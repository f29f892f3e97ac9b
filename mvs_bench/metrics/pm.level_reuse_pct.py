"""Share of PatchMatch's level images served from the call's store: the
program's counters ``pm.levels_reused`` (a level image served again) over
``pm.levels_built`` (one resized and put on the card) plus
``pm.levels_reused``, times 100, summed over the window's timed jobs.
None where the program keeps no recording, or counts neither (a program
without the store)."""

from mvs_bench import program_trace

UNIT = "%"
LAYER = "PatchMatch per view"
MOVES = "depth_maps_per_s"

install = program_trace.install


def read(ctx):
    if not ctx.maps or not program_trace.recorded(ctx.jobs):
        return None
    built = sum(j.recording.counters.get("pm.levels_built", 0) for j in ctx.jobs)
    reused = sum(j.recording.counters.get("pm.levels_reused", 0) for j in ctx.jobs)
    if not built + reused:
        return None
    return 100.0 * reused / (built + reused)
