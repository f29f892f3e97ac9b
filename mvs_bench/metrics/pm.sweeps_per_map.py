"""PatchMatch sweeps run per depth map, each early-exit sweep the block ran
included: the program's counter ``pm.sweeps`` (counted on the host by
``graphs.Sweeps``) over the window's timed jobs, over their maps. None
where the program keeps no recording."""

from mvs_bench import program_trace

UNIT = "sweeps/map"
LAYER = "PatchMatch per view"
MOVES = "depth_maps_per_s"

install = program_trace.install


def read(ctx):
    if not ctx.maps or not program_trace.recorded(ctx.jobs):
        return None
    return sum(j.recording.counters.get("pm.sweeps", 0) for j in ctx.jobs) / ctx.maps
