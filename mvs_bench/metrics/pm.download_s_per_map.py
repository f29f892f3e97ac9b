"""Seconds per depth map the host waits for a view's device work and its
copy out: the program's span ``pm.download`` (``DeferredResult.resolve``)
over the window's timed jobs, over their maps. None where the program
keeps no recording."""

from mvs_bench import program_trace

UNIT = "s/map"
LAYER = "PatchMatch per view"
MOVES = "depth_maps_per_s"

install = program_trace.install


def read(ctx):
    return program_trace.per_map(ctx, "pm.download")
