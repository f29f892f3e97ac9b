"""Seconds per depth map of the cross-view filter's projections of each
neighbour's map into the view: the program's span ``filter.project`` over
the window's timed jobs, over their maps. None where the program keeps no
recording."""

from mvs_bench import program_trace

UNIT = "s/map"
LAYER = "host filter and fusion"
MOVES = "depth_maps_per_s"

install = program_trace.install


def read(ctx):
    return program_trace.per_map(ctx, "filter.project")
