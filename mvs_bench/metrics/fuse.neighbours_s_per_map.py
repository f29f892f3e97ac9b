"""Seconds per depth map of fusion's work over each reference view's
neighbours (the candidates, their projections into the neighbours, the
claims and the accumulation): the program's span ``fuse.neighbours`` over
the window's timed jobs, over their maps. None where the program keeps no
recording."""

from mvs_bench import program_trace

UNIT = "s/map"
LAYER = "host filter and fusion"
MOVES = "depth_maps_per_s"

install = program_trace.install


def read(ctx):
    return program_trace.per_map(ctx, "fuse.neighbours")
