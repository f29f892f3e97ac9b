"""Seconds per depth map of PatchMatch's host set-up: the program's spans
``pm.seed`` (the sparse seeds) and ``pm.setup`` (each pyramid level's
resizes, ``_build_pm_data`` with its uploads, the runner's buffers and
``Sweeps``) over the window's timed jobs, over their maps. None where the
program keeps no recording."""

from mvs_bench import program_trace

UNIT = "s/map"
LAYER = "PatchMatch per view"
MOVES = "depth_maps_per_s"

install = program_trace.install


def read(ctx):
    return program_trace.per_map(ctx, "pm.seed", "pm.setup")
