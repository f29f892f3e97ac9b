"""Rectified pairs warped on the card per depth map: the program's counter
``sgm.card_rectifications`` (one per pair ``sgm.rectify_pair`` warped with
the ``rectify_warp`` kernel) over the window's timed jobs, over their maps;
0 where the pairs were rectified on the host. None where the program keeps
no recording, or has no rectification on the card and so no such counter."""

import importlib.util

from mvs_bench import program_trace

UNIT = "pairs/map"
LAYER = "SGM host steps"
MOVES = "depth_maps_per_s"

install = program_trace.install


def read(ctx):
    if not ctx.maps or not program_trace.recorded(ctx.jobs):
        return None
    if importlib.util.find_spec("openmvs_tpu_torch.ops.rectify_kernel") is None:
        return None
    return sum(j.recording.counters.get("sgm.card_rectifications", 0)
               for j in ctx.jobs) / ctx.maps
