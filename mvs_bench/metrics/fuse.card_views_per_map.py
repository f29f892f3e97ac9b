"""Views fusion fused on the card per depth map: the program's counter
``fuse.card_views`` (one per reference view the fusion kernels fused) over
the window's timed jobs, over their maps; 1.0 when every map is fused on
the card, 0 where fusion ran on the host. None where the program keeps no
recording, or has no fusion on the card and so no such counter."""

import importlib.util

from mvs_bench import program_trace

UNIT = "views/map"
LAYER = "host filter and fusion"
MOVES = "depth_maps_per_s"

install = program_trace.install


def read(ctx):
    if not ctx.maps or not program_trace.recorded(ctx.jobs):
        return None
    if importlib.util.find_spec("openmvs_tpu_torch.ops.fusion_kernel") is None:
        return None
    return sum(j.recording.counters.get("fuse.card_views", 0) for j in ctx.jobs) / ctx.maps
