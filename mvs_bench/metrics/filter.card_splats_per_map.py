"""Neighbour maps the cross-view filter splatted on the card per depth
map: the program's counter ``filter.card_splats`` (one per neighbour map
the splat kernel projected into a view) over the window's timed jobs, over
their maps; 0 where the filter ran on the host. None where the program
keeps no recording, or has no filter on the card and so no such counter."""

import importlib.util

from mvs_bench import program_trace

UNIT = "splats/map"
LAYER = "host filter and fusion"
MOVES = "depth_maps_per_s"

install = program_trace.install


def read(ctx):
    if not ctx.maps or not program_trace.recorded(ctx.jobs):
        return None
    if importlib.util.find_spec("openmvs_tpu_torch.ops.filter_kernel") is None:
        return None
    return sum(j.recording.counters.get("filter.card_splats", 0) for j in ctx.jobs) / ctx.maps
