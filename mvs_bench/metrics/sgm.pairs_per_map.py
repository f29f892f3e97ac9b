"""Rectified pairs matched per depth map: the program's counter
``sgm.pairs`` (one per ``sgm.match_pair_tsgm`` call that matches) over the
window's timed jobs, over their maps; 8.0 in ``dtu-sgm.scene`` when every
scored neighbour is matched. None where the program keeps no recording or
has no such counter."""

from mvs_bench import program_trace

UNIT = "pairs/map"
LAYER = "SGM per view"
MOVES = "depth_maps_per_s"

install = program_trace.install


def read(ctx):
    if not ctx.maps or not program_trace.recorded(ctx.jobs):
        return None
    if not any("sgm.pairs" in j.recording.counters for j in ctx.jobs):
        return None
    return sum(j.recording.counters.get("sgm.pairs", 0) for j in ctx.jobs) / ctx.maps
