"""Seconds of SGM estimation per depth map: the program's span ``sgm.view``
(``densify.estimate_depth_map_sgm``: a view's pairs rectified, matched,
projected and fused) over the window's timed jobs, over their maps. None
where the program keeps no recording or has no such span."""

from mvs_bench import program_trace

UNIT = "s/map"
LAYER = "SGM per view"
MOVES = "depth_maps_per_s"

install = program_trace.install


def _spanned(jobs, *names):
    """Every job kept a recording, and one of them a span of ``names``."""
    return program_trace.recorded(jobs) and any(
        sp.name in names for j in jobs for sp in j.recording.spans)


def read(ctx):
    if not _spanned(ctx.jobs, "sgm.view"):
        return None
    return program_trace.per_map(ctx, "sgm.view")
