"""Seconds of the host's cross-view filter and fusion per depth map: the
stage spans ``cross-view filter`` and ``fuse depth maps`` of
``densify.dense_reconstruction``, summed over the window's jobs, over their
maps."""

UNIT = "s/map"
LAYER = "host filter and fusion"
MOVES = "depth_maps_per_s"


def read(ctx):
    if not ctx.maps:
        return None
    return sum(j.span_s("cross-view filter", "fuse depth maps") for j in ctx.jobs) / ctx.maps
