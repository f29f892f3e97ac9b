"""Seconds of PatchMatch estimation per depth map: the stage spans
``photometric pass``, ``geometric pass *`` and ``optimize depth maps`` of
``densify.dense_reconstruction``, summed over the window's jobs, over
their maps. The estimation passes download their maps deferred, so they
are read as one sum."""

UNIT = "s/map"
LAYER = "PatchMatch per view"
MOVES = "depth_maps_per_s"


def read(ctx):
    if not ctx.maps:
        return None
    return sum(j.span_s("photometric pass", "geometric pass", "optimize depth maps")
               for j in ctx.jobs) / ctx.maps
