"""The PatchMatch scorers' share of their roofline in the profiled job:
the least time for the work of every ``pm_kernel.score_views`` and
``geom_terms`` call (counted from each call's shapes by ``work.py``,
recorded through ``pm_kernel.host_effect`` so each graph replay counts),
over the profiler's time of the ``pm_score_views`` and ``pm_geom_views``
kernels."""

from mvs_bench import work

UNIT = "%"
LAYER = "PatchMatch kernels"
MOVES = "depth_maps_per_s"
KERNELS = ("pm_score_views", "pm_geom_views")


def install(probes):
    """Record the shapes of each scorer call (band-flagged calls, whose
    work depends on the flags, are left out)."""
    from openmvs_tpu_torch.ops import pm_kernel

    score = pm_kernel.score_views

    def score_views(images, sizes, Hl, Hm, depth, normal, inv_nd, X0, goff, *a, **kw):
        out = score(images, sizes, Hl, Hm, depth, normal, inv_nd, X0, goff, *a, **kw)
        if kw.get("band_act") is None:
            C, H, W = depth.shape
            V, Hp, Wp = images.shape
            geom = ("geom" if kw.get("Tr") is not None else
                    "pre" if kw.get("geom_terms") is not None else "none")
            dms = kw.get("dms")
            dm_px = dms.shape[1] * dms.shape[2] if dms is not None else 0
            probes.record("pm", work.score_views(C, H, W, goff.shape[0], V, Hp * Wp, dm_px,
                                                 "nn" if kw.get("nearest") else "exact",
                                                 geom))
        return out

    probes.patch(pm_kernel, "score_views", score_views)
    gterms = pm_kernel.geom_terms

    def geom_terms(dms, sizes, Tl, Tm, Tr, Tn, depth, X0, uv):
        out = gterms(dms, sizes, Tl, Tm, Tr, Tn, depth, X0, uv)
        C, H, W = depth.shape
        probes.record("pm", work.geom_views(C, H, W, dms.shape[0], dms.shape[1] * dms.shape[2]))
        return out

    probes.patch(pm_kernel, "geom_terms", geom_terms)


def read(ctx):
    return work.roofline_pct(ctx.profiled, "pm", KERNELS)
