"""SGM's kernels' share of their roofline in the profiled job: the least
time for the work of every ``sgm.wzncc_volume_masked`` and ``sgm.sgm_scan``
call (counted from each call's shapes by ``work.py``, recorded through
``pm_kernel.host_effect`` so each graph replay counts) over the profiler's
time of the ``wzncc_volume`` and ``sgm_scan`` kernels."""

from mvs_bench import work

UNIT = "%"
LAYER = "SGM kernels"
MOVES = "depth_maps_per_s"
KERNELS = ("wzncc_volume", "sgm_scan")


def install(probes):
    """Record the shapes of each volume and scan call."""
    from openmvs_tpu_torch.ops import sgm

    volume = sgm.wzncc_volume_masked

    def wzncc_volume_masked(w, tw, sum_w, norm_sq0, rights, d_mins, num_d, lo=None, hi=None,
                            *args, **kwargs):
        out = volume(w, tw, sum_w, norm_sq0, rights, d_mins, num_d, lo, hi, *args, **kwargs)
        if rights.is_cuda:
            B, H, W = rights.shape
            probes.record("sgm", work.wzncc_volume(B, H, W, w.shape[0], num_d, lo is not None))
        return out

    probes.patch(sgm, "wzncc_volume_masked", wzncc_volume_masked)
    scan = sgm.sgm_scan

    def sgm_scan(xs, p2s, p1, shift, diag):
        out = scan(xs, p2s, p1, shift, diag)
        if xs.is_cuda:
            probes.record("sgm", work.sgm_scan(xs.numel(), p2s.numel()))
        return out

    probes.patch(sgm, "sgm_scan", sgm_scan)


def read(ctx):
    return work.roofline_pct(ctx.profiled, "sgm", KERNELS)
