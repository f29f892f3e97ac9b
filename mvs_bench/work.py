"""Work counts and published peaks: the yardstick of the roofline metrics.

A frozen copy of ``chip_smoke.py``'s counting (``_views_work``,
``_bound_views``, ``_bound_geom_views``, the ``wzncc_volume`` and
``sgm_scan`` rows' bytes and operations) and peaks, so that later changes to
the port cannot move it. Each function takes shapes and returns
``(bytes, fp32 operations, fp64 operations)``; ``bound_s`` turns that into
the least time the card could take. Imports nothing of the port.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, outside the tensor cores; at the full
# 700 W power limit (the run prints the card's limit beside every number)
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12

# fp32 operations per (candidate, pixel) of the PatchMatch scorers, counted
# from csrc/pm_common.cuh with an fma as two: per texel (warp, bounds,
# sample, accumulate), per pixel (setup, ZNCC epilogue), the geometric term
FLOP_TEXEL = {"exact": 50, "nn": 37}
FLOP_PIXEL = 44
FLOP_GEOM = 83
# of FLOP_TEXEL, the view-independent part of the texel warp, which the
# multi-view scorer computes once for all views
FLOP_SHARED = 7
# per view and (c, p): finish_view and the best-two fold
FLOP_FINISH = 10
# wzncc_volume per (pixel, disparity), counted from csrc/wzncc_volume.cu:
# 6 fp32 a texel, 8 in the epilogue, 4 fp64
WZNCC_FLOP_TEXEL = 6
WZNCC_FLOP_EPILOGUE = 8
WZNCC_FLOP64 = 4
# sgm_scan per cell: the min, two mins and adds, the subtraction
SCAN_FLOP_CELL = 8


def score_views(C, H, W, T, V, img_px, dm_px, mode, geom):
    """K1-mv / K2-mv (``csrc/pm_score_views.cu``): bytes are the weights
    once, the V images and 26 constants a view, the candidate maps (7
    floats a (c, p)), 7 floats a pixel and the output; ``geom`` "geom"
    (the fused geometric term) adds the V depth maps and uv, "pre" the
    (V, C, H, W) terms. Operations are V x K1's per view, less the
    view-independent warp part counted once, plus finish_view per view and
    K2's geometric term per view when fused."""
    px = H * W
    cp = C * px
    nbytes = 4 * (V * (img_px + 26) + 3 * T + 2 * T * px + 7 * cp + 7 * px + cp)
    flops = cp * (T * FLOP_SHARED + V * (T * (FLOP_TEXEL[mode] - FLOP_SHARED)
                                         + FLOP_PIXEL + FLOP_FINISH))
    if geom == "geom":
        nbytes += 4 * (V * dm_px + 2 * px)
        flops += cp * V * FLOP_GEOM
    elif geom == "pre":
        nbytes += 4 * V * cp
    return nbytes, flops, 0


def geom_views(C, H, W, V, dm_px):
    """K3-mv (``csrc/pm_geom_views.cu``): the raw depths in and the (V, C,
    H, W) terms out, X0, uv, the V neighbour depth maps and 26 constants a
    view once each; FLOP_GEOM operations per (view, c, p)."""
    px = H * W
    cp = C * px
    nbytes = 4 * (V * (dm_px + 26) + cp + 3 * px + 2 * px + V * cp)
    return nbytes, V * cp * FLOP_GEOM, 0


def wzncc_volume(B, H, W, T, num_d, windows):
    """``csrc/wzncc_volume.cu`` over B pairs of (H, W) levels: the 2T
    weight planes, the right image, sum_w and norm_sq0 read once (4 bytes a
    pixel each), the int16 windows lo and hi when given, the d_mins, the
    uint8 volume written once; operations per (pixel, disparity)."""
    px = B * H * W
    nbytes = (2 * T + 3) * px * 4 + (2 * px * 2 if windows else 0) + B * 4 + px * num_d
    fp32 = px * num_d * (WZNCC_FLOP_TEXEL * T + WZNCC_FLOP_EPILOGUE)
    fp64 = px * num_d * WZNCC_FLOP64
    return nbytes, fp32, fp64


def sgm_scan(cells, steps):
    """``csrc/sgm_scan.cu`` over ``cells`` = B N M D costs with ``steps`` =
    B N M per-step P2s: the costs in and out, the P2s in."""
    return (2 * cells + steps) * 4, SCAN_FLOP_CELL * cells, 0


def bound_s(nbytes, fp32, fp64):
    """(seconds, "bytes" or "operations"): the larger of the bytes at the
    HBM peak and the operations at the fp32 and fp64 peaks."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = fp32 / PEAK_FP32 + fp64 / PEAK_FP64
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def roofline_pct(job, family, kernel_names):
    """A kernel family's share of its roofline in a profiled job, in
    percent: the least time for the work its calls recorded (entries
    ``(family, bytes, fp32, fp64)`` of ``job.work``) over the profiler's
    time of the kernels whose names hold one of ``kernel_names``. None
    where the job recorded no such call or the trace holds no such
    kernel."""
    if job is None or job.device is None:
        return None
    calls = [w[1:] for w in job.work if w[0] == family]
    kernel_s = sum(s for name, s in job.device["by_name"].items()
                   if any(k in name for k in kernel_names))
    if not calls or kernel_s <= 0:
        return None
    return 100.0 * sum(bound_s(*c)[0] for c in calls) / kernel_s
