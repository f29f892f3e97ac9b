"""The PatchMatch kernels K1-mv, K2-mv, K3-mv, K1, K2, K3 and K1-v2:
wrappers, plain versions and launch counts.

K1-mv and K2-mv, ``score_views``, are K1 and K2 redesigned for the card:
one launch scores C candidate planes against all neighbour views and
returns the aggregate of ``score_hypotheses`` (the per-view epilogue
``finish_views`` and the min-mean of the best two views), reading each
pixel's patch weights once (``csrc/pm_score_views.cu``). The sweep scores
through it; K1 and K2 stay as the per-view design it replaced. K3-mv,
``geom_terms``, is K3 redesigned the same way: one launch writes the
geometric terms of all views (``csrc/pm_geom_views.cu``), which the split
sweep and the unfused scorer precompute.

K1, ``score_view``, replaces ``_score_view_pallas``
(``openmvs_tpu/ops/pm_kernel.py:819``): the bilaterally weighted ZNCC of C
candidate planes against one neighbour view. K2, ``score_view_geom``,
replaces ``_score_view_geom_pallas`` (``pm_kernel.py:979``): K1's score and
the forward-backward geometric-consistency penalty of each candidate, from
one launch. K3, ``geom_term``, replaces ``geom_term_pallas``
(``pm_kernel.py:691``): the geometric penalty alone. K1-v2,
``score_view_v2``, replaces ``score_view_v2``
(``scripts/dev_kernel_variants.py:282``): K1 with the tile's weights and a
window of the neighbour image staged in shared memory by TMA. K1, K2 and K3
are CUDA kernels in ``csrc/pm_score.cu``, K1-v2 in ``csrc/pm_score_v2.cu``,
built on first use (``ops/_build.py``).

The plain versions here are the port of the JAX package's XLA CPU path
(``_score_one_view_scan`` and ``_geometric_term``, patchmatch.py:285-480).
The kernels compute what they compute, not what the Pallas kernels compute
where the two differ: nearest sampling rounds both axes half-to-even,
``sum_w`` is divided unclamped, and the geometric term has no window. K1-v2
equals K1 bit for bit: its window changes where a sample is read from,
never its value.

``score_views`` takes optional band flags (``band_act``, one per band of
``BAND_ROWS`` image rows; the JAX package's ``tile_act``): a skipped
band's pixels score th_robust in every view with a geometric term of 0,
and the kernel does no texel work for them (``OMVS_ACTIVE``, the sweep's
convergence skipping).

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches its kernel or raises; each launch adds one to its entry of
``LAUNCHES`` (one per kernel and sampling mode, and for ``score_views`` per
geometric mode: none, ``geom`` fused, ``pre`` precomputed; launches with
band flags count under ``score_views_act*``). A launch made while a CUDA
graph is captured counts nothing then: the graph's replays count it
(``host_effect``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from typing import Tuple

import torch

from openmvs_tpu_torch.ops import _build
from openmvs_tpu_torch.utils.fmath import fma, rsqrt

LAUNCHES = {"score_views_exact": 0, "score_views_nn": 0,
            "score_views_geom_exact": 0, "score_views_geom_nn": 0,
            "score_views_pre_exact": 0, "score_views_pre_nn": 0,
            "score_views_act_exact": 0, "score_views_act_nn": 0,
            "score_views_geom_act_exact": 0, "score_views_geom_act_nn": 0,
            "score_views_pre_act_exact": 0, "score_views_pre_act_nn": 0,
            "score_view_exact": 0, "score_view_nn": 0,
            "score_view_geom_exact": 0, "score_view_geom_nn": 0,
            "geom_term": 0, "geom_terms": 0,
            "score_view_v2_exact": 0, "score_view_v2_nn": 0,
            "sgm_scan": 0, "segment_sum": 0, "wzncc_volume": 0}
# score_views' geometric modes, as the kernel numbers them
_GEOM_MODES = {"none": 0, "geom": 1, "pre": 2}
# image rows of one band of the scorer's band flags: the JAX package's
# 8-row tile of the row-pair compacted lattice
BAND_ROWS = 16


# worker threads of several devices launch at once (densify's
# _run_views_parallel): every update of LAUNCHES, and of
# patchmatch.BANDS, holds this lock
COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _add_launch(name: str) -> None:
    with COUNT_LOCK:
        LAUNCHES[name] += 1


def count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]``, now or at each replay of the graph
    being captured (``host_effect``)."""
    host_effect(functools.partial(_add_launch, name))


# per thread: the host effects of the CUDA graph this thread captures
_capture = threading.local()


@contextlib.contextmanager
def capturing(effects: list):
    """Within the block, in this thread, ``host_effect`` appends to
    ``effects`` instead of running: the capture of a CUDA graph, whose
    replays then run ``effects``."""
    prev = getattr(_capture, "effects", None)
    _capture.effects = effects
    try:
        yield
    finally:
        _capture.effects = prev


def host_effect(fn) -> None:
    """Run ``fn``, host bookkeeping of device work (a launch count, a band
    count, a debug print): now, or, while this thread captures a CUDA
    graph, after each replay of that graph."""
    effects = getattr(_capture, "effects", None)
    if effects is None:
        fn()
    else:
        effects.append(fn)


# ------------------------------------------------------------- plain versions


def _corners(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """The four pixels around float coords (clamped gather) and the
    fractional offsets."""
    Hp, Wp = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    # clamp in float first: a non-finite or huge coordinate must not reach
    # the integer conversion (its sample is masked by the callers)
    xi = x0.clamp(-1, Wp).to(torch.int64).clamp(0, Wp - 2)
    yi = y0.clamp(-1, Hp).to(torch.int64).clamp(0, Hp - 2)
    flat = img.reshape(-1)
    idx = yi * Wp + xi
    return (flat[idx], flat[idx + 1], flat[idx + Wp], flat[idx + Wp + 1],
            x - x0, y - y0)


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample, (v00 (1-fx) + v01 fx) (1-fy) + (v10 (1-fx) + v11 fx) fy,
    with the multiply-adds the JAX package's geometric term contracts: the
    right-hand term of each sum is fused."""
    v00, v01, v10, v11, fx, fy = _corners(img, x, y)
    top = fma(v01, fx, v00 * (1 - fx))
    bot = fma(v11, fx, v10 * (1 - fx))
    return fma(bot, fy, top * (1 - fy))


def _bilinear_texel(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The same blend as ``_bilinear`` with the contraction of the JAX
    package's texel loop, which fuses the left-hand term of the outer sum."""
    v00, v01, v10, v11, fx, fy = _corners(img, x, y)
    top = fma(v01, fx, v00 * (1 - fx))
    bot = fma(v11, fx, v10 * (1 - fx))
    return fma(top, 1 - fy, bot * fy)


def _nearest(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample; torch.round rounds half to even."""
    Hp, Wp = img.shape
    xi = torch.round(x).clamp(-1, Wp).to(torch.int64).clamp(0, Wp - 1)
    yi = torch.round(y).clamp(-1, Hp).to(torch.int64).clamp(0, Hp - 1)
    return img.reshape(-1)[yi * Wp + xi]


def _mat3(M: torch.Tensor, a, b, c):
    """Rows of M @ (a, b, c) as the JAX package's 3x3 einsums give them:
    elementwise float32 with a fused multiply-add chain (never a matmul,
    which may run at reduced precision on an accelerator)."""
    return [fma(M[r, 2], c, fma(M[r, 1], b, M[r, 0] * a)) for r in range(3)]


def score_view_plain(img, size, Hl, Hm, depth, normal, inv_nd, X0, goff, w,
                     wtm, sum_w, norm_sq0, *, th_robust: float,
                     nearest: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, in-bounds mask), each (C, H, W): weighted ZNCC of C
    hypothesis maps in one view, texel by texel (``_score_one_view_scan``,
    with its multiply-adds fused where XLA fuses them)."""
    h_j, w_j = size[0], size[1]
    SX0 = _mat3(Hl, X0[..., 0], X0[..., 1], X0[..., 2])      # 3 x (H, W)
    Sg = _mat3(Hl, goff[:, 0], goff[:, 1], goff[:, 2])       # 3 x (T,)
    inv_d = 1.0 / depth
    sample = _nearest if nearest else _bilinear_texel
    num = torch.zeros_like(depth)
    ssum = torch.zeros_like(depth)
    ssq = torch.zeros_like(depth)
    inb = torch.ones(depth.shape, dtype=torch.bool, device=depth.device)
    for k in range(goff.shape[0]):
        g = goff[k]
        n_goff = fma(normal[..., 2], g[2], fma(normal[..., 1], g[1], normal[..., 0] * g[0]))
        scale = fma(n_goff, inv_nd, inv_d)
        sx = fma(Hm[0], scale, SX0[0][None] + Sg[0][k])
        sy = fma(Hm[1], scale, SX0[1][None] + Sg[1][k])
        sz = fma(Hm[2], scale, SX0[2][None] + Sg[2][k])
        zok = sz > 1e-8
        izs = torch.where(zok, 1.0 / torch.where(zok, sz, 1.0), 0.0)
        px = sx * izs
        py = sy * izs
        inb = inb & zok & (px >= 1) & (px <= w_j - 2) & (py >= 1) & (py <= h_j - 2)
        val = sample(img, px, py)
        num = fma(val, wtm[k][None], num)
        ssum = fma(val, w[k][None], ssum)
        ssq = fma(val * val, w[k][None], ssq)
    return zncc_score(num, ssum, ssq, inb, sum_w, norm_sq0, th_robust), inb


def zncc_score(num, ssum, ssq, inb, sum_w, norm_sq0, th_robust: float,
               reciprocal: bool = True) -> torch.Tensor:
    """1 - the weighted ZNCC from a window's sums, th_robust where the
    window left the image or has no variance. ``reciprocal``: the
    division by sum_w as XLA rounds it in the texel-scan scorer, else as
    in the warp-once scorer (a true division, no contraction)."""
    if reciprocal:
        # XLA turns the division by the broadcast sum_w into a reciprocal
        # multiply, which then contracts with the subtraction
        norm_sq1 = fma(-(ssum * ssum), (1.0 / sum_w)[None], ssq)
    else:
        norm_sq1 = ssq - ssum * ssum / sum_w[None]
    nrm_sq = norm_sq0[None] * norm_sq1
    ncc = torch.clamp(num * rsqrt(torch.clamp(nrm_sq, min=1e-30)), -1.0, 1.0)
    score = 1.0 - ncc
    return torch.where((nrm_sq <= 1e-16) | ~inb, th_robust, score)


def geom_term_plain(dm, size, Tl, Tm, Tr, Tn, depth, X0, uv) -> torch.Tensor:
    """(C, H, W) forward-backward reprojection penalty in [0, 4]
    (``_geometric_term``, DepthMap.cpp:535-551): blend-then-check bilinear
    sample of the neighbour depth, 4 where the check fails."""
    h_j, w_j = size[0], size[1]
    Xa = X0[..., 0][None] * depth
    Xb = X0[..., 1][None] * depth
    Xc = X0[..., 2][None] * depth
    X1 = _mat3(Tl, Xa, Xb, Xc)
    X1 = [X1[r] + Tm[r] for r in range(3)]
    z1 = X1[2]
    zok = z1 > 1e-8
    iz = torch.where(zok, 1.0 / torch.where(zok, z1, 1.0), 0.0)
    x1 = X1[0] * iz
    y1 = X1[1] * iz
    inside = zok & (depth > 0) & (x1 >= 1) & (x1 <= w_j - 2) & (y1 >= 1) & (y1 <= h_j - 2)
    d1 = _bilinear(dm, x1, y1)
    similar = inside & (d1 > 0) & (torch.abs(z1 - d1) < 0.03 * z1)
    XB = _mat3(Tr, x1 * d1, y1 * d1, d1)
    XB = [XB[r] + Tn[r] for r in range(3)]
    zb = XB[2]
    zbok = zb > 1e-8
    izb = torch.where(zbok, 1.0 / torch.where(zbok, zb, 1.0), 0.0)
    du = fma(-XB[0], izb, uv[..., 0])
    dv = fma(-XB[1], izb, uv[..., 1])
    dist = torch.sqrt(fma(du, du, dv * dv))
    cons = torch.clamp(torch.sqrt(dist * (dist + 2.0)), max=4.0)
    return torch.where(similar & zbok, cons, 4.0)


def geom_terms_plain(dms, sizes, Tl, Tm, Tr, Tn, depth, X0, uv) -> torch.Tensor:
    """The plain version of ``geom_terms``: ``geom_term_plain`` of each of
    the V views, stacked (V, C, H, W)."""
    return torch.stack([geom_term_plain(dms[j], sizes[j], Tl[j], Tm[j], Tr[j],
                                        Tn[j], depth, X0, uv)
                        for j in range(dms.shape[0])])


def finish_views(per_view, n_views, sizes, bonus, f_blend, delta, d0, *,
                 th_robust: float, geom_weight: float) -> torch.Tensor:
    """(C, H, W) aggregate of per-view scores: ``per_view(j)`` gives view
    j's (score, geometric term or None), each (C, H, W); each view is
    finished as the JAX package's ``finish_view`` (patchmatch.py:562-580:
    bonus and geometric weight, low-res prior blend, clip at 2, 2 for a
    padded slot) and folded into the best two in view order, then averaged
    min-mean (DepthMap.cpp:594-609)."""
    s0 = s1 = torch.full(bonus.shape, math.inf, dtype=torch.float32,
                         device=bonus.device)
    for j in range(n_views):
        s, gj = per_view(j)
        if gj is not None:
            s = fma(s, bonus, geom_weight * gj)
        else:
            s = s * bonus
        # low-res prior blend (DepthMap.cpp:552-561)
        s_blend = fma((1.0 - f_blend)[None], s, f_blend[None] * delta)
        s = torch.where(d0[None] > 0, s_blend, s)
        s = torch.clamp(s, max=2.0)
        # a padded neighbor slot (size (0, 0)) pins to the 2.0 clip
        s = torch.where(sizes[j][0] > 0, s, 2.0)
        s0, s1 = torch.minimum(s0, s), torch.minimum(s1, torch.maximum(s0, s))
    if n_views == 1:
        return s0
    # min-mean: average the best two unless the 2nd is already robust-clipped
    return torch.where(s1 < th_robust, 0.5 * (s0 + s1), s0)


def band_rows(band_act: torch.Tensor, H: int) -> torch.Tensor:
    """(H,) bool: the rows of active bands."""
    return torch.repeat_interleave(band_act, BAND_ROWS)[:H]


def score_views_plain(images, sizes, Hl, Hm, depth, normal, inv_nd, X0, goff,
                      w, wtm, sum_w, norm_sq0, bonus, f_blend, delta, d0, *,
                      th_robust: float, geom_weight: float,
                      nearest: bool = False, Tr=None, Tn=None, dms=None,
                      uv=None, geom_terms=None, band_act=None) -> torch.Tensor:
    """The plain version of ``score_views``: per view, K1's and K2's plain
    versions (or the precomputed term), then ``finish_views``. With
    ``band_act``, the pixels of skipped bands take raw score th_robust and
    geometric term 0 in every view."""
    if band_act is None:
        def skip(s, g):
            return s, g
    else:
        off = ~band_rows(band_act, depth.shape[1])[None, :, None]

        def skip(s, g):
            return (torch.where(off, th_robust, s),
                    None if g is None else torch.where(off, 0.0, g))

    def per_view(j):
        s = score_view_plain(images[j], sizes[j], Hl[j], Hm[j], depth, normal,
                             inv_nd, X0, goff, w, wtm, sum_w, norm_sq0,
                             th_robust=th_robust, nearest=nearest)[0]
        if dms is not None:
            return skip(s, geom_term_plain(dms[j], sizes[j], Hl[j], Hm[j], Tr[j],
                                           Tn[j], depth, X0, uv))
        return skip(s, None if geom_terms is None else geom_terms[j])

    return finish_views(per_view, images.shape[0], sizes, bonus, f_blend,
                        delta, d0, th_robust=th_robust, geom_weight=geom_weight)


# ------------------------------------------------------------- wrappers


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_2d(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name}: {t.dim()}-D, expected 2-D")


def _candidate_shape(depth: torch.Tensor):
    if depth.dim() != 3:
        raise ValueError(f"depth: {depth.dim()}-D, expected (C, H, W)")
    return tuple(depth.shape)


def check_scorer_operands(img, size, Hl, Hm, depth, normal, inv_nd, X0, goff,
                          w, wtm, sum_w, norm_sq0, Tr=None, Tn=None, dm=None,
                          uv=None) -> None:
    """Raise unless the operands are what K1, K1-v2 and (with Tr, Tn, dm,
    uv) K2 take: contiguous float32 tensors on depth's device, in the
    layouts of the JAX package's score_view_pallas."""
    dev = depth.device
    C, H, W = _candidate_shape(depth)
    if goff.dim() != 2 or not 1 <= goff.shape[0] <= _build.MAX_TEXELS:
        raise ValueError(f"goff: shape {tuple(goff.shape)}, expected (T, 3) "
                         f"with 1 <= T <= {_build.MAX_TEXELS}")
    T = goff.shape[0]
    _check_2d("img", img)
    ops = dict(img=(img, img.shape), size=(size, (2,)), Hl=(Hl, (3, 3)),
               Hm=(Hm, (3,)), depth=(depth, (C, H, W)),
               normal=(normal, (C, H, W, 3)), inv_nd=(inv_nd, (C, H, W)),
               X0=(X0, (H, W, 3)), goff=(goff, (T, 3)), w=(w, (T, H, W)),
               wtm=(wtm, (T, H, W)), sum_w=(sum_w, (H, W)),
               norm_sq0=(norm_sq0, (H, W)))
    if dm is not None:
        _check_2d("dm", dm)
        ops.update(Tr=(Tr, (3, 3)), Tn=(Tn, (3,)), dm=(dm, dm.shape),
                   uv=(uv, (H, W, 2)))
    for name, (t, shape) in ops.items():
        _check(name, t, shape, dev)


def check_geom_operands(dm, size, Tl, Tm, Tr, Tn, depth, X0, uv) -> None:
    """Raise unless the operands are what K3 takes: contiguous float32
    tensors on depth's device, in the layouts of geom_term_pallas."""
    dev = depth.device
    C, H, W = _candidate_shape(depth)
    _check_2d("dm", dm)
    ops = dict(dm=(dm, dm.shape), size=(size, (2,)), Tl=(Tl, (3, 3)),
               Tm=(Tm, (3,)), Tr=(Tr, (3, 3)), Tn=(Tn, (3,)),
               depth=(depth, (C, H, W)), X0=(X0, (H, W, 3)), uv=(uv, (H, W, 2)))
    for name, (t, shape) in ops.items():
        _check(name, t, shape, dev)


def check_geom_views_operands(dms, sizes, Tl, Tm, Tr, Tn, depth, X0, uv) -> None:
    """Raise unless the operands are what K3-mv takes: contiguous float32
    tensors on depth's device, K3's operands stacked over 1 to
    ``MAX_VIEWS`` views."""
    dev = depth.device
    C, H, W = _candidate_shape(depth)
    if dms.dim() != 3:
        raise ValueError(f"dms: {dms.dim()}-D, expected (V, Hd, Wd)")
    V = dms.shape[0]
    if not 1 <= V <= _build.MAX_VIEWS:
        raise ValueError(f"dms: {V} views, expected 1 to {_build.MAX_VIEWS}")
    ops = dict(dms=(dms, dms.shape), sizes=(sizes, (V, 2)), Tl=(Tl, (V, 3, 3)),
               Tm=(Tm, (V, 3)), Tr=(Tr, (V, 3, 3)), Tn=(Tn, (V, 3)),
               depth=(depth, (C, H, W)), X0=(X0, (H, W, 3)), uv=(uv, (H, W, 2)))
    for name, (t, shape) in ops.items():
        _check(name, t, shape, dev)


def check_views_operands(images, sizes, Hl, Hm, depth, normal, inv_nd, X0,
                        goff, w, wtm, sum_w, norm_sq0, bonus, f_blend, delta,
                        d0, Tr=None, Tn=None, dms=None, uv=None,
                        geom_terms=None) -> str:
    """Raise unless the operands are what ``score_views`` takes: contiguous
    float32 tensors on depth's device, stacks of 1 to ``MAX_VIEWS`` views,
    and either the fused geometric operands (Tr, Tn, dms, uv), or the
    precomputed terms, or neither. Returns the geometric mode."""
    dev = depth.device
    C, H, W = _candidate_shape(depth)
    if images.dim() != 3:
        raise ValueError(f"images: {images.dim()}-D, expected (V, Hp, Wp)")
    V = images.shape[0]
    if not 1 <= V <= _build.MAX_VIEWS:
        raise ValueError(f"images: {V} views, expected 1 to {_build.MAX_VIEWS}")
    if goff.dim() != 2 or not 1 <= goff.shape[0] <= _build.MAX_TEXELS:
        raise ValueError(f"goff: shape {tuple(goff.shape)}, expected (T, 3) "
                         f"with 1 <= T <= {_build.MAX_TEXELS}")
    T = goff.shape[0]
    ops = dict(images=(images, images.shape), sizes=(sizes, (V, 2)),
               Hl=(Hl, (V, 3, 3)), Hm=(Hm, (V, 3)), depth=(depth, (C, H, W)),
               normal=(normal, (C, H, W, 3)), inv_nd=(inv_nd, (C, H, W)),
               X0=(X0, (H, W, 3)), goff=(goff, (T, 3)), w=(w, (T, H, W)),
               wtm=(wtm, (T, H, W)), sum_w=(sum_w, (H, W)),
               norm_sq0=(norm_sq0, (H, W)), bonus=(bonus, (C, H, W)),
               f_blend=(f_blend, (H, W)), delta=(delta, (C, H, W)), d0=(d0, (H, W)))
    fused = [a is not None for a in (Tr, Tn, dms, uv)]
    if any(fused) and not all(fused):
        raise ValueError("fused geometric term: give all of Tr, Tn, dms, uv")
    if all(fused) and geom_terms is not None:
        raise ValueError("give the fused geometric operands or geom_terms, not both")
    mode = "geom" if all(fused) else "pre" if geom_terms is not None else "none"
    if mode == "geom":
        if dms.dim() != 3:
            raise ValueError(f"dms: {dms.dim()}-D, expected (V, Hd, Wd)")
        ops.update(Tr=(Tr, (V, 3, 3)), Tn=(Tn, (V, 3)),
                   dms=(dms, (V,) + tuple(dms.shape[1:])), uv=(uv, (H, W, 2)))
    elif mode == "pre":
        ops.update(geom_terms=(geom_terms, (V, C, H, W)))
    for name, (t, shape) in ops.items():
        _check(name, t, shape, dev)
    return mode


def _cuda_device(depth: torch.Tensor) -> torch.device:
    if depth.device.type != "cuda":
        raise ValueError(f"kernel: tensors on {depth.device}, expected cuda or cpu")
    return depth.device


def _raise_on(rc: int, fn: str) -> None:
    if rc < 0:
        raise RuntimeError(f"{fn}: the driver refused a tensor map (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: {_build.error_string(rc)}")


def _pitched(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(t, row pitch in floats) for a TMA load, which needs 16-byte-aligned
    row strides and base: t itself where its rows are a multiple of 4 floats
    long and it starts 16-byte aligned, else a copy with the rows padded to
    a multiple of 4 floats. The values are the same."""
    width = t.shape[-1]
    pitch = -(-width // 4) * 4
    if pitch == width and t.data_ptr() % 16 == 0:
        return t, width
    out = torch.zeros(*t.shape[:-1], pitch, dtype=t.dtype, device=t.device)
    out[..., :width] = t
    return out, pitch


def _launch(img, size, Hl, Hm, Tr, Tn, dm, depth, normal, inv_nd, X0, uv,
            goff, w, wtm, sum_w, norm_sq0, th_robust, nearest, geom):
    dev = _cuda_device(depth)
    check_scorer_operands(img, size, Hl, Hm, depth, normal, inv_nd, X0, goff,
                          w, wtm, sum_w, norm_sq0, *((Tr, Tn, dm, uv) if geom else ()))
    C, H, W = depth.shape
    score = torch.empty_like(depth)
    cons = torch.empty_like(depth) if geom else None
    lib = _build.library("pm_score")
    null = ctypes.c_void_p(0)
    with torch.cuda.device(dev):
        rc = lib.pm_score_view(
            _ptr(img), img.shape[0], img.shape[1],
            _ptr(size), _ptr(Hl), _ptr(Hm),
            _ptr(Tr) if geom else null, _ptr(Tn) if geom else null,
            _ptr(dm) if geom else null,
            dm.shape[0] if geom else 0, dm.shape[1] if geom else 0,
            _ptr(depth), _ptr(normal), _ptr(inv_nd), _ptr(X0),
            _ptr(uv) if geom else null,
            _ptr(goff), goff.shape[0], _ptr(w), _ptr(wtm), _ptr(sum_w),
            _ptr(norm_sq0), _ptr(score), _ptr(cons) if geom else null,
            C, H, W, ctypes.c_float(th_robust), int(nearest), int(geom),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, "pm_score_view")
    return score, cons


def score_view(img, size, Hl, Hm, depth, normal, inv_nd, X0, goff, w, wtm,
               sum_w, norm_sq0, *, th_robust: float,
               nearest: bool = False) -> torch.Tensor:
    """(C, H, W) scores of candidate maps in one view (K1). Argument order
    and layouts are those of the JAX package's ``score_view_pallas``."""
    if depth.device.type == "cpu":
        return score_view_plain(img, size, Hl, Hm, depth, normal, inv_nd, X0,
                                goff, w, wtm, sum_w, norm_sq0,
                                th_robust=th_robust, nearest=nearest)[0]
    score, _ = _launch(img, size, Hl, Hm, None, None, None, depth, normal,
                       inv_nd, X0, None, goff, w, wtm, sum_w, norm_sq0,
                       th_robust, nearest, geom=False)
    count_launch("score_view_nn" if nearest else "score_view_exact")
    return score


def score_view_geom(img, size, Hl, Hm, Tr, Tn, dm, depth, normal, inv_nd, X0,
                    uv, goff, w, wtm, sum_w, norm_sq0, *, th_robust: float,
                    nearest: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, cons), each (C, H, W) (K2): K1's score and the geometric
    penalty against the neighbour depth map ``dm``. ``Hl``/``Hm`` serve as
    the forward transform of the geometric term too (``Tl == Hl`` and
    ``Tm == Hm`` in packed data). Argument order and layouts are those of
    the JAX package's ``score_view_geom_pallas``."""
    if depth.device.type == "cpu":
        s = score_view_plain(img, size, Hl, Hm, depth, normal, inv_nd, X0,
                             goff, w, wtm, sum_w, norm_sq0,
                             th_robust=th_robust, nearest=nearest)[0]
        return s, geom_term_plain(dm, size, Hl, Hm, Tr, Tn, depth, X0, uv)
    score, cons = _launch(img, size, Hl, Hm, Tr, Tn, dm, depth, normal,
                          inv_nd, X0, uv, goff, w, wtm, sum_w, norm_sq0,
                          th_robust, nearest, geom=True)
    count_launch("score_view_geom_nn" if nearest else "score_view_geom_exact")
    return score, cons


def geom_term(dm, size, Tl, Tm, Tr, Tn, depth, X0, uv) -> torch.Tensor:
    """(C, H, W) geometric penalty in [0, 4] of C candidate depth maps
    against one neighbour depth map (K3). ``depth`` is raw: zeros mark
    invalid hypotheses, which are never consistent. ``Tl``/``Tm`` are taken
    as given. Argument order and layouts are those of the JAX package's
    ``geom_term_pallas``."""
    if depth.device.type == "cpu":
        return geom_term_plain(dm, size, Tl, Tm, Tr, Tn, depth, X0, uv)
    dev = _cuda_device(depth)
    check_geom_operands(dm, size, Tl, Tm, Tr, Tn, depth, X0, uv)
    C, H, W = depth.shape
    cons = torch.empty_like(depth)
    lib = _build.library("pm_score")
    with torch.cuda.device(dev):
        rc = lib.pm_geom_term(
            _ptr(dm), dm.shape[0], dm.shape[1], _ptr(size), _ptr(Tl), _ptr(Tm),
            _ptr(Tr), _ptr(Tn), _ptr(depth), _ptr(X0), _ptr(uv), _ptr(cons),
            C, H, W, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, "pm_geom_term")
    count_launch("geom_term")
    return cons


def score_view_v2(img, size, Hl, Hm, depth, normal, inv_nd, X0, goff, w, wtm,
                  sum_w, norm_sq0, *, th_robust: float, nearest: bool = False,
                  in_window: torch.Tensor = None) -> torch.Tensor:
    """(C, H, W) scores (K1-v2): K1's function, bit for bit, with each
    block's weights and window of the neighbour image staged in shared
    memory by TMA. Argument order and layouts are K1's; the kernel takes at
    most ``V2_MAX_TEXELS`` texels. ``in_window``, an optional (C, H, W)
    uint8 tensor on the card, receives 1 where every texel of the
    (candidate, pixel) was read from the window; the plain version has no
    window and takes none."""
    check_scorer_operands(img, size, Hl, Hm, depth, normal, inv_nd, X0, goff,
                          w, wtm, sum_w, norm_sq0)
    if depth.device.type == "cpu":
        if in_window is not None:
            raise ValueError("in_window: only the kernel stages a window")
        return score_view_plain(img, size, Hl, Hm, depth, normal, inv_nd, X0,
                                goff, w, wtm, sum_w, norm_sq0,
                                th_robust=th_robust, nearest=nearest)[0]
    dev = _cuda_device(depth)
    C, H, W = depth.shape
    T = goff.shape[0]
    if T > _build.V2_MAX_TEXELS:
        raise ValueError(f"score_view_v2: {T} texels, at most {_build.V2_MAX_TEXELS}")
    if in_window is not None:
        _check("in_window", in_window, (C, H, W), dev, torch.uint8)
    img_p, img_pitch = _pitched(img)
    w_p, w_pitch = _pitched(w)
    wtm_p, _ = _pitched(wtm)
    score = torch.empty_like(depth)
    lib = _build.library("pm_score_v2")
    with torch.cuda.device(dev):
        rc = lib.pm_score_view_v2(
            _ptr(img_p), img.shape[0], img.shape[1], img_pitch, _ptr(size),
            _ptr(Hl), _ptr(Hm), _ptr(depth), _ptr(normal), _ptr(inv_nd),
            _ptr(X0), _ptr(goff), T, _ptr(w_p), _ptr(wtm_p), w_pitch,
            _ptr(sum_w), _ptr(norm_sq0), _ptr(score),
            _ptr(in_window) if in_window is not None else ctypes.c_void_p(0),
            C, H, W, ctypes.c_float(th_robust), int(nearest),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, "pm_score_view_v2")
    count_launch("score_view_v2_nn" if nearest else "score_view_v2_exact")
    return score


def geom_terms(dms, sizes, Tl, Tm, Tr, Tn, depth, X0, uv) -> torch.Tensor:
    """(V, C, H, W) geometric penalties in [0, 4] of C candidate depth maps
    against V neighbour depth maps (K3-mv): ``geom_term`` of each view,
    stacked, from one launch. ``dms`` (V, Hd, Wd), ``sizes`` (V, 2), ``Tl``
    and ``Tr`` (V, 3, 3), ``Tm`` and ``Tn`` (V, 3) are K3's per-view
    operands stacked; ``depth`` is raw (zeros mark invalid hypotheses). The
    result is the tensor the scorer's precomputed mode reads."""
    check_geom_views_operands(dms, sizes, Tl, Tm, Tr, Tn, depth, X0, uv)
    if depth.device.type == "cpu":
        return geom_terms_plain(dms, sizes, Tl, Tm, Tr, Tn, depth, X0, uv)
    dev = _cuda_device(depth)
    V, Hd, Wd = dms.shape
    C, H, W = depth.shape
    if C > 65535 or V * C * H * W >= 2 ** 31:
        raise ValueError(f"geom_terms: {V} x {C} x {H} x {W} terms, at most "
                         "65535 candidates and 2^31 terms")
    out = torch.empty((V, C, H, W), dtype=torch.float32, device=dev)
    lib = _build.library("pm_geom_views")
    with torch.cuda.device(dev):
        rc = lib.pm_geom_views_launch(
            _ptr(dms), Hd, Wd, _ptr(sizes), _ptr(Tl), _ptr(Tm), _ptr(Tr),
            _ptr(Tn), _ptr(depth), _ptr(X0), _ptr(uv), _ptr(out), V, C, H, W,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, "pm_geom_views_launch")
    count_launch("geom_terms")
    return out


def score_views(images, sizes, Hl, Hm, depth, normal, inv_nd, X0, goff, w, wtm,
                sum_w, norm_sq0, bonus, f_blend, delta, d0, *, th_robust: float,
                geom_weight: float, nearest: bool = False, Tr=None, Tn=None,
                dms=None, uv=None, geom_terms=None,
                band_act=None) -> torch.Tensor:
    """(C, H, W) scores of C candidate (depth, normal) maps aggregated over
    the V views of the stacks (K1-mv; K2-mv with the fused geometric term):
    what ``score_hypotheses`` returns, from one launch.

    ``images`` (V, Hp, Wp), ``sizes`` (V, 2), ``Hl`` (V, 3, 3) and ``Hm``
    (V, 3) are the neighbour views; ``bonus`` and ``delta`` (C, H, W) and
    ``f_blend`` and ``d0`` (H, W) the smoothness bonus and the low-res
    prior blend; the rest as for K1. The geometric term of view j is
    computed in the kernel when ``Tr`` (V, 3, 3), ``Tn`` (V, 3), ``dms``
    (V, Hd, Wd) and ``uv`` are given (with ``Hl``/``Hm`` as its forward
    transform, as K2), read from ``geom_terms`` (V, C, H, W) when that is
    given, and left out otherwise.

    ``band_act`` (ceil(H / BAND_ROWS),) bool flags the bands of
    ``BAND_ROWS`` rows to score; a skipped band's pixels take raw score
    th_robust and geometric term 0 in every view, and the kernel reads no
    image or texel weight for them. None scores every band."""
    args = (images, sizes, Hl, Hm, depth, normal, inv_nd, X0, goff, w, wtm,
            sum_w, norm_sq0, bonus, f_blend, delta, d0)
    geom = dict(Tr=Tr, Tn=Tn, dms=dms, uv=uv, geom_terms=geom_terms)
    mode = check_views_operands(*args, **geom)
    if band_act is not None:
        _check("band_act", band_act, (-(-depth.shape[1] // BAND_ROWS),),
               depth.device, torch.bool)
    if depth.device.type == "cpu":
        return score_views_plain(*args, th_robust=th_robust,
                                 geom_weight=geom_weight, nearest=nearest,
                                 band_act=band_act, **geom)
    dev = _cuda_device(depth)
    C, H, W = depth.shape
    V, Hp, Wp = images.shape
    out = torch.empty_like(depth)
    lib = _build.library("pm_score_views")
    null = ctypes.c_void_p(0)

    def ptr(t):
        return null if t is None else _ptr(t)

    with torch.cuda.device(dev):
        rc = lib.pm_score_views_launch(
            _ptr(images), Hp, Wp, _ptr(sizes), _ptr(Hl), _ptr(Hm), ptr(Tr),
            ptr(Tn), ptr(dms), dms.shape[1] if dms is not None else 0,
            dms.shape[2] if dms is not None else 0, ptr(geom_terms),
            _ptr(depth), _ptr(normal), _ptr(inv_nd), _ptr(bonus), _ptr(delta),
            _ptr(X0), ptr(uv), _ptr(f_blend), _ptr(d0), _ptr(goff),
            goff.shape[0], _ptr(w), _ptr(wtm), _ptr(sum_w), _ptr(norm_sq0),
            _ptr(out), V, C, H, W, ctypes.c_float(th_robust),
            ctypes.c_float(geom_weight), int(nearest), _GEOM_MODES[mode],
            ptr(band_act),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, "pm_score_views_launch")
    infix = ("" if mode == "none" else f"_{mode}") + ("" if band_act is None else "_act")
    count_launch(f"score_views{infix}_{'nn' if nearest else 'exact'}")
    return out
