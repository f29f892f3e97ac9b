"""PatchMatch multi-view stereo as whole-image checkerboard sweeps, in torch.

Counterpart of ``openmvs_tpu/ops/patchmatch.py`` on its serial,
non-compacted path (the one the JAX package runs on the CPU): every
half-iteration scores a fixed candidate set (8 neighbour propagations and
3 random refinements) for all pixels of one checkerboard parity, against
every neighbour view, and keeps per-pixel winners (the reference's
DepthEstimator::ProcessPixel, DepthMap.cpp:630-912, scoring
DepthMap.cpp:465-626).

Scoring goes through the kernels of ``ops/pm_kernel.py``, which run their
plain versions on CPU tensors: one launch of the multi-view scorer per
candidate stack (K1-mv photometric, K2-mv photometric + geometric), and
one launch of K3-mv for the geometric terms alone, all views at once.
Geometric sweeps score with K2-mv by default; the split sweep and the
unfused scorer (``Switches``) compute the terms with K3-mv first, score
with the scorer's precomputed mode, and give the same result.
Everything stays float32, and every 3x3 warp is written
elementwise: a reduced-precision product there shifts warped coordinates
by a tenth of a pixel (see the JAX package's note at patchmatch.py:436).
The multiply-adds that XLA fuses in the JAX package are written as
``fmath.fma`` and transcendentals go through ``fmath``, so results round as
the reference's do and agree between the CPU and the card
(``utils/fmath.py``).

``mode="warp"`` is the JAX package's warp-once scorer (XLA there, plain
PyTorch here on every device): each candidate plane warps the neighbour
image once per pixel, and the window statistics are sums over shifts of
the warped image; its candidates are field-coherent probes
(``_probe_candidates``) instead of random perturbations.

Convergence skipping (``sweep(active_eps=, conf_prev=)``, ``Switches.active``)
flags bands of 16 image rows in which no pixel of the
active parity improved by more than ``active_eps`` in the previous sweep;
the scorer skips their texel work and their pixels keep the incumbent.

Randomness is the JAX package's, bit for bit: keys are derived on the host
(``utils/rng.py``) and fields are position-anchored block hashes.

Every function of a sweep can be captured in a CUDA graph and replayed
(``ops/graphs.py``, densify's path on the card): nothing in it reads the
host, a key may be a ``rng.KeyTable`` key read from a device tensor, and
the host's bookkeeping of the work (launch and band counts, the
``geom_debug`` line) goes through ``pm_kernel.host_effect``, which
runs it after each replay. What a sweep does beyond its arguments is one
record, ``Switches``, and a level's steps are ``schedule``'s.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.ops import pm_kernel
from openmvs_tpu_torch.utils import fmath, rng, safety
from openmvs_tpu_torch.utils.fmath import fma

# progressive shrink factors for random refinement
# (reference DepthEstimator::scaleRanges, DepthMap.cpp:359)
SCALE_RANGES = tuple(0.5 ** i for i in range(12))


@dataclasses.dataclass(frozen=True)
class Switches:
    """PatchMatch's sweep switches, the JAX package's environment variables.
    ``from_env`` reads them once per call at the entries
    (``densify.dense_reconstruction`` and ``estimate_depth_map``,
    ``parallel.sharded.estimate_views_sharded``); all below take the record
    as an argument, and it keys the device programs (``ops/graphs.py``).
    The default record is the empty environment's.

    ``all_exact`` (``OMVS_ALL_EXACT`` set): every sweep samples bilinear.
    ``init_exact`` (``OMVS_INIT_EXACT`` set): the incumbent is scored
    bilinear. ``early_exit`` (off where ``OMVS_EARLY_EXIT`` is ``0`` or
    empty): the nn sweeps run as one adaptive block, which stops after
    sweep k >= ``ee_min`` (``OMVS_EE_MIN``, 2, at least 0) once the share
    of valid pixels improved by more than ``ee_eps`` (``OMVS_EE_EPS``,
    5e-3) is below ``ee_frac`` (``OMVS_EE_FRAC``, 0.01). ``active``
    (``OMVS_ACTIVE``, 0 where not a number): from sweep ``active_from``
    (``OMVS_ACTIVE_FROM``, 2) on, a sweep skips the 16-row bands in which
    no pixel improved by more than it in the previous sweep, but not at a
    mode switch nor the sweep after it (``schedule``). ``geom_split``
    (``OMVS_GEOM_SPLIT`` set and not ``0``; ``1`` and ``xla`` alike): the
    split geometric sweep (``sweep``); ``geom_fused`` (off where
    ``OMVS_GEOM_FUSED`` is ``0`` or ``false``): else K3-mv computes the
    geometric terms first (``score_hypotheses``); both give the default's
    maps bit for bit. ``geom_debug`` (``OMVS_GEOM_DEBUG`` set): each K3-mv
    call prints its comparison with the plain version. ``old_rng``
    (``OMVS_OLD_RNG`` set): shape-based uniforms (``rng.block_uniform``)."""

    all_exact: bool = False
    init_exact: bool = False
    early_exit: bool = True
    ee_min: int = 2
    ee_eps: float = 5e-3
    ee_frac: float = 0.01
    active: float = 0.0
    active_from: int = 2
    geom_split: bool = False
    geom_fused: bool = True
    geom_debug: bool = False
    old_rng: bool = False

    @classmethod
    def from_env(cls) -> "Switches":
        env = os.environ.get
        try:
            active = float(env("OMVS_ACTIVE", "0") or 0)
        except ValueError:
            active = 0.0
        return cls(all_exact=bool(env("OMVS_ALL_EXACT")),
                   init_exact=bool(env("OMVS_INIT_EXACT")),
                   early_exit=env("OMVS_EARLY_EXIT", "1") not in ("0", ""),
                   ee_min=max(0, int(env("OMVS_EE_MIN", "2"))),
                   ee_eps=float(env("OMVS_EE_EPS", "5e-3")),
                   ee_frac=float(env("OMVS_EE_FRAC", "0.01")),
                   active=active, active_from=int(env("OMVS_ACTIVE_FROM", "2")),
                   geom_split=env("OMVS_GEOM_SPLIT", "0") not in ("0", ""),
                   geom_fused=env("OMVS_GEOM_FUSED", "1") not in ("0", "false"),
                   geom_debug=bool(env("OMVS_GEOM_DEBUG")),
                   old_rng=bool(env("OMVS_OLD_RNG")))


class Block(NamedTuple):  # the adaptive block's limits (``sweep_block_adaptive``)
    n_sweeps: int
    min_sweeps: int
    eps: float
    min_frac: float


class Step(NamedTuple):  # one sweep (``sweep``'s arguments)
    fold: int
    mode: str
    rescore: bool
    active_eps: float


class Schedule(NamedTuple):
    levels: int                 # sub-resolution levels above full resolution
    init_mode: str
    block: Optional[Block]
    sweeps: Tuple[Step, ...]
    n_perturb: int


def schedule(opts: DenseOptions, switches: Switches, is_geometric: bool) -> Schedule:
    """A view's pyramid (none in a geometric pass) and each level's steps:
    the incumbent scored in the first sweep's
    mode (bilinear under ``init_exact``); nearest-texel search sweeps, as
    one adaptive block of nn sweeps keyed from fold 1 where ``early_exit``
    and there are at least 3; then ``exact_final_iters`` bilinear sweeps,
    the first rescoring the incumbent (all sweeps bilinear under
    ``all_exact``; a geometric pass is one sweep). The serial path runs it
    as it is; the sharded path with ``early_exit`` and ``active`` off."""
    sw = switches
    n_iters = 1 if is_geometric else opts.estimation_iters
    n_exact = max(1, opts.exact_final_iters)
    modes = ["exact" if (sw.all_exact or it >= n_iters - n_exact) else "nn"
             for it in range(max(n_iters, 1))]
    n_nn = modes.count("nn")
    block = (Block(n_nn, sw.ee_min, sw.ee_eps, sw.ee_frac) if sw.early_exit and n_nn >= 3
             else None)
    steps, prev, have_prev = [], "nn" if block else None, False
    for it in range(n_nn if block else 0, n_iters):
        rescore = prev is not None and modes[it] != prev
        eps = sw.active if (sw.active and it >= sw.active_from and not rescore
                            and have_prev) else 0.0
        steps.append(Step(it + 1, modes[it], rescore, eps))
        have_prev, prev = not rescore, modes[it]
    return Schedule(0 if is_geometric else opts.sub_resolution_levels,
                    "exact" if sw.init_exact else modes[0], block, tuple(steps),
                    max(1, opts.random_iters // 2))


class PMViews(NamedTuple):
    """Per-neighbor-view constants, stacked on axis 0 (V views)."""

    image: torch.Tensor     # (V, Hp, Wp) gray [0,1], zero padded
    size: torch.Tensor      # (V, 2) float32: (h, w) valid extent
    Hl: torch.Tensor        # (V, 3, 3)  Kj Rj Ri^T
    Hm: torch.Tensor        # (V, 3)     Kj Rj (Ci - Cj)
    depth: torch.Tensor     # (V, Hp, Wp) neighbor depth maps (geometric pass)
    Tl: torch.Tensor        # (V, 3, 3)
    Tm: torch.Tensor        # (V, 3)
    Tr: torch.Tensor        # (V, 3, 3)
    Tn: torch.Tensor        # (V, 3)


class PMData(NamedTuple):
    """Static (per reference view) inputs to the sweep."""

    ref: torch.Tensor       # (H, W) gray
    X0: torch.Tensor        # (H, W, 3) Kinv @ (u, v, 1)
    goff: torch.Tensor      # (T, 3)    Kinv @ (dx, dy, 0) per texel offset
    w: torch.Tensor         # (T, H, W) bilateral weights
    wtm: torch.Tensor       # (T, H, W) w * (texel - weighted mean)
    sum_w: torch.Tensor     # (H, W)
    norm_sq0: torch.Tensor  # (H, W) weighted self-variance
    views: PMViews
    d_min: torch.Tensor     # () float32
    d_max: torch.Tensor     # () float32
    lowres: torch.Tensor    # (H, W) low-res prior depth (0 = none)
    valid: torch.Tensor     # (H, W) bool: textured + full window inside
    uv: torch.Tensor        # (H, W, 2) pixel coordinates


class PMState(NamedTuple):
    depth: torch.Tensor     # (H, W)
    normal: torch.Tensor    # (H, W, 3) camera space, unit, n . X0 < 0
    conf: torch.Tensor      # (H, W) aggregated score (0 best, 2 worst)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of size 3, elementwise."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm3(a: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3, squares accumulated
    with fused multiply-adds as XLA's ``jnp.linalg.norm`` does."""
    return torch.sqrt(fma(a[..., 2], a[..., 2],
                          fma(a[..., 1], a[..., 1], a[..., 0] * a[..., 0])))


# ------------------------------------------------------------- precompute


def texel_offsets(opts: DenseOptions) -> np.ndarray:
    """(T, 2) patch sample offsets (dx, dy)."""
    r = np.arange(-opts.window_half, opts.window_half + 1, opts.window_step)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    return np.stack([dx.ravel(), dy.ravel()], axis=-1).astype(np.float32)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=torch.float32, device=device)


def pack_pm_data(opts: DenseOptions, ref_gray, images, sizes, Hl, Hm, depths,
                 Tl, Tm, Tr, Tn, KinvT, goff, d_min, d_max, lowres, usable,
                 device="cuda") -> PMData:
    """Assemble PMData on ``device`` from host (numpy) or device operands;
    X0, uv and valid are derived from pixel coordinates and Kinv."""
    dev = torch.device(device)
    ref = _f32(ref_gray, dev)
    H, W = ref.shape
    w_, wtm, sum_w, norm_sq0 = compute_patch_weights(ref, opts)
    uu = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    vv = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    KT = _f32(KinvT, dev)
    X0 = torch.stack([uu * KT[0, j] + vv * KT[1, j] + KT[2, j]
                      for j in range(3)], dim=-1)
    b = opts.window_half
    inside = (uu >= b) & (uu < W - b) & (vv >= b) & (vv < H - b)
    th_mag_sq = (opts.descriptor_min_magnitude ** 2
                 if opts.descriptor_min_magnitude > 0 else -1.0)
    low = _f32(lowres, dev)
    usable = torch.as_tensor(np.asarray(usable) if not torch.is_tensor(usable)
                             else usable, device=dev).to(torch.bool)
    valid = inside & ((norm_sq0 >= th_mag_sq) | (low > 0)) & usable
    views = PMViews(
        image=_f32(images, dev), size=_f32(sizes, dev), Hl=_f32(Hl, dev),
        Hm=_f32(Hm, dev), depth=_f32(depths, dev), Tl=_f32(Tl, dev),
        Tm=_f32(Tm, dev), Tr=_f32(Tr, dev), Tn=_f32(Tn, dev),
    )
    return PMData(
        ref=ref, X0=X0.contiguous(), goff=_f32(goff, dev).contiguous(),
        w=w_, wtm=wtm, sum_w=sum_w, norm_sq0=norm_sq0, views=views,
        d_min=_f32(d_min, dev), d_max=_f32(d_max, dev), lowres=low,
        valid=valid, uv=torch.stack([uu, vv], dim=-1).contiguous(),
    )


def compute_patch_weights(ref: torch.Tensor, opts: DenseOptions):
    """Bilateral patch weights and weighted texel stats for every pixel.

    Matches DepthEstimator::GetWeight + FillPixelPatch (DepthMap.cpp:423-459):
      weight  = exp(-(I_k - I_c)^2/(2*0.1^2) - |o_k|^2/(2*(hw-1)^2))
      tm      = sum(w I) / sum(w)
      wtm_k   = w_k (I_k - tm)
      normSq0 = sum(wtm_k (I_k - tm))
    """
    offs = texel_offsets(opts)
    sigma_color = -1.0 / (2.0 * 0.1 ** 2)
    sigma_spatial = -1.0 / (2.0 * float(opts.window_half - 1) ** 2)
    H, W = ref.shape
    pad = opts.window_half
    refp = F.pad(ref[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    texels = torch.stack([refp[int(dy) + pad: int(dy) + pad + H,
                               int(dx) + pad: int(dx) + pad + W]
                          for dx, dy in offs])                    # (T, H, W)
    diff = texels - ref[None]
    w_spatial = torch.from_numpy(
        (offs[:, 0] ** 2 + offs[:, 1] ** 2) * np.float32(sigma_spatial)
    ).to(ref.device)[:, None, None]
    w = fmath.exp(fma(diff * diff, float(np.float32(sigma_color)), w_spatial))
    # sums over the texel axis run in texel order (as XLA's reductions do,
    # and the same on every device), products fused into the accumulation
    sum_w = w[0]
    wt = w[0] * texels[0]
    for k in range(1, len(offs)):
        sum_w = sum_w + w[k]
        wt = fma(w[k], texels[k], wt)
    tm = wt / sum_w
    t_centered = texels - tm[None]
    wtm = w * t_centered
    norm_sq0 = wtm[0] * t_centered[0]
    for k in range(1, len(offs)):
        norm_sq0 = fma(wtm[k], t_centered[k], norm_sq0)
    return w.contiguous(), wtm.contiguous(), sum_w, norm_sq0


# ------------------------------------------------------------- scoring


def _score_one_view_scan(data: PMData, opts: DenseOptions, depth, normal,
                         inv_nd, img, size, Hl, Hm, exact: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, in-bounds) of C hypothesis maps in one view: the plain K1."""
    return pm_kernel.score_view_plain(
        img, size, Hl, Hm, depth, normal, inv_nd, data.X0, data.goff, data.w,
        data.wtm, data.sum_w, data.norm_sq0, th_robust=float(opts.th_robust),
        nearest=not exact)


def _bilinear_warp(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``pm_kernel._bilinear``'s blend with the contraction XLA gives it in
    the warp-once scorer: the left-hand term of every sum fused."""
    v00, v01, v10, v11, fx, fy = pm_kernel._corners(img, x, y)
    top = fma(v00, 1 - fx, v01 * fx)
    bot = fma(v10, 1 - fx, v11 * fx)
    return fma(top, 1 - fy, bot * fy)


def _score_one_view_warp(data: PMData, opts: DenseOptions, depth, normal,
                         inv_nd, img, size, Hl, Hm
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, in-bounds) of C hypothesis maps in one view, warp-once
    (``openmvs_tpu/ops/patchmatch.py:344-418``): the neighbour image is
    sampled once per pixel and candidate at the hypothesis field's warp
    (bilinear), and the window statistics are taken over the warped image
    with dense shifts, texel by texel in ``texel_offsets`` order. It equals
    the per-texel warp where the hypothesis field is locally planar."""
    th_robust = float(opts.th_robust)
    h_j, w_j = size[0], size[1]
    X0 = data.X0
    SX0 = pm_kernel._mat3(Hl, X0[..., 0], X0[..., 1], X0[..., 2])
    inv_d = 1.0 / depth
    sx = fma(Hm[0], inv_d, SX0[0][None])
    sy = fma(Hm[1], inv_d, SX0[1][None])
    sz = fma(Hm[2], inv_d, SX0[2][None])
    zok = sz > 1e-8
    izs = torch.where(zok, 1.0 / torch.where(zok, sz, 1.0), 0.0)
    px = sx * izs
    py = sy * izs
    inb0 = zok & (px >= 1) & (px <= w_j - 2) & (py >= 1) & (py <= h_j - 2)
    warped = torch.where(inb0, _bilinear_warp(img, px, py), 0.0)
    b = opts.window_half
    wp = F.pad(warped, (b, b, b, b))
    ip = F.pad(inb0, (b, b, b, b))
    C, H, W = depth.shape
    num = torch.zeros_like(depth)
    ssum = torch.zeros_like(depth)
    ssq = torch.zeros_like(depth)
    inb = torch.ones(depth.shape, dtype=torch.bool, device=depth.device)
    for k, (dx, dy) in enumerate(texel_offsets(opts).astype(int)):
        val = wp[:, dy + b:dy + b + H, dx + b:dx + b + W]
        inb = inb & ip[:, dy + b:dy + b + H, dx + b:dx + b + W]
        num = fma(val, data.wtm[k][None], num)
        ssum = fma(val, data.w[k][None], ssum)
        ssq = fma(val * val, data.w[k][None], ssq)
    score = pm_kernel.zncc_score(num, ssum, ssq, inb, data.sum_w,
                                 data.norm_sq0, th_robust, reciprocal=False)
    return score, inb


def _geometric_term(data: PMData, opts: DenseOptions, depth, dm, size, Tl,
                    Tm, Tr, Tn, force_xla: bool = False) -> torch.Tensor:
    """Forward-backward reprojection consistency (DepthMap.cpp:535-551) of
    C candidate depth maps against one neighbour: K3 on CUDA tensors; the
    plain version (the JAX package's XLA body) on CPU tensors or with
    ``force_xla``."""
    fn = pm_kernel.geom_term_plain if force_xla else pm_kernel.geom_term
    return fn(dm, size, Tl, Tm, Tr, Tn, depth, data.X0, data.uv)


def _shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with zero fill: out[y, x] = a[y+dy, x+dx] (leading 2 axes)."""
    H, W = a.shape[:2]
    out = torch.zeros_like(a)
    ys, yd = (slice(dy, H), slice(0, H - dy)) if dy >= 0 else (slice(0, H + dy), slice(-dy, H))
    xs, xd = (slice(dx, W), slice(0, W - dx)) if dx >= 0 else (slice(0, W + dx), slice(-dx, W))
    out[yd, xd] = a[ys, xs]
    return out



def _smoothness_bonus(data: PMData, opts: DenseOptions, state: PMState,
                      depth: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Plane-smoothness bonus factor vs the current 4-neighborhood estimates
    (DENSE_SMOOTHNESS_PLANE branch of ScorePixelImage, DepthMap.cpp:522-534);
    depth/normal are (C, H, W[, 3]) candidate maps."""
    plane_d = depth * _dot3(normal, data.X0[None])
    P3 = data.X0 * state.depth[..., None]
    bonus = torch.ones_like(depth)
    bd, bn = opts.smooth_bonus_depth, opts.smooth_bonus_normal
    sd, sn = opts.smooth_sigma_depth, opts.smooth_sigma_normal
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        nb_d = _shift2d(state.depth, dy, dx)
        nb_n = _shift2d(state.normal, dy, dx)
        nb_P = _shift2d(P3, dy, dx)
        valid = nb_d > 0
        dist = _dot3(nb_P[None], normal) - plane_d
        q = dist / depth
        f_depth = fmath.exp(q * q * sd)
        cosang = torch.clamp(_dot3(normal, nb_n[None]), -1.0, 1.0)
        ang = fmath.arccos(cosang)
        f_norm = fmath.exp(ang * ang * sn)
        factor = fma(-bd, f_depth, 1.0) * fma(-bn, f_norm, 1.0)
        bonus = bonus * torch.where(valid[None], factor, 1.0)
    return bonus


def score_hypotheses(data: PMData, opts: DenseOptions, state: PMState,
                     depth: torch.Tensor, normal: torch.Tensor, n_views: int,
                     use_geom: bool, mode: str = "exact",
                     bonus: torch.Tensor = None,
                     geom_terms: torch.Tensor = None,
                     band_act: torch.Tensor = None,
                     switches: Switches = Switches()) -> torch.Tensor:
    """Aggregated multi-view scores (C, H, W) of C (depth, normal) maps.

    mode: "exact" = per-texel bilinear plane-induced warp (reference
    semantics); "nn" = per-texel nearest sampling; "warp" = warp-once with
    window sums (``_score_one_view_warp``, plain PyTorch). For "exact" and
    "nn" one launch of the multi-view scorer (``pm_kernel.score_views``)
    scores every view, weights it by the smoothness bonus and the geometric
    term, blends it with the low-res prior, clips it at 2, and aggregates
    min-mean over the best two views (DepthMap.cpp:594-609); "warp" does the
    same per view with ``pm_kernel.finish_views``.

    With ``use_geom`` the geometric term of view j is ``geom_terms[j]``
    when a precomputed (V, C, H, W) stack is given (the split sweep), else
    the scorer computes it (K2-mv), or K3-mv computes the stack first where
    ``switches.geom_fused`` is off or in mode "warp"; all give the same term.
    ``band_act`` (bands of ``pm_kernel.BAND_ROWS`` rows) skips the scoring of
    flagged-off bands ("exact" and "nn" only)."""
    if mode not in ("exact", "nn", "warp"):
        raise ValueError(f"scoring mode {mode!r} is not ported")
    inv_nd, bonus, f_blend, delta = score_prelude(data, opts, state, depth,
                                                  normal, bonus)
    depth = depth.contiguous()
    normal = normal.contiguous()
    v = data.views
    n = n_views
    if mode == "warp":
        if band_act is not None:
            raise ValueError("band skipping applies to modes exact and nn")
        if use_geom and geom_terms is None:
            geom_terms = _geom_all_views(data, n_views, depth, switches)

        def per_view(j):
            s = _score_one_view_warp(data, opts, depth, normal, inv_nd,
                                     v.image[j], v.size[j], v.Hl[j], v.Hm[j])[0]
            return s, geom_terms[j] if use_geom else None

        return pm_kernel.finish_views(
            per_view, n, v.size, bonus, f_blend, delta, data.lowres,
            th_robust=float(opts.th_robust),
            geom_weight=float(opts.estimation_geometric_weight))
    geom = {}
    if use_geom:
        if geom_terms is None and not switches.geom_fused:
            geom_terms = _geom_all_views(data, n_views, depth, switches)
        if geom_terms is None:
            geom = dict(Tr=v.Tr[:n], Tn=v.Tn[:n], dms=v.depth[:n], uv=data.uv)
        else:
            geom = dict(geom_terms=geom_terms[:n].contiguous())
    return pm_kernel.score_views(
        v.image[:n], v.size[:n], v.Hl[:n], v.Hm[:n], depth, normal, inv_nd,
        data.X0, data.goff, data.w, data.wtm, data.sum_w, data.norm_sq0,
        bonus.contiguous(), f_blend, delta, data.lowres.contiguous(),
        th_robust=float(opts.th_robust),
        geom_weight=float(opts.estimation_geometric_weight),
        nearest=mode == "nn", band_act=band_act, **geom)


def score_prelude(data: PMData, opts: DenseOptions, state: PMState,
                  depth: torch.Tensor, normal: torch.Tensor,
                  bonus: torch.Tensor = None):
    """(inv_nd, bonus, f_blend, delta): what ``score_hypotheses`` computes
    before scoring C (depth, normal) maps, each (C, H, W) but f_blend
    (H, W). ``bonus`` is the smoothness bonus unless given."""
    inv_nd_den = _dot3(normal, data.X0[None]) * depth
    safe = torch.abs(inv_nd_den) > 1e-12
    inv_nd = torch.where(safe, 1.0 / torch.where(safe, inv_nd_den, 1.0), 0.0)
    if bonus is None:
        bonus = _smoothness_bonus(data, opts, state, depth, normal)
    d0 = data.lowres
    f_blend = fmath.exp(data.norm_sq0 * (-1.0 / 0.02))
    # XLA turns the division by the broadcast prior into a reciprocal
    # multiply
    delta = torch.clamp(torch.abs(d0[None] - depth)
                        * (1.0 / torch.clamp(d0, min=1e-12))[None], max=0.5)
    return inv_nd, bonus, f_blend, delta


# ------------------------------------------------------------- candidates


def _normal_to_dir(n: torch.Tensor):
    theta = fmath.atan2(n[..., 1], n[..., 0])
    phi = fmath.arccos(torch.clamp(n[..., 2], -1.0, 1.0))
    return theta, phi


def _dir_to_normal(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    sp = fmath.sin(phi)
    return torch.stack([fmath.cos(theta) * sp, fmath.sin(theta) * sp,
                        fmath.cos(phi)], dim=-1)


def _random_normal(key, uv, view_dir, old_rng: bool = False):
    """Random camera-facing normal (DepthMap.h:439-444)."""
    k1, k2 = rng.split(key)
    theta = rng.block_uniform(k1, uv, 0.0, math.pi, old_rng)
    phi = rng.block_uniform(k2, uv, math.pi / 2, math.pi, old_rng)
    n = _dir_to_normal(theta, phi)
    flip = _dot3(n, view_dir) > 0
    return torch.where(flip[..., None], -n, n)


def _random_depth(key, uv, d_min, d_max, old_rng: bool = False):
    """sqrt-space uniform random depth (DepthMap.h:435-438)."""
    u = rng.block_uniform(key, uv, old_rng=old_rng)
    r = fma(u, torch.sqrt(d_max) - torch.sqrt(d_min), torch.sqrt(d_min))
    return r * r


def _propagate_candidate(data: PMData, state: PMState, opts: DenseOptions,
                         dy: int, dx: int):
    """Neighbor estimate re-interpolated to this pixel via its plane
    (ray-plane form of InterpolatePixel, DepthMap.cpp:916-960)."""
    nb_d = _shift2d(state.depth, dy, dx)
    nb_n = _shift2d(state.normal, dy, dx)
    nb_conf = _shift2d(state.conf, dy, dx)
    nb_X0 = _shift2d(data.X0, dy, dx)
    plane_d = nb_d * _dot3(nb_n, nb_X0)
    den = _dot3(nb_n, data.X0)
    safe = torch.abs(den) > 1e-12
    d_new = torch.where(safe, plane_d / torch.where(safe, den, 1.0), nb_d)
    d_new = torch.where((d_new >= data.d_min) & (d_new <= data.d_max), d_new, nb_d)
    # only propagate from valid, confident neighbors facing the camera
    facing = den < 0
    ok = (nb_d > 0) & (nb_conf < opts.ncc_threshold_keep) & facing
    return d_new, nb_n, ok


def _perturb_candidate(data: PMData, state: PMState, opts: DenseOptions, key,
                       extra_scale: float, old_rng: bool = False):
    """Random refinement around the current estimate (DepthMap.cpp:800-852);
    the search range shrinks with the current confidence."""
    uniform = functools.partial(rng.block_uniform, uv=data.uv, old_rng=old_rng)
    conf = state.conf
    idx_scale = torch.where(
        conf <= opts.th_conf_small, opts.random_max_scale,
        torch.where(conf <= opts.th_conf_big, min(1, opts.random_max_scale), 0)
    ).to(torch.float32)
    # powers of two, exact on every device
    scale = torch.pow(0.5, idx_scale.double()).float() * extra_scale
    k1, k2, k3, k4, k5 = rng.split(key, 5)
    depth_range = state.depth * opts.random_depth_ratio
    d_new = fma((uniform(k1) * 2 - 1) * depth_range, scale, state.depth)
    theta, phi = _normal_to_dir(state.normal)
    a1 = math.radians(opts.random_angle1_range)
    a2 = math.radians(opts.random_angle2_range)
    theta = fma((uniform(k2) * 2 - 1) * a1, scale, theta)
    phi = fma((uniform(k3) * 2 - 1) * a2, scale, phi)
    n_new = _dir_to_normal(theta, phi)

    # fully random restart where the current estimate is hopeless
    rand_d = _random_depth(k4, data.uv, data.d_min, data.d_max, old_rng)
    rand_n = _random_normal(k5, data.uv, data.X0, old_rng)
    hopeless = conf >= opts.th_conf_rand
    d_new = torch.where(hopeless, rand_d, d_new)
    n_new = torch.where(hopeless[..., None], rand_n, n_new)
    ok = ((d_new >= data.d_min) & (d_new <= data.d_max)
          & (_dot3(n_new, data.X0) < 0))
    return d_new, n_new, ok


def _probe_candidates(data: PMData, state: PMState, opts: DenseOptions, key,
                      old_rng: bool = False):
    """Field-coherent refinement probes for the warp-once scorer
    (``openmvs_tpu/ops/patchmatch.py:798-832``): the warp scorer reads the
    hypothesis field over each window, so per-pixel random perturbations
    average out. Instead: depth-scale ladders around the current field, two
    normals rotated by block-random offsets, and one block-random restart
    where the estimate is hopeless."""
    uniform = functools.partial(rng.block_uniform, uv=data.uv, old_rng=old_rng)
    out = []
    r = opts.random_depth_ratio
    for delta in (4 * r, -4 * r, r, -r, 0.25 * r, -0.25 * r):
        d_new = state.depth * (1.0 + delta)
        ok = (d_new >= data.d_min) & (d_new <= data.d_max) & (state.depth > 0)
        out.append((d_new, state.normal, ok))
    k1, k2, k3, k4 = rng.split(key, 4)
    theta, phi = _normal_to_dir(state.normal)
    a1 = math.radians(opts.random_angle1_range)
    a2 = math.radians(opts.random_angle2_range)
    for kk in (k1, k2):
        ka, kb = rng.split(kk)
        t2 = fma(uniform(ka) * 2 - 1, a1, theta)
        p2 = fma(uniform(kb) * 2 - 1, a2, phi)
        n_new = _dir_to_normal(t2, p2)
        ok = (state.depth > 0) & (_dot3(n_new, data.X0) < 0)
        out.append((state.depth, n_new, ok))
    rand_d = _random_depth(k3, data.uv, data.d_min, data.d_max, old_rng)
    rand_n = _random_normal(k4, data.uv, data.X0, old_rng)
    hopeless = state.conf >= opts.th_conf_rand
    jitter = fma((uniform(k3) * 2 - 1) * 16, r, 1.0)
    d_new = torch.where(hopeless, rand_d, state.depth * jitter)
    n_new = torch.where(hopeless[..., None], rand_n, state.normal)
    ok = (d_new >= data.d_min) & (d_new <= data.d_max)
    out.append((d_new, n_new, ok))
    return out


# propagation neighborhood: 4-adjacent plus 4 longer-range samples so
# information travels faster than one pixel per half-iteration
# (PatchMatchCUDA.cu:389-548 uses near+far samples similarly)
PROP_OFFSETS = ((0, 1), (0, -1), (1, 0), (-1, 0), (0, 5), (0, -5), (5, 0), (-5, 0))


def _prop_cand_list(data, state, opts, n_prop):
    return [_propagate_candidate(data, state, opts, dy, dx)
            for dy, dx in PROP_OFFSETS[:n_prop]]


def _perturb_cand_list(data, state, opts, key, parity, n_perturb, mode="nn",
                      old_rng: bool = False):
    """Perturb candidates with the fold_in(parity*131 + r) key schedule; in
    mode "warp" the probes of ``_probe_candidates`` with fold_in(parity*131)."""
    if mode == "warp":
        return _probe_candidates(data, state, opts, rng.fold_in(key, parity * 131),
                                 old_rng)
    return [_perturb_candidate(data, state, opts, rng.fold_in(key, parity * 131 + r),
                               SCALE_RANGES[r], old_rng)
            for r in range(n_perturb)]


def _stack_cands(cand):
    cd = torch.stack([c[0] for c in cand])      # (C, H, W)
    cn = torch.stack([c[1] for c in cand])      # (C, H, W, 3)
    cok = torch.stack([c[2] for c in cand])     # (C, H, W)
    return cd, cn, cok


def _build_candidates(state, data, opts, key, parity, n_perturb, n_prop,
                      mode="nn", switches: Switches = Switches()):
    """(cd, cn, cok) for one parity half-step: the one construction both
    the fused and the split sweep use, so they see the same candidates."""
    return _stack_cands(
        _prop_cand_list(data, state, opts, n_prop)
        + _perturb_cand_list(data, state, opts, key, parity, n_perturb, mode,
                             switches.old_rng))


def _parity_map(data: PMData) -> torch.Tensor:
    """(H, W) checkerboard parity from the global data.uv (a row-tiled
    shard keeps the full lattice)."""
    return (data.uv[..., 0] + data.uv[..., 1]).to(torch.int32) % 2


def _active(data: PMData, parity: int) -> torch.Tensor:
    """Valid pixels of one checkerboard parity."""
    return (_parity_map(data) == parity) & data.valid


def _sweep_parity(state, data, opts, key, n_views, use_geom, n_perturb, mode,
                  parity, n_prop, active_eps=0.0, conf_prev=None,
                  switches: Switches = Switches()):
    cd, cn, cok = _build_candidates(state, data, opts, key, parity, n_perturb,
                                    n_prop, mode, switches)
    band_act = None
    if active_eps and conf_prev is not None:
        band_act = _band_flags(state, data, conf_prev, parity, mode, active_eps)
    return _score_select(state, data, opts, cd, cn, cok, _active(data, parity),
                         n_views, use_geom, mode, band_act=band_act, switches=switches)


# band half-sweeps scored and skipped by convergence skipping, over the
# process (chip_smoke.py reads them around a densify run). "skipped" is
# summed on the flags' device, so counting never synchronises the sweep:
# read it with int() after the run.
BANDS = {"scored": 0, "skipped": 0}


def _band_flags(state, data, conf_prev, parity, mode, eps):
    """(ceil(H / 16),) bool: the bands of 16 image rows to score in this
    half-step, or None where skipping does not apply. A band is skipped
    where no pixel of the active parity improved its confidence by more
    than ``eps`` in the previous sweep (``conf_prev`` is the confidence
    before it), as the JAX package flags the 8-row tiles of its row-pair
    compacted lattice (``_score_select``, patchmatch.py:1210-1303): the
    churn of an invalid pixel counts 0, and so does a padded row past H.
    Odd H or W (compaction off there) and mode "warp" skip nothing."""
    H, W = state.conf.shape
    if H % 2 or W % 2 or mode not in ("exact", "nn"):
        return None
    on_parity = _parity_map(data) == parity
    churn = torch.where(on_parity, torch.where(data.valid, conf_prev - state.conf, 0.0),
                        -math.inf)
    nb = -(-H // pm_kernel.BAND_ROWS)
    pad = nb * pm_kernel.BAND_ROWS - H
    if pad:
        churn = torch.cat([churn, churn.new_zeros((pad, W))])
    return torch.amax(churn.reshape(nb, -1), dim=1) > eps


def _count_bands(scored: int, skipped) -> None:
    with pm_kernel.COUNT_LOCK:
        BANDS["scored"] += scored
        if skipped is not None:
            prev = BANDS["skipped"]
            # kept on the first flags' device (worker threads may sweep on
            # several devices)
            BANDS["skipped"] = (prev + skipped.to(prev.device) if torch.is_tensor(prev)
                                else prev + skipped)


def _score_select(state, data, opts, cd, cn, cok, active, n_views, use_geom,
                  mode, geom_terms=None, band_act=None, switches: Switches = Switches()):
    """Score a candidate stack and take per-parity winners vs the incumbent
    (every pixel is scored; the active parity decides who may update).
    Pixels of bands that ``band_act`` skips never update."""
    s = score_hypotheses(data, opts, state, cd, cn, n_views, use_geom, mode,
                         geom_terms=geom_terms, band_act=band_act, switches=switches)
    s = torch.where(cok, s, math.inf)
    best = torch.argmin(s, dim=0)[None]            # first index on ties
    s_best = torch.gather(s, 0, best)[0]
    d_best = torch.gather(cd, 0, best)[0]
    n_best = torch.gather(cn, 0, best[..., None].expand(1, *cn.shape[1:]))[0]
    take = active & (s_best < state.conf)
    nb = -(-state.conf.shape[0] // pm_kernel.BAND_ROWS)
    skipped = None
    if band_act is not None:
        take = take & pm_kernel.band_rows(band_act, take.shape[0])[:, None]
        skipped = (~band_act).sum()
    pm_kernel.host_effect(functools.partial(_count_bands, nb, skipped))
    return PMState(
        depth=torch.where(take, d_best, state.depth),
        normal=torch.where(take[..., None], n_best, state.normal),
        conf=torch.where(take, s_best, state.conf),
    )


def _rescored(state: PMState, data: PMData, opts, n_views, use_geom, mode,
              geom_terms=None, switches: Switches = Switches()):
    """The incumbent state with its confidence rescored in ``mode``."""
    cur = score_hypotheses(data, opts, state, state.depth[None],
                           state.normal[None], n_views, use_geom, mode,
                           geom_terms=geom_terms, switches=switches)[0]
    return PMState(depth=state.depth, normal=state.normal,
                   conf=torch.where(data.valid, cur, 2.0))


# ------------------------------------------------------------- split sweep


def _geom_all_views(data: PMData, n_views: int, depth_c: torch.Tensor,
                    switches: Switches = Switches()) -> torch.Tensor:
    """(V, C, H, W) geometric terms of candidate depths ``depth_c`` against
    the first ``n_views`` neighbours, from one launch of K3-mv (the plain
    version on CPU tensors). ``switches.geom_debug`` prints each call's
    comparison with the plain version (after the device work, at each
    replay where the call is captured)."""
    v = data.views
    depth_c = depth_c.contiguous()
    out = pm_kernel.geom_terms(
        *(t[:n_views] for t in (v.depth, v.size, v.Tl, v.Tm, v.Tr, v.Tn)),
        depth_c, data.X0, data.uv)
    if switches.geom_debug:
        ref = torch.stack([
            _geometric_term(data, None, depth_c, v.depth[j], v.size[j], v.Tl[j],
                            v.Tm[j], v.Tr[j], v.Tn[j], force_xla=True)
            for j in range(n_views)])
        d = torch.abs(out - ref)
        pm_kernel.host_effect(functools.partial(
            _print_geom_debug, depth_c.shape[0], n_views, d.numel(),
            (d > 0.1).sum(), d.mean(), d.max()))
    return out


def _print_geom_debug(C, V, n, n_bad, mean, d_max) -> None:
    print(f"[geom-debug] C={C} V={V} frac>{0.1}: {int(n_bad) / n:.4f}  "
          f"mean|d|={float(mean):.4f} max|d|={float(d_max):.3f}", flush=True)


def _sweep_geom_split(state, data, opts, key, n_views, n_perturb, mode,
                      rescore_state, n_prop, switches: Switches):
    """A geometric sweep in three steps per half-step: candidates, their
    geometric terms against every view (K3-mv), then scoring with the terms
    precomputed and selection."""
    if rescore_state:
        g = _geom_all_views(data, n_views, state.depth[None], switches)
        state = _rescored(state, data, opts, n_views, True, mode, g, switches)
    for parity in (0, 1):
        cd, cn, cok = _build_candidates(state, data, opts, key, parity,
                                        n_perturb, n_prop, mode, switches)
        g = _geom_all_views(data, n_views, cd, switches)
        state = _score_select(state, data, opts, cd, cn, cok, _active(data, parity),
                              n_views, True, mode, geom_terms=g, switches=switches)
    return state


def sweep(state: PMState, data: PMData, opts: DenseOptions, key, n_views: int,
          use_geom: bool = False, n_perturb: int = 3, mode: str = "nn",
          rescore_state: bool = False, n_prop: int = len(PROP_OFFSETS),
          fold: int = 0, active_eps: float = 0.0, conf_prev=None,
          switches: Switches = Switches()) -> PMState:
    """One full PatchMatch iteration = two checkerboard half-steps.

    fold != 0 derives this iteration's key as fold_in(key, fold);
    rescore_state rescores the incumbent in ``mode`` first (scores from
    another sampling mode are not comparable). ``active_eps`` > 0 with
    ``conf_prev`` (the confidence before the previous sweep) skips the
    bands that did not improve by more than ``active_eps`` in it
    (``_band_flags``); the split geometric sweep skips nothing.

    ``switches.geom_split`` splits a geometric sweep in three steps per
    half-step (the JAX package's ``_sweep_geom_split``; ``Switches``)."""
    if fold:
        key = rng.fold_in(key, fold)
    if use_geom and switches.geom_split:
        return _sweep_geom_split(state, data, opts, key, n_views, n_perturb,
                                 mode, rescore_state, n_prop, switches)
    if rescore_state:
        state = _rescored(state, data, opts, n_views, use_geom, mode, switches=switches)
    for parity in (0, 1):
        state = _sweep_parity(state, data, opts, key, n_views, use_geom,
                              n_perturb, mode, parity, n_prop, active_eps,
                              conf_prev, switches)
    return state


def sweep_half(state: PMState, data: PMData, opts: DenseOptions, key,
               n_views: int, use_geom: bool = False, n_perturb: int = 3,
               mode: str = "nn", parity: int = 0,
               n_prop: int = len(PROP_OFFSETS), switches: Switches = Switches()) -> PMState:
    """One checkerboard half-step (one parity)."""
    return _sweep_parity(state, data, opts, key, n_views, use_geom, n_perturb,
                         mode, parity, n_prop, switches=switches)


def sweep_block_adaptive(state: PMState, data: PMData, opts: DenseOptions, key,
                         n_views: int, use_geom: bool = False,
                         n_perturb: int = 3, mode: str = "nn",
                         n_prop: int = len(PROP_OFFSETS), first_fold: int = 1,
                         n_sweeps: int = 3, min_sweeps: int = 2,
                         eps: float = 5e-3, min_frac: float = 0.01,
                         switches: Switches = Switches()):
    """Up to n_sweeps identical search sweeps with convergence-based early
    exit: after sweep k >= min_sweeps the block stops when the share of
    valid pixels whose score improved by more than ``eps`` in sweep k falls
    below ``min_frac`` (one host read per sweep). Sweep k uses
    fold_in(key, first_fold + k), as the eager loop does. Returns
    (state, n_done)."""
    n_valid = torch.clamp(torch.sum(data.valid.to(torch.float32)), min=1.0)
    it = 0
    go_on = True
    while it < n_sweeps and (it < min_sweeps or go_on):
        k = rng.fold_in(key, first_fold + it)
        old_conf = state.conf
        for parity in (0, 1):
            state = _sweep_parity(state, data, opts, k, n_views, use_geom,
                                  n_perturb, mode, parity, n_prop, switches=switches)
        improved = ((old_conf - state.conf) > eps) & data.valid
        frac = torch.sum(improved.to(torch.float32)) / n_valid
        it += 1
        if it < n_sweeps:
            # compared in float32, as the JAX loop condition does
            go_on = bool(frac >= min_frac)
    return state, it


def init_state(data: PMData, opts: DenseOptions, key, seed_depth, seed_normal,
               n_views: int, use_geom: bool = False, mode: str = "exact",
               switches: Switches = Switches()) -> PMState:
    """Initialize state from seeds; random where seeds are missing
    (ScoreDepthMapTmp, SceneDensify.cpp:490-517). The incumbent is scored
    in the first sweep's sampling mode."""
    dev = data.ref.device
    seed_depth = torch.as_tensor(seed_depth, dtype=torch.float32, device=dev)
    seed_normal = torch.as_tensor(seed_normal, dtype=torch.float32, device=dev)
    k1, k2 = rng.split(key, 2)
    rand_d = _random_depth(k1, data.uv, data.d_min, data.d_max, switches.old_rng)
    rand_n = _random_normal(k2, data.uv, data.X0, switches.old_rng)
    has_seed = (seed_depth >= data.d_min) & (seed_depth <= data.d_max)
    depth = torch.where(has_seed, seed_depth, rand_d)
    nrm = _norm3(seed_normal)
    facing = _dot3(seed_normal, data.X0) < 0
    seed_n_ok = has_seed & (nrm > 0.5) & facing
    normal = torch.where(seed_n_ok[..., None], seed_normal, rand_n)
    normal = normal / torch.clamp(_norm3(normal)[..., None], min=1e-12)
    state0 = PMState(depth=depth, normal=normal,
                     conf=torch.full(depth.shape, 2.0, device=dev))
    conf = score_hypotheses(data, opts, state0, depth[None], normal[None], n_views,
                            use_geom, mode, switches=switches)[0]
    conf = torch.where(data.valid, conf, 2.0)
    depth = torch.where(data.valid, depth, 0.0)
    return PMState(depth=depth, normal=normal, conf=conf)


def pack_state(state: PMState) -> torch.Tensor:
    """(H, W, 5) = [depth, normal xyz, conf], downloaded in one transfer."""
    return torch.cat([state.depth[..., None], state.normal,
                      state.conf[..., None]], dim=-1)


@safety.checked
def finalize(state: PMState, data: PMData, opts: DenseOptions,
             geometric_follows: bool) -> PMState:
    """Threshold scores and convert to [0,1] confidence (EndDepthMapTmp,
    SceneDensify.cpp:530-575). Under OMVS_CHECKIFY=1 a non-finite output
    raises here, on the device, before densify downloads it."""
    keep = opts.ncc_threshold_keep * (1.333 if geometric_follows else 1.0)
    bad = (state.depth <= 0) | (state.conf >= keep) | ~data.valid
    conf = torch.where(state.conf >= 1.0, 0.0, 1.0 - state.conf)
    conf = torch.where(bad, 0.0, conf)
    depth = torch.where(bad, 0.0, state.depth)
    normal = torch.where(bad[..., None], 0.0, state.normal)
    return PMState(depth=depth, normal=normal, conf=conf)
