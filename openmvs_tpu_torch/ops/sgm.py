"""Semi-global matching, in torch.

Counterpart of ``openmvs_tpu/ops/sgm.py`` (the reference's
SemiGlobalMatcher, libs/MVS/SemiGlobalMatcher.{h,cpp}): rectified-pair
stereo with census, ZNCC or bilateral-weighted ZNCC costs, directional
dynamic programming with intensity-adaptive P2, the left-right
cross-check and sub-pixel refinement; ``match_pair_tsgm`` is the
coarse-to-fine driver of densify's SGM estimator.

The JAX package reaches no Pallas kernel here (its volumes and scans are
XLA-jitted jnp). On the card two hand-written kernels take its jitted
programs' work: ``csrc/wzncc_volume.cu`` computes the masked WZNCC cost
volumes of a batch of pairs in one launch (``wzncc_volume_masked``, for
``_wzncc_volume0`` and ``mask_volume``), and ``csrc/sgm_scan.cu`` runs
every batch of directional DP passes in one launch (``sgm_scan``, for
``aggregate8``'s ``lax.scan``s). Each has a plain version that the CPU
runs and the kernel repeats op for op:

* the plain cost volume (``_wzncc_volumes``) is accumulated per texel
  offset over chunks of disparities, never one launch per disparity, and
  masked per pair by ``mask_volume``;
* each batch of DP passes has one (B, N, M, D) layout: the forward and
  reverse passes of an axis, the four diagonal passes (a dx = -1 pass is a
  dx = +1 pass over the column-flipped volume) and, in ``match_pair_tsgm``,
  the left and right matches of a level. Its plain version,
  ``_scan_passes_plain``, is a Python loop over rows or columns with a
  (B, M, D) carry; any D runs on both;
* the passes are summed in the JAX order, and where XLA's CPU backend
  fuses a multiply-add or evaluates exp its own way the port does the same
  (``utils/fmath``), so the card equals the CPU to the bit. Only rsqrt is
  rounded correctly here: XLA refines the CPU's hardware estimate, which
  no other device repeats.

A matching level (``_level_body``: the weights, both directions' masked
volumes, ``aggregate8`` and the winners) runs op by op
(``_match_level``) or, given a ``graphs.Runners``, as its shape class's
``LevelProgram``: one CUDA graph replayed over static buffers on the card.
``wzncc_weights`` stays plain PyTorch inside it.

Host steps stay numpy and scipy, as in the JAX package: the range maps,
the disparity flip, the sub-pixel fits, the speckle filter (OpenCV's
filterSpeckles rebuilt on scipy's connected components), rectification
(``io/images.warp_perspective`` for cv2.warpPerspective), and the depth
projection and fusion.
"""

from __future__ import annotations

import ctypes
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from openmvs_tpu_torch.io import images as imio
from openmvs_tpu_torch.ops import _build
from openmvs_tpu_torch.ops.pm_kernel import count_launch
from openmvs_tpu_torch.utils import device as devmod
from openmvs_tpu_torch.utils.fmath import exp_xla, fma, rsqrt

CMAX = np.uint8(255)          # invalid / worst cost (SemiGlobalMatcher.cpp)
_BIG = 1e9                    # the DP's out-of-range carry, exact in float32
# disparities per chunk of the WZNCC volume: at most this many elements
# per (B, chunk, H, W) accumulator
_CHUNK_ELEMS = 1 << 25


def _f32(x) -> float:
    return float(np.float32(x))


def _pad_edge(img: torch.Tensor, r: int) -> torch.Tensor:
    """``jnp.pad(img, r, mode="edge")`` over the last two axes."""
    if r == 0:
        return img
    shape = img.shape
    out = F.pad(img.reshape(-1, 1, *shape[-2:]), (r, r, r, r), mode="replicate")
    return out.reshape(*shape[:-2], *out.shape[-2:])


# --------------------------------------------------------------- cost volume
def census_transform(img: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Census bit pattern per pixel, (2r+1)^2 - 1 comparisons with the
    edge-padded neighbourhood: (H, W, n_words) int64 words holding the
    JAX package's uint32 bits (bits beyond 32 spill into more words)."""
    r = window // 2
    H, W = img.shape
    n_words = -(-(window * window - 1) // 32)
    pad = _pad_edge(img, r)
    words = [torch.zeros((H, W), dtype=torch.int64, device=img.device)
             for _ in range(n_words)]
    b = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            nb = pad[dy + r:dy + r + H, dx + r:dx + r + W]
            words[b // 32] |= (nb < img).to(torch.int64) << (b % 32)
            b += 1
    return torch.stack(words, dim=-1)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word, on int32 or int64 tensors (torch has
    no uint32 arithmetic on every op): the JAX package's mask-and-add
    form, with the final multiply's wrap-around to 32 bits made
    explicit."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _shift_columns(x: torch.Tensor, d_min: int, num_d: int):
    """(x shifted by each d = d_min + i along axis 1: (num_d, H, W, ...)
    with out[i][:, c] = x[:, c - d] and zeros past the border, and the
    (num_d, W) mask of those border columns)."""
    W = x.shape[1]
    ds = torch.arange(num_d, device=x.device) + d_min
    src = torch.arange(W, device=x.device)[None, :] - ds[:, None]
    invalid = (src < 0) | (src >= W)
    padded = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    out = padded[:, torch.where(invalid, W, src)]           # (H, D, W, ...)
    return out.movedim(1, 0), invalid


def census_cost_volume(left: torch.Tensor, right: torch.Tensor, d_min: int,
                       num_d: int, window: int = 5) -> torch.Tensor:
    """(H, W, D) float32 Hamming-distance volume; disparity d maps
    L(x) -> R(x - d), border columns cost every bit."""
    cl = census_transform(left, window)
    cr = census_transform(right, window)
    shifted, invalid = _shift_columns(cr, d_min, num_d)
    c = _popcount32(cl[None] ^ shifted).sum(-1).to(torch.float32)
    c = torch.where(invalid[:, None, :], float(window * window - 1), c)
    return c.permute(1, 2, 0).contiguous()


def zncc_cost_volume(left: torch.Tensor, right: torch.Tensor, d_min: int,
                     num_d: int, half: int = 3) -> torch.Tensor:
    """(H, W, D) 1 - ZNCC volume with (2 half + 1)^2 box windows, 2 at
    border columns. The box sums are cumsum differences summed as XLA sums
    ``jnp.cumsum`` (``refine._box``); the JAX package runs this function
    op by op, so nothing here fuses."""
    from openmvs_tpu_torch.refine import _box

    n_box = _box(torch.ones_like(left), half)
    mL = _box(left, half) / n_box
    vL = torch.clamp(_box(left * left, half) / n_box - mL * mL, min=1e-8)
    sh, invalid = _shift_columns(right, d_min, num_d)       # (D, H, W)
    mR = _box(sh, half) / n_box
    vR = torch.clamp(_box(sh * sh, half) / n_box - mR * mR, min=1e-8)
    cov = _box(left * sh, half) / n_box - mL * mR
    ncc = torch.clamp(cov * rsqrt(vL * vR), -1.0, 1.0)
    c = torch.where(invalid[:, None, :], 2.0, 1.0 - ncc)
    return c.permute(1, 2, 0).contiguous()


# ------------------------------------------------------------- DP aggregation
def _gradient(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.gradient`` over the last two axes: (d/dy, d/dx), central
    differences inside and one-sided ones at the edges."""
    out = []
    for dim in (-2, -1):
        n = image.shape[dim]
        if n < 2:
            raise ValueError("Shape of array too small to calculate a numerical "
                             "gradient, at least 2 elements are required.")
        a = image.narrow(dim, 0, 1)
        upper = image.narrow(dim, 1, 1) - a
        lower = image.narrow(dim, n - 1, 1) - image.narrow(dim, n - 2, 1)
        inner = (image.narrow(dim, 2, n - 2) - image.narrow(dim, 0, n - 2)) * 0.5
        out.append(torch.cat([upper, inner, lower], dim=dim))
    return out[0], out[1]


def _p2_eff(grad: torch.Tensor, p2: float, alpha: float, beta: float) -> torch.Tensor:
    """p2 (1 + alpha exp(-grad^2 / (2 beta^2))), rounded as the jitted JAX
    expression: the division by the constant becomes a multiply by its
    float32 reciprocal, exp is XLA's, and 1 + alpha e a fused
    multiply-add."""
    inv = _f32(1.0 / _f32(2 * beta * beta))
    e = exp_xla(-(grad * grad) * inv)
    return _f32(p2) * fma(alpha, e, 1.0)


def _scan_passes(xs: torch.Tensor, p2s: torch.Tensor, p1: float, shift: int,
                 diag: bool) -> torch.Tensor:
    """``_scan_passes_plain``'s passes: one ``sgm_scan`` launch on the
    card, the plain loop on the CPU."""
    return sgm_scan(xs.contiguous(), p2s.contiguous(), p1, shift, diag)


def sgm_scan(xs: torch.Tensor, p2s: torch.Tensor, p1: float, shift: int,
             diag: bool) -> torch.Tensor:
    """The kernel's wrapper: B directional DP passes of ``xs`` (B, N, M, D)
    with per-step P2 ``p2s`` (B, N, M), contiguous float32, as
    ``_scan_passes_plain`` computes them. CPU tensors run the plain
    version; CUDA tensors launch ``csrc/sgm_scan.cu`` or raise."""
    if xs.dim() != 4:
        raise ValueError(f"xs: {xs.dim()}-D, expected (B, N, M, D)")
    for name, t, shape in (("xs", xs, xs.shape), ("p2s", p2s, xs.shape[:3])):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != xs.device:
            raise ValueError(f"{name}: on {t.device}, expected {xs.device}")
    if shift not in (0, 1):
        raise ValueError(f"shift {shift}: expected 0 or 1")
    if xs.device.type == "cpu":
        return _scan_passes_plain(xs, p2s, p1, shift, diag)
    return _sgm_scan_launch(xs, p2s, p1, shift, diag)


def _sgm_scan_launch(xs, p2s, p1, shift, diag) -> torch.Tensor:
    """The card route of ``sgm_scan`` (operands already checked)."""
    if xs.device.type != "cuda":
        raise ValueError(f"sgm_scan kernel: tensors on {xs.device}, expected cuda")
    B, N, M, D = xs.shape
    out = torch.empty_like(xs)
    lib = _build.library("sgm_scan")
    with torch.cuda.device(xs.device):
        rc = lib.sgm_scan_launch(
            ctypes.c_void_p(xs.data_ptr()), ctypes.c_void_p(p2s.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), B, N, M, D, ctypes.c_float(_f32(p1)),
            int(shift), int(bool(diag)),
            ctypes.c_void_p(torch.cuda.current_stream(xs.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"sgm_scan_launch failed: {_build.error_string(rc)}")
    count_launch("sgm_scan")
    return out


def _scan_passes_plain(xs: torch.Tensor, p2s: torch.Tensor, p1: float, shift: int,
                       diag: bool) -> torch.Tensor:
    """B directional DP passes at once, each forward along axis 1 of
    ``xs`` (B, N, M, D) with per-step P2 ``p2s`` (B, N, M):

        L(d) = C(d) + min(Lp(d), Lp(d -+ 1) + p1, min Lp + P2) - min Lp

    with Lp the carry moved ``shift`` columns along M per step, the column
    moved in at ``_BIG``. ``diag`` adds the JAX diagonal pass's two clamps.
    The carry lives in a buffer whose window slides ``shift`` columns per
    step, padded along D by ``_BIG``: the moved carry and its D-neighbours
    are views, not copies. min(a + p1, b + p1) is computed as
    min(a, b) + p1, equal under round-to-nearest."""
    B, N, M, D = xs.shape
    out = torch.empty_like(xs)
    out[:, 0] = xs[:, 0]
    buf = torch.full((B, M + shift * (N - 1), D + 2), _BIG, dtype=xs.dtype,
                     device=xs.device)
    s = shift * (N - 1)
    buf[:, s:s + M, 1:-1] = xs[:, 0]
    p1 = _f32(p1)
    for t in range(1, N):
        s -= shift
        win = buf[:, s:s + M]
        lp = win[..., 1:-1]
        min_lp = lp.amin(-1, keepdim=True)
        best = torch.minimum(lp, min_lp + p2s[:, t, :, None])
        best = torch.minimum(best, torch.minimum(win[..., :-2], win[..., 2:]).add_(p1))
        L = xs[:, t] + best
        if diag:
            torch.clamp(L - torch.clamp(min_lp, max=_BIG * 0.5), max=_BIG, out=out[:, t])
        else:
            torch.sub(L, min_lp, out=out[:, t])
        lp.copy_(out[:, t])
    return out


def _dp_pass(cost: torch.Tensor, grad: torch.Tensor, p1: float, p2: float,
             alpha: float, axis: int, reverse: bool,
             beta: float = 0.1) -> torch.Tensor:
    """One directional aggregation of an (H, W, D) volume along ``axis``
    (0 vertical, 1 horizontal), ``reverse`` from the far end."""
    xs = cost.movedim(axis, 0)
    p2s = _p2_eff(grad, p2, alpha, beta).movedim(axis, 0)
    if reverse:
        xs, p2s = xs.flip(0), p2s.flip(0)
    out = _scan_passes(xs[None], p2s[None], p1, 0, False)[0]
    if reverse:
        out = out.flip(0)
    return out.movedim(0, axis)


def _dp_pass_diag(cost: torch.Tensor, grad: torch.Tensor, p1: float, p2: float,
                  alpha: float, dx: int, reverse: bool,
                  beta: float = 38.0 / 255.0) -> torch.Tensor:
    """Diagonal pass over the rows of an (H, W, D) volume with the carry
    moved ``dx`` columns per step (direction (dy=1, dx) forward, reversed
    for the opposite)."""
    xs, p2s = cost, _p2_eff(grad, p2, alpha, beta)
    if dx < 0:
        xs, p2s = xs.flip(1), p2s.flip(1)
    if reverse:
        xs, p2s = xs.flip(0), p2s.flip(0)
    out = _scan_passes(xs[None], p2s[None], p1, abs(dx), True)[0]
    if reverse:
        out = out.flip(0)
    return out.flip(1) if dx < 0 else out


def _aggregate(cost: torch.Tensor, image: torch.Tensor, p1: float, p2: float,
               alpha: float, beta: float, diagonals: bool) -> torch.Tensor:
    """Sum of the directional passes over (B, H, W, D) volumes with their
    (B, H, W) images: horizontal forward and reverse, vertical forward and
    reverse, then (``diagonals``) dx = +1 forward and reverse and dx = -1
    forward and reverse, added in that order as the JAX package adds
    them."""
    B = cost.shape[0]
    gy, gx = _gradient(image)
    ax, ay = torch.abs(gx), torch.abs(gy)
    p2x = _p2_eff(ax, p2, alpha, beta).transpose(1, 2)
    xs = cost.transpose(1, 2)
    out = _scan_passes(torch.cat([xs, xs.flip(1)]), torch.cat([p2x, p2x.flip(1)]),
                       p1, 0, False)
    total = out[:B].transpose(1, 2) + out[B:].flip(1).transpose(1, 2)
    p2y = _p2_eff(ay, p2, alpha, beta)
    out = _scan_passes(torch.cat([cost, cost.flip(1)]), torch.cat([p2y, p2y.flip(1)]),
                       p1, 0, False)
    total = total + out[:B]
    total = total + out[B:].flip(1)
    if diagonals:
        p2d = _p2_eff(0.5 * (ax + ay), p2, alpha, beta)
        cf, pf = cost.flip(2), p2d.flip(2)
        out = _scan_passes(torch.cat([cost, cost.flip(1), cf, cf.flip(1)]),
                           torch.cat([p2d, p2d.flip(1), pf, pf.flip(1)]), p1, 1, True)
        total = total + out[:B]
        total = total + out[B:2 * B].flip(1)
        total = total + out[2 * B:3 * B].flip(2)
        total = total + out[3 * B:].flip(1).flip(2)
    return total


def aggregate(cost: torch.Tensor, image: torch.Tensor, p1: float = 1.0,
              p2: float = 8.0, alpha: float = 2.0, num_dirs: int = 4) -> torch.Tensor:
    """Sum of the 4 axis-aligned DP passes (beta 0.1) over an (H, W, D)
    float volume; ``num_dirs`` is accepted and ignored, as in the JAX
    package."""
    return _aggregate(cost[None], image[None], p1, p2, alpha, 0.1, False)[0]


def aggregate8(cost_u8: torch.Tensor, image: torch.Tensor, p1: float = 3.0,
               p2: float = 4.0, alpha: float = 14.0, num_dirs: int = 8,
               beta: float = 38.0 / 255.0) -> torch.Tensor:
    """Sum of the directional passes over a uint8 volume: 4 axis-aligned
    and, with ``num_dirs >= 8``, 4 diagonal (the reference's numDirs=4
    runs its 4 directions forward and backward, SemiGlobalMatcher.cpp:
    1203-1265). ``cost_u8`` may be (H, W, D) with an (H, W) image, or a
    batch (B, H, W, D) with (B, H, W) images, aggregated in one set of
    scans."""
    single = cost_u8.dim() == 3
    cost = cost_u8.to(torch.float32)
    if single:
        cost, image = cost[None], image[None]
    total = _aggregate(cost, image, p1, p2, alpha, beta, num_dirs >= 8)
    return total[0] if single else total


# --------------------------------------------------------------- extraction
def _argmin_first(agg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index of the first minimum along the last axis, the minimum):
    ``jnp.argmin``'s tie rule written out, so no device's argmin decides
    the many exact ties of integer costs."""
    mn = agg.amin(-1, keepdim=True)
    D = agg.shape[-1]
    ar = torch.arange(D, device=agg.device,
                      dtype=torch.int16 if D < 32767 else torch.int32)
    idx = torch.where(agg == mn, ar, D).amin(-1)
    return idx.to(torch.int64), mn[..., 0]


def extract_disparity(agg: torch.Tensor, d_min: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner-take-all + parabola sub-pixel (SemiGlobalMatcher.h:111-119):
    (disparity, margin confidence)."""
    D = agg.shape[-1]
    idx, c0 = _argmin_first(agg)
    cm = torch.gather(agg, -1, torch.clamp(idx - 1, 0, D - 1)[..., None])[..., 0]
    cp = torch.gather(agg, -1, torch.clamp(idx + 1, 0, D - 1)[..., None])[..., 0]
    denom = cm + cp - 2 * c0
    frac = torch.where(denom > 1e-6,
                       0.5 * (cm - cp) / torch.clamp(denom, min=1e-6), 0.0)
    frac = torch.clamp(frac, -0.5, 0.5)
    disp = idx.to(torch.float32) + frac + d_min
    conf = torch.clamp(torch.minimum(cm, cp) - c0, min=0.0)
    return disp, conf


def lr_consistency(disp_l: torch.Tensor, disp_r: torch.Tensor, max_diff: float = 1.0):
    """Cross-check |dL(x) + dR(x - dL(x))| <= max_diff
    (SemiGlobalMatcher.h:175); NaN where it fails."""
    H, W = disp_l.shape
    xs = torch.arange(W, device=disp_l.device, dtype=torch.float32)[None, :] - disp_l
    xr = torch.round(xs)
    xi = torch.clamp(torch.where(torch.isfinite(xr), xr, 0.0), 0, W - 1).to(torch.int64)
    dr = torch.gather(disp_r, 1, xi)
    ok = (torch.abs(disp_l + dr) <= max_diff) & (xs >= 0) & (xs <= W - 1)
    return torch.where(ok, disp_l, float("nan"))


def match_rectified(left, right, d_min: int, num_d: int,
                    p1: float = 0.1, p2: float = 0.8, alpha: float = 2.0,
                    cost: str = "zncc", cross_check: bool = True,
                    device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Full SGM on a rectified pair on ``device``: (disparity with NaN
    invalid, confidence) as numpy."""
    dev = devmod.resolve(device)
    L = torch.as_tensor(np.asarray(left, np.float32), device=dev)
    R = torch.as_tensor(np.asarray(right, np.float32), device=dev)
    volume = zncc_cost_volume if cost == "zncc" else census_cost_volume
    agg = aggregate(volume(L, R, d_min, num_d), L, p1=p1, p2=p2, alpha=alpha)
    disp_l, conf = extract_disparity(agg, d_min)
    if cross_check:
        r_min = -(d_min + num_d - 1)
        agg_r = aggregate(volume(R, L, r_min, num_d), R, p1=p1, p2=p2, alpha=alpha)
        disp_r, _ = extract_disparity(agg_r, r_min)
        disp_l = lr_consistency(disp_l, disp_r)
    return disp_l.cpu().numpy(), conf.cpu().numpy()


# ----------------------------------------------------- rectification helpers
def rectify_pair(camA, camB, grayA: np.ndarray, grayB: np.ndarray):
    """Fusiello-style rectification of an arbitrary calibrated pair
    (Image::StereoRectify role, libs/MVS/Image.h:94-101).

    Returns (rectA, rectB, info) where correspondence is a pure horizontal
    shift: the new camera shares a rotation whose x-axis is the baseline.
    """
    C1, C2 = camA.C, camB.C
    baseline = C2 - C1
    b = np.linalg.norm(baseline)
    if b < 1e-12:
        raise ValueError("degenerate baseline")
    vx = baseline / b
    oz = camA.R[2]
    vy = np.cross(oz, vx)
    vy /= np.linalg.norm(vy)
    vz = np.cross(vx, vy)
    Rn = np.stack([vx, vy, vz])          # new rotation (both cameras)
    Kn = (camA.K + camB.K) / 2
    Kn[0, 1] = 0
    H, W = grayA.shape
    TA = Kn @ Rn @ camA.R.T @ np.linalg.inv(camA.K)
    TB = Kn @ Rn @ camB.R.T @ np.linalg.inv(camB.K)
    rectA = imio.warp_perspective(grayA, TA.astype(np.float64), W, H)
    rectB = imio.warp_perspective(grayB, TB.astype(np.float64), W, H)
    info = {"Rn": Rn, "Kn": Kn, "baseline": b, "TA": TA, "TB": TB,
            "C1": camA.C}
    return rectA, rectB, info


def disparity_to_depth(disp: np.ndarray, info: dict) -> np.ndarray:
    """depth (in the rectified frame) = f * b / disparity."""
    f = info["Kn"][0, 0]
    b = info["baseline"]
    with np.errstate(divide="ignore", invalid="ignore"):
        z = f * b / disp
    z[~np.isfinite(z)] = 0
    z[z < 0] = 0
    return z


# ----------------------------------------------------------- tSGM (WZNCC)
def _texel_offsets(half_x: int, half_y: int) -> List[Tuple[int, int]]:
    return [(dy, dx) for dy in range(-half_y, half_y + 1)
            for dx in range(-half_x, half_x + 1)]


class _XlaSum:
    """A sum of n float32 terms, arriving in order, rounded as XLA's CPU
    backend reduces a stacked leading axis: for n > 32 the axis is
    zero-padded to a multiple of 32 (half the padding, rounded down, in
    front), each window of 32 is added in order and the window sums are
    reduced the same way; up to 32 terms are added in order."""

    def __init__(self, n: int):
        self.low = (-(-n // 32) * 32 - n) // 2 if n > 32 else 0
        self.partial = {}

    def add(self, k: int, term: torch.Tensor):
        j = (self.low + k) // 32
        self.partial[j] = term if j not in self.partial else self.partial[j] + term

    def total(self) -> torch.Tensor:
        return _xla_sum([self.partial[j] for j in sorted(self.partial)])


def _xla_sum(terms: list) -> torch.Tensor:
    if len(terms) <= 32:
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        return acc
    acc = _XlaSum(len(terms))
    for k, t in enumerate(terms):
        acc.add(k, t)
    return acc.total()


def wzncc_weights(gray: torch.Tensor, half_x: int = 3, half_y: int = 3):
    """Per-pixel bilateral patch weights for WZNCC (7x7 window), the
    reference's WeightedPatch precompute (SemiGlobalMatcher.cpp:900-947):
    weight = exp(colorDelta^2 sigmaColor + spatialDist^2 sigmaSpatial) with
    sigmaColor = -1/(2 0.3^2) on [0, 1] intensities and sigmaSpatial =
    -1/(2 (0.4 * 7)^2).

    ``gray`` is (..., H, W); returns (w, tw, sum_w, norm_sq0) with w and tw
    stacked (T, ..., H, W)."""
    offs = _texel_offsets(half_x, half_y)
    sigma_color = _f32(-1.0 / (2.0 * 0.3 ** 2))
    wsz = 2 * max(half_x, half_y) + 1
    sigma_spatial = _f32(-1.0 / (2.0 * (0.4 * wsz) ** 2))
    H, W = gray.shape[-2:]
    pad = max(half_x, half_y)
    gp = _pad_edge(gray, pad)
    texels = [gp[..., dy + pad:dy + pad + H, dx + pad:dx + pad + W] for dy, dx in offs]
    w = []
    for (dy, dx), tex in zip(offs, texels):
        dcol = tex - gray
        spatial = _f32(np.float32(dy * dy + dx * dx) * np.float32(sigma_spatial))
        w.append(exp_xla(fma(dcol * dcol, sigma_color, spatial)))
    sum_w = _xla_sum(w)
    tm = _xla_sum([wk * t for wk, t in zip(w, texels)]) / sum_w
    tc = [tex - tm for tex in texels]
    tw = [wk * t for wk, t in zip(w, tc)]
    norm_sq0 = _xla_sum([a * b for a, b in zip(tw, tc)])
    return torch.stack(w), torch.stack(tw), sum_w, norm_sq0


def _wzncc_volumes(lefts: torch.Tensor, rights_shifted: torch.Tensor,
                   d_mins: Sequence[int], num_d: int, half_x: int = 3,
                   half_y: int = 3) -> torch.Tensor:
    """(B, H, W, D) uint8 WZNCC volumes of B (left, right) pairs of one
    shape, each right image already shifted by its d_min columns (the JAX
    package's ``_wzncc_volume0`` layout). Per chunk of disparities the
    49-texel sums accumulate texel by texel in XLA's order (``_XlaSum``)."""
    w, tw, sum_w, norm_sq0 = wzncc_weights(lefts, half_x, half_y)
    return _wzncc_volumes_weighted(w, tw, sum_w, norm_sq0, rights_shifted, d_mins,
                                   num_d, half_x, half_y)


def _wzncc_volumes_weighted(w, tw, sum_w, norm_sq0, rights_shifted: torch.Tensor,
                            d_mins: Sequence[int], num_d: int, half_x: int,
                            half_y: int) -> torch.Tensor:
    """``_wzncc_volumes`` from the left images' ``wzncc_weights``."""
    B, H, W = rights_shifted.shape
    dev = rights_shifted.device
    eps = _f32(1e-3)
    offs = _texel_offsets(half_x, half_y)
    pad = max(half_x, half_y)
    lo_pad = num_d - 1 + half_x + pad
    hi_pad = half_x + pad
    rp = F.pad(rights_shifted, (hi_pad, lo_pad, pad, pad)).contiguous()
    sb, sr = rp.stride(0), rp.stride(1)
    vol = torch.empty((B, H, W, num_d), dtype=torch.uint8, device=dev)
    chunk = max(1, min(num_d, _CHUNK_ELEMS // max(B * H * W, 1)))
    cols = torch.arange(W, device=dev)
    dm = torch.as_tensor(list(d_mins), device=dev)[:, None, None]
    for i0 in range(0, num_d, chunk):
        n = min(chunk, num_d - i0)
        sums = [_XlaSum(len(offs)) for _ in range(3)]
        for k, (dy, dx) in enumerate(offs):
            tex = rp.as_strided((B, n, H, W), (sb, 1, sr, 1),
                                rp.storage_offset() + (dy + pad) * sr + dx + i0 + hi_pad)
            wt = w[k][:, None] * tex
            sums[0].add(k, wt)
            sums[1].add(k, wt * tex)
            sums[2].add(k, tw[k][:, None] * tex)
        s, sq, nom = (acc.total() for acc in sums)
        norm_sq1 = sq - s * s / sum_w[:, None]
        v = torch.clamp(fma(norm_sq0[:, None], norm_sq1, eps), min=1e-12)
        ncc = nom * rsqrt(v)
        c = torch.where(ncc <= 0, 255.0,
                        torch.round((1.0 - torch.clamp(ncc, max=1.0)) * 255.0))
        # out-of-image columns invalid (original right-image coordinates)
        xs = cols[None, None, :] + (torch.arange(i0, i0 + n, device=dev)[None, :, None] + dm)
        bad = (xs < 0) | (xs >= W)                           # (B, n, W)
        c = torch.where(bad[:, :, None, :], 255.0, c)
        vol[..., i0:i0 + n] = c.to(torch.uint8).permute(0, 2, 3, 1)
    return vol


def wzncc_volume_masked(w: torch.Tensor, tw: torch.Tensor, sum_w: torch.Tensor,
                        norm_sq0: torch.Tensor, rights: torch.Tensor,
                        d_mins: torch.Tensor, num_d: int,
                        lo: Optional[torch.Tensor] = None,
                        hi: Optional[torch.Tensor] = None, half_x: int = 3,
                        half_y: int = 3) -> torch.Tensor:
    """The kernel's wrapper: (B, H, W, num_d) uint8 masked WZNCC volumes of
    B pairs, ``mask_volume(_wzncc_volumes(...))`` per pair, from the left
    images' ``wzncc_weights`` (w and tw (T, B, H, W), sum_w and norm_sq0
    (B, H, W)), the UNSHIFTED right images (B, H, W) float32, their d_min
    as a (B,) int32 tensor and, optionally, the per-pixel windows lo and
    hi (B, H, W) int16 (None: no window). All contiguous on one device.
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/wzncc_volume.cu`` or raise. d_mins on the device lets one CUDA
    graph serve any pair of a shape class."""
    if rights.dim() != 3:
        raise ValueError(f"rights: {rights.dim()}-D, expected (B, H, W)")
    B, H, W = rights.shape
    T = (2 * half_x + 1) * (2 * half_y + 1)
    if (lo is None) != (hi is None):
        raise ValueError("lo and hi: give both or neither")
    checks = [("w", w, (T, B, H, W), torch.float32), ("tw", tw, (T, B, H, W), torch.float32),
              ("sum_w", sum_w, (B, H, W), torch.float32),
              ("norm_sq0", norm_sq0, (B, H, W), torch.float32),
              ("rights", rights, (B, H, W), torch.float32),
              ("d_mins", d_mins, (B,), torch.int32)]
    if lo is not None:
        checks += [("lo", lo, (B, H, W), torch.int16), ("hi", hi, (B, H, W), torch.int16)]
    for name, t, shape, dtype in checks:
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != rights.device:
            raise ValueError(f"{name}: on {t.device}, expected {rights.device}")
    if num_d < 1:
        raise ValueError(f"num_d {num_d}: expected at least 1")
    if rights.device.type == "cpu":
        return _wzncc_volume_plain(w, tw, sum_w, norm_sq0, rights, d_mins, num_d, lo, hi,
                                   half_x, half_y)
    return _wzncc_volume_launch(w, tw, sum_w, norm_sq0, rights, d_mins, num_d, lo, hi,
                                half_x, half_y)


def _wzncc_volume_plain(w, tw, sum_w, norm_sq0, rights, d_mins, num_d, lo, hi,
                        half_x, half_y) -> torch.Tensor:
    """``wzncc_volume_masked``'s plain version: each right image shifted
    by its d_min, ``_wzncc_volumes``' loop, then ``mask_volume``."""
    dm = [int(d) for d in d_mins.tolist()]
    shifted = torch.stack([_shift_right(r, d) for r, d in zip(rights, dm)])
    vol = _wzncc_volumes_weighted(w, tw, sum_w, norm_sq0, shifted, dm, num_d,
                                  half_x, half_y)
    if lo is None:
        return vol
    return torch.stack([mask_volume(v, lo_b, hi_b, d)
                        for v, lo_b, hi_b, d in zip(vol, lo, hi, dm)])


def _xla_split(n: int) -> int:
    """The terms of an n-term ``_XlaSum`` (n <= 64) that its first partial
    sum takes: all of them up to 32."""
    return n if n <= 32 else 32 - _XlaSum(n).low


def _wzncc_volume_launch(w, tw, sum_w, norm_sq0, rights, d_mins, num_d, lo, hi,
                         half_x, half_y) -> torch.Tensor:
    """The card route of ``wzncc_volume_masked`` (operands already
    checked)."""
    if rights.device.type != "cuda":
        raise ValueError(f"wzncc_volume kernel: tensors on {rights.device}, expected cuda")
    T = (2 * half_x + 1) * (2 * half_y + 1)
    if T > _build.WZNCC_MAX_TEXELS:
        raise ValueError(f"wzncc_volume kernel: {T} texels, expected at most "
                         f"{_build.WZNCC_MAX_TEXELS}")
    B, H, W = rights.shape
    out = torch.empty((B, H, W, num_d), dtype=torch.uint8, device=rights.device)
    lib = _build.library("wzncc_volume")
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    with torch.cuda.device(rights.device):
        rc = lib.wzncc_volume_launch(
            ptr(w), ptr(tw), ptr(sum_w), ptr(norm_sq0), ptr(rights), ptr(d_mins),
            ptr(lo), ptr(hi), ptr(out), B, H, W, num_d, half_x, half_y, _xla_split(T),
            ctypes.c_void_p(torch.cuda.current_stream(rights.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"wzncc_volume_launch failed: {_build.error_string(rc)}")
    count_launch("wzncc_volume")
    return out


def _shift_right(right: torch.Tensor, d_min: int) -> torch.Tensor:
    """``right`` moved left by ``d_min`` columns, zero filled."""
    W = right.shape[-1]
    shifted = torch.zeros_like(right)
    if d_min >= 0:
        if d_min < W:
            shifted[..., :W - d_min] = right[..., d_min:]
    elif -d_min < W:
        shifted[..., -d_min:] = right[..., :W + d_min]
    return shifted


def wzncc_cost_volume(left: torch.Tensor, right: torch.Tensor, d_min: int,
                      num_d: int, half_x: int = 3, half_y: int = 3) -> torch.Tensor:
    """(H, W, D) uint8 bilateral-weighted ZNCC costs
    (SemiGlobalMatcher.cpp:948-975): 255 for ncc <= 0 or out of the image,
    else round((1 - min(ncc, 1)) 255); disparity d maps L(x) -> R(x + d)."""
    r = _shift_right(right.to(torch.float32), d_min)
    return _wzncc_volumes(left.to(torch.float32)[None], r[None], [d_min], num_d,
                          half_x, half_y)[0]


def disparity_range_map(prior_disp: np.ndarray, out_shape,
                        min_num_disp: int = 3, min_num_disp_invalid: int = 16,
                        max_valid: int = 32, max_invalid: int = 64,
                        global_range=None):
    """Per-pixel disparity search windows from the previous (half-res)
    level's disparity (Disparity2RangeMap, SemiGlobalMatcher.cpp:1350-1445).

    prior_disp: (h, w) float with NaN invalid, at HALF the target
    resolution; returns (lo, hi) int16 maps at out_shape with disparities
    DOUBLED.  Valid pixels search min/max of a 7x7 window (span capped at
    max_valid); invalid pixels a 41x41 window (capped at max_invalid);
    windows with <3 samples fall back to +-min_num_disp_invalid (or the
    provided global_range)."""
    from scipy import ndimage

    d = np.asarray(prior_disp, np.float32)
    valid = np.isfinite(d)
    dfill_min = np.where(valid, d, np.inf)
    dfill_max = np.where(valid, d, -np.inf)

    def window_stats(size):
        mn = ndimage.minimum_filter(dfill_min, size=size, mode="nearest")
        mx = ndimage.maximum_filter(dfill_max, size=size, mode="nearest")
        cnt = ndimage.uniform_filter(valid.astype(np.float32), size=size,
                                     mode="nearest") * size * size
        return mn, mx, cnt

    mn7, mx7, c7 = window_stats(7)
    mn41, mx41, c41 = window_stats(41)
    # median approximated by the window midpoint (the reference takes the
    # exact median of the collected samples; the midpoint keeps the same
    # center-of-window semantics with separable filters)
    mn = np.where(valid, mn7, mn41)
    mx = np.where(valid, mx7, mx41)
    cnt = np.where(valid, c7, c41)
    cap = np.where(valid, max_valid, max_invalid).astype(np.int32)

    with np.errstate(invalid="ignore"):
        # empty windows are (+inf, -inf): their NaN center/span are masked
        # by `ok` below — silence the expected invalid-add warning
        center = (mn + mx)  # = median*2 in doubled units
        span = (mx - mn) * 2.0
    ok = np.isfinite(mn) & np.isfinite(mx) & (cnt >= 3)
    num = np.clip(span, min_num_disp, cap)
    lo = np.where(ok, center - num / 2, 0).astype(np.float32)
    hi = np.where(ok, center + (num + 1) / 2, 0).astype(np.float32)
    if global_range is None:
        g_lo, g_hi = -min_num_disp_invalid, min_num_disp_invalid
    else:
        g_lo, g_hi = global_range
    lo = np.where(ok, lo, g_lo)
    hi = np.where(ok, hi, g_hi)

    # upscale 2x to the target level
    H, W = out_shape
    lo2 = np.repeat(np.repeat(lo, 2, 0), 2, 1)[:H, :W]
    hi2 = np.repeat(np.repeat(hi, 2, 0), 2, 1)[:H, :W]
    if lo2.shape != (H, W):
        lo2 = np.pad(lo2, ((0, H - lo2.shape[0]), (0, W - lo2.shape[1])),
                     mode="edge")
        hi2 = np.pad(hi2, ((0, H - hi2.shape[0]), (0, W - hi2.shape[1])),
                     mode="edge")
    return lo2.astype(np.int16), hi2.astype(np.int16)


def mask_volume(vol: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                d_min: int) -> torch.Tensor:
    """Set costs outside each pixel's [lo, hi) window to CMAX, the dense
    form of the reference's compressed per-pixel ranges."""
    D = vol.shape[-1]
    ds = torch.arange(D, dtype=torch.int32, device=vol.device) + int(d_min)
    inwin = ((ds >= lo[..., None].to(torch.int32))
             & (ds < hi[..., None].to(torch.int32)))
    return torch.where(inwin, vol, torch.tensor(int(CMAX), dtype=torch.uint8, device=vol.device))


# ------------------------------------------------------------- sub-pixel
def _fit_linear(x):
    return x / 2.0


def _fit_poly4(x):
    return (x ** 4 + x) / 4.0


def _fit_parabola(x):
    return x / (x + 1.0)


def _fit_sine(x):
    return 0.5 * (np.sin((x - 1.0) * (np.pi / 2)) + 1.0)


def _fit_cosine(x):
    return 1.0 - np.cos(x * (np.pi / 3.0))


def _fit_lc_blend(x):
    factor = 1.195 - np.cos(x * (np.pi / 2.3))
    return _fit_cosine(x) * factor + _fit_linear(x) * (1.0 - factor)


_SUBPIXEL_FITS = {
    "linear": _fit_linear,
    "poly4": _fit_poly4,
    "parabola": _fit_parabola,
    "sine": _fit_sine,
    "cosine": _fit_cosine,
    "lc_blend": _fit_lc_blend,
}


def refine_subpixel(agg: np.ndarray, disp_int: np.ndarray, d_min: int,
                    mode: str = "lc_blend") -> np.ndarray:
    """Sub-pixel offset from the three accumulated costs around the winner
    (RefineDisparityMap, SemiGlobalMatcher.cpp:1693-1800): pick the
    interpolation direction from the smaller neighbor delta, map the delta
    ratio x through the chosen fit, offset = (fit(x) - 0.5) * sign."""
    if mode in ("na", None):
        return disp_int.astype(np.float32)
    D = agg.shape[-1]
    idx = np.clip((disp_int - d_min).astype(np.int64), 0, D - 1)
    take = lambda i: np.take_along_axis(agg, i[..., None], axis=-1)[..., 0]
    return _subpixel(take(idx), take(np.clip(idx - 1, 0, D - 1)),
                     take(np.clip(idx + 1, 0, D - 1)), disp_int, mode)


def _subpixel(c0: np.ndarray, cm: np.ndarray, cp: np.ndarray,
              disp_int: np.ndarray, mode: str) -> np.ndarray:
    """``refine_subpixel`` from the winner's cost and its two neighbours'
    (clamped to the volume), which ``match_pair_tsgm`` gathers on the
    device instead of downloading the volume."""
    fit = _SUBPIXEL_FITS[mode]
    ld = cm - c0
    rd = cp - c0
    with np.errstate(divide="ignore", invalid="ignore"):
        x_r = np.where(rd > 0, ld / np.maximum(rd, 1e-12), 0.0)
        x_l = np.where(ld > 0, rd / np.maximum(ld, 1e-12), 0.0)
    use_r = ld < rd
    x = np.clip(np.where(use_r, x_r, x_l), 0.0, 1.0)
    val = fit(x)
    off = (val - 0.5) * np.where(use_r, 1.0, -1.0)
    # two-value edge cases (semisubpixel): prev==center or center==next
    off = np.where((cm == c0) & (cp != c0), 0.5 * (c0 / np.maximum(cp, 1e-12)), off)
    off = np.where((cp == c0) & (cm != c0), -0.5 * (c0 / np.maximum(cm, 1e-12)), off)
    off = np.where((cm == c0) & (cp == c0), 0.0, off)
    return disp_int.astype(np.float32) + np.clip(off, -0.5, 0.5)


# ------------------------------------------------------- tSGM pair pipeline
def _flip_disparity(disp: np.ndarray) -> np.ndarray:
    """Left-reference disparity -> right-reference prior (FlipDirection,
    SemiGlobalMatcher.cpp: dR(x + dL) = -dL), NaN where nothing lands."""
    H, W = disp.shape
    out = np.full((H, W), np.nan, np.float32)
    ys, xs = np.nonzero(np.isfinite(disp))
    d = disp[ys, xs]
    xr = np.round(xs + d).astype(np.int64)
    ok = (xr >= 0) & (xr < W)
    out[ys[ok], xr[ok]] = -d[ok]
    return out


def filter_speckles(img: np.ndarray, new_val: int, max_speckle_size: int,
                    max_diff: int) -> np.ndarray:
    """``cv2.filterSpeckles(img, new_val, max_speckle_size, max_diff)`` on
    an (H, W) int16 map, in place: pixels other than ``new_val`` join
    4-connected regions through neighbours that differ by at most
    ``max_diff``, and every region of at most ``max_speckle_size`` pixels
    becomes ``new_val``. OpenCV grows each region by a flood fill; the
    regions are the connected components of the same neighbour graph, which
    scipy finds without a Python loop."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    H, W = img.shape
    if H == 0 or W == 0:
        return img
    v = img.astype(np.int32)
    good = v != new_val
    ids = np.arange(H * W).reshape(H, W)
    across = good[:, :-1] & good[:, 1:] & (np.abs(v[:, :-1] - v[:, 1:]) <= max_diff)
    down = good[:-1] & good[1:] & (np.abs(v[:-1] - v[1:]) <= max_diff)
    a = np.concatenate([ids[:, :-1][across], ids[:-1][down]])
    b = np.concatenate([ids[:, 1:][across], ids[1:][down]])
    graph = coo_matrix((np.ones(len(a), np.int8), (a, b)), shape=(H * W, H * W))
    _, labels = connected_components(graph, directed=False)
    size = np.bincount(labels)
    img[good & (size[labels].reshape(H, W) <= max_speckle_size)] = new_val
    return img


def _speckle_filter(disp: np.ndarray, max_size: int = 100,
                    max_diff: float = 5.0) -> np.ndarray:
    """cv2.filterSpeckles on a float disparity with NaN invalid, through
    the same 1/16-pixel int16 map (``filter_speckles``); degenerate 0-row or
    0-column levels pass through."""
    if disp.shape[0] == 0 or disp.shape[1] == 0:
        return disp.astype(np.float32)
    d16 = np.ascontiguousarray(
        np.where(np.isfinite(disp), disp * 16.0, -32768).astype(np.int16))
    filter_speckles(d16, -32768, max_size, int(max_diff * 16))
    out = d16.astype(np.float32) / 16.0
    out[d16 == -32768] = np.nan
    return out


def _level_body(imgs: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                dmins: torch.Tensor, num_d: int, p1, p2, alpha, beta, num_dirs,
                subpixel: bool) -> List[torch.Tensor]:
    """One tSGM level's device work on (2, hs, ws) images (left, right),
    the (2, hs, ws) windows of the left and right matches and their
    d_mins (2,) int32: the masked WZNCC volumes of both directions (right
    image of one = left image of the other), their DP in one batch and
    the winners. Returns (left winner indices, left winner costs, right
    winner indices, and with ``subpixel`` the left winner's two
    neighbouring costs). No host read, so it can be captured."""
    w, tw, sum_w, norm_sq0 = wzncc_weights(imgs)
    vols = wzncc_volume_masked(w, tw, sum_w, norm_sq0, imgs.flip(0), dmins, num_d, lo, hi)
    agg = aggregate8(vols, imgs, p1, p2, alpha, num_dirs, beta)
    idx, cost = _argmin_first(agg)
    out = [idx[0], cost[0], idx[1]]
    if subpixel:
        D = agg.shape[-1]
        for step in (-1, 1):
            j = torch.clamp(idx[0] + step, 0, D - 1)
            out.append(torch.gather(agg[0], -1, j[..., None])[..., 0])
    return out


def _level_inputs(A, B, lo, hi, loR, hiR, l_min: int, num_d: int):
    """The host arrays of ``_level_body``'s inputs: images, lo, hi,
    d_mins (the right match's d_min is -(l_min + num_d - 1))."""
    return (np.stack([A, B]).astype(np.float32), np.stack([lo, loR]).astype(np.int16),
            np.stack([hi, hiR]).astype(np.int16),
            np.array([l_min, -(l_min + num_d - 1)], np.int32))


def _level_result(out: Sequence[torch.Tensor], l_min: int, num_d: int) -> List[np.ndarray]:
    """``_level_body``'s outputs as numpy with the winner indices made
    disparities: (left disparities, left winner costs, right disparities,
    the neighbouring costs)."""
    res = [t.cpu().numpy() for t in out]
    res[0] = res[0] + l_min
    res[2] = res[2] + -(l_min + num_d - 1)
    return res


def _match_level(A: np.ndarray, B: np.ndarray, lo, hi, loR, hiR, l_min: int,
                 num_d: int, p1, p2, alpha, beta, num_dirs, subpixel: bool,
                 dev):
    """One tSGM level on ``dev``, launched op by op (``_level_body``).
    Returns (left disparities, left winner costs, right disparities, and
    with ``subpixel`` the left winner's two neighbouring costs) as numpy,
    the only data the host steps read."""
    ins = [torch.as_tensor(a, device=dev)
           for a in _level_inputs(A, B, lo, hi, loR, hiR, l_min, num_d)]
    out = _level_body(*ins, num_d, p1, p2, alpha, beta, num_dirs, subpixel)
    return _level_result(out, l_min, num_d)


class LevelProgram:
    """One tSGM level of a shape class (hs, ws, num_d, num_dirs,
    subpixel, p1, p2, alpha, beta) as a device program over static
    buffers: the counterpart of the JAX package's jitted ``_wzncc_volume0``,
    ``mask_volume`` and ``aggregate8`` for one level. Eagerly a level is
    some 4,000 launches from Python; on a card the program captures
    ``_level_body`` once as a CUDA graph (``graphs.Runner``: its lock, pool
    and stream) and each later ``run`` is one replay.

    Buffers: the two images, lo and hi of both matches and their d_mins,
    filled with ``copy_`` before each run, so one graph serves every pair
    of the class; the outputs, copied into static buffers by the body. The
    first run of a program runs its body eagerly (libraries initialise
    lazily on a first call, which a capture does not permit); on a card the
    second captures it and every later run replays it. On the CPU every run
    runs the body on the same buffers (the program's CPU form). A capture
    or replay that fails raises."""

    def __init__(self, runner, hs: int, ws: int, num_d: int, p1, p2, alpha, beta,
                 num_dirs: int, subpixel: bool):
        dev = runner.device
        self.runner = runner
        self.args = (num_d, p1, p2, alpha, beta, num_dirs, subpixel)
        self.ins = (torch.zeros((2, hs, ws), dtype=torch.float32, device=dev),
                    torch.zeros((2, hs, ws), dtype=torch.int16, device=dev),
                    torch.zeros((2, hs, ws), dtype=torch.int16, device=dev),
                    torch.zeros(2, dtype=torch.int32, device=dev))
        self.outs: Optional[List[torch.Tensor]] = None
        self.graph = None
        self.effects: list = []
        self.runs = 0

    def _body(self) -> None:
        out = _level_body(*self.ins, *self.args)
        if self.outs is None:
            self.outs = [t.clone() for t in out]
        else:
            for dst, src in zip(self.outs, out):
                dst.copy_(src)

    def run(self, A, B, lo, hi, loR, hiR, l_min: int) -> List[np.ndarray]:
        """``_match_level``'s result for one pair of the class."""
        num_d = self.args[0]
        for dst, src in zip(self.ins, _level_inputs(A, B, lo, hi, loR, hiR, l_min, num_d)):
            dst.copy_(torch.from_numpy(src))
        if self.graph is None and self.runs > 0 and self.ins[0].is_cuda:
            self.graph = self.runner.capture(self._body, self.effects)
        if self.graph is None:
            self._body()
        else:
            self.runner.replay(self.graph, self.effects)
        self.runs += 1
        return _level_result(self.outs, l_min, num_d)


def match_pair_tsgm(
    rectA: np.ndarray, rectB: np.ndarray,
    d_lo: int, d_hi: int,
    p1: float = 3.0, p2: float = 4.0, alpha: float = 14.0,
    beta: float = 38.0 / 255.0,
    min_resolution: int = 320,
    subpixel_mode: str = "lc_blend",
    num_dirs: int = 8,
    max_num_d: int = 256,
    device="cuda",
    stats: Optional[list] = None,
    runners=None,
):
    """Coarse-to-fine tSGM on a rectified pair (SemiGlobalMatcher::Match,
    SemiGlobalMatcher.cpp:530-737): per-pixel disparity windows from the
    previous level restrict the search (range masking == the reference's
    range compression), both directions matched, cross-checked each level,
    speckle-filtered at the coarsest, sub-pixel refined at the finest.

    d_lo/d_hi: full-resolution global disparity bounds (e.g. from sparse
    matches). The volumes and scans run on ``device``; ``stats``, a list,
    gets one record per level (shape, num_d, seconds). With ``runners``
    (a ``graphs.Runners``) each level runs as its shape class's
    ``LevelProgram`` (on a card a CUDA graph, kept by the runner for later
    pairs), else op by op (``_match_level``).
    Returns (disparity float32 with NaN invalid, accumulated winner cost
    float32)."""
    dev = devmod.resolve(device)
    runner = None if runners is None else runners.get(dev)
    H, W = rectA.shape
    if H == 0 or W == 0:
        # degenerate rectified pair (extreme geometry can collapse a level):
        # nothing to match — the caller's cluster fusion drops empty maps
        return (np.full((H, W), np.nan, np.float32),
                np.zeros((H, W), np.float32))
    # pyramid scales: the coarsest level sits at 1/max(2, 2^l) with l from
    # computeMaxResolution(max_dim, 8, min_resolution) — tSGM always runs
    # at least one half-resolution level (SemiGlobalMatcher.cpp:585-591),
    # which is what activates the per-pixel range maps
    lvl = 0
    while (max(H, W) >> (lvl + 1)) >= min_resolution and lvl < 8:
        lvl += 1
    lvl = max(lvl, 1 if min(H, W) >= 32 else 0)
    scales = [1.0 / (1 << (lvl - i)) for i in range(lvl)] + [1.0]
    tsgm = len(scales) > 1
    debug = os.environ.get("OMVS_SGM_DEBUG") == "1"
    ladder = [int(x) for x in os.environ.get(
        "OMVS_SGM_ND_LADDER", "16,32,64,128,192,256").split(",")]

    disp = None
    cost_map = None
    first_up = True
    for li, s in enumerate(scales):
        t_lv = time.perf_counter()
        hs, ws = max(1, round(H * s)), max(1, round(W * s))
        A = imio.resize_area(rectA, ws, hs) if s != 1 else rectA
        B = imio.resize_area(rectB, ws, hs) if s != 1 else rectB
        glo, ghi = int(np.floor(d_lo * s)) - 8, int(np.ceil(d_hi * s)) + 8
        if disp is None:
            lo = np.full((hs, ws), glo, np.int16)
            hi = np.full((hs, ws), ghi, np.int16)
            loR = np.full((hs, ws), -ghi, np.int16)
            hiR = np.full((hs, ws), -glo, np.int16)
        else:
            mnd, mnd_i = (11, 33) if first_up else (5, 7)
            was_first_up = first_up
            first_up = False
            # fallback window for pixels with <3 neighborhood samples: a
            # min_num_disp_invalid-wide band at the global midpoint, the
            # role of the reference's +-minNumDispInvalid around 0
            # (SemiGlobalMatcher.cpp:1387-1390), not the whole global range
            mid = (glo + ghi) // 2
            fb = (max(glo, mid - mnd_i), min(ghi, mid + mnd_i))
            if was_first_up and os.environ.get("OMVS_SGM_FB") == "full":
                # pixels invalidated at the coarsest level get one
                # full-range chance at the first upsample
                fb = (glo, ghi)
            lo, hi = disparity_range_map(disp, (hs, ws), mnd, mnd_i,
                                         global_range=fb)
            dR = _flip_disparity(disp)
            loR, hiR = disparity_range_map(dR, (hs, ws), mnd, mnd_i,
                                           global_range=(-fb[1], -fb[0]))
        # level-global bounds hug the per-pixel windows
        l_min = int(lo.min())
        l_max = int(hi.max())
        span = l_max - l_min
        if span > max_num_d:
            # the volume cannot cover the whole span: place the coverage
            # window where it keeps the most per-pixel ranges alive
            cand = np.unique(np.linspace(
                l_min, l_max - max_num_d, 17).astype(int))
            covered = [int(((lo >= c) & (hi <= c + max_num_d)).sum())
                       for c in cand]
            l_min = int(cand[int(np.argmax(covered))])
            n_lost = lo.size - max(covered)
            if n_lost:
                from openmvs_tpu_torch.utils.log import get_logger
                get_logger("sgm").warning(
                    "disparity span %d > max_num_d %d at level %d: "
                    "%d/%d pixels' ranges fall outside the coverage window",
                    span, max_num_d, li, n_lost, lo.size)
        num_d = min(l_max - l_min, max_num_d)
        if num_d <= 1:
            num_d = 2
        # the volume depth on a short ladder (OMVS_SGM_ND_LADDER): it sets
        # the DP's disparity domain, so it is behaviour, not layout
        num_d = min(next((b for b in ladder if b >= num_d), ladder[-1]),
                    max_num_d)

        last = li == len(scales) - 1
        sub = last and subpixel_mode not in ("na", None)
        if runner is None:
            res = _match_level(A, B, lo, hi, loR, hiR, l_min, num_d, p1, p2, alpha,
                               beta, num_dirs, sub, dev)
        else:
            cls = (hs, ws, num_d, p1, p2, alpha, beta, num_dirs, sub)
            prog = runner.kept(("sgm_level",) + cls, lambda: LevelProgram(runner, *cls))
            res = prog.run(A, B, lo, hi, loR, hiR, l_min)
        dintL, costL, dintR = res[0].astype(np.int32), res[1], res[2].astype(np.int32)
        if sub:
            dsub = _subpixel(costL, res[3], res[4], dintL, subpixel_mode)
        else:
            dsub = dintL.astype(np.float32)
        # cross-check |dL(x) + dR(x + dL)| <= 1
        xs = np.arange(ws)[None, :] + dintL
        xi = np.clip(xs, 0, ws - 1)
        dr = np.take_along_axis(dintR, xi, axis=1)
        ok = (np.abs(dintL + dr) <= 1) & (xs >= 0) & (xs < ws)
        disp = np.where(ok, dsub, np.nan).astype(np.float32)
        if li == 0 and tsgm:
            disp = _speckle_filter(disp)
        cost_map = costL
        wall = time.perf_counter() - t_lv
        if stats is not None:
            stats.append({"level": li, "hw": [hs, ws], "num_d": num_d,
                          "l_min": l_min, "seconds": wall})
        if debug:
            print(f"SGM_DEBUG level={li} hw=({hs},{ws}) num_d={num_d} "
                  f"lmin={l_min} lmax={l_max} span={span} "
                  f"glob=({glo},{ghi}) "
                  f"valid={np.isfinite(disp).mean():.3f} "
                  f"wall={wall:.2f}s", flush=True)
    return disp, cost_map


def project_disparity_to_depth(
    disp: np.ndarray, cost: np.ndarray, info: dict, cam_ref,
    out_shape, subpixel_steps: float = 4.0,
):
    """Rectified disparity -> depth/conf/trust-range maps in the ORIGINAL
    reference camera (ProjectDisparity2DepthMap,
    SemiGlobalMatcher.cpp:1570-1650).

    Returns (depth, range_lo, range_hi, conf) at out_shape; 0 = invalid."""
    Kn, Rn, b = info["Kn"], info["Rn"], info["baseline"]
    f = Kn[0, 0]
    H, W = disp.shape
    ys, xs = np.nonzero(np.isfinite(disp) & (disp < -1e-3))
    out_d = np.zeros(out_shape, np.float32)
    out_lo = np.zeros(out_shape, np.float32)
    out_hi = np.zeros(out_shape, np.float32)
    out_c = np.zeros(out_shape, np.float32)
    if len(ys) == 0:
        return out_d, out_lo, out_hi, out_c
    d = disp[ys, xs].astype(np.float64)
    # z in the rectified frame: uA - uB = f b / z and d = uB - uA => z = -f b / d
    z = -f * b / d
    dd = 0.5 / subpixel_steps
    z_hi = -f * b / np.minimum(d + dd, -1e-6)
    z_lo = -f * b / (d - dd)
    good = (z > 0) & np.isfinite(z)
    ys, xs, d, z, z_lo, z_hi = ys[good], xs[good], d[good], z[good], z_lo[good], z_hi[good]
    uv1 = np.stack([xs, ys, np.ones_like(xs)], axis=0).astype(np.float64)
    Xc_rect = np.linalg.inv(Kn) @ uv1 * z
    C1 = info.get("C1")
    Xw = (Rn.T @ Xc_rect).T + C1
    # project into the original reference camera
    Xc = (cam_ref.R @ (Xw - cam_ref.C).T)
    zr = Xc[2]
    front = zr > 0
    u = cam_ref.K[0, 0] * Xc[0] / zr + cam_ref.K[0, 2] + cam_ref.K[0, 1] * Xc[1] / zr
    v = cam_ref.K[1, 1] * Xc[1] / zr + cam_ref.K[1, 2]
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    Ho, Wo = out_shape
    ok = front & (ui >= 0) & (ui < Wo) & (vi >= 0) & (vi < Ho)
    ui, vi, zr = ui[ok], vi[ok], zr[ok]
    scale = zr / z[ok]           # rectified-z -> reference-z scale per point
    c = 1.0 / (1.0 + cost[ys[ok], xs[ok]] / 255.0)
    # z-buffer scatter: nearest depth wins
    lin = vi * Wo + ui
    order = np.argsort(zr, kind="stable")[::-1]    # far first, near overwrites
    out_d.reshape(-1)[lin[order]] = zr[order]
    out_lo.reshape(-1)[lin[order]] = (z_lo[ok] * scale)[order]
    out_hi.reshape(-1)[lin[order]] = (z_hi[ok] * scale)[order]
    out_c.reshape(-1)[lin[order]] = c[order]
    return out_d, out_lo, out_hi, out_c


def fuse_pair_depths(pair_maps, min_views: int):
    """Cluster-based per-pixel fusion across pair depth maps
    (SemiGlobalMatcher::Fuse, SemiGlobalMatcher.cpp:795-850): a pixel's
    depth = the average of the LARGEST cluster of pairwise depths whose
    trust regions overlap; clusters below min_views are dropped.

    pair_maps: list of (depth, lo, hi, conf) tuples at a common shape."""
    P = len(pair_maps)
    if P == 0:
        return None, None
    D = np.stack([m[0] for m in pair_maps])      # (P, H, W)
    LO = np.stack([m[1] for m in pair_maps])
    HI = np.stack([m[2] for m in pair_maps])
    C = np.stack([m[3] for m in pair_maps])
    valid = D > 0
    # member[s, q]: pair q's depth inside seed s's trust region
    member = (D[None] >= np.minimum(LO, HI)[:, None]) & (
        D[None] <= np.maximum(LO, HI)[:, None]) & valid[None] & valid[:, None]
    counts = member.sum(axis=1)                  # (P, H, W)
    best = np.argmax(counts, axis=0)             # (H, W)
    bm = np.take_along_axis(member, best[None, None], axis=0)[0]   # (P, H, W)
    n = np.take_along_axis(counts, best[None], axis=0)[0]
    wsum = (bm * valid).sum(axis=0)
    keep = (n >= min_views) & (wsum > 0)
    depth = np.where(keep, (D * bm).sum(axis=0) / np.maximum(wsum, 1), 0.0)
    conf = np.where(keep, (C * bm).sum(axis=0) / np.maximum(wsum, 1), 0.0)
    return depth.astype(np.float32), conf.astype(np.float32)
