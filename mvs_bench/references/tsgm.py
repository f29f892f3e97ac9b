"""The reference ``tsgm``: a plain tSGM matcher, and the comparison that
decides ``correct`` for a configuration whose ``reference`` it is.

The program's SGM estimator matches each rectified pair coarse to fine
(``sgm.match_pair_tsgm``, openMVS's SemiGlobalMatcher::Match,
SemiGlobalMatcher.cpp:530-737). This module computes the same matching
again in plain PyTorch, float32 with TF32 off, from the published
description and the port's documented choices; it imports nothing of the
program and calls none of its functions:

- the level pyramid: the coarsest level at 1/2^l, l the number of halvings
  of the longer side that stay at or above 320 pixels and at least 1 (one
  half-resolution level); images halved by 2x2 means;
- per-pixel disparity windows [lo, hi): at the coarsest level the pair's
  global range widened by 8; above it from the previous level's
  disparities (Disparity2RangeMap, SemiGlobalMatcher.cpp:1350-1445):
  the least and greatest valid disparity of a 7x7 window (41x41 around
  an invalid pixel), its midpoint doubled as the centre and twice its
  span, at least 11 (5 after the first upsample) and at most 32 (64
  around an invalid pixel), as the width; where a window holds fewer than
  3 samples the band of +-33 (+-7 after the first upsample) around the
  global range's midpoint; each window repeated 2x2; the right match's
  from the left disparities moved to where they land;
- the volume depth: the span of the left windows, placed where it keeps
  the most windows whole if it passes 256, rounded up on the ladder 16,
  32, 64, 128, 192, 256;
- the WZNCC cost of a pixel and disparity (SemiGlobalMatcher.cpp:900-975):
  7x7 bilateral weights exp(-dI^2 / (2 0.3^2) - r^2 / (2 (0.4 7)^2)) of
  the left image (edge-padded), the weighted NCC of the left and right
  patches, 255 where it is 0 or below or the right pixel is out of the
  image, else round((1 - min(ncc, 1)) 255); 255 outside the pixel's
  window;
- aggregation over 8 directions (4 axis-aligned, 4 diagonal, each forward
  and back) of L(d) = C(d) + min(L'(d), L'(d -+ 1) + P1, min L' + P2) -
  min L', with P2 = p2 (1 + alpha exp(-g^2 / (2 beta^2))) at the pixel, g
  the image's central-difference gradient across the direction (the mean
  of both for a diagonal), summed over the directions;
- the winner (the lowest disparity of the least sum), both directions
  matched and cross-checked (|dL(x) + dR(x + dL)| <= 1); at the coarsest
  level a speckle filter (4-connected regions of disparities within 5 of
  each other, at most 100 pixels, dropped); at the finest the lc_blend
  sub-pixel fit of the winner's and its neighbours' sums
  (RefineDisparityMap, SemiGlobalMatcher.cpp:1693-1800).

Departures from openMVS, each the port's and kept here so that the two
compute the same thing:

- the disparity windows are dense (costs outside them set to 255), not
  openMVS's compressed per-pixel ranges, and the centre of a window is
  the midpoint of its extremes, not the median;
- the right patch is read through a copy of the right image shifted by
  the volume's first disparity, as wide as the image: a texel beyond that
  copy reads 0 even where the image has a pixel;
- the NCC's denominator is sqrt(max(n0 n1 + 1e-3, 1e-12));
- a diagonal path that enters at a side column starts from a carry of
  1e9, less half of it, clamped to 1e9;
- the volume depth's ladder, the band at the global midpoint, and each
  window's sample count taken as ``scipy.ndimage.uniform_filter`` rounds
  it (float32 means of each axis in turn, times the width twice).

``install(probes)`` keeps, for every pair of the judged views (the
centre view, ``n_views // 2``, and the corner view 0) that the program
matches in a job, its inputs (the rectified pair and the global range) and
what it returned, as plain NumPy copies in ``job.kept``. ``judge`` runs
this matcher on those inputs on the card (once per distinct input) and
compares, over the judged pairs:

- ``pair_off_pct``: the pixels valid in both whose disparities differ by
  more than one sub-pixel step (1 / ``sgm_subpixel_steps`` px), a share
  of the pixels valid in both;
- ``pair_xor_pct``: the pixels valid in exactly one, a share of those
  valid in either;

``views_missing_pct``, the scene's views with no served depth (no
filtered map, or one with no depth in it), a share of its views: the
judged views alone cannot see views left out elsewhere; and
``geometry``'s readings of the job's filtered maps and fused cloud. The
matcher's inputs are the program's on purpose: rectification, projection
and fusion are host steps that ``geometry``'s readings judge. ``control``
runs the matcher with its volume and aggregation in bfloat16 on pairs it
rectifies itself and compares it with the float32 matcher.
"""

from __future__ import annotations

import hashlib
import math
import threading
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mvs_bench import harness, scene_gen

_geometry = harness.load_reference("geometry")

COMPARED = ("pair_off_pct", "pair_xor_pct", "views_missing_pct") + _geometry.COMPARED

MIN_RESOLUTION = 320
MAX_NUM_D = 256
LADDER = (16, 32, 64, 128, 192, 256)
HALF = 3  # the 7x7 patch
SIGMA_COLOR = -1.0 / (2.0 * 0.3 ** 2)
SIGMA_SPATIAL = -1.0 / (2.0 * (0.4 * (2 * HALF + 1)) ** 2)
EPS = 1e-3
BIG = 1e9  # the carry outside the image
CMAX = 255.0
SPECKLE_SIZE, SPECKLE_DIFF = 100, 5.0
# cost cells of a volume chunk (bounds the chunk's accumulators)
CHUNK_CELLS = 1 << 25


class Params(NamedTuple):
    p1: float
    p2: float
    alpha: float
    beta: float
    steps: float  # sub-pixel steps per pixel: the precision compared


def params(cfg: dict) -> Params:
    o = cfg["options"]
    if o.get("sgm_subpixel_mode", "lc_blend") != "lc_blend" or o.get("sgm_num_dirs", 8) != 8:
        raise ValueError("references/tsgm.py computes lc_blend sub-pixels over 8 directions")
    return Params(float(o.get("sgm_p1", 3.0)), float(o.get("sgm_p2", 4.0)),
                  float(o.get("sgm_p2_alpha", 14.0)), float(o.get("sgm_p2_beta", 38.0 / 255.0)),
                  float(o.get("sgm_subpixel_steps", 4)))


# ------------------------------------------------------------ the matcher


def _halve(img: torch.Tensor, f: int) -> torch.Tensor:
    """The f x f block means of an (H, W) image (H, W multiples of f); for
    f = 2 as the sum of the two row pairs, over 4."""
    if f == 1:
        return img
    if img.shape[0] % f or img.shape[1] % f:
        raise ValueError(f"an image of {tuple(img.shape)} does not halve {f} times evenly")
    if f == 2:
        return ((img[0::2, 0::2] + img[0::2, 1::2]) + (img[1::2, 0::2] + img[1::2, 1::2])) * 0.25
    return F.avg_pool2d(img[None, None], f)[0, 0]


def _scales(H: int, W: int) -> List[int]:
    """The pyramid's downscale factors, coarsest first, ending with 1."""
    lvl = 0
    while (max(H, W) >> (lvl + 1)) >= MIN_RESOLUTION and lvl < 8:
        lvl += 1
    lvl = max(lvl, 1 if min(H, W) >= 32 else 0)
    return [1 << (lvl - i) for i in range(lvl)] + [1]


def _texels():
    return [(dy, dx) for dy in range(-HALF, HALF + 1) for dx in range(-HALF, HALF + 1)]


def _weights(left: torch.Tensor):
    """The bilateral weights of the left image's patches: w (T, H, W), the
    weighted centred texels tw (T, H, W), their sum sum_w and the left
    patch's weighted variance n0 (H, W)."""
    H, W = left.shape
    lp = F.pad(left[None, None], (HALF,) * 4, mode="replicate")[0, 0]
    tex = torch.stack([lp[HALF + dy:HALF + dy + H, HALF + dx:HALF + dx + W]
                       for dy, dx in _texels()])
    r2 = torch.tensor([float(dy * dy + dx * dx) for dy, dx in _texels()],
                      device=left.device)[:, None, None]
    w = torch.exp((tex - left) ** 2 * SIGMA_COLOR + r2 * SIGMA_SPATIAL)
    sum_w = w.sum(0)
    mean = (w * tex).sum(0) / sum_w
    tw = w * (tex - mean)
    return w, tw, sum_w, (tw * (tex - mean)).sum(0)


def _volume(left, right, d_min: int, num_d: int, lo, hi, dtype) -> torch.Tensor:
    """(H, W, num_d) WZNCC costs of ``left`` against ``right`` for the
    disparities d_min + i (left x -> right x + d), 255 outside [lo, hi),
    accumulated in ``dtype``."""
    H, W = left.shape
    dev = left.device
    w, tw, sum_w, n0 = (t.to(dtype) for t in _weights(left))
    # the right image read through its copy shifted by d_min, W wide, with
    # zeros around it
    cols = torch.arange(W, device=dev)
    src = cols + d_min
    shifted = torch.where(((src >= 0) & (src < W))[None, :],
                          right[:, src.clamp(0, W - 1)], torch.zeros((), device=dev))
    padded = torch.zeros((H + 2 * HALF, W + num_d + 2 * HALF), device=dev, dtype=dtype)
    padded[HALF:HALF + H, HALF:HALF + W] = shifted.to(dtype)
    windows = padded.unfold(1, W, 1)  # [row, first column, W]
    vol = torch.empty((num_d, H, W), device=dev)
    chunk = max(1, min(num_d, CHUNK_CELLS // (H * W)))
    for i0 in range(0, num_d, chunk):
        n = min(chunk, num_d - i0)
        s = sq = nom = None
        for k, (dy, dx) in enumerate(_texels()):
            r = windows[HALF + dy:HALF + dy + H, HALF + dx + i0:HALF + dx + i0 + n].transpose(0, 1)
            wr = w[k] * r
            s = wr if s is None else s + wr
            sq = wr * r if sq is None else sq + wr * r
            nom = tw[k] * r if nom is None else nom + tw[k] * r
        n1 = sq - s * s / sum_w
        ncc = nom / torch.sqrt(torch.clamp(n0 * n1 + EPS, min=1e-12))
        cost = torch.where(ncc <= 0, CMAX, torch.round((1 - torch.clamp(ncc, max=1.0)) * CMAX))
        d = (torch.arange(i0, i0 + n, device=dev) + d_min)[:, None, None]
        out = (cols + d < 0) | (cols + d >= W) | (d < lo) | (d >= hi)
        vol[i0:i0 + n] = torch.where(out, CMAX, cost.float())
    return vol.permute(1, 2, 0).to(dtype)


def _gradient(img: torch.Tensor):
    """(|d/dy|, |d/dx|): central differences inside, one-sided at the
    edges."""
    out = []
    for dim in (0, 1):
        n = img.shape[dim]
        a, b = img.narrow(dim, 0, 1), img.narrow(dim, 1, 1)
        y, z = img.narrow(dim, n - 2, 1), img.narrow(dim, n - 1, 1)
        inner = (img.narrow(dim, 2, n - 2) - img.narrow(dim, 0, n - 2)) * 0.5
        out.append(torch.cat([b - a, inner, z - y], dim).abs())
    return out


def _scan(cost: torch.Tensor, p2: torch.Tensor, p1: float, shift: int) -> torch.Tensor:
    """Paths along axis 1 of (B, N, M, D) costs, P2 (B, N, M) at each
    pixel; with ``shift`` 1 the previous step's pixel is one column to the
    left (a diagonal), and a path entering at column 0 starts from BIG,
    with the 1e9 clamps."""
    B, N, M, D = cost.shape
    out = torch.empty_like(cost)
    out[:, 0] = cost[:, 0]
    big = torch.full((B, 1, D), BIG, device=cost.device, dtype=cost.dtype)
    pad = torch.full((B, M, 1), BIG, device=cost.device, dtype=cost.dtype)
    prev = cost[:, 0]
    for t in range(1, N):
        lp = torch.cat([big, prev[:, :-1]], 1) if shift else prev
        m = lp.amin(-1, keepdim=True)
        near = torch.minimum(torch.cat([lp[..., 1:], pad], -1), torch.cat([pad, lp[..., :-1]], -1))
        best = torch.minimum(torch.minimum(lp, near + p1), m + p2[:, t, :, None])
        if shift:
            cur = torch.clamp(cost[:, t] + best - torch.clamp(m, max=BIG / 2), max=BIG)
        else:
            cur = cost[:, t] + best - m
        out[:, t] = cur
        prev = cur
    return out


def _p2(g: torch.Tensor, p: Params) -> torch.Tensor:
    return p.p2 * (1 + p.alpha * torch.exp(-(g * g) / (2 * p.beta * p.beta)))


def aggregate(cost: torch.Tensor, imgs: torch.Tensor, p: Params) -> torch.Tensor:
    """The sum of the 8 directions' paths over (B, H, W, D) costs with the
    (B, H, W) float32 left images: left-right and back, top-down and back,
    then the four diagonals, in the costs' dtype."""
    B = cost.shape[0]
    dt = cost.dtype
    g = [_gradient(im) for im in imgs]
    gy = torch.stack([a for a, _ in g])
    gx = torch.stack([b for _, b in g])
    p2x, p2y, p2d = _p2(gx, p).to(dt), _p2(gy, p).to(dt), _p2(0.5 * (gx + gy), p).to(dt)
    ct, pt = cost.transpose(1, 2), p2x.transpose(1, 2)
    h = _scan(torch.cat([ct, ct.flip(1)]), torch.cat([pt, pt.flip(1)]), p.p1, 0)
    total = h[:B].transpose(1, 2) + h[B:].flip(1).transpose(1, 2)
    del h
    v = _scan(torch.cat([cost, cost.flip(1)]), torch.cat([p2y, p2y.flip(1)]), p.p1, 0)
    total = total + v[:B]
    total = total + v[B:].flip(1)
    del v
    cf, pf = cost.flip(2), p2d.flip(2)
    d = _scan(torch.cat([cost, cost.flip(1), cf, cf.flip(1)]),
              torch.cat([p2d, p2d.flip(1), pf, pf.flip(1)]), p.p1, 1)
    total = total + d[:B]
    total = total + d[B:2 * B].flip(1)
    total = total + d[2 * B:3 * B].flip(2)
    return total + d[3 * B:].flip(1).flip(2)


def _winner(agg: torch.Tensor):
    """(the lowest index of the least sum, the least sum) along the last
    axis."""
    D = agg.shape[-1]
    mn = agg.amin(-1, keepdim=True)
    ar = torch.arange(D, device=agg.device, dtype=torch.int16)
    idx = torch.where(agg == mn, ar, D).amin(-1).long()
    return idx, mn[..., 0]


def _lc_blend(c0, cm, cp, dint):
    """The lc_blend sub-pixel disparity from the winner's sum and its
    neighbours' (float32)."""
    ld, rd = cm - c0, cp - c0
    x_r = torch.where(rd > 0, ld / torch.clamp(rd, min=1e-12), 0.0)
    x_l = torch.where(ld > 0, rd / torch.clamp(ld, min=1e-12), 0.0)
    use_r = ld < rd
    x = torch.clamp(torch.where(use_r, x_r, x_l), 0.0, 1.0)
    factor = 1.195 - torch.cos(x * (math.pi / 2.3))
    fit = (1.0 - torch.cos(x * (math.pi / 3.0))) * factor + (x / 2.0) * (1.0 - factor)
    off = (fit - 0.5) * torch.where(use_r, 1.0, -1.0)
    off = torch.where((cm == c0) & (cp != c0), 0.5 * (c0 / torch.clamp(cp, min=1e-12)), off)
    off = torch.where((cp == c0) & (cm != c0), -0.5 * (c0 / torch.clamp(cm, min=1e-12)), off)
    off = torch.where((cm == c0) & (cp == c0), 0.0, off)
    return dint.float() + torch.clamp(off, -0.5, 0.5)


def _speckles(disp: torch.Tensor) -> torch.Tensor:
    """``disp`` (NaN invalid) with every 4-connected region of at most
    SPECKLE_SIZE pixels whose neighbours differ by at most SPECKLE_DIFF
    (in 1/16 px) made invalid: regions labelled by their least pixel index,
    by min-label propagation with hooking and pointer jumping."""
    H, W = disp.shape
    good = torch.isfinite(disp)
    d16 = torch.where(good, disp * 16, 0.0).to(torch.int32)
    lim = int(SPECKLE_DIFF * 16)
    across = good[:, :-1] & good[:, 1:] & ((d16[:, :-1] - d16[:, 1:]).abs() <= lim)
    down = good[:-1] & good[1:] & ((d16[:-1] - d16[1:]).abs() <= lim)
    n = H * W
    ids = torch.arange(n, device=disp.device).reshape(H, W)
    a = torch.cat([ids[:, :-1][across], ids[:-1][down]])
    b = torch.cat([ids[:, 1:][across], ids[1:][down]])
    lab = torch.arange(n, device=disp.device)
    while True:
        la, lb = lab[a], lab[b]
        low = torch.minimum(la, lb)
        new = lab.clone()
        new.scatter_reduce_(0, la, low, "amin")  # hook the roots
        new.scatter_reduce_(0, lb, low, "amin")
        new.scatter_reduce_(0, a, low, "amin")
        new.scatter_reduce_(0, b, low, "amin")
        while True:  # jump to the roots
            nxt = new[new]
            if torch.equal(nxt, new):
                break
            new = nxt
        if torch.equal(new, lab):
            break
        lab = new
    size = torch.bincount(lab, minlength=n)
    small = good & (size[lab].reshape(H, W) <= SPECKLE_SIZE)
    return torch.where(small, float("nan"), disp)


def _count(valid: torch.Tensor, size: int) -> torch.Tensor:
    """The valid samples of each size x size window (edges repeated), as
    ``scipy.ndimage.uniform_filter`` of the float32 mask times size twice
    rounds them."""
    r = size // 2
    H, W = valid.shape
    v = F.pad(valid.double()[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    m0 = (sum(v[k:k + H] for k in range(size)) / size).float()
    v = F.pad(m0.double()[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    m1 = (sum(v[:, k:k + W] for k in range(size)) / size).float()
    return m1 * size * size


def _windows(prior: torch.Tensor, shape, mnd: int, g_lo: int, g_hi: int):
    """The per-pixel windows (lo, hi) int32 at ``shape`` (twice the prior's)
    from the previous level's disparities ``prior`` (NaN invalid)."""
    valid = torch.isfinite(prior)
    inf = torch.tensor(float("inf"), device=prior.device)
    low = torch.where(valid, prior, inf)[None, None]
    high = torch.where(valid, prior, -inf)[None, None]
    stats = {}
    for size in (7, 41):
        r = size // 2
        stats[size] = (-F.max_pool2d(-low, size, 1, r)[0, 0],
                       F.max_pool2d(high, size, 1, r)[0, 0], _count(valid, size))
    mn, mx, cnt = (torch.where(valid, a, b) for a, b in zip(stats[7], stats[41]))
    cap = torch.where(valid, 32.0, 64.0)
    center = mn + mx
    width = torch.minimum(((mx - mn) * 2).clamp(min=float(mnd)), cap)
    ok = torch.isfinite(mn) & torch.isfinite(mx) & (cnt >= 3)
    lo = torch.where(ok, center - width / 2, float(g_lo))
    hi = torch.where(ok, center + (width + 1) / 2, float(g_hi))
    H, W = shape

    def up(x):
        x = x.repeat_interleave(2, 0).repeat_interleave(2, 1)[:H, :W]
        x = F.pad(x[None, None], (0, W - x.shape[1], 0, H - x.shape[0]), mode="replicate")
        return x[0, 0].to(torch.int16).to(torch.int32)  # toward zero, as an int16 cast

    return up(lo), up(hi)


def _moved(disp: torch.Tensor) -> torch.Tensor:
    """The right view's prior: -d at x + round(d) of each valid left pixel
    (the rightmost source where several land), NaN elsewhere."""
    H, W = disp.shape
    ys, xs = torch.nonzero(torch.isfinite(disp), as_tuple=True)
    d = disp[ys, xs]
    xr = torch.round(xs + d).long()
    ok = (xr >= 0) & (xr < W)
    ys, xs, xr, d = ys[ok], xs[ok], xr[ok], d[ok]
    target = ys * W + xr
    last = torch.full((H * W,), -1, dtype=torch.long, device=disp.device)
    last.scatter_reduce_(0, target, xs, "amax")
    out = torch.full((H * W,), float("nan"), device=disp.device)
    pick = last[target] == xs
    out[target[pick]] = -d[pick]
    return out.reshape(H, W)


def _extent(lo: torch.Tensor, hi: torch.Tensor) -> tuple:
    """(first disparity, volume depth) covering the left windows."""
    l_min, l_max = int(lo.min()), int(hi.max())
    if l_max - l_min > MAX_NUM_D:
        cand = np.unique(np.linspace(l_min, l_max - MAX_NUM_D, 17).astype(int))
        covered = [int(((lo >= c) & (hi <= c + MAX_NUM_D)).sum()) for c in cand]
        l_min = int(cand[int(np.argmax(covered))])
    num_d = max(min(l_max - l_min, MAX_NUM_D), 2)
    return l_min, min(next((b for b in LADDER if b >= num_d), LADDER[-1]), MAX_NUM_D)


def match_pair(rectA, rectB, d_lo: int, d_hi: int, p: Params, device,
               dtype=torch.float32) -> np.ndarray:
    """The disparity (NaN invalid, float32 numpy) of a rectified pair
    (H, W float32 arrays) with global range [d_lo, d_hi]; the volumes and
    their aggregation in ``dtype``, everything else in float32."""
    A0 = torch.as_tensor(np.asarray(rectA, np.float32), device=device)
    B0 = torch.as_tensor(np.asarray(rectB, np.float32), device=device)
    H, W = A0.shape
    factors = _scales(H, W)
    disp = None
    for li, f in enumerate(factors):
        s = 1.0 / f
        A, B = _halve(A0, f), _halve(B0, f)
        hs, ws = A.shape
        glo, ghi = int(np.floor(d_lo * s)) - 8, int(np.ceil(d_hi * s)) + 8
        if disp is None:
            lo = torch.full((hs, ws), glo, device=device)
            hi = torch.full((hs, ws), ghi, device=device)
            loR, hiR = -hi, -lo
        else:
            mnd, mnd_i = (11, 33) if li == 1 else (5, 7)
            mid = (glo + ghi) // 2
            fb = (max(glo, mid - mnd_i), min(ghi, mid + mnd_i))
            lo, hi = _windows(disp, (hs, ws), mnd, *fb)
            loR, hiR = _windows(_moved(disp), (hs, ws), mnd, -fb[1], -fb[0])
        l_min, num_d = _extent(lo, hi)
        r_min = -(l_min + num_d - 1)
        vols = torch.stack([_volume(A, B, l_min, num_d, lo, hi, dtype),
                            _volume(B, A, r_min, num_d, loR, hiR, dtype)])
        agg = aggregate(vols, torch.stack([A, B]), p)
        del vols
        idx, c0 = _winner(agg)
        dL, dR = idx[0] + l_min, idx[1] + r_min
        if li == len(factors) - 1:
            D = agg.shape[-1]
            nb = [torch.gather(agg[0], -1, (idx[0] + k).clamp(0, D - 1)[..., None])[..., 0]
                  for k in (-1, 1)]
            dsub = _lc_blend(c0[0].float(), nb[0].float(), nb[1].float(), dL)
        else:
            dsub = dL.float()
        del agg
        xs = torch.arange(ws, device=device) + dL
        dr = torch.gather(dR, 1, xs.clamp(0, ws - 1))
        ok = ((dL + dr).abs() <= 1) & (xs >= 0) & (xs < ws)
        disp = torch.where(ok, dsub, float("nan"))
        if li == 0 and len(factors) > 1:
            disp = _speckles(disp)
    return disp.cpu().numpy()


# ------------------------------------------------------------ the judge


def judged_views(n_views: int) -> tuple:
    """The views whose pairs are judged: the centre view and a corner."""
    return (n_views // 2, 0)


def install(probes) -> None:
    """Keep, on each job, every pair of the judged views that the program
    matches: (view, rectified left, right, d_lo, d_hi, disparity, cost)."""
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.ops import sgm

    here = threading.local()
    estimate = densify.estimate_depth_map_sgm
    match = sgm.match_pair_tsgm

    def estimated(scene, ref_idx, *args, **kwargs):
        outer = getattr(here, "view", None)
        here.view = ref_idx if ref_idx in judged_views(scene.n_views) else None
        try:
            return estimate(scene, ref_idx, *args, **kwargs)
        finally:
            here.view = outer

    def matched(rectA, rectB, d_lo, d_hi, *args, **kwargs):
        disp, cost = match(rectA, rectB, d_lo, d_hi, *args, **kwargs)
        view, job = getattr(here, "view", None), probes.job
        if view is not None and job is not None:
            job.kept.setdefault("tsgm", []).append(
                (view, np.array(rectA, np.float32), np.array(rectB, np.float32), int(d_lo),
                 int(d_hi), np.array(disp, np.float32), np.array(cost, np.float32)))
        return disp, cost

    probes.patch(densify, "estimate_depth_map_sgm", estimated)
    probes.patch(sgm, "match_pair_tsgm", matched)


class Prepared(NamedTuple):
    truth: object  # geometry's float64 truth of the scene
    params: Params
    device: object
    done: Dict[bytes, np.ndarray]  # the matcher's disparity by input digest


def prepare(cfg: dict, device) -> Prepared:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Prepared(_geometry.prepare(cfg, device), params(cfg), device, {})


def _digest(rectA, rectB, d_lo, d_hi) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for a in (rectA, rectB, np.array([d_lo, d_hi], np.int64)):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def pair_readings(pairs, tol: float) -> Dict[str, float]:
    """``pair_off_pct`` and ``pair_xor_pct`` over (served, reference)
    disparity pairs (NaN invalid); 100 where there is no pair."""
    n_both = n_off = n_either = n_xor = 0
    for got, want in pairs:
        vg, vw = np.isfinite(got), np.isfinite(want)
        both = vg & vw
        n_both += int(both.sum())
        n_off += int((np.abs(got[both].astype(np.float64) - want[both]) > tol).sum())
        n_either += int((vg | vw).sum())
        n_xor += int((vg ^ vw).sum())
    return {"pair_off_pct": 100.0 * n_off / n_both if n_both else 100.0,
            "pair_xor_pct": 100.0 * n_xor / n_either if n_either else 100.0,
            "pairs_judged": float(len(pairs))}


def views_missing_pct(maps: Dict[int, np.ndarray], n_views: int) -> float:
    """The share of the ``n_views`` views whose served map ``maps`` lacks
    or holds no depth."""
    served = sum(1 for i in range(n_views) if i in maps and bool((maps[i] > 0).any()))
    return 100.0 * (n_views - served) / n_views


def judge(prepared: Prepared, job) -> Dict[str, float]:
    """One job's readings: its judged pairs against the matcher, the views
    it served, and ``geometry``'s of its filtered maps and fused cloud."""
    pairs = []
    for view, rectA, rectB, d_lo, d_hi, disp, _ in job.kept.get("tsgm", []):
        key = _digest(rectA, rectB, d_lo, d_hi)
        if key not in prepared.done:
            prepared.done[key] = match_pair(rectA, rectB, d_lo, d_hi, prepared.params,
                                            prepared.device)
        pairs.append((disp, prepared.done[key]))
    t = prepared.truth
    out = pair_readings(pairs, 1.0 / prepared.params.steps)
    out["views_missing_pct"] = views_missing_pct(job.maps, len(t.maps))
    out.update(_geometry.readings(job.maps, job.points, t.maps, t.tol))
    return out


# ------------------------------------------------------------ the control


def _rectified(gray_a, gray_b, K, Ca, Cb, device):
    """The pair rectified (identity rotations, one K): both images seen
    through the rotation whose x axis is the baseline, bilinear, 0
    outside; and (K, that rotation)."""
    vx = (Cb - Ca) / np.linalg.norm(Cb - Ca)
    vy = np.cross(np.array([0.0, 0.0, 1.0]), vx)
    vy /= np.linalg.norm(vy)
    R = np.stack([vx, vy, np.cross(vx, vy)])
    H, W = gray_a.shape
    inv = K @ R.T @ np.linalg.inv(K)  # rectified pixel -> source pixel
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    q = inv @ np.stack([xs.ravel(), ys.ravel(), np.ones(H * W)])
    u, v = q[0] / q[2], q[1] / q[2]
    grid = torch.as_tensor(np.stack([2 * u / (W - 1) - 1, 2 * v / (H - 1) - 1], -1)
                           .reshape(1, H, W, 2), dtype=torch.float32, device=device)
    out = []
    for g in (gray_a, gray_b):
        img = torch.as_tensor(np.asarray(g, np.float32), device=device)[None, None]
        out.append(F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)[0, 0].cpu().numpy())
    return out[0], out[1], R


def _seeded_range(points, K, R, Ca, Cb):
    """The pair's global disparity range from the sparse points seen by the
    left view: their 1st and 99th percentile, widened by 4."""
    def u(C):
        Xc = R @ (points - C).T
        return K[0, 0] * Xc[0] / Xc[2] + K[0, 2]

    d = u(Cb) - u(Ca)
    return int(np.floor(np.percentile(d, 1))) - 4, int(np.ceil(np.percentile(d, 99))) + 4


def control(cfg: dict, device, dtype=torch.bfloat16) -> Dict[str, float]:
    """The control: the matcher with its volumes and aggregation in
    ``dtype`` in the program's place on the judged views' pairs of a scene
    drawn from torch's generator, against the float32 matcher; and
    ``geometry``'s control for its readings, which serves a map of every
    view (so no view is missing)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,)))
    arrays = scene_gen.make_scene(cfg, seed, device)
    p = params(cfg)
    n = arrays.n_views
    Cs = [np.asarray(C, np.float64) for C in arrays.Cs]
    pairs = []
    for a in judged_views(n):
        seen = np.array([a in v for v in arrays.point_views])
        pts = arrays.points[seen].astype(np.float64)
        others = sorted((b for b in range(n) if b != a),
                        key=lambda b: np.linalg.norm(Cs[b] - Cs[a]))
        for b in others[:cfg["options"].get("max_views", 12)]:
            rectA, rectB, R = _rectified(arrays.grays[a], arrays.grays[b], arrays.K, Cs[a],
                                         Cs[b], device)
            d_lo, d_hi = _seeded_range(pts, arrays.K, R, Cs[a], Cs[b])
            want = match_pair(rectA, rectB, d_lo, d_hi, p, device)
            pairs.append((match_pair(rectA, rectB, d_lo, d_hi, p, device, dtype), want))
    out = pair_readings(pairs, 1.0 / p.steps)
    out["views_missing_pct"] = 0.0
    out.update(_geometry.control(cfg, device))
    return out
