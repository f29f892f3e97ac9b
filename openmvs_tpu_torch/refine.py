"""Variational photometric mesh refinement.

Port of the JAX package's ``openmvs_tpu/refine.py`` (Scene::RefineMesh,
libs/MVS/SceneRefine.cpp:1279-1422, Vu/Keriven'12): coarse-to-fine scales;
per iteration the mesh is rasterized into each view, neighbour images are
warped through the surface into the reference view, and the
photo-consistency (ZNCC) energy plus Laplacian rigidity drives vertex
movement.

The gradients are hand-derived as the reference's are
(ComputePhotometricGradient, SceneRefine.cpp:161-175): autograd is applied
only to the gather-free windowed-ZNCC tail, the bilinear derivative is the
exact interpolant gradient and the projective/barycentric chain rule is
explicit. Rasterization runs on the host (``openmvs_tpu_torch.native``)
every 8 iterations and its (face id, barycentric) maps are constants in
between, the reference's fixed visibility per iteration. All pairs are
stacked on a leading pair axis and each iteration is one pass of PyTorch
on the device. The JAX package reaches no Pallas kernel here; its jitted
iteration (``_device_iter``) becomes an ``IterProgram``, on a card a CUDA
graph replayed once an iteration, and its scatter-adds ordered segment
sums (``ops/segment.py``, the ``csrc/segment_sum.cu`` kernel on a card).

``refine_mesh(devices=[...])`` splits the pair axis over several devices
(``PairShards``), iterating eagerly. Left out: the TPU compile-cache levers (shape
bucketing), the full-autodiff Adam path
(``OMVS_REFINE_CPU_AD``) and the other ``OMVS_REFINE_*`` switches (their
defaults run). The mesh conditioning before the scales (``decimate``,
``ensure_edge_size``; ``condition_mesh``) is host code from ``mesh_ops``.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from openmvs_tpu_torch import mesh_ops, native
from openmvs_tpu_torch.config import DenseOptions, RefineOptions
from openmvs_tpu_torch.io import images as imio
from openmvs_tpu_torch.mesh_ops import edges_of_faces
from openmvs_tpu_torch.ops import graphs, segment
from openmvs_tpu_torch.parallel.mesh import psum, resolve_device, to
from openmvs_tpu_torch.scene import Mesh, Scene
from openmvs_tpu_torch.utils.fmath import fma, rsqrt
from openmvs_tpu_torch.utils.log import get_logger, timed
from openmvs_tpu_torch.view_selection import select_views_for_scene

log = get_logger("refine")

# host re-rasterization cadence in device iterations (refine.py:1043 of the
# JAX package): the per-iteration trust-region cap keeps a fixed
# rasterization valid across 8 iterations
RERASTER = 8


# ------------------------------------------------------------------ geometry
def _project_np(cam, verts: np.ndarray) -> np.ndarray:
    Xc = (verts - cam.C) @ cam.R.T
    uv = Xc @ cam.K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        u = uv[:, 0] / np.maximum(uv[:, 2], 1e-12)
        v = uv[:, 1] / np.maximum(uv[:, 2], 1e-12)
    return np.stack([u, v, Xc[:, 2]], axis=-1)


def subdivide_to_area(mesh: Mesh, scene: Scene, max_area: float, max_rounds: int = 4) -> Mesh:
    """Midpoint-subdivide faces whose max projected area exceeds max_area px
    (SubdivideMesh role, SceneRefine.cpp:1291-1307)."""
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces.astype(np.int64)
    # geometric-outlier faces (edges far beyond the median, i.e. the junk
    # rim triangles every graph-cut reconstruction carries at the scene
    # border) are never subdivided: their midpoints would land far off the
    # surface and refinement cannot recover barely-observed geometry
    el = np.linalg.norm(v[f[:, 0]] - v[f[:, 1]], axis=1)
    med_el = float(np.median(el)) if len(el) else 0.0
    for _ in range(max_rounds):
        emax = np.maximum(
            np.linalg.norm(v[f[:, 0]] - v[f[:, 1]], axis=1),
            np.maximum(np.linalg.norm(v[f[:, 1]] - v[f[:, 2]], axis=1),
                       np.linalg.norm(v[f[:, 2]] - v[f[:, 0]], axis=1)))
        area = np.zeros(len(f))
        for img in scene.images:
            pr = _project_np(img.working_camera(), v)
            a = pr[f[:, 0], :2]
            b = pr[f[:, 1], :2]
            c = pr[f[:, 2], :2]
            ar = 0.5 * np.abs((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
                              - (c[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1]))
            z = pr[f].min(axis=1)[:, 2]
            ar[z <= 0] = 0
            area = np.maximum(area, ar)
        split = (area > max_area) & (emax <= 4.0 * med_el)
        if not split.any():
            break
        # CONFORMING midpoint subdivision (red-green): every edge of a
        # marked face gets a midpoint; unmarked faces sharing split edges
        # are bisected to match (1 split edge -> 2 faces, 2 -> 3), so no
        # T-vertices/cracks appear.  Cracks are not merely cosmetic here:
        # their half-edges are single-sided, so _vertex_boundary would flag
        # interior seam vertices as boundary and DISABLE smoothing exactly
        # where the photometric term is noisiest.
        edges: Dict[Tuple[int, int], int] = {}
        vlist: List[np.ndarray] = []
        nv0 = len(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edges:
                edges[key] = nv0 + len(vlist)
                vlist.append(0.5 * (v[a] + v[b]))
            return edges[key]

        for fi in np.nonzero(split)[0]:
            a, b, c = f[fi]
            midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces = []
        for fi in range(len(f)):
            a, b, c = f[fi]
            if split[fi]:
                ab = edges[(min(a, b), max(a, b))]
                bc = edges[(min(b, c), max(b, c))]
                ca = edges[(min(c, a), max(c, a))]
                new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                              (ab, bc, ca)]
                continue
            vs = (a, b, c)
            # ms[i] = midpoint of the edge OPPOSITE vs[i], if split
            ms = (edges.get((min(b, c), max(b, c))),
                  edges.get((min(c, a), max(c, a))),
                  edges.get((min(a, b), max(a, b))))
            k = sum(m is not None for m in ms)
            if k == 0:
                new_faces.append(vs)
            elif k == 3:
                new_faces += [(a, ms[2], ms[1]), (b, ms[0], ms[2]),
                              (c, ms[1], ms[0]), (ms[2], ms[0], ms[1])]
            elif k == 1:
                i = next(j for j in range(3) if ms[j] is not None)
                A, B, C = vs[i], vs[(i + 1) % 3], vs[(i + 2) % 3]
                m = ms[i]
                new_faces += [(A, B, m), (A, m, C)]
            else:  # k == 2: unsplit edge is opposite vs[i]
                i = next(j for j in range(3) if ms[j] is None)
                A, B, C = vs[i], vs[(i + 1) % 3], vs[(i + 2) % 3]
                mAB = ms[(i + 2) % 3]
                mCA = ms[(i + 1) % 3]
                new_faces += [(A, mAB, mCA), (mAB, B, C), (mAB, C, mCA)]
        if vlist:
            v = np.concatenate([v, np.asarray(vlist)], axis=0)
        f = np.asarray(new_faces, np.int64)
    return Mesh(vertices=v.astype(np.float32), faces=f.astype(np.int32))


def _vertex_adjacency(faces: np.ndarray, nv: int, max_deg: int = 12):
    """(nv, max_deg) padded one-ring vertex ids (-1 pad) + degree."""
    nbr = [[] for _ in range(nv)]
    for a, b, c in faces:
        for x, y in ((a, b), (b, c), (c, a)):
            if y not in nbr[x]:
                nbr[x].append(y)
            if x not in nbr[y]:
                nbr[y].append(x)
    out = np.full((nv, max_deg), -1, np.int32)
    deg = np.zeros(nv, np.int32)
    for i, ns in enumerate(nbr):
        m = min(len(ns), max_deg)
        out[i, :m] = ns[:m]
        deg[i] = m
    return out, deg


def _vertex_boundary(faces: np.ndarray, nv: int) -> np.ndarray:
    """(nv,) bool: vertices on an open mesh border (edges used by only one
    face) — excluded from smoothing like the reference's vertexBoundary
    (SceneRefine.cpp:968)."""
    boundary = np.zeros(nv, bool)
    if len(faces) == 0:
        return boundary
    _, uniq, inv = edges_of_faces(np.asarray(faces))
    border = uniq[np.bincount(inv) == 1]
    boundary[border.ravel()] = True
    return boundary


def _collapse_vertices(verts: np.ndarray, faces: np.ndarray,
                       adj: np.ndarray, deg: np.ndarray, kill: np.ndarray):
    """Remove `kill` vertices by collapsing each into its nearest surviving
    one-ring neighbor (Mesh::Decimate(vertexRemove) role).  Returns
    (new_faces reindexed, remap old->new with -1 removed) or (None, None)
    if nothing could be collapsed."""
    nv = len(verts)
    target = np.arange(nv)
    for v in np.nonzero(kill)[0]:
        ring = adj[v, : deg[v]]
        ring = ring[ring >= 0]
        ring = ring[~kill[ring]]
        if len(ring) == 0:
            continue
        d = np.linalg.norm(verts[ring] - verts[v], axis=1)
        target[v] = ring[np.argmin(d)]
    if (target == np.arange(nv)).all():
        return None, None
    f2 = target[faces]
    good = ((f2[:, 0] != f2[:, 1]) & (f2[:, 1] != f2[:, 2])
            & (f2[:, 0] != f2[:, 2]))
    f2 = f2[good]
    # multiple faces can collapse onto the same vertex triple; duplicated
    # faces would double-count half-edges and hide real open borders from
    # _vertex_boundary's single-use edge test — dedup on the sorted triple,
    # keeping the first occurrence (preserves orientation)
    key = np.sort(f2, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    f2 = f2[np.sort(first)]
    used = np.zeros(nv, bool)
    used[f2.reshape(-1)] = True
    remap = np.full(nv, -1, np.int64)
    remap[used] = np.arange(int(used.sum()))
    return remap[f2].astype(faces.dtype), remap


# ------------------------------------------------------------------ energy
# Every tensor of a PairData, PairStatic or PairRaster carries a leading
# pair axis P; the functions below also take any other leading shape.
class PairData(NamedTuple):
    """Per (reference view A, neighbor B) constants for one refresh."""

    imgA: torch.Tensor      # (P, H, W)
    imgB: torch.Tensor      # (P, Hb, Wb)
    face_vid: torch.Tensor  # (P, H, W, 3) vertex ids of the face under each pixel
    bary: torch.Tensor      # (P, H, W, 3)
    mask: torch.Tensor      # (P, H, W) valid surface pixels
    KA_R: torch.Tensor      # (P, 3, 3) K_A R_A
    KA_t: torch.Tensor      # (P, 3)
    KB_R: torch.Tensor
    KB_t: torch.Tensor
    sizeB: torch.Tensor     # (P, 2) valid (Hb, Wb) of imgB (imgB may be padded)
    CA: torch.Tensor        # (P, 3) camera-A center (world) for the grazing cull
    reg_scale: torch.Tensor  # (P,) avgDepthA*avgDepthB/(fA*fB): pixel-footprint
    #                          world area (the reference RegularizationScale,
    #                          SceneRefine.cpp:1169) converting per-pixel
    #                          gradient density into world units
    fid: Optional[torch.Tensor] = None  # (P, H, W) rasterized face id (-1 =
    #                          none).  When present, the gradient scatter
    #                          accumulates per FACE (one index per pixel,
    #                          10-wide rows), then pushes faces onto vertices


class PairStatic(NamedTuple):
    """Per-pair constants that never change within one scale (images,
    cameras): uploaded once per scale."""

    imgA: torch.Tensor      # (P, H, W)
    imgB: torch.Tensor      # (P, Hb, Wb)
    KA_R: torch.Tensor      # (P, 3, 3)
    KA_t: torch.Tensor      # (P, 3)
    KB_R: torch.Tensor
    KB_t: torch.Tensor
    sizeB: torch.Tensor     # (P, 2)
    CA: torch.Tensor        # (P, 3)


class PairRaster(NamedTuple):
    """Per-pair rasterization results (change when vertices move), uploaded
    per refresh: face id + 2 barycentrics; the device reconstructs
    face_vid = faces[fid], mask = fid >= 0, b2 = 1-b0-b1."""

    fid: torch.Tensor       # (P, H, W) int32, -1 = no surface
    bary2: torch.Tensor     # (P, H, W, 2) float32
    reg_scale: torch.Tensor  # (P,)


def _assemble_pair_data(statics: PairStatic, rasters: PairRaster,
                        faces: torch.Tensor) -> PairData:
    """Rebuild the stacked PairData on the device from the split upload."""
    fid = rasters.fid
    mask = fid >= 0
    face_vid = faces[torch.clamp(fid, min=0).long()]           # (P, H, W, 3)
    b01 = rasters.bary2
    bary = torch.cat(
        [b01, (1.0 - b01[..., 0] - b01[..., 1])[..., None]], dim=-1)
    return PairData(
        imgA=statics.imgA, imgB=statics.imgB, face_vid=face_vid, bary=bary,
        mask=mask, KA_R=statics.KA_R, KA_t=statics.KA_t, KB_R=statics.KB_R,
        KB_t=statics.KB_t, sizeB=statics.sizeB, CA=statics.CA,
        reg_scale=rasters.reg_scale, fid=fid)


def _px(x: torch.Tensor) -> torch.Tensor:
    """A per-pair value (leading axes only) broadcast over (H, W)."""
    return x[..., None, None]


def _corner_index(x0: torch.Tensor, hi: int) -> torch.Tensor:
    """floor(x) as a clipped int64 index in [0, hi]. Clamped in float before
    the conversion, which is undefined for huge or NaN floats in torch and
    saturates in XLA (a NaN lands on 0 either way)."""
    return torch.clamp(torch.nan_to_num(x0), 0, hi).long()


def _taps(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """The 4 bilinear taps of img (..., Hp, Wp) at (x, y) (..., H, W) and
    the fractional offsets."""
    Hp, Wp = img.shape[-2:]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx, fy = x - x0, y - y0
    xi = _corner_index(x0, Wp - 2)
    yi = _corner_index(y0, Hp - 2)
    flat = img.reshape(*img.shape[:-2], -1)
    idx = yi * Wp + xi

    def take(i):
        return torch.gather(flat, -1, i.reshape(*i.shape[:-2], -1)).reshape(i.shape)

    return take(idx), take(idx + 1), take(idx + Wp), take(idx + Wp + 1), fx, fy


def _bilinear(img, x, y):
    v00, v01, v10, v11, fx, fy = _taps(img, x, y)
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def _bilinear_g(img, x, y):
    """Bilinear sample + the EXACT spatial derivatives of the interpolant
    (same 4 taps): what autograd of _bilinear produces, to float
    precision. The multiply-adds are fused where XLA's CPU backend fuses
    them in the JAX package's jitted iteration (``utils/fmath.py``)."""
    v00, v01, v10, v11, fx, fy = _taps(img, x, y)
    ofx, ofy = 1 - fx, 1 - fy
    top = fma(v01, fx, v00 * ofx)
    bot = fma(v10, ofx, v11 * fx)
    v = fma(bot, fy, top * ofy)
    gx = fma(v11 - v10, fy, (v01 - v00) * ofy)
    gy = fma(v11 - v01, fx, (v10 - v00) * ofx)
    return v, gx, gy


def _dot3(a, b):
    """Sum over the last axis (3) of a * b, as XLA's fused reduction
    rounds it: fma(a2, b2, fma(a1, b1, a0 * b0))."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _norm3(a):
    return torch.sqrt(_dot3(a, a))


def _segment_sum(index: torch.Tensor, src: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) sums of the rows of ``src`` by ``index``, each from 0 in
    the order of the rows (as XLA's CPU scatter adds them): a stable sort
    of the rows, then one sequential sum per segment. The card's
    index_add_ races atomics, which would round differently from run to
    run and from the CPU. Rows whose index is ``n``, one past the last
    segment, are left out. The order and offsets come from
    ``segment.segments`` (no host read, so a CUDA graph holds them), the
    sums from ``segment.segment_sum``: the kernel on the card, its plain
    version on the CPU."""
    return segment.segment_sum(*segment.segments(index, n), src.contiguous())


def _sum_ring(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 (the one-ring slots), added in slot order."""
    out = x[:, 0]
    for k in range(1, x.shape[1]):
        out = out + x[:, k]
    return out


def _cross(a, b):
    """a x b with each component a_i b_j - a_j b_i as fma(a_i, b_j, -a_j b_i)."""
    return torch.stack([fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))
                        for i, j in ((1, 2), (2, 0), (0, 1))], dim=-1)


def _warp_coords(verts: torch.Tensor, pd: PairData):
    """A-pixel -> B-image coordinates through the surface, + validity.

    The 3-element contractions are elementwise float32 (no matmul, so no
    TF32), with the multiply-adds fused where XLA's CPU backend fuses them
    in the JAX package's jitted iteration: a last-ulp change of a warped
    coordinate flips pixels in and out of the valid mask."""
    P = verts[pd.face_vid]                   # (..., H, W, 3, 3)
    b = pd.bary
    X = fma(b[..., 2, None], P[..., 2, :],
            fma(b[..., 0, None], P[..., 0, :], b[..., 1, None] * P[..., 1, :]))
    R, t = pd.KB_R, pd.KB_t
    XB = [fma(_px(R[..., a, 2]), X[..., 2],
              fma(_px(R[..., a, 0]), X[..., 0], _px(R[..., a, 1]) * X[..., 1]))
          + _px(t[..., a]) for a in range(3)]
    zb = XB[2]
    ok = pd.mask & (zb > 1e-6)
    izb = torch.where(ok, 1.0 / torch.where(ok, zb, 1.0), 0.0)
    xb = XB[0] * izb
    yb = XB[1] * izb
    ok = (ok & (xb >= 1) & (xb <= _px(pd.sizeB[..., 1]) - 2)
          & (yb >= 1) & (yb <= _px(pd.sizeB[..., 0]) - 2))
    # grazing-angle cull (SceneRefine.cpp:926-929, orientation-agnostic):
    # pixels whose face is nearly edge-on to the A-ray carry an unstable
    # projection Jacobian and mostly gradient noise
    e1 = P[..., 1, :] - P[..., 0, :]
    e2 = P[..., 2, :] - P[..., 0, :]
    N = _cross(e1, e2)
    dA = X - pd.CA[..., None, None, :]
    nd = torch.abs(_dot3(N, dA))
    nrm = torch.sqrt(_dot3(N, N) * _dot3(dA, dA)) + 1e-20
    ok = ok & (nd > 0.1 * nrm)
    return xb, yb, izb, ok


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """clip(x, lo, hi) with JAX's derivative: 1 inside, 0 outside and one
    half at a tie with a bound (the derivative of maximum/minimum splits
    between equal operands), where torch.clamp passes it all. Ties occur:
    8 windows of the full-size 640x480 workload have a ZNCC of exactly 1."""
    w = torch.where((x > lo) & (x < hi), 1.0,
                    torch.where((x == lo) | (x == hi), 0.5, 0.0)).detach()
    # x * w + (clamp(x) - x * w) equals clamp(x) to the bit for these w
    return x * w + (torch.clamp(x, lo, hi) - x * w).detach()


def _prefix16(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis, added in order in float32."""
    out = x.clone()
    for k in range(1, x.shape[-1]):
        out[..., k].add_(out[..., k - 1])
    return out


def _suffix16(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums over the last axis, each added in increasing
    index order in float32."""
    out = x.clone()
    n = x.shape[-1]
    for d in range(1, n):
        out[..., :n - d].add_(x[..., d:])
    return out


def _scan(x: torch.Tensor, reverse: bool, base: int = 16) -> torch.Tensor:
    """Prefix (or, reversed, suffix) sums over the last axis, rounded as
    XLA's CPU backend rounds ``jnp.cumsum``: the axis is zero-padded to
    blocks of ``base``, each block scanned in order, the block totals
    scanned the same way (recursively), and each block offset by the
    totals before (after) it. torch.cumsum rounds otherwise (in float64 on
    the CPU, in parallel on the card), and the box variances' cancellation
    would amplify the difference into the gradient."""
    n = x.shape[-1]
    if n <= base:
        return _suffix16(x) if reverse else _prefix16(x)
    m = -(-n // base) * base
    blocks = torch.nn.functional.pad(x, (0, m - n)).reshape(*x.shape[:-1], m // base, base)
    if reverse:
        inner = _suffix16(blocks)
        outer = _scan(inner[..., 0], True, base)
        offset = torch.cat([outer[..., 1:], torch.zeros_like(outer[..., :1])], -1)
    else:
        inner = _prefix16(blocks)
        outer = _scan(inner[..., -1], False, base)
        offset = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]], -1)
    return (inner + offset[..., None]).reshape(*x.shape[:-1], m)[..., :n]


class _Box(torch.autograd.Function):
    """Box sums of half-width ``half`` over ``dim``, zero outside:
    out[i] = S[min(i+h+1, n)] - S[max(i-h, 0)] with S = [0, cumsum(x)].
    The gradient is the JAX package's transpose of that form, summed in its
    order: the index scatters (the clipped indices' runs added in index
    order), then the reversed cumsum; no atomics, so the card and the CPU
    round alike."""

    @staticmethod
    def forward(ctx, x, dim, half):
        ctx.dim, ctx.half = dim, half
        xt = x.movedim(dim, -1)
        n = xt.shape[-1]
        S = torch.nn.functional.pad(_scan(xt, False), (1, 0))
        ar = torch.arange(n, device=x.device)
        hi = torch.clamp(ar + half + 1, 0, n)
        lo = torch.clamp(ar - half, 0, n)
        return (S[..., hi] - S[..., lo]).movedim(-1, dim)

    @staticmethod
    def backward(ctx, g):
        h = ctx.half
        gt = g.movedim(ctx.dim, -1)
        n = gt.shape[-1]
        # dS[k] for k = 1..n at k - 1 (dS[0] meets the leading zero); hi
        # sends output i to k = i + h + 1, the last n - first of them to n
        first = max(0, n - h - 1)
        hi_part = torch.zeros_like(gt)
        hi_part[..., h:h + first] = gt[..., :first]
        run = gt[..., first]
        for i in range(first + 1, n):
            run = run + gt[..., i]
        hi_part[..., n - 1] = run
        # lo sends output i >= h + 1 to k = i - h (the others to k = 0)
        lo_part = torch.zeros_like(gt)
        if n - h - 1 > 0:
            lo_part[..., :n - h - 1] = -gt[..., h + 1:]
        dx = _scan(hi_part + lo_part, True)
        return dx.movedim(-1, ctx.dim), None, None


def _box(x: torch.Tensor, half: int) -> torch.Tensor:
    """(2*half+1)^2 box sums over the last two axes, zero outside."""
    return _Box.apply(_Box.apply(x, x.ndim - 2, half), x.ndim - 1, half)


def _box_zncc_energy(A: torch.Tensor, B: torch.Tensor, M: torch.Tensor,
                     half: int = 3) -> torch.Tensor:
    """1 - windowed ZNCC(A, B), mean over valid pixels, per leading index;
    (2*half+1)^2 box windows (ComputeLocalZNCC role,
    SceneRefine.cpp:161-164), by border-clipped prefix sums (the JAX
    package's default "cumsum" form)."""
    n = torch.clamp(_box(M, half), min=1.0)
    mA = _box(A * M, half) / n
    mB = _box(B * M, half) / n
    cAB = _box(A * B * M, half) / n - mA * mB
    vA = _box(A * A * M, half) / n - mA * mA
    vB = _box(B * B * M, half) / n - mB * mB
    ncc = cAB * rsqrt(torch.clamp(vA * vB, min=1e-12))
    # texture-reliability weight (SceneRefine.cpp:890-893): low-variance
    # (textureless) windows contribute ~zero score AND ~zero gradient,
    # instead of ZNCC noise; treated as a constant weight like the reference
    minv = torch.minimum(vA, vB).detach()
    rf = minv / (minv + 0.0015)
    score = torch.where(M > 0, rf * (1.0 - _clip(ncc, -1.0, 1.0)), 0.0)
    return (torch.sum(score, dim=(-2, -1))
            / torch.clamp(torch.sum(M, dim=(-2, -1)), min=1.0))


def _zncc_value_and_grad(A, B, M, half: int = 3):
    """(energies, d sum(energies) / dB): the gradient of each leading
    index's energy with respect to its own B, by autograd of the tail
    alone (what jax.value_and_grad(..., argnums=1) gives per pair)."""
    with torch.enable_grad():
        Bg = B.detach().requires_grad_(True)
        e = _box_zncc_energy(A, Bg, M, half)
        (gB,) = torch.autograd.grad(e.sum(), Bg)
    return e.detach(), gB


def _pair_energy(verts: torch.Tensor, pd: PairData, half: int = 3) -> torch.Tensor:
    """1 - ZNCC(A, B warped through the surface), averaged over valid
    pixels, per pair. Differentiable in ``verts`` end to end: the autograd
    reference of the hand-derived gradients."""
    xb, yb, _, ok = _warp_coords(verts, pd)
    warped = torch.where(ok, _bilinear(pd.imgB, xb, yb), 0.0)
    A = torch.where(pd.mask, pd.imgA, 0.0)
    return _box_zncc_energy(A, warped, ok.to(torch.float32), half)


def _pixel_grads(verts: torch.Tensor, pd: PairData, half: int = 3):
    """The per-pixel chain shared by both scatters: (energies, dE/dP_k per
    pixel and face corner k (..., H, W, 3, 3), valid mask). Autograd
    touches only the box-ZNCC tail; the bilinear derivative, the
    projective chain rule and the barycentric split are written out
    (ComputePhotometricGradient, SceneRefine.cpp:161-175)."""
    xb, yb, izb, ok = _warp_coords(verts, pd)
    v, gx, gy = _bilinear_g(pd.imgB, xb, yb)
    warped = torch.where(ok, v, 0.0)
    A = torch.where(pd.mask, pd.imgA, 0.0)
    e, gB = _zncc_value_and_grad(A, warped, ok.to(torch.float32), half)
    gB = torch.where(ok, gB, 0.0)
    # d(xb, yb)/dX for xb = (KB_R X + t)_x / z: (KB_R[0] - xb * KB_R[2]) / z
    dxb = gB * gx
    dyb = gB * gy
    R = pd.KB_R[..., None, None, :, :]                      # (..., 1, 1, 3, 3)
    dX = (dxb[..., None] * (R[..., 0, :] - xb[..., None] * R[..., 2, :])
          + dyb[..., None] * (R[..., 1, :] - yb[..., None] * R[..., 2, :])
          ) * izb[..., None]                                # (..., H, W, 3)
    # X = sum_k bary_k P_k  =>  dE/dP_k = bary_k * dE/dX
    contrib = pd.bary[..., None] * dX[..., None, :]         # (..., H, W, 3, 3)
    contrib = torch.where(ok[..., None, None], contrib, 0.0)
    return e, contrib, ok


def _pair_energy_grad_manual(verts: torch.Tensor, pd: PairData, half: int = 3):
    """Hand-derived (energy (P,), d energy/d vertices (P, nv, 3), vertex
    support (P, nv), valid pixel count (P,)) for stacked pairs, scattered
    per vertex: the reference and test path. Matches autograd of
    _pair_energy to float precision."""
    e, contrib, ok = _pixel_grads(verts, pd, half)
    Pn, nv = e.shape[0], verts.shape[0]
    base = torch.arange(Pn, device=verts.device)[:, None] * nv
    flat = (pd.face_vid.reshape(Pn, -1) + base).reshape(-1)
    g = _segment_sum(flat, contrib.reshape(-1, 3), Pn * nv)
    # per-vertex observation support: did any valid pixel of this pair touch
    # the vertex?  (the reference's per-pair _photoGradNorm>0 test,
    # SceneRefine.cpp:1174-1188, used to average gradients over pairs)
    touched = _segment_sum(
        flat, ok[..., None].expand(pd.face_vid.shape).reshape(-1).to(torch.float32),
        Pn * nv)
    sup = (touched.reshape(Pn, nv) > 0).to(torch.float32)
    n_valid = torch.sum(ok.to(torch.float32), dim=(-2, -1))
    return e, g.reshape(Pn, nv, 3), sup, n_valid


def _pair_face_acc(verts: torch.Tensor, pd: PairData, half: int = 3):
    """Per-pair (energy, per-pixel face rows (..., H*W, 10): the 9
    barycentric gradient contributions and the valid flag, their face
    indices (..., H*W; -1 where no face), n_valid): the chain of
    _pair_energy_grad_manual accumulated by RASTER FACE ID, one scatter
    index per pixel. A pixel with no face has ok False, so its row is
    +0.0."""
    e, contrib, ok = _pixel_grads(verts, pd, half)
    M = ok.to(torch.float32)
    row = torch.cat([contrib.reshape(*contrib.shape[:-2], 9), M[..., None]],
                    dim=-1)                                 # (..., H, W, 10)
    idx = pd.fid.long()
    return (e, row.reshape(*row.shape[:-3], -1, 10),
            idx.reshape(*idx.shape[:-2], -1), torch.sum(M, dim=(-2, -1)))


def _photo_face_sums(verts, pds, faces):
    """One set of stacked pairs' share of the photometric gradient:
    (energies (P,), the per-face sums (nf, 9) of the pairs' weighted
    barycentric contributions, per-vertex supporting-pair count (nv,))."""
    nf = faces.shape[0]
    nv = verts.shape[0]
    es, rows, idx, n_valids = _pair_face_acc(verts, pds)
    Pn = es.shape[0]
    pair = torch.arange(Pn, device=verts.device)[:, None]
    # the JAX package adds a faceless pixel's +0.0 row into face 0, where it
    # changes no bit (a sum that starts at +0.0 is never -0.0, and adding
    # +0.0 leaves any other value as it is); here it goes to the segment
    # past the last, which _segment_sum leaves out, so face 0's sum does
    # not run over the whole background
    seg = torch.where(idx >= 0, idx + pair * nf, Pn * nf)
    accs = _segment_sum(seg.reshape(-1), rows.reshape(-1, 10),
                        Pn * nf).reshape(Pn, nf, 10)
    w_pair = n_valids * pds.reg_scale                       # (P,)
    # the pair sum in pair order, each term's product fused into the add
    acc9 = accs[0, :, :9] * w_pair[0]                       # (nf, 9)
    for p in range(1, Pn):
        acc9 = fma(accs[p, :, :9], w_pair[p], acc9)
    # per-pair vertex support (photoGradNorm>0 role): a vertex is supported
    # by pair p iff any valid pixel rasterized one of its faces in p
    touched_f = (accs[..., 9] > 0).to(torch.float32)        # (P, nf)
    sup = _segment_sum((faces.reshape(1, -1) + pair * nv).reshape(-1),
                       touched_f.repeat_interleave(3, dim=1).reshape(-1), Pn * nv)
    n_sup = torch.sum((sup.reshape(Pn, nv) > 0).to(torch.float32), dim=0)
    return es, acc9, n_sup


def _pairs_grad_faces(verts, pds, faces):
    """All-pairs photometric (energies (P,), per-vertex gradient sum in
    world units, per-vertex supporting-pair count) via the per-face scatter
    path. Matches the per-vertex path up to float reduction order.
    ``pds`` may be a ``PairShards``: each shard sums its own pairs on its
    device, and the shards' sums add on ``verts``' device (the JAX
    package's GSPMD all-reduce over its sharded pair axis), so the pair sum
    runs in another order than one device's."""
    nf = faces.shape[0]
    nv = verts.shape[0]
    if isinstance(pds, PairShards):
        parts = [_photo_face_sums(to(verts, f.device), pd, f)
                 for pd, f in zip(pds.pds, pds.faces)]
        dev = verts.device
        es = torch.cat([to(p[0], dev) for p in parts])
        acc9 = psum([p[1] for p in parts], dev)
        n_sup = psum([p[2] for p in parts], dev)
    else:
        es, acc9, n_sup = _photo_face_sums(verts, pds, faces)
    g = _segment_sum(faces.reshape(-1), acc9.reshape(nf * 3, 3), nv)
    return es, g, n_sup


class PairShards(NamedTuple):
    """The pair axis split over devices: each shard's stacked PairData (the
    pairs padded with all-masked dummy pairs to equal shares) and the
    mesh's faces, on the shard's device."""

    pds: List[PairData]
    faces: List[torch.Tensor]


def _pad_split(nt, n_sh: int, fills=None) -> list:
    """A NamedTuple of numpy arrays stacked on a pair axis, padded to a
    multiple of ``n_sh`` pairs (each field with ``fills.get(name, 0)``)
    and split into ``n_sh`` contiguous shares."""
    fills = fills or {}
    P = len(nt[0])
    pad = (-P) % n_sh
    if pad:
        nt = type(nt)(*[np.concatenate([x, np.full((pad,) + x.shape[1:], fills.get(name, 0),
                                                   x.dtype)])
                        for name, x in zip(nt._fields, nt)])
    size = (P + pad) // n_sh
    return [type(nt)(*[x[s * size:(s + 1) * size] for x in nt]) for s in range(n_sh)]


def shard_pairs(pds: PairData, faces: torch.Tensor, devices) -> PairShards:
    """A PairData of numpy arrays (``fid`` given) as a PairShards over
    ``devices``: dummy pairs have face id -1 everywhere, so every pixel is
    masked and they add nothing."""
    parts = _pad_split(pds, len(devices), {"fid": -1})
    return PairShards([to_device(p, d) for p, d in zip(parts, devices)],
                      [to(faces, d) for d in devices])


# --------------------------------------------------------------- iteration
def _energy_grad(v, pds, adj, deg, faces, step0, med_edge, reg_w,
                 boundary=None, ratio=None):
    """(energy, descent direction) for one refinement iteration — the
    computation described in _device_iter's docstring. step0, med_edge,
    reg_w and ratio are float32 scalars (0-d tensors on v's device, as the
    JAX package passes them)."""
    nv = v.shape[0]
    if isinstance(pds, PairShards) or pds.fid is not None:
        es, g_sum, n_sup = _pairs_grad_faces(v, pds, faces)
        photo = g_sum / torch.clamp(n_sup, min=1.0)[:, None]
    else:
        es, gs_pairs, sups, n_valids = _pair_energy_grad_manual(v, pds)
        # world-unit per-pair gradients (mean-energy grad -> pixel sum ->
        # world area), then the reference's average over supporting pairs
        w_pair = (n_valids * pds.reg_scale)[:, None, None]
        n_sup = torch.sum(sups, dim=0)                      # (nv,)
        photo = (torch.sum(gs_pairs * w_pair, dim=0)
                 / torch.clamp(n_sup, min=1.0)[:, None])
    # area-weighted vertex normals; photometric movement along normals only
    fv = v[faces]                                           # (nf, 3, 3)
    fn = _cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    vn = _segment_sum(faces.reshape(-1), fn.repeat_interleave(3, dim=0), nv)
    vn = vn / (_norm3(vn)[:, None] + 1e-20)
    photo = _dot3(photo, vn)[:, None] * vn
    cap = 0.3 * med_edge / step0
    pn = _norm3(photo)[:, None]
    photo = photo * (cap / torch.maximum(pn, cap))
    bnd = boundary if boundary is not None else torch.zeros(
        nv, dtype=torch.bool, device=v.device)
    g1, g2, score = _smooth_grads_tworing(v, adj, deg, bnd)
    r = torch.as_tensor(0.9 if ratio is None else ratio, dtype=torch.float32,
                        device=v.device)
    g_reg = torch.where(r >= 1.0, reg_w * g2, reg_w * (r * g2 - (1.0 - r) * g1))
    # normalize the smoothness score by the REAL vertex count (degree > 0)
    nv_real = torch.clamp(torch.sum((deg > 0).to(torch.float32)), min=1.0)
    e = torch.sum(es) + reg_w * score / nv_real
    return e, photo + g_reg


def _decay(it: int) -> float:
    """0.98 ** it in float32, correctly rounded (the same on every device)."""
    return float(np.float32(np.float64(np.float32(0.98)) ** it))


def _device_iter(v, it, pds, adj, deg, faces, step0, med_edge,
                 reg_w, boundary=None, ratio=None):
    """ONE refinement iteration on v's device.

    The update mirrors the reference's plain decayed gradient descent
    (SceneRefine.cpp:1385-1411), NOT Adam (per-coordinate normalization
    lets weakly-observed vertices random-walk):
      photo[v] = mean over supporting pairs (photoGrad/photoGradNorm,
                 SceneRefine.cpp:644-654) of the pair's exact energy gradient
                 in WORLD units: mean-energy grad * n_valid_pixels *
                 reg_scale (pixel-footprint world area, the reference
                 RegularizationScale) — so gradients VANISH as the surface
                 converges;
      projected onto the vertex normal (the reference moves vertices along
                 normals only, N*sg, SceneRefine.cpp:944-951);
      capped    per vertex at 0.3*med_edge/step0 so one iteration never
                 moves a vertex more than a fraction of the local edge;
      reg      = elasticity*g2 - rigidity*g1 with elasticity=ratio*w,
                 rigidity=(1-ratio)*w (SceneRefine.cpp:642-656);
      v       -= 0.98^it * step0 * (photo + reg)   with step0 = the
                 reference gstep (0.5 at the default gradient_step=45.05).
    boundary/ratio default to no-boundary / 0.9 when not given."""
    e, g = _energy_grad(v, pds, adj, deg, faces, step0, med_edge,
                        reg_w, boundary, ratio)
    return v - (_decay(int(it)) * step0) * g, e


class IterProgram:
    """``_device_iter`` as a device program over static buffers: the
    counterpart of the JAX package's jitted iteration for one scale and
    mesh (``_refine_at_scale`` makes a new one when pruning changes the
    mesh). Eagerly an iteration is some 1,560 launches from Python; on a
    card the program captures it once as a CUDA graph (``graphs.Runner``:
    its lock, pool and stream) and each ``step`` is one replay.

    Buffers: the vertices ``v`` (a copy of the MeshTensors', updated in
    place, so replays chain with no host copy), the assembled PairData (the scale's
    statics as they are, the rasterization's fields copied in at each
    ``refresh``), ``ratio``, the energy ``e`` of the last step, and the
    decay: a Python float would be frozen into the capture, so the program
    reads ``_decay(k)`` from the table ``decays`` at the counter ``it``,
    which it advances. Every bit equals ``_device_iter``'s: the same
    functions on the same values (a one-shard ``PairShards`` adds nothing).

    The first step of a program runs its body eagerly (libraries initialise
    lazily on a first call, which a capture does not permit); on a card the
    second captures it and every later step replays it. On the CPU every
    step runs the body on the same buffers (the program's CPU form). A
    capture or replay that fails raises."""

    # PairData fields that a refresh changes; the rest are the statics'
    _RASTER_FIELDS = ("face_vid", "bary", "mask", "reg_scale", "fid")

    def __init__(self, runner, mt: MeshTensors, statics: PairStatic,
                 step0: torch.Tensor, med_edge: torch.Tensor, reg_w: torch.Tensor,
                 iters: int):
        dev = mt.verts.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.runner, self.mt, self.statics = runner, mt, statics
        self.v = mt.verts.clone()  # on the CPU mt.verts may be the caller's array
        self.step0, self.med_edge, self.reg_w = step0, med_edge, reg_w
        self.decays = torch.tensor([_decay(k) for k in range(iters)], **f32)
        self.it = torch.zeros(1, dtype=torch.int64, device=dev)
        self.ratio = torch.zeros((), **f32)
        self.e = torch.zeros((), **f32)
        self.pd: Optional[PairData] = None
        self.graph = None
        self.effects: list = []
        self.steps = 0

    def refresh(self, rasters: PairRaster, ratio: float, it: int) -> None:
        """Load a refresh's rasterization (tensors on the program's
        device), the regularizer's ratio and the next iteration's index."""
        pd = _assemble_pair_data(self.statics, rasters, self.mt.faces)
        if self.pd is None:
            self.pd = pd
        else:
            for f in self._RASTER_FIELDS:
                getattr(self.pd, f).copy_(getattr(pd, f))
        self.ratio.fill_(ratio)
        self.it.fill_(it)

    def _body(self) -> None:
        mt = self.mt
        e, g = _energy_grad(self.v, self.pd, mt.adj, mt.deg, mt.faces, self.step0,
                            self.med_edge, self.reg_w, mt.boundary, self.ratio)
        decay = self.decays.index_select(0, self.it).reshape(())
        self.v.copy_(self.v - (decay * self.step0) * g)
        self.e.copy_(e)
        self.it.add_(1)

    def step(self) -> None:
        """One iteration: ``v`` and ``e`` as ``_device_iter`` returns them."""
        if self.graph is None and self.steps > 0 and self.v.is_cuda:
            self.graph = self.runner.capture(self._body, self.effects)
        if self.graph is None:
            self._body()
        else:
            self.runner.replay(self.graph, self.effects)
        self.steps += 1


def _smooth_energy_grad_manual(verts: torch.Tensor, adj: torch.Tensor,
                               deg: torch.Tensor):
    """Hand-derived (energy, gradient) of _smooth_energy:
    E = mean_i ||(M v)_i - v_i||^2 with M the row-normalized one-ring
    average; dE/dv = 2/nv * (M^T r - r) with r = M v - v."""
    nv = verts.shape[0]
    w = (adj >= 0).to(torch.float32)
    safe = torch.clamp(adj, min=0).long()
    nb = verts[safe]
    mean = _sum_ring(nb * w[..., None]) / torch.clamp(deg[:, None], min=1.0)
    r = mean - verts
    e = torch.mean(torch.sum(r * r, dim=-1))
    rw = r / torch.clamp(deg[:, None], min=1.0)             # (nv, 3)
    contrib = rw[:, None, :].expand(*adj.shape, 3) * w[..., None]
    Mt_r = _segment_sum(safe.reshape(-1), contrib.reshape(-1, 3), nv)
    g = (2.0 / nv) * (Mt_r - r)
    return e, g


def _smooth_grads_tworing(verts, adj, deg, boundary):
    """Reference two-ring smoothing gradients (ComputeSmoothnessGradient1/2,
    SceneRefine.cpp:958-1012):
      g1[v] = mean(one-ring) - v                (umbrella Laplacian)
      g2[v] = (sum g1[nb]/N - g1[v]) / (1 + mean(1/deg[nb]))
    both zero at boundary vertices; returns (g1, g2, score=sum|g1|)."""
    w = (adj >= 0).to(torch.float32)
    interior = (~boundary) & (deg > 0)
    safe_adj = torch.clamp(adj, min=0).long()
    nb = verts[safe_adj]
    degf = torch.clamp(deg.to(torch.float32), min=1.0)
    mean = _sum_ring(nb * w[..., None]) / degf[:, None]
    g1 = torch.where(interior[:, None], mean - verts, 0.0)
    invdeg = torch.where(deg > 0, 1.0 / degf, 0.0)
    wsum = _sum_ring(invdeg[safe_adj] * w) / degf
    nrm = 1.0 / (1.0 + wsum)
    sum_g1 = _sum_ring(g1[safe_adj] * w[..., None])
    g2 = (sum_g1 / degf[:, None] - g1) * nrm[:, None]
    g2 = torch.where(interior[:, None], g2, 0.0)
    score = torch.sum(_norm3(g1))
    return g1, g2, score


def _smooth_energy(verts: torch.Tensor, adj: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Uniform-Laplacian rigidity: || mean(one-ring) - v ||^2 (the reference's
    two-ring rigidity/elasticity pair, SceneRefine.cpp:170-175, collapsed to
    its dominant first-order term)."""
    nb = verts[torch.clamp(adj, min=0).long()]              # (nv, D, 3)
    w = (adj >= 0).to(torch.float32)[..., None]
    lap = torch.sum(nb * w, dim=1) / torch.clamp(deg[:, None], min=1.0) - verts
    return torch.mean(torch.sum(lap * lap, dim=-1))


# ------------------------------------------------------------------ driver
def select_pairs(scene: Scene, opts: RefineOptions) -> List[Tuple[int, int]]:
    """(reference, neighbour) image-index pairs: each view with its
    best-scoring neighbour(s); alternative_pair (nAlternatePair): 0 both
    directions, 1 alternate by scale parity (both listed here), 2 only
    (i, j), 3 only (j, i) (SceneRefine.cpp:198). Without view scores, each
    view pairs with its nearest camera."""
    pairs: List[Tuple[int, int]] = []
    id_to_idx = {im.meta.id: i for i, im in enumerate(scene.images)}
    for i, img in enumerate(scene.images):
        for vs in img.meta.view_scores[: max(1, opts.max_views // 4)]:
            j = id_to_idx.get(vs.id)
            if j is not None and (i, j) not in pairs:
                if opts.alternative_pair == 3:
                    if (j, i) not in pairs:
                        pairs.append((j, i))
                    continue
                pairs.append((i, j))
                if opts.alternative_pair == 0 and (j, i) not in pairs:
                    pairs.append((j, i))
    if not pairs:
        # no sparse points to score views: pair by camera distance
        Cs = np.stack([im.camera.C for im in scene.images])
        for i in range(len(scene.images)):
            d = np.linalg.norm(Cs - Cs[i], axis=1)
            d[i] = np.inf
            pairs.append((i, int(np.argmin(d))))
    return pairs


def decode_step(gradient_step: float) -> float:
    """The GD step from gradient_step (SceneRefine.cpp:1355-1358): the
    fractional part scaled by 10 (45.05 -> 0.5)."""
    gs = float(gradient_step)
    step0 = (gs - int(gs)) * 10.0 if gs > 1 else (gs if gs > 0 else 0.5)
    if step0 == 0.0:
        # an integer gradient_step decodes to a zero GD step in the
        # reference too — but there it is a silent no-op; warn and use the
        # reference default step (SceneRefine.cpp:1355 gstep=0.4) instead
        log.warning(
            "gradient_step=%g has zero fractional part -> zero GD step; "
            "using default 0.4 (encode step in the fraction, e.g. 45.04)", gs)
        step0 = 0.4
    return step0


def scaled_views(scene: Scene, scale: float):
    """(gray images, cameras) of every view at ``scale`` of its working
    resolution (area-filtered)."""
    grays, cams = [], []
    for img in scene.images:
        g = img.gray
        if scale != 1.0:
            g = imio.resize_area(g, max(8, round(g.shape[1] * scale)),
                                 max(8, round(g.shape[0] * scale)))
        grays.append(np.asarray(g, np.float32))
        cams.append(img.working_camera().scaled(g.shape[1] / img.gray.shape[1])
                    if scale != 1.0 else img.working_camera())
    return grays, cams


def _pad2(x: np.ndarray, hw, fill=0) -> np.ndarray:
    """x padded (bottom/right, with ``fill``) to the (H, W) ``hw``: pairs
    stack at the largest image size of the scale."""
    if x.shape[:2] == tuple(hw):
        return x
    out = np.full(tuple(hw) + x.shape[2:], fill, x.dtype)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def _stack_hw(grays) -> Tuple[int, int]:
    return max(g.shape[0] for g in grays), max(g.shape[1] for g in grays)


def build_statics(pairs, grays, cams) -> PairStatic:
    """PairStatic of ``pairs`` as numpy arrays."""
    hw = _stack_hw(grays)
    cols = []
    for (a, b) in pairs:
        camA, camB = cams[a], cams[b]
        cols.append((
            _pad2(grays[a], hw), _pad2(grays[b], hw),
            (camA.K @ camA.R).astype(np.float32),
            (-(camA.K @ camA.R) @ camA.C).astype(np.float32),
            (camB.K @ camB.R).astype(np.float32),
            (-(camB.K @ camB.R) @ camB.C).astype(np.float32),
            np.asarray(grays[b].shape, np.float32),
            camA.C.astype(np.float32)))
    return PairStatic(*[np.stack([c[k] for c in cols])
                        for k in range(len(PairStatic._fields))])


def build_rasters(pairs, grays, cams, faces: np.ndarray, v_np: np.ndarray) -> PairRaster:
    """PairRaster of ``pairs`` for vertices ``v_np`` as numpy arrays: the
    mesh rasterized into each pair's reference view on the host."""
    hw = _stack_hw(grays)
    cols = []
    v64 = v_np.astype(np.float64)
    for (a, b) in pairs:
        camA, camB = cams[a], cams[b]
        H, W = grays[a].shape
        prA = _project_np(camA, v64)
        fid, _, bar = native.rasterize(prA, faces, H, W)
        # RegularizationScale (SceneRefine.cpp:1169): mean viewing depth of
        # the surface in each view over the focal lengths — the world area
        # of one pixel footprint
        zA = prA[:, 2]
        avgA = float(zA[zA > 0].mean()) if (zA > 0).any() else 1.0
        zB = _project_np(camB, v64)[:, 2]
        avgB = float(zB[zB > 0].mean()) if (zB > 0).any() else 1.0
        cols.append((
            _pad2(fid.astype(np.int32), hw, -1),
            _pad2(np.ascontiguousarray(bar[..., :2]).astype(np.float32), hw),
            np.float32(avgA * avgB / float(camA.K[0, 0] * camB.K[0, 0]))))
    return PairRaster(*[np.stack([c[k] for c in cols])
                        for k in range(len(PairRaster._fields))])


def to_device(nt, dev):
    """A NamedTuple of numpy arrays as one of tensors on ``dev``."""
    return type(nt)(*[torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in nt])


class MeshTensors(NamedTuple):
    """The mesh's device arrays for one topology."""

    verts: torch.Tensor     # (nv, 3) float32
    faces: torch.Tensor     # (nf, 3) int64
    adj: torch.Tensor       # (nv, 12) int64, -1 pad
    deg: torch.Tensor       # (nv,) float32
    boundary: torch.Tensor  # (nv,) bool


def mesh_tensors(verts, faces, adj, deg, boundary, dev) -> MeshTensors:
    return MeshTensors(
        torch.as_tensor(np.asarray(verts, np.float32), device=dev),
        torch.as_tensor(np.asarray(faces, np.int64), device=dev),
        torch.as_tensor(np.asarray(adj, np.int64), device=dev),
        torch.as_tensor(np.asarray(deg, np.float32), device=dev),
        torch.as_tensor(np.asarray(boundary, bool), device=dev))


def _refine_at_scale(scene, mesh: Mesh, pairs, scale: float,
                     opts: RefineOptions, dev: torch.device,
                     host_s: Dict[str, float], devices=None,
                     runner=None) -> Tuple[Mesh, int, int]:
    """Refine ``mesh`` at one scale; returns (mesh, iterations, refreshes)
    and adds the host seconds of each refresh's download, rasterization
    and upload to ``host_s``. With a ``runner`` (``graphs.Runner`` of
    ``dev``) the iterations run as an ``IterProgram``. Without one, they
    run eagerly, the pair axis split over ``devices`` (``[dev]`` by
    default; no more shards than pairs) as a ``PairShards``; the step is
    applied once, on ``dev``, and the vertices go to every shard at the
    next iteration."""
    grays, cams = scaled_views(scene, scale)
    mesh = subdivide_to_area(mesh, scene, float(opts.max_face_area) / max(scale, 1e-3))
    faces = mesh.faces
    nvr = len(mesh.vertices)
    adj, deg = _vertex_adjacency(faces, nvr)
    boundary_np = _vertex_boundary(faces, nvr)
    mt = mesh_tensors(mesh.vertices, faces, adj, deg, boundary_np, dev)
    v_d = mt.verts

    # median edge length: the trust-region unit (movement per iteration is
    # capped at a fraction of it, keeping the fixed rasterization valid)
    edge = mesh.vertices[faces[:, 0]] - mesh.vertices[faces[:, 1]]
    f32 = dict(dtype=torch.float32, device=dev)
    med = torch.tensor(float(np.median(np.linalg.norm(edge, axis=1))), **f32)
    step0 = torch.tensor(decode_step(opts.gradient_step), **f32)
    reg_w = torch.tensor(opts.regularity_weight, **f32)

    iters = max(4, int(opts.iters * (0.5 if scale < 1.0 else 1.0)))
    # iteration schedule (SceneRefine.cpp:1362-1370): the elastic-only
    # regularizer takes over after 70% of the iterations; planar-vertex
    # pruning runs periodically from 40% when planar_vertex_ratio > 0
    iter_stop = iters * 7 // 10
    iter_start = iters * 4 // 10 if opts.planar_vertex_ratio > 0 else 1 << 30
    # images/cameras never change within a scale: upload ONCE; each
    # refresh ships only fid + 2 barycentrics (+ scalars) per pair
    shard_devs = [dev] if runner is not None else list(devices or [dev])[:max(1, len(pairs))]
    statics = [to_device(p, d) for p, d in zip(
        _pad_split(build_statics(pairs, grays, cams), len(shard_devs)), shard_devs)]

    def program():
        return IterProgram(runner, mt, statics[0], step0, med, reg_w, iters)

    prog = program() if runner is not None else None
    refreshes = 0
    for it in range(0, iters, RERASTER):
        t0 = time.perf_counter()
        v_prev = v_d.cpu().numpy()[:nvr]
        t1 = time.perf_counter()
        rasters_np = build_rasters(pairs, grays, cams, faces, v_prev)
        t2 = time.perf_counter()
        ratio = opts.rigidity_elasticity_ratio if it <= iter_stop else 1.0
        if prog is not None:
            prog.refresh(to_device(rasters_np, dev), ratio, it)
        else:
            faces_s = [to(mt.faces, d) for d in shard_devs]
            pds = PairShards(
                [_assemble_pair_data(st, to_device(r, d), f) for st, r, d, f in zip(
                    statics, _pad_split(rasters_np, len(shard_devs), {"fid": -1}),
                    shard_devs, faces_s)], faces_s)
            ratio_it = torch.tensor(ratio, **f32)
        t3 = time.perf_counter()
        host_s["down"] += t1 - t0
        host_s["raster"] += t2 - t1
        host_s["up"] += t3 - t2
        refreshes += 1
        for k in range(it, min(it + RERASTER, iters)):
            if prog is not None:
                prog.step()
                v_d, e = prog.v, prog.e
            else:
                v_d, e = _device_iter(v_d, k, pds, mt.adj, mt.deg, mt.faces,
                                      step0, med, reg_w, mt.boundary, ratio_it)
        if it % 8 == 0:   # the loop's only sync besides the refresh download
            log.info("  iter %d: E=%.5f", it, float(e))
        if it >= iter_start and iters - it > 5:
            # planar-vertex pruning (SceneRefine.cpp:1377-1399): remove
            # interior vertices that barely moved AND sit on a flat
            # one-ring; threshold = viewing depth * planar_vertex_ratio.
            # Cadence deviation from the reference (documented): the
            # reference tests the single-iteration gradient norm every 3
            # iterations; we test once per refresh block, so the
            # accumulated displacement is normalized by the block length
            # to keep per-iteration units and comparable aggressiveness.
            v_now = v_d.cpu().numpy()[:nvr]
            blk = max(1, min(it + RERASTER, iters) - it)
            move = np.linalg.norm(v_now - v_prev, axis=1) / blk
            # visibility guard (the reference's vertexDepth < FLT_MAX
            # test, SceneRefine.cpp:1389-1392): only vertices actually
            # rasterized by some scoring pair may be pruned — unseen or
            # occluded flat vertices keep their geometry
            seen = np.zeros(nvr, bool)
            for fidm in rasters_np.fid:
                fids = np.unique(fidm[fidm >= 0])
                seen[faces[fids].reshape(-1)] = True
            wmask = (adj >= 0)
            nbm = v_now[np.maximum(adj, 0)]
            mean_nb = (nbm * wmask[..., None]).sum(1) / np.maximum(
                deg[:, None], 1)
            g1n = np.linalg.norm(mean_nb - v_now, axis=1)
            # running per-camera minimum: the broadcast form would
            # materialize an (n_cams, nv, 3) temporary
            min_d = np.full(len(v_now), np.inf)
            for c in cams:
                np.minimum(min_d, np.linalg.norm(v_now - c.C, axis=1),
                           out=min_d)
            th = min_d * opts.planar_vertex_ratio
            kill = ((~boundary_np) & seen & (move < th) & (g1n < th)
                    & (deg > 0))
            if kill.sum() > max(16, 0.002 * len(v_now)):
                keep_faces, remap = _collapse_vertices(
                    v_now, faces, adj, deg, kill)
                if keep_faces is not None:
                    log.info("  planar pruning: -%d vertices",
                             int(kill.sum()))
                    v_now = v_now[remap >= 0]
                    faces = keep_faces
                    nvr = len(v_now)
                    adj, deg = _vertex_adjacency(faces, nvr)
                    boundary_np = _vertex_boundary(faces, nvr)
                    mt = mesh_tensors(v_now, faces, adj, deg, boundary_np, dev)
                    v_d = mt.verts
                    if prog is not None:
                        prog = program()
    v_np = v_d.cpu().numpy()[:nvr]
    return Mesh(vertices=v_np.astype(np.float32), faces=faces), iters, refreshes


def condition_mesh(mesh: Mesh, opts: RefineOptions) -> Mesh:
    """The mesh refine_mesh starts from (openmvs_tpu/refine.py:719-741):
    ``clean_mesh`` with the decimation and hole closing when ``0 <
    decimate < 1``, then ``ensure_edge_size(2 * median edge, max_rounds=2)``
    under the tri-state of ``ensure_edge_size``. Host code."""
    decimating = 0 < opts.decimate < 1
    if decimating:
        mesh = mesh_ops.clean_mesh(
            mesh, decimate=opts.decimate,
            close_holes_size=opts.close_holes,
            remove_spurious_percent=0.0, do_remove_spikes=False,
            smooth_iters=0, last_clean=False)
    if (opts.ensure_edge_size == 1 and decimating) or opts.ensure_edge_size >= 2:
        e = mesh.vertices[mesh.faces[:, 0]] - mesh.vertices[mesh.faces[:, 1]]
        med = float(np.median(np.linalg.norm(e, axis=1)))
        # cap edges at ~2x the median (EnsureEdgeSize default policy)
        mesh = mesh_ops.ensure_edge_size(mesh, 2.0 * med, max_rounds=2)
    return mesh


def refine_mesh(scene: Scene, mesh: Optional[Mesh] = None,
                opts: RefineOptions = RefineOptions(), device="cuda",
                stats: Optional[dict] = None, devices=None,
                _eager: bool = False) -> Mesh:
    """Coarse-to-fine photometric refinement (Scene::RefineMesh role) on
    ``device`` ("cuda" by default; raises without a card). ``devices``
    (default ``[device]``): with more than one, the pair axis is split over
    them, the per-shard gradients add on ``device``, and the iterations run
    eagerly. On one device they run as an ``IterProgram`` (on a card, a CUDA
    graph replayed per iteration); ``_eager`` runs them one launch at a
    time instead, the reference the program equals to the bit.

    ``stats``, if given, receives the pair count, per scale its seconds,
    iterations, refreshes and mesh size, the host seconds of the
    refreshes' download, rasterization and upload (``host_s``), and the
    program's captures, their seconds, replays and pool bytes
    (``graphs``; zeros when eager)."""
    dev = resolve_device(device)
    devices = [resolve_device(d) for d in devices] if devices else [dev]
    runner = graphs.Runner(dev) if len(devices) == 1 and not _eager else None
    mesh = mesh if mesh is not None else scene.mesh
    if len(mesh.faces) == 0:
        raise ValueError("no mesh to refine")

    w0 = max(im.width for im in scene.images)
    h0 = max(im.height for im in scene.images)
    max_dim_full = imio.compute_max_resolution(
        w0, h0, opts.resolution_level, opts.min_resolution, 1 << 30)
    for img in scene.images:
        if img.gray is None:
            img.load(max_dim=max_dim_full)
    if not scene.images[0].meta.view_scores:
        select_views_for_scene(scene, DenseOptions())

    # pre-refinement mesh conditioning (MeshRefine::SubdivideMesh,
    # SceneRefine.cpp:480-556): decimation + hole closing only when a
    # decimation was requested; ensure_edge_size follows the reference's
    # tri-state (0 disabled, 1 AUTO = only alongside a decimation, 2 force,
    # RefineMesh.cpp:126 + SceneRefine.cpp:552).  Running the remesher
    # unconditionally is actively harmful: it also densifies the junk
    # long-edge rim faces every real reconstruction carries, multiplying
    # off-surface vertices before refinement even starts.
    mesh = condition_mesh(mesh, opts)

    pairs = select_pairs(scene, opts)
    log.info("refining with %d pairs", len(pairs))
    host_s = {"down": 0.0, "raster": 0.0, "up": 0.0}
    per_scale = []
    cur = mesh
    for si in range(opts.scales):
        scale = opts.scale_step ** (opts.scales - 1 - si)
        # alternate mode (nAlternatePair=1, SceneRefine.cpp:597-600): the
        # pair direction flips with the outer iteration parity — here the
        # scale index plays the reference's iteration role
        sp = pairs
        if opts.alternative_pair == 1 and si % 2 == 1:
            sp = [(j, i) for (i, j) in pairs]
        t0 = time.perf_counter()
        with timed(log, f"scale {scale:.2f}"):
            cur, iters, refreshes = _refine_at_scale(scene, cur, sp, scale,
                                                     opts, dev, host_s, devices, runner)
        per_scale.append({"scale": scale, "seconds": time.perf_counter() - t0,
                          "iters": iters, "refreshes": refreshes,
                          "vertices": len(cur.vertices), "faces": len(cur.faces)})
    if stats is not None:
        stats.update(pairs=len(pairs), scales=per_scale, host_s=host_s, graphs={
            "captures": runner.captures if runner else 0,
            "capture_s": runner.capture_s if runner else 0.0,
            "replays": runner.replays if runner else 0,
            "pool_bytes": runner.pool_bytes() if runner else 0})
    return cur
