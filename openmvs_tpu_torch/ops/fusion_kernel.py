"""Depth-map fusion on the card: the wrapper of the hand-written kernels of
``csrc/fuse_views.cu`` and their plain PyTorch twin.

``densify.dense_reconstruction`` hands the maps a card estimated to
``fuse_views``, which fuses them there into the cloud that
``ops/fusion.fuse_depth_maps`` gives on the host, bit for bit and in the
same order: points, colours, normals, and each point's views and weights.
The job's maps go up once (span ``fuse.upload``); per reference view, in
the host's order of views, one claim and one count launch (span
``fuse.neighbours``), the keep launch (``fuse.keep``) and the emit launch
(``fuse.emit``), counter ``fuse.card_views``; the fused arrays come down
once (``fuse.download``) and the per-point lists are cut from them on the
host (``fuse.emit``).

A candidate is a valid, unowned pixel of the reference view and its index
is its linear pixel index, so a claim layer's least index is the host's
first agreeing candidate in scan order. The float64 steps follow the host's
order of operations: each 3x3 product the BLAS's chain (``filter_kernel.
blas_fuses``), the normals' dot and the normals' norm in the order NumPy
sums three terms (``sum_orders``).

``claim``, ``count_views``, ``keep``, ``emit`` and ``clear`` launch their
kernels on CUDA tensors (each launch adds one to ``LAUNCHES``) and run the
plain version, ``claim_plain`` ... ``emit_plain``, on CPU tensors:
``fuse_views(..., device="cpu")`` is the twin the tests hold against the
host fusion, and the kernels against it. No step falls back: a library that
fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.ops import _build
from openmvs_tpu_torch.ops.filter_kernel import _chain, _check, _stream, blas_fuses, fma64
from openmvs_tpu_torch.scene import PointCloud
from openmvs_tpu_torch.utils.log import count, span

LAUNCHES = {"fuse_claim": 0, "fuse_count": 0, "fuse_keep": 0, "fuse_emit": 0, "fuse_clear": 0}
EMPTY = 0x7F7F7F7F  # an unclaimed texel: every byte 0x7f
FREE, CONSUMED = -1, -2
MAX_NB = _build.MAX_VIEWS
THREADS = 256  # the kernels' block: block_sums has one row a block
CAM, META = 30, 6
# mode bits (csrc/fuse_views.cu)
FUSED, DOT_SHIFT, NORM_SHIFT, EST_COLOR, EST_NORMAL = 1, 1, 3, 32, 64


def _sum3(a, b, c, order: int):
    if order == 1:
        return a + (b + c)
    if order == 2:
        return (a + c) + b
    return (a + b) + c


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float64 square root, as NumPy's and CUDA's:
    PyTorch's CPU loop is off by an ulp on some inputs."""
    if t.device.type == "cpu":
        return torch.from_numpy(np.sqrt(t.numpy()))
    return torch.sqrt(t)


@functools.lru_cache(maxsize=None)
def sum_orders() -> Tuple[int, int]:
    """(dot, norm): the orders in which this NumPy sums three terms in
    ``np.einsum("ij,ij->i")`` and in ``np.linalg.norm(axis=-1)``: 0 (a + b)
    + c, 1 a + (b + c), 2 (a + c) + b; the dot's 3 fuses the third product
    into the first (a SIMD loop of two lanes with FMA). Each is the one
    order that gives NumPy's sums on vectors whose sums every order rounds
    differently; none raises."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4096, 3)) * 10.0 ** rng.integers(-3, 4, (4096, 3))
    b = rng.standard_normal((4096, 3)) * 10.0 ** rng.integers(-3, 4, (4096, 3))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    p = ta * tb
    dots = {k: _sum3(p[:, 0], p[:, 1], p[:, 2], k) for k in range(3)}
    dots[3] = _fma_dot(ta, tb)
    want = torch.from_numpy(np.einsum("ij,ij->i", a, b))
    dot = [k for k, v in dots.items() if torch.equal(v, want)]
    s = ta * ta
    want = torch.from_numpy(np.linalg.norm(a, axis=-1))
    norm = [k for k in range(3) if torch.equal(_sqrt(_sum3(s[:, 0], s[:, 1], s[:, 2], k)),
                                               want)]
    if len(dot) != 1 or len(norm) != 1:
        raise RuntimeError(f"NumPy sums three terms in no order the fusion kernels know "
                           f"(einsum {dot}, norm {norm})")
    return dot[0], norm[0]


def _fma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fma64(a[..., 2], b[..., 2], a[..., 0] * b[..., 0]) + a[..., 1] * b[..., 1]


def _modes(estimate_color: bool, estimate_normal: bool) -> int:
    dot, norm = sum_orders()
    return (int(blas_fuses()) | dot << DOT_SHIFT | norm << NORM_SHIFT
            | (EST_COLOR if estimate_color else 0) | (EST_NORMAL if estimate_normal else 0))


# ------------------------------------------------------------------ the job


@dataclasses.dataclass
class _View:
    """One view's place in the flat maps and its cameras (float64, the
    kernel's ``CAM`` order: K^-1, R, C, K)."""

    image_id: int
    off: int
    h: int
    w: int
    has_normal: bool
    has_color: bool
    cam: List[float]


@dataclasses.dataclass
class _Job:
    """Every buffer of a fusion call, on one device."""

    views: List[_View]
    depth: torch.Tensor    # (px,) float32, invalidated in place
    conf: torch.Tensor     # (px,) float32
    normal: torch.Tensor   # (px, 3) float32 (one row where no view has normals)
    colour: torch.Tensor   # (px, 3) uint8 (one row where no view has colours)
    owner: torch.Tensor    # (px,) int32
    cams: torch.Tensor     # (views, CAM) float64
    meta: torch.Tensor     # (views, META) int64
    sel: torch.Tensor      # (views, 1 + MAX_NB) int32: a reference's slot, its neighbours'
    claims: torch.Tensor   # (most neighbours of a view * stride,) int32
    stride: int
    flags: torch.Tensor    # (stride,) int32
    pidx: torch.Tensor     # (stride,) int32
    moff: torch.Tensor     # (stride,) int32
    block_sums: torch.Tensor  # (blocks, 2) int32
    block_base: torch.Tensor  # (blocks, 2) int64
    totals: torch.Tensor   # (2,) int64: points and members so far
    points: torch.Tensor   # (px, 3) float32
    colours: torch.Tensor  # (px, 3) uint8
    normals: torch.Tensor  # (px, 3) float32
    counts: torch.Tensor   # (px,) int32
    member_views: torch.Tensor    # (members,) int32 (uint32 bits)
    member_weights: torch.Tensor  # (members,) float32
    thr: float
    cos_err: float
    floor: float
    n_min: int
    modes: int

    @property
    def plain(self) -> bool:
        return self.depth.device.type == "cpu"

    def maps(self):
        return (ctypes.c_ulonglong * 5)(self.depth.data_ptr(), self.conf.data_ptr(),
                                         self.normal.data_ptr(), self.colour.data_ptr(),
                                         self.owner.data_ptr())

    def tables(self, ref: int, n_nb: int, hw: int):
        return (ctypes.c_void_p(self.cams.data_ptr()), ctypes.c_void_p(self.meta.data_ptr()),
                ctypes.c_void_p(self.sel[ref].data_ptr()), n_nb, hw)


def _flat(arrays: Sequence[Optional[np.ndarray]], sizes: Sequence[int], dtype, width: int
          ) -> np.ndarray:
    """The arrays one after another, zeros for the absent ones."""
    parts = [np.zeros(n * width, dtype) if a is None
             else np.ravel(np.ascontiguousarray(a, dtype)) for a, n in zip(arrays, sizes)]
    return np.concatenate(parts) if parts else np.zeros(0, dtype)


def _upload(views, order_nbs, opts: DenseOptions, modes: int, dev: torch.device) -> _Job:
    """Every map on ``dev`` once: depth and confidence in one copy, then
    normals and colours; the views' tables; the work and output buffers."""
    sizes = [v.depth.size for v in views]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    px = int(offs[-1])
    if px >= 1 << 31:
        raise ValueError(f"{px} map pixels: point indices hold 2**31")
    for v in views:
        if v.depth.dtype != np.float32 or (v.conf is not None and v.conf.dtype != np.float32):
            raise TypeError(f"view {v.image_id}: float32 depth and confidence expected")
        if v.normal is not None and (v.normal.dtype != np.float32
                                     or v.normal.shape != v.depth.shape + (3,)):
            raise TypeError(f"view {v.image_id}: (h, w, 3) float32 normals expected")
        if v.color is not None and (v.color.dtype != np.uint8
                                    or v.color.shape != v.depth.shape + (3,)):
            raise TypeError(f"view {v.image_id}: (h, w, 3) uint8 colours expected")
    dc = torch.from_numpy(np.concatenate([
        _flat([v.depth for v in views], sizes, np.float32, 1),
        _flat([v.conf if v.conf is not None else np.ones_like(v.depth) for v in views],
              sizes, np.float32, 1)])).to(dev)
    any_n = any(v.normal is not None for v in views)
    any_c = any(v.color is not None for v in views)
    normal = torch.from_numpy(_flat([v.normal for v in views], sizes, np.float32, 3)
                              if any_n else np.zeros(3, np.float32)).to(dev).view(-1, 3)
    colour = torch.from_numpy(_flat([v.color for v in views], sizes, np.uint8, 3)
                              if any_c else np.zeros(3, np.uint8)).to(dev).view(-1, 3)
    vs = []
    for s, v in enumerate(views):
        cam = np.concatenate([np.linalg.inv(v.camera.K).ravel(), v.camera.R.ravel(),
                              v.camera.C, v.camera.K.ravel()]).astype(np.float64)
        # the id's uint32 bits as the int32 the member buffer holds
        vid = int(np.array(int(v.image_id) & 0xFFFFFFFF, np.uint32).view(np.int32))
        vs.append(_View(vid, int(offs[s]), v.depth.shape[0], v.depth.shape[1],
                        v.normal is not None, v.color is not None, [float(c) for c in cam]))
    meta = np.array([[x.off, x.h, x.w, x.has_normal, x.has_color, x.image_id]
                     for x in vs], np.int64).reshape(-1, META)
    sel = np.zeros((len(views), 1 + MAX_NB), np.int32)
    for s, nbs in enumerate(order_nbs):
        sel[s, 0] = s
        sel[s, 1:1 + len(nbs)] = nbs
    stride = max(sizes)
    # each (view, pixel) is a member of at most one kept point, except that a
    # neighbour listed twice adds its winners twice
    members = px + sum(sizes[s] * (len(nbs) - len(set(nbs))) for s, nbs in enumerate(order_nbs))
    if members >= 1 << 31:
        raise ValueError(f"{members} members: offsets hold 2**31")
    blocks = -(-stride // THREADS)
    i32 = dict(dtype=torch.int32, device=dev)
    return _Job(
        views=vs, depth=dc[:px], conf=dc[px:], normal=normal, colour=colour,
        owner=torch.full((px,), FREE, **i32),
        cams=torch.from_numpy(np.array([x.cam for x in vs], np.float64).reshape(-1, CAM)).to(dev),
        meta=torch.from_numpy(meta).to(dev), sel=torch.from_numpy(sel).to(dev),
        claims=torch.full((max(map(len, order_nbs)) * stride,), EMPTY, **i32), stride=stride,
        flags=torch.zeros(stride, **i32), pidx=torch.zeros(stride, **i32),
        moff=torch.zeros(stride, **i32), block_sums=torch.zeros((blocks, 2), **i32),
        block_base=torch.zeros((blocks, 2), dtype=torch.int64, device=dev),
        totals=torch.zeros(2, dtype=torch.int64, device=dev),
        points=torch.empty((px, 3), dtype=torch.float32, device=dev),
        colours=torch.empty((px, 3), dtype=torch.uint8, device=dev),
        normals=torch.empty((px, 3), dtype=torch.float32, device=dev),
        counts=torch.empty(px, **i32),
        member_views=torch.empty(members, **i32),
        member_weights=torch.empty(members, dtype=torch.float32, device=dev),
        thr=float(opts.depth_diff_threshold),
        cos_err=float(np.cos(np.radians(opts.normal_diff_threshold))),
        floor=float(np.float32(getattr(opts, "fuse_conf_weight_floor", 0.09))),
        n_min=int(opts.min_views_fuse), modes=modes)


# ------------------------------------------------------------------ the twin


def _row_t(v, m, j, madd):  # (v @ M.T)[j]
    return madd(v[2], m[j * 3 + 2], madd(v[1], m[j * 3 + 1], v[0] * m[j * 3]))


def _col(v, m, j, madd):  # (v @ M)[j]
    return madd(v[2], m[6 + j], madd(v[1], m[3 + j], v[0] * m[j]))


def _unproject(v: _View, u, y, d, madd):
    """Camera.unproject of pixels (u, y) at depths d: three float64 tensors."""
    kinv, r, c = v.cam[0:9], v.cam[9:18], v.cam[18:21]
    uv1 = (u, y, torch.ones_like(d))
    cam = [_row_t(uv1, kinv, j, madd) * d for j in range(3)]
    return [_col(cam, r, j, madd) + c[j] for j in range(3)]


def _project(v: _View, X, madd):
    """(z, inside, x, y, lin) of world points X in view v, as the kernel's
    ``project``."""
    r, c, k = v.cam[9:18], v.cam[18:21], v.cam[21:30]
    t = [X[j] - c[j] for j in range(3)]
    xc = [_row_t(t, r, j, madd) for j in range(3)]
    p = [_row_t(xc, k, j, madd) for j in range(3)]
    z = p[2]
    front = z > 0
    rx = torch.round(torch.where(front, p[0] / z, -1.0))
    ry = torch.round(torch.where(front, p[1] / z, -1.0))
    inside = front & (rx >= 0) & (rx < v.w) & (ry >= 0) & (ry < v.h)

    def clip(a, n):
        ok = (a >= 0) & (a < 2.0 ** 63)
        return torch.where(ok, a.clamp(max=n - 1), 0.0).long()

    x, y = clip(rx, v.w), clip(ry, v.h)
    return z, inside, x, y, y * v.w + x


def _normal(v: _View, lin, madd, normal: torch.Tensor):
    """World normals of view v's pixels lin: normal @ R, or -R[2]."""
    r = v.cam[9:18]
    if v.has_normal:
        n = normal[v.off + lin].double()
        return [_col((n[:, 0], n[:, 1], n[:, 2]), r, j, madd) for j in range(3)]
    return [torch.full(lin.shape, -r[6 + j], dtype=torch.float64, device=lin.device)
            for j in range(3)]


def _weight(conf: torch.Tensor, d: torch.Tensor, floor: float) -> torch.Tensor:
    """conf2weight: float32 1 - conf and floor, float64 products."""
    m = torch.maximum(1.0 - conf, torch.tensor(floor, dtype=torch.float32, device=conf.device))
    den = m.double() * d * d
    return torch.where(den > 0, 1.0 / torch.where(den > 0, den, 1.0), 0.0)


def _dot(a, b, order: int):
    if order == 3:
        return _fma_dot(torch.stack(a, -1), torch.stack(b, -1))
    return _sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2], order)


def _candidates(job: _Job, r: _View, madd):
    """The reference's candidate pixels (ascending) and their world points."""
    hw = r.h * r.w
    d = job.depth[r.off:r.off + hw]
    idx = torch.nonzero((d > 0) & (job.owner[r.off:r.off + hw] == FREE)).squeeze(1)
    X = _unproject(r, (idx % r.w).double(), (idx // r.w).double(), d[idx].double(), madd)
    return idx, X


def _refs(job: _Job, ref: int, n_nb: int):
    s = job.sel[ref].tolist()
    return job.views[s[0]], [job.views[n] for n in s[1:1 + n_nb]]


def claim_plain(job: _Job, ref: int, n_nb: int) -> None:
    """``fuse_claim_kernel`` in plain PyTorch: each neighbour texel's least
    agreeing candidate in the claim layers."""
    madd = _chain(job.modes & FUSED)
    r, nbs = _refs(job, ref, n_nb)
    idx, X = _candidates(job, r, madd)
    nw = _normal(r, idx, madd, job.normal)
    for j, nb in enumerate(nbs):
        z, inside, x, y, lin = _project(nb, X, madd)
        q = nb.off + lin
        db = job.depth[q]
        has = inside & (db > 0) & (job.owner[q] == FREE)
        similar = has & ((z - db.double()).abs() < job.thr * z)
        nn = _normal(nb, lin, madd, job.normal)
        agree = similar & (_dot(nw, nn, (job.modes >> DOT_SHIFT) & 3) > job.cos_err)
        layer = job.claims[j * job.stride:(j + 1) * job.stride]
        layer.scatter_reduce_(0, lin[agree], idx[agree].int(), "amin")


def _won(job: _Job, nbs, X, idx, madd):
    """Per neighbour: (inside and won by the candidate, the claim word, its
    projection)."""
    out = []
    for j, nb in enumerate(nbs):
        z, inside, x, y, lin = _project(nb, X, madd)
        c = job.claims[j * job.stride + lin]
        out.append((inside & (c == idx), c, (z, inside, x, y, lin)))
    return out


def count_plain(job: _Job, ref: int, n_nb: int) -> None:
    """``fuse_count_kernel`` in plain PyTorch: ``flags`` the views of each
    kept candidate, 0 elsewhere (the block sums are the kernel's alone)."""
    madd = _chain(job.modes & FUSED)
    r, nbs = _refs(job, ref, n_nb)
    idx, X = _candidates(job, r, madd)
    n = torch.ones(len(idx), dtype=torch.int32, device=idx.device)
    for won, _, _ in _won(job, nbs, X, idx, madd):
        n += won
    job.flags.zero_()
    job.flags[idx] = torch.where(n >= job.n_min, n, 0)


def keep_plain(job: _Job, ref: int, n_nb: int) -> None:
    """``fuse_carry_kernel`` and ``fuse_keep_kernel`` in plain PyTorch:
    point indices and member offsets from the totals, ownership, the
    invalidated conflicts."""
    madd = _chain(job.modes & FUSED)
    r, nbs = _refs(job, ref, n_nb)
    hw = r.h * r.w
    flags = job.flags[:hw].long()
    kept = (flags > 0).long()
    pidx = torch.cumsum(kept, 0) - kept + job.totals[0]
    moff = torch.cumsum(flags, 0) - flags + job.totals[1]
    job.totals += torch.stack([kept.sum(), flags.sum()])
    job.pidx[:hw] = torch.where(kept > 0, pidx, 0).int()
    job.moff[:hw] = torch.where(kept > 0, moff, 0).int()
    idx, X = _candidates(job, r, madd)
    keep = flags[idx] > 0
    job.owner[r.off + idx] = torch.where(keep, pidx[idx], CONSUMED).int()
    for nb, (won, c, (z, inside, _, _, lin)) in zip(nbs, _won(job, nbs, X, idx, madd)):
        q = nb.off + lin
        win = won & keep
        job.owner[q[win]] = pidx[idx[win]].int()
        db = job.depth[q]
        conflict = (inside & keep & (c == EMPTY) & (db > 0) & (job.owner[q] == FREE)
                    & (z < db.double()))
        job.depth[q[conflict]] = 0.0


def emit_plain(job: _Job, ref: int, n_nb: int) -> None:
    """``fuse_emit_kernel`` in plain PyTorch: each kept candidate's point,
    colour, normal, member count and members."""
    madd = _chain(job.modes & FUSED)
    r, nbs = _refs(job, ref, n_nb)
    hw = r.h * r.w
    idx = torch.nonzero(job.flags[:hw] > 0).squeeze(1)
    pt, mo = job.pidx[idx].long(), job.moff[idx].long()
    d = job.depth[r.off + idx].double()
    w = _weight(job.conf[r.off + idx], d, job.floor)
    X = _unproject(r, (idx % r.w).double(), (idx // r.w).double(), d, madd)
    nw = _normal(r, idx, madd, job.normal)
    ax = [X[k] * w for k in range(3)]
    an = [nw[k] * w for k in range(3)]
    aw = w
    est_color = bool(job.modes & EST_COLOR)
    if est_color and r.has_color:
        col = job.colour[r.off + idx].double()
        ac = [col[:, k] * w for k in range(3)]
    else:
        ac = [torch.zeros_like(w) for _ in range(3)]
    job.member_views[mo] = r.image_id
    job.member_weights[mo] = w.float()
    n = torch.ones(len(idx), dtype=torch.int64, device=idx.device)
    for nb, (won, _, (_, _, x, y, lin)) in zip(nbs, _won(job, nbs, X, idx, madd)):
        sel = torch.nonzero(won).squeeze(1)
        q = nb.off + lin[sel]
        db = job.depth[q].double()
        wb = _weight(job.conf[q], db, job.floor)
        Xb = _unproject(nb, x[sel].double(), y[sel].double(), db, madd)
        nn = _normal(nb, lin[sel], madd, job.normal)
        for k in range(3):
            ax[k] = ax[k].index_add(0, sel, Xb[k] * wb)
            an[k] = an[k].index_add(0, sel, nn[k] * wb)
        aw = aw.index_add(0, sel, wb)
        if est_color and nb.has_color:
            col = job.colour[q].double()
            for k in range(3):
                ac[k] = ac[k].index_add(0, sel, col[:, k] * wb)
        slot = mo[sel] + n[sel]
        job.member_views[slot] = nb.image_id
        job.member_weights[slot] = wb.float()
        n[sel] += 1
    job.counts[pt] = n.int()
    inv = 1.0 / aw
    job.points[pt] = torch.stack([(ax[k] * inv).float() for k in range(3)], -1)
    if est_color:
        job.colours[pt] = torch.stack([(ac[k] * inv).clamp(0, 255).to(torch.uint8)
                                       for k in range(3)], -1)
    if job.modes & EST_NORMAL:
        s = _sqrt(_sum3(an[0] * an[0], an[1] * an[1], an[2] * an[2],
                             (job.modes >> NORM_SHIFT) & 3))
        den = torch.where((s > 1e-12) | torch.isnan(s), s, 1e-12)
        job.normals[pt] = torch.stack([(an[k] / den).float() for k in range(3)], -1)


# --------------------------------------------------------------- the wrapper


def _lib():
    return _build.library("fuse_views")


def claim(job: _Job, ref: int, n_nb: int, hw: int) -> None:
    if job.plain:
        claim_plain(job, ref, n_nb)
        return
    with torch.cuda.device(job.depth.device):
        rc = _lib().fuse_claim_launch(
            job.maps(), *job.tables(ref, n_nb, hw), ctypes.c_void_p(job.claims.data_ptr()),
            job.stride, job.thr, job.cos_err, job.modes, _stream(job.depth))
    _check(rc, "fuse_claim_launch")
    LAUNCHES["fuse_claim"] += 1


def count_views(job: _Job, ref: int, n_nb: int, hw: int) -> None:
    if job.plain:
        count_plain(job, ref, n_nb)
        return
    with torch.cuda.device(job.depth.device):
        rc = _lib().fuse_count_launch(
            job.maps(), *job.tables(ref, n_nb, hw), ctypes.c_void_p(job.claims.data_ptr()),
            job.stride, job.n_min, job.modes, ctypes.c_void_p(job.flags.data_ptr()),
            ctypes.c_void_p(job.block_sums.data_ptr()), _stream(job.depth))
    _check(rc, "fuse_count_launch")
    LAUNCHES["fuse_count"] += 1


def keep(job: _Job, ref: int, n_nb: int, hw: int) -> None:
    if job.plain:
        keep_plain(job, ref, n_nb)
        return
    with torch.cuda.device(job.depth.device):
        rc = _lib().fuse_keep_launch(
            job.maps(), *job.tables(ref, n_nb, hw), ctypes.c_void_p(job.claims.data_ptr()),
            job.stride, job.modes, ctypes.c_void_p(job.flags.data_ptr()),
            ctypes.c_void_p(job.block_sums.data_ptr()), ctypes.c_void_p(job.totals.data_ptr()),
            ctypes.c_void_p(job.block_base.data_ptr()), ctypes.c_void_p(job.pidx.data_ptr()),
            ctypes.c_void_p(job.moff.data_ptr()), _stream(job.depth))
    _check(rc, "fuse_keep_launch")
    LAUNCHES["fuse_keep"] += 1


def emit(job: _Job, ref: int, n_nb: int, hw: int) -> None:
    if job.plain:
        emit_plain(job, ref, n_nb)
        return
    out = (ctypes.c_ulonglong * 6)(
        job.points.data_ptr(), job.colours.data_ptr(), job.normals.data_ptr(),
        job.counts.data_ptr(), job.member_views.data_ptr(), job.member_weights.data_ptr())
    with torch.cuda.device(job.depth.device):
        rc = _lib().fuse_emit_launch(
            job.maps(), *job.tables(ref, n_nb, hw), ctypes.c_void_p(job.claims.data_ptr()),
            job.stride, job.floor, job.modes, ctypes.c_void_p(job.flags.data_ptr()),
            ctypes.c_void_p(job.pidx.data_ptr()), ctypes.c_void_p(job.moff.data_ptr()), out,
            _stream(job.depth))
    _check(rc, "fuse_emit_launch")
    LAUNCHES["fuse_emit"] += 1


def clear(job: _Job, n_nb: int) -> None:
    """Every word of the first n_nb claim layers to ``EMPTY``."""
    n = n_nb * job.stride
    if job.plain:
        job.claims[:n] = EMPTY
        return
    with torch.cuda.device(job.claims.device):
        rc = _lib().fuse_clear_launch(ctypes.c_void_p(job.claims.data_ptr()), n,
                                      _stream(job.claims))
    _check(rc, "fuse_clear_launch")
    LAUNCHES["fuse_clear"] += 1


def fuse_views(views, opts: DenseOptions, estimate_color: bool = True,
               estimate_normal: bool = True, device="cuda") -> PointCloud:
    """``fusion.fuse_depth_maps(views, opts, ...)`` on ``device``: the same
    cloud, bit for bit. ``views`` are ``fusion.ViewDepthData`` with float32
    maps and uint8 colours; they are not mutated. A neighbour id without a
    view is skipped, as the host skips it; a view that lists itself, or more
    than ``MAX_NB`` neighbours, raises. On a CPU ``device`` the plain twin
    runs."""
    dev = torch.device(device)
    with span("fuse.prepare"):
        views = list(views)
        slot = {v.image_id: s for s, v in enumerate(views)}
        if len(slot) != len(views):
            raise ValueError("two views share an image id")
        nbs = [[slot[n] for n in v.neighbor_ids if n in slot] for v in views]
        for v, nb in zip(views, nbs):
            if slot[v.image_id] in nb:
                raise ValueError(f"view {v.image_id} lists itself as a neighbour")
            if len(nb) > MAX_NB:
                raise ValueError(f"view {v.image_id}: {len(nb)} neighbours, the kernels "
                                 f"take {MAX_NB}")
        # best-connected first, the host's stable order
        order = sorted(range(len(views)), key=lambda s: -len(views[s].neighbor_ids))
        modes = _modes(estimate_color, estimate_normal)
    if not views:
        return PointCloud()
    with span("fuse.upload"):
        job = _upload(views, nbs, opts, modes, dev)
    for s in order:
        vid, n_nb, hw = views[s].image_id, len(nbs[s]), views[s].depth.size
        with span("fuse.neighbours", view=vid):
            claim(job, s, n_nb, hw)
            count_views(job, s, n_nb, hw)
        with span("fuse.keep", view=vid):
            keep(job, s, n_nb, hw)
        with span("fuse.emit", view=vid):
            emit(job, s, n_nb, hw)
            clear(job, n_nb)
        if dev.type == "cuda":
            count("fuse.card_views")
    with span("fuse.download"):
        n_pts, n_mem = (int(t) for t in job.totals.cpu())
        points = job.points[:n_pts].cpu().numpy()
        colours = job.colours[:n_pts].cpu().numpy() if estimate_color else None
        normals = job.normals[:n_pts].cpu().numpy() if estimate_normal else None
        counts = job.counts[:n_pts].cpu().numpy()
        views_flat = job.member_views[:n_mem].cpu().numpy().view(np.uint32)
        weights_flat = job.member_weights[:n_mem].cpu().numpy()
    with span("fuse.emit"):
        pc = PointCloud()
        if not n_pts:
            return pc
        pc.points = points
        if colours is not None:
            pc.colors = colours
        if normals is not None:
            pc.normals = normals
        offsets = np.concatenate([[0], np.cumsum(counts)])
        pc.views = [views_flat[offsets[i]:offsets[i + 1]] for i in range(len(counts))]
        pc.weights = [weights_flat[offsets[i]:offsets[i + 1]] for i in range(len(counts))]
        return pc
