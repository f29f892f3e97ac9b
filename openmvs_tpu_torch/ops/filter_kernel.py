"""The cross-view filter on the card: the wrapper of the hand-written
kernels of ``csrc/filter_splat.cu`` and their plain PyTorch twin.

``densify._filter_views`` hands the maps a card estimated to
``filter_views``, which filters them there: the job's maps uploaded once
(span ``filter.upload``); per reference view, each neighbour's map splatted
into the view's layer of a z-buffer stack (one ``filter_splat`` launch in
span ``filter.project``, counter ``filter.card_splats``), then one decide
launch and the download of the new depth and confidence (span
``filter.decide``). The maps equal the host filter's
(``ops/filters.project_depth_to_view``, ``filter_depth_adjust``,
``filter_depth_strict``) bit for bit: the splat projects in float64 in the
host's order of operations, with a fused multiply-add at each step of a
3x3 product where NumPy's BLAS fuses one (``blas_fuses``), and keeps the
winner NumPy's last write keeps.

A layer word packs the winner: the float32 z's bits in the upper half, the
complement of its key ``offset << 30 | source pixel`` in the lower; the
least word holds the least z and, among equal z, the greatest key
(``EMPTY`` where nothing landed). ``splat``, ``decide`` and ``clear`` launch
their kernel on CUDA tensors (each launch adds one to ``LAUNCHES``) and run
the plain version, ``splat_plain``/``decide_plain``, on CPU tensors: the
twin the tests hold against the host filter on the CPU and against the
kernels on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.geometry.camera import Camera
from openmvs_tpu_torch.ops import _build
from openmvs_tpu_torch.utils.log import count, span

LAUNCHES = {"filter_splat": 0, "filter_decide_adjust": 0, "filter_decide_strict": 0,
            "filter_clear": 0}
EMPTY = (1 << 63) - 1
KEY_BITS = 30
KEY_MASK = (1 << KEY_BITS) - 1
MAX_NB = _build.MAX_VIEWS


@functools.lru_cache(maxsize=None)
def blas_fuses() -> bool:
    """Whether NumPy's (n, 3) @ (3, 3) product rounds each step of its
    chain over k once (a fused multiply-add), as OpenBLAS's kernels do on
    x86-64 with FMA: -1 * 1 + x * x, x = 1 + 2**-30, keeps the 2**-60 of
    the exact product only then."""
    x = 1.0 + 2.0 ** -30
    a = np.tile(np.array([[-1.0, x, 0.0]]), (16, 1))
    b = np.array([[1.0, 0.0, 0.0], [x, 0.0, 0.0], [0.0, 0.0, 0.0]])
    return float((a @ b)[0, 0]) != 2.0 ** -29


def cams(src: Camera, ref: Camera) -> np.ndarray:
    """The 42 float64 of a (source, reference) pair in the kernel's order:
    the source's K^-1 (as ``Camera.image_to_cam`` computes it), R and C, the
    reference's R, C and K."""
    return np.concatenate([np.linalg.inv(src.K).ravel(), src.R.ravel(), src.C,
                           ref.R.ravel(), ref.C, ref.K.ravel()]).astype(np.float64)


# ------------------------------------------------------------------ the twin


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = a * 134217729.0  # 2**27 + 1
    hi = c - (c - a)
    return hi, a - hi


def fma64(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, in float64, from float64 operations alone
    (Boldo and Melquiond, IEEE TC 2008: the exact product as two doubles,
    its exact sum with c, the two small parts added with rounding to odd,
    then one rounding to nearest). Each operation is its own tensor
    operation, so no device contracts any of them."""
    uh = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    ul = (((ah * bh - uh) + ah * bl) + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    # rounding to odd: an inexact sum whose last bit is even moves one ulp
    # toward the exact sum
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(v.dtype)
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def _chain(fused: bool):
    if fused:
        return fma64
    return lambda a, b, acc: a * b + acc


def splat_plain(layer: torch.Tensor, depth: torch.Tensor, cam: np.ndarray,
                fused: bool) -> None:
    """``filter_splat`` in plain PyTorch, into ``layer`` (hr, wr) int64 in
    place: the host's projection op for op in float64, then the four
    offsets' words reduced by their minimum (order-free)."""
    hr, wr = layer.shape
    madd = _chain(fused)
    m = [float(v) for v in cam]
    kinv, rs, cs, rr, cr, kr = m[0:9], m[9:18], m[18:21], m[21:30], m[30:33], m[33:42]
    flat = depth.reshape(-1)
    idx = torch.nonzero(flat > 0).squeeze(1)
    d = flat[idx].double()
    ws = depth.shape[1]
    uv1 = ((idx % ws).double(), (idx // ws).double(), torch.ones_like(d))

    def row_t(v, mat, j):  # (v @ M.T)[j]
        return madd(v[2], mat[j * 3 + 2], madd(v[1], mat[j * 3 + 1], v[0] * mat[j * 3]))

    def col(v, mat, j):  # (v @ M)[j]
        return madd(v[2], mat[6 + j], madd(v[1], mat[3 + j], v[0] * mat[j]))

    cam_ = [row_t(uv1, kinv, j) * d for j in range(3)]
    t = [(col(cam_, rs, j) + cs[j]) - cr[j] for j in range(3)]
    xc = [row_t(t, rr, j) for j in range(3)]
    z = xc[2]
    fx = torch.floor(row_t(xc, kr, 0) / z)
    fy = torch.floor(row_t(xc, kr, 1) / z)
    zbits = z.float().view(torch.int32).to(torch.int64) << 32
    front = z > 0
    words = layer.view(-1)
    for off in range(4):
        ax, ay = fx + (off & 1), fy + (off >> 1)
        ok = front & (ax >= 0) & (ax < wr) & (ay >= 0) & (ay < hr)
        lin = (ay[ok] * wr + ax[ok]).long()
        key = (off << KEY_BITS) | idx[ok]
        words.scatter_reduce_(0, lin, zbits[ok] | (0xFFFFFFFF - key), "amin")


def unpack_plain(words: torch.Tensor, conf: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth, conf) float32 of layer words, as the host's projected maps:
    0 where nothing landed or the z is not finite; the winner's confidence
    from the neighbour's map ``conf`` by its key."""
    empty = words == EMPTY
    z = (words >> 32).to(torch.int32).view(torch.float32)
    depth = torch.where(empty | ~torch.isfinite(z), 0.0, z)
    idx = torch.where(empty, 0, (0xFFFFFFFF - (words & 0xFFFFFFFF)) & KEY_MASK)
    return depth, torch.where(empty, 0.0, conf.reshape(-1)[idx].reshape(words.shape))


def _similar(d0, d1, th: float):
    return (d0 - d1).abs() < th * d0


def _thresholds(opts: DenseOptions, adjust: bool) -> Tuple[float, float]:
    """The decide's float32 thresholds: adjust's agreement threshold, or
    the strict and loose ones (a Python float times a float32 array is
    float32 in NumPy)."""
    if adjust:
        return float(np.float32(opts.depth_diff_threshold * 1.2)), 0.0
    return (float(np.float32(opts.depth_diff_threshold * 0.8)),
            float(np.float32(opts.depth_diff_threshold * 1.2)))


def decide_plain(depth_ref: torch.Tensor, conf_ref: torch.Tensor,
                 projected: Sequence[Tuple[torch.Tensor, torch.Tensor]], opts: DenseOptions,
                 d_min: float, d_max: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decide kernel in plain PyTorch on projected (depth, conf) maps:
    ``filter_depth_adjust`` (``opts.filter_adjust``) or ``filter_depth_strict``
    in the kernel's order of operations."""
    th_a, th_b = _thresholds(opts, opts.filter_adjust)
    n_min = opts.min_views_filter
    valid = depth_ref > 0
    zero = torch.zeros((), dtype=torch.float64, device=depth_ref.device)
    if opts.filter_adjust:
        pos = torch.where(valid, conf_ref.double(), zero)
        avg = depth_ref.double() * pos
        neg = torch.zeros_like(pos)
        n_pos = torch.zeros(depth_ref.shape, dtype=torch.int32, device=depth_ref.device)
        n_seen = torch.zeros_like(n_pos)
        for dp, cp in projected:
            has = dp > 0
            agree = has & _similar(depth_ref, dp, th_a)
            n_seen += has
            avg = avg + torch.where(agree, (dp * cp).double(), zero)
            pos = pos + torch.where(agree, cp.double(), zero)
            n_pos += agree
            neg = neg + torch.where(has & ~agree, cp.double(), zero)
        a = avg / torch.where(torch.isnan(pos) | (pos > 1e-12), pos, 1e-12)
        keep = (valid & (n_seen >= n_min) & (n_pos >= opts.min_views_filter_adjust)
                & (pos > neg) & (a >= d_min) & (a <= d_max))
        return (torch.where(keep, a.float(), 0.0), torch.where(keep, (pos - neg).float(), 0.0))
    n_good = torch.zeros(depth_ref.shape, dtype=torch.int32, device=depth_ref.device)
    n_seen, n_good_d, n_seen_d = (torch.zeros_like(n_good) for _ in range(3))
    for dp, _ in projected:
        has = dp > 0
        n_seen += has
        n_good += has & _similar(depth_ref, dp, th_a)
        pad = torch.nn.functional.pad(dp, (1, 1, 1, 1))
        for shifted in (pad[1:-1, :-2], pad[1:-1, 2:], pad[:-2, 1:-1], pad[2:, 1:-1]):
            hs = shifted > 0
            n_seen_d += hs
            n_good_d += hs & _similar(depth_ref, shifted, th_b)
    keep = (valid & (n_good >= n_min) & (n_good * 100 >= n_seen * 75)
            & (n_good_d >= n_min * 2) & (n_good_d * 100 >= n_seen_d * 65))
    return torch.where(keep, depth_ref, 0.0), torch.where(keep, conf_ref, 0.0)


# --------------------------------------------------------------- the wrapper


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} failed: {_build.error_string(rc)}")


def _need(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int,
          device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dim}-D tensor, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def splat(layer: torch.Tensor, depth: torch.Tensor, cam: np.ndarray, fused: bool) -> None:
    """Splat the source ``depth`` (hs, ws) float32 into ``layer`` (hr, wr)
    int64 words through the cameras ``cam`` (``cams``), in place."""
    _need(layer, "layer", torch.int64, 2, depth.device)
    _need(depth, "depth", torch.float32, 2, depth.device)
    if np.shape(cam) != (42,):
        raise ValueError(f"cam: shape {np.shape(cam)}, expected (42,)")
    if depth.numel() >= 1 << KEY_BITS:
        raise ValueError(f"a source map of {depth.numel()} pixels: keys hold 2**30")
    if depth.device.type == "cpu":
        splat_plain(layer, depth, cam, fused)
        return
    host = np.ascontiguousarray(cam, np.float64)
    with torch.cuda.device(depth.device):
        rc = _build.library("filter_splat").filter_splat_launch(
            ctypes.c_void_p(depth.data_ptr()), depth.shape[0], depth.shape[1],
            host.ctypes.data_as(ctypes.c_void_p), ctypes.c_void_p(layer.data_ptr()),
            layer.shape[0], layer.shape[1], int(fused), _stream(depth))
    _check(rc, "filter_splat_launch")
    LAUNCHES["filter_splat"] += 1


def clear(words: torch.Tensor) -> None:
    """Set every word of ``words`` (int64, contiguous) to ``EMPTY``."""
    if words.device.type == "cpu":
        words.fill_(EMPTY)
        return
    with torch.cuda.device(words.device):
        rc = _build.library("filter_splat").filter_clear_launch(
            ctypes.c_void_p(words.data_ptr()), words.numel(), _stream(words))
    _check(rc, "filter_clear_launch")
    LAUNCHES["filter_clear"] += 1


def decide(stack: torch.Tensor, depth_ref: torch.Tensor, conf_ref: torch.Tensor,
           confs: List[torch.Tensor], opts: DenseOptions, d_min: float,
           d_max: float) -> torch.Tensor:
    """(2, h, w) float32, the new depth and confidence of a reference view
    from its maps and the layers ``stack`` (n_nb, h, w) that ``splat``
    filled from the neighbours whose confidence maps are ``confs``. The
    adjust mode leaves the layers ``EMPTY``; after the strict mode the
    caller clears them."""
    dev = depth_ref.device
    _need(depth_ref, "depth_ref", torch.float32, 2, dev)
    _need(conf_ref, "conf_ref", torch.float32, 2, dev)
    _need(stack, "stack", torch.int64, 3, dev)
    for c in confs:
        _need(c, "a neighbour's conf", torch.float32, 2, dev)
    n_nb, (h, w) = len(confs), depth_ref.shape
    if stack.shape != (n_nb, h, w) or conf_ref.shape != (h, w):
        raise ValueError(f"stack {tuple(stack.shape)}, conf_ref {tuple(conf_ref.shape)}: "
                         f"expected ({n_nb}, {h}, {w}) and ({h}, {w})")
    if n_nb > MAX_NB:
        raise ValueError(f"{n_nb} neighbours: the decide kernel takes {MAX_NB}")
    if depth_ref.device.type == "cpu":
        projected = [unpack_plain(stack[j], confs[j]) for j in range(n_nb)]
        nd, nc = decide_plain(depth_ref, conf_ref, projected, opts, d_min, d_max)
        if opts.filter_adjust:
            clear(stack)
        return torch.stack([nd, nc])
    th_a, th_b = _thresholds(opts, opts.filter_adjust)
    out = torch.empty((2, h, w), dtype=torch.float32, device=depth_ref.device)
    ptrs = (ctypes.c_ulonglong * MAX_NB)(*[c.data_ptr() for c in confs])
    with torch.cuda.device(depth_ref.device):
        rc = _build.library("filter_splat").filter_decide_launch(
            ctypes.c_void_p(depth_ref.data_ptr()), ctypes.c_void_p(conf_ref.data_ptr()),
            ctypes.c_void_p(stack.data_ptr()), ptrs, n_nb, h, w, int(opts.filter_adjust),
            th_a, th_b, opts.min_views_filter, opts.min_views_filter_adjust,
            float(d_min), float(d_max), ctypes.c_void_p(out.data_ptr()), _stream(out))
    _check(rc, "filter_decide_launch")
    LAUNCHES["filter_decide_adjust" if opts.filter_adjust else "filter_decide_strict"] += 1
    return out


def _upload(results, device) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """Every map's depth and confidence (ones where it has none) on
    ``device`` in one copy."""
    ids = list(results)
    parts = []
    for rid in ids:
        r = results[rid]
        parts += [r.depth, r.conf if r.conf is not None else np.ones_like(r.depth)]
    flat = torch.from_numpy(np.concatenate([np.ravel(p).astype(np.float32, copy=False)
                                            for p in parts])).to(device)
    maps, at = {}, 0
    for k, rid in enumerate(ids):
        shape = results[rid].depth.shape
        n = shape[0] * shape[1]
        maps[rid] = (flat[at:at + n].view(shape), flat[at + n:at + 2 * n].view(shape))
        at += 2 * n
    return maps


def filter_views(results, rids: Sequence[int], opts: DenseOptions, device
                 ) -> Dict[int, Optional[Tuple[np.ndarray, np.ndarray]]]:
    """The cross-view filter of the views ``rids`` of ``results`` (id ->
    ``densify.DepthMapResult``) on ``device``: per view its new (depth,
    conf) as NumPy float32, or None where fewer than
    ``opts.min_views_filter`` neighbours have a map (the view is kept as
    it is)."""
    dev = torch.device(device)
    views = [(rid, [n for n in results[rid].neighbor_ids if results.get(n) is not None])
             for rid in rids]
    todo = [(rid, nbs) for rid, nbs in views if len(nbs) >= opts.min_views_filter]
    out: Dict[int, Optional[Tuple[np.ndarray, np.ndarray]]] = {rid: None for rid in rids}
    if not todo:
        return out
    with span("filter.upload"):
        maps = _upload(results, dev)
    fused = blas_fuses()
    size = max(len(nbs) * results[rid].depth.size for rid, nbs in todo)
    words = torch.empty(size, dtype=torch.int64, device=dev)
    clear(words)
    for rid, nbs in todo:
        r = results[rid]
        h, w = r.depth.shape
        stack = words[:len(nbs) * h * w].view(len(nbs), h, w)
        for j, nb_id in enumerate(nbs):
            with span("filter.project", view=rid, neighbour=nb_id):
                splat(stack[j], maps[nb_id][0], cams(results[nb_id].camera, r.camera), fused)
                if dev.type == "cuda":
                    count("filter.card_splats")
        with span("filter.decide", view=rid):
            new = decide(stack, *maps[rid], [maps[n][1] for n in nbs], opts, r.d_min, r.d_max)
            if not opts.filter_adjust:
                clear(stack)
            new = new.cpu().numpy()
        out[rid] = (new[0], new[1])
    return out
