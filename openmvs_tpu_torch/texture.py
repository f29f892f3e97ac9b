"""Mesh texturing: face->view labeling + atlas generation.

Port of the JAX package's ``openmvs_tpu/texture.py`` (Scene::TextureMesh,
libs/MVS/SceneTexture.cpp:2331-2353, Waechter'14 "Let There Be Color"):
  1. per-view mesh rasterization -> face visibility + gradient-weighted
     quality (ListCameraFaces, SceneTexture.cpp:~400-900)
  2. face->view label assignment as a Potts MRF solved with loopy belief
     propagation (FaceViewSelection, SceneTexture.cpp:1126-1260; LBP is the
     reference default, Math/LBP.h) — min-sum message passing on the
     (face, 3-neighbor) adjacency, run in PyTorch on ``device``; or by
     sequential TRW-S on the host
  3. patch growing per connected label component
  4. global seam leveling: per-vertex color offsets solved as a Tikhonov-
     regularized least squares by conjugate gradient (SceneTexture.cpp:
     1483-1640), scipy sparse on the host
  5. texture atlas packing (RectsBinPack role) + patch copy + texcoords,
     local seam leveling and unsharp-mask sharpening

Everything but the message passing is host numpy/scipy code, copied: the
per-face sums stay ``np.add.at`` in index order, so qualities (and the
labels they decide) are those of the JAX package to the bit. The JAX
package reaches no Pallas kernel here (its device labeling is XLA-jitted
``jnp``), so the labeling is plain PyTorch. OpenCV's blurs are
``io.images.box_blur`` and ``io.images.gaussian_blur``.
``label_faces_lbp_sharded`` splits the labels over several shards.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from openmvs_tpu_torch import native
from openmvs_tpu_torch.config import TextureOptions
from openmvs_tpu_torch.io import images as imio
from openmvs_tpu_torch.scene import Mesh, Scene
from openmvs_tpu_torch.utils import device as device_mod
from openmvs_tpu_torch.utils.log import get_logger, timed

log = get_logger("texture")

# patch count from which generate_texture packs shelves straight into
# pages (MaxRects is super-linear in the patch count)
SHELF_MIN = 20000
# faces per chunk of the global leveling's offset rasterization
LEVEL_CHUNK = 2_500_000


@contextlib.contextmanager
def _stage(stats: Optional[dict], key: str, label: str):
    """``timed`` that also records the seconds under ``stats["stages_s"]``."""
    t0 = time.perf_counter()
    with timed(log, label):
        yield
    if stats is not None:
        stats.setdefault("stages_s", {})[key] = time.perf_counter() - t0


# ------------------------------------------------------------------ helpers
def _project(cam, verts: np.ndarray) -> np.ndarray:
    """(nv, 3) world -> (u, v, camera depth)."""
    Xc = (verts - cam.C) @ cam.R.T
    z = Xc[:, 2]
    uv = Xc @ cam.K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        u = uv[:, 0] / uv[:, 2]
        v = uv[:, 1] / uv[:, 2]
    return np.stack([u, v, z], axis=-1)


def _face_adjacency(faces: np.ndarray) -> np.ndarray:
    """(nf, 3) adjacent face index per edge (-1 if none)."""
    nf = len(faces)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]],
                       axis=0).astype(np.int32, copy=False)
    e = np.sort(e, axis=1)
    order = np.lexsort((e[:, 1], e[:, 0]))
    es = e[order]
    del e
    fidx = (order % nf).astype(np.int32)
    adj = np.full((nf, 3), -1, np.int32)
    same = (es[1:] == es[:-1]).all(axis=1)
    si = np.nonzero(same)[0]
    if len(si):
        # vectorized slot assignment: each face's neighbors take slots in
        # per-face occurrence order (a python pair loop cost 10 s at 2M
        # faces / ~1M matched edges).  Around non-manifold edges (>3
        # neighbors) the surviving 3 may differ from the old scan order —
        # the 3-slot cap itself was already arbitrary there.
        f_all = np.concatenate([fidx[si], fidx[si + 1]])
        nb_all = np.concatenate([fidx[si + 1], fidx[si]])
        order2 = np.argsort(f_all, kind="stable")
        fs = f_all[order2]
        starts = np.searchsorted(fs, fs)  # first index of each value run
        rank = np.arange(len(fs)) - starts
        keep = rank < 3
        adj[fs[keep], rank[keep]] = nb_all[order2][keep]
    return adj


def compute_face_qualities(
    scene: Scene, mesh: Mesh, max_dim: int
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Per (face, view) quality = integral of image gradient magnitude over
    the face's visible pixels (the reference's gradient-weighted data term,
    SceneTexture.cpp ListCameraFaces); 0 where occluded/invisible."""
    nf = len(mesh.faces)
    V = len(scene.images)
    quality = np.zeros((nf, V), np.float32)
    face_colors: List[np.ndarray] = [np.zeros((nf, 3), np.float32) for _ in range(V)]
    for vi, img in enumerate(scene.images):
        if img.gray is None:
            img.load(max_dim=max_dim)
        cam = img.working_camera()
        H, W = img.gray.shape
        proj = _project(cam, mesh.vertices.astype(np.float64))
        with timed(log, f"rasterize view {vi}"):
            fid, _, _ = native.rasterize(proj, mesh.faces, H, W, want_bary=False)
        gy, gx = np.gradient(img.gray)
        grad = np.sqrt(gx * gx + gy * gy)
        sel = fid >= 0
        ids = fid[sel].astype(np.int64)
        np.add.at(quality[:, vi], ids, grad[sel])
        # mean color per face (for outlier removal + seam leveling)
        cols = img.color[sel].astype(np.float32)
        csum = np.zeros((nf, 3), np.float32)
        cnt = np.zeros(nf, np.float32)
        np.add.at(csum, ids, cols)
        np.add.at(cnt, ids, 1.0)
        face_colors[vi] = csum / np.maximum(cnt[:, None], 1)
    return quality, face_colors


def remove_outlier_views(quality: np.ndarray, face_colors: List[np.ndarray],
                         threshold: float) -> np.ndarray:
    """Reject views whose face color deviates from the robust mean
    (simplified form of the reference's multivariate-Gaussian color
    consistency test, SceneTexture.cpp:917-1027).  Streams over views —
    an (nf, V, 3) stack peaks at ~1.2 GB on a 10M-face mesh."""
    nf, V = quality.shape
    seen = quality > 0
    cnt = seen.sum(axis=1)
    mean = np.zeros((nf, 3), np.float32)
    for vi in range(V):
        mean += np.where(seen[:, vi, None], face_colors[vi], 0.0)
    mean /= np.maximum(cnt[:, None], 1)
    q = quality.copy()
    th = np.sqrt(threshold) * 6
    may = cnt >= 3
    for vi in range(V):
        dev = np.linalg.norm(face_colors[vi] - mean, axis=-1) / 255.0
        q[seen[:, vi] & may & (dev > th), vi] = 0
    return q


def _rev_slots(adj: np.ndarray):
    """(adj_safe, rev, valid_edge) for message passing on the face-dual.

    An edge is valid only when the neighbor points BACK (mutual): around
    non-manifold edges the 3-slot adjacency can hold one-directional
    entries whose messages would otherwise clobber the neighbor's slot 0."""
    nf = len(adj)
    adj_safe = np.where(adj >= 0, adj, 0)
    rev = np.zeros((nf, 3), np.int64)
    mutual = np.zeros((nf, 3), bool)
    for k in range(3):
        nb = adj[:, k]
        for kk in range(3):
            mask = (nb >= 0) & (adj[adj_safe[:, k], kk] == np.arange(nf))
            rev[mask, k] = kk
            mutual[mask, k] = True
    return adj_safe, rev, (adj >= 0) & mutual


def label_faces_lbp(
    quality: np.ndarray, adj: np.ndarray, smoothness: float, iters: int = 30,
    lam_edge: Optional[np.ndarray] = None, device="cuda",
) -> np.ndarray:
    """Face -> view labels by loopy BP on a Potts MRF (Math/LBP.h role).

    Min-sum message passing: messages (nf, 3, L); the Potts smoothness
    makes each message update a min over (same-label, switch). The data
    cost is built on the host, the schedule runs on ``device`` ("cuda" by
    default; raises without a card). lam_edge (nf, 3) optionally scales the
    Potts cost per directed edge (used for "virtual faces": near-rigid
    coplanar groups). Unseen faces (no view with quality > 0) get -1.
    """
    return _label_faces(quality, adj, smoothness, iters, lam_edge,
                        [device_mod.resolve(device)])


def label_faces_lbp_sharded(quality: np.ndarray, adj: np.ndarray,
                            smoothness: float, devices, iters: int = 30,
                            lam_edge: Optional[np.ndarray] = None) -> np.ndarray:
    """label_faces_lbp over shards on ``devices``, split on the LABEL (view)
    axis (texture.py:236-306 of the JAX package). The message storage
    (nf, 3, L), the dominant memory at scale, is split L-ways; the labels
    equal label_faces_lbp's (``_lbp_schedule``)."""
    from openmvs_tpu_torch.parallel.mesh import resolve_device

    return _label_faces(quality, adj, smoothness, iters, lam_edge,
                        [resolve_device(d) for d in devices])


def _label_faces(quality, adj, smoothness, iters, lam_edge, devs) -> np.ndarray:
    """The data cost of ``quality`` with the label axis padded to a
    multiple of ``len(devs)`` by labels of cost 1e6, which never decide a
    minimum; the schedule on ``devs``; -1 for unseen faces."""
    nf, V = quality.shape
    L = -(-V // len(devs)) * len(devs)
    qmax = quality.max(axis=1, keepdims=True)
    # data cost in [0, 1]: 1 - normalized quality; invisible = large cost
    data = np.full((nf, L), 1e6, np.float32)
    data[:, :V] = np.where(quality > 0, 1.0 - quality / np.maximum(qmax, 1e-12), 4.0)
    lam_k = (lam_edge.astype(np.float32) if lam_edge is not None
             else np.full((nf, 3), np.float32(smoothness), np.float32))
    _, rev, valid_edge = _rev_slots(adj)
    labels = _lbp_schedule(data, adj, lam_k, rev, valid_edge, iters, devs)
    labels[quality.max(axis=1) <= 0] = -1                # unseen faces
    return labels


def _lbp_schedule(data, adj, lam_k, rev, valid_edge, iters, devs) -> np.ndarray:
    """The message schedule of the JAX package's numpy ``label_faces_lbp``
    (and of its jitted ``_label_faces_lbp_device``), to the bit, with the
    label axis of ``data`` (nf, L) split evenly over the shards on ``devs``:
    beliefs fix at the start of an iteration as data + ((m0 + m1) + m2),
    numpy's order of ``msg.sum(axis=1)``; the three slots deliver in turn,
    so slot k's writes are read by slot k+1. Each delivery is one
    ``index_put_`` without accumulation into a message array padded with a
    dummy row: mutual edges make the (target, reverse slot) pairs unique,
    and invalid edges all write the dummy row, which is never read. The
    update is label-local except for the two per-face minima (hmin and the
    normalisation), which are ``pmin`` reductions of (nf, 1) floats over
    the shards, exact full-label minima. Only min, subtract and add touch
    the floats, so the card and the CPU, and any number of shards, agree to
    the bit. Returns the argmin label per face (the lowest global label of
    the minimum, as numpy's)."""
    from openmvs_tpu_torch.parallel.mesh import pmin, to

    nf, L = data.shape
    n = len(devs)
    Lloc = L // n

    def put(x, dev):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    data_s = [put(data[:, s * Lloc:(s + 1) * Lloc], d) for s, d in enumerate(devs)]
    lam_s = [put(np.asarray(lam_k, np.float32), d) for d in devs]
    tgt_s = [put(np.where(valid_edge, adj, nf).astype(np.int64), d) for d in devs]
    rev_s = [put(np.asarray(rev, np.int64), d) for d in devs]
    msg_s = [torch.zeros((nf + 1, 3, Lloc), dtype=torch.float32, device=d) for d in devs]

    def belief(s):
        m = msg_s[s][:nf]
        return data_s[s] + ((m[:, 0] + m[:, 1]) + m[:, 2])

    def all_min(xs):
        g = pmin([x.amin(dim=1, keepdim=True) for x in xs])
        return [to(g, d) for d in devs]

    for _ in range(iters):
        b = [belief(s) for s in range(n)]
        for k in range(3):
            h = [b[s] - msg_s[s][:nf, k] for s in range(n)]        # exclude reverse msg
            hmin = all_min(h)
            out = [torch.minimum(h[s], hmin[s] + lam_s[s][:, k:k + 1]) for s in range(n)]
            omin = all_min(out)                                     # normalize
            for s in range(n):
                msg_s[s].index_put_((tgt_s[s][:, k], rev_s[s][:, k]), out[s] - omin[s])
    bel = [belief(s) for s in range(n)]
    loc_min = [x.amin(dim=1) for x in bel]
    loc_arg = [torch.argmin(x, dim=1) + s * Lloc for s, x in enumerate(bel)]
    glob_min = pmin(loc_min)
    # global argmin: the lowest label index reaching the global minimum
    cand = [torch.where(to(m, devs[0]) == glob_min, to(a, devs[0]), L)
            for m, a in zip(loc_min, loc_arg)]
    return pmin(cand).cpu().numpy().astype(np.int64)


def _trws_order(adj: np.ndarray, valid_edge: np.ndarray) -> np.ndarray:
    """Node processing order for sequential TRW-S: reverse Cuthill-McKee on
    the face-dual graph.  Any total order is valid; RCM keeps adjacent nodes
    close in the order, which keeps the wavefront-level count (and thus the
    vectorized schedule's Python overhead) low on large meshes."""
    nf = len(adj)
    src = np.repeat(np.arange(nf), 3)
    dst = adj.reshape(-1)
    ok = valid_edge.reshape(-1)
    src, dst = src[ok], dst[ok]
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        g = csr_matrix((np.ones(len(src), np.int8), (src, dst)), shape=(nf, nf))
        return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True),
                          np.int64)
    except Exception:
        return np.arange(nf, dtype=np.int64)


def _order_levels(adj: np.ndarray, valid_edge: np.ndarray) -> np.ndarray:
    """Wavefront levels for sequential TRW-S: level[i] = 1 + max level of
    lower-index neighbors.  Nodes within a level are mutually non-adjacent,
    so processing a level at once is exactly equivalent to processing its
    nodes one by one in index order — the sequential schedule, vectorized."""
    nf = len(adj)
    level = np.zeros(nf, np.int64)
    adj_l = adj.tolist()
    valid_l = valid_edge.tolist()
    lev = level.tolist()
    for i in range(nf):
        m = 0
        ai, vi = adj_l[i], valid_l[i]
        for k in range(3):
            j = ai[k]
            if vi[k] and j < i and lev[j] >= m:
                m = lev[j] + 1
        lev[i] = m
    return np.asarray(lev, np.int64)


def _monotonic_chains(adj: np.ndarray, valid_edge: np.ndarray):
    """Monotonic-chain decomposition of the face-dual graph (TRW-S's tree
    set, Kolmogorov 2006): every edge in exactly one strictly-increasing
    chain; node i appears in max(#earlier, #later neighbors) chains (or one
    singleton chain if isolated), matching gamma_i = 1/max(.,.)."""
    nf = len(adj)
    fwd = [[] for _ in range(nf)]
    n_app = np.zeros(nf, np.int64)
    for k in range(3):
        sel = valid_edge[:, k] & (adj[:, k] > np.arange(nf))
        for i in np.where(sel)[0]:
            fwd[i].append(int(adj[i, k]))
    chains: list = []
    open_at: dict = {}
    for i in range(nf):
        ends = open_at.pop(i, [])
        n_app[i] += len(ends)
        outs = fwd[i]
        for j in outs:
            if ends:
                c = ends.pop()
            else:
                c = len(chains)
                chains.append([i])
                n_app[i] += 1
            chains[c].append(j)
            open_at.setdefault(j, []).append(c)
        # leftover incoming chains simply terminate at i
    for i in range(nf):
        if n_app[i] == 0:
            chains.append([i])
    return [np.asarray(c, np.int64) for c in chains]


def trws_lower_bound(data: np.ndarray, msg: np.ndarray, adj: np.ndarray,
                     lam_k: np.ndarray, rev: np.ndarray, gamma: np.ndarray,
                     chains, edge_slot: dict) -> float:
    """The TRW-S dual value: sum over monotonic chains of the chain's
    min-energy under the current reparameterization (gamma-weighted unary
    theta-hat per node visit, Potts pairwise minus the two edge messages).
    Monotonically non-decreasing under the sequential schedule
    (Kolmogorov 2006, Thm 3.4); always a lower bound on the Potts energy."""
    theta = data + msg.sum(axis=1)              # (nf, V) reparam unaries
    g = gamma.reshape(-1)
    lb = 0.0
    for c in chains:
        alpha = g[c[0]] * theta[c[0]]
        for t in range(len(c) - 1):
            i, j = int(c[t]), int(c[t + 1])
            k = edge_slot[(i, j)]               # slot of j in adj[i]
            a = msg[i, k, :]                    # M_{j->i}
            b = msg[j, rev[i, k], :]            # M_{i->j}
            h = alpha - a
            alpha = (np.minimum(h, h.min() + lam_k[i, k]) - b
                     + g[j] * theta[j])
        lb += float(alpha.min())
    return lb


def label_faces_trws(
    quality: np.ndarray, adj: np.ndarray, smoothness: float, iters: int = 60,
    lam_edge: Optional[np.ndarray] = None, return_bound: bool = False,
    rho: float = 0.0,  # unused; kept for call compatibility
):
    """Face -> view labels by SEQUENTIAL tree-reweighted message passing
    (Kolmogorov's TRW-S — the reference's higher-quality inference
    alternative, libs/Math/TRWS/MRFEnergy.h).

    Same Potts model as label_faces_lbp.  Nodes are processed in index
    order forward then backward each iteration; the per-node coefficient
    gamma_i = 1/max(#earlier-, #later-neighbors) makes the LP lower bound
    monotonically non-decreasing (tested).  Each wavefront level (nodes
    whose lower-index neighbors are all in earlier levels) is vectorized —
    levels contain mutually non-adjacent nodes, so the result is exactly
    the sequential schedule.

    Returns labels; with return_bound=True, (labels, bounds) where bounds
    is the per-iteration LP-dual lower bound on the labeling energy.
    """
    del rho
    nf, V = quality.shape
    qmax = quality.max(axis=1, keepdims=True)
    data = np.where(quality > 0, 1.0 - quality / np.maximum(qmax, 1e-12),
                    4.0).astype(np.float32)
    lam_k = (lam_edge.astype(np.float32) if lam_edge is not None
             else np.full((nf, 3), np.float32(smoothness), np.float32))

    # reorder nodes (RCM) so the sequential schedule has few wavefront
    # levels; results are mapped back to the original face order at the end
    perm = _trws_order(adj, _rev_slots(adj)[2])       # perm[new] = old
    inv = np.empty(nf, np.int64)
    inv[perm] = np.arange(nf)
    adj = np.where(adj[perm] >= 0, inv[np.where(adj[perm] >= 0, adj[perm], 0)],
                   -1)
    data = data[perm]
    lam_k = lam_k[perm]

    adj_safe, rev, valid_edge = _rev_slots(adj)
    idx = np.arange(nf)
    fwd_edge = valid_edge & (adj > idx[:, None])   # (nf,3) edges to later
    bwd_edge = valid_edge & (adj < idx[:, None])
    n_fwd = fwd_edge.sum(axis=1)
    n_bwd = bwd_edge.sum(axis=1)
    gamma = (1.0 / np.maximum(np.maximum(n_fwd, n_bwd), 1)).astype(
        np.float32)[:, None]

    level = _order_levels(adj, valid_edge)
    n_levels = int(level.max()) + 1 if nf else 0
    by_level = [np.where(level == l)[0] for l in range(n_levels)]

    if return_bound:
        chains = _monotonic_chains(adj, valid_edge)
        edge_slot = {}
        for k in range(3):
            sel = valid_edge[:, k] & (adj[:, k] > idx)
            for i in np.where(sel)[0]:
                edge_slot[(int(i), int(adj[i, k]))] = k

    msg = np.zeros((nf, 3, V), np.float32)   # msg[i,k] = M_{adj[i,k] -> i}

    def half_pass(levels_iter, edge_sel):
        for S in levels_iter:
            if len(S) == 0:
                continue
            # messages INTO S are fixed while S is processed (level nodes
            # are mutually non-adjacent; writes only target neighbors)
            theta = data[S] + msg[S].sum(axis=1)          # (s, V)
            for k in range(3):
                e = edge_sel[S, k]
                if not e.any():
                    continue
                Sk = S[e]
                a = gamma[Sk] * theta[e] - msg[Sk, k, :]
                amin = a.min(axis=1, keepdims=True)
                out = np.minimum(a, amin + lam_k[Sk, k : k + 1])
                out -= out.min(axis=1, keepdims=True)
                msg[adj_safe[Sk, k], rev[Sk, k], :] = out

    bounds = []
    for _ in range(iters):
        half_pass(by_level, fwd_edge)
        half_pass(reversed(by_level), bwd_edge)
        if return_bound:
            bounds.append(trws_lower_bound(data, msg, adj, lam_k, rev,
                                           gamma, chains, edge_slot))

    # TRW-S rounding: assign labels in node order, conditioning on the
    # already-assigned earlier neighbors (MRFEnergy::Minimize_TRW_S role)
    labels = np.zeros(nf, np.int64)
    assigned = np.zeros(nf, bool)
    for S in by_level:
        if len(S) == 0:
            continue
        b = data[S] + msg[S].sum(axis=1)
        for k in range(3):
            e = bwd_edge[S, k]
            if not e.any():
                continue
            Sk = S[e]
            nbr = adj_safe[Sk, k]
            # earlier neighbors are always in earlier levels, hence assigned:
            # swap their message for the actual Potts cost of their label
            assert assigned[nbr].all()
            cost = np.broadcast_to(lam_k[Sk, k : k + 1],
                                   (len(Sk), V)).copy()
            cost[np.arange(len(Sk)), labels[nbr]] = 0.0
            b[e] = b[e] - msg[Sk, k, :] + cost
        labels[S] = b.argmin(axis=1)
        assigned[S] = True
    out_labels = np.empty(nf, np.int64)
    out_labels[perm] = labels                       # back to face order
    out_labels[quality.max(axis=1) <= 0] = -1
    if return_bound:
        return out_labels, np.asarray(bounds)
    return out_labels


def virtual_face_lambda(
    mesh: Mesh, adj: np.ndarray, smoothness: float, threshold_deg: float,
    rigidity: float = 30.0,
) -> np.ndarray:
    """Per-edge Potts costs implementing "virtual faces"
    (SceneTexture.cpp fVirtualFaceThreshold): adjacent near-coplanar faces
    are bound by a much stronger smoothness cost, so planar regions act as a
    single labeling unit without changing the graph structure."""
    v = np.asarray(mesh.vertices)
    f = np.asarray(mesh.faces)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    cos_thr = np.cos(np.deg2rad(threshold_deg))
    lam = np.full(adj.shape, np.float32(smoothness), np.float32)
    for k in range(3):
        nb = adj[:, k]
        ok = nb >= 0
        cosang = np.einsum("ij,ij->i", n, n[np.where(ok, nb, 0)])
        lam[ok & (cosang > cos_thr), k] = smoothness * rigidity
    return lam


@dataclass(slots=True)
class _Patch:
    view: int
    faces: np.ndarray     # face indices
    x0: int
    y0: int
    w: int
    h: int
    atlas_x: int = 0
    atlas_y: int = 0


def _pack_maxrects(
    sizes: List[Tuple[int, int]], max_w: int, heuristic: int = 3,
    max_h: int = 0, placeable=None,
) -> Tuple[List[Tuple[int, int]], int, int]:
    """MaxRects packing (the reference's default packer, RectsBinPack.h:57-420).

    Maintains the set of maximal free rectangles; each patch is placed into
    the free rect minimizing the heuristic score, every overlapping free rect
    is split into its up-to-4 remainders, and contained rects are pruned.
    heuristic (reference enum order): 0 best-short-side-fit,
    1 best-long-side-fit, 2 best-area-fit, 3 bottom-left (reference default).
    The free-rect scans are numpy-vectorized (thousands of patches)."""
    n = len(sizes)
    if n == 0:
        return [], 0, 0
    big = max_h if max_h > 0 else max_w * 8 + sum(h for _, h in sizes)
    fx = np.array([0.0]); fy = np.array([0.0])
    fw = np.array([float(max_w)]); fh = np.array([float(big)])
    pos = [(0, 0)] * n
    order = sorted(range(n), key=lambda i: -(sizes[i][0] * sizes[i][1]))
    for i in order:
        if placeable is not None and not placeable[i]:
            pos[i] = None
            continue
        w, h = float(sizes[i][0]), float(sizes[i][1])
        fit = (fw >= w) & (fh >= h)
        if not fit.any():  # bounded page full (or patch larger than a page)
            pos[i] = None
            continue
        dw, dh = fw - w, fh - h
        if heuristic == 1:
            score = np.maximum(dw, dh)
        elif heuristic == 2:
            score = fw * fh - w * h
        elif heuristic == 3:  # bottom-left rule: lowest top edge, then leftmost
            score = (fy + h) * (max_w + 1.0) + fx
        else:
            score = np.minimum(dw, dh)
        # break score ties toward the atlas top-left to keep the height low
        score = np.where(fit, score * (max_w + 1.0) * big + fy * (max_w + 1.0) + fx,
                         np.inf)
        j = int(np.argmin(score))
        x, y = float(fx[j]), float(fy[j])
        pos[i] = (int(x), int(y))
        # split every free rect overlapping the placed rect
        ox = np.maximum(fx, x); oy = np.maximum(fy, y)
        ox2 = np.minimum(fx + fw, x + w); oy2 = np.minimum(fy + fh, y + h)
        hit = (ox < ox2) & (oy < oy2)
        keep = ~hit
        ox_, oy_, ow_, oh_ = fx[keep], fy[keep], fw[keep], fh[keep]
        hx, hy, hw, hh = fx[hit], fy[hit], fw[hit], fh[hit]
        # left, right, bottom, top remainders of each hit rect
        nx, ny, nw, nh = [], [], [], []
        for cx, cy, cw, ch, ok in (
            (hx, hy, x - hx, hh, hx < x),
            (np.full_like(hx, x + w), hy, hx + hw - (x + w), hh, hx + hw > x + w),
            (hx, hy, hw, y - hy, hy < y),
            (hx, np.full_like(hy, y + h), hw, hy + hh - (y + h), hy + hh > y + h),
        ):
            nx.append(cx[ok]); ny.append(cy[ok]); nw.append(cw[ok]); nh.append(ch[ok])
        nx = np.concatenate(nx); ny = np.concatenate(ny)
        nw = np.concatenate(nw); nh = np.concatenate(nh)
        # prune: only NEW rects can be contained / contain others (untouched
        # free rects were already mutually maximal) -> O(new * F), not O(F^2)
        if len(nx):
            def contained(ax, ay, aw, ah, bx, by, bw, bh):
                return (
                    (ax[:, None] >= bx[None]) & (ay[:, None] >= by[None])
                    & (ax[:, None] + aw[:, None] <= bx[None] + bw[None])
                    & (ay[:, None] + ah[:, None] <= by[None] + bh[None])
                )
            # containment can only involve old rects intersecting the hit
            # region's bbox: prefilter before the quadratic scans (the free
            # set grows to thousands; this keeps the scan local)
            bx0, by0 = hx.min(), hy.min()
            bx1 = (hx + hw).max()
            by1 = (hy + hh).max()
            near = ((ox_ < bx1) & (ox_ + ow_ > bx0)
                    & (oy_ < by1) & (oy_ + oh_ > by0))
            ni = np.nonzero(near)[0]
            # new-in-old or new-in-new (ties broken by index)
            c_no = contained(nx, ny, nw, nh,
                             ox_[ni], oy_[ni], ow_[ni], oh_[ni]).any(axis=1)
            c_nn = contained(nx, ny, nw, nh, nx, ny, nw, nh)
            np.fill_diagonal(c_nn, False)
            dup = c_nn & c_nn.T
            c_nn &= ~(dup & (np.arange(len(nx))[:, None] < np.arange(len(nx))[None]))
            keep_n = ~(c_no | c_nn.any(axis=1))
            nx, ny, nw, nh = nx[keep_n], ny[keep_n], nw[keep_n], nh[keep_n]
            # old-in-new (same prefilter)
            if len(nx) and len(ni):
                c_on = contained(ox_[ni], oy_[ni], ow_[ni], oh_[ni],
                                 nx, ny, nw, nh).any(axis=1)
                drop = np.zeros(len(ox_), bool)
                drop[ni[c_on]] = True
                ox_, oy_, ow_, oh_ = (ox_[~drop], oy_[~drop],
                                      ow_[~drop], oh_[~drop])
        fx = np.concatenate([ox_, nx]); fy = np.concatenate([oy_, ny])
        fw = np.concatenate([ow_, nw]); fh = np.concatenate([oh_, nh])
    placed = [(p, s) for p, s in zip(pos, sizes) if p is not None]
    used_w = max((p[0] + s[0] for p, s in placed), default=0)
    used_h = max((p[1] + s[1] for p, s in placed), default=0)
    return pos, used_w, used_h


def _pack_skyline_pages(
    sizes: List[Tuple[int, int]], max_w: int, max_h: int
) -> Tuple[List[Tuple[int, int]], np.ndarray, int, int]:
    """Shelf packing straight into multiple atlas pages: O(n log n), the
    packer for VERY large patch counts (MaxRects' free-rect set is
    super-linear; at ~1M rects it dominates the whole texture stage).
    Returns (pos, page, used_w, used_h); shelves that no longer fit the
    current page start the next one."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i][1])
    pos: List[Tuple[int, int]] = [(0, 0)] * len(sizes)
    page = np.zeros(len(sizes), np.int64)
    pg = 0
    shelf_y = 0
    shelf_h = 0
    x = 0
    used_w = 0
    used_h = 0
    for i in order:
        w, h = sizes[i]
        if x + w > max_w and x > 0:
            shelf_y += shelf_h
            x = 0
            shelf_h = 0
        if shelf_y + h > max_h and shelf_y > 0:
            pg += 1
            shelf_y = 0
            shelf_h = 0
            x = 0
        pos[i] = (x, shelf_y)
        page[i] = pg
        x += w
        shelf_h = max(shelf_h, h)
        used_w = max(used_w, x)
        used_h = max(used_h, shelf_y + shelf_h)
    return pos, page, used_w, used_h


def _pack_skyline(sizes: List[Tuple[int, int]], max_w: int) -> Tuple[List[Tuple[int, int]], int, int]:
    """Simple shelf packing (RectsBinPack role, RectsBinPack.h:57-420):
    sorted by height, placed left-to-right in shelves."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i][1])
    pos = [(0, 0)] * len(sizes)
    shelf_y = 0
    shelf_h = 0
    x = 0
    used_w = 0
    for i in order:
        w, h = sizes[i]
        if x + w > max_w and x > 0:
            shelf_y += shelf_h
            x = 0
            shelf_h = 0
        pos[i] = (x, shelf_y)
        x += w
        shelf_h = max(shelf_h, h)
        used_w = max(used_w, x)
    return pos, used_w, shelf_y + shelf_h


def generate_texture(
    scene: Scene, mesh: Mesh, labels: np.ndarray, opts: TextureOptions,
    max_dim: int, adj: Optional[np.ndarray] = None,
    stats: Optional[dict] = None,
) -> Mesh:
    """Patch extraction + atlas packing + texcoords (GenerateTexture,
    SceneTexture.cpp:344-2327). ``stats``, if given, receives the patch and
    page counts, the atlas size and the seconds of global leveling, local
    leveling and sharpening (``stages_s``)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    nf = len(mesh.faces)
    if adj is None:
        adj = _face_adjacency(mesh.faces)
    # components of same-label connected faces
    rows, cols = [], []
    for k in range(3):
        nb = adj[:, k]
        ok = (nb >= 0) & (labels == labels[np.where(nb >= 0, nb, 0)]) & (labels >= 0)
        rows.append(np.nonzero(ok)[0])
        cols.append(nb[ok])
    g = coo_matrix(
        (np.ones(sum(len(r) for r in rows)), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nf, nf),
    )
    ncomp, comp = connected_components(g, directed=False)

    # build patches — fully vectorized (one scatter-min/max over components
    # instead of a Python loop with np.unique per patch; measured: the old
    # loop dominated the stage at 13k+ patches)
    patches: List[_Patch] = []
    projs = {}
    pad = 2
    for view in np.unique(labels[labels >= 0]):
        # f32 is plenty for pixel coordinates (<= 1e-4 px at 8k images) and
        # halves the largest per-view array (5M verts x 3 x 8B x V views)
        projs[int(view)] = _project(
            scene.images[int(view)].working_camera(),
            mesh.vertices.astype(np.float64)).astype(np.float32)
    _t_patch = timed(log, f"build {ncomp} patches")
    _t_patch.__enter__()
    comp_min_u = np.full(ncomp, np.inf)
    comp_min_v = np.full(ncomp, np.inf)
    comp_max_u = np.full(ncomp, -np.inf)
    comp_max_v = np.full(ncomp, -np.inf)
    comp_view = np.full(ncomp, -1, np.int64)
    valid_f = labels >= 0
    comp_view[comp[valid_f]] = labels[valid_f]
    for view in projs:
        m = valid_f & (labels == view)
        if not m.any():
            continue
        pr = projs[view]
        fuv = pr[mesh.faces[m]][..., :2]          # (mF, 3, 2)
        ci = comp[m]
        np.minimum.at(comp_min_u, ci, fuv[..., 0].min(axis=1))
        np.minimum.at(comp_min_v, ci, fuv[..., 1].min(axis=1))
        np.maximum.at(comp_max_u, ci, fuv[..., 0].max(axis=1))
        np.maximum.at(comp_max_v, ci, fuv[..., 1].max(axis=1))
    # faces grouped per component via one argsort; bbox clipping vectorized
    # over ALL components at once (a per-component numpy-scalar loop cost
    # ~40 s at 840k patches), the cheap python loop only builds the objects
    order = np.argsort(comp, kind="stable").astype(np.int32)
    comp_sorted = comp[order]
    starts = np.searchsorted(comp_sorted, np.arange(ncomp))
    ends = np.searchsorted(comp_sorted, np.arange(ncomp) + 1)
    img_h = np.array([im.gray.shape[0] for im in scene.images], np.int64)
    img_w = np.array([im.gray.shape[1] for im in scene.images], np.int64)
    cv_safe = np.maximum(comp_view, 0)
    Wv = img_w[cv_safe]
    Hv = img_h[cv_safe]
    cx0 = np.clip(np.floor(comp_min_u) - pad, 0,
                  np.maximum(Wv - 1, 0)).astype(np.int64)
    cy0 = np.clip(np.floor(comp_min_v) - pad, 0,
                  np.maximum(Hv - 1, 0)).astype(np.int64)
    cx1 = np.clip(np.ceil(comp_max_u) + pad, cx0 + 1, Wv).astype(np.int64)
    cy1 = np.clip(np.ceil(comp_max_v) + pad, cy0 + 1, Hv).astype(np.int64)
    ok_c = (comp_view >= 0) & np.isfinite(comp_min_u)
    cvl = comp_view.tolist()
    x0l, y0l = cx0.tolist(), cy0.tolist()
    wl = (cx1 - cx0).tolist()
    hl = (cy1 - cy0).tolist()
    sl, el = starts.tolist(), ends.tolist()
    for ci in np.nonzero(ok_c)[0].tolist():
        patches.append(_Patch(view=cvl[ci], faces=order[sl[ci]:el[ci]],
                              x0=x0l[ci], y0=y0l[ci], w=wl[ci], h=hl[ci]))

    if not patches:
        raise ValueError("no textured patches (no face has a visible view)")

    # split components larger than an atlas page by median cuts on face
    # centroids (the reference re-splits oversized components,
    # SceneTexture.cpp:1483-1788 / RectsBinPack.h:57)
    limit = opts.max_texture_size - 2 * pad - 2
    queue = patches
    patches = []
    while queue:
        p = queue.pop()
        if p.w <= limit and p.h <= limit:
            patches.append(p)
            continue
        pr = projs[p.view]
        cent = pr[mesh.faces[p.faces]][..., :2].mean(axis=1)   # (m, 2)
        axis = 0 if p.w >= p.h else 1
        med = np.median(cent[:, axis])
        left = cent[:, axis] <= med
        if left.all() or not left.any():
            left = cent[:, axis] <= cent[:, axis].mean()
        if left.all() or not left.any():   # degenerate: give up gracefully
            patches.append(p)
            continue
        for sel in (left, ~left):
            fs = p.faces[sel]
            fuv = pr[mesh.faces[fs]][..., :2]
            img = scene.images[p.view]
            H, W = img.gray.shape
            x0 = int(np.clip(np.floor(fuv[..., 0].min()) - pad, 0, W - 1))
            y0 = int(np.clip(np.floor(fuv[..., 1].min()) - pad, 0, H - 1))
            x1 = int(np.clip(np.ceil(fuv[..., 0].max()) + pad, x0 + 1, W))
            y1 = int(np.clip(np.ceil(fuv[..., 1].max()) + pad, y0 + 1, H))
            queue.append(_Patch(view=p.view, faces=fs, x0=x0, y0=y0,
                                w=x1 - x0, h=y1 - y0))

    _t_patch.__exit__(None, None, None)
    # pack
    _t_pack = timed(log, f"pack {len(patches)} rects")
    _t_pack.__enter__()
    max_w = opts.max_texture_size
    sizes = [(p.w, p.h) for p in patches]
    # target a square-ish power-of-2 atlas: bound the packing width by the
    # total patch area estimate instead of always spanning max_texture_size
    area = sum(w * h for w, h in sizes)
    wfit = max(max((w for w, _ in sizes), default=1),
               int(np.ceil(np.sqrt(area) * 1.1)))
    max_w = min(max_w, 1 << int(np.ceil(np.log2(max(wfit, 1)))))
    shelf_pages = None
    if len(sizes) >= SHELF_MIN:
        # very large patch counts: MaxRects is super-linear — pack shelves
        # straight into pages instead
        pos, shelf_pages, used_w, used_h = _pack_skyline_pages(
            sizes, max_w, opts.max_texture_size)
        if shelf_pages.max() > 0:
            log.info("texture atlas split into %d pages (shelf packer)",
                     int(shelf_pages.max()) + 1)
    elif opts.rect_packing_heuristic >= 0:
        pos, used_w, used_h = _pack_maxrects(
            sizes, max_w, opts.rect_packing_heuristic,
            max_h=opts.max_texture_size,
        )
    else:  # negative heuristic selects the cheap shelf packer
        pos, used_w, used_h = _pack_skyline(sizes, max_w)
        if used_h > opts.max_texture_size:
            pos = [None] * len(sizes)  # force multi-page via MaxRects
            used_w = used_h = 0
    patch_page = (shelf_pages if shelf_pages is not None
                  else np.zeros(len(patches), np.int64))
    if any(q is None for q in pos):
        # multi-page atlas (SceneTexture multi-texture support,
        # SceneTexture.cpp:2270-2327): pack remaining patches page by page.
        # When NOTHING is placed yet (skyline overflow reset) the first
        # batch must land on page 0, not leave it empty
        page = -1 if all(q is None for q in pos) else 0
        remaining = [i for i, q in enumerate(pos) if q is None]
        while remaining:
            page += 1
            placeable = [False] * len(sizes)
            for i in remaining:
                placeable[i] = True
            pg_pos, pw, ph = _pack_maxrects(
                sizes, opts.max_texture_size,
                max(opts.rect_packing_heuristic, 0),
                max_h=opts.max_texture_size, placeable=placeable,
            )
            placed_now = [i for i in remaining if pg_pos[i] is not None]
            if not placed_now:
                # cannot happen after the oversized-component split above,
                # except for pathological packings: fail loudly
                raise ValueError("texture patch larger than one atlas page")
            for i in placed_now:
                pos[i] = pg_pos[i]
                patch_page[i] = page
            used_w = max(used_w, pw)
            used_h = max(used_h, ph)
            remaining = [i for i in remaining if pg_pos[i] is None]
        log.info("texture atlas split into %d pages", page + 1)
    n_pages = int(patch_page.max()) + 1
    if opts.texture_size_multiple > 1:
        # round atlas dims up to the requested multiple
        # (RectsBinPack::ComputeTextureSize nTextureSizeMultiple role)
        m = opts.texture_size_multiple
        tw = -(-max(used_w, 1) // m) * m
        th = -(-max(used_h, 1) // m) * m
    else:
        tw = 1 << int(np.ceil(np.log2(max(used_w, 1))))
        th = 1 << int(np.ceil(np.log2(max(used_h, 1))))
    tw = min(tw, opts.max_texture_size)
    th = min(th, opts.max_texture_size)
    pages = []
    # empty-pixel marker color from the nEmptyColor knob (0x00BBGGRR packed,
    # reference TextureMesh --empty-color; default 0x00FF7F27 = RGB(39,127,255))
    ec = opts.empty_color
    empty_rgb = (ec & 0xFF, (ec >> 8) & 0xFF, (ec >> 16) & 0xFF)
    for _ in range(n_pages):
        a = np.zeros((th, tw, 3), np.uint8)
        a[:] = empty_rgb
        pages.append(a)
    atlas = pages[0]

    _t_pack.__exit__(None, None, None)
    _t_copy = timed(log, "patch copies + texcoords")
    _t_copy.__enter__()
    # per-patch rect copies: plain numpy slice assignment is already memory-
    # bandwidth bound and beats flat gather/scatter index construction
    # (measured at 840k patches: ~9 s loop vs ~100 s / +5 GB flat indices)
    page_l = patch_page.tolist()
    for pi_, (p, q) in enumerate(zip(patches, pos)):
        ax, ay = q
        p.atlas_x, p.atlas_y = ax, ay
        img = scene.images[p.view]
        tile = img.color[p.y0 : p.y0 + p.h, p.x0 : p.x0 + p.w]
        pages[page_l[pi_]][ay : ay + p.h, ax : ax + p.w] = tile
    np_ = len(patches)
    p_w = np.fromiter((p.w for p in patches), np.int64, np_)
    p_h = np.fromiter((p.h for p in patches), np.int64, np_)
    p_x0 = np.fromiter((p.x0 for p in patches), np.int64, np_)
    p_y0 = np.fromiter((p.y0 for p in patches), np.int64, np_)
    p_ax = np.fromiter((p.atlas_x for p in patches), np.int64, np_)
    p_ay = np.fromiter((p.atlas_y for p in patches), np.int64, np_)
    p_view = np.fromiter((p.view for p in patches), np.int64, np_)

    # texcoords per face (vectorized over all faces at once)
    ftc = np.zeros((nf, 3, 2), np.float32)
    face_dx = np.zeros(nf, np.float32)
    face_dy = np.zeros(nf, np.float32)
    face_view = np.full(nf, -1, np.int32)
    face_page = np.zeros(nf, np.int32)
    face_x0 = np.zeros(nf, np.float32)
    face_y0 = np.zeros(nf, np.float32)
    face_x1 = np.ones(nf, np.float32)
    face_y1 = np.ones(nf, np.float32)
    counts = np.fromiter((len(p.faces) for p in patches), np.int64, np_)
    # int32 index arrays: at 10M faces the int64 versions alone held
    # ~320 MB (order/all_f/fpid) — face counts fit int32 with headroom
    all_f = (np.concatenate([p.faces for p in patches]).astype(np.int32,
                                                               copy=False)
             if np_ else np.zeros(0, np.int32))
    fpid = np.repeat(np.arange(np_, dtype=np.int32), counts)
    face_dx[all_f] = (p_ax - p_x0)[fpid]
    face_dy[all_f] = (p_ay - p_y0)[fpid]
    face_view[all_f] = p_view[fpid]
    face_page[all_f] = patch_page[fpid]
    face_x0[all_f] = p_x0[fpid]
    face_y0[all_f] = p_y0[fpid]
    face_x1[all_f] = (p_x0 + p_w - 1)[fpid]
    face_y1[all_f] = (p_y0 + p_h - 1)[fpid]
    views_used = sorted({p.view for p in patches})
    proj_stack = np.zeros((max(views_used) + 1, len(mesh.vertices), 2),
                          np.float32)
    for vv in views_used:
        proj_stack[vv] = projs[vv][:, :2]
    mapped = face_view >= 0
    mi_all = np.nonzero(mapped)[0].astype(np.int32)
    # texcoords on the MAPPED subset only, in CHUNKS: at 10M faces the
    # one-shot (m, 3, 2) uv temporary + clamp intermediates held ~0.5 GB
    # at exactly the stage that was the whole pipeline's RSS peak
    for c0 in range(0, len(mi_all), 2_000_000):
        mi = mi_all[c0:c0 + 2_000_000]
        uv_f = proj_stack[face_view[mi][:, None], mesh.faces[mi]]  # (m,3,2)
        # clamp projections into the face's patch rect: a vertex projecting
        # outside the image (border faces) must sample its own patch's edge
        # texels, not a neighboring patch or empty atlas space
        uv_f[..., 0] = np.clip(uv_f[..., 0], face_x0[mi, None],
                               face_x1[mi, None])
        uv_f[..., 1] = np.clip(uv_f[..., 1], face_y0[mi, None],
                               face_y1[mi, None])
        ftc[mi, :, 0] = np.clip((uv_f[..., 0] + face_dx[mi, None]) / tw,
                                0.0, 1.0)
        ftc[mi, :, 1] = np.clip(
            1.0 - (uv_f[..., 1] + face_dy[mi, None]) / th, 0.0, 1.0)
    del (proj_stack, uv_f, face_dx, face_dy, face_x0, face_y0, face_x1,
         face_y1, mi_all, mi, mapped)
    # index scaffolding dead past this point — free BEFORE the leveling
    # stages so their own transients ride a lower resident base
    del all_f, fpid, counts, order, comp_sorted, starts, ends
    del cx0, cy0, cx1, cy1, Wv, Hv, comp_view, cv_safe, ok_c
    _t_copy.__exit__(None, None, None)

    if stats is not None:
        stats.update(patches=len(patches), pages=n_pages, atlas_wh=(tw, th))
    if opts.global_seam_leveling:
        with _stage(stats, "global_leveling", "global seam leveling"):
            # offsets live on mesh vertices, so leveling spans ALL pages
            _global_seam_leveling(scene, mesh, patches, projs, pages, tw, th,
                                  ftc, patch_page=patch_page)
    projs.clear()              # per-view (nv, 3) arrays: dead past leveling
    if opts.local_seam_leveling:
        with _stage(stats, "local_leveling", "local seam leveling"):
            # per page: diffusion is confined to patch rects; cross-page
            # seams were already reconciled by the global (vertex) pass
            for pg in range(n_pages):
                psel = [p for pi, p in enumerate(patches)
                        if patch_page[pi] == pg]
                _local_seam_leveling(mesh, psel, adj, pages[pg], tw, th, ftc)
    if opts.sharpness_weight > 0:
        # unsharp-mask sharpening (TextureMesh nSharpen, SceneTexture.cpp:2270)
        _t_sh = _stage(stats, "sharpen", "sharpen")
        _t_sh.__enter__()
        # banded: a full-page float copy + blur temp cost ~1.6 GB at 8k^2;
        # 1024-row bands with 16-px overlap (sigma 1.5 kernel ~ 9 px) are
        # exact away from the seam and indistinguishable at it
        SB, OV = 1024, 16
        for pg in pages:
            Hp = pg.shape[0]
            for y0 in range(0, Hp, SB):
                lo = max(0, y0 - OV)
                hi = min(Hp, y0 + SB + OV)
                a = pg[lo:hi].astype(np.float32)
                blur = imio.gaussian_blur(a, 1.5)
                out = np.clip(a + opts.sharpness_weight * (a - blur),
                              0, 255).astype(np.uint8)
                pg[y0:min(Hp, y0 + SB)] = out[y0 - lo:y0 - lo + SB]

        _t_sh.__exit__(None, None, None)
    out = Mesh(vertices=mesh.vertices, faces=mesh.faces,
               face_tex_coords=ftc, texture=pages[0],
               textures=pages if n_pages > 1 else None,
               face_page=face_page if n_pages > 1 else None)
    log.info("texture atlas %dx%d, %d patches", tw, th, len(patches))
    return out


def _global_seam_leveling(scene, mesh, patches, projs, atlas_pages, tw, th,
                          ftc, patch_page=None):
    """Per-(patch, vertex) color offsets solved as a Tikhonov-regularized
    least squares by conjugate gradient (GlobalSeamLeveling,
    SceneTexture.cpp:1483-1640): seam vertices shared by two patches pull
    their sampled colors together; within-patch smoothness keeps the
    correction field gentle.  Fully vectorized setup (unknowns via one
    np.unique over (patch, vertex) corner keys); works across MULTIPLE atlas
    pages (the offsets live on mesh vertices, the final rasterization runs
    once per page)."""
    from scipy.sparse import coo_matrix

    if isinstance(atlas_pages, np.ndarray):
        atlas_pages = [atlas_pages]
    nf = len(mesh.faces)
    nv = len(mesh.vertices)
    npatch = len(patches)
    fpatch = np.full(nf, -1, np.int64)
    view_of_patch = np.fromiter((p.view for p in patches), np.int64, npatch)
    if npatch:
        _cnt = np.fromiter((len(p.faces) for p in patches), np.int64, npatch)
        fpatch[np.concatenate([p.faces for p in patches])] = np.repeat(
            np.arange(npatch), _cnt)
    valid_f = fpatch >= 0
    fv = mesh.faces[valid_f].astype(np.int64)          # (m, 3)
    fp = fpatch[valid_f]
    del fpatch
    keys = fp[:, None] * nv + fv                        # (m, 3)
    del fv
    uniq_keys, inv = np.unique(keys, return_inverse=True)
    del keys
    inv = inv.reshape(-1, 3).astype(np.int32)   # unknown count << 2^31
    n = len(uniq_keys)
    if n == 0:
        return
    upatch = uniq_keys // nv
    uvert = (uniq_keys % nv).astype(np.int32)
    del uniq_keys

    # sampled color per unknown: the vertex projected into its patch's
    # view.  f32 + per-view projs.pop: each (nv, 3) projection dies as
    # soon as it is sampled (the caller clears the dict right after this
    # function anyway) — ~60 MB/view at 5M vertices
    c = np.zeros((n, 3), np.float32)
    uviews = view_of_patch[upatch].astype(np.int32)
    for view in np.unique(uviews):
        m = uviews == view
        pr = projs.pop(int(view))
        img = scene.images[int(view)].color
        H, W = img.shape[:2]
        ui = np.clip(pr[uvert[m], 0].astype(np.int64), 0, W - 1)
        wi = np.clip(pr[uvert[m], 1].astype(np.int64), 0, H - 1)
        c[m] = img[wi, ui]
        del pr

    # seam pairs: chain unknowns sharing a mesh vertex (sorted runs); the
    # chain couples the same connected groups as the reference's all-pairs
    order = np.argsort(uvert, kind="stable")
    sv = uvert[order]
    run = sv[1:] == sv[:-1]
    rows_i = order[:-1][run]
    rows_j = order[1:][run]
    if len(rows_i) == 0:
        return
    # smoothness: the 3 edges of every labeled face, deduplicated
    e_i = np.concatenate([inv[:, 0], inv[:, 1], inv[:, 2]])
    e_j = np.concatenate([inv[:, 1], inv[:, 2], inv[:, 0]])
    ekey = np.minimum(e_i, e_j) * n + np.maximum(e_i, e_j)
    _, first = np.unique(ekey, return_index=True)
    e_i, e_j = e_i[first], e_j[first]
    keep = e_i != e_j
    e_i, e_j = e_i[keep], e_j[keep]
    lam = 0.1

    def laplacian(i, j):
        # f32 data + int32 indices: halves the COO/CSR transients (the
        # unknown count n < 2^31 always; offsets feed an 8-bit atlas)
        i = np.asarray(i, np.int32)
        j = np.asarray(j, np.int32)
        one = np.ones(len(i), np.float32)
        data = np.concatenate([one, one, -one, -one])
        r = np.concatenate([i, j, i, j])
        col = np.concatenate([i, j, j, i])
        return coo_matrix((data, (r, col)), shape=(n, n)).tocsr()

    Lp = laplacian(rows_i, rows_j)
    M = Lp + (lam * laplacian(e_i, e_j) if len(e_i) else 0)
    _di = np.arange(n, dtype=np.int32)
    M = M + coo_matrix((np.full(n, 1e-6, np.float32), (_di, _di)),
                       shape=(n, n))
    # Jacobi-preconditioned block CG: one csr matmat per iteration for all
    # 3 channels (3 separate scipy cg() calls cost 600 serial matvecs at
    # 500k faces); the atlas is 8-bit, so rtol 2e-3 on the offsets is
    # already below quantization
    # float32 CG: the offsets feed an 8-bit atlas at rtol 2e-3 — well below
    # f32 precision; halves every (n, 3) CG vector and the CSR data
    M = M.astype(np.float32)
    Lp = Lp.astype(np.float32)
    c = c.astype(np.float32)
    B = -(Lp @ c)
    X = np.zeros_like(B)
    R = B.copy()
    dinv = (1.0 / np.maximum(M.diagonal(), 1e-12)).astype(np.float32)
    Z = R * dinv[:, None]
    P = Z.copy()
    rz = (R * Z).sum(axis=0)
    b0 = np.maximum(np.linalg.norm(B, axis=0), 1e-12)
    for _ in range(100):
        Q = M @ P
        alpha = rz / np.maximum((P * Q).sum(axis=0), 1e-30)
        X += alpha * P
        R -= alpha * Q
        if (np.linalg.norm(R, axis=0) < 2e-3 * b0).all():
            break
        Z = R * dinv[:, None]
        rz_new = (R * Z).sum(axis=0)
        P = Z + (rz_new / np.maximum(rz, 1e-30)) * P
        rz = rz_new
    g = np.clip(X, -60, 60)

    # rasterize offsets into each atlas page in texture space.  CORNER-SPLIT
    # vertex buffer: a mesh vertex shared by several patches has a DIFFERENT
    # atlas uv per patch, so per-vertex positions would mix patches (huge
    # bogus face spans — measured 10s of rasterization and seam bleeding);
    # per-corner expansion gives each face its own unambiguous uv triple.
    # per-UNKNOWN offsets; each corner looks up its own (patch, vertex).
    # Rasterization runs over PATCH-ALIGNED FACE CHUNKS x horizontal bands:
    # the full corner expansion (exp_verts f64 + the rasterizer's own f64
    # copy) cost ~1.5 GB at 10M faces — the round-5 RSS profile's largest
    # leveling spike.  Chunks are exact: atlas packing keeps different
    # patches' rects disjoint (pad >= 2), so faces from different chunks
    # never touch the same texel and each texel's offset is applied once.
    m = len(fp)
    vidx = np.nonzero(valid_f)[0].astype(np.int64)
    if patch_page is None:
        page_of_patch = np.zeros(npatch, np.int64)
    else:
        page_of_patch = np.asarray(patch_page, np.int64)
    ordp = np.argsort(fp, kind="stable").astype(np.int64)
    fp_sorted = fp[ordp]
    BAND = min(th, 2048)
    start = 0
    while start < m:
        end = min(start + LEVEL_CHUNK, m)
        if end < m:
            pe = fp_sorted[end - 1]
            while end < m and fp_sorted[end] == pe:
                end += 1
        sel = ordp[start:end]
        mc = len(sel)
        corner_uv = ftc[vidx[sel]]                      # (mc, 3, 2) f32
        exp_verts = np.empty((3 * mc, 3))
        exp_verts[:, 0] = corner_uv[..., 0].ravel() * tw
        exp_verts[:, 1] = (1.0 - corner_uv[..., 1].ravel()) * th
        exp_verts[:, 2] = 1.0
        del corner_uv
        exp_off = g[inv[sel]].reshape(3 * mc, 3)        # f32
        exp_faces = np.arange(3 * mc, dtype=np.int32).reshape(mc, 3)
        pg_sel = page_of_patch[fp[sel]]
        for pg, atlas in enumerate(atlas_pages):
            fsel = np.nonzero(pg_sel == pg)[0]
            if len(fsel) == 0:
                continue
            ef = exp_faces[fsel]
            for y0 in range(0, th, BAND):
                bh = min(BAND, th - y0)
                vb = exp_verts if y0 == 0 and bh == th else (
                    exp_verts - np.array([0.0, y0, 0.0]))
                fid, _, bar = native.rasterize(vb, ef, bh, tw)
                ys, xs = np.nonzero(fid >= 0)
                if len(ys) == 0:
                    continue
                # gather only at covered texels (full-page (H,W,3,3) f64
                # temporaries measured 10s+ per call)
                fvp = ef[fid[ys, xs]]                   # (n_hit, 3)
                o = (exp_off[fvp] * bar[ys, xs][..., None]).sum(axis=1)
                px = (atlas[y0 + ys, xs].astype(np.int16)
                      + np.round(o).astype(np.int16))
                atlas[y0 + ys, xs] = np.clip(px, 0, 255).astype(np.uint8)
        start = end


def _local_seam_leveling(mesh, patches, adj, atlas, tw, th, ftc,
                         iters: int = 16, strength: float = 1.0):
    """Blend residual color steps across patch seams (LocalSeamLeveling,
    SceneTexture.cpp:1642-1788): seam texels are pulled to the mean of the
    two patches' colors along the shared mesh edge, and the correction is
    diffused into each patch interior by normalized blurring confined to the
    patch rect (so corrections fade with distance and never cross unrelated
    patches).  Runs after global leveling, on the leveled atlas."""
    nf = len(mesh.faces)
    fpatch = np.full(nf, -1, np.int64)
    if patches:
        counts = np.fromiter((len(p.faces) for p in patches), np.int64,
                             len(patches))
        fpatch[np.concatenate([p.faces for p in patches])] = np.repeat(
            np.arange(len(patches)), counts)
    f = np.asarray(mesh.faces)
    idx = np.arange(nf)
    fi_all, fj_all = [], []
    for k in range(3):
        nb = adj[:, k]
        nbs = np.maximum(nb, 0)
        sel = (nb >= 0) & (nb > idx) & (fpatch >= 0) & (fpatch[nbs] >= 0) \
            & (fpatch != fpatch[nbs])
        fi_all.append(idx[sel])
        fj_all.append(nb[sel])
    fi = np.concatenate(fi_all)
    fj = np.concatenate(fj_all)
    if len(fi) == 0:
        return
    va, vb = f[fi], f[fj]
    eq = va[:, :, None] == vb[:, None, :]         # (m, 3, 3)
    sa = eq.any(axis=2)
    ok = (sa.sum(axis=1) == 2) & (eq.any(axis=1).sum(axis=1) == 2)
    fi, fj, sa, eq = fi[ok], fj[ok], sa[ok], eq[ok]
    m = len(fi)
    if m == 0:
        return
    ia = np.argsort(~sa, axis=1, kind="stable")[:, :2]   # shared corners in a
    e1 = eq[np.arange(m), ia[:, 0]]
    e2 = eq[np.arange(m), ia[:, 1]]
    ib = np.stack([e1.argmax(axis=1), e2.argmax(axis=1)], axis=1)
    uva = ftc[fi[:, None], ia]                    # (m, 2, 2)
    uvb = ftc[fj[:, None], ib]
    S = 8
    t = np.linspace(0.0, 1.0, S)[None, :, None]
    pa = (1 - t) * uva[:, 0:1] + t * uva[:, 1:2]  # (m, S, 2)
    pb = (1 - t) * uvb[:, 0:1] + t * uvb[:, 1:2]

    # gather seam samples straight from the uint8 atlas (a full-page float
    # conversion + ufunc.at scatters measured ~15 s at 500k faces); the
    # scatters run as bincounts over linear texel indices
    def px(uv):
        # int32 linear indices (page texel count < 2^31 at <= 16k pages)
        x = np.clip((uv[..., 0] * tw).astype(np.int32), 0, tw - 1).ravel()
        y = np.clip(((1.0 - uv[..., 1]) * th).astype(np.int32), 0, th - 1).ravel()
        return y * np.int32(tw) + x

    la = px(pa)
    lb = px(pb)
    ca = atlas.reshape(-1, 3)[la].astype(np.float32)
    cb = atlas.reshape(-1, 3)[lb].astype(np.float32)
    half = 0.5 * (ca - cb)
    lin = np.concatenate([la, lb])
    dv = np.concatenate([-half, half])
    del la, lb, ca, cb, half, pa, pb, uva, uvb, eq, sa, e1, e2
    liny = (lin // np.int32(tw)).astype(np.int32)

    # the correction/weight fields are built and applied in horizontal
    # BANDS of whole patch rects (an 8k page's full-page f32 corr+wgt held
    # 1.07 GB — the round-5 RSS peak); rects never straddle bands, so the
    # per-patch diffusion is unchanged
    ordp = sorted(range(len(patches)), key=lambda i: patches[i].atlas_y)
    sat_dim = 2 * iters + 1
    BANDH = 2048
    bi = 0
    while bi < len(ordp):
        y0b = patches[ordp[bi]].atlas_y
        y1b = y0b + patches[ordp[bi]].h
        bj = bi + 1
        while bj < len(ordp):
            p = patches[ordp[bj]]
            new_y1 = max(y1b, p.atlas_y + p.h)
            if new_y1 - y0b > BANDH and y1b > y0b:
                break
            y1b = new_y1
            bj += 1
        band = [patches[i] for i in ordp[bi:bj]]
        bi = bj
        bh = y1b - y0b
        msk = (liny >= y0b) & (liny < y1b)
        lin_b = (lin[msk] - np.int64(y0b) * tw).astype(np.int64)
        dv_b = dv[msk]
        HWb = bh * tw
        corr = np.empty((HWb, 3), np.float32)
        for ch in range(3):
            corr[:, ch] = np.bincount(lin_b, weights=dv_b[:, ch],
                                      minlength=HWb)
        wgt = np.bincount(lin_b, minlength=HWb).astype(np.float32)
        del lin_b, dv_b
        corr = corr.reshape(bh, tw, 3)
        wgt = wgt.reshape(bh, tw)

        # small patches take the SATURATED limit of the normalized
        # diffusion: after `iters` 5x5 blurs the kernel support spans the
        # whole rect, and cc/ww converges to sum(corr)/sum(wgt) — apply
        # that mean directly in one vectorized pass over every small rect
        # (a per-patch blur loop cost minutes at ~1M tiny patches); large
        # patches keep the exact diffusion.
        small = [p for p in band
                 if 3 <= min(p.h, p.w) and max(p.h, p.w) <= sat_dim]
        CHUNK_TEXELS = 8_000_000
        i0 = 0
        while i0 < len(small):
            ar_run = 0
            i1 = i0
            while i1 < len(small) and ar_run < CHUNK_TEXELS:
                ar_run += small[i1].w * small[i1].h
                i1 += 1
            chunk = small[i0:i1]
            i0 = i1
            ns = len(chunk)
            s_w = np.fromiter((p.w for p in chunk), np.int32, ns)
            s_h = np.fromiter((p.h for p in chunk), np.int32, ns)
            s_x = np.fromiter((p.atlas_x for p in chunk), np.int32, ns)
            s_y = np.fromiter((p.atlas_y for p in chunk), np.int32, ns) - y0b
            ar = s_w * s_h
            tot = int(ar.sum())
            off = np.arange(tot, dtype=np.int32) - np.repeat(
                np.cumsum(ar, dtype=np.int32) - ar, ar)
            wrep = np.repeat(s_w, ar)
            ry = off // wrep
            rx = off - ry * wrep
            yy = np.repeat(s_y, ar) + ry
            xx = np.repeat(s_x, ar) + rx
            pid = np.repeat(np.arange(ns, dtype=np.int32), ar)
            wsum = np.bincount(pid, weights=wgt[yy, xx], minlength=ns)
            mean = np.zeros((ns, 3), np.float32)
            for ch in range(3):
                csum = np.bincount(pid, weights=corr[yy, xx, ch],
                                   minlength=ns)
                mean[:, ch] = np.where(wsum > 0,
                                       csum / np.maximum(wsum, 1e-6), 0)
            upd = (atlas[yy + y0b, xx].astype(np.float32)
                   + strength * mean[pid])
            atlas[yy + y0b, xx] = np.clip(upd, 0, 255).astype(np.uint8)

        for p in band:
            if 3 <= min(p.h, p.w) and max(p.h, p.w) <= sat_dim:
                continue      # handled by the saturated-mean pass above
            cy, cx = p.atlas_y - y0b, p.atlas_x
            ww = wgt[cy : cy + p.h, cx : cx + p.w]
            if ww.size == 0 or ww.max() <= 0:
                continue
            cc = corr[cy : cy + p.h, cx : cx + p.w].copy()
            ww = ww.copy()
            if min(p.h, p.w) < 3:
                continue
            for _ in range(iters):
                cc = imio.box_blur(cc, 5)
                ww = imio.box_blur(ww, 5)
            field = cc / np.maximum(ww, 1e-6)[..., None]
            field[ww < 1e-4] = 0
            ay = p.atlas_y      # atlas coords are absolute; cy is band-rel
            crop = (atlas[ay : ay + p.h, cx : cx + p.w].astype(np.float32)
                    + strength * field)
            atlas[ay : ay + p.h, cx : cx + p.w] = np.clip(
                crop, 0, 255).astype(np.uint8)


def texture_mesh(
    scene: Scene, mesh: Optional[Mesh] = None,
    opts: TextureOptions = TextureOptions(), device="cuda",
    stats: Optional[dict] = None,
) -> Mesh:
    """Full texturing pipeline: labeling + atlas (Scene::TextureMesh role).

    LBP labeling runs on ``device`` ("cuda" by default; raises without a
    card), everything else on the host. Every image needs its ``gray`` and
    ``color`` pixels in memory. ``stats``, if given, receives the seconds of
    each stage (``stages_s``), the labels, the unseen share, whether the
    MRF was restricted to the seen faces, and ``generate_texture``'s
    counts."""
    dev = device_mod.resolve(device)
    mesh = mesh if mesh is not None else scene.mesh
    if len(mesh.faces) == 0:
        raise ValueError("no mesh to texture")
    for i, img in enumerate(scene.images):
        if img.gray is not None and img.color is None:
            raise ValueError(f"image {i} has no color pixels to texture from")
    w0 = max(im.width for im in scene.images)
    h0 = max(im.height for im in scene.images)
    max_dim = imio.compute_max_resolution(
        w0, h0, opts.resolution_level, opts.min_resolution, 1 << 30
    )
    with _stage(stats, "qualities", "face qualities"):
        quality, face_colors = compute_face_qualities(scene, mesh, max_dim)
    if opts.outlier_threshold > 0:
        with _stage(stats, "outliers", "outlier views"):
            quality = remove_outlier_views(quality, face_colors,
                                           opts.outlier_threshold)
    del face_colors          # ~600 MB at 10M faces; not needed further
    with _stage(stats, "adjacency", "face adjacency"):
        adj = _face_adjacency(mesh.faces)
    lam = opts.ratio_data_smoothness * 10
    lam_edge = (
        virtual_face_lambda(mesh, adj, lam, opts.virtual_face_threshold)
        if opts.virtual_face_threshold > 0 else None
    )
    if opts.inference == "trws":
        labeler = label_faces_trws
    else:
        def labeler(q, a, sm, lam_edge=None):
            return label_faces_lbp(q, a, sm, lam_edge=lam_edge, device=dev)
    with _stage(stats, "labeling", f"{opts.inference} face labeling"):
        # faces with NO candidate view can only take label -1; when they
        # dominate (partially-observed meshes), restrict the MRF to the
        # faces with a candidate view plus their 1-ring (smoothness across
        # one unseen face still propagates; farther unseen chains carry
        # only uniform-data messages whose influence is ~0) and scatter
        # labels back.
        seen = quality.max(axis=1) > 0
        restricted = bool((~seen).mean() > 0.5 and len(seen) > 100_000)
        if restricted:
            act = seen.copy()
            nb = adj[seen].reshape(-1)
            act[nb[nb >= 0]] = True
            idx = np.nonzero(act)[0]
            remap = np.full(len(act), -1, adj.dtype)
            remap[idx] = np.arange(len(idx), dtype=adj.dtype)
            adj_sub = np.where(adj[idx] >= 0,
                               remap[np.maximum(adj[idx], 0)], -1)
            labels = np.full(len(act), -1, np.int64)
            labels[idx] = labeler(
                quality[idx], adj_sub, lam,
                lam_edge=lam_edge[idx] if lam_edge is not None else None)
        else:
            labels = labeler(quality, adj, lam, lam_edge=lam_edge)
    n_unseen = int((labels < 0).sum())
    log.info("labels: %d faces, %d unseen", len(labels), n_unseen)
    if stats is not None:
        stats.update(labels=labels, unseen_share=n_unseen / len(labels),
                     restricted_mrf=restricted)
    del quality, lam_edge      # (nf, V) + (nf, 3): dead past labeling
    with _stage(stats, "generate", "generate texture"):
        return generate_texture(scene, mesh, labels, opts, max_dim, adj=adj,
                                stats=stats)
