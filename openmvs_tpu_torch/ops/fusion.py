"""Depth-map fusion into a dense point cloud.

Vectorized re-design of DepthMapsData::FuseDepthMaps
(SceneDensify.cpp:1372-1646): the reference walks pixels of the
best-connected image first, claims agreeing pixels in neighbor depth maps,
and confidence-averages their unprojections.  Here each reference image is
processed as a whole-image batch: candidate points unproject in bulk,
project into every neighbor at once, and agreement / claiming is resolved
with vectorized z-tests and ownership maps.  Output quality matches the
greedy original (thresholds, weights, min-view counts identical); only the
intra-image visit order differs (batch instead of scanline).

Weight: Conf2Weight(conf, depth) = 1 / (max(1-conf, floor) * depth^2)
(SceneDensify.cpp:120-122; reference floor 0.03, ours calibrated to 0.09 —
see conf2weight) -- note conf here is the [0,1] confidence map, so 1-conf is
the residual NCC score.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.geometry.camera import Camera
from openmvs_tpu_torch.scene import PointCloud
from openmvs_tpu_torch.utils.log import span


@dataclass
class ViewDepthData:
    """Per-view inputs to fusion (working-resolution maps + camera)."""

    image_idx: int                 # index into scene.images
    image_id: int                  # image meta id
    camera: Camera                 # at depth-map resolution
    depth: np.ndarray              # (h, w) float32
    normal: Optional[np.ndarray]   # (h, w, 3) float32 camera space
    conf: Optional[np.ndarray]     # (h, w) float32 [0,1]
    color: Optional[np.ndarray]    # (h, w, 3) uint8
    neighbor_ids: Sequence[int]    # neighbor image ids


def conf2weight(conf: np.ndarray, depth: np.ndarray,
                floor: float = 0.09) -> np.ndarray:
    """Fusion weight of a depth sample (Conf2Weight, SceneDensify.cpp:120:
    1/(max(1-conf, 0.03) * depth^2)).

    The saturation floor is CALIBRATED to this estimator, not copied: the
    reference constant 0.03 caps weights against ITS estimator's confidence
    distribution (median valid conf ~0.70 on the bundled scene), while this
    estimator converges deeper (one extra block-synchronous iteration +
    exact-mode final rescoring; median valid conf ~0.86 with the
    float32-correct geometric term) — through 1/(1-conf) that difference
    alone doubles every visibility-ray weight and inflated the graph-cut
    surface ~1.9x past the reference parity band (35-45k clean faces,
    apps/Tests/Tests.cpp:97-99).  floor=0.09 restores reference-scale ray
    evidence: bundled scene lands at 222k pts / 80.7k raw / 40.4k clean vs
    the band centers (>=200k / >=75k / 35-45k); see
    scripts/dev_calibrate_r4.py for the calibration sweep."""
    # depth==0 marks an invalid pixel (padded slots, masked candidates):
    # give it zero weight instead of a divide-by-zero inf
    den = np.maximum(1.0 - conf, floor) * depth * depth
    return np.where(den > 0, 1.0 / np.where(den > 0, den, 1.0), 0.0)


class ViewProvider:
    """Serves ViewDepthData by image id for fusion.

    The streamed variant bounds fusion memory to O(max_cached) loaded depth
    maps (the role of the reference's ref-counted lazy dmap load/unload,
    DepthMap.h:217-218): maps are (re)loaded from .dmap files on demand and
    evicted LRU; conflict invalidations are kept as per-view overlays so an
    evicted-and-reloaded map keeps its zeroed pixels.
    """

    def __init__(self, view_ids: Sequence[int], loader, max_cached: int = 6,
                 neighbor_ids: Optional[Dict[int, Sequence[int]]] = None):
        from collections import OrderedDict

        self._ids = list(view_ids)
        self._loader = loader
        self._max = max(2, max_cached)
        self._cache: "OrderedDict[int, ViewDepthData]" = OrderedDict()
        self._invalid: Dict[int, np.ndarray] = {}   # vid -> linear idx array
        self._meta: Dict[int, tuple] = {}           # vid -> (shape, nbr_ids)
        if neighbor_ids:
            # pre-seeded neighbor lists let the connectivity ordering pass
            # run without loading every .dmap from disk first
            for vid, nbrs in neighbor_ids.items():
                self._meta[vid] = (None, tuple(nbrs))

    def ids(self) -> List[int]:
        return list(self._ids)

    def _load(self, vid: int) -> Optional[ViewDepthData]:
        v = self._loader(vid)
        if v is None:
            return None
        # invalidate() writes through reshape(-1), which is only a VIEW for
        # contiguous arrays — a cropped/transposed loader result would
        # silently swallow the zeroing
        if not v.depth.flags.c_contiguous:
            v.depth = np.ascontiguousarray(v.depth)
        inv = self._invalid.get(vid)
        if inv is not None and len(inv):
            v.depth.reshape(-1)[inv] = 0
        self._meta[vid] = (v.depth.shape, tuple(v.neighbor_ids))
        return v

    def get(self, vid: int) -> Optional[ViewDepthData]:
        if vid in self._cache:
            self._cache.move_to_end(vid)
            return self._cache[vid]
        v = self._load(vid)
        if v is None:
            return None
        self._cache[vid] = v
        if len(self._cache) > self._max:
            self._cache.popitem(last=False)
        return v

    def meta(self, vid: int):
        if vid not in self._meta:
            self.get(vid)
        return self._meta.get(vid)

    def invalidate(self, vid: int, lin: np.ndarray) -> None:
        v = self._cache.get(vid)
        if v is not None:
            v.depth.reshape(-1)[lin] = 0
        prev = self._invalid.get(vid)
        self._invalid[vid] = lin if prev is None else np.union1d(prev, lin)


class _InMemoryProvider(ViewProvider):
    """All views resident; depth maps are COPIED on entry so fusion's
    conflict invalidation never mutates the caller's arrays (reference
    semantics zero them in place, SceneDensify.cpp:1504-1603 — surprising
    for a functional API and unsafe for retries)."""

    def __init__(self, views: List[ViewDepthData]):
        self._views = {
            v.image_id: ViewDepthData(
                image_idx=v.image_idx, image_id=v.image_id, camera=v.camera,
                depth=v.depth.copy(), normal=v.normal, conf=v.conf,
                color=v.color, neighbor_ids=v.neighbor_ids)
            for v in views
        }
        super().__init__([v.image_id for v in views],
                         lambda vid: self._views.get(vid),
                         max_cached=len(views) + 1)



def fuse_depth_maps(
    views: Optional[List[ViewDepthData]] = None,
    opts: DenseOptions = None,
    estimate_color: bool = True,
    estimate_normal: bool = True,
    provider: Optional[ViewProvider] = None,
) -> PointCloud:
    """Greedy claim-based multi-view fusion (FuseDepthMaps,
    SceneDensify.cpp:1372-1646).

    Pass either `views` (all maps resident; inputs are copied, never
    mutated) or a `provider` (streamed: maps loaded from disk on demand,
    memory bounded by the provider's cache size)."""
    with span("fuse.prepare"):
        if provider is None:
            provider = _InMemoryProvider(views)
        n_min_fuse = opts.min_views_fuse
        w_floor = getattr(opts, "fuse_conf_weight_floor", 0.09)
        cos_normal_err = np.cos(np.radians(opts.normal_diff_threshold))
        # ownership: per view, map pixel -> fused point index (-1 free, -2 consumed)
        owner: Dict[int, np.ndarray] = {}

        def own(vid, shape):
            if vid not in owner:
                owner[vid] = np.full(shape, -1, np.int64)
            return owner[vid]

        # process best-connected images first (connection score = #neighbors)
        ids = provider.ids()
        order = sorted(ids, key=lambda vid: -len((provider.meta(vid) or ((), ()))[1]))

    all_pts: List[np.ndarray] = []
    all_views: List[np.ndarray] = []     # flattened (point, view) pairs
    all_weights: List[np.ndarray] = []
    all_counts: List[np.ndarray] = []
    all_colors: List[np.ndarray] = []
    all_normals: List[np.ndarray] = []
    next_point_idx = 0

    for vid in order:
        with span("fuse.neighbours", view=vid):
            ref = provider.get(vid)
            if ref is None:
                continue
            h, w = ref.depth.shape
            own_ref = own(ref.image_id, ref.depth.shape)
            yy, xx = np.nonzero((ref.depth > 0) & (own_ref == -1))
            if len(yy) == 0:
                continue
            d = ref.depth[yy, xx].astype(np.float64)
            conf = ref.conf[yy, xx] if ref.conf is not None else np.ones(len(d), np.float32)
            wgt = conf2weight(conf, d, w_floor)
            uv = np.stack([xx, yy], -1).astype(np.float64)
            X = ref.camera.unproject(uv, d)                       # world points
            if ref.normal is not None:
                Nw = ref.normal[yy, xx] @ ref.camera.R            # R^T n (row-vec form)
            else:
                Nw = np.tile(-ref.camera.R[2], (len(d), 1))
            n_cand = len(d)

            # accumulators (confidence-weighted)
            acc_X = X * wgt[:, None]
            acc_W = wgt.copy()
            acc_N = Nw * wgt[:, None]
            n_views_pt = np.ones(n_cand, np.int32)
            if estimate_color and ref.color is not None:
                acc_C = ref.color[yy, xx].astype(np.float64) * wgt[:, None]
            else:
                acc_C = np.zeros((n_cand, 3))

            member_rows: List[np.ndarray] = [np.arange(n_cand)]
            member_view_ids: List[np.ndarray] = [np.full(n_cand, ref.image_id, np.uint32)]
            member_weights: List[np.ndarray] = [wgt.astype(np.float32)]
            # remember claimed pixels per neighbor so losers can be released
            claims: List[tuple] = []  # (view_id, candidate_rows, lin_pixels)
            conflicts: List[tuple] = []  # (view_id, candidate_rows, lin_pixels)

            for nb_id in ref.neighbor_ids:
                nb = provider.get(nb_id)
                if nb is None:
                    continue
                hb, wb = nb.depth.shape
                pb = nb.camera.project_h(X)
                zb = pb[:, 2]
                front = zb > 0
                pxb = np.where(front, pb[:, 0] / np.where(front, zb, 1), -1)
                pyb = np.where(front, pb[:, 1] / np.where(front, zb, 1), -1)
                ix = np.round(pxb).astype(np.int64)
                iy = np.round(pyb).astype(np.int64)
                inside = front & (ix >= 0) & (ix < wb) & (iy >= 0) & (iy < hb)
                ix_c = np.clip(ix, 0, wb - 1)
                iy_c = np.clip(iy, 0, hb - 1)
                db = nb.depth[iy_c, ix_c].astype(np.float64)
                own_nb = own(nb.image_id, nb.depth.shape)
                free = own_nb[iy_c, ix_c] == -1
                has_depth = inside & (db > 0) & free
                similar = has_depth & (np.abs(zb - db) < opts.depth_diff_threshold * zb)
                if nb.normal is not None:
                    Nb = nb.normal[iy_c, ix_c] @ nb.camera.R
                else:
                    Nb = np.tile(-nb.camera.R[2], (n_cand, 1))
                agree = similar & (np.einsum("ij,ij->i", Nw, Nb) > cos_normal_err)

                # resolve claim conflicts: multiple candidates may hit one pixel;
                # keep the first in scan order (matches greedy visit order)
                lin = iy_c * wb + ix_c
                cand_idx = np.nonzero(agree)[0]
                if len(cand_idx):
                    lin_a = lin[cand_idx]
                    uniq, first_pos = np.unique(lin_a, return_index=True)
                    winners = cand_idx[first_pos]
                    agree = np.zeros_like(agree)
                    agree[winners] = True
                    # accumulate neighbor contribution
                    cb = nb.conf[iy_c[winners], ix_c[winners]] if nb.conf is not None else np.ones(len(winners), np.float32)
                    dbw = db[winners]
                    wb_ = conf2weight(cb, dbw, w_floor)
                    uvb = np.stack([ix_c[winners], iy_c[winners]], -1).astype(np.float64)
                    Xb = nb.camera.unproject(uvb, dbw)
                    acc_X[winners] += Xb * wb_[:, None]
                    acc_W[winners] += wb_
                    acc_N[winners] += Nb[winners] * wb_[:, None]
                    n_views_pt[winners] += 1
                    if estimate_color and nb.color is not None:
                        acc_C[winners] += nb.color[iy_c[winners], ix_c[winners]].astype(np.float64) * wb_[:, None]
                    member_rows.append(winners)
                    member_view_ids.append(np.full(len(winners), nb.image_id, np.uint32))
                    member_weights.append(wb_.astype(np.float32))
                    claims.append((nb.image_id, winners, lin_a[first_pos]))
                    # neighbor depths the fused point sits in FRONT of: B
                    # measured a surface BEHIND the point, i.e. claims free
                    # space where the point is (SceneDensify.cpp:1572
                    # `if (pt.z < depthB) invalidDepths += &depthB`; similar
                    # depths whose normals disagree fall through to the same
                    # test there, so the conflict set is ~agree, not ~similar).
                    # DEFERRED: the reference zeroes invalidDepths only for
                    # points that are actually STORED, so invalidation waits
                    # for the keep decision below
                    conflict = has_depth & ~agree & (zb < db)
                    conflict &= ~np.isin(lin, uniq)  # pixels merged this round
                    if conflict.any():
                        rows_c = np.nonzero(conflict)[0]
                        conflicts.append((nb.image_id, rows_c, lin[rows_c]))
                else:
                    conflict = has_depth & ~agree & (zb < db)
                    if conflict.any():
                        rows_c = np.nonzero(conflict)[0]
                        conflicts.append((nb.image_id, rows_c, lin[rows_c]))

        with span("fuse.keep", view=vid):
            keep = n_views_pt >= n_min_fuse
            # invalidate conflicts of KEPT points only (reference applies
            # invalidDepths after `views.size() < nMinViewsFuse` pruning)
            for cvid, rows_c, lins_c in conflicts:
                k = keep[rows_c]
                if k.any():
                    provider.invalidate(cvid, np.unique(lins_c[k]))
            # mark ownership for kept points; release claims of dropped points
            kept_map = np.full(n_cand, -1, np.int64)
            kept_map[keep] = next_point_idx + np.arange(int(keep.sum()))
            own_ref[yy[keep], xx[keep]] = kept_map[keep]
            own_ref[yy[~keep], xx[~keep]] = -2  # consumed, not refused forever
            for cvid, rows, lins in claims:
                k = keep[rows]
                ow = owner[cvid].reshape(-1)
                ow[lins[k]] = kept_map[rows[k]]

        with span("fuse.emit", view=vid):
            inv_w = 1.0 / acc_W[keep]
            pts = (acc_X[keep] * inv_w[:, None]).astype(np.float32)
            all_pts.append(pts)
            if estimate_color:
                all_colors.append(np.clip(acc_C[keep] * inv_w[:, None], 0, 255).astype(np.uint8))
            if estimate_normal:
                nr = acc_N[keep]
                nr /= np.maximum(np.linalg.norm(nr, axis=-1, keepdims=True), 1e-12)
                all_normals.append(nr.astype(np.float32))

            # flatten (point, view, weight) membership for kept points
            rows_cat = np.concatenate(member_rows)
            vids_cat = np.concatenate(member_view_ids)
            wgts_cat = np.concatenate(member_weights)
            sel = keep[rows_cat]
            all_views.append(vids_cat[sel])
            all_weights.append(wgts_cat[sel])
            # counts per point in emission order
            cnt = np.bincount(kept_map[rows_cat[sel]] - next_point_idx, minlength=int(keep.sum()))
            all_counts.append(cnt)
            # keep membership sorted by point: emit pairs sorted
            order_pairs = np.argsort(kept_map[rows_cat[sel]], kind="stable")
            all_views[-1] = all_views[-1][order_pairs]
            all_weights[-1] = all_weights[-1][order_pairs]

        next_point_idx += int(keep.sum())

    with span("fuse.emit"):
        pc = PointCloud()
        if not all_pts:
            return pc
        pc.points = np.concatenate(all_pts)
        if estimate_color and all_colors:
            pc.colors = np.concatenate(all_colors)
        if estimate_normal and all_normals:
            pc.normals = np.concatenate(all_normals)
        views_flat = np.concatenate(all_views)
        weights_flat = np.concatenate(all_weights)
        counts = np.concatenate(all_counts)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        pc.views = [views_flat[offsets[i] : offsets[i + 1]] for i in range(len(counts))]
        pc.weights = [weights_flat[offsets[i] : offsets[i + 1]] for i in range(len(counts))]
        return pc


def merge_depth_maps(
    views: List[ViewDepthData],
    opts: DenseOptions,
    estimate_color: bool = True,
    estimate_normal: bool = True,
) -> PointCloud:
    """Simple depth-map concatenation without cross-view agreement
    (MergeDepthMaps, SceneDensify.cpp:1305-1370): every valid pixel becomes a
    point seen by its own view only.  Much faster than fusion; used when the
    caller dedups/filters downstream (e.g. before Delaunay meshing)."""
    pts, cols, nrms, view_ids, weights = [], [], [], [], []
    any_color = any(v.color is not None for v in views)
    any_normal = any(v.normal is not None for v in views)
    for v in views:
        ys, xs = np.nonzero(v.depth > 0)
        if len(ys) == 0:
            continue
        d = v.depth[ys, xs].astype(np.float64)
        P = v.camera.unproject(np.stack([xs, ys], axis=1).astype(np.float64), d)
        pts.append(P.astype(np.float32))
        # under MIXED availability, attribute-less views contribute zero
        # rows so colors/normals stay aligned with points (all-absent
        # still yields empty arrays)
        if estimate_color and any_color:
            cols.append(v.color[ys, xs] if v.color is not None
                        else np.zeros((len(ys), 3), np.uint8))
        if estimate_normal and any_normal:
            if v.normal is not None:
                nrms.append((v.normal[ys, xs] @ v.camera.R).astype(np.float32))
            else:
                nrms.append(np.zeros((len(ys), 3), np.float32))
        c = v.conf[ys, xs] if v.conf is not None else np.ones(len(ys), np.float32)
        w = conf2weight(c, d, getattr(opts, "fuse_conf_weight_floor", 0.09))
        view_ids.extend([np.array([v.image_id], np.uint32)] * len(ys))
        weights.extend(np.asarray(w, np.float32).reshape(-1, 1))
    if not pts:
        return PointCloud()
    return PointCloud(
        points=np.concatenate(pts),
        views=view_ids,
        weights=[np.asarray(w, np.float32) for w in weights],
        normals=np.concatenate(nrms) if nrms else np.zeros((0, 3), np.float32),
        colors=np.concatenate(cols) if cols else np.zeros((0, 3), np.uint8),
    )
