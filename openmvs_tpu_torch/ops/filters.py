"""Depth-map post-filters: speckle removal, gap interpolation, cross-view filter.

Host-side vectorized numpy equivalents of the reference's
DepthMapsData::RemoveSmallSegments (SceneDensify.cpp:810-900),
GapInterpolation (SceneDensify.cpp:904-1045) and FilterDepthMap
(SceneDensify.cpp:1050-1302, Merrell'07-style adjust mode).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.geometry.camera import Camera


def _is_depth_similar(d0: np.ndarray, d1: np.ndarray, th: float) -> np.ndarray:
    return np.abs(d0 - d1) < th * d0


def remove_small_segments(
    depth: np.ndarray,
    normal: Optional[np.ndarray],
    conf: Optional[np.ndarray],
    opts: DenseOptions,
) -> None:
    """Invalidate connected depth segments smaller than speckle_size (in place).

    Connectivity: 4-neighborhood with relative depth similarity
    (threshold 0.7 * depth_diff_threshold, SceneDensify.cpp:812).
    Implemented as sparse connected components instead of flood fill.
    """
    th = opts.depth_diff_threshold * 0.7
    h, w = depth.shape
    idx = np.arange(h * w).reshape(h, w)
    valid = depth > 0

    rows: List[np.ndarray] = []
    cols: List[np.ndarray] = []
    # horizontal edges
    a, b = depth[:, :-1], depth[:, 1:]
    e = valid[:, :-1] & valid[:, 1:] & _is_depth_similar(a, b, th)
    rows.append(idx[:, :-1][e])
    cols.append(idx[:, 1:][e])
    # vertical edges
    a, b = depth[:-1, :], depth[1:, :]
    e = valid[:-1, :] & valid[1:, :] & _is_depth_similar(a, b, th)
    rows.append(idx[:-1, :][e])
    cols.append(idx[1:, :][e])

    r = np.concatenate(rows)
    c = np.concatenate(cols)
    graph = sp.coo_matrix((np.ones(len(r), np.int8), (r, c)), shape=(h * w, h * w))
    n_comp, labels = connected_components(graph, directed=False)
    sizes = np.bincount(labels, minlength=n_comp)
    small = (sizes[labels] < opts.speckle_size).reshape(h, w) & valid
    depth[small] = 0
    if normal is not None:
        normal[small] = 0
    if conf is not None:
        conf[small] = 0


def _interp_gaps_1d(depth, normal, conf, gap: int, th: float):
    """Interpolate along axis=1 rows (callers transpose for columns)."""
    h, w = depth.shape
    valid = depth > 0
    # for each pixel, index of previous/next valid pixel in the row
    col = np.arange(w)[None, :].repeat(h, 0)
    prev_idx = np.where(valid, col, -1)
    np.maximum.accumulate(prev_idx, axis=1, out=prev_idx)
    next_idx = np.where(valid, col, w)
    next_idx = np.flip(np.minimum.accumulate(np.flip(next_idx, 1), axis=1), 1)

    fill = ~valid & (prev_idx >= 0) & (next_idx < w)
    gap_len = next_idx - prev_idx - 1
    fill &= gap_len <= gap
    if not fill.any():
        return
    rr = np.nonzero(fill)[0]
    cc = np.nonzero(fill)[1]
    p = prev_idx[fill]
    n = next_idx[fill]
    d0 = depth[rr, p]
    d1 = depth[rr, n]
    ok = np.abs(d0 - d1) < th * d0
    rr, cc, p, n, d0, d1 = rr[ok], cc[ok], p[ok], n[ok], d0[ok], d1[ok]
    t = (cc - p).astype(np.float32) / (n - p).astype(np.float32)
    depth[rr, cc] = d0 + (d1 - d0) * t
    if conf is not None:
        conf[rr, cc] = np.minimum(conf[rr, p], conf[rr, n])
    if normal is not None:
        n0 = normal[rr, p]
        n1 = normal[rr, n]
        nb = n0 + (n1 - n0) * t[:, None]
        nb /= np.maximum(np.linalg.norm(nb, axis=-1, keepdims=True), 1e-12)
        normal[rr, cc] = nb


def gap_interpolation(
    depth: np.ndarray,
    normal: Optional[np.ndarray],
    conf: Optional[np.ndarray],
    opts: DenseOptions,
) -> None:
    """Fill small scanline gaps row-wise then column-wise (in place)."""
    th = opts.depth_diff_threshold * 2.5
    _interp_gaps_1d(depth, normal, conf, opts.ipol_gap_size, th)
    depth_t = np.ascontiguousarray(depth.T)
    normal_t = np.ascontiguousarray(normal.transpose(1, 0, 2)) if normal is not None else None
    conf_t = np.ascontiguousarray(conf.T) if conf is not None else None
    _interp_gaps_1d(depth_t, normal_t, conf_t, opts.ipol_gap_size, th)
    depth[:] = depth_t.T
    if normal is not None:
        normal[:] = normal_t.transpose(1, 0, 2)
    if conf is not None:
        conf[:] = conf_t.T


def project_depth_to_view(
    depth_src: np.ndarray,
    conf_src: Optional[np.ndarray],
    cam_src: Camera,
    cam_ref: Camera,
    shape_ref: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Render a source depth map into the reference view (z-buffered splat).

    Equivalent of the projection loop in FilterDepthMap
    (SceneDensify.cpp:1066-1135): each source depth unprojects to world,
    projects into the reference, and writes its reference-view depth onto the
    4 surrounding pixels keeping the nearest value.
    """
    h, w = depth_src.shape
    hr, wr = shape_ref
    yy, xx = np.nonzero(depth_src > 0)
    d = depth_src[yy, xx].astype(np.float64)
    uv = np.stack([xx, yy], axis=-1).astype(np.float64)
    X = cam_src.unproject(uv, d)
    Xc = cam_ref.world_to_cam(X)
    z = Xc[:, 2]
    front = z > 0
    Xc, z = Xc[front], z[front]
    p = (Xc @ cam_ref.K.T)
    px = p[:, 0] / z
    py = p[:, 1] / z

    cvals = conf_src[yy, xx][front] if conf_src is not None else np.ones(len(z), np.float32)
    fx = np.floor(px).astype(np.int64)
    fy = np.floor(py).astype(np.int64)
    big = np.float32(np.inf)
    zbuf = np.full(hr * wr, big, np.float32)
    flat_conf = np.zeros(hr * wr, np.float32)
    zf = z.astype(np.float32)
    # splat each source depth into its 4 covering texels; min z-buffer wins,
    # second pass attaches the winners' confidences (same masks reused)
    splats = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ax, ay = fx + dx, fy + dy
        ok = (ax >= 0) & (ax < wr) & (ay >= 0) & (ay < hr)
        lin = ay[ok] * wr + ax[ok]
        splats.append((lin, ok))
        np.minimum.at(zbuf, lin, zf[ok])
    for lin, ok in splats:
        winner = zbuf[lin] == zf[ok]
        flat_conf[lin[winner]] = cvals[ok][winner]
    zbuf[~np.isfinite(zbuf)] = 0
    out = zbuf.reshape(hr, wr)
    out_conf = flat_conf.reshape(hr, wr)
    return out, out_conf


def filter_depth_adjust(
    depth_ref: np.ndarray,
    conf_ref: np.ndarray,
    projected: List[Tuple[np.ndarray, np.ndarray]],
    opts: DenseOptions,
    d_min: float,
    d_max: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Confidence-weighted cross-view depth adjustment (Merrell'07 style).

    Vectorized version of the bAdjust branch of FilterDepthMap
    (SceneDensify.cpp:1146-1217): agreeing projected depths are averaged by
    confidence; disagreeing ones subtract confidence; pixels whose negative
    evidence wins (or with too few views) are discarded.
    """
    th = opts.depth_diff_threshold * 1.2
    n_min_views = opts.min_views_filter
    n_min_adjust = opts.min_views_filter_adjust

    valid = depth_ref > 0
    pos_conf = np.where(valid, conf_ref, 0).astype(np.float64)
    avg_depth = depth_ref.astype(np.float64) * pos_conf
    neg_conf = np.zeros_like(pos_conf)
    n_pos = np.zeros(depth_ref.shape, np.int32)
    n_views_seen = np.zeros(depth_ref.shape, np.int32)
    for d_proj, c_proj in projected:
        has = d_proj > 0
        n_views_seen += has
        agree = has & _is_depth_similar(depth_ref, d_proj, th)
        avg_depth += np.where(agree, d_proj * c_proj, 0)
        pos_conf += np.where(agree, c_proj, 0)
        n_pos += agree
        neg_conf += np.where(has & ~agree, c_proj, 0)

    avg = avg_depth / np.maximum(pos_conf, 1e-12)
    keep = (
        valid
        & (n_views_seen >= n_min_views)
        & (n_pos >= n_min_adjust)
        & (pos_conf > neg_conf)
        & (avg >= d_min)
        & (avg <= d_max)
    )
    new_depth = np.where(keep, avg, 0).astype(np.float32)
    new_conf = np.where(keep, pos_conf - neg_conf, 0).astype(np.float32)
    return new_depth, new_conf


def filter_depth_strict(
    depth_ref: np.ndarray,
    conf_ref: np.ndarray,
    projected: List[Tuple[np.ndarray, np.ndarray]],
    opts: DenseOptions,
) -> Tuple[np.ndarray, np.ndarray]:
    """Non-adjusting cross-view filter (the bAdjust=false branch of
    FilterDepthMap, SceneDensify.cpp:1219-1302): discard a depth unless it
    agrees with enough neighbor-view depths both at the pixel (strict
    threshold, >=min_views and >=75% of valid views) and in its 4-neighborhood
    (loose threshold, >=2*min_views and >=65%).  Depth values are never
    modified — only kept or zeroed.
    """
    th_strict = opts.depth_diff_threshold * 0.8
    th_loose = opts.depth_diff_threshold * 1.2
    n_min_views = opts.min_views_filter
    valid = depth_ref > 0

    n_good = np.zeros(depth_ref.shape, np.int32)
    n_seen = np.zeros(depth_ref.shape, np.int32)
    n_good_d = np.zeros(depth_ref.shape, np.int32)
    n_seen_d = np.zeros(depth_ref.shape, np.int32)
    for d_proj, _ in projected:
        has = d_proj > 0
        n_seen += has
        n_good += has & _is_depth_similar(depth_ref, d_proj, th_strict)
        # 4-neighborhood agreement (xDs deltas): shift the projected map
        for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0)):
            src = np.zeros_like(d_proj)
            if dy == 0 and dx == -1:
                src[:, 1:] = d_proj[:, :-1]
            elif dy == 0 and dx == 1:
                src[:, :-1] = d_proj[:, 1:]
            elif dy == -1:
                src[1:, :] = d_proj[:-1, :]
            else:
                src[:-1, :] = d_proj[1:, :]
            hs = src > 0
            n_seen_d += hs
            n_good_d += hs & _is_depth_similar(depth_ref, src, th_loose)
    keep = (
        valid
        & (n_good >= n_min_views)
        & (n_good * 100 >= n_seen * 75)
        & (n_good_d >= n_min_views * 2)
        & (n_good_d * 100 >= n_seen_d * 65)
    )
    new_depth = np.where(keep, depth_ref, 0).astype(np.float32)
    new_conf = np.where(keep, conf_ref, 0).astype(np.float32)
    return new_depth, new_conf
