"""Neighbor-view selection and scoring.

Behavioral equivalent of the reference's Scene::SelectNeighborViews
(libs/MVS/Scene.cpp:801-968) and FilterNeighborViews (Scene.cpp:952-968),
fully vectorized over (point, view) pairs with numpy instead of per-point
loops.

Score for a candidate neighbor B of reference A accumulates over shared
sparse points:  max(wAngle, 0.1) * wScale * wROI, where
  wAngle = exp((angle-optim)^2 * sigma)   (two-sided Gaussian around 12 deg)
  wScale = footprint ratio penalty (prefer same-or-finer resolution)
and is finally multiplied by the covered-area fraction of shared
projections on a 16x16 grid.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.io.mvs import ViewScore
from openmvs_tpu_torch.scene import Scene


def _covered_area(proj: np.ndarray, width: int, height: int, grid: int = 16) -> float:
    """Fraction of a grid x grid raster covered by the projections."""
    if len(proj) == 0:
        return 0.0
    ix = np.clip((proj[:, 0] * grid / width).astype(np.int32), 0, grid - 1)
    iy = np.clip((proj[:, 1] * grid / height).astype(np.int32), 0, grid - 1)
    return len(np.unique(ix * grid + iy)) / float(grid * grid)


def _flat_point_views(pointcloud):
    """Flatten the ragged per-point view lists once per scene:
    (flat_pt, flat_view, counts) — O(total pairs) instead of a Python loop
    per reference image (O(points x images) interpreted work at scale)."""
    views = pointcloud.views
    counts = np.fromiter((len(v) for v in views), np.int64, len(views))
    flat_pt = np.repeat(np.arange(len(views), dtype=np.int64), counts)
    flat_view = (np.concatenate(views).astype(np.int64)
                 if len(views) else np.zeros(0, np.int64))
    return flat_pt, flat_view, counts


def select_neighbor_views(
    scene: Scene,
    ref_idx: int,
    opts: DenseOptions,
    min_views: int = 2,
    min_point_views: int = 3,
    flat=None,
) -> List[ViewScore]:
    """Score all other views as stereo neighbors for image ``ref_idx``.

    Returns ViewScores sorted best-first and writes avg depth onto the image
    meta (as Scene::SelectNeighborViews does).
    """
    imgA = scene.images[ref_idx]
    idA = imgA.meta.id
    pts_all = scene.pointcloud.points.astype(np.float64)

    if flat is None:
        flat = _flat_point_views(scene.pointcloud)
    flat_pt, flat_view, counts = flat
    mine = flat_view == idA
    sel_pts_arr = flat_pt[mine]
    if len(sel_pts_arr) == 0:
        return []
    # ROI mode 2 (nPointInsideROI > 1) skips outside-ROI points ENTIRELY —
    # before depth stats and pair accumulation (Scene.cpp:832-834 continue)
    roi_mode = opts.point_inside_roi if scene.is_bounded() else 0
    if roi_mode > 1:
        in_roi = scene.roi_contains(pts_all[sel_pts_arr])
        sel_pts_arr = sel_pts_arr[in_roi]
        if len(sel_pts_arr) == 0:
            return []
    seen = np.zeros(len(scene.pointcloud.views), bool)
    seen[sel_pts_arr] = True
    pair_mask = seen[flat_pt] & ~mine
    pair_pt = flat_pt[pair_mask]
    pair_view = flat_view[pair_mask]
    X = pts_all[sel_pts_arr]
    depthA = imgA.camera.point_depth(X)
    valid_depth = depthA > 0
    imgA.meta.avg_depth = float(depthA[valid_depth].mean()) if valid_depth.any() else 0.0
    imgA.meta.min_depth = float(depthA[valid_depth].min()) if valid_depth.any() else 0.0
    imgA.meta.max_depth = float(depthA[valid_depth].max()) if valid_depth.any() else 0.0

    if len(pair_pt) == 0:
        return []
    P = pts_all[pair_pt]

    id_to_idx = {img.meta.id: i for i, img in enumerate(scene.images)}
    n_images = len(scene.images)

    # angle between viewing rays.  Per-ID camera arrays once (O(images)),
    # then pure fancy-indexing over the pair list — no O(pairs) Python.
    V1 = imgA.camera.C[None, :] - P
    f1 = imgA.camera.footprint_image(P)
    n_ids = max(id_to_idx) + 1
    C_all = np.zeros((n_ids, 3))
    f_all = np.ones(n_ids)
    R2_all = np.zeros((n_ids, 3))
    for b, i in id_to_idx.items():
        cam = scene.images[i].camera
        C_all[b] = cam.C
        f_all[b] = cam.focal_length
        R2_all[b] = cam.R[2]
    CB = C_all[pair_view]
    V2 = CB - P
    cosang = np.einsum("ij,ij->i", V1, V2) / (
        np.linalg.norm(V1, axis=1) * np.linalg.norm(V2, axis=1) + 1e-30
    )
    ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
    optim = opts.optim_angle
    sigma_small = -1.0 / (2.0 * (optim * 0.38) ** 2)
    sigma_large = -1.0 / (2.0 * (optim * 0.7) ** 2)
    w_angle = np.exp((ang - optim) ** 2 * np.where(ang < optim, sigma_small, sigma_large))

    # footprint scale ratio
    fB = f_all[pair_view]
    dB = np.einsum("ij,ij->i", P - CB, R2_all[pair_view])
    f2 = fB / np.maximum(dB, 1e-30)
    ratio = f1 / np.maximum(f2, 1e-30)
    w_scale = np.where(ratio > 1.6, (1.6 / ratio) ** 2, np.where(ratio >= 1.0, 1.0, ratio ** 2))
    w_scale = np.where(dB <= 0, 0.0, w_scale)

    contrib = np.maximum(w_angle, 0.1) * w_scale

    # ROI membership weighting (nPointInsideROI, Scene.cpp:824-836): mode 1
    # down-weights outsiders to 0.7 (mode 2 already excluded them above)
    if roi_mode == 1:
        inside = scene.roi_contains(P)
        contrib = np.where(inside, contrib, 0.7 * contrib)
    max_id = int(pair_view.max()) + 1
    score_acc = np.bincount(pair_view, weights=contrib, minlength=max_id)
    scale_acc = np.bincount(pair_view, weights=ratio, minlength=max_id)
    angle_acc = np.bincount(pair_view, weights=ang, minlength=max_id)
    count_acc = np.bincount(pair_view, minlength=max_id)

    # points eligible for area computation: those with enough views
    eligible = counts[pair_pt] >= min(min_point_views, n_images)

    result: List[ViewScore] = []
    projA_all = imgA.camera.project(P)
    boundsA = (imgA.width, imgA.height)
    for b in np.nonzero(count_acc >= 3)[0]:
        if b not in id_to_idx:
            continue
        imgB = scene.images[id_to_idx[b]]
        mask = (pair_view == b) & eligible
        if not mask.any():
            continue
        projA = projA_all[mask]
        projB = imgB.camera.project(P[mask])
        insideA = (
            (projA[:, 0] >= 0) & (projA[:, 0] < boundsA[0]) & (projA[:, 1] >= 0) & (projA[:, 1] < boundsA[1])
        )
        insideB = (
            (projB[:, 0] >= 0) & (projB[:, 0] < imgB.width) & (projB[:, 1] >= 0) & (projB[:, 1] < imgB.height)
        )
        area = _covered_area(projA[insideA & insideB], imgA.width, imgA.height)
        vs = ViewScore(
            id=int(b),
            points=int(count_acc[b]),
            scale=float(scale_acc[b] / count_acc[b]),
            angle=float(math.radians(angle_acc[b] / count_acc[b])),
            area=area,
            score=float(score_acc[b] * max(area, 0.01)),
        )
        result.append(vs)
    result.sort(key=lambda v: -v.score)
    return result


def filter_neighbor_views(
    neighbors: List[ViewScore],
    opts: DenseOptions,
    min_area: float = None,
    min_scale: float = 0.2,
    max_scale: float = 3.2,
    min_angle: float = None,
    max_angle: float = None,
    max_views: int = 12,
) -> List[ViewScore]:
    """Keep only usable neighbors (reference Scene::FilterNeighborViews;
    angle/area bounds default to the OPTDENSE knobs as in
    SceneDensify.cpp:279 SelectViews)."""
    if min_area is None:
        min_area = opts.min_area
    if min_angle is None:
        min_angle = opts.min_angle
    if max_angle is None:
        max_angle = opts.max_angle
    min_keep = max(4, max_views * 3 // 4)
    out = list(neighbors)
    for vs in sorted(neighbors, key=lambda v: v.score):
        if len(out) <= min_keep:
            break
        angle_deg = math.degrees(vs.angle)
        if vs.area < min_area or not (min_scale <= vs.scale <= max_scale) or not (
            min_angle <= angle_deg <= max_angle
        ):
            out.remove(vs)
    out.sort(key=lambda v: -v.score)
    return out[:max_views]


def select_views_for_scene(scene: Scene, opts: DenseOptions,
                           respect_existing: bool = False) -> None:
    """Populate meta.view_scores for every image.

    respect_existing=True keeps images that already have neighbors (e.g.
    loaded via Scene.load_view_neighbors — the reference skips
    SelectNeighborViews for such images) and selects only for the rest."""
    flat = _flat_point_views(scene.pointcloud)
    for i in range(scene.n_views):
        if respect_existing and scene.images[i].meta.view_scores:
            continue
        neighbors = select_neighbor_views(scene, i, opts, flat=flat)
        # drop weak absolute/relative scores (SceneDensify.cpp InitViews policy)
        if neighbors:
            best = neighbors[0].score
            th = max(opts.view_min_score, best * opts.view_min_score_ratio)
            # when even the best neighbor scores below the absolute minimum
            # the image keeps NO neighbors and is skipped for estimation
            # (SceneDensify.cpp:334-339 breaks on the first sub-fMinScore
            # neighbor, leaving images.size()<2)
            neighbors = [v for v in neighbors if v.score >= th]
        neighbors = filter_neighbor_views(neighbors, opts, max_views=opts.max_views)
        scene.images[i].meta.view_scores = neighbors
    if opts.num_views == 1:
        # single-target mode: globally assign one stereo partner per image
        select_pairs_global(scene, opts)


def select_pairs_global(scene: Scene, opts: DenseOptions) -> dict:
    """Global single-target stereo pairing (the reference's nNumViews==1 MRF
    solved with TRW-S/LBP, SceneDensify.cpp:150-271): each image is assigned
    exactly one partner, maximizing the total symmetric pair score, with
    mutual assignments preferred.  Solved exactly as a max-weight matching
    via the Hungarian algorithm on the symmetrized score matrix."""
    from scipy.optimize import linear_sum_assignment

    n = scene.n_views
    ids = [im.meta.id for im in scene.images]
    idx = {v: i for i, v in enumerate(ids)}
    S = np.zeros((n, n))
    for i, im in enumerate(scene.images):
        for vs in im.meta.view_scores or []:
            if vs.id in idx:
                j = idx[vs.id]
                S[i, j] += vs.score
                S[j, i] += vs.score        # symmetrize
    big = S.max() + 1.0 if S.size else 1.0
    cost = big - S
    # diagonal = "stay unpaired" (score 0, i.e. cost `big`): any positive-score
    # pair beats it, so images pair up whenever a usable partner exists and an
    # odd image count cannot force the matching off the strong mutual pairs
    rows, cols = linear_sum_assignment(cost)
    partner = {int(r): int(c) for r, c in zip(rows, cols)}
    # the permutation may contain k-cycles on the symmetrized matrix; keep only
    # mutual transpositions, then greedily match the cycle leftovers by score
    # so every reported pair is guaranteed mutual
    pairs = {}
    leftover = []
    for r in range(n):
        c = partner.get(r, r)
        if r != c and partner.get(c) == r and S[r, c] > 0:
            pairs[ids[r]] = ids[c]
        else:
            # unassigned, in a k-cycle, or mutual with zero score — all go
            # to the greedy leftover matching
            leftover.append(r)
    free = set(leftover)
    cand = sorted(
        ((S[r, c], r, c) for r in leftover for c in leftover
         if r < c and S[r, c] > 0),
        reverse=True,
    )
    for s, r, c in cand:
        if r in free and c in free:
            pairs[ids[r]] = ids[c]
            pairs[ids[c]] = ids[r]
            free.discard(r)
            free.discard(c)
    # restrict each image's neighbor list to its assigned partner
    for i, im in enumerate(scene.images):
        tgt = pairs.get(ids[i])
        if tgt is None:
            continue
        kept = [vs for vs in (im.meta.view_scores or []) if vs.id == tgt]
        if kept:
            im.meta.view_scores = kept
    return pairs
