"""Similarity-transform estimation (7-DoF alignment).

Role equivalent of the reference's SimilarityTransform
(libs/Math/SimilarityTransform.{h,cpp}: LM-refined alignment used by
Scene::AlignTo, Scene.cpp:1588).  Implemented closed-form with the Umeyama
method — exact least-squares, no iterative refinement needed.

A copy of ``openmvs_tpu/geometry/similarity.py`` (host numpy in both
packages).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True
            ) -> Tuple[np.ndarray, float]:
    """Least-squares similarity aligning src -> dst point sets.

    Returns (T, scale) where T is 4x4 with T[:3, :3] = scale * R and
    dst ≈ (T @ [src, 1])[:3]."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.shape[0] < 3:
        raise ValueError("need >= 3 corresponding 3D points")
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    scale = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - scale * R @ mu_s
    T = np.eye(4)
    T[:3, :3] = scale * R
    T[:3, 3] = t
    return T, scale


def align_scenes(scene, ref_scene) -> np.ndarray:
    """Estimate the similarity aligning `scene` onto `ref_scene` from camera
    centers of images matched by name (basename) or id (Scene::AlignTo,
    Scene.cpp:1588-1620), apply it to `scene`, and return the 4x4."""
    import os

    def keys(s):
        out = {}
        for im in s.images:
            out[os.path.basename(im.meta.name)] = im
        return out

    a, b = keys(scene), keys(ref_scene)
    common = sorted(set(a) & set(b))
    if len(common) < 3:
        # fall back to image-id pairing
        a = {im.meta.id: im for im in scene.images}
        b = {im.meta.id: im for im in ref_scene.images}
        common = sorted(set(a) & set(b))
    if len(common) < 3:
        raise ValueError("fewer than 3 cameras in common between the scenes")
    src = np.stack([a[k].camera.C for k in common])
    dst = np.stack([b[k].camera.C for k in common])
    T, s = umeyama(src, dst)
    if len(common) >= 4:
        # LM refinement with a Huber loss on top of the closed-form estimate
        # (the reference refines its SimilarityTransform with lmmin,
        # Math/SimilarityTransform.cpp; robust to a few bad camera matches)
        from openmvs_tpu_torch.geometry.lm import refine_similarity

        try:
            T, s = refine_similarity(src, dst, T, s, robust="huber")
        except Exception:
            pass
    scene.apply_transform(T)
    return T


def estimate_ground_plane(points: np.ndarray, threshold: float = 0.0,
                          iters: int = 256, seed: int = 0
                          ) -> Tuple[np.ndarray, float]:
    """RANSAC dominant-plane fit (the role of the reference's ACRANSAC
    EstimatePlane, Common/AutoEstimator.h used via DepthMap.h:481-489).

    Returns (n, d) with n·x + d = 0, n unit, oriented so that most points
    have n·x + d >= 0 (above ground)."""
    P = np.asarray(points, np.float64)
    if len(P) < 3:
        raise ValueError("need >= 3 points")
    if threshold <= 0 and len(P) >= 4:
        # parameter-free: a-contrario RANSAC selects the threshold by NFA
        # (the reference's ACRANSAC EstimatePointsPlane, DepthMap.cpp:1353)
        from openmvs_tpu_torch.geometry.robust import ac_ransac_plane

        n, d, mask, _, _ = ac_ransac_plane(P, iters=iters, seed=seed)
        if np.median(P @ n + d) < 0:
            n, d = -n, -d
        return n, d
    if threshold <= 0:
        bbox = P.max(axis=0) - P.min(axis=0)
        threshold = float(np.linalg.norm(bbox)) * 5e-3
    rng = np.random.default_rng(seed)
    best = (None, -1)
    for _ in range(iters):
        i = rng.choice(len(P), 3, replace=False)
        v1, v2 = P[i[1]] - P[i[0]], P[i[2]] - P[i[0]]
        n = np.cross(v1, v2)
        nn = np.linalg.norm(n)
        if nn < 1e-12:
            continue
        n = n / nn
        d = -n @ P[i[0]]
        inl = int((np.abs(P @ n + d) < threshold).sum())
        if inl > best[1]:
            best = ((n, d), inl)
    if best[0] is None:
        raise ValueError(
            "ground-plane RANSAC found no non-degenerate sample "
            "(all point triples collinear)")
    (n, d), _ = best
    # refine on inliers
    m = np.abs(P @ n + d) < threshold
    Q = P[m] - P[m].mean(axis=0)
    _, _, Vt = np.linalg.svd(Q, full_matrices=False)
    n = Vt[2] / np.linalg.norm(Vt[2])
    d = -float(n @ P[m].mean(axis=0))
    if np.median(P @ n + d) < 0:
        n, d = -n, -d
    return n, d
