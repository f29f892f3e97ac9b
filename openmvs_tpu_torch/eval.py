"""Evaluation harness: depth/normal map and point-cloud accuracy metrics.

Equivalent of the reference's only built-in eval (CompareDepthMaps /
CompareNormalMaps, libs/MVS/DepthMap.cpp:2042-2152) plus the point-cloud
accuracy/completeness/F-score protocol used by DTU/ETH3D/Tanks&Temples
benchmarking (BASELINE.json configs) that the reference leaves to external
tools.

A copy of ``openmvs_tpu/eval.py`` (host numpy and scipy's cKDTree in both
packages, the same RNG subsampling).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class DepthStats:
    valid_gt: int
    valid_est: int
    completeness: float      # fraction of GT pixels with an estimate
    mae: float               # mean absolute error on common support
    rmse: float
    rel_err_median: float
    frac_under_1pct: float
    frac_under_3pct: float


def compare_depth_maps(est: np.ndarray, gt: np.ndarray) -> DepthStats:
    """Per-pixel depth accuracy vs ground truth (CompareDepthMaps role)."""
    v_gt = gt > 0
    v_est = est > 0
    both = v_gt & v_est
    if not both.any():
        return DepthStats(int(v_gt.sum()), int(v_est.sum()), 0.0,
                          float("nan"), float("nan"), float("nan"), 0.0, 0.0)
    d = est[both] - gt[both]
    rel = np.abs(d) / gt[both]
    return DepthStats(
        valid_gt=int(v_gt.sum()),
        valid_est=int(v_est.sum()),
        completeness=float(both.sum() / max(v_gt.sum(), 1)),
        mae=float(np.abs(d).mean()),
        rmse=float(np.sqrt((d * d).mean())),
        rel_err_median=float(np.median(rel)),
        frac_under_1pct=float((rel < 0.01).mean()),
        frac_under_3pct=float((rel < 0.03).mean()),
    )


def compare_normal_maps(est: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """Angular error statistics in degrees (CompareNormalMaps role)."""
    v = (np.linalg.norm(est, axis=-1) > 0.5) & (np.linalg.norm(gt, axis=-1) > 0.5)
    if not v.any():
        return {"mean_deg": float("nan"), "median_deg": float("nan"), "frac_under_10deg": 0.0}
    cos = np.clip(np.sum(est[v] * gt[v], axis=-1)
                  / (np.linalg.norm(est[v], axis=-1) * np.linalg.norm(gt[v], axis=-1)),
                  -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    return {
        "mean_deg": float(ang.mean()),
        "median_deg": float(np.median(ang)),
        "frac_under_10deg": float((ang < 10).mean()),
    }


def point_cloud_fscore(
    est: np.ndarray, gt: np.ndarray, threshold: float,
    max_points: int = 200_000, seed: int = 0,
) -> Dict[str, float]:
    """Accuracy / completeness / F-score at a distance threshold — the
    DTU/ETH3D/T&T protocol (BASELINE.md north-star metrics).

    accuracy: fraction of estimated points within `threshold` of GT;
    completeness: fraction of GT points within `threshold` of the estimate.
    """
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    e = est if len(est) <= max_points else est[rng.choice(len(est), max_points, replace=False)]
    g = gt if len(gt) <= max_points else gt[rng.choice(len(gt), max_points, replace=False)]
    d_e, _ = cKDTree(g).query(e, workers=-1)
    d_g, _ = cKDTree(e).query(g, workers=-1)
    acc = float((d_e < threshold).mean())
    comp = float((d_g < threshold).mean())
    f = 2 * acc * comp / max(acc + comp, 1e-12)
    return {
        "accuracy": acc,
        "completeness": comp,
        "fscore": f,
        "mean_dist_est_to_gt": float(d_e.mean()),
        "mean_dist_gt_to_est": float(d_g.mean()),
    }
