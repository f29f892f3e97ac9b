"""The reference ``geometry``: the scene's own geometry, and the comparison
that decides ``correct`` for a configuration whose ``reference`` it is.

The reference is each view's true depth at the maps' resolution,
ray-marched from the analytic surface by ``scene_gen.ray_march`` (plain
PyTorch, float64), and the surface itself. It takes nothing the program
made: the cameras are the configuration's, worked out again here. What the
program served (its filtered depth maps and its fused cloud, which
``harness.Probes`` keeps on every job) is read only to be judged:

- ``depth_err_med_pct``: the median relative error of the served depths,
  over the pixels where both the map and the truth have one;
- ``depth_bad_pct``: the share of the truth's pixels whose served depth is
  missing or off by more than ``BAD_REL`` of the true depth; a view
  without a map misses all of its pixels (``depth_missing_pct``, the
  missing share alone, is read and not compared);
- ``cloud_bad_pct``: the share of fused points farther than ``tol`` from
  the surface (a point off [-3, 3]^2 counts its distance to it).

``f1_pct`` is ETH3D's F1 of a cloud at ``tol``: precision as above,
recall the share of true-surface samples (every 4th pixel of each view's
true depth) with a fused point within ``tol``. Every scene is
``scene_gen``'s surface, so ``run.py`` reads ``f1_pct`` from this module
whatever the configuration's reference. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from mvs_bench import scene_gen

# ETH3D-style tolerance, as a share of the scene's median true depth
TOL_REL = 0.005
# a served depth farther than this share of the true depth from it is bad
BAD_REL = 0.002
RECALL_STRIDE = 4
# the readings that a configuration's limits may hold
COMPARED = ("depth_err_med_pct", "depth_bad_pct", "cloud_bad_pct")


def map_camera(cfg: dict):
    """(K at the maps' resolution, the centres): the benchmark's cameras."""
    s = cfg["scene"]
    K = scene_gen.scale_intrinsics(scene_gen.intrinsics(s["image_width"], s["image_height"]),
                                   0.5 ** s["resolution_level"])
    return K, scene_gen.grid_centers(s["grid"], s["spacing"])


def truth_maps(cfg: dict, device, dtype=torch.float64) -> List[np.ndarray]:
    """Each view's true depth (H, W) at the maps' resolution, float64
    numpy (0 where the ray misses), computed in ``dtype``."""
    s = cfg["scene"]
    W, H = s["image_width"] >> s["resolution_level"], s["image_height"] >> s["resolution_level"]
    K, Cs = map_camera(cfg)
    return [scene_gen.ray_march(K, C, W, H, device, dtype=dtype)[0].to(torch.float64).cpu().numpy()
            for C in Cs]


def backproject(depth: np.ndarray, K: np.ndarray, C: np.ndarray, stride: int = 1) -> np.ndarray:
    """(n, 3) world points of a depth map's valid pixels (identity
    rotation), every ``stride``-th row and column."""
    d = depth[::stride, ::stride]
    v, u = np.nonzero(d > 0)
    u, v = u * stride, v * stride
    z = d[d > 0].astype(np.float64)
    Kinv = np.linalg.inv(K)
    x = (Kinv[0, 0] * u + Kinv[0, 1] * v + Kinv[0, 2]) * z
    y = (Kinv[1, 1] * v + Kinv[1, 2]) * z
    return np.stack([x + C[0], y + C[1], z + C[2]], -1)


def surface_distance(points: np.ndarray) -> np.ndarray:
    """Distance of each point to the height field: the vertical offset over
    the slope's secant (exact to first order), with the horizontal distance
    to [-3, 3]^2 for points off it."""
    p = torch.as_tensor(np.asarray(points, np.float64))
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    xc = x.clamp(-scene_gen.EXTENT, scene_gen.EXTENT).requires_grad_(True)
    yc = y.clamp(-scene_gen.EXTENT, scene_gen.EXTENT).requires_grad_(True)
    h = scene_gen.height(xc, yc)
    hx, hy = torch.autograd.grad(h.sum(), (xc, yc))
    vert = (z - h.detach()).abs() / torch.sqrt(1 + hx * hx + hy * hy)
    return torch.sqrt(vert ** 2 + (x - xc.detach()) ** 2 + (y - yc.detach()) ** 2).numpy()


def tolerance(truth: List[np.ndarray]) -> float:
    return TOL_REL * float(np.median(np.concatenate([t[t > 0] for t in truth])))


def readings(maps: Dict[int, np.ndarray], points: np.ndarray, truth: List[np.ndarray],
             tol: float) -> Dict[str, float]:
    """The compared numbers of one job: ``maps`` {view index: served depth}
    (a view left out has no entry), ``points`` its fused cloud."""
    n_truth = n_missing = n_off = 0
    errs = []
    for i, gt in enumerate(truth):
        has_gt = gt > 0
        n_truth += int(has_gt.sum())
        d = maps.get(i)
        if d is None or d.shape != gt.shape:
            n_missing += int(has_gt.sum())
            continue
        d = d.astype(np.float64)
        both = (d > 0) & has_gt
        err = np.abs(d[both] - gt[both]) / gt[both]
        errs.append(err)
        n_off += int((err > BAD_REL).sum())
        n_missing += int((has_gt & ~(d > 0)).sum())
    errs = np.concatenate(errs) if errs else np.zeros(0)
    dist = surface_distance(points) if len(points) else np.zeros(0)
    n_truth = max(n_truth, 1)
    return {
        "depth_err_med_pct": 100.0 * float(np.median(errs)) if len(errs) else 100.0,
        "depth_bad_pct": 100.0 * (n_missing + n_off) / n_truth,
        "depth_missing_pct": 100.0 * n_missing / n_truth,
        "cloud_bad_pct": 100.0 * float((dist > tol).mean()) if len(dist) else 100.0,
    }


def f1_pct(points: np.ndarray, truth: List[np.ndarray], K: np.ndarray, Cs,
           tol: float, workers: int = 4) -> Optional[float]:
    """ETH3D's F1 (%) of a cloud at ``tol``; None for an empty cloud."""
    from scipy.spatial import cKDTree

    if len(points) == 0:
        return None
    precision = float((surface_distance(points) <= tol).mean())
    samples = np.concatenate([backproject(t, K, C, RECALL_STRIDE)
                              for t, C in zip(truth, Cs)])
    dist, _ = cKDTree(np.asarray(points, np.float64)).query(
        samples, k=1, distance_upper_bound=tol, workers=workers)
    recall = float(np.isfinite(dist).mean())
    if precision + recall == 0:
        return 0.0
    return 100.0 * 2 * precision * recall / (precision + recall)


class Truth(NamedTuple):
    """The float64 reference of a configuration's scene."""

    maps: List[np.ndarray]  # each view's true depth
    tol: float
    K: np.ndarray
    Cs: np.ndarray


def prepare(cfg: dict, device) -> Truth:
    """The true depth of every view in float64, its tolerance and cameras."""
    truth = truth_maps(cfg, device)
    K, Cs = map_camera(cfg)
    return Truth(truth, tolerance(truth), K, Cs)


def judge(prepared: Truth, job) -> Dict[str, float]:
    """One job's readings: its filtered maps and fused cloud."""
    return readings(job.maps, job.points, prepared.maps, prepared.tol)


def control(cfg: dict, device, dtype=torch.bfloat16) -> Dict[str, float]:
    """The control: the reference computed in ``dtype`` put in the
    program's place (its maps served, every valid pixel of them as the
    cloud), judged against the float64 reference."""
    truth = truth_maps(cfg, device)
    low = truth_maps(cfg, device, dtype=dtype)
    K, Cs = map_camera(cfg)
    maps = {i: d.astype(np.float32) for i, d in enumerate(low)}
    cloud = np.concatenate([backproject(d, K, C) for d, C in zip(low, Cs)])
    return readings(maps, cloud, truth, tolerance(truth))
