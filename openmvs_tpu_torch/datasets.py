"""Real-dataset evaluation adapters: ETH3D high-res multi-view and DTU.

The reference leaves DTU/ETH3D benchmarking to external tools (SURVEY §6);
BASELINE.json's north star (ETH3D F1 within 2% of OpenMVS) needs a runnable
evaluator the day the datasets are reachable.  These adapters turn the raw
dataset layouts into `Scene`s via the existing COLMAP importer and evaluate
reconstructions with the `eval.point_cloud_fscore` protocol.

ETH3D high-res scene layout (https://www.eth3d.net, training split):
    <scene>/images/...                                 undistorted images
    <scene>/dslr_calibration_undistorted/{cameras,images,points3D}.txt
    <scene>/scan_clean/*.ply  (or dslr_scan_eval/*.ply)   laser-scan GT
Official tolerances are metric; we report F at 1/2/5/10 cm (the headline
ETH3D number is F1 @ 2 cm).

DTU (SampleSet "MVS Data" layout):
    <root>/Calibration/cal18/pos_###.txt     3x4 projection matrices
    <root>/Rectified/scan<N>/rect_###_<lighting>.png
    <root>/Points/stl/stl<NNN>_total.ply     structured-light GT
DTU metrics are distances in mm: mean accuracy (est->GT), mean completeness
(GT->est), plus F at 0.5/1/2 mm.  DTU ships no sparse SfM points; PatchMatch
seeding needs them, so pass `sparse_dir` (a COLMAP model for the scan) or
reconstruct with another frontend first — same requirement as the reference.

A copy of ``openmvs_tpu/datasets.py``: image sizes come from the file
headers (``io/images.image_size``) where the JAX package opens the images
with PIL, and ``run_eval`` densifies on the caller's ``device`` (default
the card).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from openmvs_tpu_torch.io import mvs as mvsio
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("datasets")

ETH3D_TOLERANCES_M = (0.01, 0.02, 0.05, 0.10)
DTU_THRESHOLDS_MM = (0.5, 1.0, 2.0)


# ------------------------------------------------------------------- ETH3D


def find_eth3d_calibration(scene_dir: str) -> str:
    """Locate the COLMAP-format calibration folder inside an ETH3D scene."""
    for cand in ("dslr_calibration_undistorted", "dslr_calibration_jpg",
                 "rig_calibration_undistorted", "calibration_undistorted"):
        p = os.path.join(scene_dir, cand)
        if os.path.isdir(p):
            return p
    raise FileNotFoundError(
        f"no ETH3D calibration folder under {scene_dir} (expected e.g. "
        "dslr_calibration_undistorted/ with cameras.txt/images.txt)")


def find_eth3d_gt(scene_dir: str) -> List[str]:
    """Ground-truth scan PLYs (training split ships scan_clean/)."""
    for cand in ("scan_clean", "dslr_scan_eval", "scan_eval"):
        hits = sorted(glob.glob(os.path.join(scene_dir, cand, "*.ply")))
        if hits:
            return hits
    return []


def load_eth3d_scene(scene_dir: str):
    """ETH3D scene folder -> (Scene, gt_ply_paths)."""
    from openmvs_tpu_torch.interfaces.colmap import import_colmap
    from openmvs_tpu_torch.scene import Scene

    calib = find_eth3d_calibration(scene_dir)
    itf = import_colmap(calib, images_folder=scene_dir)
    scene = Scene.from_interface(itf, scene_dir)
    return scene, find_eth3d_gt(scene_dir)


# --------------------------------------------------------------------- DTU


def decompose_P(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """3x4 projection -> (K, R, C) with K upper-triangular, positive diagonal
    and det(R)=+1 (DecomposeProjectionMatrix role, libs/MVS/Camera.cpp)."""
    import scipy.linalg

    P = np.asarray(P, np.float64).reshape(3, 4)
    M = P[:, :3]
    K, R = scipy.linalg.rq(M)
    # fix signs so diag(K) > 0
    S = np.diag(np.sign(np.diag(K)))
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    C = -np.linalg.solve(M, P[:, 3])
    return K / K[2, 2], R, C


def _dtu_image_for(view_dir: str, idx: int, lighting: str) -> Optional[str]:
    pats = [f"rect_{idx:03d}_{lighting}.png", f"rect_{idx:03d}_{lighting}.jpg",
            f"rect_{idx:03d}_{lighting}_r5000.png",
            f"rect_{idx:03d}_{lighting}_r5000.jpg"]
    for p in pats:
        fp = os.path.join(view_dir, p)
        if os.path.exists(fp):
            return fp
    hits = sorted(glob.glob(os.path.join(view_dir, f"rect_{idx:03d}_*")))
    return hits[0] if hits else None


def load_dtu_scan(root: str, scan: int, lighting: str = "max",
                  sparse_dir: str = ""):
    """DTU scan -> (Scene, gt_ply_path or None).

    `sparse_dir` (optional): COLMAP model providing the sparse seed points
    PatchMatch needs; without it the scene has cameras+images only.
    """
    from openmvs_tpu_torch.geometry.camera import Camera
    from openmvs_tpu_torch.io.images import image_size
    from openmvs_tpu_torch.scene import Scene, SceneImage, PointCloud

    cal_dir = os.path.join(root, "Calibration", "cal18")
    if not os.path.isdir(cal_dir):
        raise FileNotFoundError(f"no DTU calibration at {cal_dir}")
    view_dir = None
    for cand in (f"scan{scan}", f"scan{scan}_train", f"scan{scan:03d}"):
        p = os.path.join(root, "Rectified", cand)
        if os.path.isdir(p):
            view_dir = p
            break
    if view_dir is None:
        raise FileNotFoundError(f"no DTU images for scan {scan} under "
                                f"{os.path.join(root, 'Rectified')}")

    scene = Scene()
    scene.working_folder = root
    pos_files = sorted(glob.glob(os.path.join(cal_dir, "pos_*.txt")))
    for pf in pos_files:
        idx = int(os.path.splitext(os.path.basename(pf))[0].split("_")[1])
        img_path = _dtu_image_for(view_dir, idx, lighting)
        if img_path is None:
            continue
        P = np.loadtxt(pf).reshape(3, 4)
        K, R, C = decompose_P(P)
        w, h = image_size(img_path)
        meta = mvsio.ImageMeta(name=img_path, id=len(scene.images))
        scene.images.append(SceneImage(meta=meta, camera=Camera(K, R, C),
                                       width=w, height=h, path=img_path))
    if sparse_dir:
        from openmvs_tpu_torch.interfaces.colmap import import_colmap

        itf = import_colmap(sparse_dir)
        scene.pointcloud = PointCloud(
            points=itf.points, views=itf.point_views,
            weights=itf.point_confidences, normals=itf.normals,
            colors=itf.colors)

    gt = os.path.join(root, "Points", "stl", f"stl{scan:03d}_total.ply")
    return scene, (gt if os.path.exists(gt) else None)


# ------------------------------------------------------------------- metrics


def _load_points(path: str) -> np.ndarray:
    from openmvs_tpu_torch.io import ply as plyio

    pts = plyio.load(path).vertices
    if pts is None:
        raise ValueError(f"no vertex element in {path}")
    return np.asarray(pts, np.float64).reshape(-1, 3)


def evaluate_eth3d(est_points: np.ndarray, gt_points: np.ndarray,
                   tolerances=ETH3D_TOLERANCES_M,
                   max_points: int = 500_000) -> Dict[str, object]:
    """ETH3D protocol: F-score at metric tolerances (headline = F1 @ 2 cm)."""
    from openmvs_tpu_torch import eval as ev

    out: Dict[str, object] = {"protocol": "eth3d", "tolerances_m": list(tolerances)}
    for tol in tolerances:
        r = ev.point_cloud_fscore(est_points, gt_points, tol,
                                  max_points=max_points)
        key = f"{tol * 100:g}cm"
        out[f"accuracy@{key}"] = r["accuracy"]
        out[f"completeness@{key}"] = r["completeness"]
        out[f"fscore@{key}"] = r["fscore"]
    out["headline_f1_2cm"] = out.get("fscore@2cm")
    return out


def evaluate_dtu(est_points: np.ndarray, gt_points: np.ndarray,
                 thresholds_mm=DTU_THRESHOLDS_MM,
                 max_points: int = 500_000) -> Dict[str, object]:
    """DTU protocol (simplified, no ObsMask): mean accuracy/completeness
    distances in DTU's native millimetre units + F at mm thresholds."""
    from openmvs_tpu_torch import eval as ev

    out: Dict[str, object] = {"protocol": "dtu", "thresholds_mm": list(thresholds_mm)}
    r2 = ev.point_cloud_fscore(est_points, gt_points, thresholds_mm[-1],
                               max_points=max_points)
    out["mean_accuracy_mm"] = r2["mean_dist_est_to_gt"]
    out["mean_completeness_mm"] = r2["mean_dist_gt_to_est"]
    for t in thresholds_mm:
        r = ev.point_cloud_fscore(est_points, gt_points, t,
                                  max_points=max_points)
        out[f"fscore@{t:g}mm"] = r["fscore"]
        out[f"accuracy@{t:g}mm"] = r["accuracy"]
        out[f"completeness@{t:g}mm"] = r["completeness"]
    return out


# -------------------------------------------------------------------- runner


def run_eval(dataset: str, scene_dir: str, est_ply: str = "",
             scan: int = 0, lighting: str = "max", sparse_dir: str = "",
             run_pipeline: bool = False, out_json: str = "",
             max_points: int = 500_000, device="cuda") -> Dict[str, object]:
    """One-command dataset evaluation.

    With `run_pipeline`, densifies the scene first on `device` and
    evaluates the fused cloud; otherwise `est_ply` must point at an
    existing reconstruction.
    """
    if dataset == "eth3d":
        scene, gt_paths = load_eth3d_scene(scene_dir)
        if not gt_paths:
            raise FileNotFoundError(
                f"no ground-truth scan PLYs under {scene_dir} "
                "(need scan_clean/ from the ETH3D training split)")
        gt = np.concatenate([_load_points(p) for p in gt_paths], axis=0)
    elif dataset == "dtu":
        scene, gt_path = load_dtu_scan(scene_dir, scan, lighting, sparse_dir)
        if gt_path is None:
            raise FileNotFoundError(
                f"no DTU GT at Points/stl/stl{scan:03d}_total.ply")
        gt = _load_points(gt_path)
    else:
        raise ValueError("dataset must be 'eth3d' or 'dtu'")

    if run_pipeline:
        from openmvs_tpu_torch.config import DenseOptions
        from openmvs_tpu_torch.densify import dense_reconstruction

        if len(scene.pointcloud) == 0:
            raise RuntimeError(
                "scene has no sparse seed points; provide a COLMAP model "
                "(ETH3D ships one; for DTU pass sparse_dir)")
        pc = dense_reconstruction(scene, DenseOptions(), device=device)
        est = np.asarray(pc.points, np.float64)
    else:
        if not est_ply:
            raise ValueError("pass est_ply or run_pipeline=True")
        est = _load_points(est_ply)

    res = (evaluate_eth3d(est, gt, max_points=max_points) if dataset == "eth3d"
           else evaluate_dtu(est, gt, max_points=max_points))
    res["n_est_points"] = int(len(est))
    res["n_gt_points"] = int(len(gt))
    res["scene"] = scene_dir
    if out_json:
        with open(out_json, "w") as f:
            json.dump(res, f, indent=1)
        log.info("wrote %s", out_json)
    return res
