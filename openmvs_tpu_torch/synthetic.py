"""Synthetic ground-truth scene for densify checks, built without OpenCV or
a rasterizer.

The scene of ``scripts/quality_harness.py:build_gt_scene`` (shape
``smooth``): a textured height field z = 6 + bumps over [-3, 3]^2 seen by a
row of fronto-parallel cameras, and a 600-point sparse cloud sampled from
the height field's grid vertices with the same seeded generator. Where the
harness rasterizes a 96x96 triangulation of the field, this module
ray-marches the analytic surface per pixel, so its images and ground-truth
depths are those of the smooth surface itself. ``height_field_mesh`` is
that triangulation (the harness's ``gt_mesh``), the mesh refinement starts
from.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter

from openmvs_tpu_torch.convert import scene_from_arrays
from openmvs_tpu_torch.scene import Mesh, Scene


def height(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return (6.0 + 0.6 * np.sin(x * 1.3) * np.cos(y * 1.7)
            + 0.3 * np.sin(2.9 * x + 1.0) * np.sin(2.3 * y))


def height_field_mesh(grid: int = 96) -> Mesh:
    """The height field triangulated over a grid x grid lattice on
    [-3, 3]^2: row-major vertices with z = ``height(x, y)``, two faces per
    cell, in the vertex and face order of the quality harness's
    ``gt_mesh`` (scripts/quality_harness.py:77-85)."""
    g = np.linspace(-3, 3, grid)
    xx, yy = np.meshgrid(g, g)
    verts = np.stack([xx, yy, height(xx, yy)], -1).reshape(-1, 3)
    i = (np.arange(grid - 1)[:, None] * grid
         + np.arange(grid - 1)[None, :]).reshape(-1)
    faces = np.stack([np.stack([i, i + 1, i + grid], -1),
                      np.stack([i + 1, i + grid + 1, i + grid], -1)], 1)
    return Mesh(vertices=verts.astype(np.float32),
                faces=faces.reshape(-1, 3).astype(np.int32))


def texture(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """High-frequency smooth albedo so ZNCC has signal everywhere."""
    t = (0.5 + 0.18 * np.sin(7.1 * x) * np.cos(6.3 * y)
         + 0.14 * np.sin(13.7 * x + 2.0) + 0.12 * np.cos(11.3 * y + 1.0)
         + 0.06 * np.sin(23.0 * x * y))
    return np.clip(t, 0.02, 0.98)


def albedo(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(..., 3) RGB albedo in [0.02, 0.98]: ``texture`` shifted by a
    different phase per channel, so the channels differ but keep its
    detail."""
    return np.stack([texture(x + 0.37 * c, y - 0.23 * c) for c in range(3)], -1)


def camera_intrinsics(W: int, H: int) -> np.ndarray:
    return np.array([[0.9 * W, 0, W / 2 - 0.5], [0, 0.9 * W, H / 2 - 0.5],
                     [0, 0, 1.0]])


def camera_center(i: int) -> np.ndarray:
    return np.array([-1.6 + 0.8 * i, 0.15 * (i % 2), 0.0])


def undistort_normalized(xd: np.ndarray, yd: np.ndarray, dist, iters: int = 40
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The normalized pinhole coordinates (x, y) that OpenCV's distortion
    model with coefficients (k1, k2, p1, p2) sends to (xd, yd), by the
    fixed-point iteration of ``cv2.undistortPoints`` (converged to float64
    for coefficients of ``DISTORTION``'s size)."""
    k1, k2, p1, p2 = (float(v) for v in dist)
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + (k2 * r2 + k1) * r2)
        x = (xd - (2 * p1 * x * y + p2 * (r2 + 2 * x * x))) * icdist
        y = (yd - (p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)) * icdist
    return x, y


def ray_march(K: np.ndarray, C: np.ndarray, W: int, H: int,
              t_lo: float = 4.5, t_hi: float = 7.5, step: float = 0.02,
              bisect_iters: int = 40, dist=None) -> Tuple[np.ndarray, np.ndarray]:
    """Depth (0 = miss) and the (x, y) surface point of every pixel of a
    camera with identity rotation centred at C (depth == ray parameter).
    With ``dist`` (OpenCV's k1, k2, p1, p2) the camera is distorted: each
    pixel's ray is the undistortion of its normalized coordinates."""
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    Kinv = np.linalg.inv(K)
    dx = Kinv[0, 0] * uu + Kinv[0, 1] * vv + Kinv[0, 2]
    dy = Kinv[1, 1] * vv + Kinv[1, 2]
    if dist is not None:
        dx, dy = undistort_normalized(dx, dy, dist)

    def g(t):
        return C[2] + t - height(C[0] + t * dx, C[1] + t * dy)

    lo = np.full(uu.shape, np.nan)
    t_prev = t_lo
    g_prev = g(np.full(uu.shape, t_lo))
    for t in np.arange(t_lo + step, t_hi + step / 2, step):
        g_t = g(np.full(uu.shape, t))
        first = np.isnan(lo) & (g_prev < 0) & (g_t >= 0)
        lo[first] = t_prev
        t_prev, g_prev = t, g_t
    hit = ~np.isnan(lo)
    a = np.where(hit, lo, t_lo)
    b = a + step
    for _ in range(bisect_iters):
        m = 0.5 * (a + b)
        below = g(m) < 0
        a = np.where(below, m, a)
        b = np.where(below, b, m)
    t = 0.5 * (a + b)
    x = C[0] + t * dx
    y = C[1] + t * dy
    hit &= (np.abs(x) <= 3.0) & (np.abs(y) <= 3.0)
    return np.where(hit, t, 0.0), np.stack([x, y], -1)


def build_gt_scene(n_views: int = 5, W: int = 320, H: int = 240,
                   grid: int = 96, seed: int = 0, color: bool = False,
                   dist=None) -> Tuple[Scene, List[np.ndarray], dict]:
    """(scene, gt_depths, arrays): the port's Scene, per-view float32
    ground-truth depth maps (0 where a ray misses the surface), and the
    arrays the scene was built from (for ``scene_from_arrays`` on either
    package). Each view has a gray image (``texture`` at the surface point,
    smoothed by a sigma-0.5 Gaussian). With ``color``, each also has an
    (H, W, 3) uint8 color image (``albedo`` x 255, smoothed alike), in
    ``arrays["colors"]`` and on the scene's images: texturing reads it, and
    densify's fusion then colors its points. The gray does not depend on
    it. With ``dist`` (OpenCV's k1, k2, p1, p2) the images are those of
    the distorted camera (``ray_march``); the scene's cameras are K's
    pinhole, so only an undistorted copy of the images fits them."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-3, 3, grid)
    xx, yy = np.meshgrid(g, g)
    verts = np.stack([xx, yy, height(xx, yy)], -1).reshape(-1, 3)

    K = camera_intrinsics(W, H)
    grays, colors, gts, Cs = [], [], [], []
    # the views' ray marches are independent numpy work: run them on threads
    with ThreadPoolExecutor(max_workers=max(1, min(n_views, os.cpu_count() or 1))) as ex:
        marched = list(ex.map(lambda i: ray_march(K, camera_center(i), W, H, dist=dist),
                              range(n_views)))
    for i in range(n_views):
        C = camera_center(i)
        depth, xy = marched[i]
        gray = np.where(depth > 0, texture(xy[..., 0], xy[..., 1]), 0.0)
        grays.append(gaussian_filter(gray.astype(np.float32), 0.5,
                                     mode="mirror"))
        if color:
            rgb = np.where(depth[..., None] > 0, albedo(xy[..., 0], xy[..., 1]), 0.0)
            rgb = gaussian_filter(rgb.astype(np.float32), (0.5, 0.5, 0), mode="mirror")
            colors.append(np.clip(np.rint(rgb * 255), 0, 255).astype(np.uint8))
        gts.append(depth.astype(np.float32))
        Cs.append(C)

    sel = rng.choice(len(verts), 600, replace=False)
    arrays = dict(
        grays=grays,
        Ks=[K] * n_views,
        Rs=[np.eye(3)] * n_views,
        Cs=Cs,
        points=verts[sel].astype(np.float32),
        point_views=[np.arange(n_views, dtype=np.uint32)] * len(sel),
    )
    if color:
        arrays["colors"] = colors
    return scene_from_arrays(**arrays), gts, arrays


def depth_quality(depth: np.ndarray, gt: np.ndarray, rel: float = 0.01
                  ) -> Tuple[float, float]:
    """(accuracy, completeness) of one depth map against ground truth:
    the share of valid depths within ``rel`` relative error of the truth
    (a depth where the truth is empty counts as wrong), and the share of
    ground-truth pixels that got a depth."""
    valid = depth > 0
    has_gt = gt > 0
    good = valid & has_gt & (np.abs(depth - gt) < rel * np.where(has_gt, gt, 1))
    acc = float(good.sum() / max(int(valid.sum()), 1))
    comp = float((valid & has_gt).sum() / max(int(has_gt.sum()), 1))
    return acc, comp


def write_scene_files(folder: str, n_views: int = 5, W: int = 1280, H: int = 960,
                      seed: int = 0) -> Tuple[str, dict, List[np.ndarray], dict]:
    """The colored scene of ``build_gt_scene`` as files, the way a user
    hands a scene to the CLI: one JPEG (quality 95, through
    ``io/images.write_image``) per view, ``view0000.jpg``..., and
    ``scene.mvs`` (``Scene.save``: cameras, absolute image paths and the
    sparse cloud). Returns (path of scene.mvs, {file name: sha256 of its
    bytes}, ground-truth depths, the arrays)."""
    import hashlib

    from openmvs_tpu_torch.io import images as imio

    os.makedirs(folder, exist_ok=True)
    scene, gts, arrays = build_gt_scene(n_views=n_views, W=W, H=H, seed=seed,
                                        color=True)
    digests = {}
    for i, img in enumerate(scene.images):
        path = os.path.join(folder, f"view{i:04d}.jpg")
        imio.write_image(path, arrays["colors"][i])
        with open(path, "rb") as f:
            digests[os.path.basename(path)] = hashlib.sha256(f.read()).hexdigest()
        img.path = path
        img.release()
    mvs = os.path.join(folder, "scene.mvs")
    scene.save(mvs)
    return mvs, digests, gts, arrays


# OpenCV (k1, k2, p1, p2) of the distorted camera of ``write_eth3d_files``:
# a consumer lens's size, about 7 px of barrel at the corners of 1280x960
DISTORTION = (-0.12, 0.04, 4e-4, -3e-4)


def _write_colmap_text(folder: str, model: str, params, W: int, H: int,
                       names: List[str], centers: List[np.ndarray],
                       points: np.ndarray, rgb: np.ndarray) -> None:
    """A COLMAP text model: one camera, identity rotations (qvec 1 0 0 0,
    tvec = -C), every point seen by every image."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "cameras.txt"), "w") as f:
        f.write(f"1 {model} {W} {H} " + " ".join(repr(float(v)) for v in params) + "\n")
    with open(os.path.join(folder, "images.txt"), "w") as f:
        for i, (name, C) in enumerate(zip(names, centers)):
            t = " ".join(repr(float(v)) for v in -np.asarray(C, np.float64))
            f.write(f"{i + 1} 1 0 0 0 {t} 1 {name}\n\n")
    with open(os.path.join(folder, "points3D.txt"), "w") as f:
        track = " ".join(f"{i + 1} 0" for i in range(len(names)))
        for k, (X, c) in enumerate(zip(points.astype(np.float64), rgb)):
            xyz = " ".join(repr(float(v)) for v in X)
            f.write(f"{k + 1} {xyz} {c[0]} {c[1]} {c[2]} 0.5 {track}\n")


def write_eth3d_files(folder: str, n_views: int = 5, W: int = 1280, H: int = 960,
                      seed: int = 0, dist=DISTORTION, gt_grid: int = 800
                      ) -> Tuple[dict, List[np.ndarray]]:
    """The colored scene of ``build_gt_scene`` seen through a distorted
    camera (OpenCV k1, k2, p1, p2 = ``dist``), written as an ETH3D
    training scene: ``images/dslr_images/viewNNNN.jpg`` (quality 95,
    ``io/images.write_image``), the calibration as a COLMAP text model with
    an OPENCV camera in ``dslr_calibration_jpg/`` (ETH3D's folder for its
    distorted images), the same model as PINHOLE with the coefficients
    dropped in ``pinhole_calibration/`` (a control: what importing without
    undistortion gives), and ground truth in ``scan_clean/scan.ply``: the
    height field sampled on a gt_grid x gt_grid lattice over [-3, 3]^2,
    kept where a view's pinhole projection lands inside its image. Returns
    ({file name: sha256} of the images, the ground-truth depth maps)."""
    import hashlib

    from openmvs_tpu_torch.io import images as imio
    from openmvs_tpu_torch.io import ply as plyio

    scene, gts, arrays = build_gt_scene(n_views=n_views, W=W, H=H, seed=seed,
                                        color=True, dist=dist)
    img_dir = os.path.join(folder, "images", "dslr_images")
    os.makedirs(img_dir, exist_ok=True)
    digests, names = {}, []
    for i in range(n_views):
        name = f"view{i:04d}.jpg"
        path = os.path.join(img_dir, name)
        imio.write_image(path, arrays["colors"][i])
        with open(path, "rb") as f:
            digests[name] = hashlib.sha256(f.read()).hexdigest()
        names.append(f"images/dslr_images/{name}")
    K = camera_intrinsics(W, H)
    pts = arrays["points"]
    rgb = np.full((len(pts), 3), 128, np.uint8)
    pin = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]
    _write_colmap_text(os.path.join(folder, "dslr_calibration_jpg"), "OPENCV",
                       pin + list(dist), W, H, names, arrays["Cs"], pts, rgb)
    _write_colmap_text(os.path.join(folder, "pinhole_calibration"), "PINHOLE",
                       pin, W, H, names, arrays["Cs"], pts, rgb)
    g = np.linspace(-3, 3, gt_grid)
    xx, yy = np.meshgrid(g, g)
    X = np.stack([xx, yy, height(xx, yy)], -1).reshape(-1, 3)
    seen = np.zeros(len(X), bool)
    for C in arrays["Cs"]:
        p = (X - C) @ K.T
        u, v = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
        seen |= (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    os.makedirs(os.path.join(folder, "scan_clean"), exist_ok=True)
    plyio.save_point_cloud(os.path.join(folder, "scan_clean", "scan.ply"),
                           X[seen].astype(np.float32))
    return digests, gts
