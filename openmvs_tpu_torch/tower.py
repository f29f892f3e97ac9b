"""Tower mode: cylindrical scene prior for radial captures.

A copy of ``openmvs_tpu/tower.py`` (host numpy). Role equivalent of the
reference's InitTowerScene / ComputeTowerCylinder / BuildTowerMesh
(Scene.cpp:1749-2078): detect that the cameras orbit a vertical axis
(tower-like capture), synthesize a cylinder of oriented seed points around
that axis, and use them to replace/augment the sparse cloud or to drive
neighbor-view selection.  Assumes a Z-up scene in metric units, as the
reference does.

Modes (matching DensifyPointCloud's --towermode):
  0  disabled
  1  replace the sparse cloud with the tower ring cloud
  2  append the ring cloud to the sparse cloud
  3  use the ring cloud only for neighbor-view selection
  4  select neighbor views from the ring cloud, then append it
  <0 force tower geometry even if the detection heuristics fail
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

from openmvs_tpu_torch.scene import PointCloud, Scene

log = logging.getLogger("omvs_torch.tower")

# ring density: points (and circles) per scene unit, Scene.cpp:1856
TARGET_DENSITY = 10


def compute_tower_cylinder(
    scene: Scene, tower_mode: int
) -> Optional[Tuple[np.ndarray, float, float, float, float, float]]:
    """Detect a tower-like camera rig.

    Returns (center_xy, radius, roi_radius, z_min, z_max, min_cam_z) or None.
    Reference: Scene.cpp:1749-1820."""
    n_cams = len(scene.images)
    if tower_mode > 0 and n_cams < 20:
        log.info("too few images to be a tower: %d", n_cams)
        return None

    C = np.stack([im.camera.C for im in scene.images]).astype(np.float64)
    mean = C.mean(axis=0)
    d = C - mean
    # principal spreads of the camera positions: a tower orbit (ring/helix
    # around a vertical axis) is long along the axis and comparably narrow in
    # the two transverse directions; the axis must also be near-vertical
    # (the reference's cylinder math assumes a Z-up scene, Scene.cpp:2023)
    _, s, Vt = np.linalg.svd(d, full_matrices=False)
    s = s / max(np.sqrt(n_cams), 1.0)
    s0, s1 = float(s[0]), float(s[1])
    vertical = abs(Vt[0, 2]) > 0.85
    if s0 <= 0 or (s1 / s0 > 0.6) or not vertical:
        if tower_mode > 0:
            log.info("does not seem to be a tower: spreads %.2f/%.2f, axis_z %.2f",
                     s0, s1, abs(Vt[0, 2]) if s0 > 0 else 0.0)
            return None

    min_cam_z = float(C[:, 2].min())
    center = mean[:2].copy()
    z_min = min_cam_z - 5.0
    z_max = float(C[:, 2].max())
    if len(scene.pointcloud) > 0:
        pz = np.asarray(scene.pointcloud.points)[:, 2]
        z_min = min(z_min, float(pz.min()))
        z_max = max(z_max, float(pz.max()))

    dist = np.linalg.norm(C[:, :2] - center[None], axis=1)
    radius = max(0.2, (float(np.median(dist)) - 1.0) / 3.0)
    # ROI radius: mean of the 85th..95th percentile distances
    ds = np.sort(dist)
    lo = int(np.floor(len(ds) * 0.85))
    hi = max(lo + 1, int(np.ceil(len(ds) * 0.95)))
    roi_radius = float(ds[lo:hi].mean())
    return center, radius, roi_radius, z_min, z_max, min_cam_z


def _circle_points(
    scene: Scene,
    center: np.ndarray,
    z: float,
    radius: float,
    n_points: int,
    start_angle: float,
) -> Tuple[np.ndarray, np.ndarray, list]:
    """Oriented ring points visible in >= 2 cameras (DrawCircle,
    Scene.cpp:1824-1852): a point is kept if it projects inside an image with
    positive depth and its outward normal faces the camera."""
    ang = start_angle + (2 * np.pi / n_points) * np.arange(n_points)
    normals = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], axis=1)
    pts = np.concatenate(
        [center[None] + radius * normals[:, :2], np.full((n_points, 1), z)], axis=1
    )
    views = [[] for _ in range(n_points)]
    for idx, im in enumerate(scene.images):
        cam = im.camera
        uvz = (pts @ cam.R[2] - cam.R[2] @ cam.C)  # depth along principal axis
        proj = (pts - cam.C[None]) @ cam.R.T @ cam.K.T
        with np.errstate(divide="ignore", invalid="ignore"):
            u = proj[:, 0] / proj[:, 2]
            v = proj[:, 1] / proj[:, 2]
        inside = (uvz > 0) & (u >= 0) & (v >= 0) & (u < im.width) & (v < im.height)
        # normal must face the camera: n . ray(point->camera) > 0
        ray = cam.C[None] - pts
        facing = np.einsum("ij,ij->i", normals, ray) > 0
        for p in np.nonzero(inside & facing)[0]:
            views[p].append(im.meta.id)
    keep = np.array([len(v) >= 2 for v in views])
    return pts[keep], normals[keep], [np.asarray(views[i], np.uint32) for i in np.nonzero(keep)[0]]


def build_tower_cloud(
    scene: Scene,
    center: np.ndarray,
    radius: float,
    roi_radius: float,
    z_min: float,
    z_max: float,
    min_cam_z: float,
    fix_radius: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> PointCloud:
    """Ring cloud over the cylinder with per-slice adaptive radii
    (BuildTowerMesh, Scene.cpp:1854-1960)."""
    rng = rng or np.random.default_rng(0)
    n_circles = max(2, int(round((z_max - z_min) * TARGET_DENSITY)))
    dz = (z_max - z_min) / n_circles

    radii = np.full(n_circles, radius, np.float64)
    if not fix_radius and len(scene.pointcloud) > 0:
        # per-slice trimmed mean (50%..95%) of point distances from the axis
        P = np.asarray(scene.pointcloud.points, np.float64)
        d = np.linalg.norm(P[:, :2] - center[None], axis=1)
        in_roi = d <= roi_radius
        fidx = (z_max - P[:, 2]) * TARGET_DENSITY
        b = np.floor(fidx).astype(int)
        t = np.floor(fidx + 0.5).astype(int)
        b = np.where((b == t) & (b > 0), b - 1, b)
        t = np.minimum(t, n_circles - 1)
        slices = [[] for _ in range(n_circles)]
        for pi in np.nonzero(in_roi)[0]:
            if b[pi] < n_circles - 1:
                slices[b[pi]].append(d[pi])
            if t[pi] > 0:
                slices[t[pi]].append(d[pi])
        for ci in range(n_circles):
            z = z_max - dz * ci
            if z < min_cam_z:
                continue  # fixed radius below the lowest camera
            sd = np.sort(np.asarray(slices[ci]))
            if len(sd) > 2:
                lo = max(1, int(np.floor(len(sd) * 0.5)))
                hi = min(len(sd) - 1, int(np.ceil(len(sd) * 0.95)))
                if hi > lo:
                    avg = float(sd[lo:hi].mean())
                    if avg < roi_radius * 0.8:
                        radii[ci] = avg
        # smooth radii: median-of-7 guided pick between the two neighbors
        # (Scene.cpp:1925-1943)
        r = radii.copy()
        for ri in range(1, n_circles - 1):
            above, below = r[ri - 1], r[ri + 1]
            if 2 < ri < n_circles - 5:
                med = float(np.median(r[ri - 2 : ri + 5]))
                radii[ri] = above if abs(med - above) < abs(med - below) else below
            else:
                radii[ri] = 0.5 * (above + below)

    pts_all, nrm_all, views_all = [], [], []
    for ci in range(n_circles):
        z = z_max - dz * ci
        r = float(radii[ci])
        n_points = max(10, int(round(2 * np.pi * r * TARGET_DENSITY)))
        start = (2 * np.pi / n_points) * float(rng.uniform())
        p, n, v = _circle_points(scene, center, z, r, n_points, start)
        pts_all.append(p)
        nrm_all.append(n)
        views_all.extend(v)
    points = np.concatenate(pts_all, axis=0).astype(np.float32)
    normals = np.concatenate(nrm_all, axis=0).astype(np.float32)
    weights = [np.ones(len(v), np.float32) for v in views_all]
    return PointCloud(points=points, views=views_all, weights=weights,
                      normals=normals)


def init_tower_scene(scene: Scene, tower_mode: int, opts=None) -> bool:
    """Detect + apply tower mode to the scene in place (InitTowerScene,
    Scene.cpp:2026-2078).  Returns True if the scene was tower-like."""
    if tower_mode == 0:
        return False
    cyl = compute_tower_cylinder(scene, tower_mode)
    if cyl is None:
        return False
    center, radius, roi_radius, z_min, z_max, min_cam_z = cyl
    tower_pc = build_tower_cloud(
        scene, center, radius, roi_radius, z_min, z_max, min_cam_z, fix_radius=False
    )
    mode = abs(tower_mode)

    def append(dst: PointCloud, src: PointCloud) -> PointCloud:
        def opt(a, b, nd, dtype):
            # keep normals/colors when EITHER side carries them (pad the
            # other with zeros); drop only when both sides lack them
            ha = len(a.normals if nd == "n" else a.colors) == len(a.points)
            hb = len(b.normals if nd == "n" else b.colors) == len(b.points)
            if not (ha or hb):
                return np.zeros((0, 3), dtype)
            xa = (np.asarray(a.normals if nd == "n" else a.colors)
                  if ha else np.zeros((len(a.points), 3), dtype))
            xb = (np.asarray(b.normals if nd == "n" else b.colors)
                  if hb else np.zeros((len(b.points), 3), dtype))
            return np.concatenate([xa, xb]).astype(dtype)

        return PointCloud(
            points=np.concatenate([np.asarray(dst.points), np.asarray(src.points)]),
            views=list(dst.views) + list(src.views),
            weights=list(dst.weights) + list(src.weights),
            normals=opt(dst, src, "n", np.float32),
            colors=opt(dst, src, "c", np.uint8),
        )

    if mode == 1:
        scene.pointcloud = tower_pc
        log.info("tower-like scene: replaced cloud with %d ring points", len(tower_pc))
    elif mode == 2:
        scene.pointcloud = append(scene.pointcloud, tower_pc)
        log.info("tower-like scene: appended %d ring points", len(tower_pc))
    elif mode in (3, 4):
        from openmvs_tpu_torch.config import DenseOptions
        from openmvs_tpu_torch.view_selection import select_views_for_scene

        orig = scene.pointcloud
        scene.pointcloud = tower_pc
        select_views_for_scene(scene, opts or DenseOptions())
        scene.pointcloud = orig
        if mode == 4:
            scene.pointcloud = append(scene.pointcloud, tower_pc)
        log.info("tower-like scene: view selection from %d ring points%s",
                 len(tower_pc), " + appended" if mode == 4 else "")
    return True
