"""COLMAP sparse-model import/export.

A copy of ``openmvs_tpu/interfaces/colmap.py``; a distorted camera
model's images are undistorted on import (``interfaces/undistort.py``, the
port's rebuild of ``cv2.undistort``). Equivalent of apps/InterfaceCOLMAP (InterfaceCOLMAP.cpp:67,183-184,706,990,1417-1443):
reads a COLMAP sparse reconstruction (cameras/images/points3D in
.bin or .txt form, typically the `sparse/` or `dense/sparse` folder of a
COLMAP workspace with undistorted images) into the .mvs Interface, and
exports back.

COLMAP conventions: world-to-camera rotation as quaternion qvec (w x y z) and
translation tvec; camera center C = -R^T t.  One MVS platform per COLMAP
camera; each image becomes a pose on its camera's platform (the reference
does the same, InterfaceCOLMAP.cpp:706-990).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from openmvs_tpu_torch.io import mvs as mvsio
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("colmap")

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
NAME_TO_ID = {v[0]: k for k, v in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec_to_R(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def R_to_qvec(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([s / 4, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[i + 1] = s / 4
    q[j + 1] = (R[j, i] + R[i, j]) / s
    q[k + 1] = (R[k, i] + R[i, k]) / s
    return q


def _K_from_params(model: str, p: np.ndarray) -> np.ndarray:
    # single-focal models (params f, cx, cy, [k...]): SIMPLE_PINHOLE,
    # SIMPLE_RADIAL(_FISHEYE), RADIAL(_FISHEYE).  Everything else —
    # PINHOLE, OPENCV*, FULL_OPENCV, FOV, THIN_PRISM_FISHEYE — is
    # fx fy cx cy [...] (COLMAP src/colmap/sensor/models.h)
    if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "SIMPLE_RADIAL_FISHEYE",
                 "RADIAL", "RADIAL_FISHEYE"):
        f, cx, cy = p[0], p[1], p[2]
        return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


# ----------------------------------------------------------------- readers
def read_cameras(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    if path.endswith(".bin"):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                cid, mid = struct.unpack("<ii", f.read(8))
                w, h = struct.unpack("<QQ", f.read(16))
                name, np_ = CAMERA_MODELS[mid]
                params = np.frombuffer(f.read(8 * np_), np.float64).copy()
                cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    else:
        for line in open(path):
            if line.startswith("#") or not line.strip():
                continue
            t = line.split()
            cid, model = int(t[0]), t[1]
            cams[cid] = ColmapCamera(
                cid, model, int(t[2]), int(t[3]), np.array([float(x) for x in t[4:]])
            )
    return cams


def read_images(path: str) -> Dict[int, ColmapImage]:
    imgs: Dict[int, ColmapImage] = {}
    if path.endswith(".bin"):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                (iid,) = struct.unpack("<i", f.read(4))
                q = np.frombuffer(f.read(32), np.float64).copy()
                t = np.frombuffer(f.read(24), np.float64).copy()
                (cid,) = struct.unpack("<i", f.read(4))
                name = b""
                while True:
                    c = f.read(1)
                    if c == b"\x00":
                        break
                    name += c
                (npts,) = struct.unpack("<Q", f.read(8))
                f.read(24 * npts)  # skip 2D points (x, y, point3D_id)
                imgs[iid] = ColmapImage(iid, q, t, cid, name.decode())
    else:
        # images.txt has exactly 2 lines per image, the 2nd (2D points) may
        # be empty — keep blank lines so pairing stays aligned
        lines = [l.rstrip("\n") for l in open(path) if not l.startswith("#")]
        for i in range(0, len(lines) - 1 + len(lines) % 2, 2):
            t = lines[i].split()
            if len(t) < 10:
                continue
            imgs[int(t[0])] = ColmapImage(
                int(t[0]), np.array([float(x) for x in t[1:5]]),
                np.array([float(x) for x in t[5:8]]), int(t[8]), t[9],
            )
    return imgs


def read_points3d(path: str):
    """Returns (xyz (n,3) f64, rgb (n,3) u8, tracks: list of image-id arrays)."""
    xyz, rgb, tracks = [], [], []
    if path.endswith(".bin"):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                f.read(8)  # point3D_id
                xyz.append(np.frombuffer(f.read(24), np.float64).copy())
                rgb.append(np.frombuffer(f.read(3), np.uint8).copy())
                f.read(8)  # error
                (tl,) = struct.unpack("<Q", f.read(8))
                tr = np.frombuffer(f.read(8 * tl), np.int32).reshape(-1, 2)[:, 0].copy()
                tracks.append(tr)
    else:
        for line in open(path):
            if line.startswith("#") or not line.strip():
                continue
            t = line.split()
            xyz.append(np.array([float(x) for x in t[1:4]]))
            rgb.append(np.array([int(x) for x in t[4:7]], np.uint8))
            tracks.append(np.array([int(x) for x in t[8::2]], np.int32))
    return (np.asarray(xyz).reshape(-1, 3), np.asarray(rgb, np.uint8).reshape(-1, 3), tracks)


def _find(folder: str, stem: str) -> str:
    for ext in (".bin", ".txt"):
        p = os.path.join(folder, stem + ext)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"{stem}.bin/.txt not found in {folder}")


# ----------------------------------------------------------------- import
def import_colmap(sparse_folder: str, images_folder: str = "",
                  undistort_dir: str = "") -> mvsio.Interface:
    """COLMAP sparse model -> .mvs Interface.

    Distorted camera models (SIMPLE_RADIAL/RADIAL/OPENCV/...) are undistorted
    on import when `undistort_dir` is given (default: `<sparse>/undistorted`)
    — the reference expects `colmap image_undistorter` output; importing raw
    distorted images silently breaks the homography warps."""
    from openmvs_tpu_torch.interfaces import undistort as und

    cams = read_cameras(_find(sparse_folder, "cameras"))
    imgs = read_images(_find(sparse_folder, "images"))
    xyz, rgb, tracks = read_points3d(_find(sparse_folder, "points3D"))

    itf = mvsio.Interface()
    cam_to_platform: Dict[int, int] = {}
    plat_dists: Dict[int, object] = {}
    for cid, cam in sorted(cams.items()):
        dist = und.colmap_dist_coeffs(cam.model, cam.params)
        if dist is not None:
            plat_dists[len(itf.platforms)] = dist
        # normalized K (reference stores K normalized by max dimension when
        # resolution is unset; we keep absolute K + resolution)
        rig = mvsio.CameraRig(
            name=f"cam{cid}", width=cam.width, height=cam.height,
            K=_K_from_params(cam.model, cam.params),
        )
        plat = mvsio.Platform(name=f"platform{cid}", cameras=[rig])
        cam_to_platform[cid] = len(itf.platforms)
        itf.platforms.append(plat)

    id_map: Dict[int, int] = {}  # colmap image id -> mvs image index
    for iid, im in sorted(imgs.items()):
        pid = cam_to_platform[im.camera_id]
        plat = itf.platforms[pid]
        R = qvec_to_R(im.qvec)
        C = -R.T @ im.tvec
        pose_id = len(plat.poses)
        plat.poses.append(mvsio.Pose(R=R, C=C))
        meta = mvsio.ImageMeta(
            name=os.path.join(images_folder, im.name) if images_folder else im.name,
            platform_id=pid, camera_id=0, pose_id=pose_id, id=len(itf.images),
        )
        id_map[iid] = len(itf.images)
        itf.images.append(meta)

    if plat_dists:
        und.undistort_interface_images(
            itf, plat_dists,
            undistort_dir or os.path.join(sparse_folder, "undistorted"))

    itf.points = xyz.astype(np.float32)
    itf.colors = rgb
    itf.point_views = [
        np.asarray(sorted({id_map[i] for i in tr if i in id_map}), np.uint32)
        for tr in tracks
    ]
    itf.point_confidences = []
    # drop points with <2 views (cannot triangulate / seed)
    keep = np.array([len(v) >= 2 for v in itf.point_views], bool)
    itf.points = itf.points[keep]
    itf.colors = itf.colors[keep]
    itf.point_views = [v for v, k in zip(itf.point_views, keep) if k]
    log.info("COLMAP import: %d cameras, %d images, %d points",
             len(cams), len(imgs), len(itf.points))
    return itf


# ----------------------------------------------------------------- export
def export_colmap(itf: mvsio.Interface, out_folder: str,
                  binary: bool = False):
    """.mvs Interface -> COLMAP model.

    Text (cameras/images/points3D.txt) by default; `binary=True` writes the
    COLMAP .bin model instead — the byte format COLMAP itself produces and
    the reference writes back in ExportScene (InterfaceCOLMAP.cpp:1417-1443)
    — so downstream COLMAP tooling (model_converter, patch-match, gui) can
    consume the result directly."""
    os.makedirs(out_folder, exist_ok=True)
    cam_ids = {}
    if binary:
        with open(os.path.join(out_folder, "cameras.bin"), "wb") as f:
            ncams = sum(len(p.cameras) for p in itf.platforms)
            f.write(struct.pack("<Q", ncams))
            for pi, plat in enumerate(itf.platforms):
                for ci, cam in enumerate(plat.cameras):
                    cid = len(cam_ids) + 1
                    cam_ids[(pi, ci)] = cid
                    K = np.asarray(cam.K, np.float64)
                    f.write(struct.pack("<ii", cid, NAME_TO_ID["PINHOLE"]))
                    f.write(struct.pack("<QQ", int(cam.width), int(cam.height)))
                    f.write(np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                                     np.float64).tobytes())
    else:
        with open(os.path.join(out_folder, "cameras.txt"), "w") as f:
            f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS\n")
            for pi, plat in enumerate(itf.platforms):
                for ci, cam in enumerate(plat.cameras):
                    cid = len(cam_ids) + 1
                    cam_ids[(pi, ci)] = cid
                    K = cam.K
                    f.write(f"{cid} PINHOLE {cam.width} {cam.height} "
                            f"{K[0,0]} {K[1,1]} {K[0,2]} {K[1,2]}\n")
    # per-image camera composition (reused for the 2D observation lists)
    cams = []
    for im in itf.images:
        plat = itf.platforms[im.platform_id]
        rig = plat.cameras[im.camera_id]
        pose = plat.poses[im.pose_id]
        R = rig.R @ pose.R
        C = pose.R.T @ rig.C + pose.C
        cams.append((R, C, np.asarray(rig.K, np.float64)))
    # a consistent COLMAP model requires each track element to reference a
    # real POINT2D entry of its image: build per-image observation lists
    # (x y POINT3D_ID) by projecting the point, and record the index
    obs: List[List[tuple]] = [[] for _ in itf.images]
    tracks: List[str] = []
    for i, p in enumerate(itf.points):
        parts = []
        for v in (itf.point_views[i] if itf.point_views else ()):  # noqa: B905
            v = int(v)
            if v >= len(cams):
                continue
            R, C, K = cams[v]
            Xc = R @ (np.asarray(p, np.float64) - C)
            if Xc[2] <= 1e-12:
                continue
            u = K[0, 0] * Xc[0] / Xc[2] + K[0, 2]
            w_ = K[1, 1] * Xc[1] / Xc[2] + K[1, 2]
            parts.append((v + 1, len(obs[v])))
            obs[v].append((u, w_, i + 1))
        tracks.append(parts)
    if binary:
        with open(os.path.join(out_folder, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(itf.images)))
            for i, im in enumerate(itf.images):
                R, C, _ = cams[i]
                q = R_to_qvec(R)
                t = -R @ C
                f.write(struct.pack("<i", i + 1))
                f.write(np.asarray(q, np.float64).tobytes())
                f.write(np.asarray(t, np.float64).tobytes())
                f.write(struct.pack("<i", cam_ids[(im.platform_id,
                                                   im.camera_id)]))
                f.write(os.path.basename(im.name).encode() + b"\x00")
                f.write(struct.pack("<Q", len(obs[i])))
                for u, v_, pid in obs[i]:
                    f.write(struct.pack("<ddq", u, v_, pid))
        with open(os.path.join(out_folder, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(itf.points)))
            has_col = len(itf.colors) == len(itf.points)
            for i, p in enumerate(itf.points):
                col = itf.colors[i] if has_col else (128, 128, 128)
                f.write(struct.pack("<Q", i + 1))
                f.write(np.asarray(p, np.float64).tobytes())
                f.write(struct.pack("<BBB", int(col[0]), int(col[1]),
                                    int(col[2])))
                f.write(struct.pack("<d", 0.0))
                f.write(struct.pack("<Q", len(tracks[i])))
                for img_id, p2d_idx in tracks[i]:
                    f.write(struct.pack("<ii", img_id, p2d_idx))
        log.info("COLMAP binary export: %d images, %d points -> %s",
                 len(itf.images), len(itf.points), out_folder)
        return
    with open(os.path.join(out_folder, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i, im in enumerate(itf.images):
            R, C, _ = cams[i]
            q = R_to_qvec(R)
            t = -R @ C
            cid = cam_ids[(im.platform_id, im.camera_id)]
            pts2d = " ".join(f"{u} {v_} {pid}" for u, v_, pid in obs[i])
            f.write(f"{i+1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} "
                    f"{cid} {os.path.basename(im.name)}\n{pts2d}\n")
    with open(os.path.join(out_folder, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        has_col = len(itf.colors) == len(itf.points)
        for i, p in enumerate(itf.points):
            col = itf.colors[i] if has_col else (128, 128, 128)
            tr = " ".join(f"{a} {b}" for a, b in tracks[i])
            f.write(f"{i+1} {p[0]} {p[1]} {p[2]} {col[0]} {col[1]} {col[2]} "
                    f"0 {tr}\n")
