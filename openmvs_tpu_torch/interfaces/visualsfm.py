"""VisualSFM .nvm import (apps/InterfaceVisualSFM equivalent,
InterfaceVisualSFM.cpp:44,104).

NVM_V3 layout: per camera `name focal qw qx qy qz cx cy cz r 0`, then points
`x y z r g b n_meas (img_idx feat_idx u v)*`.  VisualSFM stores camera
CENTERS and a w-first quaternion; images with nonzero radial distortion are
UNDISTORTED on import (the reference's own import undistorts before densify,
InterfaceVisualSFM.cpp:457; the NVM model x_d = x_u (1 + k r_u^2) equals
OpenCV's k1-only model in f-normalized coordinates).

Also reads Bundler `.out` + `list.txt` (InterfaceVisualSFM.cpp:44 role).

A copy of ``openmvs_tpu/interfaces/visualsfm.py``; image sizes come from
the file headers (``io/images.image_size``) where the JAX package opens the
images with PIL.
"""

from __future__ import annotations

import os

import numpy as np

from openmvs_tpu_torch.interfaces.colmap import qvec_to_R
from openmvs_tpu_torch.io import mvs as mvsio
from openmvs_tpu_torch.io.images import image_size
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("visualsfm")


def import_nvm(path: str, images_folder: str = "",
               undistort_dir: str = "") -> mvsio.Interface:
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    magic = next(it)
    if not magic.startswith("NVM_V3"):
        raise ValueError(f"unsupported NVM magic: {magic}")
    # optional 'FixedK' calibration line is not supported
    n_cams = int(next(it))
    folder = images_folder or os.path.dirname(os.path.abspath(path))
    itf = mvsio.Interface()
    _dists = {}
    for i in range(n_cams):
        name = next(it)
        focal = float(next(it))
        q = np.array([float(next(it)) for _ in range(4)])
        C = np.array([float(next(it)) for _ in range(3)])
        r = float(next(it))
        next(it)  # trailing 0
        img_path = name if os.path.isabs(name) else os.path.join(folder, name)
        w = h = 0
        if os.path.exists(img_path):
            w, h = image_size(img_path)
        else:
            log.warning("NVM image missing: %s (camera keeps w=h=0; fix "
                        "the images folder before densifying)", img_path)
        K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
        R = qvec_to_R(q)
        plat = mvsio.Platform(
            name=f"cam{i}",
            cameras=[mvsio.CameraRig(name=name, width=w, height=h, K=K)],
            poses=[mvsio.Pose(R=R, C=C)],
        )
        meta = mvsio.ImageMeta(name=img_path, platform_id=i, camera_id=0,
                               pose_id=0, id=i)
        if abs(r) > 1e-12:
            # NVM stores the pixel-measurement coefficient; the normalized
            # (OpenCV-convention) k1 = r * f^2
            # (GetNormalizedMeasurementDistortion, DataInterface.h:91)
            _dists[i] = np.array([r * focal * focal, 0, 0, 0, 0])
        itf.platforms.append(plat)
        itf.images.append(meta)

    if _dists:
        from openmvs_tpu_torch.interfaces import undistort as und

        und.undistort_interface_images(
            itf, _dists, undistort_dir or os.path.join(folder, "undistorted"))

    n_pts = int(next(it))
    pts, views_list, colors = [], [], []
    for _ in range(n_pts):
        X = [float(next(it)) for _ in range(3)]
        rgb = [int(next(it)) for _ in range(3)]
        n_meas = int(next(it))
        vs = set()
        for _ in range(n_meas):
            img_idx = int(next(it))
            next(it); next(it); next(it)  # feat_idx, u, v
            vs.add(img_idx)
        vs = sorted(v for v in vs if v < n_cams)
        if len(vs) < 2:
            continue
        pts.append(X)
        views_list.append(np.asarray(vs, np.uint32))
        colors.append(rgb)
    itf.points = np.asarray(pts, np.float32).reshape(-1, 3)
    itf.point_views = views_list
    itf.colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    log.info("NVM import: %d cameras, %d points", n_cams, len(itf.points))
    return itf


def import_bundler(out_path: str, list_path: str = "",
                   images_folder: str = "",
                   undistort_dir: str = "") -> mvsio.Interface:
    """Bundler `bundle.out` + image list import (InterfaceVisualSFM.cpp:44).

    Format (v0.3): `<ncams> <npts>`; per camera `f k1 k2 / R(3 lines) /
    t`; per point `pos / rgb / <n> (<img> <key> <x> <y>)*`.  Bundler cameras
    look down -Z with +Y up (OpenGL); converted to the CV convention by
    diag(1,-1,-1).  Distorted images (k1/k2 != 0) are undistorted on import.
    """
    folder = images_folder or os.path.dirname(os.path.abspath(out_path))
    if not list_path:
        for cand in ("list.txt", "image_list.txt"):
            p = os.path.join(folder, cand)
            if os.path.exists(p):
                list_path = p
                break
    names = []
    if list_path and os.path.exists(list_path):
        with open(list_path) as f:
            names = [ln.split()[0] for ln in f if ln.strip()]

    with open(out_path) as f:
        tokens = [t for ln in f if not ln.startswith("#") for t in ln.split()]
    it = iter(tokens)
    n_cams = int(next(it))
    n_pts = int(next(it))
    S = np.diag([1.0, -1.0, -1.0])
    itf = mvsio.Interface()
    _dists = {}
    orig_to_new = {}
    n_missing = 0
    for i in range(n_cams):
        focal = float(next(it))
        k1 = float(next(it))
        k2 = float(next(it))
        R_gl = np.array([[float(next(it)) for _ in range(3)] for _ in range(3)])
        t_gl = np.array([float(next(it)) for _ in range(3)])
        if focal <= 0:
            # unregistered camera (Bundler writes '0 0 0' and zero
            # matrices for images that failed to register): skip — a
            # singular K would blow up every downstream inverse
            continue
        R = S @ R_gl
        t = S @ t_gl
        C = -R.T @ t
        name = names[i] if i < len(names) else f"{i:08d}.jpg"
        img_path = name if os.path.isabs(name) else os.path.join(folder, name)
        w = h = 0
        if os.path.exists(img_path):
            w, h = image_size(img_path)
        else:
            n_missing += 1
        K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
        j = len(itf.images)
        orig_to_new[i] = j
        plat = mvsio.Platform(
            name=f"cam{i}",
            cameras=[mvsio.CameraRig(name=name, width=w, height=h, K=K)],
            poses=[mvsio.Pose(R=R, C=C)],
        )
        itf.platforms.append(plat)
        itf.images.append(mvsio.ImageMeta(
            name=img_path, platform_id=j, camera_id=0, pose_id=0, id=j))
        if abs(k1) > 1e-12 or abs(k2) > 1e-12:
            # bundler distorts in normalized coords: p' = p (1 + k1 r^2 + k2 r^4)
            _dists[j] = np.array([k1, k2, 0, 0, 0])
    if n_missing:
        log.warning("%d/%d images not found under %s: widths/principal "
                    "points default to 0 — pass the correct images folder",
                    n_missing, len(itf.images), folder)

    if _dists:
        from openmvs_tpu_torch.interfaces import undistort as und

        und.undistort_interface_images(
            itf, _dists, undistort_dir or os.path.join(folder, "undistorted"))

    pts, views_list, colors = [], [], []
    for _ in range(n_pts):
        X = [float(next(it)) for _ in range(3)]
        rgb = [int(next(it)) for _ in range(3)]
        n_meas = int(next(it))
        vs = set()
        for _ in range(n_meas):
            img_idx = int(next(it))
            next(it); next(it); next(it)
            vs.add(img_idx)
        vs = sorted(orig_to_new[v] for v in vs if v in orig_to_new)
        if len(vs) < 2:
            continue
        pts.append(X)
        views_list.append(np.asarray(vs, np.uint32))
        colors.append(rgb)
    itf.points = np.asarray(pts, np.float32).reshape(-1, 3)
    itf.point_views = views_list
    itf.colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    log.info("Bundler import: %d cameras, %d points", n_cams, len(itf.points))
    return itf
