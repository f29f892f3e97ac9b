"""Polycam capture-folder import (apps/InterfacePolycam equivalent,
InterfacePolycam.cpp:173,273).

Layout: <root>/keyframes/{corrected_cameras|cameras}/<ts>.json with fields
fx fy cx cy width height and a blender/ARKit-style camera-to-world transform
t_00..t_23; images in keyframes/{corrected_images|images}/<ts>.jpg; optional
depth maps in keyframes/depth.

A copy of ``openmvs_tpu/interfaces/polycam.py``.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from openmvs_tpu_torch.io import mvs as mvsio
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("polycam")


def import_polycam(root: str) -> mvsio.Interface:
    kf = os.path.join(root, "keyframes")
    cam_dir = None
    img_dir = None
    for c, i in (("corrected_cameras", "corrected_images"), ("cameras", "images")):
        if os.path.isdir(os.path.join(kf, c)):
            cam_dir = os.path.join(kf, c)
            img_dir = os.path.join(kf, i)
            if not os.path.isdir(img_dir):
                # exports sometimes carry corrected_cameras without
                # corrected_images: fall back to the raw images folder
                # instead of silently importing zero keyframes
                for alt in ("corrected_images", "images"):
                    p = os.path.join(kf, alt)
                    if os.path.isdir(p):
                        img_dir = p
                        break
                else:
                    raise FileNotFoundError(
                        f"no keyframes images folder under {kf}")
            break
    if cam_dir is None:
        raise FileNotFoundError(f"no keyframes/cameras under {root}")

    itf = mvsio.Interface()
    for ci, cam_path in enumerate(sorted(glob.glob(os.path.join(cam_dir, "*.json")))):
        d = json.load(open(cam_path))
        stem = os.path.splitext(os.path.basename(cam_path))[0]
        img_path = None
        for ext in (".jpg", ".png", ".jpeg"):
            p = os.path.join(img_dir, stem + ext)
            if os.path.exists(p):
                img_path = p
                break
        if img_path is None:
            continue
        K = np.array([[d["fx"], 0, d["cx"]], [0, d["fy"], d["cy"]], [0, 0, 1.0]])
        w, h = int(d["width"]), int(d["height"])
        # camera-to-world rows t_ij; ARKit camera looks down -Z with +Y up:
        # convert to the CV convention (+Z forward, +Y down), as the
        # reference does (InterfacePolycam.cpp:205-215)
        M = np.array([
            [d["t_00"], d["t_01"], d["t_02"], d["t_03"]],
            [d["t_10"], d["t_11"], d["t_12"], d["t_13"]],
            [d["t_20"], d["t_21"], d["t_22"], d["t_23"]],
        ])
        Rc2w = M[:, :3]
        C = M[:, 3]
        flip = np.diag([1.0, -1.0, -1.0])
        R = (Rc2w @ flip).T          # world-to-camera, CV convention
        plat = mvsio.Platform(
            name=stem,
            cameras=[mvsio.CameraRig(name=stem, width=w, height=h, K=K)],
            poses=[mvsio.Pose(R=R, C=C)],
        )
        meta = mvsio.ImageMeta(name=img_path, platform_id=len(itf.platforms),
                               camera_id=0, pose_id=0, id=len(itf.images))
        itf.platforms.append(plat)
        itf.images.append(meta)
    log.info("Polycam import: %d keyframes", len(itf.images))
    return itf
