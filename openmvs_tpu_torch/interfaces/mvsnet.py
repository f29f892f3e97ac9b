"""MVSNet folder-layout import (apps/InterfaceMVSNet equivalent,
InterfaceMVSNet.cpp:51-53,239-241).

Layout:
  <root>/cams/00000000_cam.txt   extrinsic (4x4 world-to-cam) + intrinsic 3x3
                                 + "depth_min interval (depth_num depth_max)"
  <root>/images/00000000.jpg
  <root>/pair.txt                per-view scored neighbor lists

A copy of ``openmvs_tpu/interfaces/mvsnet.py``; image sizes come from the
file headers (``io/images.image_size``) where the JAX package opens the
images with PIL.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from openmvs_tpu_torch.io import mvs as mvsio
from openmvs_tpu_torch.io.images import image_size
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("mvsnet")


def _parse_cam(path: str):
    # Strict numeric regex: real *_cam.txt files contain literal header lines
    # ("extrinsic"/"intrinsic", InterfaceMVSNet.cpp:277-294) whose letters must
    # not be picked up as numbers (the lone 'e' of "extrinsic" is not a float).
    txt = open(path).read()
    num_re = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"
    nums = [float(x) for x in re.findall(num_re, txt)]
    E = np.array(nums[:16]).reshape(4, 4)        # world-to-camera
    K = np.array(nums[16:25]).reshape(3, 3)
    rest = nums[25:]
    d_min = rest[0] if rest else 0.0
    d_max = rest[3] if len(rest) >= 4 else (rest[0] + rest[1] * 192 if len(rest) >= 2 else 0.0)
    return E, K, d_min, d_max


def import_mvsnet(root: str) -> mvsio.Interface:
    cam_files = sorted(glob.glob(os.path.join(root, "cams", "*_cam.txt")))
    if not cam_files:
        raise FileNotFoundError(f"no cams/*_cam.txt under {root}")
    img_dir = os.path.join(root, "images")
    itf = mvsio.Interface()
    # original cam index -> compacted image index: pair.txt refers to the
    # ORIGINAL ordering, which diverges whenever a cam has no image
    orig_to_new = {}
    for i, cf in enumerate(cam_files):
        E, K, d_min, d_max = _parse_cam(cf)
        R = E[:3, :3]
        t = E[:3, 3]
        C = -R.T @ t
        stem = os.path.basename(cf).replace("_cam.txt", "")
        img_path = None
        for ext in (".jpg", ".png", ".jpeg", ".JPG"):
            p = os.path.join(img_dir, stem + ext)
            if os.path.exists(p):
                img_path = p
                break
        if img_path is None:
            log.warning("no image for %s", stem)
            continue
        w, h = image_size(img_path)
        rig = mvsio.CameraRig(name=stem, width=w, height=h, K=K)
        plat = mvsio.Platform(name=stem, cameras=[rig], poses=[mvsio.Pose(R=R, C=C)])
        meta = mvsio.ImageMeta(
            name=img_path, platform_id=len(itf.platforms), camera_id=0, pose_id=0,
            id=len(itf.images), min_depth=d_min, max_depth=d_max,
        )
        orig_to_new[i] = len(itf.images)
        itf.platforms.append(plat)
        itf.images.append(meta)

    # pair.txt -> view scores
    pair_path = os.path.join(root, "pair.txt")
    if os.path.exists(pair_path):
        lines = [l.strip() for l in open(pair_path) if l.strip()]
        n = int(lines[0])
        for k in range(n):
            ref = int(lines[1 + 2 * k])
            toks = lines[2 + 2 * k].split()
            cnt = int(toks[0])
            if ref in orig_to_new:
                vs = []
                for j in range(cnt):
                    vid = int(toks[1 + 2 * j])
                    if vid not in orig_to_new:
                        continue        # neighbor cam had no image
                    score = float(toks[2 + 2 * j])
                    vs.append(mvsio.ViewScore(id=orig_to_new[vid], score=score))
                itf.images[orig_to_new[ref]].view_scores = vs
    log.info("MVSNet import: %d views", len(itf.images))
    return itf
