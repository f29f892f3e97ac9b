"""OpenMVG sfm_data import (apps/InterfaceOpenMVG equivalent).

A copy of ``openmvs_tpu/interfaces/openmvg.py``; a distorted intrinsic's
images are undistorted on import (``interfaces/undistort.py``). Reads OpenMVG's `sfm_data.json` (the
JSON serialization of SfM_Data: views, intrinsics, extrinsics/poses,
structure) or its cereal `sfm_data.bin` into the .mvs Interface — the same
mapping the reference performs by linking openMVG libs
(InterfaceOpenMVG.cpp:39-51,549).  Only pinhole intrinsic families are
supported (undistort first for radial models), matching the reference.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from openmvs_tpu_torch.io import mvs as mvsio
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("openmvg")


def import_openmvg(sfm_data_path: str, images_folder: str = "",
                   undistort_dir: str = "") -> mvsio.Interface:
    if sfm_data_path.endswith(".bin"):
        doc = _load_sfm_data_bin(sfm_data_path)
    else:
        doc = json.load(open(sfm_data_path))
    root = doc.get("root_path", "")
    if images_folder:
        root = images_folder

    # intrinsics: id -> (K, w, h, dist-or-None)
    intr: Dict[int, tuple] = {}
    for it in doc.get("intrinsics", []):
        key = it["key"]
        val = it["value"]
        data = val.get("ptr_wrapper", {}).get("data", {})
        w = data.get("width", 0)
        h = data.get("height", 0)
        f = data.get("focal_length", 0.0)
        pp = data.get("principal_point", [w / 2, h / 2])
        K = np.array([[f, 0, pp[0]], [0, f, pp[1]], [0, 0, 1.0]])
        poly = val.get("polymorphic_name", "pinhole")
        dist = _opencv_dist(poly, data)
        if dist is None and poly not in ("pinhole", "pinhole_intrinsic"):
            log.warning("intrinsic %d is %s; using pinhole part "
                        "(undistort images first)", key, poly)
        intr[key] = (K, w, h, dist)

    # poses: id -> (R, C)
    poses: Dict[int, tuple] = {}
    for it in doc.get("extrinsics", []):
        val = it["value"]
        R = np.array(val["rotation"], np.float64)
        C = np.array(val["center"], np.float64)
        poses[it["key"]] = (R, C)

    itf = mvsio.Interface()
    view_to_img: Dict[int, int] = {}
    intr_platform: Dict[int, int] = {}
    dists: Dict[int, np.ndarray] = {}
    for it in doc.get("views", []):
        data = it["value"]["ptr_wrapper"]["data"]
        view_id = data.get("id_view", it["key"])
        intr_id = data.get("id_intrinsic", -1)
        pose_id = data.get("id_pose", -1)
        if intr_id not in intr or pose_id not in poses:
            continue  # unregistered view
        if intr_id not in intr_platform:
            K, w, h, dist = intr[intr_id]
            plat = mvsio.Platform(
                name=f"intrinsic{intr_id}",
                cameras=[mvsio.CameraRig(name=f"cam{intr_id}", width=w, height=h, K=K)],
            )
            intr_platform[intr_id] = len(itf.platforms)
            if dist is not None:
                dists[len(itf.platforms)] = dist
            itf.platforms.append(plat)
        pid = intr_platform[intr_id]
        plat = itf.platforms[pid]
        R, C = poses[pose_id]
        local_pose = len(plat.poses)
        plat.poses.append(mvsio.Pose(R=R, C=C))
        name = data.get("filename", f"view{view_id}")
        meta = mvsio.ImageMeta(
            name=os.path.join(root, name) if root else name,
            platform_id=pid, camera_id=0, pose_id=local_pose,
            id=len(itf.images),
        )
        view_to_img[view_id] = len(itf.images)
        itf.images.append(meta)

    pts, views_list, colors = [], [], []
    for it in doc.get("structure", []):
        val = it["value"]
        X = val["X"]
        obs = val.get("observations", [])
        vs = sorted({view_to_img[o["key"]] for o in obs if o["key"] in view_to_img})
        if len(vs) < 2:
            continue
        pts.append(X)
        views_list.append(np.asarray(vs, np.uint32))
        colors.append(val.get("rgb", [128, 128, 128]))
    itf.points = np.asarray(pts, np.float32).reshape(-1, 3)
    itf.point_views = views_list
    itf.colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    if dists:
        from openmvs_tpu_torch.interfaces import undistort as und
        base = os.path.dirname(os.path.abspath(sfm_data_path))
        und.undistort_interface_images(
            itf, dists, undistort_dir or os.path.join(base, "undistorted"))
    log.info("OpenMVG import: %d views, %d points", len(itf.images), len(itf.points))
    return itf


class _CerealReader:
    """Minimal cereal PortableBinaryInputArchive decoder (little-endian).

    Wire format (cereal portable_binary.hpp): 1-byte endian flag, then raw
    little-endian scalars; strings/containers are uint64 count + payload;
    polymorphic shared_ptr = uint32 polymorphic_id (0 null, 0x40000000 =
    static type, msb = first sight -> name string follows) + ptr_wrapper
    (uint32 tracking id, msb = data follows).  Field names (NVPs) are not
    serialized in binary archives."""

    MSB = 0x80000000
    MSB2 = 0x40000000

    def __init__(self, path: str):
        self.buf = open(path, "rb").read()
        self.off = 0
        self.polymorphic_names: Dict[int, str] = {}
        if self.u8() != 1:
            raise ValueError("big-endian cereal archives not supported")

    def raw(self, n: int) -> bytes:
        b = self.buf[self.off:self.off + n]
        if len(b) != n:
            raise ValueError("truncated sfm_data.bin")
        self.off += n
        return b

    def u8(self):
        return self.raw(1)[0]

    def u32(self):
        return int.from_bytes(self.raw(4), "little")

    def u64(self):
        return int.from_bytes(self.raw(8), "little")

    def f64(self):
        return float(np.frombuffer(self.raw(8), "<f8")[0])

    def string(self) -> str:
        return self.raw(self.u64()).decode("utf-8", "replace")

    def dvec(self) -> list:
        n = self.u64()
        return list(np.frombuffer(self.raw(8 * n), "<f8"))

    def dmat(self) -> list:
        return [self.dvec() for _ in range(self.u64())]

    def poly_ptr(self):
        """-> (polymorphic_name or "" for static type, has_data) or None."""
        pid = self.u32()
        if pid == 0:
            return None
        if pid & self.MSB2:
            name = ""
        elif pid & self.MSB:
            name = self.string()
            self.polymorphic_names[pid & ~self.MSB] = name
        else:
            name = self.polymorphic_names.get(pid, "")
        tracking = self.u32()
        return name, bool(tracking & self.MSB)


def _load_sfm_data_bin(path: str) -> dict:
    """Decode OpenMVG's cereal-PortableBinary `sfm_data.bin` into the same
    dict shape as `sfm_data.json` (Save_Cereal field order: version,
    root_path, views, intrinsics, extrinsics, structure, control_points —
    openMVG sfm_data_io_cereal.hpp; reference reads it by linking openMVG,
    InterfaceOpenMVG.cpp:39-51)."""
    r = _CerealReader(path)
    doc = {"sfm_data_version": r.string(), "root_path": r.string()}

    views = []
    for _ in range(r.u64()):
        key = r.u32()
        ptr = r.poly_ptr()
        if ptr is None:
            continue
        name, has_data = ptr
        if not has_data:
            continue  # shared view object already read (never happens in practice)
        data = {
            "local_path": r.string(), "filename": r.string(),
            "width": r.u32(), "height": r.u32(),
            "id_view": r.u32(), "id_intrinsic": r.u32(), "id_pose": r.u32(),
        }
        if name == "view_priors":
            # ViewPriors appends pose-center/rotation priors (sfm_view_priors.hpp)
            if r.u8():
                data["center_weight"] = r.dvec()
                data["center"] = r.dvec()
            if r.u8():
                data["rotation_weight"] = r.f64()
                data["rotation"] = r.dmat()
        elif name:
            raise ValueError(f"unsupported view type {name!r} in {path}")
        views.append({"key": key, "value": {"ptr_wrapper": {"data": data}}})
    doc["views"] = views

    intrinsics = []
    for _ in range(r.u64()):
        key = r.u32()
        ptr = r.poly_ptr()
        if ptr is None:
            continue
        name, has_data = ptr
        if not has_data:
            continue
        data = {"width": r.u32(), "height": r.u32()}
        if "spherical" not in name:
            data["focal_length"] = r.f64()
            data["principal_point"] = r.dvec()
        if name in ("pinhole_radial_k1", "pinhole_radial_k3", "pinhole_brown_t2"):
            data["disto_" + name.rsplit("_", 1)[1]] = r.dvec()
        elif name == "fisheye":
            data["fisheye"] = r.dvec()
        elif name not in ("", "pinhole", "pinhole_intrinsic", "spherical"):
            raise ValueError(f"unsupported intrinsic type {name!r} in {path}")
        intrinsics.append({"key": key,
                           "value": {"polymorphic_name": name or "pinhole",
                                     "ptr_wrapper": {"data": data}}})
    doc["intrinsics"] = intrinsics

    extrinsics = []
    for _ in range(r.u64()):
        key = r.u32()
        extrinsics.append({"key": key, "value": {"rotation": r.dmat(),
                                                 "center": r.dvec()}})
    doc["extrinsics"] = extrinsics

    def landmarks():
        out = []
        for _ in range(r.u64()):
            key = r.u32()
            X = r.dvec()
            obs = []
            for _ in range(r.u64()):
                okey = r.u32()
                id_feat = r.u32()
                x = r.dvec()
                obs.append({"key": okey, "value": {"id_feat": id_feat, "x": x}})
            out.append({"key": key, "value": {"X": X, "observations": obs}})
        return out

    doc["structure"] = landmarks()
    if r.off < len(r.buf):
        doc["control_points"] = landmarks()
    return doc


def _opencv_dist(poly: str, data: dict):
    """Map an OpenMVG intrinsic's distortion to OpenCV (k1,k2,p1,p2,k3).

    pinhole_radial_k1 -> disto_k1 [k1]; _k3 -> disto_k3 [k1,k2,k3];
    pinhole_brown_t2 -> disto_t2 [k1,k2,k3,t1,t2] (t = tangential p);
    fisheye models are NOT the Brown model and stay unsupported."""
    if "fisheye" in poly:
        return None
    d = data.get("disto_k1") or data.get("disto_k3") or data.get("disto_t2")
    if d is None:
        dd = data.get("distortion", {})
        if isinstance(dd, dict):
            d = (dd.get("ptr_wrapper", {}) or {}).get("data", dd)
            if isinstance(d, dict):
                d = d.get("disto_k1") or d.get("disto_k3") or d.get("disto_t2")
    if d is None:
        return None
    d = list(np.asarray(d, np.float64).ravel())
    if len(d) == 1:                      # k1
        return np.array([d[0], 0, 0, 0, 0])
    if len(d) == 3:                      # k1 k2 k3
        return np.array([d[0], d[1], 0, 0, d[2]])
    if len(d) == 5:                      # k1 k2 k3 t1 t2
        # openMVG brown_t2 distoFunction: t_x = t2*(r^2+2x^2) + 2*t1*x*y,
        # t_y = t1*(r^2+2y^2) + 2*t2*x*y — so t1 is OpenCV's p1 and t2 is
        # p2 (cv layout k1 k2 p1 p2 k3)
        return np.array([d[0], d[1], d[3], d[4], d[2]])
    return None
