"""Agisoft Metashape / BlocksExchange XML import (apps/InterfaceMetashape
equivalent, InterfaceMetashape.cpp:83,228).

Supports the Metashape `doc.xml`/`cameras.xml` layout: <sensor> intrinsics
(fx/fy/cx/cy or f + principal point, resolution) and <camera> 4x4
camera-to-world transforms, plus the chunk-level component transform
(rotation/translation/scale).

A copy of ``openmvs_tpu/interfaces/metashape.py``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np

from openmvs_tpu_torch.io import mvs as mvsio
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("metashape")


def _parse_sensor(s) -> tuple:
    res = s.find("resolution")
    w = int(res.get("width")) if res is not None else 0
    h = int(res.get("height")) if res is not None else 0
    calib = None
    for c in s.findall("calibration"):
        if c.get("class", "adjusted") in ("adjusted", "initial"):
            calib = c
            if c.get("class", "adjusted") == "adjusted":
                break
    if calib is None:
        return None
    def val(tag, default=None):
        el = calib.find(tag)
        return float(el.text) if el is not None else default
    cres = calib.find("resolution")
    if cres is not None:
        w = int(cres.get("width"))
        h = int(cres.get("height"))
    f = val("f")
    fx = val("fx", f)
    fy = val("fy", f)
    cx = val("cx", 0.0)
    cy = val("cy", 0.0)
    # Metashape cx/cy are offsets from the image center
    K = np.array([[fx, 0, w / 2 + cx], [0, fy, h / 2 + cy], [0, 0, 1.0]])
    # OpenCV order (k1, k2, p1, p2, k3)
    dist = np.array([val("k1", 0.0), val("k2", 0.0),
                     val("p1", 0.0), val("p2", 0.0), val("k3", 0.0)])
    return K, w, h, dist


def import_metashape(xml_path: str, images_folder: str = "",
                     undistort_dir: str = "") -> mvsio.Interface:
    """Import a Metashape `cameras.xml`/`doc.xml` or a ContextCapture
    BlocksExchange XML.  Distorted sensors are undistorted on import
    (reference undistorts via pltDistCoeffs, InterfaceMetashape.cpp:757)."""
    tree = ET.parse(xml_path)
    root = tree.getroot()
    if root.tag == "BlocksExchange":
        return _import_blocks_exchange(root, xml_path, images_folder,
                                       undistort_dir)
    found = root.find(".//chunk")
    chunk = found if found is not None else root

    # component/chunk transform (applied to camera poses)
    Tr = np.eye(4)
    tr = chunk.find(".//transform")
    if tr is not None and tr.find("rotation") is not None:
        R = np.array([float(x) for x in tr.find("rotation").text.split()]).reshape(3, 3)
        t = np.array([float(x) for x in tr.find("translation").text.split()]) \
            if tr.find("translation") is not None else np.zeros(3)
        s = float(tr.find("scale").text) if tr.find("scale") is not None else 1.0
        Tr[:3, :3] = s * R
        Tr[:3, 3] = t

    sensors: Dict[str, tuple] = {}
    for s in chunk.findall(".//sensor"):
        parsed = _parse_sensor(s)
        if parsed is not None:
            sensors[s.get("id")] = parsed

    itf = mvsio.Interface()
    sensor_platform: Dict[str, int] = {}
    dists: Dict[int, np.ndarray] = {}
    for cam in chunk.findall(".//camera"):
        sid = cam.get("sensor_id")
        te = cam.find("transform")
        if sid not in sensors or te is None or cam.get("enabled", "true") in ("false", "0"):
            continue
        M = np.array([float(x) for x in te.text.split()]).reshape(4, 4)
        M = Tr @ M                      # to world
        Rc2w = M[:3, :3]
        sc = np.cbrt(max(np.linalg.det(Rc2w), 1e-30))
        Rc2w = Rc2w / sc
        C = M[:3, 3]
        R = Rc2w.T                      # world-to-camera
        if sid not in sensor_platform:
            K, w, h, dist = sensors[sid]
            sensor_platform[sid] = len(itf.platforms)
            dists[len(itf.platforms)] = dist
            itf.platforms.append(mvsio.Platform(
                name=f"sensor{sid}",
                cameras=[mvsio.CameraRig(name=f"sensor{sid}", width=w, height=h, K=K)],
            ))
        pid = sensor_platform[sid]
        plat = itf.platforms[pid]
        pose_id = len(plat.poses)
        plat.poses.append(mvsio.Pose(R=R, C=C))
        label = cam.get("label") or f"camera{cam.get('id')}"
        name = label if os.path.splitext(label)[1] else label + ".jpg"
        # anchor relative names: images_folder if given, else beside the
        # XML (a bare label would resolve against the process cwd)
        folder = images_folder or os.path.dirname(os.path.abspath(xml_path))
        meta = mvsio.ImageMeta(
            name=name if os.path.isabs(name) else os.path.join(folder, name),
            platform_id=pid, camera_id=0, pose_id=pose_id, id=len(itf.images),
        )
        itf.images.append(meta)
    if any(np.any(np.abs(d) > 1e-12) for d in dists.values()):
        from openmvs_tpu_torch.interfaces import undistort as und
        base = os.path.dirname(os.path.abspath(xml_path))
        und.undistort_interface_images(
            itf, dists, undistort_dir or os.path.join(base, "undistorted"))
    log.info("Metashape import: %d cameras, %d sensors", len(itf.images), len(sensors))
    return itf


def _import_blocks_exchange(root, xml_path: str, images_folder: str,
                            undistort_dir: str) -> mvsio.Interface:
    """ContextCapture BlocksExchange XML (InterfaceMetashape.cpp:452-612):
    Block/Photogroups/Photogroup -> one platform each (K from
    FocalLengthPixels or FocalLength*scale/SensorSize, PrincipalPoint,
    AspectRatio, Skew, Distortion), Photo -> pose (Rotation M_ij row-major,
    Center), plus TiePoints -> sparse cloud with Measurement visibility."""
    block = root.find("Block")
    if block is None:
        raise ValueError("BlocksExchange XML without <Block>")
    photogroups = block.find("Photogroups")
    if photogroups is None:
        raise ValueError("BlocksExchange XML without <Photogroups>")

    def ftext(el, tag, default=None):
        c = el.find(tag)
        return float(c.text) if c is not None and c.text else default

    itf = mvsio.Interface()
    dists: Dict[int, np.ndarray] = {}
    image_by_id: Dict[int, int] = {}
    base = os.path.dirname(os.path.abspath(xml_path))
    for pg in photogroups:
        cmt = pg.find("CameraModelType")
        if cmt is not None and cmt.text and cmt.text.strip() != "Perspective":
            log.warning("photogroup %s: unsupported camera model %s",
                        pg.findtext("Name", "?"), cmt.text)
            continue
        dims = pg.find("ImageDimensions")
        if dims is None:
            continue
        w = int(ftext(dims, "Width", 0))
        h = int(ftext(dims, "Height", 0))
        f_px = ftext(pg, "FocalLengthPixels")
        if f_px is None:
            f_mm = ftext(pg, "FocalLength")
            sensor = ftext(pg, "SensorSize")
            if f_mm is None or not sensor:
                continue
            f_px = f_mm * max(w, h) / sensor
        pp = pg.find("PrincipalPoint")
        cx = ftext(pp, "x", w * 0.5) if pp is not None else w * 0.5
        cy = ftext(pp, "y", h * 0.5) if pp is not None else h * 0.5
        fy = f_px * (ftext(pg, "AspectRatio", 1.0) or 1.0)
        skew = ftext(pg, "Skew", 0.0) or 0.0
        K = np.array([[f_px, skew, cx], [0, fy, cy], [0, 0, 1.0]])
        d = pg.find("Distortion")
        if d is not None:
            # reference swaps P1/P2 into OpenCV's (p1, p2) slots
            # (InterfaceMetashape.cpp:518-521: dc.p2=P1, dc.p1=P2)
            dist = np.array([ftext(d, "K1", 0.0) or 0.0, ftext(d, "K2", 0.0) or 0.0,
                             ftext(d, "P2", 0.0) or 0.0, ftext(d, "P1", 0.0) or 0.0,
                             ftext(d, "K3", 0.0) or 0.0])
        else:
            dist = np.zeros(5)
        pid = len(itf.platforms)
        dists[pid] = dist
        plat = mvsio.Platform(
            name=pg.findtext("Name", f"photogroup{pid}"),
            cameras=[mvsio.CameraRig(name=f"pg{pid}", width=w, height=h, K=K)])
        itf.platforms.append(plat)
        for photo in pg.findall("Photo"):
            img_id = int(ftext(photo, "Id", len(itf.images)))
            name = photo.findtext("ImagePath", f"photo{img_id}")
            if images_folder:
                name = os.path.join(images_folder, os.path.basename(name))
            elif not os.path.isabs(name):
                name = os.path.join(base, name)
            pose_el = photo.find("Pose")
            if pose_el is None:
                continue
            rot = pose_el.find("Rotation")
            cen = pose_el.find("Center")
            if rot is None or cen is None:
                continue
            R = np.array([[ftext(rot, f"M_{i}{j}", 0.0) for j in range(3)]
                          for i in range(3)])
            C = np.array([ftext(cen, "x", 0.0), ftext(cen, "y", 0.0),
                          ftext(cen, "z", 0.0)])
            pose_id = len(plat.poses)
            plat.poses.append(mvsio.Pose(R=R, C=C))
            image_by_id[img_id] = len(itf.images)
            itf.images.append(mvsio.ImageMeta(
                name=name, platform_id=pid, camera_id=0, pose_id=pose_id,
                id=len(itf.images)))

    if len(itf.images) < 2:
        raise ValueError("BlocksExchange XML yielded <2 posed images")

    # georeferenced blocks: recenter poses at the camera centroid
    # (InterfaceMetashape.cpp:582-593)
    srs = block.find("SRSId")
    local = srs is None
    if not local:
        el = root.find("SpatialReferenceSystems")
        if el is not None:
            el = el.find("SRS")
            nm = el.findtext("Name", "") if el is not None else ""
            local = nm.startswith("Local Coordinates")
    center = np.zeros(3)
    if not local:
        centers = []
        for plat in itf.platforms:
            centers += [p.C for p in plat.poses]
        center = np.mean(np.asarray(centers, np.float64), axis=0)
        for plat in itf.platforms:
            for p in plat.poses:
                p.C = np.asarray(p.C, np.float64) - center

    tp = block.find("TiePoints")
    if tp is not None:
        pts, views_list, colors = [], [], []
        for t in tp:
            pos = t.find("Position")
            if pos is None:
                continue
            X = np.array([ftext(pos, "x", 0.0), ftext(pos, "y", 0.0),
                          ftext(pos, "z", 0.0)]) - center
            col = t.find("Color")
            if col is not None:
                rgb = np.clip([(ftext(col, c, 0.5) or 0.0) * 255
                               for c in ("Red", "Green", "Blue")], 0, 255)
            else:
                rgb = [128, 128, 128]
            vs = sorted({image_by_id[int(ftext(m, "PhotoId", -1))]
                         for m in t.findall("Measurement")
                         if int(ftext(m, "PhotoId", -1)) in image_by_id})
            if len(vs) < 2:
                continue
            pts.append(X)
            colors.append(rgb)
            views_list.append(np.asarray(vs, np.uint32))
        if pts:
            itf.points = np.asarray(pts, np.float32).reshape(-1, 3)
            itf.colors = np.asarray(colors, np.uint8).reshape(-1, 3)
            itf.point_views = views_list

    if any(np.any(np.abs(d) > 1e-12) for d in dists.values()):
        from openmvs_tpu_torch.interfaces import undistort as und
        und.undistort_interface_images(
            itf, dists, undistort_dir or os.path.join(base, "undistorted"))
    log.info("BlocksExchange import: %d photos, %d photogroups, %d tie points",
             len(itf.images), len(itf.platforms), len(itf.points))
    return itf
