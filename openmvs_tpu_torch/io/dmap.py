"""Reader/writer for per-view ``.dmap`` raw depth-data files.

Bit-compatible with the reference's HeaderDepthDataRaw ("DR" magic,
content-type flags, image/depth sizes, depth range, image path, view IDs,
K/R/C doubles; libs/MVS/Interface.h:773-792, writer DepthMap.cpp:1874-2040)
and cross-checked against scripts/python/MvsUtils.py:9-70.

content_type bits: 1=depth, 2=normal, 4=confidence, 8=views.
Maps are row-major float32 at depth resolution; views map is 4x uint8.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

MAGIC = b"DR"

HAS_DEPTH = 1
HAS_NORMAL = 2
HAS_CONF = 4
HAS_VIEWS = 8


@dataclass
class DepthData:
    depth: np.ndarray                     # (h, w) float32; 0 = invalid
    image_width: int
    image_height: int
    depth_min: float
    depth_max: float
    file_name: str                        # source image path
    view_ids: np.ndarray                  # (k,) uint32; [0] = reference view
    K: np.ndarray                         # (3,3) float64 at depth resolution
    R: np.ndarray                         # (3,3) float64
    C: np.ndarray                         # (3,)  float64
    normal: Optional[np.ndarray] = None   # (h, w, 3) float32, camera space
    conf: Optional[np.ndarray] = None     # (h, w) float32
    views: Optional[np.ndarray] = None    # (h, w, 4) uint8

    @property
    def width(self) -> int:
        return self.depth.shape[1]

    @property
    def height(self) -> int:
        return self.depth.shape[0]


def save(dd: DepthData, path: str):
    content = HAS_DEPTH
    if dd.normal is not None:
        content |= HAS_NORMAL
    if dd.conf is not None:
        content |= HAS_CONF
    if dd.views is not None:
        content |= HAS_VIEWS
    h, w = dd.depth.shape
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<BB", content, 0))
        f.write(struct.pack("<II", dd.image_width, dd.image_height))
        f.write(struct.pack("<II", w, h))
        f.write(struct.pack("<ff", float(dd.depth_min), float(dd.depth_max)))
        name = dd.file_name.encode("utf-8")
        f.write(struct.pack("<H", len(name)))
        f.write(name)
        view_ids = np.asarray(dd.view_ids, np.uint32)
        f.write(struct.pack("<I", len(view_ids)))
        f.write(view_ids.tobytes())
        f.write(np.ascontiguousarray(dd.K, np.float64).tobytes())
        f.write(np.ascontiguousarray(dd.R, np.float64).tobytes())
        f.write(np.ascontiguousarray(dd.C, np.float64).tobytes())
        f.write(np.ascontiguousarray(dd.depth, np.float32).tobytes())
        if dd.normal is not None:
            f.write(np.ascontiguousarray(dd.normal, np.float32).tobytes())
        if dd.conf is not None:
            f.write(np.ascontiguousarray(dd.conf, np.float32).tobytes())
        if dd.views is not None:
            f.write(np.ascontiguousarray(dd.views, np.uint8).tobytes())


def load(path: str) -> DepthData:
    with open(path, "rb") as f:
        if f.read(2) != MAGIC:
            raise ValueError(f"{path}: not a DR depth-data file")
        content, _ = struct.unpack("<BB", f.read(2))
        if not content & HAS_DEPTH:
            raise ValueError(f"{path}: no depth map stored")
        iw, ih = struct.unpack("<II", f.read(8))
        w, h = struct.unpack("<II", f.read(8))
        dmin, dmax = struct.unpack("<ff", f.read(8))
        (name_len,) = struct.unpack("<H", f.read(2))
        name = f.read(name_len).decode("utf-8", "replace")
        (n_views,) = struct.unpack("<I", f.read(4))
        view_ids = np.frombuffer(f.read(4 * n_views), np.uint32).copy()
        K = np.frombuffer(f.read(72), np.float64).reshape(3, 3).copy()
        R = np.frombuffer(f.read(72), np.float64).reshape(3, 3).copy()
        C = np.frombuffer(f.read(24), np.float64).copy()
        n = w * h
        depth = np.frombuffer(f.read(4 * n), np.float32).reshape(h, w).copy()
        normal = conf = views = None
        if content & HAS_NORMAL:
            normal = np.frombuffer(f.read(12 * n), np.float32).reshape(h, w, 3).copy()
        if content & HAS_CONF:
            conf = np.frombuffer(f.read(4 * n), np.float32).reshape(h, w).copy()
        if content & HAS_VIEWS:
            views = np.frombuffer(f.read(4 * n), np.uint8).reshape(h, w, 4).copy()
    return DepthData(
        depth=depth, image_width=iw, image_height=ih, depth_min=dmin, depth_max=dmax,
        file_name=name, view_ids=view_ids, K=K, R=R, C=C,
        normal=normal, conf=conf, views=views,
    )
