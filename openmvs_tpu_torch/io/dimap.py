"""SGM disparity-map (.dimap) codec.

Bit-compatible with the reference's ExportDisparityDataRaw /
ImportDisparityDataRaw (libs/MVS/SemiGlobalMatcher.cpp:2094-2160): raw
little-endian stream of image size (2x int32), rectification homography H
(9 doubles, row-major), re-projection matrix Q (16 doubles), subpixel steps
(int16), disparity-map resolution (2x int32), int16 disparities scaled by
subpixel steps, and an optional uint16 accumulated-cost map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class DisparityData:
    disparity: np.ndarray                 # (h, w) float32, true disparities
    image_width: int
    image_height: int
    H: np.ndarray = field(default_factory=lambda: np.eye(3))   # rectification
    Q: np.ndarray = field(default_factory=lambda: np.eye(4))   # reprojection
    subpixel_steps: int = 4
    cost: Optional[np.ndarray] = None     # (h, w) uint16 accumulated cost


def save(dd: DisparityData, path: str):
    h, w = dd.disparity.shape
    with open(path, "wb") as f:
        np.array([dd.image_width, dd.image_height], "<i4").tofile(f)
        np.asarray(dd.H, "<f8").reshape(9).tofile(f)
        np.asarray(dd.Q, "<f8").reshape(16).tofile(f)
        np.array([dd.subpixel_steps], "<i2").tofile(f)
        np.array([w, h], "<i4").tofile(f)
        # invalid (NaN) disparities persist as NO_DISP = int16 max
        # (SemiGlobalMatcher.h:68, DECLARE_NO_INDEX = numeric_limits::max)
        # so the cache round-trips them; a plain cast of NaN is undefined
        q = np.round(dd.disparity * dd.subpixel_steps)
        bad = ~np.isfinite(q)
        q = np.clip(np.where(bad, 0, q), -32768, 32766)
        np.where(bad, 32767, q).astype("<i2").tofile(f)
        if dd.cost is not None:
            np.asarray(dd.cost, "<u2").tofile(f)


def load(path: str) -> DisparityData:
    with open(path, "rb") as f:
        iw, ih = np.fromfile(f, "<i4", 2)
        H = np.fromfile(f, "<f8", 9).reshape(3, 3)
        Q = np.fromfile(f, "<f8", 16).reshape(4, 4)
        steps = int(np.fromfile(f, "<i2", 1)[0])
        w, h = np.fromfile(f, "<i4", 2)
        disp = np.fromfile(f, "<i2", int(w) * int(h)).reshape(h, w)
        rest = np.fromfile(f, "<u2")
        cost = rest[: h * w].reshape(h, w) if rest.size >= h * w else None
    d = disp.astype(np.float32) / max(steps, 1)
    d[disp == 32767] = np.nan  # NO_DISP marker (SemiGlobalMatcher.h:68)
    return DisparityData(
        disparity=d,
        image_width=int(iw), image_height=int(ih),
        H=H, Q=Q, subpixel_steps=steps, cost=cost,
    )
