"""Image undistortion on SfM import.

A copy of ``openmvs_tpu/interfaces/undistort.py`` with OpenCV's
``cv2.undistort`` rebuilt in numpy, bit for bit, and its ``imread``/
``imwrite`` replaced by ``io/images``. The reference undistorts images
before densification (VisualSFM path: `MVS::UndistortImage`,
apps/InterfaceVisualSFM/InterfaceVisualSFM.cpp:245, 457; COLMAP path
expects `colmap image_undistorter` output). Importers call
`undistort_interface_images` so radially-distorted real-world models
reconstruct correctly instead of importing wrong geometry with a warning.
The images are host data, as in the JAX package, so the remap is numpy.

Supported models (coefficients in OpenCV's (k1, k2, p1, p2, k3) order):
  - COLMAP SIMPLE_RADIAL / RADIAL / OPENCV / FULL_OPENCV
  - VisualSFM NVM single-coefficient radial (x_d = x_u (1 + k1 r_u^2) in
    f-normalized coords — DistortPointR1, InterfaceVisualSFM.cpp:200-243 —
    which is exactly OpenCV's k1-only model)
  - Bundler (k1, k2)

``cv2.undistort(img, K, dist)`` is OpenCV's ``initUndistortRectifyMap``
with a CV_16SC2 map, then ``remap`` with INTER_LINEAR and BORDER_CONSTANT
0, in stripes of max(1, 4096 // width) rows whose new camera matrix is K
with its cy moved up by the stripe's first row. ``init_undistort_map``
builds that map: each source coordinate snapped to a 1/32-pixel grid (the
integer pixel and a 10-bit fraction index). ``remap_linear`` samples it:
uint8 in 15-bit fixed point, (sum w_i p_i + 2^14) >> 15 with the integer
weights (32 - fx)(32 - fy) 32 ...; uint16 and float32 with float32 weights
summed left to right, uint16 rounded half to even; taps outside the image
read 0.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from openmvs_tpu_torch.io import images as imio
from openmvs_tpu_torch.io import mvs as mvsio
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("undistort")

# OpenCV's remap tables: 5 fraction bits per axis, 15-bit fixed-point weights
_INTER_BITS = 5
_INTER_TAB = 1 << _INTER_BITS


def colmap_dist_coeffs(model: str, params) -> Optional[np.ndarray]:
    """OpenCV distortion vector for a COLMAP camera model (None = pinhole)."""
    p = np.asarray(params, np.float64)
    if model in ("PINHOLE", "SIMPLE_PINHOLE"):
        return None
    if model == "SIMPLE_RADIAL":          # f cx cy k
        return np.array([p[3], 0, 0, 0, 0])
    if model == "RADIAL":                 # f cx cy k1 k2
        return np.array([p[3], p[4], 0, 0, 0])
    if model == "OPENCV":                 # fx fy cx cy k1 k2 p1 p2
        return np.array([p[4], p[5], p[6], p[7], 0])
    if model == "FULL_OPENCV":            # fx fy cx cy k1 k2 p1 p2 k3 ...
        return np.array([p[4], p[5], p[6], p[7], p[8]])
    log.warning("unsupported camera model %s: importing without undistortion", model)
    return None


_SPLIT = 134217729.0  # 2^27 + 1, Dekker's splitter for float64


def _fma64(a, b, c) -> np.ndarray:
    """Correctly rounded float64 a * b + c (OpenCV's vector code uses fused
    multiply-adds): the exact product and sum as pairs of doubles, their
    low parts added with rounding to odd, then one rounding to nearest
    (Boldo and Melquiond's emulation)."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float64) for v in (a, b, c)))
    p = a * b
    ah = a * _SPLIT
    ah = ah - (ah - a)
    bh = b * _SPLIT
    bh = bh - (bh - b)
    al, bl = a - ah, b - bh
    pl = ((ah * bh - p) + ah * bl + al * bh) + al * bl

    def two_sum(x, y):
        t = x + y
        yy = t - x
        return t, (x - (t - yy)) + (y - yy)

    uh, ul = two_sum(c, p)
    t, te = two_sum(ul, pl)
    odd = (te != 0) & ((t.view(np.int64) & 1) == 0) & np.isfinite(t)
    t = np.where(odd, np.nextafter(t, np.where(te > 0, np.inf, -np.inf)), t)
    return uh + t


# OpenCV's map loop evaluates 8 columns at a time (two float64 vectors of
# AVX2), the leftover width % 8 columns one by one
_MAP_BLOCK = 8


def init_undistort_map(K: np.ndarray, dist: np.ndarray, width: int, height: int,
                       stripe: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``cv2.initUndistortRectifyMap(K, dist, None, K', (width, height),
    cv2.CV_16SC2)`` -> (map1 (h, w, 2) int16 source pixel, map2 (h, w)
    uint16 fraction index (v & 31) * 32 + (u & 31)).

    With ``stripe`` > 0 the map is ``cv2.undistort``'s: rows in stripes of
    ``stripe``, each computed with K' = K whose cy is moved up by the
    stripe's first row (row i of the stripe starting at y0 is image row y0
    + i); else K' = K. Per pixel, in float64, as OpenCV's vector loop
    rounds it (a tie of 32u at .5 exposes every rounding): with ir =
    inv(K'), the row's y = fma(i, ir4, ir5); x starts at ir2 and steps by
    8 ir0 a block of 8 columns, x = start + k ir0 in the block, and by ir0
    a column past the last block; r2 = x^2 + y^2, kr = 1 + ((k3 r2 + k2)
    r2 + k1) r2, u = fma(fx, x kr + p1 2xy + p2 (r2 + 2x^2), cx) and v
    likewise (ir is OpenCV's 3x3 inverse, the adjugate times the
    reciprocal of the determinant, ``io/images._invert3``); 32u and 32v
    rounded half to even to int32 (cvRound gives
    INT_MIN outside that range), map1 = (iu >> 5, iv >> 5) saturated to
    int16 in the blocks (``v_pack``) and wrapped to int16 in the scalar
    tail's last width % 8 columns (a cast to short)."""
    K = np.asarray(K, np.float64)
    d = np.zeros(5)
    coef = np.asarray(dist, np.float64).reshape(-1)[:5]
    d[:len(coef)] = coef
    k1, k2, p1, p2, k3 = (float(v) for v in d)
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    step = min(max(1, stripe), height) if stripe > 0 else max(height, 1)
    rows = np.arange(height)
    first = rows // step * step
    ir = np.empty((height, 9))
    for y0 in np.unique(first):
        Ar = K.copy()
        if stripe > 0:
            Ar[1, 2] = v0 - y0
        ir[first == y0] = imio._invert3(Ar)
    i = (rows - first).astype(np.float64)[:, None]
    ir = ir[:, :, None]
    nb = width // _MAP_BLOCK
    nfull = nb * _MAP_BLOCK
    cols = np.arange(width)
    block, k = cols // _MAP_BLOCK, (cols % _MAP_BLOCK).astype(np.float64)

    def walk(i_coef, start, inc):
        """A coordinate along each row: the row's start, then blocks."""
        s0 = _fma64(i, i_coef, start)
        steps = np.concatenate([s0, np.broadcast_to(_MAP_BLOCK * inc, (height, nb))], 1)
        starts = np.add.accumulate(steps, axis=1)            # each block's start
        out = starts[:, np.minimum(block, nb)] + inc * k
        if width > nfull:                                    # the scalar tail
            tail = np.concatenate([starts[:, nb:nb + 1],
                                   np.broadcast_to(inc, (height, width - nfull - 1))], 1)
            out[:, nfull:] = np.add.accumulate(tail, axis=1)
        return out

    _x = walk(ir[:, 1], ir[:, 2], ir[:, 0])
    _y = walk(ir[:, 4], ir[:, 5], ir[:, 3])
    _w = walk(ir[:, 7], ir[:, 8], ir[:, 6])
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w = 1.0 / _w
        x = _x * w
        y = _y * w
        x2 = x * x
        y2 = y * y
        r2 = x2 + y2
        _2xy = 2 * x * y
        kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
        u = _fma64(fx, x * kr + p1 * _2xy + p2 * (r2 + 2 * x2), u0)
        v = _fma64(fy, y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy, v0)

        def fixed(c):
            r = np.rint(c * _INTER_TAB)
            ok = np.abs(r) < 2.0 ** 31
            return np.where(ok, r, -2.0 ** 31).astype(np.int64)

        iu, iv = fixed(u), fixed(v)
    m = np.stack([iu >> _INTER_BITS, iv >> _INTER_BITS], -1)
    map1 = np.clip(m, -32768, 32767).astype(np.int16)    # the blocks saturate
    map1[:, nfull:] = m[:, nfull:].astype(np.int16)      # the tail wraps
    map2 = ((iv & (_INTER_TAB - 1)) * _INTER_TAB + (iu & (_INTER_TAB - 1))).astype(np.uint16)
    return map1, map2


def remap_linear(img: np.ndarray, map1: np.ndarray, map2: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map1, map2, cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_CONSTANT)`` with a CV_16SC2 map, for uint8,
    uint16 and float32 images of any channel count; the output has the
    map's size. Taps outside the image read 0 (a pixel with all four
    outside is 0)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16, np.float32):
        raise ValueError(f"remap_linear: uint8, uint16 or float32 expected, got {img.dtype}")
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    sx = map1[..., 0].astype(np.int64)
    sy = map1[..., 1].astype(np.int64)
    fx = (map2 & (_INTER_TAB - 1)).astype(np.int64)
    fy = ((map2 >> _INTER_BITS) & (_INTER_TAB - 1)).astype(np.int64)
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = sy + dy, sx + dx
            inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            v = src[np.clip(yy, 0, max(h - 1, 0)), np.clip(xx, 0, max(w - 1, 0))]
            taps.append(np.where(inside[..., None], v, np.zeros((), src.dtype)))
    if img.dtype == np.uint8:
        # OpenCV's 15-bit weight table is exact for bilinear: (32 - f) and f
        # products times 32 sum to 32768
        wx, wy = (_INTER_TAB - fx, fx), (_INTER_TAB - fy, fy)
        ws = [wy[a] * wx[b] * _INTER_TAB for a in (0, 1) for b in (0, 1)]
        acc = sum(t.astype(np.int64) * wi[..., None] for t, wi in zip(taps, ws))
        out = ((acc + (1 << 14)) >> 15).clip(0, 255).astype(np.uint8)
    else:
        f32 = np.float32
        step = f32(1.0 / _INTER_TAB)
        tx = (f32(1) - fx.astype(f32) * step, fx.astype(f32) * step)
        ty = (f32(1) - fy.astype(f32) * step, fy.astype(f32) * step)
        ws = [ty[a] * tx[b] for a in (0, 1) for b in (0, 1)]
        prods = [t.astype(f32) * wi[..., None] for t, wi in zip(taps, ws)]
        acc = ((prods[0] + prods[1]) + prods[2]) + prods[3]
        if img.dtype == np.uint16:
            out = np.clip(np.rint(acc), 0, 65535).astype(np.uint16)
        else:
            out = acc
    return out.reshape(map1.shape[:2] + img.shape[2:])


def undistort_image(img: np.ndarray, K: np.ndarray,
                    dist: np.ndarray) -> np.ndarray:
    """``cv2.undistort(img, K, dist)``: the same intrinsics out, so the
    undistorted image is the pinhole view of K."""
    h, w = img.shape[:2]
    map1, map2 = init_undistort_map(K, dist, w, h,
                                    stripe=max(1, (1 << 12) // max(w, 1)))
    return remap_linear(img, map1, map2)


def undistort_interface_images(
    itf: mvsio.Interface,
    dists: Dict[int, np.ndarray],     # platform_id -> OpenCV coeffs
    out_dir: str,
) -> int:
    """Undistort every image of a distorted platform and repoint its meta.

    Writes `<out_dir>/<basename>` undistorted copies; returns the number of
    images processed.  K is unchanged (OpenCV undistort maps to the same
    intrinsics)."""
    n = 0
    os.makedirs(out_dir, exist_ok=True)
    used_names: Dict[str, int] = {}
    for meta in itf.images:
        dist = dists.get(meta.platform_id)
        if dist is None or not np.any(np.abs(dist) > 1e-12):
            continue
        src = meta.name
        if not os.path.exists(src):
            log.warning("image %s missing; cannot undistort", src)
            continue
        try:
            img = imio.imread(src)
        except (OSError, ValueError) as e:
            log.warning("failed to read %s: %s", src, e)
            continue
        rig = itf.platforms[meta.platform_id].cameras[meta.camera_id]
        K = np.asarray(rig.K, np.float64)
        if K[0, 0] <= 1.5:  # normalized K (reference convention): scale up
            s = max(rig.width, rig.height)
            K = K * np.array([[s, s, s], [s, s, s], [1, 1, 1]])
        und = undistort_image(img, K, dist)
        # same basename from different subfolders (rig layouts) must not
        # overwrite each other in the flat out_dir; the renamed candidate
        # must ALSO avoid genuine inputs like stem_1.ext
        base = os.path.basename(src)
        stem, ext = os.path.splitext(base)
        k = 0
        cand = base
        while cand in used_names:
            k += 1
            cand = f"{stem}_{k}{ext}"
        used_names[cand] = 1
        dst = os.path.join(out_dir, cand)
        imio.imwrite(dst, und)
        meta.name = dst
        n += 1
    if n:
        log.info("undistorted %d images -> %s", n, out_dir)
    return n
