"""Image resampling, filters and the working-resolution policy (host side,
numpy and scipy).

Counterpart of ``openmvs_tpu/io/images.py:97-117`` without OpenCV:
``resize_area`` reproduces ``cv2.resize(..., interpolation=cv2.INTER_AREA)``
for downscaling (the reference's area filter), an exact block mean for
integer factors and fractional area weights otherwise. ``box_blur`` and
``gaussian_blur`` stand for ``cv2.blur`` and ``cv2.GaussianBlur`` on
float32 images (texturing's seam leveling and sharpening), with OpenCV's
default border (BORDER_REFLECT_101, scipy's ``mirror``).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) area weights of one axis, as OpenCV's
    computeResizeAreaTab builds them (fractions under 1e-3 are dropped)."""
    scale = ssize / dsize
    wts = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1 = math.ceil(fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            wts[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            wts[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            wts[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return wts


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Downscale with area filtering (cv::INTER_AREA semantics).

    Works on (h, w) and (h, w, c) arrays; integer inputs are rounded and
    saturated like OpenCV's, float inputs keep their dtype."""
    h, w = img.shape[:2]
    if (w, h) == (width, height):
        return img.copy()
    if width > w or height > h:
        raise ValueError("resize_area only downscales")
    if img.dtype == np.float32 and (w, h) == (2 * width, 2 * height):
        # OpenCV's fast path for an exact halving of float data sums each
        # 2x2 block as (row 0 pair + row 1 pair), then scales by 1/4
        return (((img[0::2, 0::2] + img[0::2, 1::2])
                 + (img[1::2, 0::2] + img[1::2, 1::2])) * np.float32(0.25))
    wy = _area_weights(h, height)
    wx = _area_weights(w, width)
    a = img.astype(np.float64)
    out = np.einsum("yh,hw...->yw...", wy, a)
    out = np.einsum("xw,yw...->yx...", wx, out)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out.astype(img.dtype)


def compute_max_resolution(width: int, height: int, level: int, min_res: int, max_res: int) -> int:
    """Pick the working resolution for the larger image dimension.

    Mirrors Image::RecomputeMaxResolution: scale down `level` times, but never
    below min_res (if the image is at least that large) nor above max_res.
    """
    size = max(width, height)
    scaled = size >> level
    if scaled < min_res:
        scaled = min(size, min_res)
    if max_res > 0 and scaled > max_res:
        scaled = max_res
    return scaled


def box_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """Normalized ``ksize`` x ``ksize`` box filter of a float32 (h, w) or
    (h, w, c) image, channels apart (``cv2.blur(img, (ksize, ksize))``;
    both sum in float64)."""
    size = (ksize, ksize) + (1,) * (img.ndim - 2)
    return ndimage.uniform_filter(img, size=size, mode="mirror")


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """(ksize,) float64 Gaussian taps as ``cv2.getGaussianKernel`` builds
    them: exp(-x^2 / (2 sigma^2)) summed in order, then scaled by the
    reciprocal of the sum."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    t = np.exp((-0.5 / (sigma * sigma)) * x * x)
    total = 0.0
    for v in t.tolist():
        total += v
    return t * (1.0 / total)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur of a float32 (h, w) or (h, w, c) image over
    its two image axes (``cv2.GaussianBlur(img, (0, 0), sigma)``): OpenCV's
    kernel size for float images, round(8 sigma + 1) made odd, and its taps
    in float32, rows then columns."""
    ksize = int(np.floor(sigma * 8 + 1 + 0.5)) | 1
    k = gaussian_kernel(ksize, sigma).astype(np.float32)
    out = ndimage.correlate1d(img, k, axis=0, mode="mirror")
    return ndimage.correlate1d(out, k, axis=1, mode="mirror")
