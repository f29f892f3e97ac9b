"""Image resampling, filters and the working-resolution policy (host side,
numpy and scipy).

Counterpart of ``openmvs_tpu/io/images.py:97-117`` without OpenCV:
``resize_area`` reproduces ``cv2.resize(..., interpolation=cv2.INTER_AREA)``
for downscaling (the reference's area filter), an exact block mean for
integer factors and fractional area weights otherwise. ``box_blur`` and
``gaussian_blur`` stand for ``cv2.blur`` and ``cv2.GaussianBlur`` on
float32 images (texturing's seam leveling and sharpening), with OpenCV's
default border (BORDER_REFLECT_101, scipy's ``mirror``).
``warp_perspective`` stands for ``cv2.warpPerspective`` on a float32 gray
image (SGM's pair rectification). ``save_pfm`` and ``load_pfm`` are copies
of ``openmvs_tpu/io/images.py:121-141``.
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


def save_pfm(path: str, data: np.ndarray) -> None:
    """Write a single-channel PFM (little-endian, bottom-up row order as the
    PFM spec mandates; the reference's DepthMap::Save uses the same format)."""
    data = np.asarray(data, np.float32)
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.flipud(data).tobytes())


def load_pfm(path: str) -> np.ndarray:
    """Read a single-channel PFM written by save_pfm (or any scanline PFM)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"Pf":
            raise ValueError("not a single-channel PFM")
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(w * h * 4),
                             "<f4" if scale < 0 else ">f4").reshape(h, w)
    return np.flipud(data).copy()


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


def _invert3(M: np.ndarray) -> list:
    """The inverse of a 3x3 matrix as OpenCV's ``invert`` forms it for 3x3
    (the adjugate times the reciprocal of the determinant, in float64),
    row-major."""
    S = [[float(v) for v in row] for row in np.asarray(M, np.float64)]
    d = (S[0][0] * (S[1][1] * S[2][2] - S[1][2] * S[2][1])
         - S[0][1] * (S[1][0] * S[2][2] - S[1][2] * S[2][0])
         + S[0][2] * (S[1][0] * S[2][1] - S[1][1] * S[2][0]))
    if d == 0.0:
        return [0.0] * 9
    d = 1.0 / d
    return [(S[1][1] * S[2][2] - S[1][2] * S[2][1]) * d,
            (S[0][2] * S[2][1] - S[0][1] * S[2][2]) * d,
            (S[0][1] * S[1][2] - S[0][2] * S[1][1]) * d,
            (S[1][2] * S[2][0] - S[1][0] * S[2][2]) * d,
            (S[0][0] * S[2][2] - S[0][2] * S[2][0]) * d,
            (S[0][2] * S[1][0] - S[0][0] * S[1][2]) * d,
            (S[1][0] * S[2][1] - S[1][1] * S[2][0]) * d,
            (S[0][1] * S[2][0] - S[0][0] * S[2][1]) * d,
            (S[0][0] * S[1][1] - S[0][1] * S[1][0]) * d]


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def warp_perspective(img: np.ndarray, M: np.ndarray, width: int, height: int
                     ) -> np.ndarray:
    """``cv2.warpPerspective(img, M, (width, height))`` of a float32 (h, w)
    image with the default flags: bilinear samples, BORDER_CONSTANT 0.

    OpenCV 5's x86 warp kernel, rebuilt: ``M`` (source to destination) is
    inverted in float64 and rounded to float32; destination pixel (x, y)
    samples the source at (X / w, Y / w), each of X, Y and w the float32
    form x c0 + y c1 + c2 of its row of the inverse. The vector loop (16
    pixels a step) computes it as fma(x, c0, y c1 + c2), the scalar tail
    (the last W mod 16 pixels of a row) as fma(x, c0, y c1) + c2. The
    sample is two horizontal lerps and a vertical one, v0 + a (v1 - v0) as
    fused multiply-adds, at the coordinate's unquantised fraction; source
    pixels outside the image read 0. (OpenCV 4.10 and older quantised the
    fraction to 1/32.)"""
    img = np.asarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError("warp_perspective takes a 2-D float32 image")
    h, w = img.shape
    m = np.asarray(_invert3(M), np.float64).astype(np.float32)
    xs = np.arange(width, dtype=np.float32)[None, :]
    ys = np.arange(height, dtype=np.float32)[:, None]

    tail = xs >= width - width % 16

    def coord(c0, c1, c2):
        return np.where(tail, _fma32(xs, c0, ys * c1) + c2, _fma32(xs, c0, ys * c1 + c2))

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        wz = coord(m[6], m[7], m[8])
        sx = coord(m[0], m[1], m[2]) / wz
        sy = coord(m[3], m[4], m[5]) / wz
    out = np.zeros((height, width), np.float32)
    if h == 0 or w == 0:
        return out
    ok = (np.isfinite(sx) & np.isfinite(sy) & (np.abs(sx) < 2 ** 30)
          & (np.abs(sy) < 2 ** 30))
    sx, sy = np.where(ok, sx, -4.0), np.where(ok, sy, -4.0)
    x0f, y0f = np.floor(sx), np.floor(sy)
    a, b = sx - x0f, sy - y0f
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)

    def pix(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return np.where(inside, img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)],
                        np.float32(0))

    p00, p01 = pix(y0, x0), pix(y0, x0 + 1)
    p10, p11 = pix(y0 + 1, x0), pix(y0 + 1, x0 + 1)
    v0 = _fma32(a, p01 - p00, p00)
    v1 = _fma32(a, p11 - p10, p10)
    return _fma32(b, v1 - v0, v0)
