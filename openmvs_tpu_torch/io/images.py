"""Image decoding, encoding, resampling and filters (host side, numpy and
scipy).

Counterpart of ``openmvs_tpu/io/images.py`` without OpenCV. Reading
follows ``cv2.imread``: ``load_color`` decodes PNG with the port's own
``io/png`` and SCI (the reference's raw format, ``load_sci``/``save_sci``)
here, and every other format (JPEG, TIFF, BMP, TGA, DDS, ...) through PIL,
imported only when such a file is read or written; ``load_gray_u8`` is
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (a mask). ``to_gray`` is
``cv2.cvtColor(RGB2GRAY)`` in OpenCV 5's 15-bit fixed point.
``image_size`` reads a file's width and height from its header.
``write_image`` stands for ``cv2.imwrite`` of 8-bit RGB images. ``imread``
and ``imwrite`` are ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` and
``cv2.imwrite`` in OpenCV's own channel order (BGR, BGRA) and dtypes
(uint8, and uint16 in PNG), which image undistortion reads and writes.

``resize_area`` reproduces ``cv2.resize(..., interpolation=cv2.INTER_AREA)``
for downscaling (the reference's area filter): uint8 images bit for bit
(OpenCV's integer-factor path and its float32 table path), float images
with fractional area weights in float64. ``resize_nearest`` is
``cv2.INTER_NEAREST``. ``box_blur`` and ``gaussian_blur`` stand for
``cv2.blur`` and ``cv2.GaussianBlur`` on float32 images (texturing's seam
leveling and sharpening), with OpenCV's default border (BORDER_REFLECT_101,
scipy's ``mirror``). ``warp_perspective`` stands for
``cv2.warpPerspective`` on a float32 gray image (SGM's pair
rectification). ``save_pfm`` and ``load_pfm`` are copies of
``openmvs_tpu/io/images.py:121-141``.
"""

from __future__ import annotations

import math
import os

import numpy as np
from scipy import ndimage

from openmvs_tpu_torch.io import png


def _pil_image(path: str):
    """PIL.Image, imported here: PIL decodes and encodes every format but
    PNG and SCI. Raises ImportError naming ``path`` where PIL is missing."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading or writing this image format needs PIL "
                          "(the port decodes only PNG and SCI itself)") from e
    return Image


def load_color(path: str) -> np.ndarray:
    """An image file as RGB uint8 (h, w, 3), as ``cv2.imread(path,
    cv2.IMREAD_COLOR)`` + BGR2RGB reads it (gray repeated, alpha dropped,
    16-bit samples reduced to their high byte); SCI through ``load_sci``
    (the JAX package's ``load_color``, openmvs_tpu/io/images.py:18-34)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".sci":
        return load_sci(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cannot read image: {path}")
    if ext == ".png":
        return png.to_rgb(png.read(path))
    Image = _pil_image(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_gray_u8(path: str) -> np.ndarray:
    """A (h, w) uint8 image as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
    reads it (a segmentation mask): a PNG through ``png.read_gray``, a JPEG
    as libjpeg's luma (PIL's ``draft("L")``), other formats through PIL's
    ``convert("L")``."""
    if os.path.splitext(path)[1].lower() == ".png":
        return png.read_gray(path)
    Image = _pil_image(path)
    with Image.open(path) as im:
        if im.format == "JPEG":
            im.draft("L", im.size)
        return np.asarray(im.convert("L"))


def to_gray(img: np.ndarray) -> np.ndarray:
    """RGB uint8 -> float32 gray in [0, 1]: ``cv2.cvtColor(img,
    cv2.COLOR_RGB2GRAY) / 255``, OpenCV 5's fixed point (R 9798 + G 19235 +
    B 3735 + 2^14) >> 15."""
    c = np.asarray(img, np.int32)
    g = (c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735 + 16384) >> 15
    return g.astype(np.uint8).astype(np.float32) / 255.0


def image_size(path: str) -> tuple:
    """(width, height) of an image file from its header, without decoding
    (PNG and SCI read here; other formats through PIL)."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == png.SIGNATURE:
        w, h = np.frombuffer(head[16:24], ">u4")
        return int(w), int(h)
    if int.from_bytes(head[:4], "little") == _SCI_MAGIC:
        return (int.from_bytes(head[4:6], "little"),
                int.from_bytes(head[6:8], "little"))
    Image = _pil_image(path)
    with Image.open(path) as im:
        return im.size


def write_image(path: str, img: np.ndarray) -> None:
    """Save a uint8 (h, w) gray or (h, w, 3) RGB image by extension, as
    ``cv2.imwrite`` would: PNG through ``io/png``, SCI through
    ``save_sci``, other formats through PIL (JPEG at OpenCV's default
    quality, 95)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: 8-bit images expected, got {img.dtype}")
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        png.write(path, img)
        return
    if ext == ".sci":
        save_sci(path, img if img.ndim == 3 else np.repeat(img[..., None], 3, 2))
        return
    Image = _pil_image(path)
    kw = {"quality": 95} if ext in (".jpg", ".jpeg") else {}
    Image.fromarray(img).save(path, **kw)


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: (h, w) for gray, (h, w,
    3) BGR, (h, w, 4) BGRA where the file has alpha (``png.read_unchanged``
    says which PNGs), uint16 samples of a 16-bit PNG kept. JPEG and other
    formats decode through PIL (libjpeg-turbo, as OpenCV's); SCI through
    ``load_sci`` as BGR."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".sci":
        return np.ascontiguousarray(load_sci(path)[..., ::-1])
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cannot read image: {path}")
    if ext == ".png":
        img = png.read_unchanged(path)
    else:
        Image = _pil_image(path)
        with Image.open(path) as im:
            if im.mode in ("L", "I;16", "RGB", "RGBA"):
                img = np.asarray(im)
            elif im.mode == "LA":
                la = np.asarray(im)
                img = np.concatenate([np.repeat(la[..., :1], 3, axis=2), la[..., 1:]], 2)
            elif im.mode == "P" and "transparency" in im.info:
                img = np.asarray(im.convert("RGBA"))
            else:
                img = np.asarray(im.convert("RGB"))
    if img.ndim == 3:
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=2)
    return np.ascontiguousarray(img)


def imwrite(path: str, img: np.ndarray) -> None:
    """``cv2.imwrite(path, img)`` of an (h, w) gray, (h, w, 3) BGR or (h, w,
    4) BGRA image, by extension: PNG through ``io/png`` (uint8 or uint16;
    OpenCV's zlib settings differ, its pixels do not), JPEG through PIL at
    OpenCV's defaults (quality 95, 4:2:0, no alpha; the same bytes as
    OpenCV's libjpeg-turbo), SCI through ``save_sci``, other formats
    through PIL."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ext = os.path.splitext(path)[1].lower()
    if img.ndim == 3:
        keep = 3 if ext in (".jpg", ".jpeg", ".sci") else img.shape[2]
        img = np.concatenate([img[..., 2::-1], img[..., 3:keep]], axis=2)
    if ext == ".png":
        png.write(path, img)
        return
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: only PNG stores {img.dtype} here; 8-bit images "
                         "expected")
    write_image(path, np.ascontiguousarray(img))


# SCI: the reference's internal raw image format (libs/IO/ImageSCI.cpp).
# 12-byte header: u32 magic "SCI"+version(1), u16 width, u16 height,
# u8 PIXELFORMAT, u8 mip levels, 2 reserved; then tightly-packed scanlines
# (level 0 first).  PIXELFORMAT enum values from libs/IO/Image.h:30-52.
_SCI_MAGIC = 0x01494353
_SCI_FORMATS = {  # value -> (bytes/px, converter to RGB)
    1: (1, lambda a: np.repeat(a, 3, axis=-1)),                    # PF_A8
    2: (1, lambda a: np.repeat(a, 3, axis=-1)),                    # PF_GRAY8
    4: (3, lambda a: a),                                           # PF_R8G8B8
    5: (4, lambda a: a[..., :3]),                                  # PF_R8G8B8A8
    6: (4, lambda a: a[..., 1:]),                                  # PF_A8R8G8B8
    7: (3, lambda a: a[..., ::-1]),                                # PF_B8G8R8
    8: (4, lambda a: a[..., 2::-1]),                               # PF_B8G8R8A8
    9: (4, lambda a: a[..., :0:-1]),                               # PF_A8B8G8R8
}


def load_sci(path: str) -> np.ndarray:
    """Read an uncompressed SCI image as RGB uint8 (h, w, 3)."""
    with open(path, "rb") as f:
        hdr = f.read(12)
        if len(hdr) < 12:
            raise ValueError(f"truncated SCI image: {path}")
        magic, w, h, fmt, _levels = (
            int.from_bytes(hdr[0:4], "little"),
            int.from_bytes(hdr[4:6], "little"),
            int.from_bytes(hdr[6:8], "little"),
            hdr[8], hdr[9],
        )
        if magic != _SCI_MAGIC:
            raise ValueError(f"invalid SCI image: {path}")
        if fmt not in _SCI_FORMATS:
            raise ValueError(f"unsupported SCI pixel format {fmt}: {path}")
        stride, conv = _SCI_FORMATS[fmt]
        data = np.frombuffer(f.read(w * h * stride), np.uint8)
        if data.size < w * h * stride:
            raise ValueError(f"truncated SCI image: {path}")
        img = data.reshape(h, w, stride)
    return np.ascontiguousarray(conv(img))


def save_sci(path: str, rgb: np.ndarray) -> None:
    """Write an RGB uint8 image as SCI PF_R8G8B8 (reference-loadable)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(_SCI_MAGIC.to_bytes(4, "little"))
        f.write(int(w).to_bytes(2, "little"))
        f.write(int(h).to_bytes(2, "little"))
        f.write(bytes([4, 1, 0, 0]))  # PF_R8G8B8, 1 level
        f.write(np.ascontiguousarray(rgb[..., :3]).tobytes())


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) area weights of one axis, OpenCV's table as a matrix
    (scale ssize / dsize)."""
    di, si, alpha = _area_table(ssize, dsize, ssize / dsize)
    wts = np.zeros((dsize, ssize), np.float64)
    wts[di, si] = alpha
    return wts


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Downscale with area filtering (cv::INTER_AREA semantics).

    Works on (h, w) and (h, w, c) arrays; uint8 inputs come out as
    OpenCV's, other integer inputs are rounded and saturated, float inputs
    keep their dtype."""
    h, w = img.shape[:2]
    if (w, h) == (width, height):
        return img.copy()
    if width > w or height > h:
        raise ValueError("resize_area only downscales")
    if img.dtype == np.uint8:
        return _resize_area_u8(img, width, height)
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


def _area_table(ssize: int, dsize: int, scale: float):
    """OpenCV's computeResizeAreaTab as three arrays in its order: the
    destination index, the source index and the float32 weight of each
    entry (entries of one destination index are consecutive, their source
    indices distinct; fractions under 1e-3 are dropped)."""
    di, si, alpha = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1 = math.ceil(fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx), si.append(sx1 - 1), alpha.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx), si.append(sx), alpha.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx), si.append(sx2), alpha.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return np.array(di), np.array(si), np.array(alpha, np.float64).astype(np.float32)


def _table_steps(di: np.ndarray):
    """The table's entries grouped by their rank within their destination
    index: OpenCV adds a destination's entries in table order, so step j
    adds every destination's j-th entry at once."""
    first = np.r_[0, np.flatnonzero(np.diff(di)) + 1]
    rank = np.arange(len(di)) - np.repeat(first, np.diff(np.r_[first, len(di)]))
    return [np.flatnonzero(rank == j) for j in range(int(rank.max()) + 1)]


def _resize_area_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(INTER_AREA) of a uint8 image, to the bit. OpenCV takes
    scale = 1 / (dst / src) per axis; where both are integers it sums each
    block in integers and rounds (sum + 2) >> 2 for 2x2 blocks, else
    scales the sum by float32(1 / area) and rounds half to even. Otherwise
    it accumulates in float32 in its table order: each source row along x
    (buf += src * alpha), then the rows into each destination row (sum =
    beta * buf, then sum += beta * buf), rounded half to even."""
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    sx, sy = 1.0 / (width / w), 1.0 / (height / h)
    ix, iy = int(round(sx)), int(round(sy))
    if abs(sx - ix) < np.finfo(float).eps and abs(sy - iy) < np.finfo(float).eps:
        blocks = src.reshape(height, iy, width, ix, -1).astype(np.int64)
        total = blocks.sum(axis=(1, 3))
        if ix == iy == 2 and src.shape[2] in (1, 3, 4):
            out = (total + 2) >> 2
        else:
            out = np.rint(total.astype(np.float32) * np.float32(1.0 / (ix * iy)))
        return np.clip(out, 0, 255).astype(np.uint8).reshape(
            (height, width) + img.shape[2:])
    xdi, xsi, xal = _area_table(w, width, sx)
    ydi, ysi, yal = _area_table(h, height, sy)
    s32 = src.astype(np.float32)
    buf = np.zeros((h, width, src.shape[2]), np.float32)
    for step in _table_steps(xdi):
        buf[:, xdi[step]] += s32[:, xsi[step]] * xal[step][None, :, None]
    out = np.zeros((height, width, src.shape[2]), np.float32)
    for j, step in enumerate(_table_steps(ydi)):
        term = yal[step][:, None, None] * buf[ysi[step]]
        out[ydi[step]] = term if j == 0 else out[ydi[step]] + term
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape(
        (height, width) + img.shape[2:])


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(INTER_NEAREST): destination pixel x reads source
    min(floor(x * (1 / (width / w))), w - 1), and likewise for y."""
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))).astype(np.int64), h - 1)
    return img[ys[:, None], xs[None, :]]


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


def scale_for_max_dim(width: int, height: int, target_max_dim: int) -> float:
    return float(target_max_dim) / float(max(width, height))


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


def warp_inverse(M: np.ndarray) -> np.ndarray:
    """The 9 float32 of ``M``'s inverse (row-major) that ``warp_perspective``
    samples through: ``_invert3`` in float64, rounded to float32."""
    return np.asarray(_invert3(M), np.float64).astype(np.float32)


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
    m = warp_inverse(M)
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
