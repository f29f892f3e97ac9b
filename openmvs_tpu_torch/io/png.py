"""PNG encoder and decoder with ``zlib`` and ``struct`` alone.

Stands in for PIL and OpenCV, which the JAX package uses for its atlas
pages (``openmvs_tpu/io/obj.py``) and its images (``cv2.imread``,
``openmvs_tpu/io/images.py``): the port imports torch, numpy and scipy
only. ``write`` stores 8- or 16-bit gray, RGB or RGBA, each row with the
Up filter. ``read`` decodes every PNG that ``cv2.imread(path,
cv2.IMREAD_COLOR)`` reads, as it reads it: bit depths 1, 2, 4, 8 and 16
(16-bit samples keep their high byte, gray below 8 bits is scaled to
0-255), colour types 0, 2, 3 (palette; ``tRNS`` ignored), 4 and 6, with or
without Adam7 interlacing, all five row filters (PNG spec, sections 7-9).
``read_unchanged`` keeps what ``cv2.IMREAD_UNCHANGED`` keeps: 16-bit
samples, alpha, and the ``tRNS`` transparency of palette and RGB images.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """The PNG file of an (h, w) gray, (h, w, 3) RGB or (h, w, 4) RGBA
    uint8 or uint16 image (16-bit samples stored big-endian)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"png.write: uint8 or uint16 pixels expected, got {img.dtype}")
    depth = 8 * img.dtype.itemsize
    if img.ndim == 2:
        img = img[..., None]
    ctype = {1: 0, 3: 2, 4: 6}.get(img.shape[2] if img.ndim == 3 else 0)
    if ctype is None:
        raise ValueError(f"png.write: (h, w), (h, w, 3) or (h, w, 4) expected, got {img.shape}")
    h, w, c = img.shape
    rows = img.astype(">u2").view(np.uint8) if depth == 16 else img
    rows = rows.reshape(h, -1)
    up = np.empty((h, 1 + rows.shape[1]), np.uint8)
    up[:, 0] = 2                                     # the Up filter
    up[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=up[1:, 1:])  # wraps modulo 256
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(up.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> None:
    """Save an (h, w) gray, (h, w, 3) RGB or (h, w, 4) RGBA uint8 or uint16
    image."""
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)


# color type -> channels (gray, RGB, palette index, gray+alpha, RGBA)
_CHANNELS_IN = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _decode(path: str):
    """(samples (h, w, c), color type, bit depth, palette or None, tRNS
    bytes or None): uint16 samples at depth 16, else uint8 samples as stored
    (palette indices, gray below 8 bits unscaled)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos + 8 <= len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = data
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or interlace > 1:
        raise ValueError(f"{path}: bit depth {depth}, color type {ctype}, interlace "
                         f"{interlace} is not a valid PNG")
    if ctype == 3 and plte is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    c = _CHANNELS_IN[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        nrow = (pw * c * depth + 7) // 8
        part = raw[pos:pos + ph * (1 + nrow)]
        pos += ph * (1 + nrow)
        if part.size != ph * (1 + nrow):
            raise ValueError(f"{path}: {raw.size} bytes of image data for "
                             f"{w}x{h}, {c} channels of {depth} bits")
        part = part.reshape(ph, 1 + nrow)
        bpp = max(1, c * depth // 8)
        rows = _unfilter(part[:, 0], part[:, 1:].reshape(ph, nrow // bpp, bpp))
        samples[y0::dy, x0::dx] = _samples(rows.reshape(ph, nrow), pw, c, depth)
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte[:256]
        plte = pal
    return samples, ctype, depth, plte, trns


def _to8(samples: np.ndarray, ctype: int, depth: int) -> np.ndarray:
    """8-bit samples as cv2 makes them: the high byte of 16-bit ones, gray
    below 8 bits scaled to 0-255."""
    if depth == 16:
        return (samples >> 8).astype(np.uint8)
    if ctype == 0 and depth < 8:
        return samples * np.uint8(255 // (2 ** depth - 1))
    return samples


def read(path: str) -> np.ndarray:
    """Decode a PNG to uint8 (h, w) for gray, (h, w, 2) gray+alpha, (h, w,
    3) RGB (palette images too) or (h, w, 4) RGBA."""
    samples, ctype, depth, plte, _ = _decode(path)
    if ctype == 3:
        return plte[samples[..., 0]]
    samples = _to8(samples, ctype, depth)
    return samples[..., 0] if samples.shape[2] == 1 else samples


def read_unchanged(path: str) -> np.ndarray:
    """Decode a PNG as ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` does, in
    RGB order (the caller swaps to OpenCV's BGR): gray (h, w) (a ``tRNS``
    ignored), gray+alpha as (h, w, 4) with the gray repeated, RGB (h, w, 3),
    RGBA (h, w, 4); a palette or RGB image with ``tRNS`` gains its alpha
    channel (palette entries past the table and colours other than the
    transparent one opaque). 16-bit samples stay uint16, gray below 8 bits
    is scaled to 0-255."""
    samples, ctype, depth, plte, trns = _decode(path)
    if ctype == 3:
        rgb = plte[samples[..., 0]]
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:min(len(trns), 256)] = np.frombuffer(trns[:256], np.uint8)
        return np.concatenate([rgb, alpha[samples[..., :1]]], axis=2)
    if depth < 8:
        samples = _to8(samples, ctype, depth)
    if ctype == 0:
        return samples[..., 0]
    if ctype == 4:
        return np.concatenate([np.repeat(samples[..., :1], 3, axis=2), samples[..., 1:]], 2)
    if ctype == 2 and trns is not None and len(trns) >= 6:
        key = np.frombuffer(trns[:6], ">u2").astype(samples.dtype)
        top = np.iinfo(samples.dtype).max
        alpha = np.where((samples == key).all(axis=2), 0, top).astype(samples.dtype)
        return np.concatenate([samples, alpha[..., None]], axis=2)
    return samples


# libpng's rgb_to_gray weights as OpenCV sets them (0.299, 0.587 -> 15-bit
# fixed point, truncated)
_GRAY_WEIGHTS = (9797, 19234, 3737)


def read_gray(path: str) -> np.ndarray:
    """Decode a PNG to (h, w) uint8 as ``cv2.imread(path,
    cv2.IMREAD_GRAYSCALE)`` does: gray as stored (alpha dropped), colour
    through libpng's (9797 R + 19234 G + 3737 B) >> 15, which rounds
    (+ 2^14) only for 16-bit samples, then keeps their high byte."""
    samples, ctype, depth, plte, _ = _decode(path)
    if ctype in (0, 4):
        return np.ascontiguousarray(_to8(samples, ctype, depth)[..., 0])
    rgb = (plte[samples[..., 0]] if ctype == 3 else samples[..., :3]).astype(np.int64)
    r, g, b = _GRAY_WEIGHTS
    mix = rgb[..., 0] * r + rgb[..., 1] * g + rgb[..., 2] * b
    if depth == 16:
        return (((mix + 16384) >> 15) >> 8).astype(np.uint8)
    return (mix >> 15).astype(np.uint8)


def _samples(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """(h, w, c) samples of unfiltered rows of packed bytes: 16-bit ones
    big-endian as uint16, those below 8 bits unpacked most significant
    first, unscaled."""
    h = len(rows)
    if depth == 8:
        return rows[:, :w * c].reshape(h, w, c)
    if depth == 16:
        pairs = rows[:, :2 * w * c].reshape(h, w, c, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    per = 8 // depth
    shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8(2 ** depth - 1)
    return vals.reshape(h, -1)[:, :w * c].reshape(h, w, c)


def _unfilter(filters: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Reconstruct (h, w, c) bytes from each row's filter type and its
    filtered bytes; the predictors read the pixel to the left (a), above
    (b) and above-left (c), zero outside the image."""
    if filters.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(filters.max())} is not 0-4")
    h, w, c = data.shape
    if not np.isin(filters, (3, 4)).any():
        # None, Sub and Up only: whole rows at a time
        out = np.empty_like(data)
        prev = np.zeros((w, c), np.uint8)
        for r in range(h):
            row = data[r]
            if filters[r] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif filters[r] == 2:
                row = row + prev
            out[r] = prev = row
        return out
    # Average and Paeth read the left pixel of the same row: sweep the
    # anti-diagonals r + x, whose pixels depend only on earlier ones
    rec = np.zeros((h + 1, w + 1, c), np.int16)      # a zero row and column in front
    d16 = data.astype(np.int16)
    f16 = filters.astype(np.int16)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a, b, cc = rec[r + 1, x], rec[r, x + 1], rec[r, x]
        f = f16[r][:, None]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, x + 1] = (d16[r, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(h, w, 3) RGB of a decoded image, as PIL's ``convert("RGB")``: gray
    repeated, alpha dropped."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
