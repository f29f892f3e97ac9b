"""PNG encoder and decoder with ``zlib`` and ``struct`` alone.

Stands in for PIL, which the JAX package's OBJ codec uses for its atlas
pages (``openmvs_tpu/io/obj.py``): the port imports torch, numpy and scipy
only. ``write`` stores 8-bit gray, RGB or RGBA, each row with the Up
filter. ``read`` decodes 8-bit gray, gray+alpha, RGB and RGBA, not
interlaced, with all five row filters (PNG spec, section 9); anything else
raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (gray, RGB, gray+alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write(path: str, img: np.ndarray) -> None:
    """Save an (h, w) gray, (h, w, 3) RGB or (h, w, 4) RGBA uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"png.write: uint8 pixels expected, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    ctype = {1: 0, 3: 2, 4: 6}.get(img.shape[2] if img.ndim == 3 else 0)
    if ctype is None:
        raise ValueError(f"png.write: (h, w), (h, w, 3) or (h, w, 4) expected, got {img.shape}")
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    up = np.empty((h, 1 + w * c), np.uint8)
    up[:, 0] = 2                                     # the Up filter
    up[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=up[1:, 1:])  # wraps modulo 256
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(up.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read(path: str) -> np.ndarray:
    """Decode a PNG to uint8 (h, w) for gray, else (h, w, channels)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: bit depth {depth}, color type {ctype}, interlace "
                         f"{interlace}: only 8-bit gray, gray+alpha, RGB and RGBA "
                         "without interlacing are read")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {w}x{h}x{c}")
    raw = raw.reshape(h, 1 + w * c)
    img = _unfilter(raw[:, 0], raw[:, 1:].reshape(h, w, c))
    return img[..., 0] if c == 1 else img


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
