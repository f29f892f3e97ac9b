"""Image decoding and the image loader of the port (``io/images.py``,
``io/png.py``, ``SceneImage.load``) against OpenCV and the JAX package.

- ``to_gray`` equals ``cv2.cvtColor(RGB2GRAY) / 255`` bit for bit over all
  2^24 colours.
- ``load_color`` equals ``cv2.imread(IMREAD_COLOR)`` + BGR2RGB for PNGs of
  bit depths 1-16, colour types 0/2/3/4/6, every row filter and Adam7, and
  for JPEGs at quality 75 and 95, 4:4:4 and 4:2:0, at odd sizes: all
  pixels equal. ``load_gray_u8`` equals ``cv2.imread(IMREAD_GRAYSCALE)``.
- ``resize_area`` of uint8 images and ``resize_nearest`` equal
  ``cv2.resize`` (INTER_AREA, INTER_NEAREST).
- SCI files cross between the packages.
- ``SceneImage.load(max_dim)`` gives the JAX package's colour, gray, mask,
  scale and camera, also for a file whose size differs from the metadata.
- Reading a PNG imports no PIL.
"""

import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("jax")
Image = pytest.importorskip("PIL.Image")

from openmvs_tpu.geometry.camera import Camera as JaxCamera  # noqa: E402
from openmvs_tpu.io import images as jimio  # noqa: E402
from openmvs_tpu.io import mvs as jmvs  # noqa: E402
from openmvs_tpu.scene import SceneImage as JaxSceneImage  # noqa: E402
from openmvs_tpu_torch.geometry.camera import Camera  # noqa: E402
from openmvs_tpu_torch.io import images as imio  # noqa: E402
from openmvs_tpu_torch.io import png  # noqa: E402
from openmvs_tpu_torch.io.mvs import ImageMeta  # noqa: E402
from openmvs_tpu_torch.scene import SceneImage  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def test_to_gray_equals_cv2_for_every_colour():
    c = np.arange(2 ** 24, dtype=np.uint32)
    rgb = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY).astype(np.float32) / 255.0
    got = imio.to_gray(rgb)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(got, jimio.to_gray(rgb))


# ---------------------------------------------------------------- PNG files

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack(samples, depth):
    """(h, w, c) samples -> (h, row bytes) as the PNG stores them."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.reshape(h, w * c).astype(np.uint8)
    per = 8 // depth
    flat = samples.reshape(h, w * c).astype(np.uint8)
    n = (w * c + per - 1) // per
    pad = np.zeros((h, n * per), np.uint8)
    pad[:, :w * c] = flat
    shifts = 8 - depth * (1 + np.arange(per))
    return (pad.reshape(h, n, per) << shifts).sum(-1).astype(np.uint8)


def _filter(rows, bpp, kinds):
    """Filter each row with kinds[r % len(kinds)] (PNG spec, section 9)."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for r, x in enumerate(rows.astype(np.int32)):
        k = kinds[r % len(kinds)]
        a = np.r_[np.zeros(bpp, np.int32), x[:-bpp]]
        c = np.r_[np.zeros(bpp, np.int32), prev[:-bpp]]
        if k == 0:
            f = x
        elif k == 1:
            f = x - a
        elif k == 2:
            f = x - prev
        elif k == 3:
            f = x - (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            f = x - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(np.r_[k, f & 255].astype(np.uint8))
        prev = x
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


def _png_bytes(samples, depth, ctype, palette=None, trns=None, interlace=False,
               kinds=(0, 1, 2, 3, 4)):
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    data = [_filter(_pack(samples[y0::dy, x0::dx], depth), bpp, kinds)
            for x0, y0, dx, dy in passes
            if samples[y0::dy, x0::dx].size]

    def chunk(kind, d):
        return struct.pack(">I", len(d)) + kind + d + struct.pack(
            ">I", zlib.crc32(kind + d) & 0xFFFFFFFF)

    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                     0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(np.concatenate(data).tobytes())) + chunk(
        b"IEND", b"")


_PNG_CASES = [(ctype, depth) for ctype, depths in
              {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
               6: (8, 16)}.items() for depth in depths]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", _PNG_CASES)
def test_png_decodes_as_cv2(tmp_path, ctype, depth, interlace):
    r = np.random.default_rng(ctype * 100 + depth)
    h, w = 19, 23
    c = _CH[ctype]
    top = 2 ** depth
    palette = trns = None
    if ctype == 3:
        n = min(top, 200)
        samples = r.integers(0, n, (h, w, 1))
        palette = r.integers(0, 256, (n, 3))
        trns = bytes(r.integers(0, 256, min(n, 7)).astype(np.uint8))
    else:
        samples = r.integers(0, top, (h, w, c))
    blob = _png_bytes(samples, depth, ctype, palette, trns, interlace)
    path = tmp_path / "x.png"
    path.write_bytes(blob)
    want = _cv2_rgb(path)
    assert np.array_equal(imio.load_color(str(path)), want)
    assert np.array_equal(imio.load_gray_u8(str(path)),
                          cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    assert imio.image_size(str(path)) == (w, h)


@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 9, 3), (9, 1, 4), (5, 6, 1), (8, 8, 2)])
def test_png_adam7_small_and_empty_passes(tmp_path, shape):
    """Images smaller than an Adam7 block leave passes empty."""
    r = np.random.default_rng(sum(shape))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[shape[2]]
    samples = r.integers(0, 256, shape)
    (tmp_path / "s.png").write_bytes(_png_bytes(samples, 8, ctype, interlace=True))
    assert np.array_equal(imio.load_color(str(tmp_path / "s.png")),
                          _cv2_rgb(tmp_path / "s.png"))


# ---------------------------------------------------------------- JPEG files

@pytest.mark.parametrize("size", [(480, 640), (481, 643), (37, 29)])
@pytest.mark.parametrize("quality,subsampling", [(75, 0), (75, 2), (95, 0), (95, 2)])
def test_jpeg_decodes_as_cv2(tmp_path, size, quality, subsampling):
    from scipy.ndimage import gaussian_filter

    r = np.random.default_rng(size[1] + quality + subsampling)
    rgb = gaussian_filter(r.integers(0, 256, size + (3,)).astype(np.uint8), (1, 1, 0))
    path = str(tmp_path / "x.jpg")
    Image.fromarray(rgb).save(path, quality=quality, subsampling=subsampling)
    got = imio.load_color(path)
    want = _cv2_rgb(path)
    assert got.shape == want.shape and np.array_equal(got, want), (
        f"{(got != want).mean():.2%} of samples differ, max "
        f"{np.abs(got.astype(int) - want).max()}")
    assert np.array_equal(imio.load_gray_u8(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    assert imio.image_size(path) == (size[1], size[0])


def test_write_image_and_missing_files(tmp_path):
    r = np.random.default_rng(3)
    rgb = r.integers(0, 256, (21, 34, 3)).astype(np.uint8)
    for ext in (".png", ".bmp", ".tif", ".sci"):
        imio.write_image(str(tmp_path / f"a{ext}"), rgb)
        assert np.array_equal(imio.load_color(str(tmp_path / f"a{ext}")), rgb), ext
    gray = rgb[..., 0]
    imio.write_image(str(tmp_path / "g.png"), gray)
    assert np.array_equal(cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_UNCHANGED), gray)
    # JPEG at OpenCV's default quality (95): cv2.imwrite's file decodes alike
    smooth = np.repeat(np.linspace(0, 255, 34).astype(np.uint8)[None, :, None], 21, 0)
    smooth = np.repeat(smooth, 3, 2)
    imio.write_image(str(tmp_path / "a.jpg"), smooth)
    cv2.imwrite(str(tmp_path / "c.jpg"), smooth)
    assert np.abs(_cv2_rgb(tmp_path / "a.jpg").astype(int)
                  - _cv2_rgb(tmp_path / "c.jpg")).max() <= 2
    with pytest.raises(FileNotFoundError):
        imio.load_color(str(tmp_path / "missing.jpg"))
    with pytest.raises(ValueError, match="8-bit"):
        imio.write_image(str(tmp_path / "f.png"), rgb.astype(np.float32))


def test_sci_both_ways(tmp_path):
    rgb = np.random.default_rng(4).integers(0, 256, (13, 17, 3)).astype(np.uint8)
    imio.save_sci(str(tmp_path / "p.sci"), rgb)
    jimio.save_sci(str(tmp_path / "j.sci"), rgb)
    assert (tmp_path / "p.sci").read_bytes() == (tmp_path / "j.sci").read_bytes()
    assert np.array_equal(jimio.load_sci(str(tmp_path / "p.sci")), rgb)
    assert np.array_equal(imio.load_color(str(tmp_path / "j.sci")), rgb)
    assert imio.image_size(str(tmp_path / "j.sci")) == (17, 13)
    # the other pixel formats the JAX codec reads
    for fmt, stride in ((2, 1), (5, 4), (7, 3), (9, 4)):
        raw = np.random.default_rng(fmt).integers(0, 256, (5, 6, stride)).astype(np.uint8)
        blob = (0x01494353).to_bytes(4, "little") + (6).to_bytes(2, "little") + (5).to_bytes(
            2, "little") + bytes([fmt, 1, 0, 0]) + raw.tobytes()
        (tmp_path / "f.sci").write_bytes(blob)
        assert np.array_equal(imio.load_sci(str(tmp_path / "f.sci")),
                              jimio.load_sci(str(tmp_path / "f.sci")))


# ---------------------------------------------------------------- resampling

@pytest.mark.parametrize("src,dst", [((960, 1280), (480, 640)), ((481, 643), (320, 428)),
                                     ((90, 120), (30, 40)), ((97, 131), (48, 65)),
                                     ((64, 48), (63, 47)), ((13, 7), (5, 3))])
@pytest.mark.parametrize("channels", [None, 3])
def test_uint8_resize_equals_cv2(src, dst, channels):
    r = np.random.default_rng(src[0] + dst[1])
    img = r.integers(0, 256, src if channels is None else src + (channels,)).astype(np.uint8)
    size = (dst[1], dst[0])
    assert np.array_equal(imio.resize_area(img, *size),
                          cv2.resize(img, size, interpolation=cv2.INTER_AREA))
    assert np.array_equal(imio.resize_nearest(img, *size),
                          cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))
    up = (src[1] * 2 + 1, src[0] + 3)
    assert np.array_equal(imio.resize_nearest(img, *up),
                          cv2.resize(img, up, interpolation=cv2.INTER_NEAREST))


# ---------------------------------------------------------------- SceneImage.load

def _images(tmp_path, file_wh, meta_wh, mask):
    r = np.random.default_rng(file_wh[0])
    from scipy.ndimage import gaussian_filter

    rgb = gaussian_filter(r.integers(0, 256, (file_wh[1], file_wh[0], 3)).astype(np.uint8),
                          (1.5, 1.5, 0))
    path = str(tmp_path / "im.jpg")
    Image.fromarray(rgb).save(path, quality=90)
    mask_name = ""
    if mask:
        mask_name = "im_mask.png"
        m = r.integers(0, 3, (file_wh[1] // 2 + 1, file_wh[0] // 2 + 3)).astype(np.uint8) * 100
        cv2.imwrite(str(tmp_path / mask_name), m)
    K = np.array([[0.9 * meta_wh[0], 0, meta_wh[0] / 2 - 0.5],
                  [0, 0.9 * meta_wh[0], meta_wh[1] / 2 - 0.5], [0, 0, 1.0]])
    R, C = np.eye(3), np.array([0.1, -0.2, 0.3])
    port = SceneImage(meta=ImageMeta(name=path, mask_name=mask_name, id=0),
                      camera=Camera(K, R, C), width=meta_wh[0], height=meta_wh[1], path=path)
    jax = JaxSceneImage(meta=jmvs.ImageMeta(name=path, mask_name=mask_name, id=0),
                        camera=JaxCamera(K, R, C), width=meta_wh[0], height=meta_wh[1],
                        path=path)
    return port, jax


@pytest.mark.parametrize("file_wh,meta_wh,max_dim,mask", [
    ((640, 480), (640, 480), 320, True),      # an exact halving
    ((643, 481), (643, 481), 500, False),     # a fractional area resize
    ((640, 480), (1280, 960), None, True),    # the file is smaller than its metadata
    ((320, 240), (640, 480), 200, False),
])
def test_scene_image_load_equals_jax(tmp_path, file_wh, meta_wh, max_dim, mask):
    port, jax = _images(tmp_path, file_wh, meta_wh, mask)
    port.load(max_dim)
    jax.load(max_dim)
    assert np.array_equal(port.color, jax.color)
    assert port.gray.dtype == np.float32 and np.array_equal(port.gray, jax.gray)
    assert port.scale == jax.scale and (port.width, port.height) == (jax.width, jax.height)
    assert np.array_equal(port.camera.K, jax.camera.K)
    assert np.array_equal(port.working_camera().K, jax.working_camera().K)
    if mask:
        assert port.mask.shape == port.gray.shape and np.array_equal(port.mask, jax.mask)
    else:
        assert port.mask is None and jax.mask is None
    port.release()
    assert port.color is None and port.gray is None and port.mask is None


def test_reading_png_imports_no_pil(tmp_path):
    png.write(str(tmp_path / "a.png"), np.zeros((4, 5, 3), np.uint8))
    code = (
        "import sys\n"
        "from openmvs_tpu_torch.io import images\n"
        f"images.load_color({str(tmp_path / 'a.png')!r})\n"
        f"images.load_gray_u8({str(tmp_path / 'a.png')!r})\n"
        f"images.image_size({str(tmp_path / 'a.png')!r})\n"
        "assert not [k for k in sys.modules if k == 'PIL' or k.startswith('PIL.')]\n"
        f"images.load_color({str(tmp_path / 'b.jpg')!r})\n"
        "assert 'PIL' in sys.modules\n")
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(tmp_path / "b.jpg")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
