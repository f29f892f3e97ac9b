"""Image undistortion (``openmvs_tpu_torch/interfaces/undistort.py``) and
the image reads and writes it uses (``io/images.imread``/``imwrite``),
against OpenCV and the JAX package on the CPU.

The port rebuilds ``cv2.undistort`` in numpy: the CV_16SC2 map of
``cv2.initUndistortRectifyMap`` and OpenCV's bilinear remap of it, in
``cv2.undistort``'s row stripes. Both are held bit-equal to OpenCV (and so
to the JAX package's ``undistort_image``, which is ``cv2.undistort``) for
uint8 with 1, 3 and 4 channels, uint16 and float32, for the distortion of
each camera model the importers undistort (COLMAP SIMPLE_RADIAL, RADIAL,
OPENCV and FULL_OPENCV, VisualSFM's NVM k1, Bundler's k1 and k2), on odd
sizes, on an image taller than one of ``cv2.undistort``'s row stripes, and
with coefficients that send taps outside the image. The JPEG encoders of
the two packages (PIL and OpenCV, both libjpeg-turbo at quality 95, 4:2:0)
write the same bytes here, so undistorted JPEG files are held byte-equal.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from openmvs_tpu.interfaces import undistort as jund  # noqa: E402
from openmvs_tpu.io import mvs as jmvs  # noqa: E402
from openmvs_tpu_torch.interfaces import undistort as und  # noqa: E402
from openmvs_tpu_torch.io import images as imio  # noqa: E402
from openmvs_tpu_torch.io import mvs as pmvs  # noqa: E402

torch.set_num_threads(1)

# (name, the model's coefficients as its importer reads them): COLMAP's
# after f (fx fy) cx cy; an NVM radial r becomes k1 = r f^2 and Bundler's
# (k1, k2) are OpenCV's (visualsfm.py)
MODELS = [
    ("SIMPLE_RADIAL", [-0.08]),
    ("RADIAL", [-0.1, 0.03]),
    ("OPENCV", [-0.12, 0.04, 4e-4, -3e-4]),
    ("FULL_OPENCV", [-0.1, 0.03, 0.001, -0.0007, 0.002, 0, 0, 0]),
    ("NVM", [-3e-8]),
    ("BUNDLER", [-0.05, 0.01]),
    ("OUTSIDE", [0.6, 0.5, 0.01, -0.01, 0.3]),
    ("BARREL", [-0.45, 0.1]),
]
# odd sizes, and one taller than a stripe of max(1, 4096 // width) rows
SIZES = [(37, 23), (161, 121), (333, 61)]


def _case(name, params, W, H):
    """(K, OpenCV coefficient vector) of a model's camera at W x H."""
    f = 0.9 * W
    K = np.array([[f, 0, W / 2 + 0.3], [0, 1.05 * f, H / 2 - 0.7], [0, 0, 1.0]])
    cx, cy = K[0, 2], K[1, 2]
    if name == "SIMPLE_RADIAL":
        p = [f, cx, cy] + params
    elif name == "RADIAL":
        p = [f, cx, cy] + params
    elif name in ("OPENCV", "FULL_OPENCV"):
        p = [f, 1.05 * f, cx, cy] + params
    if name in ("SIMPLE_RADIAL", "RADIAL", "OPENCV", "FULL_OPENCV"):
        d = und.colmap_dist_coeffs(name, p)
        assert np.array_equal(d, jund.colmap_dist_coeffs(name, p))
        if name in ("SIMPLE_RADIAL", "RADIAL"):
            K[1, 1] = f
        return K, d
    if name == "NVM":
        return K, np.array([params[0] * f * f, 0, 0, 0, 0])
    return K, np.array((params + [0] * 5)[:5], np.float64)


def _image(dtype, ch, W, H, seed):
    r = np.random.default_rng(seed)
    shape = (H, W) if ch == 1 else (H, W, ch)
    if dtype == np.float32:
        return r.uniform(-10, 300, shape).astype(np.float32)
    return r.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.mark.parametrize("W,H", SIZES)
@pytest.mark.parametrize("name,params", MODELS)
def test_map_equals_opencv(name, params, W, H):
    """init_undistort_map equals cv2.initUndistortRectifyMap(CV_16SC2)."""
    K, d = _case(name, params, W, H)
    m1, m2 = und.init_undistort_map(K, d, W, H)
    c1, c2 = cv2.initUndistortRectifyMap(K, d, None, K, (W, H), cv2.CV_16SC2)
    assert np.array_equal(m1, c1) and np.array_equal(m2, c2)


@pytest.mark.parametrize("dtype,ch", [(np.uint8, 1), (np.uint8, 3), (np.uint8, 4),
                                      (np.uint16, 1), (np.uint16, 3), (np.float32, 1),
                                      (np.float32, 3)])
@pytest.mark.parametrize("name,params", MODELS)
def test_undistort_equals_opencv_and_jax(name, params, dtype, ch):
    """undistort_image equals cv2.undistort (the JAX package's
    undistort_image) bit for bit, on each size."""
    for k, (W, H) in enumerate(SIZES):
        K, d = _case(name, params, W, H)
        img = _image(dtype, ch, W, H, k)
        out = und.undistort_image(img, K, d)
        ref = jund.undistort_image(img, K, d)
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert np.array_equal(out, ref), (W, H, float((out == ref).mean()))
        assert np.array_equal(ref, cv2.undistort(img, K, d))


# round intrinsics and coefficients put many 32u exactly on a .5 tie,
# where every rounding of OpenCV's map arithmetic shows
TIES = [((500.0, 250.0, 150.0), (0.05, 0, 0, 0, 0), (501, 300)),
        ((580.0, 319.0, 241.0), (0.05, 0, 0, 0, 0), (640, 480)),
        ((500.0, 250.0, 150.0), (-0.125, 0.0625, 0, 0, 0), (501, 300)),
        ((512.0, 320.0, 240.0), (-0.25, 0.125, 2 ** -10, -2 ** -9, 2 ** -6), (640, 480))]


@pytest.mark.parametrize("intr,coef,size", TIES)
def test_undistort_ties_equal_opencv(intr, coef, size):
    f, cx, cy = intr
    W, H = size
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    d = np.array(coef, np.float64)
    m1, m2 = und.init_undistort_map(K, d, W, H)
    c1, c2 = cv2.initUndistortRectifyMap(K, d, None, K, (W, H), cv2.CV_16SC2)
    assert np.array_equal(m1, c1) and np.array_equal(m2, c2)
    img = _image(np.uint8, 3, W, H, 5)
    assert np.array_equal(und.undistort_image(img, K, d), cv2.undistort(img, K, d))


def test_outside_coefficients_read_zeros():
    """The strong coefficients send the map outside the image: those
    pixels are 0, as OpenCV's constant border gives."""
    W, H = SIZES[1]
    K, d = _case("OUTSIDE", MODELS[6][1], W, H)
    m1, _ = und.init_undistort_map(K, d, W, H, stripe=4096 // W)
    outside = ((m1[..., 0] < -1) | (m1[..., 0] >= W) | (m1[..., 1] < -1) | (m1[..., 1] >= H))
    assert outside.mean() > 0.2
    out = und.undistort_image(np.full((H, W), 200, np.uint8), K, d)
    assert (out[outside] == 0).all() and (out[~outside] > 0).mean() > 0.9


def _png_cases(tmp_path):
    """PNG files of every colour type and depth cv2.IMREAD_UNCHANGED keeps
    apart, written by PIL and OpenCV."""
    from PIL import Image

    r = np.random.default_rng(0)
    g = r.integers(0, 256, (5, 7), dtype=np.uint8)
    rgb = r.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    paths = {}

    def put(name, save):
        paths[name] = str(tmp_path / f"{name}.png")
        save(paths[name])

    put("gray8", lambda p: Image.fromarray(g).save(p))
    put("gray_alpha", lambda p: Image.fromarray(np.stack([g, g[::-1]], -1), "LA").save(p))
    put("palette", lambda p: Image.fromarray(g).convert("P").save(p))
    put("palette_trns", lambda p: Image.fromarray(g).convert("P").save(p, transparency=5))
    put("rgb_trns", lambda p: Image.fromarray(rgb).save(p, transparency=tuple(int(v) for v in rgb[1, 2])))
    put("rgba", lambda p: Image.fromarray(np.concatenate([rgb, g[..., None]], 2)).save(p))
    put("gray16", lambda p: cv2.imwrite(p, r.integers(0, 65536, (5, 7)).astype(np.uint16)))
    put("bgr16", lambda p: cv2.imwrite(p, r.integers(0, 65536, (5, 7, 3)).astype(np.uint16)))
    put("bgra16", lambda p: cv2.imwrite(p, r.integers(0, 65536, (5, 7, 4)).astype(np.uint16)))
    put("bits1", lambda p: Image.fromarray(g > 128).save(p))
    put("gray_trns", lambda p: Image.fromarray(g).save(p, transparency=7))
    return paths


def test_imread_equals_opencv_unchanged(tmp_path):
    from PIL import Image

    paths = _png_cases(tmp_path)
    r = np.random.default_rng(1)
    for name, mode in (("color", "RGB"), ("gray", "L")):
        paths[f"jpeg_{name}"] = str(tmp_path / f"{name}.jpg")
        shape = (9, 11, 3) if mode == "RGB" else (9, 11)
        Image.fromarray(r.integers(0, 256, shape, dtype=np.uint8), mode).save(
            paths[f"jpeg_{name}"], quality=90)
    for name, p in paths.items():
        got, want = imio.imread(p), cv2.imread(p, cv2.IMREAD_UNCHANGED)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("ext,dtype,ch", [(".png", np.uint8, 1), (".png", np.uint8, 3),
                                          (".png", np.uint8, 4), (".png", np.uint16, 1),
                                          (".png", np.uint16, 3), (".jpg", np.uint8, 1),
                                          (".jpg", np.uint8, 3)])
def test_imwrite_as_opencv(tmp_path, ext, dtype, ch):
    """imwrite's files decode (cv2.imread) to cv2.imwrite's; its JPEG
    bytes equal OpenCV's."""
    from scipy.ndimage import gaussian_filter

    img = _image(dtype, ch, 23, 17, 3)
    if ext == ".jpg":
        img = np.clip(gaussian_filter(img.astype(np.float32), 1.0), 0, 255).astype(np.uint8)
    mine, theirs = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    imio.imwrite(mine, img)
    cv2.imwrite(theirs, img)
    a = cv2.imread(mine, cv2.IMREAD_UNCHANGED)
    assert np.array_equal(a, cv2.imread(theirs, cv2.IMREAD_UNCHANGED))
    if ext == ".png":
        assert np.array_equal(a, img) and np.array_equal(imio.imread(mine), img)
    else:
        with open(mine, "rb") as f, open(theirs, "rb") as g:
            assert f.read() == g.read()


def _interface(jaxmod, names, K, width=64, height=48):
    itf = jaxmod.Interface()
    for i, name in enumerate(names):
        itf.platforms.append(jaxmod.Platform(
            name=f"p{i}", cameras=[jaxmod.CameraRig(width=width, height=height, K=K)]))
        itf.images.append(jaxmod.ImageMeta(name=name, platform_id=i, camera_id=0,
                                           pose_id=0, id=i))
    return itf


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_undistort_interface_images_equal_jax(tmp_path, ext):
    """Same names (a basename in two folders and a genuine stem_1 input
    collide), the same skipped images (zero coefficients, a missing file),
    a normalized K scaled up, and files equal to the JAX package's: PNG
    pixels equal, JPEG bytes equal."""
    from scipy.ndimage import gaussian_filter

    r = np.random.default_rng(4)
    names = []
    for sub, stem in (("a", "img"), ("b", "img"), ("b", "img_1"), ("c", "zero"),
                      ("c", "norm")):
        (tmp_path / sub).mkdir(exist_ok=True)
        img = np.clip(gaussian_filter(r.uniform(0, 255, (48, 64, 3)), (2, 2, 0)), 0, 255)
        names.append(str(tmp_path / sub / f"{stem}{ext}"))
        cv2.imwrite(names[-1], img.astype(np.uint8))
    names.append(str(tmp_path / "missing.png"))
    K = np.array([[60.0, 0, 31.5], [0, 60.0, 23.5], [0, 0, 1]])
    dists = {i: np.array([0.05 * (i + 1), -0.01, 0, 0, 0]) for i in range(6)}
    dists[3] = np.zeros(5)
    outs = []
    for mod, undmod in ((pmvs, und), (jmvs, jund)):
        itf = _interface(mod, names, K)
        itf.platforms[4].cameras[0].K = K / 64.0 * np.array([[1], [1], [64]])
        out = tmp_path / ("port" if mod is pmvs else "jax")
        n = undmod.undistort_interface_images(itf, dists, str(out))
        outs.append((n, [m.name for m in itf.images], out))
    (n, pnames, pout), (jn, jnames, jout) = outs
    assert n == jn == 4
    assert [x.replace(str(pout), "OUT") for x in pnames] == [x.replace(str(jout), "OUT")
                                                             for x in jnames]
    for a, b in zip(pnames, jnames):
        if a.startswith(str(pout)):
            if ext == ".png":
                assert np.array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                                      cv2.imread(b, cv2.IMREAD_UNCHANGED))
            else:
                with open(a, "rb") as f, open(b, "rb") as g:
                    assert f.read() == g.read()


def test_tail_columns_wrap_as_opencv():
    """OpenCV's map loop packs the 8-column blocks with saturation and
    casts the scalar tail (the last width % 8 columns) to short, which
    wraps. These coefficients send the tail's pixels more than 2^20 px
    away, so map1 there wraps; the port's map and its undistorted image
    equal cv2's and the JAX package's byte for byte."""
    W, H = 45, 31
    K = np.array([[40.0, 0, 22.3], [0, 40.0, 15.6], [0, 0, 1.0]])
    d = np.array([5.0e5, 0, 0, 0, 0])
    m1, m2 = und.init_undistort_map(K, d, W, H)
    c1, c2 = cv2.initUndistortRectifyMap(K, d, None, K, (W, H), cv2.CV_16SC2)
    u = K[0, 2] + np.abs(((np.arange(W) - K[0, 2]) / K[0, 0]) ** 3 * d[0] * K[0, 0])
    assert u[W - W % 8:].min() > 2 ** 20            # the tail lies that far out
    assert (np.abs(c1[:, W - W % 8:].astype(np.int64)) < 32767).any()   # and wraps
    assert np.array_equal(m1, c1) and np.array_equal(m2, c2)
    img = _image(np.uint8, 3, W, H, 9)
    out = und.undistort_image(img, K, d)
    assert np.array_equal(out, jund.undistort_image(img, K, d))
    assert np.array_equal(out, cv2.undistort(img, K, d))
