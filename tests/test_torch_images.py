"""Host image resampling of the port against OpenCV and jax.image.resize."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from openmvs_tpu.io import images as jimio  # noqa: E402
from openmvs_tpu_torch import densify  # noqa: E402
from openmvs_tpu_torch.io import images as imio  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("src,dst", [
    ((480, 640), (240, 320)),    # halvings, as the pyramid takes them
    ((240, 320), (120, 160)),
    ((121, 161), (60, 80)),      # odd source
    ((125, 93), (62, 46)),
    ((100, 75), (37, 29)),       # fractional area weights
    ((64, 48), (63, 47)),
])
def test_resize_area_matches_cv2(src, dst):
    rng = np.random.default_rng(src[0] * 1000 + src[1])
    img = rng.uniform(0, 1, src).astype(np.float32)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    out = imio.resize_area(img, dst[1], dst[0])
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_resize_area_color_uint8():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (97, 131, 3), dtype=np.uint8)
    ref = cv2.resize(img, (65, 48), interpolation=cv2.INTER_AREA)
    out = imio.resize_area(img, 65, 48)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("args", [(640, 480, 1, 640, 3200), (4000, 3000, 1, 640, 3200),
                                  (160, 120, 1, 640, 3200), (8000, 6000, 0, 640, 3200)])
def test_compute_max_resolution_matches(args):
    assert imio.compute_max_resolution(*args) == jimio.compute_max_resolution(*args)


@pytest.mark.parametrize("src,dst", [((60, 80), (120, 160)), ((31, 62), (62, 125)),
                                     ((15, 20), (31, 41)), ((62, 80), (125, 160))])
def test_pyramid_upsampling_matches_jax_image_resize(src, dst):
    """Seeds of the next pyramid level: linear for depth, nearest for the
    normals, at exact 2x and at odd sizes."""
    rng = np.random.default_rng(1)
    d = rng.uniform(4, 8, src).astype(np.float32)
    d[rng.random(src) < 0.2] = 0.0
    n = rng.normal(size=src + (3,)).astype(np.float32)
    ref_d = np.asarray(jax.image.resize(jnp.asarray(d), dst, "linear"))
    ref_n = np.asarray(jax.image.resize(jnp.asarray(n), dst + (3,), "nearest"))
    out_d = densify._resize_linear(torch.from_numpy(d), *dst).numpy()
    out_n = densify._resize_nearest(torch.from_numpy(n), *dst).numpy()
    if dst == (2 * src[0], 2 * src[1]):
        # the pyramid's case: the same taps fused in the same order
        np.testing.assert_array_equal(out_d, ref_d)
    # at other sizes jax's sums of three or more taps differ by a few ulp
    np.testing.assert_allclose(out_d, ref_d, rtol=3e-6, atol=1e-6)
    np.testing.assert_array_equal(out_n, ref_n)
