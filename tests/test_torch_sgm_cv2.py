"""The port's rebuilds of OpenCV's two SGM calls against OpenCV itself:
``io/images.warp_perspective`` for ``cv2.warpPerspective`` (pair
rectification) and ``ops/sgm.filter_speckles`` for ``cv2.filterSpeckles``.

Tolerances: the speckle filter exactly; the warp within 1e-5 and bit for
bit on at least 99.9% of pixels (it is bit-exact on every case here: the
rebuild repeats OpenCV 5's float32 arithmetic, and only a coordinate that
rounds differently in the inverse's last bit would move a sample).

OpenCV is imported by the ``cv2`` fixture, so ``_rectifications`` imports
where it is missing (``test_torch_rectify_card.py`` holds the card's warp
to the same cases)."""

import numpy as np
import pytest

from openmvs_tpu_torch.io.images import warp_perspective
from openmvs_tpu_torch.ops import sgm as tsgm


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def _rectifications():
    """(name, homography, H, W) of the SGM slice scene's pair
    rectifications and of three others."""
    from openmvs_tpu_torch.synthetic import build_gt_scene

    scene, _, _ = build_gt_scene(n_views=3, W=160, H=120)
    cases = []
    for i, j in ((0, 1), (0, 2), (2, 1)):
        a, b = scene.images[i], scene.images[j]
        _, _, info = tsgm.rectify_pair(a.working_camera(), b.working_camera(), a.gray, b.gray)
        cases += [(f"rect_{i}{j}_A", info["TA"], 120, 160), (f"rect_{i}{j}_B", info["TB"], 120, 160)]
    cases += [
        ("identity", np.eye(3), 120, 160),
        ("strong_perspective", np.array([[0.8, 0.25, 12.0], [-0.1, 1.1, -7.0],
                                         [1.2e-3, -8e-4, 1.0]]), 120, 160),
        ("rotation_odd_width", np.array([[np.cos(0.3), -np.sin(0.3), 20.0],
                                         [np.sin(0.3), np.cos(0.3), -15.0], [0, 0, 1.0]]), 67, 93),
        ("narrow", np.array([[1.02, 0.01, -0.6], [0.0, 0.99, 0.4], [1e-4, 0, 1.0]]), 9, 31),
    ]
    return cases


@pytest.mark.parametrize("case", _rectifications(), ids=lambda c: c[0])
def test_warp_perspective_matches_cv2(cv2, case):
    _, M, H, W = case
    src = np.random.default_rng(0).uniform(0, 1, (H, W)).astype(np.float32)
    want = cv2.warpPerspective(src, M.astype(np.float64), (W, H))
    got = warp_perspective(src, M, W, H)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("max_size,max_diff", [(100, 80), (10, 16), (1, 0), (400, 3)])
def test_filter_speckles_matches_cv2(cv2, max_size, max_diff):
    rng = np.random.default_rng(max_size + max_diff)
    for trial in range(3):
        d = np.round(rng.uniform(-500, -80, (57, 83)) / 8).astype(np.int16) * 8
        d[rng.random(d.shape) < 0.25] = -32768                 # NaN holes
        d[5:40, 10:60] = -200 + rng.integers(-2, 3, (35, 50)) * max(max_diff // 2, 1)
        want = d.copy()
        cv2.filterSpeckles(want, -32768, max_size, max_diff)
        got = tsgm.filter_speckles(d.copy(), -32768, max_size, max_diff)
        assert np.array_equal(got, want), trial


@pytest.mark.parametrize("max_size,max_diff", [(100, 5.0), (20, 1.0)])
def test_speckle_filter_matches_cv2_on_float_disparities(cv2, max_size, max_diff):
    rng = np.random.default_rng(7)
    disp = (np.round(rng.normal(-20, 3, (64, 96)) * 4) / 4).astype(np.float32)
    disp[rng.random(disp.shape) < 0.2] = np.nan
    disp[20:50, 30:80] = -14.5
    d16 = np.where(np.isfinite(disp), disp * 16.0, -32768).astype(np.int16)
    cv2.filterSpeckles(d16, -32768, max_size, int(max_diff * 16))
    want = d16.astype(np.float32) / 16.0
    want[d16 == -32768] = np.nan
    got = tsgm._speckle_filter(disp, max_size, max_diff)
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("shape", [(0, 64), (64, 0), (0, 0)])
def test_speckle_filter_degenerate_shapes(shape):
    empty = np.zeros(shape, np.int16)
    assert tsgm.filter_speckles(empty, -32768, 100, 80).shape == shape
    assert tsgm._speckle_filter(np.full(shape, np.nan, np.float32)).shape == shape
