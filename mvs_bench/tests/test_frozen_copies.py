"""The yardstick was copied, not reinvented: the scene generator's true
depth and images equal the port's ``synthetic.py`` at a small size, and
the work counts equal ``chip_smoke.py``'s for PERF.md's kernel-table
shapes."""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import chip_smoke
from mvs_bench import scene_gen, work
from openmvs_tpu_torch import synthetic


@pytest.mark.parametrize("center", [(0.0, 0.0, 0.0), (-0.8, 0.8, 0.0), (0.8, 0.15, 0.0)])
def test_true_depth_equals_synthetic_ray_march(center):
    W, H = 48, 36
    K = synthetic.camera_intrinsics(W, H)
    np.testing.assert_array_equal(K, scene_gen.intrinsics(W, H))
    C = np.array(center)
    want, xy = synthetic.ray_march(K, C, W, H)
    got, x, y = scene_gen.ray_march(K, C, W, H, "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    hit = want > 0
    np.testing.assert_allclose(x.numpy()[hit], xy[..., 0][hit], rtol=0, atol=1e-12)


def test_images_equal_synthetic_at_phase_zero():
    """The gray image is synthetic.build_gt_scene's: ``texture`` at the
    surface point, smoothed by gaussian_filter(0.5, mirror); the colour its
    ``albedo`` smoothed alike."""
    W, H = 40, 30
    K = scene_gen.intrinsics(W, H)
    C = synthetic.camera_center(1)
    depth, gray, rgb = scene_gen.render(K, C, W, H, (0.0, 0.0), "cpu")
    d, xy = synthetic.ray_march(K, C, W, H)
    want = gaussian_filter(np.where(d > 0, synthetic.texture(xy[..., 0], xy[..., 1]),
                                    0.0).astype(np.float32), 0.5, mode="mirror")
    np.testing.assert_allclose(gray.numpy(), want, rtol=0, atol=2e-7)
    want_rgb = gaussian_filter(np.where(d[..., None] > 0,
                                        synthetic.albedo(xy[..., 0], xy[..., 1]),
                                        0.0).astype(np.float32), (0.5, 0.5, 0), mode="mirror")
    np.testing.assert_allclose(rgb.numpy(), want_rgb, rtol=0, atol=2e-7)


def test_scaled_intrinsics_keep_pixel_centres():
    from openmvs_tpu_torch.geometry.camera import scale_K

    K = scene_gen.intrinsics(1600, 1200)
    np.testing.assert_array_equal(scene_gen.scale_intrinsics(K, 0.5), scale_K(K, 0.5))


# PERF.md's kernel table: C=11 and C=1 at 480x640, T=25, V=4, the geometric
# kernels against 480x640 neighbour depth maps
VIEWS_SHAPES = [(C, 480, 640, 25, 4, 480 * 640, 480 * 640, mode, geom)
                for C in (11, 1) for mode in ("exact", "nn")
                for geom in ("none", "geom", "pre")]


@pytest.mark.parametrize("shape", VIEWS_SHAPES)
def test_scorer_counts_equal_chip_smoke(shape):
    nbytes, flops, fp64 = work.score_views(*shape)
    assert (nbytes, flops) == chip_smoke._views_work(*shape) and fp64 == 0
    t, by = work.bound_s(nbytes, flops, fp64)
    want_ms, want_by = chip_smoke._bound_views(*shape)
    assert t * 1e3 == pytest.approx(want_ms, rel=1e-12) and by == want_by


@pytest.mark.parametrize("C", [11, 1])
def test_geom_counts_equal_chip_smoke(C):
    nbytes, flops, _ = work.geom_views(C, 480, 640, 4, 480 * 640)
    t, by = work.bound_s(nbytes, flops, 0)
    want_ms, want_by = chip_smoke._bound_geom_views(C, 480, 640, 4, 480 * 640)
    assert t * 1e3 == pytest.approx(want_ms, rel=1e-12) and by == want_by


@pytest.mark.parametrize("hs,ws,num_d", [(240, 320, 32), (240, 320, 64),
                                         (480, 640, 64), (480, 640, 128)])
def test_wzncc_counts_equal_chip_smoke(hs, ws, num_d):
    """chip_smoke._wzncc_rows' bytes and operations for its (2, hs, ws)
    levels with windows, T = 49."""
    T, px = 49, 2 * hs * ws
    want_bytes = (2 * T + 3) * px * 4 + 2 * px * 2 + 2 * 4 + px * num_d
    want32 = px * num_d * (chip_smoke.WZNCC_FLOP_TEXEL * T + chip_smoke.WZNCC_FLOP_EPILOGUE)
    want64 = px * num_d * chip_smoke.WZNCC_FLOP64
    assert work.wzncc_volume(2, hs, ws, T, num_d, True) == (want_bytes, want32, want64)
    want_t = max(want_bytes / chip_smoke.PEAK_BYTES,
                 want32 / chip_smoke.PEAK_FP32 + want64 / chip_smoke.PEAK_FP64)
    assert work.bound_s(want_bytes, want32, want64)[0] == want_t


def test_scan_counts_equal_chip_smoke():
    """chip_smoke._sgm_scan_rows: (2 xs + p2s) floats, 8 operations a cell."""
    xs = torch.zeros(3, 60, 80, 64)
    p2s = torch.zeros(3, 60, 80)
    assert work.sgm_scan(xs.numel(), p2s.numel()) == (
        (2 * xs.numel() + p2s.numel()) * 4, 8 * xs.numel(), 0)


def test_peaks_equal_chip_smoke():
    assert (work.PEAK_FP32, work.PEAK_FP64, work.PEAK_BYTES) == (
        chip_smoke.PEAK_FP32, chip_smoke.PEAK_FP64, chip_smoke.PEAK_BYTES)
    assert work.FLOP_TEXEL == chip_smoke.FLOP_TEXEL
    assert (work.FLOP_PIXEL, work.FLOP_GEOM, work.FLOP_SHARED, work.FLOP_FINISH) == (
        chip_smoke.FLOP_PIXEL, chip_smoke.FLOP_GEOM, chip_smoke.FLOP_SHARED,
        chip_smoke.FLOP_FINISH)
