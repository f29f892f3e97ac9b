"""Interpolated seeding (``DenseOptions(init_sparse=False)``,
``ops/seed.seed_depth_normal(interpolate=True)``) of the port against the
JAX package's on the synthetic 120x160 scene: the seeds rasterize the
Delaunay triangulation of the projected sparse points with the port's copy
of the JAX package's z-buffer rasterizer, so the seed maps are equal to
the bit (stricter than the JAX suite's assert_allclose on its seeds,
tests/test_extras.py:137-160)."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from _torch_helpers import slice_scenes  # noqa: E402

from openmvs_tpu.geometry.camera import Camera as JaxCamera  # noqa: E402
from openmvs_tpu.ops import seed as jseed  # noqa: E402
from openmvs_tpu_torch.geometry.camera import Camera  # noqa: E402
from openmvs_tpu_torch.ops import seed  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("add_corners", [False, True])
def test_interpolated_seeds_equal_jax(add_corners):
    scene, _ = slice_scenes()
    pts = np.asarray(scene.pointcloud.points, np.float64)
    for k, img in enumerate(scene.images):
        cam = img.working_camera()
        H, W = img.gray.shape
        trusted = np.arange(len(pts)) % 5 != k     # some seeds untrusted
        got = seed.seed_depth_normal(cam, W, H, pts, trusted, interpolate=True,
                                     add_corners=add_corners)
        want = jseed.seed_depth_normal(JaxCamera(cam.K, cam.R, cam.C), W, H, pts,
                                       trusted, interpolate=True, add_corners=add_corners)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        sparse = seed.seed_depth_normal(cam, W, H, pts, trusted)[0]
        assert (got[0] > 0).mean() > 0.5 > (sparse > 0).mean()


def test_interpolated_seeds_small_frame_equal_jax():
    """The JAX suite's own seeding case (tests/test_extras.py:137-160)."""
    rng = np.random.default_rng(0)
    K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]])
    pts = rng.uniform(-2.4, 2.4, (60, 3)) * [1, 1, 0.3] + [0, 0, 5.0]
    trusted = np.ones(60, bool)
    for corners in (False, True):
        got = seed.seed_depth_normal(Camera(K, np.eye(3), np.zeros(3)), 64, 64, pts,
                                     trusted, interpolate=True, add_corners=corners)
        want = jseed.seed_depth_normal(JaxCamera(K, np.eye(3), np.zeros(3)), 64, 64, pts,
                                       trusted, interpolate=True, add_corners=corners)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))

