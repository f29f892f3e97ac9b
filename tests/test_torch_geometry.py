"""The port's host geometry (``geometry/robust.py``, ``lm.py``,
``similarity.py``) against the JAX package's on the same numpy inputs. Both
are numpy and scipy, so every result is expected equal (``np.array_equal``,
no tolerance): the norms, AC-RANSAC with its seeded draws, LM fits, the
Umeyama similarity, ``align_scenes`` with its LM refinement, and the ground
plane by RANSAC and by AC-RANSAC.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from openmvs_tpu.geometry import lm as jlm  # noqa: E402
from openmvs_tpu.geometry import robust as jrobust  # noqa: E402
from openmvs_tpu.geometry import similarity as jsim  # noqa: E402
from openmvs_tpu_torch.geometry import lm, robust, similarity  # noqa: E402

torch.set_num_threads(1)


def _equal(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(robust.NORMS))
def test_norms_equal_jax(name):
    r = np.random.default_rng(0).normal(0, 4, 500)
    for scale in (0.5, 1.5, 4.0):
        assert _equal(robust.NORMS[name](r, scale), jrobust.NORMS[name](r, scale))


def _plane_points(n=2000, outliers=600, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, 10, (n, 2))
    z = 0.3 * xy[:, 0] - 0.2 * xy[:, 1] + 5 + rng.normal(0, 0.01, n)
    return np.r_[np.c_[xy, z], rng.uniform(-10, 10, (outliers, 3)) * [1, 1, 2]]


@pytest.mark.parametrize("scale,max_eval,max_threshold", [(1.0, 50000, 0.0), (1000.0, 50000, 0.0),
                                                          (1.0, 900, 0.0), (1.0, 50000, 0.05)])
def test_ac_ransac_plane_equal_jax(scale, max_eval, max_threshold):
    """Same model, mask, threshold and NFA: the seeded draws (the
    evaluation subsample, then each minimal sample) come in the same
    order."""
    P = _plane_points() * scale
    kw = dict(max_threshold=max_threshold * scale, iters=256, seed=1, max_eval=max_eval)
    got, want = robust.ac_ransac_plane(P, **kw), jrobust.ac_ransac_plane(P, **kw)
    assert _equal(got, want)
    true_n = np.array([0.3, -0.2, -1.0]) / np.linalg.norm([0.3, -0.2, -1.0])
    assert abs(got[0] @ true_n) > 0.999


@pytest.mark.parametrize("robust_norm", [None, "huber", "tukey", "cauchy"])
def test_lm_fit_equal_jax(robust_norm):
    t = np.linspace(0, 4, 60)
    y = 2.5 * np.exp(-1.3 * t) + 0.4
    y[::9] += 0.5                       # a few outliers

    def res(x):
        return x[0] * np.exp(-x[1] * t) + x[2] - y

    def jac(x):
        e = np.exp(-x[1] * t)
        return np.stack([e, -x[0] * t * e, np.ones_like(t)], 1)

    for j in (None, jac):
        kw = dict(jac=j, robust=robust_norm, robust_scale=0.3)
        got = lm.lm_fit(res, np.array([1.0, 0.5, 0.0]), **kw)
        want = jlm.lm_fit(res, np.array([1.0, 0.5, 0.0]), **kw)
        assert _equal(got[0], want[0]) and got[1:] == want[1:]


@pytest.mark.parametrize("robust_norm", [None, "huber"])
def test_similarity_fits_equal_jax(robust_norm):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(2)
    src = rng.normal(size=(12, 3))
    R = Rotation.from_rotvec([0.2, -0.1, 0.4]).as_matrix()
    dst = 1.7 * src @ R.T + [0.5, -1.0, 2.0]
    dst[0] += [5.0, -4.0, 3.0]          # a gross outlier
    for with_scale in (True, False):
        T0, s0 = similarity.umeyama(src, dst, with_scale)
        assert _equal((T0, s0), jsim.umeyama(src, dst, with_scale))
    got = lm.refine_similarity(src, dst, T0, s0, robust=robust_norm)
    assert _equal(got, jlm.refine_similarity(src, dst, T0, s0, robust=robust_norm))


def _mini_scenes(mod_scene, mod_camera, mod_mvs, offset, scale, n=5):
    """The test_extras scene: 5 named cameras on a path, as either
    package's Scene."""
    scene = mod_scene.Scene()
    K = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1.0]])
    for i in range(n):
        meta = mod_mvs.ImageMeta(name=f"cam{i}.jpg", id=i, platform_id=i)
        C = scale * np.array([i * 1.0, (i % 2) * 2.0, i * 0.5 + 0.1 * i * i]) + offset
        R = np.eye(3)
        scene.platforms.append(mod_mvs.Platform(
            name=f"p{i}", cameras=[mod_mvs.CameraRig(K=K, width=640, height=480)],
            poses=[mod_mvs.Pose(R=R, C=C)]))
        scene.images.append(mod_scene.SceneImage(meta=meta, camera=mod_camera.Camera(K, R, C),
                                                 width=640, height=480))
    return scene


@pytest.mark.parametrize("n", [3, 5])
def test_align_scenes_equal_jax(n):
    """align_scenes: names matched, Umeyama, and (4 or more cameras) the
    robust LM refinement; the transform and the moved scene equal."""
    from openmvs_tpu import scene as jscene
    from openmvs_tpu.geometry import camera as jcamera
    from openmvs_tpu.io import mvs as jmvs

    from openmvs_tpu_torch import scene as pscene
    from openmvs_tpu_torch.geometry import camera as pcamera
    from openmvs_tpu_torch.io import mvs as pmvs

    args = (np.array([5.0, -1.0, 2.0]), 0.5, n)
    pa, pr = (_mini_scenes(pscene, pcamera, pmvs, *args),
              _mini_scenes(pscene, pcamera, pmvs, np.zeros(3), 1.0, n))
    ja, jr = (_mini_scenes(jscene, jcamera, jmvs, *args),
              _mini_scenes(jscene, jcamera, jmvs, np.zeros(3), 1.0, n))
    T = similarity.align_scenes(pa, pr)
    assert _equal(T, jsim.align_scenes(ja, jr))
    for a, b in zip(pa.images, ja.images):
        assert _equal(a.camera.C, b.camera.C) and _equal(a.camera.R, b.camera.R)
    np.testing.assert_allclose([im.camera.C for im in pa.images],
                               [im.camera.C for im in pr.images], atol=1e-9)


@pytest.mark.parametrize("threshold", [0.0, 0.05, 20.0])
def test_ground_plane_equal_jax(threshold):
    """threshold 0 takes AC-RANSAC, a positive one the plain RANSAC."""
    rng = np.random.default_rng(1)
    ground = np.c_[rng.uniform(-5, 5, (500, 2)), rng.normal(0, 0.01, 500)]
    clutter = rng.uniform(-2, 2, (100, 3)) + [0, 0, 3.0]
    P = np.vstack([ground, clutter])
    got = similarity.estimate_ground_plane(P, threshold=threshold, iters=128, seed=3)
    assert _equal(got, jsim.estimate_ground_plane(P, threshold=threshold, iters=128, seed=3))
    if threshold < 1:
        assert abs(abs(got[0][2]) - 1.0) < 1e-2
