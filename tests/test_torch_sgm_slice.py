"""The SGM slice against the JAX package on the CPU: ``match_pair_tsgm`` on
a rectified pair of the synthetic scene at 120x160 (with the behaviour
switches), ``estimate_depth_map_sgm`` per view, and
``dense_reconstruction(estimator="sgm")`` with its ``.dimap`` export
(``fusion_mode=-1``) and resume (``-2``).

Tolerance: per pair, at least 99.9% of pixels with the same disparity
(both invalid, or both valid within 1e-3 px). That is the smaller of the
dry-run's 0.999 bar (``__graft_entry__.py:221-222``) and the JAX package's
own floor here, 0.99995: its agreement with itself when 10% of the pixels
of every image move by one ulp (``python tests/_torch_sgm_floor.py``). The
port reaches 1.0 on every pair."""

import os

import numpy as np
import pytest
import torch

from _torch_helpers import (SGM_VIEWS, depth_agreement, disparity_agreement,
                            jax_scene, pair_disparities)

torch.set_num_threads(2)

AGREEMENT = 0.999


@pytest.fixture(scope="module")
def arrays():
    from openmvs_tpu_torch.synthetic import build_gt_scene

    return build_gt_scene(n_views=SGM_VIEWS, W=160, H=120)[2]


@pytest.fixture(scope="module")
def rectified(arrays):
    """View 0 and view 1 rectified (by the JAX package: the port's
    rectification is held to cv2 in test_torch_sgm_cv2.py), with the sparse
    seeds' disparity range."""
    from openmvs_tpu.ops import sgm as jsgm

    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.densify import _sgm_pair_range

    scene = jax_scene(arrays)
    a, b = scene.images[0], scene.images[1]
    camA, camB = a.working_camera(), b.working_camera()
    rectA, rectB, info = jsgm.rectify_pair(camA, camB, a.gray, b.gray)
    pts = np.asarray(arrays["points"], np.float64)
    d_lo, d_hi = _sgm_pair_range(pts, info, camA, camB, DenseOptions())
    return rectA, rectB, d_lo, d_hi


@pytest.mark.parametrize("env,kw", [
    ({}, {}),
    ({"OMVS_SGM_FB": "full"}, {}),
    ({"OMVS_SGM_ND_LADDER": "32,256"}, {}),
    ({}, {"subpixel_mode": "parabola", "num_dirs": 4}),
], ids=["default", "fb_full", "nd_ladder", "parabola_4dirs"])
def test_match_pair_tsgm_matches_jax(rectified, monkeypatch, env, kw):
    from openmvs_tpu.ops import sgm as jsgm

    from openmvs_tpu_torch.ops import sgm as tsgm

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rectA, rectB, d_lo, d_hi = rectified
    dj, cj = jsgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, **kw)
    stats = []
    dp, cp = tsgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, device="cpu", stats=stats, **kw)
    assert dp.dtype == np.float32 and dp.shape == dj.shape
    assert disparity_agreement(dp, dj) >= AGREEMENT
    assert (cp == cj).mean() >= AGREEMENT
    assert [lv["hw"] for lv in stats] == [[60, 80], [120, 160]]
    assert np.isfinite(dp).mean() > 0.3


def test_rectify_pair_equals_jax(arrays):
    from openmvs_tpu.ops import sgm as jsgm

    from openmvs_tpu_torch.ops import sgm as tsgm

    scene = jax_scene(arrays)
    for i, j in ((0, 1), (1, 0), (0, 2)):
        a, b = scene.images[i], scene.images[j]
        want = jsgm.rectify_pair(a.working_camera(), b.working_camera(), a.gray, b.gray)
        got = tsgm.rectify_pair(a.working_camera(), b.working_camera(), a.gray, b.gray)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        for k in ("Rn", "Kn", "baseline", "TA", "TB", "C1"):
            assert np.array_equal(got[2][k], want[2][k])


def test_estimate_depth_map_sgm_matches_jax(arrays, tmp_path):
    from openmvs_tpu import densify as jd
    from openmvs_tpu.config import DenseOptions as JaxOptions
    from openmvs_tpu.view_selection import select_views_for_scene as jax_select

    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.convert import scene_from_arrays
    from openmvs_tpu_torch.view_selection import select_views_for_scene

    js, ps = jax_scene(arrays), scene_from_arrays(**arrays)
    jax_select(js, JaxOptions(estimator="sgm"))
    select_views_for_scene(ps, DenseOptions(estimator="sgm"))
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    for i in range(SGM_VIEWS):
        rj = jd.estimate_depth_map_sgm(js, i, JaxOptions(estimator="sgm"),
                                       dimap_dir=str(tmp_path / "j"))
        rp = densify.estimate_depth_map_sgm(ps, i, DenseOptions(estimator="sgm"),
                                            dimap_dir=str(tmp_path / "p"), device="cpu")
        assert rp.neighbor_ids == rj.neighbor_ids
        assert (rp.depth == rj.depth).mean() >= AGREEMENT
        assert (rp.normal == rj.normal).all(-1).mean() >= AGREEMENT
        assert abs(rp.d_min - rj.d_min) <= 1e-3 * rj.d_min
    pj, pp = pair_disparities(str(tmp_path / "j")), pair_disparities(str(tmp_path / "p"))
    assert sorted(pj) == sorted(pp) and len(pj) == 2 * SGM_VIEWS
    for k in pj:
        assert disparity_agreement(pp[k], pj[k]) >= AGREEMENT
    # the cached pairs are read back, not matched again
    cached = densify.estimate_depth_map_sgm(ps, 0, DenseOptions(estimator="sgm"),
                                            dimap_dir=str(tmp_path / "p"), device="cpu")
    assert cached is not None and (cached.depth > 0).any()


def _dmaps(folder):
    from openmvs_tpu_torch.io import dmap

    return [dmap.load(os.path.join(folder, f"depth{i:04d}.dmap")).depth
            for i in range(SGM_VIEWS)]


def _run(arrays, port, opts, folder, fusion_mode):
    if port:
        from openmvs_tpu_torch import densify
        from openmvs_tpu_torch.config import DenseOptions
        from openmvs_tpu_torch.convert import scene_from_arrays

        return densify.dense_reconstruction(
            scene_from_arrays(**arrays), DenseOptions(**opts), save_dmaps_to=folder,
            fusion_mode=fusion_mode, device="cpu")
    from openmvs_tpu import densify as jd
    from openmvs_tpu.config import DenseOptions as JaxOptions

    return jd.dense_reconstruction(jax_scene(arrays), JaxOptions(**opts),
                                   save_dmaps_to=folder, fusion_mode=fusion_mode)


def test_dense_reconstruction_sgm_matches_jax_with_export_and_resume(arrays, tmp_path):
    """Mode 0 against JAX; then -1 (forces SGM, exports the .dimap files,
    returns no cloud), -2 resuming from the .dmap files (the mode-0 cloud),
    and -2 with the .dmap files gone, re-projecting the .dimap files."""
    sgm = dict(estimator="sgm")
    out = {}
    for port in (False, True):
        tag = "p" if port else "j"
        d0, d1 = tmp_path / f"{tag}0", tmp_path / f"{tag}1"
        pc0 = _run(arrays, port, sgm, str(d0), 0)
        maps0 = _dmaps(str(d0))
        pc_x = _run(arrays, port, {}, str(d1), -1)
        dimaps = sorted(f for f in os.listdir(d1) if f.endswith(".dimap"))
        pc_r = _run(arrays, port, sgm, str(d1), -2)
        for f in os.listdir(d1):
            if f.endswith(".dmap"):
                os.remove(d1 / f)
        pc_d = _run(arrays, port, sgm, str(d1), -2)
        out[tag] = dict(pc0=pc0, maps0=maps0, pc_x=pc_x, dimaps=dimaps, pc_r=pc_r,
                        pc_d=pc_d, disp=pair_disparities(str(d1)))
    j, p = out["j"], out["p"]
    masks, pooled, per_view = depth_agreement(p["maps0"], j["maps0"])
    assert min(masks) >= AGREEMENT and pooled >= AGREEMENT
    assert abs(len(p["pc0"]) - len(j["pc0"])) <= 0.001 * len(j["pc0"])
    assert len(p["pc_x"]) == 0 and p["dimaps"] == j["dimaps"] and len(p["dimaps"]) == 2 * SGM_VIEWS
    for f in p["dimaps"]:
        assert disparity_agreement(p["disp"][f], j["disp"][f]) >= AGREEMENT
    # -2 from the .dmap files gives the mode-0 cloud
    assert len(p["pc_r"]) == len(p["pc0"])
    assert np.array_equal(np.asarray(p["pc_r"].points), np.asarray(p["pc0"].points))
    # -2 from the .dimap files alone: both packages lose the same sub-pixel
    assert abs(len(p["pc_d"]) - len(j["pc_d"])) <= 0.001 * len(j["pc_d"])
