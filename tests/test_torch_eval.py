"""Evaluation (``openmvs_tpu_torch/eval.py``) and the dataset adapters
(``datasets.py``) against the JAX package's on the CPU: the depth and
normal map comparisons and the point-cloud F-score on seeded inputs, the
ETH3D and DTU loaders on ``tests/test_datasets.py``'s mock layouts (a
distorted ETH3D calibration too, undistorted on load), ``decompose_P``,
``evaluate_eth3d``/``evaluate_dtu``, ``run_eval`` with an estimate, and the
``eval`` subcommand through both CLIs. Host numpy and scipy's cKDTree in
both, with the same seeded subsampling, so results are held equal.
``run_eval(run_pipeline=True)`` is tests/test_torch_import_slice.py's.
"""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from openmvs_tpu import datasets as jdatasets  # noqa: E402
from openmvs_tpu import eval as jeval  # noqa: E402
from openmvs_tpu_torch import datasets  # noqa: E402
from openmvs_tpu_torch import eval as peval  # noqa: E402
from openmvs_tpu_torch.io import ply as plyio  # noqa: E402
from test_datasets import _make_dtu_mock, _make_eth3d_mock  # noqa: E402

torch.set_num_threads(1)


def _depths(seed=0, hole=0.2):
    r = np.random.default_rng(seed)
    gt = r.uniform(2, 8, (40, 50)).astype(np.float32)
    gt[r.random(gt.shape) < hole] = 0
    est = (gt * (1 + r.normal(0, 0.02, gt.shape))).astype(np.float32)
    est[r.random(gt.shape) < hole] = 0
    return est, gt


@pytest.mark.parametrize("hole", [0.2, 1.0])
def test_compare_depth_and_normal_maps_equal_jax(hole):
    est, gt = _depths(hole=hole)
    a, b = peval.compare_depth_maps(est, gt), jeval.compare_depth_maps(est, gt)
    assert np.array_equal(np.array(list(vars(a).values()), np.float64),
                          np.array(list(vars(b).values()), np.float64), equal_nan=True)
    r = np.random.default_rng(1)
    n_est, n_gt = r.normal(size=(40, 50, 3)), r.normal(size=(40, 50, 3))
    n_est[r.random((40, 50)) < hole] = 0
    x, y = peval.compare_normal_maps(n_est, n_gt), jeval.compare_normal_maps(n_est, n_gt)
    assert x.keys() == y.keys()
    assert np.array_equal(list(x.values()), list(y.values()), equal_nan=True)


@pytest.mark.parametrize("max_points", [200_000, 1500])
def test_point_cloud_fscore_equal_jax(max_points):
    """Below max_points whole clouds; above, the same seeded subsamples."""
    r = np.random.default_rng(2)
    gt = r.uniform(-1, 1, (4000, 3))
    est = np.r_[gt[:2500] + r.normal(0, 0.01, (2500, 3)), r.uniform(-1, 1, (600, 3))]
    for tol in (0.005, 0.02, 0.1):
        got = peval.point_cloud_fscore(est, gt, tol, max_points=max_points, seed=3)
        assert got == jeval.point_cloud_fscore(est, gt, tol, max_points=max_points, seed=3)


def _same_scene(a, b):
    assert len(a.images) == len(b.images)
    for x, y in zip(a.images, b.images):
        assert x.path == y.path and (x.width, x.height) == (y.width, y.height)
        for f in ("K", "R", "C"):
            assert np.array_equal(getattr(x.camera, f), getattr(y.camera, f)), f
    assert np.array_equal(a.pointcloud.points, b.pointcloud.points)
    assert all(np.array_equal(u, v) for u, v in zip(a.pointcloud.views, b.pointcloud.views))


@pytest.mark.parametrize("distorted", [False, True])
def test_eth3d_loader_equal_jax(tmp_path, distorted):
    scene_dir, _ = _make_eth3d_mock(str(tmp_path))
    if distorted:
        calib = os.path.join(scene_dir, "dslr_calibration_undistorted")
        os.rename(calib, os.path.join(scene_dir, "dslr_calibration_jpg"))
        with open(os.path.join(scene_dir, "dslr_calibration_jpg", "cameras.txt"), "w") as f:
            f.write("1 OPENCV 64 48 60 60 32 24 -0.12 0.04 0.0004 -0.0003\n")
    (a, ga), (b, gb) = datasets.load_eth3d_scene(scene_dir), jdatasets.load_eth3d_scene(scene_dir)
    assert ga == gb and len(ga) == 1
    _same_scene(a, b)
    # the undistorted copies go to <calibration>/undistorted/
    assert all(("/undistorted/" in im.path) == distorted for im in a.images)
    assert datasets.find_eth3d_calibration(scene_dir) == jdatasets.find_eth3d_calibration(scene_dir)


def test_dtu_loader_and_decompose_equal_jax(tmp_path):
    root, _, _ = _make_dtu_mock(str(tmp_path))
    (a, ga), (b, gb) = datasets.load_dtu_scan(root, 6), jdatasets.load_dtu_scan(root, 6)
    assert ga == gb
    _same_scene(a, b)
    rng = np.random.default_rng(2)
    for _ in range(10):
        P = rng.normal(size=(3, 4))
        got, want = datasets.decompose_P(P), jdatasets.decompose_P(P)
        assert all(np.array_equal(x, y) for x, y in zip(got, want))
    for fn in (datasets.load_dtu_scan, jdatasets.load_dtu_scan):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "nothing"), 1)


@pytest.mark.parametrize("dataset", ["eth3d", "dtu"])
def test_run_eval_with_estimate_equal_jax(tmp_path, dataset):
    if dataset == "eth3d":
        scene_dir, gt = _make_eth3d_mock(str(tmp_path))
        noise, kw = 0.002, {}
    else:
        scene_dir, _, gt = _make_dtu_mock(str(tmp_path))
        noise, kw = 0.3, {"scan": 6}
    rng = np.random.default_rng(1)
    est = gt + rng.normal(0, noise, gt.shape)
    est_ply = str(tmp_path / "est.ply")
    plyio.save_point_cloud(est_ply, est.astype(np.float32))
    got = datasets.run_eval(dataset, scene_dir, est_ply=est_ply, max_points=1000,
                            out_json=str(tmp_path / "p.json"), **kw)
    want = jdatasets.run_eval(dataset, scene_dir, est_ply=est_ply, max_points=1000,
                              out_json=str(tmp_path / "j.json"), **kw)
    assert got == want
    assert json.load(open(tmp_path / "p.json")) == json.load(open(tmp_path / "j.json"))
    with pytest.raises(ValueError, match="est_ply"):
        datasets.run_eval(dataset, scene_dir, **kw)


def test_eval_cli_equal_jax(tmp_path, capsys):
    from openmvs_tpu.__main__ import main as jax_main

    from openmvs_tpu_torch.__main__ import main

    scene_dir, gt = _make_eth3d_mock(str(tmp_path))
    est_ply = str(tmp_path / "est.ply")
    plyio.save_point_cloud(est_ply, (gt + 0.004).astype(np.float32))
    args = ["eval", "--dataset", "eth3d", "--scene", scene_dir, "--est", est_ply]
    main(args + ["-o", str(tmp_path / "p.json")])
    port = capsys.readouterr().out
    jax_main(args + ["-o", str(tmp_path / "j.json")])
    assert port == capsys.readouterr().out and '"fscore@2cm"' in port


def test_run_eval_densifies_on_the_card_by_default(tmp_path):
    """run_eval(run_pipeline=True) and ``eval --run`` densify on the card
    unless told otherwise, and raise without one."""
    from openmvs_tpu_torch.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    scene_dir, _ = _make_eth3d_mock(str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        datasets.run_eval("eth3d", scene_dir, run_pipeline=True)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["eval", "--dataset", "eth3d", "--scene", scene_dir, "--run"])
