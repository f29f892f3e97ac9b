"""The slice as a whole on the CPU: a distorted COLMAP model (the
synthetic colored scene through an OPENCV camera, written as an ETH3D
scene by ``synthetic.write_eth3d_files``: 3 JPEGs of 160x120) through
import, undistortion, densify and evaluation, in the port (``device="cpu"``)
and in the JAX package.

``import-colmap`` through both CLIs writes the same ``.mvs`` bytes and the
same undistorted JPEGs. ``datasets.run_eval(..., run_pipeline=True)`` then
imports the scene again, densifies it and scores the cloud against
``scan_clean/scan.ply``; each package's densify is wrapped to keep its
depth maps and to run the slice tests' reduced schedule (one
sub-resolution level, 4 iterations, one geometric pass). The final maps
agree on more than 98% of the pixels valid in both, pooled, and their
masks on more than 99%, and the F-scores at 1, 2, 5 and 10 cm are within
0.01 of the JAX package's.

The earlier slice tests hold 98.5% pooled, from the JAX package's
agreement with itself under a one-ulp image change on their scene
(0.990-0.993, tests/_torch_parity_floor.py). On this scene, whose
undistorted images carry black borders, that agreement is lower: 0.9817
and 0.9829 for two draws of the nudged pixels, and the port agrees with
the JAX package on 0.9829 (tests/_torch_import_floor.py). So this test
holds the floor of its own scene, 98%.
"""

import dataclasses
import os

import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("PIL")

from _torch_helpers import SLICE_OPTS, depth_agreement  # noqa: E402

from openmvs_tpu import datasets as jdatasets  # noqa: E402
from openmvs_tpu.__main__ import main as jax_main  # noqa: E402
from openmvs_tpu_torch import datasets  # noqa: E402
from openmvs_tpu_torch.__main__ import main  # noqa: E402
from openmvs_tpu_torch.io import dmap  # noqa: E402
from openmvs_tpu_torch.synthetic import write_eth3d_files  # noqa: E402

torch.set_num_threads(1)

VIEWS = 3
TOLERANCES = ("1cm", "2cm", "5cm", "10cm")


@pytest.fixture(scope="module")
def eth3d(tmp_path_factory):
    folder = tmp_path_factory.mktemp("eth3d")
    write_eth3d_files(str(folder), VIEWS, 160, 120)
    return folder


def test_import_colmap_undistorts_as_jax(eth3d, tmp_path):
    calib = str(eth3d / "dslr_calibration_jpg")
    files = []
    for who, run in (("p", main), ("j", jax_main)):
        und = tmp_path / who / "und"
        os.makedirs(und.parent)
        run(["import-colmap", calib, "-i", str(eth3d), "-o", str(tmp_path / f"{who}.mvs")])
        # both write <calibration>/undistorted: keep each package's files
        os.rename(eth3d / "dslr_calibration_jpg" / "undistorted", und)
        files.append({n: (und / n).read_bytes() for n in sorted(os.listdir(und))})
    assert (tmp_path / "p.mvs").read_bytes() == (tmp_path / "j.mvs").read_bytes()
    assert files[0] == files[1] and len(files[0]) == VIEWS


def _keep_maps(monkeypatch, module, folder):
    """Wrap ``module.dense_reconstruction`` to save its depth maps to
    ``folder`` and to run the slice tests' reduced schedule."""
    dense = module.dense_reconstruction

    def keep(scene, opts, **kw):
        opts = dataclasses.replace(opts, **SLICE_OPTS)
        return dense(scene, opts, save_dmaps_to=folder, **kw)

    monkeypatch.setattr(module, "dense_reconstruction", keep)


def test_run_eval_densifies_and_scores_as_jax(eth3d, tmp_path, monkeypatch):
    from openmvs_tpu import densify as jdensify

    from openmvs_tpu_torch import densify

    _keep_maps(monkeypatch, densify, str(tmp_path / "port"))
    _keep_maps(monkeypatch, jdensify, str(tmp_path / "jax"))
    port = datasets.run_eval("eth3d", str(eth3d), run_pipeline=True, device="cpu")
    jax = jdatasets.run_eval("eth3d", str(eth3d), run_pipeline=True)
    maps = [[dmap.load(str(tmp_path / who / f"depth{i:04d}.dmap")).depth for i in range(VIEWS)]
            for who in ("port", "jax")]
    masks, pooled, per_view = depth_agreement(*maps)
    msg = (f"mask agreement {masks}, depth agreement {pooled} (per view {per_view}); "
           f"points {port['n_est_points']} vs {jax['n_est_points']}")
    assert min(masks) > 0.99, msg
    assert pooled > 0.98, msg
    assert abs(port["n_est_points"] - jax["n_est_points"]) <= 0.02 * jax["n_est_points"], msg
    assert port["n_gt_points"] == jax["n_gt_points"]
    for tol in TOLERANCES:
        assert abs(port[f"fscore@{tol}"] - jax[f"fscore@{tol}"]) <= 0.01, (tol, msg)
    assert port["fscore@10cm"] > 0.5
