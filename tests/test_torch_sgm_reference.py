"""The benchmark's plain tSGM reference (``mvs_bench/references/tsgm.py``)
against the port's matcher (``sgm.match_pair_tsgm``) on the CPU.

Seeded random textured pairs of 48x64 (two levels: 24x32, then 48x64), the
right image the left moved by a disparity that varies over the rows, and
one rectified pair of a synthetic scene: the port's disparities against
the reference's, read as the benchmark reads them (``pair_off_pct``: valid
in both and more than 1/4 px apart; ``pair_xor_pct``: valid in exactly
one). Each stays under ``dtu-sgm``'s dry-run limits, and the reference
computed in bfloat16 (the configuration's control) reads over them. The
reference's parts meet the port's: the masked WZNCC volume on every cost
cell but those where a float32 rounding moves the cost by 1, the path sums
within float32 rounding, the disparity windows and the speckle filter
exactly."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from mvs_bench.references import tsgm
from openmvs_tpu_torch.ops import sgm

torch.set_num_threads(2)

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "mvs_bench" / "configs"
                     / "dtu-sgm.json").read_text())
DRY = CONFIG["dry_run"]["limits"]
PARAMS = tsgm.params(CONFIG)
TOL = 1.0 / PARAMS.steps


def _pair(seed, H=48, W=64, d0=-9):
    """A smooth random texture and the same texture seen d0 + (row / 16)
    columns further along, float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    big = gaussian_filter(rng.uniform(0, 1, (H, W + 32)), 1.1).astype(np.float32)
    left = big[:, 16:16 + W].copy()
    right = np.stack([big[y, 16 - d0 - y // 16:16 - d0 - y // 16 + W] for y in range(H)])
    return left, right.astype(np.float32), d0 - 4, d0 + H // 16 + 4


def _port(left, right, d_lo, d_hi):
    return sgm.match_pair_tsgm(left, right, d_lo, d_hi, p1=PARAMS.p1, p2=PARAMS.p2,
                               alpha=PARAMS.alpha, beta=PARAMS.beta, device="cpu")[0]


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_port_meets_the_reference_on_random_pairs(seed):
    left, right, d_lo, d_hi = _pair(seed)
    got = _port(left, right, d_lo, d_hi)
    want = tsgm.match_pair(left, right, d_lo, d_hi, PARAMS, "cpu")
    assert np.isfinite(want).mean() > 0.5
    r = tsgm.pair_readings([(got, want)], TOL)
    assert r["pair_off_pct"] <= DRY["pair_off_pct"] and r["pair_xor_pct"] <= DRY["pair_xor_pct"], r


@pytest.mark.parametrize("seed", [11, 12])
def test_the_bfloat16_control_reads_over_the_limits(seed):
    left, right, d_lo, d_hi = _pair(seed)
    want = tsgm.match_pair(left, right, d_lo, d_hi, PARAMS, "cpu")
    low = tsgm.match_pair(left, right, d_lo, d_hi, PARAMS, "cpu", torch.bfloat16)
    r = tsgm.pair_readings([(low, want)], TOL)
    assert r["pair_off_pct"] > 2 * CONFIG["limits"]["pair_off_pct"], r
    assert r["pair_off_pct"] > DRY["pair_off_pct"], r


@pytest.fixture(scope="module")
def scene_pair():
    """Views 0 and 1 of a 72x96 synthetic scene, rectified by the port, with
    the sparse seeds' range."""
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.convert import scene_from_arrays
    from openmvs_tpu_torch.densify import _sgm_pair_range
    from openmvs_tpu_torch.synthetic import build_gt_scene

    arrays = build_gt_scene(n_views=3, W=96, H=72)[2]
    scene = scene_from_arrays(**arrays)
    camA, camB = (im.working_camera() for im in scene.images[:2])
    rectA, rectB, info = sgm.rectify_pair(camA, camB, scene.images[0].gray,
                                          scene.images[1].gray)
    d_lo, d_hi = _sgm_pair_range(np.asarray(arrays["points"], np.float64), info, camA,
                                 camB, DenseOptions())
    return rectA, rectB, d_lo, d_hi


def test_port_meets_the_reference_on_a_scene_pair(scene_pair):
    got = _port(*scene_pair)
    want = tsgm.match_pair(*scene_pair, PARAMS, "cpu")
    r = tsgm.pair_readings([(got, want)], TOL)
    assert np.isfinite(got).mean() > 0.3
    assert r["pair_off_pct"] <= DRY["pair_off_pct"] and r["pair_xor_pct"] <= DRY["pair_xor_pct"], r


@pytest.mark.parametrize("d_min,num_d", [(-12, 16), (0, 16), (5, 32), (-40, 64)])
def test_the_masked_volume_meets_the_port(d_min, num_d):
    left, right, _, _ = _pair(3, 24, 40)
    rng = np.random.default_rng(num_d)
    lo = rng.integers(d_min - 2, d_min + num_d, (24, 40))
    hi = lo + rng.integers(1, num_d, (24, 40))
    L, R = torch.from_numpy(left), torch.from_numpy(right)
    w, tw, sum_w, n0 = sgm.wzncc_weights(L[None])
    port = sgm.wzncc_volume_masked(w, tw, sum_w, n0, R[None],
                                   torch.tensor([d_min], dtype=torch.int32), num_d,
                                   torch.from_numpy(lo[None].astype(np.int16)),
                                   torch.from_numpy(hi[None].astype(np.int16)))[0].float()
    ref = tsgm._volume(L, R, d_min, num_d, torch.from_numpy(lo), torch.from_numpy(hi),
                       torch.float32)
    diff = (port - ref).abs()
    assert float(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3


def test_path_sums_meet_the_port():
    left, right, _, _ = _pair(5, 24, 32)
    rng = np.random.default_rng(5)
    cost = torch.from_numpy(rng.integers(0, 256, (2, 24, 32, 16)).astype(np.uint8))
    imgs = torch.from_numpy(np.stack([left, right]))
    port = sgm.aggregate8(cost, imgs, PARAMS.p1, PARAMS.p2, PARAMS.alpha, 8, PARAMS.beta)
    ref = tsgm.aggregate(cost.float(), imgs, PARAMS)
    assert torch.allclose(port, ref, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("first_up", [True, False])
def test_windows_equal_the_port(first_up):
    rng = np.random.default_rng(7)
    prior = np.round(gaussian_filter(rng.normal(0, 4, (30, 40)), 3) * 6 - 40).astype(np.float32)
    prior[rng.uniform(size=prior.shape) < 0.3] = np.nan
    prior[5:20, 10:30] = np.nan  # an invalid hole: the 41x41 windows and the band
    mnd, mnd_i = (11, 33) if first_up else (5, 7)
    fb = (-70, -10)
    lo, hi = sgm.disparity_range_map(prior, (60, 80), mnd, mnd_i, global_range=fb)
    rlo, rhi = tsgm._windows(torch.from_numpy(prior), (60, 80), mnd, *fb)
    assert np.array_equal(rlo.numpy(), lo.astype(np.int32))
    assert np.array_equal(rhi.numpy(), hi.astype(np.int32))
    moved = tsgm._moved(torch.from_numpy(prior)).numpy()
    assert np.array_equal(moved, sgm._flip_disparity(prior), equal_nan=True)


def test_speckles_equal_the_port():
    rng = np.random.default_rng(9)
    disp = np.round(gaussian_filter(rng.normal(0, 20, (40, 50)), 1.5) - 30).astype(np.float32)
    disp[rng.uniform(size=disp.shape) < 0.15] = np.nan
    want = sgm._speckle_filter(disp)
    got = tsgm._speckles(torch.from_numpy(disp)).numpy()
    assert np.isnan(want).sum() > np.isnan(disp).sum()
    assert np.array_equal(got, want, equal_nan=True)
