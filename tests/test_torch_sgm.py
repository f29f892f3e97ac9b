"""The SGM estimator's components (``openmvs_tpu_torch/ops/sgm.py``,
``io/dimap.py``) against the JAX package's on the CPU: the same seeded
numpy inputs go through both.

Exact: census and popcount, the census and float ZNCC volumes' border
columns and the census volume itself, XLA's exp, the WZNCC weights,
``mask_volume``, every DP pass and ``aggregate``/``aggregate8`` on a shared
volume, extraction, the host helpers and the ``.dimap`` bytes. Stated
tolerances: the float ZNCC volume within 2e-6 and the WZNCC volume on at
least 99.99% of its entries and within 1 elsewhere; their only rounding
that differs is rsqrt, which XLA's CPU backend refines from the CPU's
hardware estimate and the port rounds correctly. The behavioural checks of
``tests/test_sgm.py`` run on the port as cases of one test."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from openmvs_tpu.io import dimap as jdimap
from openmvs_tpu.ops import sgm as jsgm
from openmvs_tpu_torch.io import dimap as tdimap
from openmvs_tpu_torch.ops import sgm as tsgm
from openmvs_tpu_torch.utils.fmath import exp_xla

torch.set_num_threads(2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _pair(H=40, W=56, shift=6, seed=0):
    """A smooth textured pair, the right image the left moved ``shift``
    columns."""
    rng = np.random.default_rng(seed)
    big = gaussian_filter(rng.uniform(0, 1, (H, W + 64)).astype(np.float32), 1.2)
    return big[:, 20:20 + W].copy(), big[:, 20 + shift:20 + shift + W].copy()


def test_exp_xla_equals_jitted_jnp_exp():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-90, 90, 200_000), rng.uniform(-25, 0, 100_000),
                        [0.0, -0.0, -87.8, -88.0, 88.7, 100.0, -100.0]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = exp_xla(_t(x)).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("window", [5, 7])
def test_census_transform_exact(window):
    img = np.random.default_rng(1).uniform(0, 1, (23, 31)).astype(np.float32)
    img[5:9, 5:9] = 0.5                      # ties compare false, as in JAX
    want = np.asarray(jsgm.census_transform(jnp.asarray(img), window)).astype(np.int64)
    got = tsgm.census_transform(_t(img), window).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


def test_popcount32_exact_on_int32_and_int64():
    x = np.random.default_rng(2).integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    want = np.asarray(jsgm._popcount32(jnp.asarray(x))).astype(np.int64)
    assert np.array_equal(tsgm._popcount32(_t(x.astype(np.int64))).numpy(), want)
    assert np.array_equal(tsgm._popcount32(_t(x.view(np.int32))).numpy(), want)


@pytest.mark.parametrize("d_min", [-6, 2])
def test_census_cost_volume_exact(d_min):
    left, right = _pair(seed=3)
    want = np.asarray(jsgm.census_cost_volume(jnp.asarray(left), jnp.asarray(right), d_min, 12))
    got = tsgm.census_cost_volume(_t(left), _t(right), d_min, 12).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("d_min", [-9, 3])
def test_zncc_cost_volume(d_min):
    left, right = _pair(seed=4)
    want = np.asarray(jsgm.zncc_cost_volume(jnp.asarray(left), jnp.asarray(right), d_min, 10))
    got = tsgm.zncc_cost_volume(_t(left), _t(right), d_min, 10).numpy()
    border = want == 2.0
    assert np.array_equal(got == 2.0, border)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_wzncc_weights_exact():
    img = np.random.default_rng(5).uniform(0, 1, (21, 33)).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(jsgm.wzncc_weights)(jnp.asarray(img))]
    got = [a.numpy() for a in tsgm.wzncc_weights(_t(img))]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


@pytest.mark.parametrize("H,W,shift,d_min,num_d", [
    (30, 40, 6, -12, 16), (24, 50, -3, 3, 32), (60, 80, 9, -40, 64)])
def test_wzncc_cost_volume(H, W, shift, d_min, num_d):
    left, right = _pair(H, W, shift, seed=6)
    want = np.asarray(jsgm.wzncc_cost_volume(left, right, d_min, num_d))
    got = tsgm.wzncc_cost_volume(_t(left), _t(right), d_min, num_d).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got == want).mean() >= 0.9999
    assert np.abs(got.astype(int) - want).max() <= 1


def test_wzncc_batched_volumes_equal_single():
    left, right = _pair(seed=7)
    a = tsgm.wzncc_cost_volume(_t(left), _t(right), -4, 16)
    b = tsgm.wzncc_cost_volume(_t(right), _t(left), -11, 16)
    imgs = _t(np.stack([left, right]))
    rights = torch.stack([tsgm._shift_right(imgs[1], -4), tsgm._shift_right(imgs[0], -11)])
    both = tsgm._wzncc_volumes(imgs, rights, [-4, -11], 16)
    assert torch.equal(both[0], a) and torch.equal(both[1], b)


def test_mask_volume_exact():
    rng = np.random.default_rng(8)
    vol = rng.integers(0, 256, (12, 14, 20), dtype=np.uint8)
    lo = rng.integers(-8, 6, (12, 14)).astype(np.int16)
    hi = (lo + rng.integers(0, 12, (12, 14))).astype(np.int16)
    want = np.asarray(jsgm.mask_volume(jnp.asarray(vol), jnp.asarray(lo), jnp.asarray(hi), -5))
    got = tsgm.mask_volume(_t(vol), _t(lo), _t(hi), -5).numpy()
    assert np.array_equal(got, want)


def _volume_case(H=36, W=48, num_d=24):
    left, right = _pair(H, W, 7, seed=9)
    vol = np.asarray(jsgm.wzncc_cost_volume(left, right, -14, num_d))
    return vol, left


@pytest.mark.parametrize("axis,reverse", [(0, False), (0, True), (1, False), (1, True)])
def test_dp_pass_equals_jax(axis, reverse):
    vol, _ = _volume_case()
    cost = vol.astype(np.float32)
    g = np.abs(np.random.default_rng(10).normal(0, 0.2, cost.shape[:2])).astype(np.float32)
    want = np.asarray(jax.jit(lambda c, g: jsgm._dp_pass(
        c, g, 3.0, 4.0, 14.0, axis, reverse, 0.2))(cost, g))
    got = tsgm._dp_pass(_t(cost), _t(g), 3.0, 4.0, 14.0, axis, reverse, 0.2).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dx,reverse", [(1, False), (1, True), (-1, False), (-1, True)])
def test_dp_pass_diag_equals_jax(dx, reverse):
    vol, _ = _volume_case()
    cost = vol.astype(np.float32)
    g = np.abs(np.random.default_rng(11).normal(0, 0.2, cost.shape[:2])).astype(np.float32)
    want = np.asarray(jax.jit(lambda c, g: jsgm._dp_pass_diag(
        c, g, 3.0, 4.0, 14.0, dx, reverse))(cost, g))
    got = tsgm._dp_pass_diag(_t(cost), _t(g), 3.0, 4.0, 14.0, dx, reverse).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("num_dirs,num_d", [
    pytest.param(8, 24, id="8"), pytest.param(4, 24, id="4"),
    pytest.param(8, 1, id="8-d1"), pytest.param(4, 1, id="4-d1"),
    pytest.param(8, 33, id="8-d33"), pytest.param(4, 33, id="4-d33")])
def test_aggregate8_equals_jax_on_a_shared_volume(num_dirs, num_d):
    """On the CPU the scans are ``_scan_passes_plain``; D = 1 and 33 are
    the card kernel's edge cases (one lane, one warp and one lane more)."""
    vol, left = _volume_case(num_d=num_d)
    want = np.asarray(jsgm.aggregate8(jnp.asarray(vol), jnp.asarray(left), 3.0, 4.0, 14.0,
                                      num_dirs, 38.0 / 255.0))
    got = tsgm.aggregate8(_t(vol), _t(left), 3.0, 4.0, 14.0, num_dirs, 38.0 / 255.0)
    assert np.array_equal(got.numpy(), want)
    # a batch of two volumes aggregates as the two alone
    both = tsgm.aggregate8(torch.stack([_t(vol), _t(vol[::-1])]),
                           torch.stack([_t(left), _t(left[::-1])]), 3.0, 4.0, 14.0,
                           num_dirs, 38.0 / 255.0)
    assert torch.equal(both[0], got)
    assert torch.equal(both[1], tsgm.aggregate8(_t(vol[::-1]), _t(left[::-1]), 3.0, 4.0,
                                                14.0, num_dirs, 38.0 / 255.0))


def test_aggregate_and_extraction_equal_jax():
    vol, left = _volume_case()
    cost = vol.astype(np.float32) / 255.0
    agg_j = jsgm.aggregate(jnp.asarray(cost), jnp.asarray(left), p1=0.1, p2=0.8, alpha=2.0)
    agg_p = tsgm.aggregate(_t(cost), _t(left), p1=0.1, p2=0.8, alpha=2.0)
    assert np.array_equal(agg_p.numpy(), np.asarray(agg_j))
    dj, cj = jsgm.extract_disparity(agg_j, -14)
    dp, cp = tsgm.extract_disparity(agg_p, -14)
    assert np.array_equal(dp.numpy(), np.asarray(dj)) and np.array_equal(cp.numpy(), np.asarray(cj))
    dr = -np.asarray(dj)[:, ::-1].copy()
    want = np.asarray(jsgm.lr_consistency(dj, jnp.asarray(dr)))
    got = tsgm.lr_consistency(dp, _t(dr)).numpy()
    assert np.array_equal(got, want, equal_nan=True)


def test_argmin_first_index_on_ties():
    agg = np.random.default_rng(12).integers(0, 4, (30, 40, 17)).astype(np.float32)
    idx, mn = tsgm._argmin_first(_t(agg))
    assert np.array_equal(idx.numpy(), np.argmin(agg, axis=-1))
    assert np.array_equal(mn.numpy(), agg.min(-1))


def _prior(shape=(20, 24), seed=13):
    rng = np.random.default_rng(seed)
    d = (rng.uniform(-20, -5, shape)).astype(np.float32)
    d[rng.random(shape) < 0.3] = np.nan
    d[3:9, 4:12] = np.nan
    return d


def _pair_maps(P=4, shape=(10, 12), seed=14):
    rng = np.random.default_rng(seed)
    maps = []
    for _ in range(P):
        z = (5 + rng.normal(0, 0.05, shape)).astype(np.float32)
        z[rng.random(shape) < 0.2] = 0
        maps.append((z, z - 0.04, z + 0.04, rng.uniform(0, 1, shape).astype(np.float32)))
    return maps


def _info_case():
    from openmvs_tpu_torch.geometry.camera import Camera

    K = np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]])
    camA = Camera(K, np.eye(3), np.zeros(3))
    camB = Camera(K, np.eye(3), np.array([0.4, 0.05, 0.0]))
    g = np.random.default_rng(15).uniform(0, 1, (60, 80)).astype(np.float32)
    _, _, info = tsgm.rectify_pair(camA, camB, g, g)
    disp = np.random.default_rng(16).uniform(-12, -2, (60, 80)).astype(np.float32)
    disp[::7] = np.nan
    cost = np.random.default_rng(17).uniform(0, 400, (60, 80)).astype(np.float32)
    return camA, info, disp, cost


_HOST_HELPERS = {
    "disparity_range_map": lambda m: m.disparity_range_map(_prior(), (40, 48)),
    "disparity_range_map_global": lambda m: m.disparity_range_map(
        _prior(), (41, 47), 11, 33, global_range=(-30, -2)),
    "flip_disparity": lambda m: m._flip_disparity(_prior()),
    "fuse_pair_depths": lambda m: m.fuse_pair_depths(_pair_maps(), 2),
    "disparity_to_depth": lambda m: m.disparity_to_depth(_prior(), _info_case()[1]),
    "project_disparity_to_depth": lambda m: (lambda cam, info, disp, cost: (
        m.project_disparity_to_depth(disp, cost, info, cam, (60, 80))))(*_info_case()),
    **{f"refine_subpixel_{mode}": (lambda mode: lambda m: m.refine_subpixel(
        np.random.default_rng(18).integers(0, 9, (12, 16, 10)).astype(np.float32),
        np.random.default_rng(19).integers(-3, 8, (12, 16)), -3, mode))(mode)
       for mode in ("linear", "poly4", "parabola", "sine", "cosine", "lc_blend", "na")},
}


@pytest.mark.parametrize("name", sorted(_HOST_HELPERS))
def test_host_helper_equals_jax(name):
    want = _HOST_HELPERS[name](jsgm)
    got = _HOST_HELPERS[name](tsgm)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True)


@pytest.mark.parametrize("max_size,max_diff", [(100, 5.0), (3, 0.5), (0, 5.0)])
def test_speckle_filter_equals_jax(max_size, max_diff):
    rng = np.random.default_rng(20)
    d = np.round(rng.uniform(-30, -5, (48, 64)) * 2) / 2
    d[rng.random(d.shape) < 0.3] = np.nan
    d[10:30, 10:40] = -12.25
    d = d.astype(np.float32)
    want = jsgm._speckle_filter(d, max_size, max_diff)
    got = tsgm._speckle_filter(d, max_size, max_diff)
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("cost", [True, False])
def test_dimap_save_bytes_equal_and_load_reads_jax_files(tmp_path, cost):
    rng = np.random.default_rng(21)
    disp = rng.uniform(-40, 3, (13, 17)).astype(np.float32)
    disp[rng.random(disp.shape) < 0.2] = np.nan
    kw = dict(disparity=disp, image_width=34, image_height=26,
              H=rng.normal(size=(3, 3)), Q=rng.normal(size=(4, 4)), subpixel_steps=4,
              cost=rng.integers(0, 65535, (13, 17)).astype(np.uint16) if cost else None)
    jdimap.save(jdimap.DisparityData(**kw), tmp_path / "j.dimap")
    tdimap.save(tdimap.DisparityData(**kw), tmp_path / "t.dimap")
    assert (tmp_path / "j.dimap").read_bytes() == (tmp_path / "t.dimap").read_bytes()
    want, got = jdimap.load(tmp_path / "j.dimap"), tdimap.load(tmp_path / "j.dimap")
    for k in ("disparity", "H", "Q", "cost"):
        a, b = getattr(want, k), getattr(got, k)
        assert (a is None and b is None) or np.array_equal(a, b, equal_nan=True)
    assert (want.image_width, want.image_height, want.subpixel_steps) == (
        got.image_width, got.image_height, got.subpixel_steps)


# ----------------------------------------------- tests/test_sgm.py on the port
def _plane():
    from test_sgm import _make_pair

    left, right, gt = _make_pair()
    disp, _ = tsgm.match_rectified(left, right, d_min=0, num_d=24, device="cpu")
    valid = np.isfinite(disp)
    valid[:, :16] = False
    assert valid.mean() > 0.6
    assert np.median(np.abs(disp - gt)[valid]) < 0.5


def _census():
    from test_sgm import _make_pair

    left, right, gt = _make_pair(seed=3)
    disp, _ = tsgm.match_rectified(left, right, d_min=0, num_d=24, cost="census",
                                   p1=1.0, p2=8.0, device="cpu")
    valid = np.isfinite(disp)
    valid[:, :16] = False
    assert np.median(np.abs(disp - gt)[valid]) < 1.0


def _monotone():
    H, W, D = 16, 32, 8
    rng = np.random.default_rng(0)
    best = rng.integers(0, D, (H, W))
    cost = np.ones((H, W, D), np.float32)
    cost[np.arange(H)[:, None], np.arange(W)[None, :], best] = 0.0
    agg = tsgm.aggregate(_t(cost * 10), torch.zeros(H, W), p1=0.01, p2=0.01)
    assert (torch.argmin(agg, -1).numpy() == best).mean() > 0.95


def _rectify_roundtrip():
    from test_sgm import _make_pair

    from openmvs_tpu_torch.geometry.camera import Camera

    H, W, f = 96, 160, 120.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    camA = Camera(K, np.eye(3), np.zeros(3))
    camB = Camera(K, np.eye(3), np.array([0.5, 0, 0.0]))
    z_true = 6.0
    left, right, _ = _make_pair(H, W, d0=f * 0.5 / z_true, slope=0.0)
    rectA, rectB, info = tsgm.rectify_pair(camA, camB, left, right)
    disp, _ = tsgm.match_rectified(rectA, rectB, d_min=0, num_d=24, device="cpu")
    z = tsgm.disparity_to_depth(disp, info)
    sel = np.isfinite(disp) & (z > 0)
    sel[:, :20] = False
    assert sel.mean() > 0.5
    assert abs(np.median(z[sel]) - z_true) / z_true < 0.05


def _wzncc_truth():
    from test_sgm import _shifted_pair

    left, right = _shifted_pair(d_true=-6.0)
    vol = tsgm.wzncc_cost_volume(_t(left), _t(right), -12, 13).numpy()
    assert np.median(vol[8:-8, 20:-20].argmin(axis=-1) - 12) == -6


def _tsgm_accuracy():
    from test_sgm import _shifted_pair

    left, right = _shifted_pair(d_true=-6.5)
    disp, _ = tsgm.match_pair_tsgm(left, right, d_lo=-16, d_hi=0, min_resolution=48,
                                   device="cpu")
    core = disp[10:-10, 20:-20]
    ok = np.isfinite(core)
    assert ok.mean() > 0.8
    assert np.median(np.abs(core[ok] + 6.5)) < 0.5


def _subpixel_modes():
    agg = np.zeros((1, 1, 5), np.float32)
    agg[0, 0] = [9, 4, 1, 4, 9]
    for mode in ("linear", "poly4", "parabola", "sine", "cosine", "lc_blend"):
        assert abs(float(tsgm.refine_subpixel(agg, np.array([[2]]), 0, mode)[0, 0]) - 2.0) < 1e-5
    agg[0, 0] = [9, 2, 1, 6, 9]
    for mode in ("linear", "parabola", "lc_blend"):
        d = float(tsgm.refine_subpixel(agg, np.array([[2]]), 0, mode)[0, 0])
        assert -0.5 <= d - 2.0 < 0.0


def _range_map():
    prior = np.full((20, 20), 5.0, np.float32)
    prior[5:8, 5:8] = np.nan
    lo, hi = tsgm.disparity_range_map(prior, (40, 40))
    assert lo[0, 0] <= 10 <= hi[0, 0] and hi[0, 0] - lo[0, 0] <= 32
    assert hi[12, 12] - lo[12, 12] >= hi[0, 0] - lo[0, 0]


def _fuse_clusters():
    mk = lambda z: (np.full((4, 4), z, np.float32), np.full((4, 4), z - 0.1, np.float32),
                    np.full((4, 4), z + 0.1, np.float32), np.full((4, 4), 0.5, np.float32))
    depth, _ = tsgm.fuse_pair_depths([mk(5.0), mk(5.05), mk(5.02), mk(9.0)], min_views=2)
    assert np.allclose(depth, (5.0 + 5.05 + 5.02) / 3, atol=1e-5)
    depth2, _ = tsgm.fuse_pair_depths([mk(5.0), mk(9.0)], min_views=2)
    assert (depth2 == 0).all()


def _degenerate_layouts():
    base = np.full((320, 240), np.nan, np.float32)
    base[:100, :80] = 3.0
    out = tsgm._speckle_filter(base.T)          # F-ordered input
    assert out.shape == (240, 320) and np.isfinite(out).sum() > 0
    for shape in [(0, 64), (64, 0), (0, 0)]:
        assert tsgm._speckle_filter(np.full(shape, np.nan, np.float32)).shape == shape
    disp, cost = tsgm.match_pair_tsgm(np.zeros((0, 64), np.float32),
                                      np.zeros((0, 64), np.float32), -16, 0, device="cpu")
    assert disp.shape == (0, 64) and cost.shape == (0, 64)


_BEHAVIOUR = {"recovers_plane": _plane, "census_cost": _census,
              "dp_pass_monotone": _monotone, "rectify_and_depth_roundtrip": _rectify_roundtrip,
              "wzncc_volume_minimum_at_truth": _wzncc_truth,
              "match_pair_tsgm_accuracy": _tsgm_accuracy, "subpixel_modes": _subpixel_modes,
              "disparity_range_map": _range_map, "fuse_pair_depths_clusters": _fuse_clusters,
              "speckle_filter_degenerate_layouts": _degenerate_layouts}


@pytest.mark.parametrize("case", sorted(_BEHAVIOUR))
def test_sgm_behaviour_on_the_port(case):
    _BEHAVIOUR[case]()


def test_sgm_entry_points_default_to_the_card():
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    left, right = _pair()
    with pytest.raises(RuntimeError, match="cuda"):
        tsgm.match_pair_tsgm(left, right, -10, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        tsgm.match_rectified(left, right, 0, 8)
    scene, _, _ = build_gt_scene(n_views=2, W=48, H=32)
    with pytest.raises(RuntimeError, match="cuda"):
        densify.estimate_depth_map_sgm(scene, 0, DenseOptions(estimator="sgm"))
    for mode, opts in ((0, DenseOptions(estimator="sgm")), (-1, DenseOptions())):
        with pytest.raises(RuntimeError, match="cuda"):
            densify.dense_reconstruction(scene, opts, save_dmaps_to=os.devnull,
                                         fusion_mode=mode)
