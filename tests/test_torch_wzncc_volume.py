"""The WZNCC cost-volume kernel's decomposition and wrapper
(``openmvs_tpu_torch/csrc/wzncc_volume.cu``, ``ops/sgm.wzncc_volume_masked``)
and SGM's level program (``sgm.LevelProgram``) on the CPU.

The kernel computes, for each (pair, pixel, disparity), the masked WZNCC
cost from the left images' weights and the UNSHIFTED right image, its
d_min read as data: a texel is 0 unless its row, its column and its
shifted column lie in the image; the three 49-texel sums are taken as
two in-order partial sums (texels 0-24 and 25-48) then added; the
epilogue runs the fused multiply-add and rsqrt in float64; the column
and window masks set 255. A numpy model of that decomposition equals the
plain version (``mask_volume(_wzncc_volumes(...))``, the wrapper's CPU
route) bit for bit (tolerance 0) at d_min negative, zero, positive and at
least W, num_d in {2, 16, 33}, shapes that are no multiples of 32 and a
35-texel window; it meets the JAX package's ``mask_volume(
wzncc_cost_volume(...))`` within ``tests/test_torch_sgm.py``'s stated
WZNCC tolerance (99.99% of entries equal, the rest within 1: XLA's rsqrt
refines the CPU's hardware estimate). The kernel itself runs only on the
card, where ``chip_smoke.py`` phase ``sgm`` holds it against the plain
version bit for bit at a full-width pair's level shapes.

The level program's CPU form (``match_pair_tsgm`` with ``runners``)
equals the eager levels bit for bit and the JAX package's
``match_pair_tsgm`` within the slice tests' 99.9% agreement, and a second
pair of a class reuses the class's program and buffers."""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from openmvs_tpu_torch.ops import graphs, pm_kernel, sgm

torch.set_num_threads(2)

F32 = np.float32


def _pair_images(B, H, W, seed):
    """B smooth textured (left, right) pairs, the right image the left
    moved a few columns, float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    big = gaussian_filter(rng.uniform(0, 1, (B, H, W + 16)), (0, 1.2, 1.2)).astype(F32)
    return big[:, :, 8:8 + W].copy(), big[:, :, 3:3 + W].copy()


def _windows(B, H, W, d_mins, num_d, seed):
    rng = np.random.default_rng(seed)
    lo = np.stack([rng.integers(d - 3, d + num_d, (H, W)) for d in d_mins]).astype(np.int16)
    hi = (lo + rng.integers(0, num_d, (B, H, W))).astype(np.int16)
    return lo, hi


def _kernel_model(w, tw, sum_w, norm_sq0, right, d_mins, num_d, lo, hi, half_x, half_y):
    """The kernel's decomposition in numpy: every (pixel, disparity) from
    the unshifted right image, in the kernel's order of operations."""
    T, B, H, W = w.shape
    low = (-(-T // 32) * 32 - T) // 2
    k_split = T if T <= 32 else 32 - low
    out = np.empty((B, H, W, num_d), np.uint8)
    ys = np.arange(H)[:, None]
    xs = np.arange(W)[None, :]
    eps = np.float64(F32(1e-3))
    for b in range(B):
        d_min = int(d_mins[b])
        for i in range(num_d):
            k = 0
            for dy in range(-half_y, half_y + 1):
                for dx in range(-half_x, half_x + 1):
                    yy, col = ys + dy, xs + dx + i
                    src = col + d_min
                    ok = (yy >= 0) & (yy < H) & (col >= 0) & (col < W) & (src >= 0) & (src < W)
                    t = np.where(ok, right[b][np.clip(yy, 0, H - 1), np.clip(src, 0, W - 1)],
                                 F32(0)).astype(F32)
                    wt = w[k, b] * t
                    terms = (wt, wt * t, tw[k, b] * t)
                    if k == k_split:
                        first = sums
                    sums = terms if k in (0, k_split) else tuple(
                        a + c for a, c in zip(sums, terms))
                    k += 1
            s, sq, nom = sums if k_split == T else tuple(
                a + c for a, c in zip(first, sums))
            norm_sq1 = sq - (s * s) / sum_w[b]
            v = (norm_sq0[b].astype(np.float64) * norm_sq1.astype(np.float64) + eps).astype(F32)
            v = np.maximum(v, F32(1e-12))
            ncc = nom * (1.0 / np.sqrt(v.astype(np.float64))).astype(F32)
            cost = np.where(ncc <= 0, F32(255),
                            np.rint((F32(1) - np.minimum(ncc, F32(1))) * F32(255)))
            d = i + d_min
            cost = np.where((xs + d < 0) | (xs + d >= W), F32(255), cost)
            if lo is not None:
                cost = np.where((d >= lo[b]) & (d < hi[b]), cost, F32(255))
            out[b, :, :, i] = cost.astype(np.uint8)
    return out


CASES = [  # (H, W, d_mins, num_d, half_x, half_y)
    (23, 37, (-9, 0), 2, 3, 3),
    (23, 37, (5, 40), 16, 3, 3),
    (30, 45, (-14, 37), 33, 3, 3),
    (19, 35, (-50, 3), 16, 3, 3),
    (23, 37, (-6, 2), 16, 2, 3),
]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("H,W,d_mins,num_d,half_x,half_y", CASES)
def test_kernel_model_equals_plain_volume_and_jax(H, W, d_mins, num_d, half_x, half_y,
                                                  masked):
    import jax.numpy as jnp
    from openmvs_tpu.ops import sgm as jsgm

    B = len(d_mins)
    lefts, rights = _pair_images(B, H, W, seed=H + num_d)
    lo, hi = _windows(B, H, W, d_mins, num_d, seed=W) if masked else (None, None)
    w, tw, sum_w, norm_sq0 = sgm.wzncc_weights(torch.from_numpy(lefts), half_x, half_y)
    model = _kernel_model(w.numpy(), tw.numpy(), sum_w.numpy(), norm_sq0.numpy(), rights,
                          d_mins, num_d, lo, hi, half_x, half_y)

    pm_kernel.reset_launches()
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = sgm.wzncc_volume_masked(w, tw, sum_w, norm_sq0, torch.from_numpy(rights),
                                  torch.tensor(d_mins, dtype=torch.int32), num_d, t(lo),
                                  t(hi), half_x, half_y).numpy()
    assert pm_kernel.LAUNCHES["wzncc_volume"] == 0
    assert np.array_equal(model, got)

    for b, d_min in enumerate(d_mins):
        right = torch.from_numpy(rights[b])
        plain = sgm._wzncc_volumes(torch.from_numpy(lefts[b:b + 1]),
                                   sgm._shift_right(right, d_min)[None], [d_min], num_d,
                                   half_x, half_y)[0]
        want = np.asarray(jsgm.wzncc_cost_volume(lefts[b], rights[b], d_min, num_d,
                                                 half_x, half_y))
        if masked:
            plain = sgm.mask_volume(plain, t(lo[b]), t(hi[b]), d_min)
            want = np.asarray(jsgm.mask_volume(jnp.asarray(want), jnp.asarray(lo[b]),
                                               jnp.asarray(hi[b]), d_min))
        assert np.array_equal(model[b], plain.numpy())
        assert (model[b] == want).mean() >= 0.9999
        assert np.abs(model[b].astype(int) - want).max() <= 1


def _operands(B=2, H=9, W=11, T=49):
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.uniform(0.1, 1, s).astype(F32))
    lo = torch.zeros((B, H, W), dtype=torch.int16)
    return dict(w=f(T, B, H, W), tw=f(T, B, H, W), sum_w=f(B, H, W), norm_sq0=f(B, H, W),
                rights=f(B, H, W), d_mins=torch.tensor([-3, 2], dtype=torch.int32),
                num_d=8, lo=lo, hi=lo + 4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    ops = _operands()
    bad = [
        (dict(w=ops["w"].double()), TypeError, "float32"),
        (dict(d_mins=ops["d_mins"].long()), TypeError, "int32"),
        (dict(lo=ops["lo"].int()), TypeError, "int16"),
        (dict(tw=ops["tw"][:48]), ValueError, "shape"),
        (dict(sum_w=ops["sum_w"][:, :, :-1]), ValueError, "shape"),
        (dict(rights=torch.zeros(2, 11, 9).transpose(1, 2)), ValueError, "not contiguous"),
        (dict(hi=None), ValueError, "both or neither"),
        (dict(rights=ops["rights"][0]), ValueError, "expected \\(B, H, W\\)"),
        (dict(num_d=0), ValueError, "num_d"),
    ]
    for change, err, match in bad:
        with pytest.raises(err, match=match):
            sgm.wzncc_volume_masked(**dict(ops, **change))


def test_card_route_refuses_cpu_tensors_and_counts_nothing():
    ops = _operands()
    pm_kernel.reset_launches()
    args = [ops[k] for k in ("w", "tw", "sum_w", "norm_sq0", "rights", "d_mins", "num_d",
                             "lo", "hi")]
    with pytest.raises(ValueError, match="expected cuda"):
        sgm._wzncc_volume_launch(*args, 3, 3)
    sgm.wzncc_volume_masked(**ops)
    assert pm_kernel.LAUNCHES["wzncc_volume"] == 0


def test_xla_split_matches_the_plain_sums_windows():
    for n in (1, 25, 32, 33, 35, 49, 64):
        acc = sgm._XlaSum(n)
        first = [k for k in range(n) if (acc.low + k) // 32 == 0]
        assert sgm._xla_split(n) == len(first)


@pytest.fixture(scope="module")
def rectified_pair():
    """View 0 and view 1 of a 72x96 synthetic scene, rectified, with the
    sparse seeds' disparity range."""
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
    return scene, rectA, rectB, d_lo, d_hi


def test_level_program_cpu_form_equals_eager_levels_and_jax(rectified_pair):
    from openmvs_tpu.ops import sgm as jsgm

    from _torch_helpers import disparity_agreement

    _, rectA, rectB, d_lo, d_hi = rectified_pair
    runners = graphs.Runners()
    eager_stats, prog_stats = [], []
    de, ce = sgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, device="cpu", stats=eager_stats)
    dp, cp = sgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, device="cpu", stats=prog_stats,
                                 runners=runners)
    assert np.array_equal(dp, de, equal_nan=True)
    assert np.array_equal(cp.view(np.int32), ce.view(np.int32))
    assert [lv["num_d"] for lv in prog_stats] == [lv["num_d"] for lv in eager_stats]
    assert np.isfinite(dp).mean() > 0.3

    dj, cj = jsgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi)
    assert disparity_agreement(dp, dj) >= 0.999
    assert (cp == cj).mean() >= 0.999


def test_second_pair_of_a_class_reuses_its_program(rectified_pair):
    _, rectA, rectB, d_lo, d_hi = rectified_pair
    runners = graphs.Runners()
    first = sgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, device="cpu", runners=runners)
    (runner,) = runners.all()
    progs = dict(runner._programs)
    assert len(progs) == 2 and all(isinstance(p, sgm.LevelProgram) for p in progs.values())
    ptrs = {k: [t.data_ptr() for t in p.ins + tuple(p.outs)] for k, p in progs.items()}
    again = sgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, device="cpu", runners=runners)
    assert runner._programs.keys() == progs.keys()
    for k, p in runner._programs.items():
        assert p is progs[k] and p.runs == 2 and p.graph is None
        assert [t.data_ptr() for t in p.ins + tuple(p.outs)] == ptrs[k]
    assert runner.captures == 0
    assert np.array_equal(first[0], again[0], equal_nan=True)


def test_estimate_depth_map_sgm_with_runners_equals_eager(rectified_pair):
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions

    from openmvs_tpu_torch.view_selection import select_views_for_scene

    scene = rectified_pair[0]
    opts = DenseOptions(estimator="sgm")
    select_views_for_scene(scene, opts)
    eager = densify.estimate_depth_map_sgm(scene, 0, opts, device="cpu")
    runners = graphs.Runners()
    prog = densify.estimate_depth_map_sgm(scene, 0, opts, device="cpu", runners=runners)
    assert np.array_equal(prog.depth, eager.depth) and np.array_equal(prog.conf, eager.conf)
    assert sum(p.runs for r in runners.all() for p in r._programs.values()) > 0
