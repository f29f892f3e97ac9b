"""The SGM scan kernel's decomposition and wrapper
(``openmvs_tpu_torch/csrc/sgm_scan.cu``, ``ops/sgm.sgm_scan``) on the CPU.

The kernel runs one warp per line: a (b, m) column walked over the steps
with ``shift`` 0, a diagonal with ``shift`` 1, which starts from the cost
at step 0 or, entering at column 0 later, from a carry of ``_BIG``. Up to
256 disparities the carry lives in registers; above, the line reads the
row it wrote at the previous step back from the output, in chunks of 32
lanes. A numpy model of each path, one line at a time in float32, equals
the plain version ``_scan_passes_plain`` bit for bit (signed zeros
included) for both shifts, both ``diag`` settings and D in {1, 7, 33, 64}
(one lane, a part of a warp, a warp and one more, two warps) and, on the
wide path, {257, 384, 512, 1000}. The kernel itself runs only on the
card, where ``chip_smoke.py`` phase ``sgm`` holds it against the plain
version at a full-width pair's shapes and at D 257, 384 and 512;
``tests/test_torch_sgm.py`` holds ``aggregate8`` and ``aggregate`` to the
JAX package's bit for bit, D in {1, 24, 33} included, and
``test_match_pair_past_256_disparities_equals_jax`` below the whole pair
at D = 512."""

import numpy as np
import pytest
import torch

from openmvs_tpu_torch.ops import _build, pm_kernel, sgm

torch.set_num_threads(2)

BIG = np.float32(1e9)


def _line_model(xs, p2s, p1, shift, diag):
    """The kernel's decomposition in numpy float32: each line alone."""
    B, N, M, D = xs.shape
    out = np.full(xs.shape, np.nan, np.float32)
    p1 = np.float32(p1)
    for b in range(B):
        for q in range(M + N - 1 if shift else M):
            t, m = 0, q
            if shift:
                t = max(0, N - 1 - q)
                m = q - (N - 1) + t
            if t == 0:
                lp = xs[b, 0, m].copy()
                out[b, 0, m] = lp
                t, m = 1, m + shift
            else:
                lp = np.full(D, BIG, np.float32)
            while t < N and m < M:
                mn = lp.min()
                best = np.minimum(lp, mn + p2s[b, t, m])
                pad = np.concatenate([[BIG], lp, [BIG]]).astype(np.float32)
                best = np.minimum(best, np.minimum(pad[:-2], pad[2:]) + p1)
                L = xs[b, t, m] + best
                if diag:
                    o = np.minimum(L - np.minimum(mn, BIG * np.float32(0.5)), BIG)
                else:
                    o = L - mn
                out[b, t, m] = o
                lp = o
                t, m = t + 1, m + shift
    return out


def _wide_line_model(xs, p2s, p1, shift, diag):
    """The kernel's path above ``_build.SGM_REG_D`` in numpy float32: each
    line's carry is the row it wrote at its previous step, read back from
    ``out`` (none, a carry of ``BIG``, for a diagonal entering at column 0
    after step 0); a step takes the minimum over the carry per lane, then
    across the 32 lanes, then the new row chunk by chunk."""
    B, N, M, D = xs.shape
    out = np.full(xs.shape, np.nan, np.float32)
    p1 = np.float32(p1)
    lanes = np.arange(32)
    for b in range(B):
        for q in range(M + N - 1 if shift else M):
            t, m = 0, q
            if shift:
                t = max(0, N - 1 - q)
                m = q - (N - 1) + t
            carry = None
            if t == 0:
                out[b, 0, m] = xs[b, 0, m]
                carry = out[b, 0, m]
                t, m = 1, m + shift
            while t < N and m < M:
                if carry is None:
                    mn = BIG
                else:
                    per_lane = np.full(32, np.inf, np.float32)
                    for d0 in range(0, D, 32):
                        d = d0 + lanes[:min(32, D - d0)]
                        per_lane[:len(d)] = np.minimum(per_lane[:len(d)], carry[d])
                    mn = per_lane.min()
                a = mn + p2s[b, t, m]
                mn_half = np.minimum(mn, BIG * np.float32(0.5))
                for d0 in range(0, D, 32):
                    d = d0 + lanes[:min(32, D - d0)]
                    if carry is None:
                        lp = lo = hi = np.full(len(d), BIG, np.float32)
                    else:
                        lp = carry[d]
                        lo = np.where(d > 0, carry[np.maximum(d - 1, 0)], BIG)
                        hi = np.where(d < D - 1, carry[np.minimum(d + 1, D - 1)], BIG)
                    best = np.minimum(np.minimum(lp, a), np.minimum(lo, hi) + p1)
                    L = xs[b, t, m, d] + best
                    out[b, t, m, d] = np.minimum(L - mn_half, BIG) if diag else L - mn
                carry = out[b, t, m]
                t, m = t + 1, m + shift
    return out


def _inputs(B, N, M, D, seed):
    """Integer costs (the uint8 volumes of aggregate8) on half the cells,
    float costs in [0, 2] (aggregate's ZNCC volumes) on the rest, and P2
    from p2_eff's range."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 256, (B, N, M, D)).astype(np.float32)
    flt = rng.uniform(0, 2, (B, N, M, D)).astype(np.float32)
    xs = np.where(rng.uniform(size=(B, N, M, 1)) < 0.5, xs, flt).astype(np.float32)
    p2s = rng.uniform(4.0, 60.0, (B, N, M)).astype(np.float32)
    return xs, p2s


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("D", [1, 7, 33, 64, 257, 384, 512, 1000])
@pytest.mark.parametrize("shift,diag", [(0, False), (0, True), (1, False), (1, True)])
def test_line_model_equals_plain_scan(shift, diag, D):
    wide = D > _build.SGM_REG_D
    model = _wide_line_model if wide else _line_model
    shapes = [(9, 12), (5, 3), (1, 6)] if wide else [(24, 32), (9, 5), (1, 6)]
    for seed, (N, M) in enumerate(shapes):
        xs, p2s = _inputs(2, N, M, D, 100 * D + seed)
        want = sgm._scan_passes_plain(torch.from_numpy(xs), torch.from_numpy(p2s), 3.0,
                                      shift, diag).numpy()
        got = model(xs, p2s, 3.0, shift, diag)
        assert np.array_equal(_bits(got), _bits(want)), (N, M)


def test_scan_passes_on_the_cpu_is_the_plain_loop_without_a_launch():
    xs, p2s = _inputs(2, 11, 13, 9, 5)
    x = torch.from_numpy(xs).transpose(1, 2)               # not contiguous
    p = torch.from_numpy(p2s).transpose(1, 2)
    pm_kernel.reset_launches()
    got = sgm._scan_passes(x, p, 1.0, 1, True)
    assert pm_kernel.LAUNCHES["sgm_scan"] == 0
    want = sgm._scan_passes_plain(x.contiguous(), p.contiguous(), 1.0, 1, True)
    assert np.array_equal(_bits(got), _bits(want))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xs, p2s = map(torch.from_numpy, _inputs(2, 6, 5, 4, 7))
    with pytest.raises(ValueError, match="not contiguous"):
        sgm.sgm_scan(xs.transpose(1, 2), p2s.transpose(1, 2), 3.0, 0, False)
    with pytest.raises(ValueError, match="not contiguous"):
        sgm.sgm_scan(xs, p2s.transpose(1, 2).contiguous().transpose(1, 2), 3.0, 0, False)
    with pytest.raises(TypeError, match="float32"):
        sgm.sgm_scan(xs.double(), p2s, 3.0, 0, False)
    with pytest.raises(TypeError, match="float32"):
        sgm.sgm_scan(xs, p2s.to(torch.float16), 3.0, 0, False)
    with pytest.raises(ValueError, match="shape"):
        sgm.sgm_scan(xs, p2s[:, :-1].contiguous(), 3.0, 0, False)
    with pytest.raises(ValueError, match="shift"):
        sgm.sgm_scan(xs, p2s, 3.0, 2, False)
    with pytest.raises(ValueError, match="3-D"):
        sgm.sgm_scan(xs[0], p2s[0], 3.0, 0, False)


def test_card_route_refuses_cpu_tensors():
    xs, p2s = map(torch.from_numpy, _inputs(1, 4, 3, 2, 8))
    pm_kernel.reset_launches()
    with pytest.raises(ValueError, match="expected cuda"):
        sgm._sgm_scan_launch(xs, p2s, 3.0, 0, False)
    assert pm_kernel.LAUNCHES["sgm_scan"] == 0


def test_match_pair_past_256_disparities_equals_jax(monkeypatch):
    """``match_pair_tsgm(max_num_d=512)`` with every level's volume 512
    deep (``OMVS_SGM_ND_LADDER=16,512``) on a 72x96 pair of the synthetic
    scene, its range widened by 150 px each way: the port's disparities and
    costs equal the JAX package's bit for bit (tolerance 0). At this depth
    the winners of both packages leave the range windows (ties of the
    diagonal passes' large sums go to the first disparity) and the
    cross-check drops every pixel, so the costs carry the comparison."""
    from openmvs_tpu.ops import sgm as jsgm

    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.convert import scene_from_arrays
    from openmvs_tpu_torch.densify import _sgm_pair_range
    from openmvs_tpu_torch.synthetic import build_gt_scene

    monkeypatch.setenv("OMVS_SGM_ND_LADDER", "16,512")
    arrays = build_gt_scene(n_views=2, W=96, H=72)[2]
    scene = scene_from_arrays(**arrays)
    camA, camB = (im.working_camera() for im in scene.images[:2])
    rectA, rectB, info = sgm.rectify_pair(camA, camB, scene.images[0].gray,
                                          scene.images[1].gray)
    d_lo, d_hi = _sgm_pair_range(np.asarray(arrays["points"], np.float64), info, camA,
                                 camB, DenseOptions())
    d_lo, d_hi = d_lo - 150, d_hi + 150
    stats = []
    dp, cp = sgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, max_num_d=512, device="cpu",
                                 stats=stats)
    dj, cj = jsgm.match_pair_tsgm(rectA, rectB, d_lo, d_hi, max_num_d=512)
    assert [lv["num_d"] for lv in stats] == [512, 512]
    assert np.array_equal(dp, dj, equal_nan=True)
    assert np.array_equal(_bits(cp), _bits(cj))
