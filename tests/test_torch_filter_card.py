"""The cross-view filter's kernels (``csrc/filter_splat.cu``) on the card.

Marked ``card``: each test skips without a CUDA card. This file imports no
JAX, so it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_filter_card.py -q

- The splat kernel's words and the decide kernel's maps against the plain
  twin run on the card, bit for bit, on test_torch_filter_kernel.py's cases
  in both modes; the card path (``filter_kernel.filter_views``) against the
  host NumPy filter, bit for bit where the host's BLAS rounds as the
  kernel does.
- The benchmark scene's 9 maps at 800x600, estimated on the card: the
  card's filtered depth and confidence against the host NumPy filter's on
  the same maps, equal on at least 99.99% of the pixels (the share is
  printed).
- ``dense_reconstruction`` on the card counts one ``filter.card_splats``
  per neighbour map splatted and launches one decide per view.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from openmvs_tpu_torch import densify
from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.ops import filter_kernel as fk
from openmvs_tpu_torch.utils import log

# the cases that need no JAX (test_sharded_filter.py's maps do)
CASES = ("shared_row", "ties", "behind_and_off")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip")
    return torch.device("cuda")


def _case(name):
    import test_torch_filter_kernel as cpu

    return cpu.CASES[name]()


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.card
@pytest.mark.parametrize("adjust", [True, False], ids=["adjust", "strict"])
@pytest.mark.parametrize("case", CASES)
def test_kernels_equal_the_twin_on_the_card(card, case, adjust):
    results = _case(case)
    opts = DenseOptions(filter_adjust=adjust)
    fused = fk.blas_fuses()
    for rid, r in results.items():
        h, w = r.depth.shape
        nbs = r.neighbor_ids
        stack = torch.full((len(nbs), h, w), fk.EMPTY, dtype=torch.int64, device=card)
        twin = stack.clone()
        confs = [torch.from_numpy(results[n].conf).to(card) for n in nbs]
        for j, n in enumerate(nbs):
            depth = torch.from_numpy(results[n].depth).to(card)
            cam = fk.cams(results[n].camera, r.camera)
            fk.splat(stack[j], depth, cam, fused)
            fk.splat_plain(twin[j], depth, cam, fused)
        assert torch.equal(stack, twin), f"splat words of view {rid}"
        ref = torch.from_numpy(r.depth).to(card), torch.from_numpy(r.conf).to(card)
        projected = [fk.unpack_plain(twin[j], confs[j]) for j in range(len(nbs))]
        want = torch.stack(fk.decide_plain(*ref, projected, opts, r.d_min, r.d_max))
        got = fk.decide(stack, *ref, confs, opts, r.d_min, r.d_max)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), f"decided maps of view {rid}"
        if adjust:  # the adjust decide leaves the stack clear
            assert bool((stack == fk.EMPTY).all())


@pytest.mark.card
@pytest.mark.parametrize("adjust", [True, False], ids=["adjust", "strict"])
@pytest.mark.parametrize("case", CASES)
def test_card_path_equals_the_host_filter(card, case, adjust):
    results = _case(case)
    for r in results.values():
        r.device = card
    opts = DenseOptions(filter_adjust=adjust)
    got = densify._filter_views(results, set(), opts)
    for r in results.values():
        r.device = None
    want = densify._filter_views(results, set(), opts)
    for rid in want:
        np.testing.assert_array_equal(got[rid].depth.view(np.uint32),
                                      want[rid].depth.view(np.uint32))
        np.testing.assert_array_equal(got[rid].conf.view(np.uint32),
                                      want[rid].conf.view(np.uint32))


def _bench_maps(seed):
    """The benchmark scene's maps as the card estimated them, before the
    cross-view filter, with the card's filtered maps."""
    from mvs_bench import harness, scene_gen

    cfg = copy.deepcopy(harness.resolve("dtu-pm.scene").config)
    arrays = scene_gen.make_scene(cfg, seed, "cuda")
    seen = {}
    filt = densify._filter_views

    def keep(results, resumed, opts):
        seen["in"] = {rid: dataclasses.replace(r, depth=r.depth.copy(), conf=r.conf.copy())
                      for rid, r in results.items()}
        seen["out"] = out = filt(results, resumed, opts)
        return out

    densify._filter_views = keep
    try:
        densify.dense_reconstruction(harness.build_scene(arrays), harness.options(cfg),
                                     device="cuda")
    finally:
        densify._filter_views = filt
    return seen["in"], seen["out"], harness.options(cfg)


@pytest.mark.card
def test_benchmark_scene_filters_as_the_host_does(card):
    maps, card_out, opts = _bench_maps(2147483901)
    assert len(maps) == 9 and all(r.depth.shape == (600, 800) for r in maps.values())
    assert all(torch.device(r.device).type == "cuda" for r in maps.values())
    host_in = {rid: dataclasses.replace(r, device=None) for rid, r in maps.items()}
    host_out = densify._filter_views(host_in, set(), opts)
    equal = total = 0
    for rid, h in host_out.items():
        c = card_out[rid]
        equal += int((c.depth.view(np.uint32) == h.depth.view(np.uint32)).sum())
        equal += int((c.conf.view(np.uint32) == h.conf.view(np.uint32)).sum())
        total += 2 * h.depth.size
    share = equal / total
    print(f"benchmark scene: card == host on {share:.7%} of {total} depth and conf "
          f"pixels (host BLAS fused: {fk.blas_fuses()})")
    assert share >= 0.9999, share


@pytest.mark.card
def test_dense_reconstruction_counts_card_splats(card):
    from openmvs_tpu_torch.synthetic import build_gt_scene

    scene, _, _ = build_gt_scene(n_views=3, W=64, H=48)
    opts = DenseOptions(sub_resolution_levels=1, estimation_iters=2,
                        estimation_geometric_iters=1)
    before = dict(fk.LAUNCHES)
    with log.recording() as rec:
        densify.dense_reconstruction(scene, opts, device="cuda")
    ids = {im.meta.id for im in scene.images}
    used = sum(len([v for v in im.meta.view_scores if v.id in ids]) for im in scene.images)
    names = [sp.name for sp in rec.spans]
    assert rec.counters["filter.card_splats"] == used > 0
    assert fk.LAUNCHES["filter_splat"] - before["filter_splat"] == used
    assert fk.LAUNCHES["filter_decide_adjust"] - before["filter_decide_adjust"] == 3
    assert names.count("filter.upload") == 1
    assert names.count("filter.project") == used and names.count("filter.decide") == 3
