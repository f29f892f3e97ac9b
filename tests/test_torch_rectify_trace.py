"""SGM's rectification on the card as the CPU sees it: the reader
``sgm.card_rectified_per_map`` of the counter ``sgm.card_rectifications``,
and the paths that count nothing. ``rectify_pair`` with no device or a
CPU device warps with ``io/images.warp_perspective`` and counts no card
rectification; ``rectify_kernel.warp_pair`` on CPU tensors is that host
warp and launches nothing. The card's kernel is held to the host warp by
``test_torch_rectify_card.py``."""

import importlib.util
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mvs_bench import harness
from openmvs_tpu_torch import densify
from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.io.images import warp_perspective
from openmvs_tpu_torch.ops import rectify_kernel, sgm
from openmvs_tpu_torch.synthetic import build_gt_scene
from openmvs_tpu_torch.utils import log
from openmvs_tpu_torch.view_selection import select_views_for_scene

READER = harness.load_metric("sgm.card_rectified_per_map")


def _context(counters, maps=9):
    """Two timed jobs of ``maps`` maps whose recordings hold ``counters``."""
    jobs = [harness.Job(seconds=30.0, n_maps=maps) for _ in range(2)]
    for j in jobs:
        j.recording = SimpleNamespace(counters=dict(counters), spans=[])
    return harness.Context(jobs=jobs, profiled=harness.Job(seconds=30.0, n_maps=maps))


def test_reader_counts_card_rectified_pairs_per_map():
    ctx = _context({"sgm.card_rectifications": 72, "sgm.pairs": 72})
    assert READER.read(ctx) == 8.0
    assert (READER.UNIT, READER.LAYER, READER.MOVES) == (
        "pairs/map", "SGM host steps", "depth_maps_per_s")


def test_reader_reads_zero_where_the_pairs_were_rectified_on_the_host():
    assert READER.read(_context({"sgm.pairs": 72})) == 0


def test_reader_returns_none_without_a_recording():
    jobs = [harness.Job(seconds=30.0, n_maps=9) for _ in range(2)]
    assert READER.read(harness.Context(jobs=jobs)) is None
    assert READER.read(harness.Context(jobs=[])) is None


def test_reader_returns_none_without_the_kernel_module(monkeypatch):
    find = importlib.util.find_spec

    def missing(name, *args):
        return None if name == "openmvs_tpu_torch.ops.rectify_kernel" else find(name, *args)

    monkeypatch.setattr(importlib.util, "find_spec", missing)
    assert READER.read(_context({"sgm.card_rectifications": 72})) is None


@pytest.mark.parametrize("device", [None, "cpu"], ids=["no_device", "cpu"])
def test_rectify_pair_off_the_card_warps_on_the_host_and_counts_nothing(device):
    scene, _, _ = build_gt_scene(n_views=2, W=96, H=72)
    a, b = scene.images
    before = dict(rectify_kernel.LAUNCHES)
    with log.recording() as rec:
        rectA, rectB, info = sgm.rectify_pair(a.working_camera(), b.working_camera(),
                                              a.gray, b.gray, device=device)
    assert "sgm.card_rectifications" not in rec.counters
    assert rectify_kernel.LAUNCHES == before
    assert rectA.dtype == rectB.dtype == np.float32 and isinstance(rectA, np.ndarray)
    np.testing.assert_array_equal(rectA, warp_perspective(a.gray, info["TA"], 96, 72))
    np.testing.assert_array_equal(rectB, warp_perspective(b.gray, info["TB"], 96, 72))


def test_warp_pair_on_cpu_tensors_is_the_host_warp():
    rng = np.random.default_rng(3)
    srcs = [rng.uniform(0, 1, (45, 67)).astype(np.float32) for _ in range(2)]
    Ts = [np.array([[0.9, 0.1, 3.0], [-0.05, 1.1, -2.0], [1e-3, -5e-4, 1.0]]), np.eye(3)]
    before = dict(rectify_kernel.LAUNCHES)
    got = rectify_kernel.warp_pair(*(torch.from_numpy(s) for s in srcs), *Ts, 70, 40)
    assert got.shape == (2, 40, 70) and got.dtype == torch.float32
    for k in range(2):
        np.testing.assert_array_equal(got[k].numpy(), warp_perspective(srcs[k], Ts[k], 70, 40))
    assert rectify_kernel.LAUNCHES == before


@pytest.mark.parametrize("bad,error", [
    (torch.zeros((8, 8), dtype=torch.float64), TypeError),
    (torch.zeros((2, 8, 8)), ValueError),
    (torch.zeros((8, 16))[:, ::2], ValueError),
], ids=["float64", "3d", "strided"])
def test_warp_pair_refuses_what_the_kernel_does_not_take(bad, error):
    with pytest.raises(error):
        rectify_kernel.warp_pair(torch.zeros((8, 8)), bad, np.eye(3), np.eye(3), 8, 8)


def test_sgm_view_on_the_cpu_rectifies_on_the_host():
    scene, _, _ = build_gt_scene(n_views=2, W=96, H=72)
    opts = DenseOptions(estimator="sgm")
    select_views_for_scene(scene, opts)
    with log.recording() as rec:
        densify.estimate_depth_map_sgm(scene, 0, opts, device="cpu")
    rectify = [sp for sp in rec.spans if sp.name == "sgm.rectify"]
    by_id = {sp.id: sp for sp in rec.spans}
    assert len(rectify) == rec.counters["sgm.pairs"] == 1
    assert by_id[rectify[0].parent].name == "sgm.pair"
    assert "sgm.card_rectifications" not in rec.counters
