"""Fusion's kernels (``csrc/fuse_views.cu``) on the card.

Marked ``card``: each test skips without a CUDA card. This file imports no
JAX, so it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_fusion_card.py -q -s

- The kernels' cloud against the plain twin (``fuse_views`` on the CPU)
  and against the host NumPy fusion (``fusion.fuse_depth_maps``), bit for
  bit, on test_torch_fusion_kernel.py's cases; the CPU tests hold the twin
  and the host fusion to the JAX package's.
- Maps the size of the benchmark scene's, 800x600 (``chip_smoke.
  fusion_views``): the true depths of mvs_bench/scene_gen's 3x3 grid (8
  neighbours a view) and of 13 views of its 4x4 grid (12 neighbours a
  view, ``MAX_NB``), with the surface's normals, confidences, colours and
  a tenth of the pixels dropped from a seed: kernel == twin == NumPy, bit
  for bit (the seconds of each printed).
- ``dense_reconstruction`` on the card fuses there: one ``fuse.card_views``
  a view, the kernels' launches, and the cloud the host fusion gives on the
  same maps.
"""

import time

import pytest
import torch

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.ops import fusion
from openmvs_tpu_torch.ops import fusion_kernel as fk


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip")
    return torch.device("cuda")


def _cpu():
    import test_torch_fusion_kernel as cpu

    return cpu


def _three_ways(views, opts, card, **kw):
    """(kernel, twin, host) clouds and the kernel's and host's seconds."""
    t0 = time.perf_counter()
    got = fk.fuse_views(views, opts, device=card, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    twin = fk.fuse_views(views, opts, device="cpu", **kw)
    t2 = time.perf_counter()
    host = fusion.fuse_depth_maps(views, opts, **kw)
    t3 = time.perf_counter()
    return got, twin, host, t1 - t0, t3 - t2


def _cases():
    cpu = _cpu()
    return {"seeded": lambda: cpu._views(4, 1), "six": lambda: cpu._views(6, 3),
            "ties": lambda: cpu._views(4, 5, scale=(1, 0.5)),
            "conflicts": cpu._conflict_views,
            "no_colours_or_normals": lambda: cpu._views(4, 13, normals=False, colors=False)}


@pytest.mark.card
@pytest.mark.parametrize("n_min", [2, 3])
@pytest.mark.parametrize("case", ["seeded", "six", "ties", "conflicts",
                                  "no_colours_or_normals"])
def test_kernels_equal_the_twin_and_the_host(card, case, n_min):
    cpu = _cpu()
    views = _cases()[case]()
    got, twin, host, _, _ = _three_ways(views, DenseOptions(min_views_fuse=n_min), card)
    assert len(host) > 100
    cpu._assert_same_cloud(twin, host)
    cpu._assert_same_cloud(got, host)


@pytest.mark.card
@pytest.mark.parametrize("db_val,n_points", [(2.0, 1), (0.5, 2)])
def test_invalidation_case_on_the_card(card, db_val, n_points):
    cpu = _cpu()
    views = cpu.invalidation_views(db_val)
    got, twin, host, _, _ = _three_ways(views, DenseOptions(min_views_fuse=1), card,
                                        estimate_color=False, estimate_normal=False)
    assert len(host) == n_points
    cpu._assert_same_cloud(twin, host)
    cpu._assert_same_cloud(got, host)


@pytest.mark.card
@pytest.mark.parametrize("grid,n_views", [(3, 9), (4, 13)], ids=["8_neighbours",
                                                                  "12_neighbours"])
def test_benchmark_sized_maps(card, grid, n_views):
    from chip_smoke import fusion_views

    cpu = _cpu()
    views = fusion_views(grid, n_views, 2147483901, card)
    assert all(len(v.neighbor_ids) == n_views - 1 for v in views)
    opts = DenseOptions(min_views_fuse=3)
    fk.fuse_views(views, opts, device=card)  # the build and the first launches
    got, twin, host, card_s, host_s = _three_ways(views, opts, card)
    print(f"{n_views} views at 800x600, {n_views - 1} neighbours: {len(host)} points, "
          f"card {card_s:.3f} s, host NumPy {host_s:.3f} s")
    assert len(host) > 100_000
    cpu._assert_same_cloud(twin, host)
    cpu._assert_same_cloud(got, host)


@pytest.mark.card
def test_dense_reconstruction_fuses_on_the_card(card, monkeypatch):
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.synthetic import build_gt_scene
    from openmvs_tpu_torch.utils import log

    cpu = _cpu()
    scene, _, _ = build_gt_scene(n_views=3, W=64, H=48, color=True)
    opts = DenseOptions(sub_resolution_levels=1, estimation_iters=2,
                        estimation_geometric_iters=1)
    seen = []
    fuse_views = fk.fuse_views

    def kept(views, *a, **kw):
        seen.append((views, a, kw))
        return fuse_views(views, *a, **kw)

    monkeypatch.setattr(fk, "fuse_views", kept)
    before = dict(fk.LAUNCHES)
    with log.recording() as rec:
        pc = densify.dense_reconstruction(scene, opts, device="cuda")
    assert len(seen) == 1 and len(pc) > 200
    views, a, kw = seen[0]
    kw.pop("device")
    cpu._assert_same_cloud(pc, fusion.fuse_depth_maps(views, *a, **kw))
    assert rec.counters["fuse.card_views"] == 3
    for k in ("fuse_claim", "fuse_count", "fuse_keep", "fuse_emit"):
        assert fk.LAUNCHES[k] - before[k] == 3, k
    names = [sp.name for sp in rec.spans]
    assert names.count("fuse.upload") == names.count("fuse.download") == 1
    assert names.count("fuse.neighbours") == 3
