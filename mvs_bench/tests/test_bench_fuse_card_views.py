"""The reader ``fuse.card_views_per_map`` on the CPU: the views fusion
fused on the card per map, from made-up recordings and from a small
densify job on the CPU (host fusion: 0); None without a recording or a map,
or where the program has no ``ops/fusion_kernel``."""

import importlib.util
from types import SimpleNamespace

import pytest
import torch

from mvs_bench import harness, program_trace

READER = harness.load_metric("fuse.card_views_per_map")


def _context(*jobs):
    out = []
    for n_maps, counters in jobs:
        job = harness.Job(seconds=10.0, n_maps=n_maps)
        job.recording = SimpleNamespace(counters=dict(counters))
        out.append(job)
    return harness.Context(jobs=out, profiled=None)


def test_the_count_is_summed_over_the_windows_jobs():
    job = (9, {"fuse.card_views": 9, "filter.card_splats": 72})
    assert READER.read(_context(job, job)) == 1.0
    assert READER.read(_context(job, (9, {}))) == 0.5
    assert READER.read(_context((9, {"filter.card_splats": 72}))) == 0.0


def test_none_without_a_recording_a_map_or_the_module(monkeypatch):
    no_recording = harness.Context(jobs=[harness.Job(seconds=10.0, n_maps=9)], profiled=None)
    assert READER.read(no_recording) is None
    assert READER.read(harness.Context(jobs=[], profiled=None)) is None
    assert READER.read(_context((0, {"fuse.card_views": 3}))) is None
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith("fusion_kernel") else find(name, *a))
    assert READER.read(_context((9, {"fuse.card_views": 9}))) is None


def test_a_densify_job_on_the_cpu_reads_zero():
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    probes = harness.Probes()
    try:
        READER.install(probes)
        scene, _, _ = build_gt_scene(n_views=3, W=48, H=32)
        job = harness.Job()
        probes.job = job
        densify.dense_reconstruction(scene, DenseOptions(
            sub_resolution_levels=1, estimation_iters=2, estimation_geometric_iters=1),
            device="cpu")
    finally:
        probes.job = None
        probes.uninstall()
        torch.set_num_threads(n)
    job.n_maps = 3
    assert program_trace.recorded([job])
    assert "fuse.card_views" not in job.recording.counters
    assert READER.read(harness.Context(jobs=[job], profiled=None)) == 0.0


@pytest.mark.card
def test_a_densify_job_on_the_card_reads_one(needs_card):
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene

    probes = harness.Probes()
    try:
        READER.install(probes)
        scene, _, _ = build_gt_scene(n_views=3, W=64, H=48)
        job = harness.Job()
        probes.job = job
        densify.dense_reconstruction(scene, DenseOptions(
            sub_resolution_levels=1, estimation_iters=2, estimation_geometric_iters=1),
            device="cuda")
    finally:
        probes.job = None
        probes.uninstall()
    job.n_maps = 3
    assert READER.read(harness.Context(jobs=[job], profiled=None)) == 1.0
