"""The reader ``pm.level_reuse_pct`` on the CPU: the share of level images
the program's store served again, from made-up recordings and from a
small densify job; None where the recording counts neither counter (a
program without the store) or where there is no recording."""

from types import SimpleNamespace

import pytest
import torch

from mvs_bench import harness, program_trace

READER = harness.load_metric("pm.level_reuse_pct")


def _context(*counters):
    jobs = []
    for c in counters:
        job = harness.Job(seconds=10.0, n_maps=9)
        job.recording = SimpleNamespace(counters=dict(c))
        jobs.append(job)
    return harness.Context(jobs=jobs, profiled=None)


def test_the_share_is_summed_over_the_windows_jobs():
    job = {"pm.levels_built": 27, "pm.levels_reused": 378, "pm.sweeps": 144}
    assert READER.read(_context(job, job)) == pytest.approx(100 * 756 / 810)
    assert READER.read(_context(job)) == pytest.approx(93.333, abs=1e-3)
    other = {"pm.levels_built": 9, "pm.levels_reused": 0}
    assert READER.read(_context(job, other)) == pytest.approx(100 * 378 / 414)
    assert READER.read(_context({"pm.levels_built": 5})) == 0.0


def test_none_without_the_counters_or_a_recording():
    # the program before the store: a recording without either counter
    assert READER.read(_context({"pm.sweeps": 144}, {})) is None
    no_recording = harness.Context(jobs=[harness.Job(seconds=10.0, n_maps=9)],
                                   profiled=None)
    assert READER.read(no_recording) is None
    assert READER.read(harness.Context(jobs=[], profiled=None)) is None


def test_a_densify_job_reads_its_stores_counters():
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
    counters = job.recording.counters
    # 3 images at 2 scales built once; every other request served again
    assert counters["pm.levels_built"] == 6
    reused = counters["pm.levels_reused"]
    assert reused > 6
    got = READER.read(harness.Context(jobs=[job], profiled=None))
    assert got == pytest.approx(100 * reused / (reused + 6))
