"""The readers of the program's own spans and counters
(``program_trace.py`` and the ``metrics/`` files that use it), on the CPU:
``install`` adds only the program's dotted spans to a job; the five
readers that were there read the same with them; each new reader returns
None when the program has no ``log.recording``; the device summary names
idle time by the innermost program span."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from mvs_bench import harness, program_trace

OLD = ["pm.estimate_s_per_map", "pm.capture_s_per_job", "pm.scorer_roofline_pct",
       "host.filter_fuse_s_per_map", "device.idle_pct"]
NEW = ["pm.setup_s_per_map", "pm.download_s_per_map", "pm.sweeps_per_map",
       "filter.project_s_per_map", "fuse.neighbours_s_per_map", "pm.idle_s_per_map"]
READERS = {name: harness.load_metric(name) for name in OLD + NEW}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _tiny_job(probes):
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene

    scene, _, _ = build_gt_scene(n_views=3, W=48, H=32)
    job = harness.Job()
    probes.job = job
    try:
        densify.dense_reconstruction(scene, DenseOptions(
            sub_resolution_levels=0, estimation_iters=4, estimation_geometric_iters=1),
            device="cpu")
    finally:
        probes.job = None
    return job


def test_install_adds_only_the_programs_dotted_spans():
    probes = harness.Probes()
    probes.install()  # the harness's own stage spans
    try:
        program_trace.install(probes)
        program_trace.install(probes)  # once per Probes
        job = _tiny_job(probes)
    finally:
        probes.uninstall()
    stages = [s for s in job.spans if not program_trace.dotted(s[0])]
    steps = [s for s in job.spans if program_trace.dotted(s[0])]
    assert {s[0] for s in stages} >= {"cross-view filter", "fuse depth maps"}
    assert all(" " in s[0] and "." not in s[0] for s in stages)
    rec = job.recording
    want = sorted((sp.name, sp.start_ns / 1e9, sp.end_ns / 1e9) for sp in rec.spans
                  if "." in sp.name)
    assert sorted(steps) == want and len(want) < len(rec.spans)
    names = {s[0] for s in steps}
    assert {"pm.view", "pm.setup", "pm.download", "filter.project",
            "fuse.neighbours"} <= names and "densify" not in names
    # one wrapper: each view's photometric and geometric pass once
    assert sum(1 for s in steps if s[0] == "pm.view") == 6
    assert rec.counters["pm.sweeps"] > 0


def _job(spans, **kw):
    return harness.Job(seconds=20.0, n_maps=9, spans=list(spans), **kw)


STAGE_SPANS = [("select views", 0.0, 0.1), ("photometric pass (9 views)", 0.1, 6.0),
               ("geometric pass 0 (9 views)", 6.0, 7.0), ("optimize depth maps", 7.0, 8.0),
               ("cross-view filter", 8.0, 16.0), ("fuse depth maps", 16.0, 20.0)]
STEP_SPANS = [("pm.view", 0.2, 2.0), ("pm.seed", 0.2, 0.3), ("pm.setup", 0.3, 0.5),
              ("pm.download", 2.0, 2.5), ("graphs.capture", 0.6, 0.7),
              ("filter.project", 8.0, 12.0), ("filter.decide", 12.0, 15.0),
              ("fuse.neighbours", 16.0, 19.0)]
DEVICE = {"busy_s": 2.0, "window_s": 20.0, "by_name": {"pm_score_views_x": 0.5},
          "idle_by_span": {"photometric pass (9 views)": 1.0, "pm.setup": 0.2,
                           "pm.view": 0.5, "graphs.capture": 0.1, "pm.download": 0.3,
                           "geometric pass 0 (9 views)": 0.4, "filter.project": 4.0,
                           "cross-view filter": 0.5, "between stages": 0.3}}


def _context(with_steps):
    spans = STAGE_SPANS + (STEP_SPANS if with_steps else [])
    work = [("pm", 1e9, 1e10, 0)]
    jobs = [_job(spans, captures=14, capture_s=0.8, work=work) for _ in range(2)]
    profiled = _job(spans, captures=14, capture_s=0.8, work=work, device=dict(DEVICE))
    if with_steps:
        for j in jobs + [profiled]:
            j.recording = SimpleNamespace(counters={"pm.sweeps": 90})
    return harness.Context(jobs=jobs, profiled=profiled)


def test_the_readers_that_were_there_read_the_same_with_the_programs_spans():
    before, after = _context(False), _context(True)
    for name in OLD:
        got = READERS[name].read(after)
        assert got is not None and got == READERS[name].read(before), name


def test_the_new_readers_read_the_programs_spans_and_counters():
    ctx = _context(True)
    got = {name: READERS[name].read(ctx) for name in NEW}
    assert got == pytest.approx({
        "pm.setup_s_per_map": 2 * 0.3 / 18, "pm.download_s_per_map": 2 * 0.5 / 18,
        "pm.sweeps_per_map": 2 * 90 / 18, "filter.project_s_per_map": 2 * 4.0 / 18,
        "fuse.neighbours_s_per_map": 2 * 3.0 / 18,
        "pm.idle_s_per_map": (1.0 + 0.2 + 0.5 + 0.1 + 0.3 + 0.4) / 9})


def test_the_new_readers_return_none_without_log_recording(monkeypatch):
    from openmvs_tpu_torch.utils import log

    monkeypatch.delattr(log, "recording")
    probes = harness.Probes()
    for name in NEW:
        READERS[name].install(probes)
    assert probes._undo == []  # nothing was wrapped
    job = _tiny_job(probes)
    assert not hasattr(job, "recording") and job.spans == []
    job.n_maps = 3
    profiled = harness.Job(n_maps=3, spans=list(STAGE_SPANS), device=dict(DEVICE))
    for ctx in (harness.Context(jobs=[job], profiled=profiled), _context(False)):
        for name in NEW:
            assert READERS[name].read(ctx) is None, name


def _event(name, start, end, device):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_idle_time_is_named_by_the_innermost_program_span():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event(harness.JOB_SPAN, 0, 100e6, cpu),
        _event("photometric pass (1 views)", 0, 40e6, cpu),
        _event("pm.view", 0, 30e6, cpu),
        _event("pm.setup", 0, 10e6, cpu),
        _event("graphs.capture", 22e6, 25e6, cpu),
        _event("cross-view filter", 40e6, 100e6, cpu),
        _event("filter.project", 40e6, 70e6, cpu),
        _event("kernel_a", 12e6, 20e6, cuda),
        _event("pm.view", 12e6, 20e6, cuda),  # a range on the device
    ]
    labels = {e.name for e in events if e.device_type == cpu}
    d = harness.device_summary(SimpleNamespace(events=lambda: events), labels)
    assert d["busy_s"] == pytest.approx(8.0) and d["by_name"] == {"kernel_a": 8.0}
    assert d["idle_by_span"] == pytest.approx({
        "pm.setup": 10.0, "pm.view": 2.0 + 2.0 + 5.0, "graphs.capture": 3.0,
        "photometric pass (1 views)": 10.0, "filter.project": 30.0,
        "cross-view filter": 30.0})
    job = harness.Job(n_maps=1, device=d)
    job.recording = SimpleNamespace(counters={})
    ctx = harness.Context(jobs=[], profiled=job)
    assert READERS["pm.idle_s_per_map"].read(ctx) == pytest.approx(10 + 9 + 3 + 10)
