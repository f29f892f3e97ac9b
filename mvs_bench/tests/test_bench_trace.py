"""The device summary of a profiled job, on a made-up trace: busy time is
the union of the device's operations inside the job, and idle time is cut
at the stage spans' ends and named by the innermost span around it."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from mvs_bench import harness


def _event(name, start, end, device):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_busy_and_idle_by_stage():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event(harness.JOB_SPAN, 0, 100e6, cpu),
        _event("photometric pass", 0, 40e6, cpu),
        _event("cross-view filter", 40e6, 80e6, cpu),
        _event("fuse depth maps", 80e6, 100e6, cpu),
        _event("aten::add", 1e6, 2e6, cpu),  # a host op, not a stage
        _event("kernel_a", 10e6, 20e6, cuda),
        _event("kernel_b", 15e6, 30e6, cuda),  # overlaps kernel_a
        _event("photometric pass", 10e6, 30e6, cuda),  # a range on the device
        _event("kernel_a", 120e6, 130e6, cuda),  # after the job
    ]
    prof = SimpleNamespace(events=lambda: events)
    labels = {harness.JOB_SPAN, "photometric pass", "cross-view filter", "fuse depth maps"}
    d = harness.device_summary(prof, labels)
    assert d["window_s"] == 100.0
    assert d["busy_s"] == pytest.approx(20.0)
    assert d["by_name"] == {"kernel_a": 20.0, "kernel_b": 15.0}
    assert d["idle_by_span"] == pytest.approx(
        {"photometric pass": 20.0, "cross-view filter": 40.0, "fuse depth maps": 20.0})
