"""The benchmark's harness: finds a cell's files by name, drives the
program's jobs, records spans, counters and kernel work from the
benchmark's own wrappers, and reads the device trace.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` under this folder; a configuration names the
module that judges its outputs, ``references/<reference>.py``, and keeps
the faults its cells can have in ``faults/<config>.py``. Adding one takes
new files and entries only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "openmvs_tpu")


# ---------------------------------------------------------------- finding


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    metrics: Dict[str, object]  # per-layer metric name -> its reader module
    reference: object  # the configuration's references/<name>.py


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load(path: Path, kind: str):
    """The module in ``path``, loaded by file name (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(f"mvs_bench_{kind}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, folder: Path = HERE / "metrics"):
    """The reader module ``metrics/<name>.py``."""
    return _load(folder / f"{name}.py", "metric")


def load_reference(name: str, folder: Path = HERE / "references"):
    """The reference module ``references/<name>.py``: ``COMPARED``, the
    readings it judges; ``prepare(cfg, device)``, what it compares
    against; ``judge(prepared, job)``, a job's readings; ``control(cfg,
    device)``, the readings of the reference below the configuration's
    precision put in the program's place; optionally ``install(probes)``,
    to keep on each job what it judges."""
    return _load(folder / f"{name}.py", "reference")


def load_faults(config: str, folder: Path = HERE / "faults") -> dict:
    """``FAULTS`` of ``faults/<config>.py``: name -> ``plant(monkeypatch)``,
    each a fault of the timed path that the configuration's cells can
    have, for the tests."""
    return _load(folder / f"{config}.py", "faults").FAULTS


def _reference(config: dict, folder: Path):
    """The configuration's reference, which must compare every reading that
    its limits hold."""
    if "reference" not in config:
        raise ValueError(f"configs/{config['name']}.json names no reference")
    mod = load_reference(config["reference"], folder / "references")
    for where, limits in (("limits", config["limits"]),
                          ("dry_run.limits", config["dry_run"]["limits"])):
        extra = sorted(set(limits) - set(mod.COMPARED))
        if extra:
            raise ValueError(f"configs/{config['name']}.json: {where} {extra} are not "
                             f"compared by references/{config['reference']}.py")
    return mod


def resolve(name: str, bench: Optional[dict] = None, folder: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, its
    configuration's reference, traffic and per-layer readers, each found by
    file name."""
    bench = bench or load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    with open(folder / "configs" / f"{w['config']}.json") as f:
        config = json.load(f)
    with open(folder / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    metrics = {m["name"]: load_metric(m["name"], folder / "metrics") for m in per_layer}
    for m in per_layer:
        mod = metrics[m["name"]]
        for key, attr in (("unit", "UNIT"), ("layer", "LAYER"), ("moves", "MOVES")):
            if getattr(mod, attr) != m[key]:
                raise ValueError(f"metrics/{m['name']}.py: {attr} {getattr(mod, attr)!r} "
                                 f"!= BENCHMARK.json's {m[key]!r}")
    return Cell(w, config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)], per_layer, metrics,
                _reference(config, folder))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------- records


@dataclasses.dataclass
class Job:
    """One whole job: its wall seconds, the maps it produced, the spans of
    the program's stages and what the wrappers counted in it."""

    seconds: float = 0.0
    n_maps: int = 0
    maps: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    points: Optional[np.ndarray] = None
    spans: List[tuple] = dataclasses.field(default_factory=list)  # (label, t0, t1)
    capture_s: float = 0.0
    captures: int = 0
    work: List[tuple] = dataclasses.field(default_factory=list)  # (family, bytes, fp32, fp64)
    device: Optional[dict] = None  # from the trace, for the profiled job
    kept: dict = dataclasses.field(default_factory=dict)  # by the reference's install
    error: Optional[str] = None

    def span_s(self, *prefixes: str) -> float:
        return sum(t1 - t0 for label, t0, t1 in self.spans if label.startswith(prefixes))


class Probes:
    """The benchmark's wrappers around the program's functions, installed
    for the run: the stage spans (``densify.timed``), the filtered maps
    (``densify._filter_views``), the graph runners of each call
    (``graphs.Runners``); a per-layer reader's own ``install(probes)`` adds
    more through ``patch`` and ``record`` (the shapes of each kernel call,
    recorded through ``pm_kernel.host_effect``, so a call captured in a
    CUDA graph counts at each replay). They add no span inside the
    program."""

    def __init__(self):
        self.job: Optional[Job] = None
        self.profiling = False
        self._undo = []

    def patch(self, mod, name, new):
        old = getattr(mod, name)
        setattr(mod, name, new)
        self._undo.append((mod, name, old))

    def install(self):
        from openmvs_tpu_torch import densify
        from openmvs_tpu_torch.ops import graphs

        probes = self
        timed = densify.timed

        @contextlib.contextmanager
        def spanned(log, label):
            import torch

            t0 = time.perf_counter()
            rf = (torch.profiler.record_function(label) if probes.profiling
                  else contextlib.nullcontext())
            try:
                with rf, timed(log, label):
                    yield
            finally:
                if probes.job is not None:
                    probes.job.spans.append((label, t0, time.perf_counter()))

        self.patch(densify, "timed", spanned)

        filt = densify._filter_views

        def filtered(results, resumed, opts):
            out = filt(results, resumed, opts)
            if probes.job is not None:
                # fusion zeroes the pixels it merged: keep copies
                probes.job.maps = {r.image_idx: np.array(r.depth) for r in out.values()}
            return out

        self.patch(densify, "_filter_views", filtered)

        base = graphs.Runners
        made = []

        class Recorded(base):
            def __init__(self):
                super().__init__()
                made.append(self)

        self.patch(graphs, "Runners", Recorded)
        self._runners = made

    def record(self, family, counts):
        """Add ``(family,) + counts`` to the current job's work, now or, for
        a call being captured in a CUDA graph, at each replay."""
        from openmvs_tpu_torch.ops import pm_kernel

        def add():
            if self.job is not None:
                self.job.work.append((family,) + tuple(counts))

        pm_kernel.host_effect(add)

    def end_job(self):
        """Move the finished job's runner counters into it and let the
        runners go."""
        runners = [r for rs in self._runners for r in rs.all()]
        if self.job is not None:
            self.job.captures = sum(r.captures for r in runners)
            self.job.capture_s = sum(r.capture_s for r in runners)
        # the list holds the runners' graphs: drop them with the job
        self._runners.clear()

    def uninstall(self):
        for mod, name, old in reversed(self._undo):
            setattr(mod, name, old)
        self._undo.clear()


# ---------------------------------------------------------------- the trace


def _union(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


JOB_SPAN = "mvs_bench.job"


def device_summary(prof, labels) -> dict:
    """From a torch.profiler run over one job (the host range ``JOB_SPAN``):
    seconds the device was busy inside the job (the union of its
    operations' spans), the job's length, its operations' seconds by name,
    and the idle seconds inside the job by the innermost stage span
    (``labels``) they fall in."""
    from torch.autograd import DeviceType

    dev, spans = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name not in labels:
                dev.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name in labels:
            spans.append((e.name, e.time_range.start, e.time_range.end))
    job = [s for s in spans if s[0] == JOB_SPAN]
    t_start_us, t_end_us = job[0][1], job[0][2]
    by_name: Dict[str, float] = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    busy = _union([(max(a, t_start_us), min(b, t_end_us)) for _, a, b in dev
                   if b > t_start_us and a < t_end_us])
    busy_s = sum(b - a for a, b in busy) / 1e6
    # idle time inside the job, cut at the stage spans' ends and named by
    # the innermost span around each piece
    stages = [sp for sp in spans if sp[0] != JOB_SPAN]
    cuts = sorted({t for sp in stages for t in sp[1:]})
    edges = [t_start_us] + [x for iv in busy for x in iv] + [t_end_us]
    idle: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        points = [a] + [t for t in cuts if a < t < b] + [b]
        for lo, hi in zip(points, points[1:]):
            mid = 0.5 * (lo + hi)
            inner = [sp for sp in stages if sp[1] <= mid <= sp[2]]
            name = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "between stages"
            idle[name] = idle.get(name, 0.0) + (hi - lo) / 1e6
    return {"busy_s": busy_s, "window_s": (t_end_us - t_start_us) / 1e6,
            "by_name": by_name, "idle_by_span": idle}


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the window's timed jobs (those not
    profiled; the profiled one when it was the only job) and the profiled
    job with its device summary (None without a trace)."""

    jobs: List[Job]
    profiled: Optional[Job] = None

    @property
    def maps(self) -> int:
        return sum(j.n_maps for j in self.jobs)


# ---------------------------------------------------------------- the run


def build_scene(arrays):
    """The program's Scene from the benchmark's arrays (cameras at the maps'
    resolution, identity rotations)."""
    from openmvs_tpu_torch.convert import scene_from_arrays

    n = arrays.n_views
    return scene_from_arrays(arrays.grays, [arrays.K] * n, [np.eye(3)] * n, arrays.Cs,
                             arrays.points, arrays.point_views, colors=arrays.colors)


def options(cfg: dict):
    from openmvs_tpu_torch.config import DenseOptions

    return DenseOptions(**cfg["options"])


def run_job(arrays, opts, device, traffic: dict, probes: Probes, job: Job) -> Job:
    """One whole job of the traffic mix: the scene handed to the program and
    ``dense_reconstruction`` run on it to the fused cloud."""
    from openmvs_tpu_torch import densify

    probes.job = job
    t0 = time.perf_counter()
    try:
        scene = build_scene(arrays)
        pc = densify.dense_reconstruction(scene, opts, device=device,
                                          fusion_mode=traffic["fusion_mode"])
        if str(device).startswith("cuda"):
            import torch
            torch.cuda.synchronize()
        job.seconds = time.perf_counter() - t0
        job.points = np.asarray(pc.points, np.float32)
        job.n_maps = len(job.maps)
    finally:
        probes.end_job()
        probes.job = None
        # a call's graph programs and their runner may hold each other, so
        # the call's graph pools outlive it until the cycle collector runs:
        # collect them before the next job (outside the job's seconds, inside
        # the window's)
        gc.collect()
    return job
