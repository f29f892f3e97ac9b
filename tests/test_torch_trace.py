"""The port's recording of spans and counters (``utils/log.py``: ``span``,
``count``, ``recording``, ``timed``) on the CPU.

- Spans nest: each knows its parent, the root span of its request and its
  thread, worker threads included; ``self_s`` takes off what the children
  cover; counters add, also from many threads at once.
- Outside a recording nothing is kept and no profiler range opens; inside
  one, under ``torch.profiler``, each span is a range of its name and
  length.
- ``dense_reconstruction`` with the recording on gives the maps and cloud
  of the run with it off, bit for bit, and the spans and counts that
  follow from the scene; no span opens inside a sweep program's body (it
  would run only at a CUDA graph's capture); ``OMVS_PROFILE_DIR``'s trace
  covers the whole call, filter and fusion included.
"""

import collections
import json
import logging
import sys
import threading
import time

import numpy as np
import pytest
import torch

from openmvs_tpu_torch import densify
from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.ops import graphs, patchmatch
from openmvs_tpu_torch.synthetic import build_gt_scene
from openmvs_tpu_torch.utils import log

torch.set_num_threads(2)

STAGES = ("select views", "photometric pass", "geometric pass", "optimize depth maps",
          "cross-view filter", "fuse depth maps")
PM = ("pm.view", "pm.seed", "pm.level", "pm.setup", "pm.init", "pm.block", "pm.sweep",
      "pm.finalize", "pm.download")
HOST = ("filter.project", "filter.decide", "fuse.prepare", "fuse.neighbours", "fuse.keep",
        "fuse.emit")


def test_spans_nest_with_parents_roots_and_threads():
    import contextvars

    both = threading.Barrier(2, timeout=30)

    def worker(k):
        with log.span("w", slot=k):
            both.wait()  # the two workers' spans are open at once
            with log.span("w.inner"):
                pass

    with log.recording() as rec:
        with log.span("req") as req:
            with log.span("a", view=3):
                with log.span("b"):
                    pass
            threads = [threading.Thread(target=contextvars.copy_context().run,
                                        args=(worker, k)) for k in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
        with log.span("other"):
            pass
    by = collections.defaultdict(list)
    for sp in rec.spans:
        by[sp.name].append(sp)
    r, a, b = by["req"][0], by["a"][0], by["b"][0]
    assert r.parent is None and r.root == r.id == req._id
    assert a.parent == r.id and b.parent == a.id and a.attrs == {"view": 3}
    assert {s.root for s in rec.spans if s.name != "other"} == {r.id}
    other = by["other"][0]
    assert other.parent is None and other.root == other.id != r.id
    ws, inner = by["w"], by["w.inner"]
    assert len(ws) == 2 and len(inner) == 2
    assert {w.parent for w in ws} == {r.id} and sorted(w.attrs["slot"] for w in ws) == [0, 1]
    assert len({w.thread for w in ws}) == 2 and r.thread not in {w.thread for w in ws}
    for i in inner:
        (w,) = [w for w in ws if w.id == i.parent]
        assert i.thread == w.thread and w.start_ns <= i.start_ns <= i.end_ns <= w.end_ns
    # both workers were inside their span at the barrier
    assert max(w.start_ns for w in ws) < min(w.end_ns for w in ws)


def test_self_seconds_subtract_the_childrens_union():
    rec = log.Recording()

    def add(name, a, b, sid, parent, thread=1):
        rec.spans.append(log.Span(name, a, b, sid, parent, 1, thread, {}))

    add("p", 0, 100, 1, None)
    add("c", 10, 30, 2, 1)
    add("c", 20, 50, 3, 1, thread=2)   # overlaps the first child
    add("c", 60, 70, 4, 1)
    add("g", 62, 68, 5, 4)             # a grandchild: not the parent's child
    add("p", 200, 210, 6, None)        # a second span of the name
    assert rec.self_s("p") == pytest.approx((100 - 40 - 10 + 10) / 1e9)
    assert rec.self_s("c") == pytest.approx((20 + 30 + 10 - 6) / 1e9)
    assert rec.self_s("g") == pytest.approx(6 / 1e9) and rec.self_s("none") == 0


def test_counters_add_from_many_threads():
    n_threads, n = 16, 500
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with log.span("s"):
                    log.count("c")
                log.count("d", 2)

        with log.recording() as rec:
            log.count("c", 3)
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    assert rec.counters == {"c": 3 + n_threads * n, "d": 2 * n_threads * n}
    assert len(rec.spans) == n_threads * n and len({s.id for s in rec.spans}) == len(rec.spans)


def test_nothing_is_kept_and_no_range_opens_without_a_recording(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with log.span("off.a", view=1):
            log.count("off.c")
            with log.span("off.b"):
                torch.ones(4).sum()
    assert opened == [] and log._active is None
    assert not [e for e in prof.events() if e.name.startswith("off.")]
    with log.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    with pytest.raises(RuntimeError, match="already active"):
        with log.recording():
            with log.recording():
                pass
    assert log._active is None


def test_spans_are_profiler_ranges_of_their_length():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with log.recording() as rec:
            with log.span("r.outer"):
                time.sleep(0.02)
                for k in range(3):
                    with log.span("r.inner", k=k):
                        time.sleep(0.01)
                        torch.ones(64).sum()
    ranges = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith("r."):
            ranges[e.name].append((e.time_range.end - e.time_range.start) / 1e6)
    spans = collections.defaultdict(list)
    for sp in rec.spans:
        spans[sp.name].append(sp.seconds)
    assert sorted(ranges) == ["r.inner", "r.outer"]
    for name in ranges:
        assert len(ranges[name]) == len(spans[name])
        for got, want in zip(sorted(ranges[name]), sorted(spans[name])):
            assert abs(got - want) < 1e-3, (name, got, want)


def test_timed_is_a_span_with_its_log_line(caplog):
    caplog.set_level(logging.INFO)
    lg = logging.getLogger("omvs_torch.trace")
    with log.recording() as rec:
        with log.timed(lg, "stage x"):
            with log.span("x.step"):
                pass
    lines = [r.getMessage() for r in caplog.records if r.name == "omvs_torch.trace"]
    assert len(lines) == 1 and lines[0].startswith("stage x (") and lines[0].endswith("s)")
    outer, = [s for s in rec.spans if s.name == "stage x"]
    step, = [s for s in rec.spans if s.name == "x.step"]
    assert step.parent == outer.id and outer.parent is None


OPTS = dict(sub_resolution_levels=1, estimation_iters=5, estimation_geometric_iters=1)


def _densify(devices=None):
    scene, _, _ = build_gt_scene(n_views=3, W=64, H=48)
    maps = {}
    filt = densify._filter_views

    def keep(results, resumed, opts):
        out = filt(results, resumed, opts)
        maps.update({rid: np.array(r.depth) for rid, r in out.items()})
        return out

    densify._filter_views = keep
    try:
        pc = densify.dense_reconstruction(scene, DenseOptions(**OPTS), device="cpu",
                                          devices=devices)
    finally:
        densify._filter_views = filt
    return pc, maps, scene


def test_densify_records_every_step_and_changes_nothing(monkeypatch):
    pc0, maps0, _ = _densify()
    parities = []
    sweep_parity = patchmatch._sweep_parity

    def counted(*a, **kw):
        parities.append(1)
        return sweep_parity(*a, **kw)

    monkeypatch.setattr(patchmatch, "_sweep_parity", counted)
    with log.recording() as rec:
        pc1, maps1, scene = _densify()
    assert sorted(maps1) == sorted(maps0)
    for rid in maps0:
        np.testing.assert_array_equal(maps1[rid], maps0[rid])
    np.testing.assert_array_equal(pc1.points, pc0.points)
    np.testing.assert_array_equal(pc1.colors, pc0.colors)

    names = collections.Counter(sp.name for sp in rec.spans)
    assert set(PM + HOST + ("densify",)) <= set(names)
    stage = [n for n in names if "." not in n and n != "densify"]
    assert sorted(stage) == sorted(n for n in names if n.startswith(STAGES))
    assert not [n for n in names if "." in n and n.startswith(STAGES)]
    (root,) = [sp for sp in rec.spans if sp.parent is None]
    assert root.name == "densify" and {sp.root for sp in rec.spans} == {root.id}
    by_id = {sp.id: sp for sp in rec.spans}

    def parent(sp):
        return by_id[sp.parent].name

    n_views, n_passes = len(maps1), 1 + OPTS["estimation_geometric_iters"]
    levels = OPTS["sub_resolution_levels"] + 1
    assert names["pm.view"] == names["pm.download"] == n_views * n_passes
    assert names["pm.level"] == n_views * (levels + OPTS["estimation_geometric_iters"])
    for name in ("pm.setup", "pm.init"):
        assert names[name] == names["pm.level"]
        assert {parent(sp) for sp in rec.spans if sp.name == name} == {"pm.level"}
    assert {parent(sp) for sp in rec.spans if sp.name in ("pm.block", "pm.sweep")} == {
        "pm.level"}
    assert {parent(sp) for sp in rec.spans if sp.name in ("pm.seed", "pm.level",
                                                           "pm.finalize")} == {"pm.view"}
    assert {parent(sp) for sp in rec.spans if sp.name == "pm.view"} == {
        n for n in names if n.startswith(("photometric pass", "geometric pass"))}
    assert sorted((sp.attrs["view"], sp.attrs["pass"]) for sp in rec.spans
                  if sp.name == "pm.view") == sorted(
        (v, p) for v in range(n_views) for p in ("photometric", "geometric 0"))
    # the sweeps counted are the sweeps run: two half-steps each
    assert rec.counters["pm.sweeps"] == len(parities) // 2 and len(parities) % 2 == 0
    # one projection per view and neighbour with a map
    used = sum(len([n for n in scene.images[r].meta.view_scores if n.id in maps1])
               for r in maps1)
    assert names["filter.project"] == used and names["filter.decide"] == n_views
    assert {parent(sp) for sp in rec.spans if sp.name.startswith("filter.")} == {
        "cross-view filter"}
    assert names["fuse.neighbours"] == names["fuse.keep"] == n_views
    assert {parent(sp) for sp in rec.spans if sp.name.startswith("fuse.")} == {
        "fuse depth maps"}
    assert "graphs.capture" not in names  # the CPU captures nothing


def test_worker_threads_record_into_the_call(monkeypatch):
    with log.recording() as rec:
        pc, maps, _ = _densify(devices=["cpu", "cpu"])
    assert len(pc) > 0
    by_id = {sp.id: sp for sp in rec.spans}
    (root,) = [sp for sp in rec.spans if sp.parent is None]
    views = [sp for sp in rec.spans if sp.name == "pm.view"]
    assert {sp.root for sp in rec.spans} == {root.id}
    passes = [sp for sp in rec.spans if sp.name.startswith(("photometric", "geometric"))]
    assert len(passes) == 2 and {by_id[sp.parent].id for sp in views} == {
        p.id for p in passes}
    for p in passes:
        # each pass deals its views to two worker threads of its own
        threads = {sp.thread for sp in views if sp.parent == p.id}
        assert len(threads) == 2 and root.thread not in threads
    assert len(maps) == 3


def test_no_span_opens_inside_a_sweep_program(monkeypatch):
    from openmvs_tpu_torch.view_selection import select_views_for_scene

    inside = []

    def watched(make):
        def make_body(*a):
            body = make(*a)

            def run():
                n = len(log._active.spans)
                body()
                inside.append(len(log._active.spans) - n)
            return run
        return make_body

    monkeypatch.setattr(graphs, "_init_body", watched(graphs._init_body))
    monkeypatch.setattr(graphs, "_sweep_body", watched(graphs._sweep_body))
    scene, _, _ = build_gt_scene(n_views=2, W=48, H=32)
    opts = DenseOptions(sub_resolution_levels=0, estimation_iters=4)
    select_views_for_scene(scene, opts)
    with log.recording() as rec:
        densify.estimate_depth_map(scene, 0, opts, device="cpu", runners=graphs.Runners())
    assert inside and set(inside) == {0}
    assert rec.counters["pm.sweeps"] == len(inside) - 1  # less the init program


def test_profile_trace_covers_the_whole_call(tmp_path, monkeypatch):
    monkeypatch.setenv("OMVS_PROFILE_DIR", str(tmp_path))
    scene, _, _ = build_gt_scene(n_views=3, W=48, H=32)
    densify.dense_reconstruction(scene, DenseOptions(
        sub_resolution_levels=0, estimation_iters=1, estimation_geometric_iters=0),
        device="cpu")
    assert log._active is None
    with open(tmp_path / "densify.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"densify", "cross-view filter", "fuse depth maps", "filter.project",
            "fuse.neighbours", "pm.view", "pm.download"} <= names
