"""Logging, scoped wall-clock timing, progress, profiling and the verbose
depth-map dumps (the reference's Log singleton, TD_TIMER scopes and
Util::Progress, libs/Common/Log.h:41, Common.h:45-71, Util.h:770; a copy
of ``openmvs_tpu/utils/log.py``).

- ``span`` names a step of the program; inside ``recording()`` each span
  is kept (name, start and end on ``time.perf_counter_ns``, parent, root,
  thread, attributes) and ``count`` adds to the recording's counters.
  While ``torch.profiler`` records too, each span is also a
  ``record_function`` range of its name, on the profiler's clock beside
  the device's operations. Outside a recording a span keeps nothing.
- ``timed`` is a ``span`` that also logs the step's seconds; under
  ``OMVS_LOG_RSS`` also the process's peak resident memory.
- ``verbosity`` reads ``OMVS_VERBOSE``/``OPENMVS_TPU_VERBOSE``; above 2
  ``dump_depth_artifacts`` writes a depth map's JET-coloured depth, normal
  and confidence PNGs (through ``io/png``, with OpenCV's ``COLORMAP_JET``
  rebuilt as ``JET``).
- ``profile_trace`` records a ``torch.profiler`` Chrome trace per tag under
  ``OMVS_PROFILE_DIR``, with the spans of a recording it opens.
- ``Progress`` logs "k/n (p%, elapsed, ETA)" lines.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import logging
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

_FORMAT = "%(asctime)s %(name)s: %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = (logging.DEBUG
                 if (os.environ.get("OPENMVS_TPU_VERBOSE")
                     or os.environ.get("OMVS_VERBOSE", "2") not in ("", "0", "1", "2"))
                 else logging.INFO)
        logging.basicConfig(level=level, format=_FORMAT, datefmt="%H:%M:%S")
        _configured = True
    return logging.getLogger(f"omvs_torch.{name}")


class Span(NamedTuple):
    """One recorded span: ``parent`` is the id of the span open around it
    when it began (None for a root), ``root`` the id of its outermost
    ancestor (the request: one ``dense_reconstruction`` call), ``thread``
    the ident of the thread that ran it."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int
    thread: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recording:
    """The spans and counters kept while ``recording()`` is active."""

    def __init__(self):
        import torch

        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._profiling = torch.autograd._profiler_enabled
        self._record_function = torch.profiler.record_function

    def self_s(self, name: str) -> float:
        """Seconds of the spans called ``name``, less what their children
        cover (children of one span in several threads may overlap: their
        union is taken)."""
        children: Dict[int, List[Span]] = {}
        for sp in self.spans:
            if sp.parent is not None:
                children.setdefault(sp.parent, []).append(sp)
        total = 0
        for sp in self.spans:
            if sp.name != name:
                continue
            total += sp.end_ns - sp.start_ns
            end = sp.start_ns
            for c in sorted(children.get(sp.id, ()), key=lambda c: c.start_ns):
                a, b = max(c.start_ns, end), min(c.end_ns, sp.end_ns)
                if b > a:
                    total -= b - a
                    end = b
        return total / 1e9


# the active recording (one at a time, for the whole process), and the
# (id, root) of the innermost span open in this context: worker threads run
# in a copy of their caller's context (``densify._run_views_parallel``)
_active: Optional[Recording] = None
_ACTIVE_LOCK = threading.Lock()
_current: contextvars.ContextVar = contextvars.ContextVar("omvs_span", default=None)


@contextlib.contextmanager
def recording():
    """Keep every span and counter of the process until the block ends;
    yields the ``Recording``. Only one recording is active at a time."""
    global _active
    rec = Recording()
    with _ACTIVE_LOCK:
        if _active is not None:
            raise RuntimeError("a recording is already active")
        _active = rec
    try:
        yield rec
    finally:
        _active = None


class span:
    """A named step of the program, with small attributes (a view index, a
    pyramid level). Kept by the active recording, and a ``record_function``
    range while ``torch.profiler`` records as well; outside a recording it
    reads one global and keeps nothing. Never open one inside the body of a
    CUDA graph: a body runs only at its capture."""

    __slots__ = ("name", "attrs", "_rec", "_t0", "_id", "_parent", "_root", "_tok", "_rf")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        rec = self._rec = _active
        if rec is None:
            return self
        cur = _current.get()
        self._id = next(rec._ids)
        self._parent, self._root = (None, self._id) if cur is None else cur
        self._tok = _current.set((self._id, self._root))
        self._t0 = time.perf_counter_ns()
        # the profiler's range lies inside the span: its first opening in
        # a process takes about a millisecond inside the range
        self._rf = rec._record_function(self.name) if rec._profiling() else None
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is None:
            return False
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        _current.reset(self._tok)
        sp = Span(self.name, self._t0, t1, self._id, self._parent, self._root,
                  threading.get_ident(), self.attrs)
        with rec._lock:
            rec.spans.append(sp)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the active recording's counter ``name``."""
    rec = _active
    if rec is None:
        return
    with rec._lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def timed(log: logging.Logger, label: str):
    t0 = time.perf_counter()
    try:
        with span(label):
            yield
    finally:
        if os.environ.get("OMVS_LOG_RSS"):
            # ru_maxrss is the process PEAK (monotone): the per-stage line
            # shows which stage grew it
            import resource

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
            log.info("%s (%.2fs, peak_rss %.2f GB)", label,
                     time.perf_counter() - t0, rss)
        else:
            log.info("%s (%.2fs)", label, time.perf_counter() - t0)


def verbosity() -> int:
    """The reference's g_nVerbosityLevel (Common.h:17-41): levels above 2
    dump per-view depth, normal and confidence images
    (SceneDensify.cpp:2099-2110). OMVS_VERBOSE and OPENMVS_TPU_VERBOSE are
    aliases; the larger wins, and the default is 2."""
    vals = [2]
    for var in ("OMVS_VERBOSE", "OPENMVS_TPU_VERBOSE"):
        try:
            vals.append(int(os.environ.get(var, "0")))
        except ValueError:
            pass
    return max(vals)


def _jet_table() -> np.ndarray:
    """(256, 3) uint8 BGR: OpenCV's COLORMAP_JET lookup table. Its float
    table rises and falls by 4/255 an entry; rounded to uint8 each channel
    is a clipped triangle, but for blue at 159, whose float entry (1.5/255
    in float32) rounds down to 1."""
    i = np.arange(256)
    tri = [np.clip(np.minimum(p + 4 * i, q - 4 * i), 0, 255)
           for p, q in ((128, 638), (-128, 892), (-382, 1148))]
    lut = np.stack(tri, -1).astype(np.uint8)
    lut[159, 0] = 1
    return lut


JET = _jet_table()


def apply_jet(gray: np.ndarray) -> np.ndarray:
    """``cv2.applyColorMap(gray, cv2.COLORMAP_JET)`` of a uint8 image:
    (h, w, 3) BGR."""
    return JET[np.asarray(gray, np.uint8)]


def dump_depth_artifacts(folder: str, view_id: int, depth, normal=None,
                         conf=None) -> None:
    """Write depthNNNN.png (the 2-98 percentile range of the valid depths
    JET-coloured), normalNNNN.png and confNNNN.png into ``folder`` when
    verbosity > 2, as the JAX package's cv2 writes them (BGR order on
    disk means the RGB PNG holds the channels reversed)."""
    if verbosity() <= 2 or not folder:
        return
    from openmvs_tpu_torch.io import png

    os.makedirs(folder, exist_ok=True)
    d = np.asarray(depth)
    valid = d > 0
    if valid.any():
        lo, hi = np.percentile(d[valid], 2), np.percentile(d[valid], 98)
        vis = np.where(valid, np.clip((d - lo) / max(hi - lo, 1e-9), 0, 1), 0)
        png.write(os.path.join(folder, f"depth{view_id:04d}.png"),
                  apply_jet((vis * 255).astype(np.uint8))[..., ::-1])
    if normal is not None:
        n = np.asarray(normal)
        png.write(os.path.join(folder, f"normal{view_id:04d}.png"),
                  ((n * 0.5 + 0.5) * 255).astype(np.uint8))
    if conf is not None:
        c = np.clip(np.asarray(conf), 0, 1)
        png.write(os.path.join(folder, f"conf{view_id:04d}.png"),
                  (c * 255).astype(np.uint8))


class profile_trace:
    """A ``torch.profiler`` trace (CPU and, where a card is present, CUDA
    activity) gated by OMVS_PROFILE_DIR: ``<dir>/<tag>.json``, a Chrome
    trace of the stage (the JAX package writes a ``jax.profiler`` trace
    per tag). Unless a recording is already active it opens one for the
    block, so the program's spans are ranges of the trace."""

    def __init__(self, tag: str):
        self.dir = os.environ.get("OMVS_PROFILE_DIR", "")
        self.tag = tag
        self.path = os.path.join(self.dir, f"{tag}.json") if self.dir else ""
        self._prof = None
        self._rec = None

    def __enter__(self):
        if self.dir:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            if _active is None:
                self._rec = recording()
                self._rec.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.__exit__(*exc)
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.dir, exist_ok=True)
            self._prof.export_chrome_trace(self.path)
        return False


class Progress:
    """ETA progress reporter (the reference's Util::Progress, Util.h:770):
    logs "k/n (p%, elapsed, ETA)" at most once per ``interval`` seconds,
    and a summary line with the overall rate on ``close``."""

    def __init__(self, log: logging.Logger, label: str, total: int,
                 interval: float = 5.0):
        self.log = log
        self.label = label
        self.total = max(int(total), 1)
        self.interval = interval
        self.done = 0
        self.t0 = time.perf_counter()
        self._last = 0.0

    @staticmethod
    def _fmt(s: float) -> str:
        s = int(max(s, 0))
        return f"{s // 3600}:{s % 3600 // 60:02d}:{s % 60:02d}" if s >= 3600 \
            else f"{s // 60}:{s % 60:02d}"

    def step(self, k: int = 1):
        self.done += k
        now = time.perf_counter()
        if now - self._last < self.interval and self.done < self.total:
            return
        self._last = now
        el = now - self.t0
        eta = el / self.done * (self.total - self.done) if self.done else 0.0
        self.log.info("%s: %d/%d (%.0f%%, %s elapsed, ETA %s)",
                      self.label, self.done, self.total,
                      100.0 * self.done / self.total,
                      self._fmt(el), self._fmt(eta))

    def close(self):
        el = time.perf_counter() - self.t0
        self.log.info("%s: %d done in %s (%.2f/s)", self.label, self.done,
                      self._fmt(el), self.done / max(el, 1e-9))
