"""Logging, scoped wall-clock timing, progress, profiling and the verbose
depth-map dumps (the reference's Log singleton, TD_TIMER scopes and
Util::Progress, libs/Common/Log.h:41, Common.h:45-71, Util.h:770; a copy
of ``openmvs_tpu/utils/log.py``).

- ``timed`` logs a stage's seconds; under ``OMVS_LOG_RSS`` also the
  process's peak resident memory.
- ``verbosity`` reads ``OMVS_VERBOSE``/``OPENMVS_TPU_VERBOSE``; above 2
  ``dump_depth_artifacts`` writes a depth map's JET-coloured depth, normal
  and confidence PNGs (through ``io/png``, with OpenCV's ``COLORMAP_JET``
  rebuilt as ``JET``).
- ``profile_trace`` records a ``torch.profiler`` Chrome trace per tag under
  ``OMVS_PROFILE_DIR``.
- ``Progress`` logs "k/n (p%, elapsed, ETA)" lines.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

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


@contextlib.contextmanager
def timed(log: logging.Logger, label: str):
    t0 = time.perf_counter()
    try:
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
    per tag)."""

    def __init__(self, tag: str):
        self.dir = os.environ.get("OMVS_PROFILE_DIR", "")
        self.tag = tag
        self.path = os.path.join(self.dir, f"{tag}.json") if self.dir else ""
        self._prof = None

    def __enter__(self):
        if self.dir:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
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
