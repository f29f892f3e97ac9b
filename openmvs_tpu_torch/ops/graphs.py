"""Densify's sweeps as device programs: CUDA graphs captured once and
replayed over static buffers.

The port's counterpart of the JAX package's compiled sweep programs: the
jitted sweep (``_sweep_fused_jit``, ``openmvs_tpu/ops/patchmatch.py:1127``),
``init_state`` (:1314) and the early-exit block that runs as one
``lax.while_loop`` (``sweep_block_adaptive``, :938-993). Run eagerly, a
half-step is some 1,700 launches issued one by one from Python, and the
card waits on the host for most of a photometric map. A CUDA graph replays
the same kernels with the same arguments from one launch, so its results
are the eager run's to the bit; ``torch.compile`` would fuse and reorder
the element-wise arithmetic that ``utils/fmath.py`` rounds op by op.

A ``Runner`` (one device, one thread) owns:

* static buffers per shape class, the shapes of one pyramid level's
  ``PMData`` with its view axis padded: a view with fewer neighbours than
  the class holds (two or more) fills the other slots with size (0, 0),
  which score 2 and leave the min-mean of the real views as it was. Each
  view's data and seeds are copied in with ``copy_``;
* one program per class and sweep kind, captured on first use into the
  runner's one memory pool: ``init_state``, the nn sweep, the exact sweep,
  the exact rescoring sweep and the geometric sweep, and the variants the
  switches select (band skipping, the split or unfused geometric sweep).
  Per-call constants (options, sampling mode, counts, the rescore, the
  switches read at call time) choose the program; what changes between
  replays (the view's data, seeds, state and keys) is in static buffers.
  Each program reads its keys from a ``rng.KeyTable`` filled before the
  replay, and its host bookkeeping (launch and band counts) runs after
  each replay (``pm_kernel.host_effect``);
* the early-exit block: its sweeps' program also writes the share of
  valid pixels that improved, and the host reads it only from sweep
  ``min_sweeps`` on, deciding in float32 as the JAX loop condition does.

The host side is traced through ``utils/log``: a span ``graphs.capture``
around each capture (never inside a body, which runs only at its capture)
and the counter ``pm.sweeps``, each sweep ``Sweeps`` runs, in both forms.

Each program's outputs are either static buffers or read before the next
replay, so programs may share one memory pool; the runner keeps every
graph it captured until it is released. ``Runners.release`` (or leaving a
``with Runners()`` block) releases a call's runners: their programs,
graphs and buffers go, and their pools' memory goes back to the card. On
the CPU a runner runs each program's body directly on the same static
buffers (its CPU form, which the tests hold against the eager functions).

Refinement's iteration (``refine.IterProgram``) and SGM's matching level
(``sgm.LevelProgram``, one per shape class, kept by the runner through
``kept``) are its other users: each keeps its own buffers, captures
through ``capture`` and ``replay``, and holds no reference to its runner,
so a runner and its programs form no cycle. Both are needed: a caller
that drops its runners unreleased (``estimate_depth_map`` called alone,
or one that hands ``match_pair_tsgm`` a ``Runners`` of its own) frees
their programs and graphs by reference count, and their pools' memory
at the allocator's next ``empty_cache`` or failed allocation;
``release`` returns it at once.

Threads: ``Runners`` gives each (thread, device) its own runner, so worker
threads share no buffer and no pool. Captures hold a process-wide lock and
use ``capture_error_mode="thread_local"``, so another thread's eager work
(an upload, a synchronisation) does not invalidate a capture. A capture or
replay that fails raises; nothing falls back to eager launches.
"""

from __future__ import annotations

import functools
import gc
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.ops import _build, patchmatch, pm_kernel
from openmvs_tpu_torch.ops.patchmatch import PMData, PMState, PMViews
from openmvs_tpu_torch.utils import rng
from openmvs_tpu_torch.utils.log import count, span

# switches the sweep reads when it runs, hence when it is captured
_SWITCHES = ("OMVS_GEOM_SPLIT", "OMVS_GEOM_FUSED", "OMVS_OLD_RNG", "OMVS_GEOM_DEBUG")
_CAPTURE_LOCK = threading.Lock()


def _store(dst: PMState, src: PMState) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


class _Buffers:
    """The static buffers of one shape class: PMData with ``V`` view slots,
    the state, the confidence before the last sweep (band skipping), the
    seeds and the early-exit fraction."""

    def __init__(self, data: PMData, V: int):
        def zeros(shape, like):
            return torch.zeros(shape, dtype=like.dtype, device=like.device)

        views = PMViews(*(zeros((V,) + t.shape[1:], t) for t in data.views))
        self.data = data._replace(views=views, **{
            f: zeros(t.shape, t) for f, t in data._asdict().items() if f != "views"})
        H, W = data.ref.shape
        self.state = PMState(depth=zeros((H, W), data.ref),
                             normal=zeros((H, W, 3), data.ref),
                             conf=zeros((H, W), data.ref))
        self.conf_prev = zeros((H, W), data.ref)
        self.seed_depth = zeros((H, W), data.ref)
        self.seed_normal = zeros((H, W, 3), data.ref)
        self.frac = zeros((), data.ref)
        self.V = V

    def load(self, data: PMData) -> None:
        for f, t in data._asdict().items():
            if f != "views":
                getattr(self.data, f).copy_(t)
        n = data.views.image.shape[0]
        for dst, src in zip(self.data.views, data.views):
            dst[:n].copy_(src)
            if n < self.V:
                dst[n:].zero_()


class _Program:
    """One body over a class's buffers, its key table, and, on a card, its
    CUDA graph and the host effects its capture recorded. It refers to
    nothing that refers back to it, so a runner's graphs are freed as soon
    as the runner is (a graph destroyed by the cycle collector during
    another capture would invalidate that capture)."""

    def __init__(self, device, make_body):
        self.keys = rng.KeyTable(device)
        self.body = make_body(self.keys.root)
        self.effects = []
        self.graph = None


def _init_body(b: _Buffers, opts, use_geom, mode, root):
    def body():
        _store(b.state, patchmatch.init_state(b.data, opts, root, b.seed_depth,
                                              b.seed_normal, b.V, use_geom, mode=mode))
    return body


def _sweep_body(b: _Buffers, opts, use_geom, mode, rescore, n_perturb, n_prop,
                active_eps, frac_eps, root):
    """One ``patchmatch.sweep`` of the class's state; with ``frac_eps``, the
    early-exit block's share of valid pixels improved by more than it (as
    ``patchmatch.sweep_block_adaptive`` computes it) into ``b.frac``."""
    def body():
        st = b.state
        new = patchmatch.sweep(st, b.data, opts, root, b.V, use_geom,
                               n_perturb=n_perturb, mode=mode,
                               rescore_state=rescore, n_prop=n_prop,
                               active_eps=active_eps, conf_prev=b.conf_prev)
        if frac_eps is not None:
            n_valid = torch.clamp(torch.sum(b.data.valid.to(torch.float32)), min=1.0)
            improved = ((st.conf - new.conf) > frac_eps) & b.data.valid
            b.frac.copy_(torch.sum(improved.to(torch.float32)) / n_valid)
        b.conf_prev.copy_(st.conf)
        _store(st, new)
    return body


class Runner:
    """Static buffers and sweep programs of one device, used by one thread
    (``Runners``). ``captures``, ``capture_s`` and ``replays`` count its
    work; ``pool`` is the memory pool of its graphs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._classes: Dict[tuple, list] = {}
        self._programs: Dict[tuple, _Program] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.pool = None
        # every graph captured, kept until the runner goes: PyTorch refuses
        # a capture into a shared pool once all of its graphs have died
        # while a block of it is still held
        self._graphs = []
        if self.device.type == "cuda":
            # a library loads (and builds) on first use, never under capture
            _build.load_all()
            self.pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    def buffers(self, data: PMData) -> _Buffers:
        """The buffers of ``data``'s shape class, loaded with ``data``."""
        shape = (tuple(tuple(t.shape) for f, t in data._asdict().items() if f != "views")
                 + tuple(tuple(t.shape[1:]) for t in data.views))
        V = data.views.image.shape[0]
        fit = [b for b in self._classes.get(shape, ()) if b.V == V or (V >= 2 and b.V > V)]
        if fit:
            b = min(fit, key=lambda c: c.V)
        else:
            b = _Buffers(data, V)
            self._classes.setdefault(shape, []).append(b)
        b.load(data)
        return b

    @property
    def n_classes(self) -> int:
        return sum(len(c) for c in self._classes.values())

    def run(self, b: _Buffers, kind: tuple, make_body, key) -> None:
        """Run the program ``kind`` (a hashable description of what
        ``make_body(root key)`` builds) over ``b`` with ``key``: on a card,
        capture it on first use, then fill its keys and replay it (and run
        its host effects); on the CPU, fill its keys and run its body."""
        pkey = (b,) + kind + tuple(os.environ.get(k) for k in _SWITCHES)
        prog = self._programs.get(pkey)
        if prog is None:
            prog = self._programs[pkey] = _Program(self.device, make_body)
            if self.device.type == "cuda":
                prog.graph = self.capture(prog.body, prog.effects)
        prog.keys.fill(key)
        if prog.graph is None:
            prog.body()
            return
        self.replay(prog.graph, prog.effects)

    def kept(self, key: tuple, make):
        """The object ``make()`` built at this runner's first call with
        ``key``, kept as long as the runner: another module's device
        program (``sgm.LevelProgram``), which captures through ``capture``
        and ``replay``."""
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = make()
        return prog

    def release(self) -> None:
        """Let go of every program, graph and buffer; the counters stay. A
        later capture goes into a new pool: PyTorch refuses one into a pool
        whose graphs have all gone."""
        self._programs.clear()
        self._classes.clear()
        self._graphs.clear()
        if self.pool is not None:
            self.pool = torch.cuda.graph_pool_handle()

    def replay(self, graph: torch.cuda.CUDAGraph, effects: list) -> None:
        """Replay ``graph`` on the current stream, then run the host
        effects its capture recorded."""
        graph.replay()
        self.replays += 1
        for fn in effects:
            fn()

    def pool_bytes(self) -> int:
        """Bytes of the card's memory segments in this runner's pool."""
        if self.pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))

    def capture(self, body, effects: list) -> torch.cuda.CUDAGraph:
        """``body`` captured as a CUDA graph into this runner's pool, its
        host effects appended to ``effects``. Nothing runs: replay it."""
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # no cycle collection during a capture: it may destroy a dead
        # graph, a CUDA call the capture does not permit
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with span("graphs.capture"), _CAPTURE_LOCK, torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream), pm_kernel.capturing(effects):
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    body()
                finally:
                    graph.capture_end()
        finally:
            if gc_was_on:
                gc.enable()
        self._graphs.append(graph)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph


class Runners:
    """The runners of one densify call: one per (thread, device), made on
    first use. As a context manager it releases them when the block ends."""

    def __init__(self):
        self._lock = threading.Lock()
        self._runners: Dict[tuple, Runner] = {}

    def __enter__(self) -> "Runners":
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def release(self) -> None:
        """Release every runner (``Runner.release``) and return their pools'
        memory to the card. A pool whose graphs have all gone is freed only
        by the allocator's ``empty_cache`` or by an allocation that fails,
        so without it each call's pools would stay reserved."""
        runners = self.all()
        for r in runners:
            r.release()
        if any(r.pool is not None for r in runners):
            with _CAPTURE_LOCK:  # never while another thread captures
                torch.cuda.empty_cache()

    def get(self, device) -> Runner:
        k = (threading.get_ident(), torch.device(device))
        with self._lock:
            r = self._runners.get(k)
            if r is None:
                r = self._runners[k] = Runner(device)
        return r

    def all(self) -> list:
        with self._lock:
            return list(self._runners.values())


class Sweeps:
    """The sweep schedule's steps for one reference view at one pyramid
    level (``densify.estimate_depth_map``): eager, patchmatch's functions on
    ``data``; with a ``runner``, its programs over the static buffers of
    ``data``'s shape class. ``state`` is the current PMState (the class's
    buffers with a runner: read it before the class's next view loads)."""

    def __init__(self, data: PMData, opts: DenseOptions, n_views: int,
                 use_geom: bool, runner: Optional[Runner] = None):
        self.data, self.opts, self.n_views, self.use_geom = data, opts, n_views, use_geom
        self.runner = runner
        self._b = None if runner is None else runner.buffers(data)
        self._state = self._prev = None

    @property
    def state(self) -> PMState:
        return self._state if self._b is None else self._b.state

    def _run(self, body_fn, args: tuple, key) -> None:
        """The program ``body_fn(buffers, opts, use_geom, *args)``."""
        self.runner.run(self._b, (body_fn, self.opts, self.use_geom) + args,
                        functools.partial(body_fn, self._b, self.opts, self.use_geom,
                                          *args), key)

    def init(self, key, seed_depth, seed_normal, mode: str) -> None:
        """``patchmatch.init_state`` from the seeds (numpy or tensors)."""
        if self._b is None:
            self._state = patchmatch.init_state(self.data, self.opts, key, seed_depth,
                                                seed_normal, self.n_views,
                                                self.use_geom, mode=mode)
            return
        self._b.seed_depth.copy_(torch.as_tensor(seed_depth, dtype=torch.float32))
        self._b.seed_normal.copy_(torch.as_tensor(seed_normal, dtype=torch.float32))
        self._run(_init_body, (mode,), key)

    def block(self, key, n_perturb: int, mode: str, n_prop: int, first_fold: int,
              n_sweeps: int, min_sweeps: int, eps: float, min_frac: float) -> int:
        """``patchmatch.sweep_block_adaptive``: up to ``n_sweeps`` sweeps,
        sweep k keyed fold_in(key, first_fold + k), stopping after sweep
        k >= min_sweeps once the share of valid pixels it improved by more
        than ``eps`` is below ``min_frac``. Returns the sweeps run."""
        if self._b is None:
            self._state, n = patchmatch.sweep_block_adaptive(
                self._state, self.data, self.opts, key, self.n_views, self.use_geom,
                n_perturb=n_perturb, mode=mode, n_prop=n_prop, first_fold=first_fold,
                n_sweeps=n_sweeps, min_sweeps=min_sweeps, eps=eps, min_frac=min_frac)
            count("pm.sweeps", n)
            return n
        args = (mode, False, n_perturb, n_prop, 0.0, eps)
        n, go_on = 0, True
        while n < n_sweeps and (n < min_sweeps or go_on):
            self._run(_sweep_body, args, rng.fold_in(key, first_fold + n))
            n += 1
            if min_sweeps <= n < n_sweeps:
                go_on = bool(np.float32(self._b.frac.item()) >= np.float32(min_frac))
        count("pm.sweeps", n)
        return n

    def sweep(self, key, fold: int, mode: str, rescore: bool, n_perturb: int,
              n_prop: int, active_eps: float = 0.0) -> None:
        """``patchmatch.sweep`` keyed fold_in(key, fold); ``active_eps`` > 0
        skips the bands that did not improve by more than it in the
        previous sweep of this view and level."""
        count("pm.sweeps")
        if self._b is None:
            this = self._state.conf
            self._state = patchmatch.sweep(
                self._state, self.data, self.opts, key, self.n_views, self.use_geom,
                n_perturb=n_perturb, mode=mode, rescore_state=rescore, n_prop=n_prop,
                fold=fold, active_eps=active_eps, conf_prev=self._prev)
            self._prev = this
            return
        args = (mode, rescore, n_perturb, n_prop, active_eps, None)
        self._run(_sweep_body, args, rng.fold_in(key, fold) if fold else key)
