"""SGM's level programs (``sgm.LevelProgram``) and the runner that keeps
them (``graphs.Runner``) form no cycle: with the cycle collector off, both
die when the call that made them drops its ``graphs.Runners``, so on a
card their graph pools are not held past the call. A released runner
keeps its counters and drops its programs, and the maps are the same
bits with the runners as without them (the eager levels, unchanged)."""

import gc
import weakref

import numpy as np
import pytest
import torch

from openmvs_tpu_torch import densify
from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.ops import graphs, sgm
from openmvs_tpu_torch.synthetic import build_gt_scene
from openmvs_tpu_torch.view_selection import select_views_for_scene

torch.set_num_threads(2)


@pytest.fixture
def no_collector():
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    yield
    if was:
        gc.enable()


@pytest.fixture(scope="module")
def scene():
    scene, _, _ = build_gt_scene(n_views=3, W=96, H=72)
    select_views_for_scene(scene, DenseOptions(estimator="sgm"))
    return scene


def _estimate(scene, runners=None):
    opts = DenseOptions(estimator="sgm")
    return [densify.estimate_depth_map_sgm(scene, i, opts, device="cpu", runners=runners)
            for i in range(scene.n_views)]


def _with_runners(scene, refs):
    """Every view's map through one call's runners (their CPU form), with
    weak references to the runner and its level programs."""
    runners = graphs.Runners()
    maps = _estimate(scene, runners)
    for r in runners.all():
        refs.append(weakref.ref(r))
        refs.extend(weakref.ref(p) for p in r._programs.values())
    assert sum(isinstance(ref(), sgm.LevelProgram) for ref in refs) == len(refs) - 1 >= 2
    return maps


def test_programs_and_runner_die_with_the_call(scene, no_collector):
    refs = []
    maps = _with_runners(scene, refs)
    assert len(refs) >= 3 and all(ref() is None for ref in refs)
    assert all(m is not None for m in maps)


def test_maps_are_the_eager_levels_bits(scene, no_collector):
    eager = _estimate(scene)
    with_runners = _with_runners(scene, [])
    for a, b in zip(eager, with_runners):
        assert np.array_equal(a.depth, b.depth) and np.array_equal(a.conf, b.conf)


def test_a_released_runner_keeps_its_counters(scene, no_collector):
    with graphs.Runners() as runners:
        first = _estimate(scene, runners)
        (runner,) = runners.all()
        progs = [weakref.ref(p) for p in runner._programs.values()]
        assert len(progs) >= 2
    assert not runner._programs and not runner._classes and not runner._graphs
    assert all(ref() is None for ref in progs)
    assert runner.captures == 0 and runner.pool is None  # the CPU form captures nothing
    again = _estimate(scene, runners)  # a released runner builds its programs anew
    assert len(runner._programs) == len(progs)
    for a, b in zip(first, again):
        assert np.array_equal(a.depth, b.depth)
