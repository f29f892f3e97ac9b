"""The comparison that decides ``correct`` fails each fault a cell can
have: a step that returns its state unchanged, half of the views left out,
and an answer altered where it is produced. Planted under a dry run (the
CPU, the configuration's small scene, its ``dry_run`` limits), and on the
card (``-m card``) at the cell's own size against its own limits, through
``run.run``, each run printing what it read. A sound dry run reads correct
(``test_bench_dry_run.py``). One card: no exchange between chips to leave
out. The control, the reference in bfloat16, fails the cell's limits."""

import argparse
import json

import numpy as np
import pytest
import torch

from mvs_bench import harness, reference, run as bench_run


def _args(cell, dry_run=True):
    return argparse.Namespace(workload=cell, seed=2718281828, seconds=0.0, trace=0,
                              dry_run=dry_run)


def _state_unchanged(monkeypatch, cell):
    from openmvs_tpu_torch.ops import graphs

    # every PatchMatch sweep hands back the state it was given
    monkeypatch.setattr(graphs.Sweeps, "sweep", lambda self, *a, **kw: None)
    monkeypatch.setattr(graphs.Sweeps, "block", lambda self, *a, **kw: None)


def _half_left_out(monkeypatch, cell):
    from openmvs_tpu_torch import densify

    views = densify._run_views_parallel
    monkeypatch.setattr(densify, "_run_views_parallel",
                        lambda fn, idx, devices: views(fn, list(idx)[::2], devices))


def _answer_altered(monkeypatch, cell):
    from openmvs_tpu_torch import densify

    opt = densify.optimize_depth_map

    def altered(res, opts):
        opt(res, opts)
        res.depth *= np.float32(1.02)

    monkeypatch.setattr(densify, "optimize_depth_map", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}
CELLS = ["dtu-pm.scene"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_reads_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch, cell)
    out = bench_run.run(_args(cell))
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_reads_not_correct_at_the_cells_size(needs_card, monkeypatch, cell,
                                                             fault):
    FAULTS[fault](monkeypatch, cell)
    out = bench_run.run(_args(cell, dry_run=False))
    print(f"fault {cell} {fault}: {json.dumps(out['checks'])}")
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_not_correct(cell):
    """The control's errors are bfloat16's rounding of the depth, whatever
    the size: at the small scene it fails the cell's own limits."""
    cfg = harness.resolve(cell).config
    cfg["scene"].update(cfg["dry_run"]["scene"])
    got = reference.control(cfg, "cpu")
    limits = cfg["limits"]
    assert any(got[k] > limits[k] for k in limits), got
