"""The comparison that decides ``correct`` fails each fault a cell can
have, as its configuration's ``faults/<config>.py`` plants it (for
``dtu-pm``: a step that returns its state unchanged, half of the views
left out, and an answer altered where it is produced). Planted under a dry
run (the CPU, the configuration's small scene, its ``dry_run`` limits), and
on the card (``-m card``) at the cell's own size against its own limits,
through ``run.run``, each run printing what it read. A sound dry run reads
correct (``test_bench_dry_run.py``). The control, the configuration's
reference computed below the configuration's precision, fails the cell's
limits. The cells are ``BENCHMARK.json``'s."""

import argparse
import json

import pytest
import torch

from mvs_bench import harness, run as bench_run

CONFIG = {w["name"]: w["config"] for w in harness.load_bench()["workloads"]}


def _faults(cell):
    try:
        return harness.load_faults(CONFIG[cell])
    except FileNotFoundError:
        return {}


CASES = [pytest.param(cell, fault, id=f"{fault}-{cell}")
         for cell in CONFIG for fault in sorted(_faults(cell))]


def _args(cell, dry_run=True):
    return argparse.Namespace(workload=cell, seed=2718281828, seconds=0.0, trace=0,
                              dry_run=dry_run)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(CONFIG))
def test_every_configuration_has_its_faults(cell):
    assert harness.load_faults(CONFIG[cell]), f"faults/{CONFIG[cell]}.py plants no fault"


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_reads_not_correct(monkeypatch, cell, fault):
    _faults(cell)[fault](monkeypatch)
    out = bench_run.run(_args(cell))
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_reads_not_correct_at_the_cells_size(needs_card, monkeypatch, cell,
                                                             fault):
    _faults(cell)[fault](monkeypatch)
    out = bench_run.run(_args(cell, dry_run=False))
    print(f"fault {cell} {fault}: {json.dumps(out['checks'])}")
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("cell", sorted(CONFIG))
def test_the_control_reads_not_correct(cell):
    """The control's errors are its precision's rounding, whatever the
    size: at the small scene it fails the cell's own limits."""
    c = harness.resolve(cell)
    cfg = c.config
    cfg["scene"].update(cfg["dry_run"]["scene"])
    got = c.reference.control(cfg, "cpu")
    limits = cfg["limits"]
    assert any(got[k] > limits[k] for k in limits), got
