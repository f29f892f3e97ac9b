"""On the card (``-m card``; each test skips on the CPU): the control at
each cell's own size fails the cell's limits on three seeds (each run
prints what it read: ``-s`` shows it), and a short run of each cell reads
correct with the contract's last line."""

import json
import subprocess
import sys

import pytest

from mvs_bench import harness, reference

CELLS = ["dtu-pm.scene"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_at_the_cells_size(needs_card, cell, seed):
    import torch

    torch.manual_seed(seed)
    cfg = harness.resolve(cell).config
    got = reference.control(cfg, "cuda")
    print(f"control {cell} {seed}: {json.dumps(got)}")
    limits = cfg["limits"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_reads_correct(needs_card, cell):
    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", cell,
                        "--seed", "2147483777", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert set(out["metrics"]) == {m["name"] for m in harness.resolve(cell).end_to_end}
