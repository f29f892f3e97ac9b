"""On the card (``-m card``; each test skips on the CPU): the control of
each cell's configuration, from its reference module, at the cell's own
size fails the cell's limits on three seeds (each run prints what it read:
``-s`` shows it), and a short run of each cell reads correct with the
contract's last line. The cells are ``BENCHMARK.json``'s."""

import json
import subprocess
import sys

import pytest

from mvs_bench import harness

CELLS = [w["name"] for w in harness.load_bench()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_at_the_cells_size(needs_card, cell, seed):
    import torch

    torch.manual_seed(seed)
    c = harness.resolve(cell)
    got = c.reference.control(c.config, "cuda")
    print(f"control {cell} {seed}: {json.dumps(got)}")
    limits = c.config["limits"]
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
