"""The PatchMatch sweep's switches as one record (``patchmatch.Switches``)
and the one sweep schedule both densify paths run (``patchmatch.schedule``).

- ``Switches.from_env`` parses each environment variable as the JAX
  package reads it, edge values included;
- no module of the port but the record's reader reads any of them;
- the schedule's steps for the default options, photometric and
  geometric, by hand: the pyramid's levels, the incumbent's mode, the
  adaptive block's limits, and for each sweep its key fold, mode, rescore
  and band-skipping eps; the sharded path's the same without the block
  and band skipping.
"""

import ast
import dataclasses
from pathlib import Path

import pytest

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.ops.patchmatch import Block, Step, Switches, schedule

PORT = Path(__file__).resolve().parent.parent / "openmvs_tpu_torch"
NAMES = ("OMVS_ALL_EXACT", "OMVS_INIT_EXACT", "OMVS_EARLY_EXIT", "OMVS_EE_MIN",
         "OMVS_EE_EPS", "OMVS_EE_FRAC", "OMVS_ACTIVE", "OMVS_ACTIVE_FROM",
         "OMVS_GEOM_SPLIT", "OMVS_GEOM_FUSED", "OMVS_GEOM_DEBUG", "OMVS_OLD_RNG")


CASES = [
    ({}, {}),
    ({"OMVS_ALL_EXACT": "1"}, {"all_exact": True}),
    ({"OMVS_ALL_EXACT": "0"}, {"all_exact": True}),      # any value but "" sets it
    ({"OMVS_ALL_EXACT": ""}, {}),
    ({"OMVS_INIT_EXACT": "1"}, {"init_exact": True}),
    ({"OMVS_INIT_EXACT": ""}, {}),
    ({"OMVS_EARLY_EXIT": "0"}, {"early_exit": False}),
    ({"OMVS_EARLY_EXIT": ""}, {"early_exit": False}),
    ({"OMVS_EARLY_EXIT": "1"}, {}),
    ({"OMVS_EARLY_EXIT": "no"}, {}),
    ({"OMVS_EE_MIN": "5"}, {"ee_min": 5}),
    ({"OMVS_EE_MIN": "-3"}, {"ee_min": 0}),
    ({"OMVS_EE_EPS": "0.02", "OMVS_EE_FRAC": "0.5"}, {"ee_eps": 0.02, "ee_frac": 0.5}),
    ({"OMVS_ACTIVE": "5e-3"}, {"active": 5e-3}),
    ({"OMVS_ACTIVE": "abc"}, {}),
    ({"OMVS_ACTIVE": ""}, {}),
    ({"OMVS_ACTIVE_FROM": "3"}, {"active_from": 3}),
    ({"OMVS_GEOM_SPLIT": "1"}, {"geom_split": True}),
    ({"OMVS_GEOM_SPLIT": "xla"}, {"geom_split": True}),
    ({"OMVS_GEOM_SPLIT": "0"}, {}),
    ({"OMVS_GEOM_SPLIT": ""}, {}),
    ({"OMVS_GEOM_FUSED": "0"}, {"geom_fused": False}),
    ({"OMVS_GEOM_FUSED": "false"}, {"geom_fused": False}),
    ({"OMVS_GEOM_FUSED": "False"}, {}),
    ({"OMVS_GEOM_FUSED": ""}, {}),
    ({"OMVS_GEOM_DEBUG": "1"}, {"geom_debug": True}),
    ({"OMVS_OLD_RNG": "1"}, {"old_rng": True}),
    ({"OMVS_OLD_RNG": ""}, {}),
]


@pytest.mark.parametrize("env,fields", CASES, ids=[
    ",".join(f"{k[5:]}={v!r}" for k, v in env.items()) or "empty" for env, _ in CASES])
def test_from_env_parses_as_the_jax_package(monkeypatch, env, fields):
    for k in NAMES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sw = Switches.from_env()
    assert sw == Switches(**fields)
    assert hash(sw) == hash(Switches(**fields))


def _reads(path):
    """(line, name) of every string constant of ``path`` that is one of
    the twelve names."""
    tree = ast.parse(path.read_text())
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and node.value in NAMES]


def test_only_the_record_reads_the_switches():
    """The twelve names appear as strings in one function of the port,
    ``Switches.from_env``, which reads each of them; the device programs,
    the sharded path and the random draws read no environment."""
    pm = PORT / "ops" / "patchmatch.py"
    tree = ast.parse(pm.read_text())
    (cls,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "Switches"]
    (fn,) = [n for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == "from_env"]
    inside = range(fn.lineno, fn.end_lineno + 1)
    found = {}
    for path in sorted(PORT.rglob("*.py")):
        for line, name in _reads(path):
            found.setdefault(name, []).append((path.relative_to(PORT).as_posix(), line))
    assert sorted(found) == sorted(NAMES)
    outside = {n: [w for w in where if w[0] != "ops/patchmatch.py" or w[1] not in inside]
               for n, where in found.items()}
    assert not any(outside.values()), outside
    for rel in ("ops/graphs.py", "parallel/sharded.py", "utils/rng.py"):
        assert "os.environ" not in (PORT / rel).read_text(), rel
    assert "_SWITCHES" not in (PORT / "ops" / "graphs.py").read_text()
    assert "_resize_gray" not in (PORT / "parallel" / "sharded.py").read_text()


OPTS = DenseOptions()                   # 5 iterations, the last 2 exact
BLOCK = Block(n_sweeps=3, min_sweeps=2, eps=5e-3, min_frac=0.01)


def _steps(*rows):
    return tuple(Step(*r) for r in rows)


SCHEDULES = [
    ("default", Switches(), False, "nn", BLOCK,
     _steps((4, "exact", True, 0.0), (5, "exact", False, 0.0))),
    ("geometric", Switches(), True, "exact", None, _steps((1, "exact", False, 0.0))),
    ("init_exact", Switches(init_exact=True), False, "exact", BLOCK,
     _steps((4, "exact", True, 0.0), (5, "exact", False, 0.0))),
    ("ee_limits", Switches(ee_min=0, ee_eps=0.02, ee_frac=0.5), False, "nn",
     Block(3, 0, 0.02, 0.5), _steps((4, "exact", True, 0.0), (5, "exact", False, 0.0))),
    ("all_exact", Switches(all_exact=True), False, "exact", None,
     _steps(*((f, "exact", False, 0.0) for f in range(1, 6)))),
    ("all_exact_geometric", Switches(all_exact=True), True, "exact", None,
     _steps((1, "exact", False, 0.0))),
    ("early_exit_0", Switches(early_exit=False), False, "nn", None,
     _steps((1, "nn", False, 0.0), (2, "nn", False, 0.0), (3, "nn", False, 0.0),
            (4, "exact", True, 0.0), (5, "exact", False, 0.0))),
    # band skipping from sweep 2 (the third) on, never at the mode switch
    # nor the sweep after it, nor with the block on, nor in a geometric pass
    ("active_block", Switches(active=5e-3), False, "nn", BLOCK,
     _steps((4, "exact", True, 0.0), (5, "exact", False, 0.0))),
    ("active_early_exit_0", Switches(early_exit=False, active=5e-3), False, "nn", None,
     _steps((1, "nn", False, 0.0), (2, "nn", False, 0.0), (3, "nn", False, 5e-3),
            (4, "exact", True, 0.0), (5, "exact", False, 0.0))),
    ("active_all_exact", Switches(all_exact=True, active=5e-3), False, "exact", None,
     _steps((1, "exact", False, 0.0), (2, "exact", False, 0.0), (3, "exact", False, 5e-3),
            (4, "exact", False, 5e-3), (5, "exact", False, 5e-3))),
    ("active_from_1", Switches(all_exact=True, active=0.05, active_from=1), False, "exact",
     None, _steps((1, "exact", False, 0.0), *((f, "exact", False, 0.05) for f in (2, 3, 4, 5)))),
    ("active_geometric", Switches(early_exit=False, active=5e-3), True, "exact", None,
     _steps((1, "exact", False, 0.0))),
]


@pytest.mark.parametrize("name,sw,geometric,init,block,steps", SCHEDULES,
                         ids=[c[0] for c in SCHEDULES])
def test_schedule_gives_the_level_steps(name, sw, geometric, init, block, steps):
    plan = schedule(OPTS, sw, geometric)
    assert (plan.levels, plan.init_mode, plan.block, plan.sweeps, plan.n_perturb) == (
        0 if geometric else 2, init, block, steps, 3)
    if not geometric:
        # the sharded path's: every search sweep, nothing skipped, the same
        # modes, folds and rescores as the serial path without the block
        sharded = schedule(OPTS, dataclasses.replace(sw, early_exit=False, active=0.0), False)
        serial = schedule(OPTS, dataclasses.replace(sw, early_exit=False), False)
        assert sharded.block is None and sharded.init_mode == init
        assert [s._replace(active_eps=0.0) for s in serial.sweeps] == list(sharded.sweeps)
