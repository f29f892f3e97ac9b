"""The port's NaN safety hooks (``openmvs_tpu_torch/utils/safety.py``), which
read ``OMVS_DEBUG_NANS`` and ``OMVS_CHECKIFY`` at import: run in a
subprocess with both set, a NaN at densify's stage boundary raises naming
the stage (as the JAX package's ``check_finite`` does, message for
message), a NaN in a checked function's output (densify's
``patchmatch.finalize`` among them) raises naming the function,
and autograd's anomaly detection is on (the counterpart of
``jax_debug_nans``). In this process, with both unset, nothing raises."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_CHILD = r"""
import numpy as np, torch
import openmvs_tpu_torch
from openmvs_tpu_torch.utils import safety
from openmvs_tpu_torch import densify
from openmvs_tpu_torch.geometry.camera import Camera

assert safety.DEBUG_NANS and safety.CHECKIFY
assert torch.is_anomaly_enabled()
packed = torch.zeros(4, 5, 5)
packed[1, 2, 4] = float("nan")
tmpl = densify.DepthMapResult(image_idx=0, depth=None, normal=None, conf=None,
                              d_min=1.0, d_max=2.0, neighbor_ids=[],
                              camera=Camera(np.eye(3), np.eye(3), np.zeros(3)))
try:
    densify.DeferredResult(packed, tmpl).resolve()
    raise SystemExit("no raise at the stage boundary")
except FloatingPointError as e:
    print("STAGE", e)

def scores(x):
    return x, {"s": torch.log(x)}

f = safety.checked(scores)
f(torch.ones(3))
try:
    f(torch.tensor([1.0, -1.0]))
    raise SystemExit("no raise from the checked function")
except FloatingPointError as e:
    print("CHECKED", e)

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.ops import patchmatch

class Data:
    valid = torch.ones(1, 2, dtype=torch.bool)

st = patchmatch.PMState(depth=torch.tensor([[float("nan"), 1.0]]),
                        normal=torch.zeros(1, 2, 3), conf=torch.zeros(1, 2))
try:
    patchmatch.finalize(st, Data, DenseOptions(), False)
    raise SystemExit("no raise from densify's finalize")
except FloatingPointError as e:
    print("FINAL", e)
"""


def test_nan_raises_and_names_the_stage():
    env = dict(os.environ, OMVS_DEBUG_NANS="1", OMVS_CHECKIFY="1")
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = dict(ln.split(" ", 1) for ln in r.stdout.splitlines()
                 if ln[:5] in ("STAGE", "CHECK", "FINAL"))
    assert lines["STAGE"] == ("non-finite values in 'estimate_depth_map' output #0: "
                              "1/100 bad elements, shape (4, 5, 5) (OMVS_DEBUG_NANS tripped)")
    assert "'scores' output #1: 1/2 bad elements" in lines["CHECKED"]
    assert "OMVS_CHECKIFY tripped" in lines["CHECKED"]
    assert "'finalize' output #0: 1/2 bad elements" in lines["FINAL"]


def test_check_finite_message_equals_jax(monkeypatch):
    pytest.importorskip("jax")
    from openmvs_tpu.utils import safety as jsafety
    from openmvs_tpu_torch.utils import safety

    bad = np.ones((3, 4), np.float32)
    bad[0, 1] = np.inf
    msgs = []
    for mod in (safety, jsafety):
        monkeypatch.setattr(mod, "DEBUG_NANS", True)
        with pytest.raises(FloatingPointError) as e:
            mod.check_finite("fuse", np.arange(3), None, bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "'fuse' output #2" in msgs[0]
    safety.check_finite("fuse", np.ones(3, np.float32), torch.ones(2))


def test_hooks_off_by_default():
    from openmvs_tpu_torch.utils import safety

    if os.environ.get("OMVS_DEBUG_NANS") == "1" or os.environ.get("OMVS_CHECKIFY") == "1":
        pytest.skip("the hooks are switched on for this process")
    assert not safety.DEBUG_NANS and not safety.CHECKIFY
    safety.check_finite("x", np.array([np.nan], np.float32))

    def f():
        return torch.tensor([float("nan")])

    assert safety.checked(f) is f
    from openmvs_tpu_torch.ops import patchmatch

    assert not hasattr(patchmatch.finalize, "__wrapped__")
    assert not torch.is_anomaly_enabled()
