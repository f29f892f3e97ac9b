"""SGM's graph pools on the card: a ``dense_reconstruction`` call releases
its runners when it returns, so over six SGM calls in one process, with
the cycle collector off, the card's reserved memory holds flat.

Marked ``card``: the test skips without a CUDA card. This file imports no
JAX, so it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_sgm_card.py -q -s

The scene is the benchmark's ``dtu-sgm`` one (``mvs_bench/configs/
dtu-sgm.json``: 9 views of 800x600, 8 neighbours each, 72 rectified pairs
a call); ``-s`` prints each call's reserved and allocated memory."""

import gc
import json

import pytest
import torch

from mvs_bench import harness, scene_gen
from openmvs_tpu_torch import densify

CALLS = 6
FLAT_BYTES = 0.5e9


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip")
    return torch.device("cuda")


@pytest.mark.card
def test_reserved_memory_holds_flat_over_six_sgm_calls(card):
    with open(harness.HERE / "configs" / "dtu-sgm.json") as f:
        cfg = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arrays = scene_gen.make_scene(cfg, 2147483777, card)
    opts = harness.options(cfg)
    reserved = []
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        for k in range(CALLS):
            pc = densify.dense_reconstruction(harness.build_scene(arrays), opts, device=card)
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved())
            print(f"call {k + 1}: {len(pc)} points, {reserved[-1] / 1e9:.3f} GB reserved, "
                  f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    finally:
        if was:
            gc.enable()
    assert abs(reserved[-1] - reserved[1]) <= FLAT_BYTES, reserved
