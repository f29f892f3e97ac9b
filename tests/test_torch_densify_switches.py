"""densify's diagnostic switches in the port (``patchmatch.Switches``, read
from the environment at each ``estimate_depth_map`` call, as the JAX
package reads them per call: openmvs_tpu/densify.py:294-345,
openmvs_tpu/ops/patchmatch.py:687-720), each against the JAX package on the
CPU: ``OMVS_ALL_EXACT``, ``OMVS_INIT_EXACT``, ``OMVS_EARLY_EXIT=0``,
``OMVS_EE_MIN``/``OMVS_EE_EPS``/``OMVS_EE_FRAC`` and ``OMVS_OLD_RNG``.

Each runs one view's ``estimate_depth_map`` on the 120x160 synthetic scene
(5 iterations, so that the nn sweeps form an early-exit block) in both
packages under the switch and is held to the slice tests' floor (masks
above 99%, depths to 1e-3 relative on more than 98.5% of the pixels valid
in both; the JAX package's one-ulp self-agreement,
tests/_torch_parity_floor.py), and must differ from the default run where
the switch changes the schedule. ``OMVS_OLD_RNG``'s shape-based uniforms
equal ``jax.random.uniform``'s bit for bit.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import SLICE_OPTS, depth_agreement, jax_scene  # noqa: E402

from openmvs_tpu import densify as jd  # noqa: E402
from openmvs_tpu.config import DenseOptions as JaxOptions  # noqa: E402
from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu.view_selection import select_views_for_scene as jax_select  # noqa: E402
from openmvs_tpu_torch import densify as pdens  # noqa: E402
from openmvs_tpu_torch.config import DenseOptions  # noqa: E402
from openmvs_tpu_torch.ops.patchmatch import Switches  # noqa: E402
from openmvs_tpu_torch.synthetic import build_gt_scene  # noqa: E402
from openmvs_tpu_torch.utils import rng  # noqa: E402
from openmvs_tpu_torch.view_selection import select_views_for_scene  # noqa: E402

torch.set_num_threads(1)

OPTS = dict(SLICE_OPTS, estimation_iters=5)
SWITCHES = ("OMVS_ALL_EXACT", "OMVS_INIT_EXACT", "OMVS_EARLY_EXIT", "OMVS_EE_MIN",
            "OMVS_EE_EPS", "OMVS_EE_FRAC", "OMVS_OLD_RNG")


def _with_env(env, fn):
    old = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)
    # the JAX package reads OMVS_OLD_RNG when it traces, the others per call
    retrace = "OMVS_OLD_RNG" in env
    if retrace:
        jax.clear_caches()
    try:
        return fn()
    finally:
        if retrace:
            jax.clear_caches()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def scenes():
    scene, _, arrays = build_gt_scene(n_views=3, W=160, H=120)
    jscene = jax_scene(arrays)
    select_views_for_scene(scene, DenseOptions(**OPTS))
    jax_select(jscene, JaxOptions(**OPTS))
    default = _with_env({}, lambda: pdens.estimate_depth_map(
        scene, 0, DenseOptions(**OPTS), device="cpu").depth)
    return scene, jscene, default


@pytest.mark.parametrize("env", [
    {"OMVS_ALL_EXACT": "1"},
    {"OMVS_INIT_EXACT": "1"},
    {"OMVS_EARLY_EXIT": "0"},
    {"OMVS_EE_MIN": "0", "OMVS_EE_EPS": "0.02", "OMVS_EE_FRAC": "0.5"},
    {"OMVS_OLD_RNG": "1"},
], ids=["all_exact", "init_exact", "early_exit_0", "ee_limits", "old_rng"])
def test_switch_matches_jax(scenes, env, monkeypatch):
    scene, jscene, default = scenes
    ref = _with_env(env, lambda: jd.estimate_depth_map(jscene, 0, JaxOptions(**OPTS)).depth)
    blocks = []
    block = pdens.patchmatch.sweep_block_adaptive

    def counted(*a, **kw):
        out = block(*a, **kw)
        blocks.append(out[1])
        return out

    monkeypatch.setattr(pdens.patchmatch, "sweep_block_adaptive", counted)
    out = _with_env(env, lambda: pdens.estimate_depth_map(
        scene, 0, DenseOptions(**OPTS), device="cpu").depth)
    masks, pooled, _ = depth_agreement([out], [ref])
    assert min(masks) > 0.99 and pooled > 0.985, (masks, pooled)
    if env.get("OMVS_EARLY_EXIT") == "0" or "OMVS_ALL_EXACT" in env:
        # no adaptive block: the nn sweeps run one by one (here the default
        # block ran all three, which the loop equals bit for bit)
        assert blocks == []
    else:
        # an adaptive block per pyramid level
        assert len(blocks) == OPTS["sub_resolution_levels"] + 1
    if "OMVS_EARLY_EXIT" not in env:
        # the other switches change the schedule's modes, its exits or its
        # random draws, so the map moves off the default one
        assert not np.array_equal(out, default)


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_old_rng_uniforms_equal_jax(seed, monkeypatch):
    key = jax.random.PRNGKey(seed)
    k = tuple(int(x) for x in np.asarray(key))
    for lo, hi in ((0.0, 1.0), (0.0, np.pi), (np.pi / 2, np.pi)):
        ref = np.asarray(jax.random.uniform(key, (9, 13), minval=lo, maxval=hi))
        np.testing.assert_array_equal(rng.uniform(k, (9, 13), lo, hi).numpy(), ref)
    # the block field of a 43x61 image: one draw per 8x8 block
    uv = np.stack(np.meshgrid(np.arange(61), np.arange(43)), -1).astype(np.float32)
    monkeypatch.setenv("OMVS_OLD_RNG", "1")
    ref = np.asarray(jpm._block_uniform(key, jnp.asarray(uv), 0.5, 2.0))
    out = rng.block_uniform(k, torch.from_numpy(uv), 0.5, 2.0,
                            Switches.from_env().old_rng).numpy()
    np.testing.assert_array_equal(out, ref)
    monkeypatch.delenv("OMVS_OLD_RNG")
    assert not np.array_equal(rng.block_uniform(k, torch.from_numpy(uv), 0.5, 2.0,
                                                Switches.from_env().old_rng).numpy(), out)
