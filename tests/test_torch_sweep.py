"""The port's PatchMatch sweep machinery against the JAX package on a
96x128 example with two neighbour views (``make_case``): candidates,
``init_state``, one ``sweep`` in nn mode, one in exact mode with the
incumbent rescored, ``sweep_block_adaptive`` and ``finalize``.

The RNG is exact, so candidate depths and masks are identical; candidate
normals go through sin/cos, which the port rounds correctly and XLA to
within an ulp. A pixel's state counts as equal when its depth agrees to
1e-6 relative and its normal and confidence to 1e-5: the same winner, up
to the last ulps of the score. At least 99.9% of pixels must be equal;
the rest are argmin flips between candidates whose scores differ in the
last ulp.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import equal_share as _equal_share  # noqa: E402
from _torch_helpers import make_case, port_data, port_state, t  # noqa: E402

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch.ops import patchmatch as tpm  # noqa: E402
from openmvs_tpu_torch.utils import rng  # noqa: E402

torch.set_num_threads(1)

H, W, V = 96, 128, 2


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


@pytest.fixture(scope="module")
def case():
    data, state, jo, po, _ = make_case(H, W, V)
    key = jax.random.PRNGKey(5)
    st = jpm.sweep(state, data, jo, key, V, mode="nn", fold=1)
    return data, st, jo, po, key


@pytest.mark.parametrize("parity", [0, 1])
def test_candidates_identical(case, parity):
    data, st, jo, po, key = case
    cd, cn, cok = jpm._build_candidates(st, data, jo, key, parity, 3, "nn", 8, fold=2)
    pd, ps = port_data(data), port_state(st)
    k = rng.fold_in(_key(key), 2)
    pcd, pcn, pcok = tpm._stack_cands(
        tpm._prop_cand_list(pd, ps, po, 8)
        + tpm._perturb_cand_list(pd, ps, po, k, parity, 3))
    np.testing.assert_array_equal(pcd.numpy(), np.asarray(cd))
    np.testing.assert_array_equal(pcok.numpy(), np.asarray(cok))
    np.testing.assert_allclose(pcn.numpy(), np.asarray(cn), rtol=0, atol=2 * 2.0 ** -23)


def test_init_state_matches_jax(case):
    data, _, jo, po, key = case
    r = np.random.default_rng(1)
    sd = (5.0 * (1 + 0.01 * r.standard_normal((H, W)))).astype(np.float32)
    sd[r.random((H, W)) < 0.2] = 0.0            # random where seeds are missing
    sn = (0.1 * r.standard_normal((H, W, 3)) + [0, 0, -1]).astype(np.float32)
    js = jpm.init_state(data, jo, key, jnp.asarray(sd), jnp.asarray(sn), V, False,
                        mode="nn")
    ps = tpm.init_state(port_data(data), po, _key(key), sd, sn, V, False, mode="nn")
    np.testing.assert_array_equal(ps.depth.numpy(), np.asarray(js.depth))
    assert _equal_share(js, ps) >= 0.999


@pytest.mark.parametrize("mode", ["nn", "exact"])
def test_sweep_matches_jax(case, mode):
    data, st, jo, po, key = case
    rescore = mode == "exact"
    js = jpm.sweep(st, data, jo, key, V, mode=mode, fold=2, rescore_state=rescore)
    ps = tpm.sweep(port_state(st), port_data(data), po, _key(key), V, mode=mode,
                   fold=2, rescore_state=rescore)
    share = _equal_share(js, ps)
    assert share >= 0.999, share


def test_sweep_block_adaptive_matches_jax(case):
    data, st, jo, po, key = case
    js, jn = jpm.sweep_block_adaptive(st, data, jo, key, V, mode="nn",
                                      first_fold=2, n_sweeps=3)
    ps, pn = tpm.sweep_block_adaptive(port_state(st), port_data(data), po,
                                      _key(key), V, mode="nn", first_fold=2,
                                      n_sweeps=3)
    assert int(jn) == pn
    share = _equal_share(js, ps)
    assert share >= 0.999, share


def test_sweep_block_adaptive_exits_early():
    """After min_sweeps, a block stops once fewer than min_frac of the valid
    pixels improved; with min_frac above 1 it stops at min_sweeps, and it
    never runs more than n_sweeps."""
    data, state, _, po, _ = make_case(40, 56, 1)
    pd, ps = port_data(data), port_state(state)
    _, n = tpm.sweep_block_adaptive(ps, pd, po, (0, 3), 1, n_sweeps=4,
                                    min_sweeps=2, min_frac=1.5)
    assert n == 2
    _, n = tpm.sweep_block_adaptive(ps, pd, po, (0, 3), 1, n_sweeps=3,
                                    min_sweeps=2, min_frac=0.0)
    assert n == 3


@pytest.mark.parametrize("geometric_follows", [False, True])
def test_finalize_and_pack_match_jax(case, geometric_follows):
    data, st, jo, po, _ = case
    jf = jpm.finalize(st, data, jo, geometric_follows)
    pf = tpm.finalize(port_state(st), port_data(data), po, geometric_follows)
    for a, b in zip(jf, pf):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tpm.pack_state(pf).numpy(),
                                  np.asarray(jpm.pack_state(jf)))
