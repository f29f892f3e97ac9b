"""The warp-once scorer of the port (``score_hypotheses(mode="warp")``,
``_score_one_view_warp``, ``_probe_candidates`` and the warp branch of
``_perturb_cand_list``) against the JAX package's XLA code, on the CPU.

- The probe candidates equal the JAX package's: depths and masks to the
  bit, normals within 2 ulp (sin/cos: the port rounds them correctly, XLA
  within an ulp), as tests/test_torch_sweep.py holds the random ones.
- ``score_hypotheses(mode="warp")`` on ``__graft_entry__._make_example``
  (and with the geometric term on ``make_case(geom=True)``) is held to
  K1's tolerance (tests/test_torch_score_hypotheses.py): finite masks
  equal, at least 99.9% of the scores within 1e-3 and none off by 1e-2.
  The port repeats XLA's contractions in the warp (its bilinear blend fuses
  the left-hand term of each sum, the window sums are fused multiply-adds,
  the division by sum_w is a true one), so the scores differ only where
  XLA's refined rsqrt does, by an ulp.
- Two ``sweep_half`` sweeps (parities 0, 1, 0, 1) are held to the sweep
  tests' floor: at least 99.9% of pixels with the same state.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as ge  # noqa: E402
from _torch_helpers import equal_share, make_case, port_data, port_state, t  # noqa: E402

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch.config import DenseOptions  # noqa: E402
from openmvs_tpu_torch.ops import patchmatch as tpm  # noqa: E402
from openmvs_tpu_torch.utils import rng  # noqa: E402

torch.set_num_threads(1)

H, W, V = 72, 96, 2


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


def _assert_close(a, b):
    a, b = np.asarray(a), b.numpy()
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b))
    d = np.abs(a - b)[fin]
    assert (d < 1e-3).mean() >= 0.999 and d.max() < 1e-2, ((d < 1e-3).mean(), d.max())


@pytest.fixture(scope="module")
def example():
    """_make_example's problem after one nn sweep, and the warp candidates
    of parity 0."""
    data, state, jo, v = ge._make_example(h=H, w=W, v=V)
    key = jax.random.PRNGKey(5)
    st = jpm.sweep(state, data, jo, key, v, mode="nn", fold=1)
    po = DenseOptions(sub_resolution_levels=0, estimation_iters=1)
    return data, st, jo, po, key


@pytest.mark.parametrize("parity", [0, 1])
def test_probe_candidates_identical(example, parity):
    data, st, jo, po, key = example
    cd, cn, cok = jpm._build_candidates(st, data, jo, key, parity, 3, "warp", 8, fold=2)
    pd, ps = port_data(data), port_state(st)
    k = rng.fold_in(_key(key), 2)
    pcd, pcn, pcok = tpm._build_candidates(ps, pd, po, k, parity, 3, 8, "warp")
    assert pcd.shape[0] == 8 + 9
    np.testing.assert_array_equal(pcd.numpy(), np.asarray(cd))
    np.testing.assert_array_equal(pcok.numpy(), np.asarray(cok))
    np.testing.assert_allclose(pcn.numpy(), np.asarray(cn), rtol=0, atol=2 * 2.0 ** -23)


def test_score_warp_matches_jax(example):
    data, st, jo, po, key = example
    cd, cn, _ = jpm._build_candidates(st, data, jo, key, 0, 3, "warp", 8, fold=2)
    ref = jax.jit(lambda s, d, n: jpm.score_hypotheses(
        data, jo, s, d, n, V, False, "warp"))(st, cd, cn)
    out = tpm.score_hypotheses(port_data(data), po, port_state(st), t(cd), t(cn),
                               V, False, "warp")
    _assert_close(ref, out)


@pytest.mark.parametrize("lowres", [False, True])
def test_score_warp_geometric_matches_jax(lowres):
    data, state, jo, po, _ = make_case(H, W, V, geom=True, lowres=lowres)
    key = jax.random.PRNGKey(3)
    cd, cn, _ = jpm._build_candidates(state, data, jo, key, 1, 3, "warp", 8, fold=1)
    ref = jax.jit(lambda s, d, n: jpm.score_hypotheses(
        data, jo, s, d, n, V, True, "warp"))(state, cd, cn)
    out = tpm.score_hypotheses(port_data(data), po, port_state(state), t(cd), t(cn),
                               V, True, "warp")
    _assert_close(ref, out)


def test_single_view_warp_raw_score(example):
    """One view's raw warp score and in-bounds mask, as the JAX package's
    ``_score_one_view_warp`` compiled alone gives them."""
    data, st, jo, po, key = example
    cd, cn, _ = jpm._build_candidates(st, data, jo, key, 0, 3, "warp", 8, fold=2)
    den = jnp.einsum("chwk,hwk->chw", cn, data.X0) * cd
    safe = jnp.abs(den) > 1e-12
    inv_nd = jnp.where(safe, 1.0 / jnp.where(safe, den, 1.0), 0.0)
    j = 1
    ref, rinb = jax.jit(lambda d, n, i: jpm._score_one_view_warp(
        data, jo, d, n, i, data.views.image[j], data.views.size[j],
        data.views.Hl[j], data.views.Hm[j]))(cd, cn, inv_nd)
    pd = port_data(data)
    out, inb = tpm._score_one_view_warp(
        pd, po, t(cd), t(cn), t(inv_nd), pd.views.image[j], pd.views.size[j],
        pd.views.Hl[j], pd.views.Hm[j])
    np.testing.assert_array_equal(inb.numpy(), np.asarray(rinb))
    _assert_close(ref, out)


def test_two_warp_sweeps_match_jax(example):
    data, st, jo, po, key = example
    js = st
    ps = port_state(st)
    pd = port_data(data)
    for it in range(2):
        jk = jax.random.fold_in(key, it + 7)
        pk = rng.fold_in(_key(key), it + 7)
        for parity in (0, 1):
            js = jpm.sweep_half(js, data, jo, jk, V, mode="warp", parity=parity)
            ps = tpm.sweep_half(ps, pd, po, pk, V, mode="warp", parity=parity)
    share = equal_share(js, ps)
    assert share >= 0.999, share
    # the sweeps moved the state: a warp sweep is not a no-op
    assert (np.asarray(js.conf) < np.asarray(st.conf)).mean() > 0.01


def test_warp_rejects_band_flags(example):
    data, st, jo, po, key = example
    pd, ps = port_data(data), port_state(st)
    flags = torch.ones(-(-H // 16), dtype=torch.bool)
    with pytest.raises(ValueError, match="band skipping"):
        tpm.score_hypotheses(pd, po, ps, ps.depth[None], ps.normal[None], V, False,
                             "warp", band_act=flags)
