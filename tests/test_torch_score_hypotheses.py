"""``score_hypotheses`` of the port (smoothness bonus, geometric weight,
low-res prior blend, clip at 2.0, min-mean of the best two views) against
the JAX package's, compiled as the sweep compiles it, on the candidate set
of a real sweep: K1's tolerance, at least 99.9% of pixels within 1e-3 and
none off by 1e-2."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import make_case, port_data, port_state, t  # noqa: E402

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch.ops import patchmatch as tpm  # noqa: E402

torch.set_num_threads(1)


def _case(geom, lowres):
    data, state, jo, po, _ = make_case(72, 96, 2, geom=geom, lowres=lowres)
    key = jax.random.PRNGKey(5)
    st = jpm.sweep(state, data, jo, key, 2, mode="nn", fold=1, use_geom=geom)
    cands = (jpm._prop_cand_list(data, st, jo, 8)
             + jpm._perturb_cand_list(data, st, jo, key, 0, 3, "nn"))
    cd, cn, _ = jpm._stack_cands(cands)
    return data, st, jo, po, cd, cn


def _assert_close(a, b):
    a, b = np.asarray(a), b.numpy()
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b))
    d = np.abs(a - b)[fin]
    assert (d < 1e-3).mean() >= 0.999 and d.max() < 1e-2, ((d < 1e-3).mean(), d.max())


@pytest.mark.parametrize("geom,lowres,mode", [
    (False, False, "nn"), (False, True, "exact"),
    (True, False, "exact"), (True, True, "nn"),
])
def test_score_hypotheses_matches_jax(geom, lowres, mode):
    data, st, jo, po, cd, cn = _case(geom, lowres)
    ref = jax.jit(lambda s, d, n: jpm.score_hypotheses(
        data, jo, s, d, n, 2, geom, mode))(st, cd, cn)
    out = tpm.score_hypotheses(port_data(data), po, port_state(st), t(cd), t(cn),
                               2, geom, mode)
    _assert_close(ref, out)


def test_smoothness_bonus_matches_jax():
    data, st, jo, po, cd, cn = _case(False, False)
    ref = jax.jit(lambda s, d, n: jpm._smoothness_bonus(data, jo, s, d, n))(st, cd, cn)
    out = tpm._smoothness_bonus(port_data(data), po, port_state(st), t(cd), t(cn))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_single_view_and_padded_slot():
    """n_views=1 returns the one view's score; a padded neighbour slot
    (size (0, 0)) pins to the 2.0 clip and never enters the min-mean."""
    data, st, jo, po, cd, cn = _case(False, False)
    pd, ps = port_data(data), port_state(st)
    one = tpm.score_hypotheses(pd, po, ps, t(cd), t(cn), 1, False, "exact")
    ref = jax.jit(lambda s, d, n: jpm.score_hypotheses(
        data, jo, s, d, n, 1, False, "exact"))(st, cd, cn)
    _assert_close(ref, one)
    padded = pd._replace(views=pd.views._replace(
        size=torch.stack([pd.views.size[0], torch.zeros(2)])))
    both = tpm.score_hypotheses(padded, po, ps, t(cd), t(cn), 2, False, "exact")
    # min-mean averages the best two only if the second is below th_robust;
    # the padded slot is 2.0, so the result is the real view's score (NaN
    # where the candidate is degenerate, in both)
    torch.testing.assert_close(both, one, rtol=0, atol=0, equal_nan=True)
