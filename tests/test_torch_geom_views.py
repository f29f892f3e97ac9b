"""The port's multi-view geometric kernel K3-mv (``pm_kernel.geom_terms``)
on CPU tensors, where it runs its plain version ``geom_terms_plain``:

- ``geom_terms_plain`` is the stack of the per-view ``geom_term_plain`` bit
  for bit (the kernel calls K3's ``pm::geom_cons`` for every element, so
  the split and unfused sweeps stay bit-identical to the default);
- ``_geom_all_views``, which routes through it, against the JAX package's
  ``_geom_all_views`` (its XLA term) on the same numpy inputs, at K3's
  tolerance (at least 99.5% within 1e-3, as
  ``test_torch_geom_split.py::test_geom_all_views_matches_jax``);
- a CPU tensor counts no launch, and the wrapper's operand checks raise.

Inputs: ``make_case(geom=True)`` with four neighbour views (depth maps with
20% holes) and sloped candidate depths with 7% zeros, passed raw.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_helpers import candidates, make_case, port_data, t  # noqa: E402

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch.ops import patchmatch as tpm  # noqa: E402
from openmvs_tpu_torch.ops import pm_kernel as tk  # noqa: E402

torch.set_num_threads(1)

H, W, V_MAX = 96, 128, 4


@pytest.fixture(scope="module")
def case():
    """(JAX data, port data, raw candidate depths (3, H, W) as numpy)."""
    data, state, _, _, _ = make_case(H, W, V_MAX, geom=True)
    cd, _, _ = candidates(data, state, slope=True, holes=True)
    return data, port_data(data), cd


def _views(pd, V):
    v = pd.views
    return (v.depth[:V], v.size[:V], v.Tl[:V], v.Tm[:V], v.Tr[:V], v.Tn[:V])


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("V", [1, 4])
def test_geom_terms_plain_is_the_per_view_stack(case, C, V):
    _, pd, cd = case
    depth = t(cd[:C])
    assert (depth == 0).any()
    dms, sizes, Tl, Tm, Tr, Tn = _views(pd, V)
    out = tk.geom_terms_plain(dms, sizes, Tl, Tm, Tr, Tn, depth, pd.X0, pd.uv)
    ref = torch.stack([tk.geom_term_plain(dms[j], sizes[j], Tl[j], Tm[j], Tr[j],
                                          Tn[j], depth, pd.X0, pd.uv)
                       for j in range(V)])
    assert out.shape == (V, C, H, W)
    assert torch.equal(out, ref)
    # zero (invalid) depths are never consistent; valid ones partly are
    assert (out[:, depth == 0] == 4.0).all()
    assert (out < 4.0).float().mean() > 0.05


@pytest.mark.parametrize("C", [1, 3])
def test_geom_all_views_matches_jax_at_four_views(case, C):
    data, pd, cd = case
    ref = np.asarray(jpm._geom_all_views(data, V_MAX, cd[:C]))
    out = tpm._geom_all_views(pd, V_MAX, t(cd[:C])).numpy()
    assert out.shape == ref.shape == (V_MAX, C, H, W)
    d = np.abs(out - ref)
    assert (d < 1e-3).mean() >= 0.995, ((d < 1e-3).mean(), d.max())


def test_geom_terms_on_cpu_runs_plain_without_a_launch(case):
    _, pd, cd = case
    args = (*_views(pd, V_MAX), t(cd), pd.X0, pd.uv)
    tk.reset_launches()
    out = tk.geom_terms(*args)
    assert all(n == 0 for n in tk.LAUNCHES.values())
    assert torch.equal(out, tk.geom_terms_plain(*args))


def _operands(V=2, C=2, h=6, w=8):
    return dict(dms=torch.ones(V, h, w), sizes=torch.tensor([[h, w]] * V, dtype=torch.float32),
                Tl=torch.eye(3).repeat(V, 1, 1), Tm=torch.zeros(V, 3),
                Tr=torch.eye(3).repeat(V, 1, 1), Tn=torch.zeros(V, 3),
                depth=torch.ones(C, h, w), X0=torch.ones(h, w, 3), uv=torch.zeros(h, w, 2))


@pytest.mark.parametrize("name,bad,err", [
    ("depth", torch.ones(2, 6, 8, dtype=torch.float64), TypeError),
    ("depth", torch.ones(6, 8), ValueError),
    ("dms", torch.ones(6, 8), ValueError),
    ("dms", torch.ones(13, 6, 8), ValueError),
    ("sizes", torch.ones(3, 2), ValueError),
    ("Tl", torch.eye(3).repeat(2, 1, 1).transpose(1, 2), ValueError),
    ("Tn", torch.zeros(2, 3, device="meta"), ValueError),
    ("uv", torch.zeros(8, 6, 2).transpose(0, 1), ValueError),
])
def test_geom_terms_operand_checks_raise(name, bad, err):
    ops = _operands()
    tk.check_geom_views_operands(**ops)
    ops[name] = bad
    with pytest.raises(err, match=name):
        tk.geom_terms(**ops)


def test_geom_terms_takes_up_to_max_views():
    ops = _operands(V=12)
    tk.check_geom_views_operands(**ops)
    assert tk.geom_terms(**ops).shape == (12, 2, 6, 8)


def test_geom_terms_needs_cpu_or_cuda_tensors():
    ops = {k: v.to("meta") for k, v in _operands().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.geom_terms(**ops)
