"""The port's geometric kernel K3 (``pm_kernel.geom_term``) on CPU tensors,
where it runs its plain version, against the JAX package: its XLA term
(``_geometric_term(force_xla=True)``, jitted as the split sweep jits it)
and ``geom_term_pallas`` in interpret mode. Inputs are
``make_case(geom=True)``, two neighbour views with their cameras' geometric
transforms and depth maps with 20% holes, and three sloped candidate depth
maps with 7% zeros (invalid hypotheses, passed raw).

Tolerance: at least 99.5% of pixels within 1e-3 (test_pm_kernel.py:157).
Against the Pallas kernel the share also allows for its window misses
(a neutral 2.0 where a warp leaves the loaded depth window), a TPU layout
artefact the port does not have.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import candidates, make_case, port_data, t  # noqa: E402

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch.ops import patchmatch as tpm  # noqa: E402
from openmvs_tpu_torch.ops import pm_kernel as tk  # noqa: E402

torch.set_num_threads(1)


def _case():
    """(data, opts, cd, dms): the JAX data, the candidate depths and the
    neighbour depth maps."""
    data, state, opts, _, _ = make_case(96, 128, 2, geom=True)
    cd, _, _ = candidates(data, state, slope=True, holes=True)
    return data, opts, jnp.asarray(cd), data.views.depth


def _assert_cons(out, ref):
    d = np.abs(out - np.asarray(ref))
    within = (d < 1e-3).mean()
    assert within >= 0.995, (within, d.max())


def _xla_term(data, opts, cd, dm, j, Tl=None, Tm=None):
    v = data.views
    Tl = v.Tl[j] if Tl is None else Tl
    Tm = v.Tm[j] if Tm is None else Tm
    return np.asarray(jax.jit(lambda *a: jpm._geometric_term(
        data, opts, *a, force_xla=True))(cd, dm, v.size[j], Tl, Tm, v.Tr[j], v.Tn[j]))


def _port_term(pd, cd, dm, j, Tl=None, Tm=None):
    v = pd.views
    return tk.geom_term(t(dm), v.size[j], v.Tl[j] if Tl is None else t(Tl),
                        v.Tm[j] if Tm is None else t(Tm), v.Tr[j], v.Tn[j],
                        t(cd), pd.X0, pd.uv).numpy()


@pytest.mark.parametrize("j", [0, 1])
def test_geom_term_plain_matches_xla(j):
    data, opts, cd, dms = _case()
    dm = dms[j]
    ref = _xla_term(data, opts, cd, dm, j)
    pd = port_data(data)
    out = _port_term(pd, cd, dm, j)
    _assert_cons(out, ref)
    # a share of the candidates is consistent (penalty below 4)
    assert (out < 4.0).mean() > 0.05, (out < 4.0).mean()
    # the sweep's route to K3 computes the same term
    v = pd.views
    routed = tpm._geometric_term(pd, None, t(cd), t(dm), v.size[j], v.Tl[j],
                                 v.Tm[j], v.Tr[j], v.Tn[j])
    np.testing.assert_array_equal(routed.numpy(), out)
    # raw zero depths are never consistent
    assert (out[np.asarray(cd) == 0] == 4.0).all()


def test_geom_term_plain_matches_pallas_interpret(monkeypatch):
    from openmvs_tpu.ops import pm_kernel

    data, _, cd, dms = _case()
    dm = dms[0]
    v = data.views
    monkeypatch.setattr(pm_kernel, "INTERPRET", True)
    pm_kernel.geom_term_pallas._clear_cache()
    try:
        ref = np.asarray(pm_kernel.geom_term_pallas(
            dm, v.size[0], v.Tl[0], v.Tm[0], v.Tr[0], v.Tn[0], cd, data.X0, data.uv))
    finally:
        pm_kernel.geom_term_pallas._clear_cache()
    _assert_cons(_port_term(port_data(data), cd, dm, 0), ref)


def test_geom_term_takes_its_own_forward_transform():
    """K3 warps with the Tl/Tm it is given, not with the scorer's Hl/Hm
    (which K2 uses, as the two are equal in packed data)."""
    data, opts, cd, dms = _case()
    dm = dms[0]
    a = np.radians(0.5)
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                   np.float32)
    Tl = (np.asarray(data.views.Tl[0]) @ rot).astype(np.float32)
    Tm = (np.asarray(data.views.Tm[0]) * np.float32(1.02)).astype(np.float32)
    ref = _xla_term(data, opts, cd, dm, 0, jnp.asarray(Tl), jnp.asarray(Tm))
    pd = port_data(data)
    out = _port_term(pd, cd, dm, 0, Tl, Tm)
    _assert_cons(out, ref)
    # the changed transform changes the term, so the check above has teeth
    assert (np.abs(out - _port_term(pd, cd, dm, 0)) > 1e-3).mean() > 0.05


def _geom_operands(C=2, H=6, W=8):
    return dict(dm=torch.ones(H, W), size=torch.tensor([H, W], dtype=torch.float32),
                Tl=torch.eye(3), Tm=torch.zeros(3), Tr=torch.eye(3),
                Tn=torch.zeros(3), depth=torch.ones(C, H, W),
                X0=torch.ones(H, W, 3), uv=torch.zeros(H, W, 2))


@pytest.mark.parametrize("name,bad,err", [
    ("depth", torch.ones(2, 6, 8, dtype=torch.float64), TypeError),
    ("depth", torch.ones(6, 8), ValueError),
    ("X0", torch.ones(6, 8, 2), ValueError),
    ("uv", torch.zeros(8, 6, 2).transpose(0, 1), ValueError),
    ("dm", torch.ones(1, 6, 8), ValueError),
    ("Tl", torch.eye(4), ValueError),
    ("size", torch.ones(2, device="meta"), ValueError),
])
def test_geom_operand_checks_raise(name, bad, err):
    ops = _geom_operands()
    tk.check_geom_operands(**ops)
    ops[name] = bad
    with pytest.raises(err, match=name):
        tk.check_geom_operands(**ops)


def test_geom_term_needs_cpu_or_cuda_tensors():
    ops = {k: v.to("meta") for k, v in _geom_operands().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.geom_term(**ops)
