"""The port's scorer kernels K1 (``score_view``) and K2 (``score_view_geom``)
on CPU tensors, where they run their plain versions, against the JAX
package: its XLA CPU path (``_score_one_view_scan`` and
``_geometric_term``, compiled as the sweep compiles them) and its Pallas
kernels in interpret mode. Inputs are those of ``tests/test_pm_kernel.py``:
``__graft_entry__._make_example`` with three candidate planes, and for K2
sloped candidates with holes against a neighbour depth map with holes.

Tolerances: K1 at least 99.9% of depth>0 pixels within 1e-3 and none off
by 1e-2 (test_pm_kernel.py:57-60); K2's cons at least 99.5% within 1e-3
(test_pm_kernel.py:153-157). Against the Pallas kernels, pixels whose warp
leaves the kernel's patch window (a TPU layout artefact the port does not
have) are allowed for by the 99.5% share.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import example as _example  # noqa: E402
from _torch_helpers import geom_case as _geom_case  # noqa: E402
from _torch_helpers import inv_nd as _inv_nd  # noqa: E402
from _torch_helpers import port_data, t  # noqa: E402

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch.ops import pm_kernel as tk  # noqa: E402

torch.set_num_threads(1)


def _port_args(data, cd, cn, inv_nd, j=0):
    pd = port_data(data)
    v = pd.views
    return pd, (v.image[j], v.size[j], v.Hl[j], v.Hm[j], t(cd), t(cn), t(inv_nd),
                pd.X0, pd.goff, pd.w, pd.wtm, pd.sum_w, pd.norm_sq0)


def _assert_k1(out, ref, valid, share=0.999):
    d = np.abs(out - ref)[valid]
    within = (d < 1e-3).mean()
    assert within >= share and d.max() < 1e-2, (within, d.max())


@pytest.mark.parametrize("mode", ["exact", "nn"])
def test_k1_plain_matches_xla_scan(mode):
    data, opts, cd, cn = _example()
    inv_nd = _inv_nd(cn, data.X0, cd)
    v = data.views
    ref = np.asarray(jax.jit(lambda *a: jpm._score_one_view_scan(
        data, opts, *a, exact=mode == "exact")[0])(
            cd, cn, inv_nd, v.image[0], v.size[0], v.Hl[0], v.Hm[0]))
    _, args = _port_args(data, cd, cn, inv_nd)
    out = tk.score_view(*args, th_robust=float(opts.th_robust),
                        nearest=mode == "nn").numpy()
    _assert_k1(out, ref, np.asarray(cd) > 0)


@pytest.mark.parametrize("mode", ["exact", "nn"])
def test_k2_plain_matches_xla(mode):
    data, opts, cd, cn, dm = _geom_case()
    inv_nd = _inv_nd(cn, data.X0, cd)
    v = data.views
    exact = mode == "exact"
    ref_s = np.asarray(jax.jit(lambda *a: jpm._score_one_view_scan(
        data, opts, *a, exact=exact)[0])(
            cd, cn, inv_nd, v.image[0], v.size[0], v.Hl[0], v.Hm[0]))
    ref_c = np.asarray(jax.jit(lambda *a: jpm._geometric_term(
        data, opts, *a, force_xla=True))(cd, dm, v.size[0], v.Tl[0], v.Tm[0],
                                         v.Tr[0], v.Tn[0]))
    pd, args = _port_args(data, cd, cn, inv_nd)
    pv = pd.views
    img, size, Hl, Hm, depth, normal, ind, X0, goff, w, wtm, sum_w, nsq0 = args
    s, cons = tk.score_view_geom(img, size, Hl, Hm, pv.Tr[0], pv.Tn[0], t(dm),
                                 depth, normal, ind, X0, pd.uv, goff, w, wtm,
                                 sum_w, nsq0, th_robust=float(opts.th_robust),
                                 nearest=not exact)
    valid = np.asarray(cd) > 0
    _assert_k1(s.numpy(), ref_s, valid)
    d = np.abs(cons.numpy() - ref_c)
    assert (d < 1e-3).mean() >= 0.995, ((d < 1e-3).mean(), d.max())
    # the port's K2 and K1 give the same score
    k1 = tk.score_view(*args, th_robust=float(opts.th_robust), nearest=not exact)
    assert torch.equal(k1, s)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode with float32 images
    (as tests/test_pm_kernel.py runs them without a TPU)."""
    from openmvs_tpu.ops import pm_kernel

    monkeypatch.setattr(pm_kernel, "INTERPRET", True)
    monkeypatch.setattr(pm_kernel, "BF16_IMG", False)
    fns = (pm_kernel._score_view_pallas, pm_kernel._score_view_geom_pallas)
    for f in fns:
        f._clear_cache()
    yield pm_kernel
    for f in fns:
        f._clear_cache()


def test_k1_plain_matches_pallas_interpret(pallas_interpret):
    data, opts, cd, cn = _example()
    inv_nd = _inv_nd(cn, data.X0, cd)
    v = data.views
    ref = np.asarray(pallas_interpret.score_view_pallas(
        v.image[0], v.size[0], v.Hl[0], v.Hm[0], cd, cn, inv_nd, data.X0,
        data.goff, data.w, data.wtm, data.sum_w, data.norm_sq0,
        n_texels=int(data.goff.shape[0]), th_robust=float(opts.th_robust)))
    _, args = _port_args(data, cd, cn, inv_nd)
    out = tk.score_view(*args, th_robust=float(opts.th_robust)).numpy()
    _assert_k1(out, ref, np.asarray(cd) > 0, share=0.995)


def test_k2_plain_matches_pallas_interpret(pallas_interpret):
    data, opts, cd, cn, dm = _geom_case()
    # the Pallas path clamps depth to 1e-6 before the reciprocal; compare
    # on depth > 0, where that changes nothing
    inv_nd = _inv_nd(cn, data.X0, jnp.maximum(cd, 1e-6))
    v = data.views
    s_ref, c_ref = pallas_interpret.score_view_geom_pallas(
        v.image[0], v.size[0], v.Hl[0], v.Hm[0], v.Tr[0], v.Tn[0], dm, cd, cn,
        inv_nd, data.X0, data.uv, data.goff, data.w, data.wtm, data.sum_w,
        data.norm_sq0, n_texels=int(data.goff.shape[0]),
        th_robust=float(opts.th_robust), nearest=False)
    pd, args = _port_args(data, cd, cn, inv_nd)
    img, size, Hl, Hm, depth, normal, ind, X0, goff, w, wtm, sum_w, nsq0 = args
    s, cons = tk.score_view_geom(img, size, Hl, Hm, pd.views.Tr[0], pd.views.Tn[0],
                                 t(dm), depth, normal, ind, X0, pd.uv, goff, w,
                                 wtm, sum_w, nsq0, th_robust=float(opts.th_robust))
    valid = np.asarray(cd) > 0
    _assert_k1(s.numpy(), np.asarray(s_ref), valid, share=0.995)
    d = np.abs(cons.numpy() - np.asarray(c_ref))[valid]
    assert (d < 1e-3).mean() >= 0.995, ((d < 1e-3).mean(), d.max())
