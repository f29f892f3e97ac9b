"""The port's multi-view scorer (``pm_kernel.score_views``: K1-mv, and
K2-mv with the fused geometric term) on CPU tensors, where it runs its
plain version ``score_views_plain``, against the JAX package's
``score_hypotheses``, compiled as the sweep compiles it, on the candidate
set of a real sweep (``make_case(geom=True)``: two neighbour views with
depth maps with holes, 72x96). Cases cover nn and exact sampling, the three
geometric modes (none, fused, precomputed), one and two views, a padded
view slot and a low-res prior.

Tolerance: K1's (test_pm_kernel.py:57-60), at least 99.9% of pixels within
1e-3, none off by 1e-2, and the same finite/NaN pattern (degenerate
candidates score NaN in both).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import make_case, port_data, port_state, t  # noqa: E402

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch.config import DenseOptions  # noqa: E402
from openmvs_tpu_torch.ops import patchmatch as tpm  # noqa: E402
from openmvs_tpu_torch.ops import pm_kernel as tk  # noqa: E402

torch.set_num_threads(1)

H, W, V = 72, 96, 2


@pytest.fixture(scope="module")
def cases():
    """case(lowres) -> (data, state, opts_jax, opts_port, cd, cn): the state
    after one geometric nn sweep and its 11 candidates, built once each."""
    built = {}

    def case(lowres):
        if lowres not in built:
            data, state, jo, po, _ = make_case(H, W, V, geom=True, lowres=lowres)
            key = jax.random.PRNGKey(5)
            st = jpm.sweep(state, data, jo, key, V, mode="nn", fold=1, use_geom=True)
            cands = (jpm._prop_cand_list(data, st, jo, 8)
                     + jpm._perturb_cand_list(data, st, jo, key, 0, 3, "nn"))
            cd, cn, _ = jpm._stack_cands(cands)
            built[lowres] = (data, st, jo, po, cd, cn)
        return built[lowres]

    return case


def _padded(data):
    """The JAX data with neighbour slot 1 padded (size (0, 0))."""
    v = data.views
    return data._replace(views=v._replace(size=v.size.at[1].set(0.0)))


def _port_operands(pd, po, ps, cd, cn, n_views, geom, g):
    """score_views' operands as score_hypotheses computes them."""
    cd, cn = t(cd), t(cn)
    inv_nd, bonus, f_blend, delta = tpm.score_prelude(pd, po, ps, cd, cn)
    v, n = pd.views, n_views
    args = (v.image[:n], v.size[:n], v.Hl[:n], v.Hm[:n], cd, cn, inv_nd, pd.X0,
            pd.goff, pd.w, pd.wtm, pd.sum_w, pd.norm_sq0, bonus, f_blend,
            delta, pd.lowres)
    kw = dict(th_robust=float(po.th_robust),
              geom_weight=float(po.estimation_geometric_weight))
    if geom == "fused":
        kw.update(Tr=v.Tr[:n], Tn=v.Tn[:n], dms=v.depth[:n], uv=pd.uv)
    elif geom == "pre":
        kw.update(geom_terms=t(g[:n]))
    return args, kw


def _assert_k1(ref, out):
    a, b = np.asarray(ref), out.numpy()
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b))
    d = np.abs(a - b)[fin]
    assert (d < 1e-3).mean() >= 0.999 and d.max() < 1e-2, ((d < 1e-3).mean(), d.max())


@pytest.mark.parametrize("mode,geom,n_views,lowres,padded", [
    ("nn", "none", 2, True, False),
    ("exact", "none", 1, False, False),
    ("exact", "none", 2, False, True),
    ("exact", "fused", 2, True, False),
    ("nn", "fused", 1, False, False),
    ("exact", "pre", 2, False, False),
    ("nn", "pre", 2, True, True),
])
def test_score_views_plain_matches_jax(cases, mode, geom, n_views, lowres, padded):
    data, st, jo, po, cd, cn = cases(lowres)
    if padded:
        data = _padded(data)
    use_geom = geom != "none"
    g = np.asarray(jpm._geom_all_views(data, n_views, cd)) if geom == "pre" else None
    ref = jax.jit(lambda s, d, n, gt: jpm.score_hypotheses(
        data, jo, s, d, n, n_views, use_geom, mode, geom_terms=gt))(
            st, cd, cn, None if g is None else jnp.asarray(g))
    pd, ps = port_data(data), port_state(st)
    args, kw = _port_operands(pd, po, ps, cd, cn, n_views, geom, g)
    out = tk.score_views_plain(*args, nearest=mode == "nn", **kw)
    assert out.shape == tuple(cd.shape)
    _assert_k1(ref, out)
    if padded:
        # the padded slot pins to 2.0 and never enters the min-mean: the
        # aggregate is the real view's score
        one, kw1 = _port_operands(pd, po, ps, cd, cn, 1, geom, g)
        alone = tk.score_views_plain(*one, nearest=mode == "nn", **kw1)
        torch.testing.assert_close(out, alone, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("route", ["none", "fused", "pre", "unfused"])
def test_score_hypotheses_is_score_views_plain(cases, monkeypatch, route):
    """score_hypotheses on CPU tensors returns exactly what the plain
    version returns, on each route (``unfused``: OMVS_GEOM_FUSED=0, where
    K3's plain version computes the terms first)."""
    monkeypatch.delenv("OMVS_GEOM_FUSED", raising=False)
    data, st, _, po, cd, cn = cases(True)
    pd, ps = port_data(data), port_state(st)
    geom = {"unfused": "pre"}.get(route, route)
    g = tpm._geom_all_views(pd, V, t(cd)).numpy() if geom == "pre" else None
    args, kw = _port_operands(pd, po, ps, cd, cn, V, geom, g)
    plain = tk.score_views_plain(*args, nearest=False, **kw)
    if route == "unfused":
        monkeypatch.setenv("OMVS_GEOM_FUSED", "0")
    out = tpm.score_hypotheses(pd, po, ps, t(cd), t(cn), V, geom != "none", "exact",
                               geom_terms=t(g) if route == "pre" else None,
                               switches=tpm.Switches.from_env())
    torch.testing.assert_close(out, plain, rtol=0, atol=0, equal_nan=True)


def _tiny_operands(C=2, H=24, W=32, n_views=2):
    """score_views' operands on a tiny random scene, port only."""
    opts = DenseOptions()
    r = np.random.default_rng(0)
    K = np.array([[28.0, 0, W / 2], [0, 28.0, H / 2], [0, 0, 1]])
    Kinv = np.linalg.inv(K)
    offs = tpm.texel_offsets(opts)
    goff = np.concatenate([offs, np.zeros((len(offs), 1), np.float32)], -1) @ Kinv.T
    z33, z3 = np.zeros((n_views, 3, 3)), np.zeros((n_views, 3))
    pd = tpm.pack_pm_data(
        opts, r.uniform(0, 1, (H, W)), r.uniform(0, 1, (n_views, H, W)),
        [[H, W]] * n_views, np.stack([K] * n_views), [[2.0, 0.0, 0.0]] * n_views,
        np.full((n_views, H, W), 5.0), z33, z3, z33, z3,
        Kinv.T.astype(np.float32), goff, 2.0, 10.0, np.zeros((H, W)),
        np.ones((H, W), bool), device="cpu")
    depth = torch.full((C, H, W), 5.0)
    normal = torch.zeros(C, H, W, 3)
    normal[..., 2] = -1.0
    state = tpm.PMState(depth=depth[0], normal=normal[0], conf=torch.zeros(H, W))
    args, kw = _port_operands(pd, opts, state, depth.numpy(), normal.numpy(),
                              n_views, "fused", None)
    return list(args), kw


_ARGS = ("images", "sizes", "Hl", "Hm", "depth", "normal", "inv_nd", "X0", "goff",
         "w", "wtm", "sum_w", "norm_sq0", "bonus", "f_blend", "delta", "d0")


@pytest.mark.parametrize("name,bad,err", [
    ("bonus", lambda a: a[:, :-1], ValueError),                  # shape
    ("delta", lambda a: a.double(), TypeError),                  # dtype
    ("images", lambda a: a[:1].expand(13, -1, -1).contiguous(), ValueError),  # 13 views
    ("d0", lambda a: torch.empty(a.shape, device="meta"), ValueError),    # device
    ("normal", lambda a: a.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),                                              # not contiguous
    ("dms", lambda a: None, ValueError),                         # fused term incomplete
    ("geom_terms", lambda a: torch.zeros(2, 2, 24, 32), ValueError),  # and fused too
])
def test_score_views_rejects_bad_operands(name, bad, err):
    args, kw = _tiny_operands()
    if name in _ARGS:
        i = _ARGS.index(name)
        args[i] = bad(args[i])
    else:
        kw[name] = bad(kw.get(name))
    if name == "images":
        # the stacks agree with the 13 images; only the count is wrong
        args[1] = args[1][:1].expand(13, 2).contiguous()
        args[2] = args[2][:1].expand(13, 3, 3).contiguous()
        args[3] = args[3][:1].expand(13, 3).contiguous()
        kw = {k: v for k, v in kw.items() if k in ("th_robust", "geom_weight")}
    with pytest.raises(err):
        tk.score_views(*args, **kw)


def test_score_views_on_cpu_is_plain_and_counts_no_launch():
    args, kw = _tiny_operands()
    tk.reset_launches()
    out = tk.score_views(*args, **kw)
    assert all(n == 0 for n in tk.LAUNCHES.values())
    torch.testing.assert_close(out, tk.score_views_plain(*args, **kw),
                               rtol=0, atol=0, equal_nan=True)
    assert out.shape == (2, 24, 32) and torch.isfinite(out).all()
    # tensors on neither the CPU nor a card
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]
    kw_meta = {k: (torch.empty(v.shape, device="meta") if torch.is_tensor(v) else v)
               for k, v in kw.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.score_views(*meta, **kw_meta)
