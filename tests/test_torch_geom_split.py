"""The port's split and unfused geometric sweeps.

``OMVS_GEOM_SPLIT`` (``1`` or ``xla``) splits a geometric sweep into
candidates, the geometric terms of all views (K3-mv), and scoring with the
terms precomputed plus selection; ``OMVS_GEOM_FUSED=0`` computes the terms
with K3-mv in place of the scorer's fused term (K2-mv). On a
96x128 example with two neighbour views and neighbour depth maps with
holes (``make_case(geom=True)``):

- the split sweep against the JAX package's split sweep under
  ``OMVS_GEOM_SPLIT=xla`` (the JAX package runs ``1`` as its fused sweep on
  the CPU, as ``1`` needs its Pallas kernel): at least 99.9% of pixels in
  the same state, as in ``tests/test_torch_sweep.py``;
- ``_geom_all_views`` against the JAX package's (K3's tolerance, at least
  99.5% within 1e-3) and ``score_hypotheses(geom_terms=...)`` against the
  JAX package's (K1's tolerance, as in test_torch_score_hypotheses.py);
- the split and unfused routes against the port's default, bit for bit,
  one sweep at a time and for a whole ``dense_reconstruction``.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_helpers import (SLICE_OPTS, equal_share, make_case,  # noqa: E402
                            port_data, port_state, t)

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch import densify as pdens  # noqa: E402
from openmvs_tpu_torch.config import DenseOptions  # noqa: E402
from openmvs_tpu_torch.io import dmap as pdmap  # noqa: E402
from openmvs_tpu_torch.ops import patchmatch as tpm  # noqa: E402
from openmvs_tpu_torch.ops import pm_kernel  # noqa: E402
from openmvs_tpu_torch.synthetic import build_gt_scene  # noqa: E402

torch.set_num_threads(1)

H, W, V = 96, 128, 2
ROUTES = {"split": {"OMVS_GEOM_SPLIT": "1"}, "split-xla": {"OMVS_GEOM_SPLIT": "xla"},
          "unfused": {"OMVS_GEOM_FUSED": "0"}}


@pytest.fixture(autouse=True)
def _default_routes(monkeypatch):
    for k in ("OMVS_GEOM_SPLIT", "OMVS_GEOM_FUSED", "OMVS_GEOM_DEBUG"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def case():
    data, state, jo, po, _ = make_case(H, W, V, geom=True)
    key = jax.random.PRNGKey(5)
    st = jpm.sweep(state, data, jo, key, V, mode="nn", fold=1, use_geom=True)
    return data, st, jo, po, key


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


def _candidates(case):
    data, st, jo, _, key = case
    cd, cn, cok = jpm._build_candidates(st, data, jo, key, 0, 3, "exact", 8)
    return cd, cn, cok


@pytest.mark.parametrize("rescore", [False, True])
def test_split_sweep_matches_jax_split(case, monkeypatch, rescore):
    data, st, jo, po, key = case
    monkeypatch.setenv("OMVS_GEOM_SPLIT", "xla")
    js = jpm.sweep(st, data, jo, key, V, use_geom=True, mode="exact", fold=2,
                   rescore_state=rescore)
    monkeypatch.setenv("OMVS_GEOM_SPLIT", "1")
    ps = tpm.sweep(port_state(st), port_data(data), po, _key(key), V,
                   use_geom=True, mode="exact", fold=2, rescore_state=rescore,
                   switches=tpm.Switches.from_env())
    share = equal_share(js, ps)
    assert share >= 0.999, share


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("mode", ["exact", "nn"])
def test_route_equals_default_sweep(case, monkeypatch, route, mode):
    data, st, _, po, key = case
    pd, ps = port_data(data), port_state(st)
    base = tpm.sweep(ps, pd, po, _key(key), V, use_geom=True, mode=mode,
                     fold=2, rescore_state=True)
    for k, val in ROUTES[route].items():
        monkeypatch.setenv(k, val)
    other = tpm.sweep(ps, pd, po, _key(key), V, use_geom=True, mode=mode,
                      fold=2, rescore_state=True, switches=tpm.Switches.from_env())
    for a, b in zip(base, other):
        assert torch.equal(a, b)


def test_geom_all_views_matches_jax(case, capsys, monkeypatch):
    data, *_ = case
    cd, _, _ = _candidates(case)
    ref = np.asarray(jpm._geom_all_views(data, V, cd))
    monkeypatch.setenv("OMVS_GEOM_DEBUG", "1")
    out = tpm._geom_all_views(port_data(data), V, t(cd), tpm.Switches.from_env()).numpy()
    assert out.shape == ref.shape == (V,) + tuple(cd.shape)
    d = np.abs(out - ref)
    assert (d < 1e-3).mean() >= 0.995, ((d < 1e-3).mean(), d.max())
    # on CPU tensors the term is the plain version: the debug comparison
    # against it finds nothing
    assert "frac>0.1: 0.0000" in capsys.readouterr().out


def test_score_hypotheses_with_geom_terms_matches_jax(case):
    data, st, jo, po, _ = case
    cd, cn, _ = _candidates(case)
    g = jpm._geom_all_views(data, V, cd)
    ref = np.asarray(jax.jit(lambda s, d, n, gt: jpm.score_hypotheses(
        data, jo, s, d, n, V, True, "exact", geom_terms=gt))(st, cd, cn, g))
    pd, ps = port_data(data), port_state(st)
    out = tpm.score_hypotheses(pd, po, ps, t(cd), t(cn), V, True, "exact",
                               geom_terms=t(g))
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(out.numpy()))
    d = np.abs(out.numpy() - ref)[fin]
    assert (d < 1e-3).mean() >= 0.999 and d.max() < 1e-2, ((d < 1e-3).mean(), d.max())
    # the port's own terms give its default (K2) scores
    own = tpm.score_hypotheses(pd, po, ps, t(cd), t(cn), V, True, "exact",
                               geom_terms=tpm._geom_all_views(pd, V, t(cd)))
    base = tpm.score_hypotheses(pd, po, ps, t(cd), t(cn), V, True, "exact")
    torch.testing.assert_close(own, base, rtol=0, atol=0, equal_nan=True)


def _counting(monkeypatch):
    """Count calls of the kernel wrappers, by name and candidate count: the
    multi-view scorer by its geometric mode (``score_views`` with no term,
    ``score_views_geom`` fused, ``score_views_pre`` precomputed), K3-mv and
    the per-view K3."""
    calls = {}

    def count(key):
        calls[key] = calls.get(key, 0) + 1

    views, geom_term = pm_kernel.score_views, pm_kernel.geom_term
    geom_terms = pm_kernel.geom_terms

    def counted_views(*a, **kw):
        mode = ("_geom" if kw.get("dms") is not None else
                "_pre" if kw.get("geom_terms") is not None else "")
        count((f"score_views{mode}", a[4].shape[0]))
        return views(*a, **kw)

    def counted_geom_term(*a, **kw):
        count(("geom_term", a[6].shape[0]))
        return geom_term(*a, **kw)

    def counted_geom_terms(*a, **kw):
        count(("geom_terms", a[6].shape[0]))
        return geom_terms(*a, **kw)

    monkeypatch.setattr(pm_kernel, "score_views", counted_views)
    monkeypatch.setattr(pm_kernel, "geom_term", counted_geom_term)
    monkeypatch.setattr(pm_kernel, "geom_terms", counted_geom_terms)
    return calls


def test_geometric_map_routes_under_split(case, monkeypatch):
    """A geometric map's estimation (init_state, then one exact sweep of
    C=11 candidates) under OMVS_GEOM_SPLIT=1 scores the incumbent with the
    fused multi-view scorer (K2-mv) once, then per parity runs K3-mv once
    for all views and the scorer once with the terms precomputed."""
    data, st, _, po, key = case
    pd = port_data(data)
    calls = _counting(monkeypatch)
    monkeypatch.setenv("OMVS_GEOM_SPLIT", "1")
    sw = tpm.Switches.from_env()
    state = tpm.init_state(pd, po, _key(key), st.depth, st.normal, V, True,
                           mode="exact", switches=sw)
    tpm.sweep(state, pd, po, _key(key), V, True, n_perturb=3, mode="exact",
              n_prop=8, fold=1, switches=sw)
    assert calls == {("score_views_geom", 1): 1, ("geom_terms", 11): 2,
                     ("score_views_pre", 11): 2}


def _maps(folder, n):
    return [pdmap.load(os.path.join(folder, f"depth{i:04d}.dmap")).depth
            for i in range(n)]


def test_dense_reconstruction_split_equals_default(tmp_path, monkeypatch):
    """The 120x160 slice scene (3 views, one sub-resolution level, one
    geometric pass) gives the same depth maps under the split sweep, which
    runs K3-mv twice in each geometric map (once per parity, all views at
    once) and the per-view K3 never."""
    scene, _, _ = build_gt_scene(n_views=3, W=160, H=120)
    opts = DenseOptions(**SLICE_OPTS)
    pdens.dense_reconstruction(scene, opts, save_dmaps_to=str(tmp_path / "default"),
                               device="cpu")
    calls = _counting(monkeypatch)
    monkeypatch.setenv("OMVS_GEOM_SPLIT", "1")
    pdens.dense_reconstruction(scene, opts, save_dmaps_to=str(tmp_path / "split"),
                               device="cpu")
    n_nbrs = [len(im.meta.view_scores) for im in scene.images]
    geo = opts.estimation_geometric_iters
    k3 = sum(n for (name, _), n in calls.items() if name == "geom_terms")
    k3_per_view = sum(n for (name, _), n in calls.items() if name == "geom_term")
    k2 = sum(n for (name, _), n in calls.items() if name == "score_views_geom")
    assert all(n_nbrs)
    assert (k3, k3_per_view, k2) == (geo * 2 * len(n_nbrs), 0, geo * len(n_nbrs))
    for a, b in zip(_maps(tmp_path / "default", 3), _maps(tmp_path / "split", 3)):
        np.testing.assert_array_equal(a, b)
