"""Convergence skipping of the port (``OMVS_ACTIVE``: ``patchmatch._band_flags``,
``sweep(active_eps=, conf_prev=)``, the scorer's ``band_act``) against the
JAX package's per-tile skipping (``_score_select``'s ``tile_act``,
tests/test_active_blocks.py), on the CPU.

The JAX package flags 8-row tiles of its row-pair compacted lattice; the
port scores the full lattice, so its unit is the band of 16 image rows that
such a tile covers. The contract, in the port's form of
tests/test_active_blocks.py's three tests:

- eps = -1 keeps every band active and is bit-identical to no skipping;
- with a realistic eps, pixels change only in bands whose churn exceeded
  eps, confidence never rises, and quiescent bands are frozen;
- the plain scorer gives a flagged-off band's pixels the defined sentinel
  (every view's raw score th_robust, geometric term 0, then finish_view and
  the min-mean), and a flagged-on band exactly the unflagged scores.

The flags equal the JAX package's tile flags, computed on its compacted
lattice. Then one view's ``estimate_depth_map`` under ``OMVS_ACTIVE``
(``OMVS_EARLY_EXIT=0``, so that search sweeps run one by one and can skip)
is held against the JAX package's under ``OMVS_COMPACT=1`` with the same
eps. The floor: on this scene the JAX package under ``OMVS_COMPACT=1``
equals itself under ``OMVS_COMPACT=0`` (agreement 1.0, measured in the
test), so compaction adds nothing to the port's gap, and the test holds the
slice tests' floor (masks above 99%, depths to 1e-3 on more than 98.5%;
the JAX package's one-ulp self-agreement, tests/_torch_parity_floor.py). At
eps 5e-3 no band of this scene is quiescent; at eps 0.05 both packages skip
and both move the same way (by 2.5% of pixels).
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import (SLICE_OPTS, depth_agreement, jax_scene,  # noqa: E402
                            make_case, port_data, port_state, t)

from openmvs_tpu import densify as jd  # noqa: E402
from openmvs_tpu.config import DenseOptions as JaxOptions  # noqa: E402
from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu.view_selection import select_views_for_scene as jax_select  # noqa: E402
from openmvs_tpu_torch import densify as pdens  # noqa: E402
from openmvs_tpu_torch.config import DenseOptions  # noqa: E402
from openmvs_tpu_torch.ops import patchmatch as tpm  # noqa: E402
from openmvs_tpu_torch.ops import pm_kernel  # noqa: E402
from openmvs_tpu_torch.synthetic import build_gt_scene  # noqa: E402
from openmvs_tpu_torch.utils import rng  # noqa: E402
from openmvs_tpu_torch.view_selection import select_views_for_scene  # noqa: E402

torch.set_num_threads(1)

H, W, V = 96, 128, 2


def _run(pd, ps, po, eps_list):
    """Sweeps with per-sweep active_eps, conf_prev threaded as densify's
    loop threads it."""
    prev_conf = None
    for it, eps in enumerate(eps_list):
        this_conf = ps.conf
        ps = tpm.sweep(ps, pd, po, (0, 0), V, False, mode="nn", n_prop=8, fold=it + 1,
                       active_eps=eps if prev_conf is not None else 0.0,
                       conf_prev=prev_conf)
        prev_conf = this_conf
    return ps


@pytest.fixture(scope="module")
def case():
    data, state, _, po, _ = make_case(H, W, V)
    return port_data(data), port_state(state), po, data


def test_always_active_is_bit_identical(case):
    pd, ps, po, _ = case
    ref = _run(pd, ps, po, [0.0, 0.0, 0.0])
    one = _run(pd, ps, po, [0.0, -1.0, -1.0])
    for a, b in zip(ref, one):
        assert torch.equal(a, b)


def test_skipped_bands_keep_incumbents(case):
    pd, ps, po, _ = case
    prev_conf = None
    for it in range(2):
        this_conf = ps.conf
        ps = tpm.sweep(ps, pd, po, (0, 0), V, False, mode="nn", n_prop=8, fold=it + 1)
        prev_conf = this_conf
    before = ps
    churn = torch.where(tpm._active(pd, 0), prev_conf - before.conf, 0.0)
    eps = float(torch.median(churn.reshape(-1, 16 * W).amax(1)))
    after = tpm._sweep_parity(before, pd, po, rng.fold_in((0, 0), 3), V, False, 3, "nn",
                              0, 8, active_eps=eps, conf_prev=prev_conf)
    assert bool((after.conf <= before.conf).all())
    changed = (after.depth != before.depth).numpy()
    assert changed.any()
    act = tpm._band_flags(before, pd, prev_conf, 0, "nn", eps).numpy()
    assert not act.all(), "the test needs a quiescent band"
    ch_bands = changed.reshape(-1, 16, W).any(axis=(1, 2))
    assert not np.any(ch_bands & ~act), np.nonzero(ch_bands & ~act)


@pytest.mark.parametrize("h", [96, 40])
@pytest.mark.parametrize("parity", [0, 1])
def test_band_flags_equal_jax_tiles(h, parity):
    """The port's band flags equal the JAX package's tile flags of its
    compacted lattice (zeros for invalid pixels and padded rows), for a
    height that is a multiple of 16 and one that is not."""
    data, state, _, _, _ = make_case(h, W, V)
    r = np.random.default_rng(h + parity)
    conf = np.asarray(state.conf)
    prev = (conf + r.exponential(0.01, conf.shape) * (r.random(conf.shape) < 0.3)).astype(np.float32)
    pd, ps = port_data(data), port_state(state)
    for eps in (-1.0, 0.0, 0.004, 0.02):
        churn = jnp.where(data.valid, jnp.asarray(prev) - state.conf, 0.0)
        cc = np.asarray(jpm._compact_parity_rows(churn, parity))
        nb = -(-cc.shape[0] // 8)
        cc = np.concatenate([cc, np.zeros((nb * 8 - cc.shape[0], cc.shape[1]), cc.dtype)])
        jax_act = cc.reshape(nb, -1).max(axis=1) > eps
        act = tpm._band_flags(ps, pd, t(prev), parity, "nn", eps)
        np.testing.assert_array_equal(act.numpy(), jax_act)


def test_no_skipping_where_compaction_is_off(case):
    pd, ps, po, _ = case
    prev = ps.conf + 1.0
    assert tpm._band_flags(ps, pd, prev, 0, "warp", 0.01) is None
    odd = make_case(41, 56, 1)
    assert tpm._band_flags(port_state(odd[1]), port_data(odd[0]), port_state(odd[1]).conf,
                           0, "nn", 0.01) is None


@pytest.mark.parametrize("geom", ["none", "geom", "pre"])
def test_plain_scorer_band_contract(geom):
    """score_views_plain with band flags: flagged-off bands give the
    sentinel, flagged-on bands the unflagged scores bit for bit."""
    data, state, _, po, _ = make_case(72, 96, 2, geom=True, lowres=True)
    pd, ps = port_data(data), port_state(state)
    cd = torch.stack([ps.depth * s for s in (0.97, 1.0, 1.03)])
    cn = ps.normal.expand(3, *ps.normal.shape).contiguous()
    inv_nd, bonus, f_blend, delta = tpm.score_prelude(pd, po, ps, cd, cn)
    v = pd.views
    th, wg = float(po.th_robust), float(po.estimation_geometric_weight)
    terms = pm_kernel.geom_terms_plain(v.depth, v.size, v.Tl, v.Tm, v.Tr, v.Tn, cd,
                                       pd.X0, pd.uv)
    kw = {"none": {}, "pre": {"geom_terms": terms},
          "geom": dict(Tr=v.Tr, Tn=v.Tn, dms=v.depth, uv=pd.uv)}[geom]
    args = (v.image, v.size, v.Hl, v.Hm, cd, cn, inv_nd, pd.X0, pd.goff, pd.w, pd.wtm,
            pd.sum_w, pd.norm_sq0, bonus, f_blend, delta, pd.lowres)
    flags = torch.tensor([True, False, True, False, False])   # 72 rows: 5 bands
    full = pm_kernel.score_views(*args, th_robust=th, geom_weight=wg, **kw)
    got = pm_kernel.score_views(*args, th_robust=th, geom_weight=wg, band_act=flags, **kw)
    sentinel = pm_kernel.finish_views(
        lambda j: (torch.full_like(cd, th), None if geom == "none" else torch.zeros_like(cd)),
        2, v.size, bonus, f_blend, delta, pd.lowres, th_robust=th, geom_weight=wg)
    rows = pm_kernel.band_rows(flags, 72)
    torch.testing.assert_close(got[:, rows], full[:, rows], rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got[:, ~rows], sentinel[:, ~rows], rtol=0, atol=0,
                               equal_nan=True)
    assert not torch.equal(full[:, ~rows], sentinel[:, ~rows])
    for bad in (torch.ones(4, dtype=torch.bool), torch.ones(5, dtype=torch.uint8)):
        with pytest.raises((ValueError, TypeError), match="band_act"):
            pm_kernel.score_views(*args, th_robust=th, geom_weight=wg, band_act=bad, **kw)


OPTS = dict(SLICE_OPTS, estimation_iters=6)


@pytest.fixture(scope="module")
def scenes():
    """(port scene, JAX scene, the JAX package's view 0 under OMVS_COMPACT=1
    without skipping, and the compaction floor: its agreement with
    OMVS_COMPACT=0)."""
    scene, _, arrays = build_gt_scene(n_views=3, W=160, H=120)
    jscene = jax_scene(arrays)
    select_views_for_scene(scene, DenseOptions(**OPTS))
    jax_select(jscene, JaxOptions(**OPTS))
    base_c0 = _jax_view(jscene, {"OMVS_COMPACT": "0"})
    base_c1 = _jax_view(jscene, {"OMVS_COMPACT": "1"})
    return scene, jscene, base_c1, depth_agreement([base_c1], [base_c0])


def _jax_view(jscene, env):
    old = {k: os.environ.get(k) for k in ("OMVS_COMPACT", "OMVS_ACTIVE", "OMVS_EARLY_EXIT")}
    os.environ.update(dict({"OMVS_EARLY_EXIT": "0"}, **env))
    for k in ("OMVS_COMPACT", "OMVS_ACTIVE"):
        if k not in env:
            os.environ.pop(k, None)
    jax.clear_caches()      # the JAX package reads OMVS_COMPACT when it traces
    try:
        return jd.estimate_depth_map(jscene, 0, JaxOptions(**OPTS)).depth
    finally:
        jax.clear_caches()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("eps", ["5e-3", "0.05"])
def test_densify_view_under_active_matches_jax(scenes, monkeypatch, eps):
    scene, jscene, base_c1, floor = scenes
    assert min(floor[0]) > 0.99 and floor[1] > 0.985, floor
    ref = _jax_view(jscene, {"OMVS_COMPACT": "1", "OMVS_ACTIVE": eps})
    monkeypatch.setenv("OMVS_EARLY_EXIT", "0")
    monkeypatch.setenv("OMVS_ACTIVE", eps)
    tpm.BANDS.update(scored=0, skipped=0)
    out = pdens.estimate_depth_map(scene, 0, DenseOptions(**OPTS), device="cpu").depth
    masks, pooled, _ = depth_agreement([out], [ref])
    assert min(masks) > 0.99 and pooled > 0.985, (masks, pooled, floor)
    if eps == "0.05":
        # both packages skipped: each moved away from its unskipped run
        assert tpm.BANDS["skipped"] > 0
        assert depth_agreement([ref], [base_c1])[1] < 0.999
        monkeypatch.delenv("OMVS_ACTIVE")
        plain = pdens.estimate_depth_map(scene, 0, DenseOptions(**OPTS), device="cpu").depth
        assert depth_agreement([out], [plain])[1] < 0.999
    else:
        assert tpm.BANDS["skipped"] == 0 and tpm.BANDS["scored"] > 0
