"""The sweep runner (``openmvs_tpu_torch/ops/graphs.py``) on the CPU.

On the card densify's sweeps are CUDA graphs replayed over static buffers;
on the CPU a runner runs the same program bodies directly on the same
buffers (its CPU form). Held here, bit for bit where the arithmetic is the
same:

* keys as device tensors and ``rng.KeyTable`` rows against the host keys
  and ``jax.random``;
* the host bookkeeping a capture records (launch and band counts) runs at
  each replay, and not at capture;
* the runner's programs against ``patchmatch.init_state``,
  ``sweep_block_adaptive`` and ``sweep``, for two views of different
  depth ranges and view counts sharing one buffer class (so a stale
  buffer shows), photometric and geometric, with band skipping;
* ``estimate_depth_map`` through the runner against the eager port (equal)
  and the JAX package (the slice tests' 98.5% pooled, from the JAX
  package's own agreement under a one-ulp change,
  tests/_torch_parity_floor.py).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import (SLICE_OPTS, SLICE_VIEWS, depth_agreement,  # noqa: E402
                            make_case, port_data, slice_scenes)

from openmvs_tpu.ops import patchmatch as jpm  # noqa: E402
from openmvs_tpu_torch.ops import graphs, patchmatch, pm_kernel  # noqa: E402
from openmvs_tpu_torch.utils import rng  # noqa: E402

torch.set_num_threads(2)


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 131, 2 ** 31 - 1])
def test_tensor_keys_draw_the_bits_of_host_keys_and_jax(seed):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    kt = torch.tensor(_key(k), dtype=torch.int64)
    idx = torch.arange(37, dtype=torch.int64)
    for a, b in zip(rng.threefry2x32_t(kt, idx * 3, idx), rng.threefry2x32_t(_key(k), idx * 3, idx)):
        assert torch.equal(a, b)
    u = rng.uniform(kt, (5, 9), 0.5, 2.0)
    assert torch.equal(u, rng.uniform(_key(k), (5, 9), 0.5, 2.0))
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jax.random.uniform(k, (5, 9), jnp.float32, 0.5, 2.0)))
    uu, vv = np.meshgrid(np.arange(45, dtype=np.float32) + 3, np.arange(21, dtype=np.float32))
    uv = np.stack([uu, vv], -1)
    b = rng.block_uniform(kt, torch.from_numpy(uv), 0.0, np.pi)
    assert torch.equal(b, rng.block_uniform(_key(k), torch.from_numpy(uv), 0.0, np.pi))
    np.testing.assert_array_equal(
        b.numpy(), np.asarray(jpm._block_uniform(k, jnp.asarray(uv), 0.0, np.pi)))


def test_key_table_rows_are_the_host_derivations():
    """Keys derived from ``root`` are table rows; every fill derives them
    from that fill's key, as fold_in/split and jax.random do; a row first
    read after a fill (a body run directly) is derived then."""
    table = rng.KeyTable("cpu")
    kp = rng.fold_in(table.root, 131 + 2)
    a, b, c, d, e = rng.split(kp, 5)
    e1, e2 = rng.split(e)
    rows = [rng.words(x) for x in (a, d, e1, e2)]
    for seed in (3, 99):
        key = rng.fold_in(rng.prng_key(seed), 4)
        table.fill(key)
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
        jkp = jax.random.fold_in(jk, 133)
        js = jax.random.split(jkp, 5)
        want = [_key(js[0]), _key(js[3])] + [_key(x) for x in jax.random.split(js[4])]
        assert [tuple(r.tolist()) for r in rows] == want
        late = rng.words(rng.split(kp, 5)[2])   # registered after the fill
        assert tuple(late.tolist()) == _key(js[2])
    assert len(table.paths) == 5


def test_host_effects_run_at_each_replay_not_at_capture():
    pm_kernel.reset_launches()
    patchmatch.BANDS.update(scored=0, skipped=0)
    effects = []
    with pm_kernel.capturing(effects):
        pm_kernel.count_launch("score_views_nn")
        pm_kernel.host_effect(functools.partial(patchmatch._count_bands, 3, torch.tensor(2)))
    assert pm_kernel.LAUNCHES["score_views_nn"] == 0 and patchmatch.BANDS["scored"] == 0
    for _ in range(2):
        for fn in effects:
            fn()
    assert pm_kernel.LAUNCHES["score_views_nn"] == 2
    assert patchmatch.BANDS["scored"] == 6 and int(patchmatch.BANDS["skipped"]) == 4
    pm_kernel.reset_launches()
    patchmatch.BANDS.update(scored=0, skipped=0)


def _views(geom):
    """Two views' PMData on the CPU: 3 neighbours then 2, other images and
    depth ranges, the same (H, W, T) and neighbour image size."""
    a = port_data(make_case(h=48, w=64, v=3, geom=geom, seed=0)[0])
    jb, _, _, popts, _ = make_case(h=48, w=64, v=2, geom=geom, lowres=True, seed=5)
    b = port_data(jb)._replace(d_min=torch.tensor(3.0), d_max=torch.tensor(7.5))
    return [a, b], popts


def _eager_schedule(data, opts, key, V, use_geom, min_frac, sw):
    H, W = data.ref.shape
    sd = torch.full((H, W), 5.0)
    sn = torch.tensor([0.0, 0.0, -1.0]).expand(H, W, 3).contiguous()
    st = patchmatch.init_state(data, opts, key, sd, sn, V, use_geom, mode="nn", switches=sw)
    st, n = patchmatch.sweep_block_adaptive(st, data, opts, key, V, use_geom, n_perturb=2,
                                            mode="nn", n_prop=8, first_fold=1, n_sweeps=3,
                                            min_sweeps=2, eps=5e-3, min_frac=min_frac,
                                            switches=sw)
    before = st.conf
    st = patchmatch.sweep(st, data, opts, key, V, use_geom, n_perturb=2, mode="exact",
                          rescore_state=True, n_prop=8, fold=4, switches=sw)
    st = patchmatch.sweep(st, data, opts, key, V, use_geom, n_perturb=2, mode="exact",
                          n_prop=8, fold=5, active_eps=1e-3, conf_prev=before, switches=sw)
    return st, n, (sd, sn)


@pytest.mark.parametrize("geom,split", [(False, None), (True, None), (True, "1")])
def test_runner_programs_equal_the_eager_sweeps(geom, split, monkeypatch):
    """The runner's CPU form of init, the early-exit block and two exact
    sweeps (rescoring, then band skipping against the confidence before
    the previous sweep) equals the eager functions for both views, the
    second padded into the first's class, and again for the first after
    the second (no stale buffer); geometric sweeps also split
    (``OMVS_GEOM_SPLIT``)."""
    if split:
        monkeypatch.setenv("OMVS_GEOM_SPLIT", split)
    sw = patchmatch.Switches.from_env()
    views, opts = _views(geom)
    runner = graphs.Runner("cpu")
    done = []
    for i, min_frac in ((0, 0.5), (1, 0.0), (0, 0.5)):
        data = views[i]
        V = data.views.image.shape[0]
        key = rng.prng_key(17 + i)
        want, n_want, (sd, sn) = _eager_schedule(data, opts, key, V, geom, min_frac, sw)
        pm = graphs.Sweeps(data, opts, V, geom, runner, sw)
        pm.init(key, sd, sn, "nn")
        n = pm.block(key, 2, "nn", 8, 1, 3, 2, 5e-3, min_frac)
        pm.sweep(key, 4, "exact", True, 2, 8)
        pm.sweep(key, 5, "exact", False, 2, 8, active_eps=1e-3)
        assert n == n_want
        done.append(n)
        for got, ref in zip(pm.state, want):
            assert torch.equal(got, ref)
    # the block exits early at min_frac 0.5 and runs all sweeps at 0
    assert done == [2, 3, 2] and runner.n_classes == 1


def test_cpu_estimation_stays_eager_without_runners(monkeypatch):
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene
    from openmvs_tpu_torch.view_selection import select_views_for_scene

    def refuse(*a, **kw):
        raise AssertionError("a runner was made on the CPU")

    monkeypatch.setattr(graphs.Runners, "get", refuse)
    scene, _, _ = build_gt_scene(n_views=2, W=48, H=32)
    opts = DenseOptions(sub_resolution_levels=0, estimation_iters=2)
    select_views_for_scene(scene, opts)
    assert densify.estimate_depth_map(scene, 0, opts, device="cpu").depth.shape == (32, 48)


def test_estimate_depth_map_through_the_runner_matches_jax():
    from openmvs_tpu import densify as jd
    from openmvs_tpu.config import DenseOptions as JaxOptions
    from openmvs_tpu.view_selection import select_views_for_scene as jax_select
    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.view_selection import select_views_for_scene

    scene, jscene = slice_scenes()
    opts, jopts = DenseOptions(**SLICE_OPTS), JaxOptions(**SLICE_OPTS)
    select_views_for_scene(scene, opts)
    jax_select(jscene, jopts)
    runners = graphs.Runners()
    port = [densify.estimate_depth_map(scene, i, opts, device="cpu", runners=runners)
            for i in range(SLICE_VIEWS)]
    eager = [densify.estimate_depth_map(scene, i, opts, device="cpu")
             for i in range(SLICE_VIEWS)]
    for a, b in zip(port, eager):
        for f in ("depth", "normal", "conf"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    # one class per pyramid level, shared by the views
    assert runners.all()[0].n_classes == SLICE_OPTS["sub_resolution_levels"] + 1
    ref = [jd.estimate_depth_map(jscene, i, jopts).depth for i in range(SLICE_VIEWS)]
    masks, pooled, per_view = depth_agreement([r.depth for r in port], ref)
    msg = f"mask agreement {masks}, depth agreement {pooled} (per view {per_view})"
    assert min(masks) > 0.99, msg
    assert pooled > 0.985, msg
