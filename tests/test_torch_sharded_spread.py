"""Where sharded densify's point spread comes from: the cross-view filter
and the fusion given identical depth maps, sharded and serial, in the
port and in the JAX package, on the CPU.

``tests/_torch_sharded_floor.py`` found the port's sharded
``dense_reconstruction`` on test_sharded_mixed.py's scene spanning more
points under one-ulp image changes than the JAX package's. Here the maps
of one sharded port run (taken at the filter's input, after estimation
and the speckle and gap pass) go through the rest of
``dense_reconstruction`` four ways, estimation and that pass replaced by
the maps: the port sharded (``parallel/sharded_filter.py`` on (2, 2) CPU
shards) and serial (``densify._filter_views``), the JAX package sharded
and serial. All four clouds are equal point for point (tolerance 0), so
the filter and the fusion add no spread: it comes from the estimation
under early exit. ``fusion_reduce_sharded``, the reduction the
multi-device check runs, meets the serial float64 reduction on the same
candidates at the 0.999 bar of its JAX test."""

import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_helpers import port_scene_from_jax  # noqa: E402
from test_sharded_mixed import _mixed_scene  # noqa: E402

from openmvs_tpu_torch.parallel import sharded  # noqa: E402

torch.set_num_threads(2)

OPTS = dict(sub_resolution_levels=1, estimation_iters=2, estimation_geometric_iters=1)


@pytest.fixture(scope="module")
def filter_input():
    """The maps of a sharded port run of the mixed scene as the sharded
    filter receives them, and the run's cloud."""
    from openmvs_tpu_torch import densify as pdens
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.parallel import sharded_filter

    seen = []
    orig = sharded_filter.filter_views_sharded

    def recorded(results, *a, **kw):
        seen.append(copy.deepcopy(results))
        return orig(results, *a, **kw)

    sharded_filter.filter_views_sharded = recorded
    try:
        pc = pdens.dense_reconstruction(port_scene_from_jax(_mixed_scene()),
                                        DenseOptions(**OPTS), device="cpu",
                                        mesh=sharded.make_mesh(4, devices=["cpu"] * 4))
    finally:
        sharded_filter.filter_views_sharded = orig
    assert len(seen) == 1
    return seen[0], pc


def _inject(monkeypatch, dens, shmod, maps):
    """Estimation (sharded and per view) returns copies of ``maps``; the
    speckle and gap pass, which they have been through, does nothing."""
    monkeypatch.setattr(shmod, "estimate_views_sharded",
                        lambda scene, opts, mesh, **kw: copy.deepcopy(maps))
    monkeypatch.setattr(dens, "estimate_depth_map",
                        lambda scene, i, opts, **kw: copy.deepcopy(
                            maps.get(scene.images[i].meta.id)))
    monkeypatch.setattr(dens, "optimize_depth_map", lambda r, opts: None)


def test_identical_maps_filter_and_fuse_alike_sharded_serial_and_jax(filter_input,
                                                                     monkeypatch):
    from openmvs_tpu import densify as jd
    from openmvs_tpu.config import DenseOptions as JaxOptions
    from openmvs_tpu.geometry.camera import Camera as JaxCamera
    from openmvs_tpu.parallel import sharded as jsh
    from openmvs_tpu_torch import densify as pdens
    from openmvs_tpu_torch.config import DenseOptions

    maps, pc_run = filter_input
    jmaps = {rid: jd.DepthMapResult(
        image_idx=r.image_idx, depth=r.depth.copy(), normal=r.normal.copy(),
        conf=r.conf.copy(), d_min=r.d_min, d_max=r.d_max, neighbor_ids=list(r.neighbor_ids),
        camera=JaxCamera(r.camera.K, r.camera.R, r.camera.C)) for rid, r in maps.items()}
    monkeypatch.setenv("OMVS_NO_PALLAS", "1")
    clouds = {}
    for mode, mesh in (("sharded", sharded.make_mesh(4, devices=["cpu"] * 4)),
                       ("serial", None)):
        with monkeypatch.context() as m:
            _inject(m, pdens, sharded, maps)
            clouds[f"port_{mode}"] = pdens.dense_reconstruction(
                port_scene_from_jax(_mixed_scene()), DenseOptions(**OPTS), device="cpu",
                mesh=mesh)
    for mode, mesh in (("sharded", jsh.make_mesh(4)), ("serial", None)):
        with monkeypatch.context() as m:
            _inject(m, jd, jsh, jmaps)
            clouds[f"jax_{mode}"] = jd.dense_reconstruction(_mixed_scene(),
                                                           JaxOptions(**OPTS), mesh=mesh)
    points = {k: np.asarray(v.points) for k, v in clouds.items()}
    assert np.array_equal(points["port_sharded"], np.asarray(pc_run.points))
    assert len(points["port_sharded"]) > 1000
    for k in ("port_serial", "jax_sharded", "jax_serial"):
        assert np.array_equal(points[k], points["port_sharded"]), k


def test_fusion_reduce_sharded_equals_serial_reduction(filter_input):
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.ops.fusion import conf2weight

    maps, _ = filter_input
    opts = DenseOptions()
    ref = maps[max(maps, key=lambda rid: len(maps[rid].neighbor_ids))]
    yy, xx = np.nonzero(ref.depth > 0)
    X = ref.camera.unproject(np.stack([xx, yy], -1).astype(np.float64),
                             ref.depth[yy, xx].astype(np.float64))
    Nw = ref.normal[yy, xx].astype(np.float64) @ ref.camera.R
    nbs = [maps[j] for j in ref.neighbor_ids if j in maps]
    H = max(n.depth.shape[0] for n in nbs)
    W = max(n.depth.shape[1] for n in nbs)

    def pad(a):
        out = np.zeros((H, W) + a.shape[2:], np.float32)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    nb = dict(depth=np.stack([pad(n.depth) for n in nbs]),
              normal=np.stack([pad(n.normal) for n in nbs]),
              conf=np.stack([pad(n.conf) for n in nbs]),
              K=np.stack([n.camera.K for n in nbs]), R=np.stack([n.camera.R for n in nbs]),
              C=np.stack([n.camera.C for n in nbs]), valid=np.ones(len(nbs), np.float32))
    accX, accW, nA = sharded.fusion_reduce_sharded(X.astype(np.float32),
                                                   Nw.astype(np.float32), nb, opts,
                                                   ["cpu"] * 2)
    # the serial reduction: each neighbour's agreement and weighted
    # evidence in float64, in turn
    sX, sW, sA = np.zeros((len(X), 3)), np.zeros(len(X)), np.zeros(len(X), np.int64)
    cosn = np.cos(np.radians(opts.normal_diff_threshold))
    for n in nbs:
        hb, wb = n.depth.shape
        pb = n.camera.project_h(X)
        zb = pb[:, 2]
        front = zb > 0
        ix = np.round(np.where(front, pb[:, 0] / np.where(front, zb, 1), -1)).astype(int)
        iy = np.round(np.where(front, pb[:, 1] / np.where(front, zb, 1), -1)).astype(int)
        inside = front & (ix >= 0) & (ix < wb) & (iy >= 0) & (iy < hb)
        ixc, iyc = np.clip(ix, 0, wb - 1), np.clip(iy, 0, hb - 1)
        db = n.depth[iyc, ixc].astype(np.float64)
        similar = inside & (db > 0) & (np.abs(zb - db) < opts.depth_diff_threshold * zb)
        agree = similar & (np.einsum("ij,ij->i", Nw, n.normal[iyc, ixc] @ n.camera.R) > cosn)
        w = np.where(agree, conf2weight(n.conf[iyc, ixc], db, opts.fuse_conf_weight_floor),
                     0.0)
        Xb = n.camera.unproject(np.stack([ixc, iyc], -1).astype(np.float64), db)
        sX += np.where(agree[:, None], Xb * w[:, None], 0.0)
        sW += w
        sA += agree
    assert sA.max() > 0
    assert (nA == sA).mean() >= 0.999
    both = (sW > 0) & (accW > 0)
    assert (np.abs(accW[both] - sW[both]) / np.maximum(sW[both], 1e-9) < 1e-3).mean() >= 0.999
    relx = np.abs(accX - sX).max(-1) / np.maximum(np.abs(sX).max(-1), 1e-9)
    assert (relx < 1e-3).mean() >= 0.999

