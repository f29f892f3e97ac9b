"""The port's other multi-device paths on shards that share the CPU,
against the JAX package's on its CPU mesh and against the port's serial
paths, from the same numpy inputs:

- label-sharded LBP (``texture.label_faces_lbp_sharded``) on
  test_sharded_texture.py's graphs, view counts uneven over the shards:
  labels equal on at least 0.999 of faces (expected all);
- SGM pairs and the fusion reduction (``parallel/sharded.py``) at the bars
  of __graft_entry__.py:221 and :274-277 (0.999);
- refine's pair axis over 4 shards with a dummy pair: one
  ``_energy_grad`` against one shard and against the JAX package's with
  its pairs sharded, at test_refine_grad.py:167-169's tolerances (the
  shards sum the pairs in another order);
- ``densify._run_views_parallel`` with two CPU workers, equal to the
  one-device loop bit for bit, ``dense_reconstruction(devices=...)`` with
  two CPU workers (PatchMatch and SGM) equal to the one-device run, and the
  lock of the kernel launch counts;
- ``dense_reconstruction(mesh=...)`` on test_sharded_mixed.py's scene
  (photometric and geometric passes sharded, the sharded filter, fusion):
  points within 1% of the JAX package's, at one level and 3 iterations.
  At the estimation test's options (two levels, 2 iterations) the scene
  fuses about 1,300 points and a one-ulp change of the images moves the
  count by 0.7% in the JAX package and by 3.5% in the port over seven
  draws (a region of view 2 that the filter keeps or drops whole, in both
  packages): ``python tests/_torch_sharded_floor.py``. A 1% bar cannot
  hold there; at these options both packages move by 0.2%.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _torch_helpers import port_scene_from_jax  # noqa: E402
from _torch_refine import port_pairs, stack, toy_pair, with_faces  # noqa: E402
from test_sharded_mixed import _mixed_scene  # noqa: E402
from test_sharded_texture import _random_face_graph  # noqa: E402

from openmvs_tpu_torch.parallel import sharded  # noqa: E402

torch.set_num_threads(2)


def _cpus(n):
    return jax.devices("cpu")[:n]


@pytest.mark.parametrize("n_dev,V,lam", [(2, 5, False), (4, 5, False), (4, 7, True)])
def test_sharded_lbp_matches_jax_and_serial(n_dev, V, lam):
    from openmvs_tpu.texture import label_faces_lbp_sharded as jax_lbp
    from openmvs_tpu_torch.texture import label_faces_lbp, label_faces_lbp_sharded

    quality, adj = _random_face_graph(V=V, seed=3 if lam else 0)
    lam_edge = (np.random.default_rng(1).uniform(0.05, 0.3, adj.shape).astype(np.float32)
                if lam else None)
    got = label_faces_lbp_sharded(quality, adj, 0.1, ["cpu"] * n_dev, iters=15,
                                  lam_edge=lam_edge)
    serial = label_faces_lbp(quality, adj, 0.1, iters=15, lam_edge=lam_edge, device="cpu")
    want = jax_lbp(quality, adj, 0.1, _cpus(n_dev), iters=15, lam_edge=lam_edge)
    assert (got == serial).mean() >= 0.999, (got != serial).sum()
    assert (got == want).mean() >= 0.999, (got != want).sum()


def _sgm_pairs():
    """__graft_entry__.py's stage-4 batch: 5 pairs of about constant
    disparity."""
    rng = np.random.default_rng(3)
    P_n, Hs, Ws, num_d, d_min = 5, 48, 96, 16, -12
    base = rng.uniform(0, 1, (P_n, Hs, Ws + 16)).astype(np.float32)
    lefts = base[:, :, 16:]
    rights = np.roll(base, 5, axis=2)[:, :, 16:]
    shifted = np.zeros_like(rights)
    shifted[:, :, -d_min:] = rights[:, :, :Ws + d_min]
    return lefts, shifted, d_min, num_d


def test_sgm_pairs_sharded_matches_jax():
    from openmvs_tpu.parallel import sharded as jsh

    lefts, shifted, d_min, num_d = _sgm_pairs()
    disp, cost = sharded.sgm_pairs_sharded(lefts, shifted, d_min, num_d, ["cpu"] * 4)
    jdisp, jcost = jsh.sgm_pairs_sharded(lefts, shifted, d_min, num_d, _cpus(4))
    assert disp.shape == jdisp.shape == lefts.shape and disp.dtype == np.int32
    assert (disp == jdisp).mean() >= 0.999
    assert (np.abs(cost - jcost) <= 1e-4 * np.maximum(np.abs(jcost), 1.0)).mean() >= 0.999


def _fusion_inputs():
    """Candidates unprojected from view 0 of test_sharded_filter.py's maps
    (normals facing the camera) and its neighbours stacked."""
    from test_sharded_filter import _make_results

    res = _make_results()
    r = res[0]
    yy, xx = np.nonzero(r.depth > 0)
    d = r.depth[yy, xx].astype(np.float64)
    X = r.camera.unproject(np.stack([xx, yy], -1).astype(np.float64), d)
    nrm = np.zeros(r.depth.shape + (3,), np.float32)
    nrm[..., 2] = -1.0
    Nw = nrm[yy, xx] @ r.camera.R
    nbs = [res[j] for j in r.neighbor_ids]
    H = max(n.depth.shape[0] for n in nbs)
    W = max(n.depth.shape[1] for n in nbs)

    def pad(a):
        out = np.zeros((H, W) + a.shape[2:], np.float32)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    stack_ = dict(depth=np.stack([pad(n.depth) for n in nbs]),
                  normal=np.stack([pad(np.broadcast_to(nrm[:1, :1], n.depth.shape + (3,)))
                                   for n in nbs]),
                  conf=np.stack([pad(n.conf) for n in nbs]),
                  K=np.stack([n.camera.K for n in nbs]),
                  R=np.stack([n.camera.R for n in nbs]),
                  C=np.stack([n.camera.C for n in nbs]),
                  valid=np.ones(len(nbs), np.float32))
    return X.astype(np.float32), Nw.astype(np.float32), stack_


def test_fusion_reduce_sharded_matches_jax():
    from openmvs_tpu.config import DenseOptions as JaxOptions
    from openmvs_tpu.parallel import sharded as jsh
    from openmvs_tpu_torch.config import DenseOptions

    X, Nw, nb = _fusion_inputs()
    accX, accW, nA = sharded.fusion_reduce_sharded(X, Nw, nb, DenseOptions(), ["cpu"] * 2)
    jX, jW, jA = jsh.fusion_reduce_sharded(X, Nw, nb, JaxOptions(), _cpus(2))
    assert accX.shape == (len(X), 3) and nA.max() > 0
    assert (nA == jA).mean() >= 0.999
    both = (jW > 0) & (accW > 0)
    rel = np.abs(accW[both] - jW[both]) / np.maximum(jW[both], 1e-9)
    assert (rel < 1e-3).mean() >= 0.999
    relx = np.abs(accX - jX).max(-1) / np.maximum(np.abs(jX).max(-1), 1e-9)
    assert (relx < 1e-3).mean() >= 0.999


def _refine_case():
    """3 toy pairs seen through random face ids, a mesh of 40 faces."""
    from openmvs_tpu_torch.refine import _vertex_adjacency

    rng = np.random.default_rng(5)
    nv = 30
    faces = rng.integers(0, nv, (40, 3))
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    pairs = []
    for seed in (0, 3, 7):
        verts, pd = toy_pair(seed=seed, nv=nv)
        fid = rng.integers(-1, len(faces), pd["mask"].shape).astype(np.int32)
        pairs.append(with_faces(pd, faces, fid))
    adj, deg = _vertex_adjacency(faces, nv)
    return verts, stack(pairs), faces, adj, deg


def test_refine_energy_grad_sharded_pairs():
    import openmvs_tpu.refine as jr
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from openmvs_tpu_torch import refine as pr

    verts, d, faces, adj, deg = _refine_case()
    common = (torch.from_numpy(adj).long(), torch.from_numpy(deg.astype(np.float32)))
    faces_t = torch.from_numpy(faces).long()
    scal = [torch.tensor(x, dtype=torch.float32) for x in (0.5, 0.1, 0.2)]
    v = torch.from_numpy(verts)
    e1, g1 = pr._energy_grad(v, port_pairs(d), *common, faces_t, *scal)
    npd = pr.PairData(**dict(d, face_vid=d["face_vid"].astype(np.int64)))
    shards = pr.shard_pairs(npd, faces_t, [torch.device("cpu")] * 4)
    assert [int(p.fid.shape[0]) for p in shards.pds] == [1, 1, 1, 1]
    assert bool((shards.pds[3].fid == -1).all())          # the dummy pair
    e4, g4 = pr._energy_grad(v, shards, *common, faces_t, *scal)
    assert abs(float(e4) - float(e1)) < 1e-5 * max(abs(float(e1)), 1.0)
    np.testing.assert_allclose(g4.numpy(), g1.numpy(), rtol=1e-4, atol=1e-6)

    # the JAX package's pair axis over 4 CPU devices, padded with a dummy
    mesh = Mesh(np.array(_cpus(4)), ("pairs",))
    pad = {k: np.concatenate([x, np.full((1,) + x.shape[1:], -1 if k == "fid" else 0,
                                         x.dtype)]) for k, x in d.items()}
    jpds = jax.device_put(jr.PairData(**pad), NamedSharding(mesh, PartitionSpec("pairs")))
    je, jg = jax.jit(jr._energy_grad)(
        jnp.asarray(verts), jpds, jnp.asarray(adj), jnp.asarray(deg, jnp.float32),
        jnp.asarray(faces.astype(np.int32)), jnp.float32(0.5), jnp.float32(0.1),
        jnp.float32(0.2))
    assert abs(float(e4) - float(je)) < 1e-5 * max(abs(float(je)), 1.0)
    np.testing.assert_allclose(g4.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def test_dryruns():
    assert sharded.dryrun(4, devices=["cpu"] * 4) > 0
    assert np.isfinite(sharded.dryrun_refine(["cpu"] * 2))


def test_run_views_parallel_equals_one_device_loop():
    from openmvs_tpu_torch import densify as pdens
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.view_selection import select_views_for_scene

    scene = port_scene_from_jax(_mixed_scene())
    opts = DenseOptions(sub_resolution_levels=0, estimation_iters=1)
    select_views_for_scene(scene, opts)

    def est(i, dev):
        return pdens.estimate_depth_map(scene, i, opts, defer_download=True, device=dev)

    cpu = torch.device("cpu")
    one = pdens._run_views_parallel(est, [0, 1, 2], [cpu])
    two = pdens._run_views_parallel(est, [0, 1, 2], [cpu, cpu])
    assert list(two) == [0, 1, 2] and (one[1] is None) == (two[1] is None)
    for i in (0, 2):
        for f in ("depth", "normal", "conf"):
            np.testing.assert_array_equal(getattr(two[i], f), getattr(one[i], f))


@pytest.mark.parametrize("estimator", ["patchmatch", "sgm"])
def test_dense_reconstruction_with_two_view_workers(estimator, tmp_path):
    """The entry point with ``devices=`` of two CPU workers: the geometric
    passes' closure over the photometric results, and the SGM estimator
    writing its per-pair .dimap files from both threads; the maps, the
    .dimap files and the points equal the one-device run's."""
    from openmvs_tpu_torch import densify as pdens
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.io import dmap

    opts = DenseOptions(sub_resolution_levels=0, estimation_iters=1,
                        estimation_geometric_iters=1, estimator=estimator)
    out = {}
    for label, devices in (("one", None), ("two", ["cpu", "cpu"])):
        folder = tmp_path / label
        pc = pdens.dense_reconstruction(port_scene_from_jax(_mixed_scene()), opts,
                                        save_dmaps_to=str(folder), device="cpu",
                                        devices=devices)
        files = sorted(f for f in os.listdir(folder) if f.endswith((".dmap", ".dimap")))
        out[label] = pc, files, {f: (folder / f).read_bytes() for f in files}
        maps = [dmap.load(str(folder / f)).depth for f in files if f.endswith(".dmap")]
        assert len(maps) >= 2 and all((m > 0).any() for m in maps)
    (pc1, files1, bytes1), (pc2, files2, bytes2) = out["one"], out["two"]
    assert files1 == files2
    assert any(f.endswith(".dimap") for f in files1) == (estimator == "sgm")
    assert all(bytes1[f] == bytes2[f] for f in files1)
    assert len(pc1) > 0
    np.testing.assert_array_equal(pc2.points, pc1.points)


def test_launch_counts_survive_concurrent_workers():
    """Worker threads counting launches at once lose no update."""
    from openmvs_tpu_torch.ops import pm_kernel

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pm_kernel.reset_launches()
        threads = [threading.Thread(target=lambda: [pm_kernel.count_launch("geom_terms")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert pm_kernel.LAUNCHES["geom_terms"] == 16 * 2000
    finally:
        sys.setswitchinterval(old)
        pm_kernel.reset_launches()


def test_dense_reconstruction_on_a_mesh_matches_jax():
    from openmvs_tpu import densify as jd
    from openmvs_tpu.config import DenseOptions as JaxOptions
    from openmvs_tpu.parallel import sharded as jsh
    from openmvs_tpu_torch import densify as pdens
    from openmvs_tpu_torch.config import DenseOptions

    o = dict(sub_resolution_levels=0, estimation_iters=3, estimation_geometric_iters=1)
    jscene = _mixed_scene()
    scene = port_scene_from_jax(jscene)
    old = os.environ.get("OMVS_NO_PALLAS")
    os.environ["OMVS_NO_PALLAS"] = "1"
    try:
        jpc = jd.dense_reconstruction(jscene, JaxOptions(**o), mesh=jsh.make_mesh(4))
    finally:
        if old is None:
            os.environ.pop("OMVS_NO_PALLAS")
        else:
            os.environ["OMVS_NO_PALLAS"] = old
    pc = pdens.dense_reconstruction(scene, DenseOptions(**o), device="cpu",
                                    mesh=sharded.make_mesh(4, devices=["cpu"] * 4))
    assert len(jpc) > 0
    assert abs(len(pc) - len(jpc)) <= 0.01 * len(jpc), (len(pc), len(jpc))
