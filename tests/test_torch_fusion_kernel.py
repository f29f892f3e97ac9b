"""Fusion's card path on the CPU: the plain PyTorch twin of
``csrc/fuse_views.cu`` (``ops/fusion_kernel.py``) against the port's host
NumPy fusion (``ops/fusion.fuse_depth_maps``), and that against the JAX
package's (``openmvs_tpu.ops.fusion.fuse_depth_maps``), bit for bit on
every output array and list, in order.

Cases: seeded maps of 3 to 6 views with normals and colours; a neighbour
at half the resolution, so that several candidates land on one neighbour
texel (the first in scan order wins); maps with patches moved in front of
and behind the surface, so that conflicts are invalidated and kept; both
min_views_fuse 2 and 3; colours present, absent and mixed, normals absent,
and neither estimated; the invalidation case of the JAX package's
``test_fusion_invalidates_seen_through_depths`` on the port; and a whole
``dense_reconstruction`` on the small synthetic scene with the card route
run through the twin. The kernels themselves run only on the card:
``tests/test_torch_fusion_card.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openmvs_tpu_torch import densify
from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.geometry.camera import Camera
from openmvs_tpu_torch.ops import fusion
from openmvs_tpu_torch.ops import fusion_kernel as fk

torch.set_num_threads(2)

K = np.array([[40.0, 0, 25.5], [0, 44.0, 19.5], [0, 0, 1]])


def _yaw(deg):
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])


def _plane_depth(cam, H, W, normal=(0.2, 0.1, 1.0), at=6.0):
    """Camera z of the plane normal . X = at along each pixel's ray."""
    n = np.array(normal) / np.linalg.norm(normal)
    yy, xx = np.mgrid[0:H, 0:W]
    rays = np.stack([xx, yy, np.ones_like(xx)], -1) @ np.linalg.inv(cam.K).T @ cam.R
    t = (at - n @ cam.C) / (rays @ n)
    return np.where(t > 0, t, 0.0)


def _views(n_views, seed, H=40, W=52, normals=True, colors=True, scale=None):
    """Views of a tilted plane from a row of cameras, depths with noise and
    a tenth dropped, random confidences, normals near the plane's and
    colours. ``scale`` (view, s) gives one view s times the resolution."""
    rng = np.random.default_rng(seed)
    views = []
    for i in range(n_views):
        h, w, k = H, W, K
        if scale is not None and scale[0] == i:
            s = scale[1]
            h, w = int(H * s), int(W * s)
            k = np.array([[K[0, 0] * s, 0, (K[0, 2] + 0.5) * s - 0.5],
                          [0, K[1, 1] * s, (K[1, 2] + 0.5) * s - 0.5], [0, 0, 1]])
        cam = Camera(k, _yaw(3 * (i % 3) - 3), np.array([0.3 * i, 0.1 * (i % 2), 0.05 * i]))
        d = (_plane_depth(cam, h, w) * (1 + 0.003 * rng.standard_normal((h, w)))).astype(
            np.float32)
        d[rng.random((h, w)) < 0.1] = 0
        conf = rng.uniform(0.05, 1.0, (h, w)).astype(np.float32)
        nrm = None
        if normals:
            nrm = rng.standard_normal((h, w, 3)) * 0.15 + np.array([-0.2, -0.1, -1.0])
            nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
        col = rng.integers(0, 256, (h, w, 3), dtype=np.uint8) if colors else None
        views.append(fusion.ViewDepthData(i, 10 + i, cam, d, nrm, conf, col,
                                          [10 + j for j in range(n_views) if j != i]))
    return views


def _bits(a, dtype):
    return np.asarray(a).view(dtype)


def _assert_same_cloud(got, want):
    assert got.points.dtype == want.points.dtype == np.float32
    np.testing.assert_array_equal(_bits(got.points, np.uint32), _bits(want.points, np.uint32))
    assert got.colors.dtype == want.colors.dtype and got.colors.shape == want.colors.shape
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.normals.dtype == want.normals.dtype and got.normals.shape == want.normals.shape
    np.testing.assert_array_equal(_bits(got.normals, np.uint32), _bits(want.normals, np.uint32))
    assert len(got.views) == len(want.views) == len(got.weights) == len(want.weights)
    for i, (a, b) in enumerate(zip(got.views, want.views)):
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b, err_msg=f"views of point {i}")
    for i, (a, b) in enumerate(zip(got.weights, want.weights)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(_bits(a, np.uint32), _bits(b, np.uint32),
                                      err_msg=f"weights of point {i}")


def _jax_fusion(views, opts, **kw):
    """The JAX package's host fusion on the same maps, cameras and options
    (NumPy: no JAX runs), the reference the port's copy is held to."""
    pytest.importorskip("jax")
    from openmvs_tpu.config import DenseOptions as JaxOptions
    from openmvs_tpu.geometry.camera import Camera as JaxCamera
    from openmvs_tpu.ops import fusion as jfusion

    jopts = JaxOptions(**{f.name: getattr(opts, f.name) for f in dataclasses.fields(JaxOptions)
                          if hasattr(opts, f.name)})
    jviews = [jfusion.ViewDepthData(v.image_idx, v.image_id,
                                    JaxCamera(v.camera.K, v.camera.R, v.camera.C), v.depth,
                                    v.normal, v.conf, v.color, list(v.neighbor_ids))
              for v in views]
    return jfusion.fuse_depth_maps(jviews, jopts, **kw)


def _both(views, opts, **kw):
    """The twin, the port's host fusion and the JAX package's: one cloud."""
    before = [(v.depth.copy(), None if v.conf is None else v.conf.copy()) for v in views]
    want = fusion.fuse_depth_maps(views, opts, **kw)
    got = fk.fuse_views(views, opts, device="cpu", **kw)
    ref = _jax_fusion(views, opts, **kw)
    for v, (d, c) in zip(views, before):  # the caller's maps are not mutated
        np.testing.assert_array_equal(v.depth, d)
    _assert_same_cloud(want, ref)
    _assert_same_cloud(got, want)
    return want


@pytest.mark.parametrize("n_min", [2, 3])
@pytest.mark.parametrize("n_views,seed", [(3, 0), (4, 1), (5, 2), (6, 3)])
def test_twin_equals_host_fusion(n_views, seed, n_min):
    pc = _both(_views(n_views, seed), DenseOptions(min_views_fuse=n_min))
    assert len(pc) > 100
    assert max(len(v) for v in pc.views) >= min(n_views, 4)


def _tie_share(views):
    """The share of view 0's valid pixels whose texel in view 1 another of
    them also lands on."""
    r, nb = views[0], views[1]
    yy, xx = np.nonzero(r.depth > 0)
    X = r.camera.unproject(np.stack([xx, yy], -1).astype(np.float64),
                           r.depth[yy, xx].astype(np.float64))
    p = nb.camera.project(X)
    lin = np.round(p[:, 1]) * 1000 + np.round(p[:, 0])
    _, inv, cnt = np.unique(lin, return_inverse=True, return_counts=True)
    return float((cnt[inv] > 1).mean())


@pytest.mark.parametrize("n_min", [2, 3])
def test_ties_go_to_the_first_candidate(n_min):
    # the neighbour at half the resolution: about 4 candidates a texel
    views = _views(4, 5, scale=(1, 0.5))
    assert _tie_share(views) > 0.5
    pc = _both(views, DenseOptions(min_views_fuse=n_min))
    assert len(pc) > 100


def _conflict_views():
    """Patches of each map moved 5% nearer or farther: projected points
    then sit in front of some neighbour depths (conflicts, invalidated) and
    behind others (kept); test_fusion_invalidates_seen_through_depths
    holds each direction alone."""
    views = _views(4, 7)
    rng = np.random.default_rng(11)
    for v in views:
        h, w = v.depth.shape
        for _ in range(6):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            v.depth[y:y + 8, x:x + 8] *= np.float32(rng.choice([0.95, 1.05]))
    return views


@pytest.mark.parametrize("n_min", [2, 3])
def test_conflicts_in_front_and_behind(monkeypatch, n_min):
    zeroed = []
    invalidate = fusion.ViewProvider.invalidate

    def counting(self, vid, lin):
        zeroed.append(len(lin))
        invalidate(self, vid, lin)

    monkeypatch.setattr(fusion.ViewProvider, "invalidate", counting)
    views = _conflict_views()
    opts = DenseOptions(min_views_fuse=n_min)
    _both(views, opts)
    assert sum(zeroed) > 20, zeroed


@pytest.mark.parametrize("colors", ["all", "none", "mixed"])
@pytest.mark.parametrize("normals", [True, False], ids=["normals", "no_normals"])
def test_colours_and_normals_present_or_absent(colors, normals):
    views = _views(4, 13, normals=normals, colors=colors != "none")
    if colors == "mixed":
        views[1].color = None
        views[3].color = None
    pc = _both(views, DenseOptions(min_views_fuse=2))
    assert len(pc) > 100 and pc.has_colors and pc.has_normals
    if colors == "none":
        assert not pc.colors.any()


@pytest.mark.parametrize("estimate_color,estimate_normal",
                         [(False, True), (True, False), (False, False)])
def test_outputs_not_estimated(estimate_color, estimate_normal):
    pc = _both(_views(3, 17), DenseOptions(min_views_fuse=2),
               estimate_color=estimate_color, estimate_normal=estimate_normal)
    assert pc.has_colors == estimate_color and pc.has_normals == estimate_normal


def invalidation_views(db_val):
    """Two 8x8 views, one depth each: A's point at world (0, 0, 1) projects
    to B's (3, 4), where B measured ``db_val``."""
    k = np.array([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]])
    cam_a = Camera(k, np.eye(3), np.zeros(3))
    cam_b = Camera(k, np.eye(3), np.array([0.1, 0, 0]))
    da = np.zeros((8, 8), np.float32)
    da[4, 4] = 1.0
    db = np.zeros((8, 8), np.float32)
    db[4, 3] = db_val
    conf = np.full((8, 8), 0.9, np.float32)
    return [fusion.ViewDepthData(0, 0, cam_a, da, None, conf, None, [1]),
            fusion.ViewDepthData(1, 1, cam_b, db, None, conf, None, [0])]


@pytest.mark.parametrize("db_val,n_points", [(2.0, 1), (0.5, 2)])
def test_fusion_invalidates_seen_through_depths(db_val, n_points):
    """A neighbour depth BEHIND the fused point is invalidated (one point
    left); one IN FRONT survives and fuses as its own point (two)."""
    pc = _both(invalidation_views(db_val), DenseOptions(min_views_fuse=1),
               estimate_color=False, estimate_normal=False)
    assert len(pc) == n_points


def test_missing_neighbours_are_skipped():
    views = _views(4, 19)
    views[0].neighbor_ids = [99] + list(views[0].neighbor_ids)
    views[2].neighbor_ids = [11, 77]
    views[3].neighbor_ids = [99]  # no neighbour left: its own points at n_min 1
    _both(views, DenseOptions(min_views_fuse=2))
    _both(views, DenseOptions(min_views_fuse=1))


def test_dense_reconstruction_card_route_through_the_twin(monkeypatch):
    """The small synthetic scene densified twice: the host fusion, and the
    card route (``fusion_kernel.fuse_views``) run through the twin; both
    the JAX package's fusion of the same maps."""
    from openmvs_tpu_torch.synthetic import build_gt_scene
    from openmvs_tpu_torch.utils import log

    scene, _, _ = build_gt_scene(n_views=3, W=64, H=48, color=True)
    opts = DenseOptions(sub_resolution_levels=1, estimation_iters=2,
                        estimation_geometric_iters=1)
    want = densify.dense_reconstruction(scene, opts, device="cpu")
    assert densify._fusion_card({}) is None
    calls = []
    fuse_views = fk.fuse_views

    def twin(views, *a, **kw):
        calls.append((views, a, dict(kw)))
        return fuse_views(views, *a, **kw)

    monkeypatch.setattr(densify, "_fusion_card", lambda results: torch.device("cpu"))
    monkeypatch.setattr(fk, "fuse_views", twin)
    with log.recording() as rec:
        got = densify.dense_reconstruction(scene, opts, device="cpu")
    assert len(calls) == 1 and calls[0][2].pop("device") == torch.device("cpu")
    assert len(want) > 200
    _assert_same_cloud(got, want)
    views, a, kw = calls[0]
    _assert_same_cloud(want, _jax_fusion(views, *a, **kw))
    names = [sp.name for sp in rec.spans]
    assert names.count("fuse.upload") == names.count("fuse.download") == 1
    assert names.count("fuse.neighbours") == names.count("fuse.keep") == 3
    assert "fuse.card_views" not in rec.counters  # counted on a card only


def test_routing_takes_one_card_only():
    def res(dev):
        return densify.DepthMapResult(0, None, None, None, 0.0, 1.0, [], None, device=dev)

    cuda = torch.device("cuda")
    assert densify._fusion_card({1: res(cuda), 2: res(cuda)}) == cuda
    assert densify._fusion_card({1: res(cuda), 2: res(None)}) is None
    assert densify._fusion_card({1: res(cuda), 2: res(torch.device("cuda:1"))}) is None
    assert densify._fusion_card({1: res(torch.device("cpu"))}) is None


def test_wrapper_refuses_what_the_kernels_do_not_take():
    views = _views(3, 23)
    views[0].neighbor_ids = [10, 11]
    with pytest.raises(ValueError, match="itself"):
        fk.fuse_views(views, DenseOptions(), device="cpu")
    views = _views(3, 23)
    views[1].depth = views[1].depth.astype(np.float64)
    with pytest.raises(TypeError):
        fk.fuse_views(views, DenseOptions(), device="cpu")
    views = _views(3, 23)
    views[2].color = views[2].color.astype(np.float32)
    with pytest.raises(TypeError):
        fk.fuse_views(views, DenseOptions(), device="cpu")
    views = _views(3, 23)
    views[0].neighbor_ids = [11, 12] * 7
    with pytest.raises(ValueError, match="neighbours"):
        fk.fuse_views(views, DenseOptions(), device="cpu")


def test_sum_orders_name_numpys_sums():
    rng = np.random.default_rng(29)
    a, b = rng.standard_normal((2, 5000, 3)) * 10.0 ** rng.integers(-2, 3, (2, 5000, 3))
    dot, norm = fk.sum_orders()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = fk._dot([ta[:, k] for k in range(3)], [tb[:, k] for k in range(3)], dot)
    np.testing.assert_array_equal(got.numpy(), np.einsum("ij,ij->i", a, b))
    s = ta * ta
    got = fk._sqrt(fk._sum3(s[:, 0], s[:, 1], s[:, 2], norm))
    np.testing.assert_array_equal(got.numpy(), np.linalg.norm(a, axis=-1))
    # the orders differ on these vectors, so the probe named one
    p = ta * tb
    assert len({tuple(fk._sum3(p[:, 0], p[:, 1], p[:, 2], k)[:200].tolist())
                for k in range(3)}) == 3
