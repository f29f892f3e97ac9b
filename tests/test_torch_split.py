"""Scene splitting (``openmvs_tpu_torch/split.py``) and the Morton octree
(``utils/octree.py``) against the JAX package's on the same scenes, on the
CPU. Both are host numpy: the octree's codes and order, its cells, box and
sphere queries and volume splits, ``split_scene``'s chunks (median and
octree methods) and ``export_chunks``' files (byte-equal ``.mvs``) are held
equal (``densify --split-max-points`` through both CLIs:
tests/test_torch_cli.py).
"""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from openmvs_tpu import split as jsplit  # noqa: E402
from openmvs_tpu.utils import octree as joctree  # noqa: E402
from openmvs_tpu_torch import split  # noqa: E402
from openmvs_tpu_torch.utils import octree  # noqa: E402

torch.set_num_threads(1)


def _cloud(seed=5):
    rng = np.random.default_rng(seed)
    return np.r_[rng.normal(0, 1, (3000, 3)), rng.normal(4, 0.3, (2000, 3))]


def test_octree_build_and_cells_equal_jax():
    P = _cloud()
    a, b = octree.Octree.build(P), joctree.Octree.build(P)
    for f in ("points", "order", "codes", "origin"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.size == b.size
    for depth in (0, 1, 2, 5):
        ca, cb = list(a.cells(depth)), list(b.cells(depth))
        assert len(ca) == len(cb)
        assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                   for x, y in zip(ca, cb))
        cell = ca[len(ca) // 2][0]
        assert a.cell_range(depth, cell) == b.cell_range(depth, cell)
        assert all(np.array_equal(x, y) for x, y in zip(a.cell_box(depth, cell),
                                                        b.cell_box(depth, cell)))
    ix = np.arange(1024)
    assert np.array_equal(octree.morton3(ix, ix[::-1], ix // 3),
                          joctree.morton3(ix, ix[::-1], ix // 3))


@pytest.mark.parametrize("lo,hi", [([-1, -1, -1], [1, 1, 1]), ([3.5, 3.5, 3.5], [4.2, 4.6, 4.1]),
                                   ([-9, -9, -9], [9, 9, 9]), ([20, 20, 20], [21, 21, 21])])
def test_octree_collect_box_equal_jax(lo, hi):
    P = _cloud()
    got = octree.Octree.build(P).collect_box(lo, hi)
    assert np.array_equal(got, joctree.Octree.build(P).collect_box(lo, hi))
    want = np.flatnonzero(np.all((P >= lo) & (P <= hi), axis=1))
    assert np.array_equal(np.sort(got), want)


@pytest.mark.parametrize("center,radius", [([4.0, 4.0, 4.0], 0.5), ([0, 0, 0], 1.5),
                                           ([0, 0, 0], 0.01)])
def test_octree_collect_sphere_equal_jax(center, radius):
    P = _cloud()
    got = octree.Octree.build(P).collect_sphere(center, radius)
    assert np.array_equal(got, joctree.Octree.build(P).collect_sphere(center, radius))
    want = np.flatnonzero(np.linalg.norm(P - center, axis=1) <= radius)
    assert np.array_equal(np.sort(got), want)


@pytest.mark.parametrize("budget", [5000, 600, 50])
def test_octree_split_volume_equal_jax(budget):
    P = _cloud()
    a = octree.Octree.build(P).split_volume(budget)
    b = joctree.Octree.build(P).split_volume(budget)
    assert len(a) == len(b)
    assert all(all(np.array_equal(x, y) for x, y in zip(pa, pb)) for pa, pb in zip(a, b))


def _scenes(n=6000, seed=0):
    """tests/test_split.py's scene (6 cameras, n points each seen by the 2
    nearest cameras) built in both packages from the same arrays."""
    from openmvs_tpu import scene as jscene
    from openmvs_tpu.geometry import camera as jcamera
    from openmvs_tpu.io import mvs as jmvs

    from openmvs_tpu_torch import scene as pscene
    from openmvs_tpu_torch.geometry import camera as pcamera
    from openmvs_tpu_torch.io import mvs as pmvs

    rng = np.random.default_rng(seed)
    K = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1.0]])
    pts = rng.uniform([0, -2, 0], [10, 2, 2], (n, 3)).astype(np.float32)
    order = np.argsort(np.abs(pts[:, 0, None] - np.arange(6) * 2.0), axis=1)[:, :2]
    views = [np.sort(order[i]).astype(np.uint32) for i in range(n)]
    weights = [np.array([0.5, 1.0 + (i % 3)], np.float32) for i in range(n)]
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    out = []
    for S, cam, mvs in ((pscene, pcamera, pmvs), (jscene, jcamera, jmvs)):
        scene = S.Scene()
        for i in range(6):
            C = np.array([i * 2.0, 0, -5.0])
            scene.platforms.append(mvs.Platform(
                name=f"p{i}", cameras=[mvs.CameraRig(K=K, width=640, height=480)],
                poses=[mvs.Pose(R=np.eye(3), C=C)]))
            meta = mvs.ImageMeta(name=f"img{i}.jpg", id=i, platform_id=i)
            scene.images.append(S.SceneImage(meta=meta, camera=cam.Camera(K, np.eye(3), C),
                                             width=640, height=480))
        scene.pointcloud = S.PointCloud(points=pts.copy(), views=list(views),
                                        weights=list(weights), normals=normals.copy(),
                                        colors=colors.copy())
        out.append(scene)
    return out


@pytest.mark.parametrize("method,max_points,overlap", [("median", 2000, 0.1), ("median", 700, 0.0),
                                                       ("octree", 2000, 0.1),
                                                       ("octree", 500, 0.3)])
def test_split_and_export_equal_jax(tmp_path, method, max_points, overlap):
    port, jax = _scenes()
    kw = dict(max_points=max_points, overlap=overlap, min_image_points=20, method=method)
    a, b = split.split_scene(port, **kw), jsplit.split_scene(jax, **kw)
    assert len(a) == len(b) >= 3
    for x, y in zip(a, b):
        for f in ("bbox_min", "bbox_max", "point_idx", "image_idx"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f
    pa = split.export_chunks(port, a, str(tmp_path / "port"))
    pb = jsplit.export_chunks(jax, b, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in pa] == [os.path.basename(p) for p in pb]
    for x, y in zip(pa, pb):
        with open(x, "rb") as f, open(y, "rb") as g:
            assert f.read() == g.read(), x


def test_split_empty_cloud_raises():
    port, _ = _scenes(10)
    port.pointcloud.points = np.zeros((0, 3), np.float32)
    with pytest.raises(ValueError, match="no points"):
        split.split_scene(port)
