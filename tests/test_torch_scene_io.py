"""Scene files of the port (``openmvs_tpu_torch/scene.py``, ``tower.py``,
``io/sml.py``) against the JAX package, on the CPU.

- ``Scene.load`` of a ``.mvs`` the JAX package wrote (images as JPEG
  files; pixel and normalised K) gives the JAX package's scene: platforms,
  cameras, sizes, paths, the cloud; ``Scene.save`` reads back in the JAX
  package to the same; geometry imports (.ply cloud and mesh, .obj, .glb,
  .dmap) equal the JAX package's.
- ``estimate_roi`` (modes 1 and 2) on a bounded ring scene and on the
  synthetic down-looking one, ROI and view-neighbour files both ways, and
  ``point_cloud_filter`` equal the JAX package's.
- ``init_tower_scene`` in modes 1-4 (and forced) on the tower fixture of
  tests/test_tower.py and on a scene that is no tower.
- ``dense_options_from_sml`` equals the JAX package's; a malformed boost
  "MVS project" archive raises in both packages instead of being misread.
"""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
Image = pytest.importorskip("PIL.Image")

from openmvs_tpu import scene as jscene_mod  # noqa: E402
from openmvs_tpu.geometry.camera import Camera as JaxCamera  # noqa: E402
from openmvs_tpu.io import mvs as jmvs  # noqa: E402
from openmvs_tpu_torch import scene as pscene_mod  # noqa: E402
from openmvs_tpu_torch.geometry.camera import Camera  # noqa: E402
from openmvs_tpu_torch.io import mvs as pmvs  # noqa: E402
from openmvs_tpu_torch.synthetic import build_gt_scene, write_scene_files  # noqa: E402
from test_tower import _tower_scene  # noqa: E402

torch.set_num_threads(1)


def _port_scene(js):
    """Port Scene with a JAX-package Scene's platforms, images (metadata,
    camera, size, path) and cloud."""
    s = pscene_mod.Scene()
    for p in js.platforms:
        s.platforms.append(pmvs.Platform(
            name=p.name,
            cameras=[pmvs.CameraRig(c.name, c.band_name, c.width, c.height, c.K, c.R, c.C)
                     for c in p.cameras],
            poses=[pmvs.Pose(q.R, q.C) for q in p.poses]))
    for im in js.images:
        m = im.meta
        meta = pmvs.ImageMeta(m.name, m.mask_name, m.platform_id, m.camera_id, m.pose_id,
                              m.id, m.min_depth, m.avg_depth, m.max_depth,
                              [pmvs.ViewScore(**vars(v)) for v in m.view_scores])
        s.images.append(pscene_mod.SceneImage(
            meta=meta, camera=Camera(im.camera.K, im.camera.R, im.camera.C),
            width=im.width, height=im.height, path=im.path))
    pc = js.pointcloud
    s.pointcloud = pscene_mod.PointCloud(
        points=np.array(pc.points), views=[np.array(v) for v in pc.views],
        weights=[np.array(w) for w in pc.weights], normals=np.array(pc.normals),
        colors=np.array(pc.colors))
    s.obb_rot, s.obb_min, s.obb_max = (np.array(js.obb_rot), np.array(js.obb_min),
                                       np.array(js.obb_max))
    return s


def _assert_scenes_equal(p, j):
    assert len(p.platforms) == len(j.platforms)
    for a, b in zip(p.platforms, j.platforms):
        assert a.name == b.name and len(a.cameras) == len(b.cameras)
        for ca, cb in zip(a.cameras, b.cameras):
            assert (ca.width, ca.height) == (cb.width, cb.height)
            assert all(np.array_equal(getattr(ca, k), getattr(cb, k)) for k in "KRC")
        assert all(np.array_equal(qa.R, qb.R) and np.array_equal(qa.C, qb.C)
                   for qa, qb in zip(a.poses, b.poses))
    assert len(p.images) == len(j.images)
    for a, b in zip(p.images, j.images):
        assert (a.path, a.width, a.height, a.meta.id, a.meta.name) == (
            b.path, b.width, b.height, b.meta.id, b.meta.name)
        assert all(np.array_equal(getattr(a.camera, k), getattr(b.camera, k)) for k in "KRC")
    pa, pb = p.pointcloud, j.pointcloud
    assert np.array_equal(pa.points, pb.points)
    assert all(np.array_equal(x, y) for x, y in zip(pa.views, pb.views))
    assert len(pa.views) == len(pb.views) and len(pa.weights) == len(pb.weights)
    assert all(np.array_equal(x, y) for x, y in zip(pa.weights, pb.weights))
    assert np.array_equal(pa.normals, pb.normals) and np.array_equal(pa.colors, pb.colors)
    for k in ("transform", "obb_rot", "obb_min", "obb_max"):
        assert np.array_equal(getattr(p, k), getattr(j, k)), k
    assert p.working_folder == j.working_folder


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("scene"))
    mvs, _, _, arrays = write_scene_files(folder, 3, 80, 60)
    return folder, mvs, arrays


def test_load_jax_written_mvs(files, tmp_path):
    """A .mvs written by the JAX package, with one camera in normalised K
    (width and height 0: the size comes from the JPEG's header)."""
    folder, mvs, _ = files
    js = jscene_mod.Scene.load(mvs)
    rig = js.platforms[1].cameras[0]
    rig.K = rig.K / max(rig.width, rig.height)
    rig.K[2, 2] = 1.0
    rig.width = rig.height = 0
    js.pointcloud.normals = np.random.default_rng(0).normal(
        size=(len(js.pointcloud), 3)).astype(np.float32)
    js.pointcloud.colors = np.random.default_rng(1).integers(
        0, 256, (len(js.pointcloud), 3)).astype(np.uint8)
    js.save(str(tmp_path / "j.mvs"))
    _assert_scenes_equal(pscene_mod.Scene.load(str(tmp_path / "j.mvs")),
                         jscene_mod.Scene.load(str(tmp_path / "j.mvs")))
    p = pscene_mod.Scene.load(str(tmp_path / "j.mvs"))
    assert (p.images[1].width, p.images[1].height) == (80, 60)


def test_save_reads_back_in_jax(files, tmp_path):
    folder, mvs, arrays = files
    p = pscene_mod.Scene.load(mvs)
    p.estimate_roi(1)
    p.images[0].meta.view_scores = [pmvs.ViewScore(2, 11, 1.0, 0.25, 0.5, 3.0)]
    p.save(str(tmp_path / "p.mvs"))
    j = jscene_mod.Scene.load(str(tmp_path / "p.mvs"))
    _assert_scenes_equal(pscene_mod.Scene.load(str(tmp_path / "p.mvs")), j)
    assert np.array_equal(j.pointcloud.points, arrays["points"])
    assert j.images[0].meta.view_scores[0].points == 11
    # a scene built in memory gets one platform per image, as in JAX
    scene, _, _ = build_gt_scene(n_views=2, W=40, H=30)
    scene.save(str(tmp_path / "mem.mvs"))
    j = jscene_mod.Scene.load(str(tmp_path / "mem.mvs"))
    assert len(j.platforms) == 2 and np.array_equal(j.images[1].camera.C,
                                                    scene.images[1].camera.C)


def test_geometry_imports_equal_jax(tmp_path):
    from openmvs_tpu.io import dmap as jdmap
    from openmvs_tpu.io import ply as jply

    from openmvs_tpu_torch.synthetic import height_field_mesh

    g = height_field_mesh(6)
    jply.save_mesh(str(tmp_path / "m.ply"), g.vertices, g.faces)
    r = np.random.default_rng(2)
    pts = r.normal(size=(50, 3)).astype(np.float32)
    jply.save_point_cloud(str(tmp_path / "c.ply"), pts,
                          normals=r.normal(size=(50, 3)).astype(np.float32),
                          colors=r.integers(0, 256, (50, 3)).astype(np.uint8))
    s = pscene_mod.Scene()
    s.mesh = pscene_mod.Mesh(vertices=g.vertices, faces=g.faces)
    s.save_mesh(str(tmp_path / "m.obj"))
    s.save_mesh(str(tmp_path / "m.glb"))
    depth = r.uniform(2, 3, (12, 16)).astype(np.float32)
    depth[r.random(depth.shape) < 0.3] = 0
    K = np.array([[20.0, 0, 7.5], [0, 20.0, 5.5], [0, 0, 1]])
    jdmap.save(jdmap.DepthData(depth=depth, image_width=32, image_height=24, depth_min=2,
                               depth_max=3, file_name="a.jpg",
                               view_ids=np.array([4, 1], np.uint32), K=K, R=np.eye(3),
                               C=np.array([0.1, 0.0, 0.0]),
                               normal=r.normal(size=(12, 16, 3)).astype(np.float32)),
               str(tmp_path / "d.dmap"))
    for name in ("m.ply", "c.ply", "m.obj", "m.glb", "d.dmap"):
        path = str(tmp_path / name)
        p, j = pscene_mod.Scene.load(path), jscene_mod.Scene.load(path)
        assert np.array_equal(p.mesh.vertices, j.mesh.vertices), name
        assert np.array_equal(p.mesh.faces, j.mesh.faces), name
        _assert_scenes_equal(p, j)


def test_boost_project_archive_raises(tmp_path):
    """A boost project archive is read as one since the port has the codec
    (tests/test_torch_boost_archive.py): a malformed one (version 0)
    raises UnsupportedArchive in both packages instead of being misread."""
    from openmvs_tpu.io import boost_archive as jbar
    from openmvs_tpu_torch.io import boost_archive as pbar

    (tmp_path / "p.mvs").write_bytes(b"MVS\x00" + bytes(32))
    with pytest.raises(pbar.UnsupportedArchive, match="version 0"):
        pscene_mod.Scene.load(str(tmp_path / "p.mvs"))
    with pytest.raises(jbar.UnsupportedArchive, match="version 0"):
        jscene_mod.Scene.load(str(tmp_path / "p.mvs"))


def _ring_scene():
    """Eight cameras on a ring looking at the origin, a cloud around it:
    a bounded scene."""
    from test_tower import _look_at

    js = jscene_mod.Scene()
    K = np.array([[300, 0, 160], [0, 300, 120], [0, 0, 1.0]])
    for i in range(8):
        a = 2 * np.pi * i / 8
        C = np.array([5 * np.cos(a), 5 * np.sin(a), 1.0 + 0.1 * i])
        R = _look_at(C, np.zeros(3))
        js.images.append(jscene_mod.SceneImage(
            meta=jmvs.ImageMeta(name=f"{i}.jpg", id=i), camera=JaxCamera(K, R, C),
            width=320, height=240))
    r = np.random.default_rng(5)
    pts = r.normal(size=(400, 3)).astype(np.float32)
    pts[:10] *= 40                      # far outliers, seen by one camera
    js.pointcloud = jscene_mod.PointCloud(
        points=pts, views=[np.sort(r.choice(8, 3, replace=False)).astype(np.uint32)
                           for _ in range(400)],
        weights=[np.ones(3, np.float32)] * 400)
    return js


def _down_scene():
    from _torch_helpers import jax_scene

    _, _, arrays = build_gt_scene(n_views=3, W=40, H=30)
    return jax_scene(arrays)


@pytest.mark.parametrize("make", [_ring_scene, _down_scene])
@pytest.mark.parametrize("mode", [1, 2])
def test_estimate_roi_and_roi_files(tmp_path, make, mode):
    js = make()
    ps = _port_scene(js)
    assert ps.estimate_roi(mode) == js.estimate_roi(mode)
    for k in ("obb_rot", "obb_min", "obb_max"):
        assert np.array_equal(getattr(ps, k), getattr(js, k)), k
    if ps.is_bounded():
        ps.save_roi(str(tmp_path / "p.txt"))
        js.save_roi(str(tmp_path / "j.txt"))
        assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
        back = _port_scene(make())
        back.load_roi(str(tmp_path / "j.txt"))
        jback = make()
        jback.load_roi(str(tmp_path / "p.txt"))
        assert np.array_equal(back.obb_min, jback.obb_min)
        assert np.array_equal(back.roi_contains(back.pointcloud.points),
                              jback.roi_contains(jback.pointcloud.points))


def test_view_neighbor_files(tmp_path):
    js = _ring_scene()
    ps = _port_scene(js)
    (tmp_path / "n.txt").write_text("# id neighbours\n0 1 2 7\n3 2 4\n5\n9 1\n")
    ps.load_view_neighbors(str(tmp_path / "n.txt"))
    js.load_view_neighbors(str(tmp_path / "n.txt"))
    for a, b in zip(ps.images, js.images):
        assert [vars(v) for v in a.meta.view_scores] == [vars(v) for v in b.meta.view_scores]
    ps.save_view_neighbors(str(tmp_path / "p.txt"))
    js.save_view_neighbors(str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()


@pytest.mark.parametrize("th", [-1, 0, -3])
def test_point_cloud_filter_equals_jax(th):
    js = _ring_scene()
    r = np.random.default_rng(9)
    js.pointcloud.normals = r.normal(size=(400, 3)).astype(np.float32)
    js.pointcloud.colors = r.integers(0, 256, (400, 3)).astype(np.uint8)
    ps = _port_scene(js)
    assert ps.point_cloud_filter(th) == js.point_cloud_filter(th)
    _assert_scenes_equal(ps, js)


@pytest.mark.parametrize("mode", [1, 2, 3, 4, -2, 0])
def test_init_tower_scene_equals_jax(mode):
    from openmvs_tpu.tower import init_tower_scene as jax_tower

    from openmvs_tpu_torch.tower import init_tower_scene

    js = _tower_scene()
    ps = _port_scene(js)
    assert init_tower_scene(ps, mode) == jax_tower(js, mode) == (mode != 0)
    _assert_scenes_equal(ps, js)
    for a, b in zip(ps.images, js.images):
        assert [vars(v) for v in a.meta.view_scores] == [vars(v) for v in b.meta.view_scores]
    if abs(mode) in (3, 4):
        assert all(im.meta.view_scores for im in ps.images)


@pytest.mark.parametrize("mode", [1, 4])
def test_non_tower_scene_is_left_alone(mode):
    from openmvs_tpu.tower import init_tower_scene as jax_tower

    from openmvs_tpu_torch.tower import init_tower_scene

    js = _down_scene()
    ps = _port_scene(js)
    assert not init_tower_scene(ps, mode) and not jax_tower(js, mode)
    _assert_scenes_equal(ps, js)


def test_dense_options_from_sml_equal_jax(tmp_path):
    import dataclasses

    from openmvs_tpu.config import DenseOptions as JaxOptions
    from openmvs_tpu.io import sml as jsml

    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.io import sml

    text = ("NCC Threshold Keep = 0.8\nMin Views Fuse = 3\nFilter Adjust = 0\n"
            "Optim Angle = 10\nPairwise Mul = 0.3\nUnknown Title = 1\n"
            "Estimation Iters = 6\nInit Sparse = false\n\n[Child]\n{\n\tInner = 42\n}\n")
    (tmp_path / "d.ini").write_text(text)
    got = sml.dense_options_from_sml(str(tmp_path / "d.ini"))
    want = jsml.dense_options_from_sml(str(tmp_path / "d.ini"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.min_views_fuse == 3 and got.init_sparse is False
    sml.dense_options_to_sml(DenseOptions(), str(tmp_path / "p.ini"))
    jsml.dense_options_to_sml(JaxOptions(), str(tmp_path / "j.ini"))
    assert (tmp_path / "p.ini").read_text() == (tmp_path / "j.ini").read_text()
    node = sml.parse_sml(text)
    assert sml.dump_sml(node) == jsml.dump_sml(jsml.parse_sml(text))
    assert os.path.exists(tmp_path / "p.ini")
