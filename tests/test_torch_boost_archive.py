"""The boost "MVS project" archive codec of the port
(``openmvs_tpu_torch/io/boost_archive.py``, ``Scene.save_project`` and
``Scene.load`` of an archive, ``native.emit_test_project``) against the JAX
package's, on the CPU.

- The port's writer equals the JAX writer byte for byte in all four archive
  types (TEXT, BINARY, BINARY_ZIP, BINARY_ZSTD), on the tiny project of
  tests/test_boost_archive.py and on a synthetic scene from
  ``openmvs_tpu_torch/synthetic.py`` with a textured mesh (one atlas page
  and two) and an OBB.
- Each package reads the other's archives to the same scene; the port
  reads the C++ emitter's golden archive, and the port's copy of the
  emitter writes the JAX package's bytes.
- ``Scene.save_project`` then ``Scene.load`` round-trips cameras, the
  cloud, the mesh, its texture and the OBB.
- Archives outside the documented subset raise ``UnsupportedArchive``, as
  they do in the JAX package, and so does a zstd archive without libzstd.
"""

import os
import struct

import numpy as np
import pytest

pytest.importorskip("jax")

import _torch_helpers  # noqa: E402,F401  (builds the JAX native library)
from openmvs_tpu import native as jnative  # noqa: E402
from openmvs_tpu import scene as jscene  # noqa: E402
from openmvs_tpu.io import boost_archive as jbar  # noqa: E402
from openmvs_tpu.io import mvs as jmvs  # noqa: E402
from openmvs_tpu_torch import native as pnative  # noqa: E402
from openmvs_tpu_torch import scene as pscene  # noqa: E402
from openmvs_tpu_torch.io import boost_archive as pbar  # noqa: E402
from openmvs_tpu_torch.io import mvs as pmvs  # noqa: E402
from openmvs_tpu_torch.synthetic import height_field_mesh, write_scene_files  # noqa: E402
from test_boost_archive import _check_tiny  # noqa: E402

ATYPES = ["text", "binary", "zip", "zstd"]


def _tiny(bar, mvsio):
    """tests/test_boost_archive.py's tiny project (the scene the C++
    emitter hard-codes), in the classes of either package."""
    K = np.array([[1.2, 0, 0.5], [0, 1.2, 0.48], [0, 0, 1]], np.float64)
    rig = mvsio.CameraRig(name="", K=K, R=np.eye(3), C=np.array([0.01, -0.02, 0.03]))
    poses = [mvsio.Pose(R=np.eye(3), C=np.array([0.5 * p, 0.0, -0.25 * p])) for p in range(2)]
    images = [
        bar.ProjectImage(platform_id=0, camera_id=0, pose_id=0, id=7,
                         name="images/00000.jpg", width=640, height=480,
                         neighbors=[mvsio.ViewScore(id=1, points=123, scale=1.0, angle=0.2,
                                                    area=0.8, score=3.5)],
                         avg_depth=2.5),
        bar.ProjectImage(platform_id=0, camera_id=0, pose_id=1, id=8,
                         name="images/00001.jpg", width=640, height=480,
                         neighbors=[], avg_depth=2.25),
    ]
    pts = np.array([[0, 0, 2], [1, 0, 2.5], [0, 1, 3]], np.float32)
    ps = bar.ProjectScene(
        platforms=[mvsio.Platform(name="rig0", cameras=[rig], poses=poses)], images=images,
        points=pts,
        point_views=[np.array([0, 1], np.uint32), np.array([0], np.uint32),
                     np.array([1], np.uint32)],
        point_weights=[np.array([0.5, 0.25], np.float32), np.array([1.0], np.float32),
                       np.array([2.0], np.float32)],
        normals=np.tile(np.array([[0, 0, -1]], np.float32), (3, 1)),
        colors=np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8),
        obb_rot=np.eye(3, dtype=np.float32), obb_pos=np.array([1, 2, 3], np.float32),
        obb_ext=np.array([4, 5, 6], np.float32))
    ps.mesh = bar.ProjectMesh(
        vertices=pts.copy(), faces=np.array([[0, 1, 2]], np.uint32),
        face_texcoords=np.array([[0.5, 0.5], [1.5, 0.5], [0.5, 1.5]], np.float32),
        face_texindices=np.array([0], np.uint8),
        textures=[np.arange(1, 13, dtype=np.uint8).reshape(2, 2, 3)])
    return ps


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("atype", ATYPES)
def test_tiny_writer_equals_jax_and_reads_back(tmp_path, atype):
    p, j = str(tmp_path / "port.mvs"), str(tmp_path / "jax.mvs")
    pbar.save_project(_tiny(pbar, pmvs), p, archive_type=atype)
    jbar.save_project(_tiny(jbar, jmvs), j, archive_type=atype)
    assert _read(p) == _read(j)
    _check_tiny(pbar.load_project(j))      # the port reads the JAX package's
    _check_tiny(jbar.load_project(p))      # and the JAX package the port's


def test_cpp_emitter_golden(tmp_path):
    """The port's copy of the C++ emitter writes the JAX package's golden
    bytes; the port decodes them and its binary writer repeats them."""
    g, jg, p = (str(tmp_path / n) for n in ("g.mvs", "jg.mvs", "p.mvs"))
    pnative.emit_test_project(g)
    jnative.emit_test_project(jg)
    assert _read(g) == _read(jg)
    _check_tiny(pbar.load_project(g))
    pbar.save_project(_tiny(pbar, pmvs), p, archive_type="binary")
    assert _read(p) == _read(g)


@pytest.fixture(scope="module")
def synthetic_mvs(tmp_path_factory):
    """The colored synthetic scene as 3 JPEGs of 64x48 and scene.mvs."""
    mvs, _, _, _ = write_scene_files(str(tmp_path_factory.mktemp("syn")), n_views=3,
                                     W=64, H=48)
    return mvs


def _dress(scene, mesh_cls, pages):
    """A textured mesh (the height field's 10-grid, ``pages`` atlas pages,
    faces spread over them) and an OBB on a loaded scene."""
    hm = height_field_mesh(10)
    r = np.random.default_rng(3)
    nf = len(hm.faces)
    m = mesh_cls(vertices=hm.vertices.copy(), faces=hm.faces.copy(),
                 face_tex_coords=r.uniform(0.05, 0.95, (nf, 3, 2)).astype(np.float32))
    texs = [r.integers(0, 256, (24 + 8 * k, 32, 3), dtype=np.uint8) for k in range(pages)]
    m.texture = texs[0]
    if pages > 1:
        m.textures = texs
        m.face_page = (np.arange(nf) % pages).astype(np.int32)
    scene.mesh = m
    c, s = np.cos(0.3), np.sin(0.3)
    scene.obb_rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    scene.obb_min = np.array([-3.5, -3.0, 4.0])
    scene.obb_max = np.array([3.5, 3.25, 8.0])
    return scene


@pytest.mark.parametrize("pages", [1, 2])
@pytest.mark.parametrize("atype", ATYPES)
def test_scene_writer_equals_jax(tmp_path, synthetic_mvs, atype, pages):
    """Scene.save_project of the same loaded scene, dressed alike, writes
    the JAX package's bytes; the JAX package's Scene.load of the port's
    archive and the port's of the JAX package's give the same scene."""
    ps = _dress(pscene.Scene.load(synthetic_mvs), pscene.Mesh, pages)
    js = _dress(jscene.Scene.load(synthetic_mvs), jscene.Mesh, pages)
    p, j = str(tmp_path / "port.mvs"), str(tmp_path / "jax.mvs")
    ps.save_project(p, archive_type=atype)
    js.save_project(j, archive_type=atype)
    assert _read(p) == _read(j)
    a, b = pscene.Scene.load(j), jscene.Scene.load(p)
    assert len(a.images) == len(b.images) == 3
    for x, y in zip(a.images, b.images):
        assert (x.width, x.height, x.path) == (y.width, y.height, y.path)
        assert all(np.array_equal(getattr(x.camera, k), getattr(y.camera, k)) for k in "KRC")
    assert np.array_equal(a.pointcloud.points, b.pointcloud.points)
    assert np.array_equal(a.mesh.faces, b.mesh.faces)
    assert np.array_equal(a.mesh.face_tex_coords, b.mesh.face_tex_coords)
    assert np.array_equal(a.mesh.texture, b.mesh.texture)
    assert np.array_equal(a.obb_min, b.obb_min) and np.array_equal(a.obb_max, b.obb_max)


@pytest.mark.parametrize("pages", [1, 2])
def test_save_project_load_roundtrip(tmp_path, synthetic_mvs, pages):
    """save_project -> Scene.load keeps cameras, cloud, mesh, texture and
    OBB (tolerances of tests/test_boost_archive.py: normalised K and
    pixel texcoords go through float32)."""
    ref = _dress(pscene.Scene.load(synthetic_mvs), pscene.Mesh, pages)
    p = str(tmp_path / "scene_project.mvs")
    ref.save_project(p)
    out = pscene.Scene.load(p)
    assert len(out.images) == len(ref.images)
    for a, b in zip(ref.images, out.images):
        np.testing.assert_allclose(b.camera.K, a.camera.K, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(b.camera.R, a.camera.R, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(b.camera.C, a.camera.C, rtol=1e-6, atol=1e-8)
        assert (b.width, b.height) == (a.width, a.height)
        assert os.path.abspath(b.path) == os.path.abspath(a.path)
    assert len(out.pointcloud) == len(ref.pointcloud) > 0
    np.testing.assert_array_equal(out.pointcloud.points, ref.pointcloud.points)
    assert [v.tolist() for v in out.pointcloud.views] == \
        [np.asarray(v).tolist() for v in ref.pointcloud.views]
    np.testing.assert_array_equal(out.mesh.faces, ref.mesh.faces)
    np.testing.assert_array_equal(out.mesh.vertices, ref.mesh.vertices)
    assert out.mesh.has_texture
    np.testing.assert_allclose(out.mesh.face_tex_coords, ref.mesh.face_tex_coords, atol=1e-5)
    np.testing.assert_array_equal(out.mesh.texture, ref.mesh.texture)
    if pages > 1:
        assert len(out.mesh.textures) == pages
        assert all(np.array_equal(x, y) for x, y in zip(out.mesh.textures, ref.mesh.textures))
        np.testing.assert_array_equal(out.mesh.face_page, ref.mesh.face_page)
    np.testing.assert_allclose(out.obb_rot, ref.obb_rot, atol=1e-7)
    np.testing.assert_allclose(out.obb_min, ref.obb_min, atol=1e-6)
    np.testing.assert_allclose(out.obb_max, ref.obb_max, atol=1e-6)
    # the CLI loads a project archive as it loads a .mvs
    assert len(pscene.Scene.load(p).images) == 3


def _bad_archives(tmp_path, bar, native):
    """(path, match) of archives outside the subset, as
    tests/test_boost_archive.py builds them."""
    out = []
    p = str(tmp_path / "bad.mvs")
    with open(p, "wb") as f:
        f.write(b"NOPE" + b"\0" * 32)
    out.append((p, None))
    p = str(tmp_path / "tracked.mvs")
    with open(p, "wb") as f:
        f.write(bar.PROJECT_MAGIC + struct.pack("<IIQ", 1, bar.ARCHIVE_BINARY, 0))
        f.write(b"\x01" + b"\x00" * 64)
    out.append((p, "MVSI"))
    g = str(tmp_path / "g.mvs")
    native.emit_test_project(g)
    p = str(tmp_path / "trunc.mvs")
    with open(p, "wb") as f:
        f.write(_read(g)[: len(_read(g)) // 2])
    out.append((p, None))
    p = str(tmp_path / "unk.mvs")
    with open(p, "wb") as f:
        f.write(bar.PROJECT_MAGIC + struct.pack("<IIQ", 1, 9, 0))
    out.append((p, "archive type"))
    p = str(tmp_path / "ver.mvs")
    with open(p, "wb") as f:
        f.write(bar.PROJECT_MAGIC + struct.pack("<IIQ", 2, bar.ARCHIVE_BINARY, 0))
    out.append((p, "version 2"))
    return out


def test_unsupported_variants_raise(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    for (p, match), (j, _) in zip(_bad_archives(tmp_path / "p", pbar, pnative),
                                  _bad_archives(tmp_path / "j", jbar, jnative)):
        with pytest.raises(pbar.UnsupportedArchive, match=match):
            pbar.load_project(p)
        with pytest.raises(jbar.UnsupportedArchive, match=match):
            jbar.load_project(j)
    with pytest.raises(ValueError, match="archive_type"):
        pbar.save_project(_tiny(pbar, pmvs), str(tmp_path / "x.mvs"), archive_type="lz4")


def test_zstd_without_libzstd_raises(tmp_path, monkeypatch):
    """Where the host has no libzstd, a zstd archive raises
    UnsupportedArchive naming the alternatives, as in the JAX package."""
    p = str(tmp_path / "z.mvs")
    pbar.save_project(_tiny(pbar, pmvs), p, archive_type="zstd")

    def no_lib(*a, **k):
        raise OSError("libzstd.so.1: cannot open shared object file")

    monkeypatch.setattr(pbar, "_zstd_singleton", None)
    monkeypatch.setattr(pbar.ctypes, "CDLL", no_lib)
    with pytest.raises(pbar.UnsupportedArchive, match="zlib"):
        pbar.load_project(p)
    with pytest.raises(pbar.UnsupportedArchive, match="zlib"):
        pbar.save_project(_tiny(pbar, pmvs), str(tmp_path / "z2.mvs"), archive_type="zstd")
