"""The scene transforms of the port (``Scene.apply_transform``,
``transform34``, ``align_to``, ``scale_images``,
``compute_leveled_volume``, ``_rotation_between``) and its ``transform``
subcommand, against the JAX package's on the same files, on the CPU.

The scene is the synthetic colored one written as files
(``synthetic.write_scene_files``: 3 JPEGs of 160x120 and ``scene.mvs``),
loaded by each package. Everything here is host numpy in both, so results
are held equal: saved ``.mvs`` bytes, camera and point arrays, volumes,
rescaled JPEG bytes (the same area resize and encoder). The one tolerance:
``scale_images`` keeps a float32 gray image in memory, which OpenCV
resizes in float32 and the port in float64 (``io/images.resize_area``)
where the factor is not a halving; those grays agree within 1e-6.
"""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("PIL")

from openmvs_tpu import scene as jscene  # noqa: E402
from openmvs_tpu.__main__ import main as jax_main  # noqa: E402
from openmvs_tpu_torch import scene as pscene  # noqa: E402
from openmvs_tpu_torch.__main__ import main  # noqa: E402
from openmvs_tpu_torch.synthetic import height_field_mesh, write_scene_files  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    folder = tmp_path_factory.mktemp("transform")
    mvs, _, _, _ = write_scene_files(str(folder), 3, 160, 120)
    return folder, mvs


def _both(mvs, mesh=None, normals=False):
    scenes = [pscene.Scene.load(mvs), jscene.Scene.load(mvs)]
    if mesh is not None:
        scenes[0].mesh = pscene.Mesh(vertices=mesh.vertices.copy(), faces=mesh.faces.copy())
        scenes[1].mesh = jscene.Mesh(vertices=mesh.vertices.copy(), faces=mesh.faces.copy())
    if normals:
        n = np.random.default_rng(0).normal(size=(len(scenes[0].pointcloud.points), 3))
        for s in scenes:
            s.pointcloud.normals = n.astype(np.float32)
    return scenes


def _saved_equal(tmp_path, port, jax, name="s"):
    port.save(str(tmp_path / f"{name}_p.mvs"))
    jax.save(str(tmp_path / f"{name}_j.mvs"))
    return (tmp_path / f"{name}_p.mvs").read_bytes() == (tmp_path / f"{name}_j.mvs").read_bytes()


def _similarity(angle=0.4, scale=1.7):
    c, s = np.cos(angle), np.sin(angle)
    T = np.eye(4)
    T[:3, :3] = scale * np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T[:3, 3] = [0.3, -1.2, 2.0]
    return T


@pytest.mark.parametrize("kind", ["4x4", "3x4"])
def test_apply_transform_equal_jax(files, tmp_path, kind):
    _, mvs = files
    port, jax = _both(mvs, height_field_mesh(12), normals=True)
    T = _similarity()
    if kind == "4x4":
        port.apply_transform(T)
        jax.apply_transform(T)
    else:
        port.transform34(T[:3])
        jax.transform34(T[:3])
    assert np.array_equal(port.transform, jax.transform)
    assert np.array_equal(port.pointcloud.normals, jax.pointcloud.normals)
    assert np.array_equal(port.mesh.vertices, jax.mesh.vertices)
    for a, b in zip(port.images, jax.images):
        assert np.array_equal(a.camera.P, b.camera.P)
    assert _saved_equal(tmp_path, port, jax)


def test_align_to_equal_jax(files, tmp_path):
    _, mvs = files
    port, jax = _both(mvs)
    for s in (port, jax):
        s.apply_transform(_similarity(0.9, 0.6))
    pref, jref = _both(mvs)
    T = port.align_to(pref)
    assert np.array_equal(T, jax.align_to(jref))
    assert _saved_equal(tmp_path, port, jax)
    back = np.stack([im.camera.C for im in port.images])
    np.testing.assert_allclose(back, [im.camera.C for im in pref.images], atol=1e-9)


@pytest.mark.parametrize("kw", [dict(max_resolution=80), dict(max_resolution=100),
                                dict(scale=0.5), dict(max_resolution=400)])
def test_scale_images_equal_jax(files, tmp_path, kw):
    from openmvs_tpu_torch.io import images as imio

    _, mvs = files
    port, jax = _both(mvs)
    n = port.scale_images(folder=str(tmp_path / "port"), **kw)
    assert n == jax.scale_images(folder=str(tmp_path / "jax"), **kw)
    assert n == (0 if kw.get("max_resolution") == 400 else 3)
    for a, b in zip(port.images, jax.images):
        assert (a.width, a.height) == (b.width, b.height)
        assert np.array_equal(a.camera.K, b.camera.K)
        assert np.array_equal(a.color, b.color)
        assert a.gray.dtype == b.gray.dtype == np.float32
        np.testing.assert_allclose(a.gray, b.gray, rtol=0, atol=1e-6)
        if n:
            assert (os.path.basename(a.path) == os.path.basename(b.path)
                    and a.path.startswith(str(tmp_path / "port")))
            with open(a.path, "rb") as f, open(b.path, "rb") as g:
                assert f.read() == g.read()
            assert imio.image_size(a.path) == (a.width, a.height)


@pytest.mark.parametrize("plane_threshold,sample_mesh,up_axis", [
    (20.0, -20000, 2), (0.0, -5000, 2), (20.0, 0, 2), (0.05, 40.0, 2), (-1.0, 0, 2),
    (20.0, -3000, 0), (20.0, -3000, 1)])
def test_compute_leveled_volume_equal_jax(files, plane_threshold, sample_mesh, up_axis):
    """Every branch: sampled, vertices or density-sampled ground points;
    the RANSAC threshold given, AC-RANSAC's (0), or no leveling (< 0)."""
    _, mvs = files
    mesh = height_field_mesh(24)
    mesh.vertices[:, 2] -= 5.5          # a hill rising through the z = 0 plane
    port, jax = _both(mvs, mesh)
    got = port.compute_leveled_volume(plane_threshold, sample_mesh, up_axis)
    assert got == jax.compute_leveled_volume(plane_threshold, sample_mesh, up_axis)
    assert np.array_equal(port.mesh.vertices, jax.mesh.vertices)
    assert np.array_equal(port.transform, jax.transform)
    assert np.isfinite(got)


def test_rotation_between_equal_jax():
    r = np.random.default_rng(4)
    pairs = [(v / np.linalg.norm(v), w / np.linalg.norm(w))
             for v, w in r.normal(size=(20, 2, 3))]
    e = np.array([0.0, 0.0, 1.0])
    pairs += [(e, -e), (np.array([1.0, 0, 0]), np.array([-1.0, 0, 0])), (e, e)]
    for a, b in pairs:
        R = pscene._rotation_between(a, b)
        assert np.array_equal(R, jscene._rotation_between(a, b))
        np.testing.assert_allclose(R @ a, b, atol=1e-12)


def _matrix_file(path, rows):
    np.savetxt(path, _similarity()[:rows])
    return path


@pytest.mark.parametrize("case", ["matrix12", "matrix16", "align", "max_resolution",
                                  "volume"])
def test_transform_cli_equal_jax(files, tmp_path, capsys, case):
    """``transform`` through both CLIs: the same output scene (bytes), the
    same printed lines (paths aside)."""
    from openmvs_tpu_torch.io import ply

    folder, mvs = files
    extra = {"matrix12": ["--matrix", _matrix_file(str(tmp_path / "m.txt"), 3)],
             "matrix16": ["--matrix", _matrix_file(str(tmp_path / "m.txt"), 4)],
             "align": ["--align-file", str(tmp_path / "ref.mvs")],
             "max_resolution": ["--max-resolution", "100"],
             "volume": ["--mesh-file", str(tmp_path / "hill.ply"), "--compute-volume",
                        "--sample-mesh", "-5000"]}[case]
    if case == "align":
        ref, _ = _both(mvs)
        ref.apply_transform(_similarity(0.2, 2.0))
        ref.save(str(tmp_path / "ref.mvs"))
    if case == "volume":
        mesh = height_field_mesh(16)
        mesh.vertices[:, 2] -= 5.5
        ply.save_mesh(str(tmp_path / "hill.ply"), mesh.vertices, mesh.faces)
    printed = []
    # "p" and "j": output folders whose paths have the same length
    for who, run in (("p", main), ("j", jax_main)):
        out = tmp_path / who / "out.mvs"
        os.makedirs(out.parent)
        run(["transform", mvs] + extra + ["-o", str(out)])
        printed.append(capsys.readouterr().out.replace(str(tmp_path / who), "OUT"))
    assert printed[0] == printed[1]
    assert ((tmp_path / "p" / "out.mvs").read_bytes().replace(b"/p/", b"/j/")
            == (tmp_path / "j" / "out.mvs").read_bytes())
    if case == "max_resolution":
        names = sorted(os.listdir(tmp_path / "j" / "images_scaled"))
        assert len(names) == 3
        for name in names:
            assert ((tmp_path / "p" / "images_scaled" / name).read_bytes()
                    == (tmp_path / "j" / "images_scaled" / name).read_bytes())
