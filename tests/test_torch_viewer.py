"""The port's viewers (``openmvs_tpu_torch/viewer.py``, ``viewer_web.py``)
and the CLI's ``view`` against the JAX package's, on the CPU.

- ``render_mesh`` (textured and lambert-shaded) and ``render_point_cloud``
  (with and without colors) give the JAX package's frames, pixel for pixel
  (the rasterizers are the same C++ built with the same flags).
- ``python -m openmvs_tpu_torch.viewer`` writes a PNG of the JAX viewer's
  pixels (the JAX package saves through PIL, the port through ``io/png``).
- ``export_html`` writes the same data fields; where the mesh has an atlas,
  its PNG (``io/png`` here, ``cv2.imencode`` there) decodes to the same
  pixels, and the page is otherwise the same text.
- ``view`` through the CLI with ``-m`` (an OBJ, which both packages'
  ``Scene.load`` reads as geometry alone) writes the JAX CLI's page.
"""

import base64
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

import _torch_helpers  # noqa: E402,F401  (builds the JAX native library)
from openmvs_tpu import scene as jscene  # noqa: E402
from openmvs_tpu import viewer as jviewer  # noqa: E402
from openmvs_tpu import viewer_web as jweb  # noqa: E402
from openmvs_tpu.__main__ import main as jax_main  # noqa: E402
from openmvs_tpu_torch import scene as pscene  # noqa: E402
from openmvs_tpu_torch import viewer as pviewer  # noqa: E402
from openmvs_tpu_torch import viewer_web as pweb  # noqa: E402
from openmvs_tpu_torch.__main__ import main as port_main  # noqa: E402
from openmvs_tpu_torch.io import obj as objio  # noqa: E402
from openmvs_tpu_torch.io import ply as plyio  # noqa: E402
from openmvs_tpu_torch.synthetic import height_field_mesh, write_scene_files  # noqa: E402

torch.set_num_threads(1)


def _textured(mesh_cls, pages=1):
    hm = height_field_mesh(24)
    r = np.random.default_rng(5)
    nf = len(hm.faces)
    m = mesh_cls(vertices=hm.vertices.copy(), faces=hm.faces.copy(),
                 face_tex_coords=r.uniform(0.02, 0.98, (nf, 3, 2)).astype(np.float32))
    texs = [r.integers(0, 256, (64, 48, 3), dtype=np.uint8) for _ in range(pages)]
    m.texture = texs[0]
    if pages > 1:
        m.textures = texs
        m.face_page = (np.arange(nf) % pages).astype(np.int32)
    return m


@pytest.mark.parametrize("textured", [False, True])
def test_render_mesh_equals_jax(textured):
    if textured:
        p, j = _textured(pscene.Mesh), _textured(jscene.Mesh)
    else:
        hm = height_field_mesh(30)
        p = pscene.Mesh(vertices=hm.vertices, faces=hm.faces)
        j = jscene.Mesh(vertices=hm.vertices, faces=hm.faces)
    for az in (0.0, 30.0, 200.0):
        a = pviewer.render_mesh(p, azimuth_deg=az, size=(160, 120))
        b = jviewer.render_mesh(j, azimuth_deg=az, size=(160, 120))
        np.testing.assert_array_equal(a, b)
        assert (a != np.array([24, 24, 28], np.uint8)).any(-1).mean() > 0.1


@pytest.mark.parametrize("colors", [False, True])
def test_render_point_cloud_equals_jax(colors):
    r = np.random.default_rng(2)
    pts = r.normal(size=(3000, 3)).astype(np.float32)
    col = r.integers(0, 256, (3000, 3), dtype=np.uint8) if colors else None
    for az in (10.0, 120.0):
        a = pviewer.render_point_cloud(pts, col, azimuth_deg=az, size=(128, 96))
        b = jviewer.render_point_cloud(pts, col, azimuth_deg=az, size=(128, 96))
        np.testing.assert_array_equal(a, b)


def test_viewer_main_writes_jax_pixels(tmp_path):
    m = _textured(pscene.Mesh)
    path = str(tmp_path / "m.ply")
    plyio.save_mesh(path, m.vertices, m.faces)
    pviewer.main([path, "-o", str(tmp_path / "p.png"), "--size", "96x64"])
    jviewer.main([path, "-o", str(tmp_path / "j.png"), "--size", "96x64"])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    pviewer.main([path, "-o", str(tmp_path / "turn"), "--turntable", "3", "--size", "64x48"])
    assert sorted(os.listdir(tmp_path / "turn")) == [f"frame{i:03d}.png" for i in range(3)]


@pytest.fixture(scope="module")
def mvs(tmp_path_factory):
    path, _, _, _ = write_scene_files(str(tmp_path_factory.mktemp("view")), n_views=3,
                                      W=64, H=48)
    return path


def _data(html):
    start = html.index("const DATA = ") + len("const DATA = ")
    return json.loads(html[start:html.index(";\n", start)])


@pytest.mark.parametrize("pages", [0, 1, 2])
def test_export_html_equals_jax(tmp_path, mvs, pages):
    ps, js = pscene.Scene.load(mvs), jscene.Scene.load(mvs)
    if pages:
        ps.mesh, js.mesh = _textured(pscene.Mesh, pages), _textured(jscene.Mesh, pages)
    p = pweb.export_html(ps, str(tmp_path / "p.html"))
    j = jweb.export_html(js, str(tmp_path / "j.html"))
    with open(p) as f:
        hp = f.read()
    with open(j) as f:
        hj = f.read()
    dp, dj = _data(hp), _data(hj)
    assert sorted(dp) == sorted(dj)
    assert ("tex_png" in dp) == bool(pages)
    for k in dp:
        if k != "tex_png":
            assert dp[k] == dj[k], k
    if pages:
        a = cv2.imdecode(np.frombuffer(base64.b64decode(dp["tex_png"]), np.uint8),
                         cv2.IMREAD_UNCHANGED)
        b = cv2.imdecode(np.frombuffer(base64.b64decode(dj["tex_png"]), np.uint8),
                         cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(a, b)
        assert a.shape[0] == 64 * pages
    assert hp.replace(json.dumps(_data(hp)), "") == hj.replace(json.dumps(_data(hj)), "")


def test_view_through_the_cli(tmp_path, mvs, capsys):
    m = _textured(pscene.Mesh)
    mesh_path = str(tmp_path / "m.obj")
    objio.save_mesh_obj(mesh_path, m.vertices, m.faces, m.face_tex_coords, m.texture)
    port_main(["view", mvs, "-m", mesh_path, "-o", str(tmp_path / "p.html")])
    printed = capsys.readouterr().out
    jax_main(["view", mvs, "-m", mesh_path, "-o", str(tmp_path / "j.html")])
    assert capsys.readouterr().out.replace("j.html", "p.html") == printed
    with open(tmp_path / "p.html") as f:
        dp = _data(f.read())
    with open(tmp_path / "j.html") as f:
        dj = _data(f.read())
    assert sorted(dp) == sorted(dj) and "mesh_i" in dp
    assert dp == dj
