"""The texture slice (openmvs_tpu_torch/texture.py) against the JAX
package's (openmvs_tpu/texture.py) on the same scenes, on the CPU, and
tests/test_texture.py's checks on the port.

Both packages get the same color and gray arrays: the port cannot load
images, so the two-camera plane scene of tests/test_texture.py is rendered
in memory (``cv2.remap``, then the gray that the JAX loader's
``cvtColor`` gives). Everything but the labeling is copied host code, so
labels and texcoords must be equal; atlas texels may differ by one where
the blurs that replace OpenCV's round differently. Measured shares of
equal texels (all others within one): 1.0 on the plane scene, with TRW-S
and with global leveling; 0.99993896 with local leveling; 0.99999873 on
the height field; 0.99999491 on the mostly unseen mesh.
"""

import numpy as np
import pytest
import torch

from _torch_helpers import jax_scene

torch.set_num_threads(1)

TEXEL_SHARE = 0.999


def _plane_arrays(bright=0, gray_of_bright=False):
    """tests/test_texture.py's plane_scene as arrays: a random 64x64 RGB
    texture on the plane z=4, seen by two cameras 0.4 apart at 320x240.
    ``bright`` is added to view 1's colors after its gray is taken (the
    brightness step test_texture.py puts on the loaded scene), or before
    with ``gray_of_bright``, which makes the labeling use both views."""
    import cv2

    rng = np.random.default_rng(0)
    H, W, f = 240, 320, 300.0
    K = np.array([[f, 0, W / 2 - 0.5], [0, f, H / 2 - 0.5], [0, 0, 1.0]])
    tex = rng.uniform(0, 255, (64, 64, 3)).astype(np.uint8)
    grays, colors, Cs = [], [], []
    for i, cx in enumerate((0.0, 0.4)):
        C = np.array([cx, 0, 0.0])
        uu, vv = np.meshgrid(np.arange(W, dtype=float), np.arange(H, dtype=float))
        x = (uu - K[0, 2]) / f * 4.0 + C[0]
        y = (vv - K[1, 2]) / f * 4.0 + C[1]
        tu = (x * 16 + 32) % 64
        tv = (y * 16 + 32) % 64
        img = cv2.remap(tex, tu.astype(np.float32), tv.astype(np.float32),
                        cv2.INTER_LINEAR)
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY).astype(np.float32) / 255.0
        if i == 1 and bright:
            img = np.clip(img.astype(np.int32) + bright, 0, 255).astype(np.uint8)
            if gray_of_bright:
                gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY).astype(np.float32) / 255.0
        grays.append(gray)
        colors.append(img)
        Cs.append(C)
    return dict(grays=grays, Ks=[K] * 2, Rs=[np.eye(3)] * 2, Cs=Cs,
                points=np.zeros((0, 3), np.float32), point_views=[],
                colors=colors)


def _plane_mesh(nx=9, ny=7, sx=0.8, sy=0.6):
    """A grid of quads on z=4 (test_texture.py's 9x7 quad by default)."""
    from openmvs_tpu_torch.convert import mesh_from_numpy

    gx, gy = np.meshgrid(np.linspace(-sx, sx, nx), np.linspace(-sy, sy, ny))
    verts = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 4.0)], -1)
    a = (np.arange(ny - 1)[:, None] * nx + np.arange(nx - 1)[None]).ravel()
    faces = np.stack([np.stack([a, a + 1, a + nx], -1),
                      np.stack([a + 1, a + nx + 1, a + nx], -1)], 1).reshape(-1, 3)
    return mesh_from_numpy(verts, faces)


def _scenes(arrays):
    from openmvs_tpu_torch.convert import scene_from_arrays

    return scene_from_arrays(**arrays), jax_scene(arrays)


def _jax_mesh(mesh):
    from openmvs_tpu.scene import Mesh

    return Mesh(vertices=mesh.vertices.copy(), faces=mesh.faces.copy())


def _both(arrays, mesh, monkeypatch, **opts):
    """(port textured mesh, port labels, JAX textured mesh, JAX labels) of
    texture_mesh with TextureOptions(**opts); the JAX labels are the ones
    its texture_mesh hands generate_texture."""
    from openmvs_tpu import texture as jt
    from openmvs_tpu.config import TextureOptions as JOpts
    from openmvs_tpu_torch import texture as pt
    from openmvs_tpu_torch.config import TextureOptions

    scene, jscene = _scenes(arrays)
    stats = {}
    out = pt.texture_mesh(scene, mesh, TextureOptions(**opts), device="cpu",
                          stats=stats)
    seen = {}
    generate = jt.generate_texture

    def keep_labels(scene, mesh, labels, *a, **kw):
        seen["labels"] = np.array(labels)
        return generate(scene, mesh, labels, *a, **kw)

    monkeypatch.setattr(jt, "generate_texture", keep_labels)
    jout = jt.texture_mesh(jscene, _jax_mesh(mesh), JOpts(**opts))
    return out, stats, jout, seen["labels"]


def _assert_slice_equal(out, stats, jout, jlabels):
    assert np.array_equal(stats["labels"], jlabels)
    assert out.face_tex_coords.shape == jout.face_tex_coords.shape
    np.testing.assert_allclose(out.face_tex_coords, jout.face_tex_coords,
                               rtol=0, atol=1e-6)
    pages = out.textures if out.textures is not None else [out.texture]
    jpages = jout.textures if jout.textures is not None else [jout.texture]
    assert [p.shape for p in pages] == [p.shape for p in jpages]
    for p, jp in zip(pages, jpages):
        assert p.dtype == np.uint8
        d = np.abs(p.astype(np.int16) - jp.astype(np.int16))
        assert d.max() <= 1
        assert (d == 0).mean() >= TEXEL_SHARE


@pytest.fixture(scope="module")
def plane():
    return _plane_arrays(), _plane_mesh()


@pytest.fixture(scope="module")
def height_field():
    from openmvs_tpu_torch.synthetic import build_gt_scene, height_field_mesh

    _, _, arrays = build_gt_scene(n_views=3, W=160, H=120, color=True)
    return arrays, height_field_mesh(40)


@pytest.mark.parametrize("which", ["plane", "height_field"])
def test_face_qualities_and_outliers_equal_jax(which, request):
    from openmvs_tpu import texture as jt
    from openmvs_tpu_torch import texture as pt

    arrays, mesh = request.getfixturevalue(which)
    scene, jscene = _scenes(arrays)
    q, fc = pt.compute_face_qualities(scene, mesh, 320)
    jq, jfc = jt.compute_face_qualities(jscene, _jax_mesh(mesh), 320)
    assert np.array_equal(q, jq) and (q > 0).any()
    assert all(np.array_equal(a, b) for a, b in zip(fc, jfc))
    assert np.array_equal(pt.remove_outlier_views(q, fc, 0.6e-2),
                          jt.remove_outlier_views(jq, jfc, 0.6e-2))
    assert np.array_equal(pt._face_adjacency(mesh.faces),
                          jt._face_adjacency(mesh.faces))


@pytest.mark.parametrize("which", ["plane", "height_field"])
def test_texture_mesh_matches_jax(which, request, monkeypatch):
    arrays, mesh = request.getfixturevalue(which)
    out, stats, jout, jlabels = _both(arrays, mesh, monkeypatch)
    _assert_slice_equal(out, stats, jout, jlabels)
    assert out.has_texture and stats["pages"] == 1
    assert (out.face_tex_coords >= 0).all() and (out.face_tex_coords <= 1).all()
    assert set(stats["stages_s"]) == {"qualities", "outliers", "adjacency",
                                      "labeling", "global_leveling",
                                      "local_leveling", "sharpen", "generate"}
    if which == "height_field":
        # the synthetic scene leaves faces without a pixel in any view
        assert 0 < stats["unseen_share"] < 0.5 and not stats["restricted_mrf"]


def test_texture_colors_match_source(plane):
    """test_texture.py::test_texture_colors_match_source on the port: atlas
    colors at face centroids match view 0's pixels there."""
    from openmvs_tpu_torch.config import TextureOptions
    from openmvs_tpu_torch.convert import scene_from_arrays
    from openmvs_tpu_torch.texture import _project, texture_mesh

    arrays, mesh = plane
    scene = scene_from_arrays(**arrays)
    tex = texture_mesh(scene, mesh, TextureOptions(), device="cpu")
    th, tw, _ = tex.texture.shape
    errs = []
    for fi in range(0, len(mesh.faces), 7):
        tc = tex.face_tex_coords[fi].mean(axis=0)
        tx, ty = int(tc[0] * tw), int((1 - tc[1]) * th)
        atlas_col = tex.texture[np.clip(ty, 0, th - 1), np.clip(tx, 0, tw - 1)]
        cen = mesh.vertices[mesh.faces[fi]].mean(axis=0)
        pr = _project(scene.images[0].camera, cen[None])[0]
        img_col = scene.images[0].color[int(pr[1]), int(pr[0])]
        errs.append(np.abs(atlas_col.astype(float) - img_col).mean())
    assert np.median(errs) < 30.0


def test_trws_labeling_matches_jax(plane, monkeypatch):
    arrays, mesh = plane
    out, stats, jout, jlabels = _both(arrays, mesh, monkeypatch, inference="trws")
    _assert_slice_equal(out, stats, jout, jlabels)
    assert out.texture is not None and out.face_tex_coords.shape[0] == len(mesh.faces)


def test_virtual_faces_coherence(plane):
    """On the planar mesh a virtual-face threshold binds every face to one
    view, and the port's Potts costs and labels equal the JAX package's."""
    from openmvs_tpu import texture as jt
    from openmvs_tpu_torch import texture as pt

    arrays, mesh = plane
    scene, _ = _scenes(arrays)
    quality, _ = pt.compute_face_qualities(scene, mesh, 320)
    adj = pt._face_adjacency(mesh.faces)
    lam_edge = pt.virtual_face_lambda(mesh, adj, 1.0, threshold_deg=5.0)
    assert np.array_equal(lam_edge, jt.virtual_face_lambda(_jax_mesh(mesh), adj,
                                                           1.0, threshold_deg=5.0))
    assert np.all(lam_edge[adj >= 0] > 1.0)
    labels = pt.label_faces_lbp(quality, adj, 1.0, lam_edge=lam_edge, device="cpu")
    assert np.array_equal(labels, jt.label_faces_lbp(quality, adj, 1.0,
                                                     lam_edge=lam_edge))
    assert len(np.unique(labels[labels >= 0])) == 1


def _spread(tex):
    """Std over faces of the atlas brightness at each face's centroid."""
    th, tw = tex.texture.shape[:2]
    uv = tex.face_tex_coords.mean(axis=1)
    x = np.clip((uv[:, 0] * tw).astype(int), 0, tw - 1)
    y = np.clip(((1 - uv[:, 1]) * th).astype(int), 0, th - 1)
    return tex.texture[y, x].astype(float).mean(axis=1).std()


@pytest.mark.parametrize("level", ["global", "local"])
def test_seam_leveling_smooths_and_matches_jax(level, monkeypatch):
    """test_texture.py's leveling checks on the port: with view 1's colors
    brighter by 40 and weak smoothness, global or local leveling must not
    widen the brightness spread. Then, with view 1's gray brightened too,
    the labeling uses both views, and the leveled atlas (changed by the
    leveling) equals the JAX package's."""
    mesh = _plane_mesh()
    base = dict(global_seam_leveling=False, local_seam_leveling=False,
                ratio_data_smoothness=0.001)
    on_opts = dict(base, **{f"{level}_seam_leveling": True})
    arrays = _plane_arrays(bright=40)
    off, _, _, _ = _both(arrays, mesh, monkeypatch, **base)
    on, stats, jon, jlabels = _both(arrays, mesh, monkeypatch, **on_opts)
    _assert_slice_equal(on, stats, jon, jlabels)
    assert on.texture.dtype == np.uint8 and on.texture.shape == off.texture.shape
    assert _spread(on) <= _spread(off) + 1e-6

    arrays = _plane_arrays(bright=40, gray_of_bright=True)
    off, _, _, _ = _both(arrays, mesh, monkeypatch, **base)
    on, stats, jon, jlabels = _both(arrays, mesh, monkeypatch, **on_opts)
    assert len(np.unique(stats["labels"])) == 2
    _assert_slice_equal(on, stats, jon, jlabels)
    assert not np.array_equal(on.texture, off.texture)


def test_oversized_component_splits(plane):
    """A patch wider than the atlas page is split (as in the JAX package),
    every page fits the cap, and pages and texcoords equal JAX's."""
    from openmvs_tpu import texture as jt
    from openmvs_tpu.config import TextureOptions as JOpts
    from openmvs_tpu_torch import texture as pt
    from openmvs_tpu_torch.config import TextureOptions

    arrays, mesh = plane
    scene, jscene = _scenes(arrays)
    kw = dict(max_texture_size=64, global_seam_leveling=False,
              local_seam_leveling=False, sharpness_weight=0)
    labels = np.zeros(len(mesh.faces), np.int64)
    out = pt.generate_texture(scene, mesh, labels, TextureOptions(**kw), max_dim=256)
    jout = jt.generate_texture(jscene, _jax_mesh(mesh), labels, JOpts(**kw), max_dim=256)
    assert out.has_texture and out.textures is not None and len(out.textures) > 1
    for pg, jpg in zip(out.textures, jout.textures):
        assert pg.shape[0] <= 64 and pg.shape[1] <= 64
        assert np.array_equal(pg, jpg)
    assert np.array_equal(out.face_page, jout.face_page)
    assert np.array_equal(out.face_tex_coords, jout.face_tex_coords)


def test_restricted_mrf_on_a_mostly_unseen_mesh(monkeypatch):
    """Over 100k faces with most of them outside both views: the labeling
    runs on the seen faces and their one-ring only, and still equals the
    JAX package's."""
    arrays = _plane_arrays()
    mesh = _plane_mesh(nx=231, ny=231, sx=8.0, sy=8.0)    # 105,800 faces
    out, stats, jout, jlabels = _both(arrays, mesh, monkeypatch)
    assert len(mesh.faces) > 100_000 and stats["restricted_mrf"]
    assert stats["unseen_share"] > 0.5
    _assert_slice_equal(out, stats, jout, jlabels)


def test_texture_default_device_raises_without_a_card(plane):
    from openmvs_tpu_torch.config import TextureOptions
    from openmvs_tpu_torch.convert import scene_from_arrays
    from openmvs_tpu_torch.texture import texture_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    arrays, mesh = plane
    with pytest.raises(RuntimeError, match="cuda"):
        texture_mesh(scene_from_arrays(**arrays), mesh, TextureOptions())


def test_texture_needs_color_pixels(plane):
    from openmvs_tpu_torch.convert import scene_from_arrays
    from openmvs_tpu_torch.texture import texture_mesh

    arrays, mesh = plane
    with pytest.raises(ValueError, match="color"):
        texture_mesh(scene_from_arrays(**dict(arrays, colors=None)), mesh,
                     device="cpu")
    scene = scene_from_arrays(**arrays)
    scene.images[0].gray = None      # no file behind the image to load
    with pytest.raises(FileNotFoundError):
        texture_mesh(scene, mesh, device="cpu")


def test_synthetic_scene_colors():
    """build_gt_scene's color images: uint8 RGB of the gray's shape with
    distinct channels where rays hit the surface, and grays equal to the
    scene's without colors, which has none."""
    from openmvs_tpu_torch.synthetic import build_gt_scene

    scene, gts, arrays = build_gt_scene(n_views=2, W=80, H=60, color=True)
    plain, plain_gts, plain_arrays = build_gt_scene(n_views=2, W=80, H=60)
    assert "colors" not in plain_arrays
    for img, pimg, gt, pgt in zip(scene.images, plain.images, gts, plain_gts):
        assert pimg.color is None and np.array_equal(img.gray, pimg.gray)
        assert np.array_equal(gt, pgt)
    for img, gt in zip(scene.images, gts):
        assert img.color.dtype == np.uint8 and img.color.shape == (60, 80, 3)
        hit = gt > 0
        assert hit.mean() > 0.5
        c = img.color[hit].astype(float)
        assert (c.std(axis=0) > 10).all() and np.abs(c[:, 0] - c[:, 1]).mean() > 5
    assert all(a is img.color for a, img in zip(arrays["colors"], scene.images))
