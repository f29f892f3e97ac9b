"""The chain around meshing against the JAX package, on the CPU: a scene
with a mesh and no point cloud densified from mesh-seeded samples
(``sample_mesh_with_visibility``), the mesh rendered into depth maps
(``export_mesh_to_depth_maps``), refine's mesh conditioning, and the Scene
methods dense -> mesh -> clean -> refine -> texture -> save on the
120x160 scene.

Tolerances: the mesh seeding and the rendered depth maps are host code
(numpy and the copied rasterizer), so their arrays are equal. The
mesh-seeded densify is held as the other densify slice tests are
(``tests/test_torch_densify.py``): depths within 1e-3 relative on more
than 98.5% of the pixels valid in both, pooled, valid masks on more than
99%. The chain's meshes come from the two packages' dense clouds, which
differ by PatchMatch's argmin flips, so they are held to face counts within
5% and the same height error within 5%.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_helpers import (SLICE_OPTS, SLICE_VIEWS, depth_agreement,  # noqa: E402
                            slice_scenes)

from openmvs_tpu import densify as jd  # noqa: E402
from openmvs_tpu.config import DenseOptions as JaxOptions  # noqa: E402
from openmvs_tpu.io import dmap as jdmap  # noqa: E402
from openmvs_tpu.scene import Mesh as JaxMesh  # noqa: E402
from openmvs_tpu.scene import PointCloud as JaxPointCloud  # noqa: E402
from openmvs_tpu_torch import densify as pdens  # noqa: E402
from openmvs_tpu_torch.config import DenseOptions  # noqa: E402
from openmvs_tpu_torch.io import dmap as pdmap  # noqa: E402
from openmvs_tpu_torch.scene import PointCloud  # noqa: E402
from openmvs_tpu_torch.synthetic import height_field_mesh  # noqa: E402

torch.set_num_threads(1)


def _mesh_scenes(grid=96):
    """(port scene, JAX scene) of the slice's images with the height
    field's grid as their mesh and no point cloud."""
    scene, jscene = slice_scenes()
    mesh = height_field_mesh(grid)
    scene.pointcloud = PointCloud()
    scene.mesh = mesh
    jscene.pointcloud = JaxPointCloud()
    jscene.mesh = JaxMesh(vertices=mesh.vertices.copy(), faces=mesh.faces.copy())
    return scene, jscene


def test_mesh_seeded_dense_reconstruction_matches_jax(tmp_path):
    """A scene with a mesh and no cloud seeds from the mesh's visible
    samples in both packages (SceneDensify.cpp:1756-1766)."""
    scene, jscene = _mesh_scenes()
    pc = pdens.dense_reconstruction(scene, DenseOptions(**SLICE_OPTS),
                                    save_dmaps_to=str(tmp_path / "port"),
                                    device="cpu")
    jpc = jd.dense_reconstruction(jscene, JaxOptions(**SLICE_OPTS),
                                  save_dmaps_to=str(tmp_path / "jax"))
    name = "depth{:04d}.dmap"
    port = [pdmap.load(os.path.join(tmp_path / "port", name.format(i))).depth
            for i in range(SLICE_VIEWS)]
    ref = [jdmap.load(os.path.join(tmp_path / "jax", name.format(i))).depth
           for i in range(SLICE_VIEWS)]
    masks, pooled, per_view = depth_agreement(port, ref)
    msg = (f"points {len(pc)} vs {len(jpc)}, mask agreement {masks}, depth "
           f"agreement {pooled} (per view {per_view})")
    assert abs(len(pc) - len(jpc)) <= 0.02 * len(jpc), msg
    assert min(masks) > 0.99, msg
    assert pooled > 0.985, msg
    assert np.isfinite(pc.points).all() and len(pc) > 5000, msg


def test_sample_mesh_with_visibility_equals_jax():
    from openmvs_tpu.densify import sample_mesh_with_visibility as jax_sample

    scene, jscene = _mesh_scenes()
    pc = pdens.sample_mesh_with_visibility(scene, n_samples=5000, seed=2)
    jpc = jax_sample(jscene, n_samples=5000, seed=2)
    assert pc.points.dtype == jpc.points.dtype and np.array_equal(pc.points, jpc.points)
    assert len(pc) > 2000
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(pc.views, jpc.views)) and len(pc.views) == len(jpc.views)
    assert all(np.array_equal(a, b) for a, b in zip(pc.weights, jpc.weights))


@pytest.mark.parametrize("ext", [".dmap", ".pfm", ".png"])
def test_export_mesh_to_depth_maps_equals_jax(tmp_path, ext):
    """The mesh rendered into every view: .dmap and .pfm files equal to the
    JAX package's byte for byte, the 8-bit .png decoding to the pixels of
    the JAX package's cv2.imwrite."""
    scene, jscene = _mesh_scenes(40)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    n = pdens.export_mesh_to_depth_maps(scene, str(tmp_path / "port" / f"d{ext}"))
    jn = jd.export_mesh_to_depth_maps(jscene, str(tmp_path / "jax" / f"d{ext}"))
    assert n == jn == SLICE_VIEWS
    for i in range(n):
        a = tmp_path / "port" / f"d{i:04d}{ext}"
        b = tmp_path / "jax" / f"d{i:04d}{ext}"
        if ext == ".png":
            import cv2

            pa = cv2.imread(str(a), cv2.IMREAD_UNCHANGED)
            pb = cv2.imread(str(b), cv2.IMREAD_UNCHANGED)
            assert pa.dtype == pb.dtype == np.uint8 and np.array_equal(pa, pb)
            assert (pa > 0).mean() > 0.5
        else:
            assert a.read_bytes() == b.read_bytes()
    if ext == ".dmap":
        d = pdmap.load(str(tmp_path / "port" / "d0000.dmap"))
        assert (d.depth > 0).mean() > 0.5 and d.normal is not None


def test_export_mesh_to_depth_maps_other_image_format_raises(tmp_path):
    """8-bit visualizations in formats other than PNG, once refused, are
    written through io/images.write_image: a .bmp decodes to the pixels of
    the JAX package's cv2.imwrite, a .jpg (an encoder of its own, quality
    95 as OpenCV's default) to within 3 of them."""
    import cv2

    scene, jscene = _mesh_scenes(10)
    for ext, tol in ((".bmp", 0), (".jpg", 3)):
        n = pdens.export_mesh_to_depth_maps(scene, str(tmp_path / f"p{ext}"))
        jd.export_mesh_to_depth_maps(jscene, str(tmp_path / f"j{ext}"))
        assert n == SLICE_VIEWS
        for i in range(n):
            a = cv2.imread(str(tmp_path / f"p{i:04d}{ext}"), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(tmp_path / f"j{i:04d}{ext}"), cv2.IMREAD_UNCHANGED)
            assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= tol, ext


class _Stop(Exception):
    pass


def _first_scale_mesh(module, monkeypatch, *args):
    """The mesh ``module.refine_mesh(*args)`` hands its first scale, after
    the conditioning (the scales are not run)."""
    seen = {}

    def capture(scene, mesh, *a, **kw):
        seen["mesh"] = mesh
        raise _Stop

    monkeypatch.setattr(module, "_refine_at_scale", capture)
    with pytest.raises(_Stop):
        module.refine_mesh(*args)
    return seen["mesh"]


@pytest.mark.parametrize("opts", [dict(decimate=0.5), dict(ensure_edge_size=2),
                                  dict(decimate=0.5, ensure_edge_size=0)])
def test_refine_conditioning_equals_jax(monkeypatch, opts):
    """refine_mesh's conditioning (openmvs_tpu/refine.py:719-741): the mesh
    its first scale starts from equals the JAX package's."""
    import openmvs_tpu.refine as jr
    from openmvs_tpu.config import RefineOptions as JaxRefineOptions

    from openmvs_tpu_torch import refine as pr
    from openmvs_tpu_torch.config import RefineOptions
    from openmvs_tpu_torch.convert import mesh_from_numpy

    scene, jscene = slice_scenes()
    g = height_field_mesh(40)
    v = g.vertices.copy()
    v[:, 2] += np.random.default_rng(4).normal(0, 0.02, len(v)).astype(np.float32)
    got = _first_scale_mesh(pr, monkeypatch, scene, mesh_from_numpy(v, g.faces),
                            RefineOptions(**opts), "cpu")
    ref = _first_scale_mesh(jr, monkeypatch, jscene,
                            JaxMesh(vertices=v.copy(), faces=g.faces.copy()),
                            JaxRefineOptions(**opts))
    assert got.vertices.dtype == ref.vertices.dtype and got.faces.dtype == ref.faces.dtype
    assert np.array_equal(got.vertices, ref.vertices) and np.array_equal(got.faces, ref.faces)
    assert len(got.faces) != len(g.faces)


def test_scene_methods_chain_matches_jax(tmp_path):
    """pyOpenMVS's chain through the Scene methods of both packages on the
    120x160 scene with colors: dense_reconstruction -> reconstruct_mesh ->
    clean_mesh(decimate=0.5) -> refine_mesh (one scale, 4 iterations) ->
    texture_mesh -> save. The clouds differ by PatchMatch's argmin flips, so
    the meshes are held to the JAX package's face counts within 5% and its
    height errors within 5% (``chip_smoke._mesh_height_quality``); what the
    port saves, the JAX package reads back equal."""
    from chip_smoke import _mesh_height_quality
    from openmvs_tpu.io import obj as jobj
    from openmvs_tpu.io import ply as jply

    from _torch_helpers import jax_scene
    from openmvs_tpu_torch.synthetic import build_gt_scene

    scene, _, arrays = build_gt_scene(n_views=SLICE_VIEWS, W=160, H=120, color=True)
    jscene = jax_scene(arrays)
    counts = {}
    for name, s, dev in (("port", scene, {"device": "cpu"}), ("jax", jscene, {})):
        assert s.dense_reconstruction(**SLICE_OPTS, **dev)
        counts[name] = {"points": len(s.pointcloud)}
        assert s.reconstruct_mesh()
        counts[name]["raw"] = len(s.mesh.faces)
        assert s.clean_mesh(decimate=0.5)
        counts[name]["clean"] = len(s.mesh.faces)
        counts[name]["clean_error"] = _mesh_height_quality(s.mesh.vertices)[0]
        assert s.refine_mesh(scales=1, iters=4, **dev)
        counts[name]["refined_error"] = _mesh_height_quality(s.mesh.vertices)[0]
        assert s.texture_mesh(**dev)
    p, j = counts["port"], counts["jax"]
    for k in ("points", "raw", "clean"):
        assert abs(p[k] - j[k]) <= 0.05 * j[k], counts
    for k in ("clean_error", "refined_error"):
        assert p[k] <= 1.05 * j[k], counts
    assert p["refined_error"] <= p["clean_error"], counts

    scene.save_pointcloud(str(tmp_path / "dense.ply"))
    scene.save_mesh(str(tmp_path / "mesh.obj"))
    scene.save_mesh(str(tmp_path / "mesh.ply"))
    cloud = jply.load(str(tmp_path / "dense.ply"))
    assert np.array_equal(cloud.vertices, scene.pointcloud.points)
    mesh = jply.load(str(tmp_path / "mesh.ply"))
    assert np.array_equal(mesh.vertices, scene.mesh.vertices)
    assert np.array_equal(mesh.faces, scene.mesh.faces)
    v, f, tc, tex = jobj.load_mesh_obj(str(tmp_path / "mesh.obj"))
    assert np.abs(v - scene.mesh.vertices).max() <= 1e-5
    assert len(f) == len(scene.mesh.faces) and tc.shape == (len(f), 3, 2)
    pages = scene.mesh.textures or [scene.mesh.texture]
    assert np.array_equal(tex, pages[-1])
