"""The port's mesh refinement (openmvs_tpu_torch/refine.py) against the JAX
package's (openmvs_tpu/refine.py) on the same numpy inputs, on the CPU.

Components are compared with the JAX functions jitted, as the JAX package
runs them inside its jitted iteration: XLA's CPU backend fuses
multiply-adds there, which the port repeats in the warp (so the valid
masks agree to the pixel), and rounds cumsum in blocks, which the port
repeats in the box sums. Gradient sums over pixels keep differences of
reduction order: they are held at rtol 1e-4 with an absolute tolerance of
1e-4 of their largest element (JAX's own jitted and eager
``_pairs_grad_faces`` differ by 10% of it on the slice inputs, where an
unfused warp flips pixels of the mask).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from _torch_helpers import jax_scene
from _torch_refine import allclose_to_max

torch.set_num_threads(1)

# the slice case: 3 views at 160x120, the height field's 22-grid with
# z-noise N(0, 0.05), two scales of 8 iterations
SLICE_OPTS = dict(scales=2, iters=8, max_face_area=64)


@pytest.fixture(scope="module")
def case():
    """Port scene, JAX scene, ground-truth mesh and noisy vertices."""
    from openmvs_tpu_torch.synthetic import build_gt_scene, height_field_mesh

    scene, _, arrays = build_gt_scene(n_views=3, W=160, H=120)
    gt = height_field_mesh(22)
    v0 = gt.vertices.copy()
    v0[:, 2] += np.random.default_rng(7).normal(0, 0.05, len(v0)).astype(np.float32)
    return scene, jax_scene(arrays), gt, v0


@pytest.fixture(scope="module")
def pairs_case(case):
    """Both packages' stacked PairData of the slice's full scale for the
    noisy mesh, and the mesh's arrays: (port pds, JAX pds, dict)."""
    import openmvs_tpu.refine as jr
    from openmvs_tpu_torch import refine as pr
    from openmvs_tpu_torch.config import DenseOptions, RefineOptions
    from openmvs_tpu_torch.view_selection import select_views_for_scene

    scene, _, gt, v0 = case
    select_views_for_scene(scene, DenseOptions())
    pairs = pr.select_pairs(scene, RefineOptions())
    grays, cams = pr.scaled_views(scene, 1.0)
    faces = gt.faces
    adj, deg = pr._vertex_adjacency(faces, len(v0))
    bnd = pr._vertex_boundary(faces, len(v0))
    statics = pr.build_statics(pairs, grays, cams)
    rasters = pr.build_rasters(pairs, grays, cams, faces, v0)
    mt = pr.mesh_tensors(v0, faces, adj, deg, bnd, "cpu")
    pds = pr._assemble_pair_data(pr.to_device(statics, "cpu"),
                                 pr.to_device(rasters, "cpu"), mt.faces)
    jpds = jax.jit(jr._assemble_pair_data)(
        jr.PairStatic(*map(jnp.asarray, statics)),
        jr.PairRaster(*map(jnp.asarray, rasters)), jnp.asarray(faces))
    return pds, jpds, dict(v0=v0, faces=faces, adj=adj, deg=deg, bnd=bnd,
                           mt=mt, pairs=pairs)


def _scalars(ratio=0.9):
    # step0, med_edge, reg_w, ratio as both packages take them
    vals = (0.5, 0.1, 0.2, ratio)
    return ([torch.tensor(x, dtype=torch.float32) for x in vals],
            [jnp.float32(x) for x in vals])


def test_refine_options_equal_field_for_field():
    from openmvs_tpu.config import RefineOptions as JaxOptions
    from openmvs_tpu_torch.config import RefineOptions

    assert dataclasses.asdict(RefineOptions()) == dataclasses.asdict(JaxOptions())
    assert ([f.name for f in dataclasses.fields(RefineOptions)]
            == [f.name for f in dataclasses.fields(JaxOptions)])


def test_decay_equals_jax_float32_pow():
    """The step decay 0.98^it: the port's correctly rounded float32 equals
    the float32 pow of the JAX package's jitted iteration
    (openmvs_tpu/refine.py:568) for it in 0..59, past the 25 iterations
    of a default scale."""
    from openmvs_tpu_torch.refine import _decay

    decay = jax.jit(lambda it: 0.98 ** it.astype(jnp.float32))
    for it in range(60):
        want = np.float32(decay(jnp.int32(it)))
        assert np.float32(_decay(it)) == want, it


def test_refine_default_device_raises_without_a_card(case):
    from openmvs_tpu_torch.convert import mesh_from_numpy
    from openmvs_tpu_torch.refine import refine_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    scene, _, gt, _ = case
    with pytest.raises(RuntimeError, match="cuda"):
        refine_mesh(scene, mesh_from_numpy(gt.vertices, gt.faces))


def test_rasterizer_bit_equal_to_jax_package(case):
    from openmvs_tpu import native as jax_native
    from openmvs_tpu_torch import native
    from openmvs_tpu_torch.refine import _project_np
    from openmvs_tpu_torch.synthetic import height_field_mesh

    scene = case[0]
    mesh = height_field_mesh(40)
    for img in scene.images:
        proj = _project_np(img.working_camera(), mesh.vertices.astype(np.float64))
        ours = native.rasterize(proj, mesh.faces, img.height, img.width)
        ref = jax_native.rasterize(proj, mesh.faces, img.height, img.width)
        assert (ours[0] >= 0).mean() > 0.5
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_rasterizer_build_failure_raises(monkeypatch, tmp_path):
    """A rasterizer that does not build raises (there is no fallback)."""
    from openmvs_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="build"):
        native.build()


def test_subdivide_to_area_equal(case):
    import openmvs_tpu.refine as jr
    from openmvs_tpu.scene import Mesh as JaxMesh
    from openmvs_tpu_torch import refine as pr
    from openmvs_tpu_torch.convert import mesh_from_numpy

    scene, jscene, gt, v0 = case
    ours = pr.subdivide_to_area(mesh_from_numpy(v0, gt.faces), scene, 12.0)
    ref = jr.subdivide_to_area(JaxMesh(vertices=v0.copy(), faces=gt.faces.copy()),
                               jscene, 12.0)
    assert len(ours.faces) > len(gt.faces)
    np.testing.assert_array_equal(ours.vertices, ref.vertices)
    np.testing.assert_array_equal(ours.faces, ref.faces)


def test_vertex_adjacency_and_boundary_equal(case):
    import openmvs_tpu.refine as jr
    from openmvs_tpu_torch import refine as pr

    faces = case[2].faces
    nv = int(faces.max()) + 1
    for a, b in zip(pr._vertex_adjacency(faces, nv), jr._vertex_adjacency(faces, nv)):
        np.testing.assert_array_equal(a, b)
    bnd = pr._vertex_boundary(faces, nv)
    assert 0 < bnd.sum() < nv
    np.testing.assert_array_equal(bnd, jr._vertex_boundary(faces, nv))


def test_collapse_vertices_equal(case):
    import openmvs_tpu.refine as jr
    from openmvs_tpu_torch import refine as pr

    _, _, gt, v0 = case
    adj, deg = pr._vertex_adjacency(gt.faces, len(v0))
    kill = np.random.default_rng(2).random(len(v0)) < 0.2
    ours = pr._collapse_vertices(v0, gt.faces, adj, deg, kill)
    ref = jr._collapse_vertices(v0, gt.faces, adj, deg, kill)
    assert len(ours[0]) < len(gt.faces)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_clip_gradient_matches_jax_at_ties():
    """The ZNCC clip's derivative: one half where ncc equals a bound, as
    JAX's jnp.clip gives it (torch.clamp would give 1); exact ties occur at
    the full-size workload."""
    from openmvs_tpu_torch.refine import _clip

    x = np.asarray([-2.0, -1.0, -0.5, 0.3, 1.0, 2.0], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = _clip(xt, -1.0, 1.0)
    (g,) = torch.autograd.grad(y.sum(), xt)
    ref = jax.grad(lambda a: jnp.sum(jnp.clip(a, -1.0, 1.0)))(jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.clip(x, -1.0, 1.0))
    np.testing.assert_array_equal(g.numpy(), np.asarray(ref))
    assert g[1] == 0.5 and g[4] == 0.5


def test_warp_coords_matches_jax(pairs_case):
    import openmvs_tpu.refine as jr
    from openmvs_tpu_torch import refine as pr

    pds, jpds, d = pairs_case
    ours = pr._warp_coords(d["mt"].verts, pds)
    ref = jax.jit(jax.vmap(jr._warp_coords, in_axes=(None, 0)))(
        jnp.asarray(d["v0"]), jpds)
    ok = ours[3].numpy()
    assert ok.mean() > 0.3
    np.testing.assert_array_equal(ok, np.asarray(ref[3]))
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_bilinear_g_matches_jax(pairs_case):
    import openmvs_tpu.refine as jr
    from openmvs_tpu_torch import refine as pr

    pds = pairs_case[0]
    H, W = pds.imgB.shape[1:]
    rng = np.random.default_rng(5)
    x = rng.uniform(-2, W + 2, pds.imgB.shape).astype(np.float32)
    y = rng.uniform(-2, H + 2, pds.imgB.shape).astype(np.float32)
    ours = pr._bilinear_g(pds.imgB, torch.from_numpy(x), torch.from_numpy(y))
    ref = jax.jit(jax.vmap(jr._bilinear_g))(jnp.asarray(pds.imgB.numpy()),
                                            jnp.asarray(x), jnp.asarray(y))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_box_zncc_energy_and_grad_match_jax(pairs_case):
    """The energy and its gradient in B on the slice's warped images: the
    tail autograd touches (jax.value_and_grad(..., argnums=1))."""
    import openmvs_tpu.refine as jr
    from openmvs_tpu_torch import refine as pr

    pds, _, d = pairs_case
    xb, yb, _, ok = pr._warp_coords(d["mt"].verts, pds)
    B = torch.where(ok, pr._bilinear_g(pds.imgB, xb, yb)[0], 0.0)
    A = torch.where(pds.mask, pds.imgA, 0.0)
    M = ok.to(torch.float32)
    e, gB = pr._zncc_value_and_grad(A, B, M)
    fn = jax.jit(jax.vmap(jax.value_and_grad(jr._box_zncc_energy, argnums=1)))
    je, jg = fn(*(jnp.asarray(t.numpy()) for t in (A, B, M)))
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-4)
    allclose_to_max(gB.numpy(), np.asarray(jg), atol_of_max=1e-5)


def test_pairs_grad_faces_matches_jax(pairs_case):
    import openmvs_tpu.refine as jr
    from openmvs_tpu_torch import refine as pr

    pds, jpds, d = pairs_case
    es, g, n_sup = pr._pairs_grad_faces(d["mt"].verts, pds, d["mt"].faces)
    jes, jg, jn = jax.jit(jr._pairs_grad_faces)(jnp.asarray(d["v0"]), jpds,
                                                jnp.asarray(d["faces"]))
    np.testing.assert_allclose(es.numpy(), np.asarray(jes), rtol=1e-4)
    allclose_to_max(g.numpy(), np.asarray(jg), atol_of_max=1e-4)
    np.testing.assert_array_equal(n_sup.numpy(), np.asarray(jn))


def test_smooth_grads_tworing_matches_jax(pairs_case):
    import openmvs_tpu.refine as jr
    from openmvs_tpu_torch import refine as pr

    d = pairs_case[2]
    mt = d["mt"]
    ours = pr._smooth_grads_tworing(mt.verts, mt.adj, mt.deg, mt.boundary)
    ref = jax.jit(jr._smooth_grads_tworing)(
        jnp.asarray(d["v0"]), jnp.asarray(d["adj"]),
        jnp.asarray(d["deg"], jnp.float32), jnp.asarray(d["bnd"]))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("ratio", [0.9, 1.0])
def test_energy_grad_matches_jax(pairs_case, ratio):
    """One iteration's energy and descent direction (the rigidity and the
    elastic-only regularizer), against the JAX package's jitted one."""
    import openmvs_tpu.refine as jr
    from openmvs_tpu_torch import refine as pr

    pds, jpds, d = pairs_case
    mt = d["mt"]
    ts, js = _scalars(ratio)
    e, g = pr._energy_grad(mt.verts, pds, mt.adj, mt.deg, mt.faces, *ts[:3],
                           mt.boundary, ts[3])
    je, jg = jax.jit(jr._energy_grad)(
        jnp.asarray(d["v0"]), jpds, jnp.asarray(d["adj"]),
        jnp.asarray(d["deg"], jnp.float32), jnp.asarray(d["faces"]), *js[:3],
        jnp.asarray(d["bnd"]), js[3])
    np.testing.assert_allclose(float(e), float(je), rtol=1e-4)
    allclose_to_max(g.numpy(), np.asarray(jg), atol_of_max=1e-4)


def _rms_to(gt_vertices):
    tree = cKDTree(gt_vertices)

    def rms(v):
        dist, _ = tree.query(np.asarray(v), k=1)
        return float(np.sqrt((dist ** 2).mean()))
    return rms


@pytest.mark.parametrize("scene_kind", ["analytic", "rendered"])
def test_refine_mesh_matches_jax(case, monkeypatch, scene_kind):
    """The whole slice: refine_mesh of both packages on the same scene and
    noisy mesh (the JAX package unbucketed, so both run the same shapes),
    held to the bars of test_refine_e2e.py's bucketed-vs-unbucketed check:
    rms distance to the ground-truth vertices within 1e-4, every vertex
    within 5e-3, the same topology.

    "rendered" is that check's own scene (images rendered from the mesh).
    "analytic" is the slice case: images of the smooth surface, which its
    22-grid departs from by up to 0.04, so gradients are noisy and any
    change of rounding moves vertices by up to about 5e-3 after 12
    iterations: the JAX package's own bucketed and unbucketed runs differ
    by 5.5e-3 there, and by 5.0e-3 when the images move by one ulp
    (tests/_torch_refine_floor.py). There every vertex is held within 1e-2,
    twice that floor."""
    import openmvs_tpu.refine as jr
    from openmvs_tpu.config import RefineOptions as JaxOptions
    from openmvs_tpu.scene import Mesh as JaxMesh
    from openmvs_tpu_torch.config import RefineOptions
    from openmvs_tpu_torch.convert import mesh_from_numpy, mesh_to_numpy
    from openmvs_tpu_torch.refine import refine_mesh

    if scene_kind == "analytic":
        scene, jscene, gt, v0 = case
        gv, gf, worst = gt.vertices, gt.faces, 1e-2
    else:
        from test_refine_e2e import _build_scene

        scene, gv, gf = _e2e_scene()
        jscene = _build_scene()[0]
        v0 = gv.copy()
        v0[:, 2] += np.random.default_rng(7).normal(0, 0.05, len(v0)).astype(np.float32)
        worst = 5e-3
    stats = {}
    ours = refine_mesh(scene, mesh_from_numpy(v0, gf),
                       RefineOptions(**SLICE_OPTS), device="cpu", stats=stats)
    monkeypatch.setenv("OMVS_REFINE_NO_BUCKET", "1")
    ref = jr.refine_mesh(jscene, JaxMesh(vertices=v0.copy(), faces=gf.copy()),
                         JaxOptions(**SLICE_OPTS))
    v, f = mesh_to_numpy(ours)
    assert len(v) == len(ref.vertices) and len(f) == len(ref.faces)
    np.testing.assert_array_equal(f, ref.faces)
    rms = _rms_to(gv)
    assert rms(v) < rms(v0)
    assert abs(rms(v) - rms(ref.vertices)) < 1e-4
    assert np.abs(v - np.asarray(ref.vertices)).max() < worst
    assert stats["pairs"] == 6
    assert [s["iters"] for s in stats["scales"]] == [4, 8]
    assert [s["refreshes"] for s in stats["scales"]] == [1, 1]


def _e2e_scene():
    """The arrays of tests/test_refine_e2e.py::_build_scene (a scene
    rendered from its own 22-grid mesh) as a port scene, and that mesh."""
    from test_refine_e2e import _build_scene

    from openmvs_tpu_torch.convert import scene_from_arrays

    js, gt = _build_scene()
    im = js.images
    scene = scene_from_arrays(
        [i.gray for i in im], [i.camera.K for i in im], [i.camera.R for i in im],
        [i.camera.C for i in im], js.pointcloud.points, js.pointcloud.views,
        js.pointcloud.weights)
    return scene, np.asarray(gt.vertices), np.asarray(gt.faces)


def test_refine_converges_without_periphery_blowup():
    """test_refine_e2e.py's convergence check on the port: a z-perturbed
    mesh moves back toward the surface it was rendered from, and no
    vertex random-walks away."""
    from openmvs_tpu_torch.config import RefineOptions
    from openmvs_tpu_torch.convert import mesh_from_numpy
    from openmvs_tpu_torch.refine import refine_mesh

    scene, gv, gf = _e2e_scene()
    v0 = gv.copy()
    v0[:, 2] += np.random.default_rng(7).normal(0, 0.06, len(v0)).astype(np.float32)
    tree = cKDTree(gv)

    def stats(v):
        dist, _ = tree.query(np.asarray(v), k=1)
        return float(np.sqrt((dist ** 2).mean())), float(dist.max())

    rms0, _ = stats(v0)
    opts = RefineOptions(scales=1, iters=16, max_face_area=10_000,
                         decimate=0.0, close_holes=0, ensure_edge_size=0)
    refined = refine_mesh(scene, mesh_from_numpy(v0, gf), opts, device="cpu")
    rms1, worst1 = stats(refined.vertices)
    assert rms1 < rms0 * 0.85, (rms0, rms1)
    assert worst1 < 0.5, worst1


def test_refine_planar_pruning():
    """test_refine_e2e.py's planar-pruning check on the port: flat
    well-observed interior vertices are collapsed away, the topology stays
    valid and duplicate-free, and the surface stays near the truth."""
    from openmvs_tpu_torch.config import RefineOptions
    from openmvs_tpu_torch.convert import mesh_from_numpy
    from openmvs_tpu_torch.refine import refine_mesh

    scene, gv, gf = _e2e_scene()
    v0 = gv.copy()
    v0[:, 2] += np.random.default_rng(3).normal(0, 0.04, len(v0)).astype(np.float32)
    opts = RefineOptions(scales=1, iters=20, max_face_area=10_000,
                         decimate=0.0, close_holes=0, ensure_edge_size=0,
                         planar_vertex_ratio=0.02)
    refined = refine_mesh(scene, mesh_from_numpy(v0, gf), opts, device="cpu")
    assert len(refined.vertices) < len(gv)
    f = np.sort(np.asarray(refined.faces), axis=1)
    assert len(np.unique(f, axis=0)) == len(f)
    assert f.max() < len(refined.vertices)
    assert (f[:, 0] != f[:, 1]).all() and (f[:, 1] != f[:, 2]).all()
    dist, _ = cKDTree(gv).query(np.asarray(refined.vertices), k=1)
    assert float(np.sqrt((dist ** 2).mean())) < 0.08


@pytest.mark.parametrize("opts", [dict(decimate=0.5), dict(ensure_edge_size=2)])
def test_refine_conditioning_runs(case, opts, monkeypatch):
    """With ``decimate > 0`` or ``ensure_edge_size >= 2``, refine_mesh's
    first scale starts from ``condition_mesh``'s mesh, which differs from
    the input (tests/test_torch_mesh_chain.py holds it equal to the JAX
    package's)."""
    from openmvs_tpu_torch import refine
    from openmvs_tpu_torch.config import RefineOptions
    from openmvs_tpu_torch.convert import mesh_from_numpy

    scene, _, gt, _ = case
    mesh = mesh_from_numpy(gt.vertices, gt.faces)
    seen = []
    monkeypatch.setattr(refine, "_refine_at_scale",
                        lambda s, m, *a: (seen.append(m) or m, 0, 0))
    out = refine.refine_mesh(scene, mesh, RefineOptions(**opts), device="cpu")
    want = refine.condition_mesh(mesh, RefineOptions(**opts))
    assert np.array_equal(seen[0].vertices, want.vertices)
    assert np.array_equal(seen[0].faces, want.faces)
    assert np.array_equal(out.faces, want.faces)
    assert len(want.faces) != len(gt.faces)
