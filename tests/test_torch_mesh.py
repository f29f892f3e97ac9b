"""Meshing (``reconstruct``) and the mesh operations (``mesh_ops``) of the
port against the JAX package, on the CPU.

Both packages run the same host code: Qhull's Delaunay through one scipy,
the same C++ built with the same flags, numpy. So the tolerance is
equality, of faces and vertices as float32 and int32 arrays:

- ``reconstruct_mesh`` and ``reconstruct_mesh_chunked`` on the sphere scene
  of ``tests/test_mesh.py`` (4,000 points, 6 cameras), in a subprocess
  started with ``OMP_NUM_THREADS=1``: the ray walk accumulates its facet
  weights with float atomics in thread order, so only one thread fixes
  the order in both libraries. Cases: ``dist_insert`` 0 and the default,
  ``OMVS_MAXFLOW=dinic``, and the chunked path with a small ``max_points``.
- At the default thread count, the port is held to the floor the JAX
  package reaches against itself on the same input in the same test (the
  share of faces two runs have in common).
- Every ``mesh_ops`` function on one seeded mesh with holes, a small
  component, a spike, duplicate, degenerate and non-manifold faces and
  unreferenced vertices: outputs equal, dtypes included.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_helpers import port_scene_from_jax  # noqa: E402
from test_mesh import sphere_scene  # noqa: E402

from openmvs_tpu import mesh_ops as jops  # noqa: E402
from openmvs_tpu.config import MeshOptions as JaxMeshOptions  # noqa: E402
from openmvs_tpu.reconstruct import reconstruct_mesh as jax_reconstruct  # noqa: E402
from openmvs_tpu.scene import Mesh as JaxMesh  # noqa: E402
from openmvs_tpu_torch import mesh_ops as pops  # noqa: E402
from openmvs_tpu_torch.config import MeshOptions  # noqa: E402
from openmvs_tpu_torch.reconstruct import reconstruct_mesh  # noqa: E402
from openmvs_tpu_torch.scene import Mesh  # noqa: E402
from openmvs_tpu_torch.synthetic import height_field_mesh  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent

# (case, keyword arguments of MeshOptions, environment, chunked max_points)
CASES = {
    "dist_insert_0": (dict(dist_insert=0.0), {}, 0),
    "default": ({}, {}, 0),
    "dinic": ({}, {"OMVS_MAXFLOW": "dinic"}, 0),
    "chunked": (dict(dist_insert=0.0), {}, 1500),
}

_CHILD = """
import json, os, sys
sys.path[:0] = [{tests!r}, {repo!r}]
import numpy as np
from _torch_helpers import port_scene_from_jax
from test_mesh import sphere_scene
from openmvs_tpu.config import MeshOptions as JO
from openmvs_tpu.reconstruct import reconstruct_mesh as jr, reconstruct_mesh_chunked as jrc
from openmvs_tpu_torch.config import MeshOptions as PO
from openmvs_tpu_torch.reconstruct import reconstruct_mesh as pr, reconstruct_mesh_chunked as prc
cases = json.loads({cases!r})
out = {{}}
for name, (kw, env, max_points) in cases.items():
    js = sphere_scene()
    ps = port_scene_from_jax(js)
    os.environ.update(env)
    if max_points:
        a = jrc(js, JO(**kw), max_points=max_points)
        b = prc(ps, PO(**kw), max_points=max_points)
    else:
        a = jr(js, JO(**kw))
        b = pr(ps, PO(**kw))
    for k in env:
        del os.environ[k]
    out[name] = dict(faces=len(a.faces), vertices=len(a.vertices),
                     faces_equal=bool(np.array_equal(a.faces, b.faces)),
                     vertices_equal=bool(np.array_equal(a.vertices, b.vertices)),
                     dtypes=[str(b.vertices.dtype), str(b.faces.dtype)])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def one_thread():
    """Both packages' meshes of every case, compared in one subprocess with
    OMP_NUM_THREADS=1."""
    code = _CHILD.format(tests=str(TESTS), repo=str(REPO), cases=json.dumps(CASES))
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(CASES))
def test_reconstruct_equals_jax_on_one_thread(one_thread, case):
    r = one_thread[case]
    assert r["faces_equal"] and r["vertices_equal"], r
    assert r["dtypes"] == ["float32", "int32"], r
    # the sphere stays watertight over nearly all of its points (F = 2V - 4)
    assert r["faces"] == 2 * r["vertices"] - 4, r


def _face_keys(mesh):
    """Each face as its three vertices' float32 bytes, rotated to start at
    the smallest (orientation kept), so meshes whose vertex numbering
    differs compare by geometry."""
    v = [bytes(x) for x in np.asarray(mesh.vertices, np.float32)]
    keys = set()
    for f in np.asarray(mesh.faces):
        t = [v[i] for i in f]
        k = t.index(min(t))
        keys.add(tuple(t[k:] + t[:k]))
    return keys


def _agreement(a, b):
    ka, kb = _face_keys(a), _face_keys(b)
    return len(ka & kb) / max(len(ka), len(kb))


@pytest.mark.parametrize("chunked", [False, True])
def test_reconstruct_default_threads_within_jax_floor(chunked):
    """At the default thread count the float atomics of the ray walk may
    round in another order from run to run: the port's faces agree with
    the JAX package's at least as well as two JAX runs agree (the chunked
    path with 1,500 points a chunk)."""
    from openmvs_tpu.reconstruct import reconstruct_mesh_chunked as jax_chunked

    from openmvs_tpu_torch.reconstruct import reconstruct_mesh_chunked

    js = sphere_scene()
    ps = port_scene_from_jax(js)
    if chunked:
        def jax_run():
            return jax_chunked(js, JaxMeshOptions(dist_insert=0.0), max_points=1500)
        mesh = reconstruct_mesh_chunked(ps, MeshOptions(dist_insert=0.0), max_points=1500)
    else:
        def jax_run():
            return jax_reconstruct(js, JaxMeshOptions())
        mesh = reconstruct_mesh(ps, MeshOptions())
    ref = jax_run()
    floor = _agreement(ref, jax_run())
    got = _agreement(mesh, ref)
    assert got >= floor, (got, floor)


def test_reconstruct_too_small_raises():
    ps = port_scene_from_jax(sphere_scene(n=4))
    with pytest.raises(ValueError, match="too small"):
        reconstruct_mesh(ps, MeshOptions())


# ----------------------------------------------------------------- mesh_ops
def _messy_mesh():
    """(vertices float32, faces int32) of a noisy 20x20 height-field grid
    with 10 faces removed (holes), a 4-face component far away, a needle
    face, 5 duplicated and 3 degenerate faces, a 2-face fin on an interior
    edge and 5 unreferenced vertices, from default_rng(5)."""
    rng = np.random.default_rng(5)
    g = height_field_mesh(20)
    v = g.vertices.astype(np.float32).copy()
    v[:, 2] += rng.normal(0, 0.01, len(v)).astype(np.float32)
    f = g.faces.copy()
    f = np.delete(f, rng.choice(np.arange(40, len(f) - 40), 10, replace=False), axis=0)
    nv = len(v)
    island = np.array([[10, 10, 6], [10.2, 10, 6], [10, 10.2, 6], [10.2, 10.2, 6],
                       [10.4, 10.1, 6]], np.float32)
    spike = np.array([[v[0, 0] + 1e-4, v[0, 1], v[0, 2] + 5.0]], np.float32)
    fin = np.array([[0.0, 0.0, 8.0], [0.1, 0.1, 8.5]], np.float32)
    extra = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    a, b = f[200, 0], f[200, 1]
    faces = [f,
             nv + np.array([[0, 1, 2], [1, 3, 2], [1, 4, 3], [4, 1, 0]]),
             np.array([[0, 1, nv + 5]]),
             f[[5, 50, 90, 120, 300]][:, [1, 2, 0]],
             np.array([[7, 7, 8], [9, 10, 9], [11, 12, 12]]),
             np.array([[a, b, nv + 6], [b, a, nv + 7]])]
    v = np.concatenate([v, island, spike, fin, extra])
    return v.astype(np.float32), np.concatenate(faces).astype(np.int32)


def _textured(mesh_cls, pages):
    """The 12-grid with seeded texcoords and ``pages`` random atlas pages
    (a face_page per face when there are several)."""
    rng = np.random.default_rng(9)
    g = height_field_mesh(12)
    tc = rng.uniform(0, 1, (len(g.faces), 3, 2)).astype(np.float32)
    tex = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8) for _ in range(pages)]
    m = mesh_cls(vertices=g.vertices.copy(), faces=g.faces.copy(), face_tex_coords=tc,
                 texture=tex[0])
    if pages > 1:
        m.textures = tex
        m.face_page = rng.integers(0, pages, len(g.faces)).astype(np.int32)
    return m


def _clean_grid(mesh_cls):
    g = height_field_mesh(24)
    v = g.vertices.copy()
    v[:, 2] += np.random.default_rng(6).normal(0, 0.02, len(v)).astype(np.float32)
    return mesh_cls(vertices=v, faces=g.faces.copy())


def _messy(mesh_cls):
    v, f = _messy_mesh()
    return mesh_cls(vertices=v, faces=f)


# name -> fn(ops module, Mesh class) giving the function's output
OPS = {
    "face_normals": lambda o, M: o.face_normals(*_messy_mesh()),
    "vertex_normals": lambda o, M: o.vertex_normals(*_messy_mesh()),
    "edges_of_faces": lambda o, M: o.edges_of_faces(_messy_mesh()[1]),
    "remove_unreferenced": lambda o, M: o.remove_unreferenced(*_messy_mesh()),
    "remove_degenerate_faces": lambda o, M: o.remove_degenerate_faces(_messy_mesh()[1]),
    "remove_duplicate_faces": lambda o, M: o.remove_duplicate_faces(_messy_mesh()[1]),
    "fix_non_manifold": lambda o, M: o.fix_non_manifold(*_messy_mesh()),
    "connected_components": lambda o, M: o.connected_components(
        _messy_mesh()[1], len(_messy_mesh()[0])),
    "remove_spurious": lambda o, M: o.remove_spurious(*_messy_mesh(), 20.0),
    "remove_spikes": lambda o, M: o.remove_spikes(*_messy_mesh()),
    "close_holes": lambda o, M: o.close_holes(*o.fix_non_manifold(*_messy_mesh())),
    "taubin_smooth": lambda o, M: o.taubin_smooth(*_messy_mesh()),
    "decimate_mesh": lambda o, M: o.decimate_mesh(
        _clean_grid(M).vertices, _clean_grid(M).faces, 0.3),
    "clean_mesh_default": lambda o, M: o.clean_mesh(_messy(M)),
    "clean_mesh_decimate": lambda o, M: o.clean_mesh(_messy(M), decimate=0.5),
    "sample_points": lambda o, M: o.sample_points(_clean_grid(M), 700, seed=3),
    "face_areas": lambda o, M: o.face_areas(_messy(M)),
    "subdivide": lambda o, M: o.subdivide(_clean_grid(M)),
    "isotropic_remesh": lambda o, M: o.isotropic_remesh(_clean_grid(M), 0.2),
    "compute_volume": lambda o, M: o.compute_volume(_clean_grid(M)),
    "ensure_edge_size": lambda o, M: o.ensure_edge_size(_clean_grid(M), 0.4, max_rounds=2),
    "split_mesh": lambda o, M: o.split_mesh(_textured(M, 1), 50),
    "transfer_texture": lambda o, M: o.transfer_texture(
        _textured(M, 1), o.subdivide(M(vertices=_textured(M, 1).vertices,
                                       faces=_textured(M, 1).faces))),
    "transfer_texture_pages": lambda o, M: o.transfer_texture(
        _textured(M, 3), o.subdivide(M(vertices=_textured(M, 3).vertices,
                                       faces=_textured(M, 3).faces))),
}


def _flatten(x):
    """The arrays and scalars of an output: meshes by their fields, tuples
    and lists element by element."""
    if hasattr(x, "vertices"):
        out = [x.vertices, x.faces]
        for k in ("face_tex_coords", "texture", "face_page"):
            out.append(getattr(x, k))
        out += list(x.textures or [])
        return out
    if isinstance(x, (tuple, list)):
        return [y for e in x for y in _flatten(e)]
    return [x]


@pytest.mark.parametrize("name", list(OPS))
def test_mesh_op_equals_jax(name):
    ref = _flatten(OPS[name](jops, JaxMesh))
    got = _flatten(OPS[name](pops, Mesh))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
            assert np.array_equal(a, b), name
        else:
            assert a == b, (a, b)


def test_messy_mesh_exercises_every_branch():
    """The fixture has what each cleaning step removes or closes."""
    v, f = _messy_mesh()
    assert len(pops.remove_degenerate_faces(f)) == len(f) - 3
    assert len(pops.remove_duplicate_faces(f)) == len(f) - 5
    _, uniq, inv = pops.edges_of_faces(pops.remove_duplicate_faces(f))
    assert np.bincount(inv).max() > 2                           # the fin
    assert len(np.unique(pops.connected_components(f, len(v)))) > 1
    fv, ff = pops.fix_non_manifold(v, f)
    assert len(pops.close_holes(fv, ff)[1]) > len(ff)
    assert len(pops.remove_spikes(v, f)[1]) < len(f)


def test_decimate_rejects_out_of_range_faces():
    """The native decimation is given only faces that index its vertices."""
    from openmvs_tpu_torch import native

    v, f = _messy_mesh()
    with pytest.raises(ValueError, match="out of range"):
        native.decimate(v, np.concatenate([f, [[0, 1, len(v)]]]).astype(np.int32), 10)
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        native.decimate(v[:, :2], f, 10)


def test_crop_to_roi_equals_jax():
    """Scene.crop_to_roi keeps the points inside a rotated box, with their
    view lists and weights, as the JAX package's does."""
    js = sphere_scene()
    c, s = np.cos(0.3), np.sin(0.3)
    js.obb_rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    js.obb_min, js.obb_max = np.array([-0.5, -2, -0.2]), np.array([2, 0.4, 2])
    ps = port_scene_from_jax(js)
    ps.obb_rot, ps.obb_min, ps.obb_max = js.obb_rot, js.obb_min, js.obb_max
    removed = ps.crop_to_roi()
    assert removed == js.crop_to_roi() and 0 < removed < 4000
    assert np.array_equal(ps.pointcloud.points, js.pointcloud.points)
    for a, b in zip(ps.pointcloud.views + ps.pointcloud.weights,
                    js.pointcloud.views + js.pointcloud.weights):
        assert np.array_equal(a, b)
