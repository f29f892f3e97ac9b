"""Shared helpers of the PyTorch port's parity tests: the same numpy inputs
go through the JAX package (on the CPU) and through the port.

Importing this module also builds the JAX package's native library once
for all test processes (``build_native_locked``): the port's test modules
import it at collection, which every xdist worker does before it runs a
test."""

import fcntl
import os
import traceback
import warnings

import numpy as np
import torch

from openmvs_tpu_torch import convert


def build_native_locked(native=None):
    """Build ``openmvs_tpu.native``'s library (or that of the module
    ``native``, a copy of it) if it is missing or stale, serialised across
    processes by an exclusive ``flock`` on a lock file beside the library.

    ``native.build`` compiles every process's library into the same
    ``.tmp`` path and renames it, and its lock holds only within a process:
    test workers that reach a first native call together on a fresh tree
    race, and a loser's rename finds no ``.tmp``. Under this lock the first
    process builds and the others then find the library fresh. Returns
    (library path, whether this call compiled it)."""
    if native is None:
        from openmvs_tpu import native
    with open(native._LIB_PATH + ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            built = native._needs_build()
            return native.build(), built
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


try:
    build_native_locked()
except Exception:  # noqa: BLE001 - collection goes on; the native tests fail with the cause
    warnings.warn("building openmvs_tpu.native at collection failed:\n"
                  + traceback.format_exc())


def to_numpy_dict(nt) -> dict:
    """A JAX NamedTuple (PMData, PMState, PMViews) as a dict of numpy
    arrays, nested NamedTuples as nested dicts."""
    return {k: (to_numpy_dict(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in nt._asdict().items()}


def port_data(jax_data):
    return convert.pm_data_from_numpy(to_numpy_dict(jax_data), "cpu")


def port_state(jax_state):
    return convert.pm_state_from_numpy(to_numpy_dict(jax_state), "cpu")


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C", copy=True))


def make_case(h=120, w=160, v=2, geom=False, lowres=False, seed=0):
    """(jax_data, jax_state, opts_jax, opts_port, cams) on the geometry of
    ``__graft_entry__._make_example``: random images, a fronto-parallel
    reference and neighbours shifted sideways. ``geom`` adds neighbour
    depth maps with holes (the geometric constants), ``lowres`` a low-res
    depth prior with gaps."""
    import jax.numpy as jnp
    from openmvs_tpu.config import DenseOptions
    from openmvs_tpu.densify import _build_pm_data
    from openmvs_tpu.geometry.camera import Camera
    from openmvs_tpu.ops import patchmatch

    from openmvs_tpu_torch.config import DenseOptions as PortOptions

    rng = np.random.default_rng(seed)
    f = 0.9 * w
    K = np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1.0]])
    ref_cam = Camera(K, np.eye(3), np.zeros(3))
    nbr_cams = [Camera(K, np.eye(3), np.array([0.3 * (j + 1), 0.05 * j, 0.0]))
                for j in range(v)]
    ref = rng.uniform(0, 1, (h, w)).astype(np.float32)
    nbrs = [rng.uniform(0, 1, (h, w)).astype(np.float32) for _ in range(v)]
    nbr_depths = None
    if geom:
        r2 = np.random.default_rng(7)
        nbr_depths = []
        for _ in range(v):
            dm = np.full((h, w), 5.0, np.float32) * (
                1 + 0.002 * r2.standard_normal((h, w))).astype(np.float32)
            dm[r2.random((h, w)) < 0.2] = 0.0
            nbr_depths.append(dm)
    prior = None
    if lowres:
        r3 = np.random.default_rng(11)
        prior = (5.0 * (1 + 0.02 * r3.standard_normal((h, w)))).astype(np.float32)
        prior[r3.random((h, w)) < 0.3] = 0.0
    opts = DenseOptions(sub_resolution_levels=0, estimation_iters=1)
    data = _build_pm_data(ref, ref_cam, nbrs, nbr_cams, opts, 2.0, 10.0,
                          prior, nbr_depths)
    key = jnp.zeros(2, jnp.uint32)
    seed_d = jnp.full((h, w), 5.0, jnp.float32)
    seed_n = jnp.tile(jnp.asarray([0, 0, -1.0], jnp.float32), (h, w, 1))
    state = patchmatch.init_state(data, opts, key, seed_d, seed_n, v, False)
    popts = PortOptions(sub_resolution_levels=0, estimation_iters=1)
    return data, state, opts, popts, dict(ref=ref, nbrs=nbrs, ref_cam=ref_cam,
                                          nbr_cams=nbr_cams, prior=prior,
                                          nbr_depths=nbr_depths)


def candidates(data, state, slope=False, holes=False):
    """Three candidate maps around the state (x0.95, x1, x1.05) as numpy:
    (cd, cn, inv_nd). ``slope`` tilts the depths across the image,
    ``holes`` zeroes 7% of them (invalid hypotheses)."""
    d = np.asarray(state.depth)
    n = np.asarray(state.normal)
    X0 = np.asarray(data.X0)
    cd = np.stack([d * s for s in (0.95, 1.0, 1.05)]).astype(np.float32)
    if slope:
        H, W = d.shape
        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        cd = cd * (1.0 + 0.3 * (xx / W - 0.5) + 0.2 * (yy / H - 0.5)).astype(np.float32)[None]
    if holes:
        cd = np.where(np.random.default_rng(3).random(cd.shape) < 0.07, 0.0, cd)
    cd = cd.astype(np.float32)
    cn = np.stack([n] * 3).astype(np.float32)
    den = np.einsum("chwk,hwk->chw", cn, X0) * cd
    safe = np.abs(den) > 1e-12
    inv_nd = np.where(safe, 1.0 / np.where(safe, den, 1.0), 0.0).astype(np.float32)
    return cd, cn, inv_nd


def example(h=120, w=160):
    """(data, opts, cd, cn) of ``__graft_entry__._make_example`` with three
    candidate planes (x0.95, x1, x1.05 the state), as JAX arrays."""
    import __graft_entry__ as ge
    import jax.numpy as jnp

    data, state, opts, _ = ge._make_example(h=h, w=w, v=2)
    cd = jnp.tile(state.depth[None], (3, 1, 1)) * jnp.asarray([0.95, 1.0, 1.05])[:, None, None]
    cn = jnp.tile(state.normal[None], (3, 1, 1, 1))
    return data, opts, cd, cn


def inv_nd(cn, X0, cd):
    """1 / (n . X0 * d), 0 where the denominator vanishes, in JAX."""
    import jax.numpy as jnp

    den = jnp.einsum("chwk,hwk->chw", cn, X0) * cd
    safe = jnp.abs(den) > 1e-12
    return jnp.where(safe, 1.0 / jnp.where(safe, den, 1.0), 0.0)


def geom_case(h=120, w=160):
    """``example`` with sloped candidate depths, 7% of them zero, and a
    neighbour depth map with 20% holes (``test_pm_kernel._geom_parity_case``):
    (data, opts, cd, cn, dm)."""
    import jax.numpy as jnp

    data, opts, cd, cn = example(h, w)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    slope = (1.0 + 0.3 * (xx / w - 0.5) + 0.2 * (yy / h - 0.5)).astype(np.float32)
    cd = np.asarray(cd) * slope[None]
    cd = np.where(np.random.default_rng(3).random(cd.shape) < 0.07, 0.0, cd)
    cd = jnp.asarray(cd.astype(np.float32))
    rng = np.random.default_rng(7)
    dm = np.full(np.asarray(data.views.image[0]).shape, float(np.median(np.asarray(cd))),
                 np.float32)
    dm[rng.random(dm.shape) < 0.2] = 0.0
    return data, opts, cd, cn, jnp.asarray(dm)


def equal_share(js, ps) -> float:
    """Share of pixels whose (depth, normal, conf) state is the same in a
    JAX and a port PMState: depth to 1e-6 relative, normal and confidence
    to 1e-5 (the same winner, up to the last ulps of the score)."""
    d, n, c = (np.asarray(x) for x in js)
    pdp, pn, pc = (x.numpy() for x in ps)
    same = ((np.abs(pdp - d) <= 1e-6 * np.abs(d))
            & (np.abs(pn - n).max(-1) <= 1e-5) & (np.abs(pc - c) <= 1e-5))
    return float(same.mean())


def jax_scene(arrays):
    """JAX-package Scene from the arrays ``synthetic.build_gt_scene`` returns
    (``colors``, where present, become each image's ``color``)."""
    from openmvs_tpu.geometry.camera import Camera
    from openmvs_tpu.io import mvs as mvsio
    from openmvs_tpu.scene import PointCloud, Scene, SceneImage

    scene = Scene()
    for i, gray in enumerate(arrays["grays"]):
        meta = mvsio.ImageMeta(name=f"view{i:04d}", platform_id=i, id=i)
        h, w = gray.shape
        scene.images.append(SceneImage(
            meta=meta, camera=Camera(arrays["Ks"][i], arrays["Rs"][i],
                                     arrays["Cs"][i]),
            width=w, height=h, gray=np.asarray(gray, np.float32),
            color=(np.asarray(arrays["colors"][i], np.uint8)
                   if arrays.get("colors") is not None else None)))
    views = [np.asarray(v, np.uint32) for v in arrays["point_views"]]
    scene.pointcloud = PointCloud(
        points=np.asarray(arrays["points"], np.float32), views=views,
        weights=[np.ones(len(v), np.float32) for v in views])
    return scene


# the slice-level comparison (tests/test_torch_estimate.py and
# tests/test_torch_densify.py): the synthetic scene at 120x160 with three
# views, one sub-resolution level, 4 iterations and one geometric pass
SLICE_VIEWS = 3
SLICE_OPTS = dict(sub_resolution_levels=1, estimation_iters=4,
                  estimation_geometric_iters=1)


def slice_scenes():
    """(port scene, JAX-package scene) built from the same arrays."""
    from openmvs_tpu_torch.synthetic import build_gt_scene

    scene, _, arrays = build_gt_scene(n_views=SLICE_VIEWS, W=160, H=120)
    return scene, jax_scene(arrays)


def depth_agreement(port_maps, jax_maps):
    """(per-view valid-mask agreement, depth agreement to 1e-3 relative
    pooled over the pixels valid in both, per-view depth agreement)."""
    masks, per_view = [], []
    close = n_both = 0
    for a, b in zip(port_maps, jax_maps):
        va, vb = a > 0, b > 0
        masks.append(float((va == vb).mean()))
        both = va & vb
        ok = np.abs(a - b)[both] < 1e-3 * b[both]
        close += int(ok.sum())
        n_both += int(both.sum())
        per_view.append(float(ok.mean()))
    return masks, close / max(n_both, 1), per_view


# the SGM slice comparison (tests/test_torch_sgm_slice.py): the synthetic
# scene at 120x160 with three views
SGM_VIEWS = 3


def disparity_agreement(a: np.ndarray, b: np.ndarray, tol: float = 1e-3) -> float:
    """Share of pixels where two disparity maps agree: both invalid, or
    both valid within ``tol`` pixels."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    same = (~fa & ~fb) | (fa & fb & (np.abs(np.where(fa & fb, a - b, 0.0)) <= tol))
    return float(same.mean())


def pair_disparities(folder: str) -> dict:
    """{file name: disparities} of the ``.dimap`` files in ``folder``."""
    from openmvs_tpu_torch.io import dimap

    return {f: dimap.load(os.path.join(folder, f)).disparity
            for f in sorted(os.listdir(folder)) if f.endswith(".dimap")}


def port_scene_from_jax(jscene):
    """Port Scene with the cameras, image sizes and pixels (where loaded)
    of a JAX-package Scene, its point cloud (``convert.pointcloud_from_numpy``)
    and its mesh."""
    from openmvs_tpu_torch.geometry.camera import Camera
    from openmvs_tpu_torch.io.mvs import ImageMeta
    from openmvs_tpu_torch.scene import Scene, SceneImage

    scene = Scene()
    for im in jscene.images:
        cam = im.camera
        scene.images.append(SceneImage(
            meta=ImageMeta(name=im.meta.name, platform_id=im.meta.platform_id,
                           id=im.meta.id),
            camera=Camera(cam.K, cam.R, cam.C), width=im.width, height=im.height,
            gray=im.gray, color=im.color))
    pc = jscene.pointcloud
    scene.pointcloud = convert.pointcloud_from_numpy(
        pc.points, pc.views, pc.weights,
        pc.normals if pc.has_normals else None, pc.colors if pc.has_colors else None)
    scene.mesh = convert.mesh_from_numpy(jscene.mesh.vertices, jscene.mesh.faces)
    return scene
