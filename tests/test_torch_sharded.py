"""The port's sharded estimation (``parallel/sharded.py``) on shards that
share the CPU, against the port's serial ``estimate_depth_map`` and the
JAX package's ``estimate_views_sharded`` on its 8-device CPU mesh
(``OMVS_NO_PALLAS=1``, as the JAX sharded tests run), from the same arrays:
test_sharded_mixed.py's 3-view scene (96x128 and 64x96).

Tolerances: port sharded equals port serial on at least 0.999 of the
pixels of every view (expected 1.0: candidate draws and the checkerboard
hash global pixel coordinates, so a tile boundary changes nothing);
against the JAX package, valid masks and depths to 1e-3 relative agree on
at least 0.985 of pixels pooled and 0.98 per view (JAX's own bar at
test_sharded_mixed.py:83-84; the port's rounding differs from XLA's by an
ulp in its transcendentals, tests/test_torch_estimate.py).
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_helpers import port_scene_from_jax  # noqa: E402
from test_sharded_mixed import _mixed_scene  # noqa: E402

from openmvs_tpu.config import DenseOptions as JaxOptions  # noqa: E402
from openmvs_tpu.view_selection import select_views_for_scene as jax_select  # noqa: E402
from openmvs_tpu_torch import densify as pdens  # noqa: E402
from openmvs_tpu_torch.config import DenseOptions  # noqa: E402
from openmvs_tpu_torch.io.mvs import ViewScore  # noqa: E402
from openmvs_tpu_torch.parallel import sharded  # noqa: E402
from openmvs_tpu_torch.view_selection import select_views_for_scene  # noqa: E402

torch.set_num_threads(2)

OPTS = dict(sub_resolution_levels=1, estimation_iters=2, estimation_geometric_iters=1)


def _cpu_mesh(shape):
    return sharded.make_mesh(shape[0] * shape[1], shape[0], devices=["cpu"] * 4)


def _serial(scene, opts, prev=None):
    """The port's serial maps of every estimable view (photometric, or the
    first geometric pass on ``prev``)."""
    out = {}
    for i, im in enumerate(scene.images):
        if prev is None:
            r = pdens.estimate_depth_map(scene, i, opts, device="cpu")
        elif im.meta.id in prev:
            r = pdens.estimate_depth_map(scene, i, opts, prev=prev[im.meta.id],
                                         neighbor_results=prev, geometric_iter=0,
                                         device="cpu")
        else:
            r = None
        if r is not None:
            out[im.meta.id] = r
    return out


def _equal_share(a, b):
    return min(float((a[k].depth == b[k].depth).mean()) for k in a)


def _jax_agreement(port, ref):
    masks, per_view, close, n_both = [], [], 0, 0
    for rid in ref:
        a, b = port[rid].depth, ref[rid].depth
        va, vb = a > 0, b > 0
        masks.append(float((va == vb).mean()))
        both = va & vb
        ok = np.abs(a - b)[both] < 1e-3 * b[both]
        close += int(ok.sum())
        n_both += int(both.sum())
        per_view.append(float(ok.mean()))
    return masks, close / max(n_both, 1), per_view


@pytest.fixture(scope="module")
def mixed():
    """(port scene, port serial photometric and geometric maps, JAX sharded
    photometric and geometric maps)."""
    from openmvs_tpu.parallel import sharded as jsh

    jscene = _mixed_scene()
    scene = port_scene_from_jax(jscene)
    opts, jopts = DenseOptions(**OPTS), JaxOptions(**OPTS)
    select_views_for_scene(scene, opts)
    jax_select(jscene, jopts)
    old = os.environ.get("OMVS_NO_PALLAS")
    os.environ["OMVS_NO_PALLAS"] = "1"
    try:
        jmesh = jsh.make_mesh(4)
        jphoto = jsh.estimate_views_sharded(jscene, jopts, jmesh)
        jgeo = jsh.estimate_views_sharded(jscene, jopts, jmesh, prev_results=jphoto,
                                          geometric_iter=0)
    finally:
        if old is None:
            os.environ.pop("OMVS_NO_PALLAS")
        else:
            os.environ["OMVS_NO_PALLAS"] = old
    photo = _serial(scene, opts)
    return scene, photo, _serial(scene, opts, photo), jphoto, jgeo


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_sharded_estimation_matches_serial_and_jax(mixed, shape):
    scene, photo, geo, jphoto, jgeo = mixed
    opts = DenseOptions(**OPTS)
    mesh = _cpu_mesh(shape)
    sh_photo = sharded.estimate_views_sharded(scene, opts, mesh)
    sh_geo = sharded.estimate_views_sharded(scene, opts, mesh, prev_results=photo,
                                            geometric_iter=0)
    checks = [(sh_photo, photo, jphoto, sh_photo), (sh_geo, geo, jgeo, None)]
    if shape == (2, 2):
        # the geometric pass against JAX's starts from JAX's photometric
        # maps, so that it holds the pass alone (once: the other shapes
        # equal the serial maps as this one does)
        checks[1] = (sh_geo, geo, jgeo, sharded.estimate_views_sharded(
            scene, opts, mesh, prev_results=jphoto, geometric_iter=0))
    for sh, se, ref, sh_ref in checks:
        assert set(sh) == set(se) == set(ref)
        assert _equal_share(sh, se) >= 0.999
        if sh_ref is None:
            continue
        masks, pooled, per_view = _jax_agreement(sh_ref, ref)
        msg = f"masks {masks}, pooled {pooled}, per view {per_view}"
        assert min(masks) >= 0.98 and pooled >= 0.985 and min(per_view) >= 0.98, msg


def test_sharded_mixed_sizes_and_padded_neighbour_slots():
    """Every view estimates, the 64x96 one too, against 1 or 2 neighbours
    (padded slots of size (0, 0)), over 3 views on 2 rows of shards (a
    padded reference slot), with a nearest-sampling sweep before the exact
    one (the mode switch rescores the incumbent): photometric and
    geometric maps equal the serial ones."""
    scene = port_scene_from_jax(_mixed_scene())
    opts = DenseOptions(**dict(OPTS, exact_final_iters=1))
    for im, nbrs in zip(scene.images, ([2, 1], [0], [0, 1])):
        im.meta.view_scores = [ViewScore(id=j, score=1.0) for j in nbrs]
    mesh = _cpu_mesh((2, 2))
    sh_photo = sharded.estimate_views_sharded(scene, opts, mesh)
    photo = _serial(scene, opts)
    assert set(sh_photo) == set(photo) == {0, 1, 2}
    assert _equal_share(sh_photo, photo) >= 0.999
    sh_geo = sharded.estimate_views_sharded(scene, opts, mesh, prev_results=photo,
                                            geometric_iter=0)
    assert _equal_share(sh_geo, _serial(scene, opts, photo)) >= 0.999
    assert all(r.depth.shape == scene.images[k].gray.shape for k, r in sh_geo.items())


def test_make_mesh_raises_for_an_absent_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sharded.make_mesh(4)
    with pytest.raises(RuntimeError, match="cuda"):
        sharded.make_mesh(2, devices=["cpu", "cuda:0"])
    mesh = sharded.make_mesh(4, devices=["cpu"] * 4)
    assert mesh.shape == (2, 2) and mesh.flat() == [torch.device("cpu")] * 4
    assert sharded.make_mesh(3, devices=["cpu"] * 3).shape == (1, 3)
    with pytest.raises(ValueError):
        sharded.make_mesh(4, 3, devices=["cpu"] * 4)
