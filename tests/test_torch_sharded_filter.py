"""The port's sharded cross-view filter (``parallel/sharded_filter.py``)
on shards that share the CPU, against the JAX package's
``filter_views_sharded`` on its CPU mesh and against the port's host
filter (``densify._filter_views``), on test_sharded_filter.py's maps (5
views of 96x128 and 64x96, 3 or 4 neighbours each).

Tolerances: against JAX, valid masks agree on at least 0.999 of pixels
and depths to 1e-5 relative on at least 0.999 of the pixels valid in both
(expected: equal bit for bit, as the port repeats XLA's fused
multiply-adds of the projection and of the adjust's first sum); against
the host filter, which projects in float64, above 0.99 for both, the JAX
package's own bar (test_sharded_filter.py:83-88).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import Mesh  # noqa: E402
from test_sharded_filter import _make_results  # noqa: E402

from openmvs_tpu.config import DenseOptions as JaxOptions  # noqa: E402
from openmvs_tpu.parallel.sharded_filter import filter_views_sharded as jax_filter  # noqa: E402
from openmvs_tpu_torch import densify as pdens  # noqa: E402
from openmvs_tpu_torch.config import DenseOptions  # noqa: E402
from openmvs_tpu_torch.geometry.camera import Camera  # noqa: E402
from openmvs_tpu_torch.parallel import sharded  # noqa: E402
from openmvs_tpu_torch.parallel.sharded_filter import filter_views_sharded  # noqa: E402

torch.set_num_threads(2)


def _port_results(jres):
    return {rid: pdens.DepthMapResult(
        image_idx=r.image_idx, depth=r.depth.copy(), normal=None, conf=r.conf.copy(),
        d_min=r.d_min, d_max=r.d_max, neighbor_ids=list(r.neighbor_ids),
        camera=Camera(r.camera.K, r.camera.R, r.camera.C)) for rid, r in jres.items()}


def _agreement(got, want, tol):
    """(min valid-mask agreement, min share of depths within ``tol``)."""
    masks, close = [], []
    for rid in want:
        a, b = got[rid].depth, want[rid].depth
        va, vb = a > 0, b > 0
        masks.append(float((va == vb).mean()))
        both = va & vb
        rel = np.abs(a[both] - b[both]) / np.maximum(b[both], 1e-6)
        close.append(float((rel < tol).mean()) if both.any() else 1.0)
    return min(masks), min(close)


def _jax_mesh(shape):
    cpus = jax.devices("cpu")[:shape[0] * shape[1]]
    return Mesh(np.array(cpus).reshape(shape), ("views", "tile"))


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 4)])
def test_sharded_filter_matches_jax_and_host(shape):
    jres = _make_results()
    res = _port_results(jres)
    opts = DenseOptions()
    mesh = sharded.make_mesh(shape[0] * shape[1], shape[0], devices=["cpu"] * 8)
    got = filter_views_sharded(res, opts, mesh)
    want = jax_filter(jres, JaxOptions(), _jax_mesh(shape))
    assert set(got) == set(want)
    mask, close = _agreement(got, want, 1e-5)
    assert mask >= 0.999 and close >= 0.999, (mask, close)
    mask, close = _agreement(got, pdens._filter_views(res, set(), opts), 1e-3)
    assert mask > 0.99 and close > 0.99, (mask, close)


def test_sharded_filter_skip_ids_pass_through():
    jres = _make_results()
    res = _port_results(jres)
    mesh = sharded.make_mesh(4, devices=["cpu"] * 4)
    got = filter_views_sharded(res, DenseOptions(), mesh, skip_ids={1})
    # the skipped view is unchanged, but it still served as a source
    np.testing.assert_array_equal(got[1].depth, res[1].depth)
    assert not np.array_equal(got[0].depth, res[0].depth)
    want = jax_filter(jres, JaxOptions(), _jax_mesh((2, 2)), skip_ids={1})
    mask, close = _agreement(got, want, 1e-5)
    assert mask >= 0.999 and close >= 0.999, (mask, close)
    assert filter_views_sharded(res, DenseOptions(), mesh, skip_ids=set(res)) == res
