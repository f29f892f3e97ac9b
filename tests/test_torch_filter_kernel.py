"""The cross-view filter's card path on the CPU: the plain PyTorch twin of
``csrc/filter_splat.cu`` (``ops/filter_kernel.py``) against the host
NumPy filter (``ops/filters.py``), bit for bit.

Each case holds, for every (view, neighbour), the twin's z-buffer words
unpacked against ``filters.project_depth_to_view`` and, per view, the
twin's decide against ``filter_depth_adjust`` or ``filter_depth_strict``
on the host's projections; then ``filter_kernel.filter_views`` (the card
path's upload, stack, splats, decides and download, run through the twin)
against ``densify._filter_views``. Cases: test_sharded_filter.py's maps;
cameras that share a row, so that projected rows land on integers, where
a float32 projection moves them across a texel boundary; a fronto-parallel
plane, so that every texel's candidates tie in z with different
confidences (NumPy's last write wins); cameras turned so that projections
fall behind the camera and off the frame. The twin's fused multiply-add
is held against exact rationals. The kernels themselves run only on the
card: ``tests/test_torch_filter_card.py``.
"""

import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch

from openmvs_tpu_torch import densify
from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.geometry.camera import Camera
from openmvs_tpu_torch.ops import filter_kernel as fk
from openmvs_tpu_torch.ops import filters

torch.set_num_threads(2)


def _result(i, depth, conf, cam, nbrs, d_min=0.5, d_max=50.0):
    return densify.DepthMapResult(image_idx=i, depth=depth, normal=None, conf=conf,
                                  d_min=d_min, d_max=d_max, neighbor_ids=nbrs, camera=cam)


def _sharded_maps():
    from test_sharded_filter import _make_results

    return {rid: _result(r.image_idx, r.depth.copy(), r.conf.copy(),
                         Camera(r.camera.K, r.camera.R, r.camera.C), list(r.neighbor_ids),
                         r.d_min, r.d_max)
            for rid, r in _make_results().items()}


def _yaw(deg):
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])


def _maps(cams, H, W, depth_fn, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for i, cam in enumerate(cams):
        depth = depth_fn(rng, cam).astype(np.float32)
        depth[rng.random((H, W)) < 0.08] = 0.0
        conf = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
        conf[depth == 0] = 0
        out[i] = _result(i, depth, conf, cam, [j for j in range(len(cams)) if j != i])
    return out


def _shared_row():
    # identity rotations, centres apart along x alone: a source row maps to
    # the same row of every view, exactly or an ulp off
    H, W = 48, 64
    K = np.array([[61.7, 0, 31.3], [0, 61.7, 23.9], [0, 0, 1]])
    cams = [Camera(K, np.eye(3), np.array([0.25 * i, 0.0, 0.0])) for i in range(4)]
    xs = np.linspace(0, 2, W)[None, :]
    return _maps(cams, H, W, lambda rng, cam: 4.0 + 0.25 * np.sin(xs) + np.zeros((H, 1)), 1)


def _ties():
    # a fronto-parallel plane at one depth: every candidate of a texel has
    # the same z, and the confidences differ
    H, W = 40, 56
    K = np.array([[50.0, 0, 27.5], [0, 50.0, 19.5], [0, 0, 1]])
    cams = [Camera(K, np.eye(3), np.array([0.1 * i, 0.05 * (i % 2), 0.0])) for i in range(4)]
    return _maps(cams, H, W, lambda rng, cam: np.full((H, W), 3.0), 2)


def _plane_depth(cam, H, W, normal=(0.2, 0.0, 1.0), at=6.0):
    """Camera z of the plane normal . X = at along each pixel's ray; 0 where
    the ray leaves the plane behind."""
    n = np.array(normal) / np.linalg.norm(normal)
    yy, xx = np.mgrid[0:H, 0:W]
    rays = np.stack([xx, yy, np.ones_like(xx)], -1) @ np.linalg.inv(cam.K).T @ cam.R
    t = (at - n @ cam.C) / (rays @ n)
    return np.where(t > 0, t, 0.0)


def _behind_and_off():
    # neighbours turned by up to 100 degrees and moved: the points of a
    # tilted plane fall behind the turned camera, many off its frame
    H, W = 40, 52
    K = np.array([[40.0, 0, 25.5], [0, 44.0, 19.5], [0, 0, 1]])
    cams = [Camera(K, _yaw(a), np.array([x, 0.1, z]))
            for a, x, z in ((0, 0, 0), (12, 1.0, 0.5), (-15, -1.5, 1.0), (100, 2.0, 2.5))]
    return _maps(cams, H, W, lambda rng, cam: _plane_depth(cam, H, W)
                 * (1 + 0.002 * rng.standard_normal((H, W))), 3)


CASES = {"sharded_maps": _sharded_maps, "shared_row": _shared_row, "ties": _ties,
         "behind_and_off": _behind_and_off}


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _twin_projection(nb, r):
    layer = torch.full(r.depth.shape, fk.EMPTY, dtype=torch.int64)
    fk.splat_plain(layer, torch.from_numpy(nb.depth), fk.cams(nb.camera, r.camera),
                   fk.blas_fuses())
    d, c = fk.unpack_plain(layer, torch.from_numpy(nb.conf))
    return d.numpy(), c.numpy()


def _host_projection(nb, r):
    return filters.project_depth_to_view(nb.depth, nb.conf, nb.camera, r.camera,
                                         r.depth.shape)


def _case_stats(results):
    """Shares of (view, neighbour) source depths whose host projection lands
    on an integer row, behind the reference, and in front but off its
    frame."""
    rows = behind = off = 0
    n = 0
    for r in results.values():
        hr, wr = r.depth.shape
        for nb_id in r.neighbor_ids:
            nb = results[nb_id]
            yy, xx = np.nonzero(nb.depth > 0)
            X = nb.camera.unproject(np.stack([xx, yy], -1).astype(np.float64),
                                    nb.depth[yy, xx].astype(np.float64))
            Xc = r.camera.world_to_cam(X)
            p = Xc @ r.camera.K.T
            front = Xc[:, 2] > 0
            px, py = p[front, 0] / Xc[front, 2], p[front, 1] / Xc[front, 2]
            n += len(yy)
            behind += int((~front).sum())
            rows += int((py == np.floor(py)).sum())
            off += int(((px < -1) | (px >= wr) | (py < -1) | (py >= hr)).sum())
    return rows / n, behind / n, off / n


@pytest.mark.parametrize("adjust", [True, False], ids=["adjust", "strict"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_equals_host_filter(case, adjust):
    results = CASES[case]()
    rows, behind, off = _case_stats(results)
    if case == "shared_row":
        assert rows > 0.3, rows
    if case == "behind_and_off":
        assert behind > 0.05 and off > 0.1, (behind, off)
    opts = DenseOptions(filter_adjust=adjust)
    kept = 0
    for rid, r in results.items():
        projected = []
        for nb_id in r.neighbor_ids:
            want = _host_projection(results[nb_id], r)
            got = _twin_projection(results[nb_id], r)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{rid}<-{nb_id}")
            projected.append(want)
        if adjust:
            want = filters.filter_depth_adjust(r.depth, r.conf, projected, opts,
                                               r.d_min, r.d_max)
        else:
            want = filters.filter_depth_strict(r.depth, r.conf, projected, opts)
        got = fk.decide_plain(torch.from_numpy(r.depth), torch.from_numpy(r.conf),
                              [(torch.from_numpy(d), torch.from_numpy(c)) for d, c in projected],
                              opts, r.d_min, r.d_max)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=f"view {rid}")
        kept += int((want[0] > 0).sum())
    assert kept > 0


def test_ties_keep_the_last_write():
    """On the plane every texel's candidates tie in z, so the winner's
    confidence is the last write's: held in test_twin_equals_host_filter;
    here the case is shown to tie, and the twin to differ from the first
    write's confidence."""
    results = _ties()
    r, nb = results[0], results[1]
    d, c = _twin_projection(nb, r)
    layer = torch.full(r.depth.shape, fk.EMPTY, dtype=torch.int64)
    fk.splat_plain(layer, torch.from_numpy(nb.depth), fk.cams(nb.camera, r.camera), True)
    keys = ((0xFFFFFFFF - (layer & 0xFFFFFFFF)) >> fk.KEY_BITS)[layer != fk.EMPTY]
    assert (keys > 0).float().mean() > 0.5  # most winners come from a later offset
    assert len(np.unique(d[d > 0])) == 1


def test_shared_rows_need_the_blas_rounding():
    """Where rows land on integers, the other rounding of the 3x3 products
    (fused or not) moves texels: the shared-row case tells them apart."""
    results = _shared_row()
    moved = 0
    for r in results.values():
        for nb_id in r.neighbor_ids:
            nb = results[nb_id]
            layer = torch.full(r.depth.shape, fk.EMPTY, dtype=torch.int64)
            fk.splat_plain(layer, torch.from_numpy(nb.depth), fk.cams(nb.camera, r.camera),
                           not fk.blas_fuses())
            d, _ = fk.unpack_plain(layer, torch.from_numpy(nb.conf))
            moved += int((d.numpy() != _host_projection(nb, r)[0]).sum())
    assert moved > 20, moved


@pytest.mark.parametrize("adjust", [True, False], ids=["adjust", "strict"])
@pytest.mark.parametrize("case", ["sharded_maps", "behind_and_off"])
def test_card_path_through_the_twin_equals_host(case, adjust):
    results = CASES[case]()
    opts = DenseOptions(filter_adjust=adjust)
    rids = [rid for rid in results if rid != 1]
    got = fk.filter_views(results, rids, opts, "cpu")
    want = densify._filter_views(results, {1}, opts)
    assert set(got) == set(rids)
    for rid in rids:
        assert got[rid] is not None
        np.testing.assert_array_equal(_bits(got[rid][0]), _bits(want[rid].depth))
        np.testing.assert_array_equal(_bits(got[rid][1]), _bits(want[rid].conf))


def test_too_few_neighbours_keep_the_view():
    results = _ties()
    for r in results.values():
        r.neighbor_ids = r.neighbor_ids[:1]
    got = fk.filter_views(results, list(results), DenseOptions(), "cpu")
    assert got == {rid: None for rid in results}
    out = densify._filter_views(results, set(), DenseOptions())
    assert all(out[rid] is results[rid] for rid in results)


def test_fma64_rounds_once():
    rng = np.random.default_rng(7)
    a = rng.normal(size=3000) * 10.0 ** rng.integers(-4, 4, 3000)
    b = rng.normal(size=3000)
    c = -a * b * (1 + rng.normal(size=3000) * 1e-13)
    c[::2] = rng.normal(size=1500)
    got = fk.fma64(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.array(want))
    # and it differs from two roundings where the product's low bits count
    x = torch.tensor([1.0 + 2.0 ** -30], dtype=torch.float64)
    assert float(fk.fma64(x, x, torch.tensor([-1.0], dtype=torch.float64))) == (
        2.0 ** -29 + 2.0 ** -60)


def test_blas_probe_names_numpys_rounding():
    x = 1.0 + 2.0 ** -30
    a = np.tile(np.array([[-1.0, x, 0.0]]), (64, 1))
    b = np.array([[1.0, 2.0, 0.0], [x, 1.0, 0.0], [0.0, 0.0, 1.0]])
    got = (a @ b)[:, 0]
    assert set(got.tolist()) == {2.0 ** -29 + 2.0 ** -60 if fk.blas_fuses() else 2.0 ** -29}


def test_wrapper_refuses_what_the_kernels_do_not_take():
    layer = torch.full((4, 5), fk.EMPTY, dtype=torch.int64)
    cam = Camera(np.eye(3), np.eye(3), np.zeros(3))
    c = fk.cams(cam, cam)
    with pytest.raises(TypeError):
        fk.splat(layer.float(), torch.ones(4, 5), c, True)
    with pytest.raises(ValueError):
        fk.splat(layer.t(), torch.ones(5, 4), c, True)
    with pytest.raises(ValueError):
        fk.decide(torch.zeros(2, 4, 5, dtype=torch.int64), torch.ones(4, 5), torch.ones(4, 5),
                  [torch.ones(4, 5)], DenseOptions(), 0.1, 10.0)
    with pytest.raises(ValueError):
        fk.decide(torch.zeros(13, 4, 5, dtype=torch.int64), torch.ones(4, 5), torch.ones(4, 5),
                  [torch.ones(4, 5)] * 13, DenseOptions(), 0.1, 10.0)


def test_filter_views_keeps_the_harness_contract():
    """The benchmark's harness wraps ``_filter_views(results, resumed,
    opts)`` with three positional arguments and reads ``np.array(r.depth)``
    of what it returns: DepthMapResults with NumPy maps, every id kept, the
    map's device carried along."""
    results = _sharded_maps()
    for r in results.values():
        r.device = torch.device("cpu")
    out = densify._filter_views(results, {2}, DenseOptions())
    assert list(out) == list(results)
    assert out[2] is results[2]
    for rid, r in out.items():
        assert isinstance(r, densify.DepthMapResult)
        assert isinstance(r.depth, np.ndarray) and r.depth.dtype == np.float32
        assert isinstance(r.conf, np.ndarray) and r.conf.dtype == np.float32
        assert r.device == torch.device("cpu")
        assert np.array(r.depth).shape == results[rid].depth.shape
    fields = [f.name for f in dataclasses.fields(densify.DepthMapResult)]
    assert fields[-1] == "device" and densify.DepthMapResult.__dataclass_fields__[
        "device"].default is None
