"""Refinement's iteration as a device program (``refine.IterProgram``) and
its ordered segment sums (``ops/segment.py``, ``csrc/segment_sum.cu``), on
the CPU.

On a card the program is a CUDA graph replayed once an iteration and the
segment sums are the ``segment_sum`` kernel over a stable sort's order and
``searchsorted``'s offsets; ``chip_smoke.py`` phase ``refine`` holds both
there (graphed ``refine_mesh`` against ``_eager=True`` and the kernel
against its plain version, bit for bit). Held here, bit for bit:

* the program's CPU form (its body on its static buffers) over a refresh
  block and across a refresh against eager ``_device_iter`` steps, and
  ``refine_mesh`` through it against ``_eager=True``;
* its decay table against ``_decay`` for k in 0..48;
* ``_segment_sum`` (the card's segment order and offsets, summed by the
  kernel's plain version on the CPU) against a numpy model of the
  kernel's thread loop over numpy's own stable order, with empty segments,
  ``-0.0`` rows and one-row segments.

``tests/test_torch_refine.py`` holds ``refine_mesh`` (now through the
program) against the JAX package."""

import numpy as np
import pytest
import torch

from openmvs_tpu_torch import refine as pr
from openmvs_tpu_torch.ops import graphs, pm_kernel, segment

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    """The slice case of test_torch_refine.py (3 views at 160x120, the
    22-grid with z-noise from default_rng(7)) at full scale: scene, pairs,
    views, cameras, mesh arrays and statics."""
    from openmvs_tpu_torch.config import DenseOptions, RefineOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene, height_field_mesh
    from openmvs_tpu_torch.view_selection import select_views_for_scene

    scene, _, _ = build_gt_scene(n_views=3, W=160, H=120)
    gt = height_field_mesh(22)
    v0 = gt.vertices.copy()
    v0[:, 2] += np.random.default_rng(7).normal(0, 0.05, len(v0)).astype(np.float32)
    select_views_for_scene(scene, DenseOptions())
    pairs = pr.select_pairs(scene, RefineOptions())
    grays, cams = pr.scaled_views(scene, 1.0)
    faces = gt.faces
    adj, deg = pr._vertex_adjacency(faces, len(v0))
    bnd = pr._vertex_boundary(faces, len(v0))
    statics = pr.to_device(pr.build_statics(pairs, grays, cams), "cpu")
    return dict(scene=scene, gt=gt, v0=v0, pairs=pairs, grays=grays, cams=cams,
                faces=faces, adj=adj, deg=deg, bnd=bnd, statics=statics)


def _scalars():
    # step0, med_edge, reg_w as _refine_at_scale makes them
    return [torch.tensor(x, dtype=torch.float32) for x in (0.5, 0.1, 0.2)]


def _mesh(c, v):
    return pr.mesh_tensors(v, c["faces"], c["adj"], c["deg"], c["bnd"], "cpu")


def _rasters(c, v):
    return pr.to_device(pr.build_rasters(c["pairs"], c["grays"], c["cams"],
                                         c["faces"], np.asarray(v)), "cpu")


def _bits(t):
    return t.detach().numpy().view(np.int32)


def test_program_equals_eager_iterations_over_a_refresh(case):
    """Two refresh blocks (8 iterations at ratio 0.9, then 4 at 1.0 from a
    new rasterization): the program's vertices and energy after every step
    equal _device_iter's, and on the CPU it never captures."""
    c = case
    step0, med, reg_w = _scalars()
    runner = graphs.Runner("cpu")
    mt = _mesh(c, c["v0"])
    prog = pr.IterProgram(runner, mt, c["statics"], step0, med, reg_w, 12)
    assert prog.v is not mt.verts            # mt.verts shares v0's memory here
    mt_e = _mesh(c, c["v0"])
    v_e = mt_e.verts
    for k0, n, ratio in ((0, 8, 0.9), (8, 4, 1.0)):
        rasters = _rasters(c, v_e.numpy())
        prog.refresh(rasters, ratio, k0)
        pds = pr._assemble_pair_data(c["statics"], rasters, mt_e.faces)
        r = torch.tensor(ratio, dtype=torch.float32)
        for k in range(k0, k0 + n):
            prog.step()
            v_e, e = pr._device_iter(v_e, k, pds, mt_e.adj, mt_e.deg, mt_e.faces,
                                     step0, med, reg_w, mt_e.boundary, r)
            assert np.array_equal(_bits(prog.v), _bits(v_e)), k
            assert np.array_equal(_bits(prog.e), _bits(e)), k
    assert np.array_equal(mt.verts.numpy(), c["v0"])
    assert int(prog.it) == 12 and prog.steps == 12
    assert prog.graph is None and runner.captures == 0 and runner.replays == 0


def test_decay_table_is_decay(case):
    step0, med, reg_w = _scalars()
    prog = pr.IterProgram(graphs.Runner("cpu"), _mesh(case, case["v0"]), case["statics"],
                          step0, med, reg_w, 49)
    assert prog.decays.dtype == torch.float32 and prog.decays.shape == (49,)
    for k in range(49):
        assert np.float32(prog.decays[k]) == np.float32(pr._decay(k)), k


def test_refine_mesh_program_equals_eager(case):
    """refine_mesh on the CPU through the program (the default on one
    device) against _eager=True: the same vertices to the bit, and stats
    showing no capture."""
    from openmvs_tpu_torch.config import RefineOptions
    from openmvs_tpu_torch.convert import mesh_from_numpy

    c = case
    opts = RefineOptions(scales=2, iters=8, max_face_area=64)
    stats = {}
    ours = pr.refine_mesh(c["scene"], mesh_from_numpy(c["v0"], c["faces"]), opts,
                          device="cpu", stats=stats)
    ref = pr.refine_mesh(c["scene"], mesh_from_numpy(c["v0"], c["faces"]), opts,
                         device="cpu", _eager=True)
    assert np.array_equal(np.asarray(ours.faces), np.asarray(ref.faces))
    assert np.array_equal(np.asarray(ours.vertices).view(np.int32),
                          np.asarray(ref.vertices).view(np.int32))
    assert stats["graphs"] == {"captures": 0, "capture_s": 0.0, "replays": 0,
                               "pool_bytes": 0}


def _segment_case(seed, n, R, K, empty_share=0.3):
    """Segment ids in [0, n) with about ``empty_share`` of the segments
    empty and some of one row, 20 rows at index n (left out), and rows
    holding -0.0, +0.0 and values whose sums round differently in another
    order."""
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(rng.uniform(size=n) >= empty_share)
    index = rng.choice(live, R)
    single = rng.choice(np.setdiff1d(np.arange(n), live), min(3, n - len(live)), replace=False)
    index = np.concatenate([index, single, np.full(20, n)])
    rng.shuffle(index)
    src = (rng.normal(0, 1, (len(index), K)) * 10.0 ** rng.integers(-3, 8, (len(index), K)))
    src = src.astype(np.float32)
    src[rng.uniform(size=src.shape) < 0.1] = -0.0
    src[rng.uniform(size=src.shape) < 0.05] = 0.0
    return torch.from_numpy(index.astype(np.int64)), torch.from_numpy(src), single


def _kernel_model(order, offsets, src):
    """The kernel's thread loop in numpy float32: out[s, k] from 0.0f, each
    row of the segment added in order."""
    n = len(offsets) - 1
    src2 = src.reshape(len(src), -1)
    out = np.zeros((n, src2.shape[1]), np.float32)
    for s in range(n):
        for k in range(src2.shape[1]):
            acc = np.float32(0.0)
            for r in range(offsets[s], offsets[s + 1]):
                acc = np.float32(acc + src2[order[r], k])
            out[s, k] = acc
    return out.reshape((n,) + src.shape[1:])


@pytest.mark.parametrize("K", [1, 3, 10])
def test_card_segments_and_fold_equal_segment_sum(K):
    n = 40
    index, src, single = _segment_case(K, n, 500, K)
    if K == 1:
        src = src[:, 0].contiguous()                        # 1-D rows, as vertex support
    want = pr._segment_sum(index, src, n)
    order, offsets = segment.segments(index, n)
    assert order.dtype == offsets.dtype == torch.int64 and offsets.shape == (n + 1,)
    counts = np.bincount(index.numpy(), minlength=n)[:n]
    assert np.array_equal(np.diff(offsets.numpy()), counts)
    # the rows at index n, past offsets[n], are left out
    kept = index.numpy() < n
    assert int(offsets[n]) == kept.sum()
    assert np.array_equal(_bits(want), _bits(pr._segment_sum(index[kept], src[kept], n)))
    assert (counts == 0).any() and (counts[single] == 1).all()
    got = segment.segment_sum_plain(order, offsets, src)
    assert got.shape == want.shape == (n,) + tuple(src.shape[1:])
    assert np.array_equal(_bits(got), _bits(want))
    order_np = np.argsort(index.numpy(), kind="stable")
    offsets_np = np.searchsorted(index.numpy()[order_np], np.arange(n + 1))
    assert np.array_equal(_kernel_model(order_np, offsets_np, src.numpy())
                          .view(np.int32), _bits(want))
    # the rows of one segment in their original order: the stable sort
    for s in range(n):
        rows = order[offsets[s]:offsets[s + 1]].numpy()
        assert np.array_equal(rows, np.flatnonzero(index.numpy() == s))
    # an empty segment and a segment of one -0.0 row both sum to +0.0
    assert not np.signbit(want.numpy()[counts == 0]).any()
    pm_kernel.reset_launches()
    assert np.array_equal(_bits(segment.segment_sum(order, offsets, src)), _bits(want))
    assert pm_kernel.LAUNCHES["segment_sum"] == 0


def test_face_sums_leave_faceless_pixels_out_without_changing_a_bit(case):
    """_photo_face_sums sends pixels with no face to a left-out segment;
    the JAX package adds their +0.0 rows into face 0. Both give the same
    bits: the face sums with the JAX indexing, on the slice case with its
    faces rolled so that face 0 is seen (its segment then holds real rows
    as well as the JAX package's faceless ones)."""
    c = case
    seen0 = int(_rasters(c, c["v0"]).fid[0].max())
    faces = np.roll(c["faces"], -seen0, axis=0)
    mt = pr.mesh_tensors(c["v0"], faces, c["adj"], c["deg"], c["bnd"], "cpu")
    rasters = pr.to_device(pr.build_rasters(c["pairs"], c["grays"], c["cams"], faces,
                                            c["v0"]), "cpu")
    pds = pr._assemble_pair_data(c["statics"], rasters, mt.faces)
    Pn, nf = len(pds.fid), len(faces)
    assert (pds.fid < 0).any() and (pds.fid == 0).any()
    seen = []
    seg = pr._segment_sum

    def jax_indexing(index, src, n):
        if not seen:                       # the pixel-to-face sum comes first
            seen.append(index)
            index = (torch.clamp(pds.fid, min=0).long().reshape(Pn, -1)
                     + torch.arange(Pn)[:, None] * nf).reshape(-1)
        return seg(index, src, n)

    want = pr._photo_face_sums(mt.verts, pds, mt.faces)
    pr._segment_sum = jax_indexing
    try:
        got = pr._photo_face_sums(mt.verts, pds, mt.faces)
    finally:
        pr._segment_sum = seg
    assert (seen[0] == Pn * nf).sum() == (pds.fid < 0).sum()
    for a, b in zip(got, want):
        assert np.array_equal(_bits(a), _bits(b))


def test_segment_sum_wrapper_rejects_bad_operands():
    index, src, _ = _segment_case(1, 8, 30, 3)
    order, offsets = segment.segments(index, 8)
    with pytest.raises(TypeError, match="int64"):
        segment.segment_sum(order.to(torch.int32), offsets, src)
    with pytest.raises(TypeError, match="float32"):
        segment.segment_sum(order, offsets, src.double())
    with pytest.raises(ValueError, match="not contiguous"):
        segment.segment_sum(order, offsets, src.t().contiguous().t())
    with pytest.raises(ValueError, match="src"):
        segment.segment_sum(order, offsets, src[:-1])
    pm_kernel.reset_launches()
    with pytest.raises(ValueError, match="expected cuda"):
        segment._launch(order, offsets, src)
    assert pm_kernel.LAUNCHES["segment_sum"] == 0
