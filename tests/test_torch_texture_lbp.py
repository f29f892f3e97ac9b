"""The texture stage's parts (openmvs_tpu_torch/texture.py and the blurs of
openmvs_tpu_torch/io/images.py) against the JAX package's
(openmvs_tpu/texture.py) and OpenCV on the same numpy inputs, on the CPU.

Face labels are compared with ``np.array_equal``: the port's LBP repeats
the JAX schedule operation for operation (only min, subtract and add touch
the floats), so it must give the labels of the JAX numpy path and of its
jitted device path (``OMVS_LBP_JAX=1``, set for the JAX call only).
"""

import dataclasses

import cv2
import jax  # noqa: F401  (JAX on the CPU before the port's torch work)
import numpy as np
import pytest
import torch

from test_sharded_texture import _random_face_graph

torch.set_num_threads(1)


def _ring(nf):
    """The ring graph of tests/test_texture.py: i - 1, i + 1, i + nf/2."""
    adj = np.full((nf, 3), -1, np.int64)
    for i in range(nf):
        adj[i] = ((i + 1) % nf, (i - 1) % nf, (i + nf // 2) % nf)
    return adj


def _ring_case(trial):
    """test_texture.py::test_lbp_jax_path_matches_numpy's inputs: 20%
    occlusions, face 3 unseen, lam_edge on odd trials."""
    rng = np.random.default_rng(7)
    nf, V = 400, 5
    for t in range(trial + 1):
        quality = rng.uniform(0.0, 1.0, (nf, V)).astype(np.float32)
        quality[rng.uniform(size=(nf, V)) < 0.2] = 0
        quality[3] = 0
        lam_edge = (rng.uniform(0.1, 2.0, (nf, 3)).astype(np.float32)
                    if t % 2 else None)
    return quality, _ring(nf), lam_edge


def _random_case(trial):
    """tests/test_sharded_texture.py's random dual graphs (mutual slots,
    occlusions, 5% unseen faces), with lam_edge on odd trials."""
    quality, adj = _random_face_graph(V=5 if trial < 2 else 7, seed=trial)
    lam_edge = (np.random.default_rng(1).uniform(0.05, 0.3, adj.shape)
                .astype(np.float32) if trial % 2 else None)
    return quality, adj, lam_edge


CASES = ([("ring", t) for t in range(3)] + [("random", t) for t in range(4)])


def _case(kind, trial):
    return _ring_case(trial) if kind == "ring" else _random_case(trial)


def test_texture_options_equal_field_for_field():
    from openmvs_tpu.config import TextureOptions as J
    from openmvs_tpu_torch.config import TextureOptions as P

    assert [(f.name, f.type, f.default) for f in dataclasses.fields(P)] == \
        [(f.name, f.type, f.default) for f in dataclasses.fields(J)]


@pytest.mark.parametrize("kind,trial", CASES)
def test_lbp_labels_equal_jax_numpy_and_device_paths(kind, trial, monkeypatch):
    from openmvs_tpu.texture import label_faces_lbp as jax_lbp
    from openmvs_tpu_torch.texture import label_faces_lbp

    quality, adj, lam_edge = _case(kind, trial)
    smooth = 0.5 if kind == "ring" else 0.1
    got = label_faces_lbp(quality, adj, smooth, iters=30, lam_edge=lam_edge,
                          device="cpu")
    monkeypatch.delenv("OMVS_LBP_JAX", raising=False)
    want_np = jax_lbp(quality, adj, smooth, iters=30, lam_edge=lam_edge)
    monkeypatch.setenv("OMVS_LBP_JAX", "1")
    want_dev = jax_lbp(quality, adj, smooth, iters=30, lam_edge=lam_edge)
    assert np.array_equal(got, want_np)
    assert np.array_equal(got, want_dev)
    unseen = quality.max(axis=1) <= 0
    assert unseen.any() and (got[unseen] == -1).all() and (got[~unseen] >= 0).all()


def test_lbp_non_manifold_slots_equal_jax():
    """One-directional slots (a neighbour that does not point back) carry
    no message; labels still equal the JAX package's."""
    from openmvs_tpu.texture import label_faces_lbp as jax_lbp
    from openmvs_tpu_torch.texture import label_faces_lbp

    quality, adj, _ = _random_case(0)
    adj = adj.copy()
    adj[::17, 2] = np.arange(len(adj))[::-17][: len(adj[::17])]   # one-way
    got = label_faces_lbp(quality, adj, 0.1, iters=20, device="cpu")
    assert np.array_equal(got, jax_lbp(quality, adj, 0.1, iters=20))


def test_lbp_default_device_raises_without_a_card():
    from openmvs_tpu_torch.texture import label_faces_lbp

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    quality, adj, _ = _ring_case(0)
    with pytest.raises(RuntimeError, match="cuda"):
        label_faces_lbp(quality, adj, 0.5)


@pytest.mark.parametrize("lam", [0.15, 0.45])
def test_trws_labels_and_bounds_equal_jax(lam):
    """TRW-S (host numpy, copied): labels equal, bounds to rtol 1e-6 and
    monotone, as test_texture.py checks them."""
    from openmvs_tpu.texture import label_faces_trws as jax_trws
    from openmvs_tpu_torch.texture import label_faces_trws

    rng = np.random.default_rng(11)
    quality = rng.uniform(0.05, 1.0, (300, 6)).astype(np.float32)
    adj = _ring(300)
    got, gb = label_faces_trws(quality, adj, lam, iters=25, return_bound=True)
    want, wb = jax_trws(quality, adj, lam, iters=25, return_bound=True)
    assert np.array_equal(got, want)
    np.testing.assert_allclose(gb, wb, rtol=1e-6)
    assert np.all(np.diff(gb) >= -1e-4)


def test_trws_unseen_and_lam_edge_equal_jax():
    from openmvs_tpu.texture import label_faces_trws as jax_trws
    from openmvs_tpu_torch.texture import label_faces_trws

    quality, adj, lam_edge = _random_case(1)
    got = label_faces_trws(quality, adj, 0.1, iters=10, lam_edge=lam_edge)
    assert np.array_equal(got, jax_trws(quality, adj, 0.1, iters=10,
                                        lam_edge=lam_edge))
    assert (got[quality.max(axis=1) <= 0] == -1).all()


@pytest.mark.parametrize("heuristic", [0, 1, 2, 3])
def test_maxrects_positions_equal_jax(heuristic):
    from openmvs_tpu import texture as jt
    from openmvs_tpu_torch import texture as pt

    rng = np.random.default_rng(3)
    sizes = [(int(w), int(h)) for w, h in rng.integers(4, 90, (300, 2))]
    got = pt._pack_maxrects(sizes, 512, heuristic)
    assert got == jt._pack_maxrects(sizes, 512, heuristic)
    # a bounded page that cannot take every rect, and a placeable mask
    placeable = [bool(i % 3) for i in range(len(sizes))]
    got = pt._pack_maxrects(sizes, 256, heuristic, max_h=256, placeable=placeable)
    assert got == jt._pack_maxrects(sizes, 256, heuristic, max_h=256,
                                    placeable=placeable)
    assert any(p is None for p, ok in zip(got[0], placeable) if ok)


def test_shelf_packers_equal_jax():
    from openmvs_tpu import texture as jt
    from openmvs_tpu_torch import texture as pt

    rng = np.random.default_rng(5)
    sizes = [(int(w), int(h)) for w, h in rng.integers(3, 70, (500, 2))]
    assert pt._pack_skyline(sizes, 256) == jt._pack_skyline(sizes, 256)
    pos, page, uw, uh = pt._pack_skyline_pages(sizes, 256, 256)
    jpos, jpage, juw, juh = jt._pack_skyline_pages(sizes, 256, 256)
    assert (pos, uw, uh) == (jpos, juw, juh) and np.array_equal(page, jpage)
    assert page.max() > 0


def test_rasterize_without_barycentrics_equals_jax():
    from openmvs_tpu import native as jn
    from openmvs_tpu_torch import native as pn

    rng = np.random.default_rng(2)
    proj = np.c_[rng.uniform(-5, 70, (60, 2)), rng.uniform(1, 3, 60)]
    faces = rng.integers(0, 60, (80, 3)).astype(np.int32)
    fid, depth, bary = pn.rasterize(proj, faces, 48, 64, want_bary=False)
    jfid, jdepth, jbary = jn.rasterize(proj, faces, 48, 64, want_bary=False)
    assert bary is None and jbary is None
    assert np.array_equal(fid, jfid) and np.array_equal(depth, jdepth)
    assert (fid >= 0).any()
    _, _, bary = pn.rasterize(proj, faces, 48, 64)
    assert bary.shape == (48, 64, 3)


def test_gaussian_kernel_equals_opencv():
    from openmvs_tpu_torch.io import images as imio

    for ksize, sigma in ((13, 1.5), (9, 1.1), (7, 0.8)):
        k = imio.gaussian_kernel(ksize, sigma)
        assert np.array_equal(k.astype(np.float32),
                              cv2.getGaussianKernel(ksize, sigma).ravel()
                              .astype(np.float32))


@pytest.mark.parametrize("shape", [(300, 410, 3), (97, 64)])
def test_gaussian_blur_matches_cv2(shape):
    """Within 1e-4 of cv2.GaussianBlur on random float32 images, and the
    sharpen's uint8 result equal; on integer-valued float images (an 8-bit
    atlas) the sharpened texels may differ by one where the blur lands
    next to a rounding edge."""
    from openmvs_tpu_torch.io import images as imio

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    got, want = imio.gaussian_blur(a, 1.5), cv2.GaussianBlur(a, (0, 0), 1.5)
    assert got.dtype == np.float32 and got.shape == a.shape
    assert np.abs(got - want).max() <= 1e-4

    def sharpen(a, blur):
        return np.clip(a + 0.5 * (a - blur), 0, 255).astype(np.uint8)

    assert np.array_equal(sharpen(a, got), sharpen(a, want))
    ai = np.round(a)
    d = np.abs(sharpen(ai, imio.gaussian_blur(ai, 1.5)).astype(int)
               - sharpen(ai, cv2.GaussianBlur(ai, (0, 0), 1.5)))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4


def test_box_blur_matches_cv2_over_16_rounds():
    """Local seam leveling's diffusion: 16 rounds of the 5x5 box blur on a
    (h, w, 3) correction field and an (h, w) weight field."""
    from openmvs_tpu_torch.io import images as imio

    rng = np.random.default_rng(4)
    cc = rng.normal(0, 10, (120, 90, 3)).astype(np.float32)
    ww = (rng.random((120, 90)) < 0.05).astype(np.float32)
    c1, c2, w1, w2 = cc, cc, ww, ww
    for _ in range(16):
        c1, c2 = imio.box_blur(c1, 5), cv2.blur(c2, (5, 5))
        w1, w2 = imio.box_blur(w1, 5), cv2.blur(w2, (5, 5))
        assert np.abs(c1 - c2).max() <= 1e-4 and np.abs(w1 - w2).max() <= 1e-4
    assert c1.dtype == w1.dtype == np.float32
