"""SGM's rectification on the card (``csrc/rectify_warp.cu``, wrapper
``ops/rectify_kernel.warp_pair``) against the host warp it replaces,
``io/images.warp_perspective``, bit for bit.

Marked ``card``: each test skips without a CUDA card. This file imports no
JAX, so it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_rectify_card.py -q

- ``warp_pair`` on every case of ``test_torch_sgm_cv2._rectifications``
  (odd width, a W mod 16 tail, strong perspective, a 9x31 image) and on a
  homography that sends every pixel outside the source and a singular one.
- ``rectify_pair(..., device=card)`` on the 72 scored pairs of the
  benchmark's ``dtu-sgm`` scene (a 3x3 grid at 800x600): the same images
  and ``info`` as the host path, one launch and one
  ``sgm.card_rectifications`` a pair.
- ``estimate_depth_map_sgm`` on the card: the maps of the same call with
  the host warp, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from mvs_bench import harness, scene_gen
from openmvs_tpu_torch import densify
from openmvs_tpu_torch.io.images import warp_perspective
from openmvs_tpu_torch.ops import rectify_kernel, sgm
from openmvs_tpu_torch.utils import log
from openmvs_tpu_torch.view_selection import select_views_for_scene
from test_torch_sgm_cv2 import _rectifications

SEED = 2147483911
CASES = _rectifications() + [
    ("all_outside", np.array([[1.0, 0.0, 1e4], [0.0, 1.0, 1e4], [0.0, 0.0, 1.0]]), 120, 160),
    ("singular", np.array([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [0.0, 0.0, 1.0]]), 120, 160),
]
# a sub-pixel shift, so the pair's second image takes another homography
SHIFT = np.array([[1.0, 0.0, 0.37], [0.0, 1.0, -0.61], [0.0, 0.0, 1.0]])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bench_scene():
    """The benchmark's dtu-sgm scene with its views selected."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip")
    with open(harness.HERE / "configs" / "dtu-sgm.json") as f:
        cfg = json.load(f)
    scene = harness.build_scene(scene_gen.make_scene(cfg, SEED, "cuda"))
    opts = harness.options(cfg)
    select_views_for_scene(scene, opts)
    return scene, opts


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _pairs(scene, opts):
    """(reference, neighbour) images of every scored pair, as
    ``estimate_depth_map_sgm`` takes them."""
    by_id = {im.meta.id: im for im in scene.images}
    pairs = []
    for img in scene.images:
        scores = img.meta.view_scores
        num = opts.num_views if opts.num_views > 0 else len(scores)
        pairs += [(img, by_id[vs.id]) for vs in scores[:num] if vs.id in by_id]
    return pairs


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_warp_pair_equals_the_host_warp(card, case):
    _, M, H, W = case
    rng = np.random.default_rng(0)
    srcs = [rng.uniform(0, 1, (H, W)).astype(np.float32) for _ in range(2)]
    Ts = [M, SHIFT @ M]
    before = rectify_kernel.LAUNCHES["rectify_warp"]
    got = rectify_kernel.warp_pair(*(torch.from_numpy(s).to(card) for s in srcs), *Ts, W, H)
    torch.cuda.synchronize()
    assert rectify_kernel.LAUNCHES["rectify_warp"] == before + 1
    assert got.shape == (2, H, W) and got.dtype == torch.float32
    for k in range(2):
        want = warp_perspective(srcs[k], Ts[k], W, H)
        np.testing.assert_array_equal(_bits(got[k].cpu().numpy()), _bits(want))


@pytest.mark.card
def test_rectify_pair_on_the_card_equals_the_host_on_the_benchmark_pairs(card, bench_scene):
    scene, opts = bench_scene
    pairs = _pairs(scene, opts)
    assert len(pairs) == 72 and scene.images[0].gray.shape == (600, 800)
    before = rectify_kernel.LAUNCHES["rectify_warp"]
    with log.recording() as rec:
        for img, nb in pairs:
            camA, camB = img.working_camera(), nb.working_camera()
            *want, want_info = sgm.rectify_pair(camA, camB, img.gray, nb.gray)
            *got, info = sgm.rectify_pair(camA, camB, img.gray, nb.gray, device=card)
            for g, w in zip(got, want):
                assert isinstance(g, np.ndarray) and g.shape == w.shape
                np.testing.assert_array_equal(_bits(g), _bits(w))
            assert info.keys() == want_info.keys()
            for key in info:
                np.testing.assert_array_equal(info[key], want_info[key])
    assert rectify_kernel.LAUNCHES["rectify_warp"] - before == 72
    assert rec.counters["sgm.card_rectifications"] == 72


@pytest.mark.card
def test_sgm_depth_map_with_the_card_warp_equals_the_host_warp(card, bench_scene, monkeypatch):
    scene, opts = bench_scene
    with log.recording() as rec:
        got = densify.estimate_depth_map_sgm(scene, 4, opts, device=card)
    n_pairs = rec.counters["sgm.pairs"]
    assert n_pairs == 8 and rec.counters["sgm.card_rectifications"] == n_pairs
    # one sgm.rectify a pair and one for the reference's upload
    assert sum(sp.name == "sgm.rectify" for sp in rec.spans) == n_pairs + 1

    host = sgm.rectify_pair

    def host_warp(camA, camB, grayA, grayB, device=None):
        if isinstance(grayA, torch.Tensor):
            grayA = grayA.cpu().numpy()
        return host(camA, camB, grayA, grayB)

    monkeypatch.setattr(sgm, "rectify_pair", host_warp)
    with log.recording() as rec:
        want = densify.estimate_depth_map_sgm(scene, 4, opts, device=card)
    assert "sgm.card_rectifications" not in rec.counters
    for name in ("depth", "conf", "normal"):
        np.testing.assert_array_equal(_bits(getattr(got, name)), _bits(getattr(want, name)))
    assert (got.d_min, got.d_max) == (want.d_min, want.d_max)
    assert (got.depth > 0).mean() > 0.5
