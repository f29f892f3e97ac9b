"""PatchMatch's level inputs from a per-call store (``densify.LevelStore``)
on the CPU.

Each scene image is resized and put on the device once per
``dense_reconstruction`` call, and each geometric pass reads its
neighbours' depth maps where the previous pass estimated them. Held here:

* ``_build_pm_data`` packs every ``PMData`` field from the store's tensors
  to the bit of what the host assembly it replaced (``_host_build_pm_data``
  below, the set-up that resized and padded on the host and uploaded the
  stacks) packs from host arrays: photometric levels at scales 0.25, 0.5
  and 1, a geometric level with an absent neighbour (the 8x8 zero map), and
  the sharded path's padded views and extents;
* ``dense_reconstruction`` through the store equals the host set-up's run
  (maps, normals, confidences, cloud);
* the store's life: one call builds images x scales level images and
  serves every other request, the geometric passes read every neighbour
  map from the device, a second call builds again, the store holds no
  tensor once the call returns, and a neighbour resumed from a ``.dmap``
  is uploaded once.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from openmvs_tpu_torch import densify
from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.io import dmap as dmapio
from openmvs_tpu_torch.io import images as imio
from openmvs_tpu_torch.ops import patchmatch
from openmvs_tpu_torch.synthetic import build_gt_scene
from openmvs_tpu_torch.utils import log
from openmvs_tpu_torch.view_selection import select_views_for_scene

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _host_build_pm_data(ref_gray, ref_cam, nbr_grays, nbr_cams, opts, d_min, d_max,
                        lowres_prior, nbr_depths=None, usable=None, device="cuda",
                        pad_views=0, pad_hw=None):
    """The set-up the store replaced: host arrays padded into host stacks,
    then packed (and uploaded) by ``patchmatch.pack_pm_data``."""
    H, W = ref_gray.shape
    V = max(len(nbr_grays), pad_views)
    Hp = max(g.shape[0] for g in nbr_grays)
    Wp = max(g.shape[1] for g in nbr_grays)
    if pad_hw is not None:
        Hp, Wp = max(Hp, pad_hw[0]), max(Wp, pad_hw[1])
    images = np.zeros((V, Hp, Wp), np.float32)
    sizes = np.zeros((V, 2), np.float32)
    Hl = np.zeros((V, 3, 3), np.float32)
    Hm = np.zeros((V, 3), np.float32)
    depths = np.zeros((V, Hp, Wp), np.float32)
    Tl = np.zeros((V, 3, 3), np.float32)
    Tm = np.zeros((V, 3), np.float32)
    Tr = np.zeros((V, 3, 3), np.float32)
    Tn = np.zeros((V, 3), np.float32)
    Ri, Ci, Ki = ref_cam.R, ref_cam.C, ref_cam.K
    for j, (g, cam) in enumerate(zip(nbr_grays, nbr_cams)):
        h, w = g.shape
        images[j, :h, :w] = g
        sizes[j] = (h, w)
        Hl[j] = cam.K @ cam.R @ Ri.T
        Hm[j] = cam.K @ cam.R @ (Ci - cam.C)
        if nbr_depths is not None:
            dmap = np.asarray(nbr_depths[j])
            depths[j, : dmap.shape[0], : dmap.shape[1]] = dmap
            Tl[j], Tm[j] = Hl[j], Hm[j]
            Tr[j] = Ki @ Ri @ cam.R.T @ np.linalg.inv(cam.K)
            Tn[j] = Ki @ Ri @ (cam.C - Ci)
    offs = patchmatch.texel_offsets(opts)
    Kinv = ref_cam.Kinv
    goff = np.concatenate([offs, np.zeros((len(offs), 1), np.float32)], axis=-1) @ Kinv.T
    um = np.ones((H, W), bool)
    if usable is not None:
        um = usable
        if um.shape != (H, W):
            um = imio.resize_nearest(um, W, H)
    lowres = lowres_prior if lowres_prior is not None else np.zeros((H, W), np.float32)
    return patchmatch.pack_pm_data(
        opts, ref_gray.astype(np.float32), images, sizes, Hl, Hm, depths, Tl, Tm, Tr, Tn,
        np.ascontiguousarray(Kinv.T).astype(np.float32), goff.astype(np.float32),
        np.float32(d_min), np.float32(d_max), lowres, um, device=device)


class _HostLevels(densify.LevelStore):
    """The host set-up's level inputs: each request resized again on the
    host, each neighbour map its host copy, nothing kept."""

    def image(self, gray, s, device):
        return densify._resize_gray(gray, s)

    def keep(self, result, depth, device):
        pass

    def depth(self, result, device):
        return result.depth


def _host_setup(monkeypatch):
    monkeypatch.setattr(densify, "LevelStore", _HostLevels)
    monkeypatch.setattr(densify, "_build_pm_data", _host_build_pm_data)


def _assert_data_equal(a: patchmatch.PMData, b: patchmatch.PMData):
    for f in patchmatch.PMData._fields:
        x, y = getattr(a, f), getattr(b, f)
        pairs = zip(x, y) if f == "views" else [(x, y)]
        for k, (u, v) in enumerate(pairs):
            assert u.dtype == v.dtype and torch.equal(u, v), (f, k)


@pytest.fixture(scope="module")
def scene():
    scene, _, _ = build_gt_scene(n_views=4, W=160, H=120)
    select_views_for_scene(scene, DenseOptions())
    return scene


def _maps(scene, seed=3):
    rng = np.random.default_rng(seed)
    return {im.meta.id: densify.DepthMapResult(
        image_idx=k, depth=rng.uniform(1, 5, im.gray.shape).astype(np.float32),
        normal=None, conf=None, d_min=1.0, d_max=5.0, neighbor_ids=[], camera=None)
        for k, im in enumerate(scene.images)}


@pytest.mark.parametrize("s,geometric", [(0.25, False), (0.5, False), (1.0, False),
                                         (1.0, True)])
def test_level_data_from_the_store_equals_the_host_setup(scene, s, geometric):
    opts = DenseOptions()
    view = densify.setup_view(scene, 0, opts)
    assert len(view.nbr_ids) >= 2
    results = None
    store = densify.LevelStore()
    if geometric:
        # one neighbour absent (its 8x8 zero map), one kept on the device
        # as a pass leaves it, the others uploaded from the host
        results = _maps(scene)
        del results[view.nbr_ids[0]]
        kept = results[view.nbr_ids[1]]
        store.keep(kept, torch.from_numpy(kept.depth.copy()), CPU)
    ref, cam, grays, cams, depths = view.level(s, store, CPU, results)
    host_ref = densify._resize_gray(view.image.gray, s)
    host_grays = [densify._resize_gray(n.gray, s) for n in view.nbr_imgs]
    assert torch.equal(ref, torch.from_numpy(host_ref))
    host_depths = None
    if geometric:
        host_depths = [results[i].depth if i in results else np.zeros((8, 8), np.float32)
                       for i in view.nbr_ids]
    lowres = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 2, ref.shape).astype(np.float32))
    usable = np.random.default_rng(2).uniform(size=view.image.gray.shape) > 0.1
    for um in (None, usable):
        got = densify._build_pm_data(ref, cam, grays, cams, opts, view.d_min, view.d_max,
                                     lowres, depths, usable=um, device=CPU)
        want = _host_build_pm_data(host_ref, cam, host_grays, cams, opts, view.d_min,
                                   view.d_max, lowres, host_depths, usable=um, device=CPU)
        _assert_data_equal(got, want)
    if geometric:
        assert store.uploads == len(view.nbr_ids) - 2


def test_padded_views_and_extents_equal_the_host_setup(scene):
    """The sharded path's stacking: a padded reference canvas, padded
    neighbour slots and extents."""
    opts = DenseOptions()
    view = densify.setup_view(scene, 1, opts)
    store = densify.LevelStore()
    results = _maps(scene, seed=5)
    ref, cam, grays, cams, depths = view.level(1.0, store, CPU, results)
    h, w = ref.shape
    V, pad_hw = len(grays) + 2, (h + 8, w + 6)
    host_ref = np.pad(view.image.gray, ((0, 8), (0, 4)))
    host_grays = [n.gray for n in view.nbr_imgs]
    host_depths = [results[i].depth for i in view.nbr_ids]
    got = densify._build_pm_data(F.pad(ref, (0, 4, 0, 8)), cam, grays, cams, opts, view.d_min,
                                 view.d_max, None, depths, device=CPU, pad_views=V,
                                 pad_hw=pad_hw)
    want = _host_build_pm_data(host_ref, cam, host_grays, cams, opts, view.d_min, view.d_max,
                               None, host_depths, device=CPU, pad_views=V, pad_hw=pad_hw)
    assert got.views.image.shape[:2] == (V, h + 8)
    _assert_data_equal(got, want)


@pytest.fixture(scope="module")
def slice_scene():
    scene, _, _ = build_gt_scene(n_views=3, W=160, H=120)
    return scene


SLICE = dict(sub_resolution_levels=1, estimation_iters=4, estimation_geometric_iters=2)


def _run(scene, tmp, **kw):
    pc = densify.dense_reconstruction(scene, DenseOptions(**SLICE), save_dmaps_to=str(tmp),
                                      device="cpu", **kw)
    maps = {}
    for name in sorted(os.listdir(tmp)):
        if name.endswith(".dmap"):
            d = dmapio.load(os.path.join(tmp, name))
            maps[name] = (d.depth, d.normal, d.conf)
    return pc, maps


def test_dense_reconstruction_through_the_store_equals_the_host_setup(slice_scene, tmp_path,
                                                                      monkeypatch):
    pc, maps = _run(slice_scene, tmp_path / "store")
    with monkeypatch.context() as m:
        _host_setup(m)
        host_pc, host_maps = _run(slice_scene, tmp_path / "host")
    assert len(maps) == 3 and maps.keys() == host_maps.keys()
    for name in maps:
        for a, b in zip(maps[name], host_maps[name]):
            assert torch.equal(torch.from_numpy(a), torch.from_numpy(b)), name
    assert np.array_equal(pc.points, host_pc.points) and len(pc) > 1000


def _held(store) -> int:
    return len(store._images) + len(store._maps)


class _Watched(densify.LevelStore):
    made = []

    def __init__(self):
        super().__init__()
        self.made.append(self)
        self.held_after_retain = []

    def retain(self, results):
        super().retain(results)
        self.held_after_retain.append(len(self._maps))


def _counted(scene, opts, **kw):
    with log.recording() as rec:
        densify.dense_reconstruction(scene, opts, device="cpu", **kw)
    return {k: v for k, v in rec.counters.items() if k != "pm.sweeps"}


def test_one_call_builds_each_level_image_once_and_reads_maps_where_estimated(monkeypatch):
    scene, _, _ = build_gt_scene(n_views=3, W=48, H=32)
    opts = DenseOptions(sub_resolution_levels=1, estimation_iters=2,
                        estimation_geometric_iters=2)
    monkeypatch.setattr(densify, "LevelStore", _Watched)
    _Watched.made.clear()
    first = _counted(scene, opts)
    nbrs = [len(densify.setup_view(scene, i, opts).nbr_ids) for i in range(3)]
    scales, passes = 2, 2
    requests = sum(1 + n for n in nbrs) * (scales + passes)
    assert first == {"pm.levels_built": 3 * scales,
                     "pm.levels_reused": requests - 3 * scales,
                     "pm.card_neighbour_maps": passes * sum(nbrs)}
    # nothing outlives a call: the next builds again, in a store of its own
    assert _counted(scene, opts) == first
    assert len(_Watched.made) == 2
    for store in _Watched.made:
        assert _held(store) == 0 and store.uploads == 0
        # after each geometric pass one pass's maps, none after the last
        assert store.held_after_retain == [3, 0]


def test_a_resumed_neighbour_map_is_uploaded_once(tmp_path, monkeypatch):
    scene, _, _ = build_gt_scene(n_views=3, W=48, H=32)
    opts = DenseOptions(sub_resolution_levels=0, estimation_iters=2,
                        estimation_geometric_iters=2)
    densify.dense_reconstruction(scene, opts, save_dmaps_to=str(tmp_path), fusion_mode=1,
                                 device="cpu")
    for i in (1, 2):
        os.remove(tmp_path / f"depth{i:04d}.dmap")
    monkeypatch.setattr(densify, "LevelStore", _Watched)
    _Watched.made.clear()
    got = _counted(scene, opts, save_dmaps_to=str(tmp_path), fusion_mode=1)
    (store,) = _Watched.made
    nbrs = {i: densify.setup_view(scene, i, opts).nbr_ids for i in (1, 2)}
    reads_of_0 = sum(ids.count(0) for ids in nbrs.values())
    assert reads_of_0 >= 1
    assert store.uploads == 1 and _held(store) == 0
    assert got["pm.card_neighbour_maps"] == 2 * sum(map(len, nbrs.values())) - 1
    # the resumed map stays through both passes
    assert store.held_after_retain == [3, 1]


def test_threads_sharing_a_store_build_each_level_image_once():
    """Worker threads (one per device in ``_run_views_parallel``) share the
    call's store: under a short switch interval, 16 threads asking for the
    same 8 level images in their own orders get one tensor per image."""
    import sys
    import threading

    grays = [np.random.default_rng(k).uniform(size=(24, 36)).astype(np.float32)
             for k in range(4)]
    keys = [(g, s) for g in grays for s in (1.0, 0.5)]
    store = densify.LevelStore()
    got = [[] for _ in range(16)]

    def work(t):
        order = np.random.default_rng(t).permutation(len(keys) * 4) % len(keys)
        for k in order:
            got[t].append((k, store.image(*keys[k], CPU)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with log.recording() as rec:
            threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert rec.counters == {"pm.levels_built": 8, "pm.levels_reused": 16 * 32 - 8}
    for k, (g, s) in enumerate(keys):
        served = {id(t) for row in got for j, t in row if j == k}
        assert len(served) == 1
        assert torch.equal(store.image(g, s, CPU), torch.from_numpy(densify._resize_gray(g, s)))
