"""Dense reconstruction pipeline: Scene -> dense point cloud, in torch.

Counterpart of ``openmvs_tpu/densify.py`` on its serial PatchMatch path
(Scene::DenseReconstruction / DepthMapsData::ComputeDepthMaps,
SceneDensify.cpp:1683-1980): view selection, sparse seeds, per-view
PatchMatch over a sub-resolution pyramid, geometric-consistency passes,
speckle/gap filters, the cross-view filter, and fusion into one cloud.

``estimator="sgm"`` replaces PatchMatch by tSGM stereo over the scored
neighbour pairs, fused per view (``estimate_depth_map_sgm``), with the
pairs' disparities cached as ``.dimap`` files beside the depth maps.

Estimation runs on ``device`` (the card by default); the cross-view
filter and fusion run where the maps were estimated (on a card by the
kernels of ``ops/filter_kernel.py`` and ``ops/fusion_kernel.py``, else host
numpy, as in the JAX package; fusion streamed from ``.dmap`` files and the
``merge`` mode stay on the host). A scene with a mesh and no point
cloud seeds from the mesh's visible samples (``sample_mesh_with_visibility``);
``export_mesh_to_depth_maps`` renders the mesh into every view. At
verbosity above 2 (``utils/log.verbosity``) each saved depth map also gets
its depth, normal and confidence PNGs (``dump_depth_artifacts``).

The PatchMatch sweep's switches are ``patchmatch.Switches``, read from the
environment once per ``dense_reconstruction`` or ``estimate_depth_map``
call; a view's steps are ``patchmatch.schedule``'s and its set-up is
``setup_view``'s, both shared with the sharded path. Also read:
``OMVS_PROFILE_DIR`` (a ``torch.profiler`` trace of the whole call, its
spans as ranges) and ``OMVS_DEBUG_NANS`` (``utils/safety.check_finite`` on
each downloaded map).

Spans (``utils/log.span``, kept inside ``log.recording()``): ``densify``
around the call, the stages ``timed`` logs, and in the PatchMatch path
``pm.view`` (``pm.seed``, per level ``pm.level`` with ``pm.setup``,
``pm.init``, ``pm.block`` and ``pm.sweep``, then ``pm.finalize``),
``pm.download``, ``filter.project`` and ``filter.decide`` per view (and on
a card ``filter.upload`` and the counter ``filter.card_splats``), and
fusion's ``fuse.*`` steps (on a card also ``fuse.upload``, ``fuse.download``
and the counter ``fuse.card_views``); ``graphs`` adds ``graphs.capture`` and the
counter ``pm.sweeps``; ``LevelStore`` the counters ``pm.levels_built``,
``pm.levels_reused`` and ``pm.card_neighbour_maps``.

A call's level images and the maps a geometric pass reads are a
``LevelStore``'s, on the device: each image resized and uploaded once per
call, each map read where the previous pass estimated it.

``dense_reconstruction(devices=[...])`` deals the views to one worker
thread per device; ``mesh=`` (``parallel/``) shards PatchMatch estimation
and the cross-view filter over a (views, tile) grid of shards.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.geometry.camera import Camera
from openmvs_tpu_torch.io import dimap as dimapio
from openmvs_tpu_torch.io import dmap as dmapio
from openmvs_tpu_torch.io import images as imio
from openmvs_tpu_torch.ops import (filter_kernel, filters, fusion, fusion_kernel, graphs,
                                  patchmatch, seed, sgm)
from openmvs_tpu_torch.scene import PointCloud, Scene
from openmvs_tpu_torch.utils import device as devmod
from openmvs_tpu_torch.utils import rng, safety
from openmvs_tpu_torch.utils.fmath import fma
from openmvs_tpu_torch.utils.log import (Progress, count, dump_depth_artifacts,
                                         get_logger, profile_trace, span, timed)
from openmvs_tpu_torch.view_selection import select_views_for_scene

log = get_logger("densify")


@dataclass
class DepthMapResult:
    image_idx: int
    depth: np.ndarray
    normal: np.ndarray
    conf: np.ndarray
    d_min: float
    d_max: float
    neighbor_ids: List[int]
    camera: Camera          # camera at depth-map resolution
    device: Optional[torch.device] = None  # where the map was estimated


def _resize_gray(gray: np.ndarray, scale: float) -> np.ndarray:
    if scale == 1.0:
        return gray
    h, w = gray.shape
    return imio.resize_area(gray, max(1, round(w * scale)), max(1, round(h * scale)))


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) triangle-kernel weights of ``jax.image.resize``'s
    "linear" method (half-pixel centres, weights renormalised at borders),
    computed in float32 as jax computes them."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = torch.abs(sample[None, :]
                  - torch.arange(n_in, dtype=torch.float32, device=device)[:, None])
    if inv_scale > 1.0:
        x = x / inv_scale
    wts = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(wts, dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    wts = torch.where(torch.abs(total) > eps,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0).T.contiguous()


def _resize_axis(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """One axis of the linear resize: each output is its taps (the inputs
    of nonzero weight) accumulated in input order with fused
    multiply-adds, as XLA evaluates the weight contraction."""
    wts = _linear_weights(x.shape[axis], n_out, x.device)    # (n_out, n_in)
    n_taps = int((wts != 0).sum(dim=1).max())
    # tap indices in input order; rows with fewer taps pad with weight 0,
    # which leaves the accumulation unchanged
    idx = torch.sort(torch.topk((wts != 0).to(torch.int64), n_taps, dim=1,
                                sorted=False).indices, dim=1).values
    tw = torch.gather(wts, 1, idx)
    xm = x.movedim(axis, 0)
    shape = (n_out,) + (1,) * (xm.dim() - 1)
    out = tw[:, 0].reshape(shape) * xm[idx[:, 0]]
    for k in range(1, n_taps):
        out = fma(tw[:, k].reshape(shape), xm[idx[:, k]], out)
    return out.movedim(0, axis)


def _resize_linear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (h, w), "linear")`` of a 2-D map, columns
    first, as jax contracts them."""
    H, W = x.shape
    out = x
    if w != W:
        out = _resize_axis(out, w, 1)
    if h != H:
        out = _resize_axis(out, h, 0)
    return out


def _resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (h, w, ...), "nearest")`` over the first two
    axes: source index floor((i + 0.5) * n_in / n_out) in float32."""
    for axis, n in ((0, h), (1, w)):
        m = x.shape[axis]
        if m == n:
            continue
        offs = (torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n
        x = torch.index_select(x, axis, torch.floor(offs).to(torch.int64))
    return x


def _build_pm_data(ref_gray, ref_cam: Camera, nbr_grays: list, nbr_cams: List[Camera],
                   opts: DenseOptions, d_min: float, d_max: float, lowres_prior,
                   nbr_depths: Optional[list] = None, usable: Optional[np.ndarray] = None,
                   device="cuda", pad_views: int = 0,
                   pad_hw: Optional[Tuple[int, int]] = None) -> patchmatch.PMData:
    """The static per-view arrays of the PatchMatch sweep, packed on
    ``device`` (``patchmatch.pack_pm_data``). The images and depth maps
    (tensors on ``device``, as a ``LevelStore`` serves them, or host arrays)
    are laid into zero-padded ``(V, Hp, Wp)`` stacks there; the cameras'
    constants are computed on the host.

    pad_views / pad_hw pad the neighbour-view axis and the neighbour-image
    extents to common sizes, so that the views of the sharded path stack
    (a padded view has size (0, 0): every sample lands out of bounds,
    scores th_robust, and the min-mean ignores it)."""
    dev = torch.device(device)
    H, W = ref_gray.shape
    V = max(len(nbr_grays), pad_views)
    Hp = max(g.shape[0] for g in nbr_grays)
    Wp = max(g.shape[1] for g in nbr_grays)
    if pad_hw is not None:
        Hp, Wp = max(Hp, pad_hw[0]), max(Wp, pad_hw[1])

    images = torch.zeros((V, Hp, Wp), dtype=torch.float32, device=dev)
    depths = torch.zeros((V, Hp, Wp), dtype=torch.float32, device=dev)
    sizes = np.zeros((V, 2), np.float32)
    Hl = np.zeros((V, 3, 3), np.float32)
    Hm = np.zeros((V, 3), np.float32)
    Tl = np.zeros((V, 3, 3), np.float32)
    Tm = np.zeros((V, 3), np.float32)
    Tr = np.zeros((V, 3, 3), np.float32)
    Tn = np.zeros((V, 3), np.float32)

    Ri, Ci, Ki = ref_cam.R, ref_cam.C, ref_cam.K
    for j, (g, cam) in enumerate(zip(nbr_grays, nbr_cams)):
        h, w = g.shape
        images[j, :h, :w] = torch.as_tensor(g, dtype=torch.float32, device=dev)
        sizes[j] = (h, w)
        # homography constants (DepthMap.h:175-185): Hl = Kj Rj Ri^T,
        # Hm = Kj Rj (Ci - Cj); Hr = Ki^-1 is folded into X0/goff.
        Hl[j] = cam.K @ cam.R @ Ri.T
        Hm[j] = cam.K @ cam.R @ (Ci - cam.C)
        if nbr_depths is not None:
            dmap = nbr_depths[j]
            depths[j, : dmap.shape[0], : dmap.shape[1]] = torch.as_tensor(
                dmap, dtype=torch.float32, device=dev)
            # geometric-consistency constants (DepthMap.h:170-173)
            Tl[j], Tm[j] = Hl[j], Hm[j]
            Tr[j] = Ki @ Ri @ cam.R.T @ np.linalg.inv(cam.K)
            Tn[j] = Ki @ Ri @ (cam.C - Ci)

    offs = patchmatch.texel_offsets(opts)
    Kinv = ref_cam.Kinv
    goff = np.concatenate([offs, np.zeros((len(offs), 1), np.float32)], axis=-1) @ Kinv.T

    if usable is None:
        um = torch.ones((H, W), dtype=torch.bool, device=dev)
    else:
        um = usable if usable.shape == (H, W) else imio.resize_nearest(usable, W, H)

    lowres = (lowres_prior if lowres_prior is not None
              else torch.zeros((H, W), dtype=torch.float32, device=dev))
    return patchmatch.pack_pm_data(
        opts, ref_gray, images, sizes, Hl, Hm, depths, Tl, Tm, Tr, Tn,
        np.ascontiguousarray(Kinv.T).astype(np.float32), goff.astype(np.float32),
        np.float32(d_min), np.float32(d_max), lowres, um, device=dev)


class DeferredResult:
    """estimate_depth_map output with the packed (H, W, 5) result still on
    the device: kernels run asynchronously, so the caller can prepare the
    next view's host data while this one computes; resolve() downloads."""

    def __init__(self, packed: torch.Tensor, template: DepthMapResult):
        self._packed = packed
        self._template = template

    def resolve(self) -> DepthMapResult:
        r = self._template
        with span("pm.download", view=r.image_idx):
            packed = self._packed.cpu().numpy()
            safety.check_finite("estimate_depth_map", packed)
            r.depth = np.array(packed[..., 0], np.float32, copy=True, order="C")
            r.normal = np.array(packed[..., 1:4], np.float32, copy=True, order="C")
            r.conf = np.array(packed[..., 4], np.float32, copy=True, order="C")
        return r


class LevelStore:
    """The level inputs of one densify call, on its devices.

    Each scene image at each pyramid scale is resized on the host once
    (``_resize_gray``, so its values are the host resize's bits) and put on
    a device once; every later set-up on that device is served the same
    tensor. The depth map a pass estimated is kept where it was estimated
    (``keep``), for the next geometric pass to read as a neighbour map
    without a download and an upload; a map with no copy on the asking
    device (resumed from a ``.dmap``, or estimated on another device) is
    uploaded once and kept. ``retain`` drops the maps a pass has replaced.

    ``dense_reconstruction`` owns one for the call, as it owns its
    ``graphs.Runners``, and releases it when the call returns (or at the
    end of a ``with`` block); ``estimate_depth_map`` and
    ``parallel.sharded.estimate_views_sharded`` called without one make
    their own. Worker threads share it under its lock.

    Counters (``utils/log.count``): ``pm.levels_built``, a level image made
    and put on a device; ``pm.levels_reused``, one served from the store;
    ``pm.card_neighbour_maps``, a neighbour map served from its device
    copy. ``uploads`` counts the neighbour maps uploaded from the host."""

    def __init__(self):
        self._lock = threading.Lock()
        self._images: Dict[tuple, tuple] = {}   # (id(gray), scale, device) -> (gray, tensor)
        self._maps: Dict[tuple, tuple] = {}     # (id(result), device) -> (result, tensor)
        self.uploads = 0

    def __enter__(self) -> "LevelStore":
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def release(self) -> None:
        """Let go of every tensor; the upload count stays."""
        with self._lock:
            self._images.clear()
            self._maps.clear()

    def image(self, gray: np.ndarray, s: float, device: torch.device) -> torch.Tensor:
        """``gray`` at pyramid scale ``s``, float32 on ``device``. The key
        holds the array itself, so its id names it while the entry lives."""
        key = (id(gray), s, device)
        with self._lock:
            hit = self._images.get(key)
            if hit is None:
                level = np.asarray(_resize_gray(gray, s), np.float32)
                hit = self._images[key] = (gray, torch.as_tensor(level, device=device))
                count("pm.levels_built")
            else:
                count("pm.levels_reused")
        return hit[1]

    def keep(self, result: DepthMapResult, depth: torch.Tensor, device: torch.device) -> None:
        """Keep ``depth``, ``result``'s map on ``device`` before its
        download, for the next geometric pass."""
        with self._lock:
            self._maps[(id(result), device)] = (result, depth)

    def depth(self, result: DepthMapResult, device: torch.device) -> torch.Tensor:
        """``result``'s depth map on ``device``: the copy kept there, else
        its host map uploaded and kept."""
        key = (id(result), device)
        with self._lock:
            hit = self._maps.get(key)
            if hit is None:
                hit = self._maps[key] = (result, torch.as_tensor(
                    result.depth, dtype=torch.float32, device=device))
                self.uploads += 1
            else:
                count("pm.card_neighbour_maps")
        return hit[1]

    def retain(self, results) -> None:
        """Drop the maps of every result not among ``results``: those a
        pass has replaced."""
        live = {id(r) for r in results}
        with self._lock:
            self._maps = {k: v for k, v in self._maps.items() if k[0] in live}


@dataclass
class ViewSetup:
    """What a reference view's PatchMatch estimation starts from
    (``setup_view``), at full working resolution, and its pyramid levels."""

    image: object               # the reference view's scene image
    nbr_ids: List[int]
    nbr_imgs: list
    camera: Camera
    seed_depth: np.ndarray      # (H, W), 0 where unseeded
    seed_normal: np.ndarray     # (H, W, 3)
    d_min: float
    d_max: float

    def level(self, s: float, levels: LevelStore, device: torch.device,
              neighbor_results: Optional[dict] = None):
        """(reference gray, its camera, neighbour grays, their cameras,
        their depth maps) at pyramid scale ``s``, the grays and depths as
        tensors on ``device`` served by ``levels``; the depths, from
        ``neighbor_results`` (an 8x8 zero map where one is absent), only
        where those are given."""
        ref = levels.image(self.image.gray, s, device)
        grays = [levels.image(n.gray, s, device) for n in self.nbr_imgs]
        cams = [n.working_camera() for n in self.nbr_imgs]
        cam = self.camera
        if s != 1.0:
            cam = cam.scaled(ref.shape[1] / self.image.gray.shape[1])
            cams = [c.scaled(g.shape[1] / n.gray.shape[1])
                    for c, g, n in zip(cams, grays, self.nbr_imgs)]
        depths = ([levels.depth(r, device) if (r := neighbor_results.get(i)) is not None
                   else torch.zeros((8, 8), dtype=torch.float32, device=device)
                   for i in self.nbr_ids]
                  if neighbor_results else None)
        return ref, cam, grays, cams, depths

    def seeds(self, s: float, shape: Tuple[int, int]):
        """(depth, normal) seeds at pyramid scale ``s`` on a zero canvas of
        ``shape``: each seed at its scaled pixel (clipped to the canvas),
        or copied where ``s`` is 1."""
        sd = np.zeros(shape, np.float32)
        sn = np.zeros(shape + (3,), np.float32)
        if s != 1.0:
            ys, xs = np.nonzero(self.seed_depth > 0)
            yy = np.clip((ys * s).astype(int), 0, shape[0] - 1)
            xx = np.clip((xs * s).astype(int), 0, shape[1] - 1)
            sd[yy, xx] = self.seed_depth[ys, xs]
            sn[yy, xx] = self.seed_normal[ys, xs]
        else:
            h, w = self.seed_depth.shape
            sd[:h, :w], sn[:h, :w] = self.seed_depth, self.seed_normal
        return sd, sn


def setup_view(scene: Scene, ref_idx: int, opts: DenseOptions,
               prev: Optional[DepthMapResult] = None,
               geometric: bool = False) -> Optional[ViewSetup]:
    """View ``ref_idx``'s neighbours (its scored views present in the
    scene, the first ``num_views``), working camera, seeds and depth range;
    None where it has no neighbour or an empty range. A geometric pass
    from ``prev`` takes prev's range, depth and normal; otherwise the seeds
    come from the sparse points the view sees, and the range from ``prev``
    where given. The serial and the sharded path both start from it."""
    img = scene.images[ref_idx]
    neighbors = img.meta.view_scores
    if not neighbors:
        return None
    num = opts.num_views if opts.num_views > 0 else len(neighbors)
    id_to_idx = {im.meta.id: i for i, im in enumerate(scene.images)}
    # filter, then slice: an absent scored neighbour backfills with a later
    # present one, and ids and images stay aligned
    nbr_ids = [vs.id for vs in neighbors if vs.id in id_to_idx][:num]
    if not nbr_ids:
        return None
    cam = img.working_camera()
    if prev is not None and geometric:
        sd, sn, d_min, d_max = prev.depth, prev.normal, prev.d_min, prev.d_max
    else:
        pts_sel, trusted = [], []
        for i, v in enumerate(scene.pointcloud.views):
            if img.meta.id in v:
                pts_sel.append(scene.pointcloud.points[i])
                trusted.append(len(v) >= opts.min_views_trust_point)
        H, W = img.gray.shape
        sd, sn, d_min, d_max = seed.seed_depth_normal(
            cam, W, H, np.asarray(pts_sel, np.float64).reshape(-1, 3),
            np.asarray(trusted, bool), interpolate=not opts.init_sparse,
            add_corners=opts.add_corners)
        if prev is not None:
            d_min, d_max = prev.d_min, prev.d_max
    if d_max <= d_min:
        return None
    return ViewSetup(img, nbr_ids, [scene.images[id_to_idx[i]] for i in nbr_ids], cam,
                     sd, sn, d_min, d_max)


def estimate_depth_map(
    scene: Scene,
    ref_idx: int,
    opts: DenseOptions,
    prev: Optional[DepthMapResult] = None,
    neighbor_results: Optional[Dict[int, DepthMapResult]] = None,
    geometric_iter: int = -1,
    rng_seed: int = 0,
    defer_download: bool = False,
    device="cuda",
    runners: Optional[graphs.Runners] = None,
    switches: Optional[patchmatch.Switches] = None,
    levels: Optional[LevelStore] = None,
    _eager: bool = False,
):
    """PatchMatch depth estimation for one reference view.

    geometric_iter < 0: photometric pass with the sub-resolution pyramid
    (EstimateDepthMap, SceneDensify.cpp:616-805); otherwise one
    geometric-consistency iteration at full resolution using the neighbors'
    current depth maps. ``switches`` (``patchmatch.Switches``) are read from
    the environment where not given.

    On the card the sweeps run as CUDA graphs replayed over static buffers
    (``ops/graphs.py``): ``runners`` (a ``dense_reconstruction`` call's)
    holds them across calls, else this call captures its own. On the CPU
    the sweeps run eagerly unless ``runners`` is given (the runner's CPU
    form). ``_eager`` runs them eagerly on the card too, the reference the
    graphs are checked against.

    The level images and the neighbours' depth maps come from ``levels`` (a
    ``dense_reconstruction`` call's ``LevelStore``), else from a store of
    this call's own. Where a geometric pass follows, the map is kept there
    on the device before its download.
    """
    if levels is None:
        with LevelStore() as own:
            return estimate_depth_map(scene, ref_idx, opts, prev, neighbor_results,
                                      geometric_iter, rng_seed, defer_download, device,
                                      runners, switches, own, _eager)
    switches = switches or patchmatch.Switches.from_env()
    with span("pm.view", view=ref_idx,
              **{"pass": "photometric" if geometric_iter < 0 else f"geometric {geometric_iter}"}):
        return _estimate_depth_map(scene, ref_idx, opts, prev, neighbor_results,
                                   geometric_iter, rng_seed, defer_download, device,
                                   runners, switches, levels, _eager)


def _estimate_depth_map(scene, ref_idx, opts, prev, neighbor_results, geometric_iter,
                        rng_seed, defer_download, device, runners, switches, levels, _eager):
    dev = devmod.resolve(device)
    runner = None
    if not _eager and (runners is not None or dev.type == "cuda"):
        runner = (runners or graphs.Runners()).get(dev)
    is_geometric = geometric_iter >= 0
    with span("pm.seed"):
        view = setup_view(scene, ref_idx, opts, prev, is_geometric)
    if view is None:
        return None
    plan = patchmatch.schedule(opts, switches, is_geometric)

    lowres_prior = state = None
    for level in range(plan.levels, -1, -1):
        with span("pm.level", level=level):
            with span("pm.setup"):
                s = 1.0 / (2 ** level)
                ref_gray, ref_cam, nbr_grays, nbr_cams, nbr_depths = view.level(
                    s, levels, dev, neighbor_results if is_geometric else None)
                if state is None:
                    sd, sn = view.seeds(s, ref_gray.shape)
                else:
                    # upscale the previous level's estimate as seed + low-res
                    # prior, on the device
                    sd = _resize_linear(state.depth, *ref_gray.shape)
                    sn = _resize_nearest(state.normal, *ref_gray.shape)
                    lowres_prior = sd

                data = _build_pm_data(
                    ref_gray, ref_cam, nbr_grays, nbr_cams, opts, view.d_min, view.d_max,
                    lowres_prior, nbr_depths,
                    usable=view.image.usable_mask(opts.ignore_mask_label), device=dev)
                key = rng.prng_key(rng_seed * 7919 + ref_idx * 131 + level
                                   + 1000 * (geometric_iter + 1))
                pm = graphs.Sweeps(data, opts, len(nbr_grays), is_geometric, runner,
                                   switches)
            with span("pm.init"):
                pm.init(key, sd, sn, plan.init_mode)
            if plan.block is not None:
                with span("pm.block"):
                    pm.block(key, n_perturb=plan.n_perturb, mode="nn", n_prop=8,
                             first_fold=1, **plan.block._asdict())
            for step in plan.sweeps:
                with span("pm.sweep", mode=step.mode):
                    pm.sweep(key, step.fold, step.mode, step.rescore,
                             n_perturb=plan.n_perturb, n_prop=8,
                             active_eps=step.active_eps)
            state = pm.state

    with span("pm.finalize"):
        geometric_follows = (not is_geometric) and opts.estimation_geometric_iters > 0
        # the last level's state, data and camera: full working resolution
        final = patchmatch.finalize(state, data, opts, geometric_follows)
        template = DepthMapResult(
            image_idx=ref_idx, depth=None, normal=None, conf=None,
            d_min=view.d_min, d_max=view.d_max, neighbor_ids=view.nbr_ids,
            camera=ref_cam, device=dev,
        )
        packed = patchmatch.pack_state(final)
        if geometric_iter + 1 < opts.estimation_geometric_iters:
            levels.keep(template, packed[..., 0].contiguous(), dev)
        deferred = DeferredResult(packed, template)
    if defer_download:
        return deferred
    return deferred.resolve()


def _sgm_pair_range(pts_ref: np.ndarray, info: dict, camA: Camera, camB: Camera,
                    opts: DenseOptions) -> Tuple[int, int]:
    """Global disparity range of a rectified pair from the reference's
    sparse points projected into both rectified cameras, 1st and 99th
    percentiles widened by 4 (the reference seeds from the triangulated
    sparse depth map, SemiGlobalMatcher.cpp:610-637); (-sgm_num_disparities,
    0) with fewer than 4 points in front of both."""
    d_lo, d_hi = -opts.sgm_num_disparities, 0
    if len(pts_ref) >= 4:
        Kn, Rn = info["Kn"], info["Rn"]

        def rect_u(C):
            Xc = (Rn @ (pts_ref - C).T)
            z = Xc[2]
            ok = z > 1e-9
            return (Kn[0, 0] * Xc[0] / np.where(ok, z, 1) + Kn[0, 2]), ok

        uA, okA = rect_u(camA.C)
        uB, okB = rect_u(camB.C)
        ok = okA & okB
        if ok.sum() >= 4:
            d = (uB - uA)[ok]
            d_lo = int(np.floor(np.percentile(d, 1))) - 4
            d_hi = int(np.ceil(np.percentile(d, 99))) + 4
    return d_lo, d_hi


def estimate_depth_map_sgm(
    scene: Scene,
    ref_idx: int,
    opts: DenseOptions,
    dimap_dir: Optional[str] = None,
    device="cuda",
    runners: Optional[graphs.Runners] = None,
    _eager: bool = False,
) -> Optional[DepthMapResult]:
    """Depth from tSGM stereo fused over all scored neighbour pairs
    (SemiGlobalMatcher::Match + ::Fuse, SemiGlobalMatcher.cpp:530-737,739):
    per pair, rectify, match coarse to fine on ``device`` (per-pixel
    disparity windows, WZNCC costs, cross-check, sub-pixel refinement);
    then cluster-fuse the pair depth maps in the reference frame (largest
    agreeing trust regions, min_views gate). With ``dimap_dir`` each pair's
    disparities are cached as a ``.dimap`` file and read back instead of
    matched when present (Match's File::isPresent skip).

    On the card each matching level runs as a CUDA graph of its shape
    class (``sgm.LevelProgram``): ``runners`` (a ``dense_reconstruction``
    call's) keeps them across calls, else this call captures its own and
    releases them when it returns. On the CPU the levels run op by op
    unless ``runners`` is given (the programs' CPU form). ``_eager`` runs
    them op by op on the card too, the reference the graphs are checked
    against.

    Spans: ``sgm.view`` (view) around ``sgm.pair`` (view, neighbour) per
    pair, which holds ``sgm.rectify``, the matcher's ``sgm.level`` spans
    and ``sgm.project``; then ``sgm.fuse`` (view). On the card each pair is
    rectified there, and the reference image, uploaded once a view for its
    pairs, has an ``sgm.rectify`` (view) of its own before them."""
    dev = devmod.resolve(device)
    if _eager or (runners is None and dev.type != "cuda"):
        runners = None
    elif runners is None:
        with graphs.Runners() as own:
            return estimate_depth_map_sgm(scene, ref_idx, opts, dimap_dir, dev, own)
    with span("sgm.view", view=ref_idx):
        return _estimate_depth_map_sgm(scene, ref_idx, opts, dimap_dir, dev, runners)


def _estimate_depth_map_sgm(scene, ref_idx, opts, dimap_dir, dev,
                            runners) -> Optional[DepthMapResult]:
    img = scene.images[ref_idx]
    neighbors = img.meta.view_scores
    if not neighbors:
        return None
    num = opts.num_views if opts.num_views > 0 else len(neighbors)
    id_to_idx = {im.meta.id: i for i, im in enumerate(scene.images)}
    camA = img.working_camera()
    H, W = img.gray.shape

    # sparse points seen by the reference (for disparity-range seeding)
    pts_ref = np.asarray(
        [scene.pointcloud.points[i]
         for i, v in enumerate(scene.pointcloud.views) if img.meta.id in v],
        np.float64).reshape(-1, 3)

    gray = img.gray
    if dev.type == "cuda":
        with span("sgm.rectify", view=ref_idx):
            gray = torch.as_tensor(gray, dtype=torch.float32, device=dev).contiguous()
    pair_maps = []
    for vs in neighbors[:num]:
        j = id_to_idx.get(vs.id)
        if j is None:
            continue
        nb = scene.images[j]
        camB = nb.working_camera()
        with span("sgm.pair", view=ref_idx, neighbour=vs.id):
            pair = _sgm_pair(camA, camB, img, nb, gray, pts_ref, opts, dimap_dir, dev,
                             runners)
        if pair is not None:
            pair_maps.append(pair)

    if not pair_maps:
        return None
    with span("sgm.fuse", view=ref_idx):
        depth, conf = sgm.fuse_pair_depths(pair_maps, max(1, opts.min_views - 1)
                                           if len(pair_maps) > 1 else 1)
    if depth is None or not (depth > 0).any():
        return None
    valid = depth > 0
    d_min = float(np.percentile(depth[valid], 2))
    d_max = float(np.percentile(depth[valid], 98))
    normal = np.zeros((H, W, 3), np.float32)
    normal[..., 2] = np.where(valid, -1.0, 0.0)
    conf_n = np.where(valid, np.clip(conf, 0.05, 1.0), 0.0)
    return DepthMapResult(
        image_idx=ref_idx,
        depth=depth.astype(np.float32),
        normal=normal,
        conf=conf_n.astype(np.float32),
        d_min=d_min,
        d_max=d_max,
        neighbor_ids=[vs.id for vs in neighbors[:num] if vs.id in id_to_idx],
        camera=camA,
        device=dev,
    )


def _sgm_pair(camA: Camera, camB: Camera, img, nb, gray, pts_ref: np.ndarray,
              opts: DenseOptions, dimap_dir: Optional[str], dev, runners):
    """One scored pair of an SGM view: rectified on ``dev`` (``gray`` the
    reference image, on ``dev`` already where that is a card), matched (or
    read from its ``.dimap`` cache) and projected into the reference camera
    as ``(depth, lo, hi, conf)``; None for a degenerate baseline."""
    H, W = img.gray.shape
    with span("sgm.rectify"):
        try:
            rectA, rectB, info = sgm.rectify_pair(camA, camB, gray, nb.gray, device=dev)
        except ValueError:
            return None

    cache = None
    if dimap_dir:
        cache = os.path.join(dimap_dir, f"{img.meta.id:04d}_{nb.meta.id:04d}.dimap")
    disp = cost = None
    if cache and os.path.exists(cache):
        dd = dimapio.load(cache)
        disp = dd.disparity.astype(np.float32)
        disp[~np.isfinite(disp)] = np.nan
        cost = (dd.cost.astype(np.float32)
                if dd.cost is not None else np.zeros_like(disp))
    if disp is None:
        d_lo, d_hi = _sgm_pair_range(pts_ref, info, camA, camB, opts)
        disp, cost = sgm.match_pair_tsgm(
            rectA, rectB, d_lo, d_hi,
            p1=opts.sgm_p1, p2=opts.sgm_p2, alpha=opts.sgm_p2_alpha,
            beta=opts.sgm_p2_beta,
            subpixel_mode=opts.sgm_subpixel_mode,
            num_dirs=opts.sgm_num_dirs, device=dev, runners=runners,
        )
        if cache:
            Q = np.eye(4)
            Q[:3, :3] = info["Rn"]
            Q[:3, 3] = info["C1"]
            Q[3, 0] = info["baseline"]
            dd = dimapio.DisparityData(
                disparity=disp.astype(np.float32),
                image_width=W, image_height=H,
                H=info["TA"], Q=Q,
                subpixel_steps=opts.sgm_subpixel_steps,
                cost=np.clip(np.nan_to_num(cost), 0, 65535).astype(np.uint16),
            )
            os.makedirs(dimap_dir, exist_ok=True)
            dimapio.save(dd, cache)

    with span("sgm.project"):
        return sgm.project_disparity_to_depth(
            disp, np.nan_to_num(cost), info, camA, (H, W),
            subpixel_steps=float(opts.sgm_subpixel_steps))


def optimize_depth_map(res: DepthMapResult, opts: DenseOptions) -> None:
    """Speckle removal + gap interpolation (EVT_OPTIMIZEDEPTHMAP stage)."""
    if opts.optimize & 1:
        filters.remove_small_segments(res.depth, res.normal, res.conf, opts)
    if opts.optimize & 2:
        filters.gap_interpolation(res.depth, res.normal, res.conf, opts)


def _filter_views(results: Dict[int, DepthMapResult], resumed: set,
                  opts: DenseOptions) -> Dict[int, DepthMapResult]:
    """Cross-view filter of every estimated map against its neighbors'
    maps projected into it (FilterDepthMap, SceneDensify.cpp:1050-1302).

    A map estimated on a card (``DepthMapResult.device``) is filtered there,
    by the hand-written kernels of ``ops/filter_kernel.py``; the others on
    the host in NumPy. Both give the same maps; the results hold NumPy maps
    either way."""
    cards: Dict[torch.device, List[int]] = {}
    for rid, r in results.items():
        if rid not in resumed and r.device is not None and r.device.type == "cuda":
            cards.setdefault(r.device, []).append(rid)
    on_card = {}
    for dev, rids in cards.items():
        on_card.update(filter_kernel.filter_views(results, rids, opts, dev))
    filtered: Dict[int, DepthMapResult] = {}
    for rid, r in results.items():
        if rid in resumed:
            filtered[rid] = r
            continue
        if rid in on_card:
            new = on_card[rid]
            filtered[rid] = r if new is None else dataclasses.replace(
                r, depth=new[0], conf=new[1])
            continue
        projected = []
        for nb_id in r.neighbor_ids:
            nb = results.get(nb_id)
            if nb is None:
                continue
            with span("filter.project", view=rid, neighbour=nb_id):
                projected.append(filters.project_depth_to_view(
                    nb.depth, nb.conf, nb.camera, r.camera, r.depth.shape))
        if len(projected) < opts.min_views_filter:
            filtered[rid] = r
            continue
        with span("filter.decide", view=rid):
            if opts.filter_adjust:
                nd, nc = filters.filter_depth_adjust(
                    r.depth, r.conf, projected, opts, r.d_min, r.d_max)
            else:
                nd, nc = filters.filter_depth_strict(r.depth, r.conf, projected, opts)
        filtered[rid] = dataclasses.replace(r, depth=nd, conf=nc)
    return filtered


def _fusion_card(results: Dict[int, DepthMapResult]) -> Optional[torch.device]:
    """The card every map was estimated on, where one card estimated them
    all (fusion then runs there); None otherwise."""
    devs = {r.device for r in results.values()}
    if len(devs) != 1:
        return None
    dev = devs.pop()
    return dev if dev is not None and torch.device(dev).type == "cuda" else None


def _run_views_parallel(fn, view_indices, devices) -> dict:
    """fn(view_idx, device) for each view (SceneDensify.cpp:1883-1903's
    per-image event pipeline). Progress lines count the views done.

    With one device, host work overlaps device compute: view i+1 is
    prepared and launched before view i's deferred result is downloaded
    (SceneDensify.cpp:54-64). With several, one worker thread per device
    takes the views round-robin, each on its own CUDA stream on a card, so
    the devices' launches overlap (two workers may share a card, on two
    streams). The kernel libraries are loaded before the workers start."""
    prog = Progress(log, "depth maps", len(view_indices))
    results = {}
    if len(devices) <= 1:
        dev = devices[0]
        pending = deque()
        for i in view_indices:
            r = fn(i, dev)
            if isinstance(r, DeferredResult):
                pending.append((i, r))
                if len(pending) > 1:
                    j, rj = pending.popleft()
                    results[j] = rj.resolve()
                    prog.step()
            else:
                results[i] = r
                prog.step()
        while pending:
            j, rj = pending.popleft()
            results[j] = rj.resolve()
            prog.step()
        prog.close()
        return results

    import concurrent.futures as cf

    from openmvs_tpu_torch.ops import _build

    if any(d.type == "cuda" for d in devices):
        _build.load_all()
    n = len(devices)
    step_lock = threading.Lock()

    def worker(slot):
        dev = devices[slot]
        stream = (torch.cuda.stream(torch.cuda.Stream(dev)) if dev.type == "cuda"
                  else contextlib.nullcontext())
        out = {}
        with stream:
            for i in view_indices[slot::n]:
                r = fn(i, dev)
                out[i] = r.resolve() if isinstance(r, DeferredResult) else r
                with step_lock:
                    prog.step()
        return out

    with cf.ThreadPoolExecutor(max_workers=n) as ex:
        # each worker runs in a copy of this context: its spans nest in
        # the pass's span
        for fut in [ex.submit(contextvars.copy_context().run, worker, slot)
                    for slot in range(n)]:
            results.update(fut.result())
    prog.close()
    return {i: results[i] for i in view_indices}


def dense_reconstruction(
    scene: Scene,
    opts: DenseOptions = DenseOptions(),
    max_dim: Optional[int] = None,
    save_dmaps_to: Optional[str] = None,
    fusion_mode: int = 0,
    respect_neighbors: bool = False,
    device="cuda",
    devices: Optional[list] = None,
    mesh=None,
    _eager: bool = False,
) -> PointCloud:
    """Full dense pipeline: estimate all depth maps, filter, fuse.

    fusion_mode (DensifyPointCloud --fusion-mode): 0 = estimate + fuse
    (default); 1 = export depth maps only (requires save_dmaps_to, returns
    an empty cloud); -1 = export SGM disparity maps only (forces
    estimator="sgm", per-pair .dimap files cached next to the dmaps); -2 =
    fuse from existing maps (estimation resumes off the .dmap/.dimap
    caches, so only missing views recompute). Views whose final .dmap
    already exists in save_dmaps_to are resumed, not re-estimated.

    devices (default ``[device]``): with several, the views are dealt
    round-robin to one worker thread per device (``_run_views_parallel``).
    mesh: a ``parallel.mesh.ShardMesh`` of more than one shard routes
    PatchMatch estimation and the adjust cross-view filter through the
    sharded path (``parallel.sharded``: views over the rows of shards,
    image rows over the tiles with halo exchange), whose maps equal the
    serial path's run without the adaptive early exit.

    On a card each view's sweeps (and SGM's levels) run as CUDA graphs,
    captured once per call and shape class and replayed over every view and
    pass (``ops/graphs.py``), and released with their memory pools when
    the call returns; ``_eager`` launches them one by one instead, the
    reference the graphs are checked against. The sharded path stays
    eager. The call's ``LevelStore`` holds the level images and the maps
    the geometric passes read, on the devices, until it returns."""
    with profile_trace("densify"), span("densify"), contextlib.ExitStack() as call:
        switches = patchmatch.Switches.from_env()
        dev = devmod.resolve(device)
        devices = [devmod.resolve(d) for d in devices] if devices else [dev]
        if abs(fusion_mode) == 1 and not save_dmaps_to:
            raise ValueError("fusion_mode +/-1 (map export only) requires save_dmaps_to")
        if fusion_mode == -1 and opts.estimator != "sgm":
            log.info("fusion-mode -1: forcing estimator='sgm' (disparity export)")
            opts = dataclasses.replace(opts, estimator="sgm")
        if max_dim is None:
            w0 = max(im.width for im in scene.images)
            h0 = max(im.height for im in scene.images)
            max_dim = imio.compute_max_resolution(
                w0, h0, opts.resolution_level, opts.min_resolution, opts.max_resolution)
        for img in scene.images:
            if img.gray is None:
                img.load(max_dim=max_dim)

        _mesh = getattr(scene, "mesh", None)
        if len(scene.pointcloud) == 0 and _mesh is not None and len(
                getattr(_mesh, "faces", ())):
            # mesh-but-no-cloud scenes: sample the mesh WITH VISIBILITY to seed
            # estimation (SampleMeshWithVisibility, Scene.cpp:634-741, used by
            # ComputeDepthMaps at SceneDensify.cpp:1756-1766)
            with timed(log, "sample mesh with visibility"):
                scene.pointcloud = sample_mesh_with_visibility(scene)
            log.info("mesh visibility seeding: %d points", len(scene.pointcloud))

        with timed(log, "select views"):
            select_views_for_scene(scene, opts, respect_existing=respect_neighbors)
        if len(devices) > 1:
            log.info("distributing views over %d devices", len(devices))

        # per-view resume: views whose final .dmap exists skip estimation and
        # serve as neighbor inputs (SceneDensify.cpp:2010-2029)
        results: Dict[int, DepthMapResult] = {}
        resumed: set = set()
        if save_dmaps_to:
            id_to_idx0 = {im.meta.id: i for i, im in enumerate(scene.images)}
            for img in scene.images:
                p = os.path.join(save_dmaps_to, f"depth{img.meta.id:04d}.dmap")
                if not os.path.exists(p):
                    continue
                dd = dmapio.load(p)
                results[img.meta.id] = DepthMapResult(
                    image_idx=id_to_idx0[img.meta.id],
                    depth=dd.depth,
                    normal=dd.normal if dd.normal is not None
                    else np.zeros(dd.depth.shape + (3,), np.float32),
                    conf=dd.conf if dd.conf is not None
                    else (dd.depth > 0).astype(np.float32),
                    d_min=dd.depth_min, d_max=dd.depth_max,
                    neighbor_ids=[int(v) for v in dd.view_ids[1:]],
                    camera=Camera(dd.K, dd.R, dd.C),
                )
                resumed.add(img.meta.id)
            if resumed:
                log.info("resume: %d views loaded from existing dmaps", len(resumed))

        use_sgm = opts.estimator == "sgm"
        use_sharded = mesh is not None and mesh.size > 1 and not use_sgm
        # the call's graph programs, released with their pools when it
        # returns, and its level images and neighbour maps on the devices
        runners = (call.enter_context(graphs.Runners())
                   if not _eager and any(d.type == "cuda" for d in devices) else None)
        levels = call.enter_context(LevelStore())
        if use_sharded:
            from openmvs_tpu_torch.parallel import sharded

            with timed(log, f"photometric pass sharded {mesh.shape}"):
                results.update(sharded.estimate_views_sharded(
                    scene, opts, mesh, skip_ids=resumed, switches=switches, levels=levels))
            for gi in range(opts.estimation_geometric_iters):
                with timed(log, f"geometric pass {gi} sharded"):
                    new = sharded.estimate_views_sharded(
                        scene, opts, mesh, prev_results=results, geometric_iter=gi,
                        skip_ids=resumed, switches=switches, levels=levels)
                new.update({rid: results[rid] for rid in resumed if rid in results})
                results = new
                levels.retain(results.values())
        else:
            # pass 1: photometric estimation
            todo = [i for i in range(scene.n_views)
                    if scene.images[i].meta.id not in resumed]
            if use_sgm:
                est = lambda i, d: estimate_depth_map_sgm(scene, i, opts,
                                                          dimap_dir=save_dmaps_to, device=d,
                                                          runners=runners, _eager=_eager)
            else:
                est = lambda i, d: estimate_depth_map(scene, i, opts, defer_download=True,
                                                      device=d, runners=runners,
                                                      switches=switches, levels=levels,
                                                      _eager=_eager)
            with timed(log, f"photometric pass ({len(todo)} views)"):
                raw = _run_views_parallel(est, todo, devices)
            for i, r in raw.items():
                if r is not None:
                    results[scene.images[i].meta.id] = r

            # pass 2: geometric-consistency re-estimation; SGM results are
            # fused across pairs by the SGM path itself, and the reference's
            # SGM fusion mode skips PatchMatch re-estimation
            # (SceneDensify.cpp:2045-2057)
            for gi in range(0 if use_sgm else opts.estimation_geometric_iters):
                have = [i for i in range(scene.n_views)
                        if scene.images[i].meta.id in results
                        and scene.images[i].meta.id not in resumed]
                with timed(log, f"geometric pass {gi} ({len(have)} views)"):
                    raw = _run_views_parallel(lambda i, d: estimate_depth_map(
                        scene, i, opts, prev=results[scene.images[i].meta.id],
                        neighbor_results=results, geometric_iter=gi,
                        defer_download=True, device=d, runners=runners,
                        switches=switches, levels=levels, _eager=_eager), have, devices)
                # resumed views (and failed re-estimations) keep contributing
                new_results: Dict[int, DepthMapResult] = dict(results)
                for i, r in raw.items():
                    if r is not None:
                        new_results[scene.images[i].meta.id] = r
                results = new_results
                levels.retain(results.values())

        # optimize: speckle + gaps (resumed views were optimized before saving)
        with timed(log, "optimize depth maps"):
            for rid, r in results.items():
                if rid not in resumed:
                    optimize_depth_map(r, opts)

        # pass 3: cross-view filtering (the adjust mode on the shards when
        # estimation ran sharded: one all_gather over views, pmin/pmax over tile)
        if opts.optimize & 4 and use_sharded and opts.filter_adjust:
            from openmvs_tpu_torch.parallel.sharded_filter import filter_views_sharded

            with timed(log, "cross-view filter sharded"):
                results = filter_views_sharded(results, opts, mesh, skip_ids=resumed)
        elif opts.optimize & 4:
            with timed(log, "cross-view filter"):
                results = _filter_views(results, resumed, opts)

        if save_dmaps_to:
            os.makedirs(save_dmaps_to, exist_ok=True)
            for rid, r in results.items():
                if rid in resumed:
                    continue
                dd = dmapio.DepthData(
                    depth=r.depth,
                    image_width=scene.images[r.image_idx].width,
                    image_height=scene.images[r.image_idx].height,
                    depth_min=r.d_min, depth_max=r.d_max,
                    file_name=scene.images[r.image_idx].meta.name,
                    view_ids=np.array([rid] + list(r.neighbor_ids), np.uint32),
                    K=r.camera.K, R=r.camera.R, C=r.camera.C,
                    normal=r.normal, conf=r.conf,
                )
                dmapio.save(dd, os.path.join(save_dmaps_to, f"depth{rid:04d}.dmap"))
                dump_depth_artifacts(save_dmaps_to, rid, r.depth, r.normal, r.conf)

        if abs(fusion_mode) == 1:
            log.info("fusion-mode %d: %d maps exported to %s; skipping fusion",
                     fusion_mode, len(results), save_dmaps_to)
            return PointCloud()

        with timed(log, "fuse depth maps"):
            use_stream = (opts.fuse_mode != "merge" and save_dmaps_to
                          and len(results) > 16)
            if use_stream:
                # large scene: free the in-RAM maps and stream them back from
                # the .dmap files on demand (DepthMap.h:217-218)
                meta = [(rid, r.image_idx, list(r.neighbor_ids))
                        for rid, r in results.items()]
                max_nb = max((len(m[2]) for m in meta), default=2)
                for r in results.values():
                    r.depth = r.normal = r.conf = None
                provider = fusion.ViewProvider(
                    [m[0] for m in meta], _dmap_fusion_loader(scene, save_dmaps_to, meta),
                    max_cached=max_nb + 2, neighbor_ids={m[0]: m[2] for m in meta})
                pc = fusion.fuse_depth_maps(
                    None, opts, estimate_color=opts.estimate_colors > 0,
                    estimate_normal=opts.estimate_normals > 0, provider=provider)
            else:
                id_to_idx = {im.meta.id: i for i, im in enumerate(scene.images)}
                vdd = []
                with span("fuse.prepare"):
                    for rid, r in results.items():
                        img = scene.images[id_to_idx[rid]]
                        color = img.color
                        if color is not None and color.shape[:2] != r.depth.shape:
                            color = imio.resize_area(color, r.depth.shape[1], r.depth.shape[0])
                        vdd.append(fusion.ViewDepthData(
                            image_idx=r.image_idx, image_id=rid, camera=r.camera,
                            depth=r.depth, normal=r.normal, conf=r.conf, color=color,
                            neighbor_ids=r.neighbor_ids))
                est = dict(estimate_color=opts.estimate_colors > 0,
                           estimate_normal=opts.estimate_normals > 0)
                card = _fusion_card(results)
                if opts.fuse_mode == "merge":
                    pc = fusion.merge_depth_maps(vdd, opts, **est)
                elif card is not None:
                    pc = fusion_kernel.fuse_views(vdd, opts, device=card, **est)
                else:
                    pc = fusion.fuse_depth_maps(vdd, opts, **est)
        if save_dmaps_to and opts.remove_dmaps:
            for rid in results:
                p = os.path.join(save_dmaps_to, f"depth{rid:04d}.dmap")
                if os.path.exists(p):
                    os.remove(p)
        log.info("dense point cloud: %d points", len(pc))
        return pc


def sample_mesh_with_visibility(scene: Scene, n_samples: int = 60_000,
                                seed: int = 0) -> PointCloud:
    """Area-weighted mesh surface samples with per-view visibility from
    z-buffer renders (Scene::SampleMeshWithVisibility, Scene.cpp:634-741):
    a sample sees view V when its projected depth matches V's rasterized
    mesh depth within 1%.  Samples visible in <2 views are dropped."""
    from openmvs_tpu_torch import mesh_ops, native

    pts, _ = mesh_ops.sample_points(scene.mesh, n_samples, seed=seed)
    P = pts.astype(np.float64)
    vis = []
    for img in scene.images:
        cam = img.camera if img.camera is not None else img.working_camera()
        W, H = img.width or 640, img.height or 480
        verts = scene.mesh.vertices.astype(np.float64)
        Xc = (verts - cam.C) @ cam.R.T
        z = np.maximum(Xc[:, 2], 1e-12)
        proj = np.stack([cam.K[0, 0] * Xc[:, 0] / z + cam.K[0, 2]
                         + cam.K[0, 1] * Xc[:, 1] / z,
                         cam.K[1, 1] * Xc[:, 1] / z + cam.K[1, 2],
                         Xc[:, 2]], -1)
        _, zmap, _ = native.rasterize(proj, scene.mesh.faces, H, W,
                                      want_bary=False)
        Xp = (P - cam.C) @ cam.R.T
        zp = Xp[:, 2]
        front = zp > 1e-9
        u = np.where(front, cam.K[0, 0] * Xp[:, 0] / np.where(front, zp, 1)
                     + cam.K[0, 2], -1)
        v = np.where(front, cam.K[1, 1] * Xp[:, 1] / np.where(front, zp, 1)
                     + cam.K[1, 2], -1)
        ui = np.round(u).astype(np.int64)
        vi = np.round(v).astype(np.int64)
        ok = front & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        zs = zmap[np.clip(vi, 0, H - 1), np.clip(ui, 0, W - 1)]
        vis.append(ok & (zs > 0) & (np.abs(zs - zp) < 0.01 * zp))
    vis = np.stack(vis, axis=1)                      # (N, n_views)
    ids = np.array([im.meta.id for im in scene.images], np.uint32)
    count = vis.sum(axis=1)
    keep = count >= 2
    pc = PointCloud()
    pc.points = pts[keep]
    pc.views = [ids[v] for v in vis[keep]]
    pc.weights = [np.ones(int(c), np.float32) for c in count[keep]]
    return pc


def export_mesh_to_depth_maps(scene: Scene, base_name: str,
                              opts: DenseOptions = DenseOptions()) -> int:
    """Render the scene mesh into every view and save per-image depth maps
    (Scene::ExportMeshToDepthMaps, Scene.cpp:680-736).  Output format by
    extension: .dmap (full codec incl. interpolated camera-space normals),
    .pfm (raw float), anything else = normalized 8-bit visualization.
    Files are written as base0000.ext, base0001.ext, ... Returns the count.
    The visualization is written by ``io/images.write_image`` (PNG and SCI
    by the port, other formats through PIL) where the JAX package calls
    ``cv2.imwrite``."""
    from openmvs_tpu_torch import mesh_ops, native
    from openmvs_tpu_torch.texture import _project

    mesh = scene.mesh
    if mesh is None or not len(getattr(mesh, "faces", ())):
        raise ValueError("scene has no mesh to render")
    stem, ext = os.path.splitext(base_name)
    ext_l = ext.lower()
    vnorm = (mesh_ops.vertex_normals(mesh.vertices, mesh.faces)
             if ext_l == ".dmap" else None)

    w0 = max(im.width for im in scene.images)
    h0 = max(im.height for im in scene.images)
    max_dim = imio.compute_max_resolution(
        w0, h0, opts.resolution_level, opts.min_resolution, opts.max_resolution)
    n = 0
    for img in scene.images:
        if img.gray is None:
            img.load(max_dim=max_dim)
        cam = img.working_camera()
        H, W = img.gray.shape
        proj = _project(cam, mesh.vertices.astype(np.float64))
        fid, depth, bary = native.rasterize(proj, mesh.faces, H, W,
                                            want_bary=ext_l == ".dmap")
        depth = np.where(fid >= 0, depth, 0.0).astype(np.float32)
        out = f"{stem}{img.meta.id:04d}{ext}"
        if ext_l == ".dmap":
            # interpolate vertex normals, rotate into camera space (the
            # .dmap convention, ExportDepthDataRaw)
            nrm = np.zeros((H, W, 3), np.float32)
            sel = fid >= 0
            tri = mesh.faces[fid[sel]]
            nw = np.einsum("pk,pkc->pc", bary[sel], vnorm[tri])
            nc = nw @ cam.R.T
            nc /= np.maximum(np.linalg.norm(nc, axis=1, keepdims=True), 1e-12)
            nrm[sel] = nc.astype(np.float32)
            d_valid = depth[depth > 0]
            dd = dmapio.DepthData(
                depth=depth, image_width=W, image_height=H,
                depth_min=float(d_valid.min()) if len(d_valid) else 0.001,
                depth_max=float(d_valid.max()) if len(d_valid) else 1.0,
                file_name=img.meta.name,
                view_ids=np.array(
                    [img.meta.id] + [vs.id for vs in (img.meta.view_scores
                                                      or [])], np.uint32),
                K=cam.K, R=cam.R, C=cam.C, normal=nrm,
            )
            dmapio.save(dd, out)
        elif ext_l == ".pfm":
            imio.save_pfm(out, depth)
        else:
            v = depth[depth > 0]
            lo, hi = (v.min(), v.max()) if len(v) else (0.0, 1.0)
            vis = np.where(depth > 0,
                           255 - (depth - lo) / max(hi - lo, 1e-9) * 223, 0)
            imio.write_image(out, vis.astype(np.uint8))
        n += 1
    log.info("mesh rendered into %d depth maps (%s)", n, base_name)
    return n


def _dmap_fusion_loader(scene: Scene, folder: str, meta_list):
    """ViewProvider loader reading final per-view .dmap files."""
    meta = {rid: (image_idx, nbr_ids) for rid, image_idx, nbr_ids in meta_list}

    def load(vid):
        path = os.path.join(folder, f"depth{vid:04d}.dmap")
        if vid not in meta or not os.path.exists(path):
            return None
        dd = dmapio.load(path)
        image_idx, nbr_ids = meta[vid]
        color = scene.images[image_idx].color
        if color is not None and color.shape[:2] != dd.depth.shape:
            color = imio.resize_area(color, dd.depth.shape[1], dd.depth.shape[0])
        return fusion.ViewDepthData(
            image_idx=image_idx, image_id=vid, camera=Camera(dd.K, dd.R, dd.C),
            depth=dd.depth, normal=dd.normal, conf=dd.conf, color=color,
            neighbor_ids=nbr_ids)

    return load
