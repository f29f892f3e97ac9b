"""Sharded dense estimation, SGM pairs and fusion reduction, in torch.

Counterpart of ``openmvs_tpu/parallel/sharded.py``. Depth-map work is laid
out on a (views, tile) ``ShardMesh`` (``parallel/mesh.py``):

- ``views`` axis: each row of shards owns a share of the reference views;
  neighbour images are replicated, so estimation needs no communication.
- ``tile`` axis: image rows are split over the shards of a row. Each
  shard's PatchMatch state keeps HALO rows of the adjacent tiles, refreshed
  after every checkerboard half-step (``halo_exchange``), so a tile
  boundary behaves as the interior of a one-device sweep.

Candidate randomness is position-anchored (``utils/rng.block_uniform``
hashes the global pixel coordinates of ``data.uv``) and the checkerboard
parity comes from ``uv`` too, so a sharded result equals the serial one
(``Switches.old_rng`` draws by shape, and then they differ, as in the JAX
package). Views are set up and scheduled as on the serial path
(``densify.setup_view``, ``patchmatch.schedule``). Each shard's block
reaches the scorer kernels K1-mv and K2-mv through ``patchmatch._sweep_parity``.

One process drives every shard; the collectives are the explicit tensor
operations of ``parallel/mesh.py``. A padded reference slot of the views
axis (views not a multiple of its size) holds no view and runs nothing,
where SPMD runs it on zeros and discards it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.ops import patchmatch
from openmvs_tpu_torch.parallel.mesh import ShardMesh, chunks, ppermute, psum, to
from openmvs_tpu_torch.utils import rng

# halo must cover the propagation radius (5) plus the patch half-window (4)
HALO = 16

# PMData fields whose leading (per-view) layout is image rows and therefore
# get row-tiled over the ``tile`` mesh axis
ROW_TILED = {"ref", "X0", "sum_w", "norm_sq0", "lowres", "valid", "uv"}
ROW_TILED_T = {"w", "wtm"}  # (T, rows, W): rows on axis 1


def make_mesh(n_devices: int, n_views_axis: Optional[int] = None,
              devices: Optional[Sequence] = None) -> ShardMesh:
    """A (n_views_axis, n_devices // n_views_axis) mesh of the first
    ``n_devices`` of ``devices``; by default the cards present, round-robin
    (``make_mesh(4)`` on one card is (2, 2) on ``cuda:0``). Raises when a
    named card is absent."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i % n}" if n else "cuda" for i in range(n_devices)]
    devs = list(devices)[:n_devices]
    if len(devs) < n_devices:
        raise ValueError(f"{n_devices} shards asked, {len(devs)} devices given")
    if n_views_axis is None:
        n_views_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    if n_devices % n_views_axis:
        raise ValueError(f"{n_devices} shards do not divide into {n_views_axis} rows")
    n_tile = n_devices // n_views_axis
    return ShardMesh([devs[a * n_tile:(a + 1) * n_tile] for a in range(n_views_axis)])


# ------------------------------------------------------------------ halos


def _refresh(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """One field's stale HALO rows refreshed from the adjacent tiles' core
    edge rows (blocks laid out [halo_top | core | halo_bot])."""
    n = len(xs)
    if n == 1:
        return xs
    core_top = [x[HALO:2 * HALO] for x in xs]
    core_bot = [x[x.shape[0] - 2 * HALO:x.shape[0] - HALO] for x in xs]
    # tile i's top halo is tile (i-1)'s core bottom: send core_bot down
    # (i -> i+1); its bottom halo is tile (i+1)'s core top: send core_top up.
    # Un-permuted edges receive zeros, the image-border behaviour.
    from_above = ppermute(core_bot, [(i, i + 1) for i in range(n - 1)])
    from_below = ppermute(core_top, [(i, i - 1) for i in range(1, n)])
    return [torch.cat([a, x[HALO:x.shape[0] - HALO], b])
            for a, x, b in zip(from_above, xs, from_below)]


def halo_exchange(states: List[patchmatch.PMState]) -> List[patchmatch.PMState]:
    """Refresh the stale HALO rows of each tile's extended state block (one
    list entry per tile of a view); only the core is authoritative after a
    sweep."""
    fields = [_refresh([getattr(st, f) for st in states]) for f in patchmatch.PMState._fields]
    return [patchmatch.PMState(*parts) for parts in zip(*fields)]


def _extend_rows(xs: List[torch.Tensor], rows_axis: int = 0) -> List[torch.Tensor]:
    """Each tile's core block with HALO rows of the adjacent tiles
    concatenated on ``rows_axis`` (zeros at the image top and bottom, where
    ppermute has no source)."""
    n = len(xs)
    if n == 1:
        x = xs[0]
        pad = x.new_zeros(x.shape[:rows_axis] + (HALO,) + x.shape[rows_axis + 1:])
        return [torch.cat([pad, x, pad], dim=rows_axis)]
    bot = [x.narrow(rows_axis, x.shape[rows_axis] - HALO, HALO) for x in xs]
    top = [x.narrow(rows_axis, 0, HALO) for x in xs]
    from_above = ppermute(bot, [(i, i + 1) for i in range(n - 1)])
    from_below = ppermute(top, [(i, i - 1) for i in range(1, n)])
    return [torch.cat([a, x, b], dim=rows_axis).contiguous()
            for a, x, b in zip(from_above, xs, from_below)]


def _extend_pm_data(ds: List[patchmatch.PMData]) -> List[patchmatch.PMData]:
    fields = {}
    for name in patchmatch.PMData._fields:
        xs = [getattr(d, name) for d in ds]
        if name in ROW_TILED:
            fields[name] = _extend_rows(xs, 0)
        elif name in ROW_TILED_T:
            fields[name] = _extend_rows(xs, 1)
        else:
            fields[name] = xs
    return [patchmatch.PMData(**{k: v[t] for k, v in fields.items()})
            for t in range(len(ds))]


def _core(x: torch.Tensor, rows_axis: int = 0) -> torch.Tensor:
    return x.narrow(rows_axis, HALO, x.shape[rows_axis] - 2 * HALO)


def _split_rows(x: torch.Tensor, devices: Sequence[torch.device],
                rows_axis: int = 0) -> List[torch.Tensor]:
    """A full tensor as its row blocks, block t on devices[t] (the
    ``P("tile")`` sharding; rows divide evenly)."""
    core = x.shape[rows_axis] // len(devices)
    return [to(x.narrow(rows_axis, t * core, core).contiguous(), d)
            for t, d in enumerate(devices)]


def _shard_pm_data(d: patchmatch.PMData, devices) -> List[patchmatch.PMData]:
    """A view's full-canvas PMData as its tiles' core blocks, the rest of
    the fields replicated on each tile's device."""
    fields = {}
    for name in patchmatch.PMData._fields:
        x = getattr(d, name)
        if name in ROW_TILED:
            fields[name] = _split_rows(x, devices, 0)
        elif name in ROW_TILED_T:
            fields[name] = _split_rows(x, devices, 1)
        elif name == "views":
            fields[name] = [patchmatch.PMViews(*(to(v, dev) for v in x)) for dev in devices]
        else:
            fields[name] = [to(x, dev) for dev in devices]
    return [patchmatch.PMData(**{k: v[t] for k, v in fields.items()})
            for t in range(len(devices))]


def _gather_rows(xs: List[torch.Tensor], device) -> torch.Tensor:
    """The tiles' core blocks of one field as one full tensor on ``device``."""
    return torch.cat([to(x, device) for x in xs])


# ---------------------------------------------------------- level step


def make_level_step(opts: DenseOptions, n_views: int, plan: patchmatch.Schedule,
                    use_geom: bool, switches: patchmatch.Switches):
    """The (views, tile)-sharded estimation of one pyramid level: the steps
    of ``plan``, which has no adaptive block and skips no band.

    Returns step(datas, sds, sns, keys): for each view its tiles' core
    PMData blocks, seed depth and normal blocks (each on its tile's
    device) and its key, to each view's tiles' core PMState blocks. Every
    view advances one half-step at a time, then its halos are exchanged,
    so shards on several cards overlap."""
    def step(datas, sds, sns, keys):
        exts = [_extend_pm_data(ds) for ds in datas]
        sts = []
        for ds, sd, sn, key in zip(exts, sds, sns, keys):
            sd_e, sn_e = _extend_rows(sd), _extend_rows(sn)
            sts.append(halo_exchange([
                patchmatch.init_state(d, opts, key, a, b, n_views, use_geom,
                                      mode=plan.init_mode, switches=switches)
                for d, a, b in zip(ds, sd_e, sn_e)]))
        for sweep in plan.sweeps:
            iks = [rng.fold_in(key, sweep.fold) for key in keys]
            if sweep.rescore:
                sts = [[patchmatch._rescored(st, d, opts, n_views, use_geom, sweep.mode,
                                             switches=switches)
                        for st, d in zip(vst, ds)] for vst, ds in zip(sts, exts)]
            for parity in (0, 1):
                sts = [halo_exchange([
                    patchmatch._sweep_parity(st, d, opts, ik, n_views, use_geom,
                                             plan.n_perturb, sweep.mode, parity, 8,
                                             switches=switches)
                    for st, d in zip(vst, ds)]) for vst, ds, ik in zip(sts, exts, iks)]
        return [[patchmatch.PMState(*(_core(x) for x in st)) for st in vst] for vst in sts]

    return step


def estimate_views_sharded(scene, opts: DenseOptions, mesh: ShardMesh,
                           prev_results=None, geometric_iter: int = -1,
                           rng_seed: int = 0, skip_ids=(),
                           switches: Optional[patchmatch.Switches] = None,
                           levels=None) -> Dict[int, object]:
    """Sharded equivalent of densify.estimate_depth_map over ALL views.

    Returns {image_id: DepthMapResult}, equal to the serial path's results
    run without the adaptive early exit. ``switches`` are read from the
    environment where not given. The level images and neighbour maps come
    from ``levels`` (a ``densify.LevelStore``; one of this call's own where
    not given), which keeps each map on its row's first device where a
    geometric pass follows."""
    from openmvs_tpu_torch import densify as D
    from openmvs_tpu_torch.io import images as imio

    if levels is None:
        with D.LevelStore() as own:
            return estimate_views_sharded(scene, opts, mesh, prev_results, geometric_iter,
                                          rng_seed, skip_ids, switches, own)
    switches = switches or patchmatch.Switches.from_env()
    n_views_axis, n_tile = mesh.shape
    is_geometric = geometric_iter >= 0

    # ---- host prep per view, the serial path's (a geometric pass only
    # re-estimates the views of ``prev_results``) ----
    views_info = []     # (ref_idx, densify.ViewSetup)
    for ref_idx in range(scene.n_views):
        rid = scene.images[ref_idx].meta.id
        prev = (prev_results or {}).get(rid) if is_geometric else None
        if rid in skip_ids or (is_geometric and prev is None):
            continue
        view = D.setup_view(scene, ref_idx, opts, prev, is_geometric)
        if view is not None:
            views_info.append((ref_idx, view))
    if not views_info:
        return {}

    V = max(len(view.nbr_ids) for _, view in views_info)
    Vv = len(views_info)
    Vloc = -(-Vv // n_views_axis)
    rows = [mesh.devices[k // Vloc] for k in range(Vv)]   # each view's tiles
    # the serial path's schedule with every search sweep run and no band
    # skipped, as the JAX package's sharded step runs it
    plan = patchmatch.schedule(
        opts, dataclasses.replace(switches, early_exit=False, active=0.0), is_geometric)
    step = make_level_step(opts, V, plan, is_geometric, switches)

    full_states = None       # per view: full-canvas (depth, normal) of a level
    prev_shapes = None       # per view: the previous level's logical shape
    datas_full = None
    for level in range(plan.levels, -1, -1):
        s = 1.0 / (2 ** level)
        lvls = [view.level(s, levels, rows[k][0], prev_results if is_geometric else None)
                for k, (_, view) in enumerate(views_info)]
        h_log = max(lv[0].shape[0] for lv in lvls)
        w_log = max(lv[0].shape[1] for lv in lvls)
        # pad rows so the tile axis divides them into 8-aligned cores of at
        # least the HALO rows an exchange slices
        Hl_ = -(-h_log // (n_tile * 8)) * (n_tile * 8)
        Hl_ = max(Hl_, n_tile * HALO)
        Wl_ = -(-w_log // 2) * 2
        Hp = max(g.shape[0] for lv in lvls for g in lv[2])
        Wp = max(g.shape[1] for lv in lvls for g in lv[2])

        datas_full, datas, sds, sns, keys = [], [], [], [], []
        for k, (ref_idx, view) in enumerate(views_info):
            dev0 = rows[k][0]
            gray, ref_cam, nbr_grays, nbr_cams, nbr_depths = lvls[k]
            h, w = gray.shape
            ref_gray = F.pad(gray, (0, Wl_ - w, 0, Hl_ - h))
            # usable: the serial mask resized at the logical size, False in
            # the bottom/right padding, and clamped to the serial window-inside
            # region (the padded canvas would shift that test)
            um = np.zeros((Hl_, Wl_), bool)
            um_src = view.image.usable_mask(opts.ignore_mask_label)
            b_ = opts.window_half
            if um_src is not None:
                if um_src.shape != (h, w):
                    um_src = imio.resize_nearest(um_src, w, h)
                um[:h, :w] = um_src
            else:
                um[:h, :w] = True
            um[max(h - b_, 0):, :] = False
            um[:, max(w - b_, 0):] = False
            if full_states is None:
                # level seeds from the sparse cloud (or the previous pass)
                sd, sn = (torch.from_numpy(a).to(dev0) for a in view.seeds(s, (Hl_, Wl_)))
                lowres = None
            else:
                # the previous level's state upsampled over each view's own
                # logical box (jax.image.resize's linear and nearest), padded
                dep, nrm = full_states[k].depth, full_states[k].normal
                ph, pw = prev_shapes[k]
                sd = dep.new_zeros((Hl_, Wl_))
                sn = nrm.new_zeros((Hl_, Wl_, 3))
                sd[:h, :w] = D._resize_linear(dep[:ph, :pw], h, w)
                sn[:h, :w] = D._resize_nearest(nrm[:ph, :pw], h, w)
                lowres = sd
            data = D._build_pm_data(ref_gray, ref_cam, nbr_grays, nbr_cams, opts,
                                    view.d_min, view.d_max, lowres, nbr_depths, usable=um,
                                    device=dev0, pad_views=V, pad_hw=(Hp, Wp))
            datas_full.append(data)
            datas.append(_shard_pm_data(data, rows[k]))
            sds.append(_split_rows(sd, rows[k]))
            sns.append(_split_rows(sn, rows[k]))
            keys.append(rng.prng_key(rng_seed * 7919 + ref_idx * 131 + level
                                     + 1000 * (geometric_iter + 1)))
        cores = step(datas, sds, sns, keys)
        full_states = [
            patchmatch.PMState(*(_gather_rows([getattr(st, f) for st in vst], rows[k][0])
                                 for f in patchmatch.PMState._fields))
            for k, vst in enumerate(cores)]
        prev_shapes = [lv[0].shape for lv in lvls]

    geometric_follows = (not is_geometric) and opts.estimation_geometric_iters > 0
    packed = [patchmatch.pack_state(patchmatch.finalize(st, d, opts, geometric_follows))
              for st, d in zip(full_states, datas_full)]
    keep = geometric_iter + 1 < opts.estimation_geometric_iters
    results = {}
    for k, (ref_idx, view) in enumerate(views_info):
        Hf, Wf = view.image.gray.shape
        pk = packed[k].cpu().numpy()[:Hf, :Wf]
        r = results[view.image.meta.id] = D.DepthMapResult(
            image_idx=ref_idx,
            depth=np.array(pk[..., 0], np.float32, copy=True, order="C"),
            normal=np.array(pk[..., 1:4], np.float32, copy=True, order="C"),
            conf=np.array(pk[..., 4], np.float32, copy=True, order="C"),
            d_min=view.d_min, d_max=view.d_max, neighbor_ids=view.nbr_ids,
            camera=view.camera)   # the final level is the full working resolution
        if keep:
            levels.keep(r, packed[k][:Hf, :Wf, 0].contiguous(), rows[k][0])
    return results


# ------------------------------------------------------------ dry runs


def _make_stacked_problem(n_views_total: int, h: int, w: int, v: int,
                          opts: DenseOptions, device="cpu") -> patchmatch.PMData:
    """A synthetic multi-view PMData stacked on a leading views axis."""
    from openmvs_tpu_torch.densify import _build_pm_data
    from openmvs_tpu_torch.geometry.camera import Camera

    gen = np.random.default_rng(0)
    f = 0.9 * w
    K = np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1.0]])
    datas = []
    for i in range(n_views_total):
        ref_cam = Camera(K, np.eye(3), np.array([0.1 * i, 0, 0]))
        nbr_cams = [Camera(K, np.eye(3), np.array([0.1 * i + 0.3 * (j + 1), 0, 0.0]))
                    for j in range(v)]
        ref = gen.uniform(0, 1, (h, w)).astype(np.float32)
        nbrs = [gen.uniform(0, 1, (h, w)).astype(np.float32) for _ in range(v)]
        datas.append(_build_pm_data(ref, ref_cam, nbrs, nbr_cams, opts, 2.0, 10.0,
                                    None, None, device=device))
    views = patchmatch.PMViews(*(torch.stack(xs) for xs in zip(*(d.views for d in datas))))
    return patchmatch.PMData(**{
        name: views if name == "views" else torch.stack([getattr(d, name) for d in datas])
        for name in patchmatch.PMData._fields})


def _tile_rows(x: torch.Tensor, n_tile: int, core_rows: int, rows_axis: int) -> torch.Tensor:
    """(views, ..., H, ...) -> (views, n_tile, ..., core + 2*HALO, ...)
    blocks, each with its halos read from the full array (zeros past it)."""
    pad = list(x.shape)
    pad[rows_axis] = HALO
    z = x.new_zeros(pad)
    xp = torch.cat([z, x, z], dim=rows_axis)
    return torch.stack([xp.narrow(rows_axis, t * core_rows, core_rows + 2 * HALO)
                        for t in range(n_tile)], dim=1)


def _index_local_view(data: patchmatch.PMData, i: int, t: int,
                      device) -> patchmatch.PMData:
    """View i's PMData, tile t of its row-tiled fields, on ``device``."""
    fields = {}
    for name, x in data._asdict().items():
        if name == "views":
            fields[name] = patchmatch.PMViews(*(to(y[i], device) for y in x))
        elif name in ROW_TILED or name in ROW_TILED_T:
            fields[name] = to(x[i, t].contiguous(), device)
        else:
            fields[name] = to(x[i], device)
    return patchmatch.PMData(**fields)


def dryrun(n_devices: int, devices: Optional[Sequence] = None) -> int:
    """One sharded estimation step (init, one sweep, halo exchange) of two
    synthetic reference views per row of ``make_mesh(n_devices, devices=)``;
    prints and returns the psum of the valid depths of the cores."""
    mesh = make_mesh(n_devices, devices=devices)
    n_views_axis, n_tile = mesh.shape
    opts = DenseOptions(sub_resolution_levels=0, estimation_iters=1)
    total_views = n_views_axis * 2
    core_rows, w, v = 32, 128, 2
    h = n_tile * core_rows
    data = _make_stacked_problem(total_views, h, w, v, opts)
    tiled = {}
    for name, x in data._asdict().items():
        if name in ROW_TILED:
            tiled[name] = _tile_rows(x, n_tile, core_rows, rows_axis=1)
        elif name in ROW_TILED_T:
            tiled[name] = _tile_rows(x, n_tile, core_rows, rows_axis=2)
        else:
            tiled[name] = x
    data = patchmatch.PMData(**tiled)
    ext = core_rows + 2 * HALO
    n_valid = []
    for k in range(total_views):
        devs = mesh.devices[k // 2]
        key = rng.fold_in(rng.prng_key(0), k)
        sts = []
        for t, dev in enumerate(devs):
            d = _index_local_view(data, k, t, dev)
            seed_d = torch.full((ext, w), 5.0, device=dev)
            seed_n = torch.tensor([0, 0, -1.0], device=dev).expand(ext, w, 3)
            st = patchmatch.init_state(d, opts, key, seed_d, seed_n, v, False)
            sts.append(patchmatch.sweep(st, d, opts, key, v, False))
        for st in halo_exchange(sts):
            n_valid.append(torch.sum(_core(st.depth) > 0))
    total = int(psum(n_valid))
    print(f"dryrun OK: mesh={mesh.shape} (views x tile), {total_views} views of "
          f"{h}x{w}, valid depths={total}", flush=True)
    return total


def dryrun_refine(devices: Sequence) -> float:
    """One refinement iteration with the pair axis sharded over
    ``devices`` (one pair per device); prints and returns the energy."""
    from openmvs_tpu_torch.parallel.mesh import resolve_device
    from openmvs_tpu_torch.refine import PairData, _device_iter, shard_pairs

    devs = [resolve_device(d) for d in devices]
    gen = np.random.default_rng(0)
    nv, Hh, Ww, npair = 50, 24, 32, len(devs)
    f32 = np.float32
    K = np.array([[40, 0, Ww / 2], [0, 40, Hh / 2], [0, 0, 1]], f32)
    faces_np = gen.integers(0, nv, (40, 3))
    verts = torch.from_numpy(gen.normal(size=(nv, 3)).astype(f32) + f32(5.0) * np.array(
        [0, 0, 1], f32)).to(devs[0])
    fid = gen.integers(0, len(faces_np), (npair, Hh, Ww)).astype(np.int32)
    pds = PairData(
        imgA=gen.uniform(0, 1, (npair, Hh, Ww)).astype(f32),
        imgB=gen.uniform(0, 1, (npair, Hh, Ww)).astype(f32),
        face_vid=faces_np[fid], bary=np.full((npair, Hh, Ww, 3), 1 / 3, f32),
        mask=np.ones((npair, Hh, Ww), bool), KA_R=np.tile(K, (npair, 1, 1)),
        KA_t=np.zeros((npair, 3), f32), KB_R=np.tile(K, (npair, 1, 1)),
        KB_t=np.zeros((npair, 3), f32), sizeB=np.tile(np.array([Hh, Ww], f32), (npair, 1)),
        CA=np.zeros((npair, 3), f32), reg_scale=np.ones(npair, f32), fid=fid)
    faces = torch.from_numpy(faces_np).to(devs[0])
    adj = torch.full((nv, 12), -1, dtype=torch.int64, device=devs[0])
    deg = torch.zeros(nv, device=devs[0])
    scalars = [torch.tensor(x, device=devs[0]) for x in (0.5, 0.1, 0.2)]
    shards = shard_pairs(pds, faces, devs)
    _, e = _device_iter(verts, 0, shards, adj, deg, faces, *scalars)
    e = float(e)
    print(f"dryrun refine OK: {npair} pairs sharded over {len(devs)} devices, "
          f"E={e:.4f}", flush=True)
    return e


# ----------------------------------------------------------------- SGM pairs


def sgm_pairs_sharded(lefts: np.ndarray, rights_shifted: np.ndarray, d_min: int,
                      num_d: int, devices: Sequence, p1: float = 3.0, p2: float = 4.0,
                      alpha: float = 14.0, num_dirs: int = 8,
                      beta: float = 38.0 / 255.0):
    """Disparity for a BATCH of rectified pairs with the pairs sharded over
    ``devices`` (each shard a contiguous share of the pairs, the analogue of
    the reference's per-pair EventThreadPool jobs,
    SemiGlobalMatcher.cpp:2042-2060): per shard WZNCC cost volumes, the
    8-direction DP and winner-take-all; pairs are independent, so no shard
    talks to another.

    lefts/rights_shifted: (P, H, W) float32, rights pre-shifted by d_min
    columns and zero filled (``sgm._shift_right``). Returns (disp int32
    (P, H, W) absolute disparities, cost float32 (P, H, W))."""
    from openmvs_tpu_torch.ops import sgm
    from openmvs_tpu_torch.parallel.mesh import resolve_device

    devs = [resolve_device(d) for d in devices]
    P_n = lefts.shape[0]
    outs = []
    for dev, part in zip(devs, chunks(P_n, len(devs))):
        if not len(part):
            continue
        sl = slice(part.start, part.stop)
        left = torch.from_numpy(np.ascontiguousarray(lefts[sl], np.float32)).to(dev)
        right = torch.from_numpy(np.ascontiguousarray(rights_shifted[sl], np.float32)).to(dev)
        # the kernel reads unshifted right images: undo the zero-filled
        # shift (the columns it dropped are the texels read as zeros)
        w, tw, sum_w, norm_sq0 = sgm.wzncc_weights(left)
        d_mins = torch.full((len(part),), d_min, dtype=torch.int32, device=dev)
        vol = sgm.wzncc_volume_masked(w, tw, sum_w, norm_sq0, sgm._shift_right(right, -d_min),
                                      d_mins, num_d)
        agg = sgm.aggregate8(vol, left, p1, p2, alpha, num_dirs, beta)
        idx, mn = sgm._argmin_first(agg)
        outs.append((idx.to(torch.int32) + d_min, mn))
    disp = np.concatenate([d.cpu().numpy() for d, _ in outs])
    cost = np.concatenate([c.cpu().numpy() for _, c in outs]).astype(np.float32)
    return disp, cost


# ------------------------------------------------------------ fusion reduce


def _fusion_view(depth, normal, conf, K, R, C, valid, X, Nw, cosn, ddt, w_floor):
    """One neighbour view's share of the fusion reduction: the candidates'
    agreement with it and their confidence-weighted evidence."""
    Hb, Wb = depth.shape
    Xc = (X - C[None]) @ R.T                           # (N, 3) camera coords
    pb = Xc @ K.T
    zb = pb[:, 2]
    front = zb > 0
    iz = torch.where(front, 1.0 / torch.where(front, zb, 1.0), 0.0)
    ix = torch.round(pb[:, 0] * iz).to(torch.int64)
    iy = torch.round(pb[:, 1] * iz).to(torch.int64)
    inside = front & (ix >= 0) & (ix < Wb) & (iy >= 0) & (iy < Hb)
    ixc = torch.clamp(ix, 0, Wb - 1)
    iyc = torch.clamp(iy, 0, Hb - 1)
    db = depth[iyc, ixc]
    similar = inside & (db > 0) & (torch.abs(zb - db) < ddt * zb)
    Nb = normal[iyc, ixc] @ R                          # world-frame normal
    agree = similar & (torch.sum(Nw * Nb, -1) > cosn) & (valid > 0)
    cb = conf[iyc, ixc]
    w = 1.0 / (torch.clamp(1.0 - cb, min=w_floor) * db * db + 1e-30)
    w = torch.where(agree, w, 0.0)
    # the neighbour's own unprojected point at the sampled pixel (the
    # reference fuses it, not the candidate)
    uv1 = torch.stack([ixc.to(torch.float32), iyc.to(torch.float32), torch.ones_like(db)], -1)
    Kinv = torch.linalg.inv(K)
    Xb = ((uv1 * db[:, None]) @ Kinv.T) @ R + C[None]
    return (torch.where(agree[:, None], Xb * w[:, None], 0.0), w, agree.to(torch.int32))


def fusion_reduce_sharded(X: np.ndarray, Nw: np.ndarray, nb_stack: dict,
                          opts, devices: Sequence):
    """The fusion reduction with the neighbour VIEWS sharded over
    ``devices``: every candidate point projects into each view of its
    shard, the agreement test (depth similarity and normal cone,
    FuseDepthMaps SceneDensify.cpp:1504-1603) accumulates
    confidence-weighted position evidence per shard, and one psum over the
    shards totals it (the greedy claiming stays on the host, as in the
    reference's best-connected-first loop).

    X (N, 3) world candidates, Nw (N, 3) world normals. nb_stack: dict of
    neighbour data stacked on a leading view axis: depth (V, H, W), normal
    (V, H, W, 3), conf (V, H, W), K (V, 3, 3), R (V, 3, 3), C (V, 3), valid
    (V,) 1.0 for real views. Returns (acc_X (N, 3), acc_W (N,), n_agree
    (N,)) summed over views."""
    from openmvs_tpu_torch.parallel.mesh import resolve_device

    devs = [resolve_device(d) for d in devices]
    V = nb_stack["depth"].shape[0]
    cosn = float(np.cos(np.radians(opts.normal_diff_threshold)))
    ddt = float(opts.depth_diff_threshold)
    w_floor = float(getattr(opts, "fuse_conf_weight_floor", 0.09))
    parts = []
    for dev, part in zip(devs, chunks(V, len(devs))):
        if not len(part):
            continue
        st = {k: torch.from_numpy(np.ascontiguousarray(
            np.asarray(v, np.float32)[part.start:part.stop])).to(dev)
            for k, v in nb_stack.items()}
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
        Nd = torch.from_numpy(np.ascontiguousarray(Nw, np.float32)).to(dev)
        accX = accW = nA = None
        for j in range(len(part)):
            ax, aw, na = _fusion_view(*(st[k][j] for k in ("depth", "normal", "conf", "K",
                                                           "R", "C", "valid")),
                                      Xd, Nd, cosn, ddt, w_floor)
            accX = ax if accX is None else accX + ax
            accW = aw if accW is None else accW + aw
            nA = na if nA is None else nA + na
        parts.append((accX, accW, nA))
    dev0 = parts[0][0].device
    return tuple(psum([p[i] for p in parts], dev0).cpu().numpy() for i in range(3))
