"""Sharded cross-view depth-map filtering, in torch.

Counterpart of ``openmvs_tpu/parallel/sharded_filter.py``: the pass-3
cross-view filter of ``densify.dense_reconstruction`` (the bAdjust branch
of FilterDepthMap, reference SceneDensify.cpp:1050-1217) on the (views,
tile) ``ShardMesh``. Every reference view gets each neighbour's depth map
splatted into its frame (z-buffered onto the 4 texels around each
projection, SceneDensify.cpp:1066-1135), then a confidence-weighted
agree/disagree reduction (Merrell'07 style).

- ``views`` axis: each row of shards owns a share of the reference views
  (their z-buffers and the final adjust reduction).
- ``tile`` axis: SOURCE depth-map rows are split; each shard splats its
  row block of every source view into full-size partial z-buffers, which
  combine with one ``pmin`` over the row (depth) and one ``pmax`` (the
  winners' confidence).

The neighbour maps are exchanged with ONE ``all_gather`` over the views
axis per call; the rest is local math and the two tile reductions. The
scatters are ``scatter_reduce_`` with ``amin``/``amax``, which do not
depend on the order of the writes. The math is float32 (the host filter
projects in float64), so a pixel whose projection rounds across a texel
boundary or whose agree test sits at the threshold may differ from the
host filter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.parallel.mesh import ShardMesh, all_gather, pmax, pmin, to
from openmvs_tpu_torch.utils.fmath import fma


def _splat_zbuf(d, px, py, z, ok, h_r: int, w_r: int, Wmax: int, HW: int):
    """Partial z-buffer (HW + 1,) and the splat records of the confidence
    pass. Each source depth writes its reference-frame depth onto the 4
    texels around its projection; the nearest z wins (as
    ``filters.project_depth_to_view``). Index HW is the sink of the
    splats that miss. Returns (zbuf, [(lin, zval), ...])."""
    # clamped in float before the conversion: a projection far outside the
    # frame is never inside, and its integer must not overflow
    fx = torch.clamp(torch.floor(px), -2.0, float(w_r) + 1).to(torch.int64)
    fy = torch.clamp(torch.floor(py), -2.0, float(h_r) + 1).to(torch.int64)
    zbuf = torch.full((HW + 1,), math.inf, dtype=torch.float32, device=d.device)
    recs = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ax = fx + dx
        ay = fy + dy
        ok4 = ok & (ax >= 0) & (ax < w_r) & (ay >= 0) & (ay < h_r)
        lin = torch.where(ok4, ay * Wmax + ax, HW).reshape(-1)
        zv = torch.where(ok4, z, math.inf).reshape(-1)
        zbuf.scatter_reduce_(0, lin, zv, "amin", include_self=True)
        recs.append((lin, zv))
    return zbuf, recs


def _adjust_local(depth, conf, projs_d, projs_c, d_min, d_max, nb_present: int,
                  opts: DenseOptions):
    """Elementwise Merrell-style adjust (``filters.filter_depth_adjust`` in
    float32)."""
    th = float(np.float32(opts.depth_diff_threshold * 1.2))
    valid = depth > 0
    pos_conf = torch.where(valid, conf, 0.0)
    avg_depth = None
    neg_conf = torch.zeros_like(pos_conf)
    n_pos = torch.zeros(depth.shape, dtype=torch.int32, device=depth.device)
    n_seen = torch.zeros_like(n_pos)
    for d_proj, c_proj in zip(projs_d, projs_c):
        has = d_proj > 0
        agree = has & (torch.abs(depth - d_proj) < th * depth)
        n_seen = n_seen + has.to(torch.int32)
        term = torch.where(agree, d_proj * c_proj, 0.0)
        # XLA fuses the initial depth * conf into the first sum
        avg_depth = fma(depth, pos_conf, term) if avg_depth is None else avg_depth + term
        pos_conf = pos_conf + torch.where(agree, c_proj, 0.0)
        n_pos = n_pos + agree.to(torch.int32)
        neg_conf = neg_conf + torch.where(has & ~agree, c_proj, 0.0)
    if avg_depth is None:
        avg_depth = depth * pos_conf
    avg = avg_depth / torch.clamp(pos_conf, min=1e-12)
    keep = (valid & (n_seen >= opts.min_views_filter)
            & (n_pos >= opts.min_views_filter_adjust) & (pos_conf > neg_conf)
            & (avg >= d_min) & (avg <= d_max))
    new_d = torch.where(keep, avg, 0.0)
    new_c = torch.where(keep, pos_conf - neg_conf, 0.0)
    # a view with too few neighbour maps passes through unchanged
    # (densify pass 3: len(projected) < min_views_filter)
    if nb_present < opts.min_views_filter:
        return depth, conf
    return new_d, new_c


def _project(d, yy, xx, a, b):
    """The reference-frame point b + d (A (x, y, 1)) of each source pixel,
    with the multiply-adds XLA's CPU code fuses: the first product of the
    row sum and the outer scale-and-shift."""
    a = [[float(v) for v in row] for row in a]
    return [fma(d, fma(a[r][0], xx, a[r][1] * yy) + a[r][2], float(b[r])) for r in range(3)]


def filter_views_sharded(results: Dict[int, "DepthMapResult"], opts: DenseOptions,
                         mesh: ShardMesh, skip_ids=()) -> Dict[int, "DepthMapResult"]:
    """Cross-view adjust filter of ALL depth maps over the shard mesh.

    ``results``: {image_id: DepthMapResult} as estimation produces them.
    Returns a new dict with filtered depth/conf (adjust mode; the strict
    mode stays on the host path). Views in ``skip_ids`` pass through
    untouched (resume) but still serve as projection SOURCES, as in the
    host pass-3 loop."""
    ids = sorted(results)
    if all(rid in skip_ids for rid in ids):
        return dict(results)
    n_views_axis, n_tile = mesh.shape
    V = len(ids)
    Vloc = -(-V // n_views_axis)
    Vpad = Vloc * n_views_axis
    idx_of = {rid: i for i, rid in enumerate(ids)}

    Hmax = max(results[rid].depth.shape[0] for rid in ids)
    Wmax = max(results[rid].depth.shape[1] for rid in ids)
    Hpad = -(-Hmax // n_tile) * n_tile
    hloc = Hpad // n_tile
    HW = Hpad * Wmax

    depth_s = np.zeros((Vpad, Hpad, Wmax), np.float32)
    conf_s = np.zeros((Vpad, Hpad, Wmax), np.float32)
    sizes = np.zeros((Vpad, 2), np.int64)
    nbrs: List[List[tuple]] = []      # per view: (source index, A, B)
    for i, rid in enumerate(ids):
        r = results[rid]
        h, w = r.depth.shape
        depth_s[i, :h, :w] = r.depth
        conf_s[i, :h, :w] = (r.conf if r.conf is not None
                             else (r.depth > 0).astype(np.float32))
        sizes[i] = (h, w)
        KRr = r.camera.K @ r.camera.R            # float64 on the host
        row = []
        for nb_id in r.neighbor_ids:
            j = idx_of.get(nb_id)
            if j is None:
                continue
            cj = results[nb_id].camera
            row.append((j, (KRr @ cj.R.T @ cj.Kinv).astype(np.float32),
                        (KRr @ (cj.C - r.camera.C)).astype(np.float32)))
        nbrs.append(row)

    # shard (a, t) holds rows t of views a*Vloc..; one all_gather over the
    # views axis gives every shard all views' row block t
    blocks_d = [[torch.from_numpy(depth_s[a * Vloc:(a + 1) * Vloc, t * hloc:(t + 1) * hloc].copy())
                 .to(mesh.devices[a][t]) for t in range(n_tile)] for a in range(n_views_axis)]
    blocks_c = [[torch.from_numpy(conf_s[a * Vloc:(a + 1) * Vloc, t * hloc:(t + 1) * hloc].copy())
                 .to(mesh.devices[a][t]) for t in range(n_tile)] for a in range(n_views_axis)]
    src_d = [[all_gather([blocks_d[b][t] for b in range(n_views_axis)], 0, mesh.devices[a][t])
              for t in range(n_tile)] for a in range(n_views_axis)]
    src_c = [[all_gather([blocks_c[b][t] for b in range(n_views_axis)], 0, mesh.devices[a][t])
              for t in range(n_tile)] for a in range(n_views_axis)]

    out_d = np.zeros_like(depth_s)
    out_c = np.zeros_like(conf_s)
    for a in range(n_views_axis):
        views = [i for i in range(a * Vloc, min((a + 1) * Vloc, V))]
        pairs = [(i, j, A, B) for i in views for j, A, B in nbrs[i]]
        zbufs, recs = [], []
        for t in range(n_tile):
            dev = mesh.devices[a][t]
            yy = (torch.arange(hloc, dtype=torch.float32, device=dev)[:, None]
                  + float(t * hloc)).expand(hloc, Wmax)
            xx = torch.arange(Wmax, dtype=torch.float32, device=dev)[None, :].expand(hloc, Wmax)
            zb_t, rec_t = [], []
            for i, j, A, B in pairs:
                h_r, w_r = (int(v) for v in sizes[i])
                d = src_d[a][t][j]
                ok = (d > 0) & (yy < float(sizes[j, 0])) & (xx < float(sizes[j, 1]))
                p0, p1, p2 = _project(d, yy, xx, A, B)
                front = ok & (p2 > 0)
                zsafe = torch.where(front, p2, 1.0)
                zb, rec = _splat_zbuf(d, p0 / zsafe, p1 / zsafe, p2, front, h_r, w_r,
                                      Wmax, HW)
                zb_t.append(zb)
                rec_t.append((rec, src_c[a][t][j].reshape(-1)))
            zbufs.append(zb_t)
            recs.append(rec_t)
        if not pairs:
            zb_g = cb_g = []
        else:
            # global z-buffers: pmin over the tile axis, on every tile's device
            zb_g = pmin([torch.stack(z) for z in zbufs], mesh.devices[a][0])
            cbs = []
            for t in range(n_tile):
                zb_here = to(zb_g, mesh.devices[a][t])
                cb = torch.zeros_like(zb_here)
                for k, (rec, c) in enumerate(recs[t]):
                    for lin, zv in rec:
                        win = zb_here[k][lin] == zv
                        cb[k].scatter_reduce_(0, lin, torch.where(win, c, 0.0), "amax",
                                              include_self=True)
                cbs.append(cb)
            cb_g = pmax(cbs, mesh.devices[a][0])
        # the adjust reduction on each (view, row block) shard
        k = 0
        for i in views:
            n_nb = len(nbrs[i])
            zk = zb_g[k:k + n_nb] if n_nb else None
            ck = cb_g[k:k + n_nb] if n_nb else None
            k += n_nb
            for t in range(n_tile):
                dev = mesh.devices[a][t]
                lo = t * hloc
                projs_d, projs_c = [], []
                for s in range(n_nb):
                    zmap = to(zk[s][:HW], dev).reshape(Hpad, Wmax)[lo:lo + hloc]
                    projs_d.append(torch.where(torch.isfinite(zmap), zmap, 0.0))
                    projs_c.append(to(ck[s][:HW], dev).reshape(Hpad, Wmax)[lo:lo + hloc])
                r = results[ids[i]]
                nd, nc = _adjust_local(blocks_d[a][t][i - a * Vloc], blocks_c[a][t][i - a * Vloc],
                                       projs_d, projs_c, float(np.float32(r.d_min)),
                                       float(np.float32(r.d_max)), n_nb, opts)
                out_d[i, lo:lo + hloc] = nd.cpu().numpy()
                out_c[i, lo:lo + hloc] = nc.cpu().numpy()

    out = dict(results)
    for i, rid in enumerate(ids):
        if rid in skip_ids:
            continue
        r = results[rid]
        h, w = r.depth.shape
        out[rid] = dataclasses.replace(r, depth=out_d[i, :h, :w].copy(),
                                       conf=out_c[i, :h, :w].copy())
    return out
