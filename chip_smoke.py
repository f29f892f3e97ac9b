#!/usr/bin/env python3
"""Drive the PyTorch port's PatchMatch densify path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device     - fails without CUDA; prints the card's name and power limit
  2. build      - builds the CUDA kernels from csrc/ (one nvcc per source,
                  all started together; sm_90a)
  3. kernels    - K1 (exact, nn), K2, K3 and K1-v2 (exact, nn) at the main
                  path's shapes against their plain PyTorch versions on the
                  card, with timings; K1-v2 also against K1, bit for bit
  4. variants   - K1 against K1-v2 on the dev script's inputs (C=11,
                  480x640, T=25): times, and the share of (candidate, pixel)s
                  whose texels all came from K1-v2's staged window
  5. densify    - the synthetic 5-view 480x640 scene through
                  densify.dense_reconstruction(scene, DenseOptions()) on the
                  card: throughput, point count, kernel launches, and depth
                  accuracy/completeness per view against ground truth, held
                  to 95% of what the JAX package reaches on the same scene
  6. geom_split - the same under OMVS_GEOM_SPLIT=1 (geometric sweeps split
                  into candidates, K3, then K1 and selection): K3 and K2
                  launches, quality, and agreement with phase densify's maps
  7. parity     - the same scene at 120x160 on the card against the port's
                  plain versions on the CPU
  8. geom_unfused - the 120x160 scene on the card under OMVS_GEOM_FUSED=0
                  (K1 + K3 in place of K2) against phase parity's card maps
Each of phases 4-6 and 8 sets the launch counts to 0 just before the path
it drives and reads them just after. Then the {"kernels": [...]} line and,
last, {"ok": true, "device": ...}. Any failure raises and exits non-zero.
Imports nothing of JAX.
"""

import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Per-view (accuracy, completeness) of the JAX package on the same scene,
# 480x640, 5 views, DenseOptions(), CPU, measured with
#   JAX_PLATFORMS=cpu python tests/_torch_jax_quality.py --height 480 --width 640
# (288468 points, 668 s on 4 CPU cores)
JAX_ACCURACY = [0.9904370367939697, 0.9914687213715482, 0.9839826680865127,
                0.9906634129450852, 0.9894338372725767]
JAX_COMPLETENESS = [0.963409963432761, 0.9450504042475226, 0.9660440752877728,
                    0.9466281181192615, 0.9618086060578184]

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations per (candidate, pixel), counted from csrc/pm_common.cuh
# with an fma as two: per texel (warp, bounds, sample, accumulate), per
# pixel (setup, ZNCC epilogue), and the geometric term of K2 and K3
FLOP_TEXEL = {"exact": 50, "nn": 37}
FLOP_PIXEL = 44
FLOP_GEOM = 83
# (launch-counter name, sampling mode, kind): K1, K2 and K1-v2 in the modes
# the kernel sources instantiate, and K3; K2 in "nn" mode is not on the
# main path (geometric passes score exact) and is checked here only
KERNELS = (("score_view_exact", "exact", "k1"),
           ("score_view_nn", "nn", "k1"),
           ("score_view_geom_exact", "exact", "k2"),
           ("score_view_geom_nn", "nn", "k2"),
           ("geom_term", "exact", "k3"),
           ("score_view_v2_exact", "exact", "v2"),
           ("score_view_v2_nn", "nn", "v2"))
MAIN_PATH = ("score_view_exact", "score_view_nn", "score_view_geom_exact")
# the {"kernels": [...]} line: (counter, source, TPU kernel replaced, the
# phase whose run gives the launches)
KERNEL_LINE = (
    ("score_view_exact", "pm_score.cu", "openmvs_tpu/ops/pm_kernel.py:819", "densify"),
    ("score_view_nn", "pm_score.cu", "openmvs_tpu/ops/pm_kernel.py:819", "densify"),
    ("score_view_geom_exact", "pm_score.cu", "openmvs_tpu/ops/pm_kernel.py:979", "densify"),
    ("geom_term", "pm_score.cu", "openmvs_tpu/ops/pm_kernel.py:691", "geom_split"),
    ("score_view_v2_exact", "pm_score_v2.cu", "scripts/dev_kernel_variants.py:282", "variants"),
    ("score_view_v2_nn", "pm_score_v2.cu", "scripts/dev_kernel_variants.py:282", "variants"),
)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps, graph=False):
    """Mean ms of ``fn`` over ``reps`` calls between CUDA events, after one
    warm-up call. ``graph`` replays one call captured in a CUDA graph, so
    the time is the device's alone: a kernel of tens of microseconds
    otherwise waits on its wrapper's host work."""
    import torch

    fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        run = g.replay
        run()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return card


def phase_build():
    from openmvs_tpu_torch.ops import _build

    t0 = time.perf_counter()
    for name in _build.SIGNATURES:
        _build.library(name)
    sources = {}
    for name, info in _build.BUILD_INFO["sources"].items():
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                            info["log"])
        sources[name] = {
            "nvcc_seconds": info["seconds"],
            "registers_per_thread": [int(r) for r in
                                     re.findall(r"Used (\d+) registers", info["log"])],
            "spills": any(int(a) or int(b) for a, b in spills)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "parallel_nvcc_seconds": _build.BUILD_INFO["seconds"],
          "sources": sources})


def _kernel_inputs(C, device, scene, gts):
    """Main-path operands: view 2 of the 480x640 synthetic scene against
    its four neighbours, C candidate planes around the true depth."""
    import numpy as np
    import torch

    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions

    opts = DenseOptions()
    ref = 2
    nbrs = [0, 1, 3, 4]
    cam = scene.images[ref].working_camera()
    data = densify._build_pm_data(
        scene.images[ref].gray, cam, [scene.images[j].gray for j in nbrs],
        [scene.images[j].working_camera() for j in nbrs], opts, 4.5, 7.5,
        None, [gts[j] for j in nbrs], device=device)
    gt = torch.as_tensor(gts[ref], device=device)
    d = torch.where(gt > 0, gt, 6.0)
    rs = np.random.default_rng(0)
    factors = torch.as_tensor(np.linspace(0.97, 1.03, C), dtype=torch.float32,
                              device=device)
    depth = (d[None] * factors[:, None, None]).contiguous()
    tilt = torch.as_tensor(rs.normal(0, 0.15, (C, 1, 1, 2)), dtype=torch.float32,
                           device=device)
    normal = torch.cat([tilt.expand(C, *d.shape, 2),
                        -torch.ones(C, *d.shape, 1, device=device)], -1)
    normal = (normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)).contiguous()
    den = (normal * data.X0[None]).sum(-1) * depth
    inv_nd = torch.where(den.abs() > 1e-12, 1.0 / den, 0.0).contiguous()
    return data, opts, depth, normal, inv_nd


def _bound_geom(C, H, W, dm_px):
    """K3: the raw depth in and the penalty out, X0, uv, the neighbour depth
    map and 26 constants once each; FLOP_GEOM operations per (c, p)."""
    px = H * W
    cp = C * px
    nbytes = 4 * (dm_px + 26 + cp + 3 * px + 2 * px + cp)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = cp * FLOP_GEOM / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bound(C, H, W, T, img_px, dm_px, mode, geom):
    px = H * W
    cp = C * px
    nbytes = 4 * (img_px + cp * 5 + px * 3 + 2 * T * px + 2 * px + cp)
    flops = cp * (T * FLOP_TEXEL[mode] + FLOP_PIXEL)
    if geom:
        nbytes += 4 * (dm_px + 2 * px + cp)
        flops += cp * FLOP_GEOM
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(card, scene, gts):
    import numpy as np
    import torch

    from openmvs_tpu_torch.ops import pm_kernel

    dev = torch.device("cuda")
    rows = {}
    for C in (11, 1):
        data, opts, depth, normal, inv_nd = _kernel_inputs(C, dev, scene, gts)
        v = data.views
        H, W = depth.shape[1:]
        T = data.goff.shape[0]
        th = float(opts.th_robust)
        j = 0
        common = (data.X0, data.goff, data.w, data.wtm, data.sum_w, data.norm_sq0)
        scorer = (v.image[j], v.size[j], v.Hl[j], v.Hm[j], depth, normal, inv_nd,
                  *common)
        # K3 takes raw candidate depths: 5% zeros, the invalid hypotheses
        holes = torch.as_tensor(np.random.default_rng(1).random(depth.shape) < 0.05,
                                device=dev)
        raw = torch.where(holes, 0.0, depth).contiguous()
        geom = (v.depth[j], v.size[j], v.Tl[j], v.Tm[j], v.Tr[j], v.Tn[j], raw,
                data.X0, data.uv)
        for name, mode, kind in KERNELS:
            nearest = mode == "nn"
            if kind == "k2":
                def kern():
                    return pm_kernel.score_view_geom(
                        v.image[j], v.size[j], v.Hl[j], v.Hm[j], v.Tr[j], v.Tn[j],
                        v.depth[j], depth, normal, inv_nd, data.X0, data.uv,
                        *common[1:], th_robust=th, nearest=nearest)

                def plain():
                    s, _ = pm_kernel.score_view_plain(*scorer, th_robust=th,
                                                      nearest=nearest)
                    return s, pm_kernel.geom_term_plain(
                        v.depth[j], v.size[j], v.Hl[j], v.Hm[j], v.Tr[j],
                        v.Tn[j], depth, data.X0, data.uv)
            elif kind == "k3":
                def kern():
                    return (None, pm_kernel.geom_term(*geom))

                def plain():
                    return (None, pm_kernel.geom_term_plain(*geom))
            else:
                fn = pm_kernel.score_view_v2 if kind == "v2" else pm_kernel.score_view

                def kern(fn=fn):
                    return (fn(*scorer, th_robust=th, nearest=nearest),)

                def plain():
                    return (pm_kernel.score_view_plain(*scorer, th_robust=th,
                                                       nearest=nearest)[0],)
            out_k = kern()
            torch.cuda.synchronize()
            out_p = plain()
            torch.cuda.synchronize()
            rec = {"phase": "kernels", "name": name, "C": C, "H": H, "W": W, "T": T}
            good = True
            max_err = 0.0
            if kind != "k3":
                d_s = (out_k[0] - out_p[0]).abs()[depth > 0]
                within = float((d_s < 1e-3).float().mean())
                rec["score_max_abs_err"] = float(d_s.max())
                rec["score_share_within_1e-3"] = within
                good = within >= 0.999 and float(d_s.max()) < 1e-2
                max_err = float(d_s.max())
            if kind in ("k2", "k3"):
                d_c = (out_k[1] - out_p[1]).abs()
                rec["cons_max_abs_err"] = float(d_c.max())
                rec["cons_share_within_1e-3"] = float((d_c < 1e-3).float().mean())
                good = good and rec["cons_share_within_1e-3"] >= 0.995
                max_err = max(max_err, float(d_c.max()))
            if kind == "v2":
                k1 = pm_kernel.score_view(*scorer, th_robust=th, nearest=nearest)
                in_win = torch.empty(depth.shape, dtype=torch.uint8, device=dev)
                pm_kernel.score_view_v2(*scorer, th_robust=th, nearest=nearest,
                                        in_window=in_win)
                rec["equal_to_k1"] = bool(torch.equal(out_k[0], k1))
                rec.update(_window_shares(in_win, scorer, th, nearest))
                good = good and rec["equal_to_k1"]
            rec["ms"] = cuda_ms(kern, 20, graph=True)
            rec["eager_ms"] = cuda_ms(kern, 20)
            rec["plain_ms"] = cuda_ms(plain, 3)
            rec["library_ms"] = None
            rec["library_note"] = (
                "no single PyTorch call computes a forward-backward "
                "reprojection penalty" if kind == "k3" else
                "no single PyTorch call computes a plane-warped bilateral ZNCC")
            if kind == "k3":
                bound, by = _bound_geom(C, H, W, v.depth[j].numel())
            else:
                bound, by = _bound(C, H, W, T, v.image[j].numel(),
                                   v.depth[j].numel(), mode, kind == "k2")
            rec["bound_ms"] = bound
            rec["bound_by"] = by
            rec["card"] = card
            emit(rec)
            if not good:
                raise RuntimeError(f"{name} at C={C} disagrees with its plain "
                                   "version (or K1-v2 with K1)")
            rows[(name, C)] = dict(rec, max_abs_err=max_err)
    return rows


def _window_shares(in_win, scorer, th, nearest):
    """K1-v2's staged-window share over all (candidate, pixel)s, the share
    whose texels all warp inside the view (only those texels bound the
    window), and the window share among those."""
    from openmvs_tpu_torch.ops import pm_kernel

    inb = pm_kernel.score_view_plain(*scorer, th_robust=th, nearest=nearest)[1]
    win = in_win.bool()
    return {"in_window_share": float(win.float().mean()),
            "in_bounds_share": float(inb.float().mean()),
            "in_window_share_of_in_bounds":
                float((win & inb).sum()) / max(float(inb.sum()), 1.0)}


def phase_variants(card):
    """K1 against K1-v2 on the dev script's inputs (the comparison of the
    JAX package's scripts/dev_kernel_variants.py main), timed in turns
    K1, K1-v2, K1-v2, K1."""
    import torch

    from openmvs_tpu_torch.ops import kernel_variants, pm_kernel

    ins = kernel_variants.make_inputs()
    args = kernel_variants.as_args(ins, "cuda")
    C, H, W = ins["depth"].shape
    pm_kernel.reset_launches()
    for mode in ("exact", "nn"):
        nearest = mode == "nn"

        def k1():
            return pm_kernel.score_view(*args, th_robust=1.2, nearest=nearest)

        def v2():
            return pm_kernel.score_view_v2(*args, th_robust=1.2, nearest=nearest)

        in_win = torch.empty((C, H, W), dtype=torch.uint8, device="cuda")
        s2 = pm_kernel.score_view_v2(*args, th_robust=1.2, nearest=nearest,
                                     in_window=in_win)
        s1 = k1()
        torch.cuda.synchronize()
        t = [cuda_ms(k1, 20), cuda_ms(v2, 20), cuda_ms(v2, 20), cuda_ms(k1, 20)]
        rec = {"phase": "variants", "mode": mode, "C": C, "H": H, "W": W,
               "T": ins["goff"].shape[0], "k1_ms": [t[0], t[3]],
               "k1_v2_ms": [t[1], t[2]], "equal": bool(torch.equal(s1, s2)),
               **_window_shares(in_win, args, 1.2, nearest),
               "scored_share": float((s1 < 1.19).float().mean()), "card": card}
        emit(rec)
        if not rec["equal"]:
            raise RuntimeError(f"K1-v2 ({mode}) differs from K1 on the dev inputs")
    torch.cuda.synchronize()
    launches = dict(pm_kernel.LAUNCHES)
    if launches["score_view_v2_exact"] == 0 or launches["score_view_v2_nn"] == 0:
        raise RuntimeError(f"K1-v2 was not launched: {launches}")
    return launches


class _StageLog(logging.Handler):
    def __init__(self):
        super().__init__()
        self.stages = {}

    def emit(self, record):
        m = re.match(r"(.*) \(([0-9.]+)s\)$", record.getMessage())
        if m:
            self.stages[m.group(1)] = float(m.group(2))


def _dmaps(folder, n):
    from openmvs_tpu_torch.io import dmap

    return [dmap.load(os.path.join(folder, f"depth{i:04d}.dmap")).depth
            for i in range(n)]


def _run_densify(scene, device="cuda", env=None):
    """dense_reconstruction(scene, DenseOptions()) on ``device`` with the
    launch counts set to 0 just before and read just after, and ``env``
    set around it only: (cloud, depth maps, wall s, launches, stage s)."""
    import torch

    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.ops import pm_kernel

    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    stage_log = _StageLog()
    logger = logging.getLogger("omvs_torch.densify")
    logger.addHandler(stage_log)
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            pm_kernel.reset_launches()
            t0 = time.perf_counter()
            pc = densify.dense_reconstruction(scene, DenseOptions(),
                                              save_dmaps_to=tmp, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(pm_kernel.LAUNCHES)
            maps = _dmaps(tmp, len(scene.images))
    finally:
        logger.removeHandler(stage_log)
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
    return pc, maps, wall, launches, stage_log.stages


def _agreement(maps_a, maps_b):
    """Per view: valid-mask agreement, depth agreement to 1e-3 relative on
    the pixels valid in both, and the bit-identical share."""
    import numpy as np

    mask_agree, depth_agree, identical = [], [], []
    for a, b in zip(maps_a, maps_b):
        va, vb = a > 0, b > 0
        mask_agree.append(float((va == vb).mean()))
        both = va & vb
        rel = np.abs(a - b)[both] / b[both]
        depth_agree.append(float((rel < 1e-3).mean()) if both.any() else 1.0)
        identical.append(float((a == b).mean()))
    return mask_agree, depth_agree, identical


def _check_quality(q):
    for i, (acc, comp) in enumerate(q):
        if acc < 0.95 * JAX_ACCURACY[i] or comp < 0.95 * JAX_COMPLETENESS[i]:
            raise RuntimeError(f"view {i}: quality {(acc, comp)} below 95% of the "
                               f"JAX package's ({JAX_ACCURACY[i]}, {JAX_COMPLETENESS[i]})")


def phase_densify(card, scene, gts, t_scene):
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import depth_quality

    n = len(scene.images)
    opts = DenseOptions()
    pc, maps, wall, launches, stages = _run_densify(scene)
    q = [depth_quality(maps[i], gts[i]) for i in range(n)]
    n_nbrs = [len(im.meta.view_scores) for im in scene.images]
    n_maps = n * (1 + opts.estimation_geometric_iters)
    # estimation alone (photometric and geometric passes, as bench.py of the
    # JAX package counts depth maps), from the stage log's 10 ms resolution
    est_s = sum(v for k, v in stages.items()
                if k.startswith(("photometric pass", "geometric pass")))
    rec = {"phase": "densify", "views": n, "H": 480, "W": 640,
           "depth_maps": n_maps, "wall_s": wall,
           "depth_maps_per_s": n_maps / wall, "estimate_s": est_s,
           "estimate_depth_maps_per_s": n_maps / est_s if est_s else None,
           "stages_s": stages,
           "scene_build_s": t_scene, "points": len(pc),
           "launches": launches, "neighbors_per_view": n_nbrs,
           "accuracy": [a for a, _ in q], "completeness": [c for _, c in q],
           "jax_accuracy": JAX_ACCURACY, "jax_completeness": JAX_COMPLETENESS,
           "card": card}
    emit(rec)
    if any(launches[k] == 0 for k in MAIN_PATH):
        raise RuntimeError(f"a scorer kernel was not launched on the main path: {launches}")
    # per depth map: K1 <= 12V per pyramid level, K2 = 3V per geometric pass
    k1 = launches["score_view_exact"] + launches["score_view_nn"]
    k2 = launches["score_view_geom_exact"] + launches["score_view_geom_nn"]
    geo_expected = opts.estimation_geometric_iters * sum(3 * v for v in n_nbrs)
    if k2 != geo_expected:
        raise RuntimeError(f"K2 launches {k2} != {geo_expected}")
    if k1 > (opts.sub_resolution_levels + 1) * sum(12 * v for v in n_nbrs):
        raise RuntimeError(f"K1 launches {k1} above 12V per map and level")
    if len(pc) == 0:
        raise RuntimeError("empty dense cloud")
    _check_quality(q)
    return launches, maps


def phase_geom_split(card, scene, gts, default_maps, default_launches):
    """The densify path with geometric sweeps split (OMVS_GEOM_SPLIT=1):
    per geometric map K2 scores the incumbent once per neighbour view
    (init), and per parity K3 runs once per view, then K1."""
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import depth_quality

    n = len(scene.images)
    opts = DenseOptions()
    pc, maps, wall, launches, stages = _run_densify(
        scene, env={"OMVS_GEOM_SPLIT": "1"})
    q = [depth_quality(maps[i], gts[i]) for i in range(n)]
    mask_agree, depth_agree, identical = _agreement(maps, default_maps)
    n_nbrs = [len(im.meta.view_scores) for im in scene.images]
    geo = opts.estimation_geometric_iters
    n_maps = n * (1 + geo)
    k2 = launches["score_view_geom_exact"] + launches["score_view_geom_nn"]
    k3 = launches["geom_term"]
    expected = {"geom_term": geo * sum(2 * v for v in n_nbrs),
                "score_view_geom": geo * sum(n_nbrs),
                "score_view_exact": default_launches["score_view_exact"]
                + geo * sum(2 * v for v in n_nbrs)}
    est_s = sum(v for k, v in stages.items()
                if k.startswith(("photometric pass", "geometric pass")))
    rec = {"phase": "geom_split", "views": n, "H": 480, "W": 640,
           "depth_maps": n_maps, "wall_s": wall, "depth_maps_per_s": n_maps / wall,
           "estimate_s": est_s, "stages_s": stages, "points": len(pc),
           "launches": launches, "expected_launches": expected,
           "accuracy": [a for a, _ in q], "completeness": [c for _, c in q],
           "mask_agreement_with_densify": mask_agree,
           "depth_agreement_with_densify": depth_agree,
           "bit_identical_with_densify": identical, "card": card}
    emit(rec)
    if (k3, k2, launches["score_view_exact"]) != (
            expected["geom_term"], expected["score_view_geom"],
            expected["score_view_exact"]):
        raise RuntimeError(f"split launches {launches}, expected {expected}")
    if min(mask_agree) < 0.999 or min(depth_agree) < 0.999:
        raise RuntimeError("split and default depth maps disagree")
    _check_quality(q)
    return launches


def phase_parity(card):
    from openmvs_tpu_torch.synthetic import build_gt_scene

    n = 5
    out = {}
    for dev in ("cuda", "cpu"):
        scene, _, _ = build_gt_scene(n_views=n, W=160, H=120)
        pc, maps, wall, _, _ = _run_densify(scene, dev)
        out[dev] = (len(pc), maps, wall)
    mask_agree, depth_agree, identical = _agreement(out["cuda"][1], out["cpu"][1])
    pts = (out["cuda"][0], out["cpu"][0])
    rec = {"phase": "parity", "H": 120, "W": 160, "points_cuda": pts[0],
           "points_cpu": pts[1], "mask_agreement": mask_agree,
           "depth_agreement": depth_agree, "bit_identical": identical,
           "cuda_s": out["cuda"][2],
           "cpu_s": out["cpu"][2], "card": card}
    emit(rec)
    if min(mask_agree) <= 0.99 or min(depth_agree) <= 0.99:
        raise RuntimeError("card and CPU depth maps disagree")
    if abs(pts[0] - pts[1]) > 0.02 * max(pts[1], 1):
        raise RuntimeError(f"point counts differ by more than 2%: {pts}")
    return out["cuda"][1]


def phase_geom_unfused(card, default_maps):
    """The 120x160 scene on the card with geometric scoring unfused
    (OMVS_GEOM_FUSED=0: K1, then K3 per view, in place of K2), against the
    default run of phase parity."""
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene

    scene, _, _ = build_gt_scene(n_views=5, W=160, H=120)
    pc, maps, wall, launches, _ = _run_densify(scene, env={"OMVS_GEOM_FUSED": "0"})
    mask_agree, depth_agree, identical = _agreement(maps, default_maps)
    n_nbrs = [len(im.meta.view_scores) for im in scene.images]
    # per geometric map: the incumbent (C=1) and two parities, V views each
    k3_expected = DenseOptions().estimation_geometric_iters * sum(3 * v for v in n_nbrs)
    k2 = launches["score_view_geom_exact"] + launches["score_view_geom_nn"]
    rec = {"phase": "geom_unfused", "H": 120, "W": 160, "points": len(pc),
           "wall_s": wall, "launches": launches, "geom_term_expected": k3_expected,
           "mask_agreement_with_default": mask_agree,
           "depth_agreement_with_default": depth_agree,
           "bit_identical_with_default": identical, "card": card}
    emit(rec)
    if launches["geom_term"] != k3_expected or k2 != 0:
        raise RuntimeError(f"unfused launches {launches}: expected {k3_expected} "
                           "K3 and no K2")
    if min(mask_agree) < 0.999 or min(depth_agree) < 0.999:
        raise RuntimeError("unfused and default depth maps disagree")


def main():
    if not os.path.isdir(os.path.join(REPO, "openmvs_tpu_torch")):
        raise SystemExit("chip_smoke: openmvs_tpu_torch/ not found beside this script")
    sys.path.insert(0, REPO)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k in ("OMVS_GEOM_SPLIT", "OMVS_GEOM_FUSED", "OMVS_GEOM_DEBUG"):
        os.environ.pop(k, None)
    card = phase_device()
    phase_build()
    from openmvs_tpu_torch.synthetic import build_gt_scene

    t0 = time.perf_counter()
    scene, gts, _ = build_gt_scene(n_views=5, W=640, H=480)
    t_scene = time.perf_counter() - t0
    rows = phase_kernels(card, scene, gts)
    launches = {"variants": phase_variants(card)}
    launches["densify"], maps = phase_densify(card, scene, gts, t_scene)
    launches["geom_split"] = phase_geom_split(card, scene, gts, maps,
                                              launches["densify"])
    phase_geom_unfused(card, phase_parity(card))
    kernels = []
    for name, source, replaces, path in KERNEL_LINE:
        r = rows[(name, 11)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"openmvs_tpu_torch/csrc/{source}", "replaces": replaces,
            "path": path, "launches": launches[path][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
