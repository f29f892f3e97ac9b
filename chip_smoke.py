#!/usr/bin/env python3
"""Drive the PyTorch port's PatchMatch densify path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   - fails without CUDA; prints the card's name and power limit
  2. build    - builds the CUDA scorer kernels from csrc/ (nvcc, sm_90a)
  3. kernels  - K1 (exact, nn) and K2 at the main path's shapes against
                their plain PyTorch versions on the card, with timings
  4. densify  - the synthetic 5-view 480x640 scene through
                densify.dense_reconstruction(scene, DenseOptions()) on the
                card: throughput, point count, kernel launches, and depth
                accuracy/completeness per view against ground truth, held
                to 95% of what the JAX package reaches on the same scene
  5. parity   - the same scene at 120x160 on the card against the port's
                plain versions on the CPU
then the {"kernels": [...]} line and, last, {"ok": true, "device": ...}.
Any failure raises and exits non-zero. Imports nothing of JAX.
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
# fp32 operations per (candidate, pixel), counted from csrc/pm_score.cu
# with an fma as two: per texel (warp, bounds, sample, accumulate), per
# pixel (setup, ZNCC epilogue), and the geometric term of K2
FLOP_TEXEL = {"exact": 50, "nn": 37}
FLOP_PIXEL = 44
FLOP_GEOM = 83
# (launch-counter name, sampling mode, geometric term): K1 and K2 in the
# modes the kernel source instantiates; K2 in "nn" mode is not on the main
# path (geometric passes score exact) and is checked here only
KERNELS = (("score_view_exact", "exact", False),
           ("score_view_nn", "nn", False),
           ("score_view_geom_exact", "exact", True),
           ("score_view_geom_nn", "nn", True))
MAIN_PATH = ("score_view_exact", "score_view_nn", "score_view_geom_exact")


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
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
    _build.library()
    regs = re.findall(r"Used (\d+) registers", _build.BUILD_INFO["log"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_INFO["seconds"],
          "registers_per_thread": [int(r) for r in regs],
          "spills": "spill" in _build.BUILD_INFO["log"]
          and not re.search(r"0 bytes spill stores, 0 bytes spill loads",
                            _build.BUILD_INFO["log"])})


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
        for name, mode, geom in KERNELS:
            nearest = mode == "nn"
            if geom:
                def kern():
                    return pm_kernel.score_view_geom(
                        v.image[j], v.size[j], v.Hl[j], v.Hm[j], v.Tr[j], v.Tn[j],
                        v.depth[j], depth, normal, inv_nd, data.X0, data.uv,
                        *common[1:], th_robust=th, nearest=nearest)

                def plain():
                    s, _ = pm_kernel.score_view_plain(
                        v.image[j], v.size[j], v.Hl[j], v.Hm[j], depth, normal,
                        inv_nd, *common, th_robust=th, nearest=nearest)
                    return s, pm_kernel.geom_term_plain(
                        v.depth[j], v.size[j], v.Hl[j], v.Hm[j], v.Tr[j],
                        v.Tn[j], depth, data.X0, data.uv)
            else:
                def kern():
                    return (pm_kernel.score_view(
                        v.image[j], v.size[j], v.Hl[j], v.Hm[j], depth, normal,
                        inv_nd, *common, th_robust=th, nearest=nearest),)

                def plain():
                    return (pm_kernel.score_view_plain(
                        v.image[j], v.size[j], v.Hl[j], v.Hm[j], depth, normal,
                        inv_nd, *common, th_robust=th, nearest=nearest)[0],)
            out_k = kern()
            torch.cuda.synchronize()
            out_p = plain()
            torch.cuda.synchronize()
            ok_px = depth > 0
            d_s = (out_k[0] - out_p[0]).abs()[ok_px]
            within = float((d_s < 1e-3).float().mean())
            rec = {"phase": "kernels", "name": name, "C": C, "H": H, "W": W,
                   "T": T, "score_max_abs_err": float(d_s.max()),
                   "score_share_within_1e-3": within}
            good = within >= 0.999 and float(d_s.max()) < 1e-2
            max_err = float(d_s.max())
            if geom:
                d_c = (out_k[1] - out_p[1]).abs()[ok_px]
                rec["cons_max_abs_err"] = float(d_c.max())
                rec["cons_share_within_1e-3"] = float((d_c < 1e-3).float().mean())
                good = good and rec["cons_share_within_1e-3"] >= 0.995
                max_err = max(max_err, float(d_c.max()))
            rec["ms"] = cuda_ms(kern, 20)
            rec["plain_ms"] = cuda_ms(plain, 3)
            rec["library_ms"] = None
            rec["library_note"] = ("no single PyTorch call computes a "
                                   "plane-warped bilateral ZNCC")
            bound, by = _bound(C, H, W, T, v.image[j].numel(),
                               v.depth[j].numel(), mode, geom)
            rec["bound_ms"] = bound
            rec["bound_by"] = by
            rec["card"] = card
            emit(rec)
            if not good:
                raise RuntimeError(f"{name} at C={C} disagrees with its plain version")
            rows[(name, C)] = dict(rec, max_abs_err=max_err)
    return rows


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


def phase_densify(card, scene, gts, t_scene):
    import torch

    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.ops import pm_kernel
    from openmvs_tpu_torch.synthetic import depth_quality

    n = len(scene.images)
    opts = DenseOptions()
    stage_log = _StageLog()
    logging.getLogger("omvs_torch.densify").addHandler(stage_log)
    with tempfile.TemporaryDirectory() as tmp:
        pm_kernel.reset_launches()
        t0 = time.perf_counter()
        pc = densify.dense_reconstruction(scene, opts, save_dmaps_to=tmp,
                                          device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(pm_kernel.LAUNCHES)
        maps = _dmaps(tmp, n)
    logging.getLogger("omvs_torch.densify").removeHandler(stage_log)
    q = [depth_quality(maps[i], gts[i]) for i in range(n)]
    n_nbrs = [len(im.meta.view_scores) for im in scene.images]
    n_maps = n * (1 + opts.estimation_geometric_iters)
    # estimation alone (photometric and geometric passes, as bench.py of the
    # JAX package counts depth maps), from the stage log's 10 ms resolution
    est_s = sum(v for k, v in stage_log.stages.items()
                if k.startswith(("photometric pass", "geometric pass")))
    rec = {"phase": "densify", "views": n, "H": 480, "W": 640,
           "depth_maps": n_maps, "wall_s": wall,
           "depth_maps_per_s": n_maps / wall, "estimate_s": est_s,
           "estimate_depth_maps_per_s": n_maps / est_s if est_s else None,
           "stages_s": stage_log.stages,
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
    for i in range(n):
        if q[i][0] < 0.95 * JAX_ACCURACY[i] or q[i][1] < 0.95 * JAX_COMPLETENESS[i]:
            raise RuntimeError(f"view {i}: quality {q[i]} below 95% of the JAX "
                               f"package's ({JAX_ACCURACY[i]}, {JAX_COMPLETENESS[i]})")
    return launches


def phase_parity(card):
    import numpy as np
    import torch

    from openmvs_tpu_torch import densify
    from openmvs_tpu_torch.config import DenseOptions
    from openmvs_tpu_torch.synthetic import build_gt_scene

    n = 5
    out = {}
    for dev in ("cuda", "cpu"):
        scene, _, _ = build_gt_scene(n_views=n, W=160, H=120)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            pc = densify.dense_reconstruction(scene, DenseOptions(),
                                              save_dmaps_to=tmp, device=dev)
            out[dev] = (len(pc), _dmaps(tmp, n), time.perf_counter() - t0)
    mask_agree, depth_agree, identical = [], [], []
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        va, vb = a > 0, b > 0
        mask_agree.append(float((va == vb).mean()))
        both = va & vb
        rel = np.abs(a - b)[both] / b[both]
        depth_agree.append(float((rel < 1e-3).mean()) if both.any() else 1.0)
        identical.append(float((a == b).mean()))
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


def main():
    if not os.path.isdir(os.path.join(REPO, "openmvs_tpu_torch")):
        raise SystemExit("chip_smoke: openmvs_tpu_torch/ not found beside this script")
    sys.path.insert(0, REPO)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_device()
    phase_build()
    from openmvs_tpu_torch.synthetic import build_gt_scene

    t0 = time.perf_counter()
    scene, gts, _ = build_gt_scene(n_views=5, W=640, H=480)
    t_scene = time.perf_counter() - t0
    rows = phase_kernels(card, scene, gts)
    launches = phase_densify(card, scene, gts, t_scene)
    phase_parity(card)
    kernels = []
    for name in MAIN_PATH:
        r = rows[(name, 11)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "openmvs_tpu_torch/csrc/pm_score.cu",
            "replaces": ("openmvs_tpu/ops/pm_kernel.py:979" if "geom" in name
                         else "openmvs_tpu/ops/pm_kernel.py:819"),
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
