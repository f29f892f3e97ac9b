"""Run one cell of the benchmark and print its result as the last line.

    python3 mvs_bench/run.py --workload dtu-pm.scene --seed 7 --seconds 51 --trace 0

Set-up (``setup_s``): imports, the port's CUDA libraries (built on the
first run of a checkout, under ``openmvs_tpu_torch/_build/``), the cell's
scene made on the card from ``--seed``, and the traffic's warm-up jobs.
The window: whole jobs back to back until ``--seconds`` have passed, each
``dense_reconstruction`` over the scene to its fused cloud;
``depth_maps_per_s`` is their maps over the time from the window's start
to the last job's end. Then every job is judged by the configuration's
reference (``references/<reference>.py``, named by the configuration's
``reference``): each job's readings, then each compared number beside its
limit, on standard error. ``f1_pct`` is the last job's cloud against the
scene's geometry (``references/geometry.py``), whatever the reference. The
run keeps few host threads on fixed cores (``steady_host``).

``--trace 1`` profiles the window's first job with ``torch.profiler`` (the
trace is read after the window) and reports the cell's per-layer metrics
instead of its end-to-end ones; the span metrics come from the window's
other jobs.
``--dry-run`` runs the configuration's small ``dry_run`` scene on the CPU
through the port's plain kernel versions, a test mode that reports no
device metric (and profiles nothing). Without it, a run that finds no card, or fewer than the
cell asks for, exits with an error and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# the host's share of a run: few threads, on a fixed set of cores
THREADS = 2
CORES = 4


class NoDevice(RuntimeError):
    pass


def steady_host(threads: int = THREADS, cores: int = CORES):
    """Keep the run's host load steady: every thread pool (OpenMP, BLAS,
    PyTorch's) at ``threads``, and the process on the last ``cores`` of the
    cores it may use, the same ones in every run. Call before NumPy or
    PyTorch is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(threads)
    allowed = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, allowed[-cores:])


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--dry-run", action="store_true",
                   help="test mode: the config's small scene on the CPU, no device metric")
    return p.parse_args(argv)


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run(args, t_start: float = T_START) -> dict:
    """The run's result object (the last line's content). Raises NoDevice
    when the cell's cards are not there (outside ``--dry-run``)."""
    import torch

    from mvs_bench import harness, scene_gen

    cell = harness.resolve(args.workload)
    cfg = copy.deepcopy(cell.config)
    limits = cfg["limits"]
    if args.dry_run:
        cfg["scene"].update(cfg["dry_run"]["scene"])
        limits = cfg["dry_run"]["limits"]
        device = "cpu"
    else:
        chips = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f"{args.workload} needs {chips} CUDA device(s); found "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", torch.get_num_threads())))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        from openmvs_tpu_torch.ops import _build

        _build.load_all()
        torch.cuda.reset_peak_memory_stats()
    arrays = scene_gen.make_scene(cfg, args.seed, device)
    opts = harness.options(cfg)
    traffic = cell.traffic
    probes = harness.Probes()
    probes.install()
    if hasattr(cell.reference, "install"):
        cell.reference.install(probes)
    if args.trace:
        for mod in cell.metrics.values():
            if hasattr(mod, "install"):
                mod.install(probes)
    try:
        for _ in range(traffic["warmup_jobs"]):
            harness.run_job(arrays, opts, device, traffic, probes, harness.Job())
        setup_s = time.perf_counter() - t_start

        # the window: whole jobs until the deadline has passed
        jobs, profiled = [], None
        t_window = time.perf_counter()
        deadline = t_window + args.seconds
        t_last = t_window  # the end of the last whole job
        while not jobs or time.perf_counter() < deadline:
            job = harness.Job()
            try:
                if args.trace and not args.dry_run and profiled is None:
                    profiled = job
                    prof = _profiled_job(arrays, opts, device, traffic, probes, job)
                else:
                    harness.run_job(arrays, opts, device, traffic, probes, job)
            except Exception as e:  # a job that fails is counted, then the run ends
                job.error = f"{type(e).__name__}: {e}"
                jobs.append(job)
                print(f"job failed: {job.error}", file=sys.stderr)
                break
            jobs.append(job)
            t_last = time.perf_counter()
            print(f"job {len(jobs)}: {job.seconds:.3f} s, {job.n_maps} maps, "
                  + (f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
                     f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved after it"
                     if device == "cuda" else "on the CPU"), file=sys.stderr)
    finally:
        probes.uninstall()
    if profiled is not None and profiled.error is None:
        t0 = time.perf_counter()
        labels = {sp[0] for sp in profiled.spans} | {harness.JOB_SPAN}
        profiled.device = harness.device_summary(prof, labels)
        del prof
        print(f"trace read in {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    device_info = {"platform": "cpu" if device == "cpu" else "gpu",
                   "kind": ("cpu" if device == "cpu" else torch.cuda.get_device_name(0)),
                   "count": 1 if device == "cpu" else cell.workload["chips"],
                   "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                         if device == "cuda" else 0)}
    if device == "cuda":
        device_info["power_limit"] = _power_limit()
    if profiled is not None and profiled.device is not None:
        device_info["busy_s"] = profiled.device["busy_s"]
        device_info["window_s"] = profiled.device["window_s"]
    done = [j for j in jobs if j.error is None]
    timed_jobs = [j for j in done if j is not profiled] or done

    # the reference, once the window has closed and the peak is read
    if device == "cuda":
        torch.cuda.empty_cache()
    geometry = harness.load_reference("geometry")
    scene = geometry.prepare(cfg, device)  # float64 truth, for f1_pct
    prepared = (scene if Path(cell.reference.__file__) == Path(geometry.__file__)
                else cell.reference.prepare(cfg, device))
    checks = {name: 0.0 for name in limits}
    failed = len(jobs) - len(done)
    for n, j in enumerate(done, 1):
        got = cell.reference.judge(prepared, j)
        print(f"job {n} readings {json.dumps(got)}", file=sys.stderr)
        if any(got[k] > limits[k] for k in limits):
            failed += 1
        for k in limits:
            checks[k] = max(checks[k], got[k])
    f1 = (geometry.f1_pct(done[-1].points, scene.maps, scene.K, scene.Cs, scene.tol)
          if done else None)
    correct = bool(done) and failed == 0 and f1 is not None

    metrics = {}
    if args.dry_run:  # a CPU run writes no device metric: the cloud's quality only
        if f1 is not None:
            metrics["f1_pct"] = {"value": f1, "unit": "%"}
    elif args.trace:
        ctx = harness.Context(jobs=timed_jobs, profiled=profiled)
        for m in cell.per_layer:
            value = cell.metrics[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # every map of the whole jobs over all the window's time they took
        values = {"depth_maps_per_s": (sum(j.n_maps for j in done) / (t_last - t_window)
                                       if done and len(done) == len(jobs) else None),
                  "f1_pct": f1, "setup_s": setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    out = {"correct": correct, "attempted": len(jobs), "failed": failed,
           "metrics": metrics, "device": device_info}
    if profiled is not None and profiled.device is not None:
        d = profiled.device
        out["breakdown"] = {
            "device_ops": sorted(([k[:160], v] for k, v in d["by_name"].items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in d["idle_by_span"].items()),
                                key=lambda kv: -kv[1])[:10]}
    out["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    out["checks"]["jobs_failed"] = {"value": failed, "limit": 0}
    return out


def _profiled_job(arrays, opts, device, traffic, probes, job):
    """One job under torch.profiler (host and device activity), with the
    stage spans as record_function ranges; returns the profiler, read once
    the window has closed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mvs_bench import harness

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    probes.profiling = True
    try:
        with profile(activities=acts) as prof:
            with record_function(harness.JOB_SPAN):
                harness.run_job(arrays, opts, device, traffic, probes, job)
    finally:
        probes.profiling = False
    return prof


def main(argv=None) -> int:
    args = parse(argv)
    steady_host()
    try:
        out = run(args)
    except NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    from mvs_bench import harness

    found = harness.forbidden_modules()
    if found:
        print(f"no result: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
