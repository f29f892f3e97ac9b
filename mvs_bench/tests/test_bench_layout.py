"""Every cell of BENCHMARK.json resolves to its files by name, and adding a
configuration (with a reference and faults of its own), a traffic mix or a
metric takes new files and entries only."""

import argparse
import functools
import json
import re
import shutil

import pytest
import torch

from mvs_bench import harness, run as bench_run

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = harness.resolve(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["name"] == c.workload["traffic"]
    assert c.per_layer and all(callable(m.read) for m in c.metrics.values())
    assert c.reference.__file__ == str(harness.HERE / "references"
                                       / f"{c.config['reference']}.py")
    assert set(c.config["limits"]) <= set(c.reference.COMPARED)
    assert all(callable(getattr(c.reference, f)) for f in ("prepare", "judge", "control"))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "depth_maps_per_s"}


def test_the_contract_shapes_hold():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("mvs_bench/configs/")
        with open(harness.ROOT / c["file"]) as f:
            assert set(c["reduced"]) <= set(json.load(f)["reduced"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert 1 <= BENCH["run_seconds"] <= 51
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def _copy(tmp_path):
    folder = tmp_path / "mvs_bench"
    shutil.copytree(harness.HERE, folder, ignore=shutil.ignore_patterns("__pycache__"))
    return folder, {p: p.read_bytes() for p in folder.rglob("*") if p.is_file()}


def test_a_new_metric_config_and_mix_are_found_without_an_edit(tmp_path):
    """A copy of the folder with one more metric file, configuration file
    and traffic file, and their BENCHMARK.json entries, resolves the new
    cell; no file that was there changes."""
    folder, before = _copy(tmp_path)
    (folder / "metrics" / "jobs.count.py").write_text(
        'UNIT = "jobs"\nLAYER = "driver"\nMOVES = "depth_maps_per_s"\n\n\n'
        "def read(ctx):\n    return float(len(ctx.jobs)) if ctx.jobs else None\n")
    cfg = json.loads((folder / "configs" / "dtu-pm.json").read_text())
    cfg["name"] = "dtu-pm-4nbr"
    cfg["options"]["max_views"] = 4
    (folder / "configs" / "dtu-pm-4nbr.json").write_text(json.dumps(cfg))
    mix = json.loads((folder / "traffic" / "scene.json").read_text())
    mix["name"] = "scene-cold"
    mix["warmup_jobs"] = 0
    (folder / "traffic" / "scene-cold.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="dtu-pm-4nbr",
                                 file="mvs_bench/configs/dtu-pm-4nbr.json"))
    bench["workloads"].append({"name": "dtu-pm-4nbr.scene-cold", "config": "dtu-pm-4nbr",
                               "traffic": "scene-cold", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "jobs.count", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "driver",
                               "moves": "depth_maps_per_s"})
    cell = harness.resolve("dtu-pm-4nbr.scene-cold", bench=bench, folder=folder)
    assert cell.config["options"]["max_views"] == 4 and cell.traffic["warmup_jobs"] == 0
    assert cell.metrics["jobs.count"].read(harness.Context(jobs=[harness.Job()])) == 1.0
    assert "pm.estimate_s_per_map" not in cell.metrics  # listed for dtu-pm.scene only
    after = {p: p.read_bytes() for p in before}
    assert after == before


# A test-only reference: PatchMatch's maps as estimated, before the shared
# cross-view filter and fusion, against the scene's true depth.
RAW_REFERENCE = '''"""The estimated maps against the true depth."""

import numpy as np
import torch

from mvs_bench import harness

COMPARED = ("raw_err_med_pct",)
_geometry = harness.load_reference("geometry")


def install(probes):
    from openmvs_tpu_torch import densify

    filt = densify._filter_views

    def kept(results, resumed, opts):
        if probes.job is not None:
            probes.job.kept["raw"] = {i: np.array(r.depth) for i, r in results.items()}
        return filt(results, resumed, opts)

    probes.patch(densify, "_filter_views", kept)


def prepare(cfg, device):
    return _geometry.truth_maps(cfg, device)


def _readings(maps, truth):
    errs = [np.zeros(0)]
    for i, t in enumerate(truth):
        d = maps.get(i)
        if d is not None:
            both = (d > 0) & (t > 0)
            errs.append(np.abs(d[both] - t[both]) / t[both])
    errs = np.concatenate(errs)
    return {"raw_err_med_pct": 100.0 * float(np.median(errs)) if len(errs) else 100.0,
            "raw_views": float(len(maps))}


def judge(truth, job):
    return _readings(job.kept.get("raw", {}), truth)


def control(cfg, device):
    low = _geometry.truth_maps(cfg, device, dtype=torch.bfloat16)
    return _readings(dict(enumerate(low)), prepare(cfg, device))
'''

RAW_FAULTS = '''import numpy as np


def _deeper(monkeypatch):
    from openmvs_tpu_torch import densify

    opt = densify.optimize_depth_map

    def deeper(res, opts):
        opt(res, opts)
        res.depth *= np.float32(1.05)

    monkeypatch.setattr(densify, "optimize_depth_map", deeper)


FAULTS = {"deeper": _deeper}
'''


@pytest.fixture
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_a_configuration_is_judged_by_its_own_reference(tmp_path, monkeypatch, _threads):
    """A copy of the folder with one more configuration that names a new
    reference module, with its faults file: it resolves, a dry run reads
    correct under that reference's own readings, and its planted fault
    reads not correct; no file that was there changes."""
    folder, before = _copy(tmp_path)
    (folder / "references" / "raw.py").write_text(RAW_REFERENCE)
    (folder / "faults" / "dtu-pm-raw.py").write_text(RAW_FAULTS)
    cfg = json.loads((folder / "configs" / "dtu-pm.json").read_text())
    cfg.update(name="dtu-pm-raw", reference="raw", limits={"raw_err_med_pct": 1.0})
    cfg["dry_run"]["limits"] = {"raw_err_med_pct": 3.0}
    (folder / "configs" / "dtu-pm-raw.json").write_text(json.dumps(cfg))
    mix = json.loads((folder / "traffic" / "scene.json").read_text())
    mix.update(name="scene-cold", warmup_jobs=0)
    (folder / "traffic" / "scene-cold.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="dtu-pm-raw",
                                 file="mvs_bench/configs/dtu-pm-raw.json"))
    bench["workloads"].append({"name": "dtu-pm-raw.scene-cold", "config": "dtu-pm-raw",
                               "traffic": "scene-cold", "chips": 1, "why": "a test"})
    resolve = functools.partial(harness.resolve, bench=bench, folder=folder)
    cell = resolve("dtu-pm-raw.scene-cold")
    assert cell.reference.COMPARED == ("raw_err_med_pct",)
    monkeypatch.setattr(harness, "resolve", resolve)
    args = argparse.Namespace(workload="dtu-pm-raw.scene-cold", seed=3141592653,
                              seconds=0.0, trace=0, dry_run=True)
    out = bench_run.run(args)
    print("sound", json.dumps(out["checks"]))
    assert out["correct"] is True and list(out["checks"]) == ["raw_err_med_pct", "jobs_failed"]
    harness.load_faults("dtu-pm-raw", folder / "faults")["deeper"](monkeypatch)
    out = bench_run.run(args)
    print("deeper", json.dumps(out["checks"]))
    assert out["correct"] is False and out["failed"] == 1
    assert {p: p.read_bytes() for p in before} == before


def _no_reference(cfg):
    del cfg["reference"]


def _missing_module(cfg):
    cfg["reference"] = "no-such-reference"


def _limit_not_compared(cfg):
    cfg["limits"]["points_per_map"] = 1.0


def _dry_run_limit_not_compared(cfg):
    cfg["dry_run"]["limits"]["points_per_map"] = 1.0


@pytest.mark.parametrize("edit,error,match", [
    (_no_reference, ValueError, "names no reference"),
    (_missing_module, FileNotFoundError, "no-such-reference"),
    (_limit_not_compared, ValueError, "limits .*points_per_map.* not compared"),
    (_dry_run_limit_not_compared, ValueError, "dry_run.limits .*points_per_map"),
], ids=["no_reference", "missing_module", "limit_not_compared", "dry_run_limit_not_compared"])
def test_resolve_refuses_a_configuration_without_its_reference(tmp_path, edit, error, match):
    folder, _ = _copy(tmp_path)
    path = folder / "configs" / "dtu-pm.json"
    cfg = json.loads(path.read_text())
    edit(cfg)
    path.write_text(json.dumps(cfg))
    with pytest.raises(error, match=match):
        harness.resolve("dtu-pm.scene", folder=folder)


def test_a_reader_whose_unit_disagrees_is_refused(tmp_path):
    folder, _ = _copy(tmp_path)
    path = folder / "metrics" / "device.idle_pct.py"
    path.write_text(path.read_text().replace('UNIT = "%"', 'UNIT = "s"'))
    with pytest.raises(ValueError, match="UNIT"):
        harness.resolve("dtu-pm.scene", folder=folder)
