"""Every cell of BENCHMARK.json resolves to its files by name, and adding a
configuration, a traffic mix or a metric takes new files and entries only."""

import json
import re
import shutil

import pytest

from mvs_bench import harness

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = harness.resolve(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["name"] == c.workload["traffic"]
    assert c.per_layer and all(callable(m.read) for m in c.metrics.values())
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


def test_a_new_metric_config_and_mix_are_found_without_an_edit(tmp_path):
    """A copy of the folder with one more metric file, configuration file
    and traffic file, and their BENCHMARK.json entries, resolves the new
    cell; no file that was there changes."""
    folder = tmp_path / "mvs_bench"
    shutil.copytree(harness.HERE, folder, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in folder.rglob("*") if p.is_file()}
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


def test_a_reader_whose_unit_disagrees_is_refused(tmp_path):
    folder = tmp_path / "mvs_bench"
    shutil.copytree(harness.HERE, folder, ignore=shutil.ignore_patterns("__pycache__"))
    path = folder / "metrics" / "device.idle_pct.py"
    path.write_text(path.read_text().replace('UNIT = "%"', 'UNIT = "s"'))
    with pytest.raises(ValueError, match="UNIT"):
        harness.resolve("dtu-pm.scene", folder=folder)
