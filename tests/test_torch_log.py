"""The port's logging helpers (``openmvs_tpu_torch/utils/log.py``) against
the JAX package's and OpenCV, on the CPU.

- ``JET`` equals ``cv2.applyColorMap(COLORMAP_JET)`` for all 256 values.
- ``dump_depth_artifacts`` (verbosity above 2) and the CLI's ``dump -o``
  of a ``.dmap`` write PNGs that decode to the pixels of the JAX package's
  cv2-written ones; at verbosity 2 nothing is written.
- ``Progress`` logs the JAX package's lines; ``timed`` adds the peak RSS
  under ``OMVS_LOG_RSS``; ``profile_trace`` writes a Chrome trace under
  ``OMVS_PROFILE_DIR`` and nothing without it.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from openmvs_tpu.__main__ import main as jax_main  # noqa: E402
from openmvs_tpu.utils import log as jlog  # noqa: E402
from openmvs_tpu_torch.__main__ import main as port_main  # noqa: E402
from openmvs_tpu_torch.io import dmap as dmapio  # noqa: E402
from openmvs_tpu_torch.utils import log as plog  # noqa: E402

torch.set_num_threads(1)


def test_jet_equals_opencv():
    ref = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)[:, 0]
    np.testing.assert_array_equal(plog.JET, ref)
    img = np.random.default_rng(0).integers(0, 256, (7, 9), dtype=np.uint8)
    np.testing.assert_array_equal(plog.apply_jet(img), cv2.applyColorMap(img, cv2.COLORMAP_JET))


def _maps(h=30, w=41, seed=0):
    r = np.random.default_rng(seed)
    depth = r.uniform(2, 9, (h, w)).astype(np.float32)
    depth[r.random((h, w)) < 0.2] = 0
    n = r.normal(size=(h, w, 3))
    normal = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    conf = r.uniform(-0.2, 1.2, (h, w)).astype(np.float32)
    return depth, normal, conf


def _pngs(folder):
    return {n: cv2.imread(os.path.join(folder, n), cv2.IMREAD_UNCHANGED)
            for n in sorted(os.listdir(folder))}


def _assert_same_pngs(a, b):
    pa, pb = _pngs(a), _pngs(b)
    assert list(pa) == list(pb) == ["conf0007.png", "depth0007.png", "normal0007.png"]
    for name in pa:
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)


def test_dump_depth_artifacts_equal_jax(tmp_path, monkeypatch):
    depth, normal, conf = _maps()
    monkeypatch.setenv("OMVS_VERBOSE", "2")
    plog.dump_depth_artifacts(str(tmp_path / "quiet"), 7, depth, normal, conf)
    assert not (tmp_path / "quiet").exists()
    monkeypatch.setenv("OMVS_VERBOSE", "3")
    assert plog.verbosity() == jlog.verbosity() == 3
    plog.dump_depth_artifacts(str(tmp_path / "p"), 7, depth, normal, conf)
    jlog.dump_depth_artifacts(str(tmp_path / "j"), 7, depth, normal, conf)
    _assert_same_pngs(tmp_path / "p", tmp_path / "j")


def test_dump_o_of_a_dmap_equals_jax(tmp_path, capsys):
    depth, normal, conf = _maps(24, 33, seed=1)
    path = str(tmp_path / "depth0007.dmap")
    dmapio.save(dmapio.DepthData(
        depth=depth, image_width=66, image_height=48, depth_min=2.0, depth_max=9.0,
        file_name="view0007.jpg", view_ids=np.array([7, 2, 3], np.uint32),
        K=np.array([[30.0, 0, 16], [0, 30, 12], [0, 0, 1]]), R=np.eye(3),
        C=np.zeros(3), normal=normal, conf=conf), path)
    port_main(["dump", path, "-o", str(tmp_path / "p")])
    printed = capsys.readouterr().out
    jax_main(["dump", path, "-o", str(tmp_path / "j")])
    assert capsys.readouterr().out.replace("/j", "/p") == printed
    _assert_same_pngs(tmp_path / "p", tmp_path / "j")
    assert "OMVS_VERBOSE" not in os.environ or os.environ["OMVS_VERBOSE"] != "3"


def _lines(caplog, name):
    return [r.getMessage() for r in caplog.records if r.name == name]


def test_progress_lines_equal_jax(caplog, monkeypatch):
    caplog.set_level(logging.INFO)
    clock = iter(np.arange(0.0, 100.0, 7.0))
    monkeypatch.setattr(plog.time, "perf_counter", lambda: next(clock))
    p = plog.Progress(logging.getLogger("omvs_torch.t"), "depth maps", 4, interval=5.0)
    for _ in range(4):
        p.step()
    p.close()
    clock = iter(np.arange(0.0, 100.0, 7.0))
    monkeypatch.setattr(jlog.time, "perf_counter", lambda: next(clock))
    j = jlog.Progress(logging.getLogger("omvs.t"), "depth maps", 4, interval=5.0)
    for _ in range(4):
        j.step()
    j.close()
    port, ref = _lines(caplog, "omvs_torch.t"), _lines(caplog, "omvs.t")
    assert port == ref and len(port) == 5
    assert port[0] == "depth maps: 1/4 (25%, 0:07 elapsed, ETA 0:21)"
    assert port[-1].startswith("depth maps: 4 done in 0:35")


def test_timed_logs_peak_rss(caplog, monkeypatch):
    caplog.set_level(logging.INFO)
    log = logging.getLogger("omvs_torch.rss")
    with plog.timed(log, "stage a"):
        pass
    monkeypatch.setenv("OMVS_LOG_RSS", "1")
    with plog.timed(log, "stage b"):
        pass
    a, b = _lines(caplog, "omvs_torch.rss")
    assert a.startswith("stage a (") and "peak_rss" not in a
    assert b.startswith("stage b (") and b.endswith(" GB)") and "peak_rss" in b
    assert float(b.split("peak_rss ")[1].split(" GB")[0]) > 0


def test_profile_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    with plog.profile_trace("off") as prof:
        torch.ones(3).sum()
    assert prof.path == "" and not list(tmp_path.iterdir())
    monkeypatch.setenv("OMVS_PROFILE_DIR", str(tmp_path / "prof"))
    with plog.profile_trace("densify") as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert prof.path == str(tmp_path / "prof" / "densify.json")
    with open(prof.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
