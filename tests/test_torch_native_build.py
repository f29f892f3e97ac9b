"""The first build of the native libraries under parallel test workers.
The JAX package's: ``_torch_helpers.build_native_locked`` serialises it
across processes. The port's (``openmvs_tpu_torch/native``, the graph
cut, decimation and rasterizer): its own ``build`` takes an ``flock``
beside the library. Either way, concurrent first builds on a fresh tree
compile once and share one library."""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

from _torch_helpers import build_native_locked

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent

_CHILD = """
import importlib.util, json, sys
sys.path[:0] = [{tests!r}, {repo!r}]
from _torch_helpers import build_native_locked
spec = importlib.util.spec_from_file_location("native_copy", {init!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
path, built = build_native_locked(mod)
print(json.dumps([path, built]))
"""


def test_concurrent_first_builds_share_one_library(tmp_path):
    pkg = tmp_path / "native"
    shutil.copytree(REPO / "openmvs_tpu" / "native", pkg,
                    ignore=shutil.ignore_patterns("_omvs_native.so*", "__pycache__"))
    code = _CHILD.format(tests=str(TESTS), repo=str(REPO), init=str(pkg / "__init__.py"))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(5)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    results = [tuple(__import__("json").loads(out.strip().splitlines()[-1]))
               for out, _ in outs]
    paths = {path for path, _ in results}
    assert paths == {str(pkg / "_omvs_native.so")}
    assert sum(built for _, built in results) == 1      # one process compiled
    assert not list(pkg.glob("*.tmp"))
    ctypes.CDLL(paths.pop())


def test_repo_library_is_fresh_after_collection():
    """Collection built the repo's library, so no later call rebuilds it."""
    path, built = build_native_locked()
    assert Path(path).is_file() and not built


_PORT_CHILD = """
import json, sys
sys.path[:0] = [{repo!r}]
from pathlib import Path
from openmvs_tpu_torch import native
native.BUILD_DIR = Path({build!r})
compiles = []
run = native.subprocess.run
native.subprocess.run = lambda cmd, **kw: (compiles.append(cmd[0]), run(cmd, **kw))[1]
path = native.build()
native._load()          # the library loads and binds every entry point
print(json.dumps([str(path), len(compiles)]))
"""


def test_port_concurrent_first_builds_compile_once(tmp_path):
    code = _PORT_CHILD.format(repo=str(REPO), build=str(tmp_path / "native"))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(5)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    results = [tuple(__import__("json").loads(out.strip().splitlines()[-1]))
               for out, _ in outs]
    paths = {path for path, _ in results}
    assert len(paths) == 1 and Path(paths.pop()).name == "omvs_native.so"
    assert sum(n for _, n in results) == 1                # one process compiled
    assert not list((tmp_path / "native").rglob("*.tmp"))
