"""Two OS processes join one ``torch.distributed`` group (gloo over
localhost TCP) and split the port's PatchMatch sweep of 8 views between
them, the counterpart of tests/test_distributed_multiprocess.py. Parity
with a serial sweep and a cross-process ``all_reduce`` are checked inside
each worker (tests/_torch_dist_worker.py), which imports no JAX.

The port's package itself uses no process group: its multi-device paths
are single-process (``openmvs_tpu_torch/parallel``). This test shows the
port's sweep running unchanged under a multi-process split.
"""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(600)
def test_cross_process_sweep_parity():
    port = _free_port()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    worker = os.path.join(REPO, "tests", "_torch_dist_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(port), "2", str(i)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=540)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for i, (pr, log) in enumerate(zip(procs, logs)):
        assert pr.returncode == 0, f"worker {i} failed:\n{log[-4000:]}"
        assert f"joined: rank {i}/2" in log, log[-2000:]
        assert f"DIST_OK rank={i}" in log, log[-2000:]
