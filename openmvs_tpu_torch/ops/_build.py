"""Build and load the CUDA scorer library (``csrc/pm_score.cu``).

``nvcc`` compiles the source into a shared library with a plain C
interface, keyed by a hash of the source and flags, under
``openmvs_tpu_torch/_build/``; ``ctypes`` loads it. The first call in a
fresh checkout builds (a few seconds); later calls reuse the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pm_score.cu"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no contraction into fused multiply-adds, so every rounding
# step equals the plain version's op for op. A fused multiply-add moves a
# warped coordinate by an ulp, and at an exact .5 the nearest-texel sample
# then lands on the next pixel.
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_TEXELS = 128

_lib = None
BUILD_INFO = {"seconds": None, "log": "", "path": None}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library() -> ctypes.CDLL:
    """The loaded scorer library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"pm_score_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        r = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True)
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        BUILD_INFO["log"] = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{BUILD_INFO['log']}")
        os.replace(tmp, so)
    BUILD_INFO["path"] = str(so)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pm_score_view.restype = I
    lib.pm_score_view.argtypes = [
        P, I, I,            # img, Hp, Wp
        P, P, P, P, P,      # size, Hl, Hm, Tr, Tn
        P, I, I,            # dm, Hd, Wd
        P, P, P, P, P,      # depth, normal, inv_nd, X0, uv
        P, I, P, P,         # goff, T, w, wtm
        P, P,               # sum_w, norm_sq0
        P, P,               # score, cons
        I, I, I, ctypes.c_float, I, I,  # C, H, W, th_robust, nearest, geom
        P,                  # stream
    ]
    lib.pm_error_string.restype = ctypes.c_char_p
    lib.pm_error_string.argtypes = [I]
    lib.pm_max_texels.restype = I
    if lib.pm_max_texels() != MAX_TEXELS:
        raise RuntimeError("pm_score library and wrapper disagree on MAX_TEXELS")
    _lib = lib
    return lib


def error_string(code: int) -> str:
    return library().pm_error_string(code).decode()
