"""Build and load the CUDA kernel libraries (``csrc/*.cu``).

``nvcc`` compiles each source into a shared library with a plain C
interface; the sources build in parallel, one ``nvcc`` each, all started
together. The libraries go under ``openmvs_tpu_torch/_build/<tag>/``,
where the tag hashes every file under ``csrc/`` and the flags, and
``ctypes`` loads them. The first call in a fresh checkout builds (a few
seconds); later calls reuse the libraries. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no contraction into fused multiply-adds, so every rounding
# step equals the plain version's op for op. A fused multiply-add moves a
# warped coordinate by an ulp, and at an exact .5 the nearest-texel sample
# then lands on the next pixel.
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_TEXELS = 128
MAX_VIEWS = 12  # DenseOptions.max_views: the multi-view kernels' limit
V2_MAX_TEXELS = 96  # K1-v2 stages the tile's weights of at most this many texels
SGM_REG_D = 256  # sgm_scan keeps the carry in registers up to this many disparities
WZNCC_MAX_TEXELS = 64  # wzncc_volume holds a pixel's weights in two registers a lane

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# argtypes of every exported function, by library (source stem)
SIGNATURES = {
    "pm_score": {
        "pm_score_view": [
            P, I, I,            # img, Hp, Wp
            P, P, P, P, P,      # size, Hl, Hm, Tr, Tn
            P, I, I,            # dm, Hd, Wd
            P, P, P, P, P,      # depth, normal, inv_nd, X0, uv
            P, I, P, P,         # goff, T, w, wtm
            P, P,               # sum_w, norm_sq0
            P, P,               # score, cons
            I, I, I, F, I, I,   # C, H, W, th_robust, nearest, geom
            P,                  # stream
        ],
        "pm_geom_term": [
            P, I, I,            # dm, Hd, Wd
            P, P, P, P, P,      # size, Tl, Tm, Tr, Tn
            P, P, P,            # depth, X0, uv
            P,                  # cons
            I, I, I,            # C, H, W
            P,                  # stream
        ],
        "pm_max_texels": [],
        "pm_error_string": [I],
    },
    "pm_score_views": {
        "pm_score_views_launch": [
            P, I, I,            # img (V, Hp, Wp), Hp, Wp
            P, P, P, P, P,      # size, Hl, Hm, Tr, Tn (stacked over V)
            P, I, I, P,         # dm (V, Hd, Wd), Hd, Wd, gterm (V, C, H, W)
            P, P, P, P, P,      # depth, normal, inv_nd, bonus, delta
            P, P, P, P,         # X0, uv, f_blend, d0
            P, I, P, P,         # goff, T, w, wtm
            P, P,               # sum_w, norm_sq0
            P,                  # out
            I, I, I, I,         # V, C, H, W
            F, F, I, I,         # th_robust, geom_weight, nearest, geom
            P,                  # band_act (ceil(H / 16) bytes) or null
            P,                  # stream
        ],
        "pm_views_max_views": [],
    },
    "pm_score_v2": {
        "pm_score_view_v2": [
            P, I, I, I,         # img, Hp, Wp, img_pitch
            P, P, P,            # size, Hl, Hm
            P, P, P, P,         # depth, normal, inv_nd, X0
            P, I, P, P, I,      # goff, T, w, wtm, w_pitch
            P, P,               # sum_w, norm_sq0
            P, P,               # score, in_window
            I, I, I, F, I,      # C, H, W, th_robust, nearest
            P,                  # stream
        ],
        "pm_v2_max_texels": [],
    },
    "pm_geom_views": {
        "pm_geom_views_launch": [
            P, I, I,            # dms (V, Hd, Wd), Hd, Wd
            P, P, P, P, P,      # sizes, Tl, Tm, Tr, Tn (stacked over V)
            P, P, P,            # depth, X0, uv
            P,                  # out (V, C, H, W)
            I, I, I, I,         # V, C, H, W
            P,                  # stream
        ],
        "pm_geom_views_max_views": [],
    },
    "sgm_scan": {
        "sgm_scan_launch": [
            P, P, P,            # xs (B, N, M, D), p2s (B, N, M), out
            I, I, I, I,         # B, N, M, D
            F, I, I,            # p1, shift, diag
            P,                  # stream
        ],
        "sgm_scan_reg_d": [],
    },
    "wzncc_volume": {
        "wzncc_volume_launch": [
            P, P, P, P,         # w, tw (T, B, H, W), sum_w, norm_sq0 (B, H, W)
            P, P, P, P,         # right (B, H, W), d_mins (B,), lo, hi (B, H, W) or null
            P,                  # out (B, H, W, D)
            I, I, I, I,         # B, H, W, D
            I, I, I,            # half_x, half_y, k_split
            P,                  # stream
        ],
        "wzncc_volume_max_texels": [],
    },
    "segment_sum": {
        "segment_sum_launch": [
            P, P, P, P,         # order (R,), offsets (n + 1,), src (R, K), out (n, K)
            L, I,               # n, K
            P,                  # stream
        ],
    },
}
RESTYPES = {"pm_error_string": ctypes.c_char_p}

_libs = {}
_LOAD_LOCK = threading.Lock()
# per source: nvcc seconds and output (ptxas register and spill lines)
BUILD_INFO = {"seconds": None, "sources": {}, "dir": None}


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


def sources():
    return sorted(CSRC.glob("*.cu"))


def _tag() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Build every source under csrc/ (in parallel, one nvcc each) unless
    this tag's libraries exist; returns their directory."""
    out = BUILD_DIR / _tag()
    todo = [s for s in sources() if not (out / f"{s.stem}.so").exists()]
    BUILD_INFO["dir"] = str(out)
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out / f"{src.stem}.{os.getpid()}.tmp.so"
        procs.append((src, tmp, time.perf_counter(), subprocess.Popen(
            [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, t_start, proc in procs:
        log, _ = proc.communicate()
        BUILD_INFO["sources"][src.name] = {
            "seconds": time.perf_counter() - t_start, "log": log}
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out / f"{src.stem}.so")
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return out


def library(name: str = "pm_score") -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (all sources are
    built on first use, once for the process: worker threads wait)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if name not in SIGNATURES:
        raise KeyError(f"no kernel library {name!r}")
    with _LOAD_LOCK:
        if name not in _libs:
            _libs[name] = _load(name)
    return _libs[name]


def load_all() -> None:
    """Build and load every kernel library, before worker threads launch."""
    for name in SIGNATURES:
        library(name)


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build() / f"{name}.so"))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = RESTYPES.get(fn, I)
    limits = {"pm_score": ("pm_max_texels", MAX_TEXELS),
              "pm_score_views": ("pm_views_max_views", MAX_VIEWS),
              "pm_geom_views": ("pm_geom_views_max_views", MAX_VIEWS),
              "pm_score_v2": ("pm_v2_max_texels", V2_MAX_TEXELS),
              "sgm_scan": ("sgm_scan_reg_d", SGM_REG_D),
              "wzncc_volume": ("wzncc_volume_max_texels", WZNCC_MAX_TEXELS)}
    if name in limits:
        fn, want = limits[name]
        if getattr(lib, fn)() != want:
            raise RuntimeError(f"{name} library and wrapper disagree on {fn}")
    return lib


def error_string(code: int) -> str:
    return library("pm_score").pm_error_string(code).decode()
