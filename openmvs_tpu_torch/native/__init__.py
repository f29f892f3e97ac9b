"""Host-side z-buffer rasterizer (C++ via ctypes).

A copy of the JAX package's ``openmvs_tpu/native/src/rasterize.cpp``,
built with the same ``g++`` flags (``openmvs_tpu/native/__init__.py``), so
both libraries compile the same arithmetic on one machine and rasterize
to the bit alike. It is host code, as in the JAX package: refinement
rasterizes the mesh into each view on the CPU and uploads the face-id and
barycentric maps; texturing rasterizes it for face visibility and, in
global seam leveling, rasterizes the color offsets into the atlas.

The library is built on the first call (never at import) into
``openmvs_tpu_torch/_build/native/<tag>/``; the tag hashes the source, the
flags and the host name, because ``-march=native`` code runs only on a CPU
like the one that built it. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = Path(__file__).resolve().parent / "src" / "rasterize.cpp"
BUILD_DIR = _PKG / "_build" / "native"
FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-fopenmp"]

_lock = threading.Lock()
_lib = None


def _lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS + [platform.node()]).encode())
    return BUILD_DIR / h.hexdigest()[:16] / "rasterize.so"


def build() -> Path:
    """Compile the rasterizer if this host has no library for the current
    source; returns its path. Raises if ``g++`` fails."""
    path = _lib_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"rasterize.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"rasterizer build needs g++: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"rasterizer build failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            c_i64 = ctypes.c_int64
            p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.omvs_rasterize.restype = ctypes.c_int
            lib.omvs_rasterize.argtypes = [
                p_f64, c_i64, p_i32, c_i64,   # proj (nv,3), nv, faces, nf
                c_i64, c_i64,                 # H, W
                p_i32, p_f32, p_f32,          # face_id, depth, bary
            ]
            _lib = lib
    return _lib


def rasterize(proj: np.ndarray, faces: np.ndarray, H: int, W: int,
              want_bary: bool = True):
    """Z-buffer rasterization of projected vertices (u, v, camera-depth).

    Returns (face_id (H,W) int32 with -1 empty, depth (H,W) f32,
    bary (H,W,3) f32 perspective-correct or None)."""
    proj = np.ascontiguousarray(proj, np.float64)
    faces = np.ascontiguousarray(faces, np.int32)
    if proj.ndim != 2 or proj.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"rasterize: proj {proj.shape} and faces {faces.shape} "
                         "must be (n, 3)")
    if len(faces) and (faces.min() < 0 or faces.max() >= len(proj)):
        raise ValueError("rasterize: a face indexes a vertex out of range")
    lib = _load()
    face_id = np.empty((H, W), np.int32)
    depth = np.empty((H, W), np.float32)
    bary = np.empty((H, W, 3), np.float32)
    rc = lib.omvs_rasterize(proj, len(proj), faces, len(faces), H, W,
                            face_id, depth, bary)
    if rc != 0:
        raise RuntimeError(f"omvs_rasterize failed (rc={rc})")
    return face_id, depth, (bary if want_bary else None)
