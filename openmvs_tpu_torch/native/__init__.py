"""Host-side native code (C++ via ctypes): the graph cut over the Delaunay
tetrahedralization, quadric edge-collapse decimation, the z-buffer
rasterizer and the golden "MVS project" emitter.

Copies of the JAX package's ``openmvs_tpu/native/src/`` (``maxflow.h``,
``maxflow.cpp``, ``delaunay_cut.cpp``, ``decimate.cpp``, ``rasterize.cpp``,
``project_emitter.cpp``),
built with the same ``g++`` flags (``openmvs_tpu/native/__init__.py``) into
one library, so both libraries compile the same arithmetic on one machine
and agree to the bit. It is host code, as in the JAX package: meshing runs
the visibility ray walk and the s-t min-cut (``reconstruct``), cleaning
decimates (``mesh_ops``), refinement and texturing rasterize the mesh into
each view on the CPU; ``emit_test_project`` writes an archive by an
encoder independent of ``io/boost_archive.py``, to hold that codec against.

The library is built on the first call (never at import) into
``openmvs_tpu_torch/_build/native/<tag>/``; the tag hashes the sources, the
flags and the host name, because ``-march=native`` code runs only on a CPU
like the one that built it. Each build writes a per-process ``.tmp`` and
renames it, under an exclusive ``flock`` on a lock file beside the library,
so that of several processes reaching a first build together one compiles
and the others load its library. A failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = Path(__file__).resolve().parent / "src"
SOURCES = ("maxflow.cpp", "delaunay_cut.cpp", "decimate.cpp", "rasterize.cpp",
           "project_emitter.cpp")
HEADERS = ("maxflow.h",)
BUILD_DIR = _PKG / "_build" / "native"
FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-fopenmp"]

_lock = threading.Lock()
_lib = None


def _lib_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode() + b"\0" + (SRC_DIR / name).read_bytes())
    h.update(" ".join(FLAGS + [platform.node()]).encode())
    return BUILD_DIR / h.hexdigest()[:16] / "omvs_native.so"


def build() -> Path:
    """Compile the library if this host has none for the current sources;
    returns its path. Raises if ``g++`` fails."""
    path = _lib_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.with_name(path.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():           # another process built it meanwhile
            return path
        tmp = path.with_name(f"omvs_native.{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, "-o", str(tmp), *(str(SRC_DIR / s) for s in SOURCES)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"native build needs g++: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{proc.stderr}")
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
            p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.omvs_delaunay_graph_cut.restype = ctypes.c_int64
            lib.omvs_delaunay_graph_cut.argtypes = [
                p_f64, c_i64,            # verts, nv
                p_i32, p_i32, c_i64,     # tets, neigh, nt
                p_i32,                   # vert_tet
                p_f64, c_i64,            # cam_centers, ncam
                p_f64, p_i32,            # cam_P (ncam,3,4), cam_wh (ncam,2)
                p_i64, p_i32, p_f32,     # view_indptr, view_cam, view_weight
                ctypes.c_double, ctypes.c_double, ctypes.c_double,  # sigma, kqual, kinf
                ctypes.c_int32,          # use_free_space
                ctypes.c_double, ctypes.c_double,                   # kb, kf
                ctypes.c_double, ctypes.c_double, ctypes.c_double,  # kRel, kAbs, kOutl
                p_u8,                    # inside_out (nt + n_hull)
            ]
            lib.omvs_rasterize.restype = ctypes.c_int
            lib.omvs_rasterize.argtypes = [
                p_f64, c_i64, p_i32, c_i64,   # proj (nv,3), nv, faces, nf
                c_i64, c_i64,                 # H, W
                p_i32, p_f32, p_f32,          # face_id, depth, bary
            ]
            lib.omvs_decimate.restype = ctypes.c_int
            lib.omvs_decimate.argtypes = [
                p_f64, c_i64, p_i32, c_i64,   # verts_in, nv, faces_in, nf
                c_i64,                        # target_nf
                p_f64, p_i32,                 # out_verts, out_faces
                np.ctypeslib.ndpointer(np.int64, shape=(1,)),
                np.ctypeslib.ndpointer(np.int64, shape=(1,)),
            ]
            lib.omvs_emit_test_project.restype = ctypes.c_int
            lib.omvs_emit_test_project.argtypes = [ctypes.c_char_p]
            _lib = lib
    return _lib


def emit_test_project(path: str) -> None:
    """Write the tiny golden 'MVS project' archive used to cross-validate
    io/boost_archive.py against an independent C++ emitter of the wire
    format (native/src/project_emitter.cpp)."""
    rc = _load().omvs_emit_test_project(path.encode())
    if rc != 0:
        raise RuntimeError(f"omvs_emit_test_project failed (rc={rc})")


def delaunay_graph_cut(
    verts: np.ndarray,
    tets: np.ndarray,
    neigh: np.ndarray,
    vert_tet: np.ndarray,
    cam_centers: np.ndarray,
    cam_P: np.ndarray,
    cam_wh: np.ndarray,
    view_indptr: np.ndarray,
    view_cam: np.ndarray,
    view_weight: np.ndarray,
    sigma: float,
    kqual: float,
    kinf: float,
    use_free_space: bool = False,
    kb: float = 4.0,
    kf: float = 3.0,
    k_rel: float = 0.1,
    k_abs: float = 1000.0,
    k_outl: float = 400.0,
) -> np.ndarray:
    """Returns per-cell free/full labels, length nt + n_hull: entry t < nt is
    tet t; entries nt.. are the per-hull-facet outside nodes in (t, j) scan
    order of neigh < 0.  0 = free/empty space (source side of the cut —
    camera rays tie hull-exit nodes to the source), 1 = full/interior matter
    (sink side).  The surface is the set of facets between a free and a full
    cell."""
    lib = _load()
    nv, nt = len(verts), len(tets)
    neigh = np.ascontiguousarray(neigh, np.int32)
    n_hull = int((neigh < 0).sum())
    inside = np.zeros(nt + n_hull, np.uint8)
    rc = lib.omvs_delaunay_graph_cut(
        np.ascontiguousarray(verts, np.float64), nv,
        np.ascontiguousarray(tets, np.int32),
        neigh, nt,
        np.ascontiguousarray(vert_tet, np.int32),
        np.ascontiguousarray(cam_centers, np.float64), len(cam_centers),
        np.ascontiguousarray(cam_P, np.float64),
        np.ascontiguousarray(cam_wh, np.int32),
        np.ascontiguousarray(view_indptr, np.int64),
        np.ascontiguousarray(view_cam, np.int32),
        np.ascontiguousarray(view_weight, np.float32),
        float(sigma), float(kqual), float(kinf),
        1 if use_free_space else 0,
        float(kb), float(kf), float(k_rel), float(k_abs), float(k_outl),
        inside,
    )
    if rc != n_hull:
        raise RuntimeError(f"omvs_delaunay_graph_cut failed (rc={rc}, expected {n_hull})")
    return inside


def decimate(verts: np.ndarray, faces: np.ndarray, target_nf: int):
    """Quadric edge-collapse decimation to <= target_nf faces."""
    verts = np.ascontiguousarray(verts, np.float64)
    faces = np.ascontiguousarray(faces, np.int32)
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"decimate: verts {verts.shape} and faces {faces.shape} "
                         "must be (n, 3)")
    if len(faces) and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("decimate: a face indexes a vertex out of range")
    lib = _load()
    nv, nf = len(verts), len(faces)
    out_v = np.zeros((nv, 3), np.float64)
    out_f = np.zeros((nf, 3), np.int32)
    out_nv = np.zeros(1, np.int64)
    out_nf = np.zeros(1, np.int64)
    rc = lib.omvs_decimate(verts, nv, faces, nf, int(target_nf),
                           out_v, out_f, out_nv, out_nf)
    if rc != 0:
        raise RuntimeError(f"omvs_decimate failed (rc={rc})")
    return out_v[: out_nv[0]].copy(), out_f[: out_nf[0]].copy()


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
