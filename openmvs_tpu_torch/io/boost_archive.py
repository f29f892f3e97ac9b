"""Reader/writer for the reference's boost-serialization "MVS project" files
(a copy of the JAX package's ``io/boost_archive.py``, built on the port's
``io/mvs.py``; the same bytes in all four archive types).

The reference's ``Scene::Save`` writes this format *by default whenever a mesh
is present* (``ARCHIVE_MVS`` falls through to ``ARCHIVE_DEFAULT``,
libs/MVS/Scene.cpp:591-618), so interop with existing OpenMVS working folders
requires it.  This is a version-pinned decoder for the documented subset
(platforms, images, pointcloud, mesh, obb — the full ``Scene::serialize``
surface, libs/MVS/Scene.h:160-166), plus a writer emitting the same wire
format so scenes round-trip back into the reference.

Outer container (libs/MVS/Scene.cpp:41-42,592-618), little-endian:

    'MVS\\0' | u32 version(=1) | u32 archive_type | u64 reserved | payload

``archive_type`` is the reference's ``ARCHIVE_TYPE`` (libs/Common/
Types.inl:3832-3843): 0=TEXT, 1=BINARY, 2=BINARY_ZIP (zlib stream),
3=BINARY_ZSTD (zstd stream).  The payload is a boost::serialization archive
written with ``boost::archive::no_header`` (the reference's default flags,
Types.inl:3846), pinned to the modern boost wire format (>=1.69, the
reference's vcpkg floor; archive library version >7) on 64-bit little-endian:

* first encounter of each class type emits a preamble: u8 tracking flag +
  u32 class version (``basic_oarchive::save_object``; the class-id token is
  elided in binary archives).  All reference scene types use default traits:
  version 0, tracking off (no type in the Scene graph is serialized through
  pointers).  A set tracking flag means pointer-tracked objects — out of the
  documented subset — and raises ``UnsupportedArchive``.
* arithmetic types: raw little-endian; bool: 1 byte.
* std::string: u64 length + raw bytes.
* C arrays / ``make_array`` of arithmetic types: raw dump (boost's array
  optimization); ``make_array`` of class types: per-element objects.
* ``SEACAVE::cList<T,...,IDX>``: IDX-typed element count + ``make_array``
  of the elements (libs/Common/List.h:1431-1441).  NOTE: the count width
  follows the cList *instantiation*: 4 bytes for uint32-indexed arrays,
  8 bytes for size_t-indexed ones (e.g. the PointCloud arrays,
  libs/MVS/PointCloud.h:54-71 with ``Index=IDX=size_t``), and 1 byte for
  ``Mesh::texturesDiffuse`` (``IDX=TexIndex=uint8_t``, libs/MVS/Mesh.h:76).
* TEXT archives: the same event stream as space-separated decimal tokens;
  strings as ``<len> <raw bytes>``.

Serialization bodies mirrored here (field order is the contract):
  Scene: platforms, images, pointcloud, mesh, obb       (Scene.h:160-166)
  Platform: name, cameras, poses                        (Platform.h:83-88)
  Camera: base CameraIntern{K,R,C} (K normalized when the platform camera
          carries no resolution)                        (Camera.h:247-251,476-484)
  Pose: R, C                                            (Platform.h:62-66)
  Image: platformID, cameraID, poseID, ID, relative name, relative maskName,
         width, height, neighbors, avgDepth             (Image.h:112-137)
  ViewScore: ID, points, scale, angle, area, score      (Interface.h:527-544)
  PointCloud: points, pointViews, pointWeights, normals, colors
                                                        (PointCloud.h:114-121)
  Mesh: vertices, faces, vertexNormals, vertexVertices, vertexFaces,
        vertexBoundary, faceNormals, faceTexcoords (PIXEL units,
        Mesh.cpp:1012-1047), faceTexindices, texturesDiffuse (BGR,
        Types.h:1826-1829)                              (Mesh.h:266-278)
  TOBB<float,3>: m_rot, m_pos (center), m_ext (half extents)  (OBB.h:112-116)
  TPoint2/3 and TMatrix serialize through their cv base classes
  (Types.h:1334,1427,1541; Types.inl:3733-3756): Matx = raw val array,
  Point_ = x,y[,z] fields; TImage -> TDMatrix -> cv::Mat_ = cols, rows,
  raw pixel block (Types.inl:3699-3712).

Validated against an independent C++ emitter of the same wire format
(native/src/project_emitter.cpp, ``native.emit_test_project``) plus
byte-golden and round-trip tests (tests/test_torch_boost_archive.py).  Archives written by boost builds that
pointer-track scene types, or by pre-1.69 boost, fail loudly with a
pointer to the MVSI exporter instead of misparsing.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import mvs as mvsio

PROJECT_MAGIC = b"MVS\x00"
PROJECT_VERSION = 1

ARCHIVE_TEXT = 0
ARCHIVE_BINARY = 1
ARCHIVE_BINARY_ZIP = 2
ARCHIVE_BINARY_ZSTD = 3

_ARCHIVE_NAMES = {"text": ARCHIVE_TEXT, "binary": ARCHIVE_BINARY,
                  "zip": ARCHIVE_BINARY_ZIP, "zstd": ARCHIVE_BINARY_ZSTD}


class UnsupportedArchive(RuntimeError):
    """Raised for project archives outside the documented subset."""


# --------------------------------------------------------------------- zstd


class _Zstd:
    """Minimal libzstd binding (streaming decompress, one-shot compress)."""

    class InBuffer(ctypes.Structure):
        _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                    ("pos", ctypes.c_size_t)]

    class OutBuffer(ctypes.Structure):
        _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                    ("pos", ctypes.c_size_t)]

    def __init__(self):
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        self.lib = ctypes.CDLL(name)
        self.lib.ZSTD_isError.restype = ctypes.c_uint
        self.lib.ZSTD_createDStream.restype = ctypes.c_void_p
        self.lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        self.lib.ZSTD_decompressStream.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(self.OutBuffer),
            ctypes.POINTER(self.InBuffer)]
        self.lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        self.lib.ZSTD_compressBound.restype = ctypes.c_size_t
        self.lib.ZSTD_compress.restype = ctypes.c_size_t
        self.lib.ZSTD_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
            ctypes.c_size_t, ctypes.c_int]

    def decompress(self, data: bytes) -> bytes:
        ds = self.lib.ZSTD_createDStream(None)
        try:
            src = ctypes.create_string_buffer(data, len(data))
            inb = self.InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
            chunks = []
            out_cap = 1 << 20
            outbuf = ctypes.create_string_buffer(out_cap)
            while True:
                outb = self.OutBuffer(ctypes.cast(outbuf, ctypes.c_void_p),
                                      out_cap, 0)
                ret = self.lib.ZSTD_decompressStream(
                    ds, ctypes.byref(outb), ctypes.byref(inb))
                if self.lib.ZSTD_isError(ret):
                    raise UnsupportedArchive("corrupt zstd stream in project archive")
                if outb.pos:
                    chunks.append(outbuf.raw[:outb.pos])
                if inb.pos >= inb.size and (ret == 0 or outb.pos == 0):
                    break
            return b"".join(chunks)
        finally:
            self.lib.ZSTD_freeDStream(ds)

    def compress(self, data: bytes, level: int = 1) -> bytes:
        cap = self.lib.ZSTD_compressBound(len(data))
        dst = ctypes.create_string_buffer(cap)
        n = self.lib.ZSTD_compress(ctypes.cast(dst, ctypes.c_void_p), cap,
                                   data, len(data), level)
        if self.lib.ZSTD_isError(n):
            raise RuntimeError("zstd compression failed")
        return dst.raw[:n]


_zstd_singleton: Optional[_Zstd] = None


def _zstd() -> _Zstd:
    global _zstd_singleton
    if _zstd_singleton is None:
        try:
            _zstd_singleton = _Zstd()
        except OSError as e:
            raise UnsupportedArchive(
                "project archive is zstd-compressed but libzstd is not "
                "available; re-export from OpenMVS with --archive-type 2 "
                "(zlib) or as an MVSI interface file") from e
    return _zstd_singleton


# ----------------------------------------------------------------- data model


@dataclass
class ProjectImage:
    """MVS::Image as stored in project archives (Image.h:112-137)."""

    platform_id: int = 0
    camera_id: int = 0
    pose_id: int = 0
    id: int = 0xFFFFFFFF
    name: str = ""
    mask_name: str = ""
    width: int = 0
    height: int = 0
    neighbors: List[mvsio.ViewScore] = field(default_factory=list)
    avg_depth: float = 0.0


@dataclass
class ProjectMesh:
    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    faces: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint32))
    vertex_normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    vertex_vertices: List[np.ndarray] = field(default_factory=list)
    vertex_faces: List[np.ndarray] = field(default_factory=list)
    vertex_boundary: np.ndarray = field(default_factory=lambda: np.zeros(0, np.bool_))
    face_normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    face_texcoords: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    face_texindices: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    textures: List[np.ndarray] = field(default_factory=list)  # (h,w,3) u8 BGR


@dataclass
class ProjectScene:
    """Decoded Scene::serialize payload (Scene.h:160-166)."""

    platforms: List[mvsio.Platform] = field(default_factory=list)
    images: List[ProjectImage] = field(default_factory=list)
    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    point_views: List[np.ndarray] = field(default_factory=list)
    point_weights: List[np.ndarray] = field(default_factory=list)
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint8))
    mesh: ProjectMesh = field(default_factory=ProjectMesh)
    obb_rot: np.ndarray = field(default_factory=lambda: np.zeros((3, 3), np.float32))
    obb_pos: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    obb_ext: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))


# ------------------------------------------------------------ event streams
#
# The binary and text archive variants share the same logical event stream;
# _BinReader/_TextReader (and the writers) expose it as: scalar prims,
# strings, and bulk numpy blocks.  Class preambles are layered on top.


class _BinReader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise UnsupportedArchive(
                "truncated project archive (wanted %d bytes at offset %d of "
                "%d) — wire-format mismatch or corrupt file"
                % (n, self.pos, len(self.buf)))
        b = self.buf[self.pos:end]
        self.pos = end
        return b

    def prim(self, fmt: str):
        return struct.unpack("<" + fmt, self._take(struct.calcsize(fmt)))[0]

    def string(self) -> str:
        n = self.prim("Q")
        if n > len(self.buf):
            raise UnsupportedArchive(
                "implausible string length %d — wire-format mismatch" % n)
        return self._take(n).decode("utf-8", errors="replace")

    def block(self, dtype, count: int) -> np.ndarray:
        """Raw array of `count` items of numpy dtype (boost array optimization)."""
        dtype = np.dtype(dtype)
        return np.frombuffer(self._take(dtype.itemsize * count), dtype).copy()


class _TextReader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _token(self) -> bytes:
        n = len(self.buf)
        while self.pos < n and self.buf[self.pos] in b" \n\r\t":
            self.pos += 1
        if self.pos >= n:
            raise UnsupportedArchive("truncated text project archive")
        start = self.pos
        while self.pos < n and self.buf[self.pos] not in b" \n\r\t":
            self.pos += 1
        return self.buf[start:self.pos]

    def prim(self, fmt: str):
        t = self._token()
        if fmt in ("f", "d"):
            return float(t)
        return int(t)

    def string(self) -> str:
        n = self.prim("Q")
        # exactly one separator, then n raw bytes (may contain spaces)
        self.pos += 1
        if self.pos + n > len(self.buf):
            raise UnsupportedArchive("truncated string in text project archive")
        s = self.buf[self.pos:self.pos + n]
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def block(self, dtype, count: int) -> np.ndarray:
        dtype = np.dtype(dtype)
        base = dtype.base if dtype.subdtype else dtype
        shape = (count,) + (dtype.subdtype[1] if dtype.subdtype else ())
        total = int(np.prod(shape)) if count else 0
        kind = "d" if base.kind == "f" else "q"
        vals = [self.prim(kind) for _ in range(total)]
        return np.asarray(vals, base).reshape(shape) if total else np.zeros(shape, base)


class _BinWriter:
    def __init__(self):
        self.chunks = []

    def prim(self, fmt: str, v):
        self.chunks.append(struct.pack("<" + fmt, v))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.prim("Q", len(b))
        self.chunks.append(b)

    def block(self, arr: np.ndarray):
        self.chunks.append(np.ascontiguousarray(arr).tobytes())

    def getvalue(self) -> bytes:
        return b"".join(self.chunks)


class _TextWriter:
    def __init__(self):
        self.chunks = []

    def _tok(self, t: str):
        if self.chunks:
            self.chunks.append(b" ")
        self.chunks.append(t.encode())

    def prim(self, fmt: str, v):
        if fmt == "f":
            self._tok(np.format_float_positional(np.float32(v), unique=True,
                                                 trim="0"))
        elif fmt == "d":
            self._tok(np.format_float_positional(np.float64(v), unique=True,
                                                 trim="0"))
        else:
            self._tok(str(int(v)))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.prim("Q", len(b))
        self.chunks.append(b" ")
        self.chunks.append(b)

    def block(self, arr: np.ndarray):
        flat = np.asarray(arr).ravel()
        if flat.dtype.kind == "f":
            for v in flat:
                self.prim("d" if flat.dtype.itemsize == 8 else "f", v)
        else:
            for v in flat:
                self.prim("q", v)

    def getvalue(self) -> bytes:
        return b"".join(self.chunks)


# -------------------------------------------------------------- class layer


class _Archive:
    """Class-preamble bookkeeping shared by read and write sides."""

    def __init__(self, stream, writing: bool):
        self.s = stream
        self.writing = writing
        self.seen = {}

    def preamble(self, tag: str) -> int:
        """First encounter of class `tag`: tracking flag + class version."""
        if tag in self.seen:
            return self.seen[tag]
        if self.writing:
            self.s.prim("B", 0)   # tracking: off
            self.s.prim("I", 0)   # class version (all scene types are v0)
            self.seen[tag] = 0
            return 0
        tracking = self.s.prim("B")
        if tracking not in (0, 1):
            raise UnsupportedArchive(
                "unexpected tracking byte 0x%02x for %s — this archive was "
                "probably written by an unsupported boost version; re-export "
                "from OpenMVS as an MVSI interface file" % (tracking, tag))
        if tracking:
            raise UnsupportedArchive(
                "archive pointer-tracks type %s, which is outside the "
                "documented subset; re-export from OpenMVS as an MVSI "
                "interface file" % tag)
        ver = self.s.prim("I")
        self.seen[tag] = ver
        return ver

    # -- leaf composites -----------------------------------------------------

    def point3(self, tag: str, fmt: str, value=None):
        """TPoint3<T> -> base cv::Point3_<T> -> x,y,z (Types.h:1427)."""
        self.preamble("TPoint3<%s>" % tag)
        self.preamble("cv::Point3_<%s>" % tag)
        if self.writing:
            for v in value:
                self.s.prim(fmt, v)
            return None
        return np.array([self.s.prim(fmt) for _ in range(3)])

    def matx(self, tag: str, fmt: str, rows: int, cols: int, value=None):
        """TMatrix<T,m,n> -> base cv::Matx -> raw val (Types.h:1541)."""
        self.preamble("TMatrix<%s,%d,%d>" % (tag, rows, cols))
        self.preamble("cv::Matx<%s,%d,%d>" % (tag, rows, cols))
        dt = np.float64 if fmt == "d" else np.float32
        if self.writing:
            self.s.block(np.asarray(value, dt).reshape(rows * cols))
            return None
        return self.s.block(dt, rows * cols).reshape(rows, cols)

    def clist_raw(self, tag: str, idx_fmt: str, dtype, value=None):
        """cList of arithmetic T: IDX count + raw block (List.h:1431)."""
        self.preamble(tag)
        if self.writing:
            arr = np.asarray(value)
            self.s.prim(idx_fmt, arr.shape[0] if arr.ndim else len(arr))
            self.s.block(arr)
            return None
        n = self.s.prim(idx_fmt)
        return self.s.block(dtype, n)

    def clist_objects(self, tag: str, idx_fmt: str, n_or_items):
        """cList of class T: IDX count; caller serializes the elements."""
        self.preamble(tag)
        if self.writing:
            self.s.prim(idx_fmt, n_or_items)
            return n_or_items
        return self.s.prim(idx_fmt)

    def point3_array(self, list_tag: str, idx_fmt: str, elem_tag: str,
                     fmt: str, value=None):
        """cList of TPoint3<T>: bulk-decode after the first element registers
        the element classes (each element is a fixed raw record once its
        class preambles have been emitted)."""
        dt = np.float64 if fmt == "d" else (np.uint32 if fmt == "I" else np.float32)
        if self.writing:
            arr = np.ascontiguousarray(value, dt).reshape(-1, 3)
            self.clist_objects(list_tag, idx_fmt, len(arr))
            if len(arr):
                self.point3(elem_tag, fmt, arr[0])
                self.s.block(arr[1:])
            return None
        n = self.clist_objects(list_tag, idx_fmt, None)
        if n == 0:
            return np.zeros((0, 3), dt)
        first = self.point3(elem_tag, fmt)
        rest = self.s.block(dt, 3 * (n - 1)).reshape(-1, 3)
        return np.concatenate([np.asarray(first, dt)[None], rest], axis=0)

    def nested_u32_lists(self, outer_tag: str, outer_idx: str,
                         inner_tag: str, inner_idx: str, dtype,
                         value=None):
        """cList< cList<arith> >: per-element inner lists with bulk data."""
        if self.writing:
            self.clist_objects(outer_tag, outer_idx, len(value))
            for inner in value:
                self.clist_raw(inner_tag, inner_idx,
                               dtype, np.asarray(inner, dtype))
            return None
        n = self.clist_objects(outer_tag, outer_idx, None)
        return [self.clist_raw(inner_tag, inner_idx, dtype) for _ in range(n)]


# ---------------------------------------------------------- scene grammar


def _camera_intern(a: _Archive, rig: Optional[mvsio.CameraRig]):
    """CameraIntern{K,R,C} (Camera.h:247-251); K is the normalized form
    when the platform camera has no resolution (Camera.h:57)."""
    a.preamble("MVS::CameraIntern")
    if a.writing:
        a.matx("double", "d", 3, 3, rig.K)
        a.matx("double", "d", 3, 3, rig.R)
        a.point3("double", "d", rig.C)
        return None
    K = a.matx("double", "d", 3, 3)
    R = a.matx("double", "d", 3, 3)
    C = a.point3("double", "d")
    return mvsio.CameraRig(name="", band_name="", width=0, height=0,
                           K=K, R=R, C=np.asarray(C, np.float64))


def _platforms(a: _Archive, platforms=None):
    n = a.clist_objects("cList<Platform>", "I",
                        len(platforms) if a.writing else None)
    out = []
    for i in range(n):
        a.preamble("MVS::Platform")
        if a.writing:
            p = platforms[i]
            a.preamble("SEACAVE::String")
            a.s.string(p.name)
            a.clist_objects("cList<Camera>", "I", len(p.cameras))
            for c in p.cameras:
                a.preamble("MVS::Camera")
                _camera_intern(a, c)
            a.clist_objects("cList<Pose>", "I", len(p.poses))
            for ps in p.poses:
                a.preamble("MVS::Platform::Pose")
                a.matx("double", "d", 3, 3, ps.R)
                a.point3("double", "d", ps.C)
        else:
            a.preamble("SEACAVE::String")
            name = a.s.string()
            ncam = a.clist_objects("cList<Camera>", "I", None)
            cams = []
            for _ in range(ncam):
                a.preamble("MVS::Camera")
                cams.append(_camera_intern(a, None))
            nposes = a.clist_objects("cList<Pose>", "I", None)
            poses = []
            for _ in range(nposes):
                a.preamble("MVS::Platform::Pose")
                R = a.matx("double", "d", 3, 3)
                C = a.point3("double", "d")
                poses.append(mvsio.Pose(R=R, C=np.asarray(C, np.float64)))
            out.append(mvsio.Platform(name=name, cameras=cams, poses=poses))
    return out


_VIEWSCORE_REC = np.dtype([("ID", "<u4"), ("points", "<u4"), ("scale", "<f4"),
                           ("angle", "<f4"), ("area", "<f4"), ("score", "<f4")])


def _viewscores(a: _Archive, scores=None):
    """neighbors: CLISTDEF0IDX(ViewScore,IIndex) (Image.h:51)."""
    if a.writing:
        a.clist_objects("cList<ViewScore>", "I", len(scores))
        if scores:
            a.preamble("MVS::ViewScore")
            if isinstance(a.s, _BinWriter):
                rec = np.zeros(len(scores), _VIEWSCORE_REC)
                for i, vs in enumerate(scores):
                    rec[i] = (vs.id, vs.points, vs.scale, vs.angle, vs.area,
                              vs.score)
                a.s.chunks.append(rec.tobytes())
            else:
                for vs in scores:
                    a.s.prim("q", vs.id); a.s.prim("q", vs.points)
                    a.s.prim("f", vs.scale); a.s.prim("f", vs.angle)
                    a.s.prim("f", vs.area); a.s.prim("f", vs.score)
        return None
    n = a.clist_objects("cList<ViewScore>", "I", None)
    out = []
    if n == 0:
        return out
    a.preamble("MVS::ViewScore")
    if isinstance(a.s, _BinReader):
        rec = np.frombuffer(a.s._take(_VIEWSCORE_REC.itemsize * n),
                            _VIEWSCORE_REC)
        for r in rec:
            out.append(mvsio.ViewScore(
                id=int(r["ID"]), points=int(r["points"]), scale=float(r["scale"]),
                angle=float(r["angle"]), area=float(r["area"]),
                score=float(r["score"])))
    else:
        for _ in range(n):
            out.append(mvsio.ViewScore(
                id=a.s.prim("q"), points=a.s.prim("q"), scale=a.s.prim("f"),
                angle=a.s.prim("f"), area=a.s.prim("f"), score=a.s.prim("f")))
    return out


def _images(a: _Archive, images=None, base_dir: str = "."):
    n = a.clist_objects("cList<Image>", "I", len(images) if a.writing else None)
    out = []
    for i in range(n):
        a.preamble("MVS::Image")
        if a.writing:
            im = images[i]
            for v in (im.platform_id, im.camera_id, im.pose_id, im.id):
                a.s.prim("I", v)
            a.preamble("SEACAVE::String")
            a.s.string(_make_rel(im.name, base_dir))
            a.s.string(_make_rel(im.mask_name, base_dir) if im.mask_name else "")
            a.s.prim("I", im.width)
            a.s.prim("I", im.height)
            _viewscores(a, im.neighbors)
            a.s.prim("f", im.avg_depth)
        else:
            pid = a.s.prim("I"); cid = a.s.prim("I")
            poseid = a.s.prim("I"); gid = a.s.prim("I")
            a.preamble("SEACAVE::String")
            name = a.s.string()
            mask = a.s.string()
            w = a.s.prim("I"); h = a.s.prim("I")
            neighbors = _viewscores(a)
            avg_depth = a.s.prim("f")
            out.append(ProjectImage(
                platform_id=pid, camera_id=cid, pose_id=poseid, id=gid,
                name=name, mask_name=mask, width=w, height=h,
                neighbors=neighbors, avg_depth=avg_depth))
    return out


def _pointcloud(a: _Archive, ps: Optional[ProjectScene]):
    """PointCloud arrays; Index = size_t => 8-byte counts (PointCloud.h:54)."""
    a.preamble("MVS::PointCloud")
    if a.writing:
        a.point3_array("cList<Point3f,size_t>", "Q", "float", "f",
                       np.asarray(ps.points, np.float32).reshape(-1, 3))
        a.nested_u32_lists("cList<ViewArr,size_t>", "Q",
                           "cList<View=u32>", "I", np.uint32, ps.point_views)
        a.nested_u32_lists("cList<WeightArr,size_t>", "Q",
                           "cList<Weight=f32>", "I", np.float32, ps.point_weights)
        a.point3_array("cList<Point3f,size_t>", "Q", "float", "f",
                       np.asarray(ps.normals, np.float32).reshape(-1, 3))
        _pixel_array(a, "cList<Pixel8U,size_t>", "Q",
                     np.asarray(ps.colors, np.uint8).reshape(-1, 3))
        return None
    points = a.point3_array("cList<Point3f,size_t>", "Q", "float", "f")
    views = a.nested_u32_lists("cList<ViewArr,size_t>", "Q",
                               "cList<View=u32>", "I", np.uint32)
    weights = a.nested_u32_lists("cList<WeightArr,size_t>", "Q",
                                 "cList<Weight=f32>", "I", np.float32)
    normals = a.point3_array("cList<Point3f,size_t>", "Q", "float", "f")
    colors = _pixel_array(a, "cList<Pixel8U,size_t>", "Q")
    return points, views, weights, normals, colors


def _pixel_array(a: _Archive, list_tag: str, idx_fmt: str, value=None):
    """cList<TPixel<u8>>: each element is `ar & c` = 3 raw bytes
    (Types.h:1982-1987), BGR order (Types.h:1826-1829)."""
    if a.writing:
        arr = np.ascontiguousarray(value, np.uint8).reshape(-1, 3)
        a.clist_objects(list_tag, idx_fmt, len(arr))
        if len(arr):
            a.preamble("SEACAVE::TPixel<u8>")
            a.s.block(arr)
        return None
    n = a.clist_objects(list_tag, idx_fmt, None)
    if n == 0:
        return np.zeros((0, 3), np.uint8)
    a.preamble("SEACAVE::TPixel<u8>")
    return a.s.block(np.uint8, 3 * n).reshape(-1, 3)


def _point2_array(a: _Archive, list_tag: str, idx_fmt: str, value=None):
    """cList<TPoint2<float>> (texcoords): x,y via cv::Point_ (Types.h:1334)."""
    if a.writing:
        arr = np.ascontiguousarray(value, np.float32).reshape(-1, 2)
        a.clist_objects(list_tag, idx_fmt, len(arr))
        if len(arr):
            a.preamble("TPoint2<float>")
            a.preamble("cv::Point_<float>")
            a.s.block(arr)
        return None
    n = a.clist_objects(list_tag, idx_fmt, None)
    if n == 0:
        return np.zeros((0, 2), np.float32)
    a.preamble("TPoint2<float>")
    a.preamble("cv::Point_<float>")
    return a.s.block(np.float32, 2 * n).reshape(-1, 2)


def _image8u3(a: _Archive, img=None):
    """Image8U3 -> TDMatrix -> cv::Mat_: cols, rows, raw BGR block
    (Types.h:2216, Types.inl:3699-3712)."""
    a.preamble("SEACAVE::TImage<Pixel8U>")
    a.preamble("SEACAVE::TDMatrix<Pixel8U>")
    a.preamble("cv::Mat_<Pixel8U>")
    if a.writing:
        h, w = (img.shape[0], img.shape[1]) if img is not None and img.size else (0, 0)
        a.s.prim("i", w)
        a.s.prim("i", h)
        if h and w:
            a.preamble("SEACAVE::TPixel<u8>")
            a.s.block(np.ascontiguousarray(img, np.uint8))
        return None
    w = a.s.prim("i")
    h = a.s.prim("i")
    if h <= 0 or w <= 0:
        return np.zeros((0, 0, 3), np.uint8)
    a.preamble("SEACAVE::TPixel<u8>")
    return a.s.block(np.uint8, 3 * h * w).reshape(h, w, 3)


def _mesh(a: _Archive, m: Optional[ProjectMesh]):
    a.preamble("MVS::Mesh")
    if a.writing:
        a.point3_array("cList<Vertex,u32>", "I", "float", "f",
                       np.asarray(m.vertices, np.float32).reshape(-1, 3))
        a.point3_array("cList<Face,u32>", "I", "uint32_t", "I",
                       np.asarray(m.faces, np.uint32).reshape(-1, 3))
        a.point3_array("cList<Vertex,u32>", "I", "float", "f",
                       np.asarray(m.vertex_normals, np.float32).reshape(-1, 3))
        a.nested_u32_lists("cList<VIdxArr,u32>", "I", "cList<u32,grow8>", "I",
                           np.uint32, m.vertex_vertices)
        a.nested_u32_lists("cList<VIdxArr,u32>", "I", "cList<u32,grow8>", "I",
                           np.uint32, m.vertex_faces)
        a.clist_raw("cList<bool>", "Q", np.uint8,
                    np.asarray(m.vertex_boundary, np.uint8))
        a.point3_array("cList<Vertex,u32>", "I", "float", "f",
                       np.asarray(m.face_normals, np.float32).reshape(-1, 3))
        _point2_array(a, "cList<TexCoord,u32>", "I", m.face_texcoords)
        a.clist_raw("cList<TexIndex=u8,u32>", "I", np.uint8,
                    np.asarray(m.face_texindices, np.uint8))
        n_tex = len(m.textures)
        a.clist_objects("cList<Image8U3,u8>", "B", n_tex)
        for t in m.textures:
            _image8u3(a, t)
        return None
    out = ProjectMesh()
    out.vertices = a.point3_array("cList<Vertex,u32>", "I", "float", "f")
    out.faces = a.point3_array("cList<Face,u32>", "I", "uint32_t", "I")
    out.vertex_normals = a.point3_array("cList<Vertex,u32>", "I", "float", "f")
    out.vertex_vertices = a.nested_u32_lists(
        "cList<VIdxArr,u32>", "I", "cList<u32,grow8>", "I", np.uint32)
    out.vertex_faces = a.nested_u32_lists(
        "cList<VIdxArr,u32>", "I", "cList<u32,grow8>", "I", np.uint32)
    out.vertex_boundary = a.clist_raw("cList<bool>", "Q", np.uint8).astype(bool)
    out.face_normals = a.point3_array("cList<Vertex,u32>", "I", "float", "f")
    out.face_texcoords = _point2_array(a, "cList<TexCoord,u32>", "I")
    out.face_texindices = a.clist_raw("cList<TexIndex=u8,u32>", "I", np.uint8)
    n_tex = a.clist_objects("cList<Image8U3,u8>", "B", None)
    out.textures = [_image8u3(a) for _ in range(n_tex)]
    return out


def _obb(a: _Archive, ps: Optional[ProjectScene]):
    """TOBB<float,3>: m_rot, m_pos (center), m_ext (OBB.h:45-47,112-116)."""
    a.preamble("SEACAVE::TOBB<float,3>")
    if a.writing:
        a.matx("float", "f", 3, 3, ps.obb_rot)
        a.point3("float", "f", ps.obb_pos)
        a.point3("float", "f", ps.obb_ext)
        return None
    rot = a.matx("float", "f", 3, 3)
    pos = a.point3("float", "f")
    ext = a.point3("float", "f")
    return (np.asarray(rot, np.float32), np.asarray(pos, np.float32),
            np.asarray(ext, np.float32))


def _scene_body(a: _Archive, ps: Optional[ProjectScene],
                base_dir: str = ".") -> Optional[ProjectScene]:
    a.preamble("MVS::Scene")
    if a.writing:
        _platforms(a, ps.platforms)
        _images(a, ps.images, base_dir)
        _pointcloud(a, ps)
        _mesh(a, ps.mesh)
        _obb(a, ps)
        return None
    out = ProjectScene()
    out.platforms = _platforms(a)
    out.images = _images(a)
    (out.points, out.point_views, out.point_weights,
     out.normals, out.colors) = _pointcloud(a, None)
    out.mesh = _mesh(a, None)
    out.obb_rot, out.obb_pos, out.obb_ext = _obb(a, None)
    return out


def _make_rel(path: str, base_dir: str) -> str:
    """Store image paths relative to the archive folder when possible
    (MAKE_PATH_REL in Image::save, Image.h:117-119)."""
    if not path or not os.path.isabs(path):
        return path
    try:
        rel = os.path.relpath(path, base_dir)
    except ValueError:
        return path
    return path if rel.startswith("..") else rel


# ------------------------------------------------------------------ top level


def is_project(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == PROJECT_MAGIC
    except OSError:
        return False


def load_project(path: str) -> ProjectScene:
    """Load a reference 'MVS project' archive (Scene.cpp:526-575)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != PROJECT_MAGIC:
        raise UnsupportedArchive("not an MVS project archive: %s" % path)
    ver, atype = struct.unpack_from("<II", raw, 4)
    if ver != PROJECT_VERSION:
        raise UnsupportedArchive(
            "unsupported project version %d (expected %d)" % (ver, PROJECT_VERSION))
    payload = raw[20:]
    if atype == ARCHIVE_BINARY:
        reader = _BinReader(payload)
    elif atype == ARCHIVE_BINARY_ZIP:
        try:
            reader = _BinReader(zlib.decompress(payload))
        except zlib.error as e:
            raise UnsupportedArchive("corrupt zlib stream in %s" % path) from e
    elif atype == ARCHIVE_BINARY_ZSTD:
        reader = _BinReader(_zstd().decompress(payload))
    elif atype == ARCHIVE_TEXT:
        reader = _TextReader(payload)
    else:
        raise UnsupportedArchive(
            "unknown archive type %d in %s; supported: 0 (text), 1 (binary), "
            "2 (zlib), 3 (zstd). Re-export from OpenMVS as an MVSI interface "
            "file if this was written by a newer OpenMVS" % (atype, path))
    a = _Archive(reader, writing=False)
    ps = _scene_body(a, None)
    base = os.path.dirname(os.path.abspath(path))
    for im in ps.images:
        if im.name and not os.path.isabs(im.name):
            im.name = os.path.join(base, im.name)
        if im.mask_name and not os.path.isabs(im.mask_name):
            im.mask_name = os.path.join(base, im.mask_name)
    return ps


def save_project(ps: ProjectScene, path: str, archive_type="zstd"):
    """Write a reference-compatible 'MVS project' archive."""
    if isinstance(archive_type, str):
        try:
            atype = _ARCHIVE_NAMES[archive_type.lower()]
        except KeyError:
            raise ValueError("archive_type must be one of %s"
                             % sorted(_ARCHIVE_NAMES)) from None
    else:
        atype = int(archive_type)
    writer = _TextWriter() if atype == ARCHIVE_TEXT else _BinWriter()
    a = _Archive(writer, writing=True)
    _scene_body(a, ps, base_dir=os.path.dirname(os.path.abspath(path)))
    payload = writer.getvalue()
    if atype == ARCHIVE_BINARY_ZIP:
        payload = zlib.compress(payload, 1)
    elif atype == ARCHIVE_BINARY_ZSTD:
        payload = _zstd().compress(payload)
    elif atype not in (ARCHIVE_BINARY, ARCHIVE_TEXT):
        raise ValueError("unsupported archive type %d" % atype)
    with open(path, "wb") as f:
        f.write(PROJECT_MAGIC)
        f.write(struct.pack("<IIQ", PROJECT_VERSION, atype, 0))
        f.write(payload)
