"""Reader and writer of the ``.mvs`` interchange stream (Interface v7).

A copy of ``openmvs_tpu/io/mvs.py``: bit-compatible with the reference's
self-contained interchange header (libs/MVS/Interface.h:15-16 magic 'MVSI'
version 7; Platform/Camera/Pose Interface.h:380-464; Image
Interface.h:523-580; Vertex Interface.h:585-608; lines/normals/colors/
transform/OBB Interface.h:683-693), cross-checked against the reference's
own numpy loader (scripts/python/MvsUtils.py:74-187).

Wire format (little-endian):
  'MVSI' | u32 version | u32 reserved
  strings  -> u64 size + bytes
  lists    -> u64 count + items
  matrices -> row-major float64
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, List, Optional

import numpy as np

MAGIC = b"MVSI"
VERSION = 7


# ---------------------------------------------------------------- data model


@dataclass
class CameraRig:
    """A camera mounted on a platform (Interface.h:382-394)."""

    name: str = ""
    band_name: str = ""
    width: int = 0
    height: int = 0
    K: np.ndarray = field(default_factory=lambda: np.eye(3))
    R: np.ndarray = field(default_factory=lambda: np.eye(3))  # relative to platform
    C: np.ndarray = field(default_factory=lambda: np.zeros(3))

    @property
    def has_resolution(self) -> bool:
        return self.width > 0 and self.height > 0


@dataclass
class Pose:
    R: np.ndarray = field(default_factory=lambda: np.eye(3))
    C: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class Platform:
    name: str = ""
    cameras: List[CameraRig] = field(default_factory=list)
    poses: List[Pose] = field(default_factory=list)


@dataclass
class ViewScore:
    """Scored neighbor view (Interface.h:527-544)."""

    id: int = 0
    points: int = 0
    scale: float = 0.0
    angle: float = 0.0
    area: float = 0.0
    score: float = 0.0


@dataclass
class ImageMeta:
    name: str = ""
    mask_name: str = ""
    platform_id: int = 0
    camera_id: int = 0
    pose_id: int = 0
    id: int = 0xFFFFFFFF
    min_depth: float = 0.0
    avg_depth: float = 0.0
    max_depth: float = 0.0
    view_scores: List[ViewScore] = field(default_factory=list)


@dataclass
class Interface:
    """In-memory image of one .mvs stream."""

    platforms: List[Platform] = field(default_factory=list)
    images: List[ImageMeta] = field(default_factory=list)
    # vertices as SoA; views per vertex ragged
    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    point_views: List[np.ndarray] = field(default_factory=list)   # each (k,) uint32
    point_confidences: List[np.ndarray] = field(default_factory=list)  # each (k,) f32
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint8))
    # lines (unused by the pipeline but preserved)
    lines: list = field(default_factory=list)
    line_normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    line_colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint8))
    transform: np.ndarray = field(default_factory=lambda: np.eye(4))
    obb_rot: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    obb_min: np.ndarray = field(default_factory=lambda: np.zeros(3))
    obb_max: np.ndarray = field(default_factory=lambda: np.zeros(3))
    version: int = VERSION


# ---------------------------------------------------------------- primitives


def _rd(f: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    data = f.read(size)
    if len(data) != size:
        raise EOFError("truncated .mvs stream")
    return struct.unpack("<" + fmt, data)


def _rd_str(f: BinaryIO) -> str:
    (n,) = _rd(f, "Q")
    return f.read(n).decode("utf-8", "replace")


def _rd_mat(f: BinaryIO, rows: int, cols: int, dtype="d") -> np.ndarray:
    n = rows * cols
    arr = np.frombuffer(f.read(n * (8 if dtype == "d" else 4)), dtype=np.float64 if dtype == "d" else np.float32)
    return arr.reshape(rows, cols).copy()


def _wr(f: BinaryIO, fmt: str, *vals):
    f.write(struct.pack("<" + fmt, *vals))


def _wr_str(f: BinaryIO, s: str):
    b = s.encode("utf-8")
    _wr(f, "Q", len(b))
    f.write(b)


def _wr_mat(f: BinaryIO, a: np.ndarray, dtype=np.float64):
    f.write(np.ascontiguousarray(a, dtype).tobytes())


# ---------------------------------------------------------------- load


def load(path: str) -> Interface:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise ValueError(f"{path}: not an MVSI stream (magic={magic!r})")
        (version,) = _rd(f, "I")
        if version > VERSION:
            raise ValueError(f"{path}: unsupported MVSI version {version}")
        _rd(f, "I")  # reserved
        itf = Interface(version=version)

        (n_platforms,) = _rd(f, "Q")
        for _ in range(n_platforms):
            plat = Platform(name=_rd_str(f))
            (n_cameras,) = _rd(f, "Q")
            for _ in range(n_cameras):
                cam = CameraRig(name=_rd_str(f))
                if version > 3:
                    cam.band_name = _rd_str(f)
                if version > 0:
                    cam.width, cam.height = _rd(f, "II")
                cam.K = _rd_mat(f, 3, 3)
                cam.R = _rd_mat(f, 3, 3)
                cam.C = _rd_mat(f, 1, 3).reshape(3)
                plat.cameras.append(cam)
            (n_poses,) = _rd(f, "Q")
            for _ in range(n_poses):
                R = _rd_mat(f, 3, 3)
                C = _rd_mat(f, 1, 3).reshape(3)
                plat.poses.append(Pose(R=R, C=C))
            itf.platforms.append(plat)

        (n_images,) = _rd(f, "Q")
        for _ in range(n_images):
            im = ImageMeta(name=_rd_str(f))
            if version > 4:
                im.mask_name = _rd_str(f)
            im.platform_id, im.camera_id, im.pose_id = _rd(f, "III")
            if version > 2:
                (im.id,) = _rd(f, "I")
            if version > 6:
                im.min_depth, im.avg_depth, im.max_depth = _rd(f, "fff")
                (n_scores,) = _rd(f, "Q")
                for _ in range(n_scores):
                    vid, pts = _rd(f, "II")
                    scale, angle, area, score = _rd(f, "ffff")
                    im.view_scores.append(ViewScore(vid, pts, scale, angle, area, score))
            itf.images.append(im)

        (n_vertices,) = _rd(f, "Q")
        # vectorized vertex-block parse: records are [12B xyz][8B count]
        # [count x (u4,f4)].  A per-vertex read/struct loop costs minutes at
        # dense-cloud sizes; here one read + a light offset walk + two
        # masked gathers do the same work at C speed.
        blob = f.read()
        mv = memoryview(blob)
        starts = np.empty(n_vertices, np.int64)
        counts = np.empty(n_vertices, np.int64)
        pos = 0
        for i in range(n_vertices):
            starts[i] = pos
            c = int.from_bytes(mv[pos + 12:pos + 20], "little")
            counts[i] = c
            pos += 20 + 8 * c
        u8 = np.frombuffer(blob, np.uint8, pos)
        marks = np.zeros(pos + 1, np.int8)
        marks[starts] += 1          # unique indices: fancy assignment beats
        marks[starts + 20] -= 1     # ufunc.at by ~40x at this size
        np.cumsum(marks[:-1], dtype=np.int8, out=marks[:-1])  # in place
        hdr_mask = marks[:-1].view(bool)
        # masked gathers are fresh contiguous arrays: reinterpret with
        # .view() instead of a tobytes() copy (halves transient memory)
        hdr = u8[hdr_mask].view(
            np.dtype([("xyz", "<f4", (3,)), ("cnt", "<u8")]))
        pts = hdr["xyz"].astype(np.float32).reshape(-1, 3)
        recs = u8[~hdr_mask].view(np.dtype("<u4, <f4"))
        allv = np.ascontiguousarray(recs["f0"], np.uint32)
        allc = np.ascontiguousarray(recs["f1"], np.float32)
        split = np.cumsum(counts)[:-1]
        views = np.split(allv, split) if n_vertices else []
        confs = np.split(allc, split) if n_vertices else []
        # hand the remaining (non-vertex) bytes back to the stream
        f.seek(f.tell() - (len(blob) - pos))
        itf.points, itf.point_views, itf.point_confidences = pts, views, confs

        (n_normals,) = _rd(f, "Q")
        itf.normals = np.frombuffer(f.read(12 * n_normals), np.float32).reshape(-1, 3).copy()
        (n_colors,) = _rd(f, "Q")
        itf.colors = np.frombuffer(f.read(3 * n_colors), np.uint8).reshape(-1, 3).copy()

        if version > 0:
            (n_lines,) = _rd(f, "Q")
            for _ in range(n_lines):
                pt1 = _rd(f, "fff")
                pt2 = _rd(f, "fff")
                (n_views,) = _rd(f, "Q")
                raw = np.frombuffer(f.read(8 * n_views), dtype=np.dtype("<u4, <f4"))
                itf.lines.append((pt1, pt2, raw["f0"].astype(np.uint32), raw["f1"].astype(np.float32)))
            (n_ln,) = _rd(f, "Q")
            itf.line_normals = np.frombuffer(f.read(12 * n_ln), np.float32).reshape(-1, 3).copy()
            (n_lc,) = _rd(f, "Q")
            itf.line_colors = np.frombuffer(f.read(3 * n_lc), np.uint8).reshape(-1, 3).copy()
            if version > 1:
                itf.transform = _rd_mat(f, 4, 4)
                if version > 5:
                    itf.obb_rot = _rd_mat(f, 3, 3)
                    itf.obb_min = _rd_mat(f, 1, 3).reshape(3)
                    itf.obb_max = _rd_mat(f, 1, 3).reshape(3)
    return itf


# ---------------------------------------------------------------- save


def save(itf: Interface, path: str):
    with open(path, "wb") as f:
        f.write(MAGIC)
        _wr(f, "I", VERSION)
        _wr(f, "I", 0)

        _wr(f, "Q", len(itf.platforms))
        for plat in itf.platforms:
            _wr_str(f, plat.name)
            _wr(f, "Q", len(plat.cameras))
            for cam in plat.cameras:
                _wr_str(f, cam.name)
                _wr_str(f, cam.band_name)
                _wr(f, "II", cam.width, cam.height)
                _wr_mat(f, cam.K)
                _wr_mat(f, cam.R)
                _wr_mat(f, cam.C)
            _wr(f, "Q", len(plat.poses))
            for pose in plat.poses:
                _wr_mat(f, pose.R)
                _wr_mat(f, pose.C)

        _wr(f, "Q", len(itf.images))
        for im in itf.images:
            _wr_str(f, im.name)
            _wr_str(f, im.mask_name)
            _wr(f, "III", im.platform_id, im.camera_id, im.pose_id)
            _wr(f, "I", im.id & 0xFFFFFFFF)
            _wr(f, "fff", im.min_depth, im.avg_depth, im.max_depth)
            _wr(f, "Q", len(im.view_scores))
            for vs in im.view_scores:
                _wr(f, "II", vs.id, vs.points)
                _wr(f, "ffff", vs.scale, vs.angle, vs.area, vs.score)

        n = len(itf.points)
        _wr(f, "Q", n)
        pts = np.ascontiguousarray(itf.points, np.float32)
        # vectorized vertex-block write (mirror of the load-side layout)
        vs_list: List[np.ndarray] = []
        cf_list: List[np.ndarray] = []
        for i in range(n):
            vi = itf.point_views[i] if i < len(itf.point_views) else np.zeros(0, np.uint32)
            ci = (
                itf.point_confidences[i]
                if i < len(itf.point_confidences) and len(itf.point_confidences[i]) == len(vi)
                else np.zeros(len(vi), np.float32)
            )
            vs_list.append(vi)
            cf_list.append(ci)
        counts = np.fromiter((len(v) for v in vs_list), np.int64, n)
        total = int(counts.sum())
        hdr = np.empty(n, np.dtype([("xyz", "<f4", (3,)), ("cnt", "<u8")]))
        hdr["xyz"] = pts.reshape(-1, 3) if n else pts
        hdr["cnt"] = counts
        rec = np.empty(total, np.dtype("<u4, <f4"))
        if total:
            rec["f0"] = np.concatenate(vs_list)
            rec["f1"] = np.concatenate(cf_list)
        out = np.empty(20 * n + 8 * total, np.uint8)
        if n:
            starts = 20 * np.arange(n, dtype=np.int64) + 8 * (
                np.cumsum(counts) - counts)
            marks = np.zeros(len(out) + 1, np.int8)
            marks[starts] += 1
            marks[starts + 20] -= 1
            np.cumsum(marks[:-1], dtype=np.int8, out=marks[:-1])
            hdr_mask = marks[:-1].view(bool)
            out[hdr_mask] = hdr.view(np.uint8)
            out[~hdr_mask] = rec.view(np.uint8)
        f.write(out.tobytes())

        _wr(f, "Q", len(itf.normals))
        _wr_mat(f, itf.normals, np.float32)
        _wr(f, "Q", len(itf.colors))
        f.write(np.ascontiguousarray(itf.colors, np.uint8).tobytes())

        _wr(f, "Q", len(itf.lines))
        for pt1, pt2, vids, confs in itf.lines:
            _wr(f, "fff", *pt1)
            _wr(f, "fff", *pt2)
            _wr(f, "Q", len(vids))
            raw = np.empty(len(vids), dtype=np.dtype("<u4, <f4"))
            raw["f0"] = vids
            raw["f1"] = confs
            f.write(raw.tobytes())
        _wr(f, "Q", len(itf.line_normals))
        _wr_mat(f, itf.line_normals, np.float32)
        _wr(f, "Q", len(itf.line_colors))
        f.write(np.ascontiguousarray(itf.line_colors, np.uint8).tobytes())

        _wr_mat(f, itf.transform)
        _wr_mat(f, itf.obb_rot)
        _wr_mat(f, itf.obb_min)
        _wr_mat(f, itf.obb_max)
