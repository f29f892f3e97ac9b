"""Minimal, fast PLY reader/writer (binary little-endian + ascii).

A copy of the JAX package's ``openmvs_tpu/io/ply.py``: files cross between
the packages both ways. Covers the property sets the reference
emits/consumes for point clouds and meshes (libs/IO/PLY.h usage in
PointCloud.cpp:Save/Load and Mesh.cpp:Save): vertex x/y/z [+ nx/ny/nz]
[+ red/green/blue] [+ value (confidence)], face vertex_indices, and optional
texture coordinates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class PlyData:
    """Parsed elements: name -> dict of property arrays (or list arrays)."""

    elements: Dict[str, Dict[str, np.ndarray]] = field(default_factory=dict)
    comments: List[str] = field(default_factory=list)

    @property
    def vertices(self) -> Optional[np.ndarray]:
        v = self.elements.get("vertex")
        if v is None:
            return None
        return np.stack([v["x"], v["y"], v["z"]], axis=-1)

    @property
    def faces(self) -> Optional[np.ndarray]:
        fdata = self.elements.get("face")
        if fdata is None:
            return None
        for key in ("vertex_indices", "vertex_index"):
            if key in fdata:
                return fdata[key]
        return None


def save_point_cloud(
    path: str,
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    confidences: Optional[np.ndarray] = None,
    comments: Tuple[str, ...] = (),
):
    """Binary-LE PLY point cloud with the reference's property layout."""
    n = len(points)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    header_props = ["property float x", "property float y", "property float z"]
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        header_props += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header_props += ["property uchar red", "property uchar green", "property uchar blue"]
    if confidences is not None:
        fields += [("value", "<f4")]
        header_props += ["property float value"]
    rec = np.empty(n, dtype=np.dtype(fields))
    pts = np.asarray(points, np.float32)
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if normals is not None:
        nr = np.asarray(normals, np.float32)
        rec["nx"], rec["ny"], rec["nz"] = nr[:, 0], nr[:, 1], nr[:, 2]
    if colors is not None:
        cl = np.asarray(colors, np.uint8)
        rec["red"], rec["green"], rec["blue"] = cl[:, 0], cl[:, 1], cl[:, 2]
    if confidences is not None:
        rec["value"] = np.asarray(confidences, np.float32)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0"]
        header += [f"comment {c}" for c in comments]
        header += [f"element vertex {n}"] + header_props + ["end_header"]
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())


def save_mesh(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
    comments: Tuple[str, ...] = (),
):
    """Binary-LE PLY triangle mesh."""
    nv, nf = len(vertices), len(faces)
    vfields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    vprops = ["property float x", "property float y", "property float z"]
    if colors is not None:
        vfields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        vprops += ["property uchar red", "property uchar green", "property uchar blue"]
    vrec = np.empty(nv, dtype=np.dtype(vfields))
    verts = np.asarray(vertices, np.float32)
    vrec["x"], vrec["y"], vrec["z"] = verts[:, 0], verts[:, 1], verts[:, 2]
    if colors is not None:
        cl = np.asarray(colors, np.uint8)
        vrec["red"], vrec["green"], vrec["blue"] = cl[:, 0], cl[:, 1], cl[:, 2]
    frec = np.empty(nf, dtype=np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
    frec["n"] = 3
    frec["v"] = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0"]
        header += [f"comment {c}" for c in comments]
        header += [f"element vertex {nv}"] + vprops
        header += [f"element face {nf}", "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(header) + "\n").encode())
        f.write(vrec.tobytes())
        f.write(frec.tobytes())


def load(path: str) -> PlyData:
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, list]] = []
        comments: List[str] = []
        while True:
            line = f.readline()
            if not line:
                raise EOFError("truncated PLY header")
            tokens = line.split()
            if not tokens:
                continue
            key = tokens[0]
            if key == b"format":
                fmt = tokens[1].decode()
            elif key == b"comment":
                comments.append(line.decode(errors="replace").strip()[8:])
            elif key == b"element":
                elements.append((tokens[1].decode(), int(tokens[2]), []))
            elif key == b"property":
                if tokens[1] == b"list":
                    elements[-1][2].append(
                        (tokens[4].decode(), "list", _PLY_TO_NP[tokens[2].decode()], _PLY_TO_NP[tokens[3].decode()])
                    )
                else:
                    elements[-1][2].append((tokens[2].decode(), "scalar", _PLY_TO_NP[tokens[1].decode()], None))
            elif key == b"end_header":
                break
        out = PlyData(comments=comments)
        if fmt == "ascii":
            _load_ascii(f, elements, out)
        else:
            endian = "<" if "little" in fmt else ">"
            _load_binary(f, elements, out, endian)
        return out


def _fan_triangulate(lists) -> np.ndarray:
    """Ragged per-face index lists -> (n, 3) triangles (quads and larger
    polygons fan around their first vertex).  Keeping the loader's output
    uniformly triangular means every consumer (Scene, viewer, CLI mesh
    flags) handles polygon PLYs without special cases."""
    tris = []
    for f in lists:
        f = np.asarray(f, np.int64)
        for k in range(1, len(f) - 1):
            tris.append((f[0], f[k], f[k + 1]))
    return (np.asarray(tris, np.int64) if tris
            else np.zeros((0, 3), np.int64))


def _load_binary(f, elements, out: PlyData, endian: str):
    for name, count, props in elements:
        is_fixed = all(kind == "scalar" for _, kind, _, _ in props)
        if is_fixed:
            dt = np.dtype([(pname, endian + pt) for pname, _, pt, _ in props])
            raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
            out.elements[name] = {pname: raw[pname].copy() for pname, _, _, _ in props}
        elif len(props) == 1 and props[0][1] == "list":
            pname, _, count_t, item_t = props[0]
            cdt = np.dtype(endian + count_t)
            idt = np.dtype(endian + item_t)
            if count == 0:
                out.elements[name] = {pname: np.zeros((0, 3), np.int64)}
                continue
            # fast path: uniform triangle lists
            first = np.frombuffer(f.read(cdt.itemsize), cdt)
            buf = None
            if len(first) and first[0] == 3:
                rec = np.dtype([("n", endian + count_t), ("v", endian + item_t, (3,))])
                rest = np.frombuffer(f.read(rec.itemsize * count - cdt.itemsize), np.uint8)
                buf = np.concatenate([np.frombuffer(np.array(first).tobytes(), np.uint8), rest])
                if len(buf) == rec.itemsize * count:
                    raw = np.frombuffer(buf.tobytes(), dtype=rec, count=count)
                    if (raw["n"] == 3).all():
                        out.elements[name] = {pname: raw["v"].astype(np.int64)}
                        continue
            # ragged polygon lists: parse sequentially from the bytes read
            # so far plus the rest of the stream, then restore the stream
            # position for any subsequent element
            head = (buf.tobytes() if buf is not None
                    else np.asarray(first).tobytes())
            blob = head + f.read()
            pos = 0
            lists = []
            for _ in range(count):
                n_ = int(np.frombuffer(blob, cdt, 1, pos)[0])
                pos += cdt.itemsize
                lists.append(np.frombuffer(blob, idt, n_, pos).astype(np.int64))
                pos += idt.itemsize * n_
            f.seek(f.tell() - (len(blob) - pos))
            out.elements[name] = {pname: _fan_triangulate(lists)}
        else:
            # general mixed scalar+list rows: parse row by row
            rows = {pname: [] for pname, _, _, _ in props}
            for _ in range(count):
                for pname, kind, pt, item_t in props:
                    if kind == "scalar":
                        rows[pname].append(np.frombuffer(f.read(np.dtype(pt).itemsize), endian + pt)[0])
                    else:
                        (k,) = np.frombuffer(f.read(np.dtype(pt).itemsize), endian + pt)
                        rows[pname].append(np.frombuffer(f.read(int(k) * np.dtype(item_t).itemsize), endian + item_t))
            out.elements[name] = {k: np.asarray(v) for k, v in rows.items()}


def _load_ascii(f, elements, out: PlyData):
    for name, count, props in elements:
        rows = {pname: [] for pname, _, _, _ in props}
        for _ in range(count):
            vals = f.readline().split()
            i = 0
            for pname, kind, pt, item_t in props:
                if kind == "scalar":
                    rows[pname].append(float(vals[i]))
                    i += 1
                else:
                    k = int(vals[i])
                    rows[pname].append(np.array(vals[i + 1 : i + 1 + k], dtype=item_t))
                    i += 1 + k
        kinds = {pname: kind for pname, kind, _, _ in props}

        def _pack(k, v):
            if not len(v) or not isinstance(v[0], np.ndarray):
                return np.asarray(v)
            uniform = all(len(x) == len(v[0]) for x in v)
            # index lists that are not triangles (ragged, or uniform quads+)
            # fan-triangulate; non-integer lists (e.g. texcoords) stack as-is
            if (kinds.get(k) == "list"
                    and np.issubdtype(np.asarray(v[0]).dtype, np.integer)
                    and (not uniform or len(v[0]) != 3)):
                return _fan_triangulate(v)
            if uniform:
                return np.stack(v)
            return _fan_triangulate(v)

        out.elements[name] = {k: _pack(k, v) for k, v in rows.items()}
