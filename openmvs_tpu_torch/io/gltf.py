"""Minimal binary glTF 2.0 (.glb) mesh export.

A copy of ``openmvs_tpu/io/gltf.py``, the reference's glTF backend's role
(libs/IO vendored tiny_gltf.h used by Mesh::Save for .glb outputs): one
mesh with POSITION, optional TEXCOORD_0 + embedded PNG texture pages (one
primitive and material per page), uint32 indices. The pages are encoded by
``io/png`` where the JAX package uses PIL; ``load_mesh_glb`` reads the
geometry back, as the JAX package's does.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

from openmvs_tpu_torch.io import png


def save_mesh_glb(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    face_tex_coords: Optional[np.ndarray] = None,   # (nf, 3, 2)
    texture: Optional[np.ndarray] = None,           # (th, tw, 3) uint8
    textures: Optional[list] = None,                # multi-page atlases
    face_page: Optional[np.ndarray] = None,         # (nf,) page per face
):
    if len(vertices) == 0 or len(faces) == 0:
        raise ValueError("cannot write an empty mesh to glb")
    pages = (list(textures) if textures is not None
             else ([texture] if texture is not None else []))
    has_tex = face_tex_coords is not None and len(pages) > 0
    fp = (np.asarray(face_page, np.int64) if face_page is not None
          else np.zeros(len(faces), np.int64))
    if has_tex:
        # per-corner texcoords need per-corner vertices; faces grouped by
        # page so each page becomes its own primitive+material
        order = np.argsort(fp, kind="stable")
        v = vertices[faces[order].reshape(-1)].astype(np.float32)
        uv = face_tex_coords[order].reshape(-1, 2).astype(np.float32)
        uv = np.stack([uv[:, 0], 1.0 - uv[:, 1]], axis=-1)  # glTF v: top-down
        idx = np.arange(len(v), dtype=np.uint32)
        fp_sorted = fp[order]
    else:
        v = vertices.astype(np.float32)
        uv = None
        idx = faces.reshape(-1).astype(np.uint32)

    buffers = []
    views = []
    accessors = []

    def add(data: bytes, target: Optional[int]) -> int:
        off = sum(len(b) for b in buffers)
        pad = (-off) % 4
        if pad:
            buffers.append(b"\x00" * pad)
            off += pad
        buffers.append(data)
        view = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        views.append(view)
        return len(views) - 1

    pos_view = add(v.tobytes(), 34962)
    accessors.append({
        "bufferView": pos_view, "componentType": 5126, "count": len(v),
        "type": "VEC3", "min": v.min(axis=0).tolist(), "max": v.max(axis=0).tolist(),
    })
    attrs = {"POSITION": 0}
    if uv is not None:
        uv_view = add(uv.tobytes(), 34962)
        accessors.append({"bufferView": uv_view, "componentType": 5126,
                          "count": len(uv), "type": "VEC2"})
        attrs["TEXCOORD_0"] = len(accessors) - 1
    # one index accessor (and primitive) per atlas page
    prims = []
    if has_tex and len(pages) > 1:
        page_of_face = fp_sorted
        bounds = np.searchsorted(page_of_face,
                                 np.arange(len(pages) + 1))
        ranges = [(int(bounds[p]) * 3, int(bounds[p + 1]) * 3, p)
                  for p in range(len(pages)) if bounds[p + 1] > bounds[p]]
    else:
        ranges = [(0, len(idx), 0)]
    for lo_i, hi_i, page in ranges:
        idx_view = add(idx[lo_i:hi_i].tobytes(), 34963)
        accessors.append({"bufferView": idx_view, "componentType": 5125,
                          "count": hi_i - lo_i, "type": "SCALAR"})
        prims.append({"attributes": attrs, "indices": len(accessors) - 1,
                      "mode": 4, "_page": page})

    doc = {
        "asset": {"version": "2.0", "generator": "openmvs_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": prims}],
        "bufferViews": views,
        "accessors": accessors,
    }
    if has_tex:
        doc["images"] = []
        doc["samplers"] = [{"magFilter": 9729, "minFilter": 9729}]
        doc["textures"] = []
        doc["materials"] = []
        for pg, img_arr in enumerate(pages):
            img_view = add(png.encode(img_arr), None)
            doc["images"].append({"bufferView": img_view,
                                  "mimeType": "image/png"})
            doc["textures"].append({"source": pg, "sampler": 0})
            doc["materials"].append({"pbrMetallicRoughness": {
                "baseColorTexture": {"index": pg},
                "metallicFactor": 0.0, "roughnessFactor": 1.0}})
        for prim in prims:
            prim["material"] = prim.pop("_page")
    else:
        for prim in prims:
            prim.pop("_page", None)

    bin_chunk = b"".join(buffers)
    bin_chunk += b"\x00" * ((-len(bin_chunk)) % 4)
    doc["buffers"] = [{"byteLength": len(bin_chunk)}]
    json_chunk = json.dumps(doc).encode()
    json_chunk += b" " * ((-len(json_chunk)) % 4)

    with open(path, "wb") as f:
        total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)


def load_mesh_glb(path: str):
    """Returns (vertices, faces) of the first primitive (validation helper)."""
    with open(path, "rb") as f:
        magic, version, _ = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67 and version == 2
        jlen, jtype = struct.unpack("<II", f.read(8))
        doc = json.loads(f.read(jlen))
        blen, btype = struct.unpack("<II", f.read(8))
        blob = f.read(blen)
    prim = doc["meshes"][0]["primitives"][0]

    def read_acc(ai):
        acc = doc["accessors"][ai]
        view = doc["bufferViews"][acc["bufferView"]]
        off = view.get("byteOffset", 0)
        comp = {5126: np.float32, 5125: np.uint32, 5123: np.uint16}[acc["componentType"]]
        n = {"VEC3": 3, "VEC2": 2, "SCALAR": 1}[acc["type"]]
        a = np.frombuffer(blob, comp, count=acc["count"] * n, offset=off)
        return a.reshape(acc["count"], n) if n > 1 else a

    v = read_acc(prim["attributes"]["POSITION"])
    idx = read_acc(prim["indices"]).reshape(-1, 3)
    return v, idx
