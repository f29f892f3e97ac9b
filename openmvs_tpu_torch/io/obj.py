"""Wavefront OBJ + MTL writer/reader for textured meshes.

A copy of the JAX package's ``openmvs_tpu/io/obj.py`` with its atlas pages
written and read by ``io/png`` in place of PIL, so files cross between the
packages both ways. Role equivalent of the reference's OBJ backend
(libs/IO/OBJ.{h,cpp}) as used by Mesh::Save for textured outputs: OBJ with
per-face-corner vt indices, an MTL referencing the atlas PNG.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from openmvs_tpu_torch.io import png


def save_mesh_obj(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    face_tex_coords: Optional[np.ndarray] = None,  # (nf, 3, 2)
    texture: Optional[np.ndarray] = None,          # (th, tw, 3) uint8
    textures: Optional[list] = None,               # multi-page atlases
    face_page: Optional[np.ndarray] = None,        # (nf,) page per face
):
    base = os.path.splitext(path)[0]
    name = os.path.basename(base)
    has_tex = face_tex_coords is not None and (texture is not None or textures)
    pages = textures if textures else ([texture] if texture is not None else [])
    fp = (np.asarray(face_page, np.int64) if face_page is not None
          else np.zeros(len(faces), np.int64))
    with open(path, "w") as f:
        f.write("# generated by openmvs_tpu\n")
        if has_tex:
            f.write(f"mtllib {name}.mtl\n")
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if has_tex:
            tc = face_tex_coords.reshape(-1, 2)
            for t in tc:
                f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
            # group faces per material page (multi-texture support, as the
            # reference's OBJ writer does for multiple atlases)
            for pg in range(len(pages)):
                sel = np.nonzero(fp == pg)[0]
                if len(sel) == 0:
                    continue
                f.write(f"usemtl {name}{'' if pg == 0 else f'_{pg}'}\n")
                for i in sel:
                    a, b, c = faces[i] + 1
                    f.write(f"f {a}/{3*i+1} {b}/{3*i+2} {c}/{3*i+3}\n")
        else:
            for face in faces:
                a, b, c = face + 1
                f.write(f"f {a} {b} {c}\n")
    if has_tex:
        with open(base + ".mtl", "w") as f:
            for pg, img in enumerate(pages):
                suffix = "" if pg == 0 else f"_{pg}"
                f.write(
                    f"newmtl {name}{suffix}\nKa 1 1 1\nKd 1 1 1\nKs 0 0 0\n"
                    f"d 1\nNs 0\nillum 1\nmap_Kd {name}{suffix}.png\n"
                )
                png.write(base + suffix + ".png", img)


def _load_page(path: str) -> np.ndarray:
    """An atlas page as (h, w, 3) RGB: PNG through ``io/png``, any other
    format through ``io/images.load_color`` (PIL), as the JAX package
    decodes every page with PIL."""
    if os.path.splitext(path)[1].lower() == ".png":
        return png.to_rgb(png.read(path))
    from openmvs_tpu_torch.io.images import load_color

    return load_color(path)


def load_mesh_obj(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Returns (vertices, faces, face_tex_coords, texture)."""
    verts, tcs, faces, ftc_idx = [], [], [], []
    mtl_tex = None
    folder = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
            elif t[0] == "vt":
                tcs.append([float(x) for x in t[1:3]])
            elif t[0] == "f":
                vs, ts = [], []
                for tok in t[1:]:
                    parts = tok.split("/")
                    vs.append(int(parts[0]) - 1)
                    if len(parts) > 1 and parts[1]:
                        ts.append(int(parts[1]) - 1)
                # polygons (quads etc.) fan-triangulate instead of silently
                # dropping everything past the first three corners
                for k in range(1, len(vs) - 1):
                    faces.append([vs[0], vs[k], vs[k + 1]])
                    ftc_idx.append([ts[0], ts[k], ts[k + 1]]
                                   if len(ts) == len(vs) else None)
            elif t[0] == "mtllib":
                mtl_path = os.path.join(folder, t[1])
                if os.path.exists(mtl_path):
                    for ml in open(mtl_path):
                        mt = ml.split()
                        if mt and mt[0] == "map_Kd":
                            img_path = os.path.join(folder, mt[1])
                            if os.path.exists(img_path):
                                mtl_tex = _load_page(img_path)
    verts = np.asarray(verts, np.float32)
    faces_np = np.asarray(faces, np.int32)
    ftc = None
    if tcs and all(x is not None for x in ftc_idx):
        tcs_np = np.asarray(tcs, np.float32)
        ftc = tcs_np[np.asarray(ftc_idx, np.int64)]
    return verts, faces_np, ftc, mtl_tex
