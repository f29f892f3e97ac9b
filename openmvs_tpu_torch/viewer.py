"""Headless scene viewer: turntable renders of point clouds and meshes
(a copy of ``openmvs_tpu/viewer.py``).

Role equivalent of the reference's GLFW/OpenGL Viewer app (apps/Viewer) for
a host without a display: frames are rasterized with the port's copy of the
native z-buffer rasterizer (textured or lambert-shaded) on the CPU and
written as PNGs (``io/images.write_image``), so any scene or mesh can be
inspected from a headless host.

  python -m openmvs_tpu_torch.viewer scene_dense.mvs -o snap.png
  python -m openmvs_tpu_torch.viewer mesh.obj --turntable 8 -o turns/
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from openmvs_tpu_torch import native
from openmvs_tpu_torch.io import images as imio
from openmvs_tpu_torch.scene import Mesh


def _auto_camera(points: np.ndarray, azimuth_deg: float, elevation_deg: float,
                 size: Tuple[int, int]):
    from openmvs_tpu_torch.geometry.camera import Camera

    c = points.mean(axis=0)
    r = np.percentile(np.linalg.norm(points - c, axis=1), 95) * 2.6
    az, el = np.radians(azimuth_deg), np.radians(elevation_deg)
    eye = c + r * np.array([np.cos(el) * np.sin(az), -np.sin(el), -np.cos(el) * np.cos(az)])
    z = c - eye
    z /= np.linalg.norm(z)
    up = np.array([0, -1.0, 0])
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-9:
        x = np.array([1.0, 0, 0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    W, H = size
    f = 1.1 * max(W, H)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    return Camera(K, R, eye)


def render_mesh(mesh: Mesh, azimuth_deg: float = 30.0, elevation_deg: float = 20.0,
                size: Tuple[int, int] = (1024, 768),
                bg: Tuple[int, int, int] = (24, 24, 28)) -> np.ndarray:
    """Single frame: textured if the mesh has an atlas, else lambert-shaded."""
    from openmvs_tpu_torch import mesh_ops

    cam = _auto_camera(mesh.vertices, azimuth_deg, elevation_deg, size)
    W, H = size
    Xc = (mesh.vertices - cam.C) @ cam.R.T
    uv = Xc @ cam.K.T
    z = Xc[:, 2]
    proj = np.stack([uv[:, 0] / np.maximum(uv[:, 2], 1e-9),
                     uv[:, 1] / np.maximum(uv[:, 2], 1e-9), z], axis=-1)
    fid, depth, bary = native.rasterize(proj, mesh.faces, H, W)
    frame = np.zeros((H, W, 3), np.uint8)
    frame[:] = bg
    hit = fid >= 0
    if not hit.any():
        return frame
    if mesh.has_texture:
        th, tw, _ = mesh.texture.shape
        tc = mesh.face_tex_coords[np.where(hit, fid, 0)]          # (H, W, 3, 2)
        uvp = np.einsum("hwkc,hwk->hwc", tc, bary)
        tx = np.clip((uvp[..., 0] * tw).astype(np.int64), 0, tw - 1)
        ty = np.clip(((1 - uvp[..., 1]) * th).astype(np.int64), 0, th - 1)
        frame[hit] = mesh.texture[ty[hit], tx[hit]]
    else:
        fn = mesh_ops.face_normals(mesh.vertices, mesh.faces)
        light = cam.R[2]                       # headlight
        lam = np.abs(fn @ light)
        shade = (60 + 180 * lam[np.where(hit, fid, 0)]).astype(np.uint8)
        frame[hit] = shade[hit][:, None]
    return frame


def render_point_cloud(points: np.ndarray, colors: Optional[np.ndarray] = None,
                       azimuth_deg: float = 30.0, elevation_deg: float = 20.0,
                       size: Tuple[int, int] = (1024, 768),
                       bg: Tuple[int, int, int] = (24, 24, 28)) -> np.ndarray:
    cam = _auto_camera(points, azimuth_deg, elevation_deg, size)
    W, H = size
    Xc = (points - cam.C) @ cam.R.T
    z = Xc[:, 2]
    ok = z > 1e-6
    u = (Xc[:, 0] / np.maximum(z, 1e-9) * cam.K[0, 0] + cam.K[0, 2]).astype(np.int64)
    v = (Xc[:, 1] / np.maximum(z, 1e-9) * cam.K[1, 1] + cam.K[1, 2]).astype(np.int64)
    ok &= (u >= 0) & (u < W) & (v >= 0) & (v < H)
    frame = np.zeros((H, W, 3), np.uint8)
    frame[:] = bg
    zbuf = np.full((H, W), np.inf, np.float32)
    order = np.argsort(-z[ok])  # far to near painter's fill
    uu, vv, zz = u[ok][order], v[ok][order], z[ok][order]
    cc = (colors[ok][order] if colors is not None and len(colors) == len(points)
          else np.full((ok.sum(), 3), 220, np.uint8))
    frame[vv, uu] = cc
    zbuf[vv, uu] = zz
    return frame


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="openmvs_tpu_torch.viewer")
    ap.add_argument("input", help=".mvs, .ply or .obj")
    ap.add_argument("-o", "--output", default="snapshot.png")
    ap.add_argument("--turntable", type=int, default=0,
                    help="render N frames around the model into a folder")
    ap.add_argument("--size", default="1024x768")
    args = ap.parse_args(argv)
    W, H = (int(x) for x in args.size.split("x"))

    ext = os.path.splitext(args.input)[1].lower()
    mesh = None
    points = colors = None
    if ext == ".mvs":
        from openmvs_tpu_torch.scene import Scene

        scene = Scene.load(args.input)
        points = np.asarray(scene.pointcloud.points)
        colors = np.asarray(scene.pointcloud.colors) if scene.pointcloud.has_colors else None
    elif ext == ".obj":
        from openmvs_tpu_torch.io.obj import load_mesh_obj

        v, f, ftc, tex = load_mesh_obj(args.input)
        mesh = Mesh(vertices=v, faces=f, face_tex_coords=ftc, texture=tex)
    else:
        from openmvs_tpu_torch.io import ply as plyio

        pd = plyio.load(args.input)
        if pd.faces is not None and len(pd.faces):
            mesh = Mesh(vertices=pd.vertices.astype(np.float32),
                        faces=pd.faces.astype(np.int32))
        else:
            points = pd.vertices
            ve = pd.elements.get("vertex", {})
            if "red" in ve:
                colors = np.stack([ve["red"], ve["green"], ve["blue"]], axis=-1).astype(np.uint8)

    def frame(az):
        if mesh is not None:
            return render_mesh(mesh, azimuth_deg=az, size=(W, H))
        return render_point_cloud(points, colors, azimuth_deg=az, size=(W, H))

    if args.turntable > 0:
        os.makedirs(args.output, exist_ok=True)
        for i in range(args.turntable):
            az = 360.0 * i / args.turntable
            imio.write_image(os.path.join(args.output, f"frame{i:03d}.png"), frame(az))
        print(f"wrote {args.turntable} frames -> {args.output}/")
    else:
        imio.write_image(args.output, frame(30.0))
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
