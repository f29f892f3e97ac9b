"""Sparse-point depth-map seeding.

Equivalent of the reference's TriangulatePoints2DepthMap in sparse-only mode
(libs/MVS/DepthMap.cpp:1117-1193 with bSparseOnly=true, the OPTDENSE default
bInitSparse=1): each sparse point visible in the reference view splats its
depth into the 2x2 pixels around its projection; per-point normals come from
a 2D Delaunay triangulation of the projections lifted to camera space
(mesh.ComputeNormalVertices equivalent).  Also returns the [dMin, dMax]
search range (scaled by 0.9/1.1 as InitDepthMap does).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import Delaunay

from openmvs_tpu_torch.geometry.camera import Camera


def seed_depth_normal(
    camera: Camera,
    width: int,
    height: int,
    points: np.ndarray,
    trusted: np.ndarray,
    interpolate: bool = False,
    add_corners: bool = False,
) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Seed (h, w) depth and (h, w, 3) camera-space normal maps.

    points: (N, 3) world points visible in this view; trusted: (N,) bool mask
    of points with enough observing views to be used as seeds.

    interpolate (OPTDENSE bInitSparse==0): rasterize the 2D Delaunay
    triangulation of the seeds so EVERY pixel starts from an interpolated
    depth instead of sparse splats (TriangulatePoints2DepthMap,
    DepthMap.cpp:1117-1427); add_corners additionally inserts the 4 image
    corners at the median seed depth so the triangulation covers the full
    frame (the reference's bAddCorners role).
    """
    depth_map = np.zeros((height, width), np.float32)
    normal_map = np.zeros((height, width, 3), np.float32)
    if len(points) == 0:
        return depth_map, normal_map, 0.0, 0.0

    Xc = camera.world_to_cam(points.astype(np.float64))  # camera space
    depth = Xc[:, 2]
    ok = depth > 0
    Xc, depth = Xc[ok], depth[ok]
    trusted = np.asarray(trusted, bool)[ok]
    if len(depth) == 0:
        # every sparse point behind the camera (misregistered pose, chunk
        # boundary view): no seeds, caller skips the view
        return depth_map, normal_map, 0.0, 0.0
    proj = camera.cam_to_image(Xc)

    d_min = float(depth.min()) * 0.9
    d_max = float(depth.max()) * 1.1

    # per-point normals from the 2D Delaunay triangulation lifted to 3D
    normals = np.tile(np.array([0, 0, -1], np.float32), (len(Xc), 1))
    if len(Xc) >= 4:
        try:
            tri = Delaunay(proj)
            faces = tri.simplices  # (F, 3)
            p0, p1, p2 = Xc[faces[:, 0]], Xc[faces[:, 1]], Xc[faces[:, 2]]
            fn = np.cross(p1 - p0, p2 - p0)
            acc = np.zeros((len(Xc), 3))
            np.add.at(acc, faces[:, 0], fn)
            np.add.at(acc, faces[:, 1], fn)
            np.add.at(acc, faces[:, 2], fn)
            nrm = np.linalg.norm(acc, axis=1, keepdims=True)
            good = nrm[:, 0] > 1e-12
            normals[good] = (acc[good] / nrm[good]).astype(np.float32)
            # orient towards the camera: n . ray < 0
            flip = np.einsum("ij,ij->i", normals.astype(np.float64), Xc) > 0
            normals[flip] = -normals[flip]
        except Exception:
            pass

    if add_corners and len(Xc) >= 3:
        med = float(np.median(depth))
        cuv = np.array([[0.0, 0.0], [width - 1.0, 0.0],
                        [0.0, height - 1.0], [width - 1.0, height - 1.0]])
        proj = np.concatenate([proj, cuv])
        # camera-space position of each corner at the median depth
        Kinv = camera.Kinv
        ch = np.concatenate([cuv, np.ones((4, 1))], axis=1) @ Kinv.T * med
        Xc = np.concatenate([Xc, ch])
        depth = np.concatenate([depth, np.full(4, med)])
        normals = np.concatenate(
            [normals, np.tile(np.array([0, 0, -1], np.float32), (4, 1))])
        trusted = np.concatenate([trusted, np.zeros(4, bool)])

    if interpolate and len(Xc) >= 4:
        # full-frame init: rasterize the lifted triangulation (screen-space
        # z interpolation — a seed, refined by the first sweeps); a failure
        # leaves the sparse splats alone, as in the JAX package
        try:
            from openmvs_tpu_torch import native

            tri = Delaunay(proj)
            pr = np.concatenate([proj, depth[:, None]], axis=1)
            fid, zmap, _ = native.rasterize(pr, tri.simplices.astype(np.int32),
                                            height, width, want_bary=False)
            hit = fid >= 0
            depth_map[hit] = zmap[hit]
            f0 = tri.simplices[np.where(hit, fid, 0)][..., 0]
            normal_map[hit] = normals[f0][hit]
        except Exception:
            pass

    # splat trusted points into the 2x2 pixel footprint
    sel = trusted
    if not sel.any():
        sel = np.ones(len(Xc), bool)
    px = np.floor(proj[sel, 0]).astype(np.int64)
    py = np.floor(proj[sel, 1]).astype(np.int64)
    dsel = depth[sel].astype(np.float32)
    nsel = normals[sel]
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ax, ay = px + dx, py + dy
        ok2 = (ax >= 0) & (ax < width) & (ay >= 0) & (ay < height)
        depth_map[ay[ok2], ax[ok2]] = dsel[ok2]
        normal_map[ay[ok2], ax[ok2]] = nsel[ok2]
    return depth_map, normal_map, d_min, d_max
