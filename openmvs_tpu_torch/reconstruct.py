"""Mesh reconstruction: dense point cloud -> watertight surface.

A copy of the JAX package's ``openmvs_tpu/reconstruct.py``, which is host
code: Qhull's Delaunay through scipy, then the visibility ray walk and the
s-t min-cut in the copied C++ (``native/``). Names, casts and random draws
are kept, so both packages give the same faces.

Equivalent of Scene::ReconstructMesh (libs/MVS/SceneReconstruct.cpp:767-1159,
Labatut-Pons'07 graph cut): Delaunay tetrahedralization of the (deduplicated)
points, per-(point, view) visibility ray weights accumulated over crossed
facets, s-t min-cut labeling cells free/full, surface = facets between a free
and a full cell.

The tetrahedralization comes from Qhull (scipy.spatial.Delaunay); the ray
walking and the min-cut run natively (``native/src/delaunay_cut.cpp`` +
``maxflow.cpp``), mirroring where the reference shells out to CGAL + IBFS.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from openmvs_tpu_torch import native
from openmvs_tpu_torch.config import MeshOptions
from openmvs_tpu_torch.scene import Mesh, PointCloud, Scene
from openmvs_tpu_torch.utils.log import get_logger, timed

log = get_logger("reconstruct")


def _dedup_points(
    scene: Scene, pc: PointCloud, dist_insert: float
) -> tuple[np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """Merge points closer than ~dist_insert pixels when projected (the
    reference gates Delaunay insertion the same way, SceneReconstruct.cpp:
    785-913, distInsert).  Approximated by a voxel grid whose cell size is the
    median of (dist_insert * depth / focal) over the cloud."""
    pts = np.asarray(pc.points, np.float64)
    if dist_insert <= 0 or len(pts) == 0:
        return pts, pc.views, pc.weights
    # depth w.r.t. the first view of each point
    id_to_idx = {im.meta.id: i for i, im in enumerate(scene.images)}
    first_view = np.array(
        [int(v[0]) if len(v) else 0 for v in pc.views], np.int64
    )
    cams = {i: im.camera for i, im in enumerate(scene.images)}
    depths = np.ones(len(pts))
    focals = np.ones(len(pts))
    for vid in np.unique(first_view):
        idx = id_to_idx.get(int(vid))
        if idx is None:
            continue
        cam = cams[idx]
        sel = first_view == vid
        d = (pts[sel] - cam.C) @ cam.R[2]
        depths[sel] = np.maximum(d, 1e-6)
        focals[sel] = cam.K[0, 0]
    radius = dist_insert * depths / focals
    cell = float(np.median(radius))
    if cell <= 0:
        return pts, pc.views, pc.weights
    keys = np.floor(pts / cell).astype(np.int64)
    # lexicographic unique voxel
    _, first_idx, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    n_out = len(first_idx)
    log.info("dedup: %d -> %d points (cell %.4g)", len(pts), n_out, cell)
    out_pts = np.zeros((n_out, 3))
    np.add.at(out_pts, inv, pts)
    counts = np.bincount(inv, minlength=n_out)
    out_pts /= counts[:, None]
    # merge view lists + weights
    out_views: List[np.ndarray] = [None] * n_out  # type: ignore
    out_weights: List[np.ndarray] = [None] * n_out  # type: ignore
    order = np.argsort(inv, kind="stable")
    has_w = len(pc.weights) == len(pc.views)
    start = 0
    inv_sorted = inv[order]
    boundaries = np.searchsorted(inv_sorted, np.arange(n_out + 1))
    for g in range(n_out):
        members = order[boundaries[g] : boundaries[g + 1]]
        vs = np.concatenate([np.asarray(pc.views[m], np.uint32) for m in members])
        ws = (
            np.concatenate([np.asarray(pc.weights[m], np.float32) for m in members])
            if has_w
            else np.ones(len(vs), np.float32)
        )
        # merged points SUM their per-view weights (InsertViews,
        # SceneReconstruct.cpp:235-255)
        uv, inv_v = np.unique(vs, return_inverse=True)
        wsum = np.zeros(len(uv), np.float32)
        np.add.at(wsum, inv_v, ws)
        out_views[g] = uv.astype(np.uint32)
        out_weights[g] = wsum
    return out_pts, out_views, out_weights


def reconstruct_mesh(
    scene: Scene,
    opts: MeshOptions = MeshOptions(),
    pc: Optional[PointCloud] = None,
    _skip_dedup: bool = False,
) -> Mesh:
    """Dense point cloud -> surface mesh via Delaunay graph cut."""
    from scipy.spatial import Delaunay

    pc = pc if pc is not None else scene.pointcloud
    if len(pc) < 5:
        raise ValueError("point cloud too small to mesh")

    if _skip_dedup:       # chunked path: already deduped globally
        pts = np.asarray(pc.points, np.float64)
        views, weights = pc.views, pc.weights
    else:
        with timed(log, "dedup points"):
            pts, views, weights = _dedup_points(scene, pc, opts.dist_insert)

    with timed(log, "Delaunay tetrahedralization"):
        tri = Delaunay(pts, qhull_options="QJ")  # joggle: avoid degenerate merges
        tets = np.ascontiguousarray(tri.simplices, np.int32)
        neigh = np.ascontiguousarray(tri.neighbors, np.int32)
    log.info("%d points -> %d tets", len(pts), len(tets))

    # per-vertex incident tet (any)
    vert_tet = np.full(len(pts), -1, np.int32)
    vert_tet[tets.ravel()[::-1]] = np.repeat(np.arange(len(tets), dtype=np.int32), 4)[::-1]
    if (vert_tet < 0).any():
        # points dropped by qhull merges: snap to tet 0 (their rays are skipped
        # anyway if they have no views)
        vert_tet[vert_tet < 0] = 0

    # CSR (point -> cameras): map image ids to compact camera indices
    id_to_idx = {im.meta.id: i for i, im in enumerate(scene.images)}
    cam_centers = np.stack([im.camera.C for im in scene.images]).astype(np.float64)
    cam_P = np.stack([im.camera.P for im in scene.images]).astype(np.float64)
    cam_wh = np.array([[im.width, im.height] for im in scene.images], np.int32)
    counts = np.array([len(v) for v in views], np.int64)
    indptr = np.zeros(len(pts) + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    view_cam = np.zeros(indptr[-1], np.int32)
    view_w = np.ones(indptr[-1], np.float32)
    has_w = len(weights) == len(views)
    for i, v in enumerate(views):
        beg = indptr[i]
        for k, vid in enumerate(v):
            view_cam[beg + k] = id_to_idx.get(int(vid), 0)
        if has_w and len(weights[i]) == len(v):
            w = np.asarray(weights[i], np.float32)
            if w.max(initial=0) > 0:
                view_w[beg : beg + len(v)] = w

    # sigma = median Delaunay edge length * kSigma — the "smallest
    # reconstructible object" scale (SceneReconstruct.cpp:922-928)
    sample = tets if len(tets) < 200_000 else tets[
        np.random.default_rng(0).choice(len(tets), 200_000, replace=False)
    ]
    e = pts[sample[:, [0, 1, 2, 3]]]
    elens = np.concatenate(
        [np.linalg.norm(e[:, a] - e[:, b], axis=1) for a, b in ((0, 1), (1, 2), (2, 3))]
    )
    sigma = float(np.median(elens)) * (opts.sigma if opts.sigma > 0 else 2.0)

    with timed(log, "visibility ray walk + min-cut"):
        inside = native.delaunay_graph_cut(
            pts, tets, neigh, vert_tet, cam_centers, cam_P, cam_wh,
            indptr, view_cam, view_w,
            sigma=sigma, kqual=opts.quality_factor, kinf=opts.inf_weight,
            use_free_space=opts.use_free_space_support,
            kb=opts.thickness_factor * 4.0,
        )

    with timed(log, "surface extraction"):
        mesh = _extract_surface(pts, tets, neigh, inside)

    from openmvs_tpu_torch import mesh_ops

    v, f = mesh_ops.fix_non_manifold(mesh.vertices, mesh.faces)
    mesh = Mesh(vertices=np.asarray(v, np.float32), faces=np.asarray(f, np.int32))
    log.info("surface: %d vertices, %d faces", len(mesh.vertices), len(mesh.faces))
    return mesh


def _bsp_partition(pts: np.ndarray, max_points: int):
    """Recursive median splits into core boxes that PARTITION space.

    Unlike split.split_scene (tight bboxes for sub-scene export), these
    boxes tile all of R^3 (outer faces at +-inf) so every face centroid of a
    chunk mesh falls in exactly one core box — the invariant the chunked
    clipping below relies on.  Returns [(lo, hi, point_idx)]."""
    out = []

    def recurse(idx, lo, hi):
        if len(idx) <= max_points:
            out.append((lo, hi, idx))
            return
        p = pts[idx]
        ext = p.max(axis=0) - p.min(axis=0)
        axis = int(np.argmax(ext))
        med = float(np.median(p[:, axis]))
        left = p[:, axis] <= med
        if left.all() or not left.any():
            out.append((lo, hi, idx))
            return
        lo_r = lo.copy(); lo_r[axis] = med
        hi_l = hi.copy(); hi_l[axis] = med
        recurse(idx[left], lo, hi_l)
        recurse(idx[~left], lo_r, hi)

    recurse(np.arange(len(pts)),
            np.full(3, -np.inf), np.full(3, np.inf))
    return out


def reconstruct_mesh_chunked(
    scene: Scene,
    opts: MeshOptions = MeshOptions(),
    pc: Optional[PointCloud] = None,
    max_points: int = 2_000_000,
    overlap: float = 0.15,
) -> Mesh:
    """Memory-bounded Labatut-Pons for very large clouds.

    The reference scales ReconstructMesh only by splitting the SCENE up
    front (Scene::Split + MvsScalablePipeline.py, boundary merge left to the
    user); this runs the same Delaunay graph cut per spatial chunk with an
    overlap band and stitches automatically:

      1. dedup once globally (identical merge semantics to the unchunked path)
      2. BSP-partition the cloud into core boxes of <= max_points points
      3. reconstruct each chunk from the points of its core box EXPANDED by
         `overlap` x local extent (cameras stay global; per-chunk sigma is
         locally adaptive, as a per-sub-scene reference run would be)
      4. keep only faces whose centroid lies in the chunk's core box (the
         boxes partition space -> each face is emitted by exactly one chunk)
      5. weld duplicate vertices (Delaunay vertices ARE input points; only
         Qhull's QJ joggle perturbs them, far below the weld tolerance) and
         close the residual seam cracks (close_holes)

    Peak memory is O(chunk tets), not O(cloud tets)."""
    from openmvs_tpu_torch import mesh_ops

    pc = pc if pc is not None else scene.pointcloud
    if len(pc) < 5:
        raise ValueError("point cloud too small to mesh")

    with timed(log, "dedup points"):
        pts, views, weights = _dedup_points(scene, pc, opts.dist_insert)

    if len(pts) <= max_points:
        dd = PointCloud(points=np.asarray(pts, np.float32),
                        views=views, weights=weights)
        return reconstruct_mesh(scene, opts, pc=dd, _skip_dedup=True)

    chunks = _bsp_partition(pts, max_points)
    log.info("chunked reconstruction: %d points -> %d chunks",
             len(pts), len(chunks))

    all_v: List[np.ndarray] = []
    all_f: List[np.ndarray] = []
    n_v = 0
    for ci, (lo, hi, idx) in enumerate(chunks):
        p = pts[idx]
        margin = (p.max(axis=0) - p.min(axis=0)) * overlap
        elo = np.where(np.isfinite(lo), lo - margin, lo)
        ehi = np.where(np.isfinite(hi), hi + margin, hi)
        sel = np.nonzero(np.all((pts >= elo) & (pts <= ehi), axis=1))[0]
        sub = PointCloud(
            points=np.asarray(pts[sel], np.float32),
            views=[views[i] for i in sel],
            weights=([weights[i] for i in sel]
                     if len(weights) == len(views) else []),
        )
        mesh = reconstruct_mesh(scene, opts, pc=sub, _skip_dedup=True)
        if not len(mesh.faces):
            continue
        c = mesh.vertices[mesh.faces].mean(axis=1)
        keep = np.all((c >= lo) & (c < hi), axis=1)
        v, f = mesh_ops.remove_unreferenced(mesh.vertices,
                                            mesh.faces[keep])
        log.info("chunk %d/%d: %d pts -> %d faces (%d in core)",
                 ci + 1, len(chunks), len(sel), len(mesh.faces), len(f))
        all_v.append(v)
        all_f.append(np.asarray(f, np.int64) + n_v)
        n_v += len(v)

    if not all_f:
        return Mesh()
    v = np.concatenate(all_v)
    f = np.concatenate(all_f)
    with timed(log, "stitch chunks"):
        # weld: quantize far above QJ joggle (~1e-11 of extent), far below
        # any real edge length
        diag = float(np.linalg.norm(v.max(axis=0) - v.min(axis=0)))
        tol = max(diag * 1e-7, 1e-12)
        key = np.round(v / tol).astype(np.int64)
        _, first, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
        v = v[first]
        f = inv[f]
        f = mesh_ops.remove_duplicate_faces(
            mesh_ops.remove_degenerate_faces(f.astype(np.int32)))
        v, f = mesh_ops.close_holes(v, f, max_size=30)
        v, f = mesh_ops.fix_non_manifold(v, f)
    mesh = Mesh(vertices=np.asarray(v, np.float32),
                faces=np.asarray(f, np.int32))
    log.info("stitched surface: %d vertices, %d faces",
             len(mesh.vertices), len(mesh.faces))
    return mesh


# facet j of a tet = vertices excluding slot j, in an order whose winding
# (right-hand rule) points away from vertex j
_FACET = np.array([[1, 3, 2], [0, 2, 3], [0, 3, 1], [0, 1, 2]], np.int64)


def _extract_surface(pts: np.ndarray, tets: np.ndarray, neigh: np.ndarray,
                     inside: np.ndarray) -> Mesh:
    """Faces between a full (sink) tet and a free (source) tet, oriented with
    the normal pointing into free space (SceneReconstruct.cpp:1120-1156)."""
    nt = len(tets)
    free = inside == 0  # length nt + n_hull (per-hull-facet outside nodes)
    # full tet t with facet j facing a free region (neighbor tet or its own
    # hull-facet outside node, in (t, j) scan order)
    nb = neigh.astype(np.int64).copy()
    hull_mask = nb < 0
    nb[hull_mask] = nt + np.arange(int(hull_mask.sum()))
    full_t = ~free[:nt]
    facing_free = free[nb]  # (nt, 4)
    # every cut facet is surface (reference emits all src/sink boundaries,
    # SceneReconstruct.cpp:1128-1152): full tet facing a free cell, plus hull
    # facets whose free tet faces a full outside node (emitted once, from the
    # tet side, to avoid double-counting interior facets)
    case_a = full_t[:, None] & facing_free
    case_b = hull_mask & (~full_t[:, None]) & (~facing_free) & free[:nt][:, None]
    sel_t, sel_j = np.nonzero(case_a | case_b)
    if len(sel_t) == 0:
        return Mesh()
    is_full_tet = full_t[sel_t]
    tri = tets[sel_t[:, None], _FACET[sel_j]]  # (n, 3) vertex ids

    # orientation: the normal must point into the free region — away from the
    # apex when the tet is full, toward it when the tet is the free side.
    a = pts[tri[:, 0]]
    n = np.cross(pts[tri[:, 1]] - a, pts[tri[:, 2]] - a)
    apex = pts[tets[sel_t, sel_j]]
    toward_apex = np.einsum("ij,ij->i", n, apex - a) > 0
    flip = np.where(is_full_tet, toward_apex, ~toward_apex)
    tri[flip] = tri[flip][:, [0, 2, 1]]

    from openmvs_tpu_torch.mesh_ops import remove_unreferenced

    v, f = remove_unreferenced(pts, tri.astype(np.int32))
    return Mesh(vertices=np.asarray(v, np.float32), faces=f)
