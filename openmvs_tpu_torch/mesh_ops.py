"""Mesh geometry operations: adjacency, cleaning, decimation, smoothing.

A copy of the JAX package's ``openmvs_tpu/mesh_ops.py``, which is host
code (numpy, scipy and the native quadric decimation), with its names,
dtypes and order of operations, so both packages give equal arrays.
Role-equivalent of the reference's ``Mesh`` geometry toolbox
(libs/MVS/Mesh.h:124-260 — Clean = decimate + remove spurious/spikes + close
holes + smooth; FixNonManifold).  Decimation runs natively (quadric
edge-collapse, ``native/src/decimate.cpp``); connectivity analysis is
vectorized numpy; smoothing is a dense Taubin pass.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from openmvs_tpu_torch.scene import Mesh
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("mesh")


# --------------------------------------------------------------------- basics
def face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = vertices[faces[:, 0]]
    e1 = vertices[faces[:, 1]] - a
    e2 = vertices[faces[:, 2]] - a
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(ln, 1e-30)


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    a = vertices[faces[:, 0]]
    fn = np.cross(vertices[faces[:, 1]] - a, vertices[faces[:, 2]] - a)
    vn = np.zeros_like(vertices, dtype=np.float64)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    ln = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(ln, 1e-30)).astype(np.float32)


def edges_of_faces(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (sorted) edges, one row per face-edge: returns (edges(nf*3,2),
    unique_edges, inverse index mapping face-edge -> unique edge)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    e_sorted = np.sort(e, axis=1)
    uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
    return e_sorted, uniq, inv


def remove_unreferenced(vertices: np.ndarray, faces: np.ndarray):
    used = np.zeros(len(vertices), bool)
    used[faces.ravel()] = True
    remap = np.cumsum(used) - 1
    return vertices[used], remap[faces].astype(np.int32)


def remove_degenerate_faces(faces: np.ndarray) -> np.ndarray:
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 2] != faces[:, 0])
    )
    return faces[ok]


def remove_duplicate_faces(faces: np.ndarray) -> np.ndarray:
    key = np.sort(faces, axis=1)
    _, idx = np.unique(key, axis=0, return_index=True)
    return faces[np.sort(idx)]


# --------------------------------------------------------- non-manifold fixes
def fix_non_manifold(vertices: np.ndarray, faces: np.ndarray):
    """Drop faces on edges shared by >2 faces (keeping the first two), then
    remove duplicates/degenerates (reference Mesh::FixNonManifold role,
    SceneReconstruct.cpp:1159)."""
    faces = remove_degenerate_faces(faces)
    faces = remove_duplicate_faces(faces)
    for _ in range(4):
        _, uniq, inv = edges_of_faces(faces)
        counts = np.bincount(inv, minlength=len(uniq))
        bad_edges = counts > 2
        if not bad_edges.any():
            break
        nf = len(faces)
        face_bad = np.zeros(nf, bool)
        # order face-edges per unique edge; keep first 2 incident faces
        order = np.argsort(inv, kind="stable")
        inv_sorted = inv[order]
        # rank within group
        group_start = np.searchsorted(inv_sorted, np.arange(len(uniq)))
        rank = np.arange(len(inv_sorted)) - group_start[inv_sorted]
        drop = (rank >= 2) & bad_edges[inv_sorted]
        face_bad[order[drop] % nf] = True
        faces = faces[~face_bad]
    return remove_unreferenced(vertices, faces)


def connected_components(faces: np.ndarray, n_vertices: int) -> np.ndarray:
    """Face component ids via union-find over shared edges."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as cc

    _, uniq, inv = edges_of_faces(faces)
    nf = len(faces)
    fidx = np.arange(3 * nf) % nf
    order = np.argsort(inv, kind="stable")
    inv_s, f_s = inv[order], fidx[order]
    # adjacent faces: consecutive entries with same edge id
    same = inv_s[1:] == inv_s[:-1]
    rows, cols = f_s[:-1][same], f_s[1:][same]
    g = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(nf, nf))
    _, labels = cc(g, directed=False)
    return labels


def remove_spurious(vertices: np.ndarray, faces: np.ndarray, percent: float = 20.0):
    """Remove small connected components (< percent% of the largest)."""
    if len(faces) == 0:
        return vertices, faces
    labels = connected_components(faces, len(vertices))
    counts = np.bincount(labels)
    keep_threshold = counts.max() * percent / 100.0
    keep = counts[labels] >= keep_threshold
    return remove_unreferenced(vertices, faces[keep])


def remove_spikes(vertices: np.ndarray, faces: np.ndarray, iters: int = 2):
    """Remove spike vertices: a vertex whose every incident face is nearly
    degenerate in the normal sense (very long thin triangles)."""
    for _ in range(iters):
        a = vertices[faces[:, 0]]
        e1 = vertices[faces[:, 1]] - a
        e2 = vertices[faces[:, 2]] - a
        area2 = np.linalg.norm(np.cross(e1, e2), axis=1)
        per = (
            np.linalg.norm(e1, axis=1)
            + np.linalg.norm(e2, axis=1)
            + np.linalg.norm(vertices[faces[:, 2]] - vertices[faces[:, 1]], axis=1)
        )
        # compactness ~ 0 for needle triangles
        q = area2 / np.maximum(per * per, 1e-30)
        bad = q < 1e-5
        if not bad.any():
            break
        faces = faces[~bad]
    return remove_unreferenced(vertices, faces)


def close_holes(vertices: np.ndarray, faces: np.ndarray, max_size: int = 30):
    """Close small boundary loops with a triangle fan around their centroid."""
    _, uniq, inv = edges_of_faces(faces)
    counts = np.bincount(inv, minlength=len(uniq))
    boundary = uniq[counts == 1]
    if len(boundary) == 0:
        return vertices, faces
    # directed boundary loops: each boundary edge appears in exactly one
    # face; walking it REVERSED makes the fill fan wind opposite the
    # adjacent face across the shared edge, i.e. with consistent outward
    # orientation (the old vertex-sorted trace flipped ~half the fans)
    bset = set(map(tuple, boundary.tolist()))
    nxt: dict = {}
    for f in faces:
        for u, v in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            key = (u, v) if u < v else (v, u)
            if key in bset:
                nxt[int(v)] = int(u)
    visited = set()
    new_vs = []
    new_fs = []
    nv = len(vertices)
    for start in list(nxt):
        if start in visited:
            continue
        loop = [start]
        cur = nxt[start]
        ok = True
        while cur != start:
            if cur in visited or cur not in nxt or len(loop) > max_size:
                ok = False
                break
            loop.append(cur)
            cur = nxt[cur]
        visited.update(loop)
        if not ok or len(loop) < 3 or len(loop) > max_size:
            continue
        centroid = vertices[loop].mean(axis=0)
        ci = nv + len(new_vs)
        new_vs.append(centroid)
        for i in range(len(loop)):
            new_fs.append((loop[i], loop[(i + 1) % len(loop)], ci))
    if not new_fs:
        return vertices, faces
    vertices = np.concatenate([vertices, np.asarray(new_vs, vertices.dtype)], axis=0)
    faces = np.concatenate([faces, np.asarray(new_fs, np.int32)], axis=0)
    return vertices, faces


def taubin_smooth(vertices: np.ndarray, faces: np.ndarray, iters: int = 2,
                  lam: float = 0.5, mu: float = -0.53):
    """Taubin lambda/mu smoothing (shrink-free Laplacian)."""
    from scipy.sparse import coo_matrix

    _, uniq, _ = edges_of_faces(faces)
    n = len(vertices)
    rows = np.concatenate([uniq[:, 0], uniq[:, 1]])
    cols = np.concatenate([uniq[:, 1], uniq[:, 0]])
    w = np.ones(len(rows))
    A = coo_matrix((w, (rows, cols)), shape=(n, n)).tocsr()
    deg = np.asarray(A.sum(axis=1)).ravel()
    deg[deg == 0] = 1
    v = vertices.astype(np.float64)
    for _ in range(iters):
        for step in (lam, mu):
            delta = A @ v / deg[:, None] - v
            v = v + step * delta
    return v.astype(vertices.dtype)


def decimate_mesh(vertices: np.ndarray, faces: np.ndarray, ratio: float):
    """Quadric edge-collapse decimation to ratio*nf faces (native)."""
    from openmvs_tpu_torch import native

    target = int(len(faces) * ratio)
    v2, f2 = native.decimate(vertices.astype(np.float64), faces.astype(np.int32), target)
    return v2.astype(vertices.dtype), f2


def clean_mesh(
    mesh: Mesh,
    decimate: float = 1.0,
    remove_spurious_percent: float = 20.0,
    do_remove_spikes: bool = True,
    close_holes_size: int = 30,
    smooth_iters: int = 2,
    last_clean: bool = True,
) -> Mesh:
    """Reference Mesh::Clean composite (libs/MVS/Mesh.cpp:685-790 role):
    decimate -> remove spurious components -> remove spikes -> close holes ->
    smooth."""
    v, f = mesh.vertices, mesh.faces
    if decimate < 1.0 and len(f):
        v, f = decimate_mesh(v, f, decimate)
        log.info("decimated to %d vertices, %d faces", len(v), len(f))
    if remove_spurious_percent > 0 and len(f):
        v, f = remove_spurious(v, f, remove_spurious_percent)
    if do_remove_spikes and len(f):
        v, f = remove_spikes(v, f)
    if close_holes_size > 0 and len(f):
        v, f = close_holes(v, f, close_holes_size)
    if smooth_iters > 0 and last_clean and len(f):
        v = taubin_smooth(v, f, smooth_iters)
    v, f = fix_non_manifold(v, f)
    return Mesh(vertices=np.asarray(v, np.float32), faces=np.asarray(f, np.int32))


def sample_points(mesh: Mesh, n_points: int, seed: int = 0):
    """Uniform area-weighted surface sampling (Mesh::SamplePoints role,
    Mesh.h:223-225): returns (points (n,3), face normals per sample)."""
    rng = np.random.default_rng(seed)
    v, f = mesh.vertices.astype(np.float64), mesh.faces
    a = v[f[:, 0]]
    e1 = v[f[:, 1]] - a
    e2 = v[f[:, 2]] - a
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    probs = areas / max(areas.sum(), 1e-30)
    fi = rng.choice(len(f), n_points, p=probs)
    r1 = np.sqrt(rng.random(n_points))
    r2 = rng.random(n_points)
    w = r1 * r2
    pts = a[fi] + e1[fi] * (r1 * (1 - r2))[:, None] + e2[fi] * w[:, None]
    n = face_normals(v, f)[fi]
    return pts.astype(np.float32), n.astype(np.float32)


def face_areas(mesh: Mesh) -> np.ndarray:
    """Per-face triangle areas (float64, (nf,))."""
    v, f = mesh.vertices.astype(np.float64), mesh.faces
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)


def subdivide(mesh: Mesh) -> Mesh:
    """Uniform 1->4 midpoint subdivision (Mesh::Subdivide role)."""
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces.astype(np.int64)
    edges = {}
    vlist = []

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in edges:
            edges[key] = len(v) + len(vlist)
            vlist.append(0.5 * (v[a] + v[b]))
        return edges[key]

    out = []
    for a, b, c in f:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
    v2 = np.concatenate([v, np.asarray(vlist)], axis=0) if vlist else v
    return Mesh(vertices=v2.astype(np.float32), faces=np.asarray(out, np.int32))


def _split_long_edges(v: np.ndarray, f: np.ndarray, max_edge: float):
    """Split every edge longer than max_edge at its midpoint (edge-consistent
    across adjacent faces); returns (v, f, n_split)."""
    pairs = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    key = np.sort(pairs, axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    elen = np.linalg.norm(v[uniq[:, 0]] - v[uniq[:, 1]], axis=1)
    split = elen > max_edge
    n_split = int(split.sum())
    if n_split == 0:
        return v, f, 0
    mid_id = np.full(len(uniq), -1, np.int64)
    mid_id[split] = len(v) + np.arange(n_split)
    v = np.concatenate([v, 0.5 * (v[uniq[split, 0]] + v[uniq[split, 1]])])
    m = mid_id[inv].reshape(3, -1).T            # (nf, 3): mid of e01,e12,e20
    out = []
    a, b, c = f[:, 0], f[:, 1], f[:, 2]
    has = m >= 0
    code = has[:, 0] * 1 + has[:, 1] * 2 + has[:, 2] * 4
    sel = code == 0
    out.append(f[sel])
    # one split edge: rotate so the split edge is (a, b)
    for bit, perm in ((1, (0, 1, 2)), (2, (1, 2, 0)), (4, (2, 0, 1))):
        sel = code == bit
        if not sel.any():
            continue
        aa, bb, cc = f[sel][:, perm[0]], f[sel][:, perm[1]], f[sel][:, perm[2]]
        mm = m[sel][:, (0 if bit == 1 else 1 if bit == 2 else 2)]
        out.append(np.stack([aa, mm, cc], 1))
        out.append(np.stack([mm, bb, cc], 1))
    # two split edges: rotate so the UNsplit edge is (c, a)
    for miss, perm in ((4, (0, 1, 2)), (1, (1, 2, 0)), (2, (2, 0, 1))):
        sel = code == 7 - miss
        if not sel.any():
            continue
        aa, bb, cc = f[sel][:, perm[0]], f[sel][:, perm[1]], f[sel][:, perm[2]]
        k = {4: (0, 1), 1: (1, 2), 2: (2, 0)}[miss]
        mab = m[sel][:, k[0]]
        mbc = m[sel][:, k[1]]
        out.append(np.stack([aa, mab, mbc], 1))
        out.append(np.stack([mab, bb, mbc], 1))
        out.append(np.stack([aa, mbc, cc], 1))
    sel = code == 7
    if sel.any():
        mab, mbc, mca = m[sel][:, 0], m[sel][:, 1], m[sel][:, 2]
        aa, bb, cc = a[sel], b[sel], c[sel]
        out.append(np.stack([aa, mab, mca], 1))
        out.append(np.stack([mab, bb, mbc], 1))
        out.append(np.stack([mca, mbc, cc], 1))
        out.append(np.stack([mab, mbc, mca], 1))
    return v, np.concatenate(out).astype(f.dtype), n_split


def _collapse_short_edges(v: np.ndarray, f: np.ndarray, min_edge: float,
                          max_edge: float):
    """Greedy non-conflicting midpoint collapses of edges shorter than
    min_edge (skipping collapses that would create edges beyond max_edge)."""
    pairs = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    key = np.sort(pairs, axis=1)
    uniq = np.unique(key, axis=0)
    elen = np.linalg.norm(v[uniq[:, 0]] - v[uniq[:, 1]], axis=1)
    order = np.argsort(elen)
    locked = np.zeros(len(v), bool)
    remap = np.arange(len(v))
    # max incident edge length per vertex (to bound post-collapse stretch)
    vmax = np.zeros(len(v))
    np.maximum.at(vmax, uniq[:, 0], elen)
    np.maximum.at(vmax, uniq[:, 1], elen)
    n_col = 0
    for ei in order:
        if elen[ei] >= min_edge:
            break
        a, b = uniq[ei]
        if locked[a] or locked[b]:
            continue
        if max(vmax[a], vmax[b]) + 0.5 * elen[ei] > max_edge:
            continue
        v[a] = 0.5 * (v[a] + v[b])
        remap[b] = a
        locked[a] = locked[b] = True
        n_col += 1
    if n_col == 0:
        return v, f, 0
    f2 = remap[f]
    good = (f2[:, 0] != f2[:, 1]) & (f2[:, 1] != f2[:, 2]) & (f2[:, 0] != f2[:, 2])
    return v, f2[good].astype(f.dtype), n_col


def isotropic_remesh(mesh: Mesh, target_edge: float, iters: int = 4,
                     relax: float = 0.4) -> Mesh:
    """Isotropic remeshing toward a uniform target edge length
    (Mesh::EnsureEdgeSize role, Mesh.h:185 / CLN::EnsureEdgeSize,
    Mesh.cpp:2672-3036): per iteration, split edges > 4/3 target, collapse
    edges < 4/5 target, and tangentially relax vertices toward their one-ring
    centroid (projected off the vertex normal so the shape is preserved)."""
    v = mesh.vertices.astype(np.float64).copy()
    f = mesh.faces.astype(np.int64).copy()
    hi = target_edge * 4.0 / 3.0
    lo = target_edge * 4.0 / 5.0
    for _ in range(iters):
        v, f, n_s = _split_long_edges(v, f, hi)
        v, f, n_c = _collapse_short_edges(v, f, lo, hi)
        v, f = remove_unreferenced(v, f)
        f = remove_duplicate_faces(remove_degenerate_faces(f))
        # tangential relaxation
        n = vertex_normals(v, f)
        ring = np.zeros_like(v)
        cnt = np.zeros(len(v))
        pairs = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        np.add.at(ring, pairs[:, 0], v[pairs[:, 1]])
        np.add.at(cnt, pairs[:, 0], 1.0)
        np.add.at(ring, pairs[:, 1], v[pairs[:, 0]])
        np.add.at(cnt, pairs[:, 1], 1.0)
        c = ring / np.maximum(cnt[:, None], 1.0)
        d = c - v
        d -= n * np.einsum("ij,ij->i", d, n)[:, None]   # tangent component
        v = v + relax * d
        if n_s == 0 and n_c == 0:
            break
    # final bounding pass: the tangential relax can stretch edges slightly
    # past the bound, and splits create new diagonal edges that may need
    # further rounds — iterate splits to a fixpoint (no relax afterwards)
    for _ in range(8):
        v, f, n_s = _split_long_edges(v, f, hi)
        if n_s == 0:
            break
    v, f = remove_unreferenced(v, f)
    return Mesh(vertices=v.astype(np.float32), faces=f.astype(np.int32))


def compute_volume(mesh: Mesh) -> float:
    """Signed mesh volume by the divergence theorem (Mesh::ComputeVolume
    role): sum of signed tetrahedra volumes det(a,b,c)/6 over faces.  Exact
    for watertight meshes; an open ground-contact boundary closes implicitly
    against the origin plane (Scene::ComputeLeveledVolume usage)."""
    v = mesh.vertices.astype(np.float64)
    a = v[mesh.faces[:, 0]]
    b = v[mesh.faces[:, 1]]
    c = v[mesh.faces[:, 2]]
    return abs(float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum()) / 6.0)


def ensure_edge_size(mesh: Mesh, max_edge: float, max_rounds: int = 4) -> Mesh:
    """Bound the longest edge at max_edge via isotropic remeshing
    (EnsureEdgeSize role, Mesh.h:185)."""
    return isotropic_remesh(mesh, max_edge * 0.75, iters=max_rounds)


def split_mesh(mesh: Mesh, max_faces: int) -> list:
    """Split a mesh into spatial face chunks (Mesh::Split role, Mesh.h:234:
    the reference uses its octree; here recursive median cuts on face
    centroids — the same spatial-coherence guarantee with re-indexed
    vertices per chunk)."""
    cent = mesh.vertices[mesh.faces].mean(axis=1)

    def rec(idx):
        if len(idx) <= max_faces:
            return [idx]
        c = cent[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        med = np.median(c[:, ax])
        lo = idx[c[:, ax] <= med]
        hi = idx[c[:, ax] > med]
        if len(lo) == 0 or len(hi) == 0:   # degenerate (coincident centroids)
            # no spatial separation possible: slice into max_faces pieces so
            # every chunk still honors the size contract
            return [idx[i:i + max_faces] for i in range(0, len(idx), max_faces)]
        return rec(lo) + rec(hi)

    chunks = []
    for fidx in rec(np.arange(len(mesh.faces))):
        if len(fidx) == 0:
            continue
        f = mesh.faces[fidx]
        used = np.unique(f.ravel())
        remap = np.zeros(len(mesh.vertices), np.int64)
        remap[used] = np.arange(len(used))
        sub = Mesh(vertices=mesh.vertices[used].copy(),
                   faces=remap[f].astype(np.int32))
        if mesh.face_tex_coords is not None and len(mesh.face_tex_coords):
            sub.face_tex_coords = mesh.face_tex_coords[fidx].copy()
            sub.texture = mesh.texture
        chunks.append(sub)
    return chunks


def transfer_texture(src: Mesh, dst: Mesh) -> Mesh:
    """Transfer src's texture onto dst (Mesh texture-transfer role,
    Mesh.h:237).  Each dst face corner is projected onto the nearest src
    face (KD-tree on centroids) and inherits its interpolated texcoord, so
    dst reuses src's atlas image.  Simplification vs the reference: corners
    straddling a src patch seam snap to one side of it."""
    if src.face_tex_coords is None or src.texture is None:
        raise ValueError("source mesh has no texture")
    from scipy.spatial import cKDTree

    sc = src.vertices[src.faces].mean(axis=1)
    tree = cKDTree(sc)
    corners = dst.vertices[dst.faces].reshape(-1, 3)      # (nf*3, 3)
    _, fi = tree.query(corners, k=1)
    # multi-page atlases: each dst face must sample ONE page — corners
    # whose nearest src face lives on another page snap to the face
    # nearest the dst face's centroid, whose page the dst face inherits
    page = None
    if src.face_page is not None and src.textures is not None:
        fcent = dst.vertices[dst.faces].mean(axis=1)
        _, fc = tree.query(fcent, k=1)
        page = src.face_page[fc].astype(np.int32)
        fi3 = fi.reshape(-1, 3)
        mismatch = src.face_page[fi3] != page[:, None]
        fi = np.where(mismatch, fc[:, None], fi3).reshape(-1)
    tri = src.vertices[src.faces[fi]]                     # (m, 3, 3)
    # barycentric coords of the projection onto each source triangle
    v0 = tri[:, 1] - tri[:, 0]
    v1 = tri[:, 2] - tri[:, 0]
    v2 = corners - tri[:, 0]
    d00 = np.einsum("ij,ij->i", v0, v0)
    d01 = np.einsum("ij,ij->i", v0, v1)
    d11 = np.einsum("ij,ij->i", v1, v1)
    d20 = np.einsum("ij,ij->i", v2, v0)
    d21 = np.einsum("ij,ij->i", v2, v1)
    den = np.maximum(d00 * d11 - d01 * d01, 1e-20)
    b1 = (d11 * d20 - d01 * d21) / den
    b2 = (d00 * d21 - d01 * d20) / den
    b1 = np.clip(b1, 0, 1)
    b2 = np.clip(b2, 0, 1 - b1)
    b0 = 1.0 - b1 - b2
    uv_src = src.face_tex_coords[fi]                      # (m, 3, 2)
    uv = (b0[:, None] * uv_src[:, 0] + b1[:, None] * uv_src[:, 1]
          + b2[:, None] * uv_src[:, 2])
    return Mesh(vertices=dst.vertices, faces=dst.faces,
                face_tex_coords=uv.reshape(len(dst.faces), 3, 2).astype(np.float32),
                texture=src.texture, textures=src.textures, face_page=page)
