"""Linear Morton-order octree (libs/Common/Octree.h TOctree equivalent).

The reference's pointer octree supports Insert, Collect (box/sphere
queries), and SplitVolume (cells whose content exceeds an area budget —
Octree.h:SplitVolume, used by Scene::Split).  This is the vectorised
re-design: points are sorted once by Morton code (vectorized numpy, no
per-point insertion), every octree cell at depth d is a contiguous Morton
range, and queries are range intersections — O(log n) per cell with zero
pointers, so the same structure serves million-point clouds.

Construction is O(n log n) (one argsort); `cells(depth)`, `collect`
(box/sphere), and `split_volume` (recursive max-budget cells, the
Scene::Split caller) are the TOctree API surface used by the reference.

A copy of ``openmvs_tpu/utils/octree.py`` (host numpy in both packages).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

_MAX_DEPTH = 10  # 2^30 Morton codes in 3D fit int64 comfortably


def _spread3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit integers into every 3rd bit (Morton encoding)."""
    x = x.astype(np.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray) -> np.ndarray:
    return _spread3(ix) | (_spread3(iy) << 1) | (_spread3(iz) << 2)


@dataclass
class Octree:
    """Morton-linearized octree over a point set."""

    points: np.ndarray        # (n, 3) float64 originals
    order: np.ndarray         # (n,) permutation sorting by Morton code
    codes: np.ndarray         # (n,) sorted Morton codes
    origin: np.ndarray        # (3,) cube min corner
    size: float               # cube edge length

    # ------------------------------------------------------------ build

    @classmethod
    def build(cls, points: np.ndarray) -> "Octree":
        P = np.asarray(points, np.float64).reshape(-1, 3)
        lo = P.min(axis=0) if len(P) else np.zeros(3)
        hi = P.max(axis=0) if len(P) else np.ones(3)
        size = float(max((hi - lo).max(), 1e-12)) * (1 + 1e-9)
        res = 1 << _MAX_DEPTH
        q = np.clip(((P - lo) / size * res).astype(np.int64), 0, res - 1)
        codes = morton3(q[:, 0], q[:, 1], q[:, 2])
        order = np.argsort(codes, kind="stable")
        return cls(points=P, order=order, codes=codes[order],
                   origin=lo, size=size)

    def __len__(self) -> int:
        return len(self.points)

    # ------------------------------------------------------------ cells

    def cell_range(self, depth: int, cell: np.ndarray) -> Tuple[int, int]:
        """(start, end) index range (into `order`) of one cell's points.

        `cell` = integer (cx, cy, cz) at `depth` (grid of 2^depth per axis).
        """
        shift = 3 * (_MAX_DEPTH - depth)
        base = morton3(*(np.asarray(cell, np.int64) << (_MAX_DEPTH - depth)))
        lo = int(np.searchsorted(self.codes, base << 0))
        hi = int(np.searchsorted(self.codes, base + (1 << shift)))
        return lo, hi

    def cells(self, depth: int):
        """Yield (cell_index_3, point_indices) for every NON-EMPTY cell at
        `depth` — the linear sweep equivalent of TOctree traversal."""
        shift = 3 * (_MAX_DEPTH - depth)
        keys = self.codes >> shift
        if len(keys) == 0:
            return
        cut = np.flatnonzero(np.diff(keys)) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [len(keys)]])
        for s, e in zip(starts, ends):
            key = int(keys[s])
            cell = np.array([_compact3(key), _compact3(key >> 1),
                             _compact3(key >> 2)])
            yield cell, self.order[s:e]

    def cell_box(self, depth: int, cell: np.ndarray):
        edge = self.size / (1 << depth)
        lo = self.origin + np.asarray(cell, np.float64) * edge
        return lo, lo + edge

    # ---------------------------------------------------------- queries

    def collect_box(self, lo, hi) -> np.ndarray:
        """Indices of points inside the axis-aligned box (TOctree::Collect):
        Morton cell ranges prefilter the candidates (the pointer octree's
        pruning, linearized), exact test only on candidate cells."""
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        if len(self.points) == 0:
            return np.zeros(0, np.int64)
        ext = float(max(hi.max() - lo.min(), 1e-12))
        depth = max(1, min(_MAX_DEPTH,
                           int(np.log2(max(self.size / ext, 1))) + 1))
        edge = self.size / (1 << depth)
        n_cells = 1 << depth
        lo_cell = np.clip(np.floor((lo - self.origin) / edge).astype(np.int64),
                          0, n_cells - 1)
        hi_cell = np.clip(np.floor((hi - self.origin) / edge).astype(np.int64),
                          0, n_cells - 1)
        # cap the cell sweep: a box spanning most of the tree degenerates
        # to the full scan anyway
        n_sweep = (int(hi_cell[0] - lo_cell[0] + 1)
                   * int(hi_cell[1] - lo_cell[1] + 1)
                   * int(hi_cell[2] - lo_cell[2] + 1))
        if n_sweep > 4096:
            P = self.points
            m = np.all((P >= lo) & (P <= hi), axis=1)
            return np.flatnonzero(m)
        out = []
        for cx in range(lo_cell[0], hi_cell[0] + 1):
            for cy in range(lo_cell[1], hi_cell[1] + 1):
                for cz in range(lo_cell[2], hi_cell[2] + 1):
                    s, e = self.cell_range(depth, (cx, cy, cz))
                    if e > s:
                        out.append(self.order[s:e])
        if not out:
            return np.zeros(0, np.int64)
        idx = np.concatenate(out)
        P = self.points[idx]
        m = np.all((P >= lo) & (P <= hi), axis=1)
        return idx[m]

    def collect_sphere(self, center, radius: float) -> np.ndarray:
        """Indices of points within `radius` of `center`; the box prefilter
        runs on the Morton ranges so only candidate cells are distance-
        tested (the pointer octree's pruning, linearized)."""
        c = np.asarray(center, np.float64)
        depth = max(1, min(_MAX_DEPTH,
                           int(np.log2(max(self.size / max(radius, 1e-12), 1)))))
        edge = self.size / (1 << depth)
        lo_cell = np.floor((c - radius - self.origin) / edge).astype(np.int64)
        hi_cell = np.floor((c + radius - self.origin) / edge).astype(np.int64)
        n_cells = 1 << depth
        lo_cell = np.clip(lo_cell, 0, n_cells - 1)
        hi_cell = np.clip(hi_cell, 0, n_cells - 1)
        out = []
        for cx in range(lo_cell[0], hi_cell[0] + 1):
            for cy in range(lo_cell[1], hi_cell[1] + 1):
                for cz in range(lo_cell[2], hi_cell[2] + 1):
                    s, e = self.cell_range(depth, (cx, cy, cz))
                    if e > s:
                        out.append(self.order[s:e])
        if not out:
            return np.zeros(0, np.int64)
        idx = np.concatenate(out)
        d = np.linalg.norm(self.points[idx] - c, axis=1)
        return idx[d <= radius]

    # ------------------------------------------------------ split volume

    def split_volume(self, max_points: int) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Cells covering the cloud with <= max_points each
        (TOctree::SplitVolume semantics, as Scene::Split calls it):
        recursively descend cells whose budget is exceeded.

        Returns a list of (box_lo, box_hi, point_indices)."""
        results = []

        def descend(depth, cell, s, e):
            if e - s <= max_points or depth >= _MAX_DEPTH:
                lo, hi = self.cell_box(depth, cell)
                results.append((lo, hi, self.order[s:e]))
                return
            for child in range(8):
                cc = (np.asarray(cell) << 1) + np.array(
                    [child & 1, (child >> 1) & 1, (child >> 2) & 1])
                cs, ce = self.cell_range(depth + 1, cc)
                if ce > cs:
                    descend(depth + 1, cc, cs, ce)

        descend(0, np.zeros(3, np.int64), 0, len(self.codes))
        return results


def _compact3(x: int) -> int:
    """Inverse of _spread3 for a single value."""
    x &= 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x3FF
    return x
