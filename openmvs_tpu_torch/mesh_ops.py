"""Mesh topology helpers (host side, numpy).

Counterpart of the part of ``openmvs_tpu/mesh_ops.py`` that refinement
needs: the face-edge table its open-border test reads. Cleaning,
decimation and remeshing are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def edges_of_faces(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (sorted) edges, one row per face-edge: returns (edges(nf*3,2),
    unique_edges, inverse index mapping face-edge -> unique edge)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    e_sorted = np.sort(e, axis=1)
    uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
    return e_sorted, uniq, inv
