"""Carrying state across from the JAX package.

The system has no weights: what crosses is the scene, the point cloud, the
mesh and the packed per-view PatchMatch state. These functions take plain
numpy arrays (what ``np.asarray`` gives for the JAX package's
``PMData``/``PMState`` fields, or the arrays a JAX-package ``Scene``,
``PointCloud`` or ``Mesh`` holds) and build the port's objects, so both
packages can compute on identical inputs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from openmvs_tpu_torch.geometry.camera import Camera
from openmvs_tpu_torch.io.mvs import ImageMeta
from openmvs_tpu_torch.scene import Mesh, PointCloud, Scene, SceneImage


def _tensor(a, device) -> torch.Tensor:
    # a writable C-ordered copy; keeps 0-d arrays 0-d (np.ascontiguousarray
    # would make them 1-d)
    a = np.array(a, dtype=np.float32 if np.asarray(a).dtype == np.float64
                 else None, order="C", copy=True)
    return torch.from_numpy(a).to(device)


def pm_data_from_numpy(d: dict, device="cuda"):
    """Port ``PMData`` from a dict of the JAX ``PMData`` fields as numpy
    arrays, with ``views`` a nested dict of the ``PMViews`` fields."""
    from openmvs_tpu_torch.ops.patchmatch import PMData, PMViews

    views = PMViews(**{k: _tensor(v, device) for k, v in d["views"].items()})
    fields = {k: _tensor(v, device) for k, v in d.items() if k != "views"}
    fields["valid"] = fields["valid"].to(torch.bool)
    return PMData(views=views, **fields)


def pm_state_from_numpy(d: dict, device="cuda"):
    """Port ``PMState`` from a dict of the JAX ``PMState`` fields."""
    from openmvs_tpu_torch.ops.patchmatch import PMState

    return PMState(**{k: _tensor(v, device) for k, v in d.items()})


def scene_from_arrays(
    grays: Sequence[np.ndarray],
    Ks: Sequence[np.ndarray],
    Rs: Sequence[np.ndarray],
    Cs: Sequence[np.ndarray],
    points: np.ndarray,
    point_views: Sequence[np.ndarray],
    point_weights: Optional[Sequence[np.ndarray]] = None,
    ids: Optional[Sequence[int]] = None,
    names: Optional[Sequence[str]] = None,
    colors: Optional[Sequence[np.ndarray]] = None,
) -> Scene:
    """Port ``Scene`` from per-image gray pixels and cameras (K, R, C at the
    gray image's resolution) plus the sparse cloud and its view lists;
    ``colors``, if given, are the (h, w, 3) uint8 RGB pixels of each image
    (texturing reads them)."""
    scene = Scene()
    n = len(grays)
    ids = list(range(n)) if ids is None else list(ids)
    for i in range(n):
        gray = np.asarray(grays[i], np.float32)
        meta = ImageMeta(name=names[i] if names else f"view{ids[i]:04d}",
                         platform_id=i, id=int(ids[i]))
        h, w = gray.shape
        color = None
        if colors is not None:
            color = np.asarray(colors[i], np.uint8)
            if color.shape != (h, w, 3):
                raise ValueError(f"image {i}: color {color.shape} does not "
                                 f"match gray {gray.shape}")
        scene.images.append(SceneImage(
            meta=meta, camera=Camera(Ks[i], Rs[i], Cs[i]), width=w,
            height=h, gray=gray, color=color))
    views = [np.asarray(v, np.uint32) for v in point_views]
    weights = (list(point_weights) if point_weights is not None
               else [np.ones(len(v), np.float32) for v in views])
    scene.pointcloud = PointCloud(points=np.asarray(points, np.float32),
                                  views=views, weights=weights)
    return scene


def mesh_from_numpy(vertices: np.ndarray, faces: np.ndarray) -> Mesh:
    """Port ``Mesh`` from (nv, 3) vertices and (nf, 3) vertex-index faces
    (copied, as float32 and int32)."""
    return Mesh(vertices=np.array(vertices, np.float32, order="C"),
                faces=np.array(faces, np.int32, order="C"))


def mesh_to_numpy(mesh: Mesh):
    """(vertices, faces) of a port ``Mesh`` as float32 / int32 copies, the
    arrays a JAX-package ``Mesh`` is built from."""
    return (np.array(mesh.vertices, np.float32, order="C"),
            np.array(mesh.faces, np.int32, order="C"))


def pointcloud_from_numpy(points: np.ndarray, views: Sequence[np.ndarray],
                          weights: Optional[Sequence[np.ndarray]] = None,
                          normals: Optional[np.ndarray] = None,
                          colors: Optional[np.ndarray] = None) -> PointCloud:
    """Port ``PointCloud`` from (n, 3) points, the ragged per-point view ids
    and weights, and optional (n, 3) normals and colors (copied, as float32,
    uint32, float32, float32 and uint8; empty where not given)."""
    pc = PointCloud(points=np.array(points, np.float32, order="C").reshape(-1, 3),
                    views=[np.array(v, np.uint32) for v in views],
                    weights=[np.array(w, np.float32) for w in (weights or [])])
    if normals is not None:
        pc.normals = np.array(normals, np.float32, order="C").reshape(-1, 3)
    if colors is not None:
        pc.colors = np.array(colors, np.uint8, order="C").reshape(-1, 3)
    return pc


def pointcloud_to_numpy(pc: PointCloud) -> dict:
    """The fields of a port ``PointCloud`` as numpy copies under the names
    of the JAX package's ``PointCloud`` (``points``, ``views``, ``weights``,
    ``normals``, ``colors``), so ``PointCloud(**pointcloud_to_numpy(pc))``
    builds either package's."""
    return dict(points=np.array(pc.points, np.float32, order="C"),
                views=[np.array(v, np.uint32) for v in pc.views],
                weights=[np.array(w, np.float32) for w in pc.weights],
                normals=np.array(pc.normals, np.float32, order="C"),
                colors=np.array(pc.colors, np.uint8, order="C"))
