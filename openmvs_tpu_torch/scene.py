"""In-memory scene: posed images, a sparse point cloud and a mesh.

Counterpart of the data classes of ``openmvs_tpu/scene.py`` (``SceneImage``,
``PointCloud``, ``Mesh``, ``Scene``) restricted to what densify and refine
read. Images hold their working-resolution pixels (``gray``, optional
``color``/``mask``); loading images or ``.mvs`` files from disk, and saving
a mesh as PLY, are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from openmvs_tpu_torch.geometry.camera import Camera
from openmvs_tpu_torch.io.mvs import ImageMeta


@dataclass
class SceneImage:
    """One view: metadata + resolved camera + working-resolution pixels."""

    meta: ImageMeta
    camera: Camera                      # at native image resolution
    width: int = 0
    height: int = 0
    path: str = ""
    color: Optional[np.ndarray] = None  # (h, w, 3) uint8 RGB
    gray: Optional[np.ndarray] = None   # (h, w) float32 [0,1]
    mask: Optional[np.ndarray] = None   # (h, w) segmentation labels
    scale: float = 1.0                  # working / native resolution

    @property
    def id(self) -> int:
        return self.meta.id

    def working_camera(self) -> Camera:
        if self.scale == 1.0:
            return self.camera
        return self.camera.scaled(self.scale)

    def load(self, max_dim: Optional[int] = None):
        raise NotImplementedError(
            "loading images from disk is not ported yet; build the scene "
            "with its pixels in memory (convert.scene_from_arrays)")

    def usable_mask(self, ignore_label: int):
        """(h, w) bool of pixels allowed for estimation, or None."""
        if self.mask is None or ignore_label < 0:
            return None
        return self.mask != ignore_label


@dataclass
class PointCloud:
    """SoA dense/sparse point cloud (reference libs/MVS/PointCloud.h:51-123)."""

    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    views: List[np.ndarray] = field(default_factory=list)       # ragged uint32
    weights: List[np.ndarray] = field(default_factory=list)     # ragged float32
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint8))

    def __len__(self):
        return len(self.points)

    @property
    def has_normals(self) -> bool:
        return len(self.normals) == len(self.points) and len(self.points) > 0

    @property
    def has_colors(self) -> bool:
        return len(self.colors) == len(self.points) and len(self.points) > 0


@dataclass
class Mesh:
    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    faces: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    # texturing results
    face_tex_coords: Optional[np.ndarray] = None  # (nf, 3, 2) float32, uv in [0,1]
    texture: Optional[np.ndarray] = None          # (th, tw, 3) uint8 (page 0)
    textures: Optional[list] = None               # all atlas pages (multi-page)
    face_page: Optional[np.ndarray] = None        # (nf,) int32 page per face

    def __len__(self):
        return len(self.faces)

    @property
    def has_texture(self) -> bool:
        return self.texture is not None and self.face_tex_coords is not None

    def save_ply(self, path: str):
        raise NotImplementedError("PLY output is not ported yet (io/ply)")


class Scene:
    """Posed images + sparse point cloud + mesh (+ optional region of
    interest)."""

    def __init__(self):
        self.images: List[SceneImage] = []
        self.pointcloud = PointCloud()
        self.mesh = Mesh()
        self.obb_rot = np.zeros((3, 3))
        self.obb_min = np.zeros(3)
        self.obb_max = np.zeros(3)

    @property
    def n_views(self) -> int:
        return len(self.images)

    def is_bounded(self) -> bool:
        return bool(np.any(self.obb_max - self.obb_min > 0))

    def roi_contains(self, pts: np.ndarray) -> np.ndarray:
        """Per-point OBB membership (Interface.h:665-668): obb_rot rotates
        world->OBB coordinates, obb_min/obb_max are corners in OBB space."""
        local = np.asarray(pts, np.float64) @ self.obb_rot.T
        return np.all((local >= self.obb_min) & (local <= self.obb_max), axis=1)
