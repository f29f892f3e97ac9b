"""In-memory scene: posed images, a point cloud and a mesh, with the
pipeline's entry points as methods.

Counterpart of the data classes of ``openmvs_tpu/scene.py`` (``SceneImage``,
``PointCloud``, ``Mesh``, ``Scene``) and of its pyOpenMVS-parity methods
(``dense_reconstruction`` -> ``reconstruct_mesh`` -> ``clean_mesh`` ->
``refine_mesh`` -> ``texture_mesh``, ``save_pointcloud``, ``load_mesh``,
``save_mesh``). Images hold their working-resolution pixels (``gray``,
optional ``color``/``mask``); loading images or ``.mvs`` files from disk is
not ported yet (ROADMAP Queue 1, item 4). Meshes are read and written as
PLY or OBJ; glTF waits for ``io/gltf`` (item 8).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from openmvs_tpu_torch.geometry.camera import Camera
from openmvs_tpu_torch.io import ply as plyio
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

    def save_ply(self, path: str):
        plyio.save_point_cloud(
            path,
            self.points,
            normals=self.normals if self.has_normals else None,
            colors=self.colors if self.has_colors else None,
            comments=("generated by openmvs_tpu",),
        )


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
        plyio.save_mesh(path, self.vertices, self.faces, comments=("generated by openmvs_tpu",))


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

    def crop_to_roi(self) -> int:
        """Drop point-cloud points outside the OBB
        (PointCloud::RemovePointsOutside role); returns removed count."""
        if not self.is_bounded() or len(self.pointcloud) == 0:
            return 0
        keep = self.roi_contains(self.pointcloud.points)
        removed = int((~keep).sum())
        pc = self.pointcloud
        pc.points = pc.points[keep]
        pc.views = [v for v, k in zip(pc.views, keep) if k]
        if len(pc.weights) == len(keep):
            pc.weights = [w for w, k in zip(pc.weights, keep) if k]
        if pc.has_normals:
            pc.normals = pc.normals[keep]
        if pc.has_colors:
            pc.colors = pc.colors[keep]
        return removed

    # ------------------------------------------------- pyOpenMVS-parity API
    # The reference ships boost::python bindings exposing the full pipeline
    # as Scene methods (libs/MVS/PythonWrapper.cpp:116-137); the JAX package
    # keeps their names and defaults (openmvs_tpu/scene.py:796-957), and so
    # does the port, with ``device`` passed to the stages that take one.

    def save_pointcloud(self, path: str) -> None:
        """pyOpenMVS Scene.save_pointcloud (PythonWrapper.cpp:122)."""
        self.pointcloud.save_ply(path)

    def load_mesh(self, path: str) -> None:
        """pyOpenMVS Scene.load_mesh: replace the scene mesh from .ply/.obj
        (PythonWrapper.cpp:123); a PLY without faces gives an empty mesh."""
        ext = os.path.splitext(path)[1].lower()
        if ext == ".ply":
            data = plyio.load(path)
            faces = data.faces
            if faces is not None and len(faces):
                # the PLY loader fan-triangulates polygon faces
                self.mesh = Mesh(vertices=data.vertices.astype(np.float32),
                                 faces=np.asarray(faces, np.int32))
            else:
                self.mesh = Mesh()
        elif ext == ".obj":
            from openmvs_tpu_torch.io import obj as objio

            v, f, _, _ = objio.load_mesh_obj(path)
            self.mesh = Mesh(vertices=v.astype(np.float32), faces=f.astype(np.int32))
        else:
            _unported_mesh_format(path)

    def save_mesh(self, path: str) -> None:
        """pyOpenMVS Scene.save_mesh (PythonWrapper.cpp:124): format by
        extension: .obj (with its MTL and atlas pages), .glb (not ported),
        any other extension .ply, as in the JAX package."""
        ext = os.path.splitext(path)[1].lower()
        if ext == ".obj":
            from openmvs_tpu_torch.io.obj import save_mesh_obj

            save_mesh_obj(path, self.mesh.vertices, self.mesh.faces,
                          self.mesh.face_tex_coords, self.mesh.texture,
                          textures=self.mesh.textures,
                          face_page=self.mesh.face_page)
        elif ext == ".glb":
            _unported_mesh_format(path)
        else:
            self.mesh.save_ply(path)

    def dense_reconstruction(self, resolution_level: int = 0,
                             fusion_mode: int = 0, crop_to_roi: bool = True,
                             roi_border: float = 0.0, device="cuda",
                             **opt_overrides):
        """pyOpenMVS Scene.dense_reconstruction (PythonWrapper.cpp:129):
        runs densify and stores the fused cloud on the scene."""
        from openmvs_tpu_torch.config import DenseOptions
        from openmvs_tpu_torch.densify import dense_reconstruction as _dense

        opts = DenseOptions(resolution_level=resolution_level,
                            **opt_overrides)
        pc = _dense(self, opts, fusion_mode=fusion_mode, device=device)
        if pc is not None:
            self.pointcloud = pc
            if crop_to_roi and self.is_bounded() and roi_border >= 0:
                self.crop_to_roi()
        return pc is not None

    def reconstruct_mesh(self, dist_insert: float = 2.0,
                         use_free_space_support: bool = False,
                         use_only_roi: bool = False, **opt_overrides) -> bool:
        """pyOpenMVS Scene.reconstruct_mesh (PythonWrapper.cpp:130); host
        code."""
        from openmvs_tpu_torch.config import MeshOptions
        from openmvs_tpu_torch.reconstruct import reconstruct_mesh as _mesh

        if use_only_roi and self.is_bounded():
            self.crop_to_roi()
        opts = MeshOptions(dist_insert=dist_insert,
                           use_free_space_support=use_free_space_support,
                           **opt_overrides)
        self.mesh = _mesh(self, opts)
        return len(self.mesh.faces) > 0

    def clean_mesh(self, decimate: float = 1.0, remove_spurious: float = 20.0,
                   remove_spikes: bool = True, close_holes: int = 30,
                   smooth_mesh: int = 2, edge_length: float = 0.0,
                   crop_to_roi: bool = True) -> bool:
        """pyOpenMVS Scene.clean_mesh (PythonWrapper.cpp:131); host code."""
        from openmvs_tpu_torch import mesh_ops

        self.mesh = mesh_ops.clean_mesh(
            self.mesh, decimate=decimate,
            remove_spurious_percent=remove_spurious,
            do_remove_spikes=remove_spikes, close_holes_size=close_holes,
            smooth_iters=smooth_mesh)
        if edge_length > 0:
            self.mesh = mesh_ops.ensure_edge_size(self.mesh, edge_length)
        return len(self.mesh.faces) > 0

    def refine_mesh(self, resolution_level: int = 0,
                    ensure_edge_size: int = 1, max_face_area: int = 32,
                    scales: int = 2, scale_step: float = 0.5,
                    regularity_weight: float = 0.2, device="cuda",
                    **opt_overrides) -> bool:
        """pyOpenMVS Scene.refine_mesh (PythonWrapper.cpp:132)."""
        from openmvs_tpu_torch.config import RefineOptions
        from openmvs_tpu_torch.refine import refine_mesh as _refine

        opts = RefineOptions(resolution_level=resolution_level,
                             ensure_edge_size=ensure_edge_size,
                             max_face_area=max_face_area, scales=scales,
                             scale_step=scale_step,
                             regularity_weight=regularity_weight,
                             **opt_overrides)
        self.mesh = _refine(self, self.mesh, opts, device=device)
        return len(self.mesh.faces) > 0

    def texture_mesh(self, resolution_level: int = 0,
                     empty_color: int = 0x00FF7F27, device="cuda",
                     **opt_overrides) -> bool:
        """pyOpenMVS Scene.texture_mesh (PythonWrapper.cpp:133)."""
        from openmvs_tpu_torch.config import TextureOptions
        from openmvs_tpu_torch.texture import texture_mesh as _texture

        opts = TextureOptions(resolution_level=resolution_level,
                              empty_color=empty_color, **opt_overrides)
        self.mesh = _texture(self, self.mesh, opts, device=device)
        return self.mesh.has_texture


def _unported_mesh_format(path: str):
    raise NotImplementedError(
        f"{path}: the port reads and writes meshes as .ply and .obj; glTF "
        "waits for io/gltf (ROADMAP Queue 1, item 8)")
