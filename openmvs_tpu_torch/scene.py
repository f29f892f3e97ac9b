"""Scene: posed images, a point cloud and a mesh, with the pipeline's
entry points as methods.

Counterpart of ``openmvs_tpu/scene.py``: the data classes (``SceneImage``,
``PointCloud``, ``Mesh``, ``Scene``), loading and saving (``.mvs``
interface streams through ``io/mvs``, the reference's boost "MVS project"
archives through ``io/boost_archive``, geometry imports from ``.ply``,
``.obj``, ``.glb`` and ``.dmap``; images decoded by ``io/images``), the
region of interest and view-neighbour files, the visibility filter of the
dense cloud, and the pyOpenMVS-parity methods (``dense_reconstruction`` ->
``reconstruct_mesh`` -> ``clean_mesh`` -> ``refine_mesh`` ->
``texture_mesh``, ``save_pointcloud``, ``load_mesh``, ``save_mesh``), the
device stages with a ``device`` argument, and the scene transforms of the
``transform`` subcommand (``align_to``, ``apply_transform``,
``transform34``, ``scale_images``, ``compute_leveled_volume``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from openmvs_tpu_torch.geometry.camera import Camera, denormalize_K, scale_K
from openmvs_tpu_torch.io import boost_archive as bar
from openmvs_tpu_torch.io import images as imio
from openmvs_tpu_torch.io import mvs as mvsio
from openmvs_tpu_torch.io import ply as plyio
from openmvs_tpu_torch.io.mvs import ImageMeta
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("scene")

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
        """Load pixels, optionally capped so max(h, w) == max_dim."""
        color = imio.load_color(self.path)
        h, w = color.shape[:2]
        if (w, h) != (self.width, self.height) and self.width > 0:
            # native resolution differs from metadata: rescale camera to match
            self.camera = Camera(
                scale_K(self.camera.K, max(w, h) / max(self.width, self.height)),
                self.camera.R,
                self.camera.C,
            )
        self.width, self.height = w, h
        self.scale = 1.0
        if max_dim is not None and max(w, h) > max_dim:
            self.scale = max_dim / max(w, h)
            nw, nh = round(w * self.scale), round(h * self.scale)
            self.scale = max(nw, nh) / max(w, h)
            color = imio.resize_area(color, nw, nh)
        self.color = color
        self.gray = imio.to_gray(color)
        # optional segmentation mask (Image::maskName role), applied by the
        # stages through ignore_mask_label
        if self.meta.mask_name:
            mp = self.meta.mask_name
            if not os.path.isabs(mp):
                mp = os.path.join(os.path.dirname(self.path), mp)
            if os.path.exists(mp):
                m = imio.load_gray_u8(mp)
                if m.shape != self.gray.shape:
                    m = imio.resize_nearest(m, self.gray.shape[1], self.gray.shape[0])
                self.mask = m
        else:
            self.mask = None

    def usable_mask(self, ignore_label: int):
        """(h, w) bool of pixels allowed for estimation, or None."""
        if self.mask is None or ignore_label < 0:
            return None
        return self.mask != ignore_label

    def release(self):
        self.color = None
        self.gray = None
        self.mask = None


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
    """Posed images + sparse/dense point cloud + mesh (+ optional region of
    interest)."""

    def __init__(self):
        self.platforms: List[mvsio.Platform] = []
        self.images: List[SceneImage] = []
        self.pointcloud = PointCloud()
        self.mesh = Mesh()
        self.transform = np.eye(4)
        self.obb_rot = np.zeros((3, 3))
        self.obb_min = np.zeros(3)
        self.obb_max = np.zeros(3)
        self.working_folder = "."

    # ------------------------------------------------------------------ load
    @staticmethod
    def load(path: str) -> "Scene":
        """Load a scene from .mvs (MVSI Interface) or import geometry
        directly: .ply (point cloud, or mesh when faces present), .obj/.glb
        (mesh), .dmap (one posed view + its unprojected depths), matching
        the reference's Scene::Load import breadth (Scene.cpp:483-632)."""
        ext = os.path.splitext(path)[1].lower()
        if ext in (".ply", ".obj", ".glb", ".gltf"):
            return Scene._import_geometry(path, ext)
        if ext == ".dmap":
            return Scene._import_dmap(path)
        if bar.is_project(path):
            # boost-serialization "MVS project" archive: the reference's
            # default save when a mesh is present (Scene.cpp:591-618)
            return Scene._from_boost_project(path)
        itf = mvsio.load(path)
        return Scene.from_interface(itf, os.path.dirname(os.path.abspath(path)))

    @staticmethod
    def from_interface(itf: mvsio.Interface, working_folder: str = ".") -> "Scene":
        """Build a Scene from an in-memory Interface (shared by .mvs loading
        and the SfM/dataset importers)."""
        scene = Scene()
        scene.working_folder = working_folder
        scene.platforms = itf.platforms
        scene.transform = itf.transform
        scene.obb_rot, scene.obb_min, scene.obb_max = itf.obb_rot, itf.obb_min, itf.obb_max
        for idx, meta in enumerate(itf.images):
            plat = itf.platforms[meta.platform_id]
            rig = plat.cameras[meta.camera_id]
            pose = plat.poses[meta.pose_id]
            if meta.id == 0xFFFFFFFF:
                meta.id = idx
            # compose rig-relative camera with platform pose
            # (Platform::GetPose, reference libs/MVS/Platform.cpp:44-55):
            # R = rigR * poseR;  C = poseR.T * rigC + poseC
            R = rig.R @ pose.R
            C = pose.R.T @ rig.C + pose.C
            K = rig.K if rig.has_resolution else None
            path_img = meta.name
            if not os.path.isabs(path_img):
                path_img = os.path.join(scene.working_folder, path_img)
            width, height = rig.width, rig.height
            if K is None:
                # normalized K: needs image resolution; probe the header
                width, height = imio.image_size(path_img)
                K = denormalize_K(rig.K, width, height)
            cam = Camera(K, R, C)
            si = SceneImage(meta=meta, camera=cam, width=width, height=height, path=path_img)
            scene.images.append(si)
        scene.pointcloud = PointCloud(
            points=itf.points,
            views=itf.point_views,
            weights=itf.point_confidences,
            normals=itf.normals,
            colors=itf.colors,
        )
        return scene

    # ------------------------------------------------------------------ save
    def _ensure_platforms(self):
        if not self.platforms and self.images:
            # scenes built programmatically carry cameras on the images only;
            # synthesize one platform per image (identity rig + camera pose)
            # so the archive round-trips (the Interface has no per-image K)
            for i, img in enumerate(self.images):
                rig = mvsio.CameraRig(name=f"cam{i}", width=img.width,
                                      height=img.height,
                                      K=np.asarray(img.camera.K, np.float64))
                pose = mvsio.Pose(R=np.asarray(img.camera.R, np.float64),
                                  C=np.asarray(img.camera.C, np.float64))
                self.platforms.append(mvsio.Platform(
                    name=f"platform{i}", cameras=[rig], poses=[pose]))
                img.meta.platform_id = i
                img.meta.camera_id = 0
                img.meta.pose_id = 0

    def save(self, path: str):
        itf = mvsio.Interface()
        self._ensure_platforms()
        itf.platforms = self.platforms
        itf.transform = self.transform
        itf.obb_rot, itf.obb_min, itf.obb_max = self.obb_rot, self.obb_min, self.obb_max
        for img in self.images:
            # store resolvable (absolute) image paths, as the reference does
            # when re-saving scenes (MAKE_PATH_FULL in Scene::SaveInterface)
            if img.path:
                img.meta.name = os.path.abspath(img.path)
            itf.images.append(img.meta)
        pc = self.pointcloud
        itf.points = np.asarray(pc.points, np.float32)
        itf.point_views = [np.asarray(v, np.uint32) for v in pc.views]
        itf.point_confidences = [
            np.asarray(pc.weights[i], np.float32) if i < len(pc.weights)
            else np.zeros(len(v), np.float32)
            for i, v in enumerate(pc.views)
        ] if pc.weights else [np.zeros(len(v), np.float32) for v in pc.views]
        itf.normals = np.asarray(pc.normals, np.float32).reshape(-1, 3)
        itf.colors = np.asarray(pc.colors, np.uint8).reshape(-1, 3)
        mvsio.save(itf, path)

    def is_bounded(self) -> bool:
        return bool(np.any(self.obb_max - self.obb_min > 0))

    # ------------------------------------------------- boost project archives
    @staticmethod
    def _from_boost_project(path: str) -> "Scene":
        """Build a Scene from a reference 'MVS project' archive.  Platform
        cameras carry normalized K (Camera.h:57); the full per-image K is
        recovered with the pixel-center ScaleK convention and the stored
        image resolution (Image::GetCamera, libs/MVS/Image.cpp:186-201)."""
        ps = bar.load_project(path)
        scene = Scene()
        scene.working_folder = os.path.dirname(os.path.abspath(path))
        scene.platforms = ps.platforms
        for idx, pim in enumerate(ps.images):
            plat = ps.platforms[pim.platform_id]
            rig = plat.cameras[pim.camera_id]
            pose = plat.poses[pim.pose_id]
            R = rig.R @ pose.R
            C = pose.R.T @ rig.C + pose.C
            K = scale_K(rig.K, float(max(pim.width, pim.height)))
            meta = mvsio.ImageMeta(
                name=pim.name, mask_name=pim.mask_name,
                platform_id=pim.platform_id, camera_id=pim.camera_id,
                pose_id=pim.pose_id,
                id=pim.id if pim.id != 0xFFFFFFFF else idx,
                avg_depth=pim.avg_depth, view_scores=list(pim.neighbors))
            scene.images.append(SceneImage(
                meta=meta, camera=Camera(K, R, C),
                width=pim.width, height=pim.height, path=pim.name))
        scene.pointcloud = PointCloud(
            points=np.asarray(ps.points, np.float32).reshape(-1, 3),
            views=list(ps.point_views), weights=list(ps.point_weights),
            normals=np.asarray(ps.normals, np.float32).reshape(-1, 3),
            colors=np.asarray(ps.colors, np.uint8).reshape(-1, 3))
        pm = ps.mesh
        if len(pm.vertices):
            mesh = Mesh(vertices=np.asarray(pm.vertices, np.float32),
                        faces=np.asarray(pm.faces, np.int32).reshape(-1, 3))
            if len(pm.face_texcoords) and pm.textures:
                ftc_pix = np.asarray(pm.face_texcoords, np.float32)
                if (len(ftc_pix) == len(mesh.vertices)
                        and len(ftc_pix) != 3 * len(mesh.faces)):
                    # per-vertex texcoord variant: expand to per-corner
                    ftc_pix = ftc_pix[np.asarray(pm.faces, np.int64).ravel()]
                nf = len(mesh.faces)
                texind = (np.asarray(pm.face_texindices, np.int64)
                          if len(pm.face_texindices) == nf
                          else np.zeros(nf, np.int64))
                wh = np.array([[t.shape[1], t.shape[0]] for t in pm.textures],
                              np.float32)
                per_corner = np.repeat(np.clip(texind, 0, len(pm.textures) - 1), 3)
                # pixel units -> normalized uv, v flipped
                # (Mesh::FaceTexcoordsNormalize, Mesh.cpp:1012-1047)
                uv = (ftc_pix[: 3 * nf] + 0.5) / wh[per_corner]
                uv[:, 1] = 1.0 - uv[:, 1]
                mesh.face_tex_coords = uv.reshape(-1, 3, 2).astype(np.float32)
                pages = [np.ascontiguousarray(t[:, :, ::-1]) for t in pm.textures]
                mesh.texture = pages[0]
                if len(pages) > 1:
                    mesh.textures = pages
                    mesh.face_page = texind.astype(np.int32)
            scene.mesh = mesh
        scene.obb_rot = np.asarray(ps.obb_rot, np.float64)
        scene.obb_min = np.asarray(ps.obb_pos - ps.obb_ext, np.float64)
        scene.obb_max = np.asarray(ps.obb_pos + ps.obb_ext, np.float64)
        return scene

    def save_project(self, path: str, archive_type="zstd"):
        """Save as a reference-compatible 'MVS project' archive (the format
        the reference's Scene::Save writes when a mesh is present).  Carries
        the mesh — which the MVSI interface stream cannot."""
        self._ensure_platforms()
        ps = bar.ProjectScene()
        for plat in self.platforms:
            cams = []
            for rig in plat.cameras:
                K = np.asarray(rig.K, np.float64)
                if rig.has_resolution:
                    # project archives store normalized K (Camera.h:57)
                    K = scale_K(K, 1.0 / float(max(rig.width, rig.height)))
                cams.append(mvsio.CameraRig(name=rig.name, K=K, R=rig.R,
                                            C=rig.C))
            ps.platforms.append(mvsio.Platform(
                name=plat.name, cameras=cams, poses=list(plat.poses)))
        for img in self.images:
            ps.images.append(bar.ProjectImage(
                platform_id=img.meta.platform_id, camera_id=img.meta.camera_id,
                pose_id=img.meta.pose_id, id=img.meta.id,
                name=os.path.abspath(img.path) if img.path else img.meta.name,
                mask_name=img.meta.mask_name, width=img.width,
                height=img.height, neighbors=list(img.meta.view_scores),
                avg_depth=img.meta.avg_depth))
        pc = self.pointcloud
        ps.points = np.asarray(pc.points, np.float32).reshape(-1, 3)
        ps.point_views = [np.asarray(v, np.uint32) for v in pc.views]
        ps.point_weights = [np.asarray(w, np.float32) for w in pc.weights]
        ps.normals = np.asarray(pc.normals, np.float32).reshape(-1, 3)
        ps.colors = np.asarray(pc.colors, np.uint8).reshape(-1, 3)
        mesh = self.mesh
        if mesh is not None and len(mesh.faces):
            pm = ps.mesh
            pm.vertices = np.asarray(mesh.vertices, np.float32).reshape(-1, 3)
            pm.faces = np.asarray(mesh.faces, np.uint32).reshape(-1, 3)
            if mesh.has_texture:
                pages = mesh.textures if mesh.textures else [mesh.texture]
                pm.textures = [np.ascontiguousarray(p[:, :, ::-1]) for p in pages]
                nf = len(mesh.faces)
                face_page = (np.asarray(mesh.face_page, np.int64)
                             if mesh.face_page is not None
                             else np.zeros(nf, np.int64))
                pm.face_texindices = face_page.astype(np.uint8)
                wh = np.array([[p.shape[1], p.shape[0]] for p in pages],
                              np.float32)
                uv = np.asarray(mesh.face_tex_coords, np.float32).reshape(-1, 2).copy()
                uv[:, 1] = 1.0 - uv[:, 1]
                # normalized uv -> pixel units
                # (Mesh::FaceTexcoordsUnnormalize, Mesh.cpp:1049-1082)
                pm.face_texcoords = (uv * wh[np.repeat(face_page, 3)]
                                     - 0.5).astype(np.float32)
        if self.is_bounded():
            ps.obb_rot = np.asarray(self.obb_rot, np.float32)
            ps.obb_pos = ((np.asarray(self.obb_min) + np.asarray(self.obb_max))
                          / 2).astype(np.float32)
            ps.obb_ext = ((np.asarray(self.obb_max) - np.asarray(self.obb_min))
                          / 2).astype(np.float32)
        bar.save_project(ps, path, archive_type)

    # --------------------------------------------------------- transforms
    def align_to(self, ref_scene: "Scene") -> np.ndarray:
        """Estimate + apply the similarity aligning this scene onto
        ref_scene via matched camera centers (Scene::AlignTo,
        Scene.cpp:1588-1620).  Returns the 4x4 transform."""
        from openmvs_tpu_torch.geometry.similarity import align_scenes

        return align_scenes(self, ref_scene)

    def apply_transform(self, T: np.ndarray):
        """Apply a 4x4 similarity transform to the whole scene
        (Scene::Transform role, reference Scene.cpp:1445-1530): platform
        poses, point cloud, mesh and OBB all move together."""
        T = np.asarray(T, np.float64)
        A = T[:3, :3]
        t = T[:3, 3]
        s = float(np.cbrt(max(np.linalg.det(A), 1e-30)))
        Q = A / s  # rotation part
        for plat in self.platforms:
            for pose in plat.poses:
                pose.R = pose.R @ Q.T
                pose.C = A @ pose.C + t
        for img in self.images:
            # recompose from the transformed pose exactly as the reference's
            # image.UpdateCamera(platforms) does (Scene.cpp:1545-1548) — a
            # direct camera transform would scale the rig lever arm, which
            # the pose update deliberately does not, so the live camera
            # would diverge from its own save/reload composition
            m = img.meta
            if (0 <= m.platform_id < len(self.platforms)
                    and 0 <= m.pose_id < len(self.platforms[m.platform_id].poses)):
                plat = self.platforms[m.platform_id]
                rig = plat.cameras[m.camera_id]
                pose = plat.poses[m.pose_id]
                img.camera = Camera(img.camera.K, rig.R @ pose.R,
                                    pose.R.T @ rig.C + pose.C)
            else:
                img.camera = Camera(img.camera.K, img.camera.R @ Q.T,
                                    A @ img.camera.C + t)
        if len(self.pointcloud.points):
            self.pointcloud.points = (
                self.pointcloud.points @ A.T + t
            ).astype(np.float32)
            if self.pointcloud.has_normals:
                self.pointcloud.normals = (
                    self.pointcloud.normals @ Q.T
                ).astype(np.float32)
        if len(self.mesh.vertices):
            self.mesh.vertices = (self.mesh.vertices @ A.T + t).astype(np.float32)
        self.transform = T @ self.transform

    def estimate_roi(self, mode: int = 1, scale: float = 1.1) -> bool:
        """Estimate the region of interest from cameras + sparse cloud
        (Scene::EstimateROI, reference Scene.cpp:1651-1740 semantics):

        1. scene center = camera-center median shifted along the mean view
           direction by tan(asin(|dir_mean|)) x median camera distance;
           scene radius = max camera distance to that center
        2. core points = points whose depth from some observing view is
           < 2 x radius
        3. ROI = axis-aligned box of the core points, extents enlarged by
           `scale`

        mode=2 additionally treats the scene as unbounded (returns False)
        when the camera-direction mean is unbalanced (|mean| > sqrt(2)/2,
        i.e. cameras mostly look one way — an open outdoor scene) or the
        estimated center sits behind any camera.  mode=0 is a no-op."""
        if mode <= 0 or len(self.pointcloud) < 10:
            return False
        cams = [im.camera for im in self.images]
        if len(cams) < 3:
            return False
        C = np.stack([c.C for c in cams])
        dirs = np.stack([c.view_dir() for c in cams])
        cam_center = np.median(C, axis=0)
        dir_mean = dirs.mean(axis=0)
        dlen = float(np.linalg.norm(dir_mean))
        if dlen > 1e-12:
            dir_mean = dir_mean / dlen
        if dlen > np.sqrt(2.0) / 2.0 and mode == 2:
            log.info("camera directions unbalanced: scene unbounded (no ROI)")
            return False
        cam_dist_med = float(np.median(np.linalg.norm(C - cam_center, axis=1)))
        shift = np.tan(np.arcsin(np.clip(dlen, 0.0, 0.999)))
        scene_center = cam_center + shift * cam_dist_med * dir_mean
        depths = np.array([c.point_depth(scene_center[None])[0] for c in cams])
        if (depths <= 0).any() and mode == 2:
            log.info("a camera points away from the scene center: unbounded")
            return False
        radius = float(np.linalg.norm(C - scene_center, axis=1).max())
        # core points: observed at depth < 2 x radius by some view
        pts = np.asarray(self.pointcloud.points, np.float64)
        id_to_idx = {im.meta.id: i for i, im in enumerate(self.images)}
        core = np.zeros(len(pts), bool)
        views = self.pointcloud.views
        # per-camera vectorized depth test over the points it observes
        cam_pts: dict = {}
        for i, v in enumerate(views):
            for vid in v:
                j = id_to_idx.get(int(vid))
                if j is not None:
                    cam_pts.setdefault(j, []).append(i)
        for j, idx in cam_pts.items():
            idx = np.asarray(idx, np.int64)
            d = cams[j].point_depth(pts[idx])
            core[idx[d < 2.0 * radius]] = True
        if not core.any():
            return False
        lo = pts[core].min(axis=0)
        hi = pts[core].max(axis=0)
        c = 0.5 * (lo + hi)
        half = 0.5 * (hi - lo) * scale
        self.obb_rot = np.eye(3)
        self.obb_min = c - half
        self.obb_max = c + half
        log.info("ROI: %d/%d core points, box extent %s", int(core.sum()),
                 len(pts), np.round(hi - lo, 3))
        return True

    def save_roi(self, path: str) -> None:
        """Write the scene ROI in the reference's OBB text layout
        (OBB.h:96-101 operator<<): 3x3 rotation rows, center, half-extents."""
        c = 0.5 * (self.obb_min + self.obb_max)
        e = 0.5 * (self.obb_max - self.obb_min)
        with open(path, "w") as f:
            for row in self.obb_rot:
                f.write(" ".join(f"{v:.17g}" for v in row) + "\n")
            f.write(" ".join(f"{v:.17g}" for v in c) + "\n")
            f.write(" ".join(f"{v:.17g}" for v in e) + "\n")

    def load_roi(self, path: str) -> None:
        """Read an OBB text file written by save_roi (or the reference's
        `--export-roi-file`)."""
        vals = np.array(open(path).read().split(), np.float64)
        if len(vals) != 15:
            raise ValueError(f"ROI file must hold 15 numbers, got {len(vals)}")
        self.obb_rot = vals[:9].reshape(3, 3)
        c, e = vals[9:12], vals[12:15]
        self.obb_min = c - e
        self.obb_max = c + e

    def load_view_neighbors(self, path: str) -> None:
        """Read a view-neighbors list (Scene::LoadViewNeighbors,
        Scene.cpp:423-457): one line per image, `ID nb1 nb2 ...`, `#`
        comments ignored.  Neighbors get the reference's default score
        fields (score 3, angle 15deg, scale 1, area 0.5)."""
        by_id = {im.meta.id: im for im in self.images}
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2 or parts[0].startswith("#"):
                    continue
                im = by_id.get(int(parts[0]))
                if im is None:
                    continue
                im.meta.view_scores = [
                    mvsio.ViewScore(id=int(n), points=0, scale=1.0,
                                    angle=np.deg2rad(15.0), area=0.5,
                                    score=3.0)
                    for n in parts[1:]
                ]

    def save_view_neighbors(self, path: str) -> None:
        """Write the computed neighbor lists (Scene::SaveViewNeighbors,
        Scene.cpp:458-479): `ID nb1 nb2 ...` per image."""
        with open(path, "w") as f:
            for im in self.images:
                f.write(" ".join(
                    [str(im.meta.id)]
                    + [str(vs.id) for vs in (im.meta.view_scores or [])]
                ) + "\n")

    def roi_contains(self, pts: np.ndarray) -> np.ndarray:
        """Per-point OBB membership under the reference convention
        (Interface.h:665-668): obb_rot rotates world->OBB coordinates and
        obb_min/obb_max are corners IN OBB coordinates, so the test is
        obb_min <= rot @ p <= obb_max (no world-center subtraction)."""
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

    @staticmethod
    def _import_geometry(path: str, ext: str) -> "Scene":
        scene = Scene()
        scene.working_folder = os.path.dirname(os.path.abspath(path))
        if ext == ".ply":
            data = plyio.load(path)
            faces = data.faces
            if faces is not None and len(faces):
                # the PLY loader fan-triangulates polygon faces, so this
                # is always a uniform (n, 3) array
                scene.mesh = Mesh(vertices=data.vertices.astype(np.float32),
                                  faces=np.asarray(faces, np.int32))
            else:
                pc = PointCloud()
                pc.points = data.vertices.astype(np.float32)
                pc.views = [np.zeros(0, np.uint32)] * len(pc.points)
                pc.weights = [np.zeros(0, np.float32)] * len(pc.points)
                v = data.elements.get("vertex", {})
                if {"red", "green", "blue"} <= set(v):
                    pc.colors = np.stack(
                        [v["red"], v["green"], v["blue"]], -1).astype(np.uint8)
                if {"nx", "ny", "nz"} <= set(v):
                    pc.normals = np.stack(
                        [v["nx"], v["ny"], v["nz"]], -1).astype(np.float32)
                scene.pointcloud = pc
        elif ext == ".obj":
            from openmvs_tpu_torch.io import obj as objio

            v, f, _, _ = objio.load_mesh_obj(path)
            scene.mesh = Mesh(vertices=v.astype(np.float32),
                              faces=f.astype(np.int32))
        else:
            from openmvs_tpu_torch.io import gltf as gltfio

            out = gltfio.load_mesh_glb(path)
            scene.mesh = Mesh(vertices=np.asarray(out[0], np.float32),
                              faces=np.asarray(out[1], np.int32))
        return scene

    @staticmethod
    def _import_dmap(path: str) -> "Scene":
        from openmvs_tpu_torch.io import dmap as dmapio

        dd = dmapio.load(path)
        scene = Scene()
        scene.working_folder = os.path.dirname(os.path.abspath(path))
        K = np.asarray(dd.K, np.float64)
        R = np.asarray(dd.R, np.float64)
        C = np.asarray(dd.C, np.float64)
        rig = mvsio.CameraRig(name="dmap", width=dd.image_width,
                              height=dd.image_height,
                              K=scale_K(K, max(dd.image_width, dd.image_height)
                                        / max(dd.width, dd.height)))
        scene.platforms.append(mvsio.Platform(
            name="dmap", cameras=[rig], poses=[mvsio.Pose(R=R, C=C)]))
        vid = int(dd.view_ids[0]) if len(dd.view_ids) else 0
        meta = mvsio.ImageMeta(name=dd.file_name, platform_id=0, camera_id=0,
                               pose_id=0, id=vid,
                               min_depth=dd.depth_min, max_depth=dd.depth_max)
        # dd.K is at DEPTH-map resolution (dmap.py): unproject with it, but
        # the SceneImage (width/height = full image resolution) must carry
        # the image-resolution camera or every downstream projection is off
        # by the depth/image scale factor
        cam = Camera(K, R, C)
        cam_img = Camera(
            scale_K(K, max(dd.image_width, dd.image_height)
                    / max(dd.width, dd.height)), R, C)
        scene.images.append(SceneImage(
            meta=meta, camera=cam_img, width=dd.image_width,
            height=dd.image_height, path=dd.file_name))
        ys, xs = np.nonzero(dd.depth > 0)
        if len(ys):
            d = dd.depth[ys, xs].astype(np.float64)
            uv = np.stack([xs, ys], -1).astype(np.float64)
            pts = cam.unproject(uv, d).astype(np.float32)
            pc = PointCloud()
            pc.points = pts
            pc.views = [np.array([vid], np.uint32)] * len(pts)
            pc.weights = [np.ones(1, np.float32)] * len(pts)
            if dd.normal is not None:
                pc.normals = (dd.normal[ys, xs] @ R).astype(np.float32)
            scene.pointcloud = pc
        return scene

    def point_cloud_filter(self, th_remove: int = -1) -> int:
        """Visibility-based dense-cloud outlier filter
        (Scene::PointCloudFilter, SceneDensify.cpp:2226-2359): for every
        camera ray through an observed point, points IN FRONT of the
        observation (free space the camera saw through) are penalized by the
        observation's view count and points BEHIND are credited; points with
        net visibility <= th_remove are dropped.  The reference walks a
        1-pixel cone through an octree; here each camera's points are binned
        into the pixel grid (the same 1-px cone footprint) and the per-cell
        nearest OBSERVED depth plays the cone hit.  Returns removed count."""
        pc = self.pointcloud
        n = len(pc)
        if n == 0:
            return 0
        pts = np.asarray(pc.points, np.float64)
        visibility = np.zeros(n, np.int64)
        view_counts = np.array([len(v) for v in pc.views], np.int64)
        # flat CSR view of the ragged per-point view lists: observed-by-vid
        # masks become one boolean scatter per camera instead of a Python
        # set() per point per camera
        flat_vids = (np.concatenate(pc.views).astype(np.int64)
                     if view_counts.sum() else np.zeros(0, np.int64))
        flat_pts = np.repeat(np.arange(n, dtype=np.int64), view_counts)
        th_sim = 0.01
        for img in self.images:
            cam = img.camera if img.camera is not None else img.working_camera()
            vid = img.meta.id
            Xc = (pts - cam.C) @ cam.R.T
            z = Xc[:, 2]
            front = z > 1e-9
            u = np.where(front, cam.K[0, 0] * Xc[:, 0] / np.where(front, z, 1)
                         + cam.K[0, 2], -1)
            v = np.where(front, cam.K[1, 1] * Xc[:, 1] / np.where(front, z, 1)
                         + cam.K[1, 2], -1)
            W, H = img.width or 1, img.height or 1
            ui = np.floor(u).astype(np.int64)
            vi = np.floor(v).astype(np.int64)
            inimg = front & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
            observed = np.zeros(n, bool)
            observed[flat_pts[flat_vids == vid]] = True
            observed &= inimg
            if not observed.any():
                continue
            cell = vi * W + ui
            # per-cell nearest observed depth + its weight: sort by
            # (cell, z) and keep the first entry per cell
            oc = cell[observed]
            oz = z[observed]
            ow = view_counts[observed]
            order = np.lexsort((oz, oc))
            oc_s, oz_s, ow_s = oc[order], oz[order], ow[order]
            first = np.r_[True, oc_s[1:] != oc_s[:-1]]
            cells_u, depth_u, weight_u = oc_s[first], oz_s[first], ow_s[first]
            qi = np.nonzero(inimg)[0]
            pos = np.searchsorted(cells_u, cell[qi])
            pos_c = np.minimum(pos, len(cells_u) - 1)
            hit = cells_u[pos_c] == cell[qi]
            d = depth_u[pos_c]
            zq = z[qi]
            infront = hit & (zq < d * (1 - th_sim))
            behind = hit & (zq > d * (1 + th_sim))
            visibility[qi[infront]] -= weight_u[pos_c[infront]]
            visibility[qi[behind]] += view_counts[qi[behind]]
        keep = visibility > th_remove
        removed = int((~keep).sum())
        if removed:
            pc.points = pc.points[keep]
            pc.views = [v for v, k in zip(pc.views, keep) if k]
            if len(pc.weights) == len(keep):
                pc.weights = [w for w, k in zip(pc.weights, keep) if k]
            if pc.has_normals:
                pc.normals = pc.normals[keep]
            if pc.has_colors:
                pc.colors = pc.colors[keep]
        return removed

    # ------------------------------------------------------------- utilities
    @property
    def n_views(self) -> int:
        return len(self.images)

    # ------------------------------------------------- pyOpenMVS-parity API
    # The reference ships boost::python bindings exposing the full pipeline
    # as Scene methods (libs/MVS/PythonWrapper.cpp:116-137); the JAX package
    # keeps their names and defaults (openmvs_tpu/scene.py:796-957), and so
    # does the port, with ``device`` passed to the stages that take one.

    def save_pointcloud(self, path: str) -> None:
        """pyOpenMVS Scene.save_pointcloud (PythonWrapper.cpp:122)."""
        self.pointcloud.save_ply(path)

    def load_mesh(self, path: str) -> None:
        """pyOpenMVS Scene.load_mesh: replace the scene mesh from
        .ply/.obj/.glb (PythonWrapper.cpp:123)."""
        ext = os.path.splitext(path)[1].lower()
        self.mesh = Scene._import_geometry(path, ext).mesh

    def save_mesh(self, path: str) -> None:
        """pyOpenMVS Scene.save_mesh (PythonWrapper.cpp:124): format by
        extension (.ply/.obj/.glb)."""
        ext = os.path.splitext(path)[1].lower()
        if ext == ".obj":
            from openmvs_tpu_torch.io.obj import save_mesh_obj

            save_mesh_obj(path, self.mesh.vertices, self.mesh.faces,
                          self.mesh.face_tex_coords, self.mesh.texture,
                          textures=self.mesh.textures,
                          face_page=self.mesh.face_page)
        elif ext == ".glb":
            from openmvs_tpu_torch.io.gltf import save_mesh_glb

            save_mesh_glb(path, self.mesh.vertices, self.mesh.faces,
                          face_tex_coords=self.mesh.face_tex_coords,
                          texture=self.mesh.texture,
                          textures=self.mesh.textures,
                          face_page=self.mesh.face_page)
        else:
            self.mesh.save_ply(path)

    def scale_images(self, max_resolution: int = 0, scale: float = 1.0,
                     folder: str = "") -> int:
        """pyOpenMVS Scene.scale_images (Scene::ScaleImages role,
        Scene.cpp:1507): resize loaded images by `scale` (or to fit
        max_resolution), optionally writing the resized files to `folder`;
        returns the number of images resized.  Cameras need no update: the
        per-resolution K scaling happens at use time (Camera.scaled)."""
        n = 0
        for img in self.images:
            if img.gray is None:
                img.load()
            w, h = img.width, img.height
            s = scale
            if max_resolution > 0 and max(w, h) * s > max_resolution:
                s = max_resolution / max(w, h)
            if s >= 1.0 - 1e-9:
                continue
            nw, nh = max(1, round(w * s)), max(1, round(h * s))
            img.gray = imio.resize_area(img.gray, nw, nh)
            if img.color is not None:
                img.color = imio.resize_area(img.color, nw, nh)
            # keep the native camera consistent with the new native size
            # (reload self-corrects from the file header, SceneImage.load)
            img.camera = img.camera.scaled(max(nw, nh) / max(w, h))
            img.width, img.height = nw, nh
            n += 1
            if folder:
                os.makedirs(folder, exist_ok=True)
                out = os.path.join(folder, os.path.basename(img.meta.name))
                src = img.color if img.color is not None else img.gray
                arr = np.clip(src * 255.0, 0, 255).astype(np.uint8) \
                    if src.dtype != np.uint8 else src
                imio.imwrite(out, arr[..., ::-1] if arr.ndim == 3 else arr)
                img.meta.name = out
                img.path = out
        return n

    def transform34(self, T: np.ndarray) -> None:
        """pyOpenMVS Scene.transform34: apply a 3x4 [R|t] (PythonWrapper
        .cpp:127)."""
        T = np.asarray(T, np.float64).reshape(3, 4)
        T4 = np.eye(4)
        T4[:3] = T
        self.apply_transform(T4)

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

    def compute_leveled_volume(self, plane_threshold: float = 20.0,
                               sample_mesh: float = -100000,
                               up_axis: int = 2) -> float:
        """pyOpenMVS Scene.compute_leveled_volume (Scene::
        ComputeLeveledVolume, Scene.cpp:1621-1646): estimate the ground
        plane, rotate the scene so `up_axis` aligns with its normal with
        the plane through the origin, then return the mesh volume
        (divergence theorem over faces).  The open ground-contact boundary
        closes implicitly against the z=0 plane."""
        from openmvs_tpu_torch import mesh_ops
        from openmvs_tpu_torch.geometry.similarity import estimate_ground_plane

        if len(self.mesh.faces) == 0:
            raise ValueError("no mesh to compute volume of")
        if plane_threshold >= 0:
            # sample_mesh semantics per the reference (Scene.cpp:1619):
            # 0 disabled (use vertices), <0 sample |n| surface points,
            # >0 sample density per square unit of surface area
            pts = self.mesh.vertices
            if sample_mesh < 0:
                pts = mesh_ops.sample_points(
                    self.mesh, int(-sample_mesh), seed=0)[0]
            elif sample_mesh > 0:
                areas = mesh_ops.face_areas(self.mesh)
                n_pts = max(1, int(round(float(areas.sum()) * sample_mesh)))
                pts = mesh_ops.sample_points(self.mesh, n_pts, seed=0)[0]
            n, d = estimate_ground_plane(np.asarray(pts, np.float64),
                                         threshold=plane_threshold
                                         if plane_threshold > 0 else 0.0)
            up = np.zeros(3)
            up[up_axis] = 1.0
            if float(n @ up) < 0:
                n, d = -n, -d
            # rotate n -> up, then translate the plane to the origin
            R = _rotation_between(n, up)
            center = self.mesh.vertices.mean(axis=0).astype(np.float64)
            foot = center - (float(n @ center) + d) * n
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = -R @ foot
            self.apply_transform(T)
        return mesh_ops.compute_volume(self.mesh)


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Minimal rotation taking unit vector a to unit vector b."""
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-12:
        # 180 degrees: any axis orthogonal to a
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-8:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        return -np.eye(3) + 2 * np.outer(axis, axis)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K / (1 + c)
