"""Pinhole camera model.

Conventions match the reference exactly (libs/MVS/Camera.h:46-56):
right-handed coordinate system, ``P = K R [I | -C]``, camera at ``C`` looking
down +Z in camera space, image origin top-left, **integer pixel coordinates
are pixel centers**.

All math here is plain numpy on float64 (host side, per-scene-tiny); the
device-side kernels receive the small constant matrices produced here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def scale_K(K: np.ndarray, s: float) -> np.ndarray:
    """Scale intrinsics by image-resize factor ``s``.

    Uses the pixel-center convention of the reference (Interface.h:475-480):
    focal lengths scale by ``s``; principal point maps ``c' = (c+0.5)*s-0.5``.
    """
    K = np.asarray(K, np.float64)
    out = K.copy()
    out[0, 0] *= s
    out[1, 1] *= s
    out[0, 1] *= s
    out[0, 2] = (K[0, 2] + 0.5) * s - 0.5
    out[1, 2] = (K[1, 2] + 0.5) * s - 0.5
    return out


def denormalize_K(K: np.ndarray, width: int, height: int) -> np.ndarray:
    """Expand a resolution-normalized K to absolute pixels.

    The interchange format stores K normalized by ``max(width, height)`` when
    the camera has no resolution attached (Interface.h:386,469-480).
    """
    K = np.asarray(K, np.float64)
    scale = float(max(width, height))
    out = K.copy()
    out[0, 0] *= scale
    out[1, 1] *= scale
    out[0, 1] *= scale
    out[0, 2] *= scale
    out[1, 2] *= scale
    return out


def compose_P(K: np.ndarray, R: np.ndarray, C: np.ndarray) -> np.ndarray:
    """P = K R [I | -C]  (3x4)."""
    K = np.asarray(K, np.float64)
    R = np.asarray(R, np.float64)
    C = np.asarray(C, np.float64).reshape(3)
    Rt = np.concatenate([R, (-R @ C)[:, None]], axis=1)
    return K @ Rt


@dataclass
class Camera:
    """A fully-resolved camera for one image at a specific resolution."""

    K: np.ndarray  # (3,3) float64, absolute pixels
    R: np.ndarray  # (3,3) float64, world->camera rotation
    C: np.ndarray  # (3,)  float64, camera center in world coords

    P: np.ndarray = field(init=False)

    def __post_init__(self):
        self.K = np.asarray(self.K, np.float64).reshape(3, 3)
        self.R = np.asarray(self.R, np.float64).reshape(3, 3)
        self.C = np.asarray(self.C, np.float64).reshape(3)
        self.P = compose_P(self.K, self.R, self.C)

    # -- transforms (Camera.h TransformPoint* family) --
    def world_to_cam(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        return (X - self.C) @ self.R.T

    def cam_to_world(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        return x @ self.R + self.C

    def cam_to_image(self, x: np.ndarray) -> np.ndarray:
        """Project camera-space points to pixel coords (perspective divide)."""
        p = x @ self.K.T
        return p[..., :2] / p[..., 2:3]

    def image_to_cam(self, uv: np.ndarray, depth=None) -> np.ndarray:
        """Back-project pixels (optionally at given depth) to camera space."""
        uv = np.asarray(uv, np.float64)
        ones = np.ones(uv.shape[:-1] + (1,))
        rays = np.concatenate([uv, ones], axis=-1) @ np.linalg.inv(self.K).T
        if depth is None:
            return rays
        return rays * np.asarray(depth, np.float64)[..., None]

    def project(self, X: np.ndarray) -> np.ndarray:
        """World points -> pixel coords."""
        return self.cam_to_image(self.world_to_cam(X))

    def project_h(self, X: np.ndarray) -> np.ndarray:
        """World points -> homogeneous image coords (x, y, z=depth-ish)."""
        return self.world_to_cam(X) @ self.K.T

    def unproject(self, uv: np.ndarray, depth: np.ndarray) -> np.ndarray:
        """Pixels + depth -> world points (TransformPointI2W)."""
        return self.cam_to_world(self.image_to_cam(uv, depth))

    def point_depth(self, X: np.ndarray) -> np.ndarray:
        """Depth of world points along the camera Z axis (Camera.h PointDepth)."""
        X = np.asarray(X, np.float64)
        return (X - self.C) @ self.R[2]

    def footprint_image(self, X: np.ndarray) -> np.ndarray:
        """Pixels per world unit at point X (Camera.h:438-446)."""
        return self.focal_length / self.point_depth(X)

    @property
    def focal_length(self) -> float:
        return float(self.K[0, 0])

    @property
    def Kinv(self) -> np.ndarray:
        return np.linalg.inv(self.K)

    def scaled(self, s: float) -> "Camera":
        """Camera for an image resized by factor ``s``."""
        return Camera(scale_K(self.K, s), self.R, self.C)

    def view_dir(self) -> np.ndarray:
        """Principal viewing direction in world coords."""
        return self.R[2]
