"""The benchmark's scene: a textured height field seen by a grid of cameras.

A frozen copy, in PyTorch on the device, of the port's synthetic scene
(``openmvs_tpu_torch/synthetic.py``: ``height``, ``texture``, ``albedo``,
``camera_intrinsics``, ``ray_march`` and the sigma-0.5 Gaussian smoothing of
``build_gt_scene``), so that later changes to the port cannot move it. It
imports nothing of the port.

A configuration file gives the sizes: the source's image size
(``image_width`` x ``image_height``), the resolution level the maps are
estimated at, the camera grid (``grid`` x ``grid`` centres ``spacing``
apart on z = 0, each looking down +z), and the number of sparse points.
``--seed`` draws the texture's shift and the sparse points; the surface and
the cameras are the same for every seed, so every seed asks for the same
work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

# the ray march of synthetic.ray_march: depth between T_LO and T_HI in
# steps of STEP, then BISECT bisections of the bracketing step
T_LO, T_HI, STEP, BISECT = 4.5, 7.5, 0.02, 40
EXTENT = 3.0  # the surface covers [-EXTENT, EXTENT]^2


def height(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (6.0 + 0.6 * torch.sin(x * 1.3) * torch.cos(y * 1.7)
            + 0.3 * torch.sin(2.9 * x + 1.0) * torch.sin(2.3 * y))


def texture(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    t = (0.5 + 0.18 * torch.sin(7.1 * x) * torch.cos(6.3 * y)
         + 0.14 * torch.sin(13.7 * x + 2.0) + 0.12 * torch.cos(11.3 * y + 1.0)
         + 0.06 * torch.sin(23.0 * x * y))
    return t.clamp(0.02, 0.98)


def albedo(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.stack([texture(x + 0.37 * c, y - 0.23 * c) for c in range(3)], -1)


def intrinsics(W: int, H: int) -> np.ndarray:
    return np.array([[0.9 * W, 0, W / 2 - 0.5], [0, 0.9 * W, H / 2 - 0.5],
                     [0, 0, 1.0]])


def scale_intrinsics(K: np.ndarray, s: float) -> np.ndarray:
    """K of an image resized by ``s``, pixel centres kept (openMVS's
    Camera::ScaleK: c' = (c + 0.5) s - 0.5)."""
    out = np.array(K, np.float64)
    out[0, 0] *= s
    out[1, 1] *= s
    out[0, 1] *= s
    out[0, 2] = (K[0, 2] + 0.5) * s - 0.5
    out[1, 2] = (K[1, 2] + 0.5) * s - 0.5
    return out


def grid_centers(grid: int, spacing: float) -> List[np.ndarray]:
    """Row-major camera centres of a grid x grid lattice around the origin."""
    off = (np.arange(grid) - (grid - 1) / 2) * spacing
    return [np.array([x, y, 0.0]) for y in off for x in off]


def ray_march(K: np.ndarray, C: np.ndarray, W: int, H: int, device,
              dtype=torch.float64):
    """(depth (H, W), x (H, W), y (H, W)) of every pixel centre of a camera
    with identity rotation centred at C: the first crossing of the surface
    between T_LO and T_HI, refined by bisection; depth 0 where the ray
    misses the surface or leaves [-EXTENT, EXTENT]^2. ``dtype`` is the
    arithmetic's precision (the control computes it in bfloat16)."""
    Kinv = np.linalg.inv(K)
    u = torch.arange(W, device=device, dtype=torch.float64)
    v = torch.arange(H, device=device, dtype=torch.float64)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dx = (Kinv[0, 0] * uu + Kinv[0, 1] * vv + Kinv[0, 2]).to(dtype)
    dy = (Kinv[1, 1] * vv + Kinv[1, 2]).to(dtype)
    cx, cy, cz = (torch.tensor(float(c), device=device, dtype=dtype) for c in C)

    def g(t):
        return cz + t - height(cx + t * dx, cy + t * dy)

    steps = np.arange(T_LO + STEP, T_HI + STEP / 2, STEP)
    lo = torch.full(uu.shape, float("nan"), device=device, dtype=dtype)
    t_prev = torch.tensor(T_LO, device=device, dtype=dtype)
    g_prev = g(torch.full(uu.shape, T_LO, device=device, dtype=dtype))
    for t in steps:
        t_t = torch.tensor(float(t), device=device, dtype=dtype)
        g_t = g(t_t.expand(uu.shape))
        first = torch.isnan(lo) & (g_prev < 0) & (g_t >= 0)
        lo = torch.where(first, t_prev, lo)
        t_prev, g_prev = t_t, g_t
    hit = ~torch.isnan(lo)
    a = torch.where(hit, lo, torch.tensor(T_LO, device=device, dtype=dtype))
    b = a + STEP
    for _ in range(BISECT):
        m = 0.5 * (a + b)
        below = g(m) < 0
        a = torch.where(below, m, a)
        b = torch.where(below, b, m)
    t = 0.5 * (a + b)
    x = cx + t * dx
    y = cy + t * dy
    hit = hit & (x.abs() <= EXTENT) & (y.abs() <= EXTENT)
    return torch.where(hit, t, torch.zeros_like(t)), x, y


def _gaussian_05(img: torch.Tensor) -> torch.Tensor:
    """scipy's gaussian_filter(img, 0.5, mode="mirror") over the first two
    axes of (H, W) or (H, W, c): 5 taps (truncate 4), mirror padding."""
    r = 2
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, device=img.device,
                                       dtype=torch.float64) / 0.5) ** 2)
    k = (k / k.sum()).to(img.dtype)
    x = img if img.dim() == 3 else img[..., None]
    x = x.permute(2, 0, 1)[:, None]  # (c, 1, H, W)
    x = torch.nn.functional.pad(x, (r, r, 0, 0), mode="reflect")
    x = torch.nn.functional.conv2d(x, k.view(1, 1, 1, -1))
    x = torch.nn.functional.pad(x, (0, 0, r, r), mode="reflect")
    x = torch.nn.functional.conv2d(x, k.view(1, 1, -1, 1))
    x = x[:, 0].permute(1, 2, 0)
    return x if img.dim() == 3 else x[..., 0]


def render(K: np.ndarray, C: np.ndarray, W: int, H: int, phase, device):
    """(depth, gray, rgb) of one view at W x H: the true depth (float64),
    the gray image (``texture`` at the surface point, 0 where the ray
    misses, smoothed) and the RGB albedo (smoothed), both float32 in
    [0, 1]. ``phase`` (px, py) shifts the texture over the surface."""
    depth, x, y = ray_march(K, C, W, H, device)
    hit = depth > 0
    tx, ty = x + phase[0], y + phase[1]
    gray = torch.where(hit, texture(tx, ty), 0.0).to(torch.float32)
    rgb = torch.where(hit[..., None], albedo(tx, ty), 0.0).to(torch.float32)
    return depth, _gaussian_05(gray), _gaussian_05(rgb)


def _area_half(img: torch.Tensor, level: int) -> torch.Tensor:
    """The image halved ``level`` times by 2x2 means (INTER_AREA at
    exact halvings)."""
    for _ in range(level):
        x = img if img.dim() == 3 else img[..., None]
        x = 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])
        img = x if img.dim() == 3 else x[..., 0]
    return img


@dataclass
class Scene:
    """What the benchmark hands the program: per view the gray (H, W)
    float32 and RGB (H, W, 3) uint8 images at the maps' resolution, their
    intrinsics ``K`` (identity rotations), centres ``Cs``, and the sparse
    cloud (``points`` (n, 3) float32, ``point_views`` the views that see
    each)."""

    grays: list
    colors: list
    K: np.ndarray
    Cs: list
    points: np.ndarray
    point_views: list

    @property
    def n_views(self) -> int:
        return len(self.grays)


def make_scene(cfg: dict, seed: int, device) -> Scene:
    """The scene of configuration ``cfg`` drawn from ``seed`` on ``device``:
    each view rendered at the source's image size, halved
    ``resolution_level`` times; ``sparse_points`` surface points on a
    lattice, each listed with the views whose image it projects into
    unoccluded (its depth within 1% of the view's true depth there), kept
    where two views or more see it."""
    s = cfg["scene"]
    W0, H0, level = s["image_width"], s["image_height"], s["resolution_level"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    # a shift of the texture within half a unit each way: a larger one would
    # raise the frequency of its x*y term (23 x y) towards the pixels' Nyquist
    # limit and make some seeds' scenes harder to match than others
    phase = (torch.rand(2, generator=gen, device=device, dtype=torch.float64)
             - 0.5).tolist()
    K0 = intrinsics(W0, H0)
    K = scale_intrinsics(K0, 0.5 ** level)
    Cs = grid_centers(s["grid"], s["spacing"])
    grays, colors, depths = [], [], []
    for C in Cs:
        depth, gray, rgb = render(K0, C, W0, H0, phase, device)
        grays.append(_area_half(gray, level))
        colors.append((_area_half(rgb, level) * 255).round().clamp(0, 255).to(torch.uint8))
        depths.append(depth)
    # the sparse cloud: lattice vertices of the surface drawn from the seed
    n_lat = s["sparse_lattice"]
    g = torch.linspace(-EXTENT, EXTENT, n_lat, device=device, dtype=torch.float64)
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    verts = torch.stack([xx, yy, height(xx, yy)], -1).reshape(-1, 3)
    pick = torch.randperm(len(verts), generator=gen, device=device)[:s["sparse_points"]]
    X = verts[pick]
    seen = []
    for C, depth in zip(Cs, depths):
        p = (X - torch.as_tensor(C, device=device)) @ torch.as_tensor(K0.T, device=device)
        u, v = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
        ui = u.round().long().clamp(0, W0 - 1)
        vi = v.round().long().clamp(0, H0 - 1)
        d = depth[vi, ui]
        seen.append((u >= 0) & (u <= W0 - 1) & (v >= 0) & (v <= H0 - 1)
                    & ((p[:, 2] - d).abs() <= 0.01 * d))
    seen = torch.stack(seen, 1).cpu().numpy()
    keep = seen.sum(1) >= 2
    return Scene(
        grays=[t.cpu().numpy() for t in grays],
        colors=[t.cpu().numpy() for t in colors],
        K=K, Cs=Cs,
        points=X[torch.as_tensor(keep, device=device)].to(torch.float32).cpu().numpy(),
        point_views=[np.nonzero(r)[0].astype(np.uint32) for r in seen[keep]])
