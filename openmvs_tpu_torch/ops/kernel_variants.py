"""Inputs for comparing the scorer K1 with its variant K1-v2.

The port's copy of ``make_inputs`` of the JAX package's dev timing script
(``scripts/dev_kernel_variants.py:26``): a random neighbour image seen
through a small rotation and translation, C random fronto-parallel
candidate depths in [3, 3.5], random bilateral weights. The same seed gives
the same numpy arrays as the script. ``chip_smoke.py`` (phase
``variants``) times K1 and K1-v2 on them at C=11, 480x640, T=25.
"""

from __future__ import annotations

import numpy as np
import torch

# K1's argument order (pm_kernel.score_view)
ARG_ORDER = ("img", "size", "Hl", "Hm", "depth", "normal", "inv_nd", "X0",
             "goff", "w", "wtm", "sum_w", "norm_sq0")


def make_inputs(C=11, H=480, W=640, T=25, seed=0) -> dict:
    """The script's operands as float32 numpy arrays. As in the script, the
    texel grid is always the 5x5 one (T=25)."""
    rng = np.random.default_rng(seed)
    img = rng.random((H, W), np.float32)
    size = np.array([H, W], np.float32)
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
    a = 0.03
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                 np.float32)
    Hl = (K @ R).astype(np.float32)
    Hm = (K @ np.array([0.25, 0.03, 0.01], np.float32)).astype(np.float32)
    depth = (rng.random((C, H, W), np.float32) * 0.5 + 3.0)
    normal = np.zeros((C, H, W, 3), np.float32)
    normal[..., 2] = -1.0
    X0 = np.zeros((H, W, 3), np.float32)
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    X0[..., 0] = (uu - W / 2) / (0.8 * W)
    X0[..., 1] = (vv - H / 2) / (0.8 * W)
    X0[..., 2] = 1.0
    den = np.einsum("chwk,hwk->chw", normal, X0) * depth
    inv_nd = np.where(np.abs(den) > 1e-12, 1.0 / den, 0.0).astype(np.float32)
    offs = np.stack(np.meshgrid(np.arange(-4, 5, 2), np.arange(-4, 5, 2)), -1).reshape(-1, 2)
    goff = np.concatenate([offs, np.zeros((T, 1))], -1).astype(np.float32) / (0.8 * W)
    w = rng.random((T, H, W), np.float32) * 0.5 + 0.5
    wtm = rng.normal(0, 0.2, (T, H, W)).astype(np.float32)
    sum_w = w.sum(0)
    norm_sq0 = (wtm * rng.normal(0, 0.2, (T, H, W))).sum(0).astype(np.float32) ** 2 + 0.01
    return dict(img=img, size=size, Hl=Hl, Hm=Hm, depth=depth, normal=normal,
                inv_nd=inv_nd, X0=X0, goff=goff, w=w, wtm=wtm, sum_w=sum_w,
                norm_sq0=norm_sq0)


def as_args(ins: dict, device) -> tuple:
    """The inputs as contiguous float32 tensors on ``device``, in K1's
    argument order."""
    return tuple(torch.as_tensor(np.ascontiguousarray(ins[k]), dtype=torch.float32,
                                 device=device) for k in ARG_ORDER)
