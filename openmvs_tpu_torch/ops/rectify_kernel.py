"""SGM's pair rectification on the card: the wrapper of the hand-written
kernel of ``csrc/rectify_warp.cu``.

``sgm.rectify_pair`` on a CUDA device warps both images of a pair with one
``rectify_warp`` launch (each adds one to ``LAUNCHES``). The kernel repeats
``io/images.warp_perspective`` (OpenCV 5's bilinear ``warpPerspective``,
rebuilt in NumPy) step for step, so the rectified images equal the host's
bit for bit. That host function is the plain version: ``warp_pair`` runs it
on CPU tensors, and the tests hold the kernel to it on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from openmvs_tpu_torch.io import images as imio
from openmvs_tpu_torch.ops import _build

LAUNCHES = {"rectify_warp": 0}


def _need(t: torch.Tensor, name: str, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 2-D tensor, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def warp_pair(srcA: torch.Tensor, srcB: torch.Tensor, TA: np.ndarray, TB: np.ndarray,
              W: int, H: int) -> torch.Tensor:
    """(2, H, W) float32 on the sources' device: ``srcA`` warped by the
    homography ``TA`` (source to destination) and ``srcB`` by ``TB``, as
    ``warp_perspective(src, T, W, H)`` warps each. On CUDA tensors one
    kernel launch on the current stream; on CPU tensors the host function."""
    dev = srcA.device
    _need(srcA, "srcA", dev)
    _need(srcB, "srcB", dev)
    if dev.type == "cpu":
        return torch.from_numpy(np.stack([imio.warp_perspective(s.numpy(), T, W, H)
                                          for s, T in ((srcA, TA), (srcB, TB))]))
    out = torch.empty((2, H, W), dtype=torch.float32, device=dev)
    inverses = np.concatenate([imio.warp_inverse(TA), imio.warp_inverse(TB)])
    with torch.cuda.device(dev):
        rc = _build.library("rectify_warp").rectify_warp_launch(
            ctypes.c_void_p(srcA.data_ptr()), srcA.shape[0], srcA.shape[1],
            ctypes.c_void_p(srcB.data_ptr()), srcB.shape[0], srcB.shape[1],
            inverses.ctypes.data_as(ctypes.c_void_p), ctypes.c_void_p(out.data_ptr()),
            H, W, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"rectify_warp_launch failed: {_build.error_string(rc)}")
    LAUNCHES["rectify_warp"] += 1
    return out
