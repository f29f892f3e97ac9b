"""Ordered segment sums: the scatter-adds of refinement's iteration.

The JAX package's jitted iteration (``_device_iter``,
``openmvs_tpu/refine.py:531``) accumulates pixels into faces and faces
into vertices with ``.at[].add`` (:510, :516, :523, :621), which XLA's CPU
backend adds row by row in the order of the rows. The port keeps that
order on every device: the rows are sorted stably by their segment, and
each segment is summed from 0.0 in that order (``refine._segment_sum``).

``segments`` builds the order and the offsets with a stable sort and
``searchsorted``, which read nothing back to the host, so a CUDA graph can
hold them. ``segment_sum`` is the wrapper of the hand-written kernel
``csrc/segment_sum.cu``: on CUDA tensors it launches it (or raises), on CPU
tensors it runs the plain version, ``segment_sum_plain``: the rows
gathered in order and ``torch.segment_reduce`` over the offsets, which on
the CPU folds each segment from 0 in order. Each launch adds one to
``pm_kernel.LAUNCHES["segment_sum"]`` (at each replay of a graph that holds it).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from openmvs_tpu_torch.ops import _build
from openmvs_tpu_torch.ops.pm_kernel import count_launch


def segments(index: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order (R,), offsets (n + 1,)), int64, of the 1-D segment ids
    ``index`` (values in [0, n)): the rows in a stable sort by segment, and
    where each segment starts in it."""
    ids, order = torch.sort(index, stable=True)
    bounds = torch.arange(n + 1, dtype=ids.dtype, device=ids.device)
    return order, torch.searchsorted(ids, bounds)


def _check(order, offsets, src) -> None:
    for name, t, dtype in (("order", order, torch.int64), ("offsets", offsets, torch.int64),
                           ("src", src, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
        if t.device != src.device:
            raise ValueError(f"{name}: on {t.device}, expected {src.device}")
    if order.dim() != 1 or offsets.dim() != 1 or offsets.numel() < 1:
        raise ValueError("order and offsets: expected (R,) and (n + 1,)")
    if src.dim() < 1 or src.shape[0] != order.shape[0]:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected ({order.shape[0]}, ...)")


def segment_sum(order: torch.Tensor, offsets: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """(n, ...) sums of the rows of ``src`` (R, ...): segment s sums rows
    ``order[offsets[s]:offsets[s + 1]]`` from 0.0 in that order. Contiguous
    int64 order and offsets, float32 src, on one device."""
    _check(order, offsets, src)
    if src.device.type == "cpu":
        return segment_sum_plain(order, offsets, src)
    return _launch(order, offsets, src)


def segment_sum_plain(order: torch.Tensor, offsets: torch.Tensor,
                      src: torch.Tensor) -> torch.Tensor:
    """``segment_sum`` in plain PyTorch: the rows gathered in order, then
    ``torch.segment_reduce`` over the offsets (on the CPU a fold of each
    segment from 0 in order)."""
    return torch.segment_reduce(src.index_select(0, order), "sum", offsets=offsets,
                                axis=0, unsafe=True)


def _launch(order, offsets, src) -> torch.Tensor:
    if src.device.type != "cuda":
        raise ValueError(f"segment_sum kernel: tensors on {src.device}, expected cuda")
    n = offsets.shape[0] - 1
    out = torch.empty((n,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    K = 1
    for k in src.shape[1:]:
        K *= k
    if K == 0:
        return out
    lib = _build.library("segment_sum")
    with torch.cuda.device(src.device):
        rc = lib.segment_sum_launch(
            ctypes.c_void_p(order.data_ptr()), ctypes.c_void_p(offsets.data_ptr()),
            ctypes.c_void_p(src.data_ptr()), ctypes.c_void_p(out.data_ptr()), n, K,
            ctypes.c_void_p(torch.cuda.current_stream(src.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"segment_sum_launch failed: {_build.error_string(rc)}")
    count_launch("segment_sum")
    return out
