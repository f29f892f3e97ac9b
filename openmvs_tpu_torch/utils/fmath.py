"""Float32 arithmetic that rounds the same on the CPU and on the card.

PatchMatch is chaotic: a last-ulp difference in one score can flip which
candidate wins a pixel, and the flip spreads through propagation. Two
things keep the port's results close to the JAX package's and equal
between devices:

* ``fma(a, b, c)`` is ``a * b + c`` rounded once. XLA's CPU backend
  contracts multiply-adds inside a fusion into fused multiply-adds, so the
  port writes each such site explicitly (the CUDA kernels use ``fmaf`` at
  the same sites and are built with ``-fmad=false`` so no other site
  contracts). Here it is computed in float64 and rounded to float32: the
  product of two float32 numbers is exact in float64, so this equals the
  hardware fma except in the rare double-rounding case.
* Transcendentals and ``rsqrt`` are evaluated in float64 and rounded to
  float32. That is the correctly rounded result in all but a vanishing
  share of inputs, on any device, where each device's float32 library
  differs from the other's in the last ulp on a few percent of inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def _d(x):
    # a Python number enters as the float32 constant it is in float32 code
    return x.double() if torch.is_tensor(x) else float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """a * b + c with a single rounding to float32."""
    a, b, c = _d(a), _d(b), _d(c)
    if torch.is_tensor(c) and torch.is_tensor(a) and torch.is_tensor(b):
        return torch.addcmul(c, a, b).float()
    return (a * b + c).float()


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    return (1.0 / torch.sqrt(x.double())).float()


def exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).float()


def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).float()


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).float()


def arccos(x: torch.Tensor) -> torch.Tensor:
    return torch.arccos(x.double()).float()


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(y.double(), x.double()).float()


def exp_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as XLA's CPU backend evaluates it, op for op: the
    Cephes range reduction and polynomial it emits, with its fused
    multiply-adds. It equals the JAX package's jitted ``jnp.exp`` to the
    bit, where the correctly rounded exp differs in the last ulp on about
    9% of inputs; SGM's 8-bit costs round through it. Results below the
    smallest normal float32 flush to 0, as XLA's CPU code does."""
    x = torch.clamp(x, -87.8, 88.8)
    n = torch.clamp(torch.floor(fma(x, 1.44269504088896341, 0.5)), -127.0, 127.0)
    r = fma(-0.693359375, n, x)
    r = fma(2.12194440e-4, n, r)
    y = fma(r, 1.9875691500e-4, 1.3981999507e-3)
    for c in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1):
        y = fma(y, r, c)
    y = fma(y, r * r, r) + 1.0
    scale = torch.bitwise_left_shift(n.to(torch.int32) + 127, 23).view(torch.float32)
    out = y * scale
    return torch.where(out < 1.1754943508222875e-38, 0.0, out)
