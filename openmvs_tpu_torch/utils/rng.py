"""Bit-exact host copy of the ``jax.random`` key derivation the PatchMatch
path uses, and the position-anchored block hash built on it.

Keys are ``(k0, k1)`` tuples of Python ints, the two uint32 words of a raw
threefry2x32 key (``jax.random.PRNGKey``/``key_data`` layout). Derivation
runs on the host: the sweep schedule derives a few dozen keys per depth map,
so there is nothing to gain from device code and the values stay exact.

A captured CUDA graph freezes every Python int it was captured with, so a
program replayed with another key reads its keys from a device tensor:
``threefry2x32_t``, ``uniform`` and ``block_uniform`` also take a key that
is a 2-element int64 tensor of the two words. ``KeyTable`` supplies them:
code run under capture derives keys from ``KeyTable.root`` with the same
``fold_in``/``split``, each derived key stands for its path of threefry
counters, and each key a draw reads is a row of the table's device
tensor; before each replay ``KeyTable.fill`` derives every row from that
replay's key on the host and copies the rows in.

``block_uniform`` (counterpart of ``openmvs_tpu/ops/patchmatch.py:687-720``)
runs in torch. torch has no usable uint32 arithmetic, so words are int64
masked to 32 bits, and multiplies by 32-bit constants are split into 16-bit
halves so no product leaves int64. With ``old_rng`` (the sweep's
``Switches.old_rng``) it draws shape-based uniforms instead, one per block
of the array, as ``jax.random.uniform`` does (``uniform``: threefry2x32
over the counters, in torch).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch

from openmvs_tpu_torch.utils.fmath import fma

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """One threefry2x32 block (20 rounds), as jax's ``threefry2x32_p``; of a
    ``TableKey``, the table's key one block further down its path."""
    if isinstance(key, TableKey):
        return TableKey(key.table, key.path + ((x0 & _M32, x1 & _M32),))
    k0, k1 = key[0] & _M32, key[1] & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit integer seed."""
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError("seed must fit in 32 bits")
    return 0, seed & _M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, data & _M32)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)`` under partitionable threefry (the
    default of jax 0.9): key i is the block of counter (0, i)."""
    return tuple(threefry2x32(key, 0, i) for i in range(num))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h in [0, 2**32) and a 32-bit constant."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32_t(key, x0: torch.Tensor, x1: torch.Tensor):
    """``threefry2x32`` over int64 tensors of 32-bit counters; the key is a
    host key, a 2-element int64 tensor on the counters' device, or a
    ``TableKey``. The additions run in the same order for each."""
    key = words(key)
    k0, k1 = key[0] & _M32, key[1] & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` under
    partitionable threefry: element i's bits are the xor of the block of
    counter (0, i), their 23 high bits the mantissa of a float in [1, 2),
    then (f - 1) (maxval - minval) + minval with the fused multiply-add of
    XLA's CPU code, at least minval."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32_t(key, torch.zeros_like(idx), idx)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    return torch.clamp(fma(f, float(span), float(lo)), min=float(lo)).reshape(shape)


BLOCK = 8


def block_uniform(key, uv: torch.Tensor, minval: float = 0.0,
                  maxval: float = 1.0, old_rng: bool = False) -> torch.Tensor:
    """Per-BLOCKxBLOCK-tile uniforms hashed from (key, global block coords).

    uv: (H, W, 2) float pixel coordinates; the key as ``threefry2x32_t``
    takes it. Bit-identical to the JAX package's ``_block_uniform``. With
    ``old_rng`` the uniforms are instead one ``uniform`` draw of shape
    (ceil(H / 8), ceil(W / 8)), each repeated over its block (the JAX
    package's diagnostic)."""
    if old_rng:
        H, W = uv.shape[:2]
        u = uniform(key, (-(-H // BLOCK), -(-W // BLOCK)), minval, maxval, uv.device)
        u = torch.repeat_interleave(torch.repeat_interleave(u, BLOCK, 0), BLOCK, 1)
        return u[:H, :W]
    key = words(key)
    bx = torch.div(uv[..., 0].to(torch.int64), BLOCK, rounding_mode="floor")
    by = torch.div(uv[..., 1].to(torch.int64), BLOCK, rounding_mode="floor")
    h = (key[0] ^ _mul32(bx & _M32, 0x85EBCA6B)
         ^ _mul32(by & _M32, 0x9E3779B9) ^ key[1])
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    u = h.to(torch.float32) * (1.0 / 4294967296.0)
    return minval + u * (maxval - minval)


class TableKey(NamedTuple):
    """A key of a ``KeyTable``: its root followed by ``path``, the
    (x0, x1) counters of the threefry blocks that derived it."""

    table: "KeyTable"
    path: Tuple[Tuple[int, int], ...]


def words(key) -> Union[Key, torch.Tensor]:
    """The two words of a key: a host key or a tensor as it is, a
    ``TableKey`` as its row of the table."""
    return key.table.row(key.path) if isinstance(key, TableKey) else key


class KeyTable:
    """The keys a captured program reads, as rows of a (capacity, 2) int64
    tensor on ``device``. ``root`` stands for the key of a replay; the rows
    are the keys derived from it that a draw read while the program was
    captured. ``fill(key)`` derives every row from a host key, each path
    prefix once, and copies them in one transfer (from pinned memory on a
    card, so the host does not wait for the device). A program run directly
    (on the CPU) registers its keys as it reads them, after the fill: each
    such row is derived and written when it is first read."""

    def __init__(self, device, capacity: int = 1024):
        self.buf = torch.zeros((capacity, 2), dtype=torch.int64, device=device)
        self.paths: Dict[Tuple, int] = {}
        self._derived = None

    @property
    def root(self) -> TableKey:
        return TableKey(self, ())

    def _value(self, path) -> Key:
        if path not in self._derived:
            self._derived[path] = threefry2x32(self._value(path[:-1]), *path[-1])
        return self._derived[path]

    def row(self, path) -> torch.Tensor:
        i = self.paths.get(path)
        if i is None:
            i = len(self.paths)
            if i == self.buf.shape[0]:
                raise RuntimeError(f"KeyTable: more than {i} keys")
            self.paths[path] = i
            if self._derived is not None:
                self.buf[i] = torch.tensor(self._value(path), dtype=torch.int64)
        return self.buf[i]

    def fill(self, key: Key) -> None:
        self._derived = {(): (key[0] & _M32, key[1] & _M32)}
        rows = torch.tensor([self._value(p) for p in self.paths] or [(0, 0)],
                            dtype=torch.int64)
        if self.buf.is_cuda:
            rows = rows.pin_memory()
        self.buf[:len(rows)].copy_(rows, non_blocking=self.buf.is_cuda)
