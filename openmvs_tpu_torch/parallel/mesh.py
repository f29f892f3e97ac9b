"""A grid of shards held by one process, and the collectives between them.

The JAX package lays its multi-device work out on a ``jax.sharding.Mesh``
and runs one traced body on every device under ``shard_map``, with
``ppermute``, ``psum``, ``pmin``, ``pmax`` and ``all_gather`` between the
devices. The port keeps the single controller: one process holds a list
of shards, each a set of tensors on its own ``torch.device``, runs the
body once per shard, and does each collective as an explicit tensor
operation between the shards:

- ``ppermute``: each source tensor copied to its destination's device
  (zeros where no source sends, as in JAX);
- ``psum``: a sum in mesh order on one device;
- ``pmin``/``pmax``: ``torch.minimum``/``torch.maximum`` folds;
- ``all_gather``: a cat.

Shards may share a device: a (2, 2) mesh on one card puts four shards on
``cuda:0``, which run in turn; on several cards each card's launches are
asynchronous, so the shards overlap. No ``torch.distributed`` process
group is used: NCCL refuses two ranks on one GPU, and the JAX package's
``parallel/`` is single-process too.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from openmvs_tpu_torch.utils import device as devmod


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device with an index for a card; raises for a
    card that is absent."""
    dev = devmod.resolve(device)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev}: only {torch.cuda.device_count()} "
                               "card(s) present")
        dev = torch.device("cuda", index)
    return dev


class ShardMesh:
    """A (n_views_axis, n_tile) grid of devices with axes ("views", "tile"),
    the port's ``jax.sharding.Mesh``. ``devices[a][t]`` holds shard (a, t);
    a device may hold several shards."""

    def __init__(self, devices: Sequence[Sequence]):
        rows = [[resolve_device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices: List[List[torch.device]] = rows

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def flat(self) -> List[torch.device]:
        """The devices in mesh order (row-major)."""
        return [d for row in self.devices for d in row]

    def __repr__(self) -> str:
        return f"ShardMesh(shape={self.shape}, devices={self.flat()})"


def to(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``: the tensor itself where it already lies there,
    an asynchronous copy between cards, a synchronous one to or from the
    host (an asynchronous download could be read before it lands)."""
    device = torch.device(device)
    return x.to(device, non_blocking=x.device.type == device.type == "cuda")


def ppermute(xs: Sequence[torch.Tensor], perm) -> List[torch.Tensor]:
    """``jax.lax.ppermute`` over shards: out[dst] = xs[src] on dst's device
    for each (src, dst) of ``perm``, zeros like xs[dst] where none sends."""
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = to(xs[src], xs[dst].device)
    return [o if o is not None else torch.zeros_like(x) for o, x in zip(out, xs)]


def _fold(xs: Sequence[torch.Tensor], op, device) -> torch.Tensor:
    dev = xs[0].device if device is None else device
    acc = to(xs[0], dev)
    for x in xs[1:]:
        acc = op(acc, to(x, dev))
    return acc


def psum(xs: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The sum of the shards' tensors in mesh order, on ``device`` (the
    first shard's by default)."""
    return _fold(xs, torch.add, device)


def pmin(xs: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    return _fold(xs, torch.minimum, device)


def pmax(xs: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    return _fold(xs, torch.maximum, device)


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0, device=None) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` in mesh order."""
    dev = xs[0].device if device is None else device
    return torch.cat([to(x, dev) for x in xs], dim=dim)


def chunks(n: int, n_shards: int) -> List[range]:
    """The contiguous index ranges of ``n`` items over ``n_shards`` shards
    of ceil(n / n_shards) items each (``PartitionSpec`` over a padded axis;
    the last shards may be short or empty)."""
    size = -(-n // n_shards)
    return [range(min(s * size, n), min((s + 1) * size, n)) for s in range(n_shards)]
