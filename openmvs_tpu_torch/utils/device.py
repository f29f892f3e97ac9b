"""Device policy of the port's entry points.

Entry points take ``device="cuda"`` by default and never fall back to the
CPU on their own: without a card they raise. Tests and reference runs pass
``device="cpu"``, which runs every kernel's plain version.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """The torch.device for ``device``; raises if it names CUDA and no card
    is available. Keeps float32 products in full float32 (no TF32)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
