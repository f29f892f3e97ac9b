"""PyTorch port of ``openmvs_tpu`` for NVIDIA Hopper GPUs.

The JAX package is the reference; this package mirrors its module names.
It imports torch, numpy and scipy, and never jax, OpenCV or any part of
``openmvs_tpu`` (importing that package imports jax): the host modules it
needs are kept here as copies.

Entry points take ``device="cuda"`` by default and raise without a card;
``device="cpu"`` runs every kernel's plain version.
"""


def _install_safety_hooks() -> None:
    """Env-gated NaN debug hooks (``utils/safety.py``)."""
    from openmvs_tpu_torch.utils import safety

    safety.install()


_install_safety_hooks()
