"""NaN and numeric-fault safety hooks (a port of
``openmvs_tpu/utils/safety.py``; SURVEY §5.2).

The reference's safety net is ASSERT and Breakpad crash minidumps
(libs/MVS/Common.cpp:49-52). These env-gated hooks, read at import, cover
numeric faults:

* ``OMVS_DEBUG_NANS=1``: ``install`` turns on autograd's anomaly detection
  (a backward op that produces NaN raises at that op; the JAX package sets
  ``jax_debug_nans``), and ``check_finite`` guards the host arrays at stage
  boundaries.
* ``OMVS_CHECKIFY=1``: ``checked(fn)`` returns ``fn`` wrapped so that a
  non-finite value in any tensor it returns raises, naming ``fn`` (the JAX
  package's ``checked_jit`` threads ``checkify`` float checks through a
  jitted function). ``patchmatch.finalize``, the last device step of each
  depth map before densify downloads it, is wrapped.

Both default off: they add synchronisations and exist for debugging, as
the reference's debug ASSERT builds do.
"""

from __future__ import annotations

import functools
import os

import numpy as np

DEBUG_NANS = os.environ.get("OMVS_DEBUG_NANS", "") == "1"
CHECKIFY = os.environ.get("OMVS_CHECKIFY", "") == "1"

_installed = False


def install():
    """Apply the process-wide debug configuration (called at package
    import)."""
    global _installed
    if _installed:
        return
    _installed = True
    if DEBUG_NANS:
        import torch

        torch.autograd.set_detect_anomaly(True)


def check_finite(name: str, *arrays) -> None:
    """Host-side stage-boundary guard: raises FloatingPointError naming the
    stage if any array (numpy or tensor) holds NaN or Inf. A no-op unless
    OMVS_DEBUG_NANS=1."""
    if not DEBUG_NANS:
        return
    for i, a in enumerate(arrays):
        if a is None:
            continue
        arr = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
        if arr.dtype.kind != "f":
            continue
        if not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"non-finite values in '{name}' output #{i}: {n_bad}/{arr.size} "
                f"bad elements, shape {arr.shape} (OMVS_DEBUG_NANS tripped)")


def _tensors(out):
    if isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)
    elif hasattr(out, "is_floating_point"):
        yield out


def checked(fn):
    """``fn``, or under OMVS_CHECKIFY=1 ``fn`` wrapped to check every
    floating tensor it returns (in tuples, lists, named tuples and dicts)
    with ``torch.isfinite``: a NaN or Inf raises FloatingPointError naming
    the function and the output."""
    if not CHECKIFY:
        return fn
    import torch

    name = getattr(fn, "__name__", "checked")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for i, t in enumerate(_tensors(out)):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                n_bad = int((~torch.isfinite(t)).sum())
                raise FloatingPointError(
                    f"non-finite values in '{name}' output #{i}: {n_bad}/{t.numel()} "
                    f"bad elements, shape {tuple(t.shape)} (OMVS_CHECKIFY tripped)")
        return out

    return wrapper
