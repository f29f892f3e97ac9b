"""Logging and scoped wall-clock timing (the reference's Log singleton and
TD_TIMER scopes, libs/Common/Log.h:41, Common.h:45-71)."""

from __future__ import annotations

import contextlib
import logging
import os
import time

_FORMAT = "%(asctime)s %(name)s: %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = (logging.DEBUG
                 if (os.environ.get("OPENMVS_TPU_VERBOSE")
                     or os.environ.get("OMVS_VERBOSE", "2") not in ("", "0", "1", "2"))
                 else logging.INFO)
        logging.basicConfig(level=level, format=_FORMAT, datefmt="%H:%M:%S")
        _configured = True
    return logging.getLogger(f"omvs_torch.{name}")


@contextlib.contextmanager
def timed(log: logging.Logger, label: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log.info("%s (%.2fs)", label, time.perf_counter() - t0)
