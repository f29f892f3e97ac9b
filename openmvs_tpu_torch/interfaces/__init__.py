"""SfM front-end importers and exporters (apps/Interface* equivalents):
copies of ``openmvs_tpu/interfaces/colmap.py`` and ``openmvg.py``.

The JAX package undistorts the images of a distorted camera on import
(``openmvs_tpu/interfaces/undistort.py``: ``cv2.undistort`` between
``cv2.imread`` and ``cv2.imwrite``); the port has no such step yet, so an
import that would undistort raises instead of importing wrong geometry.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def require_undistorted(dists: Dict[int, np.ndarray], source: str) -> None:
    """Raise where a platform's distortion coefficients (OpenCV order k1,
    k2, p1, p2, k3) are nonzero: the JAX package would undistort its
    images there (undistort_interface_images skips all-zero ones)."""
    bad = sorted(p for p, d in dists.items()
                 if d is not None and np.any(np.abs(d) > 1e-12))
    if bad:
        raise NotImplementedError(
            f"{source}: platforms {bad} have distorted camera models; importing "
            "them needs image undistortion (interfaces/undistort.py: cv2.undistort "
            "and cv2.imread/imwrite), which the port does not have yet (ROADMAP "
            "Queue 1, item 8). Undistort the images first (e.g. colmap "
            "image_undistorter) and import the pinhole model")
