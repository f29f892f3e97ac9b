"""Per-image records of the ``.mvs`` interchange format that the in-memory
scene carries (``ImageMeta``, ``ViewScore``; Interface.h:527-544).

Loading and saving ``.mvs`` streams is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class ViewScore:
    """Scored neighbor view (Interface.h:527-544)."""

    id: int = 0
    points: int = 0
    scale: float = 0.0
    angle: float = 0.0
    area: float = 0.0
    score: float = 0.0


@dataclass
class ImageMeta:
    name: str = ""
    mask_name: str = ""
    platform_id: int = 0
    camera_id: int = 0
    pose_id: int = 0
    id: int = 0xFFFFFFFF
    min_depth: float = 0.0
    avg_depth: float = 0.0
    max_depth: float = 0.0
    view_scores: List[ViewScore] = field(default_factory=list)
