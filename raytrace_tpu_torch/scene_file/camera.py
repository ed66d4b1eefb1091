"""Camera schema (reference: scene_file/src/camera.rs:5-17).

Only one camera model exists today — a perspective pinhole/thin-lens camera —
but the schema is a tagged union so more can be added.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ._tagged import TaggedUnion

CAMERA_UNION = TaggedUnion("camera")


@CAMERA_UNION.variant("perspective")
@dataclass
class PerspectiveCamera:
    name: str
    eye: List[float]
    look_at: List[float]
    up: List[float]
    fov_y: float  # vertical field of view in DEGREES (converted at compile time)
    z_near: float
    z_far: float
    focal_length: float
    aperture_size: float


def camera_from_json(data) -> PerspectiveCamera:
    return CAMERA_UNION.from_json(data)
