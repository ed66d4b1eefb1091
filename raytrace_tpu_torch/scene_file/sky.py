"""Sky schema (reference: scene_file/src/sky.rs).

Two sky models: a solid colour and a "vertical gradient".  NOTE the reference
shader evaluates the gradient as ``mix(top, bottom, factor)`` with a constant
factor — the ray direction is ignored (ray_gen.glsl:443-455), so a gradient
sky is effectively a solid colour.  We replicate that behaviour for pixel
parity (see engine/wavefront._background).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Union

from ._tagged import TaggedUnion

SKY_UNION = TaggedUnion("sky")

SKY_TYPE_NONE = 0
SKY_TYPE_SOLID = 1
SKY_TYPE_VERTICAL_GRADIENT = 2


@SKY_UNION.variant("solid")
@dataclass
class SolidSky:
    rgb: List[float]


@SKY_UNION.variant("vertical_gradient")
@dataclass
class VerticalGradientSky:
    factor: float
    top: List[float]
    bottom: List[float]


Sky = Union[SolidSky, VerticalGradientSky]


def sky_from_json(data) -> Sky:
    return SKY_UNION.from_json(data)
