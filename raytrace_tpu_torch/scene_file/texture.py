"""Texture schema (reference: scene_file/src/texture.rs:9-28).

Four texture kinds:

- ``constant``: a flat RGB colour.
- ``image``: an image file sampled by the hit point's UV coordinates.
- ``checker``: a 3D checker of two *basic* textures (constant/image/noise);
  checker-of-checker is rejected (texture.rs:51-75).
- ``noise``: Perlin-turbulence marble, evaluated on device.

Relative image paths are resolved against the scene file's directory at load
time (texture.rs:40-49).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Union

from ._tagged import SceneError, TaggedUnion

TEXTURE_UNION = TaggedUnion("texture")


@TEXTURE_UNION.variant("constant")
@dataclass
class ConstantTexture:
    name: str
    rgb: List[float]


@TEXTURE_UNION.variant("image")
@dataclass
class ImageTexture:
    name: str
    path: str


@TEXTURE_UNION.variant("checker")
@dataclass
class CheckerTexture:
    name: str
    scale: float
    even: str  # referenced texture names
    odd: str


@TEXTURE_UNION.variant("noise")
@dataclass
class NoiseTexture:
    name: str
    scale: float


Texture = Union[ConstantTexture, ImageTexture, CheckerTexture, NoiseTexture]

_BASIC = (ConstantTexture, ImageTexture, NoiseTexture)


def texture_from_json(data) -> Texture:
    return TEXTURE_UNION.from_json(data)


def adjust_relative_path(tex: Texture, relative_to: str) -> None:
    """Resolve an image texture's relative path against the scene directory."""
    if isinstance(tex, ImageTexture) and not os.path.isabs(tex.path):
        tex.path = os.path.join(relative_to, tex.path)


def validate_texture(tex: Texture, all_textures: Dict[str, Texture]) -> None:
    """Checker textures may only reference basic textures, never other checkers
    (texture.rs:51-75)."""
    if not isinstance(tex, CheckerTexture):
        return
    for side in ("odd", "even"):
        ref_name = getattr(tex, side)
        ref = all_textures.get(ref_name)
        if ref is None:
            raise SceneError(
                f"Checker texture {tex.name} references unknown texture {side}={ref_name}"
            )
        if isinstance(ref, CheckerTexture):
            raise SceneError("Checker texture cannot be recursive.")
        if not isinstance(ref, _BASIC):
            raise SceneError(
                f"Checker texture {tex.name} references unsupported texture {side}={ref_name}"
            )
