"""Material schema (reference: scene_file/src/material.rs:5-23).

Four material kinds mirroring the "Ray Tracing in One Weekend" set; texture
properties are referenced by texture *name* and resolved at scene-compile
time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

from ._tagged import TaggedUnion

MATERIAL_UNION = TaggedUnion("material")


@MATERIAL_UNION.variant("lambertian")
@dataclass
class Lambertian:
    name: str
    albedo: str  # texture name


@MATERIAL_UNION.variant("metal")
@dataclass
class Metal:
    name: str
    albedo: str  # texture name
    fuzz: str    # texture name (scalar fuzz encoded as constant rgb)


@MATERIAL_UNION.variant("dielectric")
@dataclass
class Dielectric:
    name: str
    refraction_index: float


@MATERIAL_UNION.variant("diffuse_light")
@dataclass
class DiffuseLight:
    name: str
    emit: str  # texture name


Material = Union[Lambertian, Metal, Dielectric, DiffuseLight]


def material_from_json(data) -> Material:
    return MATERIAL_UNION.from_json(data)
