"""Primitive schema (reference: scene_file/src/primitive.rs:5-33).

Primitives are analytic shapes tessellated into triangle meshes at scene
compile time.  ``obj_mesh`` is a first-class Wavefront-OBJ import primitive —
the reference shipped an OBJ loader (raytracer/src/obj_loader.rs) that was
never reachable from a scene file; here it is a supported primitive kind.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Union

from ._tagged import TaggedUnion

PRIMITIVE_UNION = TaggedUnion("primitive")


@PRIMITIVE_UNION.variant("uv_sphere")
@dataclass
class UvSphere:
    name: str
    center: List[float]
    radius: float
    rings: int
    segments: int
    material: str


@PRIMITIVE_UNION.variant("triangle")
@dataclass
class Triangle:
    name: str
    points: List[List[float]]  # 3 x vec3
    normal: List[float]
    uv: List[List[float]]      # 3 x vec2
    material: str


@PRIMITIVE_UNION.variant("quad")
@dataclass
class Quad:
    name: str
    points: List[List[float]]  # 4 x vec3
    normal: List[float]
    uv: List[List[float]]      # 4 x vec2
    material: str


@PRIMITIVE_UNION.variant("box")
@dataclass
class Box:
    name: str
    corners: List[List[float]]  # 2 x vec3 (any opposite pair)
    material: str


@PRIMITIVE_UNION.variant("obj_mesh")
@dataclass
class ObjMesh:
    name: str
    path: str
    material: str


Primitive = Union[UvSphere, Triangle, Quad, Box, ObjMesh]


def primitive_from_json(data) -> Primitive:
    return PRIMITIVE_UNION.from_json(data)


def adjust_primitive_relative_path(prim: Primitive, relative_to: str) -> None:
    import os

    if isinstance(prim, ObjMesh) and not os.path.isabs(prim.path):
        prim.path = os.path.join(relative_to, prim.path)
