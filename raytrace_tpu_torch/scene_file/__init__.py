"""Scene-file schema: JSON (de)serialization bit-compatible with the reference.

This is the L6 "config" layer of the framework: plain dataclasses describing
cameras, textures, materials, primitives, instances, sky and render settings.
The on-disk format is the externally-tagged snake_case JSON produced by the
reference implementation's serde derive (reference: scene_file/src/*.rs), so
scene files written for the reference load unchanged here and vice versa.

Nothing in this package touches JAX; it is pure-Python data.
"""

from .camera import PerspectiveCamera
from .texture import ConstantTexture, ImageTexture, CheckerTexture, NoiseTexture, Texture
from .material import Lambertian, Metal, Dielectric, DiffuseLight, Material
from .primitive import UvSphere, Triangle, Quad, Box, ObjMesh, Primitive
from .instance import Instance, Transform, TransformType, Rotate
from .sky import SolidSky, VerticalGradientSky, Sky
from .render import Render
from .scene import SceneFile, SceneError

__all__ = [
    "PerspectiveCamera",
    "ConstantTexture", "ImageTexture", "CheckerTexture", "NoiseTexture", "Texture",
    "Lambertian", "Metal", "Dielectric", "DiffuseLight", "Material",
    "UvSphere", "Triangle", "Quad", "Box", "ObjMesh", "Primitive",
    "Instance", "Transform", "TransformType", "Rotate",
    "SolidSky", "VerticalGradientSky", "Sky",
    "Render", "SceneFile", "SceneError",
]
