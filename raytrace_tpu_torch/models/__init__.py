"""Geometry and scene compilation: host-side (numpy) code that turns a
SceneFile into the frozen SoA array pytree consumed by the device kernels."""

from .tessellate import (
    Mesh,
    mesh_from_primitive,
    generate_uv_sphere,
    generate_box,
    generate_quad,
    generate_triangle,
)
from .transform import (
    DecomposedTransform,
    decompose_matrix,
    quat_slerp,
    trs_to_matrix,
)
from .alias_table import build_alias_table
from .compile import CompiledScene, RenderConfig, compile_scene

__all__ = [
    "Mesh", "mesh_from_primitive", "generate_uv_sphere", "generate_box",
    "generate_quad", "generate_triangle",
    "DecomposedTransform", "decompose_matrix", "quat_slerp", "trs_to_matrix",
    "build_alias_table",
    "CompiledScene", "RenderConfig", "compile_scene",
]
