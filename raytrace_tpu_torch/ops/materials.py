"""Material constants and the Schlick approximation
(raytrace_tpu/ops/materials.py:26-57)."""

from __future__ import annotations

# PDF type tags (common.glsl:117-121).
NO_PDF = 0
SPHERE_PDF = 1
COSINE_PDF = 2
LIGHT_PDF = 3


def schlick_reflectance(cosine, refraction_index):
    """ray_gen.glsl:246-250.  ``x ** 5`` is spelled as the squarings JAX's
    integer_pow lowers to, so both packages round the same products."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))
