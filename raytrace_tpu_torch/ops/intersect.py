"""Ray parameter bounds shared by every closest-hit routine
(raytrace_tpu/ops/intersect.py:19-20)."""

T_MIN = 0.001    # ray_gen.glsl:579
T_MAX = 10000.0  # ray_gen.glsl:580
