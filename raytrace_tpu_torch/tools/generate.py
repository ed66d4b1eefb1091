"""Deterministic generator for the "Ray Tracing in One Weekend" final scene
(reference: tools/src/main.rs:52-326); the port's copy of
raytrace_tpu/tools/generate.py, on the port's own ``tools/chacha.py`` and
``scene_file/``.

Same construction: a 1000-radius checkered ground sphere (y-down world), a
22x22 grid of small spheres with material chosen by a random draw
(diffuse < 0.8 <= metal < 0.95 <= glass), rejection against the three hero
spheres, every sphere snapped onto the ground sphere with a 0.035 fudge,
motion-blur variant giving diffuse spheres an animated falling translation.

RNG: a bit-compatible ChaCha20 stream (tools/chacha.py) seeded with the
reference's 485674845675491 (tools/src/main.rs:25), with rand 0.9 float
conversions and f32 arithmetic throughout — the generated scenes match the
reference's shipped assets/final-one-weekend*.json sphere-for-sphere
(the JAX package's tests/test_generate.py; the port's output is held to
the JAX generator's, byte for byte, by tests/test_torch_app_cli.py and
tests/test_torch_app_renderer.py).  The copies checked in under this
repository's assets/ predate the ChaCha20 stream and differ from both.
As in the reference, the RNG is seeded ONCE and
the static scene is generated before the motion-blur one, which continues
the same stream (tools/src/main.rs:28-31).
"""

from __future__ import annotations

import numpy as np

from ..scene_file import (
    ConstantTexture,
    CheckerTexture,
    Dielectric,
    Instance,
    Lambertian,
    Metal,
    PerspectiveCamera,
    Render,
    SceneFile,
    Transform,
    TransformType,
    UvSphere,
    VerticalGradientSky,
)
from .chacha import ChaCha20Rng

SEED = 485_674_845_675_491
FUDGE = 0.035

_f32 = np.float32


def _touch_ground(center, radius, g_center, g_radius):
    """make_sphere_touch_ground (tools/src/main.rs:39-50), f32 semantics:
    glam normalize multiplies by the reciprocal length."""
    d = [_f32(center[i]) - _f32(g_center[i]) for i in range(3)]
    inv = _f32(1.0) / np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                              dtype=np.float32)
    s = _f32(g_radius) + _f32(radius) - _f32(FUDGE)
    return [float(d[i] * inv * s + _f32(g_center[i])) for i in range(3)]


def _dist_f32(p, q):
    d = [_f32(p[i]) - _f32(q[i]) for i in range(3)]
    return float(np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                         dtype=np.float32))


def generate_final_one_weekend_scene(do_motion_blur: bool = False,
                                     rng: ChaCha20Rng | None = None,
                                     seed: int = SEED) -> SceneFile:
    if rng is None:
        rng = ChaCha20Rng.seed_from_u64(seed)

    textures = [
        ConstantTexture(name="green", rgb=[0.2, 0.3, 0.1]),
        ConstantTexture(name="pale-white", rgb=[0.9, 0.9, 0.9]),
        CheckerTexture(name="green-and-white-checker", scale=0.32,
                       even="green", odd="pale-white"),
    ]
    materials = [Lambertian(name="ground", albedo="green-and-white-checker")]

    ground_center = [0.0, 1000.0, 0.0]
    ground_radius = 1000.0
    primitives = [UvSphere(name="ground_sphere", center=ground_center,
                           radius=ground_radius, rings=128, segments=256,
                           material="ground")]
    instances = [Instance(name="ground_sphere")]

    c1 = [0.0, -1.0, 0.0]
    c2 = _touch_ground([-4.0, -1.0, 0.0], 1.0, ground_center, ground_radius)
    c3 = _touch_ground([4.0, -1.0, 0.0], 1.0, ground_center, ground_radius)
    hero_r = 1.0

    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rng.f32()
            radius = 0.2
            while True:
                x = _f32(a) + _f32(0.9) * _f32(rng.f32())
                z = _f32(b) + _f32(0.9) * _f32(rng.f32())
                center = _touch_ground([x, -radius, z], radius,
                                       ground_center, ground_radius)
                total = hero_r + radius
                if (_dist_f32(center, c1) > total
                        and _dist_f32(center, c2) > total
                        and _dist_f32(center, c3) > total):
                    break

            transform = None
            if choose_mat < 0.8:
                name = f"diffuse_{a}_{b}"
                v1, v2 = rng.vec3(), rng.vec3()
                albedo = [float(_f32(v1[i]) * _f32(v2[i])) for i in range(3)]
                textures.append(
                    ConstantTexture(name=f"tex_albedo_{name}", rgb=albedo))
                mat = Lambertian(name=f"mat_{name}",
                                 albedo=f"tex_albedo_{name}")
                if do_motion_blur:
                    transform = TransformType(
                        start=Transform(
                            translate=[0.0, rng.f32_range(-0.5, 0.0), 0.0]),
                        end=Transform(translate=[0.0, 0.0, 0.0]),
                    )
            elif choose_mat < 0.95:
                name = f"metal_{a}_{b}"
                albedo = rng.vec3_in_range(0.5, 1.0)
                fuzz = rng.vec3_in_range(0.0, 0.5)
                textures.append(
                    ConstantTexture(name=f"tex_albedo_{name}", rgb=albedo))
                textures.append(
                    ConstantTexture(name=f"tex_fuzz_{name}", rgb=fuzz))
                mat = Metal(name=f"mat_metal_{a}_{b}",
                            albedo=f"tex_albedo_{name}",
                            fuzz=f"tex_fuzz_{name}")
            else:
                mat = Dielectric(name=f"mat_dielectric_{a}_{b}",
                                 refraction_index=1.5)

            materials.append(mat)
            sphere_name = f"sphere_{a}_{b}"
            primitives.append(UvSphere(
                name=sphere_name, center=center, radius=radius,
                rings=32, segments=64, material=mat.name,
            ))
            instances.append(Instance(name=sphere_name, transform=transform))

    # Hero spheres.
    materials.append(Dielectric(name="material1", refraction_index=1.5))
    primitives.append(UvSphere(name="sphere1", center=c1, radius=hero_r,
                               rings=64, segments=128, material="material1"))
    instances.append(Instance(name="sphere1"))

    textures.append(ConstantTexture(name="texture2", rgb=[0.4, 0.2, 0.1]))
    materials.append(Lambertian(name="material2", albedo="texture2"))
    primitives.append(UvSphere(name="sphere2", center=c2, radius=hero_r,
                               rings=64, segments=128, material="material2"))
    instances.append(Instance(name="sphere2"))

    textures.append(ConstantTexture(name="texture3", rgb=[0.7, 0.6, 0.5]))
    textures.append(ConstantTexture(name="texture4", rgb=[0.0, 0.0, 0.0]))
    materials.append(Metal(name="material3", albedo="texture3",
                           fuzz="texture4"))
    primitives.append(UvSphere(name="sphere3", center=c3, radius=hero_r,
                               rings=64, segments=128, material="material3"))
    instances.append(Instance(name="sphere3"))

    cameras = [PerspectiveCamera(
        name="default", eye=[13.0, -2.0, 3.0], look_at=[0.0, 0.0, 0.0],
        up=[0.0, 1.0, 0.0], fov_y=20.0, z_near=0.01, z_far=100.0,
        focal_length=10.0, aperture_size=0.2,
    )]

    return SceneFile(
        cameras=cameras,
        textures=textures,
        materials=materials,
        primitives=primitives,
        instances=instances,
        sky=VerticalGradientSky(factor=0.5, top=[0.5, 0.7, 1.0],
                                bottom=[1.0, 1.0, 1.0]),
        render=Render(camera="default", samples_per_pixel=4,
                      sample_batches=25, max_ray_depth=50,
                      aspect_ratio=16.0 / 9.0),
    )


def generate_final_one_weekend_pair():
    """Both shipped variants from ONE seeded stream, reference order
    (tools/src/main.rs:25-31): static first, motion blur second."""
    rng = ChaCha20Rng.seed_from_u64(SEED)
    static = generate_final_one_weekend_scene(False, rng=rng)
    blur = generate_final_one_weekend_scene(True, rng=rng)
    return static, blur
