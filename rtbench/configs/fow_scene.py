"""The final scene of *Ray Tracing in One Weekend*, made from a seed.

The benchmark's own copy of the construction in the reference's
tools/src/main.rs:52-326 (and of raytrace_tpu_torch/tools/generate.py,
static variant), writing the scene JSON document directly so that it
imports nothing of the program: a 1000-radius checkered ground sphere
(y-down world), a 22x22 grid of 0.2-radius spheres whose material is
drawn per cell (diffuse < 0.8 <= metal < 0.95 <= glass), each cell's
position drawn again until it clears the three hero spheres, every
sphere snapped onto the ground with a 0.035 fudge, three hero spheres
(glass, brown diffuse, polished metal) and a thin-lens camera.

The RNG is the `rand` crate's ChaCha20 stream (chacha.py) seeded with the
given seed through `seed_from_u64`; at the reference's own seed,
485674845675491, the document is the program generator's sphere for
sphere.  Every seed gives the same 488 spheres of the same materials in
the same cells, as the reference's seed draws them (377 diffuse, 87
metal, 24 glass), so that every seed asks the same work of a render: the
seed moves each small sphere within its cell and draws its colours and
fuzz (each cell still draws its material from the stream, and takes the
reference's).  A seed that drew its own materials would change a
render's work by several percent (PERF.md).
"""

from __future__ import annotations

import numpy as np

from rtbench.configs.chacha import ChaCha20Rng

REFERENCE_SEED = 485_674_845_675_491
FUDGE = 0.035

_f32 = np.float32


def _touch_ground(center, radius, g_center, g_radius):
    """make_sphere_touch_ground (tools/src/main.rs:39-50) in f32, the
    normalisation by a reciprocal length as glam does it."""
    d = [_f32(center[i]) - _f32(g_center[i]) for i in range(3)]
    inv = _f32(1.0) / np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                              dtype=np.float32)
    s = _f32(g_radius) + _f32(radius) - _f32(FUDGE)
    return [float(d[i] * inv * s + _f32(g_center[i])) for i in range(3)]


def _dist_f32(p, q):
    d = [_f32(p[i]) - _f32(q[i]) for i in range(3)]
    return float(np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                         dtype=np.float32))


def _constant(name, rgb):
    return {"constant": {"name": name, "rgb": [float(c) for c in rgb]}}


def _sphere(name, center, radius, rings, segments, material):
    return {"uv_sphere": {"name": name, "center": center,
                          "radius": float(radius), "rings": rings,
                          "segments": segments, "material": material}}


def _materials(seed: int) -> list:
    """Each cell's material as the construction draws it from ``seed``:
    "diffuse", "metal" or "glass", cells in order."""
    return [cell["kind"] for cell in _cells(ChaCha20Rng.seed_from_u64(seed))]


def _cells(rng, kinds=None):
    """The grid's cells, drawing from ``rng`` as the construction does;
    ``kinds`` replaces each cell's drawn material."""
    ground_center, ground_radius = [0.0, 1000.0, 0.0], 1000.0
    c1 = [0.0, -1.0, 0.0]
    c2 = _touch_ground([-4.0, -1.0, 0.0], 1.0, ground_center, ground_radius)
    c3 = _touch_ground([4.0, -1.0, 0.0], 1.0, ground_center, ground_radius)
    hero_r = 1.0
    cells = []
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
            kind = ("diffuse" if choose_mat < 0.8 else
                    "metal" if choose_mat < 0.95 else "glass")
            if kinds is not None:
                kind = kinds[len(cells)]
            cell = {"a": a, "b": b, "center": center, "radius": radius,
                    "kind": kind}
            if kind == "diffuse":
                v1, v2 = rng.vec3(), rng.vec3()
                cell["albedo"] = [float(_f32(v1[i]) * _f32(v2[i]))
                                  for i in range(3)]
            elif kind == "metal":
                cell["albedo"] = rng.vec3_in_range(0.5, 1.0)
                cell["fuzz"] = rng.vec3_in_range(0.0, 0.5)
            cells.append(cell)
    return cells


def scene(seed: int) -> dict:
    """The scene document for ``seed`` (any integer; taken mod 2^64)."""
    rng = ChaCha20Rng.seed_from_u64(seed)
    textures = [
        _constant("green", [0.2, 0.3, 0.1]),
        _constant("pale-white", [0.9, 0.9, 0.9]),
        {"checker": {"name": "green-and-white-checker", "scale": 0.32,
                     "even": "green", "odd": "pale-white"}},
    ]
    materials = [{"lambertian": {"name": "ground",
                                 "albedo": "green-and-white-checker"}}]
    ground_center = [0.0, 1000.0, 0.0]
    ground_radius = 1000.0
    primitives = [_sphere("ground_sphere", ground_center, ground_radius,
                          128, 256, "ground")]
    instances = [{"name": "ground_sphere"}]

    c1 = [0.0, -1.0, 0.0]
    c2 = _touch_ground([-4.0, -1.0, 0.0], 1.0, ground_center, ground_radius)
    c3 = _touch_ground([4.0, -1.0, 0.0], 1.0, ground_center, ground_radius)
    hero_r = 1.0

    for cell in _cells(rng, _materials(REFERENCE_SEED)):
        a, b, kind = cell["a"], cell["b"], cell["kind"]
        if kind == "diffuse":
            name = f"diffuse_{a}_{b}"
            textures.append(_constant(f"tex_albedo_{name}", cell["albedo"]))
            mat = f"mat_{name}"
            materials.append({"lambertian": {
                "name": mat, "albedo": f"tex_albedo_{name}"}})
        elif kind == "metal":
            name = f"metal_{a}_{b}"
            textures.append(_constant(f"tex_albedo_{name}", cell["albedo"]))
            textures.append(_constant(f"tex_fuzz_{name}", cell["fuzz"]))
            mat = f"mat_metal_{a}_{b}"
            materials.append({"metal": {
                "name": mat, "albedo": f"tex_albedo_{name}",
                "fuzz": f"tex_fuzz_{name}"}})
        else:
            mat = f"mat_dielectric_{a}_{b}"
            materials.append({"dielectric": {
                "name": mat, "refraction_index": 1.5}})
        sphere_name = f"sphere_{a}_{b}"
        primitives.append(_sphere(sphere_name, cell["center"],
                                  cell["radius"], 32, 64, mat))
        instances.append({"name": sphere_name})

    materials.append({"dielectric": {"name": "material1",
                                     "refraction_index": 1.5}})
    primitives.append(_sphere("sphere1", c1, hero_r, 64, 128, "material1"))
    instances.append({"name": "sphere1"})
    textures.append(_constant("texture2", [0.4, 0.2, 0.1]))
    materials.append({"lambertian": {"name": "material2",
                                     "albedo": "texture2"}})
    primitives.append(_sphere("sphere2", c2, hero_r, 64, 128, "material2"))
    instances.append({"name": "sphere2"})
    textures.append(_constant("texture3", [0.7, 0.6, 0.5]))
    textures.append(_constant("texture4", [0.0, 0.0, 0.0]))
    materials.append({"metal": {"name": "material3", "albedo": "texture3",
                                "fuzz": "texture4"}})
    primitives.append(_sphere("sphere3", c3, hero_r, 64, 128, "material3"))
    instances.append({"name": "sphere3"})

    return {
        "cameras": [{"perspective": {
            "name": "default", "eye": [13.0, -2.0, 3.0],
            "look_at": [0.0, 0.0, 0.0], "up": [0.0, 1.0, 0.0],
            "fov_y": 20.0, "z_near": 0.01, "z_far": 100.0,
            "focal_length": 10.0, "aperture_size": 0.2}}],
        "textures": textures,
        "materials": materials,
        "primitives": primitives,
        "instances": instances,
        "sky": {"vertical_gradient": {"factor": 0.5, "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": 25, "max_ray_depth": 50,
                   "aspect_ratio": 16.0 / 9.0},
    }
