"""Scenes with noise textures for the port's tests and smoke run, built in
code.

The reference's ``perlin-spheres.json`` is not in this repository (its
golden ``tests/goldens/perlin-spheres.npz`` was made from it and is no
target here), so the port carries a scene doc of its own, built from the
geometry that Shirley's *Ray Tracing: The Next Week* publishes for its
"two Perlin spheres" (``two_perlin_spheres()``), at the render settings
the JAX package records for the reference scene of that name
(BENCH_SCENES.json: 1024x576, 16 spp x 1 batch, depth 50, the fused path):

- ``perlin_spheres_doc()``, ``perlin-spheres``: a ground sphere of radius
  1000 at (0, -1000, 0) and a sphere of radius 2 at (0, 2, 0), both
  lambertian with a ``noise`` texture of scale 4 (the book's marble);
  camera at (13, 2, 3) looking at the origin, vertical fov 20, no
  defocus.  The sky is the book's for this scene, a solid (0.7, 0.8, 1.0).

Fixtures for kernel checks, small enough for the CPU:

- ``noise_checker_doc()``: a checker whose even slot is a noise texture
  and whose odd slot is a constant, on an analytic sphere and on a quad
  of two triangles, beside a noise sphere and a metal sphere with a noise
  albedo (triangles, no light: the fused kernel's triangle form with
  noise).
- ``noise_light_doc()``: analytic spheres only, a noise ground, a grey
  sphere and a light sphere whose emission is a noise texture (lights,
  no triangle: the fused kernel's lit form with noise, and the emission
  slot's noise).
- ``marble_motion_blur_doc(doc)``: a copy of the motion-blur scene's doc
  whose ground checker takes a noise texture as its even slot and whose
  big lambertian sphere a noise albedo (the animated form with noise).

The camera's up vector is (0, -1, 0), as in tools/light_scenes.py: the
reference's world is y-down, so the book's y-up geometry stays upright.

Run as a script to write ``perlin-spheres.json`` into a directory:

    python -m raytrace_tpu_torch.tools.noise_scenes OUT_DIR
"""

from __future__ import annotations

import copy
import json
import os
import sys

from .light_scenes import _camera, sphere_light_doc

def _marble() -> dict:
    """The book's marble: a noise texture of scale 4."""
    return {"noise": {"name": "marble", "scale": 4}}


def _sphere(name, center, radius, material) -> dict:
    return {"uv_sphere": {"name": name, "center": center, "radius": radius,
                          "rings": 16, "segments": 32, "material": material}}


def perlin_spheres_doc() -> dict:
    """The Next Week's two Perlin spheres (its ``two_perlin_spheres()``)."""
    return {
        "cameras": [_camera([13, 2, 3], [0, 0, 0], 20)],
        "textures": [_marble()],
        "materials": [{"lambertian": {"name": "marble", "albedo": "marble"}}],
        "primitives": [_sphere("ground", [0, -1000, 0], 1000, "marble"),
                       _sphere("ball", [0, 2, 0], 2, "marble")],
        "instances": [{"name": "ground"}, {"name": "ball"}],
        "sky": {"solid": {"rgb": [0.7, 0.8, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 16,
                   "sample_batches": 1, "max_ray_depth": 50,
                   "aspect_ratio": 16 / 9},
    }


def noise_checker_doc() -> dict:
    """A checker of a noise and a constant on a sphere and a triangle quad,
    a noise sphere and a noise metal sphere over a checkered ground."""
    return {
        "cameras": [_camera([13, 2, 3], [0, 1, 0], 30)],
        "textures": [
            _marble(),
            {"noise": {"name": "fine", "scale": 9}},
            {"constant": {"name": "rust", "rgb": [0.7, 0.3, 0.1]}},
            {"checker": {"name": "ck", "scale": 0.5, "even": "marble",
                         "odd": "rust"}},
            {"constant": {"name": "fuzz", "rgb": [0.2, 0.2, 0.2]}}],
        "materials": [
            {"lambertian": {"name": "ck", "albedo": "ck"}},
            {"lambertian": {"name": "fine", "albedo": "fine"}},
            {"metal": {"name": "steel", "albedo": "marble", "fuzz": "fuzz"}}],
        "primitives": [
            _sphere("ground", [0, -1000, 0], 1000, "ck"),
            _sphere("ball", [0, 1, 0], 1, "fine"),
            _sphere("mirror", [-2, 1, -2], 1, "steel"),
            {"quad": {"name": "wall", "points": [[-3, 0, 2], [3, 0, 2],
                                                 [3, 3, 2], [-3, 3, 2]],
                      "normal": [0, 0, -1],
                      "uv": [[0, 0], [1, 0], [1, 1], [0, 1]],
                      "material": "ck"}}],
        "instances": [{"name": "ground"}, {"name": "ball"},
                      {"name": "mirror"}, {"name": "wall"}],
        "sky": {"solid": {"rgb": [0.7, 0.8, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": 2, "max_ray_depth": 8,
                   "aspect_ratio": 16 / 9},
    }


def noise_light_doc() -> dict:
    """Analytic spheres: a noise ground, a grey sphere and a light sphere
    whose emission is a noise texture, under a black sky."""
    return {
        "cameras": [_camera([26, 3, 6], [0, 2, 0], 20)],
        "textures": [
            _marble(),
            {"constant": {"name": "grey", "rgb": [0.5, 0.5, 0.5]}}],
        "materials": [
            {"lambertian": {"name": "marble", "albedo": "marble"}},
            {"lambertian": {"name": "grey", "albedo": "grey"}},
            {"diffuse_light": {"name": "glow", "emit": "marble"}}],
        "primitives": [
            _sphere("ground", [0, -1000, 0], 1000, "marble"),
            _sphere("ball", [0, 2, 0], 2, "grey"),
            _sphere("light_ball", [0, 7, 0], 2, "glow")],
        "instances": [{"name": "ground"}, {"name": "ball"},
                      {"name": "light_ball"}],
        "sky": {"solid": {"rgb": [0, 0, 0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": 2, "max_ray_depth": 8,
                   "aspect_ratio": 16 / 9},
    }


def marble_motion_blur_doc(doc: dict) -> dict:
    """final-one-weekend-motion-blur's ``doc`` with noise: its ground
    checker's even slot and its big lambertian sphere's albedo become the
    marble.  The motion is unchanged."""
    doc = copy.deepcopy(doc)
    doc["textures"].append(_marble())
    for tex in doc["textures"]:
        if "checker" in tex:
            tex["checker"]["even"] = "marble"
    for mat in doc["materials"]:
        if mat.get("lambertian", {}).get("name") == "material2":
            mat["lambertian"]["albedo"] = "marble"
    return doc


def form_checks(mb_doc: dict) -> dict:
    """The small frames on which each noise form of the fused kernel is
    held against its plain version, by form: (doc, width, depth), each
    rendered 2 batches in one launch.  ``mb_doc`` is the motion-blur
    scene's doc (assets/final-one-weekend-motion-blur.json)."""
    return {"static": (perlin_spheres_doc(), 96, 8),
            "anim": (marble_motion_blur_doc(mb_doc), 96, 8),
            "tris": (noise_checker_doc(), 96, 8),
            "lights": (noise_light_doc(), 96, 8),
            "tris+lights": (sphere_light_doc(), 128, 50)}


def write_perlin_spheres(out_dir: str) -> str:
    """Write perlin-spheres.json into ``out_dir``; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "perlin-spheres.json")
    with open(path, "w") as f:
        json.dump(perlin_spheres_doc(), f, indent=1)
    return path


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(write_perlin_spheres(argv[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
