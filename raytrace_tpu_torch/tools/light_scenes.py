"""Scenes with lights for the port's tests and smoke run, built in code.

The reference's ``cornell-box.json`` and ``simple-light.json`` are not in
this repository, so the port carries two scene docs of its own, built
from the geometry that Shirley's *Ray Tracing: The Next Week* publishes
for its Cornell box (``cornell_box()``) and its "simple light" scene
(``simple_light()``), at the render settings the JAX package records for
the reference scenes of those names (BENCH_SCENES.json):

- ``cornell_doc()``, ``cornell-style``: five quad walls (red at x = 0,
  green at x = 555, white floor, ceiling and back wall), a quad light of
  emit (15, 15, 15) at y = 554 facing down, and two white boxes placed by
  instance transforms (rotated 15 and -18 degrees about y, then moved);
  solid black sky; 1024x1024, 64 spp x 32 batches, depth 50.  36
  triangles in file order (2 of them the light), 8 instances, no sphere.
  The rotated boxes make the hit-instance quirk of the light sample
  (ops/nee.py) visible.
- ``sphere_light_doc()``, ``sphere-light-962``: a ground sphere and a
  lambertian sphere, both with the book's Perlin texture (``noise`` of
  scale 4), a light sphere (16 rings x 32 segments) and a light quad,
  both of emit (4, 4, 4); black sky; 1024x576, 64 spp x 2 batches, depth
  50.  The spheres are traced analytically; the alias table holds the
  light sphere's 960 tessellated triangles and the quad's 2: 962 lights,
  the count the JAX kernel's light_gather comment gives for simple-light
  (raytrace_tpu/ops/megakernel.py:260-263).

Two small fixtures for kernel checks: ``lit_spheres_doc()`` (the sphere
scene without its quad, and with a checker ground and a grey sphere in
place of the Perlin texture: lights, no triangle and no noise) and
``many_instances_doc(n)`` (a lit scene of ``n`` instances).

The camera's up vector is (0, -1, 0): the reference's world is y-down
(models/tessellate.py), so the book's y-up geometry keeps its light at
the top of the image that way.

Run as a script to write both JSONs into a directory:

    python -m raytrace_tpu_torch.tools.light_scenes OUT_DIR
"""

from __future__ import annotations

import json
import os
import sys


def _camera(eye, look_at, fov_y) -> dict:
    return {"perspective": {
        "name": "default", "eye": eye, "look_at": look_at, "up": [0, -1, 0],
        "fov_y": fov_y, "z_near": 0.1, "z_far": 10000, "focal_length": 10.0,
        "aperture_size": 0}}


def _quad(name, q, u, v, normal, material) -> dict:
    """The book's quad(Q, u, v): corners Q, Q + u, Q + u + v, Q + v."""
    pts = [q, [a + b for a, b in zip(q, u)],
           [a + b + c for a, b, c in zip(q, u, v)], [a + c for a, c in zip(q, v)]]
    return {"quad": {"name": name, "points": pts, "normal": normal,
                     "uv": [[0, 0], [1, 0], [1, 1], [0, 1]],
                     "material": material}}


def cornell_doc() -> dict:
    """The Next Week's Cornell box (its ``cornell_box()``)."""
    return {
        "cameras": [_camera([278, 278, -800], [278, 278, 0], 40)],
        "textures": [
            {"constant": {"name": "red", "rgb": [0.65, 0.05, 0.05]}},
            {"constant": {"name": "white", "rgb": [0.73, 0.73, 0.73]}},
            {"constant": {"name": "green", "rgb": [0.12, 0.45, 0.15]}},
            {"constant": {"name": "light", "rgb": [15, 15, 15]}}],
        "materials": [
            {"lambertian": {"name": "red", "albedo": "red"}},
            {"lambertian": {"name": "white", "albedo": "white"}},
            {"lambertian": {"name": "green", "albedo": "green"}},
            {"diffuse_light": {"name": "light", "emit": "light"}}],
        "primitives": [
            _quad("green_wall", [555, 0, 0], [0, 555, 0], [0, 0, 555],
                  [-1, 0, 0], "green"),
            _quad("red_wall", [0, 0, 0], [0, 555, 0], [0, 0, 555],
                  [1, 0, 0], "red"),
            _quad("light", [343, 554, 332], [-130, 0, 0], [0, 0, -105],
                  [0, -1, 0], "light"),
            _quad("floor", [0, 0, 0], [555, 0, 0], [0, 0, 555], [0, 1, 0],
                  "white"),
            _quad("ceiling", [555, 555, 555], [-555, 0, 0], [0, 0, -555],
                  [0, -1, 0], "white"),
            _quad("back_wall", [0, 0, 555], [555, 0, 0], [0, 555, 0],
                  [0, 0, -1], "white"),
            {"box": {"name": "tall_box", "corners": [[0, 0, 0],
                                                     [165, 330, 165]],
                     "material": "white"}},
            {"box": {"name": "short_box", "corners": [[0, 0, 0],
                                                      [165, 165, 165]],
                     "material": "white"}}],
        "instances": [
            {"name": "green_wall"}, {"name": "red_wall"}, {"name": "light"},
            {"name": "floor"}, {"name": "ceiling"}, {"name": "back_wall"},
            {"name": "tall_box", "transform": {"static": {
                "rotate": {"axis": [0, 1, 0], "degrees": 15},
                "translate": [265, 0, 295]}}},
            {"name": "short_box", "transform": {"static": {
                "rotate": {"axis": [0, 1, 0], "degrees": -18},
                "translate": [130, 0, 65]}}}],
        "sky": {"solid": {"rgb": [0, 0, 0]}},
        "render": {"camera": "default", "samples_per_pixel": 64,
                   "sample_batches": 32, "max_ray_depth": 50,
                   "aspect_ratio": 1.0},
    }


def _simple_light(textures, ground: str, ball: str) -> dict:
    """The Next Week's simple light with the ground and the lambertian
    sphere textured ``ground`` and ``ball`` (names among ``textures``)."""
    return {
        "cameras": [_camera([26, 3, 6], [0, 2, 0], 20)],
        "textures": textures + [
            {"constant": {"name": "light", "rgb": [4, 4, 4]}}],
        "materials": [
            {"lambertian": {"name": "ground", "albedo": ground}},
            {"lambertian": {"name": "grey", "albedo": ball}},
            {"diffuse_light": {"name": "light", "emit": "light"}}],
        "primitives": [
            {"uv_sphere": {"name": "ground", "center": [0, -1000, 0],
                           "radius": 1000, "rings": 16, "segments": 32,
                           "material": "ground"}},
            {"uv_sphere": {"name": "ball", "center": [0, 2, 0], "radius": 2,
                           "rings": 16, "segments": 32, "material": "grey"}},
            {"uv_sphere": {"name": "light_ball", "center": [0, 7, 0],
                           "radius": 2, "rings": 16, "segments": 32,
                           "material": "light"}},
            _quad("light_quad", [3, 1, -2], [2, 0, 0], [0, 2, 0], [0, 0, 1],
                  "light")],
        "instances": [{"name": "ground"}, {"name": "ball"},
                      {"name": "light_ball"}, {"name": "light_quad"}],
        "sky": {"solid": {"rgb": [0, 0, 0]}},
        "render": {"camera": "default", "samples_per_pixel": 64,
                   "sample_batches": 2, "max_ray_depth": 50,
                   "aspect_ratio": 16 / 9},
    }


def sphere_light_doc() -> dict:
    """The Next Week's simple light (its ``simple_light()``): the Perlin
    texture on the ground and the sphere."""
    return _simple_light([{"noise": {"name": "pertext", "scale": 4}}],
                         "pertext", "pertext")


def lit_spheres_doc() -> dict:
    """sphere-light-962 without its quad, and with a checkered ground and
    a grey sphere: analytic spheres and the light sphere's 960 light
    triangles, no triangle to trace and no noise (the fused kernel's lit
    form without triangles, and a checker under lights)."""
    doc = _simple_light([
        {"constant": {"name": "dark", "rgb": [0.2, 0.3, 0.1]}},
        {"constant": {"name": "pale", "rgb": [0.9, 0.9, 0.9]}},
        {"checker": {"name": "checker", "scale": 0.32, "even": "dark",
                     "odd": "pale"}},
        {"constant": {"name": "grey", "rgb": [0.5, 0.5, 0.5]}}],
        "checker", "grey")
    doc["primitives"] = doc["primitives"][:3]
    doc["instances"] = doc["instances"][:3]
    return doc


def many_instances_doc(n: int = 70) -> dict:
    """cornell-style's light and floor under ``n - 2`` small white boxes,
    each turned and placed by its own instance: a lit scene with more
    instances than the JAX kernel's cap of 64."""
    doc = cornell_doc()
    doc["primitives"] = [p for p in doc["primitives"]
                         if p.get("quad", {}).get("name") in ("light",
                                                              "floor")]
    doc["primitives"].append({"box": {"name": "b", "corners": [
        [0, 0, 0], [30, 30, 30]], "material": "white"}})
    doc["instances"] = [{"name": "light"}, {"name": "floor"}] + [
        {"name": "b", "transform": {"static": {
            "rotate": {"axis": [0, 1, 0], "degrees": 7 * i},
            "translate": [50 + 60 * (i % 8), 0, 50 + 60 * (i // 8)]}}}
        for i in range(n - 2)]
    return doc


DOCS = {"cornell-style": cornell_doc, "sphere-light-962": sphere_light_doc}


def write_light_scenes(out_dir: str) -> list:
    """Write cornell-style.json and sphere-light-962.json into
    ``out_dir``; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, doc in DOCS.items():
        path = os.path.join(out_dir, name + ".json")
        with open(path, "w") as f:
            json.dump(doc(), f, indent=1)
        paths.append(path)
    return paths


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    for path in write_light_scenes(argv[1]):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
