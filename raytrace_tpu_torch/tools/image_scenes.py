"""Scenes with image textures for the port's tests and smoke run, built in
code.

The reference's ``earth.json``, ``earth-motion-blur.json`` and their
``earthmap.jpg`` are not in this repository, so the port carries scene
docs of its own, built from the geometry that Shirley's *Ray Tracing: The
Next Week* publishes for its ``earth()`` scene, at the render settings the
JAX package records for the reference scenes of those names
(BENCH_SCENES.json, which renders both on the fused path), with an image
written in code in place of the photograph:

- ``texel_id_png(path, w, h)``: an RGB PNG whose texel at column x, row y
  has R = x % 256, G = y % 256, B = x // 256 + 22 * (y // 256).  The
  sRGB table is injective on the 256 byte values, so a colour sampled from
  it names its texel, and a UV error shows as a wrong texel rather than a
  slightly different colour.  The earth's is 5400x2700, the size of the
  reference's earthmap (raytrace_tpu's tests/test_compile.py:116-119).
- ``earth_doc(png)``, ``earth``: a globe of radius 2 at the origin,
  lambertian with the image as albedo; camera at (0, 0, 12) looking at
  the origin, vertical fov 20; the book's solid sky (0.7, 0.8, 1.0); 4
  spp x 16 batches, depth 50, square.  Rendered 512x512 (BENCH_SCENES'
  size; the doc's own window, as every doc's, is 1024 wide).
- ``earth_motion_blur_doc(png)``: the globe turning by 5 degrees about y
  over the shutter (an ``animated`` instance); 8 spp x 32 batches, depth
  50, rendered 512x512.

Fixtures for kernel checks, small enough for the CPU:

- ``image_mix_doc(png)``: an image sphere, an image quad (two triangles
  with their UVs), a ground whose checker has the image as its even side,
  and a mirror sphere that reflects the globe, so images are read after
  the first bounce too (triangles, no light).
- ``image_light_doc(png, quad)``: the globe over a grey ground under a
  black sky, lit by a light whose emission is the image: a quad light
  (triangles and lights) or, with ``quad=False``, a light sphere (lights,
  no triangle).
- ``with_marble(doc)``: a doc with a marble sphere beside its image
  (noise and image textures together).

The camera's up vector is (0, -1, 0), as in tools/light_scenes.py: the
reference's world is y-down, so the book's y-up geometry stays upright.

Run as a script to write ``earth.json``, ``earth-motion-blur.json`` and
their ``earthmap.png`` into a directory:

    python -m raytrace_tpu_torch.tools.image_scenes OUT_DIR
"""

from __future__ import annotations

import copy
import json
import os
import sys

import numpy as np

from .light_scenes import _camera, _quad
from .noise_scenes import _marble, _sphere

EARTH_SIZE = (5400, 2700)   # the reference's earthmap.jpg, width x height
EARTH_WIDTH = 512           # BENCH_SCENES' earth frames are 512x512


def texel_ids(w: int, h: int) -> np.ndarray:
    """[h, w, 3] uint8: each texel's colour names its (x, y)."""
    x = np.arange(w)[None, :].repeat(h, 0)
    y = np.arange(h)[:, None].repeat(w, 1)
    return np.stack([x % 256, y % 256, x // 256 + 22 * (y // 256)],
                    axis=-1).astype(np.uint8)


def texel_id_png(path: str, w: int, h: int) -> str:
    """Write ``texel_ids(w, h)`` as an RGB PNG; returns ``path``."""
    from PIL import Image

    if w > 22 * 256 or h > 11 * 256:
        raise ValueError(f"{w}x{h}: the blue byte names at most 22 x 11 "
                         f"blocks of 256 texels")
    Image.fromarray(texel_ids(w, h), "RGB").save(path, compress_level=1)
    return path


def _image(png: str) -> dict:
    return {"image": {"name": "map", "path": png}}


def earth_doc(png: str) -> dict:
    """The Next Week's ``earth()``, its texture ``png``."""
    return {
        "cameras": [_camera([0, 0, 12], [0, 0, 0], 20)],
        "textures": [_image(png)],
        "materials": [{"lambertian": {"name": "earth", "albedo": "map"}}],
        "primitives": [_sphere("globe", [0, 0, 0], 2, "earth")],
        "instances": [{"name": "globe"}],
        "sky": {"solid": {"rgb": [0.7, 0.8, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": 16, "max_ray_depth": 50,
                   "aspect_ratio": 1.0},
    }


def earth_motion_blur_doc(png: str) -> dict:
    """The globe of ``earth_doc`` turning 5 degrees about y over the
    shutter, at 8 spp x 32 batches."""
    doc = earth_doc(png)
    doc["instances"] = [{"name": "globe", "transform": {"animated": [
        {"rotate": {"axis": [0, 1, 0], "degrees": 0}},
        {"rotate": {"axis": [0, 1, 0], "degrees": 5}}]}}]
    doc["render"].update(samples_per_pixel=8, sample_batches=32)
    return doc


def image_mix_doc(png: str) -> dict:
    """An image sphere, an image quad, a checker ground with the image as
    its even side and a mirror sphere, under the book's solid sky."""
    return {
        "cameras": [_camera([13, 2, 3], [0, 1, 0], 30)],
        "textures": [
            _image(png),
            {"constant": {"name": "rust", "rgb": [0.7, 0.3, 0.1]}},
            {"checker": {"name": "ck", "scale": 0.5, "even": "map",
                         "odd": "rust"}},
            {"constant": {"name": "silver", "rgb": [0.8, 0.8, 0.8]}},
            {"constant": {"name": "fuzz", "rgb": [0, 0, 0]}}],
        "materials": [
            {"lambertian": {"name": "earth", "albedo": "map"}},
            {"lambertian": {"name": "ck", "albedo": "ck"}},
            {"metal": {"name": "mirror", "albedo": "silver", "fuzz": "fuzz"}}],
        "primitives": [
            _sphere("ground", [0, -1000, 0], 1000, "ck"),
            _sphere("globe", [0, 1, 0], 1, "earth"),
            _sphere("mirror", [-2, 1, -2], 1, "mirror"),
            {"quad": {"name": "poster", "points": [[-3, 0, 2], [3, 0, 2],
                                                   [3, 3, 2], [-3, 3, 2]],
                      "normal": [0, 0, -1],
                      "uv": [[0, 0], [1, 0], [1, 1], [0, 1]],
                      "material": "earth"}}],
        "instances": [{"name": "ground"}, {"name": "globe"},
                      {"name": "mirror"}, {"name": "poster"}],
        "sky": {"solid": {"rgb": [0.7, 0.8, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": 2, "max_ray_depth": 8,
                   "aspect_ratio": 16 / 9},
    }


def image_light_doc(png: str, quad: bool = True) -> dict:
    """The globe over a grey ground, lit by a quad light (or a light
    sphere) whose emission is the image, under a black sky."""
    light = (_quad("lamp", [-4, 0, -4], [0, 0, 8], [0, 6, 0], [1, 0, 0],
                   "glow") if quad
             else _sphere("lamp", [0, 7, 0], 2, "glow"))
    return {
        "cameras": [_camera([26, 3, 6], [0, 2, 0], 20)],
        "textures": [
            _image(png),
            {"constant": {"name": "grey", "rgb": [0.5, 0.5, 0.5]}}],
        "materials": [
            {"lambertian": {"name": "earth", "albedo": "map"}},
            {"lambertian": {"name": "grey", "albedo": "grey"}},
            {"diffuse_light": {"name": "glow", "emit": "map"}}],
        "primitives": [
            _sphere("ground", [0, -1000, 0], 1000, "grey"),
            _sphere("globe", [0, 2, 0], 2, "earth"),
            light],
        "instances": [{"name": "ground"}, {"name": "globe"},
                      {"name": "lamp"}],
        "sky": {"solid": {"rgb": [0, 0, 0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": 2, "max_ray_depth": 8,
                   "aspect_ratio": 16 / 9},
    }


def with_marble(doc: dict) -> dict:
    """``doc`` with a marble sphere (noise of scale 4) of radius 1 at
    (2, 1, 2), beside its image."""
    doc = copy.deepcopy(doc)
    doc["textures"].append(_marble())
    doc["materials"].append({"lambertian": {"name": "marble",
                                            "albedo": "marble"}})
    doc["primitives"].append(_sphere("marble_ball", [2, 1, 2], 1, "marble"))
    doc["instances"].append({"name": "marble_ball"})
    return doc


def form_checks(png: str) -> dict:
    """The small frames on which each image form of the fused kernel is
    held against its plain version, by form: (doc, width, depth), each
    rendered 2 batches in one launch.  The animated form takes no image
    (an image scene that moves renders one launch per batch)."""
    base = {"static": (earth_doc(png), 64, 8),
            "tris": (image_mix_doc(png), 96, 8),
            "lights": (image_light_doc(png, quad=False), 96, 8),
            "tris+lights": (image_light_doc(png), 96, 8)}
    out = dict(base)
    for form, (doc, w, depth) in base.items():
        out[form + "+noise"] = (with_marble(doc), w, depth)
    return out


def write_earth_scenes(out_dir: str) -> list:
    """Write earthmap.png (5400x2700 texel ids), earth.json and
    earth-motion-blur.json into ``out_dir``; returns the two JSON paths.
    The docs name the image by a path relative to their directory."""
    os.makedirs(out_dir, exist_ok=True)
    texel_id_png(os.path.join(out_dir, "earthmap.png"), *EARTH_SIZE)
    paths = []
    for name, make in (("earth.json", earth_doc),
                       ("earth-motion-blur.json", earth_motion_blur_doc)):
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            json.dump(make("earthmap.png"), f, indent=1)
        paths.append(path)
    return paths


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    for path in write_earth_scenes(argv[1]):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
