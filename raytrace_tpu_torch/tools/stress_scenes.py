"""Triangle scenes for the port's tests and smoke run.

- ``tri_stress_doc(k, obj_path)``: the JAX package's triangle stress
  scene (tools_dev/gen_tri_stress.py:27 ``tri_stress_doc``): a k x k grid
  of 960-triangle OBJ instances over an analytic ground sphere, 16 spp in
  one batch, depth 50; k = 4 is ``tri-stress-15360``.
- ``write_sphere_obj(path)``: the OBJ those instances load;
  ``write_tri_stress(out_dir, k)`` writes both as files.  The JAX
  scene reads the reference's ``sphere-smooth.obj``, which this
  repository does not hold; this writes the port's own uv-sphere
  tessellation (models/tessellate.generate_uv_sphere, 16 rings x 32
  segments: 960 triangles with smooth normals) in its place, so that
  ``load_obj`` reads the same 960 triangles back.
- ``triangle_fixture_doc()``: a small scene of triangles alone (a quad
  floor with a checker, a metal box, a dielectric triangle and a
  lambertian quad wall; no sphere, light or noise).
- ``box_grid_doc(n_boxes, moving)``: a grid of small boxes, 12 triangles
  each (16,392 at the default 1366: two pages of the paged sweep, too many
  for the fused kernel's clusters), static or sliding over the shutter.
- ``big_spheres_doc(...)``: final-one-weekend's ground sphere and its
  three large spheres alone, for rendering tessellated
  (``analytic_spheres=False``; 28,032 triangles at the default rings).

Run as a script to write tri-stress-<n>.json and its OBJ into a directory:

    python -m raytrace_tpu_torch.tools.stress_scenes OUT_DIR [K]
"""

from __future__ import annotations

import json
import os
import sys

from ..models.tessellate import generate_uv_sphere

_FINAL_ONE_WEEKEND = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "assets", "final-one-weekend.json")


def write_sphere_obj(path: str, rings: int = 16, segments: int = 32) -> str:
    """Write a unit uv-sphere as an OBJ of ``v``/``vt``/``vn`` lines and
    ``f a/a/a`` faces; returns ``path``.  Each texture v is written as
    1 - v, which ``load_obj``'s flip turns back."""
    pos, nrm, uv, idx = generate_uv_sphere([0.0, 0.0, 0.0], 1.0, rings,
                                           segments)
    lines = [f"# uv sphere, {rings} rings x {segments} segments, "
             f"{len(idx) // 3} triangles"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in pos]
    lines += [f"vt {u:.9g} {1.0 - v:.9g}" for u, v in uv]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in nrm]
    tri = idx.reshape(-1, 3) + 1
    lines += ["f " + " ".join(f"{i}/{i}/{i}" for i in t) for t in tri]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def tri_stress_doc(k: int, obj_path: str) -> dict:
    """k * k instances of the 960-triangle OBJ at ``obj_path`` over a
    ground sphere (tools_dev/gen_tri_stress.py:27-62)."""
    prims = [{"uv_sphere": {"name": "ground", "center": [0, -1000, 0],
                            "radius": 1000, "rings": 4, "segments": 8,
                            "material": "ground"}},
             {"obj_mesh": {"name": "ball", "path": obj_path,
                           "material": "grey"}}]
    insts = [{"name": "ground"}]
    for i in range(k):
        for j in range(k):
            insts.append({
                "name": "ball",
                "transform": {"static": {
                    "translate": [2.5 * (i - (k - 1) / 2), 1.0,
                                  2.5 * (j - (k - 1) / 2)],
                }},
            })
    return {
        "cameras": [{"perspective": {
            "name": "default", "eye": [0, 6.0, 3.0 * k + 4],
            "look_at": [0, 1, 0], "up": [0, 1, 0], "fov_y": 32,
            "z_near": 0.1, "z_far": 10000, "focal_length": 10.0,
            "aperture_size": 0}}],
        "textures": [
            {"constant": {"name": "grey", "rgb": [0.73, 0.73, 0.73]}},
            {"constant": {"name": "ground", "rgb": [0.8, 0.8, 0.0]}}],
        "materials": [
            {"lambertian": {"name": "grey", "albedo": "grey"}},
            {"lambertian": {"name": "ground", "albedo": "ground"}}],
        "primitives": prims, "instances": insts,
        "sky": {"vertical_gradient": {"factor": 0.5,
                                      "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 16,
                   "sample_batches": 1, "max_ray_depth": 50,
                   "aspect_ratio": 1.7777778},
    }


def triangle_fixture_doc() -> dict:
    """Triangles alone: a checkered quad floor, a metal box, a dielectric
    triangle and a lambertian quad wall, under a gradient sky."""
    return {
        "cameras": [{"perspective": {
            "name": "default", "eye": [0.0, 3.0, 7.0],
            "look_at": [0.0, 0.6, 0.0], "up": [0, 1, 0], "fov_y": 40,
            "z_near": 0.1, "z_far": 1000, "focal_length": 10.0,
            "aperture_size": 0}}],
        "textures": [
            {"constant": {"name": "white", "rgb": [0.8, 0.8, 0.8]}},
            {"constant": {"name": "green", "rgb": [0.2, 0.5, 0.2]}},
            {"constant": {"name": "red", "rgb": [0.7, 0.2, 0.15]}},
            {"constant": {"name": "fuzz", "rgb": [0.05, 0.05, 0.05]}},
            {"checker": {"name": "floor", "scale": 0.5, "even": "white",
                         "odd": "green"}}],
        "materials": [
            {"lambertian": {"name": "floor", "albedo": "floor"}},
            {"lambertian": {"name": "wall", "albedo": "red"}},
            {"metal": {"name": "steel", "albedo": "white", "fuzz": "fuzz"}},
            {"dielectric": {"name": "glass", "refraction_index": 1.5}}],
        "primitives": [
            {"quad": {"name": "floor",
                      "points": [[-6, 0, -6], [6, 0, -6], [6, 0, 6],
                                 [-6, 0, 6]],
                      "normal": [0, 1, 0],
                      "uv": [[0, 0], [1, 0], [1, 1], [0, 1]],
                      "material": "floor"}},
            {"quad": {"name": "wall",
                      "points": [[-4, 0, -2.5], [4, 0, -2.5], [4, 3, -2.5],
                                 [-4, 3, -2.5]],
                      "normal": [0, 0, 1],
                      "uv": [[0, 0], [1, 0], [1, 1], [0, 1]],
                      "material": "wall"}},
            {"box": {"name": "box", "corners": [[-2.2, 0, -1.2],
                                                [-0.8, 1.4, 0.2]],
                     "material": "steel"}},
            {"triangle": {"name": "prism",
                          "points": [[0.3, 0, 0.6], [2.1, 0, -0.2],
                                     [1.2, 1.8, 0.2]],
                          "normal": [0.0, 0.22, 0.97],
                          "uv": [[0, 0], [1, 0], [0.5, 1]],
                          "material": "glass"}}],
        "instances": [{"name": "floor"}, {"name": "wall"}, {"name": "box"},
                      {"name": "prism"}],
        "sky": {"vertical_gradient": {"factor": 0.5,
                                      "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": 2, "max_ray_depth": 8,
                   "aspect_ratio": 1.7777778},
    }


def box_grid_doc(n_boxes: int = 1366, moving: bool = False) -> dict:
    """``n_boxes`` 0.1-unit boxes in rows of 40 on a 0.2 grid, seen by
    final-one-weekend's camera under its sky, lambertian; with ``moving``
    each box slides 0.1 along y over the shutter."""
    with open(_FINAL_ONE_WEEKEND) as f:
        base = json.load(f)
    def transform(i):
        at = [0.2 * (i % 40), 0.0, 0.2 * (i // 40)]
        if not moving:
            return {"static": {"translate": at}}
        return {"animated": [{"translate": at},
                             {"translate": [at[0], -0.1, at[2]]}]}
    return {
        "cameras": base["cameras"],
        "textures": [{"constant": {"name": "white",
                                   "rgb": [0.8, 0.8, 0.8]}}],
        "materials": [{"lambertian": {"name": "m", "albedo": "white"}}],
        "primitives": [{"box": {"name": "b", "corners": [[0, 0, 0],
                                                         [0.1, 0.1, 0.1]],
                                "material": "m"}}],
        "instances": [{"name": "b", "transform": transform(i)}
                      for i in range(n_boxes)],
        "sky": base["sky"],
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": 2, "max_ray_depth": 6,
                   "aspect_ratio": 1.7777778},
    }


def big_spheres_doc(ground=(64, 128), spheres=(32, 64)) -> dict:
    """final-one-weekend (assets/final-one-weekend.json) cut to its ground
    sphere and its three large spheres (sphere1-3: dielectric, checkered
    lambertian and metal), with their materials, camera and sky, and the
    (rings, segments) given for the ground and for the three."""
    with open(_FINAL_ONE_WEEKEND) as f:
        doc = json.load(f)
    keep = {"ground_sphere": ground, "sphere1": spheres,
            "sphere2": spheres, "sphere3": spheres}
    doc["primitives"] = [p for p in doc["primitives"]
                         if p["uv_sphere"]["name"] in keep]
    for p in doc["primitives"]:
        sph = p["uv_sphere"]
        sph["rings"], sph["segments"] = keep[sph["name"]]
    doc["instances"] = [i for i in doc["instances"] if i["name"] in keep]
    used = {p["uv_sphere"]["material"] for p in doc["primitives"]}
    doc["materials"] = [m for m in doc["materials"]
                        if next(iter(m.values()))["name"] in used]
    return doc


def write_tri_stress(out_dir: str, k: int = 4) -> str:
    """Write tri-stress-<k * k * 960>.json and the OBJ it loads into
    ``out_dir``; returns the JSON's path."""
    os.makedirs(out_dir, exist_ok=True)
    obj = write_sphere_obj(os.path.join(out_dir, "sphere-smooth.obj"))
    path = os.path.join(out_dir, f"tri-stress-{k * k * 960}.json")
    with open(path, "w") as f:
        json.dump(tri_stress_doc(k, os.path.abspath(obj)), f)
    return path


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(write_tri_stress(argv[1], int(argv[2]) if len(argv) > 2 else 4))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
