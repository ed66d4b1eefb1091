"""Scenes with ellipsoids (spheres under a non-uniform instance scale) for
the port's tests and smoke run, built in code.

No scene of the reference has an ellipsoid, so the port carries its own,
made from final-one-weekend (assets/final-one-weekend.json) at its own
render settings (1200x675 by its aspect ratio, 4 spp x 25 batches, depth
50):

- ``fow_ellipsoids_doc()``, ``fow-ellipsoids``: final-one-weekend with its
  three large spheres (``sphere1``-``sphere3``: dielectric, lambertian
  and metal) given a static scale of [1, 1.5, 1] about the origin, which
  stretches each to a 1.5-high ellipsoid still standing on the ground.
  No world-space sphere table maps such a sphere, so all 488 spheres are
  swept in object space (the wavefront's kernel H2).

A fixture small enough for the CPU:

- ``ellipsoid_fixture_doc(moving, triangles)``: final-one-weekend cut to
  its ground and its three large spheres (tools/stress_scenes.
  big_spheres_doc), the three stretched as above; with ``moving`` the
  metal one also slides and grows along x over the shutter; with
  ``triangles`` a red quad wall of two triangles stands behind them.

Run as a script to write ``fow-ellipsoids.json`` into a directory:

    python -m raytrace_tpu_torch.tools.ellipsoid_scenes OUT_DIR
"""

from __future__ import annotations

import json
import os
import sys

from .stress_scenes import _FINAL_ONE_WEEKEND, big_spheres_doc

LARGE = ("sphere1", "sphere2", "sphere3")
SCALE = [1.0, 1.5, 1.0]


def _stretch(doc: dict) -> dict:
    for inst in doc["instances"]:
        if inst["name"] in LARGE:
            inst["transform"] = {"static": {"scale": list(SCALE)}}
    return doc


def fow_ellipsoids_doc() -> dict:
    """final-one-weekend with sphere1-3 scaled by [1, 1.5, 1]."""
    with open(_FINAL_ONE_WEEKEND) as f:
        return _stretch(json.load(f))


def ellipsoid_fixture_doc(moving: bool = False,
                          triangles: bool = False) -> dict:
    """The ground and the three large spheres of final-one-weekend, the
    three stretched; ``moving``: sphere3 slides by 0.5 and stretches to
    [1.5, 1.5, 1] over the shutter; ``triangles``: a quad wall at
    x = -7, behind them (the scene's world is y-down: the wall rises from
    the ground to y = -4)."""
    doc = _stretch(big_spheres_doc())
    if moving:
        inst = next(i for i in doc["instances"] if i["name"] == "sphere3")
        inst["transform"] = {"animated": [
            {"scale": list(SCALE)},
            {"translate": [0.5, 0.0, 0.0], "scale": [1.5, 1.5, 1.0]}]}
    if triangles:
        doc["textures"].append({"constant": {"name": "wall_red",
                                             "rgb": [0.7, 0.2, 0.15]}})
        doc["materials"].append({"lambertian": {"name": "wall",
                                                "albedo": "wall_red"}})
        doc["primitives"].append({"quad": {
            "name": "wall", "points": [[-7, 0, -8], [-7, 0, 8],
                                       [-7, -4, 8], [-7, -4, -8]],
            "normal": [1, 0, 0], "uv": [[0, 0], [1, 0], [1, 1], [0, 1]],
            "material": "wall"}})
        doc["instances"].append({"name": "wall"})
    return doc


def write_fow_ellipsoids(out_dir: str) -> str:
    """Write fow-ellipsoids.json into ``out_dir``; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "fow-ellipsoids.json")
    with open(path, "w") as f:
        json.dump(fow_ellipsoids_doc(), f, indent=1)
    return path


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(write_fow_ellipsoids(argv[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
