"""Scenes whose material graph the 32-float fat shading row cannot encode
(models/shading_table.py ComplexMaterial), for the port's tests and smoke
run, built in code from the repo's final-one-weekend
(assets/final-one-weekend.json) and small inline documents.  Such a scene
has no ``shade_rows``, the fused kernel's gate refuses it, and it renders
on the wavefront with registry shading (ops/materials.py).

- ``fow_registry_doc()``, ``fow-registry``: final-one-weekend, each of its
  80 metal materials' fuzz pointed at one new checker of two constant
  textures, fuzz 0.0 and 0.3 (``FUZZ_CHECKER``).  A checker on a property
  other than an albedo has no slot in the fat row.  The ground's checker
  albedo keeps the checker branch of the registry busy.  At its own
  settings: 488 spheres, 1200x675 by its aspect ratio, 4 spp x 25
  batches, depth 50.

Small documents, one for each way a material graph outgrows the row (the
ground and the three large spheres of final-one-weekend,
tools/stress_scenes.big_spheres_doc, with the metal sphere3's material
changed), in ``SMALL_DOCS``:

- ``fuzz-checker``: sphere3's fuzz is a checker (a checker on a non-albedo
  property; the compiler names it as a fuzz that is not constant);
- ``two-checkers``: sphere3's albedo and its fuzz are both checkers;
- ``noise-checker-fuzz``: sphere3's fuzz is a checker whose odd side is a
  noise texture, so the registry's checker reaches the noise family;
- ``noise-fuzz``: sphere3's fuzz is a noise texture (a metal fuzz that is
  not constant).

A nested checker, the fourth case of ComplexMaterial, reaches no renderer:
``compile_scene`` validates the scene first, which refuses a checker of a
checker (scene_file/texture.py), so no document of it is built here.

Run as a script to write ``fow-registry.json`` into a directory:

    python -m raytrace_tpu_torch.tools.registry_scenes OUT_DIR
"""

from __future__ import annotations

import json
import os
import sys

from .stress_scenes import _FINAL_ONE_WEEKEND, big_spheres_doc

FUZZ_CHECKER = "fuzz-checker"
FUZZ_SIDES = (("fuzz-0", 0.0), ("fuzz-0.3", 0.3))
FUZZ_SCALE = 0.2


def _add_fuzz_checker(doc: dict) -> dict:
    """The fuzz checker and its two constant sides, added to the doc's
    textures."""
    for name, f in FUZZ_SIDES:
        doc["textures"].append({"constant": {"name": name, "rgb": [f] * 3}})
    doc["textures"].append({"checker": {
        "name": FUZZ_CHECKER, "scale": FUZZ_SCALE,
        "even": FUZZ_SIDES[0][0], "odd": FUZZ_SIDES[1][0]}})
    return doc


def fow_registry_doc() -> dict:
    """final-one-weekend with every metal's fuzz the fuzz checker."""
    with open(_FINAL_ONE_WEEKEND) as f:
        doc = _add_fuzz_checker(json.load(f))
    for mat in doc["materials"]:
        if "metal" in mat:
            mat["metal"]["fuzz"] = FUZZ_CHECKER
    return doc


def _material_of(doc: dict, instance: str) -> dict:
    """The material record of the primitive an instance names."""
    prim = next(p for p in doc["primitives"]
                if next(iter(p.values()))["name"] == instance)
    name = next(iter(prim.values()))["material"]
    mat = next(m for m in doc["materials"]
               if next(iter(m.values()))["name"] == name)
    return next(iter(mat.values()))


SMALL_DOCS = ("fuzz-checker", "two-checkers", "noise-checker-fuzz",
              "noise-fuzz")


def small_doc(kind: str) -> dict:
    """One of ``SMALL_DOCS``."""
    doc = _add_fuzz_checker(big_spheres_doc())
    metal = _material_of(doc, "sphere3")
    if kind == "fuzz-checker":
        metal["fuzz"] = FUZZ_CHECKER
    elif kind == "two-checkers":
        metal["albedo"] = "green-and-white-checker"
        metal["fuzz"] = FUZZ_CHECKER
    elif kind == "noise-checker-fuzz":
        doc["textures"].append({"noise": {"name": "fuzz-noise",
                                          "scale": 4.0}})
        doc["textures"].append({"checker": {
            "name": "noise-checker", "scale": 0.5, "even": "fuzz-0.3",
            "odd": "fuzz-noise"}})
        metal["fuzz"] = "noise-checker"
    elif kind == "noise-fuzz":
        doc["textures"].append({"noise": {"name": "fuzz-noise",
                                          "scale": 4.0}})
        metal["fuzz"] = "fuzz-noise"
    else:
        raise ValueError(f"unknown registry doc {kind!r}")
    return doc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m raytrace_tpu_torch.tools.registry_scenes "
              "OUT_DIR", file=sys.stderr)
        return 2
    os.makedirs(argv[0], exist_ok=True)
    path = os.path.join(argv[0], "fow-registry.json")
    with open(path, "w") as f:
        json.dump(fow_registry_doc(), f)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
