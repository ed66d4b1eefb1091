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

And rays that test the object-space walk's boxes (ops/sphere_obj.py):
``surface_points`` samples every ellipsoid's surface from an
object-space table, ``grazing_rays`` aims rays along its tangent planes,
from near and from far.

Run as a script to write ``fow-ellipsoids.json`` into a directory:

    python -m raytrace_tpu_torch.tools.ellipsoid_scenes OUT_DIR
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

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


def _surface(tab: np.ndarray, u: np.ndarray):
    """World points and unit normals of spheres (float64 rows ``tab`` of
    an object-space table, [.., 16]) at the unit object-space directions
    ``u`` ([.., 3]): sphere {x : |M x + t - c| = r} at y = c + r u is x =
    A (y - t), A the inverse of M's 3 x 3 part, with normal M^T u."""
    m = tab[..., 0:12].reshape(tab.shape[:-1] + (3, 4))
    y = tab[..., 12:15] + tab[..., 15:16] * u
    x = np.einsum("...ij,...j->...i", np.linalg.inv(m[..., 0:3]),
                  y - m[..., 3])
    n = np.einsum("...ji,...j->...i", m[..., 0:3], u)
    return x, n / np.linalg.norm(n, axis=-1, keepdims=True)


def _directions(g, shape):
    u = g.standard_normal(shape + (3,))
    return u / np.linalg.norm(u, axis=-1, keepdims=True)


def surface_points(table16, num_spheres: int, per_sphere: int, seed: int):
    """``per_sphere`` random points on each ellipsoid of an [S8, 16]
    object-space table (ops/spheres.object_sphere_table, a tensor or an
    array), in float64: ([num_spheres, per_sphere, 3] world points, the
    same shape of unit world normals)."""
    tab = np.asarray(table16, np.float64)[:num_spheres]
    u = _directions(np.random.default_rng(seed), (len(tab), per_sphere))
    return _surface(np.repeat(tab[:, None], per_sphere, axis=1), u)


def grazing_rays(table16, num_spheres: int, n: int, seed: int,
                 dist=(1.0, 20.0), jitter: float = 1e-5):
    """n float32 rays (o [n, 3], d [n, 3]) along the tangent planes of the
    ellipsoids of an object-space table: at a random surface point of a
    random sphere each, d a random unit tangent there, o a distance in
    ``dist`` back along it, moved off the surface along its normal by up
    to ``jitter`` of that distance either way."""
    g = np.random.default_rng(seed)
    tab = np.asarray(table16, np.float64)[:num_spheres]
    x, nrm = _surface(tab[g.integers(0, num_spheres, n)],
                      _directions(g, (n,)))
    v = _directions(g, (n,))
    d = v - (v * nrm).sum(1, keepdims=True) * nrm
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    far = g.uniform(*dist, n)[:, None]
    o = x - far * d + g.uniform(-jitter, jitter, (n, 1)) * far * nrm
    return o.astype(np.float32), d.astype(np.float32)


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
