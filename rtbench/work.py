"""The least work of a render, counted from its inputs and its rays, and
the card's peaks: the yardstick of the fused kernel's roofline share and
of the whole step's share of the chip.

The count depends only on the scene document, the frame, the samples
rendered and the rays traced, never on how the program finds a hit: no
tree, leaf or walk enters it.  Each constant is the FP32 operations of
one part of a path as the renderer's algorithm states it (ray_gen.glsl;
the reference in reference/pathtracer.py computes the same steps),
counting an add, a multiply, a divide, a square root, a sine or a cosine
as one operation each, with no fused multiply-add:

- a camera ray (a sample's first ray, counted once a sample): two
  stratified draws and the sub-pixel offset (8), NDC (4), the inverse
  projection of (u, v, 1, 1) (15), a normalisation (9), the view rotation
  (15); with a thin lens the disk sample (14), the origin's offset (4),
  the focal point (18) and the new direction's normalisation (12);
- the one test of a ray against the primitive it hits: a sphere's
  quadratic (25), or a triangle's Moller-Trumbore test (45);
- the shading of a hit by the cheapest material (lambertian): the hit
  point (6), the front-face test (5), a cosine-weighted direction from
  two draws in an orthonormal frame (50), the throughput (3); a sphere
  hit's normal (6);
- on a scene with lights, the light sample of a lambertian hit: the
  triangle and its point from three draws (19), the direction, its
  length and normalisation (17), the two pdfs, their mixture and the
  weight (18);
- each pixel's running mean, once a batch (9).

A path ends on a miss (its last ray hits nothing), on absorption or at
the depth limit, so at least rays - samples rays hit something, and at
least rays - 2 * samples hit a lambertian surface in a lit scene (a path
hits a light at most once, and ends there).  A miss is counted as no
work.  Bytes: every scene table read once (a sphere 16 B, a triangle
36 B, a material 16 B, a light triangle 36 B) and the image written once
a batch (12 B a pixel).
"""

from __future__ import annotations

from dataclasses import dataclass

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): FP32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

CAMERA_RAY = 51
THIN_LENS = 48
SPHERE_TEST = 25
TRIANGLE_TEST = 45
SHADE_LAMBERTIAN = 64
SPHERE_NORMAL = 6
LIGHT_SAMPLE = 54
RUNNING_MEAN = 9

SPHERE_BYTES, TRIANGLE_BYTES, MATERIAL_BYTES = 16, 36, 16
PIXEL_BYTES = 12

_TRIANGLES_OF = {"triangle": 1, "quad": 2, "box": 12}


def triangles_of(kind: str, body: dict) -> int:
    """The triangles of one primitive of the scene document.  A uv_sphere
    tessellates (mesh.rs) into a fan of ``segments`` at each pole and two
    triangles a segment on each of the ``rings`` - 2 bands between."""
    if kind == "uv_sphere":
        return 2 * int(body["segments"]) * (int(body["rings"]) - 1)
    if kind not in _TRIANGLES_OF:
        raise ValueError(f"the work count cannot count a {kind!r} primitive "
                         f"({body.get('name')!r})")
    return _TRIANGLES_OF[kind]


@dataclass(frozen=True)
class SceneFacts:
    """What the count needs of a scene document and its frame."""
    spheres: int
    triangles: int
    materials: int
    light_triangles: int
    thin_lens: bool
    pixels: int

    @classmethod
    def of(cls, doc: dict, width: int, height: int,
           mesh_geometry: bool = False) -> "SceneFacts":
        """The facts of ``doc`` at ``width`` x ``height``.  A uv_sphere
        instance is one sphere, or with ``mesh_geometry`` (the scene
        compiled as the CLI's ``--mesh-geometry`` compiles it) the
        triangles of its tessellation."""
        prims = {}
        for p in doc["primitives"]:
            kind = next(iter(p))
            prims[p[kind]["name"]] = (kind, p[kind])
        lights = {m[k]["name"] for m in doc["materials"] for k in m
                  if k == "diffuse_light"}
        spheres = triangles = light_tris = 0
        for inst in doc["instances"]:
            kind, body = prims[inst["name"]]
            if kind == "uv_sphere" and not mesh_geometry:
                spheres += 1
                continue
            n = triangles_of(kind, body)
            triangles += n
            if body["material"] in lights:
                light_tris += n
        render = doc["render"]
        cam = next(c[next(iter(c))] for c in doc["cameras"]
                   if c[next(iter(c))]["name"] == render["camera"])
        return cls(spheres, triangles, len(doc["materials"]), light_tris,
                   float(cam.get("aperture_size") or 0.0) > 0.0,
                   width * height)


def operations(facts: SceneFacts, samples: int, rays: int,
               batches: int) -> int:
    """FP32 operations that ``batches`` batches of ``samples``
    pixel-samples in all, ``rays`` rays traced, need at the least."""
    hits = max(0, rays - samples)
    # The cheaper test where a scene has both kinds of primitive.
    test = min(([SPHERE_TEST] if facts.spheres else [])
               + ([TRIANGLE_TEST] if facts.triangles else []) or [0])
    normal = SPHERE_NORMAL if not facts.triangles else 0
    ops = samples * (CAMERA_RAY + (THIN_LENS if facts.thin_lens else 0))
    ops += hits * (test + SHADE_LAMBERTIAN + normal)
    if facts.light_triangles:
        ops += max(0, rays - 2 * samples) * LIGHT_SAMPLE
    return ops + batches * facts.pixels * RUNNING_MEAN


def bytes_moved(facts: SceneFacts, batches: int) -> int:
    tables = (facts.spheres * SPHERE_BYTES + facts.triangles * TRIANGLE_BYTES
              + facts.materials * MATERIAL_BYTES
              + facts.light_triangles * TRIANGLE_BYTES)
    return tables + batches * facts.pixels * PIXEL_BYTES


def least_seconds(facts: SceneFacts, samples: int, rays: int,
                  batches: int) -> float:
    """The least time one card could take: the larger of the operations
    over the FP32 peak and the bytes over the HBM peak."""
    return max(operations(facts, samples, rays, batches) / PEAK_FP32_FLOPS,
               bytes_moved(facts, batches) / PEAK_HBM_BYTES_PER_S)
