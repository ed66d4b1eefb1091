"""Per-primitive pre-resolved shading rows.

The reference resolves material/texture indirections per hit on the GPU
(mesh -> material type/index -> texture property -> registry lookup,
ray_gen.glsl:116-243).  Doing that per ray on TPU costs ~25 small random
row-gathers per bounce — the dominant cost of the whole renderer (XLA
gathers cap at ~0.4G rows/s).  Instead the scene compiler flattens every
indirection into ONE 32-float row per primitive; at shade time the row is
fetched with a single one-hot matmul on the MXU (small scenes) or a single
row gather (large meshes).

Row layout (f32):
  0: mat_type            1: refraction index
  2-4: albedo rgb        5-7: fuzz rgb          8-10: emit rgb
  11: albedo mode        12: albedo aux
  13: fuzz mode          14: fuzz aux
  15: emit mode          16: emit aux
  17: checker scale      18-20: checker even rgb  21-23: checker odd rgb
  24: ck even mode       25: ck even aux
  26: ck odd mode        27: ck odd aux
  28-31: pad
Modes: 0 = resolved constant rgb, 1 = image (aux = image index),
2 = checker (aux = checker index), 3 = noise (aux = noise SCALE, baked).

Scenes whose materials exceed this encoding (textured fuzz, checker on a
non-albedo property, checker both on albedo and emit) fall back to the
general registry path — none of the reference's shipped scenes do.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .compile import (
    MAT_PROP_CHECKER,
    MAT_PROP_IMAGE,
    MAT_PROP_NOISE,
    MAT_PROP_RGB,
    MAT_TYPE_DIELECTRIC,
    MAT_TYPE_DIFFUSE_LIGHT,
    MAT_TYPE_LAMBERTIAN,
    MAT_TYPE_METAL,
)

F = 32  # row width

MODE_CONST = 0.0
MODE_IMAGE = 1.0
MODE_CHECKER = 2.0
MODE_NOISE = 3.0


class ComplexMaterial(Exception):
    """Material graph doesn't fit the fat-row encoding; caller falls back."""


def _resolve_basic(ptype: int, pidx: int, tex) -> Tuple[float, float, np.ndarray]:
    """(mode, aux, rgb) for a basic (non-checker) property."""
    if ptype == MAT_PROP_RGB:
        return MODE_CONST, 0.0, tex["const_colours"][pidx]
    if ptype == MAT_PROP_IMAGE:
        return MODE_IMAGE, float(pidx), np.zeros(3, np.float32)
    if ptype == MAT_PROP_NOISE:
        return MODE_NOISE, float(tex["noise_scale"][pidx]), np.zeros(3, np.float32)
    raise ComplexMaterial(f"nested non-basic property type {ptype}")


def _fill_property(row, ptype: int, pidx: int, tex, rgb_at: int, mode_at: int,
                   aux_at: int, allow_checker: bool) -> None:
    if ptype == MAT_PROP_CHECKER:
        if not allow_checker:
            raise ComplexMaterial("checker on a non-albedo property")
        if row[17] != 0.0:
            raise ComplexMaterial("two checker properties on one material")
        row[mode_at] = MODE_CHECKER
        row[aux_at] = float(pidx)
        row[17] = tex["checker_scale"][pidx]
        em, ea, ergb = _resolve_basic(*tex["checker_even"][pidx], tex)
        om, oa, orgb = _resolve_basic(*tex["checker_odd"][pidx], tex)
        row[18:21] = ergb
        row[21:24] = orgb
        row[24], row[25] = em, ea
        row[26], row[27] = om, oa
        return
    mode, aux, rgb = _resolve_basic(ptype, pidx, tex)
    row[mode_at] = mode
    row[aux_at] = aux
    row[rgb_at:rgb_at + 3] = rgb


def build_shading_rows(mat_types: np.ndarray, mat_indices: np.ndarray,
                       mats: dict, tex: dict) -> np.ndarray:
    """[N] material (type, index) pairs -> [N, 32] fat rows.

    Raises ComplexMaterial when the encoding doesn't fit.
    """
    n = len(mat_types)
    rows = np.zeros((n, F), np.float32)
    cache = {}
    for i in range(n):
        key = (int(mat_types[i]), int(mat_indices[i]))
        if key in cache:
            rows[i] = cache[key]
            continue
        row = np.zeros(F, np.float32)
        mt, mi = key
        row[0] = mt
        if mt == MAT_TYPE_LAMBERTIAN:
            pt, pi = mats["lamb_albedo"][mi]
            _fill_property(row, pt, pi, tex, 2, 11, 12, allow_checker=True)
        elif mt == MAT_TYPE_METAL:
            pt, pi = mats["metal_albedo"][mi]
            _fill_property(row, pt, pi, tex, 2, 11, 12, allow_checker=True)
            ft, fi = mats["metal_fuzz"][mi]
            if ft != MAT_PROP_RGB:
                raise ComplexMaterial("non-constant metal fuzz")
            _fill_property(row, ft, fi, tex, 5, 13, 14, allow_checker=False)
        elif mt == MAT_TYPE_DIELECTRIC:
            row[1] = mats["diel_ri"][mi]
        elif mt == MAT_TYPE_DIFFUSE_LIGHT:
            et, ei = mats["light_emit"][mi]
            if et == MAT_PROP_CHECKER:
                _fill_property(row, et, ei, tex, 8, 15, 16, allow_checker=True)
            else:
                _fill_property(row, et, ei, tex, 8, 15, 16, allow_checker=False)
        cache[key] = row
        rows[i] = row
    return rows
