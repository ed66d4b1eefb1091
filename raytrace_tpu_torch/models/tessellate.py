"""Primitive tessellation to triangle meshes (reference: raytracer/src/mesh.rs).

All tessellators produce the same vertex/index streams as the reference so
renders are geometrically identical:

- uv_sphere  (mesh.rs:155-258): latitude/longitude sphere with single-triangle
  fans at both poles; pole rows have ``segments`` vertices (one less than
  interior rows) and their u coordinates are shifted by du/2.
- triangle   (mesh.rs:98-116):  3 vertices, given normal/uv per point.
- quad       (mesh.rs:118-136): 4 vertices, two triangles [0,1,2],[0,2,3].
- box        (mesh.rs:277-362): 24 vertices (4 per face), 12 triangles, with
  a 4x3 cross UV layout per face.  NOTE the world is y-down: the "top" face
  normal is (0,-1,0).
- obj_mesh:  Wavefront OBJ import (reference obj_loader.rs semantics incl.
  V-flip of texture coordinates), implemented as a first-class primitive.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..scene_file import primitive as prim_schema


@dataclass
class Mesh:
    """A tessellated primitive: SoA vertex arrays + triangle indices."""

    name: str
    positions: np.ndarray  # [V, 3] f32
    normals: np.ndarray    # [V, 3] f32
    uvs: np.ndarray        # [V, 2] f32
    indices: np.ndarray    # [3*T]  i32
    material: str          # material name, resolved at compile time

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0] // 3)

    def triangles(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-triangle [T,3,3] positions, [T,3,3] normals, [T,3,2] uvs."""
        idx = self.indices.reshape(-1, 3)
        return self.positions[idx], self.normals[idx], self.uvs[idx]


def generate_triangle(points, normal, uv) -> Tuple[np.ndarray, ...]:
    p = np.asarray(points, dtype=np.float32).reshape(3, 3)
    n = np.tile(np.asarray(normal, dtype=np.float32), (3, 1))
    t = np.asarray(uv, dtype=np.float32).reshape(3, 2)
    idx = np.array([0, 1, 2], dtype=np.int32)
    return p, n, t, idx


def generate_quad(points, normal, uv) -> Tuple[np.ndarray, ...]:
    p = np.asarray(points, dtype=np.float32).reshape(4, 3)
    n = np.tile(np.asarray(normal, dtype=np.float32), (4, 1))
    t = np.asarray(uv, dtype=np.float32).reshape(4, 2)
    idx = np.array([0, 1, 2, 0, 2, 3], dtype=np.int32)
    return p, n, t, idx


def generate_uv_sphere(center, radius: float, rings: int, segments: int):
    """UV sphere matching mesh.rs:155-258 vertex-for-vertex.

    Rows r = 0..=rings; pole rows (r==0, r==rings) have ``segments`` vertices
    with u shifted by du/2, interior rows have ``segments+1``.  Normals point
    outward as (-sin(phi)cos(theta), -cos(phi), sin(phi)sin(theta)) — the
    y-down convention of the reference.
    """
    center = np.asarray(center, dtype=np.float64)
    du = 1.0 / segments
    dv = 1.0 / rings

    pos_rows, nrm_rows, uv_rows = [], [], []
    for r in range(rings + 1):
        top_or_bot = r == 0 or r == rings
        count = segments if top_or_bot else segments + 1
        s = np.arange(count, dtype=np.float64)
        shift_u = du / 2.0 if top_or_bot else 0.0
        u = s * du + shift_u
        v = np.full(count, r * dv)
        theta = 2.0 * math.pi * u
        phi = math.pi * v
        n = np.stack(
            [-np.sin(phi) * np.cos(theta), -np.cos(phi), np.sin(phi) * np.sin(theta)],
            axis=-1,
        )
        pos_rows.append(center + radius * n)
        nrm_rows.append(n)
        uv_rows.append(np.stack([u, v], axis=-1))

    positions = np.concatenate(pos_rows).astype(np.float32)
    normals = np.concatenate(nrm_rows).astype(np.float32)
    uvs = np.concatenate(uv_rows).astype(np.float32)

    # Index generation exactly as mesh.rs:201-234.
    indices = []
    o1 = 0
    o2 = segments
    for r in range(rings):
        for s in range(segments):
            if r == 0:
                indices += [o1 + s, o2 + s, o2 + s + 1]
            elif 0 < r < rings - 1:
                indices += [o1 + s, o2 + s, o2 + s + 1]
                indices += [o1 + s + 1, o1 + s, o2 + s + 1]
            else:  # r == rings - 1: bottom fan
                indices += [o1 + s + 1, o1 + s, o2 + s]
        o1 += segments if r == 0 else segments + 1
        o2 = o1 + segments + 1

    return positions, normals, uvs, np.asarray(indices, dtype=np.int32)


def _uv_rect(col: int, row: int, cols: int, rows: int):
    """4x3-cross UV cell, V flipped so 0 is at the top (mesh.rs:260-275)."""
    cell_w = 1.0 / cols
    cell_h = 1.0 / rows
    u0 = col * cell_w
    v0 = 1.0 - (row + 1) * cell_h
    u1 = u0 + cell_w
    v1 = v0 + cell_h
    return [(u0, v1), (u1, v1), (u1, v0), (u0, v0)]  # BL BR TR TL


def generate_box(corners):
    """Axis-aligned box from any two opposite corners (mesh.rs:277-362)."""
    a = np.asarray(corners[0], dtype=np.float32)
    b = np.asarray(corners[1], dtype=np.float32)
    lx, ly, lz = np.minimum(a, b)
    hx, hy, hz = np.maximum(a, b)

    uv_front = _uv_rect(1, 1, 4, 3)
    uv_back = _uv_rect(3, 1, 4, 3)
    uv_left = _uv_rect(0, 1, 4, 3)
    uv_right = _uv_rect(2, 1, 4, 3)
    uv_top = _uv_rect(1, 0, 4, 3)
    uv_bottom = _uv_rect(1, 2, 4, 3)

    V = lambda p, n, t: (p, n, t)
    verts = [
        # Front (+Z)
        V((lx, ly, hz), (0, 0, 1), uv_front[0]),
        V((hx, ly, hz), (0, 0, 1), uv_front[1]),
        V((hx, hy, hz), (0, 0, 1), uv_front[2]),
        V((lx, hy, hz), (0, 0, 1), uv_front[3]),
        # Back (-Z)
        V((hx, ly, lz), (0, 0, -1), uv_back[0]),
        V((lx, ly, lz), (0, 0, -1), uv_back[1]),
        V((lx, hy, lz), (0, 0, -1), uv_back[2]),
        V((hx, hy, lz), (0, 0, -1), uv_back[3]),
        # Left (-X)
        V((lx, ly, lz), (-1, 0, 0), uv_left[0]),
        V((lx, ly, hz), (-1, 0, 0), uv_left[1]),
        V((lx, hy, hz), (-1, 0, 0), uv_left[2]),
        V((lx, hy, lz), (-1, 0, 0), uv_left[3]),
        # Right (+X)
        V((hx, ly, hz), (1, 0, 0), uv_right[0]),
        V((hx, ly, lz), (1, 0, 0), uv_right[1]),
        V((hx, hy, lz), (1, 0, 0), uv_right[2]),
        V((hx, hy, hz), (1, 0, 0), uv_right[3]),
        # Top (-Y) — y-down world
        V((lx, hy, hz), (0, -1, 0), uv_top[0]),
        V((hx, hy, hz), (0, -1, 0), uv_top[1]),
        V((hx, hy, lz), (0, -1, 0), uv_top[2]),
        V((lx, hy, lz), (0, -1, 0), uv_top[3]),
        # Bottom (+Y)
        V((lx, ly, lz), (0, 1, 0), uv_bottom[0]),
        V((hx, ly, lz), (0, 1, 0), uv_bottom[1]),
        V((hx, ly, hz), (0, 1, 0), uv_bottom[2]),
        V((lx, ly, hz), (0, 1, 0), uv_bottom[3]),
    ]
    positions = np.array([v[0] for v in verts], dtype=np.float32)
    normals = np.array([v[1] for v in verts], dtype=np.float32)
    uvs = np.array([v[2] for v in verts], dtype=np.float32)
    indices = np.array(
        [0, 1, 2, 2, 3, 0,
         4, 5, 6, 6, 7, 4,
         8, 9, 10, 10, 11, 8,
         12, 13, 14, 14, 15, 12,
         16, 17, 18, 18, 19, 16,
         20, 21, 22, 22, 23, 20],
        dtype=np.int32,
    )
    return positions, normals, uvs, indices


def load_obj(path: str):
    """Minimal Wavefront OBJ import (v/vn/vt/f), following the reference
    loader's semantics (obj_loader.rs): triangulate fans, flip V (1 - v),
    one flat vertex per face corner.  Polygonal faces are fan-triangulated.
    """
    raw_v, raw_vt, raw_vn = [], [], []
    face_corners = []  # list of triangles of (vi, ti, ni)

    def parse_index(token, count):
        i = int(token)
        return i - 1 if i > 0 else count + i

    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                raw_v.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                raw_vt.append([float(x) for x in parts[1:3]])
            elif tag == "vn":
                raw_vn.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    comp = tok.split("/")
                    vi = parse_index(comp[0], len(raw_v))
                    ti = parse_index(comp[1], len(raw_vt)) if len(comp) > 1 and comp[1] else -1
                    ni = parse_index(comp[2], len(raw_vn)) if len(comp) > 2 and comp[2] else -1
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):
                    face_corners += [corners[0], corners[k], corners[k + 1]]

    raw_v = np.asarray(raw_v, dtype=np.float32).reshape(-1, 3)
    raw_vt = np.asarray(raw_vt, dtype=np.float32).reshape(-1, 2)
    raw_vn = np.asarray(raw_vn, dtype=np.float32).reshape(-1, 3)

    n_corners = len(face_corners)
    positions = np.zeros((n_corners, 3), dtype=np.float32)
    normals = np.zeros((n_corners, 3), dtype=np.float32)
    uvs = np.zeros((n_corners, 2), dtype=np.float32)
    for i, (vi, ti, ni) in enumerate(face_corners):
        positions[i] = raw_v[vi]
        if ni >= 0:
            normals[i] = raw_vn[ni]
        if ti >= 0:
            uvs[i] = [raw_vt[ti, 0], 1.0 - raw_vt[ti, 1]]  # V flip (obj_loader.rs:26)

    # Faces without normals get flat geometric normals.
    for t in range(n_corners // 3):
        tri = normals[3 * t: 3 * t + 3]
        if not tri.any():
            p = positions[3 * t: 3 * t + 3]
            gn = np.cross(p[1] - p[0], p[2] - p[0])
            norm = np.linalg.norm(gn)
            if norm > 0:
                gn = gn / norm
            normals[3 * t: 3 * t + 3] = gn

    indices = np.arange(n_corners, dtype=np.int32)
    return positions, normals, uvs, indices


def mesh_from_primitive(prim) -> Mesh:
    """Tessellate a scene_file primitive into a Mesh (mesh.rs:78-153)."""
    if isinstance(prim, prim_schema.UvSphere):
        p, n, t, idx = generate_uv_sphere(prim.center, prim.radius, prim.rings, prim.segments)
    elif isinstance(prim, prim_schema.Triangle):
        p, n, t, idx = generate_triangle(prim.points, prim.normal, prim.uv)
    elif isinstance(prim, prim_schema.Quad):
        p, n, t, idx = generate_quad(prim.points, prim.normal, prim.uv)
    elif isinstance(prim, prim_schema.Box):
        p, n, t, idx = generate_box(prim.corners)
    elif isinstance(prim, prim_schema.ObjMesh):
        p, n, t, idx = load_obj(prim.path)
    else:
        raise TypeError(f"Unknown primitive type: {type(prim)!r}")
    return Mesh(
        name=prim.name, positions=p, normals=n, uvs=t, indices=idx, material=prim.material
    )
