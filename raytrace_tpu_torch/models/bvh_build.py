"""Host-side BVH construction and soup permutation (numpy)
(raytrace_tpu/models/bvh_build.py).

One flat BVH over the instance-flattened world-space triangle soup, whose
boxes bound each triangle over the whole shutter interval (9 samples,
inflated), so a moving soup keeps its tree and only its world triangles
are rebuilt each batch.  Two builders, as in the JAX package:

- ``build_bvh_sah``: the binned-SAH tree of the native builder
  (``bvh_native``, the port's copy of native/bvh_builder.cc), explicit
  child links in each node row;
- ``build_bvh``: the implicit Morton heap over leaves of ``leaf_size``,
  the fallback where the native library cannot be built.

Both return a ``BVHData`` whose ``order`` ``permute_soup`` applies to the
soup; ops/bvh.node_rows turns either into the rows the walk reads.  Also
the object-to-world matrices of every instance at a shutter time, used by
the sphere ordering at compile time, the per-batch world sphere tables and
the paged soup's order.
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .transform import quat_slerp, quat_to_mat3

log = logging.getLogger(__name__)

BIG = np.float32(3.0e38)


@dataclass
class BVHData:
    """A host-built BVH (raytrace_tpu/models/bvh_build.py:33-53).
    ``order`` maps a row of the permuted soup to its row in the compiled
    soup (-1 for padding); apply it with ``permute_soup``.

    Two layouts share the [N, 16] node-row format:
    - mode "implicit": Morton-ordered complete binary tree; children of
      heap node i are 2i+1 / 2i+2, leaves are fixed runs of ``leaf_size``
      rows;
    - mode "sah": binned-SAH tree from the native builder; rows carry
      explicit child links bitcast into float slots 12/13 (negative link =
      leaf encoding -(1 + (first << 5 | count)), count <= leaf_size).
    """

    order: np.ndarray        # [T_padded] permutation (incl. padding rows)
    child_boxes: np.ndarray  # [N, 16]
    num_leaves: int          # K (power of two; implicit mode only)
    leaf_size: int           # L / leaf_max
    depth: int               # tree depth (root=0); stack bound for traversal
    mode: str = "implicit"
    root: int = 0            # sah root link


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v.astype(np.uint64) & np.uint64(0x3FF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
    return v


def morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """30-bit Morton code from [0,1]^3 coordinates."""
    def q(c):
        return np.clip(c * 1024.0, 0, 1023).astype(np.uint64)
    return ((_expand_bits(q(x)) << np.uint64(2))
            | (_expand_bits(q(y)) << np.uint64(1)) | _expand_bits(q(z)))


def _instance_matrix_at(inst_t0: np.ndarray, inst_t1: np.ndarray, t: float) -> np.ndarray:
    """[I,10] TRS pairs → [I,3,4] object-to-world at time t (host mirror of
    ops/transforms.interpolate_instances).  Each distinct (t0, t1) pair,
    compared by its bytes, is computed once: the same operations on the
    same inputs, so the result is the per-instance loop's, bit for bit,
    while a scene of 16,384 untransformed instances costs one."""
    pairs = np.ascontiguousarray(np.concatenate([inst_t0, inst_t1], axis=1))
    keys = pairs.view(np.dtype((np.void, pairs.dtype.itemsize
                                * pairs.shape[1])))[:, 0]
    _, first, inverse = np.unique(keys, return_index=True,
                                  return_inverse=True)
    out = np.zeros((len(first), 3, 4), np.float64)
    for u, i in enumerate(first):
        tr = (1 - t) * inst_t0[i, 0:3] + t * inst_t1[i, 0:3]
        q = quat_slerp(inst_t0[i, 3:7], inst_t1[i, 3:7], t)
        sc = (1 - t) * inst_t0[i, 7:10] + t * inst_t1[i, 7:10]
        m = quat_to_mat3(q) * sc[None, :]
        out[u, :, :3] = m
        out[u, :, 3] = tr
    return out[inverse.reshape(-1)]


def world_triangle_bounds(cs, time_samples: int = 9,
                          inflate: float = 1e-4):
    """Per-soup-row world AABBs, conservative over the shutter interval
    (raytrace_tpu/models/bvh_build.py:87-117): a static scene takes one
    sample, a moving one ``time_samples``, each box then widened by
    ``inflate`` of its diagonal (at least 1e-3) against the bulge of a
    slerp between samples.  Padding rows get empty boxes (min = +BIG,
    max = -BIG)."""
    T = cs.tri_p.shape[0]
    mn = np.full((T, 3), BIG, np.float32)
    mx = np.full((T, 3), -BIG, np.float32)

    times = np.linspace(0.0, 1.0, time_samples) if cs.any_animated else [0.0]
    n = cs.num_triangles
    tp = cs.tri_p[:n].astype(np.float64)          # [n,3,3] object space
    inst = cs.tri_inst[:n]

    for t in times:
        mats = _instance_matrix_at(cs.inst_t0, cs.inst_t1, float(t))
        m = mats[inst]                              # [n,3,4]
        wp = np.einsum("tij,tvj->tvi", m[:, :, :3], tp) + m[:, None, :, 3]
        mn[:n] = np.minimum(mn[:n], wp.min(axis=1).astype(np.float32))
        mx[:n] = np.maximum(mx[:n], wp.max(axis=1).astype(np.float32))

    if cs.any_animated and len(times) > 1:
        diag = (mx[:n] - mn[:n])
        pad = inflate * np.maximum(diag, 1e-3)
        mn[:n] -= pad
        mx[:n] += pad
    return mn, mx


def build_bvh(cs, leaf_size: int = 4, time_samples: int = 9) -> BVHData:
    """The implicit tree (raytrace_tpu/models/bvh_build.py:120-182): the
    real triangles in the Morton order of their box centres, K (a power
    of two) leaves of ``leaf_size`` rows, padding slots marked -1, and one
    row an internal heap node holding both children's boxes."""
    mn, mx = world_triangle_bounds(cs, time_samples=time_samples)
    n = cs.num_triangles

    c = 0.5 * (mn[:n] + mx[:n])
    lo = c.min(axis=0)
    hi = c.max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)
    codes = morton3(*((c - lo) / ext).T)
    order_real = np.argsort(codes, kind="stable").astype(np.int64)

    L = leaf_size
    K_needed = -(-n // L)
    K = 1 << max(0, (K_needed - 1).bit_length())  # next power of two, >= 1
    total = K * L

    order = np.full(total, -1, np.int64)
    order[:n] = order_real

    smn = np.concatenate([mn[order_real],
                          np.full((total - n, 3), BIG, np.float32)])
    smx = np.concatenate([mx[order_real],
                          np.full((total - n, 3), -BIG, np.float32)])

    leaf_mn = smn.reshape(K, L, 3).min(axis=1)
    leaf_mx = smx.reshape(K, L, 3).max(axis=1)

    # Bottom-up union over the implicit tree: boxes[i], i in [0, 2K-1).
    node_mn = np.full((2 * K - 1, 3), BIG, np.float32)
    node_mx = np.full((2 * K - 1, 3), -BIG, np.float32)
    node_mn[K - 1:] = leaf_mn
    node_mx[K - 1:] = leaf_mx
    level_start = K - 1
    while level_start > 0:
        parent_start = (level_start - 1) // 2
        n_parents = level_start - parent_start
        c0 = np.arange(n_parents) * 2 + level_start
        node_mn[parent_start:level_start] = np.minimum(node_mn[c0],
                                                       node_mn[c0 + 1])
        node_mx[parent_start:level_start] = np.maximum(node_mx[c0],
                                                       node_mx[c0 + 1])
        level_start = parent_start

    if K > 1:
        i = np.arange(K - 1)
        child_boxes = np.zeros((K - 1, 16), np.float32)
        child_boxes[:, 0:3] = node_mn[2 * i + 1]
        child_boxes[:, 3:6] = node_mx[2 * i + 1]
        child_boxes[:, 6:9] = node_mn[2 * i + 2]
        child_boxes[:, 9:12] = node_mx[2 * i + 2]
    else:
        child_boxes = np.zeros((0, 16), np.float32)

    return BVHData(
        order=order.astype(np.int32),
        child_boxes=child_boxes,
        num_leaves=K,
        leaf_size=L,
        depth=int(np.log2(K)) if K > 1 else 0,
    )


def build_bvh_sah(cs, leaf_max: int = 8,
                  time_samples: int = 9) -> Optional[BVHData]:
    """The binned-SAH tree of the native builder over the
    shutter-conservative world boxes (raytrace_tpu/models/bvh_build.py:
    185-221), the order padded with -1 to a multiple of 256 rows, and one
    zero row for a single-leaf scene (a negative root link).  Returns None,
    with a warning naming the error, where the native library cannot be
    built; the caller then takes ``build_bvh``."""
    from . import bvh_native

    mn, mx = world_triangle_bounds(cs, time_samples=time_samples)
    n = cs.num_triangles
    out = bvh_native.build_sah_bvh(mn[:n], mx[:n], leaf_max=leaf_max)
    if out is None:
        log.warning("the native SAH BVH builder is unavailable (%s); the "
                    "implicit BVH is built instead", bvh_native.error())
        return None
    rows, order_real, root, depth = out
    if rows.shape[0] == 0:  # single-leaf scene: no internal nodes
        rows = np.zeros((1, 16), np.float32)

    total = max(256, -(-n // 256) * 256)
    order = np.full(total, -1, np.int64)
    order[:n] = order_real
    return BVHData(order=order, child_boxes=rows, num_leaves=0,
                   leaf_size=leaf_max, depth=depth, mode="sah", root=root)


def permute_soup(cs, order: np.ndarray):
    """A copy of ``cs`` whose triangle soup is reordered: row i of every
    per-triangle array (and of the triangles' shading rows) is row
    ``order[i]`` of ``cs``'s, or zeros (a degenerate triangle) where
    ``order[i]`` is -1 (raytrace_tpu/models/bvh_build.py:224).  ``order``
    may cover the whole padded soup, padding rows included, as the
    Renderer's paged order does, or be a ``BVHData.order``, whose length
    (a multiple of 256, or the implicit tree's leaves times their size)
    becomes the soup's.  Unlike the JAX package's copy, the
    per-mesh soup offsets and the triangle cluster size are dropped: after
    a permutation they delimit nothing."""
    order = np.asarray(order, np.int64)
    pad = order < 0
    src = np.clip(order, 0, cs.tri_p.shape[0] - 1)

    def take(a):
        out = a[src]
        out[pad] = 0
        return out

    out = copy.copy(cs)
    for name in ("tri_p", "tri_n", "tri_uv", "tri_inst", "tri_mat_type",
                 "tri_mat_index"):
        setattr(out, name, take(getattr(cs, name)))
    if cs.shade_rows is not None:
        s_pad = cs.sph_center.shape[0]
        out.shade_rows = np.concatenate([cs.shade_rows[:s_pad],
                                         take(cs.shade_rows[s_pad:])])
    out.mesh_tri_offsets = None
    out.tri_cluster_g = 0
    return out
