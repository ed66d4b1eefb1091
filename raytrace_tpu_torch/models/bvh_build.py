"""Instance motion and soup permutation on the host (numpy).

The two helpers of the JAX package's ``models/bvh_build.py`` that the port
calls: object-to-world matrices of every instance at a shutter time, used
by the sphere ordering at compile time, the per-batch world sphere tables
and the paged soup's order; and ``permute_soup``, which puts the soup in
that order.  The SAH and implicit BVH builders of that module are not
ported yet (ROADMAP queue 1, "SAH BVH").
"""

from __future__ import annotations

import copy

import numpy as np

from .transform import quat_slerp, quat_to_mat3


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


def permute_soup(cs, order: np.ndarray):
    """A copy of ``cs`` whose triangle soup is reordered: row i of every
    per-triangle array (and of the triangles' shading rows) is row
    ``order[i]`` of ``cs``'s, or zeros (a degenerate triangle) where
    ``order[i]`` is -1 (raytrace_tpu/models/bvh_build.py:224).  ``order``
    may cover the whole padded soup, padding rows included, as the
    Renderer's paged order does.  Unlike the JAX package's copy, the
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
