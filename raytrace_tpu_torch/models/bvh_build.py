"""Instance motion on the host (numpy).

The one helper of the JAX package's ``models/bvh_build.py`` that the port
calls: object-to-world matrices of every instance at a shutter time, used
by the sphere ordering at compile time and by the per-batch world sphere
tables.  The SAH and native BVH builders of that module are not ported yet
(ROADMAP queue 1, "Big meshes").
"""

from __future__ import annotations

import numpy as np

from .transform import quat_slerp, quat_to_mat3


def _instance_matrix_at(inst_t0: np.ndarray, inst_t1: np.ndarray, t: float) -> np.ndarray:
    """[I,10] TRS pairs → [I,3,4] object-to-world at time t (host mirror of
    ops/transforms.interpolate_instances)."""
    I = inst_t0.shape[0]
    out = np.zeros((I, 3, 4), np.float64)
    for i in range(I):
        tr = (1 - t) * inst_t0[i, 0:3] + t * inst_t1[i, 0:3]
        q = quat_slerp(inst_t0[i, 3:7], inst_t1[i, 3:7], t)
        sc = (1 - t) * inst_t0[i, 7:10] + t * inst_t1[i, 7:10]
        m = quat_to_mat3(q) * sc[None, :]
        out[i, :, :3] = m
        out[i, :, 3] = tr
    return out
