"""Spatial sphere ordering for the cluster-selective sweep.

The megakernel's sub-linear sphere path (ops/megakernel._sweep_selective)
sweeps a small "global" prefix densely, then traverses tight fixed-size
clusters of the remaining spheres per lane, nearest-first.  Cluster
tightness is what makes the pruning work, so compile_scene reorders the
sphere block:

  [ global prefix: spheres too large to cluster, original order ]
  [ local spheres in greedy nearest-neighbour groups of G, groups  ]
  [ emitted in isotropic-Morton order of their centroids           ]

The role matches the reference's driver-built BVH over sphere BLASes
(acceleration.rs:37-80) — proximity in the table replaces proximity in a
tree.  The permutation is image-invariant: sphere ids are internal, every
per-sphere array (tables, shading rows, instance ids) is permuted
consistently.
"""

from __future__ import annotations

import numpy as np


def _morton3(q: np.ndarray) -> np.ndarray:
    """[N,3] uint32 coords (10 bits each) -> interleaved Morton codes."""

    def spread(x):
        x = x.astype(np.uint64) & np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x30000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x9249249)
        return x

    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def sphere_cluster_order(centers, radii, insts, inst_t0, inst_t1,
                         num_spheres: int, big_factor: float = 3.0):
    """Permutation + prefix split for the sphere block.

    centers/radii/insts: unpadded [n] object-space sphere data.
    Returns (perm [n] int array over the REAL spheres, n_prefix) or
    (None, 0) when ordering can't help (few spheres).
    """
    n = num_spheres
    if n < 96:
        return None, 0

    from .bvh_build import _instance_matrix_at

    mats = _instance_matrix_at(inst_t0, inst_t1, 0.5)     # [I,3,4] f64
    m = mats[np.asarray(insts[:n])]
    rot = m[:, :, :3]
    scale = np.linalg.norm(rot, axis=1)                    # [n,3] column norms
    c_w = np.einsum("sij,sj->si", rot, np.asarray(centers[:n], np.float64))
    c_w = c_w + m[:, :, 3]
    r_w = scale.max(axis=1) * np.asarray(radii[:n], np.float64)

    med = np.median(r_w)
    big = r_w > big_factor * max(med, 1e-30)
    if (~big).sum() < 64:
        return None, 0

    local = np.where(~big)[0]
    # Group at the G the TPU sweep uses by default.  The JAX package's
    # MEGA_G tuning variable is an ablation knob of that sweep and is not
    # read here: the default grouping is what it compiles without one.
    order = local[_group_order(c_w[local], r_w[local],
                               effective_cluster_g(len(local), _GROUP))]

    perm = np.concatenate([np.where(big)[0], order]).astype(np.int32)
    return perm, int(big.sum())


#: default spheres per greedy group (KernelOptions.cluster_g's default)
_GROUP = 4


def effective_cluster_g(n_local: int, g0: int = _GROUP) -> int:
    """The G the gather sweep will actually use: megakernel.make_config
    doubles cluster_g until the cluster count fits the 128-wide gather
    table.  The greedy grouping below groups at this size directly —
    measured half-surface-area 3135 vs 6656 at S=1940 (G=16) compared to
    merging four greedy-4 groups."""
    G = g0
    # Cap raised 64 -> 128 in round 4 with the 16384-sphere gate: the
    # gather table addresses 128 clusters x G spheres, so G=128 is the
    # last doubling that still fits a 16k scene (stress-bench verified
    # bitwise vs the wavefront at that size, BENCH_STRESS.json).
    while -(-n_local // G) > 128 and G < 128:
        G *= 2
    return G


def _iso_morton_codes(pts: np.ndarray) -> np.ndarray:
    """Morton codes with ISOTROPIC quantization (one scale for all axes).

    Per-axis spans stretch a thin axis (e.g. the one-weekend grid's
    y-jitter) across the full 10-bit range, so its noise dominates the
    interleave and clusters group by jitter instead of x/z proximity —
    measured 2.63 vs 2.09 mean box-pretest candidates per bounce ray."""
    q = pts - pts.min(axis=0)
    q = np.clip(q / max(float(q.max()), 1e-12) * 1023.0, 0.0, 1023.0)
    return _morton3(q.astype(np.uint32))


def _emit_groups(c_w: np.ndarray, groups: list, group: int) -> np.ndarray:
    """Emit groups in isotropic-Morton order of their centroids; the (at
    most one) partial group stays LAST: clusters are consecutive runs of
    G in the emitted order, so a short group anywhere else shifts every
    later group off its cluster boundary and re-inflates the AABBs the
    grouping exists to shrink."""
    partial = [g for g in groups if len(g) < group]
    groups = [g for g in groups if len(g) == group]
    if not groups:
        # Only a partial group (effective G > local sphere count):
        # nothing to Morton-order, and _iso_morton_codes would crash on
        # a zero-size reduction.
        return np.concatenate([np.asarray(g) for g in partial])
    gc = np.array([c_w[g].mean(axis=0) for g in groups])
    go = np.argsort(_iso_morton_codes(gc), kind="stable")
    return np.concatenate(
        [np.asarray(groups[gi]) for gi in go]
        + [np.asarray(g) for g in partial])


def _greedy_groups(c_w: np.ndarray, group: int) -> list:
    """Greedy nearest-neighbour grouping: seeds sweep ascending x; each
    group takes the seed plus its group-1 nearest unused centers.
    O(n^2/G) distance passes."""
    n = len(c_w)
    used = np.zeros(n, bool)
    groups = []
    for s in np.argsort(c_w[:, 0], kind="stable"):
        if used[s]:
            continue
        used[s] = True
        grp = [s]
        k = min(group - 1, int((~used).sum()))
        if k > 0:
            dd = np.linalg.norm(c_w - c_w[s], axis=1)
            dd[used] = np.inf
            nn = np.argpartition(dd, k - 1)[:k]
            nn = nn[np.argsort(dd[nn], kind="stable")]
            for j in nn:
                used[j] = True
                grp.append(j)
        groups.append(grp)
    return groups


def _kd_groups(c_w: np.ndarray, idx: np.ndarray, group: int) -> list:
    """k-d median bisection to leaves of exactly `group` (one short
    tail leaf): split counts stay multiples of `group`.  O(n log n)."""
    if len(idx) <= group:
        return [idx]
    pts = c_w[idx]
    ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
    order = idx[np.argsort(pts[:, ax], kind="stable")]
    half = max(group, (len(idx) // (2 * group)) * group)
    return (_kd_groups(c_w, order[:half], group)
            + _kd_groups(c_w, order[half:], group))


def _cluster_hsa(c_w, r_w, order, group: int) -> float:
    """Total half-surface-area of the consecutive-G cluster AABBs — the
    box pretest's hit probability is proportional to it."""
    n = len(order)
    C = -(-n // group)
    pad = C * group - n
    cc = np.concatenate([c_w[order], np.zeros((pad, 3))]).reshape(C, group, 3)
    rr = np.concatenate([r_w[order], np.full(pad, -1.0)]).reshape(C, group)
    valid = rr > 0
    mn = np.where(valid[..., None], cc - rr[..., None], 1e38).min(axis=1)
    mx = np.where(valid[..., None], cc + rr[..., None], -1e38).max(axis=1)
    e = mx - mn
    return float((e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2]
                  + e[:, 0] * e[:, 2]).sum())


def _group_order(c_w: np.ndarray, r_w: np.ndarray,
                 group: int = _GROUP) -> np.ndarray:
    """Best spatial grouping of world spheres into size-`group` clusters.

    Two candidate layouts, scored by total cluster-AABB half-surface-area
    (what the box pretest's candidate count is proportional to):
    greedy nearest-neighbour (wins at small G: 574 vs 582 on
    final-one-weekend, and 3x tighter than consecutive-Morton-run
    clusters' 1795 — candidates 2.63 -> 1.17/ray) and k-d median
    bisection (wins at large G: 2448 vs 3135 at S=1940 G=16, and its
    O(n log n) covers scenes past the greedy O(n^2/G) guard)."""
    cands = [_emit_groups(c_w, _kd_groups(c_w, np.arange(len(c_w)), group),
                          group)]
    if len(c_w) <= 20000:
        cands.append(_emit_groups(c_w, _greedy_groups(c_w, group), group))
    return min(cands, key=lambda o: _cluster_hsa(c_w, r_w, o, group))


#: default triangles per cluster for the tri-gather sweep; doubled until
#: the cluster count fits the 128-wide gather table (cap: effective 128,
#: i.e. 16384 triangles).
_TRI_GROUP = 16

#: triangle count below which the dense megakernel sweep stays (keeps
#: small scenes unpermuted — identical tie-breaks, identical goldens).
_TRI_MIN = 512


def effective_tri_g(n_tris: int, g0: int = _TRI_GROUP) -> int:
    """The cluster size the tri-gather sweep will use: doubled until the
    cluster count fits the 128-wide lane-gather table (cap 128)."""
    G = g0
    while -(-n_tris // G) > 128 and G < 128:
        G *= 2
    return G


def triangle_cluster_order(tri_p, insts, inst_t0, inst_t1, num_tris: int,
                           g0: int = 0):
    """Permutation + cluster size for the triangle block.

    tri_p: [T_pad, 3, 3] object-space vertices; insts: [T_pad] instance
    ids.  Returns (perm over the REAL triangles, G) or (None, 0) when
    clustering can't help (few triangles) or can't fit (too many for the
    gather table even at G=128).

    The role matches the reference's driver-built triangle BLAS
    (acceleration.rs:268-294) the same way the sphere ordering does:
    proximity in the table replaces proximity in a tree, and the
    megakernel's AABB slab pretest + per-lane gather rounds
    (ops/megakernel._sweep_tri_gather) replace the RT-core traversal of
    ray_gen.glsl:467-478.
    """
    n = num_tris
    # The defaults of the JAX package's MEGA_TRI_MIN / MEGA_TRI_G tuning
    # variables, which are not read here.
    if n < max(_TRI_MIN, 2):
        return None, 0

    if not g0:
        g0 = _TRI_GROUP
    G = effective_tri_g(n, g0)
    if -(-n // G) > 128:
        return None, 0

    from .bvh_build import _instance_matrix_at

    mats = _instance_matrix_at(inst_t0, inst_t1, 0.5)     # [I,3,4] f64
    m = mats[np.asarray(insts[:n])]
    v = np.asarray(tri_p[:n], np.float64)                  # [n,3,3]
    w = np.einsum("sij,svj->svi", m[:, :, :3], v) + m[:, None, :, 3]
    c_w = w.mean(axis=1)                                   # [n,3] centroids
    r_w = np.linalg.norm(w - c_w[:, None, :], axis=2).max(axis=1)

    return _group_order(c_w, r_w, G).astype(np.int32), G


def apply_triangle_order(cs) -> None:
    """Reorder the triangle block of a CompiledScene in place.

    Sets cs.tri_cluster_g (0 = dense order kept).  Triangle ids are
    internal, so the permutation is image-invariant up to exact-t
    tie-breaks; every per-triangle array (geometry, attributes, shading
    rows) is permuted consistently.  Skipped for small scenes so shipped
    goldens keep the file-order dense sweep bit-for-bit.
    """
    perm, G = triangle_cluster_order(
        cs.tri_p, cs.tri_inst, cs.inst_t0, cs.inst_t1, cs.num_triangles,
    )
    if perm is None:
        cs.tri_cluster_g = 0
        return
    n = cs.num_triangles
    for name in ("tri_p", "tri_n", "tri_uv", "tri_inst",
                 "tri_mat_type", "tri_mat_index"):
        a = getattr(cs, name)
        a[:n] = a[:n][perm]
    if cs.shade_rows is not None:
        s_pad = cs.sph_center.shape[0]
        cs.shade_rows[s_pad:s_pad + n] = cs.shade_rows[s_pad:s_pad + n][perm]
    # per-mesh soup offsets no longer delimit contiguous runs
    cs.mesh_tri_offsets = None
    cs.tri_cluster_g = G


def apply_sphere_order(cs) -> None:
    """Reorder the sphere block of a CompiledScene in place (pre-shade_rows).

    Sets cs.sph_prefix; a no-op (prefix 0) for scenes the selective sweep
    won't take.
    """
    perm, n_prefix = sphere_cluster_order(
        cs.sph_center, cs.sph_radius, cs.sph_inst, cs.inst_t0, cs.inst_t1,
        cs.num_spheres,
    )
    if perm is None:
        cs.sph_prefix = 0
        return
    n = cs.num_spheres
    for name in ("sph_center", "sph_radius", "sph_inst",
                 "sph_mat_type", "sph_mat_index"):
        a = getattr(cs, name)
        a[:n] = a[:n][perm]
    if cs.shade_rows is not None:
        cs.shade_rows[:n] = cs.shade_rows[:n][perm]
    cs.sph_prefix = n_prefix
