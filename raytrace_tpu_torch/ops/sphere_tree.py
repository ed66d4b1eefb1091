"""The fused kernel's tree over its clustered spheres, and the tree walk's
plain PyTorch versions.

A scene whose compiler put its spheres in Morton clusters
(models/sphere_order.py: a dense prefix of ``n_prefix`` large spheres,
then the rest) renders in K4's clustered forms (ops/megakernel.py
``sphere_cluster_layout``).  The kernel sweeps the prefix densely, then
walks a binary tree over the spheres past it, nearest first, with the
walk the triangle trees use (csrc/tri_tree.cuh).  The compiler's clusters
are Morton-ordered only as groups (inside a group the order is not
spatial), so the tree has an order of its own: ``sphere_order`` takes the
Morton order of the spheres' centres once per Renderer, on the host, and
``build_sphere_tree`` keeps a permuted copy of their rows with an int32
slot -> id table, as ops/paged_tri.build_soup_tree does for K4's soup.

The tree is implicit (ops/paged_tri.build_tri_tree): leaf k holds the
slots [k L, (k + 1) L) and is node K - 1 + k; node n has children 2n + 1
and 2n + 2; each internal node is one 64-byte row holding both children's
boxes (columns 0:12), each child's reach, the most |c| + |r| below it
(12:14), and each child's rounding coefficient, SPHERE_ROUNDING over the
least positive radius below it (14:16).  The kernel widens a child's box
for each ray by (|o| + reach)^2 coef (ops/megakernel.sphere_cluster_pretest
derives the margin); reach and coef are maxima over a node's spheres, so a
node's widened box holds the widened box of every sphere below it.  A box
holding no sphere is the point (_BIGF, _BIGF, _BIGF) with no margin,
which never passes.  The top ``SphereTree.staged`` node rows are staged in
shared memory (``stage_nodes``); the rest, the sphere rows and the ids
are read through the read-only cache.  ``build_box_nodes`` builds the
node rows from any slots' boxes and margin terms: ``build_sphere_tree``'s
from world spheres, and ops/sphere_obj.build_object_tree's from the world
boxes of ellipsoids (the object-space sweep H2), whose tree is a
``SphereTree`` with 64-byte sphere rows.

``sphere_tree_sweep_reference`` is the kernel's sweep in plain PyTorch (the
prefix, then the walk), bit for bit with the dense sweep
(ops/spheres.intersect_spheres_world): at a leaf each sphere is tested
with the dense sweep's operations and a hit is kept as the lexicographic
minimum of (t, id), so any visiting order gives the dense sweep's winner.
``sphere_tree_visit_counts`` counts the walk's work beside
ops/megakernel.sphere_cluster_sweep_reference's count of the flat walk.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.sphere_order import _iso_morton_codes
from . import paged_tri
from .intersect import T_MAX, T_MIN
from .megakernel import (_BIGF, MAX_SPHERES_CLUSTERED, SPHERE_ROUNDING,
                         moved_table)
from .spheres import intersect_spheres_world
from .vec3 import V3

# Spheres per leaf: the fewest of 1, 2, 4 and 8 that keep the tree at
# MAX_LEAVES leaves or fewer (``sphere_leaf``); and the bytes of node rows
# a block stages in shared memory.  Both chosen on the card (PERF.md §6):
# a leaf of 1 was fastest on final-one-weekend's 484 spheres, 2 on
# stress-4x's 1,936, 4 and 8 on stress-16k's 16,380, each by more than the
# runs' spread; 8 to 24 KiB staged were within the spread of none on three
# scenes and ~9% faster on the motion-blur scene, 32 KiB slower (six
# blocks a multiprocessor in place of seven or eight).
MAX_LEAVES = 1024
STAGE_BYTES = 16384
# The walk's stack (csrc/megakernel.cu kStack): one entry a level, the
# depth of the gate's MAX_SPHERES_CLUSTERED spheres at leaves of one.
MAX_SPHERE_DEPTH = (MAX_SPHERES_CLUSTERED - 1).bit_length()
_NODE_BYTES = 64
_BIG = 3e38  # the identity of the box union, before empty boxes are marked


class SphereTree(NamedTuple):
    """The tree over a scene's clustered spheres, on the table's device.
    Slot j holds sphere ``ids[j]`` (an id of the [S8, 8] table, at or above
    ``n_prefix``)."""

    rows: torch.Tensor             # [n, 8] the table's rows in slot order
    drows: Optional[torch.Tensor]  # [n, 8] their motion rows, or None
    nodes: torch.Tensor            # [K - 1, 16] the internal nodes' rows
    ids: torch.Tensor              # [n] int32 each slot's sphere id
    n_prefix: int                  # the spheres swept densely first
    num_spheres: int               # n, the spheres in the tree
    leaf: int                      # spheres per leaf
    depth: int                     # log2 K, K leaves
    staged: int                    # node rows staged in shared memory


def sphere_order(centres: np.ndarray, n_prefix: int,
                 num_spheres: int) -> np.ndarray:
    """[num_spheres - n_prefix] int64 sphere ids past the prefix, in the
    isotropic Morton order of their centres (a [S, 3] array; at shutter
    time 0.5 for moving spheres), stable on equal codes.  Isotropic: one
    scale for the three axes, so final-one-weekend's thin y-jitter does
    not dominate the interleave (models/sphere_order._iso_morton_codes)."""
    c = np.asarray(centres[n_prefix:num_spheres], np.float64)
    return n_prefix + np.argsort(_iso_morton_codes(c), kind="stable")


def sphere_leaf(num_spheres: int) -> int:
    """Spheres per leaf of a tree over ``num_spheres``: the fewest of 1,
    2 and 4 that keep it at MAX_LEAVES leaves or fewer, else 8."""
    for leaf in (1, 2, 4):
        if -(-num_spheres // leaf) <= MAX_LEAVES:
            return leaf
    return 8


def stage_nodes(n_nodes: int, stage_bytes: int = STAGE_BYTES) -> int:
    """The node rows a block stages: the whole tree when its ``n_nodes``
    rows fit in ``stage_bytes``, else its top 2^k - 1 rows that do."""
    fit = stage_bytes // _NODE_BYTES
    if n_nodes <= fit:
        return n_nodes
    return (1 << ((fit + 1).bit_length() - 1)) - 1


def _leaf_boxes(lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor,
                K: int, leaf: int):
    """[K, 3] min of ``lo`` and max of ``hi`` ([n, 3] each slot's box) over
    each leaf's valid slots, each widened by 1e-5 + 1e-5 max(|min|, |max|)
    as ops/megakernel.sphere_cluster_boxes widens a cluster's; a leaf
    without one gets (+_BIG, -_BIG)."""
    n = lo.shape[0]
    ok = torch.zeros(K * leaf, dtype=torch.bool, device=lo.device)
    ok[:n] = valid
    ok = ok.reshape(K, leaf, 1)
    grid = lo.new_zeros((2, K * leaf, 3))
    grid[0, :n], grid[1, :n] = lo, hi
    mn = torch.where(ok, grid[0].reshape(K, leaf, 3), _BIG).amin(dim=1)
    mx = torch.where(ok, grid[1].reshape(K, leaf, 3), -_BIG).amax(dim=1)
    pad = 1e-5 + 1e-5 * torch.maximum(mn.abs(), mx.abs())
    anyv = ok[..., 0].any(dim=1, keepdim=True)
    return (torch.where(anyv, mn - pad, _BIG),
            torch.where(anyv, mx + pad, -_BIG))


def build_box_nodes(boxes, valid: torch.Tensor, reach: torch.Tensor,
                    coef: torch.Tensor, leaf: int):
    """The internal node rows ([K - 1, 16]) and depth (log2 K) of the
    implicit tree over n slots in leaves of ``leaf``, built level by level
    on the slots' device from each slot's boxes: ``boxes`` a list of (lo,
    hi) pairs of [n, 3] (a moving sphere's box at each end of the
    shutter; each leaf's union of every pair, each pair's union widened
    by ``_leaf_boxes``), ``valid`` [n] the slots a box holds, ``reach`` and
    ``coef`` [n] the terms of each slot's rounding margin, (|o| + reach)^2
    coef.  A leaf's reach and coef are their maxima over its valid slots
    (0 where it has none); an internal node's box is the exact union of
    its children's, its reach and coef their maxima.  A box holding no
    slot is the point (_BIGF, _BIGF, _BIGF) with no margin, which never
    passes."""
    n = valid.shape[0]
    n_leaves = -(-n // leaf)
    K = 1 << (n_leaves - 1).bit_length()
    mn = mx = None
    for lo, hi in boxes:
        a, b = _leaf_boxes(lo, hi, valid, K, leaf)
        mn = a if mn is None else torch.minimum(mn, a)
        mx = b if mx is None else torch.maximum(mx, b)

    def leaf_max(x):
        g = x.new_zeros(K * leaf)
        g[:n] = torch.where(valid, x, 0.0)
        return g.reshape(K, leaf).amax(dim=1)

    levels = [torch.cat([mn, mx, leaf_max(reach)[:, None],
                         leaf_max(coef)[:, None]], dim=1)]
    while levels[-1].shape[0] > 1:
        pair = levels[-1].reshape(-1, 2, 8)
        levels.append(torch.cat([pair[:, :, 0:3].amin(dim=1),
                                 pair[:, :, 3:8].amax(dim=1)], dim=1))
    heap = torch.cat(levels[::-1])                   # [2K - 1, 8] node n's
    empty = (heap[:, 0:3] > heap[:, 3:6]).any(dim=1, keepdim=True)
    heap = torch.where(empty, torch.tensor([_BIGF] * 6 + [0.0, 0.0],
                                           device=heap.device), heap)
    nodes = mn.new_zeros((K - 1, 16))
    nodes[:, 0:12] = heap[1:, 0:6].reshape(K - 1, 12)
    nodes[:, 12:14] = heap[1:, 6].reshape(K - 1, 2)
    nodes[:, 14:16] = heap[1:, 7].reshape(K - 1, 2)
    return nodes, len(levels) - 1


def _sphere_boxes(rows: torch.Tensor):
    """Each [.., 8] table row's box (c -/+ |r|), its validity (k < 1e37),
    its reach (|c| + |r|) and its rounding coefficient (SPHERE_ROUNDING /
    r where r > 0, else 0)."""
    c, r = rows[:, 0:3], rows[:, 3:4].abs()
    valid = rows[:, 4] < 1e37
    coef = torch.where(valid & (rows[:, 3] > 0.0),
                       SPHERE_ROUNDING / torch.where(rows[:, 3] > 0.0,
                                                     rows[:, 3], 1.0), 0.0)
    return (c - r, c + r, valid,
            torch.linalg.vector_norm(c, dim=-1) + r[:, 0], coef)


def build_sphere_tree(table8: torch.Tensor, n_prefix: int, num_spheres: int,
                      ids: torch.Tensor, dtab8: Optional[torch.Tensor] = None,
                      leaf: Optional[int] = None,
                      stage_bytes: int = STAGE_BYTES) -> SphereTree:
    """The tree over the spheres ``n_prefix`` .. ``num_spheres`` - 1 of the
    [S8, 8] table, in the order ``ids`` ([num_spheres - n_prefix] int32 on
    the table's device, ``sphere_order``), built on the table's device by
    ``build_box_nodes``.  A sphere's box is c -/+ |r|; with ``dtab8`` (the
    spheres' linear motion, the table at shutter time 0) also its box at
    c0 + dc, so a leaf's box holds each sphere at every time in [0, 1],
    the radii fixed.  Its reach is |c| + |r| (the larger of the two ends),
    its coefficient SPHERE_ROUNDING over its radius.  ``leaf`` spheres a
    leaf, ``sphere_leaf``'s when not given."""
    n = num_spheres - n_prefix
    if leaf is None:
        leaf = sphere_leaf(n)
    if n < 1 or leaf < 1:
        raise ValueError("a sphere tree needs at least one sphere past the "
                         "prefix and one sphere a leaf")
    if ids.dtype != torch.int32 or ids.shape != (n,):
        raise ValueError(f"ids must be an int32 [{n}] permutation of the "
                         f"spheres past the prefix")
    take = ids.long()
    rows = table8[take].contiguous()
    drows = None if dtab8 is None else dtab8[take].contiguous()
    lo, hi, valid, reach, coef = _sphere_boxes(rows)
    boxes = [(lo, hi)]
    if drows is not None:
        moved = rows.clone()
        moved[:, 0:3] = rows[:, 0:3] + drows[:, 0:3]
        lo1, hi1, _, reach1, _ = _sphere_boxes(moved)
        boxes.append((lo1, hi1))
        reach = torch.maximum(reach, reach1)
    nodes, depth = build_box_nodes(boxes, valid, reach, coef, leaf)
    return SphereTree(rows=rows, drows=drows, nodes=nodes, ids=ids,
                      n_prefix=int(n_prefix), num_spheres=int(n),
                      leaf=int(leaf), depth=depth,
                      staged=stage_nodes(nodes.shape[0], stage_bytes))


def check_tree(tree: SphereTree, table8: torch.Tensor, n_prefix: int,
               num_spheres: int, anim: bool,
               max_depth: int = MAX_SPHERE_DEPTH,
               permutation: bool = True) -> None:
    """The tree against its scene (the [S8, 8] table, the layout's prefix,
    the real spheres, and whether they move) and the kernel's stack
    (``max_depth``: K4's by default, ops/sphere_sweep.WALK_DEPTH for K1):
    shapes, devices, a contiguous and 16-byte-aligned layout for the
    float4 loads, and with ``permutation`` an id table that is a
    permutation of the spheres past the prefix (checked on the device, so
    the check waits for it)."""
    n = num_spheres - n_prefix
    dev = table8.device
    if tree.n_prefix != n_prefix or tree.num_spheres != n or n < 1:
        raise ValueError(f"the sphere tree holds spheres {tree.n_prefix} .. "
                         f"{tree.n_prefix + tree.num_spheres - 1}, the scene "
                         f"{n_prefix} .. {num_spheres - 1} past its prefix")
    if tree.leaf < 1 or tree.depth != (-(-n // tree.leaf) - 1).bit_length():
        raise ValueError(f"a sphere tree of depth {tree.depth} does not match "
                         f"its {n} spheres in leaves of {tree.leaf}")
    if tree.depth > max_depth:
        raise ValueError(f"a sphere tree of depth {tree.depth} is deeper than "
                         f"the kernel's stack ({max_depth})")
    if num_spheres > table8.shape[0]:
        raise ValueError(f"{num_spheres} spheres in a table of "
                         f"{table8.shape[0]} rows")
    n_nodes = (1 << tree.depth) - 1
    if not 0 <= tree.staged <= n_nodes:
        raise ValueError(f"{tree.staged} staged node rows of {n_nodes}")
    tables = [("rows", tree.rows, (n, table8.shape[1]), torch.float32),
              ("nodes", tree.nodes, (n_nodes, 16), torch.float32),
              ("ids", tree.ids, (n,), torch.int32)]
    if anim != (tree.drows is not None):
        raise ValueError("a moving scene's sphere tree needs its motion rows, "
                         "and a static one's has none")
    if anim:
        tables.append(("drows", tree.drows, (n, 8), torch.float32))
    for name, t, shape, dtype in tables:
        if (t.dtype != dtype or t.shape != shape or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"the sphere tree's {name} must be a contiguous, "
                             f"16-byte aligned {dtype} {list(shape)} tensor "
                             f"on the table's device")
    if not permutation:
        return
    seen = torch.zeros(num_spheres, dtype=torch.int32, device=dev)
    ok = bool(((tree.ids >= n_prefix) & (tree.ids < num_spheres)).all())
    if ok:
        seen.index_add_(0, tree.ids.long(), torch.ones_like(tree.ids))
        ok = bool((seen[n_prefix:] == 1).all())
    if not ok:
        raise ValueError("the sphere tree's ids must be a permutation of the "
                         "spheres past the prefix")


# ------------------------------------------------------------ plain version

def _margins(o3):
    """The sphere tree's rounding margins: a child box of a node row
    widened by (|o| + reach)^2 coef, reach in columns 12:14 and coef in
    14:16, |o| the Euclidean norm as the kernel computes it."""
    ox, oy, oz = o3
    onorm = torch.sqrt(ox * ox + oy * oy + oz * oz)

    def margins(rows, ray):
        near = onorm[ray]
        sl = near + rows[:, 12]
        sr = near + rows[:, 13]
        return sl * sl * rows[:, 14], sr * sr * rows[:, 15]
    return margins


def _sphere_hits(o3, d3, rows: torch.Tensor) -> torch.Tensor:
    """t [K, L] of K rays (o3, d3: three [K, 1] tensors) against each
    one's L spheres (rows [K, L, 8]), with the operations of
    ops/spheres.intersect_spheres_world; T_MAX where there is no hit."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    d_dot_o = dx * ox + dy * oy + dz * oz
    a = dx * dx + dy * dy + dz * dz
    o_sq = ox * ox + oy * oy + oz * oz
    inv_a = 1.0 / torch.where(a == 0.0, 1.0, a)
    cx, cy, cz, r, k = (rows[..., i] for i in range(5))
    dc = cx * dx + cy * dy + cz * dz
    oc = cx * ox + cy * oy + cz * oz
    h = d_dot_o - dc
    c2 = o_sq - 2.0 * oc + k
    disc = h * h - a * c2
    ok = (disc >= 0.0) & (r > 0.0)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = (-h - sq) * inv_a
    t2 = (-h + sq) * inv_a
    t1_ok = ok & (t1 > T_MIN) & (t1 < T_MAX)
    t2_ok = ok & (t2 > T_MIN) & (t2 < T_MAX)
    return torch.where(t1_ok, t1, torch.where(t2_ok, t2, T_MAX))


def sphere_tree_sweep_reference(o: V3, d: V3, table8: torch.Tensor,
                                tree: SphereTree,
                                dtab8: Optional[torch.Tensor] = None,
                                t: Optional[torch.Tensor] = None):
    """The kernel's sphere sweep in a clustered form, in plain PyTorch:
    (t [R] f32, id [R] int32), (T_MAX, -1) on a miss.  The prefix of the
    [S8, 8] table is swept densely (ops/spheres.intersect_spheres_world);
    then the tree is walked (ops/paged_tri.walk_reference with the
    spheres' margins), seeded with the prefix's best hit, whose ids are
    below the tree's, and at each leaf its spheres are tested with the
    dense sweep's operations and merged as the lexicographic minimum of
    (t, id).  With ``dtab8`` (and the tree's motion rows) the spheres
    first move to time ``t`` (a 0-dim f32 tensor), as the kernel moves
    them (ops/megakernel.moved_table)."""
    rows = tree.rows
    if dtab8 is not None:
        table8 = moved_table(table8, dtab8, t)
        rows = moved_table(rows, tree.drows, t)
    R = o.x.shape[0]
    dev = o.x.device
    best = [torch.full((R,), T_MAX, dtype=torch.float32, device=dev),
            torch.full((R,), -1, dtype=torch.int32, device=dev)]
    if tree.n_prefix > 0:
        hit = intersect_spheres_world(o, d, table8[:tree.n_prefix])
        best = [hit.t.clone(), hit.sph.clone()]
    n, L = tree.num_spheres, tree.leaf
    lane = torch.arange(L, device=dev)

    def on_leaves(ray, leaf):
        step = max(1, paged_tri._CHUNK_ELEMS // (8 * L))
        for k0 in range(0, ray.numel(), step):
            kr, kl = ray[k0:k0 + step], leaf[k0:k0 + step]
            slots = kl[:, None] * L + lane                    # [K, L]
            inside = slots < n
            idx = slots.clamp(max=n - 1)
            th = _sphere_hits(tuple(x[kr][:, None] for x in o),
                              tuple(x[kr][:, None] for x in d), rows[idx])
            paged_tri.merge_hits(best, kr, torch.where(inside, th, T_MAX),
                                 tree.ids[idx].long())

    paged_tri.walk_reference(tuple(o), tuple(paged_tri._inv(x) for x in d),
                             tree, torch.arange(R, device=dev), best[0],
                             _margins(o), on_leaves)
    return best[0], best[1]


def sphere_tree_visit_counts(o: V3, d: V3, tree: SphereTree,
                             best_t: torch.Tensor,
                             active: Optional[torch.Tensor] = None) -> dict:
    """The work of the kernel's sweep for rays whose closest hit is
    ``best_t`` (ops/paged_tri.tree_work over the sphere tree): the prefix
    swept densely, the internal nodes whose two child boxes a walk must
    test, and the spheres of every leaf reached.  No walk of the tree
    that proves ``best_t`` does less.  Returns Python ints: ``rays``,
    ``prefix_tests``, ``node_tests`` (two box tests each), ``sphere_tests``,
    and the distinct rows those read, ``nodes_read`` and
    ``spheres_read``."""
    if active is None:
        active = torch.ones(o.x.shape[0], dtype=torch.bool, device=o.x.device)
    n, L = tree.num_spheres, tree.leaf
    work = paged_tri.tree_work(
        tuple(o), tuple(paged_tri._inv(x) for x in d), tree,
        torch.nonzero(active).squeeze(1), best_t, _margins(o),
        lambda leaf: (n - leaf * L).clamp(0, L))
    work["prefix_tests"] = work["rays"] * tree.n_prefix
    work["sphere_tests"] = work.pop("leaf_tests")
    work["spheres_read"] = work.pop("leaf_read")
    return work
