"""The wavefront's triangle closest hit over the SAH or implicit BVH
(``use_bvh=True``): the CUDA kernel ``csrc/bvh_walk.cu`` (H1) and its
plain PyTorch version (counterpart of raytrace_tpu/ops/bvh.py:55
``traverse`` and :191 ``traverse_sah``, which the JAX package traces with
XLA while loops: there is no Pallas kernel to port, and H1 replaces none).

Both trees become one binary row layout (``node_rows``).  A binary node
is one [16] f32 row: both children's boxes (left min xyz, left max xyz,
right min xyz, right max xyz, the JAX rows' cols 0:12 but for the
implicit tree's empty boxes), both child links bitcast to float in cols
12:14 (the SAH builder's own; the implicit heap's 2i + 1 and 2i + 2, a
heap leaf becoming the run of ``leaf_size`` rows it holds), and each
child box's reach, its largest |coordinate|, in cols 14:16 (zero in the
JAX rows).  A link below 0 is a leaf, -(1 + (first << 5 | count)), over
the soup permuted into the tree's order (models/bvh_build.permute_soup),
so a triangle's id is its row.

The kernel walks the binary tree collapsed into four-wide nodes
(``wide_rows``): every internal binary node at an even depth becomes a
wide node, whose children are its children's children where a child is
internal and the child itself where it is a leaf, so 2 to 4 of them.  A
wide node is one [32] f32 row, 128 bytes: the four child boxes as rows of
four (min x, max x, min y, max y, min z, max z: cols 0:24), their links
(24:28) and their reaches (28:32); an absent child is the point (BIG,
BIG, BIG) with reach 0, which no slab test passes.  Each child's box and
reach are copied from the binary row that held them, so a wide child's
box is exactly its binary subtree's, with no new rounding.  The wide
tree has (depth + 1) // 2 levels of internal nodes for a binary tree of
``depth`` (``wide_stack``).

The walk (csrc/bvh_walk.cu; ``bvh_walk_reference`` walks binary and wide
rows alike): from the root link, every child box of a node slab-tested,
each widened for the ray by (|o|_inf + reach) 2^-18, pruned at
``best_t * 1.0001 + 1e-4``; of those that pass, the one entered first
(the lowest slot on equal entry t) is walked and the others pushed with
their entry t, the farthest first, each tested against the best t again
when popped; a leaf's triangles tested with the dense sweep's
Moller-Trumbore operations; a hit kept as the lexicographic minimum of
(t, id).  The tree's boxes bound each triangle over the whole shutter
(models/bvh_build.world_triangle_bounds) and the widening covers their
rounding against the batch's world triangles, so the dense sweep's winner
is always visited and the walk gives the dense sweep's bits over the same
soup, in any order and at any width.  The JAX traversals keep the first
hit found at equal t instead, which differs only on exact ties.

``intersect_tris_bvh`` is the entry point: for tensors on the CPU it runs
``bvh_walk_reference`` on either layout; for CUDA tensors it launches the
kernel on a four-wide tree, or raises.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..models.bvh_build import BIG
from . import _build
from .intersect import T_MAX, Hit
from .paged_tri import (TREE_ROUNDING, _check_rays, _cluster_hits, _inv,
                        _slab)
from .vec3 import V3

LAUNCHES = 0

# The kernel's stack (csrc/bvh_walk.cu kStack): a tree whose walk may need
# more entries is refused.  The mesh scene's SAH tree is 26 deep, so its
# wide walk needs 40 (``wide_stack``); 94 is ``wide_stack(62)``, so every
# tree the binary walk's 64 entries held (depth + 2 <= 64) is walked.
MAX_STACK = 94
# Children of a wide node, and the columns of its row.
WIDE = 4
WIDE_COLS = 32
# A leaf's count has 5 bits and its first row the other 26.
MAX_LEAF = 31
MAX_ROWS = 1 << 26


class BVHTree(NamedTuple):
    """The node rows the walk reads (``node_rows``), on the soup's device."""

    # [N, 16] f32 binary rows (``node_rows``) or [N, 32] four-wide rows
    # (``wide_rows``, the kernel's), at least one row
    nodes: torch.Tensor
    root: int             # the root link (a leaf link for a one-leaf tree)
    # the stack the walk may need: the depth + 2 for binary rows, as the
    # JAX package sizes it; ``wide_stack(depth)`` for wide rows
    stack_depth: int
    leaf: int             # the most triangles a leaf holds
    num_tris: int         # the real triangles, rows [0, num_tris)


def leaf_link(first, count):
    """A leaf's link: -(1 + (first << 5 | count))."""
    return -(1 + ((first << 5) | count))


def node_rows(bvh, num_real: int):
    """A models/bvh_build.BVHData → ([N, 16] f32 node rows, root link): the
    JAX rows' boxes and, for "sah", links; for "implicit" the heap's links
    (a leaf the run of ``leaf_size`` rows it holds, its count cut to the
    real triangles, so a padding leaf holds none); each child box's reach
    in cols 14:16.  An empty box (the implicit tree's padding, min +BIG
    and max -BIG, which a slab test taking each axis's min and max would
    pass) becomes the point (BIG, BIG, BIG) with reach 0, which no slab
    test passes, as in ops/paged_tri.build_tri_tree."""
    if bvh.leaf_size > MAX_LEAF:
        raise ValueError(f"leaves of {bvh.leaf_size} triangles: a leaf link "
                         f"holds at most {MAX_LEAF}")
    if bvh.order.shape[0] >= MAX_ROWS:
        raise ValueError(f"a soup of {bvh.order.shape[0]} rows: a leaf link "
                         f"indexes fewer than {MAX_ROWS}")
    rows = np.array(bvh.child_boxes, np.float32).reshape(-1, 16)
    if bvh.mode == "sah":
        root = int(bvh.root)
    elif bvh.mode == "implicit":
        K, L = bvh.num_leaves, bvh.leaf_size

        def link(c):
            k = c - (K - 1)
            count = np.clip(num_real - k * L, 0, L)
            return np.where(c < K - 1, c, leaf_link(k * L, count))

        i = np.arange(K - 1, dtype=np.int64)
        rows[:, 12:14] = np.stack([link(2 * i + 1), link(2 * i + 2)],
                                  axis=1).astype(np.int32).view(np.float32)
        root = 0 if K > 1 else int(link(np.int64(0)))
    else:
        raise ValueError(f"no walk for a BVH of mode {bvh.mode!r}")
    if rows.shape[0] == 0:
        rows = np.zeros((1, 16), np.float32)
    for side in (0, 1):
        box = rows[:, 6 * side:6 * side + 6]
        empty = (box[:, :3] > box[:, 3:]).any(axis=1)
        box[empty] = BIG
        rows[:, 14 + side] = np.where(empty, 0.0, np.abs(box).max(axis=1))
    return rows, root


def wide_stack(depth: int) -> int:
    """The stack the wide walk may need over a binary tree whose leaves lie
    at most ``depth`` below its root (models/bvh_build.BVHData.depth): its
    internal nodes lie at depths 0 .. depth - 1, so the wide tree has
    (depth + 1) // 2 levels of internal nodes, a walk holds at most three
    pending children of each, and one entry more."""
    return 3 * ((depth + 1) // 2) + 1


def wide_rows(rows: np.ndarray, root: int):
    """Binary node rows (``node_rows``) and their root link → ([M, 32] f32
    four-wide rows, the wide root link).  The internal binary nodes at an
    even depth below the root become the wide nodes, in the order of
    their binary rows; a wide node's slots 2s and 2s + 1 hold the children
    of its binary child s where that child is internal, else that child
    alone in slot 2s.  Each slot's box and reach are copied from the
    binary row that held them; an absent child is the point (BIG, BIG,
    BIG) with reach 0 and a leaf link of no triangle.  A one-leaf tree
    (a leaf root link) keeps its root and one zero row."""
    if root < 0:
        return np.zeros((1, WIDE_COLS), np.float32), int(root)
    rows = np.asarray(rows, np.float32)
    n = rows.shape[0]
    links = rows[:, 12:14].view(np.int32).astype(np.int64)
    depth = np.full(n, -1, np.int64)
    frontier, d = np.array([root], np.int64), 0
    while frontier.size:
        depth[frontier] = d
        frontier = links[frontier].ravel()
        frontier = frontier[frontier >= 0]
        d += 1
    wide = np.nonzero((depth >= 0) & (depth % 2 == 0))[0]
    wide_id = np.full(n, -1, np.int64)
    wide_id[wide] = np.arange(wide.size)
    M = wide.size
    box = np.full((M, WIDE, 6), BIG, np.float32)
    reach = np.zeros((M, WIDE), np.float32)
    link = np.full((M, WIDE), leaf_link(0, 0), np.int64)
    for side in (0, 1):
        child = links[wide, side]
        leaf = child < 0
        box[leaf, 2 * side] = rows[wide[leaf], 6 * side:6 * side + 6]
        reach[leaf, 2 * side] = rows[wide[leaf], 14 + side]
        link[leaf, 2 * side] = child[leaf]
        inner = child[~leaf]
        for t in (0, 1):
            grand = links[inner, t]
            box[~leaf, 2 * side + t] = rows[inner, 6 * t:6 * t + 6]
            reach[~leaf, 2 * side + t] = rows[inner, 14 + t]
            link[~leaf, 2 * side + t] = np.where(
                grand >= 0, wide_id[np.maximum(grand, 0)], grand)
    out = np.zeros((M, WIDE_COLS), np.float32)
    # [M, slot, (lo, hi), axis] -> columns axis * 8 + (lo, hi) * 4 + slot.
    out[:, 0:24] = box.reshape(M, WIDE, 2, 3).transpose(0, 3, 2, 1).reshape(
        M, 24)
    out[:, 24:28] = link.astype(np.int32).view(np.float32)
    out[:, 28:32] = reach
    return out, int(wide_id[root])


def wide_tree(bvh, num_real: int):
    """A models/bvh_build.BVHData → (its [M, 32] f32 four-wide rows, their
    root link, the walk's stack): ``node_rows`` collapsed by
    ``wide_rows``, the stack ``wide_stack(bvh.depth)``."""
    rows, root = wide_rows(*node_rows(bvh, num_real))
    return rows, root, wide_stack(bvh.depth)


# ------------------------------------------------------------ plain version

def _children(rows: torch.Tensor):
    """The child boxes [n, k, 6] (min xyz, max xyz), links [n, k] (int64)
    and reaches [n, k] of n binary (k = 2) or four-wide (k = 4) rows."""
    if rows.shape[1] == 16:
        return (rows[:, 0:12].reshape(-1, 2, 6),
                rows[:, 12:14].contiguous().view(torch.int32).long(),
                rows[:, 14:16])
    b = rows[:, 0:24].reshape(-1, 3, 2, WIDE)      # [n, axis, lo/hi, slot]
    return (torch.cat([b[:, :, 0], b[:, :, 1]], dim=1).transpose(1, 2),
            rows[:, 24:28].contiguous().view(torch.int32).long(),
            rows[:, 28:32])


def _child_tests(o3, iv3, o_inf, rows, best_t, enter=False):
    """Every child box of each ray's node (``rows`` [m, 16 or 32], the
    rays' o3, iv3, o_inf and best t [m]) slab-tested as the kernel tests
    it, widened by (|o|_inf + reach) 2^-18: (pass [m, k], entry t [m, k]
    with ``enter``, links [m, k])."""
    boxes, links, reach = _children(rows)
    out = _slab(tuple(x[:, None] for x in o3),
                tuple(x[:, None] for x in iv3), boxes, best_t[:, None], 3,
                (o_inf[:, None] + reach) * TREE_ROUNDING, enter)
    return (*out, links) if enter else (out, links)


def bvh_walk_reference(o: V3, d: V3, table12: torch.Tensor, tree: BVHTree,
                       active: torch.Tensor):
    """The plain version of the kernel: the same walk, vectorised over the
    rays that still walk, a step at a time (an internal node's box tests
    and pushes, or a leaf's triangles, then the pops), with the kernel's
    operations, over binary or four-wide rows.  The children that pass
    are ranked by (entry t, slot); the first is walked and the others
    pushed from the last.  Returns (t, id, u, v): (T_MAX, -1, 0, 0) on a
    miss and for inactive rays; at equal t the lowest id."""
    R = o.x.shape[0]
    dev = o.x.device
    bt = torch.full((R,), T_MAX, dtype=torch.float32, device=dev)
    bid = torch.full((R,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(R, dtype=torch.float32, device=dev)
    bv = torch.zeros(R, dtype=torch.float32, device=dev)
    if tree.num_tris == 0:
        return bt, bid, bu, bv
    iv3 = tuple(_inv(x) for x in d)
    o_inf = torch.maximum(torch.maximum(o.x.abs(), o.y.abs()), o.z.abs())
    lane = torch.arange(tree.leaf, device=dev)
    no_row = table12.shape[0]

    ray = torch.nonzero(active).squeeze(1)
    n = ray.numel()
    link = torch.full((n,), tree.root, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, tree.stack_depth), dtype=torch.int64, device=dev)
    stack_te = torch.zeros((n, tree.stack_depth), dtype=torch.float32,
                           device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    while ray.numel():
        internal = link >= 0
        ii = torch.nonzero(internal).squeeze(1)
        li = torch.nonzero(~internal).squeeze(1)
        pop = [li]
        if ii.numel():
            r = ray[ii]
            hit, te, links = _child_tests(
                tuple(x[r] for x in o), tuple(x[r] for x in iv3), o_inf[r],
                tree.nodes[link[ii]], bt[r], enter=True)
            k = hit.shape[1]
            key = torch.where(hit, te, float("inf"))
            slot = torch.arange(k, device=dev)
            ahead = ((key[:, :, None] < key[:, None, :])
                     | ((key[:, :, None] == key[:, None, :])
                        & (slot[:, None] < slot[None, :])))
            order = torch.empty_like(links).scatter_(
                1, ahead.sum(dim=1), slot.expand_as(links).clone())
            n_pass = hit.sum(dim=1)
            for j in range(k - 1, 0, -1):
                pj = ii[n_pass > j]
                if not pj.numel():
                    continue
                if int(sp[pj].max()) >= tree.stack_depth:
                    raise ValueError("the walk outgrew its stack: the tree "
                                     "is deeper than its stack_depth")
                cj = order[n_pass > j, j:j + 1]
                stack[pj, sp[pj]] = links[n_pass > j].gather(1, cj)[:, 0]
                stack_te[pj, sp[pj]] = te[n_pass > j].gather(1, cj)[:, 0]
                sp[pj] += 1
            go = n_pass > 0
            link[ii[go]] = links[go].gather(1, order[go, :1])[:, 0]
            pop.append(ii[~go])
        if li.numel():
            r = ray[li]
            enc = -(link[li] + 1)
            first, count = enc >> 5, enc & 31
            slots = first[:, None] + lane
            slots = torch.where(lane < count[:, None], slots, no_row)
            t, u, v = _cluster_hits(tuple(x[r][:, None] for x in o),
                                    tuple(x[r][:, None] for x in d),
                                    table12, slots, tree.num_tris)
            tk, arg = torch.min(t, dim=1)       # the lowest slot at its t
            idk = (first + arg).to(torch.int32)
            better = (tk < T_MAX) & ((tk < bt[r])
                                     | ((tk == bt[r]) & (idk < bid[r])))
            w = r[better]
            bt[w] = tk[better]
            bid[w] = idk[better]
            bu[w] = u.gather(1, arg[:, None])[:, 0][better]
            bv[w] = v.gather(1, arg[:, None])[:, 0][better]
        # Pop the nearest pending sibling that still passes.
        p = torch.cat(pop)
        done = torch.zeros(ray.numel(), dtype=torch.bool, device=dev)
        while p.numel():
            empty = sp[p] == 0
            done[p[empty]] = True
            p = p[~empty]
            sp[p] -= 1
            cand, te = stack[p, sp[p]], stack_te[p, sp[p]]
            ok = te < bt[ray[p]] * 1.0001 + 1e-4
            link[p[ok]] = cand[ok]
            p = p[~ok]
        keep = ~done
        ray, link, sp = ray[keep], link[keep], sp[keep]
        stack, stack_te = stack[keep], stack_te[keep]
    return bt, bid, bu, bv


def visit_counts(o: V3, d: V3, tree: BVHTree, best_t: torch.Tensor,
                 active: torch.Tensor) -> dict:
    """The work of a walk that proves each ray's closest hit ``best_t``
    (ops/paged_tri.tree_work's convention), over binary or four-wide rows:
    the internal nodes whose child boxes it must test (the root, and every
    node reached from it through boxes that pass against ``best_t``) and
    the triangles of every leaf so reached.  Over binary rows no walk of
    the tree that proves ``best_t`` does less.  Over four-wide rows it is
    the wide walk's own work, four box tests a node step, absent slots and
    the children of a binary box that fails included: the binary walk over
    the same boxes does less, so a bound takes the binary rows' count.
    Returns Python ints: ``rays``, ``node_tests`` (a node's two or four box
    tests each), ``tri_tests``, and the distinct rows those read,
    ``nodes_read`` and ``tris_read``."""
    iv3 = tuple(_inv(x) for x in d)
    o_inf = torch.maximum(torch.maximum(o.x.abs(), o.y.abs()), o.z.abs())
    ray = torch.nonzero(active).squeeze(1)
    work = dict(rays=ray.numel(), node_tests=0, tri_tests=0)
    seen = torch.zeros(tree.nodes.shape[0], dtype=torch.bool,
                       device=ray.device)
    leaves = []
    link = torch.full_like(ray, tree.root)
    while ray.numel():
        internal = link >= 0
        lk = link[~internal]
        leaves.append(torch.unique(lk))
        work["tri_tests"] += int((-(lk + 1) & 31).sum())
        r, lk = ray[internal], link[internal]
        work["node_tests"] += r.numel()
        seen[lk] = True
        hit, links = _child_tests(tuple(x[r] for x in o),
                                  tuple(x[r] for x in iv3), o_inf[r],
                                  tree.nodes[lk], best_t[r])
        ray = r[:, None].expand_as(hit)[hit]
        link = links[hit]
    reached = torch.unique(torch.cat(leaves)) if leaves else link
    work["nodes_read"] = int(seen.sum())
    work["tris_read"] = int((-(reached + 1) & 31).sum())
    return work


# ------------------------------------------------------------------- kernel

def check_tree(tree: BVHTree, table12: torch.Tensor, device) -> None:
    """The tree against its table, the kernel's stack and leaf links."""
    nodes = tree.nodes
    if (nodes.dtype != torch.float32 or nodes.dim() != 2
            or nodes.shape[1] not in (16, WIDE_COLS) or nodes.shape[0] < 1
            or nodes.device != device or not nodes.is_contiguous()):
        raise ValueError("tree.nodes must be a contiguous float32 [N, 16] "
                         "or [N, 32] tensor (N >= 1) on the rays' device")
    if (table12.dtype != torch.float32 or table12.dim() != 2
            or table12.shape[1] != 12 or table12.device != device
            or not table12.is_contiguous()):
        raise ValueError("table12 must be a contiguous float32 [T8, 12] "
                         "tensor on the rays' device")
    if tree.stack_depth > MAX_STACK:
        raise ValueError(f"a tree whose walk needs a stack of "
                         f"{tree.stack_depth} is deeper than the kernel's "
                         f"({MAX_STACK})")
    if not 1 <= tree.leaf <= MAX_LEAF:
        raise ValueError(f"leaves of {tree.leaf} triangles: 1 to {MAX_LEAF}")
    if tree.num_tris > table12.shape[0] or table12.shape[0] >= MAX_ROWS:
        raise ValueError(f"a tree of {tree.num_tris} triangles over a table "
                         f"of {table12.shape[0]} rows")
    if tree.root >= nodes.shape[0]:
        raise ValueError(f"root link {tree.root} past the tree's "
                         f"{nodes.shape[0]} rows")


def intersect_tris_bvh(o: V3, d: V3, table12: torch.Tensor, tree: BVHTree,
                       active: torch.Tensor) -> Hit:
    """Closest hit of rays o + t d against the soup of the [T8, 12] table
    (ops/megakernel.tri_table12, in the tree's order) through ``tree``; the
    lowest id on ties; inactive rays and misses give (T_MAX, -1, 0, 0).
    On the CPU the plain walk takes binary or four-wide rows, the kernel
    four-wide rows only.  A soup with no triangle launches nothing."""
    global LAUNCHES
    _check_rays(o, d, active)
    device = o.x.device
    check_tree(tree, table12, device)
    R = o.x.shape[0]
    if device.type == "cpu" or tree.num_tris == 0:
        return Hit(*bvh_walk_reference(o, d, table12, tree, active))
    if device.type != "cuda":
        raise ValueError(f"no BVH walk for device {device}")
    if tree.nodes.shape[1] != WIDE_COLS:
        raise ValueError("the kernel walks four-wide rows: collapse the "
                         "binary rows with wide_rows")
    if R >= 2 ** 31:
        raise ValueError(f"{R} rays: the kernel indexes rays in 32 bits")
    if table12.data_ptr() % 16 or tree.nodes.data_ptr() % 16:
        raise ValueError("the tree's tables must be 16-byte aligned (float4 "
                         "loads)")
    lib = library()
    t = torch.empty(R, dtype=torch.float32, device=device)
    ids = torch.empty(R, dtype=torch.int32, device=device)
    u = torch.empty(R, dtype=torch.float32, device=device)
    v = torch.empty(R, dtype=torch.float32, device=device)
    err = lib.bvh_walk_launch(
        tree.nodes.data_ptr(), tree.root, table12.data_ptr(), tree.num_tris,
        o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
        d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
        active.data_ptr(), R, t.data_ptr(), ids.data_ptr(), u.data_ptr(),
        v.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"bvh_walk launch failed: CUDA error {err} "
            f"({lib.bvh_walk_error_string(err).decode()})")
    LAUNCHES += 1
    return Hit(t=t, tri=ids, u=u, v=v)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/ at first use."""
    lib = _build.load_library("bvh_walk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bvh_walk_launch.argtypes = [p, i, p, i, p, p, p, p, p, p, p, i, p, p,
                                    p, p, p]
    lib.bvh_walk_launch.restype = i
    lib.bvh_walk_error_string.argtypes = [i]
    lib.bvh_walk_error_string.restype = ctypes.c_char_p
    return lib
