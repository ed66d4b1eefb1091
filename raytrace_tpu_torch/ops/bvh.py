"""The wavefront's triangle closest hit over the SAH or implicit BVH
(``use_bvh=True``): the CUDA kernel ``csrc/bvh_walk.cu`` (H1) and its
plain PyTorch version (counterpart of raytrace_tpu/ops/bvh.py:55
``traverse`` and :191 ``traverse_sah``, which the JAX package traces with
XLA while loops: there is no Pallas kernel to port, and H1 replaces none).

Both trees become one row layout (``node_rows``), so one walk serves both
``bvh_mode``s.  A node is one [16] f32 row: both children's boxes (left
min xyz, left max xyz, right min xyz, right max xyz, the JAX rows' cols
0:12 but for the implicit tree's empty boxes), both child links bitcast
to float in cols 12:14 (the SAH builder's own; the implicit heap's
2i + 1 and 2i + 2, a heap leaf becoming the run of ``leaf_size`` rows it
holds), and each child box's reach, its largest |coordinate|, in cols
14:16 (zero in the JAX rows).  A link below 0 is a
leaf, -(1 + (first << 5 | count)), over the soup permuted into the tree's
order (models/bvh_build.permute_soup), so a triangle's id is its row.

The walk is the port's (csrc/tri_tree.cuh): from the root link, both
children's boxes slab-tested, each widened for the ray by (|o|_inf +
reach) 2^-18, pruned at ``best_t * 1.0001 + 1e-4``, the nearer of two that
pass walked and the other pushed with its entry t, re-tested when popped;
a leaf's triangles tested with the dense sweep's Moller-Trumbore
operations; a hit kept as the lexicographic minimum of (t, id).  The
tree's boxes bound each triangle over the whole shutter
(models/bvh_build.world_triangle_bounds) and the widening covers their
rounding against the batch's world triangles, so the dense sweep's winner
is always visited and the walk gives the dense sweep's bits over the same
soup, in any order.  The JAX traversals keep the first hit found at equal
t instead, which differs only on exact ties.

``intersect_tris_bvh`` is the entry point: for tensors on the CPU it runs
``bvh_walk_reference``; for CUDA tensors it launches the kernel, or
raises.  ``LAUNCHES`` counts kernel launches.
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
# more entries is refused.  The mesh scene's SAH tree is 26 deep.
MAX_STACK = 64
# A leaf's count has 5 bits and its first row the other 26.
MAX_LEAF = 31
MAX_ROWS = 1 << 26


class BVHTree(NamedTuple):
    """The node rows the walk reads (``node_rows``), on the soup's device."""

    nodes: torch.Tensor   # [N, 16] f32, at least one row
    root: int             # the root link (a leaf link for a one-leaf tree)
    stack_depth: int      # the stack the walk may need: the depth + 2
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


# ------------------------------------------------------------ plain version

def bvh_walk_reference(o: V3, d: V3, table12: torch.Tensor, tree: BVHTree,
                       active: torch.Tensor):
    """The plain version of the kernel: the same walk, vectorised over the
    rays that still walk, a step at a time (an internal node's two box
    tests and push, or a leaf's triangles, then the pops), with the
    kernel's operations.  Returns (t, id, u, v): (T_MAX, -1, 0, 0) on a
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
    links = tree.nodes[:, 12:14].contiguous().view(torch.int32).long()
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
            r, lk = ray[ii], link[ii]
            rows = tree.nodes[lk]
            o3 = tuple(x[r] for x in o)
            ri = tuple(x[r] for x in iv3)
            b = bt[r]
            hl, tl = _slab(o3, ri, rows[:, 0:6], b, 3,
                           (o_inf[r] + rows[:, 14]) * TREE_ROUNDING, True)
            hr, tr = _slab(o3, ri, rows[:, 6:12], b, 3,
                           (o_inf[r] + rows[:, 15]) * TREE_ROUNDING, True)
            l0, l1 = links[lk, 0], links[lk, 1]
            both = hl & hr
            left_first = tl <= tr
            pb = ii[both]
            if pb.numel():
                if int(sp[pb].max()) >= tree.stack_depth:
                    raise ValueError("the walk outgrew its stack: the tree "
                                     "is deeper than its stack_depth")
                stack[pb, sp[pb]] = torch.where(left_first, l1, l0)[both]
                stack_te[pb, sp[pb]] = torch.where(left_first, tr, tl)[both]
                sp[pb] += 1
            go = hl | hr
            nxt = torch.where(both, torch.where(left_first, l0, l1),
                              torch.where(hl, l0, l1))
            link[ii[go]] = nxt[go]
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
    (ops/paged_tri.tree_work's convention): the internal nodes whose two
    child boxes it must test (the root, and every node reached from it
    through boxes that pass against ``best_t``) and the triangles of every
    leaf so reached.  No walk of the tree that proves ``best_t`` does
    less.  Returns Python ints: ``rays``, ``node_tests`` (two box tests
    each), ``tri_tests``, and the distinct rows those read, ``nodes_read``
    and ``tris_read``."""
    iv3 = tuple(_inv(x) for x in d)
    o_inf = torch.maximum(torch.maximum(o.x.abs(), o.y.abs()), o.z.abs())
    links = tree.nodes[:, 12:14].contiguous().view(torch.int32).long()
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
        rows = tree.nodes[lk]
        o3 = tuple(x[r] for x in o)
        ri = tuple(x[r] for x in iv3)
        b = best_t[r]
        hl = _slab(o3, ri, rows[:, 0:6], b, 3,
                   (o_inf[r] + rows[:, 14]) * TREE_ROUNDING)
        hr = _slab(o3, ri, rows[:, 6:12], b, 3,
                   (o_inf[r] + rows[:, 15]) * TREE_ROUNDING)
        ray = torch.cat([r[hl], r[hr]])
        link = torch.cat([links[lk, 0][hl], links[lk, 1][hr]])
    reached = torch.unique(torch.cat(leaves)) if leaves else link
    work["nodes_read"] = int(seen.sum())
    work["tris_read"] = int((-(reached + 1) & 31).sum())
    return work


# ------------------------------------------------------------------- kernel

def check_tree(tree: BVHTree, table12: torch.Tensor, device) -> None:
    """The tree against its table, the kernel's stack and leaf links."""
    nodes = tree.nodes
    if (nodes.dtype != torch.float32 or nodes.dim() != 2
            or nodes.shape[1] != 16 or nodes.shape[0] < 1
            or nodes.device != device or not nodes.is_contiguous()):
        raise ValueError("tree.nodes must be a contiguous float32 [N, 16] "
                         "tensor (N >= 1) on the rays' device")
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
    A soup with no triangle launches nothing."""
    global LAUNCHES
    _check_rays(o, d, active)
    device = o.x.device
    check_tree(tree, table12, device)
    R = o.x.shape[0]
    if device.type == "cpu" or tree.num_tris == 0:
        return Hit(*bvh_walk_reference(o, d, table12, tree, active))
    if device.type != "cuda":
        raise ValueError(f"no BVH walk for device {device}")
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
