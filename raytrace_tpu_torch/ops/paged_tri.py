"""Closest hit over any number of triangles: the CUDA kernel
``csrc/paged_tri.cu`` (K3) and its plain PyTorch versions (counterpart of
raytrace_tpu/ops/pallas_paged_tri.py).

The soup is put in Morton order of its world-space centroids once
(``paged_tri_order``, on the host).  The kernel walks an implicit binary
tree over that order (``build_tri_tree``): a leaf is ``LEAF`` contiguous
triangles, an internal node the exact union of its two children, and
every node stores both children's boxes in one 64-byte row.  A ray tests
both children of a node, descends into the nearer one that passes and
keeps the other on a stack; at a leaf it runs the dense sweep's
Moller-Trumbore operations (ops/tri_sweep.py) and keeps the
lexicographic minimum of (t, id).  A box is skipped when the ray enters
it at or beyond ``best_t * 1.0001 + 1e-4``, and the boxes are widened, so
no skipped triangle can hold the closest hit: the result is the dense
sweep's over the same soup, bit for bit (the lowest id on ties), in
whatever order the walk visits the leaves.

The TPU kernel's flat walk (pages of ``PAGE_C`` clusters of ``TRI_G``
triangles, ``build_page_tables``) stays as a plain version,
``paged_tri_sweep_reference``, which holds the port to the TPU kernel;
``visit_counts`` counts its work beside ``tree_visit_counts``.

The fused kernel K4 walks the same tree in its triangle forms
(csrc/tri_tree.cuh, shared by both kernels), over a soup that keeps its
compiled order: ``build_soup_tree`` builds the tree over a Morton-permuted
copy of the soup (``soup_order``) with a slot -> id table (``TriTree.ids``),
and ``tri_tree_sweep_reference`` with that table and a seed hit is the
plain version of K4's walk.

``intersect_tris_paged`` is the one entry point.  Given a ``TriTree``, for
tensors on the CPU it runs ``tri_tree_sweep_reference``; for CUDA tensors
it launches the kernel on the current stream, or raises.  Given
``PageTables`` (on the CPU only) it runs the flat plain version.
``LAUNCHES`` counts kernel launches.

The TPU kernel's lane-gather layout (``pageG``), its powers-of-two mask
packing (``tw``) and its row relayouts are TPU mechanisms and have no
counterpart here.  Its cap of 512 ray blocks a dispatch is not carried
over: the kernel takes any number of rays.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.bvh_build import _instance_matrix_at
from . import _build, megakernel, tri_sweep
from .megakernel import _BIGF
from .intersect import T_MAX, T_MIN, Hit
from .vec3 import V3

LAUNCHES = 0

LEAF = 4        # triangles per leaf of the tree (chosen on the card: PERF.md)
MAX_DEPTH = 24  # the kernel's stack (csrc/paged_tri.cu kStack)
# The fused kernel's soup trees (soup_leaf): leaves of SOUP_LEAF triangles,
# and one leaf holding the whole soup up to SOUP_FLAT_MAX triangles, where
# the walk's node tests cost more than they save.  Both chosen on the card
# over soups of 17 to 15,360 triangles (PERF.md §6): leaves of 2 were the
# fastest from 48 triangles up, one leaf at 17 and 36 and 8% slower at 48.
SOUP_LEAF = 2
SOUP_FLAT_MAX = 40
# A node's box is widened for each ray by (|o|_inf + reach) TREE_ROUNDING,
# reach the box's largest |coordinate|, against the rounding of the
# Moller-Trumbore test and the slab test far from the origin.
TREE_ROUNDING = 2.0 ** -18
TRI_G = 128    # triangles per cluster
PAGE_C = 128   # clusters per page
_BIG = 3e38    # min/max seed over a cluster's vertices
_SLAB_EPS = 1e-30  # the slab test keeps |d| at least this in 1 / d
# Elements of one [pairs, g] temporary in the plain version (64 MiB of f32).
_CHUNK_ELEMS = 1 << 24


# ---------------------------------------------------------------- host side

def paged_tri_order(world_p: np.ndarray, num_real: int) -> np.ndarray:
    """Morton permutation of the real triangles by their world-space
    centroids, in f64, stable on equal codes
    (raytrace_tpu/ops/pallas_paged_tri.py:57)."""
    v = np.asarray(world_p[:num_real], np.float64)          # [n,3,3]
    c = v.mean(axis=1)                                      # [n,3]
    lo = c.min(axis=0)
    ext = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip(((c - lo) / ext) * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = ((spread(q[:, 0]) << np.uint64(2))
            | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2]))
    return np.argsort(code, kind="stable").astype(np.int64)


def world_soup_mid(cs) -> np.ndarray:
    """The real triangles in world space at shutter time 0.5, f64 on the
    host: the time the order is taken at
    (raytrace_tpu/ops/pallas_paged_tri.py:82)."""
    n = cs.num_triangles
    mats = _instance_matrix_at(cs.inst_t0, cs.inst_t1, 0.5)  # [I,3,4] f64
    tp = np.asarray(cs.tri_p[:n], np.float64)
    m = mats[np.asarray(cs.tri_inst[:n], np.int64)]
    return np.einsum("tij,tvj->tvi", m[:, :, :3], tp) + m[:, None, :, 3]


def num_pages(num_tris: int, g: int = TRI_G, c: int = PAGE_C) -> int:
    return max(1, -(-num_tris // (g * c)))


class PageTables(NamedTuple):
    """One soup's tables for the paged sweep, on the soup's device."""

    tris: torch.Tensor        # [T8, 12] (v0, valid), (e1, 0), (e2, 0)
    boxes: torch.Tensor       # [n_clusters, 8] (min xyz, 0, max xyz, 0)
    page_boxes: torch.Tensor  # [NP, 8] the same, over each page's clusters
    num_tris: int             # the real triangles (rows past it are padding)
    g: int                    # triangles per cluster
    c: int                    # clusters per page


def build_page_tables(world_p: torch.Tensor, num_real: int,
                      tris: Optional[torch.Tensor] = None, g: int = TRI_G,
                      c: int = PAGE_C) -> PageTables:
    """The tables of a [T, 3, 3] world soup whose first ``num_real`` rows
    are its triangles.  ``tris`` is the soup's [T8, 12] table
    (ops/megakernel.tri_table12), built here when not given.  A cluster's
    box spans its triangles' world vertices, widened by
    1e-5 + 1e-5 max(|min|, |max|) in f32, as
    raytrace_tpu/ops/pallas_paged_tri.py:159-169 computes it; a page's box
    is the exact min and max of its clusters' boxes.  Only the real
    clusters get a box: the kernel never reads past them."""
    if num_real < 1:
        raise ValueError("a paged soup needs at least one triangle")
    if tris is None:
        tris = megakernel.tri_table12(tri_sweep.pack_tri_table(world_p,
                                                               num_real))
    n_clusters = -(-num_real // g)
    NP = num_pages(num_real, g, c)
    dev = world_p.device
    v = torch.zeros((n_clusters * g, 3, 3), dtype=torch.float32, device=dev)
    v[:num_real] = world_p[:num_real]
    real = (torch.arange(n_clusters * g, device=dev) < num_real).reshape(
        n_clusters, g, 1, 1)
    v = v.reshape(n_clusters, g, 3, 3)
    mn = torch.where(real, v, _BIG).amin(dim=(1, 2))          # [C, 3]
    mx = torch.where(real, v, -_BIG).amax(dim=(1, 2))
    pad = 1e-5 + 1e-5 * torch.maximum(mn.abs(), mx.abs())
    boxes = torch.zeros((n_clusters, 8), dtype=torch.float32, device=dev)
    boxes[:, 0:3] = mn - pad
    boxes[:, 4:7] = mx + pad
    full = torch.zeros((NP * c, 8), dtype=torch.float32, device=dev)
    full[:, 0:3] = _BIG
    full[:, 4:7] = -_BIG
    full[:n_clusters] = boxes
    full = full.reshape(NP, c, 8)
    page_boxes = torch.zeros((NP, 8), dtype=torch.float32, device=dev)
    page_boxes[:, 0:3] = full[:, :, 0:3].amin(dim=1)
    page_boxes[:, 4:7] = full[:, :, 4:7].amax(dim=1)
    return PageTables(tris=tris, boxes=boxes, page_boxes=page_boxes,
                      num_tris=int(num_real), g=int(g), c=int(c))


class TriTree(NamedTuple):
    """One soup's implicit binary tree for the kernel, on the soup's
    device.  Node n has children 2n + 1 and 2n + 2; leaf k is node
    K - 1 + k and holds the triangle rows [k leaf, (k + 1) leaf).  K3's
    soup is in the tree's order, so a row's slot is its id; K4's keeps its
    own order, and ``ids`` maps each slot to its triangle's id."""

    tris: torch.Tensor   # [T8, 12] (v0, valid), (e1, 0), (e2, 0)
    # [K - 1, 16] each internal node's children's boxes: left min xyz,
    # left max xyz, right min xyz, right max xyz, four zeros
    nodes: torch.Tensor
    num_tris: int        # the real triangles (rows past it are padding)
    leaf: int            # triangles per leaf
    depth: int           # log2 K, K leaves
    # [num_tris] int32 each slot's triangle id (build_soup_tree), or None
    # where the slot is the id (build_tri_tree)
    ids: Optional[torch.Tensor] = None


def leaf_boxes(world_p: torch.Tensor, num_real: int,
               leaf: int = LEAF) -> torch.Tensor:
    """[K, 6] boxes (min xyz, max xyz) of the soup's leaves of ``leaf``
    triangles, K the next power of two of their count.  A real leaf's box
    spans its triangles' world vertices, widened as ``build_page_tables``
    widens a cluster's (so it lies inside its cluster's box); a padding
    leaf's is (+BIG, -BIG), the identity of the union."""
    n_leaves = -(-num_real // leaf)
    K = 1 << (n_leaves - 1).bit_length()
    dev = world_p.device
    v = torch.zeros((K * leaf, 3, 3), dtype=torch.float32, device=dev)
    v[:num_real] = world_p[:num_real]
    real = (torch.arange(K * leaf, device=dev) < num_real).reshape(
        K, leaf, 1, 1)
    v = v.reshape(K, leaf, 3, 3)
    mn = torch.where(real, v, _BIG).amin(dim=(1, 2))          # [K, 3]
    mx = torch.where(real, v, -_BIG).amax(dim=(1, 2))
    pad = 1e-5 + 1e-5 * torch.maximum(mn.abs(), mx.abs())
    boxes = torch.cat([mn - pad, mx + pad], dim=1)
    boxes[n_leaves:, :3] = _BIG
    boxes[n_leaves:, 3:] = -_BIG
    return boxes


def build_tri_tree(world_p: torch.Tensor, num_real: int,
                   tris: Optional[torch.Tensor] = None,
                   leaf: int = LEAF) -> TriTree:
    """The tree of a [T, 3, 3] world soup in Morton order whose first
    ``num_real`` rows are its triangles, built level by level on the
    soup's device (raytrace_tpu/models/bvh_build.py:120-182 ``build_bvh``'s
    loop over ``leaf_boxes``).  An internal node's box is the exact union
    of its children's; a box that holds no real triangle is stored as the
    point (BIG, BIG, BIG), which the slab test never passes.  ``tris`` is
    the soup's [T8, 12] table (ops/megakernel.tri_table12), built here
    when not given.  A moving soup is re-fitted by building again from
    the batch's world soup: the order, and so the tree's shape, stay."""
    if num_real < 1:
        raise ValueError("a paged soup needs at least one triangle")
    if tris is None:
        tris = megakernel.tri_table12(tri_sweep.pack_tri_table(world_p,
                                                               num_real))
    levels = [leaf_boxes(world_p, num_real, leaf)]
    while levels[-1].shape[0] > 1:
        pair = levels[-1].reshape(-1, 2, 6)
        levels.append(torch.cat([pair[:, :, :3].amin(dim=1),
                                 pair[:, :, 3:].amax(dim=1)], dim=1))
    heap = torch.cat(levels[::-1])                  # [2K - 1, 6] node n's
    empty = (heap[:, :3] > heap[:, 3:]).any(dim=1, keepdim=True)
    heap = torch.where(empty, _BIGF, heap)
    K = levels[0].shape[0]
    nodes = torch.zeros((K - 1, 16), dtype=torch.float32,
                        device=world_p.device)
    nodes[:, :12] = heap[1:].reshape(K - 1, 12)
    reach = torch.where(empty, 0.0, heap.abs().amax(dim=1, keepdim=True))
    nodes[:, 12:14] = reach[1:].reshape(K - 1, 2)
    return TriTree(tris=tris, nodes=nodes, num_tris=int(num_real),
                   leaf=int(leaf), depth=len(levels) - 1)


def soup_order(world_p: torch.Tensor, num_real: int) -> torch.Tensor:
    """[num_real] int32 on the soup's device: the Morton order of a [T, 3,
    3] world soup's first ``num_real`` triangles (``paged_tri_order``, on
    the host, once per soup), the slot -> id table of ``build_soup_tree``."""
    order = paged_tri_order(world_p[:num_real].double().cpu().numpy(),
                            num_real)
    return torch.tensor(order, dtype=torch.int32, device=world_p.device)


def soup_leaf(num_real: int) -> int:
    """Triangles per leaf of the fused kernel's tree over a soup of
    ``num_real``: SOUP_LEAF, or the whole soup as one leaf (the flat
    sweep, no node test) up to SOUP_FLAT_MAX."""
    return num_real if num_real <= SOUP_FLAT_MAX else SOUP_LEAF


def build_soup_tree(world_p: torch.Tensor, num_real: int,
                    table12: torch.Tensor, ids: torch.Tensor,
                    leaf: Optional[int] = None) -> TriTree:
    """The tree K4 walks over a soup that keeps its own order: the rows of
    ``table12`` (the soup's [T8, 12] table, ops/megakernel.tri_table12) and
    of the [T, 3, 3] world soup permuted by ``ids`` (``soup_order``), the
    tree built over them (``build_tri_tree``), and ``ids`` kept as the
    slot -> id table.  A moving soup keeps its ids and is re-fitted by
    building again from the batch's world soup."""
    if ids.dtype != torch.int32 or ids.shape != (num_real,):
        raise ValueError(f"ids must be an int32 [{num_real}] permutation of "
                         f"the soup's triangles")
    take = ids.long()
    tree = build_tri_tree(world_p[take], num_real, table12[take],
                          soup_leaf(num_real) if leaf is None else leaf)
    return tree._replace(ids=ids)


# ------------------------------------------------------------ plain version

def _inv(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(x.abs() < _SLAB_EPS,
                             torch.where(x < 0.0, -_SLAB_EPS, _SLAB_EPS), x)


def _slab(o3, iv3, boxes: torch.Tensor, best_t: torch.Tensor, hi: int = 4,
          margin=None, enter: bool = False):
    """The slab test of rays (o3, iv3: three [..] tensors) against boxes
    ([.., 8] with the max at column 4, or [.., 6] with ``hi`` 3; broadcast
    against the rays), pruned by each ray's best t
    (raytrace_tpu/ops/pallas_paged_tri.py:226-236, :241-251); each box
    first widened by ``margin`` where one is given.  With ``enter`` it
    returns the entry t beside the mask."""
    te = tx = None
    for ax in range(3):
        lo, up = boxes[..., ax], boxes[..., hi + ax]
        if margin is not None:
            lo, up = lo - margin, up + margin
        a0 = (lo - o3[ax]) * iv3[ax]
        a1 = (up - o3[ax]) * iv3[ax]
        tn, tf = torch.minimum(a0, a1), torch.maximum(a0, a1)
        te = tn if te is None else torch.maximum(te, tn)
        tx = tf if tx is None else torch.minimum(tx, tf)
    hit = (te <= tx) & (tx > T_MIN) & (te < best_t * 1.0001 + 1e-4)
    return (hit, te) if enter else hit


def _cluster_hits(o3, d3, tris: torch.Tensor, tri_ids: torch.Tensor,
                  num_tris: int):
    """Moller-Trumbore of K rays (o3, d3: three [K, 1] tensors) against
    their clusters' triangles (tri_ids [K, g]), in the operation order of
    ops/tri_sweep.tri_sweep_reference.  Returns (t, u, v) [K, g], t T_MAX
    where there is no hit (and on the ids at or past ``num_tris``)."""
    rows = tris[tri_ids.clamp(max=tris.shape[0] - 1)]         # [K, g, 12]
    v0x, v0y, v0z = rows[..., 0], rows[..., 1], rows[..., 2]
    e1x, e1y, e1z = rows[..., 4], rows[..., 5], rows[..., 6]
    e2x, e2y, e2z = rows[..., 8], rows[..., 9], rows[..., 10]
    (ox, oy, oz), (dx, dy, dz) = o3, d3
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(det != 0.0,
                          1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((tri_ids < num_tris) & (det != 0.0) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > T_MIN) & (t < T_MAX))
    return torch.where(ok, t, T_MAX), u, v


def paged_tri_sweep_reference(o: V3, d: V3, tables: PageTables,
                              active: Optional[torch.Tensor] = None):
    """The plain version of the kernel, as the TPU kernel computes it: for
    each page in ascending order, the page-box gate against each ray's
    best t, then the cluster-box pretest against the best t at the page's
    start, then the triangles of every cluster that passes.  Within a page
    the closest of those hits wins, the lowest id on ties, and it replaces
    the best hit only when strictly closer, which is what visiting the
    clusters in ascending id with a strict ``<`` gives.  Returns (t, id,
    u, v); (T_MAX, -1, 0, 0) on a miss and for inactive rays."""
    R = o.x.shape[0]
    dev = o.x.device
    g, c = tables.g, tables.c
    n_clusters = tables.boxes.shape[0]
    bt = torch.full((R,), T_MAX, dtype=torch.float32, device=dev)
    bid = torch.full((R,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(R, dtype=torch.float32, device=dev)
    bv = torch.zeros(R, dtype=torch.float32, device=dev)
    live = (torch.ones(R, dtype=torch.bool, device=dev) if active is None
            else active)
    iv3 = tuple(_inv(x) for x in d)
    lane = torch.arange(g, device=dev)
    for p in range(tables.page_boxes.shape[0]):
        rays = torch.nonzero(
            live & _slab(tuple(o), iv3, tables.page_boxes[p], bt)).squeeze(1)
        if rays.numel() == 0:
            continue
        c0, c1 = p * c, min((p + 1) * c, n_clusters)
        boxes = tables.boxes[c0:c1]
        # The page's hits land in these after the pretest against the
        # page's starting best t.
        page_t = bt[rays]
        page_id = bid[rays]
        page_u, page_v = bu[rays], bv[rays]
        step = max(1, _CHUNK_ELEMS // max(boxes.shape[0], g))
        for r0 in range(0, rays.numel(), step):
            rr = rays[r0:r0 + step]
            sel = _slab(tuple(x[rr][:, None] for x in o),
                        tuple(x[rr][:, None] for x in iv3), boxes[None],
                        bt[rr][:, None])                      # [r, C]
            # (ray, cluster) pairs, ray-major, each ray's clusters ascending
            ri, ci = torch.nonzero(sel, as_tuple=True)
            for k0 in range(0, ri.numel(), step):
                kr, kc = ri[k0:k0 + step], ci[k0:k0 + step]
                ray = rr[kr]
                ids = (c0 + kc)[:, None] * g + lane           # [K, g]
                t, u, v = _cluster_hits(
                    tuple(x[ray][:, None] for x in o),
                    tuple(x[ray][:, None] for x in d), tables.tris, ids,
                    tables.num_tris)
                tk, arg = torch.min(t, dim=1)   # the first minimum
                idk = ids.gather(1, arg[:, None])[:, 0]
                # Each ray's closest hit among these pairs, then its lowest
                # id; a later chunk holds only higher ids of a ray, so it
                # takes over only when strictly closer.
                n = rr.numel()
                lt = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
                lt.scatter_reduce_(0, kr, tk, "amin")
                near = tk == lt[kr]
                li = torch.full((n,), np.iinfo(np.int64).max,
                                dtype=torch.int64, device=dev)
                li.scatter_reduce_(0, kr[near], idk[near], "amin")
                won = near & (idk == li[kr])
                lu = torch.zeros(n, dtype=torch.float32, device=dev)
                lv = torch.zeros(n, dtype=torch.float32, device=dev)
                lu[kr[won]] = u.gather(1, arg[:, None])[:, 0][won]
                lv[kr[won]] = v.gather(1, arg[:, None])[:, 0][won]
                s = slice(r0, r0 + n)
                upd = lt < page_t[s]
                page_t[s] = torch.where(upd, lt, page_t[s])
                page_id[s] = torch.where(upd, li.to(torch.int32), page_id[s])
                page_u[s] = torch.where(upd, lu, page_u[s])
                page_v[s] = torch.where(upd, lv, page_v[s])
        bt[rays], bid[rays] = page_t, page_id
        bu[rays], bv[rays] = page_u, page_v
    return bt, bid, bu, bv


def visit_counts(o: V3, d: V3, tables: PageTables, best_t: torch.Tensor,
                 active: torch.Tensor) -> dict:
    """The work of the sweep's traversal for rays whose closest hit is
    ``best_t``: every active ray tests every page box; the real clusters of
    each page whose box passes against ``best_t``; the real triangles of
    each such cluster whose box passes too.  Any traversal that proves
    ``best_t`` does at least this (a bound counts it).  Returns Python
    ints: ``rays``, ``page_tests``, ``cluster_tests``, ``tri_tests``."""
    dev = o.x.device
    g, c = tables.g, tables.c
    n_clusters = tables.boxes.shape[0]
    sizes = (tables.num_tris - g * torch.arange(n_clusters, device=dev)
             ).clamp(0, g)
    iv3 = tuple(_inv(x) for x in d)
    n = int(active.sum())
    out = dict(rays=n, page_tests=n * tables.page_boxes.shape[0],
               cluster_tests=0, tri_tests=0)
    for p in range(tables.page_boxes.shape[0]):
        rays = torch.nonzero(active & _slab(
            tuple(o), iv3, tables.page_boxes[p], best_t)).squeeze(1)
        c0, c1 = p * c, min((p + 1) * c, n_clusters)
        out["cluster_tests"] += rays.numel() * (c1 - c0)
        step = max(1, _CHUNK_ELEMS // (c1 - c0))
        for r0 in range(0, rays.numel(), step):
            rr = rays[r0:r0 + step]
            sel = _slab(tuple(x[rr][:, None] for x in o),
                        tuple(x[rr][:, None] for x in iv3),
                        tables.boxes[None, c0:c1], best_t[rr][:, None])
            out["tri_tests"] += int((sel * sizes[c0:c1]).sum())
    return out


# Rays a chunk of the tree's plain versions, and the levels of the
# subtrees they walk one after another (a ray's best t prunes the later
# subtrees' boxes).
_RAY_STEP = 1 << 18
_SUBTREE_LEVELS = 11
_NO_ID = np.iinfo(np.int64).max


def tri_margins(o3):
    """The triangle tree's rounding margins: each child box of a node row
    widened by (|o|_inf + reach) TREE_ROUNDING, reach in columns 12:14.
    Returns margins(rows, ray) -> (left, right), as ``_descend`` takes."""
    o_inf = torch.maximum(torch.maximum(o3[0].abs(), o3[1].abs()),
                          o3[2].abs())

    def margins(rows, ray):
        far = o_inf[ray]
        return ((far + rows[:, 12]) * TREE_ROUNDING,
                (far + rows[:, 13]) * TREE_ROUNDING)
    return margins


def _descend(o3, iv3, tree, ray, node, level: int, bt, margins, work=None):
    """(ray, node) pairs at ``level`` walked to the leaves: at each level
    both children's boxes of every pair's node, widened by ``margins``
    (``tri_margins``; ops/sphere_tree.py has the spheres'), are tested
    against the ray's best t and the pairs of the children that pass go
    on.  ``tree`` is any implicit tree with ``nodes`` rows (both children's
    boxes in columns 0:12) and a ``depth``.  Returns (ray, leaf index)
    pairs; counts the nodes tested in ``work``."""
    for _ in range(level, tree.depth):
        if work is not None:
            work["node_tests"] += ray.numel()
            work["seen"][node] = True
        rows = tree.nodes[node]
        ro, ri = (tuple(x[ray] for x in v) for v in (o3, iv3))
        b = bt[ray]
        ml, mr = margins(rows, ray)
        hit_l = _slab(ro, ri, rows[:, 0:6], b, 3, ml)
        hit_r = _slab(ro, ri, rows[:, 6:12], b, 3, mr)
        ray = torch.cat([ray[hit_l], ray[hit_r]])
        node = torch.cat([2 * node[hit_l] + 1, 2 * node[hit_r] + 2])
    return ray, node - ((1 << tree.depth) - 1)


def walk_reference(o3, iv3, tree, rays, bt, margins, on_leaves) -> None:
    """The plain walk of an implicit tree over the rays ``rays`` (indices),
    each (ray, node) pair pruned by its ray's best t ``bt``.  The rays walk
    in chunks; each chunk walks to the roots of the subtrees of
    ``_SUBTREE_LEVELS`` levels, then through those subtrees one after
    another in ascending order, handing each subtree's (ray, leaf) pairs
    to ``on_leaves``, which updates ``bt`` in place, so the best t found in
    one subtree prunes the next."""
    top = max(0, tree.depth - _SUBTREE_LEVELS)
    for r0 in range(0, rays.numel(), _RAY_STEP):
        rr = rays[r0:r0 + _RAY_STEP]
        ray, sub = _descend(o3, iv3, tree._replace(depth=top), rr,
                            torch.zeros_like(rr), 0, bt, margins)
        for k in torch.unique(sub).tolist():
            root = (1 << top) - 1 + k
            ray_k, leaf = _descend(o3, iv3, tree, ray[sub == k],
                                   torch.full_like(ray[sub == k], root),
                                   top, bt, margins)
            on_leaves(ray_k, leaf)


def merge_hits(best, kr, t, gid, u=None, v=None) -> None:
    """Merge the hits of (ray, leaf) pairs into ``best`` = [t, id] (or
    [t, id, u, v]), in place, as the lexicographic minimum of (t, id) per
    ray: ``kr`` [K] each pair's ray, ``t`` and ``gid`` (int64) [K, L] each
    pair's primitives' t (T_MAX for no hit) and ids, ``u`` and ``v`` their
    barycentrics where ``best`` keeps them."""
    bt, bid = best[0], best[1]
    tk = t.amin(dim=1)
    # Each pair's lowest id at its closest t.
    idk, arg = torch.min(torch.where((t == tk[:, None]) & (t < T_MAX),
                                     gid, _NO_ID), dim=1)
    lt = bt.clone()
    lt.scatter_reduce_(0, kr, tk, "amin")
    near = tk == lt[kr]
    li = torch.where((bt == lt) & (bid >= 0), bid.long(), _NO_ID)
    li.scatter_reduce_(0, kr[near], idk[near], "amin")
    if u is not None:
        won = near & (idk == li[kr]) & (tk < T_MAX)
        best[2][kr[won]] = u.gather(1, arg[:, None])[:, 0][won]
        best[3][kr[won]] = v.gather(1, arg[:, None])[:, 0][won]
    bt.copy_(lt)
    bid.copy_(torch.where(li != _NO_ID, li, bid.long()).int())


def _leaf_hits(o: V3, d: V3, tree: TriTree, ray, leaf, best,
               id_base: int) -> None:
    """The triangles of (ray, leaf) pairs, merged into ``best`` = [t, id,
    u, v] (in place, ``merge_hits``); a triangle's id is its slot, or
    ``id_base`` + ``tree.ids[slot]``."""
    L = tree.leaf
    lane = torch.arange(L, device=ray.device)
    step = max(1, _CHUNK_ELEMS // L)
    for k0 in range(0, ray.numel(), step):
        kr, kl = ray[k0:k0 + step], leaf[k0:k0 + step]
        slots = kl[:, None] * L + lane                        # [K, L]
        t, u, v = _cluster_hits(tuple(x[kr][:, None] for x in o),
                                tuple(x[kr][:, None] for x in d), tree.tris,
                                slots, tree.num_tris)
        gid = slots
        if tree.ids is not None:
            gid = id_base + tree.ids[slots.clamp(max=tree.num_tris - 1)].long()
        merge_hits(best, kr, t, gid, u, v)


def tri_tree_sweep_reference(o: V3, d: V3, tree: TriTree,
                             active: Optional[torch.Tensor] = None,
                             seed=None, id_base: int = 0):
    """The plain version of the kernel: the same tree walked level by
    level over (ray, node) pairs, each pair pruned by its ray's best t
    (``walk_reference``).  At the leaves each ray keeps the lexicographic
    minimum of (t, id), so any order of the walk gives the kernel's bits.
    A triangle's id is its slot, or with an id table ``id_base`` +
    ``tree.ids[slot]``.  ``seed`` (t [R] f32, id [R] int32) is each ray's
    best hit before the walk (K4's sphere sweep, whose ids are below
    ``id_base``), kept with u = v = 0 where no triangle beats it, and by
    inactive rays; without one (T_MAX, -1).  Returns (t, id, u, v)."""
    R = o.x.shape[0]
    dev = o.x.device
    if seed is None:
        seed = (torch.full((R,), T_MAX, dtype=torch.float32, device=dev),
                torch.full((R,), -1, dtype=torch.int32, device=dev))
    best = [seed[0].clone(), seed[1].clone(),
            torch.zeros(R, dtype=torch.float32, device=dev),
            torch.zeros(R, dtype=torch.float32, device=dev)]
    live = (torch.ones(R, dtype=torch.bool, device=dev) if active is None
            else active)
    walk_reference(tuple(o), tuple(_inv(x) for x in d), tree,
                   torch.nonzero(live).squeeze(1), best[0], tri_margins(o),
                   lambda ray, leaf: _leaf_hits(o, d, tree, ray, leaf, best,
                                                id_base))
    return tuple(best)


def tree_work(o3, iv3, tree, rays, best_t, margins, leaf_sizes) -> dict:
    """The work of a tree walk for rays (indices ``rays``) whose closest
    hit is ``best_t``: the internal nodes whose two child boxes a walk
    must test (the root, and every node whose box and its ancestors' pass
    against ``best_t``) and the real primitives of every leaf reached so
    (``leaf_sizes(leaf)``).  No walk of the tree that proves ``best_t``
    does less.  Returns Python ints: ``rays``, ``node_tests`` (two box
    tests each), ``leaf_tests``, and the distinct rows those read,
    ``nodes_read`` and ``leaf_read``."""
    K = 1 << tree.depth
    work = dict(rays=rays.numel(), node_tests=0, leaf_tests=0,
                seen=torch.zeros(K, dtype=torch.bool, device=rays.device))
    reached = torch.zeros(K, dtype=torch.bool, device=rays.device)
    for r0 in range(0, rays.numel(), _RAY_STEP):
        rr = rays[r0:r0 + _RAY_STEP]
        _, leaf = _descend(o3, iv3, tree, rr, torch.zeros_like(rr), 0,
                           best_t, margins, work)
        work["leaf_tests"] += int(leaf_sizes(leaf).sum())
        reached[leaf] = True
    work["nodes_read"] = int(work.pop("seen")[:K - 1].sum())
    work["leaf_read"] = int(leaf_sizes(torch.nonzero(reached)[:, 0]).sum())
    return work


def tree_visit_counts(o: V3, d: V3, tree: TriTree, best_t: torch.Tensor,
                      active: torch.Tensor) -> dict:
    """The work of the tree walk for rays whose closest hit is ``best_t``
    (``tree_work``).  Returns Python ints: ``rays``, ``node_tests`` (two
    box tests each), ``tri_tests``, and the distinct rows those read,
    ``nodes_read`` and ``tris_read``."""
    work = tree_work(tuple(o), tuple(_inv(x) for x in d), tree,
                     torch.nonzero(active).squeeze(1), best_t, tri_margins(o),
                     lambda leaf: _leaf_sizes(tree, leaf))
    work["tri_tests"] = work.pop("leaf_tests")
    work["tris_read"] = work.pop("leaf_read")
    return work


def _leaf_sizes(tree: TriTree, leaf: torch.Tensor) -> torch.Tensor:
    """The real triangles of each of the given leaves."""
    return (tree.num_tris - leaf * tree.leaf).clamp(0, tree.leaf)


# ------------------------------------------------------------------- kernel

def _check_rays(o: V3, d: V3, active) -> None:
    R = o.x.shape[0]
    device = o.x.device
    for comp in (*o, *d):
        if (comp.dtype != torch.float32 or comp.shape != (R,)
                or comp.device != device or not comp.is_contiguous()):
            raise ValueError("ray components must be contiguous float32 [R] "
                             "tensors on one device")
    if (active.dtype != torch.bool or active.shape != (R,)
            or active.device != device or not active.is_contiguous()):
        raise ValueError("active must be a contiguous bool [R] tensor on the "
                         "rays' device")


def _check_table(name, t, rows, cols, device) -> None:
    if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != cols
            or (rows is not None and t.shape[0] != rows)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"tables.{name} must be a contiguous float32 "
                         f"[{rows or 'T8'}, {cols}] tensor on the rays' "
                         f"device")


def _check_pages(tables: PageTables, device) -> None:
    n_clusters = -(-tables.num_tris // tables.g)
    NP = num_pages(tables.num_tris, tables.g, tables.c)
    for name, t, rows, cols in (
            ("tris", tables.tris, None, 12),
            ("boxes", tables.boxes, n_clusters, 8),
            ("page_boxes", tables.page_boxes, NP, 8)):
        _check_table(name, t, rows, cols, device)
    if tables.tris.shape[0] < tables.num_tris:
        raise ValueError("tables.tris has fewer rows than triangles")
    if tables.g < 1 or tables.c < 1 or NP * tables.c * tables.g >= 2 ** 31:
        raise ValueError("the paged soup must index in 32 bits")


def _check_tree(tree: TriTree, device, max_depth: int = MAX_DEPTH) -> None:
    """The tree's tables against its soup's size and the kernel's stack
    (``max_depth``), and its id table where it has one."""
    if tree.num_tris < 1 or tree.leaf < 1:
        raise ValueError("a tree needs at least one triangle and leaf size")
    n_leaves = -(-tree.num_tris // tree.leaf)
    if tree.depth != (n_leaves - 1).bit_length():
        raise ValueError(f"a tree of depth {tree.depth} does not match its "
                         f"soup of {tree.num_tris} triangles in leaves of "
                         f"{tree.leaf}")
    if tree.depth > max_depth:
        raise ValueError(f"a tree of depth {tree.depth} is deeper than the "
                         f"kernel's stack ({max_depth})")
    _check_table("tris", tree.tris, None, 12, device)
    _check_table("nodes", tree.nodes, (1 << tree.depth) - 1, 16, device)
    if tree.tris.shape[0] < tree.num_tris:
        raise ValueError("tables.tris has fewer rows than triangles")
    if (tree.leaf << tree.depth) >= 2 ** 31:
        raise ValueError("the tree's soup must index in 32 bits")
    ids = tree.ids
    if ids is not None and (
            ids.dtype != torch.int32 or ids.shape != (tree.num_tris,)
            or ids.device != device or not ids.is_contiguous()):
        raise ValueError(f"the tree's ids must be a contiguous int32 "
                         f"[{tree.num_tris}] tensor on the rays' device, one "
                         f"id a triangle row")


def intersect_tris_paged(o: V3, d: V3, tables, active: torch.Tensor) -> Hit:
    """Closest hit of rays o + t d against the soup of ``tables``, a
    ``TriTree`` (or ``PageTables``, on the CPU only); the lowest id on
    ties; inactive rays and misses give (T_MAX, -1, 0, 0)."""
    global LAUNCHES
    _check_rays(o, d, active)
    device = o.x.device
    if isinstance(tables, PageTables):
        _check_pages(tables, device)
        if device.type != "cpu":
            raise ValueError("the kernel walks a TriTree (build_tri_tree); "
                             "PageTables are for the plain version")
        return Hit(*paged_tri_sweep_reference(o, d, tables, active))
    _check_tree(tables, device)
    if tables.ids is not None:
        raise ValueError("K3 walks a soup in its tree's order; a tree with "
                         "an id table (build_soup_tree) is the fused "
                         "kernel's")
    if device.type == "cpu":
        return Hit(*tri_tree_sweep_reference(o, d, tables, active))
    if device.type != "cuda":
        raise ValueError(f"no paged triangle sweep for device {device}")
    R = o.x.shape[0]
    if R >= 2 ** 31:
        raise ValueError(f"{R} rays: the kernel indexes rays in 32 bits")
    if tables.tris.data_ptr() % 16 or tables.nodes.data_ptr() % 16:
        raise ValueError("the tree's tables must be 16-byte aligned (float4 "
                         "loads)")
    lib = library()
    t = torch.empty(R, dtype=torch.float32, device=device)
    ids = torch.empty(R, dtype=torch.int32, device=device)
    u = torch.empty(R, dtype=torch.float32, device=device)
    v = torch.empty(R, dtype=torch.float32, device=device)
    err = lib.paged_tri_launch(
        tables.tris.data_ptr(), tables.num_tris, tables.nodes.data_ptr(),
        tables.depth, tables.leaf, o.x.data_ptr(), o.y.data_ptr(),
        o.z.data_ptr(), d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
        active.data_ptr(), R, t.data_ptr(), ids.data_ptr(), u.data_ptr(),
        v.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged_tri launch failed: CUDA error {err} "
            f"({lib.paged_tri_error_string(err).decode()})")
    LAUNCHES += 1
    return Hit(t=t, tri=ids, u=u, v=v)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/ at first use."""
    lib = _build.load_library("paged_tri")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_tri_launch.argtypes = [p, i, p, i, i, p, p, p, p, p, p, p, i,
                                     p, p, p, p, p]
    lib.paged_tri_launch.restype = i
    lib.paged_tri_error_string.argtypes = [i]
    lib.paged_tri_error_string.restype = ctypes.c_char_p
    return lib
