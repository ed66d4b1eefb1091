"""The fused kernel's tree over its clustered spheres (ops/sphere_tree.py):
the tree walk's plain version against the dense sweep and the JAX
package's XLA sweep, its boxes, its work count against the flat cluster
walk's, how the Renderer builds it, and the wrapper's checks.  The CUDA
walk is held against its plain version in test_torch_cuda.py.

Tolerances: the tree walk equals the dense plain sweep
(ops/spheres.intersect_spheres_world) bit for bit in t and id, on every
ray, static and moving; against JAX's XLA ``intersect_spheres_world`` ids,
and ids with t within rtol=1e-3, atol=1e-3, each on >= 99.9% of rays (XLA
contracts multiply-adds into FMAs, torch does not).  Scenes at 32x18, 4
spp, depth 6, as test_torch_sphere_clusters.py builds them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops import spheres as jspheres
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.engine import renderer as renderer_mod
from raytrace_tpu_torch.ops import megakernel, sphere_sweep, sphere_tree
from raytrace_tpu_torch.ops import spheres
from raytrace_tpu_torch.ops.vec3 import V3
from test_torch_sphere_clusters import (AGREEMENT, ATOL, RTOL, _captured_rays,
                                        _port_cs, _random_rays, _static,
                                        _table8)

torch.set_num_threads(1)


def _tree(cs, table8, n_tree=None, leaf=None, dtab8=None):
    """The scene's tree (its first ``n_tree`` spheres past the prefix
    where given; leaves of ``leaf``, else sphere_leaf's) in the Morton
    order of the table's centres, at shutter time 0.5 when ``dtab8`` moves
    them."""
    n_prefix = megakernel.sphere_cluster_layout(_static(cs))[0]
    n = cs.num_spheres if n_tree is None else n_prefix + n_tree
    mid = table8[:, 0:3] if dtab8 is None else (table8[:, 0:3]
                                                + 0.5 * dtab8[:, 0:3])
    ids = torch.tensor(sphere_tree.sphere_order(mid.numpy(), n_prefix, n),
                       dtype=torch.int32)
    return sphere_tree.build_sphere_tree(table8, n_prefix, n, ids,
                                         dtab8=dtab8, leaf=leaf)


def _assert_dense(o, d, table8, tree, dtab8=None, t=None):
    """The tree walk equals the dense sweep over the prefix and the tree's
    spheres on every ray; returns the share of rays whose hit is in the
    tree."""
    n = tree.n_prefix + tree.num_spheres
    dense = table8 if dtab8 is None else megakernel.moved_table(table8,
                                                                dtab8, t)
    t0, id0 = sphere_sweep.sphere_sweep_reference(o, d, dense[:n])
    t1, id1 = sphere_tree.sphere_tree_sweep_reference(o, d, table8, tree,
                                                      dtab8=dtab8, t=t)
    assert torch.equal(t0, t1) and torch.equal(id0, id1)
    return (id1 >= tree.n_prefix).double().mean().item()


def _v3(a):
    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i], np.float32))
                for i in range(3)))


# ---- bit for bit with the dense sweep ---------------------------------------

@pytest.mark.parametrize("name", ["final-one-weekend", "stress-4x"])
def test_tree_walk_is_the_dense_sweep_on_the_frames_rays(name):
    cs = _port_cs(name)
    table8 = _table8(cs)
    tree = _tree(cs, table8)
    seen = _captured_rays(cs)
    assert len(seen) >= 4
    in_tree = [_assert_dense(o, d, table8, tree) for o, d, _ in seen]
    assert max(in_tree) > 0.05   # the tree's spheres are hit


@pytest.mark.parametrize("name", ["final-one-weekend", "grid-577",
                                  "stress-4x"])
def test_tree_walk_is_the_dense_sweep_on_random_rays(name):
    cs = _port_cs(name)
    table8 = _table8(cs)
    o, d, _ = _random_rays(table8, cs.num_spheres, 6000, seed=5)
    assert _assert_dense(o, d, table8, _tree(cs, table8)) > 0.2


@pytest.mark.parametrize("t", [0.0, 0.4375, 1.0])
def test_tree_walk_is_the_dense_sweep_while_spheres_move(t):
    cs = _port_cs("motion-blur")
    tab0, dtab8 = (torch.tensor(x) for x in
                   spheres.world_sphere_anim_tables(cs))
    table8 = sphere_sweep.pad_table8(tab0)
    tree = _tree(cs, table8, dtab8=dtab8)
    assert tree.drows is not None
    tt = torch.tensor(t, dtype=torch.float32)
    moved = megakernel.moved_table(table8, dtab8, tt)
    o, d, _ = _random_rays(moved, cs.num_spheres, 6000, seed=7)
    assert _assert_dense(o, d, table8, tree, dtab8, tt) > 0.2
    for o, d, _ in _captured_rays(cs)[:3]:
        _assert_dense(o, d, table8, tree, dtab8, tt)


@pytest.mark.parametrize("n_tree,leaf", [(484, 1), (484, 3), (484, 5),
                                         (484, 8), (9, 4), (1, 4)])
def test_tree_walk_is_the_dense_sweep_at_leaf_counts_not_powers_of_two(
        n_tree, leaf):
    """final-one-weekend's first ``n_tree`` spheres past the prefix in
    leaves of ``leaf``: 484, 162, 97, 61, 3 and 1 leaves, padded to the
    next power of two with empty subtrees."""
    cs = _port_cs("final-one-weekend")
    table8 = _table8(cs)
    tree = _tree(cs, table8, n_tree, leaf)
    n_leaves = -(-n_tree // leaf)
    assert tree.depth == (n_leaves - 1).bit_length()
    o, d, _ = _random_rays(table8, tree.n_prefix + n_tree, 4000, seed=13)
    _assert_dense(o, d, table8, tree)
    for o, d, _ in _captured_rays(cs)[:2]:
        _assert_dense(o, d, table8, tree)


@pytest.mark.parametrize("leaf", [1, 2, 4])
def test_equal_t_duplicates_keep_the_lowest_id(leaf):
    """Spheres repeated at other ids, the repeats put in slots before the
    originals (a reversed order) and in other leaves: every ray hits a
    repeated sphere at one t from several ids, and the walk keeps the
    lowest, as the dense sweep's strict < over ascending ids does; a
    repeat of a prefix sphere loses to the prefix."""
    g = np.random.default_rng(17)
    n_prefix, n_base, reps = 2, 12, 3
    c = np.zeros((n_prefix + n_base * reps, 3))
    r = np.zeros(n_prefix + n_base * reps)
    c[:n_prefix] = [[0.0, -1000.0, 0.0], [30.0, 2.0, 0.0]]
    r[:n_prefix] = [1000.0, 2.0]
    base = g.uniform([-8, 0.3, -8], [8, 1.0, 8], (n_base, 3))
    base[0] = c[1]                       # a repeat of the second prefix sphere
    rb = g.uniform(0.3, 0.8, n_base)
    rb[0] = r[1]
    for k in range(reps):
        c[n_prefix + k * n_base:n_prefix + (k + 1) * n_base] = base
        r[n_prefix + k * n_base:n_prefix + (k + 1) * n_base] = rb
    table = np.zeros((c.shape[0], 5))
    table[:, :3], table[:, 3] = c, r
    table[:, 4] = (c ** 2).sum(-1) - r ** 2
    table8 = sphere_sweep.pad_table8(torch.tensor(table, dtype=torch.float32))
    S = c.shape[0]
    ids = torch.arange(S - 1, n_prefix - 1, -1, dtype=torch.int32)
    tree = sphere_tree.build_sphere_tree(table8, n_prefix, S, ids, leaf=leaf)
    R = 3000
    o = g.uniform([-12, 3, -12], [12, 6, 12], (R, 3))
    aim = g.integers(0, n_base, R)
    d = base[aim] - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = _v3(o), _v3(d)
    _assert_dense(o, d, table8, tree)
    _, hit = sphere_tree.sphere_tree_sweep_reference(o, d, table8, tree)
    # A repeat never wins: its first copy (the prefix's, for sphere 0) is
    # hit at the same t with a lower id.
    first = torch.tensor(np.where(aim == 0, 1, n_prefix + aim),
                         dtype=torch.int32)
    assert (hit == first).double().mean() > 0.5
    assert (hit < n_prefix + n_base).all()


def test_rounding_margin_keeps_far_grazing_hits():
    """Rays from 200-2,000 units away grazing final-one-weekend's spheres
    past the prefix (test_torch_sphere_clusters's rays): the tree walk
    keeps every hit of the dense sweep; without the margin (the
    coefficients zeroed) it loses some."""
    cs = _port_cs("final-one-weekend")
    table8 = _table8(cs)
    tree = _tree(cs, table8)
    g = np.random.default_rng(3)
    R = 20000
    tab = table8.numpy().astype(np.float64)
    pick = g.integers(tree.n_prefix, cs.num_spheres, R)
    c, r = tab[pick, :3], tab[pick, 3:4]
    u = g.standard_normal((R, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = c + u * g.uniform(200, 2000, (R, 1))
    w = g.standard_normal((R, 3))
    w -= (w * u).sum(1, keepdims=True) * u
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    d = c + w * r * (1 + g.uniform(-2e-4, 2e-4, (R, 1))) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = _v3(o), _v3(d)
    _assert_dense(o, d, table8, tree)
    bare = tree.nodes.clone()
    bare[:, 14:16] = 0.0
    t0, id0 = sphere_sweep.sphere_sweep_reference(o, d, table8)
    t1, id1 = sphere_tree.sphere_tree_sweep_reference(
        o, d, table8, tree._replace(nodes=bare))
    assert ((t0 != t1) | (id0 != id1)).sum() > 100


# ---- the boxes --------------------------------------------------------------

@pytest.mark.parametrize("name", ["final-one-weekend", "motion-blur",
                                  "stress-4x"])
def test_each_node_holds_every_sphere_below_it(name):
    """For every sphere and every node above its leaf: the node's box
    holds the sphere's box (at shutter times 0, 0.5 and 1 when it moves),
    its reach is at least the sphere's |c| + |r| and its coefficient at
    least SPHERE_ROUNDING / r, so the node's widened box holds the
    sphere's widened box for any ray origin; boxes of empty subtrees are
    the far point."""
    cs = _port_cs(name)
    dtab8 = None
    if name == "motion-blur":
        tab0, dtab8 = (torch.tensor(x) for x in
                       spheres.world_sphere_anim_tables(cs))
        table8 = sphere_sweep.pad_table8(tab0)
    else:
        table8 = _table8(cs)
    tree = _tree(cs, table8, dtab8=dtab8)
    n = tree.num_spheres
    K = 1 << tree.depth
    slot = torch.arange(n)
    times = [0.0] if dtab8 is None else [0.0, 0.5, 1.0]
    rows = [tree.rows if dtab8 is None else megakernel.moved_table(
        tree.rows, tree.drows, torch.tensor(t)) for t in times]
    h = K - 1 + slot // tree.leaf                 # each slot's leaf node
    for _ in range(tree.depth):
        p = (h - 1) // 2
        right = (h == 2 * p + 2).long()
        node = tree.nodes[p]
        col = right * 6
        rows_n = torch.arange(n)
        lo = torch.stack([node[rows_n, col + a] for a in range(3)], 1)
        hi = torch.stack([node[rows_n, col + 3 + a] for a in range(3)], 1)
        reach = node[rows_n, 12 + right]
        coef = node[rows_n, 14 + right]
        for rw in rows:
            c, r = rw[:, 0:3], rw[:, 3:4].abs()
            assert (c - r >= lo).all() and (c + r <= hi).all()
            assert (torch.linalg.vector_norm(c, dim=1) + r[:, 0]
                    <= reach).all()
        pos = rows[0][:, 3] > 0
        assert (coef[pos] >= np.float32(megakernel.SPHERE_ROUNDING)
                / rows[0][pos, 3]).all()
        h = p
    # Subtrees over padding leaves only: the far point, no margin.
    count = (torch.arange(K) < -(-n // tree.leaf)).long()
    counts = [count]
    while count.numel() > 1:
        count = count.reshape(-1, 2).sum(1)
        counts.append(count)
    below = torch.cat(counts[::-1])[1:].reshape(-1, 2)   # each row's children
    for side in (0, 1):
        empty = tree.nodes[below[:, side] == 0]
        assert (empty[:, 6 * side:6 * side + 6] == 3e37).all()
        assert (empty[:, 12 + side] == 0).all()
        assert (empty[:, 14 + side] == 0).all()


# ---- against JAX, and the work ----------------------------------------------

def test_tree_walk_matches_jax_xla_sweep():
    cs = _port_cs("stress-4x")
    table8 = _table8(cs)
    o, d, _ = _random_rays(table8, cs.num_spheres, 4096, seed=9)
    t, ids = sphere_tree.sphere_tree_sweep_reference(o, d, table8,
                                                     _tree(cs, table8))
    assert (ids >= 0).double().mean() > 0.3
    jo = jnp.asarray(np.stack([x.numpy() for x in o], 1))
    jd = jnp.asarray(np.stack([x.numpy() for x in d], 1))
    jw = jspheres.intersect_spheres_world(jo, jd, jnp.asarray(
        table8[:cs.num_spheres, :5].numpy()))
    same_id = ids.numpy() == np.asarray(jw.sph)
    tt, jt = t.numpy(), np.asarray(jw.t)
    agree = same_id & (np.abs(tt - jt) <= ATOL + RTOL * np.abs(jt))
    assert same_id.mean() >= AGREEMENT and agree.mean() >= AGREEMENT


def test_visit_counts_are_at_most_the_flat_walks():
    """On every bounce of final-one-weekend's frame, the tree's box tests
    (two a node) and its box and sphere tests together are at most the
    flat cluster walk's (every box, then the spheres of each cluster that
    passes against the running best t); the prefix is swept by both."""
    cs = _port_cs("final-one-weekend")
    table8 = _table8(cs)
    layout = megakernel.sphere_cluster_layout(_static(cs))
    boxes = megakernel.sphere_cluster_boxes(table8, *layout)
    tree = _tree(cs, table8)
    for o, d, alive in _captured_rays(cs):
        best_t, _ = sphere_sweep.sphere_sweep_reference(o, d, table8)
        work = sphere_tree.sphere_tree_visit_counts(o, d, tree, best_t, alive)
        sel = alive.nonzero()[:, 0]
        flat = {}
        megakernel.sphere_cluster_sweep_reference(
            V3(*(x[sel] for x in o)), V3(*(x[sel] for x in d)), table8,
            boxes, *layout[:2], work=flat)
        assert work["rays"] == flat["rays"] == sel.numel()
        assert work["prefix_tests"] == flat["prefix_tests"]
        assert 0 < 2 * work["node_tests"] <= flat["box_tests"]
        assert (2 * work["node_tests"] + work["sphere_tests"]
                <= flat["box_tests"] + flat["sphere_tests"])
        assert 0 < work["nodes_read"] <= tree.nodes.shape[0]
        assert 0 < work["spheres_read"] <= tree.num_spheres


# ---- the Renderer and the wrapper -------------------------------------------

def _count_builds(monkeypatch):
    calls = []
    build = sphere_tree.build_sphere_tree

    def counting(*args, **kw):
        calls.append(1)
        return build(*args, **kw)

    monkeypatch.setattr(sphere_tree, "build_sphere_tree", counting)
    return calls


def test_static_scene_builds_its_tree_once(monkeypatch):
    calls = _count_builds(monkeypatch)
    r = Renderer(_port_cs("final-one-weekend"), device="cpu",
                 use_megakernel=True)
    assert r.path == "fused" and len(calls) == 1
    assert r._geometry(0).sph_tree is r._geometry(1).sph_tree is r._sph_tree
    r.render_next_batch()
    r.render_next_batch()
    assert len(calls) == 1


@pytest.mark.parametrize("per_batch", [False, True])
def test_moving_scene_keeps_its_order(monkeypatch, per_batch):
    """The motion-blur scene: its one geometry's tree (``fused_anim``), or
    with the straight-line form refused (``fused_per_batch``) a tree a
    batch, each re-fitted at its batch's time over the Renderer's one
    order."""
    if per_batch:
        monkeypatch.setattr(renderer_mod, "world_sphere_anim_tables",
                            lambda cs: None)
    calls = _count_builds(monkeypatch)
    r = Renderer(_port_cs("motion-blur"), device="cpu", use_megakernel=True)
    g0, g1 = r._geometry(0), r._geometry(1)
    assert torch.equal(g0.sph_tree.ids, r._sph_order)
    assert torch.equal(g1.sph_tree.ids, r._sph_order)
    if per_batch:
        assert r.path == "fused_per_batch" and len(calls) == 2
        assert g0.sph_tree.drows is None
        assert not torch.equal(g0.sph_tree.nodes, g1.sph_tree.nodes)
    else:
        assert r.path == "fused_anim" and len(calls) == 1
        assert g0.sph_tree is g1.sph_tree and g0.sph_tree.drows is not None


def _bad_trees(tree):
    n = tree.num_spheres
    dup = tree.ids.clone()
    dup[1] = dup[0]
    return {
        "ids not int32": tree._replace(ids=tree.ids.long()),
        "ids not a permutation": tree._replace(ids=dup),
        "ids out of range": tree._replace(ids=tree.ids - tree.n_prefix),
        "another prefix": tree._replace(n_prefix=tree.n_prefix + 1),
        "too few spheres": tree._replace(num_spheres=n - 1),
        "depth": tree._replace(depth=tree.depth + 1),
        "staged": tree._replace(staged=tree.nodes.shape[0] + 1),
        "node count": tree._replace(nodes=tree.nodes[:-1]),
        "rows": tree._replace(rows=tree.rows[:, :5].contiguous()),
        "unaligned": tree._replace(rows=torch.zeros(n * 8 + 1)[1:].view(n, 8)),
        "motion rows on a static scene": tree._replace(drows=tree.rows),
    }


@pytest.mark.parametrize("case", ["ids not int32", "ids not a permutation",
                                  "ids out of range", "another prefix",
                                  "too few spheres", "depth", "staged",
                                  "node count", "rows", "unaligned",
                                  "motion rows on a static scene"])
def test_wrapper_rejects_a_tree_that_does_not_match_its_scene(case):
    """On the CPU too, where the plain version sweeps densely: a geometry
    that carries a tree is checked against its scene (the card also
    refuses a clustered geometry without one, test_torch_cuda.py)."""
    r = Renderer(_port_cs("final-one-weekend"), device="cpu",
                 use_megakernel=True)
    geom = r._geometry(0)
    bad = _bad_trees(geom.sph_tree)[case]
    with pytest.raises(ValueError):
        megakernel.render_tile_mega(r.static, r.scene,
                                    geom._replace(sph_tree=bad), r.camera, 0,
                                    1, use_dof=r.use_dof)


def test_wrapper_rejects_a_moving_tree_without_motion_rows():
    r = Renderer(_port_cs("motion-blur"), device="cpu", use_megakernel=True)
    geom = r._geometry(0)
    with pytest.raises(ValueError, match="motion rows"):
        megakernel.render_tile_mega(
            r.static, r.scene,
            geom._replace(sph_tree=geom.sph_tree._replace(drows=None)),
            r.camera, 0, 1, use_dof=r.use_dof, times=r.batch_times_dev)
