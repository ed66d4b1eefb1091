"""The tree that the paged triangle sweep K3 walks (ops/paged_tri.py:
``leaf_boxes``, ``build_tri_tree``, the plain version
``tri_tree_sweep_reference`` and ``tree_visit_counts``) against the flat
paged walk, the dense sweep and the JAX package's paged kernel (its
``_paged_kernel`` in interpret mode), on soups and rays made from a numpy
seed.

- every leaf box holds its triangles' vertices and lies inside its
  cluster's box from ``build_page_tables``; every parent box is the union
  of its children's; padding leaves never pass; the node rows equal a
  numpy port of raytrace_tpu/models/bvh_build.py's child-box loop over
  the same leaf boxes (empty boxes as the never-passing point);
- ``tri_tree_sweep_reference`` bit for bit with ``paged_tri_sweep_reference``
  and ``tri_sweep_reference`` (t and id on every ray, u and v on the
  active ones) on random soups with leaf counts that are not powers of
  two, a one-triangle soup, duplicate triangles at equal t, tri-stress
  k = 1's soup, the tessellated big-spheres fixture, far grazing rays and
  inactive rays;
- the JAX paged kernel's (t, id, u, v) on tri-stress k = 1's soup: ids
  equal and t, u, v within 1e-3 on >= 99.9% of rays (XLA's CPU build
  contracts multiply-adds, PyTorch does not), as
  tests/test_torch_paged_tri.py holds the flat walk;
- ``tree_visit_counts`` never counts more triangle tests than
  ``visit_counts`` on the same rays and best t;
- the moving box grid's tree, re-fitted every batch, equals a fresh build
  from the batch's world soup;
- the wrapper on the CPU is the plain version, counts no launch, and
  rejects a tree that does not match its soup.
"""

import functools
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import pallas_paged_tri as jpaged
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch.engine import Renderer, arrays
from raytrace_tpu_torch.models.tessellate import generate_uv_sphere
from raytrace_tpu_torch.ops import paged_tri, transforms, tri_sweep
from raytrace_tpu_torch.ops.intersect import T_MAX
from raytrace_tpu_torch.ops.megakernel import _BIGF
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.tools import smoke_lib, stress_scenes

torch.set_num_threads(1)

AGREEMENT = 0.999
RTOL = ATOL = 1e-3
R = 4096
BIG = np.float32(3.0e38)   # raytrace_tpu/models/bvh_build.py BIG


def _soup(T, seed, spread=0.3):
    """T random triangles in a 10-unit box, in the paged sweep's order."""
    g = np.random.default_rng(seed)
    tri = (g.uniform(-5, 5, (T, 1, 3))
           + g.uniform(-spread, spread, (T, 3, 3))).astype(np.float32)
    return tri[paged_tri.paged_tri_order(tri, T)]


def _rays(tri, n, seed):
    """n rays from around the soup towards points of random triangles, a
    tenth in random directions, and an active mask (as
    tests/test_torch_paged_tri.py makes them)."""
    g = np.random.default_rng(seed)
    wp = tri.astype(np.float64)
    lo, hi = wp.min((0, 1)), wp.max((0, 1))
    span = np.maximum(hi - lo, 1.0)
    o = g.uniform(lo - span, hi + span, (n, 3))
    j = g.integers(0, len(tri), n)
    d = np.einsum("rv,rvi->ri", g.dirichlet(np.ones(3), n), wp[j]) - o
    d[:n // 10] = g.standard_normal((n // 10, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), g.random(n) < 0.8


def _v3(a):
    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


@functools.lru_cache(maxsize=None)
def _tri_stress_soup():
    """The JAX triangle stress scene at k = 1 (960 triangles of the port's
    uv-sphere OBJ): its world soup in the paged sweep's order."""
    obj = stress_scenes.write_sphere_obj(
        os.path.join(tempfile.mkdtemp(), "sphere-smooth.obj"))
    jcs = jax_compile_scene(JaxSceneFile.from_json_dict(
        stress_scenes.tri_stress_doc(1, obj)), width=16, height=9)
    mid = jpaged.world_soup_mid(jcs).astype(np.float32)
    return mid[jpaged.paged_tri_order(mid, jcs.num_triangles)]


@functools.lru_cache(maxsize=None)
def _big_spheres_soup():
    """The tessellated big-spheres fixture (final-one-weekend's ground and
    three large spheres, 28,032 triangles) in the paged sweep's order."""
    jcs = jax_compile_scene(JaxSceneFile.from_json_dict(
        stress_scenes.big_spheres_doc()), width=16, height=9,
        analytic_spheres=False)
    mid = jpaged.world_soup_mid(jcs).astype(np.float32)
    return mid[jpaged.paged_tri_order(mid, jcs.num_triangles)]


def _assert_sweeps_agree(tri, o, d, active, leaf=paged_tri.LEAF):
    """The tree's plain version bit for bit with the flat walk's and the
    dense sweep's; returns its (t, id, u, v)."""
    T = tri.shape[0]
    wp = torch.tensor(tri)
    tree = paged_tri.build_tri_tree(wp, T, leaf=leaf)
    hit = paged_tri.tri_tree_sweep_reference(o, d, tree, active)
    flat = paged_tri.paged_tri_sweep_reference(
        o, d, paged_tri.build_page_tables(wp, T), active)
    for a, b in zip(hit, flat):
        assert torch.equal(a, b)
    dt, dids, du, dv = tri_sweep.tri_sweep_reference(
        o, d, tri_sweep.pack_tri_table(wp, T))
    assert torch.equal(hit[0], torch.where(active, dt, T_MAX))
    assert torch.equal(hit[1], torch.where(active, dids, -1))
    assert torch.equal(hit[2][active], du[active])
    assert torch.equal(hit[3][active], dv[active])
    assert (hit[1][~active] == -1).all() and (hit[0][~active] == T_MAX).all()
    return hit


# ---- the tables --------------------------------------------------------------

@pytest.mark.parametrize("T,leaf", [(1, 8), (77, 8), (421, 4), (1000, 16),
                                    (3001, 8)])
def test_leaf_boxes_hold_their_triangles_inside_their_clusters(T, leaf):
    tri = _soup(T, seed=T)
    wp = torch.tensor(tri)
    boxes = paged_tri.leaf_boxes(wp, T, leaf)
    n_leaves = -(-T // leaf)
    K = boxes.shape[0]
    assert K == 1 << (n_leaves - 1).bit_length() and K < 2 * n_leaves + 1
    real = boxes[:n_leaves].numpy()
    v = np.zeros((n_leaves * leaf, 3, 3), np.float32)
    v[:T] = tri
    for k in range(n_leaves):
        pts = v[k * leaf:min((k + 1) * leaf, T)].reshape(-1, 3)
        assert (real[k, :3] < pts.min(0)).all()
        assert (real[k, 3:] > pts.max(0)).all()
    clusters = paged_tri.build_page_tables(wp, T).boxes.numpy()
    cl = clusters[np.arange(n_leaves) * leaf // paged_tri.TRI_G]
    assert (real[:, :3] >= cl[:, 0:3]).all()
    assert (real[:, 3:] <= cl[:, 4:7]).all()
    assert (boxes[n_leaves:, :3] == BIG).all()
    assert (boxes[n_leaves:, 3:] == -BIG).all()


def _bvh_child_boxes(leaf_mn, leaf_mx):
    """raytrace_tpu/models/bvh_build.py:155-172's bottom-up union and
    child-box rows, in numpy, over the given leaf boxes."""
    K = leaf_mn.shape[0]
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
    i = np.arange(K - 1)
    child_boxes = np.zeros((K - 1, 16), np.float32)
    child_boxes[:, 0:3] = node_mn[2 * i + 1]
    child_boxes[:, 3:6] = node_mx[2 * i + 1]
    child_boxes[:, 6:9] = node_mn[2 * i + 2]
    child_boxes[:, 9:12] = node_mx[2 * i + 2]
    return child_boxes, node_mn, node_mx


@pytest.mark.parametrize("T,leaf", [(77, 8), (421, 4), (3001, 8),
                                    (20000, 8)])
def test_node_rows_are_build_bvhs_child_boxes(T, leaf):
    """The rows equal build_bvh's loop over the same leaf boxes, with each
    empty box (a subtree of padding only) written as the point (BIG, BIG,
    BIG) and its reach 0; every parent box is the union of its children's
    and each reach is its box's largest |coordinate|."""
    tri = _soup(T, seed=T + 1)
    wp = torch.tensor(tri)
    boxes = paged_tri.leaf_boxes(wp, T, leaf).numpy()
    tree = paged_tri.build_tri_tree(wp, T, leaf=leaf)
    K = boxes.shape[0]
    assert tree.depth == K.bit_length() - 1 and tree.nodes.shape == (K - 1,
                                                                      16)
    want, node_mn, node_mx = _bvh_child_boxes(boxes[:, :3], boxes[:, 3:])
    rows = tree.nodes.numpy()
    for side in (0, 6):
        mn, mx = want[:, side:side + 3], want[:, side + 3:side + 6]
        empty = (mn > mx).any(axis=1)
        assert empty.any() == (K > -(-T // leaf) + 1)
        np.testing.assert_array_equal(rows[~empty, side:side + 6],
                                      want[~empty, side:side + 6])
        assert (rows[empty, side:side + 6] == np.float32(_BIGF)).all()
        reach = rows[:, 12 + side // 6]
        assert (reach[empty] == 0).all()
        np.testing.assert_array_equal(
            reach[~empty],
            np.abs(want[~empty, side:side + 6]).max(axis=1))
    assert (rows[:, 14:] == 0).all()
    # A parent is the union of its children.
    for n in range(K - 1):
        left, right = 2 * n + 1, 2 * n + 2
        np.testing.assert_array_equal(
            node_mn[n], np.minimum(node_mn[left], node_mn[right]))
        np.testing.assert_array_equal(
            node_mx[n], np.maximum(node_mx[left], node_mx[right]))


def test_padding_boxes_never_pass():
    """A soup of 9 leaves: 7 padding leaves and the empty subtrees above
    them never pass the slab test, from any origin, at any best t."""
    T, leaf = 72, 8
    tree = paged_tri.build_tri_tree(torch.tensor(_soup(T, seed=9)), T,
                                    leaf=leaf)
    assert tree.depth == 4
    g = np.random.default_rng(10)
    o = _v3(g.uniform(-1e4, 1e4, (4096, 3)).astype(np.float32))
    dd = g.standard_normal((4096, 3))
    dd[:100, 0] = 0.0
    d = _v3((dd / np.linalg.norm(dd, axis=1, keepdims=True)).astype(
        np.float32))
    iv = tuple(paged_tri._inv(x) for x in d)
    bt = torch.full((4096,), T_MAX)
    rows = tree.nodes
    empty = [(n, s) for n in range(rows.shape[0]) for s in (0, 6)
             if (rows[n, s:s + 6] == _BIGF).all()]
    # Leaves 9-15 are padding, and three nodes above them and one above
    # those hold no real triangle either.
    assert len(empty) == 7 + 3 + 1
    o_inf = torch.maximum(torch.maximum(o.x.abs(), o.y.abs()), o.z.abs())
    for n, s in empty:
        margin = (o_inf + rows[n, 12 + s // 6]) * paged_tri.TREE_ROUNDING
        assert not paged_tri._slab(tuple(o), iv, rows[n, s:s + 6], bt, 3,
                                   margin).any()


# ---- the plain version -----------------------------------------------------

@pytest.mark.parametrize("T,leaf", [(1, 8), (5, 4), (77, 8), (1000, 8),
                                    (3001, 16), (20000, 8), (20000, 4)])
def test_tree_sweep_is_the_flat_and_the_dense_sweep(T, leaf):
    """Random soups, most with leaf counts that are not powers of two, a
    one-triangle soup, and a duplicate triangle (the lower id wins the
    tie), with inactive rays."""
    tri = _soup(T, seed=T + 7)
    if T > 2:
        tri[T // 2] = tri[1]
    o, d, active = _rays(tri, R, seed=T + 8)
    hit = _assert_sweeps_agree(tri, _v3(o), _v3(d), torch.tensor(active),
                               leaf)
    assert (hit[1] >= 0).double().mean() > 0.3
    if T > 2:
        assert (hit[1] != T // 2).all()


def test_equal_t_duplicates_give_the_lowest_id():
    """Three copies of one triangle in three leaves far apart in the walk:
    every ray that hits it reports the lowest copy."""
    T = 600
    tri = _soup(T, seed=21)
    tri[[5, 300, 599]] = tri[450]
    o, d, active = _rays(tri, R, seed=22)
    hit = _assert_sweeps_agree(tri, _v3(o), _v3(d), torch.tensor(active))
    assert ((hit[1] == 5).sum() > 0) and not (
        (hit[1] == 300) | (hit[1] == 450) | (hit[1] == 599)).any()


@pytest.mark.parametrize("name", ["tri-stress-k1", "big-spheres"])
def test_tree_sweep_on_scene_soups(name):
    tri = _tri_stress_soup() if name == "tri-stress-k1" else \
        _big_spheres_soup()
    o, d, active = _rays(tri, R, seed=len(tri))
    hit = _assert_sweeps_agree(tri, _v3(o), _v3(d), torch.tensor(active))
    assert (hit[1] >= 0).double().mean() > 0.3


def test_tree_sweep_on_far_grazing_rays(monkeypatch):
    """Rays from 1,000-2,000 units away grazing the leaf boxes of one of
    final-one-weekend's small spheres tessellated (radius 0.2, 32 rings x
    64 segments: thin triangles at the poles).  The Moller-Trumbore test
    far from the origin reports some hits off their triangles; widened
    per ray by the rounding margin, the tree visits every hit whose point
    lies within that margin of its triangle's box, so each ray that
    disagrees with the dense sweep is one whose dense hit lies farther off
    (each printed); without the margin the tree loses hits the dense
    sweep reports."""
    pos, _, _, idx = generate_uv_sphere((4.0, 0.2, 1.0), 0.2, 32, 64)
    tri = pos[idx.reshape(-1, 3)].astype(np.float32)
    T = tri.shape[0]
    tri = tri[paged_tri.paged_tri_order(tri, T)]
    wp = torch.tensor(tri)
    tree = paged_tri.build_tri_tree(wp, T)
    boxes = paged_tri.leaf_boxes(wp, T)[:-(-T // paged_tri.LEAF)].numpy()
    o, d = smoke_lib.grazing_rays(boxes, 20000, 31, "cpu")
    active = torch.ones(20000, dtype=torch.bool)
    dense = tri_sweep.tri_sweep_reference(o, d,
                                          tri_sweep.pack_tri_table(wp, T))
    hit = paged_tri.tri_tree_sweep_reference(o, d, tree, active)
    bad = torch.nonzero((hit[0] != dense[0]) | (hit[1] != dense[1]))[:, 0]
    for r in bad.tolist():
        j = int(dense[1][r])
        p = np.array([float(x[r]) + float(dense[0][r]) * float(y[r])
                      for x, y in zip(o, d)])
        off = np.maximum(np.maximum(tri[j].min(0) - p, p - tri[j].max(0)),
                         0).max()
        o_inf = max(abs(float(x[r])) for x in o)
        margin = (o_inf + np.abs(boxes[j // paged_tri.LEAF]).max()
                  ) * paged_tri.TREE_ROUNDING
        print(f"ray {r}: dense hit {j} at t {float(dense[0][r])} lies "
              f"{off:.3g} off its triangle's box (margin {margin:.3g})")
        assert off > margin
    assert len(bad) <= 20000 * 1e-3
    assert (dense[1] >= 0).double().mean() > 0.3
    monkeypatch.setattr(paged_tri, "TREE_ROUNDING", 0.0)
    bare = paged_tri.tri_tree_sweep_reference(o, d, tree, active)
    bare_bad = (bare[0] != dense[0]) | (bare[1] != dense[1])
    assert bare_bad.sum() > len(bad)


def test_tree_sweep_matches_the_pallas_kernel():
    """tri-stress k = 1's soup, against JAX's paged kernel (g = 8, c = 16,
    eight pages) in interpret mode, with an active mask."""
    g, c = 8, 16
    tri = _tri_stress_soup()
    T = tri.shape[0]
    o, d, active = _rays(tri, R, seed=T + 1)
    tw = jpaged.build_page_valid(T, g, c)
    pageG, psieve = jpaged.build_page_tables(tri, T, g, c, xp=np)
    jt, jids, ju, jv = (np.asarray(a) for a in jpaged.paged_tri_sweep(
        jnp.asarray(tw), jnp.asarray(psieve), jnp.asarray(pageG),
        jnp.asarray(o.T), jnp.asarray(d.T),
        jnp.asarray(active.astype(np.float32)[None]), interpret=True, g=g,
        c=c))
    tree = paged_tri.build_tri_tree(torch.tensor(tri), T)
    t, ids, u, v = (a.numpy() for a in paged_tri.tri_tree_sweep_reference(
        _v3(o), _v3(d), tree, torch.tensor(active)))
    ok = ids == jids
    for a, b in ((t, jt), (u, ju), (v, jv)):
        ok &= np.isclose(a, b, rtol=RTOL, atol=ATOL)
    assert ok.mean() >= AGREEMENT, f"rays agree on {ok.mean()}"
    assert ((ids >= 0) & active).mean() > 0.3


@pytest.mark.parametrize("T,leaf", [(77, 8), (3001, 8), (20000, 4),
                                    (20000, 16)])
def test_tree_counts_no_more_triangle_tests_than_the_flat_walk(T, leaf):
    """On the same rays and best t (of several leaves: a one-leaf tree
    tests its triangles with no box test), every leaf a walk must reach
    lies in a cluster whose box passes, so the tree's triangle tests are
    at most the flat walk's."""
    tri = _soup(T, seed=T + 3)
    wp = torch.tensor(tri)
    tree = paged_tri.build_tri_tree(wp, T, leaf=leaf)
    o, d, active = _rays(tri, R, seed=T + 4)
    o, d, active = _v3(o), _v3(d), torch.tensor(active)
    best_t = paged_tri.tri_tree_sweep_reference(o, d, tree, active)[0]
    work = paged_tri.tree_visit_counts(o, d, tree, best_t, active)
    flat = paged_tri.visit_counts(o, d, paged_tri.build_page_tables(wp, T),
                                  best_t, active)
    n = int(active.sum())
    assert work["rays"] == flat["rays"] == n
    assert n <= work["node_tests"] <= n * (2 ** tree.depth - 1)
    assert 0 < work["tri_tests"] <= flat["tri_tests"]
    # A lone ray that hits: its walk reaches at least one leaf of its own
    # and the root's row.
    one = torch.zeros(R, dtype=torch.bool)
    one[int(torch.nonzero(best_t < T_MAX)[0, 0])] = True
    w1 = paged_tri.tree_visit_counts(o, d, tree, best_t, one)
    assert w1["rays"] == 1 and tree.depth <= w1["node_tests"]
    assert w1["tri_tests"] >= 1


def test_moving_soup_refits_every_batch():
    """The moving box grid on the paged wavefront: each batch's tree is a
    fresh build from that batch's world soup (same order and shape, new
    boxes), and the boxes move between batches."""
    cs = arrays.from_jax_compiled(jax_compile_scene(
        JaxSceneFile.from_json_dict(stress_scenes.box_grid_doc(moving=True)),
        width=16, height=9))
    r = Renderer(cs, device="cpu")
    assert r.static.bvh_mode == "paged" and r.static.any_animated
    trees = []
    for b in (0, r.compiled.render.sample_batches - 1):
        geom = r._geometry(b)
        mats = transforms.interpolate_instances(
            r.scene.inst_t0, r.scene.inst_t1, r.batch_times_dev[b])
        world_p, _ = transforms.transform_soup(r.scene.tri_p, r.scene.tri_n,
                                               r.scene.tri_inst, mats)
        fresh = paged_tri.build_tri_tree(world_p, r.static.num_triangles)
        assert torch.equal(geom.tri_tree.nodes, fresh.nodes)
        assert torch.equal(geom.tri_tree.tris, fresh.tris)
        assert geom.tri_tree[2:] == fresh[2:]
        trees.append(geom.tri_tree)
    assert r.batch_times[0] != r.batch_times[-1]
    assert trees[0].depth == trees[1].depth
    assert not torch.equal(trees[0].nodes, trees[1].nodes)


# ---- the wrapper ------------------------------------------------------------

def test_wrapper_on_the_cpu_walks_the_tree():
    T = 300
    tri = _soup(T, seed=5)
    tree = paged_tri.build_tri_tree(torch.tensor(tri), T)
    o, d, active = _rays(tri, R, seed=6)
    o, d, active = _v3(o), _v3(d), torch.tensor(active)
    before = paged_tri.LAUNCHES
    hit = paged_tri.intersect_tris_paged(o, d, tree, active)
    assert paged_tri.LAUNCHES == before   # the CPU launches no kernel
    ref = paged_tri.tri_tree_sweep_reference(o, d, tree, active)
    for a, b in zip(hit, ref):
        assert torch.equal(a, b)


def test_wrapper_rejects_trees_that_do_not_match():
    T = 300
    tri = _soup(T, seed=7)
    tree = paged_tri.build_tri_tree(torch.tensor(tri), T)
    o = _v3(np.zeros((16, 3), np.float32))
    active = torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError, match="does not match"):
        paged_tri.intersect_tris_paged(o, o, tree._replace(num_tris=T * 4),
                                       active)
    with pytest.raises(ValueError, match="nodes"):
        paged_tri.intersect_tris_paged(
            o, o, tree._replace(nodes=tree.nodes[:-1]), active)
    with pytest.raises(ValueError, match="fewer rows"):
        paged_tri.intersect_tris_paged(
            o, o, tree._replace(tris=tree.tris[:32]), active)
    deep = tree._replace(num_tris=1 << 28, leaf=1, depth=28)
    with pytest.raises(ValueError, match="stack"):
        paged_tri.intersect_tris_paged(o, o, deep, active)
    with pytest.raises(ValueError, match="at least one"):
        paged_tri.build_tri_tree(torch.tensor(tri), 0)
