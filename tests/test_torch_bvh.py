"""The SAH and implicit BVH (``use_bvh=True``) in the port against the JAX
package: the host builders bit for bit, the plain walk of H1
(ops/bvh.bvh_walk_reference) against JAX's XLA traversals, and the
Renderer against the JAX Renderer's BVH render.

Scenes, compiled by the JAX package and handed to the port through
``from_jax_compiled``, at 32x18, depth 6: the triangle fixture of
tools/stress_scenes.py (17 triangles), its moving twin (the box slides
and turns over the shutter: 9 samples and the inflated boxes), tri-stress
at k=1 (a 960-triangle sphere over a ground sphere: triangles and
spheres), final-one-weekend's four large spheres tessellated
(big-spheres, 28,032 triangles), and the box grid with its boxes sliding
(16,392 triangles).

- ``world_triangle_bounds``, ``build_bvh`` and ``build_bvh_sah`` equal
  JAX's bit for bit (the order, the rows, the depth and root);
  ``node_rows`` keeps the JAX rows' cols 0:14 (0:12 for the implicit
  tree, whose links the port adds, and whose empty padding boxes it
  stores as a point no slab test passes);
- the plain walk over JAX's rows against ``traverse_sah`` and
  ``traverse`` on seeded rays (tri-stress k=1 and the moving box grid):
  ids equal on >= 99.9% of rays, t within rtol = atol = 1e-3 (XLA's CPU
  build contracts multiply-adds, PyTorch does not), an exact tie counted
  as agreeing (the JAX walks keep the first hit at equal t, the port the
  lowest id);  on every scene, the walk bit for bit with the dense
  sweep;
- ``Renderer(cs, use_bvh=True)`` against ``JaxRenderer(jcs,
  use_bvh=True, use_pallas_sweep=False)`` (both "sah", the same permuted
  soup): channel means within 5e-3, RMSE below 0.05, rays within 1% (the
  tolerances of tests/test_torch_big_mesh.py);
- on the SAH Renderer's soup ``use_bvh=True`` and ``use_bvh=False`` (K2's
  plain version, the dense sweep) render the same bytes; so does the
  implicit tree that a failed native build leaves, with a warning;
- a tree deeper than the walk's stack raises; a one-leaf tree and a soup
  with no triangle are walked; a resumed SAH render is byte-identical
  with a one-shot render;
- the four-wide rows H1 walks (``wide_rows``), on both trees: each wide
  child's box is the union of the boxes below it, a leaf's that of its
  triangles' shutter bounds, bit for bit, the leaves cover the soup once,
  the wide tree is (depth + 1) // 2 levels deep; the plain walk over them
  bit for bit with the walk over the binary rows and with K2's dense
  plain sweep, moving and static; its work fewer node steps than the
  binary walk's; a wide tree too deep for the kernel's stack refused;
  the Renderer takes a tree of depth 62, the binary walk's deepest, and
  refuses 63; a tree of depth 62 whose walk fills the stack but for its
  spare entry (stress_scenes.deep_bvh) walked bit for bit with the dense
  sweep.
"""

import dataclasses
import functools
import logging
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.models import bvh_build as jbvh
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import bvh as jbvh_ops
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.engine import wavefront
from raytrace_tpu_torch.engine.arrays import from_jax_compiled
from raytrace_tpu_torch.models import bvh_build, bvh_native
from raytrace_tpu_torch.ops import bvh, megakernel, paged_tri, tri_sweep
from raytrace_tpu_torch.ops.intersect import T_MAX
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.tools import stress_scenes

torch.set_num_threads(1)

W, H = 32, 18
MEAN_TOL = 5e-3
RMSE_TOL = 0.05
RAY_TOL = 0.01
AGREEMENT = 0.999
RTOL = ATOL = 1e-3
SCENES = ["fixture", "fixture-moving", "tri-stress-k1", "big-spheres",
          "box-grid-moving"]


def _doc(name):
    if name == "tri-stress-k1":
        obj = stress_scenes.write_sphere_obj(
            os.path.join(tempfile.mkdtemp(), "sphere-smooth.obj"))
        return stress_scenes.tri_stress_doc(1, obj)
    if name == "big-spheres":
        return stress_scenes.big_spheres_doc()
    if name == "box-grid-moving":
        return stress_scenes.box_grid_doc(moving=True)
    doc = stress_scenes.triangle_fixture_doc()
    if name == "fixture-moving":
        box = next(i for i in doc["instances"] if i["name"] == "box")
        box["transform"] = {"animated": [
            {"translate": [0.0, 0.0, 0.0]},
            {"translate": [0.6, 0.0, 0.0],
             "rotate": {"axis": [0, 1, 0], "degrees": 30.0}}]}
    if name == "one-leaf":
        # The floor, the wall and the prism: 5 triangles, one SAH leaf.
        doc["primitives"] = [p for p in doc["primitives"] if "box" not in p]
        doc["instances"] = [i for i in doc["instances"] if i["name"] != "box"]
    return doc


@functools.lru_cache(maxsize=None)
def _jcs(name):
    cs = jax_compile_scene(JaxSceneFile.from_json_dict(_doc(name)), width=W,
                           height=H, analytic_spheres=name != "big-spheres")
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=6, sample_batches=2))


@functools.lru_cache(maxsize=None)
def _port(name):
    """The port's SAH render: (Renderer, image, rays)."""
    r = Renderer(from_jax_compiled(_jcs(name)), device="cpu", use_bvh=True)
    img = r.render_all()
    return r, img, r.stats.rays_traced


def _rows_equal(a, b):
    return np.asarray(a, np.float32).tobytes() == np.asarray(
        b, np.float32).tobytes()


@pytest.mark.parametrize("name", ["fixture", "fixture-moving",
                                  "box-grid-moving"])
def test_world_triangle_bounds_match_jax(name):
    jcs = _jcs(name)
    mn, mx = bvh_build.world_triangle_bounds(from_jax_compiled(jcs))
    jmn, jmx = jbvh.world_triangle_bounds(jcs)
    assert _rows_equal(mn, jmn) and _rows_equal(mx, jmx)


@pytest.mark.parametrize("name", ["fixture", "fixture-moving",
                                  "tri-stress-k1", "box-grid-moving"])
def test_builders_match_jax(name):
    jcs = _jcs(name)
    cs = from_jax_compiled(jcs)
    for leaf in (1, 4, 7):
        got, ref = bvh_build.build_bvh(cs, leaf), jbvh.build_bvh(jcs, leaf)
        assert got.order.tobytes() == ref.order.tobytes()
        assert _rows_equal(got.child_boxes, ref.child_boxes)
        assert (got.num_leaves, got.leaf_size, got.depth, got.mode) == (
            ref.num_leaves, ref.leaf_size, ref.depth, ref.mode)
        rows, root = bvh.node_rows(got, cs.num_triangles)
        # JAX's boxes, but an empty one (padding) as the point (BIG, BIG,
        # BIG), which no slab test passes.
        boxes = ref.child_boxes[:, :12].reshape(-1, 2, 6).copy()
        boxes[(boxes[..., :3] > boxes[..., 3:]).any(axis=2)] = jbvh.BIG
        assert _rows_equal(rows[:len(ref.child_boxes), :12],
                           boxes.reshape(-1, 12))
        assert root == (0 if got.num_leaves > 1 else bvh.leaf_link(
            0, min(cs.num_triangles, leaf)))
    got, ref = bvh_build.build_bvh_sah(cs), jbvh.build_bvh_sah(jcs)
    assert got is not None and ref is not None
    assert np.asarray(got.order, np.int64).tobytes() == np.asarray(
        ref.order, np.int64).tobytes()
    assert _rows_equal(got.child_boxes, ref.child_boxes)
    assert (got.root, got.depth, got.leaf_size, got.mode) == (
        ref.root, ref.depth, ref.leaf_size, "sah")
    rows, root = bvh.node_rows(got, cs.num_triangles)
    assert root == ref.root
    assert _rows_equal(rows[:, :14], ref.child_boxes[:, :14])
    box = rows[:, :12].reshape(-1, 2, 6)
    assert np.array_equal(rows[:, 14:16], np.abs(box).max(axis=2))


def _world_soup(name, mode):
    """The port's Renderer on ``name`` with use_bvh=True and the SAH or
    (``mode`` "implicit") the implicit builder, and its first batch's
    [T8, 12] world rows and world triangles (numpy)."""
    cs = from_jax_compiled(_jcs(name))
    if mode == "implicit":
        bvh_data = bvh_build.build_bvh(cs, 4)
    else:
        bvh_data = bvh_build.build_bvh_sah(cs)
    soup = bvh_build.permute_soup(cs, bvh_data.order)
    r = Renderer(soup, device="cpu", use_bvh=False)
    tris = wavefront.prepare_tris(r.static, r.scene, r.batch_times_dev[0])
    return soup, bvh_data, tris["tri_table12"], tris["world_p"].numpy()


def _rays(world_p, n, seed):
    """From around the soup towards random points of random triangles, a
    tenth in random directions."""
    g = np.random.default_rng(seed)
    lo, hi = world_p.min((0, 1)), world_p.max((0, 1))
    span = np.maximum(hi - lo, 1.0)
    o = g.uniform(lo - span, hi + span, (n, 3))
    pick = g.integers(0, len(world_p), n)
    bary = g.dirichlet(np.ones(3), n)
    d = np.einsum("rv,rvi->ri", bary, world_p[pick]) - o
    d[:n // 10] = g.standard_normal((n // 10, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), g.random(n) < 0.8


def _v3(a):
    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


@pytest.mark.parametrize("mode", ["sah", "implicit"])
@pytest.mark.parametrize("name", ["tri-stress-k1", "box-grid-moving"])
def test_plain_walk_matches_jax_traversal(name, mode):
    soup, data, table12, world_p = _world_soup(name, mode)
    n = soup.num_triangles
    o, d, alive = _rays(world_p[:n], 4096, 3)
    # The JAX package's rows as numpy, through the port's node_rows.
    jdata = (jbvh.build_bvh_sah(_jcs(name)) if mode == "sah"
             else jbvh.build_bvh(_jcs(name), 4))
    rows, root = bvh.node_rows(jdata, n)
    tree = bvh.BVHTree(nodes=torch.tensor(rows), root=root,
                       stack_depth=jdata.depth + 2, leaf=jdata.leaf_size,
                       num_tris=n)
    t, ids, u, v = bvh.bvh_walk_reference(_v3(o), _v3(d), table12, tree,
                                          torch.tensor(alive))
    jarr = jbvh_ops.BVHArrays(jnp.asarray(jdata.child_boxes),
                              *jbvh_ops.pack_world_tris(jnp.asarray(world_p)))
    if mode == "sah":
        ref = jbvh_ops.traverse_sah(jarr, jdata.root, jdata.leaf_size,
                                    jdata.depth + 2, jnp.asarray(o),
                                    jnp.asarray(d), jnp.asarray(alive))
    else:
        ref = jbvh_ops.traverse(jarr, jdata.num_leaves, jdata.leaf_size,
                                jdata.depth + 2, jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(alive))
    rt, rid = np.asarray(ref.t), np.asarray(ref.tri)
    ids, t = ids.numpy(), t.numpy()
    # An exact tie (two faces that meet a ray at one t): the port keeps
    # the lowest id, the JAX walk the first it finds.  Such a ray agrees
    # where JAX's triangle has, by the port's own test, exactly the port's
    # t and a higher id.  (The fixture's box stands on its floor, so its
    # coplanar faces also tie to within XLA's contracted roundings; the
    # dense-sweep test below holds the walk there, bit for bit.)
    jt, _, _ = paged_tri._cluster_hits(
        tuple(x[:, None] for x in _v3(o)), tuple(x[:, None] for x in _v3(d)),
        table12, torch.tensor(np.maximum(rid, 0).astype(np.int64))[:, None],
        n)
    tie = (rid > ids) & (ids >= 0) & (jt[:, 0].numpy() == t)
    same = (ids == rid) | tie
    close = same & np.isclose(t, rt, rtol=RTOL, atol=ATOL)
    hits = (rid >= 0).sum()
    assert hits > 500, hits
    assert same.mean() >= AGREEMENT and close.mean() >= AGREEMENT, (
        same.mean(), close.mean())
    assert (ids[~alive] == -1).all() and (t[~alive] == T_MAX).all()


@pytest.mark.parametrize("name", ["fixture-moving", "tri-stress-k1"])
def test_plain_walk_is_the_dense_sweep_bit_for_bit(name):
    """The walk keeps the lexicographic minimum of (t, id) over a
    conservative visit, so it gives the dense sweep's bits (K2's plain
    version) on any rays, moving soup or not."""
    soup, data, table12, world_p = _world_soup(name, "sah")
    n = soup.num_triangles
    o, d, alive = _rays(world_p[:n], 4096, 5)
    rows, root = bvh.node_rows(data, n)
    tree = bvh.BVHTree(torch.tensor(rows), root, data.depth + 2,
                       data.leaf_size, n)
    got = bvh.intersect_tris_bvh(_v3(o), _v3(d), table12, tree,
                                 torch.tensor(alive))
    table16 = tri_sweep.pack_tri_table(torch.tensor(world_p), n)
    ref = tri_sweep.intersect_tris_dense(_v3(o), _v3(d), table16,
                                         torch.tensor(alive))
    for a, b in zip(got, ref):
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("name", SCENES)
def test_sah_render_matches_the_jax_sah_render(name):
    r, img, rays = _port(name)
    assert r.static.bvh_mode == "sah" and r.path == "wavefront"
    assert not megakernel.megakernel_supported(r.static)
    j = JaxRenderer(_jcs(name), use_bvh=True, use_pallas_sweep=False)
    assert j.static.bvh_mode == "sah"
    assert r.compiled.tri_p.tobytes() == np.asarray(
        j.compiled.tri_p, np.float32).tobytes()
    assert r.static.bvh_stack_depth == j.static.bvh_stack_depth
    j.render_all()
    j_img, j_rays = np.asarray(j.image()), j.stats.rays_traced
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    mdiff = np.abs(img.mean((0, 1)) - j_img.mean((0, 1))).max()
    rmse = float(np.sqrt(np.mean((img - j_img) ** 2)))
    assert mdiff <= MEAN_TOL, f"channel means differ by {mdiff}"
    assert rmse <= RMSE_TOL, f"RMSE {rmse}"
    assert abs(rays - j_rays) <= RAY_TOL * j_rays, f"rays {rays} vs {j_rays}"


def _counted(monkeypatch):
    calls = {"bvh": 0, "k2": 0}

    def wrap(key, fn):
        def inner(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return inner

    monkeypatch.setattr(bvh, "intersect_tris_bvh",
                        wrap("bvh", bvh.intersect_tris_bvh))
    monkeypatch.setattr(tri_sweep, "intersect_tris_sweep",
                        wrap("k2", tri_sweep.intersect_tris_sweep))
    return calls


@pytest.mark.parametrize("name", SCENES)
def test_bvh_and_dense_sweep_render_the_same_bytes(name, monkeypatch):
    """At 16x9: the dense sweep's plain version is slow on the big soups."""
    calls = _counted(monkeypatch)
    cs = from_jax_compiled(_jcs(name))
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, width=W // 2, height=H // 2))
    r = Renderer(cs, device="cpu", use_bvh=True)
    img = r.render_all()
    assert calls["bvh"] > 0 and calls["k2"] == 0
    dense = Renderer(r.compiled, device="cpu", use_bvh=False)
    assert dense.static.bvh_mode == "none"
    dense_img = dense.render_all()
    assert calls["k2"] > 0
    assert img.tobytes() == dense_img.tobytes()
    assert r.stats.rays_traced == dense.stats.rays_traced > 0


def test_failed_native_build_falls_back_to_the_implicit_tree(
        monkeypatch, caplog):
    monkeypatch.setattr(bvh_native, "CXX", "/nonexistent/g++")
    bvh_native.reset()
    try:
        with caplog.at_level(logging.WARNING):
            r = Renderer(from_jax_compiled(_jcs("fixture-moving")),
                         device="cpu", use_bvh=True, leaf_size=4)
        assert bvh_native.error() is not None
        assert any("implicit BVH" in m and "/nonexistent/g++" in m
                   for m in caplog.messages), caplog.messages
        assert r.static.bvh_mode == "implicit" and r.bvh.mode == "implicit"
        # Every such build warns, not only the first.
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert bvh_build.build_bvh_sah(r.compiled) is None
        assert any("implicit BVH" in m for m in caplog.messages)
        assert r.static.bvh_leaf_size == 4
        img = r.render_all()
        dense = Renderer(r.compiled, device="cpu", use_bvh=False)
        assert img.tobytes() == dense.render_all().tobytes()
        assert r.stats.rays_traced == dense.stats.rays_traced
    finally:
        monkeypatch.undo()
        bvh_native.reset()
    assert bvh_build.build_bvh_sah(from_jax_compiled(_jcs("fixture")))


def test_tree_deeper_than_the_stack_raises(monkeypatch):
    soup, data, table12, world_p = _world_soup("fixture", "sah")
    rows, root = bvh.node_rows(data, soup.num_triangles)
    o, d, alive = _rays(world_p[:soup.num_triangles], 64, 1)
    tree = bvh.BVHTree(torch.tensor(rows), root, bvh.MAX_STACK + 1,
                       data.leaf_size, soup.num_triangles)
    with pytest.raises(ValueError, match="stack"):
        bvh.intersect_tris_bvh(_v3(o), _v3(d), table12, tree,
                               torch.tensor(alive))
    # A tree whose stack is smaller than its walk needs is not cut short.
    with pytest.raises(ValueError, match="stack"):
        bvh.intersect_tris_bvh(_v3(o), _v3(d), table12,
                               tree._replace(stack_depth=0),
                               torch.ones(64, dtype=torch.bool))
    deep = dataclasses.replace(data, depth=bvh.MAX_STACK - 1)
    monkeypatch.setattr(bvh_build, "build_bvh_sah", lambda *a, **k: deep)
    from raytrace_tpu_torch.engine import renderer
    monkeypatch.setattr(renderer, "build_bvh_sah", lambda *a, **k: deep)
    with pytest.raises(ValueError, match="stack"):
        Renderer(from_jax_compiled(_jcs("fixture")), device="cpu",
                 use_bvh=True)


def test_one_leaf_tree_and_no_triangles():
    r = Renderer(from_jax_compiled(_jcs("one-leaf")), device="cpu",
                 use_bvh=True)
    assert r.static.num_triangles == 5 and r.static.bvh_mode == "sah"
    assert r.static.bvh_root < 0 and r.scene.bvh_child_boxes.shape == (1, 32)
    img = r.render_all()
    dense = Renderer(r.compiled, device="cpu", use_bvh=False)
    assert img.tobytes() == dense.render_all().tobytes()
    # The implicit tree of one leaf: its root is that leaf.
    data = bvh_build.build_bvh(r.compiled, 8)
    rows, root = bvh.node_rows(data, 5)
    assert data.num_leaves == 1 and root == bvh.leaf_link(0, 5)
    # A soup with no triangle launches nothing and misses every ray.
    o, d, alive = _rays(np.ones((1, 3, 3)), 16, 2)
    hit = bvh.intersect_tris_bvh(
        _v3(o), _v3(d), torch.zeros((8, 12)),
        bvh.BVHTree(torch.zeros((1, 16)), 0, 2, 8, 0), torch.tensor(alive))
    assert (hit.t == T_MAX).all() and (hit.tri == -1).all()
    # use_bvh=True on a scene without triangles has nothing to build.
    spheres = from_jax_compiled(jax_compile_scene(JaxSceneFile.from_json_dict(
        stress_scenes.sphere_stress_doc(1)), width=8, height=4))
    assert Renderer(spheres, device="cpu", use_bvh=True).static.bvh_mode == (
        "none")


def test_resumed_sah_render_is_byte_identical(tmp_path):
    cs = from_jax_compiled(_jcs("fixture-moving"))
    one_shot = Renderer(cs, device="cpu", use_bvh=True)
    one_shot.render_all()
    first = Renderer(cs, device="cpu", use_bvh=True)
    first.render_next_batch()
    ck = str(tmp_path / "ck.npz")
    first.save_checkpoint(ck)
    resumed = Renderer(cs, device="cpu", use_bvh=True)
    resumed.load_checkpoint(ck)
    resumed.render_all()
    assert resumed.image().tobytes() == one_shot.image().tobytes()
    # update_image_size keeps use_bvh and leaf_size.
    small = one_shot.update_image_size(16, 8)
    assert small.static.bvh_mode == "sah"
    assert small._ctor_kwargs["leaf_size"] == 4


def test_visit_counts_bound_the_walk():
    """The work count of the bound: each ray's walk against its own final
    best t visits no more than the kernel's walk does, tests every node it
    reads, and reads the winner's leaf."""
    soup, data, table12, world_p = _world_soup("tri-stress-k1", "sah")
    n = soup.num_triangles
    o, d, alive = _rays(world_p[:n], 2048, 4)
    rows, root = bvh.node_rows(data, n)
    tree = bvh.BVHTree(torch.tensor(rows), root, data.depth + 2,
                       data.leaf_size, n)
    alive = torch.tensor(alive)
    t, ids, _, _ = bvh.bvh_walk_reference(_v3(o), _v3(d), table12, tree,
                                          alive)
    work = bvh.visit_counts(_v3(o), _v3(d), tree, t, alive)
    assert work["rays"] == int(alive.sum())
    assert work["node_tests"] >= work["rays"] and work["tri_tests"] > 0
    assert 0 < work["nodes_read"] <= len(rows)
    assert 0 < work["tris_read"] <= n
    # Against a miss everywhere (T_MAX) the walk reaches more.
    far = bvh.visit_counts(_v3(o), _v3(d), tree, torch.full_like(t, T_MAX),
                           alive)
    assert far["node_tests"] > work["node_tests"]
    assert far["tri_tests"] > work["tri_tests"]


# ---- the four-wide rows H1 walks -------------------------------------------

def _wide(data, n):
    rows, root, stack = bvh.wide_tree(data, n)
    return rows, bvh.BVHTree(torch.tensor(rows), root, stack, data.leaf_size,
                             n)


@pytest.mark.parametrize("mode", ["sah", "implicit"])
@pytest.mark.parametrize("name", ["fixture-moving", "tri-stress-k1",
                                  "box-grid-moving"])
def test_wide_rows_hold_their_binary_subtrees(name, mode):
    soup, data, _, _ = _world_soup(name, mode)
    n = soup.num_triangles
    rows, tree = _wide(data, n)
    mn, mx = bvh_build.world_triangle_bounds(soup)
    box = rows[:, :24].reshape(-1, 3, 2, 4).transpose(0, 3, 2, 1).reshape(
        -1, 4, 6)
    links = rows[:, 24:28].view(np.int32)
    empty = (box[..., :3] >= jbvh.BIG).all(axis=2)
    covered = np.zeros(n, np.int64)
    depth = np.zeros(len(rows), np.int64)
    for w in range(len(rows)):
        for k in range(bvh.WIDE):
            link = links[w, k]
            if link >= 0:
                # A wide child: the union of its own children's boxes.
                depth[link] = depth[w] + 1
                real = box[link][~empty[link]]
                want = (np.concatenate([real[:, :3].min(0), real[:, 3:].max(0)])
                        if len(real) else None)
            else:
                enc = -(link + 1)
                first, count = enc >> 5, enc & 31
                covered[first:first + count] += 1
                want = (np.concatenate([mn[first:first + count].min(0),
                                        mx[first:first + count].max(0)])
                        if count else None)
            if want is None:
                assert empty[w, k]
            else:
                assert box[w, k].tobytes() == want.astype(np.float32).tobytes()
    assert (covered == 1).all()
    assert tree.root == 0 and depth.max() + 1 <= (data.depth + 1) // 2
    assert tree.stack_depth == bvh.wide_stack(data.depth) == (
        3 * ((data.depth + 1) // 2) + 1)
    assert np.array_equal(rows[:, 28:32], np.where(
        empty, 0.0, np.abs(box).max(axis=2)))


@pytest.mark.parametrize("mode", ["sah", "implicit"])
@pytest.mark.parametrize("name", ["fixture-moving", "tri-stress-k1",
                                  "box-grid-moving"])
def test_wide_walk_is_the_binary_walk_and_the_dense_sweep(name, mode):
    soup, data, table12, world_p = _world_soup(name, mode)
    n = soup.num_triangles
    o, d, alive = _rays(world_p[:n], 4096, 7)
    alive = torch.tensor(alive)
    rows, root = bvh.node_rows(data, n)
    binary = bvh.BVHTree(torch.tensor(rows), root, data.depth + 2,
                         data.leaf_size, n)
    _, wide = _wide(data, n)
    got = bvh.intersect_tris_bvh(_v3(o), _v3(d), table12, wide, alive)
    walk = bvh.bvh_walk_reference(_v3(o), _v3(d), table12, binary, alive)
    dense = tri_sweep.intersect_tris_dense(
        _v3(o), _v3(d), tri_sweep.pack_tri_table(torch.tensor(world_p), n),
        alive)
    for a, b, c in zip(got, walk, dense):
        assert a.numpy().tobytes() == b.numpy().tobytes()
        assert a.numpy().tobytes() == c.numpy().tobytes()
    assert (got.tri >= 0).sum() > 500
    # The wide walk's work: about half the node steps, no fewer triangles.
    wb = bvh.visit_counts(_v3(o), _v3(d), binary, got.t, alive)
    ww = bvh.visit_counts(_v3(o), _v3(d), wide, got.t, alive)
    assert wb["rays"] == ww["rays"] == int(alive.sum())
    assert ww["node_tests"] < 0.8 * wb["node_tests"]
    assert ww["tri_tests"] >= wb["tri_tests"] > 0
    assert ww["tris_read"] == wb["tris_read"]
    assert ww["nodes_read"] <= len(wide.nodes)


def test_wide_tree_deeper_than_the_stack_is_refused(monkeypatch):
    soup, data, table12, world_p = _world_soup("box-grid-moving", "sah")
    n = soup.num_triangles
    _, wide = _wide(data, n)
    o, d, alive = _rays(world_p[:n], 256, 9)
    with pytest.raises(ValueError, match="stack"):
        bvh.intersect_tris_bvh(_v3(o), _v3(d), table12, wide._replace(
            stack_depth=bvh.MAX_STACK + 1), torch.tensor(alive))
    # A stack smaller than the walk needs is not cut short: it raises.
    with pytest.raises(ValueError, match="stack"):
        bvh.intersect_tris_bvh(_v3(o), _v3(d), table12,
                               wide._replace(stack_depth=1),
                               torch.ones(256, dtype=torch.bool))
    # The Renderer sizes the wide walk's stack from the binary depth: the
    # deepest tree it takes is 62 levels (3 * 31 + 1 = 94 entries), as the
    # binary walk's 64 entries took (depth + 2).
    assert bvh.wide_stack(62) == bvh.MAX_STACK < bvh.wide_stack(63)
    r = Renderer(from_jax_compiled(_jcs("fixture")), device="cpu",
                 use_bvh=True)
    tree = wavefront.bvh_tree(r.static, r.scene)
    assert tree.nodes.shape[1] == bvh.WIDE_COLS
    assert tree.stack_depth == bvh.wide_stack(r.bvh.depth)
    from raytrace_tpu_torch.engine import renderer
    for depth in (62, 63):
        deep = dataclasses.replace(r.bvh, depth=depth)
        monkeypatch.setattr(renderer, "build_bvh_sah",
                            lambda *a, deep=deep, **k: deep)
        if depth == 62:
            ok = Renderer(r.compiled, device="cpu", use_bvh=True)
            assert wavefront.bvh_tree(ok.static, ok.scene).stack_depth == 94
        else:
            with pytest.raises(ValueError, match="stack"):
                Renderer(r.compiled, device="cpu", use_bvh=True)


def test_depth_62_tree_fills_the_stack_it_is_given():
    """stress_scenes.deep_bvh(62): its wide walk from x = -10 along +x
    pushes 93 entries, so it is walked with wide_stack(62) = MAX_STACK
    entries and with 93, bit for bit with the binary walk and the dense
    plain sweep, and refused with 92."""
    tris, rows, root = stress_scenes.deep_bvh(62)
    n = len(tris)
    table16 = tri_sweep.pack_tri_table(torch.tensor(tris), n)
    table12 = megakernel.tri_table12(table16)
    wide, wide_root = bvh.wide_rows(rows, root)
    assert wide.shape == (31, bvh.WIDE_COLS)
    g = np.random.default_rng(47)
    R = 512
    o = np.concatenate([np.full((R, 1), -10.0), g.uniform(-1.5, 0.9, (R, 2))],
                       1)
    d = np.tile([[1.0, 0.0, 0.0]], (R, 1))
    d[R // 2:] = g.standard_normal((R // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = _v3(o.astype(np.float32)), _v3(d.astype(np.float32))
    alive = torch.tensor(g.random(R) < 0.9)
    dense = tri_sweep.intersect_tris_dense(o, d, table16, alive)
    binary = bvh.BVHTree(torch.tensor(rows), root, 64, 1, n)
    walks = [bvh.bvh_walk_reference(o, d, table12, binary, alive)]
    for stack in (bvh.MAX_STACK, 93):
        walks.append(bvh.intersect_tris_bvh(o, d, table12, bvh.BVHTree(
            torch.tensor(wide), wide_root, stack, 1, n), alive))
    for walk in walks:
        for a, b in zip(walk, dense):
            assert a.numpy().tobytes() == b.numpy().tobytes()
    assert (dense.tri == n - 1).sum() >= 0.4 * R
    with pytest.raises(ValueError, match="stack"):
        bvh.intersect_tris_bvh(o, d, table12, bvh.BVHTree(
            torch.tensor(wide), wide_root, 92, 1, n), alive)
