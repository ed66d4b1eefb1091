"""Spheres in object space (ellipsoids: a non-uniform instance scale) in
the port against the JAX package: the plain sweep of H2
(ops/spheres.intersect_spheres) against JAX's ``intersect_spheres``, the
world-to-object branch of the port's ``reconstruct_hit`` against JAX's
``sphere_hit_attributes``, and the Renderer against the JAX Renderer's
object-space wavefront.

Scenes, compiled by the JAX package and handed to the port through
``from_jax_compiled``, at 32x18, depth 6, from
tools/ellipsoid_scenes.py: the ellipsoid fixture (final-one-weekend's
ground and three large spheres, those stretched by [1, 1.5, 1]), its
moving twin (one ellipsoid slides and stretches over the shutter) and
its twin with a quad wall of two triangles; and fow-ellipsoids
(final-one-weekend's 488 spheres, three stretched) at 16x9.

- the plain sweep against JAX's on seeded rays, at the batch times:
  ids equal on >= 99.9% of rays, t within rtol = atol = 1e-3 (XLA's CPU
  build contracts multiply-adds, PyTorch does not);
- the hit point and unit normal against ``sphere_hit_attributes`` within
  1e-4;
- ``Renderer(cs, device="cpu")`` takes the wavefront with
  ``sphere_world_mode`` False and sweeps through
  ``sphere_obj.intersect_spheres_object``; against ``JaxRenderer(jcs,
  use_pallas_sweep=False)``: channel means within 5e-3, RMSE below 0.05,
  rays within 1% (the tolerances of tests/test_torch_big_mesh.py);
- the wrapper: the lowest id on ties, inactive rays miss, bad tables
  refused;
- H2's tree (ops/sphere_obj.py): its plain walk, the dense prefix then
  the tree over the ellipsoids' world boxes, bit for bit with the dense
  plain sweep on the static and the moving fixture (a tree forced over
  their three ellipsoids) at two batch times and on fow-ellipsoids, on
  seeded rays and on grazing rays from near and from 1,000-2,000 away
  (the rounding margin: without it the far ones lose hits); duplicated
  spheres keep the lowest id; each slice of a two-way scene slice; every
  ellipsoid's surface samples inside its widened box, whose faces touch
  its extreme points; the walk against JAX's ``intersect_spheres`` within
  AGREEMENT / RTOL / ATOL; the Renderer's tree built once for a static
  scene and every batch for a moving one, whose render is the dense
  sweep's bytes; the once-built tree's boxes, widened for the drift of a
  static instance's map between batch times, hold every ellipsoid at
  other times, and its walk of a later batch's rows is the dense sweep.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.models.bvh_build import _instance_matrix_at as jax_at
from raytrace_tpu.ops import spheres as jspheres
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch.engine import Renderer, wavefront
from raytrace_tpu_torch.engine.arrays import from_jax_compiled
from raytrace_tpu_torch.ops import (megakernel, sphere_obj, sphere_sweep,
                                    spheres)
from raytrace_tpu_torch.ops.intersect import T_MAX
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.tools import ellipsoid_scenes

torch.set_num_threads(1)

W, H = 32, 18
MEAN_TOL = 5e-3
RMSE_TOL = 0.05
RAY_TOL = 0.01
AGREEMENT = 0.999
RTOL = ATOL = 1e-3
SCENES = ["fixture", "fixture-moving", "fixture-triangles"]


def _doc(name):
    if name == "fow-ellipsoids":
        return ellipsoid_scenes.fow_ellipsoids_doc()
    if name == "fow-ellipsoids-moving":
        # Every tenth small sphere slides by 0.3 along x over the shutter.
        doc = ellipsoid_scenes.fow_ellipsoids_doc()
        for inst in doc["instances"][1:-3:10]:
            inst["transform"] = {"animated": [
                {"translate": [0.0, 0.0, 0.0]},
                {"translate": [0.3, 0.0, 0.0]}]}
        return doc
    return ellipsoid_scenes.ellipsoid_fixture_doc(
        moving=name == "fixture-moving", triangles=name == "fixture-triangles")


@functools.lru_cache(maxsize=None)
def _jcs(name):
    w, h = (16, 9) if name.startswith("fow-ellipsoids") else (W, H)
    cs = jax_compile_scene(JaxSceneFile.from_json_dict(_doc(name)), width=w,
                           height=h)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=6, sample_batches=2))


def _v3(a):
    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _sphere_inputs(name, t, n, seed):
    """The scene's spheres at shutter time t (object centres, radii, each
    sphere's world-to-object [S, 3, 4] from the JAX package's f64 host
    transform, rounded) and n seeded rays from the air above the ground
    towards the large spheres, a tenth in random directions."""
    jcs = _jcs(name)
    w2o = np.linalg.inv(np.concatenate([
        jax_at(jcs.inst_t0, jcs.inst_t1, t),
        np.tile([[[0.0, 0.0, 0.0, 1.0]]], (jcs.inst_t0.shape[0], 1, 1))],
        axis=1))[:, :3, :]
    w2o = w2o[np.asarray(jcs.sph_inst)].astype(np.float32)
    g = np.random.default_rng(seed)
    o = g.uniform([-6, -5, -6], [14, -0.5, 6], (n, 3))
    aim = g.uniform([-5, -3, -2], [5, 0, 2], (n, 3))
    d = aim - o
    d[:n // 10] = g.standard_normal((n // 10, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (w2o, np.asarray(jcs.sph_center, np.float32),
            np.asarray(jcs.sph_radius, np.float32), o.astype(np.float32),
            d.astype(np.float32))


@pytest.mark.parametrize("t", [0.0, 0.7])
@pytest.mark.parametrize("name", ["fixture", "fixture-moving"])
def test_plain_sweep_matches_jax(name, t):
    w2o, c, r, o, d = _sphere_inputs(name, t, 8192, 7)
    table = spheres.object_sphere_table(torch.tensor(w2o), torch.tensor(c),
                                        torch.tensor(r))
    hit = spheres.intersect_spheres(_v3(o), _v3(d), table)
    S = len(c)
    ref = jspheres.intersect_spheres(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(c), jnp.asarray(r),
                                     jnp.asarray(w2o), chunk=S)
    ids, t_ = hit.sph.numpy(), hit.t.numpy()
    rid, rt = np.asarray(ref.sph), np.asarray(ref.t)
    assert (rid >= 0).sum() > 4000
    same = ids == rid
    close = same & np.isclose(t_, rt, rtol=RTOL, atol=ATOL)
    assert same.mean() >= AGREEMENT and close.mean() >= AGREEMENT, (
        same.mean(), close.mean())


def test_hit_attributes_match_jax():
    """The port's world-to-object branch (reconstruct_hit with
    ``object_space``, from prepare_batch's rows) against JAX's
    sphere_hit_attributes: hit point and unit normal."""
    port = Renderer(from_jax_compiled(_jcs("fixture")), device="cpu")
    geom = port._geometry(0)
    w2o, c, r, o, d = _sphere_inputs("fixture", float(port.batch_times[0]),
                                     4096, 11)
    hit = sphere_obj.intersect_spheres_object(
        _v3(o), _v3(d), geom.sph_obj16, torch.ones(len(o), dtype=torch.bool))
    keep = (hit.sph >= 0).numpy()
    o, d = o[keep], d[keep]
    t, sid = hit.t[keep], hit.sph[keep]
    raw = wavefront.RawHit(missed=t >= T_MAX, t=t, prim=sid,
                           is_sphere=torch.ones_like(t, dtype=torch.bool),
                           bu=torch.zeros_like(t), bv=torch.zeros_like(t))
    rec = wavefront.reconstruct_hit(raw, _v3(o), _v3(d),
                                    geom.prim_rows[sid.long()], geom,
                                    geom.sph_obj16.shape[0],
                                    object_space=True)
    jp, jn, _, _ = jspheres.sphere_hit_attributes(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t.numpy()),
        jnp.asarray(sid.numpy()), jnp.asarray(c), jnp.asarray(r),
        jnp.asarray(w2o), None)
    for got, ref in ((rec.p, jp), (rec.n, jn)):
        got = torch.stack(list(got), dim=1).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


@functools.lru_cache(maxsize=None)
def _port(name):
    r = Renderer(from_jax_compiled(_jcs(name)), device="cpu")
    img = r.render_all()
    return r, img, r.stats.rays_traced


@pytest.mark.parametrize("name", SCENES + ["fow-ellipsoids"])
def test_render_matches_the_jax_object_space_render(name, monkeypatch):
    calls = {"h2": 0, "k1": 0}

    def counted(key, fn):
        def inner(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return inner

    monkeypatch.setattr(sphere_obj, "intersect_spheres_object",
                        counted("h2", sphere_obj.intersect_spheres_object))
    monkeypatch.setattr(sphere_sweep, "intersect_spheres_sweep",
                        counted("k1", sphere_sweep.intersect_spheres_sweep))
    _port.cache_clear()
    r, img, rays = _port(name)
    assert r.path == "wavefront" and not r.static.sphere_world_mode
    assert r.sphere_tables is None and r._sph_tree is None
    assert not megakernel.megakernel_supported(r.static)
    assert calls["h2"] > 0 and calls["k1"] == 0
    assert bool(r.static.any_animated) == (name == "fixture-moving")
    assert r.static.has_tris == (name == "fixture-triangles")
    j = JaxRenderer(_jcs(name), use_pallas_sweep=False)
    assert not j.static.sphere_world_mode
    j.render_all()
    j_img, j_rays = np.asarray(j.image()), j.stats.rays_traced
    assert np.isfinite(img).all() and (img >= 0).all()
    mdiff = np.abs(img.mean((0, 1)) - j_img.mean((0, 1))).max()
    rmse = float(np.sqrt(np.mean((img - j_img) ** 2)))
    assert mdiff <= MEAN_TOL, f"channel means differ by {mdiff}"
    assert rmse <= RMSE_TOL, f"RMSE {rmse}"
    assert abs(rays - j_rays) <= RAY_TOL * j_rays, f"rays {rays} vs {j_rays}"


def test_ellipsoids_with_triangles_on_the_sah_bvh():
    """Both new branches at once: the quad wall through the SAH BVH, the
    ellipsoids through H2, the same bytes as the wall through K2's plain
    version (the dense sweep)."""
    cs = from_jax_compiled(_jcs("fixture-triangles"))
    r = Renderer(cs, device="cpu", use_bvh=True)
    assert r.static.bvh_mode == "sah" and not r.static.sphere_world_mode
    img = r.render_all()
    dense = Renderer(r.compiled, device="cpu", use_bvh=False)
    assert img.tobytes() == dense.render_all().tobytes()


def test_wrapper_ties_inactive_rays_and_checks():
    # Two copies of one ellipsoid (ids 1 and 2) behind a padding row: the
    # lower id wins the tie.
    m = np.zeros((3, 3, 4), np.float32)
    m[:, 0, 0], m[:, 1, 1], m[:, 2, 2] = 1.0, 1.0 / 1.5, 1.0
    table = spheres.object_sphere_table(
        torch.tensor(m), torch.zeros((3, 3)), torch.tensor([0.0, 1.0, 1.0]))
    o = np.array([[0, 0, -5], [0, 5, -5], [0, 0, -5]], np.float32)
    d = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1]], np.float32)
    alive = torch.tensor([True, True, False])
    hit = sphere_obj.intersect_spheres_object(_v3(o), _v3(d), table, alive)
    assert hit.sph.tolist() == [1, -1, -1]
    assert hit.t[0].item() == pytest.approx(4.0)
    assert hit.t[1].item() == T_MAX == hit.t[2].item()
    assert table.shape == (8, 16)
    with pytest.raises(ValueError, match="table16"):
        sphere_obj.intersect_spheres_object(_v3(o), _v3(d), table[:, :8],
                                            alive)


# ---- H2's tree over the ellipsoids' world boxes ----------------------------

def _table(name, t):
    """The port's object-space table of scene ``name`` at batch time t (the
    table prepare_batch builds), and its real spheres."""
    r = Renderer(from_jax_compiled(_jcs(name)), device="cpu")
    return (wavefront.object_table(r.scene, torch.tensor(t)),
            r.static.num_spheres)


def _tree(table, n, n_prefix=None, leaf=None):
    """The tree over the spheres past ``n_prefix`` (tree_prefix's where not
    given; the fixture's three ellipsoids past its ground otherwise)."""
    if n_prefix is None:
        n_prefix = 1
    ids = sphere_obj.object_order(table, n_prefix, n)
    return sphere_obj.build_object_tree(table, n, n_prefix, ids, leaf=leaf)


def _hold_to_dense(o, d, table, tree, alive=None):
    """The walk (plain, and the wrapper on the CPU) against the dense plain
    sweep, bit for bit; returns the hit."""
    ov, dv = _v3(o), _v3(d)
    if alive is None:
        alive = torch.ones(len(o), dtype=torch.bool)
    walk = sphere_obj.intersect_spheres_object(ov, dv, table, alive, tree)
    live = torch.nonzero(alive).squeeze(1)
    plain = sphere_obj.object_tree_sweep_reference(
        *(V3(*(x[live] for x in v)) for v in (ov, dv)), table, tree)
    dense = sphere_obj.intersect_spheres_object_dense(ov, dv, table, alive)
    assert walk.t.numpy().tobytes() == dense.t.numpy().tobytes()
    assert walk.sph.numpy().tobytes() == dense.sph.numpy().tobytes()
    assert torch.equal(plain[0], dense.t[live])
    assert torch.equal(plain[1], dense.sph[live])
    return walk


def _far_grazing(table, n, count, seed):
    near = ellipsoid_scenes.grazing_rays(table, n, count // 2, seed)
    far = ellipsoid_scenes.grazing_rays(table, n, count // 2, seed + 1,
                                        dist=(1000.0, 2000.0))
    return tuple(np.concatenate([a, b]) for a, b in zip(near, far))


@pytest.mark.parametrize("t", [0.0, 0.7])
@pytest.mark.parametrize("name", ["fixture", "fixture-moving",
                                  "fow-ellipsoids"])
def test_tree_walk_is_the_dense_sweep(name, t):
    table, n = _table(name, t)
    fow = name == "fow-ellipsoids"
    tree = _tree(table, n, sphere_obj.tree_prefix(
        Renderer(from_jax_compiled(_jcs(name)), device="cpu").static, table)
        if fow else None)
    assert tree.num_spheres == (484 if fow else 3) and tree.depth >= 1
    _, _, _, o, d = _sphere_inputs(name if not fow else "fixture", t, 8192,
                                   21)
    alive = torch.tensor(np.random.default_rng(2).random(len(o)) < 0.9)
    hit = _hold_to_dense(o, d, table, tree, alive)
    assert (hit.sph >= 1).sum() > 1000
    go, gd = _far_grazing(table.numpy(), n, 8192, 23)
    hit = _hold_to_dense(go, gd, table, tree)
    assert (hit.sph >= 0).sum() > 4000


def test_rounding_margin_keeps_far_grazing_hits():
    """Without its margin (the node rows' reach and coef zeroed) the walk
    loses hits of rays from 1,000-2,000 away along the ellipsoids' tangent
    planes; with it, it is the dense sweep."""
    table, n = _table("fow-ellipsoids", 0.0)
    tree = _tree(table, n, 4)
    o, d = ellipsoid_scenes.grazing_rays(table.numpy(), n, 8192, 29,
                                         dist=(1000.0, 2000.0))
    hit = _hold_to_dense(o, d, table, tree)
    bare = tree._replace(nodes=tree.nodes.clone())
    bare.nodes[:, 12:16] = 0.0
    lost = sphere_obj.intersect_spheres_object(
        _v3(o), _v3(d), table, torch.ones(len(o), dtype=torch.bool), bare)
    assert (lost.sph != hit.sph).sum() > 100


@pytest.mark.parametrize("leaf", [1, 2, 8])
def test_duplicated_spheres_keep_the_lowest_id(leaf):
    """Each of the fixture's ellipsoids three times over (in the prefix and
    past it), in leaves of 1, 2 and 8: every hit is on the first copy, as
    in the dense sweep."""
    table, n = _table("fixture-moving", 0.7)
    dup = torch.cat([table[:n], table[1:n], table[1:n]])
    S8 = -(-dup.shape[0] // 8) * 8
    dup = torch.cat([dup, torch.zeros((S8 - dup.shape[0], 16))])
    m = dup.shape[0] - (S8 - (3 * n - 2))
    tree = _tree(dup, m, 2, leaf)
    _, _, _, o, d = _sphere_inputs("fixture-moving", 0.7, 8192, 31)
    hit = _hold_to_dense(o, d, dup, tree)
    assert ((hit.sph >= 1) & (hit.sph < n)).sum() > 1000
    assert not (hit.sph >= n).any()


def test_one_leaf_tree_and_inactive_rays():
    table, n = _table("fow-ellipsoids", 0.0)
    tree = _tree(table, n, 4, leaf=n - 4)
    assert tree.depth == 0 and tree.nodes.shape[0] == 0
    _, _, _, o, d = _sphere_inputs("fixture", 0.0, 4096, 33)
    _hold_to_dense(o, d, table, tree)
    none = torch.zeros(len(o), dtype=torch.bool)
    hit = _hold_to_dense(o, d, table, tree, none)
    assert (hit.t == T_MAX).all() and (hit.sph == -1).all()


@pytest.mark.parametrize("name", ["fixture-moving", "fow-ellipsoids"])
def test_surface_samples_lie_inside_their_widened_boxes(name):
    """Every ellipsoid's surface points (float64) lie inside its world box
    widened as the tree widens a leaf's (1e-5 + 1e-5 of its size), and its
    extreme points along each axis on the box's faces: the box is the
    ellipsoid's own."""
    for t in (0.0, 0.7):
        table, n = _table(name, t)
        lo, hi, valid, reach, coef = sphere_obj.object_sphere_bounds(
            table[:n])
        assert valid.all() and (reach > 0).all() and (coef > 0).all()
        lo, hi = lo.double().numpy(), hi.double().numpy()
        pad = 1e-5 + 1e-5 * np.maximum(np.abs(lo), np.abs(hi))
        x, _ = ellipsoid_scenes.surface_points(table.numpy(), n, 256, 37)
        assert (x >= (lo - pad)[:, None]).all()
        assert (x <= (hi + pad)[:, None]).all()
        tab = table[:n].double().numpy()
        a = np.linalg.inv(tab[:, 0:12].reshape(-1, 3, 4)[:, :, 0:3])
        for i in range(3):
            # The point of largest x_i: y - c along A^T e_i.
            u = a[:, i, :] / np.linalg.norm(a[:, i, :], axis=1,
                                            keepdims=True)
            for sign, face in ((1.0, hi), (-1.0, lo)):
                top, _ = ellipsoid_scenes._surface(tab, sign * u)
                np.testing.assert_allclose(top[:, i], face[:, i],
                                           rtol=1e-6, atol=1e-5)


def test_tree_walk_matches_jax():
    name, t = "fixture-moving", 0.7
    w2o, c, r, o, d = _sphere_inputs(name, t, 8192, 7)
    table = spheres.object_sphere_table(torch.tensor(w2o), torch.tensor(c),
                                        torch.tensor(r))
    tree = _tree(table, len(c))
    hit = sphere_obj.intersect_spheres_object(
        _v3(o), _v3(d), table, torch.ones(len(o), dtype=torch.bool), tree)
    ref = jspheres.intersect_spheres(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(c), jnp.asarray(r),
                                     jnp.asarray(w2o), chunk=len(c))
    ids, t_ = hit.sph.numpy(), hit.t.numpy()
    rid, rt = np.asarray(ref.sph), np.asarray(ref.t)
    assert (rid >= 1).sum() > 1000
    same = ids == rid
    close = same & np.isclose(t_, rt, rtol=RTOL, atol=ATOL)
    assert same.mean() >= AGREEMENT and close.mean() >= AGREEMENT, (
        same.mean(), close.mean())


def test_each_scene_slice_walks_its_own_tree():
    """fow-ellipsoids cut in two slices (parallel/multichip.SceneShard, as
    a rank of the "sc" axis holds it): each slice's Renderer builds a tree
    over its own spheres past its part of the prefix, whose ids are the
    slice's table's, and its walk is the dense sweep of that table."""
    from raytrace_tpu_torch.parallel.multichip import SceneShard

    cs = from_jax_compiled(_jcs("fow-ellipsoids"))
    for rank in (0, 1):
        r = Renderer(cs, device="cpu", shard=SceneShard(rank, 2, None))
        geom = r._geometry(0)
        tree = geom.sph_obj_tree
        n = r.static.num_spheres
        assert n == 244 and tree.n_prefix == (4 if rank == 0 else 0)
        assert tree.n_prefix + tree.num_spheres == n
        assert sorted(tree.ids.tolist()) == list(range(tree.n_prefix, n))
        go, gd = _far_grazing(geom.sph_obj16.numpy(), n, 4096, 41 + rank)
        hit = _hold_to_dense(go, gd, geom.sph_obj16, tree)
        assert (hit.sph >= 0).sum() > 2000


def test_renderer_builds_the_tree_once_or_every_batch(monkeypatch):
    """fow-ellipsoids: one tree for every batch (each batch's own rows);
    its moving twin (every tenth small sphere slides): a tree each batch
    over one order, and its render the same bytes as H2's dense sweep."""
    builds = []
    build = sphere_obj.build_object_tree

    def counting(*a, **k):
        builds.append(1)
        return build(*a, **k)

    monkeypatch.setattr(sphere_obj, "build_object_tree", counting)
    r = Renderer(from_jax_compiled(_jcs("fow-ellipsoids")), device="cpu")
    assert len(builds) == 1 and r._obj_tree is not None
    g0, g1 = r._geometry(0), r._geometry(1)
    assert len(builds) == 1
    assert torch.equal(g0.sph_obj_tree.nodes, g1.sph_obj_tree.nodes)
    assert torch.equal(g1.sph_obj_tree.rows,
                       g1.sph_obj16[g1.sph_obj_tree.ids.long()])
    builds.clear()
    cs = from_jax_compiled(_jcs("fow-ellipsoids-moving"))
    m = Renderer(cs, device="cpu")
    assert m._obj_tree is None and m._obj_order is not None
    g0, g1 = m._geometry(0), m._geometry(1)
    assert len(builds) == 2
    assert torch.equal(g0.sph_obj_tree.ids, g1.sph_obj_tree.ids)
    assert not torch.equal(g0.sph_obj_tree.nodes, g1.sph_obj_tree.nodes)
    img = m.render_all()
    monkeypatch.setattr(sphere_obj, "tree_prefix", lambda *a: None)
    dense = Renderer(cs, device="cpu")
    assert dense._obj_order is None and dense._geometry(0).sph_obj_tree is None
    assert img.tobytes() == dense.render_all().tobytes()
    assert m.stats.rays_traced == dense.stats.rays_traced


def test_once_built_tree_holds_every_batch_time():
    """fow-ellipsoids' tree, built once over the first batch's rows: a
    static instance's map differs in its last bits at some other times,
    and an ellipsoid's exact box then leaves the first batch's; it stays
    inside the once-built tree's boxes (widened for that drift) at 64
    seeded times, and at each time whose box left, the walk of that
    time's rows through the once-built tree (as prepare_batch takes them
    into it) is the dense sweep on grazing rays from near and far."""
    r = Renderer(from_jax_compiled(_jcs("fow-ellipsoids")), device="cpu")
    n = r.static.num_spheres
    first = wavefront.object_table(r.scene, r.batch_times_dev[0])
    lo0, hi0, _, _, _ = sphere_obj.object_sphere_bounds(first[:n])
    lo_s, hi_s, _, _, _ = sphere_obj.object_sphere_bounds(first[:n],
                                                          static=True)
    left = []
    for t in np.random.default_rng(53).random(64):
        table = wavefront.object_table(r.scene, torch.tensor(
            t, dtype=torch.float32))
        lo, hi, _, _, _ = sphere_obj.object_sphere_bounds(table[:n])
        if ((lo < lo0) | (hi > hi0)).any():
            left.append(table)
        assert ((lo >= lo_s) & (hi <= hi_s)).all()
    assert left
    for k, table in enumerate(left):
        tree = r._obj_tree._replace(
            rows=table[r._obj_tree.ids.long()].contiguous())
        go, gd = _far_grazing(table.numpy(), n, 8192, 59 + k)
        hit = _hold_to_dense(go, gd, table, tree)
        assert (hit.sph >= 0).sum() > 4000


def test_prefix_from_the_boxes_where_the_compiler_gives_none():
    """With no compiler prefix, the leading spheres whose boxes are large
    (above BIG_FACTOR times the median) are swept densely: fow-ellipsoids'
    table with sph_prefix 0 still sweeps its ground and three large
    ellipsoids first; a scene of at most SPHERE_FLAT_MAX spheres past it
    walks no tree."""
    r = Renderer(from_jax_compiled(_jcs("fow-ellipsoids")), device="cpu")
    table = r._geometry(0).sph_obj16
    assert r.static.sph_prefix == 4
    none = dataclasses.replace(r.static, sph_prefix=0)
    assert sphere_obj.tree_prefix(none, table) == 4
    small = dataclasses.replace(none, num_spheres=4 + sphere_sweep.
                                SPHERE_FLAT_MAX)
    assert sphere_obj.tree_prefix(small, table) is None
    fixture, n = _table("fixture", 0.0)
    assert sphere_obj.tree_prefix(dataclasses.replace(
        none, num_spheres=n), fixture) is None
    # A tree whose depth is not its spheres' (or past the stack) is refused.
    tree = _tree(table, 488, 4)
    z = _v3(np.ones((8, 3), np.float32))
    with pytest.raises(ValueError, match="depth"):
        sphere_obj.intersect_spheres_object(
            z, z, table, torch.ones(8, dtype=torch.bool),
            tree._replace(depth=sphere_sweep.WALK_DEPTH + 1))
