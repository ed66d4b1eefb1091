"""The tree that the fused kernel K4 walks in its triangle forms
(ops/paged_tri.py ``soup_order``, ``build_soup_tree``; the plain version
of its walk, ``tri_tree_sweep_reference`` with the tree's slot -> id table
and a seed hit) against the dense triangle sweep, on soups and rays made
from a numpy seed, and the fused path fed through
``engine/wavefront.prepare_tris`` against the JAX package's fused kernel.

- The Morton-permuted tree's plain walk, seeded with each ray's sphere
  hit (ids below the triangles' base), bit for bit with
  ``tri_sweep_reference`` over the soup in its compiled order behind that
  hit (the sphere keeps an equal t, as the fused kernel's dense order
  does): t and id on every ray, u and v too (0 where the sphere stays),
  on tri-stress k = 1's soup, the triangle fixture's, cornell-style's and
  sphere-light-962's, with their cameras' primary rays and random rays
  around each soup; on duplicate triangles far apart in the Morton order
  (the lowest id wins whatever leaf the walk reaches first); and on seeds
  at exactly a triangle's t (the seed keeps it).
- tri-stress k = 1 with its ball moving on the fused path: one order,
  taken once from the first batch time's soup; each batch's tree a fresh
  build over that order from the batch's soup (new boxes), its walk bit
  for bit with the dense sweep at two batch times.
- The plain fused path fed through the new ``prepare_tris`` on tri-stress
  k = 1 against JAX's K4 ``render_tile_mega(..., interpret=True)`` on the
  same compiled scene and batch time: traced rays within 1%, per-sample
  channel means within 5e-3 and RMSE below 0.05 (XLA's CPU build
  contracts multiply-adds into FMAs, PyTorch does not; the limits of
  tests/test_torch_triangles.py).
- The wrapper rejects a geometry whose tree or id table does not match
  its soup (on the CPU too, before the plain version runs), and K3's
  wrapper rejects a tree with an id table.
"""

import dataclasses
import functools
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine import arrays as jarrays
from raytrace_tpu.engine import wavefront as jwavefront
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import camera as jcamera
from raytrace_tpu.ops import megakernel as jmega
from raytrace_tpu.ops import spheres as jspheres
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch.engine import Renderer, arrays, wavefront
from raytrace_tpu_torch.ops import (camera, megakernel, paged_tri,
                                    sphere_sweep, spheres, tri_sweep)
from raytrace_tpu_torch.ops.intersect import T_MAX
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.tools import light_scenes, stress_scenes

torch.set_num_threads(1)

W, H = 32, 18
R = 4096
MEAN_TOL = 5e-3
RMSE_TOL = 0.05
RAY_TOL = 0.01


def _doc(name):
    if name.startswith("tri-stress-k1"):
        obj = stress_scenes.write_sphere_obj(
            os.path.join(tempfile.mkdtemp(), "sphere-smooth.obj"))
        doc = stress_scenes.tri_stress_doc(1, obj)
        if name.endswith("moving"):
            # The ball slides and turns over the shutter of two batches.
            doc["render"]["sample_batches"] = 2
            doc["instances"][1]["transform"] = {"animated": [
                {"translate": [0.0, 1.0, 0.0]},
                {"translate": [0.6, 1.0, 0.0],
                 "rotate": {"axis": [0, 1, 0], "degrees": 30.0}}]}
        return doc
    if name in light_scenes.DOCS:
        return light_scenes.DOCS[name]()
    return stress_scenes.triangle_fixture_doc()


@functools.lru_cache(maxsize=None)
def _jcs(name):
    cs = jax_compile_scene(JaxSceneFile.from_json_dict(_doc(name)), width=W,
                           height=H)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=6))


def _v3(a):
    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _random_rays(wp, n, seed):
    """n rays from around the soup towards points of random triangles, a
    tenth in random directions."""
    g = np.random.default_rng(seed)
    wp = wp.astype(np.float64)
    lo, hi = wp.min((0, 1)), wp.max((0, 1))
    span = np.maximum(hi - lo, 1.0)
    o = g.uniform(lo - span, hi + span, (n, 3))
    j = g.integers(0, len(wp), n)
    d = np.einsum("rv,rvi->ri", g.dirichlet(np.ones(3), n), wp[j]) - o
    d[:n // 10] = g.standard_normal((n // 10, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _v3(o.astype(np.float32)), _v3(d.astype(np.float32))


def _cat(a: V3, b: V3) -> V3:
    return V3(*(torch.cat([x, y]) for x, y in zip(a, b)))


def _assert_walk_is_dense(tris, o, d, seed, s_pad):
    """The soup tree's plain walk from ``seed`` bit for bit with the dense
    sweep over the soup's rows in their own order behind the seed (a
    triangle replaces the seed only when strictly closer)."""
    tree = tris["tri_tree"]
    hit = paged_tri.tri_tree_sweep_reference(o, d, tree, seed=seed,
                                             id_base=s_pad)
    t, ids, u, v = tri_sweep.tri_sweep_reference(o, d, tris["tri_table16"])
    tri_wins = t < seed[0]
    want = (torch.where(tri_wins, t, seed[0]),
            torch.where(tri_wins, s_pad + ids, seed[1]),
            torch.where(tri_wins, u, 0.0), torch.where(tri_wins, v, 0.0))
    for a, b in zip(hit, want):
        assert torch.equal(a, b)
    return hit, tri_wins


def _scene_soup(name):
    """The port's static, scene and batch-0 triangle fields of a scene."""
    cs = arrays.from_jax_compiled(_jcs(name))
    scene, static = arrays.upload_scene(cs, "cpu")
    static = dataclasses.replace(static, sphere_world_mode=True)
    return cs, scene, static, wavefront.prepare_tris(
        static, scene, torch.tensor(np.float32(0.0)))


# ---- the soup's tree --------------------------------------------------------

@pytest.mark.parametrize("name", ["tri-stress-k1", "fixture", "cornell-style",
                                  "sphere-light-962"])
def test_soup_tree_walk_is_the_dense_sweep_behind_the_spheres(name):
    cs, scene, static, tris = _scene_soup(name)
    n = static.num_triangles
    tree = tris["tri_tree"]
    # The tree: the Morton order of the world soup's centroids, the rows
    # and world triangles permuted by it, one id a real triangle.
    order = paged_tri.paged_tri_order(
        tris["world_p"][:n].double().numpy(), n)
    assert torch.equal(tree.ids, torch.tensor(order, dtype=torch.int32))
    assert torch.equal(tree.tris, tris["tri_table12"][tree.ids.long()])
    fresh = paged_tri.build_tri_tree(tris["world_p"][tree.ids.long()], n,
                                     leaf=paged_tri.soup_leaf(n))
    assert torch.equal(tree.nodes, fresh.nodes) and tree.depth == fresh.depth
    assert tree.depth <= megakernel.MAX_TRI_DEPTH
    # Small soups are one leaf (the flat sweep), larger ones a tree.
    assert (tree.depth == 0) == (n <= paged_tri.SOUP_FLAT_MAX)
    # Rays: the camera's primary rays and random rays about the soup.
    cam = camera.build_camera_arrays(cs.cameras[cs.render.camera], W, H,
                                     "cpu")
    _, po, pd = wavefront.primary_rays(static, cam, 0, 0, H,
                                       cs.cameras[cs.render.camera]
                                       .aperture_size > 0.0, "cpu")
    ro, rd = _random_rays(tris["world_p"][:n].numpy(), R, seed=n)
    o, d = _cat(po, ro), _cat(pd, rd)
    # The seed: each ray's sphere hit, as the fused kernel sweeps first.
    tab = spheres.world_sphere_tables(cs, np.array([0.0], np.float32))[0]
    s_pad = scene.sph_center.shape[0]
    table8 = sphere_sweep.pad_table8(torch.tensor(tab))
    seed = sphere_sweep.sphere_sweep_reference(o, d, table8[:s_pad])
    hit, tri_wins = _assert_walk_is_dense(tris, o, d, seed, s_pad)
    assert tri_wins.double().mean() > 0.05
    if static.has_spheres:
        assert ((~tri_wins) & (hit[1] >= 0)).any()


def _dup_soup(T, seed):
    """T random small triangles, four copies of one at rows far apart."""
    g = np.random.default_rng(seed)
    c = g.uniform(-5, 5, (T, 3))
    tri = (c[:, None, :] + g.uniform(-0.8, 0.8, (T, 3, 3))).astype(np.float32)
    tri[[3, T // 2, T - 2]] = tri[T // 3]
    return tri


def _soup_fields(tri):
    T = tri.shape[0]
    wp = torch.tensor(tri)
    table16 = tri_sweep.pack_tri_table(wp, T)
    table12 = megakernel.tri_table12(table16)
    tree = paged_tri.build_soup_tree(wp, T, table12,
                                     paged_tri.soup_order(wp, T))
    return dict(world_p=wp, tri_table16=table16, tri_table12=table12,
                tri_tree=tree)


@pytest.mark.parametrize("order", ["morton", "random"])
def test_soup_tree_walk_on_duplicate_triangles(order):
    """Copies of one triangle: the lowest id wins at equal t, whichever
    copy's leaf the walk reaches first.  In Morton order the copies sit
    side by side (one centroid), in ascending id; over a random
    permutation (a loose tree, but any order must give the same bits)
    they sit in four leaves, the lowest id not first."""
    T = 2000
    tri = _dup_soup(T, seed=1)
    tris = _soup_fields(tri)
    if order == "random":
        perm = np.random.default_rng(7).permutation(T).astype(np.int32)
        tris["tri_tree"] = paged_tri.build_soup_tree(
            tris["world_p"], T, tris["tri_table12"], torch.tensor(perm))
    slots = torch.argsort(tris["tri_tree"].ids.long())   # id -> slot
    copies = [3, T // 3, T // 2, T - 2]
    leaves = [int(slots[j]) // paged_tri.LEAF for j in copies]
    assert len(set(leaves)) == (2 if order == "morton" else 4)
    assert (leaves == sorted(leaves)) == (order == "morton")
    # Random rays, and rays from around the copy towards it.
    o, d = _random_rays(tri, R, seed=2)
    co, cd = _random_rays(tri[[T // 3]], R, seed=3)
    o, d = _cat(o, co), _cat(d, cd)
    none = (torch.full((2 * R,), T_MAX),
            torch.full((2 * R,), -1, dtype=torch.int32))
    hit, _ = _assert_walk_is_dense(tris, o, d, none, 0)
    assert (hit[1] == 3).sum() > 100
    assert not torch.isin(hit[1], torch.tensor(copies[1:],
                                               dtype=torch.int32)).any()


def test_soup_tree_walk_keeps_a_seed_at_equal_t():
    """A seed (a sphere, ids below the triangles') at exactly the closest
    triangle's t keeps the hit; a seed a step further loses it."""
    T = 500
    tri = _dup_soup(T, seed=3)
    tris = _soup_fields(tri)
    o, d = _random_rays(tri, R, seed=4)
    t, ids, _, _ = tri_sweep.tri_sweep_reference(o, d, tris["tri_table16"])
    hit_rays = t < T_MAX
    assert hit_rays.double().mean() > 0.3
    s_pad = 8
    sid = torch.full((R,), 5, dtype=torch.int32)
    tie = (torch.where(hit_rays, t, T_MAX), torch.where(hit_rays, sid, -1))
    hit, tri_wins = _assert_walk_is_dense(tris, o, d, tie, s_pad)
    assert not tri_wins.any() and torch.equal(hit[1][hit_rays], sid[hit_rays])
    after = (torch.where(hit_rays, torch.nextafter(t, torch.tensor(T_MAX)),
                         T_MAX), tie[1])
    hit, tri_wins = _assert_walk_is_dense(tris, o, d, after, s_pad)
    assert torch.equal(tri_wins, hit_rays)
    assert torch.equal(hit[1][hit_rays], s_pad + ids[hit_rays])


def test_moving_soup_refits_its_tree_over_one_order():
    cs = arrays.from_jax_compiled(_jcs("tri-stress-k1-moving"))
    r = Renderer(cs, device="cpu", use_megakernel=True)
    assert r.path == "fused_per_batch" and r._tri_order is not None
    n = r.static.num_triangles
    _, wp0, _ = wavefront.world_soup(r.scene, r.batch_times_dev[0])
    assert torch.equal(r._tri_order, paged_tri.soup_order(wp0, n))
    trees = []
    for b in (0, r.compiled.render.sample_batches - 1):
        geom = r._geometry(b)
        tree = geom.tri_tree
        assert torch.equal(tree.ids, r._tri_order)
        fresh = paged_tri.build_soup_tree(geom.world_p, n, geom.tri_table12,
                                          r._tri_order)
        assert torch.equal(tree.nodes, fresh.nodes)
        assert torch.equal(tree.tris, fresh.tris)
        assert tree.depth > 0
        o, d = _random_rays(geom.world_p[:n].numpy(), R, seed=b)
        none = (torch.full((R,), T_MAX),
                torch.full((R,), -1, dtype=torch.int32))
        _assert_walk_is_dense(geom._asdict(), o, d, none, 0)
        trees.append(tree)
    assert r.batch_times[0] != r.batch_times[-1]
    assert not torch.equal(trees[0].nodes, trees[1].nodes)


# ---- the fused path through prepare_tris ------------------------------------

def test_plain_fused_path_through_the_soup_tree_matches_jax_k4():
    name = "tri-stress-k1"
    jcs = _jcs(name)
    jscene, jstatic = jarrays.upload_scene(jcs)
    jstatic = dataclasses.replace(jstatic, use_pallas_sweep=True,
                                  pallas_interpret=True,
                                  sphere_world_mode=True)
    assert jmega.megakernel_supported(jstatic)
    jcam = jcamera.build_camera_arrays(jcs.cameras[jcs.render.camera], W, H)
    t = np.float32(0.5)
    tab = jspheres.world_sphere_tables(jcs, np.array([t], np.float32))[0]
    jgeom = jwavefront.prepare_batch(jstatic, jscene, jnp.float32(t),
                                     sph_table=tab)
    jsums, jrays, _, _ = jmega.render_tile_mega(
        jstatic, jscene, jgeom, jcam, jnp.int32(0), jnp.int32(0), H, False,
        interpret=True, reduce_mean=False, n_batches=1)

    cs = arrays.from_jax_compiled(jcs)
    scene, static = arrays.upload_scene(cs, "cpu")
    static = dataclasses.replace(static, sphere_world_mode=True)
    assert megakernel.megakernel_supported(static)
    tt = torch.tensor(t)
    tris = wavefront.prepare_tris(static, scene, tt)
    assert "tri_boxes" not in tris and tris["tri_tree"].ids is not None
    geom = wavefront.prepare_batch(static, scene, torch.tensor(tab),
                                   tris=tris, batch_time=tt)
    cam = camera.build_camera_arrays(cs.cameras[cs.render.camera], W, H,
                                     "cpu")
    before = megakernel.TRI_LAUNCHES
    sums, traced = megakernel.render_tile_mega(static, scene, geom, cam, 0,
                                               1, use_dof=False)
    assert megakernel.TRI_LAUNCHES == before
    K = static.sqrt_spp ** 2
    img, ref = sums.numpy() / K, np.asarray(jsums) / K
    assert np.isfinite(img).all() and (img >= 0).all()
    mdiff = np.abs(img.mean((0, 1)) - ref.mean((0, 1))).max()
    rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    assert mdiff <= MEAN_TOL and rmse <= RMSE_TOL, (mdiff, rmse)
    rays, jr = int(traced.sum()), float(jrays)
    assert abs(rays - jr) <= RAY_TOL * jr, (rays, jr)


# ---- the wrappers -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fused_args():
    cs = arrays.from_jax_compiled(_jcs("tri-stress-k1"))
    r = Renderer(cs, device="cpu", use_megakernel=True)
    assert r.path == "fused"
    return r.static, r.scene, r._geometry(0), r.camera


def _bad_trees(tree):
    n = tree.num_tris
    yield "id table", tree._replace(ids=None)
    yield "ids", tree._replace(ids=tree.ids[:-1])
    yield "ids", tree._replace(ids=tree.ids.long())
    yield "holds", tree._replace(num_tris=n - 1)
    yield "nodes", tree._replace(nodes=tree.nodes[:-1])
    yield "fewer rows", tree._replace(tris=tree.tris[:n - 1])


@pytest.mark.parametrize("case", range(6))
def test_fused_wrapper_rejects_trees_that_do_not_match(case):
    static, scene, geom, cam = _fused_args()
    assert geom.tri_tree.depth > 0
    match, bad = list(_bad_trees(geom.tri_tree))[case]
    before = megakernel.LAUNCHES
    with pytest.raises(ValueError, match=match):
        megakernel.render_tile_mega(static, scene,
                                    geom._replace(tri_tree=bad), cam, 0, 1,
                                    use_dof=False)
    assert megakernel.LAUNCHES == before


def test_fused_wrapper_needs_the_tree_within_its_stack():
    static, scene, geom, cam = _fused_args()
    with pytest.raises(ValueError, match="tree"):
        megakernel.render_tile_mega(static, scene,
                                    geom._replace(tri_tree=None), cam, 0, 1,
                                    use_dof=False)
    # One leaf more than the walk's stack holds: a level deeper.
    depth = megakernel.MAX_TRI_DEPTH + 1
    leaf = geom.tri_tree.leaf
    n = leaf * ((1 << (depth - 1)) + 1)
    cfg = megakernel.make_config(static, geom, False, 1)._replace(n_tris=n)
    deep = geom.tri_tree._replace(num_tris=n, depth=depth)
    with pytest.raises(ValueError, match="stack"):
        megakernel._check_tris(cfg, geom._replace(tri_tree=deep), "cpu")


def test_paged_wrapper_rejects_a_tree_with_an_id_table():
    tris = _soup_fields(_dup_soup(300, seed=5))
    o, d = _random_rays(tris["world_p"].numpy(), 64, seed=6)
    with pytest.raises(ValueError, match="id table"):
        paged_tri.intersect_tris_paged(o, d, tris["tri_tree"],
                                       torch.ones(64, dtype=torch.bool))


# ---- the shared source and the register pins -------------------------------

# The twenty K4 forms without triangles, as they compile with the loop of
# steps and per-lane regeneration and, in their clustered twins, the
# sphere tree's walk, in their noise forms the lattice tables and in their
# image forms the early texel fetch (re-pinned with each): the triangle
# walk moves none of them.
_NO_TRIANGLE_FORMS = {
    "static": (64, 0), "anim": (64, 0), "lights": (64, 0),
    "static+noise": (80, 4), "anim+noise": (80, 0), "lights+noise": (80, 4),
    "static+image": (64, 0), "lights+image": (64, 0),
    "static+noise+image": (80, 0), "lights+noise+image": (80, 0),
    "static+clusters": (64, 0), "anim+clusters": (64, 0),
    "lights+clusters": (64, 0), "static+image+clusters": (64, 0),
    "lights+image+clusters": (64, 0), "static+noise+clusters": (72, 0),
    "anim+noise+clusters": (80, 4), "lights+noise+clusters": (80, 4),
    "static+noise+image+clusters": (80, 0),
    "lights+noise+image+clusters": (80, 0)}


def test_one_walk_for_k3_and_k4_and_the_form_pins():
    from raytrace_tpu_torch.ops import _build
    from raytrace_tpu_torch.tools import smoke_lib

    k3 = (_build.CSRC / "paged_tri.cu").read_text()
    k4 = (_build.CSRC / "megakernel.cu").read_text()
    for src in (k3, k4):
        assert '#include "tri_tree.cuh"' in src and "tri_tree::walk<" in src
    params = k4[k4.index("#define MEGA_PARAMS"):k4.index("#define MEGA_ARGS")]
    for gone in ("tri_boxes", "cluster_g"):
        assert gone not in k4
    assert "n_clusters" not in params and "tri_ids" in params
    pins = {**smoke_lib.FORMS_BEFORE, **smoke_lib.IMAGE_FORMS_BEFORE,
            **smoke_lib.CLUSTER_FORMS_BEFORE}
    assert {f: p for f, p in pins.items() if "tris" not in f} == (
        _NO_TRIANGLE_FORMS)
    assert sum("tris" in f for f in pins) == 16
    assert smoke_lib.K3_BEFORE == (48, 0)
