"""The wavefront's two sweeps as tree walks: K2 over the soup's tree
(ops/paged_tri.build_soup_tree) and K1 over the sphere tree past the
scene's dense prefix (ops/sphere_tree.build_sphere_tree,
ops/sphere_sweep.tree_prefix).  The CUDA walks are held against their
dense entry points and plain versions in test_torch_cuda.py; here their
plain versions are held against the dense plain versions and the JAX
package's Pallas kernels in interpret mode.

Tolerances: the plain tree walks equal the dense plain sweeps
(ops/tri_sweep.tri_sweep_reference, ops/sphere_sweep.
sphere_sweep_reference) bit for bit in t, id, u and v, on every ray,
inactive rays masked; against the JAX Pallas kernels (interpret mode) the
tolerances of test_torch_tri_sweep.py and test_torch_sphere_sweep.py:
ids, and ids with t (u, v) within rtol=1e-3, atol=1e-3, each on >= 99.9%
of rays (XLA's CPU build contracts multiply-adds into FMAs, and PyTorch's
elementwise kernels do not); the CPU wavefront render of
final-one-weekend against the live JAX wavefront as test_torch_render.py
holds it at depth 1: equal ray counts and >= 99.5% of pixels within 1e-6.
"""

import dataclasses
import functools
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import pallas_sweep as jsweep
from raytrace_tpu.ops import pallas_tri_sweep as jtri
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer, wavefront
from raytrace_tpu_torch.engine.arrays import from_jax_compiled
from raytrace_tpu_torch.models import compile_scene
from raytrace_tpu_torch.ops import (megakernel, paged_tri, sphere_sweep,
                                    sphere_tree, tri_sweep)
from raytrace_tpu_torch.ops.intersect import T_MAX
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.scene_file import SceneFile
from raytrace_tpu_torch.tools import light_scenes, stress_scenes

torch.set_num_threads(1)

AGREEMENT = 0.999
RTOL = ATOL = 1e-3
MB_SCENE = cli.DEFAULT_SCENE.replace("final-one-weekend.json",
                                     "final-one-weekend-motion-blur.json")
BLOCK = 2048   # the Pallas kernels' ray block


def _doc(name):
    if name == "tri-stress-k1":
        obj = stress_scenes.write_sphere_obj(
            os.path.join(tempfile.mkdtemp(), "sphere-smooth.obj"))
        return stress_scenes.tri_stress_doc(1, obj)
    if name == "cornell-style":
        return light_scenes.cornell_doc()
    path = MB_SCENE if name == "motion-blur" else cli.DEFAULT_SCENE
    return SceneFile.load_json(path)


@functools.lru_cache(maxsize=None)
def _renderer(name, w=32, h=18):
    """A CPU wavefront Renderer of the scene at w x h, 4 spp, 2 batches,
    depth 6."""
    doc = _doc(name)
    scene = doc if isinstance(doc, SceneFile) else SceneFile.from_json_dict(
        doc)
    cs = compile_scene(scene, width=w, height=h)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=4, sample_batches=2, max_ray_depth=6))
    r = Renderer(cs, device="cpu", use_megakernel=False)
    assert r.path == "wavefront"
    return r


@functools.lru_cache(maxsize=None)
def _bounces(name, batch=0):
    """(geometry, [(o, d, alive)] of bounces 0-2) of one batch of the
    scene's CPU wavefront."""
    r = _renderer(name)
    geom = r._geometry(batch)
    trace = wavefront.make_trace_fn(r.static, r.scene, geom)
    seen = []

    def capture(o, d, alive):
        seen.append((o, d, alive))
        return trace(o, d, alive)

    wavefront.render_tile(r.static, r.scene, r.camera, capture, geom, batch,
                          0, r.static.height, r.use_dof)
    assert len(seen) >= 3
    return geom, seen[:3]


def _v3(a):
    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i], np.float32))
                for i in range(3)))


def _assert_tri_walk_is_dense(o, d, alive, table16, tree):
    t0, id0, u0, v0 = tri_sweep.tri_sweep_reference(o, d, table16)
    dense = (torch.where(alive, t0, T_MAX), torch.where(alive, id0, -1),
             torch.where(alive, u0, 0.0), torch.where(alive, v0, 0.0))
    walk = paged_tri.tri_tree_sweep_reference(o, d, tree, alive)
    for a, b in zip(dense, walk):
        assert torch.equal(a, b)
    # The wrapper on the CPU is the plain dense version, with or without
    # the tree.
    hit = tri_sweep.intersect_tris_sweep(o, d, table16, alive, tree)
    for a, b in zip(dense, hit):
        assert torch.equal(a, b)
    return (id0[alive] >= 0).double().mean().item()


def _assert_sphere_walk_is_dense(o, d, alive, table8, tree):
    t0, id0 = sphere_sweep.sphere_sweep_reference(o, d, table8)
    t1, id1 = sphere_tree.sphere_tree_sweep_reference(o, d, table8, tree)
    mask = lambda t, i: (torch.where(alive, t, T_MAX),  # noqa: E731
                         torch.where(alive, i, -1))
    assert all(torch.equal(a, b) for a, b in zip(mask(t0, id0),
                                                 mask(t1, id1)))
    hit = sphere_sweep.intersect_spheres_sweep(o, d, table8, alive, tree)
    assert torch.equal(hit.t, mask(t0, id0)[0])
    assert torch.equal(hit.sph, mask(t0, id0)[1])
    return (id1[alive] >= tree.n_prefix).double().mean().item()


# ---- K2: the soup's tree walked, bit for bit with the dense sweep ----------

@pytest.mark.parametrize("name,leaf,depth", [("tri-stress-k1", 2, 9),
                                             ("cornell-style", 36, 0)])
def test_tri_walk_is_the_dense_sweep_on_the_wavefronts_rays(name, leaf,
                                                            depth):
    """tri-stress at k = 1 (960 triangles in leaves of 2) and cornell-style
    (36 triangles, one leaf): every ray of bounces 0-2."""
    geom, bounces = _bounces(name)
    tree = geom.tri_tree
    assert tree.ids is not None and (tree.leaf, tree.depth) == (leaf, depth)
    hits = [_assert_tri_walk_is_dense(o, d, a, geom.tri_table16, tree)
            for o, d, a in bounces]
    assert max(hits) > 0.05


def test_tri_walk_keeps_the_lowest_id_on_duplicates():
    """A random soup with exact duplicates (equal t on every ray that hits
    either) and an alive mask: the lowest id wins, as in the dense order."""
    g = np.random.default_rng(21)
    tri = g.uniform(-2, 2, (301, 3, 3)).astype(np.float32) * 0.3 \
        + g.uniform(-2, 2, (301, 1, 3)).astype(np.float32)
    tri[200], tri[17], tri[300] = tri[5], tri[260], tri[0]
    wp = torch.tensor(tri)
    table16 = tri_sweep.pack_tri_table(wp, 301)
    table12 = megakernel.tri_table12(table16)
    tree = paged_tri.build_soup_tree(wp, 301, table12,
                                     paged_tri.soup_order(wp, 301))
    R = 6000
    o = g.uniform(-4, 4, (R, 3))
    j = g.choice([0, 5, 17, 200, 260, 300], R)
    j[: R // 2] = g.integers(0, 301, R // 2)
    w = g.dirichlet(np.ones(3), R)
    d = np.einsum("rv,rvi->ri", w, tri[j].astype(np.float64)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = torch.tensor(g.random(R) < 0.8)
    _assert_tri_walk_is_dense(_v3(o), _v3(d), alive, table16, tree)
    ids = paged_tri.tri_tree_sweep_reference(_v3(o), _v3(d), tree, alive)[1]
    assert not ((ids == 200) | (ids == 260) | (ids == 300)).any()
    assert ((ids == 5) | (ids == 17) | (ids == 0)).sum() > 100


def test_tri_walk_matches_the_pallas_kernel():
    """The port's walk on tri-stress k = 1's primary rays against JAX's
    tri_sweep_pallas in interpret mode."""
    geom, bounces = _bounces("tri-stress-k1")
    o, d, alive = bounces[0]
    o, d = (V3(*(c[:BLOCK] for c in v)) for v in (o, d))
    alive = torch.ones(BLOCK, dtype=torch.bool)
    t, ids, u, v = paged_tri.tri_tree_sweep_reference(o, d, geom.tri_tree,
                                                      alive)
    jt, jids, ju, jv = (np.asarray(x) for x in jtri.tri_sweep_pallas(
        jnp.asarray(geom.tri_table16.numpy()),
        jnp.asarray(torch.stack(list(o)).numpy()),
        jnp.asarray(torch.stack(list(d)).numpy()), interpret=True))
    ok = ids.numpy() == jids
    assert ok.mean() >= AGREEMENT
    for a, b in ((t, jt), (u, ju), (v, jv)):
        ok &= np.isclose(a.numpy(), b, rtol=RTOL, atol=ATOL)
    assert ok.mean() >= AGREEMENT
    assert (ids >= 0).double().mean() > 0.05


# ---- K1: the prefix, then the sphere tree, bit for bit with the dense ------

@pytest.mark.parametrize("name,batch", [("final-one-weekend", 0),
                                        ("motion-blur", 1)])
def test_sphere_walk_is_the_dense_sweep_on_the_wavefronts_rays(name, batch):
    """final-one-weekend (a prefix of large spheres, then 484 in the tree)
    and a batch of its motion-blur twin, whose wavefront table is at the
    batch's time and whose tree is built again over it in the Renderer's
    order: every ray of bounces 0-2."""
    r = _renderer(name)
    geom, bounces = _bounces(name, batch)
    tree = geom.sph_tree
    n_prefix = r.static.sph_prefix
    assert n_prefix > 0 and tree.n_prefix == n_prefix
    assert tree.drows is None and torch.equal(tree.ids, r._sph_order)
    assert torch.equal(tree.rows, geom.sph_table8[tree.ids.long()])
    if name == "motion-blur":
        assert r._sph_tree is None   # built per batch, at the batch's time
    in_tree = [_assert_sphere_walk_is_dense(o, d, a, geom.sph_table8, tree)
               for o, d, a in bounces]
    assert max(in_tree) > 0.05


def test_sphere_walk_without_a_prefix():
    """A scene with no dense prefix (sph_prefix = 0): the tree holds every
    sphere, the ground's 1000-radius sphere too."""
    r = _renderer("final-one-weekend")
    static = dataclasses.replace(r.static, sph_prefix=0)
    assert sphere_sweep.tree_prefix(static) == 0
    table = torch.tensor(r.sphere_tables[0])
    geom = wavefront.prepare_batch(static, r.scene, table)
    tree = geom.sph_tree
    assert (tree.n_prefix, tree.num_spheres) == (0, static.num_spheres)
    _, bounces = _bounces("final-one-weekend")
    for o, d, a in bounces:
        _assert_sphere_walk_is_dense(o, d, a, geom.sph_table8, tree)


def _sphere_table(n, seed, prefix=0, radius=0.05):
    """[S8, 8] table: ``prefix`` large spheres, then ``n`` small ones of
    random radius in a 20-unit cube; returns (table8, rays' o, d)."""
    g = np.random.default_rng(seed)
    c = g.uniform(-10, 10, (prefix + n, 3))
    r = g.uniform(0.5, 1.0, prefix + n) * radius
    c[:prefix] = g.uniform(-10, 10, (prefix, 3)) + [0, -1010, 0]
    r[:prefix] = 1000.0
    tab = np.zeros((prefix + n, 5))
    tab[:, 0:3], tab[:, 3] = c, r
    tab[:, 4] = (c ** 2).sum(1) - r ** 2
    return sphere_sweep.pad_table8(torch.tensor(tab.astype(np.float32)))


def _rays_at(table8, n_sph, R, seed):
    """Rays from around the spheres at random spheres' centres (most hit),
    a tenth in random directions, some starting inside a sphere."""
    g = np.random.default_rng(seed)
    tab = table8[:n_sph].numpy().astype(np.float64)
    o = g.uniform(-12, 12, (R, 3))
    j = g.integers(0, n_sph, R)
    d = tab[j, :3] + g.standard_normal((R, 3)) * tab[j, 3:4] * 0.5 - o
    d[: R // 10] = g.standard_normal((R // 10, 3))
    o[R - R // 10:] = tab[j[R - R // 10:], :3]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _v3(o), _v3(d), torch.tensor(g.random(R) < 0.85)


def _tree_over(table8, n_prefix, n_sph):
    ids = torch.tensor(sphere_tree.sphere_order(
        table8[:, 0:3].numpy(), n_prefix, n_sph), dtype=torch.int32)
    return sphere_tree.build_sphere_tree(table8, n_prefix, n_sph, ids)


@pytest.mark.parametrize("prefix", [0, 3])
def test_sphere_walk_keeps_the_lowest_id_on_duplicates(prefix):
    """Exact duplicates inside the tree, and of a prefix sphere in the
    tree: equal t on every ray that hits either, and the lowest id wins."""
    table8 = _sphere_table(400, seed=31 + prefix, prefix=prefix, radius=0.4)
    n = prefix + 400
    for lo, hi in ((prefix + 7, prefix + 390), (prefix + 100, prefix + 101)):
        table8[hi] = table8[lo]
    if prefix:
        table8[prefix + 50] = table8[prefix + 60] = table8[1]
        table8[[prefix + 50, prefix + 60], 3] = 1000.0
    tree = _tree_over(table8, prefix, n)
    o, d, alive = _rays_at(table8, n, 5000, seed=32)
    _assert_sphere_walk_is_dense(o, d, alive, table8, tree)
    ids = sphere_tree.sphere_tree_sweep_reference(o, d, table8, tree)[1]
    assert not ((ids == prefix + 390) | (ids == prefix + 101)).any()
    assert ((ids == prefix + 7) | (ids == prefix + 100)).any()
    if prefix:
        assert (ids == 1).any()
        assert not ((ids == prefix + 50) | (ids == prefix + 60)).any()


@pytest.mark.parametrize("n,leaf,depth", [(20000, 8, 12),
                                          (140000, 8, 15)])
def test_sphere_walk_beyond_the_fused_gate(n, leaf, depth):
    """More spheres than the fused gate's 16,384, and a tree deeper than
    K4's stack (MAX_SPHERE_DEPTH): K1's check takes it at WALK_DEPTH, and
    its walk is the dense sweep on a few hundred rays."""
    table8 = _sphere_table(n, seed=n, prefix=1)
    tree = _tree_over(table8, 1, n + 1)
    assert (tree.leaf, tree.depth) == (leaf, depth)
    if depth > sphere_tree.MAX_SPHERE_DEPTH:
        with pytest.raises(ValueError, match="deeper than"):
            sphere_tree.check_tree(tree, table8, 1, n + 1, anim=False)
    sphere_tree.check_tree(tree, table8, 1, n + 1, anim=False,
                           max_depth=sphere_sweep.WALK_DEPTH)
    o, d, alive = _rays_at(table8, n + 1, 300, seed=n + 1)
    assert _assert_sphere_walk_is_dense(o, d, alive, table8, tree) > 0.3


def test_sphere_walk_matches_the_pallas_kernel():
    """The port's walk on final-one-weekend's bounce-1 rays against JAX's
    sphere_sweep_pallas in interpret mode."""
    geom, bounces = _bounces("final-one-weekend")
    o, d, _ = bounces[1]
    o, d = (V3(*(c[:BLOCK] for c in v)) for v in (o, d))
    t, ids = sphere_tree.sphere_tree_sweep_reference(o, d, geom.sph_table8,
                                                     geom.sph_tree)
    jt, jid = (np.asarray(x) for x in jsweep.sphere_sweep_pallas(
        jnp.asarray(geom.sph_table8.numpy()),
        jnp.asarray(torch.stack(list(o)).numpy()),
        jnp.asarray(torch.stack(list(d)).numpy()), interpret=True))
    same = ids.numpy() == jid
    agree = same & (np.abs(t.numpy() - jt) <= ATOL + RTOL * np.abs(jt))
    assert same.mean() >= AGREEMENT and agree.mean() >= AGREEMENT
    assert (ids >= 0).double().mean() > 0.3


# ---- the Renderer, the prefix rule and the wrappers ------------------------

def test_tree_prefix_rule():
    static = _renderer("final-one-weekend").static
    n = static.num_spheres
    cut = sphere_sweep.SPHERE_FLAT_MAX
    assert sphere_sweep.tree_prefix(static) == static.sph_prefix
    for prefix, n_sph, want in ((0, cut + 1, 0), (0, cut, None),
                                (4, cut + 4, None), (4, cut + 5, 4),
                                (n + 5, n, None)):
        s = dataclasses.replace(static, sph_prefix=prefix,
                                num_spheres=n_sph)
        assert sphere_sweep.tree_prefix(s) == want
    # No tree on a scene with too few spheres: K1 sweeps the table.
    r = _renderer("tri-stress-k1")
    assert r.static.num_spheres <= cut and r._geometry(0).sph_tree is None


@pytest.fixture(scope="module")
def jax_depth1():
    jcs = jax_compile_scene(JaxSceneFile.load_json(cli.DEFAULT_SCENE),
                            width=96, height=54)
    jcs = dataclasses.replace(jcs, render=dataclasses.replace(
        jcs.render, samples_per_pixel=4, sample_batches=1, max_ray_depth=1))
    r = JaxRenderer(jcs, use_pallas_sweep=False)
    r.render_next_batch()
    return jcs, r


def test_cpu_wavefront_renderer_builds_the_sphere_tree(jax_depth1):
    """The CPU Renderer with use_megakernel=False builds K1's tree once for
    a static scene, and its render still matches the live JAX wavefront."""
    jcs, jr = jax_depth1
    port = Renderer(from_jax_compiled(jcs), device="cpu",
                    use_megakernel=False)
    assert port.path == "wavefront"
    tree = port._geometry(0).sph_tree
    assert tree is port._sph_tree and tree.n_prefix == port.static.sph_prefix
    assert tree.n_prefix + tree.num_spheres == port.static.num_spheres
    img = port.render_all()
    assert port.stats.rays_traced == int(jr.stats.rays_traced)
    close = np.abs(img - jr.image()).max(axis=-1) <= 1e-6
    assert close.mean() >= 0.995


def test_wrappers_check_their_trees_on_the_cpu():
    geom, bounces = _bounces("tri-stress-k1")
    o, d, alive = bounces[0]
    before = (tri_sweep.LAUNCHES, sphere_sweep.LAUNCHES)
    with pytest.raises(ValueError, match="slot -> id"):
        tri_sweep.intersect_tris_sweep(o, d, geom.tri_table16, alive,
                                       geom.tri_tree._replace(ids=None))
    with pytest.raises(ValueError, match="depth"):
        tri_sweep.intersect_tris_sweep(o, d, geom.tri_table16, alive,
                                       geom.tri_tree._replace(depth=30))
    dense = tri_sweep.intersect_tris_dense(o, d, geom.tri_table16, alive)
    walk = tri_sweep.intersect_tris_sweep(o, d, geom.tri_table16, alive,
                                          geom.tri_tree)
    assert all(torch.equal(a, b) for a, b in zip(dense, walk))
    # A moving tree (K4's animated form) is not K1's.
    sgeom, sb = _bounces("final-one-weekend")
    so, sd, salive = sb[0]
    tree = sgeom.sph_tree
    moving = tree._replace(drows=tree.rows.clone())
    with pytest.raises(ValueError, match="motion rows"):
        sphere_sweep.intersect_spheres_sweep(so, sd, sgeom.sph_table8,
                                             salive, moving)
    dense = sphere_sweep.intersect_spheres_dense(so, sd, sgeom.sph_table8,
                                                 salive)
    walk = sphere_sweep.intersect_spheres_sweep(so, sd, sgeom.sph_table8,
                                                salive, tree)
    assert torch.equal(dense.t, walk.t) and torch.equal(dense.sph, walk.sph)
    # The CPU launches no kernel.
    assert (tri_sweep.LAUNCHES, sphere_sweep.LAUNCHES) == before


def test_trace_refuses_a_geometry_without_k1s_tree():
    """make_trace_fn raises where the batch's sphere tree is not the one
    K1 walks: none where one pays (the fused path's geometry of a scene
    past its cluster gate), or one where K1 sweeps every sphere."""
    r = _renderer("final-one-weekend")
    geom = r._geometry(0)
    assert sphere_sweep.tree_prefix(r.static) is not None
    with pytest.raises(ValueError, match="the batch's geometry has none"):
        wavefront.make_trace_fn(r.static, r.scene,
                                geom._replace(sph_tree=None))
    moved = geom.sph_tree._replace(n_prefix=geom.sph_tree.n_prefix + 1)
    with pytest.raises(ValueError, match="has one past the first"):
        wavefront.make_trace_fn(r.static, r.scene,
                                geom._replace(sph_tree=moved))
    t = _renderer("tri-stress-k1")
    tgeom = t._geometry(0)
    assert sphere_sweep.tree_prefix(t.static) is None
    with pytest.raises(ValueError, match="K1 walks no tree"):
        wavefront.make_trace_fn(t.static, t.scene,
                                tgeom._replace(sph_tree=geom.sph_tree))
    wavefront.make_trace_fn(r.static, r.scene, geom)
    wavefront.make_trace_fn(t.static, t.scene, tgeom)
