"""The dense triangle sweep of the port (ops/tri_sweep.py, the plain
version of the kernel K2, and ops/intersect.py) against the JAX package's
(raytrace_tpu/ops/pallas_tri_sweep.py in interpret mode, and
raytrace_tpu/ops/intersect.py) on the same soups and rays, made from a numpy
seed.  The soups are the world soups of the JAX triangle stress scene at
k = 1 (960 triangles of the port's uv-sphere OBJ over a ground sphere) and
of the small triangle-only fixture doc.

- the packed position table and the attribute table, fed JAX's world soup:
  bit for bit with JAX's ``prepare_batch``; the port's own soup
  (``transform_soup``) within 1e-6 relative;
- ``tri_sweep_reference`` and ``intersect_brute_force`` against JAX's
  ``tri_sweep_pallas(interpret=True)`` and ``intersect_brute_force``: the
  same id and t, u and v within 1e-3 (rtol and atol) on >= 99.9% of rays
  (XLA's CPU build contracts multiply-adds into FMAs, and PyTorch's
  elementwise kernels do not);
- the wrapper's contract on the CPU: the plain version, masked; ties to
  the lowest id; (T_MAX, -1, 0, 0) on a miss; no launch counted;
- the fused kernel's cluster pretest is conservative (a property test):
  every dense hit lies in a cluster whose box passes against that hit's t.
"""

import dataclasses
import functools
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from raytrace_tpu.engine import arrays as jarrays
from raytrace_tpu.engine import wavefront as jwavefront
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import intersect as jintersect
from raytrace_tpu.ops import pallas_tri_sweep as jtri
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch.engine import arrays, wavefront
from raytrace_tpu_torch.ops import intersect, megakernel, transforms, tri_sweep
from raytrace_tpu_torch.ops.intersect import T_MAX
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.tools import stress_scenes

torch.set_num_threads(1)

AGREEMENT = 0.999
RTOL = ATOL = 1e-3
R = 4096   # a multiple of the Pallas kernel's 2048-ray block


@functools.lru_cache(maxsize=None)
def _jcs(name):
    """The JAX package's compiled scene of one fixture, at 32x18."""
    if name == "tri-stress-k1":
        obj = stress_scenes.write_sphere_obj(
            os.path.join(tempfile.mkdtemp(), "sphere-smooth.obj"))
        doc = stress_scenes.tri_stress_doc(1, obj)
    else:
        doc = stress_scenes.triangle_fixture_doc()
    return jax_compile_scene(JaxSceneFile.from_json_dict(doc), width=32,
                             height=18)


@functools.lru_cache(maxsize=None)
def _jax_geom(name):
    """JAX's packed tables for batch time 0 (its Pallas path packs them)."""
    jscene, jstatic = jarrays.upload_scene(_jcs(name))
    jstatic = dataclasses.replace(jstatic, use_pallas_sweep=True,
                                  pallas_interpret=True)
    return jscene, jwavefront.prepare_batch(jstatic, jscene,
                                            jnp.float32(0.0))


def _rays(world_p, num_real, seed):
    """R rays: from points around the soup towards random points of random
    real triangles (most hit), a tenth in random directions."""
    g = np.random.default_rng(seed)
    wp = np.asarray(world_p[:num_real], np.float64)
    lo, hi = wp.min((0, 1)), wp.max((0, 1))
    span = np.maximum(hi - lo, 1.0)
    o = g.uniform(lo - span, hi + span, (R, 3))
    j = g.integers(0, num_real, R)
    w = g.dirichlet(np.ones(3), R)
    target = np.einsum("rv,rvi->ri", w, wp[j])
    d = target - o
    d[: R // 10] = g.standard_normal((R // 10, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _v3(a):
    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i])) for i in range(3)))


@pytest.mark.parametrize("name", ["tri-stress-k1", "fixture"])
def test_packed_tables_match_jax_prepare_batch(name):
    jcs = _jcs(name)
    jscene, jgeom = _jax_geom(name)
    world_p = torch.tensor(np.asarray(jgeom.world_p))
    world_n = torch.tensor(np.asarray(jgeom.world_n))
    table16 = tri_sweep.pack_tri_table(world_p, jcs.num_triangles)
    np.testing.assert_array_equal(table16.numpy(),
                                  np.asarray(jgeom.tri_table16))
    att = wavefront.tri_attr_table(world_n, torch.tensor(jcs.tri_uv),
                                   table16.shape[0])
    np.testing.assert_array_equal(att.numpy(), np.asarray(jgeom.tri_attr16))
    assert (table16[jcs.num_triangles:, 9] == 0).all()
    assert (table16[:jcs.num_triangles, 9] == 1).all()

    # The port's own soup from the same scene, through its transforms.
    scene, static = arrays.upload_scene(arrays.from_jax_compiled(jcs), "cpu")
    tris = wavefront.prepare_tris(static, scene, torch.tensor(0.0))
    np.testing.assert_allclose(tris["world_p"].numpy(),
                               np.asarray(jgeom.world_p), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tris["world_n"].numpy(),
                               np.asarray(jgeom.world_n), rtol=1e-6,
                               atol=1e-6)
    # The fused kernel's fat rows carry the normal rows n0, dn1, dn2.
    geom = wavefront.prepare_batch(
        static, scene, torch.zeros((scene.sph_center.shape[0], 5)),
        tris=tris)
    s_pad = scene.sph_center.shape[0]
    n = jcs.num_triangles
    assert torch.equal(geom.prim_rows[s_pad:s_pad + n, 49:58],
                       tris["tri_attr16"][:n, 0:9])


def _agree(name, t, ids, u, v, jt, jids, ju, jv):
    """A ray agrees when its id is equal and its t, u and v are within
    RTOL/ATOL; at least AGREEMENT of the rays must.  (A ray nearly parallel
    to its triangle has a tiny det, which amplifies the FMA's one rounding
    in u and v past 1e-3.)"""
    jt, jids, ju, jv = (np.asarray(a) for a in (jt, jids, ju, jv))
    t, ids, u, v = (a.numpy() for a in (t, ids, u, v))
    ok = ids == jids
    for a, b in ((t, jt), (u, ju), (v, jv)):
        ok &= np.isclose(a, b, rtol=RTOL, atol=ATOL)
    assert ok.mean() >= AGREEMENT, f"{name}: rays agree on {ok.mean()}"
    return (ids >= 0).mean()


@pytest.mark.parametrize("name", ["tri-stress-k1", "fixture"])
def test_plain_sweep_matches_the_pallas_kernel(name):
    jcs = _jcs(name)
    _, jgeom = _jax_geom(name)
    o, d = _rays(np.asarray(jgeom.world_p), jcs.num_triangles, seed=3)
    jt, jids, ju, jv = jtri.tri_sweep_pallas(
        jgeom.tri_table16, jnp.asarray(o.T), jnp.asarray(d.T), interpret=True)
    table16 = torch.tensor(np.asarray(jgeom.tri_table16))
    t, ids, u, v = tri_sweep.tri_sweep_reference(_v3(o), _v3(d), table16)
    hit_share = _agree(name, t, ids, u, v, jt, jids, ju, jv)
    assert hit_share > 0.5
    miss = ids < 0
    assert (t[miss] == T_MAX).all() and (u[miss] == 0).all()


@pytest.mark.parametrize("name", ["tri-stress-k1", "fixture"])
def test_brute_force_matches_jax(name):
    jcs = _jcs(name)
    _, jgeom = _jax_geom(name)
    wp = np.asarray(jgeom.world_p)
    o, d = _rays(wp, jcs.num_triangles, seed=4)
    alive = np.random.default_rng(5).random(R) < 0.8
    chunk = min(512, wp.shape[0])
    jh = jintersect.intersect_brute_force(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(wp),
        active=jnp.asarray(alive), chunk=chunk)
    h = intersect.intersect_brute_force(
        torch.tensor(o), torch.tensor(d), torch.tensor(wp),
        active=torch.tensor(alive), chunk=chunk)
    _agree(name, h.t, h.tri, h.u, h.v, jh.t, jh.tri, jh.u, jh.v)
    assert (h.tri[~torch.tensor(alive)] == -1).all()
    # The plain kernel sweep agrees with the brute force on the alive rays.
    table16 = tri_sweep.pack_tri_table(torch.tensor(wp), jcs.num_triangles)
    hs = tri_sweep.intersect_tris_sweep(_v3(o), _v3(d), table16,
                                        torch.tensor(alive))
    assert (hs.tri == h.tri).double().mean().item() >= AGREEMENT


def test_wrapper_on_the_cpu_is_the_masked_plain_version():
    g = np.random.default_rng(9)
    tri = g.uniform(-1, 1, (37, 3, 3)).astype(np.float32)
    tri[20] = tri[5]   # a duplicate: ties go to the lower id
    table16 = tri_sweep.pack_tri_table(torch.tensor(tri), 37)
    assert table16.shape == (40, 16)
    o, d = _rays(tri, 37, seed=10)
    alive = torch.tensor(g.random(R) < 0.7)
    before = tri_sweep.LAUNCHES
    hit = tri_sweep.intersect_tris_sweep(_v3(o), _v3(d), table16, alive)
    assert tri_sweep.LAUNCHES == before   # the CPU launches no kernel
    t, ids, u, v = tri_sweep.tri_sweep_reference(_v3(o), _v3(d), table16)
    assert torch.equal(hit.t, torch.where(alive, t, T_MAX))
    assert torch.equal(hit.tri, torch.where(alive, ids, -1))
    assert torch.equal(hit.u, torch.where(alive, u, 0.0))
    assert (hit.tri != 20).all() and (hit.tri == 5).any()
    missed = hit.tri < 0
    assert (hit.t[missed] == T_MAX).all()
    assert (hit.u[missed] == 0).all() and (hit.v[missed] == 0).all()
    # Padding rows (valid = 0) never hit, even where they hold a triangle.
    table16[5, 9] = 0.0
    assert not (tri_sweep.intersect_tris_sweep(
        _v3(o), _v3(d), table16, alive).tri == 5).any()


def test_wrapper_rejects_bad_inputs():
    table16 = torch.zeros((8, 16))
    o = _v3(np.zeros((16, 3), np.float32))
    alive = torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError, match="table16"):
        tri_sweep.intersect_tris_sweep(o, o, torch.zeros((9, 16)), alive)
    with pytest.raises(ValueError, match="active"):
        tri_sweep.intersect_tris_sweep(o, o, table16, alive[:8])
    with pytest.raises(ValueError, match="float32"):
        tri_sweep.intersect_tris_sweep(o, V3(*(c.double() for c in o)),
                                       table16, alive)


def _soup(seed, n, offset):
    """n small random triangles in contiguous clusters (sorted along x)."""
    g = np.random.default_rng(seed)
    c = g.uniform(-4, 4, (n, 3))
    c = c[np.argsort(c[:, 0])]
    tri = c[:, None, :] + g.uniform(-0.3, 0.3, (n, 3, 3))
    return (tri + offset).astype(np.float32)


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(8, 300),
       group=st.sampled_from([8, 16, 32, 64]),
       scale=st.sampled_from([0.0, 1.0, 1e3, 1e4]))
def test_cluster_pretest_is_conservative(seed, n, group, scale):
    """Every ray's dense closest hit lies in a cluster whose box passes the
    fused kernel's pretest against that hit's own t (so pruning with any
    best t at or above it never drops the hit)."""
    offset = np.float32(scale) * np.array([1.0, -1.0, 1.0], np.float32)
    tri = _soup(seed, n, offset)
    table16 = tri_sweep.pack_tri_table(torch.tensor(tri), n)
    o, d = _rays(tri, n, seed + 1)
    o, d = _v3(o[:512]), _v3(d[:512])
    t, ids, _, _ = tri_sweep.tri_sweep_reference(o, d, table16)
    boxes = megakernel.cluster_boxes(table16, n, group)
    assert boxes.shape == (-(-n // group), 8)
    passes = megakernel.cluster_pretest(o, d, boxes, t)    # [C, R]
    hit = ids >= 0
    assert hit.any()
    cluster = (ids[hit] // group).long()
    assert passes[cluster, torch.nonzero(hit)[:, 0]].all()


def test_cluster_boxes_of_an_empty_cluster_never_pass():
    tri = _soup(1, 40, np.zeros(3, np.float32))
    table16 = tri_sweep.pack_tri_table(torch.tensor(tri), 40)
    table16[16:32, 9] = 0.0    # cluster 1 of 16 holds no valid triangle
    boxes = megakernel.cluster_boxes(table16, 40, 16)
    o, d = _rays(tri, 40, 2)
    passes = megakernel.cluster_pretest(_v3(o), _v3(d), boxes,
                                        torch.full((R,), T_MAX))
    assert not passes[1].any() and passes[0].any()


def test_transforms_leave_a_static_soup_unchanged_over_time():
    """A static instance (t1 == t0) gives the same world soup at every
    batch time, so a static scene builds its soup once."""
    jcs = _jcs("tri-stress-k1")
    scene, _ = arrays.upload_scene(arrays.from_jax_compiled(jcs), "cpu")
    soups = [transforms.transform_soup(
        scene.tri_p, scene.tri_n, scene.tri_inst,
        transforms.interpolate_instances(scene.inst_t0, scene.inst_t1,
                                         torch.tensor(t)))[0]
        for t in (0.0, 0.31, 1.0)]
    assert torch.equal(soups[0], soups[1]) and torch.equal(soups[0],
                                                           soups[2])
