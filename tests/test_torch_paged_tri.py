"""The paged triangle sweep of the port (ops/paged_tri.py: the host order
and tables, and the plain version of the kernel K3) against the JAX
package's (raytrace_tpu/ops/pallas_paged_tri.py, its kernel in interpret
mode) and against the port's dense sweep, on soups and rays made from a
numpy seed.

- ``world_soup_mid`` bit for bit and ``paged_tri_order`` integer for
  integer with JAX's, on a compiled scene and on random soups;
- the triangle rows and cluster boxes bit for bit with JAX's
  ``build_page_tables(xp=np)`` (triangle p g c + ci g + s is
  ``pageG[p, 9 s + f, ci]``, its cluster's box ``psieve[p, ci, :6]``); a
  page's box is the min and max of its clusters';
- the plain K3 against JAX's ``paged_tri_sweep(interpret=True)`` at g = 8,
  c = 16 over several pages with a padding tail and an active mask: ids
  equal and t, u, v within 1e-3 (rtol and atol) on >= 99.9% of rays (XLA's
  CPU build contracts multiply-adds into FMAs, PyTorch does not; the limit
  of tests/test_torch_tri_sweep.py);
- the plain K3 bit for bit with ``tri_sweep_reference`` over the same
  soup: t and id on every ray, u and v on the active ones;
- the box tests are conservative (a property test): every dense hit lies
  in a page and a cluster whose boxes pass against that hit's t;
- the wrapper on the CPU is the plain version and counts no launch.
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

from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import pallas_paged_tri as jpaged
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch.engine import arrays, wavefront
from raytrace_tpu_torch.engine.renderer import paged_soup
from raytrace_tpu_torch.ops import paged_tri, tri_sweep
from raytrace_tpu_torch.ops.intersect import T_MAX
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.tools import stress_scenes

torch.set_num_threads(1)

AGREEMENT = 0.999
RTOL = ATOL = 1e-3
R = 4096   # a multiple of the Pallas kernel's 1024-ray block


def _soup(T, seed, spread=0.3):
    """T random triangles in a 10-unit box, in the paged sweep's order."""
    g = np.random.default_rng(seed)
    tri = (g.uniform(-5, 5, (T, 1, 3))
           + g.uniform(-spread, spread, (T, 3, 3))).astype(np.float32)
    return tri[paged_tri.paged_tri_order(tri, T)]


def _rays(tri, n, seed):
    """n rays from around the soup towards points of random triangles, a
    tenth in random directions (as tests/test_torch_tri_sweep.py makes
    them), and an active mask."""
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
def _jcs():
    """The JAX package's compiled box grid (16,392 triangles, 1,366
    instances), at 16x9."""
    return jax_compile_scene(JaxSceneFile.from_json_dict(
        stress_scenes.box_grid_doc()), width=16, height=9)


def test_order_and_mid_soup_match_jax():
    jcs = _jcs()
    cs = arrays.from_jax_compiled(jcs)
    mid = paged_tri.world_soup_mid(cs)
    jmid = jpaged.world_soup_mid(jcs)
    assert mid.dtype == np.float64 and mid.shape == (jcs.num_triangles, 3, 3)
    np.testing.assert_array_equal(mid, jmid)
    order = paged_tri.paged_tri_order(mid, jcs.num_triangles)
    np.testing.assert_array_equal(order,
                                  jpaged.paged_tri_order(jmid,
                                                         jcs.num_triangles))
    assert sorted(order.tolist()) == list(range(jcs.num_triangles))
    for seed, T in ((0, 1000), (1, 77), (2, 5000)):
        tri = np.random.default_rng(seed).uniform(-5, 5, (T, 3, 3))
        np.testing.assert_array_equal(paged_tri.paged_tri_order(tri, T),
                                      jpaged.paged_tri_order(tri, T))
    assert paged_tri.num_pages(16392) == jpaged.num_pages(16392) == 2
    assert paged_tri.num_pages(1, 8, 16) == jpaged.num_pages(1, 8, 16) == 1


def test_paged_soup_is_the_jax_renderers_permutation():
    """The Renderer's soup: JAX's order over the real triangles, the
    padding rows kept at the end; every per-triangle array and the
    triangles' shading rows follow; a second pass is the identity."""
    jcs = _jcs()
    cs = arrays.from_jax_compiled(jcs)
    n = cs.num_triangles
    order = jpaged.paged_tri_order(jpaged.world_soup_mid(jcs), n)
    out = paged_soup(cs)
    s_pad = cs.sph_center.shape[0]
    for name in ("tri_p", "tri_n", "tri_uv", "tri_inst", "tri_mat_type",
                 "tri_mat_index"):
        np.testing.assert_array_equal(getattr(out, name)[:n],
                                      getattr(cs, name)[order])
        np.testing.assert_array_equal(getattr(out, name)[n:],
                                      getattr(cs, name)[n:])
    np.testing.assert_array_equal(out.shade_rows[s_pad:s_pad + n],
                                  cs.shade_rows[s_pad:][order])
    np.testing.assert_array_equal(out.shade_rows[:s_pad],
                                  cs.shade_rows[:s_pad])
    assert out.mesh_tri_offsets is None and out.tri_cluster_g == 0
    again = paged_soup(out)
    np.testing.assert_array_equal(again.tri_p, out.tri_p)


@pytest.mark.parametrize("T,g,c", [(421, 8, 16), (300, 8, 16),
                                   (20000, 128, 128)])
def test_tables_match_jax_build_page_tables(T, g, c):
    tri = _soup(T, seed=T)
    pageG, psieve = jpaged.build_page_tables(tri, T, g, c, xp=np)
    tables = paged_tri.build_page_tables(torch.tensor(tri), T, g=g, c=c)
    NP = paged_tri.num_pages(T, g, c)
    n_clusters = -(-T // g)
    assert tables.page_boxes.shape == (NP, 8)
    assert tables.boxes.shape == (n_clusters, 8)
    assert (tables.num_tris, tables.g, tables.c) == (T, g, c)
    # Triangle p g c + ci g + s: field f at pageG[p, 9 s + f, ci].
    ids = np.arange(T)
    p, rem = np.divmod(ids, g * c)
    ci, s = np.divmod(rem, g)
    rows = tables.tris.numpy()
    for f, col in enumerate((0, 1, 2, 4, 5, 6, 8, 9, 10)):
        np.testing.assert_array_equal(rows[:T, col], pageG[p, 9 * s + f, ci])
    assert (rows[:T, 3] == 1).all() and (rows[T:, 3] == 0).all()
    # Real clusters: psieve[p, ci, :6] is (min, max).
    cid = np.arange(n_clusters)
    jbox = psieve[cid // c, cid % c, :6]
    boxes = tables.boxes.numpy()
    np.testing.assert_array_equal(boxes[:, [0, 1, 2, 4, 5, 6]], jbox)
    # A page's box: the min and max over its clusters' (JAX's page gate,
    # pallas_paged_tri.py:226-228, over the padded psieve tile).
    np.testing.assert_array_equal(tables.page_boxes[:, 0:3].numpy(),
                                  psieve[:, :, 0:3].min(axis=1))
    np.testing.assert_array_equal(tables.page_boxes[:, 4:7].numpy(),
                                  psieve[:, :, 3:6].max(axis=1))


def _jax_paged(tri, T, o, d, active, g, c):
    tw = jpaged.build_page_valid(T, g, c)
    pageG, psieve = jpaged.build_page_tables(tri, T, g, c, xp=np)
    return jpaged.paged_tri_sweep(
        jnp.asarray(tw), jnp.asarray(psieve), jnp.asarray(pageG),
        jnp.asarray(o.T), jnp.asarray(d.T),
        jnp.asarray(active.astype(np.float32)[None]), interpret=True, g=g,
        c=c)


@functools.lru_cache(maxsize=None)
def _tri_stress_soup():
    """The JAX triangle stress scene at k = 1 (960 triangles of the port's
    uv-sphere OBJ): its world soup in the paged sweep's order, as the JAX
    Renderer builds a static scene's page tables."""
    obj = stress_scenes.write_sphere_obj(
        os.path.join(tempfile.mkdtemp(), "sphere-smooth.obj"))
    jcs = jax_compile_scene(JaxSceneFile.from_json_dict(
        stress_scenes.tri_stress_doc(1, obj)), width=16, height=9)
    mid = jpaged.world_soup_mid(jcs).astype(np.float32)
    return mid[jpaged.paged_tri_order(mid, jcs.num_triangles)]


@pytest.mark.parametrize("name", ["tri-stress-k1", "random-77"])
def test_plain_sweep_matches_the_pallas_kernel(name):
    """tri-stress k = 1's soup, eight pages of g = 8, c = 16 with a partial
    last page; or 77 random triangles, one page mostly padding (JAX's own
    padding-tail case); with an active mask."""
    g, c = 8, 16
    if name == "random-77":
        T, tri = 77, _soup(77, seed=77, spread=1.0)
    else:
        tri = _tri_stress_soup()
        T = tri.shape[0]
    o, d, active = _rays(tri, R, seed=T + 1)
    jt, jids, ju, jv = (np.asarray(a) for a in _jax_paged(tri, T, o, d,
                                                         active, g, c))
    tables = paged_tri.build_page_tables(torch.tensor(tri), T, g=g, c=c)
    assert tables.page_boxes.shape[0] == -(-T // (g * c))
    t, ids, u, v = (a.numpy() for a in paged_tri.paged_tri_sweep_reference(
        _v3(o), _v3(d), tables, torch.tensor(active)))
    ok = ids == jids
    for a, b in ((t, jt), (u, ju), (v, jv)):
        ok &= np.isclose(a, b, rtol=RTOL, atol=ATOL)
    assert ok.mean() >= AGREEMENT, f"rays agree on {ok.mean()}"
    assert (ids[~active] == -1).all() and (t[~active] == T_MAX).all()
    assert ((ids >= 0) & active).mean() > 0.3
    assert (ids < T).all()


@pytest.mark.parametrize("T,g,c", [(1000, 8, 16), (77, 8, 16),
                                   (3000, 16, 4), (5000, 128, 128),
                                   (20000, 128, 128)])
def test_plain_sweep_is_the_dense_sweep_bit_for_bit(T, g, c):
    tri = _soup(T, seed=T + 7)
    tri[T // 2] = tri[1]    # a duplicate: the lower id wins the tie
    o, d, active = _rays(tri, R, seed=T + 8)
    o, d, active = _v3(o), _v3(d), torch.tensor(active)
    tables = paged_tri.build_page_tables(torch.tensor(tri), T, g=g, c=c)
    t, ids, u, v = paged_tri.paged_tri_sweep_reference(o, d, tables, active)
    dt, dids, du, dv = tri_sweep.tri_sweep_reference(
        o, d, tri_sweep.pack_tri_table(torch.tensor(tri), T))
    assert torch.equal(t, torch.where(active, dt, T_MAX))
    assert torch.equal(ids, torch.where(active, dids, -1))
    assert torch.equal(u[active], du[active])
    assert torch.equal(v[active], dv[active])
    assert (ids >= 0).double().mean() > 0.3
    if T // 2 != 1:
        assert (ids != T // 2).all()


def test_plain_sweep_on_a_scene_soup_is_the_dense_sweep():
    """The box grid's world soup in the Renderer's order, two pages of
    g = c = 128, through the wavefront's prepare_tris (the tree K3 walks,
    sharing the triangle rows; no page tables on the path); and the
    sweep over it at the frame's primary rays, through the tree and
    through the page tables."""
    cs = paged_soup(arrays.from_jax_compiled(_jcs()))
    scene, static = arrays.upload_scene(cs, "cpu")
    static = dataclasses.replace(static, bvh_mode="paged")
    tris = wavefront.prepare_tris(static, scene, torch.tensor(0.0))
    assert "tri_boxes" not in tris and "tri_pages" not in tris
    tree = tris["tri_tree"]
    assert tree.tris.data_ptr() == tris["tri_table12"].data_ptr()
    wp = tris["world_p"][:static.num_triangles]
    tables = paged_tri.build_page_tables(wp, static.num_triangles)
    assert tables.page_boxes.shape[0] == 2
    wp = wp.numpy()
    o, d, active = _rays(wp, R // 2, seed=11)
    o, d, active = _v3(o), _v3(d), torch.tensor(active)
    hit = paged_tri.intersect_tris_paged(o, d, tree, active)
    flat = paged_tri.intersect_tris_paged(o, d, tables, active)
    assert all(torch.equal(a, b) for a, b in zip(hit, flat))
    dense = tri_sweep.intersect_tris_sweep(o, d, tris["tri_table16"], active)
    assert torch.equal(hit.t, dense.t) and torch.equal(hit.tri, dense.tri)
    assert torch.equal(hit.u[active], dense.u[active])
    assert torch.equal(hit.v[active], dense.v[active])
    assert (hit.tri >= 0).double().mean() > 0.3


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(8, 600),
       gc=st.sampled_from([(8, 4), (8, 16), (16, 8), (32, 2)]),
       scale=st.sampled_from([0.0, 1.0, 1e3, 1e4]))
def test_box_tests_are_conservative(seed, n, gc, scale):
    """Every ray's dense closest hit lies in a page and a cluster whose
    boxes pass the slab test against that hit's own t (so pruning with any
    best t at or above it never drops the hit)."""
    g, c = gc
    tri = _soup(n, seed) + np.float32(scale) * np.array([1.0, -1.0, 1.0],
                                                        np.float32)
    tables = paged_tri.build_page_tables(torch.tensor(tri), n, g=g, c=c)
    o, d, _ = _rays(tri, 512, seed + 1)
    o, d = _v3(o), _v3(d)
    t, ids, _, _ = tri_sweep.tri_sweep_reference(
        o, d, tri_sweep.pack_tri_table(torch.tensor(tri), n))
    hit = ids >= 0
    assert hit.any()
    rays = torch.nonzero(hit)[:, 0]
    cluster = (ids[hit] // g).long()
    iv = tuple(paged_tri._inv(x[rays]) for x in d)
    ro = tuple(x[rays] for x in o)
    assert paged_tri._slab(ro, iv, tables.page_boxes[cluster // c],
                           t[hit]).all()
    assert paged_tri._slab(ro, iv, tables.boxes[cluster], t[hit]).all()


def test_visit_counts_count_the_traversal():
    """On one page of two clusters, every active ray tests the page box;
    the counts are bounded by the dense work and exact for a lone ray."""
    T, g, c = 12, 8, 16
    tri = _soup(T, seed=3)
    tables = paged_tri.build_page_tables(torch.tensor(tri), T, g=g, c=c)
    o, d, active = _rays(tri, 256, seed=4)
    o, d, active = _v3(o), _v3(d), torch.tensor(active)
    hit = paged_tri.intersect_tris_paged(o, d, tables, active)
    work = paged_tri.visit_counts(o, d, tables, hit.t, active)
    n = int(active.sum())
    assert work["rays"] == work["page_tests"] == n
    assert 0 < work["cluster_tests"] <= 2 * n
    assert 0 < work["tri_tests"] <= T * n
    one = torch.zeros(256, dtype=torch.bool)
    one[int(torch.nonzero(hit.tri >= 0)[0, 0])] = True
    w1 = paged_tri.visit_counts(o, d, tables, hit.t, one)
    assert w1["rays"] == 1 and w1["cluster_tests"] == 2
    assert w1["tri_tests"] in (4, 8, 12)


def test_wrapper_on_the_cpu_is_the_plain_version():
    T, g, c = 300, 8, 16
    tri = _soup(T, seed=5)
    tables = paged_tri.build_page_tables(torch.tensor(tri), T, g=g, c=c)
    o, d, active = _rays(tri, R, seed=6)
    o, d, active = _v3(o), _v3(d), torch.tensor(active)
    before = paged_tri.LAUNCHES
    hit = paged_tri.intersect_tris_paged(o, d, tables, active)
    assert paged_tri.LAUNCHES == before   # the CPU launches no kernel
    ref = paged_tri.paged_tri_sweep_reference(o, d, tables, active)
    for a, b in zip(hit, ref):
        assert torch.equal(a, b)
    missed = hit.tri < 0
    assert (hit.t[missed] == T_MAX).all()
    assert (hit.u[missed] == 0).all() and (hit.v[missed] == 0).all()


def test_wrapper_rejects_bad_inputs():
    T = 40
    tri = _soup(T, seed=7)
    tables = paged_tri.build_page_tables(torch.tensor(tri), T, g=8, c=2)
    o = _v3(np.zeros((16, 3), np.float32))
    active = torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError, match="active"):
        paged_tri.intersect_tris_paged(o, o, tables, active[:8])
    with pytest.raises(ValueError, match="float32"):
        paged_tri.intersect_tris_paged(o, V3(*(x.double() for x in o)),
                                       tables, active)
    with pytest.raises(ValueError, match="boxes"):
        paged_tri.intersect_tris_paged(
            o, o, tables._replace(boxes=tables.boxes[:-1]), active)
    with pytest.raises(ValueError, match="page_boxes"):
        paged_tri.intersect_tris_paged(
            o, o, tables._replace(page_boxes=tables.page_boxes[:1]), active)
    with pytest.raises(ValueError, match="fewer rows"):
        paged_tri.intersect_tris_paged(
            o, o, tables._replace(tris=tables.tris[:32]), active)
    with pytest.raises(ValueError, match="at least one"):
        paged_tri.build_page_tables(torch.tensor(tri), 0)
