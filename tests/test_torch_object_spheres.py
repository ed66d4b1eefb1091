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
  refused.
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
    return ellipsoid_scenes.ellipsoid_fixture_doc(
        moving=name == "fixture-moving", triangles=name == "fixture-triangles")


@functools.lru_cache(maxsize=None)
def _jcs(name):
    w, h = (16, 9) if name == "fow-ellipsoids" else (W, H)
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
