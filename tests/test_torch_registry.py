"""Registry shading: the port's ops/textures.py ``eval_basic`` /
``eval_property``, ops/materials.py ``calculate_scatter`` /
``calculate_emission`` and the wavefront's registry branch against the
JAX package's, on the same numpy-seeded inputs.

Tolerances:

- texture evaluation against JAX's functions run op by op (no jit, so
  nothing is contracted): constant, image and checker within 1e-6
  absolute; noise within 1e-5 absolute, the Perlin tolerance of
  tests/test_torch_perlin.py (JIT_ATOL) (measured: constant, image and
  checker exact, noise within 6e-8);
- scatter and emission: RNG words bit for bit, attenuation, emission and
  directions within 1e-5 absolute (measured: attenuation within 6e-8 and
  directions within 1.2e-7, on 27 and 47 of 4096 rays);
- the port's registry path renders its own fat path's bytes on scenes
  that fit both (shade_rows forced to None, as tests/test_shading_table.py
  does): final-one-weekend, a light scene and a noise scene (measured:
  the same bytes);
- whole renders against the JAX Renderer (its XLA wavefront) on the same
  compiled scene: channel means within 5e-3 and RMSE below 0.05, ray
  counts within 2%, as tests/test_torch_object_spheres.py holds the
  wavefront.
"""

import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import materials as jmaterials
from raytrace_tpu.ops import textures as jtextures
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.engine import wavefront
from raytrace_tpu_torch.engine.arrays import from_jax_compiled
from raytrace_tpu_torch.ops import materials, megakernel, sphere_sweep
from raytrace_tpu_torch.ops import textures
from raytrace_tpu_torch.tools import light_scenes, noise_scenes
from raytrace_tpu_torch.tools import registry_scenes

torch.set_num_threads(1)

R = 4096
BASIC_ATOL = 1e-6
NOISE_ATOL = 1e-5
SCATTER_ATOL = 1e-5
MEAN_TOL, RMSE_TOL, RAY_TOL = 5e-3, 0.05, 0.02

RGB, IMAGE, CHECKER, NOISE = 0, 1, 2, 3
FAMILIES = (RGB, IMAGE, NOISE)


def _tables(seed=0):
    """Texture and material tables as numpy: 4 constants, 2 images, 2
    noise scales, a checker for every (even, odd) pair of basic families,
    and material rows referring to every family."""
    g = np.random.default_rng(seed)
    checkers = [(e, o) for e in FAMILIES for o in FAMILIES]
    side = {RGB: 3, IMAGE: 1, NOISE: 1}
    t = dict(
        const_colours=g.uniform(0, 1, (4, 3)).astype(np.float32),
        atlas=g.integers(0, 256, (2, 8, 16, 3)).astype(np.uint8),
        atlas_wh=np.array([[16, 8], [12, 5]], np.int32),
        srgb_lut=textures.srgb_u8_to_linear_lut(),
        noise_scale=np.array([4.0, 0.5], np.float32),
        checker_scale=g.uniform(0.2, 1.0, len(checkers)).astype(np.float32),
        checker_even=np.array([(e, i % (side[e] + 1))
                               for i, (e, _) in enumerate(checkers)],
                              np.int32),
        checker_odd=np.array([(o, (i + 1) % (side[o] + 1))
                              for i, (_, o) in enumerate(checkers)],
                             np.int32),
        diel_ri=np.array([1.5, 1.0 / 1.3], np.float32),
    )
    props = np.array([(f, i) for f in (RGB, IMAGE, NOISE, CHECKER)
                      for i in range(3)], np.int32)
    for name in ("lamb_albedo", "metal_albedo", "metal_fuzz", "light_emit"):
        t[name] = props[g.permutation(len(props))]
    counts = dict(n_const=4, n_image=2, n_noise=2, n_checker=len(checkers),
                  n_lamb=len(props), n_metal=len(props), n_diel=2,
                  n_light_mat=len(props))
    return t, counts


def _scenes(seed=0):
    t, counts = _tables(seed)
    js = types.SimpleNamespace(
        **{k: jnp.asarray(v) for k, v in t.items()},
        **{k: jnp.int32(v) for k, v in counts.items()})
    ts = types.SimpleNamespace(
        **{k: torch.tensor(v) for k, v in t.items()},
        **{k: torch.tensor(v, dtype=torch.int32) for k, v in counts.items()})
    return js, ts


def _flags(noise=True):
    return (jtextures.TexFlags(True, True, noise, True),
            textures.TexFlags(True, True, noise, True))


def _hits(seed):
    g = np.random.default_rng(seed)
    p = g.uniform(-4, 4, (R, 3)).astype(np.float32)
    u = g.uniform(-2, 2, R).astype(np.float32)
    v = g.uniform(-2, 2, R).astype(np.float32)
    return p, u, v


def _refs(seed, n_max=4):
    """Property references: every family, in and out of its table."""
    g = np.random.default_rng(seed)
    ptype = g.integers(0, 4, R).astype(np.int32)
    pindex = g.integers(0, n_max + 8, R).astype(np.int32)
    return ptype, pindex


def _both(fn_j, fn_t, *arrays):
    j = np.asarray(fn_j(*map(jnp.asarray, arrays)))
    t = fn_t(*map(torch.tensor, arrays)).numpy()
    return j, t


@pytest.mark.parametrize("fn", ["eval_basic", "eval_property"])
@pytest.mark.parametrize("noise", [False, True])
def test_texture_evaluation_matches_jax(fn, noise):
    js, ts = _scenes()
    jf, tf = _flags(noise)
    p, u, v = _hits(1)
    ptype, pindex = _refs(2, n_max=9)
    j, t = _both(
        lambda *a: getattr(jtextures, fn)(js, jf, *a),
        lambda *a: getattr(textures, fn)(ts, tf, *a),
        ptype, pindex, p, u, v)
    assert t.shape == (R, 3) and t.dtype == np.float32
    is_noise = ptype == NOISE
    if fn == "eval_property":
        ck = np.clip(pindex, 0, len(ts.checker_scale) - 1)
        sides = np.concatenate([ts.checker_even.numpy()[ck][:, :1],
                                ts.checker_odd.numpy()[ck][:, :1]], 1)
        is_noise |= (ptype == CHECKER) & (sides == NOISE).any(1)
    np.testing.assert_allclose(t[~is_noise], j[~is_noise], rtol=0,
                               atol=BASIC_ATOL)
    np.testing.assert_allclose(t[is_noise], j[is_noise], rtol=0,
                               atol=NOISE_ATOL)
    # Every family shades some rays, so none is compared as zeros only.
    for fam in FAMILIES + ((CHECKER,) if fn == "eval_property" else ()):
        if fam == NOISE and not noise:
            continue
        assert np.abs(t[ptype == fam]).max() > 0.0


def _scatter_inputs(seed):
    g = np.random.default_rng(seed)
    p, u, v = _hits(seed)
    n = g.normal(size=(R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = g.normal(size=(R, 3)).astype(np.float32) * 2.0
    front = g.random(R) < 0.5
    mat_type = g.integers(0, 5, R).astype(np.int32)
    mat_index = g.integers(0, 14, R).astype(np.int32)
    state = g.integers(0, 2 ** 32, R, dtype=np.uint64)
    return state, mat_type, mat_index, p, n, front, u, v, d


def test_scatter_and_emission_match_jax():
    js, ts = _scenes()
    jf, tf = _flags(True)
    state, mt, mi, p, n, front, u, v, d = _scatter_inputs(3)
    jstate, jrec = jmaterials.calculate_scatter(
        jnp.asarray(state.astype(np.uint32)), js, jf, jnp.asarray(mt),
        jnp.asarray(mi), jnp.asarray(p), jnp.asarray(n), jnp.asarray(front),
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(d))
    T = torch.tensor
    tstate, trec = materials.calculate_scatter(
        T(state.astype(np.int64)), ts, tf, T(mt), T(mi), T(p), T(n),
        T(front), T(u), T(v), T(d))
    np.testing.assert_array_equal(tstate.numpy(),
                                  np.asarray(jstate).astype(np.int64))
    for field in ("is_scattered", "mat_pdf_type", "skip_pdf"):
        np.testing.assert_array_equal(getattr(trec, field).numpy(),
                                      np.asarray(getattr(jrec, field)))
    for field in ("attenuation", "skip_dir"):
        np.testing.assert_allclose(getattr(trec, field).numpy(),
                                   np.asarray(getattr(jrec, field)), rtol=0,
                                   atol=SCATTER_ATOL)
    for fam in (1, 2, 3):  # each material family scatters some rays
        assert trec.is_scattered.numpy()[mt == fam].any()
    jem = jmaterials.calculate_emission(
        js, jf, jnp.asarray(mt), jnp.asarray(mi), jnp.asarray(p),
        jnp.asarray(front), jnp.asarray(u), jnp.asarray(v))
    tem = materials.calculate_emission(ts, tf, T(mt), T(mi), T(p), T(front),
                                       T(u), T(v))
    np.testing.assert_allclose(tem.numpy(), np.asarray(jem), rtol=0,
                               atol=SCATTER_ATOL)
    assert tem.numpy()[(mt == 4) & front].any()
    assert not tem.numpy()[~front].any()


def _fat_and_registry(cs):
    fat = Renderer(cs, device="cpu")
    reg_cs = dataclasses.replace(cs, shade_rows=None)
    reg = Renderer(reg_cs, device="cpu")
    assert not reg.static.use_fat_shading and reg.path == "wavefront"
    return fat.render_all(), reg.render_all(), fat, reg


def _cut(doc, width, height, spp=4, depth=8):
    doc["render"].update(samples_per_pixel=spp, sample_batches=1,
                         max_ray_depth=depth)
    return jax_compile_scene(JaxSceneFile.from_json_dict(doc), width=width,
                             height=height)


@pytest.mark.parametrize("name", ["final-one-weekend", "cornell-style",
                                  "perlin-spheres"])
def test_registry_path_renders_the_fat_path_bytes(name):
    doc = {"final-one-weekend": registry_scenes.fow_registry_doc,
           "cornell-style": light_scenes.cornell_doc,
           "perlin-spheres": noise_scenes.perlin_spheres_doc}[name]()
    if name == "final-one-weekend":   # back to the shipped fuzz
        import json

        from raytrace_tpu_torch.cli import DEFAULT_SCENE
        doc = json.load(open(DEFAULT_SCENE))
    cs = from_jax_compiled(_cut(doc, 32, 18, depth=6))
    assert cs.shade_rows is not None
    a, b, fat, reg = _fat_and_registry(cs)
    assert fat.stats.rays_traced == reg.stats.rays_traced
    assert a.tobytes() == b.tobytes()


@functools.lru_cache(maxsize=None)
def _jcs(name):
    if name == "fow-registry":
        return _cut(registry_scenes.fow_registry_doc(), 48, 27, depth=50)
    return _cut(registry_scenes.small_doc(name), 32, 18, depth=16)


@pytest.mark.parametrize("name", ["fow-registry", *registry_scenes.SMALL_DOCS])
def test_registry_scenes_match_the_jax_render(name, monkeypatch):
    jcs = _jcs(name)
    assert jcs.shade_rows is None
    calls = {"k1": 0}
    sweep = sphere_sweep.intersect_spheres_sweep

    def counted(*a, **k):
        calls["k1"] += 1
        return sweep(*a, **k)

    monkeypatch.setattr(sphere_sweep, "intersect_spheres_sweep", counted)
    r = Renderer(from_jax_compiled(jcs), device="cpu", use_megakernel=True)
    assert r.path == "wavefront" and not r.use_megakernel
    assert not megakernel.megakernel_supported(r.static)
    img = r.render_all()
    assert calls["k1"] > 0
    j = JaxRenderer(jcs, use_pallas_sweep=False)
    j_img = np.asarray(j.render_all())
    assert np.isfinite(img).all() and (img >= 0).all() and img.max() > 0
    mdiff = np.abs(img.mean((0, 1)) - j_img.mean((0, 1))).max()
    rmse = float(np.sqrt(np.mean((img - j_img) ** 2)))
    assert mdiff <= MEAN_TOL, f"channel means differ by {mdiff}"
    assert rmse <= RMSE_TOL, f"RMSE {rmse}"
    rays = r.stats.rays_traced
    assert abs(rays - j.stats.rays_traced) <= RAY_TOL * j.stats.rays_traced


def test_registry_fuzz_checker_changes_the_image():
    """The fuzz checker is read: fow-registry differs from the scene with
    its shipped fuzz where metal spheres are seen."""
    import json

    from raytrace_tpu_torch.cli import DEFAULT_SCENE
    reg = from_jax_compiled(_cut(registry_scenes.fow_registry_doc(), 32, 18))
    base = from_jax_compiled(_cut(json.load(open(DEFAULT_SCENE)), 32, 18))
    a = Renderer(reg, device="cpu").render_all()
    b = Renderer(base, device="cpu").render_all()
    assert a.shape == b.shape and a.tobytes() != b.tobytes()


def test_registry_material_lookup():
    """The hit's (type, index, instance) come from the scene's tables by
    primitive, sphere or triangle as the hit says."""
    scene = types.SimpleNamespace(
        sph_center=torch.zeros(8, 3),
        sph_mat_type=torch.arange(8, dtype=torch.int32),
        sph_mat_index=torch.arange(8, dtype=torch.int32) + 10,
        sph_inst=torch.arange(8, dtype=torch.int32) + 20,
        tri_mat_type=torch.arange(8, dtype=torch.int32) + 100,
        tri_mat_index=torch.arange(8, dtype=torch.int32) + 110,
        tri_inst=torch.arange(8, dtype=torch.int32) + 120)
    static = types.SimpleNamespace(has_tris=True, has_spheres=True)
    prim = torch.tensor([3, 8, 12], dtype=torch.int32)
    is_sphere = torch.tensor([True, False, False])
    raw = wavefront.RawHit(missed=torch.zeros(3, dtype=torch.bool),
                           t=torch.ones(3), prim=prim, is_sphere=is_sphere,
                           bu=torch.zeros(3), bv=torch.zeros(3))
    mt, mi, inst = wavefront.registry_material(static, scene, raw)
    assert mt.tolist() == [3, 100, 104]
    assert mi.tolist() == [13, 110, 114]
    assert inst.tolist() == [23, 120, 124]
