"""Noise textures through the port against the JAX package.

- The three places a noise slot is read (the albedo slot, a checker's
  side, the emission slot) through the port's ``scatter_and_emit_v3``
  against JAX's, on the same rows, hit points and RNG states: RNG states
  and integer outputs exact, floats within ATOL = 1e-5 (each side's sin
  rounds on its own; measured: at most 6e-8).
- The port's wavefront, ``Renderer(cs, device="cpu")``, against the JAX
  ``Renderer`` (its XLA wavefront) on the two fixtures of
  tools/noise_scenes.py, perlin-spheres and the noise checker, at 32
  pixels wide, 4 spp x 1 batch, depth 6; the port's fused path (its plain
  version on the CPU) against its wavefront.
- The port's plain fused version against JAX's K4 ``render_tile_mega(...,
  interpret=True)`` on perlin-spheres at 16x9, 1 spp x 1 batch, depth 3
  (the interpret kernel's XLA compile takes about a minute, whatever the
  frame).
- The scene doc's settings, the CLI, and the reference's scale-0 quirk.

Tolerances for images: traced rays within 1%, per-sample channel means
within 1e-3, RMSE below 0.05.  XLA's CPU build contracts multiply-adds
where torch does not, and the turbulence turns a last-bit difference in a
hit point into ~1e-4 of albedo (raytrace_tpu's tests/test_megakernel.py
measured the same against its own interpret kernel), so pixels part
while the means hold.  Measured: rays equal in all three; channel means
within 1.6e-6 (perlin-spheres), 2.8e-4 (the noise checker, whose metal
sphere turns a ray's last bits into a different path) and 1.3e-5 (K4);
RMSE at most 4.8e-3.
"""

import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.engine import arrays as jarrays
from raytrace_tpu.engine import wavefront as jwavefront
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.models.shading_table import MODE_CHECKER, MODE_NOISE
from raytrace_tpu.ops import camera as jcamera
from raytrace_tpu.ops import megakernel as jmega
from raytrace_tpu.ops import shading as jshading
from raytrace_tpu.ops import spheres as jspheres
from raytrace_tpu.ops import textures as jtextures
from raytrace_tpu.ops import vec3 as jvec3
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer, arrays, wavefront
from raytrace_tpu_torch.models import compile_scene
from raytrace_tpu_torch.models.compile import (MAT_TYPE_DIFFUSE_LIGHT,
                                               MAT_TYPE_LAMBERTIAN)
from raytrace_tpu_torch.ops import camera, megakernel, spheres
from raytrace_tpu_torch.ops import shading as tshading
from raytrace_tpu_torch.ops.textures import TexFlags, checker_is_even
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.scene_file import SceneFile
from raytrace_tpu_torch.tools import noise_scenes

torch.set_num_threads(1)

ATOL = 1e-5
N = 2048
W = 32
MEAN_TOL = 1e-3
RMSE_TOL = 0.05
RAY_TOL = 0.01
DOCS = {"perlin-spheres": noise_scenes.perlin_spheres_doc,
        "noise-checker": noise_scenes.noise_checker_doc}


# ---- the noise slots --------------------------------------------------------

def _rows(case: str, g) -> np.ndarray:
    """[N, 32] fat rows of one kind: a lambertian whose albedo is noise, a
    lambertian whose albedo is a checker with a noise even side, or a
    light whose emission is noise; each noise of a random scale."""
    rows = np.zeros((N, 32), np.float32)
    scale = g.uniform(0.5, 8.0, N)
    if case == "emission":
        rows[:, 0] = MAT_TYPE_DIFFUSE_LIGHT
        rows[:, 15], rows[:, 16] = MODE_NOISE, scale
        return rows
    rows[:, 0] = MAT_TYPE_LAMBERTIAN
    if case == "albedo":
        rows[:, 11], rows[:, 12] = MODE_NOISE, scale
        return rows
    rows[:, 11], rows[:, 17] = MODE_CHECKER, 0.5
    rows[:, 24], rows[:, 25] = MODE_NOISE, scale
    rows[:, 21:24] = g.random((N, 3))
    return rows


@pytest.mark.parametrize("case", ["albedo", "checker", "emission"])
def test_noise_slots_match_jax(case):
    g = np.random.default_rng({"albedo": 0, "checker": 1, "emission": 2}[case])
    rows = _rows(case, g)
    p = g.uniform(-12, 12, (N, 3)).astype(np.float32)
    normal = g.standard_normal((N, 3))
    normal = (normal / np.linalg.norm(normal, axis=1,
                                      keepdims=True)).astype(np.float32)
    wrd = g.standard_normal((N, 3)).astype(np.float32)
    front = g.random(N) < 0.5
    state = g.integers(0, 2 ** 32, N, dtype=np.uint64)
    flags = (False, case == "checker", True, case == "emission")
    jscene, _ = jarrays.upload_scene(jax_compile_scene(
        JaxSceneFile.from_json_dict(noise_scenes.perlin_spheres_doc()),
        width=8))
    jv = lambda a: jvec3.V3(*(jnp.asarray(a[:, i]) for i in range(3)))  # noqa
    tv = lambda a: V3(*(torch.tensor(np.ascontiguousarray(a[:, i]))  # noqa
                        for i in range(3)))
    zeros = jnp.zeros(N, jnp.float32)
    js, jrec, jemit = jshading.scatter_and_emit_v3(
        jnp.asarray(state.astype(np.uint32)), jscene,
        jtextures.TexFlags(*flags), jnp.asarray(rows), jv(p), jv(normal),
        jnp.asarray(front), zeros, zeros, jv(wrd))
    ts, trec, temit = tshading.scatter_and_emit_v3(
        torch.tensor(state.astype(np.int64)), TexFlags(*flags),
        torch.tensor(rows), tv(p), tv(normal), torch.tensor(front), tv(wrd))
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                  ts.numpy().astype(np.int64))
    for j, t in ((jrec.attenuation, trec.attenuation), (jemit, temit)):
        for a, b in zip(j, t):
            np.testing.assert_allclose(b.numpy(), np.broadcast_to(
                np.asarray(a), b.shape), rtol=0, atol=ATOL)
    value = (temit if case == "emission" else trec.attenuation).x.numpy()
    read = front if case == "emission" else np.ones(N, bool)
    if case == "checker":
        read = checker_is_even(torch.tensor(rows[:, 17]), tv(p)).numpy()
    # The marble: one grey channel in [0, 1], not the slot's zero base.
    assert ((value[read] > 0.0) & (value[read] <= 1.0)).mean() > 0.99
    grey = (temit if case == "emission" else trec.attenuation)
    assert torch.equal(grey.x[read], grey.z[read])


def test_scale_zero_noise_shades_as_its_base_colour():
    """The reference's quirk, kept: a noise texture of scale 0 leaves
    has_noise False in both packages, so its slot is the row's zero base
    colour and the scene renders black where it is hit."""
    doc = noise_scenes.perlin_spheres_doc()
    doc["textures"][0]["noise"]["scale"] = 0
    jcs = jax_compile_scene(JaxSceneFile.from_json_dict(doc), width=8)
    assert not jtextures.TexFlags.for_scene(jcs).has_noise
    cs = compile_scene(SceneFile.from_json_dict(doc), width=8)
    assert not TexFlags.for_scene(cs).has_noise
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=1, max_ray_depth=3))
    r = Renderer(cs, device="cpu", use_megakernel=True)
    assert r.path == "fused"
    img = r.render_all()
    sky = np.float32([0.7, 0.8, 1.0])
    assert ((img == 0.0).all(-1) | (img == sky).all(-1)).all()
    assert (img == 0.0).all(-1).any()


# ---- images ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jcs(name, width=W, spp=4, depth=6):
    cs = jax_compile_scene(JaxSceneFile.from_json_dict(DOCS[name]()),
                           width=width)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=spp, sample_batches=1,
        max_ray_depth=depth))


def _close(label, img, rays, ref_img, ref_rays):
    assert np.isfinite(img).all() and (img >= 0).all()
    mdiff = np.abs(img.mean((0, 1)) - ref_img.mean((0, 1))).max()
    rmse = float(np.sqrt(np.mean((img - ref_img) ** 2)))
    assert mdiff <= MEAN_TOL, f"{label}: channel means differ by {mdiff}"
    assert rmse <= RMSE_TOL, f"{label}: RMSE {rmse}"
    assert abs(rays - ref_rays) <= RAY_TOL * ref_rays, (
        f"{label}: rays {rays} vs {ref_rays}")


@pytest.mark.parametrize("name", sorted(DOCS))
def test_wavefront_matches_the_jax_renderer(name):
    jcs = _jcs(name)
    j = JaxRenderer(jcs)
    j.render_all()
    r = Renderer(arrays.from_jax_compiled(jcs), device="cpu")
    img = r.render_all()
    assert r.path == "wavefront" and r.static.flags.has_noise
    assert r.static.has_tris == (name == "noise-checker")
    _close(f"{name}: port wavefront vs JAX wavefront", img,
           r.stats.rays_traced, np.asarray(j.image()), j.stats.rays_traced)
    f = Renderer(arrays.from_jax_compiled(jcs), device="cpu",
                 use_megakernel=True)
    f_img = f.render_all()
    assert f.path == "fused" and f.stats.rays_traced == r.stats.rays_traced
    np.testing.assert_allclose(f_img.mean((0, 1)), img.mean((0, 1)),
                               atol=1e-5)


def test_plain_fused_path_matches_jax_k4():
    jcs = _jcs("perlin-spheres", width=16, spp=1, depth=3)
    w, h = jcs.render.width, jcs.render.height
    jscene, jstatic = jarrays.upload_scene(jcs)
    jstatic = dataclasses.replace(jstatic, use_pallas_sweep=True,
                                  pallas_interpret=True,
                                  sphere_world_mode=True)
    assert jmega.megakernel_supported(jstatic) and jstatic.flags.has_noise
    jcam = jcamera.build_camera_arrays(jcs.cameras[jcs.render.camera], w, h)
    tab = jspheres.world_sphere_tables(jcs, np.array([0.5], np.float32))[0]
    jgeom = jwavefront.prepare_batch(jstatic, jscene, jnp.float32(0.5),
                                     sph_table=tab)
    jsums, jrays, _, _ = jmega.render_tile_mega(
        jstatic, jscene, jgeom, jcam, jnp.int32(0), jnp.int32(0), h, False,
        interpret=True, reduce_mean=False, n_batches=1)

    cs = arrays.from_jax_compiled(jcs)
    scene, static = arrays.upload_scene(cs, "cpu")
    static = dataclasses.replace(static, sphere_world_mode=True)
    assert megakernel.megakernel_supported(static)
    geom = wavefront.prepare_batch(static, scene, torch.tensor(
        spheres.world_sphere_tables(cs, np.array([0.5], np.float32))[0]))
    cam = camera.build_camera_arrays(cs.cameras[cs.render.camera], w, h,
                                     "cpu")
    before = megakernel.NOISE_LAUNCHES
    sums, traced = megakernel.render_tile_mega(static, scene, geom, cam, 0,
                                               1, use_dof=False)
    assert megakernel.NOISE_LAUNCHES == before   # the plain version ran
    _close("perlin-spheres: port plain fused vs JAX K4", sums.numpy(),
           int(traced.sum()), np.asarray(jsums), float(jrays))


# ---- the scene doc and the CLI ---------------------------------------------

def test_perlin_spheres_settings():
    """The render settings the JAX package records for the reference's
    perlin-spheres (BENCH_SCENES.json), and the book's geometry."""
    sf = SceneFile.from_json_dict(noise_scenes.perlin_spheres_doc())
    cs = compile_scene(sf)
    assert (cs.render.width, cs.render.height, cs.render.samples_per_pixel,
            cs.render.sample_batches, cs.render.max_ray_depth) == (
                1024, 576, 16, 1, 50)
    assert cs.num_spheres == 2 and cs.num_triangles == 0
    assert list(cs.noise_scale) == [4.0]
    assert SceneFile.from_json_dict(sf.to_json_dict()) == sf
    assert TexFlags.for_scene(cs) == TexFlags(False, False, True, False)


def test_form_checks_cover_every_noise_form():
    """tools/noise_scenes.form_checks names one doc for each form of the
    fused kernel, and each renders with noise on that form's path."""
    with open(cli.DEFAULT_SCENE.replace(
            "final-one-weekend.json",
            "final-one-weekend-motion-blur.json")) as f:
        checks = noise_scenes.form_checks(json.load(f))
    seen = {}
    for form, (doc, w, depth) in checks.items():
        cs = compile_scene(SceneFile.from_json_dict(doc), width=8)
        r = Renderer(cs, device="cpu", use_megakernel=True)
        assert r.static.flags.has_noise and depth in (8, 50)
        seen[form] = (r.path, r.static.has_tris, r.static.has_lights)
    assert seen == {"static": ("fused", False, False),
                    "anim": ("fused_anim", False, False),
                    "tris": ("fused", True, False),
                    "lights": ("fused", False, True),
                    "tris+lights": ("fused", True, True)}


def test_cli_writes_and_renders_perlin_spheres(tmp_path):
    assert noise_scenes.main(["noise_scenes", str(tmp_path)]) == 0
    path = tmp_path / "perlin-spheres.json"
    assert json.loads(path.read_text()) == noise_scenes.perlin_spheres_doc()
    png = tmp_path / "perlin.png"
    assert cli.main(["render", "--path", str(path), "--width", "8",
                     "--device", "cpu", "-o", str(png)]) == 0
    head = png.read_bytes()[:24]
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    assert (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big")) == (8, 4)
