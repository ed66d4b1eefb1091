"""Scenes with lights through the port against the JAX package: the two
light scenes of tools/light_scenes.py (cornell-style: 36 triangles, 2 of
them a quad light, boxes under rotations; sphere-light-962: analytic
spheres with the book's Perlin texture, a tessellated light sphere and a
light quad, 962 lights).

- The port's wavefront, ``Renderer(cs, device="cpu",
  use_megakernel=False)``, against the JAX ``Renderer`` (its XLA
  wavefront) at 32 pixels wide, 4 spp x 2 batches, depth 8.
- The port's plain fused version (``render_tile_mega`` on CPU tensors)
  against JAX's K4 ``render_tile_mega(..., interpret=True)`` on the same
  compiled scene and batch time, 2 batches in one call; on
  sphere-light-962 JAX runs its ``light_gather`` branch (L > 16).
- The Renderer's paths with lights, the gate without the JAX package's
  64-instance cap, and the CLI.

Tolerances: traced rays within 1%, per-sample channel means within 1e-3
and image RMSE below 0.05 (XLA's CPU build contracts multiply-adds into
FMAs where torch does not, so single paths may part, and a light sample
of emit 15 makes one path worth several units).  Measured: rays equal
but for the JAX wavefront on cornell-style (25,070 against the port's
25,019 and JAX K4's 25,019, which agree) and one ray of 7,643 on
sphere-light-962; channel means within 1.5e-8 on cornell-style, and on
sphere-light-962 (with its Perlin texture) within 5.6e-6 of the JAX
wavefront and 6.6e-6 of JAX K4; RMSE at most 5.3e-4.  The port's two paths agree with each other within
1e-5 in means, with equal rays.  JAX's K4 in interpret mode takes about a
minute on sphere-light-962 with its noise, at any frame size: the time
is XLA's compile of the interpret kernel, not the render.
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
from raytrace_tpu.ops import camera as jcamera
from raytrace_tpu.ops import megakernel as jmega
from raytrace_tpu.ops import spheres as jspheres
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer, arrays, wavefront
from raytrace_tpu_torch.models import compile_scene
from raytrace_tpu_torch.ops import camera, megakernel, spheres
from raytrace_tpu_torch.scene_file import SceneFile
from raytrace_tpu_torch.tools import light_scenes

torch.set_num_threads(1)

W = 32
SPP, BATCHES, DEPTH = 4, 2, 8
MEAN_TOL = 1e-3
RMSE_TOL = 0.05
RAY_TOL = 0.01
SCENES = sorted(light_scenes.DOCS)


@functools.lru_cache(maxsize=None)
def _jcs(name):
    cs = jax_compile_scene(
        JaxSceneFile.from_json_dict(light_scenes.DOCS[name]()), width=W)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=SPP, sample_batches=BATCHES,
        max_ray_depth=DEPTH))


def _close(label, img, rays, ref_img, ref_rays):
    assert np.isfinite(img).all() and (img >= 0).all()
    mdiff = np.abs(img.mean((0, 1)) - ref_img.mean((0, 1))).max()
    rmse = float(np.sqrt(np.mean((img - ref_img) ** 2)))
    assert mdiff <= MEAN_TOL, f"{label}: channel means differ by {mdiff}"
    assert rmse <= RMSE_TOL, f"{label}: RMSE {rmse}"
    assert abs(rays - ref_rays) <= RAY_TOL * ref_rays, (
        f"{label}: rays {rays} vs {ref_rays}")


@pytest.mark.parametrize("name", SCENES)
def test_wavefront_matches_the_jax_renderer(name):
    jcs = _jcs(name)
    j = JaxRenderer(jcs)
    assert not j.static.use_megakernel
    j.render_all()
    r = Renderer(arrays.from_jax_compiled(jcs), device="cpu",
                 use_megakernel=False)
    img = r.render_all()
    assert r.path == "wavefront" and r.static.has_lights
    _close(f"{name}: port wavefront vs JAX wavefront", img,
           r.stats.rays_traced, np.asarray(j.image()), j.stats.rays_traced)
    f = Renderer(arrays.from_jax_compiled(jcs), device="cpu",
                 use_megakernel=True)
    f_img = f.render_all()
    assert f.path == "fused"
    assert f.stats.rays_traced == r.stats.rays_traced
    np.testing.assert_allclose(f_img.mean((0, 1)), img.mean((0, 1)),
                               atol=1e-5)


def _geometry(static, scene, cs, t: float):
    """The port's geometry of one batch at shutter time t."""
    tab = torch.tensor(spheres.world_sphere_tables(
        cs, np.array([t], np.float32))[0])
    tt = torch.tensor(np.float32(t))
    tris = (wavefront.prepare_tris(static, scene, tt) if static.has_tris
            else None)
    return wavefront.prepare_batch(static, scene, tab, tris=tris,
                                   batch_time=tt)


@pytest.mark.parametrize("name", SCENES)
def test_plain_fused_path_matches_jax_k4(name):
    jcs = _jcs(name)
    H = jcs.render.height
    jscene, jstatic = jarrays.upload_scene(jcs)
    jstatic = dataclasses.replace(jstatic, use_pallas_sweep=True,
                                  pallas_interpret=True,
                                  sphere_world_mode=True)
    assert jmega.megakernel_supported(jstatic)
    cfg = jmega.make_config(jstatic, jscene, False, 0)
    assert cfg.has_lights and cfg.light_gather == (name == "sphere-light-962")
    jcam = jcamera.build_camera_arrays(jcs.cameras[jcs.render.camera], W, H)
    tab = jspheres.world_sphere_tables(jcs, np.array([0.5], np.float32))[0]
    jgeom = jwavefront.prepare_batch(jstatic, jscene, jnp.float32(0.5),
                                     sph_table=tab)
    jsums, jrays, _, _ = jmega.render_tile_mega(
        jstatic, jscene, jgeom, jcam, jnp.int32(0), jnp.int32(0), H, False,
        interpret=True, reduce_mean=False, n_batches=BATCHES)

    cs = arrays.from_jax_compiled(jcs)
    scene, static = arrays.upload_scene(cs, "cpu")
    static = dataclasses.replace(static, sphere_world_mode=True)
    assert megakernel.megakernel_supported(static)
    geom = _geometry(static, scene, cs, 0.5)
    cam = camera.build_camera_arrays(cs.cameras[cs.render.camera], W, H,
                                     "cpu")
    before = megakernel.LIGHT_LAUNCHES
    sums, traced = megakernel.render_tile_mega(static, scene, geom, cam, 0,
                                               BATCHES, use_dof=False)
    assert megakernel.LIGHT_LAUNCHES == before
    K = SPP * BATCHES
    _close(f"{name}: port plain fused vs JAX K4", sums.numpy() / K,
           int(traced.sum()), np.asarray(jsums) / K, float(jrays))


def _moving(doc):
    """The short box slides over the shutter: the lights stay still."""
    box = next(i for i in doc["instances"] if i["name"] == "short_box")
    box["transform"] = {"animated": [
        {"rotate": {"axis": [0, 1, 0], "degrees": -18},
         "translate": [130, 0, 65]},
        {"rotate": {"axis": [0, 1, 0], "degrees": -18},
         "translate": [160, 0, 65]}]}
    return doc


def test_lit_scene_with_motion_renders_per_batch(monkeypatch):
    cs = compile_scene(SceneFile.from_json_dict(
        _moving(light_scenes.cornell_doc())), width=16)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=1, sample_batches=3, max_ray_depth=4))
    calls = []
    inner = megakernel.render_tile_mega

    def counted(*args, **kw):
        calls.append(args[2].inst_o2w_rows.clone())
        return inner(*args, **kw)

    monkeypatch.setattr(megakernel, "render_tile_mega", counted)
    r = Renderer(cs, device="cpu", use_megakernel=True)
    assert r.path == "fused_per_batch"
    img = r.render_all()
    assert len(calls) == 3 and np.isfinite(img).all()
    # Each batch's launch carries its own instance transforms.
    assert not torch.equal(calls[0], calls[2])
    w = Renderer(cs, device="cpu", use_megakernel=False)
    np.testing.assert_allclose(w.render_all().mean((0, 1)), img.mean((0, 1)),
                               atol=1e-5)
    assert w.stats.rays_traced == r.stats.rays_traced


def test_gate_has_no_instance_cap():
    doc = light_scenes.many_instances_doc(70)
    jcs = jax_compile_scene(JaxSceneFile.from_json_dict(doc), width=8)
    _, jstatic = jarrays.upload_scene(jcs)
    assert jstatic.num_instances == 70 and jstatic.has_lights
    assert not jmega.megakernel_supported(jstatic)
    cs = arrays.from_jax_compiled(jcs)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=1, sample_batches=1, max_ray_depth=3))
    r = Renderer(cs, device="cpu", use_megakernel=True)
    assert r.path == "fused" and r.static.num_instances == 70
    img = r.render_all()
    w = Renderer(cs, device="cpu", use_megakernel=False)
    np.testing.assert_allclose(w.render_all().mean((0, 1)), img.mean((0, 1)),
                               atol=1e-5)


def test_cli_writes_and_renders_the_light_scenes(tmp_path):
    assert light_scenes.main(["light_scenes", str(tmp_path)]) == 0
    for name in SCENES:
        path = tmp_path / f"{name}.json"
        assert json.loads(path.read_text()) == light_scenes.DOCS[name]()
    # Every batch of cornell-style (64 spp x 32) at 4x4 on the CPU.
    png = tmp_path / "cornell.png"
    assert cli.main(["render", "--path", str(tmp_path / "cornell-style.json"),
                     "--width", "4", "--device", "cpu", "-o", str(png)]) == 0
    head = png.read_bytes()[:24]
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    assert (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big")) == (4, 4)


def test_light_scene_settings():
    """The render settings the JAX package records for the reference's
    cornell-box and simple-light (BENCH_SCENES.json)."""
    for name, (w, h, spp, batches) in {
            "cornell-style": (1024, 1024, 64, 32),
            "sphere-light-962": (1024, 576, 64, 2)}.items():
        sf = SceneFile.from_json_dict(light_scenes.DOCS[name]())
        cs = compile_scene(sf)
        assert (cs.render.width, cs.render.height,
                cs.render.samples_per_pixel, cs.render.sample_batches,
                cs.render.max_ray_depth) == (w, h, spp, batches, 50)
        assert SceneFile.from_json_dict(sf.to_json_dict()) == sf
