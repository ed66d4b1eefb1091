"""Image scenes through the port against the JAX package.

- The port's wavefront, ``Renderer(cs, device="cpu")``, against the JAX
  ``Renderer`` (its XLA wavefront) on the earth, its rotating twin and the
  image mix of tools/image_scenes.py (a 128x64 texel-id image), at 32
  pixels wide, 4 spp x 2 batches, depth 6: rays equal, channel means
  within MEAN_TOL = 1e-5, RMSE below RMSE_TOL = 1e-4 (measured: means
  equal, RMSE at most 1.7e-11).  The port's fused path (its plain version
  on the CPU: ``fused`` for the static scenes, ``fused_per_batch`` for the
  rotating globe) against its wavefront: rays equal, means within 1e-5.
- The port's plain fused version against JAX's K4 in its item mode
  (``render_tile_mega(..., interpret=True)``: image albedo shaded as 1,
  each sample multiplied by its primary hit's texel afterwards, exact for
  the earth's one convex sphere) on the earth at 32x32, 1 spp, depth 4:
  rays equal, per-sample channel means within MEAN_TOL, no pixel's sum
  more than 1e-3 apart (the factorisation changes the order of the
  multiplies; measured: the sums equal).
- The scene docs' settings, each image form's fixture, the Renderer's
  paths, the paged sweep's UVs (the same bytes as the dense sweep's) and
  the CLI.
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
from raytrace_tpu_torch.tools import image_scenes

torch.set_num_threads(1)

W = 32
MEAN_TOL = 1e-5
RMSE_TOL = 1e-4
MAP = (128, 64)
DOCS = {"earth": image_scenes.earth_doc,
        "earth-motion-blur": image_scenes.earth_motion_blur_doc,
        "image-mix": image_scenes.image_mix_doc}


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    return image_scenes.texel_id_png(
        str(tmp_path_factory.mktemp("maps") / "map.png"), *MAP)


@functools.lru_cache(maxsize=None)
def _jcs(name, png, width=W, spp=4, batches=2, depth=6):
    cs = jax_compile_scene(JaxSceneFile.from_json_dict(DOCS[name](png)),
                           width=width)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=spp, sample_batches=batches,
        max_ray_depth=depth))


@pytest.mark.parametrize("name", sorted(DOCS))
def test_wavefront_matches_the_jax_renderer(png, name):
    jcs = _jcs(name, png)
    j = JaxRenderer(jcs)
    j_img = np.asarray(j.render_all())
    r = Renderer(arrays.from_jax_compiled(jcs), device="cpu")
    img = r.render_all()
    assert r.path == "wavefront" and r.static.flags.has_image
    assert np.isfinite(img).all() and (img >= 0).all()
    assert r.stats.rays_traced == j.stats.rays_traced
    mdiff = np.abs(img.mean((0, 1)) - j_img.mean((0, 1))).max()
    assert mdiff <= MEAN_TOL, mdiff
    assert float(np.sqrt(np.mean((img - j_img) ** 2))) <= RMSE_TOL
    f = Renderer(arrays.from_jax_compiled(jcs), device="cpu",
                 use_megakernel=True)
    f_img = f.render_all()
    assert f.path == ("fused_per_batch" if name == "earth-motion-blur"
                      else "fused")
    assert f.stats.rays_traced == r.stats.rays_traced
    np.testing.assert_allclose(f_img.mean((0, 1)), img.mean((0, 1)),
                               atol=MEAN_TOL)


def test_plain_fused_path_matches_jax_k4_item_mode(png):
    jcs = _jcs("earth", png, width=32, spp=1, batches=1, depth=4)
    w, h = jcs.render.width, jcs.render.height
    jscene, jstatic = jarrays.upload_scene(jcs)
    jstatic = dataclasses.replace(jstatic, use_pallas_sweep=True,
                                  pallas_interpret=True,
                                  sphere_world_mode=True)
    assert jmega.deferred_image_supported(jstatic)
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
        spheres.world_sphere_tables(cs, np.array([0.5], np.float32))[0]),
        batch_time=torch.tensor(np.float32(0.5)))
    cam = camera.build_camera_arrays(cs.cameras[cs.render.camera], w, h,
                                     "cpu")
    before = megakernel.IMAGE_LAUNCHES
    sums, traced = megakernel.render_tile_mega(static, scene, geom, cam, 0,
                                               1, use_dof=False)
    assert megakernel.IMAGE_LAUNCHES == before   # the plain version ran
    jsums = np.asarray(jsums)
    assert int(traced.sum()) == int(jrays)
    assert np.abs(sums.numpy().mean((0, 1)) - jsums.mean((0, 1))).max() <= (
        MEAN_TOL)
    assert np.abs(sums.numpy() - jsums).max() <= 1e-3
    assert sums.numpy().mean() > 0.05


def test_earth_settings(tmp_path):
    """The render settings the JAX package records for the reference's
    earth and earth-motion-blur (BENCH_SCENES.json, at 512 wide), the
    book's geometry, and the reference earthmap's size
    (raytrace_tpu's tests/test_compile.py:116-119)."""
    assert image_scenes.main(["image_scenes", str(tmp_path)]) == 0
    settings = {}
    for name in ("earth", "earth-motion-blur"):
        path = tmp_path / f"{name}.json"
        assert json.loads(path.read_text()) == DOCS[name]("earthmap.png")
        cs = cli.load_scene(str(path), image_scenes.EARTH_WIDTH)
        r = cs.render
        settings[name] = (r.width, r.height, r.samples_per_pixel,
                          r.sample_batches, r.max_ray_depth)
        assert cs.num_spheres == 1 and cs.num_triangles == 0
        assert cs.atlas.shape == (1, 2700, 5400, 3)
        assert tuple(cs.atlas_wh[0]) == image_scenes.EARTH_SIZE
        np.testing.assert_array_equal(
            cs.atlas[0], image_scenes.texel_ids(*image_scenes.EARTH_SIZE))
        assert cs.any_animated == (name == "earth-motion-blur")
    assert settings == {"earth": (512, 512, 4, 16, 50),
                        "earth-motion-blur": (512, 512, 8, 32, 50)}
    sf = SceneFile.from_json_dict(image_scenes.earth_motion_blur_doc("m.png"))
    assert SceneFile.from_json_dict(sf.to_json_dict()) == sf


def test_form_checks_cover_every_image_form(png):
    """tools/image_scenes.form_checks names one doc for each image form of
    the fused kernel (every form but the animated one, with and without
    noise), and each renders with images on that form's path."""
    seen = {}
    for form, (doc, w, depth) in image_scenes.form_checks(png).items():
        cs = compile_scene(SceneFile.from_json_dict(doc), width=8)
        r = Renderer(cs, device="cpu", use_megakernel=True)
        assert r.static.flags.has_image and depth == 8
        seen[form] = (r.path, r.static.has_tris, r.static.has_lights,
                      r.static.flags.has_noise)
    forms = {"static": (False, False), "tris": (True, False),
             "lights": (False, True), "tris+lights": (True, True)}
    assert seen == {f + n: ("fused", *shape, bool(n))
                    for f, shape in forms.items() for n in ("", "+noise")}


def test_moving_image_scene_renders_per_batch(png):
    """The world-to-object rows change with the batch time, so a moving
    image scene takes one fused launch per batch, never the animated
    form (the JAX Renderer's rule), and each batch's rows are its own."""
    cs = compile_scene(SceneFile.from_json_dict(
        image_scenes.earth_motion_blur_doc(png)), width=8)
    r = Renderer(cs, device="cpu", use_megakernel=True)
    assert r.path == "fused_per_batch" and r._anim_geom is None
    a, b = r._geometry(0).prim_rows, r._geometry(5).prim_rows
    assert not torch.equal(a[0, 32:44], b[0, 32:44])
    assert torch.equal(a[0, 44:48], b[0, 44:48])


def test_paged_soup_reads_the_same_uvs(png):
    """The paged sweep (K3's plain version on the CPU) takes its UVs from
    the same attribute table as the dense one: the image mix renders the
    same bytes on both."""
    cs = compile_scene(SceneFile.from_json_dict(
        image_scenes.image_mix_doc(png)), width=24)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, sample_batches=1, max_ray_depth=4))
    paged = Renderer(cs, device="cpu", use_bvh="paged")
    dense = Renderer(cs, device="cpu", use_bvh=False)
    assert paged.static.bvh_mode == "paged" and paged.path == "wavefront"
    assert paged.render_all().tobytes() == dense.render_all().tobytes()
    assert paged.stats.rays_traced == dense.stats.rays_traced


def test_cli_renders_the_earth(tmp_path):
    assert image_scenes.main(["image_scenes", str(tmp_path)]) == 0
    out = tmp_path / "earth.png"
    assert cli.main(["render", "--path", str(tmp_path / "earth.json"),
                     "--width", "8", "--device", "cpu", "-o", str(out)]) == 0
    head = out.read_bytes()[:24]
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    assert (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big")) == (8, 8)
