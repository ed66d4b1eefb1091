"""The port's whole slice against the live JAX Renderer: final-one-weekend
at 96x54, 4 spp, 1 batch (the golden config, rendered live because the
stored golden is stale), with the JAX XLA wavefront (use_pallas_sweep=False).

- depth 1: equal ray counts, >= 99.5% of pixels within 1e-6 (measured: all);
- depth 8: channel means within 1e-2 and ray counts within 2% (measured:
  means within 1e-4, rays 52131 vs 52120, RMSE 0.0045, asserted < 0.02);
- checkpoints: a JAX checkpoint resumes here, and resume is byte-identical
  to a one-shot render;
- scenes outside the slice raise NotImplementedError naming their item
  (triangles are inside it at any count: a big mesh takes the paged
  sweep; lights and noise textures are inside it too).
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.engine.arrays import from_jax_compiled
from raytrace_tpu_torch.models import compile_scene
from raytrace_tpu_torch.scene_file import SceneFile

torch.set_num_threads(1)

W, H = 96, 54


@functools.lru_cache(maxsize=1)
def _base():
    """The JAX package's compiled scene; the port renders its carry-over."""
    return jax_compile_scene(JaxSceneFile.load_json(cli.DEFAULT_SCENE),
                             width=W, height=H)


def _jcs(depth, batches=1):
    cs = _base()
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=4, sample_batches=batches,
        max_ray_depth=depth))


def _cs(depth, batches=1):
    return from_jax_compiled(_jcs(depth, batches))


@pytest.fixture(scope="module")
def jax_depth1():
    r = JaxRenderer(_jcs(1, batches=2), use_pallas_sweep=False)
    r.render_next_batch()
    return r


def test_depth1_matches_jax(jax_depth1):
    port = Renderer(_cs(1), device="cpu")
    img = port.render_all()
    assert port.stats.rays_traced == int(jax_depth1.stats.rays_traced)
    close = np.abs(img - jax_depth1.image()).max(axis=-1) <= 1e-6
    assert close.mean() >= 0.995


def test_depth8_matches_jax():
    j = JaxRenderer(_jcs(8), use_pallas_sweep=False)
    jimg = j.render_all()
    port = Renderer(_cs(8), device="cpu")
    img = port.render_all()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)),
                               atol=1e-2)
    assert abs(port.stats.rays_traced - j.stats.rays_traced) <= (
        0.02 * j.stats.rays_traced)
    assert float(np.sqrt(np.mean((img - jimg) ** 2))) < 0.02


def test_jax_checkpoint_resumes_in_port(jax_depth1, tmp_path):
    ck = str(tmp_path / "jax.npz")
    jax_depth1.save_checkpoint(ck)
    port = Renderer(_cs(1, batches=2), device="cpu")
    port.load_checkpoint(ck)
    assert port.current_batch == 1
    assert port.render_next_batch() and not port.render_next_batch()
    jax_depth1.render_next_batch()
    close = np.abs(port.image() - jax_depth1.image()).max(axis=-1) <= 1e-6
    assert close.mean() >= 0.995


def test_checkpoint_resume_is_byte_identical(tmp_path):
    cs = _cs(2, batches=2)
    one_shot = Renderer(cs, device="cpu").render_all()
    first = Renderer(cs, device="cpu")
    first.render_batches(1)
    first.save_checkpoint(str(tmp_path / "ck"))
    resumed = Renderer(cs, device="cpu")
    resumed.load_checkpoint(str(tmp_path / "ck"))
    assert resumed.render_batches(5) == 1
    assert resumed.image().tobytes() == one_shot.tobytes()


def test_update_image_size():
    r = Renderer(_cs(1), device="cpu").update_image_size(32, 16)
    assert r.image().shape == (16, 32, 3) and r.device.type == "cpu"


def _tiny_doc(material="m", transform=None, extra_prims=(), albedo="white"):
    cam = json.load(open(cli.DEFAULT_SCENE))["cameras"]
    inst = {"name": "s"}
    if transform is not None:
        inst["transform"] = transform
    return {
        "cameras": cam,
        "textures": [{"constant": {"name": "white", "rgb": [0.8, 0.8, 0.8]}}]
        + ([{"noise": {"name": "n", "scale": 4.0}}] if albedo == "n" else []),
        "materials": [{"lambertian": {"name": "m", "albedo": albedo}},
                      {"diffuse_light": {"name": "l", "emit": "white"}}],
        "primitives": [{"uv_sphere": {
            "name": "s", "center": [0, 0, 0], "radius": 1.0, "rings": 8,
            "segments": 16, "material": material}}, *extra_prims],
        "instances": [inst] + [{"name": p["triangle"]["name"]}
                               for p in extra_prims],
        "sky": {"vertical_gradient": {"factor": 0.5, "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 1,
                   "sample_batches": 1, "max_ray_depth": 2,
                   "aspect_ratio": 2.0},
    }


def _big_mesh_doc(n_boxes=1366):
    """16,392 triangles (12 a box): above every triangle ceiling, so the
    Renderer pages the soup."""
    doc = _tiny_doc()
    doc["primitives"] = [{"box": {"name": "b", "corners": [[0, 0, 0],
                                                           [0.1, 0.1, 0.1]],
                                  "material": "m"}}]
    doc["instances"] = [{"name": "b", "transform": {"static": {
        "translate": [0.2 * (i % 40), 0, 0.2 * (i // 40)]}}}
        for i in range(n_boxes)]
    return doc


def _registry_doc():
    """The tiny doc with its sphere a metal whose fuzz is a checker."""
    doc = _tiny_doc(material="metal")
    doc["textures"] += [
        {"constant": {"name": "f0", "rgb": [0.0, 0.0, 0.0]}},
        {"checker": {"name": "fuzz", "scale": 0.5, "even": "f0",
                     "odd": "white"}}]
    doc["materials"].append({"metal": {"name": "metal", "albedo": "white",
                                       "fuzz": "fuzz"}})
    return doc


@pytest.mark.parametrize("doc,item", [
    # Triangles are inside the slice at any count: a mesh above the dense
    # ceiling renders on the paged sweep.
    pytest.param(_big_mesh_doc(), None, id="doc0-Triangles"),
    # NEE with lights is inside the slice now: a lit scene renders.
    pytest.param(_tiny_doc(material="l"), None, id="doc1-NEE with lights"),
    # Noise textures are inside the slice now: the marble renders.
    pytest.param(_tiny_doc(albedo="n"), None, id="doc2-Noise textures"),
    # Motion blur is inside the slice, and object-space spheres are now:
    # a moving ellipsoid and a static one render.
    pytest.param(_tiny_doc(transform={"animated": [
        {"translate": [0, 0, 0]}, {"translate": [0, 1, 0],
                                   "scale": [1, 2, 1]}]}),
        None, id="doc3-Motion blur"),
    pytest.param(_tiny_doc(transform={"static": {"scale": [1, 2, 1]}}),
                 None, id="doc4-Object-space spheres"),
    # Registry shading is inside the slice now: a metal whose fuzz is a
    # checker, which the fat row cannot encode, renders.
    pytest.param(_registry_doc(), None, id="doc5-Registry shading"),
])
def test_scenes_outside_the_slice_raise(doc, item):
    """Each scene outside the slice raises, naming its ROADMAP item; a
    case whose item has been ported (item None) renders instead."""
    cs = compile_scene(SceneFile.from_json_dict(doc), width=16, height=8)
    if item is None:
        r = Renderer(cs, device="cpu")
        img = r.render_all()
        assert r.path == "wavefront"
        # Each case shows the one feature it ports.
        assert sum((r.static.has_lights, r.static.bvh_mode == "paged",
                    r.static.flags.has_noise,
                    not r.static.sphere_world_mode,
                    not r.static.use_fat_shading)) == 1
        assert img.shape == (8, 16, 3) and np.isfinite(img).all()
        assert img.max() > 0.0
        return
    with pytest.raises(NotImplementedError, match=item):
        Renderer(cs, device="cpu")


def test_tiny_scene_inside_the_slice_renders():
    cs = compile_scene(SceneFile.from_json_dict(_tiny_doc()), width=16,
                       height=8)
    img = Renderer(cs, device="cpu").render_all()
    assert img.shape == (8, 16, 3) and np.isfinite(img).all()


def test_cli_renders_and_resumes_on_cpu(tmp_path):
    scene = tmp_path / "tiny.json"
    scene.write_text(json.dumps(_tiny_doc()))
    png, ck = tmp_path / "out.png", tmp_path / "ck.npz"
    args = ["render", "--path", str(scene), "--width", "16", "--height", "8",
            "-o", str(png), "--checkpoint", str(ck), "--device", "cpu"]
    assert cli.main(args) == 0
    assert png.stat().st_size > 0 and ck.exists()
    head = png.read_bytes()[:24]
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    assert (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big")) == (16, 8)
    os.remove(png)
    assert cli.main(args + ["--resume"]) == 0 and png.exists()


def test_cli_errors_exit_2(tmp_path):
    assert cli.main(["render", "--path", str(tmp_path / "missing.json"),
                     "--device", "cpu"]) == 2
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    assert cli.main(["render", "--path", cli.DEFAULT_SCENE]) == 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(_cs(1))
