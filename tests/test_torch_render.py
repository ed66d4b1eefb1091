"""The port's whole slice against the live JAX Renderer: final-one-weekend
at 96x54, 4 spp, 1 batch (the golden config, rendered live because the
stored golden is stale), with the JAX XLA wavefront (use_pallas_sweep=False).

- depth 1: equal ray counts, >= 99.5% of pixels within 1e-6 (measured: all);
- depth 8: channel means within 1e-2 and ray counts within 2% (measured:
  means within 1e-4, rays 52131 vs 52120, RMSE 0.0045, asserted < 0.02);
- checkpoints: a JAX checkpoint resumes here, and resume is byte-identical
  to a one-shot render;
- scenes outside the slice raise NotImplementedError naming their item.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.models import compile_scene
from raytrace_tpu.scene_file import SceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer

torch.set_num_threads(1)

W, H = 96, 54


@functools.lru_cache(maxsize=1)
def _base():
    return cli.load_scene(cli.DEFAULT_SCENE, W, H)


def _cs(depth, batches=1):
    cs = _base()
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=4, sample_batches=batches,
        max_ray_depth=depth))


@pytest.fixture(scope="module")
def jax_depth1():
    r = JaxRenderer(_cs(1, batches=2), use_pallas_sweep=False)
    r.render_next_batch()
    return r


def test_depth1_matches_jax(jax_depth1):
    port = Renderer(_cs(1), device="cpu")
    img = port.render_all()
    assert port.stats.rays_traced == int(jax_depth1.stats.rays_traced)
    close = np.abs(img - jax_depth1.image()).max(axis=-1) <= 1e-6
    assert close.mean() >= 0.995


def test_depth8_matches_jax():
    j = JaxRenderer(_cs(8), use_pallas_sweep=False)
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


_TRIANGLE = {"triangle": {"name": "t", "points": [[0, 0, 0], [1, 0, 0],
                                                  [0, 1, 0]],
                          "normal": [0, 0, 1], "uv": [[0, 0], [1, 0], [0, 1]],
                          "material": "m"}}


@pytest.mark.parametrize("doc,item", [
    (_tiny_doc(extra_prims=[_TRIANGLE]), "Triangles"),
    (_tiny_doc(material="l"), "NEE with lights"),
    (_tiny_doc(albedo="n"), "Noise textures"),
    (_tiny_doc(transform={"animated": [{"translate": [0, 0, 0]},
                                       {"translate": [0, 1, 0]}]}),
     "Motion blur"),
    (_tiny_doc(transform={"static": {"scale": [1, 2, 1]}}),
     "Object-space spheres"),
])
def test_scenes_outside_the_slice_raise(doc, item):
    cs = compile_scene(SceneFile.from_json_dict(doc), width=16, height=8)
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
