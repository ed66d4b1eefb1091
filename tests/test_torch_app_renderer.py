"""The port's app layer against the JAX package, on the CPU: the scene
generator, per-batch metrics and the profiler trace, and the Renderer's
``camera_name``, runtime ``max_depth``, ``debug`` validation and
``render_all(progress)`` (the sharded renderer's ``camera_name`` and
``metrics_jsonl`` too).

Tolerances: a whole image against the JAX Renderer's, as
tests/test_torch_render.py holds whole images: channel means within 1e-2
and rays within 2%; at depth 1 (primary hits only), pixels within 1e-6.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu.tools import chacha as jax_chacha
from raytrace_tpu.tools.generate import (
    generate_final_one_weekend_pair as jax_generate_pair)
from raytrace_tpu.utils.profiling import BatchMetrics as JaxBatchMetrics
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.engine.arrays import from_jax_compiled
from raytrace_tpu_torch.engine.renderer import DebugValidationError
from raytrace_tpu_torch.parallel import MultiChipRenderer
from raytrace_tpu_torch.tools import chacha, generate_final_one_weekend_pair
from raytrace_tpu_torch.utils import profiling

torch.set_num_threads(1)

W, H = 24, 12
BATCHES = 3
DEPTH = 2
MEAN_ATOL = 1e-2
RAYS_RTOL = 0.02


def app_doc():
    """Three spheres (diffuse on a checker, metal, glass) on a ground
    sphere, two cameras ("default" and "cam"), 4 spp x 3 batches, depth
    50: inside the fused kernel's gate."""
    def cam(name, eye):
        return {"perspective": {
            "name": name, "eye": eye, "look_at": [0.0, 0.0, 0.0],
            "up": [0.0, 1.0, 0.0], "fov_y": 30.0, "z_near": 0.01,
            "z_far": 100.0, "focal_length": 10.0, "aperture_size": 0.0}}

    def sphere(name, center, radius, material):
        return {"uv_sphere": {"name": name, "center": center,
                              "radius": radius, "rings": 8, "segments": 16,
                              "material": material}}

    return {
        "cameras": [cam("default", [0.0, -1.0, 8.0]),
                    cam("cam", [6.0, -2.0, 4.0])],
        "textures": [
            {"constant": {"name": "green", "rgb": [0.2, 0.3, 0.1]}},
            {"constant": {"name": "white", "rgb": [0.9, 0.9, 0.9]}},
            {"checker": {"name": "ground", "scale": 0.32, "even": "green",
                         "odd": "white"}},
            {"constant": {"name": "red", "rgb": [0.7, 0.2, 0.1]}},
            {"constant": {"name": "fuzz", "rgb": [0.1, 0.1, 0.1]}}],
        "materials": [
            {"lambertian": {"name": "ground", "albedo": "ground"}},
            {"lambertian": {"name": "red", "albedo": "red"}},
            {"metal": {"name": "metal", "albedo": "white", "fuzz": "fuzz"}},
            {"dielectric": {"name": "glass", "refraction_index": 1.5}}],
        "primitives": [sphere("g", [0.0, 1000.0, 0.0], 999.0, "ground"),
                       sphere("a", [-2.0, 0.0, 0.0], 1.0, "red"),
                       sphere("b", [0.0, 0.0, 0.0], 1.0, "metal"),
                       sphere("c", [2.0, 0.0, 0.0], 1.0, "glass")],
        "instances": [{"name": n} for n in "gabc"],
        "sky": {"vertical_gradient": {"factor": 0.5, "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": BATCHES, "max_ray_depth": 50,
                   "aspect_ratio": 2.0},
    }


def _jcs(depth=None):
    cs = jax_compile_scene(JaxSceneFile.from_json_dict(app_doc()),
                           width=W, height=H)
    if depth is None:
        return cs
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=depth))


@pytest.fixture(scope="module")
def jax_depth2():
    """The JAX Renderer with debug on, its runtime max_depth set to 2
    (its XLA wavefront), every batch rendered."""
    r = JaxRenderer(_jcs(), use_pallas_sweep=False, debug=True)
    r.max_depth = DEPTH
    r.render_all()
    return r


# -- the generator ----------------------------------------------------------


@pytest.fixture(scope="module")
def generated():
    return generate_final_one_weekend_pair(), jax_generate_pair()


@pytest.mark.parametrize("which", [0, 1], ids=["static", "motion-blur"])
def test_generator_matches_jax_byte_for_byte(generated, which, tmp_path):
    ours, theirs = (pair[which] for pair in generated)
    ours.save_json(str(tmp_path / "port.json"))
    theirs.save_json(str(tmp_path / "jax.json"))
    port = (tmp_path / "port.json").read_bytes()
    assert port == (tmp_path / "jax.json").read_bytes()
    doc = json.loads(port)
    assert len(doc["primitives"]) == 488


def test_chacha20_zero_vector():
    """The known ChaCha20 keystream for a zero key, nonce and counter,
    and the seeded stream the generator draws, equal to JAX's copy."""
    import struct

    w = chacha._chacha20_block((0,) * 8, 0, 0)
    ks = b"".join(struct.pack("<I", x) for x in w)
    assert ks[:16].hex() == "76b8e0ada0f13d90405d6ae55386bd28"
    assert list(w) == list(jax_chacha._chacha20_block((0,) * 8, 0, 0))
    a = chacha.ChaCha20Rng.seed_from_u64(485_674_845_675_491)
    b = jax_chacha.ChaCha20Rng.seed_from_u64(485_674_845_675_491)
    assert [a.f32() for _ in range(64)] == [b.f32() for _ in range(64)]


# -- metrics and the trace --------------------------------------------------


def test_batch_metrics_lines_match_jax(tmp_path):
    records = [(0, 2.0, 4_000_000.0), (1, 0.5, 1_250_001.0), (2, 0.0, 7.0)]
    ours = profiling.BatchMetrics(pixels=100, spp=4,
                                  jsonl_path=str(tmp_path / "port.jsonl"))
    theirs = JaxBatchMetrics(pixels=100, spp=4,
                             jsonl_path=str(tmp_path / "jax.jsonl"))
    for rec in records:
        assert ours.record(*rec) == profiling.BatchRecord(
            *rec, pixels=100, spp=4)
        theirs.record(*rec)
    assert ((tmp_path / "port.jsonl").read_text()
            == (tmp_path / "jax.jsonl").read_text())
    assert ours.total_rays == theirs.total_rays == 5_250_008.0
    assert ours.mrays_per_sec == theirs.mrays_per_sec
    assert ours.records[0].spp_per_sec == 2.0
    assert ours.records[2].mrays_per_sec == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    events = json.load(open(prof.trace_path))["traceEvents"]
    assert prof.trace_path.startswith(str(tmp_path / "trace"))
    assert any("cumsum" in e.get("name", "") for e in events)


# -- the Renderer's options -------------------------------------------------


def test_camera_name():
    cs = from_jax_compiled(_jcs(1))
    with pytest.raises(KeyError, match="Camera nope not found"):
        Renderer(cs, device="cpu", camera_name="nope")
    r = Renderer(cs, device="cpu", camera_name="cam")
    img = r.render_all()
    j = JaxRenderer(_jcs(1), camera_name="cam", use_pallas_sweep=False)
    jimg = j.render_all()
    assert r.stats.rays_traced == int(j.stats.rays_traced)
    close = np.abs(img - jimg).max(axis=-1) <= 1e-6
    assert close.mean() >= 0.995
    default = Renderer(cs, device="cpu").render_all()
    assert np.abs(img - default).max() > 0.1


@pytest.mark.parametrize("fused", [False, True], ids=["wavefront", "fused"])
def test_runtime_max_depth_matches_jax(jax_depth2, fused):
    r = Renderer(from_jax_compiled(_jcs()), device="cpu",
                 use_megakernel=fused)
    assert r.path == ("fused" if fused else "wavefront")
    assert r.max_depth == 50
    r.max_depth = DEPTH
    img = r.render_all()
    jimg = jax_depth2.image()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)),
                               jimg.mean(axis=(0, 1)), atol=MEAN_ATOL)
    rays = jax_depth2.stats.rays_traced
    assert abs(r.stats.rays_traced - rays) <= RAYS_RTOL * rays
    # Every path stopped at two bounces.
    assert r.stats.rays_traced <= DEPTH * H * W * 4 * BATCHES
    # The same function as a scene whose own depth is 2.
    own = Renderer(from_jax_compiled(_jcs(DEPTH)), device="cpu",
                   use_megakernel=fused)
    np.testing.assert_array_equal(own.render_all(), img)


def test_debug_counters_match_jax(jax_depth2):
    r = Renderer(from_jax_compiled(_jcs()), device="cpu", debug=True)
    r.max_depth = DEPTH
    r.render_all()
    ours, theirs = r.debug_stats, jax_depth2.debug_stats
    assert ours.energy_bound == theirs.energy_bound == 1.0 * (50 + 2)
    assert (ours.checks, ours.nonfinite_values, ours.negative_values) == (
        theirs.checks, theirs.nonfinite_values, theirs.negative_values) == (
        BATCHES, 0, 0)
    assert 0.0 < ours.max_radiance <= ours.energy_bound
    np.testing.assert_allclose(ours.max_radiance, theirs.max_radiance,
                               atol=MEAN_ATOL)


def test_debug_catches_a_poisoned_accumulation():
    r = Renderer(from_jax_compiled(_jcs(DEPTH)), device="cpu", debug=True)
    assert r.render_next_batch()
    r.accum[0, 0, 0] = float("nan")
    with pytest.raises(DebugValidationError,
                       match="batch 1: 1 non-finite / 0 negative"):
        r.render_next_batch()
    assert r.current_batch == 1
    r.accum[0, 0, 0] = -10.0
    with pytest.raises(DebugValidationError, match="0 non-finite / 1 neg"):
        r.render_next_batch()
    r.accum[0, 0, 0] = 1e6
    with pytest.raises(DebugValidationError, match="exceeds energy bound"):
        r.render_next_batch()
    assert r.debug_stats.checks == 4


@pytest.mark.parametrize("fused", [False, True], ids=["wavefront", "fused"])
def test_metrics_and_progress(tmp_path, fused):
    """One record a batch, which add up to ``stats``; on the fused path a
    chunk of 3 batches is one step, whose rays are split over its
    batches; progress once a chunk."""
    path = tmp_path / "m.jsonl"
    r = Renderer(from_jax_compiled(_jcs(DEPTH)), device="cpu",
                 use_megakernel=fused, metrics_jsonl=str(path))
    calls = []
    r.render_all(progress=lambda b, total: calls.append((b, total)))
    assert calls == [(BATCHES, BATCHES)]
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [x["batch"] for x in lines] == list(range(BATCHES))
    assert sum(x["rays"] for x in lines) == r.stats.rays_traced
    assert r.metrics.total_rays == r.stats.rays_traced
    assert r.metrics.total_seconds == pytest.approx(r.stats.render_seconds)
    if fused:
        assert len({x["seconds"] for x in lines}) == 1
        assert max(x["rays"] for x in lines) - min(
            x["rays"] for x in lines) <= 1


def test_update_image_size_keeps_every_option(tmp_path):
    path = tmp_path / "m.jsonl"
    r = Renderer(from_jax_compiled(_jcs(DEPTH)), device="cpu",
                 use_megakernel=True, camera_name="cam",
                 metrics_jsonl=str(path), debug=True)
    r2 = r.update_image_size(16, 8)
    assert r2._ctor_kwargs == r._ctor_kwargs
    assert (r2.static.width, r2.static.height) == (16, 8)
    assert r2.path == "fused" and r2.debug_stats is not None
    assert r2.metrics.jsonl_path == str(path)
    cam = Renderer(r2.compiled, device="cpu", camera_name="cam").camera
    assert torch.equal(r2.camera.view_inverse, cam.view_inverse)
    assert r2.render_next_batch() and r2.debug_stats.checks == 1
    assert len(path.read_text().splitlines()) == 1


def test_sharded_renderer_takes_camera_name_and_metrics(tmp_path,
                                                        monkeypatch):
    """A world of one rank: the lead writes the metrics' lines; a rank
    that is not the lead keeps its records and writes none."""
    cs = from_jax_compiled(_jcs(DEPTH))
    path = tmp_path / "m.jsonl"
    r = MultiChipRenderer(cs, device="cpu", camera_name="cam",
                          metrics_jsonl=str(path))
    img = r.render_all()
    np.testing.assert_array_equal(
        img, Renderer(cs, device="cpu", camera_name="cam").render_all())
    assert len(path.read_text().splitlines()) == BATCHES
    assert r.update_image_size(16, 8)._ctor_kwargs["camera_name"] == "cam"
    with pytest.raises(KeyError, match="Camera nope not found"):
        MultiChipRenderer(cs, device="cpu", camera_name="nope")
    monkeypatch.setattr(MultiChipRenderer, "is_lead",
                        property(lambda self: False))
    other = tmp_path / "other.jsonl"
    r = MultiChipRenderer(cs, device="cpu", metrics_jsonl=str(other))
    r.render_all()
    assert len(r.metrics.records) == BATCHES and not other.exists()
