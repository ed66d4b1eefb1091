"""The Renderer's fused path (use_megakernel) against the port's wavefront
and the JAX Renderer's fused chunks, its checkpoints, its resize, and the
CLI stepping in chunks.

Setup: final-one-weekend at 32x18, 4 spp, 3 batches, depth 4.  Renders of
the fused path agree with the wavefront and with the JAX fused chunk
(raytrace_tpu Renderer(use_pallas_sweep=True), interpret mode on the CPU)
in channel means within 1e-3 and ray counts within 0.5%.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.engine.arrays import from_jax_compiled
from raytrace_tpu_torch.ops import megakernel

torch.set_num_threads(1)

W, H = 32, 18


@functools.lru_cache(maxsize=None)
def _jcs(batches=3, depth=4):
    """The JAX package's compiled scene; the port takes its carry-over."""
    cs = jax_compile_scene(JaxSceneFile.load_json(cli.DEFAULT_SCENE),
                           width=W, height=H)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=4, sample_batches=batches,
        max_ray_depth=depth))


@functools.lru_cache(maxsize=None)
def _cs(batches=3, depth=4):
    return from_jax_compiled(_jcs(batches, depth))


def _agree(img, rays, ref_img, ref_rays):
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)),
                               ref_img.mean(axis=(0, 1)), atol=1e-3)
    assert abs(rays - ref_rays) <= 0.005 * ref_rays


@pytest.fixture
def calls(monkeypatch):
    """Counts calls of the fused wrapper (one per chunk)."""
    seen = []
    inner = megakernel.render_tile_mega

    def counted(*args, **kw):
        seen.append(args[5] if len(args) > 5 else kw.get("n_batches", 1))
        return inner(*args, **kw)

    monkeypatch.setattr(megakernel, "render_tile_mega", counted)
    return seen


@pytest.fixture(scope="module")
def fused():
    r = Renderer(_cs(), device="cpu", use_megakernel=True)
    return r, r.render_all()


def test_path_choice():
    assert not Renderer(_cs(), device="cpu").use_megakernel
    assert not Renderer(_cs(), device="cpu",
                        use_megakernel=False).use_megakernel
    r = Renderer(_cs(), device="cpu", use_megakernel=True)
    assert r.use_megakernel and r.chunk_size() == Renderer.CHUNK


def test_render_all_takes_one_chunk(calls):
    r = Renderer(_cs(), device="cpu", use_megakernel=True)
    r.render_all()
    assert calls == [3] and r.current_batch == 3
    assert r.stats.batches_done == 3


def test_fused_path_matches_the_wavefront(fused):
    r, img = fused
    w = Renderer(_cs(), device="cpu", use_megakernel=False)
    _agree(img, r.stats.rays_traced, w.render_all(), w.stats.rays_traced)


def test_fused_path_matches_the_jax_fused_chunk(fused):
    r, img = fused
    j = JaxRenderer(_jcs(), use_pallas_sweep=True)
    assert j._mega_step is not None
    assert j.render_batches(3) == 3
    _agree(img, r.stats.rays_traced, j.image(), j.stats.rays_traced)


def test_single_batches_match_the_chunk(fused, calls):
    """k == 1 steps batch by batch; the fold of single batches agrees
    with the fused chunk up to float rounding."""
    r, img = fused
    s = Renderer(_cs(), device="cpu", use_megakernel=True)
    while s.render_batches(1):
        pass
    assert calls == [1, 1, 1]
    assert s.stats.rays_traced == r.stats.rays_traced
    np.testing.assert_allclose(s.image(), img, rtol=1e-5, atol=1e-6)


def test_resume_at_a_chunk_boundary_is_byte_identical(tmp_path):
    cs = _cs(batches=4, depth=3)
    one_shot = Renderer(cs, device="cpu", use_megakernel=True)
    assert one_shot.render_batches(2) == 2 and one_shot.render_batches(5) == 2
    first = Renderer(cs, device="cpu", use_megakernel=True)
    first.render_batches(2)
    first.save_checkpoint(str(tmp_path / "ck"))
    resumed = Renderer(cs, device="cpu", use_megakernel=True)
    resumed.load_checkpoint(str(tmp_path / "ck"))
    assert resumed.render_batches(5) == 2
    assert resumed.image().tobytes() == one_shot.image().tobytes()


def test_jax_checkpoint_resumes_in_the_fused_path(tmp_path):
    j = JaxRenderer(_jcs(), use_pallas_sweep=True)
    j.render_next_batch()
    ck = str(tmp_path / "jax.npz")
    j.save_checkpoint(ck)
    port = Renderer(_cs(), device="cpu", use_megakernel=True)
    port.load_checkpoint(ck)
    assert port.current_batch == 1
    assert port.render_batches(5) == 2
    rays0 = j.stats.rays_traced
    j.render_batches(2)
    _agree(port.image(), port.stats.rays_traced, j.image(),
           j.stats.rays_traced - rays0)


@pytest.mark.parametrize("use_megakernel", [True, False])
def test_update_image_size_keeps_the_options(use_megakernel):
    r = Renderer(_cs(), device="cpu", use_megakernel=use_megakernel)
    s = r.update_image_size(16, 8)
    assert s.image().shape == (8, 16, 3) and s.device.type == "cpu"
    assert s.use_megakernel is use_megakernel
    assert s.update_image_size(W, H).use_megakernel is use_megakernel


@pytest.mark.parametrize("fused", [True, False])
def test_cli_renders_and_resumes_in_chunks(tmp_path, monkeypatch, fused):
    """The CLI steps in chunk_size() chunks and checkpoints at each chunk
    boundary, on either path (the Renderer picks it; forced here)."""
    cs = _cs(batches=3, depth=3)
    monkeypatch.setattr(cli, "load_scene", lambda *a, **k: cs)
    made = []

    def renderer(*args, **kw):
        made.append(Renderer(*args, **kw, use_megakernel=fused))
        return made[-1]

    monkeypatch.setattr("raytrace_tpu_torch.engine.Renderer", renderer)
    saved, save = [], Renderer.save_checkpoint

    def counted_save(self, path):
        saved.append(self.current_batch)
        save(self, path)

    monkeypatch.setattr(Renderer, "save_checkpoint", counted_save)
    png, ck = tmp_path / "out.png", tmp_path / "ck.npz"
    args = ["render", "-o", str(png), "--checkpoint", str(ck),
            "--device", "cpu"]
    assert cli.main(args) == 0
    assert saved == [3] and png.stat().st_size > 0
    assert made[-1].use_megakernel is fused

    # Resume from a checkpoint at batch 1: the last two batches are one
    # chunk, and the result is the render with the same chunk boundaries.
    first = Renderer(cs, device="cpu", use_megakernel=fused)
    first.render_batches(1)
    first.save_checkpoint(str(ck))
    saved.clear()
    assert cli.main(args + ["--resume"]) == 0
    assert saved == [3]
    same = Renderer(cs, device="cpu", use_megakernel=fused)
    same.render_batches(1)
    same.render_batches(2)
    with np.load(ck) as data:
        assert int(data["current_batch"]) == 3
        assert data["accum"].tobytes() == same.image().tobytes()
