"""The port's CLI app commands on the CPU (raytrace_tpu_torch/cli.py):
exit codes (2 on a missing scene, 3 on a failed debug validation),
``--preview-every`` (the PNG written every N batches, its last bytes a
stepped render's), ``--debug``'s log, and ``gen-final-one-weekend``,
whose files are the JAX generator's byte for byte."""

import json
import logging

import numpy as np
import pytest
import torch

from raytrace_tpu.tools.generate import (
    generate_final_one_weekend_pair as jax_generate_pair)
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer

torch.set_num_threads(1)

BATCHES = 4


def _doc():
    """A diffuse sphere and a glass one under a gradient sky, 16x8, 1 spp
    x 4 batches, depth 4."""
    def sphere(name, center, material):
        return {"uv_sphere": {"name": name, "center": center, "radius": 1.0,
                              "rings": 8, "segments": 16,
                              "material": material}}

    return {
        "cameras": [{"perspective": {
            "name": "default", "eye": [0, -1, 6], "look_at": [0, 0, 0],
            "up": [0, 1, 0], "fov_y": 40.0, "z_near": 0.01, "z_far": 100.0,
            "focal_length": 10.0, "aperture_size": 0.0}}],
        "textures": [{"constant": {"name": "w", "rgb": [0.7, 0.6, 0.5]}}],
        "materials": [{"lambertian": {"name": "m", "albedo": "w"}},
                      {"dielectric": {"name": "g",
                                      "refraction_index": 1.5}}],
        "primitives": [sphere("a", [-1.1, 0, 0], "m"),
                       sphere("b", [1.1, 0, 0], "g")],
        "instances": [{"name": "a"}, {"name": "b"}],
        "sky": {"vertical_gradient": {"factor": 0.5, "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 1,
                   "sample_batches": BATCHES, "max_ray_depth": 4,
                   "aspect_ratio": 2.0},
    }


@pytest.fixture
def scene(tmp_path):
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(_doc()))
    return str(path)


def _render(scene, out, *extra):
    return cli.main(["render", "--path", scene, "--width", "16", "-o",
                     str(out), "--device", "cpu", *extra])


def test_missing_scene_exits_2(tmp_path):
    missing = str(tmp_path / "missing.json")
    assert cli.main(["render", "--path", missing, "--device", "cpu"]) == 2
    assert cli.main(["view", missing, "--port", "0", "--device", "cpu"]) == 2


def test_debug_takes_no_multichip(scene, tmp_path):
    assert _render(scene, tmp_path / "o.png", "--debug", "--multichip") == 2


def test_debug_validation_failure_exits_3(scene, tmp_path, monkeypatch,
                                          caplog):
    """A step whose image holds a NaN: the Renderer's debug scan raises
    DebugValidationError inside cmd_render, and the CLI exits 3."""
    slab = Renderer._slab

    def poisoned(self, b0, k, mean):
        img, rays = slab(self, b0, k, mean)
        img[0, 0, 0] = float("nan")
        return img, rays

    monkeypatch.setattr(Renderer, "_slab", poisoned)
    out = tmp_path / "o.png"
    with caplog.at_level(logging.ERROR, logger="raytrace_tpu_torch"):
        assert _render(scene, out, "--debug") == 3
    assert ("debug validation failed: batch 0: 1 non-finite / 0 negative"
            in caplog.text)
    assert not out.exists()


def test_preview_every_writes_the_png(scene, tmp_path, monkeypatch, caplog):
    """--preview-every 1 steps a batch at a time and writes the PNG after
    each, then once more at the end; the bytes are those of a Renderer
    stepped batch by batch.  --debug logs each batch against the bound."""
    writes = []
    save_png = Renderer.save_png

    def counted(self, path):
        writes.append(self.current_batch)
        save_png(self, path)

    monkeypatch.setattr(Renderer, "save_png", counted)
    out = tmp_path / "preview.png"
    with caplog.at_level(logging.INFO, logger="raytrace_tpu_torch"):
        assert _render(scene, out, "--preview-every", "1", "--debug") == 0
    assert writes == [*range(1, BATCHES + 1), BATCHES]
    valid = [r for r in caplog.messages if r.startswith("debug: batch")]
    assert len(valid) == BATCHES and "of bound 6" in valid[-1]
    assert f"debug: {BATCHES} checks, 0 non-finite, 0 negative" in (
        caplog.text)

    r = Renderer(cli.load_scene(scene, 16), device="cpu")
    while r.render_next_batch():
        pass
    stepped = tmp_path / "stepped.png"
    save_png(r, str(stepped))
    assert out.read_bytes() == stepped.read_bytes()


def test_preview_every_2_caps_the_chunk(scene, tmp_path, monkeypatch):
    chunks = []
    render_batches = Renderer.render_batches

    def counted(self, k):
        chunks.append(k)
        return render_batches(self, k)

    monkeypatch.setattr(Renderer, "render_batches", counted)
    assert _render(scene, tmp_path / "o.png", "--preview-every", "2") == 0
    assert chunks == [2, 2, 2]


def test_gen_final_one_weekend_matches_jax(tmp_path):
    out = tmp_path / "gen"
    assert cli.main(["gen-final-one-weekend", "--out-dir", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "final-one-weekend-motion-blur.json", "final-one-weekend.json"]
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    for scene, name in zip(jax_generate_pair(),
                           ["final-one-weekend.json",
                            "final-one-weekend-motion-blur.json"]):
        scene.save_json(str(jax_dir / name))
        assert (out / name).read_bytes() == (jax_dir / name).read_bytes()
    static = json.loads((out / "final-one-weekend.json").read_text())
    centers = [next(iter(p.values()))["center"] for p in static["primitives"]]
    assert len(centers) == 488 and np.isfinite(centers).all()
