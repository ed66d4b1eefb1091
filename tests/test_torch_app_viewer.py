"""The port's progressive viewer (raytrace_tpu_torch/viewer.py) on the CPU
at width 48: refinement over HTTP and a PNG, a hot-swap that fails on a
scene file keeping the old scene, a hot-swap then a resize restarting
accumulation, the mtime watch, a failed render thread shown in /status,
and the finished image: byte for byte the port's Renderer's, and held to
the JAX Renderer's as tests/test_torch_render.py holds whole images
(channel means within 1e-2).  Every wait has its own timeout."""

import io
import json
import os
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.utils.image import to_srgb_u8
from raytrace_tpu_torch.viewer import Viewer

torch.set_num_threads(1)

WIDTH = 48
WAIT_S = 60.0
MEAN_ATOL = 1e-2


def _doc(sky=(0.5, 0.7, 1.0), batches=6, triangle=False):
    """Two diffuse spheres under a gradient sky (1 spp, depth 4, aspect
    2), or a triangle over a ground sphere."""
    prims = [{"uv_sphere": {"name": "g", "center": [0, 101, 0],
                            "radius": 100.0, "rings": 8, "segments": 16,
                            "material": "m"}}]
    if triangle:
        prims.append({"triangle": {
            "name": "t", "points": [[-1, 0, 0], [1, 0, 0], [0, -1.5, 0]],
            "normal": [0, 0, 1], "uv": [[0, 0], [1, 0], [0, 1]],
            "material": "m"}})
    else:
        prims.append({"uv_sphere": {"name": "s", "center": [0, 0, 0],
                                    "radius": 1.0, "rings": 8,
                                    "segments": 16, "material": "m"}})
    return {
        "cameras": [{"perspective": {
            "name": "default", "eye": [0, -1, 6], "look_at": [0, 0, 0],
            "up": [0, 1, 0], "fov_y": 40.0, "z_near": 0.01, "z_far": 100.0,
            "focal_length": 10.0, "aperture_size": 0.0}}],
        "textures": [{"constant": {"name": "w", "rgb": [0.7, 0.6, 0.5]}}],
        "materials": [{"lambertian": {"name": "m", "albedo": "w"}}],
        "primitives": prims,
        "instances": [{"name": p[next(iter(p))]["name"]} for p in prims],
        "sky": {"vertical_gradient": {"factor": 0.5, "top": list(sky),
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 1,
                   "sample_batches": batches, "max_ray_depth": 4,
                   "aspect_ratio": 2.0},
    }


def _write(path, doc):
    path.write_text(json.dumps(doc))
    return str(path)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT_S) as r:
        return r.read()


def _status(port):
    return json.loads(_get(port, "/status"))


def _wait(port, pred, timeout=WAIT_S):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        st = _status(port)
        if pred(st):
            return st
        time.sleep(0.05)
    raise TimeoutError(str(_status(port)))


def _png(port):
    return np.asarray(Image.open(io.BytesIO(_get(port, "/image.png"))))


@pytest.fixture
def scene(tmp_path):
    return _write(tmp_path / "spheres.json", _doc())


@pytest.fixture
def viewer(scene):
    v = Viewer(scene, width=WIDTH, port=0, device="cpu")
    v.start()
    yield v
    v.stop()
    assert not v._render_thread.is_alive()


def test_progressive_refinement_and_png(viewer):
    p = viewer.port
    st = _wait(p, lambda s: s["batch"] >= 1)
    assert (st["width"], st["height"]) == (WIDTH, WIDTH // 2)
    assert st["error"] is None and st["generation"] == 1
    png = _get(p, "/image.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    img = np.asarray(Image.open(io.BytesIO(png)))
    assert img.shape == (WIDTH // 2, WIDTH, 3) and img.mean() > 0
    assert b"raytrace_tpu_torch" in _get(p, "/")
    st = _wait(p, lambda s: s["batch"] == s["total_batches"])
    assert st["mrays_per_sec"] > 0


def test_finished_image_is_the_renderers(viewer, scene):
    """Run to the end: /image.png is the port's Renderer's image byte for
    byte, and its linear image is held to the JAX Renderer's."""
    _wait(viewer.port, lambda s: s["batch"] == s["total_batches"])
    r = Renderer(cli.load_scene(scene, WIDTH), device="cpu")
    img = r.render_all()
    np.testing.assert_array_equal(_png(viewer.port), to_srgb_u8(img))
    jcs = jax_compile_scene(JaxSceneFile.load_json(scene), width=WIDTH)
    jimg = JaxRenderer(jcs, use_pallas_sweep=False).render_all()
    np.testing.assert_allclose(viewer.state.renderer.image().mean((0, 1)),
                               jimg.mean((0, 1)), atol=MEAN_ATOL)


@pytest.mark.parametrize("bad", ["missing", "not-json", "bad-scene"])
def test_bad_hotswap_keeps_old_scene(viewer, tmp_path, bad):
    p = viewer.port
    _wait(p, lambda s: s["batch"] >= 1)
    gen0 = _status(p)["generation"]
    path = tmp_path / f"{bad}.json"
    if bad == "not-json":
        path.write_text("{ not json")
    elif bad == "bad-scene":
        doc = _doc()
        doc["instances"].append({"name": "no-such-primitive"})
        _write(path, doc)
    _get(p, f"/reload?path={path}")
    st = _wait(p, lambda s: s["error"] is not None)
    assert st["generation"] == gen0          # old scene kept rendering
    assert st["scene"].endswith("spheres.json")
    assert viewer._render_thread.is_alive()
    _wait(p, lambda s: s["batch"] == s["total_batches"])


def test_hotswap_and_resize_restart(viewer, tmp_path):
    p = viewer.port
    _wait(p, lambda s: s["batch"] >= 1)
    gen0 = _status(p)["generation"]
    tri = _write(tmp_path / "triangle.json", _doc(triangle=True))
    _get(p, f"/reload?path={tri}")
    st = _wait(p, lambda s: s["generation"] > gen0)
    assert st["scene"] == tri and st["error"] is None
    assert viewer.state.renderer.static.num_triangles == 1

    gen1 = st["generation"]
    _get(p, "/resize?width=32")
    st = _wait(p, lambda s: s["generation"] > gen1 and s["width"] == 32)
    assert st["scene"] == tri and st["height"] == 16
    st = _wait(p, lambda s: s["batch"] == s["total_batches"])
    # Accumulation restarted: a new Renderer, every batch its own.
    assert viewer.state.renderer.stats.batches_done == st["total_batches"]
    assert _png(p).shape == (16, 32, 3)


def test_rewritten_file_reloads(viewer, scene):
    p = viewer.port
    _wait(p, lambda s: s["batch"] == s["total_batches"])
    before = _png(p)
    gen0 = _status(p)["generation"]
    _write(Path(scene), _doc(sky=(1.0, 0.2, 0.2), batches=3))
    mt = os.path.getmtime(scene) + 5.0
    os.utime(scene, (mt, mt))
    st = _wait(p, lambda s: s["generation"] > gen0)
    assert st["total_batches"] == 3 and st["error"] is None
    _wait(p, lambda s: s["batch"] == 3)
    assert np.abs(_png(p).astype(int) - before).max() > 10


def test_render_thread_failure_shows_in_status(viewer, monkeypatch):
    """An error that is not a scene file's ends the render thread and
    shows in /status; the page keeps serving the last image."""
    p = viewer.port
    _wait(p, lambda s: s["batch"] >= 1)

    def broken(self):
        raise RuntimeError("the card went away")

    monkeypatch.setattr(Renderer, "render_next_batch", broken)
    viewer.state.request()                   # the scene starts again
    st = _wait(p, lambda s: s["error"] is not None)
    assert st["error"] == "RuntimeError: the card went away"
    viewer._render_thread.join(WAIT_S)
    assert not viewer._render_thread.is_alive()
    assert _png(p).shape == (WIDTH // 2, WIDTH, 3)
