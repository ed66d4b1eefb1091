"""Big meshes through the port's Renderer: the paged wavefront (the plain
version of K3 on the CPU) against the JAX Renderer's dense XLA wavefront
(``use_bvh=False``), and against the port's own dense sweep on the same
soup.

Scenes, at 32x18, depth 6, compiled by the JAX package and handed to the
port through ``from_jax_compiled``: the box grid of
tools/stress_scenes.py (16,392 triangles in 1,366 instances: two pages of
128 x 128, above every triangle ceiling); final-one-weekend's ground and
three large spheres tessellated (``analytic_spheres=False``, 28,032
triangles, as ``--mesh-geometry`` renders them); and the box grid with its
boxes sliding over the shutter, whose tree is re-fitted per batch.

- ``Renderer(cs, device="cpu")`` with defaults takes the paged wavefront;
  against the JAX render, channel means within 5e-3, RMSE below 0.05 and
  ray counts within 1% (as tests/test_torch_triangles.py: XLA's CPU build
  contracts multiply-adds, PyTorch does not);
- ``use_bvh="paged"`` and ``use_bvh=False`` on the same permuted soup give
  identical images and ray counts (K3 is the dense sweep bit for bit);
- the CLI's ``--mesh-geometry`` renders a PNG on the paged path.
"""

import dataclasses
import functools
import json
import logging

import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.engine.arrays import from_jax_compiled
from raytrace_tpu_torch.engine.renderer import paged_soup
from raytrace_tpu_torch.ops import megakernel, paged_tri, tri_sweep
from raytrace_tpu_torch.tools import stress_scenes

torch.set_num_threads(1)

W, H = 32, 18
MEAN_TOL = 5e-3
RMSE_TOL = 0.05
RAY_TOL = 0.01
SCENES = ["box-grid", "big-spheres", "box-grid-moving"]


def _doc(name):
    if name == "big-spheres":
        return stress_scenes.big_spheres_doc()
    return stress_scenes.box_grid_doc(moving=name == "box-grid-moving")


@functools.lru_cache(maxsize=None)
def _jcs(name):
    cs = jax_compile_scene(JaxSceneFile.from_json_dict(_doc(name)), width=W,
                           height=H, analytic_spheres=name != "big-spheres")
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=6, sample_batches=2))


@functools.lru_cache(maxsize=None)
def _port(name):
    """The port's render with defaults: (Renderer, image, rays)."""
    r = Renderer(from_jax_compiled(_jcs(name)), device="cpu")
    img = r.render_all()
    return r, img, r.stats.rays_traced


@pytest.mark.parametrize("name", SCENES)
def test_scene_is_a_big_mesh_on_the_paged_wavefront(name):
    jcs = _jcs(name)
    assert jcs.num_triangles > 16384 and jcs.num_spheres == 0
    assert bool(jcs.any_animated) == (name == "box-grid-moving")
    r, img, rays = _port(name)
    assert r.path == "wavefront" and r.static.bvh_mode == "paged"
    assert not r.use_megakernel
    assert not megakernel.megakernel_supported(r.static)
    assert r.compiled.mesh_tri_offsets is None
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert (img >= 0).all() and img.max() > 0.0 and rays > W * H * 4


@pytest.mark.parametrize("name", SCENES)
def test_paged_render_matches_the_jax_dense_render(name):
    _, img, rays = _port(name)
    j = JaxRenderer(_jcs(name), use_bvh=False, use_pallas_sweep=False)
    assert j.static.bvh_mode == "none"
    j.render_all()
    j_img, j_rays = np.asarray(j.image()), j.stats.rays_traced
    mdiff = np.abs(img.mean((0, 1)) - j_img.mean((0, 1))).max()
    rmse = float(np.sqrt(np.mean((img - j_img) ** 2)))
    assert mdiff <= MEAN_TOL, f"channel means differ by {mdiff}"
    assert rmse <= RMSE_TOL, f"RMSE {rmse}"
    assert abs(rays - j_rays) <= RAY_TOL * j_rays, f"rays {rays} vs {j_rays}"


@pytest.mark.parametrize("name", SCENES)
def test_paged_and_dense_sweeps_render_the_same_bytes(name, monkeypatch):
    """On the Renderer's permuted soup, at 16x9, the paged sweep and the
    dense sweep give the same image and ray count; each path calls only
    its sweep, and an animated scene builds (re-fits) its tree once per
    batch."""
    calls = {"paged": 0, "dense": 0, "tables": 0}

    def counted(key, fn):
        def inner(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return inner

    monkeypatch.setattr(paged_tri, "intersect_tris_paged",
                        counted("paged", paged_tri.intersect_tris_paged))
    monkeypatch.setattr(tri_sweep, "intersect_tris_sweep",
                        counted("dense", tri_sweep.intersect_tris_sweep))
    monkeypatch.setattr(paged_tri, "build_tri_tree",
                        counted("tables", paged_tri.build_tri_tree))
    soup = paged_soup(from_jax_compiled(_jcs(name)))
    np.testing.assert_array_equal(soup.tri_p, _port(name)[0].compiled.tri_p)
    soup = dataclasses.replace(soup, render=dataclasses.replace(
        soup.render, width=W // 2, height=H // 2))
    paged = Renderer(soup, device="cpu", use_bvh="paged")
    batches = soup.render.sample_batches
    assert calls["tables"] == (0 if soup.any_animated else 1)
    paged_img = paged.render_all()
    assert calls["tables"] == (batches if soup.any_animated else 1)
    dense = Renderer(soup, device="cpu", use_bvh=False)
    assert dense.static.bvh_mode == "none" and dense.path == "wavefront"
    n_paged = calls["paged"]
    dense_img = dense.render_all()
    assert n_paged > 0 and calls["paged"] == n_paged and calls["dense"] > 0
    assert dense_img.tobytes() == paged_img.tobytes()
    assert paged.stats.rays_traced == dense.stats.rays_traced > 0


def test_use_bvh_options():
    jcs = _jcs("box-grid")
    cs = from_jax_compiled(jcs)
    # True builds the SAH BVH (tests/test_torch_bvh.py holds its renders).
    r = Renderer(cs, device="cpu", use_bvh=True)
    assert r.static.bvh_mode == "sah" and r.path == "wavefront"
    assert r.compiled.tri_p.shape[0] % 256 == 0
    with pytest.raises(ValueError, match="use_bvh"):
        Renderer(cs, device="cpu", use_bvh="sah")
    # "paged" at any size; a scene without triangles has nothing to page.
    small = from_jax_compiled(jax_compile_scene(JaxSceneFile.from_json_dict(
        stress_scenes.box_grid_doc(3)), width=8, height=4))
    assert small.num_triangles == 36
    assert Renderer(small, device="cpu").static.bvh_mode == "none"
    r = Renderer(small, device="cpu", use_bvh="paged")
    assert r.static.bvh_mode == "paged" and r.path == "wavefront"
    assert np.isfinite(r.render_all()).all()


def test_cli_renders_mesh_geometry_on_the_paged_path(tmp_path, caplog):
    doc = stress_scenes.big_spheres_doc(ground=(64, 128), spheres=(16, 32))
    doc["render"].update(sample_batches=2, max_ray_depth=4)
    scene = tmp_path / "big-spheres.json"
    scene.write_text(json.dumps(doc))
    png = tmp_path / "out.png"
    caplog.set_level(logging.INFO)
    assert cli.main(["render", "--path", str(scene), "--mesh-geometry",
                     "--width", "16", "--height", "9", "-o", str(png),
                     "--device", "cpu"]) == 0
    head = png.read_bytes()[:24]
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    assert (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big")) == (16, 9)
    messages = [rec.getMessage() for rec in caplog.records]
    assert "path: wavefront (paged triangles)" in messages
    assert any(m.startswith("scene: 0 spheres, 19008 triangles")
               for m in messages)
