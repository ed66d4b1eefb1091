"""Triangle scenes through the port's Renderer against the JAX package's,
and the triangle gate.

The same compiled scene (the JAX package's, handed to the port through
``from_jax_compiled``) renders on four paths: the JAX wavefront (its XLA
dense triangle sweep), the JAX fused kernel in interpret mode
(``use_pallas_sweep=True``, as tests/test_tri_gather.py runs it), the
port's wavefront and the port's fused path (its plain version on the CPU).
Scenes: the triangle stress scene at k = 1 (960 triangles of the port's
uv-sphere OBJ in 16-triangle clusters, over an analytic ground sphere),
the triangle-only fixture (tools/stress_scenes.py), and the fixture with
its box moving over the shutter (the port's fused path then launches once
per batch from that batch's soup), at 32x18, depth 6.

Tolerances: the port's two paths agree with each other to float rounding
(channel means within 1e-5, ray counts equal); each agrees with each JAX
path in channel means within 5e-3, RMSE below 0.05 and ray counts within
1% (XLA's CPU build contracts multiply-adds into FMAs and PyTorch does
not, so single paths may part; the measured gaps are far below these).
Both packages choose the same path.
"""

import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.engine.arrays import from_jax_compiled, upload_scene
from raytrace_tpu_torch.engine.renderer import bvh_mode
from raytrace_tpu_torch.ops import megakernel
from raytrace_tpu_torch.tools import stress_scenes

torch.set_num_threads(1)

W, H = 32, 18
MEAN_TOL = 5e-3
RMSE_TOL = 0.05
RAY_TOL = 0.01


def _doc(name):
    if name == "tri-stress-k1":
        obj = stress_scenes.write_sphere_obj(
            os.path.join(tempfile.mkdtemp(), "sphere-smooth.obj"))
        return stress_scenes.tri_stress_doc(1, obj)
    doc = stress_scenes.triangle_fixture_doc()
    if name == "fixture-moving":
        # The box slides and turns over the shutter: a new soup per batch.
        box = next(i for i in doc["instances"] if i["name"] == "box")
        box["transform"] = {"animated": [
            {"translate": [0.0, 0.0, 0.0]},
            {"translate": [0.6, 0.0, 0.0],
             "rotate": {"axis": [0, 1, 0], "degrees": 30.0}}]}
    return doc


@functools.lru_cache(maxsize=None)
def _jcs(name):
    cs = jax_compile_scene(JaxSceneFile.from_json_dict(_doc(name)), width=W,
                           height=H)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=6))


def _close(label, img, rays, ref_img, ref_rays):
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert (img >= 0).all()
    mdiff = np.abs(img.mean((0, 1)) - ref_img.mean((0, 1))).max()
    rmse = float(np.sqrt(np.mean((img - ref_img) ** 2)))
    assert mdiff <= MEAN_TOL, f"{label}: channel means differ by {mdiff}"
    assert rmse <= RMSE_TOL, f"{label}: RMSE {rmse}"
    assert abs(rays - ref_rays) <= RAY_TOL * ref_rays, (
        f"{label}: rays {rays} vs {ref_rays}")


@pytest.mark.parametrize("name", ["tri-stress-k1", "fixture",
                                  "fixture-moving"])
def test_port_renders_match_the_jax_renders(name, monkeypatch):
    jcs = _jcs(name)
    cs = from_jax_compiled(jcs)
    launches = []
    inner = megakernel.render_tile_mega

    def counted(*args, **kw):
        launches.append(args[5] if len(args) > 5 else kw.get("n_batches", 1))
        return inner(*args, **kw)

    monkeypatch.setattr(megakernel, "render_tile_mega", counted)
    port = {}
    for fused in (False, True):
        r = Renderer(cs, device="cpu", use_megakernel=fused)
        port[fused] = (r, r.render_all(), r.stats.rays_traced)
    assert port[False][0].path == "wavefront"
    batches = cs.render.sample_batches
    if name == "fixture-moving":
        # One launch per batch, each from that batch's soup.
        assert port[True][0].path == "fused_per_batch"
        assert launches == [1] * batches
    else:
        assert port[True][0].path == "fused" and launches == [batches]
    assert port[True][0].static.has_spheres == (name == "tri-stress-k1")
    (_, w_img, w_rays), (_, f_img, f_rays) = port[False], port[True]
    assert w_rays == f_rays
    np.testing.assert_allclose(f_img.mean((0, 1)), w_img.mean((0, 1)),
                               atol=1e-5)

    for pallas in (False, True):
        j = JaxRenderer(jcs, use_pallas_sweep=pallas)
        # The same path: the fused kernel where the JAX gate admits the
        # scene with its Pallas kernels on, the wavefront otherwise.
        assert bool(j.static.use_megakernel) == (
            pallas and port[True][0].use_megakernel)
        j.render_all()
        j_img, j_rays = np.asarray(j.image()), j.stats.rays_traced
        for fused, (_, img, rays) in port.items():
            _close(f"{name}: port {'fused' if fused else 'wavefront'} vs "
                   f"JAX {'fused' if pallas else 'wavefront'}", img, rays,
                   j_img, j_rays)


# ---- the gate ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _static():
    """The stress scene's static facts, which the gate tests vary."""
    _, static = upload_scene(from_jax_compiled(_jcs("tri-stress-k1")), "cpu")
    return dataclasses.replace(static, sphere_world_mode=True)


@pytest.mark.parametrize("g,n,fused,renders", [
    # In clusters: the fused kernel up to 16,384 triangles; above it the
    # paged sweep.
    (128, 16384, True, True),
    (128, 16385, False, False),
    # In file order: the fused kernel up to 2,048, the dense wavefront
    # sweep up to 8,192, the paged sweep above.
    (0, 2048, True, True),
    (0, 2049, False, True),
    (0, 8192, False, True),
    (0, 8193, False, False),
])
def test_gate_and_triangle_ceiling(g, n, fused, renders):
    """``renders`` here: without paging (the fused kernel or the dense
    sweep); above the ceiling "auto" pages the soup, and the fused gate
    refuses a paged soup, as the JAX gate does."""
    static = dataclasses.replace(_static(), tri_cluster_g=g, num_triangles=n)
    assert megakernel.megakernel_supported(static) is fused
    mode = bvh_mode(static)
    assert mode == ("none" if renders else "paged")
    assert bvh_mode(static, use_bvh=False) == "none"
    assert bvh_mode(static, use_bvh="paged") == "paged"
    paged = dataclasses.replace(static, bvh_mode="paged")
    assert not megakernel.megakernel_supported(paged)


def test_other_gates_still_hold_triangle_scenes_back():
    """Lights, noise and image textures no longer hold a triangle scene
    back (the fused kernel's lit, noise and image forms take it); nothing
    else in the gate reads the texture families."""
    lit = dataclasses.replace(_static(), has_lights=True)
    assert megakernel.megakernel_supported(lit)
    noisy = dataclasses.replace(lit, flags=lit.flags._replace(has_noise=True))
    assert megakernel.megakernel_supported(noisy)
    static = dataclasses.replace(
        noisy, flags=noisy.flags._replace(has_image=True))
    assert megakernel.megakernel_supported(static)
