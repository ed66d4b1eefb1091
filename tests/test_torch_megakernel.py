"""The fused bounce kernel's plain version (ops/megakernel.py) against the
JAX megakernel K4 (raytrace_tpu/ops/megakernel.py render_tile_mega, in
interpret mode on the CPU), the gate against the JAX gate, and the
wrapper's contract.

Setup: final-one-weekend at 32x18, 4 spp, 2 batches fused into one call.
Tolerances (depth 6): traced rays within 0.5%, per-sample channel means
within 1e-3, at most 5% of pixels with a max-channel difference above
1e-4 (measured: 11,254 vs 11,239 rays, means within 2.0e-4, 16 of 576
pixels; XLA contracts multiply-adds into FMAs and torch does not, and a
chaotic dielectric/metal path can flip a whole sample).  Depth 1: equal
traced counts and >= 99.5% of pixels within 1e-6 (measured: all).
"""

import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine import arrays as jarrays
from raytrace_tpu.engine import wavefront as jwavefront
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import camera as jcamera
from raytrace_tpu.ops import megakernel as jmega
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import arrays, wavefront
from raytrace_tpu_torch.models import compile_scene
from raytrace_tpu_torch.scene_file import SceneFile
from raytrace_tpu_torch.engine.renderer import get_batch_ray_times
from raytrace_tpu_torch.ops import _build, camera, megakernel, spheres

torch.set_num_threads(1)

W, H = 32, 18
N_BATCHES = 2


@functools.lru_cache(maxsize=None)
def _jcs(depth):
    """The JAX package's compiled scene; the port takes its carry-over."""
    cs = jax_compile_scene(JaxSceneFile.load_json(cli.DEFAULT_SCENE),
                           width=W, height=H)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=4, sample_batches=N_BATCHES,
        max_ray_depth=depth))


def _cs(depth):
    return arrays.from_jax_compiled(_jcs(depth))


def _table(cs):
    return spheres.world_sphere_tables(cs, np.array([0.5], np.float32))[0]


@functools.lru_cache(maxsize=None)
def _jax(depth):
    """JAX K4 in interpret mode: (sums [H, W, 3], rays, traced [H, W])."""
    cs = _jcs(depth)
    scene, static = jarrays.upload_scene(cs)
    static = dataclasses.replace(static, use_pallas_sweep=True,
                                 pallas_interpret=True,
                                 sphere_world_mode=True)
    cam = jcamera.build_camera_arrays(cs.cameras[cs.render.camera], W, H)
    geom = jwavefront.prepare_batch(static, scene, jnp.float32(0.5),
                                    sph_table=_table(cs))
    use_dof = cs.cameras[cs.render.camera].aperture_size > 0.0
    sums, rays, traced, _ = jmega.render_tile_mega(
        static, scene, geom, cam, jnp.int32(0), jnp.int32(0), H, use_dof,
        interpret=True, reduce_mean=False, n_batches=N_BATCHES)
    return (np.asarray(sums), float(rays),
            np.asarray(traced).reshape(H, W))


def _port_args(depth):
    cs = _cs(depth)
    scene, static = arrays.upload_scene(cs, "cpu")
    static = dataclasses.replace(static, sphere_world_mode=True)
    geom = wavefront.prepare_batch(static, scene, torch.tensor(_table(cs)))
    cam = camera.build_camera_arrays(cs.cameras[cs.render.camera], W, H,
                                     "cpu")
    use_dof = cs.cameras[cs.render.camera].aperture_size > 0.0
    return (static, scene, geom, cam), use_dof


def _port(depth):
    args, use_dof = _port_args(depth)
    sums, traced = megakernel.render_tile_mega(*args, 0, N_BATCHES,
                                               use_dof=use_dof)
    return sums.numpy(), traced.numpy()


def test_plain_fused_path_matches_jax_k4():
    jsums, jrays, _ = _jax(6)
    sums, traced = _port(6)
    assert sums.shape == (H, W, 3) and np.isfinite(sums).all()
    assert abs(int(traced.sum()) - jrays) <= 0.005 * jrays
    K = N_BATCHES * 4
    np.testing.assert_allclose(sums.mean(axis=(0, 1)) / K,
                               jsums.mean(axis=(0, 1)) / K, atol=1e-3)
    bad = np.abs(sums - jsums).max(axis=-1) > 1e-4
    assert bad.mean() <= 0.05


def test_depth1_matches_jax_k4():
    jsums, jrays, jtraced = _jax(1)
    sums, traced = _port(1)
    assert int(traced.sum()) == jrays
    np.testing.assert_array_equal(traced, jtraced)
    close = np.abs(sums - jsums).max(axis=-1) <= 1e-6
    assert close.mean() >= 0.995


def test_wrapper_runs_the_plain_version_on_the_cpu():
    args, use_dof = _port_args(3)
    before = megakernel.LAUNCHES
    sums, traced = megakernel.render_tile_mega(*args, 1, 2, use_dof=use_dof)
    ref_sums, ref_traced = megakernel.megakernel_reference(
        *args, 1, 2, use_dof=use_dof)
    assert megakernel.LAUNCHES == before
    assert torch.equal(sums, ref_sums) and torch.equal(traced, ref_traced)
    assert traced.dtype == torch.int32 and traced.shape == (H, W)
    mean, _ = megakernel.render_tile_mega(*args, 1, 2, use_dof=use_dof,
                                          reduce_mean=True)
    assert torch.equal(mean, sums / 8.0)


def test_reference_matches_the_wavefront_batch_by_batch():
    """One fused call of two batches is the wavefront's two batches: the
    same rays, and per-pixel sums equal to spp times each batch's mean."""
    (static, scene, geom, cam), use_dof = _port_args(4)
    sums, traced = megakernel.megakernel_reference(
        static, scene, geom, cam, 0, 2, use_dof=use_dof)
    trace = wavefront.make_trace_fn(static, scene, geom)
    rays, tiles = 0, []
    for b in range(2):
        tile, tr = wavefront.render_tile(static, scene, cam, trace, geom, b,
                                         0, H, use_dof)
        tiles.append(tile)
        rays += tr
    assert int(traced.sum()) == rays
    np.testing.assert_allclose(sums.numpy(),
                               (4 * (tiles[0] + tiles[1])).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_sample_base_offsets_the_sample_numbers():
    """sample_base numbers the samples from an offset (the sp axis of a
    sharded render), so each sample takes its own RNG stream."""
    (static, scene, geom, cam), use_dof = _port_args(3)
    a, _ = megakernel.render_tile_mega(static, scene, geom, cam, 0,
                                       use_dof=use_dof)
    b, _ = megakernel.render_tile_mega(static, scene, geom, cam, 0,
                                       sample_base=2, use_dof=use_dof)
    assert not torch.equal(a, b)


def test_wrapper_rejects_other_devices():
    args, use_dof = _port_args(2)
    static, scene, geom, cam = args
    # The batch's sphere tree (K1's and the clustered forms') would fail
    # its own device check first; without it the device check speaks.
    meta = geom._replace(sph_table8=geom.sph_table8.to("meta"),
                         prim_rows=geom.prim_rows.to("meta"), sph_tree=None)
    with pytest.raises(ValueError, match="no fused bounce kernel"):
        megakernel.render_tile_mega(static, scene, meta, cam, 0,
                                    use_dof=use_dof)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("megakernel")


def test_kernel_flags_turn_contraction_off():
    assert "-fmad=false" in _build.nvcc_flags("megakernel")
    # K1 shares K4's sphere test (csrc/sphere_tree.cuh) and its flags.
    assert "-fmad=false" in _build.nvcc_flags("sphere_sweep")
    assert "--use_fast_math" not in _build.nvcc_flags("sphere_sweep")
    assert "--use_fast_math" not in _build.nvcc_flags("megakernel")
    assert (_build.library_path("megakernel").name
            != _build.library_path("sphere_sweep").name)


# ---- the gate --------------------------------------------------------------

def _port_static(cs):
    """The port's SceneStatic as the Renderer sets it up."""
    _, static = arrays.upload_scene(cs, "cpu")
    times = get_batch_ray_times(cs.render.sample_batches)
    world = spheres.world_sphere_tables(cs, times) is not None
    return dataclasses.replace(static, sphere_world_mode=world)


def test_gate_agrees_with_jax_on_final_one_weekend():
    cs = _cs(6)
    _, jstatic = jarrays.upload_scene(_jcs(6))
    jstatic = dataclasses.replace(jstatic, sphere_world_mode=True)
    assert jmega.megakernel_supported(jstatic)
    assert megakernel.megakernel_supported(_port_static(cs))


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
    """16,392 triangles (12 a box): too many for the soup's clusters, and
    above the kernel's ceiling for a soup in file order."""
    doc = _tiny_doc()
    doc["primitives"] = [{"box": {"name": "b", "corners": [[0, 0, 0],
                                                           [0.1, 0.1, 0.1]],
                                  "material": "m"}}]
    doc["instances"] = [{"name": "b", "transform": {"static": {
        "translate": [0.2 * (i % 40), 0, 0.2 * (i // 40)]}}}
        for i in range(n_boxes)]
    return doc


@pytest.mark.parametrize("doc,admitted", [
    # A triangle is inside the gate (tests/test_torch_triangles.py); a
    # mesh above its ceiling is not.
    (_big_mesh_doc(), False),
    # The gate admits a lit scene (the kernel's lit form) and a noise
    # texture (its noise form), as the JAX gate does.
    (_tiny_doc(material="l"), True),
    (_tiny_doc(albedo="n"), True),
    # A moving ellipsoid: motion the kernel takes, a shape it does not.
    (_tiny_doc(transform={"animated": [{"translate": [0, 0, 0]},
                                       {"translate": [0, 1, 0],
                                        "scale": [1, 2, 1]}]}), False),
    (_tiny_doc(transform={"static": {"scale": [1, 2, 1]}}), False),
], ids=["triangles", "lights", "noise", "motion-blur", "object-space"])
def test_gate_rejects_scenes_the_kernel_cannot_render(doc, admitted):
    """The gate on scenes at its edges: it rejects those the kernel cannot
    render and admits those it now can (a lit scene, a noise texture),
    as the JAX gate does."""
    cs = compile_scene(SceneFile.from_json_dict(doc), width=16, height=8)
    static = _port_static(cs)
    assert megakernel.megakernel_supported(static) is admitted
    if admitted:
        assert static.has_lights != static.flags.has_noise
        jcs = jax_compile_scene(JaxSceneFile.from_json_dict(doc), width=16,
                                height=8)
        _, jstatic = jarrays.upload_scene(jcs)
        jstatic = dataclasses.replace(jstatic, sphere_world_mode=True)
        assert jmega.megakernel_supported(jstatic)


def test_gate_admits_a_tiny_sphere_scene_and_caps_the_sphere_count():
    cs = compile_scene(SceneFile.from_json_dict(_tiny_doc()), width=16,
                       height=8)
    static = _port_static(cs)
    assert megakernel.megakernel_supported(static)
    big = dataclasses.replace(static,
                              num_spheres=megakernel.MAX_SPHERES + 1)
    assert not megakernel.megakernel_supported(big)
