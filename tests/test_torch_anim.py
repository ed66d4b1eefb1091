"""Motion blur in the port: the animated form of the fused kernel (the JAX
kernel's ``anim_lerp``) through its plain version, against the JAX
package on the CPU, on final-one-weekend-motion-blur (391 of 488 spheres
moving) at 32x18, 4 spp.

- ``world_sphere_anim_tables`` and the fat rows bit for bit; None for
  radius animation and for a centre path that is not a line
  (tests/test_anim_fuse.py:62-79);
- the port's fused animated chunk against the JAX Renderer's
  (use_pallas_sweep=True, interpret mode), depth 6, 3 batches: rays within
  0.5%, channel means within 2e-4, at most 5% of pixels above 1e-4 (the
  tolerances of tests/test_torch_megakernel.py; XLA contracts
  multiply-adds into FMAs and torch does not, and a chaotic path can flip
  a whole sample);
- a fused chunk against per-batch steps: rtol 2e-6, atol 2e-7, the
  running-mean fold order (tests/test_anim_fuse.py:86-96);
- against the port's wavefront, which renders each batch from its exact
  world table: channel means within 2e-3 (statistical: the f32 lerp moves
  centres by an ulp, tests/test_anim_fuse.py:100-108);
- other motion takes one launch per batch, each from that batch's table.
"""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine import Renderer as JaxRenderer
from raytrace_tpu.engine import arrays as jarrays
from raytrace_tpu.engine import wavefront as jwavefront
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import spheres as jspheres
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer, arrays, wavefront
from raytrace_tpu_torch.ops import megakernel, spheres, sphere_sweep

torch.set_num_threads(1)

W, H = 32, 18
SCENE = os.path.join(os.path.dirname(cli.DEFAULT_SCENE),
                     "final-one-weekend-motion-blur.json")


@functools.lru_cache(maxsize=None)
def _jcs(batches=3, depth=6):
    """The JAX package's compiled scene; the port takes its carry-over."""
    cs = jax_compile_scene(JaxSceneFile.load_json(SCENE), width=W, height=H)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=4, sample_batches=batches,
        max_ray_depth=depth))


@functools.lru_cache(maxsize=None)
def _cs(batches=3, depth=6):
    return arrays.from_jax_compiled(_jcs(batches, depth))


def _bent(cs):
    """The scene with one sphere's instance turned 90 degrees about x at
    t = 1: its centre sweeps an arc (tests/test_anim_fuse.py:72-79)."""
    si = int(cs.sph_inst[0])
    t1 = np.array(cs.inst_t1)
    s45 = np.sin(np.pi / 4)
    t1[si, 3:7] = [s45, 0.0, 0.0, s45]
    return dataclasses.replace(cs, inst_t1=t1)


@pytest.fixture(scope="module")
def fused():
    r = Renderer(_cs(), device="cpu", use_megakernel=True)
    return r, r.render_all()


@pytest.fixture
def calls(monkeypatch):
    """The geometry and batch count of each fused wrapper call."""
    seen = []
    inner = megakernel.render_tile_mega

    def counted(static, scene, geom, cam, batch0, n_batches=1, *a, **kw):
        seen.append((geom, batch0, n_batches))
        return inner(static, scene, geom, cam, batch0, n_batches, *a, **kw)

    monkeypatch.setattr(megakernel, "render_tile_mega", counted)
    return seen


def test_anim_tables_match_jax_bitwise():
    ours = spheres.world_sphere_anim_tables(_cs())
    theirs = jspheres.world_sphere_anim_tables(_jcs())
    assert ours is not None and theirs is not None
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    tab0, dtab8 = ours
    assert tab0.shape == (488, 5) and dtab8.shape == (488, 8)
    assert (np.abs(dtab8[:, 0:3]).sum(1) > 0).sum() == 391


def test_anim_tables_reject_radius_and_nonlinear_motion():
    cs = _cs()
    si = int(cs.sph_inst[0])
    grown = np.array(cs.inst_t1)
    grown[si, 7:10] = grown[si, 7:10] * 2.0
    assert spheres.world_sphere_anim_tables(
        dataclasses.replace(cs, inst_t1=grown)) is None
    assert spheres.world_sphere_anim_tables(_bent(cs)) is None
    assert jspheres.world_sphere_anim_tables(_bent(_jcs())) is None


def test_prepare_batch_motion_rows_match_jax_bitwise():
    jcs = _jcs()
    tab0, dtab8 = jspheres.world_sphere_anim_tables(jcs)
    jscene, jstatic = jarrays.upload_scene(jcs)
    jstatic = dataclasses.replace(jstatic, sphere_world_mode=True)
    jgeom = jwavefront.prepare_batch(jstatic, jscene, jnp.float32(0.0),
                                     sph_table=tab0, sph_dtab=dtab8)
    scene, static = arrays.upload_scene(_cs(), "cpu")
    geom = wavefront.prepare_batch(static, scene, torch.tensor(tab0),
                                   sph_dtab=torch.tensor(dtab8))
    np.testing.assert_array_equal(geom.prim_rows.numpy(),
                                  np.asarray(jgeom.prim_rows))
    assert torch.equal(geom.sph_dtab8, torch.tensor(dtab8))
    assert (geom.prim_rows[:, 49:52] != 0).any(1).sum() == 391


def test_geometry_at_matches_the_per_batch_tables():
    """The plain version's moved table agrees with the host's exact
    per-batch table to f32 rounding (tests/test_anim_fuse.py:41-58)."""
    r = Renderer(_cs(batches=25), device="cpu", use_megakernel=True)
    exact = r.sphere_tables
    for b in (0, 7, 24):
        g = megakernel.geometry_at(r._geometry(b), r.batch_times_dev[b])
        np.testing.assert_allclose(g.sph_table8[:488, 0:3].numpy(),
                                   exact[b, :, 0:3], rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.sph_table8[:488, 4].numpy(),
                                   exact[b, :, 4], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(g.prim_rows[:488, 44:47].numpy(),
                                   exact[b, :, 0:3], rtol=0, atol=1e-6)
        assert g.sph_dtab8 is None


def test_path_choice_from_facts_about_the_scene():
    assert Renderer(_cs(), device="cpu", use_megakernel=True).path == (
        "fused_anim")
    assert Renderer(_cs(), device="cpu").path == "wavefront"
    assert Renderer(_bent(_cs()), device="cpu",
                    use_megakernel=True).path == "fused_per_batch"
    j = JaxRenderer(_jcs(), use_pallas_sweep=True)
    assert j.static.anim_fuse


def test_fused_chunk_matches_the_jax_fused_chunk(fused):
    r, img = fused
    j = JaxRenderer(_jcs(), use_pallas_sweep=True)
    assert j.static.anim_fuse and j.render_batches(3) == 3
    jimg = j.image()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert abs(r.stats.rays_traced - j.stats.rays_traced) <= (
        0.005 * j.stats.rays_traced)
    np.testing.assert_allclose(img.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)),
                               atol=2e-4)
    assert (np.abs(img - jimg).max(axis=-1) > 1e-4).mean() <= 0.05


def test_fused_chunk_is_one_call_and_matches_batch_steps(fused, calls):
    r, img = fused
    assert r.render_batches(5) == 0
    stepped = Renderer(_cs(), device="cpu", use_megakernel=True)
    while stepped.render_next_batch():
        pass
    assert [n for _, _, n in calls] == [1, 1, 1]
    assert all(g is stepped._anim_geom for g, _, _ in calls)
    assert stepped.stats.rays_traced == r.stats.rays_traced
    np.testing.assert_allclose(stepped.image(), img, rtol=2e-6, atol=2e-7)
    again = Renderer(_cs(), device="cpu", use_megakernel=True)
    calls.clear()
    again.render_all()
    assert [(b, n) for _, b, n in calls] == [(0, 3)]
    assert again.image().tobytes() == img.tobytes()


def test_fused_chunk_matches_the_wavefront(fused):
    r, img = fused
    w = Renderer(_cs(), device="cpu", use_megakernel=False)
    wimg = w.render_all()
    assert np.abs(img.mean(axis=(0, 1)) - wimg.mean(axis=(0, 1))).max() < 2e-3
    assert abs(r.stats.rays_traced - w.stats.rays_traced) <= (
        0.02 * w.stats.rays_traced)


def test_other_motion_takes_one_launch_per_batch(calls):
    cs = _bent(_cs(depth=3))
    r = Renderer(cs, device="cpu", use_megakernel=True)
    before = megakernel.LAUNCHES, megakernel.ANIM_LAUNCHES
    assert r.render_batches(3) == 3
    # The CPU runs the plain version: no kernel launch is counted.
    assert (megakernel.LAUNCHES, megakernel.ANIM_LAUNCHES) == before
    assert [(b, n) for _, b, n in calls] == [(0, 1), (1, 1), (2, 1)]
    for geom, b, _ in calls:
        assert geom.sph_dtab8 is None
        assert torch.equal(geom.sph_table8, sphere_sweep.pad_table8(
            torch.tensor(r.sphere_tables[b])))
    stepped = Renderer(cs, device="cpu", use_megakernel=True)
    while stepped.render_next_batch():
        pass
    assert stepped.image().tobytes() == r.image().tobytes()


def test_wrapper_needs_the_times_for_an_animated_geometry():
    r = Renderer(_cs(depth=2), device="cpu", use_megakernel=True)
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
    with pytest.raises(ValueError, match="batch times"):
        megakernel.render_tile_mega(*args, use_dof=r.use_dof)
    sums, _ = megakernel.render_tile_mega(*args, use_dof=r.use_dof,
                                          times=r.batch_times_dev)
    ref, _ = megakernel.megakernel_reference(*args, use_dof=r.use_dof,
                                             times=r.batch_times_dev)
    assert torch.equal(sums, ref)


def test_gate_admits_motion_blur_and_keeps_its_cap():
    r = Renderer(_cs(), device="cpu", use_megakernel=True)
    assert r.static.any_animated and megakernel.megakernel_supported(r.static)
    assert megakernel.MAX_SPHERES_ANIM * 48 + 160 <= 232_448
    # Swept densely (no cluster layout), the moving spheres keep the
    # staged table's cap; in clusters the cap is the clustered sweep's,
    # as in the JAX gate, which reads no motion.
    dense = dataclasses.replace(r.static, sph_prefix=0)
    big = dataclasses.replace(dense,
                              num_spheres=megakernel.MAX_SPHERES_ANIM + 1)
    assert not megakernel.megakernel_supported(big)
    assert megakernel.megakernel_supported(dataclasses.replace(
        big, sph_prefix=r.static.sph_prefix))
    assert not megakernel.megakernel_supported(dataclasses.replace(
        r.static, num_spheres=megakernel.MAX_SPHERES_CLUSTERED + 1))


def test_cli_renders_motion_blur_on_the_cpu_when_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "load_scene",
                        lambda *a, **k: _cs(batches=2, depth=2))
    png = tmp_path / "mb.png"
    assert cli.main(["render", "--path", SCENE, "-o", str(png),
                     "--device", "cpu"]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    assert cli.main(["render", "--path", SCENE, "-o", str(png)]) == 2
