"""A Renderer's world sphere tables (engine/renderer.py ``WorldTables``),
on the CPU: a static scene's set-up computes the first batch time's table
and each other is built when a step first reads it, ahead of its step
while the card runs the step before, or on demand; every table is the
very table that ``world_sphere_tables`` gives for all batch times, so
every image is bit for bit the one the eager tables give.  A moving
scene still computes every table at set-up, an ellipsoid scene none, a
scene without a sphere its padding rows alone, and a scene shard its
slice of each."""

import dataclasses

import numpy as np
import pytest
import torch

from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import spheres as jspheres
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.engine.renderer import WorldTables
from raytrace_tpu_torch.models import compile_scene
from raytrace_tpu_torch.ops import spheres
from raytrace_tpu_torch.ops.spheres import world_sphere_tables
from raytrace_tpu_torch.parallel.multichip import (SceneShard,
                                                   shard_sphere_tables)
from raytrace_tpu_torch.scene_file import SceneFile
from raytrace_tpu_torch.tools import ellipsoid_scenes, light_scenes
from raytrace_tpu_torch.utils import profiling

torch.set_num_threads(1)

W, H = 16, 8
BATCHES = 5
PATHS = pytest.mark.parametrize("fused", [True, False],
                                ids=["fused", "wavefront"])


def _doc(moving=False):
    """Four spheres (a ground, diffuse, metal, glass), 4 spp x 5 batches,
    depth 3; with ``moving`` the diffuse one slides up over the
    shutter."""
    def sphere(name, center, radius, material):
        return {"uv_sphere": {"name": name, "center": center,
                              "radius": radius, "rings": 8, "segments": 16,
                              "material": material}}

    instances = [{"name": n} for n in "gabc"]
    if moving:
        instances[1]["transform"] = {"animated": [
            {"translate": [0.0, 0.0, 0.0]}, {"translate": [0.0, 0.5, 0.0]}]}
    return {
        "cameras": [{"perspective": {
            "name": "default", "eye": [0.0, -1.0, 8.0],
            "look_at": [0.0, 0.0, 0.0], "up": [0.0, 1.0, 0.0],
            "fov_y": 30.0, "z_near": 0.01, "z_far": 100.0,
            "focal_length": 10.0, "aperture_size": 0.0}}],
        "textures": [{"constant": {"name": "grey", "rgb": [0.5, 0.5, 0.5]}},
                     {"constant": {"name": "fuzz", "rgb": [0.1, 0.1, 0.1]}}],
        "materials": [
            {"lambertian": {"name": "grey", "albedo": "grey"}},
            {"metal": {"name": "metal", "albedo": "grey", "fuzz": "fuzz"}},
            {"dielectric": {"name": "glass", "refraction_index": 1.5}}],
        "primitives": [sphere("g", [0.0, 1000.0, 0.0], 999.0, "grey"),
                       sphere("a", [-2.0, 0.0, 0.0], 1.0, "grey"),
                       sphere("b", [0.0, 0.0, 0.0], 1.0, "metal"),
                       sphere("c", [2.0, 0.0, 0.0], 1.0, "glass")],
        "instances": instances,
        "sky": {"vertical_gradient": {"factor": 0.5, "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": BATCHES, "max_ray_depth": 3,
                   "aspect_ratio": 2.0},
    }


def _cs(doc):
    return compile_scene(SceneFile.from_json_dict(doc), width=W, height=H)


@pytest.fixture(scope="module")
def static_cs():
    return _cs(_doc())


def _since():
    spans = profiling.spans()
    return spans[-1].t1 if spans else 0.0


def _built(since):
    """The ``renderer.step.world_table`` spans recorded since ``since``."""
    return [s for s in profiling.spans(since)
            if s.name == "renderer.step.world_table"]


def _renderer(cs, fused, **kw):
    r = Renderer(cs, device="cpu", use_megakernel=fused, **kw)
    r.CHUNK = 2
    return r


# -- a static scene -----------------------------------------------------------


@PATHS
def test_set_up_computes_one_table(static_cs, fused):
    since = _since()
    r = _renderer(static_cs, fused)
    (init,) = [s for s in profiling.spans(since)
               if s.name == "renderer.init.world_tables"]
    assert init.attrs["tables"] == 1
    assert isinstance(r.sphere_tables, WorldTables)
    assert len(r.sphere_tables) == BATCHES
    assert [b for b in range(BATCHES) if r.sphere_tables.built(b)] == [0]
    assert not _built(since)
    assert r.path == ("fused" if fused else "wavefront")


@PATHS
def test_every_table_is_the_eager_one(static_cs, fused):
    r = _renderer(static_cs, fused)
    eager = world_sphere_tables(static_cs, r.batch_times)
    since = _since()
    for b in (3, 1, 4, 2, 0, -1):
        table = r.sphere_tables[b]
        assert table.dtype == np.float32 and table.shape == eager[b].shape
        assert table.tobytes() == eager[b].tobytes()
    # Each table is computed once, on its first read.
    assert [s.attrs["batch"] for s in _built(since)] == [3, 1, 4, 2]
    assert r.sphere_tables[3] is r.sphere_tables[3]
    with pytest.raises(IndexError):
        r.sphere_tables[BATCHES]


@PATHS
def test_render_matches_the_eager_tables(static_cs, fused):
    lazy = _renderer(static_cs, fused)
    eager = _renderer(static_cs, fused)
    eager.sphere_tables = world_sphere_tables(static_cs, eager.batch_times)
    assert isinstance(eager.sphere_tables, np.ndarray)
    img = lazy.render_all()
    assert img.tobytes() == eager.render_all().tobytes()
    assert lazy.stats.rays_traced == eager.stats.rays_traced
    # A fused chunk reads its first batch's table alone.
    assert [b for b in range(BATCHES) if lazy.sphere_tables.built(b)] == (
        [0, 2, 4] if fused else list(range(BATCHES)))


@PATHS
def test_tables_are_built_ahead_between_launch_and_wait(static_cs, fused):
    r = _renderer(static_cs, fused)
    since = _since()
    r.render_all()
    built = _built(since)
    # Chunks of 2, 2 and 1 on the fused path; the wavefront steps one
    # batch at a time.
    assert [s.attrs["batch"] for s in built] == (
        [2, 4] if fused else [1, 2, 3, 4])
    for s in built:
        step = s.parent
        assert step.name == "renderer.step"
        assert step.attrs["b0"] + step.attrs["k"] == s.attrs["batch"]
        kids = [x for x in profiling.spans(step.t0) if x.parent is step]
        (launch,) = [x for x in kids if x.name == "renderer.step.launch"]
        waits = [x for x in kids if x.name == "renderer.step.wait"]
        assert launch.t1 <= s.t0 and s.t1 <= min(w.t0 for w in waits)


@PATHS
def test_a_resumed_render_builds_its_table_on_demand(static_cs, fused,
                                                     tmp_path):
    first = _renderer(static_cs, fused)
    assert first.render_batches(3) == 3
    first.save_checkpoint(str(tmp_path / "ck.npz"))
    r = _renderer(static_cs, fused)
    r.load_checkpoint(str(tmp_path / "ck.npz"))
    assert r.current_batch == 3 and not r.sphere_tables.built(3)
    since = _since()
    assert r.render_batches(2) == 2
    built = {s.attrs["batch"]: s for s in _built(since)}
    assert built[3].parent.name == "renderer.step.geometry"
    assert built[3].parent.parent.attrs["b0"] == 3
    # The fused chunk of 2 is the render's last step; the wavefront's step
    # of batch 3 builds batch 4's ahead.
    assert sorted(built) == ([3] if fused else [3, 4])
    assert not r.sphere_tables.built(1) and not r.sphere_tables.built(2)
    eager = world_sphere_tables(static_cs, r.batch_times)
    assert r.sphere_tables[3].tobytes() == eager[3].tobytes()


# -- other scenes -------------------------------------------------------------


@PATHS
def test_a_moving_scene_computes_every_table_at_set_up(fused):
    cs = _cs(_doc(moving=True))
    since = _since()
    r = _renderer(cs, fused)
    (init,) = [s for s in profiling.spans(since)
               if s.name == "renderer.init.world_tables"]
    assert init.attrs["tables"] == BATCHES
    assert isinstance(r.sphere_tables, np.ndarray)
    assert r.sphere_tables.tobytes() == world_sphere_tables(
        cs, r.batch_times).tobytes()
    r.render_all()
    assert not _built(since)


def test_an_ellipsoid_scene_has_no_tables():
    cs = _cs(ellipsoid_scenes.ellipsoid_fixture_doc())
    r = Renderer(cs, device="cpu")
    assert r.sphere_tables is None and not r.static.sphere_world_mode


def _cornell(compile_fn, scene_file):
    doc = light_scenes.cornell_doc()
    cs = compile_fn(scene_file.from_json_dict(doc), width=W, height=W)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, sample_batches=BATCHES, max_ray_depth=3))


def test_a_scene_without_spheres_skips_the_instance_matrices(monkeypatch):
    cs = _cornell(compile_scene, SceneFile)
    assert cs.num_spheres == 0
    calls = []
    real = spheres._instance_matrix_at
    monkeypatch.setattr(spheres, "_instance_matrix_at",
                        lambda *a: calls.append(a) or real(*a))
    r = Renderer(cs, device="cpu", use_megakernel=True)
    tables = [r.sphere_tables[b] for b in range(BATCHES)]
    assert not calls
    padding = np.zeros((cs.sph_center.shape[0], 5), np.float64)
    padding[:, 4] = 3.0e37
    for table in tables:
        assert table.tobytes() == padding.astype(np.float32).tobytes()
    # The early path is bit for bit JAX's loop, at any list of times.
    jcs = _cornell(jax_compile_scene, JaxSceneFile)
    times = np.concatenate([r.batch_times, [0.0, 0.5, 1.0]]).astype(
        np.float32)
    np.testing.assert_array_equal(world_sphere_tables(cs, times),
                                  jspheres.world_sphere_tables(jcs, times))


def test_a_scene_shard_gets_its_slice_of_every_table(static_cs):
    eager = shard_sphere_tables(
        world_sphere_tables(static_cs, Renderer(
            static_cs, device="cpu").batch_times), 2)
    for rank in range(2):
        since = _since()
        r = Renderer(static_cs, device="cpu",
                     shard=SceneShard(rank, 2, collective=None))
        (init,) = [s for s in profiling.spans(since)
                   if s.name == "renderer.init.world_tables"]
        assert init.attrs["tables"] == 1
        for b in range(BATCHES):
            got = r.sphere_tables[b]
            assert got.flags.c_contiguous
            assert got.tobytes() == eager[b, rank].tobytes()
