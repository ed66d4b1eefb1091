"""The fused kernel's clustered sphere sweep (ops/megakernel.py
``sphere_cluster_layout``, ``sphere_cluster_boxes``,
``sphere_cluster_sweep_reference`` and the gate) against the JAX package's
gather sweep (raytrace_tpu/ops/megakernel.py ``make_config``,
``cluster_aabbs``, ``megakernel_supported`` and K4 in interpret mode), and
the sphere stress scenes (tools/stress_scenes.py).  The CUDA forms are held
against their plain version in test_torch_cuda.py.

Tolerances: the cluster boxes equal JAX's bit for bit, static and as the
union over the shutter (tolerance 0); the layout (n_prefix, G, C) equal;
the clustered plain sweep equals the dense plain sweep bit for bit in t
and id; against JAX's XLA ``intersect_spheres_world`` ids, and ids with t
within rtol=1e-3, atol=1e-3, each on >= 99.9% of rays (XLA contracts
multiply-adds into FMAs, torch does not); the plain fused render of a
small stress-4x frame against JAX K4, test_torch_megakernel.py's: rays
within 0.5%, per-sample channel means within 1e-3, at most 5% of pixels
with a max-channel difference above 1e-4 (32x18, 4 spp x 2 batches,
depth 6; JAX's interpret-mode render takes ~20 s of the development CPU).
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
from raytrace_tpu.ops import spheres as jspheres
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer, arrays, wavefront
from raytrace_tpu_torch.models import compile_scene
from raytrace_tpu_torch.ops import camera, megakernel, sphere_sweep, spheres
from raytrace_tpu_torch.ops.intersect import T_MAX
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.scene_file import SceneFile
from raytrace_tpu_torch.tools import stress_scenes

torch.set_num_threads(1)

W, H = 32, 18
AGREEMENT = 0.999
RTOL = ATOL = 1e-3
MB_SCENE = cli.DEFAULT_SCENE.replace("final-one-weekend.json",
                                     "final-one-weekend-motion-blur.json")


def _grid_doc(n_grid=24):
    """n_grid^2 small spheres on a jittered grid over a ground sphere
    (tests/test_stress_scale.py's big sphere scene): 577 spheres, whose
    clusters need G = 8."""
    rng = np.random.default_rng(11)
    prims = [{"uv_sphere": {"name": "ground", "center": [0, -1000, 0],
                            "radius": 1000, "rings": 4, "segments": 8,
                            "material": "ground"}}]
    for i in range(n_grid):
        for j in range(n_grid):
            c = [i - n_grid / 2 + 0.6 * rng.random(), 0.2,
                 j - n_grid / 2 + 0.6 * rng.random()]
            prims.append({"uv_sphere": {"name": f"s{i}_{j}", "center": c,
                                        "radius": 0.2, "rings": 4,
                                        "segments": 8, "material": "grey"}})
    return {
        "cameras": [{"perspective": {
            "name": "default", "eye": [13, 2, 3], "look_at": [0, 0, 0],
            "up": [0, 1, 0], "fov_y": 20, "z_near": 0.1, "z_far": 10000,
            "focal_length": 10.0, "aperture_size": 0}}],
        "textures": [{"constant": {"name": "grey", "rgb": [0.5, 0.5, 0.5]}},
                     {"constant": {"name": "ground",
                                   "rgb": [0.8, 0.8, 0.0]}}],
        "materials": [{"lambertian": {"name": "grey", "albedo": "grey"}},
                      {"lambertian": {"name": "ground",
                                      "albedo": "ground"}}],
        "primitives": prims,
        "instances": [{"name": p["uv_sphere"]["name"]} for p in prims],
        "sky": {"vertical_gradient": {"factor": 0.5,
                                      "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": 2, "max_ray_depth": 6,
                   "aspect_ratio": 16 / 9},
    }


def _doc(name):
    if name == "final-one-weekend":
        with open(cli.DEFAULT_SCENE) as f:
            return json.load(f)
    if name == "motion-blur":
        with open(MB_SCENE) as f:
            return json.load(f)
    if name == "grid-577":
        return _grid_doc()
    return stress_scenes.sphere_stress_doc(*stress_scenes.SPHERE_STRESS[name])


@functools.lru_cache(maxsize=None)
def _port_cs(name):
    """The port's own compile of the scene at 32x18, 2 batches, depth 6."""
    cs = compile_scene(SceneFile.from_json_dict(_doc(name)), width=W,
                       height=H)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=4, sample_batches=2, max_ray_depth=6))


@functools.lru_cache(maxsize=None)
def _jax_cs(name):
    cs = jax_compile_scene(JaxSceneFile.from_json_dict(_doc(name)), width=W,
                           height=H)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=4, sample_batches=2, max_ray_depth=6))


def _static(cs):
    _, static = arrays.upload_scene(cs, "cpu")
    return dataclasses.replace(static, sphere_world_mode=True)


def _table8(cs, t=0.5):
    tab = spheres.world_sphere_tables(cs, np.array([t], np.float32))[0]
    return sphere_sweep.pad_table8(torch.tensor(tab))


def _jax_grid(table8, n_prefix, G, C):
    """The sphere rows the JAX kernel clusters, as build_mega_tables cuts
    and pads them (raytrace_tpu/ops/megakernel.py:2350-2358)."""
    S8 = table8.shape[0]
    take = min(C * G, S8 - n_prefix)
    grid = np.zeros((C * G, 8), np.float32)
    grid[:, 4] = jmega.BIGF
    grid[:take] = np.asarray(table8[n_prefix:n_prefix + take])
    return grid, take


# ---- the layout and the boxes ----------------------------------------------

@pytest.mark.parametrize("name,G", [("final-one-weekend", 4),
                                    ("grid-577", 8), ("stress-4x", 16)])
def test_layout_matches_jax_make_config(name, G):
    """n_prefix, G and C are the JAX gather sweep's, whose sphere order the
    port's copy of models/sphere_order.py reproduces."""
    cs, jcs = _port_cs(name), _jax_cs(name)
    np.testing.assert_array_equal(cs.sph_center, jcs.sph_center)
    np.testing.assert_array_equal(cs.sph_radius, jcs.sph_radius)
    layout = megakernel.sphere_cluster_layout(_static(cs))
    jscene, jstatic = jarrays.upload_scene(jcs)
    cfg = jmega.make_config(jstatic, jscene, False)
    assert cfg.use_gather
    assert layout == (cfg.n_prefix, cfg.clu_g, cfg.n_clusters)
    assert layout[1] == G and layout[0] == jcs.sph_prefix > 0


@pytest.mark.parametrize("name", ["final-one-weekend", "stress-4x"])
def test_boxes_match_jax_cluster_aabbs(name):
    cs = _port_cs(name)
    n_prefix, G, C = megakernel.sphere_cluster_layout(_static(cs))
    table8 = _table8(cs)
    boxes = megakernel.sphere_cluster_boxes(table8, n_prefix, G, C).numpy()
    grid, _ = _jax_grid(table8, n_prefix, G, C)
    jb = np.asarray(jmega.cluster_aabbs(jnp.asarray(grid), C, G))
    np.testing.assert_array_equal(boxes[:, 0:3], jb[:, 0:3])
    np.testing.assert_array_equal(boxes[:, 4:7], jb[:, 3:6])
    # The w columns, which JAX leaves 0, hold the terms of the pretest's
    # rounding margin: SPHERE_ROUNDING / the least radius, the most
    # |c| + r.
    g = table8[n_prefix:cs.num_spheres]
    c = torch.div(torch.arange(g.shape[0]), G, rounding_mode="floor")
    for k in range(C):
        rows = g[c == k]
        assert boxes[k, 3] == np.float32(megakernel.SPHERE_ROUNDING
                                         / rows[:, 3].min())
        assert boxes[k, 7] == torch.max(
            torch.linalg.vector_norm(rows[:, 0:3], dim=1) + rows[:, 3])


def test_animated_boxes_are_jax_shutter_unions():
    """The motion-blur scene's boxes: the union of each cluster's boxes at
    c0 and c0 + dc, as raytrace_tpu/ops/megakernel.py:2364-2378 takes it."""
    cs = _port_cs("motion-blur")
    n_prefix, G, C = megakernel.sphere_cluster_layout(_static(cs))
    tab0, dtab8 = (torch.tensor(t) for t in
                   spheres.world_sphere_anim_tables(cs))
    table8 = sphere_sweep.pad_table8(tab0)
    boxes = megakernel.sphere_cluster_boxes(table8, n_prefix, G, C,
                                            dtab8=dtab8).numpy()
    grid, take = _jax_grid(table8, n_prefix, G, C)
    dg = np.zeros((C * G, 8), np.float32)
    dg[:take] = np.asarray(dtab8[n_prefix:n_prefix + take])
    grid = jnp.asarray(grid)
    aabb = jmega.cluster_aabbs(grid, C, G)
    aabb1 = jmega.cluster_aabbs(grid.at[:, 0:3].add(jnp.asarray(dg)[:, 0:3]),
                                C, G)
    jb = np.asarray(aabb.at[:, 0:3].set(jnp.minimum(aabb[:, 0:3],
                                                    aabb1[:, 0:3]))
                    .at[:, 3:6].set(jnp.maximum(aabb[:, 3:6],
                                                aabb1[:, 3:6])))
    np.testing.assert_array_equal(boxes[:, 0:3], jb[:, 0:3])
    np.testing.assert_array_equal(boxes[:, 4:7], jb[:, 3:6])
    # Each sphere at any shutter time lies inside its cluster's box.
    for t in (0.0, 0.31, 1.0):
        moved = megakernel.moved_table(table8, dtab8, torch.tensor(t))
        g = moved[n_prefix:cs.num_spheres]
        c = torch.div(torch.arange(g.shape[0]), G, rounding_mode="floor")
        b = torch.tensor(boxes)[c]
        assert (g[:, 0:3] - g[:, 3:4] >= b[:, 0:3]).all()
        assert (g[:, 0:3] + g[:, 3:4] <= b[:, 4:7]).all()


def test_empty_cluster_box_is_a_far_point():
    """A cluster of padding rows alone gets the point box at _BIGF, which
    no ray's pretest passes."""
    table8 = torch.zeros((16, 8))
    table8[:, 4] = 3.0e37
    table8[:3, 0:5] = torch.tensor([[0.0, 0, 0, 1, -1], [2, 0, 0, 0.5, 3.75],
                                    [4, 0, 0, -0.5, 15.75]])
    boxes = megakernel.sphere_cluster_boxes(table8, 1, 2, 3)
    assert torch.equal(boxes[1], torch.tensor([3e37, 3e37, 3e37, 0,
                                               3e37, 3e37, 3e37, 0]))
    assert boxes[0, 0] < 1.5 and boxes[0, 4] > 4.5   # |r| of a negative r
    o = V3(torch.zeros(4), torch.zeros(4), torch.zeros(4))
    d = V3(torch.ones(4), torch.zeros(4), torch.zeros(4))
    passes = megakernel.cluster_pretest(o, d, boxes, torch.full((4,), T_MAX))
    assert passes[0].all() and not passes[1].any()


# ---- the clustered sweep ----------------------------------------------------

def _captured_rays(cs):
    """Every bounce's (o, d, alive) of one batch of ``cs`` on the CPU
    wavefront."""
    scene, static = arrays.upload_scene(cs, "cpu")
    static = dataclasses.replace(static, sphere_world_mode=True)
    geom = wavefront.prepare_batch(static, scene, _table8(cs)[:, :5])
    cam = camera.build_camera_arrays(cs.cameras[cs.render.camera], W, H,
                                     "cpu")
    trace = wavefront.make_trace_fn(static, scene, geom)
    seen = []

    def capture(o, d, alive):
        seen.append((o, d, alive))
        return trace(o, d, alive)

    use_dof = cs.cameras[cs.render.camera].aperture_size > 0.0
    wavefront.render_tile(static, scene, cam, capture, geom, 0, 0, H,
                          use_dof)
    return seen


def _random_rays(table8, n_sph, R, seed):
    """Rays from inside random spheres (dielectric exits), from random
    points around the scene, and along the axes (directions with zero
    components), with an alive mask."""
    g = np.random.default_rng(seed)
    tab = table8[:n_sph].numpy().astype(np.float64)
    pick = g.integers(0, n_sph, R)
    u = g.standard_normal((R, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = tab[pick, :3] + u * (0.9 * np.abs(tab[pick, 3:4])
                             * g.random((R, 1)))
    big = np.abs(tab[:, 3]) > 50
    lo, hi = tab[~big, :3].min(0) - 2, tab[~big, :3].max(0) + 2
    o[R // 2:] = g.uniform(lo, hi, (R - R // 2, 3))
    d = g.standard_normal((R, 3))
    axes = np.eye(3)[g.integers(0, 3, R // 4)] * g.choice([-1.0, 1.0],
                                                           (R // 4, 1))
    d[:R // 4] = axes
    d[R // 4:R // 2, g.integers(0, 3)] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v3 = lambda a: V3(*(torch.tensor(np.ascontiguousarray(  # noqa: E731
        a[:, i], np.float32)) for i in range(3)))
    return v3(o), v3(d), torch.tensor(g.random(R) < 0.8)


def _assert_same_hits(o, d, alive, table8, boxes, layout, dtab8=None,
                      t=None):
    n_prefix, G, _ = layout
    dense = table8 if dtab8 is None else megakernel.moved_table(
        table8, dtab8, t)
    t0, id0 = sphere_sweep.sphere_sweep_reference(o, d, dense)
    t1, id1 = megakernel.sphere_cluster_sweep_reference(
        o, d, table8, boxes, n_prefix, G, dtab8=dtab8, t=t)
    t0, t1 = torch.where(alive, t0, T_MAX), torch.where(alive, t1, T_MAX)
    id0, id1 = torch.where(alive, id0, -1), torch.where(alive, id1, -1)
    assert torch.equal(t0, t1) and torch.equal(id0, id1)
    return (id1 >= n_prefix).double().mean().item()


@pytest.mark.parametrize("name", ["final-one-weekend", "stress-4x"])
def test_clustered_sweep_is_the_dense_sweep_on_the_frames_rays(name):
    cs = _port_cs(name)
    layout = megakernel.sphere_cluster_layout(_static(cs))
    table8 = _table8(cs)
    boxes = megakernel.sphere_cluster_boxes(table8, *layout)
    seen = _captured_rays(cs)
    assert len(seen) >= 4
    clustered_hits = [_assert_same_hits(o, d, alive, table8, boxes, layout)
                      for o, d, alive in seen]
    assert max(clustered_hits) > 0.05   # the clusters are hit


@pytest.mark.parametrize("name", ["final-one-weekend", "grid-577",
                                  "stress-4x"])
def test_clustered_sweep_is_the_dense_sweep_on_random_rays(name):
    cs = _port_cs(name)
    layout = megakernel.sphere_cluster_layout(_static(cs))
    table8 = _table8(cs)
    boxes = megakernel.sphere_cluster_boxes(table8, *layout)
    o, d, alive = _random_rays(table8, cs.num_spheres, 6000, seed=5)
    assert _assert_same_hits(o, d, alive, table8, boxes, layout) > 0.2


@pytest.mark.parametrize("t", [0.0, 0.4375, 1.0])
def test_clustered_sweep_is_the_dense_sweep_while_spheres_move(t):
    cs = _port_cs("motion-blur")
    layout = megakernel.sphere_cluster_layout(_static(cs))
    tab0, dtab8 = (torch.tensor(x) for x in
                   spheres.world_sphere_anim_tables(cs))
    table8 = sphere_sweep.pad_table8(tab0)
    boxes = megakernel.sphere_cluster_boxes(table8, *layout, dtab8=dtab8)
    tt = torch.tensor(t, dtype=torch.float32)
    moved = megakernel.moved_table(table8, dtab8, tt)
    o, d, alive = _random_rays(moved, cs.num_spheres, 6000, seed=7)
    hits = _assert_same_hits(o, d, alive, table8, boxes, layout, dtab8, tt)
    assert hits > 0.2
    for o, d, alive in _captured_rays(cs)[:3]:
        _assert_same_hits(o, d, alive, table8, boxes, layout, dtab8, tt)


def test_rounding_margin_keeps_far_grazing_hits():
    """Rays from 200-2,000 units away that graze final-one-weekend's
    clustered spheres: the f32 quadratic reports some hits outside the
    JAX-padded boxes, so without the margin (box column 3 zero) the
    clustered sweep loses hits the dense sweep reports; with it, none."""
    cs = _port_cs("final-one-weekend")
    layout = megakernel.sphere_cluster_layout(_static(cs))
    table8 = _table8(cs)
    boxes = megakernel.sphere_cluster_boxes(table8, *layout)
    g = np.random.default_rng(3)
    R = 20000
    tab = table8.numpy().astype(np.float64)
    pick = g.integers(layout[0], cs.num_spheres, R)
    c, r = tab[pick, :3], tab[pick, 3:4]
    u = g.standard_normal((R, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = c + u * g.uniform(200, 2000, (R, 1))
    w = g.standard_normal((R, 3))
    w -= (w * u).sum(1, keepdims=True) * u
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    d = c + w * r * (1 + g.uniform(-2e-4, 2e-4, (R, 1))) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v3 = lambda a: V3(*(torch.tensor(np.ascontiguousarray(  # noqa: E731
        a[:, i], np.float32)) for i in range(3)))
    alive = torch.ones(R, dtype=torch.bool)
    _assert_same_hits(v3(o), v3(d), alive, table8, boxes, layout)
    bare = boxes.clone()
    bare[:, 3] = 0.0
    t0, id0 = sphere_sweep.sphere_sweep_reference(v3(o), v3(d), table8)
    t1, id1 = megakernel.sphere_cluster_sweep_reference(
        v3(o), v3(d), table8, bare, *layout[:2])
    assert ((t0 != t1) | (id0 != id1)).sum() > 100


def test_clustered_sweep_counts_its_work():
    cs = _port_cs("stress-4x")
    n_prefix, G, C = megakernel.sphere_cluster_layout(_static(cs))
    table8 = _table8(cs)
    boxes = megakernel.sphere_cluster_boxes(table8, n_prefix, G, C)
    (o, d, alive), = _captured_rays(cs)[:1]
    work = {}
    megakernel.sphere_cluster_sweep_reference(o, d, table8, boxes, n_prefix,
                                              G, work=work)
    R = o.x.shape[0]
    assert work["rays"] == R and work["box_tests"] == R * C
    assert work["prefix_tests"] == R * n_prefix
    # Sub-linear: far fewer than the dense sweep's tests.
    assert 0 < work["sphere_tests"] < 0.1 * R * (cs.num_spheres - n_prefix)


def test_clustered_sweep_matches_jax_xla_sweep():
    cs = _port_cs("stress-4x")
    layout = megakernel.sphere_cluster_layout(_static(cs))
    table8 = _table8(cs)
    boxes = megakernel.sphere_cluster_boxes(table8, *layout)
    o, d, _ = _random_rays(table8, cs.num_spheres, 4096, seed=9)
    t, ids = megakernel.sphere_cluster_sweep_reference(o, d, table8, boxes,
                                                       *layout[:2])
    assert (ids >= 0).double().mean() > 0.3
    jo = jnp.asarray(np.stack([x.numpy() for x in o], 1))
    jd = jnp.asarray(np.stack([x.numpy() for x in d], 1))
    jw = jspheres.intersect_spheres_world(jo, jd, jnp.asarray(
        table8[:cs.num_spheres, :5].numpy()))
    same_id = ids.numpy() == np.asarray(jw.sph)
    tt, jt = t.numpy(), np.asarray(jw.t)
    agree = same_id & (np.abs(tt - jt) <= ATOL + RTOL * np.abs(jt))
    assert same_id.mean() >= AGREEMENT and agree.mean() >= AGREEMENT


# ---- the gate and the configuration -----------------------------------------

@pytest.mark.parametrize("n", [4096, 4097, 16384, 16385])
@pytest.mark.parametrize("prefix", [0, 4])
@pytest.mark.parametrize("moving", [False, True])
def test_gate_agrees_with_jax_at_the_sphere_ceilings(n, prefix, moving):
    static = dataclasses.replace(_static(_port_cs("final-one-weekend")),
                                 num_spheres=n, sph_prefix=prefix,
                                 any_animated=moving)
    _, jstatic = jarrays.upload_scene(_jax_cs("final-one-weekend"))
    jstatic = dataclasses.replace(jstatic, num_spheres=n, sph_prefix=prefix,
                                  sphere_world_mode=True)
    expected = jmega.megakernel_supported(jstatic)
    assert megakernel.megakernel_supported(static) is expected
    assert expected is (n <= (16384 if prefix else 4096))


def test_config_sweeps_the_real_spheres():
    """The kernel loops over the scene's real spheres, none in a scene
    without spheres, and takes the clustered form exactly where the
    layout exists."""
    from raytrace_tpu_torch.tools import light_scenes

    for name, n, clusters in (("final-one-weekend", 488, 121),
                              ("stress-4x", 1940, 121)):
        cs = _port_cs(name)
        static = _static(cs)
        geom = wavefront.prepare_batch(static, arrays.upload_scene(
            cs, "cpu")[0], _table8(cs)[:, :5])
        cfg = megakernel.make_config(static, geom, False, 1)
        assert (cfg.n_sph, cfg.clustered, cfg.n_prefix) == (n, True, 4)
        assert megakernel.sphere_cluster_layout(static)[2] == clusters
        flat = megakernel.make_config(
            dataclasses.replace(static, sph_prefix=0), geom, False, 1)
        assert (flat.n_sph, flat.n_prefix, flat.clustered) == (n, 0, False)
    cs = compile_scene(SceneFile.from_json_dict(light_scenes.cornell_doc()),
                       width=16)
    r = Renderer(cs, device="cpu", use_megakernel=True)
    cfg = megakernel.make_config(r.static, r._geometry(0), False, 1)
    assert (cfg.n_sph, cfg.S8, cfg.clustered) == (0, 8, False)
    assert r._geometry(0).sph_tree is None


@pytest.mark.parametrize("scene", ["final-one-weekend", "motion-blur"])
def test_instance_matrices_match_jax_bit_for_bit(scene):
    """The port's _instance_matrix_at computes each distinct transform
    pair once; the result is JAX's per-instance loop's, byte for byte."""
    from raytrace_tpu.models.bvh_build import _instance_matrix_at as jax_at
    from raytrace_tpu_torch.models.bvh_build import _instance_matrix_at

    cs = _port_cs(scene)
    for t in (0.0, 0.123, 0.5, 1.0):
        assert _instance_matrix_at(cs.inst_t0, cs.inst_t1, t).tobytes() == (
            jax_at(cs.inst_t0, cs.inst_t1, t).tobytes())


# ---- the scenes and the fused path ------------------------------------------

@pytest.mark.parametrize("name,n", [("stress-4x", 1940),
                                    ("stress-16k", 16384)])
def test_sphere_stress_doc_tiles_final_one_weekend(name, n):
    doc = _doc(name)
    with open(cli.DEFAULT_SCENE) as f:
        base = json.load(f)
    prims = [p["uv_sphere"] for p in doc["primitives"]]
    assert len(prims) == len(doc["instances"]) == n
    assert prims[:488] == [p["uv_sphere"] for p in base["primitives"]]
    first = {p["name"]: p for p in prims[:488]}
    for p in prims[488:]:
        grid_name, tile = p["name"].rsplit("_t", 1)
        src = first[grid_name]
        ti, tj = int(tile[0]), int(tile[1])
        assert p["center"] == [src["center"][0] + 22.5 * ti,
                               src["center"][1],
                               src["center"][2] + 22.5 * tj]
    assert doc["render"] == base["render"]


def test_cpu_renderer_takes_the_fused_path_on_stress_4x():
    cs = _port_cs("stress-4x")
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, width=16, height=9, max_ray_depth=3, sample_batches=1))
    r = Renderer(cs, device="cpu", use_megakernel=True)
    assert r.path == "fused"
    tree = r._geometry(0).sph_tree
    assert (tree.num_spheres, tree.leaf, tree.depth) == (1936, 2, 10)
    img = r.render_all()
    assert np.isfinite(img).all() and img.mean() > 0.05


@pytest.mark.parametrize("name", ["stress-4x", "motion-blur"])
def test_only_the_fused_path_builds_the_sphere_boxes(name):
    """The fused path's geometry (a batch's, or the moving scene's one
    geometry) has the tree over every sphere past the prefix, in the
    Renderer's order, with motion rows where the spheres move; the
    wavefront's has K1's tree over the same spheres in the same order,
    built over the batch's own table, with no motion rows."""
    cs = _port_cs(name)
    fused = Renderer(cs, device="cpu", use_megakernel=True)
    wave = Renderer(cs, device="cpu", use_megakernel=False)
    assert fused.path in ("fused", "fused_anim") and wave.path == "wavefront"
    n_prefix = megakernel.sphere_cluster_layout(fused.static)[0]
    tree = fused._geometry(0).sph_tree
    assert (tree.n_prefix, tree.num_spheres) == (
        n_prefix, cs.num_spheres - n_prefix)
    assert torch.equal(tree.ids, fused._sph_order)
    assert (tree.drows is not None) == (fused.path == "fused_anim")
    wtree = wave._geometry(1).sph_tree
    assert (wtree.n_prefix, wtree.num_spheres) == (
        n_prefix, cs.num_spheres - n_prefix)
    assert torch.equal(wtree.ids, fused._sph_order)
    assert torch.equal(wave._sph_order, fused._sph_order)
    assert wtree.drows is None
    assert torch.equal(wtree.rows, wave._geometry(1).sph_table8[
        wtree.ids.long()])


@functools.lru_cache(maxsize=None)
def _jax_k4_stress_4x():
    jcs = _jax_cs("stress-4x")
    scene, static = jarrays.upload_scene(jcs)
    static = dataclasses.replace(static, use_pallas_sweep=True,
                                 pallas_interpret=True,
                                 sphere_world_mode=True)
    assert jmega.make_config(static, scene, False).use_gather
    cam = jcamera.build_camera_arrays(jcs.cameras[jcs.render.camera], W, H)
    tab = jspheres.world_sphere_tables(jcs, np.array([0.5], np.float32))[0]
    geom = jwavefront.prepare_batch(static, scene, jnp.float32(0.5),
                                    sph_table=tab)
    use_dof = jcs.cameras[jcs.render.camera].aperture_size > 0.0
    sums, rays, _, _ = jmega.render_tile_mega(
        static, scene, geom, cam, jnp.int32(0), jnp.int32(0), H, use_dof,
        interpret=True, reduce_mean=False, n_batches=2)
    return np.asarray(sums), float(rays)


def test_plain_fused_render_of_stress_4x_matches_jax_k4():
    jsums, jrays = _jax_k4_stress_4x()
    cs = arrays.from_jax_compiled(_jax_cs("stress-4x"))
    scene, static = arrays.upload_scene(cs, "cpu")
    static = dataclasses.replace(static, sphere_world_mode=True)
    geom = wavefront.prepare_batch(static, scene, _table8(cs)[:, :5])
    cam = camera.build_camera_arrays(cs.cameras[cs.render.camera], W, H,
                                     "cpu")
    use_dof = cs.cameras[cs.render.camera].aperture_size > 0.0
    sums, traced = megakernel.render_tile_mega(static, scene, geom, cam, 0,
                                               2, use_dof=use_dof)
    sums = sums.numpy()
    assert sums.shape == (H, W, 3) and np.isfinite(sums).all()
    assert abs(int(traced.sum()) - jrays) <= 0.005 * jrays
    K = 2 * 4
    np.testing.assert_allclose(sums.mean(axis=(0, 1)) / K,
                               jsums.mean(axis=(0, 1)) / K, atol=1e-3)
    assert (np.abs(sums - jsums).max(axis=-1) > 1e-4).mean() <= 0.05
