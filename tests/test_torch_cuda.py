"""Card-only tests of the port: the CUDA kernels against their plain
PyTorch versions on the same tensors, and both render paths on the card.
No JAX here, so they also run on a GPU machine without it
(tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test skips with a reason where torch.cuda.is_available() is false.
Sphere sweep: ids equal, and ids equal with t within rtol=1e-3, atol=1e-3,
each on >= 99.9% of rays (nvcc contracts multiply-adds into FMAs, PyTorch's
elementwise kernels do not; a ray starting within float error of T_MIN
from a surface may take the other root).  Fused bounce kernel (built
without contraction): traced rays within 0.5%, per-sample channel means
within 1e-3, at most 5% of pixels with a max-channel difference above
1e-4; on small scenes every pixel's bounce count equal.  Its animated
form (motion blur): the same, and every pixel's bounce count equal.
Triangle sweep K2 and the fused kernel's triangle form (both built without
contraction): bit for bit with their plain versions; the triangle form
against the wavefront with K2: channel means within 2e-3, rays within 0.5%.
The fused kernel's lit forms (lights, with and without triangles): bit for
bit with their plain versions on the four lit docs of
tools/light_scenes.py at depth 50; the Renderer's fused path against the
wavefront: channel means within 2e-3, rays within 0.5%.  The paged
triangle sweep K3 (built without contraction): bit for bit with its plain
version and with K2 over the same soup; the Renderer's paged wavefront on
the card byte-identical with its dense sweep, and within the card-vs-CPU
limits (means 1e-2, rays 2%) of the CPU's render.  The fused kernel's
noise forms (each of its five forms with noise textures): bit for bit
with their plain versions on the small docs of
tools/noise_scenes.form_checks, and the Renderer's fused path on
perlin-spheres against its wavefront: channel means within 2e-3, rays
within 0.5%.  The fused kernel's image forms (each form but the animated
one, with and without noise, with image textures): bit for bit with their
plain versions on the small docs of tools/image_scenes.form_checks, two
launches byte-identical; the Renderer's fused path on the earth against
its wavefront: channel means within 2e-3, rays within 0.5%; a moving image
scene launches the image form once per batch.  The fused kernel's
clustered sphere forms (each form, and its noise and image twins, with
the spheres in Morton clusters): bit for bit with their plain (dense)
versions on the small docs of tools/stress_scenes.cluster_form_checks,
two launches byte-identical, and the dense forms the same on those docs
with the cluster layout dropped; the Renderer's fused path on stress-4x
against its wavefront: channel means within 2e-3, rays within 0.5%.  The
final-one-weekend and motion-blur checks above run both the clustered
form (the scenes' layout) and the dense one (layout dropped).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.models import compile_scene
from raytrace_tpu_torch.ops import megakernel, paged_tri, sphere_sweep, tri_sweep
from raytrace_tpu_torch.ops.intersect import T_MAX
from raytrace_tpu_torch.ops.vec3 import V3
from raytrace_tpu_torch.scene_file import SceneFile

pytestmark = pytest.mark.cuda

AGREEMENT = 0.999
RTOL = ATOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(S, R, seed, dev):
    """A 1000-radius ground sphere (centre y = -1000) under S - 1 small
    spheres, R rays from the air above it, a random alive mask."""
    g = np.random.default_rng(seed)
    c = np.zeros((S, 3))
    r = np.zeros(S)
    c[0], r[0] = (0.0, -1000.0, 0.0), 1000.0
    c[1:] = g.uniform([-11, 0.2, -11], [11, 1.0, 11], (S - 1, 3))
    r[1:] = g.uniform(0.2, 1.0, S - 1)
    table = np.zeros((S, 5))
    table[:, :3], table[:, 3] = c, r
    table[:, 4] = (c ** 2).sum(-1) - r ** 2
    o = g.uniform([-13, 0.5, -13], [13, 4.0, 13], (R, 3)).astype(np.float32)
    d = g.standard_normal((R, 3)).astype(np.float32)
    v3 = lambda a: V3(*(torch.tensor(np.ascontiguousarray(a[:, i]),  # noqa
                                     device=dev) for i in range(3)))
    t8 = sphere_sweep.pad_table8(torch.tensor(table.astype(np.float32),
                                              device=dev))
    alive = torch.tensor(g.random(R) < 0.7, device=dev)
    return v3(o), v3(d), t8, alive


def _plain(o, d, t8, alive):
    t, ids = sphere_sweep.sphere_sweep_reference(o, d, t8)
    return torch.where(alive, t, T_MAX), torch.where(alive, ids, -1)


@pytest.mark.parametrize("S,R", [(3, 2048), (37, 4099), (488, 1 << 16),
                                 (1000, 2048)])
def test_kernel_matches_plain(dev, S, R):
    o, d, t8, alive = _inputs(S, R, seed=S, dev=dev)
    before = sphere_sweep.LAUNCHES
    hit = sphere_sweep.intersect_spheres_sweep(o, d, t8, alive)
    torch.cuda.synchronize()
    assert sphere_sweep.LAUNCHES == before + 1
    t_ref, id_ref = _plain(o, d, t8, alive)
    same_id = hit.sph == id_ref
    agree = same_id & ((hit.t - t_ref).abs() <= ATOL + RTOL * t_ref.abs())
    assert same_id.double().mean().item() >= AGREEMENT
    assert agree.double().mean().item() >= AGREEMENT
    assert (hit.sph[~alive] == -1).all() and (hit.t[~alive] == T_MAX).all()
    assert (hit.sph < S).all()


def test_kernel_ties_go_to_the_lowest_id(dev):
    o, d, t8, alive = _inputs(16, 512, seed=13, dev=dev)
    t8[9] = t8[4]
    for comp, val in zip(o, t8[4, :3] + torch.tensor([0.0, 3.0, 0.0],
                                                      device=dev)):
        comp.fill_(val.item())
    for comp, val in zip(d, (0.0, -1.0, 0.0)):
        comp.fill_(val)
    hit = sphere_sweep.intersect_spheres_sweep(o, d, t8,
                                               torch.ones_like(alive))
    assert (hit.sph == 4).all()


def test_kernel_rejects_misaligned_table(dev):
    o, d, t8, alive = _inputs(8, 256, seed=4, dev=dev)
    buf = torch.zeros(8 * 8 + 1, device=dev)
    shifted = buf[1:].view(8, 8)
    shifted.copy_(t8)
    with pytest.raises(ValueError, match="aligned"):
        sphere_sweep.intersect_spheres_sweep(o, d, shifted, alive)


def test_render_on_card_matches_cpu(dev):
    cs = cli.load_scene(cli.DEFAULT_SCENE, 96, 54)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, sample_batches=1, max_ray_depth=8))
    before = sphere_sweep.LAUNCHES
    gpu = Renderer(cs, device=dev, use_megakernel=False)
    g_img = gpu.render_all()
    assert sphere_sweep.LAUNCHES > before
    cpu = Renderer(cs, device="cpu")
    c_img = cpu.render_all()
    assert np.isfinite(g_img).all() and (g_img >= 0).all()
    np.testing.assert_allclose(g_img.mean(axis=(0, 1)),
                               c_img.mean(axis=(0, 1)), atol=1e-2)
    assert abs(gpu.stats.rays_traced - cpu.stats.rays_traced) <= (
        0.02 * cpu.stats.rays_traced)


# ---- the fused bounce kernel ------------------------------------------------

def _fused_args(cs, dev, k):
    r = Renderer(cs, device=dev)
    assert r.use_megakernel
    return (r.static, r.scene, r._geometry(0), r.camera, 0, k), r.use_dof


def _with_layout(args, layout):
    """The launch arguments with the scene's sphere cluster layout
    ("clusters": the clustered form) or without it ("dense")."""
    assert megakernel.sphere_cluster_layout(args[0]) is not None
    if layout == "clusters":
        return args
    return (dataclasses.replace(args[0], sph_prefix=0),) + tuple(args[1:])


def _final(w, h, depth):
    cs = cli.load_scene(cli.DEFAULT_SCENE, w, h)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=depth))


@pytest.mark.parametrize("layout", ["clusters", "dense"])
@pytest.mark.parametrize("w,h", [(32, 18), (96, 54)])
def test_fused_kernel_matches_plain(dev, w, h, layout):
    k = 2
    args, use_dof = _fused_args(_final(w, h, 8), dev, k)
    args = _with_layout(args, layout)
    before = megakernel.LAUNCHES, megakernel.SPHERE_CLUSTER_LAUNCHES
    sums, traced = megakernel.render_tile_mega(*args, use_dof=use_dof)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.SPHERE_CLUSTER_LAUNCHES) == (
        before[0] + 1, before[1] + (layout == "clusters"))
    ref, ref_traced = megakernel.megakernel_reference(*args, use_dof=use_dof)
    assert sums.shape == (h, w, 3) and torch.isfinite(sums).all()
    rays, ref_rays = int(traced.sum()), int(ref_traced.sum())
    assert abs(rays - ref_rays) <= 0.005 * ref_rays
    n = 4 * k
    torch.testing.assert_close(sums.mean((0, 1)) / n, ref.mean((0, 1)) / n,
                               rtol=0, atol=1e-3)
    bad = (sums - ref).abs().amax(-1) > 1e-4
    assert bad.double().mean().item() <= 0.05


def test_fused_kernel_is_deterministic(dev):
    args, use_dof = _fused_args(_final(96, 54, 8), dev, 2)
    a = megakernel.render_tile_mega(*args, use_dof=use_dof)
    b = megakernel.render_tile_mega(*args, use_dof=use_dof)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _sphere_doc(n):
    """Spheres under the final-one-weekend camera: a lambertian ground,
    then a metal and a dielectric sphere."""
    cam = json.load(open(cli.DEFAULT_SCENE))["cameras"]
    prims = [("ground", [0, 1000, 0], 1000.0, "lamb"),  # y points down
             ("metal", [4, -1, 0], 1.0, "metal"),
             ("glass", [0, -1, 0], 1.0, "glass")][:n]
    return {
        "cameras": cam,
        "textures": [{"constant": {"name": "grey", "rgb": [0.5, 0.5, 0.5]}},
                     {"constant": {"name": "gold",
                                   "rgb": [0.7, 0.6, 0.5]}},
                     {"constant": {"name": "fuzz", "rgb": [0.1, 0.1, 0.1]}}],
        "materials": [{"lambertian": {"name": "lamb", "albedo": "grey"}},
                      {"metal": {"name": "metal", "albedo": "gold",
                                 "fuzz": "fuzz"}},
                      {"dielectric": {"name": "glass",
                                      "refraction_index": 1.5}}],
        "primitives": [{"uv_sphere": {"name": nm, "center": c, "radius": r,
                                      "rings": 8, "segments": 16,
                                      "material": m}}
                       for nm, c, r, m in prims],
        "instances": [{"name": nm} for nm, *_ in prims],
        "sky": {"vertical_gradient": {"factor": 0.5, "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": 2, "max_ray_depth": 10,
                   "aspect_ratio": 16 / 9},
    }


@pytest.mark.parametrize("n", [1, 3])
def test_fused_kernel_traced_counts_equal_plain(dev, n):
    cs = compile_scene(SceneFile.from_json_dict(_sphere_doc(n)), width=64,
                       height=36)
    args, use_dof = _fused_args(cs, dev, 2)
    _, traced = megakernel.render_tile_mega(*args, use_dof=use_dof)
    _, ref_traced = megakernel.megakernel_reference(*args, use_dof=use_dof)
    assert torch.equal(traced, ref_traced)


def test_renderer_defaults_to_the_fused_path_on_the_card(dev):
    cs = dataclasses.replace(_final(96, 54, 8), render=dataclasses.replace(
        _final(96, 54, 8).render, sample_batches=3))
    sweeps, fused = sphere_sweep.LAUNCHES, megakernel.LAUNCHES
    r = Renderer(cs, device=dev)
    img = r.render_all()
    assert r.use_megakernel and megakernel.LAUNCHES == fused + 1
    assert sphere_sweep.LAUNCHES == sweeps
    w = Renderer(cs, device=dev, use_megakernel=False)
    w_img = w.render_all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), w_img.mean(axis=(0, 1)),
                               atol=1e-3)
    assert abs(r.stats.rays_traced - w.stats.rays_traced) <= (
        0.005 * w.stats.rays_traced)


# ---- the fused kernel's animated form (motion blur) -------------------------

def _motion_blur(w, h, depth, batches):
    path = os.path.join(os.path.dirname(cli.DEFAULT_SCENE),
                        "final-one-weekend-motion-blur.json")
    cs = cli.load_scene(path, w, h)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=depth, sample_batches=batches))


@pytest.mark.parametrize("layout", ["clusters", "dense"])
@pytest.mark.parametrize("w,h", [(32, 18), (96, 54)])
def test_animated_fused_kernel_matches_plain(dev, w, h, layout):
    """The animated form against its plain version: the same bounce
    counts and rays, and (built without contraction) the same sums."""
    r = Renderer(_motion_blur(w, h, 8, 2), device=dev)
    assert r.path == "fused_anim"
    args = _with_layout((r.static, r.scene, r._geometry(0), r.camera, 0, 2),
                        layout)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    before = (megakernel.LAUNCHES, megakernel.ANIM_LAUNCHES,
              megakernel.SPHERE_CLUSTER_LAUNCHES)
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    again, _ = megakernel.render_tile_mega(*args, **kw)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.ANIM_LAUNCHES,
            megakernel.SPHERE_CLUSTER_LAUNCHES) == (
        before[0] + 2, before[1] + 2, before[2] + 2 * (layout == "clusters"))
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    assert torch.equal(sums, again) and torch.isfinite(sums).all()
    assert torch.equal(traced, ref_traced)
    n = 4 * 2
    torch.testing.assert_close(sums.mean((0, 1)) / n, ref.mean((0, 1)) / n,
                               rtol=0, atol=1e-3)
    bad = (sums - ref).abs().amax(-1) > 1e-4
    assert bad.double().mean().item() <= 0.05


def test_animated_kernel_needs_every_batch_time(dev):
    r = Renderer(_motion_blur(32, 18, 2, 3), device=dev)
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 3)
    with pytest.raises(ValueError, match="batch times"):
        megakernel.render_tile_mega(*args, use_dof=r.use_dof)
    with pytest.raises(ValueError, match="every batch"):
        megakernel.render_tile_mega(*args, use_dof=r.use_dof,
                                    times=r.batch_times_dev[:2])


def test_renderer_takes_the_animated_kernel_on_the_card(dev):
    cs = _motion_blur(96, 54, 8, 3)
    fused, anim = megakernel.LAUNCHES, megakernel.ANIM_LAUNCHES
    r = Renderer(cs, device=dev)
    img = r.render_all()
    assert r.path == "fused_anim"
    assert megakernel.ANIM_LAUNCHES == anim + 1
    assert megakernel.LAUNCHES == fused + 1
    w = Renderer(cs, device=dev, use_megakernel=False)
    w_img = w.render_all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), w_img.mean(axis=(0, 1)),
                               atol=2e-3)


def test_other_motion_launches_once_per_batch_on_the_card(dev):
    cs = _motion_blur(32, 18, 4, 3)
    si = int(cs.sph_inst[0])
    t1 = np.array(cs.inst_t1)
    t1[si, 3:7] = [np.sin(np.pi / 4), 0.0, 0.0, np.sin(np.pi / 4)]
    cs = dataclasses.replace(cs, inst_t1=t1)
    fused, anim = megakernel.LAUNCHES, megakernel.ANIM_LAUNCHES
    r = Renderer(cs, device=dev)
    assert r.path == "fused_per_batch" and r.render_batches(3) == 3
    assert megakernel.LAUNCHES == fused + 3
    assert megakernel.ANIM_LAUNCHES == anim


# ---- triangles: the sweep K2 and the fused kernel's triangle form -----------

def _tri_soup(T, seed):
    """T random small triangles in a 10-unit box, with a duplicate pair."""
    g = np.random.default_rng(seed)
    c = g.uniform(-5, 5, (T, 3))
    tri = (c[:, None, :] + g.uniform(-0.8, 0.8, (T, 3, 3))).astype(np.float32)
    tri[T // 2] = tri[1]
    return tri


def _tri_rays(tri, R, seed, dev):
    """R rays from around the soup towards points of random triangles, a
    tenth in random directions, and a random alive mask."""
    g = np.random.default_rng(seed)
    wp = tri.astype(np.float64)
    o = g.uniform(-9, 9, (R, 3))
    j = g.integers(0, len(tri), R)
    d = np.einsum("rv,rvi->ri", g.dirichlet(np.ones(3), R), wp[j]) - o
    d[:R // 10] = g.standard_normal((R // 10, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v3 = lambda a: V3(*(torch.tensor(  # noqa: E731
        np.ascontiguousarray(a[:, i], np.float32), device=dev)
        for i in range(3)))
    return v3(o), v3(d), torch.tensor(g.random(R) < 0.7, device=dev)


@pytest.mark.parametrize("T,R", [(7, 2048), (300, 4099), (2000, 1 << 16)])
def test_tri_sweep_kernel_matches_plain_bit_for_bit(dev, T, R):
    """Built without contraction, K2 gives the plain version's bits."""
    tri = _tri_soup(T, seed=T)
    table16 = tri_sweep.pack_tri_table(torch.tensor(tri, device=dev), T - 1)
    o, d, alive = _tri_rays(tri, R, seed=R, dev=dev)
    before = tri_sweep.LAUNCHES
    hit = tri_sweep.intersect_tris_sweep(o, d, table16, alive)
    torch.cuda.synchronize()
    assert tri_sweep.LAUNCHES == before + 1
    t, ids, u, v = tri_sweep.tri_sweep_reference(o, d, table16)
    assert torch.equal(hit.t, torch.where(alive, t, T_MAX))
    assert torch.equal(hit.tri, torch.where(alive, ids, -1))
    assert torch.equal(hit.u, torch.where(alive, u, 0.0))
    assert torch.equal(hit.v, torch.where(alive, v, 0.0))
    assert (hit.tri >= 0).any() and (hit.tri != T // 2).all()
    assert (hit.tri < T - 1).all()   # the last row is marked invalid


def test_tri_sweep_kernel_rejects_misaligned_table(dev):
    tri = _tri_soup(8, seed=1)
    table16 = tri_sweep.pack_tri_table(torch.tensor(tri, device=dev), 8)
    shifted = torch.zeros(table16.numel() + 1, device=dev)[1:].view(8, 16)
    shifted.copy_(table16)
    o, d, alive = _tri_rays(tri, 256, seed=2, dev=dev)
    with pytest.raises(ValueError, match="aligned"):
        tri_sweep.intersect_tris_sweep(o, d, shifted, alive)


def _tri_scene(name, w, depth, batches, tmp_path):
    from raytrace_tpu_torch.tools import stress_scenes

    if name == "fixture":
        doc = stress_scenes.triangle_fixture_doc()
    else:
        obj = stress_scenes.write_sphere_obj(str(tmp_path / "sphere.obj"))
        doc = stress_scenes.tri_stress_doc(int(name[-1]), obj)
    cs = compile_scene(SceneFile.from_json_dict(doc), width=w)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=depth, sample_batches=batches))


@pytest.mark.parametrize("name", ["tri-stress-k1", "tri-stress-k4",
                                  "fixture"])
def test_triangle_fused_kernel_matches_plain_bit_for_bit(dev, name, tmp_path):
    r = Renderer(_tri_scene(name, 96, 8, 2, tmp_path), device=dev)
    assert r.path == "fused"
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 2)
    before = megakernel.LAUNCHES, megakernel.TRI_LAUNCHES
    sums, traced = megakernel.render_tile_mega(*args, use_dof=r.use_dof)
    again, traced2 = megakernel.render_tile_mega(*args, use_dof=r.use_dof)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.TRI_LAUNCHES) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(sums, again) and torch.equal(traced, traced2)
    ref, ref_traced = megakernel.megakernel_reference(*args,
                                                      use_dof=r.use_dof)
    assert torch.isfinite(sums).all()
    assert torch.equal(sums, ref) and torch.equal(traced, ref_traced)


def test_renderer_takes_the_triangle_kernel_on_the_card(dev, tmp_path):
    cs = _tri_scene("tri-stress-k1", 96, 8, 1, tmp_path)
    before = (megakernel.TRI_LAUNCHES, tri_sweep.LAUNCHES,
              sphere_sweep.LAUNCHES)
    r = Renderer(cs, device=dev)
    img = r.render_all()
    assert r.path == "fused"
    assert (megakernel.TRI_LAUNCHES, tri_sweep.LAUNCHES,
            sphere_sweep.LAUNCHES) == (before[0] + 1, before[1], before[2])
    w = Renderer(cs, device=dev, use_megakernel=False)
    w_img = w.render_all()
    assert tri_sweep.LAUNCHES > before[1] and sphere_sweep.LAUNCHES > before[2]
    np.testing.assert_allclose(img.mean(axis=(0, 1)), w_img.mean(axis=(0, 1)),
                               atol=2e-3)
    assert abs(r.stats.rays_traced - w.stats.rays_traced) <= (
        0.005 * w.stats.rays_traced)


# ---- lights: the fused kernel's lit forms -----------------------------------

def _lit_scene(name, w, depth, batches, spp):
    from raytrace_tpu_torch.tools import light_scenes

    doc = {"cornell-style": light_scenes.cornell_doc,
           "sphere-light-962": light_scenes.sphere_light_doc,
           "lit-spheres": light_scenes.lit_spheres_doc,
           "70-instances": light_scenes.many_instances_doc}[name]()
    cs = compile_scene(SceneFile.from_json_dict(doc), width=w)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=depth, sample_batches=batches,
        samples_per_pixel=spp))


@pytest.mark.parametrize("name", ["cornell-style", "sphere-light-962",
                                  "lit-spheres", "70-instances"])
def test_lit_fused_kernel_matches_plain_bit_for_bit(dev, name):
    r = Renderer(_lit_scene(name, 48, 50, 2, 16), device=dev)
    assert r.path == "fused" and r.static.has_lights
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 2)
    before = (megakernel.LAUNCHES, megakernel.LIGHT_LAUNCHES,
              megakernel.TRI_LAUNCHES)
    sums, traced = megakernel.render_tile_mega(*args, use_dof=r.use_dof)
    again, traced2 = megakernel.render_tile_mega(*args, use_dof=r.use_dof)
    torch.cuda.synchronize()
    tris = 2 if r.static.has_tris else 0
    assert (megakernel.LAUNCHES, megakernel.LIGHT_LAUNCHES,
            megakernel.TRI_LAUNCHES) == (before[0] + 2, before[1] + 2,
                                         before[2] + tris)
    assert torch.equal(sums, again) and torch.equal(traced, traced2)
    ref, ref_traced = megakernel.megakernel_reference(*args,
                                                      use_dof=r.use_dof)
    assert torch.isfinite(sums).all() and float(sums.max()) > 0.0
    assert torch.equal(sums, ref) and torch.equal(traced, ref_traced)


def test_renderer_takes_the_lit_kernel_on_the_card(dev):
    cs = _lit_scene("cornell-style", 32, 8, 2, 4)
    before = (megakernel.LIGHT_LAUNCHES, tri_sweep.LAUNCHES,
              sphere_sweep.LAUNCHES)
    r = Renderer(cs, device=dev)
    img = r.render_all()
    assert r.path == "fused"
    assert (megakernel.LIGHT_LAUNCHES, tri_sweep.LAUNCHES,
            sphere_sweep.LAUNCHES) == (before[0] + 1, before[1], before[2])
    w = Renderer(cs, device=dev, use_megakernel=False)
    w_img = w.render_all()
    assert tri_sweep.LAUNCHES > before[1]
    np.testing.assert_allclose(img.mean(axis=(0, 1)), w_img.mean(axis=(0, 1)),
                               atol=2e-3)
    assert abs(r.stats.rays_traced - w.stats.rays_traced) <= (
        0.005 * w.stats.rays_traced)


def test_lit_scene_with_motion_launches_once_per_batch_on_the_card(dev):
    from raytrace_tpu_torch.tools import light_scenes

    doc = light_scenes.cornell_doc()
    box = next(i for i in doc["instances"] if i["name"] == "short_box")
    box["transform"] = {"animated": [{"translate": [130, 0, 65]},
                                     {"translate": [160, 0, 65]}]}
    cs = compile_scene(SceneFile.from_json_dict(doc), width=32)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=4, sample_batches=3, samples_per_pixel=1))
    before = (megakernel.LIGHT_LAUNCHES, megakernel.ANIM_LAUNCHES)
    r = Renderer(cs, device=dev)
    assert r.path == "fused_per_batch" and r.render_batches(3) == 3
    assert (megakernel.LIGHT_LAUNCHES, megakernel.ANIM_LAUNCHES) == (
        before[0] + 3, before[1])


# ---- big meshes: the paged triangle sweep K3 --------------------------------

def _paged_soup(T, g, c, seed, dev):
    """_tri_soup's triangles in the paged sweep's order, their page tables
    and their dense table."""
    tri = _tri_soup(T, seed)
    tri = tri[paged_tri.paged_tri_order(tri, T)]
    wp = torch.tensor(tri, device=dev)
    return (tri, paged_tri.build_page_tables(wp, T, g=g, c=c),
            tri_sweep.pack_tri_table(wp, T))


@pytest.mark.parametrize("T,g,c,R", [(5, 8, 16, 2048), (300, 16, 4, 4099),
                                     (3001, 8, 16, 1 << 14),
                                     (40000, 128, 128, 1 << 16)])
def test_paged_kernel_matches_plain_and_k2_bit_for_bit(dev, T, g, c, R):
    """Built without contraction, K3 gives its plain version's bits and the
    dense sweep's, over several pages with a partial last one."""
    tri, tables, table16 = _paged_soup(T, g, c, T, dev)
    o, d, alive = _tri_rays(tri, R, seed=R, dev=dev)
    before = paged_tri.LAUNCHES
    hit = paged_tri.intersect_tris_paged(o, d, tables, alive)
    torch.cuda.synchronize()
    assert paged_tri.LAUNCHES == before + 1
    ref = paged_tri.paged_tri_sweep_reference(o, d, tables, alive)
    dense = tri_sweep.intersect_tris_sweep(o, d, table16, alive)
    for a, b in ((hit, ref), (hit, dense)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert torch.equal(a[2][alive], b[2][alive])
        assert torch.equal(a[3][alive], b[3][alive])
    assert (hit.tri[~alive] == -1).all() and (hit.t[~alive] == T_MAX).all()
    assert (hit.tri >= 0).any() and (hit.tri < T).all()


def test_paged_kernel_is_deterministic(dev):
    tri, tables, _ = _paged_soup(20000, 128, 128, 3, dev)
    o, d, alive = _tri_rays(tri, 1 << 16, seed=4, dev=dev)
    a = paged_tri.intersect_tris_paged(o, d, tables, alive)
    b = paged_tri.intersect_tris_paged(o, d, tables, alive)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_paged_kernel_rejects_bad_inputs(dev):
    tri, tables, _ = _paged_soup(300, 8, 16, 5, dev)
    o, d, alive = _tri_rays(tri, 256, seed=6, dev=dev)
    shifted = torch.zeros(tables.boxes.numel() + 1, device=dev)[1:].view(
        tables.boxes.shape)
    shifted.copy_(tables.boxes)
    with pytest.raises(ValueError, match="aligned"):
        paged_tri.intersect_tris_paged(o, d, tables._replace(boxes=shifted),
                                       alive)
    with pytest.raises(ValueError, match="device"):
        paged_tri.intersect_tris_paged(
            o, d, tables._replace(boxes=tables.boxes.cpu()), alive)
    with pytest.raises(ValueError, match="active"):
        paged_tri.intersect_tris_paged(o, d, tables, alive.cpu())


def test_renderer_takes_the_paged_sweep_on_the_card(dev):
    """A 16,392-triangle box grid: the paged wavefront on the card (K3, not
    K2 or K4), the same bytes as the dense sweep on its soup, and the CPU's
    render within the card-vs-CPU limits (means 1e-2, rays 2%)."""
    from raytrace_tpu_torch.engine.renderer import paged_soup
    from raytrace_tpu_torch.tools import stress_scenes

    cs = compile_scene(SceneFile.from_json_dict(
        stress_scenes.box_grid_doc(moving=False)), width=96)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=8, sample_batches=1))
    before = (paged_tri.LAUNCHES, tri_sweep.LAUNCHES, megakernel.LAUNCHES)
    r = Renderer(cs, device=dev)
    img = r.render_all()
    assert r.path == "wavefront" and r.static.bvh_mode == "paged"
    assert paged_tri.LAUNCHES > before[0]
    assert (tri_sweep.LAUNCHES, megakernel.LAUNCHES) == before[1:]
    dense = Renderer(paged_soup(cs), device=dev, use_bvh=False)
    assert dense.render_all().tobytes() == img.tobytes()
    assert dense.stats.rays_traced == r.stats.rays_traced
    cpu = Renderer(cs, device="cpu")
    c_img = cpu.render_all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), c_img.mean(axis=(0, 1)),
                               atol=1e-2)
    assert abs(r.stats.rays_traced - cpu.stats.rays_traced) <= (
        0.02 * cpu.stats.rays_traced)


# ---- noise textures: the fused kernel's noise forms -------------------------

def _noise_form_scene(form, w=48):
    from raytrace_tpu_torch.tools import noise_scenes

    with open(os.path.join(os.path.dirname(cli.DEFAULT_SCENE),
                           "final-one-weekend-motion-blur.json")) as f:
        doc, _, depth = noise_scenes.form_checks(json.load(f))[form]
    cs = compile_scene(SceneFile.from_json_dict(doc), width=w)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=depth, sample_batches=2))


@pytest.mark.parametrize("form", ["static", "anim", "tris", "lights",
                                  "tris+lights"])
def test_noise_fused_kernel_matches_plain_bit_for_bit(dev, form):
    r = Renderer(_noise_form_scene(form), device=dev)
    assert r.use_megakernel and r.static.flags.has_noise
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 2)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    before = megakernel.LAUNCHES, megakernel.NOISE_LAUNCHES
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    again, traced2 = megakernel.render_tile_mega(*args, **kw)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.NOISE_LAUNCHES) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(sums, again) and torch.equal(traced, traced2)
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    assert torch.isfinite(sums).all() and float(sums.max()) > 0.0
    assert torch.equal(sums, ref) and torch.equal(traced, ref_traced)


def test_renderer_takes_the_noise_kernel_on_the_card(dev):
    from raytrace_tpu_torch.tools import noise_scenes

    cs = compile_scene(SceneFile.from_json_dict(
        noise_scenes.perlin_spheres_doc()), width=64)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=8))
    before = (megakernel.NOISE_LAUNCHES, sphere_sweep.LAUNCHES)
    r = Renderer(cs, device=dev)
    img = r.render_all()
    assert r.path == "fused"
    assert (megakernel.NOISE_LAUNCHES, sphere_sweep.LAUNCHES) == (
        before[0] + 1, before[1])
    w = Renderer(cs, device=dev, use_megakernel=False)
    w_img = w.render_all()
    assert sphere_sweep.LAUNCHES > before[1]
    np.testing.assert_allclose(img.mean(axis=(0, 1)), w_img.mean(axis=(0, 1)),
                               atol=2e-3)
    assert abs(r.stats.rays_traced - w.stats.rays_traced) <= (
        0.005 * w.stats.rays_traced)


# ---- image textures: the fused kernel's image forms -------------------------

IMAGE_FORMS = ["static", "tris", "lights", "tris+lights", "static+noise",
               "tris+noise", "lights+noise", "tris+lights+noise"]


def _image_png(tmp_path):
    from raytrace_tpu_torch.tools import image_scenes

    return image_scenes.texel_id_png(str(tmp_path / "map.png"), 640, 320)


def _doc_cs(doc, w, depth=None, batches=None):
    cs = compile_scene(SceneFile.from_json_dict(doc), width=w)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=depth or cs.render.max_ray_depth,
        sample_batches=batches or cs.render.sample_batches))


@pytest.mark.parametrize("form", IMAGE_FORMS)
def test_image_fused_kernel_matches_plain_bit_for_bit(dev, form, tmp_path):
    from raytrace_tpu_torch.tools import image_scenes

    doc, _, depth = image_scenes.form_checks(_image_png(tmp_path))[form]
    r = Renderer(_doc_cs(doc, 48, depth, 2), device=dev)
    assert r.use_megakernel and r.static.flags.has_image
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 2)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    before = megakernel.LAUNCHES, megakernel.IMAGE_LAUNCHES
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    again, traced2 = megakernel.render_tile_mega(*args, **kw)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.IMAGE_LAUNCHES) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(sums, again) and torch.equal(traced, traced2)
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    assert torch.isfinite(sums).all() and float(sums.max()) > 0.0
    assert torch.equal(sums, ref) and torch.equal(traced, ref_traced)


def test_image_kernel_needs_the_packed_atlas(dev, tmp_path):
    from raytrace_tpu_torch.tools import image_scenes

    r = Renderer(_doc_cs(image_scenes.earth_doc(_image_png(tmp_path)), 16, 4,
                         1), device=dev)
    geom = r._geometry(0)._replace(atlas_words=None)
    with pytest.raises(ValueError, match="atlas_words"):
        megakernel.render_tile_mega(r.static, r.scene, geom, r.camera, 0, 1,
                                    use_dof=r.use_dof)


def test_renderer_takes_the_image_kernel_on_the_card(dev, tmp_path):
    from raytrace_tpu_torch.tools import image_scenes

    cs = _doc_cs(image_scenes.earth_doc(_image_png(tmp_path)), 64, 8, 2)
    before = (megakernel.IMAGE_LAUNCHES, sphere_sweep.LAUNCHES)
    r = Renderer(cs, device=dev)
    img = r.render_all()
    assert r.path == "fused"
    assert (megakernel.IMAGE_LAUNCHES, sphere_sweep.LAUNCHES) == (
        before[0] + 1, before[1])
    w = Renderer(cs, device=dev, use_megakernel=False)
    w_img = w.render_all()
    assert sphere_sweep.LAUNCHES > before[1]
    np.testing.assert_allclose(img.mean(axis=(0, 1)), w_img.mean(axis=(0, 1)),
                               atol=2e-3)
    assert abs(r.stats.rays_traced - w.stats.rays_traced) <= (
        0.005 * w.stats.rays_traced)


def test_moving_image_scene_launches_once_per_batch_on_the_card(dev,
                                                                tmp_path):
    from raytrace_tpu_torch.tools import image_scenes

    cs = _doc_cs(image_scenes.earth_motion_blur_doc(_image_png(tmp_path)),
                 32, 8, 3)
    before = (megakernel.IMAGE_LAUNCHES, megakernel.ANIM_LAUNCHES)
    r = Renderer(cs, device=dev)
    img = r.render_all()
    assert r.path == "fused_per_batch"
    assert (megakernel.IMAGE_LAUNCHES, megakernel.ANIM_LAUNCHES) == (
        before[0] + 3, before[1])
    c = Renderer(cs, device="cpu", use_megakernel=True)
    np.testing.assert_allclose(img.mean(axis=(0, 1)),
                               c.render_all().mean(axis=(0, 1)), atol=1e-2)


# ---- spheres in clusters: the fused kernel's clustered sphere sweep ---------

CLUSTER_FORMS = ["static", "anim", "tris", "lights", "tris+lights",
                 "static+noise", "anim+noise", "tris+noise", "lights+noise",
                 "tris+lights+noise", "static+image", "tris+image",
                 "lights+image", "tris+lights+image", "static+noise+image",
                 "tris+noise+image", "lights+noise+image",
                 "tris+lights+noise+image"]


def _cluster_form_args(form, tmp_path, dev, w=48):
    from raytrace_tpu_torch.tools import stress_scenes

    doc, _, depth = stress_scenes.cluster_form_checks(
        _image_png(tmp_path))[form]
    r = Renderer(_doc_cs(doc, w, depth, 2), device=dev)
    assert r.use_megakernel and r._geometry(0).sph_boxes is not None
    return (r.static, r.scene, r._geometry(0), r.camera, 0, 2), dict(
        use_dof=r.use_dof, times=r.batch_times_dev)


@pytest.mark.parametrize("form", CLUSTER_FORMS)
def test_sphere_cluster_kernel_matches_plain_bit_for_bit(dev, form, tmp_path):
    args, kw = _cluster_form_args(form, tmp_path, dev)
    before = megakernel.LAUNCHES, megakernel.SPHERE_CLUSTER_LAUNCHES
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    again, traced2 = megakernel.render_tile_mega(*args, **kw)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.SPHERE_CLUSTER_LAUNCHES) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(sums, again) and torch.equal(traced, traced2)
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    assert torch.isfinite(sums).all() and float(sums.max()) > 0.0
    assert torch.equal(sums, ref) and torch.equal(traced, ref_traced)


@pytest.mark.parametrize("form", CLUSTER_FORMS)
def test_dense_kernel_matches_plain_on_the_cluster_docs(dev, form, tmp_path):
    """The dense form of each clustered one, on the same doc with the
    cluster layout dropped: bit for bit with the plain version, two
    launches byte-identical, no clustered launch."""
    args, kw = _cluster_form_args(form, tmp_path, dev)
    args = _with_layout(args, "dense")
    before = megakernel.LAUNCHES, megakernel.SPHERE_CLUSTER_LAUNCHES
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    again, traced2 = megakernel.render_tile_mega(*args, **kw)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.SPHERE_CLUSTER_LAUNCHES) == (
        before[0] + 2, before[1])
    assert torch.equal(sums, again) and torch.equal(traced, traced2)
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    assert torch.isfinite(sums).all() and float(sums.max()) > 0.0
    assert torch.equal(sums, ref) and torch.equal(traced, ref_traced)


def test_sphere_cluster_kernel_needs_the_boxes(dev, tmp_path):
    args, kw = _cluster_form_args("static", tmp_path, dev, 16)
    geom = args[2]._replace(sph_boxes=None)
    with pytest.raises(ValueError, match="sph_boxes"):
        megakernel.render_tile_mega(*args[:2], geom, *args[3:], **kw)


def test_renderer_takes_the_clustered_kernel_on_the_card(dev):
    from raytrace_tpu_torch.tools import stress_scenes

    cs = _doc_cs(stress_scenes.sphere_stress_doc(2), 64, 8, 2)
    before = (megakernel.SPHERE_CLUSTER_LAUNCHES, sphere_sweep.LAUNCHES)
    r = Renderer(cs, device=dev)
    img = r.render_all()
    assert r.path == "fused" and r.static.num_spheres == 1940
    assert (megakernel.SPHERE_CLUSTER_LAUNCHES, sphere_sweep.LAUNCHES) == (
        before[0] + 1, before[1])
    w = Renderer(cs, device=dev, use_megakernel=False)
    w_img = w.render_all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), w_img.mean(axis=(0, 1)),
                               atol=2e-3)
    assert abs(r.stats.rays_traced - w.stats.rays_traced) <= (
        0.005 * w.stats.rays_traced)
