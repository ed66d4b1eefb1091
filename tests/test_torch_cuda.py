"""Card-only tests of the port: the CUDA kernels against their plain
PyTorch versions on the same tensors, and both render paths on the card.
No JAX here, so they also run on a GPU machine without it
(tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test skips with a reason where torch.cuda.is_available() is false.
Sphere sweep K1 (built without contraction since it shares K4's sphere
test, csrc/sphere_tree.cuh): the prefix and the sphere tree's walk, and
its dense entry point, bit for bit with the plain version, on random,
far and grazing rays and on a tree deeper than K4's stack (more than
131,072 spheres), two launches byte-identical; the older agreement check
(ids, and ids with t within rtol=1e-3, atol=1e-3, each on >= 99.9% of
rays) kept beside it.  Triangle sweep K2's walk of the soup's tree: bit
for bit with its dense entry point and the plain version, on a
use_bvh=False soup above 8,192 triangles too.  Fused bounce kernel (built
without contraction): traced rays within 0.5%, per-sample channel means
within 1e-3, at most 5% of pixels with a max-channel difference above
1e-4; on small scenes every pixel's bounce count equal.  Its animated
form (motion blur): the same, and every pixel's bounce count equal.
Triangle sweep K2 and the fused kernel's triangle form (both built without
contraction): bit for bit with their plain versions; the triangle form
against the wavefront with K2: channel means within 2e-3, rays within 0.5%.
The triangle forms' tree walk (csrc/tri_tree.cuh, shared with K3): each of
the sixteen triangle forms bit for bit on the small docs of
tools/stress_scenes.cluster_form_checks, dense and clustered; equal-t ties
between duplicated shapes under other materials, in one leaf, in the
Morton tree and in a tree over a random permutation; grazing rays from
1,500 units; a moving triangle scene re-fitting its tree once a batch; a
tree that does not match its soup refused.
The fused kernel's lit forms (lights, with and without triangles): bit for
bit with their plain versions on the four lit docs of
tools/light_scenes.py at depth 50; the Renderer's fused path against the
wavefront: channel means within 2e-3, rays within 0.5%.  The paged
triangle sweep K3 (built without contraction; a walk of a tree over the
soup): bit for bit with its plain version and with K2 over the same soup,
on far grazing rays with K2 on every ray whose K2 hit lies within the
rounding margin of its triangle; a moving mesh's tree re-fitted per batch; the Renderer's paged wavefront on
the card byte-identical with its dense sweep, and within the card-vs-CPU
limits (means 1e-2, rays 2%) of the CPU's render.  The fused kernel's
noise forms (each of its five forms with noise textures): bit for bit
with their plain versions on the small docs of
tools/noise_scenes.form_checks, and at 97 wide (a partial last warp) at
depths 1 and 50; the measuring build's turbulences, one for each noise
hit; the Renderer's fused path on
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
with the cluster layout dropped, each at the doc's depth and, for the
loop of steps' termination, at max_depth 1, 2 and 50 over batches 1-2
with the samples numbered from 2; no bounce at max_depth <= 0; the
measuring build's sums byte-identical with the normal build's on every
form, its busy lanes adding up to the bounces traced; the Renderer's
fused path on stress-4x against its wavefront: channel means within 2e-3, rays within 0.5%.  The
final-one-weekend and motion-blur checks above run both the clustered
form (the scenes' layout) and the dense one (layout dropped).  The dev
probes (raytrace_tpu_torch/tools_dev/, built without contraction): P1's
ten probe kernels bit for bit with their plain versions (sin+cos and
pow-exp-log within 2^-22), P2 within 2 ulps at (8, 128) and 2^24 points
and byte for byte with its check-only kernel there, at lengths 1, 7, 8,
1,025 and 2^24 + 3 from an aligned and a misaligned start and on wide
inputs, the C launcher's split the Python ``plan``, P3's three variants bit for bit at 4 iterations at both shapes, two
launches byte-identical, and byte for byte with its sequential entry
point at 20,000 iterations at shape (a) (the split kernel) and at 1 and
16 at shape (b); each module's main runs on the card.  The BVH walk H1
(use_bvh=True, built without contraction): bit for bit with its plain
version and with K2's dense entry point over the SAH and the implicit
tree of a static and a moving box grid, and over a one-leaf tree, two
launches byte-identical; a tree deeper than its stack refused; the SAH
Renderer byte-identical with use_bvh=False on its soup and within the
card-vs-CPU limits.  The object-space sphere sweep H2 (built without
contraction): bit for bit with its plain version on the ellipsoid
fixture (static and moving) and fow-ellipsoids, two launches
byte-identical; the ellipsoid Renderer on the card within the
card-vs-CPU limits.  The fused kernel's row and sample ranges (the
sharded renderer's launch): bit for bit with the plain version at
row_base > 0, rows past the frame, a range wholly past it (no launch,
zero outputs) and spp_local < spp, on a static, an
animated and a lit, textured triangle form, each range's rows the full
frame's where it takes every sample; the sharded renderer with one rank
on the card byte-identical with the Renderer, stepped and in a chunk.
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
from raytrace_tpu_torch.tools_dev import _common
from raytrace_tpu_torch.tools_dev import micro_raygen as mr
from raytrace_tpu_torch.tools_dev import probe_ops, probe_trig

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


def _sphere_tree(t8, n_prefix, n_sph):
    """K1's tree over the spheres past ``n_prefix`` (None where the walk
    does not pay: ops/sphere_sweep.SPHERE_FLAT_MAX)."""
    from raytrace_tpu_torch.ops import sphere_tree

    if n_sph - n_prefix <= sphere_sweep.SPHERE_FLAT_MAX:
        return None
    ids = torch.tensor(sphere_tree.sphere_order(
        t8[:, 0:3].cpu().numpy(), n_prefix, n_sph), dtype=torch.int32,
        device=t8.device)
    return sphere_tree.build_sphere_tree(t8, n_prefix, n_sph, ids)


def _assert_k1_is_plain(o, d, t8, alive, tree):
    """K1 (prefix and walk), its dense entry point and the plain version
    give the same bits; a second launch the same bytes.  Returns K1's
    hit."""
    before = sphere_sweep.LAUNCHES
    hit = sphere_sweep.intersect_spheres_sweep(o, d, t8, alive, tree)
    again = sphere_sweep.intersect_spheres_sweep(o, d, t8, alive, tree)
    dense = sphere_sweep.intersect_spheres_dense(o, d, t8, alive)
    torch.cuda.synchronize()
    assert sphere_sweep.LAUNCHES == before + 2   # the dense entry uncounted
    t_ref, id_ref = _plain(o, d, t8, alive)
    for other in (again, dense):
        assert torch.equal(hit.t, other.t) and torch.equal(hit.sph, other.sph)
    assert torch.equal(hit.t, t_ref) and torch.equal(hit.sph, id_ref)
    return hit


@pytest.mark.parametrize("S,R", [(3, 2048), (37, 4099), (488, 1 << 16),
                                 (1000, 2048)])
def test_kernel_matches_plain(dev, S, R):
    o, d, t8, alive = _inputs(S, R, seed=S, dev=dev)
    tree = _sphere_tree(t8, 1, S)
    assert (tree is None) == (S - 1 <= sphere_sweep.SPHERE_FLAT_MAX)
    hit = _assert_k1_is_plain(o, d, t8, alive, tree)
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


@pytest.mark.parametrize("S,prefix", [(3000, 1), (140000, 1), (5000, 0)])
def test_sphere_walk_on_random_far_and_grazing_rays(dev, S, prefix):
    """K1's walk bit for bit with its dense entry point and the plain
    version on random rays, rays from 1,000-2,000 units away and far rays
    grazing the spheres' boxes; 140,000 spheres make a tree of depth 15,
    deeper than K4's stack of 14."""
    from raytrace_tpu_torch.ops import sphere_tree
    from raytrace_tpu_torch.tools import smoke_lib

    o, d, t8, alive = _inputs(S, 1 << 14, seed=S, dev=dev)
    if prefix == 0:
        t8[0, 3] = 0.5   # the ground shrinks to one of the small spheres
        t8[0, 4] = (t8[0, 0:3] ** 2).sum() - 0.25
    tree = _sphere_tree(t8, prefix, S)
    assert (tree.depth > sphere_tree.MAX_SPHERE_DEPTH) == (S == 140000)
    if S == 140000:
        assert tree.depth == 15
    assert (_assert_k1_is_plain(o, d, t8, alive, tree).sph >= 0).any()
    tab = t8[prefix:S].cpu().numpy()
    boxes = np.concatenate([tab[:, 0:3] - np.abs(tab[:, 3:4]),
                            tab[:, 0:3] + np.abs(tab[:, 3:4])], axis=1)
    ones = torch.ones(1 << 14, dtype=torch.bool, device=dev)
    for seed, jitter in ((1, 1e-5), (2, 1e-2)):
        go, gd = smoke_lib.grazing_rays(boxes, 1 << 14, seed, dev, jitter)
        hit = _assert_k1_is_plain(go, gd, t8, ones, tree)
        assert (hit.sph >= 0).any()


def test_tri_walk_on_a_deep_unpaged_soup(dev, tmp_path):
    """use_bvh=False sends a soup of any size to K2: 20,000 triangles in
    leaves of 2 make a tree of depth 14, deeper than K4's triangle stack
    (13).  Bit for bit with the dense entry point and the plain version,
    on random rays and far grazing rays, two launches byte-identical; and
    the Renderer takes K2 on that soup."""
    from raytrace_tpu_torch.tools import smoke_lib, stress_scenes

    T = 20000
    tri = _tri_soup(T, seed=5)
    wp = torch.tensor(tri, device=dev)
    table16 = tri_sweep.pack_tri_table(wp, T)
    tree = _soup_tree(wp, T, table16)
    assert tree.depth == 14 > megakernel.MAX_TRI_DEPTH
    o, d, alive = _tri_rays(tri, 1 << 15, seed=6, dev=dev)
    assert (_assert_k2_is_plain(o, d, table16, alive, tree).tri >= 0).any()
    mn, mx = tri.min(1), tri.max(1)
    go, gd = smoke_lib.grazing_rays(np.concatenate([mn, mx], 1), 1 << 15, 7,
                                    dev)
    _assert_k2_is_plain(go, gd, table16,
                        torch.ones(1 << 15, dtype=torch.bool, device=dev),
                        tree)
    cs = _doc_cs(stress_scenes.box_grid_doc(2000), 64, depth=4, batches=1)
    r = Renderer(cs, device=dev, use_megakernel=False, use_bvh=False)
    assert r.static.bvh_mode == "none" and r.static.num_triangles > 8192
    before = tri_sweep.LAUNCHES
    assert np.isfinite(r.render_all()).all()
    assert tri_sweep.LAUNCHES > before


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


def _soup_tree(wp, n, table16):
    """K2's tree over the first ``n`` triangles of the [T, 3, 3] world
    soup (ops/paged_tri.build_soup_tree, as the wavefront builds it)."""
    return paged_tri.build_soup_tree(wp, n, megakernel.tri_table12(table16),
                                     paged_tri.soup_order(wp, n))


def _assert_k2_is_plain(o, d, table16, alive, tree):
    """K2's walk, twice, its dense entry point and the plain version give
    the same bits.  Returns K2's hit."""
    hit = tri_sweep.intersect_tris_sweep(o, d, table16, alive, tree)
    again = tri_sweep.intersect_tris_sweep(o, d, table16, alive, tree)
    dense = tri_sweep.intersect_tris_dense(o, d, table16, alive)
    torch.cuda.synchronize()
    t, ids, u, v = tri_sweep.tri_sweep_reference(o, d, table16)
    plain = (torch.where(alive, t, T_MAX), torch.where(alive, ids, -1),
             torch.where(alive, u, 0.0), torch.where(alive, v, 0.0))
    for other in (again, dense, plain):
        assert all(torch.equal(a, b) for a, b in zip(hit, other))
    return hit


@pytest.mark.parametrize("T,R", [(7, 2048), (300, 4099), (2000, 1 << 16)])
def test_tri_sweep_kernel_matches_plain_bit_for_bit(dev, T, R):
    """Built without contraction, K2 gives the plain version's bits."""
    tri = _tri_soup(T, seed=T)
    table16 = tri_sweep.pack_tri_table(torch.tensor(tri, device=dev), T - 1)
    o, d, alive = _tri_rays(tri, R, seed=R, dev=dev)
    before = tri_sweep.LAUNCHES
    tree = _soup_tree(torch.tensor(tri, device=dev), T - 1, table16)
    hit = _assert_k2_is_plain(o, d, table16, alive, tree)
    assert tri_sweep.LAUNCHES == before + 2
    assert (hit.tri >= 0).any() and (hit.tri != T // 2).all()
    assert (hit.tri < T - 1).all()   # the last row is marked invalid


def test_tri_sweep_kernel_rejects_misaligned_table(dev):
    tri = _tri_soup(8, seed=1)
    table16 = tri_sweep.pack_tri_table(torch.tensor(tri, device=dev), 8)
    shifted = torch.zeros(table16.numel() + 1, device=dev)[1:].view(8, 16)
    shifted.copy_(table16)
    o, d, alive = _tri_rays(tri, 256, seed=2, dev=dev)
    with pytest.raises(ValueError, match="aligned"):
        tri_sweep.intersect_tris_dense(o, d, shifted, alive)
    tree = _soup_tree(torch.tensor(tri, device=dev), 8, table16)
    rows = torch.zeros(tree.tris.numel() + 1, device=dev)[1:].view(
        tree.tris.shape)
    rows.copy_(tree.tris)
    with pytest.raises(ValueError, match="aligned"):
        tri_sweep.intersect_tris_sweep(o, d, table16, alive,
                                       tree._replace(tris=rows))
    with pytest.raises(ValueError, match="tree"):
        tri_sweep.intersect_tris_sweep(o, d, table16, alive)


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


# ---- the fused kernel's triangle tree walk (csrc/tri_tree.cuh) --------------

def _tie_doc():
    """The triangle fixture with each shape given twice, the copy under
    another material: every triangle hit ties at equal t, and the lowest
    id (the first copy) must win, or the pixel takes the copy's colour."""
    from raytrace_tpu_torch.tools import stress_scenes

    doc = stress_scenes.triangle_fixture_doc()
    twins = {"floor": "wall", "wall": "floor", "box": "glass",
             "prism": "steel"}
    for prim in list(doc["primitives"]):
        (kind, body), = prim.items()
        doc["primitives"].append({kind: dict(body, name=body["name"] + "2",
                                             material=twins[body["name"]])})
        doc["instances"].append({"name": body["name"] + "2"})
    return doc


def _hold_k4(args, kw):
    """K4 on ``args`` bit for bit with the plain version, two launches
    byte-identical, one triangle launch each."""
    before = megakernel.TRI_LAUNCHES
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    again, traced2 = megakernel.render_tile_mega(*args, **kw)
    torch.cuda.synchronize()
    assert megakernel.TRI_LAUNCHES == before + 2
    assert torch.equal(sums, again) and torch.equal(traced, traced2)
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    assert torch.isfinite(sums).all() and float(sums.max()) > 0.0
    assert torch.equal(sums, ref) and torch.equal(traced, ref_traced)


TRI_FORMS = ["tris", "tris+lights", "tris+noise", "tris+lights+noise",
             "tris+image", "tris+lights+image", "tris+noise+image",
             "tris+lights+noise+image"]


@pytest.mark.parametrize("layout", ["clusters", "dense"])
@pytest.mark.parametrize("form", TRI_FORMS)
def test_triangle_forms_walk_the_tree_bit_for_bit(dev, form, layout,
                                                  tmp_path):
    """Each triangle form, dense and clustered: the geometry carries the
    soup's tree with its id table (no cluster boxes), and the kernel walks
    it bit for bit with the plain version's dense sweep; a one-leaf soup
    also through a tree of one triangle a leaf."""
    args, kw = _cluster_form_args(form, tmp_path, dev)
    geom = args[2]
    tree = geom.tri_tree
    assert tree.ids is not None and tree.ids.is_cuda
    assert "tri_boxes" not in geom._fields
    _hold_k4(_with_layout(args, layout), kw)
    # A soup small enough to be one leaf walks a tree of one triangle a
    # leaf too.
    n = args[0].num_triangles
    if tree.depth == 0 and n > 1:
        deep = paged_tri.build_soup_tree(geom.world_p, n, geom.tri_table12,
                                         tree.ids, 1)
        args = args[:2] + (geom._replace(tri_tree=deep),) + args[3:]
        _hold_k4(_with_layout(args, layout), kw)


@pytest.mark.parametrize("order", ["one leaf", "morton", "random"])
def test_triangle_kernel_on_equal_t_ties(dev, order):
    """Every shape twice under another material: the lowest id wins each
    tie in the Renderer's tree (this small soup is one leaf), in a tree of
    leaves of SOUP_LEAF in Morton order (twins side by side) and over a
    random permutation (twins in any leaves, the lower id not first)."""
    r = Renderer(_doc_cs(_tie_doc(), 48, 8, 2), device=dev)
    assert r.path == "fused"
    geom = r._geometry(0)
    n = r.static.num_triangles
    ids = geom.tri_tree.ids
    if order == "random":
        ids = torch.tensor(np.random.default_rng(1).permutation(n),
                           dtype=torch.int32, device=dev)
    if order != "one leaf":
        geom = geom._replace(tri_tree=paged_tri.build_soup_tree(
            geom.world_p, n, geom.tri_table12, ids, paged_tri.SOUP_LEAF))
    assert (geom.tri_tree.depth > 0) == (order != "one leaf")
    _hold_k4((r.static, r.scene, geom, r.camera, 0, 2),
             dict(use_dof=r.use_dof))


def test_triangle_kernel_on_far_grazing_rays(dev, tmp_path):
    """tri-stress k = 1 seen from 1,500 units away, low over the ground,
    through a narrow field of view: rays graze the ball's 960 triangles
    far from the origin, where the walk's boxes are widened by the ray's
    rounding margin; bit for bit."""
    from raytrace_tpu_torch.tools import stress_scenes

    obj = stress_scenes.write_sphere_obj(str(tmp_path / "sphere.obj"))
    doc = stress_scenes.tri_stress_doc(1, obj)
    doc["cameras"][0]["perspective"].update(eye=[1500.0, 1.3, 40.0],
                                            look_at=[0.0, 1.0, 0.0],
                                            fov_y=0.2)
    r = Renderer(_doc_cs(doc, 96, 8, 2), device=dev)
    assert r.path == "fused" and r._geometry(0).tri_tree.depth > 0
    _hold_k4((r.static, r.scene, r._geometry(0), r.camera, 0, 2),
             dict(use_dof=r.use_dof))


def test_moving_triangle_scene_refits_its_tree_on_the_card(dev, tmp_path):
    """tri-stress k = 1 with its ball sliding over the shutter: one order
    from the first batch time, each batch's tree a fresh build over it
    (new boxes), each batch's launch bit for bit with the plain version,
    one launch a batch through the Renderer."""
    from raytrace_tpu_torch.tools import stress_scenes

    obj = stress_scenes.write_sphere_obj(str(tmp_path / "sphere.obj"))
    doc = stress_scenes.tri_stress_doc(1, obj)
    doc["instances"][1]["transform"] = {"animated": [
        {"translate": [0.0, 1.0, 0.0]}, {"translate": [0.6, 1.0, 0.0]}]}
    r = Renderer(_doc_cs(doc, 48, 8, 3), device=dev)
    assert r.path == "fused_per_batch"
    n = r.static.num_triangles
    nodes = []
    for b in (0, 2):
        geom = r._geometry(b)
        assert torch.equal(geom.tri_tree.ids, r._tri_order)
        fresh = paged_tri.build_soup_tree(geom.world_p, n, geom.tri_table12,
                                          r._tri_order)
        assert torch.equal(geom.tri_tree.nodes, fresh.nodes)
        nodes.append(geom.tri_tree.nodes)
        _hold_k4((r.static, r.scene, geom, r.camera, b, 1),
                 dict(use_dof=r.use_dof, times=r.batch_times_dev))
    assert not torch.equal(nodes[0], nodes[1])
    before = megakernel.TRI_LAUNCHES
    assert r.render_batches(3) == 3 and megakernel.TRI_LAUNCHES == before + 3


def test_triangle_kernel_rejects_a_tree_that_does_not_match(dev, tmp_path):
    r = Renderer(_tri_scene("tri-stress-k1", 32, 4, 1, tmp_path), device=dev)
    geom = r._geometry(0)
    args = (r.static, r.scene)
    before = megakernel.LAUNCHES
    for bad, match in ((geom.tri_tree._replace(ids=None), "id table"),
                       (geom.tri_tree._replace(ids=geom.tri_tree.ids.cpu()),
                        "ids"),
                       (geom.tri_tree._replace(nodes=geom.tri_tree.nodes[1:]),
                        "nodes")):
        with pytest.raises(ValueError, match=match):
            megakernel.render_tile_mega(*args, geom._replace(tri_tree=bad),
                                        r.camera, 0, 1, use_dof=r.use_dof)
    assert megakernel.LAUNCHES == before


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

def _paged_soup(T, seed, dev, leaf=paged_tri.LEAF):
    """_tri_soup's triangles in the paged sweep's order, their tree and
    their dense table."""
    tri = _tri_soup(T, seed)
    tri = tri[paged_tri.paged_tri_order(tri, T)]
    wp = torch.tensor(tri, device=dev)
    return (tri, paged_tri.build_tri_tree(wp, T, leaf=leaf),
            tri_sweep.pack_tri_table(wp, T))


def _assert_hits_equal(a, b, alive):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[2][alive], b[2][alive])
    assert torch.equal(a[3][alive], b[3][alive])


@pytest.mark.parametrize("T,leaf,R", [(5, 4, 2048), (300, 4, 4099),
                                      (3001, 8, 1 << 14),
                                      (40000, 4, 1 << 16),
                                      (40000, 16, 1 << 16)])
def test_paged_kernel_matches_plain_and_k2_bit_for_bit(dev, T, leaf, R):
    """Built without contraction, K3's tree walk gives its plain version's
    bits and the dense sweep's, on soups whose leaf counts are not powers
    of two, with a duplicate pair (the lower id wins)."""
    tri, tree, table16 = _paged_soup(T, T, dev, leaf)
    o, d, alive = _tri_rays(tri, R, seed=R, dev=dev)
    before = paged_tri.LAUNCHES
    hit = paged_tri.intersect_tris_paged(o, d, tree, alive)
    torch.cuda.synchronize()
    assert paged_tri.LAUNCHES == before + 1
    ref = paged_tri.tri_tree_sweep_reference(o, d, tree, alive)
    dense = tri_sweep.intersect_tris_dense(o, d, table16, alive)
    for other in (ref, dense):
        _assert_hits_equal(hit, other, alive)
    assert (hit.tri[~alive] == -1).all() and (hit.t[~alive] == T_MAX).all()
    assert (hit.tri >= 0).any() and (hit.tri < T).all()


def test_paged_kernel_is_deterministic(dev):
    tri, tree, _ = _paged_soup(20000, 3, dev)
    o, d, alive = _tri_rays(tri, 1 << 16, seed=4, dev=dev)
    a = paged_tri.intersect_tris_paged(o, d, tree, alive)
    b = paged_tri.intersect_tris_paged(o, d, tree, alive)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_paged_kernel_rejects_bad_inputs(dev):
    tri, tree, _ = _paged_soup(300, 5, dev)
    o, d, alive = _tri_rays(tri, 256, seed=6, dev=dev)
    shifted = torch.zeros(tree.nodes.numel() + 1, device=dev)[1:].view(
        tree.nodes.shape)
    shifted.copy_(tree.nodes)
    with pytest.raises(ValueError, match="aligned"):
        paged_tri.intersect_tris_paged(o, d, tree._replace(nodes=shifted),
                                       alive)
    with pytest.raises(ValueError, match="device"):
        paged_tri.intersect_tris_paged(
            o, d, tree._replace(nodes=tree.nodes.cpu()), alive)
    with pytest.raises(ValueError, match="active"):
        paged_tri.intersect_tris_paged(o, d, tree, alive.cpu())
    pages = paged_tri.build_page_tables(torch.tensor(tri, device=dev), 300)
    with pytest.raises(ValueError, match="TriTree"):
        paged_tri.intersect_tris_paged(o, d, pages, alive)


def test_paged_kernel_rejects_trees_that_do_not_match(dev):
    tri, tree, _ = _paged_soup(300, 7, dev)
    o, d, alive = _tri_rays(tri, 256, seed=8, dev=dev)
    before = paged_tri.LAUNCHES
    with pytest.raises(ValueError, match="does not match"):
        paged_tri.intersect_tris_paged(o, d, tree._replace(num_tris=1200),
                                       alive)
    with pytest.raises(ValueError, match="nodes"):
        paged_tri.intersect_tris_paged(
            o, d, tree._replace(nodes=tree.nodes[:-1]), alive)
    with pytest.raises(ValueError, match="stack"):
        paged_tri.intersect_tris_paged(
            o, d, tree._replace(num_tris=1 << 28, leaf=1, depth=28), alive)
    assert paged_tri.LAUNCHES == before


def test_paged_kernel_on_equal_t_duplicates(dev):
    """Copies of one triangle in leaves far apart: the lowest id wins, as
    in the dense sweep, whatever order the walk meets them in."""
    tri = _tri_soup(4000, 9)
    tri = tri[paged_tri.paged_tri_order(tri, 4000)]
    tri[[3, 1999, 3998]] = tri[2500]
    wp = torch.tensor(tri, device=dev)
    tree = paged_tri.build_tri_tree(wp, 4000)
    o, d, alive = _tri_rays(tri, 1 << 15, seed=10, dev=dev)
    hit = paged_tri.intersect_tris_paged(o, d, tree, alive)
    dense = tri_sweep.intersect_tris_dense(
        o, d, tri_sweep.pack_tri_table(wp, 4000), alive)
    _assert_hits_equal(hit, dense, alive)
    _assert_hits_equal(hit, paged_tri.tri_tree_sweep_reference(
        o, d, tree, alive), alive)
    assert (hit.tri == 3).any() and not torch.isin(
        hit.tri, torch.tensor([1999, 2500, 3998], device=dev)).any()


def test_paged_kernel_on_far_grazing_rays(dev):
    """Rays from 1,000-2,000 units away grazing the leaf boxes of a small
    sphere tessellated (radius 0.2, 64 rings x 128 segments): bit for bit
    with the plain version on every ray, and with K2 on every ray whose
    K2 hit lies within the rounding margin of its triangle's box."""
    from raytrace_tpu_torch.models.tessellate import generate_uv_sphere
    from raytrace_tpu_torch.tools import smoke_lib

    pos, _, _, idx = generate_uv_sphere((4.0, 0.2, 1.0), 0.2, 64, 128)
    tri = pos[idx.reshape(-1, 3)].astype(np.float32)
    T = tri.shape[0]
    tri = tri[paged_tri.paged_tri_order(tri, T)]
    wp = torch.tensor(tri, device=dev)
    tree = paged_tri.build_tri_tree(wp, T)
    boxes = paged_tri.leaf_boxes(wp, T)[:-(-T // paged_tri.LEAF)]
    o, d = smoke_lib.grazing_rays(boxes.cpu().numpy(), 1 << 16, 12, dev)
    alive = torch.ones(1 << 16, dtype=torch.bool, device=dev)
    hit = paged_tri.intersect_tris_paged(o, d, tree, alive)
    _assert_hits_equal(hit, paged_tri.tri_tree_sweep_reference(
        o, d, tree, alive), alive)
    k2 = tri_sweep.intersect_tris_dense(o, d, tri_sweep.pack_tri_table(wp, T),
                                        alive)
    assert (k2.tri >= 0).double().mean() > 0.3
    for r in torch.nonzero((hit.t != k2.t) | (hit.tri != k2.tri))[:, 0].tolist():
        j = int(k2.tri[r])
        p = torch.stack([x[r].double() for x in o]) + k2.t[r].double() * \
            torch.stack([x[r].double() for x in d])
        off = float(torch.maximum(wp[j].double().amin(0) - p,
                                  p - wp[j].double().amax(0)).amax())
        o_inf = max(abs(float(x[r])) for x in o)
        reach = float(boxes[j // paged_tri.LEAF].abs().amax())
        assert off > (o_inf + reach) * paged_tri.TREE_ROUNDING


def test_moving_mesh_refits_its_tree_on_the_card(dev):
    """The moving box grid on the card: each batch's tree is a fresh build
    from that batch's world soup, the boxes move, and K3 renders it."""
    from raytrace_tpu_torch.ops import transforms
    from raytrace_tpu_torch.tools import stress_scenes

    cs = compile_scene(SceneFile.from_json_dict(
        stress_scenes.box_grid_doc(moving=True)), width=48)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=8, sample_batches=2))
    r = Renderer(cs, device=dev)
    assert r.static.bvh_mode == "paged" and r.static.any_animated
    trees = []
    for b in (0, 1):
        geom = r._geometry(b)
        mats = transforms.interpolate_instances(
            r.scene.inst_t0, r.scene.inst_t1, r.batch_times_dev[b])
        world_p, _ = transforms.transform_soup(r.scene.tri_p, r.scene.tri_n,
                                               r.scene.tri_inst, mats)
        fresh = paged_tri.build_tri_tree(world_p, r.static.num_triangles)
        assert torch.equal(geom.tri_tree.nodes, fresh.nodes)
        trees.append(geom.tri_tree.nodes)
    assert not torch.equal(trees[0], trees[1])
    before = paged_tri.LAUNCHES
    img = r.render_all()
    assert paged_tri.LAUNCHES > before and np.isfinite(img).all()


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


@pytest.mark.parametrize("depth", [1, 50])
@pytest.mark.parametrize("form", ["static", "anim", "tris", "lights",
                                  "tris+lights"])
def test_noise_forms_on_partial_warps(dev, form, depth):
    """At an odd width the frame's last warp has lanes past the image, and
    at depth 1 lanes finish while others trace: a partial warp's
    turbulences keep the plain version's bits."""
    from raytrace_tpu_torch.tools import smoke_lib

    cs = _noise_form_scene(form, smoke_lib.PARTIAL_WARP_WIDTH)
    r = Renderer(dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=depth)), device=dev)
    assert r.static.flags.has_noise
    assert (r.static.width * r.static.height) % 32 != 0
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    again, traced2 = megakernel.render_tile_mega(*args, **kw)
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sums, again) and torch.equal(traced, traced2)
    assert torch.equal(sums, ref) and torch.equal(traced, ref_traced)


@pytest.mark.parametrize("form", ["static", "tris+lights"])
def test_measuring_build_counts_the_noise_lanes(dev, form):
    """The measuring build of a noise form counts the turbulences its
    lanes take, as eval_slot takes them: some, and at most one a
    bounce."""
    r = Renderer(_noise_form_scene(form), device=dev)
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 2)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    _, traced, counts = megakernel.measure_tile_mega(*args, **kw)
    assert counts["busy"] == int(traced.sum())
    assert 0 < counts["noise_lanes"] <= counts["busy"]


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


def _cluster_form_args(form, tmp_path, dev, w=48, depth=None, batches=2):
    """The launch arguments of ``form``'s clustered doc at width ``w``
    (its depth replaced where given) for 2 batches from batch 0."""
    from raytrace_tpu_torch.tools import stress_scenes

    doc, _, doc_depth = stress_scenes.cluster_form_checks(
        _image_png(tmp_path))[form]
    r = Renderer(_doc_cs(doc, w, depth or doc_depth, batches), device=dev)
    assert r.use_megakernel and r._geometry(0).sph_tree is not None
    return (r.static, r.scene, r._geometry(0), r.camera, 0, 2), dict(
        use_dof=r.use_dof, times=r.batch_times_dev)


# The loop of steps' termination and sample numbering: the doc's depth from
# batch 0, and max_depth 1, 2 and 50 over batches 1-2 with the samples
# numbered from 2 (sample_base; the plain version numbers them the same).
LOOP_CASES = {"doc": (None, 0, 0), "depth-1": (1, 1, 2),
              "depth-2": (2, 1, 2), "depth-50": (50, 1, 2)}


def _loop_case_args(form, case, tmp_path, dev):
    depth, batch0, base = LOOP_CASES[case]
    args, kw = _cluster_form_args(form, tmp_path, dev, depth=depth,
                                  batches=batch0 + 2)
    return args[:4] + (batch0, 2, base), kw


@pytest.mark.parametrize("case", LOOP_CASES)
@pytest.mark.parametrize("form", CLUSTER_FORMS)
def test_sphere_cluster_kernel_matches_plain_bit_for_bit(dev, form, case,
                                                         tmp_path):
    args, kw = _loop_case_args(form, case, tmp_path, dev)
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


@pytest.mark.parametrize("case", LOOP_CASES)
@pytest.mark.parametrize("form", CLUSTER_FORMS)
def test_dense_kernel_matches_plain_on_the_cluster_docs(dev, form, case,
                                                        tmp_path):
    """The dense form of each clustered one, on the same doc with the
    cluster layout dropped: bit for bit with the plain version, two
    launches byte-identical, no clustered launch."""
    args, kw = _loop_case_args(form, case, tmp_path, dev)
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


@pytest.mark.parametrize("depth", [0, -1])
def test_fused_kernel_traces_nothing_without_depth(dev, depth, tmp_path):
    """max_depth <= 0: no bounce, sums and counts 0, as the plain version;
    the loop of steps must not spin."""
    args, kw = _cluster_form_args("lights", tmp_path, dev, w=16)
    args = (dataclasses.replace(args[0], max_ray_depth=depth),) + args[1:]
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    torch.cuda.synchronize()
    assert not sums.any() and not traced.any()
    assert torch.equal(sums, ref) and torch.equal(traced, ref_traced)


@pytest.mark.parametrize("layout", ["clusters", "dense"])
@pytest.mark.parametrize("form", CLUSTER_FORMS)
def test_measuring_build_gives_the_same_bytes(dev, form, layout, tmp_path):
    """K4's measuring build (csrc/megakernel.cu under K4_MEASURE): the
    normal build's sums and counts, byte for byte, not counted as a
    launch; its busy lanes add up to the bounces traced, within its lane
    slots, and every phase took cycles."""
    args, kw = _cluster_form_args(form, tmp_path, dev)
    args = _with_layout(args, layout)
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    before = megakernel.LAUNCHES
    m_sums, m_traced, counts = megakernel.measure_tile_mega(*args, **kw)
    assert megakernel.LAUNCHES == before
    assert torch.equal(sums, m_sums) and torch.equal(traced, m_traced)
    assert counts["busy"] == int(traced.sum())
    assert counts["slots"] % 32 == 0 and counts["slots"] >= counts["busy"]
    assert all(counts[k] > 0 for k in megakernel.MEASURE_PHASES)


def test_sphere_cluster_kernel_needs_the_boxes(dev, tmp_path):
    """A clustered geometry without its sphere tree is refused on the
    card, where the kernel walks it."""
    args, kw = _cluster_form_args("static", tmp_path, dev, 16)
    geom = args[2]._replace(sph_tree=None)
    with pytest.raises(ValueError, match="sph_tree"):
        megakernel.render_tile_mega(*args[:2], geom, *args[3:], **kw)


def _hold_clusters(args, kw):
    """K4 on ``args`` bit for bit with the plain version's dense sweep, two
    launches byte-identical, one clustered launch each."""
    before = megakernel.SPHERE_CLUSTER_LAUNCHES
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    again, traced2 = megakernel.render_tile_mega(*args, **kw)
    torch.cuda.synchronize()
    assert megakernel.SPHERE_CLUSTER_LAUNCHES == before + 2
    assert torch.equal(sums, again) and torch.equal(traced, traced2)
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    assert torch.isfinite(sums).all() and float(sums.max()) > 0.0
    assert torch.equal(sums, ref) and torch.equal(traced, ref_traced)


def _retree(r, geom, leaf=None, ids=None, staged=None):
    """``geom`` with its sphere tree rebuilt at another leaf size or over
    another order, or with another number of node rows staged."""
    from raytrace_tpu_torch.ops import sphere_tree

    t = geom.sph_tree
    if leaf is not None or ids is not None:
        t = sphere_tree.build_sphere_tree(
            geom.sph_table8, t.n_prefix, r.static.num_spheres,
            t.ids if ids is None else ids, dtab8=geom.sph_dtab8,
            leaf=leaf or t.leaf)
    if staged is not None:
        t = t._replace(staged=staged)
    return geom._replace(sph_tree=t)


SPHERE_TREE_VARIANTS = ["leaf 1", "leaf 2", "leaf 8", "random order",
                        "staged 0", "staged 7", "staged all"]


@pytest.mark.parametrize("variant", SPHERE_TREE_VARIANTS)
@pytest.mark.parametrize("scene", ["stress-4x", "motion-blur"])
def test_sphere_tree_variants_bit_for_bit(dev, scene, variant):
    """stress-4x (a tree of 1,023 nodes, more than the cap stages) and the
    moving motion-blur scene at 64 wide, depth 8: the tree at other leaf
    sizes, over a random order (the lower id of a tie not first), and
    with none, 7 or all of its node rows staged in shared memory (the
    staged and the __ldg parts of the walk), each bit for bit."""
    from raytrace_tpu_torch.tools import stress_scenes

    if scene == "stress-4x":
        cs = _doc_cs(stress_scenes.sphere_stress_doc(2), 64, 8, 2)
    else:
        cs = cli.load_scene(cli.DEFAULT_SCENE.replace(
            "final-one-weekend.json", "final-one-weekend-motion-blur.json"),
            64)
        cs = dataclasses.replace(cs, render=dataclasses.replace(
            cs.render, max_ray_depth=8, sample_batches=2))
    r = Renderer(cs, device=dev)
    geom = r._geometry(0)
    tree = geom.sph_tree
    kind, value = variant.split(" ", 1)
    if kind == "leaf":
        geom = _retree(r, geom, leaf=int(value))
    elif kind == "random":
        perm = np.random.default_rng(3).permutation(tree.num_spheres)
        geom = _retree(r, geom, ids=tree.ids[torch.tensor(perm, device=dev)])
    else:
        geom = _retree(r, geom, staged=(tree.nodes.shape[0] if value == "all"
                                        else int(value)))
    _hold_clusters((r.static, r.scene, geom, r.camera, 0, 2),
                   dict(use_dof=r.use_dof, times=r.batch_times_dev))


def _sphere_tie_doc():
    """final-one-weekend with each of its small spheres given twice, the
    copy under the next sphere's material: every hit on one ties at equal
    t, and the lowest id must win, or the pixel takes the copy's colour."""
    with open(cli.DEFAULT_SCENE) as f:
        doc = json.load(f)
    prims = [p for p in doc["primitives"]
             if p["uv_sphere"]["radius"] < 10]
    mats = [p["uv_sphere"]["material"] for p in prims]
    for k, prim in enumerate(prims):
        body = prim["uv_sphere"]
        doc["primitives"].append({"uv_sphere": dict(
            body, name=body["name"] + "2",
            material=mats[(k + 1) % len(mats)])})
        doc["instances"].append({"name": body["name"] + "2"})
    return doc


@pytest.mark.parametrize("order", ["morton", "random"])
def test_sphere_kernel_on_equal_t_duplicates(dev, order):
    """Every small sphere twice under another material, in the Renderer's
    tree and in one over a random order: bit for bit."""
    r = Renderer(_doc_cs(_sphere_tie_doc(), 48, 8, 2), device=dev)
    assert r.path == "fused" and r.static.num_spheres > 900
    geom = r._geometry(0)
    if order == "random":
        perm = np.random.default_rng(5).permutation(
            geom.sph_tree.num_spheres)
        geom = _retree(r, geom, ids=geom.sph_tree.ids[
            torch.tensor(perm, device=dev)])
    _hold_clusters((r.static, r.scene, geom, r.camera, 0, 2),
                   dict(use_dof=r.use_dof))


def test_sphere_kernel_on_far_grazing_rays(dev):
    """final-one-weekend seen from 1,800 units away, low over the ground,
    through a narrow field of view: rays graze its small spheres far from
    the origin, where each box is widened by the ray's rounding margin;
    bit for bit."""
    with open(cli.DEFAULT_SCENE) as f:
        doc = json.load(f)
    # The scene's ground lies at y > 0: the spheres stand at y < 0.
    doc["cameras"][0]["perspective"].update(eye=[1800.0, -0.6, 40.0],
                                            look_at=[0.0, -0.4, 0.0],
                                            fov_y=0.3, z_far=10000.0,
                                            aperture_size=0.0)
    r = Renderer(_doc_cs(doc, 96, 8, 2), device=dev)
    assert r.path == "fused"
    _hold_clusters((r.static, r.scene, r._geometry(0), r.camera, 0, 2),
                   dict(use_dof=r.use_dof))


def test_sphere_kernel_on_stress_16k_beyond_the_staging_cap(dev):
    """stress-16k at 128x72, depth 50: a tree of 2,047 nodes (leaves of
    8) of which the top 255 are staged, the walk reading the rest through
    __ldg; bit for bit."""
    from raytrace_tpu_torch.tools import stress_scenes

    doc = stress_scenes.sphere_stress_doc(*stress_scenes.SPHERE_STRESS[
        "stress-16k"])
    cs = compile_scene(SceneFile.from_json_dict(doc), width=128, height=72)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, sample_batches=1))
    r = Renderer(cs, device=dev)
    tree = r._geometry(0).sph_tree
    assert r.path == "fused" and 0 < tree.staged < tree.nodes.shape[0]
    _hold_clusters((r.static, r.scene, r._geometry(0), r.camera, 0, 1),
                   dict(use_dof=r.use_dof))


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


@pytest.mark.parametrize("name", probe_ops.PROBES)
def test_probe_ops_kernel_matches_plain(dev, name):
    x, tab = probe_ops.make_inputs(dev).args(name)
    before = probe_ops.LAUNCHES[name]
    out = probe_ops.probe(name, x, tab)
    again = probe_ops.probe(name, x, tab)
    ref = probe_ops.probe_reference(name, x, tab)
    torch.cuda.synchronize()
    assert probe_ops.LAUNCHES[name] == before + 2
    assert probe_ops.agrees(name, out, ref) and torch.equal(out, again)


def test_probe_ops_fetch_gives_nan_for_ids_out_of_range(dev):
    rows_t = torch.rand(4, 16, device=dev)
    ids = torch.tensor([[0, 15, 16, -1]], dtype=torch.int32, device=dev)
    out = probe_ops.probe("onehot-fetch", ids, rows_t)
    assert torch.equal(out[:, :2], rows_t[:, [0, 15]])
    assert torch.isnan(out[:, 2:]).all()


@pytest.mark.parametrize("size", sorted(probe_trig.SIZES))
def test_probe_trig_kernel_matches_plain(dev, size):
    x = probe_trig.points(probe_trig.SIZES[size], dev)
    before = (probe_trig.LAUNCHES, probe_trig.SCALAR_LAUNCHES)
    out = probe_trig.uv_sum(x)
    scalar = probe_trig.uv_sum(x, scalar=True)
    ref = probe_trig.uv_sum_reference(x)
    assert (probe_trig.LAUNCHES, probe_trig.SCALAR_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert probe_trig.same_bytes(out, scalar)
    assert _common.max_ulps(out, ref) <= probe_trig.ULP_TOL
    assert probe_trig.ulps_vs_float64(x, out) < 8


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 7, 8, 1025, (1 << 24) + 3])
def test_probe_trig_kernel_at_any_length_and_offset(dev, n, offset):
    # A view that starts ``offset`` floats into its storage: the kernel's
    # head runs up to the first 16-byte boundary.
    x = probe_trig.points((n + 1,), dev)[offset:offset + n]
    assert probe_trig.misalignment(x) == offset
    before = probe_trig.LAUNCHES
    out = probe_trig.uv_sum(x)
    torch.cuda.synchronize()
    assert probe_trig.LAUNCHES == before + 1
    assert out.shape == x.shape
    assert probe_trig.misalignment(out) == offset
    assert _common.max_ulps(out, probe_trig.uv_sum_reference(x)) <= (
        probe_trig.ULP_TOL)
    assert probe_trig.same_bytes(out, probe_trig.uv_sum(x, scalar=True))


def test_probe_trig_kernel_on_wide_inputs(dev):
    g = np.random.default_rng(7)
    special = [-0.0, 0.0, np.inf, -np.inf, 1e-45, -1e-45, 3e38, -3e38, 0.5,
               -0.5, 2.0, -2.0]
    x = torch.tensor(np.concatenate([special, g.uniform(-1e4, 1e4, 2045)])
                     .astype(np.float32), device=dev)[1:]
    out = probe_trig.uv_sum(x)
    assert probe_trig.same_bytes(out, probe_trig.uv_sum(x, scalar=True))
    assert _common.max_ulps(out, probe_trig.uv_sum_reference(x)) <= (
        probe_trig.ULP_TOL)


def test_probe_trig_card_plan_is_the_python_plan(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = probe_trig.card_plan(0, 0)[4]
    assert resident >= sms and resident % sms == 0
    for n in [*range(71), (1 << 24) + 3]:
        for misalign in range(4):
            assert probe_trig.card_plan(n, misalign)[:4] == probe_trig.plan(
                n, misalign, sms, resident // sms)
    # Input and output at different offsets from a 16-byte boundary: refused.
    x = probe_trig.points((64,), dev)
    out = torch.empty_like(x)
    err = probe_trig.library().probe_trig_launch(
        x[1:].data_ptr(), 63, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    assert err != 0


@pytest.mark.parametrize("shape", ["a", "b"])
@pytest.mark.parametrize("variant", mr.VARIANTS)
def test_micro_raygen_kernel_matches_plain(dev, variant, shape):
    params = mr.camera_params(dev)
    pix = mr.pixels(variant, shape, dev)
    before = mr.LAUNCHES
    chk = mr.check(params, pix, variant, mr.PROGRAMS if shape == "a" else 1)
    assert mr.LAUNCHES == before + 2
    assert chk["bitwise"] and chk["repeat_identical"], chk


@pytest.mark.parametrize("run", ["a", "b1", "b16"])
@pytest.mark.parametrize("variant", mr.VARIANTS)
def test_micro_raygen_matches_the_sequential_loop(dev, variant, run):
    """P3 byte for byte with its check-only sequential entry point at the
    timed runs' own iterations: shape (a) at the full 20,000 on the split
    kernel, shape (b) at 1 and 16 iterations one thread a cell."""
    shape = run[0]
    iters = mr.ITERS if shape == "a" else int(run[1:])
    programs = mr.PROGRAMS if shape == "a" else 1
    params = mr.camera_params(dev)
    pix = mr.pixels(variant, shape, dev)
    before = mr.LAUNCHES, mr.SPLIT_LAUNCHES
    got = mr.raygen_sums(params, pix, iters, variant, programs)
    again = mr.raygen_sums(params, pix, iters, variant, programs)
    assert (mr.LAUNCHES, mr.SPLIT_LAUNCHES) == (
        before[0] + 2, before[1] + (2 if shape == "a" else 0))
    seq = mr.raygen_sums(params, pix, iters, variant, programs,
                         sequential=True)
    torch.cuda.synchronize()
    assert mr.LAUNCHES == before[0] + 2
    assert torch.equal(got, again) and torch.equal(got, seq)
    assert torch.isfinite(got).all()


def test_probe_mains_run_on_the_card(dev, capsys, monkeypatch):
    assert all(r["ok"] for r in probe_ops.main([]).values())
    assert probe_trig.main([])["large"]["n"] == 1 << 24
    monkeypatch.setattr(mr, "ITERS", 64)
    res = mr.main([])
    assert all(r["a"]["iters"] == 64 and r["a"]["ns_per_raygen"] > 0
               and r["b1"]["plain_ms"] > 0 for r in res.values())
    out = capsys.readouterr().out
    assert out.count("PASS ") == 10 and "FAIL" not in out


# ---- the BVH walk H1 and the object-space sphere sweep H2 --------------------

def _bvh_tree(soup_cs, data, dev, wide=True):
    """The tree H1 walks (four-wide rows), or with ``wide`` False its
    binary rows, which only the plain walk takes."""
    from raytrace_tpu_torch.ops import bvh

    n = soup_cs.num_triangles
    if wide:
        rows, root, stack = bvh.wide_tree(data, n)
    else:
        (rows, root), stack = bvh.node_rows(data, n), data.depth + 2
    return bvh.BVHTree(torch.tensor(rows, device=dev), root, stack,
                       data.leaf_size, n)


def _assert_h1_is_plain(o, d, table12, tree, alive, table16, binary=None):
    """H1, twice, its plain version (and the plain walk of the ``binary``
    rows, where given) and K2's dense entry point give the same bits.
    Returns H1's hit."""
    from raytrace_tpu_torch.ops import bvh

    before = bvh.LAUNCHES
    hit = bvh.intersect_tris_bvh(o, d, table12, tree, alive)
    again = bvh.intersect_tris_bvh(o, d, table12, tree, alive)
    assert bvh.LAUNCHES == before + 2
    refs = [bvh.bvh_walk_reference(o, d, table12, tree, alive),
            tri_sweep.intersect_tris_dense(o, d, table16, alive)]
    if binary is not None:
        refs.append(bvh.bvh_walk_reference(o, d, table12, binary, alive))
    torch.cuda.synchronize()
    for a, b, *c in zip(hit, again, *refs):
        assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
        for e in c:
            assert a.cpu().numpy().tobytes() == e.cpu().numpy().tobytes()
    return hit


@pytest.mark.parametrize("mode", ["sah", "implicit"])
@pytest.mark.parametrize("moving", [False, True])
def test_bvh_walk_matches_plain(dev, mode, moving):
    """H1 over the SAH tree and the implicit one of a 5,000-instance box
    grid (static, or sliding over the shutter: its batch's world rows
    under the shutter-wide boxes), on random rays with an alive mask."""
    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.models import bvh_build
    from raytrace_tpu_torch.tools import stress_scenes

    cs = _doc_cs(stress_scenes.box_grid_doc(5000, moving), 32, 4, 2)
    data = (bvh_build.build_bvh_sah(cs) if mode == "sah"
            else bvh_build.build_bvh(cs, 4))
    assert data is not None and data.mode == mode
    soup = bvh_build.permute_soup(cs, data.order)
    r = Renderer(soup, device=dev, use_megakernel=False, use_bvh=False)
    tris = wavefront.prepare_tris(r.static, r.scene, r.batch_times_dev[1])
    n = soup.num_triangles
    wp = tris["world_p"][:n].cpu().numpy()
    o, d, alive = _tri_rays(wp, 1 << 16, seed=8, dev=dev)
    hit = _assert_h1_is_plain(o, d, tris["tri_table12"],
                              _bvh_tree(soup, data, dev), alive,
                              tris["tri_table16"],
                              _bvh_tree(soup, data, dev, wide=False))
    assert (hit.tri >= 0).sum() > 1000


def test_bvh_walk_refuses_a_deep_tree_and_walks_one_leaf(dev):
    from raytrace_tpu_torch.ops import bvh

    tri = _tri_soup(5, seed=9)
    wp = torch.tensor(tri, device=dev)
    table16 = tri_sweep.pack_tri_table(wp, 5)
    table12 = megakernel.tri_table12(table16)
    one_leaf = bvh.BVHTree(torch.zeros((1, bvh.WIDE_COLS), device=dev),
                           bvh.leaf_link(0, 5), 2, 8, 5)
    o, d, alive = _tri_rays(tri, 4096, seed=10, dev=dev)
    assert (_assert_h1_is_plain(o, d, table12, one_leaf, alive,
                                table16).tri >= 0).any()
    with pytest.raises(ValueError, match="stack"):
        bvh.intersect_tris_bvh(o, d, table12, one_leaf._replace(
            stack_depth=bvh.MAX_STACK + 1), alive)


def test_bvh_walk_fills_its_stack_on_a_depth_62_tree(dev):
    """stress_scenes.deep_bvh(62), the deepest tree the Renderer takes:
    rays from x = -10 along +x push 93 of the kernel's 94 entries, and H1
    is bit for bit with its plain walk and K2's dense entry point."""
    from raytrace_tpu_torch.ops import bvh
    from raytrace_tpu_torch.tools import stress_scenes

    tris, rows, root = stress_scenes.deep_bvh(62)
    n = len(tris)
    table16 = tri_sweep.pack_tri_table(torch.tensor(tris, device=dev), n)
    table12 = megakernel.tri_table12(table16)
    wide, wide_root = bvh.wide_rows(rows, root)
    tree = bvh.BVHTree(torch.tensor(wide, device=dev), wide_root,
                       bvh.wide_stack(62), 1, n)
    assert tree.stack_depth == bvh.MAX_STACK
    g = np.random.default_rng(48)
    R = 1 << 12
    o = np.concatenate([np.full((R, 1), -10.0), g.uniform(-1.5, 0.9, (R, 2))],
                       1)
    d = np.tile([[1.0, 0.0, 0.0]], (R, 1))
    d[R // 2:] = g.standard_normal((R // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = torch.tensor(g.random(R) < 0.9, device=dev)
    hit = _assert_h1_is_plain(_v3_dev(o, dev), _v3_dev(d, dev), table12,
                              tree, alive, table16)
    assert (hit.tri == n - 1).sum() >= 0.4 * R


@pytest.mark.parametrize("mode", ["sah", "implicit"])
def test_bvh_walk_on_inactive_rays_and_binary_rows(dev, mode):
    """H1 with every ray inactive (each a miss, bit for bit with the plain
    walk); binary rows, which only the plain walk takes, refused on the
    card."""
    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.models import bvh_build
    from raytrace_tpu_torch.ops import bvh
    from raytrace_tpu_torch.tools import stress_scenes

    cs = _doc_cs(stress_scenes.box_grid_doc(500, False), 32, 4, 2)
    data = (bvh_build.build_bvh_sah(cs) if mode == "sah"
            else bvh_build.build_bvh(cs, 4))
    soup = bvh_build.permute_soup(cs, data.order)
    r = Renderer(soup, device=dev, use_megakernel=False, use_bvh=False)
    tris = wavefront.prepare_tris(r.static, r.scene, r.batch_times_dev[0])
    n = soup.num_triangles
    o, d, _ = _tri_rays(tris["world_p"][:n].cpu().numpy(), 1 << 12, seed=11,
                        dev=dev)
    none = torch.zeros(1 << 12, dtype=torch.bool, device=dev)
    hit = _assert_h1_is_plain(o, d, tris["tri_table12"],
                              _bvh_tree(soup, data, dev), none,
                              tris["tri_table16"],
                              _bvh_tree(soup, data, dev, wide=False))
    assert (hit.tri == -1).all() and (hit.t == T_MAX).all()
    with pytest.raises(ValueError, match="four-wide"):
        bvh.intersect_tris_bvh(o, d, tris["tri_table12"],
                               _bvh_tree(soup, data, dev, wide=False), none)


def test_sah_renderer_on_card_matches_dense_and_cpu(dev):
    """final-one-weekend's four large spheres tessellated (28,032
    triangles), use_bvh=True on the card: H1 launched, the same bytes as
    use_bvh=False (K2) on the same soup, and within the card-vs-CPU limits
    of the CPU's SAH render."""
    from raytrace_tpu_torch.ops import bvh
    from raytrace_tpu_torch.tools import stress_scenes

    cs = compile_scene(SceneFile.from_json_dict(
        stress_scenes.big_spheres_doc()), width=64, analytic_spheres=False)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=8, sample_batches=1))
    before = bvh.LAUNCHES
    r = Renderer(cs, device=dev, use_bvh=True)
    assert r.static.bvh_mode == "sah" and r.path == "wavefront"
    img = r.render_all()
    assert bvh.LAUNCHES > before
    k2 = Renderer(r.compiled, device=dev, use_bvh=False)
    assert img.tobytes() == k2.render_all().tobytes()
    cpu = Renderer(cs, device="cpu", use_bvh=True)
    c_img = cpu.render_all()
    np.testing.assert_allclose(img.mean(axis=(0, 1)), c_img.mean(axis=(0, 1)),
                               atol=1e-2)
    assert abs(r.stats.rays_traced - cpu.stats.rays_traced) <= (
        0.02 * cpu.stats.rays_traced)


def _assert_h2_is_plain(ov, dv, table, tree, alive):
    """H2's walk (over ``tree``, twice) and its launch without a tree, its
    dense entry point, the plain walk and the dense plain sweep give the
    same bits.  Returns the walk's hit."""
    from raytrace_tpu_torch.ops import sphere_obj, spheres

    before = sphere_obj.LAUNCHES
    hit = sphere_obj.intersect_spheres_object(ov, dv, table, alive, tree)
    again = sphere_obj.intersect_spheres_object(ov, dv, table, alive, tree)
    flat = sphere_obj.intersect_spheres_object(ov, dv, table, alive)
    assert sphere_obj.LAUNCHES == before + 3
    dense = sphere_obj.intersect_spheres_object_dense(ov, dv, table, alive)
    assert sphere_obj.LAUNCHES == before + 3
    plain = spheres.intersect_spheres(ov, dv, table)
    refs = [again, flat, dense, (torch.where(alive, plain.t, T_MAX),
                                 torch.where(alive, plain.sph, -1))]
    if tree is not None:
        live = torch.nonzero(alive).squeeze(1)
        walk = sphere_obj.object_tree_sweep_reference(
            *(V3(*(x[live] for x in v)) for v in (ov, dv)), table, tree)
        refs.append((torch.full_like(hit.t, T_MAX).index_put_(
            (live,), walk[0]), torch.full_like(hit.sph, -1).index_put_(
                (live,), walk[1])))
    torch.cuda.synchronize()
    for ref in refs:
        for a, b in zip(hit, ref):
            assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
    return hit


def _v3_dev(a, dev):
    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i], np.float32),
                             device=dev) for i in range(3)))


@pytest.mark.parametrize("moving", [False, True])
def test_object_sphere_sweep_matches_plain(dev, moving):
    """H2 on the ellipsoid fixture's table at a batch time (and fow-
    ellipsoids' 488 spheres, the Renderer's tree past its four large
    ones), on random rays with an alive mask: the walk bit for bit with
    its plain walk, its dense entry point and the dense plain sweep, two
    launches byte-identical."""
    from raytrace_tpu_torch.tools import ellipsoid_scenes

    for doc in (ellipsoid_scenes.ellipsoid_fixture_doc(moving=moving),
                ellipsoid_scenes.fow_ellipsoids_doc()):
        r = Renderer(_doc_cs(doc, 32, 4, 2), device=dev)
        assert r.path == "wavefront" and not r.static.sphere_world_mode
        geom = r._geometry(1)
        table, tree = geom.sph_obj16, geom.sph_obj_tree
        assert (tree is None) == (r.static.num_spheres == 4)
        g = np.random.default_rng(12)
        R = 1 << 16
        o = g.uniform([-12, -6, -12], [14, -0.2, 12], (R, 3))
        d = g.uniform([-5, -3, -3], [5, 0.5, 3], (R, 3)) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        alive = torch.tensor(g.random(R) < 0.8, device=dev)
        hit = _assert_h2_is_plain(_v3_dev(o, dev), _v3_dev(d, dev), table,
                                  tree, alive)
        assert (hit.sph >= 0).sum() > 1000


def test_object_sphere_walk_far_grazing_one_leaf_and_inactive(dev):
    """fow-ellipsoids' table on the card: the Renderer's tree (built once)
    on grazing rays from near and from 1,000-2,000 away, at the first
    batch's time and at a later time whose rows differ from its in their
    last bits (taken into the once-built tree as prepare_batch takes
    them), a one-leaf tree, and every ray inactive, each bit for bit with
    the plain versions."""
    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.ops import sphere_obj
    from raytrace_tpu_torch.tools import ellipsoid_scenes

    r = Renderer(_doc_cs(ellipsoid_scenes.fow_ellipsoids_doc(), 32, 4, 2),
                 device=dev)
    geom = r._geometry(0)
    first, n = geom.sph_obj16, r.static.num_spheres
    assert torch.equal(geom.sph_obj_tree.nodes, r._obj_tree.nodes)
    drifted = next(table for table in (
        wavefront.object_table(r.scene, torch.tensor(
            t, dtype=torch.float32, device=dev))
        for t in np.random.default_rng(45).random(64))
        if not torch.equal(table, first))
    for k, table in enumerate((first, drifted)):
        tree = r._obj_tree._replace(
            rows=table[r._obj_tree.ids.long()].contiguous())
        rays = [ellipsoid_scenes.grazing_rays(table.cpu(), n, 1 << 15,
                                              43 + 2 * k),
                ellipsoid_scenes.grazing_rays(table.cpu(), n, 1 << 15,
                                              44 + 2 * k,
                                              dist=(1000.0, 2000.0))]
        one_leaf = sphere_obj.build_object_tree(table, n, 4, tree.ids,
                                                leaf=n - 4)
        assert one_leaf.depth == 0
        for o, d in rays:
            ov, dv = _v3_dev(o, dev), _v3_dev(d, dev)
            on = torch.ones(len(o), dtype=torch.bool, device=dev)
            assert (_assert_h2_is_plain(ov, dv, table, tree, on).sph
                    >= 0).sum() > 1 << 14
            _assert_h2_is_plain(ov, dv, table, one_leaf, on)
            hit = _assert_h2_is_plain(ov, dv, table, tree, ~on)
            assert (hit.sph == -1).all() and (hit.t == T_MAX).all()


def test_ellipsoid_render_on_card_matches_cpu(dev):
    from raytrace_tpu_torch.ops import sphere_obj
    from raytrace_tpu_torch.tools import ellipsoid_scenes

    cs = _doc_cs(ellipsoid_scenes.ellipsoid_fixture_doc(triangles=True), 96,
                 8, 1)
    before = sphere_obj.LAUNCHES
    gpu = Renderer(cs, device=dev)
    assert gpu.path == "wavefront" and not gpu.static.sphere_world_mode
    g_img = gpu.render_all()
    assert sphere_obj.LAUNCHES > before
    c_img = Renderer(cs, device="cpu").render_all()
    np.testing.assert_allclose(g_img.mean(axis=(0, 1)),
                               c_img.mean(axis=(0, 1)), atol=1e-2)


# ---- K4's row and sample ranges: the sharded renderer's launch ------------

# (row_base, rows, spp_local, sample_base) on a 48 x 27 frame: a middle
# range, one running past the frame's last row, one wholly past it (a row
# shard of 5 rows over 4 ranks has one: it launches nothing), the whole
# frame.
RANGES = [(7, 9, 2, 2), (22, 9, 1, 3), (30, 4, 2, 0), (0, 27, 4, 0)]


@pytest.mark.parametrize("form", ["static", "anim", "tris+lights+noise+image"])
def test_fused_kernel_row_and_sample_ranges_bit_for_bit(dev, form, tmp_path):
    args, kw = _cluster_form_args(form, tmp_path, dev, w=48)
    assert args[0].height == 27
    full, full_traced = megakernel.render_tile_mega(*args, **kw)
    for row_base, rows, spp_local, base in RANGES:
        rk = dict(kw, spp_local=spp_local, row_base=row_base, rows=rows)
        before = megakernel.LAUNCHES
        sums, traced = megakernel.render_tile_mega(*args, base, **rk)
        torch.cuda.synchronize()
        inside = max(0, min(rows, 27 - row_base))
        assert megakernel.LAUNCHES == before + (inside > 0)
        assert sums.shape == (rows, 48, 3) and traced.shape == (rows, 48)
        ref, ref_traced = megakernel.megakernel_reference(*args, base, **rk)
        assert torch.equal(sums, ref) and torch.equal(traced, ref_traced)
        assert not sums[inside:].any() and not traced[inside:].any()
        assert inside == 0 or float(sums[:inside].max()) > 0.0
        if spp_local == 4:
            assert torch.equal(sums, full[row_base:row_base + rows])
            assert torch.equal(traced, full_traced[row_base:row_base + rows])


def test_one_rank_sharded_renderer_is_the_renderer_on_the_card(dev):
    from raytrace_tpu_torch.parallel import MultiChipRenderer

    cs = _final(64, 36, 8)
    for step in (1, 2):
        r = Renderer(cs, device=dev)
        m = MultiChipRenderer(cs, device=dev)
        assert r.path == m.path == "fused"
        before = megakernel.LAUNCHES
        assert m.render_batches(step) == step
        assert megakernel.LAUNCHES == before + 1
        r.render_batches(step)
        assert m.image().tobytes() == r.image().tobytes()
