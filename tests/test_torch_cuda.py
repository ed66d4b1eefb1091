"""Card-only tests of the port: the CUDA sphere-sweep kernel against its
plain PyTorch version on the same tensors, and the main path rendered on
the card against the CPU.  No JAX here, so they also run on a GPU machine
without it (tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test skips with a reason where torch.cuda.is_available() is false.
Tolerance: ids equal, and ids equal with t within rtol=1e-3, atol=1e-3,
each on >= 99.9% of rays (nvcc contracts multiply-adds into FMAs, PyTorch's
elementwise kernels do not; a ray starting within float error of T_MIN
from a surface may take the other root).
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.ops import sphere_sweep
from raytrace_tpu_torch.ops.intersect import T_MAX
from raytrace_tpu_torch.ops.vec3 import V3

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
    gpu = Renderer(cs, device=dev)
    g_img = gpu.render_all()
    assert sphere_sweep.LAUNCHES > before
    cpu = Renderer(cs, device="cpu")
    c_img = cpu.render_all()
    assert np.isfinite(g_img).all() and (g_img >= 0).all()
    np.testing.assert_allclose(g_img.mean(axis=(0, 1)),
                               c_img.mean(axis=(0, 1)), atol=1e-2)
    assert abs(gpu.stats.rays_traced - cpu.stats.rays_traced) <= (
        0.02 * cpu.stats.rays_traced)
