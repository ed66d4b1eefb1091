"""Sphere closest hit: the port's plain sweep against the Pallas kernel (in
interpret mode) and the XLA ``intersect_spheres_world``, on numpy-seeded
spheres and rays; the host tables bitwise.  The CUDA kernel is tested
against the plain sweep in test_torch_cuda.py.

Tolerance: ids equal on >= 99.9% of rays, and ids equal with t within
rtol=1e-3, atol=1e-3 on >= 99.9% of rays.  Bitwise t is not available even on the CPU: XLA
contracts multiply-adds into FMAs and torch does not (measured: ids 100%,
max relative t error ~1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.engine.renderer import get_batch_ray_times as jax_times
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops import pallas_sweep as jsweep
from raytrace_tpu.ops import spheres as jspheres
from raytrace_tpu.scene_file import SceneFile
from raytrace_tpu_torch.cli import DEFAULT_SCENE
from raytrace_tpu_torch.engine.arrays import from_jax_compiled
from raytrace_tpu_torch.ops import _build, sphere_sweep, spheres
from raytrace_tpu_torch.ops.intersect import T_MAX
from raytrace_tpu_torch.ops.vec3 import V3

torch.set_num_threads(1)

AGREEMENT = 0.999
RTOL = ATOL = 1e-3
R = 2048  # a multiple of the Pallas kernel's block


def _scene(S, seed):
    """[S, 5] world table with the ground-sphere geometry of
    final-one-weekend, and R rays from above the ground."""
    g = np.random.default_rng(seed)
    c = np.zeros((S, 3))
    r = np.zeros(S)
    c[0], r[0] = (0.0, -1000.0, 0.0), 1000.0
    c[1:] = g.uniform([-11, 0.2, -11], [11, 1.0, 11], (S - 1, 3))
    r[1:] = g.uniform(0.2, 1.0, S - 1)
    table = np.zeros((S, 5))
    table[:, :3], table[:, 3] = c, r
    table[:, 4] = (c ** 2).sum(-1) - r ** 2
    o = g.uniform([-13, 0.5, -13], [13, 4.0, 13], (R, 3))
    d = g.standard_normal((R, 3))
    return (table.astype(np.float32), o.astype(np.float32),
            d.astype(np.float32))


def _v3(a):
    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _assert_hits_agree(t, ids, t_ref, id_ref):
    """ids equal, and (id, t within tolerance) equal, each on >= 99.9% of
    rays: a ray starting within float error of T_MIN from a surface may
    keep the near root in one version and the far root in the other."""
    t, ids = np.asarray(t), np.asarray(ids)
    t_ref, id_ref = np.asarray(t_ref), np.asarray(id_ref)
    same_id = ids == id_ref
    agree = same_id & (np.abs(t - t_ref) <= ATOL + RTOL * np.abs(t_ref))
    assert same_id.mean() >= AGREEMENT
    assert agree.mean() >= AGREEMENT


@pytest.mark.parametrize("S", [3, 37, 488])
def test_plain_sweep_matches_jax(S):
    table, o, d = _scene(S, seed=S)
    t_tab8 = sphere_sweep.pad_table8(torch.tensor(table))
    t, ids = sphere_sweep.sphere_sweep_reference(_v3(o), _v3(d), t_tab8)
    assert (ids >= 0).float().mean() > 0.3   # the rays do hit spheres

    jt, jid = jsweep.sphere_sweep_pallas(
        jsweep.pad_table8(jnp.asarray(table)), jnp.asarray(o.T),
        jnp.asarray(d.T), interpret=True)
    _assert_hits_agree(t.numpy(), ids.numpy(), jt, jid)

    jw = jspheres.intersect_spheres_world(jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(table),
                                          chunk=min(128, S))
    _assert_hits_agree(t.numpy(), ids.numpy(), jw.t, jw.sph)


def test_active_mask_and_padding_rows():
    table, o, d = _scene(3, seed=11)     # S8 = 8: five padding rows
    # Rays through the origin, where every padding row is centred.
    o[:64] = (0.0, 2.0, 0.0)
    d[:64] = (0.0, -1.0, 0.0)
    active = np.random.default_rng(12).random(R) < 0.6
    t_tab8 = sphere_sweep.pad_table8(torch.tensor(table))
    hit = sphere_sweep.intersect_spheres_sweep(_v3(o), _v3(d), t_tab8,
                                               torch.tensor(active))
    t, ids = hit.t.numpy(), hit.sph.numpy()
    assert (ids[~active] == -1).all() and (t[~active] == T_MAX).all()
    assert ids.max() < 3
    assert ((ids == -1) == (t == T_MAX)).all()

    jh = jsweep.intersect_spheres_pallas_v3(
        V3(*(jnp.asarray(o[:, i]) for i in range(3))),
        V3(*(jnp.asarray(d[:, i]) for i in range(3))),
        jsweep.pad_table8(jnp.asarray(table)), active=jnp.asarray(active),
        interpret=True)
    _assert_hits_agree(t, ids, jh.t, jh.sph)


def test_ties_go_to_the_lowest_id():
    table, o, d = _scene(16, seed=13)
    table[9] = table[4]                  # an exact duplicate at a higher id
    o[:] = table[4, :3] + (0.0, 3.0, 0.0)
    d[:] = (0.0, -1.0, 0.0)
    t_tab8 = sphere_sweep.pad_table8(torch.tensor(table))
    _, ids = sphere_sweep.sphere_sweep_reference(_v3(o), _v3(d), t_tab8)
    assert (ids == 4).all()


def test_world_sphere_tables_and_pad_table8_bitwise():
    jcs = jax_compile_scene(SceneFile.load_json(DEFAULT_SCENE), width=96,
                            height=54)
    times = jax_times(jcs.render.sample_batches)[:3]
    tabs = spheres.world_sphere_tables(from_jax_compiled(jcs), times)
    np.testing.assert_array_equal(tabs,
                                  jspheres.world_sphere_tables(jcs, times))
    for S in (488, 3):
        t8 = sphere_sweep.pad_table8(torch.tensor(tabs[0, :S]))
        np.testing.assert_array_equal(
            t8.numpy(), np.asarray(jsweep.pad_table8(jnp.asarray(tabs[0, :S]))))


def test_wrapper_checks_inputs_and_never_falls_back():
    table, o, d = _scene(8, seed=14)
    t_tab8 = sphere_sweep.pad_table8(torch.tensor(table))
    active = torch.ones(R, dtype=torch.bool)
    strided = V3(*(torch.tensor(o)[:, i] for i in range(3)))
    with pytest.raises(ValueError, match="contiguous"):
        sphere_sweep.intersect_spheres_sweep(strided, _v3(d), t_tab8, active)
    with pytest.raises(ValueError, match="table8"):
        sphere_sweep.intersect_spheres_sweep(_v3(o), _v3(d), t_tab8[:, :5],
                                             active)
    meta = lambda v: V3(*(c.to("meta") for c in v))  # noqa: E731
    with pytest.raises(ValueError, match="no sphere sweep"):
        sphere_sweep.intersect_spheres_sweep(
            meta(_v3(o)), meta(_v3(d)), t_tab8.to("meta"), active.to("meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("sphere_sweep")
