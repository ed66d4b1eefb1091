"""Perlin noise and turbulence: the port's ops/perlin.py against the JAX
package's raytrace_tpu/ops/perlin.py on the same seeded points.

Point sets: small coordinates, negative ones, lattice-exact integers, and
large ones (|p| up to 1e3 x 2^6, where the turbulence's last octave
samples a sphere of radius 1000).  Tolerances:

- the lattice hash (floor, mod 289, the permute chain on integer-valued
  floats below 2^24) is exact;
- against JAX evaluated op by op (each jnp call its own XLA computation,
  nothing contracted) the float results are bit for bit too (measured:
  every point equal);
- against ``jax.jit`` of the same functions, where XLA's CPU build
  contracts multiply-adds into FMAs and torch does not, within
  JIT_ATOL = 1e-5 (measured: 2.2e-6 on cnoise_v3, 2.2e-6 on turbulence_v3,
  and exact on the lattice-exact set);
- the port's row forms give its component forms' bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops import perlin as jperlin
from raytrace_tpu_torch.ops import perlin as tperlin

torch.set_num_threads(1)

N = 4096
JIT_ATOL = 1e-5


def _points(kind: str) -> np.ndarray:
    g = np.random.default_rng({"small": 0, "negative": 1, "lattice": 2,
                               "large": 3}[kind])
    if kind == "small":
        p = g.uniform(0.0, 5.0, (N, 3))
    elif kind == "negative":
        p = g.uniform(-40.0, 0.0, (N, 3))
    elif kind == "lattice":
        p = np.round(g.uniform(-300.0, 300.0, (N, 3)))
        p[: N // 2, 2] += 0.5   # half of them off the lattice in z only
    else:
        p = g.uniform(-1e3 * 64, 1e3 * 64, (N, 3))
    return p.astype(np.float32)


KINDS = ["small", "negative", "lattice", "large"]


def _j(p):
    return [jnp.asarray(p[:, i]) for i in range(3)]


def _t(p):
    return [torch.tensor(np.ascontiguousarray(p[:, i])) for i in range(3)]


@pytest.mark.parametrize("kind", KINDS)
def test_lattice_hash_is_exact(kind):
    """floor, _mod289 and the _permute chain of cnoise_v3's corners."""
    p = _points(kind)
    for jx, tx, jy, ty in zip(_j(p), _t(p), _j(p[:, ::-1].copy()),
                              _t(p[:, ::-1].copy())):
        j = jperlin._permute(jperlin._permute(
            jperlin._mod289(jnp.floor(jx) + 1.0)) + jperlin._mod289(
                jnp.floor(jy)))
        t = tperlin._permute(tperlin._permute(
            tperlin._mod289(torch.floor(tx) + 1.0)) + tperlin._mod289(
                torch.floor(ty)))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert (t >= 0).all() and (t <= 289).all()
        assert torch.equal(t, torch.round(t))


@pytest.mark.parametrize("fn", ["cnoise_v3", "turbulence_v3"])
@pytest.mark.parametrize("kind", KINDS)
def test_component_forms_match_jax_op_by_op(fn, kind):
    p = _points(kind)
    j = np.asarray(getattr(jperlin, fn)(*_j(p)))
    t = getattr(tperlin, fn)(*_t(p)).numpy()
    np.testing.assert_array_equal(t, j)
    assert np.isfinite(t).all() and np.abs(t).max() < 2.5


@pytest.mark.parametrize("fn", ["cnoise_v3", "turbulence_v3"])
@pytest.mark.parametrize("kind", ["small", "large"])
def test_component_forms_match_jitted_jax(fn, kind):
    p = _points(kind)
    j = np.asarray(jax.jit(getattr(jperlin, fn))(*_j(p)))
    t = getattr(tperlin, fn)(*_t(p)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=JIT_ATOL)


@pytest.mark.parametrize("fn", ["cnoise", "turbulence"])
def test_row_forms_match_jax(fn):
    p = np.concatenate([_points(k) for k in KINDS]).reshape(-1, 2, 3)
    j = np.asarray(getattr(jperlin, fn)(jnp.asarray(p)))
    t = getattr(tperlin, fn)(torch.tensor(p)).numpy()
    assert t.shape == p.shape[:-1]
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kind", KINDS)
def test_row_forms_give_the_component_bits(kind):
    p = _points(kind)
    assert torch.equal(tperlin.cnoise(torch.tensor(p)),
                       tperlin.cnoise_v3(*_t(p)))
    assert torch.equal(tperlin.turbulence(torch.tensor(p), 7),
                       tperlin.turbulence_v3(*_t(p), 7))


def test_noise_is_zero_on_the_lattice_and_continuous():
    """Classic Perlin noise vanishes at integer points and moves little
    over a small step (raytrace_tpu's tests/test_ops.py holds JAX's the
    same way)."""
    g = np.random.default_rng(4)
    lattice = np.round(g.uniform(-20, 20, (512, 3))).astype(np.float32)
    assert torch.allclose(tperlin.cnoise(torch.tensor(lattice)),
                          torch.zeros(512), atol=1e-4)
    p = torch.tensor(g.uniform(-5, 5, (512, 3)).astype(np.float32))
    step = (tperlin.cnoise(p + 1e-4) - tperlin.cnoise(p)).abs()
    assert step.max() < 1e-2
