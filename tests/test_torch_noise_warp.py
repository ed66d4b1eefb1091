"""The fused kernel's noise design (csrc/megakernel.cu: the lattice tables in
shared memory), through its plain-PyTorch model in ops/perlin.py, against
cnoise_v3 / turbulence_v3 and JAX's raytrace_tpu/ops/perlin.py.

- The domain: for every integer-valued lattice coordinate |x| <= 2^24,
  mod289 lands in [-1, 289], every argument of _permute in [-1, 577],
  every hash in [0, 288], and every product (34 x + 10) x stays below
  2^24, so the chain is exact and the tables hold every value it gives.
- x - floor(x) is torch.remainder(x, 1.0) bit for bit on every value the
  gradient takes from a hash.
- The table form (tables below 2^24, arithmetic beyond) gives cnoise_v3's
  and turbulence_v3's bits (cnoise: values, so +0 and -0 agree and NaN
  agrees with NaN; turbulence: bits), and JAX's evaluated op by op; within
  JIT_ATOL of JAX's jitted functions, as tests/test_torch_perlin.py holds
  cnoise_v3.
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
LIMIT = 2 ** 24


def _points(kind: str) -> np.ndarray:
    seeds = {"small": 0, "negative": 1, "lattice": 2, "large": 3,
             "mod289": 5, "crossing": 6, "beyond": 7}
    g = np.random.default_rng(seeds[kind])
    if kind == "small":
        p = g.uniform(0.0, 5.0, (N, 3))
    elif kind == "negative":
        p = g.uniform(-40.0, 0.0, (N, 3))
    elif kind == "lattice":
        p = np.round(g.uniform(-300.0, 300.0, (N, 3)))
        p[: N // 2, 2] += 0.5
    elif kind == "large":
        p = g.uniform(-1e3 * 64, 1e3 * 64, (N, 3))
    elif kind == "mod289":
        # at and around multiples of 289, on both sides of 0
        k = g.integers(-200, 200, (N, 3)) * 289.0
        off = g.choice([-1.0, -1e-3, 0.0, 1e-3, 0.5, 288.999, 289.0],
                       (N, 3))
        p = k + off
    elif kind == "crossing":
        # octaves 0-6 cross 2^24 within one turbulence
        p = g.uniform(2.0 ** 17, 2.0 ** 20, (N, 3)) * g.choice([-1, 1],
                                                               (N, 3))
    else:
        # beyond 2^24 on one axis or on all three
        p = g.uniform(-50.0, 50.0, (N, 3))
        far = g.uniform(2.0 ** 24, 2.0 ** 27, (N, 3)) * g.choice([-1, 1],
                                                                 (N, 3))
        axis = g.integers(0, 3, N)
        p[np.arange(N), axis] = far[np.arange(N), axis]
        p[: N // 4] = far[: N // 4]
    return p.astype(np.float32)


KINDS = ["small", "negative", "lattice", "large", "mod289", "crossing",
         "beyond"]


def _t(p):
    return [torch.tensor(np.ascontiguousarray(p[:, i])) for i in range(3)]


def _j(p):
    return [jnp.asarray(p[:, i]) for i in range(3)]


@pytest.fixture(scope="module")
def tables():
    return tperlin.gradient_table(), tperlin.permute_table()


# ---- the domain --------------------------------------------------------------

def test_mod289_of_every_lattice_coordinate_is_an_integer_in_range():
    """Every integer-valued float x with |x| <= 2^24 (fpx and fpx + 1 of a
    coordinate whose floor is below 2^24)."""
    seen = torch.zeros(291, dtype=torch.bool)
    chunk = 1 << 22
    for lo in range(-LIMIT, LIMIT + 1, chunk):
        x = torch.arange(lo, min(lo + chunk, LIMIT + 1),
                         dtype=torch.float64).float()
        m = tperlin._mod289(x)
        assert torch.equal(m, torch.round(m))
        assert m.min() >= -1 and m.max() <= 289
        seen[(m + 1).long()] = True
    assert seen.all()   # the whole range is taken, -1 and 289 included


def test_permute_covers_its_arguments_exactly():
    """_permute on [-1, 577]: (34 x + 10) x below 2^24, every result an
    integer hash in [0, 288]; its arguments in the chain, permute(a) + b
    with a, b from mod289, stay in [-1, 577]."""
    x = torch.arange(tperlin.PERM_MIN, tperlin.PERM_MAX + 1,
                     dtype=torch.float32)
    prod = ((x * 34.0) + 10.0) * x
    assert prod.abs().max() < LIMIT
    assert torch.equal(prod.double(),
                       (34.0 * x.double() + 10.0) * x.double())
    h = tperlin._permute(x)
    assert torch.equal(h, torch.round(h))
    assert h.min() >= 0 and h.max() <= 288
    a = torch.arange(-1, 290, dtype=torch.float32)   # mod289's range
    ha = tperlin._permute(a)
    args = (ha[:, None] + a[None, :]).flatten()
    assert args.min() >= tperlin.PERM_MIN and args.max() <= tperlin.PERM_MAX
    ixy = tperlin._permute(args)
    hashes = tperlin._permute((ixy[:, None] + a[None, :]).flatten())
    assert hashes.min() >= 0 and hashes.max() <= 288


def test_the_tables_hold_the_arithmetic(tables):
    """Row x + 1 holds permute(x) and the scaled gradient of that hash, as
    cnoise_v3 computes it (with torch.remainder)."""
    grad, perm = tables
    assert grad.shape == (579, 3) and grad.dtype == torch.float32
    assert perm.shape == (579,) and perm.min() >= 0 and perm.max() <= 288
    x = torch.arange(-1, 578, dtype=torch.float32)
    assert torch.equal(perm.float(), tperlin._permute(x))
    gx, gy, gz = tperlin._grads(perm.float())
    norm = tperlin._taylor_inv_sqrt(gx * gx + gy * gy + gz * gz)
    ref = torch.stack([gx * norm, gy * norm, gz * norm], -1)
    assert torch.equal(grad.view(torch.int32), ref.view(torch.int32))


def test_fract_is_the_remainder_on_every_gradient_argument():
    h = torch.arange(289, dtype=torch.float32)
    gx = h * (1.0 / 7.0)
    for v in (gx, torch.floor(gx) * (1.0 / 7.0)):
        assert (v >= 0).all()
        assert torch.equal(tperlin._fract(v).view(torch.int32),
                           torch.remainder(v, 1.0).view(torch.int32))


# ---- the table form ----------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_table_cnoise_gives_cnoise_v3(kind, tables):
    p = _points(kind)
    t = tperlin.cnoise_table(*_t(p), *tables).numpy()
    np.testing.assert_array_equal(t, tperlin.cnoise_v3(*_t(p)).numpy())
    if kind != "beyond":
        assert np.isfinite(t).all()


@pytest.mark.parametrize("kind", KINDS)
def test_table_turbulence_gives_turbulence_v3_bits(kind, tables):
    p = _points(kind)
    t = tperlin.turbulence_table(*_t(p), *tables)
    ref = tperlin.turbulence_v3(*_t(p))
    finite = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(t), finite)
    assert torch.equal(t[finite].view(torch.int32),
                       ref[finite].view(torch.int32))


@pytest.mark.parametrize("fn", ["cnoise", "turbulence"])
@pytest.mark.parametrize("kind", KINDS)
def test_table_forms_match_jax_op_by_op(fn, kind, tables):
    p = _points(kind)
    j = np.asarray(getattr(jperlin, fn + "_v3")(*_j(p)))
    t = getattr(tperlin, fn + "_table")(*_t(p), *tables).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("fn", ["cnoise", "turbulence"])
@pytest.mark.parametrize("kind", ["small", "large", "mod289"])
def test_table_forms_match_jitted_jax(fn, kind, tables):
    p = _points(kind)
    j = np.asarray(jax.jit(getattr(jperlin, fn + "_v3"))(*_j(p)))
    t = getattr(tperlin, fn + "_table")(*_t(p), *tables).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=JIT_ATOL)

