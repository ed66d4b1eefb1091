"""PCG RNG and samplers: the port against raytrace_tpu.ops.rng on the same
numpy-seeded states.  Integer words and uniform floats are bit-identical;
the sin/cos samplers agree within atol=2e-6 (XLA's and torch's CPU sin/cos
differ by a few ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops import rng as jrng
from raytrace_tpu_torch.ops import rng as trng

torch.set_num_threads(1)

SAMPLER_ATOL = 2e-6


def _states(n=4096, seed=0):
    """Random 32-bit states, plus the edge values 0 and 2^32 - 1."""
    s = np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64)
    s[:2] = [0, 2 ** 32 - 1]
    return jnp.asarray(s.astype(np.uint32)), torch.tensor(s.astype(np.int64))


def _same_words(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


def test_init_rng_then_eight_floats_bitwise():
    g = np.random.default_rng(1)
    W, H, spp = 1200, 675, 4
    n = 4096
    s = g.integers(0, spp, n)
    py = g.integers(0, H, n)
    px = g.integers(0, W, n)
    batch = 24
    js = jrng.init_rng(jnp.int32(batch), jnp.asarray(s, jnp.uint32),
                       jnp.asarray(py, jnp.uint32), jnp.asarray(px, jnp.uint32),
                       W, H, spp)
    ts = trng.init_rng(batch, torch.tensor(s), torch.tensor(py),
                       torch.tensor(px), W, H, spp)
    _same_words(js, ts)
    for _ in range(8):
        js, jf = jrng.random_float(js)
        ts, tf = trng.random_float(ts)
        _same_words(js, ts)
        assert tf.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())


def test_random_float_full_range_bitwise():
    js, ts = _states()
    for _ in range(8):
        js, jf = jrng.random_float(js)
        ts, tf = trng.random_float(ts)
        _same_words(js, ts)
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    assert float(tf.min()) >= 0.0 and float(tf.max()) <= 1.0


def test_sample_square_stratified():
    js, ts = _states(seed=2)
    si = np.random.default_rng(3).integers(0, 3, js.shape[0])
    sj = np.random.default_rng(4).integers(0, 3, js.shape[0])
    recip = np.float32(1.0 / 3.0)
    js, joff = jrng.sample_square_stratified(
        js, jnp.asarray(si, jnp.float32), jnp.asarray(sj, jnp.float32), recip)
    ts, tx, ty = trng.sample_square_stratified(
        ts, torch.tensor(si, dtype=torch.float32),
        torch.tensor(sj, dtype=torch.float32), float(recip))
    _same_words(js, ts)
    np.testing.assert_allclose(tx.numpy(), np.asarray(joff[:, 0]), atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(joff[:, 1]), atol=1e-6)


@pytest.mark.parametrize("name", ["random_unit_v3", "random_cosine_v3"])
def test_v3_samplers(name):
    js, ts = _states(seed=5)
    js, jv = getattr(jrng, name)(js)
    ts, tv = getattr(trng, name)(ts)
    _same_words(js, ts)
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=SAMPLER_ATOL)


def test_disk_concentric():
    js, ts = _states(seed=6)
    js, jx, jy = jrng.sample_disk_concentric_xy(js)
    ts, tx, ty = trng.sample_disk_concentric_xy(ts)
    _same_words(js, ts)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=SAMPLER_ATOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=SAMPLER_ATOL)
    assert float((tx * tx + ty * ty).max()) <= 1.0 + 1e-6
