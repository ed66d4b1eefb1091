"""K4's image forms take the UV's floor-mod as x - floorf(x)
(csrc/megakernel.cu fract) where the plain sampler
(ops/textures.sample_image_nearest) takes torch.remainder(x, 1): the texel
index floor(fract(u) * w), clamped to [0, w - 1], must be the plain
version's for every float.  Checked here in float32 at the earth's 5,400
x 2,700 texels and at the form checks' 640 x 320, on both coordinates and
on the sphere's u, which is floor-modded twice (once where the kernel
takes it from atan2f, once in the sampler), for the zeros, the smallest
subnormals, 1 - ulp, +-0.5 and their neighbours, integers, and 2^20
random floats in [-0.5, 0.5] and in [0, 1]."""

from __future__ import annotations

import numpy as np
import pytest
import torch

SIZES = [(5400, 2700), (640, 320)]


def _fract(x: torch.Tensor) -> torch.Tensor:
    return x - torch.floor(x)


def _rem1(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x, 1.0)


def _index(x: torch.Tensor, w: int) -> torch.Tensor:
    """floor(x * w) clamped to [0, w - 1], the float product as the kernel
    takes it (x * float(w) in float32)."""
    return torch.floor(x * np.float32(w)).to(torch.int64).clamp(0, w - 1)


def _values() -> torch.Tensor:
    f32 = np.float32
    tiny = np.finfo(f32).smallest_subnormal
    one_minus = np.nextafter(f32(1), f32(0))
    special = [0.0, -0.0, tiny, -tiny, 2 * tiny, -2 * tiny,
               np.finfo(f32).tiny, -np.finfo(f32).tiny, one_minus, -one_minus,
               1.0, -1.0, 2.0, -3.0, 1e-10, -1e-10, 2.0 ** 23, -(2.0 ** 23),
               2.0 ** 24 + 2, -(2.0 ** 24) - 2]
    for h in (f32(0.5), f32(-0.5)):
        special += [np.nextafter(h, f32(-1)), h, np.nextafter(h, f32(1))]
    rng = np.random.default_rng(17)
    return torch.cat([
        torch.tensor(np.array(special, dtype=f32)),
        torch.tensor(rng.uniform(-0.5, 0.5, 1 << 20).astype(f32)),
        torch.tensor(rng.uniform(0.0, 1.0, 1 << 20).astype(f32))])


@pytest.fixture(scope="module")
def values():
    x = _values()
    assert x.dtype == torch.float32
    return x


@pytest.mark.parametrize("w,h", SIZES)
def test_fract_gives_the_plain_texel_index(values, w, h):
    for size in (w, h):
        assert torch.equal(_index(_fract(values), size),
                           _index(_rem1(values), size))


@pytest.mark.parametrize("w,h", SIZES)
def test_sphere_u_floor_modded_twice(values, w, h):
    assert torch.equal(_index(_fract(_fract(values)), w),
                       _index(_rem1(_rem1(values)), w))


def test_fract_is_the_remainder_but_for_the_sign_of_zero(values):
    a, b = _fract(values), _rem1(values)
    assert torch.equal(a, b)  # -0 == +0 in torch.equal's comparison
    assert not torch.signbit(a).any()
    # The remainder keeps -0 where x is a negative integer or -0.
    assert torch.signbit(b).any()
