"""The dev probe P3's split kernel through its plain model
(raytrace_tpu_torch/tools_dev/micro_raygen.py): any range of iterations'
seven terms from the closed form sip = it mod (spp * 24), summed in
iteration order block by block, gives raygen_reference's sums bit for
bit, for every variant, at both shapes cut to 64 cells, at block sizes
that do and do not divide the 96-iteration period; the producers'
stepping of sip; the magic-number division the kernels decode a pixel
with; and which cell counts take the split kernel.  The kernels
themselves are held to the sequential loop on the card
(tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.tools_dev import micro_raygen as mr

CELLS = 64
ITERS = 2 * mr.PERIOD + 13


def _cells(variant, shape):
    pix = mr.pixels(variant, shape, "cpu").reshape(-1)
    return pix[::pix.numel() // CELLS][:CELLS].contiguous()


@pytest.fixture(scope="module")
def sequential():
    """raygen_reference's sums at ITERS iterations, by (variant, shape)."""
    params = mr.camera_params("cpu")
    return {(v, s): mr.raygen_reference(params, _cells(v, s), ITERS, v)
            for v in mr.VARIANTS for s in ("a", "b")}


@pytest.mark.parametrize("block", [1, 16, 17, mr.PERIOD, ITERS])
@pytest.mark.parametrize("shape", ["a", "b"])
@pytest.mark.parametrize("variant", mr.VARIANTS)
def test_blocked_ordered_sum_is_the_sequential_loop(sequential, variant,
                                                    shape, block):
    params = mr.camera_params("cpu")
    pix = _cells(variant, shape)
    acc = torch.zeros(CELLS, dtype=torch.float32)
    for it0 in range(0, ITERS, block):
        terms = mr.raygen_terms(params, pix, it0, min(it0 + block, ITERS),
                                variant)
        assert terms.shape == (min(block, ITERS - it0), 7, CELLS)
        acc = mr.ordered_sum(terms, acc)
    assert torch.equal(acc, sequential[variant, shape])


@pytest.mark.parametrize("variant", mr.VARIANTS)
def test_terms_are_the_loops_terms(variant):
    """Each iteration's terms from the closed form are those of the
    loop's own iteration, across the period's wrap."""
    params = mr.camera_params("cpu")
    pix = _cells(variant, "b")
    it0 = mr.PERIOD - 3
    terms = mr.raygen_terms(params, pix, it0, it0 + 6, variant)
    for it, (_, o, d, f) in enumerate(mr.raygen_steps(params, pix,
                                                      it0 + 6, variant)):
        if it >= it0:
            want = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z, f])
            assert torch.equal(terms[it - it0], want)


@pytest.mark.parametrize("spp", [1, 4, 16])
def test_producers_step_sip_through_the_period(spp):
    """A producer warp w starts at sip = w and adds the chunk a step with
    one conditional subtraction of the period (csrc/micro_raygen.cu
    raygen_split): sip stays it mod period for every iteration."""
    period, chunk = spp * 24, 24
    for w in range(chunk):
        sip = w
        for c in range(3 * period // chunk + 2):
            assert sip == (c * chunk + w) % period
            sip += chunk
            if sip >= period:
                sip -= period


@pytest.mark.parametrize("d", [1, 2, 3, 7, 640, mr.WIDTH, 5400, 2048,
                               (1 << 20) + 1, (1 << 31) - 1])
def test_divisor_divides_exactly(d):
    div = mr.divisor(d)
    assert 0 < div[0] < 1 << 32
    rng = np.random.default_rng(d)
    n = np.concatenate([np.arange(1 << 16, dtype=np.int64),
                        rng.integers(0, 1 << 31, 1 << 18, dtype=np.int64),
                        np.array([(1 << 31) - 1, d - 1, d, d + 1,
                                  2 * d - 1], dtype=np.int64)])
    n = n[(n >= 0) & (n < 1 << 31)]
    assert np.array_equal(mr.divide(n, div), n // d)


def test_divisor_of_the_width_on_every_pixel_id():
    n = np.arange(mr.WIDTH * mr.HEIGHT * 4, dtype=np.int64)
    assert np.array_equal(mr.divide(n, mr.divisor(mr.WIDTH)), n // mr.WIDTH)
    with pytest.raises(ValueError, match="divisor"):
        mr.divisor(0)


def test_only_the_jax_layout_takes_the_split_kernel():
    sms = 132
    assert mr.splits(mr.PROGRAMS * 1024, sms)
    assert not mr.splits(mr.WIDTH * mr.HEIGHT * mr.SPP, sms)
    assert mr.splits(sms * mr.THREADS_PER_SM - 1, sms)
    assert not mr.splits(sms * mr.THREADS_PER_SM, sms)
