"""P2's kernel as redesigned for the card (raytrace_tpu_torch/csrc/
probe_trig.cu): what of it the CPU reaches.

- ``probe_trig.plan``, the kernel's split of n elements into a head up
  to the first 16-byte boundary, runs of 8 and a tail, over a grid of at
  most the resident blocks: every element written exactly once, by the
  kernel's own thread mapping, for n = 0..70 and 2^24 + 3 at every
  misalignment.
- The floor-mod ``x - floor(x)`` (K4's fract) against the check-only
  kernel's fmod with its sign fix-up (rem1), in float32 numpy: bit for bit
  but for the sign of a zero, on the edge cases and 2^20 seeded points of
  u's range; and u + v the same bytes under both over the probe's points.
- The SASS walk that counts P2's instructions an element
  (``smoke_lib.sass_path``, ``sass_per_element``, ``trig_sass``) on
  listings written in cuobjdump's form, and the buffer the wrapper gives
  the kernel (``empty_aligned_like``).

The kernel itself runs only on a card: tests/test_torch_cuda.py holds it
byte for byte to the check-only kernel and within ULP_TOL of the plain
version.  tests/test_torch_probes.py holds the plain version to the JAX
probe.
"""

import pathlib

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.tools import smoke_lib
from raytrace_tpu_torch.tools_dev import probe_trig

torch.set_num_threads(1)

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "raytrace_tpu_torch"
        / "csrc" / "probe_trig.cu")
# (SMs, resident blocks an SM) the grid is planned for: the H100's 132
# at several occupancies, and small cards.
CARDS = ((132, 3), (132, 8), (1, 1), (2, 4))
F32 = np.float32


def _half_index(i, h, vectors):
    """csrc/probe_trig.cu's half_index: the float4 that half h of run i
    takes (the l-th of each half of its warp's float4)."""
    w = i & ~31
    return i + w + h * np.minimum(32, vectors - w)


def _written(n, misalign, sms, blocks_per_sm):
    """How often the kernel's threads write each element under ``plan``:
    block 0's first head + tail threads one element each, then every
    thread the runs tid, tid + stride, ... below ``vectors``, each run's
    two float4 where ``_half_index`` puts them."""
    head, vectors, tail, grid = probe_trig.plan(n, misalign, sms,
                                                blocks_per_sm)
    tid = np.arange(grid * probe_trig.THREADS)
    edge = tid[tid < head + tail]
    stride = max(tid.size, 1)
    # Thread t takes runs t, t + stride, ...: every run below vectors once.
    runs = (tid[:, None] + stride * np.arange(-(-vectors // stride))).ravel()
    runs = runs[runs < vectors]
    quads = np.concatenate([_half_index(runs, h, vectors) for h in (0, 1)])
    written = np.concatenate([
        np.where(edge < head, edge, edge + probe_trig.VEC * vectors),
        (head + 4 * quads[:, None] + np.arange(4)).ravel()])
    counts = np.bincount(written, minlength=n)
    return counts, (head, vectors, tail, grid)


@pytest.mark.parametrize("misalign", range(4))
def test_plan_covers_every_element_once(misalign):
    for n in [*range(71), (1 << 24) + 3]:
        for sms, per_sm in CARDS:
            counts, (head, vectors, tail, grid) = _written(
                n, misalign, sms, per_sm)
            assert counts.size == n and (counts == 1).all(), (
                n, misalign, sms, per_sm)
            assert head + probe_trig.VEC * vectors + tail == n
            assert 0 <= head < 4 and 0 <= tail < probe_trig.VEC
            # The runs start on a 16-byte boundary.
            assert vectors == 0 or (misalign + head) % 4 == 0
            assert grid <= sms * per_sm
            assert (grid == 0) == (n == 0)
            assert head + tail <= grid * probe_trig.THREADS
            # No block without a run, beyond the one a head or tail needs.
            assert grid <= max(1, -(-vectors // probe_trig.THREADS))


def test_plan_constants_are_the_kernels():
    src = CSRC.read_text()
    assert f"constexpr int kThreads = {probe_trig.THREADS};" in src
    assert f"constexpr int kVec = {probe_trig.VEC};" in src
    assert "return i + w + h * min(32, vectors - w);" in src


def test_a_warps_loads_are_contiguous():
    # Each half of a warp's runs covers its lanes' float4 side by side, the
    # last warp's too.
    for vectors in (32, 33, 95, 96, 1000):
        for w in range(0, vectors, 32):
            lanes = np.arange(w, min(w + 32, vectors))
            for h in (0, 1):
                got = _half_index(lanes, h, vectors)
                assert np.array_equal(got, got[0] + np.arange(lanes.size))


def _rem1(x):
    """The check-only kernel's floor-mod: fmodf, then + 1 where negative."""
    m = np.fmod(x, F32(1))
    return np.where(m < 0, m + F32(1), m).astype(F32)


def _fract(x):
    return (x - np.floor(x)).astype(F32)


def _edge_cases():
    tiny = np.float32(np.finfo(F32).smallest_subnormal)
    base = np.array([-0.0, 0.0, tiny, -tiny, -2.0 ** -25, 2.0 ** -25,
                     0.5, -0.5], F32)
    return np.concatenate([base, np.nextafter(base, F32(1)),
                           np.nextafter(base, F32(-1))])


def test_fract_is_rem1_but_for_the_sign_of_zero():
    g = np.random.default_rng(0)
    x = np.concatenate([_edge_cases(),
                        g.uniform(-0.5, 0.5, 1 << 20).astype(F32)])
    a, b = _rem1(x), _fract(x)
    assert np.array_equal(a, b)
    differ = a.view(np.int32) != b.view(np.int32)
    assert (a[differ] == 0).all()
    # -0.0: rem1 keeps the sign, fract gives +0.0.
    assert np.signbit(_rem1(np.array([-0.0], F32)))[0]
    assert not np.signbit(_fract(np.array([-0.0], F32)))[0]
    # Both are torch.remainder, the plain version's floor-mod, in value.
    assert np.array_equal(b, torch.remainder(torch.tensor(x), 1.0).numpy())


@pytest.mark.parametrize("n", [8 * 128, 1 << 20])
def test_uv_sum_bytes_do_not_depend_on_the_floor_mod(n):
    x = torch.tensor(np.append(np.linspace(-1.0, 1.0, n, dtype=F32),
                               F32(-0.0)))
    # The kernel's u before the floor-mod and its v, in float32.
    a = (torch.atan2(x, -x + F32(0.3)) * F32(1.0 / F32(2 * np.pi))).numpy()
    v = (torch.acos(torch.clamp(x * F32(0.5), -1.0, 1.0))
         * F32(1.0 / F32(np.pi))).numpy()
    with_rem1, with_fract = _rem1(a) + v, _fract(a) + v
    assert with_rem1.dtype == with_fract.dtype == F32
    assert np.array_equal(with_rem1.view(np.int32), with_fract.view(np.int32))
    assert np.signbit(_rem1(a[-1:]))[0]  # the -0.0 point reaches u = -0.0


# cuobjdump -sass listings in its form: a kernel of one element a thread
# (a bounds exit, atan2f's special case, a division's slow-path call, a
# loop only large arguments take), and a kernel with a loop over runs of 8.
SCALAR = """
        Function : _ZN46_GLOBAL__N__14cfcf60_13_probe_trig_cu_58ea4dff10probe_trigEPKfiPf
        /*0000*/                   S2R R0, SR_TID.X ;            /* 0x0000000000007919 */
        /*0010*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;
        /*0020*/               @P0 EXIT ;
        /*0030*/              @!P0 BRA P1, 0xa0 ;
        /*0040*/                   FCHK P0, R0, R9 ;
        /*0050*/              @!P0 BRA 0x80 ;
        /*0060*/                   MOV R2, 0x70 ;
        /*0070*/                   CALL.REL.NOINC 0x100 ;
        /*0080*/                   FADD R1, R1, R1 ;
        /*0090*/                   BRA 0xb0 ;
        /*00a0*/                   MOV R1, RZ ;
        /*00b0*/              @!P0 BRA 0xe0 ;
        /*00c0*/                   FADD R2, R2, 1 ;
        /*00d0*/               @P1 BRA 0xc0 ;
        /*00e0*/                   STG.E desc[UR4][R4.64], R1 ;
        /*00f0*/                   EXIT ;
        /*0100*/                   RET.REL.NODEC R2 0x0 ;
        /*0110*/                   BRA 0x110;
"""
VEC = """
        Function : _ZN46_GLOBAL__N__14cfcf60_13_probe_trig_cu_58ea4dff14probe_trig_vecEPKfiiiPf
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/               @P0 EXIT ;
        /*0020*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0030*/                   FCHK P0, R0, R9 ;
        /*0040*/              @!P0 BRA 0x70 ;
        /*0050*/                   MOV R2, 0x60 ;
        /*0060*/                   CALL.REL.NOINC 0xa0 ;
        /*0070*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0080*/               @P1 BRA 0x20 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   RET.REL.NODEC R2 0x0 ;
"""


# A loop over runs with a loop over its halves inside.
NESTED = """
        Function : _ZN46_GLOBAL__N__14cfcf60_13_probe_trig_cu_58ea4dff14probe_trig_vecEPKfiiiPf
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   FADD R1, R1, 1 ;
        /*0030*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0040*/               @P2 BRA 0x20 ;
        /*0050*/               @P1 BRA 0x10 ;
        /*0060*/                   EXIT ;
"""


def test_sass_walk_runs_an_inner_loop_its_trips():
    (code,) = smoke_lib.sass_functions(NESTED).values()
    assert smoke_lib.sass_per_element(code, 8, 2) == (1 + 2 * 3 + 1) / 8
    assert smoke_lib.sass_per_element(code, 8) == (1 + 3 + 1) / 8


def test_sass_walk_takes_the_path_of_ordinary_inputs(monkeypatch):
    funcs = smoke_lib.sass_functions(SCALAR + VEC)
    scalar, vec = funcs.values()
    path = smoke_lib.sass_path(scalar, 0)
    # Past the special case, over the call and the loop, to the exit.
    assert [ins.split()[0] for ins in path] == [
        "S2R", "ISETP.GE.AND", "@P0", "@!P0", "FCHK", "@!P0", "FADD", "BRA",
        "@!P0", "STG.E", "EXIT"]
    assert smoke_lib.sass_per_element(scalar) == 11
    # The loop's body from its top to its backward branch, over the call.
    assert smoke_lib.sass_per_element(vec, 8) == 5 / 8
    monkeypatch.setattr(smoke_lib, "sass_listing", lambda lib: SCALAR + VEC)
    assert smoke_lib.trig_sass("lib.so") == {"probe_trig": 11,
                                             "probe_trig_vec": 5 / 8}


def test_issue_time_is_instructions_over_the_lanes_a_clock():
    # 128 lane-instructions an SM a clock: 132 SMs at 1 GHz issue
    # 16,896 per ns.
    assert smoke_lib.issue_ms(16896e6, 132, 1000.0) == pytest.approx(1.0)


@pytest.mark.parametrize("offset", range(4))
def test_output_buffer_shares_the_inputs_misalignment(offset):
    storage = torch.zeros(64 + 8)
    x = storage[offset:offset + 64].view(8, 8)
    out = probe_trig.empty_aligned_like(x)
    assert out.shape == x.shape and out.is_contiguous()
    assert probe_trig.misalignment(out) == probe_trig.misalignment(x)
    assert probe_trig.empty_aligned_like(storage[:0]).numel() == 0


def test_uv_sum_on_the_cpu_is_the_plain_version_for_both_entry_points():
    x = probe_trig.points((8, 128), "cpu")
    ref = probe_trig.uv_sum_reference(x)
    before = (probe_trig.LAUNCHES, probe_trig.SCALAR_LAUNCHES)
    assert torch.equal(probe_trig.uv_sum(x), ref)
    assert torch.equal(probe_trig.uv_sum(x, scalar=True), ref)
    assert (probe_trig.LAUNCHES, probe_trig.SCALAR_LAUNCHES) == before
    with pytest.raises(ValueError, match="contiguous float32"):
        probe_trig.uv_sum(x.t())
