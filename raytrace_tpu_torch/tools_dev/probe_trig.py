"""Dev probe P2: the sphere-UV trigonometry of K4's image form, a CUDA
kernel (``csrc/probe_trig.cu``) held against its plain PyTorch version.

    python3 -m raytrace_tpu_torch.tools_dev.probe_trig [--device cpu]

Counterpart of tools_dev/probe_trig.py, which checked that Mosaic lowers
arctan2 and arccos: ``u = (atan2(x, -x + 0.3) / 2 pi) mod 1``, ``v =
acos(clip(x * 0.5, -1, 1)) / pi``, out ``u + v``.  Runs at the probe's
(8, 128) ``linspace(-1, 1)`` and at 2^24 points of the same range, and
prints for each the max abs error and the differing elements against the
plain version on the same device (as the JAX probe prints against XLA),
the max error in ulps against float64 numpy and, on the card, whether the
kernel gives the check-only kernel's bytes.  ``uv_sum`` is the one entry
point: the plain version for CPU tensors, the kernel for CUDA tensors (or
it raises): 8 floats a thread over a grid of the blocks resident at once,
split as ``plan`` says; with ``scalar=True`` the kernel as first ported,
one element a thread, a check-only entry point.  ``LAUNCHES`` counts the
kernel's launches, ``SCALAR_LAUNCHES`` the check-only kernel's.
"""

from __future__ import annotations

import ctypes
import functools
import sys
import time

import numpy as np
import torch

from ..ops import _build
from ..tools import smoke_lib
from . import _common

SIZES = {"probe": (8, 128), "large": (1 << 24,)}
# The kernel against the plain version on the card: atan2f and acosf are
# the same library calls on both sides, so bit for bit is expected; this
# many ulps are allowed.
ULP_TOL = 2
# The kernel's block and the floats a thread takes an iteration (two
# 16-byte loads), as csrc/probe_trig.cu holds them.
THREADS = 256
VEC = 8

LAUNCHES = 0
SCALAR_LAUNCHES = 0


def points(shape, device) -> torch.Tensor:
    """linspace(-1, 1) over ``shape``'s elements, float32."""
    n = int(np.prod(shape))
    return torch.tensor(np.linspace(-1.0, 1.0, n, dtype=np.float32),
                        device=device).reshape(shape)


def uv_sum_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version, in the probe's operations."""
    u = torch.remainder(torch.atan2(x, -x + 0.3) / (2.0 * np.pi), 1.0)
    v = torch.acos(torch.clamp(x * 0.5, -1.0, 1.0)) / np.pi
    return u + v


def plan(n: int, misalign: int, sms: int, blocks_per_sm: int):
    """The kernel's split of n elements whose first lies ``misalign``
    floats (0-3) past a 16-byte boundary: (head, vectors, tail, grid),
    ``head`` elements up to the boundary, ``vectors`` runs of VEC, ``tail``
    after them, over ``grid`` blocks: as many as the runs need, at most the
    ``sms * blocks_per_sm`` resident at once, one for a head or tail alone,
    none for no element."""
    head = min(n, (4 - misalign) % 4)
    vectors = (n - head) // VEC
    tail = n - head - VEC * vectors
    grid = 0 if n == 0 else max(1, min(sms * blocks_per_sm,
                                       -(-vectors // THREADS)))
    return head, vectors, tail, grid


def misalignment(t: torch.Tensor) -> int:
    """Floats from the last 16-byte boundary to ``t``'s first element."""
    return t.data_ptr() % 16 // 4


def empty_aligned_like(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of x's shape whose first element lies as far past
    a 16-byte boundary as x's (so one split serves both)."""
    m = misalignment(x)
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    start = (m - misalignment(buf)) % 4
    return buf[start:start + x.numel()].view(x.shape)


def uv_sum(x: torch.Tensor, scalar: bool = False) -> torch.Tensor:
    """u + v of every element of x (float32, contiguous).  ``scalar``: on
    the card, the check-only kernel as first ported."""
    global LAUNCHES, SCALAR_LAUNCHES
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 tensor")
    if x.device.type == "cpu":
        return uv_sum_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"no probe_trig kernel for device {x.device}")
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if scalar:
        out = torch.empty_like(x)
        err = lib.probe_trig_launch_scalar(x.data_ptr(), x.numel(),
                                           out.data_ptr(), stream)
    else:
        out = empty_aligned_like(x)
        err = lib.probe_trig_launch(x.data_ptr(), x.numel(), out.data_ptr(),
                                    stream)
    if err != 0:
        raise RuntimeError(f"probe_trig launch failed: CUDA error {err} "
                           f"({lib.probe_trig_error_string(err).decode()})")
    if scalar:
        SCALAR_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def card_plan(n: int, misalign: int):
    """(head, vectors, tail, grid, resident blocks): the split the C
    launcher takes on the current card."""
    out = (ctypes.c_int * 5)()
    err = library().probe_trig_plan(n, misalign, out)
    if err != 0:
        raise RuntimeError(f"probe_trig_plan failed: CUDA error {err}")
    return tuple(out)


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def ulps_vs_float64(x: torch.Tensor, out: torch.Tensor) -> float:
    """The largest error of ``out`` in float32 ulps of the exact value,
    computed in float64 numpy from the same float32 inputs (in chunks of
    2^20, to bound the host memory)."""
    xs, outs = x.cpu().numpy().reshape(-1), out.cpu().numpy().reshape(-1)
    worst = 0.0
    for i in range(0, xs.size, 1 << 20):
        x64 = xs[i:i + (1 << 20)].astype(np.float64)
        ref = (np.remainder(np.arctan2(x64, -x64 + 0.3) / (2.0 * np.pi), 1.0)
               + np.arccos(np.clip(x64 * 0.5, -1.0, 1.0)) / np.pi)
        ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
        got = outs[i:i + (1 << 20)].astype(np.float64)
        worst = max(worst, float(np.max(np.abs(got - ref) / ulp)))
    return worst


@functools.cache
def library() -> ctypes.CDLL:
    """The probe's shared library, built from csrc/ at first use."""
    lib = _build.load_library("probe_trig")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.probe_trig_launch, lib.probe_trig_launch_scalar):
        fn.argtypes = [p, i, p, p]
        fn.restype = i
    lib.probe_trig_plan.argtypes = [i, i, ctypes.POINTER(i)]
    lib.probe_trig_plan.restype = i
    lib.probe_trig_error_string.argtypes = [i]
    lib.probe_trig_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> dict:
    """Runs the probe at both sizes and prints a line each; raises if the
    kernel and the plain version differ by more than ULP_TOL ulps, or the
    kernel and the check-only kernel by a byte.  Returns {size: {n,
    seconds, max_abs_err, differing, ulps, ulps_vs_float64,
    scalar_identical, ms, scalar_ms, plain_ms}}, the times (CUDA-event
    medians of 5) only on the card."""
    args = _common.parse(argv, __doc__)
    dev = args.device
    print(_common.card_line(dev))
    results = {}
    for size, shape in SIZES.items():
        x = points(shape, dev)
        t0 = time.perf_counter()
        out = uv_sum(x)
        _common.sync(dev)
        seconds = time.perf_counter() - t0
        ref = uv_sum_reference(x)
        res = dict(n=x.numel(), seconds=seconds,
                   max_abs_err=float((out - ref).abs().max()),
                   differing=int((out != ref).sum()),
                   ulps=_common.max_ulps(out, ref),
                   ulps_vs_float64=ulps_vs_float64(x, out),
                   scalar_identical=same_bytes(out, uv_sum(x, scalar=True)))
        if dev.type == "cuda":
            res["ms"] = smoke_lib.median_ms(lambda: uv_sum(x))
            res["scalar_ms"] = smoke_lib.median_ms(
                lambda: uv_sum(x, scalar=True))
            res["plain_ms"] = smoke_lib.median_ms(
                lambda: uv_sum_reference(x))
        results[size] = res
        ok = res["ulps"] <= ULP_TOL and res["scalar_identical"]
        print(f"{'cuda' if dev.type == 'cuda' else 'plain'} arctan2+arccos "
              f"{'OK' if ok else 'FAIL'} at {tuple(shape)} (build+run "
              f"{seconds:.1f}s); max abs err vs plain "
              f"{res['max_abs_err']:.3e}, differing elems "
              f"{res['differing']}/{res['n']}; max "
              f"{res['ulps_vs_float64']:.3f} ulp vs float64; byte for byte "
              f"with the check-only kernel {res['scalar_identical']}"
              + (f"; kernel {res['ms']:.4f} ms, check-only kernel "
                 f"{res['scalar_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms"
                 if "ms" in res else ""))
    bad = [s for s, r in results.items() if r["ulps"] > ULP_TOL]
    if bad:
        raise AssertionError(f"probe_trig: kernel and plain version differ "
                             f"by more than {ULP_TOL} ulps at {bad}")
    bad = [s for s, r in results.items() if not r["scalar_identical"]]
    if bad:
        raise AssertionError(f"probe_trig: kernel and check-only kernel "
                             f"differ at {bad}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
