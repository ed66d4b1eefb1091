"""Dev probe P2: the sphere-UV trigonometry of K4's image form, a CUDA
kernel (``csrc/probe_trig.cu``) held against its plain PyTorch version.

    python3 -m raytrace_tpu_torch.tools_dev.probe_trig [--device cpu]

Counterpart of tools_dev/probe_trig.py, which checked that Mosaic lowers
arctan2 and arccos: ``u = (atan2(x, -x + 0.3) / 2 pi) mod 1``, ``v =
acos(clip(x * 0.5, -1, 1)) / pi``, out ``u + v``.  Runs at the probe's
(8, 128) ``linspace(-1, 1)`` and at 2^24 points of the same range, and
prints for each the max abs error and the differing elements against the
plain version on the same device (as the JAX probe prints against XLA),
and the max error in ulps against float64 numpy.  ``uv_sum`` is the one
entry point: the plain version for CPU tensors, the kernel for CUDA
tensors (or it raises).  ``LAUNCHES`` counts kernel launches.
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

LAUNCHES = 0


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


def uv_sum(x: torch.Tensor) -> torch.Tensor:
    """u + v of every element of x (float32, contiguous)."""
    global LAUNCHES
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 tensor")
    if x.device.type == "cpu":
        return uv_sum_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"no probe_trig kernel for device {x.device}")
    lib = library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.probe_trig_launch(x.data_ptr(), x.numel(), out.data_ptr(),
                                stream)
    if err != 0:
        raise RuntimeError(f"probe_trig launch failed: CUDA error {err} "
                           f"({lib.probe_trig_error_string(err).decode()})")
    LAUNCHES += 1
    return out


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
    lib.probe_trig_launch.argtypes = [p, i, p, p]
    lib.probe_trig_launch.restype = i
    lib.probe_trig_error_string.argtypes = [i]
    lib.probe_trig_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> dict:
    """Runs the probe at both sizes and prints a line each; raises if the
    kernel and the plain version differ by more than ULP_TOL ulps.
    Returns {size: {n, seconds, max_abs_err, differing, ulps,
    ulps_vs_float64, ms, plain_ms}}, the times (CUDA-event medians of 5)
    only on the card."""
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
                   ulps_vs_float64=ulps_vs_float64(x, out))
        if dev.type == "cuda":
            res["ms"] = smoke_lib.median_ms(lambda: uv_sum(x))
            res["plain_ms"] = smoke_lib.median_ms(
                lambda: uv_sum_reference(x))
        results[size] = res
        ok = res["ulps"] <= ULP_TOL
        print(f"{'cuda' if dev.type == 'cuda' else 'plain'} arctan2+arccos "
              f"{'OK' if ok else 'FAIL'} at {tuple(shape)} (build+run "
              f"{seconds:.1f}s); max abs err vs plain "
              f"{res['max_abs_err']:.3e}, differing elems "
              f"{res['differing']}/{res['n']}; max "
              f"{res['ulps_vs_float64']:.3f} ulp vs float64"
              + (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f}"
                 " ms" if "ms" in res else ""))
    bad = [s for s, r in results.items() if r["ulps"] > ULP_TOL]
    if bad:
        raise AssertionError(f"probe_trig: kernel and plain version differ "
                             f"by more than {ULP_TOL} ulps at {bad}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
