"""Dev probe P1: ten op-support probes, each a CUDA kernel
(``csrc/probe_ops.cu``) held against its plain PyTorch version.

    python3 -m raytrace_tpu_torch.tools_dev.probe_ops [--device cpu]

Counterpart of tools_dev/probe_pallas.py, which compiled each operation
the TPU's fused kernel needs as a tiny Pallas kernel and checked it
against XLA.  Here each probe runs on the card at the JAX probe's shapes
((8, 128) inputs; the fetch probe a [32, 544] table and 128 ids; the
table probes a [64, 8] table) and prints ``PASS/FAIL name: build+run s,
max err`` against its plain version on the same device.  ``probe`` is the
one entry point: for tensors on the CPU it runs the plain version; for
CUDA tensors it launches the kernel on the current stream, or raises.
``LAUNCHES`` counts each probe's kernel launches.

Agreement: the integer, gather, scalar-read, loop and branch probes bit
for bit; ``sin+cos`` and ``pow-exp-log`` (library transcendentals) within
``TRANSCENDENTAL_ATOL`` of the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _build, rng
from ..tools import smoke_lib
from . import _common

PROBES = ("sin+cos", "pcg-rng", "onehot-fetch", "smem-scalar-loop",
          "while-loop", "lax-cond-datadep", "pl-when-datadep",
          "vmem-scalar-read", "vmem-dynrow-read", "pow-exp-log")
# Probes whose functions are sinf/cosf or expf/logf: the kernel's library
# calls and PyTorch's may round differently, by this much at most (2 ulps
# of 1.0: their terms lie in [-1, 2], and sin + cos cancels near zero, so
# the bound is absolute).
TRANSCENDENTAL = ("sin+cos", "pow-exp-log")
TRANSCENDENTAL_ATOL = 2.0 ** -22
WHILE_COUNT = 10   # the while loop's trip count (probe_pallas.py:87)
SCALAR_ROW = 3     # vmem-scalar-read's row (:107)
DYN_ROW = 5        # vmem-dynrow-read's runtime row (:114)
BLOCK_SUM_MAX = 1024  # the one block that sums the branch probes' input
SMEM_MAX = 48 * 1024  # static launch limit of the staged table, bytes

LAUNCHES = dict.fromkeys(PROBES, 0)


class ProbeInputs(NamedTuple):
    """The JAX probe's inputs: x, u (uint32 bits in int32), the fetch
    probe's rows_t and prim ids, and the scalar probes' table."""

    x: torch.Tensor       # [8, 128] f32, linspace(0.1, 6.0)
    u: torch.Tensor       # [8, 128] int32: arange * 2654435761 mod 2^32
    rows_t: torch.Tensor  # [32, 544] f32
    prim: torch.Tensor    # [1, 128] int32 in [0, 544)
    tab: torch.Tensor     # [64, 8] f32

    def args(self, name: str) -> tuple:
        """The (x, tab) a probe takes."""
        if name == "pcg-rng":
            return self.u, None
        if name == "onehot-fetch":
            return self.prim, self.rows_t
        if name in ("smem-scalar-loop", "vmem-scalar-read",
                    "vmem-dynrow-read"):
            return self.x, self.tab
        return self.x, None


def make_inputs(device, seed: int = 0) -> ProbeInputs:
    """probe_pallas.main's inputs, the random ones from ``seed``."""
    g = np.random.default_rng(seed)
    u = (np.arange(8 * 128, dtype=np.uint32) * np.uint32(2654435761))
    arrays = (
        np.linspace(0.1, 6.0, 8 * 128, dtype=np.float32).reshape(8, 128),
        u.view(np.int32).reshape(8, 128),
        g.random((32, 544), dtype=np.float32),
        g.integers(0, 544, (1, 128)).astype(np.int32),
        g.random((64, 8), dtype=np.float32),
    )
    return ProbeInputs(*(torch.tensor(a, device=device) for a in arrays))


def probe_reference(name: str, x: torch.Tensor, tab=None) -> torch.Tensor:
    """The plain version of probe ``name``, in the kernel's operation
    order."""
    if name == "sin+cos":
        return torch.sin(x) + torch.cos(x)
    if name == "pcg-rng":
        # ops/rng.py's int64 emulation of the uint32 step and word.
        return rng.random_float(x.to(torch.int64) & 0xFFFFFFFF)[1]
    if name == "onehot-fetch":
        return tab[:, x.reshape(-1).to(torch.int64)]
    if name == "smem-scalar-loop":
        acc = torch.zeros_like(x)
        for r in range(tab.shape[0]):
            acc = acc + tab[r, 0] * x
        return acc
    if name == "while-loop":
        acc = torch.zeros_like(x)
        k = 0
        while k < WHILE_COUNT:
            acc = acc + x
            k += 1
        return acc
    if name == "lax-cond-datadep":
        return torch.where(x.sum() > 0, x * 2.0, x)
    if name == "pl-when-datadep":
        return torch.where(x.sum() > 1e9, x * 3.0, x)
    if name == "vmem-scalar-read":
        return tab[SCALAR_ROW, 0] * x
    if name == "vmem-dynrow-read":
        return tab[DYN_ROW, 0] * x
    if name == "pow-exp-log":
        xs = x * 0.1
        b = 1.0 - xs
        b2 = b * b
        b4 = b2 * b2   # JAX's integer_pow(b, 5): b * ((b * b) * (b * b))
        return b * b4 + torch.exp(-xs) + torch.log(xs + 1.0)
    raise ValueError(f"no probe {name!r}; probes: {PROBES}")


def _check_inputs(name: str, x: torch.Tensor, tab) -> None:
    if name not in PROBES:
        raise ValueError(f"no probe {name!r}; probes: {PROBES}")
    want = torch.int32 if name in ("pcg-rng", "onehot-fetch") else (
        torch.float32)
    if x.dtype != want or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: x must be a contiguous non-empty {want} "
                         "tensor")
    needs_tab = name in ("onehot-fetch", "smem-scalar-loop",
                         "vmem-scalar-read", "vmem-dynrow-read")
    if needs_tab != (tab is not None):
        raise ValueError(f"{name}: " + ("needs" if needs_tab else "takes no")
                         + " table")
    if tab is not None:
        if (tab.dtype != torch.float32 or tab.dim() != 2
                or not tab.is_contiguous() or tab.device != x.device):
            raise ValueError(f"{name}: the table must be a contiguous "
                             "float32 [rows, cols] tensor on x's device")
        row = {"vmem-scalar-read": SCALAR_ROW,
               "vmem-dynrow-read": DYN_ROW}.get(name, 0)
        if tab.shape[0] <= row:
            raise ValueError(f"{name}: the table needs a row {row}")
        if name == "smem-scalar-loop" and tab.numel() * 4 > SMEM_MAX:
            raise ValueError(f"{name}: the table must fit {SMEM_MAX} bytes "
                             "of shared memory")
    if (name in ("lax-cond-datadep", "pl-when-datadep")
            and x.numel() > BLOCK_SUM_MAX):
        raise ValueError(f"{name}: the block-wide sum takes at most "
                         f"{BLOCK_SUM_MAX} elements")


def probe(name: str, x: torch.Tensor, tab=None) -> torch.Tensor:
    """Probe ``name`` on x (and its table): the kernel for CUDA tensors,
    the plain version for CPU tensors.  The output has x's shape (the
    fetch probe's [rows, x.numel()])."""
    _check_inputs(name, x, tab)
    if x.device.type == "cpu":
        return probe_reference(name, x, tab)
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernels for device {x.device}")
    lib = library()
    n = x.numel()
    rows, cols = tab.shape if tab is not None else (0, 0)
    shape = (rows, n) if name == "onehot-fetch" else x.shape
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    arg = {"while-loop": WHILE_COUNT, "vmem-dynrow-read": DYN_ROW}.get(name, 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.probe_ops_launch(
        PROBES.index(name), x.data_ptr(),
        tab.data_ptr() if tab is not None else None, n, rows, cols, arg,
        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"probe_ops {name} launch failed: CUDA error {err}"
                           f" ({lib.probe_ops_error_string(err).decode()})")
    LAUNCHES[name] += 1
    return out


def agrees(name: str, out: torch.Tensor, ref: torch.Tensor) -> bool:
    """The kernel's agreement with the plain version: bit for bit, or
    within TRANSCENDENTAL_ATOL for the transcendental probes."""
    if out.shape != ref.shape:
        return False
    if name in TRANSCENDENTAL:
        return bool((out - ref).abs().max() <= TRANSCENDENTAL_ATOL)
    return torch.equal(out, ref)


@functools.cache
def library() -> ctypes.CDLL:
    """The probes' shared library, built from csrc/ at first use."""
    lib = _build.load_library("probe_ops")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_ops_launch.argtypes = [i, p, p, i, i, i, i, p, p]
    lib.probe_ops_launch.restype = i
    lib.probe_ops_error_string.argtypes = [i]
    lib.probe_ops_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> dict:
    """Runs the ten probes and prints a line each; raises if any fails.
    Returns {probe: {seconds, max_abs_err, ulps, ok, ms, plain_ms}}, the
    times (CUDA-event medians of 5) only on the card."""
    args = _common.parse(argv, __doc__)
    dev = args.device
    print(_common.card_line(dev))
    inp = make_inputs(dev)
    results = {}
    for name in PROBES:
        t0 = time.perf_counter()
        out = probe(name, *inp.args(name))
        _common.sync(dev)
        seconds = time.perf_counter() - t0
        ref = probe_reference(name, *inp.args(name))
        err = float((out - ref).abs().max())
        ok = agrees(name, out, ref)
        res = dict(seconds=seconds, max_abs_err=err,
                   ulps=_common.max_ulps(out, ref), ok=ok)
        if dev.type == "cuda":
            res["ms"] = smoke_lib.median_ms(
                lambda: probe(name, *inp.args(name)))
            res["plain_ms"] = smoke_lib.median_ms(
                lambda: probe_reference(name, *inp.args(name)))
        results[name] = res
        print(f"{'PASS' if ok else 'FAIL'} {name}: build+run {seconds:.1f}s "
              f"maxerr={err:.3e} ({res['ulps']} ulp)"
              + (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f}"
                 " ms" if "ms" in res else ""))
    failed = [name for name, res in results.items() if not res["ok"]]
    if failed:
        raise AssertionError(f"probes disagree with their plain versions: "
                             f"{failed}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
