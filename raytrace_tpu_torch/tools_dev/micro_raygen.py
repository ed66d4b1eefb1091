"""Dev probe P3: K4's raygen alone, a CUDA kernel
(``csrc/micro_raygen.cu``, which includes K4's own ``csrc/raygen.cuh``)
held against its plain PyTorch version and timed per raygen.

    python3 -m raytrace_tpu_torch.tools_dev.micro_raygen [--device cpu]
        [--shape a|b|both]

Counterpart of tools_dev/micro_raygen.py: for each cell, ``iters`` times,
init_rng + get_rays_v3 with the thin-lens sample, folding the origin, the
direction and one more random_float into a float32 sum (the kernel's
comment gives the loop).  Variants ``base``, ``nodof`` (no lens sample)
and ``packedpx`` (pixel ids packed as py << 11 | px).  Two shapes of the
same function:

- (a) the JAX layout: one (8, 128) block of pixel ids, 8 programs (the
  TPU grid; each program computes the whole block), ITERS = 20,000
  iterations as in the JAX probe;
- (b) the main path's width: a cell per pixel-sample of final-one-weekend,
  1200 x 675 x 4 = 3,240,000 cells (cell c is pixel c mod 810,000), at 1
  iteration (the raygen work of one K4 batch) and at 16.

Constants as the JAX probe's: 1200 x 675, 4 spp (sqrt 2), its camera
table (view identity, projection diag(1.2, 2.1, -1, 1) inverted, focal
length 10, aperture 0.2), in K4's parameter layout.  Each variant and
shape is held bit for bit against the plain version at 4 iterations, and
two launches must give the same bytes.  ``raygen_sums`` is the one entry
point: the plain version for CPU tensors, the kernel for CUDA tensors (or
it raises).  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import sys
import time

import numpy as np
import torch

from ..ops import _build, camera, rng
from ..tools import smoke_lib
from . import _common

WIDTH, HEIGHT, SPP, SQRT_SPP = 1200, 675, 4, 2
ITERS = 20000
PROGRAMS = 8          # shape (a): the TPU grid over one block
CHECK_ITERS = 4       # the bit-for-bit check's iterations
FULL_ITERS = (1, 16)  # shape (b)'s timed iteration counts
VARIANTS = ("base", "nodof", "packedpx")
N_PARAMS = 40         # K4's float parameter block (csrc/megakernel.cu)

LAUNCHES = 0


def camera_params(device) -> torch.Tensor:
    """The JAX probe's camera in K4's [40] float layout (ops/megakernel.py
    _float_params): view inverse, projection inverse (row-major), focal
    length, aperture, the sky (unused), 1 / sqrt_spp, the lights
    (unused)."""
    p = np.zeros(N_PARAMS, np.float32)
    p[0:16] = np.eye(4).reshape(16)
    p[16:32] = np.linalg.inv(np.diag([1.2, 2.1, -1.0, 1.0])).reshape(16)
    p[32], p[33] = 10.0, 0.2
    p[37] = np.float32(1.0 / SQRT_SPP)
    return torch.tensor(p, device=device)


def pixels(variant: str, shape: str, device) -> torch.Tensor:
    """The cells' pixel ids, int32: shape "a" the (8, 128) block of the
    JAX probe (pixel ids 0..1023, or packed y << 11 | x), shape "b" one
    cell per pixel-sample of a 1200 x 675 x 4 batch."""
    if shape == "a":
        if variant == "packedpx":
            yy, xx = np.meshgrid(np.arange(8), np.arange(128), indexing="ij")
            pix = yy * 2048 + xx
        else:
            pix = np.arange(8 * 128).reshape(8, 128)
    elif shape == "b":
        p = np.arange(WIDTH * HEIGHT * SPP) % (WIDTH * HEIGHT)
        pix = (p // WIDTH) << 11 | p % WIDTH if variant == "packedpx" else p
    else:
        raise ValueError(f"shape must be 'a' or 'b', not {shape!r}")
    return torch.tensor(pix.astype(np.int32), device=device)


def raygen_steps(params: torch.Tensor, pix: torch.Tensor, iters: int,
                 variant: str):
    """The plain version's loop: for each iteration, the (PCG state after
    the last draw, origin, direction, last random float) of every cell,
    from ops/rng.py and ops/camera.py get_rays_v3."""
    cam = camera.CameraArrays(params[0:16].reshape(4, 4),
                              params[16:32].reshape(4, 4), params[32],
                              params[33])
    p = pix.reshape(-1).to(torch.int64)
    if variant == "packedpx":
        px, py = p & 2047, p >> 11
    else:
        px, py = p % WIDTH, p // WIDTH
    sip = torch.zeros_like(p)
    for it in range(iters):
        batch, s = sip // SPP, sip % SPP
        st = rng.init_rng(batch, s, py, px, WIDTH, HEIGHT, SPP)
        st = (st + it) & 0xFFFFFFFF
        st, o, d = camera.get_rays_v3(st, cam, px, py, s % SQRT_SPP,
                                      s // SQRT_SPP, WIDTH, HEIGHT, SQRT_SPP,
                                      use_dof=variant != "nodof")
        st, f = rng.random_float(st)
        yield st, o, d, f
        sip = (sip + 1) % (SPP * 24)


def raygen_reference(params: torch.Tensor, pix: torch.Tensor, iters: int,
                     variant: str) -> torch.Tensor:
    """The plain version: the [pix.numel()] sums of raygen_steps."""
    acc = torch.zeros(pix.numel(), dtype=torch.float32, device=pix.device)
    for _, o, d, f in raygen_steps(params, pix, iters, variant):
        acc = acc + o.x + o.y + o.z + d.x + d.y + d.z + f
    return acc


def raygen_sums(params: torch.Tensor, pix: torch.Tensor, iters: int,
                variant: str, programs: int = 1) -> torch.Tensor:
    """[programs, pix.numel()] sums, each program's row the whole function
    of the cells."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    if (params.dtype != torch.float32 or params.shape != (N_PARAMS,)
            or not params.is_contiguous() or params.device != pix.device):
        raise ValueError(f"params must be a contiguous float32 [{N_PARAMS}] "
                         "tensor on the pixels' device")
    if pix.dtype != torch.int32 or not pix.is_contiguous():
        raise ValueError("pix must be a contiguous int32 tensor")
    if iters < 0 or programs < 1:
        raise ValueError("iters must be >= 0 and programs >= 1")
    if pix.device.type == "cpu":
        return raygen_reference(params, pix, iters, variant).expand(
            programs, -1).clone()
    if pix.device.type != "cuda":
        raise ValueError(f"no micro_raygen kernel for device {pix.device}")
    lib = library()
    out = torch.empty((programs, pix.numel()), dtype=torch.float32,
                      device=pix.device)
    stream = torch.cuda.current_stream(pix.device).cuda_stream
    err = lib.micro_raygen_launch(
        params.data_ptr(), pix.data_ptr(), pix.numel(), iters, WIDTH, HEIGHT,
        SQRT_SPP, VARIANTS.index(variant), programs, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"micro_raygen launch failed: CUDA error {err} "
                           f"({lib.micro_raygen_error_string(err).decode()})")
    LAUNCHES += 1
    return out


def check(params, pix, variant: str, programs: int) -> dict:
    """The kernel (or, on the CPU, the wrapper) against the plain version
    at CHECK_ITERS iterations: every program's row bit for bit, and two
    launches byte-identical."""
    a = raygen_sums(params, pix, CHECK_ITERS, variant, programs)
    b = raygen_sums(params, pix, CHECK_ITERS, variant, programs)
    ref = raygen_reference(params, pix, CHECK_ITERS, variant)
    return dict(bitwise=all(torch.equal(row, ref) for row in a),
                repeat_identical=torch.equal(a, b),
                max_abs_err=float((a - ref).abs().max()))


@functools.cache
def library() -> ctypes.CDLL:
    """The probe's shared library, built from csrc/ at first use."""
    lib = _build.load_library("micro_raygen")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.micro_raygen_launch.argtypes = [p, p, i, i, i, i, i, i, i, p, p]
    lib.micro_raygen_launch.restype = i
    lib.micro_raygen_error_string.argtypes = [i]
    lib.micro_raygen_error_string.restype = ctypes.c_char_p
    return lib


def _options(parser) -> None:
    parser.add_argument("--shape", choices=("a", "b", "both"),
                        default="both")


def main(argv=None) -> dict:
    """Checks and times each variant at the chosen shapes and prints a line
    each; raises if any check fails.  Returns {variant: {run: {...}}} with
    run "a" (shape (a) at ITERS) and "b1", "b16" (shape (b)); the times
    (CUDA-event medians of 5) and ns per raygen only on the card, and the
    plain version's time at one iteration ("b1")."""
    args = _common.parse(argv, __doc__, _options)
    dev = args.device
    print(_common.card_line(dev))
    params = camera_params(dev)
    shapes = ("a", "b") if args.shape == "both" else (args.shape,)
    results, failed = {}, []
    for variant in VARIANTS:
        results[variant] = {}
        for shape in shapes:
            pix = pixels(variant, shape, dev)
            programs = PROGRAMS if shape == "a" else 1
            t0 = time.perf_counter()
            chk = check(params, pix, variant, programs)
            seconds = time.perf_counter() - t0
            if not (chk["bitwise"] and chk["repeat_identical"]):
                failed.append((variant, shape))
            runs = ([("a", ITERS)] if shape == "a"
                    else [(f"b{k}", k) for k in FULL_ITERS])
            for run, iters in runs:
                res = dict(chk, cells=pix.numel() * programs, iters=iters,
                           check_seconds=seconds)
                if dev.type == "cuda":
                    res["ms"] = smoke_lib.median_ms(lambda: raygen_sums(
                        params, pix, iters, variant, programs))
                    res["ns_per_raygen"] = (res["ms"] * 1e6
                                            / (res["cells"] * iters))
                    if run == "b1":
                        res["plain_ms"] = smoke_lib.median_ms(
                            lambda: raygen_reference(params, pix, 1, variant))
                results[variant][run] = res
                print(f"[{variant:10s}] {run:3s} {res['cells']} cells x "
                      f"{iters} iters: bit for bit at {CHECK_ITERS} iters "
                      f"{chk['bitwise']}, "
                      f"repeat identical {chk['repeat_identical']}"
                      + (f"; {res['ms']:.4f} ms, {res['ns_per_raygen']:.4f} "
                         "ns/raygen" if "ms" in res else "")
                      + (f", plain {res['plain_ms']:.4f} ms"
                         if "plain_ms" in res else ""), flush=True)
    if failed:
        raise AssertionError(f"micro_raygen: kernel and plain version differ "
                             f"at {CHECK_ITERS} iterations: {failed}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
