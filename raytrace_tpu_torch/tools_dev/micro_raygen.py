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
two launches must give the same bytes; on the card each timed run is also
held byte for byte to the sequential entry point at its own iterations.
``raygen_sums`` is the one entry point: the plain version for CPU
tensors, the kernel for CUDA tensors (or it raises): where the cells do
not fill the card (``splits``, shape (a)) the kernel that spreads each
cell's iterations over a block, else one thread a cell; with
``sequential=True`` the loop one thread a cell as it ran before the
split, a check-only entry point.  ``LAUNCHES`` counts the launches of the
first two, ``SPLIT_LAUNCHES`` those of the split kernel among them.
``raygen_terms`` and ``ordered_sum`` are the split kernel's plain model:
any range of iterations' seven terms from the closed form, and their sum
in iteration order.
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
PERIOD = SPP * 24     # the iterations after which sip repeats
# Resident threads a multiprocessor (Hopper): below this many cells a
# multiprocessor, one thread a cell leaves the card part idle.
THREADS_PER_SM = 2048

LAUNCHES = 0
SPLIT_LAUNCHES = 0


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


def _camera(params: torch.Tensor) -> camera.CameraArrays:
    return camera.CameraArrays(params[0:16].reshape(4, 4),
                               params[16:32].reshape(4, 4), params[32],
                               params[33])


def _pixel(pix: torch.Tensor, variant: str):
    p = pix.reshape(-1).to(torch.int64)
    if variant == "packedpx":
        return p & 2047, p >> 11
    return p % WIDTH, p // WIDTH


def _raygen(cam, px, py, it: int, sip: torch.Tensor, variant: str):
    """One iteration's (PCG state after the last draw, origin, direction,
    last random float) of every cell at sample-in-period ``sip``."""
    batch, s = sip // SPP, sip % SPP
    st = rng.init_rng(batch, s, py, px, WIDTH, HEIGHT, SPP)
    st = (st + it) & 0xFFFFFFFF
    st, o, d = camera.get_rays_v3(st, cam, px, py, s % SQRT_SPP,
                                  s // SQRT_SPP, WIDTH, HEIGHT, SQRT_SPP,
                                  use_dof=variant != "nodof")
    st, f = rng.random_float(st)
    return st, o, d, f


def raygen_steps(params: torch.Tensor, pix: torch.Tensor, iters: int,
                 variant: str):
    """The plain version's loop: for each iteration, the (PCG state after
    the last draw, origin, direction, last random float) of every cell,
    from ops/rng.py and ops/camera.py get_rays_v3."""
    cam = _camera(params)
    px, py = _pixel(pix, variant)
    sip = torch.zeros_like(px)
    for it in range(iters):
        yield _raygen(cam, px, py, it, sip, variant)
        sip = (sip + 1) % PERIOD


def raygen_reference(params: torch.Tensor, pix: torch.Tensor, iters: int,
                     variant: str) -> torch.Tensor:
    """The plain version: the [pix.numel()] sums of raygen_steps."""
    acc = torch.zeros(pix.numel(), dtype=torch.float32, device=pix.device)
    for _, o, d, f in raygen_steps(params, pix, iters, variant):
        acc = acc + o.x + o.y + o.z + d.x + d.y + d.z + f
    return acc


def raygen_terms(params: torch.Tensor, pix: torch.Tensor, it0: int, it1: int,
                 variant: str) -> torch.Tensor:
    """[it1 - it0, 7, pix.numel()]: the seven terms (o.x, o.y, o.z, d.x,
    d.y, d.z, the last random float) of iterations it0..it1-1 of every
    cell, each from the closed form sip = it mod PERIOD, as a producer
    warp of the split kernel computes them."""
    cam = _camera(params)
    px, py = _pixel(pix, variant)
    rows = []
    for it in range(it0, it1):
        _, o, d, f = _raygen(cam, px, py, it,
                             torch.full_like(px, it % PERIOD), variant)
        rows.append(torch.stack([o.x, o.y, o.z, d.x, d.y, d.z, f]))
    return torch.stack(rows) if rows else torch.zeros(
        (0, 7, pix.numel()), dtype=torch.float32, device=pix.device)


def ordered_sum(terms: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """acc plus raygen_terms' terms, seven dependent adds an iteration in
    iteration order, as the split kernel's consumer lane adds them."""
    for k in range(terms.shape[0]):
        for j in range(7):
            acc = acc + terms[k, j]
    return acc


def splits(cells: int, sms: int) -> bool:
    """Whether ``cells`` (pixel ids x programs) take the split kernel on a
    card of ``sms`` multiprocessors: fewer than fill it one thread a
    cell."""
    return cells < sms * THREADS_PER_SM


def divisor(d: int):
    """(m, sh1, sh2) for the kernel's division n / d of an n in [0, 2^31):
    the branch-free unsigned form of Granlund and Montgomery, with l =
    ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1 < 2^32."""
    if not 1 <= d < 1 << 31:
        raise ValueError(f"divisor {d} must lie in [1, 2^31)")
    lg = (d - 1).bit_length()
    return ((1 << 32) * ((1 << lg) - d)) // d + 1, min(lg, 1), max(lg - 1, 0)


def divide(n, div):
    """The kernel's n / d for int64 n in [0, 2^31) (numpy arrays or ints)
    by divisor(d)'s (m, sh1, sh2), in uint32 arithmetic."""
    m, sh1, sh2 = div
    t = (n * m) >> 32
    return (t + ((n - t) >> sh1)) >> sh2


def raygen_sums(params: torch.Tensor, pix: torch.Tensor, iters: int,
                variant: str, programs: int = 1,
                sequential: bool = False) -> torch.Tensor:
    """[programs, pix.numel()] sums, each program's row the whole function
    of the cells.  ``sequential``: on the card, the check-only loop one
    thread a cell (counted in no launch count)."""
    global LAUNCHES, SPLIT_LAUNCHES
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
    if sequential:
        err = lib.micro_raygen_sequential_launch(
            params.data_ptr(), pix.data_ptr(), pix.numel(), iters, WIDTH,
            HEIGHT, SQRT_SPP, VARIANTS.index(variant), programs,
            out.data_ptr(), stream)
    else:
        split = splits(pix.numel() * programs, torch.cuda.get_device_properties(
            pix.device).multi_processor_count)
        err = lib.micro_raygen_launch(
            params.data_ptr(), pix.data_ptr(), pix.numel(), iters, WIDTH,
            HEIGHT, SQRT_SPP, *divisor(WIDTH), VARIANTS.index(variant),
            programs, int(split), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"micro_raygen launch failed: CUDA error {err} "
                           f"({lib.micro_raygen_error_string(err).decode()})")
    if not sequential:
        LAUNCHES += 1
        SPLIT_LAUNCHES += int(split)
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
    lib.micro_raygen_launch.argtypes = [p, p, i, i, i, i, i, ctypes.c_uint,
                                        i, i, i, i, i, p, p]
    lib.micro_raygen_launch.restype = i
    lib.micro_raygen_sequential_launch.argtypes = [p, p, i, i, i, i, i, i,
                                                   i, p, p]
    lib.micro_raygen_sequential_launch.restype = i
    lib.micro_raygen_error_string.argtypes = [i]
    lib.micro_raygen_error_string.restype = ctypes.c_char_p
    return lib


def _options(parser) -> None:
    parser.add_argument("--shape", choices=("a", "b", "both"),
                        default="both")


def main(argv=None) -> dict:
    """Checks and times each variant at the chosen shapes and prints a line
    each; raises if any check fails.  Returns {variant: {run: {...}}} with
    run "a" (shape (a) at ITERS) and "b1", "b16" (shape (b)); only on the
    card: the times (CUDA-event medians of 5 after a warm-up, the
    launches that took them in "launches"), ns per raygen, the run's
    output byte for byte against the sequential entry point's at the same
    iterations and that entry point's time ("sequential_ms"), and the
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
                    def launch(sequential=False):
                        return raygen_sums(params, pix, iters, variant,
                                           programs, sequential=sequential)

                    res["sequential_identical"] = torch.equal(
                        launch(), launch(sequential=True))
                    if not res["sequential_identical"]:
                        failed.append((variant, run, "sequential"))
                    before = LAUNCHES
                    res["ms"] = smoke_lib.median_ms(launch)
                    res["launches"] = LAUNCHES - before
                    res["sequential_ms"] = smoke_lib.median_ms(
                        lambda: launch(sequential=True))
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
                      + (f", byte for byte with the sequential loop "
                         f"{res['sequential_identical']}; {res['ms']:.4f} "
                         f"ms, {res['ns_per_raygen']:.4f} ns/raygen, the "
                         f"sequential loop {res['sequential_ms']:.4f} ms"
                         if "ms" in res else "")
                      + (f", plain {res['plain_ms']:.4f} ms"
                         if "plain_ms" in res else ""), flush=True)
    if failed:
        raise AssertionError(f"micro_raygen: the kernel differs from the "
                             f"plain version at {CHECK_ITERS} iterations or "
                             f"from the sequential loop: {failed}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
