"""What chip_smoke.py and tools/chip_probe.py share: the card's peak
rates and the least time they allow, a kernel's SASS instructions an
element and their issue-slot time, CUDA-event timing, the kernel
builds with K4's form pins and the walks' pins, K1's check against its
plain version, the wavefront's dense oracle, the
dev-probe phase, and K4's idle lanes: two warp models over path lengths
and the measuring build's own count.

Every function here needs a CUDA card but ``least_ms``, ``ptxas_forms``,
``ptxas_kernel``, ``ptxas_entry``, ``sweep_diagnostics``,
``library_call``, ``rows_to_v3``, ``warp_tail``, ``warp_regen``,
``measured_busy``, ``wave_lengths``, ``dense_trace_fn``,
``sphere_walk_bound``, ``subset_rays``, ``bvh_work`` and
``sphere_obj_work`` (on CPU tensors), ``sass_functions``, ``sass_path``,
``sass_per_element`` and ``issue_ms``; the port's modules are imported
inside the functions that use them.
"""

from __future__ import annotations

import concurrent.futures
import re
import shutil
import statistics
import subprocess
import time

import numpy as np
import torch

# The main path's frame: final-one-weekend at its 1200x675, 4 spp.
WIDTH, HEIGHT = 1200, 675
# K1's check: random rays beside the primary ones; ids, and ids with t
# within RTOL/ATOL, must agree on this share of rays.
RANDOM_RAYS = 1 << 20
AGREEMENT = 0.999
RTOL = ATOL = 1e-3
# Cycles of the spin kernel queued before each timed run (~2 ms at the
# H100's ~2 GHz clock).
SPIN_CYCLES = 4_000_000

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of one ray-sphere test, counted from the sweep loops of
# csrc/sphere_sweep.cu and csrc/megakernel.cu: dc 5, oc 5, h 1, c2 3,
# disc 3, max 1, sqrt 1, t1 3, t2 3.  The animated form adds the moved
# centre (3 multiplies, 3 adds) and k0 + t * (k1 + t * k2) (2 and 2).
# The tests are ~99% of the fused kernel's operations (a bounce's other
# work is ~150 operations against 488 x 25), so its bound counts them
# alone and is a lower bound.
FLOPS_PER_TEST = 25
FLOPS_PER_TEST_ANIM = 35
# One child box test of a sphere tree's node: the slab test (per axis two
# subtractions, two multiplies, a min and a max: 18), the running max and
# min over axes (4), the pruned best t (2), the rounding margin (|o| +
# reach)^2 coef (3) and the box widened by it on its six faces (6).
FLOPS_PER_SPHERE_BOX = 33

# Registers and spill-store bytes of K4's 36 forms (nvcc -Xptxas -v) as
# they compile with the loop of steps and per-lane regeneration and, in
# the clustered forms, the sphere tree's walk and, in the noise forms, the
# lattice tables, and in the image forms the texel fetched before the
# hit's draws (PERF.md §6; the forms that moved are listed in
# CHANGES.md): a change to the kernel that moves a
# form must re-pin it and say so.  The dense forms without images, the
# dense image forms, and the clustered twins.
FORMS_BEFORE = {"static": (64, 0), "anim": (64, 0), "tris": (72, 0),
                "lights": (64, 0), "tris+lights": (64, 4),
                "static+noise": (80, 4), "anim+noise": (80, 0),
                "tris+noise": (72, 0), "lights+noise": (80, 4),
                "tris+lights+noise": (80, 4)}
IMAGE_FORMS_BEFORE = {"static+image": (64, 0), "tris+image": (72, 0),
                      "lights+image": (64, 0), "tris+lights+image": (69, 0),
                      "static+noise+image": (80, 0),
                      "tris+noise+image": (80, 0),
                      "lights+noise+image": (80, 0),
                      "tris+lights+noise+image": (80, 0)}
CLUSTER_FORMS_BEFORE = {
    "static+clusters": (64, 0), "anim+clusters": (64, 0),
    "tris+clusters": (72, 0), "lights+clusters": (64, 0),
    "tris+lights+clusters": (72, 0), "static+image+clusters": (64, 0),
    "tris+image+clusters": (72, 0), "lights+image+clusters": (64, 0),
    "tris+lights+image+clusters": (72, 0), "static+noise+clusters": (72, 0),
    "anim+noise+clusters": (80, 4), "tris+noise+clusters": (72, 0),
    "lights+noise+clusters": (80, 4), "tris+lights+noise+clusters": (80, 4),
    "static+noise+image+clusters": (80, 0),
    "tris+noise+image+clusters": (80, 0),
    "lights+noise+image+clusters": (80, 0),
    "tris+lights+noise+image+clusters": (80, 0)}
# The noise forms' partial-warp frames: each noise form's small doc at an
# odd width, so that the frame's last warp has lanes past the image, at
# depth 1 (every sample ends after one bounce, so lanes finish at
# different steps) and at depth 50.
PARTIAL_WARP_WIDTH = 97
PARTIAL_WARP_DEPTHS = (1, 50)
# K3's registers and spill-store bytes (PERF.md): its walk, shared with K4
# in csrc/tri_tree.cuh, compiles as when it was K3's alone.
K3_BEFORE = (48, 0)
# The walks of K1 and K2 (csrc/sphere_sweep.cu sphere_sweep_kernel,
# csrc/tri_sweep.cu tri_sweep_kernel) as they compile with their trees,
# and the BVH walk H1 and the object-space sphere sweep H2
# (csrc/bvh_walk.cu, csrc/sphere_obj.cu): (registers, spill-store bytes),
# pinned from their first build on the card (PERF.md §6); H1 and H2 as
# redesigned, H1 over four-wide nodes (48/0 before), H2 the prefix then a
# tree walk, its far rays swept by their warp (48/0 before); each
# source's dense entry point is printed, not pinned.
WALK_KERNELS = {"K1": ("sphere_sweep", "sphere_sweep_kernel"),
                "K2": ("tri_sweep", "tri_sweep_kernel"),
                "H1": ("bvh_walk", "bvh_walk_kernel"),
                "H2": ("sphere_obj", "sphere_obj_kernel")}
WALKS_BEFORE = {"K1": (56, 0), "K2": (48, 0), "H1": (56, 0), "H2": (48, 56)}
# The image forms: each form but the animated one, with and without noise.
IMAGE_FORMS = sorted(IMAGE_FORMS_BEFORE)
DENSE_FORMS = sorted(list(FORMS_BEFORE) + IMAGE_FORMS)
# The clustered sphere forms: the twin of each dense form
# (tools/stress_scenes.cluster_form_checks names them without the suffix).
CLUSTER_FORMS = sorted(f + "+clusters" for f in DENSE_FORMS)
K4_FORMS = sorted(DENSE_FORMS + CLUSTER_FORMS)

# The dev probes P1-P3 (raytrace_tpu_torch/tools_dev/).  The card's INT32
# rate: 64 INT32 lanes an SM against 128 FP32 lanes (NVIDIA's Hopper
# white paper), so half of PEAK_FP32_FLOPS on its convention.  A kernel
# that does both dispatches one instruction a lane-slot, so its operation
# bound is the larger of its FP32 ops over PEAK_FP32_FLOPS, its INT32 ops
# over PEAK_INT32_OPS and all its ops over PEAK_FP32_FLOPS.
PEAK_INT32_OPS = PEAK_FP32_FLOPS / 2
# Shared memory: 32 banks of 4 bytes a clock on each SM (CUDA C++
# Programming Guide, compute capability 9.0), against its 128 FP32 FMAs (256
# operations) a clock, so half of PEAK_FP32_FLOPS in bytes a second on the
# same clock.  A warp's load of 4-byte words at 32 distinct banks takes one
# clock, of 16-byte rows at least four.
PEAK_SHARED_BYTES = PEAK_FP32_FLOPS / 2
# FP32 and INT32 operations of each P1 probe per element, counted from
# csrc/probe_ops.cu (library transcendentals, sqrt and conversions one
# each; compares and selects not counted): (fp32, int32).  The branch
# probes count the block sum's add per element; the fetch probe computes
# nothing.
PROBE_OPS = {"sin+cos": (3, 0), "pcg-rng": (2, 9), "onehot-fetch": (0, 0),
             "smem-scalar-loop": (2 * 64, 0), "while-loop": (10, 0),
             "lax-cond-datadep": (2, 0), "pl-when-datadep": (1, 0),
             "vmem-scalar-read": (1, 0), "vmem-dynrow-read": (1, 0),
             "pow-exp-log": (11, 0)}
# P2 per element: neg, add, atan2f, scale, the floor-mod (floorf and the
# subtraction); scale, max, min, acosf, scale; the sum.
TRIG_FLOPS = 12
# The card's issue rate: each SM's four schedulers issue one warp
# instruction a clock each, 128 lane-instructions a clock (NVIDIA's Hopper
# white paper).
LANES_ISSUED_PER_SM_CLOCK = 128
# P3 per raygen (one iteration), counted from csrc/raygen.cuh's get_ray
# and csrc/micro_raygen.cu's loop: a random_float is 9 INT32 operations
# (the PCG step and word) and 2 FP32 (the conversion and the scale); the
# camera without the lens 65 FP32 (the sub-pixel offsets 8, the two
# reciprocals 4, the NDC point 12, the projected target 15, its
# normalisation 11, the direction 15); the lens sample 55 (the disk 13
# with sinf and cosf, the half aperture and the origin 7, the focal point
# 21, the direction again 14 with its normalisation); the sum 7; 13 INT32
# (the batch and sample 2, the seed 6, the + it 1, si and sj 2, the next
# sip 2).  base and packedpx draw five random floats, nodof three.
RAYGEN_OPS = {"base": (65 + 55 + 5 * 2 + 7, 13 + 5 * 9),
              "nodof": (65 + 3 * 2 + 7, 13 + 3 * 9),
              "packedpx": (65 + 55 + 5 * 2 + 7, 13 + 5 * 9)}


def noise_form_docs(mb_doc: dict, png: str) -> dict:
    """Each of K4's 18 noise forms, by its name in K4_FORMS: (doc, width,
    depth) of the small doc on which it is held against its plain version
    (tools/noise_scenes.form_checks, the noise twins of
    tools/image_scenes.form_checks and of
    tools/stress_scenes.cluster_form_checks).  ``mb_doc`` is the
    motion-blur scene's doc, ``png`` a texel-id image."""
    from raytrace_tpu_torch.tools import (image_scenes, noise_scenes,
                                          stress_scenes)

    out = {f + "+noise": v for f, v in noise_scenes.form_checks(
        mb_doc).items()}
    out.update({f + "+image": v for f, v in image_scenes.form_checks(
        png).items() if "noise" in f})
    out.update({f + "+clusters": v for f, v in
                stress_scenes.cluster_form_checks(png).items()
                if "noise" in f})
    return out


def least_ms(flops: float, nbytes: float, int_ops: float = 0.0,
             shared_bytes: float = 0.0):
    """(least ms, "operations" or "bytes"): the larger of the two (the
    operations' time as PEAK_INT32_OPS says; the bytes' time the larger of
    device memory's and, for ``shared_bytes``, shared memory's)."""
    t_ops = max(flops, int_ops * PEAK_FP32_FLOPS / PEAK_INT32_OPS,
                flops + int_ops) / PEAK_FP32_FLOPS * 1e3
    t_bytes = max(nbytes / PEAK_BYTES,
                  shared_bytes / PEAK_SHARED_BYTES) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k4_form(text: str):
    """The name of the first K4 instantiation named in ``text`` (its mangled
    symbol, megakernel<kAnim, kTris, kLights, kNoise, kImage,
    kSphClusters>; a noise form's name has "+noise", an image form's
    "+image", a clustered sphere form's ends in "+clusters"), or None."""
    m = re.search(r"megakernelILb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E",
                  text)
    if m is None:
        return None
    names = {("0", "0", "0"): "static", ("1", "0", "0"): "anim",
             ("0", "1", "0"): "tris", ("0", "0", "1"): "lights",
             ("0", "1", "1"): "tris+lights"}
    return (names.get(m.groups()[:3], str(m.groups()))
            + ("+noise" if m.group(4) == "1" else "")
            + ("+image" if m.group(5) == "1" else "")
            + ("+clusters" if m.group(6) == "1" else ""))


def ptxas_forms(log: str):
    """[(form, registers, spill store bytes)] of each K4 instantiation in
    nvcc's -Xptxas=-v report (named by k4_form)."""
    forms = []
    for block in log.split("Compiling entry function")[1:]:
        name = k4_form(block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if name and regs and spill:
            forms.append((name, int(regs.group(1)), int(spill.group(1))))
    return forms


def ptxas_kernel(log: str):
    """(registers, spill store bytes) of the one kernel in nvcc's report."""
    regs = re.search(r"Used (\d+) registers", log)
    spill = re.search(r"(\d+) bytes spill stores", log)
    return int(regs.group(1)), int(spill.group(1)) if spill else 0


def ptxas_entry(log: str, entry: str):
    """(registers, spill store bytes) of the kernel named ``entry`` (its
    length-prefixed name in the mangled symbol) in nvcc's report of a
    source with several."""
    for block in log.split("Compiling entry function")[1:]:
        if f"{len(entry)}{entry}" in block.split("\n", 1)[0]:
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            return int(regs.group(1)), int(spill.group(1)) if spill else 0
    raise AssertionError(f"no entry {entry} in nvcc's report")


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass_functions(listing: str) -> dict:
    """{mangled name: [(address, instruction)]} of each function in
    ``cuobjdump -sass``'s listing."""
    funcs = {}
    for func in re.split(r"\n\s*Function : ", listing)[1:]:
        name, _, body = func.partition("\n")
        funcs[name.strip()] = [(int(a, 16), ins) for a, ins in
                               _SASS_LINE.findall(body)]
    return funcs


def _branch(ins: str):
    """(target, conditional) of a BRA, else None."""
    m = re.match(r"(@!?U?P\w+\s+)?BRA(\.\w+)*\s+(.*)$", ins)
    if m is None:
        return None
    args = m.group(3)
    target = int(re.findall(r"0x([0-9a-f]+)", args)[-1], 16)
    return target, bool(m.group(1)) or bool(re.match(r"!?U?P\w+\s*,", args))


def _skips_slow_path(code, i: int, target: int) -> bool:
    """Whether the conditional branch at code[i] jumps over a slow path:
    the instructions it skips hold a backward branch (a loop: fmodf's long
    reduction) or a subroutine call and no conditional branch (the slow
    path of a division or a reciprocal)."""
    skipped = [(a, ins, _branch(ins)) for a, ins in code[i + 1:]
               if a < target]
    loop = any(b and b[0] <= a for a, _, b in skipped)
    call = any(ins.startswith("CALL") for _, ins, _ in skipped)
    cond = any(b and b[1] for _, _, b in skipped)
    return loop or (call and not cond)


def sass_path(code, start: int, stop=None, trips=None) -> list:
    """The instructions one thread runs from address ``start`` to the first
    EXIT, or to the instruction at ``stop`` (included), taking a
    conditional branch only where it skips a slow path
    (``_skips_slow_path``: inputs of ordinary magnitude never take a
    division's, a reciprocal's or fmodf's slow path) and falling through
    the others (atan2f's zero and infinite arguments), and following every
    unconditional one.  A backward branch at an address in ``trips`` (an
    inner loop's end) is taken until its loop has run that many times and
    then falls through; any other backward branch ends the path."""
    index = {a: k for k, (a, _) in enumerate(code)}
    trips, taken = trips or {}, {}
    k, path = index[start], []
    while k < len(code):
        addr, ins = code[k]
        path.append(ins)
        if addr == stop or ins == "EXIT":
            break
        branch = _branch(ins)
        if branch is not None:
            target, conditional = branch
            if target <= addr:
                if addr not in trips:
                    break
                taken[addr] = taken.get(addr, 0) + 1
                if taken[addr] < trips[addr]:
                    k = index[target]
                    continue
            elif not conditional or _skips_slow_path(code, k, target):
                k = index[target]
                continue
        k += 1
    return path


def sass_per_element(code, elements: int = 1, inner_trips: int = 1) -> float:
    """SASS instructions an element runs through: the whole path from the
    entry for a kernel of one element a thread (``elements`` = 1), else the
    body of its outermost loop (from the target of its lowest-reaching
    backward branch to that branch), which takes ``elements`` an
    iteration, each loop inside it run ``inner_trips`` times."""
    if elements == 1:
        return float(len(sass_path(code, code[0][0])))
    latches = [(b[0], a) for a, ins in code
               if (b := _branch(ins)) and b[0] < a]
    target, latch = min(latches)
    inner = {a: inner_trips for t, a in latches if t > target and a < latch}
    return len(sass_path(code, target, stop=latch, trips=inner)) / elements


def sass_listing(library) -> str:
    """``cuobjdump -sass`` of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout


def trig_sass(library) -> dict:
    """P2's SASS instructions an element in each kernel of its library
    (the short name after "probe_trig" in the mangled symbol): a kernel
    named ``probe_trig_vec`` takes 8 elements a loop iteration (a loop
    inside it is its two float4 halves, run twice), any other one an
    element a thread."""
    out = {}
    for name, code in sass_functions(sass_listing(library)).items():
        m = re.search(r"\d+(probe_trig\w*?)E", name)
        if m:
            vec = m.group(1) == "probe_trig_vec"
            out[m.group(1)] = sass_per_element(code, 8 if vec else 1,
                                               2 if vec else 1)
    return out


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reads while the card runs a spin kernel
    (an idle card reads its idle clock)."""
    torch.cuda._sleep(2_000_000_000)
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True).stdout
    torch.cuda.synchronize()
    return float(mhz.split()[0])


def issue_ms(instructions: float, sms: int, mhz: float) -> float:
    """The least time ``instructions`` lane-instructions take at the card's
    issue rate (LANES_ISSUED_PER_SM_CLOCK an SM a clock)."""
    return instructions / (sms * LANES_ISSUED_PER_SM_CLOCK * mhz * 1e6) * 1e3


def median_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms by CUDA events, after a warm-up
    call.  A spin kernel of SPIN_CYCLES is queued before each start event,
    so the host's work inside ``fn`` (a wrapper's checks and parameter
    tensors) is done while the card is still busy, and the events measure
    the card's time alone: without it, a kernel shorter than its wrapper's
    host time (K4 on the earth) reads as the host time."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sweep_diagnostics(ids, id_ref, t, s8: int, block: int = 256) -> str:
    """What a failed K1 check saw: the share of K1's ids outside [-1, S8)
    and of its t not finite (values a launch that never wrote its output
    leaves), the share of the disagreeing rays that K1 calls a miss and the
    plain version a hit, and whether the disagreeing rays fill whole
    ``block``-ray blocks (K1's thread blocks: blocks that never ran or read
    a stale tile), with the first such blocks."""
    bad = ids != id_ref
    n_bad = int(bad.sum())
    outside = ((ids < -1) | (ids >= s8)).double().mean().item()
    not_finite = (~torch.isfinite(t)).double().mean().item()
    miss_vs_hit = int((bad & (ids == -1) & (id_ref >= 0)).sum())
    block_of = torch.arange(bad.numel(), device=bad.device) // block
    rays = torch.bincount(block_of)
    wrong = torch.bincount(block_of[bad], minlength=rays.numel())
    full = (wrong == rays).nonzero().flatten()
    touched = int((wrong > 0).sum())
    return (f"{n_bad} rays disagree; ids outside [-1, {s8}) on {outside:.6f}"
            f" of rays, t not finite on {not_finite:.6f}; of the disagreeing"
            f" rays {miss_vs_hit / max(n_bad, 1):.6f} are a K1 miss and a "
            f"plain hit; {full.numel()} whole {block}-ray blocks disagree "
            f"(first {full[:8].tolist()}), of {touched} blocks with a "
            f"disagreement")


def compare_sweep(name, o, d, table8, alive, tree=None):
    """Kernel vs plain version on the same rays.  A ray agrees when both
    give the same sphere id and t within rtol/atol; ids must agree on
    >= 99.9% of rays, and so must whole hits.  (A ray that starts within
    float error of T_MIN from a surface may keep the near root in one
    version and take the far root in the other.)  K1 walks ``tree`` where
    it is given.  Then K1, and its dense entry point, must equal the
    plain version bit for bit (both are built without contraction).
    Returns max |dt| over the rays that agree."""
    from raytrace_tpu_torch.ops import sphere_sweep
    from raytrace_tpu_torch.ops.intersect import T_MAX

    hit = sphere_sweep.intersect_spheres_sweep(o, d, table8, alive, tree)
    t_ref, id_ref = sphere_sweep.sphere_sweep_reference(o, d, table8)
    t_ref = torch.where(alive, t_ref, T_MAX)
    id_ref = torch.where(alive, id_ref, -1)
    torch.cuda.synchronize()
    same_id = hit.sph == id_ref
    agree = same_id & ((hit.t - t_ref).abs() <= ATOL + RTOL * t_ref.abs())
    frac_id = same_id.double().mean().item()
    frac = agree.double().mean().item()
    if frac_id < AGREEMENT or frac < AGREEMENT:
        diag = sweep_diagnostics(hit.sph, id_ref, hit.t, table8.shape[0])
        print(f"sweep {name} FAILED: {diag}", flush=True)
        raise AssertionError(f"{name}: ids agree on {frac_id:.6f}, hits on "
                             f"{frac:.6f} of rays (need {AGREEMENT}); {diag}")
    err = (hit.t[agree] - t_ref[agree]).abs().max().item()
    hits = (hit.sph >= 0).double().mean().item()
    dense = sphere_sweep.intersect_spheres_dense(o, d, table8, alive)
    bitwise = torch.equal(hit.t, t_ref) and torch.equal(hit.sph, id_ref)
    dense_bitwise = (torch.equal(dense.t, t_ref)
                     and torch.equal(dense.sph, id_ref))
    walk = ("none" if tree is None else
            f"prefix {tree.n_prefix}, tree of {tree.num_spheres} in leaves "
            f"of {tree.leaf}, depth {tree.depth}")
    print(f"sweep {name}: R={o.x.shape[0]} S8={table8.shape[0]} ({walk}): "
          f"ids agree on {frac_id:.6f}, (id, t) on {frac:.6f} of rays "
          f"({int((same_id & ~agree).sum())} same-id root flips); hit share "
          f"{hits:.4f}; max |dt| where they agree {err:.3g}; bit for bit "
          f"with the plain version: K1 {bitwise}, its dense entry "
          f"{dense_bitwise}")
    if not (bitwise and dense_bitwise):
        raise AssertionError(f"{name}: K1 (bit for bit {bitwise}) or its "
                             f"dense entry ({dense_bitwise}) is not the "
                             f"plain version's bits")
    return err


def dense_trace_fn(static, scene, geom):
    """engine/wavefront.make_trace_fn with the dense entry points of K2 and
    K1 (ops/tri_sweep.intersect_tris_dense, ops/sphere_sweep.
    intersect_spheres_dense) in place of their walks: the independent
    dense oracle that chip_smoke.py holds the fused paths against.  No
    Renderer path runs it."""
    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.ops import paged_tri, sphere_sweep, tri_sweep

    s_pad = scene.sph_center.shape[0]

    def trace(o, d, alive):
        tri = None
        if static.bvh_mode == "paged":
            tri = paged_tri.intersect_tris_paged(o, d, geom.tri_tree, alive)
        elif static.has_tris:
            tri = tri_sweep.intersect_tris_dense(o, d, geom.tri_table16,
                                                 alive)
        sph = (sphere_sweep.intersect_spheres_dense(o, d, geom.sph_table8,
                                                    alive)
               if static.has_spheres or not static.has_tris else None)
        return wavefront.combine_hits(sph, tri, s_pad)

    return trace


def sphere_walk_bound(o, d, alive, tree, best_t, n_rays):
    """K1's least time over ``n_rays`` rays from the walk's work on the
    rays (o, d, alive), a subset of them whose closest hits are
    ``best_t`` (ops/sphere_tree.sphere_tree_visit_counts): the prefix's
    tests, the nodes' box tests and the leaves' sphere tests a ray, scaled
    to ``n_rays``; bytes the rays (25 in, 8 out), the prefix's rows, the
    distinct node rows, sphere rows and ids the walk reads.  Returns
    (least ms, "operations" or "bytes", per-ray work)."""
    from raytrace_tpu_torch.ops import sphere_tree

    work = sphere_tree.sphere_tree_visit_counts(o, d, tree, best_t, alive)
    rays = max(work["rays"], 1)
    per = {k: work[k] / rays for k in ("prefix_tests", "node_tests",
                                       "sphere_tests")}
    flops = n_rays * ((per["prefix_tests"] + per["sphere_tests"])
                      * FLOPS_PER_TEST
                      + per["node_tests"] * 2 * FLOPS_PER_SPHERE_BOX)
    nbytes = (n_rays * (6 * 4 + 1 + 4 + 4) + tree.n_prefix * 32
              + work["nodes_read"] * 64 + work["spheres_read"] * (32 + 4))
    return (*least_ms(flops, nbytes), per)


def rows_to_v3(a, dev):
    """[R, 3] numpy rows → a V3 of contiguous [R] tensors on ``dev``."""
    from raytrace_tpu_torch.ops.vec3 import V3

    return V3(*(torch.tensor(np.ascontiguousarray(a[:, i]), device=dev)
                for i in range(3)))


def kernel_builds():
    """The loader of each library phase 2 builds, by library name: the
    nine kernel sources, K4's measuring build and the host library of
    the native SAH builder (g++, models/bvh_native.py; a failed build
    raises here)."""
    from raytrace_tpu_torch.models import bvh_native
    from raytrace_tpu_torch.ops import (bvh, megakernel, paged_tri,
                                        sphere_obj, sphere_sweep, tri_sweep)
    from raytrace_tpu_torch.tools_dev import (micro_raygen, probe_ops,
                                              probe_trig)

    def sah_builder():
        if bvh_native.get_library() is None:
            raise RuntimeError(f"the native SAH builder did not build: "
                               f"{bvh_native.error()}")

    return {"sphere_sweep": sphere_sweep.library,
            "tri_sweep": tri_sweep.library, "megakernel": megakernel.library,
            "megakernel_measure": megakernel.measure_library,
            "paged_tri": paged_tri.library, "bvh_walk": bvh.library,
            "sphere_obj": sphere_obj.library, "probe_ops": probe_ops.library,
            "probe_trig": probe_trig.library,
            "micro_raygen": micro_raygen.library,
            "bvh_builder": sah_builder}


def build_kernels(names=None):
    """Phase 2: builds every library (or those ``names``), one nvcc each,
    started together; prints each build's seconds and nvcc's register
    report, a line per K4 form and K3's; every K4 form must keep the
    registers and spills pinned for it (FORMS_BEFORE, IMAGE_FORMS_BEFORE,
    CLUSTER_FORMS_BEFORE), and K3 its K3_BEFORE.  K4's measuring build
    has every form too; its registers are printed, not pinned."""
    from raytrace_tpu_torch.ops import _build

    def timed_build(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    loads = {name: load for name, load in kernel_builds().items()
             if names is None or name in names}
    with concurrent.futures.ThreadPoolExecutor(len(loads)) as pool:
        secs = dict(zip(loads, pool.map(timed_build, loads.values())))
    for name, sec in secs.items():
        if name == "bvh_builder":
            print(f"build: the native SAH builder (csrc/bvh_builder.cc, "
                  f"g++) in {sec:.2f} s")
            continue
        print(f"build: {name} ({_build.source(name).name}) in {sec:.2f} s")
        log = _build.library_path(name).with_suffix(".log")
        if log.exists() and name != "megakernel_measure":
            print(log.read_text().strip())
    if names is not None:
        return secs
    forms = ptxas_forms(_build.library_path("megakernel").with_suffix(
        ".log").read_text())
    if sorted(f for f, _, _ in forms) != K4_FORMS:
        raise AssertionError(f"K4's forms in nvcc's report: {forms}")
    before = {**FORMS_BEFORE, **IMAGE_FORMS_BEFORE, **CLUSTER_FORMS_BEFORE}
    for form, regs, spill in forms:
        print(f"K4 {form} form: {regs} registers, {spill} bytes spill "
              f"stores")
        if before[form] != (regs, spill):
            raise AssertionError(f"K4's {form} form changed: {regs} "
                                 f"registers, {spill} bytes spilled, "
                                 f"before {before[form]}")
    measured = ptxas_forms(_build.library_path(
        "megakernel_measure").with_suffix(".log").read_text())
    if sorted(f for f, _, _ in measured) != K4_FORMS:
        raise AssertionError(f"K4's measuring build's forms: {measured}")
    print("K4's measuring build (registers, spill bytes): "
          + ", ".join(f"{f} {r}/{b}" for f, r, b in measured))
    k3_regs, k3_spill = ptxas_kernel(_build.library_path(
        "paged_tri").with_suffix(".log").read_text())
    print(f"K3: {k3_regs} registers, {k3_spill} bytes spill stores")
    if (k3_regs, k3_spill) != K3_BEFORE:
        raise AssertionError(f"K3 changed: {k3_regs} registers, {k3_spill} "
                             f"bytes spilled, before {K3_BEFORE}")
    for label, (lib, entry) in WALK_KERNELS.items():
        got = ptxas_entry(_build.library_path(lib).with_suffix(
            ".log").read_text(), entry)
        print(f"{label}'s walk: {got[0]} registers, {got[1]} bytes spill "
              f"stores")
        if got != WALKS_BEFORE[label]:
            raise AssertionError(f"{label}'s walk changed: {got}, before "
                                 f"{WALKS_BEFORE[label]}")
    return secs


# ---- K4's idle lanes: two models of a warp over per-(pixel, sample) path
# lengths, and the measuring build's own count.

def _warps(lengths):
    """[n_warps, 32, K] float64 of [n_pix, K] path lengths: warps of 32
    consecutive pixels, a last partial warp dropped."""
    n_pix, k = lengths.shape
    return torch.as_tensor(lengths)[:n_pix - n_pix % 32].reshape(
        -1, 32, k).double()


def warp_tail(lengths):
    """Lanes busy under per-sample reconvergence (a loop over samples around
    a loop over bounces: a warp of 32 consecutive pixels runs each sample
    until its longest path ends) from [n_pix, K] path lengths: for each
    warp and sample, the longest and the mean path length of its 32 lanes.
    Returns (mean lanes busy: the sum of the means over the sum of the
    longest, the mean of the per-(warp, sample) ratios, the mean longest,
    the mean path length)."""
    warps = _warps(lengths)
    longest = warps.amax(dim=1)
    mean = warps.mean(dim=1)
    return (float(mean.sum() / longest.sum()),
            float((mean / longest.clamp(min=1)).mean()),
            float(longest.mean()), float(mean.mean()))


def warp_regen(lengths):
    """Lanes busy under per-lane regeneration (one loop of steps, a lane
    starting its pixel's next sample where a path ends: a warp runs as many
    steps as its busiest lane's total over its K samples) from [n_pix, K]
    path lengths.  Returns (mean lanes busy: the sum over warps of the
    lanes' total path lengths over the sum of 32 x the busiest lane's
    total, the mean of the per-warp ratios, the mean busiest lane's total,
    the mean lane's total)."""
    totals = _warps(lengths).sum(dim=2)
    busiest = totals.amax(dim=1)
    mean = totals.mean(dim=1)
    return (float(mean.sum() / busiest.sum()),
            float((mean / busiest.clamp(min=1)).mean()),
            float(busiest.mean()), float(mean.mean()))


def measured_busy(counts):
    """The measuring build's lanes-busy share and each phase's share of the
    warps' cycles, from megakernel.measure_tile_mega's counters."""
    from raytrace_tpu_torch.ops import megakernel

    # The phases' slots, after busy and slots, in every checkout's order.
    phases = megakernel.MEASURE_SLOTS[2:7]
    cycles = sum(counts[k] for k in phases)
    return (counts["busy"] / max(counts["slots"], 1),
            {k: counts[k] / max(cycles, 1) for k in phases})


def measure_busy(args, kw):
    """K4's measuring build on one launch of ``render_tile_mega(*args,
    **kw)``: its sums and counts must be the normal build's, byte for
    byte, and its busy lanes must add up to the bounces traced.  Returns
    {"busy": lanes-busy share, "phases": measured_busy's, "steps": warp
    steps} and, where the build counts them (the noise forms), the
    turbulences the lanes took ("noise_lanes") and those a warp step."""
    from raytrace_tpu_torch.ops import megakernel

    sums, traced = megakernel.render_tile_mega(*args, **kw)
    m_sums, m_traced, counts = megakernel.measure_tile_mega(*args, **kw)
    if not (torch.equal(sums, m_sums) and torch.equal(traced, m_traced)):
        raise AssertionError("the measuring build's sums differ from the "
                             "normal build's")
    if counts["busy"] != int(traced.sum()):
        raise AssertionError(f"the measuring build counted {counts['busy']} "
                             f"busy lanes for {int(traced.sum())} bounces")
    busy, phases = measured_busy(counts)
    out = {"busy": busy, "phases": phases, "steps": counts["slots"] // 32}
    if "noise_lanes" in counts:  # since the lattice tables
        out["noise_lanes"] = counts["noise_lanes"]
        out["noise_lanes_a_step"] = counts["noise_lanes"] / max(
            out["steps"], 1)
    return out


def wave_lengths(static, scene, cam, trace, geom, use_dof, rows_per_tile,
                 batch: int = 0):
    """Batch ``batch`` on the wavefront with ``trace``, as render_tile
    renders it tile by tile, keeping each ray's bounce count.  Returns
    (image [H, W, 3] on the card, rays traced, [H * W, spp] int32 each
    (pixel, sample)'s bounces: its path length)."""
    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.ops import vec3

    W, H = static.width, static.height
    spp = static.sqrt_spp ** 2
    dev = geom.sph_table8.device
    tiles, rays, lengths = [], 0, []
    for row0 in range(0, H, rows_per_tile):
        state, o, d = wavefront.primary_rays(static, cam, batch, row0,
                                             rows_per_tile, use_dof, dev)
        counts = torch.zeros(o.x.shape[0], dtype=torch.int32, device=dev)
        radiance, tr = wavefront.bounce_wavefront(static, scene, trace,
                                                  geom, state, o, d, counts)
        tiles.append(vec3.to_rows(radiance).reshape(
            rows_per_tile, W, spp, 3).mean(2))
        lengths.append(counts.reshape(rows_per_tile, W * spp)[:H - row0])
        rays += tr
    return (torch.cat(tiles, dim=0)[:H], rays,
            torch.cat(lengths).reshape(H * W, spp))


def library_call(name, x, tab):
    """The one PyTorch call that computes P1 probe ``name``'s function on
    its inputs, or None.  The fetch is a gather (``index_select``) and the
    two table reads a product by one entry (``mul``), each bit for bit
    with the plain version.  The other seven are chains of operations in
    a fixed order that no one call reproduces: two transcendentals and a
    sum (sin+cos), the PCG step and word, 64 or 10 sums in order (the
    table loop, the while loop), a block sum and then a select (the two
    branch probes), the power, exp and log."""
    from raytrace_tpu_torch.tools_dev import probe_ops

    if name == "onehot-fetch":
        ids = x.reshape(-1).to(torch.int64)
        return lambda: torch.index_select(tab, 1, ids)
    row = {"vmem-scalar-read": probe_ops.SCALAR_ROW,
           "vmem-dynrow-read": probe_ops.DYN_ROW}.get(name)
    if row is None:
        return None
    scalar = tab[row, 0]
    return lambda: torch.mul(x, scalar)


def dev_probes(dev, card):
    """Phase 3c: the dev probes P1-P3, through the mains a user runs
    (``python3 -m raytrace_tpu_torch.tools_dev.probe_ops`` and the
    others).  Each main holds its kernels against their plain versions,
    raises where one disagrees (P1 bit for bit, sin+cos and pow-exp-log
    within probe_ops.TRANSCENDENTAL_ATOL; P2 at (8, 128) and 2^24 points
    within probe_trig.ULP_TOL ulps and byte for byte with its check-only
    kernel; P3's three variants at shapes (a) and (b) bit for bit at 4
    iterations, two launches byte-identical, and each timed run byte for
    byte with the sequential entry point at its own iterations) and times
    both (CUDA-event medians of 5; P2's check-only kernel beside it; P3 at
    (a) with 20,000 iterations on its split kernel and at (b) with 1 and
    16 one thread a cell, each beside the sequential entry point).  The
    launches are counted from 0 across the mains, and every probe kernel
    must launch there (P2's check-only kernel and P3's split kernel too).
    Adds what the mains do not give: each least time the card allows, the
    PyTorch call where one computes a P1 probe's function, the card's
    launch floor beside P1 (one one-element PyTorch kernel), and P2's SASS
    instructions an element (``trig_sass``) with the issue-slot time they
    imply at the SM clock read under load.  Returns the three entries of
    the kernels line and P3's base variant at (b) with one iteration."""
    from raytrace_tpu_torch.tools_dev import micro_raygen as mr
    from raytrace_tpu_torch.tools_dev import probe_ops, probe_trig

    probe_ops.LAUNCHES = dict.fromkeys(probe_ops.PROBES, 0)
    probe_trig.LAUNCHES = probe_trig.SCALAR_LAUNCHES = 0
    mr.LAUNCHES = mr.SPLIT_LAUNCHES = 0
    t0 = time.perf_counter()
    p1, p2, p3 = probe_ops.main([]), probe_trig.main([]), mr.main([])
    launches = dict(probe_ops.LAUNCHES, probe_trig=probe_trig.LAUNCHES,
                    probe_trig_scalar=probe_trig.SCALAR_LAUNCHES,
                    micro_raygen=mr.LAUNCHES,
                    micro_raygen_split=mr.SPLIT_LAUNCHES)
    idle = [name for name, count in launches.items() if count <= 0]
    if idle:
        raise AssertionError(f"dev probes never launched: {idle}")
    print(f"dev probes' mains in {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}")

    # P1 at the JAX probe's shapes; every probe is bound by its launch.
    # The card's launch floor: one one-element PyTorch kernel.
    one = torch.ones(1, device=dev)
    floor_ms = median_ms(lambda: one.add_(1))
    print(f"launch floor: one one-element PyTorch kernel {floor_ms:.4f} ms "
          f"({card})")
    inp = probe_ops.make_inputs(dev)
    rows = []
    for name in probe_ops.PROBES:
        x, tab = inp.args(name)
        n, res = x.numel(), p1[name]
        ref = probe_ops.probe_reference(name, x, tab)
        # Bytes the function needs: x, the table's entries it reads, out.
        nbytes = (n + ref.numel()) * 4
        if name == "onehot-fetch":
            nbytes += tab.shape[0] * int(x.unique().numel()) * 4
        elif tab is not None:
            nbytes += (tab.shape[0] if name == "smem-scalar-loop" else 1) * 4
        call = library_call(name, x, tab)
        library_ms = None
        if call is not None:
            if not torch.equal(call(), ref):
                raise AssertionError(f"P1 {name}: the PyTorch call differs "
                                     "from the plain version")
            library_ms = median_ms(call)
        fp, iops = PROBE_OPS[name]
        bound = least_ms(fp * n, nbytes, iops * n)
        rows.append(dict(name=name, launches=launches[name],
                         max_abs_err=res["max_abs_err"], ms=res["ms"],
                         plain_ms=res["plain_ms"], bound_ms=bound[0],
                         bound_by=bound[1], library_ms=library_ms,
                         flops=fp * n, int_ops=iops * n, bytes=nbytes))
        print(f"P1 {name}: kernel {res['ms']:.4f} ms, plain "
              f"{res['plain_ms']:.4f} ms"
              + (f", one PyTorch call {library_ms:.4f} ms"
                 if library_ms is not None else "")
              + f"; the launch floor {floor_ms:.4f} ms, "
              f"{(res['ms'] - floor_ms) * 1e3:+.2f} us over it; bound "
              f"{bound[0]:.6f} ms by {bound[1]}: launch-bound ({card})")
    p1_bound = least_ms(sum(r["flops"] for r in rows),
                        sum(r["bytes"] for r in rows),
                        sum(r["int_ops"] for r in rows))

    # P2 at the probe's (8, 128) and at 2^24 points, and the issue-slot
    # time of its SASS instructions an element.
    from raytrace_tpu_torch.ops import _build

    sass = trig_sass(_build.library_path("probe_trig"))
    mhz = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    large = p2["large"]["n"]
    print(f"P2 SASS instructions an element: {sass}; SM clock {mhz:.0f} MHz "
          f"under load, {sms} SMs; their issue slots at {large} points: "
          + ", ".join(f"{k} {issue_ms(v * large, sms, mhz):.6f} ms"
                      for k, v in sass.items()))
    trig = {}
    for size, res in p2.items():
        bound = least_ms(TRIG_FLOPS * res["n"], 8 * res["n"])
        issue = issue_ms(sass["probe_trig_vec"] * res["n"], sms, mhz)
        trig[size] = dict(res, bound=bound, issue_ms=issue)
        print(f"P2 at {res['n']} points: kernel {res['ms']:.4f} ms, the "
              f"check-only kernel {res['scalar_ms']:.4f} ms; bound "
              f"{bound[0]:.6f} ms by {bound[1]}"
              + (": launch-bound" if size == "probe" else
                 f" ({bound[0] / res['ms']:.3f} of it)")
              + f"; issue slots {issue:.6f} ms ({issue / res['ms']:.3f} of "
              f"it) ({card})")

    # P3: every variant at both shapes.
    for variant, runs in p3.items():
        fp, iops = RAYGEN_OPS[variant]
        for run, res in runs.items():
            cells, iters = res["cells"], res["iters"]
            pixels = cells // (mr.PROGRAMS if run == "a" else 1)
            # Each cell decodes its pixel once (2 INT32 operations).
            res["bound"] = bound = least_ms(
                fp * cells * iters, (pixels + cells + mr.N_PARAMS) * 4,
                (iops * iters + 2) * cells)
            print(f"P3 {variant} {run}: {cells} cells x {iters} iterations"
                  f", {res['ms']:.4f} ms in {res['launches']} launches "
                  f"({'split' if run == 'a' else 'a thread a cell'}), the "
                  f"sequential loop {res['sequential_ms']:.4f} ms, byte for "
                  f"byte {res['sequential_identical']}; bound "
                  f"{bound[0]:.4f} ms by {bound[1]} "
                  f"({bound[0] / res['ms']:.3f} of it) ({card})")
    b1, a = p3["base"]["b1"], p3["base"]["a"]
    print(f"dev-probe phase in {time.perf_counter() - t0:.1f} s")

    entries = [{
        # The ten probes, each launched once; the PyTorch calls of the
        # fetch and the two table reads are in their rows of "probes": no
        # one call computes the ten.
        "name": "probe_ops", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/probe_ops.cu",
        "replaces": "tools_dev/probe_pallas.py:17",
        "launches": sum(r["launches"] for r in rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": p1_bound[0], "bound_by": p1_bound[1], "library_ms": None,
        "launch_floor_ms": floor_ms,
        "probes": [{k: r[k] for k in (
            "name", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")} for r in rows],
    }, {
        # 2^24 points; the probe's (8, 128) is launch-bound.  Beside it the
        # check-only kernel as first ported, and the issue-slot time of the
        # kernel's SASS instructions an element at the SM clock.
        "name": "probe_trig", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/probe_trig.cu",
        "replaces": "tools_dev/probe_trig.py:20",
        "launches": launches["probe_trig"],
        "max_abs_err": trig["large"]["max_abs_err"],
        "ms": trig["large"]["ms"], "plain_ms": trig["large"]["plain_ms"],
        "bound_ms": trig["large"]["bound"][0],
        "bound_by": trig["large"]["bound"][1], "library_ms": None,
        "scalar_ms": trig["large"]["scalar_ms"],
        "scalar_launches": launches["probe_trig_scalar"],
        "probe_ms": trig["probe"]["ms"],
        "sass_per_element": sass["probe_trig_vec"],
        "scalar_sass_per_element": sass["probe_trig_scalar"],
        "sm_clock_mhz": mhz, "issue_ms": trig["large"]["issue_ms"],
        "scalar_issue_ms": issue_ms(sass["probe_trig_scalar"] * large, sms,
                                    mhz),
    }, {
        # The base variant at shape (b), one iteration: the raygen work of
        # one K4 batch of final-one-weekend; beside it shape (a), the JAX
        # layout at 20,000 iterations on the split kernel, and the
        # launches at that shape's full iterations (each variant's
        # warm-up and five timed), of the split kernel's in all.
        "name": "micro_raygen", "route": "cuda", "variant": "base",
        "source": "raytrace_tpu_torch/csrc/micro_raygen.cu",
        "replaces": "tools_dev/micro_raygen.py:89",
        "launches": launches["micro_raygen"],
        "max_abs_err": b1["max_abs_err"], "ms": b1["ms"],
        "plain_ms": b1["plain_ms"], "bound_ms": b1["bound"][0],
        "bound_by": b1["bound"][1], "library_ms": None,
        "sequential_ms": b1["sequential_ms"],
        "a_ms": a["ms"], "a_bound_ms": a["bound"][0],
        "a_bound_by": a["bound"][1], "a_sequential_ms": a["sequential_ms"],
        "a_launches": sum(r["a"]["launches"] for r in p3.values()),
        "split_launches": launches["micro_raygen_split"],
        "a_ms_by_variant": {v: r["a"]["ms"] for v, r in p3.items()},
    }]
    return entries, b1


def k1_checks(cs, dev, card, rng):
    """Phase 3's K1 part: K1 (the scene's prefix, then its sphere tree,
    as the wavefront runs it) against the plain sweep on the main path's
    3,240,000 primary rays of ``cs`` (final-one-weekend at 1200x675) and
    on 2^20 random rays with an alive mask drawn from ``rng`` (the
    agreement check, then bit for bit), then its time beside its dense
    entry point's and the plain version's, and its bound from the walk's
    work on 2^17 of the primary rays beside the dense sweep's.  Returns
    {err, ms, dense_ms, plain_ms, bound, dense_bound}."""
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.engine.wavefront import prepare_batch, primary_rays
    from raytrace_tpu_torch.ops import sphere_sweep
    from raytrace_tpu_torch.ops.vec3 import V3

    probe = Renderer(cs, device=dev, use_megakernel=False)
    geom = prepare_batch(probe.static, probe.scene,
                         torch.tensor(probe.sphere_tables[0], device=dev))
    table8, tree = geom.sph_table8, geom.sph_tree
    if tree is None or tree.n_prefix != probe.static.sph_prefix:
        raise AssertionError("the wavefront's geometry has no K1 tree")
    _, o, d = primary_rays(probe.static, probe.camera, 0, 0, HEIGHT,
                           probe.use_dof, dev)
    if o.x.shape[0] != WIDTH * HEIGHT * 4:
        raise AssertionError(f"primary rays: {o.x.shape[0]}")
    alive = torch.ones(o.x.shape[0], dtype=torch.bool, device=dev)
    err = compare_sweep("primary", o, d, table8, alive, tree)

    # Origins in the scene's air (its ground fills y > 0).
    ro = rng.uniform([-14.0, -4.0, -14.0], [14.0, -0.05, 14.0],
                     (RANDOM_RAYS, 3)).astype(np.float32)
    rd = rng.standard_normal((RANDOM_RAYS, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    r_alive = torch.tensor(rng.random(RANDOM_RAYS) < 0.75, device=dev)
    err = max(err, compare_sweep("random", rows_to_v3(ro, dev),
                                 rows_to_v3(rd, dev), table8, r_alive, tree))

    ms = median_ms(lambda: sphere_sweep.intersect_spheres_sweep(
        o, d, table8, alive, tree), 20)
    dense_ms = median_ms(lambda: sphere_sweep.intersect_spheres_dense(
        o, d, table8, alive), 20)
    plain_ms = median_ms(
        lambda: sphere_sweep.sphere_sweep_reference(o, d, table8), 5)
    n_rays, s8 = o.x.shape[0], table8.shape[0]
    # Rays in: origin, direction, alive; out: t and id; the table once.
    dense_bound = least_ms(n_rays * s8 * FLOPS_PER_TEST,
                           n_rays * (6 * 4 + 1 + 4 + 4) + table8.numel() * 4)
    sel = torch.arange(0, n_rays, n_rays // (1 << 17), device=dev)[:1 << 17]
    so, sd = (V3(*(x[sel].contiguous() for x in v)) for v in (o, d))
    best_t = sphere_sweep.sphere_sweep_reference(so, sd, table8)[0]
    *bound, per = sphere_walk_bound(so, sd, alive[sel].contiguous(), tree,
                                    best_t, n_rays)
    print(f"sweep time at R={n_rays}, S8={s8}: K1 (prefix "
          f"{tree.n_prefix}, then the tree) {ms:.4f} ms, its dense entry "
          f"{dense_ms:.4f} ms, plain PyTorch {plain_ms:.3f} ms (median, CUDA "
          f"events); the walk's work a ray: {per['prefix_tests']:.0f} prefix "
          f"tests, {per['node_tests']:.2f} nodes, {per['sphere_tests']:.2f} "
          f"sphere tests; bound {bound[0]:.4f} ms by {bound[1]} "
          f"({bound[0] / ms:.4f} of it), the dense sweep's "
          f"{dense_bound[0]:.4f} ms by {dense_bound[1]} ({card})")
    return dict(err=err, ms=ms, dense_ms=dense_ms, plain_ms=plain_ms,
                bound=tuple(bound), dense_bound=dense_bound)


# ---- K3 on the mesh path.  Written against paged_tri's entry point and
# the Renderer alone, so tools/chip_probe.py runs them on a parent checkout
# too, whose K3 walked page tables.

def k3_tables(geom):
    """The tables K3 takes in a paged wavefront's batch geometry: its tree,
    or a parent checkout's page tables."""
    tree = getattr(geom, "tri_tree", None)
    return tree if tree is not None else geom.tri_pages


def capture_bounces(renderer, batch: int = 0):
    """(geometry, [(o, d, alive)] of every bounce) of one batch of a
    wavefront Renderer, rendered through render_tile with a trace that
    keeps each bounce's rays."""
    from raytrace_tpu_torch.engine import wavefront

    static, geom = renderer.static, renderer._geometry(batch)
    trace = wavefront.make_trace_fn(static, renderer.scene, geom)
    seen = []

    def capture(o, d, alive):
        seen.append((o, d, alive))
        return trace(o, d, alive)

    wavefront.render_tile(static, renderer.scene, renderer.camera, capture,
                          geom, batch, 0, static.height, renderer.use_dof)
    torch.cuda.synchronize()
    return geom, seen


def subset_rays(o, d, alive, n, gen):
    """``n`` of the rays (o, d, alive), drawn with ``gen``."""
    from raytrace_tpu_torch.ops.vec3 import V3

    sel = torch.randperm(o.x.shape[0], generator=gen)[:n].to(o.x.device)
    return (*(V3(*(x[sel].contiguous() for x in v)) for v in (o, d)),
            alive[sel].contiguous())


def bounce_ms(launch, seen, reps: int = 3, first_reps: int = 5):
    """A kernel's median device ms (median_ms) of ``launch(o, d, alive)``
    on the first bounce's rays (``first_reps`` reps) and on each bounce's
    of ``seen`` (``reps`` each): (first ms, [ms a bounce])."""
    o, d, a = seen[0]
    return (median_ms(lambda: launch(o, d, a), first_reps),
            [median_ms(lambda o=o, d=d, a=a: launch(o, d, a), reps)
             for o, d, a in seen])


def bvh_work(o, d, alive, table12, trees, n: int, gen):
    """H1's work a ray on ``n`` of the rays (o, d, alive): ops/bvh.
    visit_counts against H1's own closest hits over each of ``trees``
    (its walk's first, which it launches on; binary or four-wide rows of
    the same boxes), as ((node steps, triangle tests) a ray, the distinct
    bytes those read: 64 a binary and 128 a wide node row, 48 a triangle
    row) for each."""
    from raytrace_tpu_torch.ops import bvh

    so, sd, sa = subset_rays(o, d, alive, n, gen)
    best_t = bvh.intersect_tris_bvh(so, sd, table12, trees[0], sa).t
    out = []
    for tree in trees:
        w = bvh.visit_counts(so, sd, tree, best_t, sa)
        rays = max(1, w["rays"])
        out.append(((w["node_tests"] / rays, w["tri_tests"] / rays),
                    w["nodes_read"] * 4 * tree.nodes.shape[1]
                    + w["tris_read"] * 48))
    return out


def sphere_obj_work(o, d, alive, launch, tree, n: int, gen):
    """H2's work on ``n`` of the rays (o, d, alive) through ``tree``
    (ops/sphere_tree.sphere_tree_visit_counts against ``launch``'s own
    closest hits): (prefix tests, node tests and sphere tests a ray as a
    dict, the counts' dict with the distinct rows read)."""
    from raytrace_tpu_torch.ops import sphere_tree

    so, sd, sa = subset_rays(o, d, alive, n, gen)
    w = sphere_tree.sphere_tree_visit_counts(so, sd, tree,
                                             launch(so, sd, sa).t, sa)
    return {key: w[key] / max(1, w["rays"]) for key in (
        "prefix_tests", "node_tests", "sphere_tests")}, w


def k3_bounce_ms(tables, bounces, reps: int = 3):
    """K3's median device ms (median_ms) on each bounce's rays."""
    from raytrace_tpu_torch.ops import paged_tri

    return [median_ms(lambda o=o, d=d, a=a: paged_tri.intersect_tris_paged(
        o, d, tables, a), reps) for o, d, a in bounces]


def grazing_rays(boxes, n: int, seed: int, dev, jitter: float = 1e-5):
    """n rays from 1,000-2,000 units away aimed at points on random edges
    of the [.., 6] boxes (min xyz, max xyz), each aim moved by ``jitter``
    of its magnitude (tests/test_torch_tri_tree.py's far grazing rays):
    (o, d) as V3s on ``dev``."""
    g = np.random.default_rng(seed)
    b = boxes[g.integers(0, len(boxes), n)].astype(np.float64)
    mn, mx = b[:, :3], b[:, 3:]
    p = np.where(g.random((n, 3)) < 0.5, mn, mx)
    ax, rows = g.integers(0, 3, n), np.arange(n)
    p[rows, ax] = mn[rows, ax] + g.random(n) * (mx - mn)[rows, ax]
    w = g.standard_normal((n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    o = p + w * g.uniform(1000, 2000, (n, 1))
    d = p + g.standard_normal((n, 3)) * jitter * (1 + np.abs(p)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (rows_to_v3(o.astype(np.float32), dev),
            rows_to_v3(d.astype(np.float32), dev))


def multichip_rank(rank: int, world: int, init: str, jobs, results,
                   device: str = "cuda:0") -> None:
    """One rank of chip_smoke.py's multi-rank phase, a process of its own
    (torch.multiprocessing spawn): a gloo process group of ``world`` ranks
    over ``init`` (a ``file://`` rendezvous), every rank on the one
    ``device`` (NCCL refuses two ranks on one card; parallel/multichip.py
    takes gloo's collectives through host copies), then each job (name, compiled
    scene, MultiChipRenderer keywords) rendered whole: a first batch
    stepped, a warm-up (the first launch, the groups' first collectives),
    then the rest by ``render_all``, whose batches, render seconds and
    collective seconds are reported apart from the first's.  Puts (rank,
    {name: what the job gave}, None) on ``results``, or (rank, None, the
    traceback) where the rank failed.  Each job's kernel launches are
    counted from 0 for it."""
    import traceback

    try:
        import torch.distributed as dist

        from ..ops import megakernel, sphere_sweep
        from ..parallel import MultiChipRenderer

        if torch.device(device).type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        out = {}
        for name, cs, kw in jobs:
            megakernel.LAUNCHES = sphere_sweep.LAUNCHES = 0
            m = MultiChipRenderer(cs, device=device, **kw)
            m.render_next_batch()
            warm_s, warm_c = m.stats.render_seconds, m.collective_seconds()
            img = m.render_all()
            out[name] = dict(
                img=img, rays=m.stats.rays_traced, path=m.path,
                layout=(m.layout.px, m.layout.sp, m.layout.sc),
                k4=megakernel.LAUNCHES, k1=sphere_sweep.LAUNCHES,
                batches=m.stats.batches_done - 1,
                render_s=m.stats.render_seconds - warm_s,
                collective_s=m.collective_seconds() - warm_c,
                warm_render_s=warm_s, warm_collective_s=warm_c,
                rows=(m.row_base, m.rows, m.rows_local),
                samples=(m.sample_base, m.spp_local))
        dist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))


def app_trace(compiled, log_dir: str, results,
              device: str = "cuda:0") -> None:
    """chip_smoke.py's profiled batch of the app layer, a process of its
    own (torch.multiprocessing spawn: a second torch.profiler session in
    one process has dropped the card's kernel events): the compiled
    scene's first batch with the Renderer's defaults under
    ``utils/profiling.trace(log_dir)``.  Puts ({"path": the
    Renderer's, "trace": the Chrome trace's file, "kernels": the names of
    its kernel events, "launches": K4's launches in the batch}, None) on
    ``results``, or (None, the traceback) where it failed."""
    import json
    import traceback

    try:
        from ..engine import Renderer
        from ..ops import megakernel
        from ..utils import profiling

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        r = Renderer(compiled, device=dev)
        launches = megakernel.LAUNCHES
        with profiling.trace(log_dir) as prof:
            r.render_next_batch()
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        results.put(({
            "path": r.path, "trace": prof.trace_path,
            "kernels": sorted({e["name"] for e in events
                               if e.get("cat") == "kernel"}),
            "launches": megakernel.LAUNCHES - launches}, None))
    except BaseException:
        results.put((None, traceback.format_exc()))
