#!/usr/bin/env python3
"""Smoke run of the PyTorch port (raytrace_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's render paths through the entry points a user calls,
on the repository's two scenes at their full size: final-one-weekend at
1200x675 with its 4 spp and depth 50 (static: the fused kernel K4 and the
wavefront with K1), and final-one-weekend-motion-blur at its shipped
1024x576, 4 spp x 25 batches, depth 50 (391 of 488 spheres moving: K4's
animated form, and the wavefront).  Every phase is checked; any failure
raises and the script exits non-zero without printing a result.  Phases:

1. needs torch.cuda.is_available(); prints nvidia-smi's name and power limit;
2. builds both kernel sources from the checkout, in parallel: the sphere
   sweep K1 (csrc/sphere_sweep.cu) and the fused bounce kernel K4
   (csrc/megakernel.cu, static and animated forms), with nvcc's register
   report;
3. K1 against the plain PyTorch sweep: the 3,240,000 primary rays of the
   main path and 2^20 random rays with an alive mask (ids equal, and ids
   equal with t within rtol=1e-3, atol=1e-3, each on >= 99.9% of rays),
   timed with CUDA events;
4. K4 against its plain version (the wavefront loop with the plain sweep):
   at 96x54, depth 8, 2 batches fused (rays within 0.5%, per-sample channel
   means within 1e-3, at most 5% of pixels above 1e-4) and at the main
   path's 1200x675, 4 spp, depth 50, one batch (rays within 0.5%, means
   within 2e-3); two launches give the same bytes; both timed with CUDA
   events; then K4's animated form the same way on the motion-blur scene,
   at 96x54/depth 8/k=2 and at 1024x576/depth 50/k=1;
5. the wavefront path, Renderer(cs, use_megakernel=False): several batches,
   counting K1 launches; the image checks; the same for the motion-blur
   scene; a small frame on the card against the CPU, for both paths and
   the animated fused path;
6. the main path, Renderer(cs) with defaults: it must take the fused path
   (K4 launched, K1 not); Mrays/s over batches 1-3 stepped one at a time
   and over one fused chunk of 12 batches, the chunk beside the 298.602
   that PERF.md records for the static kernel before its animated form; the image checks; then the motion-blur
   scene's Renderer with defaults, which must take the animated fused
   path (one animated K4 launch per batch stepped and per chunk), with
   the same numbers and its image within 2e-3 of the wavefront's means;
7. checkpoint round trips on both paths, with the same chunk boundaries:
   the resumed image must be byte-identical to the uninterrupted render;
8. the CLI renders all 25 batches of each scene to a PNG (fused chunks);
9. one fused chunk of each scene under torch.profiler (one session):
   device busy share, the fused kernel's share of device time and device
   operations per batch.

The line before the last is the kernels' JSON record (with each kernel's
bound: the larger of its FP32 operations over 67 TFLOP/s and its bytes
over 3.35 TB/s, counted from this run's inputs), the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

WIDTH, HEIGHT = 1200, 675
MB_WIDTH, MB_HEIGHT = 1024, 576   # the motion-blur scene's shipped size
MAIN_BATCHES = 4          # the first one is warm-up for the Mrays/s figure
CHUNK_BATCHES = 12        # Renderer.CHUNK: one fused launch
CKPT_SPLIT = 2            # round trip: save after this many batches
RANDOM_RAYS = 1 << 20
AGREEMENT = 0.999
RTOL = ATOL = 1e-3
# The static fused chunk's Mrays/s that PERF.md records for the static
# kernel before its animated form was added (NVIDIA H100 80GB HBM3,
# 700 W), printed beside this run's.
STATIC_CHUNK_MRAYS_BEFORE = 298.602

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


def _bound(flops: float, nbytes: float):
    """(least ms, "operations" or "bytes"): the larger of the two."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _k4_bound(geom, traced_sum: int, width: int, height: int,
              n_times: int):
    """K4's bound for one launch: every bounce tests every table row;
    bytes are the tables, rows, parameters (and motion rows and times)
    read once and the sums and counts written once."""
    s8 = geom.sph_table8.shape[0]
    anim = geom.sph_dtab8 is not None
    per_test = FLOPS_PER_TEST_ANIM if anim else FLOPS_PER_TEST
    nbytes = (geom.sph_table8.numel() + geom.prim_rows.numel() + 40) * 4
    if anim:
        nbytes += (geom.sph_dtab8.numel() + n_times) * 4
    nbytes += width * height * (3 * 4 + 4)
    return _bound(traced_sum * s8 * per_test, nbytes)


def _median_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _compare_sweep(name, o, d, table8, alive):
    """Kernel vs plain version on the same rays.  A ray agrees when both
    give the same sphere id and t within rtol/atol; ids must agree on
    >= 99.9% of rays, and so must whole hits.  (A ray that starts within
    float error of T_MIN from a surface may keep the near root in one
    version and take the far root in the other.)  Returns max |dt| over
    the rays that agree."""
    import torch

    from raytrace_tpu_torch.ops import sphere_sweep
    from raytrace_tpu_torch.ops.intersect import T_MAX

    hit = sphere_sweep.intersect_spheres_sweep(o, d, table8, alive)
    t_ref, id_ref = sphere_sweep.sphere_sweep_reference(o, d, table8)
    t_ref = torch.where(alive, t_ref, T_MAX)
    id_ref = torch.where(alive, id_ref, -1)
    torch.cuda.synchronize()
    same_id = hit.sph == id_ref
    agree = same_id & ((hit.t - t_ref).abs() <= ATOL + RTOL * t_ref.abs())
    frac_id = same_id.double().mean().item()
    frac = agree.double().mean().item()
    if frac_id < AGREEMENT or frac < AGREEMENT:
        raise AssertionError(f"{name}: ids agree on {frac_id:.6f}, hits on "
                             f"{frac:.6f} of rays (need {AGREEMENT})")
    err = (hit.t[agree] - t_ref[agree]).abs().max().item()
    hits = (hit.sph >= 0).double().mean().item()
    print(f"sweep {name}: R={o.x.shape[0]} S8={table8.shape[0]}: ids agree "
          f"on {frac_id:.6f}, (id, t) on {frac:.6f} of rays "
          f"({int((same_id & ~agree).sum())} same-id root flips); hit share "
          f"{hits:.4f}; max |dt| where they agree {err:.3g}")
    return err


def _scene(cs, width, height, depth=None, batches=None):
    render = dataclasses.replace(
        cs.render, width=width, height=height,
        max_ray_depth=depth or cs.render.max_ray_depth,
        sample_batches=batches or cs.render.sample_batches)
    return dataclasses.replace(cs, render=render)


def _compare_fused(label, renderer, k, mean_tol, pixel_share, card):
    """K4 vs its plain version on batches 0..k-1 of ``renderer``'s frame.
    Rays within 0.5%, per-sample channel means within mean_tol, and (when
    pixel_share is set) at most that share of pixels with a max-channel
    difference above 1e-4; two launches must give the same bytes.
    Returns (max |sums difference|, launch args, launch keywords, rays)."""
    import torch

    from raytrace_tpu_torch.ops import megakernel

    if not renderer.use_megakernel:
        raise AssertionError(f"{label}: the gate rejected the scene")
    args = (renderer.static, renderer.scene, renderer._geometry(0),
            renderer.camera, 0, k)
    kw = dict(use_dof=renderer.use_dof, times=renderer.batch_times_dev)
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    again, traced2 = megakernel.render_tile_mega(*args, **kw)
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(sums, again) and torch.equal(traced, traced2)):
        raise AssertionError(f"{label}: two launches differ")
    if not torch.isfinite(sums).all():
        raise AssertionError(f"{label}: non-finite sums")
    n = 4 * k
    rays, ref_rays = int(traced.sum()), int(ref_traced.sum())
    mdiff = ((sums.mean((0, 1)) - ref.mean((0, 1))).abs().max() / n).item()
    pix = (sums - ref).abs().amax(-1)
    bad = (pix > 1e-4).double().mean().item()
    err = pix.max().item()
    bitwise = torch.equal(sums, ref) and torch.equal(traced, ref_traced)
    print(f"fused {label}: rays {rays} vs plain {ref_rays}; per-sample "
          f"channel-mean diff {mdiff:.3g}; pixels above 1e-4: {bad:.6f}; "
          f"traced counts equal on "
          f"{(traced == ref_traced).double().mean().item():.6f} of pixels; "
          f"max |dsum| {err:.3g}; bit for bit: {bitwise}; repeat launch "
          f"byte-identical ({card})")
    if abs(rays - ref_rays) > 0.005 * ref_rays or mdiff > mean_tol or (
            pixel_share is not None and bad > pixel_share):
        raise AssertionError(f"{label}: kernel and plain version disagree")
    return err, args, kw, rays


def _check_image(img, label, width=WIDTH, height=HEIGHT):
    means = img.mean(axis=(0, 1))
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{label}: image is not a finite [H, W, 3] array")
    if (img < 0).any() or not ((means > 0.05) & (means < 1.5)).all():
        raise AssertionError(f"{label}: image out of range: means {means}")
    print(f"{label} image: channel means {means.tolist()}")


def _step(renderer, batches):
    """Render ``batches`` one by one; [(rays, seconds)] per batch."""
    out = []
    for _ in range(batches):
        rays0, sec0 = renderer.stats.rays_traced, renderer.stats.render_seconds
        if not renderer.render_next_batch():
            raise AssertionError("render_next_batch returned False")
        out.append((renderer.stats.rays_traced - rays0,
                    renderer.stats.render_seconds - sec0))
    return out


def _mrays(per_batch):
    return sum(r for r, _ in per_batch) / sum(s for _, s in per_batch) / 1e6


def _busy_share(events, label, wall_s):
    """(device busy share of wall_s, device operations, fused-kernel share
    of device time) for the chunk profiled under record_function(label):
    the union of the card's operation intervals that start inside that
    host range (the chunk ends in a synchronize) over the wall time."""
    from torch.autograd import DeviceType

    host = [e for e in events
            if e.name == label and e.device_type == DeviceType.CPU]
    if len(host) != 1:
        raise AssertionError(f"profile: {len(host)} host ranges '{label}'")
    lo, hi = host[0].time_range.start, host[0].time_range.end
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and lo <= e.time_range.start <= hi)
    busy, end, k4 = 0.0, -1.0, 0.0
    for s, e, name in spans:
        if "megakernel" in name:
            k4 += e - s
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6 / wall_s, len(spans), k4 / busy if busy else 0.0


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs one CUDA card", file=sys.stderr)
        return 1
    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.engine.wavefront import prepare_batch, primary_rays
    from raytrace_tpu_torch.ops import _build, megakernel, sphere_sweep
    from raytrace_tpu_torch.ops.vec3 import V3

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # -- 2. build both kernels, one nvcc each, started together ------------
    def timed_build(mod):
        t0 = time.perf_counter()
        mod.library()
        return time.perf_counter() - t0

    mods = {"sphere_sweep": sphere_sweep, "megakernel": megakernel}
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        secs = dict(zip(mods, pool.map(timed_build, mods.values())))
    for name, sec in secs.items():
        print(f"build: csrc/{name}.cu in {sec:.2f} s")
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    # -- 3. K1 vs plain at the main path's shapes ---------------------------
    cs = cli.load_scene(cli.DEFAULT_SCENE, WIDTH, HEIGHT)
    probe = Renderer(cs, device=dev, use_megakernel=False)
    geom = prepare_batch(probe.static, probe.scene,
                         torch.tensor(probe.sphere_tables[0], device=dev))
    table8 = geom.sph_table8
    _, o, d = primary_rays(probe.static, probe.camera, 0, 0, HEIGHT,
                           probe.use_dof, dev)
    if o.x.shape[0] != WIDTH * HEIGHT * 4:
        raise AssertionError(f"primary rays: {o.x.shape[0]}")
    alive = torch.ones(o.x.shape[0], dtype=torch.bool, device=dev)
    err = _compare_sweep("primary", o, d, table8, alive)

    rng = np.random.default_rng(0)
    # Origins in the scene's air (its ground fills y > 0).
    ro = rng.uniform([-14.0, -4.0, -14.0], [14.0, -0.05, 14.0],
                     (RANDOM_RAYS, 3)).astype(np.float32)
    rd = rng.standard_normal((RANDOM_RAYS, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    to_v3 = lambda a: V3(*(torch.tensor(np.ascontiguousarray(a[:, i]),  # noqa
                                        device=dev) for i in range(3)))
    r_alive = torch.tensor(rng.random(RANDOM_RAYS) < 0.75, device=dev)
    err = max(err, _compare_sweep("random", to_v3(ro), to_v3(rd), table8,
                                  r_alive))

    ms = _median_ms(
        lambda: sphere_sweep.intersect_spheres_sweep(o, d, table8, alive), 20)
    plain_ms = _median_ms(
        lambda: sphere_sweep.sphere_sweep_reference(o, d, table8), 5)
    n_rays, s8 = o.x.shape[0], table8.shape[0]
    # Rays in: origin, direction, alive; out: t and id; the table once.
    k1_bound = _bound(n_rays * s8 * FLOPS_PER_TEST,
                      n_rays * (6 * 4 + 1 + 4 + 4) + table8.numel() * 4)
    print(f"sweep time at R={n_rays}, S8={s8}: kernel {ms:.3f} ms, plain "
          f"PyTorch {plain_ms:.3f} ms (median, CUDA events); bound "
          f"{k1_bound[0]:.4f} ms by {k1_bound[1]} ({card})")
    del probe, geom, o, d, alive

    # -- 4. K4 vs plain -----------------------------------------------------
    small = _scene(cs, 96, 54, depth=8, batches=2)
    k4_err, _, _, _ = _compare_fused("96x54 depth 8 k=2",
                                     Renderer(small, device=dev), 2, 1e-3,
                                     0.05, card)
    full = Renderer(cs, device=dev)
    err_full, args, kw, k4_rays = _compare_fused(
        f"{WIDTH}x{HEIGHT} 4 spp depth 50 k=1", full, 1, 2e-3, None, card)
    k4_err = max(k4_err, err_full)
    k4_ms = _median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    k4_plain_ms = _median_ms(
        lambda: megakernel.megakernel_reference(*args, **kw), 2)
    k4_bound = _k4_bound(args[2], k4_rays, WIDTH, HEIGHT, 0)
    print(f"fused kernel time at {WIDTH}x{HEIGHT}, 4 spp, depth 50, one "
          f"batch: kernel {k4_ms:.3f} ms (median of 5), plain PyTorch "
          f"{k4_plain_ms:.3f} ms (median of 2) (CUDA events); bound "
          f"{k4_bound[0]:.4f} ms by {k4_bound[1]} ({card})")
    del full, args, kw

    # -- 4b. K4's animated form vs plain, on the motion-blur scene ----------
    mb_scene = os.path.join(os.path.dirname(cli.DEFAULT_SCENE),
                            "final-one-weekend-motion-blur.json")
    cs_mb = cli.load_scene(mb_scene)
    if (cs_mb.render.width, cs_mb.render.height) != (MB_WIDTH, MB_HEIGHT):
        raise AssertionError("the motion-blur scene's size changed")
    mb_small = Renderer(_scene(cs_mb, 96, 54, depth=8, batches=2),
                        device=dev)
    mb_full = Renderer(cs_mb, device=dev)
    if mb_small.path != "fused_anim" or mb_full.path != "fused_anim":
        raise AssertionError("the motion-blur scene did not take the "
                             "animated fused path")
    anim_err, _, _, _ = _compare_fused("motion-blur 96x54 depth 8 k=2",
                                       mb_small, 2, 1e-3, 0.05, card)
    err_full, args, kw, anim_rays = _compare_fused(
        f"motion-blur {MB_WIDTH}x{MB_HEIGHT} 4 spp depth 50 k=1", mb_full,
        1, 2e-3, None, card)
    anim_err = max(anim_err, err_full)
    anim_ms = _median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    anim_plain_ms = _median_ms(
        lambda: megakernel.megakernel_reference(*args, **kw), 2)
    anim_bound = _k4_bound(args[2], anim_rays, MB_WIDTH, MB_HEIGHT,
                           len(mb_full.batch_times))
    print(f"animated fused kernel time at {MB_WIDTH}x{MB_HEIGHT}, 4 spp, "
          f"depth 50, one batch: kernel {anim_ms:.3f} ms (median of 5), "
          f"plain PyTorch {anim_plain_ms:.3f} ms (median of 2) (CUDA "
          f"events); bound {anim_bound[0]:.4f} ms by {anim_bound[1]} "
          f"({card})")
    del mb_small, mb_full, args, kw

    # -- 5. the wavefront path ----------------------------------------------
    sphere_sweep.LAUNCHES = megakernel.LAUNCHES = megakernel.ANIM_LAUNCHES = 0
    wave = Renderer(cs, device=dev, use_megakernel=False)
    per_batch = _step(wave, MAIN_BATCHES)
    sweep_launches = sphere_sweep.LAUNCHES
    if sweep_launches <= 0 or megakernel.LAUNCHES:
        raise AssertionError("the wavefront path did not run on K1 alone")
    for i, (r, s) in enumerate(per_batch):
        print(f"wavefront batch {i}: {r} rays in {s:.4f} s "
              f"({r / s / 1e6:.3f} Mrays/s)")
    print(f"wavefront path: final-one-weekend {WIDTH}x{HEIGHT}, 4 spp, depth "
          f"50: {_mrays(per_batch[1:]):.3f} Mrays/s over batches "
          f"1-{MAIN_BATCHES - 1}; sphere_sweep LAUNCHES={sweep_launches} "
          f"({card})")
    wave_img = wave.image()
    _check_image(wave_img, "wavefront")

    sphere_sweep.LAUNCHES = megakernel.LAUNCHES = megakernel.ANIM_LAUNCHES = 0
    wave_mb = Renderer(cs_mb, device=dev, use_megakernel=False)
    per_batch = _step(wave_mb, MAIN_BATCHES)
    if sphere_sweep.LAUNCHES <= 0 or megakernel.LAUNCHES:
        raise AssertionError("the motion-blur wavefront did not run on K1 "
                             "alone")
    print(f"wavefront path: final-one-weekend-motion-blur {MB_WIDTH}x"
          f"{MB_HEIGHT}, 4 spp, depth 50: {_mrays(per_batch[1:]):.3f} "
          f"Mrays/s over batches 1-{MAIN_BATCHES - 1}; sphere_sweep "
          f"LAUNCHES={sphere_sweep.LAUNCHES} ({card})")
    wave_mb_img = wave_mb.image()
    _check_image(wave_mb_img, "motion-blur wavefront", MB_WIDTH, MB_HEIGHT)
    del wave_mb

    # Small-input reference: the same frame on the card and on the CPU
    # (plain versions) must agree in channel means and ray counts.
    tiny = _scene(cs, 96, 54, depth=8, batches=1)
    tiny_mb = _scene(cs_mb, 96, 54, depth=8, batches=2)
    for name, small_cs, fused in (("final-one-weekend", tiny, False),
                                  ("final-one-weekend", tiny, True),
                                  ("motion-blur", tiny_mb, False),
                                  ("motion-blur", tiny_mb, True)):
        gpu_s = Renderer(small_cs, device=dev, use_megakernel=fused)
        cpu_s = Renderer(small_cs, device="cpu", use_megakernel=fused)
        if gpu_s.path != cpu_s.path:
            raise AssertionError(f"{name}: card path {gpu_s.path}, CPU path "
                                 f"{cpu_s.path}")
        g_img, c_img = gpu_s.render_all(), cpu_s.render_all()
        g_rays, c_rays = gpu_s.stats.rays_traced, cpu_s.stats.rays_traced
        mdiff = np.abs(g_img.mean(axis=(0, 1)) - c_img.mean(axis=(0, 1))).max()
        rmse = float(np.sqrt(np.mean((g_img - c_img) ** 2)))
        if mdiff > 1e-2 or abs(g_rays - c_rays) > 0.02 * c_rays:
            raise AssertionError(f"{name} {gpu_s.path} card vs CPU at 96x54: "
                                 f"mean diff {mdiff}, rays {g_rays} vs "
                                 f"{c_rays}")
        print(f"{name} {gpu_s.path} card vs CPU at 96x54, depth 8: max "
              f"channel-mean diff {mdiff:.3g}, RMSE {rmse:.3g}, rays "
              f"{g_rays} vs {c_rays} ({card})")

    # -- 6. the main path: Renderer with defaults, the fused kernel ---------
    sphere_sweep.LAUNCHES = megakernel.LAUNCHES = megakernel.ANIM_LAUNCHES = 0
    main_r = Renderer(cs, device=dev)
    per_batch = _step(main_r, MAIN_BATCHES)
    rays0, sec0 = main_r.stats.rays_traced, main_r.stats.render_seconds
    if main_r.render_batches(CHUNK_BATCHES) != CHUNK_BATCHES:
        raise AssertionError("render_batches rendered a short chunk")
    chunk = (main_r.stats.rays_traced - rays0,
             main_r.stats.render_seconds - sec0)
    k4_launches = megakernel.LAUNCHES
    if (main_r.path != "fused" or k4_launches <= 0 or sphere_sweep.LAUNCHES
            or megakernel.ANIM_LAUNCHES):
        raise AssertionError("the main path did not take the fused kernel "
                             f"(K4 {k4_launches}, K1 {sphere_sweep.LAUNCHES})")
    for i, (r, s) in enumerate(per_batch):
        print(f"fused batch {i}: {r} rays in {s:.4f} s "
              f"({r / s / 1e6:.3f} Mrays/s)")
    print(f"main path (fused): final-one-weekend {WIDTH}x{HEIGHT}, 4 spp, "
          f"depth 50: {_mrays(per_batch[1:]):.3f} Mrays/s over batches "
          f"1-{MAIN_BATCHES - 1} stepped one at a time; "
          f"{_mrays([chunk]):.3f} Mrays/s over one {CHUNK_BATCHES}-batch "
          f"chunk ({chunk[0]} rays in {chunk[1]:.4f} s); megakernel "
          f"LAUNCHES={k4_launches}, sphere_sweep LAUNCHES=0 ({card})")
    print(f"static fused chunk: {_mrays([chunk]):.3f} Mrays/s in this run, "
          f"{STATIC_CHUNK_MRAYS_BEFORE} before the animated form "
          f"(PERF.md) ({card})")
    _check_image(main_r.image(), "fused")
    del main_r

    # The motion-blur scene's main path: Renderer with defaults, the
    # animated fused kernel, one launch per stepped batch and per chunk.
    sphere_sweep.LAUNCHES = megakernel.LAUNCHES = megakernel.ANIM_LAUNCHES = 0
    mb_r = Renderer(cs_mb, device=dev)
    per_batch = _step(mb_r, MAIN_BATCHES)
    fused_mb_img = mb_r.image()
    rays0, sec0 = mb_r.stats.rays_traced, mb_r.stats.render_seconds
    if mb_r.render_batches(CHUNK_BATCHES) != CHUNK_BATCHES:
        raise AssertionError("render_batches rendered a short chunk")
    mb_chunk = (mb_r.stats.rays_traced - rays0,
                mb_r.stats.render_seconds - sec0)
    anim_launches = megakernel.ANIM_LAUNCHES
    if (mb_r.path != "fused_anim" or anim_launches != MAIN_BATCHES + 1
            or megakernel.LAUNCHES != anim_launches or sphere_sweep.LAUNCHES):
        raise AssertionError(
            f"the motion-blur main path did not take the animated fused "
            f"kernel (path {mb_r.path}, K4 {megakernel.LAUNCHES}, animated "
            f"{anim_launches}, K1 {sphere_sweep.LAUNCHES})")
    for i, (r, s) in enumerate(per_batch):
        print(f"motion-blur fused batch {i}: {r} rays in {s:.4f} s "
              f"({r / s / 1e6:.3f} Mrays/s)")
    print(f"motion-blur main path (animated fused): "
          f"final-one-weekend-motion-blur {MB_WIDTH}x{MB_HEIGHT}, 4 spp, "
          f"depth 50: {_mrays(per_batch[1:]):.3f} Mrays/s over batches "
          f"1-{MAIN_BATCHES - 1} stepped one at a time; "
          f"{_mrays([mb_chunk]):.3f} Mrays/s over one {CHUNK_BATCHES}-batch "
          f"chunk ({mb_chunk[0]} rays in {mb_chunk[1]:.4f} s); path "
          f"{mb_r.path}, megakernel LAUNCHES={megakernel.LAUNCHES} (animated "
          f"{anim_launches}), sphere_sweep LAUNCHES=0 ({card})")
    _check_image(mb_r.image(), "motion-blur fused", MB_WIDTH, MB_HEIGHT)
    mdiff = np.abs(fused_mb_img.mean(axis=(0, 1))
                   - wave_mb_img.mean(axis=(0, 1))).max()
    print(f"motion-blur fused vs wavefront over batches 0-"
          f"{MAIN_BATCHES - 1}: max channel-mean diff {mdiff:.3g} ({card})")
    if mdiff > 2e-3:
        raise AssertionError("motion-blur: the fused and wavefront renders "
                             "disagree")
    del mb_r

    # -- 7. checkpoint round trips, same chunk boundaries --------------------
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        for fused in (False, True):
            one_shot = Renderer(cs, device=dev, use_megakernel=fused)
            one_shot.render_batches(CKPT_SPLIT)
            one_shot.render_batches(MAIN_BATCHES - CKPT_SPLIT)
            first = Renderer(cs, device=dev, use_megakernel=fused)
            first.render_batches(CKPT_SPLIT)
            first.save_checkpoint(ck)
            resumed = Renderer(cs, device=dev, use_megakernel=fused)
            resumed.load_checkpoint(ck)
            resumed.render_batches(MAIN_BATCHES - CKPT_SPLIT)
            path = "fused" if fused else "wavefront"
            if resumed.image().tobytes() != one_shot.image().tobytes():
                raise AssertionError(f"{path}: resumed render differs")
            if not fused and one_shot.image().tobytes() != wave_img.tobytes():
                raise AssertionError("wavefront: render differs from the "
                                     "main-path render")
            print(f"checkpoint ({path}): resume after batch {CKPT_SPLIT} of "
                  f"{MAIN_BATCHES} is byte-identical")

        # -- 8. CLI: every batch of each scene -------------------------------
        for scene_path, size_args, (w, h), path in (
                (cli.DEFAULT_SCENE, ["--width", str(WIDTH), "--height",
                                     str(HEIGHT)], (WIDTH, HEIGHT), "fused"),
                (mb_scene, [], (MB_WIDTH, MB_HEIGHT), "fused_anim")):
            name = os.path.splitext(os.path.basename(scene_path))[0]
            png = os.path.join(tmp, name + ".png")
            capture = _Capture()
            logging.getLogger("raytrace_tpu_torch").addHandler(capture)
            t0 = time.perf_counter()
            rc = cli.main(["render", "--path", scene_path, *size_args,
                           "-o", png])
            logging.getLogger("raytrace_tpu_torch").removeHandler(capture)
            if rc != 0 or not os.path.getsize(png):
                raise AssertionError(f"cli render of {name} failed: rc={rc}")
            with open(png, "rb") as f:
                head = f.read(24)
            if head[:8] != b"\x89PNG\r\n\x1a\n" or (
                    int.from_bytes(head[16:20], "big"),
                    int.from_bytes(head[20:24], "big")) != (w, h):
                raise AssertionError(f"cli wrote no valid PNG of {name}'s "
                                     f"size")
            if f"path: fused bounce kernel ({path})" not in capture.lines:
                raise AssertionError(f"the cli did not take the {path} path "
                                     f"for {name}")
            done = [m for m in capture.lines if m.startswith("rendered ")]
            chunks = len([m for m in capture.lines if m.startswith("batch ")])
            print(f"cli {name} ({path}): "
                  f"{done[-1] if done else 'no summary'}; {chunks} chunks; "
                  f"{time.perf_counter() - t0:.1f} s in all ({card})")

    # -- 9. one fused chunk of each scene under the profiler ----------------
    # One profiler session for both chunks, each under its own
    # record_function range (a second session in one process has dropped
    # the kernel's device events).
    from torch.profiler import ProfilerActivity, profile, record_function

    runs = []
    for name, prof_cs in (("final-one-weekend", cs),
                          ("final-one-weekend-motion-blur", cs_mb)):
        prof_r = Renderer(prof_cs, device=dev)
        prof_r.render_batches(CHUNK_BATCHES)   # warm-up
        sec0 = prof_r.stats.render_seconds
        prof_r.render_batches(CHUNK_BATCHES)
        prof_r.current_batch = 0
        runs.append((name, prof_r, prof_r.stats.render_seconds - sec0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, prof_r, _ in runs:
            with record_function(name):
                prof_r.render_batches(CHUNK_BATCHES)
    events = prof.events()
    for name, prof_r, untraced in runs:
        share, n_ops, k4_share = _busy_share(events, name, untraced)
        busy = (f"device busy {share * untraced:.4f} s = {share:.4f} of the "
                f"untraced wall; the fused kernel {k4_share:.4f} of device "
                f"time" if k4_share > 0 else
                "the profiler recorded no fused-kernel time: device busy "
                "share not measured")
        print(f"profile of one {CHUNK_BATCHES}-batch fused chunk of {name} "
              f"({prof_r.path}): untraced {untraced:.4f} s; {busy}; {n_ops} "
              f"device operations, {n_ops / CHUNK_BATCHES:.2f} per batch "
              f"({card})")
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=8))
    del runs, prof_r

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    # No single PyTorch call computes a closest-hit sweep or a whole path
    # tracer, so library_ms is null for each kernel.
    print(json.dumps({"kernels": [{
        "name": "sphere_sweep", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/sphere_sweep.cu",
        "replaces": "raytrace_tpu/ops/pallas_sweep.py:33",
        "launches": sweep_launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1], "library_ms": None,
    }, {
        "name": "megakernel", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms,
        "plain_ms": k4_plain_ms, "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1], "library_ms": None,
    }, {
        "name": "megakernel_anim", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": anim_launches, "max_abs_err": anim_err, "ms": anim_ms,
        "plain_ms": anim_plain_ms, "bound_ms": anim_bound[0],
        "bound_by": anim_bound[1], "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
