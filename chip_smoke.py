#!/usr/bin/env python3
"""Smoke run of the PyTorch port (raytrace_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's two render paths on final-one-weekend at 1200x675 with
its 4 spp and depth 50, through the entry points a user calls, and checks
every phase; any failure raises and the script exits non-zero without
printing a result.  Phases:

1. needs torch.cuda.is_available(); prints nvidia-smi's name and power limit;
2. builds both kernels from the checkout, in parallel: the sphere sweep
   K1 (csrc/sphere_sweep.cu) and the fused bounce kernel K4
   (csrc/megakernel.cu), with nvcc's register report;
3. K1 against the plain PyTorch sweep: the 3,240,000 primary rays of the
   main path and 2^20 random rays with an alive mask (ids equal, and ids
   equal with t within rtol=1e-3, atol=1e-3, each on >= 99.9% of rays),
   timed with CUDA events;
4. K4 against its plain version (the wavefront loop with the plain sweep):
   at 96x54, depth 8, 2 batches fused (rays within 0.5%, per-sample channel
   means within 1e-3, at most 5% of pixels above 1e-4) and at the main
   path's 1200x675, 4 spp, depth 50, one batch (rays within 0.5%, means
   within 2e-3); two launches give the same bytes; both timed with CUDA
   events;
5. the wavefront path, Renderer(cs, use_megakernel=False): several batches,
   counting K1 launches; the image checks; a small frame on the card
   against the CPU, for both paths;
6. the main path, Renderer(cs) with defaults: it must take the fused path
   (K4 launched, K1 not); Mrays/s over batches 1-3 stepped one at a time
   and over one fused chunk of 12 batches; the image checks;
7. checkpoint round trips on both paths, with the same chunk boundaries:
   the resumed image must be byte-identical to the uninterrupted render;
8. the CLI renders all 25 batches to a PNG (fused chunks);
9. one fused chunk under torch.profiler: device busy share and device
   operations per batch.

The line before the last is the kernels' JSON record, the last line
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
MAIN_BATCHES = 4          # the first one is warm-up for the Mrays/s figure
CHUNK_BATCHES = 12        # Renderer.CHUNK: one fused launch
CKPT_SPLIT = 2            # round trip: save after this many batches
RANDOM_RAYS = 1 << 20
AGREEMENT = 0.999
RTOL = ATOL = 1e-3


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


def _compare_fused(label, renderer, k, mean_tol, pixel_share):
    """K4 vs its plain version on batches 0..k-1 of ``renderer``'s frame.
    Rays within 0.5%, per-sample channel means within mean_tol, and (when
    pixel_share is set) at most that share of pixels with a max-channel
    difference above 1e-4; two launches must give the same bytes.
    Returns (max |sums difference|, launch args)."""
    import torch

    from raytrace_tpu_torch.ops import megakernel

    if not renderer.use_megakernel:
        raise AssertionError(f"{label}: the gate rejected the scene")
    args = (renderer.static, renderer.scene, renderer._geometry(0),
            renderer.camera, 0, k)
    kw = dict(use_dof=renderer.use_dof)
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
    print(f"fused {label}: rays {rays} vs plain {ref_rays}; per-sample "
          f"channel-mean diff {mdiff:.3g}; pixels above 1e-4: {bad:.6f}; "
          f"traced counts equal on "
          f"{(traced == ref_traced).double().mean().item():.6f} of pixels; "
          f"max |dsum| {err:.3g}; repeat launch byte-identical")
    if abs(rays - ref_rays) > 0.005 * ref_rays or mdiff > mean_tol or (
            pixel_share is not None and bad > pixel_share):
        raise AssertionError(f"{label}: kernel and plain version disagree")
    return err, args, kw


def _check_image(img, label):
    means = img.mean(axis=(0, 1))
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all():
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


def _busy_share(prof, wall_s):
    """(device busy share of wall_s, device operations) from a profile:
    the union of the card's operation intervals over the wall time."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6 / wall_s, len(spans)


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
    print(f"sweep time at R={o.x.shape[0]}, S8={table8.shape[0]}: kernel "
          f"{ms:.3f} ms, plain PyTorch {plain_ms:.3f} ms (median, CUDA "
          f"events; {card})")
    del probe, geom, o, d, alive

    # -- 4. K4 vs plain -----------------------------------------------------
    small = _scene(cs, 96, 54, depth=8, batches=2)
    k4_err, _, _ = _compare_fused("96x54 depth 8 k=2",
                                  Renderer(small, device=dev), 2, 1e-3, 0.05)
    full = Renderer(cs, device=dev)
    err_full, args, kw = _compare_fused(
        f"{WIDTH}x{HEIGHT} 4 spp depth 50 k=1", full, 1, 2e-3, None)
    k4_err = max(k4_err, err_full)
    k4_ms = _median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    k4_plain_ms = _median_ms(
        lambda: megakernel.megakernel_reference(*args, **kw), 2)
    print(f"fused kernel time at {WIDTH}x{HEIGHT}, 4 spp, depth 50, one "
          f"batch: kernel {k4_ms:.3f} ms (median of 5), plain PyTorch "
          f"{k4_plain_ms:.3f} ms (median of 2) (CUDA events; {card})")
    del full, args, kw

    # -- 5. the wavefront path ----------------------------------------------
    sphere_sweep.LAUNCHES = megakernel.LAUNCHES = 0
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

    # Small-input reference: the same frame on the card and on the CPU
    # (plain versions) must agree in channel means and ray counts.
    tiny = _scene(cs, 96, 54, depth=8, batches=1)
    for fused in (False, True):
        gpu_s = Renderer(tiny, device=dev, use_megakernel=fused)
        cpu_s = Renderer(tiny, device="cpu", use_megakernel=fused)
        g_img, c_img = gpu_s.render_all(), cpu_s.render_all()
        g_rays, c_rays = gpu_s.stats.rays_traced, cpu_s.stats.rays_traced
        mdiff = np.abs(g_img.mean(axis=(0, 1)) - c_img.mean(axis=(0, 1))).max()
        rmse = float(np.sqrt(np.mean((g_img - c_img) ** 2)))
        path = "fused" if fused else "wavefront"
        if mdiff > 1e-2 or abs(g_rays - c_rays) > 0.02 * c_rays:
            raise AssertionError(f"{path} card vs CPU at 96x54: mean diff "
                                 f"{mdiff}, rays {g_rays} vs {c_rays}")
        print(f"{path} card vs CPU at 96x54, depth 8: max channel-mean diff "
              f"{mdiff:.3g}, RMSE {rmse:.3g}, rays {g_rays} vs {c_rays}")

    # -- 6. the main path: Renderer with defaults, the fused kernel ---------
    sphere_sweep.LAUNCHES = megakernel.LAUNCHES = 0
    main_r = Renderer(cs, device=dev)
    per_batch = _step(main_r, MAIN_BATCHES)
    rays0, sec0 = main_r.stats.rays_traced, main_r.stats.render_seconds
    if main_r.render_batches(CHUNK_BATCHES) != CHUNK_BATCHES:
        raise AssertionError("render_batches rendered a short chunk")
    chunk = (main_r.stats.rays_traced - rays0,
             main_r.stats.render_seconds - sec0)
    k4_launches = megakernel.LAUNCHES
    if not main_r.use_megakernel or k4_launches <= 0 or sphere_sweep.LAUNCHES:
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
    _check_image(main_r.image(), "fused")

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

        # -- 8. CLI ---------------------------------------------------------
        png = os.path.join(tmp, "final-one-weekend.png")
        capture = _Capture()
        logging.getLogger("raytrace_tpu_torch").addHandler(capture)
        t0 = time.perf_counter()
        rc = cli.main(["render", "--path", cli.DEFAULT_SCENE, "--width",
                       str(WIDTH), "--height", str(HEIGHT), "-o", png])
        logging.getLogger("raytrace_tpu_torch").removeHandler(capture)
        if rc != 0 or not os.path.getsize(png):
            raise AssertionError(f"cli render failed: rc={rc}")
        with open(png, "rb") as f:
            head = f.read(24)
        if head[:8] != b"\x89PNG\r\n\x1a\n" or (
                int.from_bytes(head[16:20], "big"),
                int.from_bytes(head[20:24], "big")) != (WIDTH, HEIGHT):
            raise AssertionError("cli wrote no valid PNG of the scene size")
        if "path: fused bounce kernel" not in capture.lines:
            raise AssertionError("the cli did not take the fused path")
        done = [m for m in capture.lines if m.startswith("rendered ")]
        print(f"cli: {done[-1] if done else 'no summary'}; "
              f"{len([m for m in capture.lines if m.startswith('batch ')])} "
              f"chunks; {time.perf_counter() - t0:.1f} s in all ({card})")

    # -- 9. one fused chunk under the profiler --------------------------------
    from torch.profiler import ProfilerActivity, profile

    prof_r = Renderer(cs, device=dev)
    prof_r.render_batches(CHUNK_BATCHES)   # warm-up
    sec0 = prof_r.stats.render_seconds
    prof_r.render_batches(CHUNK_BATCHES)
    untraced = prof_r.stats.render_seconds - sec0
    prof_r.current_batch = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_r.render_batches(CHUNK_BATCHES)
    traced_wall = time.perf_counter() - t0
    share, n_ops = _busy_share(prof, untraced)
    print(f"profile of one {CHUNK_BATCHES}-batch fused chunk: untraced "
          f"{untraced:.4f} s, traced {traced_wall:.4f} s; device busy "
          f"{share * untraced:.4f} s = {share:.4f} of the untraced wall; "
          f"{n_ops} device operations, {n_ops / CHUNK_BATCHES:.2f} per batch "
          f"({card})")
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=8))

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "sphere_sweep", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/sphere_sweep.cu",
        "replaces": "raytrace_tpu/ops/pallas_sweep.py:33",
        "launches": sweep_launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "megakernel", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms,
        "plain_ms": k4_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
