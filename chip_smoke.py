#!/usr/bin/env python3
"""Smoke run of the PyTorch port (raytrace_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, final-one-weekend at 1200x675 with its 4 spp
and depth 50, through the entry points a user calls, and checks every
phase; any failure raises and the script exits non-zero without printing a
result.  Phases:

1. needs torch.cuda.is_available(); prints nvidia-smi's name and power limit;
2. builds the sphere-sweep kernel (csrc/sphere_sweep.cu) from the checkout;
3. compares kernel and plain PyTorch sweep on the card: the 3,240,000
   primary rays of the main path and 2^20 random rays with an alive mask
   (ids equal, and ids equal with t within rtol=1e-3, atol=1e-3, each
   on >= 99.9% of rays), and times both with CUDA events;
4. renders several batches with Renderer(cs, device="cuda"), counting
   kernel launches, and checks the image; renders a small frame on the
   card and on the CPU (plain sweep) and checks they agree;
5. checkpoint round trip: save, resume in a new Renderer, finish; the
   image must be byte-identical to the uninterrupted render;
6. the CLI entry point renders the full scene to a PNG.

The line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

WIDTH, HEIGHT = 1200, 675
MAIN_BATCHES = 4          # the first one is warm-up for the Mrays/s figure
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs one CUDA card", file=sys.stderr)
        return 1
    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.engine.wavefront import prepare_batch, primary_rays
    from raytrace_tpu_torch.ops import _build, sphere_sweep
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

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    sphere_sweep.library()
    print(f"build: csrc/sphere_sweep.cu in {time.perf_counter() - t0:.2f} s")
    log = _build.library_path("sphere_sweep").with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    # -- 3. kernel vs plain at the main path's shapes -----------------------
    cs = cli.load_scene(cli.DEFAULT_SCENE, WIDTH, HEIGHT)
    probe = Renderer(cs, device=dev)
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

    # -- 4. the main path ---------------------------------------------------
    sphere_sweep.LAUNCHES = 0
    main_r = Renderer(cs, device=dev)
    per_batch = []
    for _ in range(MAIN_BATCHES):
        rays0, sec0 = main_r.stats.rays_traced, main_r.stats.render_seconds
        if not main_r.render_next_batch():
            raise AssertionError("render_next_batch returned False")
        per_batch.append((main_r.stats.rays_traced - rays0,
                          main_r.stats.render_seconds - sec0))
    launches = sphere_sweep.LAUNCHES
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    steady = per_batch[1:]
    mrays = (sum(r for r, _ in steady) / sum(s for _, s in steady) / 1e6)
    for i, (r, s) in enumerate(per_batch):
        print(f"batch {i}: {r} rays in {s:.4f} s ({r / s / 1e6:.3f} Mrays/s)")
    print(f"main path: final-one-weekend {WIDTH}x{HEIGHT}, 4 spp, depth 50: "
          f"{mrays:.3f} Mrays/s over batches 1-{MAIN_BATCHES - 1}; "
          f"sphere_sweep LAUNCHES={launches} ({card})")
    img = main_r.image()
    means = img.mean(axis=(0, 1))
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all():
        raise AssertionError("image is not a finite [H, W, 3] array")
    if (img < 0).any() or not ((means > 0.05) & (means < 1.5)).all():
        raise AssertionError(f"image out of range: channel means {means}")
    print(f"image: channel means {means.tolist()}")

    # Small-input reference: the same frame on the card (kernel) and on the
    # CPU (plain sweep) must agree in channel means and ray counts.
    small = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, width=96, height=54, sample_batches=1, max_ray_depth=8))
    gpu_s, cpu_s = Renderer(small, device=dev), Renderer(small, device="cpu")
    g_img, c_img = gpu_s.render_all(), cpu_s.render_all()
    g_rays, c_rays = gpu_s.stats.rays_traced, cpu_s.stats.rays_traced
    mdiff = np.abs(g_img.mean(axis=(0, 1)) - c_img.mean(axis=(0, 1))).max()
    rmse = float(np.sqrt(np.mean((g_img - c_img) ** 2)))
    if mdiff > 1e-2 or abs(g_rays - c_rays) > 0.02 * c_rays:
        raise AssertionError(f"card vs CPU at 96x54: mean diff {mdiff}, "
                             f"rays {g_rays} vs {c_rays}")
    print(f"card vs CPU at 96x54, depth 8: max channel-mean diff {mdiff:.3g}, "
          f"RMSE {rmse:.3g}, rays {g_rays} vs {c_rays}")

    # -- 5. checkpoint round trip -------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        first = Renderer(cs, device=dev)
        first.render_batches(CKPT_SPLIT)
        first.save_checkpoint(ck)
        resumed = Renderer(cs, device=dev)
        resumed.load_checkpoint(ck)
        resumed.render_batches(MAIN_BATCHES - CKPT_SPLIT)
        if resumed.image().tobytes() != img.tobytes():
            raise AssertionError("resumed render differs from one-shot")
        print(f"checkpoint: resume after batch {CKPT_SPLIT} of "
              f"{MAIN_BATCHES} is byte-identical")

        # -- 6. CLI ---------------------------------------------------------
        png = os.path.join(tmp, "final-one-weekend.png")
        t0 = time.perf_counter()
        rc = cli.main(["render", "--path", cli.DEFAULT_SCENE, "--width",
                       str(WIDTH), "--height", str(HEIGHT), "-o", png])
        if rc != 0 or not os.path.getsize(png):
            raise AssertionError(f"cli render failed: rc={rc}")
        with open(png, "rb") as f:
            head = f.read(24)
        if head[:8] != b"\x89PNG\r\n\x1a\n" or (
                int.from_bytes(head[16:20], "big"),
                int.from_bytes(head[20:24], "big")) != (WIDTH, HEIGHT):
            raise AssertionError("cli wrote no valid PNG of the scene size")
        print(f"cli: rendered {cs.render.sample_batches} batches to a "
              f"{WIDTH}x{HEIGHT} PNG in {time.perf_counter() - t0:.1f} s")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "sphere_sweep", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/sphere_sweep.cu",
        "replaces": "raytrace_tpu/ops/pallas_sweep.py:33",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
