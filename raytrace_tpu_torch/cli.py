"""Command line for the PyTorch port (counterpart of raytrace_tpu/cli.py).

Usage:
  python -m raytrace_tpu_torch.cli render [--path scene.json] [-o out.png]
      [--width W] [--height H] [--checkpoint ck.npz] [--resume]
      [--device cuda|cpu]

``--device`` defaults to ``cuda`` and fails with a clear error when no
CUDA device is present; the CPU has to be asked for with ``--device cpu``.
Each batch refines the running mean; with ``--checkpoint`` the state is
saved after every batch, and ``--resume`` continues from it.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from pathlib import Path

log = logging.getLogger("raytrace_tpu_torch")

DEFAULT_SCENE = str(Path(__file__).resolve().parents[1] / "assets"
                    / "final-one-weekend.json")


def load_scene(path: str, width=None, height=None):
    """Scene JSON → CompiledScene (the shared numpy host layers)."""
    from raytrace_tpu.models import compile_scene
    from raytrace_tpu.scene_file import SceneFile

    scene = SceneFile.load_json(path)
    scene.validate()
    return compile_scene(scene, width=width, height=height)


def cmd_render(args) -> int:
    import torch

    from .engine import Renderer

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        log.error("CUDA is not available on this machine; pass --device cpu "
                  "to render on the CPU")
        return 2
    cs = load_scene(args.path, args.width, args.height)
    log.info("scene: %d spheres, %d triangles, %dx%d, %d spp x %d batches",
             cs.num_spheres, cs.num_triangles, cs.render.width,
             cs.render.height, cs.render.samples_per_pixel,
             cs.render.sample_batches)
    out = args.output or (os.path.splitext(os.path.basename(args.path))[0]
                          + ".png")
    renderer = Renderer(cs, device=args.device)
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        renderer.load_checkpoint(args.checkpoint)
        log.info("resumed at batch %d", renderer.current_batch)

    t0 = time.perf_counter()
    total = cs.render.sample_batches
    while renderer.render_next_batch():
        log.info("batch %d/%d done", renderer.current_batch, total)
        if args.checkpoint:
            renderer.save_checkpoint(args.checkpoint)
    dt = time.perf_counter() - t0
    renderer.save_png(out)
    log.info("rendered %d batches in %.1fs — %.1f Mrays/s on %s -> %s",
             renderer.stats.batches_done, dt, renderer.stats.mrays_per_sec,
             args.device, out)
    print(out)
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "INFO"),
                        format="%(levelname)s %(name)s: %(message)s")
    p = argparse.ArgumentParser(prog="raytrace_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene JSON to PNG")
    pr.add_argument("--path", default=DEFAULT_SCENE,
                    help="scene file (default: assets/final-one-weekend.json)")
    pr.add_argument("-o", "--output", default=None)
    pr.add_argument("--width", type=int, default=None)
    pr.add_argument("--height", type=int, default=None)
    pr.add_argument("--checkpoint", default=None)
    pr.add_argument("--resume", action="store_true")
    pr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    pr.set_defaults(fn=cmd_render)

    args = p.parse_args(argv)
    from raytrace_tpu.scene_file import SceneError

    try:
        return args.fn(args)
    except FileNotFoundError as e:
        log.error("file not found: %s", e.filename or e)
        return 2
    except (SceneError, NotImplementedError) as e:
        log.error("%s", e)
        return 2


if __name__ == "__main__":
    sys.exit(main())
