"""Command line for the PyTorch port (counterpart of raytrace_tpu/cli.py).

Usage:
  python -m raytrace_tpu_torch.cli render [--path scene.json] [-o out.png]
      [--width W] [--height H] [--mesh-geometry] [--checkpoint ck.npz]
      [--resume] [--device cuda|cpu] [--multichip [--scene-shards N]]
      [--preview-every N] [--debug]
  torchrun --nproc-per-node N -m raytrace_tpu_torch.cli render --multichip
      [--scene-shards S] ...
  python -m raytrace_tpu_torch.cli gen-final-one-weekend [--out-dir assets]
  python -m raytrace_tpu_torch.cli view [scene.json] [--width W]
      [--height H] [--port 8000] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and fails with a clear error when no
CUDA device is present; the CPU has to be asked for with ``--device cpu``.
``--mesh-geometry`` tessellates the uv spheres into triangles, as the
reference renders them (final-one-weekend becomes 2,033,920 triangles).
The Renderer chooses its path (the fused kernel on a CUDA device for
every scene it covers, static or with moving spheres, else the
wavefront, whose big meshes take the paged sweep K3) and logs it.  The render steps in chunks of
``Renderer.chunk_size()`` batches (one fused kernel launch each on the
fused paths); with ``--checkpoint`` the state is saved after every chunk,
and ``--resume`` continues from it.  ``--preview-every N`` caps the chunk
at N batches and writes the PNG every N batches.  ``--debug`` validates
the accumulation after every chunk (finite, non-negative, under the
Renderer's energy bound), logs each chunk's largest value against the
bound, and exits 3 on a violation.

``gen-final-one-weekend`` writes the generated final-one-weekend scene
and its motion-blur twin (tools/generate.py) into ``--out-dir``, by
default ``assets``, whose copies it overwrites.  ``view`` serves the
progressive viewer (viewer.py) on ``--port``.

``--multichip`` renders with parallel/multichip.MultiChipRenderer over the
ranks ``torchrun`` starts (one a card, NCCL; run alone, one rank):
image rows over "px" and samples over "sp", and with ``--scene-shards S``
the scene's primitives over an "sc" axis of S ranks.  The first rank
logs and writes the PNG and checkpoints.
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
# How the log names the wavefront's triangle paths (static.bvh_mode).
TRIANGLE_PATHS = {"paged": "paged triangles", "sah": "SAH BVH",
                  "implicit": "implicit BVH"}


def load_scene(path: str, width=None, height=None,
               analytic_spheres: bool = True):
    """Scene JSON → CompiledScene (the port's numpy host layers);
    ``analytic_spheres=False`` tessellates the uv spheres."""
    from .models import compile_scene
    from .scene_file import SceneFile

    scene = SceneFile.load_json(path)
    scene.validate()
    return compile_scene(scene, width=width, height=height,
                         analytic_spheres=analytic_spheres)


def cmd_render(args) -> int:
    import torch

    from .engine import Renderer

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        log.error("CUDA is not available on this machine; pass --device cpu "
                  "to render on the CPU")
        return 2
    from .scene_file import SceneError

    if args.scene_shards < 1:
        raise SceneError(f"--scene-shards must be >= 1, got "
                         f"{args.scene_shards}")
    if args.scene_shards > 1 and not args.multichip:
        raise SceneError("--scene-shards requires --multichip")
    if args.debug and args.multichip:
        raise SceneError("--debug validates a single-device render; it "
                         "does not take --multichip")
    cs = load_scene(args.path, args.width, args.height,
                    analytic_spheres=not args.mesh_geometry)
    log.info("scene: %d spheres, %d triangles, %dx%d, %d spp x %d batches",
             cs.num_spheres, cs.num_triangles, cs.render.width,
             cs.render.height, cs.render.samples_per_pixel,
             cs.render.sample_batches)
    out = args.output or (os.path.splitext(os.path.basename(args.path))[0]
                          + ".png")
    if args.multichip:
        from .parallel import MultiChipRenderer

        try:
            renderer = MultiChipRenderer(
                cs, device=args.device,
                sc=args.scene_shards if args.scene_shards > 1 else None)
        except ValueError as e:
            raise SceneError(str(e))
        lay = renderer.layout
        if not renderer.is_lead:
            log.setLevel(logging.WARNING)
        log.info("multichip: px=%d sp=%d sc=%d", lay.px, lay.sp, lay.sc)
    else:
        renderer = Renderer(cs, device=args.device, debug=args.debug)
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        renderer.load_checkpoint(args.checkpoint)
        log.info("resumed at batch %d", renderer.current_batch)

    log.info("path: %s (%s)", "fused bounce kernel"
             if renderer.use_megakernel else "wavefront",
             TRIANGLE_PATHS.get(renderer.static.bvh_mode, renderer.path))

    t0 = time.perf_counter()
    total = cs.render.sample_batches
    chunk = renderer.chunk_size()
    if args.preview_every:
        chunk = min(chunk, args.preview_every)
    ds = renderer.debug_stats
    while renderer.render_batches(chunk):
        batch = renderer.current_batch
        log.info("batch %d/%d done", batch, total)
        if ds is not None:
            log.info("debug: batch %d valid (max radiance %.3g of bound "
                     "%.3g)", batch, ds.max_radiance, ds.energy_bound)
        if args.preview_every and batch % args.preview_every == 0:
            renderer.save_png(out)
        if args.checkpoint:
            renderer.save_checkpoint(args.checkpoint)
    dt = time.perf_counter() - t0
    renderer.save_png(out)
    log.info("rendered %d batches in %.1fs — %.1f Mrays/s on %s -> %s",
             renderer.stats.batches_done, dt, renderer.stats.mrays_per_sec,
             args.device, out)
    if ds is not None:
        log.info("debug: %d checks, %d non-finite, %d negative, max "
                 "radiance %.6g of bound %.6g", ds.checks,
                 ds.nonfinite_values, ds.negative_values, ds.max_radiance,
                 ds.energy_bound)
    if getattr(renderer, "is_lead", True):
        print(out)
    return 0


def cmd_generate(args) -> int:
    from .tools import generate_final_one_weekend_pair

    os.makedirs(args.out_dir, exist_ok=True)
    static, blur = generate_final_one_weekend_pair()
    for scene, name in [(static, "final-one-weekend.json"),
                        (blur, "final-one-weekend-motion-blur.json")]:
        path = os.path.join(args.out_dir, name)
        scene.save_json(path)
        log.info("wrote %s", path)
    return 0


def cmd_view(args) -> int:
    import torch

    from .viewer import Viewer

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        log.error("CUDA is not available on this machine; pass --device cpu "
                  "to render on the CPU")
        return 2
    Viewer(args.path, width=args.width, height=args.height, port=args.port,
           device=args.device).serve_forever()
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
    pr.add_argument("--mesh-geometry", action="store_true",
                    help="tessellate spheres (the reference's geometry)")
    pr.add_argument("--checkpoint", default=None)
    pr.add_argument("--resume", action="store_true")
    pr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    pr.add_argument("--multichip", action="store_true",
                    help="render sharded over torchrun's ranks")
    pr.add_argument("--scene-shards", type=int, default=1,
                    help="shard the primitive tables over an 'sc' axis of "
                         "this many ranks; needs --multichip")
    pr.add_argument("--preview-every", type=int, default=0,
                    help="write the PNG every N batches (progressive "
                         "preview)")
    pr.add_argument("--debug", action="store_true",
                    help="validate every chunk (finite / non-negative / "
                         "energy-bounded accumulation); exit 3 if not")
    pr.set_defaults(fn=cmd_render)

    pg = sub.add_parser("gen-final-one-weekend",
                        help="generate the RTiOW final scene files")
    pg.add_argument("--out-dir", default="assets",
                    help="where to write them (default assets, whose "
                         "copies are overwritten)")
    pg.set_defaults(fn=cmd_generate)

    pv = sub.add_parser(
        "view", help="interactive progressive viewer (browser; hot-swap "
                     "+ resize like the reference's windowed app)")
    pv.add_argument("path", nargs="?", default=DEFAULT_SCENE)
    pv.add_argument("--width", type=int, default=None)
    pv.add_argument("--height", type=int, default=None)
    pv.add_argument("--port", type=int, default=8000)
    pv.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    pv.set_defaults(fn=cmd_view)

    args = p.parse_args(argv)
    from .scene_file import SceneError

    try:
        return args.fn(args)
    except FileNotFoundError as e:
        log.error("file not found: %s", e.filename or e)
        return 2
    except SceneError as e:
        log.error("%s", e)
        return 2
    except RuntimeError as e:
        from .engine.renderer import DebugValidationError

        if isinstance(e, DebugValidationError):
            log.error("debug validation failed: %s", e)
            return 3
        raise


if __name__ == "__main__":
    sys.exit(main())
