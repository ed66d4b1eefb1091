"""Short measurements on one CUDA card, outside chip_smoke.py.

    python3 raytrace_tpu_torch/tools/chip_probe.py anim [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py chunks [TREE]

TREE is the root of a checkout whose ``raytrace_tpu_torch`` is measured
(default: the checkout holding this file), so two trees can be compared on
one card in one call (parent, change, change, parent).  Run it as a file,
not with ``-m``, so that the package comes from TREE.

- ``anim``: builds the fused kernel and prints nvcc's register report;
  holds its animated form against the plain version on the motion-blur
  scene at 96x54/depth 8/k=2 and at its full 1024x576/depth 50/k=1 (bit
  for bit or not), times one full batch (kernel median of 5, plain one
  run), the static kernel on final-one-weekend at 1200x675, and one
  12-batch chunk of each scene.
- ``chunks``: the static fused main path, final-one-weekend at 1200x675,
  4 spp, depth 50: the kernel's time for one batch (7 CUDA-event runs)
  and Mrays/s of three 12-batch chunks, as one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

MB_SCENE = "final-one-weekend-motion-blur.json"


def _med(fn, n):
    import torch

    fn()
    ts = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def _scene(path, w, h, depth=None, batches=None):
    from raytrace_tpu_torch import cli

    cs = cli.load_scene(path, w, h)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=depth or cs.render.max_ray_depth,
        sample_batches=batches or cs.render.sample_batches))


def _chunk_mrays(r):
    """Mrays/s of one 12-batch chunk after a warm-up chunk."""
    r.render_batches(12)
    r.current_batch = 0
    rays0, sec0 = r.stats.rays_traced, r.stats.render_seconds
    r.render_batches(12)
    return (r.stats.rays_traced - rays0) / (
        r.stats.render_seconds - sec0) / 1e6


def anim() -> None:
    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import _build, megakernel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    megakernel.library()
    print("build", time.perf_counter() - t0)
    print(_build.library_path("megakernel").with_suffix(".log").read_text())
    dev = torch.device("cuda:0")
    mb = str(Path(cli.DEFAULT_SCENE).with_name(MB_SCENE))
    for label, cs, k in [("mb 96x54 d8 k2", _scene(mb, 96, 54, 8, 2), 2),
                         ("mb 1024x576 d50 k1", _scene(mb, 1024, 576), 1)]:
        r = Renderer(cs, device=dev)
        print(label, r.path)
        args = (r.static, r.scene, r._geometry(0), r.camera, 0, k)
        kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
        s1, t1 = megakernel.render_tile_mega(*args, **kw)
        s2, t2 = megakernel.render_tile_mega(*args, **kw)
        ref, rt = megakernel.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        print(" repeat identical", torch.equal(s1, s2) and torch.equal(t1, t2))
        print(" bitwise", torch.equal(s1, ref), torch.equal(t1, rt),
              "maxdiff", (s1 - ref).abs().max().item(),
              "rays", int(t1.sum()), int(rt.sum()))
        if k == 1:
            print(" kernel ms",
                  _med(lambda: megakernel.render_tile_mega(*args, **kw), 5),
                  "plain ms",
                  _med(lambda: megakernel.megakernel_reference(*args, **kw),
                       1))
    r = Renderer(_scene(cli.DEFAULT_SCENE, 1200, 675), device=dev)
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
    print("static kernel ms", r.path, _med(
        lambda: megakernel.render_tile_mega(*args, use_dof=r.use_dof), 5))
    print("static chunk Mrays/s", _chunk_mrays(r))
    r = Renderer(_scene(mb, 1024, 576), device=dev)
    print("mb chunk Mrays/s", r.path, _chunk_mrays(r))


def chunks(tree: str) -> None:
    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import megakernel

    dev = torch.device("cuda:0")
    r = Renderer(cli.load_scene(cli.DEFAULT_SCENE, 1200, 675), device=dev)
    geom = r._geometry(0)
    ms = []
    launch = lambda: megakernel.render_tile_mega(  # noqa: E731
        r.static, r.scene, geom, r.camera, 0, 1, use_dof=r.use_dof)
    launch()
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    r.render_batches(12)
    mrays = []
    for _ in range(3):
        r.current_batch = 0
        rays0, sec0 = r.stats.rays_traced, r.stats.render_seconds
        r.render_batches(12)
        mrays.append((r.stats.rays_traced - rays0)
                     / (r.stats.render_seconds - sec0) / 1e6)
    print(json.dumps({"tree": tree, "kernel_ms_median7": statistics.median(ms),
                      "kernel_ms": ms, "chunk_mrays": mrays}))


def main(argv) -> int:
    if len(argv) < 2 or argv[1] not in ("anim", "chunks"):
        print(__doc__, file=sys.stderr)
        return 2
    tree = str(Path(argv[2] if len(argv) > 2
                    else Path(__file__).resolve().parents[2]).resolve())
    sys.path.insert(0, tree)
    import raytrace_tpu_torch

    if not raytrace_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"raytrace_tpu_torch came from "
                           f"{raytrace_tpu_torch.__file__}, not {tree}")
    anim() if argv[1] == "anim" else chunks(tree)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
