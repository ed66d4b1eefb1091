"""Readings that the check's limits are set from (PERF.md gives them).

    python3 rtbench/control.py --workload <cell> --seeds 1,2,3

For each seed, on the card, at the cell's own sizes: the control, the
configuration's plain reference (``core.reference_of``) computed in
bfloat16 (the precision below the float32 the program renders in) put
in the program's place: its images at the cell's drawn pixels, with as
many samples a pixel as the cell's answers hold (``--samples``; by
default those of a whole image, and for a progressive cell 8, 100 and
1024), judged against the float64 reference as the program's are.  The
program's own readings are the benchmark's runs.  One JSON line a
reading; the benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def control_readings(bench, cell_name: str, seed: int, samples: list,
                     device: str = "cuda", overrides=None) -> list:
    """The control's numbers at each sample count, for one seed."""
    import numpy as np
    import torch

    from rtbench import check, core, scene

    cell = bench.cell(cell_name)
    cfg = {**bench.config(cell["config"]), **(overrides or {})}
    reference = core.reference_of(cfg)
    W, H = int(cfg["width"]), int(cfg["height"])
    offset = scene.batch_offset(cfg, seed)
    doc = scene.make(bench.dir / "configs", cfg, seed,
                     offset + int(cfg["sample_batches"]))
    chk = cfg["check"]
    px, py = check.draw_pixels(seed, W, H, int(chk["pixels"]))
    args = (doc, px, py, W, H)
    kw = dict(device=device)
    depth, s = int(cfg["max_ray_depth"]), scene.sqrt_spp(cfg)
    mean, var = reference(*args, int(chk["ref_samples"]), s, depth,
                          seed=seed, **kw)
    out = []
    for n in samples:
        t0 = time.perf_counter()
        low, _ = reference(*args, n, s, depth, seed=seed + 7919 * n,
                           dtype=torch.bfloat16, **kw)
        bad = int(np.count_nonzero(~np.isfinite(low))
                  + np.count_nonzero(low < 0.0))
        ans = check.Answer(f"bfloat16 reference, {n} samples", low, n, bad)
        nums = check.numbers(ans, mean, var, int(chk["ref_samples"]))
        out.append({"workload": cell_name, "seed": seed, "kind": "control",
                    "samples": n, **{k: core._finite(v)
                                     for k, v in nums.items()},
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--samples", default="")
    args = p.parse_args(argv)

    from rtbench import core

    bench = core.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    whole = int(cfg["samples_per_pixel"]) * int(cfg["sample_batches"])
    samples = ([int(x) for x in args.samples.split(",")] if args.samples
               else [whole] if bench.traffic(cell["traffic"])[
                   "renderer_per_image"] else [8, whole, 1024])
    for seed in (int(x) for x in args.seeds.split(",")):
        for line in control_readings(bench, args.workload, seed, samples):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
