"""A configuration's scene document for one run, made from the seed.

A configuration (configs/<name>.json) names its scene either as a
generator module in configs/ (``{"generator": "fow_scene"}``: its
``scene(seed)`` returns the document) or as a frozen document beside it
(``{"file": "cornell-box.scene.json"}``, the same for every seed), and
gives the frame, the samples a pixel a batch, the batches of a whole
render and the depth.  Where ``stream_offsets`` is above 1 the seed also
picks the samples the render draws: the program's sample streams are
keyed by the batch index, so a render that starts at batch
seed mod stream_offsets (a resumed render with an empty accumulation)
draws other samples, and its running mean is scaled back by the batches
it holds.
"""

from __future__ import annotations

import copy
import importlib
import json
import math


def batch_offset(cfg: dict, seed: int) -> int:
    return seed % max(1, int(cfg.get("stream_offsets", 1)))


def sqrt_spp(cfg: dict) -> int:
    s = math.isqrt(int(cfg["samples_per_pixel"]))
    if s * s != int(cfg["samples_per_pixel"]):
        raise ValueError("samples_per_pixel must be a square")
    return s


def make(configs_dir, cfg: dict, seed: int, batches: int) -> dict:
    """The scene document of ``cfg`` for ``seed``, its render settings
    set so that a renderer holds ``batches`` batches from batch 0."""
    src = cfg["scene"]
    if "generator" in src:
        mod = importlib.import_module(f"rtbench.configs.{src['generator']}")
        doc = mod.scene(seed)
    else:
        with open(configs_dir / src["file"]) as f:
            doc = json.load(f)
    doc = copy.deepcopy(doc)
    render = doc["render"]
    render["samples_per_pixel"] = int(cfg["samples_per_pixel"])
    render["sample_batches"] = int(batches)
    render["max_ray_depth"] = int(cfg["max_ray_depth"])
    return doc
