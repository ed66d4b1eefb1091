"""One run of one cell: set-up, the measured window, the check, the
result line.  Everything is found by name from BENCHMARK.json:

- a cell's configuration: configs/<config>.json (the scene, the frame,
  the samples, the depth, the check's sizes and limits; optionally
  ``"reference"``, the module reference/<name>.py whose
  ``render_pixels`` is the plain reference of the check, by default
  ``pathtracer``, and ``"mesh_geometry"``, true to compile the scene's
  uv spheres into triangles as the CLI's ``--mesh-geometry`` does, by
  default false);
- its traffic mix: traffic/<mix>.json, read by drive.py;
- each metric: metrics/<metric>.py (for a metric split over cells,
  ``base.part``, the base's file where it has none of its own), whose
  ``read(run)`` takes the number from the run (``Run``), or returns None
  where it finds nothing to read, and the metric is then left out of the
  line.

The program under test is raytrace_tpu_torch; the benchmark takes from
it only its public calls (``compile_scene``, ``Renderer`` and its
``render_batches``, ``chunk_size``, ``image``, ``current_batch`` and
``stats``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from rtbench import check, drive, scene
from rtbench.devtrace import Profiler
from rtbench.spans import Spans
from rtbench.work import SceneFacts

ROOT = Path(__file__).resolve().parents[1]
# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "raytrace_tpu")
PROGRAM = "raytrace_tpu_torch"
REFERENCE = "pathtracer"


class ConfigError(ValueError):
    """A configuration the harness refuses before set-up."""


def reference_of(cfg: dict):
    """``render_pixels`` of reference/<name>.py, ``name`` the
    configuration's ``"reference"`` (``REFERENCE`` where it has none).
    Its contract: ``render_pixels(doc, px, py, width, height, samples,
    sqrt_spp, max_depth, *, seed, device, dtype=torch.float64)`` returns
    float64 numpy arrays (mean [P, 3], var [P, 3]) of the drawn pixels;
    ``dtype`` is the precision it computes in (the control's bfloat16)."""
    name = cfg.get("reference", REFERENCE)
    module = f"rtbench.reference.{name}"
    if not (isinstance(name, str) and name.isidentifier()
            and importlib.util.find_spec(module) is not None):
        raise ConfigError(
            f"configuration {cfg.get('name')!r}: no plain reference "
            f"{name!r} (a module rtbench/reference/<name>.py)")
    render = getattr(importlib.import_module(module), "render_pixels", None)
    if not callable(render):
        raise ConfigError(f"configuration {cfg.get('name')!r}: the reference "
                          f"{name!r} has no render_pixels")
    return render


def mesh_geometry(cfg: dict) -> bool:
    """The configuration's ``"mesh_geometry"`` (false where it has none)."""
    mesh = cfg.get("mesh_geometry", False)
    if not isinstance(mesh, bool):
        raise ConfigError(f"configuration {cfg.get('name')!r}: mesh_geometry "
                          f"must be true or false, not {mesh!r}")
    return mesh


class Bench:
    """BENCHMARK.json and the benchmark's folder of data and readers."""

    def __init__(self, root: Path = ROOT, spec: dict | None = None):
        self.root = Path(root)
        self.dir = Path(__file__).resolve().parent
        if spec is None:
            with open(self.root / "BENCHMARK.json") as f:
                spec = json.load(f)
        self.spec = spec

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        with open(self.dir / "configs" / f"{name}.json") as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, cell: str, traced: bool) -> list:
        """The cell's metrics of one kind: per-layer in a traced run,
        end-to-end otherwise."""
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """``read`` of metrics/<metric>.py, or for a metric split over
        cells (``base.part``) of the file of its base where the metric has
        none of its own."""
        name = metric
        while "." in name and not (self.dir / "metrics"
                                   / f"{name}.py").exists():
            name = name.rsplit(".", 1)[0]
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "rtbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


@dataclass
class Run:
    """What a metric reader may read of a run."""
    cell: str
    config: dict
    mix: dict
    facts: SceneFacts
    spans: Spans
    outcome: drive.Outcome
    setup_s: float
    trace: object  # devtrace.DeviceTrace, or None in an untraced run

    def units(self, profiled=None) -> list:
        return [u for u in self.outcome.units
                if profiled is None or u.profiled == profiled]

    def host_spans(self, name: str) -> list:
        """Host seconds of the window's spans called ``name``, those
        outside the profiled sub-window (the profiler's cost is not
        theirs), or all where every one was profiled."""
        out = self.spans.named(name, profiled=False, setup=None)
        return [s.seconds for s in out or self.spans.named(name, setup=None)]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1.0e300


def run(bench: Bench, cell_name: str, seed: int, seconds: float,
        traced: bool, t_start: float, *, device: str = "cuda",
        overrides: dict | None = None, log=print) -> dict:
    """One run; returns the result line's object.  ``overrides`` (tests
    only) replaces configuration keys, to run a cell at a small size.
    A configuration whose reference or geometry is refused raises
    ``ConfigError`` before set-up."""
    cell = bench.cell(cell_name)
    cfg = {**bench.config(cell["config"]), **(overrides or {})}
    reference = reference_of(cfg)
    mesh = mesh_geometry(cfg)

    import torch

    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.models import compile_scene
    from raytrace_tpu_torch.scene_file import SceneFile

    mix = bench.traffic(cell["traffic"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    spans = Spans(annotate=traced)
    W, H = int(cfg["width"]), int(cfg["height"])
    spp = int(cfg["samples_per_pixel"])
    per_image = int(cfg["sample_batches"])
    offset = scene.batch_offset(cfg, seed)
    held = (per_image if mix["renderer_per_image"]
            else drive.progressive_batches(mix, seconds))
    doc = scene.make(bench.dir / "configs", cfg, seed, offset + held)
    facts = SceneFacts.of(doc, W, H, mesh_geometry=mesh)

    with spans.span("scene_compile", setup=True):
        compiled = compile_scene(SceneFile.from_json_dict(doc), width=W,
                                 height=H, analytic_spheres=not mesh)

    def make_renderer():
        r = Renderer(compiled, device=dev)
        r.current_batch = offset  # a render resumed at that batch, empty
        return r

    with spans.span("renderer_init", setup=True):
        first = make_renderer()
        sync()
    drive.warm_up(mix, first, per_image)
    sync()
    if mix["renderer_per_image"]:
        first = None
    profiler = Profiler() if traced else None
    if traced:
        profiler.prepare()
    setup_s = time.perf_counter() - t_start
    out = drive.drive(mix, make_renderer, first, offset=offset,
                      batches=per_image, spp=spp, pixels=W * H,
                      seconds=seconds, seed=seed, spans=spans,
                      profiler=profiler, sync=sync)
    if out.error:
        log(f"rtbench: the program failed in the window: {out.error}",
            file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    record = Run(cell_name, cfg, mix, facts, spans, out, setup_s,
                 profiler.trace if traced else None)
    metrics = {}
    for m in bench.metrics(cell_name, traced):
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # The check, once the program's state is freed: every kept answer
    # against the reference on pixels drawn from the seed.
    answers_in = out.kept
    del first, compiled
    out.kept = []
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    chk = cfg["check"]
    px, py = check.draw_pixels(seed, W, H, int(chk["pixels"]))
    answers = [check.answer(k.label, k.image, k.scale, k.samples, px, py)
               for k in answers_in]
    del answers_in
    t_ref = time.perf_counter()
    mean, var = reference(
        doc, px, py, W, H, int(chk["ref_samples"]), scene.sqrt_spp(cfg),
        int(cfg["max_ray_depth"]), seed=seed, device=dev)
    correct, table = check.judge(answers, mean, var, int(chk["ref_samples"]),
                                 chk["limits"])
    correct = correct and out.failed == 0
    log(f"rtbench: {len(out.units)} calls, {out.attempted} answers due, "
        f"{len(answers)} checked ({', '.join(a.label for a in answers)}) on "
        f"{len(px)} pixels; reference {time.perf_counter() - t_ref:.1f} s",
        file=sys.stderr)

    log(span_summary(spans), file=sys.stderr)
    result = {"correct": bool(correct), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(memory_peak)}
    if traced and record.trace is not None:
        result["device"]["busy_s"] = record.trace.busy_s()
        result["device"]["window_s"] = record.trace.window_s
        result["breakdown"] = {"device_ops": record.trace.top_ops(10),
                               "idle_gaps": record.trace.idle_gaps(10)}
    result["check"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                       for k, v in table.items()}
    return result


def span_summary(spans: Spans) -> str:
    """One line: each span name's count, median, 90th percentile and total
    milliseconds over the window (outside the profiled sub-window)."""
    parts = []
    for name in sorted({s.name for s in spans.items}):
        ms = sorted(1e3 * s.seconds for s in spans.named(
            name, profiled=False, setup=None))
        if ms:
            parts.append(f"{name} n={len(ms)} med={ms[len(ms) // 2]:.3f} "
                         f"p90={ms[int(0.9 * (len(ms) - 1))]:.3f} "
                         f"max={ms[-1]:.3f} sum={sum(ms):.1f}")
    return "rtbench spans (ms): " + "; ".join(parts)


def compared_lines(result: dict) -> list:
    """The numbers compared, each beside its limit, one a line."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in result["check"].items()] + [
        f"check correct: {result['correct']}"]
