"""The harness on the CPU: the result line, each traffic mix driven end to
end through the program's plain path at a small size, the check's
faults and control, the work count, the scene generator, the trace
reader and the imports."""

import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from rtbench import check, core, drive, work
from rtbench.configs import fow_scene
from rtbench.devtrace import DeviceTrace

BENCH = Path(core.__file__).resolve().parent
ROOT = BENCH.parent
SEED = 3_000_000_019

# Small sizes that the CPU renders in seconds; the check's limits stay the
# configuration's.
SMALL = {
    "fow-offline": {"width": 16, "height": 9, "sample_batches": 2},
    "fow-preview": {"width": 16, "height": 9},
    "cornell-offline": {"width": 16, "height": 16, "sample_batches": 4},
}
SMALL_CHECK = {"fow-offline": (144, 128), "fow-preview": (144, 128),
               "cornell-offline": (256, 1024)}
SECONDS = {"fow-offline": 1.0, "fow-preview": 1.0, "cornell-offline": 1.5}


def bench():
    """BENCHMARK.json's cells and, for its traffic mix's tests, the
    live-preview cell PERF.md keeps out of it for now."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "fow-preview",
                              "config": "final-one-weekend",
                              "traffic": "preview", "chips": 1, "why": ""})
    for m in spec["end_to_end"]:
        if m["name"] == "msamples_per_s.fow":
            m["workloads"].append("fow-preview")
    return core.Bench(spec=spec)


def small(bench, cell):
    cfg = bench.config(bench.cell(cell)["config"])
    pixels, ref = SMALL_CHECK[cell]
    return {**SMALL[cell], "check": {**cfg["check"], "pixels": pixels,
                                     "ref_samples": ref}}


def run_small(cell, traced=False, seed=SEED):
    import torch

    torch.set_num_threads(2)
    b = bench()
    lines = []
    result = core.run(b, cell, seed, SECONDS[cell], traced,
                      time.perf_counter(), device="cpu",
                      overrides=small(b, cell),
                      log=lambda *a, **k: lines.append(a[0]))
    return result, lines


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_each_mix_end_to_end(cell):
    result, lines = run_small(cell)
    assert result["correct"], (result["check"], lines)
    assert result["attempted"] >= 1 and result["failed"] == 0
    m = result["metrics"]
    want = {e["name"] for e in bench().metrics(cell, traced=False)}
    rate = "msamples_per_s.fow" if cell.startswith("fow") else "msamples_per_s"
    assert set(m) == want == {"setup_s", rate}
    assert m[rate]["unit"] == "Msamples/s"
    assert m[rate]["value"] > 0 and m["setup_s"]["value"] > 0


def test_result_line_shape():
    result, _ = run_small("cornell-offline", traced=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "check"]
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(dev)
    assert dev["count"] == 1
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result["check"]) == list(check.NUMBERS)
    for v in result["check"].values():
        assert set(v) == {"value", "limit"}
    # A traced run reports per-layer metrics only, with their units.
    units = {m["name"]: m["unit"] for m in core.Bench().spec["per_layer"]}
    assert result["metrics"] and set(result["metrics"]) <= set(units)
    for k, v in result["metrics"].items():
        assert v["unit"] == units[k]
    json.loads(json.dumps(result))
    lines = core.compared_lines(result)
    assert lines[-1] == f"check correct: {result['correct']}"


def _fault_half_samples(monkeypatch):
    """Half of each batch's samples left out, the mean taken over the
    rest."""
    from raytrace_tpu_torch.engine.renderer import Renderer

    slab = Renderer._slab

    def half(self, b0, k, mean):
        full = self.spp_local
        self.spp_local = full // 2
        try:
            sums, rays = slab(self, b0, k, False)
        finally:
            self.spp_local = full
        sums = sums / (k * (full // 2)) if mean else sums * 2.0
        return sums, rays

    monkeypatch.setattr(Renderer, "_slab", half)


def _fault_unchanged(monkeypatch):
    """A step that returns the state unchanged."""
    from raytrace_tpu_torch.engine.renderer import Renderer

    step = Renderer._step

    def unchanged(self, b0, k):
        before = self.accum
        step(self, b0, k)
        self.accum = before

    monkeypatch.setattr(Renderer, "_step", unchanged)


def _fault_altered(monkeypatch):
    """An answer altered where it is produced: a band of an eighth of the
    rows, across the frame's middle, written as its unnormalised sum
    (eight times its value) in every batch."""
    from raytrace_tpu_torch.engine.renderer import Renderer

    slab = Renderer._slab

    def altered(self, b0, k, mean):
        sums, rays = slab(self, b0, k, mean)
        sums = sums.clone()
        mid = sums.shape[0] // 2
        sums[mid:mid + max(1, sums.shape[0] // 8)] *= 8.0
        return sums, rays

    monkeypatch.setattr(Renderer, "_slab", altered)


@pytest.mark.parametrize("cell", ["fow-offline", "fow-preview",
                                  "cornell-offline"])
@pytest.mark.parametrize("fault", [_fault_half_samples, _fault_unchanged,
                                   _fault_altered],
                         ids=["half-samples", "unchanged", "altered"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, _ = run_small(cell)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    """The reference in bfloat16 in the program's place fails a limit."""
    import torch

    from rtbench import control

    torch.set_num_threads(2)
    b = bench()
    ov = small(b, cell)
    cfg = {**b.config(b.cell(cell)["config"]), **ov}
    n = int(cfg["samples_per_pixel"]) * int(cfg["sample_batches"])
    limits = cfg["check"]["limits"]
    for reading in control.control_readings(b, cell, SEED, [n],
                                            device="cpu", overrides=ov):
        assert any(reading[k] > limits[k] for k in check.NUMBERS), reading


def test_work_count_pinned():
    fow = work.SceneFacts.of(fow_scene.scene(fow_scene.REFERENCE_SEED),
                             1200, 675)
    assert fow == work.SceneFacts(488, 0, 488, 0, True, 810_000)
    samples, rays = 3_240_000, 8_510_401
    want = (samples * (51 + 48) + (rays - samples) * (25 + 64 + 6)
            + 810_000 * 9)
    assert work.operations(fow, samples, rays, 1) == want == 828_738_095
    assert work.bytes_moved(fow, 1) == 488 * 32 + 810_000 * 12
    assert work.least_seconds(fow, samples, rays, 1) == pytest.approx(
        want / 67e12)
    cornell = work.SceneFacts.of(json.load(open(
        BENCH / "configs" / "cornell-box.scene.json")), 1024, 1024)
    assert cornell == work.SceneFacts(0, 36, 4, 2, False, 1 << 20)
    samples, rays = 64 << 20, 216_879_966
    assert work.operations(cornell, samples, rays, 1) == (
        samples * 51 + (rays - samples) * (45 + 64)
        + (rays - 2 * samples) * 54 + (1 << 20) * 9)
    # Whatever walks the tree, the count reads only these inputs.
    assert work.operations(cornell, samples, samples, 1) == (
        samples * 51 + (1 << 20) * 9)


def test_generator_is_the_books():
    from raytrace_tpu_torch.tools.generate import (
        generate_final_one_weekend_scene)

    ours = fow_scene.scene(fow_scene.REFERENCE_SEED)
    assert ours == generate_final_one_weekend_scene().to_json_dict()
    other = fow_scene.scene(SEED)
    assert other != ours
    names = [p["uv_sphere"]["name"] for p in other["primitives"]]
    assert len(names) == 488 and names[0] == "ground_sphere"
    assert names[-3:] == ["sphere1", "sphere2", "sphere3"]
    assert all(re.fullmatch(r"sphere_-?\d+_-?\d+", n) for n in names[1:-3])
    # The same materials in the same cells for every seed.
    assert [next(iter(m)) for m in other["materials"]] == [
        next(iter(m)) for m in ours["materials"]]
    for p in other["primitives"][1:-3]:
        s = p["uv_sphere"]
        assert s["radius"] == 0.2
        # On the ground sphere (centre (0, 1000, 0), radius 1000).
        c = np.asarray(s["center"])
        assert abs(np.linalg.norm(c - [0, 1000, 0]) - 1000.165) < 1e-3


def test_devtrace_union_and_gaps():
    t = DeviceTrace(0.0, 100.0,
                    ops=[(10.0, 30.0, "k4"), (20.0, 40.0, "copy"),
                         (70.0, 80.0, "k4")],
                    spans=[(0.0, 100.0, "chunk"), (45.0, 65.0, "readback")])
    assert t.busy_s() == pytest.approx(40e-6)
    assert t.kernel_s("k4") == pytest.approx(30e-6)
    assert t.busy_s(25.0, 75.0) == pytest.approx(20e-6)
    assert t.top_ops(1) == [["k4", pytest.approx(30e-6)]]
    gaps = t.idle_gaps(10)
    assert [g[0] for g in gaps] == ["readback", "chunk", "chunk"]
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 20e-6, 10e-6])


def test_keeper_is_seeded_and_keeps_the_last():
    def kept(seed):
        k = drive._Keeper(seed, 3, forced=(1,))
        for i in range(50):
            k.offer(drive.Kept(str(i), None, 1.0, 1))
        return [a.label for a in k.answers()]

    a = kept(5)
    assert a == kept(5) and a != kept(6)
    assert a[0] == "1" and a[-1] == "49" and len(a) == 5


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & set(core.FORBIDDEN), f
        src = f.read_text()
        for name in ("import_module", "__import__"):
            # Dynamic imports take names from the benchmark's own files.
            for m in re.finditer(name + r"\(\s*['\"]([\w.]+)", src):
                assert m.group(1).split(".")[0] not in core.FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    for f in files:
        assert core.PROGRAM not in _imports(f), f
    # Every reference a configuration can name, loaded as a run loads it.
    modules = ", ".join(
        "rtbench.reference." + f.stem for f in files if f.stem != "__init__")
    assert "rtbench.reference.pathtracer" in modules
    code = ("import sys; sys.path.insert(0, %r); "
            "import %s, rtbench.check, rtbench.configs.fow_scene; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(ROOT), modules))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out))
    assert core.PROGRAM not in loaded and not loaded & set(core.FORBIDDEN)


def test_reads_nothing_of_the_old_benchmark():
    for f in sorted(BENCH.rglob("*")):
        if f.suffix in (".py", ".json"):
            src = f.read_text()
            for name in ("bench.py", "tools_dev", "BENCH_"):
                assert name not in src or f.name.startswith("test_"), (f, name)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "cornell-offline",
         "--seed", "11", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["rtbench"] and spec["command"][1] == (
        "rtbench/run.py")
    assert 1 <= spec["run_seconds"] <= 51
    b = core.Bench()
    cells = {w["name"]: w for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and isinstance(c["reduced"], list)
        # Each cut key once, named as a name is.
        assert len(c["reduced"]) <= 16
        assert len(set(c["reduced"])) == len(c["reduced"])
        assert all(isinstance(k, str) and NAME.fullmatch(k)
                   for k in c["reduced"])
        assert c["file"] == f"rtbench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
        b.reader(m["name"])
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads",
                                                                cells))
    for name in cells:
        own = [m["name"] for m in b.metrics(name, traced=False)]
        assert "setup_s" in own and len(own) >= 2
        assert b.metrics(name, traced=True)
