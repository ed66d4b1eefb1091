"""A configuration's own plain reference and geometry: the keys
``"reference"`` and ``"mesh_geometry"`` of configs/<name>.json, driven
through ``core.run`` on the CPU at a small size, and the work count of a
scene compiled to triangles."""

import json
import sys
import time
from pathlib import Path

import pytest

from rtbench import core, work
from rtbench.configs import fow_scene

BENCH = Path(core.__file__).resolve().parent
SEED = 3_000_000_043
CELL = "cornell-offline"
# Cornell at 16x16, 4 batches of 64 spp; the check's limits stay the
# configuration's.
SMALL = {"width": 16, "height": 16, "sample_batches": 4}
SMALL_CHECK = {"pixels": 256, "ref_samples": 1024}

RECORDING = '''
"""A reference that records its calls and renders as pathtracer."""
from rtbench.reference import pathtracer

CALLS = []


def render_pixels(*args, **kwargs):
    CALLS.append((args[3:8], kwargs))
    return pathtracer.render_pixels(*args, **kwargs)
'''


def overrides(**keys):
    cfg = core.Bench().config(core.Bench().cell(CELL)["config"])
    return {**SMALL, "check": {**cfg["check"], **SMALL_CHECK}, **keys}


def run_small(**keys):
    import torch

    torch.set_num_threads(2)
    return core.run(core.Bench(), CELL, SEED, 1.0, False,
                    time.perf_counter(), device="cpu",
                    overrides=overrides(**keys), log=lambda *a, **k: None)


@pytest.fixture
def compiles(monkeypatch):
    """Each compile_scene call's keywords and each Renderer's scene."""
    import raytrace_tpu_torch.engine as engine
    import raytrace_tpu_torch.models as models

    seen = {"compile": [], "scenes": []}
    compile_scene, renderer = models.compile_scene, engine.Renderer

    def compile_spy(scene, **kw):
        seen["compile"].append(kw)
        return compile_scene(scene, **kw)

    def renderer_spy(cs, **kw):
        seen["scenes"].append(cs)
        return renderer(cs, **kw)

    monkeypatch.setattr(models, "compile_scene", compile_spy)
    monkeypatch.setattr(engine, "Renderer", renderer_spy)
    return seen


@pytest.fixture
def facts(monkeypatch):
    """Each SceneFacts the run counted its work from."""
    out = []
    of = work.SceneFacts.of

    def spy(cls, *a, **kw):
        out.append(of(*a, **kw))
        return out[-1]

    monkeypatch.setattr(work.SceneFacts, "of", classmethod(spy))
    return out


def test_without_the_keys_pathtracer_and_analytic_spheres(
        compiles, facts, monkeypatch):
    from rtbench.reference import pathtracer

    calls = []
    render = pathtracer.render_pixels

    def spy(*a, **kw):
        calls.append(a[3:8])
        return render(*a, **kw)

    monkeypatch.setattr(pathtracer, "render_pixels", spy)
    cfg = core.Bench().config("cornell-box")
    assert "reference" not in cfg and "mesh_geometry" not in cfg
    result = run_small()
    assert result["correct"], result["check"]
    assert calls == [(16, 16, 1024, 8, 50)]
    assert compiles["compile"] == [{"width": 16, "height": 16,
                                    "analytic_spheres": True}]
    assert facts == [work.SceneFacts(0, 36, 4, 2, False, 256)]


@pytest.fixture
def recording(tmp_path, monkeypatch):
    """A reference module ``recording`` found by name beside pathtracer."""
    import rtbench.reference as package

    (tmp_path / "recording.py").write_text(RECORDING)
    monkeypatch.setattr(package, "__path__",
                        [*package.__path__, str(tmp_path)])
    yield "rtbench.reference.recording"
    sys.modules.pop("rtbench.reference.recording", None)


def test_the_named_reference_is_called(recording, monkeypatch):
    from rtbench.reference import pathtracer

    direct = []
    render = pathtracer.render_pixels

    def spy(*a, **kw):
        direct.append(a[3:8])
        return render(*a, **kw)

    monkeypatch.setattr(pathtracer, "render_pixels", spy)
    result = run_small(reference="recording")
    calls = sys.modules[recording].CALLS
    assert [c[0] for c in calls] == [(16, 16, 1024, 8, 50)]
    assert calls[0][1]["seed"] == SEED
    # pathtracer ran once, for the recording reference alone.
    assert direct == [(16, 16, 1024, 8, 50)]
    assert result["correct"], result["check"]


@pytest.mark.parametrize("name", ["no_such_reference", "../pathtracer",
                                  "pathtracer.render_pixels", "__init__",
                                  3])
def test_an_unknown_reference_is_refused_before_set_up(name, compiles):
    with pytest.raises(core.ConfigError, match="reference") as err:
        run_small(reference=name)
    assert repr(name) in str(err.value)
    assert compiles["compile"] == [] and compiles["scenes"] == []


def test_a_mesh_geometry_that_is_not_a_switch_is_refused(compiles):
    with pytest.raises(core.ConfigError, match="mesh_geometry"):
        run_small(mesh_geometry="yes")
    assert compiles["compile"] == []


def test_mesh_geometry_compiles_the_spheres_to_triangles(
        tmp_path, compiles, facts):
    doc = json.loads((BENCH / "configs" / "cornell-box.scene.json")
                     .read_text())
    doc["primitives"].append({"uv_sphere": {
        "name": "ball", "center": [190, 90, 190], "radius": 90,
        "rings": 8, "segments": 12, "material": "white"}})
    doc["instances"].append({"name": "ball"})
    path = tmp_path / "ball.scene.json"
    path.write_text(json.dumps(doc))
    result = run_small(scene={"file": str(path)}, mesh_geometry=True)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert compiles["compile"] == [{"width": 16, "height": 16,
                                    "analytic_spheres": False}]
    ball = 2 * 12 * (8 - 1)
    assert facts == [work.SceneFacts(0, 36 + ball, 4, 2, False, 256)]
    for cs in compiles["scenes"]:
        assert cs.num_spheres == 0 and cs.num_triangles == 36 + ball
    # The same document without the switch: one analytic sphere.
    compiles["compile"].clear()
    compiles["scenes"].clear()
    run_small(scene={"file": str(path)})
    assert compiles["scenes"][0].num_spheres == 1
    assert compiles["scenes"][0].num_triangles == 36


def test_mesh_count_of_final_one_weekend():
    doc = fow_scene.scene(fow_scene.REFERENCE_SEED)
    mesh = work.SceneFacts.of(doc, 1200, 675, mesh_geometry=True)
    # The ground 2 * 256 * 127, the grid 484 * 2 * 64 * 31, the three
    # hero spheres 3 * 2 * 128 * 63.
    assert mesh == work.SceneFacts(0, 2_033_920, 488, 0, True, 810_000)
    assert 65_024 + 484 * 3_968 + 3 * 16_128 == 2_033_920
    assert work.SceneFacts.of(doc, 1200, 675).spheres == 488


def test_mesh_count_of_a_light_sphere_and_an_obj_mesh():
    doc = json.loads((BENCH / "configs" / "cornell-box.scene.json")
                     .read_text())
    doc["primitives"].append({"uv_sphere": {
        "name": "lamp", "center": [278, 400, 278], "radius": 40,
        "rings": 4, "segments": 6, "material": "light"}})
    doc["instances"].append({"name": "lamp"})
    assert work.SceneFacts.of(doc, 8, 8) == work.SceneFacts(
        1, 36, 4, 2, False, 64)
    assert work.SceneFacts.of(doc, 8, 8, mesh_geometry=True) == (
        work.SceneFacts(0, 36 + 36, 4, 2 + 36, False, 64))
    doc["primitives"].append({"obj_mesh": {
        "name": "bunny", "path": "bunny.obj", "material": "white"}})
    doc["instances"].append({"name": "bunny"})
    with pytest.raises(ValueError, match="obj_mesh"):
        work.SceneFacts.of(doc, 8, 8)
