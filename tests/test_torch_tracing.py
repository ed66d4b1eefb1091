"""The port's tracer (utils/profiling.py ``span``/``spans``) and the spans
the Renderer records at its layer boundaries, on the CPU: nesting and
parent links, the ring's bound, the profiler ranges, and the Renderer's
``renderer.init``, ``renderer.step`` and ``renderer.readback`` spans
against ``stats`` and the scene."""

import json
import threading

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.models import compile_scene
from raytrace_tpu_torch.scene_file import SceneFile
from raytrace_tpu_torch.utils import profiling

torch.set_num_threads(1)

W, H = 16, 8
BATCHES = 5


def _doc():
    """Four spheres (a ground, diffuse, metal, glass), 4 spp x 5 batches:
    inside the fused kernel's gate."""
    def sphere(name, center, radius, material):
        return {"uv_sphere": {"name": name, "center": center,
                              "radius": radius, "rings": 8, "segments": 16,
                              "material": material}}

    return {
        "cameras": [{"perspective": {
            "name": "default", "eye": [0.0, -1.0, 8.0],
            "look_at": [0.0, 0.0, 0.0], "up": [0.0, 1.0, 0.0],
            "fov_y": 30.0, "z_near": 0.01, "z_far": 100.0,
            "focal_length": 10.0, "aperture_size": 0.0}}],
        "textures": [{"constant": {"name": "grey", "rgb": [0.5, 0.5, 0.5]}},
                     {"constant": {"name": "fuzz", "rgb": [0.1, 0.1, 0.1]}}],
        "materials": [
            {"lambertian": {"name": "grey", "albedo": "grey"}},
            {"metal": {"name": "metal", "albedo": "grey", "fuzz": "fuzz"}},
            {"dielectric": {"name": "glass", "refraction_index": 1.5}}],
        "primitives": [sphere("g", [0.0, 1000.0, 0.0], 999.0, "grey"),
                       sphere("a", [-2.0, 0.0, 0.0], 1.0, "grey"),
                       sphere("b", [0.0, 0.0, 0.0], 1.0, "metal"),
                       sphere("c", [2.0, 0.0, 0.0], 1.0, "glass")],
        "instances": [{"name": n} for n in "gabc"],
        "sky": {"vertical_gradient": {"factor": 0.5, "top": [0.5, 0.7, 1.0],
                                      "bottom": [1.0, 1.0, 1.0]}},
        "render": {"camera": "default", "samples_per_pixel": 4,
                   "sample_batches": BATCHES, "max_ray_depth": 3,
                   "aspect_ratio": 2.0},
    }


@pytest.fixture(scope="module")
def compiled():
    return compile_scene(SceneFile.from_json_dict(_doc()), width=W, height=H)


def _mine(renderer, name, since):
    """The spans called ``name`` of this renderer (by its serial number on
    the step and init spans, by their parents' on children)."""
    def serial(s):
        while s is not None:
            if "renderer" in s.attrs:
                return s.attrs["renderer"]
            s = s.parent
        return None

    return [s for s in profiling.spans(since) if s.name == name
            and serial(s) == renderer.serial]


def _children(parent, name):
    return [s for s in profiling.spans(parent.t0) if s.parent is parent
            and s.name == name]


# -- the tracer -------------------------------------------------------------


def test_nesting_and_parent_links():
    t = profiling.Tracer()
    with t.span("outer", a=1) as outer:
        with t.span("inner", b=2) as inner:
            pass
        with t.span("second"):
            pass
    got = t.spans()
    assert [s.name for s in got] == ["inner", "second", "outer"]
    assert inner.parent is outer and got[1].parent is outer
    assert outer.parent is None
    assert outer.attrs == {"a": 1} and inner.attrs == {"b": 2}
    assert outer.t0 <= inner.t0 <= inner.t1 <= got[1].t0 <= outer.t1
    assert inner.seconds == inner.t1 - inner.t0 >= 0.0
    assert t.spans(since=got[1].t0) == [got[1]]
    assert t.dropped == 0


def test_a_thread_keeps_its_own_parents():
    t = profiling.Tracer()
    seen = []

    def other():
        with t.span("in-thread") as s:
            seen.append(s)

    with t.span("main"):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    assert seen[0].parent is None
    assert {s.name for s in t.spans()} == {"in-thread", "main"}


def test_ring_keeps_the_last_and_counts_the_dropped():
    t = profiling.Tracer(size=4)
    for i in range(10):
        with t.span(f"s{i}"):
            pass
    assert [s.name for s in t.spans()] == ["s6", "s7", "s8", "s9"]
    assert t.dropped == 6
    assert profiling.RING == 1 << 16


def test_ranges_only_while_the_profiler_records(tmp_path):
    with profiling.span("test.before"):
        pass
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.span("test.inside") as inside:
            torch.ones(64).cumsum(0)
    with profiling.span("test.after") as after:
        pass
    events = json.load(open(prof.trace_path))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "rt.test.inside" in names
    assert not {"rt.test.before", "rt.test.after"} & names
    # A host range of function scope: the profiler puts no annotation of
    # it on the card's timeline.
    cats = {e.get("cat") for e in events if e.get("name") == "rt.test.inside"}
    assert cats == {"cpu_op"}
    assert inside._range is None and after._range is None


# -- the Renderer's spans ---------------------------------------------------


def test_compile_scene_is_a_span():
    t0 = profiling.spans()[-1].t1 if profiling.spans() else 0.0
    compile_scene(SceneFile.from_json_dict(_doc()), width=W, height=H)
    assert [s.name for s in profiling.spans(t0)].count("scene.compile") == 1


def test_renderer_init_spans(compiled):
    r = Renderer(compiled, device="cpu", use_megakernel=True)
    init = _mine(r, "renderer.init", None)
    assert len(init) == 1
    init = init[0]
    assert init.attrs == {"renderer": r.serial} and init.parent is None
    tables = _children(init, "renderer.init.world_tables")
    assert len(tables) == 1
    # A static scene's set-up computes the first batch time's table; each
    # other is built when a step reads it.
    assert tables[0].attrs["tables"] == 1
    assert _children(init, "renderer.init.upload")
    for s in profiling.spans(init.t0):
        if s.name.startswith("renderer.init."):
            assert s.parent is init and init.t0 <= s.t0 <= s.t1 <= init.t1
    assert Renderer(compiled, device="cpu").serial == r.serial + 1


def test_a_moving_scene_tables_every_batch_time_at_init():
    doc = _doc()
    doc["instances"][1]["transform"] = {"animated": [
        {"translate": [0.0, 0.0, 0.0]}, {"translate": [0.0, 0.5, 0.0]}]}
    cs = compile_scene(SceneFile.from_json_dict(doc), width=W, height=H)
    r = Renderer(cs, device="cpu", use_megakernel=True)
    (init,) = _mine(r, "renderer.init", None)
    (tables,) = _children(init, "renderer.init.world_tables")
    assert tables.attrs["tables"] == BATCHES
    since = profiling.spans()[-1].t1
    r.render_all()
    assert not [s for s in profiling.spans(since)
                if s.name == "renderer.step.world_table"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "wavefront"])
def test_a_step_span_a_chunk(compiled, fused):
    r = Renderer(compiled, device="cpu", use_megakernel=fused)
    r.CHUNK = 2
    since = profiling.spans()[-1].t1
    r.render_all()
    steps = _mine(r, "renderer.step", since)
    want = [(0, 2), (2, 2), (4, 1)] if fused else [(b, 1)
                                                  for b in range(BATCHES)]
    assert [(s.attrs["b0"], s.attrs["k"]) for s in steps] == want
    for s in steps:
        assert s.attrs["path"] == r.path and s.parent is None
        waits = _children(s, "renderer.step.wait")
        # The fused kernel's ray count, then the step's synchronize.
        assert len(waits) == (2 if fused else 1)
        geom = _children(s, "renderer.step.geometry")
        assert len(geom) == 1
        assert geom[0].attrs["h2d_bytes"] == r.sphere_tables[
            s.attrs["b0"]].nbytes
        assert len(_children(s, "renderer.step.launch")) == 1
        assert len(_children(s, "renderer.step.accumulate")) == 1
        assert not _children(s, "renderer.step.debug")
    records = [x for x in profiling.spans(since)
               if x.name == "renderer.step.record" and x.t0 >= steps[0].t0]
    assert len(records) == len(steps)
    assert all(rec.t0 >= s.t1 for rec, s in zip(records, steps))
    # The step spans are the seconds stats and metrics book.
    assert r.stats.render_seconds == sum(s.seconds for s in steps)
    assert r.metrics.total_seconds == pytest.approx(r.stats.render_seconds)
    assert r.stats.batches_done == BATCHES


def test_debug_and_readback_spans(compiled):
    r = Renderer(compiled, device="cpu", use_megakernel=True, debug=True)
    since = profiling.spans()[-1].t1
    r.render_batches(2)
    img = r.image()
    (step,) = _mine(r, "renderer.step", since)
    assert len(_children(step, "renderer.step.debug")) == 1
    (read,) = [s for s in profiling.spans(since)
               if s.name == "renderer.readback"]
    assert read.attrs == {"d2h_bytes": img.nbytes} == {
        "d2h_bytes": H * W * 3 * np.dtype(np.float32).itemsize}
