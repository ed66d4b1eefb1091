"""What chip_smoke.py and tools/chip_probe.py share
(raytrace_tpu_torch/tools/smoke_lib.py), on the CPU: the least time the
card allows, the parse of nvcc's register report, K1's failure
diagnostics, the PyTorch calls timed beside the P1 probes, K4's idle
lanes: the per-sample and regenerating warp models, the measuring
build's counters and the wavefront's path lengths, and H1's and H2's
work counts."""

import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from raytrace_tpu_torch.tools import smoke_lib
from raytrace_tpu_torch.tools_dev import probe_ops

torch.set_num_threads(1)


def test_least_ms_takes_the_larger_time():
    ms, by = smoke_lib.least_ms(smoke_lib.PEAK_FP32_FLOPS / 1e3, 0.0)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by = smoke_lib.least_ms(0.0, smoke_lib.PEAK_BYTES / 1e3)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    # INT32 operations at half the FP32 rate.
    ms, by = smoke_lib.least_ms(0.0, 0.0, smoke_lib.PEAK_INT32_OPS / 1e3)
    assert (ms, by) == (pytest.approx(1.0), "operations")


def test_least_ms_counts_shared_memory_bytes():
    """Shared-memory bytes at their own rate, against device memory's and
    the operations'; the larger time wins."""
    ms, by = smoke_lib.least_ms(0.0, 0.0,
                                shared_bytes=smoke_lib.PEAK_SHARED_BYTES / 1e3)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = smoke_lib.least_ms(smoke_lib.PEAK_FP32_FLOPS / 1e3,
                                smoke_lib.PEAK_BYTES / 2e3,
                                shared_bytes=smoke_lib.PEAK_SHARED_BYTES / 4e3)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by = smoke_lib.least_ms(smoke_lib.PEAK_FP32_FLOPS / 4e3,
                                smoke_lib.PEAK_BYTES / 2e3,
                                shared_bytes=smoke_lib.PEAK_SHARED_BYTES / 1e3)
    assert (ms, by) == (pytest.approx(1.0), "bytes")


def test_ptxas_forms_names_each_instantiation():
    log = "".join(
        f"ptxas info    : Compiling entry function "
        f"'_Z10megakernelILb{a}ELb{t}ELb{li}ELb{n}ELb{im}ELb{c}EEvPKf' for "
        f"'sm_90a'\nptxas info    : Function properties\n    0 bytes stack "
        f"frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, 400 bytes cmem[0]\n"
        for a, t, li, n, im, c, regs, spill in (
            (0, 0, 0, 0, 0, 1, 56, 12), (1, 0, 0, 1, 0, 0, 72, 8),
            (0, 1, 1, 1, 1, 1, 72, 28)))
    assert smoke_lib.ptxas_forms(log) == [
        ("static+clusters", 56, 12), ("anim+noise", 72, 8),
        ("tris+lights+noise+image+clusters", 72, 28)]
    assert smoke_lib.ptxas_kernel(log.split("ptxas info    : Compiling")[1]
                                  ) == (56, 12)
    assert len(smoke_lib.K4_FORMS) == 36
    assert set(smoke_lib.K4_FORMS) == {
        *smoke_lib.FORMS_BEFORE, *smoke_lib.IMAGE_FORMS_BEFORE,
        *smoke_lib.CLUSTER_FORMS_BEFORE}


def test_sweep_diagnostics_finds_whole_blocks():
    id_ref = torch.arange(1024, dtype=torch.int32) % 8
    ids = id_ref.clone()
    ids[256:512] = -1          # a 256-ray block that never wrote its ids
    ids[5] = 99                # an id outside [-1, 8)
    t = torch.ones(1024)
    t[7] = float("nan")
    diag = smoke_lib.sweep_diagnostics(ids, id_ref, t, 8)
    assert diag.startswith("257 rays disagree")
    assert f"ids outside [-1, 8) on {1 / 1024:.6f}" in diag
    assert f"t not finite on {1 / 1024:.6f}" in diag
    assert f"{256 / 257:.6f} are a K1 miss and a plain hit" in diag
    assert "1 whole 256-ray blocks disagree (first [1]), of 2 blocks" in diag


@pytest.mark.parametrize("name", probe_ops.PROBES)
def test_library_calls_compute_the_probes(name):
    x, tab = probe_ops.make_inputs("cpu").args(name)
    call = smoke_lib.library_call(name, x, tab)
    if name in ("onehot-fetch", "vmem-scalar-read", "vmem-dynrow-read"):
        assert torch.equal(call(), probe_ops.probe_reference(name, x, tab))
    else:
        assert call is None


def test_grazing_rays_aim_at_box_edges_from_far_away():
    """Each ray's origin lies 1,000-2,000 units from a point within the
    jitter of an edge of one of the boxes, and its direction is a unit
    vector towards that point."""
    import numpy as np

    boxes = np.array([[0.0, 0.0, 0.0, 1.0, 2.0, 3.0],
                      [-5.0, 4.0, 4.0, -4.0, 4.5, 6.0]], np.float32)
    o, d = smoke_lib.grazing_rays(boxes, 256, 3, "cpu")
    o = torch.stack(tuple(o), 1).double()
    d = torch.stack(tuple(d), 1).double()
    assert torch.allclose(d.norm(dim=1), torch.ones(256, dtype=torch.float64),
                          atol=1e-6)
    dist = o.norm(dim=1)
    assert (dist > 990).all() and (dist < 2010).all()
    # Each ray's line comes within 2e-3 of one of the boxes (sampled every
    # 1e-3 around its closest approach to the box's centre).
    steps = torch.arange(-4.0, 4.0, 1e-3, dtype=torch.float64)
    near = []
    for b in torch.tensor(boxes, dtype=torch.float64):
        s = ((((b[:3] + b[3:]) / 2) - o) * d).sum(1, keepdim=True)
        p = o[:, None] + (s + steps)[..., None] * d[:, None]   # [R, S, 3]
        out = torch.maximum(b[:3] - p, p - b[3:]).clamp(min=0).norm(dim=2)
        near.append(out.amin(1))
    assert (torch.stack(near).amin(0) < 2e-3).all()


def test_k3_tables_take_the_tree():
    from types import SimpleNamespace

    assert smoke_lib.k3_tables(SimpleNamespace(tri_tree="tree",
                                               tri_pages=None)) == "tree"
    assert smoke_lib.k3_tables(SimpleNamespace(tri_pages="pages")) == "pages"


# ---- K4's idle lanes: the two warp models over path lengths ---------------

def test_warp_models_give_one_for_equal_lengths():
    lengths = torch.full((96, 5), 7, dtype=torch.int32)
    assert smoke_lib.warp_tail(lengths) == (1.0, 1.0, 7.0, 7.0)
    assert smoke_lib.warp_regen(lengths) == (1.0, 1.0, 35.0, 35.0)


def test_warp_models_on_two_warps_worked_by_hand():
    """Warp 0: every path 1 bounce but lane 0's first sample (3).  Warp 1:
    every path 2 but lane 5's second sample and lane 7's first (4 each).
    Per sample the warps run 3 + 1 and 4 + 4 steps; regenerating, their
    busiest lanes' totals, 4 and 6."""
    lengths = torch.ones((64, 2), dtype=torch.int32)
    lengths[0, 0] = 3
    lengths[32:] = 2
    lengths[32 + 5, 1] = 4
    lengths[32 + 7, 0] = 4
    tail = smoke_lib.warp_tail(lengths)
    assert tail == pytest.approx((
        (34 / 32 + 1 + 66 / 32 + 66 / 32) / 12,
        (34 / 96 + 1 + 66 / 128 + 66 / 128) / 4, 3.0,
        (34 / 32 + 1 + 66 / 32 + 66 / 32) / 4), abs=1e-12)
    regen = smoke_lib.warp_regen(lengths)
    assert regen == pytest.approx((
        (66 / 32 + 132 / 32) / 10, (66 / 128 + 132 / 192) / 2, 5.0,
        (66 / 32 + 132 / 32) / 2), abs=1e-12)
    assert regen[0] > tail[0]


def test_warp_tail_gives_the_per_sample_numbers():
    """The per-sample model (moved from chip_smoke.py) against a plain
    loop over warps and samples; a last partial warp is dropped."""
    import numpy as np

    g = np.random.default_rng(5)
    lengths = g.integers(1, 40, (32 * 3 + 11, 6)).astype(np.int32)
    ratios, means, longest = [], [], []
    for w in range(3):
        for s in range(6):
            lane = lengths[32 * w:32 * (w + 1), s].astype(np.float64)
            ratios.append(lane.mean() / lane.max())
            means.append(lane.mean())
            longest.append(lane.max())
    want = (sum(means) / sum(longest), np.mean(ratios), np.mean(longest),
            np.mean(means))
    assert smoke_lib.warp_tail(torch.tensor(lengths)) == pytest.approx(
        want, rel=1e-12)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 4), st.integers(1, 9), st.integers(0, 2 ** 32 - 1),
       st.integers(1, 60))
@example(warps=2, k=2, seed=225, top=31)
def test_regeneration_keeps_at_least_as_many_lanes_busy(warps, k, seed, top):
    """A lane's total over its samples is at most the sum of each sample's
    longest path, so the regenerating share is never below the per-sample
    one: over the frame, and in each warp against that warp's per-sample
    share pooled over its samples (sum of means over sum of longest).  The
    mean of the per-(warp, sample) ratios has no such bound (the example:
    a short sample's ratio near 1 lifts the mean above the pooled share)."""
    import numpy as np

    g = np.random.default_rng(seed)
    lengths = torch.tensor(g.integers(1, top + 1, (32 * warps, k)),
                           dtype=torch.int32)
    tail, regen = smoke_lib.warp_tail(lengths), smoke_lib.warp_regen(lengths)
    assert regen[0] >= tail[0] - 1e-12
    w = lengths.numpy().reshape(warps, 32, k).astype(np.float64)
    pooled = w.mean(axis=1).sum(axis=1) / w.max(axis=1).sum(axis=1)
    assert regen[1] >= pooled.mean() - 1e-12
    assert 0.0 < tail[0] <= 1.0 and 0.0 < regen[0] <= 1.0
    assert 0.0 < tail[1] <= 1.0 and 0.0 < regen[1] <= 1.0


def test_measured_busy_reads_the_counters():
    counts = {"busy": 96, "slots": 128, "regen": 10, "hit": 50, "shade": 20,
              "nee": 15, "end": 5}
    busy, phases = smoke_lib.measured_busy(counts)
    assert busy == 0.75
    assert phases == {"regen": 0.1, "hit": 0.5, "shade": 0.2, "nee": 0.15,
                      "end": 0.05}


def test_noise_form_docs_give_each_noise_form_partial_warps(tmp_path):
    """One small doc for each of K4's 18 noise forms, each with a noise
    texture and, at the partial-warp width, a frame whose last warp has
    lanes past the image."""
    import json
    import os

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.models import compile_scene
    from raytrace_tpu_torch.scene_file import SceneFile
    from raytrace_tpu_torch.tools import image_scenes

    png = image_scenes.texel_id_png(str(tmp_path / "small.png"), 64, 32)
    with open(os.path.join(os.path.dirname(cli.DEFAULT_SCENE),
                           "final-one-weekend-motion-blur.json")) as f:
        docs = smoke_lib.noise_form_docs(json.load(f), png)
    assert sorted(docs) == sorted(f for f in smoke_lib.K4_FORMS
                                  if "noise" in f)
    for form, (doc, _, _) in docs.items():
        cs = compile_scene(SceneFile.from_json_dict(doc),
                           width=smoke_lib.PARTIAL_WARP_WIDTH)
        assert cs.render.width * cs.render.height % 32 != 0, form
        assert "noise" in json.dumps(doc), form


def test_wave_lengths_count_each_sample_bounce_by_bounce():
    """A small cornell-style frame on the CPU's wavefront: the path
    lengths add up to the rays traced, and per pixel to the fused path's
    plain version's bounce counts."""
    import dataclasses

    from raytrace_tpu_torch.engine import Renderer, wavefront
    from raytrace_tpu_torch.models import compile_scene
    from raytrace_tpu_torch.ops import megakernel
    from raytrace_tpu_torch.scene_file import SceneFile
    from raytrace_tpu_torch.tools import light_scenes

    cs = compile_scene(SceneFile.from_json_dict(light_scenes.cornell_doc()),
                       width=8)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=4, max_ray_depth=20))
    r = Renderer(cs, device="cpu", use_megakernel=True)
    geom = r._geometry(0)
    trace = wavefront.make_trace_fn(r.static, r.scene, geom)
    img, rays, lengths = smoke_lib.wave_lengths(
        r.static, r.scene, r.camera, trace, geom, r.use_dof,
        r.rows_per_tile)
    assert img.shape == (8, 8, 3) and lengths.shape == (64, 4)
    assert int(lengths.sum()) == rays and int(lengths.min()) >= 1
    _, traced = megakernel.megakernel_reference(
        r.static, r.scene, geom, r.camera, 0, 1, use_dof=r.use_dof)
    assert torch.equal(lengths.sum(1).reshape(8, 8), traced)


def test_kernel_builds_include_the_measuring_build():
    from raytrace_tpu_torch.ops import _build, megakernel

    builds = smoke_lib.kernel_builds()
    assert builds["megakernel_measure"] is megakernel.measure_library
    # The nine kernel sources, the measuring build and the SAH builder.
    assert len(builds) == 11 and "bvh_builder" in builds
    assert _build.source("megakernel_measure") == _build.source("megakernel")
    assert "-DK4_MEASURE" in _build.nvcc_flags("megakernel_measure")
    assert "-DK4_MEASURE" not in _build.nvcc_flags("megakernel")
    assert (_build.library_path("megakernel_measure")
            != _build.library_path("megakernel"))


def test_ptxas_entry_reads_one_kernel_of_several():
    """K1's and K2's sources each hold a walk and a dense entry point; the
    walk's registers are read by its own length-prefixed name."""
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_125sphere_sweep_dense_kernelEPK6float4i' for "
           "'sm_90a'\nptxas info    : Used 40 registers\n"
           "ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_119sphere_sweep_kernelEPK6float4i' for "
           "'sm_90a'\n    224 bytes stack frame, 8 bytes spill stores, 8 "
           "bytes spill loads\nptxas info    : Used 56 registers\n")
    assert smoke_lib.ptxas_entry(log, "sphere_sweep_kernel") == (56, 8)
    assert smoke_lib.ptxas_entry(log, "sphere_sweep_dense_kernel") == (40, 0)
    with pytest.raises(AssertionError, match="no entry"):
        smoke_lib.ptxas_entry(log, "tri_sweep_kernel")
    assert set(smoke_lib.WALK_KERNELS) == set(smoke_lib.WALKS_BEFORE)


def _walk_renderer(doc, width=16):
    import dataclasses

    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.models import compile_scene
    from raytrace_tpu_torch.scene_file import SceneFile

    cs = compile_scene(SceneFile.from_json_dict(doc), width=width)
    cs = dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, samples_per_pixel=4, max_ray_depth=4))
    return Renderer(cs, device="cpu", use_megakernel=False)


@pytest.mark.parametrize("name", ["final-one-weekend", "cornell-style"])
def test_dense_trace_is_the_wavefronts_trace(name):
    """The dense oracle's trace gives the wavefront's own hits, ray for
    ray, on the CPU (where both are the plain versions)."""
    import json

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.tools import light_scenes

    if name == "cornell-style":
        doc = light_scenes.cornell_doc()
    else:
        with open(cli.DEFAULT_SCENE) as f:
            doc = json.load(f)
    r = _walk_renderer(doc)
    geom = r._geometry(0)
    own = wavefront.make_trace_fn(r.static, r.scene, geom)
    dense = smoke_lib.dense_trace_fn(r.static, r.scene, geom)
    _, o, d = wavefront.primary_rays(r.static, r.camera, 0, 0,
                                     r.static.height, r.use_dof, "cpu")
    alive = torch.rand(o.x.shape[0], generator=torch.Generator().manual_seed(
        1)) < 0.8
    a, b = own(o, d, alive), dense(o, d, alive)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sphere_walk_bound_counts_the_walks_work():
    """K1's bound from the walk's work: more rays cost more, the prefix's
    tests are counted, and it is far below the dense sweep's."""
    import json

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.ops import sphere_sweep

    with open(cli.DEFAULT_SCENE) as f:
        r = _walk_renderer(json.load(f), width=32)
    geom = r._geometry(0)
    _, o, d = wavefront.primary_rays(r.static, r.camera, 0, 0,
                                     r.static.height, r.use_dof, "cpu")
    alive = torch.ones(o.x.shape[0], dtype=torch.bool)
    best_t = sphere_sweep.sphere_sweep_reference(o, d, geom.sph_table8)[0]
    ms, by, per = smoke_lib.sphere_walk_bound(o, d, alive, geom.sph_tree,
                                              best_t, 1 << 20)
    ms2, _, _ = smoke_lib.sphere_walk_bound(o, d, alive, geom.sph_tree,
                                            best_t, 1 << 22)
    assert 0 < ms < ms2 and by in ("operations", "bytes")
    assert per["prefix_tests"] == geom.sph_tree.n_prefix > 0
    assert 1 <= per["node_tests"] and per["sphere_tests"] < 100
    dense, _ = smoke_lib.least_ms(
        (1 << 20) * geom.sph_table8.shape[0] * smoke_lib.FLOPS_PER_TEST, 0.0)
    assert ms < dense / 5


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["final-one-weekend", "cornell-style"])
def test_walk_batch_holds_the_renderers_wavefront_to_the_dense_oracle(
        name):
    """chip_smoke's _walk_batch: a batch rendered through the dense
    oracle's trace (smoke_lib.dense_trace_fn) and the same batch rendered
    by the Renderer itself are the same bytes and rays, with the sweeps'
    launches counted from 0 (none on the CPU); a batch that differs by
    one ulp, or by one ray, fails."""
    import json

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.tools import light_scenes

    chip_smoke = _chip_smoke()
    if name == "cornell-style":
        doc = light_scenes.cornell_doc()
    else:
        with open(cli.DEFAULT_SCENE) as f:
            doc = json.load(f)
    r = _walk_renderer(doc)
    geom = r._geometry(0)
    trace = smoke_lib.dense_trace_fn(r.static, r.scene, geom)
    img, rays, _ = smoke_lib.wave_lengths(r.static, r.scene, r.camera, trace,
                                          geom, r.use_dof, r.rows_per_tile)
    out = chip_smoke._walk_batch(name, r, img, rays, "cpu")
    assert out["k1"] == out["k2"] == 0 and r.current_batch == 1
    off = img.clone()
    off.view(-1)[0] = torch.nextafter(off.view(-1)[0], torch.tensor(1.0))
    for bad_img, bad_rays in ((off, rays), (img, rays + 1)):
        r = _walk_renderer(doc)
        with pytest.raises(AssertionError, match="differ"):
            chip_smoke._walk_batch(name, r, bad_img, bad_rays, "cpu")


def test_app_trace_reports_the_traced_batch(tmp_path):
    """The smoke's profiled app batch, called in this process on the CPU
    at a small size: the wavefront's batch traced to a Chrome trace file;
    no kernel events and no K4 launch on the CPU.  A failure (here, no
    scene) comes back as its traceback."""
    import queue

    from raytrace_tpu_torch import cli

    results = queue.Queue()
    smoke_lib.app_trace(cli.load_scene(cli.DEFAULT_SCENE, 16, 9),
                        str(tmp_path / "trace"), results, device="cpu")
    out, tb = results.get_nowait()
    assert tb is None
    assert out["path"] == "wavefront" and out["launches"] == 0
    assert out["trace"].startswith(str(tmp_path / "trace"))
    assert out["kernels"] == []
    smoke_lib.app_trace(None, str(tmp_path), results, device="cpu")
    out, tb = results.get_nowait()
    assert out is None and "Traceback" in tb


def test_subset_rays_take_the_same_rays_from_each_tensor():
    from raytrace_tpu_torch.ops.vec3 import V3

    R = 1000
    o = V3(*(torch.arange(R, dtype=torch.float32) + k for k in (0, 1, 2)))
    d = V3(*(-torch.arange(R, dtype=torch.float32) - k for k in (0, 1, 2)))
    alive = torch.arange(R) % 3 == 0
    so, sd, sa = smoke_lib.subset_rays(o, d, alive, 64,
                                       torch.Generator().manual_seed(0))
    assert so.x.shape == (64,) and len(set(so.x.tolist())) == 64
    assert torch.equal(so.y, so.x + 1) and torch.equal(sd.z, -so.x - 2)
    assert torch.equal(sa, so.x.long() % 3 == 0)
    assert all(v.is_contiguous() for v in (*so, *sd, sa))


def test_bvh_work_counts_the_binary_proof_beside_the_wide_walk():
    """H1's work over the four-wide rows it walks and over the binary
    rows of the same boxes: fewer wide node steps, but no fewer box tests
    (four a wide step, two a binary one) and no fewer triangle tests, and
    each row read counted at its width."""
    import numpy as np

    from raytrace_tpu_torch.engine import Renderer, wavefront
    from raytrace_tpu_torch.models import bvh_build, compile_scene
    from raytrace_tpu_torch.ops import bvh
    from raytrace_tpu_torch.ops.vec3 import V3
    from raytrace_tpu_torch.scene_file import SceneFile
    from raytrace_tpu_torch.tools import stress_scenes

    cs = compile_scene(SceneFile.from_json_dict(
        stress_scenes.box_grid_doc(200, False)), width=16)
    data = bvh_build.build_bvh_sah(cs)
    soup = bvh_build.permute_soup(cs, data.order)
    r = Renderer(soup, device="cpu", use_bvh=False)
    tris = wavefront.prepare_tris(r.static, r.scene, r.batch_times_dev[0])
    n = soup.num_triangles
    wp = tris["world_p"][:n].numpy()
    g = np.random.default_rng(3)
    o = g.uniform(wp.min((0, 1)) - 1, wp.max((0, 1)) + 1, (2048, 3))
    d = wp[g.integers(0, n, 2048)].mean(axis=1) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (V3(*(torch.tensor(a[:, i], dtype=torch.float32)
                 for i in range(3))) for a in (o, d))
    alive = torch.ones(2048, dtype=torch.bool)
    rows, root, stack = bvh.wide_tree(data, n)
    wide = bvh.BVHTree(torch.tensor(rows), root, stack, data.leaf_size, n)
    b_rows, b_root = bvh.node_rows(data, n)
    binary = bvh.BVHTree(torch.tensor(b_rows), b_root, data.depth + 2,
                         data.leaf_size, n)
    (w_per, w_bytes), (b_per, b_bytes) = smoke_lib.bvh_work(
        o, d, alive, tris["tri_table12"], (wide, binary), 1024,
        torch.Generator().manual_seed(0))
    assert 1 <= w_per[0] < b_per[0]
    assert 4 * w_per[0] >= 2 * b_per[0] and w_per[1] >= b_per[1] > 0
    assert w_bytes % 16 == 0 and b_bytes % 16 == 0 and w_bytes >= 128


def test_sphere_obj_work_counts_the_walks_work():
    """H2's work on fow-ellipsoids' primary rays through the Renderer's
    tree: every ray tests the dense prefix, a few nodes and far fewer
    spheres than the table holds."""
    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.ops import sphere_obj
    from raytrace_tpu_torch.tools import ellipsoid_scenes

    r = _walk_renderer(ellipsoid_scenes.fow_ellipsoids_doc(), width=32)
    geom = r._geometry(0)
    table, tree = geom.sph_obj16, geom.sph_obj_tree
    _, o, d = wavefront.primary_rays(r.static, r.camera, 0, 0,
                                     r.static.height, r.use_dof, "cpu")
    alive = torch.ones(o.x.shape[0], dtype=torch.bool)

    def launch(o, d, a):
        return sphere_obj.intersect_spheres_object(o, d, table, a, tree)

    per, w = smoke_lib.sphere_obj_work(o, d, alive, launch, tree, 256,
                                       torch.Generator().manual_seed(0))
    assert w["rays"] == 256 and per["prefix_tests"] == tree.n_prefix == 4
    assert per["node_tests"] >= 1
    assert 0 < per["sphere_tests"] < tree.num_spheres / 8
    assert 0 < w["spheres_read"] <= tree.num_spheres
