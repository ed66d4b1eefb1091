"""Short measurements on one CUDA card, outside chip_smoke.py.

    python3 raytrace_tpu_torch/tools/chip_probe.py anim [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py chunks [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py tris [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py lights [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py paged [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py noise [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py image [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py spheres [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py probes [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py trig [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py k1 [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py forms [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py sass [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py walks [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py hwalks [TREE]

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
- ``tris``: builds the fused kernel (with K1 and K2) and prints each K4
  form's registers and spills; holds the triangle forms against the plain
  version at small size (the triangle stress scene, tools/stress_scenes.py,
  at k = 1 and 4 and the triangle fixture at 96x54/depth 8/k=2; the two
  light scenes of tools/light_scenes.py at 128 wide/depth 50/k=2; bit for
  bit, two launches byte-identical); times K4 on one full batch of
  tri-stress-15360 (1024x576, 16 spp, depth 50; median of 5),
  cornell-style (1024x1024, 64 spp) and sphere-light-962 (1024x576, 64
  spp; medians of 3); with a soup tree (since the tree walk), times the
  tri-stress and cornell-style batches at leaf sizes 2, 4, 8 and 16;
  renders tri-stress's batch through ``Renderer`` with defaults; ends
  with one JSON line.  It runs on a parent checkout whose K4 swept
  cluster boxes too, so TREE = the parent's ``git archive`` gives the
  before of the same card.
- ``lights``: builds the fused kernel (and its measuring build, where
  TREE has one) and prints nvcc's register report; holds its lit forms
  against the plain version at depth 50, k=2 on the four lit docs of
  tools/light_scenes.py (cornell-style at 128x128, sphere-light-962 at
  128x72, the lit spheres and the 70-instance doc at 96 wide; bit for bit
  or not, and two launches byte-identical), holds one full batch of each
  light scene against the plain version (bit for bit or not; the plain
  version's seconds and peak device memory) and times it (kernel median
  of 5), times final-one-weekend's batch at 1200x675; on those three
  batches K4's lanes busy under the two warp models of this checkout's
  smoke_lib (the wavefront's path lengths) and, with a measuring build,
  K4's own count and phase cycles; steps two full cornell-style batches
  through ``Renderer`` with defaults; ends with one JSON line.  TREE =
  the parent's ``git archive`` gives the before of the same card (the
  models, no measuring build).
- ``paged``: builds the paged triangle sweep K3 (with K1 and K2) and
  prints nvcc's register report; holds K3 against its plain version and
  K2 on random soups with an alive mask and a repeat launch; on
  final-one-weekend --mesh-geometry (2,033,920 triangles) captures every
  bounce's rays of one batch, times the table build and K3 on each
  bounce's rays (K3 ms a batch), holds K3 against K2 on 2^17 rays of
  bounces 0, 1, 2 and 10 and on 2^16 far grazing rays at the leaf boxes;
  with a tree, times the batch at leaf sizes 4, 8 and 16 and counts the
  tree's and the flat walk's work on bounces 0-2; steps three batches of
  ``Renderer`` with defaults and profiles a fourth (Mrays/s, the card's
  busy share, K3's share of device time), renders one batch of the
  motion-blur scene with --mesh-geometry (with a tree, its re-fit
  timed), and ends with one JSON line.  It runs on a parent checkout
  whose K3 walked page tables too (``smoke_lib``'s K3 helpers, loaded
  from beside this file), so TREE = the parent's ``git archive`` gives
  the before of the same card.
- ``noise``: builds the fused kernel (and its measuring build, where
  TREE has one) and prints nvcc's register report; holds each of its 18
  noise forms against the plain version (bit for bit, two launches
  byte-identical) on its small doc (``smoke_lib.noise_form_docs``, 2
  batches in one launch) and on the same doc at the partial-warp width
  (``smoke_lib.PARTIAL_WARP_WIDTH``) at depths 1 and 50, and prints each
  noise form's resident blocks a multiprocessor at its shared memory (a
  clustered form with a full staged tree); holds the full batches of
  perlin-spheres (1024x576, 16 spp, depth 50) and sphere-light-962
  (1024x576, 64 spp) against the plain version and times them (kernel
  medians of 5), and runs them through the measuring build (busy lanes,
  phase cycles and, since the lattice tables, the turbulences the lanes
  took, a warp step); times one batch of final-one-weekend, cornell-style,
  tri-stress-15360 and earth (forms without noise); steps perlin-spheres'
  batch through ``Renderer`` with defaults; ends with one JSON line.
  TREE = the parent's ``git archive`` gives the before of the same card.
- ``image``: builds the fused kernel and its measuring build and prints
  nvcc's register report; holds each of its 16 image forms against the
  plain version on its small doc (``tools/image_scenes.form_checks``, a
  640x320 texel-id image, and the image docs of
  ``tools/stress_scenes.cluster_form_checks``; 2 batches in one launch;
  bit for bit or not, two launches byte-identical) and prints its
  resident blocks a multiprocessor; holds earth's full batch (512x512, 4
  spp, depth 50, its 5400x2700 image) and ``render_all``'s two chunks of
  it (batches 0-11 and 12-15) against the plain version (bit for bit or
  not, the plain version's seconds) and times them (kernel medians of 21
  and 9); runs the batch through the measuring build (busy lanes, phase
  cycles); holds earth-motion-blur's first per-batch launch against the
  plain version and times it (median of 21); steps earth's batch through
  ``Renderer`` with defaults; ends with one JSON line.  TREE = the
  parent's ``git archive`` gives the before of the same card.
- ``spheres``: builds the fused kernel and prints each K4 form's
  registers and spills; with a sphere tree (since the tree walk), each
  clustered form's resident blocks a multiprocessor at each staging cap
  of STAGE_CAPS; holds each form of its clustered sphere sweep against
  the plain version on the small docs of
  ``tools/stress_scenes.cluster_form_checks`` (2 batches in one launch;
  bit for bit or not, two launches byte-identical, the clustered launches
  counted) and times it, clustered and dense (medians of 5); holds one
  full batch of final-one-weekend (1200x675), its motion-blur twin and
  stress-4x (1024x576) against the plain version (bit for bit or not) and
  times the clustered form and the dense form (kernel medians of 5), with
  a tree also at each leaf size of SPHERE_LEAVES and cap of STAGE_CAPS,
  and the tree's build (CUDA events); final-one-weekend's batch through
  the measuring build (its phase cycles); compiles stress-16k (seconds),
  holds a 128x72, depth-50 batch of it against the plain version, times
  its full batch (and the sweep) and holds it against the wavefront's;
  steps two batches of each stress scene through ``Renderer`` with
  defaults; final-one-weekend's main path, four stepped batches and a
  12-batch chunk (Mrays/s); the soup tree's build for tri-stress-15360
  (CUDA events); ends with one JSON line.  TREE = the parent's ``git
  archive`` gives the before of the same card (no sweep there).
- ``probes``: builds the three dev probes (P1-P3,
  ``raytrace_tpu_torch/tools_dev/``) together and prints nvcc's register
  reports, then runs the dev-probe phase of ``chip_smoke.py``
  (``smoke_lib.dev_probes``): each module's ``main`` on the card, which
  holds each kernel against its plain version and times both, and the
  bounds; one JSON line of the times, with P2's SASS instructions an
  element in each kernel of TREE's build (``smoke_lib.trig_sass`` of
  this checkout, so a parent's build is counted the same way).
- ``trig``: builds each variant of TREE's ``csrc/probe_trig.cu`` in
  ``TRIG_VARIANTS`` (text replaced in the source, one nvcc each, started
  together) and prints each one's registers and SASS instructions an
  element; at both of P2's sizes holds each variant byte for byte with
  the source's check-only kernel and times it (CUDA-event medians of 21,
  the variants in order and then in reverse); one JSON line.
- ``k1``: what ``chip_smoke.py``'s phases 2 and 3 do for K1
  (``smoke_lib.build_kernels`` and ``smoke_lib.k1_checks``): every kernel
  source built together, then K1 against its plain version on the main
  path's primary rays and on 2^20 random rays, with the failure
  diagnostics; run it in fresh processes to look for a fault of K1's
  first launches.
- ``forms``: builds TREE's fused kernel and prints one JSON line of each
  K4 form's registers and spill-store bytes (nvcc -Xptxas -v), to set a
  ``*_FORMS_BEFORE`` table of ``smoke_lib`` from a parent's build on
  the same card.
- ``sass``: builds TREE's fused kernel and prints one JSON line of each
  K4 form's SASS (``cuobjdump -sass``): its instruction count and the
  SHA-256 of its listing, so that two trees' forms can be shown to
  compile to the same code.
- ``walks``: the wavefront's K1 and K2 as it launches them: on a TREE
  whose K1 and K2 walk trees (the walks), else a parent's dense kernels.
  Builds both and prints nvcc's reports (with the walks, each walk's
  registers); K1 on the forced wavefront of final-one-weekend (1200x675)
  and stress-16k (1024x576), one batch's bounces kept: its time on the
  first bounce and summed over the batch (CUDA events), and with the
  walks its dense entry point's time and the two bit for bit on every
  bounce; the uncut ``stress_scenes.sphere_stress_doc(6)`` (17,428
  spheres, past the fused gate) compiled (seconds) and rendered on
  defaults: the wavefront, K1 launched, Mrays/s over batches 1-2; K2 on
  tri-stress-15360's forced wavefront, its 9,437,184 primary rays (with
  the walks: its dense entry point, bit for bit) and one batch (seconds,
  Mrays/s, launches); with the walks, K1 without a tree against its walk
  over 8 to 256 small spheres past a ground sphere, on 2^21 rays (where
  the walk starts to pay, ops/sphere_sweep.SPHERE_FLAT_MAX); ends with
  one JSON line.  TREE = the parent's ``git archive`` gives the before
  of the same card.
- ``hwalks``: the wavefront's H1 and H2 as it launches them.  Builds both
  and prints each kernel's registers and spills.  H1 on final-one-weekend
  --mesh-geometry at 1200x675 with ``use_bvh=True``, on the SAH tree and
  on the implicit tree (``build_bvh`` at the Renderer's leaf size): one
  batch's bounces kept, H1 timed on each bounce's rays (CUDA-event
  medians of 3; the primary rays' of 5), its work a ray on every bounce
  (TREE's ``bvh.visit_counts`` against H1's own hits, on 2^17 of the
  rays), H1 bit for bit with TREE's plain walk on 2^17 primary rays; with
  four-wide nodes also the collapse's host seconds.  H2 on fow-ellipsoids
  (1200x675): timed on each bounce's rays of one batch, bit for bit with
  the dense plain sweep on every bounce; with the tree walk also the
  dense entry point's times, the tree's build (CUDA events) and the
  walk's work a ray on bounces 0 and 1.  The timing and the work are
  smoke_lib's, as chip_smoke.py takes them.  One JSON line.  TREE = the
  parent's ``git archive`` gives the before of the same card.
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
    """Median device ms of ``fn`` (smoke_lib.median_ms, as chip_smoke.py
    times): a ~2 ms spin kernel goes before each start event, so the
    host's work inside ``fn`` does not count."""
    from raytrace_tpu_torch.tools import smoke_lib

    return smoke_lib.median_ms(fn, n)


def _scene(path, w, h, depth=None, batches=None):
    from raytrace_tpu_torch import cli

    cs = cli.load_scene(path, w, h)
    return dataclasses.replace(cs, render=dataclasses.replace(
        cs.render, max_ray_depth=depth or cs.render.max_ray_depth,
        sample_batches=batches or cs.render.sample_batches))


def _doc_scene(doc, w, depth=None, batches=None):
    """A scene doc compiled at width ``w``, its depth and batch count
    replaced where given."""
    from raytrace_tpu_torch.models import compile_scene
    from raytrace_tpu_torch.scene_file import SceneFile

    cs = compile_scene(SceneFile.from_json_dict(doc), width=w)
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


def _tri_stress(k, width, depth=None, batches=None):
    """The triangle stress scene at ``width`` (its files written to a
    temporary directory)."""
    import tempfile

    from raytrace_tpu_torch.tools import stress_scenes

    return _scene(stress_scenes.write_tri_stress(tempfile.mkdtemp(), k),
                  width, None, depth, batches)


def _batch_ms(r, reps):
    """K4's median device ms (_med) for batch 0 of Renderer ``r``."""
    from raytrace_tpu_torch.ops import megakernel

    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    return _med(lambda: megakernel.render_tile_mega(*args, **kw), reps)


def tris() -> None:
    import concurrent.futures
    import tempfile

    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.models import compile_scene
    from raytrace_tpu_torch.ops import (_build, megakernel, sphere_sweep,
                                        tri_sweep)
    from raytrace_tpu_torch.scene_file import SceneFile
    from raytrace_tpu_torch.tools import light_scenes, stress_scenes

    lib = _change_smoke_lib()
    card = _card()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    mods = (megakernel, tri_sweep, sphere_sweep)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: m.library(), mods))
    out = {"card": card, "build_s": time.perf_counter() - t0}
    forms = lib.ptxas_forms(_build.library_path("megakernel").with_suffix(
        ".log").read_text())
    out["forms"] = {f: [regs, spill] for f, regs, spill in forms}
    print("K4 forms (registers, spill bytes):", out["forms"])
    dev = torch.device("cuda:0")

    # Each triangle scene small, bit for bit with the plain version.
    fixture = compile_scene(SceneFile.from_json_dict(
        stress_scenes.triangle_fixture_doc()), width=96)
    out["bitwise"] = {}
    for label, cs in (("k1", _tri_stress(1, 96, 8, 2)),
                      ("k4", _tri_stress(4, 96, 8, 2)),
                      ("fixture", dataclasses.replace(
                          fixture, render=dataclasses.replace(
                              fixture.render, max_ray_depth=8,
                              sample_batches=2))),
                      ("cornell-style", _doc_scene(
                          light_scenes.cornell_doc(), 128, 50, 2)),
                      ("sphere-light-962", _doc_scene(
                          light_scenes.sphere_light_doc(), 128, 50, 2))):
        r = Renderer(cs, device=dev)
        args = (r.static, r.scene, r._geometry(0), r.camera, 0, 2)
        kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
        s1, t1 = megakernel.render_tile_mega(*args, **kw)
        s2, t2 = megakernel.render_tile_mega(*args, **kw)
        ref, rt = megakernel.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        ok = (torch.equal(s1, s2) and torch.equal(t1, t2)
              and torch.equal(s1, ref) and torch.equal(t1, rt))
        out["bitwise"][label] = ok
        print(label, r.path, "bit for bit, repeat identical", ok, "rays",
              int(t1.sum()), int(rt.sum()))

    # The full batches: tri-stress-15360, cornell-style, sphere-light-962.
    full = Renderer(_tri_stress(4, 1024), device=dev)
    print("tri-stress-15360", full.path, full.static.num_triangles,
          full.static.tri_cluster_g)
    out["tris_ms"] = _batch_ms(full, 5)
    light_dir = tempfile.mkdtemp()
    lights = dict(zip(light_scenes.DOCS,
                      light_scenes.write_light_scenes(light_dir)))
    for name, path in lights.items():
        r = Renderer(cli.load_scene(path), device=dev)
        out[f"{name}_ms"] = _batch_ms(r, 3)
        geom = r._geometry(0)
        out[f"{name}_tree"] = (
            None if getattr(geom, "tri_tree", None) is None else
            [geom.tri_tree.depth, geom.tri_tree.leaf])
    print("K4 ms a batch: tri-stress", out["tris_ms"], "cornell-style",
          out["cornell-style_ms"], "sphere-light-962",
          out["sphere-light-962_ms"])

    # With a soup tree: K4 at other leaf sizes on the same batches, and on
    # small soups at leaves of LEAF and at one leaf holding the whole soup
    # (the flat sweep): cornell-style, the triangle fixture at 1024 wide,
    # and tri-stress k = 1 with coarser uv spheres (48 to 960 triangles).
    tree = getattr(full._geometry(0), "tri_tree", None)
    if tree is not None and tree.ids is not None:
        from raytrace_tpu_torch.ops import paged_tri

        def leaf_ms(r, leaf):
            g = r._geometry(0)
            t = paged_tri.build_soup_tree(
                g.world_p, r.static.num_triangles, g.tri_table12,
                g.tri_tree.ids, leaf)
            if t.depth > megakernel.MAX_TRI_DEPTH:
                return None
            args = (r.static, r.scene, g._replace(tri_tree=t), r.camera, 0,
                    1)
            return _med(lambda: megakernel.render_tile_mega(
                *args, use_dof=r.use_dof), 3)

        out["leaf_ms"] = {}
        small = [("cornell-style", Renderer(cli.load_scene(
            lights["cornell-style"]), device=dev)),
                 ("fixture", Renderer(compile_scene(SceneFile.from_json_dict(
                     stress_scenes.triangle_fixture_doc()), width=1024),
                     device=dev))]
        for rings, segments in ((4, 8), (6, 12), (8, 16), (12, 24),
                                (16, 32)):
            obj = stress_scenes.write_sphere_obj(
                tempfile.mkdtemp() + "/sphere.obj", rings, segments)
            doc = stress_scenes.tri_stress_doc(1, obj)
            small.append((f"uv {rings}x{segments}", Renderer(compile_scene(
                SceneFile.from_json_dict(doc), width=1024), device=dev)))
        for name, r in [("tri-stress", full)] + small:
            n = r.static.num_triangles
            for leaf in sorted({2, 4, 8, 16, n} if name != "tri-stress"
                               else {2, 4, 8, 16}):
                ms = leaf_ms(r, leaf)
                if ms is not None:
                    out["leaf_ms"][f"{name} n={n} L={leaf}"] = ms
        print("K4 ms by leaf size", out["leaf_ms"])

    # tri-stress's main path: its one batch through Renderer with defaults.
    before = megakernel.TRI_LAUNCHES
    full.render_all()
    out["tris_mrays"] = full.stats.mrays_per_sec
    print("tri-stress main path", full.path, "Mrays/s",
          full.stats.mrays_per_sec, "K4 tris launches",
          megakernel.TRI_LAUNCHES - before)
    print(json.dumps(out))


def _busy(lib, label, r, args, kw, megakernel, out):
    """K4's lanes busy on Renderer ``r``'s batch: the two warp models of
    this checkout's smoke_lib (``lib``) over the wavefront's path lengths
    of the batch, and, where TREE's kernel has a measuring build, its own
    count and phase cycles (lib.measure_busy: its sums byte-identical to
    the normal build's).  Into ``out[label]``."""
    from raytrace_tpu_torch.engine import wavefront

    w = r.static
    geom = r._geometry(0)
    trace = wavefront.make_trace_fn(w, r.scene, geom)
    _, _, lengths = lib.wave_lengths(w, r.scene, r.camera, trace, geom,
                                     r.use_dof, r.rows_per_tile)
    res = {"per_sample": lib.warp_tail(lengths)[0],
           "regen": lib.warp_regen(lengths)[0]}
    if hasattr(megakernel, "measure_tile_mega"):
        res["measured"] = lib.measure_busy(args, kw)
    out[label] = res
    print(label, "lanes busy", res)


def lights() -> None:
    import concurrent.futures

    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import (_build, megakernel, sphere_sweep,
                                        tri_sweep)
    from raytrace_tpu_torch.tools import light_scenes as ls

    lib = _change_smoke_lib()
    card = _card()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    mods = [megakernel.library, tri_sweep.library, sphere_sweep.library]
    if hasattr(megakernel, "measure_library"):
        mods.append(megakernel.measure_library)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda load: load(), mods))
    print(_build.library_path("megakernel").with_suffix(".log").read_text())
    dev = torch.device("cuda:0")
    out = {"card": card, "bitwise": {}, "ms": {}, "busy": {}}

    for label, doc, w in (("cornell-style", ls.cornell_doc(), 128),
                          ("sphere-light-962", ls.sphere_light_doc(), 128),
                          ("lit spheres", ls.lit_spheres_doc(), 96),
                          ("70 instances", ls.many_instances_doc(70), 96)):
        r = Renderer(_doc_scene(doc, w, 50, 2), device=dev)
        args = (r.static, r.scene, r._geometry(0), r.camera, 0, 2)
        kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
        s1, t1 = megakernel.render_tile_mega(*args, **kw)
        s2, t2 = megakernel.render_tile_mega(*args, **kw)
        t0 = time.perf_counter()
        ref, rt = megakernel.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        ok = (torch.equal(s1, s2) and torch.equal(t1, t2)
              and torch.equal(s1, ref) and torch.equal(t1, rt))
        out["bitwise"][label] = ok
        print(label, r.path, r.static.width, r.static.height,
              "bit for bit, repeat identical", ok,
              "maxdiff", (s1 - ref).abs().max().item(), "rays",
              int(t1.sum()), int(rt.sum()), "plain s",
              time.perf_counter() - t0, "LIGHT_LAUNCHES",
              megakernel.LIGHT_LAUNCHES)

    for label, doc in (("cornell-style", ls.cornell_doc()),
                       ("sphere-light-962", ls.sphere_light_doc())):
        r = Renderer(_doc_scene(doc, 1024), device=dev)
        args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
        kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
        sums, traced = megakernel.render_tile_mega(*args, **kw)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        ref, rt = megakernel.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        out["bitwise"][label + " full"] = (torch.equal(sums, ref)
                                           and torch.equal(traced, rt))
        out["ms"][label] = _med(
            lambda: megakernel.render_tile_mega(*args, **kw), 5)
        print(label, "full batch", r.static.width, r.static.height, "rays",
              int(traced.sum()), "kernel ms", out["ms"][label],
              "bit for bit", out["bitwise"][label + " full"], "plain s",
              plain_s, "plain peak GiB",
              torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        del sums, traced, ref, rt
        _busy(lib, label, r, args, kw, megakernel, out["busy"])
    r = Renderer(_scene(cli.DEFAULT_SCENE, 1200, 675), device=dev)
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    out["ms"]["final-one-weekend"] = _med(
        lambda: megakernel.render_tile_mega(*args, **kw), 5)
    _busy(lib, "final-one-weekend", r, args, kw, megakernel, out["busy"])

    r = Renderer(_doc_scene(ls.cornell_doc(), 1024), device=dev)
    before = (megakernel.LIGHT_LAUNCHES, sphere_sweep.LAUNCHES,
              tri_sweep.LAUNCHES)
    for _ in range(2):
        r.render_next_batch()
    out["cornell-style_mrays"] = r.stats.mrays_per_sec
    print("cornell-style main path", r.path, "Mrays/s",
          r.stats.mrays_per_sec, "rays", r.stats.rays_traced, "launches",
          megakernel.LIGHT_LAUNCHES - before[0],
          sphere_sweep.LAUNCHES - before[1], tri_sweep.LAUNCHES - before[2],
          "means", r.image().mean((0, 1)))
    print(json.dumps(out))


def _form_name(r) -> str:
    """The name (smoke_lib.K4_FORMS) of the K4 form Renderer ``r``'s first
    batch launches."""
    st = r.static
    name = ("anim" if r.path == "fused_anim" else "+".join(
        f for f, on in (("tris", st.has_tris), ("lights", st.has_lights))
        if on) or "static")
    return (name + ("+noise" if st.flags.has_noise else "")
            + ("+image" if st.flags.has_image else "")
            + ("+clusters" if r._geometry(0).sph_tree is not None else ""))


def _static(r, dense):
    """Renderer ``r``'s static scene, with its cluster layout dropped (the
    dense form) when ``dense``."""
    return dataclasses.replace(r.static, sph_prefix=0) if dense else r.static


def _form_occupancy(r, dense):
    """(resident blocks a multiprocessor, dynamic shared memory bytes) of
    the form Renderer ``r`` launches (the dense one when ``dense``); a
    clustered form's tree rebuilt at leaves of one, so that it stages what
    it would on a big tree (STAGE_BYTES of node rows)."""
    from raytrace_tpu_torch.ops import megakernel, sphere_tree

    geom = r._geometry(0)
    tree = geom.sph_tree
    if tree is not None and not dense:
        geom = geom._replace(sph_tree=sphere_tree.build_sphere_tree(
            geom.sph_table8, tree.n_prefix, r.static.num_spheres, tree.ids,
            dtab8=geom.sph_dtab8, leaf=1))
    return megakernel.occupancy(_static(r, dense), r.scene, geom, r.camera,
                                use_dof=r.use_dof, times=r.batch_times_dev)


def _held(r, k, label, out, dense=False):
    """K4 against its plain version on batches 0..k-1 of Renderer ``r``
    (its dense form when ``dense``): bit for bit and two launches
    byte-identical, into ``out[label]``."""
    import torch

    from raytrace_tpu_torch.ops import megakernel

    args = (_static(r, dense), r.scene, r._geometry(0), r.camera, 0, k)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    before = megakernel.NOISE_LAUNCHES
    s1, t1 = megakernel.render_tile_mega(*args, **kw)
    s2, t2 = megakernel.render_tile_mega(*args, **kw)
    t0 = time.perf_counter()
    ref, rt = megakernel.megakernel_reference(*args, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    ok = (torch.equal(s1, s2) and torch.equal(t1, t2)
          and torch.equal(s1, ref) and torch.equal(t1, rt))
    out[label] = ok
    print(label, r.path, r.static.width, r.static.height, "depth",
          r.static.max_ray_depth, "bit for bit, repeat identical", ok,
          "maxdiff", (s1 - ref).abs().max().item(), "rays", int(t1.sum()),
          int(rt.sum()), "NOISE_LAUNCHES +",
          megakernel.NOISE_LAUNCHES - before, "plain s", plain_s)
    return args, kw, plain_s


def noise() -> None:
    import concurrent.futures
    import tempfile

    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import _build, megakernel, sphere_sweep
    from raytrace_tpu_torch.tools import image_scenes as ims
    from raytrace_tpu_torch.tools import light_scenes as ls
    from raytrace_tpu_torch.tools import noise_scenes as ns

    lib = _change_smoke_lib()
    card = _card()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    mods = [megakernel.library]
    if hasattr(megakernel, "measure_library"):
        mods.append(megakernel.measure_library)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda load: load(), mods))
    log = _build.library_path("megakernel").with_suffix(".log").read_text()
    print(log)
    dev = torch.device("cuda:0")
    out = {"card": card, "build_s": time.perf_counter() - t0,
           "forms": {f: [regs, spill]
                     for f, regs, spill in lib.ptxas_forms(log)},
           "bitwise": {}, "occupancy": {}, "ms": {}, "plain_s": {},
           "measured": {}}

    with open(Path(cli.DEFAULT_SCENE).with_name(MB_SCENE)) as f:
        mb_doc = json.load(f)
    png = ims.texel_id_png(str(Path(tempfile.mkdtemp()) / "small.png"),
                           640, 320)
    for form, (doc, w, depth) in lib.noise_form_docs(mb_doc, png).items():
        frames = [("small", w, depth, 2)] + [
            (f"{lib.PARTIAL_WARP_WIDTH} wide depth {d}",
             lib.PARTIAL_WARP_WIDTH, d, 1) for d in lib.PARTIAL_WARP_DEPTHS]
        for label, width, d, k in frames:
            r = Renderer(_doc_scene(doc, width, d, k), device=dev)
            # A doc in clusters holds a dense form with its layout dropped.
            dense = _form_name(r) == form + "+clusters"
            if _form_name(r) != form and not dense:
                raise AssertionError(f"{form}: the doc takes {_form_name(r)}")
            _held(r, k, f"{form} {label}", out["bitwise"], dense)
        out["occupancy"][form] = _form_occupancy(r, dense)
        print(form, "blocks a multiprocessor, shared memory bytes",
              out["occupancy"][form])

    # The two full batches of the noise forms' default paths, and through
    # the measuring build.
    for label, doc in (("perlin-spheres", ns.perlin_spheres_doc()),
                       ("sphere-light-962", ls.sphere_light_doc())):
        r = Renderer(_doc_scene(doc, 1024), device=dev)
        args, kw, out["plain_s"][label] = _held(r, 1, label + " full",
                                                out["bitwise"])
        out["ms"][label] = _med(
            lambda: megakernel.render_tile_mega(*args, **kw), 5)
        print(label, "full batch kernel ms", out["ms"][label], card)
        if hasattr(megakernel, "measure_tile_mega"):
            out["measured"][label] = lib.measure_busy(args, kw)
            print(label, "measuring build", out["measured"][label])

    # Batches of forms without noise, to hold them to the parent's.
    fow = Renderer(_scene(cli.DEFAULT_SCENE, 1200, 675), device=dev)
    tmp = tempfile.mkdtemp()
    earth_json, _ = ims.write_earth_scenes(tmp)
    for label, r in (
            ("final-one-weekend", fow),
            ("cornell-style", Renderer(_doc_scene(ls.cornell_doc(), 1024),
                                       device=dev)),
            ("tri-stress-15360", Renderer(_tri_stress(4, 1024), device=dev)),
            ("earth", Renderer(cli.load_scene(earth_json, ims.EARTH_WIDTH),
                               device=dev))):
        out["ms"][label] = _batch_ms(r, 5)
        print(label, _form_name(r), "batch kernel ms", out["ms"][label])

    before = (megakernel.NOISE_LAUNCHES, sphere_sweep.LAUNCHES)
    r = Renderer(_doc_scene(ns.perlin_spheres_doc(), 1024), device=dev)
    r.render_next_batch()
    out["perlin_mrays_stepped"] = r.stats.mrays_per_sec
    print("perlin-spheres main path", r.path, "Mrays/s", r.stats.mrays_per_sec,
          "rays", r.stats.rays_traced, "NOISE_LAUNCHES +",
          megakernel.NOISE_LAUNCHES - before[0], "K1 +",
          sphere_sweep.LAUNCHES - before[1], "means", r.image().mean((0, 1)))
    print(json.dumps(out))


def image() -> None:
    import concurrent.futures
    import tempfile

    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import _build, megakernel, sphere_sweep
    from raytrace_tpu_torch.tools import image_scenes as ims
    from raytrace_tpu_torch.tools import stress_scenes

    lib = _change_smoke_lib()
    card = _card()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda load: load(), (megakernel.library,
                                            megakernel.measure_library)))
    log = _build.library_path("megakernel").with_suffix(".log").read_text()
    print(log)
    dev = torch.device("cuda:0")
    out = {"card": card, "build_s": time.perf_counter() - t0,
           "forms": {f: [regs, spill]
                     for f, regs, spill in lib.ptxas_forms(log)
                     if "+image" in f},
           "bitwise": {}, "occupancy": {}, "ms": {}, "plain_s": {}}
    tmp = tempfile.mkdtemp()
    png = ims.texel_id_png(str(Path(tmp) / "small.png"), 640, 320)
    docs = {f + "+image": v for f, v in ims.form_checks(png).items()}
    docs.update({f + "+clusters": v for f, v in
                 stress_scenes.cluster_form_checks(png).items()
                 if "image" in f})
    for form, (doc, w, depth) in docs.items():
        r = Renderer(_doc_scene(doc, w, depth, 2), device=dev)
        if _form_name(r) != form:
            raise AssertionError(f"{form}: the doc takes {_form_name(r)}")
        _held(r, 2, f"{form} small", out["bitwise"])
        out["occupancy"][form] = _form_occupancy(r, False)
        print(form, "blocks a multiprocessor, shared memory bytes",
              out["occupancy"][form])

    # earth: its full batch and render_all's two chunks (12 and 4
    # batches), held to the plain version and timed; its batch through the
    # measuring build; earth-motion-blur's per-batch launch.
    earth_json, mb_json = ims.write_earth_scenes(tmp)
    r = Renderer(cli.load_scene(earth_json, ims.EARTH_WIDTH), device=dev)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    geom = r._geometry(0)
    for label, b0, k in (("batch", 0, 1), ("chunk12", 0, 12),
                         ("chunk4", 12, 4)):
        args = (r.static, r.scene, geom, r.camera, b0, k)
        s1, t1 = megakernel.render_tile_mega(*args, **kw)
        s2, t2 = megakernel.render_tile_mega(*args, **kw)
        t0 = time.perf_counter()
        ref, rt = megakernel.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        out["plain_s"][label] = time.perf_counter() - t0
        out["bitwise"][f"earth {label}"] = (
            torch.equal(s1, s2) and torch.equal(t1, t2)
            and torch.equal(s1, ref) and torch.equal(t1, rt))
        out["ms"][f"earth {label}"] = _med(
            lambda: megakernel.render_tile_mega(*args, **kw),
            21 if k == 1 else 9)
        print("earth", label, "batches", b0, "+", k, "rays", int(t1.sum()),
              "kernel ms", out["ms"][f"earth {label}"], "bit for bit, "
              "repeat identical", out["bitwise"][f"earth {label}"],
              "plain s", out["plain_s"][label], card)
        del s1, s2, t1, t2, ref, rt
    args = (r.static, r.scene, geom, r.camera, 0, 1)
    out["measured"] = lib.measure_busy(args, kw)
    print("earth measuring build", out["measured"])
    out["occupancy"]["earth"] = megakernel.occupancy(
        r.static, r.scene, geom, r.camera, use_dof=r.use_dof,
        times=r.batch_times_dev)
    mb = Renderer(cli.load_scene(mb_json, ims.EARTH_WIDTH), device=dev)
    if mb.path != "fused_per_batch":
        raise AssertionError(f"earth-motion-blur takes {mb.path}")
    mb_args = (mb.static, mb.scene, mb._geometry(0), mb.camera, 0, 1)
    mb_kw = dict(use_dof=mb.use_dof, times=mb.batch_times_dev)
    s1, t1 = megakernel.render_tile_mega(*mb_args, **mb_kw)
    ref, rt = megakernel.megakernel_reference(*mb_args, **mb_kw)
    out["bitwise"]["earth-motion-blur batch"] = (torch.equal(s1, ref)
                                                 and torch.equal(t1, rt))
    out["ms"]["earth-motion-blur batch"] = _med(
        lambda: megakernel.render_tile_mega(*mb_args, **mb_kw), 21)
    print("earth-motion-blur batch kernel ms",
          out["ms"]["earth-motion-blur batch"], "bit for bit",
          out["bitwise"]["earth-motion-blur batch"])

    before = (megakernel.IMAGE_LAUNCHES, sphere_sweep.LAUNCHES)
    r = Renderer(cli.load_scene(earth_json, ims.EARTH_WIDTH), device=dev)
    r.render_next_batch()
    out["earth_mrays_stepped"] = r.stats.mrays_per_sec
    print("earth main path", r.path, "Mrays/s", r.stats.mrays_per_sec,
          "rays", r.stats.rays_traced, "IMAGE_LAUNCHES +",
          megakernel.IMAGE_LAUNCHES - before[0], "K1 +",
          sphere_sweep.LAUNCHES - before[1], "means", r.image().mean((0, 1)))
    print(json.dumps(out))


def _cluster_times(args, kw, dense):
    """Kernel medians (ms, 5 launches each) of the clustered form, and of
    the dense form (the cluster layout dropped) when ``dense``."""
    from raytrace_tpu_torch.ops import megakernel

    out = {"clusters": _med(
        lambda: megakernel.render_tile_mega(*args, **kw), 5)}
    if dense:
        flat = (dataclasses.replace(args[0], sph_prefix=0),) + args[1:]
        out["dense"] = _med(lambda: megakernel.render_tile_mega(*flat, **kw),
                            5)
    return out


# The sphere tree's leaf sizes and shared-memory caps swept on the card
# (bytes of node rows a block stages; ops/sphere_tree.stage_nodes).
SPHERE_LEAVES = (1, 2, 4, 8)
STAGE_CAPS = (0, 8192, 16384, 24576, 32768)


def _event_ms(fn, reps=5):
    """Median CUDA-event ms of ``fn`` (its host work included: a tree
    build is host-issued work on the card), after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _tree_sweep(r, args, kw):
    """K4's median ms (5 launches) on ``args``'s batch with the Renderer's
    sphere tree rebuilt at each leaf size of SPHERE_LEAVES and each cap of
    STAGE_CAPS, and the tree's build ms on the card (CUDA events, median
    of 5) at the Renderer's leaf."""
    from raytrace_tpu_torch.ops import megakernel, sphere_tree

    geom = args[2]
    tree = geom.sph_tree
    n = r.static.num_spheres

    def build(leaf, cap=sphere_tree.STAGE_BYTES):
        return sphere_tree.build_sphere_tree(
            geom.sph_table8, tree.n_prefix, n, tree.ids,
            dtab8=geom.sph_dtab8, leaf=leaf, stage_bytes=cap)

    out = {"leaf": tree.leaf, "staged": tree.staged,
           "build_ms": _event_ms(lambda: build(tree.leaf)), "ms": {}}
    for leaf in SPHERE_LEAVES:
        for cap in STAGE_CAPS:
            t = build(leaf, cap)
            if t.depth > sphere_tree.MAX_SPHERE_DEPTH:
                continue
            a = args[:2] + (geom._replace(sph_tree=t),) + args[3:]
            out["ms"][f"L={leaf} cap={cap} staged={t.staged}"] = _med(
                lambda: megakernel.render_tile_mega(*a, **kw), 5)
    return out


def _occupancy(forms_docs, dev):
    """Each clustered form's resident blocks a multiprocessor
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at each cap of
    STAGE_CAPS, on its small doc's tree rebuilt at leaves of one (at
    least 511 nodes, so each cap stages what it would on a big tree)."""
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import megakernel, sphere_tree

    out = {}
    for form, (doc, w, depth) in forms_docs.items():
        r = Renderer(_doc_scene(doc, w, depth, 2), device=dev)
        geom = r._geometry(0)
        tree = geom.sph_tree
        deep = sphere_tree.build_sphere_tree(
            geom.sph_table8, tree.n_prefix, r.static.num_spheres, tree.ids,
            dtab8=geom.sph_dtab8, leaf=1)
        out[form] = {}
        for cap in STAGE_CAPS:
            t = deep._replace(staged=sphere_tree.stage_nodes(
                deep.nodes.shape[0], cap))
            blocks, smem = megakernel.occupancy(
                r.static, r.scene, geom._replace(sph_tree=t), r.camera,
                use_dof=r.use_dof, times=r.batch_times_dev)
            out[form][cap] = [blocks, smem]
    return out


def spheres() -> None:
    import tempfile

    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import _build, megakernel, paged_tri
    from raytrace_tpu_torch.ops import sphere_sweep
    from raytrace_tpu_torch.tools import image_scenes as ims
    from raytrace_tpu_torch.tools import stress_scenes

    lib = _change_smoke_lib()
    card = _card()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    megakernel.library()
    print("build", time.perf_counter() - t0)
    log = _build.library_path("megakernel").with_suffix(".log").read_text()
    dev = torch.device("cuda:0")
    tree_side = hasattr(megakernel, "occupancy")   # a checkout with the tree
    out = {"card": card, "tree": tree_side, "small_ms": {}, "ms": {},
           "forms": {f: [regs, spill] for f, regs, spill
                     in lib.ptxas_forms(log)}}
    print("K4 forms (registers, spill bytes):", out["forms"])
    tmp = tempfile.mkdtemp()
    png = ims.texel_id_png(str(Path(tmp) / "small.png"), 640, 320)
    docs = stress_scenes.cluster_form_checks(png)
    if tree_side:
        out["occupancy"] = _occupancy(docs, dev)
        print("clustered forms' blocks a multiprocessor, shared memory "
              "bytes, by cap:", out["occupancy"])
    for form, (doc, w, depth) in docs.items():
        r = Renderer(_doc_scene(doc, w, depth, 2), device=dev)
        args = (r.static, r.scene, r._geometry(0), r.camera, 0, 2)
        kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
        before = megakernel.SPHERE_CLUSTER_LAUNCHES
        s1, t1 = megakernel.render_tile_mega(*args, **kw)
        s2, t2 = megakernel.render_tile_mega(*args, **kw)
        ref, rt = megakernel.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        print(form, r.path, r.static.width, r.static.height, "depth", depth,
              "repeat identical", torch.equal(s1, s2) and torch.equal(t1, t2),
              "bitwise", torch.equal(s1, ref), torch.equal(t1, rt),
              "maxdiff", (s1 - ref).abs().max().item(), "rays",
              int(t1.sum()), int(rt.sum()), "SPHERE_CLUSTER_LAUNCHES +",
              megakernel.SPHERE_CLUSTER_LAUNCHES - before)
        out["small_ms"][form] = _cluster_times(args, kw, True)

    stress = stress_scenes.write_sphere_stress(tmp)
    mb = str(Path(cli.DEFAULT_SCENE).with_name(MB_SCENE))
    full = [("final-one-weekend", lambda: _scene(cli.DEFAULT_SCENE, 1200,
                                                 675), True),
            ("motion-blur", lambda: _scene(mb, 1024, 576), True),
            ("stress-4x", lambda: cli.load_scene(stress["stress-4x"]),
             True)]
    out["sweep"] = {}
    for label, make, dense in full:
        t0 = time.perf_counter()
        cs = make()
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = Renderer(cs, device=dev)
        init_s = time.perf_counter() - t0
        args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
        kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
        s1, t1 = megakernel.render_tile_mega(*args, **kw)
        t0 = time.perf_counter()
        ref, rt = megakernel.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        out["ms"][label] = _cluster_times(args, kw, dense)
        print(label, r.path, r.static.width, r.static.height,
              r.static.num_spheres,
              megakernel.sphere_cluster_layout(r.static), "compile s",
              compile_s, "Renderer s", init_s, "bitwise",
              torch.equal(s1, ref), torch.equal(t1, rt), "rays",
              int(t1.sum()), "plain s", plain_s, "ms", out["ms"][label])
        if tree_side:
            out["sweep"][label] = _tree_sweep(r, args, kw)
            print(label, "tree sweep", out["sweep"][label])
        if label == "final-one-weekend":
            out["fow_measured"] = lib.measure_busy(args, kw)
            print(label, "measuring build", out["fow_measured"])
        del r, args, kw, s1, t1, ref, rt

    t0 = time.perf_counter()
    cs16 = cli.load_scene(stress["stress-16k"])
    compile_s = time.perf_counter() - t0
    small = dataclasses.replace(cs16, render=dataclasses.replace(
        cs16.render, width=128, height=72))
    r = Renderer(small, device=dev)
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    s1, t1 = megakernel.render_tile_mega(*args, **kw)
    s2, t2 = megakernel.render_tile_mega(*args, **kw)
    t0 = time.perf_counter()
    ref, rt = megakernel.megakernel_reference(*args, **kw)
    torch.cuda.synchronize()
    print("stress-16k 128x72 depth 50", r.path, r.static.num_spheres,
          megakernel.sphere_cluster_layout(r.static), "compile s", compile_s,
          "repeat identical", torch.equal(s1, s2) and torch.equal(t1, t2),
          "bitwise", torch.equal(s1, ref), torch.equal(t1, rt), "rays",
          int(t1.sum()), "plain s", time.perf_counter() - t0)
    t0 = time.perf_counter()
    r = Renderer(cs16, device=dev)
    init_s = time.perf_counter() - t0
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    fused = (sums / 4).cpu().numpy()
    w = Renderer(cs16, device=dev, use_megakernel=False)
    t0 = time.perf_counter()
    w.render_next_batch()
    print("stress-16k full batch", r.path, "Renderer s", init_s, "rays",
          int(traced.sum()), w.stats.rays_traced, "channel-mean diff",
          abs(fused.mean((0, 1)) - w.image().mean((0, 1))).max(),
          "wavefront s", time.perf_counter() - t0, "ms",
          _cluster_times(args, kw, False))
    out["ms"]["stress-16k"] = _cluster_times(args, kw, False)
    if tree_side:
        out["sweep"]["stress-16k"] = _tree_sweep(r, args, kw)
        print("stress-16k tree sweep", out["sweep"]["stress-16k"])
    del r, w, args, kw, sums, traced
    for name in stress_scenes.SPHERE_STRESS:
        before = (megakernel.SPHERE_CLUSTER_LAUNCHES, sphere_sweep.LAUNCHES)
        r = Renderer(cs16 if name == "stress-16k"
                     else cli.load_scene(stress[name]), device=dev)
        r.render_next_batch()
        r.render_next_batch()
        print(name, "main path", r.path, "Mrays/s", r.stats.mrays_per_sec,
              "SPHERE_CLUSTER_LAUNCHES +",
              megakernel.SPHERE_CLUSTER_LAUNCHES - before[0], "K1 +",
              sphere_sweep.LAUNCHES - before[1], "means",
              r.image().mean((0, 1)), "peak GiB",
              torch.cuda.max_memory_allocated(dev) / 2 ** 30)

    # final-one-weekend's main path: four stepped batches, then two
    # 12-batch chunks (the second timed), as chip_smoke.py phase 6 steps.
    r = Renderer(_scene(cli.DEFAULT_SCENE, 1200, 675), device=dev)
    for _ in range(4):
        r.render_next_batch()
    out["fow_stepped_mrays"] = r.stats.mrays_per_sec
    out["fow_chunk_mrays"] = _chunk_mrays(r)
    print("final-one-weekend main path", r.path, "stepped Mrays/s",
          out["fow_stepped_mrays"], "chunk Mrays/s", out["fow_chunk_mrays"])

    # The soup tree's build on the card (tri-stress-15360), CUDA events.
    tri = Renderer(_tri_stress(4, 1024), device=dev)
    g = tri._geometry(0)
    out["soup_tree_build_ms"] = _event_ms(lambda: paged_tri.build_soup_tree(
        g.world_p, tri.static.num_triangles, g.tri_table12, g.tri_tree.ids))
    print("tri-stress soup tree build ms", out["soup_tree_build_ms"])
    print(json.dumps(out))


def _change_smoke_lib():
    """This checkout's tools/smoke_lib.py, loaded from beside this file
    whatever TREE is: its K3 helpers run on a parent's package too."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "change_smoke_lib", Path(__file__).with_name("smoke_lib.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k2_dense(tri_sweep):
    """K2's dense sweep in TREE's package: its check-only entry point
    (since K2 walks the soup's tree), or a parent's K2 itself."""
    return getattr(tri_sweep, "intersect_tris_dense",
                   tri_sweep.intersect_tris_sweep)


def _hits_equal(a, b, alive):
    """(t, id equal) and (u, v equal on the alive rays) of two hits."""
    import torch

    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2][alive], b[2][alive])
            and torch.equal(a[3][alive], b[3][alive]))


def paged() -> None:
    import numpy as np
    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import (_build, paged_tri, sphere_sweep,
                                        tri_sweep)
    from raytrace_tpu_torch.ops.vec3 import V3

    lib = _change_smoke_lib()
    tree_mode = hasattr(paged_tri, "build_tri_tree")
    card = _card()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    for m in (paged_tri, tri_sweep, sphere_sweep):
        m.library()
    print("builds s", time.perf_counter() - t0)
    print(_build.library_path("paged_tri").with_suffix(".log").read_text())
    dev = torch.device("cuda:0")
    out = {"tree": str(Path(paged_tri.__file__).parents[2]),
           "tree_mode": tree_mode, "card": card}

    # Random soups with a duplicate pair: K3 against its plain version and
    # K2, a repeat launch.
    for T, R in ((40000, 1 << 16), (3001, 1 << 14), (5, 2048)):
        rng = np.random.default_rng(T)
        tri = (rng.uniform(-5, 5, (T, 1, 3))
               + rng.uniform(-0.8, 0.8, (T, 3, 3))).astype(np.float32)
        tri[T // 2] = tri[1]
        tri = tri[paged_tri.paged_tri_order(tri, T)]
        wp = torch.tensor(tri, device=dev)
        if tree_mode:
            tables = paged_tri.build_tri_tree(wp, T)
            plain = paged_tri.tri_tree_sweep_reference
        else:
            tables = paged_tri.build_page_tables(wp, T)
            plain = paged_tri.paged_tri_sweep_reference
        o = rng.uniform(-9, 9, (R, 3))
        d = np.einsum("rv,rvi->ri", rng.dirichlet(np.ones(3), R),
                      tri[rng.integers(0, T, R)].astype(np.float64)) - o
        d[:R // 10] = rng.standard_normal((R // 10, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = (lib.rows_to_v3(a.astype(np.float32), dev) for a in (o, d))
        alive = torch.tensor(rng.random(R) < 0.7, device=dev)
        hit = paged_tri.intersect_tris_paged(o, d, tables, alive)
        again = paged_tri.intersect_tris_paged(o, d, tables, alive)
        ref = plain(o, d, tables, alive)
        k2 = _k2_dense(tri_sweep)(
            o, d, tri_sweep.pack_tri_table(wp, T), alive)
        torch.cuda.synchronize()
        print(f"random T={T} R={R}: vs plain {_hits_equal(hit, ref, alive)}"
              f", vs K2 {_hits_equal(hit, k2, alive)}, repeat "
              f"{all(torch.equal(a, b) for a, b in zip(hit, again))}, hit "
              f"share {(hit.tri >= 0).double().mean().item():.4f}")

    t0 = time.perf_counter()
    cs = cli.load_scene(cli.DEFAULT_SCENE, 1200, 675, analytic_spheres=False)
    print("mesh compile s", time.perf_counter() - t0, cs.num_triangles)
    t0 = time.perf_counter()
    r = Renderer(cs, device=dev)
    print("Renderer s", time.perf_counter() - t0, r.path, r.static.bvh_mode)
    t0 = time.perf_counter()
    geom, seen = lib.capture_bounces(r)
    tables = lib.k3_tables(geom)
    print("one batch through render_tile s", time.perf_counter() - t0,
          "bounces", len(seen), "rays", sum(int(a.sum()) for *_, a in seen))
    n = geom.world_p.shape[0]
    if tree_mode:
        build = lambda leaf=paged_tri.LEAF: paged_tri.build_tri_tree(  # noqa
            geom.world_p, r.static.num_triangles, geom.tri_table12, leaf)
        out["build_ms"] = _med(build, 3)
    else:
        build = lambda: paged_tri.build_page_tables(  # noqa: E731
            geom.world_p, r.static.num_triangles, geom.tri_table12)
        out["build_ms"] = _med(build, 3)
    print("table build ms (median of 3)", out["build_ms"], "soup", n)

    # K3 a batch: each bounce's rays, median of 3 each.
    per = lib.k3_bounce_ms(tables, seen)
    out["k3_primary_ms"], out["k3_batch_ms"] = per[0], sum(per)
    print("K3 ms per bounce", [round(x, 3) for x in per])
    print("K3 ms a batch", sum(per), "primary", per[0])

    # Bit for bit with K2 on 2^17 of bounces 0, 1, 2 and 10.
    gen = torch.Generator().manual_seed(0)
    for b in (0, 1, 2, 10):
        o, d, alive = seen[b]
        sel = torch.randperm(o.x.shape[0], generator=gen)[:1 << 17].to(dev)
        so, sd = (V3(*(x[sel].contiguous() for x in v)) for v in (o, d))
        sa = alive[sel].contiguous()
        hit = paged_tri.intersect_tris_paged(so, sd, tables, sa)
        k2 = _k2_dense(tri_sweep)(so, sd, geom.tri_table16, sa)
        torch.cuda.synchronize()
        print(f"bounce {b}: R {o.x.shape[0]}, 2^17 subset vs K2 "
              f"{_hits_equal(hit, k2, sa)}, hit share "
              f"{(hit.tri >= 0).double().mean().item():.4f}")

    # Far grazing rays at the mesh's leaf boxes (of L = 8), against K2.
    wp = geom.world_p[:r.static.num_triangles]
    boxes = (paged_tri.leaf_boxes(wp, wp.shape[0], 8) if tree_mode else None)
    if boxes is None:
        pad = torch.zeros((-(-wp.shape[0] // 8) * 8 - wp.shape[0], 3, 3),
                          device=dev)
        v = torch.cat([wp, pad]).reshape(-1, 8 * 3, 3)
        boxes = torch.cat([v.amin(1), v.amax(1)], 1)
    boxes = boxes[:-(-wp.shape[0] // 8)].cpu().numpy()
    go, gd = lib.grazing_rays(boxes, 1 << 16, 1, dev)
    ga = torch.ones(1 << 16, dtype=torch.bool, device=dev)
    hit = paged_tri.intersect_tris_paged(go, gd, tables, ga)
    k2 = _k2_dense(tri_sweep)(go, gd, geom.tri_table16, ga)
    bad = (hit.t != k2.t) | (hit.tri != k2.tri)
    out["grazing_disagree"] = int(bad.sum())
    print("far grazing 2^16 vs K2: disagree", int(bad.sum()), "K2 hits",
          int((k2.tri >= 0).sum()))

    if tree_mode:
        # The leaf size: each of 4, 8 and 16 timed a batch, bit for bit with
        # the module's own on bounce 2.
        leaves = {}
        for leaf in (4, 8, 16):
            tl = build(leaf)
            same = _hits_equal(paged_tri.intersect_tris_paged(
                *seen[2][:2], tl, seen[2][2]), paged_tri.intersect_tris_paged(
                *seen[2][:2], tables, seen[2][2]), seen[2][2])
            leaves[leaf] = sum(lib.k3_bounce_ms(tl, seen))
            print(f"L={leaf}: depth {tl.depth}, {leaves[leaf]:.3f} ms a "
                  f"batch; bounce 2 same bits {same}", flush=True)
            del tl
        out["leaf_batch_ms"] = leaves
        # The work on 2^17 of bounces 0, 1 and 2, tree and flat.
        pages = paged_tri.build_page_tables(wp, wp.shape[0], geom.tri_table12)
        for b in (0, 1, 2):
            o, d, alive = seen[b]
            sel = torch.randperm(o.x.shape[0], generator=gen)[:1 << 17].to(
                dev)
            so, sd = (V3(*(x[sel].contiguous() for x in v)) for v in (o, d))
            sa = alive[sel].contiguous()
            bt = paged_tri.intersect_tris_paged(so, sd, tables, sa).t
            print(f"bounce {b} work a ray: tree",
                  paged_tri.tree_visit_counts(so, sd, tables, bt, sa),
                  "flat", paged_tri.visit_counts(so, sd, pages, bt, sa))
    del seen

    # The main path: three batches stepped; the third profiled.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        r.render_next_batch()
    rays0, sec0 = r.stats.rays_traced, r.stats.render_seconds
    r.render_next_batch()
    rays, sec = r.stats.rays_traced - rays0, r.stats.render_seconds - sec0
    out["mrays_stepped"] = rays / sec / 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.render_next_batch()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end, k3 = 0.0, -1.0, 0.0
    for s0, e0, name in spans:
        if "paged_tri" in name:
            k3 += e0 - s0
        if e0 > end:
            busy += e0 - max(s0, end)
            end = e0
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    out["busy_timeline"] = busy / window if window else 0.0
    out["k3_share"] = k3 / busy if busy else 0.0
    out["device_busy_s"] = busy / 1e6
    print(f"main path batch 2: {rays} rays in {sec:.4f} s, "
          f"{out['mrays_stepped']:.3f} Mrays/s; profiled batch 3: device "
          f"busy {busy / 1e6:.4f} s, {out['busy_timeline']:.4f} of its "
          f"timeline, K3 {out['k3_share']:.4f} of device time; K3 launches "
          f"{paged_tri.LAUNCHES}")

    # Motion blur with meshes: one batch (the tree re-fitted for it).
    mb = str(Path(cli.DEFAULT_SCENE).with_name(MB_SCENE))
    rm = Renderer(cli.load_scene(mb, analytic_spheres=False), device=dev)
    t0 = time.perf_counter()
    rm.render_next_batch()
    print("motion blur one batch s", time.perf_counter() - t0, "rays",
          rm.stats.rays_traced, "means", rm.image().mean((0, 1)))
    if tree_mode:
        g1 = rm._geometry(1)
        out["refit_ms"] = _med(lambda: paged_tri.build_tri_tree(
            g1.world_p, rm.static.num_triangles, g1.tri_table12), 3)
        print("motion blur tree re-fit ms", out["refit_ms"])
    print("peak GiB", torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    print(json.dumps(out))


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def probes() -> None:
    import torch

    from raytrace_tpu_torch.ops import _build
    from raytrace_tpu_torch.tools import smoke_lib

    card = _card()
    secs = smoke_lib.build_kernels(("probe_ops", "probe_trig",
                                    "micro_raygen"))
    entries, _ = smoke_lib.dev_probes(torch.device("cuda:0"), card)
    # P2's SASS instructions an element in TREE's build (a parent's too),
    # counted by this checkout's smoke_lib.
    sass = _change_smoke_lib().trig_sass(_build.library_path("probe_trig"))
    print(json.dumps({"card": card, "build_s": secs, "p2_sass": sass,
                      "kernels": entries}))


# P2's source variants (``trig``): (name, [(text in csrc/probe_trig.cu,
# its replacement)]); the first is the source as it stands.
TRIG_VARIANTS = [
    ("kept", []),
    ("a half a pass", [("#pragma unroll\n    for (int h = 0; h < 2;",
                        "#pragma unroll 1\n    for (int h = 0; h < 2;")]),
    ("runs of 8 side by side", [("return i + w + h * min(32, vectors - w);",
                                 "return 2 * i + h;")]),
    ("streaming stores", [
        ("ov[half_index(i, h, vectors)] = uv_sum4(h == 0 ? a : b);",
         "__stcs(ov + half_index(i, h, vectors), uv_sum4(h == 0 ? a : b));"
         )]),
    # Diagnostics, not the function: the loads and stores alone (also
    # with a thread's two float4 side by side), and the trig and stores on
    # values made in registers.
    ("copy only", [("uv_sum4(h == 0 ? a : b)", "(h == 0 ? a : b)")]),
    ("copy only, side by side", [
        ("uv_sum4(h == 0 ? a : b)", "(h == 0 ? a : b)"),
        ("return i + w + h * min(32, vectors - w);", "return 2 * i + h;")]),
    ("no loads", [(f"__ldg(xv + half_index({v}, {h}, vectors))",
                   f"make_float4({v} * {s}1e-7f, {v} * {s}2e-7f, "
                   f"{v} * {s}3e-7f, {v} * {s}4e-7f)")
                  for v in ("i", "next") for h, s in ((0, ""), (1, "-"))]),
]


def trig() -> None:
    import concurrent.futures
    import ctypes
    import tempfile

    import torch

    from raytrace_tpu_torch.ops import _build
    from raytrace_tpu_torch.tools import smoke_lib
    from raytrace_tpu_torch.tools_dev import probe_trig

    src = _build.source("probe_trig").read_text()
    tmp = Path(tempfile.mkdtemp())

    def build(k):
        name, subs = TRIG_VARIANTS[k]
        text = src
        for old, new in subs:
            if old not in text:
                raise AssertionError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        (tmp / f"v{k}.cu").write_text(text)
        out = subprocess.run(
            [_build._nvcc(), *_build.nvcc_flags("probe_trig"), "-o",
             str(tmp / f"v{k}.so"), str(tmp / f"v{k}.cu")],
            capture_output=True, text=True, check=True)
        return out.stdout + out.stderr

    with concurrent.futures.ThreadPoolExecutor(len(TRIG_VARIANTS)) as pool:
        logs = list(pool.map(build, range(len(TRIG_VARIANTS))))
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {"card": _card(), "variants": {}}
    libs = []
    for k, (name, _) in enumerate(TRIG_VARIANTS):
        lib = ctypes.CDLL(str(tmp / f"v{k}.so"))
        for fn in (lib.probe_trig_launch, lib.probe_trig_launch_scalar):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p]
        libs.append(lib)
        regs = smoke_lib.ptxas_entry(logs[k], "probe_trig_vec")
        out["variants"][name] = dict(
            registers=regs[0], spills=regs[1],
            sass=smoke_lib.trig_sass(tmp / f"v{k}.so")["probe_trig_vec"],
            ms={}, identical={})
        print(name, regs, out["variants"][name]["sass"], flush=True)
    for size, shape in probe_trig.SIZES.items():
        x = probe_trig.points(shape, dev)
        want = torch.empty_like(x)
        libs[0].probe_trig_launch_scalar(x.data_ptr(), x.numel(),
                                         want.data_ptr(), stream)
        for k in [*range(len(libs)), *reversed(range(len(libs)))]:
            name = TRIG_VARIANTS[k][0]
            got = torch.empty_like(x)

            def launch(lib=libs[k], got=got):
                err = lib.probe_trig_launch(x.data_ptr(), x.numel(),
                                            got.data_ptr(), stream)
                assert err == 0, err

            ms = smoke_lib.median_ms(launch, 21)
            res = out["variants"][name]
            res["ms"].setdefault(size, []).append(ms)
            res["identical"][size] = probe_trig.same_bytes(got, want)
            print(f"{name} at {x.numel()}: {ms:.5f} ms, byte for byte "
                  f"{res['identical'][size]}", flush=True)
    print(json.dumps(out))


def k1() -> None:
    import os

    import numpy as np
    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.tools import smoke_lib

    card = _card()
    print(card, "pid", os.getpid(), "CUDA_MODULE_LOADING",
          os.environ.get("CUDA_MODULE_LOADING"), flush=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smoke_lib.build_kernels()
    cs = cli.load_scene(cli.DEFAULT_SCENE, smoke_lib.WIDTH, smoke_lib.HEIGHT)
    res = smoke_lib.k1_checks(cs, dev, card, np.random.default_rng(0))
    print(json.dumps({"k1": res}))


def _k1_batch(r, walk):
    """Batch 0 of wavefront Renderer ``r`` through its trace, every
    bounce's rays kept; K1 as the wavefront launches it (walk: with the
    batch's sphere tree, else a parent's dense K1) timed on the first
    bounce and summed over the batch's bounces, and with a walk its dense
    entry point on the first bounce and the two held bit for bit on every
    bounce.  Returns a dict."""
    import torch

    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.ops import sphere_sweep

    geom = r._geometry(0)
    trace = wavefront.make_trace_fn(r.static, r.scene, geom)
    seen = []

    def capture(o, d, alive):
        seen.append((o, d, alive))
        return trace(o, d, alive)

    wavefront.render_tile(r.static, r.scene, r.camera, capture, geom, 0, 0,
                          r.rows_per_tile, r.use_dof)
    table8 = geom.sph_table8
    tree = geom.sph_tree if walk else None

    def k1(o, d, a):
        if walk:
            return sphere_sweep.intersect_spheres_sweep(o, d, table8, a, tree)
        return sphere_sweep.intersect_spheres_sweep(o, d, table8, a)

    o, d, a = seen[0]
    out = dict(spheres=r.static.num_spheres, prefix=r.static.sph_prefix,
               launches=len(seen), rays=o.x.shape[0],
               ms=_med(lambda: k1(o, d, a), 5),
               batch_ms=sum(_med(lambda o=o, d=d, a=a: k1(o, d, a), 3)
                            for o, d, a in seen))
    if walk:
        out["tree"] = (None if tree is None else
                       [tree.num_spheres, tree.leaf, tree.depth])
        out["dense_ms"] = _med(lambda: sphere_sweep.intersect_spheres_dense(
            o, d, table8, a), 5)
        out["bitwise"] = True
        for o, d, a in seen:
            w = k1(o, d, a)
            x = sphere_sweep.intersect_spheres_dense(o, d, table8, a)
            out["bitwise"] &= torch.equal(w.t, x.t) and torch.equal(w.sph,
                                                                    x.sph)
    return out


def walks() -> None:
    """K1 and K2 as the wavefront launches them, on TREE (a parent's dense
    kernels, or the walks): see the module docstring."""
    import numpy as np
    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.engine.wavefront import primary_rays
    from raytrace_tpu_torch.models import compile_scene
    from raytrace_tpu_torch.ops import _build, sphere_sweep, tri_sweep
    from raytrace_tpu_torch.scene_file import SceneFile
    from raytrace_tpu_torch.tools import stress_scenes

    card = _card()
    dev = torch.device("cuda:0")
    walk = hasattr(sphere_sweep, "intersect_spheres_dense")
    lib = _change_smoke_lib()
    out = {"card": card, "walk": walk}
    print(card, "walks:", walk, flush=True)
    for mod in (sphere_sweep, tri_sweep):
        mod.library()
        name = mod.__name__.rsplit(".", 1)[1]
        log = _build.library_path(name).with_suffix(".log").read_text()
        print(log.strip())
        if walk:
            out[f"{name}_regs"] = lib.ptxas_entry(log, f"{name}_kernel")

    # K1 on forced wavefronts: final-one-weekend, stress-16k.
    tmp = __import__("tempfile").mkdtemp()
    scenes = {"final-one-weekend": cli.load_scene(cli.DEFAULT_SCENE, 1200,
                                                  675),
              "stress-16k": cli.load_scene(
                  stress_scenes.write_sphere_stress(tmp)["stress-16k"])}
    for name, cs in scenes.items():
        r = Renderer(cs, device=dev, use_megakernel=False)
        out[name] = _k1_batch(r, walk)
        print(name, "forced wavefront K1", out[name], flush=True)
        del r

    # The uncut sphere_stress_doc(6) on defaults: the wavefront, K1.
    t0 = time.perf_counter()
    cs = compile_scene(SceneFile.from_json_dict(
        stress_scenes.sphere_stress_doc(6)))
    compile_s = time.perf_counter() - t0
    r = Renderer(cs, device=dev)
    if r.path != "wavefront" or r.static.num_spheres != 17428:
        raise AssertionError(f"stress-17428: {r.static.num_spheres} spheres "
                             f"on {r.path}")
    before = sphere_sweep.LAUNCHES
    r.render_next_batch()
    rays0, sec0 = r.stats.rays_traced, r.stats.render_seconds
    r.render_next_batch()
    r.render_next_batch()
    launches = sphere_sweep.LAUNCHES - before
    if launches <= 0:
        raise AssertionError("stress-17428's wavefront launched no K1")
    out["stress-17428"] = dict(
        compile_s=compile_s, path=r.path, k1_launches=launches,
        mrays=(r.stats.rays_traced - rays0)
        / (r.stats.render_seconds - sec0) / 1e6,
        width=cs.render.width, height=cs.render.height,
        spp=cs.render.samples_per_pixel)
    print("stress-17428 on defaults", out["stress-17428"], flush=True)
    del r

    # K2 on tri-stress-15360's forced wavefront: its primary rays, one batch.
    r = Renderer(_tri_stress(4, 1024), device=dev, use_megakernel=False)
    geom = r._geometry(0)
    _, o, d = primary_rays(r.static, r.camera, 0, 0, r.static.height,
                           r.use_dof, dev)
    alive = torch.ones(o.x.shape[0], dtype=torch.bool, device=dev)
    table16 = geom.tri_table16

    def k2():
        if not walk:
            return tri_sweep.intersect_tris_sweep(o, d, table16, alive)
        return tri_sweep.intersect_tris_sweep(o, d, table16, alive,
                                              geom.tri_tree)

    res = dict(rays=o.x.shape[0], ms=_med(k2, 3))
    if walk:
        dense = tri_sweep.intersect_tris_dense(o, d, table16, alive)
        res["bitwise"] = all(torch.equal(a, b) for a, b in zip(k2(), dense))
        res["dense_ms"] = _med(lambda: tri_sweep.intersect_tris_dense(
            o, d, table16, alive), 3)
    before = tri_sweep.LAUNCHES
    r.render_next_batch()
    res["batch_launches"] = tri_sweep.LAUNCHES - before
    res["batch_s"] = r.stats.render_seconds
    res["batch_mrays"] = r.stats.mrays_per_sec
    out["tri-stress-15360"] = res
    print("tri-stress-15360 forced wavefront K2", res, flush=True)
    del r, geom, o, d, alive, table16

    if walk:
        # Where the walk starts to pay: n small spheres past a ground
        # prefix, 2^21 rays from the air, K1 dense (no tree) vs its walk.
        g = np.random.default_rng(0)
        R = 1 << 21
        ro = g.uniform([-12, 0.3, -12], [12, 3.0, 12], (R, 3))
        rd = g.standard_normal((R, 3))
        rd /= np.linalg.norm(rd, axis=1, keepdims=True)
        ro, rd = (lib.rows_to_v3(x.astype(np.float32), dev) for x in (ro, rd))
        ra = torch.ones(R, dtype=torch.bool, device=dev)
        from raytrace_tpu_torch.ops import sphere_tree

        flat = {}
        for n in (8, 16, 24, 32, 48, 64, 96, 128, 256):
            c = np.zeros((n + 1, 3))
            rad = np.zeros(n + 1)
            c[0], rad[0] = (0.0, -1000.0, 0.0), 1000.0
            c[1:] = g.uniform([-10, 0.2, -10], [10, 1.0, 10], (n, 3))
            rad[1:] = g.uniform(0.2, 1.0, n)
            tab = np.zeros((n + 1, 5))
            tab[:, :3], tab[:, 3] = c, rad
            tab[:, 4] = (c ** 2).sum(-1) - rad ** 2
            t8 = sphere_sweep.pad_table8(torch.tensor(
                tab.astype(np.float32), device=dev))
            ids = torch.tensor(sphere_tree.sphere_order(
                t8[:, :3].cpu().numpy(), 1, n + 1), dtype=torch.int32,
                device=dev)
            tree = sphere_tree.build_sphere_tree(t8, 1, n + 1, ids)
            a = sphere_sweep.intersect_spheres_sweep(ro, rd, t8, ra, tree)
            b = sphere_sweep.intersect_spheres_sweep(ro, rd, t8, ra)
            flat[n] = dict(
                walk_ms=_med(lambda: sphere_sweep.intersect_spheres_sweep(
                    ro, rd, t8, ra, tree), 5),
                dense_ms=_med(lambda: sphere_sweep.intersect_spheres_sweep(
                    ro, rd, t8, ra), 5),
                bitwise=torch.equal(a.t, b.t) and torch.equal(a.sph, b.sph))
            print("flat threshold", n, flat[n], flush=True)
        out["flat"] = flat
    print(json.dumps(out))


def _h1_tree(cs, dev, implicit):
    """Renderer(cs, use_bvh=True) on the SAH tree, or with ``implicit``
    on the implicit tree that a failed SAH build leaves; the collapse's
    host seconds where TREE has four-wide nodes."""
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.engine import renderer as renderer_mod
    from raytrace_tpu_torch.ops import bvh

    secs = []
    sah, wide = renderer_mod.build_bvh_sah, getattr(bvh, "wide_rows", None)
    if wide is not None:
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = wide(*a, **k)
            secs.append(time.perf_counter() - t0)
            return out
        bvh.wide_rows = timed
    if implicit:
        renderer_mod.build_bvh_sah = lambda *a, **k: None
    try:
        r = Renderer(cs, device=dev, use_bvh=True)
    finally:
        renderer_mod.build_bvh_sah = sah
        if wide is not None:
            bvh.wide_rows = wide
    want = "implicit" if implicit else "sah"
    if r.static.bvh_mode != want:
        raise AssertionError(f"use_bvh=True built {r.static.bvh_mode}, "
                             f"not {want}")
    return r, secs


def _h1_probe(r, lib, gen):
    """H1 on batch 0 of Renderer ``r``: see ``hwalks``."""
    import torch

    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.ops import bvh

    tree = wavefront.bvh_tree(r.static, r.scene)
    geom, seen = lib.capture_bounces(r)
    table12 = geom.tri_table12

    def h1(o, d, a):
        return bvh.intersect_tris_bvh(o, d, table12, tree, a)

    so, sd, sa = lib.subset_rays(*seen[0], 1 << 17, gen)
    hit = h1(so, sd, sa)
    plain = bvh.bvh_walk_reference(so, sd, table12, tree, sa)
    ms, bounce_ms = lib.bounce_ms(h1, seen)
    return dict(rows=list(tree.nodes.shape), stack=tree.stack_depth,
                launches=len(seen), rays=[x.x.shape[0] for x, _, _ in seen],
                active=[int(x.sum()) for _, _, x in seen],
                bitwise=all(torch.equal(x.view(torch.int32),
                                        y.view(torch.int32))
                            for x, y in zip(hit, plain)),
                ms=ms, bounce_ms=bounce_ms, batch_ms=sum(bounce_ms),
                work=[lib.bvh_work(*x, table12, (tree,), 1 << 17, gen)[0][0]
                      for x in seen])


def _h2_probe(r, lib):
    """H2 on batch 0 of fow-ellipsoids' Renderer ``r``: see ``hwalks``."""
    import torch

    from raytrace_tpu_torch.ops import sphere_obj, spheres
    from raytrace_tpu_torch.ops.intersect import T_MAX

    geom, seen = lib.capture_bounces(r)
    table = geom.sph_obj16
    walk = getattr(geom, "sph_obj_tree", None)
    kw = {} if not hasattr(sphere_obj, "intersect_spheres_object_dense") \
        else {"tree": walk}

    def h2(o, d, a):
        return sphere_obj.intersect_spheres_object(o, d, table, a, **kw)

    bitwise = True
    for o, d, a in seen:
        hit, plain = h2(o, d, a), spheres.intersect_spheres(o, d, table)
        bitwise &= (torch.equal(hit.t, torch.where(a, plain.t, T_MAX))
                    and torch.equal(hit.sph, torch.where(a, plain.sph, -1)))
    ms, bounce_ms = lib.bounce_ms(h2, seen)
    out = dict(launches=len(seen), bitwise=bitwise, ms=ms,
               bounce_ms=bounce_ms, batch_ms=sum(bounce_ms))
    if kw:
        def dense(o, d, a):
            return sphere_obj.intersect_spheres_object_dense(o, d, table, a)

        out["dense_ms"], dense_bounce = lib.bounce_ms(dense, seen)
        out["dense_batch_ms"] = sum(dense_bounce)
        out["tree"] = None if walk is None else [
            walk.n_prefix, walk.num_spheres, walk.leaf, walk.depth]
        out["build_ms"] = _med(lambda: sphere_obj.build_object_tree(
            table, r.static.num_spheres, walk.n_prefix, walk.ids,
            static=r._obj_tree is not None), 5)
        gen = torch.Generator().manual_seed(2)
        out["work"] = [list(lib.sphere_obj_work(*x, h2, walk, 1 << 17,
                                                gen)[0].values())
                       for x in seen[:2]]
    return out


def hwalks() -> None:
    """H1 and H2 as the wavefront launches them, on TREE: see the module
    docstring."""
    import tempfile

    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import _build, bvh, sphere_obj
    from raytrace_tpu_torch.tools import ellipsoid_scenes

    card = _card()
    dev = torch.device("cuda:0")
    lib = _change_smoke_lib()
    out = {"card": card, "wide": hasattr(bvh, "wide_rows"),
           "obj_walk": hasattr(sphere_obj, "intersect_spheres_object_dense")}
    print(card, out, flush=True)
    for mod, name, kernel in ((bvh, "bvh_walk", "bvh_walk_kernel"),
                              (sphere_obj, "sphere_obj",
                               "sphere_obj_kernel")):
        mod.library()
        log = _build.library_path(name).with_suffix(".log").read_text()
        print(log.strip())
        out[f"{name}_regs"] = lib.ptxas_entry(log, kernel)
    gen = torch.Generator().manual_seed(1)
    cs = cli.load_scene(cli.DEFAULT_SCENE, 1200, 675, analytic_spheres=False)
    for implicit in (False, True):
        t0 = time.perf_counter()
        r, secs = _h1_tree(cs, dev, implicit)
        key = "implicit" if implicit else "sah"
        out[key] = dict(renderer_s=time.perf_counter() - t0,
                        collapse_s=secs, **_h1_probe(r, lib, gen))
        print("H1", key, out[key], flush=True)
        del r
    path = ellipsoid_scenes.write_fow_ellipsoids(tempfile.mkdtemp())
    r = Renderer(cli.load_scene(path, 1200, 675), device=dev)
    out["ellipsoids"] = _h2_probe(r, lib)
    print("H2", out["ellipsoids"], flush=True)
    print(json.dumps(out))


def forms() -> None:
    from raytrace_tpu_torch.ops import _build, megakernel
    from raytrace_tpu_torch.tools import smoke_lib

    t0 = time.perf_counter()
    megakernel.library()
    log = _build.library_path("megakernel").with_suffix(".log").read_text()
    print(json.dumps({"build_s": time.perf_counter() - t0, "forms": {
        form: [regs, spill]
        for form, regs, spill in smoke_lib.ptxas_forms(log)}}))


def sass() -> None:
    import hashlib
    import re

    from raytrace_tpu_torch.ops import _build, megakernel

    lib = _change_smoke_lib()
    megakernel.library()
    listing = subprocess.run(
        ["/usr/local/cuda/bin/cuobjdump", "-sass",
         str(_build.library_path("megakernel"))], check=True,
        capture_output=True, text=True).stdout
    forms = {}
    for func in re.split(r"\n\s*Function : ", listing)[1:]:
        name, _, body = func.partition("\n")
        form = lib.k4_form(name)
        if form is not None:
            forms[form] = [len(re.findall(r"/\*[0-9a-f]{4,}\*/", body)),
                           hashlib.sha256(body.encode()).hexdigest()]
    print(json.dumps({"card": _card(), "sass": forms}))


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
    if len(argv) < 2 or argv[1] not in ("anim", "chunks", "tris", "lights",
                                        "paged", "noise", "image",
                                        "spheres", "probes", "trig", "k1",
                                        "forms",
                                        "sass", "walks", "hwalks"):
        print(__doc__, file=sys.stderr)
        return 2
    tree = str(Path(argv[2] if len(argv) > 2
                    else Path(__file__).resolve().parents[2]).resolve())
    sys.path.insert(0, tree)
    import raytrace_tpu_torch

    if not raytrace_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"raytrace_tpu_torch came from "
                           f"{raytrace_tpu_torch.__file__}, not {tree}")
    if argv[1] == "chunks":
        chunks(tree)
    else:
        {"anim": anim, "tris": tris, "lights": lights, "paged": paged,
         "noise": noise, "image": image, "spheres": spheres,
         "probes": probes, "trig": trig, "k1": k1, "forms": forms,
         "sass": sass, "walks": walks, "hwalks": hwalks}[argv[1]]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
