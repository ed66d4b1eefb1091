"""Short measurements on one CUDA card, outside chip_smoke.py.

    python3 raytrace_tpu_torch/tools/chip_probe.py anim [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py chunks [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py tris [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py lights [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py paged [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py noise [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py image [TREE]
    python3 raytrace_tpu_torch/tools/chip_probe.py spheres [TREE]

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
- ``tris``: builds the three kernels and prints nvcc's register reports;
  on the triangle stress scene (tools/stress_scenes.py) holds the
  triangle sweep K2 against its plain version on 2^18 primary rays and
  times it over all of them, holds the fused kernel's triangle form
  against its plain version at 96x54/depth 8/k=2 (k = 1 and 4, and the
  triangle fixture) and at 256x144/depth 50, times it at 1024x576, and
  renders the scene's one batch on the fused path and on the wavefront.
- ``lights``: builds the fused kernel and prints nvcc's register report;
  holds its lit forms against the plain version at depth 50, k=2 on the
  four lit docs of tools/light_scenes.py (cornell-style at 128x128,
  sphere-light-962 at 128x72, the lit spheres and the 70-instance doc at
  96 wide; bit for bit or not, and two launches byte-identical), holds
  one full batch of each light scene against the plain version (bit for
  bit or not; the plain version's seconds and peak device memory) and
  times it (kernel median of 3), and steps two full cornell-style
  batches through ``Renderer`` with defaults.
- ``paged``: builds the paged triangle sweep K3 (with K1 and K2) and
  prints nvcc's register report; holds K3 against its plain version and
  K2 on random soups of several pages (g = c = 128, and g = 8, c = 16)
  with an alive mask, and a repeat launch; on final-one-weekend
  --mesh-geometry (2,033,920 triangles) renders one frame through
  ``render_tile`` capturing every bounce's rays, holds K3 against the
  plain version and K2 on 2^16 primary and bounce-2 rays (plain seconds,
  traversal work), times it over all of them (median of 3), steps two
  batches of ``Renderer`` with defaults (launch counts, means, peak
  memory), renders one batch of the motion-blur scene with
  --mesh-geometry, and renders a 240x135 frame of each soup on the paged
  and the dense sweep (byte-identical or not).
- ``noise``: builds the fused kernel and prints nvcc's register report;
  holds each of its five noise forms against the plain version on the
  small frames of ``tools/noise_scenes.form_checks`` (2 batches in one
  launch; bit for bit or not, two launches byte-identical, the noise
  launches counted), holds perlin-spheres' full batch (1024x576, 16 spp,
  depth 50) against the plain version (bit for bit or not; the plain
  version's seconds and peak device memory) and times it (kernel median
  of 3), and steps that batch through ``Renderer`` with defaults.
- ``image``: builds the fused kernel and prints nvcc's register report;
  holds each of its image forms against the plain version on the small
  frames of ``tools/image_scenes.form_checks`` (a 640x320 texel-id image;
  2 batches in one launch; bit for bit or not, two launches
  byte-identical, the image launches counted), holds earth's full batch
  (512x512, 4 spp, depth 50, its 5400x2700 image) against the plain
  version (bit for bit or not, texel ids of the primary hits, the plain
  version's seconds) and times it (kernel median of 3), steps that batch
  through ``Renderer`` with defaults, and one batch of earth-motion-blur.
- ``spheres``: builds the fused kernel and prints nvcc's register report;
  holds each form of its clustered sphere sweep against the plain version
  on the small docs of ``tools/stress_scenes.cluster_form_checks`` (2
  batches in one launch; bit for bit or not, two launches byte-identical,
  the clustered launches counted); holds one full batch of
  final-one-weekend (1200x675), its motion-blur twin and stress-4x
  (1024x576) against the plain version (bit for bit or not) and times the
  clustered form and the dense form (kernel medians of 5); compiles stress-16k
  (seconds), holds a 128x72, depth-50 batch of it against the plain
  version, times its full batch and holds it against the wavefront's;
  steps one batch of each stress scene through ``Renderer`` with
  defaults.
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
    """Median device ms of ``fn``: a ~2 ms spin kernel goes before each
    start event, so the host's work inside ``fn`` does not count (as in
    chip_smoke.py's _median_ms)."""
    import torch

    fn()
    ts = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
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


def tris() -> None:
    import concurrent.futures

    import torch

    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.engine.wavefront import primary_rays
    from raytrace_tpu_torch.models import compile_scene
    from raytrace_tpu_torch.ops import (_build, megakernel, sphere_sweep,
                                        tri_sweep)
    from raytrace_tpu_torch.ops.vec3 import V3
    from raytrace_tpu_torch.scene_file import SceneFile
    from raytrace_tpu_torch.tools import stress_scenes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    mods = (megakernel, tri_sweep, sphere_sweep)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: m.library(), mods))
    for name in ("megakernel", "tri_sweep"):
        print(_build.library_path(name).with_suffix(".log").read_text())
    dev = torch.device("cuda:0")

    full = Renderer(_tri_stress(4, 1024), device=dev)
    print("tri-stress-15360", full.path, full.static.num_triangles,
          full.static.tri_cluster_g)
    geom = full._geometry(0)
    _, o, d = primary_rays(full.static, full.camera, 0, 0, full.static.height,
                           full.use_dof, dev)
    n = o.x.shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    sel = torch.randperm(n, generator=torch.Generator().manual_seed(0))[
        :1 << 18].to(dev)
    so, sd = (V3(*(c[sel].contiguous() for c in v)) for v in (o, d))
    hit = tri_sweep.intersect_tris_sweep(so, sd, geom.tri_table16, alive[sel])
    ref = tri_sweep.tri_sweep_reference(so, sd, geom.tri_table16)
    torch.cuda.synchronize()
    print("K2 2^18 primary: bitwise", [torch.equal(a, b) for a, b in
                                       zip(hit, ref)],
          "ids agree", (hit.tri == ref[1]).double().mean().item(),
          "hit share", (hit.tri >= 0).double().mean().item())
    print("K2 ms over", n, "rays:",
          _med(lambda: tri_sweep.intersect_tris_sweep(o, d, geom.tri_table16,
                                                      alive), 3))
    t0 = time.perf_counter()
    tri_sweep.tri_sweep_reference(so, sd, geom.tri_table16)
    torch.cuda.synchronize()
    print("K2 plain s at 2^18 rays", time.perf_counter() - t0)

    fixture = compile_scene(SceneFile.from_json_dict(
        stress_scenes.triangle_fixture_doc()), width=96)
    for label, cs in (("k1", _tri_stress(1, 96, 8, 2)),
                      ("k4", _tri_stress(4, 96, 8, 2)),
                      ("fixture", dataclasses.replace(
                          fixture, render=dataclasses.replace(
                              fixture.render, max_ray_depth=8,
                              sample_batches=2)))):
        r = Renderer(cs, device=dev)
        args = (r.static, r.scene, r._geometry(0), r.camera, 0, 2)
        kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
        s1, t1 = megakernel.render_tile_mega(*args, **kw)
        s2, t2 = megakernel.render_tile_mega(*args, **kw)
        t0 = time.perf_counter()
        ref, rt = megakernel.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        print(label, r.path, "repeat identical",
              torch.equal(s1, s2) and torch.equal(t1, t2), "bitwise",
              torch.equal(s1, ref), torch.equal(t1, rt), "maxdiff",
              (s1 - ref).abs().max().item(), "rays", int(t1.sum()),
              int(rt.sum()), "plain s", time.perf_counter() - t0)

    args = (full.static, full.scene, geom, full.camera, 0, 1)
    kw = dict(use_dof=full.use_dof, times=full.batch_times_dev)
    print("K4 tris full ms", _med(lambda: megakernel.render_tile_mega(
        *args, **kw), 3))
    for label, r in (("fused", full),
                     ("wavefront", Renderer(_tri_stress(4, 1024), device=dev,
                                            use_megakernel=False))):
        launches = (megakernel.TRI_LAUNCHES, tri_sweep.LAUNCHES,
                    sphere_sweep.LAUNCHES)
        r.render_all()
        print(label, r.path, "Mrays/s", r.stats.mrays_per_sec, "rays",
              r.stats.rays_traced, "s", r.stats.render_seconds,
              "means", r.image().mean((0, 1)), "K4/K2/K1 launches",
              megakernel.TRI_LAUNCHES - launches[0],
              tri_sweep.LAUNCHES - launches[1],
              sphere_sweep.LAUNCHES - launches[2])
    mid = Renderer(_tri_stress(4, 256, 50, 1), device=dev)
    args = (mid.static, mid.scene, mid._geometry(0), mid.camera, 0, 1)
    s1, t1 = megakernel.render_tile_mega(*args, **kw)
    t0 = time.perf_counter()
    ref, rt = megakernel.megakernel_reference(*args, **kw)
    torch.cuda.synchronize()
    print("256x144 d50 plain s", time.perf_counter() - t0, "bitwise",
          torch.equal(s1, ref), "rays", int(rt.sum()))


def lights() -> None:
    import concurrent.futures

    import torch

    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import (_build, megakernel, sphere_sweep,
                                        tri_sweep)
    from raytrace_tpu_torch.tools import light_scenes as ls

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    mods = (megakernel, tri_sweep, sphere_sweep)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: m.library(), mods))
    print(_build.library_path("megakernel").with_suffix(".log").read_text())
    dev = torch.device("cuda:0")

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
        print(label, r.path, r.static.width, r.static.height,
              "repeat identical", torch.equal(s1, s2) and torch.equal(t1, t2),
              "bitwise", torch.equal(s1, ref), torch.equal(t1, rt),
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
        print(label, "full batch", r.static.width, r.static.height, "rays",
              int(traced.sum()), "kernel ms",
              _med(lambda: megakernel.render_tile_mega(*args, **kw), 3),
              "bitwise", torch.equal(sums, ref), torch.equal(traced, rt),
              "plain s", plain_s, "plain peak GiB",
              torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        del sums, traced, ref, rt
    r = Renderer(_doc_scene(ls.cornell_doc(), 1024), device=dev)
    before = (megakernel.LIGHT_LAUNCHES, sphere_sweep.LAUNCHES,
              tri_sweep.LAUNCHES)
    for _ in range(2):
        r.render_next_batch()
    print("cornell-style main path", r.path, "Mrays/s",
          r.stats.mrays_per_sec, "rays", r.stats.rays_traced, "launches",
          megakernel.LIGHT_LAUNCHES - before[0],
          sphere_sweep.LAUNCHES - before[1], tri_sweep.LAUNCHES - before[2],
          "means", r.image().mean((0, 1)))


def noise() -> None:
    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import _build, megakernel, sphere_sweep
    from raytrace_tpu_torch.tools import noise_scenes as ns

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    megakernel.library()
    print("build", time.perf_counter() - t0)
    print(_build.library_path("megakernel").with_suffix(".log").read_text())
    dev = torch.device("cuda:0")

    with open(Path(cli.DEFAULT_SCENE).with_name(MB_SCENE)) as f:
        checks = ns.form_checks(json.load(f))
    for form, (doc, w, depth) in checks.items():
        r = Renderer(_doc_scene(doc, w, depth, 2), device=dev)
        args = (r.static, r.scene, r._geometry(0), r.camera, 0, 2)
        kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
        before = megakernel.NOISE_LAUNCHES
        s1, t1 = megakernel.render_tile_mega(*args, **kw)
        s2, t2 = megakernel.render_tile_mega(*args, **kw)
        ref, rt = megakernel.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        print(form, r.path, r.static.width, r.static.height, "depth", depth,
              "repeat identical", torch.equal(s1, s2) and torch.equal(t1, t2),
              "bitwise", torch.equal(s1, ref), torch.equal(t1, rt),
              "maxdiff", (s1 - ref).abs().max().item(), "pixels > 1e-4",
              ((s1 - ref).abs().amax(-1) > 1e-4).double().mean().item(),
              "rays", int(t1.sum()), int(rt.sum()), "NOISE_LAUNCHES +",
              megakernel.NOISE_LAUNCHES - before)

    r = Renderer(_doc_scene(ns.perlin_spheres_doc(), 1024), device=dev)
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ref, rt = megakernel.megakernel_reference(*args, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    print("perlin-spheres full batch", r.static.width, r.static.height,
          "rays", int(traced.sum()), "kernel ms",
          _med(lambda: megakernel.render_tile_mega(*args, **kw), 3),
          "bitwise", torch.equal(sums, ref), torch.equal(traced, rt),
          "maxdiff", (sums - ref).abs().max().item(), "plain s", plain_s,
          "plain peak GiB", torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    del sums, traced, ref, rt
    before = (megakernel.NOISE_LAUNCHES, sphere_sweep.LAUNCHES)
    r = Renderer(_doc_scene(ns.perlin_spheres_doc(), 1024), device=dev)
    r.render_next_batch()
    print("perlin-spheres main path", r.path, "Mrays/s", r.stats.mrays_per_sec,
          "rays", r.stats.rays_traced, "NOISE_LAUNCHES +",
          megakernel.NOISE_LAUNCHES - before[0], "K1 +",
          sphere_sweep.LAUNCHES - before[1], "means", r.image().mean((0, 1)))


def image() -> None:
    import tempfile

    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import _build, megakernel, sphere_sweep
    from raytrace_tpu_torch.tools import image_scenes as ims

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    megakernel.library()
    print("build", time.perf_counter() - t0)
    print(_build.library_path("megakernel").with_suffix(".log").read_text())
    dev = torch.device("cuda:0")
    tmp = tempfile.mkdtemp()
    png = ims.texel_id_png(str(Path(tmp) / "small.png"), 640, 320)
    for form, (doc, w, depth) in ims.form_checks(png).items():
        r = Renderer(_doc_scene(doc, w, depth, 2), device=dev)
        args = (r.static, r.scene, r._geometry(0), r.camera, 0, 2)
        kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
        before = megakernel.IMAGE_LAUNCHES
        s1, t1 = megakernel.render_tile_mega(*args, **kw)
        s2, t2 = megakernel.render_tile_mega(*args, **kw)
        ref, rt = megakernel.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        print(form, r.path, r.static.width, r.static.height, "depth", depth,
              "repeat identical", torch.equal(s1, s2) and torch.equal(t1, t2),
              "bitwise", torch.equal(s1, ref), torch.equal(t1, rt),
              "maxdiff", (s1 - ref).abs().max().item(), "pixels > 1e-4",
              ((s1 - ref).abs().amax(-1) > 1e-4).double().mean().item(),
              "rays", int(t1.sum()), int(rt.sum()), "IMAGE_LAUNCHES +",
              megakernel.IMAGE_LAUNCHES - before, "means",
              s1.mean((0, 1)).tolist())

    earth_json, mb_json = ims.write_earth_scenes(tmp)
    r = Renderer(cli.load_scene(earth_json, ims.EARTH_WIDTH), device=dev)
    args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev)
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ref, rt = megakernel.megakernel_reference(*args, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    print("earth full batch", r.static.width, r.static.height,
          "rays", int(traced.sum()), "kernel ms",
          _med(lambda: megakernel.render_tile_mega(*args, **kw), 3),
          "bitwise", torch.equal(sums, ref), torch.equal(traced, rt),
          "maxdiff", (sums - ref).abs().max().item(), "pixels > 1e-4",
          ((sums - ref).abs().amax(-1) > 1e-4).double().mean().item(),
          "plain s", plain_s, "plain peak GiB",
          torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    del sums, traced, ref, rt
    before = (megakernel.IMAGE_LAUNCHES, sphere_sweep.LAUNCHES)
    r = Renderer(cli.load_scene(earth_json, ims.EARTH_WIDTH), device=dev)
    r.render_next_batch()
    print("earth main path", r.path, "Mrays/s", r.stats.mrays_per_sec,
          "rays", r.stats.rays_traced, "IMAGE_LAUNCHES +",
          megakernel.IMAGE_LAUNCHES - before[0], "K1 +",
          sphere_sweep.LAUNCHES - before[1], "means", r.image().mean((0, 1)))
    r = Renderer(cli.load_scene(mb_json, ims.EARTH_WIDTH), device=dev)
    r.render_next_batch()
    print("earth-motion-blur", r.path, "Mrays/s", r.stats.mrays_per_sec,
          "means", r.image().mean((0, 1)))


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


def spheres() -> None:
    import tempfile

    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import _build, megakernel, sphere_sweep
    from raytrace_tpu_torch.tools import image_scenes as ims
    from raytrace_tpu_torch.tools import stress_scenes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    megakernel.library()
    print("build", time.perf_counter() - t0)
    print(_build.library_path("megakernel").with_suffix(".log").read_text())
    dev = torch.device("cuda:0")
    tmp = tempfile.mkdtemp()
    png = ims.texel_id_png(str(Path(tmp) / "small.png"), 640, 320)
    for form, (doc, w, depth) in stress_scenes.cluster_form_checks(
            png).items():
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

    stress = stress_scenes.write_sphere_stress(tmp)
    mb = str(Path(cli.DEFAULT_SCENE).with_name(MB_SCENE))
    full = [("final-one-weekend", lambda: _scene(cli.DEFAULT_SCENE, 1200,
                                                 675), True),
            ("motion-blur", lambda: _scene(mb, 1024, 576), True),
            ("stress-4x", lambda: cli.load_scene(stress["stress-4x"]),
             True)]
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
        print(label, r.path, r.static.width, r.static.height,
              r.static.num_spheres,
              megakernel.sphere_cluster_layout(r.static), "compile s",
              compile_s, "Renderer s", init_s, "bitwise",
              torch.equal(s1, ref), torch.equal(t1, rt), "rays",
              int(t1.sum()), "plain s", plain_s, "ms", _cluster_times(
                  args, kw, dense))
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


def _paged_soup_tables(T, g, c, seed, dev):
    """T random small triangles in a 10-unit box put in the paged sweep's
    order, with a duplicate pair; their page tables and dense table."""
    import numpy as np
    import torch

    from raytrace_tpu_torch.ops import paged_tri, tri_sweep

    rng = np.random.default_rng(seed)
    cen = rng.uniform(-5, 5, (T, 3))
    tri = (cen[:, None, :] + rng.uniform(-0.8, 0.8, (T, 3, 3))).astype(
        np.float32)
    tri[T // 2] = tri[1]
    tri = tri[paged_tri.paged_tri_order(tri, T)]
    wp = torch.tensor(tri, device=dev)
    return tri, paged_tri.build_page_tables(wp, T, g=g, c=c), \
        tri_sweep.pack_tri_table(wp, T)


def _hits_equal(a, b, alive):
    """(t, id equal) and (u, v equal on the alive rays) of two hits."""
    import torch

    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2][alive], b[2][alive])
            and torch.equal(a[3][alive], b[3][alive]))


def paged() -> None:
    import concurrent.futures

    import numpy as np
    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer, wavefront
    from raytrace_tpu_torch.ops import (_build, megakernel, paged_tri,
                                        sphere_sweep, tri_sweep)
    from raytrace_tpu_torch.ops.vec3 import V3

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    mods = (paged_tri, tri_sweep, sphere_sweep)
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: m.library(), mods))
    print(_build.library_path("paged_tri").with_suffix(".log").read_text())
    dev = torch.device("cuda:0")

    for T, g, c, R in ((40000, 128, 128, 1 << 16), (3001, 8, 16, 1 << 14)):
        tri, tables, table16 = _paged_soup_tables(T, g, c, T, dev)
        rng = np.random.default_rng(R)
        o = rng.uniform(-9, 9, (R, 3))
        j = rng.integers(0, T, R)
        d = np.einsum("rv,rvi->ri", rng.dirichlet(np.ones(3), R),
                      tri[j].astype(np.float64)) - o
        d[:R // 10] = rng.standard_normal((R // 10, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        v3 = lambda a: V3(*(torch.tensor(  # noqa: E731
            np.ascontiguousarray(a[:, i], np.float32), device=dev)
            for i in range(3)))
        o, d = v3(o), v3(d)
        alive = torch.tensor(rng.random(R) < 0.7, device=dev)
        hit = paged_tri.intersect_tris_paged(o, d, tables, alive)
        again = paged_tri.intersect_tris_paged(o, d, tables, alive)
        ref = paged_tri.paged_tri_sweep_reference(o, d, tables, alive)
        k2 = tri_sweep.intersect_tris_sweep(o, d, table16, alive)
        torch.cuda.synchronize()
        print(f"random T={T} g={g} c={c} pages "
              f"{tables.page_boxes.shape[0]} R={R}: vs plain "
              f"{_hits_equal(hit, ref, alive)}, vs K2 "
              f"{_hits_equal(hit, k2, alive)}, repeat "
              f"{all(torch.equal(a, b) for a, b in zip(hit, again))}, hit "
              f"share {(hit.tri >= 0).double().mean().item():.4f}")

    t0 = time.perf_counter()
    cs = cli.load_scene(cli.DEFAULT_SCENE, 1200, 675, analytic_spheres=False)
    print("mesh compile s", time.perf_counter() - t0, cs.num_triangles)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r = Renderer(cs, device=dev)
    print("Renderer s", time.perf_counter() - t0, r.path, r.static.bvh_mode,
          "peak GiB", torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    geom = r._geometry(0)
    pages = geom.tri_pages
    print("pages", pages.page_boxes.shape[0], "clusters",
          pages.boxes.shape[0])
    trace = wavefront.make_trace_fn(r.static, r.scene, geom)
    seen = []

    def capture(o, d, alive):
        seen.append((o, d, alive))
        return trace(o, d, alive)

    t0 = time.perf_counter()
    wavefront.render_tile(r.static, r.scene, r.camera, capture, geom, 0, 0,
                          r.static.height, r.use_dof)
    torch.cuda.synchronize()
    print("one frame through render_tile s", time.perf_counter() - t0,
          "bounces", len(seen))
    gen = torch.Generator().manual_seed(0)
    for label, (o, d, alive) in (("primary", seen[0]), ("bounce 2",
                                                        seen[2])):
        n = o.x.shape[0]
        sel = torch.randperm(n, generator=gen)[:1 << 16].to(dev)
        so, sd = (V3(*(x[sel].contiguous() for x in v)) for v in (o, d))
        sa = alive[sel].contiguous()
        hit = paged_tri.intersect_tris_paged(so, sd, pages, sa)
        t1 = time.perf_counter()
        ref = paged_tri.paged_tri_sweep_reference(so, sd, pages, sa)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        k2 = tri_sweep.intersect_tris_sweep(so, sd, geom.tri_table16, sa)
        torch.cuda.synchronize()
        work = paged_tri.visit_counts(so, sd, pages, hit.t, sa)
        print(label, "R", n, "2^16 subset: vs plain",
              _hits_equal(hit, ref, sa), "vs K2", _hits_equal(hit, k2, sa),
              "plain s", plain_s, "hit share",
              (hit.tri >= 0).double().mean().item(), "work", work)
        print(label, "K3 ms over", n, "rays", _med(
            lambda: paged_tri.intersect_tris_paged(o, d, pages, alive), 3))
    del seen

    before = (paged_tri.LAUNCHES, tri_sweep.LAUNCHES, sphere_sweep.LAUNCHES,
              megakernel.LAUNCHES)
    for _ in range(2):
        r.render_next_batch()
        print("main path batch", r.stats.rays_traced, r.stats.render_seconds)
    print("main path", r.path, "Mrays/s", r.stats.mrays_per_sec, "K3/K2/K1/K4",
          paged_tri.LAUNCHES - before[0], tri_sweep.LAUNCHES - before[1],
          sphere_sweep.LAUNCHES - before[2], megakernel.LAUNCHES - before[3],
          "means", r.image().mean((0, 1)), "peak GiB",
          torch.cuda.max_memory_allocated(dev) / 2 ** 30)

    mb = str(Path(cli.DEFAULT_SCENE).with_name(MB_SCENE))
    cs_mb = cli.load_scene(mb, analytic_spheres=False)
    for label, paged_cs in (("static", r.compiled), ("motion blur", None)):
        if paged_cs is None:
            t0 = time.perf_counter()
            rm = Renderer(cs_mb, device=dev)
            before = paged_tri.LAUNCHES
            rm.render_next_batch()
            print("motion blur", rm.path, rm.static.bvh_mode,
                  rm.static.any_animated, "Renderer + batch s",
                  time.perf_counter() - t0, "rays", rm.stats.rays_traced,
                  "batch s", rm.stats.render_seconds, "K3",
                  paged_tri.LAUNCHES - before, "means",
                  rm.image().mean((0, 1)))
            paged_cs = rm.compiled
            del rm
        small = dataclasses.replace(paged_cs, render=dataclasses.replace(
            paged_cs.render, width=240, height=135, sample_batches=1))
        imgs = {}
        for mode in ("paged", False):
            rs = Renderer(small, device=dev, use_bvh=mode)
            rs.render_next_batch()
            imgs[mode] = (rs.image(), rs.stats.rays_traced,
                          rs.stats.render_seconds)
        print(label, "240x135 paged vs dense identical",
              imgs["paged"][0].tobytes() == imgs[False][0].tobytes(),
              "rays", imgs["paged"][1], imgs[False][1], "s",
              imgs["paged"][2], imgs[False][2])
    print("peak GiB", torch.cuda.max_memory_allocated(dev) / 2 ** 30)


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
                                        "spheres"):
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
         "noise": noise, "image": image, "spheres": spheres}[argv[1]]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
