"""Multi-device rendering: the port's parallel/multichip.py against its own
single-device Renderer and against the JAX package's MultiChipRenderer.

Ranks run as spawned processes on the CPU, gloo over a ``file://``
rendezvous under the test's temporary directory (so xdist workers never
share a port), at most 4 ranks, one torch thread each, joined with a
timeout that fails the test.  One spawn renders every layout in turn, in
one process group for each set of ranks that layouts take.

Tolerances:

- px and sc shards: the single-device port render's bytes, on the
  wavefront (each path of these scenes gathers its radiance in one term
  or the shards tile the rows as the Renderer does) and on the fused
  path's plain version; every rank holds the same image;
- sp = 2: within 1e-6 absolute of the single-device render (the order of
  the sample sums changes; measured: 6e-8);
- against JAX's MultiChipRenderer (its XLA wavefront) on the same layout
  over the conftest's virtual CPU devices: channel means within 5e-3,
  RMSE below 0.05 and rays traced within 2%, as the wavefront is held
  to the JAX Renderer (tests/test_torch_object_spheres.py);
- ``make_layout``, ``_pad_dup``, ``shard_scene_arrays`` and
  ``shard_sphere_tables`` bit for bit with JAX's.
"""

import dataclasses
import functools
import json
import os
import queue
import traceback

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from raytrace_tpu.engine.arrays import upload_scene as jax_upload_scene
from raytrace_tpu.models import compile_scene as jax_compile_scene
from raytrace_tpu.ops.spheres import (
    world_sphere_tables as jax_world_sphere_tables)
from raytrace_tpu.parallel import MultiChipRenderer as JaxMultiChip
from raytrace_tpu.parallel import make_mesh
from raytrace_tpu.parallel import multichip as jmc
from raytrace_tpu.scene_file import SceneFile as JaxSceneFile
from raytrace_tpu_torch import cli
from raytrace_tpu_torch.engine import Renderer
from raytrace_tpu_torch.engine.arrays import from_jax_compiled, upload_scene
from raytrace_tpu_torch.models import compile_scene
from raytrace_tpu_torch.ops.spheres import world_sphere_tables
from raytrace_tpu_torch.parallel import multichip as mc
from raytrace_tpu_torch.scene_file import SceneFile
from raytrace_tpu_torch.tools import (ellipsoid_scenes, light_scenes,
                                      registry_scenes, stress_scenes)

torch.set_num_threads(1)

WORLD = 4
JOIN_SECONDS = 240
SP_ATOL = 1e-6
MEAN_TOL, RMSE_TOL, RAY_TOL = 5e-3, 0.05, 0.02


def _doc(name):
    if name in ("fow5", "fow11", "fow18"):
        with open(cli.DEFAULT_SCENE) as f:
            doc = json.load(f)
    else:
        doc = {"tri": stress_scenes.triangle_fixture_doc,
               "cornell": light_scenes.cornell_doc,
               "ellipsoid-tri": lambda: ellipsoid_scenes.ellipsoid_fixture_doc(
                   triangles=True),
               "registry": lambda: registry_scenes.small_doc(
                   "fuzz-checker")}[name]()
    doc["render"].update(samples_per_pixel=4, sample_batches=2,
                         max_ray_depth=4)
    return doc


SIZES = {"fow5": (8, 5), "fow11": (20, 11), "fow18": (32, 18), "tri": (16, 9),
         "cornell": (12, 12), "ellipsoid-tri": (16, 9), "registry": (16, 9)}


def _cs(name):
    w, h = SIZES[name]
    return compile_scene(SceneFile.from_json_dict(_doc(name)), width=w,
                         height=h)


@functools.lru_cache(maxsize=None)
def _jcs(name):
    w, h = SIZES[name]
    return jax_compile_scene(JaxSceneFile.from_json_dict(_doc(name)),
                             width=w, height=h)


# (job, scene, MultiChipRenderer keywords; "ranks": the spawn's ranks that
# make the layout's world, all of them by default).
JOBS = [
    ("px4", "fow11", dict(sp=1)),
    ("px2sp2", "fow11", dict(sp=2)),
    ("px2-sub", "fow11", dict(sp=1, ranks=(2, 3))),
    ("sc2", "fow11", dict(sp=1, sc=2)),
    ("sc4", "fow11", dict(sp=1, sc=4)),
    ("sc3", "fow11", dict(sp=1, sc=3, ranks=(0, 1, 2))),
    ("fused-px4", "fow11", dict(sp=1, use_megakernel=True)),
    ("fused-px2sp2", "fow11", dict(sp=2, use_megakernel=True)),
    # 5 rows over 4 ranks: slabs of 2, the last wholly past the frame.
    ("px4-h5", "fow5", dict(sp=1)),
    ("fused-px4-h5", "fow5", dict(sp=1, use_megakernel=True)),
    ("tri-sc4", "tri", dict(sp=1, sc=4)),
    ("tri-sc3", "tri", dict(sp=1, sc=3, ranks=(1, 2, 3))),
    ("cornell-sc2", "cornell", dict(sp=1, sc=2, ranks=(0, 1))),
    ("ellipsoid-tri-sc2", "ellipsoid-tri", dict(sp=1, sc=2, ranks=(2, 3))),
    ("jax-px2", "fow18", dict(sp=1, ranks=(0, 1))),
    ("jax-px2sp2", "fow18", dict(sp=2)),
    ("jax-sc2", "fow18", dict(sp=1, sc=2, ranks=(0, 1))),
    ("jax-sc3", "fow18", dict(sp=1, sc=3, ranks=(0, 1, 2))),
]
REFUSALS = [
    ("bvh", "tri", dict(sp=1, sc=2, ranks=(0, 1), use_bvh=True)),
    ("paged", "tri", dict(sp=1, sc=2, ranks=(0, 1), use_bvh="paged")),
    ("registry", "registry", dict(sp=1, sc=2, ranks=(0, 1))),
]


def _session(tmp, rank, ranks, fn):
    """fn() in a gloo process group over ``ranks`` of the spawn, on the
    ranks in it."""
    if rank not in ranks:
        return
    dist = torch.distributed
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/init-{'-'.join(map(str, ranks))}",
            rank=ranks.index(rank), world_size=len(ranks))
    except Exception as e:
        e.add_note(f"the process group of ranks {ranks}, on rank {rank}")
        raise
    try:
        fn()
    finally:
        dist.destroy_process_group()


def _work(rank, tmp, port):
    """Every job this rank takes part in: {job: (image, rays, path,
    layout)}, the refusals' messages, a resumed render, and a render from
    torchrun's environment.  The jobs on one set of ranks share one
    process group, made once (each its own layout's groups in it): the
    observed gloo failures came at a process group's rendezvous."""
    out, refused, cs = {}, {}, {}
    by_ranks = {}
    for job, scene, kw in JOBS + REFUSALS:
        kw = dict(kw)
        by_ranks.setdefault(tuple(kw.pop("ranks", range(WORLD))),
                            []).append((job, scene, kw))

    def render(jobs):
        for job, scene, kw in jobs:
            if scene not in cs:
                cs[scene] = _cs(scene)
            try:
                r = mc.MultiChipRenderer(cs[scene], device="cpu", **kw)
            except ValueError as e:
                refused[job] = str(e)
                continue
            except Exception as e:
                e.add_note(f"job {job}")
                raise
            img = r.render_all()
            out[job] = (img, r.stats.rays_traced, r.path,
                        (r.layout.px, r.layout.sp, r.layout.sc))

    def resume():
        # Checkpoint and resume on px=2, sp=2: every rank reads the file
        # the lead rank wrote.
        first = mc.MultiChipRenderer(cs["fow11"], device="cpu", sp=2)
        first.render_next_batch()
        path = os.path.join(tmp, "ck.npz")
        first.save_checkpoint(path)
        resumed = mc.MultiChipRenderer(cs["fow11"], device="cpu", sp=2)
        resumed.load_checkpoint(path)
        assert resumed.current_batch == 1
        out["resumed"] = (resumed.render_all(), None, None, None)

    # The same order on every rank (dicts keep it).
    for ranks, jobs in by_ranks.items():
        everyone = ranks == tuple(range(WORLD))
        _session(tmp, rank, ranks, lambda jobs=jobs, everyone=everyone: (
            render(jobs), everyone and resume()))
    if rank < 2:
        out["torchrun-px2"] = _torchrun_render(rank, port, cs["fow11"])
    return out, refused


def _torchrun_render(rank, port, compiled):
    """Ranks 0 and 1 of 2 from torchrun's environment, with no process
    group made first, rendering on the CPU where CUDA is reported (its
    set_device refused): (image, rays, (path, backend), layout).  As
    under torchrun, the launcher hosts the store (the fixture's, on a port
    it bound itself: a port picked free and bound later may be taken by
    then, by another process's gloo listener)."""
    dist = torch.distributed
    env = dict(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               TORCHELASTIC_USE_AGENT_STORE="True")
    saved = torch.cuda.is_available, torch.cuda.set_device

    def no_card(*_):
        raise AssertionError("a CPU render set a card")

    os.environ.update(env)
    torch.cuda.is_available, torch.cuda.set_device = (lambda: True), no_card
    try:
        r = mc.MultiChipRenderer(compiled, device="cpu", sp=1)
        backend = dist.get_backend()
        img = r.render_all()
        return (img, r.stats.rays_traced, (r.path, backend),
                (r.layout.px, r.layout.sp, r.layout.sc))
    finally:
        torch.cuda.is_available, torch.cuda.set_device = saved
        for k in env:
            del os.environ[k]
        if dist.is_initialized():
            dist.destroy_process_group()


def _worker(rank, tmp, port, results):
    try:
        torch.set_num_threads(1)
        results.put((rank, _work(rank, tmp, port), None))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, None, traceback.format_exc()))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank's results, by rank."""
    tmp = tmp_path_factory.mktemp("gloo")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # The torchrun job's store, hosted here as torchrun's agent hosts it.
    store = torch.distributed.TCPStore("127.0.0.1", 0, is_master=True,
                                       wait_for_workers=False)
    procs = [ctx.Process(target=_worker,
                         args=(r, str(tmp), store.port, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    out, errs = {}, []
    try:
        for _ in procs:
            rank, res, err = results.get(timeout=JOIN_SECONDS)
            if err is not None:
                errs.append(f"rank {rank} failed:\n{err}")
            out[rank] = res
    except queue.Empty:
        errs.append(f"the ranks did not finish in {JOIN_SECONDS} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    if errs:
        # Every rank's failure: one rank's is often another's effect.
        pytest.fail("\n".join(errs))
    return out


def _job(spawned, job):
    """The job's (image, rays, path, layout) after checking every rank
    that took part holds the same image."""
    ranks = [r for r in spawned if job in spawned[r][0]]
    assert ranks, job
    first = spawned[ranks[0]][0][job]
    for r in ranks[1:]:
        assert spawned[r][0][job][0].tobytes() == first[0].tobytes()
    return first


@functools.lru_cache(maxsize=None)
def _single(scene, fused=False):
    r = Renderer(_cs(scene), device="cpu", use_megakernel=fused or None)
    img = r.render_all()
    return img, r.stats.rays_traced, r.path


@pytest.mark.parametrize("job,scene,fused,layout", [
    ("px4", "fow11", False, (4, 1, 1)),
    ("px2-sub", "fow11", False, (2, 1, 1)),
    ("sc2", "fow11", False, (2, 1, 2)),
    ("sc4", "fow11", False, (1, 1, 4)),
    ("sc3", "fow11", False, (1, 1, 3)),
    ("fused-px4", "fow11", True, (4, 1, 1)),
    ("px4-h5", "fow5", False, (4, 1, 1)),
    ("fused-px4-h5", "fow5", True, (4, 1, 1)),
    ("tri-sc4", "tri", False, (1, 1, 4)),
    ("tri-sc3", "tri", False, (1, 1, 3)),
    ("cornell-sc2", "cornell", False, (1, 1, 2)),
    ("ellipsoid-tri-sc2", "ellipsoid-tri", False, (1, 1, 2)),
])
def test_px_and_sc_shards_give_the_single_device_bytes(spawned, job, scene,
                                                       fused, layout):
    img, rays, path, lay = _job(spawned, job)
    ref, ref_rays, ref_path = _single(scene, fused)
    assert lay == layout and path == ref_path
    assert path == ("fused" if fused else "wavefront")
    assert rays == ref_rays
    assert img.tobytes() == ref.tobytes()


@pytest.mark.parametrize("job,fused", [("px2sp2", False),
                                       ("fused-px2sp2", True)])
def test_sp_split_within_its_tolerance(spawned, job, fused):
    img, rays, path, lay = _job(spawned, job)
    ref, ref_rays, _ = _single("fow11", fused)
    assert lay == (2, 2, 1) and rays == ref_rays
    np.testing.assert_allclose(img, ref, rtol=0, atol=SP_ATOL)


def test_torchrun_environment_on_the_cpu_takes_gloo(spawned):
    """torchrun's environment and device "cpu": a gloo group and no card,
    where CUDA is reported too; the single-device render's bytes."""
    img, rays, (path, backend), lay = _job(spawned, "torchrun-px2")
    ref, ref_rays, _ = _single("fow11")
    assert backend == "gloo" and lay == (2, 1, 1) and path == "wavefront"
    assert rays == ref_rays and img.tobytes() == ref.tobytes()


def test_resume_on_the_ranks_is_byte_identical(spawned):
    resumed = _job(spawned, "resumed")[0]
    one_shot = _job(spawned, "px2sp2")[0]
    assert resumed.tobytes() == one_shot.tobytes()


@pytest.mark.parametrize("job,match", [
    ("bvh", "not a BVH or a paged soup"),
    ("paged", "not a BVH or a paged soup"),
    ("registry", "fat shading rows"),
])
def test_scene_sharding_refusals(spawned, job, match):
    for r in (0, 1):
        assert match in spawned[r][1][job]


@pytest.mark.parametrize("job,mesh", [
    ("jax-px2", dict(n=2, sp=1)),
    ("jax-px2sp2", dict(n=4, sp=2)),
    ("jax-sc2", dict(n=2, sp=1, sc=2)),
    ("jax-sc3", dict(n=3, sp=1, sc=3)),
])
def test_matches_jax_multichip(spawned, job, mesh):
    img, rays, _, lay = _job(spawned, job)
    mesh = dict(mesh)
    n = mesh.pop("n")
    j = JaxMultiChip(_jcs("fow18"), mesh=make_mesh(jax.devices()[:n],
                                                   **mesh))
    assert tuple(dict(j.mesh.shape).get(a, 1) for a in ("px", "sp", "sc")) \
        == lay
    j_img = np.asarray(j.render_all())
    mdiff = np.abs(img.mean((0, 1)) - j_img.mean((0, 1))).max()
    rmse = float(np.sqrt(np.mean((img - j_img) ** 2)))
    assert mdiff <= MEAN_TOL, f"channel means differ by {mdiff}"
    assert rmse <= RMSE_TOL, f"RMSE {rmse}"
    assert abs(rays - j.rays_traced) <= RAY_TOL * j.rays_traced


@pytest.mark.parametrize("n", range(1, 9))
def test_make_layout_matches_jax_make_mesh(n):
    for sp in (None, 1, 2, 3, 4):
        for sc in (None, 1, 2, 3, 4):
            try:
                shape = dict(make_mesh(jax.devices()[:n], sp=sp,
                                       sc=sc).shape)
            except ValueError:
                with pytest.raises(ValueError):
                    mc.make_layout(n, sp, sc)
                continue
            want = (shape["px"], shape["sp"], shape.get("sc", 1))
            assert mc.make_layout(n, sp, sc) == want


def test_layout_groups():
    lay = mc.Layout.of(5, 2, 2, 2)
    # rank = (px_i * sp + sp_i) * sc + sc_i
    assert (lay.px_i, lay.sp_i, lay.sc_i) == (1, 0, 1)
    assert lay.group_ranks("p") == (5, 7)
    assert lay.group_ranks("x") == (1, 5)
    assert lay.group_ranks("c") == (4, 5)
    assert lay.group_ranks("xp") == (1, 3, 5, 7)
    assert lay.group_ranks("xpc") == tuple(range(8))


@pytest.mark.parametrize("n_sc", [2, 3, 4])
@pytest.mark.parametrize("scene", ["fow11", "tri", "cornell"])
def test_scene_sharding_matches_jax_bit_for_bit(scene, n_sc):
    jcs = _jcs(scene)
    jscene, _ = jax_upload_scene(jcs)
    tscene, _ = upload_scene(from_jax_compiled(jcs), "cpu")
    jst = jmc.shard_scene_arrays(jscene, n_sc)
    tst = mc.shard_scene_arrays(tscene, n_sc)
    for f in mc._SC_SHARDED:
        a, b = np.asarray(getattr(jst, f)), getattr(tst, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f
    times = np.array([0.25, 0.75], np.float32)
    jt = jax_world_sphere_tables(jcs, times)
    tt = world_sphere_tables(from_jax_compiled(jcs), times)
    a, b = jmc.shard_sphere_tables(jt, n_sc), mc.shard_sphere_tables(tt, n_sc)
    assert a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("rows", [1, 5, 8, 9])
def test_pad_dup_matches_jax(rows):
    a = np.random.default_rng(rows).normal(size=(rows, 3)).astype(np.float32)
    for n in (1, 2, 3, 4):
        want = jmc._pad_dup(a, n)
        assert mc._pad_dup(a, n).tobytes() == want.tobytes()
        assert mc._pad_dup(torch.tensor(a), n).numpy().tobytes() == \
            want.tobytes()


def test_world_of_one_is_the_renderer():
    """Without a process group the renderer is one rank: the Renderer's
    bytes, stepped and in a fused chunk."""
    for fused in (False, True):
        r = mc.MultiChipRenderer(_cs("fow11"), device="cpu",
                                 use_megakernel=fused or None)
        assert (r.layout.px, r.layout.sp, r.layout.sc) == (1, 1, 1)
        assert r.path == ("fused" if fused else "wavefront")
        assert r.render_batches(2) == 2
        assert r.image().tobytes() == _single("fow11", fused)[0].tobytes()


def test_resize_keeps_the_sharded_renderer():
    r = mc.MultiChipRenderer(_cs("fow11"), device="cpu")
    r.render_next_batch()
    small = r.update_image_size(16, 9)
    assert isinstance(small, mc.MultiChipRenderer)
    assert (small.static.width, small.static.height) == (16, 9)
    assert small.current_batch == 0 and small.layout == r.layout


def test_checkpoints_cross_with_jax_multichip(tmp_path):
    """A JAX MultiChipRenderer checkpoint resumes in the port's, and the
    port's in the JAX one, in the Renderer's npz."""
    jcs = _jcs("fow18")
    j = JaxMultiChip(jcs, mesh=make_mesh(jax.devices()[:2], sp=1))
    j.render_next_batch()
    j.save_checkpoint(str(tmp_path / "jax"))
    port = mc.MultiChipRenderer(from_jax_compiled(jcs), device="cpu")
    port.load_checkpoint(str(tmp_path / "jax"))
    assert port.current_batch == 1
    assert port.image().tobytes() == np.asarray(j.image()).tobytes()
    assert port.render_next_batch() and not port.render_next_batch()
    j.render_next_batch()
    rmse = float(np.sqrt(np.mean((port.image() - np.asarray(j.image())) ** 2)))
    assert rmse <= RMSE_TOL

    port2 = mc.MultiChipRenderer(from_jax_compiled(jcs), device="cpu")
    port2.render_next_batch()
    port2.save_checkpoint(str(tmp_path / "port.npz"))
    j2 = JaxMultiChip(jcs, mesh=make_mesh(jax.devices()[:2], sp=1))
    j2.load_checkpoint(str(tmp_path / "port.npz"))
    assert j2.current_batch == 1
    assert np.asarray(j2.image()).tobytes() == port2.image().tobytes()


def test_cli_multichip_and_scene_shards(tmp_path):
    scene = tmp_path / "fow.json"
    doc = _doc("fow11")
    scene.write_text(json.dumps(doc))
    base = ["render", "--path", str(scene), "--width", "20", "--height",
            "11", "--device", "cpu", "-o", str(tmp_path / "out.png")]
    assert cli.main(base + ["--scene-shards", "0"]) == 2
    assert cli.main(base + ["--scene-shards", "2"]) == 2
    # One rank cannot hold two scene shards (make_layout refuses).
    assert cli.main(base + ["--multichip", "--scene-shards", "2"]) == 2
    ck = str(tmp_path / "ck.npz")
    assert cli.main(base + ["--multichip", "--checkpoint", ck]) == 0
    assert (tmp_path / "out.png").stat().st_size > 0
    data = np.load(ck)
    assert int(data["current_batch"]) == 2
    ref = Renderer(dataclasses.replace(_cs("fow11")), device="cpu")
    assert data["accum"].tobytes() == ref.render_all().tobytes()
