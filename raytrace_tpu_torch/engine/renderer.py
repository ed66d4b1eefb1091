"""Progressive batched rendering with a running mean, checkpoint/resume
and PNG export (raytrace_tpu/engine/renderer.py).

Each ``render_next_batch`` traces one sample batch and folds it into the
running mean (ray_gen.glsl:597-603); ``render_batches(k)`` renders k
batches, on the fused path in one kernel launch; ``render_all`` drives
every batch in chunks of ``chunk_size()``.  A checkpoint is the JAX
package's npz (accumulation image, batch index, resolution), so a render
started there resumes here.

Two paths render a batch, as in the JAX package: the fused bounce kernel
(ops/megakernel.py) for every scene its gate admits, and the torch
wavefront (engine/wavefront.py, with the sphere and triangle sweep
kernels) for the rest.  ``use_megakernel`` picks: None takes the fused
kernel on a CUDA device when the gate admits the scene and the wavefront
on the CPU; True takes the fused path wherever the gate admits the scene
(on the CPU its plain version); False always takes the wavefront.

``path`` names what the scene gets, from facts about it:

- ``"fused"``: a static scene; a chunk of batches is one launch.
- ``"fused_anim"``: spheres that move on straight lines at a constant
  radius, and no triangles or lights; one geometry (the spheres at
  shutter time 0 and their motion) serves every batch, the kernel moves
  them to each batch's time, and a chunk is one launch.
- ``"fused_per_batch"``: other motion, and any motion in a scene with
  triangles, lights or image textures; one launch per batch, each from
  that batch's world table, soup, instance transforms and spheres'
  world-to-object rows (the JAX renderer's ``step`` scan).
- ``"wavefront"``: per-batch world tables, one batch at a time.

A static scene's triangle soup goes to world space once; an animated
one's at every batch's time.  The instance transforms that move a light
sample (the hit-instance quirk, ops/nee.py) come with the soup, or, in a
scene without triangles, at each batch's time.

``use_bvh`` picks how the wavefront traces triangles, as in the JAX
package: ``"auto"`` keeps the soup in its compiled order up to
``triangle_ceiling``, where K2 walks the soup's own tree
(ops/paged_tri.build_soup_tree, the JAX package's dense sweep there), and
takes the paged sweep (K3, ops/paged_tri.py) above it; ``"paged"`` takes
the paged sweep at any size; ``False`` keeps the compiled order, and K2
walks its own tree, at any size; ``True`` builds the binned-SAH BVH of
the native builder (models/bvh_build.build_bvh_sah, leaves of at most 8),
or where that library cannot be built the implicit Morton BVH over leaves
of ``leaf_size`` (build_bvh), puts the soup in its order and walks it
with H1 (ops/bvh.py; ``static.bvh_mode`` "sah" or "implicit").  The paged
sweep first puts the soup in Morton order (``paged_soup``); the fused
kernel refuses a soup in either order, so the scene renders on the
wavefront (path ``"wavefront"``).  Where the port differs from JAX: on the
CPU the JAX Renderer traces a big mesh through its SAH BVH under
``"auto"``, while the port takes K3's plain version there too.

A scene whose material graph the fat shading row cannot encode
(models/shading_table.py ComplexMaterial: a checker on a non-albedo
property, two checkers on one material, a nested checker, a metal fuzz
that is not constant) has no ``shade_rows``; the fused kernel's gate
refuses it, as the JAX gate does, and it renders on the wavefront with
registry shading (ops/materials.py).

A Renderer given a ``split`` (``FrameSplit``; parallel/multichip.RankSplit)
renders one part of every batch, a slab of rows and a run of each pixel's
samples, and joins the parts through the split's hooks at every step, so
the sharded renderer steps through this one loop.

A Renderer given a ``shard`` (parallel/multichip.SceneShard) holds one
slice of the scene's primitives, as a rank of the "sc" axis of the
sharded renderer does: every table of spheres and triangles, their shading
rows and world tables are cut to the slice, the trees are built over it,
and the wavefront combines the slices' closest hits at every bounce
(engine/wavefront.py); such a scene renders on the wavefront, with its
soup in its compiled order, and needs its fat shading rows.

Spheres whose instances all map them to spheres (a uniform scale) have
world-space tables (``sphere_world_mode``); a scene with a non-uniform
scale (ellipsoids) has none, and its spheres are swept in object space
by H2 (ops/sphere_obj.py) on the wavefront, which the fused kernel's gate
sends it to: the dense prefix, then a tree over the world boxes of the
rest, built once where no sphere instance moves, else every batch.

The JAX Renderer's app-layer options are here too: ``camera_name`` renders
through a camera other than the scene's own; ``metrics_jsonl`` appends a
``utils/profiling.BatchMetrics`` line a batch; ``max_depth``, an attribute
set at any time, limits the bounces from the next step on; ``debug``
scans the accumulation after every step (``DebugStats``) and raises
``DebugValidationError`` on a non-finite, negative or over-bright value.

Each layer boundary is a span of the program's tracer
(utils/profiling.py; ``profiling.spans()`` reads them): ``renderer.init``
around the constructor, with one child for each of its phases
(``world_tables``, tagged with the tables it computes: every batch
time's where a sphere instance moves, else the first's; ``upload``,
``bvh``, ``tris``, ``sphere_tree``, ``object_tree``, ``anim_geom``);
``renderer.step`` around each step, tagged with the Renderer's serial
number, its first batch, its batch count and its path, with children
``geometry`` (the bytes of the batch's sphere table copied to the card),
``launch``, ``wait`` (the host waiting on the card: for the fused
kernel's ray count, and the step's final synchronize), ``accumulate``
and, with ``debug``, ``debug``; a static scene's other world tables are
``renderer.step.world_table`` spans tagged with their batch: the next
step's, between ``launch`` and ``wait``, or the step's own, inside
``geometry`` where it was not built ahead; then
``renderer.step.record``, which books the step span's seconds into
``stats`` and ``metrics``; ``renderer.readback`` around ``image()``.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.bvh_build import build_bvh, build_bvh_sah, permute_soup
from ..models.compile import CompiledScene
from ..ops import camera as cam_ops
from ..ops import bvh as bvh_ops
from ..ops import megakernel, paged_tri, sphere_obj, sphere_sweep, sphere_tree
from ..ops.spheres import world_sphere_anim_tables, world_sphere_tables
from ..tools.chacha import ChaCha20Rng
from ..utils.image import write_png
from ..utils.profiling import BatchMetrics, span
from .arrays import SceneStatic, pack_atlas, scene_static, upload_scene
from .wavefront import (make_trace_fn, object_table, prepare_batch,
                        prepare_tris, render_tile, sphere_prefix, world_soup)

# The reference seeds its host RNG with this value (render_engine.rs:116);
# it drives the batch-time jitter stream.
HOST_SEED = 485_674_845_675_491

# Rays per tile: a whole 1200x675x4 frame is one tile, which fills the card
# and keeps the host's per-bounce loop overhead to one pass per frame.  The
# paged sweep keeps it: the JAX package's smaller paged tiles (1 << 19,
# raytrace_tpu/engine/renderer.py:495-500) exist for its kernel's scratch
# cap, which K3 does not have.
RAY_BUDGET = 1 << 22

# Triangles a scene may have when the fused kernel does not take it in
# clusters: the JAX Renderer's dense-sweep ceiling (tri_fast_max,
# raytrace_tpu/engine/renderer.py:341-350); above it, and above the fused
# kernel's own ceiling, "auto" takes the paged sweep.
DENSE_SWEEP_MAX_TRIANGLES = 8192

# The serial numbers of the process's Renderers, which tag their spans.
_SERIALS = itertools.count()


def get_batch_ray_times(sample_batches: int,
                        seed: int = HOST_SEED) -> np.ndarray:
    """Jittered stratified shutter times over [0, 1] (render_engine.rs:
    700-710), drawn from the reference's ChaCha20 stream."""
    rng = ChaCha20Rng.seed_from_u64(seed)
    f = np.float32
    d = f(1.0) / f(sample_batches)
    out = []
    for i in range(sample_batches):
        t_center = (f(i) + f(0.5)) * d
        jitter = f(rng.f32_range(-0.5, 0.5))
        out.append(np.clip(t_center + jitter * d, f(0.0), f(1.0)))
    return np.asarray(out, np.float32)


def triangle_ceiling(static: SceneStatic) -> int:
    """The most triangles the port renders a scene with: the fused kernel's
    ceiling for a clustered soup when its gate admits the scene, else the
    dense sweep's (the JAX Renderer's rule, decided by the one gate,
    ops/megakernel.megakernel_supported)."""
    if static.tri_cluster_g > 0 and megakernel.megakernel_supported(static):
        return megakernel.MAX_TRIANGLES
    return DENSE_SWEEP_MAX_TRIANGLES


def bvh_mode(static: SceneStatic, use_bvh="auto") -> str:
    """How the scene's triangles are traced: "paged", "sah" (use_bvh=True:
    the SAH BVH, which the Renderer replaces by "implicit" where the
    native builder is unavailable) or "none" (the soup in its compiled
    order: K2's walk of its own tree, or the fused kernel's).  ``static``
    has ``bvh_mode`` "none"; "auto" pages a soup above ``triangle_ceiling``
    (raytrace_tpu/engine/renderer.py:331-386)."""
    if use_bvh not in ("auto", "paged", False, True):
        raise ValueError(f"use_bvh must be 'auto', 'paged', True or False, "
                         f"not {use_bvh!r}")
    if not static.has_tris or use_bvh is False:
        return "none"
    if use_bvh is True:
        return "sah"
    if use_bvh == "paged" or static.num_triangles > triangle_ceiling(static):
        return "paged"
    return "none"


def paged_soup(cs: CompiledScene) -> CompiledScene:
    """``cs`` with its soup in the paged sweep's order: the Morton order
    of the real triangles' world centroids at shutter time 0.5, the
    padding rows kept at the end (raytrace_tpu/engine/renderer.py:
    359-374).  A triangle's id is its row in the result.  On a soup
    already in that order the order is the identity."""
    n = cs.num_triangles
    order = paged_tri.paged_tri_order(paged_tri.world_soup_mid(cs), n)
    return permute_soup(cs, np.concatenate(
        [order, np.arange(n, cs.tri_p.shape[0])]))


def _debug_scan(accum: torch.Tensor):
    """The per-step validation reduction: (non-finite values, negative
    values, the largest finite value) of the accumulation, read back in
    one copy."""
    finite = torch.isfinite(accum)
    clean = torch.where(finite, accum, 0.0)
    nonf, neg, mx = torch.stack([
        (~finite).sum().double(), (clean < 0.0).sum().double(),
        clean.max().double()]).tolist()
    return int(nonf), int(neg), mx


@dataclass
class DebugStats:
    """``debug=True`` counters, the validation-layer analogue of the
    reference's Vulkan debug callback (bin/src/app.rs:317-369): every
    step's accumulation is scanned for non-finite, negative and
    energy-violating radiance."""
    checks: int = 0
    nonfinite_values: int = 0
    negative_values: int = 0
    max_radiance: float = 0.0
    energy_bound: float = 0.0


class DebugValidationError(RuntimeError):
    pass


@dataclass
class RenderStats:
    batches_done: int = 0
    rays_traced: int = 0
    render_seconds: float = 0.0

    @property
    def mrays_per_sec(self) -> float:
        if self.render_seconds <= 0:
            return 0.0
        return self.rays_traced / self.render_seconds / 1e6


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class FrameSplit:
    """How a Renderer shares every batch with others
    (parallel/multichip.RankSplit): the image's rows cut into ``px`` slabs
    of ceil(H / px) rows, this one the ``px_i``-th (its rows past the frame
    are zero), and each pixel's samples into ``sp`` runs,
    this one the ``sp_i``-th.  Its hooks join the parts at every step:
    ``reduce_samples`` sums a slab's sample sums over the runs,
    ``gather_rows`` stacks the slabs in row order, ``sum_rays`` adds up the
    rays traced.  This one is the whole frame, its hooks the identity."""

    px = sp = 1
    px_i = sp_i = 0

    def reduce_samples(self, slab: torch.Tensor) -> torch.Tensor:
        return slab

    def gather_rows(self, slab: torch.Tensor) -> torch.Tensor:
        return slab

    def sum_rays(self, rays: int) -> int:
        return rays


class WorldTables:
    """A static scene's world sphere tables, one a batch time, as a
    sequence: ``tables[b]`` is ops/spheres.world_sphere_tables' table at
    batch time b (cut by ``at``, which maps [k] times to [k, S, 5]
    tables), computed on its first read in a ``renderer.step.world_table``
    span and kept.  Each is the very table a list of every batch time
    holds, so no step reads another batch's."""

    def __init__(self, at, times: np.ndarray, first: np.ndarray):
        self._at, self._times = at, times
        self._built = {0: first}

    def __len__(self) -> int:
        return len(self._times)

    def built(self, batch: int) -> bool:
        return batch in self._built

    def __getitem__(self, batch: int) -> np.ndarray:
        batch = range(len(self._times))[batch]
        table = self._built.get(batch)
        if table is None:
            with span("renderer.step.world_table", batch=batch):
                table = self._at(self._times[batch:batch + 1])[0]
            self._built[batch] = table
        return table


class Renderer:
    # Batches fused into one kernel launch by render_all and the CLI.
    CHUNK = 12

    def __init__(self, compiled: CompiledScene, device="cuda",
                 use_megakernel: Optional[bool] = None, use_bvh="auto",
                 leaf_size: int = 4, shard=None,
                 split: Optional[FrameSplit] = None,
                 camera_name: Optional[str] = None,
                 metrics_jsonl: Optional[str] = None, debug: bool = False):
        # Kept so update_image_size rebuilds with the same options.
        self._ctor_kwargs = dict(device=torch.device(device),
                                 use_megakernel=use_megakernel,
                                 use_bvh=use_bvh, leaf_size=leaf_size,
                                 shard=shard, split=split,
                                 camera_name=camera_name,
                                 metrics_jsonl=metrics_jsonl, debug=debug)
        self.serial = next(_SERIALS)
        with span("renderer.init", renderer=self.serial):
            self._build(compiled, **self._ctor_kwargs)

    def _build(self, compiled: CompiledScene, device, use_megakernel,
               use_bvh, leaf_size, shard, split, camera_name, metrics_jsonl,
               debug) -> None:
        self.device = device
        self.shard = shard
        self.split = split = split or FrameSplit()
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; rendering on the CPU must be asked "
                "for with device='cpu'")
        self.batch_times = get_batch_ray_times(compiled.render.sample_batches)

        def tables_at(times):
            tables = world_sphere_tables(compiled, times)
            if tables is None or shard is None:
                return tables
            return shard.tables(tables)

        # World-space sphere tables per batch time (host f64 -> f32, the
        # shard's slice), or None where a non-uniform scale makes an
        # ellipsoid: the spheres are then swept in object space.  Where a
        # sphere instance moves, every batch time's now; else the first
        # now, which decides the mode, and each other on its first read
        # (WorldTables; the step before builds it while the card runs).
        inst = compiled.sph_inst[:compiled.num_spheres]
        moving = (compiled.inst_t0[inst].tobytes()
                  != compiled.inst_t1[inst].tobytes())
        times = self.batch_times if moving else self.batch_times[:1]
        with span("renderer.init.world_tables", tables=len(times)):
            self.sphere_tables = tables_at(times)
        if self.sphere_tables is not None and not moving:
            self.sphere_tables = WorldTables(tables_at, self.batch_times,
                                             self.sphere_tables[0])
        world_mode = self.sphere_tables is not None
        with span("renderer.init.upload"):
            static = dataclasses.replace(scene_static(compiled),
                                         sphere_world_mode=world_mode)
        if shard is not None:
            # raytrace_tpu/parallel/multichip.py:374-375, :424-426.
            if use_bvh is True or use_bvh == "paged":
                raise ValueError("scene sharding (sc > 1) shards the soup in "
                                 "its compiled order, not a BVH or a paged "
                                 "soup")
            if not static.use_fat_shading:
                raise ValueError("scene sharding needs the fat shading rows "
                                 "(shade_rows)")
            use_bvh = use_megakernel = False
        mode = bvh_mode(static, use_bvh)
        # The BVH of use_bvh=True (raytrace_tpu/engine/renderer.py:375-386):
        # the native SAH builder's, else the implicit tree's; the soup is
        # put in its order.
        self.bvh = None
        if mode == "paged":
            with span("renderer.init.bvh"):
                compiled = paged_soup(compiled)
        elif mode == "sah":
            with span("renderer.init.bvh"):
                self.bvh = build_bvh_sah(compiled, leaf_max=8)
                if self.bvh is None:
                    self.bvh = build_bvh(compiled, leaf_size=leaf_size)
                if bvh_ops.wide_stack(self.bvh.depth) > bvh_ops.MAX_STACK:
                    raise ValueError(
                        f"a BVH of depth {self.bvh.depth}: its walk's stack "
                        f"would outgrow the kernel's {bvh_ops.MAX_STACK}")
                compiled = permute_soup(compiled, self.bvh.order)
            mode = self.bvh.mode
        with span("renderer.init.upload"):
            self.scene, static = upload_scene(compiled, self.device,
                                              self.bvh)
        self.static = dataclasses.replace(static, sphere_world_mode=world_mode,
                                          bvh_mode=mode)
        if shard is not None:
            # The slice's primitives (its world tables are cut above); the
            # static facts that differ by slice are its counts.
            self.scene = shard.scene(self.scene)
            self.static = shard.static(self.static, self.scene)
        self.compiled = compiled
        if use_megakernel is None:
            use_megakernel = self.device.type == "cuda"
        self.use_megakernel = bool(use_megakernel) and (
            megakernel.megakernel_supported(self.static))
        # The fused kernel's copy of the image atlas, packed once.
        self._atlas_words = (pack_atlas(self.scene.atlas)
                             if self.use_megakernel
                             and self.static.flags.has_image else None)
        # Every batch's shutter time, read by the animated fused kernel.
        self.batch_times_dev = torch.tensor(self.batch_times,
                                            device=self.device)
        # A static soup in world space, built once (at the first batch's
        # time, where the JAX package's first chunk builds it).  A moving
        # soup outside the paged sweep keeps the Morton order of its tree
        # from that time, on the host once, and re-fits the tree each batch.
        self._tris = self._tri_order = None
        if self.static.has_tris and not self.static.any_animated:
            with span("renderer.init.tris"):
                self._tris = prepare_tris(self.static, self.scene,
                                          self.batch_times_dev[0])
        elif (self.static.has_tris and mode == "none"
              and self.static.num_triangles > 0):
            with span("renderer.init.tris"):
                _, world_p, _ = world_soup(self.scene,
                                           self.batch_times_dev[0])
                self._tri_order = paged_tri.soup_order(
                    world_p, self.static.num_triangles)
        # The tree over the spheres past the dense prefix, where the path
        # walks one (the fused kernel's clustered forms, or K1 on the
        # wavefront): their Morton order at shutter time 0.5, on the host
        # once; for a static scene the whole tree once, over the first
        # batch's table (every batch's).  A moving scene's tree is built
        # each batch over that batch's table, in this order.
        self._sph_order = self._sph_tree = None
        n_prefix = (sphere_prefix(self.static, self.use_megakernel)
                    if world_mode else None)
        if n_prefix is not None:
            with span("renderer.init.sphere_tree"):
                self._sphere_tree(tables_at, n_prefix)
        # The tree H2 walks over the world boxes of the spheres in object
        # space past the dense prefix: their Morton order at shutter time
        # 0.5, once; where no sphere instance moves, the whole tree once,
        # over the first batch's table, its boxes widened for the maps'
        # drift between batch times (each batch takes its own sphere rows
        # into it), else each batch over that batch's table.
        self._obj_order = self._obj_tree = None
        if not world_mode and self.static.num_spheres > 0:
            with span("renderer.init.object_tree"):
                self._object_tree()
        # The animated fused kernel's one geometry, built once.  Not for
        # triangles or lights, nor for image textures, whose spheres'
        # world-to-object rows change with every batch time (the JAX
        # Renderer's rule, raytrace_tpu/engine/renderer.py:462-472).
        self._anim_geom = None
        if (self.use_megakernel and self.static.any_animated
                and not (self.static.has_tris or self.static.has_lights
                         or self.static.flags.has_image)):
            with span("renderer.init.anim_geom"):
                tables = world_sphere_anim_tables(compiled)
                if tables is not None:
                    tab0, dtab8 = (torch.tensor(t, device=self.device)
                                   for t in tables)
                    self._anim_geom = prepare_batch(
                        self.static, self.scene, tab0, sph_dtab=dtab8,
                        fused=True, sph_order=self._sph_order)
        if not self.use_megakernel:
            self.path = "wavefront"
        elif not self.static.any_animated:
            self.path = "fused"
        else:
            self.path = ("fused_per_batch" if self._anim_geom is None
                         else "fused_anim")

        name = camera_name or compiled.render.camera
        if name not in compiled.cameras:
            raise KeyError(f"Camera {name} not found")
        params = compiled.cameras[name]
        self.camera = cam_ops.build_camera_arrays(
            params, self.static.width, self.static.height, self.device)
        self.use_dof = params.aperture_size > 0.0

        # This renderer's part of every batch (the split's): rows row_base
        # .. row_base + rows - 1 of a slab of rows_local, samples
        # sample_base .. sample_base + spp_local - 1 of each pixel.
        H, W = self.static.height, self.static.width
        spp = self.static.sqrt_spp ** 2
        if spp % split.sp != 0:
            raise ValueError(f"effective spp {spp} must be divisible by "
                             f"sp={split.sp}")
        self.spp_local = spp // split.sp
        self.sample_base = split.sp_i * self.spp_local
        self.rows_local = -(-H // split.px)
        self.row_base = split.px_i * self.rows_local
        self.rows = max(0, min(self.rows_local, H - self.row_base))
        # The wavefront's tiles: at most RAY_BUDGET rays, balanced so the
        # last tile is not mostly padding rows.
        budget = max(1, RAY_BUDGET // (W * self.spp_local))
        n_tiles = max(1, -(-self.rows // budget))
        self.rows_per_tile = max(1, -(-self.rows // n_tiles))

        self.accum = torch.zeros((H, W, 3), dtype=torch.float32,
                                 device=self.device)
        self.current_batch = 0
        self.stats = RenderStats()
        # The bounce limit of the next step, which may be set at any time.
        # Both paths take it at run time: K4 as its launch argument, the
        # wavefront as its loop's bound.  The JAX Renderer sends a depth
        # other than the scene's down its XLA wavefront; the port keeps K4,
        # which computes the same function at any depth.
        self.max_depth = compiled.render.max_ray_depth
        self.debug_stats = None
        if debug:
            # A loose ceiling on a sample's radiance: every added term is a
            # product of albedos (each at most 1) and one emission or the
            # sky, and NEE adds at most one light term a bounce.
            emax = max(1.0, float(compiled.const_colours.max()))
            self.debug_stats = DebugStats(
                energy_bound=emax * (self.max_depth + 2))
        self.metrics = BatchMetrics(pixels=W * H, spp=spp,
                                    jsonl_path=metrics_jsonl)

    def _sphere_tree(self, tables_at, n_prefix: int) -> None:
        """The spheres' Morton order at shutter time 0.5 (``tables_at``'s
        table there) and, for a static scene, their tree over the first
        batch's table."""
        n_sph = self.static.num_spheres
        mid = tables_at(np.array([0.5], np.float32))
        self._sph_order = torch.tensor(
            sphere_tree.sphere_order(mid[0, :, 0:3], n_prefix, n_sph),
            dtype=torch.int32, device=self.device)
        if not self.static.any_animated:
            table8 = sphere_sweep.pad_table8(torch.tensor(
                self.sphere_tables[0], device=self.device))
            self._sph_tree = sphere_tree.build_sphere_tree(
                table8, n_prefix, n_sph, self._sph_order)

    def _object_tree(self) -> None:
        """H2's order of the object-space spheres past the dense prefix
        and, where no sphere instance moves, its tree."""
        mid = object_table(self.scene, torch.tensor(
            0.5, dtype=torch.float32, device=self.device))
        n_prefix = sphere_obj.tree_prefix(self.static, mid)
        if n_prefix is None:
            return
        n_sph = min(self.static.num_spheres, mid.shape[0])
        self._obj_order = sphere_obj.object_order(mid, n_prefix, n_sph)
        inst = self.scene.sph_inst[:n_sph].long()
        if torch.equal(self.scene.inst_t0[inst], self.scene.inst_t1[inst]):
            self._obj_tree = sphere_obj.build_object_tree(
                object_table(self.scene, self.batch_times_dev[0]),
                n_sph, n_prefix, self._obj_order, static=True)

    def _geometry(self, batch: int):
        """The geometry the fused kernel or the wavefront renders batch
        ``batch`` from."""
        with span("renderer.step.geometry", h2d_bytes=0) as geom:
            if self._anim_geom is not None:
                return self._anim_geom
            table = (None if self.sphere_tables is None
                     else self.sphere_tables[batch])
            if table is not None:
                geom.attrs["h2d_bytes"] = table.nbytes
            sph_table = (None if table is None
                         else torch.tensor(table, device=self.device))
            tris = self._tris
            if self.static.has_tris and tris is None:
                tris = prepare_tris(self.static, self.scene,
                                    self.batch_times_dev[batch],
                                    self._tri_order)
            return prepare_batch(self.static, self.scene, sph_table,
                                 tris=tris,
                                 batch_time=self.batch_times_dev[batch],
                                 atlas_words=self._atlas_words,
                                 fused=self.use_megakernel,
                                 sph_order=self._sph_order,
                                 sph_tree=self._sph_tree, shard=self.shard,
                                 obj_order=self._obj_order,
                                 obj_tree=self._obj_tree)

    def _table_ahead(self, batch: int) -> None:
        """Build batch ``batch``'s world table, where it is built on first
        read and not yet, while the card runs the step just launched."""
        tables = self.sphere_tables
        if (isinstance(tables, WorldTables) and batch < len(tables)
                and not tables.built(batch)):
            tables[batch]

    def _debug_check(self, batch: int) -> None:
        """debug=True: validate the accumulation after a step (finite,
        non-negative, energy-bounded); raises DebugValidationError naming
        the step's last batch on the first violation."""
        st = self.debug_stats
        if st is None:
            return
        nonf, neg, mx = _debug_scan(self.accum)
        st.checks += 1
        st.nonfinite_values += nonf
        st.negative_values += neg
        st.max_radiance = max(st.max_radiance, mx)
        if nonf or neg:
            raise DebugValidationError(
                f"batch {batch}: {nonf} non-finite / {neg} "
                f"negative accumulation values")
        if mx > st.energy_bound:
            raise DebugValidationError(
                f"batch {batch}: radiance {mx:.3g} exceeds energy "
                f"bound {st.energy_bound:.3g}")

    def _record(self, b0: int, k: int, rays: int, dt: float) -> None:
        """Account batches b0 .. b0 + k - 1, rendered in ``dt`` seconds (the
        step span's).  Each gets one metrics record of dt / k seconds and
        rays / k rays (the remainder to the first batches), so the records
        add up to ``stats``: K4 counts a pixel's bounces over the whole
        launch, where the JAX package records each fused batch's own
        rays."""
        q, r = divmod(rays, k)
        for i in range(k):
            self.metrics.record(b0 + i, dt / k, float(q + (i < r)))
        self.current_batch += k
        self.stats.batches_done += k
        self.stats.rays_traced += rays
        self.stats.render_seconds += dt

    def _slab(self, b0: int, k: int, mean: bool):
        """Batches b0 .. b0 + k - 1 (k > 1 only on the paths that take a
        chunk in one launch) over this renderer's rows and samples: (the
        sample sums [rows_local, W, 3], or their mean with ``mean``; rays
        traced)."""
        s = self.static
        geom = self._geometry(b0)
        if self.use_megakernel:
            with span("renderer.step.launch"):
                slab, traced = megakernel.render_tile_mega(
                    s, self.scene, geom, self.camera, b0, k,
                    self.sample_base, use_dof=self.use_dof,
                    reduce_mean=mean, times=self.batch_times_dev,
                    spp_local=self.spp_local, row_base=self.row_base,
                    rows=self.rows_local, max_depth=self.max_depth)
            self._table_ahead(b0 + k)
            with span("renderer.step.wait"):
                return slab, int(traced.sum(dtype=torch.int64))
        end = self.row_base + self.rows
        tiles, rays = [], 0
        with span("renderer.step.launch"):
            trace = make_trace_fn(s, self.scene, geom)
            for row0 in range(self.row_base, end, self.rows_per_tile):
                # A tile stops where another slab's rows start; the frame's
                # last tile keeps its size, its rows past the frame cropped
                # (the JAX Renderer's tiles).
                n = (self.rows_per_tile if end == s.height
                     else min(self.rows_per_tile, end - row0))
                tile, tr = render_tile(s, self.scene, self.camera, trace,
                                       geom, b0, row0, n, self.use_dof,
                                       self.spp_local, self.sample_base,
                                       reduce_mean=mean,
                                       max_depth=self.max_depth)
                tiles.append(tile)
                rays += tr
        self._table_ahead(b0 + k)
        pad = torch.zeros((self.rows_local - self.rows, s.width, 3),
                          dtype=torch.float32, device=self.device)
        slab = torch.cat(tiles)[:self.rows] if tiles else pad[:0]
        return (torch.cat([slab, pad]) if pad.shape[0] else slab), rays

    def _step(self, b0: int, k: int) -> None:
        """Render batches b0 .. b0 + k - 1 into the running mean: this
        renderer's part, joined with the others' by the split's hooks."""
        with span("renderer.step", renderer=self.serial, b0=b0, k=k,
                  path=self.path) as step:
            spp = self.static.sqrt_spp ** 2
            mean = k == 1 and self.spp_local == spp
            slab, rays = self._slab(b0, k, mean)
            with span("renderer.step.accumulate"):
                slab = self.split.reduce_samples(slab)
                img = self.split.gather_rows(slab)[:self.static.height]
                if mean:
                    self.accum = ((float(b0) * self.accum + img)
                                  / (float(b0) + 1.0))
                else:
                    self.accum = ((float(b0) * self.accum + img / spp)
                                  / float(b0 + k))
                rays = self.split.sum_rays(rays)
            with span("renderer.step.wait"):
                _synchronize(self.device)
            if self.debug_stats is not None:
                with span("renderer.step.debug"):
                    self._debug_check(b0 + k - 1)
        with span("renderer.step.record"):
            self._record(b0, k, rays, step.seconds)

    def render_next_batch(self) -> bool:
        """Trace one sample batch; returns False when every batch is done."""
        if self.current_batch >= self.compiled.render.sample_batches:
            return False
        self._step(self.current_batch, 1)
        return True

    def render_batches(self, k: int) -> int:
        """Render up to k batches; returns how many were rendered.  On the
        "fused" and "fused_anim" paths the k batches are one kernel launch
        of k x spp samples per pixel; otherwise (and for k == 1) they are
        stepped one by one.  Static: every batch of the chunk shares batch
        b0's table; animated: the one geometry, moved to each batch's time
        in the kernel."""
        k = min(k, self.compiled.render.sample_batches - self.current_batch)
        if k <= 0:
            return 0
        if self.path not in ("fused", "fused_anim") or k == 1:
            done = 0
            while done < k and self.render_next_batch():
                done += 1
            return done
        self._step(self.current_batch, k)
        return k

    def chunk_size(self) -> int:
        """Batches per render_batches call from render_all and the CLI."""
        spp = max(1, self.static.sqrt_spp ** 2)
        return max(1, min(self.CHUNK, 256 // spp))

    def render_all(self, progress=None) -> np.ndarray:
        """Render every batch left, in chunks of ``chunk_size()``;
        ``progress(current_batch, total)`` is called after each chunk."""
        total = self.compiled.render.sample_batches
        while self.render_batches(self.chunk_size()):
            if progress is not None:
                progress(self.current_batch, total)
        return self.image()

    def image(self) -> np.ndarray:
        """Current linear-light accumulation image [H, W, 3] (float32)."""
        with span("renderer.readback",
                  d2h_bytes=self.accum.numel() * self.accum.element_size()):
            return self.accum.cpu().numpy()

    def save_png(self, path: str) -> None:
        write_png(path, self.image())

    def save_checkpoint(self, path: str) -> None:
        np.savez(path, accum=self.image(), current_batch=self.current_batch,
                 width=self.static.width, height=self.static.height)

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path if path.endswith(".npz") else path + ".npz")
        if (int(data["width"]), int(data["height"])) != (
                self.static.width, self.static.height):
            raise ValueError("Checkpoint resolution does not match scene")
        self.accum = torch.tensor(np.asarray(data["accum"], np.float32),
                                  device=self.device)
        self.current_batch = int(data["current_batch"])

    def update_image_size(self, width: int, height: int) -> "Renderer":
        """A resize restarts accumulation (render_engine.rs:397-414): returns
        a new renderer of this one's class for the new resolution with this
        one's options."""
        cs = dataclasses.replace(
            self.compiled,
            render=dataclasses.replace(self.compiled.render, width=width,
                                       height=height),
        )
        return type(self)(cs, **self._ctor_kwargs)
