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
package: ``"auto"`` takes the dense sweep (K2) up to ``triangle_ceiling``
and the paged sweep (K3, ops/paged_tri.py) above it; ``"paged"`` takes the
paged sweep at any size; ``False`` the dense sweep at any size.  The paged
sweep first puts the soup in Morton order (``paged_soup``), and the fused
kernel refuses such a soup, so the scene renders on the wavefront (path
``"wavefront"``, ``static.bvh_mode == "paged"``).  Where the port differs
from JAX: on the CPU the JAX Renderer traces a big mesh through its SAH
BVH, while the port takes K3's plain version there too; ``True`` (the SAH
or implicit BVH) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time as _time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.bvh_build import permute_soup
from ..models.compile import CompiledScene
from ..ops import camera as cam_ops
from ..ops import megakernel, paged_tri
from ..ops.spheres import world_sphere_anim_tables, world_sphere_tables
from ..tools.chacha import ChaCha20Rng
from ..utils.image import write_png
from .arrays import SceneStatic, pack_atlas, scene_static, upload_scene
from .wavefront import make_trace_fn, prepare_batch, prepare_tris, render_tile

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
    """How the scene's triangles are traced: "paged" or "none" (the dense
    sweep, or the fused kernel's clusters).  ``static`` has
    ``bvh_mode`` "none"; "auto" pages a soup above ``triangle_ceiling``
    (raytrace_tpu/engine/renderer.py:331-359)."""
    if use_bvh is True:
        raise NotImplementedError(
            "not ported yet: the SAH and implicit BVH (use_bvh=True; "
            "ROADMAP queue 1: 'SAH BVH'); use_bvh='paged' traces any soup")
    if use_bvh not in ("auto", "paged", False):
        raise ValueError(f"use_bvh must be 'auto', 'paged' or False, not "
                         f"{use_bvh!r}")
    if not static.has_tris or use_bvh is False:
        return "none"
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


def unsupported_feature(static: SceneStatic) -> Optional[str]:
    """Why this port cannot render the scene yet, naming the ROADMAP
    queue 1 item that will add it; None when it is inside the slice.
    ``static`` is the Renderer's, with ``sphere_world_mode`` set."""
    if not static.use_fat_shading:
        return ("materials beyond the fat-row encoding (ROADMAP queue 1: "
                "'Registry shading')")
    return None


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


class Renderer:
    # Batches fused into one kernel launch by render_all and the CLI.
    CHUNK = 12

    def __init__(self, compiled: CompiledScene, device="cuda",
                 use_megakernel: Optional[bool] = None, use_bvh="auto"):
        self.device = torch.device(device)
        # Kept so update_image_size rebuilds with the same options.
        self._ctor_kwargs = dict(device=self.device,
                                 use_megakernel=use_megakernel,
                                 use_bvh=use_bvh)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; rendering on the CPU must be asked "
                "for with device='cpu'")
        self.batch_times = get_batch_ray_times(compiled.render.sample_batches)
        # World-space sphere tables per batch time (host f64 -> f32).
        self.sphere_tables = world_sphere_tables(compiled, self.batch_times)
        if self.sphere_tables is None:
            raise NotImplementedError(
                "not ported yet: spheres with non-uniform scale, which need "
                "object-space intersection (ROADMAP queue 1: 'Object-space "
                "spheres')")
        static = dataclasses.replace(scene_static(compiled),
                                     sphere_world_mode=True)
        missing = unsupported_feature(static)
        if missing is not None:
            raise NotImplementedError(f"not ported yet: {missing}")
        mode = bvh_mode(static, use_bvh)
        if mode == "paged":
            compiled = paged_soup(compiled)
        self.scene, static = upload_scene(compiled, self.device)
        self.static = dataclasses.replace(static, sphere_world_mode=True,
                                          bvh_mode=mode)
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
        # time, where the JAX package's first chunk builds it).
        self._tris = None
        if self.static.has_tris and not self.static.any_animated:
            self._tris = prepare_tris(self.static, self.scene,
                                      self.batch_times_dev[0])
        # The animated fused kernel's one geometry, built once.  Not for
        # triangles or lights, nor for image textures, whose spheres'
        # world-to-object rows change with every batch time (the JAX
        # Renderer's rule, raytrace_tpu/engine/renderer.py:462-472).
        self._anim_geom = None
        if (self.use_megakernel and self.static.any_animated
                and not (self.static.has_tris or self.static.has_lights
                         or self.static.flags.has_image)):
            tables = world_sphere_anim_tables(compiled)
            if tables is not None:
                tab0, dtab8 = (torch.tensor(t, device=self.device)
                               for t in tables)
                self._anim_geom = prepare_batch(self.static, self.scene,
                                                tab0, sph_dtab=dtab8,
                                                fused=True)
        if not self.use_megakernel:
            self.path = "wavefront"
        elif not self.static.any_animated:
            self.path = "fused"
        else:
            self.path = ("fused_per_batch" if self._anim_geom is None
                         else "fused_anim")

        name = compiled.render.camera
        if name not in compiled.cameras:
            raise KeyError(f"Camera {name} not found")
        params = compiled.cameras[name]
        self.camera = cam_ops.build_camera_arrays(
            params, self.static.width, self.static.height, self.device)
        self.use_dof = params.aperture_size > 0.0

        # Tiles of at most RAY_BUDGET rays, balanced so the last tile is
        # not mostly padding rows.
        H, W = self.static.height, self.static.width
        budget = max(1, RAY_BUDGET // (W * self.static.sqrt_spp ** 2))
        n_tiles = -(-H // budget)
        self.rows_per_tile = -(-H // n_tiles)

        self.accum = torch.zeros((H, W, 3), dtype=torch.float32,
                                 device=self.device)
        self.current_batch = 0
        self.stats = RenderStats()

    def _geometry(self, batch: int):
        """The geometry the fused kernel or the wavefront renders batch
        ``batch`` from."""
        if self._anim_geom is not None:
            return self._anim_geom
        sph_table = torch.tensor(self.sphere_tables[batch], device=self.device)
        tris = self._tris
        if self.static.has_tris and tris is None:
            tris = prepare_tris(self.static, self.scene,
                                self.batch_times_dev[batch])
        return prepare_batch(self.static, self.scene, sph_table, tris=tris,
                             batch_time=self.batch_times_dev[batch],
                             atlas_words=self._atlas_words,
                             fused=self.use_megakernel)

    def _record(self, batches: int, rays: int, t0: float) -> None:
        dt = _time.perf_counter() - t0
        self.current_batch += batches
        self.stats.batches_done += batches
        self.stats.rays_traced += rays
        self.stats.render_seconds += dt

    def render_next_batch(self) -> bool:
        """Trace one sample batch; returns False when every batch is done."""
        if self.current_batch >= self.compiled.render.sample_batches:
            return False
        t0 = _time.perf_counter()
        H = self.static.height
        geom = self._geometry(self.current_batch)
        if self.use_megakernel:
            img, traced = megakernel.render_tile_mega(
                self.static, self.scene, geom, self.camera,
                self.current_batch, 1, use_dof=self.use_dof, reduce_mean=True,
                times=self.batch_times_dev)
            rays = int(traced.sum(dtype=torch.int64))
        else:
            trace = make_trace_fn(self.static, self.scene, geom)
            tiles, rays = [], 0
            for row0 in range(0, H, self.rows_per_tile):
                tile, tr = render_tile(
                    self.static, self.scene, self.camera, trace, geom,
                    self.current_batch, row0, self.rows_per_tile,
                    self.use_dof)
                tiles.append(tile)
                rays += tr
            img = torch.cat(tiles, dim=0)[:H]
        b = float(self.current_batch)
        self.accum = (b * self.accum + img) / (b + 1.0)
        _synchronize(self.device)
        self._record(1, rays, t0)
        return True

    def render_batches(self, k: int) -> int:
        """Render up to k batches; returns how many were rendered.  On the
        "fused" and "fused_anim" paths the k batches are one kernel launch
        of k x spp samples per pixel; otherwise (and for k == 1) they are
        stepped one by one."""
        k = min(k, self.compiled.render.sample_batches - self.current_batch)
        if k <= 0:
            return 0
        if self.path not in ("fused", "fused_anim") or k == 1:
            done = 0
            while done < k and self.render_next_batch():
                done += 1
            return done
        t0 = _time.perf_counter()
        b0 = self.current_batch
        # Static: every batch of the chunk shares batch b0's table.
        # Animated: the one geometry, moved to each batch's time in the
        # kernel.
        sums, traced = megakernel.render_tile_mega(
            self.static, self.scene, self._geometry(b0), self.camera, b0, k,
            use_dof=self.use_dof, times=self.batch_times_dev)
        spp = self.static.sqrt_spp ** 2
        self.accum = (float(b0) * self.accum + sums / spp) / float(b0 + k)
        rays = int(traced.sum(dtype=torch.int64))
        _synchronize(self.device)
        self._record(k, rays, t0)
        return k

    def chunk_size(self) -> int:
        """Batches per render_batches call from render_all and the CLI."""
        spp = max(1, self.static.sqrt_spp ** 2)
        return max(1, min(self.CHUNK, 256 // spp))

    def render_all(self) -> np.ndarray:
        while self.render_batches(self.chunk_size()):
            pass
        return self.image()

    def image(self) -> np.ndarray:
        """Current linear-light accumulation image [H, W, 3] (float32)."""
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
        a new Renderer for the new resolution with this one's options."""
        cs = dataclasses.replace(
            self.compiled,
            render=dataclasses.replace(self.compiled.render, width=width,
                                       height=height),
        )
        return Renderer(cs, **self._ctor_kwargs)
