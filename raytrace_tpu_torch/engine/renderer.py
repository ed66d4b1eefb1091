"""Progressive batched rendering with a running mean, checkpoint/resume
and PNG export (raytrace_tpu/engine/renderer.py).

Each ``render_next_batch`` traces one sample batch and folds it into the
running mean (ray_gen.glsl:597-603); ``render_all`` drives every batch.  A
checkpoint is the JAX package's npz (accumulation image, batch index,
resolution), so a render started there resumes here.
"""

from __future__ import annotations

import dataclasses
import time as _time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from raytrace_tpu.models.compile import CompiledScene
from raytrace_tpu.tools.chacha import ChaCha20Rng
from raytrace_tpu.utils.image import write_png

from ..ops import camera as cam_ops
from ..ops.spheres import world_sphere_tables
from .arrays import SceneStatic, upload_scene
from .wavefront import make_trace_fn, prepare_batch, render_tile

# The reference seeds its host RNG with this value (render_engine.rs:116);
# it drives the batch-time jitter stream.
HOST_SEED = 485_674_845_675_491

# Rays per tile: a whole 1200x675x4 frame is one tile, which fills the card
# and keeps the host's per-bounce loop overhead to one pass per frame.
RAY_BUDGET = 1 << 22


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


def unsupported_feature(static: SceneStatic) -> Optional[str]:
    """Why this port cannot render the scene yet, naming the ROADMAP
    queue 1 item that will add it; None when it is inside the slice."""
    if static.has_tris:
        return "triangles (ROADMAP queue 1: 'Triangles')"
    if static.has_lights:
        return "lights (ROADMAP queue 1: 'NEE with lights')"
    if static.flags.has_image:
        return "image textures (ROADMAP queue 1: 'Image textures')"
    if static.flags.has_noise:
        return "noise textures (ROADMAP queue 1: 'Noise textures')"
    if static.any_animated:
        return "animated instances (ROADMAP queue 1: 'Motion blur')"
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
    def __init__(self, compiled: CompiledScene, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; rendering on the CPU must be asked "
                "for with device='cpu'")
        self.scene, self.static = upload_scene(compiled, self.device)
        missing = unsupported_feature(self.static)
        if missing is not None:
            raise NotImplementedError(f"not ported yet: {missing}")
        self.batch_times = get_batch_ray_times(compiled.render.sample_batches)
        # World-space sphere tables per batch time (host f64 -> f32).
        self.sphere_tables = world_sphere_tables(compiled, self.batch_times)
        if self.sphere_tables is None:
            raise NotImplementedError(
                "not ported yet: spheres with non-uniform scale (ROADMAP "
                "queue 1: 'Object-space spheres')")
        self.compiled = compiled

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

    def render_next_batch(self) -> bool:
        """Trace one sample batch; returns False when every batch is done."""
        if self.current_batch >= self.compiled.render.sample_batches:
            return False
        t0 = _time.perf_counter()
        H = self.static.height
        sph_table = torch.tensor(self.sphere_tables[self.current_batch],
                                 device=self.device)
        geom = prepare_batch(self.static, self.scene, sph_table)
        trace = make_trace_fn(geom)
        tiles, rays = [], 0
        for row0 in range(0, H, self.rows_per_tile):
            tile, tr = render_tile(
                self.static, self.scene, self.camera, trace, geom,
                self.current_batch, row0, self.rows_per_tile, self.use_dof)
            tiles.append(tile)
            rays += tr
        img = torch.cat(tiles, dim=0)[:H]
        b = float(self.current_batch)
        self.accum = (b * self.accum + img) / (b + 1.0)
        _synchronize(self.device)
        dt = _time.perf_counter() - t0
        self.current_batch += 1
        self.stats.batches_done += 1
        self.stats.rays_traced += rays
        self.stats.render_seconds += dt
        return True

    def render_batches(self, k: int) -> int:
        """Render up to k batches; returns how many were rendered."""
        done = 0
        while done < k and self.render_next_batch():
            done += 1
        return done

    def render_all(self) -> np.ndarray:
        while self.render_next_batch():
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
        return Renderer(cs, device=self.device)
