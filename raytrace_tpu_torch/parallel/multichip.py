"""Sharded rendering over torch.distributed (counterpart of
raytrace_tpu/parallel/multichip.py).

One process a rank: NCCL on the card, each rank on ``cuda:LOCAL_RANK``,
gloo on the CPU.  The rank and world size come from a process group the
caller made (``torch.distributed.init_process_group``), else from
``torchrun``'s environment (``init_distributed``), else the world is one
rank and nothing is communicated.

Layout (``make_layout``, the JAX ``make_mesh``'s rules): the ranks form a
(px, sp, sc) grid, rank = (px_i * sp + sp_i) * sc + sc_i.

- "px" shards the image's rows: a rank renders rows_local = ceil(H / px)
  rows from row_base = px_i * rows_local (a slab's rows past H are zero;
  a slab wholly past H launches nothing);
- "sp" shards each pixel's samples: a rank renders spp_local = spp / sp
  of them, numbered from sample_base = sp_i * spp_local in the same
  per-sample RNG streams as the single-device render; the sample sums are
  all_reduced over "sp" and divided by spp;
- "sc" shards the scene itself: each rank holds a contiguous slice of the
  primitive tables (``shard_scene_arrays``, ``shard_sphere_tables``; the
  Renderer's ``shard``), builds its own sphere and soup trees over it, and
  every bounce combines the slices' closest hits and fetches the winner's
  rows with collectives over "sc" (engine/wavefront._sc_combine_hit);
  rays repeat over "sc".

``MultiChipRenderer`` is the ``Renderer`` given a ``RankSplit``: the
Renderer's one stepping loop renders the rank's part of every batch and
joins it with the others' through the split's hooks.  The image rows are
gathered over "px" and cropped to H, so every rank
holds the whole accumulation image; rays traced are summed over "px" and
"sp".  A batch with sp = 1 computes each pixel as the ``Renderer`` does,
so px and sc shards give its bytes (on the wavefront, where a path's
radiance has one nonzero term, as in a scene without emissive materials:
with several, the tail compaction's grouping follows the tile's ray
count); an sp split changes the order of the sample sums.

With gloo, collectives on CUDA tensors go through host copies, explicitly:
gloo reduces CUDA tensors but gathers none, and NCCL refuses two ranks on
one card, so that is how two ranks share one card.

The fused path (K4, ops/megakernel.render_tile_mega) renders a rank's
rows and samples in one launch with its row range and ``spp_local``: a
chunk of k batches is one launch on the ``Renderer``'s "fused" and
"fused_anim" paths, and one launch a batch on "fused_per_batch".  The
JAX chunk's snake permutation of pixels to lanes and its cost history are
TPU mechanisms and are not ported.
"""

from __future__ import annotations

import os
import time as _time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..engine.arrays import SceneArrays
from ..engine.renderer import FrameSplit, Renderer


class Layout(NamedTuple):
    """A rank's place in the (px, sp, sc) grid of the world's ranks,
    rank = (px_i * sp + sp_i) * sc + sc_i."""

    px: int
    sp: int
    sc: int
    px_i: int
    sp_i: int
    sc_i: int

    @staticmethod
    def of(rank: int, px: int, sp: int, sc: int) -> "Layout":
        return Layout(px, sp, sc, rank // (sp * sc), rank // sc % sp,
                      rank % sc)

    def group_ranks(self, axes: str) -> tuple:
        """The ranks that share this rank's coordinates on every axis not
        in ``axes`` (letters of "px", "sp", "sc" as "x", "p", "c"), in
        rank order."""
        out = []
        for x in range(self.px):
            for p in range(self.sp):
                for c in range(self.sc):
                    if ((x == self.px_i or "x" in axes)
                            and (p == self.sp_i or "p" in axes)
                            and (c == self.sc_i or "c" in axes)):
                        out.append((x * self.sp + p) * self.sc + c)
        return tuple(out)


def make_layout(world_size: int, sp: Optional[int] = None,
                sc: Optional[int] = None) -> tuple:
    """(px, sp, sc) for ``world_size`` ranks, by the JAX ``make_mesh``'s
    rules (raytrace_tpu/parallel/multichip.py:38-63): ``sc`` defaults to
    1; ``sp`` to 2 where the ranks left after sc are even and more than 1,
    else 1; sp * sc must divide the world size."""
    n = world_size
    sc = sc or 1
    if sc < 1:
        raise ValueError(f"sc must be >= 1, got {sc}")
    if sp is None:
        rem = max(1, n // sc)
        sp = 2 if rem % 2 == 0 and rem > 1 else 1
    if sp < 1 or n % (sp * sc) != 0:
        raise ValueError(
            f"sp*sc = {sp}*{sc} must divide the device count {n}")
    return n // (sp * sc), sp, sc


def init_distributed(device: torch.device) -> tuple:
    """(rank, world size) of this process: the process group's where one
    exists, else one made from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) for the rank's ``device``: NCCL for a card
    (made the current one), gloo for the CPU; else (0, 1) with no
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", init_method="env://")
        else:
            dist.init_process_group("gloo", init_method="env://")
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def default_device(device="cuda") -> torch.device:
    """``device``, with a bare "cuda" taken to ``cuda:LOCAL_RANK`` (the
    rank's own card under torchrun)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


_OPS = {"sum": "SUM", "min": "MIN"}


def _groups(layout: Layout, axes: str):
    """This rank's process group along ``axes`` (as ``group_ranks``):
    every rank of the world makes every such group, in one order (as
    torch.distributed.new_group asks), and keeps its own; the world's
    group where it spans the world, None where it is this rank alone."""
    mine = layout.group_ranks(axes)
    if len(mine) == 1:
        return mine, None
    if len(mine) == dist.get_world_size():
        return mine, dist.group.WORLD
    made = {}
    for r in range(dist.get_world_size()):
        ranks = Layout.of(r, layout.px, layout.sp, layout.sc).group_ranks(
            axes)
        if ranks not in made:
            made[ranks] = dist.new_group(list(ranks))
    return mine, made[mine]


class Collective:
    """all_reduce and all_gather over one process group of the layout
    (``_groups``); the identity on a group of one.  ``host``: go through
    host copies (gloo with CUDA tensors)."""

    def __init__(self, layout: Layout, axes: str, host: bool):
        self.ranks, self.group = _groups(layout, axes)
        self.size = len(self.ranks)
        self.host = host
        # Host time spent in this group's collectives: with host copies,
        # from when the rank's own device work is done (the copy would
        # wait for it), so the waits for the other ranks and the copies
        # count, the rank's kernels not.
        self.seconds = 0.0

    def _start(self, t: torch.Tensor) -> float:
        if self.host and t.is_cuda:
            torch.cuda.synchronize(t.device)
        return _time.perf_counter()

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host else t.contiguous()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The element-wise reduction (``op`` "sum" or "min") of ``t``
        over the group, as a new tensor on ``t``'s device."""
        if self.size == 1:
            return t
        t0 = self._start(t)
        x = self._in(t).clone()
        dist.all_reduce(x, op=getattr(dist.ReduceOp, _OPS[op]),
                        group=self.group)
        x = x.to(t.device)
        self.seconds += _time.perf_counter() - t0
        return x

    def all_gather(self, t: torch.Tensor) -> list:
        """Every member's ``t`` (one shape on all), in rank order."""
        if self.size == 1:
            return [t]
        t0 = self._start(t)
        x = self._in(t)
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        out = [o.to(t.device) for o in out]
        self.seconds += _time.perf_counter() - t0
        return out


# ---------------------------------------------------------------- scene
# sharding ("sc"): the primitive tables row-sharded across ranks.

# The per-primitive SceneArrays fields sharded along "sc" (with
# shade_rows, rebuilt family by family).
_SC_SPH = ("sph_center", "sph_radius", "sph_inst", "sph_mat_type",
           "sph_mat_index")
_SC_TRI = ("tri_p", "tri_n", "tri_uv", "tri_inst", "tri_mat_type",
           "tri_mat_index")
_SC_SHARDED = _SC_SPH + _SC_TRI + ("shade_rows",)


def _pad_dup(a, n: int):
    """Pad dim 0 to a multiple of n by repeating the last row
    (raytrace_tpu/parallel/multichip.py:155-162): a duplicate primitive
    at a higher id never wins the closest hit (the lowest id wins ties),
    so the padding is inert whatever it holds.  numpy or torch."""
    pad = -(-a.shape[0] // n) * n - a.shape[0]
    if pad == 0:
        return a
    if isinstance(a, np.ndarray):
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
    return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))], dim=0)


def shard_scene_arrays(scene: SceneArrays, n_sc: int) -> SceneArrays:
    """SceneArrays → the same with each per-primitive field stacked
    [n_sc, local, ...] (raytrace_tpu/parallel/multichip.py:165-185):
    ``shade_rows``' [spheres | triangles] blocks are cut each on its own,
    so a slice's rows match its primitives; every other field is kept
    whole."""
    s_pad = scene.sph_center.shape[0]
    upd = {}
    for f in _SC_SPH + _SC_TRI:
        a = _pad_dup(getattr(scene, f), n_sc)
        upd[f] = a.reshape((n_sc, -1) + tuple(a.shape[1:]))
    sr = scene.shade_rows
    sph = _pad_dup(sr[:s_pad], n_sc).reshape(n_sc, -1, sr.shape[1])
    tri = _pad_dup(sr[s_pad:], n_sc).reshape(n_sc, -1, sr.shape[1])
    upd["shade_rows"] = torch.cat([sph, tri], dim=1)
    return scene._replace(**upd)


def shard_sphere_tables(tables: np.ndarray, n_sc: int) -> np.ndarray:
    """[B, S, 5] world sphere tables → [B, n_sc, S_local, 5]
    (raytrace_tpu/parallel/multichip.py:188-195)."""
    B, S = tables.shape[0], tables.shape[1]
    S2 = -(-S // n_sc) * n_sc
    out = np.empty((B, S2, tables.shape[2]), tables.dtype)
    for b in range(B):
        out[b] = _pad_dup(tables[b], n_sc)
    return out.reshape(B, n_sc, S2 // n_sc, tables.shape[2])


class SceneShard:
    """Slice ``rank`` of ``count`` of a scene sharded over "sc", with the
    collective over the slices (a ``Collective``), as engine/wavefront.py
    and the Renderer read it."""

    def __init__(self, rank: int, count: int, collective: Collective):
        self.rank, self.count, self.collective = rank, count, collective

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        return self.collective.all_reduce(t, op)

    def scene(self, scene: SceneArrays) -> SceneArrays:
        """The slice's SceneArrays: its rows of every sharded field."""
        stacked = shard_scene_arrays(scene, self.count)
        return scene._replace(**{f: getattr(stacked, f)[self.rank].clone()
                                 for f in _SC_SHARDED})

    def tables(self, tables: np.ndarray) -> np.ndarray:
        """The slice's rows of [B, S, 5] world sphere tables."""
        return np.ascontiguousarray(
            shard_sphere_tables(tables, self.count)[:, self.rank])

    def static(self, static, scene: SceneArrays):
        """The whole scene's SceneStatic with the slice's counts: its real
        spheres, the part of the dense sphere prefix it holds, and its
        real triangles (raytrace_tpu/engine/wavefront.py:809-818).  Every
        other fact stays the whole scene's, so every slice traces and
        shades alike and meets the others at the same collectives."""
        import dataclasses

        S, T = scene.sph_center.shape[0], scene.tri_inst.shape[0]

        def local(n, size):
            return int(np.clip(n - self.rank * size, 0, size))

        return dataclasses.replace(
            static, num_spheres=local(static.num_spheres, S),
            sph_prefix=local(static.sph_prefix, S),
            num_triangles=local(static.num_triangles, T))


class RankSplit(FrameSplit):
    """A rank's part of every batch in its (px, sp, sc) layout (the
    Renderer's ``split``): its slab of rows and run of samples, joined with
    the other ranks' by the layout's collectives: the sample sums
    all_reduced over "sp", the slabs gathered over "px", the rays summed
    over ("px", "sp") (they repeat over "sc")."""

    def __init__(self, layout: Layout, samples: Collective,
                 rows: Collective, rays: Collective, device: torch.device):
        self.px, self.px_i = layout.px, layout.px_i
        self.sp, self.sp_i = layout.sp, layout.sp_i
        self._samples, self._rows, self._rays = samples, rows, rays
        self._device = device

    def reduce_samples(self, slab: torch.Tensor) -> torch.Tensor:
        return self._samples.all_reduce(slab, "sum")

    def gather_rows(self, slab: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._rows.all_gather(slab))

    def sum_rays(self, rays: int) -> int:
        return int(self._rays.all_reduce(torch.tensor(
            [rays], dtype=torch.int64, device=self._device))[0])


class MultiChipRenderer(Renderer):
    """Progressive renderer sharded over the ranks of a process group
    (raytrace_tpu/parallel/multichip.py:335-636): the ``Renderer``, its
    stepping loop, running mean, checkpoints (the same ``.npz``, so a
    checkpoint of either renderer resumes in the other) and PNG export,
    with a ``RankSplit`` of every batch and, with sc > 1, a
    ``SceneShard`` of the scene.

    The renderer spans the process group's world (one rank without one):
    every rank constructs it and makes the same calls.  ``sp`` and ``sc``
    as ``make_layout`` takes them.
    ``device``: a bare "cuda" is the rank's ``cuda:LOCAL_RANK``; the CPU
    must be asked for.  ``use_megakernel``, ``use_bvh``, ``leaf_size``,
    ``camera_name`` and ``metrics_jsonl`` as the ``Renderer`` takes them;
    with sc > 1 a BVH or a paged soup is refused, as is a scene without
    fat shading rows.  Checkpoints, PNGs and the metrics' JSONL lines are
    written by the lead rank (every rank keeps its records)."""

    def __init__(self, compiled, device="cuda", sp: Optional[int] = None,
                 sc: Optional[int] = None,
                 use_megakernel: Optional[bool] = None, use_bvh="auto",
                 leaf_size: int = 4, camera_name: Optional[str] = None,
                 metrics_jsonl: Optional[str] = None):
        device = default_device(device)
        rank, world = init_distributed(device)
        self.layout = lay = Layout.of(rank, *make_layout(world, sp, sc))
        host = (world > 1 and device.type == "cuda"
                and dist.get_backend() == "gloo")
        self._collectives = {axes: Collective(lay, axes, host)
                             for axes in ("p", "x", "xp", "xpc", "c")}
        c = self._collectives
        super().__init__(
            compiled, device=device, use_megakernel=use_megakernel,
            use_bvh=use_bvh, leaf_size=leaf_size,
            shard=(SceneShard(lay.sc_i, lay.sc, c["c"]) if lay.sc > 1
                   else None),
            split=RankSplit(lay, c["p"], c["x"], c["xp"], device),
            camera_name=camera_name,
            metrics_jsonl=metrics_jsonl if self.is_lead else None)
        # update_image_size makes a MultiChipRenderer with these.
        self._ctor_kwargs = dict(device=device, sp=lay.sp, sc=lay.sc,
                                 use_megakernel=use_megakernel,
                                 use_bvh=use_bvh, leaf_size=leaf_size,
                                 camera_name=camera_name,
                                 metrics_jsonl=metrics_jsonl)

    @property
    def is_lead(self) -> bool:
        """The rank that writes files: the first of the renderer's."""
        return self.layout.px_i == self.layout.sp_i == self.layout.sc_i == 0

    def collective_seconds(self) -> float:
        """Host seconds spent in this renderer's collectives so far."""
        return sum(c.seconds for c in self._collectives.values())

    def _barrier(self) -> None:
        self._collectives["xpc"].all_reduce(
            torch.zeros(1, device=self.device))

    def save_png(self, path: str) -> None:
        """Written by the lead rank; every rank returns once it is."""
        if self.is_lead:
            super().save_png(path)
        self._barrier()

    def save_checkpoint(self, path: str) -> None:
        """The Renderer's npz, written by the lead rank; every rank
        returns once it is."""
        if self.is_lead:
            super().save_checkpoint(path)
        self._barrier()
