#!/usr/bin/env python3
"""Smoke run of the PyTorch port (raytrace_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's render paths through the entry points a user calls,
on six scenes at their full size: final-one-weekend at 1200x675 with
its 4 spp and depth 50 (static: the fused kernel K4 and the wavefront
with K1), final-one-weekend-motion-blur at its shipped 1024x576, 4 spp x
25 batches, depth 50 (391 of 488 spheres moving: K4's animated form, and
the wavefront), the triangle stress scene tri-stress-15360
(raytrace_tpu_torch/tools/stress_scenes.py: 16 instances of a
960-triangle OBJ over a ground sphere, 1024x576, 16 spp x 1 batch, depth
50: K4's triangle form, and the wavefront with the triangle sweep K2 and
K1), and the two light scenes of raytrace_tpu_torch/tools/light_scenes.py
(K4's lit forms, and the wavefront's NEE branch with K2, and K1):
cornell-style (a Cornell box of 36 triangles with a quad light, 1024x1024,
64 spp x 32 batches, depth 50) and sphere-light-962 (analytic spheres
with the book's Perlin texture, a light sphere and a light quad: 962
light triangles; 1024x576, 64 spp x 2 batches, depth 50: K4's lit noise
form); perlin-spheres (raytrace_tpu_torch/tools/noise_scenes.py: the
book's two Perlin spheres, 1024x576, 16 spp x 1 batch, depth 50: K4's
noise form, and the wavefront with K1); earth and earth-motion-blur
(raytrace_tpu_torch/tools/image_scenes.py: the book's globe of radius 2
with a 5400x2700 texel-id image, 512x512, 4 spp x 16 batches and 8 spp x
32, depth 50: K4's image form, fused and, for the turning globe, one
launch per batch, and the wavefront with K1); and final-one-weekend with
--mesh-geometry (its 488 uv spheres tessellated: 2,033,920 triangles, 125
pages of the paged sweep K3; 1200x675, 4 spp, depth 50: the paged
wavefront), with its motion-blur twin the same way (page tables built
per batch); and the sphere stress scenes of
raytrace_tpu_torch/tools/stress_scenes.py, final-one-weekend's small
spheres tiled 2 x 2 (stress-4x: 1,940 spheres, 121 clusters of 16) and 6 x
6 cut to 16,384 (stress-16k: 128 clusters of 128), 1024x576, 4 spp x 25,
depth 50: K4's clustered sphere form, which final-one-weekend and its
motion-blur twin take too, and the wavefront with K1.  Every phase
is checked; any failure raises and the script exits non-zero without
printing a result.  No path runs at a cut depth.  Phases:

1. needs torch.cuda.is_available(); prints nvidia-smi's name and power limit;
2. builds the four kernel sources from the checkout, one nvcc each,
   started together: the sphere sweep K1 (csrc/sphere_sweep.cu), the
   triangle sweep K2 (csrc/tri_sweep.cu), the fused bounce kernel K4
   (csrc/megakernel.cu: static, animated, triangle and the two lit
   forms, each without and with noise, and each but the animated one
   with images; each of these eighteen dense forms and its clustered
   sphere twin) and the paged triangle sweep K3 (csrc/paged_tri.cu), with
   nvcc's register report, a line per K4 form and K3's; the ten forms
   without images must keep the registers and spills they had before the
   image forms (FORMS_BEFORE), and the eight image forms those they had
   before the clustered forms (IMAGE_FORMS_BEFORE);
3. K1 against the plain PyTorch sweep: the 3,240,000 primary rays of the
   main path and 2^20 random rays with an alive mask (ids equal, and ids
   equal with t within rtol=1e-3, atol=1e-3, each on >= 99.9% of rays),
   timed with CUDA events; then K2 the same way (bit for bit, or the same
   agreement): 2^18 of tri-stress's primary rays against its 15,360
   triangles and 2^20 random rays with an alive mask against 960, timed
   over all 9,437,184 primary rays;
4. K4 against its plain version (the wavefront loop with the plain
   sweeps): at 96x54, depth 8, 2 batches fused (rays within 0.5%,
   per-sample channel means within 1e-3, at most 5% of pixels above 1e-4)
   and at the main path's 1200x675, 4 spp, depth 50, one batch (rays
   within 0.5%, means within 2e-3, and bit for bit: the clustered static
   form); two launches give the same bytes; both timed with CUDA events,
   and the dense form on the same batch; the clustered traversal's work
   counted for the bound on 2^17 of the wavefront's rays of the batch;
   wherever a scene in clusters is held to the plain version (here and
   below, up to the dense gate's 4096 spheres), its dense form (the
   layout dropped) is too, bit for bit, two launches byte-identical;
   then K4's animated form the same way on the motion-blur scene, at
   96x54/depth 8/k=2 and at 1024x576/depth 50/k=1 (bit for bit); then
   its triangle form, bit for bit at 96x54/depth 8/k=2 on
   tri-stress at k=1 and k=4 and on the triangle fixture, and at
   tri-stress's full size against the plain version and against the
   wavefront with K2 on the same batch (rays within 0.5%, means within
   2e-3), which also counts the work its bound estimates; then its lit
   forms, bit for bit (and two launches byte-identical) at depth 50, k=2
   on cornell-style at 128x128, sphere-light-962 at 128x72, the lit
   spheres doc (no triangle: the lit form without triangles) at 96x54 and
   the 70-instance lit doc at 96x96; then each light scene's full batch
   bit for bit with the plain version (both timed), and held against the
   wavefront with K2 (and K1) on the same batch (rays within 0.5%, means
   within LIGHT_MEAN_TOL), which also counts the work of the bound; then
   K4's five noise forms, each bit for bit with its plain version (and
   two launches byte-identical) on the small frames of
   noise_scenes.form_checks (perlin-spheres at 96x54, depth 8, the
   motion-blur scene with noise, the noise checker and the noise light
   docs, and sphere-light-962 at 128x72, depth 50; k=2), and
   perlin-spheres' full batch bit for bit with the plain version (both
   timed; the plain version run again counts the noise hits of the
   bound); then K4's eight image forms, each bit for bit with its plain
   version (and two launches byte-identical) on the small frames of
   image_scenes.form_checks (a 640x320 texel-id image; k=2), and earth's
   full batch bit for bit with the plain version (both timed; the plain
   version run again counts the image hits of the bound); then K4's
   eighteen clustered sphere forms, each bit for bit with its plain
   (dense) version (and two launches byte-identical, the clustered
   launches counted) on the small docs of stress_scenes.
   cluster_form_checks (final-one-weekend's 488 spheres, or its
   motion-blur twin's, with a triangle, a light sphere or quad, a marble
   ground and an image albedo; 96x54, depth 8, k=2); then stress-4x and
   stress-16k (compile and Renderer seconds), stress-16k first at 128x72,
   depth 50, k=1, and each full batch bit for bit with the plain version
   (both timed, stress-4x's dense form too) and against the wavefront
   with K1 on the same batch (rays within 0.5%, means within 2e-3),
   whose rays count the clustered work of the bound; then K3 bit
   for bit with its plain version and with K2 (two launches
   byte-identical) on random multi-page soups with a partial
   last page and an alive mask (g = c = 128, and g = 8, c = 16), on all
   3,240,000 primary rays of the mesh scene's batch 0 (plain version
   timed) and on 2^17 of them and of its bounce-2 rays against K2 too;
   K3 timed over the primary rays, its work counted on the subset for
   the bound;
5. the wavefront path, Renderer(cs, use_megakernel=False): several batches,
   counting K1 launches; the image checks; the same for the motion-blur
   scene, for tri-stress's one batch (counting K2 and K1 launches) and
   for perlin-spheres' and earth's batches (K1; each held to its fused
   batch's channel means); a small frame on the card against the
   CPU, for both paths and the animated fused path, for both triangle
   paths, both paths of each light scene, of perlin-spheres and of earth,
   and the paged wavefront (a tessellated big-spheres doc);
6. the main path, Renderer(cs) with defaults: it must take the fused path
   (K4 launched, K1 not); Mrays/s over batches 1-3 stepped one at a time
   and over one fused chunk of 12 batches, the chunk beside the 298.602
   that PERF.md records for the static kernel before its animated form;
   the image checks; then the motion-blur scene's Renderer with defaults,
   which must take the animated fused path (one animated K4 launch per
   batch stepped and per chunk), with the same numbers and its image
   within 2e-3 of the wavefront's means; then tri-stress's Renderer with
   defaults, which must take the fused path in K4's triangle form (K1 and
   K2 not launched), with Mrays/s for its batch stepped and for
   render_all, and the image checks; then cornell-style's Renderer with
   defaults at 1024x1024, 64 spp, depth 50, which must take the fused
   path in K4's lit form (K1 and K2 not launched), with Mrays/s over
   batches 1-3 stepped and over one fused chunk of 4 batches, and
   sphere-light-962's, its batches stepped and in render_all; the image
   checks; then perlin-spheres' Renderer with defaults, which must take
   the fused path in K4's noise form (K1 not launched), its batch
   stepped and in render_all, the image checks and its channel means
   beside the wavefront's; then earth's Renderer with defaults, which
   must take the fused path in K4's image form (K1 not launched), its
   first batch stepped and render_all; then earth-motion-blur's, which
   must take fused_per_batch (one image launch a batch, no animated
   form), four batches stepped and held to the wavefront's four (channel
   means within IMAGE_MEAN_TOL); then the mesh scene's Renderer with
   defaults, which must take the paged wavefront (K3 launched; K1, K2
   and K4 not), Mrays/s over batches 1-3 stepped, the image checks and
   its channel means beside the analytic scene's; a reduced frame
   (240x135, depth 50, one batch) of its soup on the paged and on the
   dense sweep, byte-identical with equal ray counts; one batch of the
   motion-blur mesh (tables built once for the batch), the image checks
   and the same reduced-frame identity; final-one-weekend and its
   motion-blur twin must count every K4 launch as clustered; then
   stress-4x's and stress-16k's Renderer with defaults, which must take
   the fused path in K4's clustered form (K1 not launched), Mrays/s over
   batches 1-3 stepped and in render_all (three launches), and the image
   checks;
7. checkpoint round trips on both paths, with the same chunk boundaries,
   and on cornell-style's fused path: the resumed image must be
   byte-identical to the uninterrupted render;
8. the CLI renders every batch of each scene to a PNG (fused chunks;
   the mesh scene with --mesh-geometry on the paged wavefront);
9. one fused chunk of each sphere scene, tri-stress's batch, a chunk of
   each light scene, perlin-spheres' batch, a chunk of earth and of
   stress-16k and one batch of the mesh scene under torch.profiler
   (one session): the device's busy share of the traced window's own
   device timeline and of the untraced wall, the fused kernel's (or
   K3's) share of device time and device operations per batch.

The line before the last is the kernels' JSON record (with each kernel's
bound: the larger of its FP32 operations over 67 TFLOP/s and its bytes
over 3.35 TB/s, counted from this run's inputs and the scene's real
spheres, not the table's padding rows; K4's triangle, lit, noise and
image forms' and K3's are estimates, see _k4_tris_bound, _noise_bound,
_image_bound and _k3_full; its clustered forms' count the traversal's
work on a subset of the rays, _cluster_bound), the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

WIDTH, HEIGHT = 1200, 675
MB_WIDTH, MB_HEIGHT = 1024, 576   # the motion-blur scene's shipped size
MAIN_BATCHES = 4          # the first one is warm-up for the Mrays/s figure
CHUNK_BATCHES = 12        # Renderer.CHUNK: one fused launch
CKPT_SPLIT = 2            # round trip: save after this many batches
RANDOM_RAYS = 1 << 20
AGREEMENT = 0.999
RTOL = ATOL = 1e-3
# The static fused chunk's Mrays/s that PERF.md records for the static
# kernel before its animated form was added (NVIDIA H100 80GB HBM3,
# 700 W), printed beside this run's.
STATIC_CHUNK_MRAYS_BEFORE = 298.602

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of one ray-sphere test, counted from the sweep loops of
# csrc/sphere_sweep.cu and csrc/megakernel.cu: dc 5, oc 5, h 1, c2 3,
# disc 3, max 1, sqrt 1, t1 3, t2 3.  The animated form adds the moved
# centre (3 multiplies, 3 adds) and k0 + t * (k1 + t * k2) (2 and 2).
# The tests are ~99% of the fused kernel's operations (a bounce's other
# work is ~150 operations against 488 x 25), so its bound counts them
# alone and is a lower bound.
FLOPS_PER_TEST = 25
FLOPS_PER_TEST_ANIM = 35
# The triangle stress scene: k x k instances of the 960-triangle OBJ.
TRI_K = 4
TRI_WIDTH, TRI_HEIGHT = 1024, 576
TRI_SUBSET = 1 << 18
# FP32 operations of one ray-triangle test, counted from the loops of
# csrc/tri_sweep.cu and csrc/megakernel.cu as FLOPS_PER_TEST is (compares
# not counted): p = d x e2 9, det 5, 1 / det 1, s = o - v0 3, u 6,
# q = s x e1 9, v 6, t 6, u + v 1.  One cluster-box pretest: per axis two
# subtractions, two multiplies, a min and a max (18), the running max and
# min over axes (4), the pruned best t (2).
FLOPS_PER_TRI_TEST = 46
FLOPS_PER_PRETEST = 24
# One sphere cluster's pretest: the box pretest above, its rounding margin
# (|o| + reach)^2 / r_min scaled (3) and the box widened by it (6).
FLOPS_PER_SPHERE_PRETEST = FLOPS_PER_PRETEST + 9
# The sphere stress scenes (tools/stress_scenes.py): spheres, spheres per
# cluster and clusters; and the rays on which K4's clustered traversal
# work is counted for its bound.
STRESS_LAYOUT = {"stress-4x": (1940, 16, 121), "stress-16k": (16384, 128, 128)}
STRESS_SIZE = (1024, 576)
STRESS_SMALL = (128, 72)
CLUSTER_SUBSET = 1 << 17
# FP32 operations of one NEE step of K4's lit form after a scattering hit,
# counted from csrc/megakernel.cu as above (the cheaper direction, the
# light's; RNG words and compares not counted): the alias pick 1, three
# points moved by the 3x4 matrix 54, the fold and the point on the
# triangle 19, the light normal 26, the sphere and cosine samples 20, the
# light direction 3, the two pdfs, their mixture and the ratio 35, the
# throughput 6 and the new direction 11.
FLOPS_PER_NEE = 175
# FP32 operations of one noise evaluation of K4's noise forms, counted
# from csrc/megakernel.cu as above (compares and selects not counted;
# floorf, fmodf, fabsf and sinf one each): a cnoise is 451 (the lattice
# floors, the six mod-289s and the offsets 36, three fades 21, each of the
# four (x, y) corners 96: its hash 15, its two z corners 39 each with
# their permute, gradient, normalisation and dot, and a z mix 3; the y
# and x mixes and the gain 10); an octave adds 6, the turbulence's abs 1
# and the marble around it 6.  An estimate: it counts the turbulence
# alone, once per hit whose slot is in noise mode (_slot_hits).
FLOPS_PER_TURBULENCE = 7 * (451 + 6) + 1 + 6
# FP32 operations of one image read of K4's image forms, counted from
# csrc/megakernel.cu as above (compares, selects and integer work not
# counted; acosf, atan2f, floorf and fmodf one each): a sphere's object
# normal again 25 (the point moved by the 3x4 matrix 18, its reciprocal
# radius 1, the offset and scale 6), its normalisation 11, v 5 (clamp 2,
# negation, acosf, scale) and u 5 (negation, atan2f, scale, fmodf and its
# fix-up), the texel's wrap, scale and floor in u and v 8.  An estimate:
# the sphere form (the earth's one globe), once per hit whose slot is in
# image mode (_slot_hits).  Its bytes: one 32-byte sector a texel read,
# at a random address of the atlas.
FLOPS_PER_IMAGE_READ = 25 + 11 + 5 + 5 + 8
BYTES_PER_IMAGE_READ = 32
# Registers and spill-store bytes of K4's forms without images, as the
# parent of the image forms compiled them (nvcc -Xptxas -v; PERF.md, PR
# 7), and of its image forms, as the parent of the clustered sphere forms
# compiled them (PERF.md): the dense forms must compile as before.
FORMS_BEFORE = {"static": (61, 0), "anim": (62, 0), "tris": (72, 4),
                "lights": (72, 0), "tris+lights": (72, 4),
                "static+noise": (72, 8), "anim+noise": (72, 8),
                "tris+noise": (72, 28), "lights+noise": (72, 8),
                "tris+lights+noise": (72, 28)}
IMAGE_FORMS_BEFORE = {"static+image": (64, 0), "tris+image": (72, 4),
                      "lights+image": (64, 0), "tris+lights+image": (72, 4),
                      "static+noise+image": (72, 8),
                      "tris+noise+image": (72, 28),
                      "lights+noise+image": (72, 8),
                      "tris+lights+noise+image": (72, 28)}
# The image forms: each form but the animated one, with and without noise.
IMAGE_FORMS = sorted(IMAGE_FORMS_BEFORE)
DENSE_FORMS = sorted(list(FORMS_BEFORE) + IMAGE_FORMS)
# The clustered sphere forms: the twin of each dense form
# (tools/stress_scenes.cluster_form_checks names them without the suffix).
CLUSTER_FORMS = sorted(f + "+clusters" for f in DENSE_FORMS)
K4_FORMS = sorted(DENSE_FORMS + CLUSTER_FORMS)
# The light scenes: their full sizes, and the widths of the small frames
# that hold K4's lit forms against the plain version at depth 50, k=2.
LIGHT_SMALL = {"cornell-style": 128, "sphere-light-962": 128,
               "lit spheres": 96, "70 instances": 96}
# The light scenes' full batch, fused against the wavefront with K2 (and
# K1, which contracts multiply-adds): per-sample channel means within
# this.  Measured 6.0e-8 (cornell-style) and 1.1e-6 (sphere-light-962)
# on an H100 (PERF.md).
LIGHT_MEAN_TOL = 1e-5
# Big meshes: final-one-weekend --mesh-geometry (its 488 uv spheres
# tessellated, as the reference renders them), held against the plain
# version and K2 on this many of its rays at a bounce; the reduced frame
# on which the paged and the dense sweep must render the same bytes.
MESH_TRIANGLES = 2_033_920
# perlin-spheres (tools/noise_scenes.py): its size, and its full batch,
# fused against the wavefront with K1 (which contracts multiply-adds,
# and the turbulence amplifies a hit point's last bits about 100x):
# per-sample channel means within this.
PERLIN_SIZE = (1024, 576)
NOISE_MEAN_TOL = 1e-4
MESH_SUBSET = 1 << 17
REDUCED = (240, 135)
# Cycles of the spin kernel _median_ms queues before each timed run: ~2 ms.
SPIN_CYCLES = 4_000_000
# earth (tools/image_scenes.py): its size, and its full batch, fused
# against the wavefront with K1 (which contracts multiply-adds): channel
# means within this.  earth-motion-blur's batch on fused_per_batch against
# its wavefront batch, the same.
EARTH_SIZE = (512, 512)
IMAGE_MEAN_TOL = 1e-4


def _bound(flops: float, nbytes: float):
    """(least ms, "operations" or "bytes"): the larger of the two."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _spheres(static) -> int:
    """The scene's real spheres: the rows of the sphere table that a bound
    counts (the table's padding rows hold nothing to hit)."""
    return static.num_spheres if static.has_spheres else 0


def _k4_bound(static, geom, traced_sum: int, width: int, height: int,
              n_times: int):
    """K4's bound for one launch: every bounce tests every sphere;
    bytes are the tables, rows, parameters (and motion rows and times)
    read once and the sums and counts written once."""
    anim = geom.sph_dtab8 is not None
    per_test = FLOPS_PER_TEST_ANIM if anim else FLOPS_PER_TEST
    nbytes = (geom.sph_table8.numel() + geom.prim_rows.numel() + 40) * 4
    if anim:
        nbytes += (geom.sph_dtab8.numel() + n_times) * 4
    nbytes += width * height * (3 * 4 + 4)
    return _bound(traced_sum * _spheres(static) * per_test, nbytes)


def _k4_tris_bound(static, geom, work, width: int, height: int, scene=None):
    """An estimate of K4's triangle form's bound for one launch, from the
    work ``_tri_work`` counted on the wavefront's rays of the same batch:
    every bounce tests every sphere and every cluster box, and the
    real triangles of each cluster whose box passes the pretest seeded by
    the sphere hit (the JAX kernel's, megakernel.py:1280; the kernel's own
    running best t can only skip more), and every noise hit takes
    FLOPS_PER_TURBULENCE.  With ``scene`` (the lit form),
    every bounce but a sample's last takes an NEE step, and the light rows
    and instance transforms are read too.  Bytes: the tables, boxes, rows
    and parameters read once, the sums and counts written once."""
    flops = (work["rays"] * _spheres(static) * FLOPS_PER_TEST
             + work["pretests"] * FLOPS_PER_PRETEST
             + work["tri_tests"] * FLOPS_PER_TRI_TEST
             + work["noise_hits"] * FLOPS_PER_TURBULENCE)
    nbytes = (geom.sph_table8.numel() + geom.prim_rows.numel()
              + geom.tri_table12.numel() + geom.tri_boxes.numel() + 40) * 4
    if scene is not None:
        flops += (work["rays"] - work["samples"]) * FLOPS_PER_NEE
        nbytes += (scene.light_tri_packed.numel()
                   + geom.inst_o2w_rows.numel()) * 4
    nbytes += width * height * (3 * 4 + 4)
    return _bound(flops, nbytes)


def _cluster_work(wave_r, geom, times=None):
    """Render batch 0 of ``wave_r``'s scene on the wavefront (K1), as
    render_next_batch does, capturing every bounce's alive rays; count on
    CLUSTER_SUBSET of them K4's clustered traversal against ``geom`` (the
    fused path's geometry, moved to times[0] when it moves) with
    ops/megakernel.sphere_cluster_sweep_reference.  Returns (image [H, W,
    3] on the host, rays traced, per-ray work: prefix sphere tests, box
    tests and sphere tests in clusters that pass)."""
    import torch

    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.ops import megakernel
    from raytrace_tpu_torch.ops.vec3 import V3

    static, scene = wave_r.static, wave_r.scene
    wave_geom = wave_r._geometry(0)
    trace = wavefront.make_trace_fn(static, scene, wave_geom)
    seen = []

    def capture(o, d, alive):
        seen.append(torch.stack([*o, *d])[:, alive])
        return trace(o, d, alive)

    tiles, rays = [], 0
    for row0 in range(0, static.height, wave_r.rows_per_tile):
        tile, tr = wavefront.render_tile(static, scene, wave_r.camera,
                                         capture, wave_geom, 0, row0,
                                         wave_r.rows_per_tile,
                                         wave_r.use_dof)
        tiles.append(tile)
        rays += tr
    img = torch.cat(tiles, dim=0)[:static.height].cpu().numpy()
    allr = torch.cat(seen, dim=1)
    del seen
    gen = torch.Generator().manual_seed(0)
    sel = torch.randperm(allr.shape[1], generator=gen)[:CLUSTER_SUBSET].to(
        allr.device)
    sub = allr[:, sel]
    o, d = V3(*sub[0:3]), V3(*sub[3:6])
    n_prefix, G, _ = megakernel.sphere_cluster_layout(static)
    work = {}
    megakernel.sphere_cluster_sweep_reference(
        o, d, geom.sph_table8, geom.sph_boxes, n_prefix, G,
        dtab8=geom.sph_dtab8, t=None if times is None else times[0],
        work=work)
    per_ray = {k: work[k] / work["rays"] for k in ("prefix_tests",
                                                  "box_tests",
                                                  "sphere_tests")}
    return img, rays, per_ray


def _cluster_bound(geom, per_ray, traced_sum: int, width: int, height: int,
                   n_times: int):
    """K4's bound for one launch of a clustered sphere form, from the
    per-ray work ``_cluster_work`` counted: every bounce tests the prefix,
    every cluster box and the spheres of the clusters that pass; bytes
    are the tables, boxes, rows, parameters (and motion rows and times)
    read once and the sums and counts written once."""
    anim = geom.sph_dtab8 is not None
    per_test = FLOPS_PER_TEST_ANIM if anim else FLOPS_PER_TEST
    flops = traced_sum * ((per_ray["prefix_tests"] + per_ray["sphere_tests"])
                          * per_test
                          + per_ray["box_tests"] * FLOPS_PER_SPHERE_PRETEST)
    nbytes = (geom.sph_table8.numel() + geom.sph_boxes.numel()
              + geom.prim_rows.numel() + 40) * 4
    if anim:
        nbytes += (geom.sph_dtab8.numel() + n_times) * 4
    nbytes += width * height * (3 * 4 + 4)
    return _bound(flops, nbytes)


def _dense_ms(args, kw):
    """The dense form's median time (5 launches) on the same batch: the
    static with its cluster layout dropped, which the dense sweep takes
    (_compare_fused has held it to the plain version)."""
    from raytrace_tpu_torch.ops import megakernel

    flat = (dataclasses.replace(args[0], sph_prefix=0),) + args[1:]
    return _median_ms(lambda: megakernel.render_tile_mega(*flat, **kw), 5)


def _ptxas_forms(log: str):
    """[(form, registers, spill store bytes)] of each K4 instantiation in
    nvcc's -Xptxas=-v report (megakernel<kAnim, kTris, kLights, kNoise,
    kImage, kSphClusters>; a noise form's name has "+noise", an image
    form's "+image", a clustered sphere form's ends in "+clusters")."""
    forms = []
    names = {("0", "0", "0"): "static", ("1", "0", "0"): "anim",
             ("0", "1", "0"): "tris", ("0", "0", "1"): "lights",
             ("0", "1", "1"): "tris+lights"}
    for block in log.split("Compiling entry function")[1:]:
        m = re.search(r"megakernelILb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E",
                      block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if m and regs and spill:
            name = names.get(m.groups()[:3], str(m.groups()))
            forms.append((name + ("+noise" if m.group(4) == "1" else "")
                          + ("+image" if m.group(5) == "1" else "")
                          + ("+clusters" if m.group(6) == "1" else ""),
                          int(regs.group(1)), int(spill.group(1))))
    return forms


def _slot_hits(static, scene, geom, o, d, alive, raw, mode) -> int:
    """The hits of one bounce whose slot is in ``mode`` (noise or image),
    the turbulences or texel reads K4 computes there (csrc/megakernel.cu
    eval_slot): the albedo of a lambertian or metal hit, or a front-facing
    light's emission, read through the row's checker."""
    import torch

    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.models.compile import (MAT_TYPE_DIFFUSE_LIGHT,
                                                   MAT_TYPE_LAMBERTIAN,
                                                   MAT_TYPE_METAL)
    from raytrace_tpu_torch.models.shading_table import MODE_CHECKER
    from raytrace_tpu_torch.ops import vec3
    from raytrace_tpu_torch.ops.textures import checker_is_even

    hit = alive & ~raw.missed
    rows = geom.prim_rows[torch.where(hit, raw.prim, 0)]
    rec = wavefront.reconstruct_hit(raw, o, d, rows, geom,
                                    scene.sph_center.shape[0],
                                    static.flags.has_image)
    mat = rows[:, 0]
    albedo = (mat == MAT_TYPE_LAMBERTIAN) | (mat == MAT_TYPE_METAL)
    emit = ((mat == MAT_TYPE_DIFFUSE_LIGHT) & (vec3.dot(d, rec.n) < 0.0)
            if static.flags.has_emissive else torch.zeros_like(hit))
    slot = torch.where(albedo, rows[:, 11], rows[:, 15])
    if static.flags.has_checker:
        side = torch.where(checker_is_even(rows[:, 17], rec.p), rows[:, 24],
                           rows[:, 26])
        slot = torch.where(slot == MODE_CHECKER, side, slot)
    return int((hit & (albedo | emit) & (slot == mode)).sum())


def _plain_work(args, kw):
    """K4's plain version on ``args`` once more, counting at every bounce
    the rays traced, the noise hits and the image hits (_slot_hits), for
    _noise_bound and _image_bound."""
    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.models.shading_table import MODE_IMAGE, MODE_NOISE
    from raytrace_tpu_torch.ops import megakernel

    static, scene = args[0], args[1]
    work = dict(rays=0, noise_hits=0, image_hits=0)
    inner = wavefront.bounce_wavefront

    def counting(static_, scene_, trace_fn, geom, *rest):
        def trace(o, d, alive):
            raw = trace_fn(o, d, alive)
            work["rays"] += int(alive.sum())
            for key, mode in (("noise_hits", MODE_NOISE),
                              ("image_hits", MODE_IMAGE)):
                work[key] += _slot_hits(static, scene, geom, o, d, alive,
                                        raw, mode)
            return raw

        return inner(static_, scene_, trace, geom, *rest)

    wavefront.bounce_wavefront = counting
    try:
        megakernel.megakernel_reference(*args, **kw)
    finally:
        wavefront.bounce_wavefront = inner
    return work


def _image_bound(static, scene, geom, work, width: int, height: int):
    """An estimate of K4's image form's bound for one launch of a sphere
    scene, from the work ``_plain_work`` counted: every bounce tests every
    sphere, every image hit takes FLOPS_PER_IMAGE_READ and reads one
    random 32-byte sector of the atlas; the tables, rows, parameters, the
    atlas sizes and the sRGB table read once, the sums and counts written
    once."""
    flops = (work["rays"] * _spheres(static) * FLOPS_PER_TEST
             + work["image_hits"] * FLOPS_PER_IMAGE_READ)
    nbytes = ((geom.sph_table8.numel() + geom.prim_rows.numel() + 40
               + scene.atlas_wh.numel() + scene.srgb_lut.numel()) * 4
              + work["image_hits"] * BYTES_PER_IMAGE_READ
              + width * height * (3 * 4 + 4))
    return _bound(flops, nbytes)


def _noise_bound(static, geom, work, width: int, height: int):
    """An estimate of K4's noise form's bound for one launch of a sphere
    scene, from the work ``_plain_work`` counted: every bounce tests
    every sphere and every noise hit takes FLOPS_PER_TURBULENCE; bytes as
    _k4_bound's."""
    flops = (work["rays"] * _spheres(static) * FLOPS_PER_TEST
             + work["noise_hits"] * FLOPS_PER_TURBULENCE)
    nbytes = ((geom.sph_table8.numel() + geom.prim_rows.numel() + 40) * 4
              + width * height * (3 * 4 + 4))
    return _bound(flops, nbytes)


def _tri_stress(k: int, width: int, obj_dir: str, depth=None, batches=None):
    """The triangle stress scene (tools/stress_scenes.py) at ``width``,
    its JSON and OBJ written into ``obj_dir``; with the JSON's path."""
    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.tools import stress_scenes

    path = stress_scenes.write_tri_stress(obj_dir, k)
    cs = cli.load_scene(path, width)
    return _scene(cs, cs.render.width, cs.render.height, depth,
                  batches), path


def _compare_tris(name, o, d, table16, alive):
    """K2 vs its plain version on the same rays: bit for bit, or else ids
    equal and t within rtol/atol on >= 99.9% of rays.  Returns max |dt|
    over the rays whose ids agree."""
    import torch

    from raytrace_tpu_torch.ops import tri_sweep
    from raytrace_tpu_torch.ops.intersect import T_MAX

    hit = tri_sweep.intersect_tris_sweep(o, d, table16, alive)
    t, ids, u, v = tri_sweep.tri_sweep_reference(o, d, table16)
    ref = (torch.where(alive, t, T_MAX), torch.where(alive, ids, -1),
           torch.where(alive, u, 0.0), torch.where(alive, v, 0.0))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(hit, ref))
    same_id = hit.tri == ref[1]
    agree = same_id & ((hit.t - ref[0]).abs() <= ATOL + RTOL * ref[0].abs())
    frac = agree.double().mean().item()
    if not bitwise and frac < AGREEMENT:
        raise AssertionError(f"K2 {name}: (id, t) agree on {frac:.6f} of "
                             f"rays (need {AGREEMENT})")
    err = (hit.t[same_id] - ref[0][same_id]).abs().max().item()
    print(f"triangle sweep {name}: R={o.x.shape[0]} T8={table16.shape[0]} "
          f"alive {alive.double().mean().item():.4f}: bit for bit "
          f"{bitwise}; (id, t) agree on {frac:.6f} of rays; hit share "
          f"{(hit.tri >= 0).double().mean().item():.4f}; max |dt| where "
          f"ids agree {err:.3g}")
    return err


def _tri_work(renderer):
    """Render batch 0 of ``renderer``'s triangle scene on the wavefront
    (K2, K1), as render_next_batch does, and count at every bounce the
    work of K4's triangle form on the same rays (for _k4_tris_bound): the
    alive rays, their cluster pretests, the tests of the real triangles
    of the clusters that pass the pretest against each ray's sphere hit,
    and the noise hits (_slot_hits); and the samples.  Returns (image
    [H, W, 3] on the host, rays traced, work)."""
    import torch

    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.models.shading_table import MODE_NOISE
    from raytrace_tpu_torch.ops import megakernel, sphere_sweep

    static, scene = renderer.static, renderer.scene
    geom = renderer._geometry(0)
    trace = wavefront.make_trace_fn(static, scene, geom)
    n_clusters = geom.tri_boxes.shape[0]
    group = megakernel.tri_group(static, geom.tri_table16.shape[0])
    # The rows K4 sweeps in each cluster: the real triangles.
    sizes = (static.num_triangles - group * torch.arange(
        n_clusters, device=geom.tri_boxes.device)).clamp(0, group)
    work = dict(rays=0, pretests=0, tri_tests=0, noise_hits=0,
                samples=static.width * static.height * static.sqrt_spp ** 2)

    def counting(o, d, alive):
        sph = sphere_sweep.intersect_spheres_sweep(o, d, geom.sph_table8,
                                                   alive)
        passes = megakernel.cluster_pretest(o, d, geom.tri_boxes, sph.t)
        n = int(alive.sum())
        work["rays"] += n
        work["pretests"] += n * n_clusters
        work["tri_tests"] += int(((passes & alive).sum(1) * sizes).sum())
        raw = trace(o, d, alive)
        work["noise_hits"] += _slot_hits(static, scene, geom, o, d, alive,
                                         raw, MODE_NOISE)
        return raw

    tiles, rays = [], 0
    rows = renderer.rows_per_tile
    for row0 in range(0, static.height, rows):
        tile, tr = wavefront.render_tile(static, scene, renderer.camera,
                                         counting, geom, 0, row0, rows,
                                         renderer.use_dof)
        tiles.append(tile)
        rays += tr
    torch.cuda.synchronize()
    img = torch.cat(tiles, dim=0)[:static.height].cpu().numpy()
    return img, rays, work


def _ptxas_kernel(log: str):
    """(registers, spill store bytes) of the one kernel in nvcc's report."""
    regs = re.search(r"Used (\d+) registers", log)
    spill = re.search(r"(\d+) bytes spill stores", log)
    return int(regs.group(1)), int(spill.group(1)) if spill else 0


def _paged_equal(a, b, alive) -> bool:
    """Two sweeps' hits bit for bit: t and id on every ray, u and v on the
    alive ones (the dense sweep fills them on dead rays too)."""
    import torch

    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2][alive], b[2][alive])
            and torch.equal(a[3][alive], b[3][alive]))


def _compare_paged(name, o, d, tables, table16, alive, plain=True):
    """K3 vs its plain version (when ``plain``) and vs K2 over the same
    soup, on the same rays: bit for bit, and two launches byte-identical.
    Returns (plain seconds or None, K3's hits)."""
    import torch

    from raytrace_tpu_torch.ops import paged_tri, tri_sweep

    hit = paged_tri.intersect_tris_paged(o, d, tables, alive)
    again = paged_tri.intersect_tris_paged(o, d, tables, alive)
    k2 = tri_sweep.intersect_tris_sweep(o, d, table16, alive)
    torch.cuda.synchronize()
    plain_s = None
    checks = {"K2": _paged_equal(hit, k2, alive),
              "repeat": all(torch.equal(a, b) for a, b in zip(hit, again))}
    if plain:
        t0 = time.perf_counter()
        ref = paged_tri.paged_tri_sweep_reference(o, d, tables, alive)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        checks["plain"] = _paged_equal(hit, ref, alive)
    print(f"paged sweep {name}: R={o.x.shape[0]} T={tables.num_tris} "
          f"g={tables.g} c={tables.c} pages {tables.page_boxes.shape[0]} "
          f"alive {alive.double().mean().item():.4f}: bit for bit with "
          + ", ".join(f"{k} {v}" for k, v in checks.items())
          + f"; hit share {(hit.tri >= 0).double().mean().item():.4f}"
          + (f"; plain {plain_s:.3f} s" if plain else ""))
    if not all(checks.values()):
        raise AssertionError(f"K3 {name}: {checks}")
    return plain_s, hit


def _paged_random(T, g, c, R, seed, dev):
    """T random small triangles in a 10-unit box in the paged sweep's
    order, with a duplicate pair: (page tables, dense table, rays towards
    random triangles with a tenth in random directions, alive mask)."""
    import torch

    from raytrace_tpu_torch.ops import paged_tri, tri_sweep
    from raytrace_tpu_torch.ops.vec3 import V3

    rng = np.random.default_rng(seed)
    tri = (rng.uniform(-5, 5, (T, 1, 3))
           + rng.uniform(-0.8, 0.8, (T, 3, 3))).astype(np.float32)
    tri[T // 2] = tri[1]
    tri = tri[paged_tri.paged_tri_order(tri, T)]
    o = rng.uniform(-9, 9, (R, 3))
    d = np.einsum("rv,rvi->ri", rng.dirichlet(np.ones(3), R),
                  tri[rng.integers(0, T, R)].astype(np.float64)) - o
    d[:R // 10] = rng.standard_normal((R // 10, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v3 = lambda a: V3(*(torch.tensor(  # noqa: E731
        np.ascontiguousarray(a[:, i], np.float32), device=dev)
        for i in range(3)))
    wp = torch.tensor(tri, device=dev)
    return (paged_tri.build_page_tables(wp, T, g=g, c=c),
            tri_sweep.pack_tri_table(wp, T), v3(o), v3(d),
            torch.tensor(rng.random(R) < 0.7, device=dev))


def _k3_full(mesh_r, card):
    """K3 on final-one-weekend --mesh-geometry, the main path's soup: the
    frame's rays at every bounce of batch 0 (render_tile with a capturing
    trace); all primary rays bit for bit with the plain version (timed), a
    subset of them and of bounce 2's against K2 too; K3 timed over all
    primary rays; the work of the traversal counted on the subset and
    scaled to all primary rays for the bound.  Returns a dict."""
    import torch

    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.ops import paged_tri
    from raytrace_tpu_torch.ops.vec3 import V3

    static, geom = mesh_r.static, mesh_r._geometry(0)
    pages, table16 = geom.tri_pages, geom.tri_table16
    trace = wavefront.make_trace_fn(static, mesh_r.scene, geom)
    seen = []

    def capture(o, d, alive):
        seen.append((o, d, alive))
        return trace(o, d, alive)

    wavefront.render_tile(static, mesh_r.scene, mesh_r.camera, capture, geom,
                          0, 0, static.height, mesh_r.use_dof)
    torch.cuda.synchronize()
    (o, d, alive), later = seen[0], seen[2]
    del seen
    n_rays = o.x.shape[0]
    if n_rays != static.width * static.height * static.sqrt_spp ** 2:
        raise AssertionError(f"mesh primary rays: {n_rays}")
    plain_s, hit = _compare_paged(f"{n_rays} primary (all)", o, d, pages,
                                  table16, alive)
    del hit
    gen = torch.Generator().manual_seed(0)
    work = None
    for label, (ro, rd, ra) in (("primary", (o, d, alive)),
                                ("bounce 2", later)):
        sel = torch.randperm(ro.x.shape[0], generator=gen)[:MESH_SUBSET].to(
            ro.x.device)
        so, sd = (V3(*(x[sel].contiguous() for x in v)) for v in (ro, rd))
        sa = ra[sel].contiguous()
        _, hit = _compare_paged(f"{MESH_SUBSET} {label}", so, sd, pages,
                                table16, sa, plain=label != "primary")
        if label == "primary":
            work = paged_tri.visit_counts(so, sd, pages, hit.t, sa)
    ms = _median_ms(
        lambda: paged_tri.intersect_tris_paged(o, d, pages, alive), 5)
    scale = n_rays / work["rays"]
    flops = scale * ((work["page_tests"] + work["cluster_tests"])
                     * FLOPS_PER_PRETEST
                     + work["tri_tests"] * FLOPS_PER_TRI_TEST)
    # Rays in: origin, direction, alive; out: t, id, u, v; the triangle
    # rows, cluster boxes and page boxes once.
    nbytes = n_rays * (6 * 4 + 1 + 4 * 4) + 4 * (
        pages.tris.numel() + pages.boxes.numel() + pages.page_boxes.numel())
    bound = _bound(flops, nbytes)
    per = {k: work[k] / work["rays"] for k in ("page_tests",
                                              "cluster_tests", "tri_tests")}
    print(f"paged sweep time at R={n_rays} (final-one-weekend --mesh-geometry"
          f"'s primary rays), T={pages.num_tris}: kernel {ms:.3f} ms (median "
          f"of 5, CUDA events), plain PyTorch {plain_s * 1e3:.1f} ms (one "
          f"run, host clock); work counted on {work['rays']} of its rays: "
          f"{per['page_tests']:.1f} page tests, {per['cluster_tests']:.1f} "
          f"cluster tests and {per['tri_tests']:.1f} triangle tests a ray; "
          f"bound (an estimate) {bound[0]:.4f} ms by {bound[1]} "
          f"({bound[0] / ms:.4f} of it) ({card})")
    return dict(ms=ms, plain_ms=plain_s * 1e3, bound=bound)


def _median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms, by CUDA events.  A spin kernel
    of ~2 ms (at the H100's ~2 GHz clock) is queued before each start
    event, so the host's work inside ``fn`` (a wrapper's checks and
    parameter tensors) is done while the card is still busy, and the
    events measure the card's time alone: without it, a kernel shorter
    than its wrapper's host time (K4 on the earth) reads as the host
    time."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _compare_sweep(name, o, d, table8, alive):
    """Kernel vs plain version on the same rays.  A ray agrees when both
    give the same sphere id and t within rtol/atol; ids must agree on
    >= 99.9% of rays, and so must whole hits.  (A ray that starts within
    float error of T_MIN from a surface may keep the near root in one
    version and take the far root in the other.)  Returns max |dt| over
    the rays that agree."""
    import torch

    from raytrace_tpu_torch.ops import sphere_sweep
    from raytrace_tpu_torch.ops.intersect import T_MAX

    hit = sphere_sweep.intersect_spheres_sweep(o, d, table8, alive)
    t_ref, id_ref = sphere_sweep.sphere_sweep_reference(o, d, table8)
    t_ref = torch.where(alive, t_ref, T_MAX)
    id_ref = torch.where(alive, id_ref, -1)
    torch.cuda.synchronize()
    same_id = hit.sph == id_ref
    agree = same_id & ((hit.t - t_ref).abs() <= ATOL + RTOL * t_ref.abs())
    frac_id = same_id.double().mean().item()
    frac = agree.double().mean().item()
    if frac_id < AGREEMENT or frac < AGREEMENT:
        raise AssertionError(f"{name}: ids agree on {frac_id:.6f}, hits on "
                             f"{frac:.6f} of rays (need {AGREEMENT})")
    err = (hit.t[agree] - t_ref[agree]).abs().max().item()
    hits = (hit.sph >= 0).double().mean().item()
    print(f"sweep {name}: R={o.x.shape[0]} S8={table8.shape[0]}: ids agree "
          f"on {frac_id:.6f}, (id, t) on {frac:.6f} of rays "
          f"({int((same_id & ~agree).sum())} same-id root flips); hit share "
          f"{hits:.4f}; max |dt| where they agree {err:.3g}")
    return err


def _scene(cs, width, height, depth=None, batches=None):
    render = dataclasses.replace(
        cs.render, width=width, height=height,
        max_ray_depth=depth or cs.render.max_ray_depth,
        sample_batches=batches or cs.render.sample_batches)
    return dataclasses.replace(cs, render=render)


K4_COUNTS = ("LAUNCHES", "ANIM_LAUNCHES", "TRI_LAUNCHES", "LIGHT_LAUNCHES",
             "NOISE_LAUNCHES", "IMAGE_LAUNCHES", "SPHERE_CLUSTER_LAUNCHES")


def _hold_dense(label, args, kw, ref, ref_traced, card):
    """The dense form of a scene in clusters, on the same batch with the
    cluster layout dropped: launched as the dense form, two launches
    byte-identical, and its sums and traced counts byte-equal to the plain
    version's (``ref``, ``ref_traced``).  Skipped where the dense gate
    refuses the scene (above its sphere cap).  Its launches are taken off
    K4's counts again, so that the caller counts the clustered ones."""
    import torch

    from raytrace_tpu_torch.ops import megakernel

    flat = dataclasses.replace(args[0], sph_prefix=0)
    if not megakernel.megakernel_supported(flat):
        print(f"dense form {label}: not held (the dense gate refuses "
              f"{flat.num_spheres} spheres)")
        return
    counts = {name: getattr(megakernel, name) for name in K4_COUNTS}
    sums, traced = megakernel.render_tile_mega(flat, *args[1:], **kw)
    again, traced2 = megakernel.render_tile_mega(flat, *args[1:], **kw)
    torch.cuda.synchronize()
    launched = (megakernel.LAUNCHES - counts["LAUNCHES"],
                megakernel.SPHERE_CLUSTER_LAUNCHES
                - counts["SPHERE_CLUSTER_LAUNCHES"])
    for name, n in counts.items():
        setattr(megakernel, name, n)
    repeat = torch.equal(sums, again) and torch.equal(traced, traced2)
    bitwise = torch.equal(sums, ref) and torch.equal(traced, ref_traced)
    print(f"dense form {label}: bit for bit with the plain version: "
          f"{bitwise}; repeat launch byte-identical: {repeat} ({card})")
    if launched != (2, 0):
        raise AssertionError(f"{label}: the dense form was not launched "
                             f"(K4 +{launched[0]}, clustered "
                             f"+{launched[1]})")
    if not (repeat and bitwise):
        raise AssertionError(f"{label}: the dense form and the plain "
                             f"version disagree")


def _compare_fused(label, renderer, k, mean_tol, pixel_share, card,
                   bitwise_required=False):
    """K4 vs its plain version on batches 0..k-1 of ``renderer``'s frame.
    Rays within 0.5%, per-sample channel means within mean_tol, and (when
    pixel_share is set) at most that share of pixels with a max-channel
    difference above 1e-4, or bit for bit when ``bitwise_required``; two
    launches must give the same bytes.  A scene in clusters also has its
    dense form held to the plain version bit for bit (_hold_dense).
    Returns (max |sums difference|, launch args, launch keywords, rays,
    plain seconds)."""
    import torch

    from raytrace_tpu_torch.ops import megakernel

    if not renderer.use_megakernel:
        raise AssertionError(f"{label}: the gate rejected the scene")
    args = (renderer.static, renderer.scene, renderer._geometry(0),
            renderer.camera, 0, k)
    kw = dict(use_dof=renderer.use_dof, times=renderer.batch_times_dev)
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    again, traced2 = megakernel.render_tile_mega(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not (torch.equal(sums, again) and torch.equal(traced, traced2)):
        raise AssertionError(f"{label}: two launches differ")
    if not torch.isfinite(sums).all():
        raise AssertionError(f"{label}: non-finite sums")
    n = renderer.static.sqrt_spp ** 2 * k
    rays, ref_rays = int(traced.sum()), int(ref_traced.sum())
    mdiff = ((sums.mean((0, 1)) - ref.mean((0, 1))).abs().max() / n).item()
    pix = (sums - ref).abs().amax(-1)
    bad = (pix > 1e-4).double().mean().item()
    err = pix.max().item()
    bitwise = torch.equal(sums, ref) and torch.equal(traced, ref_traced)
    print(f"fused {label}: rays {rays} vs plain {ref_rays}; per-sample "
          f"channel-mean diff {mdiff:.3g}; pixels above 1e-4: {bad:.6f}; "
          f"traced counts equal on "
          f"{(traced == ref_traced).double().mean().item():.6f} of pixels; "
          f"max |dsum| {err:.3g}; bit for bit: {bitwise}; repeat launch "
          f"byte-identical ({card})")
    if abs(rays - ref_rays) > 0.005 * ref_rays or mdiff > mean_tol or (
            pixel_share is not None and bad > pixel_share) or (
            bitwise_required and not bitwise):
        raise AssertionError(f"{label}: kernel and plain version disagree")
    if megakernel.sphere_cluster_layout(renderer.static) is not None:
        _hold_dense(label, args, kw, ref, ref_traced, card)
    return err, args, kw, rays, plain_s


def _check_image(img, label, width=WIDTH, height=HEIGHT):
    means = img.mean(axis=(0, 1))
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{label}: image is not a finite [H, W, 3] array")
    if (img < 0).any() or not ((means > 0.05) & (means < 1.5)).all():
        raise AssertionError(f"{label}: image out of range: means {means}")
    print(f"{label} image: channel means {means.tolist()}")


def _step(renderer, batches):
    """Render ``batches`` one by one; [(rays, seconds)] per batch."""
    out = []
    for _ in range(batches):
        rays0, sec0 = renderer.stats.rays_traced, renderer.stats.render_seconds
        if not renderer.render_next_batch():
            raise AssertionError("render_next_batch returned False")
        out.append((renderer.stats.rays_traced - rays0,
                    renderer.stats.render_seconds - sec0))
    return out


def _reset_counts():
    """Every kernel's launch count to 0."""
    from raytrace_tpu_torch.ops import (megakernel, paged_tri, sphere_sweep,
                                        tri_sweep)

    sphere_sweep.LAUNCHES = tri_sweep.LAUNCHES = paged_tri.LAUNCHES = 0
    megakernel.LAUNCHES = megakernel.ANIM_LAUNCHES = 0
    megakernel.TRI_LAUNCHES = megakernel.LIGHT_LAUNCHES = 0
    megakernel.NOISE_LAUNCHES = megakernel.IMAGE_LAUNCHES = 0
    megakernel.SPHERE_CLUSTER_LAUNCHES = 0


def _mrays(per_batch):
    return sum(r for r, _ in per_batch) / sum(s for _, s in per_batch) / 1e6


def _busy_share(events, label, wall_s, kernel="megakernel"):
    """The device timeline of the work profiled under
    record_function(label): the card's operation intervals that start
    inside that host range (the work ends in a synchronize), without the
    range's own device-side annotation, which spans the whole range and
    is no operation of the card's.  Returns a
    dict: ``busy_s``, their union; ``timeline``, the union over the span
    from the first operation's start to the last one's end (the traced
    window's own device timeline: what is not busy there is the card
    waiting between its operations); ``wall``, the union over wall_s, an
    untraced run's host time; ``ops``, the operations; ``kernel``, the
    share of the union in the kernel whose name holds ``kernel``."""
    from torch.autograd import DeviceType

    host = [e for e in events
            if e.name == label and e.device_type == DeviceType.CPU]
    if len(host) != 1:
        raise AssertionError(f"profile: {len(host)} host ranges '{label}'")
    lo, hi = host[0].time_range.start, host[0].time_range.end
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.name != label and lo <= e.time_range.start <= hi)
    busy, end, k4 = 0.0, -1.0, 0.0
    for s, e, name in spans:
        if kernel in name:
            k4 += e - s
        if e > end:
            busy += e - max(s, end)
            end = e
    window = (max(e for _, e, _ in spans) - spans[0][0]) if spans else 0.0
    return dict(busy_s=busy / 1e6, timeline=busy / window if window else 0.0,
                wall=busy / 1e6 / wall_s, ops=len(spans),
                kernel=k4 / busy if busy else 0.0)


def _paged_vs_dense(label, paged_cs, dev, card):
    """A reduced frame of a soup in paged order, one batch at full depth,
    on the paged sweep and on the dense sweep K2: the same bytes and the
    same ray count."""
    from raytrace_tpu_torch.engine import Renderer

    small = _scene(paged_cs, *REDUCED, batches=1)
    out = {}
    for mode in ("paged", False):
        r = Renderer(small, device=dev, use_bvh=mode)
        (rays, sec), = _step(r, 1)
        out[mode] = (r.image(), rays, sec)
    same = out["paged"][0].tobytes() == out[False][0].tobytes()
    print(f"{label} at {REDUCED[0]}x{REDUCED[1]}, depth "
          f"{small.render.max_ray_depth}, one batch: paged and dense images "
          f"byte-identical {same}; rays {out['paged'][1]} vs "
          f"{out[False][1]}; {out['paged'][2]:.3f} s vs {out[False][2]:.3f} "
          f"s ({card})")
    if not same or out["paged"][1] != out[False][1]:
        raise AssertionError(f"{label}: the paged and dense renders differ")


def _mesh_paths(mesh_r, mb_scene, fused_img, wave_img, dev, card):
    """The big-mesh paths: ``mesh_r`` (final-one-weekend --mesh-geometry,
    Renderer with defaults) stepped as the main path, the reduced-frame
    identity on its soup, and one batch of the motion-blur scene with
    --mesh-geometry.  Returns K3's launches on the main path."""
    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import (megakernel, paged_tri, sphere_sweep,
                                        tri_sweep)

    # The big-mesh main path: final-one-weekend --mesh-geometry through
    # Renderer with defaults, the paged wavefront (K3 alone: no sphere is
    # left, and K2 and K4 must not run), its batches stepped.
    _reset_counts()
    per_batch = _step(mesh_r, MAIN_BATCHES)
    k3_launches = paged_tri.LAUNCHES
    if (mesh_r.path != "wavefront" or k3_launches <= 0 or tri_sweep.LAUNCHES
            or megakernel.LAUNCHES or sphere_sweep.LAUNCHES):
        raise AssertionError(
            f"the mesh main path did not take the paged wavefront (path "
            f"{mesh_r.path}, K3 {k3_launches}, K2 {tri_sweep.LAUNCHES}, K4 "
            f"{megakernel.LAUNCHES}, K1 {sphere_sweep.LAUNCHES})")
    for i, (r, s) in enumerate(per_batch):
        print(f"mesh paged batch {i}: {r} rays in {s:.4f} s "
              f"({r / s / 1e6:.3f} Mrays/s)")
    print(f"mesh main path (wavefront, paged triangles): final-one-weekend "
          f"--mesh-geometry {WIDTH}x{HEIGHT}, 4 spp, depth 50: "
          f"{_mrays(per_batch[1:]):.3f} Mrays/s over batches "
          f"1-{MAIN_BATCHES - 1} stepped one at a time; paged_tri "
          f"LAUNCHES={k3_launches}, tri_sweep, megakernel and sphere_sweep "
          f"LAUNCHES=0 ({card})")
    mesh_img = mesh_r.image()
    _check_image(mesh_img, "mesh paged")
    print(f"mesh vs analytic spheres over batches 0-{MAIN_BATCHES - 1}: "
          f"channel means {mesh_img.mean(axis=(0, 1)).tolist()} (mesh), "
          f"{fused_img.mean(axis=(0, 1)).tolist()} (fused), "
          f"{wave_img.mean(axis=(0, 1)).tolist()} (wavefront)")

    # The whole path bit for bit: a reduced frame of the same permuted
    # soup on the paged sweep and on the dense sweep K2.
    _paged_vs_dense("mesh", mesh_r.compiled, dev, card)

    # Motion blur with meshes: final-one-weekend-motion-blur
    # --mesh-geometry, its page tables built for every batch from that
    # batch's world soup.
    cs_mb_mesh = cli.load_scene(mb_scene, analytic_spheres=False)
    mb_mesh = Renderer(cs_mb_mesh, device=dev)
    builds = []
    build_tables = paged_tri.build_page_tables
    paged_tri.build_page_tables = lambda *a, **k: (  # noqa: E731
        builds.append(1), build_tables(*a, **k))[1]
    _reset_counts()
    try:
        (mb_rays, mb_s), = _step(mb_mesh, 1)
    finally:
        paged_tri.build_page_tables = build_tables
    if (mb_mesh.path != "wavefront" or mb_mesh.static.bvh_mode != "paged"
            or not mb_mesh.static.any_animated or len(builds) != 1
            or paged_tri.LAUNCHES <= 0 or tri_sweep.LAUNCHES
            or megakernel.LAUNCHES):
        raise AssertionError(
            f"the motion-blur mesh did not take the paged wavefront with "
            f"per-batch tables (path {mb_mesh.path}, tables built "
            f"{len(builds)}, K3 {paged_tri.LAUNCHES})")
    print(f"motion-blur mesh (wavefront, paged triangles, tables per "
          f"batch): final-one-weekend-motion-blur --mesh-geometry "
          f"{MB_WIDTH}x{MB_HEIGHT}, {cs_mb_mesh.num_triangles} triangles, "
          f"one batch: {mb_rays} rays in {mb_s:.4f} s "
          f"({mb_rays / mb_s / 1e6:.3f} Mrays/s); paged_tri "
          f"LAUNCHES={paged_tri.LAUNCHES} ({card})")
    _check_image(mb_mesh.image(), "motion-blur mesh paged", MB_WIDTH,
                 MB_HEIGHT)
    _paged_vs_dense("motion-blur mesh", mb_mesh.compiled, dev, card)
    return k3_launches



class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs one CUDA card", file=sys.stderr)
        return 1
    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.engine.renderer import RenderStats
    from raytrace_tpu_torch.engine.wavefront import prepare_batch, primary_rays
    from raytrace_tpu_torch.models import compile_scene
    from raytrace_tpu_torch.ops import (_build, megakernel, paged_tri,
                                        sphere_sweep, tri_sweep)
    from raytrace_tpu_torch.ops.vec3 import V3
    from raytrace_tpu_torch.scene_file import SceneFile
    from raytrace_tpu_torch.tools import (image_scenes, light_scenes,
                                          noise_scenes, stress_scenes)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    tri_dir = tempfile.TemporaryDirectory()

    # -- 2. build the four kernels, one nvcc each, started together ---------
    def timed_build(mod):
        t0 = time.perf_counter()
        mod.library()
        return time.perf_counter() - t0

    mods = {"sphere_sweep": sphere_sweep, "tri_sweep": tri_sweep,
            "megakernel": megakernel, "paged_tri": paged_tri}
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        secs = dict(zip(mods, pool.map(timed_build, mods.values())))
    for name, sec in secs.items():
        print(f"build: csrc/{name}.cu in {sec:.2f} s")
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())
    forms = _ptxas_forms(_build.library_path("megakernel").with_suffix(
        ".log").read_text())
    if sorted(f for f, _, _ in forms) != K4_FORMS:
        raise AssertionError(f"K4's forms in nvcc's report: {forms}")
    for form, regs, spill in forms:
        print(f"K4 {form} form: {regs} registers, {spill} bytes spill "
              f"stores")
        before = {**FORMS_BEFORE, **IMAGE_FORMS_BEFORE}
        if before.get(form, (regs, spill)) != (regs, spill):
            raise AssertionError(f"K4's {form} form changed: {regs} "
                                 f"registers, {spill} bytes spilled, "
                                 f"before {before[form]}")
    k3_regs, k3_spill = _ptxas_kernel(_build.library_path(
        "paged_tri").with_suffix(".log").read_text())
    print(f"K3: {k3_regs} registers, {k3_spill} bytes spill stores")

    # -- 3. K1 vs plain at the main path's shapes ---------------------------
    cs = cli.load_scene(cli.DEFAULT_SCENE, WIDTH, HEIGHT)
    probe = Renderer(cs, device=dev, use_megakernel=False)
    geom = prepare_batch(probe.static, probe.scene,
                         torch.tensor(probe.sphere_tables[0], device=dev))
    table8 = geom.sph_table8
    _, o, d = primary_rays(probe.static, probe.camera, 0, 0, HEIGHT,
                           probe.use_dof, dev)
    if o.x.shape[0] != WIDTH * HEIGHT * 4:
        raise AssertionError(f"primary rays: {o.x.shape[0]}")
    alive = torch.ones(o.x.shape[0], dtype=torch.bool, device=dev)
    k1_err = _compare_sweep("primary", o, d, table8, alive)

    rng = np.random.default_rng(0)
    # Origins in the scene's air (its ground fills y > 0).
    ro = rng.uniform([-14.0, -4.0, -14.0], [14.0, -0.05, 14.0],
                     (RANDOM_RAYS, 3)).astype(np.float32)
    rd = rng.standard_normal((RANDOM_RAYS, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    to_v3 = lambda a: V3(*(torch.tensor(np.ascontiguousarray(a[:, i]),  # noqa
                                        device=dev) for i in range(3)))
    r_alive = torch.tensor(rng.random(RANDOM_RAYS) < 0.75, device=dev)
    k1_err = max(k1_err, _compare_sweep("random", to_v3(ro), to_v3(rd),
                                        table8, r_alive))

    ms = _median_ms(
        lambda: sphere_sweep.intersect_spheres_sweep(o, d, table8, alive), 20)
    plain_ms = _median_ms(
        lambda: sphere_sweep.sphere_sweep_reference(o, d, table8), 5)
    n_rays, s8 = o.x.shape[0], table8.shape[0]
    # Rays in: origin, direction, alive; out: t and id; the table once.
    k1_bound = _bound(n_rays * s8 * FLOPS_PER_TEST,
                      n_rays * (6 * 4 + 1 + 4 + 4) + table8.numel() * 4)
    print(f"sweep time at R={n_rays}, S8={s8}: kernel {ms:.3f} ms, plain "
          f"PyTorch {plain_ms:.3f} ms (median, CUDA events); bound "
          f"{k1_bound[0]:.4f} ms by {k1_bound[1]} ({card})")
    del probe, geom, o, d, alive

    # -- 3b. K2 vs plain at tri-stress's shapes ------------------------------
    tri_cs, tri_json = _tri_stress(TRI_K, TRI_WIDTH, tri_dir.name)
    if (tri_cs.render.width, tri_cs.render.height) != (TRI_WIDTH, TRI_HEIGHT):
        raise AssertionError("tri-stress's size changed")
    probe = Renderer(tri_cs, device=dev, use_megakernel=False)
    if (probe.static.num_triangles, probe.static.tri_cluster_g) != (
            TRI_K * TRI_K * 960, 128):
        raise AssertionError("tri-stress: unexpected soup "
                             f"{probe.static.num_triangles} / "
                             f"{probe.static.tri_cluster_g}")
    table16 = probe._geometry(0).tri_table16
    _, o, d = primary_rays(probe.static, probe.camera, 0, 0, TRI_HEIGHT,
                           probe.use_dof, dev)
    n_rays = o.x.shape[0]
    if n_rays != TRI_WIDTH * TRI_HEIGHT * 16:
        raise AssertionError(f"tri-stress primary rays: {n_rays}")
    alive = torch.ones(n_rays, dtype=torch.bool, device=dev)
    sel = torch.tensor(rng.choice(n_rays, TRI_SUBSET, replace=False),
                       device=dev)
    k2_err = _compare_tris(f"{TRI_SUBSET} primary", V3(*(c[sel] for c in o)),
                           V3(*(c[sel] for c in d)), table16, alive[sel])

    # Random rays against tri-stress k=1's 960 triangles: from around the
    # soup towards random points of random triangles, a tenth of them in
    # random directions.
    small_cs, _ = _tri_stress(1, 96, tri_dir.name)
    soup = Renderer(small_cs, device=dev, use_megakernel=False)._geometry(0)
    wp = soup.world_p[:960].double().cpu().numpy()
    lo, hi = wp.min((0, 1)), wp.max((0, 1))
    span = np.maximum(hi - lo, 1.0)
    ro = rng.uniform(lo - span, hi + span, (RANDOM_RAYS, 3))
    pick = rng.integers(0, 960, RANDOM_RAYS)
    bary = rng.dirichlet(np.ones(3), RANDOM_RAYS)
    rd = np.einsum("rv,rvi->ri", bary, wp[pick]) - ro
    rd[:RANDOM_RAYS // 10] = rng.standard_normal((RANDOM_RAYS // 10, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    r_alive = torch.tensor(rng.random(RANDOM_RAYS) < 0.75, device=dev)
    k2_err = max(k2_err, _compare_tris(
        "random", to_v3(ro.astype(np.float32)), to_v3(rd.astype(np.float32)),
        soup.tri_table16, r_alive))

    k2_ms = _median_ms(
        lambda: tri_sweep.intersect_tris_sweep(o, d, table16, alive), 5)
    t0 = time.perf_counter()
    tri_sweep.tri_sweep_reference(o, d, table16)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    t8 = table16.shape[0]
    # Rays in: origin, direction, alive; out: t, id, u, v; the table once.
    k2_bound = _bound(n_rays * t8 * FLOPS_PER_TRI_TEST,
                      n_rays * (6 * 4 + 1 + 4 * 4) + table16.numel() * 4)
    print(f"triangle sweep time at R={n_rays} (tri-stress's primary rays), "
          f"T8={t8}: kernel {k2_ms:.3f} ms (median of 5), plain PyTorch "
          f"{k2_plain_ms:.3f} ms (one run); "
          f"{n_rays * t8 / k2_ms / 1e6:.4g}G ray-triangle tests/s; bound "
          f"{k2_bound[0]:.4f} ms by {k2_bound[1]} "
          f"({k2_bound[0] / k2_ms:.3f} of it) ({card})")
    del probe, soup, table16, o, d, alive, sel

    # -- 4. K4 vs plain -----------------------------------------------------
    small = _scene(cs, 96, 54, depth=8, batches=2)
    k4_err, *_ = _compare_fused("96x54 depth 8 k=2",
                                Renderer(small, device=dev), 2, 1e-3, 0.05,
                                card)
    full = Renderer(cs, device=dev)
    before = megakernel.SPHERE_CLUSTER_LAUNCHES
    err_full, args, kw, k4_rays, _ = _compare_fused(
        f"{WIDTH}x{HEIGHT} 4 spp depth 50 k=1", full, 1, 2e-3, None, card,
        bitwise_required=True)
    if megakernel.SPHERE_CLUSTER_LAUNCHES != before + 2:
        raise AssertionError("final-one-weekend did not take K4's clustered "
                             "sphere form")
    k4_err = max(k4_err, err_full)
    k4_ms = _median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    k4_plain_ms = _median_ms(
        lambda: megakernel.megakernel_reference(*args, **kw), 2)
    k4_dense_ms = _dense_ms(args, kw)
    dense_bound = _k4_bound(full.static, args[2], k4_rays, WIDTH, HEIGHT, 0)
    _, _, per_ray = _cluster_work(
        Renderer(cs, device=dev, use_megakernel=False), args[2])
    k4_bound = _cluster_bound(args[2], per_ray, k4_rays, WIDTH, HEIGHT, 0)
    print(f"fused kernel (clustered static form) time at {WIDTH}x{HEIGHT}, 4 "
          f"spp, depth 50, one batch: kernel {k4_ms:.3f} ms (median of 5), "
          f"the dense form {k4_dense_ms:.3f} ms (median of 5), plain "
          f"PyTorch {k4_plain_ms:.3f} ms (median of 2) (CUDA events); work "
          f"counted on {CLUSTER_SUBSET} of the wavefront's rays, a bounce: "
          f"{per_ray['prefix_tests']:.0f} prefix tests, "
          f"{per_ray['box_tests']:.0f} box pretests, "
          f"{per_ray['sphere_tests']:.2f} sphere tests in clusters that "
          f"pass; bound {k4_bound[0]:.4f} ms by {k4_bound[1]} "
          f"({k4_bound[0] / k4_ms:.4f} of it), the dense sweep's "
          f"{dense_bound[0]:.4f} ms by {dense_bound[1]} ({card})")
    del full, args, kw

    # -- 4b. K4's animated form vs plain, on the motion-blur scene ----------
    mb_scene = os.path.join(os.path.dirname(cli.DEFAULT_SCENE),
                            "final-one-weekend-motion-blur.json")
    cs_mb = cli.load_scene(mb_scene)
    if (cs_mb.render.width, cs_mb.render.height) != (MB_WIDTH, MB_HEIGHT):
        raise AssertionError("the motion-blur scene's size changed")
    mb_small = Renderer(_scene(cs_mb, 96, 54, depth=8, batches=2),
                        device=dev)
    mb_full = Renderer(cs_mb, device=dev)
    if mb_small.path != "fused_anim" or mb_full.path != "fused_anim":
        raise AssertionError("the motion-blur scene did not take the "
                             "animated fused path")
    anim_err, *_ = _compare_fused("motion-blur 96x54 depth 8 k=2",
                                  mb_small, 2, 1e-3, 0.05, card)
    before = megakernel.SPHERE_CLUSTER_LAUNCHES
    err_full, args, kw, anim_rays, _ = _compare_fused(
        f"motion-blur {MB_WIDTH}x{MB_HEIGHT} 4 spp depth 50 k=1", mb_full,
        1, 2e-3, None, card, bitwise_required=True)
    if megakernel.SPHERE_CLUSTER_LAUNCHES != before + 2:
        raise AssertionError("the motion-blur scene did not take K4's "
                             "clustered animated form")
    anim_err = max(anim_err, err_full)
    anim_ms = _median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    anim_plain_ms = _median_ms(
        lambda: megakernel.megakernel_reference(*args, **kw), 2)
    anim_dense_ms = _dense_ms(args, kw)
    n_times = len(mb_full.batch_times)
    dense_bound = _k4_bound(mb_full.static, args[2], anim_rays, MB_WIDTH,
                            MB_HEIGHT, n_times)
    _, _, per_ray = _cluster_work(
        Renderer(cs_mb, device=dev, use_megakernel=False), args[2],
        mb_full.batch_times_dev)
    anim_bound = _cluster_bound(args[2], per_ray, anim_rays, MB_WIDTH,
                                MB_HEIGHT, n_times)
    print(f"animated fused kernel (clustered) time at {MB_WIDTH}x"
          f"{MB_HEIGHT}, 4 spp, depth 50, one batch: kernel {anim_ms:.3f} ms "
          f"(median of 5), the dense form {anim_dense_ms:.3f} ms (median of "
          f"5), plain PyTorch {anim_plain_ms:.3f} ms (median of 2) (CUDA "
          f"events); work a bounce: {per_ray['prefix_tests']:.0f} prefix "
          f"tests, {per_ray['box_tests']:.0f} box pretests, "
          f"{per_ray['sphere_tests']:.2f} sphere tests; bound "
          f"{anim_bound[0]:.4f} ms by {anim_bound[1]} "
          f"({anim_bound[0] / anim_ms:.4f} of it), the dense sweep's "
          f"{dense_bound[0]:.4f} ms by {dense_bound[1]} ({card})")
    del mb_small, mb_full, args, kw

    # -- 4c. K4's triangle form vs plain, on tri-stress and the fixture -----
    fixture = compile_scene(SceneFile.from_json_dict(
        stress_scenes.triangle_fixture_doc()), width=96)
    tris_err = 0.0
    for label, small_cs in (
            ("tri-stress k=1", _tri_stress(1, 96, tri_dir.name, 8, 2)[0]),
            (f"tri-stress k={TRI_K}",
             _tri_stress(TRI_K, 96, tri_dir.name, 8, 2)[0]),
            ("triangle fixture", _scene(fixture, 96, 54, 8, 2))):
        r = Renderer(small_cs, device=dev)
        if r.path != "fused":
            raise AssertionError(f"{label}: path {r.path}, not fused")
        small_err, *_ = _compare_fused(f"{label} 96x54 depth 8 k=2", r, 2,
                                       1e-3, None, card,
                                       bitwise_required=True)
        tris_err = max(tris_err, small_err)
    tri_full = Renderer(tri_cs, device=dev)
    if tri_full.path != "fused":
        raise AssertionError(f"tri-stress: path {tri_full.path}, not fused")
    err_full, args, kw, tris_rays, tris_plain_s = _compare_fused(
        f"tri-stress-15360 {TRI_WIDTH}x{TRI_HEIGHT} 16 spp depth 50 k=1",
        tri_full, 1, 2e-3, None, card)
    tris_err = max(tris_err, err_full)
    tris_ms = _median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    tris_plain_ms = tris_plain_s * 1e3
    sums, _ = megakernel.render_tile_mega(*args, **kw)
    # The image as the Renderer folds it (sums / spp per pixel); its mean
    # on the host, as the wavefront image's (a float32 mean of the sums on
    # the card rounds by ~1e-3 at this size).
    fused_img = (sums / tri_full.static.sqrt_spp ** 2).cpu().numpy()
    # The same batch on the wavefront with K2 and K1, counting the work
    # of the kernel's bound on its rays.
    wave_img, wave_rays, work = _tri_work(
        Renderer(tri_cs, device=dev, use_megakernel=False))
    mdiff = np.abs(fused_img.mean(axis=(0, 1))
                   - wave_img.mean(axis=(0, 1))).max()
    print(f"fused (triangle form) vs wavefront with K2 on tri-stress-15360's "
          f"batch at {TRI_WIDTH}x{TRI_HEIGHT}, 16 spp, depth 50: rays "
          f"{tris_rays} vs {wave_rays}, max channel-mean diff {mdiff:.3g} "
          f"({card})")
    if abs(tris_rays - wave_rays) > 0.005 * wave_rays or mdiff > 2e-3:
        raise AssertionError("tri-stress: the fused and wavefront renders "
                             "disagree")
    tris_bound = _k4_tris_bound(args[0], args[2], work, TRI_WIDTH,
                                TRI_HEIGHT)
    print(f"fused kernel (triangle form) time at {TRI_WIDTH}x{TRI_HEIGHT}, "
          f"16 spp, depth 50, one batch: kernel {tris_ms:.3f} ms (median of "
          f"5, CUDA events), plain PyTorch {tris_plain_ms:.1f} ms (one run, "
          f"host clock); work counted on the wavefront's rays: "
          f"{work['rays']} bounces, {work['pretests']} cluster pretests, "
          f"{work['tri_tests']} triangle tests in clusters that pass against "
          f"the sphere hit ({work['tri_tests'] / max(work['rays'], 1):.1f} a "
          f"bounce, of {TRI_K * TRI_K * 960}); bound (an estimate) "
          f"{tris_bound[0]:.4f} ms by {tris_bound[1]} ({card})")
    del tri_full, args, kw, sums

    # -- 4d. K4's lit forms vs plain, on the light scenes --------------------
    light_paths = dict(zip(light_scenes.DOCS,
                           light_scenes.write_light_scenes(tri_dir.name)))
    light_cs = {name: cli.load_scene(path)
                for name, path in light_paths.items()}
    light_size = {"cornell-style": (1024, 1024),
                  "sphere-light-962": (1024, 576)}
    for name, size in light_size.items():
        if (light_cs[name].render.width, light_cs[name].render.height,
                light_cs[name].render.samples_per_pixel) != (*size, 64):
            raise AssertionError(f"{name}'s size changed")
    small_docs = {"cornell-style": light_scenes.cornell_doc(),
                  "sphere-light-962": light_scenes.sphere_light_doc(),
                  "lit spheres": light_scenes.lit_spheres_doc(),
                  "70 instances": light_scenes.many_instances_doc(70)}
    lights_err = 0.0
    for label, doc in small_docs.items():
        small_cs = compile_scene(SceneFile.from_json_dict(doc),
                                 width=LIGHT_SMALL[label])
        w, h = small_cs.render.width, small_cs.render.height
        r = Renderer(_scene(small_cs, w, h, 50, 2), device=dev)
        if r.path != "fused" or not r.static.has_lights:
            raise AssertionError(f"{label}: path {r.path}, not the lit "
                                 f"fused form")
        small_err, *_ = _compare_fused(
            f"lit {label} {w}x{h} depth 50 k=2 "
            f"({'with' if r.static.has_tris else 'no'} triangles, "
            f"{r.static.num_instances} instances, "
            f"{r.scene.light_tri_packed.shape[0]} lights)", r, 2, 1e-3,
            None, card,
            bitwise_required=True)
        lights_err = max(lights_err, small_err)
    light_full = {}
    for name, (w, h) in light_size.items():
        r = Renderer(light_cs[name], device=dev)
        if r.path != "fused":
            raise AssertionError(f"{name}: path {r.path}, not fused")
        # The full batch bit for bit with the plain version.
        err_full, args, kw, lit_rays, plain_s = _compare_fused(
            f"lit {name} {w}x{h} 64 spp depth 50 k=1", r, 1, 0.0, None, card,
            bitwise_required=True)
        lights_err = max(lights_err, err_full)
        lit_ms = _median_ms(
            lambda: megakernel.render_tile_mega(*args, **kw), 5)
        sums, _ = megakernel.render_tile_mega(*args, **kw)
        fused_img = (sums / r.static.sqrt_spp ** 2).cpu().numpy()
        # The same batch on the wavefront with K2 (and K1 for the spheres),
        # counting the work of the kernel's bound on its rays.
        t0 = time.perf_counter()
        wave_img, wave_rays, work = _tri_work(
            Renderer(light_cs[name], device=dev, use_megakernel=False))
        wave_s = time.perf_counter() - t0
        mdiff = np.abs(fused_img.mean(axis=(0, 1))
                       - wave_img.mean(axis=(0, 1))).max()
        bound = _k4_tris_bound(r.static, args[2], work, w, h, scene=r.scene)
        print(f"fused (lit form) vs wavefront with K2 on {name}'s batch at "
              f"{w}x{h}, 64 spp, depth 50: rays {lit_rays} vs {wave_rays}, "
              f"max channel-mean diff {mdiff:.3g}; the wavefront's batch "
              f"{wave_s:.2f} s with the work count ({card})")
        if (abs(lit_rays - wave_rays) > 0.005 * wave_rays
                or mdiff > LIGHT_MEAN_TOL):
            raise AssertionError(f"{name}: the fused and wavefront renders "
                                 f"disagree")
        print(f"fused kernel (lit form) time on {name} at {w}x{h}, 64 spp, "
              f"depth 50, one batch: kernel {lit_ms:.3f} ms (median of 5, "
              f"CUDA events), plain PyTorch {plain_s * 1e3:.1f} ms (one run, "
              f"host clock), {lit_rays / lit_ms / 1e3:.1f} Mrays/s in the "
              f"kernel; work "
              f"counted on the wavefront's rays: {work['rays']} bounces of "
              f"{work['samples']} samples, {work['pretests']} cluster "
              f"pretests, {work['tri_tests']} triangle tests, "
              f"{work['rays'] - work['samples']} NEE steps, "
              f"{work['noise_hits']} noise hits; bound (an "
              f"estimate) {bound[0]:.4f} ms by {bound[1]} "
              f"({bound[0] / lit_ms:.4f} of it) ({card})")
        light_full[name] = dict(ms=lit_ms, plain_ms=plain_s * 1e3,
                                bound=bound)
        del r, args, kw, sums

    # -- 4e. K4's noise forms vs plain, and perlin-spheres' full batch -------
    with open(mb_scene) as f:
        form_docs = noise_scenes.form_checks(json.load(f))
    noise_err = 0.0
    for form, (doc, w, depth) in form_docs.items():
        small_cs = compile_scene(SceneFile.from_json_dict(doc), width=w)
        r = Renderer(_scene(small_cs, small_cs.render.width,
                            small_cs.render.height, depth, 2), device=dev)
        shape = (r.path == "fused_anim", r.static.has_tris,
                 r.static.has_lights)
        if not (r.use_megakernel and r.static.flags.has_noise) or shape != (
                form == "anim", "tris" in form, "lights" in form):
            raise AssertionError(f"noise {form}: path {r.path}, not K4's "
                                 f"{form} noise form")
        before = megakernel.NOISE_LAUNCHES
        small_err, *_ = _compare_fused(
            f"noise {form} {r.static.width}x{r.static.height} depth {depth} "
            f"k=2 ({r.path})", r, 2, 1e-3, None, card, bitwise_required=True)
        if megakernel.NOISE_LAUNCHES != before + 2:
            raise AssertionError(f"noise {form}: the noise form was not "
                                 f"launched")
        noise_err = max(noise_err, small_err)
    perlin_json = noise_scenes.write_perlin_spheres(tri_dir.name)
    perlin_cs = cli.load_scene(perlin_json)
    pr = perlin_cs.render
    if (pr.width, pr.height, pr.samples_per_pixel, pr.sample_batches,
            pr.max_ray_depth) != (*PERLIN_SIZE, 16, 1, 50):
        raise AssertionError("perlin-spheres' settings changed")
    perlin_full = Renderer(perlin_cs, device=dev)
    if perlin_full.path != "fused":
        raise AssertionError(f"perlin-spheres: path {perlin_full.path}")
    err_full, args, kw, noise_rays, noise_plain_s = _compare_fused(
        "perlin-spheres 1024x576 16 spp depth 50 k=1", perlin_full, 1, 0.0,
        None, card, bitwise_required=True)
    noise_err = max(noise_err, err_full)
    noise_ms = _median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    sums, _ = megakernel.render_tile_mega(*args, **kw)
    perlin_fused_img = (sums / pr.samples_per_pixel).cpu().numpy()
    work = _plain_work(args, kw)
    if work["rays"] != noise_rays:
        raise AssertionError("perlin-spheres: the counted rays differ")
    noise_bound = _noise_bound(perlin_full.static, args[2], work,
                               *PERLIN_SIZE)
    print(f"fused kernel (noise form) time on perlin-spheres at 1024x576, 16 "
          f"spp, depth 50, one batch: kernel {noise_ms:.3f} ms (median of 5, "
          f"CUDA events), plain PyTorch {noise_plain_s * 1e3:.1f} ms (one "
          f"run, host clock), {noise_rays / noise_ms / 1e3:.1f} Mrays/s in "
          f"the kernel; work counted on the plain version's rays: "
          f"{work['rays']} bounces, {work['noise_hits']} noise hits "
          f"({work['noise_hits'] / work['rays']:.4f} a bounce); bound (an "
          f"estimate) {noise_bound[0]:.4f} ms by {noise_bound[1]} "
          f"({noise_bound[0] / noise_ms:.4f} of it) ({card})")
    del perlin_full, args, kw, sums

    # -- 4g. K4's image forms vs plain, and earth's full batch ---------------
    small_png = image_scenes.texel_id_png(
        os.path.join(tri_dir.name, "small-map.png"), 640, 320)
    image_err = 0.0
    for form, (doc, w, depth) in image_scenes.form_checks(small_png).items():
        small_cs = compile_scene(SceneFile.from_json_dict(doc), width=w)
        r = Renderer(_scene(small_cs, small_cs.render.width,
                            small_cs.render.height, depth, 2), device=dev)
        shape = (r.static.has_tris, r.static.has_lights,
                 r.static.flags.has_noise)
        if r.path != "fused" or not r.static.flags.has_image or shape != (
                "tris" in form, "lights" in form, "noise" in form):
            raise AssertionError(f"image {form}: path {r.path}, not K4's "
                                 f"{form} image form")
        before = megakernel.IMAGE_LAUNCHES
        small_err, *_ = _compare_fused(
            f"image {form} {r.static.width}x{r.static.height} depth {depth} "
            f"k=2", r, 2, 1e-3, None, card, bitwise_required=True)
        if megakernel.IMAGE_LAUNCHES != before + 2:
            raise AssertionError(f"image {form}: the image form was not "
                                 f"launched")
        image_err = max(image_err, small_err)
    earth_json, earth_mb_json = image_scenes.write_earth_scenes(tri_dir.name)
    earth_cs = cli.load_scene(earth_json, EARTH_SIZE[0])
    er = earth_cs.render
    if (er.width, er.height, er.samples_per_pixel, er.sample_batches,
            er.max_ray_depth) != (*EARTH_SIZE, 4, 16, 50) or (
            tuple(earth_cs.atlas_wh[0]) != image_scenes.EARTH_SIZE):
        raise AssertionError("earth's settings changed")
    earth_full = Renderer(earth_cs, device=dev)
    if earth_full.path != "fused":
        raise AssertionError(f"earth: path {earth_full.path}")
    err_full, args, kw, image_rays, image_plain_s = _compare_fused(
        "earth 512x512 4 spp depth 50 k=1", earth_full, 1, 0.0, None, card,
        bitwise_required=True)
    image_err = max(image_err, err_full)
    image_ms = _median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    sums, _ = megakernel.render_tile_mega(*args, **kw)
    earth_fused_img = (sums / er.samples_per_pixel).cpu().numpy()
    work = _plain_work(args, kw)
    if work["rays"] != image_rays:
        raise AssertionError("earth: the counted rays differ")
    image_bound = _image_bound(earth_full.static, earth_full.scene, args[2],
                               work, *EARTH_SIZE)
    print(f"fused kernel (image form) time on earth at 512x512, 4 spp, depth "
          f"50, one batch: kernel {image_ms:.3f} ms (median of 5, CUDA "
          f"events), plain PyTorch {image_plain_s * 1e3:.1f} ms (one run, "
          f"host clock), {image_rays / image_ms / 1e3:.1f} Mrays/s in the "
          f"kernel; work counted on the plain version's rays: "
          f"{work['rays']} bounces, {work['image_hits']} image hits "
          f"({work['image_hits'] / work['rays']:.4f} a bounce); bound (an "
          f"estimate) {image_bound[0]:.5f} ms by {image_bound[1]} "
          f"({image_bound[0] / image_ms:.4f} of it) ({card})")
    del earth_full, args, kw, sums

    # -- 4h. K4's clustered sphere forms vs plain, and the stress scenes ----
    cluster_err = 0.0
    for form, (doc, w, depth) in stress_scenes.cluster_form_checks(
            small_png).items():
        small_cs = compile_scene(SceneFile.from_json_dict(doc), width=w)
        r = Renderer(_scene(small_cs, small_cs.render.width,
                            small_cs.render.height, depth, 2), device=dev)
        parts = form.split("+")
        shape = (r.path == "fused_anim", r.static.has_tris,
                 r.static.has_lights, r.static.flags.has_noise,
                 r.static.flags.has_image)
        if (not r.use_megakernel or r._geometry(0).sph_boxes is None
                or shape != tuple(f in parts for f in ("anim", "tris",
                                                       "lights", "noise",
                                                       "image"))):
            raise AssertionError(f"clusters {form}: path {r.path}, not K4's "
                                 f"clustered {form} form")
        before = megakernel.SPHERE_CLUSTER_LAUNCHES
        small_err, *_ = _compare_fused(
            f"clusters {form} {r.static.width}x{r.static.height} depth "
            f"{depth} k=2 ({r.path}, {r.static.num_spheres} spheres)", r, 2,
            1e-3, None, card, bitwise_required=True)
        if megakernel.SPHERE_CLUSTER_LAUNCHES != before + 2:
            raise AssertionError(f"clusters {form}: the clustered form was "
                                 f"not launched")
        cluster_err = max(cluster_err, small_err)
    stress_paths = stress_scenes.write_sphere_stress(tri_dir.name)
    stress_cs, stress_r, stress = {}, {}, {}
    for name, path in stress_paths.items():
        t0 = time.perf_counter()
        stress_cs[name] = cli.load_scene(path)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = stress_r[name] = Renderer(stress_cs[name], device=dev)
        init_s = time.perf_counter() - t0
        rs = stress_cs[name].render
        layout = megakernel.sphere_cluster_layout(r.static)
        if ((rs.width, rs.height, rs.samples_per_pixel, rs.sample_batches,
             rs.max_ray_depth) != (*STRESS_SIZE, 4, 25, 50)
                or (r.static.num_spheres, *layout[1:]) != STRESS_LAYOUT[name]
                or r.path != "fused"):
            raise AssertionError(f"{name}: {r.static.num_spheres} spheres, "
                                 f"layout {layout}, path {r.path}")
        print(f"{name}: {r.static.num_spheres} spheres (prefix {layout[0]}, "
              f"{layout[2]} clusters of {layout[1]}), compiled in "
              f"{compile_s:.2f} s, Renderer (world tables for "
              f"{rs.sample_batches} batch times, upload, boxes) in "
              f"{init_s:.2f} s; path {r.path}")
        label = f"{name} {STRESS_SIZE[0]}x{STRESS_SIZE[1]} 4 spp depth 50 k=1"
        if name == "stress-16k":
            # A small frame first: the plain version's time where its
            # chunked dense sweep of 16,384 spheres is short.
            small_r = Renderer(_scene(stress_cs[name], *STRESS_SMALL),
                               device=dev)
            small_err, args, kw, small_rays, small_plain_s = _compare_fused(
                f"{name} {STRESS_SMALL[0]}x{STRESS_SMALL[1]} 4 spp depth 50 "
                f"k=1", small_r, 1, 0.0, None, card, bitwise_required=True)
            small_ms = _median_ms(
                lambda: megakernel.render_tile_mega(*args, **kw), 5)
            print(f"{name} at {STRESS_SMALL[0]}x{STRESS_SMALL[1]}, 4 spp, "
                  f"depth 50, one batch, {small_rays} rays: kernel "
                  f"{small_ms:.3f} ms (median of 5, CUDA events), plain "
                  f"PyTorch {small_plain_s * 1e3:.1f} ms (one run, host "
                  f"clock) ({card})")
            cluster_err = max(cluster_err, small_err)
            del small_r, args, kw
        err_full, args, kw, rays, plain_s = _compare_fused(
            label, r, 1, 0.0, None, card, bitwise_required=True)
        cluster_err = max(cluster_err, err_full)
        stress_ms = _median_ms(
            lambda: megakernel.render_tile_mega(*args, **kw), 5)
        sums, _ = megakernel.render_tile_mega(*args, **kw)
        fused_img = (sums / rs.samples_per_pixel).cpu().numpy()
        t0 = time.perf_counter()
        wave_img, wave_rays, per_ray = _cluster_work(
            Renderer(stress_cs[name], device=dev, use_megakernel=False),
            args[2])
        wave_s = time.perf_counter() - t0
        mdiff = np.abs(fused_img.mean(axis=(0, 1))
                       - wave_img.mean(axis=(0, 1))).max()
        print(f"fused (clustered) vs wavefront with K1 on {name}'s batch: "
              f"rays {rays} vs {wave_rays}, max channel-mean diff "
              f"{mdiff:.3g}; the wavefront's batch {wave_s:.2f} s with the "
              f"work count ({card})")
        if abs(rays - wave_rays) > 0.005 * wave_rays or mdiff > 2e-3:
            raise AssertionError(f"{name}: the fused and wavefront renders "
                                 f"disagree")
        bound = _cluster_bound(args[2], per_ray, rays, *STRESS_SIZE, 0)
        dense_bound = _k4_bound(r.static, args[2], rays, *STRESS_SIZE, 0)
        dense = (f"the dense form {_dense_ms(args, kw):.3f} ms (median of "
                 f"5), " if r.static.num_spheres <= megakernel.MAX_SPHERES
                 else "")
        print(f"fused kernel (clustered) time on {name} at {STRESS_SIZE[0]}x"
              f"{STRESS_SIZE[1]}, 4 spp, depth 50, one batch: kernel "
              f"{stress_ms:.3f} ms (median of 5, CUDA events), {dense}plain "
              f"PyTorch {plain_s * 1e3:.1f} ms (one run, host clock), "
              f"{rays / stress_ms / 1e3:.1f} Mrays/s in the kernel, the "
              f"wavefront "
              f"{wave_rays / wave_s / 1e6:.3f} Mrays/s; work a bounce: "
              f"{per_ray['prefix_tests']:.0f} prefix tests, "
              f"{per_ray['box_tests']:.0f} box pretests, "
              f"{per_ray['sphere_tests']:.2f} sphere tests in clusters that "
              f"pass (of {r.static.num_spheres}); bound {bound[0]:.4f} ms by "
              f"{bound[1]} ({bound[0] / stress_ms:.4f} of it), the dense "
              f"sweep's "
              f"{dense_bound[0]:.4f} ms ({card})")
        stress[name] = dict(ms=stress_ms, plain_ms=plain_s * 1e3,
                            bound=bound)
        del args, kw, sums

    # -- 4f. K3 vs plain and K2, at small size and on the 2M-triangle mesh ---
    for T, g, c, R in ((40000, 128, 128, 1 << 16), (3001, 8, 16, 1 << 14)):
        tables, table16, ro, rd, r_alive = _paged_random(T, g, c, R, T, dev)
        _compare_paged(f"random T={T}", ro, rd, tables, table16, r_alive)
    del tables, table16, ro, rd, r_alive
    t0 = time.perf_counter()
    cs_mesh = cli.load_scene(cli.DEFAULT_SCENE, WIDTH, HEIGHT,
                             analytic_spheres=False)
    mesh_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_r = Renderer(cs_mesh, device=dev)
    mesh_init_s = time.perf_counter() - t0
    pages = mesh_r._geometry(0).tri_pages
    print(f"final-one-weekend --mesh-geometry: {cs_mesh.num_triangles} "
          f"triangles, {cs_mesh.num_spheres} spheres, compiled in "
          f"{mesh_compile_s:.2f} s; Renderer (paged order, upload, tables) "
          f"{mesh_init_s:.2f} s; path {mesh_r.path}, bvh_mode "
          f"{mesh_r.static.bvh_mode}; {pages.page_boxes.shape[0]} pages, "
          f"{pages.boxes.shape[0]} clusters")
    if (cs_mesh.num_triangles != MESH_TRIANGLES or cs_mesh.num_spheres
            or mesh_r.path != "wavefront"
            or mesh_r.static.bvh_mode != "paged"):
        raise AssertionError("the mesh scene did not take the paged "
                             "wavefront")
    del pages
    k3 = _k3_full(mesh_r, card)

    # -- 5. the wavefront path ----------------------------------------------
    _reset_counts()
    wave = Renderer(cs, device=dev, use_megakernel=False)
    per_batch = _step(wave, MAIN_BATCHES)
    sweep_launches = sphere_sweep.LAUNCHES
    if sweep_launches <= 0 or megakernel.LAUNCHES or tri_sweep.LAUNCHES:
        raise AssertionError("the wavefront path did not run on K1 alone")
    for i, (r, s) in enumerate(per_batch):
        print(f"wavefront batch {i}: {r} rays in {s:.4f} s "
              f"({r / s / 1e6:.3f} Mrays/s)")
    print(f"wavefront path: final-one-weekend {WIDTH}x{HEIGHT}, 4 spp, depth "
          f"50: {_mrays(per_batch[1:]):.3f} Mrays/s over batches "
          f"1-{MAIN_BATCHES - 1}; sphere_sweep LAUNCHES={sweep_launches} "
          f"({card})")
    wave_img = wave.image()
    _check_image(wave_img, "wavefront")

    _reset_counts()
    wave_mb = Renderer(cs_mb, device=dev, use_megakernel=False)
    per_batch = _step(wave_mb, MAIN_BATCHES)
    if (sphere_sweep.LAUNCHES <= 0 or megakernel.LAUNCHES
            or tri_sweep.LAUNCHES):
        raise AssertionError("the motion-blur wavefront did not run on K1 "
                             "alone")
    print(f"wavefront path: final-one-weekend-motion-blur {MB_WIDTH}x"
          f"{MB_HEIGHT}, 4 spp, depth 50: {_mrays(per_batch[1:]):.3f} "
          f"Mrays/s over batches 1-{MAIN_BATCHES - 1}; sphere_sweep "
          f"LAUNCHES={sphere_sweep.LAUNCHES} ({card})")
    wave_mb_img = wave_mb.image()
    _check_image(wave_mb_img, "motion-blur wavefront", MB_WIDTH, MB_HEIGHT)
    del wave_mb

    # tri-stress's one batch on the wavefront: K2, then K1 for the ground.
    _reset_counts()
    wave_tri = Renderer(tri_cs, device=dev, use_megakernel=False)
    (tri_wave_rays, tri_wave_s), = _step(wave_tri, 1)
    k2_launches, k1_tri_launches = tri_sweep.LAUNCHES, sphere_sweep.LAUNCHES
    if k2_launches <= 0 or k1_tri_launches <= 0 or megakernel.LAUNCHES:
        raise AssertionError("tri-stress's wavefront did not run on K2 and "
                             "K1")
    print(f"wavefront path: tri-stress-15360 {TRI_WIDTH}x{TRI_HEIGHT}, 16 "
          f"spp, depth 50, one batch: {tri_wave_rays} rays in "
          f"{tri_wave_s:.4f} s ({tri_wave_rays / tri_wave_s / 1e6:.3f} "
          f"Mrays/s); tri_sweep LAUNCHES={k2_launches}, sphere_sweep "
          f"LAUNCHES={k1_tri_launches} ({card})")
    _check_image(wave_tri.image(), "tri-stress wavefront", TRI_WIDTH,
                 TRI_HEIGHT)
    del wave_tri

    # perlin-spheres' batch on the wavefront: K1, the turbulence in torch.
    _reset_counts()
    wave_perlin = Renderer(perlin_cs, device=dev, use_megakernel=False)
    (pw_rays, pw_s), = _step(wave_perlin, 1)
    if (sphere_sweep.LAUNCHES <= 0 or megakernel.LAUNCHES
            or tri_sweep.LAUNCHES):
        raise AssertionError("perlin-spheres' wavefront did not run on K1 "
                             "alone")
    print(f"wavefront path: perlin-spheres 1024x576, 16 spp, depth 50, one "
          f"batch: {pw_rays} rays in {pw_s:.4f} s "
          f"({pw_rays / pw_s / 1e6:.3f} Mrays/s); sphere_sweep "
          f"LAUNCHES={sphere_sweep.LAUNCHES} ({card})")
    perlin_wave_img = wave_perlin.image()
    _check_image(perlin_wave_img, "perlin-spheres wavefront", *PERLIN_SIZE)
    mdiff = np.abs(perlin_fused_img.mean(axis=(0, 1))
                   - perlin_wave_img.mean(axis=(0, 1))).max()
    print(f"fused (noise form) vs wavefront with K1 on perlin-spheres' "
          f"batch: rays {noise_rays} vs {pw_rays}, max channel-mean diff "
          f"{mdiff:.3g} ({card})")
    if abs(noise_rays - pw_rays) > 0.005 * pw_rays or mdiff > NOISE_MEAN_TOL:
        raise AssertionError("perlin-spheres: the fused and wavefront renders "
                             "disagree")
    del wave_perlin

    # earth's batch on the wavefront: K1, the image sampled in torch.
    _reset_counts()
    wave_earth = Renderer(earth_cs, device=dev, use_megakernel=False)
    (ew_rays, ew_s), = _step(wave_earth, 1)
    if (sphere_sweep.LAUNCHES <= 0 or megakernel.LAUNCHES
            or tri_sweep.LAUNCHES):
        raise AssertionError("earth's wavefront did not run on K1 alone")
    print(f"wavefront path: earth 512x512, 4 spp, depth 50, one batch: "
          f"{ew_rays} rays in {ew_s:.4f} s ({ew_rays / ew_s / 1e6:.3f} "
          f"Mrays/s); sphere_sweep LAUNCHES={sphere_sweep.LAUNCHES} ({card})")
    earth_wave_img = wave_earth.image()
    _check_image(earth_wave_img, "earth wavefront", *EARTH_SIZE)
    mdiff = np.abs(earth_fused_img.mean(axis=(0, 1))
                   - earth_wave_img.mean(axis=(0, 1))).max()
    print(f"fused (image form) vs wavefront with K1 on earth's batch: rays "
          f"{image_rays} vs {ew_rays}, max channel-mean diff {mdiff:.3g} "
          f"({card})")
    if abs(image_rays - ew_rays) > 0.005 * ew_rays or mdiff > IMAGE_MEAN_TOL:
        raise AssertionError("earth: the fused and wavefront renders "
                             "disagree")
    del wave_earth

    # Small-input reference: the same frame on the card and on the CPU
    # (plain versions) must agree in channel means and ray counts.
    tiny = _scene(cs, 96, 54, depth=8, batches=1)
    tiny_mb = _scene(cs_mb, 96, 54, depth=8, batches=2)
    tiny_tri = _tri_stress(1, 96, tri_dir.name, depth=8)[0]
    tiny_fix = _scene(fixture, 96, 54, depth=8, batches=1)
    tiny_cb = _scene(light_cs["cornell-style"], 32, 32, depth=8, batches=1)
    tiny_sl = _scene(light_cs["sphere-light-962"], 48, 27, depth=8,
                     batches=1)
    tiny_perlin = _scene(perlin_cs, 48, 27, depth=8)
    tiny_earth = _scene(earth_cs, 48, 48, depth=8, batches=1)
    tiny_mesh = _scene(compile_scene(SceneFile.from_json_dict(
        stress_scenes.big_spheres_doc()), width=48,
        analytic_spheres=False), 48, 27, depth=8, batches=1)
    for name, small_cs, fused in (("final-one-weekend", tiny, False),
                                  ("final-one-weekend", tiny, True),
                                  ("motion-blur", tiny_mb, False),
                                  ("motion-blur", tiny_mb, True),
                                  ("tri-stress k=1", tiny_tri, False),
                                  ("tri-stress k=1", tiny_tri, True),
                                  ("triangle fixture", tiny_fix, False),
                                  ("triangle fixture", tiny_fix, True),
                                  ("cornell-style", tiny_cb, False),
                                  ("cornell-style", tiny_cb, True),
                                  ("sphere-light-962", tiny_sl, False),
                                  ("sphere-light-962", tiny_sl, True),
                                  ("perlin-spheres", tiny_perlin, False),
                                  ("perlin-spheres", tiny_perlin, True),
                                  ("earth", tiny_earth, False),
                                  ("earth", tiny_earth, True),
                                  ("big spheres --mesh-geometry", tiny_mesh,
                                   None)):
        gpu_s = Renderer(small_cs, device=dev, use_megakernel=fused)
        cpu_s = Renderer(small_cs, device="cpu", use_megakernel=fused)
        if gpu_s.path != cpu_s.path or (
                gpu_s.static.bvh_mode != cpu_s.static.bvh_mode):
            raise AssertionError(f"{name}: card path {gpu_s.path}, CPU path "
                                 f"{cpu_s.path}")
        g_img, c_img = gpu_s.render_all(), cpu_s.render_all()
        g_rays, c_rays = gpu_s.stats.rays_traced, cpu_s.stats.rays_traced
        mdiff = np.abs(g_img.mean(axis=(0, 1)) - c_img.mean(axis=(0, 1))).max()
        rmse = float(np.sqrt(np.mean((g_img - c_img) ** 2)))
        if mdiff > 1e-2 or abs(g_rays - c_rays) > 0.02 * c_rays:
            raise AssertionError(f"{name} {gpu_s.path} card vs CPU at 96x54: "
                                 f"mean diff {mdiff}, rays {g_rays} vs "
                                 f"{c_rays}")
        print(f"{name} {gpu_s.path} ({gpu_s.static.bvh_mode}) card vs CPU at "
              f"{small_cs.render.width}x"
              f"{small_cs.render.height}, depth 8: max "
              f"channel-mean diff {mdiff:.3g}, RMSE {rmse:.3g}, rays "
              f"{g_rays} vs {c_rays} ({card})")

    # -- 6. the main path: Renderer with defaults, the fused kernel ---------
    _reset_counts()
    main_r = Renderer(cs, device=dev)
    per_batch = _step(main_r, MAIN_BATCHES)
    rays0, sec0 = main_r.stats.rays_traced, main_r.stats.render_seconds
    if main_r.render_batches(CHUNK_BATCHES) != CHUNK_BATCHES:
        raise AssertionError("render_batches rendered a short chunk")
    chunk = (main_r.stats.rays_traced - rays0,
             main_r.stats.render_seconds - sec0)
    k4_launches = megakernel.LAUNCHES
    if (main_r.path != "fused" or k4_launches <= 0 or sphere_sweep.LAUNCHES
            or megakernel.ANIM_LAUNCHES
            or megakernel.SPHERE_CLUSTER_LAUNCHES != k4_launches):
        raise AssertionError("the main path did not take the fused kernel's "
                             f"clustered form (K4 {k4_launches}, clustered "
                             f"{megakernel.SPHERE_CLUSTER_LAUNCHES}, K1 "
                             f"{sphere_sweep.LAUNCHES})")
    for i, (r, s) in enumerate(per_batch):
        print(f"fused batch {i}: {r} rays in {s:.4f} s "
              f"({r / s / 1e6:.3f} Mrays/s)")
    print(f"main path (fused): final-one-weekend {WIDTH}x{HEIGHT}, 4 spp, "
          f"depth 50: {_mrays(per_batch[1:]):.3f} Mrays/s over batches "
          f"1-{MAIN_BATCHES - 1} stepped one at a time; "
          f"{_mrays([chunk]):.3f} Mrays/s over one {CHUNK_BATCHES}-batch "
          f"chunk ({chunk[0]} rays in {chunk[1]:.4f} s); megakernel "
          f"LAUNCHES={k4_launches} (SPHERE_CLUSTER_LAUNCHES="
          f"{megakernel.SPHERE_CLUSTER_LAUNCHES}), sphere_sweep LAUNCHES=0 "
          f"({card})")
    print(f"static fused chunk: {_mrays([chunk]):.3f} Mrays/s in this run, "
          f"{STATIC_CHUNK_MRAYS_BEFORE} before the animated form "
          f"(PERF.md) ({card})")
    fused_img = main_r.image()
    _check_image(fused_img, "fused")
    del main_r

    # The motion-blur scene's main path: Renderer with defaults, the
    # animated fused kernel, one launch per stepped batch and per chunk.
    _reset_counts()
    mb_r = Renderer(cs_mb, device=dev)
    per_batch = _step(mb_r, MAIN_BATCHES)
    fused_mb_img = mb_r.image()
    rays0, sec0 = mb_r.stats.rays_traced, mb_r.stats.render_seconds
    if mb_r.render_batches(CHUNK_BATCHES) != CHUNK_BATCHES:
        raise AssertionError("render_batches rendered a short chunk")
    mb_chunk = (mb_r.stats.rays_traced - rays0,
                mb_r.stats.render_seconds - sec0)
    anim_launches = megakernel.ANIM_LAUNCHES
    if (mb_r.path != "fused_anim" or anim_launches != MAIN_BATCHES + 1
            or megakernel.LAUNCHES != anim_launches or sphere_sweep.LAUNCHES
            or megakernel.SPHERE_CLUSTER_LAUNCHES != anim_launches):
        raise AssertionError(
            f"the motion-blur main path did not take the animated fused "
            f"kernel (path {mb_r.path}, K4 {megakernel.LAUNCHES}, animated "
            f"{anim_launches}, K1 {sphere_sweep.LAUNCHES})")
    for i, (r, s) in enumerate(per_batch):
        print(f"motion-blur fused batch {i}: {r} rays in {s:.4f} s "
              f"({r / s / 1e6:.3f} Mrays/s)")
    print(f"motion-blur main path (animated fused): "
          f"final-one-weekend-motion-blur {MB_WIDTH}x{MB_HEIGHT}, 4 spp, "
          f"depth 50: {_mrays(per_batch[1:]):.3f} Mrays/s over batches "
          f"1-{MAIN_BATCHES - 1} stepped one at a time; "
          f"{_mrays([mb_chunk]):.3f} Mrays/s over one {CHUNK_BATCHES}-batch "
          f"chunk ({mb_chunk[0]} rays in {mb_chunk[1]:.4f} s); path "
          f"{mb_r.path}, megakernel LAUNCHES={megakernel.LAUNCHES} (animated "
          f"{anim_launches}), sphere_sweep LAUNCHES=0 ({card})")
    _check_image(mb_r.image(), "motion-blur fused", MB_WIDTH, MB_HEIGHT)
    mdiff = np.abs(fused_mb_img.mean(axis=(0, 1))
                   - wave_mb_img.mean(axis=(0, 1))).max()
    print(f"motion-blur fused vs wavefront over batches 0-"
          f"{MAIN_BATCHES - 1}: max channel-mean diff {mdiff:.3g} ({card})")
    if mdiff > 2e-3:
        raise AssertionError("motion-blur: the fused and wavefront renders "
                             "disagree")
    del mb_r

    # The sphere stress scenes' main paths: Renderer with defaults, K4's
    # clustered form; batches stepped, then render_all from batch 0 (its
    # 25 batches in chunks of 12).
    for name, r in stress_r.items():
        _reset_counts()
        per_batch = _step(r, MAIN_BATCHES)
        stepped = megakernel.SPHERE_CLUSTER_LAUNCHES
        r.current_batch = 0
        r.accum.zero_()
        r.stats = RenderStats()
        img = r.render_all()
        launches = stress[name]["launches"] = (
            megakernel.SPHERE_CLUSTER_LAUNCHES)
        n_chunks = -(-r.compiled.render.sample_batches // r.chunk_size())
        if (r.path != "fused" or stepped != MAIN_BATCHES
                or launches != MAIN_BATCHES + n_chunks
                or megakernel.LAUNCHES != launches or sphere_sweep.LAUNCHES
                or megakernel.ANIM_LAUNCHES):
            raise AssertionError(
                f"{name}'s main path did not take K4's clustered form (path "
                f"{r.path}, K4 {megakernel.LAUNCHES}, clustered {launches}, "
                f"K1 {sphere_sweep.LAUNCHES})")
        print(f"{name} main path (fused, clustered spheres): "
              f"{STRESS_SIZE[0]}x{STRESS_SIZE[1]}, 4 spp, depth 50: "
              f"{_mrays(per_batch[1:]):.3f} Mrays/s over batches "
              f"1-{MAIN_BATCHES - 1} stepped one at a time; render_all "
              f"{r.stats.rays_traced} rays in {r.stats.render_seconds:.4f} s "
              f"({r.stats.mrays_per_sec:.3f} Mrays/s) in {n_chunks} launches; "
              f"megakernel LAUNCHES={megakernel.LAUNCHES} "
              f"(SPHERE_CLUSTER_LAUNCHES={launches}), sphere_sweep "
              f"LAUNCHES=0 ({card})")
        _check_image(img, f"{name} fused", *STRESS_SIZE)
    del stress_r

    # tri-stress's main path: Renderer with defaults, K4's triangle form;
    # its one batch stepped, then render_all on a second Renderer.
    _reset_counts()
    tri_r = Renderer(tri_cs, device=dev)
    (tri_rays, tri_s), = _step(tri_r, 1)
    tri_all = Renderer(tri_cs, device=dev)
    tri_img = tri_all.render_all()
    tris_launches = megakernel.TRI_LAUNCHES
    if (tri_r.path != "fused" or tri_all.path != "fused"
            or tris_launches != 2 or megakernel.LAUNCHES != 2
            or megakernel.ANIM_LAUNCHES or sphere_sweep.LAUNCHES
            or tri_sweep.LAUNCHES):
        raise AssertionError(
            f"tri-stress's main path did not take K4's triangle form (path "
            f"{tri_r.path}, K4 {megakernel.LAUNCHES}, triangle form "
            f"{tris_launches}, K1 {sphere_sweep.LAUNCHES}, K2 "
            f"{tri_sweep.LAUNCHES})")
    print(f"tri-stress main path (fused, triangle form): tri-stress-15360 "
          f"{TRI_WIDTH}x{TRI_HEIGHT}, 16 spp, depth 50: its batch stepped "
          f"{tri_rays} rays in {tri_s:.4f} s "
          f"({tri_rays / tri_s / 1e6:.3f} Mrays/s); render_all "
          f"{tri_all.stats.rays_traced} rays in "
          f"{tri_all.stats.render_seconds:.4f} s "
          f"({tri_all.stats.mrays_per_sec:.3f} Mrays/s); megakernel "
          f"LAUNCHES={megakernel.LAUNCHES} (triangle form {tris_launches}), "
          f"tri_sweep and sphere_sweep LAUNCHES=0 ({card})")
    _check_image(tri_img, "tri-stress fused", TRI_WIDTH, TRI_HEIGHT)
    del tri_r, tri_all

    # cornell-style's main path, the slice at full size: Renderer with
    # defaults, K4's lit form (with triangles), batches stepped, then one
    # fused chunk.
    _reset_counts()
    cb_r = Renderer(light_cs["cornell-style"], device=dev)
    per_batch = _step(cb_r, MAIN_BATCHES)
    cb_k = cb_r.chunk_size()
    rays0, sec0 = cb_r.stats.rays_traced, cb_r.stats.render_seconds
    if cb_r.render_batches(cb_k) != cb_k:
        raise AssertionError("render_batches rendered a short chunk")
    cb_chunk = (cb_r.stats.rays_traced - rays0,
                cb_r.stats.render_seconds - sec0)
    lights_launches = megakernel.LIGHT_LAUNCHES
    if (cb_r.path != "fused" or lights_launches != MAIN_BATCHES + 1
            or megakernel.LAUNCHES != lights_launches
            or megakernel.TRI_LAUNCHES != lights_launches
            or sphere_sweep.LAUNCHES or tri_sweep.LAUNCHES):
        raise AssertionError(
            f"cornell-style's main path did not take K4's lit form (path "
            f"{cb_r.path}, K4 {megakernel.LAUNCHES}, lit form "
            f"{lights_launches}, K1 {sphere_sweep.LAUNCHES}, K2 "
            f"{tri_sweep.LAUNCHES})")
    for i, (r, s) in enumerate(per_batch):
        print(f"cornell-style fused batch {i}: {r} rays in {s:.4f} s "
              f"({r / s / 1e6:.3f} Mrays/s)")
    print(f"cornell-style main path (fused, lit form): 1024x1024, 64 spp, "
          f"depth 50: {_mrays(per_batch[1:]):.3f} Mrays/s over batches "
          f"1-{MAIN_BATCHES - 1} stepped one at a time; "
          f"{_mrays([cb_chunk]):.3f} Mrays/s over one {cb_k}-batch chunk "
          f"({cb_chunk[0]} rays in {cb_chunk[1]:.4f} s); megakernel "
          f"LAUNCHES={megakernel.LAUNCHES} (lit form {lights_launches}), "
          f"tri_sweep and sphere_sweep LAUNCHES=0 ({card})")
    _check_image(cb_r.image(), "cornell-style fused", 1024, 1024)
    del cb_r

    # sphere-light-962's main path: its first batch stepped, then
    # render_all (its two batches in one chunk) on a second Renderer.
    _reset_counts()
    sl_r = Renderer(light_cs["sphere-light-962"], device=dev)
    (sl_rays, sl_s), = _step(sl_r, 1)
    sl_all = Renderer(light_cs["sphere-light-962"], device=dev)
    sl_img = sl_all.render_all()
    if (sl_all.path != "fused" or megakernel.LIGHT_LAUNCHES != 2
            or megakernel.LAUNCHES != 2 or sphere_sweep.LAUNCHES
            or tri_sweep.LAUNCHES):
        raise AssertionError(
            f"sphere-light-962's main path did not take K4's lit form (path "
            f"{sl_all.path}, K4 {megakernel.LAUNCHES}, lit form "
            f"{megakernel.LIGHT_LAUNCHES}, K1 {sphere_sweep.LAUNCHES}, K2 "
            f"{tri_sweep.LAUNCHES})")
    print(f"sphere-light-962 main path (fused, lit form): 1024x576, 64 spp, "
          f"depth 50: its first batch stepped {sl_rays} rays in "
          f"{sl_s:.4f} s ({sl_rays / sl_s / 1e6:.3f} Mrays/s); render_all "
          f"{sl_all.stats.rays_traced} rays in "
          f"{sl_all.stats.render_seconds:.4f} s "
          f"({sl_all.stats.mrays_per_sec:.3f} Mrays/s); megakernel "
          f"LAUNCHES={megakernel.LAUNCHES} (lit form "
          f"{megakernel.LIGHT_LAUNCHES}), tri_sweep and sphere_sweep "
          f"LAUNCHES=0 ({card})")
    _check_image(sl_img, "sphere-light-962 fused", 1024, 576)
    del sl_r, sl_all

    # perlin-spheres' main path, the slice at full size: Renderer with
    # defaults, K4's noise form; its batch stepped, then render_all on a
    # second Renderer.
    _reset_counts()
    pl_r = Renderer(perlin_cs, device=dev)
    (pl_rays, pl_s), = _step(pl_r, 1)
    pl_all = Renderer(perlin_cs, device=dev)
    pl_img = pl_all.render_all()
    noise_launches = megakernel.NOISE_LAUNCHES
    if (pl_r.path != "fused" or pl_all.path != "fused" or noise_launches != 2
            or megakernel.LAUNCHES != 2 or megakernel.ANIM_LAUNCHES
            or megakernel.TRI_LAUNCHES or megakernel.LIGHT_LAUNCHES
            or sphere_sweep.LAUNCHES or tri_sweep.LAUNCHES):
        raise AssertionError(
            f"perlin-spheres' main path did not take K4's noise form (path "
            f"{pl_all.path}, K4 {megakernel.LAUNCHES}, noise form "
            f"{noise_launches}, K1 {sphere_sweep.LAUNCHES})")
    print(f"perlin-spheres main path (fused, noise form): 1024x576, 16 spp, "
          f"depth 50: its batch stepped {pl_rays} rays in {pl_s:.4f} s "
          f"({pl_rays / pl_s / 1e6:.3f} Mrays/s); render_all "
          f"{pl_all.stats.rays_traced} rays in "
          f"{pl_all.stats.render_seconds:.4f} s "
          f"({pl_all.stats.mrays_per_sec:.3f} Mrays/s); megakernel "
          f"LAUNCHES={megakernel.LAUNCHES} (noise form {noise_launches}), "
          f"tri_sweep and sphere_sweep LAUNCHES=0 ({card})")
    _check_image(pl_img, "perlin-spheres fused", *PERLIN_SIZE)
    print(f"perlin-spheres fused vs wavefront: channel means "
          f"{pl_img.mean(axis=(0, 1)).tolist()} (fused), "
          f"{perlin_wave_img.mean(axis=(0, 1)).tolist()} (wavefront)")
    del pl_r, pl_all

    # earth's main path, the slice at full size: Renderer with defaults,
    # K4's image form; its first batch stepped, then render_all (its 16
    # batches in chunks of 12) on a second Renderer.
    _reset_counts()
    ea_r = Renderer(earth_cs, device=dev)
    (ea_rays, ea_s), = _step(ea_r, 1)
    ea_all = Renderer(earth_cs, device=dev)
    ea_img = ea_all.render_all()
    image_launches = megakernel.IMAGE_LAUNCHES
    n_chunks = -(-er.sample_batches // ea_all.chunk_size())
    if (ea_r.path != "fused" or ea_all.path != "fused"
            or image_launches != 1 + n_chunks
            or megakernel.LAUNCHES != image_launches
            or megakernel.ANIM_LAUNCHES or megakernel.TRI_LAUNCHES
            or megakernel.LIGHT_LAUNCHES or megakernel.NOISE_LAUNCHES
            or sphere_sweep.LAUNCHES or tri_sweep.LAUNCHES):
        raise AssertionError(
            f"earth's main path did not take K4's image form (path "
            f"{ea_all.path}, K4 {megakernel.LAUNCHES}, image form "
            f"{image_launches}, K1 {sphere_sweep.LAUNCHES})")
    print(f"earth main path (fused, image form): 512x512, 4 spp, depth 50: "
          f"its first batch stepped {ea_rays} rays in {ea_s:.4f} s "
          f"({ea_rays / ea_s / 1e6:.3f} Mrays/s); render_all "
          f"{ea_all.stats.rays_traced} rays in "
          f"{ea_all.stats.render_seconds:.4f} s "
          f"({ea_all.stats.mrays_per_sec:.3f} Mrays/s) in {n_chunks} "
          f"launches; megakernel LAUNCHES={megakernel.LAUNCHES} (image form "
          f"{image_launches}), tri_sweep and sphere_sweep LAUNCHES=0 "
          f"({card})")
    _check_image(ea_img, "earth fused", *EARTH_SIZE)
    del ea_r, ea_all

    # earth-motion-blur: the globe turns, so each batch is one launch of
    # the static image form from that batch's world-to-object rows
    # (fused_per_batch), against the same batches on the wavefront.
    earth_mb_cs = cli.load_scene(earth_mb_json, EARTH_SIZE[0])
    _reset_counts()
    emb_r = Renderer(earth_mb_cs, device=dev)
    per_batch = _step(emb_r, MAIN_BATCHES)
    if (emb_r.path != "fused_per_batch"
            or megakernel.IMAGE_LAUNCHES != MAIN_BATCHES
            or megakernel.ANIM_LAUNCHES or sphere_sweep.LAUNCHES):
        raise AssertionError(
            f"earth-motion-blur did not take fused_per_batch in K4's image "
            f"form (path {emb_r.path}, image form "
            f"{megakernel.IMAGE_LAUNCHES}, animated "
            f"{megakernel.ANIM_LAUNCHES})")
    emb_wave = Renderer(earth_mb_cs, device=dev, use_megakernel=False)
    wave_batches = _step(emb_wave, MAIN_BATCHES)
    emb_img, emb_wave_img = emb_r.image(), emb_wave.image()
    _check_image(emb_img, "earth-motion-blur fused_per_batch", *EARTH_SIZE)
    mdiff = np.abs(emb_img.mean(axis=(0, 1))
                   - emb_wave_img.mean(axis=(0, 1))).max()
    print(f"earth-motion-blur (fused_per_batch, image form): 512x512, 8 spp, "
          f"depth 50: {_mrays(per_batch[1:]):.3f} Mrays/s over batches "
          f"1-{MAIN_BATCHES - 1} stepped, the wavefront "
          f"{_mrays(wave_batches[1:]):.3f}; max channel-mean diff over "
          f"batches 0-{MAIN_BATCHES - 1} {mdiff:.3g}; megakernel "
          f"IMAGE_LAUNCHES={MAIN_BATCHES}, ANIM_LAUNCHES=0 ({card})")
    if mdiff > IMAGE_MEAN_TOL:
        raise AssertionError("earth-motion-blur: the fused and wavefront "
                             "renders disagree")
    del emb_r, emb_wave

    k3_launches = _mesh_paths(mesh_r, mb_scene, fused_img, wave_img, dev,
                              card)
    del mesh_r

    # -- 7. checkpoint round trips, same chunk boundaries --------------------
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        for fused in (False, True):
            one_shot = Renderer(cs, device=dev, use_megakernel=fused)
            one_shot.render_batches(CKPT_SPLIT)
            one_shot.render_batches(MAIN_BATCHES - CKPT_SPLIT)
            first = Renderer(cs, device=dev, use_megakernel=fused)
            first.render_batches(CKPT_SPLIT)
            first.save_checkpoint(ck)
            resumed = Renderer(cs, device=dev, use_megakernel=fused)
            resumed.load_checkpoint(ck)
            resumed.render_batches(MAIN_BATCHES - CKPT_SPLIT)
            path = "fused" if fused else "wavefront"
            if resumed.image().tobytes() != one_shot.image().tobytes():
                raise AssertionError(f"{path}: resumed render differs")
            if not fused and one_shot.image().tobytes() != wave_img.tobytes():
                raise AssertionError("wavefront: render differs from the "
                                     "main-path render")
            print(f"checkpoint ({path}): resume after batch {CKPT_SPLIT} of "
                  f"{MAIN_BATCHES} is byte-identical")
        cb = light_cs["cornell-style"]
        one_shot = Renderer(cb, device=dev)
        one_shot.render_batches(CKPT_SPLIT)
        one_shot.render_batches(CKPT_SPLIT)
        first = Renderer(cb, device=dev)
        first.render_batches(CKPT_SPLIT)
        first.save_checkpoint(ck)
        resumed = Renderer(cb, device=dev)
        resumed.load_checkpoint(ck)
        resumed.render_batches(CKPT_SPLIT)
        if resumed.image().tobytes() != one_shot.image().tobytes():
            raise AssertionError("cornell-style: resumed render differs")
        print(f"checkpoint (cornell-style, {resumed.path}): resume after "
              f"batch {CKPT_SPLIT} of {2 * CKPT_SPLIT} is byte-identical")
        del one_shot, first, resumed

        # -- 8. CLI: every batch of each scene -------------------------------
        full_size = ["--width", str(WIDTH), "--height", str(HEIGHT)]
        for scene_path, size_args, (w, h), path in (
                (cli.DEFAULT_SCENE, full_size, (WIDTH, HEIGHT),
                 "fused bounce kernel (fused)"),
                (mb_scene, [], (MB_WIDTH, MB_HEIGHT),
                 "fused bounce kernel (fused_anim)"),
                (tri_json, [], (TRI_WIDTH, TRI_HEIGHT),
                 "fused bounce kernel (fused)"),
                (light_paths["cornell-style"], [], (1024, 1024),
                 "fused bounce kernel (fused)"),
                (light_paths["sphere-light-962"], [], (1024, 576),
                 "fused bounce kernel (fused)"),
                (perlin_json, [], PERLIN_SIZE, "fused bounce kernel (fused)"),
                (earth_json, ["--width", str(EARTH_SIZE[0])], EARTH_SIZE,
                 "fused bounce kernel (fused)"),
                (earth_mb_json, ["--width", str(EARTH_SIZE[0])], EARTH_SIZE,
                 "fused bounce kernel (fused_per_batch)"),
                (cli.DEFAULT_SCENE, ["--mesh-geometry", *full_size],
                 (WIDTH, HEIGHT), "wavefront (paged triangles)")):
            name = os.path.splitext(os.path.basename(scene_path))[0]
            if "--mesh-geometry" in size_args:
                name += "-mesh-geometry"
            png = os.path.join(tmp, name + ".png")
            capture = _Capture()
            logging.getLogger("raytrace_tpu_torch").addHandler(capture)
            t0 = time.perf_counter()
            rc = cli.main(["render", "--path", scene_path, *size_args,
                           "-o", png])
            logging.getLogger("raytrace_tpu_torch").removeHandler(capture)
            if rc != 0 or not os.path.getsize(png):
                raise AssertionError(f"cli render of {name} failed: rc={rc}")
            with open(png, "rb") as f:
                head = f.read(24)
            if head[:8] != b"\x89PNG\r\n\x1a\n" or (
                    int.from_bytes(head[16:20], "big"),
                    int.from_bytes(head[20:24], "big")) != (w, h):
                raise AssertionError(f"cli wrote no valid PNG of {name}'s "
                                     f"size")
            if f"path: {path}" not in capture.lines:
                raise AssertionError(f"the cli did not take the {path} path "
                                     f"for {name}")
            done = [m for m in capture.lines if m.startswith("rendered ")]
            chunks = len([m for m in capture.lines if m.startswith("batch ")])
            print(f"cli {name} ({path}): "
                  f"{done[-1] if done else 'no summary'}; {chunks} chunks; "
                  f"{time.perf_counter() - t0:.1f} s in all ({card})")

    # -- 9. one fused chunk of each scene under the profiler ----------------
    # One profiler session for all the chunks, each under its own
    # record_function range (a second session in one process has dropped
    # the kernel's device events); and one batch of the mesh scene's paged
    # wavefront.
    from torch.profiler import ProfilerActivity, profile, record_function

    runs = []
    for name, prof_cs, k in (("final-one-weekend", cs, CHUNK_BATCHES),
                             ("final-one-weekend-motion-blur", cs_mb,
                              CHUNK_BATCHES),
                             ("tri-stress-15360", tri_cs, 1),
                             ("cornell-style", light_cs["cornell-style"], 4),
                             ("sphere-light-962",
                              light_cs["sphere-light-962"], 2),
                             ("perlin-spheres", perlin_cs, 1),
                             ("earth", earth_cs, CHUNK_BATCHES),
                             ("stress-16k", stress_cs["stress-16k"],
                              CHUNK_BATCHES),
                             ("final-one-weekend --mesh-geometry", cs_mesh,
                              1)):
        prof_r = Renderer(prof_cs, device=dev)
        prof_r.render_batches(k)   # warm-up
        prof_r.current_batch = 0
        sec0 = prof_r.stats.render_seconds
        prof_r.render_batches(k)
        prof_r.current_batch = 0
        runs.append((name, prof_r, k, prof_r.stats.render_seconds - sec0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, prof_r, k, _ in runs:
            with record_function(name):
                prof_r.render_batches(k)
    events = prof.events()
    for name, prof_r, k, untraced in runs:
        paged = prof_r.static.bvh_mode == "paged"
        kernel = "the paged sweep" if paged else "the fused kernel"
        b = _busy_share(events, name, untraced,
                        "paged_tri" if paged else "megakernel")
        busy = (f"device busy {b['busy_s']:.4f} s = {b['timeline']:.4f} of "
                f"the traced window's own device timeline, {b['wall']:.4f} "
                f"of the untraced wall; {kernel} {b['kernel']:.4f} of "
                f"device time" if b["kernel"] > 0 else
                f"the profiler recorded no time of {kernel}: device busy "
                f"share not measured")
        what = "batch" if paged else f"{k}-batch fused chunk"
        print(f"profile of one {what} of {name} "
              f"({prof_r.path}): untraced {untraced:.4f} s; {busy}; "
              f"{b['ops']} device operations, {b['ops'] / k:.2f} per batch "
              f"({card})")
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=8))
    del runs, prof_r

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    # No single PyTorch call computes a closest-hit sweep or a whole path
    # tracer, so library_ms is null for each kernel.
    print(json.dumps({"kernels": [{
        "name": "sphere_sweep", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/sphere_sweep.cu",
        "replaces": "raytrace_tpu/ops/pallas_sweep.py:33",
        "launches": sweep_launches, "max_abs_err": k1_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1], "library_ms": None,
    }, {
        "name": "megakernel", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms,
        "plain_ms": k4_plain_ms, "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1], "library_ms": None,
    }, {
        "name": "megakernel_anim", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": anim_launches, "max_abs_err": anim_err, "ms": anim_ms,
        "plain_ms": anim_plain_ms, "bound_ms": anim_bound[0],
        "bound_by": anim_bound[1], "library_ms": None,
    }, {
        "name": "tri_sweep", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/tri_sweep.cu",
        "replaces": "raytrace_tpu/ops/pallas_tri_sweep.py:27",
        "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
        "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": None,
    }, {
        "name": "megakernel_tris", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": tris_launches, "max_abs_err": tris_err, "ms": tris_ms,
        "plain_ms": tris_plain_ms, "bound_ms": tris_bound[0],
        "bound_by": tris_bound[1], "library_ms": None,
    }, {
        # cornell-style's full batch, the slice's main path.
        "name": "megakernel_lights", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": lights_launches, "max_abs_err": lights_err,
        "ms": light_full["cornell-style"]["ms"],
        "plain_ms": light_full["cornell-style"]["plain_ms"],
        "bound_ms": light_full["cornell-style"]["bound"][0],
        "bound_by": light_full["cornell-style"]["bound"][1],
        "library_ms": None,
    }, {
        # perlin-spheres' full batch, the slice's main path.
        "name": "megakernel_noise", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": noise_launches, "max_abs_err": noise_err,
        "ms": noise_ms, "plain_ms": noise_plain_s * 1e3,
        "bound_ms": noise_bound[0], "bound_by": noise_bound[1],
        "library_ms": None,
    }, {
        # earth's full batch, the slice's main path.
        "name": "megakernel_image", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": image_launches, "max_abs_err": image_err,
        "ms": image_ms, "plain_ms": image_plain_s * 1e3,
        "bound_ms": image_bound[0], "bound_by": image_bound[1],
        "library_ms": None,
    }, {
        # stress-4x's and stress-16k's full batches (K4's clustered form),
        # the slice's main paths.
        "name": "megakernel_stress_4x", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": stress["stress-4x"]["launches"],
        "max_abs_err": cluster_err, "ms": stress["stress-4x"]["ms"],
        "plain_ms": stress["stress-4x"]["plain_ms"],
        "bound_ms": stress["stress-4x"]["bound"][0],
        "bound_by": stress["stress-4x"]["bound"][1], "library_ms": None,
    }, {
        "name": "megakernel_stress_16k", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": stress["stress-16k"]["launches"],
        "max_abs_err": cluster_err, "ms": stress["stress-16k"]["ms"],
        "plain_ms": stress["stress-16k"]["plain_ms"],
        "bound_ms": stress["stress-16k"]["bound"][0],
        "bound_by": stress["stress-16k"]["bound"][1], "library_ms": None,
    }, {
        # final-one-weekend --mesh-geometry's primary rays: the main path's.
        "name": "paged_tri", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/paged_tri.cu",
        "replaces": "raytrace_tpu/ops/pallas_paged_tri.py:185",
        "launches": k3_launches, "max_abs_err": 0.0, "ms": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound"][0],
        "bound_by": k3["bound"][1], "library_ms": None,
    }]}))
    tri_dir.cleanup()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
