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
--mesh-geometry (its 488 uv spheres tessellated: 2,033,920 triangles in
a tree over leaves of 4 that the paged sweep K3 walks; 1200x675, 4 spp,
depth 50: the paged wavefront), with its motion-blur twin the same way
(the tree re-fitted per batch); and the sphere stress scenes of
raytrace_tpu_torch/tools/stress_scenes.py, final-one-weekend's small
spheres tiled 2 x 2 (stress-4x: 1,940 spheres, 121 clusters of 16) and 6 x
6 cut to 16,384 (stress-16k: 128 clusters of 128), 1024x576, 4 spp x 25,
depth 50: K4's clustered sphere form, which final-one-weekend and its
motion-blur twin take too, and the wavefront with K1; the mesh and its
motion-blur twin also with use_bvh=True (the SAH BVH, walked by H1,
csrc/bvh_walk.cu); and fow-ellipsoids (raytrace_tpu_torch/tools/
ellipsoid_scenes.py: final-one-weekend with its three large spheres
scaled by [1, 1.5, 1], 1200x675, 4 spp x 25, depth 50: the wavefront
with H2, csrc/sphere_obj.cu, every sphere in object space).  Every phase
is checked; any failure raises and the script exits non-zero without
printing a result.  No path runs at a cut depth.  Phases:

1. needs torch.cuda.is_available(); prints nvidia-smi's name and power limit;
2. builds the nine kernel sources from the checkout, one nvcc each,
   started together, and the native SAH builder (g++,
   csrc/bvh_builder.cc): the BVH walk H1 (csrc/bvh_walk.cu), the
   object-space sphere sweep H2 (csrc/sphere_obj.cu), the sphere sweep K1
   (csrc/sphere_sweep.cu), the
   triangle sweep K2 (csrc/tri_sweep.cu), the fused bounce kernel K4
   (csrc/megakernel.cu: static, animated, triangle and the two lit
   forms, each without and with noise, and each but the animated one
   with images; each of these eighteen dense forms and its clustered
   sphere twin), the paged triangle sweep K3 (csrc/paged_tri.cu) and the
   dev probes P1-P3 (csrc/probe_ops.cu, csrc/probe_trig.cu,
   csrc/micro_raygen.cu), and K4's measuring build (the same source under
   K4_MEASURE), with nvcc's register report, a line per K4 form and
   K3's; every K4 form must keep the registers and spills pinned for it
   as it compiles with the loop of steps (FORMS_BEFORE,
   IMAGE_FORMS_BEFORE, CLUSTER_FORMS_BEFORE), and K3 its K3_BEFORE;
   K1's and K2's walks, H1 and H2 print theirs (smoke_lib.WALKS_BEFORE
   pins them);
3. K1 (the scene's dense prefix, then a walk of its sphere tree, as the
   wavefront runs it) against the plain PyTorch sweep: the 3,240,000
   primary rays of the main path and 2^20 random rays with an alive mask
   (ids equal, and ids equal with t within rtol=1e-3, atol=1e-3, each on
   >= 99.9% of rays; then K1 and its dense entry point bit for bit), timed
   with CUDA events beside the dense entry point; then K2's walk of the
   soup's tree (bit for bit, and its dense entry point too): 2^18 of
   tri-stress's primary rays against its 15,360 triangles, 2^20 random
   rays with an alive mask against 960, and all 9,437,184 primary rays,
   timed there beside the dense entry point; each walk's bound from its
   work on 2^17 rays beside the dense sweep's; a failed K1 check first
   prints what it saw (smoke_lib.sweep_diagnostics); then the dev probes
   (raytrace_tpu_torch/tools_dev/; smoke_lib.dev_probes): each module's
   main run as a user runs it (the dev-probe path, every probe kernel
   launched), which holds P1's ten probes against their plain versions
   at the JAX probe's shapes (bit for bit; sin+cos and pow-exp-log within
   2^-22), P2 at (8, 128) and 2^24 points (within 2 ulps, and byte for
   byte with its check-only kernel as first ported, timed beside it; its
   ulps against float64 printed), P3's three variants at the JAX layout (8
   programs over one (8, 128) block: the split kernel, each cell's
   iterations spread over a block) and at a cell per pixel-sample of
   final-one-weekend (3,240,000 cells, one thread a cell), bit for bit at
   4 iterations with two launches byte-identical, and times each (P3 at
   20,000 iterations and at 1 and 16, each run byte for byte with the
   sequential entry point at its own iterations and timed beside it); the
   bounds, and the PyTorch call of the fetch and the two table reads,
   timed beside, the card's launch floor beside P1 (one one-element
   PyTorch kernel), P2's SASS instructions an element and their
   issue-slot time at the SM clock read under load; with K4's batch time
   below, raygen's share of it;
4. K4 against its plain version (the wavefront loop with the plain
   sweeps): at 96x54, depth 8, 2 batches fused (rays within 0.5%,
   per-sample channel means within 1e-3, at most 5% of pixels above 1e-4)
   and at the main path's 1200x675, 4 spp, depth 50, one batch (rays
   within 0.5%, means within 2e-3, and bit for bit: the clustered static
   form); two launches give the same bytes; both timed with CUDA events,
   and the dense form on the same batch; the clustered sweep's work (the
   sphere tree's walk, beside the flat cluster walk it replaced) counted
   for the bound on 2^17 of the wavefront's rays of the batch (that
   wavefront, like every wavefront render this script holds a fused
   path against, runs through the dense entry points of K1 and K2,
   smoke_lib.dense_trace_fn, and the same batch rendered again by the
   Renderer's own wavefront, the walks of K1 and K2 at every bounce and
   on the shadow rays, must give its bytes and its ray count, with the
   walks' launches counted from 0 there; K1's walk on its first bounce is
   held to the dense entry's bits and both are timed, here and on the
   motion-blur and stress scenes' forced wavefronts; K2's walk on 2^17
   rays of bounces 0, 1, 2 and 10 of each triangle scene's batch, bit for
   bit with its plain version and its dense entry);
   wherever a scene in clusters is held to the plain version (here and
   below, up to the dense gate's 4096 spheres), its dense form (the
   layout dropped) is too, bit for bit, two launches byte-identical;
   then K4's animated form the same way on the motion-blur scene, at
   96x54/depth 8/k=2 and at 1024x576/depth 50/k=1 (bit for bit); then
   its triangle form (the soup's tree walked with csrc/tri_tree.cuh,
   the walk K3 runs), bit for bit at 96x54/depth 8/k=2 on
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
   within LIGHT_MEAN_TOL), which also counts the work of the bound and
   each (pixel, sample)'s path length; then
   K4's five noise forms, each bit for bit with its plain version (and
   two launches byte-identical) on the small frames of
   noise_scenes.form_checks (perlin-spheres at 96x54, depth 8, the
   motion-blur scene with noise, the noise checker and the noise light
   docs, and sphere-light-962 at 128x72, depth 50; k=2), and
   perlin-spheres' full batch bit for bit with the plain version (both
   timed; the plain version run again counts the noise hits of the
   bound; the measuring build's turbulences, equal to those noise hits,
   and those a warp step); then every noise form (smoke_lib.noise_form_docs: the five
   noise docs, the noise image docs and the clustered noise docs, a
   clustered doc's dense form too) bit for bit at the partial-warp width
   (97 wide: the frame's last warp has lanes past the image) at depths 1
   and 50, k=1; then K4's eight image forms, each bit for bit with its plain
   version (and two launches byte-identical) on the small frames of
   image_scenes.form_checks (a 640x320 texel-id image; k=2), and earth's
   full batch bit for bit with the plain version (both timed; the plain
   version run again counts the image hits of the bound; its lanes busy
   and phase cycles from the measuring build), and render_all's first
   chunk of earth (12 batches, one launch) the same way; then K4's
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
   whose rays count the clustered work of the bound (stress-16k's tree
   larger than the node rows a block stages); then K3 bit
   for bit with its plain version and with K2 (two launches
   byte-identical) on random soups whose leaf counts are not powers of
   two, with a duplicate pair and an alive mask (40,000, 3,001 and 5
   triangles), the mesh's tree built on the card (timed), all 3,240,000
   primary rays of the mesh scene's batch 0 (plain version timed) and
   2^17 of the rays of bounces 0, 1, 2 and 10 against K2's dense entry
   (and the plain
   version past bounce 0); 2^18 far grazing rays (1,000-2,000 units away,
   aimed at the mesh's leaf boxes) against K2, bit for bit but for rays
   whose K2 hit lies off its own triangle by more than the rounding
   margin (each printed); K3 timed on every bounce's rays (K3 ms a
   batch) and over the primary rays, the tree's and the flat page walk's
   work counted on 2^17 rays of bounces 0, 1 and 2 for the bounds;
   K4's lanes busy: on the path lengths of one batch of final-one-weekend,
   its motion-blur twin, tri-stress, both light scenes, perlin-spheres,
   earth and both stress scenes (the wavefront's, or the plain version's
   where that batch is rendered anyway), the share of a warp's lane slots
   that trace a bounce under per-sample reconvergence and under per-lane
   regeneration (smoke_lib.warp_tail, warp_regen); on final-one-weekend,
   the light scenes, perlin-spheres and earth K4's own share, from its
   measuring build
   (csrc/megakernel.cu under K4_MEASURE), whose sums must be the normal
   build's byte for byte and whose busy lanes must add up to the bounces
   traced, with the warps' cycles by phase (raygen, closest hit,
   shading, NEE, the sample's end);
5. the wavefront path, Renderer(cs, use_megakernel=False): several batches,
   counting K1 launches; the image checks; the same for the motion-blur
   scene, for tri-stress's one batch (counting K2 and K1 launches) and
   for perlin-spheres' and earth's batches (K1; each held to its fused
   batch's channel means); a small frame on the card against the
   CPU, for both paths and the animated fused path, for both triangle
   paths, both paths of each light scene, of perlin-spheres and of earth,
   the paged wavefront and use_bvh=True (a tessellated big-spheres doc),
   and fow-ellipsoids at 48x27;
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
   and K4 not), Mrays/s over batches 1-3 stepped and over the other 21
   in render_all, the image checks and its channel means beside the
   analytic scene's; a reduced frame
   (240x135, depth 50, one batch) of its soup on the paged sweep, on
   K2's walk (use_bvh=False) and through K2's dense entry point,
   byte-identical with equal ray counts; one batch of the
   motion-blur mesh (its tree re-fitted once for the batch; the re-fit
   timed), the image checks
   and the same reduced-frame identity; then the mesh with use_bvh=True:
   the SAH build's and the four-wide collapse's host seconds, rows,
   depth and stack; on the SAH tree and on the implicit one, H1 on every
   bounce's rays of batch 0 bit for bit with K2's walk over the same
   soup (the dense sweep's bits) and on 2^17 primary rays with its plain
   walk and the binary rows' plain walk, timed on the primary rays and
   on every bounce (CUDA events), its work counted on 2^17 rays of
   bounces 0 and 1 (ops/bvh.visit_counts over the binary rows, the least
   work that proves the hits, for the bound; over the wide rows, the
   walk's own work, for a second figure), beside the dense sweep's
   bound; the Renderer's batch 0
   byte-identical with K2's on the same soup (use_bvh=False) with equal
   rays, batches 1-3 stepped (H1 alone launched; Mrays/s beside the paged
   path's), and the motion-blur mesh the same way for one batch (its
   tree over the shutter); then fow-ellipsoids with defaults (the
   wavefront, H2 alone launched, its four large spheres dense, then the
   tree over the other 484's world boxes): H2 bit for bit with the dense
   plain sweep on the 3,240,000 primary rays and every bounce's rays of
   batch 0, timed there beside its dense entry point, its work counted
   on 2^17 rays of bounces 0 and 1 for the bound, beside the dense
   sweep's, the tree's build timed; grazing rays from near and from
   1,000-2,000 away through the once-built tree at batch 0's rows and at
   a time whose rows differ from batch 0's in their last bits, bit for
   bit with the dense entry point; its 25 batches, Mrays/s and the
   image checks; then fow-registry (tools/registry_scenes.py:
   final-one-weekend with every metal's fuzz a checker, which the fat
   shading row cannot encode; 1200x675, 4 spp, depth 50) with defaults:
   the wavefront with registry shading and K1 (launches counted from 0,
   K4 none), two batches stepped, Mrays/s, the image checks, and a 48x27
   frame on the card against the CPU; then the sharded renderer
   (raytrace_tpu_torch/parallel/multichip.py): K4's row-range launch
   (rows 338-405 of final-one-weekend's 675, samples 2-3 of 4) bit for bit
   with its plain version and timed; world size 1 over NCCL at 1200x675, a
   stepped batch and a 12-batch chunk byte-identical with the Renderer's;
   two ranks sharing the one card over gloo (their own processes,
   smoke_lib.multichip_rank): sp=2 and px=2 on the fused path at 240x135
   (K4 on a rank's rows and samples) and sc=2 on the wavefront at 120x68
   (K1 over each rank's slice of the spheres), px and sc byte-identical
   with the single-device render and sp within TWO_RANK_SP_ATOL, the
   collectives' host time a batch and its share after a warm-up batch;
   final-one-weekend and its
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
   K3's) share of device time and device operations per batch;
10. the app layer (_app_paths) on final-one-weekend at 1200x675, 4 spp x
   25, depth 50, its files in a temporary directory: the CLI with
   --preview-every 1 and --debug (K4 launched 25 times, counted from 0,
   every step validated, the PNG byte-equal to 25 stepped batches),
   render_all with progress and metrics_jsonl (25 lines adding up to the
   rays traced), one batch at the runtime max_depth 8 on K4 bit for bit
   with its plain version at that depth, the viewer over HTTP (a bad
   hot-swap kept out, the motion-blur twin swapped in on fused_anim, a
   resize to 600x338 restarting accumulation, the finished image
   byte-equal to render_all's), gen-final-one-weekend and a fused batch
   of the generated scene, and a batch under utils/profiling.trace in a
   process of its own whose Chrome trace names K4; its wall time.

The line before the last is the kernels' JSON record (with each kernel's
bound: the larger of its FP32 operations over 67 TFLOP/s (the dev
probes' INT32 operations counted as PEAK_INT32_OPS says) and its bytes
over 3.35 TB/s (the noise forms' turbulences' shared-memory loads over
PEAK_SHARED_BYTES), counted from this run's inputs and the scene's real
spheres, not the table's padding rows; K4's triangle, lit, noise and
image forms' and K3's are estimates, see _k4_tris_bound (the tree's
work, beside the flat cluster walk's as flat_bound_ms), _noise_bound,
_image_bound and _k3_full; its clustered forms' count the traversal's
work on a subset of the rays, the sphere tree's beside the flat cluster
walk's as flat_bound_ms, _cluster_bound), the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from raytrace_tpu_torch.tools import smoke_lib
from raytrace_tpu_torch.tools.smoke_lib import (
    AGREEMENT, ATOL, FLOPS_PER_SPHERE_BOX, FLOPS_PER_TEST,
    FLOPS_PER_TEST_ANIM, HEIGHT, RANDOM_RAYS, RTOL, WIDTH, least_ms,
    median_ms, rows_to_v3)

MB_WIDTH, MB_HEIGHT = 1024, 576   # the motion-blur scene's shipped size
MAIN_BATCHES = 4          # the first one is warm-up for the Mrays/s figure
CHUNK_BATCHES = 12        # Renderer.CHUNK: one fused launch
CKPT_SPLIT = 2            # round trip: save after this many batches
# The static fused chunk's Mrays/s that PERF.md records for the static
# kernel before its animated form was added (NVIDIA H100 80GB HBM3,
# 700 W), printed beside this run's.
STATIC_CHUNK_MRAYS_BEFORE = 298.602

# The triangle stress scene: k x k instances of the 960-triangle OBJ.
TRI_K = 4
TRI_WIDTH, TRI_HEIGHT = 1024, 576
TRI_SUBSET = 1 << 18
# Rays of each bounce on which the work of K4's tree walk is counted for
# its bound (_tri_work).
TREE_SUBSET = 1 << 17
# The bounces at which _tri_work holds K2's walk on TREE_SUBSET rays
# against its plain version and its dense entry point.
K2_BOUNCES = (0, 1, 2, 10)
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
# floorf, fabsf and sinf one each), as the noise forms compute it from the
# lattice tables in shared memory: a cnoise is 128 operations (the lattice
# floors, the six mod-289s and the offsets 36, the tables' guard 3, the six
# lattice coordinates converted to table arguments 6, three fades 21, each
# of the four (x, y) corners 13: its two z corners' dot products 5 each and
# a z mix 3; the y and x mixes and the gain 10) and 14 shared-memory loads
# (6 permutes of 4 bytes, 8 gradients of 16 bytes); an octave adds 6, the
# turbulence's abs 1 and the marble around it 6.  An estimate: it counts
# the turbulence alone, once per hit whose slot is in noise mode
# (_slot_hits).
OPS_PER_TURBULENCE = 7 * (128 + 6) + 1 + 6
SHARED_BYTES_PER_TURBULENCE = 7 * (6 * 4 + 8 * 16)
# The same turbulence computed without the tables, as the noise forms did
# before them, counted the same way (fmodf one operation): a cnoise is 451
# (the floors, mod-289s and offsets 36, three fades 21, each of the four
# (x, y) corners 96: its hash 15, its two z corners 39 each with their
# permute, gradient, normalisation and dot, and a z mix 3; the mixes and
# the gain 10).  The noise row's bound_ms_fp32_chain is on this count, so
# that times from before and after the tables read on one yardstick too.
FLOPS_PER_TURBULENCE_CHAIN = 7 * (451 + 6) + 1 + 6
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
# The light scenes: their full sizes, and the widths of the small frames
# that hold K4's lit forms against the plain version at depth 50, k=2.
LIGHT_SMALL = {"cornell-style": 128, "sphere-light-962": 128,
               "lit spheres": 96, "70 instances": 96}
# The light scenes' full batch, fused against the wavefront through the
# dense entry points of K2 and K1 (K1 built with multiply-add contraction
# when these limits were set, without it since it shares K4's sphere
# test): per-sample channel means within this.  Measured 6.0e-8
# (cornell-style) and 1.1e-6 (sphere-light-962) on an H100 (PERF.md).
LIGHT_MEAN_TOL = 1e-5
# Big meshes: final-one-weekend --mesh-geometry (its 488 uv spheres
# tessellated, as the reference renders them), held against the plain
# version and K2's dense entry on this many of its rays at a bounce; the
# reduced frame on which the paged sweep, K2's walk and the dense sweep
# must render the same bytes.
MESH_TRIANGLES = 2_033_920
# perlin-spheres (tools/noise_scenes.py): its size, and its full batch,
# fused against the wavefront with K1 (built with multiply-add
# contraction when this limit was set, without it since it shares K4's
# sphere test; the turbulence amplifies a hit point's last bits about
# 100x): per-sample channel means within this.
PERLIN_SIZE = (1024, 576)
NOISE_MEAN_TOL = 1e-4
MESH_SUBSET = 1 << 17
REDUCED = (240, 135)
# K3's far grazing check: rays from 1,000-2,000 units away aimed at the
# mesh's leaf boxes.  One node of K3's tree: its two children's box tests,
# each FLOPS_PER_PRETEST and the box widened by the ray's rounding margin
# (|o|_inf + reach) 2^-18 (2) on its six faces (6).
GRAZING_RAYS = 1 << 18
FLOPS_PER_TREE_NODE = 2 * (FLOPS_PER_PRETEST + 8)
# use_bvh=True on the mesh (the SAH BVH, H1): its walk held to its plain
# version on this many primary rays, and its work counted on this many of
# a bounce's rays for the bound.  fow-ellipsoids (tools/
# ellipsoid_scenes.py, H2): one object-space sphere test, csrc/
# sphere_obj.cu's count.
BVH_SUBSET = 1 << 17
FLOPS_PER_OBJ_SPHERE_TEST = 65
# One four-wide node of H1's tree: its four children's box tests, the
# wide walk's own work (its bound takes the binary walk's, which tests
# fewer boxes over the same tree).
FLOPS_PER_WIDE_NODE = 2 * FLOPS_PER_TREE_NODE
# H1's binary walk and H2's dense loop before their redesign (PERF.md §6,
# on an NVIDIA H100 80GB HBM3 at 700 W): the primary rays' launch and a
# batch, ms.
H1_BEFORE = {"primary_ms": (1.432, 1.446), "batch_ms": (14.959, 15.017)}
H2_BEFORE = {"primary_ms": (5.629, 5.672), "batch_ms": (27.276, 27.427)}
# earth (tools/image_scenes.py): its size, and its full batch, fused
# against the wavefront with K1 (built with multiply-add contraction when
# this limit was set, without it since it shares K4's sphere test):
# channel means within this.  earth-motion-blur's batch on fused_per_batch against
# its wavefront batch, the same.
EARTH_SIZE = (512, 512)
# fow-registry's stepped batches on defaults (the wavefront).
REGISTRY_BATCHES = 2
# K4's row range held to its plain version: (row_base, rows, spp_local,
# sample_base) of final-one-weekend's 1200x675 frame.
ROW_RANGE = (338, 68, 2, 2)
# The two-rank phase's frames: final-one-weekend on the fused path and on
# the wavefront; its limits: the rendezvous's wait, and an sp split's
# largest difference from the single-device render (the sample sums'
# order changes).
TWO_RANK_FUSED = (240, 135)
TWO_RANK_WAVE = (120, 68)
TWO_RANK_SECONDS = 240
# Their batches: the first a warm-up, the collectives timed over the rest.
TWO_RANK_BATCHES = 4
TWO_RANK_SP_ATOL = 1e-5
IMAGE_MEAN_TOL = 1e-4
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
    return least_ms(traced_sum * _spheres(static) * per_test, nbytes)


def _k4_tris_bound(static, geom, work, width: int, height: int, scene=None):
    """An estimate of K4's triangle form's bound for one launch, from the
    work ``_tri_work`` counted on the wavefront's rays of the same batch:
    every bounce tests every sphere; the tree walk tests the nodes and the
    real triangles of the leaves that a walk proving each ray's closest
    hit must reach (paged_tri.tree_visit_counts, on a subset of each
    bounce's rays: the kernel's walk, seeded by the sphere hit, can only
    do more); every noise hit takes OPS_PER_TURBULENCE and
    SHARED_BYTES_PER_TURBULENCE of shared memory.  With ``scene``
    (the lit form), every bounce but a sample's last takes an NEE step,
    and the light rows and instance transforms are read too.  Bytes: the
    tables, the tree's rows, ids and nodes, the fat rows and parameters
    read once, the sums and counts written once.  Returns (the tree
    walk's bound, the flat cluster walk's that it replaced: every cluster
    box pretested and the real triangles of each cluster that passes
    against the sphere hit, the JAX kernel's pretest, megakernel.py:1280,
    with the soup's table and boxes read once)."""
    tree = geom.tri_tree
    flops = (work["rays"] * _spheres(static) * FLOPS_PER_TEST
             + work["noise_hits"] * OPS_PER_TURBULENCE)
    shared = work["noise_hits"] * SHARED_BYTES_PER_TURBULENCE
    nbytes = (geom.sph_table8.numel() + geom.prim_rows.numel() + 40) * 4
    if scene is not None:
        flops += (work["rays"] - work["samples"]) * FLOPS_PER_NEE
        nbytes += (scene.light_tri_packed.numel()
                   + geom.inst_o2w_rows.numel()) * 4
    nbytes += width * height * (3 * 4 + 4)
    tree_bound = least_ms(
        flops + work["node_tests"] * FLOPS_PER_TREE_NODE
        + work["tree_tri_tests"] * FLOPS_PER_TRI_TEST,
        nbytes + (tree.tris.numel() + tree.nodes.numel()
                  + tree.ids.numel()) * 4, shared_bytes=shared)
    flat_bound = least_ms(
        flops + work["pretests"] * FLOPS_PER_PRETEST
        + work["tri_tests"] * FLOPS_PER_TRI_TEST,
        nbytes + (geom.tri_table12.numel() + 8 * work["clusters"]) * 4,
        shared_bytes=shared)
    return tree_bound, flat_bound


def _cluster_work(name, wave_r, geom, card, times=None):
    """Render batch 0 of scene ``name``, ``wave_r``'s, on the wavefront, as
    render_next_batch does but through K1's dense entry point (the
    independent oracle, smoke_lib.dense_trace_fn), capturing every
    bounce's alive rays; hold K1's walk, as the wavefront launches it, to
    the dense entry's bits on the first bounce and time both; count on
    CLUSTER_SUBSET of them K4's clustered sweep against ``geom`` (the
    fused path's geometry, moved to times[0] when it moves): the tree
    walk's work (ops/sphere_tree.sphere_tree_visit_counts, against the
    dense sweep's closest hit) and the flat cluster walk's that it
    replaced (ops/megakernel.sphere_cluster_sweep_reference over
    sphere_cluster_boxes).  Returns (image [H, W, 3] on the host, rays
    traced, per-ray work: prefix sphere tests, the tree's node and sphere
    tests, the flat walk's box tests and sphere tests in clusters that
    pass, [H * W, spp] each (pixel, sample)'s path length, K1's launches
    in the Renderer's own batch, the first bounce's rays and K1's and its
    dense entry's ms there).  The Renderer's own batch: the same batch
    rendered by ``wave_r`` itself (_walk_batch: K1 walking its tree at
    every bounce), the dense oracle's bytes and ray count."""
    import torch

    from raytrace_tpu_torch.ops import sphere_sweep

    static, scene = wave_r.static, wave_r.scene
    wave_geom = wave_r._geometry(0)
    trace = smoke_lib.dense_trace_fn(static, scene, wave_geom)
    seen, first = [], []

    def capture(o, d, alive):
        seen.append(torch.stack([*o, *d])[:, alive])
        if not first:
            first.append((o, d, alive))
        return trace(o, d, alive)

    img, rays, lengths = smoke_lib.wave_lengths(
        static, scene, wave_r.camera, capture, wave_geom, wave_r.use_dof,
        wave_r.rows_per_tile)
    walked = _walk_batch(name, wave_r, img, rays, card)
    img = img.cpu().numpy()
    # K1 as the wavefront launches it, on the batch's first bounce, beside
    # its dense entry point: bit for bit, then one launch timed each.
    o0, d0, a0 = first[0]
    table8, k1_tree = wave_geom.sph_table8, wave_geom.sph_tree
    walk = sphere_sweep.intersect_spheres_sweep(o0, d0, table8, a0, k1_tree)
    dense = sphere_sweep.intersect_spheres_dense(o0, d0, table8, a0)
    if not (torch.equal(walk.t, dense.t) and torch.equal(walk.sph,
                                                         dense.sph)):
        raise AssertionError("K1's walk is not its dense entry's bits")
    k1 = dict(launches=walked["k1"], batch_s=walked["s"],
              rays=o0.x.shape[0], ms=median_ms(
        lambda: sphere_sweep.intersect_spheres_sweep(o0, d0, table8, a0,
                                                     k1_tree), 5),
              dense_ms=median_ms(lambda: sphere_sweep.intersect_spheres_dense(
                  o0, d0, table8, a0), 5))
    del first, o0, d0, a0
    per_ray = _per_ray_work(static, geom, seen, times)
    return img, rays, per_ray, lengths, k1


def _per_ray_work(static, geom, seen, times=None):
    """K4's clustered sweep's work a ray on CLUSTER_SUBSET of the rays in
    ``seen`` (each bounce's alive rays, [6, n] origins and directions),
    against ``geom`` moved to times[0] when it moves: the tree walk's
    (ops/sphere_tree.sphere_tree_visit_counts, against the dense sweep's
    closest hit) and the flat cluster walk's that it replaced
    (ops/megakernel.sphere_cluster_sweep_reference over
    sphere_cluster_boxes): {prefix_tests, box_tests, sphere_tests,
    node_tests, tree_sphere_tests}."""
    import torch

    from raytrace_tpu_torch.ops import megakernel, sphere_sweep, sphere_tree
    from raytrace_tpu_torch.ops.vec3 import V3

    allr = torch.cat(seen, dim=1)
    seen.clear()
    gen = torch.Generator().manual_seed(0)
    sel = torch.randperm(allr.shape[1], generator=gen)[:CLUSTER_SUBSET].to(
        allr.device)
    sub = allr[:, sel]
    o, d = V3(*sub[0:3]), V3(*sub[3:6])
    layout = megakernel.sphere_cluster_layout(static)
    t = None if times is None else times[0]
    moved = (geom.sph_table8 if t is None else
             megakernel.moved_table(geom.sph_table8, geom.sph_dtab8, t))
    best_t, _ = sphere_sweep.sphere_sweep_reference(o, d, moved)
    tree = sphere_tree.sphere_tree_visit_counts(o, d, geom.sph_tree, best_t)
    flat = {}
    megakernel.sphere_cluster_sweep_reference(
        o, d, geom.sph_table8, megakernel.sphere_cluster_boxes(
            geom.sph_table8, *layout, dtab8=geom.sph_dtab8),
        *layout[:2], dtab8=geom.sph_dtab8, t=t, work=flat)
    per_ray = {k: flat[k] / flat["rays"] for k in ("prefix_tests",
                                                  "box_tests",
                                                  "sphere_tests")}
    per_ray.update(node_tests=tree["node_tests"] / tree["rays"],
                   tree_sphere_tests=tree["sphere_tests"] / tree["rays"])
    return per_ray


def _band_work(cs, fused_geom, dev):
    """K4's work a ray on ROW_RANGE's own rays (its rows and samples of
    batch 0 of ``cs``), counted as _cluster_work counts the frame's: the
    band rendered on the wavefront through K1's dense entry point, every
    bounce's alive rays captured, _per_ray_work against ``fused_geom``."""
    import torch

    from raytrace_tpu_torch.engine import Renderer, wavefront

    r = Renderer(cs, device=dev, use_megakernel=False)
    geom = r._geometry(0)
    trace = smoke_lib.dense_trace_fn(r.static, r.scene, geom)
    seen = []

    def capture(o, d, alive):
        seen.append(torch.stack([*o, *d])[:, alive])
        return trace(o, d, alive)

    row_base, rows, spp_local, base = ROW_RANGE
    wavefront.render_tile(r.static, r.scene, r.camera, capture, geom, 0,
                          row_base, min(rows, HEIGHT - row_base), r.use_dof,
                          spp_local, base)
    return _per_ray_work(r.static, fused_geom, seen)


def _walk_batch(name, r, dense_img, dense_rays, card):
    """Batch 0 of wavefront Renderer ``r`` rendered by the Renderer itself
    (render_next_batch: K2 and K1 walking their trees at every bounce,
    shadow rays included), every count set to 0 just before: its image
    must be the bytes of ``dense_img``, the same batch through the dense
    entry points (on the card), and its ray count ``dense_rays``.  Returns
    {"k1", "k2": launches, "s": seconds}."""
    from raytrace_tpu_torch.ops import sphere_sweep, tri_sweep

    if r.use_megakernel or r.current_batch != 0:
        raise AssertionError(f"{name}: not a fresh wavefront Renderer")
    # The Renderer's fold of its first batch (render_next_batch).
    want = ((0.0 * r.accum + dense_img) / 1.0).cpu().numpy()
    _reset_counts()
    (rays, sec), = _step(r, 1)
    out = {"k1": sphere_sweep.LAUNCHES, "k2": tri_sweep.LAUNCHES, "s": sec}
    same = r.image().tobytes() == want.tobytes()
    print(f"{name}'s batch through the Renderer's own wavefront (the "
          f"walks): {rays} rays in {sec:.3f} s, K1 {out['k1']} and K2 "
          f"{out['k2']} launches; byte-identical with the dense entry "
          f"points' batch {same}, {dense_rays} rays there ({card})")
    if not same or rays != dense_rays:
        raise AssertionError(f"{name}: the Renderer's wavefront and the "
                             f"dense oracle's batch differ")
    # On the card each sweep the scene has must have launched (on the CPU
    # the wavefront runs the plain versions and launches nothing).
    idle = [k for k, has in (("k1", r.static.has_spheres),
                             ("k2", r.static.has_tris
                              and r.static.bvh_mode != "paged"))
            if has and out[k] <= 0]
    if idle and r.device.type == "cuda":
        raise AssertionError(f"{name}: the wavefront launched no "
                             f"{' or '.join(k.upper() for k in idle)}")
    return out


def _print_k1_launch(name, k1, card) -> None:
    """K1's launch on a forced wavefront's first bounce (_cluster_work)."""
    print(f"K1 on {name}'s forced wavefront: {k1['launches']} launches in "
          f"the Renderer's batch; the first bounce's {k1['rays']} rays: the walk "
          f"{k1['ms']:.4f} ms, its dense entry {k1['dense_ms']:.4f} ms "
          f"(medians of 5, CUDA events), bit for bit ({card})")


def _tree_work_text(per_ray) -> str:
    """The clustered sweep's work a bounce, the tree's beside the flat
    walk's, as the phases print it."""
    return (f"{per_ray['prefix_tests']:.0f} prefix tests, then the tree's "
            f"{per_ray['node_tests']:.2f} nodes "
            f"({2 * per_ray['node_tests']:.2f} box tests) and {per_ray['tree_sphere_tests']:.2f} sphere tests "
            f"(the flat walk's {per_ray['box_tests']:.0f} box pretests and "
            f"{per_ray['sphere_tests']:.2f} sphere tests in clusters that "
            f"pass)")


def _cluster_bound(geom, per_ray, traced_sum: int, width: int, height: int,
                   n_times: int):
    """K4's bound for one launch of a clustered sphere form, from the
    per-ray work ``_cluster_work`` counted: every bounce tests the prefix,
    then the tree's nodes (two widened boxes each) and the spheres of the
    leaves that a walk proving its closest hit must reach; bytes are the
    prefix's rows, the tree's rows, nodes and ids, the fat rows and
    parameters (and motion rows and times) read once and the sums and
    counts written once.  Returns (that bound, the flat cluster walk's
    that the tree replaced: every cluster box pretested and the spheres
    of the clusters that pass, the table and boxes read once)."""
    anim = geom.sph_dtab8 is not None
    per_test = FLOPS_PER_TEST_ANIM if anim else FLOPS_PER_TEST
    tree = geom.sph_tree
    nbytes = (geom.prim_rows.numel() + 40) * 4 + width * height * (3 * 4 + 4)
    if anim:
        nbytes += n_times * 4
    rows = 2 if anim else 1      # [n, 8] rows, and their motion rows
    tree_flops = traced_sum * (
        (per_ray["prefix_tests"] + per_ray["tree_sphere_tests"]) * per_test
        + per_ray["node_tests"] * 2 * FLOPS_PER_SPHERE_PRETEST)
    tree_bytes = (rows * 8 * (tree.n_prefix + tree.num_spheres)
                  + tree.nodes.numel() + tree.ids.numel()) * 4
    flat_flops = traced_sum * (
        (per_ray["prefix_tests"] + per_ray["sphere_tests"]) * per_test
        + per_ray["box_tests"] * FLOPS_PER_SPHERE_PRETEST)
    # Every ray pretests every cluster box: box_tests a ray is C.
    flat_bytes = (geom.sph_table8.numel() * rows
                  + 8 * round(per_ray["box_tests"])) * 4
    return (least_ms(tree_flops, nbytes + tree_bytes),
            least_ms(flat_flops, nbytes + flat_bytes))


def _dense_ms(args, kw):
    """The dense form's median time (5 launches) on the same batch: the
    static with its cluster layout dropped, which the dense sweep takes
    (_compare_fused has held it to the plain version)."""
    from raytrace_tpu_torch.ops import megakernel

    flat = (dataclasses.replace(args[0], sph_prefix=0),) + args[1:]
    return median_ms(lambda: megakernel.render_tile_mega(*flat, **kw), 5)


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
    """K4's plain version on ``args`` (one batch) once more, counting at
    every bounce the rays traced, the noise hits and the image hits
    (_slot_hits), for _noise_bound and _image_bound, and keeping each
    (pixel, sample)'s path length ([H * W, spp] under "lengths")."""
    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.models.shading_table import MODE_IMAGE, MODE_NOISE
    from raytrace_tpu_torch.ops import megakernel

    static, scene = args[0], args[1]
    work = dict(rays=0, noise_hits=0, image_hits=0)
    inner = wavefront.bounce_wavefront

    def counting(static_, scene_, trace_fn, geom, *rest, **kw):
        def trace(o, d, alive):
            raw = trace_fn(o, d, alive)
            work["rays"] += int(alive.sum())
            for key, mode in (("noise_hits", MODE_NOISE),
                              ("image_hits", MODE_IMAGE)):
                work[key] += _slot_hits(static, scene, geom, o, d, alive,
                                        raw, mode)
            return raw

        out = inner(static_, scene_, trace, geom, *rest, **kw)
        work["lengths"] = rest[-1].reshape(static.width * static.height, -1)
        return out

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
    return least_ms(flops, nbytes)


def _noise_bound(static, geom, work, width: int, height: int,
                 per_turbulence=(OPS_PER_TURBULENCE,
                                 SHARED_BYTES_PER_TURBULENCE)):
    """An estimate of K4's noise form's bound for one launch of a sphere
    scene, from the work ``_plain_work`` counted: every bounce tests
    every sphere and every noise hit takes ``per_turbulence``'s
    (operations, shared-memory bytes); device-memory bytes as
    _k4_bound's."""
    ops, shared = per_turbulence
    flops = (work["rays"] * _spheres(static) * FLOPS_PER_TEST
             + work["noise_hits"] * ops)
    nbytes = ((geom.sph_table8.numel() + geom.prim_rows.numel() + 40) * 4
              + width * height * (3 * 4 + 4))
    return least_ms(flops, nbytes, shared_bytes=work["noise_hits"] * shared)


def _tri_stress(k: int, width: int, obj_dir: str, depth=None, batches=None):
    """The triangle stress scene (tools/stress_scenes.py) at ``width``,
    its JSON and OBJ written into ``obj_dir``; with the JSON's path."""
    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.tools import stress_scenes

    path = stress_scenes.write_tri_stress(obj_dir, k)
    cs = cli.load_scene(path, width)
    return _scene(cs, cs.render.width, cs.render.height, depth,
                  batches), path


def _compare_tris(name, o, d, table16, alive, tree, ref=None):
    """K2 (its walk of the soup's ``tree``) vs its plain version on the
    same rays: bit for bit, or else ids equal and t within rtol/atol on
    >= 99.9% of rays; then the walk and its dense entry point must both
    be the plain version's bits.  ``ref`` is the plain version's (t, id,
    u, v) where it is already computed.  Returns max |dt| over the rays
    whose ids agree."""
    import torch

    from raytrace_tpu_torch.ops import tri_sweep
    from raytrace_tpu_torch.ops.intersect import T_MAX

    hit = tri_sweep.intersect_tris_sweep(o, d, table16, alive, tree)
    dense = tri_sweep.intersect_tris_dense(o, d, table16, alive)
    t, ids, u, v = (tri_sweep.tri_sweep_reference(o, d, table16)
                    if ref is None else ref)
    ref = (torch.where(alive, t, T_MAX), torch.where(alive, ids, -1),
           torch.where(alive, u, 0.0), torch.where(alive, v, 0.0))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(hit, ref))
    dense_bitwise = all(torch.equal(a, b) for a, b in zip(dense, ref))
    same_id = hit.tri == ref[1]
    agree = same_id & ((hit.t - ref[0]).abs() <= ATOL + RTOL * ref[0].abs())
    frac = agree.double().mean().item()
    if not bitwise and frac < AGREEMENT:
        raise AssertionError(f"K2 {name}: (id, t) agree on {frac:.6f} of "
                             f"rays (need {AGREEMENT})")
    err = (hit.t[same_id] - ref[0][same_id]).abs().max().item()
    print(f"triangle sweep {name}: R={o.x.shape[0]} T8={table16.shape[0]} "
          f"(tree: leaves of {tree.leaf}, depth {tree.depth}) alive "
          f"{alive.double().mean().item():.4f}: bit for bit: the walk "
          f"{bitwise}, the dense entry {dense_bitwise}; (id, t) agree on "
          f"{frac:.6f} of rays; hit share "
          f"{(hit.tri >= 0).double().mean().item():.4f}; max |dt| where "
          f"ids agree {err:.3g}")
    if not (bitwise and dense_bitwise):
        raise AssertionError(f"K2 {name}: the walk (bit for bit {bitwise}) "
                             f"or its dense entry ({dense_bitwise}) is not "
                             f"the plain version's bits")
    return err


def _tri_work(name, renderer, card):
    """Render batch 0 of ``renderer``'s triangle scene ``name`` on the
    wavefront,
    as render_next_batch does but through the dense entry points of K2 and
    K1 (the independent oracle, smoke_lib.dense_trace_fn), hold K2's walk
    on TREE_SUBSET of the rays of each bounce of K2_BOUNCES to its plain
    version and its dense entry (_compare_tris), and count at every
    bounce the
    work of K4's triangle form on the same rays (for _k4_tris_bound): the
    alive rays; the tree walk's node tests and triangle tests against each
    ray's closest hit (paged_tri.tree_visit_counts on TREE_SUBSET of the
    bounce's rays, evenly spaced, scaled to its alive rays); the flat
    cluster walk's pretests and the tests of the real triangles of the
    clusters that pass the pretest against each ray's sphere hit, on every
    ray; the noise hits (_slot_hits); and the samples.  Returns (image
    [H, W, 3] on the host, rays traced, work, [H * W, spp] int32 each
    (pixel, sample)'s bounces: its path length).  Then the same batch
    through the Renderer's own wavefront (_walk_batch, K2 and K1 walking
    at every bounce): the dense oracle's bytes and ray count."""
    import torch

    from raytrace_tpu_torch.models.shading_table import MODE_NOISE
    from raytrace_tpu_torch.ops import megakernel, paged_tri, sphere_sweep
    from raytrace_tpu_torch.ops.vec3 import V3

    static, scene = renderer.static, renderer.scene
    geom = renderer._geometry(0)
    trace = smoke_lib.dense_trace_fn(static, scene, geom)
    group = megakernel.tri_group(static, geom.tri_table16.shape[0])
    boxes = megakernel.cluster_boxes(geom.tri_table16, static.num_triangles,
                                     group)
    n_clusters = boxes.shape[0]
    # The rows the flat walk sweeps in each cluster: the real triangles.
    sizes = (static.num_triangles - group * torch.arange(
        n_clusters, device=boxes.device)).clamp(0, group)
    W, H = static.width, static.height
    spp = static.sqrt_spp ** 2
    work = dict(rays=0, pretests=0, tri_tests=0, noise_hits=0,
                node_tests=0.0, tree_tri_tests=0.0, clusters=n_clusters,
                samples=W * H * spp)

    bounce = [0]

    def counting(o, d, alive):
        sph = sphere_sweep.intersect_spheres_dense(o, d, geom.sph_table8,
                                                   alive)
        passes = megakernel.cluster_pretest(o, d, boxes, sph.t)
        n = int(alive.sum())
        work["rays"] += n
        work["pretests"] += n * n_clusters
        work["tri_tests"] += int(((passes & alive).sum(1) * sizes).sum())
        raw = trace(o, d, alive)
        sel = torch.arange(0, o.x.shape[0], max(1, o.x.shape[0]
                                                // TREE_SUBSET),
                           device=alive.device)[:TREE_SUBSET]
        tree = paged_tri.tree_visit_counts(
            V3(*(x[sel].contiguous() for x in o)),
            V3(*(x[sel].contiguous() for x in d)), geom.tri_tree,
            raw.t[sel].contiguous(), alive[sel].contiguous())
        if tree["rays"]:
            work["node_tests"] += tree["node_tests"] * n / tree["rays"]
            work["tree_tri_tests"] += tree["tri_tests"] * n / tree["rays"]
        if bounce[0] in K2_BOUNCES and static.bvh_mode != "paged":
            # K2's walk on TREE_SUBSET of the bounce's rays, held against
            # the plain version and its dense entry point.
            _compare_tris(f"{static.num_triangles}-triangle bounce "
                          f"{bounce[0]}",
                          *(V3(*(x[sel].contiguous() for x in v))
                            for v in (o, d)), geom.tri_table16,
                          alive[sel].contiguous(), geom.tri_tree)
        bounce[0] += 1
        work["noise_hits"] += _slot_hits(static, scene, geom, o, d, alive,
                                         raw, MODE_NOISE)
        return raw

    img, rays, lengths = smoke_lib.wave_lengths(
        static, scene, renderer.camera, counting, geom, renderer.use_dof,
        renderer.rows_per_tile)
    _walk_batch(name, renderer, img, rays, card)
    return img.cpu().numpy(), rays, work, lengths


def _warp_models(label, lengths, card):
    """K4's lanes busy on ``label``'s batch under the two warp models of
    smoke_lib over its [H * W, spp] path lengths: per-sample
    reconvergence (the parent's nested loops) and per-lane regeneration
    (the loop of steps).  Prints both; returns {"per_sample", "regen"}."""
    tail = smoke_lib.warp_tail(lengths)
    regen = smoke_lib.warp_regen(lengths)
    print(f"{label}: K4's lanes busy, modelled on the batch's path lengths "
          f"(warps of 32 pixels): per-sample reconvergence {tail[0]:.4f} "
          f"(longest {tail[2]:.2f} and mean {tail[3]:.2f} bounces a (warp, "
          f"sample)), per-lane regeneration {regen[0]:.4f} (busiest lane "
          f"{regen[2]:.1f} and mean lane {regen[3]:.1f} bounces over the "
          f"{lengths.shape[1]} samples) ({card})")
    return {"per_sample": tail[0], "regen": regen[0]}


def _measured_busy(label, args, kw, models, card):
    """K4's measuring build on the same launch (smoke_lib.measure_busy:
    byte-identical sums, busy lanes equal to the bounces traced): prints
    its lanes-busy share beside the models and each phase's share of the
    warps' cycles; returns them."""
    res = smoke_lib.measure_busy(args, kw)
    noise = (f"; {res['noise_lanes']} turbulences, "
             f"{res['noise_lanes_a_step']:.3f} a warp step"
             if res.get("noise_lanes") else "")
    print(f"{label}: K4's own lanes busy (measuring build, byte-identical "
          f"sums) {res['busy']:.4f} of {res['steps']} warp steps, against "
          f"the models' {models['regen']:.4f} (regeneration) and "
          f"{models['per_sample']:.4f} (per-sample); the warps' cycles: "
          + ", ".join(f"{k} {v:.4f}" for k, v in res["phases"].items())
          + f"{noise} ({card})")
    return res


def _paged_equal(a, b, alive) -> bool:
    """Two sweeps' hits bit for bit: t and id on every ray, u and v on the
    alive ones (the dense sweep fills them on dead rays too)."""
    import torch

    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2][alive], b[2][alive])
            and torch.equal(a[3][alive], b[3][alive]))


def _compare_paged(name, o, d, tree, table16, alive, plain=True):
    """K3 vs its plain version (when ``plain``) and vs K2 over the same
    soup, on the same rays: bit for bit, and two launches byte-identical.
    Returns (plain seconds or None, K3's hits)."""
    import torch

    from raytrace_tpu_torch.ops import paged_tri, tri_sweep

    hit = paged_tri.intersect_tris_paged(o, d, tree, alive)
    again = paged_tri.intersect_tris_paged(o, d, tree, alive)
    k2 = tri_sweep.intersect_tris_dense(o, d, table16, alive)
    torch.cuda.synchronize()
    plain_s = None
    checks = {"K2": _paged_equal(hit, k2, alive),
              "repeat": all(torch.equal(a, b) for a, b in zip(hit, again))}
    if plain:
        t0 = time.perf_counter()
        ref = paged_tri.tri_tree_sweep_reference(o, d, tree, alive)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        checks["plain"] = _paged_equal(hit, ref, alive)
    print(f"paged sweep {name}: R={o.x.shape[0]} T={tree.num_tris} "
          f"L={tree.leaf} depth {tree.depth} alive "
          f"{alive.double().mean().item():.4f}: bit for bit with "
          + ", ".join(f"{k} {v}" for k, v in checks.items())
          + f"; hit share {(hit.tri >= 0).double().mean().item():.4f}"
          + (f"; plain {plain_s:.3f} s" if plain else ""))
    if not all(checks.values()):
        raise AssertionError(f"K3 {name}: {checks}")
    return plain_s, hit


def _paged_random(T, R, seed, dev):
    """T random small triangles in a 10-unit box in the paged sweep's
    order, with a duplicate pair: (tree, dense table, rays towards random
    triangles with a tenth in random directions, alive mask)."""
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
    return (paged_tri.build_tri_tree(wp, T), tri_sweep.pack_tri_table(wp, T),
            v3(o), v3(d), torch.tensor(rng.random(R) < 0.7, device=dev))


def _k3_far_grazing(geom, static, dev):
    """K3 against K2 on rays from 1,000-2,000 units away grazing the
    mesh's leaf boxes: bit for bit, but for rays whose K2 hit lies farther
    off its own triangle's box than the ray's rounding margin (the
    Moller-Trumbore test's error far from the origin at near-parallel
    incidence, which no conservative box can hold), each printed.
    Returns (rays, such rays)."""
    import torch

    from raytrace_tpu_torch.ops import paged_tri, tri_sweep

    n = static.num_triangles
    wp = geom.world_p[:n]
    boxes = paged_tri.leaf_boxes(wp, n)[:-(-n // paged_tri.LEAF)]
    o, d = smoke_lib.grazing_rays(boxes.cpu().numpy(), GRAZING_RAYS, 11, dev)
    alive = torch.ones(GRAZING_RAYS, dtype=torch.bool, device=dev)
    hit = paged_tri.intersect_tris_paged(o, d, geom.tri_tree, alive)
    k2 = tri_sweep.intersect_tris_dense(o, d, geom.tri_table16, alive)
    bad = torch.nonzero((hit.t != k2.t) | (hit.tri != k2.tri))[:, 0]
    for r in bad.tolist():
        j = int(k2.tri[r])
        tri = wp[j].double()
        p = torch.stack([x[r].double() for x in o]) + k2.t[r].double() * \
            torch.stack([x[r].double() for x in d])
        off = float(torch.maximum(tri.amin(0) - p, p - tri.amax(0)).amax())
        reach = float(boxes[j // paged_tri.LEAF].abs().amax())
        margin = (max(abs(float(x[r])) for x in o) + reach) * \
            paged_tri.TREE_ROUNDING
        print(f"far grazing ray {r}: K2 hit {j} at t {float(k2.t[r])}, "
              f"{off:.3g} off its triangle's box (margin {margin:.3g}); K3 "
              f"{int(hit.tri[r])} at t {float(hit.t[r])}")
        if not off > margin:
            raise AssertionError(f"K3 lost K2's hit on far grazing ray {r}")
    print(f"far grazing: {GRAZING_RAYS} rays at the mesh's leaf boxes, K2 "
          f"hits {float((k2.tri >= 0).double().mean()):.4f}; K3 bit for bit "
          f"with K2 on all but {len(bad)}, each a K2 hit off its triangle")
    return GRAZING_RAYS, len(bad)


def _k3_work(label, o, d, alive, geom, pages, gen):
    """The tree's and the flat walk's work on MESH_SUBSET of one bounce's
    rays: (per active ray: tree node tests, tree triangle tests, flat page,
    cluster and triangle tests)."""
    import torch

    from raytrace_tpu_torch.ops import paged_tri
    from raytrace_tpu_torch.ops.vec3 import V3

    sel = torch.randperm(o.x.shape[0], generator=gen)[:MESH_SUBSET].to(
        o.x.device)
    so, sd = (V3(*(x[sel].contiguous() for x in v)) for v in (o, d))
    sa = alive[sel].contiguous()
    bt = paged_tri.intersect_tris_paged(so, sd, geom.tri_tree, sa).t
    tree = paged_tri.tree_visit_counts(so, sd, geom.tri_tree, bt, sa)
    flat = paged_tri.visit_counts(so, sd, pages, bt, sa)
    n = tree["rays"]
    per = (tree["node_tests"] / n, tree["tri_tests"] / n,
           flat["page_tests"] / n, flat["cluster_tests"] / n,
           flat["tri_tests"] / n)
    print(f"K3 work on {n} active of {sa.numel()} {label} rays, a ray: tree "
          f"{per[0]:.1f} nodes (two box tests each) and {per[1]:.1f} "
          f"triangle tests, {tree['nodes_read']} node rows and "
          f"{tree['tris_read']} triangle rows read in all; flat walk "
          f"{per[2]:.1f} page, {per[3]:.1f} cluster and {per[4]:.1f} "
          f"triangle tests")
    return per, 64 * tree["nodes_read"] + 48 * tree["tris_read"]


def _k3_bounds(per, rays, n_launch, R_total, tree_bytes, flat_bytes):
    """(tree bound, flat bound) of K3 over ``rays`` active rays of
    ``n_launch`` launches of ``R_total`` rays in all, from per-ray work
    ``per`` (_k3_work): least_ms of the FP32 operations, and of the rays'
    bytes with, each launch, the tree's rows its subset read
    (``tree_bytes``: fewer than the whole launch reads) or the flat walk's
    tables (``flat_bytes``, read whole, as PRs 6-10 counted them)."""
    nodes, tris, pages, clusters, flat_tris = per
    nbytes = R_total * (6 * 4 + 1 + 4 * 4)
    tree = smoke_lib.least_ms(
        rays * (nodes * FLOPS_PER_TREE_NODE + tris * FLOPS_PER_TRI_TEST),
        nbytes + n_launch * tree_bytes)
    flat = smoke_lib.least_ms(
        rays * ((pages + clusters) * FLOPS_PER_PRETEST
                + flat_tris * FLOPS_PER_TRI_TEST),
        nbytes + n_launch * flat_bytes)
    return tree, flat


def _k3_full(mesh_r, card):
    """K3 on final-one-weekend --mesh-geometry, the main path's soup: every
    bounce's rays of batch 0 (render_tile with a capturing trace); all
    primary rays bit for bit with the plain version (timed) and K2, and
    MESH_SUBSET of bounces 0, 1, 2 and 10 against K2 (and, past the
    primary rays, the plain version); far grazing rays against K2; K3
    timed on every bounce's rays (K3 ms a batch) and over the primary
    rays; the tree's and the flat walk's work counted on MESH_SUBSET of
    bounces 0, 1 and 2 for the bounds.  Returns a dict."""
    import torch

    from raytrace_tpu_torch.ops import paged_tri
    from raytrace_tpu_torch.ops.vec3 import V3

    static = mesh_r.static
    geom, seen = smoke_lib.capture_bounces(mesh_r)
    tree, table16 = geom.tri_tree, geom.tri_table16
    o, d, alive = seen[0]
    n_rays = o.x.shape[0]
    if n_rays != static.width * static.height * static.sqrt_spp ** 2:
        raise AssertionError(f"mesh primary rays: {n_rays}")
    plain_s, hit = _compare_paged(f"{n_rays} primary (all)", o, d, tree,
                                  table16, alive)
    del hit
    gen = torch.Generator().manual_seed(0)
    for b in (0, 1, 2, 10):
        ro, rd, ra = seen[b]
        sel = torch.randperm(ro.x.shape[0], generator=gen)[:MESH_SUBSET].to(
            ro.x.device)
        so, sd = (V3(*(x[sel].contiguous() for x in v)) for v in (ro, rd))
        _compare_paged(f"{min(MESH_SUBSET, ro.x.shape[0])} of bounce {b}'s "
                       f"{ro.x.shape[0]}", so, sd, tree, table16,
                       ra[sel].contiguous(), plain=b > 0)
    grazing = _k3_far_grazing(geom, static, o.x.device)
    per_bounce = smoke_lib.k3_bounce_ms(tree, seen)
    ms = median_ms(
        lambda: paged_tri.intersect_tris_paged(o, d, tree, alive), 5)
    pages = paged_tri.build_page_tables(geom.world_p, static.num_triangles,
                                        geom.tri_table12)
    work = [_k3_work(f"bounce {b}", *seen[b], geom, pages, gen)
            for b in (0, 1, 2)]
    active = [int(a.sum()) for _, _, a in seen]
    R_all = sum(x.x.shape[0] for x, _, _ in seen)
    flat_bytes = 4 * (pages.tris.numel() + pages.boxes.numel()
                      + pages.page_boxes.numel())
    bound, flat_bound = _k3_bounds(work[0][0], active[0], 1, n_rays,
                                   work[0][1], flat_bytes)
    # The later bounces at the mean of bounces 1 and 2's work a ray.
    later = [(w1 + w2) / 2 for w1, w2 in zip(work[1][0], work[2][0])]
    b_tree, b_flat = _k3_bounds(later, sum(active[1:]), len(seen) - 1,
                                R_all - n_rays,
                                min(work[1][1], work[2][1]), flat_bytes)
    batch_bound = (bound[0] + b_tree[0], b_tree[1])
    batch_flat = (flat_bound[0] + b_flat[0], b_flat[1])
    batch_ms = sum(per_bounce)
    print(f"K3 ms per bounce of batch 0 ({len(seen)} launches, "
          f"{sum(active)} active rays of {R_all}): "
          + ", ".join(f"{x:.3f}" for x in per_bounce) + f" ({card})")
    print(f"K3 a batch of final-one-weekend --mesh-geometry at L={tree.leaf}"
          f" (depth {tree.depth}, {tree.nodes.numel() * 4 / 1e6:.1f} MB of "
          f"nodes): {batch_ms:.3f} ms, the primary rays' launch {ms:.3f} ms "
          f"(median of 5, CUDA events); plain PyTorch on the primary rays "
          f"{plain_s * 1e3:.1f} ms (one run, host clock); bound (an "
          f"estimate from the work on {MESH_SUBSET} rays of bounces 0, 1 "
          f"and 2) {bound[0]:.4f} ms on the primary rays by {bound[1]} "
          f"({bound[0] / ms:.4f} of it), {batch_bound[0]:.4f} ms a batch "
          f"({batch_bound[0] / batch_ms:.4f} of it); the flat walk's bound "
          f"{flat_bound[0]:.4f} ms and {batch_flat[0]:.4f} ms a batch "
          f"({card})")
    return dict(ms=ms, plain_ms=plain_s * 1e3, bound=bound,
                flat_bound=flat_bound, batch_ms=batch_ms,
                batch_bound=batch_bound, batch_flat_bound=batch_flat,
                leaf=tree.leaf, grazing=grazing)


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
    from raytrace_tpu_torch.ops import (bvh, megakernel, paged_tri,
                                        sphere_obj, sphere_sweep, tri_sweep)
    from raytrace_tpu_torch.tools_dev import (micro_raygen, probe_ops,
                                              probe_trig)

    sphere_sweep.LAUNCHES = tri_sweep.LAUNCHES = paged_tri.LAUNCHES = 0
    bvh.LAUNCHES = sphere_obj.LAUNCHES = 0
    megakernel.LAUNCHES = megakernel.ANIM_LAUNCHES = 0
    megakernel.TRI_LAUNCHES = megakernel.LIGHT_LAUNCHES = 0
    megakernel.NOISE_LAUNCHES = megakernel.IMAGE_LAUNCHES = 0
    megakernel.SPHERE_CLUSTER_LAUNCHES = 0
    probe_ops.LAUNCHES = dict.fromkeys(probe_ops.PROBES, 0)
    probe_trig.LAUNCHES = probe_trig.SCALAR_LAUNCHES = 0
    micro_raygen.LAUNCHES = 0
    micro_raygen.SPLIT_LAUNCHES = 0


def _mrays(per_batch):
    return sum(r for r, _ in per_batch) / sum(s for _, s in per_batch) / 1e6


def _busy_share(events, label, wall_s, kernel="megakernel", labels=()):
    """The device timeline of the work profiled under
    record_function(label): the card's operation intervals that start
    inside that host range (the work ends in a synchronize), without the
    device-side annotations of the range and of the other profiled
    ``labels``, each of which spans its whole range and is no operation
    of the card's (the next range's can start inside this one).  Returns a
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
                   and e.name != label and e.name not in labels
                   and lo <= e.time_range.start <= hi)
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


def _dense_batch(r):
    """Batch 0 of ``r``'s scene on the wavefront, as render_next_batch
    renders it but through the dense entry points of K2 and K1
    (smoke_lib.dense_trace_fn): (image [H, W, 3] on the host, rays,
    seconds)."""
    import torch

    from raytrace_tpu_torch.engine import wavefront

    t0 = time.perf_counter()
    geom = r._geometry(0)
    trace = smoke_lib.dense_trace_fn(r.static, r.scene, geom)
    tiles, rays = [], 0
    for row0 in range(0, r.static.height, r.rows_per_tile):
        tile, traced = wavefront.render_tile(
            r.static, r.scene, r.camera, trace, geom, 0, row0,
            r.rows_per_tile, r.use_dof)
        tiles.append(tile)
        rays += traced
    img = (0.0 * r.accum + torch.cat(tiles, dim=0)[:r.static.height]) / 1.0
    torch.cuda.synchronize()
    return img.cpu().numpy(), rays, time.perf_counter() - t0


def _paged_vs_dense(label, paged_cs, dev, card):
    """A reduced frame of a soup in paged order, one batch at full depth,
    on the paged sweep K3, on K2's walk of the soup's own tree
    (use_bvh=False) and through the dense sweep K2's dense entry point:
    the same bytes and the same ray count."""
    from raytrace_tpu_torch.engine import Renderer

    small = _scene(paged_cs, *REDUCED, batches=1)
    out = {}
    for mode in ("paged", False):
        r = Renderer(small, device=dev, use_bvh=mode)
        (rays, sec), = _step(r, 1)
        out[mode] = (r.image(), rays, sec)
    out["dense"] = _dense_batch(Renderer(small, device=dev, use_bvh=False))
    same = (out["paged"][0].tobytes() == out[False][0].tobytes()
            == out["dense"][0].tobytes())
    print(f"{label} at {REDUCED[0]}x{REDUCED[1]}, depth "
          f"{small.render.max_ray_depth}, one batch: paged, K2's walk and "
          f"dense images byte-identical {same}; rays {out['paged'][1]} vs "
          f"{out[False][1]} vs {out['dense'][1]}; {out['paged'][2]:.3f} s "
          f"vs {out[False][2]:.3f} s vs {out['dense'][2]:.3f} s ({card})")
    if not same or not (out["paged"][1] == out[False][1]
                        == out["dense"][1]):
        raise AssertionError(f"{label}: the paged, walk and dense renders "
                             f"differ")


def _mesh_paths(mesh_r, mb_scene, fused_img, wave_img, dev, card):
    """The big-mesh paths: ``mesh_r`` (final-one-weekend --mesh-geometry,
    Renderer with defaults) stepped as the main path, the reduced-frame
    identity on its soup, and one batch of the motion-blur scene with
    --mesh-geometry.  Returns K3's launches on the main path and its
    Mrays/s over batches 1-3 stepped."""
    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import (megakernel, paged_tri, sphere_sweep,
                                        tri_sweep)

    # The big-mesh main path: final-one-weekend --mesh-geometry through
    # Renderer with defaults, the paged wavefront (K3 alone: no sphere is
    # left, and K2 and K4 must not run), its batches stepped.
    _reset_counts()
    per_batch = _step(mesh_r, MAIN_BATCHES)
    rays0, sec0 = mesh_r.stats.rays_traced, mesh_r.stats.render_seconds
    mesh_r.render_all()
    all_rays = mesh_r.stats.rays_traced - rays0
    all_s = mesh_r.stats.render_seconds - sec0
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
          f"1-{MAIN_BATCHES - 1} stepped one at a time, "
          f"{all_rays / all_s / 1e6:.3f} over the other "
          f"{mesh_r.compiled.render.sample_batches - MAIN_BATCHES} in "
          f"render_all ({all_s:.3f} s); paged_tri LAUNCHES={k3_launches}, "
          f"tri_sweep, megakernel and sphere_sweep LAUNCHES=0 ({card})")
    mesh_img = mesh_r.image()
    _check_image(mesh_img, "mesh paged")
    print(f"mesh vs analytic spheres (all {mesh_r.current_batch} batches "
          f"against {MAIN_BATCHES}): "
          f"channel means {mesh_img.mean(axis=(0, 1)).tolist()} (mesh), "
          f"{fused_img.mean(axis=(0, 1)).tolist()} (fused), "
          f"{wave_img.mean(axis=(0, 1)).tolist()} (wavefront)")

    # The whole path bit for bit: a reduced frame of the same permuted
    # soup on the paged sweep and on the dense sweep K2.
    _paged_vs_dense("mesh", mesh_r.compiled, dev, card)

    # Motion blur with meshes: final-one-weekend-motion-blur
    # --mesh-geometry, its tree re-fitted for every batch from that
    # batch's world soup.
    cs_mb_mesh = cli.load_scene(mb_scene, analytic_spheres=False)
    mb_mesh = Renderer(cs_mb_mesh, device=dev)
    builds = []
    build_tree = paged_tri.build_tri_tree
    paged_tri.build_tri_tree = lambda *a, **k: (  # noqa: E731
        builds.append(1), build_tree(*a, **k))[1]
    _reset_counts()
    try:
        (mb_rays, mb_s), = _step(mb_mesh, 1)
    finally:
        paged_tri.build_tri_tree = build_tree
    g1 = mb_mesh._geometry(1)
    refit_ms = median_ms(lambda: paged_tri.build_tri_tree(
        g1.world_p, cs_mb_mesh.num_triangles, g1.tri_table12), 5)
    del g1
    if (mb_mesh.path != "wavefront" or mb_mesh.static.bvh_mode != "paged"
            or not mb_mesh.static.any_animated or len(builds) != 1
            or paged_tri.LAUNCHES <= 0 or tri_sweep.LAUNCHES
            or megakernel.LAUNCHES):
        raise AssertionError(
            f"the motion-blur mesh did not take the paged wavefront with "
            f"a tree re-fitted per batch (path {mb_mesh.path}, trees built "
            f"{len(builds)}, K3 {paged_tri.LAUNCHES})")
    print(f"motion-blur mesh (wavefront, paged triangles, tree re-fitted "
          f"per batch in {refit_ms:.3f} ms, median of 5, CUDA events): "
          f"final-one-weekend-motion-blur --mesh-geometry "
          f"{MB_WIDTH}x{MB_HEIGHT}, {cs_mb_mesh.num_triangles} triangles, "
          f"one batch: {mb_rays} rays in {mb_s:.4f} s "
          f"({mb_rays / mb_s / 1e6:.3f} Mrays/s); paged_tri "
          f"LAUNCHES={paged_tri.LAUNCHES} ({card})")
    _check_image(mb_mesh.image(), "motion-blur mesh paged", MB_WIDTH,
                 MB_HEIGHT)
    _paged_vs_dense("motion-blur mesh", mb_mesh.compiled, dev, card)
    return k3_launches, _mrays(per_batch[1:])


def _h1_bound(per, active: int, rays: int, launches: int, tree_bytes: int,
              per_node: int = FLOPS_PER_TREE_NODE):
    """H1's least time for ``active`` rays of ``rays`` in ``launches``
    launches at ``per`` = (node steps, triangle tests) a ray, ``per_node``
    FP32 operations a node step (a binary node's two box tests, or with
    FLOPS_PER_WIDE_NODE a wide node's four): the FP32 operations of those
    tests, and the rays' bytes (25 in, 16 out) with the distinct node and
    triangle rows once a launch."""
    return least_ms(active * (per[0] * per_node
                              + per[1] * FLOPS_PER_TRI_TEST),
                    rays * (6 * 4 + 1 + 4 * 4) + launches * tree_bytes)


def _h1_bounces(label, r, card, gen):
    """H1 on batch 0 of wavefront Renderer ``r`` (use_bvh=True): every
    bounce's rays held bit for bit against K2's walk over the same soup
    (use_bvh=False: the dense sweep's bits), H1 against its plain walk
    and the binary rows' plain walk on BVH_SUBSET of the primary rays,
    timed on the primary rays and on every bounce, its work counted on
    bounces 0 and 1 for the bounds (the wide walk's and the dense
    sweep's).  Returns a dict."""
    import torch

    from raytrace_tpu_torch.engine import Renderer, wavefront
    from raytrace_tpu_torch.ops import bvh, tri_sweep

    t_phase = time.perf_counter()
    tree = wavefront.bvh_tree(r.static, r.scene)
    n = r.static.num_triangles
    rows, root = bvh.node_rows(r.bvh, n)
    binary = bvh.BVHTree(torch.tensor(rows, device=tree.nodes.device), root,
                         r.bvh.depth + 2, tree.leaf, n)
    geom, seen = smoke_lib.capture_bounces(r)
    table12 = geom.tri_table12
    k2_geom = Renderer(r.compiled, device=tree.nodes.device,
                       use_bvh=False)._geometry(0)

    def h1(o, d, a):
        return bvh.intersect_tris_bvh(o, d, table12, tree, a)

    same = True
    for o, d, a in seen:
        hit = h1(o, d, a)
        k2 = tri_sweep.intersect_tris_sweep(o, d, k2_geom.tri_table16, a,
                                            k2_geom.tri_tree)
        same &= (torch.equal(hit.t, k2.t) and torch.equal(hit.tri, k2.tri)
                 and torch.equal(hit.u[a], k2.u[a])
                 and torch.equal(hit.v[a], k2.v[a]))
    del k2_geom
    o, d, alive = seen[0]
    so, sd, sa = smoke_lib.subset_rays(o, d, alive, BVH_SUBSET, gen)
    hit = h1(so, sd, sa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = bvh.bvh_walk_reference(so, sd, table12, tree, sa)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    walk = bvh.bvh_walk_reference(so, sd, table12, binary, sa)
    held = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               and torch.equal(x.view(torch.int32), z.view(torch.int32))
               for x, y, z in zip(hit, plain, walk))
    err = float((hit.t - plain[0]).abs().max())
    print(f"H1 on {label} ({tree.nodes.shape[0]} four-wide rows, a stack of "
          f"{tree.stack_depth}): every bounce of batch 0 ({len(seen)} "
          f"launches) bit for bit with K2's walk over the same soup {same}; "
          f"{BVH_SUBSET} of the {o.x.shape[0]} primary rays bit for bit "
          f"with its plain walk and the binary rows' {held}, "
          f"{int((hit.tri >= 0).sum())} hits ({card})")
    if not (same and held):
        raise AssertionError(f"H1 on {label} disagrees with its plain "
                             f"version or the dense sweep's bits")
    sub_ms = median_ms(lambda: h1(so, sd, sa), 5)
    ms, per_bounce = smoke_lib.bounce_ms(h1, seen)
    # Its work on BVH_SUBSET of the rays of bounces 0 and 1: the bound
    # takes the binary walk's, the least that proves the hits over these
    # boxes; the wide walk's own (four box tests a step) is printed beside
    # it as a figure.
    (work0, wbytes0), (bin0, bytes0) = smoke_lib.bvh_work(
        o, d, alive, table12, (tree, binary), BVH_SUBSET, gen)
    (work1, wbytes1), (bin1, bytes1) = smoke_lib.bvh_work(
        *seen[1], table12, (tree, binary), BVH_SUBSET, gen)
    steps0, steps1 = bin0[0], bin1[0]
    active = [int(a.sum()) for _, _, a in seen]
    R_all = sum(x.x.shape[0] for x, _, _ in seen)
    R0 = o.x.shape[0]
    bound = _h1_bound(bin0, active[0], R0, 1, bytes0)
    later = _h1_bound(bin1, sum(active[1:]), R_all - R0, len(seen) - 1,
                      bytes1)
    batch_ms, batch_bound = sum(per_bounce), (bound[0] + later[0], later[1])
    wide = _h1_bound(work0, active[0], R0, 1, wbytes0, FLOPS_PER_WIDE_NODE)
    wide_later = _h1_bound(work1, sum(active[1:]), R_all - R0,
                           len(seen) - 1, wbytes1, FLOPS_PER_WIDE_NODE)
    wide_batch = wide[0] + wide_later[0]
    dense = least_ms(active[0] * n * FLOPS_PER_TRI_TEST,
                     o.x.shape[0] * (6 * 4 + 1 + 4 * 4) + n * 48)
    dense_batch = least_ms(sum(active) * n * FLOPS_PER_TRI_TEST,
                           R_all * (6 * 4 + 1 + 4 * 4) + len(seen) * n * 48)
    print(f"H1 on {label}, ms per bounce of batch 0 ({len(seen)} launches, "
          f"{sum(active)} active rays of {R_all}): "
          + ", ".join(f"{x:.3f}" for x in per_bounce) + f" ({card})")
    print(f"H1 on {label}: {batch_ms:.3f} ms a batch, the primary rays' "
          f"launch {ms:.4f} ms, {BVH_SUBSET} of them {sub_ms:.3f} ms "
          f"(medians, CUDA events), plain PyTorch on those {plain_ms:.1f} ms "
          f"(one run, host clock); work a ray on the primary rays "
          f"{steps0:.2f} binary node steps and {bin0[1]:.2f} triangle tests "
          f"(the wide walk's {work0[0]:.2f} steps and {work0[1]:.2f}), on "
          f"bounce 1's {steps1:.2f} and {bin1[1]:.2f} ({work1[0]:.2f} and "
          f"{work1[1]:.2f}); bound from the binary walk's work "
          f"{bound[0]:.4f} ms on the primary rays by {bound[1]} "
          f"({bound[0] / ms:.4f} of it), {batch_bound[0]:.4f} ms a batch "
          f"({batch_bound[0] / batch_ms:.4f}); from the wide walk's own "
          f"work {wide[0]:.4f} and {wide_batch:.4f} ms by {wide[1]}; from "
          f"the dense sweep's work {dense[0]:.1f} and {dense_batch[0]:.1f} "
          f"ms by {dense[1]}; the binary walk's figures {H1_BEFORE} "
          f"({card})")
    print(f"phase H1 on {label}: {time.perf_counter() - t_phase:.1f} s")
    return dict(ms=ms, plain_ms=plain_ms, sub_ms=sub_ms, bound=bound,
                batch_ms=batch_ms, batch_bound=batch_bound, err=err,
                dense_bound=dense, dense_batch_bound=dense_batch,
                wide_bound=wide, wide_batch_bound=wide_batch,
                work=(work0, work1), steps=(steps0, steps1))


def _sah_paths(cs_mesh, mb_scene, paged_mrays, dev, card):
    """use_bvh=True on final-one-weekend --mesh-geometry (the SAH BVH and
    H1, four-wide rows): the native build's and the collapse's host time,
    rows, depth and stack; H1 on batch 0 of the SAH tree and of the
    implicit tree (``_h1_bounces``); the Renderer's batch byte-identical
    with K2's on the same soup (use_bvh=False) with equal ray counts, its
    Mrays/s beside the paged path's; the same identity for one batch of
    the motion-blur mesh.  Returns a dict for the kernels line."""
    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.engine import renderer as renderer_mod
    from raytrace_tpu_torch.models import bvh_native
    from raytrace_tpu_torch.ops import (bvh, megakernel, paged_tri,
                                        sphere_sweep, tri_sweep)

    t_phase = time.perf_counter()

    def sah_renderer(cs, implicit=False):
        """Renderer(cs, use_bvh=True) (on the implicit tree that a failed
        SAH build leaves, with ``implicit``), the SAH build's and the
        collapse's host seconds."""
        secs, wide_s = [], []
        build, wide = renderer_mod.build_bvh_sah, bvh.wide_rows

        def timed(*a, **k):
            if implicit:
                secs.append(0.0)
                return None
            t0 = time.perf_counter()
            out = build(*a, **k)
            secs.append(time.perf_counter() - t0)
            return out

        def timed_wide(*a, **k):
            t0 = time.perf_counter()
            out = wide(*a, **k)
            wide_s.append(time.perf_counter() - t0)
            return out

        renderer_mod.build_bvh_sah, bvh.wide_rows = timed, timed_wide
        try:
            t0 = time.perf_counter()
            r = Renderer(cs, device=dev, use_bvh=True)
            init_s = time.perf_counter() - t0
        finally:
            renderer_mod.build_bvh_sah, bvh.wide_rows = build, wide
        want = "implicit" if implicit else "sah"
        if (r.static.bvh_mode != want or bvh_native.error() is not None
                or r.path != "wavefront" or len(secs) != 1
                or len(wide_s) != 1):
            raise AssertionError(
                f"use_bvh=True did not build the {want} BVH (bvh_mode "
                f"{r.static.bvh_mode}, path {r.path}, native builder "
                f"error {bvh_native.error()})")
        return r, secs[0], wide_s[0], init_s

    def identity(label, r, size):
        """One batch of ``r`` (batch 0) against the same batch on K2 over
        r's soup: (rays, seconds)."""
        _reset_counts()
        (rays, sec), = _step(r, 1)
        img = r.image()
        if (bvh.LAUNCHES <= 0 or tri_sweep.LAUNCHES or paged_tri.LAUNCHES
                or megakernel.LAUNCHES or sphere_sweep.LAUNCHES):
            raise AssertionError(f"{label} did not run on H1 alone (H1 "
                                 f"{bvh.LAUNCHES}, K2 {tri_sweep.LAUNCHES}"
                                 f", K3 {paged_tri.LAUNCHES})")
        launches = bvh.LAUNCHES
        k2 = Renderer(r.compiled, device=dev, use_bvh=False)
        (k2_rays, k2_sec), = _step(k2, 1)
        same = img.tobytes() == k2.image().tobytes()
        print(f"{label} ({size[0]}x{size[1]}, 4 spp, depth 50), batch 0: "
              f"the SAH BVH (H1, {launches} launches) and K2's walk over "
              f"the same soup byte-identical {same}; rays {rays} vs "
              f"{k2_rays}; {sec:.3f} s vs {k2_sec:.3f} s ({card})")
        if not same or rays != k2_rays:
            raise AssertionError(f"{label}: the SAH BVH's batch is not "
                                 f"K2's")
        _check_image(img, label, *size)
        return rays, sec, launches

    gen = torch.Generator().manual_seed(1)
    r, build_s, wide_s, init_s = sah_renderer(cs_mesh)
    data = r.bvh
    print(f"SAH BVH of final-one-weekend --mesh-geometry: "
          f"{cs_mesh.num_triangles} triangles, built on the host in "
          f"{build_s:.2f} s (world bounds and the native builder), its "
          f"{data.child_boxes.shape[0]} binary node rows collapsed into "
          f"{r.scene.bvh_child_boxes.shape[0]} four-wide rows in "
          f"{wide_s:.3f} s (the Renderer {init_s:.2f} s with the "
          f"permutation and upload): depth {data.depth}, a stack of "
          f"{bvh.wide_stack(data.depth)} of the kernel's {bvh.MAX_STACK}, "
          f"root link {data.root} ({card})")
    h1 = _h1_bounces("the mesh's SAH tree", r, card, gen)
    rays0, sec0, _ = identity("mesh SAH", r, (WIDTH, HEIGHT))
    _reset_counts()
    per_batch = _step(r, MAIN_BATCHES - 1)
    launches = bvh.LAUNCHES
    if launches <= 0 or tri_sweep.LAUNCHES or paged_tri.LAUNCHES:
        raise AssertionError("the mesh's SAH path did not run on H1")
    mrays = _mrays(per_batch)
    print(f"mesh SAH path (wavefront, use_bvh=True): final-one-weekend "
          f"--mesh-geometry {WIDTH}x{HEIGHT}, 4 spp, depth 50: {mrays:.3f} "
          f"Mrays/s over batches 1-{MAIN_BATCHES - 1} stepped, beside the "
          f"paged path's {paged_mrays:.3f} in this run; bvh LAUNCHES="
          f"{launches}, tri_sweep, paged_tri, megakernel and sphere_sweep "
          f"LAUNCHES=0 ({card})")
    del r

    ri, _, iwide_s, iinit_s = sah_renderer(cs_mesh, implicit=True)
    print(f"implicit BVH of the mesh (leaves of {ri.bvh.leaf_size}, depth "
          f"{ri.bvh.depth}): {ri.scene.bvh_child_boxes.shape[0]} four-wide "
          f"rows, collapsed in {iwide_s:.3f} s (the Renderer {iinit_s:.2f} "
          f"s) ({card})")
    implicit = _h1_bounces("the mesh's implicit tree", ri, card, gen)
    del ri

    cs_mb_mesh = cli.load_scene(mb_scene, analytic_spheres=False)
    mb, mb_build_s, _, mb_init_s = sah_renderer(cs_mb_mesh)
    print(f"SAH BVH of final-one-weekend-motion-blur --mesh-geometry: "
          f"{cs_mb_mesh.num_triangles} triangles over the shutter (9 "
          f"samples), built on the host in {mb_build_s:.2f} s (the "
          f"Renderer {mb_init_s:.2f} s): {mb.bvh.child_boxes.shape[0]} node "
          f"rows, depth {mb.bvh.depth} ({card})")
    if not mb.static.any_animated:
        raise AssertionError("the motion-blur mesh does not move")
    mb_rays, mb_s, _ = identity("motion-blur mesh SAH", mb,
                                (MB_WIDTH, MB_HEIGHT))
    print(f"motion-blur mesh SAH path: one batch {mb_rays} rays in "
          f"{mb_s:.4f} s ({mb_rays / mb_s / 1e6:.3f} Mrays/s) ({card})")
    print(f"phase SAH paths: {time.perf_counter() - t_phase:.1f} s")
    return dict(h1, launches=launches, mrays=mrays, depth=data.depth,
                build_s=build_s, wide_s=wide_s, implicit=implicit)


def _h2_drift(r, tree, h2, dense, dev, card) -> int:
    """H2 through fow-ellipsoids' once-built tree (``tree``, batch 0's)
    on GRAZING_RAYS grazing rays from near and from 1,000-2,000 away, at
    batch 0's rows and at the first of 64 seeded times whose rows differ
    from batch 0's in their last bits (taken into the tree as
    prepare_batch takes them), bit for bit with the dense entry point.
    ``h2`` and ``dense`` launch on (o, d, alive) with a table and tree.
    Returns how many table rows differ at that time."""
    import torch

    from raytrace_tpu_torch.engine import wavefront
    from raytrace_tpu_torch.ops.vec3 import V3
    from raytrace_tpu_torch.tools import ellipsoid_scenes

    first = wavefront.object_table(r.scene, r.batch_times_dev[0])
    drifted = next(table for table in (
        wavefront.object_table(r.scene, torch.tensor(
            t, dtype=torch.float32, device=dev))
        for t in np.random.default_rng(7).random(64))
        if not torch.equal(table, first))
    rows = int((drifted != first).any(dim=1).sum())
    n, same, hits = r.static.num_spheres, True, 0
    for k, table in enumerate((first, drifted)):
        tk = tree._replace(rows=table[tree.ids.long()].contiguous())
        for j, dist in enumerate(((1.0, 20.0), (1000.0, 2000.0))):
            o, d = ellipsoid_scenes.grazing_rays(
                table.cpu(), n, GRAZING_RAYS // 2, 61 + 2 * k + j, dist=dist)
            ov, dv = (V3(*(torch.tensor(np.ascontiguousarray(a[:, i]),
                                        device=dev) for i in range(3)))
                      for a in (o, d))
            on = torch.ones(len(o), dtype=torch.bool, device=dev)
            hit, want = h2(ov, dv, on, table, tk), dense(ov, dv, on, table)
            same &= all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                        for x, y in zip(hit, want))
            hits += int((hit.sph >= 0).sum())
    print(f"H2 through the once-built tree on {GRAZING_RAYS} grazing rays "
          f"(near and 1,000-2,000 away) at batch 0's rows and {GRAZING_RAYS}"
          f" at a time whose rows differ from them in {rows} rows: bit for "
          f"bit with the dense entry point {same}, {hits} hits ({card})")
    if not same:
        raise AssertionError("H2's once-built tree loses a hit at a later "
                             "time's rows")
    return rows


def _ellipsoid_paths(ell_json, dev, card):
    """fow-ellipsoids (tools/ellipsoid_scenes.py) on the wavefront with H2
    (the dense prefix, then the tree over the ellipsoids' world boxes):
    H2 bit for bit with the dense plain sweep on the primary rays and on
    every bounce's rays of a batch, timed there beside its dense entry
    point, its work counted on BVH_SUBSET of bounces 0 and 1 for the
    bound (and the dense sweep's); the tree's build; the Renderer with
    defaults over every batch (Mrays/s, the image checks).  Returns a
    dict for the kernels line."""
    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import (bvh, megakernel, sphere_obj,
                                        sphere_sweep, spheres, tri_sweep)
    from raytrace_tpu_torch.ops.intersect import T_MAX

    t_phase = time.perf_counter()
    cs_e = cli.load_scene(ell_json, WIDTH, HEIGHT)
    r = Renderer(cs_e, device=dev)
    if (r.path != "wavefront" or r.static.sphere_world_mode
            or r.static.num_spheres != 488 or r._obj_tree is None):
        raise AssertionError(f"fow-ellipsoids: path {r.path}, world mode "
                             f"{r.static.sphere_world_mode}, tree "
                             f"{r._obj_tree is not None}")
    geom, seen = smoke_lib.capture_bounces(r)
    table, tree = geom.sph_obj16, geom.sph_obj_tree
    S = r.static.num_spheres

    def h2(o, d, a, tab=table, walk=tree):
        return sphere_obj.intersect_spheres_object(o, d, tab, a, walk)

    def dense(o, d, a, tab=table):
        return sphere_obj.intersect_spheres_object_dense(o, d, tab, a)

    same, plain_ms, err = True, 0.0, 0.0
    for i, (o, d, a) in enumerate(seen):
        hit = h2(o, d, a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = spheres.intersect_spheres(o, d, table)
        torch.cuda.synchronize()
        if i == 0:
            plain_ms = (time.perf_counter() - t0) * 1e3
        want = (torch.where(a, plain.t, T_MAX), torch.where(a, plain.sph, -1))
        same &= all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                    for x, y in zip(hit, want))
        err = max(err, float((hit.t - want[0]).abs().max()))
    o, d, alive = seen[0]
    n_rays = o.x.shape[0]
    print(f"H2 on fow-ellipsoids ({table.shape[0]} table rows, {S} spheres: "
          f"{tree.n_prefix} swept densely, a tree over {tree.num_spheres} "
          f"in leaves of {tree.leaf}, depth {tree.depth}, {tree.staged} "
          f"node rows staged): bit for bit with the dense plain sweep on "
          f"the {n_rays} primary rays and every bounce's of batch 0 "
          f"({len(seen)} launches) {same} ({card})")
    if not same:
        raise AssertionError("H2 disagrees with the dense plain sweep")
    ms, per_bounce = smoke_lib.bounce_ms(h2, seen)
    dense_ms, dense_bounce = smoke_lib.bounce_ms(dense, seen)
    build_ms = median_ms(lambda: sphere_obj.build_object_tree(
        table, S, tree.n_prefix, tree.ids, static=True), 5)
    gen = torch.Generator().manual_seed(3)
    active = [int(a.sum()) for _, _, a in seen]
    R_all = sum(x.x.shape[0] for x, _, _ in seen)

    def walk_bound(k, act, rays, launches):
        per, w = smoke_lib.sphere_obj_work(*seen[k], h2, tree, BVH_SUBSET,
                                           gen)
        flops = act * ((per["prefix_tests"] + per["sphere_tests"])
                       * FLOPS_PER_OBJ_SPHERE_TEST
                       + per["node_tests"] * 2 * FLOPS_PER_SPHERE_BOX)
        nbytes = (rays * (6 * 4 + 1 + 2 * 4) + launches * (
            tree.n_prefix * 64 + w["nodes_read"] * 64
            + w["spheres_read"] * (64 + 4)))
        return least_ms(flops, nbytes), per

    def dense_bound(act, rays, launches):
        return least_ms(act * S * FLOPS_PER_OBJ_SPHERE_TEST,
                        rays * (6 * 4 + 1 + 2 * 4) + launches * S * 64)

    bound, per0 = walk_bound(0, active[0], n_rays, 1)
    later, per1 = walk_bound(1, sum(active[1:]), R_all - n_rays,
                             len(seen) - 1)
    batch_bound = (bound[0] + later[0], later[1])
    d_bound = dense_bound(active[0], n_rays, 1)
    d_batch = dense_bound(sum(active), R_all, len(seen))
    batch_ms = sum(per_bounce)
    drift = _h2_drift(r, tree, h2, dense, dev, card)
    print(f"H2 ms per bounce of batch 0 ({len(seen)} launches, "
          f"{sum(active)} active rays of {R_all}): "
          + ", ".join(f"{x:.3f}" for x in per_bounce) + f"; its dense "
          f"entry point's: " + ", ".join(f"{x:.3f}" for x in dense_bounce)
          + f" ({card})")
    print(f"H2 on fow-ellipsoids: {batch_ms:.3f} ms a batch against the "
          f"dense entry point's {sum(dense_bounce):.3f}, the primary rays' "
          f"launch {ms:.4f} ms against {dense_ms:.4f} (medians, CUDA "
          f"events), plain PyTorch (dense) {plain_ms:.1f} ms (one run, "
          f"host clock); the tree's build {build_ms:.3f} ms; work a ray on "
          f"the primary rays {per0['prefix_tests']:.0f} prefix tests, "
          f"{per0['node_tests']:.2f} nodes and {per0['sphere_tests']:.2f} "
          f"sphere tests, on bounce 1's {per1['node_tests']:.2f} and "
          f"{per1['sphere_tests']:.2f}; bound from that work "
          f"{bound[0]:.4f} ms by {bound[1]} ({bound[0] / ms:.4f} of it), "
          f"{batch_bound[0]:.4f} ms a batch ({batch_bound[0] / batch_ms:.4f}"
          f"); from the dense sweep's work {d_bound[0]:.4f} and "
          f"{d_batch[0]:.4f} ms; the dense kernel's figures "
          f"{H2_BEFORE} ({card})")
    del geom, seen, o, d, alive, hit, plain, want

    _reset_counts()
    per_batch = _step(r, MAIN_BATCHES)
    rays0, sec0 = r.stats.rays_traced, r.stats.render_seconds
    r.render_all()
    launches = sphere_obj.LAUNCHES
    if (launches <= 0 or sphere_sweep.LAUNCHES or megakernel.LAUNCHES
            or tri_sweep.LAUNCHES or bvh.LAUNCHES):
        raise AssertionError(f"fow-ellipsoids did not run on H2 alone (H2 "
                             f"{launches}, K1 {sphere_sweep.LAUNCHES}, K4 "
                             f"{megakernel.LAUNCHES})")
    all_rays = r.stats.rays_traced - rays0
    all_s = r.stats.render_seconds - sec0
    mrays = _mrays(per_batch[1:])
    print(f"fow-ellipsoids (wavefront, spheres in object space): "
          f"{WIDTH}x{HEIGHT}, 4 spp x {r.current_batch} batches, depth 50: "
          f"{mrays:.3f} Mrays/s over batches 1-{MAIN_BATCHES - 1} stepped, "
          f"{all_rays / all_s / 1e6:.3f} over the other "
          f"{r.current_batch - MAIN_BATCHES} in render_all ({all_s:.3f} s); "
          f"sphere_obj LAUNCHES={launches}, sphere_sweep, megakernel, "
          f"tri_sweep and bvh LAUNCHES=0 ({card})")
    _check_image(r.image(), "fow-ellipsoids")
    print(f"phase ellipsoids: {time.perf_counter() - t_phase:.1f} s")
    return dict(ms=ms, plain_ms=plain_ms, bound=bound, batch_ms=batch_ms,
                batch_bound=batch_bound, err=err, launches=launches,
                mrays=mrays, dense_ms=dense_ms,
                dense_batch_ms=sum(dense_bounce), dense_bound=d_bound,
                dense_batch_bound=d_batch, build_ms=build_ms,
                drift_rows=drift)


def _registry_paths(dev, card):
    """fow-registry (tools/registry_scenes.py: final-one-weekend with every
    metal's fuzz a checker, which the fat shading row cannot encode) with
    defaults: the wavefront with registry shading and K1, two batches
    stepped (K1's launches counted from 0, K4's none), Mrays/s, the image
    checks; then a 48x27 frame of it on the card against the CPU.
    Returns a dict for the kernels line."""
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.models import compile_scene
    from raytrace_tpu_torch.ops import (bvh, megakernel, paged_tri,
                                        sphere_obj, sphere_sweep, tri_sweep)
    from raytrace_tpu_torch.scene_file import SceneFile
    from raytrace_tpu_torch.tools import registry_scenes

    t0 = time.perf_counter()
    cs_r = compile_scene(SceneFile.from_json_dict(
        registry_scenes.fow_registry_doc()), width=WIDTH, height=HEIGHT)
    compile_s = time.perf_counter() - t0
    if cs_r.shade_rows is not None or cs_r.num_spheres != 488:
        raise AssertionError("fow-registry: fat rows, or not 488 spheres")
    _reset_counts()
    r = Renderer(cs_r, device=dev)
    if r.path != "wavefront" or r.use_megakernel:
        raise AssertionError(f"fow-registry took the {r.path} path")
    per_batch = _step(r, REGISTRY_BATCHES)
    launches = sphere_sweep.LAUNCHES
    if launches <= 0 or (megakernel.LAUNCHES or tri_sweep.LAUNCHES
                         or paged_tri.LAUNCHES or bvh.LAUNCHES
                         or sphere_obj.LAUNCHES):
        raise AssertionError(f"fow-registry did not run on K1 alone (K1 "
                             f"{launches}, K4 {megakernel.LAUNCHES})")
    print(f"fow-registry (wavefront, registry shading): {WIDTH}x{HEIGHT}, 4 "
          f"spp, depth 50, {REGISTRY_BATCHES} batches stepped: "
          + ", ".join(f"{rays / s / 1e6:.3f}" for rays, s in per_batch)
          + f" Mrays/s ({[rays for rays, _ in per_batch]} rays, "
          f"{[round(s, 4) for _, s in per_batch]} s); compile "
          f"{compile_s:.2f} s; sphere_sweep LAUNCHES={launches}, "
          f"megakernel, tri_sweep, paged_tri, bvh and sphere_obj "
          f"LAUNCHES=0 ({card})")
    _check_image(r.image(), "fow-registry")
    mrays = _mrays(per_batch[1:])
    del r
    small = _scene(cs_r, 48, 27, batches=2)
    g = Renderer(small, device=dev)
    c = Renderer(small, device="cpu")
    g_img, c_img = g.render_all(), c.render_all()
    g_rays, c_rays = g.stats.rays_traced, c.stats.rays_traced
    mdiff = np.abs(g_img.mean(axis=(0, 1)) - c_img.mean(axis=(0, 1))).max()
    rmse = float(np.sqrt(np.mean((g_img - c_img) ** 2)))
    if g.path != c.path or mdiff > 1e-2 or abs(g_rays - c_rays) > (
            0.02 * c_rays):
        raise AssertionError(f"fow-registry card vs CPU at 48x27: paths "
                             f"{g.path}/{c.path}, mean diff {mdiff}, rays "
                             f"{g_rays} vs {c_rays}")
    print(f"fow-registry {g.path} card vs CPU at 48x27, depth 50, 2 "
          f"batches: max channel-mean diff {mdiff:.3g}, RMSE {rmse:.3g}, "
          f"rays {g_rays} vs {c_rays} ({card})")
    return dict(launches=launches, mrays=mrays)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _multichip_paths(cs, dev, card):
    """The sharded renderer (parallel/multichip.py) on the one card: K4's
    row-range launch (a middle band of final-one-weekend's rows, half its
    samples) bit for bit with its plain version and timed, its bound from
    the band's own work (_band_work); world size 1
    over NCCL at 1200x675, a stepped batch and a 12-batch chunk on the
    fused path byte-identical with the Renderer's; then two ranks sharing
    the card over gloo (smoke_lib.multichip_rank): sp=2 and px=2 on the
    fused path at 240x135 (K4 with a row range and spp_local 2) and sc=2
    on the wavefront at 120x68 (K1 over each rank's slice), each held to
    the single-device render.  Returns a dict for the kernels line."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import megakernel
    from raytrace_tpu_torch.parallel import MultiChipRenderer

    # K4's row and sample ranges, bit for bit with the plain version.
    r = Renderer(cs, device=dev)
    geom = r._geometry(0)
    row_base, rows, spp_local, base = ROW_RANGE
    args = (r.static, r.scene, geom, r.camera, 0, 1, base)
    kw = dict(use_dof=r.use_dof, times=r.batch_times_dev,
              spp_local=spp_local, row_base=row_base, rows=rows)
    sums, traced = megakernel.render_tile_mega(*args, **kw)
    t0 = time.perf_counter()
    ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(sums, ref) and torch.equal(traced, ref_traced)
    err = float((sums - ref).abs().max())
    range_traced = int(traced.sum())
    ms = median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    band = _band_work(cs, geom, dev)
    bound, _ = _cluster_bound(geom, band, range_traced, WIDTH, rows, 0)
    print(f"K4 row range: rows {row_base}..{row_base + rows - 1} of "
          f"{HEIGHT}, samples {base}..{base + spp_local - 1} of 4, "
          f"{WIDTH} wide, depth 50: bit for bit with its plain version "
          f"{same} (max abs err {err:.3g}), {range_traced} bounces; kernel "
          f"{ms:.3f} ms (median of 5, CUDA events), plain PyTorch "
          f"{plain_ms:.1f} ms (one run, host clock); the band's own work "
          f"a bounce: {_tree_work_text(band)}; bound {bound[0]:.4f} ms "
          f"by {bound[1]} ({bound[0] / ms:.4f} of it) ({card})")
    if not same:
        raise AssertionError("K4's row-range launch differs from its plain "
                             "version")
    del r, geom, sums, traced, ref, ref_traced

    # World size 1 over NCCL: the Renderer's bytes.
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        _reset_counts()
        m = MultiChipRenderer(cs, device=dev)
        one = Renderer(cs, device=dev)
        if m.path != "fused" or (m.layout.px, m.layout.sp,
                                 m.layout.sc) != (1, 1, 1):
            raise AssertionError(f"world size 1: path {m.path}, layout "
                                 f"{m.layout}")
        for k in (1, CHUNK_BATCHES):
            before = megakernel.LAUNCHES
            if m.render_batches(k) != k:
                raise AssertionError("the sharded renderer stopped short")
            if megakernel.LAUNCHES != before + 1:
                raise AssertionError(f"world size 1: {k} batches took "
                                     f"{megakernel.LAUNCHES - before} "
                                     f"launches")
            one.render_batches(k)
            if m.image().tobytes() != one.image().tobytes():
                raise AssertionError(f"world size 1 differs from the "
                                     f"Renderer after {m.current_batch} "
                                     f"batches")
        rays = torch.tensor([m.stats.rays_traced], device=dev)
        dist.all_reduce(rays)
        print(f"multichip world size 1 (NCCL, {dist.get_backend()}): "
              f"{WIDTH}x{HEIGHT}, a stepped batch and a {CHUNK_BATCHES}-"
              f"batch chunk, byte-identical with the Renderer; "
              f"{m.stats.mrays_per_sec:.3f} Mrays/s over "
              f"{m.current_batch} batches, {int(rays)} rays (an NCCL "
              f"all_reduce) ({card})")
        world1_mrays = m.stats.mrays_per_sec
        del m, one
    finally:
        dist.destroy_process_group()

    # Two ranks on the one card over gloo.
    fused_cs = _scene(cs, *TWO_RANK_FUSED, batches=TWO_RANK_BATCHES)
    wave_cs = _scene(cs, *TWO_RANK_WAVE, batches=TWO_RANK_BATCHES)
    jobs = [("sp2", fused_cs, dict(sp=2)), ("px2", fused_cs, dict(sp=1)),
            ("sc2", wave_cs, dict(sp=1, sc=2))]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'init')}"
        t0 = time.perf_counter()
        procs = [ctx.Process(target=smoke_lib.multichip_rank,
                             args=(rank, 2, init, jobs, results,
                                   str(dev)))
                 for rank in range(2)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in procs:
                rank, out, tb = results.get(timeout=TWO_RANK_SECONDS)
                if tb is not None:
                    raise AssertionError(f"rank {rank} failed:\n{tb}")
                got[rank] = out
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        spawn_s = time.perf_counter() - t0
    # The references step as the ranks do: a first batch, then the rest.
    fused_ref = Renderer(fused_cs, device=dev)
    fused_ref.render_next_batch()
    fused_img = fused_ref.render_all()
    wave_ref = Renderer(wave_cs, device=dev, use_megakernel=False)
    wave_ref.render_next_batch()
    wave_img = wave_ref.render_all()
    out = {}
    for name, _, _ in jobs:
        a, b = got[0][name], got[1][name]
        if a["img"].tobytes() != b["img"].tobytes():
            raise AssertionError(f"two ranks, {name}: the ranks' images "
                                 f"differ")
        ref = wave_img if name == "sc2" else fused_img
        ref_r = wave_ref if name == "sc2" else fused_ref
        diff = float(np.abs(a["img"] - ref).max())
        exact = a["img"].tobytes() == ref.tobytes()
        kernel = "k1" if name == "sc2" else "k4"
        if (not exact if name != "sp2" else diff > TWO_RANK_SP_ATOL) or (
                a["rays"] != ref_r.stats.rays_traced
                or min(a[kernel], b[kernel]) <= 0):
            raise AssertionError(f"two ranks, {name}: max diff {diff}, rays "
                                 f"{a['rays']} vs {ref_r.stats.rays_traced}, "
                                 f"launches {a[kernel]}/{b[kernel]}")
        per_batch = [x["collective_s"] / x["batches"] for x in (a, b)]
        share = [x["collective_s"] / x["render_s"] for x in (a, b)]
        print(f"two ranks on one card (gloo), {name} {a['path']} layout "
              f"(px, sp, sc) {a['layout']}, rows {[x['rows'] for x in (a, b)]}"
              f", samples {[x['samples'] for x in (a, b)]}: "
              f"{'byte-identical with' if exact else f'max diff {diff:.3g} against'}"
              f" the single-device render, rays {a['rays']}; "
              f"{'K1' if name == 'sc2' else 'K4'} launches {a[kernel]} and "
              f"{b[kernel]}; collectives {per_batch[0] * 1e3:.2f} and "
              f"{per_batch[1] * 1e3:.2f} ms a batch over the "
              f"{a['batches']} batches after the first, {share[0]:.4f} and "
              f"{share[1]:.4f} of the ranks' render time there (the first "
              f"batch: collectives {a['warm_collective_s'] * 1e3:.2f} and "
              f"{b['warm_collective_s'] * 1e3:.2f} ms of "
              f"{a['warm_render_s'] * 1e3:.2f} and "
              f"{b['warm_render_s'] * 1e3:.2f} ms) ({card})")
        out[name] = dict(launches=a[kernel] + b[kernel],
                         collective_ms=max(per_batch) * 1e3,
                         share=max(share), diff=diff)
    print(f"two ranks on one card: {spawn_s:.1f} s for both processes, "
          f"start-up and imports included ({card})")
    return dict(range_ms=ms, range_plain_ms=plain_ms, range_bound=bound,
                range_err=err, world1_mrays=world1_mrays, two_rank=out)


# The app-layer phase: final-one-weekend's full batches, K4's runtime
# depth on one batch, its waits for the viewer and its spawned trace.
APP_BATCHES = 25
APP_DEPTH = 8
APP_WAIT_S = 60
APP_RESIZE = (600, 338)


def _http_get(port: int, path: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=APP_WAIT_S) as r:
        return r.read()


def _viewer_wait(port: int, pred, what: str) -> dict:
    """The viewer's /status once ``pred`` holds, polled for at most
    APP_WAIT_S seconds."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < APP_WAIT_S:
        st = json.loads(_http_get(port, "/status"))
        if pred(st):
            return st
        time.sleep(0.05)
    raise AssertionError(f"viewer: no {what} within {APP_WAIT_S} s: {st}")


def _viewer_png(port: int) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(_http_get(port, "/image.png"))))


def _app_paths(cs, mb_scene, dev, card):
    """10. The app layer on the card, at final-one-weekend's full 1200x675,
    4 spp x 25, depth 50, its files in a temporary directory (never
    assets/): (a) the CLI with --preview-every 1 and --debug, its PNG
    byte-equal to a Renderer stepped 25 times, every step checked, K4
    launched 25 times; (b) render_all(progress) with metrics_jsonl, a line
    a batch adding up to the rays traced; (c) the runtime max_depth on K4,
    bit for bit with its plain version at that depth (and the dense form,
    _hold_dense), through the Renderer too; (d) the viewer over HTTP:
    refinement, a bad hot-swap kept out, the motion-blur twin swapped in
    (fused_anim), a resize restarting accumulation, the finished image
    byte-equal to a Renderer's render_all; (e) gen-final-one-weekend and
    one fused batch of the generated scene; (f) a batch under
    utils/profiling.trace in a process of its own, its Chrome trace
    naming K4's kernel.  Returns the phase's numbers."""
    import multiprocessing as mp

    import torch

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.ops import megakernel
    from raytrace_tpu_torch.utils.image import to_srgb_u8
    from raytrace_tpu_torch.viewer import Viewer

    t_phase = time.perf_counter()
    out = {}
    if (cs.render.width, cs.render.height, cs.render.sample_batches,
            cs.render.max_ray_depth) != (WIDTH, HEIGHT, APP_BATCHES, 50):
        raise AssertionError("app phase: final-one-weekend's settings "
                             "changed")
    logger = logging.getLogger("raytrace_tpu_torch")
    with tempfile.TemporaryDirectory() as tmp:
        # (a) The CLI, a batch at a time, the PNG after each, validated.
        png = os.path.join(tmp, "preview.png")
        capture = _Capture()
        logger.addHandler(capture)
        _reset_counts()
        t0 = time.perf_counter()
        try:
            rc = cli.main(["render", "--path", cli.DEFAULT_SCENE,
                           "--width", str(WIDTH), "--height", str(HEIGHT),
                           "--preview-every", "1", "--debug", "-o", png])
        finally:
            logger.removeHandler(capture)
        cli_s = time.perf_counter() - t0
        launches = megakernel.LAUNCHES
        if rc != 0:
            raise AssertionError(f"app cli: exit {rc}")
        if launches != APP_BATCHES:
            raise AssertionError(f"app cli: K4 launched {launches} times, "
                                 f"not {APP_BATCHES}")
        valid = [m for m in capture.lines if m.startswith("debug: batch ")]
        summary = [m for m in capture.lines
                   if m.startswith(f"debug: {APP_BATCHES} checks, ")]
        if len(valid) != APP_BATCHES or len(summary) != 1:
            raise AssertionError(f"app cli: {len(valid)} validated steps, "
                                 f"summary {summary}")
        words = summary[0].split()
        checks, nonf, neg = int(words[1]), int(words[3]), int(words[5])
        max_rad, bound = float(words[9]), float(words[12])
        if (checks, nonf, neg) != (APP_BATCHES, 0, 0) or max_rad > bound:
            raise AssertionError(f"app cli: debug stats {summary[0]}")
        stepped = Renderer(cs, device=dev)
        for _ in range(APP_BATCHES):
            stepped.render_next_batch()
        stepped_png = os.path.join(tmp, "stepped.png")
        stepped.save_png(stepped_png)
        with open(png, "rb") as f, open(stepped_png, "rb") as g:
            if f.read() != g.read():
                raise AssertionError("app cli: --preview-every 1's PNG is "
                                     "not the stepped Renderer's")
        print(f"app (a): cli render --preview-every 1 --debug: rc 0, K4 "
              f"{launches} launches, {checks} checks, 0 non-finite, 0 "
              f"negative, max radiance {max_rad} of bound {bound}; PNG "
              f"byte-equal to 25 stepped batches; {cli_s:.2f} s ({card})")
        out["a_s"] = time.perf_counter() - t_phase

        # (b) render_all with progress and metrics.
        t0 = time.perf_counter()
        jsonl = os.path.join(tmp, "metrics.jsonl")
        calls = []
        r = Renderer(cs, device=dev, metrics_jsonl=jsonl)
        img = r.render_all(progress=lambda b, total: calls.append(b))
        with open(jsonl) as f:
            lines = [json.loads(line) for line in f]
        expect = list(range(r.chunk_size(), APP_BATCHES, r.chunk_size()))
        if (len(lines) != APP_BATCHES
                or sum(x["rays"] for x in lines) != r.stats.rays_traced
                or calls != expect + [APP_BATCHES]):
            raise AssertionError(f"app render_all: {len(lines)} lines, rays "
                                 f"{sum(x['rays'] for x in lines)} vs "
                                 f"{r.stats.rays_traced}, progress {calls}")
        _check_image(img, "app render_all", WIDTH, HEIGHT)
        out["mrays"] = r.metrics.mrays_per_sec
        print(f"app (b): render_all: {len(lines)} JSONL lines, rays "
              f"{r.stats.rays_traced} as traced, progress at {calls}, "
              f"{out['mrays']:.1f} Mrays/s ({card})")
        del r, stepped
        out["b_s"] = time.perf_counter() - t0

        # (c) The runtime depth on K4, held to its plain version.
        t0 = time.perf_counter()
        r = Renderer(cs, device=dev)
        r.max_depth = APP_DEPTH
        args = (r.static, r.scene, r._geometry(0), r.camera, 0, 1)
        kw = dict(use_dof=r.use_dof, times=r.batch_times_dev,
                  max_depth=APP_DEPTH)
        _reset_counts()
        sums, traced = megakernel.render_tile_mega(*args, **kw)
        launched = megakernel.LAUNCHES
        ref, ref_traced = megakernel.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        bitwise = torch.equal(sums, ref) and torch.equal(traced, ref_traced)
        most = int(traced.max())
        spp = r.static.sqrt_spp ** 2
        if launched != 1 or not bitwise or most > APP_DEPTH * spp:
            raise AssertionError(f"app max_depth {APP_DEPTH}: launched "
                                 f"{launched}, bit for bit {bitwise}, most "
                                 f"bounces a pixel {most}")
        _hold_dense(f"final-one-weekend at max_depth {APP_DEPTH}", args, kw,
                    ref, ref_traced, card)
        r.render_next_batch()
        if not torch.equal(r.accum, ref / float(np.float32(spp))):
            raise AssertionError("app max_depth: the Renderer's batch is not "
                                 "the plain version's mean")
        out["depth_rays"] = int(traced.sum())
        print(f"app (c): K4 at max_depth {APP_DEPTH}: bit for bit with the "
              f"plain version, {out['depth_rays']} rays, at most {most} "
              f"bounces a pixel ({spp} samples); the Renderer's batch the "
              f"same ({card})")
        del r, sums, traced, ref, ref_traced
        out["c_s"] = time.perf_counter() - t0

        # (d) The viewer over HTTP.
        t0 = time.perf_counter()
        v = Viewer(cli.DEFAULT_SCENE, WIDTH, HEIGHT, port=0, device=dev)
        v.start()
        try:
            port = v.port
            _viewer_wait(port, lambda s: s["batch"] >= 1, "first batch")
            first = _viewer_png(port)
            if first.shape != (HEIGHT, WIDTH, 3):
                raise AssertionError(f"viewer: image {first.shape}")
            gen0 = json.loads(_http_get(port, "/status"))["generation"]
            _http_get(port, "/reload?path=" + os.path.join(tmp, "no.json"))
            st = _viewer_wait(port, lambda s: s["error"] is not None,
                              "error from the bad reload")
            if st["generation"] != gen0 or v.state.render_error:
                raise AssertionError(f"viewer: the bad reload was not kept "
                                     f"out: {st}")
            _http_get(port, f"/reload?path={mb_scene}")
            st = _viewer_wait(port, lambda s: s["generation"] > gen0,
                              "motion-blur swap")
            if v.state.renderer.path != "fused_anim" or st["error"]:
                raise AssertionError(f"viewer: the twin took "
                                     f"{v.state.renderer.path}: {st}")
            gen1 = st["generation"]
            _http_get(port, "/resize?width={}&height={}".format(*APP_RESIZE))
            st = _viewer_wait(port, lambda s: s["generation"] > gen1
                              and s["width"] == APP_RESIZE[0], "resize")
            st = _viewer_wait(port, lambda s: s["batch"] == s[
                "total_batches"], "the resized render's end")
            vr = v.state.renderer
            if vr.stats.batches_done != st["total_batches"]:
                raise AssertionError("viewer: the resize did not restart "
                                     "accumulation")
            final = _viewer_png(port)
            viewed = vr.compiled
            if v.state.render_error or not v._render_thread.is_alive():
                raise AssertionError(f"viewer: render thread failed: "
                                     f"{v.state.render_error}")
        finally:
            v.stop()
        want = to_srgb_u8(Renderer(viewed, device=dev).render_all())
        if not np.array_equal(final, want):
            raise AssertionError("viewer: the finished image is not the "
                                 "Renderer's render_all")
        print(f"app (d): viewer: {WIDTH}x{HEIGHT} refining, a bad reload "
              f"kept out, the motion-blur twin on fused_anim, resized to "
              f"{st['width']}x{st['height']} and restarted, its "
              f"{st['total_batches']} batches byte-equal to render_all "
              f"({card})")
        out["d_s"] = time.perf_counter() - t0

        # (e) The generator, and a batch of the generated scene.
        t0 = time.perf_counter()
        gen_dir = os.path.join(tmp, "gen")
        if cli.main(["gen-final-one-weekend", "--out-dir", gen_dir]) != 0:
            raise AssertionError("gen-final-one-weekend failed")
        gen_path = os.path.join(gen_dir, "final-one-weekend.json")
        with open(gen_path) as f, open(cli.DEFAULT_SCENE) as g:
            ours, shipped = json.load(f), json.load(g)
        moved = sum(next(iter(a.values())).get("center") != next(iter(
            b.values())).get("center") for a, b in zip(
            ours["primitives"], shipped["primitives"]))
        r = Renderer(cli.load_scene(gen_path, WIDTH, HEIGHT), device=dev)
        if r.path != "fused":
            raise AssertionError(f"generated scene took {r.path}")
        r.render_next_batch()
        _check_image(r.image(), "app generated final-one-weekend", WIDTH,
                     HEIGHT)
        print(f"app (e): generated final-one-weekend "
              f"({len(ours['primitives'])} primitives, {moved} centres "
              f"other than assets/'s): a fused batch ({card})")
        del r
        out["e_s"] = time.perf_counter() - t0

        # (f) A batch under the profiler, in a process of its own.
        t0 = time.perf_counter()
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        proc = ctx.Process(target=smoke_lib.app_trace,
                           args=(cs, os.path.join(tmp, "trace"), results,
                                 str(dev)))
        proc.start()
        try:
            got, tb = results.get(timeout=APP_WAIT_S * 2)
        finally:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
        if tb is not None:
            raise AssertionError(f"app trace failed:\n{tb}")
        k4 = [n for n in got["kernels"] if "megakernel" in n]
        if not k4 or got["launches"] != 1:
            raise AssertionError(f"app trace: no K4 kernel in "
                                 f"{got['kernels']}")
        print(f"app (f): profiling.trace of a {got['path']} batch: "
              f"{len(got['kernels'])} kernels traced, K4 as {k4[0][:80]}")
        out["f_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"app phase: {out['seconds']:.1f} s, (a)-(f) "
          + ", ".join(f"{out[k + '_s']:.1f}" for k in "abcdef")
          + f" s ({card})")
    return out


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


class _PhaseClock:
    """Prints each phase's host seconds when the next one starts
    (``phase(name)``; ``phase(None)`` ends the last) and the total."""

    def __init__(self):
        self.start = self.t = time.perf_counter()
        self.name = "1"

    def __call__(self, name):
        now = time.perf_counter()
        print(f"phase {self.name}: {now - self.t:.1f} s", flush=True)
        if name is None:
            print(f"phases 1-{self.name}: {now - self.start:.1f} s")
        self.name, self.t = name, now


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs one CUDA card", file=sys.stderr)
        return 1
    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.engine import Renderer
    from raytrace_tpu_torch.engine.renderer import RenderStats
    from raytrace_tpu_torch.engine.wavefront import primary_rays
    from raytrace_tpu_torch.models import compile_scene
    from raytrace_tpu_torch.ops import (megakernel, paged_tri, sphere_sweep,
                                        tri_sweep)
    from raytrace_tpu_torch.ops.vec3 import V3
    from raytrace_tpu_torch.scene_file import SceneFile
    from raytrace_tpu_torch.tools import (ellipsoid_scenes, image_scenes,
                                          light_scenes, noise_scenes,
                                          stress_scenes)

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
    ell_json = ellipsoid_scenes.write_fow_ellipsoids(tri_dir.name)
    phase = _PhaseClock()

    # -- 2. build the nine kernel sources, one nvcc each, started together --
    phase("2")
    smoke_lib.build_kernels()

    # -- 3. K1 vs plain at the main path's shapes ---------------------------
    phase("3")
    cs = cli.load_scene(cli.DEFAULT_SCENE, WIDTH, HEIGHT)
    rng = np.random.default_rng(0)
    k1 = smoke_lib.k1_checks(cs, dev, card, rng)
    to_v3 = lambda a: rows_to_v3(a, dev)  # noqa: E731

    # -- 3b. K2 vs plain at tri-stress's shapes ------------------------------
    phase("3b")
    tri_cs, tri_json = _tri_stress(TRI_K, TRI_WIDTH, tri_dir.name)
    if (tri_cs.render.width, tri_cs.render.height) != (TRI_WIDTH, TRI_HEIGHT):
        raise AssertionError("tri-stress's size changed")
    probe = Renderer(tri_cs, device=dev, use_megakernel=False)
    if (probe.static.num_triangles, probe.static.tri_cluster_g) != (
            TRI_K * TRI_K * 960, 128):
        raise AssertionError("tri-stress: unexpected soup "
                             f"{probe.static.num_triangles} / "
                             f"{probe.static.tri_cluster_g}")
    tri_geom = probe._geometry(0)
    table16, tree = tri_geom.tri_table16, tri_geom.tri_tree
    del tri_geom
    _, o, d = primary_rays(probe.static, probe.camera, 0, 0, TRI_HEIGHT,
                           probe.use_dof, dev)
    n_rays = o.x.shape[0]
    if n_rays != TRI_WIDTH * TRI_HEIGHT * 16:
        raise AssertionError(f"tri-stress primary rays: {n_rays}")
    alive = torch.ones(n_rays, dtype=torch.bool, device=dev)
    sel = torch.tensor(rng.choice(n_rays, TRI_SUBSET, replace=False),
                       device=dev)
    k2_err = _compare_tris(f"{TRI_SUBSET} primary", V3(*(c[sel] for c in o)),
                           V3(*(c[sel] for c in d)), table16, alive[sel],
                           tree)

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
        soup.tri_table16, r_alive, soup.tri_tree))

    k2_ms = median_ms(lambda: tri_sweep.intersect_tris_sweep(
        o, d, table16, alive, tree), 5)
    k2_dense_ms = median_ms(
        lambda: tri_sweep.intersect_tris_dense(o, d, table16, alive), 3)
    t0 = time.perf_counter()
    plain = tri_sweep.tri_sweep_reference(o, d, table16)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    # The walk on every primary ray, bit for bit with the plain version.
    k2_err = max(k2_err, _compare_tris(f"all {n_rays} primary", o, d,
                                       table16, alive, tree, ref=plain))
    t8 = table16.shape[0]
    # Rays in: origin, direction, alive; out: t, id, u, v; the table once.
    k2_dense_bound = least_ms(n_rays * t8 * FLOPS_PER_TRI_TEST,
                              n_rays * (6 * 4 + 1 + 4 * 4)
                              + table16.numel() * 4)
    # The walk's: the nodes and leaf triangles a walk proving each ray's
    # closest hit must test (paged_tri.tree_visit_counts on TREE_SUBSET of
    # the rays, scaled to all), the distinct rows those read once.
    sub = torch.arange(0, n_rays, n_rays // TREE_SUBSET,
                       device=dev)[:TREE_SUBSET]
    work = paged_tri.tree_visit_counts(
        *(V3(*(x[sub].contiguous() for x in v)) for v in (o, d)), tree,
        plain[0][sub].contiguous(), alive[sub].contiguous())
    k2_per = {k: work[k] / work["rays"] for k in ("node_tests", "tri_tests")}
    k2_bound = least_ms(
        n_rays * (k2_per["node_tests"] * FLOPS_PER_TREE_NODE
                  + k2_per["tri_tests"] * FLOPS_PER_TRI_TEST),
        n_rays * (6 * 4 + 1 + 4 * 4) + work["nodes_read"] * 64
        + work["tris_read"] * (48 + 4))
    print(f"triangle sweep time at R={n_rays} (tri-stress's primary rays), "
          f"T8={t8}: K2's walk {k2_ms:.3f} ms (median of 5), its dense "
          f"entry {k2_dense_ms:.3f} ms (median of 3), plain PyTorch "
          f"{k2_plain_ms:.3f} ms (one run); the walk's work a ray: "
          f"{k2_per['node_tests']:.2f} nodes, {k2_per['tri_tests']:.2f} "
          f"triangle tests; bound {k2_bound[0]:.4f} ms by {k2_bound[1]} "
          f"({k2_bound[0] / k2_ms:.4f} of it), the dense sweep's "
          f"{k2_dense_bound[0]:.4f} ms by {k2_dense_bound[1]} "
          f"({k2_dense_bound[0] / k2_dense_ms:.3f} of the dense entry) "
          f"({card})")
    del probe, soup, table16, tree, o, d, alive, sel, plain, sub

    # -- 3c. the dev probes P1-P3 -------------------------------------------
    phase("3c")
    probe_entries, raygen_b1 = smoke_lib.dev_probes(dev, card)

    # -- 4. K4 vs plain -----------------------------------------------------
    phase("4")
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
    k4_ms = median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    k4_plain_ms = median_ms(
        lambda: megakernel.megakernel_reference(*args, **kw), 2)
    k4_dense_ms = _dense_ms(args, kw)
    dense_bound = _k4_bound(full.static, args[2], k4_rays, WIDTH, HEIGHT, 0)
    _, _, per_ray, lengths, fow_k1 = _cluster_work(
        "final-one-weekend", Renderer(cs, device=dev, use_megakernel=False),
        args[2], card)
    _print_k1_launch("final-one-weekend", fow_k1, card)
    k4_bound, k4_flat = _cluster_bound(args[2], per_ray, k4_rays, WIDTH,
                                       HEIGHT, 0)
    fow = _warp_models("final-one-weekend", lengths, card)
    fow["measured"] = _measured_busy("final-one-weekend", args, kw, fow,
                                     card)
    lanes_busy = {"final-one-weekend": fow}
    print(f"fused kernel (clustered static form) time at {WIDTH}x{HEIGHT}, 4 "
          f"spp, depth 50, one batch: kernel {k4_ms:.3f} ms (median of 5), "
          f"the dense form {k4_dense_ms:.3f} ms (median of 5), plain "
          f"PyTorch {k4_plain_ms:.3f} ms (median of 2) (CUDA events); work "
          f"counted on {CLUSTER_SUBSET} of the wavefront's rays, a bounce: "
          f"{_tree_work_text(per_ray)}; bound {k4_bound[0]:.4f} ms by "
          f"{k4_bound[1]} ({k4_bound[0] / k4_ms:.4f} of it), the flat "
          f"walk's {k4_flat[0]:.4f} ms, the dense sweep's "
          f"{dense_bound[0]:.4f} ms by {dense_bound[1]} ({card})")
    print(f"raygen's share of K4's final-one-weekend batch: P3 base at "
          f"{WIDTH}x{HEIGHT}x4 cells, one iteration, {raygen_b1['ms']:.4f} "
          f"ms ({raygen_b1['ns_per_raygen']:.4f} ns a pixel-sample) against "
          f"K4's "
          f"{k4_ms:.3f} ms: {raygen_b1['ms'] / k4_ms:.4f} ({card})")
    del full, args, kw

    # -- 4b. K4's animated form vs plain, on the motion-blur scene ----------
    phase("4b")
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
    anim_ms = median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    anim_plain_ms = median_ms(
        lambda: megakernel.megakernel_reference(*args, **kw), 2)
    anim_dense_ms = _dense_ms(args, kw)
    n_times = len(mb_full.batch_times)
    dense_bound = _k4_bound(mb_full.static, args[2], anim_rays, MB_WIDTH,
                            MB_HEIGHT, n_times)
    _, _, per_ray, lengths, mb_k1 = _cluster_work(
        "motion-blur", Renderer(cs_mb, device=dev, use_megakernel=False),
        args[2], card, mb_full.batch_times_dev)
    _print_k1_launch("motion-blur", mb_k1, card)
    lanes_busy["motion-blur"] = _warp_models("motion-blur", lengths, card)
    anim_bound, anim_flat = _cluster_bound(args[2], per_ray, anim_rays,
                                           MB_WIDTH, MB_HEIGHT, n_times)
    print(f"animated fused kernel (clustered) time at {MB_WIDTH}x"
          f"{MB_HEIGHT}, 4 spp, depth 50, one batch: kernel {anim_ms:.3f} ms "
          f"(median of 5), the dense form {anim_dense_ms:.3f} ms (median of "
          f"5), plain PyTorch {anim_plain_ms:.3f} ms (median of 2) (CUDA "
          f"events); work a bounce: {_tree_work_text(per_ray)}; bound "
          f"{anim_bound[0]:.4f} ms by {anim_bound[1]} "
          f"({anim_bound[0] / anim_ms:.4f} of it), the flat walk's "
          f"{anim_flat[0]:.4f} ms, the dense sweep's "
          f"{dense_bound[0]:.4f} ms by {dense_bound[1]} ({card})")
    del mb_small, mb_full, args, kw

    # -- 4c. K4's triangle form vs plain, on tri-stress and the fixture -----
    phase("4c")
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
    tris_ms = median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    tris_plain_ms = tris_plain_s * 1e3
    sums, _ = megakernel.render_tile_mega(*args, **kw)
    # The image as the Renderer folds it (sums / spp per pixel); its mean
    # on the host, as the wavefront image's (a float32 mean of the sums on
    # the card rounds by ~1e-3 at this size).
    fused_img = (sums / tri_full.static.sqrt_spp ** 2).cpu().numpy()
    # The same batch on the wavefront with K2 and K1, counting the work
    # of the kernel's bound on its rays.
    wave_img, wave_rays, work, lengths = _tri_work(
        "tri-stress-15360", Renderer(tri_cs, device=dev,
                                     use_megakernel=False), card)
    lanes_busy["tri-stress"] = _warp_models("tri-stress-15360", lengths,
                                            card)
    mdiff = np.abs(fused_img.mean(axis=(0, 1))
                   - wave_img.mean(axis=(0, 1))).max()
    print(f"fused (triangle form) vs wavefront with K2 on tri-stress-15360's "
          f"batch at {TRI_WIDTH}x{TRI_HEIGHT}, 16 spp, depth 50: rays "
          f"{tris_rays} vs {wave_rays}, max channel-mean diff {mdiff:.3g} "
          f"({card})")
    if abs(tris_rays - wave_rays) > 0.005 * wave_rays or mdiff > 2e-3:
        raise AssertionError("tri-stress: the fused and wavefront renders "
                             "disagree")
    tris_bound, tris_flat = _k4_tris_bound(args[0], args[2], work,
                                           TRI_WIDTH, TRI_HEIGHT)
    tris_leaf = args[2].tri_tree.leaf
    per = max(work["rays"], 1)
    print(f"fused kernel (triangle form) time at {TRI_WIDTH}x{TRI_HEIGHT}, "
          f"16 spp, depth 50, one batch: kernel {tris_ms:.3f} ms (median of "
          f"5, CUDA events), plain PyTorch {tris_plain_ms:.1f} ms (one run, "
          f"host clock); work counted on the wavefront's rays: "
          f"{work['rays']} bounces; the tree (depth "
          f"{args[2].tri_tree.depth}, leaves of {tris_leaf}): "
          f"{work['node_tests'] / per:.1f} node and "
          f"{work['tree_tri_tests'] / per:.1f} triangle tests a bounce "
          f"against the closest hit (on {TREE_SUBSET} rays a bounce); the "
          f"flat walk: {work['pretests']} cluster pretests, "
          f"{work['tri_tests']} triangle tests in clusters that pass against "
          f"the sphere hit ({work['tri_tests'] / per:.1f} a bounce, of "
          f"{TRI_K * TRI_K * 960}); bound (an estimate) "
          f"{tris_bound[0]:.4f} ms by {tris_bound[1]} "
          f"({tris_bound[0] / tris_ms:.4f} of it), the flat walk's "
          f"{tris_flat[0]:.4f} ms by {tris_flat[1]} ({card})")
    del tri_full, args, kw, sums

    # -- 4d. K4's lit forms vs plain, on the light scenes --------------------
    phase("4d")
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
        lit_ms = median_ms(
            lambda: megakernel.render_tile_mega(*args, **kw), 5)
        sums, _ = megakernel.render_tile_mega(*args, **kw)
        fused_img = (sums / r.static.sqrt_spp ** 2).cpu().numpy()
        # The same batch on the wavefront with K2 (and K1 for the spheres),
        # counting the work of the kernel's bound on its rays.
        t0 = time.perf_counter()
        wave_img, wave_rays, work, lengths = _tri_work(
            name, Renderer(light_cs[name], device=dev,
                           use_megakernel=False), card)
        wave_s = time.perf_counter() - t0
        mdiff = np.abs(fused_img.mean(axis=(0, 1))
                       - wave_img.mean(axis=(0, 1))).max()
        bound, flat = _k4_tris_bound(r.static, args[2], work, w, h,
                                     scene=r.scene)
        lanes_busy[name] = _warp_models(name, lengths, card)
        lanes_busy[name]["measured"] = _measured_busy(
            name, args, kw, lanes_busy[name], card)
        print(f"fused (lit form) vs wavefront with K2 on {name}'s batch at "
              f"{w}x{h}, 64 spp, depth 50: rays {lit_rays} vs {wave_rays}, "
              f"max channel-mean diff {mdiff:.3g}; the wavefront's batch "
              f"with the work count, then the Renderer's own, {wave_s:.2f} "
              f"s ({card})")
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
              f"{work['samples']} samples, "
              f"{work['node_tests'] / max(work['rays'], 1):.1f} node and "
              f"{work['tree_tri_tests'] / max(work['rays'], 1):.1f} "
              f"triangle tests a bounce in the tree, the flat walk's "
              f"{work['pretests']} cluster pretests and {work['tri_tests']} "
              f"triangle tests, {work['rays'] - work['samples']} NEE steps, "
              f"{work['noise_hits']} noise hits; bound (an "
              f"estimate) {bound[0]:.4f} ms by {bound[1]} "
              f"({bound[0] / lit_ms:.4f} of it), the flat walk's "
              f"{flat[0]:.4f} ms ({card})")
        light_full[name] = dict(ms=lit_ms, plain_ms=plain_s * 1e3,
                                bound=bound, flat_bound=flat,
                                leaf=args[2].tri_tree.leaf)
        del r, args, kw, sums

    # -- 4e. K4's noise forms vs plain, and perlin-spheres' full batch -------
    phase("4e")
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
    noise_ms = median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    sums, _ = megakernel.render_tile_mega(*args, **kw)
    perlin_fused_img = (sums / pr.samples_per_pixel).cpu().numpy()
    work = _plain_work(args, kw)
    if work["rays"] != noise_rays:
        raise AssertionError("perlin-spheres: the counted rays differ")
    lanes_busy["perlin-spheres"] = _warp_models(
        "perlin-spheres", work["lengths"], card)
    lanes_busy["perlin-spheres"]["measured"] = _measured_busy(
        "perlin-spheres", args, kw, lanes_busy["perlin-spheres"], card)
    if (lanes_busy["perlin-spheres"]["measured"]["noise_lanes"]
            != work["noise_hits"]):
        raise AssertionError("perlin-spheres: the measuring build's "
                             "turbulences differ from the noise hits")
    noise_bound = _noise_bound(perlin_full.static, args[2], work,
                               *PERLIN_SIZE)
    chain_bound = _noise_bound(perlin_full.static, args[2], work,
                               *PERLIN_SIZE,
                               per_turbulence=(FLOPS_PER_TURBULENCE_CHAIN, 0))
    print(f"fused kernel (noise form) time on perlin-spheres at 1024x576, 16 "
          f"spp, depth 50, one batch: kernel {noise_ms:.3f} ms (median of 5, "
          f"CUDA events), plain PyTorch {noise_plain_s * 1e3:.1f} ms (one "
          f"run, host clock), {noise_rays / noise_ms / 1e3:.1f} Mrays/s in "
          f"the kernel; work counted on the plain version's rays: "
          f"{work['rays']} bounces, {work['noise_hits']} noise hits "
          f"({work['noise_hits'] / work['rays']:.4f} a bounce); bound (an "
          f"estimate) {noise_bound[0]:.4f} ms by {noise_bound[1]} "
          f"({noise_bound[0] / noise_ms:.4f} of it), a turbulence "
          f"{OPS_PER_TURBULENCE} operations and "
          f"{SHARED_BYTES_PER_TURBULENCE} bytes of shared-memory loads; on "
          f"the turbulence without tables ({FLOPS_PER_TURBULENCE_CHAIN} "
          f"operations) {chain_bound[0]:.4f} ms by {chain_bound[1]} "
          f"({chain_bound[0] / noise_ms:.4f} of it); sphere-light-962's "
          f"batch (the lit noise form, phase 4d) "
          f"{light_full['sphere-light-962']['ms']:.3f} ms ({card})")
    del perlin_full, args, kw, sums

    # -- 4e'. Every noise form on frames with partial warps -----------------
    phase("4e'")
    # Each noise form's small doc at an odd width, so that the frame's last
    # warp has lanes past the image, at depth 1 (lanes whose pixel is done
    # while others still trace) and 50, bit for bit.  A doc in clusters
    # also holds its dense form (_compare_fused).
    warp_png = image_scenes.texel_id_png(
        os.path.join(tri_dir.name, "warp.png"), 640, 320)
    with open(mb_scene) as f:
        warp_docs = smoke_lib.noise_form_docs(json.load(f), warp_png)
    for form, (doc, _, _) in warp_docs.items():
        for depth in smoke_lib.PARTIAL_WARP_DEPTHS:
            warp_cs = compile_scene(SceneFile.from_json_dict(doc),
                                    width=smoke_lib.PARTIAL_WARP_WIDTH)
            r = Renderer(_scene(warp_cs, warp_cs.render.width,
                                warp_cs.render.height, depth, 1), device=dev)
            n_pix = r.static.width * r.static.height
            if not r.static.flags.has_noise or n_pix % 32 == 0:
                raise AssertionError(f"partial warp {form}: no noise form "
                                     f"or no partial warp")
            before = megakernel.NOISE_LAUNCHES
            warp_err, *_ = _compare_fused(
                f"noise {form} partial warps {r.static.width}x"
                f"{r.static.height} ({n_pix % 32} lanes of the last warp in "
                f"the image) depth {depth} k=1 ({r.path})", r, 1, 0.0, None,
                card, bitwise_required=True)
            if megakernel.NOISE_LAUNCHES != before + 2:
                raise AssertionError(f"partial warp {form}: the noise form "
                                     f"was not launched")
            noise_err = max(noise_err, warp_err)

    # -- 4g. K4's image forms vs plain, and earth's full batch ---------------
    phase("4g")
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
    image_ms = median_ms(lambda: megakernel.render_tile_mega(*args, **kw), 5)
    sums, _ = megakernel.render_tile_mega(*args, **kw)
    earth_fused_img = (sums / er.samples_per_pixel).cpu().numpy()
    work = _plain_work(args, kw)
    if work["rays"] != image_rays:
        raise AssertionError("earth: the counted rays differ")
    lanes_busy["earth"] = _warp_models("earth", work["lengths"], card)
    lanes_busy["earth"]["measured"] = _measured_busy(
        "earth", args, kw, lanes_busy["earth"], card)
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
    # render_all's first chunk of earth (batches 0-11, one launch), bit for
    # bit with the plain version, timed, and its bound from its own work.
    err_chunk, args, kw, chunk_rays, chunk_plain_s = _compare_fused(
        f"earth 512x512 4 spp depth 50 k={CHUNK_BATCHES}", earth_full,
        CHUNK_BATCHES, 0.0, None, card, bitwise_required=True)
    image_err = max(image_err, err_chunk)
    image_chunk_ms = median_ms(
        lambda: megakernel.render_tile_mega(*args, **kw), 5)
    work = _plain_work(args, kw)
    if work["rays"] != chunk_rays:
        raise AssertionError("earth's chunk: the counted rays differ")
    image_chunk_bound = _image_bound(earth_full.static, earth_full.scene,
                                     args[2], work, *EARTH_SIZE)
    print(f"fused kernel (image form) time on earth's chunk of "
          f"{CHUNK_BATCHES} batches (render_all's first launch): kernel "
          f"{image_chunk_ms:.3f} ms (median of 5, CUDA events), "
          f"{image_chunk_ms / CHUNK_BATCHES:.4f} ms a batch against the "
          f"batch's {image_ms:.4f}; plain PyTorch {chunk_plain_s:.2f} s; "
          f"{work['rays']} bounces, {work['image_hits']} image hits; bound "
          f"(an estimate) {image_chunk_bound[0]:.5f} ms by "
          f"{image_chunk_bound[1]} ({image_chunk_bound[0] / image_chunk_ms:.4f}"
          f" of it) ({card})")
    del earth_full, args, kw, sums

    # -- 4h. K4's clustered sphere forms vs plain, and the stress scenes ----
    phase("4h")
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
        if (not r.use_megakernel or r._geometry(0).sph_tree is None
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
            small_ms = median_ms(
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
        stress_ms = median_ms(
            lambda: megakernel.render_tile_mega(*args, **kw), 5)
        sums, _ = megakernel.render_tile_mega(*args, **kw)
        fused_img = (sums / rs.samples_per_pixel).cpu().numpy()
        t0 = time.perf_counter()
        wave_img, wave_rays, per_ray, lengths, wave_k1 = _cluster_work(
            name, Renderer(stress_cs[name], device=dev,
                           use_megakernel=False), args[2], card)
        _print_k1_launch(name, wave_k1, card)
        lanes_busy[name] = _warp_models(name, lengths, card)
        wave_s = time.perf_counter() - t0
        mdiff = np.abs(fused_img.mean(axis=(0, 1))
                       - wave_img.mean(axis=(0, 1))).max()
        print(f"fused (clustered) vs wavefront with K1 on {name}'s batch: "
              f"rays {rays} vs {wave_rays}, max channel-mean diff "
              f"{mdiff:.3g}; the wavefront's batch with the work count, "
              f"then the Renderer's own, {wave_s:.2f} s ({card})")
        if abs(rays - wave_rays) > 0.005 * wave_rays or mdiff > 2e-3:
            raise AssertionError(f"{name}: the fused and wavefront renders "
                                 f"disagree")
        bound, flat = _cluster_bound(args[2], per_ray, rays, *STRESS_SIZE,
                                     0)
        dense_bound = _k4_bound(r.static, args[2], rays, *STRESS_SIZE, 0)
        dense = (f"the dense form {_dense_ms(args, kw):.3f} ms (median of "
                 f"5), " if r.static.num_spheres <= megakernel.MAX_SPHERES
                 else "")
        print(f"fused kernel (clustered) time on {name} at {STRESS_SIZE[0]}x"
              f"{STRESS_SIZE[1]}, 4 spp, depth 50, one batch: kernel "
              f"{stress_ms:.3f} ms (median of 5, CUDA events), {dense}plain "
              f"PyTorch {plain_s * 1e3:.1f} ms (one run, host clock), "
              f"{rays / stress_ms / 1e3:.1f} Mrays/s in the kernel, the "
              f"wavefront (the Renderer's own batch) "
              f"{wave_rays / wave_k1['batch_s'] / 1e6:.3f} Mrays/s; work a "
              f"bounce: "
              f"{_tree_work_text(per_ray)} (of {r.static.num_spheres} "
              f"spheres); bound {bound[0]:.4f} ms by {bound[1]} "
              f"({bound[0] / stress_ms:.4f} of it), the flat walk's "
              f"{flat[0]:.4f} ms, the dense sweep's "
              f"{dense_bound[0]:.4f} ms ({card})")
        stress[name] = dict(ms=stress_ms, plain_ms=plain_s * 1e3,
                            bound=bound, flat_bound=flat, k1=wave_k1)
        del args, kw, sums

    # -- 4f. K3 vs plain and K2, at small size and on the 2M-triangle mesh ---
    phase("4f")
    for T, R in ((40000, 1 << 16), (3001, 1 << 14), (5, 2048)):
        tree, table16, ro, rd, r_alive = _paged_random(T, R, T, dev)
        _compare_paged(f"random T={T}", ro, rd, tree, table16, r_alive)
    del tree, table16, ro, rd, r_alive
    t0 = time.perf_counter()
    cs_mesh = cli.load_scene(cli.DEFAULT_SCENE, WIDTH, HEIGHT,
                             analytic_spheres=False)
    mesh_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_r = Renderer(cs_mesh, device=dev)
    mesh_init_s = time.perf_counter() - t0
    geom = mesh_r._geometry(0)
    tree_ms = median_ms(lambda: paged_tri.build_tri_tree(
        geom.world_p, cs_mesh.num_triangles, geom.tri_table12), 5)
    print(f"final-one-weekend --mesh-geometry: {cs_mesh.num_triangles} "
          f"triangles, {cs_mesh.num_spheres} spheres, compiled in "
          f"{mesh_compile_s:.2f} s; Renderer (paged order, upload, tree) "
          f"{mesh_init_s:.2f} s; path {mesh_r.path}, bvh_mode "
          f"{mesh_r.static.bvh_mode}; a tree of depth {geom.tri_tree.depth} "
          f"over leaves of {geom.tri_tree.leaf}, built on the card in "
          f"{tree_ms:.3f} ms (median of 5, CUDA events) ({card})")
    if (cs_mesh.num_triangles != MESH_TRIANGLES or cs_mesh.num_spheres
            or mesh_r.path != "wavefront"
            or mesh_r.static.bvh_mode != "paged"):
        raise AssertionError("the mesh scene did not take the paged "
                             "wavefront")
    del geom
    k3 = _k3_full(mesh_r, card)

    # -- 5. the wavefront path ----------------------------------------------
    phase("5")
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
    tiny_ell = _scene(cli.load_scene(ell_json, WIDTH, HEIGHT), 48, 27,
                      depth=8, batches=1)
    for name, small_cs, fused, *bvh_opt in (
                                  ("final-one-weekend", tiny, False),
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
                                   None),
                                  ("big spheres --mesh-geometry", tiny_mesh,
                                   None, True),
                                  ("fow-ellipsoids", tiny_ell, None)):
        use_bvh = bvh_opt[0] if bvh_opt else "auto"
        gpu_s = Renderer(small_cs, device=dev, use_megakernel=fused,
                         use_bvh=use_bvh)
        cpu_s = Renderer(small_cs, device="cpu", use_megakernel=fused,
                         use_bvh=use_bvh)
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
    phase("6")
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

    k3_launches, paged_mrays = _mesh_paths(mesh_r, mb_scene, fused_img,
                                           wave_img, dev, card)
    del mesh_r

    # The wavefront's last two closest-hit branches: use_bvh=True on the
    # mesh (the SAH BVH, H1) and its motion-blur twin, and the ellipsoids
    # of fow-ellipsoids in object space (H2).
    sah = _sah_paths(cs_mesh, mb_scene, paged_mrays, dev, card)
    ell = _ellipsoid_paths(ell_json, dev, card)

    # Registry shading (fow-registry on the wavefront) and the sharded
    # renderer on the one card.
    reg = _registry_paths(dev, card)
    multi = _multichip_paths(cs, dev, card)

    # -- 7. checkpoint round trips, same chunk boundaries --------------------
    phase("7")
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
        phase("8")
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
    phase("9")
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
                        "paged_tri" if paged else "megakernel",
                        {label for label, *_ in runs})
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

    # -- 10. the app layer: CLI, metrics, runtime depth, viewer, trace -----
    phase("10")
    _app_paths(cs, mb_scene, dev, card)

    phase(None)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print("K4's lanes busy by configuration (the two warp models; measured "
          "by the measuring build where given): " + json.dumps(lanes_busy))
    cornell_busy = lanes_busy["cornell-style"]
    # No single PyTorch call computes a closest-hit sweep or a whole path
    # tracer, so library_ms is null for each kernel.
    print(json.dumps({"kernels": [{
        "name": "sphere_sweep", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/sphere_sweep.cu",
        "replaces": "raytrace_tpu/ops/pallas_sweep.py:33",
        "launches": sweep_launches, "max_abs_err": k1["err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound"][0], "bound_by": k1["bound"][1],
        "library_ms": None, "dense_ms": k1["dense_ms"],
        # fow-registry's stepped batches (registry shading, the wavefront):
        # K1's launches there, Mrays/s past the first batch.
        "registry_launches": reg["launches"],
        "registry_mrays": reg["mrays"],
        "dense_bound_ms": k1["dense_bound"][0],
        "stress16k_wave_launches": stress["stress-16k"]["k1"]["launches"],
        "stress16k_wave_ms": stress["stress-16k"]["k1"]["ms"],
        "stress16k_wave_dense_ms": stress["stress-16k"]["k1"]["dense_ms"],
    }, {
        "name": "megakernel", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms,
        "plain_ms": k4_plain_ms, "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1], "library_ms": None,
        "flat_bound_ms": k4_flat[0],
    }, {
        "name": "megakernel_anim", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": anim_launches, "max_abs_err": anim_err, "ms": anim_ms,
        "plain_ms": anim_plain_ms, "bound_ms": anim_bound[0],
        "bound_by": anim_bound[1], "library_ms": None,
        "flat_bound_ms": anim_flat[0],
    }, {
        # K4's launch over a band of final-one-weekend's rows and half its
        # samples (ROW_RANGE), as a rank of the sharded renderer launches
        # it, its bound from the band's own work; launches: the two-rank
        # phase's sp=2 and px=2 renders, both ranks.  The collectives' host
        # time a batch and its share of the ranks' render time, after each
        # render's warm-up batch, the most over the three two-rank renders.
        "name": "megakernel_row_range", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": (multi["two_rank"]["sp2"]["launches"]
                     + multi["two_rank"]["px2"]["launches"]),
        "max_abs_err": multi["range_err"], "ms": multi["range_ms"],
        "plain_ms": multi["range_plain_ms"],
        "bound_ms": multi["range_bound"][0],
        "bound_by": multi["range_bound"][1], "library_ms": None,
        "collective_ms_a_batch": max(
            x["collective_ms"] for x in multi["two_rank"].values()),
        "collective_share": max(
            x["share"] for x in multi["two_rank"].values()),
        "world1_mrays": multi["world1_mrays"],
    }, {
        "name": "tri_sweep", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/tri_sweep.cu",
        "replaces": "raytrace_tpu/ops/pallas_tri_sweep.py:27",
        "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
        "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": None,
        "dense_ms": k2_dense_ms, "dense_bound_ms": k2_dense_bound[0],
    }, {
        "name": "megakernel_tris", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": tris_launches, "max_abs_err": tris_err, "ms": tris_ms,
        "plain_ms": tris_plain_ms, "bound_ms": tris_bound[0],
        "bound_by": tris_bound[1], "library_ms": None,
        "flat_bound_ms": tris_flat[0], "leaf": tris_leaf,
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
        "flat_bound_ms": light_full["cornell-style"]["flat_bound"][0],
        "leaf": light_full["cornell-style"]["leaf"],
        # The share of lanes busy: K4's own (the measuring build) and the
        # two warp models on the wavefront's path lengths of the batch.
        "warp_busy_share": cornell_busy["measured"]["busy"],
        "warp_busy_model_regen": cornell_busy["regen"],
        "warp_busy_model_per_sample": cornell_busy["per_sample"],
    }, {
        # perlin-spheres' full batch, the slice's main path.
        "name": "megakernel_noise", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": noise_launches, "max_abs_err": noise_err,
        "ms": noise_ms, "plain_ms": noise_plain_s * 1e3,
        "bound_ms": noise_bound[0], "bound_by": noise_bound[1],
        "library_ms": None,
        # The lit noise form on sphere-light-962's full batch (phase 4d),
        # the bound on the turbulence without the lattice tables, and the
        # measuring build's turbulences a warp step.
        "sphere_light_962_ms": light_full["sphere-light-962"]["ms"],
        "bound_ms_fp32_chain": chain_bound[0],
        "noise_lanes_a_step": lanes_busy["perlin-spheres"]["measured"][
            "noise_lanes_a_step"],
    }, {
        # earth's full batch, the slice's main path.
        "name": "megakernel_image", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": image_launches, "max_abs_err": image_err,
        "ms": image_ms, "plain_ms": image_plain_s * 1e3,
        "bound_ms": image_bound[0], "bound_by": image_bound[1],
        "library_ms": None,
        # render_all's first chunk (12 batches in one launch), and the
        # measuring build's phase cycles on the batch.
        "chunk_batches": CHUNK_BATCHES, "chunk_ms": image_chunk_ms,
        "chunk_plain_ms": chunk_plain_s * 1e3,
        "chunk_bound_ms": image_chunk_bound[0],
        "chunk_bound_by": image_chunk_bound[1],
        "phases": lanes_busy["earth"]["measured"]["phases"],
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
        "flat_bound_ms": stress["stress-4x"]["flat_bound"][0],
    }, {
        "name": "megakernel_stress_16k", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytrace_tpu/ops/megakernel.py:1666",
        "launches": stress["stress-16k"]["launches"],
        "max_abs_err": cluster_err, "ms": stress["stress-16k"]["ms"],
        "plain_ms": stress["stress-16k"]["plain_ms"],
        "bound_ms": stress["stress-16k"]["bound"][0],
        "bound_by": stress["stress-16k"]["bound"][1], "library_ms": None,
        "flat_bound_ms": stress["stress-16k"]["flat_bound"][0],
    }, {
        # final-one-weekend --mesh-geometry's primary rays, the main
        # path's, and its whole batch (every bounce's launch); the bounds
        # of the tree walk and of the flat page walk it replaced; the leaf.
        "name": "paged_tri", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/paged_tri.cu",
        "replaces": "raytrace_tpu/ops/pallas_paged_tri.py:185",
        "launches": k3_launches, "max_abs_err": 0.0, "ms": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound"][0],
        "bound_by": k3["bound"][1], "library_ms": None,
        "batch_ms": k3["batch_ms"], "batch_bound_ms": k3["batch_bound"][0],
        "flat_bound_ms": k3["flat_bound"][0],
        "batch_flat_bound_ms": k3["batch_flat_bound"][0], "leaf": k3["leaf"],
    }, {
        # use_bvh=True on final-one-weekend --mesh-geometry (the SAH tree
        # in four-wide rows): the primary rays' launch and the batch's
        # (every bounce's launch); the plain version timed on BVH_SUBSET
        # of the primary rays, as the kernel on those (subset_ms).  No TPU
        # kernel: the JAX package traces this tree with XLA while loops.
        "name": "bvh_walk", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/bvh_walk.cu",
        "replaces": "raytrace_tpu/ops/bvh.py:191",
        "tpu_kernel": False,
        "launches": sah["launches"], "max_abs_err": sah["err"],
        "ms": sah["ms"], "plain_ms": sah["plain_ms"],
        "plain_rays": BVH_SUBSET, "subset_ms": sah["sub_ms"],
        "bound_ms": sah["bound"][0], "bound_by": sah["bound"][1],
        "library_ms": None, "batch_ms": sah["batch_ms"],
        "batch_bound_ms": sah["batch_bound"][0],
        # bound_ms takes the binary walk's work, the least that proves
        # the hits; the bound from the wide walk's own work (four box
        # tests a step) and from the dense sweep's; the wide and the
        # binary walk's node steps a primary ray; the implicit tree's
        # launch and batch; the collapse's host seconds.
        "wide_work_bound_ms": sah["wide_bound"][0],
        "wide_work_batch_bound_ms": sah["wide_batch_bound"],
        "dense_bound_ms": sah["dense_bound"][0],
        "wide_node_steps": sah["work"][0][0],
        "binary_node_steps": sah["steps"][0],
        "implicit_ms": sah["implicit"]["ms"],
        "implicit_batch_ms": sah["implicit"]["batch_ms"],
        "implicit_bound_ms": sah["implicit"]["bound"][0],
        "collapse_s": sah["wide_s"],
    }, {
        # fow-ellipsoids' primary rays and its batch.  No TPU kernel: the
        # JAX package traces this sweep with XLA.
        "name": "sphere_obj", "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/sphere_obj.cu",
        "replaces": "raytrace_tpu/ops/spheres.py:40",
        "tpu_kernel": False,
        "launches": ell["launches"], "max_abs_err": ell["err"],
        "ms": ell["ms"], "plain_ms": ell["plain_ms"],
        "bound_ms": ell["bound"][0], "bound_by": ell["bound"][1],
        "library_ms": None, "batch_ms": ell["batch_ms"],
        "batch_bound_ms": ell["batch_bound"][0],
        # The kept dense entry point, the bound from the dense sweep's
        # work, and the tree's build on the card.
        "dense_ms": ell["dense_ms"], "dense_batch_ms": ell["dense_batch_ms"],
        "dense_bound_ms": ell["dense_bound"][0],
        "tree_build_ms": ell["build_ms"],
    }, *probe_entries]}))
    tri_dir.cleanup()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
