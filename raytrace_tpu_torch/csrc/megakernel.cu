// The whole path-tracing loop in one kernel: raygen, sphere and triangle
// closest hit, fat-row shading (constant, checker, noise and image textures),
// next-event estimation (with or without lights) and per-pixel sums.
//
// Replaces the TPU kernel raytrace_tpu/ops/megakernel.py::_mega_kernel
// (launched by mega_dispatch) in its spheres-in-world-space, direct-normal
// configuration without image textures: static, with the spheres moving on
// straight lines (its anim_lerp form), or with a world-space triangle soup
// (its triangle sweeps, _sweep :1486-1536 and _sweep_tri_gather), each
// without lights, and the static and triangle forms also with lights (its
// light slice, _sample_lights_kernel :1542, _o2w_cols_kernel :1602 and the
// MIS branch :1970-1991); each of these also with noise textures (its
// scatter_and_emit_v3 call :1953, which reaches shading._eval_slot_v3 and
// perlin.turbulence_v3); and the static, triangle and lit forms also with
// image textures (the same call, which reaches textures.sample_image_nearest
// at the UV of reconstruct_hit's world-to-object branch); and each of these
// with its spheres in Morton clusters (its gather sweep: _sweep :1389,
// _sweep_sieve :1005, _cluster_rounds_gather :550).  It computes
// what the torch wavefront (engine/wavefront.py) computes, ray for ray: the
// same PCG stream per (pixel, sample), the same camera and shading
// arithmetic in the same operation order, the same closest hit (strict <
// over ascending sphere ids, T_MIN/T_MAX), and the same termination (miss,
// absorption, or max_depth bounces).
//
// Design: one thread owns one pixel and traces its K = n_batches *
// spp_local samples in sample order (sample s_all belongs to batch batch0 +
// s_all / spp_local) in one loop of steps: each step is one bounce of the
// thread's sample in flight, and a sample that ends (a miss, absorption or
// max_depth bounces) adds its radiance to the pixel's sums and hands the
// thread's next step to the next sample's raygen.  This is the TPU kernel's
// sample regeneration (megakernel.py:1671-1689, "regenerating a fresh
// camera ray the moment a sample terminates") without its lane-assignment
// machinery, since every (pixel, sample) has its own RNG stream and a
// pixel's samples are summed in sample order: the sums and bounce counts
// are those of sample-by-sample tracing, bit for bit.  A warp's 32 lanes
// therefore trace different samples at different depths in one step, and
// a lane idles only once its pixel has no sample left, where a loop over
// samples around a loop over bounces kept every lane of the warp waiting,
// sample by sample, for the warp's longest path.  A step's phases run
// one after another, each behind its own branch: the raygen of lanes whose
// sample starts, the closest hit, the shading of hits (a miss adds the
// sky), the NEE of scattering hits, the flush of ending samples.  In the
// compiled code (cuobjdump -sass of the lit triangle form) each branch is
// a region closed by a reconvergence barrier (BSSY/BSYNC; the flush's few
// instructions are predicated instead), so the warp
// reconverges after each phase and takes the step's one back-edge
// together; a lane with no sample left waits at the barrier after the
// loop.  The thread writes its pixel's radiance
// sums and bounce count once, at the end: no atomics, so two launches give
// the same bytes.
//
// The sphere table [S8, 8] and the camera/sky parameters are staged into
// shared memory once, before any loop; the only __syncthreads() sits
// there, because threads of a block run different numbers of bounces.
//
// Motion (template parameter kAnim, so the static kernel's inner loop is
// compiled without it): the table holds each sphere at shutter time 0 and
// a second table [S8, 8] its motion, dc = c1 - c0 in columns 0:3, k1 =
// 2 c0.dc in 4 and k2 = |dc|^2 in 5 (ops/spheres.world_sphere_anim_tables).
// A sample of batch b runs at time t = times[b]: the sweep tests the
// sphere at c0 + t * dc with k0 + t * (k1 + t * k2), and the hit's normal
// uses the centre moved the same way (fat-row slots 49:52 hold dc).  Each
// sphere is staged as three float4 (48 B): (c0, r), (k0, k1, k2, -),
// (dc, -), so 4096 spheres take 192 KiB of shared memory.
// Every thread of a bounce reads the same sphere at the same time (a
// broadcast).  The fat rows are read per hit from global memory through
// the read-only cache: columns 0:24 (material) and 44:48 (world centre and
// radius).
//
// Triangles (template parameter kTris; not combined with kAnim, as in the
// JAX kernel): after the sphere sweep, a thread walks the soup's tree with
// csrc/tri_tree.cuh's walk, the one K3 runs: nearest first, over leaves of
// 2 triangles (a soup of at most 40 is one leaf: ops/paged_tri.soup_leaf,
// chosen on the card), seeded with the sphere sweep's best (t, id).  The soup keeps
// its compiled order (models/sphere_order.apply_triangle_order), whose
// groups are not spatial inside, so the tree is built over a Morton order
// of the soup's world centroids (ops/paged_tri.py build_soup_tree): a
// permuted copy of the [t8, 12] rows, 48 bytes a triangle as three float4
// (v0, valid), (e1, -), (e2, -), an int32 slot -> triangle id table and
// the node rows, all read through the read-only cache from global memory
// (at 16,384 triangles 768 KiB of rows and 512 KiB of nodes, which stay in
// L2).  A triangle's primitive id is s_pad + ids[slot], above every
// sphere's, and the walk keeps the lexicographic minimum of (t, id): a
// sphere keeps an equal-t hit (it was swept first in the dense order), and
// among triangles the lowest id wins, so the result is the dense sweep's
// (ops/tri_sweep.py) behind the spheres', bit for bit, in any order of the
// walk.  The hit point is captured in the walk as v0 + u e1 + v e2 and the
// normal is the barycentric lerp of the fat row's n0, n1 - n0, n2 - n0
// (slots 49:58), as engine/wavefront.py reconstruct_hit computes them.
// It replaces the JAX kernel's flat sweep over 128-triangle clusters in
// ascending id (its pretest, megakernel.py:1262-1280, and
// _sweep_tri_gather), under which a warp runs the union of its threads'
// passing clusters, 128 triangles each.
// The stack holds one entry a level: 13 for the 8,192 leaves of the
// gate's 16,384 triangles (ops/megakernel.py MAX_TRI_DEPTH).
//
// Lights (template parameter kLights; not combined with kAnim: the JAX
// renderer never fuses animation with lights, renderer.py:468-472): after a
// scattering hit the thread picks a light triangle with the alias table
// (two draws; one index, u1 * n, into a [n_lights, 16] table of 64-byte rows
// holding p0 p1 p2, the probability and the alias, read through the
// read-only cache: 962 lights are 61 KB, which stay in L1/L2), moves its
// three points by the objectToWorld of the instance that was HIT (fat-row
// slot 48 names it; its [12] row of the [I, 12] table is read from global
// memory, so any number of instances is taken: the JAX kernel's 64-instance
// cap is its SMEM budget), samples a point on it (two draws and the fold),
// draws the 50/50 mixture choice and both direction samples, and weighs the
// material pdf by the mixture's (ops/nee.py, engine/wavefront.py _bounce).
// Metal and dielectric hits consume the same nine draws and then take their
// own direction.  The JAX kernel's select loop over the light table and its
// light_gather (for more than 16 lights) are TPU mechanisms: one indexed
// load serves any number of lights here.
//
// Noise (template parameter kNoise, instantiated with each of the five forms
// above, so their code is compiled without it): a hit reads one property
// slot, the albedo of a lambertian or metal, or a front-facing light's
// emission, through the row's checker when its mode says so.  Where that
// slot is in noise mode the thread computes the turbulence at the hit point
// (ops/perlin.py turbulence_v3: 7 octaves of classic Perlin noise, each
// eight hashed lattice corners) and the marble 0.5 (1 + sin(aux p.z + 10
// turb)) on all three channels; elsewhere it computes none.  The plain
// version evaluates every slot of every ray and selects, but noise draws no
// random number and a dielectric reads no albedo, so the values taken are
// the same.  Perlin's operations run in ops/perlin.py's order: floorf, the
// floor-mod of torch.remainder (x - floorf(x): the same bits on the
// gradient's arguments), the fade t*t*t*(t*(t*6-15)+10) left to right, the
// corners in cnoise_v3's order, and the accurate sinf.  The lattice
// tables: where an octave's lattice coordinates are below 2^24 the hash
// chain is exact integer arithmetic on floats and takes few values, so each
// block builds at its start, with the same device functions, the permutes
// of [-1, 577] and each corner's scaled gradient by the argument of its
// last permute (579 float4 rows: gradient(permute(x))) in shared memory,
// 11.6 KB, and a corner reads them there: a turbulence is ~950 operations
// and 98 shared loads (42 permutes, 56 gradients) in place of ~3,200
// operations and 112 fmodf calls.  An octave whose lattice coordinates
// reach 2^24 computes them as before, so every point keeps its bits.  The
// octaves stay with the lane that needs them: dealing a warp's octaves over
// its 32 lanes (warp-wide rounds, shuffles) was measured slower on both
// noise scenes (PERF.md §6), since the table forms wait on the
// shared-memory pipe, whose work follows the loads, not the lanes.
//
// Images (template parameter kImage, instantiated with each form but the
// animated one, with and without kNoise, so the forms without images are
// compiled as before): the fat rows of a sphere hold its world-to-object
// matrix at the batch's time (slots 32:44) and its object-space centre and
// radius (44:48), so the normal is engine/wavefront.py reconstruct_hit's
// world-to-object branch: the hit point moved to object space, (p_obj - c) /
// r, taken to world space by the transposed matrix (the matrix read once,
// the object normal kept for the UV).  Where the slot a hit reads is in
// image mode (after the checker, as for noise), the thread computes the UV
// right after the hit's reconstruction, before the hit's draws: a sphere's
// from its unit object normal, v = acosf(-n.y) / pi and u = atan2f(n.z,
// -n.x) / 2 pi floor-mod 1, a triangle's as the barycentric lerp of uv0,
// uv1 - uv0, uv2 - uv0 in fat-row slots 58:64; then the texel of
// sample_image_nearest, floor((u floor-mod 1) * w) clamped to [0, w - 1] (and
// the same in v; the floor-mod as x - floorf(x), which gives every float
// the texel of torch.remainder's fmodf), read as one 32-bit word (r | g <<
// 8 | b << 16) through the read-only cache from the packed atlas
// (engine/arrays.pack_atlas: the images padded to the largest, row stride
// its width).  The draws and the material's scatter do not depend on it,
// so the read of an atlas larger than L2 (earth's 5400x2700 words are 58
// MB) is in flight across them; each byte is decoded where the shading
// takes the texel, by the 256-entry sRGB table staged in shared memory
// after the other tables.  The TPU kernel shades images as 1 and
// multiplies each sample by its primary hit's texel afterwards (its item
// mode and _texel_factor), which is exact
// only for one convex sphere seen from outside: this kernel samples the
// image at every hit, as the wavefront does.  An animated image scene
// renders with the static form, one launch per batch, because the
// world-to-object rows change with the batch's time.
//
// Spheres in clusters (template parameter kSphClusters, instantiated with
// each form above, so the dense forms are compiled as before): a scene whose
// compiler put its sphere block in Morton clusters (models/sphere_order.py:
// a dense prefix of n_prefix large spheres, then the rest in contiguous
// clusters) has the closest hit of the JAX kernel's gather sweep
// (megakernel.py _sweep :1389, _sweep_sieve :1005, _cluster_rounds_gather
// :550): the dense sweep's (t, id).  The prefix is swept densely; then the
// thread walks a binary tree over the other spheres with csrc/tri_tree.cuh's
// walk, the one K3 and the triangle forms run: nearest first, the nearer
// passing child taken and the other pushed (Aila and Laine), seeded with
// the prefix's best (t, id).  The tree (ops/sphere_tree.py
// build_sphere_tree) is built over a Morton order of the spheres' centres,
// since the compiler's clusters are Morton-ordered only as groups: a
// permuted copy of their [n, 8] rows (and motion rows), an int32 slot -> id
// table, and one 64-byte row an internal node, both children's boxes with
// each child's reach (the most |c| + |r| below it) and rounding
// coefficient (2^-19 over the least positive radius below it).  A child's
// box is widened for the ray by (|o| + reach)^2 coef: the f32 quadratic
// can report a grazing hit up to that far outside a sphere, and without
// the margin a ray from ~1,800 units away kept a hit that the dense sweep
// does not report (measured on the lit cluster doc); at the camera of
// final-one-weekend it is ~0.008.  Reach and coef are maxima over a
// node's spheres, so a node's widened box holds every widened sphere box
// below it.  The boxes prune as the JAX kernel's pretest
// (megakernel.py:1262-1280).  At a leaf each sphere is tested with the
// dense sweep's arithmetic (sphere_t; the test and this walk are
// csrc/sphere_tree.cuh's, which the wavefront's K1 runs too), and a real
// hit replaces the best
// one when t < best_t, or t == best_t and id < best_id, the id read from
// the slot table only for a hit at or below the best t: the lexicographic
// minimum of (t, id) over a conservative walk and the prefix (whose ids are
// below every tree id), which is the dense sweep's winner, bit for bit, in
// any order of the walk.  The animated form's leaf boxes also hold each
// sphere at c0 + dc, so they hold it at every time in [0, 1].  The tree's
// top node rows (SphereTree.staged: the whole tree when it fits the cap,
// ops/sphere_tree.py STAGE_BYTES, else its top 2^k - 1 rows) are staged in
// shared memory, since every ray reads them and each step of the walk
// waits on its row; the other rows, the sphere rows (up to 16,384: 512
// KiB, 768 KiB with the motion rows) and the ids are read through the
// read-only cache, where a ray reads only what its walk reaches.  The
// sphere walk and the triangle walk run one after the other and share one
// stack (kStack entries, the deeper of the two trees).  It replaces a flat
// walk that slab-tested every cluster box (up to 128) in ascending id at
// every bounce.
//
// What bounds it: per bounce S ray-sphere tests of ~20 flops and a sqrt
// (for clustered spheres the prefix, then the node tests and the spheres
// of the leaves the walk reaches; for triangles the node tests and the
// triangles of the leaves), against one 112-byte row fetch: the
// fp32 ALU issue rate, times the share of a warp's lane slots that do a
// bounce.  With per-lane regeneration that share is the warp's total
// bounces over 32 x its busiest lane's, the tail of the pixel with the
// most bounces over its K samples; the measuring build below reads it.
// The tree walks add divergence (a warp's lanes walk different paths) and
// a dependent load a step.  A persistent work queue comes later.
//
// Bits: built with -fmad=false (ops/_build.py), so no multiply-add is
// contracted and each operation rounds as PyTorch's elementwise kernels
// do; sqrtf and division are IEEE (no fast math); sinf/cosf are the
// accurate library functions.  Where the torch code divides a tensor by a
// Python number (x / width, x / pi), PyTorch's CUDA division multiplies by
// the number's float reciprocal, and so does this kernel, so it follows
// the plain version on the card.  Every 0/0 guard of the torch code is
// kept.

#include <cuda_runtime.h>
#include <stdint.h>

// The raygen (PCG hash, get_ray, V3, the parameters' first slots).
#include "raygen.cuh"
// The triangle tree walk shared with K3.
#include "tri_tree.cuh"
// The sphere test and the sphere tree's walk shared with K1.
#include "sphere_tree.cuh"

namespace {

constexpr float kTMax = 10000.0f;  // ops/intersect.py T_MAX
constexpr int kThreads = 128;
constexpr int kRowWidth = 64;      // engine/wavefront.py prepare_batch rows
constexpr int kTriStack = 13;      // ops/megakernel.py MAX_TRI_DEPTH
constexpr int kSphStack = 14;      // ops/sphere_tree.py MAX_SPHERE_DEPTH
// The one stack of a step's two walks.
constexpr int kStack = kSphStack > kTriStack ? kSphStack : kTriStack;

// raytrace_tpu/models/compile.py MAT_TYPE_*; shading_table.py MODE_CHECKER.
constexpr int kLambertian = 1;
constexpr int kMetal = 2;
constexpr int kDielectric = 3;
constexpr int kDiffuseLight = 4;
constexpr float kModeChecker = 2.0f;
constexpr float kModeNoise = 3.0f;
constexpr float kModeImage = 1.0f;
constexpr int kLutSize = 256;  // the sRGB table's entries

// float32 roundings of the constants, as ops/rng.py and ops/nee.py hold them
// (pi / 2 and pi / 4 in raygen.cuh).
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);

// Launch flags (bit mask).
constexpr int kUseDof = 1;
constexpr int kHasChecker = 2;
constexpr int kHasEmissive = 4;
constexpr int kHasNoise = 8;
constexpr int kHasImage = 16;

// float4 per sphere in shared memory.
template <bool kAnim>
constexpr int kStride = kAnim ? 3 : 2;

// Float parameters, staged into shared memory (ops/megakernel.py
// _float_params builds the same layout; slots 0-37 in raygen.cuh).
constexpr int kLightCount = 38;  // f32(number of light triangles)
constexpr int kLightArea = 39;   // their total world-space area
constexpr int kNumParams = 40;
constexpr int kLightWidth = 16;  // floats per light row (light_table16)

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// ops/vec3.py reflect (GLSL reflect)
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  const float d = 2.0f * dot(i, n);
  return {i.x - d * n.x, i.y - d * n.y, i.z - d * n.z};
}

// ops/vec3.py refract (GLSL refract); 0 on total internal reflection
__device__ __forceinline__ V3 refract(V3 i, V3 n, float eta) {
  const float cos_i = -dot(i, n);
  const float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
  if (k < 0.0f) return {0.0f, 0.0f, 0.0f};
  const float coef = eta * cos_i - sqrtf(fmaxf(k, 0.0f));
  return {eta * i.x + coef * n.x, eta * i.y + coef * n.y, eta * i.z + coef * n.z};
}

// ---- ops/rng.py: samplers over raygen.cuh's PCG hash ----

__device__ __forceinline__ V3 random_unit(uint32_t& state) {
  const float u1 = random_float(state);
  const float u2 = random_float(state);
  const float z = 1.0f - 2.0f * u1;
  const float r = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  const float phi = kTwoPi * u2;
  return {r * cosf(phi), r * sinf(phi), z};
}

__device__ __forceinline__ V3 random_cosine(uint32_t& state) {
  const float r1 = random_float(state);
  const float r2 = random_float(state);
  const float phi = kTwoPi * r1;
  const float sq = sqrtf(r2);
  return {cosf(phi) * sq, sinf(phi) * sq, sqrtf(fmaxf(1.0f - r2, 0.0f))};
}

// ---- ops/textures.py checker_is_even and the fat-row property slots ----

__device__ __forceinline__ bool checker_is_even(float scale, V3 p) {
  const float inv = 1.0f / (scale == 0.0f ? 1.0f : scale);
  // int32 sum as in torch, wrapping; & 1 is the floor-mod parity.
  const uint32_t cells = static_cast<uint32_t>(static_cast<int>(floorf(inv * p.x))) +
                         static_cast<uint32_t>(static_cast<int>(floorf(inv * p.y))) +
                         static_cast<uint32_t>(static_cast<int>(floorf(inv * p.z)));
  return (cells & 1u) == 0u;
}

__device__ __forceinline__ V3 load3(const float* __restrict__ row, int c) {
  return {__ldg(row + c), __ldg(row + c + 1), __ldg(row + c + 2)};
}

// ops/vec3.py mat34_apply_point: M p + t, m a row-major 3x4
__device__ __forceinline__ V3 apply_point(const float (&m)[12], V3 p) {
  return {m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
          m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
          m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]};
}

// nee.make_onb_v3 about the normal, then the cosine sample in that basis
// (nee.gen_scatter_direction_v3's cosine direction)
__device__ __forceinline__ V3 cosine_direction(V3 normal, V3 cl) {
  const V3 axis2 = normalize(normal);
  const bool pick_y = fabsf(axis2.x) > 0.9f;
  const V3 up = pick_y ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  const V3 axis1 = normalize(cross(axis2, up));
  const V3 axis0 = cross(axis2, axis1);
  return {cl.x * axis0.x + cl.y * axis1.x + cl.z * axis2.x,
          cl.x * axis0.y + cl.y * axis1.y + cl.z * axis2.y,
          cl.x * axis0.z + cl.y * axis1.z + cl.z * axis2.z};
}

// shading._eval_property without noise: the constant slot, or the row's
// checker.
__device__ __forceinline__ V3 eval_property(const float* __restrict__ row, int base, int mode,
                                            bool has_checker, V3 p) {
  if (has_checker && __ldg(row + mode) == kModeChecker) {
    return checker_is_even(__ldg(row + 17), p) ? load3(row, 18) : load3(row, 21);
  }
  return load3(row, base);
}

// ---- ops/perlin.py: classic Perlin noise and turbulence ----

// float32 roundings of the Python constants, as PyTorch rounds a number
// that meets a float tensor.
constexpr float kInv289 = static_cast<float>(1.0 / 289.0);
constexpr float kInv7 = static_cast<float>(1.0 / 7.0);
constexpr float kTaylor0 = static_cast<float>(1.79284291400159);
constexpr float kTaylor1 = static_cast<float>(0.85373472095314);
constexpr float kNoiseGain = static_cast<float>(2.2);
constexpr int kOctaves = 7;
// The lattice tables.  Where a lattice coordinate floor(p) is below 2^24 in
// magnitude, the hash chain is exact integer arithmetic on floats: mod289
// gives integers in [-1, 289], every argument of permute lies in [-1, 577]
// and every hash in [0, 288] (tests/test_torch_noise_warp.py checks every
// such coordinate), so kTableRows permutes, and as many gradients indexed
// by the last permute's argument, hold every value the chain can produce
// there.
constexpr int kTableRows = 579;              // x in [-1, 577], at x + 1
constexpr float kTableLimit = 16777216.0f;  // 2^24

__device__ __forceinline__ float mod289(float x) { return x - floorf(x * kInv289) * 289.0f; }

__device__ __forceinline__ float permute(float x) { return mod289(((x * 34.0f) + 10.0f) * x); }

// torch.remainder(x, 1.0) as the gradient and the image UVs take it.
// torch.remainder adds 1 to fmodf(x, 1) where that is negative; fmodf is
// exact, so both that sum and x - floor(x) are the one rounding of x -
// floor(x) and give the same bits, but for the sign of a zero (fmodf keeps
// -0 where x is a negative integer): no sum of the turbulence keeps it (its
// accumulator starts at +0), and no texel index (floor(+-0 * w) is 0;
// tests/test_torch_image_fract.py checks the indices).
__device__ __forceinline__ float fract(float x) { return x - floorf(x); }

__device__ __forceinline__ float fade(float t) {
  return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f);
}

__device__ __forceinline__ float mix(float a, float b, float t) { return a + (b - a) * t; }

// perlin._grads of one hash, each component scaled by _taylor_inv_sqrt of
// the gradient's squared length
__device__ __forceinline__ float4 gradient(float hash) {
  float gx = hash * kInv7;
  float gy = fract(floorf(gx) * kInv7) - 0.5f;
  gx = fract(gx);
  const float gz = 0.5f - fabsf(gx) - fabsf(gy);
  const float sz = gz <= 0.0f ? 1.0f : 0.0f;
  gx = gx - sz * ((gx >= 0.0f ? 1.0f : 0.0f) - 0.5f);
  gy = gy - sz * ((gy >= 0.0f ? 1.0f : 0.0f) - 0.5f);
  const float norm = kTaylor0 - kTaylor1 * (gx * gx + gy * gy + gz * gz);
  return make_float4(gx * norm, gy * norm, gz * norm, 0.0f);
}

// A hashed corner's scaled gradient dotted with the corner's offset
__device__ __forceinline__ float corner(float4 g, float xx, float yy, float zz) {
  return g.x * xx + g.y * yy + g.z * zz;
}

// The lattice tables a noise form stages in shared memory at block start,
// built by permute() and gradient() themselves: row x + 1 of each holds
// permute(x) and gradient(permute(x)), x in [-1, 577].
struct NoiseTables {
  const float4* grad;
  const int* perm;
};

// perlin.cnoise_v3.  Each (x, y) corner's two z corners are mixed along z
// as soon as both are known, which computes the same mixes in fewer
// registers.  Below 2^24 the permutes and gradients are read from the
// tables; beyond, where the chain is no longer exact, they are computed.
__device__ __forceinline__ float cnoise(float px, float py, float pz, const NoiseTables& nt) {
  const float fpx = floorf(px);
  const float fpy = floorf(py);
  const float fpz = floorf(pz);
  const float x0i = mod289(fpx), y0i = mod289(fpy), z0i = mod289(fpz);
  const float x1i = mod289(fpx + 1.0f), y1i = mod289(fpy + 1.0f), z1i = mod289(fpz + 1.0f);
  const float x0 = px - fpx, y0 = py - fpy, z0 = pz - fpz;
  const float x1 = x0 - 1.0f, y1 = y0 - 1.0f, z1 = z0 - 1.0f;
  const float fz = fade(z0);
  float nz[4];  // corners (x0,y0) (x1,y0) (x0,y1) (x1,y1), as cnoise_v3's
  if (fabsf(fpx) < kTableLimit && fabsf(fpy) < kTableLimit && fabsf(fpz) < kTableLimit) {
    const int* perm = nt.perm + 1;       // perm[x] = permute(x)
    const float4* grad = nt.grad + 1;    // grad[x] = gradient(permute(x))
    const int hx0 = perm[static_cast<int>(x0i)];
    const int hx1 = perm[static_cast<int>(x1i)];
    const int iz0 = static_cast<int>(z0i);
    const int iz1 = static_cast<int>(z1i);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ixy = perm[(c & 1 ? hx1 : hx0) + static_cast<int>(c & 2 ? y1i : y0i)];
      const float xx = c & 1 ? x1 : x0;
      const float yy = c & 2 ? y1 : y0;
      const float n0 = corner(grad[ixy + iz0], xx, yy, z0);
      const float n1 = corner(grad[ixy + iz1], xx, yy, z1);
      nz[c] = mix(n0, n1, fz);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float ixy = permute(permute(c & 1 ? x1i : x0i) + (c & 2 ? y1i : y0i));
      const float xx = c & 1 ? x1 : x0;
      const float yy = c & 2 ? y1 : y0;
      const float n0 = corner(gradient(permute(ixy + z0i)), xx, yy, z0);
      const float n1 = corner(gradient(permute(ixy + z1i)), xx, yy, z1);
      nz[c] = mix(n0, n1, fz);
    }
  }
  const float fy = fade(y0);
  const float fx = fade(x0);
  return kNoiseGain * mix(mix(nz[0], nz[2], fy), mix(nz[1], nz[3], fy), fx);
}

// perlin.turbulence_v3(p, 7)
__device__ __forceinline__ float turbulence(V3 p, const NoiseTables& nt) {
  float accum = 0.0f;
  float weight = 1.0f;
#pragma unroll 1
  for (int i = 0; i < kOctaves; ++i) {
    accum = accum + weight * cnoise(p.x, p.y, p.z, nt);
    weight *= 0.5f;
    p = p * 2.0f;
  }
  return fabsf(accum);
}

// ---- images: the sphere's world-to-object branch, its UV, the sampler ----

// engine/wavefront.py reconstruct_hit's world-to-object branch for a
// sphere whose fat row holds its world-to-object matrix (slots 32:44) and
// its object-space centre and radius (44:48), at world point p: the object
// normal on = (p_obj - c) / r and the world normal, on taken back by the
// transposed matrix (ops/vec3.py mat34_apply_transposed_vec) and
// normalised.  The matrix is read once; the UV takes on too.
__device__ __forceinline__ void sphere_normals(const float* __restrict__ row, V3 p, V3& on,
                                               V3& n) {
  float m[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) m[k] = __ldg(row + 32 + k);
  const V3 po = apply_point(m, p);
  const float r = __ldg(row + 47);
  const float inv_r = 1.0f / (r == 0.0f ? 1.0f : r);
  on = {(po.x - __ldg(row + 44)) * inv_r, (po.y - __ldg(row + 45)) * inv_r,
        (po.z - __ldg(row + 46)) * inv_r};
  n = normalize(v3(m[0] * on.x + m[4] * on.y + m[8] * on.z, m[1] * on.x + m[5] * on.y + m[9] * on.z,
                   m[2] * on.x + m[6] * on.y + m[10] * on.z));
}

// The packed image atlas (engine/arrays.pack_atlas) and what samples it.
struct Atlas {
  const int* __restrict__ words;  // [n, h, w] r | g << 8 | b << 16
  const int* __restrict__ wh;     // [n, 2] each image's width and height
  int n, h, w;                    // images, and the padded height and width
  const float* lut;               // the sRGB table, in shared memory
};

// textures.sample_image_nearest of image `aux` (clipped to the atlas) at (u,
// v), up to the sRGB decode: the texel's packed word
__device__ __forceinline__ uint32_t texel_word(const Atlas& at, float aux, float u, float v) {
  const int idx = min(max(static_cast<int>(aux), 0), at.n - 1);
  const int w = __ldg(at.wh + 2 * idx);
  const int h = __ldg(at.wh + 2 * idx + 1);
  const int x = min(max(static_cast<int>(floorf(fract(u) * static_cast<float>(w))), 0), w - 1);
  const int y = min(max(static_cast<int>(floorf(fract(v) * static_cast<float>(h))), 0), h - 1);
  return static_cast<uint32_t>(
      __ldg(at.words + (static_cast<size_t>(idx) * at.h + y) * at.w + x));
}

// ... and its decode by the sRGB table
__device__ __forceinline__ V3 decode_texel(const Atlas& at, uint32_t word) {
  return {at.lut[word & 0xffu], at.lut[(word >> 8) & 0xffu], at.lut[(word >> 16) & 0xffu]};
}

// The measuring build's eval_slot and slot_value also set took_noise where
// the slot takes a turbulence; the normal build's have no such parameter,
// so their code is as without it.
#ifdef K4_MEASURE
#define K4_MEASURE_TOOK_PARAM , bool& took_noise
#define K4_MEASURE_TOOK_ARG , m_took
#define K4_MEASURE_TOOK() took_noise = true
#else
#define K4_MEASURE_TOOK_PARAM
#define K4_MEASURE_TOOK_ARG
#define K4_MEASURE_TOOK() static_cast<void>(0)
#endif

// shading._eval_property in the noise forms without images: the slot (cols
// base:base+3, its mode at mode, its aux after it), or the row's checker's
// even or odd slot where the mode says so; a slot in noise mode is the
// marble (its turbulence from the lattice tables nt).
template <bool kNoise>
__device__ __forceinline__ V3 eval_slot(const float* __restrict__ row, int base, int mode,
                                        bool has_checker, V3 p,
                                        const NoiseTables& nt K4_MEASURE_TOOK_PARAM) {
  float m = __ldg(row + mode);
  int aux = mode + 1;
  if (has_checker && m == kModeChecker) {
    const bool even = checker_is_even(__ldg(row + 17), p);
    base = even ? 18 : 21;
    aux = even ? 25 : 27;
    m = __ldg(row + aux - 1);
  }
  if constexpr (kNoise) {
    if (m == kModeNoise) {
      K4_MEASURE_TOOK();
      const float v = 0.5f * (1.0f + sinf(__ldg(row + aux) * p.z + 10.0f * turbulence(p, nt)));
      return {v, v, v};
    }
  }
  return load3(row, base);
}

// The image forms' slot read, in two parts around the draws.  read_slot,
// right after the hit is reconstructed: the slot the hit reads (the albedo
// of a lambertian or metal, or a front-facing light's emission, through the
// row's checker where its mode says so), and where that slot is in image
// mode the texel's word, fetched then (at the UV of the sphere's object
// normal on, or the lerp of a triangle's fat-row slots 58:64) so that the
// read of the atlas, larger than L2, overlaps the draws and the material's
// scatter.  slot_value, where the hit's shading needs it: the texel
// decoded, the marble (with kNoise) or the constant slot.
struct SlotRead {
  bool wants;     // the hit reads a slot
  bool albedo;    // ... its albedo, else its emission
  int base;       // the slot's columns, after the checker
  int aux;        // its aux column
  float mode;     // its mode
  uint32_t word;  // image mode: the texel's packed word
};

__device__ __forceinline__ SlotRead read_slot(const float* __restrict__ row, int mat, bool front,
                                              bool has_emissive, bool has_checker, V3 p,
                                              bool is_sphere, V3 on, float bu, float bv,
                                              const Atlas& atlas) {
  SlotRead s;
  s.albedo = mat == kLambertian || mat == kMetal;
  s.wants = s.albedo || (has_emissive && mat == kDiffuseLight && front);
  s.base = s.albedo ? 2 : 8;
  s.aux = s.albedo ? 12 : 16;
  s.mode = 0.0f;
  s.word = 0u;
  if (!s.wants) return s;
  s.mode = __ldg(row + s.aux - 1);
  if (has_checker && s.mode == kModeChecker) {
    const bool even = checker_is_even(__ldg(row + 17), p);
    s.base = even ? 18 : 21;
    s.aux = even ? 25 : 27;
    s.mode = __ldg(row + s.aux - 1);
  }
  if (s.mode == kModeImage) {
    float u, v;
    if (is_sphere) {
      const V3 nn = normalize(on);
      v = acosf(fminf(fmaxf(-nn.y, -1.0f), 1.0f)) * (1.0f / kPi);
      u = fract(atan2f(nn.z, -nn.x) * (1.0f / kTwoPi));
    } else {
      u = __ldg(row + 58) + bu * __ldg(row + 60) + bv * __ldg(row + 62);
      v = __ldg(row + 59) + bu * __ldg(row + 61) + bv * __ldg(row + 63);
    }
    s.word = texel_word(atlas, __ldg(row + s.aux), u, v);
  }
  return s;
}

template <bool kNoise>
__device__ __forceinline__ V3 slot_value(const float* __restrict__ row, const SlotRead& s, V3 p,
                                         const Atlas& atlas,
                                         const NoiseTables& nt K4_MEASURE_TOOK_PARAM) {
  if constexpr (kNoise) {
    if (s.mode == kModeNoise) {
      K4_MEASURE_TOOK();
      const float v =
          0.5f * (1.0f + sinf(__ldg(row + s.aux) * p.z + 10.0f * turbulence(p, nt)));
      return {v, v, v};
    }
  }
  if (s.mode == kModeImage) return decode_texel(atlas, s.word);
  return load3(row, s.base);
}

// Sphere j of the table staged in shared memory, at the sample's time in
// the animated form (megakernel.py sph_8 anim_lerp).
template <bool kAnim>
__device__ __forceinline__ void staged_sphere(const float4* tbl, int j, float tcur, float4& sph,
                                              float& k) {
  if constexpr (kAnim) {
    const float4 c0 = tbl[3 * j];
    const float4 kk = tbl[3 * j + 1];
    const float4 dc = tbl[3 * j + 2];
    sph = make_float4(c0.x + tcur * dc.x, c0.y + tcur * dc.y, c0.z + tcur * dc.z, c0.w);
    k = kk.x + tcur * (kk.y + tcur * kk.z);
  } else {
    sph = tbl[2 * j];
    k = tbl[2 * j + 1].x;
  }
}

// The sphere read from the tables in global memory (csrc/sphere_tree.cuh),
// the sphere test and the clustered spheres' tree, shared with K1.
using sphere_tree::global_sphere;
using sphere_tree::SphereTree;
using sphere_tree::test_sphere;

// Sphere j: staged in the dense forms, from global memory in the
// clustered ones.
template <bool kAnim, bool kSphClusters>
__device__ __forceinline__ void fetch_sphere(const float4* tbl, const float4* __restrict__ table,
                                             const float4* __restrict__ dtable, int j, float tcur,
                                             float4& sph, float& k) {
  if constexpr (kSphClusters) {
    global_sphere<kAnim>(table, dtable, j, tcur, sph, k);
  } else {
    staged_sphere<kAnim>(tbl, j, tcur, sph, k);
  }
}

// The triangle soup's tree against one ray, after the sphere sweep: see
// the header.  Updates the best t and id, the barycentrics and the hit
// point.
__device__ __forceinline__ void sweep_tris(const tri_tree::Tree& tree,
                                           tri_tree::Stack<kStack>& stack, int s_pad, V3 o, V3 d,
                                           float& best_t, int& best_id, float& best_u,
                                           float& best_v, V3& tp) {
  const tri_tree::Ray r = tri_tree::make_ray(o.x, o.y, o.z, d.x, d.y, d.z);
  tri_tree::walk<kStack, true>(
      stack, tree, r, s_pad, best_t, best_id, best_u, best_v,
      [&](float4 v0, float4 e1, float4 e2, float u, float v) {
        tp = {v0.x + u * e1.x + v * e2.x, v0.y + u * e1.y + v * e2.y,
              v0.z + u * e1.z + v * e2.z};
      });
}

// ---- the measuring build ----
//
// Built with -DK4_MEASURE (ops/_build.py "megakernel_measure"; never
// loaded by the Renderer), the kernel also counts, each step of a warp,
// its busy lanes (__popc(__activemask())) and 32 lane slots, and clock64
// spans of the step's phases: regeneration, closest hit, shading, NEE and
// the sample's end; and in the noise forms, each lane's turbulences, as
// eval_slot reports them.  The step's lowest active lane keeps the warp's
// busy lanes, slots and spans in registers, and each lane its own
// turbulences; each lane adds what it kept into g_measure once, after its
// last step.  The clocks are read by every active lane at the points
// where the warp has reconverged, so a span is the warp's time in that
// phase, other warps' issue slots on the multiprocessor included.  The
// sums and bounce counts are the normal build's, byte for byte.

enum MeasureSlot {
  kMeasureBusy, kMeasureSlots, kMeasureRegen, kMeasureHit, kMeasureShade, kMeasureNee,
  kMeasureEnd, kMeasureNoiseLanes, kMeasureCount
};

#ifdef K4_MEASURE
__device__ unsigned long long g_measure[kMeasureCount];

#define K4_MEASURE_INIT()                             \
  unsigned long long m_acc[kMeasureCount] = {};       \
  bool m_lead = false;                                \
  bool m_took = false;                                \
  long long m_t = 0
#define K4_MEASURE_STEP()                                          \
  do {                                                             \
    const unsigned m_mask = __activemask();                        \
    m_lead = (threadIdx.x & 31) == __ffs(m_mask) - 1;              \
    m_t = clock64();                                               \
    if (m_lead) {                                                  \
      m_acc[kMeasureBusy] += __popc(m_mask);                       \
      m_acc[kMeasureSlots] += 32;                                  \
    }                                                              \
  } while (0)
#define K4_MEASURE_NOISE()                                         \
  do {                                                             \
    if (m_took) ++m_acc[kMeasureNoiseLanes];                       \
    m_took = false;                                                \
  } while (0)
#define K4_MEASURE_SPAN(slot)                                      \
  do {                                                             \
    const long long m_now = clock64();                             \
    if (m_lead) m_acc[slot] += static_cast<unsigned long long>(m_now - m_t); \
    m_t = m_now;                                                   \
  } while (0)
#define K4_MEASURE_FLUSH()                                         \
  do {                                                             \
    _Pragma("unroll") for (int m_k = 0; m_k < kMeasureCount; ++m_k) { \
      if (m_acc[m_k] != 0) atomicAdd(&g_measure[m_k], m_acc[m_k]); \
    }                                                              \
  } while (0)
#else
#define K4_MEASURE_INIT() static_cast<void>(0)
#define K4_MEASURE_STEP() static_cast<void>(0)
#define K4_MEASURE_NOISE() static_cast<void>(0)
#define K4_MEASURE_SPAN(slot) static_cast<void>(0)
#define K4_MEASURE_FLUSH() static_cast<void>(0)
#endif

// ---- the kernel ----

template <bool kAnim, bool kTris, bool kLights, bool kNoise, bool kImage, bool kSphClusters>
__global__ void __launch_bounds__(kThreads)
megakernel(const float4* __restrict__ table, const float4* __restrict__ dtable,
           const float* __restrict__ times, int n_sph, const float4* __restrict__ tris, int t8,
           const float4* __restrict__ tri_nodes, const int* __restrict__ tri_ids, int tri_depth,
           int tri_leaf, int s_pad, const float4* __restrict__ sph_rows,
           const float4* __restrict__ sph_drows, const float4* __restrict__ sph_nodes,
           const int* __restrict__ sph_ids, int n_prefix, int sph_depth, int sph_leaf,
           int sph_staged, const float* __restrict__ lights, const float* __restrict__ o2w,
           const int* __restrict__ atlas_words, const int* __restrict__ atlas_wh, int n_images,
           int atlas_h, int atlas_w, const float* __restrict__ lut,
           const float* __restrict__ rows, int n_prim_rows, const float* __restrict__ fparams,
           int width, int height, int row_base, int n_rows, int sqrt_spp, int spp_local,
           int n_batches, int batch0, int sample_base, int max_depth, int flags,
           float* __restrict__ sums, int* __restrict__ traced_out) {
  static_assert(!(kAnim && kTris), "the animated form has no triangles");
  static_assert(!(kAnim && kLights), "the animated form has no lights");
  static_assert(!(kAnim && kImage), "the animated form has no images");
  extern __shared__ float4 smem[];
  float* prm = reinterpret_cast<float*>(smem);        // kNumParams floats
  // Static sphere j: tbl[2j] = (c, r), tbl[2j+1].x = k.  Animated:
  // tbl[3j] = (c0, r), tbl[3j+1] = (k0, k1, k2, -), tbl[3j+2] = (dc, -).
  // The clustered forms stage no row.
  const int n_staged = kSphClusters ? 0 : n_sph;
  float4* tbl = smem + kNumParams / 4;
  // The clustered forms' top node rows of the sphere tree, four float4 a
  // node.
  float4* snodes = tbl + kStride<kAnim> * n_staged;
  // The sRGB table, after the nodes.
  float* lut_s = reinterpret_cast<float*>(snodes + (kSphClusters ? 4 * sph_staged : 0));
  // The noise forms' lattice tables, after the sRGB table.
  float4* grad_s = reinterpret_cast<float4*>(lut_s + (kImage ? kLutSize : 0));
  int* perm_s = reinterpret_cast<int*>(grad_s + kTableRows);
  for (int j = threadIdx.x; j < kNumParams; j += kThreads) prm[j] = fparams[j];
  if constexpr (kSphClusters) {
    for (int j = threadIdx.x; j < 4 * sph_staged; j += kThreads) snodes[j] = sph_nodes[j];
  }
  if constexpr (kImage) {
    for (int j = threadIdx.x; j < kLutSize; j += kThreads) lut_s[j] = lut[j];
  }
  if constexpr (kNoise) {
    for (int j = threadIdx.x; j < kTableRows; j += kThreads) {
      const float h = permute(static_cast<float>(j - 1));
      perm_s[j] = static_cast<int>(h);
      grad_s[j] = gradient(h);
    }
  }
  if constexpr (kAnim) {
    for (int j = threadIdx.x; j < n_staged; j += kThreads) {
      const float4 dk = dtable[2 * j + 1];
      tbl[3 * j] = table[2 * j];
      tbl[3 * j + 1] = make_float4(table[2 * j + 1].x, dk.x, dk.y, 0.0f);
      tbl[3 * j + 2] = dtable[2 * j];
    }
  } else {
    for (int j = threadIdx.x; j < 2 * n_staged; j += kThreads) tbl[j] = table[j];
  }
  __syncthreads();  // the only barrier: no thread waits on another below

  // The launch's pixels: rows row_base .. row_base + n_rows - 1 of the
  // frame, each thread one pixel, the outputs indexed from the first.
  const int n_pix = width * n_rows;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= n_pix) return;
  const int px = pix % width;
  const int py = row_base + pix / width;
  const bool use_dof = flags & kUseDof;
  const bool has_checker = flags & kHasChecker;
  const bool has_emissive = flags & kHasEmissive;
  const uint32_t spp = static_cast<uint32_t>(sqrt_spp * sqrt_spp);
  const V3 bg = {prm[kSky], prm[kSky + 1], prm[kSky + 2]};
  const int n_samples = n_batches * spp_local;
  const Atlas atlas = {atlas_words, atlas_wh, n_images, atlas_h, atlas_w, lut_s};
  const tri_tree::Tree tree = {tris, tri_nodes, tri_ids, t8, tri_depth, tri_leaf};
  const SphereTree sph_tree = {sph_rows, sph_drows, sph_nodes, snodes, sph_ids,
                               n_sph - n_prefix, sph_depth, sph_leaf, sph_staged};
  const NoiseTables noise_tables = {grad_s, perm_s};
  tri_tree::Stack<kStack> stack;

  float sum_x = 0.0f, sum_y = 0.0f, sum_z = 0.0f;
  int traced = 0;
  // The lane's sample in flight: its index s_all, its bounces so far
  // (depth 0: the sample is still to start), its PCG state, ray,
  // throughput, radiance and (kAnim) shutter time.  With max_depth <= 0 no
  // sample traces a bounce, as in the plain version.
  const int n_run = max_depth > 0 ? n_samples : 0;
  int s_all = 0;
  int depth = 0;
  uint32_t state = 0u;
  V3 o = {0.0f, 0.0f, 0.0f};
  V3 d = {0.0f, 0.0f, 0.0f};
  V3 thr = {0.0f, 0.0f, 0.0f};
  V3 acc = {0.0f, 0.0f, 0.0f};
  float tcur = 0.0f;  // the sample's shutter time (kAnim)
  K4_MEASURE_INIT();

  // One step a loop iteration: one bounce of the lane's sample, after its
  // raygen where the sample starts.  A lane whose sample ends adds it to its
  // pixel's sums and starts the next one at the top of its next step, so
  // the warp's lanes run their own samples at their own depths and a lane
  // waits only when its pixel has no sample left.
  while (s_all < n_run) {
    K4_MEASURE_STEP();
    if (depth == 0) {  // regeneration: the camera ray of sample s_all
      const int batch = batch0 + s_all / spp_local;
      const int s = s_all % spp_local + sample_base;
      if constexpr (kAnim) tcur = __ldg(times + batch);
      state = init_rng(static_cast<uint32_t>(batch), static_cast<uint32_t>(s),
                       static_cast<uint32_t>(py), static_cast<uint32_t>(px),
                       static_cast<uint32_t>(width), static_cast<uint32_t>(height), spp);
      get_ray(state, prm, px, py, s % sqrt_spp, s / sqrt_spp, width, height, use_dof, o, d);
      thr = {1.0f, 1.0f, 1.0f};
      acc = {0.0f, 0.0f, 0.0f};
    }
    K4_MEASURE_SPAN(kMeasureRegen);

    ++traced;
    // Closest hit (the quadratic of csrc/sphere_sweep.cu and
    // ops/spheres.py intersect_spheres_world).
    const float d_dot_o = d.x * o.x + d.y * o.y + d.z * o.z;
    const float a = d.x * d.x + d.y * d.y + d.z * d.z;
    const float o_sq = o.x * o.x + o.y * o.y + o.z * o.z;
    const float inv_a = 1.0f / (a == 0.0f ? 1.0f : a);
    float best_t = kTMax;
    int best_id = -1;
    // Every real sphere densely, or in the clustered forms the prefix,
    // then the tree.
    const int n_dense = kSphClusters ? n_prefix : n_sph;
    for (int j = 0; j < n_dense; ++j) {
      float4 sph;
      float k;
      fetch_sphere<kAnim, kSphClusters>(tbl, table, dtable, j, tcur, sph, k);
      test_sphere(sph, k, o, d, d_dot_o, a, o_sq, inv_a, j, best_t, best_id);
    }
    if constexpr (kSphClusters) {
      sphere_tree::sweep_sphere_tree<kAnim>(sph_tree, stack, tcur, o, d, d_dot_o, a, o_sq,
                                            inv_a, best_t, best_id);
    }
    float bu = 0.0f, bv = 0.0f;
    V3 tp = {0.0f, 0.0f, 0.0f};
    if constexpr (kTris) {
      sweep_tris(tree, stack, s_pad, o, d, best_t, best_id, bu, bv, tp);
    }
    K4_MEASURE_SPAN(kMeasureHit);

    // Shading: a miss adds the sky; a hit is reconstructed and shaded, and
    // either scatters or is absorbed.  What the next phase needs of the
    // hit is declared here.
    const float* __restrict__ row =
        rows + static_cast<size_t>(min(max(best_id, 0), n_prim_rows - 1)) * kRowWidth;
    V3 p = {0.0f, 0.0f, 0.0f};
    V3 normal = {0.0f, 0.0f, 0.0f};
    V3 attenuation = {0.0f, 0.0f, 0.0f};
    V3 skip_dir = {0.0f, 0.0f, 0.0f};
    bool is_lamb = false;
    bool scattered = false;
    if (best_t >= kTMax) {  // miss: the sky, and the sample ends
      acc = acc + thr * bg;
    } else {
      // Hit reconstruction (wavefront.reconstruct_hit): a sphere's point
      // o + t d and its direct world normal (with images, the normal of the
      // world-to-object branch), or a triangle's captured point and lerped
      // normal.
      const bool is_sphere = !kTris || best_id < s_pad;
      V3 n;
      V3 on = {0.0f, 0.0f, 0.0f};  // kImage: a sphere's object normal
      if (is_sphere) {
        p = {o.x + d.x * best_t, o.y + d.y * best_t, o.z + d.z * best_t};
        if constexpr (kImage) {
          sphere_normals(row, p, on, n);
        } else {
          V3 c = load3(row, 44);
          if constexpr (kAnim) {  // the centre at the sample's time, as swept
            c = {c.x + tcur * __ldg(row + 49), c.y + tcur * __ldg(row + 50),
                 c.z + tcur * __ldg(row + 51)};
          }
          const float r = __ldg(row + 47);
          const float inv_r = 1.0f / (r == 0.0f ? 1.0f : r);
          n = normalize(v3((p.x - c.x) * inv_r, (p.y - c.y) * inv_r, (p.z - c.z) * inv_r));
        }
      } else {
        p = tp;
        n = normalize(v3(__ldg(row + 49) + bu * __ldg(row + 52) + bv * __ldg(row + 55),
                         __ldg(row + 50) + bu * __ldg(row + 53) + bv * __ldg(row + 56),
                         __ldg(row + 51) + bu * __ldg(row + 54) + bv * __ldg(row + 57)));
      }
      const bool front = dot(d, n) < 0.0f;
      normal = front ? n : -n;

      // shading.scatter_and_emit_v3 (fat rows); the draws are unconditional.
      const int mat = static_cast<int>(__ldg(row + 0));
      SlotRead slot;  // kImage: the slot, and its texel fetched before the draws
      if constexpr (kImage) {
        slot = read_slot(row, mat, front, has_emissive, has_checker, p, is_sphere, on, bu, bv,
                         atlas);
      }
      const V3 fuzz_unit = random_unit(state);
      const float diel_u = random_float(state);
      is_lamb = mat == kLambertian;
      const bool is_metal = mat == kMetal;
      const bool is_diel = mat == kDielectric;
      const bool is_light = mat == kDiffuseLight;

      V3 emit = {0.0f, 0.0f, 0.0f};
      if constexpr (kImage) {
        if (slot.wants) {
          const V3 v = slot_value<kNoise>(row, slot, p, atlas, noise_tables K4_MEASURE_TOOK_ARG);
          K4_MEASURE_NOISE();
          if (slot.albedo) {
            attenuation = v;
          } else {
            emit = v;
          }
        }
      } else if constexpr (kNoise) {
        // The one slot this hit reads, evaluated once: one call site
        // holds the turbulence.
        const bool reads_albedo = is_lamb || is_metal;
        if (reads_albedo || (has_emissive && is_light && front)) {
          const V3 v = eval_slot<kNoise>(row, reads_albedo ? 2 : 8, reads_albedo ? 11 : 15,
                                         has_checker, p, noise_tables K4_MEASURE_TOOK_ARG);
          K4_MEASURE_NOISE();
          if (reads_albedo) {
            attenuation = v;
          } else {
            emit = v;
          }
        }
      } else {
        if (is_lamb || is_metal) attenuation = eval_property(row, 2, 11, has_checker, p);
      }
      if (is_lamb) {
        scattered = true;
      } else if (is_metal) {
        const V3 reflected = reflect(d, normal);
        scattered = dot(reflected, normal) > 0.0f;
        skip_dir = normalize(reflected) + load3(row, 5) * fuzz_unit;
      } else if (is_diel) {
        scattered = true;
        attenuation = {1.0f, 1.0f, 1.0f};
        const float ref_idx = __ldg(row + 1);
        const float ri = front ? 1.0f / (ref_idx == 0.0f ? 1.0f : ref_idx) : ref_idx;
        const V3 unit_dir = normalize(d);
        const float cos_theta = fminf(-dot(unit_dir, normal), 1.0f);
        const float sin_theta = sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
        // materials.schlick_reflectance, x**5 as the squarings JAX lowers to
        float r0 = (1.0f - ri) / (1.0f + ri);
        r0 = r0 * r0;
        const float x = 1.0f - cos_theta;
        const float x2 = x * x;
        const float schlick = r0 + (1.0f - r0) * (x * (x2 * x2));
        const bool cannot_refract = ri * sin_theta > 1.0f || schlick > diel_u;
        skip_dir = cannot_refract ? reflect(unit_dir, normal) : refract(unit_dir, normal, ri);
      }
      if (has_emissive && is_light && front) {
        if constexpr (kNoise || kImage) {
          acc = acc + thr * emit;
        } else {
          acc = acc + thr * eval_property(row, 8, 15, has_checker, p);
        }
      }
    }
    K4_MEASURE_SPAN(kMeasureShade);

    if (scattered) {
      // nee.py.  With lights, sample_light_sources_v3 (the alias pick, the
      // hit instance's objectToWorld: the quirk, a uniform point and the
      // light normal) and choose_mixture_pdf; without, the material pdf
      // alone.  Both direction draws are unconditional, as in
      // gen_scatter_direction_v3.
      bool chose_light = false;
      V3 lpos = {0.0f, 0.0f, 0.0f};
      V3 lnrm = {0.0f, 0.0f, 0.0f};
      if constexpr (kLights) {
        const float u1 = random_float(state);
        const float u2 = random_float(state);
        const float n_lights = prm[kLightCount];
        const int li = min(static_cast<int>(u1 * n_lights), max(static_cast<int>(n_lights) - 1, 0));
        const float* __restrict__ lrow = lights + static_cast<size_t>(li) * kLightWidth;
        const int tri = u2 >= __ldg(lrow + 9) ? static_cast<int>(__ldg(lrow + 10)) : li;
        const float* __restrict__ lt = lights + static_cast<size_t>(tri) * kLightWidth;
        const float* __restrict__ o2w_row =
            o2w + static_cast<size_t>(static_cast<int>(__ldg(row + 48))) * 12;
        float m[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) m[k] = __ldg(o2w_row + k);
        const V3 w0 = apply_point(m, load3(lt, 0));
        const V3 w1 = apply_point(m, load3(lt, 3));
        const V3 w2 = apply_point(m, load3(lt, 6));
        float rx = random_float(state);
        float ry = random_float(state);
        if (rx + ry > 1.0f) {
          rx = 1.0f - rx;
          ry = 1.0f - ry;
        }
        lpos = {w0.x + rx * (w1.x - w0.x) + ry * (w2.x - w0.x),
                w0.y + rx * (w1.y - w0.y) + ry * (w2.y - w0.y),
                w0.z + rx * (w1.z - w0.z) + ry * (w2.z - w0.z)};
        lnrm = normalize(cross(w1 - w0, w2 - w0));
        chose_light = random_float(state) < 0.5f;
      }
      random_unit(state);  // the sphere-pdf direction, which no material takes
      const V3 cl = random_cosine(state);
      if (is_lamb) {
        const V3 sdir = chose_light ? lpos - p : cosine_direction(normal, cl);
        // pdf_value_v3: the cosine pdf of sdir (and with lights its light pdf)
        const float dn = sqrtf(dot(sdir, sdir));
        const float inv = 1.0f / (dn == 0.0f ? 1.0f : dn);
        const V3 unit = sdir * inv;
        const float scatter_pdf = fmaxf(dot(unit, normal) * (1.0f / kPi), 0.0f);
        // Without lights the ratio pdf/pdf is 1 except where the pdf is 0
        // (guarded 0/0).
        float ratio = scatter_pdf > 0.0f ? 1.0f : 0.0f;
        if constexpr (kLights) {
          const float dist_sq = dot(sdir, sdir);
          const float cos_l = fabsf(-dot(lnrm, unit));
          const float light_pdf =
              cos_l <= 0.0f ? 0.0f : (dist_sq / cos_l) * (1.0f / prm[kLightArea]);
          const float pdf_value = 0.5f * light_pdf + 0.5f * scatter_pdf;
          ratio = pdf_value > 0.0f ? scatter_pdf / pdf_value : 0.0f;
        }
        thr = thr * attenuation * ratio;
        d = normalize(sdir);
      } else {  // metal or dielectric: skip the pdf
        thr = thr * attenuation;
        d = skip_dir;
      }
      o = p;
      ++depth;
    }
    K4_MEASURE_SPAN(kMeasureNee);

    // The sample ends on a miss, on absorption or after max_depth bounces
    // (no sky then): its radiance joins the pixel's sums in sample order.
    if (!scattered || depth == max_depth) {
      sum_x += acc.x;
      sum_y += acc.y;
      sum_z += acc.z;
      ++s_all;
      depth = 0;
    }
    K4_MEASURE_SPAN(kMeasureEnd);
  }
  K4_MEASURE_FLUSH();
  sums[3 * pix + 0] = sum_x;
  sums[3 * pix + 1] = sum_y;
  sums[3 * pix + 2] = sum_z;
  traced_out[pix] = traced;
}

template <bool kAnim, bool kTris, bool kLights, bool kNoise, bool kImage, bool kSphClusters>
int launch(const void* table8, const void* dtab8, const void* times, int n_sph, const void* tris12,
           int t8, const void* tri_nodes, const void* tri_ids, int tri_depth, int tri_leaf,
           int s_pad, const void* sph_rows, const void* sph_drows, const void* sph_nodes,
           const void* sph_ids, int n_prefix, int sph_depth, int sph_leaf, int sph_staged,
           const void* lights16, const void* o2w12, const void* atlas_words,
           const void* atlas_wh, int n_images, int atlas_h, int atlas_w, const void* lut,
           const void* rows, int n_prim_rows, const void* fparams, int width, int height,
           int row_base, int n_rows, int sqrt_spp, int spp_local, int n_batches, int batch0,
           int sample_base, int max_depth, int flags, void* sums, void* traced, void* stream,
           void* query) {
  const size_t n_staged = kSphClusters ? 0 : static_cast<size_t>(n_sph);
  const size_t smem = (kNumParams + 4 * kStride<kAnim> * n_staged +
                       (kSphClusters ? 16 * static_cast<size_t>(sph_staged) : 0) +
                       (kImage ? kLutSize : 0) +
                       (kNoise ? 5 * kTableRows : 0)) *  // a float4 and an int a row
                      sizeof(float);
  auto* kernel = megakernel<kAnim, kTris, kLights, kNoise, kImage, kSphClusters>;
  if (smem > 48 * 1024) {  // above the default limit it must be opted into
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (query != nullptr) {  // the form's occupancy at this shared memory, no launch
    int* out = static_cast<int*>(query);
    out[1] = static_cast<int>(smem);
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads, smem));
  }
  const int n_pix = width * n_rows;
  if (n_pix <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table8), static_cast<const float4*>(dtab8),
      static_cast<const float*>(times), n_sph, static_cast<const float4*>(tris12), t8,
      static_cast<const float4*>(tri_nodes), static_cast<const int*>(tri_ids), tri_depth,
      tri_leaf, s_pad, static_cast<const float4*>(sph_rows),
      static_cast<const float4*>(sph_drows), static_cast<const float4*>(sph_nodes),
      static_cast<const int*>(sph_ids), n_prefix, sph_depth, sph_leaf, sph_staged,
      static_cast<const float*>(lights16), static_cast<const float*>(o2w12),
      static_cast<const int*>(atlas_words), static_cast<const int*>(atlas_wh), n_images, atlas_h,
      atlas_w, static_cast<const float*>(lut), static_cast<const float*>(rows), n_prim_rows,
      static_cast<const float*>(fparams), width, height, row_base, n_rows, sqrt_spp, spp_local,
      n_batches, batch0, sample_base, max_depth, flags, static_cast<float*>(sums),
      static_cast<int*>(traced));
  return static_cast<int>(cudaGetLastError());
}

#define MEGA_PARAMS                                                                            \
  const void *table8, const void *dtab8, const void *times, int n_sph, const void *tris12,     \
      int t8, const void *tri_nodes, const void *tri_ids, int tri_depth, int tri_leaf,         \
      int s_pad, const void *sph_rows, const void *sph_drows, const void *sph_nodes,           \
      const void *sph_ids, int n_prefix, int sph_depth, int sph_leaf, int sph_staged,          \
      const void *lights16, const void *o2w12, const void *atlas_words, const void *atlas_wh,  \
      int n_images, int atlas_h, int atlas_w, const void *lut, const void *rows,               \
      int n_prim_rows, const void *fparams, int width, int height, int row_base, int n_rows,   \
      int sqrt_spp, int spp_local, int n_batches, int batch0, int sample_base, int max_depth,  \
      int flags, void *sums, void *traced, void *stream, void *query

#define MEGA_ARGS                                                                            \
  table8, dtab8, times, n_sph, tris12, t8, tri_nodes, tri_ids, tri_depth, tri_leaf, s_pad,   \
      sph_rows, sph_drows, sph_nodes, sph_ids, n_prefix, sph_depth, sph_leaf, sph_staged,      \
      lights16, o2w12, atlas_words, atlas_wh, n_images, atlas_h, atlas_w, lut, rows,           \
      n_prim_rows, fparams, width, height, row_base, n_rows, sqrt_spp, spp_local, n_batches,   \
      batch0, sample_base, max_depth, flags, sums, traced, stream, query

// The form for the inputs that megakernel_launch has checked.
template <bool kNoise, bool kImage, bool kSphClusters>
int dispatch(MEGA_PARAMS) {
  if (lights16 != nullptr) {
    return tris12 != nullptr
               ? launch<false, true, true, kNoise, kImage, kSphClusters>(MEGA_ARGS)
               : launch<false, false, true, kNoise, kImage, kSphClusters>(MEGA_ARGS);
  }
  if (tris12 != nullptr) return launch<false, true, false, kNoise, kImage, kSphClusters>(MEGA_ARGS);
  if (dtab8 != nullptr) {
    if constexpr (kImage) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      return launch<true, false, false, kNoise, false, kSphClusters>(MEGA_ARGS);
    }
  }
  return launch<false, false, false, kNoise, kImage, kSphClusters>(MEGA_ARGS);
}

// The noise and image twins of the clustered or dense forms.
template <bool kSphClusters>
int dispatch_textures(MEGA_PARAMS) {
  const bool image = flags & kHasImage;
  if (flags & kHasNoise) {
    return image ? dispatch<true, true, kSphClusters>(MEGA_ARGS)
                 : dispatch<true, false, kSphClusters>(MEGA_ARGS);
  }
  return image ? dispatch<false, true, kSphClusters>(MEGA_ARGS)
               : dispatch<false, false, kSphClusters>(MEGA_ARGS);
}

}  // namespace

// table8: [>= n_sph, 8] f32, 16-byte aligned, n_sph the spheres swept (the
// real ones; 0 sweeps none); dtab8: null for a static table, else the
// motion rows shaped as table8 (16-byte aligned), and times: every batch's
// shutter time, [>= batch0 + n_batches] f32; tris12: null for no
// triangles, else the soup's rows in its tree's order, [>= t8, 12] f32
// (v0, valid, e1, -, e2, -; 16-byte aligned, not with dtab8; t8: the real
// triangles), tri_nodes: the tree's [2^tri_depth - 1, 16] f32 node rows
// (16-byte aligned; tri_depth <= kTriStack), tri_ids: [t8] i32 each row's
// triangle id, tri_leaf: triangles per leaf, s_pad: the primitive id of
// triangle 0; sph_rows: null for the dense sphere sweep, else the tree over
// the spheres n_prefix .. n_sph - 1 after the n_prefix swept densely: their
// [n_sph - n_prefix, 8] f32 rows in slot order (and sph_drows their motion
// rows with dtab8), the [2^sph_depth - 1, 16] f32 node rows (all 16-byte
// aligned; sph_depth <= kSphStack), sph_ids: each slot's sphere id, i32,
// sph_leaf spheres a leaf, the first sph_staged node rows staged in shared
// memory; lights16: null for no lights, else the [n_lights, 16] f32 light
// rows (p0 p1 p2, prob, alias; not with dtab8) and o2w12 the [n_instances,
// 12] f32 objectToWorld rows; atlas_words: with kHasImage the [n_images,
// atlas_h, atlas_w] i32 packed atlas, atlas_wh its [n_images, 2] i32 sizes
// and lut the [256] f32 sRGB table (not with dtab8); rows: [n_prim_rows, 64]
// f32; fparams: [40] f32 (layout above); the frame is width x height, and
// the launch renders its rows row_base .. row_base + n_rows - 1 (the caller
// keeps them inside the frame), samples sample_base .. sample_base +
// spp_local - 1 of each pixel in each batch (numbered past the pixel's spp
// where the caller asks: each number is its own RNG stream); flags: kUseDof | kHasChecker |
// kHasEmissive | kHasNoise | kHasImage (the last two pick the noise and
// image forms); sums: [n_rows * width, 3] f32 out; traced: [n_rows * width]
// i32 out.  Launches on `stream` without synchronising and returns
// cudaGetLastError(); with query, an int[2], launches nothing and writes the
// form's resident blocks a multiprocessor and its dynamic shared memory.
extern "C" int megakernel_launch(MEGA_PARAMS) {
  if (row_base < 0 || n_rows < 0 || row_base + n_rows > height || spp_local < 1 ||
      sample_base < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tris12 != nullptr &&
      (dtab8 != nullptr || tri_ids == nullptr || (tri_depth > 0 && tri_nodes == nullptr) ||
       tri_depth < 0 || tri_depth > kTriStack || tri_leaf < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lights16 != nullptr && (dtab8 != nullptr || o2w12 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtab8 != nullptr && times == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((flags & kHasImage) && (atlas_words == nullptr || atlas_wh == nullptr || lut == nullptr ||
                            n_images < 1 || atlas_h < 1 || atlas_w < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sph_rows != nullptr) {
    const int n = n_sph - n_prefix;
    const int n_leaves = sph_leaf < 1 ? 0 : (n + sph_leaf - 1) / sph_leaf;
    if (n_prefix < 0 || n < 1 || sph_leaf < 1 || sph_depth < 0 || sph_depth > kSphStack ||
        n_leaves > (1 << sph_depth) || (sph_depth > 0 && 2 * n_leaves <= (1 << sph_depth)) ||
        sph_ids == nullptr || (sph_depth > 0 && sph_nodes == nullptr) ||
        (dtab8 != nullptr) != (sph_drows != nullptr) || sph_staged < 0 ||
        sph_staged > (1 << sph_depth) - 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return dispatch_textures<true>(MEGA_ARGS);
  }
  return dispatch_textures<false>(MEGA_ARGS);
}
#undef MEGA_ARGS
#undef MEGA_PARAMS

extern "C" const char* megakernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef K4_MEASURE
// The measuring build's counters since the last reset (kMeasureCount
// uint64, in MeasureSlot order) into out, then zeroed when reset is set.
// Waits for the device's work before it reads.
extern "C" int megakernel_measure_read(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_measure, sizeof(g_measure));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kMeasureCount] = {};
    err = cudaMemcpyToSymbol(g_measure, zero, sizeof(g_measure));
  }
  return static_cast<int>(err);
}
#endif
