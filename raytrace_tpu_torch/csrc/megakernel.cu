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
// spp_local samples one after another in sample order (sample s_all
// belongs to batch batch0 + s_all / spp_local), each bounce by bounce until
// it ends, then starts the next: the TPU kernel's sample regeneration
// without its lane-assignment machinery, since every (pixel, sample) has
// its own RNG stream and a pixel's samples are summed in sample order.  The
// thread writes its pixel's radiance sums and bounce count once, at the
// end: no atomics, so two launches give the same bytes.
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
// JAX kernel): the soup is a [t8, 12] table in global memory, 48 bytes a
// triangle as three float4 (v0, valid), (e1, -), (e2, -), read through the
// read-only cache; at 15,360 triangles that is 737 KB, which stays in L2.
// The soup is laid out in contiguous clusters of cluster_g triangles
// (models/sphere_order.apply_triangle_order; one cluster holds the whole
// soup when it is not clustered), and the clusters' boxes, [n_clusters, 8]
// as two float4 (min, -), (max, -), at most 128 x 32 B = 4 KiB, sit in
// shared memory after the sphere table.  After the sphere sweep seeds the
// best t, a thread visits the clusters in ascending id, slab-tests each box
// with the JAX kernel's conservative pretest (megakernel.py:1262-1280:
// te <= tx, tx > T_MIN, te < best_t * 1.0001 + 1e-4, with its 1e-30 guard
// on 1/d), pruned by its running best t, and runs the dense sweep's exact
// Moller-Trumbore operations over the triangles of each cluster that
// passes, strict < over ascending ids.  A skipped cluster can hold only
// hits at t >= best t, which under strict < never win, so the result is
// the dense sweep's (ops/tri_sweep.py), bit for bit.  The hit point is
// captured in the sweep as v0 + u e1 + v e2 and the normal is the
// barycentric lerp of the fat row's n0, n1 - n0, n2 - n0 (slots 49:58),
// as engine/wavefront.py reconstruct_hit computes them.  At equal t a
// sphere keeps the hit (it is swept first), as in the JAX kernel.
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
// floor-mod of torch.remainder as fmodf with its sign fix-up, the fade
// t*t*t*(t*(t*6-15)+10) left to right, the corners in cnoise_v3's order,
// and the accurate sinf.  A turbulence is ~3,000 operations, so a noise
// hit costs about as much as 120 sphere tests.
//
// Images (template parameter kImage, instantiated with each form but the
// animated one, with and without kNoise, so the forms without images are
// compiled as before): the fat rows of a sphere hold its world-to-object
// matrix at the batch's time (slots 32:44) and its object-space centre and
// radius (44:48), so the normal is engine/wavefront.py reconstruct_hit's
// world-to-object branch: the hit point moved to object space, (p_obj - c) /
// r, taken to world space by the transposed matrix.  Where the slot a hit
// reads is in image mode (after the checker, as for noise), the thread
// computes the UV: a sphere's from its unit object normal, v = acosf(-n.y) /
// pi and u = atan2f(n.z, -n.x) / 2 pi floor-mod 1 (the object normal is
// computed again there from the hit point, by the same operations, so it is
// not held across the draws), a triangle's as the barycentric lerp of uv0,
// uv1 - uv0, uv2 - uv0 in fat-row slots 58:64; then the texel of
// sample_image_nearest, floor((u floor-mod 1) * w) clamped to [0, w - 1] (and
// the same in v), read as one 32-bit word (r | g << 8 | b << 16) through the
// read-only cache from the packed atlas (engine/arrays.pack_atlas: the images
// padded to the largest, row stride its width), each byte decoded by the
// 256-entry sRGB table staged in shared memory after the other tables.  The
// TPU kernel shades images as 1 and multiplies each sample by its primary
// hit's texel afterwards (its item mode and _texel_factor), which is exact
// only for one convex sphere seen from outside: this kernel samples the
// image at every hit, as the wavefront does.  An animated image scene
// renders with the static form, one launch per batch, because the
// world-to-object rows change with the batch's time.
//
// Spheres in clusters (template parameter kSphClusters, instantiated with
// each form above, so the dense forms are compiled as before): a scene whose
// compiler put its sphere block in Morton clusters (models/sphere_order.py:
// a dense prefix of n_prefix large spheres, then the rest in contiguous
// clusters of sph_g) is swept as the JAX kernel's gather sweep is
// (megakernel.py _sweep :1389, _sweep_sieve :1005, _cluster_rounds_gather
// :550), without its TPU mechanisms.  The prefix is swept densely; then the
// thread visits the n_sph_clusters clusters in ascending id, slab-tests each
// box (ops/megakernel.py sphere_cluster_boxes, at most 128 x 32 B in shared
// memory after the triangle boxes) with the triangles' pretest against its
// running best t, and tests the spheres of each cluster that passes with the
// dense sweep's own test (test_sphere), strict < over ascending ids.  Prefix
// ids are below cluster ids, and a skipped cluster can hold only hits at t
// above the best t, so the result is the dense sweep's (t, id), bit for bit.
// The box is first widened by a margin for the quadratic's rounding, (|o| +
// reach)^2 * 2^-19 / r_min (its w components hold reach and 2^-19 / r_min;
// ops/megakernel.py sphere_cluster_pretest derives it): the f32 test can
// report a grazing hit up to that far outside a sphere, and without it a ray
// from ~1,800 units away kept a hit that the dense sweep does not (measured
// on the lit cluster doc); at the camera of final-one-weekend it is ~0.008.
// The animated form's boxes are the union of a cluster's boxes at shutter
// times 0 and 1, which holds each sphere c0 + t dc for t in [0, 1].  The
// clustered forms read the sphere rows from global memory through the
// read-only cache (up to 16,384 spheres: 512 KiB static, 768 KiB with the
// motion rows, which stay in L2): a ray reads only the rows of the
// clusters it enters, and a staged table would lower the blocks each
// multiprocessor holds.  A warp runs the union of its threads' passing
// clusters.
//
// What bounds it: per bounce S ray-sphere tests of ~20 flops and a sqrt
// (for clustered spheres the prefix, the box pretests and the spheres of
// the clusters that pass; for triangles the box pretests and the tests of
// the clusters that pass), against one 112-byte row fetch: the fp32 ALU
// issue rate.  The first version is the simple one: a persistent work
// queue and a deeper hierarchy come later.
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

namespace {

constexpr float kTMin = 0.001f;    // ops/intersect.py T_MIN
constexpr float kTMax = 10000.0f;  // ops/intersect.py T_MAX
constexpr int kThreads = 128;
constexpr int kRowWidth = 64;      // engine/wavefront.py prepare_batch rows

// raytrace_tpu/models/compile.py MAT_TYPE_*; shading_table.py MODE_CHECKER.
constexpr int kLambertian = 1;
constexpr int kMetal = 2;
constexpr int kDielectric = 3;
constexpr int kDiffuseLight = 4;
constexpr float kModeChecker = 2.0f;
constexpr float kModeNoise = 3.0f;
constexpr float kModeImage = 1.0f;
constexpr int kLutSize = 256;  // the sRGB table's entries

// float32 roundings of the constants, as ops/rng.py and ops/nee.py hold them.
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kPiOver2 = static_cast<float>(3.14159265358979323846 / 2.0);
constexpr float kPiOver4 = static_cast<float>(3.14159265358979323846 / 4.0);

// Launch flags (bit mask).
constexpr int kUseDof = 1;
constexpr int kHasChecker = 2;
constexpr int kHasEmissive = 4;
constexpr int kHasNoise = 8;
constexpr int kHasImage = 16;

// float4 per sphere in shared memory.
template <bool kAnim>
constexpr int kStride = kAnim ? 3 : 2;

// The slab pretest's guard on 1 / d (megakernel.py:1262) and the prune
// margin on the best t (:1280).
constexpr float kSlabEps = 1e-30f;
constexpr float kPruneScale = 1.0001f;
constexpr float kPruneAdd = 1e-4f;

// Float parameters, staged into shared memory (ops/megakernel.py
// _float_params builds the same layout).
constexpr int kViewInv = 0;    // [16] row-major view_inverse
constexpr int kProjInv = 16;   // [16] row-major proj_inverse
constexpr int kFocal = 32;
constexpr int kAperture = 33;
constexpr int kSky = 34;       // [3]
constexpr int kRecipSqrtSpp = 37;
constexpr int kLightCount = 38;  // f32(number of light triangles)
constexpr int kLightArea = 39;   // their total world-space area
constexpr int kNumParams = 40;
constexpr int kLightWidth = 16;  // floats per light row (light_table16)

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// ops/vec3.py normalize
__device__ __forceinline__ V3 normalize(V3 v) {
  const float inv = 1.0f / fmaxf(sqrtf(dot(v, v)), 1e-20f);
  return v * inv;
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

// ---- ops/rng.py: the per-(pixel, sample) PCG hash, in native uint32 ----

__device__ __forceinline__ uint32_t init_rng(uint32_t batch, uint32_t s, uint32_t py,
                                             uint32_t px, uint32_t res_x, uint32_t res_y,
                                             uint32_t spp) {
  uint32_t v = batch * spp + s;
  v = v * res_y + py;
  return v * res_x + px;
}

__device__ __forceinline__ float random_float(uint32_t& state) {
  state = state * 747796405u + 1u;
  uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  word = (word >> 22) ^ word;
  return __uint2float_rn(word) / 4294967296.0f;  // f32(4294967295)
}

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

// ---- ops/camera.py get_rays_v3 (with the thin-lens quirk) ----

__device__ __forceinline__ void get_ray(uint32_t& state, const float* prm, int px, int py,
                                        int si, int sj, int width, int height, bool use_dof,
                                        V3& origin, V3& dir) {
  const float recip = prm[kRecipSqrtSpp];
  const float rx = random_float(state);
  const float ry = random_float(state);
  const float ox_pix = (static_cast<float>(si) + rx) * recip - 0.5f;
  const float oy_pix = (static_cast<float>(sj) + ry) * recip - 0.5f;
  const float inv_w = 1.0f / static_cast<float>(width);
  const float inv_h = 1.0f / static_cast<float>(height);
  const float dx = ((static_cast<float>(px) + 0.5f + ox_pix) * inv_w) * 2.0f - 1.0f;
  const float dy = ((static_cast<float>(py) + 0.5f + oy_pix) * inv_h) * 2.0f - 1.0f;

  const float* pi = prm + kProjInv;
  const float* vi = prm + kViewInv;
  const V3 target = {pi[0] * dx + pi[1] * dy + pi[2] + pi[3],
                     pi[4] * dx + pi[5] * dy + pi[6] + pi[7],
                     pi[8] * dx + pi[9] * dy + pi[10] + pi[11]};
  const V3 tn = normalize(target);
  dir = {vi[0] * tn.x + vi[1] * tn.y + vi[2] * tn.z,
         vi[4] * tn.x + vi[5] * tn.y + vi[6] * tn.z,
         vi[8] * tn.x + vi[9] * tn.y + vi[10] * tn.z};
  origin = {vi[3], vi[7], vi[11]};
  if (!use_dof) return;

  // rng.sample_disk_concentric_xy
  const float u1 = random_float(state);
  const float u2 = random_float(state);
  const float ux = 2.0f * u1 - 1.0f;
  const float uy = 2.0f * u2 - 1.0f;
  const bool degenerate = ux == 0.0f && uy == 0.0f;
  const bool x_major = fabsf(ux) > fabsf(uy);
  const float r = x_major ? ux : uy;
  const float theta = x_major ? kPiOver4 * (uy / (ux == 0.0f ? 1.0f : ux))
                              : kPiOver2 - kPiOver4 * (ux / (uy == 0.0f ? 1.0f : uy));
  const float lx = degenerate ? 0.0f : r * cosf(theta);
  const float ly = degenerate ? 0.0f : r * sinf(theta);
  const float half_ap = prm[kAperture] / 2.0f;
  // QUIRK (ray_gen.glsl:554-558): world x/y offset scaled by NDC d.
  origin.x = origin.x + lx * half_ap * dx;
  origin.y = origin.y + ly * half_ap * dy;
  const float f = prm[kFocal];
  const V3 fp = {f * tn.x, f * tn.y, f * tn.z};
  const V3 fpw = {vi[0] * fp.x + vi[1] * fp.y + vi[2] * fp.z + vi[3],
                  vi[4] * fp.x + vi[5] * fp.y + vi[6] * fp.z + vi[7],
                  vi[8] * fp.x + vi[9] * fp.y + vi[10] * fp.z + vi[11]};
  dir = normalize(fpw - origin);
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

__device__ __forceinline__ float mod289(float x) { return x - floorf(x * kInv289) * 289.0f; }

__device__ __forceinline__ float permute(float x) { return mod289(((x * 34.0f) + 10.0f) * x); }

// torch.remainder(x, 1.0): fmod, plus the divisor where the result's sign
// differs from the divisor's
__device__ __forceinline__ float rem1(float x) {
  const float m = fmodf(x, 1.0f);
  return m < 0.0f ? m + 1.0f : m;
}

__device__ __forceinline__ float fade(float t) {
  return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f);
}

__device__ __forceinline__ float mix(float a, float b, float t) { return a + (b - a) * t; }

// perlin._grads of one hashed corner, scaled by _taylor_inv_sqrt of its
// squared length, dotted with the corner's offset (xx, yy, zz)
__device__ __forceinline__ float corner(float hash, float xx, float yy, float zz) {
  float gx = hash * kInv7;
  float gy = rem1(floorf(gx) * kInv7) - 0.5f;
  gx = rem1(gx);
  const float gz = 0.5f - fabsf(gx) - fabsf(gy);
  const float sz = gz <= 0.0f ? 1.0f : 0.0f;
  gx = gx - sz * ((gx >= 0.0f ? 1.0f : 0.0f) - 0.5f);
  gy = gy - sz * ((gy >= 0.0f ? 1.0f : 0.0f) - 0.5f);
  const float norm = kTaylor0 - kTaylor1 * (gx * gx + gy * gy + gz * gz);
  return (gx * norm) * xx + (gy * norm) * yy + (gz * norm) * zz;
}

// perlin.cnoise_v3.  Each (x, y) corner's two z corners are mixed along z
// as soon as both are known, which computes the same mixes in fewer
// registers.
__device__ __forceinline__ float cnoise(float px, float py, float pz) {
  const float fpx = floorf(px);
  const float fpy = floorf(py);
  const float fpz = floorf(pz);
  const float x0i = mod289(fpx), y0i = mod289(fpy), z0i = mod289(fpz);
  const float x1i = mod289(fpx + 1.0f), y1i = mod289(fpy + 1.0f), z1i = mod289(fpz + 1.0f);
  const float x0 = px - fpx, y0 = py - fpy, z0 = pz - fpz;
  const float x1 = x0 - 1.0f, y1 = y0 - 1.0f, z1 = z0 - 1.0f;
  const float fz = fade(z0);
  float nz[4];  // corners (x0,y0) (x1,y0) (x0,y1) (x1,y1), as cnoise_v3's
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float ixy = permute(permute(c & 1 ? x1i : x0i) + (c & 2 ? y1i : y0i));
    const float xx = c & 1 ? x1 : x0;
    const float yy = c & 2 ? y1 : y0;
    const float n0 = corner(permute(ixy + z0i), xx, yy, z0);
    const float n1 = corner(permute(ixy + z1i), xx, yy, z1);
    nz[c] = mix(n0, n1, fz);
  }
  const float fy = fade(y0);
  const float fx = fade(x0);
  return kNoiseGain * mix(mix(nz[0], nz[2], fy), mix(nz[1], nz[3], fy), fx);
}

// perlin.turbulence_v3(p, 7)
__device__ __forceinline__ float turbulence(V3 p) {
  float accum = 0.0f;
  float weight = 1.0f;
#pragma unroll 1
  for (int i = 0; i < kOctaves; ++i) {
    accum = accum + weight * cnoise(p.x, p.y, p.z);
    weight *= 0.5f;
    p = p * 2.0f;
  }
  return fabsf(accum);
}

// ---- images: the sphere's world-to-object branch, its UV, the sampler ----

// engine/wavefront.py reconstruct_hit's object normal (p_obj - c) / r of a
// sphere whose fat row holds its world-to-object matrix (slots 32:44) and
// its object-space centre and radius (44:48), at world point p
__device__ __forceinline__ V3 object_normal(const float* __restrict__ row, V3 p) {
  float m[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) m[k] = __ldg(row + 32 + k);
  const V3 po = apply_point(m, p);
  const float r = __ldg(row + 47);
  const float inv_r = 1.0f / (r == 0.0f ? 1.0f : r);
  return {(po.x - __ldg(row + 44)) * inv_r, (po.y - __ldg(row + 45)) * inv_r,
          (po.z - __ldg(row + 46)) * inv_r};
}

// ops/vec3.py mat34_apply_transposed_vec: v M of the row's 3x4 matrix
__device__ __forceinline__ V3 apply_transposed(const float* __restrict__ row, V3 v) {
  float m[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) m[k] = __ldg(row + 32 + k);
  return {m[0] * v.x + m[4] * v.y + m[8] * v.z, m[1] * v.x + m[5] * v.y + m[9] * v.z,
          m[2] * v.x + m[6] * v.y + m[10] * v.z};
}

// The packed image atlas (engine/arrays.pack_atlas) and what samples it.
struct Atlas {
  const int* __restrict__ words;  // [n, h, w] r | g << 8 | b << 16
  const int* __restrict__ wh;     // [n, 2] each image's width and height
  int n, h, w;                    // images, and the padded height and width
  const float* lut;               // the sRGB table, in shared memory
};

// textures.sample_image_nearest of image `aux` (clipped to the atlas) at (u, v)
__device__ __forceinline__ V3 sample_image(const Atlas& at, float aux, float u, float v) {
  const int idx = min(max(static_cast<int>(aux), 0), at.n - 1);
  const int w = __ldg(at.wh + 2 * idx);
  const int h = __ldg(at.wh + 2 * idx + 1);
  const int x = min(max(static_cast<int>(floorf(rem1(u) * static_cast<float>(w))), 0), w - 1);
  const int y = min(max(static_cast<int>(floorf(rem1(v) * static_cast<float>(h))), 0), h - 1);
  const uint32_t word = static_cast<uint32_t>(
      __ldg(at.words + (static_cast<size_t>(idx) * at.h + y) * at.w + x));
  return {at.lut[word & 0xffu], at.lut[(word >> 8) & 0xffu], at.lut[(word >> 16) & 0xffu]};
}

// shading._eval_property in the noise and image forms: the slot (cols
// base:base+3, its mode at mode, its aux after it), or the row's checker's
// even or odd slot where the mode says so; a slot in noise mode is the
// marble, one in image mode the texel at the hit's UV (a sphere's from its
// object normal at p, a triangle's the lerp of fat-row slots 58:64).
template <bool kNoise, bool kImage>
__device__ __forceinline__ V3 eval_slot(const float* __restrict__ row, int base, int mode,
                                        bool has_checker, V3 p, bool is_sphere, float bu,
                                        float bv, const Atlas& atlas) {
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
      const float v = 0.5f * (1.0f + sinf(__ldg(row + aux) * p.z + 10.0f * turbulence(p)));
      return {v, v, v};
    }
  }
  if constexpr (kImage) {
    if (m == kModeImage) {
      float u, v;
      if (is_sphere) {
        const V3 nn = normalize(object_normal(row, p));
        v = acosf(fminf(fmaxf(-nn.y, -1.0f), 1.0f)) * (1.0f / kPi);
        u = rem1(atan2f(nn.z, -nn.x) * (1.0f / kTwoPi));
      } else {
        u = __ldg(row + 58) + bu * __ldg(row + 60) + bv * __ldg(row + 62);
        v = __ldg(row + 59) + bu * __ldg(row + 61) + bv * __ldg(row + 63);
      }
      return sample_image(atlas, __ldg(row + aux), u, v);
    }
  }
  return load3(row, base);
}

// 1 / d for the slab pretest, with |d| kept at least kSlabEps
// (megakernel.py:1264-1266).
__device__ __forceinline__ float slab_inv(float dx) {
  return 1.0f / (fabsf(dx) < kSlabEps ? (dx < 0.0f ? -kSlabEps : kSlabEps) : dx);
}

// The slab pretest of one cluster box (min, max) against the ray, pruned by
// its best t so far (megakernel.py:1262-1280).
__device__ __forceinline__ bool box_passes(float4 mn, float4 mx, V3 o, float ivx, float ivy,
                                           float ivz, float best_t) {
  float a0 = (mn.x - o.x) * ivx;
  float a1 = (mx.x - o.x) * ivx;
  float te = fminf(a0, a1);
  float tx = fmaxf(a0, a1);
  a0 = (mn.y - o.y) * ivy;
  a1 = (mx.y - o.y) * ivy;
  te = fmaxf(te, fminf(a0, a1));
  tx = fminf(tx, fmaxf(a0, a1));
  a0 = (mn.z - o.z) * ivz;
  a1 = (mx.z - o.z) * ivz;
  te = fmaxf(te, fminf(a0, a1));
  tx = fminf(tx, fmaxf(a0, a1));
  return te <= tx && tx > kTMin && te < best_t * kPruneScale + kPruneAdd;
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

// The same sphere read from the tables in global memory through the
// read-only cache: (c, r) and k from the [s8, 8] table, (dc) and (k1, k2)
// from the motion rows.
template <bool kAnim>
__device__ __forceinline__ void global_sphere(const float4* __restrict__ table,
                                              const float4* __restrict__ dtable, int j,
                                              float tcur, float4& sph, float& k) {
  const float4 c0 = __ldg(table + 2 * j);
  const float k0 = __ldg(reinterpret_cast<const float*>(table + 2 * j + 1));
  if constexpr (kAnim) {
    const float4 dc = __ldg(dtable + 2 * j);
    const float2 kk = __ldg(reinterpret_cast<const float2*>(dtable + 2 * j + 1));
    sph = make_float4(c0.x + tcur * dc.x, c0.y + tcur * dc.y, c0.z + tcur * dc.z, c0.w);
    k = k0 + tcur * (kk.x + tcur * kk.y);
  } else {
    sph = c0;
    k = k0;
  }
}

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

// The closest-hit quadratic against sphere j (csrc/sphere_sweep.cu and
// ops/spheres.py intersect_spheres_world), and the strict < update of the
// best hit.  d_dot_o, a, o_sq and inv_a are the ray's.
__device__ __forceinline__ void test_sphere(float4 sph, float k, V3 o, V3 d, float d_dot_o,
                                            float a, float o_sq, float inv_a, int j,
                                            float& best_t, int& best_id) {
  const float dc = sph.x * d.x + sph.y * d.y + sph.z * d.z;
  const float oc = sph.x * o.x + sph.y * o.y + sph.z * o.z;
  const float h = d_dot_o - dc;
  const float c2 = o_sq - 2.0f * oc + k;
  const float disc = h * h - a * c2;
  const bool ok = disc >= 0.0f && sph.w > 0.0f;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t1 = (-h - sq) * inv_a;
  const float t2 = (-h + sq) * inv_a;
  const bool t1_ok = ok && t1 > kTMin && t1 < kTMax;
  const bool t2_ok = ok && t2 > kTMin && t2 < kTMax;
  const float t = t1_ok ? t1 : (t2_ok ? t2 : kTMax);
  if (t < best_t) {
    best_t = t;
    best_id = j;
  }
}

// The clustered spheres against one ray, after the prefix: see the header.
template <bool kAnim>
__device__ __forceinline__ void sweep_sphere_clusters(
    const float4* __restrict__ table, const float4* __restrict__ dtable, const float4* boxes,
    int n_clusters, int g, int n_prefix, int n_sph, float tcur, V3 o, V3 d, float d_dot_o,
    float a, float o_sq, float inv_a, float& best_t, int& best_id) {
  const float ivx = slab_inv(d.x);
  const float ivy = slab_inv(d.y);
  const float ivz = slab_inv(d.z);
  const float onorm = sqrtf(o_sq);
  for (int c = 0; c < n_clusters; ++c) {
    const float4 mn = boxes[2 * c];
    const float4 mx = boxes[2 * c + 1];
    // The rounding margin: (|o| + reach)^2 * SPHERE_ROUNDING / r_min.
    const float s = onorm + mx.w;
    const float m = s * s * mn.w;
    if (!box_passes(make_float4(mn.x - m, mn.y - m, mn.z - m, 0.0f),
                    make_float4(mx.x + m, mx.y + m, mx.z + m, 0.0f), o, ivx, ivy, ivz, best_t)) {
      continue;
    }
    const int j1 = min(n_prefix + (c + 1) * g, n_sph);
    for (int j = n_prefix + c * g; j < j1; ++j) {
      float4 sph;
      float k;
      global_sphere<kAnim>(table, dtable, j, tcur, sph, k);
      test_sphere(sph, k, o, d, d_dot_o, a, o_sq, inv_a, j, best_t, best_id);
    }
  }
}

// The triangle soup against one ray, after the sphere sweep: see the
// header.  Updates the best t and id, the barycentrics and the hit point.
__device__ __forceinline__ void sweep_tris(const float4* __restrict__ tris, int t8,
                                           const float4* boxes, int n_clusters, int cluster_g,
                                           int s_pad, V3 o, V3 d, float& best_t, int& best_id,
                                           float& best_u, float& best_v, V3& tp) {
  const float ivx = slab_inv(d.x);
  const float ivy = slab_inv(d.y);
  const float ivz = slab_inv(d.z);
  for (int c = 0; c < n_clusters; ++c) {
    if (!box_passes(boxes[2 * c], boxes[2 * c + 1], o, ivx, ivy, ivz, best_t)) continue;
    const int j1 = min((c + 1) * cluster_g, t8);
    for (int j = c * cluster_g; j < j1; ++j) {
      // csrc/tri_sweep.cu's operations, in its order.
      const float4 v0 = __ldg(tris + 3 * j);
      const float4 e1 = __ldg(tris + 3 * j + 1);
      const float4 e2 = __ldg(tris + 3 * j + 2);
      const float px = d.y * e2.z - d.z * e2.y;
      const float py = d.z * e2.x - d.x * e2.z;
      const float pz = d.x * e2.y - d.y * e2.x;
      const float det = e1.x * px + e1.y * py + e1.z * pz;
      const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
      const float sx = o.x - v0.x;
      const float sy = o.y - v0.y;
      const float sz = o.z - v0.z;
      const float u = (sx * px + sy * py + sz * pz) * inv_det;
      const float qx = sy * e1.z - sz * e1.y;
      const float qy = sz * e1.x - sx * e1.z;
      const float qz = sx * e1.y - sy * e1.x;
      const float v = (d.x * qx + d.y * qy + d.z * qz) * inv_det;
      const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
      const bool ok = v0.w > 0.0f && det != 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                      t > kTMin && t < kTMax;
      if (ok && t < best_t) {
        best_t = t;
        best_id = s_pad + j;
        best_u = u;
        best_v = v;
        tp = {v0.x + u * e1.x + v * e2.x, v0.y + u * e1.y + v * e2.y,
              v0.z + u * e1.z + v * e2.z};
      }
    }
  }
}

// ---- the kernel ----

template <bool kAnim, bool kTris, bool kLights, bool kNoise, bool kImage, bool kSphClusters>
__global__ void __launch_bounds__(kThreads)
megakernel(const float4* __restrict__ table, const float4* __restrict__ dtable,
           const float* __restrict__ times, int n_sph, const float4* __restrict__ tris, int t8,
           const float4* __restrict__ tri_boxes, int n_clusters, int cluster_g, int s_pad,
           const float4* __restrict__ sph_boxes, int n_prefix, int sph_g, int n_sph_clusters,
           const float* __restrict__ lights, const float* __restrict__ o2w,
           const int* __restrict__ atlas_words, const int* __restrict__ atlas_wh, int n_images,
           int atlas_h, int atlas_w, const float* __restrict__ lut,
           const float* __restrict__ rows, int n_rows, const float* __restrict__ fparams,
           int width, int height, int sqrt_spp, int spp_local, int n_batches, int batch0,
           int sample_base, int max_depth, int flags, float* __restrict__ sums,
           int* __restrict__ traced_out) {
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
  // Triangle cluster c's box: boxes[2c] = (min, -), boxes[2c+1] = (max, -).
  float4* boxes = tbl + kStride<kAnim> * n_staged;
  // Sphere cluster c's box, the same way, after them.
  float4* sboxes = boxes + (kTris ? 2 * n_clusters : 0);
  // The sRGB table, after the boxes.
  float* lut_s = reinterpret_cast<float*>(sboxes + (kSphClusters ? 2 * n_sph_clusters : 0));
  for (int j = threadIdx.x; j < kNumParams; j += kThreads) prm[j] = fparams[j];
  if constexpr (kTris) {
    for (int j = threadIdx.x; j < 2 * n_clusters; j += kThreads) boxes[j] = tri_boxes[j];
  }
  if constexpr (kSphClusters) {
    for (int j = threadIdx.x; j < 2 * n_sph_clusters; j += kThreads) sboxes[j] = sph_boxes[j];
  }
  if constexpr (kImage) {
    for (int j = threadIdx.x; j < kLutSize; j += kThreads) lut_s[j] = lut[j];
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

  const int n_pix = width * height;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= n_pix) return;
  const int px = pix % width;
  const int py = pix / width;
  const bool use_dof = flags & kUseDof;
  const bool has_checker = flags & kHasChecker;
  const bool has_emissive = flags & kHasEmissive;
  const uint32_t spp = static_cast<uint32_t>(sqrt_spp * sqrt_spp);
  const V3 bg = {prm[kSky], prm[kSky + 1], prm[kSky + 2]};
  const int n_samples = n_batches * spp_local;
  const Atlas atlas = {atlas_words, atlas_wh, n_images, atlas_h, atlas_w, lut_s};

  float sum_x = 0.0f, sum_y = 0.0f, sum_z = 0.0f;
  int traced = 0;
  for (int s_all = 0; s_all < n_samples; ++s_all) {
    const int batch = batch0 + s_all / spp_local;
    const int s = s_all % spp_local + sample_base;
    const float tcur = kAnim ? __ldg(times + batch) : 0.0f;  // shutter time
    uint32_t state = init_rng(static_cast<uint32_t>(batch), static_cast<uint32_t>(s),
                              static_cast<uint32_t>(py), static_cast<uint32_t>(px),
                              static_cast<uint32_t>(width), static_cast<uint32_t>(height), spp);
    V3 o, d;
    get_ray(state, prm, px, py, s % sqrt_spp, s / sqrt_spp, width, height, use_dof, o, d);
    V3 thr = {1.0f, 1.0f, 1.0f};
    V3 acc = {0.0f, 0.0f, 0.0f};

    for (int depth = 0; depth < max_depth; ++depth) {
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
      // then the clusters.
      const int n_dense = kSphClusters ? n_prefix : n_sph;
      for (int j = 0; j < n_dense; ++j) {
        float4 sph;
        float k;
        fetch_sphere<kAnim, kSphClusters>(tbl, table, dtable, j, tcur, sph, k);
        test_sphere(sph, k, o, d, d_dot_o, a, o_sq, inv_a, j, best_t, best_id);
      }
      if constexpr (kSphClusters) {
        sweep_sphere_clusters<kAnim>(table, dtable, sboxes, n_sph_clusters, sph_g, n_prefix,
                                     n_sph, tcur, o, d, d_dot_o, a, o_sq, inv_a, best_t, best_id);
      }
      float bu = 0.0f, bv = 0.0f;
      V3 tp = {0.0f, 0.0f, 0.0f};
      if constexpr (kTris) {
        sweep_tris(tris, t8, boxes, n_clusters, cluster_g, s_pad, o, d, best_t, best_id, bu,
                   bv, tp);
      }
      if (best_t >= kTMax) {  // miss: the sky, and the sample ends
        acc = acc + thr * bg;
        break;
      }
      const float* __restrict__ row =
          rows + static_cast<size_t>(min(max(best_id, 0), n_rows - 1)) * kRowWidth;

      // Hit reconstruction (wavefront.reconstruct_hit): a sphere's point
      // o + t d and its direct world normal (with images, the normal of the
      // world-to-object branch), or a triangle's captured point and lerped
      // normal.
      const bool is_sphere = !kTris || best_id < s_pad;
      V3 p;
      V3 n;
      if (is_sphere) {
        p = {o.x + d.x * best_t, o.y + d.y * best_t, o.z + d.z * best_t};
        if constexpr (kImage) {
          n = normalize(apply_transposed(row, object_normal(row, p)));
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
      const V3 normal = front ? n : -n;

      // shading.scatter_and_emit_v3 (fat rows); the draws are unconditional.
      const int mat = static_cast<int>(__ldg(row + 0));
      const V3 fuzz_unit = random_unit(state);
      const float diel_u = random_float(state);
      const bool is_lamb = mat == kLambertian;
      const bool is_metal = mat == kMetal;
      const bool is_diel = mat == kDielectric;
      const bool is_light = mat == kDiffuseLight;

      V3 attenuation = {0.0f, 0.0f, 0.0f};
      V3 skip_dir = {0.0f, 0.0f, 0.0f};
      bool scattered = false;
      V3 emit = {0.0f, 0.0f, 0.0f};
      if constexpr (kNoise || kImage) {
        // The one slot this hit reads, evaluated once: one call site
        // holds the turbulence and the texel read.
        const bool reads_albedo = is_lamb || is_metal;
        if (reads_albedo || (has_emissive && is_light && front)) {
          const V3 v = eval_slot<kNoise, kImage>(row, reads_albedo ? 2 : 8,
                                                 reads_albedo ? 11 : 15, has_checker, p,
                                                 is_sphere, bu, bv, atlas);
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
      if (!scattered) break;  // absorbed

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
    }
    sum_x += acc.x;
    sum_y += acc.y;
    sum_z += acc.z;
  }
  sums[3 * pix + 0] = sum_x;
  sums[3 * pix + 1] = sum_y;
  sums[3 * pix + 2] = sum_z;
  traced_out[pix] = traced;
}

template <bool kAnim, bool kTris, bool kLights, bool kNoise, bool kImage, bool kSphClusters>
int launch(const void* table8, const void* dtab8, const void* times, int n_sph, const void* tris12,
           int t8, const void* tri_boxes, int n_clusters, int cluster_g, int s_pad,
           const void* sph_boxes, int n_prefix, int sph_g, int n_sph_clusters,
           const void* lights16, const void* o2w12, const void* atlas_words,
           const void* atlas_wh, int n_images, int atlas_h, int atlas_w, const void* lut,
           const void* rows, int n_rows, const void* fparams, int width, int height,
           int sqrt_spp, int spp_local, int n_batches, int batch0, int sample_base,
           int max_depth, int flags, void* sums, void* traced, void* stream) {
  const int n_pix = width * height;
  if (n_pix <= 0) return static_cast<int>(cudaGetLastError());
  const size_t n_staged = kSphClusters ? 0 : static_cast<size_t>(n_sph);
  const size_t smem = (kNumParams + 4 * kStride<kAnim> * n_staged +
                       (kTris ? 8 * static_cast<size_t>(n_clusters) : 0) +
                       (kSphClusters ? 8 * static_cast<size_t>(n_sph_clusters) : 0) +
                       (kImage ? kLutSize : 0)) *
                      sizeof(float);
  auto* kernel = megakernel<kAnim, kTris, kLights, kNoise, kImage, kSphClusters>;
  if (smem > 48 * 1024) {  // above the default limit it must be opted into
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table8), static_cast<const float4*>(dtab8),
      static_cast<const float*>(times), n_sph, static_cast<const float4*>(tris12), t8,
      static_cast<const float4*>(tri_boxes), n_clusters, cluster_g, s_pad,
      static_cast<const float4*>(sph_boxes), n_prefix, sph_g, n_sph_clusters,
      static_cast<const float*>(lights16), static_cast<const float*>(o2w12),
      static_cast<const int*>(atlas_words), static_cast<const int*>(atlas_wh), n_images, atlas_h,
      atlas_w, static_cast<const float*>(lut), static_cast<const float*>(rows), n_rows,
      static_cast<const float*>(fparams), width, height, sqrt_spp, spp_local, n_batches, batch0,
      sample_base, max_depth, flags, static_cast<float*>(sums), static_cast<int*>(traced));
  return static_cast<int>(cudaGetLastError());
}

#define MEGA_PARAMS                                                                            \
  const void *table8, const void *dtab8, const void *times, int n_sph, const void *tris12,     \
      int t8, const void *tri_boxes, int n_clusters, int cluster_g, int s_pad,                 \
      const void *sph_boxes, int n_prefix, int sph_g, int n_sph_clusters,                      \
      const void *lights16, const void *o2w12, const void *atlas_words, const void *atlas_wh,  \
      int n_images, int atlas_h, int atlas_w, const void *lut, const void *rows, int n_rows,   \
      const void *fparams, int width, int height, int sqrt_spp, int spp_local, int n_batches, \
      int batch0, int sample_base, int max_depth, int flags, void *sums, void *traced,         \
      void *stream

#define MEGA_ARGS                                                                            \
  table8, dtab8, times, n_sph, tris12, t8, tri_boxes, n_clusters, cluster_g, s_pad, sph_boxes, \
      n_prefix, sph_g, n_sph_clusters, lights16, o2w12, atlas_words, atlas_wh,                 \
      n_images, atlas_h, atlas_w, lut, rows, n_rows, fparams, width, height, sqrt_spp,         \
      spp_local, n_batches, batch0, sample_base, max_depth, flags, sums, traced, stream

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
// triangles, else the [t8, 12] f32 soup (v0, valid, e1, -, e2, -; 16-byte
// aligned, not with dtab8; t8: the rows swept, the real triangles),
// tri_boxes: [n_clusters, 8] f32 cluster boxes (min, -, max, -), cluster_g:
// triangles per cluster, s_pad: the primitive id of triangle 0; sph_boxes:
// null for the dense sphere sweep, else the [n_sph_clusters, 8] f32 boxes
// (16-byte aligned, 1 <= n_sph_clusters <= 128) of the clusters of sph_g
// spheres after the n_prefix swept densely (their rows read from global
// memory); lights16: null for no lights, else the [n_lights, 16] f32 light
// rows (p0 p1 p2, prob, alias; not with dtab8) and o2w12 the [n_instances,
// 12] f32 objectToWorld rows; atlas_words: with kHasImage the [n_images,
// atlas_h, atlas_w] i32 packed atlas, atlas_wh its [n_images, 2] i32 sizes
// and lut the [256] f32 sRGB table (not with dtab8); rows: [n_rows, 64] f32;
// fparams: [40] f32 (layout above); flags: kUseDof | kHasChecker |
// kHasEmissive | kHasNoise | kHasImage (the last two pick the noise and
// image forms); sums: [height * width, 3] f32 out; traced: [height * width]
// i32 out.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int megakernel_launch(MEGA_PARAMS) {
  if (tris12 != nullptr && (dtab8 != nullptr || tri_boxes == nullptr || cluster_g <= 0)) {
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
  if (sph_boxes != nullptr) {
    if (n_sph_clusters < 1 || n_sph_clusters > 128 || sph_g < 1 || n_prefix < 0 ||
        n_prefix + n_sph_clusters * sph_g < n_sph) {
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
