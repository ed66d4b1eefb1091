// K4's raygen: the per-(pixel, sample) PCG hash and the primary ray with
// the thin-lens quirk, the device code that the fused bounce kernel
// (csrc/megakernel.cu) runs at the start of every sample and that the dev
// probe P3 (csrc/micro_raygen.cu) times alone.  Both include this file, so
// the probe times K4's own code and cannot drift from it.
//
// The plain versions are ops/rng.py (init_rng, random_float) and
// ops/camera.py get_rays_v3; the code follows their operation order, and a
// file that includes this one is built with -fmad=false (ops/_build.py),
// so every operation rounds as PyTorch's elementwise kernels do.  Where the
// torch code divides a tensor by a Python number (x / width), PyTorch's
// CUDA division multiplies by the number's float reciprocal, and so does
// get_ray.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32 roundings of the constants, as ops/rng.py holds them.
constexpr float kPiOver2 = static_cast<float>(3.14159265358979323846 / 2.0);
constexpr float kPiOver4 = static_cast<float>(3.14159265358979323846 / 4.0);

// The float parameters' layout, staged into shared memory by the caller
// (ops/megakernel.py _float_params builds it; csrc/megakernel.cu adds the
// light slots after kRecipSqrtSpp).
constexpr int kViewInv = 0;    // [16] row-major view_inverse
constexpr int kProjInv = 16;   // [16] row-major proj_inverse
constexpr int kFocal = 32;
constexpr int kAperture = 33;
constexpr int kSky = 34;       // [3]
constexpr int kRecipSqrtSpp = 37;

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

// ops/vec3.py normalize
__device__ __forceinline__ V3 normalize(V3 v) {
  const float inv = 1.0f / fmaxf(sqrtf(dot(v, v)), 1e-20f);
  return v * inv;
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

}  // namespace
