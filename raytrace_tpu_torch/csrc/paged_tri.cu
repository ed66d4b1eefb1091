// Closest hit of rays against a paged triangle soup of any size (K3).
//
// Replaces the TPU kernel raytrace_tpu/ops/pallas_paged_tri.py::_paged_kernel
// (launched by paged_tri_sweep).  The soup is in Morton order of its
// centroids, cut into clusters of g contiguous triangles and pages of c
// clusters (ops/paged_tri.py build_page_tables).  For each ray it computes
// what the dense sweep over the same soup computes (csrc/tri_sweep.cu):
// (t, id, u, v) of the nearest hit, ties to the lowest id, or
// (T_MAX, -1, 0, 0) on a miss or for an inactive ray.  A page whose box the
// ray misses, or enters at or beyond best_t * 1.0001 + 1e-4, is skipped
// whole; so is a cluster by the same test on its box.  The boxes are
// widened (1e-5 + 1e-5 max|coordinate|), so a skipped triangle can hold no
// hit closer than the best one, and a skipped cluster comes after the best
// hit's, so it could not win a tie either.  The TPU kernel prunes clusters
// by the best t at the page's start; the running best t here skips more
// and gives the same hit.
//
// What bounds it: the work depends on the data.  For each ray, one slab
// test per page, one per cluster of every page whose box passes, and g
// Moller-Trumbore tests per cluster whose box passes; against that, the
// bytes are the rays (25 B in, 16 B out) and the tables read once (48 B a
// triangle).  On final-one-weekend's 2,033,920-triangle mesh the tests far
// outweigh the bytes, so the kernel is bound by fp32 issue; chip_smoke.py
// counts the tests on a subset of rays for its bound.
//
// Design (first version, simple and right): one thread per ray in
// 128-thread blocks; no shared memory.  Every thread walks the pages and
// each page's real clusters in ascending order, so the threads of a warp
// read the same page box, cluster box and triangle rows at the same time
// (one broadcast load through the read-only cache, __ldg).  Clusters past
// the soup's real ones are never read: the loop stops at the real cluster
// count, and the last cluster stops at the real triangle count.  Rays per
// launch are not capped; indices are 32-bit (the wrapper checks the soup
// and the ray count fit).
//
// Bits: built with -fmad=false (ops/_build.py KERNEL_FLAGS), and each
// triangle test is csrc/tri_sweep.cu's in its operation order, so the
// kernel matches the dense sweep K2 and its own plain PyTorch version
// (ops/paged_tri.py paged_tri_sweep_reference) bit for bit on the card.

#include <cuda_runtime.h>

namespace {

constexpr float kTMin = 0.001f;    // ops/intersect.py T_MIN
constexpr float kTMax = 10000.0f;  // ops/intersect.py T_MAX
constexpr float kSlabEps = 1e-30f; // ops/paged_tri.py _SLAB_EPS
constexpr int kThreads = 128;

__device__ __forceinline__ float slab_inv(float d) {
  return 1.0f / (fabsf(d) < kSlabEps ? (d < 0.0f ? -kSlabEps : kSlabEps) : d);
}

// The slab test of the ray against box[0] = (min xyz, -), box[1] =
// (max xyz, -), pruned by the ray's best t (the TPU kernel's :226-236).
__device__ __forceinline__ bool box_passes(const float4* __restrict__ box,
                                           float ox, float oy, float oz,
                                           float ivx, float ivy, float ivz,
                                           float best_t) {
  const float4 lo = __ldg(box);
  const float4 hi = __ldg(box + 1);
  float a0 = (lo.x - ox) * ivx;
  float a1 = (hi.x - ox) * ivx;
  float te = fminf(a0, a1);
  float tx = fmaxf(a0, a1);
  a0 = (lo.y - oy) * ivy;
  a1 = (hi.y - oy) * ivy;
  te = fmaxf(te, fminf(a0, a1));
  tx = fminf(tx, fmaxf(a0, a1));
  a0 = (lo.z - oz) * ivz;
  a1 = (hi.z - oz) * ivz;
  te = fmaxf(te, fminf(a0, a1));
  tx = fminf(tx, fmaxf(a0, a1));
  return te <= tx && tx > kTMin && te < best_t * 1.0001f + 1e-4f;
}

__global__ void __launch_bounds__(kThreads)
paged_tri_kernel(const float4* __restrict__ tris, int n_tris,
                 const float4* __restrict__ boxes, int n_clusters,
                 const float4* __restrict__ page_boxes, int n_pages, int g,
                 int c, const float* __restrict__ ox,
                 const float* __restrict__ oy, const float* __restrict__ oz,
                 const float* __restrict__ dx, const float* __restrict__ dy,
                 const float* __restrict__ dz,
                 const unsigned char* __restrict__ alive, int n,
                 float* __restrict__ t_out, int* __restrict__ id_out,
                 float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float best_t = kTMax, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  if (alive[i] != 0) {
    const float rox = ox[i], roy = oy[i], roz = oz[i];
    const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
    const float ivx = slab_inv(rdx), ivy = slab_inv(rdy),
                ivz = slab_inv(rdz);
    for (int p = 0; p < n_pages; ++p) {
      if (!box_passes(page_boxes + 2 * p, rox, roy, roz, ivx, ivy, ivz,
                      best_t)) {
        continue;
      }
      const int c_end = min((p + 1) * c, n_clusters);
      for (int ci = p * c; ci < c_end; ++ci) {
        if (!box_passes(boxes + 2 * ci, rox, roy, roz, ivx, ivy, ivz,
                        best_t)) {
          continue;
        }
        const int j_end = min((ci + 1) * g, n_tris);
        for (int j = ci * g; j < j_end; ++j) {
          // (v0, valid), (e1, -), (e2, -): ops/megakernel.tri_table12.
          const float4 v0 = __ldg(tris + 3 * j);
          const float4 e1 = __ldg(tris + 3 * j + 1);
          const float4 e2 = __ldg(tris + 3 * j + 2);
          const float px = rdy * e2.z - rdz * e2.y;
          const float py = rdz * e2.x - rdx * e2.z;
          const float pz = rdx * e2.y - rdy * e2.x;
          const float det = e1.x * px + e1.y * py + e1.z * pz;
          const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
          const float tx = rox - v0.x;
          const float ty = roy - v0.y;
          const float tz = roz - v0.z;
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * e1.z - tz * e1.y;
          const float qy = tz * e1.x - tx * e1.z;
          const float qz = tx * e1.y - ty * e1.x;
          const float v = (rdx * qx + rdy * qy + rdz * qz) * inv_det;
          const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
          const bool ok = det != 0.0f && u >= 0.0f && v >= 0.0f &&
                          u + v <= 1.0f && t > kTMin && t < kTMax;
          if (ok && t < best_t) {
            best_t = t;
            best_id = j;
            best_u = u;
            best_v = v;
          }
        }
      }
    }
  }
  t_out[i] = best_t;
  id_out[i] = best_id;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

}  // namespace

// tris: [>= n_tris, 12] f32; boxes: [n_clusters, 8] f32; page_boxes:
// [n_pages, 8] f32 (all 16-byte aligned); ox..dz: [n] f32; alive: [n] bool;
// t, u, v: [n] f32 out; id: [n] i32 out.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
extern "C" int paged_tri_launch(const void* tris, int n_tris,
                                const void* boxes, int n_clusters,
                                const void* page_boxes, int n_pages, int g,
                                int c, const void* ox, const void* oy,
                                const void* oz, const void* dx,
                                const void* dy, const void* dz,
                                const void* alive, int n, void* t, void* id,
                                void* u, void* v, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    paged_tri_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(tris), n_tris,
        static_cast<const float4*>(boxes), n_clusters,
        static_cast<const float4*>(page_boxes), n_pages, g, c,
        static_cast<const float*>(ox), static_cast<const float*>(oy),
        static_cast<const float*>(oz), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(dz),
        static_cast<const unsigned char*>(alive), n, static_cast<float*>(t),
        static_cast<int*>(id), static_cast<float*>(u),
        static_cast<float*>(v));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* paged_tri_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
