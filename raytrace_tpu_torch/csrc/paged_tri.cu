// Closest hit of rays against a triangle soup of any size (K3): a
// per-thread, nearest-first walk of an implicit binary tree.
//
// Replaces the TPU kernel raytrace_tpu/ops/pallas_paged_tri.py::_paged_kernel
// (launched by paged_tri_sweep), whose flat walk (every page box, then
// every cluster box of each page that passes, in ascending order) was
// shaped by the TPU's lane gathers, and this file's first version, which
// kept that walk.  It computes what the dense sweep over the same soup
// computes (csrc/tri_sweep.cu): (t, id, u, v) of the nearest hit, ties to
// the lowest id, or (T_MAX, -1, 0, 0) on a miss or for an inactive ray.
//
// The soup is in Morton order of its centroids (ops/paged_tri.py).  The
// tree (build_tri_tree) is implicit: leaf k holds triangles [k L, (k+1) L)
// and is node K - 1 + k; node n has children 2n + 1 and 2n + 2; each
// internal node is one 64-byte row, four float4: both children's boxes
// (left min xyz, left max xyz, right min xyz, right max xyz) and each
// child's reach (its box's largest |coordinate|).  A box holding no real
// triangle is the point (BIG, BIG, BIG) with reach 0, which never passes.
//
// The walk and its bits are csrc/tri_tree.cuh's, which K4's triangle
// forms share (csrc/megakernel.cu): the lexicographic minimum of (t, id)
// over a conservative walk is the dense sweep's (t, id, u, v), bit for
// bit, whatever the order.  Built with -fmad=false (ops/_build.py
// KERNEL_FLAGS), so every operation rounds as the plain PyTorch versions'
// (ops/paged_tri.py tri_tree_sweep_reference, ops/tri_sweep.py).
//
// What bounds it on the H100: the work depends on the data.  Per ray, two
// box tests (32 FP32 operations each with the widening) at every node the
// walk reaches and 46 operations a triangle at every leaf; the bytes are
// the rays (25 in, 16 out), 64 per node row and 48 per triangle row, of
// which the top of the tree and the triangles a warp's rays share stay in
// the 50 MB L2 (final-one-weekend --mesh-geometry's 33.6 MB of nodes at
// L = 4 and 98 MB of triangles).  So it is bound by FP32 issue and by
// divergence: a warp's 32 rays walk different paths, each step waits on a
// dependent 64-byte load, and the warp runs until its longest walk ends.
// The design keeps a node's row to one 64-byte line, the stack in local
// memory (L1, 192 bytes a thread; 48 registers, no spills), and the leaf
// small: L = 4 (ops/paged_tri.py LEAF), timed on the card against 8 and 16
// (PERF.md).  Two options were built and timed on the card and left out
// (PERF.md): the top 8 or 10 levels of the tree in shared memory (slower:
// a block's copy of up to 64 KB costs more than the L2 hits it saves, and
// fewer blocks fit an SM), and a persistent grid taking rays 32 at a time
// from an atomic counter (1-2% faster on K3 alone, which the host-bound
// mesh path cannot show).

#include <cuda_runtime.h>

// The tree walk shared with K4.
#include "tri_tree.cuh"

namespace {

constexpr float kTMax = tri_tree::kTMax;
constexpr int kStack = 24;         // ops/paged_tri.py MAX_DEPTH
constexpr int kThreads = 128;

struct NoCapture {
  __device__ __forceinline__ void operator()(float4, float4, float4, float, float) const {}
};

__global__ void __launch_bounds__(kThreads)
paged_tri_kernel(tri_tree::Tree tree, const float* __restrict__ ox,
                 const float* __restrict__ oy,
                 const float* __restrict__ oz,
                 const float* __restrict__ dx,
                 const float* __restrict__ dy,
                 const float* __restrict__ dz,
                 const unsigned char* __restrict__ alive, int n,
                 float* __restrict__ t_out, int* __restrict__ id_out,
                 float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float best_t = kTMax, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  if (alive[i] != 0) {
    const tri_tree::Ray r = tri_tree::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
    tri_tree::Stack<kStack> stack;
    tri_tree::walk<kStack, false>(stack, tree, r, 0, best_t, best_id, best_u, best_v,
                                  NoCapture{});
  }
  t_out[i] = best_t;
  id_out[i] = best_id;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

}  // namespace

// tris: [>= n_tris, 12] f32; nodes: [2^depth - 1, 16] f32 (both 16-byte
// aligned); ox..dz: [n] f32; alive: [n] bool; t, u, v: [n] f32 out; id:
// [n] i32 out.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int paged_tri_launch(const void* tris, int n_tris,
                                const void* nodes, int depth, int leaf,
                                const void* ox, const void* oy,
                                const void* oz, const void* dx,
                                const void* dy, const void* dz,
                                const void* alive, int n, void* t, void* id,
                                void* u, void* v, void* stream) {
  if (depth > kStack) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const tri_tree::Tree tree{static_cast<const float4*>(tris),
                              static_cast<const float4*>(nodes), nullptr, n_tris,
                              depth, leaf};
    paged_tri_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        tree, static_cast<const float*>(ox), static_cast<const float*>(oy),
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
