// Closest hit of the wavefront's rays against a triangle soup through its
// SAH or implicit BVH (H1, use_bvh=True): a per-thread, nearest-first walk
// over explicit child links.
//
// Replaces no TPU kernel: the JAX package traces this tree with XLA while
// loops (raytrace_tpu/ops/bvh.py:55 traverse, the implicit heap, and :191
// traverse_sah, the explicit links), a whole wavefront stepping one node
// at a time, which as PyTorch operations would be tens of small kernels a
// step for hundreds of steps.  Here each thread walks its own ray.
//
// The tree (ops/bvh.py node_rows): one 64-byte row a node, four float4:
// the left child's box (min xyz, max xyz), the right one's, both child
// links bitcast to float, both boxes' reach (largest |coordinate|).  A
// link >= 0 is a node row; a link < 0 a leaf, -(1 + (first << 5 |
// count)), the rows [first, first + count) of the soup in the tree's
// order, three float4 a triangle, (v0, valid), (e1, -), (e2, -)
// (ops/megakernel.py tri_table12).  The root may itself be a leaf.
//
// The walk is csrc/tri_tree.cuh's with links for heap indices (Aila and
// Laine's while-while loop, the nearer passing child first): both child
// boxes tested with tri_tree::box_passes, each widened for this ray by
// (|o|_inf + reach) 2^-18, the other child pushed with its entry t and
// tested again against the best t when popped, a leaf's triangles tested
// with tri_tree::tri_hit, the Moller-Trumbore operations of every
// triangle walk of the port.  The stack holds kStack = 64 entries, one a
// level (ops/bvh.py MAX_STACK; the mesh scene's SAH tree is 26 deep): the
// wrapper refuses a deeper tree, and a push past it traps, so a walk is
// never cut short in silence.
//
// Bits.  A hit replaces the best one when t < best_t, or t == best_t and
// its row is lower: the lexicographic minimum of (t, id).  The boxes bound
// each triangle over the shutter (models/bvh_build.py
// world_triangle_bounds, in float64 and rounded) and the widening covers
// their rounding against the batch's world triangles and the slab test's,
// so the dense sweep's winner is always visited, and the minimum over any
// superset holding it is that winner, whatever the order.  Built with
// -fmad=false (ops/_build.py KERNEL_FLAGS) and IEEE division, so it
// matches its plain PyTorch version (ops/bvh.py bvh_walk_reference) bit
// for bit, and the dense sweep K2 over the same soup.
//
// What bounds it: the work depends on the data.  Per ray two box tests at
// each node the walk reaches and 46 FP32 operations a triangle at each
// leaf; the bytes are the rays (25 in, 16 out), 64 a node row and 48 a
// triangle row.  Like K2's and K3's walks it is held back by divergence
// and the dependent row loads, not by either roof.

#include <cuda_runtime.h>

#include "tri_tree.cuh"

namespace {

constexpr int kThreads = 128;  // as K2's and K3's walks
constexpr int kStack = 64;     // ops/bvh.py MAX_STACK

__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float4* __restrict__ nodes, int root, const float4* __restrict__ tris,
                const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ dx,
                const float* __restrict__ dy, const float* __restrict__ dz,
                const unsigned char* __restrict__ alive, int n, float* __restrict__ t_out,
                int* __restrict__ id_out, float* __restrict__ u_out,
                float* __restrict__ v_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float best_t = tri_tree::kTMax, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  if (alive[i] != 0) {
    const tri_tree::Ray r = tri_tree::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
    int stack_link[kStack];
    float stack_te[kStack];
    int sp = 0;
    int link = root;
    for (;;) {
      if (link >= 0) {
        const float4* row = nodes + 4 * link;
        const float4 a = __ldg(row);
        const float4 b = __ldg(row + 1);
        const float4 c = __ldg(row + 2);
        const float4 e = __ldg(row + 3);
        float tl, tr;
        const bool hl = tri_tree::box_passes(a.x, a.y, a.z, a.w, b.x, b.y,
                                             (r.o_inf + e.z) * tri_tree::kRounding, r, best_t,
                                             &tl);
        const bool hr = tri_tree::box_passes(b.z, b.w, c.x, c.y, c.z, c.w,
                                             (r.o_inf + e.w) * tri_tree::kRounding, r, best_t,
                                             &tr);
        const int l0 = __float_as_int(e.x);
        const int l1 = __float_as_int(e.y);
        if (hl && hr) {
          const bool left_first = tl <= tr;
          if (sp >= kStack) __trap();
          stack_link[sp] = left_first ? l1 : l0;
          stack_te[sp] = left_first ? tr : tl;
          ++sp;
          link = left_first ? l0 : l1;
          continue;
        }
        if (hl || hr) {
          link = hl ? l0 : l1;
          continue;
        }
      } else {
        const int enc = -(link + 1);
        const int first = enc >> 5;
        const int last = first + (enc & 31);
        for (int j = first; j < last; ++j) {
          float t, u, v;
          if (tri_tree::tri_hit(r, __ldg(tris + 3 * j), __ldg(tris + 3 * j + 1),
                                __ldg(tris + 3 * j + 2), t, u, v) &&
              (t < best_t || (t == best_t && j < best_id))) {
            best_t = t;
            best_id = j;
            best_u = u;
            best_v = v;
          }
        }
      }
      // Pop the nearest pending sibling that still passes.
      bool found = false;
      while (sp > 0) {
        --sp;
        if (stack_te[sp] < best_t * 1.0001f + 1e-4f) {
          link = stack_link[sp];
          found = true;
          break;
        }
      }
      if (!found) break;
    }
  }
  t_out[i] = best_t;
  id_out[i] = best_id;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

}  // namespace

// nodes: [N, 16] f32 (16-byte aligned); root: the root link; tris: [>=
// n_tris, 12] f32 in the tree's order (16-byte aligned); ox..dz: [n] f32;
// alive: [n] bool; t, u, v: [n] f32 out; id: [n] i32 out.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int bvh_walk_launch(const void* nodes, int root, const void* tris, int n_tris,
                               const void* ox, const void* oy, const void* oz, const void* dx,
                               const void* dy, const void* dz, const void* alive, int n,
                               void* t, void* id, void* u, void* v, void* stream) {
  if (n_tris <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    bvh_walk_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(nodes), root, static_cast<const float4*>(tris),
        static_cast<const float*>(ox), static_cast<const float*>(oy),
        static_cast<const float*>(oz), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(dz),
        static_cast<const unsigned char*>(alive), n, static_cast<float*>(t),
        static_cast<int*>(id), static_cast<float*>(u), static_cast<float*>(v));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bvh_walk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
