// Closest hit of the wavefront's rays against a triangle soup through its
// SAH or implicit BVH (H1, use_bvh=True): a per-thread, nearest-first walk
// over four-wide nodes with explicit child links.
//
// Replaces no TPU kernel: the JAX package traces this tree with XLA while
// loops (raytrace_tpu/ops/bvh.py:55 traverse, the implicit heap, and :191
// traverse_sah, the explicit links), a whole wavefront stepping one node
// at a time, which as PyTorch operations would be tens of small kernels a
// step for hundreds of steps.  Here each thread walks its own ray.
//
// The tree (ops/bvh.py wide_rows): the binary tree (node_rows) collapsed
// so that every internal binary node at an even depth is a wide node whose
// children are its grandchildren (or a child that is a leaf): 2 to 4 of
// them.  One 128-byte row a wide node, eight float4: the four children's
// min x, max x, min y, max y, min z, max z (a float4 each, one lane a
// child), their links bitcast to float, their reaches (largest
// |coordinate| of the box).  A link >= 0 is a wide row; a link < 0 a
// leaf, -(1 + (first << 5 | count)), the rows [first, first + count) of
// the soup in the tree's order, three float4 a triangle, (v0, valid),
// (e1, -), (e2, -) (ops/megakernel.py tri_table12).  An absent child is
// the point (BIG, BIG, BIG), which no slab test passes.  The root may
// itself be a leaf.  Each child's box is the binary subtree's, copied
// with no new rounding.
//
// The walk: at a node all four child boxes are tested with
// tri_tree::box_passes, each widened for this ray by (|o|_inf + reach)
// 2^-18; the four tests read one row and are independent, so they
// overlap.  The children that pass are ranked by (entry t, slot) with a
// five-step sorting network; the first is walked and the others pushed,
// the farthest first, each with its entry t, tested again against the
// best t when popped.  A leaf's triangles are tested with
// tri_tree::tri_hit, the Moller-Trumbore operations of every triangle walk
// of the port.  The stack holds kStack = 94 entries (ops/bvh.py
// MAX_STACK): a wide level pushes at most three, so a binary tree of depth
// d needs 3 ((d + 1) / 2) + 1 (ops/bvh.py wide_stack; the mesh scene's SAH
// tree, depth 26, 40), and 94 holds every tree of depth 62 or less, the
// binary walk's 64 entries' reach.  The stack is local memory, which costs
// no registers.  The wrapper refuses a deeper tree, and a push past the
// stack traps, so a walk is never cut short in silence.
//
// Bits.  A hit replaces the best one when t < best_t, or t == best_t and
// its row is lower: the lexicographic minimum of (t, id).  The boxes bound
// each triangle over the shutter (models/bvh_build.py
// world_triangle_bounds, in float64 and rounded) and the widening covers
// their rounding against the batch's world triangles and the slab test's,
// so the dense sweep's winner is always visited, and the minimum over any
// superset holding it is that winner, whatever the order.  Built with
// -fmad=false (ops/_build.py KERNEL_FLAGS) and IEEE division, so it
// matches its plain PyTorch version (ops/bvh.py bvh_walk_reference, which
// walks the same rows, or the binary ones) bit for bit, and the dense
// sweep K2 over the same soup.
//
// What bounds it: the work depends on the data.  The least work that
// proves a ray's hit over these boxes is the binary walk's (ops/bvh.py
// visit_counts over the binary rows): two box tests at each binary node
// it reaches and 46 FP32 operations a triangle at each leaf; the bytes are
// the rays (25 in, 16 out), 64 a binary node row and 48 a triangle row.
// This kernel does more: four box tests a wide node, absent slots and
// children of a failing binary box included.  A wide node brings four
// boxes a load, so the chain of
// dependent node loads is half the binary walk's (14.9 steps a primary ray
// on the mesh against 28.6): that shortens the small late bounces, each as
// long as its slowest ray's chain.  The large bounces move little (PERF.md
// §6): a ray still makes ~60 box tests and reads ~3 KB of node and
// triangle rows, which the collapse leaves as they were.

#include <cuda_runtime.h>

#include "tri_tree.cuh"

namespace {

constexpr int kThreads = 128;  // as K2's and K3's walks
constexpr int kStack = 94;     // ops/bvh.py MAX_STACK

// A child that passed: its entry t, link and slot (the tie-break).
struct Child {
  float te;
  int link, slot;
};

__device__ __forceinline__ void order2(Child& a, Child& b) {
  const bool swap = b.te < a.te || (b.te == a.te && b.slot < a.slot);
  const Child lo = swap ? b : a;
  const Child hi = swap ? a : b;
  a = lo;
  b = hi;
}

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
        const float4* row = nodes + 8 * link;
        const float4 lx = __ldg(row), hx = __ldg(row + 1);
        const float4 ly = __ldg(row + 2), hy = __ldg(row + 3);
        const float4 lz = __ldg(row + 4), hz = __ldg(row + 5);
        const float4 ln = __ldg(row + 6), re = __ldg(row + 7);
        // Each child's key: its entry t where it passes, else +inf, which
        // sorts it after every child that passes.
        Child c0, c1, c2, c3;
        float te;
        const bool p0 = tri_tree::box_passes(lx.x, ly.x, lz.x, hx.x, hy.x, hz.x,
                                             (r.o_inf + re.x) * tri_tree::kRounding, r, best_t,
                                             &te);
        c0 = {p0 ? te : __int_as_float(0x7f800000), __float_as_int(ln.x), 0};
        const bool p1 = tri_tree::box_passes(lx.y, ly.y, lz.y, hx.y, hy.y, hz.y,
                                             (r.o_inf + re.y) * tri_tree::kRounding, r, best_t,
                                             &te);
        c1 = {p1 ? te : __int_as_float(0x7f800000), __float_as_int(ln.y), 1};
        const bool p2 = tri_tree::box_passes(lx.z, ly.z, lz.z, hx.z, hy.z, hz.z,
                                             (r.o_inf + re.z) * tri_tree::kRounding, r, best_t,
                                             &te);
        c2 = {p2 ? te : __int_as_float(0x7f800000), __float_as_int(ln.z), 2};
        const bool p3 = tri_tree::box_passes(lx.w, ly.w, lz.w, hx.w, hy.w, hz.w,
                                             (r.o_inf + re.w) * tri_tree::kRounding, r, best_t,
                                             &te);
        c3 = {p3 ? te : __int_as_float(0x7f800000), __float_as_int(ln.w), 3};
        const int passed = int(p0) + int(p1) + int(p2) + int(p3);
        if (passed > 0) {
          // Sort the four by (key, slot): c0 nearest, then c1, c2, c3.
          order2(c0, c1);
          order2(c2, c3);
          order2(c0, c2);
          order2(c1, c3);
          order2(c1, c2);
          // Push the others that passed, the farthest first.
          if (passed > 3) {
            if (sp >= kStack) __trap();
            stack_link[sp] = c3.link;
            stack_te[sp] = c3.te;
            ++sp;
          }
          if (passed > 2) {
            if (sp >= kStack) __trap();
            stack_link[sp] = c2.link;
            stack_te[sp] = c2.te;
            ++sp;
          }
          if (passed > 1) {
            if (sp >= kStack) __trap();
            stack_link[sp] = c1.link;
            stack_te[sp] = c1.te;
            ++sp;
          }
          link = c0.link;
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

// nodes: [N, 32] f32 four-wide rows (16-byte aligned); root: the root
// link; tris: [>= n_tris, 12] f32 in the tree's order (16-byte aligned);
// ox..dz: [n] f32; alive: [n] bool; t, u, v: [n] f32 out; id: [n] i32 out.
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
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
