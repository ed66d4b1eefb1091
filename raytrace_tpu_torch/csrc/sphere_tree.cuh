// The sphere closest-hit test and the walk of a sphere tree, shared by the
// wavefront's sphere sweep K1 (csrc/sphere_sweep.cu) and the fused bounce
// kernel K4's clustered sphere forms (csrc/megakernel.cu).  Both kernels
// include this file, so their sphere tests cannot drift apart.
//
// The test (sphere_t) is the quadratic of ops/spheres.py
// intersect_spheres_world in its stable h-form, in that function's
// operation order:
//     h = d.o - d.c,  c2 = |o|^2 - 2 o.c + k,  disc = h^2 - a c2,
// with k = |c|^2 - r^2 precomputed on the host in float64; a root counts
// when it lies in (T_MIN, T_MAX), the r > 0 gate drops padding rows (which
// also carry k = 3e37, so disc < 0), and the nearer valid root wins.
//
// The tree (ops/sphere_tree.py build_sphere_tree) holds the spheres past a
// dense prefix in a Morton order of their centres: a permuted copy of
// their [n, 8] rows (c, r), (k, -) (and, in K4's animated form, motion
// rows, each sphere read at the sample's time: global_sphere), an int32
// slot -> id table, and one 64-byte row an internal node,
// both children's boxes with each child's reach (the most |c| + |r| below
// it) and rounding coefficient (2^-19 over the least positive radius below
// it).  A child's box is widened for the ray by (|o| + reach)^2 coef: the
// f32 quadratic can report a grazing hit up to that far outside a sphere.
// The walk is csrc/tri_tree.cuh's walk_tree (nearest first, a short
// stack); the tree's top `staged` node rows are read from a copy the
// caller put in shared memory, the rest through the read-only cache.  At
// a leaf each sphere is tested with sphere_t and a real hit replaces the
// best one when t < best_t, or t == best_t and id < best_id, the id read
// from the slot table only for a hit at or below the best t: the
// lexicographic minimum of (t, id) over a conservative walk and the
// caller's seed (the prefix's best, whose ids are below every tree id),
// which is the dense sweep's winner, bit for bit, in any order of the
// walk.  sweep_sphere_tree is the walk K4's clustered forms ran before
// this file held it, unchanged, so that they compile to the same code;
// K1 runs its static instantiation.  A file that includes this one is
// built with -fmad=false
// (ops/_build.py KERNEL_FLAGS), so every operation rounds as the plain
// PyTorch versions' (ops/spheres.py, ops/sphere_tree.py).

#pragma once

#include <cuda_runtime.h>

// The walk shared with the triangle trees.
#include "tri_tree.cuh"

namespace sphere_tree {

constexpr float kTMin = tri_tree::kTMin;
constexpr float kTMax = tri_tree::kTMax;

// The closest-hit quadratic against one sphere: its nearer root in (T_MIN,
// T_MAX), or kTMax for no hit.  d_dot_o, a, o_sq and inv_a are the ray's;
// V is the caller's vector of three floats.
template <typename V>
__device__ __forceinline__ float sphere_t(float4 sph, float k, V o, V d, float d_dot_o, float a,
                                          float o_sq, float inv_a) {
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
  return t1_ok ? t1 : (t2_ok ? t2 : kTMax);
}

// Sphere j tested in ascending id: the strict < update of the dense sweep.
template <typename V>
__device__ __forceinline__ void test_sphere(float4 sph, float k, V o, V d, float d_dot_o, float a,
                                            float o_sq, float inv_a, int j, float& best_t,
                                            int& best_id) {
  const float t = sphere_t(sph, k, o, d, d_dot_o, a, o_sq, inv_a);
  if (t < best_t) {
    best_t = t;
    best_id = j;
  }
}

// A sphere tree (ops/sphere_tree.py SphereTree): slot j's rows rows[2j],
// rows[2j + 1] (and drows' in K4's animated form) hold sphere ids[j]; n
// slots; the node rows, the first `staged` also at staged_nodes in shared
// memory.
struct SphereTree {
  const float4* rows;
  const float4* drows;
  const float4* nodes;
  const float4* staged_nodes;
  const int* ids;
  int n, depth, leaf, staged;
};

// Sphere j read from the tables in global memory through the read-only
// cache: (c, r) and k from the [s8, 8] table, and in the animated form
// (dc) and (k1, k2) from the motion rows, moved to time tcur.
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

// The tree's spheres against one ray, after the caller's seed (best_t,
// best_id): see the header.  A static tree (kAnim false) ignores tcur.
template <bool kAnim, int kStack, typename V>
__device__ __forceinline__ void sweep_sphere_tree(const SphereTree& tree,
                                                  tri_tree::Stack<kStack>& stack, float tcur,
                                                  V o, V d, float d_dot_o, float a, float o_sq,
                                                  float inv_a, float& best_t, int& best_id) {
  const tri_tree::Ray r = tri_tree::make_ray(o.x, o.y, o.z, d.x, d.y, d.z);
  const float onorm = sqrtf(o_sq);
  tri_tree::walk_tree(
      stack, tree.depth, r, best_t,
      [&](int node, float4& ra, float4& rb, float4& rc, float4& re) {
        if (node < tree.staged) {
          const float4* row = tree.staged_nodes + 4 * node;
          ra = row[0];
          rb = row[1];
          rc = row[2];
          re = row[3];
        } else {
          const float4* row = tree.nodes + 4 * node;
          ra = __ldg(row);
          rb = __ldg(row + 1);
          rc = __ldg(row + 2);
          re = __ldg(row + 3);
        }
      },
      [&](float4 e, bool right) {
        // The rounding margin: (|o| + reach)^2 * SPHERE_ROUNDING / r_min.
        const float s = onorm + (right ? e.y : e.x);
        return s * s * (right ? e.w : e.z);
      },
      [&](int k) {
        const int j0 = k * tree.leaf;
        const int j1 = min(j0 + tree.leaf, tree.n);
        for (int j = j0; j < j1; ++j) {
          float4 sph;
          float kk;
          global_sphere<kAnim>(tree.rows, tree.drows, j, tcur, sph, kk);
          const float t = sphere_t(sph, kk, o, d, d_dot_o, a, o_sq, inv_a);
          // A real hit may win; the id is read only for one at or below
          // the best t.
          if (t < kTMax && t <= best_t) {
            const int id = __ldg(tree.ids + j);
            if (t < best_t || id < best_id) {
              best_t = t;
              best_id = id;
            }
          }
        }
      });
}

}  // namespace sphere_tree
