// K3, the skip-link traversal render, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracers_tpu/render/pallas_traversal.py:_kernel
// (a Whitted render in which each ray walks its own skip-link BVH over at most
// 128 clusters of K spheres).  Each bounce of a ray is a stackless walk of
// the threaded tree:
//
//   inner node:  slab test in (T_MIN, best_t) -> hit ? left child : skip
//   leaf node:   the cluster's K spheres in (eps, best_t) -> skip
//
// then the winner's shading.  A preorder walk visits each of the 2C-1 nodes
// at most once, so a walk is capped at 2C-1 steps (a corrupt table cannot
// hang the card; the plain version stops at the same cap).
//
// What bounds it on this card: FP32 issue, and the share of a warp's lanes
// that do a ray's own work when they issue it.  Its data (the inner table
// 4 KB, leaf skips 512 B, spheres K x 4 KB: 316 KB at K = 79) is read from
// shared memory and L1/L2, and the bytes it must move (the packed image) are
// far below the operations' time.  Lane operations counted in this source,
// each float32 add, subtract, multiply, conversion, comparison, min, max and
// select as one (loads, integer and predicate logic, shuffles and warp
// minimums not counted), and each IEEE square root and division at the
// multiply-equivalents M1 measures (csrc/microbench.cu: 8.84 and 8.77,
// docs/MICROBENCH_H100.json), written below as plain + roots + divisions;
// the plain version counts how often each part runs:
//   * every sphere slot tested (sphere_t to the discriminant's sign, and the
//     caller's compare and update): 3 (oc) + 5 (b) + 7 (c) + 3 (disc) + 1
//     (disc > 0) + 2 (t < best_t, the select of best_t) = 21 plain;
//   * a slot with disc > 0 adds t0 2 + its window 2 + select 1 = 5 plain
//     and sqrtf;
//   * a far root tried (far_root, the near one outside the window) adds
//     t1 2 + its window 2 + select 1 = 5;
//   * an inner-node slab test, per axis: t0 2 + t1 2 + the two selects on
//     the sign of inv 2 + nan_max 3 (unordered test, fmaxf, select) +
//     nan_min 3 + the fail test 1 = 13, so 39 (the sign tests are hoisted);
//   * a bounce's set-up: a 5 + the three sign tests of 1/d 3 + the hit
//     test 1 = 9 plain, and 1/a and the three 1/d (4 divisions); then a
//     hit's re-intersection and shading, 64 plain (oc 3, b 5, c 7, disc 3,
//     its guard 2, t0 2, t1 2, w_hi 1, the window 3, p 6, n 6, u 3, u.n 5,
//     r 7, the scatter test 6, the light 3), 2 roots (sqrtf(disc),
//     sqrtf(a)) and 2 divisions (1/r, 1/sqrtf(a)): a hit bounce 73 plain, 2
//     roots, 6 divisions; or the sky's 13 plain (uy 1, t 2, the gradient 7,
//     the light 3), sqrtf(a) and 1/: a miss 22 plain, 1 root, 5 divisions;
//   * every ray: its primary direction 21 and the packing 6 = 27.
//
// The TPU kernel keeps a tile's rays as (G, 128) lane arrays and picks, per
// tile, a tree step or a leaf round (:268-274).  A thread per ray, running
// each step's branch for its own ray, loses most of its lanes: a warp runs
// a K-slot leaf round whenever any lane is at a leaf, and runs until its
// deepest ray ends (PERF.md: 5.8% / 7.6% of the bound on irreg / rgbbox).
// The design here (render/traversal_model.py models it):
//   * persistent warps that take new rays: a grid of the card's resident
//     blocks; a warp takes runs of 32 rays from a counter, and a lane whose
//     ray ends (sky, absorbed, or max_depth) writes its pixel and takes the
//     warp's next ray, so no lane waits for the warp's deepest ray;
//   * the TPU's postponed leaf rounds as a warp policy: each iteration the
//     warp ballots its lanes' states (at an inner node, at a leaf, or
//     waiting to shade) and runs one kind of work for all of them.  It
//     shades when at least kShadeEighths / 8 of its lanes with rays wait to
//     shade or none walks; else it runs a leaf round when at least
//     kLeafEighths / 8 of its walking lanes wait at leaves or none is at an
//     inner node (the TPU's rule, pallas_traversal.py:273, which waits for
//     a quarter); else the lanes at inner nodes take a slab step;
//   * a leaf tested by the whole warp: a split round gives each pending
//     leaf a segment of S lanes (the power of two at or above K, at most
//     32), so a pass tests 32 / S leaves.  The segment reads the owner's
//     o, d, a, 1/a and best_t by __shfl_sync, lane r tests slots r, r + S,
//     ... in (eps, the owner's best_t at entry) and keeps its first smallest
//     t, and two __reduce_min_sync over the segment take the smallest bits
//     of t (t is positive and finite, or kBig, so its bits order as the
//     floats do) and the smallest slot holding it: the first smallest t,
//     which is the serial loop's winner and t (render/traversal.py's
//     _leaf_round says why).  The rule, from the counts the warp holds:
//     split where ceil(n / (32 / S)) * (ceil(K / S) + kSplitOverhead) < K
//     slot passes, n the pending leaves, else the serial round (each lane
//     its own leaf's K slots in order, in the running window).  So irreg's
//     79-slot leaves split when at most 7 wait, and rgbbox's 8-slot leaves
//     never;
//   * the constants were measured, not modelled: probes/k3_policy.py builds
//     copies of this source with other values and times render_traversal
//     in turns at 1000^2 depth 50 (NVIDIA H100 80GB HBM3, 700 W), in ms on
//     rgbbox / irreg / the 14,400-sphere soup of the global path:
//       these values (6, 2, 8)                    2.134 / 3.271 / 12.555
//       the TPU's quarter, overhead 1 (2, 2, 1)   3.444 / 3.895 / 17.411
//       leaf rounds at half (4, 2, 8)             2.132 / 3.216 / 15.070
//       leaf rounds with no lane inside (8, 2, 8) 2.401 / 3.401 / 12.035
//       shading at once (6, 0, 8)                 2.366 / 3.278 / 12.432
//       shading at half (6, 4, 8)                 2.085 / 3.251 / 13.129
//       shading when none walks (6, 9, 8)         2.477 / 3.100 / 14.185
//       overhead 3 / 20 / never split             2.248 / 3.338 / 12.424,
//                                                 2.162 / 3.394 / 13.210,
//                                                 2.097 / 4.903 / 17.749
//     (rounds of one run spread by up to 9%).  A leaf round pays when most
//     walking lanes wait at leaves; splitting pays only when few leaves
//     wait (never splitting costs irreg half again), and between 3 and 20
//     passes of overhead the times stay within the spread.  The first values
//     (the TPU's quarter, overhead 1) came from the schedule model
//     (render/traversal_model.py), which charges a split group only its
//     lane operations; at 128^2 it keeps 49% / 75% of the issued lane
//     operations useful on rgbbox / irreg with these values, 48% / 65%
//     with those;
//   * tables in shared memory, laid out for the warp: the inner table, the
//     leaf skips and, where C*K slots fit a block's 227 KB, the geometry
//     (cx, cy, cz, r) cluster-major as one float4 a slot, so 32 lanes on one
//     leaf read 512 contiguous bytes; each persistent block loads them once.
//     Where they do not fit, the kernel reads the same layout from global
//     memory (a copy the wrapper makes).  The winner's colours are one
//     indexed global load after the walk.
//
// Arithmetic (bit-equal to render/traversal.py:traversal_kernel_reference;
// the source builds with -fmad=false and IEEE division and square root):
//   * the search runs in t space: t = (-b -+ sqrtf(disc)) * (1/a) in the
//     window eps < t < best_t, the near root first (the far one with
//     far_root), and a strictly smaller t wins, so the first visit wins;
//   * shading re-intersects in (T_MIN, best_t + 1); rsqrt(a) of the TPU
//     shading (:326) is 1.0f / sqrtf(a);
//   * min/max propagate NaN as XLA's do, with the fail-if polarity
//     !(t_hi <= t_lo): a NaN slab stage keeps the node (:219-228);
//   * every sum is written in the order it is evaluated: (x + y) + z.
//
// Layouts: params (24,) f32 (camera 0-11, row offset 12 = 0, w h 1/w 1/h
// 16-19, block geometry 20-23); inner (8,128) f32 rows mnx mny mnz mxx mxy
// mxz left skip per inner node; leaf_skip (1,128) f32; spheres (K,8,128) f32,
// row k slot k of every cluster, fields cx cy cz rad cr cg cb 0; geo (C*K,)
// float4 cx cy cz rad, slot k of cluster c at c*K + k (the global-memory
// path only); packed (n,) int32 in ray order; work (1,) int32, the ray
// counter (zeroed here); counters (kNumCounters,) u64 or null, added to.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "ray_math.cuh"

namespace {

constexpr int kLane = 128;           // most clusters; table lane width
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;       // one block an SM: 32 warps
constexpr int kTableSmem = 9 * kLane * 4;   // node boxes and links, bytes
constexpr int kSmemLimit = 232448;   // the most a block may opt into
// The warp policy and the split rule (see the header for their measured
// reasons): a leaf round when at least kLeafEighths / 8 of the walking
// lanes wait at leaves, a shading when at least kShadeEighths / 8 of the
// lanes with rays wait to shade, and a split group charged kSplitOverhead
// slot passes beyond its own.
constexpr int kLeafEighths = 6;
constexpr int kShadeEighths = 2;
constexpr int kSplitOverhead = 8;
constexpr float kBig = 1e9f;         // T_MAX: best_t before any hit
constexpr float kEps = 0.1f;         // SCENE_EPSILON
constexpr float kTMin = 0.0f;        // T_MIN

// warp rounds by kind, and leaves tested in leaf rounds of each kind
enum {
  kTreeSteps, kSerialRounds, kSplitRounds, kSerialLeaves, kSplitLeaves,
  kShadeRounds, kNumCounters
};

struct Args {
  const float* params;
  const float* inner;
  const float* leaf_skip;
  const float* spheres;
  const float4* geo;
  int n_clusters, leaf_size, max_depth;
  int* packed;
  int n, tile, block_tiled;
  int* work;
  unsigned long long* counters;
};

// One lane's ray: where it is in its bounce loop and its walk.
struct Ray {
  int g;                              // ray index; -1: the lane has none
  int depth, step, cur, best_c, best_k;
  float ox, oy, oz, dx, dy, dz, a, inv_a, inv_dx, inv_dy, inv_dz, best_t;
  float lr, lg, lb;
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// One staged slab test (pallas_traversal.py:213-228) against the box of
// the ray's inner node in the window (T_MIN, best_t) -> the next node: the
// left child on a hit, else the skip link.  lo = (mnx, mny, mnz, left),
// hi = (mxx, mxy, mxz, skip), the links as int bits.
__device__ __forceinline__ int slab_step(const float4* lo_tab,
                                         const float4* hi_tab,
                                         const Ray& r) {
  const float4 lo = lo_tab[r.cur], hi = hi_tab[r.cur];
  const float o[3] = {r.ox, r.oy, r.oz};
  const float inv[3] = {r.inv_dx, r.inv_dy, r.inv_dz};
  const float mn[3] = {lo.x, lo.y, lo.z}, mx[3] = {hi.x, hi.y, hi.z};
  float t_lo = kTMin, t_hi = r.best_t;
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t0 = (mn[k] - o[k]) * inv[k];
    const float t1 = (mx[k] - o[k]) * inv[k];
    const bool neg = inv[k] < 0.0f;
    t_lo = nan_max(neg ? t1 : t0, t_lo);
    t_hi = nan_min(neg ? t0 : t1, t_hi);
    ok = ok && !(t_hi <= t_lo);
  }
  return __float_as_int(ok ? lo.w : hi.w);
}

// A sphere's root in the search window (eps, best_t): the near root, else
// (with far_root) the far one, else kBig (pallas_traversal.py:238-258).
template <bool kFarRoot>
__device__ __forceinline__ float sphere_t(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float a, float inv_a, float4 s,
                                          float best_t) {
  const float ocx = ox - s.x, ocy = oy - s.y, ocz = oz - s.z;
  const float b = (ocx * dx + ocy * dy) + ocz * dz;
  const float c = ((ocx * ocx + ocy * ocy) + ocz * ocz) - s.w * s.w;
  const float disc = b * b - a * c;
  if (!(disc > 0.0f)) return kBig;
  const float sq = sqrtf(disc);
  const float t0 = (-b - sq) * inv_a;
  if (t0 < best_t && t0 > kEps) return t0;
  if (kFarRoot) {
    const float t1 = (-b + sq) * inv_a;
    if (t1 < best_t && t1 > kEps) return t1;
  }
  return kBig;
}

template <bool kSmemGeo>
__device__ __forceinline__ float4 geo_at(const float4* smem,
                                         const float4* __restrict__ glob,
                                         int i) {
  if constexpr (kSmemGeo)
    return smem[i];
  else
    return __ldg(glob + i);
}

// A bounce's set-up: the walk starts at the root with nothing hit.
__device__ __forceinline__ void begin_bounce(Ray& r) {
  r.a = (r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz;
  r.inv_a = 1.0f / r.a;
  r.inv_dx = 1.0f / r.dx;
  r.inv_dy = 1.0f / r.dy;
  r.inv_dz = 1.0f / r.dz;
  r.best_t = kBig;
  r.best_c = r.best_k = 0;
  r.cur = 0;
  r.step = 0;
}

// 255.99 quantization, truncation toward zero (ray.fut:156-162); the lane
// then has no ray.
__device__ __forceinline__ void finish(const Args& A, Ray& r, float rr,
                                       float rg, float rb) {
  A.packed[r.g] = ((int)(255.99f * rr) << 16) | ((int)(255.99f * rg) << 8) |
                  (int)(255.99f * rb);
  r.g = -1;
}

// Ray g's primary ray; at max_depth 0 its pixel at once.
__device__ __forceinline__ void start_ray(const Args& A, Ray& r, int g) {
  r.g = g;
  r.ox = A.params[9];
  r.oy = A.params[10];
  r.oz = A.params[11];
  rt::primary_ray(A.params, g, A.tile, A.block_tiled, r.dx, r.dy, r.dz);
  r.lr = r.lg = r.lb = 1.0f;
  r.depth = 0;
  if (A.max_depth == 0) {
    finish(A, r, 0.0f, 0.0f, 0.0f);
    return;
  }
  begin_bounce(r);
}

// A walk step taken: the walk ends at the cap (cur = -1 marks it over).
__device__ __forceinline__ void stepped(Ray& r, int cap) {
  if (++r.step >= cap) r.cur = -1;
}

// The shading of a ray whose walk is over (pallas_traversal.py:283-334):
// the sky, absorption or max_depth end it; a mirror bounce starts the next
// walk.
template <bool kSmemGeo>
__device__ __forceinline__ void shade(const Args& A, const float4* smem_geo,
                                      Ray& r) {
  const float a = r.a;
  if (!(r.best_t < kBig)) {                            // miss: sky
    const float uy = r.dy * (1.0f / sqrtf(a));
    const float t = 0.5f * (uy + 1.0f);
    finish(A, r, r.lr * rt::sky(t, rt::kSkyR), r.lg * rt::sky(t, rt::kSkyG),
           r.lb * rt::sky(t, rt::kSkyB));
    return;
  }
  const float4 s = geo_at<kSmemGeo>(smem_geo, A.geo,
                                    r.best_c * A.leaf_size + r.best_k);
  const float ocx = r.ox - s.x, ocy = r.oy - s.y, ocz = r.oz - s.z;
  const float b = (ocx * r.dx + ocy * r.dy) + ocz * r.dz;
  const float c = ((ocx * ocx + ocy * ocy) + ocz * ocz) - s.w * s.w;
  const float disc = b * b - a * c;
  const float sq = sqrtf(disc > 0.0f ? disc : 1.0f);
  const float t0 = (-b - sq) * r.inv_a;
  const float t1 = (-b + sq) * r.inv_a;
  const float w_hi = r.best_t + 1.0f;
  const float t2 = (t0 < w_hi && t0 > kTMin) ? t0 : t1;
  const float px = r.ox + t2 * r.dx, py = r.oy + t2 * r.dy,
              pz = r.oz + t2 * r.dz;
  const float inv_r = 1.0f / s.w;
  const float nx = (px - s.x) * inv_r, ny = (py - s.y) * inv_r,
              nz = (pz - s.z) * inv_r;
  const float inv_dn = 1.0f / sqrtf(a);
  const float ux = r.dx * inv_dn, uy = r.dy * inv_dn, uz = r.dz * inv_dn;
  const float udn = (ux * nx + uy * ny) + uz * nz;
  const float rx = ux - (2.0f * udn) * nx;
  const float ry = uy - (2.0f * udn) * ny;
  const float rz = uz - (2.0f * udn) * nz;
  if (!(((rx * nx + ry * ny) + rz * nz) > 0.0f)) {     // absorbed
    finish(A, r, 0.0f, 0.0f, 0.0f);
    return;
  }
  // the winner's colours, one indexed load (pallas_traversal.py:283-295)
  const float* w = A.spheres + (size_t)r.best_k * 8 * kLane + r.best_c;
  r.lr = r.lr * __ldg(w + 4 * kLane);
  r.lg = r.lg * __ldg(w + 5 * kLane);
  r.lb = r.lb * __ldg(w + 6 * kLane);
  r.ox = px; r.oy = py; r.oz = pz;
  r.dx = rx; r.dy = ry; r.dz = rz;
  if (++r.depth == A.max_depth) {
    finish(A, r, 0.0f, 0.0f, 0.0f);
    return;
  }
  begin_bounce(r);
}

// The serial leaf round: each lane at a leaf tests its own leaf's K slots
// in order, each in the running window (eps, best_t).
template <bool kFarRoot, bool kSmemGeo>
__device__ __forceinline__ void serial_round(const Args& A,
                                             const float4* smem_geo,
                                             const int* leaf_next, Ray& r,
                                             int NI, int cap) {
  const int c = r.cur - NI, K = A.leaf_size;
  for (int k = 0; k < K; ++k) {
    const float t = sphere_t<kFarRoot>(
        r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.a, r.inv_a,
        geo_at<kSmemGeo>(smem_geo, A.geo, c * K + k), r.best_t);
    if (t < r.best_t) {
      r.best_t = t;
      r.best_c = c;
      r.best_k = k;
    }
  }
  r.cur = leaf_next[c];
  stepped(r, cap);
}

// The split leaf round over the lanes of `pending` (see the header): groups
// of 32 / S leaves, a segment of S lanes each.
template <bool kFarRoot, bool kSmemGeo>
__device__ __forceinline__ void split_round(const Args& A,
                                            const float4* smem_geo,
                                            const int* leaf_next, Ray& r,
                                            unsigned pending, int S,
                                            int NI, int cap) {
  const int lane = threadIdx.x % kWarp, K = A.leaf_size;
  const int seg = lane / S, sub = lane % S;
  const unsigned seg_mask =
      S == kWarp ? kFull : ((1u << S) - 1u) << (seg * S);
  for (unsigned rest = pending; rest;) {
    int owner = -1;                    // whose leaf my segment tests
    int mine = -1;                     // the segment that tests my leaf
    for (int s = 0; s < kWarp / S && rest; ++s) {
      const int j = __ffs(rest) - 1;
      rest &= rest - 1;
      if (s == seg) owner = j;
      if (j == lane) mine = s;
    }
    const int src = owner >= 0 ? owner : lane;
    const float ox = __shfl_sync(kFull, r.ox, src);
    const float oy = __shfl_sync(kFull, r.oy, src);
    const float oz = __shfl_sync(kFull, r.oz, src);
    const float dx = __shfl_sync(kFull, r.dx, src);
    const float dy = __shfl_sync(kFull, r.dy, src);
    const float dz = __shfl_sync(kFull, r.dz, src);
    const float a = __shfl_sync(kFull, r.a, src);
    const float inv_a = __shfl_sync(kFull, r.inv_a, src);
    const float bt = __shfl_sync(kFull, r.best_t, src);
    const int c = __shfl_sync(kFull, r.cur, src) - NI;
    // this lane's first smallest t over its slots sub, sub + S, ...
    float t_min = kBig;
    int slot = sub;
    if (owner >= 0) {
      for (int k = sub; k < K; k += S) {
        const float t = sphere_t<kFarRoot>(
            ox, oy, oz, dx, dy, dz, a, inv_a,
            geo_at<kSmemGeo>(smem_geo, A.geo, c * K + k), bt);
        if (t < t_min) {
          t_min = t;
          slot = k;
        }
      }
    }
    const unsigned bits = __float_as_uint(t_min);
    const unsigned t_bits = __reduce_min_sync(seg_mask, bits);
    const unsigned k_min =
        __reduce_min_sync(seg_mask, bits == t_bits ? (unsigned)slot : kFull);
    // the owner reads its segment's minimum from the segment's first lane
    const int head = (mine >= 0 ? mine : 0) * S;
    const unsigned w_bits = __shfl_sync(kFull, t_bits, head);
    const unsigned w_slot = __shfl_sync(kFull, k_min, head);
    if (mine >= 0) {
      const int own_c = r.cur - NI;
      const float t = __uint_as_float(w_bits);
      if (t < r.best_t) {
        r.best_t = t;
        r.best_c = own_c;
        r.best_k = (int)w_slot;
      }
      r.cur = leaf_next[own_c];
      stepped(r, cap);
    }
  }
}

template <bool kFarRoot, bool kSmemGeo>
__global__ void __launch_bounds__(kThreads, 1) traversal(Args A) {
  extern __shared__ float4 smem_geo[];                 // (C*K,), kSmemGeo
  __shared__ float4 lo_tab[kLane], hi_tab[kLane];      // inner nodes
  __shared__ int leaf_next[kLane];                     // leaf skip links
  const int C = A.n_clusters, K = A.leaf_size, NI = C - 1;
  for (int i = threadIdx.x; i < kLane; i += blockDim.x) {
    const float* f = A.inner + i;
    lo_tab[i] = make_float4(f[0], f[kLane], f[2 * kLane],
                            __int_as_float((int)f[6 * kLane]));
    hi_tab[i] = make_float4(f[3 * kLane], f[4 * kLane], f[5 * kLane],
                            __int_as_float((int)f[7 * kLane]));
    leaf_next[i] = (int)A.leaf_skip[i];
  }
  if constexpr (kSmemGeo) {
    for (int i = threadIdx.x; i < C * K; i += blockDim.x) {
      const int c = i / K, k = i - c * K;
      const float* s = A.spheres + (size_t)k * 8 * kLane + c;
      smem_geo[i] = make_float4(s[0], s[kLane], s[2 * kLane], s[3 * kLane]);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;
  const int cap = 2 * C - 1;
  int seg_S = 1;                     // the power of two at or above K, <= 32
  while (seg_S < K && seg_S < kWarp) seg_S *= 2;
  const int per_group = kWarp / seg_S;
  const int slot_passes = (K + seg_S - 1) / seg_S;
  unsigned count[kNumCounters] = {};
  Ray r{};
  r.g = -1;
  int next = 0, end = 0;                               // the warp's run
  bool drained = false;
  for (;;) {
    // lanes without a ray take the next rays of the warp's run
    unsigned empty = __ballot_sync(kFull, r.g < 0);
    while (empty && !drained) {
      if (next >= end) {
        int base = lane == 0 ? atomicAdd(A.work, kWarp) : 0;
        base = __shfl_sync(kFull, base, 0);
        if (base >= A.n) {
          drained = true;
          break;
        }
        next = base;
        end = min(base + kWarp, A.n);
      }
      const int take = min(__popc(empty), end - next);
      const int rank = __popc(empty & below);
      if (r.g < 0 && rank < take) start_ray(A, r, next + rank);
      next += take;
      empty = __ballot_sync(kFull, r.g < 0);
    }
    const unsigned live = ~empty;
    if (!live) break;
    const bool walking = r.g >= 0 && r.cur >= 0;
    const bool at_leaf = walking && r.cur >= NI;
    const unsigned walk = __ballot_sync(kFull, walking);
    const unsigned leaf = __ballot_sync(kFull, at_leaf);
    const int n_walk = __popc(walk), n_leaf = __popc(leaf);
    const int n_shade = __popc(live & ~walk);
    if (n_shade && (8 * n_shade >= kShadeEighths * __popc(live) ||
                    n_walk == 0)) {
      ++count[kShadeRounds];
      if (r.g >= 0 && !walking) shade<kSmemGeo>(A, smem_geo, r);
    } else if (n_leaf &&
               (8 * n_leaf >= kLeafEighths * n_walk || n_leaf == n_walk)) {
      const int groups = (n_leaf + per_group - 1) / per_group;
      if (groups * (slot_passes + kSplitOverhead) < K) {
        ++count[kSplitRounds];
        count[kSplitLeaves] += n_leaf;
        split_round<kFarRoot, kSmemGeo>(A, smem_geo, leaf_next, r, leaf, seg_S,
                                        NI, cap);
      } else {
        ++count[kSerialRounds];
        count[kSerialLeaves] += n_leaf;
        if (at_leaf)
          serial_round<kFarRoot, kSmemGeo>(A, smem_geo, leaf_next, r, NI,
                                           cap);
      }
    } else {
      ++count[kTreeSteps];
      if (walking && !at_leaf) {
        r.cur = slab_step(lo_tab, hi_tab, r);
        stepped(r, cap);
      }
    }
  }
  if (A.counters != nullptr && lane == 0)
    for (int k = 0; k < kNumCounters; ++k)
      if (count[k])
        atomicAdd(A.counters + k, (unsigned long long)count[k]);
}

// The blocks of `kernel` the card holds at once with `smem` bytes of dynamic
// shared memory (after opting the kernel into them), worked out at an
// instantiation's first launch with that size and kept, (smem << 32) |
// blocks, for the launches after it.  Any grid computes the same result
// (the warps take rays from a counter).
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem,
                    std::atomic<unsigned long long>& memo, int& blocks) {
  const unsigned long long m = memo.load(std::memory_order_relaxed);
  if (m != 0 && (m >> 32) == smem) {
    blocks = (int)(m & 0xffffffffu);
    return 0;
  }
  int dev, sms, per_sm;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  blocks = std::max(per_sm, 1) * sms;
  memo.store(((unsigned long long)smem << 32) | (unsigned)blocks,
             std::memory_order_relaxed);
  return 0;
}

template <bool kFarRoot, bool kSmemGeo>
int launch(const Args& a, cudaStream_t s) {
  auto* kernel = traversal<kFarRoot, kSmemGeo>;
  const size_t smem =
      kSmemGeo ? (size_t)a.n_clusters * a.leaf_size * sizeof(float4) : 0;
  static std::atomic<unsigned long long> memo{0};
  int resident;
  int e = resident_blocks(kernel, smem, memo, resident);
  if (e == 0) e = (int)cudaMemsetAsync(a.work, 0, sizeof(int), s);
  if (e != 0) return e;
  const long long want = ((long long)a.n + kThreads - 1) / kThreads;
  const int blocks = (int)std::min<long long>(want, resident);
  kernel<<<blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_traversal_launch(const float* params, const float* inner,
                                   const float* leaf_skip,
                                   const float* spheres, const float* geo,
                                   int n_clusters, int leaf_size,
                                   int max_depth, int far_root,
                                   int* packed_out, int n, int tile,
                                   int block_tiled, int* work,
                                   unsigned long long* counters,
                                   void* stream) {
  if (n_clusters < 2 || n_clusters > kLane || leaf_size < 1 ||
      max_depth < 0 || n <= 0 || tile <= 0 || work == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool smem_geo = geo == nullptr;
  if (smem_geo && kTableSmem + 16LL * n_clusters * leaf_size > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const Args a{params, inner, leaf_skip, spheres,
               reinterpret_cast<const float4*>(geo), n_clusters, leaf_size,
               max_depth, packed_out, n, tile, block_tiled, work, counters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (far_root)
    return smem_geo ? launch<true, true>(a, s) : launch<true, false>(a, s);
  return smem_geo ? launch<false, true>(a, s) : launch<false, false>(a, s);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
