// K3, the per-ray skip-link traversal render, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracers_tpu/render/pallas_traversal.py:_kernel
// (a Whitted render in which each ray walks its own skip-link BVH over at most
// 128 clusters of K spheres).  One thread owns one ray and runs its whole
// bounce loop; each bounce is a stackless walk of the threaded tree:
//
//   inner node:  slab test in (T_MIN, best_t) -> hit ? left child : skip
//   leaf node:   the cluster's K spheres in (eps, best_t) -> skip
//
// then the winner's shading.  The TPU kernel keeps its rays as (G, 128) lane
// arrays, reads tables with per-lane gathers and picks, per tile, a tree step
// or a leaf round by a scalar policy (:268-274).  None of that carries over:
// each ray's visit sequence and best_t depend only on its own path, so a
// per-ray walk gives the same result, and a ray stops when it dies instead
// of riding its tile.  A preorder walk visits each of the 2C-1 nodes at most
// once, so the walk is capped at 2C-1 steps (a corrupt table cannot hang the
// card; the plain version stops at the same cap).
//
// What bounds it on this card: FP32 issue.  Its data (the inner table 4 KB,
// leaf skips 512 B, spheres K x 4 KB: 316 KB at K = 79) is read from L1/L2,
// and the bytes it must move (the packed image) are far below the
// operations' time.  Lane operations counted in this source, each float32
// add, subtract, multiply, division, square root, conversion, comparison,
// min, max and select as one (loads, integer and predicate logic not
// counted); the plain version counts how often each part runs:
//   * every sphere slot tested (sphere_t to the discriminant's sign, and the
//     caller's compare and update): 3 (oc) + 5 (b) + 7 (c) + 3 (disc) + 1
//     (disc > 0) + 2 (t < best_t, the select of best_t) = 21;
//   * a slot with disc > 0 adds sqrtf 1 + t0 2 + its window 2 + select 1 = 6;
//   * a far root tried (far_root, the near one outside the window) adds
//     t1 2 + its window 2 + select 1 = 5;
//   * an inner-node slab test, per axis: t0 2 + t1 2 + the two selects on
//     the sign of inv 2 + nan_max 3 (unordered test, fmaxf, select) +
//     nan_min 3 + the fail test 1 = 13, so 39 (the sign tests are hoisted);
//   * a bounce's set-up: a 5 + 1/a 1 + the three 1/d 3 + their sign tests
//     3 + the hit test 1 = 13; then a hit's re-intersection and shading 68
//     (oc 3, b 5, c 7, disc 3, its guard 2, sqrtf 1, t0 2, t1 2, w_hi 1,
//     the window 3, p 6, 1/r 1, n 6, 1/sqrtf(a) 2, u 3, u.n 5, r 7, the
//     scatter test 6, the light 3): 81 a hit bounce; or the sky's 15
//     (sqrtf and 1/ 2, uy 1, t 2, the gradient 7, the light 3): 28 a miss;
//   * every ray: its primary direction 21 and the packing 6 = 27.
// The simple design: the inner table and the leaf skips
// sit in shared memory, the sphere table is read through the read-only path,
// and the winner's fields are one indexed load after the walk.  Lanes of a
// warp walk different nodes, so the walk diverges; block tiles (32 x 16
// pixels) keep a warp's rays close.
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
// row k slot k of every cluster, fields cx cy cz rad cr cg cb 0; packed (n,)
// int32 in ray order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_math.cuh"

namespace {

constexpr int kLane = 128;           // most clusters; table lane width
constexpr int kThreads = 128;
constexpr float kBig = 1e9f;         // T_MAX: best_t before any hit
constexpr float kEps = 0.1f;         // SCENE_EPSILON
constexpr float kTMin = 0.0f;        // T_MIN

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// One staged slab test (pallas_traversal.py:213-228) against the box of
// inner node `node` in the window (T_MIN, best_t).
__device__ __forceinline__ bool slab_step(const float (*box)[kLane], int node,
                                          float best_t, float ox, float oy,
                                          float oz, float inv_dx, float inv_dy,
                                          float inv_dz) {
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {inv_dx, inv_dy, inv_dz};
  float t_lo = kTMin, t_hi = best_t;
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t0 = (box[k][node] - o[k]) * inv[k];
    const float t1 = (box[3 + k][node] - o[k]) * inv[k];
    const bool neg = inv[k] < 0.0f;
    t_lo = nan_max(neg ? t1 : t0, t_lo);
    t_hi = nan_min(neg ? t0 : t1, t_hi);
    ok = ok && !(t_hi <= t_lo);
  }
  return ok;
}

// A sphere's root in the search window (eps, best_t): the near root, else
// (with far_root) the far one, else kBig (pallas_traversal.py:238-258).
template <bool kFarRoot>
__device__ __forceinline__ float sphere_t(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float a, float inv_a, float cx,
                                          float cy, float cz, float r,
                                          float best_t) {
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  const float b = (ocx * dx + ocy * dy) + ocz * dz;
  const float c = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r * r;
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

template <bool kFarRoot>
__global__ void __launch_bounds__(kThreads)
traversal(const float* __restrict__ params, const float* __restrict__ inner,
          const float* __restrict__ leaf_skip,
          const float* __restrict__ spheres, int n_clusters, int leaf_size,
          int max_depth, int* __restrict__ packed_out, int n, int tile,
          int block_tiled) {
  __shared__ float box[6][kLane];
  __shared__ int links[3][kLane];          // left, skip, leaf skip
  for (int k = threadIdx.x; k < 9 * kLane; k += blockDim.x) {
    const int row = k / kLane, lane = k % kLane;
    if (row < 6)
      box[row][lane] = inner[k];
    else if (row < 8)
      links[row - 6][lane] = (int)inner[k];
    else
      links[2][lane] = (int)leaf_skip[lane];
  }
  __syncthreads();

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;

  const int C = n_clusters, K = leaf_size, NI = C - 1;
  float ox = params[9], oy = params[10], oz = params[11], dx, dy, dz;
  rt::primary_ray(params, g, tile, block_tiled, dx, dy, dz);
  float lr = 1.0f, lg = 1.0f, lb = 1.0f, rr = 0.0f, rg = 0.0f, rb = 0.0f;

  for (int depth = 0; depth < max_depth; ++depth) {
    const float a = (dx * dx + dy * dy) + dz * dz;
    const float inv_a = 1.0f / a;
    const float inv_dx = 1.0f / dx, inv_dy = 1.0f / dy, inv_dz = 1.0f / dz;

    // the walk (pallas_traversal.py:184-280)
    float best_t = kBig;
    int best_c = 0, best_k = 0;
    int cur = 0;                                       // the root
    for (int step = 0; cur >= 0 && step < 2 * C - 1; ++step) {
      if (cur < NI) {
        cur = slab_step(box, cur, best_t, ox, oy, oz, inv_dx, inv_dy, inv_dz)
                  ? links[0][cur]
                  : links[1][cur];
      } else {
        const int c = cur - NI;
        for (int k = 0; k < K; ++k) {
          const float* s = spheres + (size_t)k * 8 * kLane + c;
          const float t = sphere_t<kFarRoot>(
              ox, oy, oz, dx, dy, dz, a, inv_a, __ldg(s), __ldg(s + kLane),
              __ldg(s + 2 * kLane), __ldg(s + 3 * kLane), best_t);
          if (t < best_t) {
            best_t = t;
            best_c = c;
            best_k = k;
          }
        }
        cur = links[2][c];
      }
    }

    if (!(best_t < kBig)) {                            // miss: sky
      const float uy = dy * (1.0f / sqrtf(a));
      const float t = 0.5f * (uy + 1.0f);
      rr = lr * rt::sky(t, rt::kSkyR);
      rg = lg * rt::sky(t, rt::kSkyG);
      rb = lb * rt::sky(t, rt::kSkyB);
      break;
    }
    // the winner's fields, one indexed load (pallas_traversal.py:283-295)
    const float* w = spheres + (size_t)best_k * 8 * kLane + best_c;
    const float scx = __ldg(w), scy = __ldg(w + kLane),
                scz = __ldg(w + 2 * kLane), srad = __ldg(w + 3 * kLane);
    // shading (pallas_traversal.py:303-334)
    const float ocx = ox - scx, ocy = oy - scy, ocz = oz - scz;
    const float b = (ocx * dx + ocy * dy) + ocz * dz;
    const float c = ((ocx * ocx + ocy * ocy) + ocz * ocz) - srad * srad;
    const float disc = b * b - a * c;
    const float sq = sqrtf(disc > 0.0f ? disc : 1.0f);
    const float t0 = (-b - sq) * inv_a;
    const float t1 = (-b + sq) * inv_a;
    const float w_hi = best_t + 1.0f;
    const float t2 = (t0 < w_hi && t0 > kTMin) ? t0 : t1;
    const float px = ox + t2 * dx, py = oy + t2 * dy, pz = oz + t2 * dz;
    const float inv_r = 1.0f / srad;
    const float nx = (px - scx) * inv_r, ny = (py - scy) * inv_r,
                nz = (pz - scz) * inv_r;
    const float inv_dn = 1.0f / sqrtf(a);
    const float ux = dx * inv_dn, uy = dy * inv_dn, uz = dz * inv_dn;
    const float udn = (ux * nx + uy * ny) + uz * nz;
    const float rx = ux - (2.0f * udn) * nx;
    const float ry = uy - (2.0f * udn) * ny;
    const float rz = uz - (2.0f * udn) * nz;
    if (!(((rx * nx + ry * ny) + rz * nz) > 0.0f)) break;   // absorbed
    lr = lr * __ldg(w + 4 * kLane);
    lg = lg * __ldg(w + 5 * kLane);
    lb = lb * __ldg(w + 6 * kLane);
    ox = px; oy = py; oz = pz;
    dx = rx; dy = ry; dz = rz;
  }
  // 255.99 quantization, truncation toward zero (ray.fut:156-162)
  packed_out[g] = ((int)(255.99f * rr) << 16) | ((int)(255.99f * rg) << 8) |
                  (int)(255.99f * rb);
}

}  // namespace

extern "C" int rt_traversal_launch(const float* params, const float* inner,
                                   const float* leaf_skip,
                                   const float* spheres, int n_clusters,
                                   int leaf_size, int max_depth, int far_root,
                                   int* packed_out, int n, int tile,
                                   int block_tiled, void* stream) {
  if (n_clusters < 2 || n_clusters > kLane || leaf_size < 1 ||
      max_depth < 0 || n <= 0 || tile <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (far_root)
    traversal<true><<<blocks, kThreads, 0, s>>>(
        params, inner, leaf_skip, spheres, n_clusters, leaf_size, max_depth,
        packed_out, n, tile, block_tiled);
  else
    traversal<false><<<blocks, kThreads, 0, s>>>(
        params, inner, leaf_skip, spheres, n_clusters, leaf_size, max_depth,
        packed_out, n, tile, block_tiled);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
