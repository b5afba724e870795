// K1, the forward megakernel of the sphere ray tracer, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracers_tpu/render/pallas_kernel.py:_megakernel
// (the Pallas megakernel: fused ray generation or state load, then a bounce
// loop of cluster culling, occlusion gating, packed-key closest hit over
// 128-sphere clusters, re-intersection and mirror shading).  It computes what
// that kernel computes per ray, not its tile mechanics: one thread owns one
// ray and runs its whole bounce loop, so a ray stops when it dies instead of
// riding its tile's deepest ray.  Culling and the occlusion gate therefore act
// per ray; culling is conservative, so only a candidate in the same 2^-16
// key-floor bucket can be dropped, and the plain torch version
// (render/megakernel.py:megakernel_reference) applies the same per-ray gates.
//
// What bounds it on this card: FP32 issue on the visit math, about 30 lane
// operations per (ray, sphere) slot with FMA contraction off.  Its data is a
// few hundred KB (irreg's sphere table is 316 KB), resident in L2; the bytes
// it must move (ray state in and out) are far below the operations' time.
// The simple design does three things about that: the cluster AABBs (at most
// 128 x 6 floats) sit in shared memory, so the per-ray cull reads no global
// memory; warps sweep clusters in the same order, so sphere loads are warp-
// uniform broadcasts from L1/L2; and the winner's fields are read back with
// one indexed load after the sweep, not tracked through it.  Measured on an
// H100 at 700 W, the main path runs at 7-15% of that operation bound: the
// late phases, where a few rays each run a long bounce chain on one thread,
// are bound by that thread's instruction latency instead (PERF.md).
//
// Arithmetic contract (bit-equal to the plain version, which the tests hold
// against the JAX package): that of ray_math.cuh, which K2 shares, plus
//   * min/max propagate NaN as XLA's do (a NaN slab stage keeps a cluster);
//   * the key is (bits(m) & ~0x7F) | lane with m = a*t, clusters are swept in
//     array order and the winner moves only on a strictly smaller key.
//
// Record mode (K1d, pallas_kernel.py:934-1015) adds, per step of a segment of
// static depth D, the winner's slot cluster*128 + lane for a mirror bounce,
// -1 for a miss, -3 for an absorbed hit and -2 for the steps after the ray's
// death; with pay, the bounce winner's 7 fields.  The forward arithmetic is
// unchanged: the records are written beside it.
//
// Layouts: params (24,) f32; sphT (C,128,8) f32 rows cx cy cz rad cr cg cb r2;
// aabbT rows of 8 (mnx mny mnz mxx mxy mxz pad pad), the first C used; state
// (13,n) f32 rows ox oy oz dx dy dz lr lg lb rr rg rb active; packed (n,)
// int32; stats (3,n) int32 rows sphere rows tested, bounces, AABB slab rows;
// rec (D,n) int32; pay (D,8,n) f32 rows cx cy cz rad cr cg cb, written only
// where rec >= 0 (row 7 never).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_math.cuh"

namespace {

using rt::kBig;
using rt::kKeyMask;
using rt::kLane;
constexpr int kMaxClusters = 128;
constexpr int kThreads = 128;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__global__ void __launch_bounds__(kThreads)
megakernel(const float* __restrict__ params, const float* __restrict__ sphT,
           const float* __restrict__ aabbT, int n_clusters, int tail_rows,
           int cull, int occl, const float* __restrict__ state_in,
           float* __restrict__ state_out, int* __restrict__ packed_out,
           int* __restrict__ stats_out, int* __restrict__ rec_out,
           float* __restrict__ pay_out, int rec_depth, int n, int tile,
           int block_tiled) {
  __shared__ float box[6][kMaxClusters];
  const int C = n_clusters;
  for (int k = threadIdx.x; k < 6 * C; k += blockDim.x)
    box[k % 6][k / 6] = aabbT[(k / 6) * 8 + k % 6];
  __syncthreads();

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;

  float ox, oy, oz, dx, dy, dz, lr, lg, lb, rr, rg, rb, act;
  if (state_in == nullptr) {
    rt::primary_ray(params, g, tile, block_tiled, dx, dy, dz);
    ox = params[9];
    oy = params[10];
    oz = params[11];
    lr = lg = lb = act = 1.0f;
    rr = rg = rb = 0.0f;
  } else {
    ox = state_in[0 * n + g];  oy = state_in[1 * n + g];
    oz = state_in[2 * n + g];  dx = state_in[3 * n + g];
    dy = state_in[4 * n + g];  dz = state_in[5 * n + g];
    lr = state_in[6 * n + g];  lg = state_in[7 * n + g];
    lb = state_in[8 * n + g];  rr = state_in[9 * n + g];
    rg = state_in[10 * n + g]; rb = state_in[11 * n + g];
    act = state_in[12 * n + g];
  }

  // a record's depth is the static depth of its segment (K1d)
  const int max_depth = rec_out != nullptr ? rec_depth : (int)params[13];
  int n_slots = 0, n_bounces = 0, n_cull = 0;
  int depth = 0;
  for (; depth < max_depth && act > 0.0f; ++depth) {
    const float a = (dx * dx + dy * dy) + dz * dz;
    const float epsa = rt::kEps * a;
    const float inv_dx = 1.0f / dx, inv_dy = 1.0f / dy, inv_dz = 1.0f / dz;

    // closest hit: culled packed-key sweep (pallas_kernel.py:481-864)
    int krun = (__float_as_int(kBig) & kKeyMask) | (kLane - 1);
    int wcl = 0;
    for (int c = 0; c < C; ++c) {
      if (cull) {
        float t0 = (box[0][c] - ox) * inv_dx, t1 = (box[3][c] - ox) * inv_dx;
        float lo = nan_min(t0, t1), hi = nan_max(t0, t1);
        t0 = (box[1][c] - oy) * inv_dy;
        t1 = (box[4][c] - oy) * inv_dy;
        lo = nan_max(lo, nan_min(t0, t1));
        hi = nan_min(hi, nan_max(t0, t1));
        t0 = (box[2][c] - oz) * inv_dz;
        t1 = (box[5][c] - oz) * inv_dz;
        lo = nan_max(lo, nan_min(t0, t1));
        hi = nan_min(hi, nan_max(t0, t1));
        if (nan_min(hi, kBig) <= nan_max(lo, 0.0f)) continue;
        // occlusion gate: the box starts behind the best hit so far
        if (occl && lo * a >= __int_as_float(krun & kKeyMask)) continue;
      }
      const int rows = (c == C - 1) ? tail_rows : kLane;
      const float* s = sphT + (size_t)c * kLane * 8;
      int kmin = 0x7fffffff;
      for (int l = 0; l < rows; ++l) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(s + 8 * l));
        const float r2 = __ldg(s + 8 * l + 7);
        const rt::Quad qd = rt::quad(ox, oy, oz, dx, dy, dz, a, q.x, q.y,
                                     q.z, r2);
        // sqrtf is NaN on a miss, which search_m masks
        const float tv = rt::search_m(qd, sqrtf(qd.disc), epsa);
        kmin = min(kmin, (__float_as_int(tv) & kKeyMask) | l);
      }
      n_slots += rows;
      if (kmin < krun) {
        krun = kmin;
        wcl = c;
      }
    }
    n_cull += cull ? C : 0;
    ++n_bounces;

    // shading (pallas_kernel.py:866-983)
    if (krun >= (__float_as_int(kBig) & kKeyMask)) {     // miss: sky
      const float uy = dy * (1.0f / sqrtf(a));
      const float t = 0.5f * (uy + 1.0f);
      rr = lr * rt::sky(t, rt::kSkyR);
      rg = lg * rt::sky(t, rt::kSkyG);
      rb = lb * rt::sky(t, rt::kSkyB);
      act = 0.0f;
      if (rec_out != nullptr) rec_out[(size_t)depth * n + g] = -1;
      continue;
    }
    const int lane = krun & (kLane - 1);
    const float* w = sphT + ((size_t)wcl * kLane + lane) * 8;
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(w));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(w + 4));
    const rt::Bounce h = rt::bounce(ox, oy, oz, dx, dy, dz, a, s0.x, s0.y,
                                    s0.z, s0.w, __int_as_float(krun & kKeyMask));
    if (h.scatter) {                                     // mirror bounce
      if (rec_out != nullptr) {
        // K1d: the winner's slot, and with pay its 7 fields
        rec_out[(size_t)depth * n + g] = wcl * kLane + lane;
        if (pay_out != nullptr) {
          float* pw = pay_out + (size_t)depth * 8 * n + g;
          pw[0 * (size_t)n] = s0.x; pw[1 * (size_t)n] = s0.y;
          pw[2 * (size_t)n] = s0.z; pw[3 * (size_t)n] = s0.w;
          pw[4 * (size_t)n] = s1.x; pw[5 * (size_t)n] = s1.y;
          pw[6 * (size_t)n] = s1.z;
        }
      }
      lr = lr * s1.x;
      lg = lg * s1.y;
      lb = lb * s1.z;
      ox = h.px; oy = h.py; oz = h.pz;
      dx = h.rx; dy = h.ry; dz = h.rz;
      act = 1.0f;
    } else {                                             // absorbed: black
      if (rec_out != nullptr) rec_out[(size_t)depth * n + g] = -3;
      act = 0.0f;
    }
  }
  if (rec_out != nullptr) {
    // the steps after the ray's death, up to the segment's depth: inactive
    for (; depth < rec_depth; ++depth) rec_out[(size_t)depth * n + g] = -2;
  }

  if (state_out != nullptr) {
    state_out[0 * n + g] = ox;  state_out[1 * n + g] = oy;
    state_out[2 * n + g] = oz;  state_out[3 * n + g] = dx;
    state_out[4 * n + g] = dy;  state_out[5 * n + g] = dz;
    state_out[6 * n + g] = lr;  state_out[7 * n + g] = lg;
    state_out[8 * n + g] = lb;  state_out[9 * n + g] = rr;
    state_out[10 * n + g] = rg; state_out[11 * n + g] = rb;
    state_out[12 * n + g] = act;
  }
  if (packed_out != nullptr) {
    // 255.99 quantization, truncation toward zero (ray.fut:156-162)
    packed_out[g] = ((int)(255.99f * rr) << 16) | ((int)(255.99f * rg) << 8)
                    | (int)(255.99f * rb);
  }
  if (stats_out != nullptr) {
    stats_out[0 * n + g] = n_slots;
    stats_out[1 * n + g] = n_bounces;
    stats_out[2 * n + g] = n_cull;
  }
}

}  // namespace

extern "C" int rt_megakernel_launch(
    const float* params, const float* sphT, const float* aabbT, int n_clusters,
    int tail_rows, int cull, int occl, const float* state_in, float* state_out,
    int* packed_out, int* stats_out, int* rec_out, float* pay_out,
    int rec_depth, int n, int tile, int block_tiled, void* stream) {
  if (n_clusters < 1 || n_clusters > kMaxClusters || n <= 0 ||
      (rec_out != nullptr && rec_depth < 0))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  megakernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, sphT, aabbT, n_clusters, tail_rows, cull, occl, state_in,
      state_out, packed_out, stats_out, rec_out, pay_out, rec_depth, n, tile,
      block_tiled);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
