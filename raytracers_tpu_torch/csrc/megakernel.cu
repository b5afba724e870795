// K1, the forward megakernel of the sphere ray tracer, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracers_tpu/render/pallas_kernel.py:_megakernel
// (the Pallas megakernel: fused ray generation or state load, then a bounce
// loop of cluster culling, occlusion gating, packed-key closest hit over
// clusters of 32, 64 or 128 spheres, re-intersection and mirror shading).  It computes what
// that kernel computes per ray, not its tile mechanics: one thread owns one
// ray and runs its whole bounce loop, so a ray stops when it dies instead of
// riding its tile's deepest ray.  Culling and the occlusion gate therefore act
// per ray; culling is conservative, so only a candidate in the same 2^-16
// key-floor bucket can be dropped, and the plain torch version
// (render/megakernel.py:megakernel_reference) applies the same per-ray gates.
//
// What bounds it on this card: FP32 issue on the visit math.  Per (ray,
// sphere) slot, with FMA contraction off, 29 plain lane operations and one
// IEEE square root: the quadratic 17 (oc 3, b 5, c 6, disc 3), the far-root
// search 9 (-b - sq, -b + sq, two window compares, disc > 0, an and, two
// selects, the lane loop's own step) and the key 3 (mask, lane, min).  The
// near-root search (kFarRoot = false) drops -b + sq, one compare and one
// select: 26 and the root.  An AABB row of the cull and occlusion gate: 25
// plain.  A bounce (set-up, readback and shading): 52 plain (an
// estimate), 2 square roots (the re-intersection's, and sqrtf(a) of the unit
// direction) and 6 divisions (1/dx, 1/dy, 1/dz, 1/a, 1/rad, 1/sqrtf(a)).
// -prec-sqrt and -prec-div make a square root and a division sequences of a
// MUFU instruction, refinement and a slow-path branch: M1
// (csrc/microbench.cu) measures each at 8.84 and 8.77 multiply-equivalents
// (docs/MICROBENCH_H100.json, NVIDIA H100 80GB HBM3, 700.00 W), so a slot
// test is charged 37.84 lane operations (chip_smoke.py, SQRT_OPS, DIV_OPS).
// Its data is a
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
// Scene scale (K1e, layouts of CB > 1 cull blocks of CR clusters, C > 128;
// pallas_kernel.py:526-566, 796-838): a two-level cull.  Each ray tests the
// CB block unions, held in shared memory (2.9 KB for a 1M-sphere soup's
// CB = 123); only for a block whose union it meets does it read that
// block's cluster AABBs, through the read-only cache, and visit the
// clusters that pass, in array order behind the occlusion gate.  The
// sphere tables stay in global memory (32 MB at 1M spheres, within the
// 50 MB L2), where the TPU streams them from HBM by DMA (:340-475).  Lanes
// of a warp may enter different blocks, so the loads stop being warp-
// uniform there; the sweep is the same per-ray semantics as the TPU's
// unrolled (CB <= 4) and dynamic sweeps, with no tail peel (:789-791).
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
// K1f, the remaining static modes (pallas_kernel.py:162-163, 634-639,
// 672-679, 725): the cluster width W (32, 64 or 128 sphere rows) and the
// near-root-only search are template parameters, so each of the 3 x 2 x 2
// instantiations has a static visit trip count.  The key keeps its 7 lane
// bits (lanes < W fit) and the record slot stays cluster*128 + lane, so K1d's
// records and K2 are width-agnostic.  The forced occlusion gate is the `occl`
// launch argument, which the wrapper sets.  JAX's lane groups gate the rays
// of a tile in groups; this kernel gates each ray alone, the limit of that
// partition, so they change nothing here.
//
// Layouts: params (24,) f32; sphT (C,W,8) f32 rows cx cy cz rad cr cg cb r2;
// aabbT (CB,CR,8) rows (mnx mny mnz mxx mxy mxz pad pad), the first C used;
// superT (1,SBR,8) the block unions in the same rows, the first CB used; state
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
constexpr int kMaxClusters = 128;   // single-level: boxes in shared memory
constexpr int kMaxBlocks = 2048;    // two-level: block unions, 48 KB
constexpr int kThreads = 128;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Slab test of a ray against one AABB: whether its [0, kBig) interval
// meets the box, with the entry distance in lo.  The test fails only on
// hi <= lo, so a NaN stage (an axis-parallel ray on a slab plane) keeps the
// box (pallas_kernel.py:513-515).
__device__ __forceinline__ bool slab(float mnx, float mny, float mnz,
                                     float mxx, float mxy, float mxz,
                                     float ox, float oy, float oz,
                                     float inv_dx, float inv_dy, float inv_dz,
                                     float& lo) {
  float t0 = (mnx - ox) * inv_dx, t1 = (mxx - ox) * inv_dx;
  lo = nan_min(t0, t1);
  float hi = nan_max(t0, t1);
  t0 = (mny - oy) * inv_dy;
  t1 = (mxy - oy) * inv_dy;
  lo = nan_max(lo, nan_min(t0, t1));
  hi = nan_min(hi, nan_max(t0, t1));
  t0 = (mnz - oz) * inv_dz;
  t1 = (mxz - oz) * inv_dz;
  lo = nan_max(lo, nan_min(t0, t1));
  hi = nan_min(hi, nan_max(t0, t1));
  return !(nan_min(hi, kBig) <= nan_max(lo, 0.0f));
}

// The packed-key closest hit over the first `rows` spheres of cluster c of
// a table of kW-row clusters; the winner moves only on a strictly smaller
// key.  kFarRoot: the far root is tried where the near one fails the window.
template <int kW, bool kFarRoot>
__device__ __forceinline__ void visit(const float* __restrict__ sphT, int c,
                                      int rows, float ox, float oy, float oz,
                                      float dx, float dy, float dz, float a,
                                      float epsa, int& krun, int& wcl,
                                      int& n_slots) {
  const float* s = sphT + (size_t)c * kW * 8;
  int kmin = 0x7fffffff;
  for (int l = 0; l < rows; ++l) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(s + 8 * l));
    const float r2 = __ldg(s + 8 * l + 7);
    const rt::Quad qd = rt::quad(ox, oy, oz, dx, dy, dz, a, q.x, q.y, q.z,
                                 r2);
    // sqrtf is NaN on a miss, which the search masks
    const float sq = sqrtf(qd.disc);
    const float tv = kFarRoot ? rt::search_m(qd, sq, epsa)
                              : rt::search_m_near(qd, sq, epsa);
    kmin = min(kmin, (__float_as_int(tv) & kKeyMask) | l);
  }
  n_slots += rows;
  if (kmin < krun) {
    krun = kmin;
    wcl = c;
  }
}

// kTwoLevel: the scene-scale sweep (K1e).  Otherwise one cull block of at
// most 128 clusters, or no culling.  kW: sphere rows per cluster; kFarRoot:
// the far-root fallback of the search (K1f).
template <bool kTwoLevel, int kW, bool kFarRoot>
__global__ void __launch_bounds__(kThreads)
megakernel(const float* __restrict__ params, const float* __restrict__ sphT,
           const float* __restrict__ aabbT, const float* __restrict__ superT,
           int n_clusters, int n_blocks, int cull_rows, int tail_rows,
           int cull, int occl, const float* __restrict__ state_in,
           float* __restrict__ state_out, int* __restrict__ packed_out,
           int* __restrict__ stats_out, int* __restrict__ rec_out,
           float* __restrict__ pay_out, int rec_depth, int n, int tile,
           int block_tiled) {
  const int C = n_clusters;
  const int CB = n_blocks;
  // single-level: the cluster AABBs; two-level: the block unions, row k of
  // face k at sup[k * CB + b] (the blocks' cluster AABBs are read from
  // global memory, through the read-only cache, only for entered blocks)
  __shared__ float box[kTwoLevel ? 1 : 6][kTwoLevel ? 1 : kMaxClusters];
  extern __shared__ float sup[];
  if constexpr (kTwoLevel) {
    for (int k = threadIdx.x; k < 6 * CB; k += blockDim.x)
      sup[(k % 6) * CB + k / 6] = superT[(k / 6) * 8 + k % 6];
  } else if (cull) {
    for (int k = threadIdx.x; k < 6 * C; k += blockDim.x)
      box[k % 6][k / 6] = aabbT[(k / 6) * 8 + k % 6];
  }
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
    if constexpr (kTwoLevel) {
      // K1e (pallas_kernel.py:526-566, 796-838): the block unions first;
      // in each block whose union the ray meets, its clusters' AABBs, then
      // the visits in array order behind the occlusion gate
      for (int b = 0; b < CB; ++b) {
        float lo;
        if (!slab(sup[b], sup[CB + b], sup[2 * CB + b], sup[3 * CB + b],
                  sup[4 * CB + b], sup[5 * CB + b], ox, oy, oz, inv_dx,
                  inv_dy, inv_dz, lo))
          continue;
        const int c0 = b * cull_rows;
        const int nb = min(cull_rows, C - c0);
        n_cull += nb;
        const float4* bx = reinterpret_cast<const float4*>(aabbT) + 2 * c0;
        for (int j = 0; j < nb; ++j) {
          const float4 p = __ldg(bx + 2 * j);
          const float4 q = __ldg(bx + 2 * j + 1);
          if (!slab(p.x, p.y, p.z, p.w, q.x, q.y, ox, oy, oz, inv_dx, inv_dy,
                    inv_dz, lo))
            continue;
          // occlusion gate: the box starts behind the best hit so far
          if (occl && lo * a >= __int_as_float(krun & kKeyMask)) continue;
          visit<kW, kFarRoot>(sphT, c0 + j, kW, ox, oy, oz, dx, dy, dz, a,
                              epsa, krun, wcl, n_slots);
        }
      }
      n_cull += CB;
    } else {
      for (int c = 0; c < C; ++c) {
        if (cull) {
          float lo;
          if (!slab(box[0][c], box[1][c], box[2][c], box[3][c], box[4][c],
                    box[5][c], ox, oy, oz, inv_dx, inv_dy, inv_dz, lo))
            continue;
          // occlusion gate: the box starts behind the best hit so far
          if (occl && lo * a >= __int_as_float(krun & kKeyMask)) continue;
        }
        visit<kW, kFarRoot>(sphT, c, (c == C - 1) ? tail_rows : kW, ox, oy,
                            oz, dx, dy, dz, a, epsa, krun, wcl, n_slots);
      }
      n_cull += cull ? C : 0;
    }
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
    const int lane = krun & (kLane - 1);                 // < kW on a hit
    const float* w = sphT + ((size_t)wcl * kW + lane) * 8;
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(w));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(w + 4));
    const rt::Bounce h = rt::bounce(ox, oy, oz, dx, dy, dz, a, s0.x, s0.y,
                                    s0.z, s0.w, __int_as_float(krun & kKeyMask));
    if (h.scatter) {                                     // mirror bounce
      if (rec_out != nullptr) {
        // K1d: the winner's slot (cluster*128 + lane at any width), and
        // with pay its 7 fields
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

// The launch's arguments, passed on to the instantiation it selects.
struct Args {
  const float *params, *sphT, *aabbT, *superT;
  int n_clusters, n_blocks, cull_rows, tail_rows, cull, occl;
  const float* state_in;
  float* state_out;
  int *packed_out, *stats_out, *rec_out;
  float* pay_out;
  int rec_depth, n, tile, block_tiled;
};

template <bool kTwoLevel, int kW, bool kFarRoot>
void launch(const Args& a, size_t smem, cudaStream_t s) {
  megakernel<kTwoLevel, kW, kFarRoot>
      <<<(a.n + kThreads - 1) / kThreads, kThreads, smem, s>>>(
          a.params, a.sphT, a.aabbT, a.superT, a.n_clusters, a.n_blocks,
          a.cull_rows, a.tail_rows, a.cull, a.occl, a.state_in, a.state_out,
          a.packed_out, a.stats_out, a.rec_out, a.pay_out, a.rec_depth, a.n,
          a.tile, a.block_tiled);
}

template <int kW>
int launch_width(const Args& a, int two_level, int far_root,
                 cudaStream_t s) {
  if (a.tail_rows < 1 || a.tail_rows > kW) return (int)cudaErrorInvalidValue;
  if (two_level) {
    // the scene-scale sweep visits whole clusters: no tail peel
    if (!a.cull || a.n_blocks < 2 || a.n_blocks > kMaxBlocks ||
        a.tail_rows != kW)
      return (int)cudaErrorInvalidValue;
    const size_t smem = 6 * a.n_blocks * sizeof(float);
    far_root ? launch<true, kW, true>(a, smem, s)
             : launch<true, kW, false>(a, smem, s);
  } else {
    if (a.cull && a.n_clusters > kMaxClusters)
      return (int)cudaErrorInvalidValue;
    far_root ? launch<false, kW, true>(a, 0, s)
             : launch<false, kW, false>(a, 0, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_megakernel_launch(
    const float* params, const float* sphT, const float* aabbT,
    const float* superT, int n_clusters, int n_blocks, int cull_rows,
    int tail_rows, int cull, int occl, int two_level, int cluster_width,
    int far_root, const float* state_in, float* state_out, int* packed_out,
    int* stats_out, int* rec_out, float* pay_out, int rec_depth, int n,
    int tile, int block_tiled, void* stream) {
  if (n_clusters < 1 || n <= 0 || (rec_out != nullptr && rec_depth < 0) ||
      n_blocks < 1 || cull_rows < 1 ||
      (long long)n_blocks * cull_rows < n_clusters)
    return (int)cudaErrorInvalidValue;
  const Args a{params,   sphT,      aabbT,      superT,    n_clusters,
               n_blocks, cull_rows, tail_rows,  cull,      occl,
               state_in, state_out, packed_out, stats_out, rec_out,
               pay_out,  rec_depth, n,          tile,      block_tiled};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cluster_width) {
    case 32:
      return launch_width<32>(a, two_level, far_root, s);
    case 64:
      return launch_width<64>(a, two_level, far_root, s);
    case kLane:
      return launch_width<kLane>(a, two_level, far_root, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
