// The megakernel's scene layout, built on Hopper (sm_90a) in two launches
// around the caller's stable sort.
//
// It replaces no TPU kernel.  The JAX package builds the layout with XLA
// operations (raytracers_tpu/render/pallas_kernel.py:121-300 over
// raytracers_tpu/bvh/lbvh.py:239-258), which XLA fuses into a few programs;
// the port's torch version of the same build (render/megakernel.py,
// _build_pallas_scene_plain) is about 150 aten operations, 111-128 of them
// device launches.  The fwd+bwd engine builds the layout every step, and
// the card waited through that whole chain at the start of each step.
// Here the build is:
//
//   stage 0, layout_codes: each sphere's AABB centre min + 0.5 (max - min)
//     (min = c - r, max = c + r), the per-axis minimum and maximum of the
//     centres over all n spheres (a grid-stride pass, one partial a block,
//     a grid-wide barrier, each block folding every partial), then each
//     centre normalised to [0, 1] per axis (a degenerate axis to 0) and its
//     30-bit Morton code on the 1024^3 grid, in uint32 arithmetic
//     (bvh/morton.py);
//   torch.sort(codes, stable=True), the caller's: the Morton permutation;
//   stage 1, layout_pack: a block per cluster, W threads, one a slot
//     (grid-stride over the clusters when C exceeds the blocks the card
//     holds at once).  A slot's sphere comes through the permutation (and
//     the cluster permutation of the front-to-back order, when given);
//     the last cluster's slots past n are radius-0, colour-0 rows at the
//     last sorted centre.  The block writes the cluster's rows of sph8
//     (C,8,W) and sphT (C,W,8) (r^2 one IEEE multiply), its row of order
//     (C,128) (-1 for padding and the lanes >= W), its AABB, folded in the
//     block, as its row of aabbT (CB*CR,8), and, for the last cluster, the
//     tail peel's first P rows (tailT (P,8), tail8 (8,P)).  Rows C.. of
//     aabbT are +inf/-inf.  After a grid-wide barrier a block folds each
//     block of CR clusters' boxes into its row of superT (SBR,8).
//
// Both launches are cooperative (cudaLaunchCooperativeKernel), so every
// block is resident and the barrier is cooperative_groups' grid sync: no
// counter to clear, no launch more.  The grid is at most what the card
// holds at once.
//
// Arithmetic: IEEE float32 without contraction (-fmad=false), so each
// centre, normalised coordinate, radius square and AABB equals the plain
// build's bit for bit.  Minima and maxima propagate NaN as torch's amin
// and amax do.  They fold in another order than torch's reductions, so a
// box coordinate that is a signed zero may differ in its sign alone.
//
// What bounds it: latency, not bytes or operations.  A slot reads 28 B of
// its sphere (gathered) and 8 B of the permutation and writes 68 B (both
// tables and order); at n = 10^4 that is about 1 MB, under a microsecond at
// the card's HBM rate, so each launch is bound by its dependent loads and
// its grid barrier.  On an NVIDIA H100 80GB HBM3 at 700 W (torch.profiler's
// device times, medians of 20 builds): layout_codes 6.3 / 6.5 us and
// layout_pack 4.1 / 3.8 us for irreg (10,000 spheres) / rgbbox (400), the
// stable sort between them 43 us in 14 operations (a radix sort past 4,096
// keys) / 20 us in 5; the plain build 0.20 / 0.26 ms of device time in
// 128 / 111 operations.  The design's point is the count of launches and
// host calls, which set the step's time before.

// Layouts: center (n,3), radius (n,), color (n,3) f32, contiguous; perm
// (n,) i64 the sorted order, or null for the identity (n <= 128: one
// padded cluster, unsorted); cperm (C,) i64 the front-to-back cluster
// order, or null; codes (n,) i32; partial (max_blocks,6) f32 scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLane = 128;          // slots a cluster encodes in order
constexpr int kCodesThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Fold lo (minima) and hi (maxima) over the block; every thread gets the
// result.  smem holds 6 floats a warp.  blockDim.x is a multiple of 32.
__device__ void block_fold(float lo[3], float hi[3], float* smem) {
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      lo[q] = min_nan(lo[q], __shfl_xor_sync(kFull, lo[q], o));
      hi[q] = max_nan(hi[q], __shfl_xor_sync(kFull, hi[q], o));
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      smem[warp * 6 + q] = lo[q];
      smem[warp * 6 + 3 + q] = hi[q];
    }
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    lo[q] = smem[q];
    hi[q] = smem[3 + q];
  }
  for (int w = 1; w < warps; ++w) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      lo[q] = min_nan(lo[q], smem[w * 6 + q]);
      hi[q] = max_nan(hi[q], smem[w * 6 + 3 + q]);
    }
  }
  __syncthreads();                  // smem free for the next fold
}

// centre(sphere_aabb(s)) of sphere i (vec.py centre, geometry.py
// sphere_aabb)
__device__ __forceinline__ void aabb_centre(const float* __restrict__ center,
                                            const float* __restrict__ radius,
                                            int i, float c[3]) {
  const float r = radius[i];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float x = center[3 * i + q];
    const float lo = x - r;
    const float hi = x + r;
    c[q] = lo + 0.5f * (hi - lo);
  }
}

// morton.expand_bits: the low 10 bits of v spread to every third bit
__device__ __forceinline__ unsigned expand_bits(unsigned v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

__global__ void __launch_bounds__(kCodesThreads)
layout_codes(const float* __restrict__ center,
             const float* __restrict__ radius, int n, float* partial,
             int* __restrict__ codes) {
  __shared__ float smem[kCodesThreads / 32 * 6];
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  // a thread's first sphere's centre stays in registers for its code
  float c0[3];
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (int i = first; i < n; i += stride) {
    float c[3];
    aabb_centre(center, radius, i, c);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (i == first) c0[q] = c[q];
      lo[q] = min_nan(lo[q], c[q]);
      hi[q] = max_nan(hi[q], c[q]);
    }
  }
  block_fold(lo, hi, smem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      partial[blockIdx.x * 6 + q] = lo[q];
      partial[blockIdx.x * 6 + 3 + q] = hi[q];
    }
  }
  grid.sync();                      // orders the partials' stores too
  // every block folds the grid's partials (gridDim.x <= blockDim.x)
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    lo[q] = CUDART_INF_F;
    hi[q] = -CUDART_INF_F;
  }
  if (threadIdx.x < gridDim.x) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      lo[q] = __ldcg(partial + threadIdx.x * 6 + q);
      hi[q] = __ldcg(partial + threadIdx.x * 6 + 3 + q);
    }
  }
  block_fold(lo, hi, smem);
  float span[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) span[q] = hi[q] - lo[q];
  for (int i = first; i < n; i += stride) {
    float c[3];
    if (i == first) {
#pragma unroll
      for (int q = 0; q < 3; ++q) c[q] = c0[q];
    } else {
      aabb_centre(center, radius, i, c);
    }
    unsigned e[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      // morton.normalise_centres, then morton3d's clamp and truncation
      const float p = span[q] > 0.0f ? (c[q] - lo[q]) / span[q] : 0.0f;
      float x = p * 1024.0f;
      x = x < 0.0f ? 0.0f : x;
      x = x > 1023.0f ? 1023.0f : x;
      e[q] = expand_bits(static_cast<unsigned>(x));
    }
    codes[i] = static_cast<int>(e[0] * 4u + e[1] * 2u + e[2]);
  }
}

__global__ void __launch_bounds__(kLane)
layout_pack(const float* __restrict__ center, const float* __restrict__ radius,
            const float* __restrict__ color,
            const long long* __restrict__ perm,
            const long long* __restrict__ cperm, int n, int C, int CB, int CR,
            int SBR, int P, int pad_in_box, float* __restrict__ sphT,
            float* __restrict__ sph8, float* aabbT, float* __restrict__ superT,
            int* __restrict__ order, float* __restrict__ tailT,
            float* __restrict__ tail8) {
  __shared__ float smem[kLane / 32 * 6];
  cg::grid_group grid = cg::this_grid();
  const int j = threadIdx.x;
  const int W = blockDim.x;
  const long long last = perm != nullptr ? perm[n - 1] : n - 1;
  for (int i = blockIdx.x; i < CB * CR; i += gridDim.x) {
    if (i >= C) {                   // a padding cluster: an empty box
      if (j < 8)
        aabbT[i * 8 + j] = j < 3 ? CUDART_INF_F : (j < 6 ? -CUDART_INF_F
                                                         : 0.0f);
      continue;
    }
    const long long src = cperm != nullptr ? cperm[i] : i;
    const long long s = src * W + j;
    const bool real = s < n;
    const long long k = real ? (perm != nullptr ? perm[s] : s) : last;
    float f[8];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      f[q] = center[3 * k + q];
      f[4 + q] = real ? color[3 * k + q] : 0.0f;
    }
    f[3] = real ? radius[k] : 0.0f;
    f[7] = f[3] * f[3];
#pragma unroll
    for (int q = 0; q < 8; ++q) sph8[(i * 8 + q) * W + j] = f[q];
    const float4 a = make_float4(f[0], f[1], f[2], f[3]);
    const float4 b = make_float4(f[4], f[5], f[6], f[7]);
    float4* rowT = reinterpret_cast<float4*>(sphT + (i * W + j) * 8);
    rowT[0] = a;
    rowT[1] = b;
    for (int l = j; l < kLane; l += W)
      order[i * kLane + l] = (l == j && real) ? static_cast<int>(k) : -1;
    if (i == C - 1 && j < P) {
      float4* tT = reinterpret_cast<float4*>(tailT + j * 8);
      tT[0] = a;
      tT[1] = b;
#pragma unroll
      for (int q = 0; q < 8; ++q) tail8[q * P + j] = f[q];
    }
    // the cluster's box over its slots (padding rows too, except in the
    // one padded cluster of n <= 128, whose box is its spheres')
    const bool boxed = real || pad_in_box;
    float lo[3], hi[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      lo[q] = boxed ? f[q] - f[3] : CUDART_INF_F;
      hi[q] = boxed ? f[q] + f[3] : -CUDART_INF_F;
    }
    block_fold(lo, hi, smem);
    if (j < 8)
      aabbT[i * 8 + j] = j < 3 ? lo[j] : (j < 6 ? hi[j - 3] : 0.0f);
  }
  grid.sync();                      // orders aabbT's stores too
  // superT: row b < CB the union of aabbT's rows b*CR .. b*CR + CR - 1,
  // folded over the block
  for (int b = blockIdx.x; b < SBR; b += gridDim.x) {
    float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
    float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int r = j; b < CB && r < CR; r += W) {
      const float* row = aabbT + (b * CR + r) * 8;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        lo[q] = min_nan(lo[q], __ldcg(row + q));
        hi[q] = max_nan(hi[q], __ldcg(row + 3 + q));
      }
    }
    block_fold(lo, hi, smem);
    if (j < 8)
      superT[b * 8 + j] = j < 3 ? lo[j] : (j < 6 ? hi[j - 3] : 0.0f);
  }
}

// The blocks of `threads` threads that the card holds at once.
cudaError_t co_resident(const void* fn, int threads, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        0);
  *blocks = sms * per_sm;
  return err;
}

}  // namespace

// stage 0: layout_codes over n spheres, with at most max_blocks partials;
// stage 1: layout_pack of C clusters of W slots.  Both on `stream`,
// cooperative; returns the launch's error code (0: launched).
extern "C" int rt_layout_launch(
    int stage, const float* center, const float* radius, const float* color,
    const long long* perm, const long long* cperm, int* codes, float* partial,
    int max_blocks, float* sphT, float* sph8, float* aabbT, float* superT,
    int* order, float* tailT, float* tail8, int n, int C, int W, int CB,
    int CR, int SBR, int P, int pad_in_box, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int resident = 0;
  cudaError_t err;
  if (stage == 0) {
    if (n < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
    err = co_resident((const void*)layout_codes, kCodesThreads, &resident);
    if (err != cudaSuccess) return (int)err;
    int blocks = (n + kCodesThreads - 1) / kCodesThreads;
    blocks = blocks < resident ? blocks : resident;
    blocks = blocks < max_blocks ? blocks : max_blocks;
    blocks = blocks < kCodesThreads ? blocks : kCodesThreads;
    if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&center, &radius, &n, &partial, &codes};
    err = cudaLaunchCooperativeKernel((const void*)layout_codes, dim3(blocks),
                                      dim3(kCodesThreads), args, 0, st);
    return (int)err;
  }
  if (stage != 1 || n < 1 || C < 1 || CB * CR < C || SBR < CB || P < 1 ||
      P > W || (W != 32 && W != 64 && W != kLane))
    return (int)cudaErrorInvalidValue;
  err = co_resident((const void*)layout_pack, W, &resident);
  if (err != cudaSuccess) return (int)err;
  const int work = CB * CR > SBR ? CB * CR : SBR;
  int blocks = work < resident ? work : resident;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&center, &radius, &color, &perm,  &cperm, &n,
                  &C,      &CB,     &CR,    &SBR,   &P,     &pad_in_box,
                  &sphT,   &sph8,   &aabbT, &superT, &order, &tailT,
                  &tail8};
  err = cudaLaunchCooperativeKernel((const void*)layout_pack, dim3(blocks),
                                    dim3(W), args, 0, st);
  return (int)err;
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
