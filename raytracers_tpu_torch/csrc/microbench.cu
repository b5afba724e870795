// M1-M4, the probes of tools/microbench_tpu.py, for Hopper (sm_90a).
//
// Each probe computes what its TPU probe computes, at the TPU probe's amount
// of work (grid x tile), and answers the same question for this card:
//
//   M1 fma_kernel (:44)    the FP32 issue rate: `streams` independent chains
//                          a <- a*m + d per thread, as FMUL + FADD (what
//                          every kernel of the port issues under -fmad=false)
//                          or one FFMA; and the cost of an IEEE sqrtf
//                          (a <- sqrtf(a)), an IEEE division (a <- m / a) and
//                          the reciprocal the kernels divide by (a <- 1 / a),
//                          as they build them (-prec-sqrt=true
//                          -prec-div=true, render/_cuda.py);
//   M2 dot_kernel (:75)    the v4 kernel's small products, `iters` of them a
//                          tile, (lhs + salt + i) . rhs summed: pair
//                          (128,8)@(8,256), pairT (8,128)^T(8,256), payload
//                          (8,128)@(128,256); as an FP32 loop of fixed k
//                          order, as TF32 mma.sync, and as 3xTF32 (hi/lo
//                          split: hi*lo + lo*hi + hi*hi);
//   M3 reduce_kernel (:134) the minimum of 128 keys per column of a
//                          (128,256) block, v += 1 each iteration, the minima
//                          summed: one thread's serial loop over 128
//                          registers (K1's way), a warp of 4 keys a lane
//                          reduced by a __shfl_xor_sync butterfly, and
//                          __reduce_min_sync (int32);
//   M4 visit_kernel (:170) one 128-sphere cluster visit per iteration: the
//                          pair sums q and ll, disc, sqrtf, t0/t1, the window
//                          select, the key (bits(t) & ~0x7F) | row, its
//                          minimum, a strict-less update of krun and the
//                          winner's 8 payload fields read by index (the
//                          one-hot MXU dot of the TPU is an indexed load
//                          here); one thread per ray sweeping 128 rows (K1's
//                          design) or a warp per ray, 4 rows a lane, the key
//                          through __reduce_min_sync.
//
// Every probe reads its salt and inputs from device memory and writes its
// result, so nvcc cannot fold a loop.  The sources build with -fmad=false;
// M1's contracted variant asks for __fmaf_rn, the others for __fmul_rn and
// __fadd_rn, so one build serves both.  Each variant is bit-equal to its
// plain torch version (probes/microbench.py) but M1's FMA (within its
// iterations' ulps) and M2's TF32 routes (within the rounding of their
// operands): the arithmetic below is written in the order it is evaluated.
//
// What bounds each on this card: M1-M4 are issue-bound by design (a few KB
// of inputs, resident in L1/L2; the outputs are written once).  M1's
// uncontracted loop is 2 lane operations a step, FMA 1 (2 flops), a square
// root or a division 1 as the data sheet counts it, so M1's time over that
// bound is the multiply-equivalents it costs.  M2's TF32 routes are bound by
// the tensor cores' 495 TFLOP/s; the FP32 loop by the 33.5e12 lane
// operations a second.
//
// SASS (cuobjdump -sass of the build, CUDA 12.8; probes/microbench.py
// sass_counts, counts of every kernel in docs/MICROBENCH_H100.json): M1's
// 8-stream loop is unrolled 8 times, 64 steps a pass, and holds per step
//   mul_add  1 FMUL + 1 FADD (73 FMUL, 89 FADD in the kernel: the body, the
//            remainder loop, the set-up and the sum), no FFMA;
//   fma      1 FFMA (72 in the kernel), no FMUL or FADD in the loop;
//   sqrt     1 MUFU.RSQ, 2 FMUL.FTZ, 2 FFMA, an integer range test and a
//            branch to the slow-path call (73 MUFU, 147 FMUL, 147 FFMA,
//            72 CALL);
//   div      1 MUFU.RCP, 5 FFMA, 1 FCHK and a branch (73 MUFU, 369 FFMA,
//            72 FCHK, 72 CALL);
//   1/x      1 MUFU.RCP, 2 FFMA, 1 FADD.FTZ, a range test and a branch
//            (76 MUFU, 149 FFMA, 74 FADD.FTZ, 72 CALL).
// The MUFU unit issues 16 lanes a cycle an SM against the FP32 pipes' 128,
// so a root or a reciprocal costs about 8 multiply-equivalents before its
// refinement; M1 measures 8.84 and 8.77, and 16.39 for a general division.
//
// Layouts: salt (1,) f32.  M1 out (n,) f32.  M2 a (128,8) | (8,128) |
// (8,128), b (8,256) | (8,256) | (128,256), out (grid, M, 256) f32, M 128 |
// 128 | 8.  M3 v0 (128,256) f32 or i32, out (grid, 1, 256).  M4 sphT (128,8)
// f32 rows [cx cy cz 0 0 0 0 |c|^2 - r^2], sph8 (8,128) f32 payload fields,
// out (n/256, 8, 256) f32 = pay + (float)krun.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kT = 256;      // the TPU probe's lane width T
constexpr int kRows = 128;   // the TPU probe's sublane rows (LANE)

// ------------------------------------------------------------------ M1
enum { kMulAdd = 0, kFma = 1, kSqrt = 2, kDiv = 3, kRcp = 4 };

template <int kMode>
__device__ __forceinline__ float step(float a, float m, float d) {
  if constexpr (kMode == kMulAdd) return __fadd_rn(__fmul_rn(a, m), d);
  if constexpr (kMode == kFma) return __fmaf_rn(a, m, d);
  if constexpr (kMode == kSqrt) return sqrtf(a);
  if constexpr (kMode == kRcp) return 1.0f / a;
  return m / a;
}

template <int kMode, int kStreams>
__global__ void __launch_bounds__(256)
fma_probe(const float* __restrict__ salt, float* __restrict__ out, int iters,
          int n) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const float base = salt[0];
  float acc[kStreams];
#pragma unroll
  for (int u = 0; u < kStreams; ++u) acc[u] = __fadd_rn(base, (float)u);
  const float m = __fadd_rn(__fmul_rn(base, 0.5f), 0.9999f);
  const float d = __fadd_rn(base, 1e-7f);
#pragma unroll 8
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kStreams; ++u) acc[u] = step<kMode>(acc[u], m, d);
  }
  float s = acc[0];
#pragma unroll
  for (int u = 1; u < kStreams; ++u) s = __fadd_rn(s, acc[u]);
  out[g] = s;
}

template <int kMode>
int launch_fma(int streams, const float* salt, float* out, int iters, int n,
               cudaStream_t st) {
  const int blocks = (n + 255) / 256;
  switch (streams) {
    case 1: fma_probe<kMode, 1><<<blocks, 256, 0, st>>>(salt, out, iters, n);
      break;
    case 4: fma_probe<kMode, 4><<<blocks, 256, 0, st>>>(salt, out, iters, n);
      break;
    case 8: fma_probe<kMode, 8><<<blocks, 256, 0, st>>>(salt, out, iters, n);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// ------------------------------------------------------------------ M2
enum { kPair = 0, kPairT = 1, kPayload = 2 };

template <int kKind>
struct Dot {
  static constexpr int M = kKind == kPayload ? 8 : kRows;
  static constexpr int K = kKind == kPayload ? kRows : 8;
  static constexpr int N = kT;
  // lhs[r][k] in a's layout: (M,K) row-major, or (K,M) for pairT
  __device__ static int aidx(int r, int k) {
    return kKind == kPairT ? k * M + r : r * K + k;
  }
};

// (a) FP32 CUDA-core loop: one thread per row and 4 consecutive columns;
// r = sum_k (lhs[r][k] + s) * b[k][j] in k order, uncontracted, then
// acc = acc + r.
constexpr int kNC = 4;

template <int kKind>
__global__ void __launch_bounds__(128)
dot_fp32(const float* __restrict__ salt, const float* __restrict__ a,
         const float* __restrict__ b, float* __restrict__ out, int iters,
         int grid) {
  using S = Dot<kKind>;
  constexpr int kStrips = S::N / kNC;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= grid * S::M * kStrips) return;
  const int g = t / (S::M * kStrips);
  const int r = (t / kStrips) % S::M;
  const int j0 = (t % kStrips) * kNC;
  const float x = salt[0];
  float acc[kNC];
#pragma unroll
  for (int c = 0; c < kNC; ++c) acc[c] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const float s = __fadd_rn(x, (float)i);
    float rs[kNC];
#pragma unroll 8
    for (int k = 0; k < S::K; ++k) {
      const float l = __fadd_rn(__ldg(a + S::aidx(r, k)), s);
      const float4 bk = __ldg(reinterpret_cast<const float4*>(
          b + k * S::N + j0));
      const float bv[kNC] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const float p = __fmul_rn(l, bv[c]);
        rs[c] = k == 0 ? p : __fadd_rn(rs[c], p);
      }
    }
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[c] = __fadd_rn(acc[c], rs[c]);
  }
  *reinterpret_cast<float4*>(out + ((size_t)g * S::M + r) * S::N + j0) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// D = A(16x8, row) . B(8x8, col) + C in TF32 with float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (b) TF32 and (c) 3xTF32 mma.sync: one warp per 16x8 output tile, all
// iterations, D += A.B per k step of 8.  Fragments (PTX ISA, m16n8k8 .tf32):
// with q = lane / 4 and p = lane % 4, A holds (q, p), (q+8, p), (q, p+4),
// (q+8, p+4); B (p, q), (p+4, q); C (q, 2p), (q, 2p+1), (q+8, 2p),
// (q+8, 2p+1).  The payload's 8 rows fill half of a 16-row tile; the other
// half is zero.
template <int kKind, bool kSplit>
__global__ void __launch_bounds__(128)
dot_tf32(const float* __restrict__ salt, const float* __restrict__ a,
         const float* __restrict__ b, float* __restrict__ out, int iters,
         int grid) {
  using S = Dot<kKind>;
  constexpr int kMT = (S::M + 15) / 16, kNT = S::N / 8, kKS = S::K / 8;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= grid * kMT * kNT) return;
  const int g = warp / (kMT * kNT);
  const int m0 = ((warp / kNT) % kMT) * 16, n0 = (warp % kNT) * 8;
  const int q = lane / 4, p = lane % 4;
  const float x = salt[0];
  // B's fragments are the same every iteration: split them once
  uint32_t bh[kKS][2], bl[kKS][2];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = __ldg(b + (ks * 8 + p + 4 * h) * S::N + n0 + q);
      bh[ks][h] = to_tf32(v);
      bl[ks][h] = to_tf32(__fsub_rn(v, __uint_as_float(bh[ks][h])));
    }
  const bool lo_ok = m0 + q < S::M, hi_ok = m0 + q + 8 < S::M;
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < iters; ++i) {
    const float s = __fadd_rn(x, (float)i);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int k0 = ks * 8 + p;
      const float v[4] = {
          lo_ok ? __fadd_rn(__ldg(a + S::aidx(m0 + q, k0)), s) : 0.0f,
          hi_ok ? __fadd_rn(__ldg(a + S::aidx(m0 + q + 8, k0)), s) : 0.0f,
          lo_ok ? __fadd_rn(__ldg(a + S::aidx(m0 + q, k0 + 4)), s) : 0.0f,
          hi_ok ? __fadd_rn(__ldg(a + S::aidx(m0 + q + 8, k0 + 4)), s)
                : 0.0f};
      uint32_t ah[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ah[e] = to_tf32(v[e]);
      if constexpr (kSplit) {
        uint32_t al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          al[e] = to_tf32(__fsub_rn(v[e], __uint_as_float(ah[e])));
        mma_tf32(c, al, bh[ks]);
        mma_tf32(c, ah, bl[ks]);
      }
      mma_tf32(c, ah, bh[ks]);
    }
  }
  float* o = out + (size_t)g * S::M * S::N;
  if (lo_ok) {
    o[(m0 + q) * S::N + n0 + 2 * p] = c[0];
    o[(m0 + q) * S::N + n0 + 2 * p + 1] = c[1];
  }
  if (hi_ok) {
    o[(m0 + q + 8) * S::N + n0 + 2 * p] = c[2];
    o[(m0 + q + 8) * S::N + n0 + 2 * p + 1] = c[3];
  }
}

template <int kKind>
int launch_dot_kind(int route, const float* salt, const float* a,
                    const float* b, float* out, int iters, int grid,
                    cudaStream_t st) {
  using S = Dot<kKind>;
  if (route == 0) {
    const int threads = grid * S::M * (S::N / kNC);
    dot_fp32<kKind><<<(threads + 127) / 128, 128, 0, st>>>(salt, a, b, out,
                                                           iters, grid);
    return 0;
  }
  const int warps = grid * ((S::M + 15) / 16) * (S::N / 8);
  const int blocks = (warps * 32 + 127) / 128;
  if (route == 1)
    dot_tf32<kKind, false><<<blocks, 128, 0, st>>>(salt, a, b, out, iters,
                                                   grid);
  else if (route == 2)
    dot_tf32<kKind, true><<<blocks, 128, 0, st>>>(salt, a, b, out, iters,
                                                  grid);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

// ------------------------------------------------------------------ M3
template <typename V>
__device__ __forceinline__ V vmin(V x, V y) {
  return y < x ? y : x;
}

__device__ __forceinline__ float plus_one(float v) { return __fadd_rn(v, 1.0f); }
__device__ __forceinline__ int plus_one(int v) { return v + 1; }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ int add(int x, int y) { return x + y; }

// (a) one thread per column, its 128 keys in registers, a serial minimum
template <typename V>
__global__ void __launch_bounds__(128)
reduce_serial(const V* __restrict__ v0, V* __restrict__ out, int iters,
              int grid) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= grid * kT) return;
  const int j = t % kT;
  V v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = v0[r * kT + j];
  V acc = V(0);
  for (int i = 0; i < iters; ++i) {
    V m = v[0];
#pragma unroll
    for (int r = 1; r < kRows; ++r) m = vmin(m, v[r]);
    acc = add(acc, m);
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = plus_one(v[r]);
  }
  out[t] = acc;
}

// (b) a warp per column, rows lane + 32e for e < 4, a butterfly of
// __shfl_xor_sync; (c) the same with __reduce_min_sync (int32 only)
template <typename V, bool kRedux>
__global__ void __launch_bounds__(256)
reduce_warp(const V* __restrict__ v0, V* __restrict__ out, int iters,
            int grid) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= grid * kT) return;
  const int j = w % kT;
  V v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = v0[(lane + 32 * e) * kT + j];
  V acc = V(0);
  for (int i = 0; i < iters; ++i) {
    V m = vmin(vmin(v[0], v[1]), vmin(v[2], v[3]));
    if constexpr (kRedux) {
      m = __reduce_min_sync(0xffffffffu, m);
    } else {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = vmin(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    acc = add(acc, m);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = plus_one(v[e]);
  }
  if (lane == 0) out[w] = acc;
}

template <typename V>
int launch_reduce(int way, const V* v0, V* out, int iters, int grid,
                  cudaStream_t st) {
  if (way == 0) {
    reduce_serial<V><<<(grid * kT + 127) / 128, 128, 0, st>>>(v0, out, iters,
                                                             grid);
  } else if (way == 1) {
    reduce_warp<V, false><<<grid * kT / 8, 256, 0, st>>>(v0, out, iters,
                                                        grid);
  } else if (way == 2) {
    if constexpr (std::is_same_v<V, int>)
      reduce_warp<V, true><<<grid * kT / 8, 256, 0, st>>>(v0, out, iters,
                                                         grid);
    else
      return (int)cudaErrorInvalidValue;   // __reduce_min_sync: int32 only
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// ------------------------------------------------------------------ M4
// The TPU probe's fake ray of lane lid (:175-191), its pair terms
// gq = (dx, dy, dz, 0, 0, 0, 0, 0) and gl = (2a ox - 2p dx, 2a oy - 2p dy,
// 2a oz - 2p dz, 0, 0, 0, 0, -a), p and pc.
struct Ray {
  float gq[8], gl[8];
  float p, pc, inv_a;
};

__device__ __forceinline__ Ray fake_ray(float lid, float x) {
  const float ox = __fadd_rn(__fmul_rn(lid, 1e-3f), x);
  const float oy = __fmul_rn(lid, 2e-3f);
  const float oz = 30.0f;
  const float dx = __fadd_rn(__fmul_rn(lid, 1e-4f), 0.1f);
  const float dy = __fadd_rn(__fmul_rn(lid, -1e-4f), 0.2f);
  const float dz = -1.0f;
  const float a = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  Ray r;
  r.inv_a = 1.0f / a;
  r.p = __fadd_rn(__fadd_rn(__fmul_rn(ox, dx), __fmul_rn(oy, dy)),
                  __fmul_rn(oz, dz));
  const float m2 = __fadd_rn(
      __fadd_rn(__fmul_rn(ox, ox), __fmul_rn(oy, oy)), __fmul_rn(oz, oz));
  r.pc = __fsub_rn(__fmul_rn(r.p, r.p), __fmul_rn(a, m2));
  const float a2 = __fmul_rn(2.0f, a), p2 = __fmul_rn(2.0f, r.p);
  r.gq[0] = dx;
  r.gq[1] = dy;
  r.gq[2] = dz;
  r.gl[0] = __fsub_rn(__fmul_rn(a2, ox), __fmul_rn(p2, dx));
  r.gl[1] = __fsub_rn(__fmul_rn(a2, oy), __fmul_rn(p2, dy));
  r.gl[2] = __fsub_rn(__fmul_rn(a2, oz), __fmul_rn(p2, dz));
#pragma unroll
  for (int k = 3; k < 8; ++k) r.gq[k] = r.gl[k] = 0.0f;
  r.gl[7] = -a;
  return r;
}

// The key of sphere row `row` (its sphT row + s) for ray r.
__device__ __forceinline__ int row_key(const float* __restrict__ sphT,
                                       int row, float s, const Ray& r) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(sphT + 8 * row));
  const float4 hi =
      __ldg(reinterpret_cast<const float4*>(sphT + 8 * row + 4));
  const float l[8] = {__fadd_rn(lo.x, s), __fadd_rn(lo.y, s),
                      __fadd_rn(lo.z, s), __fadd_rn(lo.w, s),
                      __fadd_rn(hi.x, s), __fadd_rn(hi.y, s),
                      __fadd_rn(hi.z, s), __fadd_rn(hi.w, s)};
  float q = __fmul_rn(l[0], r.gq[0]), ll = __fmul_rn(l[0], r.gl[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    q = __fadd_rn(q, __fmul_rn(l[k], r.gq[k]));
    ll = __fadd_rn(ll, __fmul_rn(l[k], r.gl[k]));
  }
  const float disc = __fadd_rn(__fadd_rn(__fmul_rn(q, q), ll), r.pc);
  const bool pos = disc > 0.0f;
  const float sq = sqrtf(pos ? disc : 1.0f);
  const float qp = __fsub_rn(q, r.p);
  const float t0 = __fmul_rn(__fsub_rn(qp, sq), r.inv_a);
  const float t1 = __fmul_rn(__fadd_rn(qp, sq), r.inv_a);
  const float t = t0 > 0.1f ? t0 : t1;
  const float tv = (pos && t > 0.1f) ? t : 1e9f;
  return (__float_as_int(tv) & ~0x7F) | row;
}

// (a) one thread per ray, 128 rows in order
__global__ void __launch_bounds__(256)
visit_thread(const float* __restrict__ salt, const float* __restrict__ sphT,
             const float* __restrict__ sph8, float* __restrict__ out,
             int iters, int n) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int j = g % kT;
  const float x = salt[0];
  const Ray r = fake_ray((float)j, x);
  int krun = 0x7F000000;
  float pay[8];
#pragma unroll
  for (int f = 0; f < 8; ++f) pay[f] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const float s = __fmul_rn(x, (float)i);
    int kmin = 0x7fffffff;
#pragma unroll 4
    for (int row = 0; row < kRows; ++row)
      kmin = min(kmin, row_key(sphT, row, s, r));
    if (kmin < krun) {
      krun = kmin;
      const int w = kmin & 0x7F;
#pragma unroll
      for (int f = 0; f < 8; ++f) pay[f] = __ldg(sph8 + f * kRows + w);
    }
  }
  float* o = out + (size_t)(g / kT) * 8 * kT + j;
#pragma unroll
  for (int f = 0; f < 8; ++f) o[f * kT] = __fadd_rn(pay[f], (float)krun);
}

// (b) a warp per ray: lane l tests rows l + 32e, e < 4; the key's minimum
// through __reduce_min_sync; lane f < 8 reads the winner's field f
__global__ void __launch_bounds__(256)
visit_warp(const float* __restrict__ salt, const float* __restrict__ sphT,
           const float* __restrict__ sph8, float* __restrict__ out, int iters,
           int n) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (g >= n) return;
  const int j = g % kT;
  const float x = salt[0];
  const Ray r = fake_ray((float)j, x);
  int krun = 0x7F000000;
  float pay = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const float s = __fmul_rn(x, (float)i);
    int kmin = 0x7fffffff;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      kmin = min(kmin, row_key(sphT, lane + 32 * e, s, r));
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    if (kmin < krun) {
      krun = kmin;
      if (lane < 8) pay = __ldg(sph8 + lane * kRows + (kmin & 0x7F));
    }
  }
  if (lane < 8)
    out[(size_t)(g / kT) * 8 * kT + lane * kT + j] =
        __fadd_rn(pay, (float)krun);
}

}  // namespace

// One entry point for the four probes.  probe 0 (M1): variant = mode
// (0 mul+add, 1 fma, 2 sqrt, 3 div, 4 1/x), arg = streams, size = n elements;
// probe 1 (M2): variant = route (0 fp32, 1 tf32, 2 3xtf32), arg = kind
// (0 pair, 1 pairT, 2 payload), size = grid; probe 2 (M3): variant = way
// (0 serial, 1 shuffle, 2 __reduce_min_sync), arg = dtype (0 f32, 1 i32),
// size = grid; probe 3 (M4): variant = way (0 thread, 1 warp), size = rays.
extern "C" int rt_microbench_launch(int probe, int variant, int arg,
                                    int iters, int size, const float* salt,
                                    const void* in0, const void* in1,
                                    void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (iters < 0 || size <= 0) return (int)cudaErrorInvalidValue;
  int rc = 0;
  switch (probe) {
    case 0: {
      float* o = static_cast<float*>(out);
      switch (variant) {
        case kMulAdd: rc = launch_fma<kMulAdd>(arg, salt, o, iters, size, st);
          break;
        case kFma: rc = launch_fma<kFma>(arg, salt, o, iters, size, st);
          break;
        case kSqrt: rc = launch_fma<kSqrt>(arg, salt, o, iters, size, st);
          break;
        case kDiv: rc = launch_fma<kDiv>(arg, salt, o, iters, size, st);
          break;
        case kRcp: rc = launch_fma<kRcp>(arg, salt, o, iters, size, st);
          break;
        default: return (int)cudaErrorInvalidValue;
      }
      break;
    }
    case 1: {
      const float* a = static_cast<const float*>(in0);
      const float* b = static_cast<const float*>(in1);
      float* o = static_cast<float*>(out);
      switch (arg) {
        case kPair:
          rc = launch_dot_kind<kPair>(variant, salt, a, b, o, iters, size, st);
          break;
        case kPairT:
          rc = launch_dot_kind<kPairT>(variant, salt, a, b, o, iters, size,
                                       st);
          break;
        case kPayload:
          rc = launch_dot_kind<kPayload>(variant, salt, a, b, o, iters, size,
                                         st);
          break;
        default: return (int)cudaErrorInvalidValue;
      }
      break;
    }
    case 2:
      if (arg == 0)
        rc = launch_reduce<float>(variant, static_cast<const float*>(in0),
                                  static_cast<float*>(out), iters, size, st);
      else if (arg == 1)
        rc = launch_reduce<int>(variant, static_cast<const int*>(in0),
                                static_cast<int*>(out), iters, size, st);
      else
        return (int)cudaErrorInvalidValue;
      break;
    case 3: {
      const float* sphT = static_cast<const float*>(in0);
      const float* sph8 = static_cast<const float*>(in1);
      float* o = static_cast<float*>(out);
      if (size % kT != 0) return (int)cudaErrorInvalidValue;
      if (variant == 0)
        visit_thread<<<(size + 255) / 256, 256, 0, st>>>(salt, sphT, sph8, o,
                                                        iters, size);
      else if (variant == 1)
        visit_warp<<<size / 8, 256, 0, st>>>(salt, sphT, sph8, o, iters,
                                             size);
      else
        return (int)cudaErrorInvalidValue;
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
