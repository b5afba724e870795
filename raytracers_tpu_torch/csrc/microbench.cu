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
//                          order, and on wgmma as TF32 and 3xTF32 (hi/lo
//                          split: hi*lo + lo*hi + hi*hi);
//   M3 reduce_kernel (:134) the minimum of 128 keys per column of a
//                          (128,256) block, v += 1 each iteration, the minima
//                          summed: one thread's serial loop over 128
//                          registers (K1's way, the yardstick); 8 lanes a
//                          column of 16 keys each, a tree of minima in each
//                          lane, then a __shfl_xor_sync butterfly over the
//                          8; or (int32 keys) a warp a column and
//                          __reduce_min_sync; several iterations in flight;
//   M4 visit_kernel (:170) one 128-sphere cluster visit per iteration: the
//                          pair sums q and ll, disc, sqrtf, t0/t1, the window
//                          select, the key (bits(t) & ~0x7F) | row, its
//                          minimum, a strict-less update of krun and the
//                          winner's 8 payload fields read by index (the
//                          one-hot MXU dot of the TPU is an indexed load
//                          here); one thread per ray sweeping 128 rows (K1's
//                          design) or k lanes a ray, 128 / k rows a lane,
//                          the key folded within the group once a visit,
//                          one template (visit_lanes) for both.
//
// Every probe reads its salt and inputs from device memory and writes its
// result, so nvcc cannot fold a loop.  The sources build with -fmad=false;
// M1's contracted variant asks for __fmaf_rn, the others for __fmul_rn and
// __fadd_rn, so one build serves both.  Each variant is bit-equal to its
// plain torch version (probes/microbench.py) but M1's FMA (within its
// iterations' ulps) and M2's TF32 routes (within the rounding of their
// operands and sums, probes/microbench.py dot_tolerance): the arithmetic
// below is written in the order it is evaluated.
//
// What bounds each on this card: M1-M4 are issue-bound by design (a few KB
// of inputs, resident in L1/L2; the outputs are written once).  M1's
// uncontracted loop is 2 lane operations a step, FMA 1 (2 flops), a square
// root or a division 1 as the data sheet counts it, so M1's time over that
// bound is the multiply-equivalents it costs; counted by pipe
// (probes/microbench.py fma_pipes), a root or 1/x is one MUFU at 16 lanes
// a cycle an SM and a division two (its FCHK runs at MUFU's rate), against
// the FP32 pipe's 128.  M2's TF32 routes are bound by the tensor cores' 495
// TFLOP/s; the FP32 loop by the 33.5e12 lane operations a second.  M3 by
// its 127 minima a column and iteration at 64 a cycle an SM ("compare,
// minimum, maximum"): 0.0159 ms at 1980 MHz; k lanes a column issue
// 128 - k + k log2 k minima a column and log2(k) k / 32 shuffles, so a few
// lanes a column keep it on the minima and off the shuffle unit (32 a
// cycle), while 4096 columns x k lanes are enough warps to fill the SMs.
// M4's lanes way at 32 lanes a ray: its two 16-byte loads of a slot-major
// row take 16 L1 wavefronts for 32 tests (probes/microbench.py
// visit_pipes), which bound it above its FP32 operations.
//
// SASS (cuobjdump -sass of the build, CUDA 12.8; probes/microbench.py
// sass_counts, counts of every kernel in docs/MICROBENCH_H100.json; the
// main loops by probes/m1_turns.py loop_sass, docs/M1_TURNS_H100.json):
// M1's FP32 loops are unrolled 64 times and its MUFU loops 8, and hold per
// step
//   mul_add  1 FMUL + 1 FADD (521 FMUL, 537 FADD in the 8-stream kernel:
//            the body, the remainder loop, the set-up and the sum), no
//            FFMA; at one stream 131 instructions a pass, 128 of them FP32;
//   fma      1 FFMA (520 in the 8-stream kernel), no FMUL or FADD in the
//            loop; at 4 and 8 streams FFMA Ra, R4.reuse, Ra, R3.reuse (m
//            and d from the reuse cache); at one stream FFMA R6, R6, UR7,
//            R3 (m in a uniform register that ULDC fills from c[0x3][0x0]),
//            67 instructions a pass, 64 of them FFMA, where the parent's
//            FFMA R4, R0, R4, R3 read three registers, two in one bank;
//   sqrt     1 MUFU.RSQ, 2 FMUL.FTZ, 2 FFMA, an integer range test and a
//            branch to the slow-path call (73 MUFU, 147 FMUL, 147 FFMA,
//            72 CALL);
//   div      1 MUFU.RCP, 5 FFMA, 1 FCHK and a branch (74 MUFU, 372 FFMA,
//            72 FCHK, 72 CALL);
//   1/x      1 MUFU.RCP, 2 FFMA, 1 FADD.FTZ, a range test and a branch
//            (76 MUFU, 151 FFMA, 89 FADD, 72 CALL).
// The MUFU unit issues 16 lanes a cycle an SM against the FP32 pipes' 128,
// so a root or a reciprocal costs about 8 multiply-equivalents before its
// refinement; the record's weights are 8.78 and 8.71, and 16.27 for a
// general division.
//
// M2's schedule.  FP32 pair and pairT (K = 8): a thread per (row, 8
// columns) holds its lhs row and b's 8 x 8 block in registers, 137 FP32
// operations an iteration for the 128.25 the bound counts.  FP32 payload
// (K = 128): a block per (tile, 16 columns), 2 an SM; its 256 threads take
// 128 iterations at a time, a thread an (iteration, 4 rows) x 16 columns:
// 64 independent k-ordered chains r_i, which 128 threads then fold into acc
// in i order from shared memory.  Each product, sum and fold is the plain
// version's, in the same order, so the result is dot_plain's bit for bit.
// TF32 and 3xTF32:
// the product is turned so that b^T is A and lhs_i^T is B: out^T = sum_i
// b^T . lhs_i^T, m64n64k8 wgmma with A in the consumer's registers for the
// whole launch and B in shared memory (A read from shared memory by every
// wgmma, beside the producer's writes, was slower).  A producer warpgroup forms B into a ring of stages, a consumer
// warpgroup issues the wgmma of a stage with no branch between them; named
// barriers pass the stages.  pair: one k8 wgmma an
// iteration into one D across every iteration, 16 iterations a stage;
// payload: 8 iterations side by side (N = 64), each r_i summed from zero
// by 16 wgmma, then acc = acc + r_i in float32 in i order.
//
// SASS of M2 (the same build, docs/MICROBENCH_H100.json): dot_fp32_rows
//   64 FMUL + 73 FADD an iteration (56 sums, 8 acc, 8 lhs + s, 1 s);
// dot_fp32_payload 512 FMUL, 497 FADD (the k loop unrolled 4 times, 64
//   FMUL + 68 FADD a k); dot_tf32_rows 24 HGMMA.64x64x8.F32.TF32 (70 for
//   3xTF32; 16 and 48 in a full stage's straight run); dot_tf32_payload
//   16 (48); no FFMA in any M2 kernel.
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

// M1's schedule: a thread an element, kStreams chains a thread, kFmaBlock
// threads a block.  The step loop's counter, compare and branch take 3
// issue slots a pass: the FP32 steps (FMUL + FADD, FFMA) are unrolled
// kFmaUnroll times, so that a one-chain pass of FFMA holds 64 of its 67
// instructions; the MUFU steps (sqrtf, 1/x, division) kMufuUnroll times,
// since their pipe issues an eighth of FP32's and hides the control, while
// a longer pass only grows the code (unrolled 32 times, sqrtf at 8 chains
// took 1.20 -> 1.55 ms, docs/M1_TURNS_H100.json).  FFMA is the one step
// with three source operands, and the register file's two banks serve
// one read each an issue: where FFMA is alone in its chain (kFmaConstM)
// its m comes from the constant bank (cFmaM; ptxas reads it into a uniform
// register), so that it reads two registers; with several chains a warp's
// consecutive FFMAs are independent and share m and d, which ptxas marks
// .reuse.  m is formed from the salt on the device (fma_operand) and
// copied to the constant bank on the launch's stream before each such
// launch (about 4 us a call, which is why the other chain counts keep m in
// a register); two streams launching it at once with different salts
// would race.
constexpr int kFmaBlock = 256;
constexpr int kFmaUnroll = 64;
constexpr int kMufuUnroll = 8;
template <int kMode, int kStreams>
constexpr bool kFmaConstM = kMode == kFma && kStreams == 1;

__device__ float gFmaM;
__constant__ float cFmaM;

__global__ void fma_operand(const float* __restrict__ salt) {
  gFmaM = __fadd_rn(__fmul_rn(salt[0], 0.5f), 0.9999f);
}

template <int kMode>
__device__ __forceinline__ float step(float a, float m, float d) {
  if constexpr (kMode == kMulAdd) return __fadd_rn(__fmul_rn(a, m), d);
  if constexpr (kMode == kFma) return __fmaf_rn(a, m, d);
  if constexpr (kMode == kSqrt) return sqrtf(a);
  if constexpr (kMode == kRcp) return 1.0f / a;
  return m / a;
}

template <int kMode, int kStreams>
__global__ void __launch_bounds__(kFmaBlock)
fma_probe(const float* __restrict__ salt, float* __restrict__ out, int iters,
          int n) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const float base = salt[0];
  float acc[kStreams];
#pragma unroll
  for (int u = 0; u < kStreams; ++u) acc[u] = __fadd_rn(base, (float)u);
  const float m_reg = __fadd_rn(__fmul_rn(base, 0.5f), 0.9999f);
  const float m = kFmaConstM<kMode, kStreams> ? cFmaM : m_reg;
  const float d = __fadd_rn(base, 1e-7f);
#pragma unroll (kMode == kMulAdd || kMode == kFma ? kFmaUnroll : kMufuUnroll)
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kStreams; ++u) acc[u] = step<kMode>(acc[u], m, d);
  }
  float s = acc[0];
#pragma unroll
  for (int u = 1; u < kStreams; ++u) s = __fadd_rn(s, acc[u]);
  out[g] = s;
}

template <int kMode, int kStreams>
int launch_fma_chains(const float* salt, float* out, int iters, int n,
                      cudaStream_t st) {
  if constexpr (kFmaConstM<kMode, kStreams>) {
    fma_operand<<<1, 1, 0, st>>>(salt);
    void* m = nullptr;
    cudaError_t rc = cudaGetSymbolAddress(&m, gFmaM);
    if (rc == cudaSuccess)
      rc = cudaMemcpyToSymbolAsync(cFmaM, m, sizeof(float), 0,
                                   cudaMemcpyDeviceToDevice, st);
    if (rc != cudaSuccess) return (int)rc;
  }
  fma_probe<kMode, kStreams><<<(n + kFmaBlock - 1) / kFmaBlock, kFmaBlock, 0,
                               st>>>(salt, out, iters, n);
  return 0;
}

template <int kMode>
int launch_fma(int streams, const float* salt, float* out, int iters, int n,
               cudaStream_t st) {
  switch (streams) {
    case 1: return launch_fma_chains<kMode, 1>(salt, out, iters, n, st);
    case 4: return launch_fma_chains<kMode, 4>(salt, out, iters, n, st);
    case 8: return launch_fma_chains<kMode, 8>(salt, out, iters, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
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

// (a) FP32, pair and pairT (K = 8): one thread per row and 8 consecutive
// columns, its lhs row and b's 8 x 8 block in registers for every
// iteration; r = sum_k (lhs[r][k] + s) * b[k][j] in k order, uncontracted,
// then acc = acc + r.
constexpr int kRowCols = 8;

template <int kKind>
__global__ void __launch_bounds__(128)
dot_fp32_rows(const float* __restrict__ salt, const float* __restrict__ a,
              const float* __restrict__ b, float* __restrict__ out, int iters,
              int grid) {
  using S = Dot<kKind>;
  static_assert(S::K == 8, "the rows kernel holds all of K in registers");
  constexpr int kStrips = S::N / kRowCols;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= grid * S::M * kStrips) return;
  const int g = t / (S::M * kStrips);
  const int r = (t / kStrips) % S::M;
  const int j0 = (t % kStrips) * kRowCols;
  float av[8], bv[8][kRowCols];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    av[k] = __ldg(a + S::aidx(r, k));
    const float4 lo =
        __ldg(reinterpret_cast<const float4*>(b + k * S::N + j0));
    const float4 hi =
        __ldg(reinterpret_cast<const float4*>(b + k * S::N + j0 + 4));
    bv[k][0] = lo.x; bv[k][1] = lo.y; bv[k][2] = lo.z; bv[k][3] = lo.w;
    bv[k][4] = hi.x; bv[k][5] = hi.y; bv[k][6] = hi.z; bv[k][7] = hi.w;
  }
  const float x = salt[0];
  float acc[kRowCols];
#pragma unroll
  for (int c = 0; c < kRowCols; ++c) acc[c] = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const float s = __fadd_rn(x, (float)i);
    float rs[kRowCols];
    const float l0 = __fadd_rn(av[0], s);
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) rs[c] = __fmul_rn(l0, bv[0][c]);
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      const float l = __fadd_rn(av[k], s);
#pragma unroll
      for (int c = 0; c < kRowCols; ++c)
        rs[c] = __fadd_rn(rs[c], __fmul_rn(l, bv[k][c]));
    }
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) acc[c] = __fadd_rn(acc[c], rs[c]);
  }
  float* o = out + ((size_t)g * S::M + r) * S::N + j0;
  *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(o + 4) =
      make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// (b) FP32, payload (M = 8, K = 128): a block owns the 8 x 16 outputs of
// one tile and column strip, b's strip (8 KB) and a (4 KB) in shared
// memory.  Its 256 threads take a chunk of kChunk iterations at a time, a
// thread (iteration, 4 rows) x 16 columns: 64 independent k-ordered chains
// r_i of uncontracted products and sums, with l = a + s_i formed once a
// (row, k) per thread.  The chunk's r_i go to shared memory; then 128
// threads, one an output, fold them into acc in i order: acc = acc + r_i
// as the plain version does.  256 blocks at 2 an SM (78 KB each).
constexpr int kPayCols = 16;                  // output columns a block
constexpr int kChunk = 128;                   // iterations a chunk
constexpr int kPayThreads = 2 * kChunk;       // (iteration, half of M)
constexpr int kRPad = 8 * kPayCols + 4;       // floats of one r_i, padded
constexpr int kPaySmem = 4 * (kChunk * kRPad + kRows * kPayCols + kRows * 8);

template <bool kFirst>
__device__ __forceinline__ void pay_step(float (&r)[4][kPayCols],
                                         const float4* a4, const float4* b4,
                                         int k, float s) {
  const float4 av = a4[2 * k];
  const float l[4] = {__fadd_rn(av.x, s), __fadd_rn(av.y, s),
                      __fadd_rn(av.z, s), __fadd_rn(av.w, s)};
  float bv[kPayCols];
#pragma unroll
  for (int c4 = 0; c4 < kPayCols / 4; ++c4) {
    const float4 v = b4[(kPayCols / 4) * k + c4];
    bv[4 * c4] = v.x; bv[4 * c4 + 1] = v.y;
    bv[4 * c4 + 2] = v.z; bv[4 * c4 + 3] = v.w;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int c = 0; c < kPayCols; ++c) {
      const float p = __fmul_rn(l[m], bv[c]);
      r[m][c] = kFirst ? p : __fadd_rn(r[m][c], p);
    }
}

__global__ void __launch_bounds__(kPayThreads, 2)
dot_fp32_payload(const float* __restrict__ salt, const float* __restrict__ a,
                 const float* __restrict__ b, float* __restrict__ out,
                 int iters, int grid) {
  extern __shared__ float4 pay_smem[];
  float* rs = reinterpret_cast<float*>(pay_smem);   // [kChunk][kRPad]
  float* bs = rs + kChunk * kRPad;                  // [k][kPayCols]
  float* as = bs + kRows * kPayCols;                // [k][m] = a[m][k]
  constexpr int kStrips = kT / kPayCols;
  const int g = blockIdx.x / kStrips, n0 = (blockIdx.x % kStrips) * kPayCols;
  const int t = threadIdx.x;
  for (int e = t; e < kRows * kPayCols; e += kPayThreads)
    bs[e] = __ldg(b + (e / kPayCols) * kT + n0 + e % kPayCols);
  for (int e = t; e < kRows * 8; e += kPayThreads)
    as[e] = __ldg(a + (e % 8) * kRows + e / 8);
  __syncthreads();
  const float x = salt[0];
  const int il = t >> 1, mh = t & 1;
  const float4* a4 = reinterpret_cast<const float4*>(as) + mh;
  const float4* b4 = reinterpret_cast<const float4*>(bs);
  const bool sweeps = t < 8 * kPayCols;
  const int sm = t / kPayCols, sn = t % kPayCols;   // the output it folds
  float acc = 0.0f;
  for (int i0 = 0; i0 < iters; i0 += kChunk) {
    const int i = i0 + il;
    float r[4][kPayCols];
    if (i < iters) {
      const float s = __fadd_rn(x, (float)i);
      pay_step<true>(r, a4, b4, 0, s);
#pragma unroll 4
      for (int k = 1; k < kRows; ++k) pay_step<false>(r, a4, b4, k, s);
    }
    __syncthreads();                    // the last chunk's fold is done
    if (i < iters) {
      float4* dst = reinterpret_cast<float4*>(rs + il * kRPad +
                                              mh * 4 * kPayCols);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int c4 = 0; c4 < kPayCols / 4; ++c4)
          dst[m * (kPayCols / 4) + c4] =
              make_float4(r[m][4 * c4], r[m][4 * c4 + 1], r[m][4 * c4 + 2],
                          r[m][4 * c4 + 3]);
    }
    __syncthreads();
    if (sweeps) {
      const int cnt = min(kChunk, iters - i0);
      const float* src = rs + sm * kPayCols + sn;
#pragma unroll 8
      for (int j = 0; j < cnt; ++j) acc = __fadd_rn(acc, src[j * kRPad]);
    }
  }
  if (sweeps) out[((size_t)g * 8 + sm) * kT + n0 + sn] = acc;
}

// (c) TF32 and (d) 3xTF32 on wgmma (sm_90a): one warpgroup forms B in
// shared memory, another holds A in registers and issues m64n64k8 products
// into float32 registers.

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), in two integer operations where cvt takes four
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// st.shared writes become visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// pins a register's value behind the fences and waits before it
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// B's shared-memory layout (PTX ISA, "Matrix Descriptor"), K-major, no
// swizzle: core matrices of 8 rows x 4 k (16 bytes a row); kLbo bytes to
// the next 4 k, kSbo to the next 8 rows; one k8 slice of R rows is R * 32
// bytes.
constexpr uint32_t kLbo = 128, kSbo = 256;

__device__ __forceinline__ int kmajor_word(int row, int k) {
  return (row >> 3) * 64 + (k >> 2) * 32 + (row & 7) * 4 + (k & 3);
}

__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32);
}

// D (64 x 64) = A (64 x 8) . B (8 x 64) + (scale_d ? D : 0), A from
// registers, B from shared memory.  With w the warp of the warpgroup, q =
// lane / 4 and p = lane % 4, a[e] holds A's (16w + q + 8 (e & 1), p + 4 (e
// >> 1)) and D[4j + 2h + c] is (16w + q + 8h, 8j + 2p + c) (PTX ISA, wgmma
// .m64nNk8 .tf32 register fragments).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

constexpr int kTcN = 64;        // a warpgroup's tile: m64n64
constexpr int kRing = 3;        // B's stages in shared memory

// named barriers between the consumer warpgroup (0) and the producer (1):
// stage s is formed (kFull + s), stage s is read (kEmpty + s)
constexpr int kFull = 1, kEmpty = kFull + kRing, kBoth = 256;
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kBoth) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kBoth) : "memory");
}
// the thread's warpgroup, uniform across the warp as ptxas can see (a
// branch on threadIdx.x alone makes it serialize the wgmma behind it)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// A = b^T's 64 x 8 slice k0..k0+7, rows c0 and c0 + 8 of A (columns of
// b), as TF32 hi and lo (3xTF32): the thread's register fragment
template <bool kSplit>
__device__ __forceinline__ void bt_fragment(const float* __restrict__ b,
                                            int k0, int c0, int p,
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v =
        __ldg(b + (k0 + p + 4 * (e >> 1)) * kT + c0 + 8 * (e & 1));
    hi[e] = to_tf32(v);
    if constexpr (kSplit)
      lo[e] = to_tf32(__fsub_rn(v, __uint_as_float(hi[e])));
  }
}

// 4 consecutive k of one row of B: lhs + s in TF32 (hi, and lo for
// 3xTF32), stored at word w of a stage's hi and lo parts
template <bool kSplit>
__device__ __forceinline__ void form4(float4 base, float s, uint32_t* hi,
                                      uint32_t* lo, int w) {
  const float v[4] = {__fadd_rn(base.x, s), __fadd_rn(base.y, s),
                      __fadd_rn(base.z, s), __fadd_rn(base.w, s)};
  uint32_t h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = to_tf32(v[e]);
  *reinterpret_cast<uint4*>(hi + w) = make_uint4(h[0], h[1], h[2], h[3]);
  if constexpr (kSplit) {
    uint32_t l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      l[e] = to_tf32(__fsub_rn(v[e], __uint_as_float(h[e])));
    *reinterpret_cast<uint4*>(lo + w) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// One k8 step from A's registers and the descriptors of B's hi and lo
// parts: D += b^T . lhs^T (TF32), or for 3xTF32 b_hi . lhs_lo + b_lo .
// lhs_hi + b_hi . lhs_hi; scale_d 0 starts D from zero.  Callers issue a
// run of steps with no branch between them: ptxas gives a wgmma behind a
// branch a fence and a scoreboard wait of its own.
template <bool kSplit>
__device__ __forceinline__ void tf32_step(float (&d)[32],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint64_t bh, uint64_t bl,
                                          int scale_d) {
  if constexpr (kSplit) {
    wgmma_tf32(d, ah, bl, scale_d);
    wgmma_tf32(d, al, bh, 1);
    wgmma_tf32(d, ah, bh, 1);
  } else {
    wgmma_tf32(d, ah, bh, scale_d);
  }
}

// pair and pairT: out^T (256 x 128) = sum_i b^T (256 x 8) . lhs_i^T (8 x
// 128).  A block owns a 64 x 64 tile of one grid tile (128 blocks) and
// runs two warpgroups.  The producer forms lhs_i^T's 8 x 64 slice, kGroup
// iterations a stage, into a ring of kRing stages in shared memory (TF32
// hi, and lo for 3xTF32).  The consumer holds b^T's 64 x 8 slice as A in
// registers and issues one k8 wgmma an iteration (three for 3xTF32: hi.lo,
// lo.hi, hi.hi), every one into the same D; a stage is given back once the
// wgmma that read it have been waited for.
constexpr int kGroup = 16;
template <bool kSplit>
constexpr int tf32_rows_smem() {            // the ring of B's stages
  return kRing * kGroup * (kSplit ? 2 : 1) * kTcN * 8 * 4;
}

template <int kKind, bool kSplit>
__global__ void __launch_bounds__(256)
dot_tf32_rows(const float* __restrict__ salt, const float* __restrict__ a,
              const float* __restrict__ b, float* __restrict__ out, int iters,
              int grid) {
  using S = Dot<kKind>;
  static_assert(S::M % kTcN == 0 && S::N % 64 == 0 && S::K == 8, "");
  constexpr int kParts = kSplit ? 2 : 1, kStage = kTcN * 8;
  constexpr int kNT = S::N / 64, kRT = S::M / kTcN, kG = kGroup;
  extern __shared__ __align__(128) uint32_t smem[];
  // B's stage of iteration u of group stage st, part h
  auto lt = [&](int st, int u, int h) {
    return smem + ((st * kG + u) * kParts + h) * kStage;
  };
  const int nt = blockIdx.x % kNT, rt = (blockIdx.x / kNT) % kRT;
  const int g = blockIdx.x / (kNT * kRT);
  const int t = threadIdx.x & 127;
  const int groups = (iters + kG - 1) / kG;
  const float x = salt[0];
  if (warpgroup() == 1) {
    // producer: lhs row rt * 64 + (t & 63), k = 4 kc + 0..3
    const int rl = t & 63, kc = t >> 6, row = rt * kTcN + rl;
    const float4 base = make_float4(__ldg(a + S::aidx(row, 4 * kc)),
                                    __ldg(a + S::aidx(row, 4 * kc + 1)),
                                    __ldg(a + S::aidx(row, 4 * kc + 2)),
                                    __ldg(a + S::aidx(row, 4 * kc + 3)));
    const int w = kmajor_word(rl, 4 * kc);
    for (int j = 0; j < groups; ++j) {
      const int st = j % kRing, n = min(kG, iters - j * kG);
      if (j >= kRing) bar_sync(kEmpty + st);
#pragma unroll
      for (int u = 0; u < kG; ++u)
        if (u < n)
          form4<kSplit>(base, __fadd_rn(x, (float)(j * kG + u)),
                        lt(st, u, 0), lt(st, u, kParts - 1), w);
      fence_proxy_async();
      bar_arrive(kFull + st);
    }
    return;
  }
  const int lane = t & 31, q = lane >> 2, p = lane & 3;
  const int c0 = nt * 64 + (t >> 5) * 16 + q;
  uint32_t ah[4], al[4];
  bt_fragment<kSplit>(b, 0, c0, p, ah, al);
  float d[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) d[e] = 0.0f;
  for (int j = 0; j < groups; ++j) {
    const int st = j % kRing, n = min(kG, iters - j * kG);
    bar_sync(kFull + st);
    if (n == kG) {            // no branch between the wgmma of a full group
      uint64_t bh[kG], bl[kG];
#pragma unroll
      for (int u = 0; u < kG; ++u) {
        bh[u] = kmajor_desc(lt(st, u, 0));
        bl[u] = kmajor_desc(lt(st, u, kParts - 1));
      }
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < kG; ++u)
        tf32_step<kSplit>(d, ah, al, bh[u], bl[u], 1);
    } else {
      wgmma_fence();
      for (int u = 0; u < n; ++u)
        tf32_step<kSplit>(d, ah, al, kmajor_desc(lt(st, u, 0)),
                          kmajor_desc(lt(st, u, kParts - 1)), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();                  // group j - 1 is done: its stage too
    if (j >= 1) bar_arrive(kEmpty + (j - 1) % kRing);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < 32; ++e) reg_fence(d[e]);
  // D[4j + 2h + c] is (column c0 + 8h, lhs row rt * 64 + 8j + 2p + c)
  float* o = out + (size_t)g * S::M * S::N;
#pragma unroll
  for (int j = 0; j < kTcN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        o[(rt * kTcN + 8 * j + 2 * p + c) * S::N + c0 + 8 * h] =
            d[4 * j + 2 * h + c];
}

// payload: out^T (256 x 8) = sum_i b^T (256 x 128) . lhs_i^T (128 x 8).  A
// block owns 64 output columns of one grid tile (64 blocks) and runs two
// warpgroups.  The producer forms kBatch iterations' lhs_i^T side by side
// as one stage of B (N = 8 kBatch = 64, 16 k8 slices), into a ring of
// kRing stages; its a values stay in registers.  The consumer holds b^T's
// 64 x 128 slice as A in registers (TF32 hi, and lo for 3xTF32) and runs a
// batch's 16 k8 wgmma (48 for 3xTF32) into its accumulator from zero, so
// each r_i is summed by the tensor cores alone; then it adds the
// accumulator's column blocks to acc in float32, in i order: acc = acc +
// r_i.
constexpr int kBatch = kTcN / 8;
constexpr int kLWords = (kRows / 8) * kTcN * 8;   // a stage's part (32 KB)

template <bool kSplit>
constexpr int tf32_payload_smem() {        // the ring of B's stages
  return kRing * (kSplit ? 2 : 1) * kLWords * 4;
}

template <bool kSplit>
__global__ void __launch_bounds__(256, 1)
dot_tf32_payload(const float* __restrict__ salt, const float* __restrict__ a,
                 const float* __restrict__ b, float* __restrict__ out,
                 int iters, int grid) {
  constexpr int kParts = kSplit ? 2 : 1, kKS = kRows / 8, kNT = kT / kTcN;
  constexpr uint64_t kSlice = kTcN * 8 * 4 / 16;   // a k8 slice, 16 B units
  extern __shared__ __align__(128) uint32_t lt[];  // [stage][part][ks][64x8]
  const int g = blockIdx.x / kNT, n0 = (blockIdx.x % kNT) * kTcN;
  const int t = threadIdx.x & 127;
  const int batches = (iters + kBatch - 1) / kBatch;
  const float x = salt[0];
  if (warpgroup() == 1) {
    // producer: B's row 8 jg + jr (iteration jg of the batch, lhs row jr),
    // k = 8 ks + 4 kc + 0..3 for every ks
    const int jg = t >> 4, kc = (t >> 3) & 1, jr = t & 7;
    const int w = kmajor_word(8 * jg + jr, 4 * kc);
    float4 av[kKS];                    // the same for every batch
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
      av[ks] = __ldg(reinterpret_cast<const float4*>(a + jr * kRows + 8 * ks +
                                                     4 * kc));
    for (int bt = 0; bt < batches; ++bt) {
      const int st = bt % kRing;
      uint32_t* hi = lt + st * kParts * kLWords;
      if (bt >= kRing) bar_sync(kEmpty + st);
      const float s = __fadd_rn(x, (float)(bt * kBatch + jg));
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        form4<kSplit>(av[ks], s, hi + ks * kTcN * 8,
                      hi + (kParts - 1) * kLWords + ks * kTcN * 8, w);
      fence_proxy_async();
      bar_arrive(kFull + st);
    }
    return;
  }
  const int lane = t & 31, q = lane >> 2, p = lane & 3;
  const int c0 = n0 + (t >> 5) * 16 + q;    // A's rows c0 and c0 + 8: columns
  uint32_t ah[kKS][4], al[kKS][4];            // b^T's fragments, hi and lo
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks)
    bt_fragment<kSplit>(b, 8 * ks, c0, p, ah[ks], al[ks]);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float d[32];
  for (int bt = 0; bt < batches; ++bt) {
    const int st = bt % kRing;
    const uint32_t* hi = lt + st * kParts * kLWords;
    const uint64_t bh = kmajor_desc(hi);
    const uint64_t bl = kmajor_desc(hi + (kParts - 1) * kLWords);
    bar_sync(kFull + st);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
      tf32_step<kSplit>(d, ah[ks], al[ks], bh + ks * kSlice,
                        bl + ks * kSlice, ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    bar_arrive(kEmpty + st);          // the stage is read: give it back
#pragma unroll
    for (int e = 0; e < 32; ++e) reg_fence(d[e]);
    const int cnt = min(kBatch, iters - bt * kBatch);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j < cnt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], d[4 * j + e]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    out[((size_t)g * 8 + 2 * p + (e & 1)) * kT + c0 + 8 * (e >> 1)] = acc[e];
}

template <typename... P, typename... A>
int launch_with_smem(void (*kernel)(P...), int blocks, int threads, int smem,
                     cudaStream_t st, A... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, threads, smem, st>>>(args...);
  return 0;
}

template <int kKind>
int launch_dot_kind(int route, const float* salt, const float* a,
                    const float* b, float* out, int iters, int grid,
                    cudaStream_t st) {
  using S = Dot<kKind>;
  if (route < 0 || route > 2) return (int)cudaErrorInvalidValue;
  if constexpr (kKind == kPayload) {
    if (route == 0)
      return launch_with_smem(dot_fp32_payload, grid * (kT / kPayCols),
                              kPayThreads, kPaySmem, st, salt, a, b, out,
                              iters, grid);
    const int blocks = grid * (kT / kTcN);
    if (route == 1)
      return launch_with_smem(dot_tf32_payload<false>, blocks, 256,
                              tf32_payload_smem<false>(), st, salt, a, b,
                              out, iters, grid);
    return launch_with_smem(dot_tf32_payload<true>, blocks, 256,
                            tf32_payload_smem<true>(), st, salt, a, b, out,
                            iters, grid);
  } else {
    if (route == 0) {
      const int threads = grid * S::M * (S::N / kRowCols);
      dot_fp32_rows<kKind><<<(threads + 127) / 128, 128, 0, st>>>(
          salt, a, b, out, iters, grid);
      return 0;
    }
    const int blocks = grid * (S::M / kTcN) * (S::N / 64);
    if (route == 1)
      return launch_with_smem(dot_tf32_rows<kKind, false>, blocks, 256,
                              tf32_rows_smem<false>(), st, salt, a, b, out,
                              iters, grid);
    return launch_with_smem(dot_tf32_rows<kKind, true>, blocks, 256,
                            tf32_rows_smem<true>(), st, salt, a, b, out,
                            iters, grid);
  }
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

// (b) k lanes a column: lane `sub` of the column's group holds rows
// sub + k*e, e < 128/k, in registers.  An iteration takes each lane's
// minimum as a tree of independent minima, then log2 k rounds of
// __shfl_xor_sync within the group (shuffle), or one __reduce_min_sync over
// the warp (redux, int32 keys, k = 32).  The minima of kFlight iterations
// are in flight together: their trees and increments come first, then
// their rounds side by side, then acc adds them in iteration order.  Every
// iteration's minima stay in the loop.
//
// k of the shuffle way: the card's sweep of k in {2, 4, 8, 16, 32}
// (probes/m3m6_turns.py, docs/M3M6_TURNS_H100.json) puts k = 4 and 8 level
// for float keys and k = 8 first for int32 keys; k = 2 leaves two of an
// SM's four schedulers without a warp, k >= 16 issues more minima and
// shuffles.  REDUX with one mask a group of k < 32 lanes runs once a
// distinct mask, so the redux way keeps a warp a column.
constexpr int kShuffleLanes = 8;
constexpr int kReduxLanes = 32;

__device__ __forceinline__ float kmin(float x, float y) { return fminf(x, y); }
__device__ __forceinline__ int kmin(int x, int y) { return min(x, y); }

// The levels of the tree and the rounds of the butterfly are template
// recursions, so every index is a constant and the keys stay in registers
// (a loop over halving strides is not unrolled by nvcc, and its array goes
// to local memory).
template <int kH, typename V, int kN>
__device__ __forceinline__ void tree_level(V (&w)[kN]) {
  if constexpr (kH >= 1) {
#pragma unroll
    for (int e = 0; e < kH; ++e) w[e] = kmin(w[e], w[e + kH]);
    tree_level<kH / 2>(w);
  }
}

// the minimum of the keys v, which then step to v + 1: the tree's first
// level reads each key once and the key's increment follows that read, so a
// lane's minima (64 lanes a cycle an SM) and adds (128) interleave
template <typename V, int kN>
__device__ __forceinline__ V min_then_step(V (&v)[kN]) {
  static_assert(kN >= 2, "two keys a lane at least");
  V w[kN / 2];
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) {
    w[e] = kmin(v[e], v[e + kN / 2]);
    v[e] = plus_one(v[e]);
    v[e + kN / 2] = plus_one(v[e + kN / 2]);
  }
  tree_level<kN / 4>(w);
  return w[0];
}

template <int kO, typename V, int kU>
__device__ __forceinline__ void butterfly(V (&m)[kU]) {
  if constexpr (kO >= 1) {
#pragma unroll
    for (int u = 0; u < kU; ++u)
      m[u] = kmin(m[u], __shfl_xor_sync(0xffffffffu, m[u], kO));
    butterfly<kO / 2>(m);
  }
}

constexpr int kFlight = 4;   // iterations whose minima are in flight at once

template <typename V, int kLanes, bool kRedux, int kU>
__device__ __forceinline__ void iterate(V (&v)[kRows / kLanes], V& acc) {
  V m[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) m[u] = min_then_step(v);
  if constexpr (kRedux) {
    static_assert(kLanes == 32 && std::is_same_v<V, int>,
                  "__reduce_min_sync: a warp of int32 keys");
#pragma unroll
    for (int u = 0; u < kU; ++u) m[u] = __reduce_min_sync(0xffffffffu, m[u]);
  } else {
    butterfly<kLanes / 2>(m);
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) acc = add(acc, m[u]);
}

template <typename V, int kLanes, bool kRedux>
__global__ void __launch_bounds__(64)
reduce_lanes(const V* __restrict__ v0, V* __restrict__ out, int iters,
             int grid) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int col = t / kLanes, sub = t % kLanes;
  if (col >= grid * kT) return;      // whole warps: 64 | grid * kT * kLanes
  const int j = col % kT;
  V v[kRows / kLanes];
#pragma unroll
  for (int e = 0; e < kRows / kLanes; ++e)
    v[e] = v0[(sub + kLanes * e) * kT + j];
  V acc = V(0);
  int i = 0;
  for (; i + kFlight <= iters; i += kFlight)
    iterate<V, kLanes, kRedux, kFlight>(v, acc);
  for (; i < iters; ++i) iterate<V, kLanes, kRedux, 1>(v, acc);
  if (sub == 0) out[col] = acc;
}

template <typename V>
int launch_reduce(int way, const V* v0, V* out, int iters, int grid,
                  cudaStream_t st) {
  if (way == 0) {
    reduce_serial<V><<<(grid * kT + 127) / 128, 128, 0, st>>>(v0, out, iters,
                                                             grid);
  } else if (way == 1) {
    reduce_lanes<V, kShuffleLanes, false>
        <<<grid * kT * kShuffleLanes / 64, 64, 0, st>>>(v0, out, iters, grid);
  } else if (way == 2) {
    if constexpr (std::is_same_v<V, int>)
      reduce_lanes<V, kReduxLanes, true>
          <<<grid * kT * kReduxLanes / 64, 64, 0, st>>>(v0, out, iters, grid);
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

// k of the lanes way: the card's sweep of k in {4, 8, 16, 32} at the TPU
// probe's 4,096 rays (probes/m4m5_turns.py, docs/M4M5_TURNS_H100.json),
// where 4,096 x k lanes are 1-31 warps an SM and fewer than 32 lanes a ray
// leave the card too few warps to hide a row test's latency; at 1M rays
// k = 4 is 16% faster.  probes/microbench.py VISIT_LANES holds the same.
constexpr int kVisitLanes = 32;
// Row `row` of K1's slot-major (128, 8) table t plus s: its two 16-byte
// halves through __ldg and the 8 adds here; or (kShifted) the block's
// shifted copy in shared memory, read as it is.
template <bool kShifted>
__device__ __forceinline__ void table_row(const float* __restrict__ t,
                                          int row, float s, float (&l)[8]) {
  float v[8];
  const float4* p = reinterpret_cast<const float4*>(t + 8 * row);
  float4 lo, hi;
  if constexpr (kShifted) {
    lo = p[0];
    hi = p[1];
  } else {
    lo = __ldg(p);
    hi = __ldg(p + 1);
  }
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
#pragma unroll
  for (int f = 0; f < 8; ++f) l[f] = kShifted ? v[f] : __fadd_rn(v[f], s);
}

// The key of sphere row `row` (its table row + s) for ray r.
template <bool kShifted>
__device__ __forceinline__ int row_key(const float* __restrict__ tbl,
                                       int row, float s, const Ray& r) {
  float l[8];
  table_row<kShifted>(tbl, row, s, l);
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

// k lanes a ray (a thread a ray at k = 1, K1's phase-0 design): lane i of
// a ray's group tests rows i + k*e, e < 128 / k; the group folds its keys
// once a visit (M3's butterfly within the group, or at k = 32 one
// __reduce_min_sync), every lane makes the same strict-less update of
// krun, and on an improvement lane i reads the winner's fields i + k*m
// (one each at k >= 8, all 8 at k = 1).  row_key's two 16-byte loads of a
// slot-major row fall in an even and an odd bank group of L1, so a warp's
// k distinct rows a load take 2 ceil(k / 4) wavefronts for 32 tests (16 at
// the parent's warp a ray, k = 32; probes/microbench.py visit_load_model).
// The lanes way's 256 threads form (table + s) in shared memory once a
// visit, a float4 each, double-buffered, so that one barrier a visit
// orders the writes after the last visit's reads: the TPU kernel forms
// lhsT once a visit for the tile (tools/microbench_tpu.py:196), and 8 adds
// a lane and row in its place took 0.358 ms against 0.327 at 4,096 rays
// (the sweep, docs/M4M5_TURNS_H100.json).  The grid is exact (n is a
// multiple of 256), so every warp and block runs whole.
template <int kLanes>
__global__ void __launch_bounds__(256)
visit_lanes(const float* __restrict__ salt, const float* __restrict__ sphT,
            const float* __restrict__ sph8, float* __restrict__ out,
            int iters) {
  static_assert(32 % kLanes == 0, "k divides a warp");
  constexpr int kE = kRows / kLanes;                  // rows a lane
  constexpr int kF = kLanes < 8 ? 8 / kLanes : 1;     // fields a lane
  constexpr bool kStage = kLanes > 1;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t / kLanes, i = t % kLanes;
  const int j = g % kT;
  const float x = salt[0];
  const Ray r = fake_ray((float)j, x);
  int krun = 0x7F000000;
  float pay[kF];
#pragma unroll
  for (int m = 0; m < kF; ++m) pay[m] = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const float s = __fmul_rn(x, (float)it);
    const float* tbl = sphT;
    if constexpr (kStage) {
      __shared__ float4 shifted[2][2 * kRows];
      float4 v = __ldg(reinterpret_cast<const float4*>(sphT) + threadIdx.x);
      v.x = __fadd_rn(v.x, s);
      v.y = __fadd_rn(v.y, s);
      v.z = __fadd_rn(v.z, s);
      v.w = __fadd_rn(v.w, s);
      shifted[it & 1][threadIdx.x] = v;
      __syncthreads();
      tbl = reinterpret_cast<const float*>(shifted[it & 1]);
    }
    int best[1] = {0x7fffffff};
#pragma unroll (kE <= 16 ? kE : 4)
    for (int e = 0; e < kE; ++e)
      best[0] = min(best[0], row_key<kStage>(tbl, i + kLanes * e, s, r));
    if constexpr (kLanes == 32)
      best[0] = __reduce_min_sync(0xffffffffu, best[0]);
    else
      butterfly<kLanes / 2>(best);
    if (best[0] < krun) {
      krun = best[0];
      if (i < 8) {
        const int w = krun & 0x7F;
#pragma unroll
        for (int m = 0; m < kF; ++m)
          pay[m] = __ldg(sph8 + (i + kLanes * m) * kRows + w);
      }
    }
  }
  if (i < 8) {
    float* o = out + (size_t)(g / kT) * 8 * kT + j;
#pragma unroll
    for (int m = 0; m < kF; ++m)
      o[(i + kLanes * m) * kT] = __fadd_rn(pay[m], (float)krun);
  }
}

}  // namespace

// One entry point for the four probes.  probe 0 (M1): variant = mode
// (0 mul+add, 1 fma, 2 sqrt, 3 div, 4 1/x), arg = streams, size = n elements;
// probe 1 (M2): variant = route (0 fp32, 1 tf32, 2 3xtf32), arg = kind
// (0 pair, 1 pairT, 2 payload), size = grid; probe 2 (M3): variant = way
// (0 serial, 1 shuffle, 2 __reduce_min_sync), arg = dtype (0 f32, 1 i32),
// size = grid; probe 3
// (M4): variant = lanes a ray (1 the thread way, the build's kVisitLanes
// the lanes way; any other is refused), size = rays, in0 = sphT.
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
      if (variant == 1)
        visit_lanes<1><<<size / 256, 256, 0, st>>>(salt, sphT, sph8, o,
                                                   iters);
      else if (variant == kVisitLanes)
        visit_lanes<kVisitLanes><<<size / 256 * kVisitLanes, 256, 0, st>>>(
            salt, sphT, sph8, o, iters);
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
