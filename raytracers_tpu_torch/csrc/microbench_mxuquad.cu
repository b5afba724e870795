// M7, the probe of tools/microbench_mxuquad.py, for Hopper (sm_90a).
//
//   M7 visit_kernel (:44)  M5's mxu visit (csrc/microbench_v5.cu) with b and
//                          c of the quadratic from either
//                            vpu      the FP32 chain, oc = o - s, b = oc.d,
//                                     c = |oc|^2 - r2; one thread per ray,
//                                     bit-equal to its plain version; or
//                            mxuquad  one product a visit, G (2 rows splits,
//                                     16) @ F (16, rays), bf16 operands and
//                                     float32 accumulation, summed over the
//                                     splits in float32, b + salt*c*1e-20
//                                     at visit c.  F = [d o o.d |o|^2 1
//                                     0..] of each ray, rounded to bf16 once
//                                     before the loop; G rounded to bf16 once
//                                     a block, into shared memory.
//
// mxuquad runs on the tensor cores through wgmma.mma_async m64nNk16 .bf16
// -> .f32 (visit_mma).  A warpgroup takes a tile of 64 rays, the M of the
// product; the depth of 16 is the 16 features.  A = F^T (64 rays x 16) sits
// in the warpgroup's registers, 4 a thread, formed before the loop and never
// written again (a write to A between two wgmma makes ptxas serialize them).
// B = G^T (16 x 2 rows, a split after another) is staged once a block into
// shared memory, K-major without swizzle, its columns interleaved: column
// 2k is sphere row k's b row, 2k + 1 its c row.  The f32 accumulator gives
// thread (w = warp, q = lane / 4, p = lane % 4) the column pairs (8j + 2p,
// 8j + 2p + 1) of rays 16w + q and 16w + q + 8 (PTX ISA, wgmma .m64nNk16
// register fragments), so one thread holds b and c of one (ray, sphere row
// 4j + p) pair and finishes the quadratic and the key there.
//
// A visit issues the product in chunks of kN columns (64 for splits 1, 32
// sphere rows; 32 for splits 3, three accumulators): each chunk's wgmma,
// one a split from zero, go out as one group (fence, wgmma, commit, wait 0),
// then the splits are added in float32 in split order, as the TPU probe
// sums its split blocks, and each (ray, row) key joins the thread's running
// minimum.  The product is issued every visit, as the TPU probe computes
// its dot inside the loop.
//
// The key carries its row (keys are unique) and the payload is sph8's
// column of the winning row, so the visits of a ray may be taken in any
// grouping: a block holds `parts` warpgroups (1, 2 or 4) on one tile, each
// taking a contiguous share of the visits with its own running minimum; the
// minimum over rows and visits is folded over the four lanes of a ray (xor
// 1, 2) and over the parts in shared memory, and warpgroup 0 writes pay +
// (float)krun, pay = sph8[:, krun & (rows - 1)], or 0 where no key beat the
// miss key.  The result is bit-equal to the visit in order.  The partition
// (mxuquad_parts): the fewest parts that give kFillWarpgroups warpgroups
// (four a SM), at most 4: 4 at 8,192 rays (128 tiles), 1 from 33,792 rays
// on.  Several warpgroups a SM hide each other's wgmma latency with their
// FP32 tails.  Measured so (docs/M7_TURNS_H100.json, H100 80GB HBM3 at
// 700 W): at 8,192 rays 4 parts beat 2 and 1 (rows 128 splits 1: 0.342,
// 0.529, 0.909 ms); at 1,048,576 rays 1 part is as fast or faster (splits
// 3: 49.9, 52.5, 53.2 ms for 1, 2, 4).
//
// The tensor cores' sums are not IEEE (products exact, the sum truncated),
// so mxuquad is held within a bound of the float64 product of the bf16
// operands (probes/microbench_mxuquad.py product_tolerance), read through
// `tap`: tile 0's summed product at visit 0, (2 rows, 512).  The visit
// after the product is bit-equal to the plain visit given that product.
//
// What bounds it on this card: vpu as M5 (issue-bound, 32 lane operations
// and a root a (ray, row) test); mxuquad does 2 x 2 rows x splits x 16
// bf16 flops a ray and visit, far under the tensor cores' 989 TFLOP/s, and
// 19 + 2 (splits - 1) FP32 lane operations and a root a (ray, row) test:
// issue-bound by its FP32 tail, with G out of the visit loop (no load, no
// conversion) and one B tile serving 64 rays: 64-77% of that bound at
// 1,048,576 rays, 57-64% at 8,192 (the same record).
//
// Layouts: salt (1,) f32.  tbl: sphT (rows, 8) [cx cy cz . . . . r^2] for
// vpu, G (2 rows splits, 16) f32 for mxuquad (b rows, then c rows, a split
// after another).  sph8 (8, rows).  out (n/512, 8, 512) = pay + (float)krun.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_visit.cuh"

namespace {

using probe_visit::fake_ray;
using probe_visit::kMissKey;
using probe_visit::kT;
using probe_visit::quad_key;
using probe_visit::Ray;
using probe_visit::row_bc;

constexpr int kF = 16;   // features

// vpu: one thread per ray, M5's mxu visit without cidx
template <int kRows>
__global__ void __launch_bounds__(256)
visit_vpu(const float* __restrict__ salt, const float* __restrict__ sphT,
          const float* __restrict__ sph8, float* __restrict__ out, int iters,
          int n) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int j = g % kT;
  const float x = salt[0];
  const Ray r = fake_ray((float)j, x);
  int krun = kMissKey;
  float pay[8];
#pragma unroll
  for (int f = 0; f < 8; ++f) pay[f] = 0.0f;
  for (int c = 0; c < iters; ++c) {
    const float s = __fmul_rn(x, (float)c);
    int kmin = 0x7fffffff;
#pragma unroll 4
    for (int row = 0; row < kRows; ++row) {
      float b, cq;
      row_bc(sphT, row, s, r, b, cq);
      kmin = min(kmin, quad_key(b, cq, r, ~(kRows - 1), row));
    }
    if (kmin < krun) {
      const int w = kmin & (kRows - 1);
#pragma unroll
      for (int f = 0; f < 8; ++f) pay[f] = __ldg(sph8 + f * kRows + w);
      krun = kmin;
    }
  }
  float* o = out + (size_t)(g / kT) * 8 * kT + j;
#pragma unroll
  for (int f = 0; f < 8; ++f) o[f * kT] = __fadd_rn(pay[f], (float)krun);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The features of ray r: [dx dy dz ox oy oz o.d |o|^2 1 0 ...]
__device__ __forceinline__ float feature(const Ray& r, int k) {
  switch (k) {
    case 0: return r.dx;
    case 1: return r.dy;
    case 2: return r.dz;
    case 3: return r.ox;
    case 4: return r.oy;
    case 5: return r.oz;
    case 6:
      return __fadd_rn(__fadd_rn(__fmul_rn(r.ox, r.dx), __fmul_rn(r.oy, r.dy)),
                       __fmul_rn(r.oz, r.dz));
    case 7:
      return __fadd_rn(__fadd_rn(__fmul_rn(r.ox, r.ox), __fmul_rn(r.oy, r.oy)),
                       __fmul_rn(r.oz, r.oz));
    case 8: return 1.0f;
    default: return 0.0f;
  }
}

constexpr int kTile = 64;             // rays of a warpgroup: wgmma's M
constexpr int kMaxParts = 4;          // warpgroups of a block, on one tile
constexpr int kFillWarpgroups = 528;  // 132 SMs x 4 warpgroups

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// st.shared writes become visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// pins a register's value behind the wait
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// B's shared-memory layout (PTX ISA, "Matrix Descriptor"), K-major, no
// swizzle: core matrices of 8 columns x 8 k (16 bytes a column); kLbo bytes
// to the next 8 k, kSbo to the next 8 columns.  A split's 2 rows columns
// take rows * 64 bytes.
constexpr uint32_t kLbo = 128, kSbo = 256;

__device__ __forceinline__ int kmajor_word(int col, int k) {   // k even
  return (col >> 3) * 64 + (k >> 3) * 32 + (col & 7) * 4 + ((k & 7) >> 1);
}

__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32);
}

// D (64 x kN) = A (64 x 16) . B (16 x kN), bf16, float32 from zero; A from
// registers (a[e]: row 16w + q + 8 (e & 1), k 2p + 8 (e >> 1) and + 1),
// B from shared memory; D[4j + 2h + c] is (16w + q + 8h, 8j + 2p + c).
template <int kN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[kN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  if constexpr (kN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
  } else {
    static_assert(kN == 32, "chunks of 64 or 32 columns");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
  }
}

// the thread's warpgroup, uniform across the warp as ptxas can see
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// mxuquad: a block per tile of 64 rays, `parts` warpgroups on its visits
template <int kRows, int kSplits>
__global__ void __launch_bounds__(128 * kMaxParts, 1)
visit_mma(const float* __restrict__ salt, const float* __restrict__ G,
          const float* __restrict__ sph8, float* __restrict__ out,
          float* __restrict__ tap, int iters, int parts) {
  constexpr int kN = kSplits == 1 ? 64 : 32;      // a chunk's columns
  constexpr int kChunks = 2 * kRows / kN;
  constexpr int kSplitWords = kRows * kF;          // 2 rows columns of bf16
  __shared__ __align__(128) uint32_t gt[kSplits * kSplitWords];
  __shared__ int part_key[kMaxParts][kTile];
  // G^T into shared memory, bf16, column 2 row + s (s = 0 b, 1 c)
  for (int i = threadIdx.x; i < kSplits * 2 * kRows * (kF / 2);
       i += blockDim.x) {
    const int gr = i / (kF / 2), k = 2 * (i % (kF / 2));
    const int sp = gr / (2 * kRows), s = (gr / kRows) & 1, row = gr % kRows;
    const float2 v = __ldg(reinterpret_cast<const float2*>(G + gr * kF + k));
    gt[sp * kSplitWords + kmajor_word(2 * row + s, k)] = pack_bf16(v.x, v.y);
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = warpgroup();
  const int w = (threadIdx.x / 32) & 3, lane = threadIdx.x % 32;
  const int q = lane / 4, p = lane % 4;
  const int base = blockIdx.x * kTile;
  const int ray_at[2] = {base + 16 * w + q, base + 16 * w + q + 8};
  const float x = salt[0];
  const Ray ray[2] = {fake_ray((float)(ray_at[0] % kT), x),
                      fake_ray((float)(ray_at[1] % kT), x)};
  // A = F^T: features 2p, 2p + 1 (e < 2) and 2p + 8, 2p + 9 of ray e & 1
  uint32_t a[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    a[e] = pack_bf16(feature(ray[e & 1], 2 * p + 8 * (e >> 1)),
                     feature(ray[e & 1], 2 * p + 8 * (e >> 1) + 1));
  const uint64_t desc = kmajor_desc(gt);
  const bool tapping = tap != nullptr && base < kT;
  const int lo = (int)((long long)iters * wg / parts);
  const int hi = (int)((long long)iters * (wg + 1) / parts);
  int kmin[2] = {kMissKey, kMissKey};
  float d[kSplits][kN / 2];
#pragma unroll
  for (int sp = 0; sp < kSplits; ++sp)
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) d[sp][e] = 0.0f;
  for (int c = lo; c < hi; ++c) {
    const float sb = __fmul_rn(__fmul_rn(x, (float)c), 1e-20f);
#pragma unroll 1
    for (int ch = 0; ch < kChunks; ++ch) {
      wgmma_fence();
#pragma unroll
      for (int sp = 0; sp < kSplits; ++sp)   // a chunk: kN columns, 32 B each
        wgmma_bf16<kN>(d[sp], a, desc + (sp * kSplitWords + ch * kN * 8) / 4);
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int sp = 0; sp < kSplits; ++sp)
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) reg_fence(d[sp][e]);
      float bc[kN / 2];
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) {
        bc[e] = d[0][e];
#pragma unroll
        for (int sp = 1; sp < kSplits; ++sp) bc[e] = __fadd_rn(bc[e], d[sp][e]);
      }
      if (tapping && c == 0) {
#pragma unroll
        for (int e = 0; e < kN / 2; ++e)
          tap[((e & 1) * kRows + ch * (kN / 2) + 4 * (e >> 2) + p) * kT +
              ray_at[(e >> 1) & 1]] = bc[e];
      }
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int row = ch * (kN / 2) + 4 * j + p;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          kmin[h] = min(kmin[h], quad_key(__fadd_rn(bc[4 * j + 2 * h], sb),
                                          bc[4 * j + 2 * h + 1], ray[h],
                                          ~(kRows - 1), row));
      }
    }
  }
  // fold: over the ray's four lanes, then over the parts
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kmin[h] = min(kmin[h], __shfl_xor_sync(0xffffffffu, kmin[h], 1));
    kmin[h] = min(kmin[h], __shfl_xor_sync(0xffffffffu, kmin[h], 2));
    if (p == 0) part_key[wg][16 * w + q + 8 * h] = kmin[h];
  }
  __syncthreads();
  if (wg != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int krun = part_key[0][16 * w + q + 8 * h];
    for (int i = 1; i < parts; ++i)
      krun = min(krun, part_key[i][16 * w + q + 8 * h]);
    const int r = ray_at[h];
    float* o = out + (size_t)(r / kT) * 8 * kT + r % kT;
#pragma unroll
    for (int f = 2 * p; f < 2 * p + 2; ++f) {
      const float pay =
          krun < kMissKey ? __ldg(sph8 + f * kRows + (krun & (kRows - 1)))
                          : 0.0f;
      o[f * kT] = __fadd_rn(pay, (float)krun);
    }
  }
}

// the fewest warpgroups a tile, up to kMaxParts, that fill the card
int mxuquad_parts(int n) {
  int parts = 1;
  while (parts < kMaxParts && (n / kTile) * parts < kFillWarpgroups)
    parts *= 2;
  return parts;
}

template <int kRows>
int launch_rows(int mode, int splits, int parts, const float* salt,
                const float* tbl, const float* sph8, float* out, float* tap,
                int iters, int n, cudaStream_t st) {
  if (mode == 0) {
    if (splits != 1 || parts != 0) return (int)cudaErrorInvalidValue;
    visit_vpu<kRows><<<(n + 255) / 256, 256, 0, st>>>(salt, tbl, sph8, out,
                                                     iters, n);
    return 0;
  }
  if (mode != 1) return (int)cudaErrorInvalidValue;
  if (parts == 0) parts = mxuquad_parts(n);
  if (parts != 1 && parts != 2 && parts != 4) return (int)cudaErrorInvalidValue;
  const int blocks = n / kTile;
  if (splits == 1)
    visit_mma<kRows, 1><<<blocks, 128 * parts, 0, st>>>(salt, tbl, sph8, out,
                                                       tap, iters, parts);
  else if (splits == 3)
    visit_mma<kRows, 3><<<blocks, 128 * parts, 0, st>>>(salt, tbl, sph8, out,
                                                       tap, iters, parts);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// mode 0 vpu (tbl = sphT, splits 1), 1 mxuquad (tbl = G); rows 32, 64 or
// 128; size = rays, a multiple of 512; parts: mxuquad's warpgroups a tile
// (1, 2 or 4; 0 takes mxuquad_parts; vpu takes 0); tap null or (2 rows,
// 512) f32 (mxuquad only).
extern "C" int rt_microbench_mxuquad_launch_parts(int mode, int rows,
                                                  int splits, int parts,
                                                  int iters, int size,
                                                  const float* salt,
                                                  const float* tbl,
                                                  const float* sph8,
                                                  float* out, float* tap,
                                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (iters < 0 || size <= 0 || size % kT != 0)
    return (int)cudaErrorInvalidValue;
  int rc;
  switch (rows) {
    case 32: rc = launch_rows<32>(mode, splits, parts, salt, tbl, sph8, out,
                                  tap, iters, size, st);
      break;
    case 64: rc = launch_rows<64>(mode, splits, parts, salt, tbl, sph8, out,
                                  tap, iters, size, st);
      break;
    case 128: rc = launch_rows<128>(mode, splits, parts, salt, tbl, sph8, out,
                                    tap, iters, size, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// the same with the partition of mxuquad_parts
extern "C" int rt_microbench_mxuquad_launch(int mode, int rows, int splits,
                                            int iters, int size,
                                            const float* salt,
                                            const float* tbl,
                                            const float* sph8, float* out,
                                            float* tap, void* stream) {
  return rt_microbench_mxuquad_launch_parts(mode, rows, splits, 0, iters,
                                            size, salt, tbl, sph8, out, tap,
                                            stream);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
