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
//                                     before the loop; G is read and rounded
//                                     every visit, as the TPU probe does.
//
// mxuquad runs on the tensor cores through mma.sync.aligned.m16n8k16.row.
// col.f32.bf16.bf16.f32: the depth of 16 is the 16 features.  A warp takes
// 8 rays (the n of 8); its m-tile j holds G's b rows 8j..8j+7 in rows 0-7
// and the matching c rows in rows 8-15, so lane (g = lane / 4, t = lane % 4)
// gets b and c of sphere row 8j + g for rays 2t and 2t + 1 (the accumulator
// fragment, PTX ISA: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8,
// 2t+1)).  Each lane finishes the quadratic and the key for its two rays
// over its rows; the minimum over the 8 lanes of equal t is a shuffle
// butterfly (xor 4, 8, 16), after which lane g reads the winner's field g.
// The sum over splits is one mma a split from zero, then float32 adds in
// split order, as the TPU probe sums its split blocks.
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
// issue-bound by its FP32 tail, and by the shuffles and the mma's latency
// in a simple kernel (one mma in flight a warp; wgmma is a later kernel's).
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

// D = A (16x16, row) . B (16x8, col), bf16 operands, float32 from zero
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
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

// mxuquad: a warp per 8 rays
template <int kRows, int kSplits>
__global__ void __launch_bounds__(256)
visit_mma(const float* __restrict__ salt, const float* __restrict__ G,
          const float* __restrict__ sph8, float* __restrict__ out,
          float* __restrict__ tap, int iters, int n) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const int base = warp * 8;
  if (base >= n) return;
  const int g = lane / 4, t = lane % 4;
  const float x = salt[0];
  // B: features 2t, 2t+1 and 2t+8, 2t+9 of ray base + g
  const Ray rb = fake_ray((float)((base + g) % kT), x);
  const uint32_t bf[2] = {pack_bf16(feature(rb, 2 * t), feature(rb, 2 * t + 1)),
                          pack_bf16(feature(rb, 2 * t + 8),
                                    feature(rb, 2 * t + 9))};
  // this lane's rays in the accumulator: base + 2t and base + 2t + 1
  const int j0 = (base + 2 * t) % kT;
  const Ray ray[2] = {fake_ray((float)j0, x), fake_ray((float)(j0 + 1), x)};
  const bool tapping = tap != nullptr && base < kT;
  int krun[2] = {kMissKey, kMissKey};
  float pay[2] = {0.0f, 0.0f};   // field g of each ray
  for (int c = 0; c < iters; ++c) {
    const float sb = __fmul_rn(__fmul_rn(x, (float)c), 1e-20f);
    int kmin[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll 2
    for (int mt = 0; mt < kRows / 8; ++mt) {
      const int row = 8 * mt + g;
      float acc[4];
#pragma unroll
      for (int sp = 0; sp < kSplits; ++sp) {
        const float* gb = G + ((size_t)sp * 2 * kRows + row) * kF;
        const float* gc = gb + (size_t)kRows * kF;
        const float2 b01 = __ldg(reinterpret_cast<const float2*>(gb + 2 * t));
        const float2 c01 = __ldg(reinterpret_cast<const float2*>(gc + 2 * t));
        const float2 b89 =
            __ldg(reinterpret_cast<const float2*>(gb + 2 * t + 8));
        const float2 c89 =
            __ldg(reinterpret_cast<const float2*>(gc + 2 * t + 8));
        const uint32_t a[4] = {pack_bf16(b01.x, b01.y), pack_bf16(c01.x, c01.y),
                               pack_bf16(b89.x, b89.y), pack_bf16(c89.x, c89.y)};
        float d[4];
        mma_bf16(d, a, bf);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] = sp == 0 ? __fadd_rn(0.0f, d[e]) : __fadd_rn(acc[e], d[e]);
      }
      if (tapping && c == 0) {
        tap[row * kT + base + 2 * t] = acc[0];
        tap[row * kT + base + 2 * t + 1] = acc[1];
        tap[(kRows + row) * kT + base + 2 * t] = acc[2];
        tap[(kRows + row) * kT + base + 2 * t + 1] = acc[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        kmin[i] = min(kmin[i], quad_key(__fadd_rn(acc[i], sb), acc[2 + i],
                                        ray[i], ~(kRows - 1), row));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        kmin[i] = min(kmin[i], __shfl_xor_sync(0xffffffffu, kmin[i], o));
      if (kmin[i] < krun[i]) {
        pay[i] = __ldg(sph8 + g * kRows + (kmin[i] & (kRows - 1)));
        krun[i] = kmin[i];
      }
    }
  }
  float* o = out + (size_t)(base / kT) * 8 * kT + g * kT;
  o[j0] = __fadd_rn(pay[0], (float)krun[0]);
  o[j0 + 1] = __fadd_rn(pay[1], (float)krun[1]);
}

template <int kRows>
int launch_rows(int mode, int splits, const float* salt, const float* tbl,
                const float* sph8, float* out, float* tap, int iters, int n,
                cudaStream_t st) {
  if (mode == 0) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    visit_vpu<kRows><<<(n + 255) / 256, 256, 0, st>>>(salt, tbl, sph8, out,
                                                     iters, n);
    return 0;
  }
  if (mode != 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n / 8 * 32 + 255) / 256;
  if (splits == 1)
    visit_mma<kRows, 1><<<blocks, 256, 0, st>>>(salt, tbl, sph8, out, tap,
                                               iters, n);
  else if (splits == 3)
    visit_mma<kRows, 3><<<blocks, 256, 0, st>>>(salt, tbl, sph8, out, tap,
                                               iters, n);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// mode 0 vpu (tbl = sphT, splits 1), 1 mxuquad (tbl = G); rows 32, 64 or
// 128; size = rays, a multiple of 512; tap null or (2 rows, 512) f32
// (mxuquad only).
extern "C" int rt_microbench_mxuquad_launch(int mode, int rows, int splits,
                                            int iters, int size,
                                            const float* salt,
                                            const float* tbl,
                                            const float* sph8, float* out,
                                            float* tap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (iters < 0 || size <= 0 || size % kT != 0)
    return (int)cudaErrorInvalidValue;
  int rc;
  switch (rows) {
    case 32: rc = launch_rows<32>(mode, splits, salt, tbl, sph8, out, tap,
                                  iters, size, st);
      break;
    case 64: rc = launch_rows<64>(mode, splits, salt, tbl, sph8, out, tap,
                                  iters, size, st);
      break;
    case 128: rc = launch_rows<128>(mode, splits, salt, tbl, sph8, out, tap,
                                    iters, size, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
