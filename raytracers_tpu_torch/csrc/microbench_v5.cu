// M5 and M6, the probes of tools/microbench_v5.py, for Hopper (sm_90a).
//
//   M5 visit_kernel (:50)   `iters` visits of one (rows, 8) sphere table,
//                           rows 32, 64 or 128, by 512 fake rays a tile; at
//                           visit c the table's x column is shifted by
//                           salt * c.  A visit: oc = o - s, b = oc.d,
//                           c = |oc|^2 - r2, disc, sqrtf, the near or far
//                           root past eps, the key (bits(t) & mask) | row
//                           and its minimum over the rows; then
//                             mxu    mask ~(rows - 1); on a strict
//                                    improvement the winner's 8 fields of
//                                    the (8, rows) table are read by index
//                                    (the TPU's one-hot MXU dot, which for
//                                    finite fields selects them exactly);
//                             defer  mask ~511; on an improvement the
//                                    visit's index is kept (cidx), for a
//                                    bounce to read its payload once (M6).
//                           One thread per ray, its rows in order (K1's
//                           design), or a warp per ray, rows lane + 32e,
//                           the key's minimum by __reduce_min_sync and
//                           lane f < 8 reading field f.  The table (at most
//                           4 KB) is read through __ldg and stays in L1.
//   M6 gather_kernel (:135) the deferred read: for 64 steps i each lane
//                           sums the 8 fields of slot (lane*37 + i) mod W
//                           of an (8, W) table, W = chunks * 128, in field
//                           order ((0 + f0) + f1) + ... + f7, and adds the
//                           sum to its running sum.  Through __ldg, or from
//                           a copy the block stages in shared memory: 37 is
//                           odd, so the 32 lanes of a warp read 32 banks.
//                           The TPU probe's salt * 0.0 changes no value but
//                           -0, which no table of the probes holds, so the
//                           kernel leaves it out.
//
// Each variant is bit-equal to its plain torch version (probes/
// microbench_v5.py): the arithmetic is written as IEEE intrinsics in the
// order the plain version evaluates it (csrc/probe_visit.cuh), -fmad=false.
//
// What bounds each on this card: both are issue-bound by design.  M5 moves
// a few KB of table and writes 32 bytes a ray; a (ray, row) test is 32
// lane operations and a square root.  M6 reads at most 16 KB of table and
// writes 4 bytes a lane; a lane-step is 12 lane operations, 8 of them the
// field sums, and 8 loads from L1 or shared memory.
//
// Layouts: salt (1,) f32.  M5 sphT (rows, 8) f32 rows [cx cy cz . . . . r^2],
// sph8 (8, rows) f32 payload fields, out (n/512, 8, 512) f32 =
// (pay + (float)krun) + (float)cidx.  M6 tbl (8, W) f32, out (n/512, 1, 512).

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

template <int kRows, bool kDefer>
constexpr int kKeyMask = kDefer ? ~511 : ~(kRows - 1);

// ------------------------------------------------------------------ M5
// (a) one thread per ray, its rows in order
template <int kRows, bool kDefer>
__global__ void __launch_bounds__(256)
visit_thread(const float* __restrict__ salt, const float* __restrict__ sphT,
             const float* __restrict__ sph8, float* __restrict__ out,
             int iters, int n) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int j = g % kT;
  const float x = salt[0];
  const Ray r = fake_ray((float)j, x);
  int krun = kMissKey, cidx = 0;
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
      kmin = min(kmin, quad_key(b, cq, r, kKeyMask<kRows, kDefer>, row));
    }
    if (kmin < krun) {
      if constexpr (kDefer) {
        cidx = c;
      } else {
        const int w = kmin & (kRows - 1);
#pragma unroll
        for (int f = 0; f < 8; ++f) pay[f] = __ldg(sph8 + f * kRows + w);
      }
      krun = kmin;
    }
  }
  float* o = out + (size_t)(g / kT) * 8 * kT + j;
#pragma unroll
  for (int f = 0; f < 8; ++f)
    o[f * kT] = __fadd_rn(__fadd_rn(pay[f], (float)krun), (float)cidx);
}

// (b) a warp per ray: lane l tests rows l + 32e, e < rows / 32
template <int kRows, bool kDefer>
__global__ void __launch_bounds__(256)
visit_warp(const float* __restrict__ salt, const float* __restrict__ sphT,
           const float* __restrict__ sph8, float* __restrict__ out, int iters,
           int n) {
  constexpr int kE = kRows / 32;
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (g >= n) return;
  const int j = g % kT;
  const float x = salt[0];
  const Ray r = fake_ray((float)j, x);
  int krun = kMissKey, cidx = 0;
  float pay = 0.0f;
  for (int c = 0; c < iters; ++c) {
    const float s = __fmul_rn(x, (float)c);
    int kmin = 0x7fffffff;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int row = lane + 32 * e;
      float b, cq;
      row_bc(sphT, row, s, r, b, cq);
      kmin = min(kmin, quad_key(b, cq, r, kKeyMask<kRows, kDefer>, row));
    }
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    if (kmin < krun) {
      if constexpr (kDefer)
        cidx = c;
      else if (lane < 8)
        pay = __ldg(sph8 + lane * kRows + (kmin & (kRows - 1)));
      krun = kmin;
    }
  }
  if (lane < 8)
    out[(size_t)(g / kT) * 8 * kT + lane * kT + j] =
        __fadd_rn(__fadd_rn(pay, (float)krun), (float)cidx);
}

template <int kRows, bool kDefer>
int launch_visit_rows(int way, const float* salt, const float* sphT,
                      const float* sph8, float* out, int iters, int n,
                      cudaStream_t st) {
  if (way == 0)
    visit_thread<kRows, kDefer><<<(n + 255) / 256, 256, 0, st>>>(
        salt, sphT, sph8, out, iters, n);
  else if (way == 1)
    visit_warp<kRows, kDefer><<<(n + 7) / 8, 256, 0, st>>>(salt, sphT, sph8,
                                                          out, iters, n);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool kDefer>
int launch_visit(int way, int rows, const float* salt, const float* sphT,
                 const float* sph8, float* out, int iters, int n,
                 cudaStream_t st) {
  switch (rows) {
    case 32: return launch_visit_rows<32, kDefer>(way, salt, sphT, sph8, out,
                                                  iters, n, st);
    case 64: return launch_visit_rows<64, kDefer>(way, salt, sphT, sph8, out,
                                                  iters, n, st);
    case 128: return launch_visit_rows<128, kDefer>(way, salt, sphT, sph8,
                                                    out, iters, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ M6
template <bool kSmem>
__global__ void __launch_bounds__(256)
gather_probe(const float* __restrict__ tbl, float* __restrict__ out,
             int iters, int width, int n) {
  extern __shared__ float stbl[];
  if constexpr (kSmem) {
    for (int i = threadIdx.x; i < 8 * width; i += blockDim.x)
      stbl[i] = __ldg(tbl + i);
    __syncthreads();
  }
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int j = g % kT;
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const int slot = (j * 37 + i) % width;
    float s = 0.0f;
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const float v = kSmem ? stbl[f * width + slot]
                            : __ldg(tbl + f * width + slot);
      s = __fadd_rn(s, v);
    }
    acc = __fadd_rn(acc, s);
  }
  out[g] = acc;
}

}  // namespace

// One entry point for both probes.  probe 0 (M5): way (0 thread, 1 warp),
// width = rows (32, 64, 128), payload (0 mxu, 1 defer), size = rays, in0 =
// sphT, in1 = sph8; probe 1 (M6): way (0 __ldg, 1 shared memory), width =
// chunks (1 or 4), size = lanes, in0 = the table.  size is a multiple of
// 512.  The salt of M6 is not read.
extern "C" int rt_microbench_v5_launch(int probe, int way, int width,
                                       int payload, int iters, int size,
                                       const float* salt, const float* in0,
                                       const float* in1, float* out,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (iters < 0 || size <= 0 || size % kT != 0)
    return (int)cudaErrorInvalidValue;
  int rc = 0;
  if (probe == 0) {
    if (payload == 0)
      rc = launch_visit<false>(way, width, salt, in0, in1, out, iters, size,
                               st);
    else if (payload == 1)
      rc = launch_visit<true>(way, width, salt, in0, in1, out, iters, size,
                              st);
    else
      return (int)cudaErrorInvalidValue;
  } else if (probe == 1) {
    if (width != 1 && width != 4) return (int)cudaErrorInvalidValue;
    const int w = width * 128;
    const int blocks = (size + 255) / 256;
    if (way == 0)
      gather_probe<false><<<blocks, 256, 0, st>>>(in0, out, iters, w, size);
    else if (way == 1)
      gather_probe<true><<<blocks, 256, 8 * w * sizeof(float), st>>>(
          in0, out, iters, w, size);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
