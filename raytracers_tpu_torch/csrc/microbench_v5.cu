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
//                           phase-0 design), or k lanes a ray (the lanes
//                           way), lane i on rows i + k*e, the key folded
//                           within the group once a visit and lane f < 8
//                           reading field f: one template, visit_lanes,
//                           for both.  The table (at most 4 KB) is read in
//                           K1's slot-major layout through __ldg and stays
//                           in L1.
//   M6 gather_kernel (:135) the deferred read: for 64 steps i each lane
//                           sums the 8 fields of slot (lane*37 + i) mod W
//                           of an (8, W) table, W = chunks * 128, in field
//                           order ((0 + f0) + f1) + ... + f7, and adds the
//                           sum to its running sum.  Through __ldg from the
//                           slot-major (W, 8) copy, two 16-byte loads a
//                           lane-step as K1 reads its winner's payload, or
//                           from a copy the block stages in shared memory
//                           (8 words a lane-step).  The TPU probe's
//                           salt * 0.0 changes no value but -0, which no
//                           table of the probes holds, so the kernel leaves
//                           it out.
//
// Each variant is bit-equal to its plain torch version (probes/
// microbench_v5.py): the arithmetic is written as IEEE intrinsics in the
// order the plain version evaluates it (csrc/probe_visit.cuh), -fmad=false.
//
// What bounds each on this card.  M5 moves a few KB of table and writes 32
// bytes a ray; a (ray, row) test is 32 lane operations and a square root,
// about 10 issue cycles for 32 tests, and its loads take 2 ceil(k / 4) L1
// wavefronts for 32 tests at k lanes a ray in the slot-major layout, 4 in
// the field-major one (16 at a warp a ray, which held that route to within
// 5% of one wavefront a cycle an SM).  At k = 8 the FP32 pipe bounds it;
// at 8,192 rays 8,192 x k lanes are 16 warps an SM, whose latency keeps it
// at 59-70% of that bound (NVIDIA H100 80GB HBM3, 700 W).
// M6 reads at most 16 KB of table and
// writes 4 bytes a lane; a lane-step brings its slot's 32 bytes through L1
// or shared memory, 128 bytes a cycle an SM, which bounds it (0.0642 ms at
// 1M lanes, 1980 MHz); its 9 adds and the slot's increment and mask are
// far below that on the FP32 and integer pipes.
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
// k lanes a ray (a thread a ray at k = 1): lane i of a ray's group tests
// rows i + k*e, e < rows / k; the group folds its keys once a visit
// (group_min), every lane makes the same strict-less update of krun, and on
// an improvement the group's lanes read the winner's 8 fields, lane i the
// fields i + k*m (one each at k >= 8, all 8 at k = 1).
//
// Why k lanes: L1 serves a warp's load in wavefronts, a 16-byte unit from
// each of 8 bank groups a wavefront, and lanes in one group at different
// addresses take a wavefront each (probes/m3m6_turns.py load_model).
// row_bc reads a row's 16 bytes at byte 0 (an even group) and 4 at byte 28
// (an odd one), so a warp's 32 distinct rows at k = 32 (the parent's warp
// a ray) take 16 wavefronts for 32 tests, about 1.6 times their
// arithmetic; k lanes a ray read k distinct rows a load, 2 ceil(k / 4)
// wavefronts (probes/microbench.py visit_load_model), while 8,192 rays x k
// lanes fill the card where a thread a ray (256 warps) does not.
//
// k and the table's layout of the lanes way at 32, 64 and 128 rows: the
// card's sweep of k in {4, 8, 16, 32} in both layouts at the TPU probe's
// 8,192 rays (probes/m4m5_turns.py, docs/M4M5_TURNS_H100.json), where the
// field-major (8, rows) copy the caller passes (a 4-byte load a field, 4
// wavefronts for 32 tests at any k) beat K1's slot-major (rows, 8) layout
// by more than 5% at 32 and 64 rows; probes/microbench_v5.py VISIT_LANES
// and VISIT_LAYOUT hold the same.  The thread way reads K1's layout.
constexpr int kVisitLanes[3] = {8, 32, 8};
constexpr bool kFieldMajor[3] = {true, true, false};

template <int kRows>
constexpr int kWidthAt = kRows == 32 ? 0 : kRows == 64 ? 1 : 2;
template <int kRows>
constexpr int kLanesAt = kVisitLanes[kWidthAt<kRows>];

// row_bc of the table t, slot-major or (kField) field-major
template <int kRows, bool kField>
__device__ __forceinline__ void table_bc(const float* __restrict__ t,
                                         int row, float shift, const Ray& r,
                                         float& b, float& c) {
  if constexpr (kField) {
    const float ocx = __fsub_rn(r.ox, __fadd_rn(__ldg(t + row), shift));
    const float ocy = __fsub_rn(r.oy, __ldg(t + kRows + row));
    const float ocz = __fsub_rn(r.oz, __ldg(t + 2 * kRows + row));
    b = __fadd_rn(__fadd_rn(__fmul_rn(ocx, r.dx), __fmul_rn(ocy, r.dy)),
                  __fmul_rn(ocz, r.dz));
    c = __fsub_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy)),
                  __fmul_rn(ocz, ocz)),
        __ldg(t + 7 * kRows + row));
  } else {
    row_bc(t, row, shift, r, b, c);
  }
}

// The minimum of a ray's k lanes' keys, in each of them: log2 k rounds of
// __shfl_xor_sync within the group (template recursions, so that nvcc
// unrolls them), or at k = 32 one __reduce_min_sync.
template <int kO>
__device__ __forceinline__ int butterfly(int v) {
  if constexpr (kO >= 1)
    return butterfly<kO / 2>(min(v, __shfl_xor_sync(0xffffffffu, v, kO)));
  else
    return v;
}

template <int kLanes>
__device__ __forceinline__ int group_min(int v) {
  if constexpr (kLanes == 32)
    return __reduce_min_sync(0xffffffffu, v);
  else
    return butterfly<kLanes / 2>(v);
}

// The grid is exact (n is a multiple of 512), so every warp runs whole.
template <int kRows, bool kDefer, int kLanes>
__global__ void __launch_bounds__(256)
visit_lanes(const float* __restrict__ salt, const float* __restrict__ sphT,
            const float* __restrict__ sph8, float* __restrict__ out,
            int iters) {
  static_assert(32 % kLanes == 0 && kLanes <= kRows, "k divides a warp");
  constexpr int kE = kRows / kLanes;                  // rows a lane
  constexpr int kF = kLanes < 8 ? 8 / kLanes : 1;     // fields a lane
  constexpr bool kField = kLanes > 1 && kFieldMajor[kWidthAt<kRows>];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t / kLanes, i = t % kLanes;
  const int j = g % kT;
  const float x = salt[0];
  const Ray r = fake_ray((float)j, x);
  int krun = kMissKey, cidx = 0;
  float pay[kF];
#pragma unroll
  for (int m = 0; m < kF; ++m) pay[m] = 0.0f;
  for (int c = 0; c < iters; ++c) {
    const float s = __fmul_rn(x, (float)c);
    int kmin = 0x7fffffff;
#pragma unroll (kE <= 16 ? kE : 4)
    for (int e = 0; e < kE; ++e) {
      const int row = i + kLanes * e;
      float b, cq;
      table_bc<kRows, kField>(sphT, row, s, r, b, cq);
      kmin = min(kmin, quad_key(b, cq, r, kKeyMask<kRows, kDefer>, row));
    }
    kmin = group_min<kLanes>(kmin);
    if (kmin < krun) {
      if constexpr (kDefer) {
        cidx = c;
      } else if (i < 8) {
        const int w = kmin & (kRows - 1);
#pragma unroll
        for (int m = 0; m < kF; ++m)
          pay[m] = __ldg(sph8 + (i + kLanes * m) * kRows + w);
      }
      krun = kmin;
    }
  }
  if (i < 8) {
    float* o = out + (size_t)(g / kT) * 8 * kT + j;
#pragma unroll
    for (int m = 0; m < kF; ++m)
      o[(i + kLanes * m) * kT] =
          __fadd_rn(__fadd_rn(pay[m], (float)krun), (float)cidx);
  }
}

// lanes 1 (the thread way) or the build's k at this width (the lanes way)
template <int kRows, bool kDefer>
int launch_visit_rows(int lanes, const float* salt, const float* sphT,
                      const float* sph8, float* out, int iters, int n,
                      cudaStream_t st) {
  constexpr int k = kLanesAt<kRows>;
  if (lanes == 1)
    visit_lanes<kRows, kDefer, 1><<<n / 256, 256, 0, st>>>(salt, sphT, sph8,
                                                           out, iters);
  else if (lanes == k)
    visit_lanes<kRows, kDefer, k><<<n / 256 * k, 256, 0, st>>>(
        salt, sphT, sph8, out, iters);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool kDefer>
int launch_visit(int lanes, int rows, const float* salt, const float* sphT,
                 const float* sph8, float* out, int iters, int n,
                 cudaStream_t st) {
  switch (rows) {
    case 32: return launch_visit_rows<32, kDefer>(lanes, salt, sphT, sph8,
                                                  out, iters, n, st);
    case 64: return launch_visit_rows<64, kDefer>(lanes, salt, sphT, sph8,
                                                  out, iters, n, st);
    case 128: return launch_visit_rows<128, kDefer>(lanes, salt, sphT, sph8,
                                                    out, iters, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ M6
// The width W is a template (128 or 512 slots), so a lane's slot starts at
// (j * 37) & (W - 1) and steps by an increment and a mask: no division.
// Ways (the C entry's codes):
//   0 __ldg, slot-major: the (W, 8) copy the wrapper makes, each slot's 8
//     fields as two float4 (16-byte) loads, as K1 reads its winner's
//     payload (csrc/megakernel.cu).  Two limits of L1 hold it at about
//     twice its bytes' time (probes/m3m6_turns.py, load_model and its side
//     builds): a warp's load takes a wavefront for each lane that meets
//     another in one of 8 16-byte bank groups at another address, and
//     every lower half lies in an even group, so 8 wavefronts a load
//     against its bytes' 4; and L1 takes about 3 distinct lines a cycle,
//     against the 25.75 (W = 128) and 32 (W = 512) lines of this probe's
//     scattered slots.  Alternating the halves' order across lanes halves
//     the wavefronts but not the lines: no gain here, so K1's order stays;
//   1 shared memory, field-major: the block stages the (8, W) table as it
//     is and reads 8 words a lane-step; 37 is odd, so a warp's 32 lanes
//     read 32 banks.  A slot-major staging, padded to 12 words a slot so
//     that two float4 loads meet no bank conflict, ran 0.5-0.7% slower.
// Blocks of the shared way loop over tiles of 256 lanes, so that the table
// is staged once for each block the card holds at a time, not once a tile.
enum { kGatherLdgSlots = 0, kGatherSmem = 1 };
constexpr int kSlotStride = 37;   // slots between neighbouring lanes

template <int kWidth, int kWay>
__global__ void __launch_bounds__(256)
gather_probe(const float* __restrict__ tbl, float* __restrict__ out,
             int iters, int n) {
  extern __shared__ __align__(16) float stbl[];
  if constexpr (kWay == kGatherSmem) {
    for (int i = threadIdx.x; i < 8 * kWidth; i += blockDim.x)
      stbl[i] = __ldg(tbl + i);
    __syncthreads();
  }
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n;
       g += gridDim.x * blockDim.x) {
    int slot = (g % kT) * kSlotStride & (kWidth - 1);
    float acc = 0.0f;
#pragma unroll 4
    for (int i = 0; i < iters; ++i) {
      float v[8];
      if constexpr (kWay == kGatherSmem) {
#pragma unroll
        for (int f = 0; f < 8; ++f) v[f] = stbl[f * kWidth + slot];
      } else {
        const float4* p = reinterpret_cast<const float4*>(tbl) + 2 * slot;
        const float4 lo = __ldg(p), hi = __ldg(p + 1);
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      }
      float s = 0.0f;
#pragma unroll
      for (int f = 0; f < 8; ++f) s = __fadd_rn(s, v[f]);
      acc = __fadd_rn(acc, s);
      slot = (slot + 1) & (kWidth - 1);
    }
    out[g] = acc;
  }
}

template <int kWidth, int kWay>
int launch_gather(const float* tbl, float* out, int iters, int n,
                  cudaStream_t st) {
  const int tiles = (n + 255) / 256;
  if constexpr (kWay == kGatherLdgSlots) {
    gather_probe<kWidth, kWay><<<tiles, 256, 0, st>>>(tbl, out, iters, n);
  } else {
    constexpr size_t smem = sizeof(float) * 8 * kWidth;
    static int resident = 0;     // blocks the card holds at a time
    if (resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_probe<kWidth, kWay>, 256, smem);
      resident = sms * per_sm;
    }
    const int blocks = resident > 0 && resident < tiles ? resident : tiles;
    gather_probe<kWidth, kWay><<<blocks, 256, smem, st>>>(tbl, out, iters, n);
  }
  return 0;
}

template <int kWidth>
int launch_gather_way(int way, const float* tbl, float* out, int iters,
                      int n, cudaStream_t st) {
  switch (way) {
    case kGatherSmem:
      return launch_gather<kWidth, kGatherSmem>(tbl, out, iters, n, st);
    case kGatherLdgSlots:
      return launch_gather<kWidth, kGatherLdgSlots>(tbl, out, iters, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One entry point for both probes.  probe 0 (M5): way = lanes a ray (1 the
// thread way, the build's k at the width the lanes way; any other is
// refused), width = rows (32, 64, 128), payload (0 mxu, 1 defer), size =
// rays, in0 = sphT (for the lanes way its field-major copy where the
// build's kFieldMajor says so), in1 = sph8;
// probe 1 (M6): way (0 __ldg slot-major, 1 shared
// memory), width = chunks (1 or 4), size = lanes, in0 = the table, (W, 8)
// for way 0 and (8, W) for way 1.  size is a multiple of 512.  The
// salt of M6 is not read.
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
    if (width == 1)
      rc = launch_gather_way<128>(way, in0, out, iters, size, st);
    else if (width == 4)
      rc = launch_gather_way<512>(way, in0, out, iters, size, st);
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
