// The visit arithmetic shared by M5 (csrc/microbench_v5.cu) and M7
// (csrc/microbench_mxuquad.cu): the fake ray of tools/microbench_v5.py:55-63
// (and tools/microbench_mxuquad.py:47-55, the same ray) and the quadratic's
// key of one (ray, sphere row).  Every operation is written as the IEEE
// intrinsic it is (the sources build with -fmad=false), in the order the
// plain versions of probes/microbench_v5.py evaluate it.
#pragma once

#include <cuda_runtime.h>

namespace probe_visit {

constexpr int kT = 512;              // the TPU probes' lane width T
constexpr int kMissKey = 0x7F000000; // krun's initial value

struct Ray {
  float ox, oy, oz, dx, dy, dz, a, inv_a;
};

__device__ __forceinline__ Ray fake_ray(float lid, float x) {
  Ray r;
  r.ox = __fadd_rn(__fmul_rn(lid, 1e-3f), x);
  r.oy = __fmul_rn(lid, 2e-3f);
  r.oz = 30.0f;
  r.dx = __fadd_rn(__fmul_rn(lid, 1e-4f), 0.1f);
  r.dy = __fadd_rn(__fmul_rn(lid, -1e-4f), 0.2f);
  r.dz = -1.0f;
  r.a = __fadd_rn(__fadd_rn(__fmul_rn(r.dx, r.dx), __fmul_rn(r.dy, r.dy)),
                  __fmul_rn(r.dz, r.dz));
  r.inv_a = 1.0f / r.a;
  return r;
}

// b = oc.d and c = |oc|^2 - r2 of table row `row` (cx cy cz . . . . r2),
// its x shifted by `shift`: oc = o - s.
__device__ __forceinline__ void row_bc(const float* __restrict__ sphT,
                                       int row, float shift, const Ray& r,
                                       float& b, float& c) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(sphT + 8 * row));
  const float r2 = __ldg(sphT + 8 * row + 7);
  const float ocx = __fsub_rn(r.ox, __fadd_rn(lo.x, shift));
  const float ocy = __fsub_rn(r.oy, lo.y);
  const float ocz = __fsub_rn(r.oz, lo.z);
  b = __fadd_rn(__fadd_rn(__fmul_rn(ocx, r.dx), __fmul_rn(ocy, r.dy)),
                __fmul_rn(ocz, r.dz));
  c = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy)),
                          __fmul_rn(ocz, ocz)),
                r2);
}

// The key (bits(t) & mask) | row: disc = b^2 - a c, the near root past eps
// or else the far one, 1e9 for a miss (tools/microbench_v5.py:85-93).
__device__ __forceinline__ int quad_key(float b, float c, const Ray& r,
                                        int mask, int row) {
  const float disc = __fsub_rn(__fmul_rn(b, b), __fmul_rn(r.a, c));
  const bool pos = disc > 0.0f;
  const float sq = sqrtf(pos ? disc : 1.0f);
  const float nb = -b;
  const float t0 = __fmul_rn(__fsub_rn(nb, sq), r.inv_a);
  const float t1 = __fmul_rn(__fadd_rn(nb, sq), r.inv_a);
  const float t = t0 > 0.1f ? t0 : t1;
  const float tv = (pos && t > 0.1f) ? t : 1e9f;
  return (__float_as_int(tv) & mask) | row;
}

}  // namespace probe_visit
