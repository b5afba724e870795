// Ray math shared by K1 (megakernel.cu) and K2 (replay_bwd.cu).
//
// K2 replays the path K1 took: it recomputes every bounce from the recorded
// winner's fields, so the two kernels must compute each bounce with the same
// float32 operations in the same order.  Both include this header, so they
// cannot drift apart.  The plain torch versions mirror it in
// render/ray_math.py.
//
// Arithmetic contract (the sources build with -fmad=false and IEEE
// division and square root; render/_cuda.py):
//   * no multiply-add is contracted, and every sum is written in the order
//     it is evaluated: (x + y) + z;
//   * rsqrt(a) of the TPU shading is 1.0f / sqrtf(a);
//   * the closest-hit search runs in m = a*t space, and its key floor clears
//     the 7 lane bits of m's float32 bits (pallas_kernel.py:646-710); the
//     re-intersection window is floor(m) / a + 1 (pallas_kernel.py:894-911).
#pragma once

#include <stdint.h>

namespace rt {

constexpr int kLane = 128;                 // spheres per cluster
constexpr int kKeyMask = ~(kLane - 1);     // clears the 7 lane bits
constexpr float kBig = 1e9f;               // T_MAX, the miss value
constexpr float kEps = 0.1f;               // SCENE_EPSILON
// the sky gradient's endpoint per channel (ray.fut:141-148), and the
// endpoint minus one, rounded once from double as the JAX source's
// Python constants are
constexpr float kSkyR = 0.5f, kSkyG = 0.7f, kSkyB = 1.0f;
constexpr float kSkyRm1 = (float)(0.5 - 1.0), kSkyGm1 = (float)(0.7 - 1.0),
                kSkyBm1 = (float)(1.0 - 1.0);

// Primary ray g of the ray order (pallas_kernel.py:379-431): lane g % tile
// of tile g / tile, mapped to its pixel by scanline or by image blocks.
// Exact integer div/mod gives the values the TPU's float floor plus
// renormalisation gives.
__device__ __forceinline__ void primary_ray(const float* __restrict__ p,
                                            int g, int tile, int block_tiled,
                                            float& dx, float& dy, float& dz) {
  int i, j;
  if (block_tiled) {
    const int bpr = (int)p[20], bw = (int)p[21], bh = (int)p[22];
    const int pid = g / tile, lid = g % tile;
    i = (pid % bpr) * bw + lid % bw;
    j = (pid / bpr) * bh + lid / bw;
  } else {
    const int w = (int)p[16];
    i = g % w;
    j = g / w;
  }
  const float u = (float)i * p[18];
  const float v = (p[17] - ((float)j + p[12])) * p[19];
  dx = ((p[0] + u * p[3]) + v * p[6]) - p[9];
  dy = ((p[1] + u * p[4]) + v * p[7]) - p[10];
  dz = ((p[2] + u * p[5]) + v * p[8]) - p[11];
}

// The quadratic of a ray (o, d) with a = d.d and a sphere (c, r2 = r*r).
struct Quad {
  float ocx, ocy, ocz, b, c, disc;
};

__device__ __forceinline__ Quad quad(float ox, float oy, float oz, float dx,
                                     float dy, float dz, float a, float cx,
                                     float cy, float cz, float r2) {
  Quad q;
  q.ocx = ox - cx;
  q.ocy = oy - cy;
  q.ocz = oz - cz;
  q.b = (q.ocx * dx + q.ocy * dy) + q.ocz * dz;
  q.c = ((q.ocx * q.ocx + q.ocy * q.ocy) + q.ocz * q.ocz) - r2;
  q.disc = q.b * q.b - a * q.c;
  return q;
}

// The search value of the closest-hit sweep: m = a*t of the near root if it
// lies beyond epsa = eps*a, else of the far root; kBig on a miss.  sq is
// sqrtf(disc) wherever disc > 0 (its value elsewhere is never used).
__device__ __forceinline__ float search_m(const Quad& q, float sq,
                                          float epsa) {
  const float m0 = -q.b - sq;
  const float m = (m0 > epsa) ? m0 : (-q.b + sq);
  return (q.disc > 0.0f && m > epsa) ? m : kBig;
}

// m with its 7 lane bits cleared, as the packed key holds it.
__device__ __forceinline__ float key_floor(float m) {
  return __int_as_float(__float_as_int(m) & kKeyMask);
}

// A hit's re-intersection in the widened window (0, best_m / a + 1) and its
// mirror shading (pallas_kernel.py:894-931): hit point, normal, unit
// direction, reflection and the scatter test.
struct Bounce {
  Quad q;
  float sq, inv_a, t2;
  bool near;                       // the near root was taken
  float px, py, pz, inv_r, nx, ny, nz;
  float inv_dn, ux, uy, uz, udn, rx, ry, rz;
  bool scatter;                    // the reflection leaves the surface
};

__device__ __forceinline__ Bounce bounce(float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float a, float cx, float cy,
                                         float cz, float rad, float best_m) {
  Bounce h;
  h.q = quad(ox, oy, oz, dx, dy, dz, a, cx, cy, cz, rad * rad);
  h.sq = sqrtf(h.q.disc > 0.0f ? h.q.disc : 1.0f);
  h.inv_a = 1.0f / a;
  const float t0 = (-h.q.b - h.sq) * h.inv_a;
  const float t1 = (-h.q.b + h.sq) * h.inv_a;
  const float w_hi = best_m * h.inv_a + 1.0f;
  h.near = t0 < w_hi && t0 > 0.0f;
  h.t2 = h.near ? t0 : t1;
  h.px = ox + h.t2 * dx;
  h.py = oy + h.t2 * dy;
  h.pz = oz + h.t2 * dz;
  h.inv_r = 1.0f / rad;
  h.nx = (h.px - cx) * h.inv_r;
  h.ny = (h.py - cy) * h.inv_r;
  h.nz = (h.pz - cz) * h.inv_r;
  h.inv_dn = 1.0f / sqrtf(a);
  h.ux = dx * h.inv_dn;
  h.uy = dy * h.inv_dn;
  h.uz = dz * h.inv_dn;
  h.udn = (h.ux * h.nx + h.uy * h.ny) + h.uz * h.nz;
  h.rx = h.ux - (2.0f * h.udn) * h.nx;
  h.ry = h.uy - (2.0f * h.udn) * h.ny;
  h.rz = h.uz - (2.0f * h.udn) * h.nz;
  h.scatter = ((h.rx * h.nx + h.ry * h.ny) + h.rz * h.nz) > 0.0f;
  return h;
}

// The sky gradient's weight for a channel of endpoint k at
// t = 0.5 * (uy + 1).
__device__ __forceinline__ float sky(float t, float k) {
  return (1.0f - t) + t * k;
}

}  // namespace rt
