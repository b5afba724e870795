// K1, the forward megakernel of the sphere ray tracer, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracers_tpu/render/pallas_kernel.py:_megakernel
// (the Pallas megakernel: fused ray generation or state load, then a bounce
// loop of cluster culling, occlusion gating, packed-key closest hit over
// clusters of 32, 64 or 128 spheres, re-intersection and mirror shading).  It
// computes what that kernel computes per ray, not its tile mechanics: each
// ray runs its own bounce loop, so a ray stops when it dies instead of
// riding its tile's deepest ray.  Culling and the occlusion gate therefore act
// per ray; culling is conservative, so only a candidate in the same 2^-16
// key-floor bucket can be dropped, and the plain torch version
// (render/megakernel.py:megakernel_reference) applies the same per-ray gates.
//
// Two routes compute that one function (kLanes, lanes per ray; the wrapper
// picks one per launch):
//   * kLanes = 1, a thread per ray: the lane runs its ray's whole bounce loop
//     alone, sweeping every cluster row one after another.  Best where rays
//     are many and alike (a generated single-level launch: ~1M live rays);
//   * kLanes = 32, a warp per ray: the warp runs one ray's bounce loop.  Lane
//     q tests clusters q, q + 32, ... (and block unions the same way) and the
//     warp walks the passing set in ascending order, which is array order,
//     applying the occlusion gate with the running key before each visit, so
//     the sequence of gate decisions is the thread's.  A visit spreads the
//     cluster's rows over the lanes (rows q, q + 32, ...; each load across the
//     warp is 32 contiguous 32-byte rows) and takes the key minimum with
//     __reduce_min_sync.  Everything else (the bounce, the shading, the
//     counters) is warp-uniform and computed by every lane; lane 0 writes the
//     ray's outputs.  This puts 32x more lanes on the few rays that carry the
//     work (the deep tails of continuation phases, the 1M soup's K1e sweep),
//     and no lane pays for another ray's clusters.  Generated rays map one warp
//     to each ray; a continuation runs a grid sized to the card's resident
//     blocks whose warps take rays from a counter the wrapper allocates: a
//     warp takes a run of consecutive rays, copies the dead ones through one
//     lane each, traces the live ones one after another, and doubles its run
//     (up to 32) while it finds no live ray, so the dead suffix of a
//     compacted phase costs a lane per ray, not a warp.
// The counters count the ray's work on either route (rows tested, bounces,
// AABB rows), so both are bit-equal to the plain version in every output.
//
// What bounds it on this card: FP32 issue on the visit math.  Lane operations
// counted from this source (one per FADD, FMUL, FSETP, FMNMX, FSEL or integer
// AND/OR/MIN; a NaN test of two values is one FSETP.NAN), with FMA
// contraction off:
//   * a (ray, sphere) slot: 29 and one IEEE square root: the quadratic 17 (oc
//     3, b 5, c 6, disc 3), the far-root search 9 (-b - sq, -b + sq, two
//     window compares, disc > 0, an and, two selects, the lane loop's own
//     step) and the key 3 (mask, lane, min).  The near-root search (kFarRoot
//     = false) drops -b + sq, one compare and one select: 26 and the root;
//   * an AABB row, a block union's or a cluster's: 48.  The slab test 46:
//     the x axis 9 (t0 2, t1 2, NaN test 1, min and max 2, two selects 2), y
//     and z 15 each (9, then the running lo and hi 3 each), the end 7 (hi
//     against kBig 3, lo against 0 3, the compare 1); the loop's step 2;
//   * the occlusion gate, where the launch has it (`occl`): 3 (lo * a, the
//     key floor, the compare) for each cluster row that passes the slab test.
//     The bound charges it once a visit, slot tests / W of them, the least
//     it can be;
//   * every bounce: 19 plain, a square root and 4 divisions, what one that
//     ends on the sky costs.  Set-up 6 (a 5, epsa 1) and 1/dx, 1/dy, 1/dz;
//     the hit test 1; uy 1 with sqrtf(a) and 1/x; t 2; the sky's weights 6
//     (1 - t once, then t * k and the sum for red and green, and the sum
//     alone for blue, whose k is 1); the colour 3 (the light times each
//     weight);
//   * a bounce that hits: 72 plain, 2 square roots and 6 divisions in all,
//     53, 1 and 2 more than the sky's.  Set-up 6 and the three divisions;
//     the readback 3 (the hit test, the lane, the key floor); ray_math.cuh's
//     bounce 63 (the quadratic with r2 18, the guarded root 2, t0 2, t1 2,
//     the window 2, the near test 3, the select 1, p 6, n 6, u 3, u.n 5, the
//     reflection 7, the scatter test 6) with sqrtf(disc), 1/a, 1/rad and
//     1/sqrtf(a).  A mirror bounce adds the light's 3 products; an absorbed
//     one does not.  A ray ends on the sky at most once, so at most as many bounces
//     as rays end there: a render's bound charges the hit's extra to its
//     bounces less its rays, and K1d's, whose records tell the misses and
//     the mirror bounces apart, to exactly its hits.
// -prec-sqrt and -prec-div make a square root and a division sequences of a
// MUFU instruction, refinement and a slow-path branch: M1
// (csrc/microbench.cu) measures each at 8.78 and 8.71 multiply-equivalents
// (docs/MICROBENCH_H100.json, NVIDIA H100 80GB HBM3, 700.00 W), so a slot
// test is charged 37.78 lane operations (chip_smoke.py, SQRT_OPS, DIV_OPS).
// Its data is a few hundred KB (irreg's sphere table is 316 KB), resident in
// L2; the bytes it must move (ray state in and out) are far below the
// operations' time.  The cluster AABBs (at most 128 x 6 floats) sit in
// shared memory, so the single-level cull reads no global memory, and the
// winner's fields are read back with one indexed load after the sweep, not
// tracked through it.  What holds each route back on the main path is in
// PERF.md: the thread per ray loses to divergent lanes and to the long
// chains a handful of rays run alone; the warp per ray to the per-visit
// latency of its short loops where rays are many.
//
// Scene scale (K1e, layouts of CB > 1 cull blocks of CR clusters, C > 128;
// pallas_kernel.py:526-566, 796-838): a two-level cull.  A ray tests the
// CB block unions, held in shared memory (2.9 KB for a 1M-sphere soup's
// CB = 123); only for a block whose union it meets does it read that
// block's cluster AABBs, through the read-only cache, and visit the
// clusters that pass, in array order behind the occlusion gate.  The
// sphere tables stay in global memory (32 MB at 1M spheres, within the
// 50 MB L2), where the TPU streams them from HBM by DMA (:340-475).  The
// sweep is the same per-ray semantics as the TPU's unrolled (CB <= 4) and
// dynamic sweeps, with no tail peel (:789-791).
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
// x 2 instantiations (with the two routes) has a static visit trip count.
// The key keeps its 7 lane bits (lanes < W fit) and the record slot stays
// cluster*128 + lane, so K1d's records and K2 are width-agnostic.  The forced
// occlusion gate is the `occl` launch argument, which the wrapper sets.
// JAX's lane groups gate the rays of a tile in groups; this kernel gates each
// ray alone, the limit of that partition, so they change nothing here.
//
// Layouts: params (24,) f32; sphT (C,W,8) f32 rows cx cy cz rad cr cg cb r2;
// aabbT (CB,CR,8) rows (mnx mny mnz mxx mxy mxz pad pad), the first C used;
// superT (1,SBR,8) the block unions in the same rows, the first CB used; state
// (13,n) f32 rows ox oy oz dx dy dz lr lg lb rr rg rb active; packed (n,)
// int32; stats (3,n) int32 rows sphere rows tested, bounces, AABB slab rows;
// rec (D,n) int32; pay (D,8,n) f32 rows cx cy cz rad cr cg cb, written only
// where rec >= 0 (row 7 never); work (1,) int32, the warp-per-ray
// continuation's ray counter (zeroed here before the launch).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "ray_math.cuh"

namespace {

using rt::kBig;
using rt::kKeyMask;
using rt::kLane;
constexpr int kMaxClusters = 128;   // single-level: boxes in shared memory
constexpr int kMaxBlocks = 2048;    // two-level: block unions, 48 KB
constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// The launch's arguments, passed by value to the kernel.
struct Args {
  const float *params, *sphT, *aabbT, *superT;
  int n_clusters, n_blocks, cull_rows, tail_rows, cull, occl;
  const float* state_in;
  float* state_out;
  int *packed_out, *stats_out, *rec_out;
  float* pay_out;
  int rec_depth, n, tile, block_tiled;
  int* work;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, lr, lg, lb, rr, rg, rb, act;
};

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
                                     const Ray& r, float inv_dx, float inv_dy,
                                     float inv_dz, float& lo) {
  float t0 = (mnx - r.ox) * inv_dx, t1 = (mxx - r.ox) * inv_dx;
  lo = nan_min(t0, t1);
  float hi = nan_max(t0, t1);
  t0 = (mny - r.oy) * inv_dy;
  t1 = (mxy - r.oy) * inv_dy;
  lo = nan_max(lo, nan_min(t0, t1));
  hi = nan_min(hi, nan_max(t0, t1));
  t0 = (mnz - r.oz) * inv_dz;
  t1 = (mxz - r.oz) * inv_dz;
  lo = nan_max(lo, nan_min(t0, t1));
  hi = nan_min(hi, nan_max(t0, t1));
  return !(nan_min(hi, kBig) <= nan_max(lo, 0.0f));
}

// Ray g's state at entry: generated from the camera (K1a) or loaded (K1b).
__device__ __forceinline__ Ray load_ray(const Args& A, int g) {
  Ray r;
  const int n = A.n;
  if (A.state_in == nullptr) {
    rt::primary_ray(A.params, g, A.tile, A.block_tiled, r.dx, r.dy, r.dz);
    r.ox = A.params[9];
    r.oy = A.params[10];
    r.oz = A.params[11];
    r.lr = r.lg = r.lb = r.act = 1.0f;
    r.rr = r.rg = r.rb = 0.0f;
  } else {
    const float* s = A.state_in;
    r.ox = s[0 * n + g];  r.oy = s[1 * n + g];  r.oz = s[2 * n + g];
    r.dx = s[3 * n + g];  r.dy = s[4 * n + g];  r.dz = s[5 * n + g];
    r.lr = s[6 * n + g];  r.lg = s[7 * n + g];  r.lb = s[8 * n + g];
    r.rr = s[9 * n + g];  r.rg = s[10 * n + g]; r.rb = s[11 * n + g];
    r.act = s[12 * n + g];
  }
  return r;
}

// The bounce cap: a record's depth is the static depth of its segment (K1d).
__device__ __forceinline__ int max_depth(const Args& A) {
  return A.rec_out != nullptr ? A.rec_depth : (int)A.params[13];
}

// Ray g's outputs once its loop ends after `depth` steps: the records of the
// steps after its death, the state or packed pixel, the counters.
__device__ __forceinline__ void finish(const Args& A, int g, const Ray& r,
                                       int depth, int n_slots, int n_bounces,
                                       int n_cull) {
  const int n = A.n;
  if (A.rec_out != nullptr) {
    // the steps after the ray's death, up to the segment's depth: inactive
    for (; depth < A.rec_depth; ++depth) A.rec_out[(size_t)depth * n + g] = -2;
  }
  if (A.state_out != nullptr) {
    float* s = A.state_out;
    s[0 * n + g] = r.ox;  s[1 * n + g] = r.oy;  s[2 * n + g] = r.oz;
    s[3 * n + g] = r.dx;  s[4 * n + g] = r.dy;  s[5 * n + g] = r.dz;
    s[6 * n + g] = r.lr;  s[7 * n + g] = r.lg;  s[8 * n + g] = r.lb;
    s[9 * n + g] = r.rr;  s[10 * n + g] = r.rg; s[11 * n + g] = r.rb;
    s[12 * n + g] = r.act;
  }
  if (A.packed_out != nullptr) {
    // 255.99 quantization, truncation toward zero (ray.fut:156-162)
    A.packed_out[g] = ((int)(255.99f * r.rr) << 16)
                      | ((int)(255.99f * r.rg) << 8) | (int)(255.99f * r.rb);
  }
  if (A.stats_out != nullptr) {
    A.stats_out[0 * n + g] = n_slots;
    A.stats_out[1 * n + g] = n_bounces;
    A.stats_out[2 * n + g] = n_cull;
  }
}

// The packed-key closest hit over the first `rows` spheres of cluster c of
// a table of kW-row clusters; the winner moves only on a strictly smaller
// key.  kFarRoot: the far root is tried where the near one fails the window.
// kLanes = 32: lane q takes rows q, q + 32, ... and the warp takes the
// minimum; every lane ends with the same krun and wcl.
template <int kW, bool kFarRoot, int kLanes>
__device__ __forceinline__ void visit(const float* __restrict__ sphT, int c,
                                      int rows, const Ray& r, float a,
                                      float epsa, int& krun, int& wcl,
                                      int& n_slots) {
  const float* s = sphT + (size_t)c * kW * 8;
  int kmin = 0x7fffffff;
  for (int l = kLanes == 1 ? 0 : (int)(threadIdx.x % kWarp); l < rows;
       l += kLanes) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(s + 8 * l));
    const float r2 = __ldg(s + 8 * l + 7);
    const rt::Quad qd = rt::quad(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, a, q.x,
                                 q.y, q.z, r2);
    // sqrtf is NaN on a miss, which the search masks
    const float sq = sqrtf(qd.disc);
    const float tv = kFarRoot ? rt::search_m(qd, sq, epsa)
                              : rt::search_m_near(qd, sq, epsa);
    kmin = min(kmin, (__float_as_int(tv) & kKeyMask) | l);
  }
  if constexpr (kLanes > 1) kmin = __reduce_min_sync(kFull, kmin);
  n_slots += rows;
  if (kmin < krun) {
    krun = kmin;
    wcl = c;
  }
}

// The warp's walk over 32 consecutive candidate clusters c0 + j whose AABB
// test lane j made (`ok`, entry distance `lo`): the passing ones in
// ascending order, each behind the occlusion gate with the running key.
template <int kW, bool kFarRoot>
__device__ __forceinline__ void warp_visits(const Args& A, int c0, bool ok,
                                            float lo, const Ray& r, float a,
                                            float epsa, int& krun, int& wcl,
                                            int& n_slots) {
  const int C = A.n_clusters;
  for (unsigned pass = __ballot_sync(kFull, ok); pass; pass &= pass - 1) {
    const int j = __ffs(pass) - 1;
    const float loj = __shfl_sync(kFull, lo, j);
    // occlusion gate: the box starts behind the best hit so far
    if (A.occl && loj * a >= __int_as_float(krun & kKeyMask)) continue;
    const int c = c0 + j;
    visit<kW, kFarRoot, kWarp>(A.sphT, c, c == C - 1 ? A.tail_rows : kW, r, a,
                               epsa, krun, wcl, n_slots);
  }
}

// The culled packed-key sweep of one bounce (pallas_kernel.py:481-864).
// box: the single-level cluster AABBs, row k of face k; sup: the two-level
// block unions, face k of block b at sup[k * CB + b].
template <bool kTwoLevel, int kW, bool kFarRoot, int kLanes>
__device__ __forceinline__ void closest_hit(
    const Args& A, const float* box, const float* sup, const Ray& r, float a,
    float epsa, float inv_dx, float inv_dy, float inv_dz, int& krun,
    int& wcl, int& n_slots, int& n_cull) {
  const int C = A.n_clusters;
  const int CB = A.n_blocks;
  const int q = kLanes == 1 ? 0 : (int)(threadIdx.x % kWarp);
  krun = (__float_as_int(kBig) & kKeyMask) | (kLane - 1);
  wcl = 0;
  if constexpr (kTwoLevel) {
    // K1e (pallas_kernel.py:526-566, 796-838): the block unions first;
    // in each block whose union the ray meets, its clusters' AABBs, then
    // the visits in array order behind the occlusion gate
    for (int b0 = 0; b0 < CB; b0 += kLanes) {
      float lo = 0.0f;
      const int bq = b0 + q;
      const bool met = bq < CB &&
                       slab(sup[bq], sup[CB + bq], sup[2 * CB + bq],
                            sup[3 * CB + bq], sup[4 * CB + bq],
                            sup[5 * CB + bq], r, inv_dx, inv_dy, inv_dz, lo);
      unsigned enter = kLanes == 1 ? (unsigned)met : __ballot_sync(kFull, met);
      for (; enter; enter &= enter - 1) {
        const int c0 = (b0 + __ffs(enter) - 1) * A.cull_rows;
        const int nb = min(A.cull_rows, C - c0);
        n_cull += nb;
        const float4* bx =
            reinterpret_cast<const float4*>(A.aabbT) + 2 * c0;
        for (int j0 = 0; j0 < nb; j0 += kLanes) {
          const int j = j0 + q;
          bool ok = false;
          if (j < nb) {
            const float4 p = __ldg(bx + 2 * j);
            const float4 u = __ldg(bx + 2 * j + 1);
            ok = slab(p.x, p.y, p.z, p.w, u.x, u.y, r, inv_dx, inv_dy,
                      inv_dz, lo);
          }
          if constexpr (kLanes == 1) {
            // occlusion gate: the box starts behind the best hit so far
            if (!ok || (A.occl && lo * a >= __int_as_float(krun & kKeyMask)))
              continue;
            visit<kW, kFarRoot, 1>(A.sphT, c0 + j, kW, r, a, epsa, krun, wcl,
                                   n_slots);
          } else {
            // the scene-scale sweep visits whole clusters: no tail peel, and
            // the wrapper passes tail_rows = W
            warp_visits<kW, kFarRoot>(A, c0 + j0, ok, lo, r, a, epsa, krun,
                                      wcl, n_slots);
          }
        }
      }
    }
    n_cull += CB;
  } else if (A.cull) {
    for (int c0 = 0; c0 < C; c0 += kLanes) {
      const int c = c0 + q;
      float lo = 0.0f;
      const bool ok = c < C &&
                      slab(box[c], box[kMaxClusters + c],
                           box[2 * kMaxClusters + c], box[3 * kMaxClusters + c],
                           box[4 * kMaxClusters + c], box[5 * kMaxClusters + c],
                           r, inv_dx, inv_dy, inv_dz, lo);
      if constexpr (kLanes == 1) {
        // occlusion gate: the box starts behind the best hit so far
        if (!ok || (A.occl && lo * a >= __int_as_float(krun & kKeyMask)))
          continue;
        visit<kW, kFarRoot, 1>(A.sphT, c, (c == C - 1) ? A.tail_rows : kW, r,
                               a, epsa, krun, wcl, n_slots);
      } else {
        warp_visits<kW, kFarRoot>(A, c0, ok, lo, r, a, epsa, krun, wcl,
                                  n_slots);
      }
    }
    n_cull += C;
  } else {
    for (int c = 0; c < C; ++c)
      visit<kW, kFarRoot, kLanes>(A.sphT, c, (c == C - 1) ? A.tail_rows : kW,
                                  r, a, epsa, krun, wcl, n_slots);
  }
}

// Ray g's bounce loop from its entry state r, then its outputs.  kLanes =
// 32: the whole warp runs it for one ray, every value but the sweep's
// per-lane tests warp-uniform; lane 0 writes.
template <bool kTwoLevel, int kW, bool kFarRoot, int kLanes>
__device__ __forceinline__ void trace(const Args& A, const float* box,
                                      const float* sup, int g, Ray r) {
  const int n = A.n;
  const bool writer = kLanes == 1 || threadIdx.x % kWarp == 0;
  const int cap = max_depth(A);
  int n_slots = 0, n_bounces = 0, n_cull = 0;
  int depth = 0;
  for (; depth < cap && r.act > 0.0f; ++depth) {
    const float a = (r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz;
    const float epsa = rt::kEps * a;
    const float inv_dx = 1.0f / r.dx, inv_dy = 1.0f / r.dy,
                inv_dz = 1.0f / r.dz;
    int krun, wcl;
    closest_hit<kTwoLevel, kW, kFarRoot, kLanes>(
        A, box, sup, r, a, epsa, inv_dx, inv_dy, inv_dz, krun, wcl, n_slots,
        n_cull);
    ++n_bounces;
    // shading (pallas_kernel.py:866-983)
    if (krun >= (__float_as_int(kBig) & kKeyMask)) {     // miss: sky
      const float uy = r.dy * (1.0f / sqrtf(a));
      const float t = 0.5f * (uy + 1.0f);
      r.rr = r.lr * rt::sky(t, rt::kSkyR);
      r.rg = r.lg * rt::sky(t, rt::kSkyG);
      r.rb = r.lb * rt::sky(t, rt::kSkyB);
      r.act = 0.0f;
      if (writer && A.rec_out != nullptr)
        A.rec_out[(size_t)depth * n + g] = -1;
      continue;
    }
    const int lane = krun & (kLane - 1);                 // < kW on a hit
    const float* w = A.sphT + ((size_t)wcl * kW + lane) * 8;
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(w));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(w + 4));
    const rt::Bounce h = rt::bounce(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, a,
                                    s0.x, s0.y, s0.z, s0.w,
                                    __int_as_float(krun & kKeyMask));
    if (h.scatter) {                                     // mirror bounce
      if (writer && A.rec_out != nullptr) {
        // K1d: the winner's slot (cluster*128 + lane at any width), and
        // with pay its 7 fields
        A.rec_out[(size_t)depth * n + g] = wcl * kLane + lane;
        if (A.pay_out != nullptr) {
          float* pw = A.pay_out + (size_t)depth * 8 * n + g;
          pw[0 * (size_t)n] = s0.x; pw[1 * (size_t)n] = s0.y;
          pw[2 * (size_t)n] = s0.z; pw[3 * (size_t)n] = s0.w;
          pw[4 * (size_t)n] = s1.x; pw[5 * (size_t)n] = s1.y;
          pw[6 * (size_t)n] = s1.z;
        }
      }
      r.lr = r.lr * s1.x;
      r.lg = r.lg * s1.y;
      r.lb = r.lb * s1.z;
      r.ox = h.px; r.oy = h.py; r.oz = h.pz;
      r.dx = h.rx; r.dy = h.ry; r.dz = h.rz;
      r.act = 1.0f;
    } else {                                             // absorbed: black
      if (writer && A.rec_out != nullptr)
        A.rec_out[(size_t)depth * n + g] = -3;
      r.act = 0.0f;
    }
  }
  if (writer) finish(A, g, r, depth, n_slots, n_bounces, n_cull);
}

// kTwoLevel: the scene-scale sweep (K1e).  Otherwise one cull block of at
// most 128 clusters, or no culling.  kW: sphere rows per cluster; kFarRoot:
// the far-root fallback of the search (K1f); kLanes: lanes per ray.
template <bool kTwoLevel, int kW, bool kFarRoot, int kLanes>
__global__ void __launch_bounds__(kThreads) megakernel(const Args A) {
  // single-level: the cluster AABBs; two-level: the block unions (the
  // blocks' cluster AABBs are read from global memory, through the
  // read-only cache, only for entered blocks)
  __shared__ float box[kTwoLevel ? 1 : 6 * kMaxClusters];
  extern __shared__ float sup[];
  const int C = A.n_clusters;
  const int CB = A.n_blocks;
  if constexpr (kTwoLevel) {
    for (int k = threadIdx.x; k < 6 * CB; k += blockDim.x)
      sup[(k % 6) * CB + k / 6] = A.superT[(k / 6) * 8 + k % 6];
  } else if (A.cull) {
    for (int k = threadIdx.x; k < 6 * C; k += blockDim.x)
      box[(k % 6) * kMaxClusters + k / 6] = A.aabbT[(k / 6) * 8 + k % 6];
  }
  __syncthreads();
  const int n = A.n;

  if constexpr (kLanes == 1) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g < n) trace<kTwoLevel, kW, kFarRoot, 1>(A, box, sup, g, load_ray(A, g));
  } else if (A.state_in == nullptr) {
    // generated rays are all live: one warp each
    const int g = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
    if (g < n) trace<kTwoLevel, kW, kFarRoot, kWarp>(A, box, sup, g,
                                                      load_ray(A, g));
  } else {
    // a continuation: runs of consecutive rays from the counter; the dead
    // ones are copied through by a lane each, the live ones traced by the
    // warp in turn; the run doubles (to 32) while it holds no live ray
    const int q = threadIdx.x % kWarp;
    const int cap = max_depth(A);
    for (int run = 1;;) {
      int g0 = q == 0 ? atomicAdd(A.work, run) : 0;
      g0 = __shfl_sync(kFull, g0, 0);
      if (g0 >= n) break;
      const int g = g0 + q;
      bool live = false;
      if (q < min(run, n - g0)) {
        const Ray r = load_ray(A, g);
        live = r.act > 0.0f && cap > 0;
        if (!live) finish(A, g, r, 0, 0, 0, 0);
      }
      const unsigned todo = __ballot_sync(kFull, live);
      run = todo ? 1 : min(2 * run, kWarp);
      for (unsigned t = todo; t; t &= t - 1) {
        const int gl = g0 + __ffs(t) - 1;
        trace<kTwoLevel, kW, kFarRoot, kWarp>(A, box, sup, gl,
                                              load_ray(A, gl));
      }
    }
  }
}

// The blocks of `kernel` the card holds at once with `smem` bytes of dynamic
// shared memory, worked out at an instantiation's first launch with that
// size and kept, (smem << 32) | blocks, for the launches after it.  Any grid
// computes the same result (the warps take rays from a counter); this one
// keeps the dead suffix of a continuation from queueing blocks.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem,
                    std::atomic<unsigned long long>& memo, int& blocks) {
  const unsigned long long m = memo.load(std::memory_order_relaxed);
  if (m != 0 && (m >> 32) == smem) {
    blocks = (int)(m & 0xffffffffu);
    return 0;
  }
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  blocks = std::max(per_sm, 1) * sms;
  memo.store(((unsigned long long)smem << 32) | (unsigned)blocks,
             std::memory_order_relaxed);
  return 0;
}

template <bool kTwoLevel, int kW, bool kFarRoot, int kLanes>
int launch(const Args& a, size_t smem, cudaStream_t s) {
  auto* kernel = megakernel<kTwoLevel, kW, kFarRoot, kLanes>;
  long long blocks = ((long long)a.n * kLanes + kThreads - 1) / kThreads;
  if (kLanes > 1 && a.state_in != nullptr) {
    // a continuation: as many blocks as the card holds at once, each warp
    // taking rays from the counter
    static std::atomic<unsigned long long> memo{0};
    int resident;
    int e = resident_blocks(kernel, smem, memo, resident);
    if (e == 0) e = (int)cudaMemsetAsync(a.work, 0, sizeof(int), s);
    if (e != 0) return e;
    blocks = std::min<long long>(blocks, resident);
  }
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int kW, int kLanes>
int launch_width(const Args& a, int two_level, int far_root,
                 cudaStream_t s) {
  if (a.tail_rows < 1 || a.tail_rows > kW) return (int)cudaErrorInvalidValue;
  if (two_level) {
    // the scene-scale sweep visits whole clusters: no tail peel
    if (!a.cull || a.n_blocks < 2 || a.n_blocks > kMaxBlocks ||
        a.tail_rows != kW)
      return (int)cudaErrorInvalidValue;
    const size_t smem = 6 * a.n_blocks * sizeof(float);
    return far_root ? launch<true, kW, true, kLanes>(a, smem, s)
                    : launch<true, kW, false, kLanes>(a, smem, s);
  }
  if (a.cull && a.n_clusters > kMaxClusters) return (int)cudaErrorInvalidValue;
  return far_root ? launch<false, kW, true, kLanes>(a, 0, s)
                  : launch<false, kW, false, kLanes>(a, 0, s);
}

template <int kLanes>
int launch_lanes(const Args& a, int two_level, int cluster_width,
                 int far_root, cudaStream_t s) {
  switch (cluster_width) {
    case 32:
      return launch_width<32, kLanes>(a, two_level, far_root, s);
    case 64:
      return launch_width<64, kLanes>(a, two_level, far_root, s);
    case kLane:
      return launch_width<kLane, kLanes>(a, two_level, far_root, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rt_megakernel_launch(
    const float* params, const float* sphT, const float* aabbT,
    const float* superT, int n_clusters, int n_blocks, int cull_rows,
    int tail_rows, int cull, int occl, int two_level, int cluster_width,
    int far_root, int lanes, const float* state_in, float* state_out,
    int* packed_out, int* stats_out, int* rec_out, float* pay_out,
    int* work, int rec_depth, int n, int tile, int block_tiled,
    void* stream) {
  if (n_clusters < 1 || n <= 0 || (rec_out != nullptr && rec_depth < 0) ||
      n_blocks < 1 || cull_rows < 1 ||
      (long long)n_blocks * cull_rows < n_clusters ||
      (lanes == kWarp && state_in != nullptr && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{params,    sphT,      aabbT,      superT,    n_clusters,
               n_blocks,  cull_rows, tail_rows,  cull,      occl,
               state_in,  state_out, packed_out, stats_out, rec_out,
               pay_out,   rec_depth, n,          tile,      block_tiled,
               work};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1:
      return launch_lanes<1>(a, two_level, cluster_width, far_root, s);
    case kWarp:
      return launch_lanes<kWarp>(a, two_level, cluster_width, far_root, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
