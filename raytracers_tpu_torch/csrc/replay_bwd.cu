// K2, the backward replay of the differentiable renderer, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// raytracers_tpu/grad/pallas_replay_bwd.py:_replay_bwd_kernel.  The forward
// megakernel in record mode (K1d) leaves, per step and ray, the winner's
// slot (or -1 miss, -2 inactive, -3 absorbed) and the winner's 7 fields.
// This kernel differentiates the path each ray took, with the discrete
// choices (which sphere, which root, scatter or not) held fixed:
//   pass 1 replays o, d and light per step from the records into a global
//          scratch (D, 9, n), stopping at the ray's own path length;
//   pass 2 walks those steps deepest first, carrying the cotangents of
//          (o, d, light): a miss seeds them from the image cotangent through
//          the sky gradient, a bounce hand-reverses the shading chain
//          (quadratic -> hit point -> normal -> reflection -> attenuation,
//          futhark/ray.fut:76-117), an absorbed hit zeroes them.
// Pass 1 recomputes each bounce with K1's own arithmetic (ray_math.cuh):
// the key floor of the recomputed search value gives the same widened
// window, so the replay is the path the forward took, bit for bit (the
// argument of pallas_replay_bwd.py:26-37).  The cotangent arithmetic is the
// TPU kernel's, expression for expression, without contraction.
//
// One thread owns one ray, a warp 32 consecutive rays.  Each bounce's
// sphere cotangents (d/d cx cy cz rad cr cg cb) are either written per step
// (D, 8, n) or summed into a slot table (S, 7), S = clusters * W.  The TPU
// kernel sums each tile's bounces into its table in VMEM by exact bf16
// one-hot dots on its matrix unit (pallas_replay_bwd.py:241-246,377-428):
// no bounce's cotangent reaches HBM.  Here the warp aggregates before the
// table.  Pass 2 runs each warp for its longest path's steps with every
// lane at the same step k, deepest first (a lane whose path is shorter
// waits), so neighbouring rays at one depth, which mostly hit one sphere,
// meet in one iteration.  There the lanes of one slot find each other by
// __match_any_sync, sum their 7 cotangents in registers down a shuffle tree
// fixed by the lanes (table_add), and the group's lowest lane adds the sums
// with 7 float32 atomics: one row-add.  No lane leaves early: a ray past n
// or dead at a continuation's start has a path of length 0 and joins every
// collective.  Blocks run in no order, so the order of the row-adds, and
// the table's last bits, change from run to run: the table is held to a
// tolerance, every per-ray output and the per-step cotangents to bit
// equality with the plain version (grad/replay_bwd.py).  The optional
// counters count the row-adds and warp iterations, which
// grad/replay_bwd_model.py:warp_groups gives from the records.
//
// SASS of the aggregation (cuobjdump; the kernel holds 1 MATCH, 84 SHFL
// and 9 REDG, 7 of them the table's): one MATCH an iteration with a
// bounce; 7 SHFL a round of the tree (ceil(log2) of the largest group, 5
// for a whole warp, whose tree is unrolled); 7 REDG (float32 atomic adds)
// a row-add.  Per bounce on the fwd+bwd step at 1000x1000, depth 50
// (probes/k2_table.py, docs/K2_TABLE_H100.json), segment 0: rgbbox 0.045
// MATCH, 1.09 SHFL, 1.88 REDG (3.73 bounces a row-add, against 7 REDG
// before), irreg 0.042, 1.18, 0.57 (12.39).
//
// What bounds it on this card: its bytes at the roofline, its atomics in
// practice.  Per replayed step a ray reads its record (4 B) and the
// winner's fields (28 B) twice and writes and reads 36 B of scratch.  A
// replayed bounce costs 351 plain float32 lane operations, 6 IEEE square
// roots and 7 divisions: pass 1 104, 3 and 3 (the search's sqrtf(disc); the
// re-intersection's root, 1/a, 1/rad, sqrtf(a) and 1/sqrtf(a)), pass 2 the
// same replay and the reversal, 247, 3 and 4 (0.5f / sq); a step that ends
// the path on the sky 61, 2, 2 (1/sqrtf(a) in each pass).  M1
// (csrc/microbench.cu) measures a root and a division at 8.84 and 8.77
// multiply-equivalents (docs/MICROBENCH_H100.json, NVIDIA H100 80GB HBM3,
// 700.00 W); at those weights the operations' time stays below the bytes'
// at the card's peak rates.  The same kernel with no table writes runs
// segment 0 in 0.161 ms (rgbbox, 2.1M bounces onto 512 slots) and 0.087
// (irreg, 0.73M onto 10,112), the whole step in 0.468 and 0.246; the warp
// design in 0.355 / 0.131 and 0.938 / 0.328, and per-lane atomics in 1.745
// / 1.452 and 2.473 / 1.707 (docs/K2_TABLE_H100.json, NVIDIA H100 80GB
// HBM3, 700.00 W).  What is left above the floor is rgbbox's row-adds
// meeting on 512 slots across warps (1.2 bounces a row-add after segment
// 0), and the deep segments' serial chain of a few long paths.
//
// Layouts (n rays): params (24,) f32 as K1's; rec (D,n) i32; pay (D,8,n)
// f32, read only where rec >= 0; gcot (12,n) f32: rows 0-2 the image
// cotangent, rows 3-11 the incoming carry (cotangents of o, d, light at the
// end of this segment; zero for a whole path); state_in (9,n) f32 o, d,
// light at the segment's start, or null for primary rays; scratch
// (D,9,n) f32; cot_step (D,8,n) f32 pre-zeroed, or null; table (S,7) f32
// pre-zeroed, or null; cotray (6,n) cotangents of each primary ray's o and
// d, or with state_in (9,n) the carry at the segment's start; fwd (3,n)
// the replayed colours, or null; counters (2,) u64 the row-adds and warp
// iterations, added to, or null.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Fields {
  float cx, cy, cz, rad, cr, cg, cb;
};

__device__ __forceinline__ Fields load_fields(const float* __restrict__ pay,
                                              int k, size_t n, int g) {
  const float* p = pay + (size_t)k * 8 * n + g;
  return Fields{p[0], p[n], p[2 * n], p[3 * n], p[4 * n], p[5 * n], p[6 * n]};
}

// The bounce K1 took at this step, recomputed from the winner's fields: the
// search value's key floor sets the re-intersection window.
__device__ __forceinline__ rt::Bounce replay_bounce(float ox, float oy,
                                                    float oz, float dx,
                                                    float dy, float dz,
                                                    float a, const Fields& f) {
  const rt::Quad q = rt::quad(ox, oy, oz, dx, dy, dz, a, f.cx, f.cy, f.cz,
                              f.rad * f.rad);
  const float sq = sqrtf(q.disc > 0.0f ? q.disc : 1.0f);
  const float best_m = rt::key_floor(rt::search_m(q, sq, rt::kEps * a));
  return rt::bounce(ox, oy, oz, dx, dy, dz, a, f.cx, f.cy, f.cz, f.rad,
                    best_m);
}

// The slot table's accumulation.  Every lane of the warp calls it once a
// pass-2 iteration (the collectives need all 32), with e its bounce's slot,
// or a negative value where it replayed no bounce in this iteration.  The
// lanes of one slot meet by __match_any_sync; each group's 7 cotangents
// are summed in registers down a tree fixed by the lanes (Westphal's
// reduce_peers: round r adds to each remaining peer the peer 2^r above it
// in the group, then retires the odd ones), and the group's lowest lane
// adds the sums into its slot's row with 7 float32 atomics.  A whole warp
// on one slot takes the same tree by __shfl_down_sync.  Returns the
// row-adds this lane issued (0 or 1).
__device__ __forceinline__ int table_add(float* __restrict__ table, int e,
                                         float (&cot)[7], unsigned lane) {
  if (__ballot_sync(kFull, e >= 0) == 0u) return 0;    // no bounce here
  const int key = e >= 0 ? e : ~(int)lane;     // no bounce: a group of one
  const unsigned peers = __match_any_sync(kFull, key);
  if (peers == kFull) {                        // uniform: one group
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
      for (int r = 0; r < 7; ++r)
        cot[r] = cot[r] + __shfl_down_sync(kFull, cot[r], s);
    }
  } else {
    unsigned above = peers & (0xfffffffeu << lane);   // peers above this lane
    unsigned rel = __popc(peers & ((1u << lane) - 1u));  // place in the group
    while (__any_sync(kFull, above != 0u)) {
      const int next = __ffs(above);           // the next remaining peer, 1-based
      float t[7];
#pragma unroll
      for (int r = 0; r < 7; ++r)
        t[r] = __shfl_sync(kFull, cot[r], next > 0 ? next - 1 : (int)lane);
      if (next > 0) {
#pragma unroll
        for (int r = 0; r < 7; ++r) cot[r] = cot[r] + t[r];
      }
      above &= ~__ballot_sync(kFull, rel & 1u);  // the odd places are done
      rel >>= 1;
    }
  }
  if (e < 0 || (int)lane != __ffs(peers) - 1) return 0;
  float* row = table + (size_t)e * 7;
#pragma unroll
  for (int r = 0; r < 7; ++r) atomicAdd(row + r, cot[r]);
  return 1;
}

__global__ void __launch_bounds__(kThreads)
replay_bwd(const float* __restrict__ params, const int* __restrict__ rec,
           const float* __restrict__ pay, const float* __restrict__ gcot,
           const float* __restrict__ state_in, float* __restrict__ scratch,
           float* __restrict__ cot_step, float* __restrict__ table,
           float* __restrict__ cotray, float* __restrict__ fwd,
           unsigned long long* __restrict__ counters, int D, int n_,
           int tile, int block_tiled) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const size_t n = n_;

  // Every lane stays to the end, for the table's collectives.  A lane past
  // n, or a ray inactive at a continuation's start (it stays so), has no
  // path (L = 0): it writes its zeros and nothing else.
  bool live = g < n_;
  if (live && state_in != nullptr && rec[g] == -2) {
    for (int r = 0; r < 9; ++r) cotray[r * n + g] = 0.0f;
    if (fwd != nullptr)
      for (int r = 0; r < 3; ++r) fwd[r * n + g] = 0.0f;
    live = false;
  }

  // ---- pass 1: replay the path, keeping o, d, light of every step ----
  int L = 0;                                   // the ray's recorded steps
  if (live) {
    float ox, oy, oz, dx, dy, dz, lr, lg, lb;
    if (state_in == nullptr) {
      rt::primary_ray(params, g, tile, block_tiled, dx, dy, dz);
      ox = params[9];
      oy = params[10];
      oz = params[11];
      lr = lg = lb = 1.0f;
    } else {
      ox = state_in[0 * n + g]; oy = state_in[1 * n + g];
      oz = state_in[2 * n + g]; dx = state_in[3 * n + g];
      dy = state_in[4 * n + g]; dz = state_in[5 * n + g];
      lr = state_in[6 * n + g]; lg = state_in[7 * n + g];
      lb = state_in[8 * n + g];
    }
    float rr = 0.0f, rg = 0.0f, rb = 0.0f;
    for (; L < D; ++L) {
      const int e = rec[(size_t)L * n + g];
      if (e == -2) break;
      float* s = scratch + (size_t)L * 9 * n + g;
      s[0 * n] = ox; s[1 * n] = oy; s[2 * n] = oz;
      s[3 * n] = dx; s[4 * n] = dy; s[5 * n] = dz;
      s[6 * n] = lr; s[7 * n] = lg; s[8 * n] = lb;
      const float a = (dx * dx + dy * dy) + dz * dz;
      if (e < 0) {                             // the path ends here
        if (e == -1) {                         // miss: the sky
          const float t = 0.5f * (dy * (1.0f / sqrtf(a)) + 1.0f);
          rr = lr * rt::sky(t, rt::kSkyR);
          rg = lg * rt::sky(t, rt::kSkyG);
          rb = lb * rt::sky(t, rt::kSkyB);
        }
        ++L;
        break;
      }
      const Fields f = load_fields(pay, L, n, g);
      const rt::Bounce h = replay_bounce(ox, oy, oz, dx, dy, dz, a, f);
      ox = h.px; oy = h.py; oz = h.pz;
      dx = h.rx; dy = h.ry; dz = h.rz;
      lr = lr * f.cr; lg = lg * f.cg; lb = lb * f.cb;
    }
    if (fwd != nullptr) {
      fwd[0 * n + g] = rr;
      fwd[1 * n + g] = rg;
      fwd[2 * n + g] = rb;
    }
  }

  // ---- pass 2: the cotangent sweep, deepest step first ----
  float gr = 0.0f, gg = 0.0f, gb = 0.0f;
  float cox = 0.0f, coy = 0.0f, coz = 0.0f, cdx = 0.0f, cdy = 0.0f,
        cdz = 0.0f, clr = 0.0f, clg = 0.0f, clb = 0.0f;
  if (live) {
    gr = gcot[0 * n + g]; gg = gcot[1 * n + g]; gb = gcot[2 * n + g];
    cox = gcot[3 * n + g]; coy = gcot[4 * n + g]; coz = gcot[5 * n + g];
    cdx = gcot[6 * n + g]; cdy = gcot[7 * n + g]; cdz = gcot[8 * n + g];
    clr = gcot[9 * n + g]; clg = gcot[10 * n + g]; clb = gcot[11 * n + g];
  }
  // The warp runs as long as its longest path, every lane at the same
  // step k: neighbouring rays at one depth mostly hit one sphere, and meet
  // in the table's groups.  A lane whose path is shorter waits until k
  // reaches its own last step.
  const int Lw = __reduce_max_sync(kFull, L);
  int row_adds = 0;
  for (int i = 0; i < Lw; ++i) {
    const int k = Lw - 1 - i;
    const bool active = k < L;
    int slot = -1;                             // the bounce's, if any
    float cot[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (active) {
      const int e = rec[(size_t)k * n + g];
      const float* s = scratch + (size_t)k * 9 * n + g;
      const float ox = s[0 * n], oy = s[1 * n], oz = s[2 * n];
      const float dx = s[3 * n], dy = s[4 * n], dz = s[5 * n];
      const float lr = s[6 * n], lg = s[7 * n], lb = s[8 * n];
      const float a = (dx * dx + dy * dy) + dz * dz;
      if (e == -3) {                           // absorbed: black
        cox = coy = coz = cdx = cdy = cdz = clr = clg = clb = 0.0f;
      } else if (e == -1) {                    // miss: seed from the sky
        const float inv_len = 1.0f / sqrtf(a);
        const float ux = dx * inv_len, uy = dy * inv_len, uz = dz * inv_len;
        const float t = 0.5f * (uy + 1.0f);
        clr = rt::sky(t, rt::kSkyR) * gr;
        clg = rt::sky(t, rt::kSkyG) * gg;
        clb = rt::sky(t, rt::kSkyB) * gb;
        const float cot_t = ((lr * gr) * rt::kSkyRm1 + (lg * gg) * rt::kSkyGm1)
                            + (lb * gb) * rt::kSkyBm1;
        const float cuy = 0.5f * cot_t;
        const float udotcu = uy * cuy;
        cox = coy = coz = 0.0f;
        cdx = ((-ux) * udotcu) * inv_len;
        cdy = (cuy - uy * udotcu) * inv_len;
        cdz = ((-uz) * udotcu) * inv_len;
      } else {
        // a mirror bounce (pallas_replay_bwd.py:277-358)
        const Fields f = load_fields(pay, k, n, g);
        const rt::Bounce h = replay_bounce(ox, oy, oz, dx, dy, dz, a, f);
        const float inv_len = h.inv_dn;
        // light' = light * colour
        const float ccolr = lr * clr, ccolg = lg * clg, ccolb = lb * clb;
        const float nlr = f.cr * clr, nlg = f.cg * clg, nlb = f.cb * clb;
        // d' = u - 2 (u.n) n ; o' = p
        const float ndotcr = (h.nx * cdx + h.ny * cdy) + h.nz * cdz;
        const float cux = cdx - (2.0f * h.nx) * ndotcr;
        const float cuy = cdy - (2.0f * h.ny) * ndotcr;
        const float cuz = cdz - (2.0f * h.nz) * ndotcr;
        const float cnx = -2.0f * (h.ux * ndotcr + h.udn * cdx);
        const float cny = -2.0f * (h.uy * ndotcr + h.udn * cdy);
        const float cnz = -2.0f * (h.uz * ndotcr + h.udn * cdz);
        // n = (p - c) / r
        const float cpx = cox + cnx * h.inv_r;
        const float cpy = coy + cny * h.inv_r;
        const float cpz = coz + cnz * h.inv_r;
        float ccx = (-cnx) * h.inv_r, ccy = (-cny) * h.inv_r,
              ccz = (-cnz) * h.inv_r;
        float crad = (-((h.nx * cnx + h.ny * cny) + h.nz * cnz)) * h.inv_r;
        // u = d / |d|
        const float udotcu = (h.ux * cux + h.uy * cuy) + h.uz * cuz;
        float ndx = (cux - h.ux * udotcu) * inv_len;
        float ndy = (cuy - h.uy * udotcu) * inv_len;
        float ndz = (cuz - h.uz * udotcu) * inv_len;
        // p = o + t2 d
        ndx = ndx + h.t2 * cpx;
        ndy = ndy + h.t2 * cpy;
        ndz = ndz + h.t2 * cpz;
        const float ct2 = (dx * cpx + dy * cpy) + dz * cpz;
        // t2 = (-b + s sq) / a, s = -1 for the near root, +1 for the far one
        const float sgn = h.near ? -1.0f : 1.0f;
        float cb2 = (-h.inv_a) * ct2;
        const float csq = (sgn * h.inv_a) * ct2;
        float ca = ((-h.t2) * h.inv_a) * ct2;
        const float cdisc = csq * (0.5f / h.sq);
        cb2 = cb2 + (2.0f * h.q.b) * cdisc;
        ca = ca - h.q.c * cdisc;
        const float cc2 = (-a) * cdisc;
        // b = oc.d ; c = oc.oc - r^2 ; a = d.d ; oc = o - c
        const float cocx = cb2 * dx + (2.0f * cc2) * h.q.ocx;
        const float cocy = cb2 * dy + (2.0f * cc2) * h.q.ocy;
        const float cocz = cb2 * dz + (2.0f * cc2) * h.q.ocz;
        ndx = (ndx + cb2 * h.q.ocx) + (2.0f * ca) * dx;
        ndy = (ndy + cb2 * h.q.ocy) + (2.0f * ca) * dy;
        ndz = (ndz + cb2 * h.q.ocz) + (2.0f * ca) * dz;
        crad = crad - (2.0f * f.rad) * cc2;
        ccx = ccx - cocx;
        ccy = ccy - cocy;
        ccz = ccz - cocz;

        cot[0] = ccx; cot[1] = ccy; cot[2] = ccz; cot[3] = crad;
        cot[4] = ccolr; cot[5] = ccolg; cot[6] = ccolb;
        if (cot_step != nullptr) {
          float* c = cot_step + (size_t)k * 8 * n + g;
#pragma unroll
          for (int r = 0; r < 7; ++r) c[r * n] = cot[r];
        }
        slot = e;
        cox = cpx + cocx; coy = cpy + cocy; coz = cpz + cocz;
        cdx = ndx; cdy = ndy; cdz = ndz;
        clr = nlr; clg = nlg; clb = nlb;
      }
    }
    if (table != nullptr) row_adds += table_add(table, slot, cot, lane);
  }

  if (live) {
    cotray[0 * n + g] = cox; cotray[1 * n + g] = coy;
    cotray[2 * n + g] = coz; cotray[3 * n + g] = cdx;
    cotray[4 * n + g] = cdy; cotray[5 * n + g] = cdz;
    if (state_in != nullptr) {
      cotray[6 * n + g] = clr;
      cotray[7 * n + g] = clg;
      cotray[8 * n + g] = clb;
    }
  }
  if (counters != nullptr) {                   // row-adds, warp iterations
    const unsigned adds = __reduce_add_sync(kFull, (unsigned)row_adds);
    if (lane == 0) {
      atomicAdd(counters, (unsigned long long)adds);
      atomicAdd(counters + 1, (unsigned long long)Lw);
    }
  }
}

}  // namespace

extern "C" int rt_replay_bwd_launch(
    const float* params, const int* rec, const float* pay, const float* gcot,
    const float* state_in, float* scratch, float* cot_step, float* table,
    float* cotray, float* fwd, unsigned long long* counters, int depth, int n,
    int tile, int block_tiled, void* stream) {
  if (n <= 0 || depth < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  replay_bwd<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, rec, pay, gcot, state_in, scratch, cot_step, table, cotray, fwd,
      counters, depth, n, tile, block_tiled);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
