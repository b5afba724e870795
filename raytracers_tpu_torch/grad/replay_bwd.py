"""K2, the backward replay: wrapper of ``csrc/replay_bwd.cu`` and its plain
version.

Counterpart of ``raytracers_tpu.grad.pallas_replay_bwd``
(``replay_bwd_pallas`` and its kernel ``_replay_bwd_kernel``).  From the
records of K1d (``render/megakernel.py``, record mode) it replays each ray's
path and hand-reverses the shading chain, giving the cotangents of every
bounce's sphere and of each ray's start.  The discrete path (which sphere,
which root, scatter or not) is held fixed, so this is the exact gradient
away from visibility discontinuities.

The replay recomputes every bounce with K1's arithmetic (``ray_math``, the
mirror of ``csrc/ray_math.cuh``): the key floor of the recomputed search
value sets the re-intersection window, so the replayed path is the one the
forward took, bit for bit (``emit_fwd`` shows it).

Layouts, for n rays in the forward's ray order:

* ``rec`` (D, n) int32 and ``pay`` (D, 8, n) float32 as K1d writes them;
  ``pay`` is read only where ``rec >= 0``;
* ``gcot`` (12, n) float32: rows 0-2 the image cotangent of each ray,
  rows 3-11 the incoming carry, the cotangents of (o, d, light) at the end
  of this segment (zero for a whole path);
* ``state_rows`` (9, n) float32: (o, d, light) at the segment's start, for
  a continuation segment; without it the rays are the primary rays of
  ``params`` (scanline or ``block_tiled``, as K1 generates them).

Results: ``(cot, cotray, fwd)``.  ``cot`` is per step (D, 8, n), rows
d/d(cx cy cz rad cr cg cb) at each bounce and zero elsewhere, or with
``reduce_slots=S`` the slot table (S, 7): each slot's cotangents summed
over every bounce that hit it.  ``cotray`` is (6, n), the cotangents of
each primary ray's origin and direction, or for a continuation (9, n), the
carry at the segment's start (zero for a ray inactive there).  ``fwd`` is
the replayed colours (3, n) with ``emit_fwd``, else None.  With
``counters=True`` (the kernel only) a fourth result, int64 (2,) on the
card: the launch's ``COUNTERS``.
"""
from __future__ import annotations

import ctypes

import torch

from ..render.megakernel import _gen_rays, _ptr
from ..render.ray_math import (EPS, SKY_K, bounce, key_floor, quad, search_m,
                               sky)
from ..utils.trace import counters as _counters, stats_on
from ..vec import sqrt

N_GCOT = 12        # image cotangent (3) + incoming carry (9)
N_CARRY = 9        # cotangents of o, d, light
# the kernel's counters of a launch: atomic row-adds into the slot table
# (one a group of lanes on one slot, 7 float32 atomics each) and pass-2
# iterations summed over warps (each runs its longest path's steps);
# grad/replay_bwd_model.py:warp_groups gives both from the records
COUNTERS = ("row_adds", "warp_iterations")


def _check(params, rec, pay, gcot, state_rows, reduce_slots):
    dev = rec.device
    if rec.dim() != 2 or rec.dtype != torch.int32 or rec.shape[0] < 1:
        raise ValueError("rec must be (D, n) int32 with D >= 1")
    D, n = rec.shape
    want = (("params", params, (24,), torch.float32),
            ("pay", pay, (D, 8, n), torch.float32),
            ("gcot", gcot, (N_GCOT, n), torch.float32),
            ("state_rows", state_rows, (N_CARRY, n), torch.float32))
    for name, t, shape, dtype in want:
        if t is None:
            continue
        if t.shape != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name} must be {shape} {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not rec.is_contiguous():
        raise ValueError("rec must be contiguous")
    if reduce_slots is not None and reduce_slots < 1:
        raise ValueError("reduce_slots must be positive")


def replay_bwd(params, rec, pay, gcot, *, tile: int,
               block_tiled: bool = False, state_rows=None,
               emit_fwd: bool = False, reduce_slots: int | None = None,
               counters: bool = False):
    """K2 over the rays of one segment (see the module's docstring for the
    arguments and results).

    A CPU tensor takes ``replay_bwd_reference``; a CUDA tensor launches the
    CUDA kernel on the current stream, without synchronising, and under
    ``utils.trace.counting()`` counts the launch in ``k2.launches`` and, with
    ``stats``, its ``COUNTERS`` in ``k2.row_adds`` and
    ``k2.warp_iterations``.  The kernel sums each warp's bounces on one
    slot in registers and adds each sum into the slot table with float32
    atomics, so the table's last bits change from run to run; every other
    output is bit-equal to the plain version's.  ``counters=True`` also returns the launch's ``COUNTERS``;
    the plain version has none, so it raises on the CPU."""
    _check(params, rec, pay, gcot, state_rows, reduce_slots)
    if counters and rec.device.type != "cuda":
        raise ValueError("counters count the kernel's row-adds and warp "
                         "iterations; the plain version has none")
    if rec.device.type == "cpu":
        return replay_bwd_reference(params, rec, pay, gcot, tile=tile,
                                    block_tiled=block_tiled,
                                    state_rows=state_rows, emit_fwd=emit_fwd,
                                    reduce_slots=reduce_slots)
    if rec.device.type != "cuda":
        raise ValueError(f"unsupported device {rec.device}")
    from ..render import _cuda
    fn = _cuda.load("replay_bwd")
    dev = rec.device
    D, n = rec.shape
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty(D, N_CARRY, n, **f32)
    cot_step = table = None
    if reduce_slots is None:
        cot_step = torch.zeros(D, 8, n, **f32)
    else:
        table = torch.zeros(reduce_slots, 7, **f32)
    cotray = torch.empty(N_CARRY if state_rows is not None else 6, n, **f32)
    fwd = torch.empty(3, n, **f32) if emit_fwd else None
    c = _counters()
    cnt = (torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
           if counters or stats_on(c) else None)
    rc = fn(_ptr(params), _ptr(rec), _ptr(pay), _ptr(gcot), _ptr(state_rows),
            _ptr(scratch), _ptr(cot_step), _ptr(table), _ptr(cotray),
            _ptr(fwd), _ptr(cnt), D, n, tile, int(block_tiled),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError("replay_bwd launch failed: "
                           + _cuda.error_string("replay_bwd", rc))
    if c is not None:
        c.add("k2.launches", 1)
        for name, v in zip(COUNTERS, cnt if stats_on(c) else ()):
            c.add(f"k2.{name}", v)
    out = (cot_step if table is None else table), cotray, fwd
    return out + (cnt,) if counters else out


def _replayed(o, d, f, a):
    """The bounce K1 took, recomputed from the winner's fields ``f``."""
    cx, cy, cz, rad = f[0], f[1], f[2], f[3]
    q = quad(*o, *d, a, cx, cy, cz, rad * rad)
    sq = sqrt(torch.where(q.disc > 0.0, q.disc, 1.0))
    best_m = key_floor(search_m(q, sq, EPS * a))
    return bounce(*o, *d, a, cx, cy, cz, rad, best_m)


def replay_bwd_reference(params, rec, pay, gcot, *, tile: int,
                         block_tiled: bool = False, state_rows=None,
                         emit_fwd: bool = False,
                         reduce_slots: int | None = None):
    """Plain torch version of K2, on any device, with the kernel's per-ray
    arithmetic (square roots through float64, no fused multiply-adds).  Every
    ray runs every step under masks, as the TPU kernel runs its tiles; the
    masks select what the kernel computes for the steps a ray has.  The slot
    table is summed in float64 and rounded once.  Same arguments and results
    as ``replay_bwd``."""
    D, n = rec.shape
    if state_rows is None:
        start = _gen_rays(params, n, tile, block_tiled)[:N_CARRY]
    else:
        start = state_rows
    o, d, light = list(start[0:3]), list(start[3:6]), list(start[6:9])
    zero = torch.zeros_like(o[0])
    col = [zero, zero, zero]

    # pass 1: o, d, light at the start of every step
    steps = []
    for k in range(D):
        steps.append((o, d, light))
        e = rec[k]
        a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        f = pay[k, :7]
        h = _replayed(o, d, f, a)
        if emit_fwd:
            t = 0.5 * (h.uy + 1.0)
            col = [torch.where(e == -1, light[c] * sky(t, SKY_K[c]), col[c])
                   for c in range(3)]
        bnc = e >= 0
        o = [torch.where(bnc, v, w) for v, w in zip((h.px, h.py, h.pz), o)]
        d = [torch.where(bnc, v, w) for v, w in zip((h.rx, h.ry, h.rz), d)]
        light = [torch.where(bnc, light[c] * f[4 + c], light[c])
                 for c in range(3)]

    # pass 2: the cotangent sweep, deepest step first
    gr, gg, gb = gcot[0], gcot[1], gcot[2]
    carry = list(gcot[3:12])
    cot_step = torch.zeros(D, 8, n, dtype=pay.dtype, device=rec.device)
    for k in reversed(range(D)):
        (ox, oy, oz), (dx, dy, dz), (lr, lg, lb) = steps[k]
        cox, coy, coz, cdx, cdy, cdz, clr, clg, clb = carry
        e = rec[k]
        a = dx * dx + dy * dy + dz * dz
        f = pay[k, :7]
        h = _replayed((ox, oy, oz), (dx, dy, dz), f, a)
        inv_len = h.inv_dn
        # a mirror bounce (pallas_replay_bwd.py:277-358)
        ccolr, ccolg, ccolb = lr * clr, lg * clg, lb * clb
        nlr, nlg, nlb = f[4] * clr, f[5] * clg, f[6] * clb
        ndotcr = h.nx * cdx + h.ny * cdy + h.nz * cdz
        cux = cdx - 2.0 * h.nx * ndotcr
        cuy = cdy - 2.0 * h.ny * ndotcr
        cuz = cdz - 2.0 * h.nz * ndotcr
        cnx = -2.0 * (h.ux * ndotcr + h.udn * cdx)
        cny = -2.0 * (h.uy * ndotcr + h.udn * cdy)
        cnz = -2.0 * (h.uz * ndotcr + h.udn * cdz)
        cpx = cox + cnx * h.inv_r
        cpy = coy + cny * h.inv_r
        cpz = coz + cnz * h.inv_r
        ccx, ccy, ccz = -cnx * h.inv_r, -cny * h.inv_r, -cnz * h.inv_r
        crad = -(h.nx * cnx + h.ny * cny + h.nz * cnz) * h.inv_r
        udotcu = h.ux * cux + h.uy * cuy + h.uz * cuz
        ndx = (cux - h.ux * udotcu) * inv_len
        ndy = (cuy - h.uy * udotcu) * inv_len
        ndz = (cuz - h.uz * udotcu) * inv_len
        ndx = ndx + h.t2 * cpx
        ndy = ndy + h.t2 * cpy
        ndz = ndz + h.t2 * cpz
        ct2 = dx * cpx + dy * cpy + dz * cpz
        sgn = torch.where(h.near, -1.0, 1.0)
        cb2 = -h.inv_a * ct2
        csq = sgn * h.inv_a * ct2
        ca = -h.t2 * h.inv_a * ct2
        # 0.5 / sq is torch's reciprocal times 0.5: exact, a power of two
        cdisc = csq * (0.5 / h.sq)
        cb2 = cb2 + 2.0 * h.q.b * cdisc
        ca = ca - h.q.c * cdisc
        cc2 = -a * cdisc
        cocx = cb2 * dx + 2.0 * cc2 * h.q.ocx
        cocy = cb2 * dy + 2.0 * cc2 * h.q.ocy
        cocz = cb2 * dz + 2.0 * cc2 * h.q.ocz
        ndx = ndx + cb2 * h.q.ocx + 2.0 * ca * dx
        ndy = ndy + cb2 * h.q.ocy + 2.0 * ca * dy
        ndz = ndz + cb2 * h.q.ocz + 2.0 * ca * dz
        crad = crad - 2.0 * f[3] * cc2
        bnc = e >= 0
        for r, v in enumerate((ccx - cocx, ccy - cocy, ccz - cocz, crad,
                               ccolr, ccolg, ccolb)):
            cot_step[k, r] = torch.where(bnc, v, 0.0)
        # a miss seeds the carry from the image cotangent through the sky
        t = 0.5 * (h.uy + 1.0)
        cot_t = (lr * gr * (SKY_K[0] - 1.0) + lg * gg * (SKY_K[1] - 1.0)
                 + lb * gb * (SKY_K[2] - 1.0))
        cuy_m = 0.5 * cot_t
        udotcu_m = h.uy * cuy_m
        miss_carry = (zero, zero, zero,
                      (-h.ux * udotcu_m) * inv_len,
                      (cuy_m - h.uy * udotcu_m) * inv_len,
                      (-h.uz * udotcu_m) * inv_len,
                      sky(t, SKY_K[0]) * gr, sky(t, SKY_K[1]) * gg,
                      sky(t, SKY_K[2]) * gb)
        bounce_carry = (cpx + cocx, cpy + cocy, cpz + cocz, ndx, ndy, ndz,
                        nlr, nlg, nlb)
        miss, absorb = e == -1, e == -3
        carry = [torch.where(bnc, bv, torch.where(
                     miss, mv, torch.where(absorb, 0.0, cv)))
                 for bv, mv, cv in zip(bounce_carry, miss_carry, carry)]

    if state_rows is not None:
        # a ray inactive at the segment's start has no cotangent
        dead = rec[0] == -2
        cotray = torch.stack([torch.where(dead, 0.0, c) for c in carry])
    else:
        cotray = torch.stack(carry[:6])
    fwd = None
    if emit_fwd:
        fwd = torch.stack(col)
        if state_rows is not None:
            fwd = torch.where(rec[0] == -2, 0.0, fwd)
    if reduce_slots is None:
        return cot_step, cotray, fwd
    return slot_table(rec, cot_step, reduce_slots).float(), cotray, fwd


def slot_table(rec, cot_step, n_slots: int, absolute: bool = False):
    """Per-step sphere cotangents (D, 8, n) summed onto their slots in
    float64: the (n_slots, 7) table.  ``absolute`` sums their magnitudes
    instead (the scale of a summation-order tolerance)."""
    src = cot_step[:, :7].permute(0, 2, 1).reshape(-1, 7).double()
    if absolute:
        src = src.abs()
    tab = torch.zeros(n_slots, 7, dtype=torch.float64, device=rec.device)
    # non-bounce steps carry zero cotangents: sending them to slot 0 adds 0
    return tab.index_add_(0, rec.reshape(-1).clamp(min=0).long(), src)
