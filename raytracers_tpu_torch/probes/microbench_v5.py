"""M5 and M6 on an NVIDIA Hopper card: the counterpart of ``tools/microbench_v5.py``.

The TPU probe sized the v5 design space: visits of 32- or 64-row
sub-clusters against 128-row ones, with the winner's payload read at every
visit or deferred to once a bounce.  These ask the same of the H100, with
hand-written CUDA (``csrc/microbench_v5.cu``) and a plain PyTorch version
beside each kernel:

* M5 (``visit_kernel``): 256 visits of one (rows, 8) sphere table by 512
  fake rays a tile, rows 32, 64 or 128.  A visit is the quadratic with
  oc = o - s, b = oc.d, c = |oc|^2 - r2 (column 7 of the table holds r^2),
  the key (bits(t) & mask) | row and its minimum over the rows.  Payload
  ``mxu``: the key masks ~(rows - 1), and on improvement the winner's 8
  fields of the (8, rows) table replace the carried ones (the TPU's one-hot
  MXU dot; on the card a select of an indexed load).  Payload ``defer``:
  the key masks ~511 and the visit carries the index of the winning visit,
  whose payload a bounce would read once (M6).  One thread per ray (K1's
  design) or k lanes a ray (``VISIT_LANES``, by width); the table is read
  through ``__ldg`` (L1) in K1's slot-major layout, or for the lanes way
  where ``VISIT_LAYOUT`` says so from a field-major copy made in the
  call.
* M6 (``gather_kernel``): the deferred read, 64 times per lane: the 8
  fields of slot (lane * 37 + i) mod (chunks * 128) of an (8, chunks * 128)
  table, summed in field order and added to a running sum; through
  ``__ldg`` from the slot-major copy K1's payload layout keeps (two 16-byte
  loads a slot), or from a copy staged in shared memory.

Each wrapper launches its kernel for CUDA tensors (counted in
``microbench.LAUNCHES`` under the variant's label) and takes the plain
version for CPU tensors.  ``run()`` drives every variant at the TPU probe's
sizes (and at 65,536 and 1,048,576 rays, since 8,192 threads fill about 6%
of the card), times it with CUDA events, holds it bit for bit against its
plain version and computes its bound; ``main`` writes
``docs/MICROBENCH_V5_H100.json``:

    python -m raytracers_tpu_torch.probes.microbench_v5            # on the card
    python -m raytracers_tpu_torch.probes.microbench_v5 --device cpu

``--device cpu`` runs only the plain versions at a small size and times
nothing.  The advanced indexing timed beside M6 (``tbl[:, slot].sum(0)``)
is a yardstick: no result of the port goes through it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import vec
from ..utils.platform import resolve_device
from .microbench import (F32, I32, FP32_LANE_OPS_PER_S, SALT,
                         VISIT_DEVICE_MS_BELOW, ClockSampler, _bit_equal, _c,
                         _device_entry, _device_note, _entry, _expect,
                         _launch, _on_card, _pipe_note, _plain_timed, _smi,
                         _timed, measure_mul_equivalents, sass_counts,
                         visit_least_wavefronts, visit_route_ms)

T = 512                           # the TPU probe's lane width
GRID = 16                         # its grid: 8,192 rays or lanes
ITERS = 256                       # visits (tools/microbench_v5.py:95)
GATHER_ITERS = 64                 # gather iterations (:147)
ROWS = (32, 64, 128)
PAYLOADS = ("mxu", "defer")
CHUNKS = (4, 1)
VISIT_WAYS = ("thread", "lanes")
# k of the lanes way at each width (csrc/microbench_v5.cu kVisitLanes): the
# card's sweep at 8,192 rays (probes/m4m5_turns.py,
# docs/M4M5_TURNS_H100.json)
VISIT_LANES = {32: 8, 64: 32, 128: 8}
# the lanes way's table at each width (csrc/microbench_v5.cu kFieldMajor):
# K1's slot-major (rows, 8), or the field-major (8, rows) copy
# (``field_major``) where the sweep found it more than 5% faster
VISIT_LAYOUT = {32: "field", 64: "field", 128: "slot"}
# the fields of a table row row_bc uses: cx, cy, cz and r^2
# (microbench.visit_load_model, visit_least_wavefronts)
VISIT_FIELDS = (0, 1, 2, 7)
# the C entry's way codes: __ldg from the slot-major (W, 8) copy, K1's
# layout; the (8, W) table staged in shared memory as it is
GATHER_WAYS = ("ldg", "smem")
RAYS = (GRID * T, 256 * 256, 1 << 20)   # the TPU's grid, 256^2, ~1000^2
LANES = (GRID * T, 1 << 20)
INPUTS = ("tpu", "seeded")
INPUT_SEED = 7
MISS_KEY = 0x7F000000             # krun's initial value
SLOT_STRIDE = 37

RECORD = Path(__file__).resolve().parents[2] / "docs" / "MICROBENCH_V5_H100.json"


# ---------------------------------------------------------------- M5

def visit_label(rows: int, payload: str, way: str, n_rays: int) -> str:
    return f"M5 visit_r{rows}_{payload} {way} {n_rays}"


def way_route(way: str, rows: int) -> tuple[int, str]:
    """(lanes a ray, the table's layout) of a way at a width: the C entry's
    code and the table it is given."""
    return ((1, "slot") if way == "thread"
            else (VISIT_LANES[rows], VISIT_LAYOUT[rows]))


def visit_v5(salt, sphT, sph8, n_rays, rows, payload="mxu", way="thread",
             iters=ITERS):
    """M5: ``iters`` visits of the ``rows`` spheres of ``sphT`` (rows, 8),
    column 0 shifted by salt * c at visit c, by ``n_rays`` fake rays (lane
    j % 512 of tools/microbench_v5.py:55-63); out (n_rays / 512, 8, 512) =
    (pay + float(krun)) + float(cidx).  ``payload``: ``mxu`` carries the
    winner's 8 fields of ``sph8`` (8, rows), ``defer`` the winning visit's
    index.  ``way``: one thread per ray, or ``VISIT_LANES[rows]`` lanes a
    ray, which reads the table in ``VISIT_LAYOUT[rows]`` (the field-major
    copy made here; ``way_route``)."""
    _expect(salt, (1,), F32, "salt")
    _expect(sphT, (rows, 8), F32, "M5 sphT")
    _expect(sph8, (8, rows), F32, "M5 sph8")
    if (rows not in ROWS or payload not in PAYLOADS or way not in VISIT_WAYS
            or n_rays < T or n_rays % T or iters < 0):
        raise ValueError(f"M5: rows {rows}, payload {payload!r}, way {way!r},"
                         f" {n_rays} rays, iters {iters}")
    if not _on_card(salt, sphT, sph8):
        return visit_v5_plain(salt, sphT, sph8, n_rays, rows, payload, iters)
    out = torch.empty((n_rays // T, 8, T), dtype=F32, device=salt.device)
    lanes, layout = way_route(way, rows)
    if layout == "field":
        sphT = field_major(sphT)
    return _launch(visit_label(rows, payload, way, n_rays), out, 0, lanes,
                   rows, PAYLOADS.index(payload), iters, n_rays, salt, sphT,
                   sph8, out, kernel="microbench_v5")


def field_major(sphT):
    """The (8, rows) copy of the (rows, 8) table: field f of every row in
    row f, a 4-byte load a field for a warp's consecutive rows."""
    return sphT.t().contiguous()


def fake_rays(salt):
    """The TPU probe's ray of lane lid (:55-63): ox, oy, oz, dx, dy, dz, a
    and 1/a as (512,) float32 tensors, each operation rounded."""
    lid = torch.arange(T, dtype=F32, device=salt.device)
    c = lambda v: _c(v, salt)                                # noqa: E731
    ox = lid * c(1e-3) + salt
    oy = lid * c(2e-3)
    oz = torch.full((T,), 30.0, dtype=F32, device=salt.device)
    dx = lid * c(1e-4) + c(0.1)
    dy = lid * c(-1e-4) + c(0.2)
    dz = torch.full((T,), -1.0, dtype=F32, device=salt.device)
    a = (dx * dx + dy * dy) + dz * dz
    return ox, oy, oz, dx, dy, dz, a, c(1.0) / a


def visit_keys(b, cq, a, inv_a, key_mask: int, rows: int):
    """(rows, 512) keys of one visit from b and c (rows, 512): disc, the
    near root past eps or else the far one, the miss value 1e9, then
    (bits(t) & key_mask) | row (tools/microbench_v5.py:85-93)."""
    one, eps, big = _c(1.0, b), _c(0.1, b), _c(1e9, b)
    disc = b * b - a * cq
    pos = disc > 0
    sq = vec.sqrt(torch.where(pos, disc, one))
    t0 = (-b - sq) * inv_a
    t1 = (-b + sq) * inv_a
    t = torch.where(t0 > eps, t0, t1)
    tv = torch.where(pos & (t > eps), t, big)
    rid = torch.arange(rows, dtype=I32, device=b.device)[:, None]
    return (tv.view(I32) & key_mask) | rid


def key_mask(rows: int, payload: str) -> int:
    return ~(rows - 1) if payload == "mxu" else ~511


def visit_v5_state_plain(salt, sphT, sph8, rows, payload="mxu",
                         iters=ITERS):
    """The visit loop over one tile of 512 rays (every tile is the same):
    krun (512,) int32, pay (8, 512) float32 and cidx (512,) int32.  The
    ``mxu`` payload is the select the one-hot dot computes exactly for
    finite fields: pay * (1 - impf) + onehot . sph8 = sph8[:, w] on
    improvement, pay otherwise."""
    ox, oy, oz, dx, dy, dz, a, inv_a = fake_rays(salt)
    mask = key_mask(rows, payload)
    krun = torch.full((T,), MISS_KEY, dtype=I32, device=salt.device)
    pay = torch.zeros((8, T), dtype=F32, device=salt.device)
    cidx = torch.zeros((T,), dtype=I32, device=salt.device)
    sy, sz, r2 = sphT[:, 1:2], sphT[:, 2:3], sphT[:, 7:8]
    for c in range(iters):
        sx = sphT[:, 0:1] + salt * _c(float(c), salt)
        ocx, ocy, ocz = ox - sx, oy - sy, oz - sz
        b = (ocx * dx + ocy * dy) + ocz * dz
        cq = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r2
        kmin = visit_keys(b, cq, a, inv_a, mask, rows).amin(0)
        imp = kmin < krun
        if payload == "mxu":
            pay = torch.where(imp, sph8[:, (kmin & (rows - 1)).long()], pay)
        else:
            cidx = torch.where(imp, torch.full_like(cidx, c), cidx)
        krun = torch.minimum(krun, kmin)
    return krun, pay, cidx


def visit_v5_tile(krun, pay, cidx):
    """What the TPU kernel writes for one tile: (pay + float(krun)) +
    float(cidx)."""
    return (pay + krun.float()) + cidx.float()


def visit_v5_plain(salt, sphT, sph8, n_rays, rows, payload="mxu",
                   iters=ITERS):
    tile = visit_v5_tile(*visit_v5_state_plain(salt, sphT, sph8, rows,
                                               payload, iters))
    return tile.expand(n_rays // T, 8, T)


def visit_v5_inputs(kind: str, rows: int, seed: int = INPUT_SEED):
    """(sphT (rows, 8), sph8 (8, rows)) float32 numpy arrays.  ``tpu``: the
    TPU probe's 0.1 and 0.2 fills (every ray misses, so row 0 wins at the
    first visit and nothing changes after); ``seeded``: spheres placed on
    the fake rays' paths for lanes 0..511, 3 to 40 units ahead, radii 0.02
    to 0.1, column 7 = r^2, so rows win unevenly and neighbouring rays take
    different winners."""
    if kind == "tpu":
        return (np.full((rows, 8), 0.1, np.float32),
                np.full((8, rows), 0.2, np.float32))
    rng = np.random.default_rng(seed + rows)
    lid = rng.uniform(0.0, T - 1.0, rows)
    t = rng.uniform(3.0, 40.0, rows)
    o = np.stack([lid * 1e-3, lid * 2e-3, np.full(rows, 30.0)], 1)
    d = np.stack([lid * 1e-4 + 0.1, lid * -1e-4 + 0.2, -np.ones(rows)], 1)
    c = o + t[:, None] * d + rng.normal(0.0, 0.05, (rows, 3))
    r = rng.uniform(0.02, 0.1, rows)
    sphT = np.zeros((rows, 8))
    sphT[:, :3] = c
    sphT[:, 7] = r * r
    sph8 = np.zeros((8, rows))
    sph8[:3] = c.T
    sph8[3] = r
    sph8[4:] = rng.uniform(0.0, 1.0, (4, rows))
    return sphT.astype(np.float32), sph8.astype(np.float32)


# ---------------------------------------------------------------- M6

def gather_label(chunks: int, way: str, n_lanes: int) -> str:
    return f"M6 paygather_c{chunks} {way} {n_lanes}"


def gather(salt, tbl, n_lanes, chunks, way="ldg", iters=GATHER_ITERS):
    """M6: for ``iters`` steps i, each lane (j % 512) adds the sum of the 8
    fields, in field order, of slot (lane * 37 + i) mod (chunks * 128) of
    ``tbl`` (8, chunks * 128) to a running sum; out (n_lanes / 512, 1, 512).
    ``way``: ``ldg`` reads the slot-major copy (``slot_major``, made in the
    call) through ``__ldg``; ``smem`` stages the table in shared memory.
    The TPU probe adds salt * 0.0 to the table, which changes no value but
    -0; neither version does."""
    _expect(salt, (1,), F32, "salt")
    _expect(tbl, (8, chunks * 128), F32, "M6 tbl")
    if (chunks not in CHUNKS or way not in GATHER_WAYS or n_lanes < T
            or n_lanes % T or iters < 0):
        raise ValueError(f"M6: chunks {chunks}, way {way!r}, {n_lanes} lanes,"
                         f" iters {iters}")
    if not _on_card(salt, tbl):
        return gather_plain(salt, tbl, n_lanes, chunks, iters)
    out = torch.empty((n_lanes // T, 1, T), dtype=F32, device=salt.device)
    return _launch(gather_label(chunks, way, n_lanes), out, 1,
                   GATHER_WAYS.index(way), chunks, 0, iters, n_lanes, salt,
                   slot_major(tbl) if way == "ldg" else tbl, None, out,
                   kernel="microbench_v5")


def slot_major(tbl):
    """The (W, 8) copy of the (8, W) table: slot s's 8 fields in row s, 32
    contiguous bytes, as K1 keeps its winners' payload."""
    return tbl.t().contiguous()


def gather_slots(chunks: int, iters: int, device) -> torch.Tensor:
    """(iters, 512) int64: the slot each lane reads at step i."""
    lid = torch.arange(T, device=device)
    i = torch.arange(iters, device=device)[:, None]
    return (lid * SLOT_STRIDE + i) % (chunks * 128)


def gather_plain(salt, tbl, n_lanes, chunks, iters=GATHER_ITERS):
    acc = torch.zeros(T, dtype=F32, device=tbl.device)
    for slot in gather_slots(chunks, iters, tbl.device):
        f = tbl[:, slot]
        s = torch.zeros_like(acc)
        for fld in range(8):
            s = s + f[fld]
        acc = acc + s
    return acc.reshape(1, 1, T).expand(n_lanes // T, 1, T)


def gather_inputs(kind: str, chunks: int, seed: int = INPUT_SEED):
    """(8, chunks * 128) float32: the TPU probe's ones (the output is then
    a constant), or distinct values from ``seed``."""
    if kind == "tpu":
        return np.ones((8, chunks * 128), np.float32)
    rng = np.random.default_rng(seed + 1000 * chunks)
    return rng.uniform(-1.0, 1.0, (8, chunks * 128)).astype(np.float32)


# ---------------------------------------------------------------- bounds

# Lane operations of one (ray, sphere row) test of M5, each float32 add,
# multiply, negation, comparison and select and the key's and, or and
# minimum as one: oc 3, b 5, c 6, disc 3, disc > 0 1, its select 1, -b 1,
# t0 2, t1 2, t0 > eps 1, t's select 1, t > eps 1, the and 1, tv's select
# 1, the key 2, the minimum 1 = 32, plus the square root at its measured
# weight.  Per ray and visit: the strict-less test and krun's minimum, and
# 8 selects (mxu) or 1 (defer).  Per tile and visit the table shift: rows
# adds and the salt's product.  Per ray its set-up (12 and 1/a) and its
# output (8 x 2 adds and 2 conversions).
VISIT_ROW_OPS, VISIT_RAY_OPS = 32, 30
VISIT_RAY_VISIT_OPS = {"mxu": 10, "defer": 3}


def visit_v5_work(n_rays, rows, payload, iters, sqrt_ops, div_ops):
    """(lane operations, bytes) of one M5 launch: every input read once,
    the output written once."""
    per_visit = rows * (VISIT_ROW_OPS + sqrt_ops) + VISIT_RAY_VISIT_OPS[payload]
    tiles = n_rays // T
    ops = (n_rays * iters * per_visit + tiles * iters * (rows + 1)
           + n_rays * (VISIT_RAY_OPS + div_ops))
    return ops, 4 * (rows * 8 + 8 * rows + 8 * n_rays + 1)


def visit_v5_pipes(n_rays, rows, payload, iters, sqrt_ops, div_ops):
    """M5 by row (``microbench.pipe_bound``): every lane operation of
    ``visit_v5_work`` on fp32 (a root and 1/a at M1's multiply-equivalents)
    and the fewest L1 wavefronts its table loads need
    (``microbench.visit_least_wavefronts``)."""
    return {"fp32": visit_v5_work(n_rays, rows, payload, iters, sqrt_ops,
                                  div_ops)[0],
            "l1_wavefronts": n_rays * iters * rows / 32
            * visit_least_wavefronts(VISIT_FIELDS, rows)}


# Per lane and step of M6: the slot (a multiply, an add and the modulo,
# one each), the 8 field sums and the running add = 12.
GATHER_OPS = 12


def gather_work(n_lanes, chunks, iters):
    return (n_lanes * iters * GATHER_OPS,
            4 * (8 * chunks * 128 + n_lanes + 1))


# A lane-step brings its slot's 8 fields, 32 bytes, through L1 or shared
# memory, whatever the layout: the recounted bound (``pipe_bound``).
GATHER_STEP_BYTES = 32


def gather_pipes(n_lanes, iters):
    return {"l1_bytes": n_lanes * iters * GATHER_STEP_BYTES}


# ---------------------------------------------------------------- runs

def _dev_inputs(arrays, dev):
    return tuple(torch.from_numpy(x).to(dev) for x in arrays)


def warm_plain(salt):
    """One short plain visit and gather, so that the first timed plain
    version does not carry the card's first use of these torch ops."""
    sphT, sph8 = _dev_inputs(visit_v5_inputs("tpu", 32), salt.device)
    visit_v5_state_plain(salt, sphT, sph8, 32, "mxu", 2)
    gather_plain(salt, sphT.reshape(8, 32).repeat(1, 4), T, 1, 2)


def run_m5(dev, weights, log=print):
    """Every M5 variant on the card, on the TPU probe's spheres and the
    seeded ones: timed, with the device's own time under
    ``VISIT_DEVICE_MS_BELOW``, bit-equal to its plain version, with its
    bound by row (``visit_v5_pipes``: the root and 1/a at ``weights``, M1's
    multiply-equivalents, and L1's wavefronts)."""
    return _run_m5(dev, weights, log, {
        w: ({r: way_route(w, r) for r in ROWS},
            lambda *a, w=w: visit_v5(*a[:6], way=w, iters=a[6]))
        for w in VISIT_WAYS})


def _run_m5(dev, weights, log, calls):
    """``run_m5`` of ``calls`` {way: ({rows: (lanes a ray, layout)}, a
    launcher (salt, sphT, sph8, n_rays, rows, payload, iters))}: this
    build's ways, or another build's for a probe of two builds in turns."""
    salt = torch.tensor([SALT], dtype=F32, device=dev)
    out = []
    warm_plain(salt)
    for which in INPUTS:
        for rows in ROWS:
            sphT, sph8 = _dev_inputs(visit_v5_inputs(which, rows), dev)
            for payload in PAYLOADS:
                state, plain_ms = _plain_timed(lambda: visit_v5_state_plain(
                    salt, sphT, sph8, rows, payload, ITERS))
                tile = visit_v5_tile(*state)
                winners = int(torch.unique(state[0] & (rows - 1)).numel())
                for n_rays in RAYS:
                    for way, (route, fn) in calls.items():
                        lanes, layout = route[rows]
                        label = visit_label(rows, payload, way, n_rays)
                        name = f"{label} rays ({which})"
                        call = lambda: fn(  # noqa: E731
                            salt, sphT, sph8, n_rays, rows, payload, ITERS)
                        ms, y, _, runs = _timed(call, min_window_ms=50.0)
                        _bit_equal(name, y, tile.expand_as(y))
                        visits = n_rays * ITERS
                        w = (weights["sqrt"], weights["rcp"])
                        e = _entry(
                            "M5", name, label, ms, runs,
                            (*visit_v5_work(n_rays, rows, payload, ITERS, *w),
                             FP32_LANE_OPS_PER_S), plain_ms, 0.0,
                            pipes=visit_v5_pipes(n_rays, rows, payload, ITERS,
                                                 *w),
                            rows=rows, payload=payload, way=way,
                            lanes=lanes, layout=layout, rays=n_rays,
                            input=which,
                            winning_rows=winners,
                            ns_per_ray_visit=ms * 1e6 / visits,
                            ns_per_row_test=ms * 1e6 / (visits * rows),
                            **_device_entry(call, ms, VISIT_DEVICE_MS_BELOW))
                        e["pipe_ms"]["l1_route"] = visit_route_ms(
                            visits * rows, lanes, layout, VISIT_FIELDS, rows)
                        log(f"[probe] {name}: {ms:.4f} ms{_device_note(e)}, "
                            f"{e['ns_per_ray_visit']:.4f} ns a ray-visit, "
                            f"{_pipe_note(e)}; {winners} rows win; "
                            "bit-equal")
                        out.append(e)
    return out


def width_ratios(m5) -> dict:
    """A ray-visit's time at 32 and 64 rows over its time at 128, for each
    input, payload, way and ray count."""
    by = {(e["input"], e["payload"], e["way"], e["rays"], e["rows"]): e["ms"]
          for e in m5}
    return {f"{i} {p} {w} {n}": {str(r): by[i, p, w, n, r] / by[i, p, w, n, 128]
                                 for r in (32, 64)}
            for (i, p, w, n, r) in by if r == 128}


def _gather_library_ms(tbl, chunks, n_lanes):
    """The library call: one advanced index of every step's slots for every
    lane, summed over fields and steps."""
    from ..utils.timing import cuda_ms
    slots = gather_slots(chunks, GATHER_ITERS, tbl.device).repeat(
        1, n_lanes // T)
    return cuda_ms(lambda: tbl[:, slots].sum(0).sum(0), warmup=1, runs=3)


def run_m6(dev, log=print):
    """Every M6 way at each width and lane count, on the TPU probe's table
    and the seeded one: timed, with the device's own time where the
    window's is under ``DEVICE_MS_BELOW``, and bit-equal to
    ``gather_plain`` (raises ``ProbeMismatch``)."""
    return _run_m6(dev, log, gather)


def _run_m6(dev, log, gather_fn):
    """``run_m6`` through ``gather_fn``, ``gather``'s signature (another
    build's launcher, for a probe of two builds in turns)."""
    salt = torch.tensor([SALT], dtype=F32, device=dev)
    out = []
    warm_plain(salt)
    for which in INPUTS:
        for chunks in CHUNKS:
            tbl = torch.from_numpy(gather_inputs(which, chunks)).to(dev)
            ref, plain_ms = _plain_timed(
                lambda: gather_plain(salt, tbl, T, chunks, GATHER_ITERS))
            for n_lanes in LANES:
                lib_ms = _gather_library_ms(tbl, chunks, n_lanes)
                for way in GATHER_WAYS:
                    label = gather_label(chunks, way, n_lanes)
                    name = f"{label} lanes ({which})"
                    call = lambda: gather_fn(  # noqa: E731
                        salt, tbl, n_lanes, chunks, way, GATHER_ITERS)
                    ms, y, _, runs = _timed(call, min_window_ms=50.0)
                    _bit_equal(name, y, ref[0:1].expand_as(y))
                    e = _entry("M6", name, label, ms, runs,
                               (*gather_work(n_lanes, chunks, GATHER_ITERS),
                                FP32_LANE_OPS_PER_S), plain_ms, 0.0, lib_ms,
                               pipes=gather_pipes(n_lanes, GATHER_ITERS),
                               chunks=chunks, way=way, lanes=n_lanes,
                               input=which,
                               ns_per_lane_step=ms * 1e6
                               / (n_lanes * GATHER_ITERS),
                               **_device_entry(call, ms))
                    log(f"[probe] {name}: {ms:.4f} ms "
                        f"({e['ns_per_lane_step']:.5f} ns a lane-step"
                        f"{_device_note(e)}), bound"
                        f" {e['bound_ms']:.4f} on {e['bound_row']} "
                        f"({e['share']:.4f}; old {e['old_bound_ms']:.4f}, "
                        f"{e['old_share']:.4f}), indexing {lib_ms:.4f} ms; "
                        "bit-equal")
                    out.append(e)
    return out


def run(device=None, log=print, weights=None) -> dict:
    """M5 and M6 at the TPU probe's sizes on the card.  ``weights``: M1's
    multiply-equivalents of a root and 1/x, measured here when not given."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("run() measures on the card; the CPU takes "
                           "cpu_smoke()")
    card = _smi("name,power.limit")
    log(f"[probe] {card}")
    t0 = time.perf_counter()
    if weights is None:
        weights = measure_mul_equivalents(dev)
    with ClockSampler() as clocks:
        m5 = run_m5(dev, weights, log)
        m6 = run_m6(dev, log)
        samples = [m for _, m, _ in clocks.samples]
    ratios = width_ratios(m5)
    for k, v in ratios.items():
        log(f"[probe] M5 width, {k}: W=32 {v['32']:.4f}, W=64 {v['64']:.4f} "
            "of W=128's time")
    log(f"[probe] M5-M6 in {time.perf_counter() - t0:.1f} s")
    return dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                clocks_sm_mhz=dict(min=min(samples, default=None),
                                   max=max(samples, default=None),
                                   samples=len(samples)),
                mul_equivalents=weights, width_ratios=ratios,
                entries=m5 + m6)


def cpu_smoke(log=print) -> dict:
    """The plain versions at a small size on the CPU; nothing is timed."""
    salt = torch.tensor([SALT], dtype=F32)
    res = {}
    for which in INPUTS:
        for rows in ROWS:
            sphT, sph8 = _dev_inputs(visit_v5_inputs(which, rows), "cpu")
            for payload in PAYLOADS:
                res[f"M5 r{rows} {payload} ({which})"] = visit_v5(
                    salt, sphT, sph8, T, rows, payload, iters=4)
        for chunks in CHUNKS:
            tbl = torch.from_numpy(gather_inputs(which, chunks))
            res[f"M6 c{chunks} ({which})"] = gather(salt, tbl, T, chunks,
                                                    iters=4)
    for k, v in res.items():
        log(f"[probe=cpu] {k}: {tuple(v.shape)} {v.dtype}, "
            f"finite {bool(torch.isfinite(v).all())}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracers_tpu_torch.probes.microbench_v5",
        description="M5 and M6 of tools/microbench_v5.py on the CUDA card; "
                    "writes docs/MICROBENCH_V5_H100.json")
    ap.add_argument("--device", default=None,
                    help="'cpu': run the plain versions at a small size "
                         "and time nothing (default: the CUDA card)")
    ap.add_argument("--out", default=str(RECORD),
                    help="where the card's record goes")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        cpu_smoke()
        return 0
    from ..render import _cuda
    rec = run(dev)
    rec["sass"] = sass_counts(_cuda.build_info["microbench_v5"]["path"])[0]
    Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
    print(f"[probe] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
