"""M1-M4 on an NVIDIA Hopper card: the counterpart of ``tools/microbench_tpu.py``.

The TPU probes sized the megakernel's design space on a v5e; these ask the
same four questions of the H100, with hand-written CUDA
(``csrc/microbench.cu``) and a plain PyTorch version beside each kernel:

* M1 (``fma_kernel``): the FP32 issue rate at 8, 4 and 1 independent chains a
  thread, uncontracted (``__fmul_rn`` + ``__fadd_rn``, as every kernel of the
  port issues) and as one FFMA; and what an IEEE ``sqrtf`` and an IEEE
  division cost in multiply-equivalents, which the operation bounds of
  ``chip_smoke.py`` charge for them;
* M2 (``dot_kernel``): the v4 kernel's small products (pair, pairT,
  payload) as an FP32 loop of fixed order, and as TF32 and 3xTF32
  ``wgmma``;
* M3 (``reduce_kernel``): a 128-key minimum by one thread's serial loop,
  by 8 lanes a column, each a tree of its 16 keys, then a shuffle
  butterfly over the 8, or (int32 keys) by a warp a column and
  ``__reduce_min_sync``;
* M4 (``visit_kernel``): one 128-sphere cluster visit, one thread per ray
  (K1's design) against k lanes a ray (``VISIT_LANES``), at 4k, 64k and 1M
  rays.

Each wrapper launches its kernel for CUDA tensors (counting the launch in
``LAUNCHES`` under the variant's label) and takes the plain version for CPU
tensors.  ``run()`` drives every variant at the TPU probes' sizes, times it
with CUDA events, holds it against its plain version on the same inputs and
computes its bound; ``main`` writes the result to ``docs/MICROBENCH_H100.json``
(never ``docs/MICROBENCH.json``, the JAX package's v5e record):

    python -m raytracers_tpu_torch.probes.microbench            # on the card
    python -m raytracers_tpu_torch.probes.microbench --device cpu

``--device cpu`` runs only the plain versions at a small size and times
nothing.  The PyTorch calls timed beside M2 and M3 (``torch.bmm``,
``torch.amin``) are yardsticks: no result of the port goes through them.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .. import vec
from ..utils.platform import resolve_device
from ..utils.profiling import (FP32_LANE_OPS_PER_S, HBM_BYTES_PER_S,
                               device_ms)

F32, I32 = torch.float32, torch.int32
T, ROWS = 256, 128                # the TPU probes' lane width and rows
SALT = 1e-6                       # bench_salted's salt at its first run

# the TPU probes' sizes (tools/microbench_tpu.py:57, 104, 152, 234)
FMA_GRID = 64
FMA_N = FMA_GRID * ROWS * T       # one thread per element of the output
FMA_CASES = ((8, 256), (4, 512), (1, 2048))     # (streams, iters)
FMA_MODES = ("mul_add", "fma", "sqrt", "div", "rcp")
DOT_KINDS = ("pair", "pairT", "payload")
DOT_ROUTES = ("fp32", "tf32", "3xtf32")
DOT_ITERS, DOT_GRID = 512, 16
DOT_SHAPES = {"pair": ((ROWS, 8), (8, T), (ROWS, T)),
              "pairT": ((8, ROWS), (8, T), (ROWS, T)),
              "payload": ((8, ROWS), (ROWS, T), (8, T))}
REDUCE_DTYPES = {"f32": F32, "int32": I32}
REDUCE_WAYS = ("serial", "shuffle", "redux")
# lanes a column of each way (csrc/microbench.cu kShuffleLanes, kReduxLanes)
REDUCE_LANES = {"serial": 1, "shuffle": 8, "redux": 32}
REDUCE_ITERS, REDUCE_GRID = 512, 16
VISIT_WAYS = ("thread", "lanes")
# k of the lanes way (csrc/microbench.cu kVisitLanes): the card's sweep at
# 4,096 rays (probes/m4m5_turns.py, docs/M4M5_TURNS_H100.json)
VISIT_LANES = 32
# the k a lanes way may be built with: a power of two that divides a warp
LANE_COUNTS = (2, 4, 8, 16, 32)
VISIT_ITERS = 256
VISIT_RAYS = (16 * T, 256 * 256, 1 << 20)   # the TPU's grid, the soup's 256^2, ~1000^2
VISIT_INPUTS = ("tpu", "seeded")
INPUT_SEED = 6

# the TPU kernel each probe replaces
REPLACES = {"M1": "tools/microbench_tpu.py:44", "M2": "tools/microbench_tpu.py:75",
            "M3": "tools/microbench_tpu.py:134", "M4": "tools/microbench_tpu.py:170",
            "M5": "tools/microbench_v5.py:50", "M6": "tools/microbench_v5.py:135",
            "M7": "tools/microbench_mxuquad.py:44"}
# the kernel library of render/_cuda.py that holds each probe
KERNEL_OF = {"M1": "microbench", "M2": "microbench", "M3": "microbench",
             "M4": "microbench", "M5": "microbench_v5", "M6": "microbench_v5",
             "M7": "microbench_mxuquad"}

# H100 SXM published peaks at a 700 W power limit (NVIDIA's data sheet):
# FP32_LANE_OPS_PER_S and HBM_BYTES_PER_S (utils/profiling.py), 495 TFLOP/s
# dense TF32; 132 SMs
TF32_FLOPS_PER_S = 495e12
N_SMS = 132

RECORD = Path(__file__).resolve().parents[2] / "docs" / "MICROBENCH_H100.json"
LAUNCHES: collections.Counter = collections.Counter()


class ProbeMismatch(RuntimeError):
    """A probe's kernel disagrees with its plain version."""


def _c(v, like: torch.Tensor, dtype=F32) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=like.device)


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _on_card(*ts: torch.Tensor) -> bool:
    """False where every tensor is on the CPU (the plain version runs), True
    where every one is a contiguous CUDA tensor; raises otherwise."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}: all "
                         "on one CUDA card, or all on the CPU")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the probes take contiguous tensors")
    return True


def _expect(t: torch.Tensor, shape, dtype, what: str) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{what}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _launch(label, out, *args, kernel="microbench"):
    """Launch ``kernel``'s C entry point with ``args`` (tensors and None as
    pointers, ints as they are) and the current stream of ``out``'s card;
    count the launch under ``label``; return ``out``."""
    from ..render import _cuda
    fn = _cuda.load(kernel)
    stream = ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream)
    rc = fn(*(_ptr(a) if a is None or isinstance(a, torch.Tensor) else a
              for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{label} launch failed: "
                           + _cuda.error_string(kernel, rc))
    LAUNCHES[label] += 1
    return out


# ---------------------------------------------------------------- M1

def fma_label(mode: str, streams: int) -> str:
    return f"M1 {mode} x{streams}"


def fma(salt: torch.Tensor, n: int, streams: int, iters: int,
        mode: str = "mul_add") -> torch.Tensor:
    """M1: ``streams`` chains a thread, each ``iters`` steps of ``mode``
    (``mul_add``: a*m + d rounded twice; ``fma``: rounded once; ``sqrt``:
    a <- sqrtf(a); ``div``: a <- m / a; ``rcp``: a <- 1 / a, the division
    the kernels issue), from a_u = salt + u, m = salt*0.5
    + 0.9999, d = salt + 1e-7; out (n,) f32, the chains' sum in order."""
    _expect(salt, (1,), F32, "salt")
    if mode not in FMA_MODES or streams not in (1, 4, 8) or iters < 0:
        raise ValueError(f"M1: mode {mode!r}, streams {streams}, iters {iters}")
    if not _on_card(salt):
        return fma_plain(salt, n, streams, iters, mode)
    out = torch.empty(n, dtype=F32, device=salt.device)
    return _launch(fma_label(mode, streams), out, 0, FMA_MODES.index(mode),
                   streams, iters, n, salt, None, None, out)


def _step(a, m, d, mode):
    if mode == "mul_add":
        return a * m + d
    if mode == "fma":
        # a*m is exact in float64, so this rounds the fused result twice
        return (a.double() * m.double() + d.double()).float()
    if mode == "sqrt":
        return vec.sqrt(a)
    if mode == "rcp":
        return torch.ones_like(a) / a
    return m / a


def fma_plain(salt, n, streams, iters, mode="mul_add"):
    """M1's recurrence in torch float32, on every element."""
    base = salt.reshape(1).expand(n)
    accs = [base + _c(float(u), salt) for u in range(streams)]
    m = base * _c(0.5, salt) + _c(0.9999, salt)
    d = base + _c(1e-7, salt)
    for _ in range(iters):
        accs = [_step(a, m, d, mode) for a in accs]
    s = accs[0]
    for a in accs[1:]:
        s = s + a
    return s.contiguous()


# ---------------------------------------------------------------- M2

def dot_label(kind: str, route: str) -> str:
    return f"M2 {kind} {route}"


def dot(salt, a, b, kind="pair", iters=DOT_ITERS, grid=DOT_GRID,
        route="fp32"):
    """M2: out[g] = sum_i (lhs + (salt + i)) . b over ``iters`` for each of
    ``grid`` tiles; lhs is ``a`` (pair, payload) or its transpose (pairT).
    ``route``: the FP32 loop, TF32 ``wgmma`` or 3xTF32.  The plain
    version of every route is the FP32 loop; the TF32 routes are held to
    the float64 sum within their rounding (``dot_tolerance``)."""
    sa, sb, so = DOT_SHAPES[kind]
    _expect(salt, (1,), F32, "salt")
    _expect(a, sa, F32, f"M2 {kind} a")
    _expect(b, sb, F32, f"M2 {kind} b")
    if route not in DOT_ROUTES or iters < 0 or grid < 1:
        raise ValueError(f"M2: route {route!r}, iters {iters}, grid {grid}")
    if not _on_card(salt, a, b):
        return dot_plain(salt, a, b, kind, iters, grid)
    out = torch.empty((grid,) + so, dtype=F32, device=a.device)
    return _launch(dot_label(kind, route), out, 1, DOT_ROUTES.index(route),
                   DOT_KINDS.index(kind), iters, grid, salt, a, b, out)


def _dot_lhs(salt, a, kind, iters):
    """(iters, M, K): lhs + (salt + i), each rounded to float32."""
    lhs = a.t() if kind == "pairT" else a
    s = salt + torch.arange(iters, dtype=F32, device=a.device)
    return lhs[None] + s[:, None, None]


def dot_plain(salt, a, b, kind="pair", iters=DOT_ITERS, grid=DOT_GRID):
    """The FP32 loop: r = sum_k lhs[:, k] * b[k] in k order, each product
    and sum rounded, then acc = acc + r iteration by iteration."""
    L = _dot_lhs(salt, a, kind, iters)
    r = L[:, :, 0:1] * b[0:1]
    for k in range(1, L.shape[2]):
        r = r + L[:, :, k:k + 1] * b[k:k + 1]
    acc = torch.zeros(r.shape[1:], dtype=F32, device=a.device)
    for i in range(iters):
        acc = acc + r[i]
    return acc.expand((grid,) + tuple(acc.shape))


def dot_reference(salt, a, b, kind="pair", iters=DOT_ITERS):
    """The float64 sum of the float32 products' exact values, the sum of
    their magnitudes, and sum_i |acc_i| bounded from above (the running
    sums the iterations add into)."""
    L = _dot_lhs(salt, a, kind, iters).double()
    bd = b.double()
    exact = L.sum(0) @ bd
    mag = L.abs().sum(0) @ bd.abs()
    w = (iters - torch.arange(iters, dtype=torch.float64, device=a.device))
    running = (w[:, None, None] * L.abs()).sum(0) @ bd.abs()
    return exact, mag, running


# per-product rounding of the TF32 routes: two operands rounded to 10
# explicit bits, (1 + 2^-11)^2 - 1; 3xTF32 drops lo*lo and rounds lo
DOT_EPS = {"tf32": 2.0 ** -10 + 2.0 ** -22, "3xtf32": 2.0 ** -19}


def dot_tolerance(route, kind, mag, running):
    """Bound on |route - float64|: the products' rounding, eps * sum|a||b|,
    plus the sums'.  A k8 wgmma step adds 8 exact TF32 products into its
    float32 sum and rounds once; the tensor cores align and truncate (not
    round to nearest), so each step is charged 2^-22 of the magnitudes
    entering it: its products (every product once, 3 times over for
    3xTF32) and the sum it adds to.  An iteration issues K/8 steps (3K/8
    for 3xTF32).

    pair, pairT (K = 8): every step adds into the one sum that runs over all
    iterations, so the sums entering them are charged ``steps * running``.
    payload (K = 128): r_i is summed by its own steps from zero, each sum
    at most sum_k |l_ik||b_k| = mag_i, so ``(split + steps) * mag``; then
    acc = acc + r_i in float32, rounded to nearest, at most 2^-24
    |acc_{i+1}| <= 2^-24 sum_{j <= i} mag_j an iteration: ``2^-24 *
    running``."""
    split = 3 if route == "3xtf32" else 1
    steps = DOT_SHAPES[kind][1][0] // 8 * split       # b is (K, N)
    if kind == "payload":
        return (DOT_EPS[route] * mag + 2.0 ** -22 * (split + steps) * mag
                + 2.0 ** -24 * running)
    return DOT_EPS[route] * mag + 2.0 ** -22 * (split * mag + steps * running)


# ---------------------------------------------------------------- M3

def reduce_label(dtype: str, way: str) -> str:
    return f"M3 {dtype} {way}"


def reduce_routes() -> list:
    """Every M3 route, (dtype, way): ``redux`` takes int32 keys only."""
    return [(d, w) for d in REDUCE_DTYPES for w in REDUCE_WAYS
            if not (w == "redux" and d == "f32")]


def reduce_min(v0, iters=REDUCE_ITERS, grid=REDUCE_GRID, way="serial"):
    """M3: acc = sum over ``iters`` of the column minima of v (128, 256),
    v += 1 after each; out (grid, 1, 256) in v0's type (float32 or int32).
    ``way``: one thread's serial loop, 8 lanes a column and a shuffle
    butterfly, or a warp a column and ``__reduce_min_sync`` (int32 only)."""
    if v0.dtype not in (F32, I32):
        raise ValueError(f"M3 takes float32 or int32 keys, not {v0.dtype}")
    _expect(v0, (ROWS, T), v0.dtype, "M3 v0")
    dname = "f32" if v0.dtype == F32 else "int32"
    if (dname, way) not in reduce_routes():
        raise ValueError(f"M3: way {way!r} for {dname} keys")
    if iters < 0 or grid < 1:
        raise ValueError(f"M3: iters {iters}, grid {grid}")
    if not _on_card(v0):
        return reduce_plain(v0, iters, grid)
    out = torch.empty((grid, 1, T), dtype=v0.dtype, device=v0.device)
    return _launch(reduce_label(dname, way), out, 2, REDUCE_WAYS.index(way),
                   0 if v0.dtype == F32 else 1, iters, grid, None, v0, None,
                   out)


def reduce_plain(v0, iters=REDUCE_ITERS, grid=REDUCE_GRID):
    v = v0
    acc = torch.zeros(T, dtype=v0.dtype, device=v0.device)
    for _ in range(iters):
        acc = acc + v.amin(0)
        v = v + 1
    return acc.reshape(1, 1, T).expand(grid, 1, T)


# ---------------------------------------------------------------- M4

def visit_label(way: str, n_rays: int) -> str:
    return f"M4 {way} {n_rays}"


def visit(salt, sphT, sph8, n_rays, iters=VISIT_ITERS, way="thread"):
    """M4: ``iters`` visits of the 128 spheres of ``sphT`` (128, 8) by
    ``n_rays`` fake rays (lane j % 256 of tools/microbench_tpu.py:175-191),
    the table shifted by salt * i at visit i; out (n_rays / 256, 8, 256) =
    the winner's 8 fields of ``sph8`` (8, 128) + float(krun).  ``way``: one
    thread per ray, or ``VISIT_LANES`` lanes a ray (the C entry's code is
    the lanes a ray)."""
    _expect(salt, (1,), F32, "salt")
    _expect(sphT, (ROWS, 8), F32, "M4 sphT")
    _expect(sph8, (8, ROWS), F32, "M4 sph8")
    if way not in VISIT_WAYS or n_rays < T or n_rays % T or iters < 0:
        raise ValueError(f"M4: way {way!r}, {n_rays} rays, iters {iters}")
    if not _on_card(salt, sphT, sph8):
        return visit_plain(salt, sphT, sph8, n_rays, iters)
    out = torch.empty((n_rays // T, 8, T), dtype=F32, device=salt.device)
    return _launch(visit_label(way, n_rays), out, 3,
                   1 if way == "thread" else VISIT_LANES, 0, iters, n_rays,
                   salt, sphT, sph8, out)


def _fake_rays(salt):
    """The TPU probe's per-lane ray terms: gq, gl (8 rows each), p, pc and
    1/a, as (256,) float32 tensors."""
    lid = torch.arange(T, dtype=F32, device=salt.device)
    c = lambda v: _c(v, salt)                                # noqa: E731
    ox = lid * c(1e-3) + salt
    oy = lid * c(2e-3)
    oz = torch.full((T,), 30.0, dtype=F32, device=salt.device)
    dx = lid * c(1e-4) + c(0.1)
    dy = lid * c(-1e-4) + c(0.2)
    dz = torch.full((T,), -1.0, dtype=F32, device=salt.device)
    a = (dx * dx + dy * dy) + dz * dz
    p = (ox * dx + oy * dy) + oz * dz
    m2 = (ox * ox + oy * oy) + oz * oz
    pc = p * p - a * m2
    a2, p2 = c(2.0) * a, c(2.0) * p
    z = torch.zeros_like(lid)
    gq = [dx, dy, dz, z, z, z, z, z]
    gl = [a2 * ox - p2 * dx, a2 * oy - p2 * dy, a2 * oz - p2 * dz,
          z, z, z, z, -a]
    return gq, gl, p, pc, c(1.0) / a


def visit_state_plain(salt, sphT, sph8, iters=VISIT_ITERS):
    """The visit loop over one tile of 256 rays: krun (256,) int32 and pay
    (8, 256) float32 after ``iters`` visits (every tile is the same)."""
    gq, gl, p, pc, inv_a = _fake_rays(salt)
    eps, big = _c(0.1, salt), _c(1e9, salt)
    rows = torch.arange(ROWS, dtype=I32, device=salt.device)[:, None]
    krun = torch.full((T,), 0x7F000000, dtype=I32, device=salt.device)
    pay = torch.zeros((8, T), dtype=F32, device=salt.device)
    for i in range(iters):
        lhs = sphT + salt * _c(float(i), salt)
        q = lhs[:, 0:1] * gq[0]
        ll = lhs[:, 0:1] * gl[0]
        for k in range(1, 8):
            q = q + lhs[:, k:k + 1] * gq[k]
            ll = ll + lhs[:, k:k + 1] * gl[k]
        disc = (q * q + ll) + pc
        pos = disc > 0
        sq = vec.sqrt(torch.where(pos, disc, _c(1.0, salt)))
        qp = q - p
        t0 = (qp - sq) * inv_a
        t1 = (qp + sq) * inv_a
        t = torch.where(t0 > eps, t0, t1)
        tv = torch.where(pos & (t > eps), t, big)
        key = (tv.view(I32) & ~0x7F) | rows
        kmin = key.amin(0)
        better = kmin < krun
        pay = torch.where(better, sph8[:, (kmin & 0x7F).long()], pay)
        krun = torch.where(better, kmin, krun)
    return krun, pay


def visit_plain(salt, sphT, sph8, n_rays, iters=VISIT_ITERS):
    krun, pay = visit_state_plain(salt, sphT, sph8, iters)
    return (pay + krun.float()).expand(n_rays // T, 8, T)


def visit_inputs(kind: str, seed: int = INPUT_SEED):
    """(sphT (128, 8), sph8 (8, 128)) float32 numpy arrays.  ``tpu``: the
    TPU probe's 0.1 and 0.2 fills (every row alike, so row 0 always wins);
    ``seeded``: 128 spheres placed along the fake rays' paths, 3 to 40
    units ahead, radii 0.02 to 0.1, so rows win unevenly and lanes of a warp
    take different winners."""
    if kind == "tpu":
        return (np.full((ROWS, 8), 0.1, np.float32),
                np.full((8, ROWS), 0.2, np.float32))
    rng = np.random.default_rng(seed)
    lid = rng.uniform(0.0, T - 1.0, ROWS)
    t = rng.uniform(3.0, 40.0, ROWS)
    o = np.stack([lid * 1e-3, lid * 2e-3, np.full(ROWS, 30.0)], 1)
    d = np.stack([lid * 1e-4 + 0.1, lid * -1e-4 + 0.2, -np.ones(ROWS)], 1)
    c = o + t[:, None] * d + rng.normal(0.0, 0.05, (ROWS, 3))
    r = rng.uniform(0.02, 0.1, ROWS)
    sphT = np.zeros((ROWS, 8))
    sphT[:, :3] = c
    sphT[:, 7] = (c * c).sum(1) - r * r
    sph8 = np.zeros((8, ROWS))
    sph8[:3] = c.T
    sph8[3] = r
    sph8[4:7] = rng.uniform(0.0, 1.0, (3, ROWS))
    return sphT.astype(np.float32), sph8.astype(np.float32)


# ---------------------------------------------------------------- bounds

def _bound(ops: float, nbytes: float, rate: float = FP32_LANE_OPS_PER_S):
    ops_ms = ops / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


# The recounted bounds of M1, M3 and M6: the work counted on the pipe or
# path that limits it, whatever implements it, at the rates of the CUDA C++
# Programming Guide's table of arithmetic instruction throughput (results
# per clock cycle per multiprocessor) for compute capability 9.0: "32-bit
# floating-point add, multiply, multiply-add" 128 (fp32); "compare,
# minimum, maximum" 64 (minmax); "32-bit integer add, extended-precision
# add, subtract, extended-precision subtract" 64 (int_add); "32-bit
# floating-point reciprocal, reciprocal square root, ..." 16 (mufu, the unit
# that also issues sqrtf's MUFU.RSQ and, by its measured rate, FCHK); and
# the L1 cache and shared memory's 128 bytes a cycle (l1_bytes).  Each row
# is its own limit (the table does not say which rows share a unit), so the
# bound is the slowest row, or HBM's bytes where that is slower.  The clock
# is clocks.sm as every sampled window held it (docs/MICROBENCH_H100.json,
# docs/MICROBENCH_V5_H100.json: 1980 MHz); at it, fp32's row is the data
# sheet's 33.5e12 lane operations a second within 0.2%.
# M4's and M5's visits add L1's wavefronts (l1_wavefronts): one a cycle an
# SM, a 16-byte unit from each of 8 bank groups (``visit_load_model``).
SM_CLOCK_HZ = 1.98e9
PIPE_PER_CYCLE = {"fp32": 128, "minmax": 64, "int_add": 64, "mufu": 16,
                  "l1_bytes": 128, "l1_wavefronts": 1}
# the rows of the memory path: a bound on one of them is "bytes"
MEMORY_ROWS = ("l1_bytes", "l1_wavefronts", "hbm_bytes")


def pipe_terms(counts: dict, nbytes: float) -> dict:
    """{row: ms} of work ``counts`` {row of ``PIPE_PER_CYCLE``: lane
    operations, bytes for l1_bytes, wavefronts for l1_wavefronts}, each at
    its rate on every SM, and ``nbytes`` read from and written to HBM at
    HBM's rate (hbm_bytes)."""
    terms = {row: c / (PIPE_PER_CYCLE[row] * N_SMS * SM_CLOCK_HZ) * 1e3
             for row, c in counts.items()}
    terms["hbm_bytes"] = nbytes / HBM_BYTES_PER_S * 1e3
    return terms


def pipe_bound(counts: dict, nbytes: float) -> tuple[float, str, str]:
    """(ms, "operations" or "bytes", the limiting row) of ``pipe_terms``:
    the slowest row."""
    terms = pipe_terms(counts, nbytes)
    row = max(terms, key=terms.get)
    return (terms[row], "bytes" if row in MEMORY_ROWS else "operations",
            row)


def fma_work(n, streams, iters, mode):
    """Lane operations (a square root or a division as one, as the data
    sheet counts, so the time over this bound is its cost in multiply-
    equivalents) and bytes of one M1 launch."""
    per_step = 2 if mode == "mul_add" else 1
    return n * (streams * iters * per_step + 2 * streams + 2), 4 * (n + 1)


# Each M1 step's instructions by row, from the SASS in csrc/microbench.cu's
# header: FP32 (FMUL, FADD, FFMA and their .FTZ forms) and MUFU.  A
# division's FCHK is not in the table; it is counted on mufu's row because a
# division chain takes one MUFU's time more than a 1/x chain, whose step is
# the division's but for FCHK and FFMAs the FP32 pipe hides
# (``fchk_lanes_per_cycle``).  The integer range tests and branches of the
# slow-path checks go to other pipes, below MUFU's time.
FMA_STEP_PIPES = {"mul_add": {"fp32": 2}, "fma": {"fp32": 1},
                  "sqrt": {"fp32": 4, "mufu": 1},
                  "rcp": {"fp32": 3, "mufu": 1},
                  "div": {"fp32": 5, "mufu": 2}}


def fma_pipes(n, streams, iters, mode):
    """Lane operations by row of one M1 launch: the steps' SASS, and each
    thread's set-up and sum (2 streams + 2) on fp32."""
    steps = n * streams * iters
    counts = {row: steps * c for row, c in FMA_STEP_PIPES[mode].items()}
    counts["fp32"] += n * (2 * streams + 2)
    return counts


def fma_issue_share(fp32: int, other: int, fp32_cycles: float = 1) -> float:
    """The share of the FP32 pipe a pass of M1's step loop can reach where a
    scheduler issues one warp instruction a cycle: ``fp32`` FP32
    instructions a pass, each taking ``fp32_cycles`` issue cycles (2 where
    an FFMA reads three registers of the register file's two banks and no
    reuse serves one), and ``other`` instructions a pass (the counter, the
    compare and the branch), one cycle each."""
    return fp32 / (fp32_cycles * fp32 + other)


def fchk_lanes_per_cycle(m1) -> float:
    """FCHK's rate in lanes a cycle an SM, from M1's 8-stream division and
    1/x chains of one run (``run_m1``'s entries): the division's time over
    1/x's is its FCHK, one a step, at the division entry's sampled clock."""
    by = {(e["mode"], e["streams"]): e for e in m1}
    div, rcp = by["div", 8], by["rcp", 8]
    mhz = div["clocks_sm_mhz"] or SM_CLOCK_HZ / 1e6
    steps = FMA_N * 8 * div["iters"]
    return steps / ((div["ms"] - rcp["ms"]) * 1e-3) / (N_SMS * mhz * 1e6)


def dot_work(kind, route, iters, grid):
    """The function's work: FP32 lane operations (the lhs adds, K products
    and K - 1 sums a product, the running sum) or, for the TF32 routes,
    tensor-core flops (2MNK a product, 3x for 3xTF32) with their own
    peak; and the bytes of a, b and the output."""
    (ma, ka), (kb, nb), (mo, no) = DOT_SHAPES[kind]
    m, k, n = mo, kb, no
    nbytes = 4 * (ma * ka + kb * nb + grid * mo * no + 1)
    per = grid * iters
    if route == "fp32":
        return per * (m * k + 2 * m * n * k), nbytes, FP32_LANE_OPS_PER_S
    flops = 2 * m * n * k * (3 if route == "3xtf32" else 1)
    return per * flops, nbytes, TF32_FLOPS_PER_S


def reduce_work(iters, grid, itemsize=4):
    """Per tile and iteration: 127 minima and one running add a column,
    and the 128 x 256 increments; bytes of v0 and the output.  int32 keys
    are charged at the FP32 lane rate: the data sheet gives no int32
    rate."""
    return (grid * iters * (ROWS * T + (ROWS - 1) * T + T),
            itemsize * (ROWS * T + grid * T))


def reduce_pipes(iters, grid, dtype):
    """Lane operations by row of one M3 launch: 127 minima a column and
    iteration on minmax; the 128 increments and the running add on fp32
    (float32 keys) or int_add (int32)."""
    tiles = grid * iters
    return {"minmax": tiles * (ROWS - 1) * T,
            "fp32" if dtype == "f32" else "int_add": tiles * (ROWS + 1) * T}


# lane operations of one (ray, sphere row) test of M4, each float32 add,
# multiply, comparison, select and the key's and, or and minimum as one:
# q 15, ll 15, disc 3, disc > 0 1, its select 1, q - p 1, t0 2, t1 2,
# t0 > eps 1, t's select 1, t > eps 1, tv's select 1, the key 3 = 47, plus
# the square root at its measured weight; per ray and visit the winner's
# test and 9 selects (10); per tile and visit the table shift, 8 x 128 adds
# and the salt's product; per ray its set-up (36 and 1/a) and output (9)
VISIT_ROW_OPS, VISIT_RAY_VISIT_OPS, VISIT_RAY_OPS = 47, 10, 45


def visit_work(n_rays, iters, sqrt_ops, div_ops):
    per_visit = ROWS * (VISIT_ROW_OPS + sqrt_ops) + VISIT_RAY_VISIT_OPS
    tiles = n_rays // T
    ops = (n_rays * iters * per_visit + tiles * iters * (8 * ROWS + 1)
           + n_rays * (VISIT_RAY_OPS + div_ops))
    return ops, 4 * (ROWS * 8 + 8 * ROWS + 8 * n_rays + 1)


# The fields of a table row one (ray, row) test uses: M4's row_key all 8,
# M5's row_bc cx, cy, cz and r^2 (microbench_v5.VISIT_FIELDS).
VISIT_FIELDS = tuple(range(8))
VISIT_LAYOUTS = ("slot", "field")


def visit_load_model(k: int, layout: str, fields, rows: int = ROWS) -> float:
    """L1 wavefronts for every 32 (ray, row) tests of a visit at ``k``
    lanes a ray, where lane l of a warp tests rows l % k + k e at step e
    and a test reads ``fields`` of its row: from the ``slot``-major (rows,
    8) table, 32 bytes a row, one load a 16-byte half that holds any of
    them (the kernels' float4 and 4-byte ``__ldg``); or from the
    ``field``-major (8, rows) copy, a 4-byte load a field.  By
    ``m3m6_turns.load_model``'s rule: L1 serves a 16-byte unit from each of
    8 bank groups a wavefront, lanes at one unit share it, lanes at
    distinct units in one group take one each.  Averaged over the steps; a
    step is 32 tests."""
    if k not in (1, *LANE_COUNTS) or rows % k or layout not in VISIT_LAYOUTS:
        raise ValueError(f"visit_load_model: k {k}, {layout!r}, rows {rows}")
    lane = np.arange(32) % k
    if layout == "slot":     # (base, bytes a row, offset) of each load
        loads = [(0, 32, 16 * h) for h in sorted({f // 4 for f in fields})]
    else:
        loads = [(4 * f * rows, 4, 0) for f in sorted(set(fields))]
    steps = rows // k
    waves = 0
    for e in range(steps):
        row = lane + k * e
        for base, stride, at in loads:
            units = set(((base + stride * row + at) // 16).tolist())
            waves += max(collections.Counter(u % 8 for u in units).values())
    return waves / steps


def visit_tests(n_rays, iters, rows=ROWS) -> int:
    return n_rays * iters * rows


def visit_least_wavefronts(fields, rows=ROWS) -> float:
    """The fewest L1 wavefronts for 32 tests that any route's loads of
    ``fields`` take (``visit_load_model`` at its best k and layout): what
    the function needs, whichever route reads the table."""
    return min(visit_load_model(k, layout, fields, rows)
               for k in (1, *LANE_COUNTS) for layout in VISIT_LAYOUTS)


def visit_pipes(n_rays, iters, sqrt_ops, div_ops):
    """M4 by row (``pipe_bound``): every lane operation of ``visit_work``
    on fp32 (a root and 1/a at M1's multiply-equivalents, as the operations
    bound counts them) and the fewest L1 wavefronts its table loads need
    (``visit_least_wavefronts``)."""
    return {"fp32": visit_work(n_rays, iters, sqrt_ops, div_ops)[0],
            "l1_wavefronts": visit_tests(n_rays, iters) / 32
            * visit_least_wavefronts(VISIT_FIELDS)}


def visit_route_ms(tests, lanes, layout, fields, rows=ROWS) -> float:
    """A route's own L1 time: ``tests`` (ray, row) tests at
    ``visit_load_model(lanes, layout, fields, rows)`` wavefronts for 32,
    one a cycle an SM.  M4's and M5's entries keep it in ``pipe_ms`` as
    ``l1_route``, a diagnostic beside the bound's rows."""
    waves = tests / 32 * visit_load_model(lanes, layout, fields, rows)
    return pipe_terms({"l1_wavefronts": waves}, 0)["l1_wavefronts"]


# ---------------------------------------------------------------- timing

def _timed(fn, min_window_ms=150.0, min_runs=3, max_runs=2000):
    """(mean ms over a window of at least ``min_window_ms``, the output of
    the warm-up call, (host start, host end) of the window)."""
    from ..utils.timing import cuda_ms
    out = fn()
    one = cuda_ms(fn, warmup=0, runs=1)
    runs = int(min(max_runs, max(min_runs, math.ceil(min_window_ms
                                                    / max(one, 1e-3)))))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ms = cuda_ms(fn, warmup=0, runs=runs)
    return ms, out, (t0, time.monotonic()), runs


# a window under this is near the host's cost of a call: such an entry also
# carries the device's own time (``_device_entry``); M4's and M5's visits
# and M1's chains carry it under a millisecond, where the host's cost is a
# few percent
DEVICE_MS_BELOW = 0.05
VISIT_DEVICE_MS_BELOW = M1_DEVICE_MS_BELOW = 1.0


def _device_entry(fn, window_ms, below=DEVICE_MS_BELOW) -> dict:
    """The device's own time of a call (``utils.profiling.device_ms``)
    where ``window_ms`` is under ``below``."""
    return (dict(device_ms=device_ms(fn, window_ms, clock_hz=SM_CLOCK_HZ))
            if window_ms < below else {})


def _device_note(e) -> str:
    return (f"; device {e['device_ms']:.4f} ms" if "device_ms" in e
            else "")


def _plain_timed(fn):
    """The plain version's output and its time, once, with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


class ClockSampler:
    """``nvidia-smi`` sampling clocks.sm and power.draw every 50 ms while
    the block runs, each sample stamped with the host's monotonic clock."""

    def __enter__(self):
        self.samples: list[tuple[float, float, float]] = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        time.sleep(0.5)               # the first samples are slow to come
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                mhz, watts = (float(v) for v in line.split(","))
            except ValueError:
                continue
            self.samples.append((time.monotonic(), mhz, watts))

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)
        return False

    def within(self, window) -> list[tuple[float, float]]:
        t0, t1 = window
        return [(m, w) for t, m, w in self.samples if t0 <= t <= t1]


def _max_err(out, ref) -> float:
    if out.dtype == F32:
        d = (out.double() - ref.double()).abs()
        return float(torch.nan_to_num(d, nan=math.inf).max())
    return float((out.long() - ref.long()).abs().max())


def _bit_equal(label, out, ref):
    ai = out.view(I32) if out.dtype == F32 else out
    bi = ref.view(I32) if ref.dtype == F32 else ref
    bad = (ai != bi).nonzero()
    if bad.numel():
        idx = tuple(bad[0].tolist())
        raise ProbeMismatch(f"{label}: kernel {out[idx].item()!r} plain "
                            f"{ref[idx].item()!r} at {idx}")


# ---------------------------------------------------------------- runs

def _entry(probe, name, label, ms, runs, work, plain_ms, max_err,
           library_ms=None, pipes=None, **extra):
    """A probe record's entry.  ``work`` is (lane operations, bytes, rate);
    with ``pipes`` (a row count for ``pipe_bound``) the bound is recounted
    by row, and the one from ``work`` stays beside it as ``old_*``."""
    ops, nbytes, rate = work
    bound_ms, bound_by = _bound(ops, nbytes, rate)
    if pipes is not None:
        extra.update(old_bound_ms=bound_ms, old_bound_by=bound_by,
                     old_share=bound_ms / ms, pipes=pipes,
                     pipe_ms=pipe_terms(pipes, nbytes))
        bound_ms, bound_by, extra["bound_row"] = pipe_bound(pipes, nbytes)
    return dict(probe=probe, name=name, label=label, ms=ms, runs=runs,
                ops=ops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                share=bound_ms / ms, plain_ms=plain_ms, max_abs_err=max_err,
                library_ms=library_ms, **extra)


def fma_refs(dev) -> dict:
    """{label: (``fma_plain``'s output, its ms)} of every M1 variant at the
    TPU probe's size on ``dev``."""
    salt = torch.tensor([SALT], dtype=F32, device=dev)
    return {fma_label(mode, streams): _plain_timed(
        lambda: fma_plain(salt, FMA_N, streams, iters, mode))
        for mode in FMA_MODES for streams, iters in FMA_CASES}


def run_m1(dev, clocks: ClockSampler | None, log=print):
    """Every M1 variant at the TPU probe's size: timed, with the device's
    own time under ``M1_DEVICE_MS_BELOW``, held against ``fma_plain``
    (raises ``ProbeMismatch``), with its bound by pipe."""
    return _run_m1(dev, clocks, log)


def _run_m1(dev, clocks, log, refs=None):
    """``run_m1``, the plain versions' outputs and times taken from
    ``refs`` (``fma_refs``) where given: a probe of several builds in turns
    forms them once."""
    salt = torch.tensor([SALT], dtype=F32, device=dev)
    out = []
    for mode in FMA_MODES:
        for streams, iters in FMA_CASES:
            label = fma_label(mode, streams)
            call = lambda: fma(salt, FMA_N, streams, iters, mode)  # noqa: E731
            ms, y, window, runs = _timed(call)
            ref, plain_ms = (refs[label] if refs else _plain_timed(
                lambda: fma_plain(salt, FMA_N, streams, iters, mode)))
            err = _max_err(y, ref)
            tol = None
            if mode == "fma":
                # double rounding: at most an ulp a step, and the sum's
                tol = (iters + streams) * 2.0 ** -23 * float(ref.abs().max())
                if not err <= tol:
                    raise ProbeMismatch(f"{label}: {err} > {tol}")
            else:
                _bit_equal(label, y, ref)
            ops, nbytes = fma_work(FMA_N, streams, iters, mode)
            steps = FMA_N * streams * iters
            lane_ops = steps * (2 if mode == "mul_add" else 1)
            rate = lane_ops / (ms * 1e-3)
            mhz = [m for m, _ in clocks.within(window)] if clocks else []
            clk = statistics.median(mhz) if mhz else None
            e = _entry("M1", f"{label} ({iters} iters)", label, ms, runs,
                       (ops, nbytes, FP32_LANE_OPS_PER_S), plain_ms, err,
                       pipes=fma_pipes(FMA_N, streams, iters, mode),
                       streams=streams, iters=iters, mode=mode,
                       lane_ops_per_s=rate,
                       share_of_peak=rate / FP32_LANE_OPS_PER_S,
                       clocks_sm_mhz=clk,
                       per_sm_per_cycle=(rate / (N_SMS * clk * 1e6)
                                         if clk else None),
                       watts=(statistics.median(w for _, w in
                                                clocks.within(window))
                              if mhz else None),
                       tolerance=tol,
                       **_device_entry(call, ms, M1_DEVICE_MS_BELOW))
            log(f"[probe] {label}: {ms:.4f} ms ({runs} runs"
                f"{_device_note(e)}), {rate:.4e} lane ops/s = "
                f"{rate / FP32_LANE_OPS_PER_S:.4f} of 33.5e12, "
                f"{e['per_sm_per_cycle']} /SM/cycle at {clk} MHz; bound "
                f"{e['bound_ms']:.4f} on {e['bound_row']} "
                f"({e['share']:.4f}; old {e['old_bound_ms']:.4f}, "
                f"{e['old_share']:.4f}); plain {plain_ms:.2f} ms, err {err}")
            out.append(e)
    return out


def mul_equivalents(m1) -> dict:
    """sqrtf, division and reciprocal at 8 streams in multiply-
    equivalents: the uncontracted loop's lane-op rate over the operation's
    rate."""
    by = {(e["mode"], e["streams"]): e for e in m1}
    base = by["mul_add", 8]["lane_ops_per_s"]
    return {op: base / by[op, 8]["lane_ops_per_s"]
            for op in ("sqrt", "div", "rcp")}


def measure_mul_equivalents(device=None) -> dict:
    """``mul_equivalents`` from M1's 8-stream loops alone, timed on the
    card (no plain version, no clocks)."""
    dev = resolve_device(device)
    salt = torch.tensor([SALT], dtype=F32, device=dev)
    streams, iters = FMA_CASES[0]
    m1 = []
    for mode in ("mul_add", "sqrt", "div", "rcp"):
        ms = _timed(lambda: fma(salt, FMA_N, streams, iters, mode),
                    min_window_ms=50.0)[0]
        lane_ops = FMA_N * streams * iters * (2 if mode == "mul_add" else 1)
        m1.append(dict(mode=mode, streams=streams,
                       lane_ops_per_s=lane_ops / (ms * 1e-3)))
    return mul_equivalents(m1)


def _dot_inputs(kind, which, dev):
    sa, sb, _ = DOT_SHAPES[kind]
    if which == "tpu":
        return (torch.full(sa, 0.5, dtype=F32, device=dev),
                torch.full(sb, 0.25, dtype=F32, device=dev))
    rng = np.random.default_rng(INPUT_SEED + DOT_KINDS.index(kind))
    return (torch.from_numpy(rng.uniform(-1, 1, sa).astype(np.float32)).to(dev),
            torch.from_numpy(rng.uniform(-1, 1, sb).astype(np.float32)).to(dev))


def library_precision(route: str) -> str:
    """The precision M2's library call is timed at for ``route``: TF32 for
    the TF32 route, full float32 for the FP32 loop and 3xTF32."""
    return "tf32" if route == "tf32" else "fp32"


def _bmm_ms(salt, a, b, kind, precision):
    """The library call: torch.bmm over the same grid x iters products in
    one call, in full float32 (``allow_tf32`` False) or in TF32 (True); the
    setting found is restored."""
    from ..utils.timing import cuda_ms
    L = _dot_lhs(salt, a, kind, DOT_ITERS).repeat(DOT_GRID, 1, 1)
    B = b.expand(L.shape[0], *b.shape)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        return cuda_ms(lambda: torch.bmm(L, B), warmup=1, runs=5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def run_m2(dev, log=print, hold=True):
    """Every M2 kind and route, timed, with its error against the plain
    version (FP32) or the float64 sum (TF32 routes); ``hold`` raises
    ``ProbeMismatch`` when the FP32 loop is not bit-equal to ``dot_plain``
    or a TF32 route lies outside ``dot_tolerance``."""
    salt = torch.tensor([SALT], dtype=F32, device=dev)
    out = []
    for kind in DOT_KINDS:
        lib_ms = {prec: _bmm_ms(salt, *_dot_inputs(kind, "tpu", dev), kind,
                                prec) for prec in ("fp32", "tf32")}
        refs = {}
        for which in ("tpu", "seeded"):
            a, b = _dot_inputs(kind, which, dev)
            plain, plain_ms = _plain_timed(
                lambda: dot_plain(salt, a, b, kind, DOT_ITERS, DOT_GRID))
            refs[which] = (a, b, plain, plain_ms,
                           dot_reference(salt, a, b, kind, DOT_ITERS))
        for route in DOT_ROUTES:
            label = dot_label(kind, route)
            errs, shares, times = [], [], {}
            for which in ("tpu", "seeded"):
                a, b, plain, plain_ms, (exact, mag, running) = refs[which]
                ms, y, _, runs = _timed(
                    lambda: dot(salt, a, b, kind, DOT_ITERS, DOT_GRID, route),
                    min_window_ms=50.0)
                times[which] = ms
                if route == "fp32":
                    if hold:
                        _bit_equal(f"{label} ({which})", y, plain)
                    errs.append(_max_err(y, plain))
                    continue
                gap = (y.double() - exact).abs()
                tol = dot_tolerance(route, kind, mag, running)
                if hold and not bool((gap <= tol).all()):
                    g = int((gap - tol).argmax())
                    raise ProbeMismatch(
                        f"{label} ({which}): |kernel - float64| "
                        f"{gap.flatten()[g].item():.3e} > bound "
                        f"{tol.flatten()[g].item():.3e}")
                errs.append(float(gap.max()))
                shares.append(float((gap / (DOT_EPS[route] * mag)
                                     .expand_as(gap)).max()))
            prec = library_precision(route)
            e = _entry("M2", label, label, times["tpu"], runs,
                       dot_work(kind, route, DOT_ITERS, DOT_GRID),
                       refs["tpu"][3], max(errs), lib_ms[prec], kind=kind,
                       route=route, library_precision=prec,
                       ms_seeded=times["seeded"],
                       ns_per_product=times["tpu"] * 1e6
                       / (DOT_GRID * DOT_ITERS),
                       err_share_of_product_term=(max(shares) if shares
                                                  else None))
            log(f"[probe] {label}: {e['ms']:.4f} ms "
                f"({e['ns_per_product']:.2f} ns a product; seeded "
                f"{e['ms_seeded']:.4f}), bound {e['bound_ms']:.4f} by "
                f"{e['bound_by']}, bmm ({prec}) {e['library_ms']:.4f} ms; "
                f"err {e['max_abs_err']}"
                f" ({e['err_share_of_product_term']} of eps.sum|a||b|)")
            out.append(e)
    return out


def _reduce_inputs(dtype, which, dev):
    if which == "tpu":
        v = (torch.full((ROWS, T), SALT, dtype=F32) if dtype == "f32"
             else torch.full((ROWS, T), 7, dtype=I32))
    else:
        rng = np.random.default_rng(INPUT_SEED)
        v = (torch.from_numpy(rng.uniform(-100, 100, (ROWS, T))
                              .astype(np.float32)) if dtype == "f32" else
             torch.from_numpy(rng.integers(-10 ** 6, 10 ** 6, (ROWS, T))
                              .astype(np.int32)))
    return v.to(dev)


def run_m3(dev, log=print):
    """Every M3 route (``reduce_routes()``), on the TPU probe's keys and
    the seeded ones: timed, with the device's own time where the window's
    is under ``DEVICE_MS_BELOW``, and bit-equal to ``reduce_plain`` (raises
    ``ProbeMismatch``)."""
    from ..utils.timing import cuda_ms
    out = []
    for dtype in REDUCE_DTYPES:
        v_tpu = _reduce_inputs(dtype, "tpu", dev)
        # the library call: torch.amin(dim=1) over the grid x iters blocks
        batch = (v_tpu[None] + torch.arange(REDUCE_ITERS, device=dev)
                 .to(v_tpu.dtype)[:, None, None]).repeat(REDUCE_GRID, 1, 1)
        lib_ms = cuda_ms(lambda: torch.amin(batch, dim=1), warmup=1, runs=5)
        del batch
        refs = {w: _plain_timed(lambda: reduce_plain(
            _reduce_inputs(dtype, w, dev), REDUCE_ITERS, REDUCE_GRID))
            for w in ("tpu", "seeded")}
        for way in (w for d, w in reduce_routes() if d == dtype):
            label = reduce_label(dtype, way)
            times, calls = {}, {}
            for which in ("tpu", "seeded"):
                v = _reduce_inputs(dtype, which, dev)
                calls[which] = lambda v=v: reduce_min(  # noqa: E731
                    v, REDUCE_ITERS, REDUCE_GRID, way)
                ms, y, _, runs = _timed(calls[which], min_window_ms=50.0)
                _bit_equal(f"{label} ({which})", y, refs[which][0])
                times[which] = ms
            e = _entry("M3", label, label, times["tpu"], runs,
                       (*reduce_work(REDUCE_ITERS, REDUCE_GRID),
                        FP32_LANE_OPS_PER_S), refs["tpu"][1], 0.0, lib_ms,
                       pipes=reduce_pipes(REDUCE_ITERS, REDUCE_GRID, dtype),
                       dtype=dtype, way=way, lanes=REDUCE_LANES[way],
                       ms_seeded=times["seeded"],
                       ns_per_reduce=times["tpu"] * 1e6
                       / (REDUCE_GRID * REDUCE_ITERS),
                       **_device_entry(calls["tpu"], times["tpu"]))
            log(f"[probe] {label}: {e['ms']:.4f} ms ({e['ns_per_reduce']:.2f}"
                f" ns a (128,256) minimum; seeded {e['ms_seeded']:.4f}"
                f"{_device_note(e)}), "
                f"bound {e['bound_ms']:.4f} on {e['bound_row']} "
                f"({e['share']:.4f}; old {e['old_bound_ms']:.4f}, "
                f"{e['old_share']:.4f}), amin {lib_ms:.4f} ms, bit-equal")
            out.append(e)
    return out


def run_m4(dev, weights, log=print):
    """Every M4 way at each ray count, on the TPU probe's spheres and the
    seeded ones: timed, with the device's own time under
    ``VISIT_DEVICE_MS_BELOW``, bit-equal to ``visit_state_plain``, with its
    bound by row (``visit_pipes``)."""
    return _run_m4(dev, weights, log, {
        w: (1 if w == "thread" else VISIT_LANES,
            lambda *a, w=w: visit(*a, way=w)) for w in VISIT_WAYS})


def _run_m4(dev, weights, log, calls):
    """``run_m4`` of ``calls`` {way: (lanes a ray, a launcher (salt, sphT,
    sph8, n_rays, iters))}: this build's ways, or another build's for a
    probe of two builds in turns."""
    salt = torch.tensor([SALT], dtype=F32, device=dev)
    out = []
    for which in VISIT_INPUTS:
        sphT, sph8 = (torch.from_numpy(x).to(dev)
                      for x in visit_inputs(which))
        (krun, pay), plain_ms = _plain_timed(
            lambda: visit_state_plain(salt, sphT, sph8, VISIT_ITERS))
        tile = pay + krun.float()
        winners = int(torch.unique(krun & 0x7F).numel())
        for n_rays in VISIT_RAYS:
            for way, (lanes, fn) in calls.items():
                label = visit_label(way, n_rays)
                name = f"{label} rays ({which})"
                call = lambda: fn(salt, sphT, sph8, n_rays,  # noqa: E731
                                  VISIT_ITERS)
                ms, y, _, runs = _timed(call, min_window_ms=50.0)
                _bit_equal(name, y, tile.expand_as(y))
                visits = n_rays * VISIT_ITERS
                e = _entry("M4", name, label, ms, runs,
                           (*visit_work(n_rays, VISIT_ITERS, weights["sqrt"],
                                        weights["rcp"]),
                            FP32_LANE_OPS_PER_S), plain_ms, 0.0,
                           pipes=visit_pipes(n_rays, VISIT_ITERS,
                                             weights["sqrt"], weights["rcp"]),
                           way=way, lanes=lanes, rays=n_rays,
                           input=which,
                           winning_rows=winners,
                           ns_per_ray_visit=ms * 1e6 / visits,
                           ray_visits_per_s=visits / (ms * 1e-3),
                           **_device_entry(call, ms, VISIT_DEVICE_MS_BELOW))
                e["pipe_ms"]["l1_route"] = visit_route_ms(
                    visit_tests(n_rays, VISIT_ITERS), lanes, "slot",
                    VISIT_FIELDS)
                log(f"[probe] {name}: {ms:.4f} ms{_device_note(e)}, "
                    f"{e['ns_per_ray_visit']:.4f} ns a ray-visit "
                    f"({e['ray_visits_per_s']:.4e}/s), {_pipe_note(e)}; "
                    f"{winners} rows win; bit-equal")
                out.append(e)
    return out


def _pipe_note(e) -> str:
    """An M4 or M5 entry's bound, its share, and each row's time."""
    rows = ", ".join(f"{r} {m:.4f}" for r, m in e["pipe_ms"].items())
    return (f"bound {e['bound_ms']:.4f} ms on {e['bound_row']} "
            f"({e['share']:.4f}; {rows})")


def run(device=None, log=print) -> dict:
    """Every probe variant at the TPU probes' sizes on the card: timed,
    held against its plain version (raises ``ProbeMismatch``), with its
    bound.  M4's bound charges the square root at the multiply-equivalents
    M1 measures in the same run."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("run() measures on the card; the CPU takes "
                           "cpu_smoke()")
    card = _smi("name,power.limit")
    log(f"[probe] {card}")
    t0 = time.perf_counter()
    with ClockSampler() as clocks:
        m1 = run_m1(dev, clocks, log)
        samples = [m for _, m, _ in clocks.samples]
    weights = mul_equivalents(m1)
    fchk = fchk_lanes_per_cycle(m1)
    log(f"[probe] sqrtf {weights['sqrt']:.3f}, division {weights['div']:.3f},"
        f" 1/x {weights['rcp']:.3f} multiply-equivalents (8 streams); FCHK "
        f"{fchk:.2f} lanes a cycle an SM")
    m2 = run_m2(dev, log)
    m3 = run_m3(dev, log)
    m4 = run_m4(dev, weights, log)
    log(f"[probe] all probes in {time.perf_counter() - t0:.1f} s")
    return dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                clocks_sm_mhz=dict(
                    min=min(samples, default=None),
                    median=statistics.median(samples) if samples else None,
                    max=max(samples, default=None), samples=len(samples)),
                peaks=dict(fp32_lane_ops_per_s=FP32_LANE_OPS_PER_S,
                           tf32_flops_per_s=TF32_FLOPS_PER_S,
                           hbm_bytes_per_s=HBM_BYTES_PER_S),
                mul_equivalents=weights, fchk_lanes_per_cycle=fchk,
                entries=m1 + m2 + m3 + m4)


def cpu_smoke(log=print) -> dict:
    """The plain versions at a small size on the CPU; nothing is timed."""
    salt = torch.tensor([SALT], dtype=F32)
    res = {}
    for mode in FMA_MODES:
        res[fma_label(mode, 8)] = fma(salt, 1024, 8, 8, mode)
    for kind in DOT_KINDS:
        a, b = _dot_inputs(kind, "seeded", "cpu")
        res[dot_label(kind, "fp32")] = dot(salt, a, b, kind, iters=4, grid=1)
    for dtype in REDUCE_DTYPES:
        res[reduce_label(dtype, "serial")] = reduce_min(
            _reduce_inputs(dtype, "seeded", "cpu"), iters=4, grid=1)
    for which in VISIT_INPUTS:
        sphT, sph8 = (torch.from_numpy(x) for x in visit_inputs(which))
        res[f"M4 ({which})"] = visit(salt, sphT, sph8, T, iters=4)
    for k, v in res.items():
        log(f"[probe=cpu] {k}: {tuple(v.shape)} {v.dtype}, "
            f"finite {bool(torch.isfinite(v.float()).all())}")
    return res


# ---------------------------------------------------------------- SASS

def sass_counts(path: str) -> dict:
    """Instruction counts by opcode (FMUL, FADD, FFMA, MUFU, HMMA, HGMMA,
    SHFL, REDUX, VIMNMX3 and VIADDMNMX (Hopper's three-input int32 minimum
    and its fused add and minimum), ...; LDG.128 and LDS.128 for the
    16-byte loads) of each
    kernel in the library at ``path``, from ``cuobjdump -sass``; and the
    listing itself."""
    tool = shutil.which("cuobjdump")
    if tool is None:
        from torch.utils.cpp_extension import CUDA_HOME
        tool = str(Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts: dict = {}
    fn = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)(\S*)", line)
        if m and fn is not None:
            counts[fn][m.group(1)] += 1
            if m.group(1) in ("LDG", "LDS") and ".128" in m.group(2):
                counts[fn][m.group(1) + ".128"] += 1
    keep = ("FMUL", "FADD", "FFMA", "MUFU", "FCHK", "HMMA", "HGMMA", "SHFL",
            "REDUX", "FMNMX", "IMNMX", "VIMNMX", "VIMNMX3", "VIADDMNMX",
            "FSETP", "FSEL", "LDG",
            "LDG.128", "LDS", "LDS.128", "LDL", "STL", "BRA", "CALL")
    return {f: {k: c[k] for k in keep if c[k]} for f, c in counts.items()}, text


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracers_tpu_torch.probes.microbench",
        description="M1-M4 of tools/microbench_tpu.py on the CUDA card; "
                    "writes docs/MICROBENCH_H100.json")
    ap.add_argument("--device", default=None,
                    help="'cpu': run the plain versions at a small size "
                         "and time nothing (default: the CUDA card)")
    ap.add_argument("--out", default=str(RECORD),
                    help="where the card's record goes")
    ap.add_argument("--sass", default=None,
                    help="also write cuobjdump -sass of the probes here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        cpu_smoke()
        return 0
    from ..render import _cuda
    rec = run(dev)
    _cuda.load("microbench")
    counts, text = sass_counts(_cuda.build_info["microbench"]["path"])
    rec["sass"] = counts
    if args.sass:
        Path(args.sass).parent.mkdir(parents=True, exist_ok=True)
        Path(args.sass).write_text(text)
    Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
    print(f"[probe] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
