"""Tracing, profiling and metrics, and the operation counts of the bounds.

Counterpart of ``raytracers_tpu.utils.profiling`` over ``torch.profiler``:
``device_trace`` records CPU and CUDA activity and exports a Chrome trace
(Perfetto or chrome://tracing open it), ``device_kernel_ms`` reads the
device's kernel time by name back from such traces, ``device_profile``
sums one call's device time, busy share and idle gaps from the profiler's
events, ``device_ms`` times a call on the device's clock without the
profiler.  ``Metrics`` and ``timed`` are the JAX package's structured metrics
and wall-clock phase timer.

The rest is the roofline model of the card that every bound of the port
reads (``chip_smoke.py``, the probes): the H100's published peaks, and the
lane operations a unit of counted work of each kernel costs, broken down in
the kernel's source.  Square roots and divisions are charged at M1's
measured weights (``docs/MICROBENCH_H100.json``); the TPU's record,
``docs/MICROBENCH.json``, is never read here.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import socket
import sys
import time

import torch

from .platform import resolve_device

# ---- the card's peaks and the kernels' operation counts ----------------

# H100 SXM published peaks at a 700 W power limit: 67 TFLOP/s float32
# outside the tensor cores, i.e. 33.5e12 lane operations a second with a
# fused multiply-add counted as 2 flops; 3.35 TB/s of HBM.
FP32_LANE_OPS_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
# An IEEE square root and an IEEE division (the kernels build with
# -prec-sqrt=true -prec-div=true and divide as 1.0f / x) in multiply-
# equivalents: M1's uncontracted FMUL + FADD lane-op rate over the
# operation's rate at 8 streams (probes/microbench.py; the record
# docs/MICROBENCH_H100.json, NVIDIA H100 80GB HBM3, 700.00 W).  The bounds
# charge each at that weight; chip_smoke.py's phase 1 prints the run's own
# measurement.
SQRT_OPS = 8.78
DIV_OPS = 8.71


def _ops(plain: int, sqrt: int = 0, div: int = 0) -> float:
    """Lane operations of a unit of work: its plain float32 operations,
    and its square roots and divisions at M1's weights."""
    return plain + sqrt * SQRT_OPS + div * DIV_OPS


# K1's lane operations per unit of counted work, broken down in
# csrc/megakernel.cu's header
OPS_PER_SLOT = _ops(29, sqrt=1)         # one (ray, sphere) test of the visit
OPS_PER_SLOT_NEAR = _ops(26, sqrt=1)    # the same, near root (far_root=False)
OPS_PER_CULL_ROW = _ops(48)             # one AABB slab test
CULL_OPS_PER_ROW = OPS_PER_CULL_ROW     # the JAX package's name
OPS_PER_GATE = _ops(3)                  # the occlusion gate, once a visit
OPS_PER_BOUNCE = _ops(19, sqrt=1, div=4)   # every bounce: one to the sky
OPS_PER_HIT = _ops(53, sqrt=1, div=2)   # more for one that hits (72, 2, 6)
OPS_PER_MIRROR = _ops(3)                # more for a mirror bounce's light
STATE_BYTES = 13 * 4            # the ray state a phase reads or writes
# K2's lane operations per replayed step, counted in csrc/replay_bwd.cu and
# csrc/ray_math.cuh: a bounce replayed in pass 1 (104 and 3 square roots, 3
# divisions) and replayed and reversed in pass 2 (247, 3, 4), or a step
# that ends the path (a miss: its colour, then the carry's seed; 61, 2, 2)
OPS_PER_K2_BOUNCE = _ops(351, sqrt=6, div=7)
OPS_PER_K2_END = _ops(61, sqrt=2, div=2)
K2_SCRATCH_BYTES = 2 * 9 * 4    # o, d, light of a step, written and read
PAY_BYTES = 28                  # the winner's 7 fields, at a bounce
# K3's lane operations per unit of counted work, with their breakdown in
# csrc/traversal.cu's header: an inner-node slab test, a sphere slot tested,
# one with a positive discriminant, a far root tried, a bounce that hits, one
# that ends on the sky, and a ray's primary direction and packing
K3_OPS = dict(node_steps=_ops(39), slot_tests=_ops(21),
              slot_roots=_ops(5, sqrt=1), far_roots=_ops(5),
              hit_bounces=_ops(73, sqrt=2, div=6),
              sky_bounces=_ops(22, sqrt=1, div=5), rays=_ops(27))


def vpu_ceiling_lane_ops(record: dict) -> float:
    """FP32 lane operations a second at M1's best measured issue rate (its
    uncontracted multiply-add and FMA chains at 8, 4 and 1 streams), from a
    record in ``docs/MICROBENCH_H100.json``'s format (``probes/
    microbench.py``).  Kernels that issue their operations as well as M1
    approach it; the published peak is ``record["peaks"]``.  A record
    without the card's peaks, such as the TPU's ``docs/MICROBENCH.json``,
    raises ``ValueError``."""
    if "fp32_lane_ops_per_s" not in record.get("peaks", {}):
        raise ValueError("not a record of the card's probes: it has no "
                         "peaks['fp32_lane_ops_per_s']")
    rates = [e["lane_ops_per_s"] for e in record.get("entries", ())
             if e.get("probe") == "M1" and e.get("mode") in ("mul_add", "fma")]
    if not rates:
        raise ValueError("the record holds no M1 issue-rate entry")
    return max(rates)


# ---- traces ---------------------------------------------------------------

@contextlib.contextmanager
def _profiled():
    """A ``torch.profiler.profile`` of CPU activity, and of CUDA activity
    where a card is present, that waits for the card before it stops."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block's CPU activity, and its CUDA activity where a card
    is present; yields the ``torch.profiler.profile``.  On a clean exit it
    waits for the card and exports a Chrome trace into ``log_dir``
    (``<host>_<pid>_<ns>.pt.trace.json.gz``)."""
    os.makedirs(log_dir, exist_ok=True)
    with _profiled() as prof:
        yield prof
    name = f"{socket.gethostname()}_{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"{name}.pt.trace.json.gz"))


def _trace_files(log_dir: str) -> list:
    return sorted(glob.glob(os.path.join(log_dir, "**", "*.trace.json"),
                            recursive=True)
                  + glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                              recursive=True))


def device_kernel_ms(log_dir: str) -> dict:
    """The Chrome traces under ``log_dir`` (plain or gzipped): device
    kernel name -> total ms.  Only the device's kernel events count
    (complete events of category ``kernel``); host operations, runtime
    calls, copies and sets do not."""
    out: collections.Counter = collections.Counter()
    for path in _trace_files(log_dir):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        for e in data.get("traceEvents", ()):
            if e.get("ph") == "X" and e.get("cat") == "kernel":
                out[e.get("name", "?")] += e.get("dur", 0) / 1e3
    return dict(out)


def device_events(prof) -> list:
    """The device's events of a finished ``torch.profiler.profile`` (its
    kernels, and its copies and sets), by start time."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sorted(events, key=lambda e: e.time_range.start)


def device_profile(fn) -> dict | None:
    """One call of ``fn`` under torch.profiler: device time by kernel name,
    the device's busy time and the span from its first kernel's start to
    its last kernel's end.  None where the profiler saw no device kernel
    (as on the host)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with _profiled() as prof:
        fn()
    kernels = device_events(prof)
    if not kernels:
        return None
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    span_ms = (kernels[-1].time_range.end - kernels[0].time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # idle gaps between consecutive kernels, with the kernels around them
    gaps = sorted(((b.time_range.start - a.time_range.end) / 1e3,
                   a.name[:40], b.name[:40])
                  for a, b in zip(kernels, kernels[1:]))[::-1]
    k1_gap_ms = sum(g for g, a, b in gaps
                    if g > 0 and ("megakernel" in a or "megakernel" in b))
    return dict(device_busy_ms=busy_ms, device_span_ms=span_ms,
                device_idle_share=1.0 - busy_ms / span_ms,
                n_kernels=len(kernels),
                top_kernels_ms=[[name[:60], us / 1e3] for name, us in top],
                largest_gaps_ms=[list(g) for g in gaps[:5]],
                gaps_next_to_k1_ms=k1_gap_ms)


def device_ms(fn, window_ms: float, runs: int = 20,
              clock_hz: float = 1.98e9) -> float:
    """The device's own time of one call of ``fn``: ``runs`` calls enqueued
    behind a spin kernel (``torch.cuda._sleep``, its cycles at
    ``clock_hz``) that outlasts their enqueue (``window_ms``, the windowed
    time of a call, bounds the host's cost of one), between two CUDA
    events, over ``runs``.  The host's cost of a call is not in it, the
    device's gaps between launches are.  It agrees with torch.profiler's
    kernel times (``device_profile``), which a timing process should not
    start before its windows: a profiled process pays more host time a
    launch afterwards."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3 * runs * window_ms * 1e-3 * clock_hz) + 10 ** 6)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


# ---- metrics ----------------------------------------------------------------

class Metrics:
    """Structured render metrics: phase ms + derived throughput.
    ``platform`` is the device type (``cuda``, or ``cpu`` for the plain
    versions on the host); ``n_devices`` the process group's world size
    where one is initialised, else the cards present (1 on the host)."""

    def __init__(self, width: int, height: int, scene: str, device=None):
        device = resolve_device(device)
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            n_devices = torch.distributed.get_world_size()
        elif device.type == "cuda":
            n_devices = torch.cuda.device_count()
        else:
            n_devices = 1
        self.data = {"width": width, "height": height, "scene": scene,
                     "platform": device.type, "n_devices": n_devices}

    def phase(self, name: str, seconds: float):
        self.data[f"{name}_ms"] = seconds * 1e3
        if name == "render":
            rays = self.data["width"] * self.data["height"]
            self.data["mrays_per_s"] = rays / seconds / 1e6
            self.data["mrays_per_s_per_chip"] = (
                self.data["mrays_per_s"] / self.data["n_devices"])
        return self

    def dump(self, path: str | None = None):
        if path:
            with open(path, "w") as f:
                json.dump(self.data, f, indent=2)
        else:
            json.dump(self.data, sys.stderr, indent=2)
            sys.stderr.write("\n")
        return self.data


@contextlib.contextmanager
def timed(label: str, sink=None):
    """Wall-clock phase timer, reference-driver style: the block waits for
    its own results (``utils.timing.wait``); prints ``<label> in <t>s.``
    to stderr and passes (label, seconds) to ``sink``."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    print(f"{label} in {dt:f}s.", file=sys.stderr)
    if sink is not None:
        sink(label, dt)
