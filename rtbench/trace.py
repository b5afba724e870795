"""What a run measured, in one object that the metric readers read.

``Window`` holds the host clock's readings of the measured window: each
unit's submission and completion, and the set-up time.  ``Trace`` holds a
traced window as the profiler saw it: the device's operations (kernels,
copies, sets) with their names and intervals, the harness's own host spans
around each call into the program (``rtbench.submit``: the call until it
returns; ``rtbench.sync``: the wait for the card), the host operations
that were running, and the reference's work for the roofline readers.

The layer of a device operation is found by name, from ``layers.json``: a
kernel belongs to the first layer one of whose patterns its name contains.
"""
from __future__ import annotations

import bisect
import json
import statistics
from pathlib import Path

LAYERS = json.loads((Path(__file__).with_name("layers.json")).read_text())
SPAN_PREFIX = "rtbench."


class Window:
    """Host-clock readings of a measured window, in seconds."""

    def __init__(self, latencies: list, window_s: float, setup_s: float):
        self.latencies = latencies
        self.window_s = window_s
        self.setup_s = setup_s

    def mean_ms(self) -> float:
        """The window's time over the units completed in it."""
        return self.window_s / len(self.latencies) * 1e3

    def p95_ms(self) -> float:
        """The 95th percentile of every unit's latency in the window."""
        if len(self.latencies) < 2:
            return max(self.latencies) * 1e3
        return statistics.quantiles(self.latencies, n=20,
                                    method="inclusive")[18] * 1e3


def layer_of(name: str) -> str | None:
    for layer, patterns in LAYERS.items():
        if any(p in name for p in patterns):
            return layer
    return None


def _union(intervals, t0: float, t1: float):
    """The length of the union of (start, end) intervals clipped to
    [t0, t1], and the gaps of [t0, t1] that it leaves, as
    (busy, [(gap_start, gap_end), ...])."""
    busy, gaps, end = 0.0, [], t0
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in intervals
                       if e > t0 and s < t1):
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if end < t1:
        gaps.append((end, t1))
    return busy, gaps


class Trace:
    """A traced window: device operations and host spans in microseconds
    on the profiler's clock, the units it held, and the reference's work
    of one unit (``work``: pixels, spheres, hits, misses)."""

    def __init__(self, device_ops: list, spans: list, host_ops: list,
                 units: int, work: dict | None = None):
        self.device_ops = device_ops      # (name, start_us, end_us)
        self.spans = spans                # (name, start_us, end_us)
        self.host_ops = sorted(host_ops, key=lambda x: x[1])
        self._host_starts = [s for _, s, _ in self.host_ops]
        self.units = units
        self.work = work
        self.t0 = min((s for _, s, _ in spans), default=0.0)
        self.t1 = max((e for _, _, e in spans), default=0.0)
        self._busy_us, self._gaps = _union(
            [(s, e) for _, s, e in device_ops], self.t0, self.t1)

    @classmethod
    def from_profile(cls, prof, units: int, work=None) -> "Trace":
        from torch.autograd import DeviceType
        device_ops, spans, host_ops = [], [], []
        for e in prof.events():
            rng = (e.time_range.start, e.time_range.end)
            if e.name.startswith(SPAN_PREFIX):
                # a span shows on the device's timeline too: keep the host's
                if e.device_type != DeviceType.CUDA:
                    spans.append((e.name[len(SPAN_PREFIX):], *rng))
            elif e.device_type == DeviceType.CUDA:
                device_ops.append((e.name, *rng))
            else:
                host_ops.append((e.name, *rng))
        return cls(device_ops, spans, host_ops, units, work)

    @property
    def window_s(self) -> float:
        """From the first span's start to the last span's end."""
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return self._busy_us / 1e6

    def idle_share(self) -> float | None:
        if not self.device_ops or self.t1 <= self.t0:
            return None
        return 1.0 - self._busy_us / (self.t1 - self.t0)

    def layer_ms(self, layer: str | None, exclude=()) -> float | None:
        """Device ms a unit of the operations of ``layer``, or with
        ``layer`` None of every operation in none of the layers
        ``exclude``; None where the trace holds none."""
        total, found = 0.0, False
        for name, s, e in self.device_ops:
            lay = layer_of(name)
            if (lay == layer) if layer is not None else lay not in exclude:
                total += e - s
                found = True
        return total / 1e3 / self.units if found and self.units else None

    def span_ms(self, name: str) -> float | None:
        """Mean host ms of the harness's spans called ``name``."""
        d = [e - s for n, s, e in self.spans if n == name]
        return sum(d) / len(d) / 1e3 if d else None

    def _host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the harness's span and the
        innermost host operation running then (the one started last of
        those not yet ended), leaving out the CUDA runtime's own calls;
        else the operation started last before ``t``."""
        span = next((n for n, s, e in self.spans if s <= t <= e), "harness")
        i = bisect.bisect_right(self._host_starts, t) - 1
        op = self.host_ops[i][0] if i >= 0 else "-"
        for name, _, end in self.host_ops[max(0, i - 256):i + 1][::-1]:
            if end >= t and not name.startswith("cuda"):
                op = name
                break
        return f"{span}: {op}"

    def breakdown(self) -> dict:
        """The device operations with the most time and the idle time by
        what the host was doing when the device resumed, in seconds."""
        by_name: dict = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        idle: dict = {}
        for gs, ge in self._gaps:
            label = self._host_at(ge)
            idle[label] = idle.get(label, 0.0) + (ge - gs) / 1e6

        def first(d):
            return [[k[:120], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return dict(device_ops=first(by_name), idle_gaps=first(idle))
