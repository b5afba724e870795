"""The program's own spans and counters in a traced run, for the per-layer
metrics of source ``program_span`` and ``program_counter``.

The port opens a profiler range at each layer boundary while torch.profiler
runs (``rt.render``, ``rt.phase<k>``, ``rt.segment<k>``, ...: the table in
PERF.md §3), as plain host ranges: the profiler draws no device-side copy of
them, so the device operations of ``trace.Trace``, and every metric read
from them, stay as they were.  A device operation belongs to the innermost
``rt.`` span around the host operation that launched it: the profiler ties
each kernel, copy and set to that operation by correlation id (its
``kernels``; a launch made straight from a span, as K1's and K2's are, is
tied to the span itself), and the operation lies inside the spans of its
thread on the host's clock.  Neither step compares a device time with a
host time: the profiler maps the device's timestamps onto the host's clock
with a skew of up to about 20 µs, which would move operations launched near
a span's edge into the next span.  ``Spans`` gives, a unit:

* device ms and operations under each span, self: an operation counts in
  its innermost span only;
* host ms of each span: the union of its intervals across threads (a
  step's backward runs on autograd's thread);
* idle device time by the innermost ``rt.`` span open on the host when the
  device resumed, ``harness`` where none was (this one compares the two
  clocks, so a gap's label can be off by the skew).

The counters come from one counted unit: a driver of its own, set up for
the run's cell and seed, runs the window's first unit under the port's
``utils.trace.counting()`` after the window has closed and the check is
done, so its device work and its waits enter no timed or traced window.

``Trace`` keeps neither the profiler's correlation nor the program's counters,
and a reader is handed only ``Run``.  So ``of_run`` and ``counters`` read the
profile and the cell's set-up from the frame of the harness's ``run`` that
called the reader (``_harness_locals``), and ``_count_unit`` sets up a
driver of its own; both go once ``Trace`` keeps the profile's correlation
and each driver counts a unit itself.  A program without ``rt.`` spans or
without ``utils.trace`` gives None from every reader; any other fault
raises, a traced reading without the harness's frame among them, so that a
broken reader cannot pass for a metric the program lacks.

    python3 -m rtbench.spans --workload rgbbox.grad --seed 7 --seconds 1

runs a cell traced, prints its result line, then a second line with the
per-span table (``spans``), the idle time by span (``idle_by_span``) and the
counted unit's counters (``counters``).
"""
from __future__ import annotations

import bisect
import importlib
import json
import sys
from pathlib import Path

from rtbench.trace import _union

PREFIX = "rt."
LAUNCHERS = (PREFIX, "aten::")
HARNESS = "harness"
_RUN_PY = Path(__file__).resolve().with_name("run.py")
_cache: dict = {}       # by traced window: its Spans, its counters, the run


def picks(name: str, keys) -> bool:
    """``name`` is one of ``keys``; a key ending in ``*`` is a prefix."""
    return any(name.startswith(k[:-1]) if k.endswith("*") else name == k
               for k in keys)


def _innermost(spans: list, points: list) -> list:
    """For each time of ``points``, the innermost of ``spans`` (name,
    start, end, thread: one thread's, which nest) holding it, or None."""
    order = sorted(range(len(points)), key=points.__getitem__)
    ranked = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    out, stack, j = [None] * len(points), [], 0
    for i in order:
        t = points[i]
        while j < len(ranked) and ranked[j][1] <= t:
            while stack and stack[-1][2] < ranked[j][1]:
                stack.pop()
            stack.append(ranked[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


def _latest_holding(spans: list, t: float):
    """Of ``spans`` on any thread, the one started last that holds ``t``."""
    best = None
    for sp in spans:
        if sp[1] <= t <= sp[2] and (best is None or sp[1] > best[1]):
            best = sp
    return best


class Spans:
    """The ``rt.`` spans of a traced window and its device operations, each
    with the span it belongs to.

    ``spans``: (name, start_us, end_us, thread) host ranges; ``launched``:
    (name, duration_us, thread, start_us), each device operation that the
    profiler ties to a host operation, with that operation's thread and
    start; ``device``: (name, duration_us) of every device operation, of
    which those the profiler ties to none belong to no span."""

    def __init__(self, spans: list, launched: list, device: list,
                 units: int):
        self.spans = spans
        self.units = units
        by_thread: dict = {}
        for sp in spans:
            by_thread.setdefault(sp[3], []).append(sp)
        owner = [None] * len(launched)
        for thread, sps in by_thread.items():
            idx = [i for i, op in enumerate(launched) if op[2] == thread]
            for i, sp in zip(idx, _innermost(sps, [launched[i][3]
                                                   for i in idx])):
                owner[i] = sp
        # (name, duration_us, owning span or None)
        self.ops = [(op[0], op[1], sp) for op, sp in zip(launched, owner)]
        left: dict = {}
        for name, us in device:
            n, t = left.get(name, (0, 0.0))
            left[name] = (n + 1, t + us)
        for name, us, _ in self.ops:
            n, t = left.get(name, (0, 0.0))
            left[name] = (n - 1, t - us)
        for name, (n, us) in left.items():
            if n < 0:
                raise ValueError(f"{-n} more operations {name!r} tied to "
                                 "host operations than the trace holds: "
                                 "an operation was counted twice")
            if n > 0:
                self.ops += [(name, us / n, None)] * n  # tied to nothing

    @classmethod
    def from_events(cls, events, units: int) -> "Spans":
        """From torch.profiler's events (``prof.events()``); the device
        operations are ``Trace``'s: every device event but the harness's
        spans."""
        from torch.autograd import DeviceType
        events = list(events)
        spans, launched, device = [], [], []
        for e in events:
            if e.device_type == DeviceType.CPU:
                if e.name.startswith(PREFIX):
                    spans.append((e.name, e.time_range.start,
                                  e.time_range.end, e.thread))
                if e.name.startswith(LAUNCHERS):
                    # only torch's operations and the port's spans: an event
                    # of the runtime's or the profiler's own carries an id
                    # from another count, which can equal an operation's,
                    # and the profiler then gives it that operation's kernels
                    launched += [(k.name, k.duration, e.thread,
                                  e.time_range.start) for k in e.kernels]
            elif (e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("rtbench.", PREFIX))):
                device.append((e.name, e.time_range.end - e.time_range.start))
        return cls(spans, launched, device, units)

    def names(self) -> set:
        return {sp[0] for sp in self.spans}

    def _found(self, keys) -> bool:
        return any(picks(n, keys) for n in self.names())

    def device_ms(self, keys) -> float | None:
        """Device ms a unit of the operations under the spans ``keys``
        (self); None where the trace holds no such span."""
        if not self._found(keys) or not self.units:
            return None
        us = sum(us for _, us, sp in self.ops
                 if sp is not None and picks(sp[0], keys))
        return us / 1e3 / self.units

    def device_ops(self, keys) -> float | None:
        """Device operations a unit under the spans ``keys`` (self)."""
        if not self._found(keys) or not self.units:
            return None
        n = sum(1 for _, _, sp in self.ops
                if sp is not None and picks(sp[0], keys))
        return n / self.units

    def host_ms(self, keys) -> float | None:
        """Host ms a unit covered by the spans ``keys``: the union of their
        intervals, across threads."""
        if not self._found(keys) or not self.units:
            return None
        ivs = [(s, e) for n, s, e, _ in self.spans if picks(n, keys)]
        us = _union(ivs, min(s for s, _ in ivs), max(e for _, e in ivs))[0]
        return us / 1e3 / self.units

    def table(self) -> dict:
        """Each span's device ms, device operations and host ms a unit, and
        the device operations under no span (``outside``), with the names
        that take most of their time."""
        out = {name: dict(device_ms=self.device_ms((name,)),
                          ops=self.device_ops((name,)),
                          host_ms=self.host_ms((name,)))
               for name in sorted(self.names())}
        outside: dict = {}
        for name, us, sp in self.ops:
            if sp is None:
                outside[name] = outside.get(name, 0.0) + us
        units = self.units or 1
        out["outside"] = dict(
            device_ms=sum(outside.values()) / 1e3 / units,
            ops=sum(1 for _, _, sp in self.ops if sp is None) / units,
            top=[[n[:120], us / 1e3 / units] for n, us in
                 sorted(outside.items(), key=lambda kv: -kv[1])[:8]])
        return out

    def idle_by_span(self, gaps) -> dict:
        """Seconds of the device's idle ``gaps`` (start_us, end_us) by the
        innermost span open on the host when the device resumed, on any
        thread; ``harness`` where none was."""
        starts = sorted(self.spans, key=lambda sp: sp[1])
        keys = [sp[1] for sp in starts]
        out: dict = {}
        for gs, ge in gaps:
            i = bisect.bisect_right(keys, ge)
            sp = _latest_holding(starts[max(0, i - 512):i], ge)
            label = HARNESS if sp is None else sp[0]
            out[label] = out.get(label, 0.0) + (ge - gs) / 1e6
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _harness_locals() -> dict:
    """The locals of the harness's ``run`` that called the reader; raises
    where no such frame is found."""
    f = sys._getframe(1)
    while f is not None:
        code = f.f_code
        if (code.co_name == "run" and "prof" in f.f_locals
                and Path(code.co_filename).resolve() == _RUN_PY):
            return f.f_locals
        f = f.f_back
    raise RuntimeError("a traced reading of the program's spans and "
                       "counters found no frame of rtbench/run.py's run")


def _cached(run, key, make):
    """``make()`` once a traced window."""
    entry = _cache.get(key)
    if entry is not None and entry[0] is run.trace:
        return entry[1]
    value = make()
    _cache[key] = (run.trace, value)
    _cache["run"] = run
    return value


def of_run(run) -> Spans | None:
    """The traced window's spans, or None where it holds no ``rt.`` span."""
    if run.trace is None:
        return None

    def make():
        events = list(_harness_locals()["prof"].events())
        if not any(e.name.startswith(PREFIX) for e in events):
            return None             # a program without the port's spans
        return Spans.from_events(events, run.trace.units)
    return _cached(run, "spans", make)


def counters(run) -> dict | None:
    """The counters of one counted unit of the run's cell and seed, or None
    where the program has no ``utils.trace``."""
    if run.trace is None:
        return None
    return _cached(run, "counters", lambda: _count_unit(_harness_locals()))


def _count_unit(loc) -> dict | None:
    try:
        from raytracers_tpu_torch.utils.trace import counting
    except ModuleNotFoundError as e:
        if e.name not in ("raytracers_tpu_torch.utils.trace",
                          "raytracers_tpu_torch.utils"):
            raise
        return None
    mix = loc["mix"]
    module = importlib.import_module(f"rtbench.drivers.{mix['driver']}")
    driver = module.Driver(loc["config"], mix, loc["seed"], loc["device"])
    try:
        with counting() as c:
            driver.run(mix["warmup_units"])
            driver.wait()
        return c.read()
    finally:
        driver.release()


def part_sum(counts: dict, name: str, parts) -> int | None:
    """The sum of counter ``name`` over ``parts``; None where it has none."""
    found = [v for k, v in counts.get(name, {}).items() if k in parts]
    return sum(found) if found else None


def main(argv=None) -> int:
    """Run a cell traced through the harness, then print its spans, idle
    time by span and counters as one more JSON line."""
    from rtbench import run as harness
    from rtbench import spans as this         # the readers' module
    rc = harness.main(list(sys.argv[1:] if argv is None else argv)
                      + ["--trace", "1"])
    run = this._cache.get("run")
    if rc or run is None:
        return rc or 1
    s = this._cache.get("spans", (None, None))[1]
    tr = run.trace
    gaps = _union([(a, b) for _, a, b in tr.device_ops], tr.t0, tr.t1)[1]
    print(json.dumps(dict(
        spans=None if s is None else s.table(),
        idle_by_span=None if s is None else s.idle_by_span(gaps),
        counters=this._cache.get("counters", (None, None))[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
