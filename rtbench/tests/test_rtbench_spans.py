"""``rtbench/spans.py`` on synthetic profiles: each device operation in the
innermost ``rt.`` span of the thread that launched it, self time, host time
as the union across threads, idle time by span; the port's host-only spans
leave every device reading of ``trace.Trace`` as it was; a trace without
them gives None from every new reader.  On the card: the spans account
for every device operation of the traced window.

    python -m pytest rtbench/tests/test_rtbench_spans.py -q -p no:cacheprovider
"""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Kernel

from rtbench import run, spans
from rtbench.trace import Trace, Window, _union

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# the metrics read from the program's own spans and counters
NEW = [m["name"] for m in BENCH["per_layer"]
       if "from rtbench import spans" in
       (ROOT / "rtbench" / "metrics" / f"{m['name']}.py").read_text()]
OLD = [m["name"] for m in BENCH["per_layer"] if m["name"] not in NEW]


def _ev(name, start, end, *, thread=1, device=False, kernels=()):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        thread=thread, kernels=[Kernel(k, 0, d) for k, d in kernels],
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=name.startswith("rtbench."))


def _events(with_port=True, k2_tied=True):
    """Two units on thread 1; the second's backward on thread 2.  The
    harness's spans are user annotations, with a copy on the device.  The
    profiler ties each device operation to the host operation that
    launched it (``kernels``); K1 is launched straight from ``rt.phase0``.
    With ``k2_tied`` false it ties K2 to nothing."""
    mega = "megakernel<false, 128, true, 1>"
    port = [
        _ev("rt.render", 10, 60), _ev("rt.boundary0", 30, 45),
        _ev("rt.grad.forward", 110, 140),
        _ev("rt.grad.backward", 140, 190, thread=2),
        _ev("rt.segment0", 150, 170, thread=2),
    ]
    phase0 = _ev("rt.phase0", 12, 30, kernels=[(mega, 39)])
    host = [
        _ev("rtbench.submit", 0, 70), _ev("rtbench.sync", 70, 100),
        _ev("rtbench.submit", 100, 200), _ev("rtbench.sync", 200, 260),
        _ev("rtbench.submit", 5, 80, device=True),
        _ev("aten::fill_", 13, 15, kernels=[("fill", 1)]),       # rt.phase0
        _ev("cudaLaunchKernel", 14, 15),
        # a runtime call whose id equals aten::sort's: given its kernels too
        _ev("cudaDeviceSynchronize", 70, 99, kernels=[("radix_sort", 6)]),
        _ev("aten::sort", 31, 40, kernels=[("radix_sort", 6)]),  # boundary0
        _ev("aten::cat", 50, 55, kernels=[("cat", 2)]),          # rt.render
        _ev("aten::mul", 120, 121, kernels=[("mul", 2)]),        # forward
        _ev("aten::add", 155, 156, thread=2,                     # segment0
            kernels=[("replay_bwd", 23)] if k2_tied else []),
        _ev("aten::sub", 195, 196, kernels=[("sub", 2)]),        # no span
    ]
    host = port + [phase0] + host if with_port else host
    device = [
        _ev("fill", 40, 41, device=True), _ev(mega, 41, 80, device=True),
        _ev("radix_sort", 80, 86, device=True),
        _ev("cat", 86, 88, device=True), _ev("mul", 122, 124, device=True),
        _ev("replay_bwd", 157, 180, device=True),
        _ev("sub", 197, 199, device=True),
    ]
    return host + device


def _spans(with_port=True):
    return spans.Spans.from_events(_events(with_port), units=2)


def test_innermost_span_and_self_time():
    s = _spans()
    owner = {name: (sp[0] if sp else None) for name, _, sp in s.ops}
    assert owner == {
        "fill": "rt.phase0", "megakernel<false, 128, true, 1>": "rt.phase0",
        "radix_sort": "rt.boundary0", "cat": "rt.render",
        "mul": "rt.grad.forward", "replay_bwd": "rt.segment0", "sub": None}
    # self: rt.render holds only its own cat, not its phases' operations
    assert s.device_ms(("rt.render",)) == pytest.approx(2 / 1e3 / 2)
    assert s.device_ms(("rt.phase0",)) == pytest.approx(40 / 1e3 / 2)
    assert s.device_ops(("rt.*",)) == 3.0
    assert s.device_ms(("rt.boundary*", "rt.unpermute")) == pytest.approx(
        6 / 1e3 / 2)
    assert s.table()["outside"]["ops"] == 0.5


def test_an_operation_tied_to_nothing_is_outside():
    """A device operation the profiler ties to no host operation belongs to
    no span, and the table still holds every operation's time."""
    s = spans.Spans.from_events(_events(k2_tied=False), units=2)
    assert s.device_ms(("rt.segment0",)) == 0.0
    outside = s.table()["outside"]
    assert outside["ops"] == 1.0
    assert dict(outside["top"]) == pytest.approx({"replay_bwd": 0.0115,
                                                  "sub": 0.001})
    assert sum(us for _, us, _ in s.ops) == 75


def test_host_time_is_the_union_across_threads():
    s = _spans()
    # forward 110-140 on thread 1, backward 140-190 on thread 2
    assert s.host_ms(("rt.grad.forward", "rt.grad.backward")) == \
        pytest.approx(80 / 1e3 / 2)
    overlapping = spans.Spans([("rt.a", 0, 50, 1), ("rt.a", 30, 70, 2)], [],
                              [], units=1)
    assert overlapping.host_ms(("rt.a",)) == pytest.approx(70 / 1e3)
    assert s.host_ms(("rt.camera",)) is None
    assert s.device_ms(("rt.layout",)) is None


def test_idle_by_span():
    s = _spans()
    gaps = [(30, 40), (100, 122), (124, 157), (199, 260)]
    idle = s.idle_by_span(gaps)
    # resumed at 40 in rt.boundary0, at 122 in rt.grad.forward, at 157 in
    # rt.segment0 (thread 2), at 260 in none
    assert idle == pytest.approx({"rt.boundary0": 10e-6,
                                  "rt.grad.forward": 22e-6,
                                  "rt.segment0": 33e-6, "harness": 61e-6})
    assert sum(idle.values()) == pytest.approx(
        sum(e - s for s, e in gaps) / 1e6)


def _trace(evs):
    return Trace.from_profile(SimpleNamespace(events=lambda: evs), 2,
                              dict(pixels=1, spheres=1, hits=1, misses=1))


def test_port_spans_leave_the_device_readings_as_they_were():
    with_port, without = _trace(_events(True)), _trace(_events(False))
    assert with_port.device_ops == without.device_ops
    assert with_port.busy_s == without.busy_s
    assert with_port.idle_share() == without.idle_share()
    assert with_port.window_s == without.window_s
    assert with_port.span_ms("submit") == without.span_ms("submit")
    assert (with_port.breakdown()["device_ops"]
            == without.breakdown()["device_ops"])
    w = Window([0.1, 0.1], 0.2, 1.0)
    for name in OLD:
        read = run.reader(name)
        assert read(run.Run(w, with_port)) == read(run.Run(w, without)), name


def test_new_readers_give_none_without_port_spans(monkeypatch):
    tr = _trace(_events(False))
    r = run.Run(Window([0.1, 0.1], 0.2, 1.0), tr)
    # untraced: nothing to read
    for name in NEW:
        assert run.reader(name)(run.Run(r.window, None)) is None, name
    # traced, but not called by the harness: a fault, not a missing metric
    spans._cache.clear()
    for name in NEW:
        with pytest.raises(RuntimeError, match="no frame"):
            run.reader(name)(r)
    # called with a profile that holds no rt. span, and a program without
    # counters
    monkeypatch.setattr(spans, "_harness_locals",
                        lambda: dict(prof=SimpleNamespace(
                            events=lambda: _events(False))))
    monkeypatch.setattr(spans, "_count_unit", lambda loc: None)
    spans._cache.clear()
    for name in NEW:
        assert run.reader(name)(r) is None, name


def test_counted_unit_without_the_port_module(monkeypatch):
    """A program without ``utils.trace`` has no counters; a fault inside
    the port's module is raised."""
    monkeypatch.setitem(sys.modules, "raytracers_tpu_torch.utils.trace",
                        None)
    assert spans._count_unit({}) is None
    monkeypatch.setitem(sys.modules, "raytracers_tpu_torch.utils.trace",
                        SimpleNamespace())      # no counting(): a fault
    with pytest.raises(ImportError):
        spans._count_unit({})


def test_an_operation_tied_twice_is_a_fault():
    """More operations tied to host operations than the trace holds: one
    was counted twice, and the spans refuse to read."""
    evs = _events() + [_ev("aten::mm", 56, 57, kernels=[("cat", 2)])]
    with pytest.raises(ValueError, match="counted twice"):
        spans.Spans.from_events(evs, units=2)


def test_new_readers_on_port_spans_and_counters(monkeypatch):
    tr = _trace(_events(True))
    r = run.Run(Window([0.1, 0.1], 0.2, 1.0), tr)
    counts = {"k1.rays_launched": {"total": 30, "phase0": 10, "phase1": 10,
                                   "phase2": 10},
              "k1.rays_live_in": {"total": 15, "phase0": 10, "phase1": 4,
                                  "phase2": 1},
              "k1.slot_tests": {"total": 900}, "k1.ray_bounces": {"total": 3},
              "k2.bounces": {"total": 40}, "k2.row_adds": {"total": 8}}
    monkeypatch.setattr(spans, "_harness_locals",
                        lambda: dict(prof=SimpleNamespace(
                            events=lambda: _events(True))))
    monkeypatch.setattr(spans, "_count_unit", lambda loc: counts)
    spans._cache.clear()
    got = {name: run.reader(name)(r) for name in NEW}
    assert got["k1_phase0_ms.render"] == pytest.approx(0.02)
    assert got["boundary_ms.render"] == pytest.approx(0.003)
    assert got["live_share.render"] == pytest.approx(25.0)
    assert got["k1_tests.render"] == pytest.approx(300.0)
    assert got["k2_fanin.grad"] == pytest.approx(5.0)
    assert got["engine_host_ms.grad"] == pytest.approx(0.04)
    assert got["layout_ms.grad"] is None    # no rt.layout in this trace


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["irreg.render", "rgbbox.grad"])
def test_spans_account_for_the_device_time(cell):
    """On the card: every device operation of the traced window is counted
    once, in one span or outside; the profiler ties K1's and K2's launches
    to their spans; each unit's spans lie inside its ``rtbench.submit`` on
    the host's clock; and the idle time by span sums to the window's idle
    time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    spans._cache.clear()
    out = run.run(cell, 2 ** 32 + 21, 1.0, True)
    assert all(name in out["metrics"] for name in NEW
               if cell in next(m for m in BENCH["per_layer"]
                               if m["name"] == name)["workloads"])
    s = spans._cache["spans"][1]
    tr = spans._cache["run"].trace
    assert len(s.ops) == len(tr.device_ops)
    assert sum(us for _, us, _ in s.ops) == pytest.approx(
        sum(e - b for _, b, e in tr.device_ops))
    phase = {sp[0] for name, _, sp in s.ops if "megakernel" in name}
    assert phase and all(p.startswith("rt.phase") for p in phase)
    if cell.endswith(".grad"):
        segment = {sp[0] for name, _, sp in s.ops
                   if "replay_bwd" in name and sp is not None}
        assert segment and all(p.startswith("rt.segment") for p in segment)
    else:
        # a frame's work lies in rt.render: all of its device time bar the
        # odd operation the profiler ties to no host operation
        outside = s.table()["outside"]["device_ms"] * tr.units * 1e3
        assert outside <= 1e-3 * sum(us for _, us, _ in s.ops)
    submits = [(a, b) for n, a, b in tr.spans if n == "submit"]
    for _, a, b, _ in s.spans:
        assert any(sa <= a and b <= sb for sa, sb in submits)
    gaps = _union([(a, b) for _, a, b in tr.device_ops], tr.t0, tr.t1)[1]
    idle = s.idle_by_span(gaps)
    assert sum(idle.values()) == pytest.approx(
        tr.window_s - tr.busy_s, rel=1e-6)
