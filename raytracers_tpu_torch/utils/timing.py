"""Timing: CUDA events on the card, and the reference driver's host clock.

``cuda_ms`` and ``EventTimer`` are the card's yardstick: the clock is the
device's, an event before and after a run of calls, then
``torch.cuda.synchronize()`` and ``elapsed_time`` over the count.  Warm-up
calls go first, so the kernels' build and first-launch costs are excluded.

``bench_fn``, ``bench_salted``, ``bench_batched`` and ``PhaseTimer`` keep the
JAX package's signatures (``raytracers_tpu/utils/timing.py``) and return
host seconds, as the reference driver times its phases
(futhark/main.c:88-124): they wait for the CUDA devices that the outputs
lie on before the clock starts and before it stops, and for nothing on the
host.  The salted and batched variants exist in the JAX package for a TPU
runtime's result cache and its per-dispatch floor; the card has neither,
so here they are plain loops with the same contracts.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Hashable

import torch


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (nested tuples, lists,
    dicts and NamedTuples)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    return found


def wait(out):
    """Wait for the CUDA devices that ``out`` holds tensors on (nothing for
    host tensors); returns ``out``."""
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)
    return out


def bench_fn(fn: Callable, *args, warmup: int = 2, runs: int = 10) -> float:
    """Average host seconds per call of ``fn(*args)``, the outputs'
    devices drained before the clock starts and before it stops."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    wait(out)
    t0 = time.perf_counter()
    for _ in range(runs):
        out = fn(*args)
    wait(out)
    return (time.perf_counter() - t0) / runs


def bench_salted(fn: Callable, make_args: Callable[[int], tuple],
                 warmup: int = 2, runs: int = 10) -> float:
    """Average host seconds per call of ``fn(*make_args(k))``, run ``k``
    taking arguments of its own (warm-up runs ``-1 - k``).  The JAX
    package salts its inputs against a TPU runtime's result cache; the card
    has none, so this is ``bench_fn`` over the salted arguments."""
    out = None
    for k in range(warmup):
        out = fn(*make_args(-1 - k))
    wait(out)
    t0 = time.perf_counter()
    for k in range(runs):
        out = fn(*make_args(k))
    wait(out)
    return (time.perf_counter() - t0) / runs


def bench_batched(make_sum_fn: Callable[[int], Callable], runs: int = 3,
                  k: int = 16) -> float:
    """Host seconds per evaluation of a workload that ``make_sum_fn(k)``
    evaluates ``k`` times in one call: it returns ``fn(seed: float) ->
    scalar``, which evaluates the workload on ``k`` different inputs made
    from ``seed``.  The JAX package batches so against a TPU runtime's
    per-dispatch floor; on the card it is a plain loop (two warm-up calls,
    then ``runs`` timed ones with seeds 0, 1, ...)."""
    fn = make_sum_fn(k)
    wait(fn(-1.0))
    wait(fn(-2.0))
    t0 = time.perf_counter()
    out = None
    for r in range(runs):
        out = fn(float(r))
    wait(out)
    return (time.perf_counter() - t0) / runs / k


class PhaseTimer:
    """Collects named phase timings (host seconds, ``bench_fn``); renders
    a metrics dict."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    def measure(self, name: str, fn: Callable, *args, warmup: int = 2,
                runs: int = 10) -> float:
        dt = bench_fn(fn, *args, warmup=warmup, runs=runs)
        self.phases[name] = dt
        return dt

    def report(self) -> dict:
        return dict(self.phases)


def cuda_ms(fn: Callable[[], object], warmup: int = 2, runs: int = 10) -> float:
    """Mean milliseconds of one ``fn()`` on the current CUDA stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms measures on a CUDA device; none is here")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


class EventTimer:
    """Times spans on the stream without synchronising in between:
    ``with timer.span(name): ...`` records an event before and after;
    ``ms()`` waits for the device once and returns {name: [ms, ...]}."""

    def __init__(self):
        self._spans: list[tuple[Hashable, torch.cuda.Event,
                                torch.cuda.Event]] = []

    @contextmanager
    def span(self, name: Hashable):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._spans.append((name, start, end))

    def ms(self) -> dict:
        torch.cuda.synchronize()
        out: dict = {}
        for name, s, e in self._spans:
            out.setdefault(name, []).append(s.elapsed_time(e))
        return out
