"""Spans and counters inside the port.

``span(name)`` marks a stretch of the port's host code for torch.profiler:
while a profiler runs it opens a profiler range called ``name``, else it
returns one shared null context.  An ungated range costs about 15 µs a call
on the host even with no profiler running; the gate costs well under 1 µs.
Every name starts with ``rt.`` and names the layer: ``rt.render``,
``rt.rays``, ``rt.phase<k>``, ``rt.boundary<k>``, ``rt.unpermute``,
``rt.layout``, ``rt.grad.forward``, ``rt.grad.backward``, ``rt.reorder``,
``rt.segment<k>``, ``rt.carry<k>``, ``rt.scatter``, ``rt.camera``;
the trainer's ``rt.train`` (a whole step), ``rt.allreduce`` (the
reduction of ``parallel/mesh.py`` ``all_sum``) and ``rt.optim`` (the
masks, the optimizer's step, the clamps).

The range is a plain host range (``RecordScope::FUNCTION``), not a user
annotation: the profiler draws no device-side copy of it, so a trace's
device timeline holds only the device's own operations.  The profiler links
each kernel, copy and set to the host operation that launched it, and that
operation lies inside the spans of its thread; so a device operation belongs
to the innermost span open when it was launched.

``counting()`` switches on a registry of counters for the calls made inside
it, on every thread (a backward's K2 launches run on autograd's thread).
Outside it ``counters()`` is None and each hook costs one ``is None`` test.
Inside it the hooks add host ints or device tensors, without synchronising;
``Counters.read()`` synchronises once and returns plain ints.  A nested
``counting()`` adds its totals to the outer one's when it ends.

``counting()`` runs K1's ``with_stats`` variant and K2's counters, so that
their counts can be read; ``counting(stats=False)`` keeps every kernel's
variant as the main path runs it and counts the launches, the rays and the
bounces alone:

* ``k1.rays_launched``, ``k1.rays_live_in``: by phase (``phase<k>``), the
  rays a K1 launch runs and those live at its entry (for k >= 1 the
  survivors of boundary k-1);
* ``k1.slot_tests``, ``k1.ray_bounces``, ``k1.cull_rows``: by phase, K1's
  own per-ray counters (its ``with_stats`` variant, which the renders and
  the engine's forward take while counting with ``stats``);
* ``k1.launches``: by route (``lanes1``, ``lanes32``), CUDA launches only;
* ``k2.launches``, ``k2.row_adds``, ``k2.warp_iterations``: K2's CUDA
  launches and, with ``stats``, its ``counters=True`` counts;
  ``k2.bounces`` by segment (``segment<k>``), the records >= 0 the
  engine's backward replays;
* ``k3.launches``: by geometry path (``shared``, ``global``);
* ``layout.launches``: by stage (``codes``, ``pack``), the CUDA launches of
  the scene layout (``render/megakernel.py`` ``build_pallas_scene``).
* ``mesh.allreduce_calls``, ``mesh.allreduce_bytes``: by caller
  (``train``: ``all_sum``; ``gather``: ``all_gather``), the mesh's
  collectives and the bytes this rank contributes to each;
* ``train.steps``: the trainer's steps (``grad/inverse.py``);
* ``render.graph``: by part, how each multi-phase frame's launches ran
  (``render/megakernel.py`` ``render_pallas_twophase``): ``eager`` one by
  one from Python, ``capture`` captured into CUDA graphs (then replayed
  once), ``replay`` replayed from the graphs of an earlier frame.
"""
from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()
_registry = None


def span(name: str):
    """A profiler range called ``name`` while torch.profiler runs; else a
    shared null context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def spanned(name: str):
    """Decorator: the whole call inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


class Counters:
    """Totals by counter and part; values are host ints or device tensors
    until ``read``.  ``stats``: the hooks run the kernels' counting
    variants."""

    def __init__(self, stats: bool = True):
        self.stats = stats
        self._parts: dict = {}

    def add(self, name: str, value, part: str | None = None) -> None:
        """Add ``value`` (an int or a one-element integer tensor) to
        ``name``'s total and, with ``part``, to that part's."""
        parts = self._parts.setdefault(name, {})
        for key in ("total",) if part is None else ("total", part):
            old = parts.get(key)
            parts[key] = value if old is None else old + value

    def add_all(self, other: "Counters") -> None:
        """Add every total and part of ``other``."""
        for name, parts in other._parts.items():
            mine = self._parts.setdefault(name, {})
            for key, value in parts.items():
                old = mine.get(key)
                mine[key] = value if old is None else old + value

    def read(self) -> dict:
        """``{name: {"total": n, part: n, ...}}`` as plain ints; waits for
        the device tensors once."""
        flat = [(name, key, v) for name, parts in self._parts.items()
                for key, v in parts.items()]
        by_device: dict = {}
        for _, _, v in flat:
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, []).append(v)
        values = {dev: iter(torch.stack([t.reshape(()).to(torch.int64)
                                         for t in ts]).tolist())
                  for dev, ts in by_device.items()}
        out: dict = {}
        for name, key, v in flat:
            out.setdefault(name, {})[key] = (
                next(values[v.device]) if isinstance(v, torch.Tensor)
                else int(v))
        return out


def counters() -> Counters | None:
    """The registry of the innermost ``counting()``, or None."""
    return _registry


def count(name: str, value, part: str | None = None) -> None:
    """``Counters.add`` on the innermost ``counting()``'s registry; nothing
    outside it."""
    if _registry is not None:
        _registry.add(name, value, part)


def stats_on(c: Counters | None) -> bool:
    """The hooks under ``c`` run the kernels' counting variants."""
    return c is not None and c.stats


@contextlib.contextmanager
def counting(stats: bool = True):
    """Count the calls made inside; yields the ``Counters``.  ``stats``
    runs K1's ``with_stats`` variant and K2's counters; without it every
    kernel runs as on the main path.  A nested ``counting()`` reads its own
    calls alone, and adds them to the outer one's when it ends."""
    global _registry
    outer, _registry = _registry, Counters(stats)
    try:
        yield _registry
    finally:
        inner, _registry = _registry, outer
        if outer is not None:
            outer.add_all(inner)
