"""The port's spans and counters (``utils/trace.py``) on the CPU.

Under torch.profiler a render through the compaction schedule and a fwd+bwd
step emit the ``rt.`` spans with the layers' nesting, and a step of the
trainer nests them under ``rt.train`` beside its all-reduce and update;
with no profiler running no profiler range is entered at all.  Under
``counting()`` the counters equal what the port computes without them
(``render_stats``, a direct count of the survivors of each boundary, the
bytes the all-reduce carries), and the images, gradients and updated
states are bit-equal to those of an uncounted call.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.grad.inverse import (adam, init_state,
                                               make_train_step_pallas)
from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
from raytracers_tpu_torch.parallel.mesh import RayMesh, all_gather, ray_mesh
from raytracers_tpu_torch.render import megakernel as tmk
from raytracers_tpu_torch.render.api import (pallas_config, prepare_scene,
                                             render, render_stats)
from raytracers_tpu_torch.utils import trace

torch.set_num_threads(2)
CPU = "cpu"
SIZE = 48
RENDER_DEPTH = 16       # deep enough for the schedule of the scene class
STEP_DEPTH = 8
STEP_SCHEDULE = (3, 2)
STEP_PREFIX = (None, 0.5)

FORWARD_SPANS = {"rt.layout", "rt.rays", "rt.phase0", "rt.phase1",
                 "rt.phase2", "rt.boundary0", "rt.boundary1", "rt.unpermute"}
BACKWARD_SPANS = {"rt.rays", "rt.reorder", "rt.segment2", "rt.segment1",
                  "rt.segment0", "rt.carry1", "rt.carry0", "rt.scatter",
                  "rt.camera"}


def _prepared(name):
    sc = tscenes.by_name(name, device=CPU)
    return sc, prepare_scene(sc, SIZE, SIZE, with_pallas=True,
                             with_bvh=False, device=CPU)


def _engine():
    return make_render_pallas_diff(SIZE, SIZE, max_depth=STEP_DEPTH,
                                   tile=256, block=(16, 16),
                                   schedule=STEP_SCHEDULE,
                                   sort_prefix=STEP_PREFIX)


def _step(f, sc, cam):
    sph = tgeo.Spheres(*(t.clone().requires_grad_() for t in sc.spheres))
    cam = tgeo.Camera(*(t.clone().requires_grad_() for t in cam))
    img = f(sph, cam)
    (img ** 2).sum().backward()
    return img.detach(), [t.grad for t in (*sph, *cam)]


def _enclosing(event):
    """The innermost ``rt.`` span around a profiler event, or None."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("rt."):
        p = p.cpu_parent
    return None if p is None else p.name


def _spans(prof):
    return [(e.name, _enclosing(e)) for e in prof.events()
            if e.name.startswith("rt.")]


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_render_spans_nest_under_render(name):
    sc, prep = _prepared(name)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(prep, SIZE, SIZE, mode="pallas", max_depth=RENDER_DEPTH)
    spans = _spans(prof)
    assert spans[0] == ("rt.render", None)
    inner = {n for n, _ in spans[1:]}
    assert all(parent == "rt.render" for _, parent in spans[1:])
    n_phases = len(pallas_config(prep.pallas.n_clusters)[2]) + 1
    assert inner == ({"rt.rays", "rt.unpermute"}
                     | {f"rt.phase{k}" for k in range(n_phases)}
                     | {f"rt.boundary{k}" for k in range(n_phases - 1)})


def test_step_spans_nest_under_forward_and_backward():
    sc, prep = _prepared("rgbbox")
    f = _engine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(f, sc, prep.cam)
    spans = _spans(prof)
    roots = [n for n, parent in spans if parent is None]
    assert roots == ["rt.grad.forward", "rt.grad.backward"]
    assert {n for n, p in spans if p == "rt.grad.forward"} == FORWARD_SPANS
    assert {n for n, p in spans if p == "rt.grad.backward"} == BACKWARD_SPANS
    names = [n for n, _ in spans]
    # the backward replays the segments deepest first, each carry crossing
    # back between two of them
    order = [n for n in names if n.startswith(("rt.segment", "rt.carry"))]
    assert order == ["rt.segment2", "rt.carry1", "rt.segment1", "rt.carry0",
                     "rt.segment0"]
    assert all(n.startswith("rt.") and not n.startswith("rtbench.")
               for n in names)


def test_no_profiler_range_without_a_profiler(monkeypatch):
    """Untraced, the spans are a shared null context: no profiler range is
    ever entered."""
    def refuse(*args, **kw):
        raise AssertionError("a profiler range was entered untraced")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    sc, prep = _prepared("rgbbox")
    assert trace.span("rt.render") is trace.span("rt.layout")
    render(prep, SIZE, SIZE, mode="pallas", max_depth=RENDER_DEPTH)
    _step(_engine(), sc, prep.cam)


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_counted_render_equals_render_stats(name):
    _, prep = _prepared(name)
    plain = render(prep, SIZE, SIZE, mode="pallas", max_depth=RENDER_DEPTH)
    with trace.counting() as c:
        counted = render(prep, SIZE, SIZE, mode="pallas",
                         max_depth=RENDER_DEPTH)
    n = c.read()
    stats = render_stats(prep, SIZE, SIZE, max_depth=RENDER_DEPTH)
    assert torch.equal(counted, plain)
    for key in tmk.STAT_NAMES:
        assert n[f"k1.{key}"]["total"] == stats[key]
        assert [n[f"k1.{key}"][f"phase{k}"]
                for k in range(len(stats[f"phase_{key}"]))
                ] == stats[f"phase_{key}"]
    # the plain version is no launch
    assert "k1.launches" not in n and "k2.launches" not in n


class _States:
    """K1 that keeps each launch's state rows."""

    def __init__(self):
        self.states = []

    def __call__(self, *args, **kw):
        out = tmk.megakernel(*args, **kw)
        self.states.append(out[0])
        return out


@pytest.mark.parametrize("name,schedule,prefix", [
    ("rgbbox", (3, 4, 8), (None, 0.5, 0.25)),
    ("irreg", (3, 6), (None, 0.25)),
    ("irreg", (2,), None)])
def test_live_in_is_the_survivors_of_the_last_boundary(name, schedule,
                                                        prefix):
    _, prep = _prepared(name)
    kern = _States()
    with trace.counting() as c:
        tmk.render_pallas_twophase(prep.pallas, prep.cam, SIZE, SIZE,
                                   max_depth=RENDER_DEPTH, tile=256,
                                   schedule=schedule, sort_prefix=prefix,
                                   kernel=kern)
    n = c.read()
    n_rays = kern.states[0].shape[1]
    assert n["k1.rays_live_in"]["phase0"] == n_rays
    for k in range(1, len(schedule) + 1):
        live = int((kern.states[k - 1][12] > 0.0).sum())
        assert n["k1.rays_live_in"][f"phase{k}"] == live
        assert n["k1.rays_launched"][f"phase{k}"] == n_rays
    assert n["k1.rays_live_in"]["total"] == n_rays + sum(
        int((s[12] > 0.0).sum()) for s in kern.states[:-1])


def test_counted_step_is_bit_equal():
    sc, prep = _prepared("irreg")
    f = _engine()
    img, grads = _step(f, sc, prep.cam)
    with trace.counting() as c:
        img2, grads2 = _step(f, sc, prep.cam)
    n = c.read()
    assert torch.equal(img, img2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    # K1d's counters a phase and K2's replayed bounces a segment
    assert set(n["k1.ray_bounces"]) == {"total", "phase0", "phase1",
                                        "phase2"}
    assert set(n["k2.bounces"]) == {"total", "segment0", "segment1",
                                    "segment2"}
    assert 0 < n["k2.bounces"]["total"] <= n["k1.ray_bounces"]["total"]


def test_counting_nests_and_reads_plain_ints():
    """A nested ``counting()`` reads its own calls, and the outer one
    reads them too."""
    with trace.counting() as outer:
        outer.add("a", 2, "x")
        with trace.counting() as inner:
            assert trace.counters() is inner
            inner.add("a", torch.tensor(3))
            inner.add("a", torch.tensor(4, dtype=torch.int32), "y")
        assert trace.counters() is outer
    assert trace.counters() is None
    assert outer.read() == {"a": {"total": 9, "x": 2, "y": 4}}
    got = inner.read()
    assert got == {"a": {"total": 7, "y": 4}}
    assert all(type(v) is int for v in got["a"].values())


class _Variants:
    """K1 that keeps whether each launch ran its counting variant."""

    def __init__(self):
        self.with_stats = []

    def __call__(self, *args, **kw):
        self.with_stats.append(kw.get("with_stats", False))
        return tmk.megakernel(*args, **kw)


@pytest.mark.parametrize("unit", ["render", "step"])
def test_counting_without_stats_keeps_the_main_path_kernels(unit):
    """``counting(stats=False)`` runs K1 as the main path does and counts
    launches, rays and bounces alone; ``counting()`` runs K1's counting
    variant; the images are bit-equal."""
    sc, prep = _prepared("irreg")
    images = []
    for stats in (False, True):
        kern = _Variants()
        with trace.counting(stats=stats) as c:
            if unit == "render":
                images.append(tmk.render_pallas_twophase(
                    prep.pallas, prep.cam, SIZE, SIZE,
                    max_depth=RENDER_DEPTH, tile=256, schedule=(3, 6),
                    sort_prefix=(None, 0.25), kernel=kern))
            else:
                f = make_render_pallas_diff(
                    SIZE, SIZE, max_depth=STEP_DEPTH, tile=256,
                    block=(16, 16), schedule=STEP_SCHEDULE,
                    sort_prefix=STEP_PREFIX, fwd_kernel=kern)
                images.append(_step(f, sc, prep.cam)[0])
        n = c.read()
        assert kern.with_stats == [stats] * 3
        assert ("k1.slot_tests" in n) == stats
        assert set(n["k1.rays_live_in"]) == {"total", "phase0", "phase1",
                                             "phase2"}
        assert ("k2.bounces" in n) == (unit == "step")
    assert torch.equal(images[0], images[1])


TRAIN_SPANS = {"rt.grad.forward", "rt.grad.backward", "rt.allreduce",
               "rt.optim"}


@pytest.fixture(params=["gloo", None], ids=["gloo", "no_group"])
def train_mesh(request):
    """A one-rank mesh over a gloo process group (a ``HashStore``), as
    ``chip_smoke.py`` runs the trainer over NCCL, or over none."""
    import torch.distributed as dist
    if request.param is None:
        yield RayMesh(0, 1, None, torch.device(CPU))
        return
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield ray_mesh(device=CPU)
    finally:
        dist.destroy_process_group()


def _train(mesh):
    """A train step of the colours alone, its state and its target."""
    sc, prep = _prepared("rgbbox")
    sph = sc.spheres
    mask = tgeo.Spheres(torch.zeros_like(sph.center),
                        torch.zeros_like(sph.radius),
                        torch.ones_like(sph.color))
    step = make_train_step_pallas(
        mesh, SIZE, SIZE, max_depth=STEP_DEPTH, trainable=mask, tile=256,
        block=(16, 16), schedule=STEP_SCHEDULE, sort_prefix=STEP_PREFIX)
    target = torch.rand(SIZE, SIZE, 3,
                        generator=torch.Generator().manual_seed(3))
    return step, lambda: init_state(sph, adam(2e-3)), prep.cam, target


def test_train_spans_nest_under_train(train_mesh):
    step, state, cam, target = _train(train_mesh)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state(), cam, target)
    spans = _spans(prof)
    assert [n for n, parent in spans if parent is None] == ["rt.train"]
    assert {n for n, p in spans if p == "rt.train"} == TRAIN_SPANS
    names = [n for n, _ in spans]
    assert names.index("rt.grad.backward") < names.index("rt.allreduce") \
        < names.index("rt.optim")


def test_train_counters_and_bit_equal_state(train_mesh):
    """A step adds one to ``train.steps`` and one all-reduce of the loss
    and the three leaves' gradients, (1 + 7 n) float32 for n spheres;
    counting changes no bit of the updated state."""
    step, state, cam, target = _train(train_mesh)
    plain, counted = state(), state()
    for _ in range(2):
        step(plain, cam, target)
    with trace.counting() as c:
        for _ in range(2):
            step(counted, cam, target)
    n = c.read()
    spheres = plain.spheres.center.shape[0]
    assert n["train.steps"] == {"total": 2}
    assert n["mesh.allreduce_calls"] == {"total": 2, "train": 2}
    assert n["mesh.allreduce_bytes"] == {"total": 2 * (1 + 7 * spheres) * 4,
                                         "train": 2 * (1 + 7 * spheres) * 4}
    assert all(torch.equal(a, b) for a, b in zip(plain.leaves(),
                                                 counted.leaves()))


def test_gather_counts_under_its_caller():
    mesh = RayMesh(0, 2, None, torch.device(CPU))
    with trace.counting() as c:
        out = all_gather(mesh, lambda r: torch.full((3,), float(r)))
    assert out.tolist() == [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    assert c.read() == {"mesh.allreduce_calls": {"total": 1, "gather": 1},
                        "mesh.allreduce_bytes": {"total": 12, "gather": 12}}


def test_no_span_in_an_untraced_train_step(monkeypatch, train_mesh):
    """Untraced, the trainer's spans are the shared null context.  (The
    optimizer's step opens torch's own ``record_function`` whatever the
    port does, so only the port's range is refused here.)"""
    def refuse(*args, **kw):
        raise AssertionError("a span was entered untraced")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    step, state, cam, target = _train(train_mesh)
    assert trace.span("rt.train") is trace.span("rt.optim")
    step(state(), cam, target)
