"""The CUDA kernels against their plain versions, on the card: K1 (all
modes, K1d's records and K1f's widths, near-root search and forced
occlusion gate included), K2, the backward replay, and K3, the
per-ray traversal; and the BVH build on the card against the CPU build.

These tests need an NVIDIA card and skip without one (the kernels are CUDA
and have no CPU mode; the plain versions' tests against the JAX package run
everywhere).  On a machine with the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

``--noconftest`` because the repository's ``conftest.py`` imports JAX,
which the port neither needs nor has there.
"""
import pytest
import torch

from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.grad import replay_bwd as trb
from raytracers_tpu_torch.bvh.lbvh import build_bvh
from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
from raytracers_tpu_torch.render import megakernel as tmk
from raytracers_tpu_torch.render import traversal as ttr
from raytracers_tpu_torch.render.api import pallas_config, pallas_diff_config
from raytracers_tpu_torch.utils.trace import counting

pytestmark = pytest.mark.cuda
SIZE = 64
F32_EPS = 2.0 ** -24         # float32 unit roundoff


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1 is a CUDA kernel")
    return torch.device("cuda")


def _scene(name, device, diff=False):
    """The render's layout (clusters front to back from the camera) or,
    with ``diff``, the fwd+bwd engine's (unsorted), and the camera."""
    sc = tscenes.by_name(name, device=device)
    ps = tmk.build_pallas_scene(sc.spheres,
                                sort_origin=None if diff else sc.look_from)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device=device)
    return ps, cam


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


class _Both:
    """K1 with every launch repeated by the plain version on the same
    inputs; each result must be bit-equal."""

    def __init__(self):
        self.launches = 0

    def __call__(self, *args, **kw):
        out = tmk.megakernel(*args, **kw)
        ref = tmk.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out[0]), _bits(ref[0]))
        if out[1] is not None:
            assert torch.equal(out[1], ref[1])
        if kw.get("record_depth") is not None:
            assert torch.equal(out[2], ref[2])
            if out[3] is not None:
                # pay is defined only at bounces
                bnc = out[2] >= 0
                got, want = (_bits(p[:, :7].permute(1, 0, 2)[:, bnc])
                             for p in (out[3], ref[3]))
                assert torch.equal(got, want)
        self.launches += 1
        return out


@pytest.mark.parametrize("depth", [1, 50])
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_single_phase_kernel_equals_plain(cuda, name, blocked, depth):
    ps, cam = _scene(name, cuda)
    block = (16, 16) if blocked else None
    both = _Both()
    img, stats = tmk.render_pallas(ps, cam, SIZE, SIZE, max_depth=depth,
                                   tile=256, block=block, with_stats=True,
                                   kernel=both)
    assert both.launches == 1 and img.device.type == "cuda"
    assert stats["slot_tests"] > 0


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_multi_phase_kernel_equals_plain(cuda, name):
    ps, cam = _scene(name, cuda)
    _, _, schedule, prefix = pallas_config(ps.n_clusters)
    both = _Both()
    kw = dict(max_depth=50, tile=256, block=(16, 16), with_stats=True)
    img, stats = tmk.render_pallas_twophase(
        ps, cam, SIZE, SIZE, schedule=schedule, sort_prefix=prefix,
        kernel=both, **kw)
    one, one_stats = tmk.render_pallas(ps, cam, SIZE, SIZE, **kw)
    assert both.launches == len(schedule) + 1
    assert torch.equal(img, one)
    assert stats["slot_tests"] == one_stats["slot_tests"]


def test_launch_count_and_device_checks(cuda):
    ps, cam = _scene("rgbbox", cuda)
    params = tmk._ray_order(cam, SIZE, SIZE, 256, None, 0.0, None, 3).params
    with counting(stats=False) as c:
        tmk.megakernel(ps, params, SIZE * SIZE, 256)
        tmk.megakernel(ps, params, SIZE * SIZE, 256, emit_state=True)
        cpu_scene = tmk.PallasScene(*(f.cpu() for f in ps))
        with pytest.raises(ValueError, match="sphT"):
            tmk.megakernel(cpu_scene, params, SIZE * SIZE, 256)
    assert c.read()["k1.launches"]["total"] == 2


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_record_kernel_equals_plain(cuda, name, blocked):
    """K1d: records, pay at bounces and state rows bit-equal, single- and
    multi-phase; the multi-phase colours equal the single-phase ones."""
    ps, cam = _scene(name, cuda, diff=True)
    _, _, schedule, prefix = pallas_diff_config(ps.n_clusters)
    block = (16, 16) if blocked else None
    both = _Both()
    one, _, _, _ = tmk.render_pallas_record(ps, cam, SIZE, SIZE,
                                            max_depth=50, tile=256,
                                            with_pay=True, block=block,
                                            kernel=both)
    two, aux = tmk.render_pallas_record_twophase(
        ps, cam, SIZE, SIZE, max_depth=50, tile=256, block=block,
        schedule=schedule, sort_prefix=prefix, kernel=both)
    assert both.launches == 1 + len(schedule) + 1
    assert torch.equal(_bits(one), _bits(two))
    assert [r.shape[0] for r in aux["recs"]] == [
        *schedule, 50 - sum(schedule)]


class _BothK2:
    """K2 with every launch repeated by the plain version: per-ray outputs
    and per-bounce cotangents bit-equal; the slot table within the bound
    of a float32 sum in any order.

    The kernel adds each bounce into the table with float32 atomics, whose
    order changes from run to run.  A float32 sum of k terms in any order
    lies within about k unit roundoffs of the sum of their magnitudes from
    the exact sum; the limit is (k + 1) * 2^-24 * sum|x| per slot, against
    the float64 sum of the plain version's per-bounce cotangents."""

    def __init__(self):
        self.launches = 0

    def __call__(self, params, rec, pay, gcot, **kw):
        out = trb.replay_bwd(params, rec, pay, gcot, **kw)
        step_kw = dict(kw, reduce_slots=None)
        ref_step, ref_ray, ref_fwd = trb.replay_bwd_reference(
            params, rec, pay, gcot, **step_kw)
        step, ray, fwd = trb.replay_bwd(params, rec, pay, gcot, **step_kw)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out[1]), _bits(ref_ray))
        assert torch.equal(_bits(step), _bits(ref_step))
        if ref_fwd is not None:
            assert torch.equal(_bits(out[2]), _bits(ref_fwd))
        S = kw.get("reduce_slots")
        if S is not None:
            exact = trb.slot_table(rec, ref_step, S)
            mag = trb.slot_table(rec, ref_step, S, absolute=True)
            ids = rec.reshape(-1)
            count = torch.zeros(S, dtype=torch.float64, device=rec.device)
            count.index_add_(0, ids.clamp(min=0).long(), (ids >= 0).double())
            bound = (count[:, None] + 1.0) * F32_EPS * mag
            assert ((out[0].double() - exact).abs() <= bound).all()
        self.launches += 1
        return out


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_replay_kernel_equals_plain(cuda, name):
    """K2 whole-path and segmented (continuations with the 9-row carry) at
    the scene's pallas_diff_config, through the engine; the segmented
    gradient agrees with the whole-path one up to the slot tables'
    summation order."""
    sc = tscenes.by_name(name, device=cuda)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device=cuda)
    n_clusters = tmk.build_pallas_scene(sc.spheres).n_clusters
    _, _, schedule, prefix = pallas_diff_config(n_clusters)
    grads = []
    for sched, pref in ((None, None), (schedule, prefix)):
        both = _BothK2()
        f = make_render_pallas_diff(SIZE, SIZE, max_depth=50, tile=256,
                                    block=(16, 16), schedule=sched,
                                    sort_prefix=pref, bwd_kernel=both)
        leaves = [t.detach().requires_grad_(True) for t in (*sc.spheres,
                                                            *cam)]
        img = f(tgeo.Spheres(*leaves[:3]), tgeo.Camera(*leaves[3:]))
        (img * img).sum().backward()
        assert both.launches == (1 if sched is None else len(sched) + 1)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        # per-ray cotangents are bit-equal; only the order of the slot
        # tables' float32 sums differs
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_replayed_colours_equal_record_colours(cuda, name):
    """K2's emit_fwd replays K1d's path bit for bit at depth 50."""
    ps, cam = _scene(name, cuda, diff=True)
    col, _, rec, pay = tmk.render_pallas_record(
        ps, cam, SIZE, SIZE, max_depth=50, tile=256, with_pay=True,
        block=(16, 16))
    ro = tmk._ray_order(cam, SIZE, SIZE, 256, (16, 16), 0.0, None, 50)
    gcot = torch.zeros(trb.N_GCOT, ro.n_rays, device=cuda)
    with counting(stats=False) as c:
        _, _, fwd = trb.replay_bwd(ro.params, rec, pay, gcot, tile=256,
                                   block_tiled=True, emit_fwd=True)
    assert c.read()["k2.launches"] == {"total": 1}
    rep = tmk._to_image(ro, fwd, SIZE, SIZE).permute(1, 2, 0)
    assert torch.equal(_bits(rep.contiguous()), _bits(col))


def _soup20k(device):
    """The 20k-sphere soup of tests/test_pallas.py:88-103 (C = 157, three
    cull blocks: the scene-scale two-level cull, K1e) and its camera."""
    sph = tscenes.random_spheres(20_000, seed=5, extent=200.0, device=device)
    cam = tgeo.camera((0., 0., 260.), (0., 0., 0.), (0., 1., 0.), 60.0, 1.0,
                      device=device)
    return tmk.build_pallas_scene(sph), cam


@pytest.mark.parametrize("depth", [1, 8])
@pytest.mark.parametrize("blocked", [False, True])
def test_scene_scale_kernel_equals_plain(cuda, blocked, depth):
    """K1e: images and counters bit-equal to the plain version; culled
    equals unculled."""
    ps, cam = _soup20k(cuda)
    assert ps.aabbT.shape[0] == 3
    block = (16, 16) if blocked else None
    both = _Both()
    img, stats = tmk.render_pallas(ps, cam, SIZE, SIZE, max_depth=depth,
                                   tile=256, block=block, with_stats=True,
                                   kernel=both)
    off = tmk.render_pallas(ps, cam, SIZE, SIZE, max_depth=depth, tile=256,
                            block=block, cull=False, kernel=both)
    assert both.launches == 2 and torch.equal(img, off)
    assert stats["cull_rows"] >= 3 * stats["ray_bounces"]


def test_scene_scale_record_kernel_equals_plain(cuda):
    """K1d at CB > 1: records, pay at bounces and state rows bit-equal."""
    ps, cam = _soup20k(cuda)
    both = _Both()
    tmk.render_pallas_record(ps, cam, SIZE, SIZE, max_depth=5, tile=256,
                             with_pay=True, block=(16, 16), kernel=both)
    assert both.launches == 1


@pytest.mark.parametrize("depth", [1, 50])
@pytest.mark.parametrize("mode", ["width64", "width32", "near_root"])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_k1f_kernel_equals_plain(cuda, name, mode, depth):
    """K1f: clusters of 64 and 32 spheres (irreg then takes the two-level
    cull) and the near-root-only search, images and counters bit-equal to
    the plain version's, block-tiled."""
    sc = tscenes.by_name(name, device=cuda)
    width = {"width64": 64, "width32": 32}.get(mode)
    ps = tmk.build_pallas_scene(sc.spheres, sort_origin=sc.look_from,
                                cluster_width=width)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device=cuda)
    both = _Both()
    _, stats = tmk.render_pallas(ps, cam, SIZE, SIZE, max_depth=depth,
                                 tile=256, block=(16, 16), with_stats=True,
                                 far_root=mode != "near_root", kernel=both)
    assert both.launches == 1 and stats["slot_tests"] > 0


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_k1f_compaction_options_equal_plain(cuda, name):
    """The forced occlusion gate (``occl_cont``, C = 4 at rgbbox), the
    coherent repacking, segments and ``tile2``: every launch bit-equal to
    the plain version, and each image equal to one launch's."""
    ps, cam = _scene(name, cuda)
    kw = dict(max_depth=50, tile=256, block=(16, 16))
    one = tmk.render_pallas(ps, cam, SIZE, SIZE, **kw)
    for extra in (dict(coherent=True, occl_cont=True),
                  dict(seg_tiles=4, tile2=512, lane_groups=2)):
        both = _Both()
        img = tmk.render_pallas_twophase(ps, cam, SIZE, SIZE,
                                         schedule=(3, 8), kernel=both,
                                         **extra, **kw)
        assert both.launches == 3 and torch.equal(img, one)


def test_k1f_record_and_engine_at_width_64(cuda):
    """K1d at W = 64 bit-equal to its plain version; the engine at W = 64
    with K2 checked against its plain version, its gradients equal to the
    W = 128 engine's up to the slot tables' summation order."""
    sc = tscenes.by_name("irreg", device=cuda)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device=cuda)
    ps = tmk.build_pallas_scene(sc.spheres, cluster_width=64)
    both = _Both()
    tmk.render_pallas_record(ps, cam, SIZE, SIZE, max_depth=50, tile=256,
                             with_pay=True, block=(16, 16), kernel=both)
    assert both.launches == 1
    grads = []
    for width in (None, 64):
        f = make_render_pallas_diff(SIZE, SIZE, max_depth=50, tile=256,
                                    block=(16, 16), schedule=(3, 6),
                                    cluster_width=width, bwd_kernel=_BothK2())
        leaves = [t.detach().requires_grad_(True) for t in (*sc.spheres,
                                                            *cam)]
        img = f(tgeo.Spheres(*leaves[:3]), tgeo.Camera(*leaves[3:]))
        (img * img).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.isfinite(b).all() and b.abs().max() > 0
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


@pytest.mark.parametrize("depth", [1, 50])
@pytest.mark.parametrize("block", [None, (32, 16)])
@pytest.mark.parametrize("far_root", [True, False])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_traversal_kernel_equals_plain(cuda, name, far_root, block, depth):
    """K3: one launch a render, the image bit-equal to the plain
    version's on the same tables."""
    sc = tscenes.by_name(name, device=cuda)
    scene, C, K = ttr.build_traversal_scene(sc.spheres)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device=cuda)
    kw = dict(max_depth=depth, far_root=far_root, block=block)
    with counting(stats=False) as c:
        img = ttr.render_traversal(scene, C, K, cam, SIZE, SIZE, **kw)
    assert c.read()["k3.launches"]["total"] == 1
    ref = ttr.traversal_reference(scene, C, K, cam, SIZE, SIZE, **kw)
    torch.cuda.synchronize()
    assert img.device.type == "cuda" and torch.equal(img, ref)


@pytest.mark.parametrize("leaf_size", [1, 8, 128])
@pytest.mark.parametrize("name", ["rgbbox", "irreg", "soup"])
def test_bvh_build_on_card_equals_cpu(cuda, name, leaf_size):
    sph = (tscenes.random_spheres(50_000, seed=0, device=cuda)
           if name == "soup" else tscenes.by_name(name, device=cuda).spheres)
    card = build_bvh(sph, leaf_size=leaf_size)
    host = build_bvh(tgeo.Spheres(*(f.cpu() for f in sph)),
                     leaf_size=leaf_size)
    for a, b in zip((*card.spheres, *card[1:]), (*host.spheres, *host[1:])):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


# the multi-phase frame from CUDA graphs (render_pallas_twophase)

GRAPH_SIZE = 200
GRAPH_SCHEDULES = {"rgbbox": (3, 4, 8), "irreg": (3, 6), "soup20k": (2, 3, 6)}


@pytest.fixture
def graphs(cuda, monkeypatch):
    """A fresh cache of frame graphs."""
    from collections import OrderedDict
    monkeypatch.setattr(tmk, "_graphs", OrderedDict())
    return tmk._graphs


def _graph_kw(ps):
    """The scene class's render arguments at depth 50."""
    tile, block, schedule, prefix = pallas_config(ps.n_clusters)
    return dict(max_depth=50, tile=tile, block=block, schedule=schedule,
                sort_prefix=prefix)


def _graph_case(name, device):
    """The layout, camera and render arguments of a scene of each class
    (C <= 16, C <= 128 and C > 128)."""
    ps, cam = _soup20k(device) if name == "soup20k" else _scene(name, device)
    kw = _graph_kw(ps)
    assert kw["schedule"] == GRAPH_SCHEDULES[name]
    return ps, cam, kw


def _jittered(cam, n, seed=0):
    """``n`` cameras, the lower-left corner of each moved by up to half a
    pixel each way."""
    g = torch.Generator().manual_seed(seed)
    jit = (torch.rand(n, 2, generator=g) - 0.5).tolist()
    return [cam._replace(llc=cam.llc + (a / GRAPH_SIZE) * cam.horizontal
                         + (b / GRAPH_SIZE) * cam.vertical) for a, b in jit]


def _frame(ps, cam, kw, **extra):
    """One frame and the route ``render.graph`` counted for it."""
    with counting(stats=False) as c:
        img = tmk.render_pallas_twophase(ps, cam, GRAPH_SIZE, GRAPH_SIZE,
                                         **kw, **extra)
    (route,) = set(c.read()["render.graph"]) - {"total"}
    return img, route


@pytest.mark.parametrize("name", list(GRAPH_SCHEDULES))
def test_replayed_frames_equal_eager_frames(graphs, name):
    """Over 16 jittered cameras: one frame eager, one captured, the rest
    replayed, each bit-equal to the eager chain's frame; every frame kept
    is a tensor of its own, unchanged by the replays after it."""
    ps, cam, kw = _graph_case(name, torch.device("cuda"))
    kept, want, routes = [], [], []
    for c in _jittered(cam, 16):
        img, route = _frame(ps, c, kw)
        kept.append(img)
        routes.append(route)
        want.append(_frame(ps, c, kw, kernel=tmk.megakernel_eager)[0])
    assert routes == ["eager", "capture"] + ["replay"] * 14
    assert len({img.data_ptr() for img in kept}) == len(kept)
    torch.cuda.synchronize()
    for img, ref in zip(kept, want):
        assert torch.equal(img, ref)
    assert len({tuple(img.reshape(-1)[::97].tolist()) for img in kept}) > 1


def test_a_replay_reads_the_layout_as_it_is_now(graphs):
    """An in-place change of the spheres' colours shows in the next
    replay."""
    ps, cam, kw = _graph_case("rgbbox", torch.device("cuda"))
    for _ in range(3):
        before, route = _frame(ps, cam, kw)
    assert route == "replay"
    ps.sphT[..., 4:7] *= 0.5
    after, route = _frame(ps, cam, kw)
    want = _frame(ps, cam, kw, kernel=tmk.megakernel_eager)[0]
    assert route == "replay"
    assert torch.equal(after, want) and not torch.equal(after, before)


def test_a_rebuilt_layout_never_replays_a_stale_entry(graphs):
    """A layout rebuilt from other colours, with the first one's
    references dropped, lands at other addresses (the cache holds the
    first one's tensors): its first frame runs eagerly, with its colours."""
    sc = tscenes.by_name("irreg", device="cuda")
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device="cuda")
    ps = tmk.build_pallas_scene(sc.spheres, sort_origin=sc.look_from)
    kw = _graph_kw(ps)
    for _ in range(3):
        old, route = _frame(ps, cam, kw)
    assert route == "replay"
    addresses = {t.data_ptr() for t in ps}
    del ps
    centre, radius, colour = sc.spheres
    ps = tmk.build_pallas_scene(tgeo.Spheres(centre, radius, 1.0 - colour),
                                sort_origin=sc.look_from)
    assert not addresses & {t.data_ptr() for t in ps}
    new, route = _frame(ps, cam, kw)
    assert route == "eager"
    assert torch.equal(new, _frame(ps, cam, kw,
                                   kernel=tmk.megakernel_eager)[0])
    assert not torch.equal(new, old)


def test_a_layout_built_where_a_freed_one_was_runs_eagerly(graphs):
    """A layout of the same shapes built after the first one is dropped
    (the card's allocator may give it the freed addresses, and so the
    freed layout's key): its first frame runs eagerly, its second
    captures."""
    sc = tscenes.by_name("irreg", device="cuda")
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device="cuda")
    ps = tmk.build_pallas_scene(sc.spheres, sort_origin=sc.look_from)
    kw = _graph_kw(ps)
    assert _frame(ps, cam, kw)[1] == "eager"
    del ps
    ps = tmk.build_pallas_scene(sc.spheres, sort_origin=sc.look_from)
    assert [_frame(ps, cam, kw)[1] for _ in range(2)] == ["eager", "capture"]


def test_a_replay_counts_as_the_eager_chain(graphs):
    """Under ``counting(stats=False)`` a replayed frame adds the launches
    by route, the rays and the survivors a phase that its eager chain adds,
    and one frame to ``render.graph``."""
    ps, cam, kw = _graph_case("rgbbox", torch.device("cuda"))
    names = ("k1.launches", "k1.rays_launched", "k1.rays_live_in")
    counts = {}
    for route in ("eager", "capture", "replay", "kernel"):
        with counting(stats=False) as c:
            extra = (dict(kernel=tmk.megakernel_eager) if route == "kernel"
                     else {})
            tmk.render_pallas_twophase(ps, cam, GRAPH_SIZE, GRAPH_SIZE,
                                       **kw, **extra)
        n = c.read()
        assert set(n["render.graph"]) == {"total", "eager" if route ==
                                          "kernel" else route}
        counts[route] = {k: n[k] for k in names}
    assert counts["replay"]["k1.launches"]["total"] == 4
    for route in ("eager", "capture", "replay"):
        assert counts[route] == counts["kernel"]


def test_replayed_kernels_belong_to_their_spans(graphs):
    """Under torch.profiler, each replayed K1 launch is tied to the
    ``rt.phase<k>`` span open at its replay, and each boundary's and the
    unpermute's operations to theirs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ps, cam, kw = _graph_case("irreg", torch.device("cuda"))
    for _ in range(2):
        _frame(ps, cam, kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with counting(stats=False) as c:
            tmk.render_pallas_twophase(ps, cam, GRAPH_SIZE, GRAPH_SIZE,
                                       **kw)
        torch.cuda.synchronize()
    assert c.read()["render.graph"] == {"total": 1, "replay": 1}
    events = list(prof.events())
    tied = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("rt."):
            tied.setdefault(e.name, []).extend(k.name for k in e.kernels)
    for k in range(3):
        assert sum("megakernel<" in n for n in tied[f"rt.phase{k}"]) == 1
    assert not any("megakernel<" in n for s, ks in tied.items()
                   if not s.startswith("rt.phase") for n in ks)
    for s in ("rt.boundary0", "rt.boundary1", "rt.unpermute"):
        assert tied[s]
