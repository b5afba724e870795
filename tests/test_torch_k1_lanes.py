"""K1's two routes: a thread per ray and a warp per ray.

The CUDA kernel (``csrc/megakernel.cu``) runs each ray on one thread
(``kLanes = 1``) or on one warp of 32 lanes (``kLanes = 32``); the wrapper
picks the route of each launch with ``lanes_per_ray`` from what it knows
without reading the device, and ``_lanes`` overrides it for tests and
measurements.  Both routes compute one function, bit-equal to
``megakernel_reference``.

On the CPU: the route of every launch of each main-path cell's schedule
(``pallas_config`` and ``pallas_diff_config`` of rgbbox, irreg and plane,
and the 1M soup's one launch), and the validation of ``_lanes``.  The cases
marked ``cuda`` hold both routes bit-equal to the plain version in images,
state rows, counters, records and pay; they skip without a card.  On a
machine with the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k1_lanes.py -m cuda
"""
import pytest
import torch

from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
from raytracers_tpu_torch.render import megakernel as tmk
from raytracers_tpu_torch.render.api import pallas_config, pallas_diff_config
from raytracers_tpu_torch.utils.trace import counting

CPU = "cpu"
SIZE = 64
# the lanes per ray of each launch of a main-path cell, in launch order
RENDER_ROUTES = {"rgbbox": [1, 32, 32, 32], "irreg": [1, 32, 32],
                 "plane": [1, 32, 32, 32]}
FWDBWD_ROUTES = {"rgbbox": [1, 32, 32, 32], "irreg": [1, 32, 32],
                 "plane": [1, 32, 32]}
SOUP_ROUTE = 32


class _Spy:
    """K1's plain version, keeping the lanes per ray the route rule gives
    each launch were it of ``main_rays`` rays (the main path's count; the
    spied render is small)."""

    def __init__(self, main_rays):
        self.main_rays, self.lanes = main_rays, []

    def __call__(self, scene, params, n_rays, tile, **kw):
        self.lanes.append(tmk.lanes_per_ray(
            self.main_rays, kw.get("state_in") is not None))
        return tmk.megakernel(scene, params, n_rays, tile, **kw)


def _main_rays(sc, tile, block):
    """The padded ray count of the main path's 1000x1000 render."""
    return tmk._ray_order(_camera(sc), 1000, 1000, tile, block, 0.0, None,
                          0).n_rays


def _camera(sc, device=CPU):
    return tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                       device=device)


@pytest.mark.parametrize("name", ["rgbbox", "irreg", "plane"])
def test_route_of_every_render_launch(name):
    """The render's schedule (``pallas_config``, the layout front to back):
    one route per launch, as the rule gives it at the main path's size."""
    sc = tscenes.by_name(name, device=CPU)
    ps = tmk.build_pallas_scene(sc.spheres, sort_origin=sc.look_from)
    tile, block, schedule, prefix = pallas_config(ps.n_clusters)
    spy = _Spy(_main_rays(sc, tile, block))
    tmk.render_pallas_twophase(ps, _camera(sc), 8, 8, max_depth=50,
                               tile=tile, block=block, schedule=schedule,
                               sort_prefix=prefix, kernel=spy)
    assert spy.lanes == RENDER_ROUTES[name]
    # a small render's generated rays take a warp each too
    assert tmk.lanes_per_ray(200 * 200, False) == 32


@pytest.mark.parametrize("name", ["rgbbox", "irreg", "plane"])
def test_route_of_every_fwdbwd_launch(name):
    """The fwd+bwd engine's K1d launches (``pallas_diff_config``, the
    engine's unsorted layout)."""
    sc = tscenes.by_name(name, device=CPU)
    ps = tmk.build_pallas_scene(sc.spheres)
    tile, block, schedule, prefix = pallas_diff_config(ps.n_clusters)
    spy = _Spy(_main_rays(sc, tile, block))
    f = make_render_pallas_diff(8, 8, max_depth=50, tile=tile, block=block,
                                schedule=schedule, sort_prefix=prefix,
                                fwd_kernel=spy)
    with torch.no_grad():
        f(sc.spheres, _camera(sc))
    assert spy.lanes == FWDBWD_ROUTES[name]


def test_route_of_the_soup_launch():
    """The 1M soup's render (256x256, depth 5, tile 2048, blocks (8, 256):
    65,536 generated rays in one two-level launch), driven on a 20k soup
    (C = 157, three cull blocks) at 8x8."""
    sph = tscenes.random_spheres(20_000, seed=5, extent=200.0, device=CPU)
    cam = tgeo.camera((0., 0., 260.), (0., 0., 0.), (0., 1., 0.), 60.0, 1.0,
                      device=CPU)
    ps = tmk.build_pallas_scene(sph)
    assert ps.aabbT.shape[0] == 3
    spy = _Spy(256 * 256)
    tmk.render_pallas(ps, cam, 8, 8, max_depth=5, tile=64, kernel=spy)
    assert spy.lanes == [SOUP_ROUTE]


@pytest.mark.parametrize("lanes", [None, 1, 32])
def test_lanes_accepted(lanes):
    sc = tscenes.by_name("rgbbox", device=CPU)
    ps = tmk.build_pallas_scene(sc.spheres)
    ro = tmk._ray_order(_camera(sc), 16, 16, 256, None, 0.0, None, 3)
    out, _ = tmk.megakernel(ps, ro.params, ro.n_rays, 256, _lanes=lanes)
    ref, _ = tmk.megakernel_reference(ps, ro.params, ro.n_rays, 256)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("lanes", [0, 2, 16, 64, True, False, 1.0, "32"])
def test_lanes_rejected(lanes):
    sc = tscenes.by_name("rgbbox", device=CPU)
    ps = tmk.build_pallas_scene(sc.spheres)
    ro = tmk._ray_order(_camera(sc), 16, 16, 256, None, 0.0, None, 3)
    with pytest.raises(ValueError, match="_lanes"):
        tmk.megakernel(ps, ro.params, ro.n_rays, 256, _lanes=lanes)


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_k1_bound_counts_no_more_than_the_work(name):
    """``chip_smoke``'s K1 bound is a lower bound: a render charges at least
    its bounces less its rays as hits, no more than the hits its K1d records
    show (a miss, -1, is the sky), and charges the gate (irreg's C > 16) once
    a visit."""
    import chip_smoke
    sc = tscenes.by_name(name, device=CPU)
    ps = tmk.build_pallas_scene(sc.spheres)
    kw = dict(max_depth=50, tile=256)
    _, stats = tmk.render_pallas(ps, _camera(sc), 16, 16, with_stats=True,
                                 **kw)
    _, rec = tmk.render_pallas_record(ps, _camera(sc), 16, 16, **kw)
    misses, mirrors = int((rec == -1).sum()), int((rec >= 0).sum())
    assert misses + mirrors + int((rec == -3).sum()) == stats["ray_bounces"]
    hits = stats["ray_bounces"] - misses
    rule = max(stats["ray_bounces"] - 16 * 16, 0)
    assert 0 < rule <= hits
    assert (chip_smoke._k1_ops(stats, ps, rule)
            <= chip_smoke._k1_ops(stats, ps, hits, mirrors))
    gate = chip_smoke._k1_ops(stats, ps, 0) - (
        stats["slot_tests"] * chip_smoke.OPS_PER_SLOT
        + stats["cull_rows"] * chip_smoke.OPS_PER_CULL_ROW
        + stats["ray_bounces"] * chip_smoke.OPS_PER_BOUNCE)
    visits = stats["slot_tests"] / ps.cluster_width
    assert gate == pytest.approx(
        visits * chip_smoke.OPS_PER_GATE if ps.n_clusters > 16 else 0.0)


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K1 is a CUDA kernel")
    return torch.device("cuda")


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


class _Route:
    """K1 on one route with every launch repeated by the plain version on
    the same inputs; images or state rows, counters, records and pay at
    bounces must be bit-equal."""

    def __init__(self, lanes):
        self.lanes, self.launches = lanes, 0

    def __call__(self, *args, **kw):
        with counting() as c:
            out = tmk.megakernel(*args, _lanes=self.lanes, **kw)
        assert c.read()["k1.launches"] == {"total": 1,
                                           f"lanes{self.lanes}": 1}
        ref = tmk.megakernel_reference(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out[0]), _bits(ref[0]))
        if out[1] is not None:
            assert torch.equal(out[1], ref[1])
        if kw.get("record_depth") is not None:
            assert torch.equal(out[2], ref[2])
            if out[3] is not None:
                bnc = out[2] >= 0
                got, want = (_bits(p[:, :7].permute(1, 0, 2)[:, bnc])
                             for p in (out[3], ref[3]))
                assert torch.equal(got, want)
        self.launches += 1
        return out


def _scene(name, device, diff=False, width=None):
    sc = tscenes.by_name(name, device=device)
    ps = tmk.build_pallas_scene(sc.spheres,
                                sort_origin=None if diff else sc.look_from,
                                cluster_width=width)
    return ps, _camera(sc, device)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("depth", [1, 50])
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_route_single_phase_equals_plain(cuda, name, blocked, depth, lanes):
    """K1a/K1c: generated rays, scanline and block tiles, with counters."""
    ps, cam = _scene(name, cuda)
    run = _Route(lanes)
    _, stats = tmk.render_pallas(ps, cam, SIZE, SIZE, max_depth=depth,
                                 tile=256, block=(16, 16) if blocked else None,
                                 with_stats=True, kernel=run)
    assert run.launches == 1 and stats["slot_tests"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_route_multi_phase_equals_plain(cuda, name, lanes):
    """K1b: continuations from state, the class schedule and prefixes; the
    image equals one launch's."""
    ps, cam = _scene(name, cuda)
    _, _, schedule, prefix = pallas_config(ps.n_clusters)
    run = _Route(lanes)
    kw = dict(max_depth=50, tile=256, block=(16, 16))
    img, stats = tmk.render_pallas_twophase(
        ps, cam, SIZE, SIZE, schedule=schedule, sort_prefix=prefix,
        with_stats=True, kernel=run, **kw)
    assert run.launches == len(schedule) + 1
    assert torch.equal(img, tmk.render_pallas(ps, cam, SIZE, SIZE, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_route_record_with_pay_equals_plain(cuda, name, lanes):
    """K1d: records and pay, single- and multi-phase, the engine's layout."""
    ps, cam = _scene(name, cuda, diff=True)
    _, _, schedule, prefix = pallas_diff_config(ps.n_clusters)
    run = _Route(lanes)
    tmk.render_pallas_record(ps, cam, SIZE, SIZE, max_depth=50, tile=256,
                             with_pay=True, block=(16, 16), kernel=run)
    tmk.render_pallas_record_twophase(ps, cam, SIZE, SIZE, max_depth=50,
                                      tile=256, block=(16, 16),
                                      schedule=schedule, sort_prefix=prefix,
                                      kernel=run)
    assert run.launches == 1 + len(schedule) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("depth", [1, 8])
def test_route_scene_scale_equals_plain(cuda, depth, lanes):
    """K1e on the 20k soup (C = 157, three cull blocks): culled and
    unculled, one launch and a continuation, and K1d with pay."""
    sph = tscenes.random_spheres(20_000, seed=5, extent=200.0, device=cuda)
    cam = tgeo.camera((0., 0., 260.), (0., 0., 0.), (0., 1., 0.), 60.0, 1.0,
                      device=cuda)
    ps = tmk.build_pallas_scene(sph)
    assert ps.n_clusters == 157 and ps.aabbT.shape[0] == 3
    run = _Route(lanes)
    kw = dict(max_depth=depth, tile=256, block=(16, 16))
    img = tmk.render_pallas(ps, cam, SIZE, SIZE, kernel=run, **kw)
    off = tmk.render_pallas(ps, cam, SIZE, SIZE, cull=False, kernel=run, **kw)
    assert torch.equal(img, off)
    if depth > 1:
        two = tmk.render_pallas_twophase(ps, cam, SIZE, SIZE, schedule=(2,),
                                         kernel=run, **kw)
        assert torch.equal(two, img)
    tmk.render_pallas_record(ps, cam, SIZE, SIZE, max_depth=depth, tile=256,
                             with_pay=True, block=(16, 16), kernel=run)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("mode", ["width64", "width32", "near_root"])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_route_k1f_modes_equal_plain(cuda, name, mode, lanes):
    """K1f: clusters of 64 and 32 spheres (irreg then takes the two-level
    cull) and the near-root search, one launch and the class schedule."""
    width = {"width64": 64, "width32": 32}.get(mode)
    ps, cam = _scene(name, cuda, width=width)
    _, _, schedule, prefix = pallas_config(ps.n_clusters)
    run = _Route(lanes)
    kw = dict(max_depth=50, tile=256, block=(16, 16),
              far_root=mode != "near_root")
    one = tmk.render_pallas(ps, cam, SIZE, SIZE, kernel=run, **kw)
    two = tmk.render_pallas_twophase(ps, cam, SIZE, SIZE, schedule=schedule,
                                     sort_prefix=prefix, kernel=run, **kw)
    assert torch.equal(one, two)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_route_forced_gate_equals_plain(cuda, name, lanes):
    """The forced occlusion gate (``occl_cont``; C = 4 at rgbbox) in every
    continuation, with coherent repacking."""
    ps, cam = _scene(name, cuda)
    run = _Route(lanes)
    tmk.render_pallas_twophase(ps, cam, SIZE, SIZE, max_depth=50, tile=256,
                               block=(16, 16), schedule=(3, 8), coherent=True,
                               occl_cont=True, kernel=run)
    assert run.launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 32])
def test_route_all_dead_continuation_copies_through(cuda, lanes):
    """A continuation whose rays are all dead returns its input state, zero
    counters and records of -2 only."""
    ps, cam = _scene("irreg", cuda)
    ro = tmk._ray_order(cam, SIZE, SIZE, 256, None, 0.0, None, 7)
    st = torch.rand(tmk.N_STATE, ro.n_rays, device=cuda)
    st[12] = 0.0
    out, stats, rec, _ = tmk.megakernel(ps, ro.params, ro.n_rays, 256,
                                        state_in=st, emit_state=True,
                                        with_stats=True, record_depth=4,
                                        _lanes=lanes)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(st))
    assert not stats.any() and (rec == -2).all()
