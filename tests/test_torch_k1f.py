"""K1f, the last static modes of the port's K1, on the CPU (its plain
version) against the JAX megakernel, which runs as the JAX package's own
tests run it: ``interpret=True``, each case once per module.

* cluster widths 32 and 64 (``build_pallas_scene(cluster_width=)``): the
  tables equal JAX's field for field, and renders equal the width-128 ones
  bit for bit (tests/test_pallas.py:352) and JAX's at depth 1;
* the near-root-only search (``far_root=False``): bit-exact against JAX at
  depth 1, within tests/test_pallas.py:73's structural tolerance deeper, and
  different from the far-root search where a ray starts inside a sphere;
* the compaction options of ``render_pallas_twophase`` (``seg_tiles``,
  ``coherent``, ``occl_cont``, ``tile2``, ``lane_groups``): the same image as
  one launch (tests/test_pallas.py:122, 277-284);
* the fwd+bwd engine at cluster width 64 (tests/test_pallas_diff.py:341) and
  the ``backward="xla"`` options ``bwd_chunks``, ``sort_by_depth`` and
  ``skip_dead`` (tests/test_pallas_diff.py:115-150).

Deeper than depth 1 the two packages differ in the last bits by design (XLA's
CPU code fuses multiply-adds; the port does not): ROADMAP queue 3.
"""
import functools
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracers_tpu import camera as jcamera
from raytracers_tpu import scenes as jscenes
from raytracers_tpu.geometry import Spheres as JSpheres
from raytracers_tpu.grad.pallas_diff import make_render_pallas_diff as jmake
from raytracers_tpu.render import pallas_kernel as jpk
from raytracers_tpu_torch import convert
from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.geometry import Camera, Spheres
from raytracers_tpu_torch.grad import diff_render as tdr
from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
from raytracers_tpu_torch.image import pixel_to_rgb
from raytracers_tpu_torch.render import bruteforce as tbf
from raytracers_tpu_torch.render import megakernel as tmk
from raytracers_tpu_torch.render.tracer import primary_rays

torch.set_num_threads(2)
CPU = "cpu"


def _eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _structural(img, ref, max_mismatch=0.12, max_mean_delta=4.0):
    """tests/test_pallas.py:73's tolerance for f32 mirror cascades."""
    img, ref = np.asarray(img), np.asarray(ref)
    delta = np.abs(pixel_to_rgb(img).astype(np.int32)
                   - pixel_to_rgb(ref).astype(np.int32)).mean()
    assert (img != ref).mean() < max_mismatch
    assert delta < max_mean_delta


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(JAX spheres, JAX camera, port spheres, port camera) at aspect 1."""
    jsc = jscenes.by_name(name)
    args = (jsc.look_from, jsc.look_at, (0., 1., 0.), jsc.fov, 1.0)
    return (jsc.spheres, jcamera(*args), convert.spheres(jsc.spheres, CPU),
            tgeo.camera(*args, device=CPU))


@functools.lru_cache(maxsize=None)
def _layouts(name, width):
    """The unsorted JAX and port layouts of a scene at ``width``."""
    jsph, _, sph, _ = _scene(name)
    return (jpk.build_pallas_scene(jsph, cluster_width=width),
            tmk.build_pallas_scene(sph, cluster_width=width))


# ---------------------------------------------------------------------------
# layout


def _layout_case(case):
    """(JAX spheres, sort_origin) of a layout case."""
    if case == "soup-300":
        # a ragged soup: 300 spheres, a partial last cluster at both widths
        return jscenes.random_spheres(300, seed=2, extent=20.0), None
    name, _, sort = case.partition("-")
    sc = jscenes.by_name(name)
    return sc.spheres, (sc.look_from if sort else None)


# (case, width) -> (clusters, cull blocks, tail rows)
LAYOUTS = {
    ("rgbbox", 64): (7, 1, 16), ("rgbbox", 32): (13, 1, 16),
    ("rgbbox-sorted", 64): (7, 1, 16), ("rgbbox-sorted", 32): (13, 1, 16),
    ("irreg", 64): (157, 3, 16), ("irreg", 32): (313, 5, 16),
    ("irreg-sorted", 64): (157, 3, 64), ("irreg-sorted", 32): (313, 5, 32),
    ("soup-300", 64): (5, 1, 64), ("soup-300", 32): (10, 1, 16),
}


@pytest.mark.parametrize("case,width", list(LAYOUTS))
def test_layout_equals_jax(case, width):
    jsph, origin = _layout_case(case)
    ref = jpk.build_pallas_scene(jsph, sort_origin=origin,
                                 cluster_width=width)
    port = tmk.build_pallas_scene(convert.spheres(jsph, CPU),
                                  sort_origin=origin, cluster_width=width)
    C, CB, P = LAYOUTS[case, width]
    assert (port.n_clusters, port.aabbT.shape[0], port.tailT.shape[0]) == (
        C, CB, P)
    assert port.cluster_width == width and port.order.shape == (C, 128)
    for field in tmk.PallasScene._fields:
        p, r = getattr(port, field), getattr(ref, field)
        assert p.dtype == torch.from_numpy(np.array(r)).dtype, field
        _eq(p, r)


def test_narrow_clusters_of_a_small_scene_raise_in_both():
    """At most 128 spheres are one padded 128-row cluster: JAX fails to
    reshape it to W = 64 rows (pallas_kernel.py:165-192, 212), and the port
    raises too (ROADMAP queue 3).  200 spheres work."""
    jsph = jscenes.random_spheres(100, seed=1, extent=10.0)
    with pytest.raises(TypeError):
        jpk.build_pallas_scene(jsph, cluster_width=64)
    with pytest.raises(ValueError, match="cluster_width 64"):
        tmk.build_pallas_scene(convert.spheres(jsph, CPU), cluster_width=64)
    with pytest.raises(ValueError, match="cluster_width 48"):
        tmk.build_pallas_scene(convert.spheres(jsph, CPU), cluster_width=48)
    big = jscenes.random_spheres(200, seed=1, extent=10.0)
    assert tmk.build_pallas_scene(convert.spheres(big, CPU),
                                  cluster_width=64).n_clusters == 4


def test_kernel_flags_at_narrow_widths():
    """The tail peel keeps JAX's P < 128 rule, so a full last cluster of a
    narrow layout is visited at its W rows; narrow irreg takes the two-level
    cull with no peel; rgbbox at C = 7 and 13 has no occlusion gate unless
    it is forced."""
    _, ps64 = _layouts("rgbbox", 64)
    flags = tmk._kernel_flags(ps64)
    assert (flags.cull, flags.occl, flags.two_level, flags.tail_rows) == (
        True, False, False, 16)
    assert tmk._kernel_flags(ps64, force_occl=True).occl
    assert not tmk._kernel_flags(ps64, cull=False, force_occl=True).occl
    _, irr = _layouts("irreg", 32)
    flags = tmk._kernel_flags(irr)
    assert flags.two_level and flags.occl and flags.tail_rows == 32
    assert tmk._kernel_flags(irr, cull=False).tail_rows == 16


# ---------------------------------------------------------------------------
# renders at narrow widths


@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("name,side,depth", [("rgbbox", 24, 4),
                                             ("irreg", 32, 6)])
def test_narrow_width_equals_width_128(name, side, depth, width):
    """tests/test_pallas.py:352 on the port: winners are order-independent
    outside key-floor tie buckets, and these configs hit none."""
    _, _, sph, cam = _scene(name)
    ps128 = tmk.build_pallas_scene(sph)
    _, ps = _layouts(name, width)
    kw = dict(max_depth=depth, tile=256)
    a = tmk.render_pallas(ps128, cam, side, side, **kw)
    b = tmk.render_pallas(ps, cam, side, side, **kw)
    assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_render(name, width, depth, far_root=True, lane_groups=None):
    _, jcam, _, _ = _scene(name)
    jps = (jpk.build_pallas_scene(_scene(name)[0]) if width == 128
           else _layouts(name, width)[0])
    return np.asarray(jpk.render_pallas(jps, jcam, 32, 32, max_depth=depth,
                                        tile=256, far_root=far_root,
                                        lane_groups=lane_groups,
                                        interpret=True))


def _port_render(name, width, depth, **kw):
    _, _, sph, cam = _scene(name)
    ps = (tmk.build_pallas_scene(sph) if width == 128
          else _layouts(name, width)[1])
    return tmk.render_pallas(ps, cam, 32, 32, max_depth=depth, tile=256,
                             **kw).numpy()


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_width_64_depth1_vs_jax(name):
    _eq(_port_render(name, 64, 1), _jax_render(name, 64, 1))


def test_width_64_deep_structural_vs_jax():
    _structural(_port_render("rgbbox", 64, 6), _jax_render("rgbbox", 64, 6))


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_width_32_depth1_vs_jax(name):
    """JAX's own width-32 kernel (irreg at C = 313 on its two-level cull):
    the port's key and tie order are JAX's at this width too."""
    _eq(_port_render(name, 32, 1), _jax_render(name, 32, 1))


def test_width_32_deep_structural_vs_jax():
    """rgbbox 96x96 depth 6: within the structural tolerance of JAX's
    width-32 render, and the pixels where width 32 differs from width 128
    (rays whose winner is decided inside a 2^-16 key-floor tie bucket, which
    the narrower clusters reorder) are the same pixels in both packages."""
    jsph, jcam, sph, cam = _scene("rgbbox")
    kw = dict(max_depth=6, tile=256)
    jax_imgs = [np.asarray(jpk.render_pallas(
        jpk.build_pallas_scene(jsph, cluster_width=w), jcam, 96, 96,
        interpret=True, **kw)) for w in (32, 128)]
    port_imgs = [tmk.render_pallas(tmk.build_pallas_scene(
        sph, cluster_width=w), cam, 96, 96, **kw).numpy() for w in (32, 128)]
    _structural(port_imgs[0], jax_imgs[0])
    moved = port_imgs[0] != port_imgs[1]
    assert moved.any()
    _eq(moved, jax_imgs[0] != jax_imgs[1])


# ---------------------------------------------------------------------------
# the near-root-only search


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_far_root_false_depth1_vs_jax(name):
    _eq(_port_render(name, 128, 1, far_root=False),
        _jax_render(name, 128, 1, far_root=False))


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_far_root_false_deep_structural_vs_jax(name):
    _structural(_port_render(name, 128, 6, far_root=False),
                _jax_render(name, 128, 6, far_root=False))


def test_far_root_false_differs_inside_a_sphere():
    """A camera inside a large sphere: the far-root search hits its inner
    wall, the near-root search passes through it to the sky and the small
    sphere beyond (bit-exact against JAX at depth 1 both ways)."""
    centre = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -8.0]], np.float32)
    radius = np.array([3.0, 1.5], np.float32)
    color = np.array([[0.9, 0.9, 0.9], [0.8, 0.2, 0.2]], np.float32)
    jsph = JSpheres(jnp.asarray(centre), jnp.asarray(radius),
                    jnp.asarray(color))
    sph = Spheres(*(torch.from_numpy(x) for x in (centre, radius, color)))
    args = ((0., 0., 1.), (0., 0., -8.), (0., 1., 0.), 40.0, 1.0)
    jps = jpk.build_pallas_scene(jsph)
    ps = tmk.build_pallas_scene(sph)
    cam = tgeo.camera(*args, device=CPU)
    imgs = {}
    for far in (True, False):
        imgs[far] = tmk.render_pallas(ps, cam, 16, 16, max_depth=1,
                                      tile=256, far_root=far).numpy()
        _eq(imgs[far], jpk.render_pallas(jps, jcamera(*args), 16, 16,
                                         max_depth=1, tile=256, far_root=far,
                                         interpret=True))
    assert (imgs[True] != imgs[False]).mean() > 0.5


# ---------------------------------------------------------------------------
# compaction options and lane groups


@functools.lru_cache(maxsize=None)
def _irreg_sorted():
    _, _, sph, cam = _scene("irreg")
    sc = tscenes.irreg(device=CPU)
    return tmk.build_pallas_scene(sph, sort_origin=sc.look_from), cam


TWOPHASE_OPTIONS = {
    "seg_tiles": dict(seg_tiles=4),
    "seg_tiles_with_prefix": dict(seg_tiles=4, sort_prefix=(None, 0.5)),
    "coherent_occl_cont": dict(coherent=True, occl_cont=True),
    "coherent": dict(coherent=True),
    "tile2": dict(tile2=512, sort_prefix=(None, 0.5)),
    "lane_groups": dict(lane_groups=2),
    "near_root": dict(far_root=False),
}


@pytest.mark.parametrize("option", list(TWOPHASE_OPTIONS))
def test_twophase_options_equal_one_launch(option):
    """tests/test_pallas.py:122, 277-284 on the port: irreg 64x64, depth 50,
    block tiles, schedule (3, 8).  ``seg_tiles`` with a sort prefix is the
    case whose segmented unpermute scrambles JAX's image (ROADMAP queue 3);
    the port's equals one launch."""
    ps, cam = _irreg_sorted()
    kw = dict(max_depth=50, tile=256, block=(16, 16))
    extra = TWOPHASE_OPTIONS[option]
    one = tmk.render_pallas(ps, cam, 64, 64, far_root=extra.get(
        "far_root", True), **kw)
    two = tmk.render_pallas_twophase(ps, cam, 64, 64, schedule=(3, 8),
                                     **extra, **kw)
    assert torch.equal(one, two)


def test_occl_cont_and_coherent_on_rgbbox():
    """tests/test_pallas.py:277-284: rgbbox 40x40 depth 30, the forced gate
    at C = 4 in the continuations, equal to one launch; the forced gate
    runs fewer slot tests than the ungated continuations."""
    _, _, sph, cam = _scene("rgbbox")
    ps = tmk.build_pallas_scene(sph)
    one = tmk.render_pallas(ps, cam, 40, 40, max_depth=30)
    kw = dict(max_depth=30, schedule=(4, 8), with_stats=True)
    img, gated = tmk.render_pallas_twophase(ps, cam, 40, 40, coherent=True,
                                            occl_cont=True, **kw)
    _, plain = tmk.render_pallas_twophase(ps, cam, 40, 40, **kw)
    assert torch.equal(one, img)
    assert gated["phase_slot_tests"][0] == plain["phase_slot_tests"][0]
    assert gated["slot_tests"] < plain["slot_tests"]


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_lane_groups_depth1_vs_jax(name):
    """JAX runs two gated lane groups of 128 rays a tile (culled, one cull
    block, 256 % 256 == 0); the port's per-ray gates give its image."""
    _eq(_port_render(name, 128, 1, lane_groups=2),
        _jax_render(name, 128, 1, lane_groups=2))


def test_lane_groups_fallback_and_validation():
    """JAX's fallback rule (pallas_kernel.py:1403-1416) picks one group
    unless culled, one cull block and the tile splits into whole 128-lane
    groups; on the port every valid count, resolved or fallen back, gives
    the image of none, and an invalid one raises."""
    _, _, sph, cam = _scene("rgbbox")
    ps = tmk.build_pallas_scene(sph)
    kw = dict(max_depth=4, tile=256)
    ref = tmk.render_pallas(ps, cam, 16, 16, **kw)
    for extra in (dict(lane_groups=2), dict(lane_groups=4),
                  dict(lane_groups=2, cull=False)):
        assert torch.equal(tmk.render_pallas(ps, cam, 16, 16, **kw, **extra),
                           ref)
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="lane_groups"):
            tmk.render_pallas(ps, cam, 16, 16, lane_groups=bad, **kw)
    params = tmk._ray_order(_scene("rgbbox")[3], 16, 16, 256, None, 0.0,
                            None, 1).params
    with pytest.raises(ValueError, match="lane_groups"):
        tmk.megakernel(ps, params, 256, 256, lane_groups=0)
    with pytest.raises(ValueError, match="tile2"):
        tmk.render_pallas_twophase(ps, _scene("rgbbox")[3], 16, 16,
                                   max_depth=10, tile=256, tile2=384)


@pytest.mark.parametrize("port,ref,extra", [
    (tmk.render_pallas, jpk.render_pallas, ["kernel"]),
    (tmk.render_pallas_twophase, jpk.render_pallas_twophase, ["kernel"]),
    (tmk.render_pallas_record, jpk.render_pallas_record, ["kernel"]),
    (tmk.render_pallas_record_twophase, jpk.render_pallas_record_twophase,
     ["kernel"]),
    (make_render_pallas_diff, jmake, ["fwd_kernel", "bwd_kernel"]),
])
def test_signatures_match_jax(port, ref, extra):
    """Every parameter of the JAX function but ``interpret``, in its order
    and with its default, then the port's kernel hooks: a JAX call passes
    unchanged."""
    p = inspect.signature(port).parameters
    r = inspect.signature(ref).parameters
    names = [n for n in r if n != "interpret"]
    assert list(p) == names + extra
    for n in names:
        assert p[n].default == r[n].default, n


# ---------------------------------------------------------------------------
# the fwd+bwd engine


def _weights(shape):
    return np.sin(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)


def _port_grads(f, spheres, cam, loss="sq"):
    sph = Spheres(*(t.clone().requires_grad_(True) for t in spheres))
    c = Camera(*(t.clone().requires_grad_(True) for t in cam))
    img = f(sph, c)
    w = img if loss == "sq" else torch.from_numpy(_weights(img.shape))
    val = (img * w).sum()
    val.backward()
    return val.detach(), [t.grad for t in (*sph, *c)]


# centre, radius, colour, then the camera's origin, llc, horizontal, vertical
# (tests/test_torch_pallas_diff.py)
TOLS = (1e-2, 1e-2, 3e-3, 3e-3, 3e-3, 3e-3, 3e-3)


@functools.lru_cache(maxsize=None)
def _engine_irreg(width):
    _, _, sph, cam = _scene("irreg")
    f = make_render_pallas_diff(16, 16, max_depth=2, tile=256,
                                cluster_width=width)
    return _port_grads(f, sph, cam, loss="sin")


def test_engine_width_64_equals_width_128():
    """tests/test_pallas_diff.py:341 on the port: slots are cluster*128 +
    lane at any width, so loss and gradients are bit-identical."""
    l1, g1 = _engine_irreg(None)
    l2, g2 = _engine_irreg(64)
    assert torch.equal(l1, l2)
    assert all(g.abs().max() > 0 for g in g1)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_engine_width_64_vs_jax():
    """Against JAX's width-64 engine, within the port-vs-JAX tolerances of
    tests/test_torch_pallas_diff.py (relative to the largest magnitude)."""
    jsph, jcam, _, _ = _scene("irreg")
    jf = jmake(16, 16, max_depth=2, tile=256, interpret=True,
               cluster_width=64)

    def L(s, c):
        img = jf(s, c)
        return jnp.sum(img * jnp.asarray(_weights(img.shape)))

    gs, gc = jax.grad(L, argnums=(0, 1))(jsph, jcam)
    _, grads = _engine_irreg(64)
    for a, b, tol in zip(grads, [*gs, *gc], TOLS):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / (np.abs(b).max() + 1e-8)
        assert err < tol, err


@functools.lru_cache(maxsize=None)
def _xla_grads(**kw):
    _, _, sph, cam = _scene("rgbbox")
    f = make_render_pallas_diff(16, 16, max_depth=6, backward="xla",
                                **dict(kw))
    return _port_grads(f, sph, cam)


def _close(a, b, rtol, atol):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("chunks", [3, 4])
def test_xla_bwd_chunks_match(chunks):
    """tests/test_pallas_diff.py:115: chunked replays sum the same ray
    contributions in chunk order (3 chunks pad the last one with inert
    rays)."""
    l1, g1 = _xla_grads()
    l4, g4 = _xla_grads(bwd_chunks=chunks)
    assert torch.equal(l1, l4)
    _close(g1, g4, 1e-5, 1e-6)


@pytest.mark.parametrize("skip_dead", [None, False])
def test_xla_sort_by_depth_matches_unsorted(skip_dead):
    """tests/test_pallas_diff.py:129: the depth-sorted replay (skipping dead
    step groups by default) against the unsorted one, up to the ray sums'
    order."""
    _, g1 = _xla_grads(bwd_chunks=4)
    _, g2 = _xla_grads(bwd_chunks=4, sort_by_depth=True, skip_dead=skip_dead)
    _close(g1, g2, 2e-3, 3e-4)
    assert all(g.abs().max() > 0 for g in g2)


def test_xla_skip_dead_unsorted_is_exact():
    """Skipping all-dead step groups without sorting changes nothing: the
    rays' deepest path sets the live groups, and dead steps are the
    identity."""
    _, g1 = _xla_grads()
    _, g2 = _xla_grads(skip_dead=True)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("group,remat", [(1, False), (3, True), (8, False),
                                         (64, True)])
def test_replay_skip_dead_equals_dense(group, remat):
    """``replay_paths(skip_dead=True)`` over a batch whose paths end early:
    colours and gradients bit-identical to the dense replay at every group
    size (a group past the depth is one group)."""
    sph = Spheres(torch.tensor([[0.0, 0.0, -5.0], [2.5, 0.0, -4.0]]),
                  torch.tensor([1.5, 1.0]),
                  torch.tensor([[0.8, 0.3, 0.2], [0.2, 0.6, 0.9]]))
    cam = tgeo.camera((0., 0., 2.), (0., 0., -5.), (0., 1., 0.), 60.0, 1.0,
                      device=CPU)
    o, d = primary_rays(cam, 12, 12)
    idxs, events = tdr.trace_paths(tbf.make_closest_hit(sph), sph, o, d, 20)
    assert (events[-1] == tdr.EV_INACTIVE).all()
    assert (events == tdr.EV_BOUNCE).any()
    out = []
    for skip in (False, True):
        leaves = Spheres(*(t.clone().requires_grad_(True) for t in sph))
        col = tdr.replay_paths(leaves, o, d, idxs, events, remat=remat,
                               skip_dead=skip, skip_group=group)
        (col * col).sum().backward()
        out.append([col.detach()] + [t.grad for t in leaves])
    for a, b in zip(*out):
        assert torch.equal(a, b)
