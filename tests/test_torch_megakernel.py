"""K1 of the port (its plain version on the CPU) against the JAX megakernel.

The JAX side runs as its own tests run it: ``render_pallas(...,
interpret=True)``.  At depth 1 the port is bit-exact.  Deeper, f32 mirror
cascades are chaotic and the two packages differ by design in the last
bits (XLA's CPU code fuses multiplies and adds; the port does IEEE float32
without contraction, so that its CUDA kernel and its plain version compute
one function), so full-depth images are held to the structural tolerance of
``tests/test_pallas.py``.  Within the port, every repartitioning (multi-phase
schedules, sort prefixes, block tiles) is bit-identical.
"""
import os

import numpy as np
import pytest
import torch

from raytracers_tpu import camera as jcamera
from raytracers_tpu import scenes as jscenes
from raytracers_tpu.render import pallas_kernel as jpk
from raytracers_tpu_torch import convert
from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.image import pixel_to_rgb, read_ppm
from raytracers_tpu_torch.render import megakernel as tmk
from raytracers_tpu_torch.utils.trace import counting

torch.set_num_threads(2)
CPU = "cpu"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _port(name, w, h):
    sc = tscenes.by_name(name, device=CPU)
    ps = tmk.build_pallas_scene(sc.spheres, sort_origin=sc.look_from)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, w / h,
                      device=CPU)
    return ps, cam


def _jax(name, w, h):
    sc = jscenes.by_name(name)
    ps = jpk.build_pallas_scene(sc.spheres, sort_origin=sc.look_from)
    cam = jcamera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, w / h)
    return ps, cam


def _structural(img, ref, max_mismatch, max_mean_delta):
    img, ref = np.asarray(img), np.asarray(ref)
    a = pixel_to_rgb(img).astype(np.int32)
    b = pixel_to_rgb(ref).astype(np.int32)
    mismatch = (img != ref).mean()
    delta = np.abs(a - b).mean()
    assert mismatch < max_mismatch, (mismatch, max_mismatch)
    assert delta < max_mean_delta, (delta, max_mean_delta)


TILINGS = [(256, None), (256, (16, 16))]


@pytest.mark.parametrize("tile,block", TILINGS)
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_depth1_bit_exact_vs_jax(name, tile, block):
    ps, cam = _port(name, 64, 64)
    jps, jcam = _jax(name, 64, 64)
    img = tmk.render_pallas(ps, cam, 64, 64, max_depth=1, tile=tile,
                            block=block)
    ref = jpk.render_pallas(jps, jcam, 64, 64, max_depth=1, tile=tile,
                            block=block, interpret=True)
    assert img.dtype == torch.int32 and img.shape == (64, 64)
    np.testing.assert_array_equal(img.numpy(), np.asarray(ref))


@pytest.mark.parametrize("tile,block", TILINGS)
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_depth1_on_jax_layout(name, tile, block):
    """The JAX package's own tables, carried across by ``convert``: the
    port's K1 renders them to the JAX kernel's bits, apart from the
    port's layout build."""
    jps, jcam = _jax(name, 64, 64)
    ps = convert.pallas_scene(jps, CPU)
    cam = convert.camera(jcam, CPU)
    img = tmk.render_pallas(ps, cam, 64, 64, max_depth=1, tile=tile,
                            block=block)
    ref = jpk.render_pallas(jps, jcam, 64, 64, max_depth=1, tile=tile,
                            block=block, interpret=True)
    np.testing.assert_array_equal(img.numpy(), np.asarray(ref))


def test_full_depth_structural_vs_jax():
    ps, cam = _port("rgbbox", 64, 64)
    jps, jcam = _jax("rgbbox", 64, 64)
    img = tmk.render_pallas(ps, cam, 64, 64, max_depth=50, tile=256)
    ref = jpk.render_pallas(jps, jcam, 64, 64, max_depth=50, tile=256,
                            interpret=True)
    _structural(img, ref, 0.12, 4.0)


def test_one_bounce_state_is_ieee_without_contraction():
    """The port's first-bounce state equals a numpy float32 evaluation of
    the same formulas with no fused multiply-add (ray 0 of rgbbox 64x64:
    the smallest input where the JAX kernel, fused by XLA, differs)."""
    ps, cam = _port("rgbbox", 64, 64)
    params = tmk._ray_order(cam, 64, 64, 256, None, 0.0, None, 1).params
    st, _ = tmk.megakernel(ps, params, 4096, 256, emit_state=True)
    f = np.float32
    p = params.numpy()
    d = np.array([(p[k] + f(0) * p[3 + k]) + (p[17] - f(0)) * p[19] * p[6 + k]
                  - p[9 + k] for k in range(3)], f)
    o = p[9:12]
    sph = ps.sphT.reshape(-1, 8).numpy()
    a = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    best = (np.inf, -1)
    for s in range(sph.shape[0]):
        oc = o - sph[s, :3]
        b = (oc[0] * d[0] + oc[1] * d[1]) + oc[2] * d[2]
        c = ((oc[0] * oc[0] + oc[1] * oc[1]) + oc[2] * oc[2]) - sph[s, 7]
        disc = b * b - a * c
        if disc > 0:
            sq = f(np.sqrt(np.float64(disc)))
            m = -b - sq if -b - sq > f(0.1) * a else -b + sq
            if m > f(0.1) * a and m < best[0]:
                best = (m, s)
    m, s = best
    c0, rad = sph[s, :3], sph[s, 3]
    oc = o - c0
    b = (oc[0] * d[0] + oc[1] * d[1]) + oc[2] * d[2]
    c = ((oc[0] * oc[0] + oc[1] * oc[1]) + oc[2] * oc[2]) - rad * rad
    sq = f(np.sqrt(np.float64(b * b - a * c)))
    inv_a = f(1) / a
    t0, t1 = (-b - sq) * inv_a, (-b + sq) * inv_a
    key = np.array([m], f).view(np.int32) & np.int32(-128)
    w_hi = key.view(f)[0] * inv_a + f(1)
    t2 = t0 if (t0 < w_hi and t0 > 0) else t1
    hit = o + t2 * d
    n = (hit - c0) * (f(1) / rad)
    u = d * (f(1) / f(np.sqrt(np.float64(a))))
    udn = (u[0] * n[0] + u[1] * n[1]) + u[2] * n[2]
    assert st[12, 0] == 1.0                       # a mirror bounce
    np.testing.assert_array_equal(st[0:3, 0].numpy(), hit)
    np.testing.assert_array_equal(st[3:6, 0].numpy(), u - (f(2) * udn) * n)


def _golden(name):
    return read_ppm(os.path.join(GOLDEN, name))


def test_golden_rgbbox_depth1_exact():
    ps, cam = _port("rgbbox", 200, 200)
    img = tmk.render_pallas(ps, cam, 200, 200, max_depth=1, tile=2048,
                            block=(64, 32))
    np.testing.assert_array_equal(img.numpy(), _golden("rgbbox_200_d1.ppm"))


def test_golden_irreg_full_depth_structural():
    ps, cam = _port("irreg", 200, 200)
    img = tmk.render_pallas_twophase(ps, cam, 200, 200, max_depth=50,
                                     tile=2048, block=(32, 64),
                                     schedule=(3, 6), sort_prefix=(None, .25))
    _structural(img, _golden("irreg_200.ppm"), 0.02, 0.5)


def test_twophase_equals_single_phase():
    ps, cam = _port("rgbbox", 40, 40)
    a = tmk.render_pallas(ps, cam, 40, 40, max_depth=50)
    b = tmk.render_pallas_twophase(ps, cam, 40, 40, max_depth=50,
                                   schedule=(5,))
    assert torch.equal(a, b)


@pytest.mark.parametrize("prefix", [None, (None, 0.5, 0.25),
                                    (0.25, 0.07, 0.07)])
def test_schedule_and_prefixes_bit_identical(prefix):
    """A deliberately too-small prefix leaves live rays unpacked: exact
    all the same (tests/test_pallas.py:137)."""
    ps, cam = _port("rgbbox", 64, 64)
    kw = dict(max_depth=50, tile=256, block=(16, 16))
    ref = tmk.render_pallas(ps, cam, 64, 64, **kw)
    img = tmk.render_pallas_twophase(ps, cam, 64, 64, schedule=(3, 4, 8),
                                     sort_prefix=prefix, **kw)
    assert torch.equal(img, ref)


def test_block_tiles_equal_scanline():
    ps, cam = _port("rgbbox", 52, 52)
    a = tmk.render_pallas(ps, cam, 52, 52, max_depth=3)
    b = tmk.render_pallas(ps, cam, 52, 52, max_depth=3, tile=256,
                          block=(16, 16))
    assert torch.equal(a, b)


@pytest.mark.parametrize("block", [None, (8, 32)])
def test_row_slab_equals_rows_of_full_image(block):
    """``row0``/``total_height`` render rows [row0, row0+height) of a taller
    image: the same pixels as those rows of the whole render."""
    ps, cam = _port("rgbbox", 32, 32)
    tile = 256
    full = tmk.render_pallas(ps, cam, 32, 32, max_depth=3, tile=tile,
                             block=block)
    slab = tmk.render_pallas(ps, cam, 32, 16, max_depth=3, tile=tile,
                             block=block, row0=8, total_height=32)
    assert torch.equal(slab, full[8:24])
    two = tmk.render_pallas_twophase(ps, cam, 32, 16, max_depth=50,
                                     tile=tile, block=block, schedule=(2,),
                                     row0=8, total_height=32)
    deep = tmk.render_pallas(ps, cam, 32, 32, max_depth=50, tile=tile,
                             block=block)
    assert torch.equal(two, deep[8:24])


@pytest.mark.parametrize("name,schedule,prefix", [
    ("rgbbox", (3, 4, 8), (None, 0.5, 0.25)),
    ("irreg", (3, 6), (None, 0.25)),
])
def test_counters_independent_of_phases(name, schedule, prefix):
    """Per-ray work does not depend on how the rays are split into phases:
    the multi-phase counters sum to the single-phase ones."""
    ps, cam = _port(name, 48, 48)
    kw = dict(max_depth=50, tile=256, block=(16, 16), with_stats=True)
    img1, one = tmk.render_pallas(ps, cam, 48, 48, **kw)
    img2, two = tmk.render_pallas_twophase(ps, cam, 48, 48,
                                           schedule=schedule,
                                           sort_prefix=prefix, **kw)
    assert torch.equal(img1, img2)
    for key in ("slot_tests", "ray_bounces", "cull_rows"):
        assert two[key] == one[key] > 0, key
        assert sum(two[f"phase_{key}"]) == two[key]
        assert len(two[f"phase_{key}"]) == len(schedule) + 1


def test_wrapper_checks_inputs():
    ps, cam = _port("rgbbox", 16, 16)
    params = tmk._ray_order(cam, 16, 16, 256, None, 0.0, None, 1).params
    with pytest.raises(ValueError, match="params"):
        tmk.megakernel(ps, params.double(), 256, 256)
    with pytest.raises(ValueError, match="multiple"):
        tmk.megakernel(ps, params, 300, 256)
    with pytest.raises(ValueError, match="state_in"):
        tmk.megakernel(ps, params, 256, 256,
                       state_in=torch.zeros(13, 128))
    bad = ps._replace(sphT=ps.sphT.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="sphT"):
        tmk.megakernel(bad, params, 256, 256)
    with counting() as c:
        out, stats = tmk.megakernel(ps, params, 256, 256, with_stats=True)
    assert out.shape == (256,) and stats.shape == (3, 256)
    # the CPU takes the plain version: no kernel launch is counted
    assert "k1.launches" not in c.read()
