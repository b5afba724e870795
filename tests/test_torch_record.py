"""K1d, the record mode of the port's K1 (its plain version on the CPU),
against the JAX megakernel's record mode, which runs as the JAX package's
own tests run it: ``render_pallas_record(..., interpret=True)``.

The records are compared in the port's layout: JAX's raw (tiles, D, T)
and (tiles, D, 8, T) become (D, n_rays) and (D, 8, n_rays).  ``pay`` is
compared only where ``rec >= 0``, the only place the port defines it.
"""
import numpy as np
import pytest
import torch

from raytracers_tpu import camera as jcamera
from raytracers_tpu import scenes as jscenes
from raytracers_tpu.render import api as japi
from raytracers_tpu.render import pallas_kernel as jpk
from raytracers_tpu_torch import convert
from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.image import pixel_to_rgb
from raytracers_tpu_torch.render import api as tapi
from raytracers_tpu_torch.render import megakernel as tmk

torch.set_num_threads(2)
CPU = "cpu"
SIZE, TILE = 32, 256


def _scenes(name, size=SIZE):
    """Both packages' layouts of ``name`` as the fwd+bwd engine builds them
    (no front-to-back sort), and both cameras."""
    sc = jscenes.by_name(name)
    jps = jpk.build_pallas_scene(sc.spheres)
    jcam = jcamera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0)
    tsc = tscenes.by_name(name, device=CPU)
    ps = tmk.build_pallas_scene(tsc.spheres)
    cam = tgeo.camera(tsc.look_from, tsc.look_at, (0., 1., 0.), tsc.fov,
                      1.0, device=CPU)
    return (ps, cam), (jps, jcam)


def _jax_layout(rec_raw, pay):
    D = rec_raw.shape[1]
    rec = np.asarray(rec_raw).transpose(1, 0, 2).reshape(D, -1)
    pay = np.asarray(pay).transpose(1, 2, 0, 3).reshape(D, 8, -1)
    return rec, pay


def _pay_equal_where_bounce(rec, pay, jrec, jpay):
    both = (rec == jrec) & (rec >= 0)
    for k in range(rec.shape[0]):
        np.testing.assert_array_equal(pay[k, :7][:, both[k]],
                                      jpay[k, :7][:, both[k]])


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("block", [None, (16, 16)])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_depth1_records_equal_jax(name, block):
    """Depth 1: records and pay equal.  Colours agree to 1 ulp: the sky
    gradient of a miss goes through XLA's rsqrt and fused multiply-adds
    (on 1-5% of the pixels at this size), the port's through 1/sqrt."""
    (ps, cam), (jps, jcam) = _scenes(name)
    col, rec, raw, pay = tmk.render_pallas_record(
        ps, cam, SIZE, SIZE, max_depth=1, tile=TILE, with_pay=True,
        block=block)
    jcol, jrec, jraw, jpay = jpk.render_pallas_record(
        jps, jcam, SIZE, SIZE, max_depth=1, tile=TILE, interpret=True,
        with_pay=True, block=block)
    jraw, jpay = _jax_layout(jraw, jpay)
    assert col.shape == (SIZE, SIZE, 3) and rec.shape == (1, SIZE * SIZE)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    np.testing.assert_array_equal(raw.numpy(), jraw)
    assert (raw >= 0).any() and (raw == -1).any()
    _pay_equal_where_bounce(raw.numpy(), pay.numpy(), jraw, jpay)
    assert _ulps(col.numpy(), np.asarray(jcol)).max() <= 1


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_depth3_records_agree_with_jax(name):
    """Past depth 1 the rays differ from JAX's in the last bits (XLA fuses
    multiply-adds; ROADMAP queue 3), which can flip a near-tie winner: at
    least 99% of the record entries agree (all did when measured at this
    size); pay is equal wherever the records agree on a bounce; packed
    colours are held to the structural tolerance of
    tests/test_pallas.py:73."""
    (ps, cam), (jps, jcam) = _scenes(name)
    col, rec, raw, pay = tmk.render_pallas_record(
        ps, cam, SIZE, SIZE, max_depth=3, tile=TILE, with_pay=True)
    jcol, jrec, jraw, jpay = jpk.render_pallas_record(
        jps, jcam, SIZE, SIZE, max_depth=3, tile=TILE, interpret=True,
        with_pay=True)
    jraw, jpay = _jax_layout(jraw, jpay)
    assert (rec.numpy() == np.asarray(jrec)).mean() >= 0.99
    _pay_equal_where_bounce(raw.numpy(), pay.numpy(), jraw, jpay)
    img = tmk.pack_pix(*col.unbind(-1)).numpy()
    ref = tmk.pack_pix(*torch.from_numpy(np.asarray(jcol)).unbind(-1)).numpy()
    assert (img != ref).mean() < 0.12
    delta = np.abs(pixel_to_rgb(img).astype(np.int32)
                   - pixel_to_rgb(ref).astype(np.int32)).mean()
    assert delta < 4.0


def _full_records(aux, n_rays):
    """Reassemble per-ray records in the original ray order from the
    segments: the poskeys' low bits give, per position of segment k+1, the
    position in segment k that the ray came from."""
    orig = torch.arange(n_rays)
    recs, pays = [aux["recs"][0]], [aux["pays"][0]]
    for k, key in enumerate(aux["poskeys"]):
        orig = orig[(key & ((1 << 30) - 1)).long()]
        inv = torch.empty_like(orig)
        inv[orig] = torch.arange(n_rays)
        recs.append(aux["recs"][k + 1][:, inv])
        pays.append(aux["pays"][k + 1][:, :, inv])
    return torch.cat(recs), torch.cat(pays)


@pytest.mark.parametrize("schedule,prefix,block", [
    ((3, 4, 8), (None, 0.5, 0.25), (16, 16)),
    ((2, 3), (0.25, 0.1), None),
])
def test_multiphase_record_equals_single_phase(schedule, prefix, block):
    """Compaction is pure repartitioning: the colours are bit-identical and
    the segments' records, put back in ray order through the poskeys, are
    the single-phase records (a too-small prefix leaves live rays in
    place, exact all the same)."""
    (ps, cam), _ = _scenes("rgbbox")
    kw = dict(max_depth=50, tile=TILE, block=block)
    col, _, rec, pay = tmk.render_pallas_record(ps, cam, SIZE, SIZE,
                                                with_pay=True, **kw)
    col2, aux = tmk.render_pallas_record_twophase(
        ps, cam, SIZE, SIZE, schedule=schedule, sort_prefix=prefix, **kw)
    assert torch.equal(col2.view(torch.int32), col.view(torch.int32))
    assert [r.shape[0] for r in aux["recs"]] == [*schedule,
                                                 50 - sum(schedule)]
    rec2, pay2 = _full_records(aux, rec.shape[1])
    assert torch.equal(rec2, rec)
    bnc = (rec >= 0)[:, None, :].expand(-1, 8, -1).clone()
    bnc[:, 7] = False
    assert torch.equal(pay2[bnc], pay[bnc])
    for st, key in zip(aux["states"], aux["poskeys"]):
        assert st.shape == (9, rec.shape[1])
        live = (key >> 30) == 0
        assert torch.isfinite(st[:, live]).all()
    # the packed render of the same schedule gives the same pixels
    img = tmk.render_pallas_twophase(ps, cam, SIZE, SIZE, schedule=schedule,
                                     sort_prefix=prefix, **kw)
    assert torch.equal(tmk.pack_pix(*col2.unbind(-1)), img)


def test_record_leaves_the_forward_unchanged():
    """K1d writes its records beside K1's arithmetic: the state rows of a
    record launch equal those of a plain launch, bit for bit."""
    (ps, cam), _ = _scenes("irreg", 24)
    ro = tmk._ray_order(cam, 24, 24, TILE, None, 0.0, None, 7)
    st, stats = tmk.megakernel(ps, ro.params, ro.n_rays, TILE,
                               emit_state=True, with_stats=True)
    st2, stats2, rec, pay = tmk.megakernel(ps, ro.params, ro.n_rays, TILE,
                                           emit_state=True, with_stats=True,
                                           record_depth=7, record_pay=True)
    assert torch.equal(st.view(torch.int32), st2.view(torch.int32))
    assert torch.equal(stats, stats2)
    assert rec.shape == (7, ro.n_rays) and pay.shape == (7, 8, ro.n_rays)
    # every ray's record: steps while live, then -2 to the end
    dead = rec < 0
    assert ((rec == -2)[1:] | ~dead[:-1]).all()


def test_record_wrapper_checks_inputs():
    (ps, cam), _ = _scenes("rgbbox", 16)
    ro = tmk._ray_order(cam, 16, 16, TILE, None, 0.0, None, 2)
    with pytest.raises(ValueError, match="record_depth"):
        tmk.megakernel(ps, ro.params, ro.n_rays, TILE, record_pay=True)
    with pytest.raises(ValueError, match="record_depth"):
        tmk.megakernel(ps, ro.params, ro.n_rays, TILE, record_depth=0)
    out = tmk.megakernel(ps, ro.params, ro.n_rays, TILE, record_depth=2)
    assert len(out) == 4 and out[3] is None


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_render_float_pallas_vs_jax(name):
    """``render_float(mode="pallas")`` at depth 1: JAX's colours to 1 ulp
    (the sky's rsqrt, as above); and the brute mode's floats equal the
    pallas mode's where the two tracers agree (they do at depth 1)."""
    size = 24
    port = tapi.prepare_scene(tscenes.by_name(name, device=CPU), size, size,
                              with_pallas=True, with_bvh=False, device=CPU)
    ref = japi.prepare_scene(jscenes.by_name(name), size, size,
                             with_pallas=True)
    col = tapi.render_float(port, size, size, mode="pallas", max_depth=1)
    want = japi.render_float(ref, size, size, mode="pallas", max_depth=1,
                             interpret=True)
    assert col.shape == (size, size, 3) and col.dtype == torch.float32
    assert _ulps(col.numpy(), np.asarray(want)).max() <= 1
    brute = tapi.render_float(port, size, size, mode="brute", max_depth=1)
    assert (brute - col).abs().max() < 1e-6
    with pytest.raises(ValueError, match="with_bvh=True"):
        tapi.render_float(port, size, size, mode="bvh")
    # with the tree, the BVH tracer's floats equal the brute tracer's here
    bvh_port = tapi.prepare_scene(tscenes.by_name(name, device=CPU), size,
                                  size, device=CPU)
    assert torch.equal(tapi.render_float(bvh_port, size, size, mode="bvh",
                                         max_depth=1), brute)


@pytest.mark.parametrize("C", [1, 4, 16, 17, 79, 128])
def test_pallas_diff_config_values(C):
    assert tapi.pallas_diff_config(C) == japi.pallas_diff_config(C)


def test_convert_carries_records_layout():
    """The JAX package's tables through ``convert`` give the same records
    as the port's own layout (the two layouts are bit-equal)."""
    (ps, cam), (jps, jcam) = _scenes("irreg", 16)
    ps2 = convert.pallas_scene(jps, CPU)
    a = tmk.render_pallas_record(ps, cam, 16, 16, max_depth=2, tile=TILE)
    b = tmk.render_pallas_record(ps2, convert.camera(jcam, CPU), 16, 16,
                                 max_depth=2, tile=TILE)
    assert torch.equal(a[1], b[1])
