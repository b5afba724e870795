"""K2, the port's backward replay (its plain version on the CPU), against
the JAX package's replay kernel, which runs as its own tests run it:
``replay_bwd_pallas(..., interpret=True)``.

Both sides are fed the same records: JAX's ``(rec, pay)`` from its record
render, carried across in the port's layout.  The replays then differ only
by arithmetic: XLA's CPU code fuses multiply-adds and computes ``rsqrt``,
the port does IEEE float32 without contraction and ``1/sqrt``.  One ulp of
a hit point grows through the mirror chain (f32 mirror cascades are
chaotic, tests/test_pallas_diff.py:11-15), so at depth 2-3 the cotangents
are compared relative to their largest magnitude: at most 3e-2 (measured:
at most 1.2e-2 at 24², depth 2-3, both scenes), and at most 5% of the
elements may differ by more than 1e-3 relative (measured: at most 2.3%).
Where they differ most, the port is the closer of the two to a float64
evaluation of the same chain.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from raytracers_tpu import camera as jcamera
from raytracers_tpu import scenes as jscenes
from raytracers_tpu.grad.pallas_replay_bwd import replay_bwd_pallas
from raytracers_tpu.render import pallas_kernel as jpk
from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.grad import replay_bwd as trb
from raytracers_tpu_torch.render import megakernel as tmk
from raytracers_tpu_torch.render import ray_math
from raytracers_tpu_torch.utils.trace import counting

torch.set_num_threads(2)
CPU = "cpu"
W = H = 24
TILE = 256
REL_MAX = 3e-2
ELEM_REL, ELEM_SHARE = 1e-3, 0.05


def _jax_setup(name):
    sc = jscenes.by_name(name)
    jps = jpk.build_pallas_scene(sc.spheres)
    jcam = jcamera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, W / H)
    params = jnp.concatenate([
        jcam.llc, jcam.horizontal, jcam.vertical, jcam.origin,
        jnp.zeros((4,), jnp.float32),
        jnp.asarray([W, H, 1.0 / W, 1.0 / H], jnp.float32),
        jnp.zeros((4,), jnp.float32)]).astype(jnp.float32)
    return jps, jcam, params


def _rows(x, T=TILE):
    """JAX (tiles, rows, T) -> the port's (rows, n_rays)."""
    x = np.asarray(x)
    return torch.from_numpy(
        x.transpose(1, 0, 2).reshape(x.shape[1], -1).copy())


def _tiles(x, T=TILE):
    """The port's (rows, n_rays) -> JAX (tiles, rows, T)."""
    x = np.asarray(x)
    return jnp.asarray(x.reshape(x.shape[0], -1, T).transpose(1, 0, 2))


def _records(rec_raw, pay):
    D = rec_raw.shape[1]
    rec = torch.from_numpy(np.asarray(rec_raw).transpose(1, 0, 2)
                           .reshape(D, -1).copy())
    pay = torch.from_numpy(np.asarray(pay).transpose(1, 2, 0, 3)
                           .reshape(D, 8, -1).copy())
    return rec, pay


def _jax_table(tab, C):
    """JAX's (1, C*24, 128) bf16-plane table -> (C*128, 7)."""
    t = np.asarray(tab).reshape(C, 3, 8, 128).sum(axis=1)
    return t.transpose(0, 2, 1).reshape(C * 128, 8)[:, :7]


def _close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(port - ref)
    assert err.max() <= REL_MAX * scale, (err.max(), scale)
    assert (err > ELEM_REL * np.abs(ref) + 1e-6 * scale).mean() <= ELEM_SHARE


@pytest.mark.parametrize("name,depth", [("rgbbox", 3), ("irreg", 2)])
def test_whole_path_vs_jax_on_jax_records(name, depth):
    """Per-bounce sphere cotangents, the slot table and the primary rays'
    cotangents, whole-path mode."""
    jps, jcam, params = _jax_setup(name)
    C = jps.n_clusters
    _, _, jraw, jpay = jpk.render_pallas_record(
        jps, jcam, W, H, max_depth=depth, tile=TILE, interpret=True,
        with_pay=True)
    rec, pay = _records(jraw, jpay)
    n = rec.shape[1]
    g = np.random.default_rng(7).standard_normal((3, n)).astype(np.float32)
    gcot = torch.zeros(trb.N_GCOT, n)
    gcot[0:3] = torch.from_numpy(g)
    jg = np.zeros((16, n), np.float32)
    jg[0:3] = g
    jcot, jray = replay_bwd_pallas(params, jraw, jpay, _tiles(jg),
                                   tile=TILE, max_depth=depth,
                                   interpret=True)
    jtab, _ = replay_bwd_pallas(params, jraw, jpay, _tiles(jg), tile=TILE,
                                max_depth=depth, interpret=True,
                                reduce_clusters=C)
    p = torch.from_numpy(np.asarray(params))
    cot, ray, fwd = trb.replay_bwd(p, rec, pay, gcot, tile=TILE)
    tab, ray2, _ = trb.replay_bwd(p, rec, pay, gcot, tile=TILE,
                                  reduce_slots=C * 128)
    assert fwd is None and cot.shape == (depth, 8, n)
    _close(cot.numpy(), np.asarray(jcot).transpose(1, 2, 0, 3)
           .reshape(depth, 8, -1))
    _close(ray.numpy(), _rows(jray)[:6].numpy())
    _close(tab.numpy(), _jax_table(jtab, C))
    assert torch.equal(ray, ray2)
    # the table is the per-bounce cotangents summed onto their slots
    assert torch.equal(tab, trb.slot_table(rec, cot, C * 128).float())
    # zero where a step is no bounce, and in the unused row 7
    assert (cot.permute(1, 0, 2)[:, rec < 0] == 0).all()
    assert (cot[:, 7] == 0).all()


def test_continuation_vs_jax_on_jax_records():
    """A continuation segment: state rows in, the 9-row carry in and out
    (random incoming carry), on the deep segment of JAX's own two-segment
    record; rays dead at the segment's start emit zeros."""
    jps, jcam, params = _jax_setup("rgbbox")
    _, aux = jpk.render_pallas_record_twophase(
        jps, jcam, W, H, max_depth=3, schedule=(1,), tile=TILE,
        interpret=True)
    jraw, jpay, jst = aux["recs"][1], aux["pays"][1], aux["states16"][0]
    rec, pay = _records(jraw, jpay)
    n = rec.shape[1]
    rng = np.random.default_rng(3)
    jg = np.zeros((16, n), np.float32)
    jg[0:12] = rng.standard_normal((12, n)).astype(np.float32)
    jcot, jcarry = replay_bwd_pallas(params, jraw, jpay, _tiles(jg),
                                     tile=TILE, max_depth=2, interpret=True,
                                     state_rows=jst)
    state = _rows(jst)[:9].contiguous()
    cot, carry, _ = trb.replay_bwd(torch.from_numpy(np.asarray(params)),
                                   rec, pay, torch.from_numpy(jg[:12]),
                                   tile=TILE, state_rows=state)
    assert carry.shape == (9, n)
    _close(cot.numpy(), np.asarray(jcot).transpose(1, 2, 0, 3)
           .reshape(2, 8, -1))
    dead = rec[0] == -2
    assert dead.any() and (~dead).any()
    assert (carry[:, dead] == 0).all()
    _close(carry[:, ~dead].numpy(), _rows(jcarry)[:9, ~dead].numpy())


def test_closer_to_float64_than_jax(monkeypatch):
    """The same records replayed in float64 (the key floor, a selector,
    still taken in float32): the port's float32 cotangents are nearer to
    it than JAX's (measured at rgbbox 24², depth 2: 2.1e-3 against 6.2e-3
    of the largest cotangent), so the cross-package gap comes from the
    conditioning of grazing hits, which divide by sqrt(disc), and not
    from a fault of the port's chain.  The port stays within the 3e-3 of
    the largest cotangent that tests/test_pallas_diff.py:246 allows
    between two engines; JAX's own kernel does not, which is why the
    engine tests hold the two packages' centre and radius gradients to
    1e-2 and not 3e-3 (ROADMAP queue 3)."""
    jps, jcam, params = _jax_setup("rgbbox")
    _, _, jraw, jpay = jpk.render_pallas_record(
        jps, jcam, W, H, max_depth=2, tile=TILE, interpret=True,
        with_pay=True)
    rec, pay = _records(jraw, jpay)
    n = rec.shape[1]
    g = np.sin(np.arange(3 * n, dtype=np.float32)).reshape(3, n)
    jg = np.zeros((16, n), np.float32)
    jg[0:3] = g
    jcot, _ = replay_bwd_pallas(params, jraw, jpay, _tiles(jg), tile=TILE,
                                max_depth=2, interpret=True)
    jcot = np.asarray(jcot).transpose(1, 2, 0, 3).reshape(2, 8, -1)
    p = torch.from_numpy(np.asarray(params))
    gcot = torch.zeros(trb.N_GCOT, n)
    gcot[0:3] = torch.from_numpy(g)
    cot, _, _ = trb.replay_bwd(p, rec, pay, gcot, tile=TILE)
    key_floor = trb.key_floor
    monkeypatch.setattr(trb, "key_floor",
                        lambda m: key_floor(m.float()).double())
    monkeypatch.setattr(trb, "sqrt", torch.sqrt)
    monkeypatch.setattr(ray_math, "sqrt", torch.sqrt)
    c64, _, _ = trb.replay_bwd_reference(p, rec, pay.double(),
                                         gcot.double(), tile=TILE)
    assert c64.dtype == torch.float64
    err_port = (cot.double() - c64).abs().max()
    err_jax = (torch.from_numpy(jcot).double() - c64).abs().max()
    assert err_port < err_jax
    assert err_port < 3e-3 * c64.abs().max()


@pytest.mark.parametrize("name,block", [("rgbbox", None),
                                        ("irreg", (16, 16))])
def test_emit_fwd_replays_the_forward_bit_for_bit(name, block):
    """The replay's pass 1 reproduces K1d's colours bit for bit at depth 50
    (the port's version of tests/test_pallas_diff.py:155): it recomputes
    each bounce with K1's arithmetic from the records."""
    sc = tscenes.by_name(name, device=CPU)
    ps = tmk.build_pallas_scene(sc.spheres)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device=CPU)
    col, _, rec, pay = tmk.render_pallas_record(ps, cam, W, H, max_depth=50,
                                                tile=TILE, with_pay=True,
                                                block=block)
    ro = tmk._ray_order(cam, W, H, TILE, block, 0.0, None, 50)
    gcot = torch.zeros(trb.N_GCOT, ro.n_rays)
    _, _, fwd = trb.replay_bwd(ro.params, rec, pay, gcot, tile=TILE,
                               block_tiled=block is not None, emit_fwd=True)
    rep = tmk._to_image(ro, fwd, W, H).permute(1, 2, 0).contiguous()
    assert torch.equal(rep.view(torch.int32), col.view(torch.int32))
    assert (rec >= 0).sum(0).max() >= 3          # a deep mirror chain


def test_replay_wrapper_checks_inputs():
    rec = torch.full((2, 256), -2, dtype=torch.int32)
    pay = torch.zeros(2, 8, 256)
    gcot = torch.zeros(trb.N_GCOT, 256)
    params = torch.zeros(24)
    with pytest.raises(ValueError, match="pay"):
        trb.replay_bwd(params, rec, pay[:, :7], gcot, tile=256)
    with pytest.raises(ValueError, match="gcot"):
        trb.replay_bwd(params, rec, pay, gcot[:9], tile=256)
    with pytest.raises(ValueError, match="rec"):
        trb.replay_bwd(params, rec.float(), pay, gcot, tile=256)
    with pytest.raises(ValueError, match="state_rows"):
        trb.replay_bwd(params, rec, pay, gcot, tile=256,
                       state_rows=torch.zeros(16, 256))
    with counting() as c:
        _, carry, _ = trb.replay_bwd(params, rec, pay, gcot, tile=256,
                                     state_rows=torch.ones(9, 256))
    # all rays dead at the start: zero carry; the CPU takes the plain
    # version, so no kernel launch is counted
    assert (carry == 0).all()
    assert "k2.launches" not in c.read()
