"""The port's gradient oracle (``grad/diff_render.py``, plain torch under
autograd) against the JAX package's, on the CPU.

Both sides replay the same recorded paths, the JAX package's
``trace_paths`` over its brute-force oracle.  The replay's arithmetic is the
same formula family on both sides, but XLA's CPU code fuses multiply-adds
and torch does not, and the mirror chain amplifies those ulps (f32 mirror
cascades are chaotic, tests/test_pallas_diff.py:11-15): at depth 3 the
colours agree to 1e-3 absolute, and the gradients to 2e-3 of their
largest magnitude (measured: 1.0e-4 and under 2e-3 at 16², rgbbox).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracers_tpu import camera as jcamera
from raytracers_tpu import scenes as jscenes
from raytracers_tpu.grad import diff_render as jdr
from raytracers_tpu.render import bruteforce as jbf
from raytracers_tpu.render.tracer import primary_rays as jprimary
from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.geometry import Spheres
from raytracers_tpu_torch.grad import diff_render as tdr
from raytracers_tpu_torch.render import bruteforce as tbf
from raytracers_tpu_torch.render.tracer import primary_rays

torch.set_num_threads(2)
CPU = "cpu"
S = 16
DEPTH = 3


def _setup():
    jsc = jscenes.rgbbox()
    jcam = jcamera(jsc.look_from, jsc.look_at, (0., 1., 0.), jsc.fov, 1.0)
    sc = tscenes.rgbbox(device=CPU)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device=CPU)
    return (jsc.spheres, jcam), (sc.spheres, cam)


def _leaves(spheres):
    return Spheres(*(t.clone().requires_grad_(True) for t in spheres))


def test_replay_paths_and_gradients_vs_jax():
    (jsph, jcam), (sph, cam) = _setup()
    jo, jd = jprimary(jcam, S, S)
    idxs, events = jdr.trace_paths(jbf.make_closest_hit(jsph), jsph, jo, jd,
                                   DEPTH)
    g = np.random.default_rng(1).standard_normal((S * S, 3)).astype(
        np.float32)
    jcol, vjp = jax.vjp(
        lambda s, o, d: jdr.replay_paths(s, o, d, idxs, events), jsph, jo, jd)
    jgs, jgo, jgd = vjp(jnp.asarray(g))

    leaves = _leaves(sph)
    o = torch.from_numpy(np.asarray(jo)).requires_grad_(True)
    d = torch.from_numpy(np.asarray(jd)).requires_grad_(True)
    col = tdr.replay_paths(leaves, o, d,
                           torch.from_numpy(np.asarray(idxs)),
                           torch.from_numpy(np.asarray(events)))
    col.backward(torch.from_numpy(g))
    assert np.abs(col.detach().numpy() - np.asarray(jcol)).max() < 1e-3
    for port, ref in [(leaves.center.grad, jgs.center),
                      (leaves.radius.grad, jgs.radius),
                      (leaves.color.grad, jgs.color), (o.grad, jgo),
                      (d.grad, jgd)]:
        ref = np.asarray(ref)
        err = np.abs(port.numpy() - ref).max()
        assert err <= 2e-3 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_trace_paths_vs_jax():
    """The discrete records: equal at depth 1 and on at least 99% of the
    entries at depth 3 (all of them when measured at this size)."""
    (jsph, jcam), (sph, cam) = _setup()
    jo, jd = jprimary(jcam, S, S)
    o, d = primary_rays(cam, S, S)
    assert np.array_equal(o.numpy(), np.asarray(jo))
    jidx, jev = jdr.trace_paths(jbf.make_closest_hit(jsph), jsph, jo, jd,
                                DEPTH)
    idx, ev = tdr.trace_paths(tbf.make_closest_hit(sph), sph, o, d, DEPTH)
    assert idx.dtype == torch.int32 and ev.dtype == torch.uint8
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx)[0])
    np.testing.assert_array_equal(ev[0].numpy(), np.asarray(jev)[0])
    assert (idx.numpy() == np.asarray(jidx)).mean() >= 0.99
    assert (ev.numpy() == np.asarray(jev)).mean() >= 0.99
    assert set(np.unique(ev.numpy())) >= {tdr.EV_BOUNCE, tdr.EV_MISS,
                                          tdr.EV_INACTIVE}


def test_render_diff_vs_jax():
    (jsph, jcam), (sph, cam) = _setup()
    ref = jdr.render_diff(lambda s: jbf.make_closest_hit(s), jsph, jcam, S,
                          S, max_depth=DEPTH)
    img = tdr.render_diff(lambda s: tbf.make_closest_hit(s), sph, cam, S, S,
                          max_depth=DEPTH, chunk=100)
    assert img.shape == (S, S, 3)
    assert np.abs(img.numpy() - np.asarray(ref)).max() < 1e-3


def test_gather_modes_and_remat_agree():
    """``gather="onehot"`` computes the gather "take" does, ``remat``
    recomputes the same steps, and ``skip_dead`` skips only step groups in
    which every ray is inactive, each the identity: values and gradients
    bit-identical to the dense replay (here at depth 12, where the last
    group of 8 steps has no live ray)."""
    (_, _), (sph, cam) = _setup()
    o, d = primary_rays(cam, S, S)
    idxs, events = tdr.trace_paths(tbf.make_closest_hit(sph), sph, o, d,
                                   DEPTH)
    grads = []
    for gather, remat in [("take", False), ("onehot", False),
                          ("onehot", True)]:
        leaves = _leaves(sph)
        col = tdr.replay_paths(leaves, o, d, idxs, events, gather=gather,
                               remat=remat)
        (col * col).sum().backward()
        grads.append([col.detach()] + [t.grad for t in leaves])
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="gather"):
        tdr.replay_paths(sph, o, d, idxs, events, gather="dot")
    pad = torch.full((12 - DEPTH,) + tuple(events.shape[1:]),
                     tdr.EV_INACTIVE, dtype=events.dtype)
    idxs = torch.cat([idxs, torch.zeros_like(pad, dtype=idxs.dtype)])
    events = torch.cat([events, pad])
    skip = []
    for skip_dead in (False, True):
        leaves = _leaves(sph)
        col = tdr.replay_paths(leaves, o, d, idxs, events, skip_dead=skip_dead)
        (col * col).sum().backward()
        skip.append([col.detach()] + [t.grad for t in leaves])
    for a, b in zip(*skip):
        assert torch.equal(a, b)


def test_gradients_finite_where_rays_miss():
    """Misses and bounces side by side: the isfinite guards keep the
    unselected branches' infinities out of the gradients."""
    sph = Spheres(torch.tensor([[0.0, 0.0, -5.0], [2.5, 0.0, -4.0]]),
                  torch.tensor([1.5, 1.0]),
                  torch.tensor([[0.8, 0.3, 0.2], [0.2, 0.6, 0.9]]))
    cam = tgeo.camera((0., 0., 2.), (0., 0., -5.), (0., 1., 0.), 60.0, 1.0,
                      device=CPU)
    leaves = _leaves(sph)
    img = tdr.render_diff(lambda s: tbf.make_closest_hit(s), leaves, cam, S,
                          S, max_depth=5)
    img.sum().backward()
    for t in leaves:
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
