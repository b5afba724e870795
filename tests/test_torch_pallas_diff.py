"""The port's fwd+bwd engine (``grad/pallas_diff.py``; K1d and K2 by their
plain versions on the CPU) against the JAX engine, which runs its Pallas
kernels with ``interpret=True`` as tests/test_pallas_diff.py does.

Across the two packages gradients are compared at depth 2, relative to
their largest magnitude: deeper, f32 mirror cascades amplify the two
packages' ulp-level differences (XLA fuses multiply-adds) past any
element-wise comparison.  The colour and camera gradients stay below the
3e-3 of tests/test_pallas_diff.py:246 (measured: 2e-5 and 2.6e-3 at 24²).
The centre and radius gradients are held below 1e-2 (measured: 5.5e-3 and
4.6e-3): they sum the cotangents of grazing hits, which divide by
sqrt(disc), and there the port's K2 is closer than JAX's to a float64
evaluation of the same chain (tests/test_torch_replay_bwd.py), so the gap
is JAX's rounding as much as the port's.  Within the port,
the segmented schedules are pure repartitioning: the forward is
bit-identical and the gradients agree to within 1e-5 of their largest
magnitude, the slack of summing the slot tables segment by segment
(tests/test_pallas_diff.py:187-303).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracers_tpu import camera as jcamera
from raytracers_tpu import scenes as jscenes
from raytracers_tpu.grad.pallas_diff import make_render_pallas_diff as jmake
from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.geometry import Camera, Spheres
from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
from raytracers_tpu_torch.render import megakernel as tmk

torch.set_num_threads(2)
CPU = "cpu"
W = H = 24


def _weights(shape):
    return np.sin(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)


def _port_grads(f, spheres, cam, loss="sin"):
    sph = Spheres(*(t.clone().requires_grad_(True) for t in spheres))
    c = Camera(*(t.clone().requires_grad_(True) for t in cam))
    img = f(sph, c)
    if loss == "sin":
        val = (img * torch.from_numpy(_weights(img.shape))).sum()
    else:
        val = (img * img).sum()
    val.backward()
    return img.detach(), [t.grad for t in (*sph, *c)]


def _jax_grads(f, spheres, cam):
    def L(s, c):
        img = f(s, c)
        return jnp.sum(img * jnp.asarray(_weights(img.shape)))
    gs, gc = jax.grad(L, argnums=(0, 1))(spheres, cam)
    return [np.asarray(x) for x in (*gs, *gc)]


def _rgbbox():
    jsc = jscenes.rgbbox()
    jcam = jcamera(jsc.look_from, jsc.look_at, (0., 1., 0.), jsc.fov, W / H)
    sc = tscenes.rgbbox(device=CPU)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, W / H,
                      device=CPU)
    return (jsc.spheres, jcam), (sc.spheres, cam)


# centre, radius, colour, then the camera's origin, llc, horizontal, vertical
TOLS = (1e-2, 1e-2, 3e-3, 3e-3, 3e-3, 3e-3, 3e-3)


def _assert_rel(port, ref, tols=TOLS):
    for a, b, tol in zip(port, ref, tols):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        scale = np.abs(b).max() + 1e-8
        assert np.abs(a - b).max() / scale < tol, np.abs(a - b).max() / scale


@pytest.mark.parametrize("backward", ["pallas", "xla"])
def test_engine_gradients_vs_jax_depth2(backward):
    (jsph, jcam), (sph, cam) = _rgbbox()
    f = make_render_pallas_diff(W, H, max_depth=2, backward=backward)
    jf = jmake(W, H, max_depth=2, interpret=True, backward=backward)
    img, grads = _port_grads(f, sph, cam)
    ref = _jax_grads(jf, jsph, jcam)
    assert img.shape == (H, W, 3)
    assert all(np.abs(g.numpy()).max() > 0 for g in grads)
    _assert_rel(grads, ref)


def test_engine_gradients_vs_jax_many_clusters():
    """1,330 random spheres, C = 11 clusters: the slot table beyond one
    8-cluster chunk of the JAX kernel.  The forward equals the JAX
    engine's within float noise; gradients as above."""
    jsph = jscenes.random_spheres(1330, seed=5, extent=12.0)
    sph = tscenes.random_spheres(1330, seed=5, extent=12.0, device=CPU)
    args = ((0.0, 2.0, 30.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 75.0, 1.0)
    jcam = jcamera(*args)
    cam = tgeo.camera(*args, device=CPU)
    assert tmk.build_pallas_scene(sph).n_clusters > 8
    f = make_render_pallas_diff(W, H, max_depth=2)
    jf = jmake(W, H, max_depth=2, interpret=True)
    img, grads = _port_grads(f, sph, cam)
    assert np.abs(img.numpy() - np.asarray(jf(jsph, jcam))).max() < 1e-4
    _assert_rel(grads[:3], _jax_grads(jf, jsph, jcam)[:3])


def test_engine_forward_and_backward_agree():
    """The xla and pallas engines share the forward, bit for bit, and their
    gradients agree at depth 2 to the tolerances above (measured: centre
    4.4e-3, radius 3.6e-3, camera 1.6e-3)."""
    _, (sph, cam) = _rgbbox()
    img_p, gp = _port_grads(make_render_pallas_diff(W, H, max_depth=2),
                            sph, cam)
    img_x, gx = _port_grads(
        make_render_pallas_diff(W, H, max_depth=2, backward="xla"), sph, cam)
    assert torch.equal(img_p, img_x)
    _assert_rel(gp, gx)


@pytest.mark.parametrize("kw", [
    dict(schedule=(2, 3), block=(16, 16)),
    dict(phase1_depth=3),
    dict(schedule=(2, 3), block=(16, 16), sort_prefix=(None, 0.5)),
    dict(schedule=(2, 3), block=(16, 16), sort_prefix=(0.25, 0.1)),
])
def test_segmented_schedules_equal_single_segment(kw):
    """A too-small prefix (0.25, 0.1) leaves live rays in place: exact all
    the same."""
    _, (sph, cam) = _rgbbox()
    base = dict(max_depth=10, tile=256)
    img1, g1 = _port_grads(make_render_pallas_diff(W, H, **base), sph, cam,
                           loss="sq")
    img2, g2 = _port_grads(make_render_pallas_diff(W, H, **base, **kw), sph,
                           cam, loss="sq")
    assert torch.equal(img1.view(torch.int32), img2.view(torch.int32))
    for a, b in zip(g1, g2):
        assert (a - b).abs().max() <= 1e-5 * (a.abs().max() + 1e-8)


def test_gradient_finite_difference():
    """Central differences on a smooth 2-sphere scene (the configuration
    of tests/test_pallas_diff.py:89): no silhouette grazes a pixel of the
    loss's support at this step, so the difference quotient sees the
    landscape the path-replay gradient differentiates."""
    sph = Spheres(torch.tensor([[0.0, 0.0, -5.0], [2.5, 0.0, -4.0]]),
                  torch.tensor([1.5, 1.0]),
                  torch.tensor([[0.8, 0.3, 0.2], [0.2, 0.6, 0.9]]))
    cam = tgeo.camera((0., 0., 2.), (0., 0., -5.), (0., 1., 0.), 60.0, 1.0,
                      device=CPU)
    f = make_render_pallas_diff(W, H, max_depth=5)
    w = torch.linspace(0.5, 1.5, W * H * 3).reshape(H, W, 3)

    def loss(radius):
        return float((f(sph._replace(radius=radius), cam) * w).sum())

    r = sph.radius.clone().requires_grad_(True)
    (f(sph._replace(radius=r), cam) * w).sum().backward()
    eps = 3e-3
    for i in range(2):
        up, dn = sph.radius.clone(), sph.radius.clone()
        up[i] += eps
        dn[i] -= eps
        fd = (loss(up) - loss(dn)) / (2 * eps)
        an = float(r.grad[i])
        assert abs(fd - an) < 0.03 * (abs(fd) + abs(an)) + 1e-2, (i, fd, an)


def test_forward_matches_jax_engine():
    """Float colours of the deep forward against the JAX engine's: f32
    mirror cascades, so packed pixels are held to the structural tolerance
    of tests/test_pallas.py:73."""
    (jsph, jcam), (sph, cam) = _rgbbox()
    img = make_render_pallas_diff(W, H, max_depth=10)(sph, cam)
    ref = np.asarray(jmake(W, H, max_depth=10, interpret=True)(jsph, jcam))
    a = tmk.pack_pix(*img.unbind(-1)).numpy()
    b = tmk.pack_pix(*torch.from_numpy(ref).unbind(-1)).numpy()
    assert (a != b).mean() < 0.12


def test_not_ported_options_raise():
    for kw in (dict(bwd_chunks=4), dict(sort_by_depth=True),
               dict(skip_dead=True), dict(cluster_width=64)):
        with pytest.raises(NotImplementedError):
            make_render_pallas_diff(W, H, **kw)
    with pytest.raises(ValueError, match="backward"):
        make_render_pallas_diff(W, H, backward="nope")

