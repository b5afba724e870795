"""The port's ray mesh and sharded train step against the one-rank port and
the JAX package (mirrors tests/test_sharding.py).

The JAX tests run 8 virtual devices in one process; here a ``RayMesh`` of
8 ranks without a process group runs its 8 rank bodies in this process,
and its collectives concatenate and sum locally (the 2-process gloo runs
are tests/test_torch_distributed.py).  Renders are pure repartitioning:
the 8-slab image equals the one-rank image bit for bit, and at depth 1
JAX's 8-device image too.  The 8-band train step agrees with the unsharded
engine within tests/test_sharding.py:214-220's tolerances (the band camera
rounds each ray direction once) and with JAX's sharded step within the
engine tolerances of tests/test_torch_pallas_diff.py:74.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracers_tpu import camera as jcamera
from raytracers_tpu import scenes as jscenes
from raytracers_tpu.geometry import Spheres as JSpheres
from raytracers_tpu.grad.inverse import make_train_step_pallas as jstep
from raytracers_tpu.parallel.mesh import ray_mesh as jray_mesh
from raytracers_tpu.parallel.mesh import render_sharded as jrender_sharded
from raytracers_tpu.render.api import prepare_scene as jprepare
from raytracers_tpu_torch import convert, scenes
from raytracers_tpu_torch.geometry import Spheres, camera
from raytracers_tpu_torch.grad.diff_render import render_diff
from raytracers_tpu_torch.grad.inverse import (adam, init_state,
                                               make_train_step,
                                               make_train_step_pallas,
                                               recover)
from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
from raytracers_tpu_torch.parallel.mesh import (RayMesh, ray_mesh,
                                                render_pallas_sharded,
                                                render_pallas_slab,
                                                render_sharded)
from raytracers_tpu_torch.render.api import prepare_scene, render
from raytracers_tpu_torch.render.bruteforce import make_closest_hit
from raytracers_tpu_torch.render.megakernel import (build_pallas_scene,
                                                    render_pallas)
from raytracers_tpu_torch.render.tracer import primary_rays

torch.set_num_threads(2)
CPU = torch.device("cpu")
MESH8 = RayMesh(0, 8, None, CPU)
# centre, radius, colour (tests/test_torch_pallas_diff.py:74)
TOLS = (1e-2, 1e-2, 3e-3)


def _mini():
    return Spheres(torch.tensor([[0.0, 0.0, -5.0], [2.5, 0.0, -4.0]]),
                   torch.tensor([1.5, 1.0]),
                   torch.tensor([[0.8, 0.3, 0.2], [0.2, 0.6, 0.9]]))


MINI_CAM = ((0., 0., 2.), (0., 0., -5.), (0., 1., 0.), 60.0, 1.0)


def _mini_cam():
    """JAX's camera of the toy scene: at fov 60 XLA's float32 tan is one
    ulp above the correctly rounded tan the port computes (ROADMAP queue
    3), and the soft recovery's trajectory amplifies that ulp."""
    return convert.camera(jcamera(*MINI_CAM), CPU)


def _rgbbox_cam(sc, aspect=1.0):
    return camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, aspect,
                  device=CPU)


def _target(spheres, cam, side, depth):
    return render_diff(lambda s: make_closest_hit(s, "precise"), spheres,
                       cam, side, side, max_depth=depth)


def test_ray_mesh_without_a_group_is_one_rank():
    assert ray_mesh(device="cpu") == RayMesh(0, 1, None, CPU)


def test_trainer_entry_points_raise_without_cuda(monkeypatch):
    """No fallback that hides the device: the mesh, ``init`` and the
    examples default to the card and raise without one."""
    from raytracers_tpu_torch.examples import inverse_rendering
    from raytracers_tpu_torch.parallel.distributed import init
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (ray_mesh, init, lambda: inverse_rendering.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_sharded_render_matches_single_device():
    prep = prepare_scene(scenes.rgbbox(device=CPU), 64, 64, device=CPU)
    single = render(prep, 64, 64, mode="bvh", max_depth=4)
    assert torch.equal(single, render_sharded(prep, 64, 64, mesh=MESH8,
                                              mode="bvh", max_depth=4))


@pytest.mark.parametrize("h, w", [(30, 31), (2, 3)])
def test_sharded_render_nondivisible_rays(h, w):
    """930 rays on 8 ranks, and 6 rays on 8 ranks: the padding cycles the
    rays (tests/test_sharding.py:31,229)."""
    prep = prepare_scene(scenes.rgbbox(device=CPU), h, w, leaf_size=4,
                         device=CPU)
    img = render_sharded(prep, h, w, mesh=MESH8, mode="bvh", max_depth=2)
    assert img.shape == (h, w)
    assert torch.equal(img, render(prep, h, w, mode="bvh", max_depth=2))


def test_inverse_rendering_recovers_perturbation():
    """Sharded gradient descent pulls perturbed colour and radius back to
    the truth (tests/test_sharding.py:45), centres masked."""
    true, cam = _mini(), _mini_cam()
    target = _target(true, cam, 24, 3)
    pert = true._replace(radius=true.radius * torch.tensor([1.12, 0.9]),
                         color=(true.color + 0.15).clamp(0, 1))
    trainable = Spheres(torch.zeros(2, 3), torch.ones(2), torch.ones(2, 3))
    fitted, _ = recover(target, cam, pert, MESH8, steps=80, lr=1e-2,
                        max_depth=3, trainable=trainable)

    def img_loss(s):
        return float(((_target(s, cam, 24, 3) - target) ** 2).mean())
    assert img_loss(fitted) < 0.25 * img_loss(pert)
    assert ((fitted.color - true.color).abs().mean()
            < (pert.color - true.color).abs().mean())
    assert torch.equal(fitted.center, true.center)


def test_train_step_loss_decreases():
    true, cam = _mini(), _mini_cam()
    target = _target(true, cam, 16, 3).reshape(-1, 3)
    step = make_train_step(MESH8, max_depth=3)
    o, d = primary_rays(cam, 16, 16)
    state = init_state(true._replace(radius=true.radius * 1.2), adam(1e-2))
    losses = [float(step(state, o, d, target)[1]) for _ in range(12)]
    assert losses[-1] < losses[0]


def test_sharded_pallas_matches_single_device_bitexact():
    sc = scenes.rgbbox(device=CPU)
    ps, cam = build_pallas_scene(sc.spheres), _rgbbox_cam(sc)
    single = render_pallas(ps, cam, 64, 64, max_depth=3, tile=512,
                           block=(32, 16))
    assert torch.equal(single, render_pallas_sharded(ps, cam, 64, 64,
                                                     mesh=MESH8, max_depth=3))
    # the slabs are rows of the image, and the mesh defaults to one rank
    slab = render_pallas_slab(ps, cam, 64, 64, 1, 2, max_depth=3)
    assert torch.equal(slab, single[32:])
    assert torch.equal(single, render_pallas_sharded(ps, cam, 64, 64,
                                                     max_depth=3))


def test_cli_shard_pallas_contract():
    """render_sharded(mode="pallas"), the CLI's --shard path, equals the
    unsharded render (tests/test_sharding.py:127)."""
    prep = prepare_scene(scenes.rgbbox(device=CPU), 48, 48, with_pallas=True,
                         device=CPU)
    assert torch.equal(render_sharded(prep, 48, 48, mesh=MESH8,
                                      mode="pallas", max_depth=2),
                       render(prep, 48, 48, mode="pallas", max_depth=2))


def test_sharded_pallas_deep_twophase_bitexact():
    sc = scenes.rgbbox(device=CPU)
    prep = prepare_scene(sc, 64, 64, with_pallas=True, device=CPU)
    ps = build_pallas_scene(sc.spheres)
    assert torch.equal(render(prep, 64, 64, mode="pallas", max_depth=50),
                       render_pallas_sharded(ps, _rgbbox_cam(sc), 64, 64,
                                             mesh=MESH8, max_depth=50))


def test_sharded_scene_scale_class_bitexact():
    """C > 128 (the two-level cull, (8, 256) blocks) rendered as 8
    slabs at 256x64 (tests/test_sharding.py:239)."""
    sph = scenes.random_spheres(20_000, seed=7, extent=200.0, device=CPU)
    ps = build_pallas_scene(sph)
    assert ps.n_clusters > 128
    cam = camera((0., 0., 260.), (0., 0., 0.), (0., 1., 0.), 60.0, 256 / 64,
                 device=CPU)
    single = render_pallas(ps, cam, 256, 64, max_depth=2, tile=2048,
                           block=(8, 256))
    assert torch.equal(single, render_pallas_sharded(ps, cam, 64, 256,
                                                     mesh=MESH8, max_depth=2))


def test_eight_slabs_equal_jax_render_sharded_depth1():
    """At depth 1 the port's 8 slabs equal JAX's ``render_sharded`` on
    its 8-device mesh (``interpret=True``) bit for bit."""
    assert len(jax.devices()) == 8
    jimg = np.asarray(jrender_sharded(
        jprepare(jscenes.rgbbox(), 32, 16, with_pallas=True, with_bvh=False),
        32, 16, mesh=jray_mesh(), mode="pallas", max_depth=1,
        interpret=True))
    prep = prepare_scene(scenes.rgbbox(device=CPU), 32, 16, with_pallas=True,
                         with_bvh=False, device=CPU)
    np.testing.assert_array_equal(
        render_sharded(prep, 32, 16, mesh=MESH8, mode="pallas",
                       max_depth=1).numpy(), jimg)


def test_trace_sharded_vs_jax():
    """``trace_sharded`` over 8 ranks against JAX's on its 8-device mesh,
    the all-pairs oracle, 100 rays (padded to 104), depth 1: the same
    colours within 1e-6 (XLA may fuse the tracer's multiply-adds)."""
    from raytracers_tpu.parallel.mesh import trace_sharded as jtrace
    from raytracers_tpu.render.tracer import primary_rays as jprimary
    from raytracers_tpu_torch.parallel.mesh import trace_sharded
    jsc = jscenes.rgbbox()
    jcam = jcamera(jsc.look_from, jsc.look_at, (0., 1., 0.), jsc.fov, 1.0)
    jo, jd = jprimary(jcam, 10, 10)
    jcol = np.asarray(jtrace(jprepare(jsc, 10, 10, with_bvh=False), jo, jd,
                             jray_mesh(), mode="brute", max_depth=1))
    prep = prepare_scene(scenes.rgbbox(device=CPU), 10, 10, with_bvh=False,
                         device=CPU)
    col = trace_sharded(prep, torch.from_numpy(np.array(jo)),
                        torch.from_numpy(np.array(jd)), MESH8, mode="brute",
                        max_depth=1)
    assert col.shape == (100, 3)
    np.testing.assert_allclose(col.numpy(), jcol, rtol=0, atol=1e-6)


def _pallas_step_inputs(depth):
    true = _mini()
    pert = true._replace(radius=true.radius * torch.tensor([1.15, 0.9]),
                         color=(true.color + 0.1).clamp(0.0, 1.0))
    cam = _mini_cam()
    target = make_render_pallas_diff(32, 32, max_depth=depth)(true, cam)
    return true, pert, cam, target


def test_sharded_pallas_inverse_matches_unsharded_grads():
    """8 bands' summed loss and gradients against the unsharded engine
    (tests/test_sharding.py:186), then the full step lowers the loss."""
    _, pert, cam, target = _pallas_step_inputs(3)
    f = make_render_pallas_diff(32, 32, max_depth=3)
    sph = Spheres(*(t.clone().requires_grad_(True) for t in pert))
    lu = ((f(sph, cam) - target) ** 2).sum()
    lu.backward()
    step = make_train_step_pallas(MESH8, 32, 32, max_depth=3)
    ls, gs = step.loss_and_grads(pert, cam, target)
    np.testing.assert_allclose(float(ls), float(lu.detach()), rtol=1e-5,
                               atol=1e-6)
    for a, b, name in zip(gs, sph, ("center", "radius", "color")):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    state = init_state(pert, adam(1e-2))
    state, l0 = step(state, cam, target)
    for _ in range(3):
        state, l1 = step(state, cam, target)
    assert float(l1) < float(l0)


def test_sharded_pallas_step_vs_jax():
    """The 8-band ``loss_and_grads`` against JAX's
    ``make_train_step_pallas(interpret=True)`` on its 8-device mesh at
    depth 2: the loss within 1e-5, the gradients within the engine
    tolerances."""
    true, pert, cam, target = _pallas_step_inputs(2)
    jpert = JSpheres(*(jnp.asarray(t.numpy()) for t in pert))
    jcam = jcamera(*MINI_CAM)
    jls, jgs = jstep(optax.adam(1e-2), jray_mesh(), 32, 32, max_depth=2,
                     interpret=True).loss_and_grads(jpert, jcam,
                                                    target.numpy())
    ls, gs = make_train_step_pallas(MESH8, 32, 32,
                                    max_depth=2).loss_and_grads(pert, cam,
                                                                target)
    np.testing.assert_allclose(float(ls), float(jls), rtol=1e-5)
    for a, b, tol in zip(gs, jax.tree.leaves(jgs), TOLS):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        assert np.abs(a.numpy() - b).max() / np.abs(b).max() < tol


def test_one_band_step_is_the_unsharded_engine():
    """One band: the camera is unchanged, so the step's loss and
    gradients are the unsharded engine's bit for bit."""
    _, pert, cam, target = _pallas_step_inputs(2)
    f = make_render_pallas_diff(32, 32, max_depth=2)
    sph = Spheres(*(t.clone().requires_grad_(True) for t in pert))
    lu = ((f(sph, cam) - target) ** 2).sum()
    lu.backward()
    ls, gs = make_train_step_pallas(RayMesh(0, 1, None, CPU), 32, 32,
                                    max_depth=2).loss_and_grads(pert, cam,
                                                                target)
    assert torch.equal(ls, lu.detach())
    for a, b in zip(gs, sph):
        assert torch.equal(a, b.grad)


def test_center_recovery_soft_gradients():
    """BASELINE configs[4] in full: recover perturbed sphere centres with
    the soft-visibility renderer (tests/test_sharding.py:140), on the same
    inputs as JAX's ``recover_soft``, whose first ten losses the port's
    follow within 1e-4."""
    from raytracers_tpu.grad.soft_render import recover_soft as jrecover
    from raytracers_tpu_torch.grad.soft_render import recover_soft
    true, cam = _mini(), _mini_cam()
    target = _target(true, cam, 32, 1)
    shift = torch.tensor([[0.6, -0.4, 0.3], [-0.5, 0.45, 0.0]])
    pert = true._replace(center=true.center + shift)
    d0 = float((pert.center - true.center).abs().mean())
    losses, jlosses = [], []
    fitted = recover_soft(target, cam, pert, steps=300, lr=3e-2,
                          callback=lambda i, l, s: losses.append(l))
    jrecover(target.numpy(), jcamera(*MINI_CAM),
             JSpheres(*(jnp.asarray(t.numpy()) for t in pert)), steps=300,
             lr=3e-2, callback=lambda i, l, s: jlosses.append(l))
    np.testing.assert_allclose(losses[:10], jlosses[:10], rtol=1e-4)
    d1 = float((fitted.center - true.center).abs().mean())
    assert d1 < 0.35 * d0, (d0, d1)
    assert losses[-1] < 0.3 * losses[0]
