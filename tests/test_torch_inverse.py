"""The port's inverse rendering (``grad/inverse.py``, ``grad/soft_render.py``,
the train-state checkpoints, ``convert.inverse_state``) and the matmul
oracle against the JAX package.

Band cameras are bit-equal to JAX's (both evaluated op by op).  One Adam
step from the same state and gradient agrees with optax's within 1e-6 of
each leaf's largest magnitude: torch's Adam rounds in another order
(``lerp_``, ``addcdiv_``).  The all-pairs train step's loss and gradients
agree with JAX's ``_loss_shard`` within the engine tolerances of
tests/test_torch_pallas_diff.py.  A checkpoint written by either package
resumes in the other, and the resumed losses agree with the writer's own
uninterrupted run within 1e-5: they part by the optimizers' rounding.
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
from raytracers_tpu.grad import inverse as jinv
from raytracers_tpu.grad import soft_render as jsoft
from raytracers_tpu.render import api as japi
from raytracers_tpu.render import bruteforce as jbf
from raytracers_tpu.render.tracer import primary_rays as jprimary
from raytracers_tpu_torch import convert
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.geometry import Spheres, camera
from raytracers_tpu_torch.grad import inverse as tinv
from raytracers_tpu_torch.grad import soft_render as tsoft
from raytracers_tpu_torch.parallel.mesh import RayMesh
from raytracers_tpu_torch.render import api as tapi
from raytracers_tpu_torch.render import bruteforce as tbf
from raytracers_tpu_torch.render.tracer import primary_rays
from raytracers_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)
CPU = torch.device("cpu")
MINI = ([[0.0, 0.0, -5.0], [2.5, 0.0, -4.0]], [1.5, 1.0],
        [[0.8, 0.3, 0.2], [0.2, 0.6, 0.9]])
MINI_CAM = ((0., 0., 2.), (0., 0., -5.), (0., 1., 0.), 60.0, 1.0)
# centre, radius, colour (tests/test_torch_pallas_diff.py:74)
TOLS = (1e-2, 1e-2, 3e-3)


def _mini():
    j = JSpheres(*(jnp.asarray(x, jnp.float32) for x in MINI))
    t = Spheres(*(torch.tensor(x, dtype=torch.float32) for x in MINI))
    return j, t, jcamera(*MINI_CAM), camera(*MINI_CAM, device=CPU)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


@pytest.mark.parametrize("name", ["rgbbox", "irreg", "mini"])
def test_band_camera_bit_equal_to_jax(name):
    """Given JAX's camera, the port's bands are JAX's bit for bit."""
    if name == "mini":
        jcam = _mini()[2]
    else:
        jsc = jscenes.by_name(name)
        jcam = jcamera(jsc.look_from, jsc.look_at, (0., 1., 0.), jsc.fov,
                       1.0)
    cam = convert.camera(jcam, CPU)
    for row0, rows, height in ((0, 64, 64), (0, 8, 64), (24, 8, 64),
                               (56, 8, 64), (96, 32, 1000)):
        jb = jinv.band_camera(jcam, jnp.float32(row0), rows, height)
        tb = tinv.band_camera(cam, float(row0), rows, height)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    # one band leaves the camera unchanged, bit for bit
    for a, b in zip(tinv.band_camera(cam, 0.0, 64, 64), cam):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _jax_state(seed, n=5, count=3):
    """A JAX InverseState after ``count`` steps: random spheres, moments."""
    rng = np.random.default_rng(seed)
    sph = JSpheres(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
                   jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32),
                   jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32))
    opt = optax.adam(1e-2)
    st = opt.init(sph)
    adam = st[0]._replace(
        count=jnp.asarray(count, jnp.int32),
        mu=jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape) * 0.1, jnp.float32), sph),
        nu=jax.tree.map(lambda x: jnp.asarray(
            rng.uniform(0, 0.02, x.shape), jnp.float32), sph))
    return opt, jinv.InverseState(sph, (adam,) + tuple(st[1:])), rng


def test_jax_leaf_order():
    _, state, _ = _jax_state(0)
    leaves = jax.tree.leaves(state)
    assert len(leaves) == 10
    assert leaves[3].dtype == jnp.int32 and leaves[3].shape == ()
    assert [np.shape(x) for x in leaves[:3]] == [(5, 3), (5,), (5, 3)]
    ts = convert.inverse_state([np.asarray(x) for x in leaves], CPU)
    for a, b in zip(ts.leaves(), leaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert all(p.is_leaf and p.dtype == torch.float32 for p in ts.spheres)


@pytest.mark.parametrize("masked", [False, True])
def test_one_adam_step_vs_optax(masked):
    """``_apply_update`` from the same state and gradient: optax's adam
    and torch's Adam, the trainable mask, radius >= 1e-2, colour in
    [0, 1]; every leaf within 1e-6 of its largest magnitude."""
    opt, state, rng = _jax_state(1)
    grads = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=x.shape), jnp.float32), state.spheres)
    trainable = None
    if masked:
        trainable = JSpheres(jnp.zeros((5, 3)), jnp.ones(5),
                             jnp.ones((5, 3)))
    ts = convert.inverse_state(
        [np.asarray(x) for x in jax.tree.leaves(state)], CPU, lr=1e-2)
    jnew, _ = jinv._apply_update(opt, state, grads, 0.0, trainable)
    tgrads = Spheres(*(torch.from_numpy(np.array(g)) for g in grads))
    tmask = None if trainable is None else Spheres(
        *(torch.from_numpy(np.array(m)) for m in trainable))
    tnew, _ = tinv._apply_update(ts, tgrads, 0.0, tmask)
    jl, tl = jax.tree.leaves(jnew), tnew.leaves()
    assert int(tl[3]) == int(jl[3]) == 4
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert _rel(a.numpy(), b) < 1e-6, (i, _rel(a.numpy(), b))


def test_closest_hit_matmul_vs_jax():
    """The matmul oracle against JAX's on rays of rgbbox's camera at 32²:
    the same winners and the same t up to the expansion's rounding."""
    jsc, sc = jscenes.rgbbox(), tscenes.rgbbox(device=CPU)
    jo, jd = jprimary(jcamera(jsc.look_from, jsc.look_at, (0., 1., 0.),
                              jsc.fov, 1.0), 32, 32)
    o, d = primary_rays(camera(sc.look_from, sc.look_at, (0., 1., 0.),
                               sc.fov, 1.0, device=CPU), 32, 32)
    ji, jt = jbf.closest_hit_matmul(jsc.spheres, jo, jd)
    ti, tt = tbf.closest_hit_matmul(sc.spheres, o, d)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    hit = np.isfinite(np.asarray(jt))
    assert hit.mean() > 0.3
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=1e-5)
    pi, pt = tbf.closest_hit_precise(sc.spheres, o, d)
    assert (pi != ti).float().mean() < 0.01
    assert tapi._oracle(tapi.prepare_scene(sc, 8, 8, with_bvh=False,
                                           device=CPU),
                        "brute_matmul").func is tbf.closest_hit_matmul


def test_soft_render_vs_jax():
    """Image and gradients of a weighted loss of ``soft_render_image`` at
    16², centres moved so that silhouettes cross pixels."""
    js, ts, jcam, cam = _mini()
    shift = np.asarray([[0.3, -0.2, 0.1], [-0.25, 0.2, 0.0]], np.float32)
    js = js._replace(center=js.center + shift)
    ts = ts._replace(center=ts.center + torch.from_numpy(shift))
    wts = np.sin(np.arange(16 * 16 * 3, dtype=np.float32)).reshape(16, 16, 3)

    def jloss(s):
        return jnp.sum(jsoft.soft_render_image(s, jcam, 16, 16, 5e-2)
                       * wts)
    jimg = np.asarray(jsoft.soft_render_image(js, jcam, 16, 16, 5e-2))
    jg = jax.grad(jloss)(js)
    sph = Spheres(*(t.clone().requires_grad_(True) for t in ts))
    img = tsoft.soft_render_image(sph, cam, 16, 16, 5e-2)
    (img * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(img.detach().numpy(), jimg, rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(sph, jg):
        assert np.abs(np.asarray(b)).max() > 0
        assert _rel(a.grad.numpy(), b) < 1e-4, _rel(a.grad.numpy(), b)


def test_brute_train_step_vs_jax_loss_shard():
    """``make_train_step``'s 8 rank bodies, summed, against JAX's
    ``_loss_shard`` over all the rays (what its psum adds up): the loss
    within 1e-5, the gradients within the engine tolerances."""
    js, ts, jcam, cam = _mini()
    js = js._replace(radius=js.radius * 1.2)
    ts = ts._replace(radius=ts.radius * 1.2)
    jo, jd = jprimary(jcam, 16, 16)
    o, d = primary_rays(cam, 16, 16)
    rng = np.random.default_rng(3)
    tgt = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    for mode in ("brute", "brute_matmul"):
        jl, jg = jax.value_and_grad(jinv._loss_shard)(
            js, jo, jd, jnp.asarray(tgt), 3, mode)
        step = tinv.make_train_step(RayMesh(0, 8, None, CPU), max_depth=3,
                                    oracle_mode=mode)
        parts = [step.rank_loss_and_grads(r, ts, o, d, torch.from_numpy(tgt))
                 for r in range(8)]
        loss = sum(p[0] for p in parts)
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
        for k, (b, tol) in enumerate(zip(jg, TOLS)):
            a = sum(p[1 + k] for p in parts)
            assert _rel(a.numpy(), b) < tol, (mode, k, _rel(a.numpy(), b))


def _fit_inputs():
    jsc, sc = jscenes.rgbbox(), tscenes.rgbbox(device=CPU)
    jcam = jcamera(jsc.look_from, jsc.look_at, (0., 1., 0.), jsc.fov, 1.0)
    cam = camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                 device=CPU)
    target = np.asarray(japi.render_float(japi.prepare_scene(jsc, 16, 16),
                                          16, 16, mode="brute", max_depth=2))
    jinit = jsc.spheres._replace(
        color=jnp.clip(jsc.spheres.color + 0.2, 0, 1))
    init = Spheres(*(torch.from_numpy(np.array(x)) for x in jinit))
    return target, (jcam, jinit), (cam, init)


def _jmesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("rays",))


def test_train_state_resume_no_regression(tmp_path):
    """tests/test_utils.py:105 on the port: a fit resumed from a
    checkpoint continues exactly."""
    target, _, (cam, init) = _fit_inputs()
    mesh = RayMesh(0, 1, None, CPU)
    kw = dict(lr=5e-2, max_depth=2)
    losses_a = []
    tinv.recover(target, cam, init, mesh, steps=4,
                 callback=lambda i, l, s: losses_a.append(l), **kw)
    ckdir = str(tmp_path / "ck")
    tinv.recover(target, cam, init, mesh, steps=2, checkpoint_dir=ckdir,
                 checkpoint_every=1, **kw)
    losses_b = []
    _, final = tinv.recover(target, cam, init, mesh, steps=4,
                            checkpoint_dir=ckdir, checkpoint_every=10,
                            callback=lambda i, l, s: losses_b.append(l),
                            **kw)
    np.testing.assert_allclose(losses_b, losses_a[2:], rtol=1e-5)
    assert final == losses_b[-1]
    # a resume past the end runs no step and reports the saved loss
    _, again = tinv.recover(target, cam, init, mesh, steps=4,
                            checkpoint_dir=ckdir, **kw)
    assert again == final


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """Two steps in one package, checkpointed; the other package loads the
    state bit for bit and resumes with steps 3 and 4.  Step 3's loss, a
    function of the loaded state alone, agrees with the writer's own
    uninterrupted run within 1e-5; later steps part as the packages'
    gradients and optimizers round differently."""
    from raytracers_tpu.utils import checkpoint as jckpt
    target, (jcam, jinit), (cam, init) = _fit_inputs()
    kw = dict(lr=5e-2, max_depth=2)
    ckdir = str(tmp_path / "ck")
    mesh = RayMesh(0, 1, None, CPU)
    own, resumed = [], []
    if writer == "jax":
        jinv.recover(target, jcam, jinit, _jmesh(), steps=4,
                     callback=lambda i, l, s: own.append(l), **kw)
        jinv.recover(target, jcam, jinit, _jmesh(), steps=2,
                     checkpoint_dir=ckdir, checkpoint_every=1, **kw)
        loaded, step, _ = tckpt.load_train_state(
            ckdir + "/ckpt_2", tinv.init_state(init, tinv.adam(5e-2)))
        tinv.recover(target, cam, init, mesh, steps=4, checkpoint_dir=ckdir,
                     callback=lambda i, l, s: resumed.append(l), **kw)
        leaves = [x.numpy() for x in loaded.leaves()]
    else:
        tinv.recover(target, cam, init, mesh, steps=4,
                     callback=lambda i, l, s: own.append(l), **kw)
        tinv.recover(target, cam, init, mesh, steps=2, checkpoint_dir=ckdir,
                     checkpoint_every=1, **kw)
        opt = optax.adam(5e-2)
        loaded, step, _ = jckpt.load_train_state(
            ckdir + "/ckpt_2", jinv.InverseState(jinit, opt.init(jinit)))
        jinv.recover(target, jcam, jinit, _jmesh(), steps=4,
                     checkpoint_dir=ckdir,
                     callback=lambda i, l, s: resumed.append(l), **kw)
        leaves = [np.asarray(x) for x in jax.tree.leaves(loaded)]
    assert step == 2 and int(leaves[3]) == 2
    with np.load(ckdir + "/ckpt_2.npz") as z:
        for i, x in enumerate(leaves):
            np.testing.assert_array_equal(x, z[f"leaf_{i}"])
    with np.load(ckdir + "/ckpt_4.npz") as z:
        assert int(z["leaf_3"]) == 4 and int(z["step"]) == 4
    assert len(resumed) == 2
    np.testing.assert_allclose(resumed[0], own[2], rtol=1e-5)


def test_train_state_file_matches_jax(tmp_path):
    """The port writes JAX's fields, and loads them back exactly."""
    opt, state, _ = _jax_state(2)
    from raytracers_tpu.utils import checkpoint as jckpt
    jckpt.save_train_state(str(tmp_path / "j"), state, 7, loss=0.5)
    ts = tinv.init_state(Spheres(torch.zeros(5, 3), torch.ones(5),
                                 torch.zeros(5, 3)), tinv.adam(1e-2))
    ts, step, loss = tckpt.load_train_state(str(tmp_path / "j"), ts)
    assert (step, loss) == (7, 0.5)
    tckpt.save_train_state(str(tmp_path / "t"), ts, 7, loss=0.5)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    back, step, _ = jckpt.load_train_state(str(tmp_path / "t"), state)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_recover_soft_runs_and_keeps_init():
    """``recover_soft``'s torch Adam: the loss falls, masks hold, the
    initial spheres are not changed."""
    _, ts, _, cam = _mini()
    target = tsoft.soft_render_image(ts, cam, 16, 16, 1e-2).detach()
    pert = ts._replace(center=ts.center + 0.3)
    before = [t.clone() for t in pert]
    losses = []
    mask = Spheres(torch.ones(2, 3), torch.zeros(2), torch.zeros(2, 3))
    fit = tsoft.recover_soft(target, cam, pert, steps=20, lr=3e-2,
                             trainable=mask,
                             callback=lambda i, l, s: losses.append(l))
    assert losses[-1] < losses[0]
    assert all(torch.equal(a, b) for a, b in zip(pert, before))
    assert torch.equal(fit.radius, pert.radius)
    assert torch.equal(fit.color, pert.color)


def test_examples_run_on_the_host(tmp_path, capsys):
    """The three examples at a tiny size with ``--cpu``; rgbbox_recovery
    checkpoints and resumes."""
    from raytracers_tpu_torch.examples import (center_recovery,
                                               inverse_rendering,
                                               rgbbox_recovery)
    losses = inverse_rendering.main(["--cpu", "--steps", "3", "--res", "8"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    d0, d1 = center_recovery.main(["--cpu", "--steps", "5", "--res", "8"])
    assert np.isfinite(d1) and d0 > 0
    ck = str(tmp_path / "ck")
    args = ["--cpu", "--res", "16", "--depth", "2", "--ckpt-dir", ck,
            "--ckpt-every", "1"]
    assert len(rgbbox_recovery.main(args + ["--steps", "2"])) == 2
    assert len(rgbbox_recovery.main(args + ["--steps", "3"])) == 1
    assert "resumed from" in capsys.readouterr().out


def test_fit_grad_gap_probe_isolates_the_differing_pixels(capsys):
    """At a fit's start the kernel engine's colour gradient stands off the
    plain renderer's by the few pixels whose paths the two settle
    differently; with those left out of both cotangents they agree."""
    import re

    from raytracers_tpu_torch.probes import fit_grad_gap
    fit_grad_gap.main(["--size", "24", "--depth", "4", "--seeds", "1"])
    out = capsys.readouterr().out

    def read(name):
        return float(re.search(rf"\b{name} (\S+)", out).group(1))
    assert read("grad_kept") < 1e-3
    assert read("grad") > 10 * read("grad_kept")
