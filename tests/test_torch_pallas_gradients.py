"""The port of ``examples/pallas_gradients.py`` against the JAX example's
computation: rgbbox through the fwd+bwd engine (K1d + K2; JAX's kernels
with ``interpret=True``, the port's plain versions on the CPU), loss
mean(img ** 2), gradients by the spheres' centre, radius and colour and by
the camera's origin, at 16x16, depth 2.

Gradients are held within tests/test_torch_pallas_diff.py's tolerances
relative to their largest magnitude (centre and radius 1e-2: grazing hits
divide by sqrt(disc), where the two packages round differently, ROADMAP
queue 3; colour and camera 3e-3).  The loss: XLA's CPU code contracts
multiply-adds, which moves 80 of the 768 colour channels at depth 2 (by
up to 3.3e-5) and the loss by 2.7e-6 of itself, so in this process it is
held within 1e-5; with XLA held to SSE4.2, which has no FMA, JAX's image
equals the port's bit for bit and the loss agrees within 1e-6 (the mean's
summation order).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracers_tpu import camera as jcamera
from raytracers_tpu import scenes as jscenes
from raytracers_tpu.grad.pallas_diff import make_render_pallas_diff as jmake
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.examples import pallas_gradients
from raytracers_tpu_torch.geometry import camera
from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff

torch.set_num_threads(2)
RES, DEPTH = 16, 2
TOLS = dict(center=1e-2, radius=1e-2, color=3e-3, origin=3e-3)


def _jax():
    sc = jscenes.rgbbox()
    cam = jcamera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0)
    f = jmake(RES, RES, max_depth=DEPTH, interpret=True)
    value, (gs, gc) = jax.value_and_grad(
        lambda s, c: jnp.mean(f(s, c) ** 2), argnums=(0, 1))(sc.spheres, cam)
    return float(value), dict(center=gs.center, radius=gs.radius,
                              color=gs.color, origin=gc.origin)


def _check_grads(grads, ref):
    for name, tol in TOLS.items():
        a, b = grads[name].numpy(), np.asarray(ref[name])
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.abs(a).max() > 0
        gap = np.abs(a - b).max() / np.abs(b).max()
        assert gap < tol, (name, gap)


def _port():
    return pallas_gradients.main(["--cpu", "--res", str(RES), "--depth",
                                  str(DEPTH)])


def test_example_against_jax(capsys):
    loss, grads = _port()
    out = capsys.readouterr().out
    assert out.startswith("loss = ") and "d loss / d camera.origin" in out
    ref_loss, ref = _jax()
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    _check_grads(grads, ref)


_NO_FMA = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_pallas_gradients as t
loss, grads = t._jax()
sc = t.jscenes.rgbbox()
cam = t.jcamera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0)
img = t.jmake(t.RES, t.RES, max_depth=t.DEPTH, interpret=True)(sc.spheres,
                                                                cam)
print(json.dumps(dict(loss=loss, img=np.asarray(img).tolist(),
                      **{k: np.asarray(v).tolist() for k, v in grads.items()})))
"""


def test_example_against_jax_without_fma():
    """JAX's computation in a process whose XLA may not use FMA
    instructions (``--xla_cpu_max_isa=SSE4_2``): the image bit for bit, the
    loss within 1e-6."""
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.path.dirname(tests))
    out = subprocess.run([sys.executable, "-c", _NO_FMA, tests], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    loss, grads = _port()
    sc = tscenes.rgbbox(device="cpu")
    cam = camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                 device="cpu")
    img = make_render_pallas_diff(RES, RES, max_depth=DEPTH)(sc.spheres, cam)
    np.testing.assert_array_equal(img.numpy(),
                                  np.asarray(ref["img"], np.float32))
    assert float(loss) == pytest.approx(ref["loss"], rel=1e-6)
    _check_grads(grads, ref)


def test_example_runs_on_the_card_by_default():
    """Without ``--cpu`` the example asks for the card, and there is none
    here: it raises instead of falling back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pallas_gradients.main(["--res", "8", "--depth", "1"])
