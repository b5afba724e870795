"""The port's mesh and train step across two real processes: gloo on the
CPU (mirrors tests/test_distributed_multiprocess.py and
tests/test_utils.py:87).

Each test starts two processes that join one process group through
``parallel.distributed.init`` at a free localhost port, each under a
120 s limit.  A 2-rank sum is a + b in either order, so the all-reduced
loss and gradients equal the one-process sum of the two rank bodies bit
for bit, and the gathered render equals the one-process render.
"""
import os
import subprocess
import sys

import pytest
import torch

from raytracers_tpu_torch.parallel.distributed import (dryrun_multichip,
                                                       free_address, init,
                                                       scaling_efficiency)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

_PRELUDE = r"""
import os, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO_ROOT"])
from raytracers_tpu_torch.parallel.distributed import init
from raytracers_tpu_torch.parallel.mesh import RayMesh, ray_mesh

pid = int(sys.argv[1])
info = init(os.environ["COORD"], 2, pid, device="cpu")
assert info == {"process_index": pid, "process_count": 2,
                "local_devices": 1, "global_devices": 2}, info
mesh = ray_mesh(device="cpu")
assert (mesh.rank, mesh.size) == (pid, 2), mesh
CPU = torch.device("cpu")
"""

_ALL_REDUCE = r"""
from raytracers_tpu_torch.parallel.mesh import all_gather, all_sum
total = all_sum(mesh, lambda r: [torch.full((4,), float(r + 1)),
                                 torch.tensor(2.0 * r)])
assert torch.equal(total[0], torch.full((4,), 3.0)), total
assert float(total[1]) == 2.0 and total[1].shape == (), total
got = all_gather(mesh, lambda r: torch.tensor([r, 10 * r]))
assert got.tolist() == [0, 0, 1, 10], got
print(f"proc {pid}: all-reduce ok", flush=True)
"""

_RENDER = r"""
from raytracers_tpu_torch import scenes
from raytracers_tpu_torch.geometry import camera
from raytracers_tpu_torch.parallel.mesh import (render_pallas_sharded,
                                                render_sharded)
from raytracers_tpu_torch.render.api import prepare_scene, render
from raytracers_tpu_torch.render.megakernel import (build_pallas_scene,
                                                    render_pallas)
H, W, D = 256, 16, 3          # the (32, 16) / 512 fallback config
sc = scenes.rgbbox(device=CPU)
ps = build_pallas_scene(sc.spheres)
cam = camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, W / H,
             device=CPU)
ref = render_pallas(ps, cam, W, H, max_depth=D, tile=512, block=(32, 16))
img = render_pallas_sharded(ps, cam, H, W, mesh=mesh, max_depth=D)
assert torch.equal(img, ref)
prep = prepare_scene(sc, 30, 31, leaf_size=4, device=CPU)
assert torch.equal(render_sharded(prep, 30, 31, mesh=mesh, mode="bvh",
                                  max_depth=2),
                   render(prep, 30, 31, mode="bvh", max_depth=2))
print(f"proc {pid}: sharded render bitexact ok", flush=True)
"""

_TRAIN = r"""
from raytracers_tpu_torch.geometry import Spheres, camera
from raytracers_tpu_torch.grad.inverse import (adam, init_state,
                                               make_train_step_pallas)
from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
H = W = 32
true = Spheres(torch.tensor([[0.0, 0.0, -5.0], [2.5, 0.0, -4.0]]),
               torch.tensor([1.5, 1.0]),
               torch.tensor([[0.8, 0.3, 0.2], [0.2, 0.6, 0.9]]))
pert = true._replace(radius=true.radius * torch.tensor([1.15, 0.9]),
                     color=(true.color + 0.1).clamp(0.0, 1.0))
cam = camera((0., 0., 2.), (0., 0., -5.), (0., 1., 0.), 60.0, 1.0,
             device=CPU)
target = make_render_pallas_diff(W, H, max_depth=3)(true, cam)
step = make_train_step_pallas(mesh, W, H, max_depth=3)
ls, gs = step.loss_and_grads(pert, cam, target)
# the one-process sum of the two rank bodies
local = make_train_step_pallas(RayMesh(0, 2, None, CPU), W, H, max_depth=3)
lu, gu = local.loss_and_grads(pert, cam, target)
assert torch.equal(ls, lu), (ls, lu)
for a, b in zip(gs, gu):
    assert torch.equal(a, b)
state = init_state(pert, adam(1e-2))
state, l0 = step(state, cam, target)
lstate = init_state(pert, adam(1e-2))
lstate, l1 = local(lstate, cam, target)
assert torch.equal(l0, l1) and torch.isfinite(l0)
for a, b in zip(state.leaves(), lstate.leaves()):
    assert torch.equal(a, b)
print(f"proc {pid}: train step bitexact ok", flush=True)
"""


def _run_two_process(tmp_path, body, ok_marker):
    worker = tmp_path / "worker.py"
    worker.write_text(_PRELUDE + body)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(COORD=free_address(), REPO_ROOT=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), str(i)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("2-process workers timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert ok_marker in out, out


def test_two_process_all_reduce(tmp_path):
    _run_two_process(tmp_path, _ALL_REDUCE, "all-reduce ok")


def test_two_process_pallas_sharded_bitexact(tmp_path):
    _run_two_process(tmp_path, _RENDER, "sharded render bitexact ok")


def test_two_process_train_step_pallas(tmp_path):
    """The gloo step's loss and gradients equal the one-process sum of its
    two rank bodies bit for bit, and so does the state after one step."""
    _run_two_process(tmp_path, _TRAIN, "train step bitexact ok")


def test_dryrun_multichip_two_processes():
    out = dryrun_multichip(2, device="cpu")
    assert [r[0] for r in out] == [0, 1]
    assert out[0][3] == (64, 64) and out[0][2] is not None


def test_distributed_single_process():
    info = init(device="cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1}
    assert not torch.distributed.is_initialized()
    assert abs(scaling_efficiency(100.0, 680.0, 8) - 0.85) < 1e-9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: NCCL and the kernels K1d and K2")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_rank_nccl_train_step(cuda):
    """The megakernel's train step on a one-rank NCCL mesh (a HashStore,
    world size 1): the loss bit-equal to the unsharded engine's, the
    gradients within 1e-4 of their largest magnitude (K2's slot table adds
    in no fixed order), and a colour-only step lowers the loss."""
    from raytracers_tpu_torch import scenes
    from raytracers_tpu_torch.geometry import Spheres, camera
    from raytracers_tpu_torch.grad.inverse import (adam, init_state,
                                                   make_train_step_pallas)
    from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
    from raytracers_tpu_torch.parallel.mesh import ray_mesh
    sc = scenes.rgbbox(device=cuda)
    cam = camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                 device=cuda)
    f = make_render_pallas_diff(64, 64, max_depth=8)
    with torch.no_grad():
        target = f(sc.spheres, cam)
    pert = sc.spheres._replace(color=(sc.spheres.color + 0.1).clamp(0, 1))
    sph = Spheres(*(t.clone().requires_grad_(True) for t in pert))
    lu = ((f(sph, cam) - target) ** 2).sum()
    lu.backward()
    torch.distributed.init_process_group(
        "nccl", store=torch.distributed.HashStore(), rank=0, world_size=1)
    try:
        mesh = ray_mesh(device=cuda)
        assert mesh.group is not None and mesh.size == 1
        mask = Spheres(torch.zeros_like(pert.center),
                       torch.zeros_like(pert.radius),
                       torch.ones_like(pert.color))
        step = make_train_step_pallas(mesh, 64, 64, max_depth=8,
                                      trainable=mask)
        ls, gs = step.loss_and_grads(pert, cam, target)
        assert torch.equal(ls, lu.detach())
        for a, b in zip(gs, sph):
            assert float((a - b.grad).abs().max()) <= (
                1e-4 * float(b.grad.abs().max()))
        state = init_state(pert, adam(2e-3))
        losses = [float(step(state, cam, target)[1]) for _ in range(3)]
        assert losses[-1] < losses[0]
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_dryrun_multichip_one_card(cuda):
    out = dryrun_multichip(1, device="cuda")
    assert out[0][0] == 0 and out[0][3] == (64, 64)
