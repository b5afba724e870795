"""Full-scene inverse rendering: recover a perturbed rgbbox, all 400
spheres, from a rendered target image through the sharded fwd+bwd engine
of the megakernel (``grad.inverse.make_train_step_pallas``: K1d forward,
K2 backward on the card), with checkpoints.  The port of
``examples/rgbbox_recovery.py``, whose docstring records what converges on
this scene (colour) and what does not (geometry by path replay).

On the card (or ``--cpu`` on the host, slowly); under ``torchrun`` the
image's bands are sharded over its processes:

    python -m raytracers_tpu_torch.examples.rgbbox_recovery --res 256 \\
        --depth 8 --steps 200 --ckpt-dir /tmp/rgbbox_ckpt

Prints the loss curve, per-parameter L1 errors against the truth and the
wall-clock per phase.
"""
import argparse
import os
import time

import numpy as np
import torch

from .. import scenes
from ..geometry import Spheres, camera
from ..grad.inverse import (InverseState, init_state,
                            make_train_step_pallas)
from ..grad.pallas_diff import make_render_pallas_diff
from ..grad.soft_render import recover_soft
from ..parallel.distributed import init
from ..parallel.mesh import ray_mesh
from ..utils import checkpoint as ckpt
from ..utils.platform import resolve_device

CFG = dict(tile=2048, block=(64, 32))      # the engine's rgbbox config


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def perturb(truth: Spheres, seed: int, pc: float, pr: float, pk: float):
    """Every parameter of every sphere moved by a seeded uniform draw, as
    ``examples/rgbbox_recovery.py`` moves them."""
    rng = np.random.default_rng(seed)
    n, dev = truth.center.shape[0], truth.center.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)
    return truth._replace(
        center=truth.center + f32(rng.uniform(-pc, pc, (n, 3))),
        radius=truth.radius * f32(rng.uniform(1 - pr, 1 + pr, (n,))),
        color=(truth.color + f32(rng.uniform(-pk, pk, (n, 3)))).clamp(0, 1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--soft-steps", type=int, default=0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--anneal", type=int, nargs="*", default=None,
                    help="engine depth ladder for phase B (e.g. 2 8); "
                         "default: [depth]")
    ap.add_argument("--lr-soft", type=float, default=3e-2)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--lr-geo", type=float, default=3e-4,
                    help="Adam's rate for centre and radius")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pert-center", type=float, default=0.0)
    ap.add_argument("--pert-radius", type=float, default=0.0)
    ap.add_argument("--pert-colour", type=float, default=0.12)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    init(device=device)
    mesh = ray_mesh(device=device)

    H = W = args.res
    sc = scenes.rgbbox(device=device)
    truth = sc.spheres
    n = truth.center.shape[0]
    cam = camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, W / H,
                 device=device)
    print(f"device: {device} ({mesh.size} ranks)  scene: rgbbox ({n} "
          f"spheres) {W}x{H} depth {args.depth}", flush=True)

    def target_at(depth):
        with torch.no_grad():
            return make_render_pallas_diff(W, H, max_depth=depth,
                                           **CFG)(truth, cam)
    target = target_at(args.depth)
    pc, pr, pk = args.pert_center, args.pert_radius, args.pert_colour
    pert = perturb(truth, args.seed, pc, pr, pk)

    def errs(s):
        return tuple(float((a - b).abs().mean()) for a, b in zip(s, truth))

    e0 = errs(pert)
    print(f"start   L1: center {e0[0]:.4f} radius {e0[1]:.4f} "
          f"colour {e0[2]:.4f}", flush=True)

    # phase A: soft-visibility warm start against a depth-2 target
    t0 = time.perf_counter()
    warm = pert
    if args.soft_steps > 0:
        warm = recover_soft(target_at(2), cam, pert, steps=args.soft_steps,
                            lr=args.lr_soft, sigma0=5e-2, sigma1=5e-3)
    _sync(device)
    tA = time.perf_counter() - t0
    eA = errs(warm)
    print(f"phase A ({args.soft_steps} soft steps, {tA:.1f}s)  L1: center "
          f"{eA[0]:.4f} radius {eA[1]:.4f} colour {eA[2]:.4f}", flush=True)

    # phase B: the megakernel's path replay, one engine a depth rung;
    # unperturbed groups masked, geometry at its own smaller rate
    def adam_groups(params):
        return torch.optim.Adam(
            [dict(params=params[:2], lr=args.lr_geo),
             dict(params=params[2:], lr=args.lr)], betas=(0.9, 0.999),
            eps=1e-8)

    depths = args.anneal if args.anneal else [args.depth]
    steps_per = [args.steps // len(depths)] * len(depths)
    steps_per[-1] += args.steps - sum(steps_per)
    trainable = Spheres(torch.full_like(truth.center, 1.0 if pc else 0.0),
                        torch.full_like(truth.radius, 1.0 if pr else 0.0),
                        torch.full_like(truth.color, 1.0 if pk else 0.0))
    step_fns = {d: make_train_step_pallas(mesh, W, H, max_depth=d,
                                          trainable=trainable, **CFG)
                for d in depths}
    targets = {d: target if d == args.depth else target_at(d)
               for d in depths}
    state: InverseState = init_state(warm, adam_groups)
    start, loss = 0, float("inf")
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        latest = ckpt.latest_checkpoint(args.ckpt_dir)
        if latest is not None:
            state, start, loss = ckpt.load_train_state(latest, state)
            print(f"resumed from {latest} (step {start})", flush=True)

    t0 = time.perf_counter()
    losses = []
    sched = [d for d, k in zip(depths, steps_per) for _ in range(k)]
    for i in range(start, args.steps):
        state, loss = step_fns[sched[i]](state, cam, targets[sched[i]])
        losses.append(float(loss))
        if (i + 1) % 25 == 0 or i == start:
            e = errs(state.spheres)
            print(f"  step {i + 1:4d} (d{sched[i]})  loss {float(loss):.5f}"
                  f"  L1 c/r/col {e[0]:.4f}/{e[1]:.4f}/{e[2]:.4f}",
                  flush=True)
        if args.ckpt_dir and mesh.rank == 0 and (
                (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps):
            ckpt.save_train_state(
                os.path.join(args.ckpt_dir, f"ckpt_{i + 1}"), state, i + 1,
                loss=float(loss))
    _sync(device)
    tB = time.perf_counter() - t0
    eB = errs(state.spheres)
    nsteps = max(args.steps - start, 1)
    print(f"phase B ({nsteps} replay steps, {tB:.1f}s, "
          f"{tB / nsteps * 1e3:.0f} ms/step)", flush=True)
    print(f"final   L1: center {eB[0]:.4f} radius {eB[1]:.4f} "
          f"colour {eB[2]:.4f}", flush=True)
    if losses:
        print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f}", flush=True)
    print(f"error reduction: center {e0[0] / max(eB[0], 1e-9):.1f}x  "
          f"radius {e0[1] / max(eB[1], 1e-9):.1f}x  "
          f"colour {e0[2] / max(eB[2], 1e-9):.1f}x", flush=True)
    return losses


if __name__ == "__main__":
    main()
