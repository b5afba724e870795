"""Inverse rendering demo (BASELINE.json configs[4]), the port of
``examples/inverse_rendering.py``.

Renders a small ground-truth scene, perturbs the spheres' radii and
colours, and recovers them by sharded pixel-gradient descent over the
all-pairs oracle.  On the card, or with ``--cpu`` on the host; under
``torchrun`` the rays are sharded over its processes:

    python -m raytracers_tpu_torch.examples.inverse_rendering [--steps 120] [--res 32] [--cpu]
"""
import argparse

import numpy as np
import torch

from ..geometry import Spheres, camera
from ..grad.diff_render import render_diff
from ..grad.inverse import recover
from ..parallel.distributed import init
from ..parallel.mesh import ray_mesh
from ..render.bruteforce import make_closest_hit
from ..utils.platform import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    init(device=device)
    mesh = ray_mesh(device=device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    truth = Spheres(f32([[0.0, 0.0, -5.0], [2.5, 0.0, -4.0],
                         [-2.2, 0.8, -6.0]]),
                    f32([1.5, 1.0, 0.9]),
                    f32([[0.8, 0.3, 0.2], [0.2, 0.6, 0.9], [0.9, 0.8, 0.2]]))
    cam = camera((0., 0., 2.), (0., 0., -5.), (0., 1., 0.), 60.0, 1.0,
                 device=device)
    target = render_diff(lambda s: make_closest_hit(s, "precise"), truth,
                         cam, args.res, args.res, max_depth=4)

    rng = np.random.default_rng(0)
    start = truth._replace(
        radius=truth.radius * f32(rng.uniform(0.85, 1.2, 3)),
        color=(truth.color + f32(rng.uniform(-0.2, 0.2, (3, 3)))).clamp(0, 1))
    trainable = Spheres(torch.zeros_like(truth.center),
                        torch.ones_like(truth.radius),
                        torch.ones_like(truth.color))
    print(f"mesh: {mesh.size} ranks on {device}; optimizing radius+color "
          f"({args.steps} steps)")
    losses = []
    fitted, final = recover(target, cam, start, mesh, steps=args.steps,
                            lr=args.lr, max_depth=4, trainable=trainable,
                            callback=lambda i, l, s: losses.append(l))
    print(f"loss: {losses[0]:.4f} -> {final:.4f}")
    print("radius err:", (fitted.radius - truth.radius).abs().cpu().numpy())
    print("colour err:", (fitted.color - truth.color).abs().amax(dim=1)
          .cpu().numpy())
    return losses


if __name__ == "__main__":
    main()
