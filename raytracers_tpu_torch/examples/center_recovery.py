"""Recover perturbed sphere CENTRES from a rendered image, the port of
``examples/center_recovery.py``.

Path-replay gradients are blind to silhouette motion; this uses the
soft-visibility reparameterisation (``grad/soft_render.py``), whose
annealed sigmoid silhouettes carry d(pixel)/d(centre) across the boundary:

    python -m raytracers_tpu_torch.examples.center_recovery [--steps 400] [--res 48] [--cpu]
"""
import argparse

import torch

from ..geometry import Spheres, camera
from ..grad.diff_render import render_diff
from ..grad.soft_render import recover_soft
from ..render.bruteforce import make_closest_hit
from ..utils.platform import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    true = Spheres(f32([[0.0, 0.0, -5.0], [2.5, 0.0, -4.0]]), f32([1.5, 1.0]),
                   f32([[0.8, 0.3, 0.2], [0.2, 0.6, 0.9]]))
    cam = camera((0., 0., 2.), (0., 0., -5.), (0., 1., 0.), 60.0, 1.0,
                 device=device)
    target = render_diff(lambda s: make_closest_hit(s, "precise"), true, cam,
                         args.res, args.res, max_depth=1)
    pert = true._replace(center=true.center + f32([[0.6, -0.4, 0.3],
                                                   [-0.5, 0.45, 0.0]]))
    d0 = float((pert.center - true.center).abs().mean())
    print(f"initial mean |center error| = {d0:.4f}")
    fitted = recover_soft(
        target, cam, pert, steps=args.steps, lr=3e-2,
        callback=lambda i, l, s: (i % 100 == 0) and print(
            f"  step {i}: loss {l:.5f}"))
    d1 = float((fitted.center - true.center).abs().mean())
    print(f"final mean |center error|   = {d1:.4f}  "
          f"({d0 / max(d1, 1e-9):.1f}x reduction)")
    print("fitted centers:\n", fitted.center.cpu().numpy())
    return d0, d1


if __name__ == "__main__":
    main()
