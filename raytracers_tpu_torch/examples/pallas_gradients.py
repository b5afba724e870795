"""Gradients through the megakernel (the fwd+bwd path), the port of
``examples/pallas_gradients.py``.

Forward: K1 renders in record mode (K1d).  Backward: K2 replays the
recorded paths; autograd returns d(loss)/d(centre, radius, colour) for
every sphere of rgbbox, and d(loss)/d(camera), for loss = mean(img ** 2):

    python -m raytracers_tpu_torch.examples.pallas_gradients [--res 64] [--depth 8] [--cpu]

It runs on the card, or with ``--cpu`` through the plain versions of K1d
and K2 on the host.
"""
import argparse

import torch

from .. import scenes
from ..geometry import Camera, Spheres, camera
from ..grad.pallas_diff import make_render_pallas_diff
from ..utils.platform import resolve_device


def gradients(res: int, depth: int, device=None, **engine):
    """The loss and its gradients for rgbbox at ``res``², ``depth``
    bounces: (loss, {"center", "radius", "color", "origin"}).  ``engine``
    goes to ``make_render_pallas_diff`` (e.g. other kernels)."""
    device = resolve_device(device)
    sc = scenes.rgbbox(device=device)
    cam = camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                 device=device)
    f = make_render_pallas_diff(res, res, max_depth=depth, **engine)
    sph = Spheres(*(t.detach().requires_grad_(True) for t in sc.spheres))
    c = Camera(*(t.detach().requires_grad_(True) for t in cam))
    loss = torch.mean(f(sph, c) ** 2)
    loss.backward()
    return loss.detach(), dict(center=sph.center.grad,
                               radius=sph.radius.grad,
                               color=sph.color.grad, origin=c.origin.grad)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: the card)")
    args = ap.parse_args(argv)
    loss, grads = gradients(args.res, args.depth,
                            "cpu" if args.cpu else None)
    print(f"loss = {float(loss):.6f}")
    for name in ("center", "radius", "color"):
        g = grads[name].abs()
        print(f"d loss / d {name}: shape {tuple(g.shape)}, "
              f"|g| mean {float(g.mean()):.3e}, max {float(g.max()):.3e}")
    print(f"d loss / d camera.origin = {grads['origin'].cpu().numpy()}")
    return loss, grads


if __name__ == "__main__":
    main()
