"""How far the kernel engine's colour gradient stands from the plain one's
at the start of an rgbbox colour fit, and why.

A fit (``examples/rgbbox_recovery.py``) starts from the suite's colours
moved by up to ``--pert`` a channel, against a target rendered from the
suite's own colours, so its residual ``f - target`` is small.  The kernel
engine (``grad/pallas_diff.py``) and the plain renderer
(``grad/diff_render.py`` over the brute-force oracle) settle a few pixels'
paths differently in float32; there the two images differ by a whole
colour, which weighs against that small residual.  For each seed this
prints:

* ``px``: the pixels whose colours differ by more than 1e-3;
* ``img``: ‖f_engine - f_plain‖ / ‖f_plain - target‖;
* ``grad``: ‖g_engine - g_plain‖ / ‖g_plain‖ of the colours' gradient of
  sum((f - target)²);
* ``grad_kept``: the same with the differing pixels left out of both
  cotangents;
* ``grad_far``: ``grad`` against a uniform random target, whose residual
  is large.

    python -m raytracers_tpu_torch.probes.fit_grad_gap --size 64 --depth 8

Runs on the card where there is one, else on the CPU.
"""
from __future__ import annotations

import argparse

import torch

from ..geometry import Spheres
from ..grad.diff_render import render_diff
from ..grad.pallas_diff import make_render_pallas_diff
from ..render.api import pallas_diff_config, prepare_scene
from ..render.bruteforce import make_closest_hit
from ..render.megakernel import build_pallas_scene
from ..scenes import rgbbox


def _grad(render, spheres: Spheres, cam, cot_of):
    """The image and the colours' gradient for the cotangent
    ``cot_of(image)``."""
    colour = spheres.color.detach().clone().requires_grad_(True)
    img = render(Spheres(spheres.center, spheres.radius, colour), cam)
    img.backward(cot_of(img.detach()))
    return img.detach(), colour.grad


def _rel(a, b, scale) -> float:
    return float((a - b).norm() / scale.norm())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--pert", type=float, default=0.12)
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    a = p.parse_args(argv)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    n = a.size
    sc = rgbbox(device=dev)
    cam = prepare_scene(sc, n, n, with_bvh=False, device=dev).cam
    engine = {}
    if a.depth >= 50:
        tile, block, sched, prefix = pallas_diff_config(
            build_pallas_scene(sc.spheres).n_clusters)
        engine = dict(tile=tile, block=block, schedule=tuple(sched),
                      sort_prefix=tuple(prefix))
    kernel = make_render_pallas_diff(n, n, max_depth=a.depth, **engine)

    def plain(s, c):
        return render_diff(make_closest_hit, s, c, n, n, max_depth=a.depth)

    with torch.no_grad():
        target = plain(sc.spheres, cam)
    for seed in a.seeds:
        g = torch.Generator().manual_seed(seed)
        moved = (torch.rand(sc.spheres.color.shape, generator=g) * 2 - 1
                 ) * a.pert
        start = Spheres(sc.spheres.center, sc.spheres.radius,
                        (sc.spheres.color + moved.to(dev)).clamp(0, 1))
        fe, ge = _grad(kernel, start, cam, lambda f: 2 * (f - target))
        fp, gp = _grad(plain, start, cam, lambda f: 2 * (f - target))
        keep = ((fe - fp).abs().amax(-1, keepdim=True) <= 1e-3).to(fe.dtype)
        _, ge_k = _grad(kernel, start, cam, lambda f: 2 * (f - target) * keep)
        _, gp_k = _grad(plain, start, cam, lambda f: 2 * (f - target) * keep)
        far = torch.rand(target.shape, generator=g).to(dev)
        _, ge_f = _grad(kernel, start, cam, lambda f: 2 * (f - far))
        _, gp_f = _grad(plain, start, cam, lambda f: 2 * (f - far))
        print(f"seed {seed} px {int((keep == 0).sum())} of {n * n} "
              f"img {_rel(fe, fp, fp - target):.4f} "
              f"grad {_rel(ge, gp, gp):.4f} "
              f"grad_kept {_rel(ge_k, gp_k, gp_k):.2e} "
              f"grad_far {_rel(ge_f, gp_f, gp_f):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
