"""Soft-visibility differentiable rendering: silhouette-aware gradients.

Counterpart of ``raytracers_tpu.grad.soft_render``, reproduced as it
stands.  Path-replay gradients (``pallas_diff.py``, ``diff_render.py``)
are blind to visibility motion, so pure centre recovery stalls; this adds
the boundary term with a SoftRas-style reparameterisation (Liu et al.
2019, adapted from triangles to spheres):

* per (ray, sphere) the quadratic's margin m = disc / a = r² - d⊥² is a
  smooth signed silhouette distance, positive inside the silhouette;
* hard visibility [m > 0] becomes sigmoid(m / (sigma · r²));
* the hard closest hit becomes a depth softmin: colours aggregate with
  weights w_i ∝ vis_i · exp(-t_i / gamma), plus a background term, the
  product of (1 - vis) over the spheres.

As sigma, gamma -> 0 this converges to the hard depth-1 render.  The
softmin is gated to spheres in front of the ray by the hard test t > 0, as
the reference gates it (ROADMAP queue 3).  All-pairs (R, N) tensors, sized
for inverse problems, not for the forward benchmark path.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..geometry import Camera, Spheres, sky_colour
from ..render.tracer import primary_rays
from ..vec import sqrt
from .inverse import _apply_update, _leaf_grads, _target, adam, init_state


def soft_render(spheres: Spheres, origins, dirs, sigma: float = 3e-2,
                gamma: float = 2e-2):
    """Soft depth-1 render -> colours (R, 3), smooth in all sphere params.

    ``sigma``: silhouette softness (relative to r², dimensionless).
    ``gamma``: depth-aggregation temperature (relative to scene scale).
    """
    o = origins[:, None, :]                     # (R, 1, 3)
    d = dirs[:, None, :]
    c = spheres.center[None, :, :]              # (1, N, 3)
    r = spheres.radius[None, :]                 # (1, N)

    oc = o - c                                  # (R, N, 3)
    a = (dirs * dirs).sum(dim=-1)[:, None]      # (R, 1)
    b = (oc * d).sum(dim=-1)                    # (R, N)
    cc = (oc * oc).sum(dim=-1) - r * r
    disc = b * b - a * cc
    m = disc / a                                # r² - d⊥² (signed margin)

    vis = torch.sigmoid(m / (sigma * (r * r + 1e-8)))
    sq = sqrt(torch.clamp(disc, min=1e-12))
    t = (-b - sq) / a                           # near root (smoothed)
    # behind-the-camera spheres must not contribute
    front = torch.sigmoid(t / (gamma + 1e-8))
    # irrelevant spheres must not claim the softmin's normaliser: a sphere
    # behind the camera, or one the ray misses, whose weight vis * front is
    # ~0 anyway (soft_render.py:63-73)
    relevant = (t > 0.0) & (m > -20.0 * sigma * (r * r + 1e-8))
    t_safe = torch.where(relevant, t, 1e7)

    scale = spheres.center.abs().max() + 1.0
    logits = -t_safe / (gamma * scale)
    w = vis * front * torch.exp(
        logits - logits.max(dim=1, keepdim=True).values.detach())
    # background weight = transparency: miss rays get ~1 -> sky
    w_bg = torch.prod(1.0 - vis * front, dim=1, keepdim=True)
    # 1e-12 guards 0/0 and keeps denom ** 2 of the quotient rule normal
    denom = w.sum(dim=1, keepdim=True) + w_bg + 1e-12
    sky = sky_colour(dirs)                      # (R, 3)
    colours = (w[..., None] * spheres.color[None, :, :]).sum(dim=1)
    return (colours + w_bg * sky) / denom


def soft_render_image(spheres: Spheres, cam: Camera, width: int,
                      height: int, sigma: float = 3e-2,
                      gamma: float = 2e-2):
    o, d = primary_rays(cam, width, height)
    return soft_render(spheres, o, d, sigma, gamma).reshape(height, width, 3)


def recover_soft(target_image, cam: Camera, init_spheres: Spheres,
                 steps: int = 300, lr: float = 5e-2,
                 sigma0: float = 1e-1, sigma1: float = 1e-2,
                 gamma: float = 2e-2,
                 trainable: Spheres | None = None,
                 callback: Callable | None = None) -> Spheres:
    """Fit sphere parameters, centres included, to a target image by
    annealed soft-visibility gradient descent with Adam (``optax.adam``'s
    defaults); sigma anneals geometrically sigma0 -> sigma1.  Returns new
    tensors; ``init_spheres`` is not changed."""
    h, w = target_image.shape[:2]
    target = _target(target_image, cam)
    state = init_state(init_spheres, adam(lr))
    decay = (sigma1 / sigma0) ** (1.0 / max(steps - 1, 1))
    sigma = sigma0
    for i in range(steps):
        # the JAX package passes each step's sigma as a float32
        s32 = float(torch.tensor(sigma, dtype=torch.float32))
        loss, *grads = _leaf_grads(lambda sph: ((soft_render_image(
            sph, cam, w, h, s32, gamma) - target) ** 2).mean(),
            state.spheres)
        state, loss = _apply_update(state, Spheres(*grads), loss, trainable)
        sigma *= decay
        if callback is not None:
            callback(i, float(loss), state.spheres)
    return Spheres(*(t.detach().clone() for t in state.spheres))
