"""Brute-force closest-hit oracles: every ray against every sphere.

Counterpart of ``raytracers_tpu.render.bruteforce``, with its two
formulations of the same semantics (futhark/ray.fut:76-86 minus the BVH
pruning, which cannot change the argmin):

* ``precise`` materialises ``oc = origin - center`` per (ray, sphere) pair,
  bit-faithful to the reference's scalar code; the port's cull-free CPU
  oracle, behind ``render(mode="brute")``;
* ``matmul`` expands the quadratic's coefficients so that the two per-pair
  dot products become (R, 3) @ (3, N) products:

      b = origin·dir - dir @ Cᵀ
      c = |origin|² - 2·origin @ Cᵀ + (|C|² - r²)

  The expansion cancels in float32 near grazing hits, so images agree with
  ``precise`` up to a handful of boundary pixels; ``render(mode=
  "brute_matmul")``.  As in the JAX package the products are plain matrix
  products, outside any kernel.

Ties on t go to the lower sphere index (argmin semantics).
"""
from __future__ import annotations

import functools

import torch

from ..geometry import INF, SCENE_EPSILON, T_MAX, Spheres, sphere_hit_t
from ..vec import dot, sqrt


def _best(t_pair):
    """(R, N) pair ts -> (idx (R,) int64, t (R,)); -1/inf on a total miss."""
    best_t, best_idx = torch.min(t_pair, dim=1)
    return torch.where(torch.isinf(best_t), -1, best_idx), best_t


def closest_hit_precise(spheres: Spheres, origins, dirs,
                        t_min=SCENE_EPSILON, t_max=T_MAX):
    """All-pairs intersection with exact per-pair ``oc`` arithmetic."""
    return _best(sphere_hit_t(origins[:, None, :], dirs[:, None, :],
                              spheres.center[None, :, :],
                              spheres.radius[None, :], t_min, t_max))


def closest_hit_matmul(spheres: Spheres, origins, dirs,
                       t_min=SCENE_EPSILON, t_max=T_MAX):
    """All-pairs intersection as two matrix products + elementwise work."""
    C = spheres.center                       # (N, 3)
    r2 = spheres.radius * spheres.radius     # (N,)
    a = dot(dirs, dirs)[:, None]             # (R, 1)
    od = dot(origins, dirs)[:, None]         # (R, 1)
    oo = dot(origins, origins)[:, None]      # (R, 1)
    dC = dirs @ C.T                          # (R, N)
    oC = origins @ C.T                       # (R, N)
    cc = dot(C, C)[None, :]                  # (1, N)
    b = od - dC
    c = oo - 2.0 * oC + (cc - r2[None, :])
    disc = b * b - a * c
    pos = disc > 0.0
    sq = sqrt(torch.where(pos, disc, 1.0))
    inv_a = 1.0 / a
    root0 = (-b - sq) * inv_a
    root1 = (-b + sq) * inv_a
    ok0 = (root0 < t_max) & (root0 > t_min)
    ok1 = (root1 < t_max) & (root1 > t_min)
    t = torch.where(ok0, root0, torch.where(ok1, root1, INF))
    return _best(torch.where(pos, t, INF))


def make_closest_hit(spheres: Spheres, formulation: str = "precise"):
    fn = {"precise": closest_hit_precise,
          "matmul": closest_hit_matmul}[formulation]
    return functools.partial(fn, spheres)
