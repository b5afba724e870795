"""Ray math shared by the plain versions of K1 and K2.

The torch mirror of ``csrc/ray_math.cuh``: the same float32 operations in
the same order, so the kernels and their plain versions compute one
function bit for bit.  Square roots go through float64 (``vec.sqrt``),
which rounds them correctly on every device; ``1.0 / x`` is torch's IEEE
reciprocal.  Every function broadcasts over its tensors' shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import SCENE_EPSILON, T_MAX
from ..vec import sqrt

LANE = 128                                 # spheres per cluster
KEY_MASK = -LANE                           # clears the 7 lane bits
BIG = float(T_MAX)
EPS = SCENE_EPSILON
SKY_K = (0.5, 0.7, 1.0)                    # sky endpoint per channel


class Quad(NamedTuple):
    ocx: torch.Tensor
    ocy: torch.Tensor
    ocz: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    disc: torch.Tensor


def quad(ox, oy, oz, dx, dy, dz, a, cx, cy, cz, r2) -> Quad:
    """The quadratic of a ray (o, d), a = d.d, and a sphere (c, r2)."""
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r2
    return Quad(ocx, ocy, ocz, b, c, b * b - a * c)


def search_m(q: Quad, sq, epsa):
    """m = a*t of the near root beyond ``epsa``, else of the far root; BIG
    on a miss (``sq`` is sqrt(disc) wherever disc > 0)."""
    m0 = -q.b - sq
    m = torch.where(m0 > epsa, m0, -q.b + sq)
    return torch.where((q.disc > 0.0) & (m > epsa), m, BIG)


def key_floor(m: torch.Tensor) -> torch.Tensor:
    """m with its 7 lane bits cleared, as the packed key holds it."""
    return (m.view(torch.int32) & KEY_MASK).view(torch.float32)


class Bounce(NamedTuple):
    q: Quad
    sq: torch.Tensor
    inv_a: torch.Tensor
    t2: torch.Tensor
    near: torch.Tensor               # the near root was taken
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    inv_r: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    inv_dn: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    udn: torch.Tensor
    rx: torch.Tensor
    ry: torch.Tensor
    rz: torch.Tensor
    scatter: torch.Tensor            # the reflection leaves the surface


def bounce(ox, oy, oz, dx, dy, dz, a, cx, cy, cz, rad, best_m) -> Bounce:
    """A hit's re-intersection in the window (0, best_m / a + 1) and its
    mirror shading (pallas_kernel.py:894-931)."""
    q = quad(ox, oy, oz, dx, dy, dz, a, cx, cy, cz, rad * rad)
    sq = sqrt(torch.where(q.disc > 0.0, q.disc, 1.0))
    inv_a = 1.0 / a
    t0 = (-q.b - sq) * inv_a
    t1 = (-q.b + sq) * inv_a
    w_hi = best_m * inv_a + 1.0
    near = (t0 < w_hi) & (t0 > 0.0)
    t2 = torch.where(near, t0, t1)
    px, py, pz = ox + t2 * dx, oy + t2 * dy, oz + t2 * dz
    inv_r = 1.0 / rad
    nx, ny, nz = (px - cx) * inv_r, (py - cy) * inv_r, (pz - cz) * inv_r
    inv_dn = 1.0 / sqrt(a)
    ux, uy, uz = dx * inv_dn, dy * inv_dn, dz * inv_dn
    udn = ux * nx + uy * ny + uz * nz
    rx = ux - 2.0 * udn * nx
    ry = uy - 2.0 * udn * ny
    rz = uz - 2.0 * udn * nz
    scatter = (rx * nx + ry * ny + rz * nz) > 0.0
    return Bounce(q, sq, inv_a, t2, near, px, py, pz, inv_r, nx, ny, nz,
                  inv_dn, ux, uy, uz, udn, rx, ry, rz, scatter)


def sky(t, k: float):
    """The sky gradient's weight for a channel of endpoint k at
    t = 0.5 * (uy + 1)."""
    return (1.0 - t) + t * k
