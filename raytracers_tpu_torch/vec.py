"""L0 math primitives: 3-vectors and axis-aligned bounding boxes, SoA style.

A "vec3" is the trailing axis of an ``(..., 3)`` float32 tensor, so every op
here broadcasts over batch shapes.  Counterpart of ``raytracers_tpu.vec``,
with the same associativity everywhere so results agree bit for bit:

* ``dot`` sums left to right, ``(x + y) + z``, as XLA's reduce does;
* ``sqrt`` is correctly rounded on every device: torch's CPU float32
  ``sqrt`` is not (about 0.7% of inputs differ by an ulp), so it is taken
  through float64, which rounds back to the correctly rounded float32;
* ``enclosing`` takes ``torch.minimum``/``maximum``, which propagate NaN
  as XLA's min/max do.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def vec3(x, y, z, dtype=torch.float32):
    """Build an (..., 3) vector from components (broadcasting), on the
    device of the first tensor among them (else the host)."""
    device = next((c.device for c in (x, y, z)
                   if isinstance(c, torch.Tensor)), None)
    return torch.stack(torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=dtype, device=device) for c in (x, y, z))),
        dim=-1)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (via float64)."""
    return torch.sqrt(x.double()).float()


def dot(a, b):
    """Dot product over the trailing axis: (...,3),(...,3) -> (...)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm(v):
    return sqrt(dot(v, v))


def normalise(v):
    return v * (1.0 / norm(v))[..., None]


def scale(s, v):
    """Scalar (...,) times vector (...,3)."""
    return torch.as_tensor(s, dtype=v.dtype, device=v.device)[..., None] * v


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


class Aabb(NamedTuple):
    """Axis-aligned bounding box; both corners are (..., 3) tensors."""
    min: torch.Tensor
    max: torch.Tensor


def enclosing(a: Aabb, b: Aabb) -> Aabb:
    """Smallest AABB containing both (futhark/prim.fut:38-45)."""
    return Aabb(torch.minimum(a.min, b.min), torch.maximum(a.max, b.max))


def centre(box: Aabb):
    """AABB centre as min + 0.5*(max-min) (futhark/prim.fut:47-50), in that
    associativity for bit parity with the reference."""
    return box.min + 0.5 * (box.max - box.min)
