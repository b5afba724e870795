"""The plain reference of one step of the inverse-rendering fit.

Plain PyTorch, independent of the program: it imports nothing of it, and
builds on ``reference.py``'s tracer and replay alone.  From a given state
(the spheres, Adam's first and second moments and its count) one step:

* the loss ``sum((f - target)²)`` of the reference's own colours ``f``
  (``reference.trace``), and the spheres' gradients through its recorded
  paths (``reference.replay``) with the cotangent ``2 (f - target)``; the
  camera is not a parameter of the fit, so its gradient is dropped;
* each gradient times its leaf's mask (a masked leaf's moments still move,
  as optax's do);
* optax's Adam, written out: ``m = (1 - b1) g + b1 m``,
  ``v = (1 - b2) g² + b2 v``, the bias corrections with ``count + 1``,
  ``p - lr m̂ / (√v̂ + eps)``;
* the clamps: radius at least ``RADIUS_MIN``, colour in ``COLOUR_CLIP``,
  the constants the program's update (``grad/inverse.py``
  ``_apply_update``) documents.

Every operation runs in ``dtype``: float32 is the configuration's precision,
bfloat16 the control that has to fail.  The constants (``lr``, ``b1``,
``b2``, ``eps`` and the bias corrections, computed on the host from the
count) enter as Python numbers, so that the control's moments stay
finite: 0.999 has no bfloat16 of its own below 1.

Where it parts from the program by rounding alone: torch's Adam, which the
program runs, moves the first moment by ``lerp_`` (``m + (1 - b1)(g - m)``),
divides ``√v`` by ``√(1 - b2^t)`` before adding ``eps``, and applies
``lr / (1 - b1^t)`` through ``addcdiv_``; optax, and this reference, scale
``m`` and ``v`` first.  The two agree to a few float32 roundings a step.
"""
from __future__ import annotations

import torch

from rtbench import reference

LEAVES = ("centre", "radius", "colour")
RADIUS_MIN = 1e-2
COLOUR_CLIP = (0.0, 1.0)


class State:
    """A fit's state: the three leaves, their first and second moments
    (each a tuple of three tensors in ``LEAVES``' order) and Adam's count
    of the steps taken, a host int."""

    def __init__(self, leaves, m, v, count: int):
        self.leaves, self.m, self.v = tuple(leaves), tuple(m), tuple(v)
        self.count = int(count)

    def flat(self) -> torch.Tensor:
        """The nine tensors in one float32 vector."""
        return torch.cat([t.reshape(-1).float()
                          for t in (*self.leaves, *self.m, *self.v)])

    @classmethod
    def unflat(cls, flat: torch.Tensor, count: int, like) -> "State":
        """The inverse of ``flat``, with the leaves shaped as ``like``."""
        out, k = [], 0
        for t in (*like, *like, *like):
            out.append(flat[k:k + t.numel()].reshape(t.shape))
            k += t.numel()
        return cls(out[0:3], out[3:6], out[6:9], count)


def adam(p, g, m, v, count: int, lr: float, b1: float, b2: float,
         eps: float):
    """optax's Adam on one leaf in ``p``'s dtype: (p', m', v')."""
    m = (1.0 - b1) * g + b1 * m
    v = (1.0 - b2) * (g * g) + b2 * v
    return adam_apply(p, m, v, count + 1, lr, b1, b2, eps), m, v


def adam_apply(p, m, v, t: int, lr: float, b1: float, b2: float,
               eps: float):
    """Adam's update of ``p`` from the moments ``m``, ``v`` after its
    ``t``-th step: ``p - lr m̂ / (√v̂ + eps)``, bias-corrected with t."""
    m_hat = m / (1.0 - b1 ** t)
    v_hat = v / (1.0 - b2 ** t)
    return p - lr * (m_hat / (torch.sqrt(v_hat) + eps))


def step(state: State, masks, adam_args: dict, cam, target, width: int,
         height: int, max_depth: int, dtype=torch.float32):
    """One step of the fit from ``state``: (the new state and the loss, in
    ``dtype``, and the trace's info: ``reference.trace``'s work and
    ``bounces``).  ``masks`` are the leaves' masks, ``adam_args`` Adam's
    ``lr``, ``b1``, ``b2`` and ``eps`` (the traffic mix's)."""
    leaves = [t.to(dtype) for t in state.leaves]
    img, info = reference.trace(leaves, cam, width, height, max_depth,
                                dtype=dtype, record=True)
    resid = img - target.to(dtype)
    loss = (resid * resid).sum()
    grads = reference.replay(leaves, cam, width, height, info.pop("path"),
                             2.0 * resid, dtype=dtype)[:3]
    new, ms, vs = [], [], []
    for p, g, m, v, mask in zip(leaves, grads, state.m, state.v, masks):
        p, m, v = adam(p, g.to(dtype) * mask.to(dtype), m.to(dtype),
                       v.to(dtype), state.count, adam_args["lr"],
                       adam_args["b1"], adam_args["b2"], adam_args["eps"])
        new.append(p)
        ms.append(m)
        vs.append(v)
    new[1] = new[1].clamp(min=RADIUS_MIN)
    new[2] = new[2].clamp(*COLOUR_CLIP)
    return State(new, ms, vs, state.count + 1), loss, info
