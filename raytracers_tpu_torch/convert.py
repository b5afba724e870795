"""Carry data of the JAX package across into the port's tensors.

Each function takes one of the JAX package's NamedTuples (``Spheres``,
``Camera``, ``PallasScene``, ``Bvh``, ``TraversalScene``), or any tuple of
the same fields, and reads every field with ``np.asarray``, so this module
needs neither JAX nor the JAX package.  The tests use it to give the port's
kernel and traversal paths exactly the tables the JAX package renders from,
independently of the port's build.  ``inverse_state`` takes a training
state's leaves, so a fit begun in the JAX package continues in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .bvh.lbvh import Bvh
from .geometry import Camera, Spheres
from .render.megakernel import PallasScene
from .render.traversal import TraversalScene


def _fields(obj, device):
    return [torch.from_numpy(np.array(np.asarray(f))).to(device) for f in obj]


def spheres(obj, device) -> Spheres:
    return Spheres(*_fields(obj, device))


def camera(obj, device) -> Camera:
    return Camera(*_fields(obj, device))


def pallas_scene(obj, device) -> PallasScene:
    return PallasScene(*_fields(obj, device))


def bvh(obj, device) -> Bvh:
    return Bvh(spheres(obj.spheres, device), *_fields(obj[1:], device))


def traversal_scene(obj, device) -> TraversalScene:
    return TraversalScene(*_fields(obj, device))


def inverse_state(leaves, device, lr: float = 1e-2):
    """The JAX package's training state, ``InverseState(spheres,
    optax.adam(lr).init(...))`` after any number of steps, as its leaves
    (``jax.tree.leaves``, numpy arrays) -> the port's ``InverseState`` over
    ``torch.optim.Adam(lr)`` on ``device``: optax's count and moments
    become Adam's ``step``, ``exp_avg`` and ``exp_avg_sq``."""
    from .grad.inverse import adam, init_state
    state = init_state(spheres(leaves[:3], device), adam(lr))
    state.load_leaves(leaves)
    return state
