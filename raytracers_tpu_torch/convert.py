"""Carry data of the JAX package across into the port's tensors.

Each function takes one of the JAX package's NamedTuples (``Spheres``,
``Camera``, ``PallasScene``, ``Bvh``, ``TraversalScene``), or any tuple of
the same fields, and reads every field with ``np.asarray``, so this module
needs neither JAX nor the JAX package.  The tests use it to give the port's
kernel and traversal paths exactly the tables the JAX package renders from,
independently of the port's build.
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
