"""BVH caching, sphere and train-state checkpoints as .npz files.

Counterpart of ``raytracers_tpu.utils.checkpoint`` in the same npz fields,
so a file written by either package loads in the other: a built LBVH
(``save_bvh`` / ``load_bvh``) skips the Morton sort and tree build on
reload; ``save_spheres`` / ``load_spheres`` keep inverse-rendering scene
parameters with a step and extra scalars; ``save_train_state`` /
``load_train_state`` keep a fit's spheres and Adam moments, so a fit
checkpointed by either package resumes in the other.  Loads go to
``device`` (default: the CUDA card), or to the template's tensors.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..bvh.lbvh import Bvh
from ..geometry import Spheres
from .platform import resolve_device

_BVH_FIELDS = ("order", "left", "right", "node_min", "node_max", "leaf_min",
               "leaf_max", "skip", "parent", "leaf_parent")


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' when missing; normalise so save(p)/load(p)
    round-trips for suffix-less paths too."""
    return path if path.endswith(".npz") else path + ".npz"


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def save_bvh(path: str, bvh: Bvh) -> None:
    arrays = {f: _np(getattr(bvh, f)) for f in _BVH_FIELDS}
    arrays["sph_center"] = _np(bvh.spheres.center)
    arrays["sph_radius"] = _np(bvh.spheres.radius)
    arrays["sph_color"] = _np(bvh.spheres.color)
    np.savez_compressed(_npz_path(path), **arrays)


def load_bvh(path: str, device=None) -> Bvh:
    device = resolve_device(device)
    with np.load(_npz_path(path)) as z:
        spheres = Spheres(*(_tensor(z[f"sph_{f}"], device)
                            for f in ("center", "radius", "color")))
        return Bvh(spheres=spheres,
                   **{f: _tensor(z[f], device) for f in _BVH_FIELDS})


def save_spheres(path: str, spheres: Spheres, step: int = 0,
                 extra: dict | None = None) -> None:
    """Checkpoint inverse-rendering scene parameters (+ scalars)."""
    arrays = {"center": _np(spheres.center),
              "radius": _np(spheres.radius),
              "color": _np(spheres.color),
              "step": np.asarray(step)}
    for k, v in (extra or {}).items():
        arrays["x_" + k] = _np(v)
    np.savez_compressed(_npz_path(path), **arrays)


def load_spheres(path: str, device=None) -> tuple[Spheres, int, dict]:
    device = resolve_device(device)
    with np.load(_npz_path(path)) as z:
        spheres = Spheres(*(_tensor(z[f], device)
                            for f in ("center", "radius", "color")))
        extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
        return spheres, int(z["step"]), extra


def save_train_state(path: str, state, step: int = 0,
                     loss: float = float("nan")) -> None:
    """Checkpoint a ``grad.inverse.InverseState`` as the JAX package saves
    its ``InverseState``: its leaves as ``leaf_0``... in JAX's leaf order
    (``InverseState.leaves``), then ``step`` and ``loss``."""
    arrays = {f"leaf_{i}": _np(x) for i, x in enumerate(state.leaves())}
    arrays["step"] = np.asarray(step)
    arrays["loss"] = np.asarray(loss, np.float64)
    np.savez_compressed(_npz_path(path), **arrays)


def load_train_state(path: str, like) -> tuple[object, int, float]:
    """Restore a training state saved by either package's
    ``save_train_state`` into ``like``, an ``InverseState`` over an Adam
    optimizer, in place.  Returns (like, step, loss at save: nan for old
    checkpoints)."""
    with np.load(_npz_path(path)) as z:
        n = len(like.leaves())
        like.load_leaves([z[f"leaf_{i}"] for i in range(n)])
        loss = float(z["loss"]) if "loss" in z.files else float("nan")
        return like, int(z["step"]), loss


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> str | None:
    if not os.path.isdir(directory):
        return None
    cands = [f for f in os.listdir(directory)
             if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f[len(prefix):-4]))
    return os.path.join(directory, cands[-1])
