"""The suite's scenes and camera, frozen here, and the seeded inputs a cell
draws from them.

A frozen copy of the reference suite's generators (athas/raytracers,
``futhark/ray.fut:88-107`` for the camera, ``:176-237`` for the scenes),
kept in the benchmark so that neither the program nor a later change to it
decides what the benchmark renders.  A configuration file names its
generator (``generator``, a module of ``rtbench/generators/``) and gives
its numbers; ``spheres`` builds the deterministic sphere grid on the host
(a few thousand float32 rows) and moves it to the device once.
Everything drawn from the seed (colours, offsets, jitters, targets) is
drawn on the device by ``torch.Generator``.
"""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch


def _grid(n: int, k: float) -> np.ndarray:
    """-k/2 + (k/n) * i for i in 0..n-1, in float32 (ray.fut:183-215)."""
    i = np.arange(n, dtype=np.float32)
    return (np.float32(-k / 2.0) + np.float32(k / n) * i).astype(np.float32)


def wall(fixed_axis: int, fixed_val: float, n: int, k: float,
         axes: tuple) -> np.ndarray:
    """An n x n grid of centres on a wall; ``axes`` are the (outer, inner)
    varying axes, in the suite's tabulate_2d order."""
    g = _grid(n, k)
    outer, inner = axes
    c = np.zeros((n, n, 3), dtype=np.float32)
    c[..., fixed_axis] = fixed_val
    c[..., outer] = g[:, None]
    c[..., inner] = g[None, :]
    return c.reshape(n * n, 3)


def spheres(config: dict, device) -> tuple:
    """(centre (N, 3), radius (N,), colour (N, 3)) float32 on ``device``,
    as the configuration's generator lays them out."""
    gen = config["generator"]
    module = importlib.import_module(f"rtbench.generators.{gen['name']}")
    arrays = module.spheres(**gen["args"])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64)."""
    return torch.sqrt(x.double()).float()


def _normalise(v: torch.Tensor) -> torch.Tensor:
    return v * (1.0 / _sqrt32((v * v).sum()))


def camera(config: dict, device) -> tuple:
    """The suite's pinhole camera (ray.fut:93-107) for the configuration's
    look_from, look_at and fov at aspect width / height, up (0, 1, 0):
    (origin, llc, horizontal, vertical), each (3,) float32, computed on the
    host in float32 and moved to ``device``."""
    f32 = torch.float32
    lf = torch.tensor(config["look_from"], dtype=f32)
    la = torch.tensor(config["look_at"], dtype=f32)
    vup = torch.tensor([0.0, 1.0, 0.0], dtype=f32)
    half_h = torch.tan(torch.tensor(config["fov"] * math.pi / 360.0,
                                    dtype=f32))
    half_w = (config["width"] / config["height"]) * half_h
    w = _normalise(lf - la)
    u = _normalise(torch.linalg.cross(vup, w))
    v = torch.linalg.cross(w, u)
    llc = lf - half_w * u - half_h * v - w
    return tuple(x.to(device) for x in (lf, llc, 2.0 * half_w * u,
                                        2.0 * half_h * v))


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number: the seed is
    folded to the 64 bits ``manual_seed`` takes."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def uniform(g: torch.Generator, shape, lo: float, hi: float,
            device) -> torch.Tensor:
    """Uniform float32 draws in [lo, hi) on ``device``."""
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                       dtype=torch.float32)
