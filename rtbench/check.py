"""The numbers that decide ``correct``: the program's outputs against the
plain reference's on the same inputs.

Images, packed 0x00RRGGBB:

* ``mismatch``: the share of pixels whose packed value differs;
* ``mismatch_shallow``: the same over the pixels whose reference path ran
  at most ``SHALLOW`` segments, where no mirror cascade amplifies a
  rounding difference into another path;
* ``mismatch_mid``: the same over the pixels whose reference path ran at
  most ``MID`` segments, which every phase of the schedule before its
  last serves;
* ``mismatch_deep``: the same over the pixels whose reference path ran
  more than ``MID`` segments, which the last phases and the tail serve;
  0 where no path ran that deep;
* ``mean_delta``: the mean absolute difference of a channel, 0 to 255.

Gradients, per leaf (centre, radius, colour, then the camera's origin,
llc, horizontal, vertical), in float64: ``grad_<leaf>`` is the norm of the
difference over the reference's norm, ``norm_<leaf>`` the gap between the
two norms over the reference's.  Per sphere, for the centre and the
radius, ``sphere_<leaf>_q50`` and ``_q90`` are quantiles over the spheres
that either side moves of one sphere's error: the norm of its row's
difference over the larger of its reference row's norm and the median
row's.  A leaf's norm is the sum over all of a step's segments, and a few
near-tangent segments, whose float32 discriminant cancels, can carry it
(PERF.md §2); a sphere's row holds few of them.  A number that is not
finite reads +inf.

``limits/<cell>.json`` gives each compared number its limit; the others
are printed beside ``null`` and decide nothing (``verdict``).
"""
from __future__ import annotations

import math

import torch

SHALLOW = 2
MID = 8
SPHERE_LEAVES = ("centre", "radius")
QUANTILES = (50, 90)
LEAVES = ("centre", "radius", "colour", "origin", "llc", "horizontal",
          "vertical")


def _rgb(p: torch.Tensor) -> torch.Tensor:
    return torch.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], -1)


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def image(out: torch.Tensor, ref: torch.Tensor, bounces: torch.Tensor
          ) -> dict:
    """Numbers of a packed (h, w) image against the reference's."""
    out, ref = out.to(ref.device), ref
    diff = out != ref
    depth = bounces.reshape(ref.shape)
    deep = depth > MID
    delta = (_rgb(out) - _rgb(ref)).abs().double().mean()
    return dict(mismatch=float(diff.double().mean()),
                mismatch_shallow=float(diff[depth <= SHALLOW].double()
                                       .mean()),
                mismatch_mid=float(diff[depth <= MID].double().mean()),
                mismatch_deep=(float(diff[deep].double().mean())
                               if deep.any() else 0.0),
                mean_delta=float(delta))


def gradients(grads, ref_grads) -> dict:
    """Numbers of each leaf's gradient against the reference's."""
    out = {}
    for name, a, b in zip(LEAVES, grads, ref_grads):
        a = a.to(b.device).double()
        nb = float(b.norm())
        out[f"grad_{name}"] = _finite(float((a - b).norm()) / nb)
        out[f"norm_{name}"] = _finite(abs(float(a.norm()) - nb) / nb)
        if name in SPHERE_LEAVES:
            out.update(per_sphere(name, a, b))
    return out


def per_sphere(name: str, a: torch.Tensor, b: torch.Tensor) -> dict:
    """Quantiles over spheres of one sphere's error in leaf ``name``."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    gap, ref = (a - b).norm(dim=1), b.norm(dim=1)
    moved = (ref > 0) | (a.norm(dim=1) > 0)
    if not bool((ref > 0).any()):
        return {f"sphere_{name}_q{q}": math.inf for q in QUANTILES}
    floor = ref[ref > 0].median()
    err = (gap / torch.maximum(ref, floor))[moved]
    qs = torch.quantile(err, torch.tensor(QUANTILES, dtype=err.dtype,
                                          device=err.device) / 100.0)
    return {f"sphere_{name}_q{q}": _finite(float(v))
            for q, v in zip(QUANTILES, qs)}


def worst(readings: list) -> dict:
    """The largest reading of each number over the units checked."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct where every number
    with a limit reads at most its limit."""
    table = {k: dict(value=v, limit=limits.get(k)) for k, v in
             numbers.items()}
    ok = all(not (v["value"] > v["limit"]) and math.isfinite(v["value"])
             for v in table.values() if v["limit"] is not None)
    missing = [k for k in limits if k not in numbers]
    return ok and not missing, table
