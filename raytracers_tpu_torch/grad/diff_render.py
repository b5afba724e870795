"""Differentiable rendering by path replay: d(pixel)/d(sphere centre,
radius, colour) through torch autograd.

Counterpart of ``raytracers_tpu.grad.diff_render``, in two phases
(futhark/ray.fut:76-86):

* ``trace_paths`` runs the forward bounce loop with any closest-hit oracle
  and records only the discrete outcome of each bounce: the hit sphere and
  the event (bounce, absorb, miss, inactive).  No gradient flows there.
* ``replay_paths`` re-runs the shading chain over the recorded path,
  recomputing every continuous quantity (re-intersection t, hit point,
  normal, reflection, attenuation, sky) from the live sphere tensors, so
  autograd gives the gradient with the path held fixed: the exact gradient
  away from visibility discontinuities.

This module is the CPU oracle the fwd+bwd engine's backward kernel (K2,
``grad/replay_bwd.py``) is held against.  It runs no kernel.  The JAX
package's one-hot gather (``_onehot_gather``, an exactness device for the
TPU's matrix unit) computes an indexed gather; here both ``gather`` modes
are that gather.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..geometry import (MAX_DEPTH, SCENE_EPSILON, T_MAX, T_MIN, Camera,
                        Spheres, reflect, sky_colour, sphere_hit_t)
from ..render.tracer import primary_rays
from ..vec import dot, normalise

# event codes recorded per (step, ray)
EV_BOUNCE = 0    # hit + mirror scatter: the path continues
EV_ABSORB = 1    # hit, scatter rejected: the path ends black
EV_MISS = 2      # no hit: the path ends on the sky gradient
EV_INACTIVE = 3  # the path ended at an earlier step


@torch.no_grad()
def trace_paths(closest_hit: Callable, spheres: Spheres, origins, dirs,
                max_depth: int = MAX_DEPTH):
    """Phase 1: the forward trace, recording (idxs int32, events uint8),
    each (max_depth, R)."""
    o, d = origins, dirs
    done = torch.isnan(origins[:, 0])
    idxs, events = [], []
    for _ in range(max_depth):
        idx, t = closest_hit(o, d)
        hit = idx >= 0
        safe = idx.clamp(min=0)
        c, r = spheres.center[safe], spheres.radius[safe]
        t2 = sphere_hit_t(o, d, c, r, T_MIN, t + 1.0)
        p = o + t2[..., None] * d
        n = (p - c) * (1.0 / r)[..., None]
        refl = reflect(normalise(d), n)
        scatter_ok = dot(refl, n) > 0.0
        event = torch.where(
            done, EV_INACTIVE,
            torch.where(~hit, EV_MISS,
                        torch.where(scatter_ok, EV_BOUNCE, EV_ABSORB)))
        bounce = (event == EV_BOUNCE)[..., None]
        o = torch.where(bounce, p, o)
        d = torch.where(bounce, refl, d)
        done = done | (event == EV_MISS) | (event == EV_ABSORB)
        idxs.append(torch.where(hit, idx, -1).to(torch.int32))
        events.append(event.to(torch.uint8))
    return torch.stack(idxs), torch.stack(events)


def _gather_sphere_params(spheres: Spheres, safe_idx, mode: str):
    """The winner spheres' centre, radius and colour.  ``mode`` "take" and
    "onehot" both index: the one-hot dot of the JAX package computes this
    gather, exactly, on the TPU's matrix unit."""
    if mode not in ("take", "onehot"):
        raise ValueError(f"unknown gather mode {mode!r}")
    return (spheres.center[safe_idx], spheres.radius[safe_idx],
            spheres.color[safe_idx])


def _replay_step(spheres: Spheres, gather: str, o, d, light, result, idx,
                 event):
    safe = idx.clamp(min=0).long()
    c, r, col = _gather_sphere_params(spheres, safe, gather)
    # two-phase re-intersection, differentiable in (c, r); a miss's t is
    # +inf, and its gradient would turn into NaN through the unselected
    # branches below, so it is zeroed first (diff_render.py:181-184)
    t1 = sphere_hit_t(o, d, c, r, SCENE_EPSILON, T_MAX)
    t1 = torch.where(torch.isfinite(t1), t1, 0.0)
    t2 = sphere_hit_t(o, d, c, r, T_MIN, t1 + 1.0)
    t2 = torch.where(torch.isfinite(t2), t2, 0.0)
    p = o + t2[..., None] * d
    n = (p - c) * (1.0 / r)[..., None]
    refl = reflect(normalise(d), n)

    bounce = (event == EV_BOUNCE)[..., None]
    miss = (event == EV_MISS)[..., None]
    result = torch.where(miss, light * sky_colour(d), result)
    light = torch.where(bounce, light * col, light)
    o = torch.where(bounce, p, o)
    d = torch.where(bounce, refl, d)
    return o, d, light, result


def replay_paths(spheres: Spheres, origins, dirs, idxs, events,
                 gather: str = "take", remat: bool = False,
                 skip_dead: bool = False, skip_group: int = 8):
    """Phase 2: the differentiable shading replay -> colours (R, 3).

    ``remat=True`` recomputes each step (with ``skip_dead``, each group of
    steps) in the backward pass instead of keeping its intermediates
    (torch's activation checkpointing), which bounds the replay's memory at
    large ray counts.

    ``skip_dead=True`` replays groups of ``skip_group`` consecutive steps
    and skips a group in which no ray of the batch is alive (every event
    EV_INACTIVE): a dead step is the identity on the carry, so the colours
    and gradients are those of the dense replay (diff_render.py:202-233).
    The JAX package pads the last group with EV_INACTIVE steps; here it is
    shorter, which is the same function.  Eager torch decides on the host:
    the groups' liveness is read back in one transfer, which waits for the
    device when the events live there."""
    light = torch.ones_like(origins)
    result = torch.zeros_like(origins)
    o, d = origins, dirs

    def steps(o, d, light, result, idx, event):
        for i, e in zip(idx, event):
            o, d, light, result = _replay_step(spheres, gather, o, d, light,
                                               result, i, e)
        return o, d, light, result

    if skip_dead and skip_group < 1:
        raise ValueError(f"skip_group {skip_group} must be >= 1")
    G = skip_group if skip_dead else 1
    groups = [(idxs[k:k + G], events[k:k + G])
              for k in range(0, idxs.shape[0], G)]
    if skip_dead and groups:
        alive = torch.stack([(ev != EV_INACTIVE).any() for _, ev in groups])
        groups = [g for g, a in zip(groups, alive.tolist()) if a]
    for idx, event in groups:
        if remat and torch.is_grad_enabled():
            o, d, light, result = checkpoint(steps, o, d, light, result, idx,
                                             event, use_reentrant=False)
        else:
            o, d, light, result = steps(o, d, light, result, idx, event)
    return result


def trace_diff(closest_hit: Callable, spheres: Spheres, origins, dirs,
               max_depth: int = MAX_DEPTH):
    """Differentiable colours for a ray batch (R, 3)."""
    idxs, events = trace_paths(closest_hit, spheres, origins, dirs, max_depth)
    return replay_paths(spheres, origins, dirs, idxs, events)


def render_diff(closest_hit_for: Callable, spheres: Spheres, cam: Camera,
                width: int, height: int, max_depth: int = MAX_DEPTH,
                chunk: int | None = None):
    """Differentiable image (h, w, 3).  ``closest_hit_for(spheres)`` builds
    the oracle from the live sphere tensors, so the trace follows the
    current geometry at each call; ``chunk`` traces that many rays at a
    time."""
    origins, dirs = primary_rays(cam, width, height)
    ch = closest_hit_for(spheres)
    R = width * height
    chunk = R if chunk is None else chunk
    colours = torch.cat([
        trace_diff(ch, spheres, origins[k:k + chunk], dirs[k:k + chunk],
                   max_depth)
        for k in range(0, R, chunk)])
    return colours.reshape(height, width, 3)
