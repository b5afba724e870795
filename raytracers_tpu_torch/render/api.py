"""Public rendering API: prepare_scene / render (futhark/ray.fut:239-247).

Counterpart of ``raytracers_tpu.render.api``.  ``prepare_scene`` builds the
camera and the megakernel's scene layout once, on ``device`` (default: the
CUDA card); ``render`` runs where the prepared tensors live.
"""
from __future__ import annotations

from typing import NamedTuple

from ..geometry import MAX_DEPTH, Camera, Spheres, camera
from ..scenes import Scene
from ..utils.platform import resolve_device
from . import bruteforce
from .megakernel import (PallasScene, build_pallas_scene, render_pallas,
                         render_pallas_record, render_pallas_twophase)
from .tracer import render_colours, render_packed

_NO_BVH = ("the BVH path (build_bvh, mode='bvh') is not ported yet "
           "(ROADMAP queue 1, item 12); use with_bvh=False")


class PreparedScene(NamedTuple):
    """Camera + scene layouts, ready to render."""
    spheres: Spheres      # original order
    bvh: None             # the BVH is not ported: always None
    cam: Camera
    pallas: PallasScene | None = None


def prepare_scene(scene: Scene, height: int, width: int,
                  with_pallas: bool = False, with_bvh: bool = True,
                  device=None) -> PreparedScene:
    """Build the camera (vup=(0,1,0), aspect w/h) and, with ``with_pallas``,
    the megakernel layout with clusters front-to-back from the camera.
    ``with_bvh=True``, the JAX package's default, needs the BVH, which is
    not ported yet: pass ``with_bvh=False``."""
    if with_bvh:
        raise NotImplementedError(_NO_BVH)
    device = resolve_device(device)
    spheres = Spheres(*(f.to(device) for f in scene.spheres))
    cam = camera(scene.look_from, scene.look_at, (0.0, 1.0, 0.0), scene.fov,
                 width / height, device=device)
    pallas = (build_pallas_scene(spheres, sort_origin=scene.look_from)
              if with_pallas else None)
    return PreparedScene(spheres=spheres, bvh=None, cam=cam, pallas=pallas)


def pallas_config(C: int):
    """Megakernel config by scene class: (tile, block, schedule,
    sort_prefix), the values of the JAX package's ``pallas_config``."""
    if C > 128:
        return 2048, (8, 256), (2, 3, 6), (None, 0.25, 0.12)
    if C <= 16:
        return 2048, (64, 32), (3, 4, 8), (None, 0.5, 0.25)
    return 2048, (32, 64), (3, 6), (None, 0.25)


def pallas_diff_config(C: int):
    """Fwd+bwd engine config by scene class: (tile, block, schedule,
    sort_prefix) for ``grad.pallas_diff.make_render_pallas_diff``, the
    values of the JAX package's ``pallas_diff_config``."""
    if C <= 16:
        return 2048, (64, 32), (3, 4, 8), (None, 0.5, 0.25)
    return 2048, (32, 64), (3, 6), (None, 0.25)


def _render_pallas(prepared: PreparedScene, height: int, width: int,
                   max_depth: int, with_stats: bool):
    """The megakernel render with the scene class's config: deep renders
    (``max_depth >= 16``) go through the multi-phase compaction schedule,
    shallow ones through one launch."""
    ps = prepared.pallas
    if ps is None:
        raise ValueError("prepare_scene(..., with_pallas=True) required "
                         "for mode='pallas'")
    tile, block, schedule, sort_prefix = pallas_config(ps.n_clusters)
    kw = dict(max_depth=max_depth, tile=tile, block=block,
              with_stats=with_stats)
    if max_depth >= 16 and sum(schedule) < max_depth:
        return render_pallas_twophase(ps, prepared.cam, width, height,
                                      schedule=schedule,
                                      sort_prefix=sort_prefix, **kw)
    return render_pallas(ps, prepared.cam, width, height, **kw)


def render(prepared: PreparedScene, height: int, width: int,
           mode: str = "bvh", max_depth: int = MAX_DEPTH,
           chunk: int | None = None):
    """Render to the packed int32 image (h, w) (futhark/ray.fut:246-247).

    ``mode="pallas"`` runs the megakernel with the scene class's config;
    ``mode="brute"`` is the all-pairs tracer; ``chunk`` bounds its batch."""
    if mode == "pallas":
        return _render_pallas(prepared, height, width, max_depth, False)
    if mode == "brute":
        return render_packed(bruteforce.make_closest_hit(prepared.spheres),
                             prepared.spheres, prepared.cam, width, height,
                             max_depth, chunk)
    if mode == "bvh":
        raise NotImplementedError(_NO_BVH)
    raise ValueError(f"unknown render mode: {mode}")


def render_stats(prepared: PreparedScene, height: int, width: int,
                 max_depth: int = MAX_DEPTH) -> dict:
    """Exact per-ray work counters, summed, for the render that
    ``render(mode="pallas")`` runs: ``slot_tests`` (sphere rows tested),
    ``ray_bounces`` and ``cull_rows`` (AABB slab rows tested), plus the
    per-phase lists of a multi-phase render.  The counters are the port's
    own (per ray, what its kernel executes), not the TPU's per-tile ones."""
    return _render_pallas(prepared, height, width, max_depth, True)[1]


def render_float(prepared: PreparedScene, height: int, width: int,
                 mode: str = "bvh", max_depth: int = MAX_DEPTH,
                 chunk: int | None = None):
    """Render to float colours (h, w, 3), the differentiable output.

    ``mode="pallas"`` runs the megakernel in record mode (K1d), one launch
    at the default tile, as the JAX package does; gradients through it come
    from ``grad.pallas_diff.make_render_pallas_diff``.  ``mode="brute"`` is
    the all-pairs tracer."""
    if mode == "pallas":
        if prepared.pallas is None:
            raise ValueError("prepare_scene(..., with_pallas=True) required "
                             "for mode='pallas'")
        colours, _ = render_pallas_record(prepared.pallas, prepared.cam,
                                          width, height, max_depth=max_depth)
        return colours
    if mode == "brute":
        return render_colours(bruteforce.make_closest_hit(prepared.spheres),
                              prepared.spheres, prepared.cam, width, height,
                              max_depth, chunk)
    if mode == "bvh":
        raise NotImplementedError(_NO_BVH)
    raise ValueError(f"unknown render mode: {mode}")
