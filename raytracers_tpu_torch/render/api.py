"""Public rendering API: prepare_scene / render (futhark/ray.fut:239-247).

Counterpart of ``raytracers_tpu.render.api``.  ``prepare_scene`` builds the
camera, the LBVH and, on request, the megakernel's scene layout once, on
``device`` (default: the CUDA card); ``render`` runs where the prepared
tensors live.
"""
from __future__ import annotations

from typing import NamedTuple

from ..bvh.lbvh import Bvh, build_bvh
from ..bvh import traverse
from ..geometry import MAX_DEPTH, Camera, Spheres, camera
from ..scenes import Scene
from ..utils.platform import resolve_device
from ..utils.trace import spanned
from . import bruteforce
from .megakernel import (PallasScene, build_pallas_scene, render_pallas,
                         render_pallas_record, render_pallas_twophase)
from .tracer import render_colours, render_packed


class PreparedScene(NamedTuple):
    """Camera + scene layouts, ready to render."""
    spheres: Spheres      # original order
    bvh: Bvh | None       # None when built with with_bvh=False
    cam: Camera
    pallas: PallasScene | None = None


def prepare_scene(scene: Scene, height: int, width: int,
                  leaf_size: int = 8, with_pallas: bool = False,
                  with_bvh: bool = True, device=None) -> PreparedScene:
    """Build the camera (vup=(0,1,0), aspect w/h), with ``with_bvh`` the
    LBVH over clusters of ``leaf_size`` spheres (``mode="bvh"``), and with
    ``with_pallas`` the megakernel layout with clusters front-to-back from
    the camera (``mode="pallas"``)."""
    device = resolve_device(device)
    spheres = Spheres(*(f.to(device) for f in scene.spheres))
    cam = camera(scene.look_from, scene.look_at, (0.0, 1.0, 0.0), scene.fov,
                 width / height, device=device)
    bvh = build_bvh(spheres, leaf_size=leaf_size) if with_bvh else None
    pallas = (build_pallas_scene(spheres, sort_origin=scene.look_from)
              if with_pallas else None)
    return PreparedScene(spheres=spheres, bvh=bvh, cam=cam, pallas=pallas)


def _oracle(prepared: PreparedScene, mode: str):
    """The tracer's closest-hit function of ``mode`` "bvh", "brute" or
    "brute_matmul"."""
    if mode == "bvh":
        if prepared.bvh is None:
            raise ValueError("prepare_scene(..., with_bvh=True) required "
                             "for mode='bvh'")
        return traverse.make_closest_hit(prepared.bvh)
    if mode in ("brute", "brute_matmul"):
        formulation = "precise" if mode == "brute" else "matmul"
        return bruteforce.make_closest_hit(prepared.spheres, formulation)
    raise ValueError(f"unknown render mode: {mode}")


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
                   max_depth: int, with_stats: bool,
                   phase1_depth: int | None = None,
                   schedule: tuple | None = None):
    """The megakernel render with the scene class's config: deep renders
    (``max_depth >= 16``) go through the multi-phase compaction schedule,
    shallow ones through one launch.  An explicit ``schedule`` (or the
    single boundary ``phase1_depth``) replaces the class's schedule; an
    explicit ``schedule`` also drops the sort prefixes, as in the JAX
    package's ``render`` (api.py:152-157)."""
    ps = prepared.pallas
    if ps is None:
        raise ValueError("prepare_scene(..., with_pallas=True) required "
                         "for mode='pallas'")
    tile, block, default_sched, sort_prefix = pallas_config(ps.n_clusters)
    if schedule is None:
        schedule = ((phase1_depth,) if phase1_depth is not None
                    else default_sched)
    else:
        sort_prefix = None
    kw = dict(max_depth=max_depth, tile=tile, block=block,
              with_stats=with_stats)
    if max_depth >= 16 and sum(schedule) < max_depth:
        return render_pallas_twophase(ps, prepared.cam, width, height,
                                      schedule=tuple(schedule),
                                      sort_prefix=sort_prefix, **kw)
    return render_pallas(ps, prepared.cam, width, height, **kw)


@spanned("rt.render")
def render(prepared: PreparedScene, height: int, width: int,
           mode: str = "bvh", max_depth: int = MAX_DEPTH,
           chunk: int | None = None, phase1_depth: int | None = None,
           schedule: tuple | None = None):
    """Render to the packed int32 image (h, w) (futhark/ray.fut:246-247).

    ``mode="pallas"`` runs the megakernel with the scene class's config,
    scene-scale layouts (C > 128) through the two-level cull; ``schedule``
    (or the single boundary ``phase1_depth``) overrides the class's
    compaction schedule of deep renders.  ``mode="bvh"`` is the tracer
    over the skip-link walk, ``mode="brute"`` the all-pairs tracer and
    ``mode="brute_matmul"`` its matrix-product formulation; ``chunk``
    bounds their batch of rays."""
    if mode == "pallas":
        return _render_pallas(prepared, height, width, max_depth, False,
                              phase1_depth, schedule)
    return render_packed(_oracle(prepared, mode), prepared.spheres,
                         prepared.cam, width, height, max_depth, chunk)


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
    the all-pairs tracer, ``mode="bvh"`` the tracer over the skip-link
    walk."""
    if mode == "pallas":
        if prepared.pallas is None:
            raise ValueError("prepare_scene(..., with_pallas=True) required "
                             "for mode='pallas'")
        colours, _ = render_pallas_record(prepared.pallas, prepared.cam,
                                          width, height, max_depth=max_depth)
        return colours
    return render_colours(_oracle(prepared, mode), prepared.spheres,
                          prepared.cam, width, height, max_depth, chunk)
