"""The two backward backends of the port's fwd+bwd engine at depth 50,
against a float64 replay of the same recorded paths (CPU, plain versions).

rgbbox at 48x48, depth 50, loss sum(image ** 2).  A float64 replay of the
paths K1d records (``replay_paths`` in float64, the discrete path held
fixed) gives about half the pixels their float32 colour within 1e-6: the
well-conditioned pixels.  At the others a mirror cascade reaches a
near-tangent re-intersection, whose gradient divides by sqrt(disc); in
float32 a few such rays' gradients blow up by 1e7 or more of the float64
replay's largest, in either backend, on different rays.  So over the whole
image the two backends' largest gradients disagree completely, and neither
is the float64 replay's.  Over the well-conditioned pixels both are within
tests/test_torch_pallas_diff.py's tolerances of the float64 replay and of
each other, and the chunked, depth-sorted xla backward with them.  The
unchunked xla backward is the plain autograd of the replay through
``primary_rays``, bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.geometry import Camera, Spheres, camera
from raytracers_tpu_torch.grad import pallas_diff as pd
from raytracers_tpu_torch.grad.diff_render import replay_paths
from raytracers_tpu_torch.render import megakernel as tmk
from raytracers_tpu_torch.render.api import pallas_diff_config
from raytracers_tpu_torch.render.tracer import primary_rays

torch.set_num_threads(2)
CPU = "cpu"
SIDE, DEPTH = 48, 50
WELL_CONDITIONED_ERR = 1e-6
# centre, radius, colour, then the camera's origin, llc, horizontal,
# vertical (tests/test_torch_pallas_diff.py)
TOLS = (1e-2, 1e-2, 3e-3, 3e-3, 3e-3, 3e-3, 3e-3)


@functools.lru_cache(maxsize=None)
def _setup():
    """Spheres, camera, the engine's config, the recorded paths and the
    well-conditioned pixels' (SIDE, SIDE, 1) weights."""
    sc = tscenes.rgbbox(device=CPU)
    cam = camera(sc.look_from, sc.look_at, (0.0, 1.0, 0.0), sc.fov, 1.0,
                 device=CPU)
    cfg = pallas_diff_config(tmk.build_pallas_scene(sc.spheres).n_clusters)
    engine = pd._ReplayEngine(SIDE, SIDE, DEPTH, cfg[0], "take", False, 1,
                              False, None, tmk.megakernel)
    colours, rec = engine.forward(sc.spheres, cam)
    idxs, events = pd._rec_to_path(rec)
    with torch.no_grad():
        o, d = primary_rays(Camera(*(t.double() for t in cam)), SIDE, SIDE)
        col = replay_paths(Spheres(*(t.double() for t in sc.spheres)), o, d,
                           idxs, events)
    err = (col.reshape(colours.shape) - colours.double()).abs().amax(-1)
    weight = (err < WELL_CONDITIONED_ERR).double()[..., None]
    return sc.spheres, cam, cfg, colours, idxs, events, weight


def _leaves(spheres, cam, dtype=torch.float32):
    return (Spheres(*(t.detach().to(dtype).requires_grad_(True)
                      for t in spheres)),
            Camera(*(t.detach().to(dtype).requires_grad_(True) for t in cam)))


@functools.lru_cache(maxsize=None)
def _engine_grads(backend, masked):
    """Gradients of sum(image ** 2), times the well-conditioned weights if
    ``masked``, through one of the engine's backward backends."""
    spheres, cam, (tile, block, schedule, prefix), _, _, _, weight = _setup()
    kw = dict(max_depth=DEPTH, tile=tile)
    if backend == "pallas":
        kw.update(block=block, schedule=schedule, sort_prefix=prefix)
    elif backend == "xla":
        kw.update(backward="xla")
    else:
        kw.update(backward="xla", bwd_chunks=8, sort_by_depth=True)
    f = pd.make_render_pallas_diff(SIDE, SIDE, **kw)
    sph, c = _leaves(spheres, cam)
    img = f(sph, c)
    loss = img * img
    (loss * weight.float() if masked else loss).sum().backward()
    return [t.grad for t in (*sph, *c)]


@functools.lru_cache(maxsize=None)
def _float64_grads():
    """The masked loss's gradients through a float64 replay of the same
    paths, with the float32 image's cotangent."""
    spheres, cam, _, colours, idxs, events, weight = _setup()
    sph, c = _leaves(spheres, cam, torch.float64)
    o, d = primary_rays(c, SIDE, SIDE)
    col = replay_paths(sph, o, d, idxs, events)
    g = (2.0 * colours.double() * weight).reshape(-1, 3)
    return torch.autograd.grad(col, [*sph, *c], g)


def _rel(a, ref):
    return [float((x.double() - y.double()).abs().max() / y.abs().max())
            for x, y in zip(a, ref)]


def test_well_conditioned_pixels_are_a_partial_set():
    """The mask is neither empty nor the whole image, and over the whole
    image the two backends' gradients are past the tolerances: the mask is
    what makes them comparable at depth 50."""
    share = float(_setup()[-1].mean())
    assert 0.2 < share < 0.9, share
    gaps = _rel(_engine_grads("xla", False), _engine_grads("pallas", False))
    assert any(g > tol for g, tol in zip(gaps, TOLS)), gaps


@pytest.mark.parametrize("backend", ["pallas", "xla", "xla_chunked_sorted"])
def test_backend_vs_float64_on_well_conditioned_pixels(backend):
    gaps = _rel(_engine_grads(backend, True), _float64_grads())
    assert all(g < tol for g, tol in zip(gaps, TOLS)), gaps


def test_backends_agree_on_well_conditioned_pixels():
    gaps = _rel(_engine_grads("xla", True), _engine_grads("pallas", True))
    assert all(g < tol for g, tol in zip(gaps, TOLS)), gaps


def test_xla_backward_is_the_autograd_of_the_replay():
    """One chunk, unsorted: the engine's VJP (replay by ray, then the
    camera's VJP of the ray cotangents) equals autograd through
    ``primary_rays`` and the replay in one graph, bit for bit."""
    spheres, cam, _, colours, idxs, events, _ = _setup()
    sph, c = _leaves(spheres, cam)
    o, d = primary_rays(c, SIDE, SIDE)
    col = replay_paths(sph, o, d, idxs, events)
    ref = torch.autograd.grad(col, [*sph, *c],
                              (2.0 * colours).reshape(-1, 3))
    for a, b in zip(_engine_grads("xla", False), ref):
        assert torch.equal(a, b)
