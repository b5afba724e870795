"""The golden ladder on the port: ``render(mode="pallas")`` (K1's plain
version on the CPU) against the native renderer's goldens.

Mirrors ``tests/test_golden.py:52,58,69,99`` with its tolerances: depth 2
near exact, the depth-4 and depth-8 ladder, rgbbox at full depth, each a
bounded share of mismatching pixels and a bounded mean channel delta (the
mirror cascades amplify f32 ulps chaotically past depth ~3).  The
float-space check compares colours before quantization with a float64 run
of the all-pairs tracer on the same discrete semantics.  Depth 1 and irreg
at full depth: ``tests/test_torch_megakernel.py``.
"""
import os

import numpy as np
import pytest
import torch

from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.geometry import Spheres, camera
from raytracers_tpu_torch.image import pixel_to_rgb, read_ppm
from raytracers_tpu_torch.render.api import (prepare_scene, render,
                                             render_float)
from raytracers_tpu_torch.render.bruteforce import make_closest_hit
from raytracers_tpu_torch.render.tracer import render_colours

torch.set_num_threads(2)
CPU = "cpu"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _render(name, side, depth):
    prep = prepare_scene(tscenes.by_name(name, device=CPU), side, side,
                         with_pallas=True, with_bvh=False, device=CPU)
    return render(prep, side, side, mode="pallas", max_depth=depth).numpy()


def _structural_match(img, fname, max_mismatch, max_mean_delta):
    ref = read_ppm(os.path.join(GOLDEN, fname))
    mismatch = (img != ref).mean()
    mean_delta = np.abs(pixel_to_rgb(img).astype(np.int32)
                        - pixel_to_rgb(ref).astype(np.int32)).mean()
    assert mismatch <= max_mismatch, (mismatch, max_mismatch)
    assert mean_delta <= max_mean_delta, (mean_delta, max_mean_delta)


def test_rgbbox_depth2_near_exact():
    _structural_match(_render("rgbbox", 200, 2), "rgbbox_200_d2.ppm",
                      max_mismatch=0.01, max_mean_delta=1.0)


@pytest.mark.parametrize("depth,max_mismatch,max_mean_delta",
                         [(4, 0.05, 2.0), (8, 0.13, 4.0)])
def test_rgbbox_depth_ladder_mid(depth, max_mismatch, max_mean_delta):
    _structural_match(_render("rgbbox", 200, depth),
                      f"rgbbox_200_d{depth}.ppm", max_mismatch,
                      max_mean_delta)


def test_rgbbox_full_depth_structural():
    _structural_match(_render("rgbbox", 200, 50), "rgbbox_200.ppm",
                      max_mismatch=0.15, max_mean_delta=6.0)


@pytest.mark.parametrize("tracer", ["brute", "pallas"])
def test_float_space_vs_oracle_depth4(tracer):
    """Float colours at depth 4, 64x64, of the all-pairs tracer (as
    tests/test_golden.py:69 takes them) and of K1's record mode, against
    the all-pairs tracer on float64 spheres and camera: float64 rays from
    float32 film coordinates, as JAX's tracer makes them
    (raytracers_tpu/render/tracer.py:37-40), whose square roots the port
    rounds to float32 (``vec.sqrt``): ulp-scale error away from the
    chaotic pixels."""
    sc = tscenes.rgbbox(device=CPU)
    cam = camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                 device=CPU)
    if tracer == "brute":
        cols = render_colours(make_closest_hit(sc.spheres, "precise"),
                              sc.spheres, cam, 64, 64, max_depth=4)
    else:
        prep = prepare_scene(sc, 64, 64, with_pallas=True, with_bvh=False,
                             device=CPU)
        cols = render_float(prep, 64, 64, mode="pallas", max_depth=4)
    sph64 = Spheres(*(t.double() for t in sc.spheres))
    cam64 = type(cam)(*(t.double() for t in cam))
    ref = render_colours(make_closest_hit(sph64, "precise"), sph64, cam64,
                         64, 64, max_depth=4)
    assert ref.dtype == torch.float64
    err = (cols.double() - ref).abs().numpy()
    assert np.median(err) < 1e-6
    assert (err > 1e-3).mean() < 0.02, (err > 1e-3).mean()
