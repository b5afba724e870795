"""The port's loader of the native C++ renderer (``raytracers_tpu_torch/
native.py``) and the CLI's ``--native``, against the goldens, the port and
the JAX package.

The loader builds ``native/raytracer.cpp`` with the system g++ into
``build/`` (never into ``native/``), with ``native/Makefile``'s flags plus
``-ffp-contract=off``; so built it reproduces the six ``tests/golden``
images bit for bit, and its depth-1 renders equal the port's at 200x200.
Mirrors ``tests/test_cli.py:44``, which skips where ``make -C native`` has
not run; here the library is built, so nothing skips.

At 1000x1000 depth 1 the port's K1 differs from the oracle on 13 rgbbox
and 4 irreg pixels.  Their rays, and only theirs, are recomputed: the two
renderers trace rays a few ulps apart (the oracle rounds its field of view
in float32 steps; K1 takes u = i * (1 / width)), and each pixel is a
grazing hit or a sky colour at a quantization step (``explain_depth1``).
"""
import os
import subprocess
import sys

os.environ.setdefault("OMP_NUM_THREADS", "2")   # the oracle's OpenMP loop

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from raytracers_tpu import camera as jcamera  # noqa: E402
from raytracers_tpu import scenes as jscenes  # noqa: E402
from raytracers_tpu.image import colour_to_pixel as jcolour_to_pixel  # noqa: E402
from raytracers_tpu.render.bruteforce import make_closest_hit as jclosest  # noqa: E402
from raytracers_tpu.render import tracer as jtracer  # noqa: E402
from raytracers_tpu_torch import native  # noqa: E402
from raytracers_tpu_torch import scenes as tscenes  # noqa: E402
from raytracers_tpu_torch.geometry import camera  # noqa: E402
from raytracers_tpu_torch.image import (image_to_ppm_bytes, pixel_to_rgb,  # noqa: E402
                                        read_ppm)
from raytracers_tpu_torch.render.api import prepare_scene, render  # noqa: E402
from raytracers_tpu_torch.render.megakernel import render_pallas  # noqa: E402

torch.set_num_threads(2)
CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
GOLDENS = [("rgbbox", 1, "rgbbox_200_d1.ppm"),
           ("rgbbox", 2, "rgbbox_200_d2.ppm"),
           ("rgbbox", 4, "rgbbox_200_d4.ppm"),
           ("rgbbox", 8, "rgbbox_200_d8.ppm"),
           ("rgbbox", 50, "rgbbox_200.ppm"),
           ("irreg", 50, "irreg_200.ppm")]


def _native(name, w, h, depth):
    sc = tscenes.by_name(name, device=CPU)
    return native.render(sc.spheres, sc.look_from, sc.look_at, sc.fov, w, h,
                         max_depth=depth)


def test_build_into_a_build_dir_and_reuse(tmp_path):
    """The library lands in the given build directory, named by the hash of
    source, compiler, flags and CPU; a second build reuses it; nothing is
    written into native/."""
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    lib = native.build(tmp_path / "build")
    assert lib.parent == tmp_path / "build" and lib.exists()
    assert lib.name.startswith("libraytracer_native_")
    assert "-ffp-contract=off" in native.CXXFLAGS
    assert "-ffast-math" not in native.CXXFLAGS
    mtime = lib.stat().st_mtime_ns
    assert native.build(tmp_path / "build") == lib
    assert lib.stat().st_mtime_ns == mtime
    assert [p.name for p in (tmp_path / "build").iterdir()] == [lib.name]
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before


def test_no_compiler_raises_naming_the_command(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "CXX", "no-such-compiler-here")
    with pytest.raises(native.NativeUnavailable,
                       match="no-such-compiler-here .*-ffp-contract=off"):
        native.build(tmp_path / "build")


@pytest.mark.parametrize("name,depth,fname", GOLDENS)
def test_goldens_bit_for_bit(name, depth, fname):
    np.testing.assert_array_equal(_native(name, 200, 200, depth),
                                  read_ppm(os.path.join(GOLDEN, fname)))


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_depth1_equals_the_port(name):
    sc = tscenes.by_name(name, device=CPU)
    prep = prepare_scene(sc, 200, 200, with_pallas=True, with_bvh=False,
                         device=CPU)
    img = render(prep, 200, 200, mode="pallas", max_depth=1)
    np.testing.assert_array_equal(_native(name, 200, 200, 1), img.numpy())


def test_bench_times_and_image():
    sc = tscenes.irreg(device=CPU)
    bvh_ms, render_ms, img = native.bench(sc.spheres, sc.look_from,
                                          sc.look_at, sc.fov, 40, 30,
                                          max_depth=5, runs=2)
    assert bvh_ms > 0 and render_ms > 0
    np.testing.assert_array_equal(img, _native("irreg", 40, 30, 5))
    assert "threads" in native.host_cpu()


def test_ppm_bytes_equals_the_port_writer():
    img = _native("rgbbox", 24, 16, 3)
    rgb = pixel_to_rgb(img).reshape(-1, 3)
    assert native.ppm_bytes(rgb, 16, 24) == image_to_ppm_bytes(img)
    assert native.ppm_bytes(torch.from_numpy(rgb), 16, 24) == \
        image_to_ppm_bytes(img)


def test_bad_inputs_raise_before_the_call():
    sc = tscenes.rgbbox(device=CPU)
    with pytest.raises(ValueError, match="spheres"):
        native.render(sc.spheres._replace(radius=sc.spheres.radius[:3]),
                      sc.look_from, sc.look_at, sc.fov, 8, 8)
    with pytest.raises(ValueError, match="positive"):
        native.render(sc.spheres, sc.look_from, sc.look_at, sc.fov, 0, 8)


def test_cli_native(tmp_path):
    """tests/test_cli.py:44 on the port: the reference's output lines, and
    the image of native.render."""
    out = tmp_path / "n.ppm"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-m", "raytracers_tpu_torch.cli", "--native", "-s",
         "irreg", "-m", "24", "-n", "24", "-r", "1", "-f", str(out)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "Using scene irreg (-s to switch)."
    assert lines[1] == "Timing over average of 1 runs (-r to change)."
    assert lines[2].startswith("Scene BVH construction in ")
    assert lines[3].startswith("Rendering in ")
    assert "host CPU" in r.stderr
    np.testing.assert_array_equal(read_ppm(str(out)),
                                  _native("irreg", 24, 24, 50))


# the pixels (row, col) where render(mode="pallas") at 1000x1000, depth 1,
# differs from the oracle, with the port's and the oracle's packed values
# and whether JAX's brute "precise" tracer agrees with the port
N1K = 1000
DEPTH1_PIXELS = {
    "rgbbox": [((8, 556), 0x0, 0xc8deff, False),
               ((10, 639), 0x0, 0xc8deff, True),
               ((44, 379), 0x0, 0xcae0ff, True),
               ((633, 260), 0x0, 0xf2f7ff, False),
               ((743, 457), 0xfafcff, 0x0, False),
               ((743, 543), 0x0, 0xfafcff, True),
               ((748, 324), 0xf8fbff, 0x0, True),
               ((794, 269), 0x0, 0xf8fbff, True),
               ((794, 731), 0x0, 0xf8fbff, True),
               ((956, 379), 0x0, 0xfefeff, True),
               ((959, 42), 0xf6faff, 0x0, True),
               ((981, 112), 0xf9fbff, 0x0, True),
               ((990, 639), 0x0, 0xfeffff, True)],
    "irreg": [((274, 247), 0xb0cfff, 0xafcfff, True),
              ((274, 753), 0xb0cfff, 0xafcfff, True),
              ((341, 10), 0xb7d4ff, 0xb6d4ff, True),
              ((341, 990), 0xb7d4ff, 0xb6d4ff, True)]}
KINDS = {"rgbbox": "grazing", "irreg": "quantization"}


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_depth1_pixels_at_1000_explained(name):
    """The rows of the listed pixels, rendered alone by the port's K1
    (``row0`` of a 1000-row image: the same rays as the whole render), differ
    from the oracle's 1000x1000 render exactly there, with the listed values;
    the classifier explains each; JAX's brute tracer, on those rays, agrees
    with the port where listed and with the oracle elsewhere."""
    pixels = DEPTH1_PIXELS[name]
    sc = tscenes.by_name(name, device=CPU)
    prep = prepare_scene(sc, N1K, N1K, with_pallas=True, with_bvh=False,
                         device=CPU)
    nat = _native(name, N1K, N1K, 1)
    port = np.zeros_like(nat)
    rows = sorted({j for (j, _), *_ in pixels})
    for j in rows:
        port[j] = render_pallas(prep.pallas, prep.cam, N1K, 1, max_depth=1,
                                row0=j, total_height=N1K).numpy()[0]
    diff = [tuple(p) for p in np.argwhere(port[rows] != nat[rows])]
    assert [(rows[r], c) for r, c in diff] == [p for p, *_ in pixels]
    for (j, i), want_port, want_native, _ in pixels:
        assert (port[j, i], nat[j, i]) == (want_port, want_native)

    found = native.explain_depth1(sc.spheres, prep.cam, N1K, N1K,
                                  [p for p, *_ in pixels], port, nat)
    assert [e["kind"] for e in found] == [KINDS[name]] * len(pixels), found

    jsc = jscenes.by_name(name)
    jcam = jcamera(jsc.look_from, jsc.look_at, (0., 1., 0.), jsc.fov, 1.0)
    o, d = jtracer.primary_rays(jcam, N1K, N1K)
    k = jnp.asarray([j * N1K + i for (j, i), *_ in pixels])
    col = jtracer.trace(jclosest(jsc.spheres, "precise"), jsc.spheres, o[k],
                        d[k], 1)
    got = np.asarray(jcolour_to_pixel(col))
    want = [p if as_port else n for _, p, n, as_port in pixels]
    np.testing.assert_array_equal(got, want)


def test_classifier_refuses_an_unexplained_pixel():
    """A pixel whose ray grazes nothing and whose colour is far from a
    quantization step is not explained."""
    sc = tscenes.rgbbox(device=CPU)
    cam = camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                 device=CPU)
    img = np.zeros((4, 4), np.int32)
    other = img.copy()
    other[0, 0] = 0x102030
    (e,) = native.explain_depth1(sc.spheres, cam, 4, 4, [(0, 0)], img, other)
    assert e["kind"] is None
