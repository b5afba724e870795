"""The port's foundations against the JAX package: vec, geometry, scenes,
image and Morton codes, array for array; and the port's import rules."""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracers_tpu import geometry as jgeo
from raytracers_tpu import image as jimage
from raytracers_tpu import scenes as jscenes
from raytracers_tpu import vec as jvec
from raytracers_tpu.bvh import morton as jmorton
from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import image as timage
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch import vec as tvec
from raytracers_tpu_torch.bvh import morton as tmorton

torch.set_num_threads(2)
CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _rand(shape, seed, lo=-10.0, hi=10.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def test_vec_ops_equal():
    a, b = _rand((1000, 3), 0), _rand((1000, 3), 1)
    _eq(tvec.dot(_t(a), _t(b)), jvec.dot(a, b))
    _eq(tvec.cross(_t(a), _t(b)), jvec.cross(a, b))
    _eq(tvec.norm(_t(a)), jvec.norm(a))
    _eq(tvec.normalise(_t(a)), jvec.normalise(a))
    _eq(tvec.centre(tvec.Aabb(_t(a), _t(b))), jvec.centre(jvec.Aabb(a, b)))


def test_sqrt_correctly_rounded():
    x = np.abs(_rand(100_000, 2, 0.0, 1e6))
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    _eq(tvec.sqrt(_t(x)), want)
    _eq(jnp.sqrt(x), want)


def test_sphere_hit_t_equal():
    o, d = _rand((4000, 3), 3), _rand((4000, 3), 4)
    c, r = _rand((4000, 3), 5, -3, 3), np.abs(_rand(4000, 6, 0.1, 4))
    for tmin, tmax in ((tgeo.SCENE_EPSILON, tgeo.T_MAX), (0.0, 2.5)):
        _eq(tgeo.sphere_hit_t(_t(o), _t(d), _t(c), _t(r), tmin, tmax),
            jgeo.sphere_hit_t(o, d, c, r, tmin, tmax))


def test_aabb_hit_equal_with_nan_polarity():
    lo = _rand((2000, 3), 7, -5, 0)
    hi = lo + np.abs(_rand((2000, 3), 8, 0.1, 5))
    o, d = _rand((2000, 3), 9), _rand((2000, 3), 10)
    # axis-parallel rays with their origin on a slab plane: 0 * inf = NaN
    # stages, which the fail-if polarity reports as hits
    d[:200, 0] = 0.0
    o[:200, 0] = lo[:200, 0]
    d[200:400, 1] = 0.0
    o[200:400, 1] = hi[200:400, 1]
    port = tgeo.aabb_hit(tvec.Aabb(_t(lo), _t(hi)), _t(o), _t(d), 0.0, 1e9)
    ref = jgeo.aabb_hit(jvec.Aabb(lo, hi), o, d, 0.0, 1e9)
    _eq(port, ref)
    assert bool(port[:400].any())


@pytest.mark.parametrize("fov,aspect", [(75.0, 1.0), (75.0, 1.5),
                                        (80.0, 1.0)])
def test_camera_equal(fov, aspect):
    args = ((0.0, 30.0, 30.0), (0.0, -1.0, -1.0), (0.0, 1.0, 0.0), fov,
            aspect)
    port = tgeo.camera(*args, device=CPU)
    ref = jgeo.camera(*args)
    for p, r in zip(port, ref):
        _eq(p, r)


def test_rays_reflect_sky_equal():
    cam = jgeo.camera((0.0, 12.0, 30.0), (0.0, 10.0, -1.0), (0.0, 1.0, 0.0),
                      75.0, 1.0)
    tcam = tgeo.Camera(*(_t(f) for f in cam))
    s, t = _rand(500, 11, 0, 1), _rand(500, 12, 0, 1)
    for p, r in zip(tgeo.get_ray(tcam, _t(s), _t(t)),
                    jgeo.get_ray(cam, s, t)):
        _eq(p, r)
    v, n = _rand((500, 3), 13), _rand((500, 3), 14)
    _eq(tgeo.reflect(_t(v), _t(n)), jgeo.reflect(v, n))
    _eq(tgeo.sky_colour(_t(v)), jgeo.sky_colour(v))


@pytest.mark.parametrize("name", ["rgbbox", "irreg", "plane", "random"])
def test_scenes_equal(name):
    if name == "random":
        port = tscenes.random_spheres(5000, seed=3, device=CPU)
        ref = jscenes.random_spheres(5000, seed=3)
    else:
        kw = {"n_side": 120} if name == "plane" else {}
        tsc = getattr(tscenes, name)(device=CPU, **kw)
        jsc = getattr(jscenes, name)(**kw)
        assert (tsc.look_from, tsc.look_at, tsc.fov) == (
            jsc.look_from, jsc.look_at, jsc.fov)
        port, ref = tsc.spheres, jsc.spheres
    for p, r in zip(port, ref):
        _eq(p, r)


def test_image_pack_and_ppm_round_trip(tmp_path):
    c = _rand((64, 48, 3), 15, 0.0, 1.0)
    c[0, 0] = [1.0, 0.0, 1.0]
    img = timage.colour_to_pixel(_t(c))
    _eq(img, jimage.colour_to_pixel(c))
    _eq(timage.pixel_to_rgb(img), jimage.pixel_to_rgb(np.asarray(img)))
    path = str(tmp_path / "a.ppm")
    timage.write_ppm(path, img)
    _eq(jimage.read_ppm(path), img)
    _eq(timage.read_ppm(path), img)
    assert timage.image_to_ppm_bytes(img) == jimage.image_to_ppm_bytes(
        np.asarray(img))


def test_morton_codes_equal():
    centres = [np.asarray(jscenes.irreg().spheres.center),
               _rand((3000, 3), 16, -50, 50)]
    # duplicate codes: points far closer than one 1024^3 cell
    dup = _rand((1000, 3), 17, -1, 1) * 1e-4 + np.float32([3.0, -2.0, 5.0])
    centres.append(np.concatenate([centres[1][:500], dup]))
    for c in centres:
        port = tmorton.morton_codes(_t(c))
        ref = jmorton.morton_codes(c)
        _eq(port, np.asarray(ref).astype(np.int64))
    assert len(np.unique(np.asarray(port))) < len(port)


def _port_sources():
    root = os.path.join(REPO, "raytracers_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(name):
    return any(name == m or name.startswith(m + ".")
               for m in ("jax", "raytracers_tpu"))


def test_port_sources_import_no_jax():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad, bad


def test_no_jax_checks_cover_the_probes():
    """The two checks above walk every module of the port: the probes
    (``probes/``, the counterparts of tools/microbench_tpu.py,
    microbench_v5.py and microbench_mxuquad.py) among them."""
    import pkgutil
    import raytracers_tpu_torch as p
    srcs = {os.path.relpath(f, REPO) for f in _port_sources()}
    mods = ("microbench", "microbench_v5", "microbench_mxuquad")
    assert {os.path.join("raytracers_tpu_torch", "probes", f)
            for f in ("__init__.py",) + tuple(m + ".py" for m in mods)} <= srcs
    walked = {m.name for m in pkgutil.walk_packages(p.__path__,
                                                    p.__name__ + ".")}
    assert {f"raytracers_tpu_torch.probes.{m}" for m in mods} <= walked


def test_port_imports_without_jax_subprocess():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['raytracers_tpu'] = None\n"
        "import raytracers_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       (m.split('.')[0] in ('jax', 'jaxlib', 'raytracers_tpu'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_raises_without_cuda(monkeypatch):
    from raytracers_tpu_torch.render.api import prepare_scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tscenes.rgbbox()
    with pytest.raises(RuntimeError, match="CUDA"):
        tgeo.camera((0, 0, 1), (0, 0, 0), (0, 1, 0), 75.0, 1.0)
    sc = tscenes.rgbbox(device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_scene(sc, 8, 8, with_pallas=True, with_bvh=False)
