"""K3 of the port (its plain version on the CPU) against the JAX package's
per-ray traversal kernel.

The JAX side runs ``render_traversal(..., interpret=True)``: the JAX
package has no test of K3 of its own, so these are the first to hold it.
Each distinct JAX configuration compiles for 3-25 s, so the runs are few.
The tables equal JAX's; renders from the same tables (carried across by
``convert``) are bit-exact at depth 1.  Deeper, the two packages differ by
design in the last bits (XLA's CPU code contracts multiply-adds, and its
``rsqrt`` is not ``1/sqrt``; the port does IEEE float32 without
contraction, ROADMAP queue 3), so depth-50 images are held to the
structural tolerance of ``tests/test_render_bvh.py``.
"""
import numpy as np
import pytest
import torch

from raytracers_tpu import camera as jcamera
from raytracers_tpu import scenes as jscenes
from raytracers_tpu.render import pallas_traversal as jtr
from raytracers_tpu_torch import convert
from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.image import pixel_to_rgb
from raytracers_tpu_torch.render import api as tapi
from raytracers_tpu_torch.render import traversal as ttr
from raytracers_tpu_torch.utils.trace import counting

torch.set_num_threads(2)
CPU = "cpu"

_JAX_SCENES = {}


def _jax(name):
    """JAX's tables (built once per module: the eager build takes
    seconds) and the camera."""
    if name not in _JAX_SCENES:
        sc = jscenes.by_name(name)
        cam = jcamera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0)
        _JAX_SCENES[name] = (*jtr.build_traversal_scene(sc.spheres), cam)
    return _JAX_SCENES[name]


def _port(name):
    sc = tscenes.by_name(name, device=CPU)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device=CPU)
    return (*ttr.build_traversal_scene(sc.spheres), cam)


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_tables_equal_jax(name):
    scene, C, K, _ = _port(name)
    jscene, jC, jK, _ = _jax(name)
    assert (C, K) == (jC, jK) == {"rgbbox": (50, 8), "irreg": (127, 79)}[name]
    for field, a, b in zip(scene._fields, jscene, scene):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, field
        np.testing.assert_array_equal(a, b.numpy(), err_msg=field)
    assert scene.inner.shape == (8, 128) and scene.leaf_skip.shape == (1, 128)
    assert scene.spheres.shape == (K, 8, 128)


def test_too_many_clusters():
    sph = tscenes.random_spheres(129 * 8, seed=1, device=CPU)
    with pytest.raises(ValueError, match="129 clusters > 128"):
        ttr.build_traversal_scene(sph, leaf_size=8)
    # the default leaf size grows with the scene instead
    _, C, K = ttr.build_traversal_scene(sph)
    assert (C, K) == (115, 9)


# (scene, side, depth, block, far_root): scanline and block maps, far_root
# on and off, each JAX configuration compiled once
RUNS = [("rgbbox", 24, 1, None, True), ("rgbbox", 24, 1, (32, 16), False),
        ("rgbbox", 24, 50, (32, 16), True), ("irreg", 16, 1, (32, 16), True),
        ("irreg", 16, 1, None, False), ("irreg", 16, 50, (32, 16), True)]
# test_render_bvh.py:28-38: rgbbox's mirror cascades, irreg's few
DEEP_TOL = {"rgbbox": (0.12, 5.0), "irreg": (0.02, 0.5)}


@pytest.mark.parametrize("name,side,depth,block,far_root", RUNS)
def test_plain_version_vs_jax_kernel(name, side, depth, block, far_root):
    """The port's plain K3 on JAX's own tables against the JAX kernel
    in interpret mode; the port's tables render the same image."""
    jscene, C, K, jcam = _jax(name)
    want = np.asarray(jtr.render_traversal(
        jscene, C, K, jcam, side, side, max_depth=depth, far_root=far_root,
        block=block, interpret=True))
    cam = convert.camera(jcam, CPU)
    kw = dict(max_depth=depth, far_root=far_root, block=block)
    img, stats = ttr.traversal_reference(convert.traversal_scene(jscene, CPU),
                                         C, K, cam, side, side,
                                         with_stats=True, **kw)
    assert img.dtype == torch.int32 and img.shape == (side, side)
    own = ttr.traversal_reference(_port(name)[0], C, K, cam, side, side, **kw)
    assert torch.equal(img, own)
    # every ray runs at least its first bounce and tests nodes and slots
    n_rays = (-(-side // 16) * 16) * (-(-side // 32) * 32) if block else \
        -(-side * side // 512) * 512
    assert stats["rays"] == n_rays and stats["ray_bounces"] >= n_rays
    assert stats["node_steps"] >= n_rays and stats["slot_tests"] >= K
    assert 0 < stats["slot_roots"] < stats["slot_tests"]
    assert stats["far_roots"] <= stats["slot_roots"]
    assert (stats["far_roots"] > 0) == far_root
    assert stats["sky_bounces"] <= n_rays
    if depth == 1:
        np.testing.assert_array_equal(img.numpy(), want)
        return
    mismatch = (img.numpy() != want).mean()
    delta = np.abs(pixel_to_rgb(img).astype(np.int32)
                   - pixel_to_rgb(want).astype(np.int32)).mean()
    max_mismatch, max_delta = DEEP_TOL[name]
    assert mismatch <= max_mismatch and delta <= max_delta, (mismatch, delta)


@pytest.mark.parametrize("name,side", [("rgbbox", 48), ("irreg", 24)])
def test_depth1_equals_brute(name, side):
    """At depth 1 the walk finds the all-pairs winner's hit or miss on every
    ray, so K3's image equals the brute render's."""
    scene, C, K, cam = _port(name)
    for block in (None, (32, 16)):
        img = ttr.traversal_reference(scene, C, K, cam, side, side,
                                      max_depth=1, block=block)
        prep = tapi.prepare_scene(tscenes.by_name(name, device=CPU), side,
                                  side, with_bvh=False, device=CPU)
        assert torch.equal(img, tapi.render(prep, side, side, mode="brute",
                                            max_depth=1))


def test_wrapper_takes_plain_version_on_cpu():
    """``render_traversal`` on CPU tensors runs the plain version (the
    launch count stays put); scanline and block maps give one image; the
    arguments are checked."""
    scene, C, K, cam = _port("rgbbox")
    with counting() as c:
        a = ttr.render_traversal(scene, C, K, cam, 40, 40, max_depth=6)
        b = ttr.render_traversal(scene, C, K, cam, 40, 40, max_depth=6,
                                 block=None)
    assert torch.equal(a, b) and torch.equal(
        a, ttr.traversal_reference(scene, C, K, cam, 40, 40, max_depth=6))
    assert "k3.launches" not in c.read()
    with pytest.raises(ValueError, match="does not cover"):
        ttr.render_traversal(scene, C, K, cam, 8, 8, tile=256)
    with pytest.raises(ValueError, match="spheres"):
        ttr.render_traversal(scene, C, K + 1, cam, 8, 8)


f32 = np.float32


def _nan_max(a, b):
    return f32(np.nan) if (a != a or b != b) else max(a, b)


def _nan_min(a, b):
    return f32(np.nan) if (a != a or b != b) else min(a, b)


def _scalar_ray(inner, leaf_skip, spheres, C, K, o, d, max_depth, far_root):
    """One ray as ``csrc/traversal.cu`` runs it, in float32 scalars: the
    slots of a leaf tested in order, each in (eps, the running best).
    Returns its packed pixel and its counters."""
    eps, big, t_min, one = f32(0.1), f32(1e9), f32(0.0), f32(1.0)
    n = dict.fromkeys(ttr.STATS, 0)
    (ox, oy, oz), (dx, dy, dz) = o, d
    light, res = [one] * 3, [f32(0.0)] * 3
    for _ in range(max_depth):
        n["ray_bounces"] += 1
        a = (dx * dx + dy * dy) + dz * dz
        inv_a = one / a
        org, inv = (ox, oy, oz), (one / dx, one / dy, one / dz)
        best_t, best, cur = big, None, 0
        for _ in range(2 * C - 1):
            if cur < 0:
                break
            if cur < C - 1:
                n["node_steps"] += 1
                lo, hi, ok = t_min, best_t, True
                for k in range(3):
                    t0 = (inner[k, cur] - org[k]) * inv[k]
                    t1 = (inner[3 + k, cur] - org[k]) * inv[k]
                    near, far = (t1, t0) if inv[k] < 0 else (t0, t1)
                    lo, hi = _nan_max(near, lo), _nan_min(far, hi)
                    ok = ok and not hi <= lo
                cur = int(inner[6 if ok else 7, cur])
                continue
            c = cur - (C - 1)
            for k in range(K):
                n["slot_tests"] += 1
                cx, cy, cz, r = spheres[k, :4, c]
                ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
                b = (ocx * dx + ocy * dy) + ocz * dz
                cc = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r * r
                disc = b * b - a * cc
                if not disc > 0:
                    continue
                n["slot_roots"] += 1
                sq = np.sqrt(disc)
                t = (-b - sq) * inv_a
                if not (t < best_t and t > eps):
                    t = big
                    if far_root:
                        n["far_roots"] += 1
                        t1 = (-b + sq) * inv_a
                        if t1 < best_t and t1 > eps:
                            t = t1
                if t < best_t:
                    best_t, best = t, (k, c)
            cur = int(leaf_skip[0, c])
        if best is None:
            n["sky_bounces"] += 1
            ts = f32(0.5) * (dy * (one / np.sqrt(a)) + one)
            res = [li * ((one - ts) + ts * f32(k))
                   for li, k in zip(light, (0.5, 0.7, 1.0))]
            break
        sx, sy, sz, sr, *col = spheres[best[0], :7, best[1]]
        ocx, ocy, ocz = ox - sx, oy - sy, oz - sz
        b = (ocx * dx + ocy * dy) + ocz * dz
        cc = ((ocx * ocx + ocy * ocy) + ocz * ocz) - sr * sr
        disc = b * b - a * cc
        sq = np.sqrt(disc if disc > 0 else one)
        t0, t1 = (-b - sq) * inv_a, (-b + sq) * inv_a
        t2 = t0 if (t0 < best_t + one and t0 > t_min) else t1
        px, py, pz = ox + t2 * dx, oy + t2 * dy, oz + t2 * dz
        inv_r = one / sr
        nx, ny, nz = (px - sx) * inv_r, (py - sy) * inv_r, (pz - sz) * inv_r
        inv_dn = one / np.sqrt(a)
        ux, uy, uz = dx * inv_dn, dy * inv_dn, dz * inv_dn
        two_udn = f32(2.0) * ((ux * nx + uy * ny) + uz * nz)
        rx, ry, rz = ux - two_udn * nx, uy - two_udn * ny, uz - two_udn * nz
        if not ((rx * nx + ry * ny) + rz * nz) > 0:
            break
        light = [li * ci for li, ci in zip(light, col)]
        ox, oy, oz, dx, dy, dz = px, py, pz, rx, ry, rz
    q = [int(f32(255.99) * x) for x in res]
    return (q[0] << 16) | (q[1] << 8) | q[2], n


@pytest.mark.parametrize("name,far_root", [("rgbbox", True),
                                           ("rgbbox", False),
                                           ("irreg", True)])
def test_counters_match_scalar_replay(name, far_root):
    """The plain version's pixels and per-ray counters equal a scalar
    replay of the kernel's loop, which tests a leaf's slots one by one in
    the running window: the counters that K3's bound is made of count what
    the kernel runs."""
    from raytracers_tpu_torch.render.megakernel import _gen_rays, _ray_order
    scene, C, K, cam = _port(name)
    depth = 4
    ro = _ray_order(cam, 8, 8, 64, None, 0.0, None, depth)
    packed, stats = ttr.traversal_kernel_reference(
        scene, ro.params, ro.n_rays, 64, n_clusters=C, leaf_size=K,
        max_depth=depth, far_root=far_root)
    S = _gen_rays(ro.params, ro.n_rays, 64, False).numpy()
    tables = [t.numpy() for t in scene[:3]]
    for g in range(ro.n_rays):
        with np.errstate(divide="ignore", invalid="ignore"):   # 1/0 = inf
            pix, n = _scalar_ray(*tables, C, K, S[0:3, g], S[3:6, g],
                                 depth, far_root)
        assert pix == int(packed[g]), g
        assert [n[k] for k in ttr.STATS] == stats[:, g].tolist(), g
