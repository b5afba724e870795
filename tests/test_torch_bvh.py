"""The port's BVH path against the JAX package's: the Karras radix tree,
the LBVH build, the skip-link walk, ``render(mode="bvh")``, validation,
npz checkpoints and the CLI.

Mirrors ``tests/test_radix_tree.py``, ``tests/test_lbvh.py``,
``tests/test_render_bvh.py``, ``tests/test_utils.py`` and
``tests/test_cli.py`` on the port, and holds every tree and ``Bvh`` field
equal to JAX's.  The walk's hits are held to ``test_lbvh.py``'s tolerances
(XLA fuses multiply-adds in its graph, the port does not), full-depth
images to ``test_render_bvh.py``'s structural ones; depth 1 is bit-exact.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracers_tpu import scenes as jscenes
from raytracers_tpu.bvh import lbvh as jlbvh
from raytracers_tpu.bvh import radix_tree as jrt
from raytracers_tpu.bvh.traverse import closest_hit_bvh as jclosest
from raytracers_tpu.geometry import Spheres as JSpheres
from raytracers_tpu.render import api as japi
from raytracers_tpu.utils import checkpoint as jckpt
from raytracers_tpu_torch import convert
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.bvh import lbvh as tlbvh
from raytracers_tpu_torch.bvh import radix_tree as trt
from raytracers_tpu_torch.bvh.traverse import closest_hit_bvh
from raytracers_tpu_torch.geometry import Spheres, sphere_aabb
from raytracers_tpu_torch.image import colour_to_pixel, pixel_to_rgb, read_ppm
from raytracers_tpu_torch.render import api as tapi
from raytracers_tpu_torch.render.bruteforce import closest_hit_precise
from raytracers_tpu_torch.utils import checkpoint as tckpt
from raytracers_tpu_torch.utils.validate import validate_bvh, validate_spheres

torch.set_num_threads(2)
CPU = "cpu"
REPO = os.path.join(os.path.dirname(__file__), os.pardir)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

_jax_build = jax.jit(jlbvh.build_bvh, static_argnums=1)
_jax_tree = jax.jit(jrt.build_radix_tree)


def _codes(c):
    return torch.from_numpy(np.asarray(c, np.uint32).astype(np.int64))


def _assert_fields_equal(want, got, what=""):
    """Every field of a JAX NamedTuple equal to the port's, values and
    integer/float kind."""
    for name, a, b in zip(want._fields, want, got):
        if isinstance(a, tuple):
            _assert_fields_equal(a, b, f"{what}{name}.")
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype, (what + name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what + name)


# ---------------------------------------------------------------------------
# the radix tree (tests/test_radix_tree.py)


def _walk(tree):
    """Leaves below the root, in order; asserts parent consistency."""
    n_inner = tree.n_inner
    left, right = tree.left.tolist(), tree.right.tolist()
    parent, leaf_parent = tree.parent.tolist(), tree.leaf_parent.tolist()
    out = []

    def below(node, depth):
        assert depth < n_inner + 2, "cycle detected"
        for child in (left[node], right[node]):
            if child >= n_inner:
                assert leaf_parent[child - n_inner] == node
                out.append(child - n_inner)
            else:
                assert parent[child] == node
                below(child, depth + 1)

    below(0, 0)
    return out


def _check(codes):
    tree = trt.build_radix_tree(_codes(codes))
    leaves = _walk(tree)
    assert leaves == list(range(len(codes)))
    assert int(tree.parent[0]) == -1
    return tree


_RNG = np.random.default_rng(11)
TREE_CASES = {
    **{f"random{n}": np.sort(_RNG.integers(0, 2**32, size=n, dtype=np.uint32))
       for n in (2, 3, 4, 5, 7, 17, 64, 100, 257, 1000)},
    "karras8": np.array([0b00001, 0b00010, 0b00100, 0b00101, 0b10011,
                         0b11000, 0b11001, 0b11110], np.uint32),
    **{f"dup{n}": np.full(n, 12345, np.uint32) for n in (2, 3, 8, 17, 33)},
    "mixed": np.sort(np.array([5, 5, 5, 9, 9, 100, 100, 100, 100, 2**31],
                              np.uint32)),
    "chain": np.array([1 << i for i in range(30)], np.uint32),
    "few_codes": np.sort(_RNG.integers(0, 4, size=333, dtype=np.uint32)),
    "top_bit": np.array([0, 2**31, 2**32 - 1], np.uint32),
}


@pytest.mark.parametrize("name", sorted(TREE_CASES))
def test_radix_tree_equals_jax(name):
    """Both builds of the port give JAX's tree, field for field: sorted,
    duplicate-heavy and chain codes."""
    codes = TREE_CASES[name]
    want = _jax_tree(jnp.asarray(codes))
    _assert_fields_equal(want, _check(codes))
    _assert_fields_equal(want, trt.build_radix_tree_searches(_codes(codes)))


def test_two_leaves():
    t = _check([3, 7])
    assert int(t.left[0]) == 1 and int(t.right[0]) == 2


def test_adversarial_skewed_depths():
    tree = _check(TREE_CASES["chain"])
    depths, max_depth = trt.node_depths(tree)
    assert int(max_depth) == 28
    want, want_max = jrt.node_depths(_jax_tree(jnp.asarray(
        TREE_CASES["chain"])))
    np.testing.assert_array_equal(depths.numpy(), np.asarray(want))
    assert int(want_max) == int(max_depth)


def test_node_depths_balanced():
    depths, max_depth = trt.node_depths(
        trt.build_radix_tree(_codes(np.arange(64))))
    assert int(max_depth) == 5 and int(depths[0]) == 0
    _, max_depth = trt.node_depths(
        trt.build_radix_tree(_codes(np.full(256, 7))))
    assert int(max_depth) <= 8


def test_clz32_exact_at_powers_of_two():
    """No float log2: exact next to every power of two."""
    x = torch.tensor(sorted({v for k in range(33) for v in
                             ((1 << k) - 1, 1 << k, (1 << k) + 1)
                             if 0 <= v < 2**32}), dtype=torch.int64)
    want = np.array([32 - int(v).bit_length() for v in x.tolist()])
    np.testing.assert_array_equal(trt.clz32(x).numpy(), want)
    np.testing.assert_array_equal(
        trt.floor_log2(x[x > 0]).numpy(),
        [int(v).bit_length() - 1 for v in x[x > 0].tolist()])


# ---------------------------------------------------------------------------
# the LBVH build (tests/test_lbvh.py)


def _random_np(n, seed=0, dup_of=None):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    if dup_of is not None:
        # many spheres on a few centres: duplicate Morton codes
        c = c[rng.integers(0, dup_of, n)]
    return (c, rng.uniform(0.5, 4.0, (n,)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _chain_np():
    """Centres at 2^i along x: a maximally skewed (chain) tree."""
    x = np.float32(2.0) ** np.arange(11, dtype=np.float32)
    c = np.stack([x, np.zeros_like(x), np.zeros_like(x)], 1)
    c = np.concatenate([c, c[::-1] + np.float32(0.5)])
    n = c.shape[0]
    return (c.astype(np.float32), np.full(n, 0.25, np.float32),
            np.full((n, 3), 0.5, np.float32))


SOUPS = {"random": lambda: _random_np(333),
         "duplicates": lambda: _random_np(200, seed=3, dup_of=9),
         "chain": _chain_np}


def _both(name):
    """A scene's or soup's spheres for JAX and the port."""
    if name in SOUPS:
        arrays = SOUPS[name]()
        return (JSpheres(*map(jnp.asarray, arrays)),
                Spheres(*(torch.from_numpy(a) for a in arrays)))
    return (jscenes.by_name(name).spheres,
            tscenes.by_name(name, device=CPU).spheres)


@pytest.mark.parametrize("leaf_size", [1, 4, 8, 16, 128])
@pytest.mark.parametrize("name", ["rgbbox", "irreg", "random", "duplicates",
                                  "chain"])
def test_bvh_fields_equal_jax(name, leaf_size):
    jsph, tsph = _both(name)
    _assert_fields_equal(_jax_build(jsph, leaf_size),
                         tlbvh.build_bvh(tsph, leaf_size=leaf_size))


@pytest.mark.parametrize("leaf_size", [1, 4, 16])
def test_aabb_containment(leaf_size):
    bvh = tlbvh.build_bvh(_both("random")[1], leaf_size=leaf_size)
    sb = sphere_aabb(bvh.spheres)
    C, K = bvh.n_leaves, bvh.leaf_size
    assert (sb.min.reshape(C, K, 3) >= bvh.leaf_min[:, None] - 1e-5).all()
    assert (sb.max.reshape(C, K, 3) <= bvh.leaf_max[:, None] + 1e-5).all()
    ext_min = torch.cat([bvh.node_min, bvh.leaf_min])
    ext_max = torch.cat([bvh.node_max, bvh.leaf_max])
    left, right = bvh.left.long(), bvh.right.long()
    assert torch.equal(bvh.node_min,
                       torch.minimum(ext_min[left], ext_min[right]))
    assert torch.equal(bvh.node_max,
                       torch.maximum(ext_max[left], ext_max[right]))


def test_order_is_permutation_and_padding():
    bvh = tlbvh.build_bvh(Spheres(*(torch.from_numpy(a) for a in
                                    _random_np(100))), leaf_size=8)
    order = bvh.order
    assert sorted(order[order >= 0].tolist()) == list(range(100))
    assert (bvh.spheres.radius[order < 0] == 0).all()
    assert bvh.n_leaves == 13 and bvh.leaf_size == 8


def test_skip_links_form_full_traversal():
    bvh = tlbvh.build_bvh(Spheres(*(torch.from_numpy(a) for a in
                                    _random_np(57))), leaf_size=4)
    left, skip = bvh.left.tolist(), bvh.skip.tolist()
    cur, visited = 0, []
    while cur != -1:
        visited.append(cur)
        cur = left[cur] if cur < bvh.n_inner else skip[cur]
        assert len(visited) <= 4 * 2 * bvh.n_leaves, "skip links loop"
    assert sorted(visited) == list(range(2 * bvh.n_leaves - 1))


@pytest.mark.parametrize("name", sorted(TREE_CASES))
def test_rmq_refit_and_skip_links_match_sweeps(name):
    """The RMQ refit and the closed-form skip links equal the levelwise
    sweeps exactly (JAX's equal the port's through the ``Bvh`` fields)."""
    codes = TREE_CASES[name]
    n = len(codes)
    tree = trt.build_radix_tree(_codes(codes))
    rng = np.random.default_rng(5)
    lo = rng.standard_normal((n, 3)).astype(np.float32)
    hi = lo + rng.random((n, 3)).astype(np.float32)
    leaf_min, leaf_max = torch.from_numpy(lo), torch.from_numpy(hi)
    _, max_depth = trt.node_depths(tree)
    a = tlbvh._refit(tree, leaf_min, leaf_max, int(max_depth) + 1)
    b = tlbvh._refit_rmq(tree.first, tree.last, leaf_min, leaf_max)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    skip = tlbvh._skip_links_rmq(tree)
    assert torch.equal(tlbvh._skip_links(tree, int(max_depth) + 2), skip)


@pytest.mark.parametrize("name,leaf_size",
                         [("rgbbox", 128), ("irreg", 128), ("irreg", 32)])
def test_clusters_match_bvh_fields(name, leaf_size):
    sph = _both(name)[1]
    full = tlbvh.build_bvh(sph, leaf_size=leaf_size)
    fast = tlbvh.build_clusters(sph, leaf_size=leaf_size)
    for f in ("order", "leaf_min", "leaf_max"):
        assert torch.equal(getattr(fast, f), getattr(full, f)), f
    for a, b in zip(fast.spheres, full.spheres):
        assert torch.equal(a, b)


def test_build_needs_two_spheres():
    one = Spheres(torch.zeros(1, 3), torch.ones(1), torch.ones(1, 3))
    with pytest.raises(ValueError, match="at least 2"):
        tlbvh.build_bvh(one, leaf_size=8)


# ---------------------------------------------------------------------------
# the skip-link walk (tests/test_lbvh.py)


def _assert_hits_equivalent(bi, bt, ti, tt, max_disagree=0.0):
    """test_lbvh.py:83-98: index agreement on >= 1 - max_disagree of the
    rays, t within 1e-4 where the indices agree, both inf on a miss."""
    bi, bt, ti, tt = (np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                                 else x) for x in (bi, bt, ti, tt))
    disagree = (bi != ti).mean()
    assert disagree <= max_disagree, (disagree, max_disagree)
    same = bi == ti
    hit = same & (bi >= 0)
    np.testing.assert_allclose(bt[hit], tt[hit], rtol=1e-4)
    miss = same & (bi < 0)
    assert np.isinf(bt[miss]).all() and np.isinf(tt[miss]).all()


def _random_rays(r, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-60, 60, (r, 3)).astype(np.float32),
            rng.normal(size=(r, 3)).astype(np.float32))


def _scene_rays(name, r=256):
    sc = jscenes.by_name(name)
    rng = np.random.default_rng(7)
    o = np.float32(sc.look_from)[None, :].repeat(r, 0)
    d = (np.float32(sc.look_at)[None, :] - np.float32(sc.look_from)[None, :]
         + rng.normal(scale=20.0, size=(r, 3)).astype(np.float32))
    return o, d.astype(np.float32)


@pytest.mark.parametrize("name,leaf_size", [("random", 1), ("random", 4),
                                            ("random", 16), ("rgbbox", 4),
                                            ("irreg", 4)])
def test_walk_matches_jax_and_bruteforce(name, leaf_size):
    jsph, tsph = _both(name)
    o, d = _random_rays(512) if name == "random" else _scene_rays(name)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    bvh = tlbvh.build_bvh(tsph, leaf_size=leaf_size)
    ti, tt = closest_hit_bvh(bvh, to, td)
    assert ti.dtype == torch.int64 and tt.dtype == torch.float32
    bi, bt = closest_hit_precise(tsph, to, td)
    _assert_hits_equivalent(bi, bt, ti, tt, max_disagree=0.005)
    ji, jt = jclosest(_jax_build(jsph, leaf_size), jnp.asarray(o),
                      jnp.asarray(d))
    _assert_hits_equivalent(ji, jt, ti, tt, max_disagree=0.005)


def test_duplicate_position_spheres():
    sph = Spheres(torch.zeros(33, 3), torch.full((33,), 0.5),
                  torch.ones(33, 3))
    bvh = tlbvh.build_bvh(sph, leaf_size=4)
    _, t = closest_hit_bvh(bvh, torch.tensor([[0., 0., -10.]] * 4),
                           torch.tensor([[0., 0., 1.]] * 4))
    np.testing.assert_allclose(t.numpy(), 9.5, rtol=1e-5)


def test_walk_on_jax_tree_equals_walk_on_port_tree():
    """JAX's tree through ``convert`` gives the port's walk the same hits
    as the port's own tree (the two trees are equal)."""
    jsph, tsph = _both("irreg")
    o, d = (torch.from_numpy(x) for x in _scene_rays("irreg"))
    a = closest_hit_bvh(tlbvh.build_bvh(tsph, leaf_size=8), o, d)
    b = closest_hit_bvh(convert.bvh(_jax_build(jsph, 8), CPU), o, d)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# render(mode="bvh") (tests/test_render_bvh.py)


def _structural_match(img, ref, max_mismatch, max_mean_delta):
    img, ref = np.asarray(img), np.asarray(ref)
    a = pixel_to_rgb(img).astype(np.int32)
    b = pixel_to_rgb(ref).astype(np.int32)
    mismatch = (img != ref).mean()
    delta = np.abs(a - b).mean()
    assert mismatch <= max_mismatch, (mismatch, max_mismatch)
    assert delta <= max_mean_delta, (delta, max_mean_delta)


# test_render_bvh.py's tolerances: rgbbox's mirror cascades, irreg's few
BVH_TOL = {"rgbbox": (0.12, 5.0), "irreg": (0.02, 0.5)}


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_bvh_render_vs_jax(name):
    """The JAX defaults (``with_bvh=True``, leaf 8) through ``render``:
    the tree equals JAX's; the image is JAX's within the structural
    tolerance (XLA's contraction moves deep rays by ulps), bit-exact at
    depth 1; ``render_float`` agrees with ``render``."""
    size = 64
    port = tapi.prepare_scene(tscenes.by_name(name, device=CPU), size, size,
                              device=CPU)
    ref = japi.prepare_scene(jscenes.by_name(name), size, size)
    assert port.pallas is None and port.bvh.leaf_size == 8
    _assert_fields_equal(ref.bvh, port.bvh)
    img = tapi.render(port, size, size, mode="bvh", chunk=1024)
    assert img.dtype == torch.int32 and img.shape == (size, size)
    want = np.asarray(japi.render(ref, size, size, mode="bvh", chunk=1024))
    _structural_match(img.numpy(), want, *BVH_TOL[name])
    d1 = tapi.render(port, size, size, mode="bvh", max_depth=1)
    np.testing.assert_array_equal(
        d1.numpy(), np.asarray(japi.render(ref, size, size, mode="bvh",
                                           max_depth=1)))
    col = tapi.render_float(port, size, size, mode="bvh", max_depth=1)
    assert col.shape == (size, size, 3) and col.dtype == torch.float32
    assert torch.equal(colour_to_pixel(col), d1)


@pytest.mark.parametrize("leaf_size", [1, 8])
def test_bvh_render_matches_bruteforce_rgbbox(leaf_size):
    size = 32
    prep = tapi.prepare_scene(tscenes.rgbbox(device=CPU), size, size,
                              leaf_size=leaf_size, device=CPU)
    bvh_img = tapi.render(prep, size, size, mode="bvh")
    brute_img = tapi.render(prep, size, size, mode="brute")
    _structural_match(bvh_img.numpy(), brute_img.numpy(), 0.12, 5.0)


def test_bvh_render_depth1_golden_exact():
    prep = tapi.prepare_scene(tscenes.rgbbox(device=CPU), 200, 200,
                              leaf_size=8, device=CPU)
    img = tapi.render(prep, 200, 200, mode="bvh", max_depth=1, chunk=8000)
    np.testing.assert_array_equal(
        img.numpy(), read_ppm(os.path.join(GOLDEN, "rgbbox_200_d1.ppm")))


def test_bvh_mode_needs_the_tree():
    prep = tapi.prepare_scene(tscenes.rgbbox(device=CPU), 8, 8,
                              with_bvh=False, device=CPU)
    assert prep.bvh is None
    for fn in (tapi.render, tapi.render_float):
        with pytest.raises(ValueError, match="with_bvh=True"):
            fn(prep, 8, 8, mode="bvh")


# ---------------------------------------------------------------------------
# validation and checkpoints (tests/test_utils.py)


def test_validate_bvh_accepts_good_and_catches_bad():
    sc = tscenes.rgbbox(device=CPU)
    bvh = tlbvh.build_bvh(sc.spheres, leaf_size=8)
    assert validate_bvh(bvh) == [] and validate_spheres(sc.spheres) == []
    # a corrupt node AABB: a containment violation
    node_min = bvh.node_min.clone()
    node_min[0] = 1e9
    assert any("AABB" in p for p in validate_bvh(
        bvh._replace(node_min=node_min)))
    # a corrupt leaf skip link: a threading violation
    skip = bvh.skip.clone()
    skip[bvh.n_inner] = -1
    assert any("skip" in p for p in validate_bvh(bvh._replace(skip=skip)))
    # a bad radius
    radius = sc.spheres.radius.clone()
    radius[0] = -1.0
    assert validate_spheres(sc.spheres._replace(radius=radius))
    # JAX's tree validates in the port too
    assert validate_bvh(convert.bvh(_jax_build(
        jscenes.irreg().spheres, 8), CPU)) == []


def test_bvh_npz_both_ways(tmp_path):
    """A tree the port saves loads in JAX and walks as JAX's own; a tree
    JAX saves loads in the port field for field."""
    jsph, tsph = _both("rgbbox")
    port_path, jax_path = str(tmp_path / "port"), str(tmp_path / "jax.npz")
    bvh = tlbvh.build_bvh(tsph, leaf_size=8)
    tckpt.save_bvh(port_path, bvh)
    loaded = jckpt.load_bvh(port_path)
    jbvh = _jax_build(jsph, 8)
    _assert_fields_equal(loaded, bvh)
    o, d = _scene_rays("rgbbox", 16)
    for a, b in zip(jclosest(loaded, jnp.asarray(o), jnp.asarray(d)),
                    jclosest(jbvh, jnp.asarray(o), jnp.asarray(d))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jckpt.save_bvh(jax_path, jbvh)
    back = tckpt.load_bvh(jax_path, device=CPU)
    _assert_fields_equal(jbvh, back)


def test_spheres_npz_both_ways_and_latest(tmp_path):
    s = Spheres(torch.ones(3, 3), torch.ones(3), torch.zeros(3, 3))
    p = str(tmp_path / "ckpt_5.npz")
    tckpt.save_spheres(p, s, step=5, extra={"loss": 0.25})
    js, step, extra = jckpt.load_spheres(p)
    assert step == 5 and float(extra["loss"]) == 0.25
    np.testing.assert_array_equal(np.asarray(js.center), 1.0)
    jckpt.save_spheres(str(tmp_path / "bare"), js, step=7)
    s2, step, _ = tckpt.load_spheres(str(tmp_path / "bare"), device=CPU)
    assert step == 7 and torch.equal(s2.radius, s.radius)
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
    for i in (1, 10, 2):
        tckpt.save_spheres(str(tmp_path / f"ckpt_{i}.npz"), s, step=i)
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith("ckpt_10.npz")


# ---------------------------------------------------------------------------
# the CLI (tests/test_cli.py)


def _run(args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "raytracers_tpu_torch.cli"] + args,
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)


@pytest.mark.parametrize("mode", ["bvh", "brute", "brute_matmul"])
def test_cli_renders_ppm(tmp_path, mode):
    out = tmp_path / "out.ppm"
    r = _run(["-m", "24", "-n", "32", "-s", "rgbbox", "-r", "1", "--cpu",
              "--mode", mode, "--validate", "--depth", "4", "-f", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "Using scene rgbbox (-s to switch)."
    assert lines[1] == "Timing over average of 1 runs (-r to change)."
    assert lines[2].startswith("Scene BVH construction in ")
    assert lines[3].startswith("Rendering in ")
    assert "invariants OK" in r.stderr
    img = read_ppm(str(out))
    assert img.shape == (24, 32)
    prep = tapi.prepare_scene(tscenes.rgbbox(device=CPU), 24, 32, device=CPU)
    np.testing.assert_array_equal(
        img, tapi.render(prep, 24, 32, mode=mode, max_depth=4).numpy())


def test_cli_unknown_scene_and_not_ported_flags(tmp_path):
    r = _run(["-s", "nope", "--cpu", "-r", "1"])
    assert r.returncode != 0 and "Unknown scene" in r.stderr + r.stdout
    # --native renders through the native C++ renderer on the host
    # (tests/test_torch_native.py holds its image)
    r = _run(["--native", "--cpu", "-r", "1", "-m", "24", "-n", "32"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines()[3].startswith("Rendering in ")
    # --shard renders over a one-rank mesh the unsharded image
    # (tests/test_sharding.py:127)
    out = tmp_path / "shard.ppm"
    r = _run(["--shard", "-m", "24", "-n", "32", "-s", "rgbbox", "-r", "1",
              "--cpu", "--mode", "pallas", "--depth", "2", "-f", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines()[3].startswith("Rendering in ")
    prep = tapi.prepare_scene(tscenes.rgbbox(device=CPU), 24, 32,
                              with_pallas=True, device=CPU)
    np.testing.assert_array_equal(
        read_ppm(str(out)),
        tapi.render(prep, 24, 32, mode="pallas", max_depth=2).numpy())
