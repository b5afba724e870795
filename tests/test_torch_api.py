"""The port's render path as a user calls it, against the JAX package's:
``prepare_scene(with_pallas=True, with_bvh=False)`` + ``render``."""
import numpy as np
import pytest
import torch

from raytracers_tpu import scenes as jscenes
from raytracers_tpu.render import api as japi
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.image import pixel_to_rgb
from raytracers_tpu_torch.render import api as tapi
from raytracers_tpu_torch.render import megakernel as tmk

torch.set_num_threads(2)
CPU = "cpu"
W = H = 64


def _prepared(name, size=W):
    port = tapi.prepare_scene(tscenes.by_name(name, device=CPU), size, size,
                              with_pallas=True, with_bvh=False, device=CPU)
    ref = japi.prepare_scene(jscenes.by_name(name), size, size,
                             with_pallas=True)
    return port, ref


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_pallas_depth1_bit_exact(name):
    port, ref = _prepared(name)
    img = tapi.render(port, H, W, mode="pallas", max_depth=1)
    want = japi.render(ref, H, W, mode="pallas", max_depth=1, interpret=True)
    assert img.device.type == "cpu" and img.dtype == torch.int32
    np.testing.assert_array_equal(img.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_pallas_full_depth_structural(name):
    """Deep renders run the class schedule with its sort prefixes; the
    tolerance is tests/test_pallas.py's (f32 mirror cascades)."""
    port, ref = _prepared(name)
    img = tapi.render(port, H, W, mode="pallas").numpy()
    want = np.asarray(japi.render(ref, H, W, mode="pallas", interpret=True))
    assert (img != want).mean() < 0.12
    delta = np.abs(pixel_to_rgb(img).astype(np.int32)
                   - pixel_to_rgb(want).astype(np.int32)).mean()
    assert delta < 4.0


@pytest.mark.parametrize("name,size", [("rgbbox", 48), ("irreg", 24)])
def test_brute_depth1_equal(name, size):
    port, ref = _prepared(name, size)
    img = tapi.render(port, size, size, mode="brute", max_depth=1, chunk=96)
    want = japi.render(ref, size, size, mode="brute", max_depth=1,
                       chunk=96)
    np.testing.assert_array_equal(img.numpy(), np.asarray(want))


def test_brute_equals_pallas_depth1():
    port, _ = _prepared("irreg", 32)
    a = tapi.render(port, 32, 32, mode="brute", max_depth=1, chunk=128)
    b = tapi.render(port, 32, 32, mode="pallas", max_depth=1)
    assert torch.equal(a, b)


@pytest.mark.parametrize("C", [1, 4, 16, 17, 79, 128, 129, 782])
def test_pallas_config_values(C):
    assert tapi.pallas_config(C) == japi.pallas_config(C)


@pytest.mark.parametrize("depth", [3, 50])
def test_render_stats(depth):
    port, _ = _prepared("rgbbox", 32)
    stats = tapi.render_stats(port, 32, 32, max_depth=depth)
    for key in ("slot_tests", "ray_bounces", "cull_rows"):
        assert isinstance(stats[key], int) and stats[key] > 0, key
    ps = port.pallas
    _, one = tmk.render_pallas(ps, port.cam, 32, 32, max_depth=depth,
                               tile=2048, block=(64, 32), with_stats=True)
    assert {k: stats[k] for k in one} == one
    # every ray is traced once per bounce it runs; rgbbox tests its 4
    # cluster boxes each time
    assert stats["cull_rows"] == 4 * stats["ray_bounces"]
    assert ("phase_slot_tests" in stats) == (depth == 50)


def test_not_ported_paths_raise():
    """The BVH path runs (the JAX defaults build the tree, and
    ``mode="bvh"`` renders through it; without the tree it raises JAX's
    ValueError); unknown modes and a missing megakernel layout raise."""
    sc = tscenes.rgbbox(device=CPU)
    both = tapi.prepare_scene(sc, 8, 8, with_pallas=True, device=CPU)
    assert both.bvh.n_leaves == 50 and both.pallas is not None
    img = tapi.render(both, 8, 8, mode="bvh", max_depth=1)
    assert torch.equal(img, tapi.render(both, 8, 8, mode="brute",
                                        max_depth=1))
    prep = tapi.prepare_scene(sc, 8, 8, with_pallas=True, with_bvh=False,
                              device=CPU)
    with pytest.raises(ValueError, match="with_bvh=True"):
        tapi.render(prep, 8, 8, mode="bvh")
    with pytest.raises(ValueError, match="unknown"):
        tapi.render(prep, 8, 8, mode="nope")
    bare = tapi.prepare_scene(sc, 8, 8, with_bvh=False, device=CPU)
    with pytest.raises(ValueError, match="with_pallas"):
        tapi.render(bare, 8, 8, mode="pallas")


def test_render_schedule_overrides():
    """``schedule`` and ``phase1_depth`` as in the JAX package's render:
    each replaces the class schedule (the image is the same: schedules only
    repartition the bounce loop); an explicit schedule drops the class's
    sort prefixes, ``phase1_depth`` keeps them."""
    port, _ = _prepared("rgbbox", 32)
    seen = []

    def spy(*args, **kw):
        seen.append((kw["schedule"], kw["sort_prefix"]))
        return tmk.render_pallas_twophase(*args, **kw)

    base = tapi.render(port, 32, 32, mode="pallas", max_depth=20)
    orig, tapi.render_pallas_twophase = tapi.render_pallas_twophase, spy
    try:
        a = tapi.render(port, 32, 32, mode="pallas", max_depth=20,
                        schedule=(4, 8))
        b = tapi.render(port, 32, 32, mode="pallas", max_depth=20,
                        phase1_depth=5)
    finally:
        tapi.render_pallas_twophase = orig
    assert torch.equal(a, base) and torch.equal(b, base)
    assert seen == [((4, 8), None), ((5,), (None, 0.5, 0.25))]


def test_scene_scale_render_through_the_api():
    """plane(n_side=130), C = 133 in three cull blocks, front to back: the
    scene-scale class config through ``render``, depth 1 bit-exact against
    the JAX package's render; deep, the multi-phase render equals one
    launch, and ``render_stats`` counts the two-level cull."""
    sc = tscenes.plane(n_side=130, device=CPU)
    port = tapi.prepare_scene(sc, 24, 24, with_pallas=True, with_bvh=False,
                              device=CPU)
    ps = port.pallas
    assert ps.n_clusters == 133 and ps.aabbT.shape[0] == 3
    ref = japi.prepare_scene(jscenes.plane(n_side=130), 24, 24,
                             with_pallas=True, with_bvh=False)
    img = tapi.render(port, 24, 24, mode="pallas", max_depth=1)
    want = japi.render(ref, 24, 24, mode="pallas", max_depth=1,
                       interpret=True)
    np.testing.assert_array_equal(img.numpy(), np.asarray(want))
    deep = tapi.render(port, 24, 24, mode="pallas", max_depth=16)
    one = tmk.render_pallas(ps, port.cam, 24, 24, max_depth=16)
    assert torch.equal(deep, one)
    stats = tapi.render_stats(port, 24, 24, max_depth=16)
    assert len(stats["phase_slot_tests"]) == 4
    assert 3 * stats["ray_bounces"] <= stats["cull_rows"]
    assert stats["cull_rows"] <= (3 + 133) * stats["ray_bounces"]
