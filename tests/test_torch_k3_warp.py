"""K3's warp schedule: the split leaf round, the path and split rules, the
schedule model, and (on the card) the kernel against its plain version.

The CUDA kernel (``csrc/traversal.cu``) runs persistent warps whose lanes
take new rays, picks each iteration a tree step, a leaf round or a shading
by ballot, and tests a leaf round's leaves split over the warp's lanes where
that takes fewer slot passes.  None of that may change a pixel: the split
round takes the first smallest t of a leaf, which is what the serial loop
keeps.  On the CPU these tests hold the split round's model
(``traversal_model.split_leaf_round``) equal to the plain version's
``_leaf_round`` on rays of rgbbox and irreg and on spheres built to tie,
check the wrapper's path rule at the shared-memory budget and the split
rule, and check the schedule model on hand-built cases.  The cases marked
``cuda`` hold the kernel bit-equal to ``traversal_kernel_reference``; they
skip without a card.  On a machine with the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k3_warp.py -m cuda
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.render import traversal as ttr
from raytracers_tpu_torch.render import traversal_model as tm
from raytracers_tpu_torch.render.megakernel import _ray_order
from raytracers_tpu_torch.utils.trace import counting

torch.set_num_threads(2)
CPU = "cpu"
I, L, S = tm.STEP_INNER, tm.STEP_LEAF, tm.STEP_SHADE


def _port(name, device=CPU):
    sc = tscenes.by_name(name, device=device)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device=device)
    return (*ttr.build_traversal_scene(sc.spheres), cam)


def _leaf_calls(scene, C, K, cam, far_root, side=12, depth=4):
    """The inputs of every ``_leaf_round`` call of a small plain render."""
    calls = []
    real = ttr._leaf_round

    def spy(*args):
        calls.append(args)
        return real(*args)

    ttr._leaf_round = spy
    try:
        ttr.traversal_reference(scene, C, K, cam, side, side,
                                max_depth=depth, far_root=far_root,
                                block=None, tile=16)
    finally:
        ttr._leaf_round = real
    return calls


@pytest.mark.parametrize("far_root", [True, False])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_split_round_equals_leaf_round(name, far_root):
    """The split round's (t, slot) equals the plain leaf round's on every
    leaf visit of a 12x12 render to depth 4."""
    scene, C, K, cam = _port(name)
    calls = _leaf_calls(scene, C, K, cam, far_root)
    assert len(calls) > 4
    for args in calls:
        k_t, k_best = ttr._leaf_round(*args)[:2]
        t, slot = tm.split_leaf_round(*args)
        assert torch.equal(t.view(torch.int32), k_t.view(torch.int32))
        assert torch.equal(slot, k_best)


def _tie_leaf(K, dup):
    """One cluster of K spheres far off the axis but for the slots in
    ``dup``: the same sphere on the ray's axis, so they tie in t."""
    sph = torch.zeros(K, 8, ttr.LANE)
    sph[:, 0, 0] = 1000.0 + 10.0 * torch.arange(K, dtype=torch.float32)
    sph[:, 3, 0] = 1.0
    for k in dup:
        sph[k, :4, 0] = torch.tensor([0.0, 0.0, -20.0, 2.0])
    return sph


@pytest.mark.parametrize("K,dup,want", [
    (8, (5, 2, 7), 2),           # one segment of 8: the smallest lane wins
    (40, (35, 3, 33, 4), 3),     # lane 3's passes 0 and 1, lane 1's pass 1
    (79, (71, 40, 8), 8),        # three passes; the first slot, not lane
])
def test_split_round_ties_take_the_first_slot(K, dup, want):
    """Duplicate spheres give equal t; the split round's minimum of (t
    bits, slot) takes the first slot, as the serial loop does."""
    sph = _tie_leaf(K, dup)
    m = 5
    o = [torch.zeros(m), torch.linspace(-0.5, 0.5, m), torch.zeros(m)]
    d = [torch.zeros(m), torch.zeros(m), -torch.ones(m)]
    a = torch.ones(m)
    best_t = torch.full((m,), 1e9)
    c = torch.zeros(m, dtype=torch.int64)
    for far_root in (True, False):
        args = (sph, c, best_t, o, d, a, 1.0 / a, far_root)
        k_t, k_best = ttr._leaf_round(*args)[:2]
        t, slot = tm.split_leaf_round(*args)
        assert (k_best == want).all() and (k_t < 1e9).all()
        assert torch.equal(t.view(torch.int32), k_t.view(torch.int32))
        assert torch.equal(slot, k_best)


def test_segment_width_and_split_rule():
    """A leaf's segment is the power of two at or above K (at most 32);
    the kernel splits a round where that takes fewer slot passes than K,
    a group charged 8 passes beyond its own."""
    assert [tm.segment_width(k) for k in (1, 2, 3, 8, 9, 32, 33, 79)] == \
        [1, 2, 4, 8, 16, 32, 32, 32]
    assert tm.SPLIT_OVERHEAD == 8
    # irreg: 3 + 8 passes a leaf, against 79
    assert tm.split_groups(7, 79) == 77 and tm.leaf_round_split(7, 79)
    assert not tm.leaf_round_split(8, 79)
    # rgbbox: 4 leaves a group of 1 + 8 passes, against 8: never
    assert not any(tm.leaf_round_split(n, 8) for n in range(1, 33))
    # K = 112 (four passes): up to 9 leaves
    assert tm.leaf_round_split(9, 112) and not tm.leaf_round_split(10, 112)
    assert not any(tm.leaf_round_split(n, 1) for n in range(1, 33))


def test_model_constants_are_the_kernels():
    """The model's policy constants are the ones ``csrc/traversal.cu``
    defines, and the policy sweep rewrites each of them there."""
    from raytracers_tpu_torch.probes import k3_policy
    from raytracers_tpu_torch.render import _cuda
    text = _cuda.source("traversal").read_text()
    assert k3_policy.source_values(text) == (
        tm.LEAF_EIGHTHS, tm.SHADE_EIGHTHS, tm.SPLIT_OVERHEAD)
    for values in k3_policy.VARIANTS.values():
        if values is not None:
            assert k3_policy.source_values(
                k3_policy.variant_source(text, values)) == values


@pytest.mark.parametrize("C", [2, 33, 128])
def test_path_rule_at_the_shared_memory_budget(C):
    """The geometry goes to shared memory while C*K float4 slots fit
    beside the inner table and leaf skips in a block's 227 KB."""
    k_max = (ttr.SMEM_LIMIT - ttr.TABLE_SMEM) // (16 * C)
    assert ttr.geometry_in_shared(C, k_max)
    assert not ttr.geometry_in_shared(C, k_max + 1)
    assert ttr.TABLE_SMEM + 16 * C * k_max <= 232_448 < \
        ttr.TABLE_SMEM + 16 * C * (k_max + 1)


def test_path_rule_for_the_scenes():
    """rgbbox and irreg keep their geometry in shared memory; a 14,000-
    sphere scene at the default leaf size (C = 128, K = 110) does too, and
    one of 14,400 (K = 113) reads it from global memory."""
    assert ttr.geometry_in_shared(50, 8) and ttr.geometry_in_shared(127, 79)
    assert ttr.geometry_in_shared(128, 110)
    assert not ttr.geometry_in_shared(128, 113)
    scene, C, K = ttr.build_traversal_scene(
        tscenes.random_spheres(4 * 5, seed=3, device=CPU), leaf_size=5)
    geo = ttr.cluster_major(scene, C)
    assert geo.shape == (C, K, 4) and geo.is_contiguous()
    assert torch.equal(geo[2, 3], scene.spheres[3, :4, 2])


def test_counters_only_on_the_card():
    scene, C, K, cam = _port("rgbbox")
    ro = _ray_order(cam, 8, 8, 64, None, 0.0, None, 2)
    with pytest.raises(ValueError, match="warp rounds"):
        ttr.traversal_kernel(scene, ro.params, ro.n_rays, 64, n_clusters=C,
                             leaf_size=K, max_depth=2,
                             counters=torch.zeros(len(ttr.COUNTERS),
                                                  dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        ttr.traversal_kernel(scene, ro.params, ro.n_rays, 64, n_clusters=C,
                             leaf_size=K, max_depth=2,
                             counters=torch.zeros(3, dtype=torch.int64))


def test_ray_sequences_follow_the_counters():
    """Each ray's steps from the plain version's trace: its inner steps
    are its node steps, K slots a leaf its slot tests, a shading a bounce."""
    scene, C, K, cam = _port("rgbbox")
    ro = _ray_order(cam, 8, 8, 64, None, 0.0, None, 6)
    trace = []
    _, stats = ttr.traversal_kernel_reference(
        scene, ro.params, ro.n_rays, 64, n_clusters=C, leaf_size=K,
        max_depth=6, trace=trace)
    seqs = tm.ray_sequences(trace, ro.n_rays)
    for g, s in enumerate(seqs):
        n = {k: int((s == k).sum()) for k in (I, L, S)}
        assert n[I] == stats[ttr.STATS.index("node_steps"), g]
        assert n[L] * K == stats[ttr.STATS.index("slot_tests"), g]
        assert n[S] == stats[ttr.STATS.index("ray_bounces"), g]
        assert s[-1] == S


def _seqs(*rays):
    return [np.array(r, dtype=np.int8) for r in rays]


def test_model_split_round_on_a_hand_built_warp():
    """Four rays at leaves of K = 64 (segments of 32, 2 passes): one
    split round of 4 x (2 + 8) slot passes, then a shading, against the
    serial round's 64 passes.  Useful: 4 x (64 x 21 + 143)."""
    seqs = _seqs(*[[L, S]] * 4)
    useful = 4 * (64 * 21 + 143)
    split = tm.schedule_share(seqs, 64, persistent=False)
    assert split["share"] == pytest.approx(
        useful / (32 * (40 * 21 + 143)), rel=1e-12)
    assert (split["leaf_split"], split["shade"]) == (1, 1)
    for kw in (dict(split=False), dict(policy="diverge")):
        r = tm.schedule_share(seqs, 64, persistent=False, **kw)
        assert r["share"] == pytest.approx(useful / (32 * (64 * 21 + 143)),
                                           rel=1e-12)
        assert r["leaf_split"] == 0


def test_model_policy_and_persistence_on_a_hand_built_case():
    """33 rays, K = 1: ray 0 takes three tree steps, the others one.  A
    fixed warp runs rays 0-31 in 5 rounds (tree, shade, tree, tree, shade:
    the ballot shades once 31 of 32 lanes wait) and a second warp ray 32;
    one persistent warp gives lane 1 ray 32 after the first shading, and
    runs its tree step beside ray 0's."""
    seqs = _seqs([I, I, I, S], *[[I, S]] * 32)
    useful = (3 * 39 + 143) + 32 * (39 + 143)
    fixed = tm.schedule_share(seqs, 1, persistent=False)
    assert Fraction(fixed["useful"], fixed["issued"]) == \
        Fraction(useful, 32 * ((39 + 143 + 39 + 39 + 143) + (39 + 143)))
    pers = tm.schedule_share(seqs, 1, persistent=True, n_warps=1)
    assert Fraction(pers["useful"], pers["issued"]) == \
        Fraction(useful, 32 * 3 * (39 + 143))
    assert (pers["tree"], pers["shade"]) == (3, 3)
    # every kind some lane needs, each round: the thread-per-ray kernel
    div = tm.schedule_share(_seqs([I, L, S], [I, I, L, S]), 1,
                            policy="diverge", persistent=False)
    assert div["issued"] == 32 * (39 + (39 + 21) + (143 + 21) + 143)


def test_thread_warp_share():
    """Σ work over Σ over warps of 32 x the busiest lane's."""
    work = torch.ones(64, dtype=torch.int64)
    work[0] = 5
    assert tm.thread_warp_share(work) == pytest.approx(68 / (32 * 5 + 32))
    # a ragged last warp counts as a whole warp
    assert tm.thread_warp_share(torch.ones(40)) == pytest.approx(40 / 64)


# ---------------------------------------------------------------------------
# the kernel, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K3 is a CUDA kernel")
    return torch.device("cuda")


def _over(C):
    """The least K whose geometry does not fit shared memory at C."""
    return (ttr.SMEM_LIMIT - ttr.TABLE_SMEM) // (16 * C) + 1


def _random_scene(C, K, device, seed=7):
    """A seeded soup of C leaves of K spheres (the last one partly full),
    dense enough to bounce, and a camera outside it looking at its
    centre."""
    n = C * K - (K - 1) // 2
    rng = np.random.default_rng(seed)
    ext = 8.0 * n ** (1.0 / 3.0)
    sph = tgeo.Spheres(
        torch.tensor(rng.uniform(-ext / 2, ext / 2, (n, 3)),
                     dtype=torch.float32, device=device),
        torch.tensor(rng.uniform(0.5, 3.0, n), dtype=torch.float32,
                     device=device),
        torch.tensor(rng.uniform(0.0, 1.0, (n, 3)), dtype=torch.float32,
                     device=device))
    scene, c, k = ttr.build_traversal_scene(sph, leaf_size=K)
    assert (c, k) == (C, K)
    cam = tgeo.camera((0.3, 0.2, ext), (0., 0., 0.), (0., 1., 0.), 60.0,
                      1.0, device=device)
    return scene, C, K, cam


SCENE_CASES = [pytest.param(name, None, None, id=name)
               for name in ("rgbbox", "irreg")] + [
    pytest.param("random", C, K, id=f"C{C}-K{K or 'over'}")
    for C in (2, 33, 128) for K in (1, 8, 33, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("far_root", [True, False])
@pytest.mark.parametrize("name,C,K", SCENE_CASES)
def test_kernel_equals_plain(cuda, name, C, K, far_root):
    """One launch a render, bit-equal to the plain version, in both ray
    orders at depth 1 and 50, on 900 (scanline) and 1,200 (blocks of 5 x
    20) rays: neither a multiple of a warp nor of a block.  Each path
    (shared or global geometry; K None: the least K over the budget) is
    the one the rule gives."""
    over = name == "random" and K is None
    if name == "random":
        scene, C, K, cam = _random_scene(C, K or _over(C), cuda)
    else:
        scene, C, K, cam = _port(name, cuda)
    path = "shared" if ttr.geometry_in_shared(C, K) else "global"
    assert (path == "global") == over
    counters = torch.zeros(len(ttr.COUNTERS), dtype=torch.int64,
                           device=cuda)

    def kernel(*args, **kw):
        return ttr.traversal_kernel(*args, counters=counters, **kw)

    for block in (None, (5, 20)):
        for depth in (1, 50):
            kw = dict(max_depth=depth, far_root=far_root, block=block,
                      tile=100)
            with counting() as c:
                img = ttr.render_traversal(scene, C, K, cam, 30, 30,
                                           kernel=kernel, **kw)
            assert c.read()["k3.launches"] == {"total": 1, path: 1}
            ref = ttr.traversal_reference(scene, C, K, cam, 30, 30, **kw)
            torch.cuda.synchronize()
            assert img.device.type == "cuda"
            assert torch.equal(img, ref), (block, depth)
    n = dict(zip(ttr.COUNTERS, counters.tolist()))
    assert n["tree_steps"] > 0 and n["shade_rounds"] > 0
    assert n["serial_rounds"] + n["split_rounds"] > 0
    assert n["serial_leaves"] >= n["serial_rounds"]
    assert n["split_leaves"] >= n["split_rounds"]


def test_chip_smoke_k3_work_is_the_bounds_count():
    """``chip_smoke``'s per-ray work (the thread-per-ray warp-lane share's
    input) sums to the operations K3's bound charges."""
    import chip_smoke
    scene, C, K, cam = _port("irreg")
    ro = _ray_order(cam, 8, 8, 64, None, 0.0, None, 3)
    _, per_ray = ttr.traversal_kernel_reference(
        scene, ro.params, ro.n_rays, 64, n_clusters=C, leaf_size=K,
        max_depth=3)
    stats = dict(zip(ttr.STATS, per_ray.sum(dim=1).tolist()),
                 rays=ro.n_rays)
    ops_ms, by = chip_smoke._k3_bound(stats, 0)
    assert by == "operations"
    work = chip_smoke._k3_work(per_ray)
    assert work.shape == (ro.n_rays,) and (work > 0).all()
    assert float(work.sum()) == pytest.approx(
        ops_ms * 1e-3 * chip_smoke.FP32_LANE_OPS_PER_S, rel=1e-9)
    assert 0 < tm.thread_warp_share(work) <= 1
