"""K2's slot table: the warp model, its float32 emulation of the table, and
(on the card) the kernel's counters and outputs.

The CUDA kernel (``csrc/replay_bwd.cu``) sweeps each warp's paths
backwards, every lane at the warp's step k, and sums the cotangents of the
lanes that hit one slot in registers before one atomic row-add a group.
``grad/replay_bwd_model.py`` models that from the records: ``warp_groups``
counts the row-adds and warp iterations the kernel's counters must report,
and ``aggregated_table`` sums the table in the kernel's order.  On the CPU
these tests hold the model's counts against a brute count per warp, and
its table within the bound of a float32 sum in any order of the float64
sum (``chip_smoke._slot_bound``).  The cases marked ``cuda`` hold the
kernel's per-ray outputs and per-bounce cotangents bit-equal to
``replay_bwd_reference``, its table within the bound and its counters
equal to the model's (``chip_smoke.CheckedK2``); they skip without a card.
On a machine with the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k2_aggregate.py -m cuda
"""
import functools
import re

import numpy as np
import pytest
import torch

import chip_smoke
from raytracers_tpu_torch import geometry as tgeo
from raytracers_tpu_torch import scenes as tscenes
from raytracers_tpu_torch.grad import replay_bwd as trb
from raytracers_tpu_torch.grad import replay_bwd_model as tmod
from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
from raytracers_tpu_torch.probes import k2_table
from raytracers_tpu_torch.render import megakernel as tmk
from raytracers_tpu_torch.render.api import pallas_diff_config

torch.set_num_threads(2)
CPU = "cpu"
SIZE, DEPTH = 64, 50


def _setup(name, device=CPU, width=None):
    sc = tscenes.by_name(name, device=device)
    cam = tgeo.camera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0,
                      device=device)
    ps = tmk.build_pallas_scene(sc.spheres, cluster_width=width)
    cfg = pallas_diff_config(tmk.build_pallas_scene(sc.spheres).n_clusters)
    return sc, cam, ps, cfg


@functools.lru_cache(maxsize=None)
def _records(name, blocked):
    """K1d's plain records of a whole path at 64x64, depth 50, under the
    scene's pallas_diff_config tile (and block), and the ray order."""
    _, cam, ps, (tile, block, _, _) = _setup(name)
    blk = block if blocked else None
    _, _, rec, pay = tmk.render_pallas_record(ps, cam, SIZE, SIZE,
                                              max_depth=DEPTH, tile=tile,
                                              with_pay=True, block=blk)
    ro = tmk._ray_order(cam, SIZE, SIZE, tile, blk, 0.0, None, DEPTH)
    return rec, pay, ro.params, tile, ps.order.numel()


@functools.lru_cache(maxsize=None)
def _segments(name):
    """The class schedule's records: (rec, pay, state) per segment."""
    _, cam, ps, (tile, block, schedule, prefix) = _setup(name)
    _, aux = tmk.render_pallas_record_twophase(
        ps, cam, SIZE, SIZE, max_depth=DEPTH, tile=tile, block=block,
        schedule=schedule, sort_prefix=prefix)
    states = [None] + aux["states"]
    return list(zip(aux["recs"], aux["pays"], states)), tile


def _brute(rec, align):
    """Row-adds, warp iterations, iterations with a bounce (a match) and
    shuffle rounds by lists, one warp and iteration at a time,
    with pass 1's path lengths from a loop over each ray's steps."""
    D, n = rec.shape
    L = []
    for g in range(n):
        k = 0
        while k < D and rec[k, g] != -2:
            k += 1
            if rec[k - 1, g] < 0:
                break
        L.append(k)
    adds = iters = matches = rounds = 0
    for w0 in range(0, n, 32):
        lanes = range(w0, min(w0 + 32, n))
        Lw = max(L[g] for g in lanes)
        iters += Lw
        for i in range(Lw):
            slots = []
            for g in lanes:
                k = Lw - 1 - i if align == "depth" else L[g] - 1 - i
                if 0 <= k < L[g] and rec[k, g] >= 0:
                    slots.append(int(rec[k, g]))
            adds += len(set(slots))
            matches += len(slots) > 0
            big = max((slots.count(x) for x in slots), default=1)
            rounds += (big - 1).bit_length()
    return adds, iters, matches, rounds


def _rec_cases():
    for name in ("rgbbox", "irreg"):
        for case in ("whole-scan", "whole-block", "segments", "tail"):
            yield pytest.param(name, case, id=f"{name}-{case}")
    yield pytest.param("rgbbox", "dead", id="all-dead")


def _recs(name, case):
    if case.startswith("whole"):
        return [_records(name, case.endswith("block"))[0]]
    if case == "segments":
        return [r for r, _, _ in _segments(name)[0]]
    if case == "tail":          # n not a multiple of a warp or a block
        rec = _records(name, True)[0]
        seg = _segments(name)[0][1][0]
        return [rec[:, :-13].contiguous(), seg[:, :-45].contiguous()]
    return [torch.full((4, 4096), -2, dtype=torch.int32)]


@pytest.mark.parametrize("align", tmod.ALIGNS)
@pytest.mark.parametrize("name,case", list(_rec_cases()))
def test_warp_groups_equal_brute_count(name, case, align):
    for rec in _recs(name, case):
        g = tmod.warp_groups(rec, align)
        assert (g.row_adds, g.warp_iterations, g.matches,
                g.shuffle_rounds) == _brute(rec, align)
        assert g.bounces == int((rec >= 0).sum())
        assert g.groups.shape[1] * 32 % tmod.THREADS == 0
        if case == "dead":
            assert (g.row_adds, g.warp_iterations, g.bounces) == (0, 0, 0)
        else:
            assert g.row_adds > 0 and g.conflict >= 1.0


def test_continuations_have_dead_rays():
    for name in ("rgbbox", "irreg"):
        segs = _segments(name)[0]
        assert len(segs) > 1
        assert all((rec[0] == -2).any() for rec, _, _ in segs[1:])


def test_path_lengths_by_hand():
    rec = torch.tensor([[3, 3, -1, -2, -3, 5],
                        [4, -1, -2, -2, -2, 5],
                        [-3, -2, -2, -2, -2, 5]], dtype=torch.int32)
    assert tmod.path_lengths(rec).tolist() == [3, 2, 1, 0, 1, 3]


def _tree(vals):
    """A group's sum as reduce_peers forms it, by pairs of places."""
    v = [np.float32(x) for x in vals]
    step = 1
    while step < len(v):
        for j in range(0, len(v), 2 * step):
            if j + step < len(v):
                v[j] = np.float32(v[j] + v[j + step])
        step *= 2
    return v[0]


def _shfl_down_sum(vals):
    """Lane 0's sum of the kernel's whole-warp path: x += shfl_down(x, s)
    for s = 1, 2, 4, 8, 16 (a lane past the top reads its own value)."""
    x = [np.float32(v) for v in vals]
    for s in (1, 2, 4, 8, 16):
        x = [np.float32(x[j] + x[j + s if j + s < 32 else j])
             for j in range(32)]
    return x[0]


def test_group_sums_in_the_kernels_order():
    """Groups of 3, 5, 1 and 23 lanes on values whose sum depends on the
    order: each equals reduce_peers' tree over its lanes in lane order."""
    rng = np.random.default_rng(3)
    slots = np.full(32, -1)
    groups = {5: [0, 3, 4], 2: [1, 2, 6, 7, 9], 8: [31]}
    for s, lanes in groups.items():
        slots[lanes] = s
    rest = [j for j in range(32) if slots[j] == -1][:23]
    slots[rest] = 11
    groups[11] = rest
    x = (rng.standard_normal((32, 7))
         * 10.0 ** rng.integers(-6, 7, (32, 7))).astype(np.float32)
    slot, sums = tmod.group_sums(torch.from_numpy(slots)[None],
                                 torch.from_numpy(x)[None])
    got = dict(zip(slot.tolist(), sums.numpy()))
    assert sorted(got) == sorted(groups)
    for s, lanes in groups.items():
        want = [_tree(x[lanes, r]) for r in range(7)]
        assert np.array_equal(got[s].view(np.int32),
                              np.array(want, np.float32).view(np.int32))


def test_whole_warp_fast_path_is_the_same_tree():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((32, 7))
         * 10.0 ** rng.integers(-6, 7, (32, 7))).astype(np.float32)
    slot, sums = tmod.group_sums(torch.full((1, 32), 7),
                                 torch.from_numpy(x)[None])
    assert slot.tolist() == [7]
    want = np.array([_shfl_down_sum(x[:, r]) for r in range(7)], np.float32)
    assert np.array_equal(sums[0].numpy().view(np.int32), want.view(np.int32))


def _within_bound(table, rec, step, n_slots):
    exact, mag, count = chip_smoke._slot_bound(rec, step, n_slots)
    bound = ((count[:, None] + 1.0) * chip_smoke.F32_EPS * mag
             + count[:, None] * chip_smoke.F32_FTZ)
    err = (table.double() - exact).abs()
    assert (err <= bound).all(), float((err - bound).max())
    return float((err / torch.where(bound > 0, bound, 1.0)).max())


def _gcot(n, seed, carry=False):
    g = np.random.default_rng(seed).standard_normal((trb.N_GCOT, n))
    if not carry:
        g[3:] = 0.0
    return torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("align", tmod.ALIGNS)
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_aggregated_table_within_bound(name, align):
    """The whole path (block-tiled) and every continuation of the class
    schedule, with a random image cotangent and carry."""
    rec, pay, params, tile, S = _records(name, True)
    step, _, _ = trb.replay_bwd_reference(params, rec, pay,
                                          _gcot(rec.shape[1], 1), tile=tile,
                                          block_tiled=True)
    _within_bound(tmod.aggregated_table(rec, step, S, align), rec, step, S)
    segs, tile = _segments(name)
    for k, (rec, pay, state) in enumerate(segs[1:], 1):
        step, _, _ = trb.replay_bwd_reference(
            params, rec, pay, _gcot(rec.shape[1], 1 + k, carry=True),
            tile=tile, state_rows=state)
        _within_bound(tmod.aggregated_table(rec, step, S, align), rec, step,
                      S)


def _synthetic(n, D, n_slots, seed, scale=1.0, tied=False):
    """Records with every path D bounces long (or ending early at random),
    slots tied across whole warps or drawn at random, and per-step
    cotangents of magnitude ``scale``."""
    rng = np.random.default_rng(seed)
    if tied:
        slots = np.repeat(rng.integers(0, n_slots, (D, -(-n // 32))), 32,
                          axis=1)[:, :n]
    else:
        slots = rng.integers(0, n_slots, (D, n))
    end = rng.integers(1, D + 1, n)
    k = np.arange(D)[:, None]
    rec = np.where(k < end - 1, slots, np.where(k == end - 1, -1, -2))
    step = np.zeros((D, 8, n), np.float32)
    step[:, :7] = (rng.standard_normal((D, 7, n)) * scale).astype(np.float32)
    step[:, :7] *= (rec >= 0)[:, None]
    return torch.from_numpy(rec.astype(np.int32)), torch.from_numpy(step)


@pytest.mark.parametrize("tied,scale", [(True, 1.0), (False, 1.0),
                                        (True, 1e-39), (False, 1e-39)],
                         ids=["tied", "random", "tied-subnormal",
                              "random-subnormal"])
def test_aggregated_table_ties_and_subnormals(tied, scale):
    """Whole warps on one slot (the kernel's shuffle-down path); and
    subnormal cotangents, whose float32 atomics flush them (the bound's
    2^-125 an add)."""
    rec, step = _synthetic(32 * 40 - 7, 6, 24, seed=5, scale=scale,
                           tied=tied)
    g = tmod.warp_groups(rec)
    if tied:
        assert g.groups.max() == 1
    tab = tmod.aggregated_table(rec, step, 24)
    _within_bound(tab, rec, step, 24)
    if scale < 1e-30:
        # the atomics flush the sums that stay subnormal
        exact = trb.slot_table(rec, step, 24)
        assert (tab == 0).sum() > (exact == 0).sum()


def test_counters_raise_on_the_cpu():
    rec, pay, params, tile, S = _records("rgbbox", True)
    gcot = _gcot(rec.shape[1], 0)
    with pytest.raises(ValueError, match="row-adds"):
        trb.replay_bwd(params, rec, pay, gcot, tile=tile, block_tiled=True,
                       reduce_slots=S, counters=True)
    out = trb.replay_bwd(params, rec, pay, gcot, tile=tile,
                         block_tiled=True, reduce_slots=S)
    assert len(out) == 3


def test_model_constants_are_the_kernels():
    from raytracers_tpu_torch.render import _cuda
    text = _cuda.source("replay_bwd").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", text)[1]) == \
        tmod.THREADS
    assert "const int k = Lw - 1 - i;" in text      # align="depth"


def test_probe_variants_rewrite_the_source():
    """The probe's copies: ``none`` adds nothing, ``lane`` and
    ``lane-uniform`` add per lane (``lane`` in a loop of the lane's own
    path), ``warp-end`` puts each lane at its own k; the source and the
    copies keep the counters' argument."""
    from raytracers_tpu_torch.render import _cuda
    text = _cuda.source("replay_bwd").read_text()
    src = {v: k2_table.variant_source(text, body, rw)
           for v, (body, rw) in k2_table.VARIANTS.items()}
    assert src["warp"] == text
    assert "__match_any_sync(kFull" not in src["none"]
    assert "{ return 0; }" in src["none"]
    for v in ("lane", "lane-uniform"):
        assert "__match_any_sync(kFull" not in src[v]
        assert "atomicAdd(row + r, cot[r]);" in src[v]
    assert "const int Lw = L;" in src["lane"]
    assert "__reduce_max_sync(kFull, L)" in src["lane-uniform"]
    assert "const int k = L - 1 - i;" in src["warp-end"]
    assert all(k2_table._has_counters(s) for s in src.values())
    old = text.replace("unsigned long long* counters, ", "")
    assert not k2_table._has_counters(old)


# ---------------------------------------------------------------------------
# the kernel, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K2 is a CUDA kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [False, True],
                         ids=["whole", "segmented"])
@pytest.mark.parametrize("blocked", [False, True], ids=["scan", "block"])
@pytest.mark.parametrize("width", [32, 64, 128])
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_kernel_equals_plain_with_counters(cuda, name, width, blocked,
                                           segmented):
    """Every K2 launch of the engine's step at 64x64, depth 50: per-ray
    outputs and per-bounce cotangents bit-equal, the table within its
    bound, the counters equal to the model's."""
    sc, cam, _, (tile, block, schedule, prefix) = _setup(name, cuda)
    k2 = chip_smoke.CheckedK2(f"{name} W={width}")
    f = make_render_pallas_diff(
        SIZE, SIZE, max_depth=DEPTH, tile=tile,
        block=block if blocked else None,
        schedule=schedule if segmented else None,
        sort_prefix=prefix if segmented else None,
        cluster_width=None if width == 128 else width, bwd_kernel=k2)
    leaves = [t.detach().requires_grad_(True) for t in (*sc.spheres, *cam)]
    img = f(tgeo.Spheres(*leaves[:3]), tgeo.Camera(*leaves[3:]))
    (img * img).sum().backward()
    torch.cuda.synchronize()
    assert k2.checks >= 4 and k2.row_adds > 0
    assert k2.bounces >= k2.row_adds


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rgbbox", "irreg"])
def test_kernel_tail_warp_and_dead_continuation(cuda, name):
    """Launches whose n is not a multiple of a warp (a whole path, both ray
    maps, and a continuation) and a continuation whose rays are all dead:
    no lane may leave before the warp's collectives."""
    _, cam, ps, (tile, block, schedule, prefix) = _setup(name, cuda)
    S = ps.order.numel()
    k2 = chip_smoke.CheckedK2(f"{name} tail")
    for blk in (None, block):
        _, _, rec, pay = tmk.render_pallas_record(
            ps, cam, SIZE, SIZE, max_depth=DEPTH, tile=tile, with_pay=True,
            block=blk)
        ro = tmk._ray_order(cam, SIZE, SIZE, tile, blk, 0.0, None, DEPTH)
        n = rec.shape[1] - 13
        k2(ro.params, rec[:, :n].contiguous(), pay[..., :n].contiguous(),
           _gcot(n, 2).to(cuda), tile=tile, block_tiled=blk is not None,
           reduce_slots=S)
    _, aux = tmk.render_pallas_record_twophase(
        ps, cam, SIZE, SIZE, max_depth=DEPTH, tile=tile, block=block,
        schedule=schedule, sort_prefix=prefix)
    rec, pay, state = aux["recs"][1], aux["pays"][1], aux["states"][0]
    n = rec.shape[1] - 45
    k2(ro.params, rec[:, :n].contiguous(), pay[..., :n].contiguous(),
       _gcot(n, 3, carry=True).to(cuda), tile=tile,
       state_rows=state[:, :n].contiguous(), reduce_slots=S)
    dead = torch.full_like(rec, -2)
    tab, carry, _, cnt = trb.replay_bwd(
        ro.params, dead, pay, _gcot(rec.shape[1], 4, carry=True).to(cuda),
        tile=tile, state_rows=state, reduce_slots=S, counters=True)
    torch.cuda.synchronize()
    assert cnt.tolist() == [0, 0]
    assert (tab == 0).all() and (carry == 0).all()
    k2(ro.params, dead, pay, _gcot(rec.shape[1], 4, carry=True).to(cuda),
       tile=tile, state_rows=state, reduce_slots=S)
    assert k2.checks >= 8
