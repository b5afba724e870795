#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``raytracers_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with a Hopper card and nvcc:

    python3 chip_smoke.py

It imports torch, numpy and the port, never JAX.  The phases run in order;
a failed phase exits non-zero before the final line:

1. card and build: the card's name and power limit as nvidia-smi gives
   them, then every kernel of ``raytracers_tpu_torch/csrc`` compiled for
   sm_90a (one nvcc each, all started together), with the build times and
   ptxas's register reports;
1b. the scene layout (``[layout]`` lines): ``build_pallas_scene`` on the
   card (``csrc/layout.cu``: the Morton codes, one stable sort, the pack)
   against the plain build on the card, for rgbbox, irreg, plane-100k and
   the 1M soup, front to back and unsorted: every table equal (bit for
   bit, but a zero of the boxes whose sign alone differs), the launches by
   stage counted, both builds timed in turns (the host's call, the
   synchronised end, CUDA events; medians of LAYOUT_RUNS), the soup's
   kernel build, unsorted as phase 5 renders it, no slower than the plain
   one;
2. K1 against its plain version: rgbbox and irreg at 200x200 through
   ``render_pallas`` (scanline and block tiles, depth 1 and 50: mode K1a)
   and ``render_pallas_twophase`` with the scene's class schedule and sort
   prefixes (K1a with state out, then K1b continuations), all with the
   per-ray counters (K1c).  Every K1 launch runs on both of the kernel's
   routes (a thread per ray and a warp per ray) and is repeated by the
   plain version on the same inputs on the card, and the images, state rows
   and counters must be bit-equal.  Then the scene-scale mode (K1e, the
   two-level cull) the same way at SCALE_CHECK_SIZE: plane-100k (depth 1
   and its class schedule to depth 50) and the 1M-sphere soup (depth 1 and
   5), and the culled depth-1 images against unculled launches;
3. K1d and K2 against their plain versions at 200x200, both scenes, and on
   the 20k-sphere soup (C = 157, three cull blocks) at SOUP20K_CHECK_SIZE
   and depth SOUP20K_DEPTH:
   record renders single- and multi-phase, scanline and block (records, pay
   at bounces, state rows bit-equal); the fwd+bwd engine whole-path and at
   the scene's ``pallas_diff_config``, with every K2 launch repeated by the
   plain version (per-ray cotangents, carries and per-bounce cotangents
   bit-equal; the slot table within its summation-order bound, plus the
   subnormals its float32 atomics flush; the kernel's counters, atomic
   row-adds and warp iterations, equal to ``replay_bwd_model.warp_groups``'
   counts on the records); the replayed colours of K2 (``emit_fwd``)
   bit-equal to K1d's at the full depth;
4. goldens: ``render(mode="pallas")`` at 200x200 against ``tests/golden``;
   then the native oracle (``native/raytracer.cpp``), built by the port's
   loader (``raytracers_tpu_torch/native.py``) on this host (``[native]``
   lines): the six goldens reproduced bit for bit at 200x200;
   ``render(mode="pallas")`` on the card at 1000x1000 against it, depth 50
   within the scene's golden tolerances, and at depth 1 every differing
   pixel explained by ``native.explain_depth1`` (a grazing hit or a sky
   colour at a quantization step, on rays a few ulps apart), else the run
   fails; the oracle's render times on the host CPU, named, printed after
   phase 5 beside the card's ``render_ms``;
5. main path, render, for each cell: launches counted from zero around one
   render (and by route; no layout launch), render times with CUDA events,
   per-phase K1 times on both routes in turns (the route rule's route, the
   other, the other, the rule's; ``[routes]`` lines), what an all-dead
   continuation costs on each route, counters, K1's bound, the
   thread-per-ray route's warp-lane share of the visit work, the uncounted
   image against the plain version (the counted render, and the render with
   K1's counters, bit-equal to it), and for the soup the render at twice
   the side.  A multi-phase cell's timed renders replay the frame's CUDA
   graphs (``render_pallas_twophase``): its counted render captures them,
   and K1's launches a phase and by route are read from torch.profiler's
   kernels of one replayed frame; its replayed frame is checked bit for bit
   against the same frame with its launches run one by one, and both are
   timed in turns (graph, eager, eager, graph; ``[graphs]`` lines).
   rgbbox, irreg and plane-100k go through ``prepare_scene`` +
   ``render(mode="pallas")`` at 1000x1000, depth 50; the 1M-sphere soup
   through ``build_pallas_scene`` + ``render_pallas`` at 256x256, depth 5,
   tile 2048, blocks (8, 256), as ``bench.py`` renders it (the camera at
   (0, 0, 520) looking at the origin, fov 60). Then one rgbbox render under
   ``utils.profiling.device_trace`` (``[profile]``): ``device_kernel_ms``
   of the exported Chrome trace equal to the per-kernel sums of the same
   session's device events, the per-kernel times beside the card's name and
   power limit;
6. main path, fwd+bwd: ``make_render_pallas_diff`` at 1000x1000, depth 50,
   with the scene's ``pallas_diff_config``, then ``loss.backward()`` for
   ``loss = (f(spheres, cam) ** 2).sum()``: launches counted from zero
   around one step (the layout's two stages once each, K1d once a phase, K2
   once a segment), finite non-zero gradients, step times with CUDA events,
   per-launch K1d times on both routes in turns as phase 5 times them, K2
   times, one profiled step, the bounds, and the uncounted step's image and
   gradients against the plain engine on the card (the counted step's, and
   the step's with the kernels' counters, too: images bit-equal, gradients
   within the same bounds); per K2 segment (``K2 segment`` lines) its time,
   bounces, atomic row-adds (the model's, equal to the kernel's counters on
   the same inputs), conflict factor (bounces per row-add) and
   ``index_add_``'s time.  Then ``examples/pallas_gradients.py``'s port as
   a user runs it (``[example]`` lines), at its defaults (64x64, depth 8)
   and at 1000x1000, depth 50: launches counted from zero around one run
   (K1d and K2 once each, its engine being one segment), finite loss and
   gradients, the run's host seconds, and at the defaults the gradients
   against the plain engine on the card within this phase's bound;
7. the BVH path against its plain versions: ``build_bvh`` on the card
   field for field equal to the CPU build (rgbbox, irreg and plane at leaf
   8, the 1M-sphere soup of ``bench.py`` at leaf 128 and 8),
   ``validate_bvh`` clean on rgbbox and irreg; K3 (``render_traversal``)
   bit-equal to its plain version at 200x200, both scenes (the shared-
   memory path) and the 14,400-sphere soup (C = 128, K = 113: the global-
   memory path), far root on and off, scanline and block, depth 1 and 50;
   K3 and ``render(mode="bvh")`` against the goldens (depth 1 bit-exact,
   depth 50 within their tolerances);
8. main path, BVH (``[bvh]`` lines): the 1M-sphere ``build_bvh`` at leaf
   128 and 8 (CUDA events, one warm-up, 3 runs); ``prepare_scene`` with
   the tree and ``render(mode="bvh")`` for rgbbox and irreg at 1000x1000,
   depth 50 (one warm-up, 2 timed renders); K3 for
   both scenes and the 14,400-sphere soup at 1000x1000, depth 50, default
   tile and blocks: launches counted from zero around one render, 3 rounds
   of 5 renders, the kernel's time by CUDA events, its warp rounds by kind
   (tree steps, serial and split leaf rounds and their leaves, shadings),
   the plain version's time and counters on the card, the bound, the
   thread-per-ray schedule's warp-lane share (Σ work over Σ over warps of
   32 × the busiest lane's, from the per-ray counters), and the image
   bit-equal to the plain version's;
9. K1f (``[k1f]`` lines): at 200x200, K1 at cluster widths 64 and 32 (irreg
   then takes the two-level cull) and near root only (``far_root=False``),
   scanline and block, depth 1 and 50, and the class schedule; the forced
   occlusion gate (``occl_cont``) with ``coherent`` repacking, and
   ``seg_tiles`` + ``tile2`` + ``lane_groups``; K1d at W = 64; every launch
   on both routes bit-equal to the plain version; the engine at W = 64
   with every K2 launch checked as in phase 3 and its gradients against
   the W = 128 engine's.  Then the render cells at 1000x1000, depth 50,
   with the default render's config, for both scenes: (a) W = 64, (b) W = 32,
   (c) ``far_root=False``, (d) ``coherent`` + ``occl_cont``, (e)
   ``seg_tiles=8, tile2=512, lane_groups=2``, each measured as phase 5
   measures (launches, 3 rounds of 5 renders, per-phase K1 time on both
   routes, counters,
   bound, the plain version's image bit-equal) and held to the default
   render: (e) and ``coherent`` alone bit-equal, the others within the
   depth-50 golden tolerances, with the differing pixels printed.  The
   fwd+bwd step at W = 64 as phase 6 measures it.  Last,
   ``backward="xla"`` on rgbbox at depth 50 with 8 ray chunks, unsorted and
   sorted by depth (the largest side of 1000, 707, 500 whose warm-up step
   takes at most 60 s): step times, peak memory, the sorted gradients
   against the unsorted ones, the gap to ``backward="pallas"`` over the
   whole image (printed), and over the pixels whose float64 replay gives
   their float32 colour within 1e-6 (held to the tests' tolerances);
10. the probes M1-M7 of ``tools/microbench_tpu.py``, ``microbench_v5.py``
   and ``microbench_mxuquad.py`` (``[probe]`` lines); first M1-M4:
   ``probes.microbench.run`` at the TPU probes' sizes, launches counted from
   zero around it: M1's FP32 issue rate (uncontracted and FMA at 8, 4 and
   1 streams) and sqrtf, division and 1/x; M2's pair, pairT and payload
   products as an FP32 loop, TF32 and 3xTF32 wgmma (with ``torch.bmm`` at
   each route's precision as the library call); M3's 128-key minimum,
   serial, shuffled and ``__reduce_min_sync`` (with ``torch.amin``); M4's
   cluster visit, a thread or k lanes a ray at 4k, 64k and 1M rays, on
   the TPU probe's spheres and a seeded set.  Every variant is held
   against its plain version on the card (bit-equal, but M1's FMA and M2's
   TF32 routes within their stated bounds).  Phase 1 also times M1's
   square root, division and 1/x, and prints them beside the weights the
   bounds charge (``SQRT_OPS``, ``DIV_OPS``).  Then
   ``probes.microbench_v5.run`` and ``probes.microbench_mxuquad.run``:
   M5's visit at 32, 64 and 128 rows, payload read each visit (``mxu``) or
   deferred (``defer``), a thread or k lanes a ray, at 8,192, 65,536 and
   1,048,576 rays (M4 and M5 bounded by operations and by the fewest L1
   wavefronts any route's loads need, with the device's own time under a
   millisecond); M6's deferred 8-field gather, 4 and 1 chunks, through
   ``__ldg`` or shared memory, at 8,192 and 1,048,576 lanes (with
   ``tbl[:, slot]`` indexing timed beside it); M7's five variants, the FP32 quadratic (``vpu``) or bf16 ``wgmma``
   (``mxuquad``, splits 1 and 3), at 8,192 and 1,048,576 rays (with
   ``torch.matmul`` of the bf16 operands), on the TPU probes' inputs and a
   seeded set.  M5, M6 and M7's ``vpu`` are bit-equal to their plain
   versions; ``mxuquad``'s product lies within its bound of the float64
   product and its visit is bit-equal given that product, and the rays
   whose winner equals the ``vpu`` visit's are printed;
11. the trainer (``[train]`` lines): ``make_train_step_pallas`` on a
   one-rank NCCL mesh (a ``HashStore``, world size 1), rgbbox at
   1000x1000, depth 50, ``pallas_diff_config``, colours perturbed as
   ``examples/rgbbox_recovery.py`` perturbs them, only colours trainable:
   launches counted from zero around one step (phase 6's K1d and K2), 10
   steps whose losses are finite and fall, ``train_step_ms`` (3 rounds of
   3 steps, CUDA events) beside phase 6's ``fwdbwd_ms`` and their
   difference (the all-reduce, Adam and the clamps), a profile of one
   step; the one-rank loss
   bit-equal to the plain engine's and its gradients within phase 6's
   summation-order bound (K2's slot table adds in no fixed order, so two
   kernel runs need not agree bit for bit; the unsharded kernel engine's
   are printed, held to the slabs' tolerances).  Then four ranks in this
   process: ``render_pallas_slab`` of ranks 0-3 at 1000x1000, depth 50,
   both scenes, assembled bit-equal to ``render(mode="pallas")``; the four
   bands' summed loss and gradients at 256x256, depth 3, against the
   unsharded engine: on tests/test_sharding.py:186's toy scene within its
   tolerances (:214-220), on rgbbox printed with the share of pixels whose
   banded path differs (a band camera rounds each ray direction once, and
   rgbbox's mirror cascades carry that to other paths).  Last, ``recover`` over the all-pairs oracle (64x64, depth
   2, 4 steps) resumed from a checkpoint after step 2 within 1e-5 of an
   uninterrupted run, and ``render(mode="brute_matmul")`` differing from
   ``brute`` on under 1% of the 64x64 pixels.

The line before the last is the kernels' JSON record (each K1 entry with
the lanes per ray of each launch); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

ROOT = Path(__file__).resolve().parent
SCENES = ("rgbbox", "irreg")
SIZE, DEPTH = 1000, 50          # the main path's image and bounce cap
CHECK_SIZE = 200                # phases 2 to 4
REPEATS = 5                     # timed renders per scene
ROUTE_REPS = 2                  # renders a turn when K1's routes alternate
FB_REPEATS = 3                  # timed fwd+bwd steps per round
SCALE_CHECK_SIZE = 64           # K1e against its plain version (phase 2)
# K1d and K2 at three cull blocks (phase 3), at a depth whose mirror
# cascades keep the soup's gradients within float32 (~1e17 at depth 16)
SOUP20K_CHECK_SIZE, SOUP20K_DEPTH = 128, 16
# random sphere soups: (spheres, seed, extent, camera distance); the camera
# looks at the origin, fov 60.  soup1m is bench.py:184-194's render.
SOUPS = {"soup20k": (20_000, 5, 200.0, 260.0),
         # K3's global-memory path: at the default leaf size (C = 128,
         # K = 113) the geometry does not fit a block's shared memory
         "soup14k": (14_400, 5, 200.0, 260.0),
         "soup1m": (1_000_000, 11, 400.0, 520.0)}
# render cells of the main path: name -> (image side, depth)
CELLS = {"rgbbox": (SIZE, DEPTH), "irreg": (SIZE, DEPTH),
         "plane": (SIZE, DEPTH), "soup1m": (256, 5)}
SOUP_CONFIG = (2048, (8, 256), (), None)    # bench.py's tile and blocks
# one layout build of more than 128 spheres: the codes, then the pack
LAYOUT_LAUNCHES = {"total": 2, "codes": 1, "pack": 1}
LAYOUT_RUNS = 6                 # rounds of the two builds in turns (phase 1b)
WARP = 32

# the card's peaks and the kernels' operation counts, which every bound of
# the port reads (raytracers_tpu_torch/utils/profiling.py)
sys.path.insert(0, str(ROOT))
from raytracers_tpu_torch.utils.profiling import (  # noqa: E402
    DIV_OPS, FP32_LANE_OPS_PER_S, HBM_BYTES_PER_S, K2_SCRATCH_BYTES, K3_OPS,
    OPS_PER_BOUNCE, OPS_PER_CULL_ROW, OPS_PER_GATE, OPS_PER_HIT,
    OPS_PER_K2_BOUNCE, OPS_PER_K2_END, OPS_PER_MIRROR, OPS_PER_SLOT,
    OPS_PER_SLOT_NEAR, PAY_BYTES, SQRT_OPS, STATE_BYTES,
    device_profile)
K2_STATUS = ("redesigned: a warp-uniform backward sweep, each warp's "
             "bounces on one slot summed in registers before one atomic "
             "row-add")
F32_EPS = 2.0 ** -24            # float32 unit roundoff
# float32 atomic adds flush subnormal operands and results to zero: each
# add of a slot table may lose up to twice the smallest normal, 2^-125
F32_FTZ = 2.0 ** -125

# the BVH build's soup (bench.py:249-267) and its leaf sizes
BVH_SOUP, BVH_LEAVES = (1_000_000, 0), (128, 8)
K3_GLOBAL = "soup14k"           # K3's scene on the global-memory path

# the goldens the native oracle reproduces bit for bit (phase 4), and its
# timed renders a scene at SIZE, DEPTH
NATIVE_GOLDENS = (("rgbbox", 1, "rgbbox_200_d1.ppm"),
                  ("rgbbox", 2, "rgbbox_200_d2.ppm"),
                  ("rgbbox", 4, "rgbbox_200_d4.ppm"),
                  ("rgbbox", 8, "rgbbox_200_d8.ppm"),
                  ("rgbbox", DEPTH, "rgbbox_200.ppm"),
                  ("irreg", DEPTH, "irreg_200.ppm"))
NATIVE_RUNS = 3
# more differing depth-1 pixels than this is a fault, not rounding (the CPU
# run of the plain version: 13 and 4 of 10^6); each is classified alone
NATIVE_MAX_DEPTH1_PIXELS = 1000
GOLDENS = (("rgbbox", 1, "rgbbox_200_d1.ppm", 0.0, 0.0),
           ("rgbbox", DEPTH, "rgbbox_200.ppm", 0.15, 6.0),
           ("irreg", DEPTH, "irreg_200.ppm", 0.02, 0.5))


class SmokeError(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def load_port():
    """Import the port from this checkout; fail where the script stands
    alone or would pick up another copy."""
    sys.path.insert(0, str(ROOT))
    import raytracers_tpu_torch as port
    where = Path(port.__file__).resolve().parent.parent
    if where != ROOT:
        raise SmokeError(f"imported the port from {where}, not {ROOT}")
    return port


# ---------------------------------------------------------------------------
# comparing the kernel with its plain version


def _first_diff(a, b):
    """Bitwise comparison of two same-shape tensors whose last axis is the
    ray; returns the first differing ray or None."""
    import torch
    ai = a.view(torch.int32) if a.dtype == torch.float32 else a
    bi = b.view(torch.int32) if b.dtype == torch.float32 else b
    bad = ai != bi
    if bad.dim() > 1:
        bad = bad.any(dim=0)
    idx = bad.nonzero()
    return None if idx.numel() == 0 else int(idx[0, 0])


def _abs_err(a, b, packed: bool) -> float:
    """Largest difference: float values as floats, packed pixels by
    channel, counters as integers."""
    import torch
    if a.numel() == 0:
        return 0.0
    if a.dtype == torch.float32:
        d = (a - b).abs()
        return float(torch.nan_to_num(d, nan=float("inf")).max())
    if packed:
        ch = [((a >> s) & 0xFF) - ((b >> s) & 0xFF) for s in (16, 8, 0)]
        return float(max(c.abs().max() for c in ch))
    return float((a.long() - b.long()).abs().max())


class Checked:
    """K1 with each launch run on both routes (a thread and a warp per ray)
    and repeated by its plain version on the same inputs on the card; any
    bit of difference fails the phase.  Returns the rule's route's result."""

    def __init__(self, mk, label: str):
        self.mk, self.label = mk, label
        self.checks = 0
        self.max_abs_err = 0.0
        self.route_checks = {lanes: 0 for lanes in mk.LANES}

    def compare(self, what: str, out, ref, packed: bool = True) -> None:
        g = _first_diff(out, ref)
        self.max_abs_err = max(self.max_abs_err, _abs_err(out, ref, packed))
        if g is not None:
            o = out[..., g].tolist()
            r = ref[..., g].tolist()
            raise SmokeError(f"{self.label}: {what} differs first at ray {g}:"
                             f" kernel {o} plain {r}")
        self.checks += 1

    def __call__(self, scene, params, n_rays, tile, **kw):
        mk = self.mk
        ref = mk.megakernel_reference(scene, params, n_rays, tile, **kw)
        rule = _rule_lanes(mk, n_rays, kw)
        outs = {lanes: mk.megakernel(scene, params, n_rays, tile,
                                     _lanes=lanes, **kw)
                for lanes in mk.LANES}
        for lanes, out in outs.items():
            route = f"{lanes} lane{'s' if lanes > 1 else ''} per ray: "
            what = "state rows" if kw.get("emit_state") else "packed image"
            self.compare(route + what, out[0], ref[0])
            if out[1] is not None:
                self.compare(route + "counters", out[1], ref[1], packed=False)
            if kw.get("record_depth") is not None:
                self.compare(route + "records", out[2], ref[2], packed=False)
                if out[3] is not None:
                    # pay is defined only at bounces
                    bnc = out[2] >= 0
                    self.compare(route + "pay at bounces",
                                 out[3][:, :7].permute(1, 0, 2)[:, bnc],
                                 ref[3][:, :7].permute(1, 0, 2)[:, bnc])
            self.route_checks[lanes] += 1
        return outs[rule]


def _rule_lanes(mk, n_rays, kw) -> int:
    """The lanes per ray the route rule gives a launch of these arguments."""
    return mk.lanes_per_ray(n_rays, kw.get("state_in") is not None)


def _slot_bound(rec, cot_step, n_slots):
    """The float64 sum of each slot's per-bounce cotangents, the sum of
    their magnitudes and their count: a float32 sum of them in any order
    lies within (count + 1) unit roundoffs of the magnitudes' sum of the
    exact one (count terms, then one rounding)."""
    import torch
    from raytracers_tpu_torch.grad.replay_bwd import slot_table
    exact = slot_table(rec, cot_step, n_slots)
    mag = slot_table(rec, cot_step, n_slots, absolute=True)
    count = torch.zeros(n_slots, dtype=torch.float64, device=rec.device)
    count.index_add_(0, rec.reshape(-1).clamp(min=0).long(),
                     (rec.reshape(-1) >= 0).double())
    return exact, mag, count


class CheckedK2:
    """K2 with each launch repeated by its plain version on the same inputs
    on the card: per-ray outputs (cotangents of the rays or the carry, the
    replayed colours) and, in a second kernel launch, the per-bounce
    cotangents must be bit-equal; the slot table must lie within
    ``_slot_bound`` of the float64 sum of the plain per-bounce cotangents,
    since the kernel adds it with float32 atomics in no fixed order (which
    also flush subnormals: ``F32_FTZ`` an add).  A third launch with the
    kernel's counters must report the atomic row-adds and warp iterations
    that ``replay_bwd_model.warp_groups`` counts on the records."""

    def __init__(self, label: str):
        from raytracers_tpu_torch.grad import replay_bwd as rb
        from raytracers_tpu_torch.grad import replay_bwd_model as model
        self.rb, self.model, self.label = rb, model, label
        self.checks = 0
        self.max_abs_err = 0.0          # per-ray outputs and the table
        self.table_err_share = 0.0      # largest error / its bound
        self.bounces = self.row_adds = 0    # of the table launches

    def _equal(self, what, out, ref):
        g = _first_diff(out, ref)
        self.max_abs_err = max(self.max_abs_err, _abs_err(out, ref, False))
        if g is not None:
            raise SmokeError(f"{self.label}: K2 {what} differs first at ray "
                             f"{g}: kernel {out[..., g].tolist()} plain "
                             f"{ref[..., g].tolist()}")
        self.checks += 1

    def __call__(self, params, rec, pay, gcot, **kw):
        import torch
        rb = self.rb
        out = rb.replay_bwd(params, rec, pay, gcot, **kw)
        step_kw = dict(kw, reduce_slots=None)
        ref_step, ref_ray, ref_fwd = rb.replay_bwd_reference(
            params, rec, pay, gcot, **step_kw)
        self._equal("ray cotangents", out[1], ref_ray)
        if ref_fwd is not None:
            self._equal("replayed colours", out[2], ref_fwd)
        step, _, _ = rb.replay_bwd(params, rec, pay, gcot, **step_kw)
        self._equal("per-bounce cotangents", step, ref_step)
        n_slots = kw.get("reduce_slots")
        if n_slots is not None:
            exact, mag, count = _slot_bound(rec, ref_step, n_slots)
            err = (out[0].double() - exact).abs()
            bound = ((count[:, None] + 1.0) * F32_EPS * mag
                     + count[:, None] * F32_FTZ)
            self.max_abs_err = max(self.max_abs_err, float(err.max()))
            bad = (err > bound).nonzero()
            if bad.numel():
                s, f = (int(x) for x in bad[0])
                raise SmokeError(
                    f"{self.label}: K2 slot table [{s}, {f}] kernel "
                    f"{float(out[0][s, f])} exact {float(exact[s, f])} "
                    f"bound {float(bound[s, f])}")
            share = err / torch.where(bound > 0, bound, 1.0)
            self.table_err_share = max(self.table_err_share,
                                       float(share.max()))
            self.checks += 1
        self._counters(params, rec, pay, gcot, kw)
        return out

    def _counters(self, params, rec, pay, gcot, kw):
        got = self.rb.replay_bwd(params, rec, pay, gcot, counters=True,
                                 **kw)[3].tolist()
        groups = self.model.warp_groups(rec)
        table = kw.get("reduce_slots") is not None
        want = [groups.row_adds if table else 0, groups.warp_iterations]
        if got != want:
            names = self.rb.COUNTERS
            raise SmokeError(f"{self.label}: K2 counters "
                             f"{dict(zip(names, got))}, the model's "
                             f"{dict(zip(names, want))}")
        if table:
            self.bounces += groups.bounces
            self.row_adds += groups.row_adds
        self.checks += 1


class Timed:
    """K1 (or its plain version) with CUDA events around each launch; the
    k-th launch of a render of n phases is phase k % n."""

    def __init__(self, fn, n_phases: int):
        from raytracers_tpu_torch.utils.timing import EventTimer
        self.fn, self.n_phases = fn, n_phases
        self.timer = EventTimer()
        self.calls = 0

    def __call__(self, *args, **kw):
        with self.timer.span(self.calls % self.n_phases):
            out = self.fn(*args, **kw)
        self.calls += 1
        return out

    def phase_ms(self) -> list[float]:
        """Mean milliseconds of each phase over the renders timed."""
        ms = self.timer.ms()
        return [sum(ms[k]) / len(ms[k]) for k in range(self.n_phases)]


class RouteTimed:
    """K1 on a chosen route with CUDA events around each launch: ``"rule"``
    runs the route rule's route, ``"other"`` the other one; the lanes per
    ray of each phase's launch are kept."""

    def __init__(self, mk, n_phases: int, which: str):
        self.mk, self.which = mk, which
        self.timed = Timed(self._launch, n_phases)
        self.lanes = [None] * n_phases

    def _launch(self, scene, params, n_rays, tile, **kw):
        rule = _rule_lanes(self.mk, n_rays, kw)
        lanes = rule if self.which == "rule" else 33 - rule
        self.lanes[self.timed.calls % self.timed.n_phases] = lanes
        return self.mk.megakernel(scene, params, n_rays, tile, _lanes=lanes,
                                  **kw)

    def __call__(self, *args, **kw):
        return self.timed(*args, **kw)


def route_turns(mk, n_phases: int, run: Callable, reps: int) -> dict:
    """Each phase's K1 time on both routes in turns (the rule's route, the
    other, the other, the rule's): ``run(kernel)`` renders (or steps) once
    with ``kernel`` running K1, ``reps`` times a turn.  Returns per phase
    the rule's lanes per ray, the mean ms of the rule's route, the other's,
    the thread-per-ray and warp-per-ray routes', and the totals."""
    turns = {w: RouteTimed(mk, n_phases, w) for w in ("rule", "other")}
    for which in ("rule", "other", "other", "rule"):
        for _ in range(reps):
            run(turns[which])
    rule_ms = turns["rule"].timed.phase_ms()
    other_ms = turns["other"].timed.phase_ms()
    lanes = turns["rule"].lanes
    by = {1: [r if l == 1 else o for l, r, o in zip(lanes, rule_ms, other_ms)],
          32: [r if l == 32 else o for l, r, o in zip(lanes, rule_ms,
                                                      other_ms)]}
    return dict(rule_lanes=lanes, rule_phase_ms=rule_ms,
                other_phase_ms=other_ms, thread_phase_ms=by[1],
                warp_phase_ms=by[32], rule_ms=sum(rule_ms),
                thread_ms=sum(by[1]), warp_ms=sum(by[32]),
                best_ms=sum(min(a, b) for a, b in zip(by[1], by[32])))


# ---------------------------------------------------------------------------
# phases


def phase_card_and_build() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip())
    from raytracers_tpu_torch.render import _cuda
    t0 = time.perf_counter()
    _cuda.build_all()
    log(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")
    for name in _cuda.KERNELS:
        _cuda.load(name)
        info = _cuda.build_info[name]
        log(f"[build] {name}: {_cuda.source(name).relative_to(ROOT)} -> "
            f"{Path(info['path']).relative_to(ROOT)} (nvcc "
            f"{info['seconds']:.2f} s)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
    from raytracers_tpu_torch.probes import microbench as mb
    w = mb.measure_mul_equivalents()
    log(f"[build] M1 here: sqrtf {w['sqrt']:.3f}, division {w['div']:.3f}, "
        f"1/x {w['rcp']:.3f} multiply-equivalents; the bounds charge "
        f"SQRT_OPS = {SQRT_OPS}, DIV_OPS = {DIV_OPS}")


def _layout_equal(what: str, got, want) -> int:
    """Every field of layout ``got`` equal to ``want``'s, bit for bit but
    for zeros of ``aabbT`` and ``superT`` whose sign alone differs (the
    boxes fold in another order than torch's reductions); returns how many
    such zeros there are."""
    import torch
    signed = 0
    for field in got._fields:
        a, b = getattr(got, field), getattr(want, field)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise SmokeError(f"{what}: {field} {tuple(a.shape)} {a.dtype}, "
                             f"the plain build's {tuple(b.shape)} {b.dtype}")
        if a.dtype == torch.float32:
            diff = a.view(torch.int32) != b.view(torch.int32)
        else:
            diff = a != b
        if not bool(diff.any()):
            continue
        if field in ("aabbT", "superT") and torch.equal(a, b):
            signed += int(diff.sum())
            continue
        raise SmokeError(f"{what}: {field} differs from the plain build's "
                         f"at {_first_diff(a.reshape(-1), b.reshape(-1))}")
    return signed


def _time_builds(kernel, plain) -> tuple:
    """Medians over LAYOUT_RUNS rounds, each build after a synchronise and
    the two in turns (kernel first in even rounds): the host's ms from the
    call to its return, the ms to the device's end (host clock,
    synchronised) and between CUDA events around the call."""
    import statistics
    import torch
    times = {kernel: ([], [], []), plain: ([], [], [])}
    for r in range(LAYOUT_RUNS):
        for build in (kernel, plain) if r % 2 == 0 else (plain, kernel):
            host, wall, event = times[build]
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            build()
            e1.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host.append((t1 - t0) * 1e3)
            wall.append((time.perf_counter() - t0) * 1e3)
            event.append(e0.elapsed_time(e1))
    return tuple(dict(host_ms=statistics.median(h),
                      wall_ms=statistics.median(w),
                      event_ms=statistics.median(e))
                 for h, w, e in (times[kernel], times[plain]))


def phase_layout(port) -> list:
    """The scene layout on the card (``csrc/layout.cu``) against the plain
    build on the card, for every scene the smoke renders, front to back
    and unsorted: every field equal, the launches by stage, both builds
    timed in turns; the 1M soup's kernel build, unsorted as phase 5
    renders it, no slower than the plain one."""
    import torch
    from raytracers_tpu_torch.render import megakernel as mk
    from raytracers_tpu_torch.utils.trace import counting
    out = []
    for name in CELLS:
        if name in SOUPS:
            sph, _ = _soup(name)
            origin = (0.0, 0.0, SOUPS[name][3])
        else:
            sc = port.scenes.by_name(name)
            sph, origin = sc.spheres, sc.look_from
        n = sph.center.shape[0]
        for so in (origin, None):
            what = f"{name} {'front to back' if so else 'unsorted'}"
            with counting(stats=False) as c:
                got = mk.build_pallas_scene(sph, sort_origin=so)
            torch.cuda.synchronize()
            launches = c.read().get("layout.launches", {})
            want = mk._build_pallas_scene_plain(sph, so, None, mk.LANE)
            signed = _layout_equal(what, got, want)
            C = got.n_clusters
            stages = dict(codes=int(n > mk.LANE),
                          pack=1 + int(so is not None and C > 16))
            expect = {k: v for k, v in stages.items() if v}
            expect["total"] = sum(stages.values())
            if launches != expect:
                raise SmokeError(f"{what}: the layout's launches {launches},"
                                 f" not {expect}")
            kernel, plain = _time_builds(
                lambda: mk.build_pallas_scene(sph, sort_origin=so),
                lambda: mk._build_pallas_scene_plain(sph, so, None, mk.LANE))
            res = dict(scene=name, sort_origin=so, n=n, clusters=C,
                       blocks=got.aabbT.shape[0], tail=got.tailT.shape[0],
                       launches=launches, signed_zeros=signed,
                       table_bytes=sum(t.numel() * 4 for t in got) + 28 * n,
                       kernel=kernel, plain=plain)
            log(f"[layout] {json.dumps(res)}")
            # the soup as phase 5 renders it; front to back, both builds
            # spend most of their time in the same torch argsorts (about 500
            # small operations at C = 7,813), which the host's noise sets
            if (name in SOUPS and so is None
                    and kernel["wall_ms"] > plain["wall_ms"]):
                raise SmokeError(f"{what}: the kernel build takes "
                                 f"{kernel['wall_ms']:.3f} ms, the plain "
                                 f"one {plain['wall_ms']:.3f}")
            out.append(res)
    return out


def _prepare(port, name: str, size: int):
    from raytracers_tpu_torch.render.api import prepare_scene
    sc = port.scenes.by_name(name)
    return prepare_scene(sc, size, size, with_pallas=True, with_bvh=False)


def _soup(name: str):
    """A random sphere soup on the card and its camera."""
    from raytracers_tpu_torch.geometry import camera
    from raytracers_tpu_torch.scenes import random_spheres
    n, seed, extent, z = SOUPS[name]
    sph = random_spheres(n, seed=seed, extent=extent)
    cam = camera((0.0, 0.0, z), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0, 1.0)
    return sph, cam


class Cell(NamedTuple):
    """A render of the main path: the layout, camera, image side, depth,
    config (tile, block, schedule, sort prefixes) and the user's call."""
    name: str
    ps: object
    cam: object
    size: int
    depth: int
    config: tuple
    render: Callable

    @property
    def multi_phase(self) -> bool:
        schedule = self.config[2]
        return bool(schedule) and self.depth >= 16 and sum(schedule) < self.depth

    @property
    def n_phases(self) -> int:
        return len(self.config[2]) + 1 if self.multi_phase else 1

    @property
    def n_rays(self) -> int:
        bh, bw = self.config[1]
        return (-(-self.size // bh) * bh) * (-(-self.size // bw) * bw)


def _cell(port, name: str, size: int | None = None,
          depth: int | None = None) -> Cell:
    """The main path's render of ``name`` (at ``size`` and ``depth`` if
    given): a scene through ``prepare_scene`` + ``render(mode="pallas")``,
    a soup through ``build_pallas_scene`` + ``render_pallas``."""
    from raytracers_tpu_torch.render import megakernel as mk
    from raytracers_tpu_torch.render.api import pallas_config, render
    size = size or CELLS[name][0]
    depth = depth or CELLS[name][1]
    if name in SOUPS:
        sph, cam = _soup(name)
        ps = mk.build_pallas_scene(sph)
        tile, block, _, _ = SOUP_CONFIG
        return Cell(name, ps, cam, size, depth, SOUP_CONFIG,
                    lambda: mk.render_pallas(ps, cam, size, size,
                                             max_depth=depth, tile=tile,
                                             block=block))
    prep = _prepare(port, name, size)
    return Cell(name, prep.pallas, prep.cam, size, depth,
                pallas_config(prep.pallas.n_clusters),
                lambda: render(prep, size, size, mode="pallas",
                               max_depth=depth))


def _render_with(cell: Cell, kernel, with_stats: bool = False):
    """The cell's render with ``kernel`` running K1 (the same schedule as
    the user's call)."""
    from raytracers_tpu_torch.render import megakernel as mk
    tile, block, schedule, prefix = cell.config
    kw = dict(max_depth=cell.depth, tile=tile, block=block,
              with_stats=with_stats, kernel=kernel)
    if cell.multi_phase:
        return mk.render_pallas_twophase(cell.ps, cell.cam, cell.size,
                                         cell.size, schedule=schedule,
                                         sort_prefix=prefix, **kw)
    return mk.render_pallas(cell.ps, cell.cam, cell.size, cell.size, **kw)


def phase_kernel_vs_plain(port) -> dict:
    """K1a/K1b/K1c against the plain version; returns the checkers."""
    from raytracers_tpu_torch.render import megakernel as mk
    from raytracers_tpu_torch.render.api import pallas_config
    size = CHECK_SIZE
    checkers = {}
    for name in SCENES:
        prep = _prepare(port, name, size)
        ps, cam = prep.pallas, prep.cam
        tile, block, schedule, prefix = pallas_config(ps.n_clusters)
        chk = Checked(mk, f"{name} {size}x{size}")
        imgs = {}
        for depth in (1, DEPTH):
            for blk in (None, block):
                imgs[depth, blk], _ = mk.render_pallas(
                    ps, cam, size, size, max_depth=depth, tile=tile,
                    block=blk, with_stats=True, kernel=chk)
        two, two_stats = mk.render_pallas_twophase(
            ps, cam, size, size, max_depth=DEPTH, tile=tile, block=block,
            schedule=schedule, sort_prefix=prefix, with_stats=True,
            kernel=chk)
        _, one_stats = mk.render_pallas(ps, cam, size, size, max_depth=DEPTH,
                                        tile=tile, block=block,
                                        with_stats=True, kernel=chk)
        chk.compare("block-tiled image against scanline",
                    imgs[1, block].reshape(-1), imgs[1, None].reshape(-1))
        chk.compare("multi-phase image against single-phase",
                    two.reshape(-1), imgs[DEPTH, block].reshape(-1))
        for key in ("slot_tests", "ray_bounces", "cull_rows"):
            if two_stats[key] != one_stats[key]:
                raise SmokeError(f"{name}: multi-phase {key} "
                                 f"{two_stats[key]} != {one_stats[key]}")
        log(f"[kernel=plain] {name} {size}x{size}: {chk.checks} bit-equal "
            f"comparisons, launches by lanes per ray {chk.route_checks} "
            f"(K1a scanline+block d1/d{DEPTH}, K1b schedule "
            f"{schedule} prefixes {prefix}, K1c counters {two_stats['slot_tests']}"
            f" slot tests)")
        checkers[name] = chk
    return checkers


def phase_scene_scale_vs_plain(port) -> dict:
    """K1e against its plain version at SCALE_CHECK_SIZE on plane-100k
    (C = 781, 13 cull blocks, front to back) and the 1M-sphere soup
    (C = 7,813, 123 blocks, unsorted): scanline and block tiles at depth 1,
    the cell's own render (plane: its class schedule to depth 50, and one
    launch to depth 50; soup: depth 5), every launch with counters; and the
    culled depth-1 images equal to unculled launches'.  Returns the
    checkers."""
    from raytracers_tpu_torch.render import megakernel as mk
    size = SCALE_CHECK_SIZE
    checkers = {}
    for name in ("plane", "soup1m"):
        t0 = time.perf_counter()
        cell = _cell(port, name, size=size)
        ps = cell.ps
        chk = Checked(mk, f"{name} {size}x{size}")
        tile, block = cell.config[:2]
        imgs = {blk: _render_with(cell._replace(
                    depth=1, config=(tile, blk, (), None)), chk,
                    with_stats=True)[0] for blk in (None, block)}
        chk.compare("block-tiled image against scanline",
                    imgs[block].reshape(-1), imgs[None].reshape(-1))
        off = mk.render_pallas(ps, cell.cam, size, size, max_depth=1,
                               tile=tile, cull=False)
        chk.compare("culled image against unculled", imgs[None].reshape(-1),
                    off.reshape(-1))
        full, stats = _render_with(cell, chk, with_stats=True)
        if cell.multi_phase:
            one, one_stats = _render_with(cell._replace(config=(
                tile, block, (), None)), chk, with_stats=True)
            chk.compare("multi-phase image against single-phase",
                        full.reshape(-1), one.reshape(-1))
            for key in ("slot_tests", "ray_bounces", "cull_rows"):
                if stats[key] != one_stats[key]:
                    raise SmokeError(f"{name}: multi-phase {key} "
                                     f"{stats[key]} != {one_stats[key]}")
        log(f"[kernel=plain] {name} {size}x{size} C={ps.n_clusters} "
            f"CB={ps.aabbT.shape[0]}: {chk.checks} bit-equal comparisons, "
            f"launches by lanes per ray {chk.route_checks} "
            f"(K1e scanline+block d1, culled = unculled at d1, d{cell.depth}"
            f" config {cell.config}; counters {stats['slot_tests']} slot "
            f"tests, {stats['cull_rows']} cull rows) in "
            f"{time.perf_counter() - t0:.1f} s")
        checkers[name] = chk
    return checkers


def _diff_scene(port, name: str, size: int, cluster_width=None):
    """A scene's or soup's spheres and camera on the card, as a user of the
    fwd+bwd engine passes them, the engine's layout (at ``cluster_width``)
    and the class config of its default (128-wide) layout."""
    from raytracers_tpu_torch.geometry import camera
    from raytracers_tpu_torch.render.api import pallas_diff_config
    from raytracers_tpu_torch.render.megakernel import build_pallas_scene
    if name in SOUPS:
        spheres, cam = _soup(name)
    else:
        sc = port.scenes.by_name(name)
        spheres = sc.spheres
        cam = camera(sc.look_from, sc.look_at, (0.0, 1.0, 0.0), sc.fov, 1.0)
    layout = build_pallas_scene(spheres, cluster_width=cluster_width)
    default = (layout if cluster_width is None
               else build_pallas_scene(spheres))
    return spheres, cam, layout, pallas_diff_config(default.n_clusters)


def _grads(f, spheres, cam, weight=None):
    """One fwd+bwd step: loss = sum(f(spheres, cam) ** 2), each pixel times
    ``weight`` if given, backward; returns the image and the gradients
    (centre, radius, colour, then the camera's origin, llc, horizontal,
    vertical)."""
    from raytracers_tpu_torch.geometry import Camera, Spheres
    sph = Spheres(*(t.detach().requires_grad_(True) for t in spheres))
    c = Camera(*(t.detach().requires_grad_(True) for t in cam))
    img = f(sph, c)
    (img * img if weight is None else img * img * weight).sum().backward()
    return img.detach(), [t.grad for t in (*sph, *c)]


def phase_diff_kernels_vs_plain(port) -> dict:
    """K1d and K2 against their plain versions at CHECK_SIZE, and on the
    20k-sphere soup (K1d's two-level cull) at SOUP20K_CHECK_SIZE; returns
    the checkers by scene."""
    import torch
    from raytracers_tpu_torch.grad import replay_bwd as rb
    from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
    from raytracers_tpu_torch.render import megakernel as mk
    checkers = {}
    for name in SCENES + ("soup20k",):
        size, depth = ((SOUP20K_CHECK_SIZE, SOUP20K_DEPTH) if name in SOUPS
                       else (CHECK_SIZE, DEPTH))
        spheres, cam, ps, (tile, block, schedule, prefix) = _diff_scene(
            port, name, size)
        k1 = Checked(mk, f"{name} {size}x{size} K1d")
        k2 = CheckedK2(f"{name} {size}x{size}")
        # K1d single-phase, scanline and block, and multi-phase
        cols = {}
        for blk in (None, block):
            cols[blk], _, rec, pay = mk.render_pallas_record(
                ps, cam, size, size, max_depth=depth, tile=tile,
                with_pay=True, block=blk, kernel=k1)
        k1.compare("block-tiled colours against scanline",
                   cols[block].reshape(-1), cols[None].reshape(-1))
        two, _ = mk.render_pallas_record_twophase(
            ps, cam, size, size, max_depth=depth, tile=tile, block=block,
            schedule=schedule, sort_prefix=prefix, kernel=k1)
        k1.compare("multi-phase colours against single-phase",
                   two.reshape(-1), cols[block].reshape(-1))
        # K2's replayed colours against K1d's, full depth, block tiles
        ro = mk._ray_order(cam, size, size, tile, block, 0.0, None, depth)
        gcot = torch.zeros(rb.N_GCOT, ro.n_rays, device=rec.device)
        _, _, fwd = k2(ro.params, rec, pay, gcot, tile=tile,
                       block_tiled=True, emit_fwd=True)
        rep = mk._to_image(ro, fwd, size, size).permute(1, 2, 0)
        k1.compare(f"K2 replayed colours against K1d's at depth {depth}",
                   rep.reshape(-1), cols[block].reshape(-1))
        # the engine whole-path and at the class config, every launch of
        # both kernels checked; the segmented gradient against the
        # whole-path one within the slot tables' summation slack
        whole = make_render_pallas_diff(size, size, max_depth=depth,
                                        tile=tile, block=block,
                                        fwd_kernel=k1, bwd_kernel=k2)
        seg = make_render_pallas_diff(size, size, max_depth=depth, tile=tile,
                                      block=block, schedule=schedule,
                                      sort_prefix=prefix, fwd_kernel=k1,
                                      bwd_kernel=k2)
        img1, g1 = _grads(whole, spheres, cam)
        img2, g2 = _grads(seg, spheres, cam)
        k1.compare("segmented engine colours against whole-path",
                   img2.reshape(-1), img1.reshape(-1))
        for a, b in zip(g1, g2):
            if not torch.isfinite(a).all() or a.abs().max() == 0:
                raise SmokeError(f"{name}: a whole-path gradient is not "
                                 f"finite or is zero: max |g| "
                                 f"{float(a.abs().max())}")
            # per-ray cotangents are bit-equal; only the order of the slot
            # tables' sums differs
            rel = float((a - b).abs().max() / a.abs().max())
            if rel > 1e-3:
                raise SmokeError(f"{name}: segmented gradient differs from "
                                 f"the whole-path one by {rel} of its max")
        log(f"[kernel=plain] {name} {size}x{size}: K1d {k1.checks} (launches "
            f"by lanes per ray {k1.route_checks}) and K2 "
            f"{k2.checks} comparisons (records and pay bit-equal, per-ray "
            f"cotangents and carries bit-equal, slot tables within "
            f"{k2.table_err_share:.3f} of their bound; schedule {schedule} "
            f"prefixes {prefix}; replayed colours bit-equal at d{depth})")
        checkers[name] = (k1, k2)
    return checkers


def _golden_check(what: str, img, fname: str, max_mis: float,
                  max_delta: float) -> None:
    import numpy as np
    from raytracers_tpu_torch.image import pixel_to_rgb, read_ppm
    img = img.cpu().numpy()
    ref = read_ppm(str(ROOT / "tests" / "golden" / fname))
    mis = float((img != ref).mean())
    delta = float(np.abs(pixel_to_rgb(img).astype(np.int32)
                         - pixel_to_rgb(ref).astype(np.int32)).mean())
    log(f"[golden] {what} {fname}: mismatch {mis} (limit {max_mis}), "
        f"mean |drgb| {delta} (limit {max_delta})")
    if mis > max_mis or delta > max_delta:
        raise SmokeError(f"{what}: golden {fname} out of tolerance")


def phase_goldens(port) -> dict:
    """Phase 4: the port's render against the goldens, then the native
    oracle, built by the port's loader on this host: the six goldens bit
    for bit, the card's 1000x1000 renders against it (depth 50 within the
    golden tolerances, every depth-1 pixel that differs explained), and its
    render times.  Returns the oracle's ms a render by scene."""
    from raytracers_tpu_torch.render.api import render
    preps = {}
    for name, depth, fname, max_mis, max_delta in GOLDENS:
        prep = preps.get(name) or _prepare(port, name, CHECK_SIZE)
        preps[name] = prep
        img = render(prep, CHECK_SIZE, CHECK_SIZE, mode="pallas",
                     max_depth=depth)
        _golden_check("render(mode='pallas')", img, fname, max_mis,
                      max_delta)
    return _native_oracle(port)


def _native_oracle(port) -> dict:
    import numpy as np
    import torch
    from raytracers_tpu_torch import native
    from raytracers_tpu_torch.image import read_ppm
    from raytracers_tpu_torch.render.api import render
    t0 = time.perf_counter()
    try:
        lib = native.build()
    except native.NativeUnavailable as e:
        raise SmokeError(f"the native oracle did not build: {e}") from e
    cpu = native.host_cpu()
    log(f"[native] {Path(lib).relative_to(ROOT)}: "
        f"{' '.join([native.CXX, *native.CXXFLAGS])}, "
        f"{time.perf_counter() - t0:.2f} s, on the host CPU {cpu}")
    scenes = {name: port.scenes.by_name(name, device="cpu")
              for name in SCENES}

    def oracle(name, side, depth):
        sc = scenes[name]
        return native.render(sc.spheres, sc.look_from, sc.look_at, sc.fov,
                             side, side, max_depth=depth)

    for name, depth, fname in NATIVE_GOLDENS:
        n = int((oracle(name, CHECK_SIZE, depth)
                 != read_ppm(str(ROOT / "tests" / "golden" / fname))).sum())
        log(f"[native] golden {fname}: {n} pixels differ")
        if n:
            raise SmokeError(f"the native oracle does not reproduce {fname}")

    native_ms = {}
    for name in SCENES:
        prep = _prepare(port, name, SIZE)
        for depth in (1, DEPTH):
            img = render(prep, SIZE, SIZE, mode="pallas",
                         max_depth=depth).cpu()
            nat = oracle(name, SIZE, depth)
            n, share, delta = _image_gap(img, torch.from_numpy(nat))
            what = f"{name} {SIZE}x{SIZE} d{depth}"
            if depth == DEPTH:
                max_mis, max_delta = _golden_limits(name)
                log(f"[native] {what}: render(mode='pallas') on the card "
                    f"differs from the oracle on {n} pixels ({share}, limit "
                    f"{max_mis}), mean |drgb| {delta} (limit {max_delta})")
                if share > max_mis or delta > max_delta:
                    raise SmokeError(f"{what}: out of the golden tolerances "
                                     "against the native oracle")
                continue
            if n > NATIVE_MAX_DEPTH1_PIXELS:
                raise SmokeError(f"{what}: {n} pixels differ from the "
                                 f"oracle, more than the "
                                 f"{NATIVE_MAX_DEPTH1_PIXELS} a few-ulp ray "
                                 "gap could move")
            img = img.numpy()
            found = native.explain_depth1(
                scenes[name].spheres, prep.cam, SIZE, SIZE,
                np.argwhere(img != nat), img, nat)
            kinds = {}
            for e in found:
                kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
            log(f"[native] {what}: {n} pixels differ from the oracle, by "
                f"kind {kinds}; the first: {json.dumps(found[:4])}")
            bad = [e for e in found if e["kind"] is None]
            if bad:
                raise SmokeError(f"{what}: {len(bad)} differing pixels are "
                                 f"not explained, the first {bad[0]}")
        sc = scenes[name]
        bvh_ms, render_ms, img = native.bench(
            sc.spheres, sc.look_from, sc.look_at, sc.fov, SIZE, SIZE,
            max_depth=DEPTH, runs=NATIVE_RUNS)
        if not np.array_equal(img, nat):
            raise SmokeError(f"{name}: native.bench's image differs from "
                             "native.render's")
        native_ms[name] = render_ms
        log(f"[native] {name} {SIZE}x{SIZE} d{DEPTH}: the oracle renders in "
            f"{render_ms:.3f} ms (BVH {bvh_ms:.3f} ms), mean of "
            f"{NATIVE_RUNS}, on the host CPU {cpu}")
    return native_ms


def _k1_ops(stats: dict, ps, hits: int, mirrors: int = 0,
            far_root: bool = True) -> float:
    """K1's lane operations for its counted work on layout ``ps``: the
    slot tests at the launch's search, every AABB row, the occlusion gate
    once a visit where the layout's launches gate, every bounce at what one
    to the sky costs and ``hits`` of them, ``mirrors`` of those, at what
    they cost more (csrc/megakernel.cu's header)."""
    from raytracers_tpu_torch.render import megakernel as mk
    visits = (stats["slot_tests"] / ps.cluster_width
              if mk._kernel_flags(ps).occl else 0)
    return (stats["slot_tests"] * (OPS_PER_SLOT if far_root
                                   else OPS_PER_SLOT_NEAR)
            + stats["cull_rows"] * OPS_PER_CULL_ROW + visits * OPS_PER_GATE
            + stats["ray_bounces"] * OPS_PER_BOUNCE + hits * OPS_PER_HIT
            + mirrors * OPS_PER_MIRROR)


def _k1_bound(stats: dict, ps, n_phases: int, n_rays: int,
              far_root: bool = True):
    """Least time K1 could take for one render's counted work: operations
    over the FP32 lane-op rate, or the bytes over HBM (the ray state each
    phase must read and write, the scene's tables read once), whichever is
    larger.  A slot test costs what the launch's search costs; a ray ends on
    the sky at most once, so at least the bounces less the rays hit."""
    hits = max(stats["ray_bounces"] - n_rays, 0)
    ops = _k1_ops(stats, ps, hits, far_root=far_root)
    nbytes = STATE_BYTES * n_rays * (2 * n_phases - 1) + _table_bytes(ps)
    ops_ms = ops / FP32_LANE_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def _table_bytes(ps) -> int:
    """The bytes of the tables K1 reads: spheres, cluster AABBs, unions."""
    return sum(t.numel() * 4 for t in (ps.sphT, ps.aabbT, ps.superT))


class WarpWork:
    """K1 with its counters on, summing per launch the sphere rows tested
    and, for each warp of 32 consecutive rays, 32 times its busiest lane's:
    their ratio bounds the share of the warps' visit work done by active
    lanes from above (lanes that visit different clusters serialise, so the
    true share is lower)."""

    def __init__(self, mk):
        self.mk, self.slots, self.warp_slots = mk, 0, 0

    def __call__(self, *args, **kw):
        out = self.mk.megakernel(*args, **dict(kw, with_stats=True))
        per_ray = out[1][0].long()
        self.slots += int(per_ray.sum())
        self.warp_slots += WARP * int(per_ray.view(-1, WARP).amax(1).sum())
        return out

    def share(self) -> float:
        return self.slots / max(self.warp_slots, 1)


def _log_routes(what: str, turns: dict) -> None:
    """One ``[routes]`` line: each phase's K1 ms on both routes and the
    route the rule chose, then the totals."""
    phases = ", ".join(
        f"{k}: thread {t:.4f} warp {w:.4f} rule {l}"
        for k, (t, w, l) in enumerate(zip(turns["thread_phase_ms"],
                                          turns["warp_phase_ms"],
                                          turns["rule_lanes"])))
    log(f"[routes] {what}: {phases}; K1 ms rule {turns['rule_ms']:.4f}, "
        f"all thread {turns['thread_ms']:.4f}, all warp "
        f"{turns['warp_ms']:.4f}, faster route each launch "
        f"{turns['best_ms']:.4f}")


def _counted(mk, fn):
    """``fn()`` under the port's launch counts (``utils.trace.counting``
    without ``stats``, so every kernel runs as on the main path): its
    result, K1's launches, K1's launches by lanes per ray, K2's launches
    and the layout's launches by stage."""
    import torch
    from raytracers_tpu_torch.utils.trace import counting
    with counting(stats=False) as c:
        out = fn()
    torch.cuda.synchronize()
    n = c.read()
    k1 = n.get("k1.launches", {})
    return (out, k1.get("total", 0),
            {lanes: k1.get(f"lanes{lanes}", 0) for lanes in mk.LANES},
            n.get("k2.launches", {}).get("total", 0),
            n.get("layout.launches", {}))


def _check_routes(what: str, routes: dict, rule_lanes) -> None:
    """The main path's launches by route must be those the rule gives."""
    want = {lanes: 0 for lanes in routes}
    for lanes in rule_lanes:
        want[lanes] += 1
    if routes != want:
        raise SmokeError(f"{what}: K1 launches by lanes per ray {routes}, "
                         f"the rule gives {want}")


def _dead_launch_ms(mk, ps, cell) -> dict:
    """What a continuation whose rays are all dead costs on each route: one
    launch over the cell's padded rays with every ray inactive, timed with
    CUDA events; its outputs are the inputs copied through."""
    import torch
    from raytracers_tpu_torch.utils.timing import cuda_ms
    tile, block = cell.config[:2]
    ro = mk._ray_order(cell.cam, cell.size, cell.size, tile, block, 0.0,
                       None, cell.depth)
    st = torch.zeros(mk.N_STATE, ro.n_rays, device=ro.params.device)
    out = {}
    for lanes in mk.LANES:
        def launch(lanes=lanes):
            return mk.megakernel(ps, ro.params, ro.n_rays, tile, state_in=st,
                                 emit_state=True, with_stats=True,
                                 _lanes=lanes)
        got, stats = launch()
        if not torch.equal(got, st) or stats.any():
            raise SmokeError(f"{cell.name}: an all-dead continuation on "
                             f"{lanes} lanes per ray changed its rays")
        out[lanes] = cuda_ms(launch, warmup=1, runs=REPEATS)
    return out


def _log_native_beside_card(native_ms: dict, results) -> None:
    """The native oracle's render times (the host CPU's) beside the card's
    ``render_ms`` of the same cells."""
    from raytracers_tpu_torch import native
    card, cpu = _smi(), native.host_cpu()
    for r in results:
        if r["scene"] in native_ms:
            log(f"[native] {r['scene']} {r['size']}x{r['size']} "
                f"d{r['depth']}: render_ms {r['render_ms_mean']:.4f} on the "
                f"card ({card}); the native oracle "
                f"{native_ms[r['scene']]:.3f} ms on the host CPU ({cpu})")


def _replayed_k1(mk, what: str, render: Callable, n_phases: int) -> tuple:
    """K1's launches in a replayed frame of ``render()``, as the device ran
    them: torch.profiler's ``megakernel<`` kernels tied to each
    ``rt.phase<k>`` span of the second of two replayed frames, a list by
    phase, and by lanes per ray (the kernel's last template argument).
    Late in a long process the profiler has missed the first 17-19 device
    operations after its start (the first frame's K1 launch of phase 0
    among them), so the first frame is not read.  A replay's own
    ``k1.launches`` are what its capture counted, added again, and show
    nothing of what ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from raytracers_tpu_torch.utils.trace import counting
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with counting(stats=False) as c:
            for _ in range(2):
                render()
        torch.cuda.synchronize()
    route = c.read()["render.graph"]
    if route != {"total": 2, "replay": 2}:
        raise SmokeError(f"{what}: the profiled frames' routes are {route}, "
                         "not two replays")
    last = {}
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CPU
                     and e.name.startswith("rt.")),
                    key=lambda e: e.time_range.start):
        k1 = [k.name for k in e.kernels if "megakernel<" in k.name]
        if k1 and not e.name.startswith("rt.phase"):
            raise SmokeError(f"{what}: a replayed K1 launch is tied to "
                             f"{e.name}")
        if e.name.startswith("rt.phase"):
            last[int(e.name[len("rt.phase"):])] = k1
    per_phase = [len(last.get(k, ())) for k in range(n_phases)]
    by_lanes = {lanes: 0 for lanes in mk.LANES}
    for name in (n for k1 in last.values() for n in k1):
        args = name.split("megakernel<", 1)[1].split(">", 1)[0]
        lanes = int(re.search(r"(\d+)\s*$", args).group(1))
        by_lanes[lanes] = by_lanes.get(lanes, 0) + 1
    return per_phase, by_lanes


def _replayed_launches(mk, what: str, render: Callable,
                       n_phases: int) -> tuple:
    """Where the counted frame captured the frame's graphs: K1's launches
    of a frame that replays them, and by lanes per ray, from the device;
    once a phase, each tied to its phase's span."""
    per_phase, routes = _replayed_k1(mk, what, render, n_phases)
    if per_phase != [1] * n_phases:
        raise SmokeError(f"{what}: a replayed frame launched K1 {per_phase} "
                         "times a phase, not once each")
    return n_phases, routes


def _graph_turns(mk, cell: Cell, checker) -> dict:
    """The cell's frame replayed from its CUDA graphs against the same frame
    with its launches run one by one: bit-equal, then each timed in turns
    (graph, eager, eager, graph; REPEATS frames a turn, CUDA events).
    Returns the mean ms of each."""
    from raytracers_tpu_torch.utils.timing import cuda_ms
    from raytracers_tpu_torch.utils.trace import counting
    eager = mk.megakernel_eager
    with counting(stats=False) as c:
        graph_img = cell.render()
    route = c.read()["render.graph"]
    if route != {"total": 1, "replay": 1}:
        raise SmokeError(f"{cell.name}: the timed frame's route is {route}, "
                         "not a replay")
    checker.compare("frame replayed from its graphs against the eager one",
                    graph_img.reshape(-1),
                    _render_with(cell, eager).reshape(-1))
    runs = {"graph": cell.render, "eager": lambda: _render_with(cell, eager)}
    ms = {"graph": [], "eager": []}
    for which in ("graph", "eager", "eager", "graph"):
        ms[which].append(cuda_ms(runs[which], warmup=1, runs=REPEATS))
    out = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"[graphs] {cell.name} {cell.size}x{cell.size} d{cell.depth}: frame "
        f"replayed from its graphs bit-equal to the eager one; ms a frame "
        f"(graph, eager, eager, graph) {ms['graph'][0]:.4f} "
        f"{ms['eager'][0]:.4f} {ms['eager'][1]:.4f} {ms['graph'][1]:.4f}: "
        f"graph {out['graph']:.4f}, eager {out['eager']:.4f}")
    return out


def phase_main_path(port, name: str, checker) -> dict:
    import torch
    from raytracers_tpu_torch.render import megakernel as mk
    from raytracers_tpu_torch.utils.timing import cuda_ms
    from raytracers_tpu_torch.utils.trace import counting
    prep_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cell = _cell(port, name)
        torch.cuda.synchronize()
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    ps, n_phases, size = cell.ps, cell.n_phases, cell.size
    tile, block, schedule, prefix = cell.config

    img = cell.render()                # warm-up, and the main path's image
    torch.cuda.synchronize()
    counted, launches, routes, _, layout = _counted(mk, cell.render)
    with counting():                            # K1's counting variant
        with_stats = cell.render()
    for what, other in (("counted", counted),
                        ("with K1's counters", with_stats)):
        if not torch.equal(other, img):
            raise SmokeError(f"{name}: the image {what} differs from the "
                             "uncounted render's")
    if cell.multi_phase:
        launches, routes = _replayed_launches(mk, name, cell.render,
                                              n_phases)
    if launches != n_phases:
        raise SmokeError(f"{name}: the main path launched K1 {launches} "
                         f"times, not {n_phases}")
    if layout:
        raise SmokeError(f"{name}: a frame built the layout again: "
                         f"{layout}")
    if img.shape != (size, size) or img.dtype != torch.int32:
        raise SmokeError(f"{name}: image {tuple(img.shape)} {img.dtype}")

    # three rounds of REPEATS renders, each timed as one event pair
    render_ms = [cuda_ms(cell.render, warmup=0, runs=REPEATS)
                 for _ in range(3)]
    mean_ms = sum(render_ms) / len(render_ms)
    graph_ms = (_graph_turns(mk, cell, checker) if cell.multi_phase
                else None)

    turns = route_turns(mk, n_phases, lambda k: _render_with(cell, k),
                        ROUTE_REPS)
    _check_routes(name, routes, turns["rule_lanes"])
    _log_routes(f"{name} render", turns)
    k1_phase_ms = turns["rule_phase_ms"]
    k1_ms = turns["rule_ms"]
    dead = _dead_launch_ms(mk, ps, cell) if cell.multi_phase else None

    profiled = device_profile(cell.render)
    if profiled is None:
        log(f"[main] {name}: torch.profiler saw no device kernels")

    # the counters of the same render (render_stats for the API cells)
    warps = WarpWork(mk)
    _, stats = _render_with(cell, warps, with_stats=True)
    bound_ms, bound_by = _k1_bound(stats, ps, n_phases, cell.n_rays)

    plain = Timed(mk.megakernel_reference, n_phases)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_img = _render_with(cell, plain)
    torch.cuda.synchronize()
    plain_render_ms = (time.perf_counter() - t0) * 1e3
    plain_ms = sum(plain.phase_ms())
    checker.compare(f"{size}x{size} image against the plain render",
                    img.reshape(-1), plain_img.reshape(-1))
    # a soup's rays fill the card's resident warps only in part: the same
    # render at twice the side (4x the rays) shows how far its time is set
    # by the rays in flight rather than by their work, and its one launch
    # on both routes places the rule's threshold (WARP_BELOW_RAYS) between
    # measured launches
    ms_2x = turns_2x = None
    if name in SOUPS:
        cell_2x = _cell(port, name, size=2 * size)
        ms_2x = cuda_ms(cell_2x.render, warmup=1, runs=3)
        turns_2x = route_turns(mk, 1, lambda k: _render_with(cell_2x, k),
                               ROUTE_REPS)
        _log_routes(f"{name} render at {2 * size}x{2 * size} "
                    f"({cell_2x.n_rays} rays)", turns_2x)

    res = dict(scene=name, size=size, depth=cell.depth,
               clusters=ps.n_clusters, cull_blocks=ps.aabbT.shape[0],
               tile=tile, block=block, schedule=schedule,
               sort_prefix=prefix, prepare_ms=prep_ms, render_ms=render_ms,
               render_ms_mean=mean_ms, graph_turns_ms=graph_ms,
               mrays_per_s=size * size / mean_ms / 1e3,
               k1_launches=launches, k1_route_launches=routes,
               k1_phase_ms=k1_phase_ms, k1_ms=k1_ms,
               k1_routes=turns, all_dead_continuation_ms=dead,
               sort_and_glue_ms=mean_ms - k1_ms,
               slot_tests=stats["slot_tests"],
               ray_bounces=stats["ray_bounces"],
               cull_rows=stats["cull_rows"],
               phase_slot_tests=stats.get("phase_slot_tests"),
               thread_route_warp_lane_share_bound=warps.share(),
               k1_bound_ms=bound_ms, k1_bound_by=bound_by,
               k1_bound_share=bound_ms / k1_ms,
               plain_k1_ms=plain_ms, plain_render_ms=plain_render_ms,
               render_ms_twice_the_side=ms_2x,
               k1_routes_twice_the_side=turns_2x, profile=profiled)
    log(f"[main] {json.dumps(res)}")
    return res


class Counted:
    """K1d with its counters (K1c) on, keeping each launch's counter sums,
    depth and number of bounce records: the work the bound counts."""

    def __init__(self, mk):
        self.mk = mk
        self.launches = []

    def __call__(self, *args, **kw):
        out = self.mk.megakernel(*args, **dict(kw, with_stats=True))
        rec = out[2]
        self.launches.append(dict(self.mk._stats_dict(out[1]),
                                  depth=rec.shape[0],
                                  bounces=int((rec >= 0).sum()),
                                  misses=int((rec == -1).sum()),
                                  ends=int(((rec == -1) | (rec == -3)).sum()),
                                  live=int((rec[0] != -2).sum())))
        return out


class Captured:
    """K2, keeping each launch's inputs (for the library call's timing)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)

    def segments(self):
        """The launches by segment (the engine runs the deepest first)."""
        return self.calls[::-1]


class PlainK2:
    """K2's plain version on the card, timed, summing per slot the float64
    magnitudes and the number of the per-bounce cotangents (the scale of the
    kernel's summation-order bound)."""

    def __init__(self, n_slots: int, timed):
        from raytracers_tpu_torch.grad import replay_bwd as rb
        self.rb, self.n_slots, self.timed = rb, n_slots, timed
        self.mag = self.count = 0.0

    def _plain(self, params, rec, pay, gcot, **kw):
        step, ray, fwd = self.rb.replay_bwd_reference(
            params, rec, pay, gcot, **dict(kw, reduce_slots=None))
        return step, self.rb.slot_table(rec, step, self.n_slots), ray, fwd

    def __call__(self, params, rec, pay, gcot, **kw):
        step, exact, ray, fwd = self.timed(self._plain, params, rec, pay,
                                           gcot, **kw)
        _, mag, count = _slot_bound(rec, step, self.n_slots)
        self.mag = self.mag + mag
        self.count = self.count + count
        return exact.float(), ray, fwd


def _k1d_bound(launches, ps, n_rays: int):
    """Least time of one step's K1d launches on layout ``ps``: K1's
    operation count from the counters, with the hits and mirror bounces the
    records tell, or the bytes (ray state in and out of each phase, the
    records and the pay at bounces) over HBM, whichever is larger."""
    stats = {k: sum(l[k] for l in launches)
             for k in ("slot_tests", "cull_rows", "ray_bounces", "misses",
                       "bounces")}
    ops = _k1_ops(stats, ps, stats["ray_bounces"] - stats["misses"],
                  mirrors=stats["bounces"])
    nbytes = (STATE_BYTES * n_rays * (2 * len(launches) - 1)
              + sum(4 * l["depth"] * n_rays + PAY_BYTES * l["bounces"]
                    for l in launches))
    ops_ms = ops / FP32_LANE_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes")), stats


def _k2_bound(launches, n_rays: int, n_slots: int):
    """Least time of one step's K2 launches for the paths this run
    recorded: the operations of each replayed step, or the bytes of each
    input read once and each output written once, whichever is larger.
    The bytes are the records up to each path's end, the pay at bounces,
    the image cotangent and carry (12 rows), a continuation's start state
    (9 rows), the ray cotangents or carry out (6 or 9 rows) and the slot
    table.  K2's scratch (o, d, light of every step, written in pass 1 and
    read back in pass 2) belongs to the design, not the function: its time
    at the HBM rate is returned beside the bound."""
    ops = sum(l["bounces"] * OPS_PER_K2_BOUNCE + l["ends"] * OPS_PER_K2_END
              for l in launches)
    nbytes = scratch = 0
    for k, l in enumerate(launches):
        steps = l["bounces"] + l["ends"]
        rows_in, rows_out = (12, 6) if k == 0 else (12 + 9, 9)
        nbytes += (4 * steps + PAY_BYTES * l["bounces"]
                   + 4 * (rows_in + rows_out) * l["live"]
                   + (4 + 4 * rows_out) * (n_rays - l["live"])
                   + 4 * 7 * n_slots)
        scratch += K2_SCRATCH_BYTES * steps
    ops_ms = ops / FP32_LANE_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound = ((ops_ms, "operations") if ops_ms >= bytes_ms
             else (bytes_ms, "bytes"))
    return bound, scratch / HBM_BYTES_PER_S * 1e3


def _index_add_ms(captured, n_slots: int) -> list[float]:
    """The library call for K2's slot reduction: one ``index_add_`` of each
    segment's per-bounce cotangents onto the slot table, timed with CUDA
    events on the main path's inputs, by segment.  Only the bounce steps'
    rows are added (the others carry zeros, and sending them to one slot
    would time the contention of that slot instead)."""
    import torch
    from raytracers_tpu_torch.grad import replay_bwd as rb
    from raytracers_tpu_torch.utils.timing import cuda_ms
    out = []
    for args, kw in captured.segments():
        step, _, _ = rb.replay_bwd(*args, **dict(kw, reduce_slots=None))
        ids = args[1].reshape(-1)
        bnc = ids >= 0
        src = step[:, :7].permute(0, 2, 1).reshape(-1, 7)[bnc].contiguous()
        idx = ids[bnc].long()
        del step
        tab = torch.zeros(n_slots, 7, dtype=torch.float32, device=src.device)
        out.append(cuda_ms(lambda: tab.index_add_(0, idx, src), warmup=1,
                           runs=3))
    return out


def _k2_groups(captured) -> list[dict]:
    """Per segment of the captured step: bounces, K2's atomic row-adds and
    warp iterations, from ``replay_bwd_model.warp_groups`` and from the
    kernel's counters (a launch on the same inputs), which must agree."""
    from raytracers_tpu_torch.grad import replay_bwd as rb
    from raytracers_tpu_torch.grad import replay_bwd_model as model
    out = []
    for s, (args, kw) in enumerate(captured.segments()):
        g = model.warp_groups(args[1])
        got = rb.replay_bwd(*args, counters=True, **kw)[3].tolist()
        if got != [g.row_adds, g.warp_iterations]:
            raise SmokeError(f"K2 segment {s}: counters {got}, the model's "
                             f"{[g.row_adds, g.warp_iterations]}")
        out.append(dict(bounces=g.bounces, row_adds=g.row_adds,
                        warp_iterations=g.warp_iterations,
                        conflict=g.conflict))
    return out


def _sphere_grad_check(name: str, ps, p_k2, n_phases: int, grads, plain):
    """Sphere gradients (centre, radius, colour) of the kernel engine
    against the plain engine's, whose K2 ran as ``p_k2`` (a ``PlainK2``):
    the kernel's slot tables sum in no fixed order, the plain engine's in
    float64, so per sphere they may differ by (count + 2 segments + 2) unit
    roundoffs of the sum of magnitudes, plus the subnormals flushed.
    Returns (|error|, bound, plain) per sphere and field, float64."""
    import torch
    ordv = ps.order.reshape(-1).long()
    real = ordv >= 0
    n_sph = grads[0].shape[0]
    f64 = dict(dtype=torch.float64, device=ordv.device)
    mag = torch.zeros(n_sph, 7, **f64).index_add_(0, ordv[real],
                                                  p_k2.mag[real])
    count = torch.zeros(n_sph, **f64).index_add_(0, ordv[real],
                                                 p_k2.count[real])
    bound = ((count[:, None] + 2 * n_phases + 2) * F32_EPS * mag
             + count[:, None] * F32_FTZ)
    got = torch.cat([grads[0], grads[1][:, None], grads[2]], 1).double()
    want = torch.cat([plain[0], plain[1][:, None], plain[2]], 1).double()
    err = (got - want).abs()
    if (err > bound).any():
        i = int((err > bound).nonzero()[0, 0])
        raise SmokeError(f"{name}: sphere {i}'s gradient {got[i].tolist()} "
                         f"against the plain {want[i].tolist()}, bound "
                         f"{bound[i].tolist()}")
    return err, bound, want


def phase_fwdbwd(port, name: str, cluster_width=None,
                 tag: str = "fwdbwd") -> dict:
    """The fwd+bwd main path at SIZE, depth DEPTH, the engine's layout at
    ``cluster_width``; the result is logged as a ``[tag]`` line."""
    import torch
    from raytracers_tpu_torch.grad import replay_bwd as rb
    from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
    from raytracers_tpu_torch.render import megakernel as mk
    from raytracers_tpu_torch.utils.timing import cuda_ms
    from raytracers_tpu_torch.utils.trace import counting
    spheres, cam, ps, (tile, block, schedule, prefix) = _diff_scene(
        port, name, SIZE, cluster_width)
    n_phases = len(schedule) + 1
    n_slots = ps.order.numel()
    cfg = dict(max_depth=DEPTH, tile=tile, block=block, schedule=schedule,
               sort_prefix=prefix, cluster_width=cluster_width)
    f = make_render_pallas_diff(SIZE, SIZE, **cfg)
    step = lambda: _grads(f, spheres, cam)                      # noqa: E731

    step()                                                      # warm-up
    counted_step, k1d_launches, routes, k2_launches, layout = _counted(
        mk, step)
    launches = (k1d_launches, k2_launches)
    with counting():                   # K1d's counting variant, K2's counters
        stats_step = step()
    # the main path's step, uncounted, and its peak (without the frame
    # graphs the renders before it keep)
    mk.release_graphs()
    torch.cuda.reset_peak_memory_stats()
    img, grads = step()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != (n_phases, n_phases):
        raise SmokeError(f"{name}: one fwd+bwd step launched K1d and K2 "
                         f"{launches} times, not {n_phases} each")
    if layout != LAYOUT_LAUNCHES:
        raise SmokeError(f"{name}: one fwd+bwd step launched the layout's "
                         f"stages {layout}, not {LAYOUT_LAUNCHES}")
    if img.shape != (SIZE, SIZE, 3) or not torch.isfinite(img).all():
        raise SmokeError(f"{name}: image {tuple(img.shape)} not finite")
    for g, what in zip(grads, ("centre", "radius", "colour", "origin",
                               "llc", "horizontal", "vertical")):
        if not torch.isfinite(g).all() or float(g.abs().max()) == 0.0:
            raise SmokeError(f"{name}: the {what} gradient is not finite "
                             "or is zero")

    fwdbwd_ms = [cuda_ms(step, warmup=0, runs=FB_REPEATS) for _ in range(3)]
    mean_ms = sum(fwdbwd_ms) / len(fwdbwd_ms)

    t_k2 = Timed(rb.replay_bwd, n_phases)
    turns = route_turns(mk, n_phases, lambda k: _grads(make_render_pallas_diff(
        SIZE, SIZE, fwd_kernel=k, bwd_kernel=t_k2, **cfg), spheres, cam),
        ROUTE_REPS)
    _check_routes(f"{name} fwd+bwd", routes, turns["rule_lanes"])
    _log_routes(f"{name} fwd+bwd K1d ({tag})", turns)
    k1d_ms, k2_ms = turns["rule_phase_ms"], t_k2.phase_ms()[::-1]  # by segment

    profiled = device_profile(step)
    if profiled is None:
        log(f"[fwdbwd] {name}: torch.profiler saw no device kernels")

    counted, captured = Counted(mk), Captured(rb.replay_bwd)
    _grads(make_render_pallas_diff(SIZE, SIZE, fwd_kernel=counted,
                                   bwd_kernel=captured, **cfg), spheres, cam)
    n_rays = (-(-SIZE // block[0]) * block[0]) * (-(-SIZE // block[1])
                                                  * block[1])
    (k1d_bound, k1d_by), stats = _k1d_bound(counted.launches, ps, n_rays)
    (k2_bound, k2_by), k2_scratch_ms = _k2_bound(counted.launches, n_rays,
                                                 n_slots)
    library_seg_ms = _index_add_ms(captured, n_slots)
    library_ms = sum(library_seg_ms)
    groups = _k2_groups(captured)
    del captured
    for s, (ms, gr, lib) in enumerate(zip(k2_ms, groups, library_seg_ms)):
        log(f"[{tag}] {name} K2 segment {s}: {ms:.4f} ms, {gr['bounces']} "
            f"bounces, {gr['row_adds']} row-adds, conflict factor "
            f"{gr['conflict']:.2f}, index_add_ {lib:.4f} ms")
    k2_conflict = (sum(g["bounces"] for g in groups)
                   / max(sum(g["row_adds"] for g in groups), 1))

    # the plain engine on the card: K1d's and K2's plain versions
    p_k1d = Timed(mk.megakernel_reference, n_phases)
    p_k2 = PlainK2(n_slots, Timed(lambda fn, *a, **kw: fn(*a, **kw),
                                  n_phases))
    f_plain = make_render_pallas_diff(SIZE, SIZE, fwd_kernel=p_k1d,
                                      bwd_kernel=p_k2, **cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_p, grads_p = _grads(f_plain, spheres, cam)
    torch.cuda.synchronize()
    plain_step_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(img.view(torch.int32), img_p.view(torch.int32)):
        raise SmokeError(f"{name}: the fwd+bwd image differs from the plain "
                         "engine's")
    sph_err, bound, want = _sphere_grad_check(name, ps, p_k2, n_phases,
                                              grads[:3], grads_p[:3])
    cam_rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(grads[3:], grads_p[3:]))
    if cam_rel > 1e-6:
        raise SmokeError(f"{name}: the camera gradient differs from the "
                         f"plain engine's by {cam_rel} of its max")
    # the counted steps: the image bit-equal to the uncounted step's, the
    # gradients within the same bounds of the plain engine's (K2's float32
    # atomics change their last bits from run to run)
    for what, (img_c, grads_c) in (("counted", counted_step),
                                   ("with the kernels' counters",
                                    stats_step)):
        if not torch.equal(img_c.view(torch.int32), img.view(torch.int32)):
            raise SmokeError(f"{name}: the fwd+bwd image {what} differs "
                             "from the uncounted step's")
        _sphere_grad_check(f"{name} ({what})", ps, p_k2, n_phases,
                           grads_c[:3], grads_p[:3])
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(grads_c[3:], grads_p[3:]))
        if rel > 1e-6:
            raise SmokeError(f"{name} ({what}): the camera gradient differs "
                             f"from the plain engine's by {rel} of its max")
    del counted_step, stats_step
    share = sph_err / torch.where(bound > 0, bound, 1.0)

    res = dict(scene=name, clusters=ps.n_clusters,
               cluster_width=ps.cluster_width, tile=tile, block=block,
               schedule=schedule, sort_prefix=prefix,
               fwdbwd_ms=fwdbwd_ms, fwdbwd_ms_mean=mean_ms,
               k1d_launches=launches[0], k2_launches=launches[1],
               k1d_route_launches=routes, k1d_routes=turns,
               k1d_phase_ms=k1d_ms, k2_segment_ms=k2_ms,
               k1d_ms=sum(k1d_ms), k2_ms=sum(k2_ms),
               glue_ms=mean_ms - sum(k1d_ms) - sum(k2_ms),
               peak_memory_gib=peak_gib,
               slot_tests=stats["slot_tests"],
               ray_bounces=stats["ray_bounces"], cull_rows=stats["cull_rows"],
               bounce_records=[l["bounces"] for l in counted.launches],
               k1d_bound_ms=k1d_bound, k1d_bound_by=k1d_by,
               k2_bound_ms=k2_bound, k2_bound_by=k2_by,
               k2_scratch_bytes_ms=k2_scratch_ms,
               k2_library_ms=library_ms,
               k2_library_segment_ms=library_seg_ms,
               k2_row_adds=[g["row_adds"] for g in groups],
               k2_warp_iterations=[g["warp_iterations"] for g in groups],
               k2_conflict=k2_conflict,
               plain_k1d_ms=sum(p_k1d.phase_ms()),
               plain_k2_ms=sum(p_k2.timed.phase_ms()),
               plain_step_ms=plain_step_ms,
               grad_max_abs=[float(g.abs().max()) for g in grads],
               sphere_grad_max_abs_err=float(sph_err.max()),
               sphere_grad_rel_err=float(sph_err.max() / want.abs().max()),
               sphere_grad_err_share_of_bound=float(share.max()),
               camera_grad_rel_err=cam_rel,
               loss=float((img * img).sum()), profile=profiled)
    log(f"[{tag}] {json.dumps(res)}")
    return res


# the example's runs: its defaults, then the main path's side and depth
EXAMPLE_RUNS = ((64, 8), (SIZE, DEPTH))


def phase_example(port) -> list:
    """``examples/pallas_gradients.py`` as a user runs it on the card
    (``main``): at its defaults and at SIZE, DEPTH, launches counted from
    zero around one run (K1d once a phase, K2 once a segment: one each at
    the example's single-segment engine), the run's host seconds, finite
    loss and gradients; at the defaults the gradients against the plain
    engine on the card, within phase 6's summation-order bound."""
    import torch
    from raytracers_tpu_torch.examples import pallas_gradients as ex
    from raytracers_tpu_torch.render import megakernel as mk
    out = []
    for side, depth in EXAMPLE_RUNS:
        argv = ["--res", str(side), "--depth", str(depth)]
        ex.main(argv)                                           # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        (loss, grads), k1d, routes, k2, _ = _counted(
            mk, lambda: ex.main(argv))
        launches = (k1d, k2)
        what = f"example {side}x{side} d{depth}"
        if launches != (1, 1):
            raise SmokeError(f"{what}: launched K1d and K2 {launches} "
                             "times, not once each")
        if not torch.isfinite(loss) or not all(
                torch.isfinite(g).all() for g in grads.values()):
            raise SmokeError(f"{what}: the loss or a gradient is not finite")
        res = dict(side=side, depth=depth, loss=float(loss),
                   seconds=seconds, k1d_launches=k1d,
                   k1d_route_launches=routes, k2_launches=launches[1],
                   grad_max_abs={k: float(g.abs().max())
                                 for k, g in grads.items()})
        if (side, depth) == EXAMPLE_RUNS[0]:
            res.update(_example_vs_plain(ex, mk, side, depth, loss, grads))
        log(f"[example] {json.dumps(res)}")
        out.append(res)
    return out


def _example_vs_plain(ex, mk, side, depth, loss, grads) -> dict:
    """The example's loss and gradients against the plain engine's (K1d's
    and K2's plain versions on the card): the loss equal, the sphere
    gradients within ``_sphere_grad_check``'s bound, the camera origin's
    within 1e-6 of its largest magnitude, as phase 6 holds them."""
    from raytracers_tpu_torch.render.megakernel import build_pallas_scene
    ps = build_pallas_scene(ex.scenes.rgbbox().spheres)  # the engine's
    p_k2 = PlainK2(ps.order.numel(), lambda fn, *a, **kw: fn(*a, **kw))
    p_loss, plain = ex.gradients(side, depth,
                                 fwd_kernel=mk.megakernel_reference,
                                 bwd_kernel=p_k2)
    what = f"example {side}x{side} d{depth}"
    if float(loss) != float(p_loss):
        raise SmokeError(f"{what}: loss {float(loss)} against the plain "
                         f"engine's {float(p_loss)}")
    keys = ("center", "radius", "color")
    err, bound, want = _sphere_grad_check(
        what, ps, p_k2, 1, [grads[k] for k in keys], [plain[k] for k in keys])
    cam_rel = float((grads["origin"] - plain["origin"]).abs().max()
                    / plain["origin"].abs().max())
    if cam_rel > 1e-6:
        raise SmokeError(f"{what}: the camera origin's gradient differs from "
                         f"the plain engine's by {cam_rel} of its max")
    share = err / bound.clamp(min=1e-300)
    return dict(sphere_grad_max_abs_err=float(err.max()),
                sphere_grad_err_share_of_bound=float(share.max()),
                camera_origin_grad_rel_err=cam_rel)


def phase_profiling(port) -> dict:
    """One main-path render (rgbbox) under ``utils.profiling.device_trace``:
    ``device_kernel_ms`` of the exported trace against the per-kernel sums
    of the same session's device events, to the trace's microsecond
    rounding a kernel; the session's other device events must be copies
    and sets.  The per-kernel times are printed beside the card's name and
    power limit."""
    import shutil
    from raytracers_tpu_torch.utils.profiling import (device_events,
                                                      device_kernel_ms,
                                                      device_trace)
    cell = _cell(port, "rgbbox")
    cell.render()                                               # warm-up
    trace_dir = ROOT / "build" / "traces"
    shutil.rmtree(trace_dir, ignore_errors=True)
    with device_trace(str(trace_dir)) as prof:
        cell.render()
    from_trace = device_kernel_ms(str(trace_dir))
    events, counts = {}, {}
    for e in device_events(prof):
        events[e.name] = events.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        counts[e.name] = counts.get(e.name, 0) + 1
    if not from_trace:
        raise SmokeError("the exported trace holds no device kernel")
    for name, ms in from_trace.items():
        if name not in events or abs(ms - events[name]) > counts[name] * 1e-3:
            raise SmokeError(f"kernel {name[:80]}: {ms} ms in the trace, "
                             f"{events.get(name)} ms in the session's events")
    others = {n: ms for n, ms in events.items() if n not in from_trace}
    if any(not n.startswith(("Memcpy", "Memset")) for n in others):
        raise SmokeError(f"device events missing from the trace's kernels: "
                         f"{sorted(others)[:5]}")
    res = dict(card=_smi(), scene=cell.name, size=cell.size,
               depth=cell.depth, trace_files=len(list(trace_dir.iterdir())),
               kernel_ms={n[:60]: ms for n, ms in sorted(
                   from_trace.items(), key=lambda kv: -kv[1])},
               kernel_ms_total=sum(from_trace.values()),
               copies_and_sets_ms=others)
    log(f"[profile] {json.dumps(res)}")
    return res


class CheckedK3:
    """K3 with each launch repeated by its plain version on the same inputs
    on the card; any bit of difference fails the phase.  ``paths`` counts
    the launches by the wrapper's path (shared or global geometry)."""

    def __init__(self, tr, label: str):
        self.tr, self.label = tr, label
        self.checks = 0
        self.max_abs_err = 0.0
        self.paths = {"shared": 0, "global": 0}

    def __call__(self, scene, params, n_rays, tile, **kw):
        from raytracers_tpu_torch.utils.trace import counting
        with counting(stats=False) as c:
            out = self.tr.traversal_kernel(scene, params, n_rays, tile, **kw)
        for path in self.paths:
            self.paths[path] += c.read()["k3.launches"].get(path, 0)
        ref, _ = self.tr.traversal_kernel_reference(scene, params, n_rays,
                                                    tile, **kw)
        self.max_abs_err = max(self.max_abs_err, _abs_err(out, ref, True))
        g = _first_diff(out, ref)
        if g is not None:
            raise SmokeError(f"{self.label}: K3 packed image differs first "
                             f"at ray {g}: kernel {int(out[g])} plain "
                             f"{int(ref[g])}")
        self.checks += 1
        return out


def _bvh_fields(bvh) -> dict:
    return dict(zip(("center", "radius", "color"), bvh.spheres),
                **{f: getattr(bvh, f) for f in bvh._fields[1:]})


def _traversal_cell(port, name: str):
    """A scene's (or a soup's) K3 tables on the card (default leaf size),
    C, K and the camera."""
    from raytracers_tpu_torch.geometry import camera
    from raytracers_tpu_torch.render import traversal as tr
    if name in SOUPS:
        sph, cam = _soup(name)
    else:
        sc = port.scenes.by_name(name)
        sph = sc.spheres
        cam = camera(sc.look_from, sc.look_at, (0.0, 1.0, 0.0), sc.fov, 1.0)
    scene, C, K = tr.build_traversal_scene(sph)
    return scene, C, K, cam


def phase_bvh_vs_plain(port) -> dict:
    """The BVH build on the card against the CPU build, validation, K3
    against its plain version, and K3 and ``render(mode="bvh")`` against
    the goldens.  Returns the K3 checkers by scene."""
    import torch
    from raytracers_tpu_torch.bvh.lbvh import build_bvh
    from raytracers_tpu_torch.geometry import Spheres
    from raytracers_tpu_torch.render import traversal as tr
    from raytracers_tpu_torch.render.api import prepare_scene, render
    from raytracers_tpu_torch.utils.validate import validate_bvh
    t0 = time.perf_counter()
    builds = [(name, port.scenes.by_name(name).spheres, 8)
              for name in ("rgbbox", "irreg", "plane")]
    soup = port.scenes.random_spheres(BVH_SOUP[0], seed=BVH_SOUP[1])
    builds += [("soup1m", soup, leaf) for leaf in BVH_LEAVES]
    for name, sph, leaf in builds:
        card = build_bvh(sph, leaf_size=leaf)
        host = build_bvh(Spheres(*(f.cpu() for f in sph)), leaf_size=leaf)
        for field, a in _bvh_fields(card).items():
            b = _bvh_fields(host)[field]
            if a.device != sph.center.device or not torch.equal(a.cpu(), b):
                raise SmokeError(f"build_bvh {name} leaf {leaf}: field "
                                 f"{field} differs from the CPU build")
        if name in SCENES:
            problems = validate_bvh(card)
            if problems:
                raise SmokeError(f"validate_bvh {name}: {problems}")
        log(f"[bvh=cpu] {name} leaf {leaf}: {card.n_leaves} leaves, every "
            f"field bit-equal to the CPU build"
            + (", validate_bvh clean" if name in SCENES else ""))
    del soup, builds

    size = CHECK_SIZE
    checkers = {}
    for name in (*SCENES, K3_GLOBAL):
        scene, C, K, cam = _traversal_cell(port, name)
        chk = CheckedK3(tr, f"{name} {size}x{size}")
        path = "shared" if tr.geometry_in_shared(C, K) else "global"
        if (path == "global") != (name == K3_GLOBAL):
            raise SmokeError(f"{name}: C={C} K={K} takes K3's {path} path")
        imgs = {}
        for far_root in (True, False):
            for depth in (1, DEPTH):
                for block in (None, (32, 16)):
                    imgs[far_root, depth, block] = tr.render_traversal(
                        scene, C, K, cam, size, size, max_depth=depth,
                        block=block, far_root=far_root, kernel=chk)
        if not torch.equal(imgs[True, 1, None], imgs[True, 1, (32, 16)]):
            raise SmokeError(f"{name}: K3 block-tiled image differs from "
                             "the scanline one at depth 1")
        if chk.paths[path] != chk.checks:
            raise SmokeError(f"{name}: K3 launches by path {chk.paths}, "
                             f"all {chk.checks} should be {path}")
        log(f"[kernel=plain] {name} {size}x{size} C={C} K={K}: K3 "
            f"{chk.checks} bit-equal comparisons on the {path} path "
            f"(far root on and off, scanline+block, d1/d{DEPTH})")
        checkers[name] = chk
        if name == K3_GLOBAL:
            continue
        imgs = {key[1:]: img for key, img in imgs.items() if key[0]}
        goldens = [g for g in GOLDENS if g[0] == name]
        prep = prepare_scene(port.scenes.by_name(name), size, size)
        for _, depth, fname, max_mis, max_delta in goldens:
            _golden_check(f"K3 {name} d{depth}", imgs[depth, (32, 16)],
                          fname, max_mis, max_delta)
            img = render(prep, size, size, mode="bvh", max_depth=depth)
            _golden_check(f"render(mode='bvh') {name} d{depth}", img, fname,
                          max_mis, max_delta)
    log(f"[bvh=cpu] phase 7 in {time.perf_counter() - t0:.1f} s")
    return checkers


def _k3_bound(stats: dict, table_bytes: int):
    """Least time of one K3 render for this run's counted work: the
    operations over the FP32 lane-op rate, or the bytes (the tables read
    once, the packed image written once) over HBM, whichever is larger."""
    count = dict(stats, hit_bounces=stats["ray_bounces"]
                 - stats["sky_bounces"])
    ops = sum(count[k] * n for k, n in K3_OPS.items())
    ops_ms = ops / FP32_LANE_OPS_PER_S * 1e3
    bytes_ms = (table_bytes + 4 * stats["rays"]) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def _k3_work(per_ray):
    """Each ray's lane operations by K3_OPS, from the plain version's
    per-ray counters (len(STATS), n)."""
    from raytracers_tpu_torch.render.traversal import STATS
    n = dict(zip(STATS, per_ray.double()))
    return (n["node_steps"] * K3_OPS["node_steps"]
            + n["slot_tests"] * K3_OPS["slot_tests"]
            + n["slot_roots"] * K3_OPS["slot_roots"]
            + n["far_roots"] * K3_OPS["far_roots"]
            + (n["ray_bounces"] - n["sky_bounces"]) * K3_OPS["hit_bounces"]
            + n["sky_bounces"] * K3_OPS["sky_bounces"] + K3_OPS["rays"])


def phase_bvh_main(port, checkers) -> list:
    """The BVH main path: the 1M-sphere build, ``render(mode="bvh")`` and
    K3 at SIZE, depth DEPTH, each result logged as a ``[bvh]`` line (K3
    also on the soup of its global-memory path).  Returns K3's results."""
    import torch
    from raytracers_tpu_torch.bvh.lbvh import build_bvh
    from raytracers_tpu_torch.render import traversal as tr
    from raytracers_tpu_torch.render.megakernel import _ray_order, _to_image
    from raytracers_tpu_torch.render.traversal_model import thread_warp_share
    from raytracers_tpu_torch.render.api import prepare_scene, render
    from raytracers_tpu_torch.utils.timing import cuda_ms
    from raytracers_tpu_torch.utils.trace import counting
    soup = port.scenes.random_spheres(BVH_SOUP[0], seed=BVH_SOUP[1])
    for leaf in BVH_LEAVES:
        fn = lambda leaf=leaf: build_bvh(soup, leaf_size=leaf)  # noqa: E731
        fn()                                                    # warm-up
        ms = [cuda_ms(fn, warmup=0, runs=1) for _ in range(3)]
        res = dict(what="build_bvh", spheres=BVH_SOUP[0], seed=BVH_SOUP[1],
                   leaf_size=leaf, leaves=-(-BVH_SOUP[0] // leaf),
                   build_ms=ms, build_ms_mean=sum(ms) / len(ms))
        log(f"[bvh] {json.dumps(res)}")
    del soup

    for name in SCENES:
        sc = port.scenes.by_name(name)
        prep_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prep = prepare_scene(sc, SIZE, SIZE)
            torch.cuda.synchronize()
            prep_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        img = render(prep, SIZE, SIZE, mode="bvh", max_depth=DEPTH)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        if img.shape != (SIZE, SIZE) or img.dtype != torch.int32:
            raise SmokeError(f"{name}: bvh image {tuple(img.shape)} "
                             f"{img.dtype}")
        with counting(stats=False) as c:
            ms = [cuda_ms(lambda: render(prep, SIZE, SIZE, mode="bvh",
                                         max_depth=DEPTH), warmup=0, runs=1)
                  for _ in range(2)]
        launched = {"k1.launches", "k3.launches"} & set(c.read())
        if launched:
            raise SmokeError(f"{name}: render(mode='bvh') launched a kernel "
                             f"({', '.join(sorted(launched))})")
        res = dict(what="render(mode='bvh')", scene=name, size=SIZE,
                   depth=DEPTH, leaf_size=8,
                   leaves=prep.bvh.n_leaves, warm_up_s=warm_s,
                   prepare_ms=prep_ms, render_ms=ms,
                   render_ms_mean=sum(ms) / len(ms),
                   mrays_per_s=SIZE * SIZE / (sum(ms) / len(ms)) / 1e3)
        log(f"[bvh] {json.dumps(res)}")

    k3 = []
    for name in (*SCENES, K3_GLOBAL):
        scene, C, K, cam = _traversal_cell(port, name)
        call = lambda: tr.render_traversal(scene, C, K, cam, SIZE,  # noqa
                                           SIZE, max_depth=DEPTH)
        call()                                                  # warm-up
        torch.cuda.synchronize()
        with counting(stats=False) as c:
            img = call()
        torch.cuda.synchronize()
        launches = c.read().get("k3.launches", {}).get("total", 0)
        if launches != 1:
            raise SmokeError(f"{name}: one K3 render launched K3 "
                             f"{launches} times")
        render_ms = [cuda_ms(call, warmup=0, runs=REPEATS)
                     for _ in range(3)]
        timed = Timed(tr.traversal_kernel, 1)
        for _ in range(REPEATS):
            tr.render_traversal(scene, C, K, cam, SIZE, SIZE,
                                max_depth=DEPTH, kernel=timed)
        k3_ms = timed.phase_ms()[0]
        # the kernel's warp rounds, in one more render
        counters = torch.zeros(len(tr.COUNTERS), dtype=torch.int64,
                               device="cuda")
        tr.render_traversal(
            scene, C, K, cam, SIZE, SIZE, max_depth=DEPTH,
            kernel=lambda *a, **kw: tr.traversal_kernel(
                *a, counters=counters, **kw))
        rounds = dict(zip(tr.COUNTERS, counters.tolist()))
        # the plain version, as traversal_reference runs it, with the
        # per-ray counters
        ro = _ray_order(cam, SIZE, SIZE, tr.DEFAULT_TILE, (32, 16), 0.0,
                        None, DEPTH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed, per_ray = tr.traversal_kernel_reference(
            scene, ro.params, ro.n_rays, tr.DEFAULT_TILE, n_clusters=C,
            leaf_size=K, max_depth=DEPTH, block_tiled=True)
        plain_img = _to_image(ro, packed, SIZE, SIZE)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        stats = dict(zip(tr.STATS, per_ray.sum(dim=1,
                                               dtype=torch.int64).tolist()),
                     rays=ro.n_rays)
        checkers[name].max_abs_err = max(
            checkers[name].max_abs_err,
            _abs_err(img.reshape(-1), plain_img.reshape(-1), True))
        g = _first_diff(img.reshape(-1), plain_img.reshape(-1))
        if g is not None:
            raise SmokeError(f"{name}: the {SIZE}x{SIZE} K3 image differs "
                             f"from the plain version's at pixel {g}")
        table_bytes = sum(t.numel() * t.element_size()
                          for t in (scene.inner, scene.leaf_skip,
                                    scene.spheres))
        bound_ms, bound_by = _k3_bound(stats, table_bytes)
        mean_ms = sum(render_ms) / len(render_ms)
        leaf_rounds = rounds["serial_rounds"] + rounds["split_rounds"]
        res = dict(what="K3 render_traversal", scene=name, size=SIZE,
                   depth=DEPTH, clusters=C, leaf_size=K, tile=512,
                   block=(32, 16), k3_launches=launches,
                   path=("shared" if tr.geometry_in_shared(C, K)
                         else "global"),
                   render_ms=render_ms, render_ms_mean=mean_ms,
                   mrays_per_s=SIZE * SIZE / mean_ms / 1e3, k3_ms=k3_ms,
                   **stats, k3_bound_ms=bound_ms, k3_bound_by=bound_by,
                   k3_bound_share=bound_ms / k3_ms, plain_ms=plain_ms,
                   thread_warp_lane_share=thread_warp_share(
                       _k3_work(per_ray)),
                   **{f"kernel_{k}": v for k, v in rounds.items()},
                   split_share_of_leaf_rounds=(rounds["split_rounds"]
                                               / max(leaf_rounds, 1)))
        log(f"[bvh] {json.dumps(res)}")
        k3.append(res)
    return k3


def _golden_limits(name: str):
    """The depth-DEPTH golden tolerances of a scene: (mismatch share, mean
    |drgb|)."""
    return next((m, d) for n, depth, _, m, d in GOLDENS
                if n == name and depth == DEPTH)


def _image_gap(img, ref) -> tuple:
    """Differing pixels, their share and the mean |drgb| of two packed
    images."""
    import torch
    diff = img != ref
    ch = [((img >> s) & 0xFF) - ((ref >> s) & 0xFF) for s in (16, 8, 0)]
    delta = float(torch.stack(ch).abs().double().mean())
    return int(diff.sum()), float(diff.double().mean()), delta


def _k1f_layout(sc, default_ps, width):
    """A scene's render layout at ``width`` (front to back, as
    prepare_scene builds it), or, for None, the prepared 128-wide one."""
    from raytracers_tpu_torch.render import megakernel as mk
    if width is None:
        return default_ps
    return mk.build_pallas_scene(sc.spheres, sort_origin=sc.look_from,
                                 cluster_width=width)


def _k1f_vs_plain(port) -> dict:
    """Phase 9's checks at CHECK_SIZE: K1 at W = 64 and 32, near root only,
    the forced gate and the compaction options, and K1d at W = 64, every
    launch bit-equal to its plain version; the engine at W = 64 with every
    K2 launch checked.  Returns the checkers by (mode, scene)."""
    import torch
    from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
    from raytracers_tpu_torch.render import megakernel as mk
    from raytracers_tpu_torch.render.api import pallas_config
    size = CHECK_SIZE
    checkers = {}
    for name in SCENES:
        t0 = time.perf_counter()
        prep = _prepare(port, name, size)
        sc = port.scenes.by_name(name)
        cam = prep.cam
        tile, block, schedule, prefix = pallas_config(prep.pallas.n_clusters)
        kw = dict(tile=tile, with_stats=True)
        two_kw = dict(max_depth=DEPTH, tile=tile, block=block,
                      schedule=schedule, sort_prefix=prefix)
        for mode, width, opts in (("W=64", 64, {}), ("W=32", 32, {}),
                                  ("near-root", None,
                                   dict(far_root=False))):
            ps = _k1f_layout(sc, prep.pallas, width)
            chk = Checked(mk, f"{name} {size}x{size} K1 {mode}")
            imgs = {}
            for depth in (1, DEPTH):
                for blk in (None, block):
                    imgs[depth, blk], _ = mk.render_pallas(
                        ps, cam, size, size, max_depth=depth, block=blk,
                        kernel=chk, **kw, **opts)
            chk.compare("block-tiled image against scanline",
                        imgs[1, block].reshape(-1), imgs[1, None].reshape(-1))
            two = mk.render_pallas_twophase(ps, cam, size, size, kernel=chk,
                                            **two_kw, **opts)
            chk.compare("multi-phase image against single-phase",
                        two.reshape(-1), imgs[DEPTH, block].reshape(-1))
            checkers[mode, name] = chk
        chk = Checked(mk, f"{name} {size}x{size} K1f options")
        one = mk.render_pallas(prep.pallas, cam, size, size, max_depth=DEPTH,
                               tile=tile, block=block)
        for opts in (dict(coherent=True, occl_cont=True),
                     dict(seg_tiles=8, tile2=512, lane_groups=2),
                     dict(coherent=True)):
            img = mk.render_pallas_twophase(prep.pallas, cam, size, size,
                                            kernel=chk, with_stats=True,
                                            **two_kw, **opts)[0]
            if "occl_cont" not in opts:
                chk.compare(f"{opts} image against one launch",
                            img.reshape(-1), one.reshape(-1))
        checkers["options", name] = chk

        # K1d and K2 at W = 64, on the engine's unsorted layout
        spheres, dcam, ps64, (dtile, dblock, dsched, dpref) = _diff_scene(
            port, name, size, 64)
        k1 = Checked(mk, f"{name} {size}x{size} K1d W=64")
        k2 = CheckedK2(f"{name} {size}x{size} W=64")
        for blk in (None, dblock):
            mk.render_pallas_record(ps64, dcam, size, size, max_depth=DEPTH,
                                    tile=dtile, with_pay=True, block=blk,
                                    kernel=k1)
        cfg = dict(max_depth=DEPTH, tile=dtile, block=dblock,
                   schedule=dsched, sort_prefix=dpref)
        img64, g64 = _grads(make_render_pallas_diff(
            size, size, cluster_width=64, fwd_kernel=k1, bwd_kernel=k2,
            **cfg), spheres, dcam)
        img128, g128 = _grads(make_render_pallas_diff(size, size, **cfg),
                              spheres, dcam)
        k1.compare("W=64 engine colours against W=128",
                   img64.reshape(-1), img128.reshape(-1))
        for a, b in zip(g128, g64):
            if not torch.isfinite(b).all() or b.abs().max() == 0:
                raise SmokeError(f"{name}: a W=64 engine gradient is not "
                                 "finite or is zero")
            rel = float((a - b).abs().max() / a.abs().max())
            if rel > 1e-3:
                raise SmokeError(f"{name}: the W=64 engine's gradient differs "
                                 f"from the W=128 one by {rel} of its max")
        checkers["K1d W=64", name] = k1
        checkers["K2 W=64", name] = k2
        log(f"[k1f] {name} {size}x{size}: K1 W=64/W=32/near-root "
            + "/".join(str(checkers[m, name].checks)
                       for m in ("W=64", "W=32", "near-root"))
            + f", options {chk.checks}, K1d W=64 {k1.checks}, K2 W=64 "
            f"{k2.checks} comparisons bit-equal (slot tables within "
            f"{k2.table_err_share:.3f} of their bound) in "
            f"{time.perf_counter() - t0:.1f} s")
    return checkers


# phase 9's render cells: name -> (cluster width, render_pallas_twophase
# options, the TPU kernel's lines the mode replaces, bit-equal to the
# default render)
K1F_CELLS = {
    "W=64": (64, {}, "634", False),
    "W=32": (32, {}, "634", False),
    "near-root": (None, dict(far_root=False), "672", False),
    "coherent+occl_cont": (None, dict(coherent=True, occl_cont=True), "725",
                           False),
    "seg_tiles+tile2+lane_groups": (
        None, dict(seg_tiles=8, tile2=512, lane_groups=2), "442", True),
}


def _k1f_cell(port, default: Cell, mode: str, checker, default_img) -> dict:
    """One render cell of phase 9 at SIZE, depth DEPTH, with the default
    render's config: launches, times, counters, bound, the image against
    the plain version (bit-equal) and against the default render."""
    import torch
    from raytracers_tpu_torch.render import megakernel as mk
    from raytracers_tpu_torch.utils.timing import cuda_ms
    width, opts, _, exact = K1F_CELLS[mode]
    name = default.name
    ps = _k1f_layout(port.scenes.by_name(name), default.ps, width)
    tile, block, schedule, prefix = default.config
    n_phases = default.n_phases

    def render(kernel=mk.megakernel, with_stats=False):
        return mk.render_pallas_twophase(
            ps, default.cam, SIZE, SIZE, max_depth=DEPTH, tile=tile,
            block=block, schedule=schedule, sort_prefix=prefix,
            with_stats=with_stats, kernel=kernel, **opts)

    render()                                                    # warm-up
    torch.cuda.synchronize()
    img, launches, routes, _, _ = _counted(mk, render)
    launches, routes = _replayed_launches(mk, f"{name} {mode}", render,
                                          n_phases)
    if launches != n_phases:
        raise SmokeError(f"{name} {mode}: the render launched K1 {launches} "
                         f"times, not {n_phases}")
    render_ms = [cuda_ms(render, warmup=0, runs=REPEATS) for _ in range(3)]
    mean_ms = sum(render_ms) / len(render_ms)
    turns = route_turns(mk, n_phases, render, ROUTE_REPS)
    _check_routes(f"{name} {mode}", routes, turns["rule_lanes"])
    _log_routes(f"{name} {mode}", turns)
    k1_phase_ms = turns["rule_phase_ms"]
    k1_ms = turns["rule_ms"]
    _, stats = render(with_stats=True)
    bound_ms, bound_by = _k1_bound(stats, ps, n_phases, default.n_rays,
                                   opts.get("far_root", True))
    plain = Timed(mk.megakernel_reference, n_phases)
    plain_img = render(plain)
    checker.compare(f"{SIZE}x{SIZE} {mode} image against the plain render",
                    img.reshape(-1), plain_img.reshape(-1))
    n_diff, share, delta = _image_gap(img, default_img)
    max_share, max_delta = (0.0, 0.0) if exact else _golden_limits(name)
    if share > max_share or delta > max_delta:
        raise SmokeError(f"{name} {mode}: {n_diff} pixels ({share}, mean "
                         f"|drgb| {delta}) differ from the default render, "
                         f"over ({max_share}, {max_delta})")
    res = dict(scene=name, mode=mode, size=SIZE, depth=DEPTH,
               cluster_width=ps.cluster_width, clusters=ps.n_clusters,
               cull_blocks=ps.aabbT.shape[0], options=opts, tile=tile,
               block=block, schedule=schedule, sort_prefix=prefix,
               render_ms=render_ms, render_ms_mean=mean_ms,
               mrays_per_s=SIZE * SIZE / mean_ms / 1e3,
               k1_launches=launches, k1_route_launches=routes,
               k1_phase_ms=k1_phase_ms, k1_ms=k1_ms, k1_routes=turns,
               sort_and_glue_ms=mean_ms - k1_ms,
               slot_tests=stats["slot_tests"],
               ray_bounces=stats["ray_bounces"],
               cull_rows=stats["cull_rows"],
               phase_slot_tests=stats["phase_slot_tests"],
               k1_bound_ms=bound_ms, k1_bound_by=bound_by,
               k1_bound_share=bound_ms / k1_ms,
               plain_k1_ms=sum(plain.phase_ms()),
               pixels_differing_from_default=n_diff,
               share_differing_from_default=share,
               mean_drgb_from_default=delta)
    log(f"[k1f] {json.dumps(res)}")
    return res


# the xla backward's cell: scene, ray chunks, the largest side a step may
# take and the time a step may take there before the side shrinks
XLA_SCENE, XLA_CHUNKS, XLA_MAX_STEP_S = "rgbbox", 8, 60.0
XLA_SIDES = (SIZE, 707, 500)
# tests/test_torch_pallas_diff.py's tolerances between the two backends,
# relative to the largest magnitude: centre, radius, colour, then the
# camera's origin, llc, horizontal, vertical
XLA_TOLS = (1e-2, 1e-2, 3e-3, 3e-3, 3e-3, 3e-3, 3e-3)
# a pixel is well conditioned where a float64 replay of its recorded path
# gives its float32 colour within this
WELL_CONDITIONED_ERR = 1e-6


def _well_conditioned(spheres, cam, side: int, tile: int):
    """(side, side, 1) float32 weights: 1 at the pixels whose float64 replay
    of the path K1d records (``grad.diff_render.replay_paths``) reproduces
    the float32 colour within WELL_CONDITIONED_ERR, else 0.  The others'
    gradients are those of near-tangent float32 re-intersections, which the
    two backends amplify differently."""
    import torch
    from raytracers_tpu_torch.geometry import Camera, Spheres
    from raytracers_tpu_torch.grad import pallas_diff as pd
    from raytracers_tpu_torch.grad.diff_render import replay_paths
    from raytracers_tpu_torch.render.megakernel import megakernel
    from raytracers_tpu_torch.render.tracer import primary_rays
    engine = pd._ReplayEngine(side, side, DEPTH, tile, "take", False, 1,
                              False, None, megakernel)
    with torch.no_grad():
        colours, rec = engine.forward(spheres, cam)
        idxs, events = pd._rec_to_path(rec)
        o, d = primary_rays(Camera(*(t.double() for t in cam)), side, side)
        col = replay_paths(Spheres(*(t.double() for t in spheres)), o, d,
                           idxs, events, skip_dead=True)
    err = (col.reshape(colours.shape) - colours.double()).abs().amax(-1)
    return (err < WELL_CONDITIONED_ERR).float()[..., None]


def _k1f_xla(port) -> list:
    """``backward="xla"`` at depth DEPTH on rgbbox with XLA_CHUNKS ray
    chunks, unsorted and sorted by depth: a warm-up, 2 timed steps, peak
    memory; the sorted replay's gradients against the unsorted one's (the
    same per-ray cotangents, summed in another order); against
    ``backward="pallas"``'s, the whole image's gap printed and the loss over
    the well-conditioned pixels (``_well_conditioned``) held to
    XLA_TOLS."""
    import torch
    from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
    from raytracers_tpu_torch.render import megakernel as mk
    from raytracers_tpu_torch.utils.timing import cuda_ms
    spheres, cam, _, (tile, block, schedule, prefix) = _diff_scene(
        port, XLA_SCENE, SIZE)
    for side in XLA_SIDES:
        grads, out = {}, []
        for sort in (False, True):
            f = make_render_pallas_diff(side, side, max_depth=DEPTH,
                                        tile=tile, backward="xla",
                                        bwd_chunks=XLA_CHUNKS,
                                        sort_by_depth=sort)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _grads(f, spheres, cam)                             # warm-up
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            if warm_s > XLA_MAX_STEP_S:
                break
            mk.release_graphs()       # the frame graphs of earlier renders
            torch.cuda.reset_peak_memory_stats()
            ms = [cuda_ms(lambda: _grads(f, spheres, cam), warmup=0, runs=1)
                  for _ in range(2)]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            img, grads[sort] = _grads(f, spheres, cam)
            out.append(dict(scene=XLA_SCENE, size=side, depth=DEPTH,
                            backward="xla", bwd_chunks=XLA_CHUNKS,
                            sort_by_depth=sort, warm_up_s=warm_s,
                            step_ms=ms, step_ms_mean=sum(ms) / 2,
                            peak_memory_gib=peak))
        else:
            break
        log(f"[k1f] xla at {side}x{side}: a warm-up step took {warm_s:.1f} "
            f"s, over {XLA_MAX_STEP_S} s; trying a smaller side")
    else:
        raise SmokeError("the xla backward exceeded its step time at every "
                         f"side of {XLA_SIDES}")
    pallas = make_render_pallas_diff(side, side, max_depth=DEPTH, tile=tile,
                                     block=block, schedule=schedule,
                                     sort_prefix=prefix)
    img_p, g_p = _grads(pallas, spheres, cam)
    if not torch.equal(img.view(torch.int32), img_p.view(torch.int32)):
        raise SmokeError("the xla engine's image differs from the pallas "
                         "engine's")
    gap_sorted, gap_pallas = [], []
    for a, b, p in zip(grads[False], grads[True], g_p):
        if not torch.isfinite(b).all() or b.abs().max() == 0:
            raise SmokeError("an xla gradient is not finite or is zero")
        gap_sorted.append(float((a - b).abs().max() / a.abs().max()))
        gap_pallas.append(float((a - p).abs().max() / p.abs().max()))
    if max(gap_sorted) > 1e-4:
        raise SmokeError(f"the depth-sorted xla gradients differ from the "
                         f"unsorted ones by {gap_sorted} of their max")
    weight = _well_conditioned(spheres, cam, side, tile)
    _, g_xw = _grads(make_render_pallas_diff(
        side, side, max_depth=DEPTH, tile=tile, backward="xla",
        bwd_chunks=XLA_CHUNKS, sort_by_depth=True), spheres, cam, weight)
    _, g_pw = _grads(pallas, spheres, cam, weight)
    gap_wc = [float((a - p).abs().max() / p.abs().max())
              for a, p in zip(g_xw, g_pw)]
    if any(g > tol for g, tol in zip(gap_wc, XLA_TOLS)):
        raise SmokeError(f"on the well-conditioned pixels the xla gradients "
                         f"differ from the pallas ones by {gap_wc} of their "
                         f"max, over {XLA_TOLS}")
    for r in out:
        r.update(sorted_vs_unsorted_rel_gap=gap_sorted,
                 vs_pallas_rel_gap=gap_pallas,
                 well_conditioned_share=float(weight.mean()),
                 vs_pallas_rel_gap_well_conditioned=gap_wc)
        log(f"[k1f] {json.dumps(r)}")
    return out


def _width_gap(port, name: str) -> list:
    """One fwd+bwd step of the W = 64 and the W = 128 engines at SIZE,
    depth DEPTH: the float pixels that differ and the largest gap of each
    gradient relative to the W = 128 one's largest, printed."""
    import torch
    from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
    spheres, cam, _, (tile, block, schedule, prefix) = _diff_scene(
        port, name, SIZE)
    cfg = dict(max_depth=DEPTH, tile=tile, block=block, schedule=schedule,
               sort_prefix=prefix)
    img64, g64 = _grads(make_render_pallas_diff(SIZE, SIZE, cluster_width=64,
                                                **cfg), spheres, cam)
    img128, g128 = _grads(make_render_pallas_diff(SIZE, SIZE, **cfg), spheres,
                          cam)
    n_diff = int((img64 != img128).any(dim=-1).sum())
    gaps = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(g64, g128)]
    if not all(torch.isfinite(g).all() for g in g64):
        raise SmokeError(f"{name}: a W=64 engine gradient is not finite")
    log(f"[k1f] {name} fwd+bwd {SIZE}x{SIZE} d{DEPTH}, W=64 against the "
        f"W=128 engine: {n_diff} pixels differ; gradient gaps {gaps} of "
        "the W=128 largest")
    return gaps


def phase_k1f(port) -> dict:
    """Phase 9: K1f against its plain version at CHECK_SIZE; the K1f render
    cells at SIZE for both scenes; the fwd+bwd engine at W = 64; the xla
    backward's options.  Returns the checkers, the cells, the fwd+bwd
    results and the xla results."""
    from raytracers_tpu_torch.render import megakernel as mk
    t0 = time.perf_counter()
    checkers = _k1f_vs_plain(port)
    cells = []
    for name in SCENES:
        default = _cell(port, name)
        default_img = default.render()
        for mode in K1F_CELLS:
            key = mode if mode in ("W=64", "W=32", "near-root") else "options"
            cells.append(_k1f_cell(port, default, mode, checkers[key, name],
                                   default_img))
        coherent = mk.render_pallas_twophase(
            default.ps, default.cam, SIZE, SIZE, max_depth=DEPTH,
            tile=default.config[0], block=default.config[1],
            schedule=default.config[2], sort_prefix=default.config[3],
            coherent=True)
        checkers["options", name].compare(
            f"{SIZE}x{SIZE} coherent image against the default render",
            coherent.reshape(-1), default_img.reshape(-1))
    fwdbwd = []
    for name in SCENES:
        res = phase_fwdbwd(port, name, cluster_width=64, tag="k1f")
        res["grad_rel_gap_to_w128"] = _width_gap(port, name)
        fwdbwd.append(res)
    xla = _k1f_xla(port)
    log(f"[k1f] phase 9 in {time.perf_counter() - t0:.1f} s")
    return dict(checkers=checkers, cells=cells, fwdbwd=fwdbwd, xla=xla)


def phase_probes() -> dict:
    """Phase 10, the probes M1-M7 (``[probe]`` lines): every variant at the
    TPU probes' sizes through ``microbench.run``, ``microbench_v5.run`` and
    ``microbench_mxuquad.run``, with the launch counts set to 0 just before
    and read just after; each variant timed, held against its plain version
    on the same inputs (bit-equal; M1's FMA within its steps' ulps, M2's
    TF32 routes within their rounding bound, M7's mxuquad product within
    its bound and its visit bit-equal given that product) and given its
    bound (M1, M3 and M6 by the pipe that limits them, M4 and M5 by their
    operations or the fewest L1 wavefronts their loads need, the old bound
    beside); M3's and M6's rows under 0.05 ms, M1's, M4's and M5's under
    1 ms also carry the device's own time.  M4, M5 and M7 charge a root and 1/a at the M1
    weights measured here."""
    from raytracers_tpu_torch.probes import microbench as mb
    from raytracers_tpu_torch.probes import microbench_mxuquad as mq
    from raytracers_tpu_torch.probes import microbench_v5 as v5
    t0 = time.perf_counter()
    mb.LAUNCHES.clear()
    try:
        rec = mb.run(log=log)
        w = rec["mul_equivalents"]
        t1 = time.perf_counter()
        rec_v5 = v5.run(log=log, weights=w)
        rec_mq = mq.run(log=log, weights=w)
    except mb.ProbeMismatch as e:
        raise SmokeError(f"probe: {e}") from e
    launches = dict(mb.LAUNCHES)
    entries = rec["entries"] + rec_v5["entries"] + rec_mq["entries"]
    missing = sorted({e["label"] for e in entries} - set(launches))
    if missing:
        raise SmokeError(f"probe: no launch counted for {missing}")
    log(f"[probe] launches {launches}")
    log(f"[probe] M1: sqrtf {w['sqrt']:.3f}, division {w['div']:.3f}, 1/x "
        f"{w['rcp']:.3f} multiply-equivalents; clocks.sm "
        f"{rec['clocks_sm_mhz']}; M5-M7 in {time.perf_counter() - t1:.1f} s;"
        f" phase 10 in {time.perf_counter() - t0:.1f} s")
    return dict(entries=entries, launches=launches)


# phase 11: the trainer
TRAIN_STEPS = 10                # the fit's steps, losses finite and falling
TRAIN_LR = 2e-3                 # examples/rgbbox_recovery.py's colour rate
SLABS = 4                       # ranks run in one process (phase 11)
SLAB_GRAD_SIZE, SLAB_GRAD_DEPTH = 256, 3
# the sharded step's summed loss and gradients against the unsharded
# engine's (tests/test_sharding.py:214-220): each band's camera rounds its
# ray directions once
SLAB_LOSS_RTOL, SLAB_GRAD_RTOL, SLAB_GRAD_ATOL = 1e-5, 2e-4, 2e-5
BRUTE_SIZE, BRUTE_DEPTH, BRUTE_STEPS = 64, 2, 4


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def _close(what: str, got, want, rtol: float, atol: float = 0.0) -> float:
    """Fail unless |got - want| <= atol + rtol |want| everywhere; returns
    the largest |got - want| / max |want|."""
    import torch
    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        raise SmokeError(f"{what}: not finite")
    gap = (got - want).abs()
    if (gap > atol + rtol * want.abs()).any():
        i = int((gap > atol + rtol * want.abs()).reshape(-1).nonzero()[0])
        raise SmokeError(f"{what}: {got.reshape(-1)[i].item()} against "
                         f"{want.reshape(-1)[i].item()} (rtol {rtol}, atol "
                         f"{atol})")
    return float(gap.max() / want.abs().max().clamp(min=1e-30))


def _train_one_rank(port, fb) -> dict:
    """The train step of the megakernel's engine on a one-rank NCCL mesh
    (a HashStore, world size 1), rgbbox at SIZE, depth DEPTH, the class's
    ``pallas_diff_config``, colours perturbed as the example perturbs them
    and only colours trainable."""
    import torch
    import torch.distributed as dist
    from raytracers_tpu_torch.examples.rgbbox_recovery import perturb
    from raytracers_tpu_torch.geometry import Spheres
    from raytracers_tpu_torch.grad.inverse import (adam, init_state,
                                                   make_train_step_pallas)
    from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
    from raytracers_tpu_torch.parallel.mesh import ray_mesh
    from raytracers_tpu_torch.render import megakernel as mk
    from raytracers_tpu_torch.utils.timing import cuda_ms
    from raytracers_tpu_torch.utils.trace import counting

    truth, cam, ps, (tile, block, schedule, prefix) = _diff_scene(
        port, "rgbbox", SIZE)
    n_phases = len(schedule) + 1
    cfg = dict(max_depth=DEPTH, tile=tile, block=block, schedule=schedule,
               sort_prefix=prefix)
    with torch.no_grad():
        target = make_render_pallas_diff(SIZE, SIZE, **cfg)(truth, cam)
    pert = perturb(truth, 0, 0.0, 0.0, 0.12)
    trainable = Spheres(torch.zeros_like(truth.center),
                        torch.zeros_like(truth.radius),
                        torch.ones_like(truth.color))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = ray_mesh(device="cuda")
        if (mesh.rank, mesh.size) != (0, 1) or mesh.group is None:
            raise SmokeError(f"the one-rank NCCL mesh is {mesh}")
        step = make_train_step_pallas(mesh, SIZE, SIZE, trainable=trainable,
                                      **cfg)
        state = init_state(pert, adam(TRAIN_LR))
        step(state, cam, target)                              # warm-up
        torch.cuda.synchronize()
        with counting(stats=False) as c:
            state, loss = step(state, cam, target)
        torch.cuda.synchronize()
        counts = c.read()
        launches = tuple(counts.get(f"{k}.launches", {}).get("total", 0)
                         for k in ("k1", "k2"))
        if launches != (fb["k1d_launches"], fb["k2_launches"]):
            raise SmokeError(f"one train step launched K1d and K2 {launches} "
                             f"times; the fwd+bwd step of phase 6 "
                             f"{fb['k1d_launches']}, {fb['k2_launches']}")
        state = init_state(pert, adam(TRAIN_LR))
        losses = [float(step(state, cam, target)[1])
                  for _ in range(TRAIN_STEPS)]
        if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
            raise SmokeError(f"the fit's losses {losses} are not finite or "
                             "did not fall")
        if not torch.equal(state.spheres.center, pert.center):
            raise SmokeError("a masked parameter moved")
        ms = [cuda_ms(lambda: step(state, cam, target), warmup=0,
                      runs=FB_REPEATS) for _ in range(3)]
        profile = device_profile(lambda: step(state, cam, target))

        # one rank: its loss and gradients against the plain engine's (K1d's
        # and K2's plain versions on the card) and the unsharded kernel
        # engine's, on the same inputs
        loss_r, g_r = step.loss_and_grads(pert, cam, target)
    finally:
        dist.destroy_process_group()
    p_k2 = PlainK2(ps.order.numel(), Timed(lambda fn, *a, **kw: fn(*a, **kw),
                                           n_phases))
    plain = make_render_pallas_diff(SIZE, SIZE, fwd_kernel=mk.megakernel_reference,
                                    bwd_kernel=p_k2, **cfg)
    unsharded = make_render_pallas_diff(SIZE, SIZE, **cfg)
    ref = {}
    for which, f in (("plain", plain), ("kernel", unsharded)):
        sph = Spheres(*(t.detach().clone().requires_grad_(True)
                        for t in pert))
        lo = ((f(sph, cam) - target) ** 2).sum()
        lo.backward()
        ref[which] = (lo.detach(), [t.grad for t in sph])
    if not torch.equal(loss_r, ref["plain"][0]):
        raise SmokeError(f"the one-rank loss {float(loss_r)} is not the plain "
                         f"engine's {float(ref['plain'][0])}")
    err, bound, want = _sphere_grad_check("one-rank train step", ps, p_k2,
                                          n_phases, list(g_r),
                                          ref["plain"][1])
    unsharded_bit_equal = torch.equal(loss_r, ref["kernel"][0]) and all(
        torch.equal(a, b) for a, b in zip(g_r, ref["kernel"][1]))
    # printed only: both runs' slot tables add in no fixed order
    unsharded_rel = [float((a - b).abs().max() / b.abs().max())
                     for a, b in zip(g_r, ref["kernel"][1])]
    mean_ms = sum(ms) / len(ms)
    return dict(scene="rgbbox", size=SIZE, depth=DEPTH, schedule=schedule,
                k1d_launches=launches[0], k2_launches=launches[1],
                losses=losses, train_step_ms=ms, train_step_ms_mean=mean_ms,
                fwdbwd_ms_mean=fb["fwdbwd_ms_mean"],
                step_minus_fwdbwd_ms=mean_ms - fb["fwdbwd_ms_mean"],
                loss_bit_equal_plain=True,
                sphere_grad_max_abs_err=float(err.max()),
                sphere_grad_rel_err=float(err.max() / want.abs().max()),
                sphere_grad_err_share_of_bound=float(
                    (err / torch.where(bound > 0, bound, 1.0)).max()),
                unsharded_kernel_bit_equal=unsharded_bit_equal,
                unsharded_kernel_grad_rel=unsharded_rel, profile=profile)


def _four_slabs(port) -> dict:
    """SLABS ranks in this process: the render's slabs assembled against
    ``render(mode="pallas")`` (both scenes, SIZE, DEPTH), and the step's
    summed loss and gradients against the unsharded engine at
    SLAB_GRAD_SIZE, SLAB_GRAD_DEPTH: held to the tolerances on
    tests/test_sharding.py:186's toy scene; printed on rgbbox, whose
    mirror cascades turn the band cameras' one rounding per ray direction
    into other paths for a share of its pixels."""
    import torch
    from raytracers_tpu_torch.examples.rgbbox_recovery import perturb
    from raytracers_tpu_torch.geometry import Spheres, camera
    from raytracers_tpu_torch.grad.inverse import (band_camera,
                                                   make_train_step_pallas)
    from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
    from raytracers_tpu_torch.parallel.mesh import RayMesh, render_pallas_slab
    from raytracers_tpu_torch.render.api import render
    out = {}
    for name in SCENES:
        prep = _prepare(port, name, SIZE)
        slabs = [render_pallas_slab(prep.pallas, prep.cam, SIZE, SIZE, r,
                                    SLABS, max_depth=DEPTH)
                 for r in range(SLABS)]
        img = torch.cat(slabs)[:SIZE]
        ref = render(prep, SIZE, SIZE, mode="pallas", max_depth=DEPTH)
        g = _first_diff(img.reshape(-1), ref.reshape(-1))
        if g is not None:
            raise SmokeError(f"{name}: the {SLABS} slabs differ from the "
                             f"one-rank render first at pixel {g}")
        out[f"{name}_slab_rows"] = [int(t.shape[0]) for t in slabs]
    n, rows = SLAB_GRAD_SIZE, SLAB_GRAD_SIZE // SLABS
    sc = port.scenes.by_name("rgbbox")
    toy = Spheres(torch.tensor([[0.0, 0.0, -5.0], [2.5, 0.0, -4.0]]),
                  torch.tensor([1.5, 1.0]),
                  torch.tensor([[0.8, 0.3, 0.2], [0.2, 0.6, 0.9]]))
    cases = {
        # tests/test_sharding.py:186's scene and perturbation
        "toy": (toy, toy._replace(radius=toy.radius * torch.tensor(
            [1.15, 0.9]), color=(toy.color + 0.1).clamp(0.0, 1.0)),
            camera((0., 0., 2.), (0., 0., -5.), (0., 1., 0.), 60.0, 1.0)),
        "rgbbox": (sc.spheres, perturb(sc.spheres, 0, 0.0, 0.05, 0.12),
                   camera(sc.look_from, sc.look_at, (0.0, 1.0, 0.0), sc.fov,
                          1.0))}
    for name, (truth, pert, cam) in cases.items():
        truth = Spheres(*(t.to(cam.origin.device) for t in truth))
        pert = Spheres(*(t.to(cam.origin.device) for t in pert))
        f = make_render_pallas_diff(n, n, max_depth=SLAB_GRAD_DEPTH)
        with torch.no_grad():
            target = f(truth, cam)
        sph = Spheres(*(t.detach().clone().requires_grad_(True)
                        for t in pert))
        img = f(sph, cam)
        lu = ((img - target) ** 2).sum()
        lu.backward()
        step = make_train_step_pallas(
            RayMesh(0, SLABS, None, cam.origin.device), n, n,
            max_depth=SLAB_GRAD_DEPTH)
        ls, gs = step.loss_and_grads(pert, cam, target)
        # the pixels whose banded path differs from the unsharded one
        fb = make_render_pallas_diff(n, rows, max_depth=SLAB_GRAD_DEPTH)
        with torch.no_grad():
            bands = torch.cat([fb(pert, band_camera(cam, float(r * rows),
                                                    rows, n))
                               for r in range(SLABS)])
        moved = float(((bands - img.detach()).abs().amax(-1) > 1e-3)
                      .float().mean())
        gaps = [float(((a - b.grad).abs() / (SLAB_GRAD_ATOL + SLAB_GRAD_RTOL
                                             * b.grad.abs())).max())
                for a, b in zip(gs, sph)]
        lu = lu.detach()
        out[f"{name}_slab_loss_rel"] = float((ls - lu).abs() / lu.abs())
        out[f"{name}_slab_grad_share_of_tol"] = gaps
        out[f"{name}_moved_pixel_share"] = moved
        if name == "toy":
            _close("the toy scene's slab loss", ls, lu, SLAB_LOSS_RTOL)
            for w, a, b in zip(("centre", "radius", "colour"), gs, sph):
                _close(f"the toy scene's slab {w} gradient", a, b.grad,
                       SLAB_GRAD_RTOL, SLAB_GRAD_ATOL)
    return out


def _brute_and_checkpoints(port) -> dict:
    """``recover`` over the all-pairs oracle, resumed from a checkpoint
    after step 2, against an uninterrupted run; ``--mode brute_matmul``
    against ``brute``."""
    import tempfile
    import torch
    from raytracers_tpu_torch.geometry import camera
    from raytracers_tpu_torch.grad.inverse import recover
    from raytracers_tpu_torch.parallel.mesh import ray_mesh
    from raytracers_tpu_torch.render.api import prepare_scene, render, \
        render_float
    sc = port.scenes.by_name("rgbbox")
    n, d = BRUTE_SIZE, BRUTE_DEPTH
    cam = camera(sc.look_from, sc.look_at, (0.0, 1.0, 0.0), sc.fov, 1.0)
    prep = prepare_scene(sc, n, n, with_bvh=False)
    target = render_float(prep, n, n, mode="brute", max_depth=d)
    init = sc.spheres._replace(color=(sc.spheres.color + 0.2).clamp(0, 1))
    mesh = ray_mesh()
    kw = dict(lr=5e-2, max_depth=d)
    whole, resumed = [], []
    recover(target, cam, init, mesh, steps=BRUTE_STEPS,
            callback=lambda i, l, s: whole.append(l), **kw)
    with tempfile.TemporaryDirectory() as ckdir:
        recover(target, cam, init, mesh, steps=2, checkpoint_dir=ckdir,
                checkpoint_every=1, **kw)
        recover(target, cam, init, mesh, steps=BRUTE_STEPS,
                checkpoint_dir=ckdir,
                callback=lambda i, l, s: resumed.append(l), **kw)
    if len(resumed) != BRUTE_STEPS - 2:
        raise SmokeError(f"the resumed fit ran {len(resumed)} steps")
    resume_rel = _close("the resumed fit's losses", torch.tensor(resumed),
                        torch.tensor(whole[2:]), 1e-5)
    a = render(prep, n, n, mode="brute")
    b = render(prep, n, n, mode="brute_matmul")
    frac = float((a != b).float().mean())
    if frac >= 0.01:
        raise SmokeError(f"brute_matmul differs from brute on {frac:.4f} of "
                         "the pixels")
    return dict(brute_losses=whole, resumed_losses=resumed,
                resume_rel=resume_rel, matmul_pixel_share=frac)


def phase_train(port, fb_results) -> dict:
    """Phase 11: the trainer (``[train]`` lines)."""
    fb = next(r for r in fb_results if r["scene"] == "rgbbox")
    t0 = time.perf_counter()
    res = dict(card=_smi(), **_train_one_rank(port, fb))
    log(f"[train] {res['card']}: rgbbox {SIZE}x{SIZE} d{DEPTH} one-rank "
        f"NCCL step: train_step_ms {res['train_step_ms_mean']:.3f} "
        f"(rounds {res['train_step_ms']}), fwdbwd_ms "
        f"{res['fwdbwd_ms_mean']:.3f}; the all-reduce, Adam and the clamps "
        f"{res['step_minus_fwdbwd_ms']:.3f} ms; K1d {res['k1d_launches']} "
        f"and K2 {res['k2_launches']} launches a step; losses "
        f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}")
    res.update(_four_slabs(port))
    log(f"[train] {SLABS} slabs: rgbbox and irreg {SIZE}x{SIZE} d{DEPTH} "
        f"bit-equal to render(mode='pallas'); at {SLAB_GRAD_SIZE}^2 "
        f"d{SLAB_GRAD_DEPTH} against the unsharded engine, the toy scene's "
        f"loss {res['toy_slab_loss_rel']:.2e} and gradients "
        f"{res['toy_slab_grad_share_of_tol']} of their tolerances "
        f"(held); rgbbox's loss {res['rgbbox_slab_loss_rel']:.2e} and "
        f"gradients {res['rgbbox_slab_grad_share_of_tol']} of them, with "
        f"{res['rgbbox_moved_pixel_share']:.5f} of its pixels on another "
        "path (printed)")
    res.update(_brute_and_checkpoints(port))
    res["seconds"] = time.perf_counter() - t0
    log(f"[train] {json.dumps(res)}")
    return res


def _kernels_record(layouts, checkers, diff_checkers, results, fb_results,
                    k3_checkers, k3_results, k1f, probes, train) -> list:
    """One entry per kernel and scene: the layout build from phase 1b
    (replacing no TPU kernel; its bound the tables' and spheres' bytes
    once at the HBM rate), K1 from the render main path, K1d
    and K2 from the fwd+bwd main path, K3 from the BVH main path, K1f's
    modes from phase 9's cells and its W = 64 fwd+bwd steps, K1d and K2
    of the train step (phase 11) with its launches and phase 6's times;
    ``max_abs_err`` from the kernel against plain checks (K2's includes
    its slot tables)."""
    from raytracers_tpu_torch.render import _cuda
    src = {k: str(_cuda.source(k).relative_to(ROOT)) for k in _cuda.KERNELS}
    where = f"{SIZE}x{SIZE} d{DEPTH}"
    out = []
    for r in layouts:
        order = "front to back" if r["sort_origin"] else "unsorted"
        out.append(dict(
            name=f"layout build ({r['scene']}, {order})", route="cuda",
            source=src["layout"], replaces=None, launches=r["launches"],
            max_abs_err=0.0, ms=r["kernel"]["event_ms"],
            plain_ms=r["plain"]["event_ms"],
            bound_ms=r["table_bytes"] / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None))
    for r in results:
        # scene-scale layouts run K1e, the two-level cull
        k1e = r["cull_blocks"] > 1
        out.append(dict(
            name=(f"K1{'e' if k1e else ''} megakernel ({r['scene']} "
                  f"{r['size']}x{r['size']} d{r['depth']})"),
            route="cuda", source=src["megakernel"],
            replaces=("raytracers_tpu/render/pallas_kernel.py:"
                      + ("526" if k1e else "319")),
            launches=r["k1_launches"],
            lanes_per_ray=r["k1_routes"]["rule_lanes"],
            max_abs_err=checkers[r["scene"]].max_abs_err,
            ms=r["k1_ms"], plain_ms=r["plain_k1_ms"],
            bound_ms=r["k1_bound_ms"], bound_by=r["k1_bound_by"],
            library_ms=None))
    for r in fb_results:
        k1, k2 = diff_checkers[r["scene"]]
        out.append(dict(
            name=f"K1d megakernel record ({r['scene']} fwd+bwd {where})",
            route="cuda", source=src["megakernel"],
            replaces="raytracers_tpu/render/pallas_kernel.py:934",
            launches=r["k1d_launches"],
            lanes_per_ray=r["k1d_routes"]["rule_lanes"],
            max_abs_err=k1.max_abs_err,
            ms=r["k1d_ms"], plain_ms=r["plain_k1d_ms"],
            bound_ms=r["k1d_bound_ms"], bound_by=r["k1d_bound_by"],
            library_ms=None))
        out.append(dict(
            name=(f"K2 replay_bwd, redesigned ({r['scene']} fwd+bwd "
                  f"{where})"),
            route="cuda", source=src["replay_bwd"],
            replaces="raytracers_tpu/grad/pallas_replay_bwd.py:104",
            status=K2_STATUS, conflict_factor=r["k2_conflict"],
            launches=r["k2_launches"], max_abs_err=k2.max_abs_err,
            table_err_share_of_bound=k2.table_err_share,
            ms=r["k2_ms"], plain_ms=r["plain_k2_ms"],
            bound_ms=r["k2_bound_ms"], bound_by=r["k2_bound_by"],
            library_ms=r["k2_library_ms"]))
    for r in k3_results:
        out.append(dict(
            name=(f"K3 traversal, redesigned ({r['scene']} {where}, "
                  f"{r['path']} geometry)"),
            route="cuda", source=src["traversal"],
            replaces="raytracers_tpu/render/pallas_traversal.py:116",
            status=("redesigned: persistent warps, ballot policy, leaves "
                    "split over the warp"),
            launches=r["k3_launches"],
            max_abs_err=k3_checkers[r["scene"]].max_abs_err,
            ms=r["k3_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["k3_bound_ms"], bound_by=r["k3_bound_by"],
            library_ms=None))
    k1f_checkers = k1f["checkers"]
    for c in k1f["cells"]:
        mode, scene = c["mode"], c["scene"]
        key = mode if mode in ("W=64", "W=32", "near-root") else "options"
        out.append(dict(
            name=f"K1f {mode} megakernel ({scene} {where})",
            route="cuda", source=src["megakernel"],
            replaces=("raytracers_tpu/render/pallas_kernel.py:"
                      + K1F_CELLS[mode][2]),
            launches=c["k1_launches"],
            lanes_per_ray=c["k1_routes"]["rule_lanes"],
            max_abs_err=k1f_checkers[key, scene].max_abs_err,
            ms=c["k1_ms"], plain_ms=c["plain_k1_ms"],
            bound_ms=c["k1_bound_ms"], bound_by=c["k1_bound_by"],
            library_ms=None))
    for r in k1f["fwdbwd"]:
        scene = r["scene"]
        k1, k2 = (k1f_checkers["K1d W=64", scene],
                  k1f_checkers["K2 W=64", scene])
        out.append(dict(
            name=f"K1f W=64 K1d megakernel record ({scene} fwd+bwd {where})",
            route="cuda", source=src["megakernel"],
            replaces="raytracers_tpu/render/pallas_kernel.py:634",
            launches=r["k1d_launches"],
            lanes_per_ray=r["k1d_routes"]["rule_lanes"],
            max_abs_err=k1.max_abs_err,
            ms=r["k1d_ms"], plain_ms=r["plain_k1d_ms"],
            bound_ms=r["k1d_bound_ms"], bound_by=r["k1d_bound_by"],
            library_ms=None))
        out.append(dict(
            name=(f"K2 replay_bwd at W=64, redesigned ({scene} fwd+bwd "
                  f"{where})"),
            route="cuda", source=src["replay_bwd"],
            replaces="raytracers_tpu/grad/pallas_replay_bwd.py:104",
            status=K2_STATUS, conflict_factor=r["k2_conflict"],
            launches=r["k2_launches"], max_abs_err=k2.max_abs_err,
            table_err_share_of_bound=k2.table_err_share,
            ms=r["k2_ms"], plain_ms=r["plain_k2_ms"],
            bound_ms=r["k2_bound_ms"], bound_by=r["k2_bound_by"],
            library_ms=r["k2_library_ms"]))
    # the trainer's step runs phase 6's rgbbox launches (the same engine,
    # config and scene), whose times, bounds and checks stand for it
    fb = next(r for r in fb_results if r["scene"] == "rgbbox")
    k1, k2 = diff_checkers["rgbbox"]
    for kind, src_key, replaces, chk in (
            ("K1d", "megakernel",
             "raytracers_tpu/render/pallas_kernel.py:934", k1),
            ("K2", "replay_bwd",
             "raytracers_tpu/grad/pallas_replay_bwd.py:104", k2)):
        key = kind.lower()
        out.append(dict(
            name=(f"{kind} in the train step (rgbbox {where}, one-rank "
                  "NCCL mesh)"),
            route="cuda", source=src[src_key], replaces=replaces,
            launches=train[f"{key}_launches"], max_abs_err=chk.max_abs_err,
            ms=fb[f"{key}_ms"], plain_ms=fb[f"plain_{key}_ms"],
            bound_ms=fb[f"{key}_bound_ms"], bound_by=fb[f"{key}_bound_by"],
            library_ms=fb["k2_library_ms"] if kind == "K2" else None,
            times_from="fwdbwd rgbbox"))
    from raytracers_tpu_torch.probes.microbench import KERNEL_OF, REPLACES
    for e in probes["entries"]:
        out.append(dict(
            name=e["name"], route="cuda", source=src[KERNEL_OF[e["probe"]]],
            replaces=REPLACES[e["probe"]],
            launches=probes["launches"][e["label"]],
            max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"],
            bound_ms=e["bound_ms"], bound_by=e["bound_by"],
            library_ms=e["library_ms"]))
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    try:
        port = load_port()
        phase_card_and_build()
        layouts = phase_layout(port)
        checkers = phase_kernel_vs_plain(port)
        checkers.update(phase_scene_scale_vs_plain(port))
        diff_checkers = phase_diff_kernels_vs_plain(port)
        native_ms = phase_goldens(port)
        results = [phase_main_path(port, name, checkers[name])
                   for name in CELLS]
        _log_native_beside_card(native_ms, results)
        phase_profiling(port)
        fb_results = [phase_fwdbwd(port, name) for name in SCENES]
        phase_example(port)
        k3_checkers = phase_bvh_vs_plain(port)
        k3_results = phase_bvh_main(port, k3_checkers)
        k1f = phase_k1f(port)
        probes = phase_probes()
        train = phase_train(port, fb_results)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": _kernels_record(
        layouts, checkers, diff_checkers, results, fb_results, k3_checkers,
        k3_results, k1f, probes, train)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
