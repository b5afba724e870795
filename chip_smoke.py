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
2. K1 against its plain version: rgbbox and irreg at 200x200 through
   ``render_pallas`` (scanline and block tiles, depth 1 and 50: mode K1a)
   and ``render_pallas_twophase`` with the scene's class schedule and sort
   prefixes (K1a with state out, then K1b continuations), all with the
   per-ray counters (K1c).  Every K1 launch is repeated by the plain version
   on the same inputs on the card, and the images, state rows and counters
   must be bit-equal;
3. K1d and K2 against their plain versions at 200x200, both scenes: record
   renders single- and multi-phase, scanline and block (records, pay at
   bounces, state rows bit-equal); the fwd+bwd engine whole-path and at the
   scene's ``pallas_diff_config``, with every K2 launch repeated by the
   plain version (per-ray cotangents, carries and per-bounce cotangents
   bit-equal; the slot table within its summation-order bound); the
   replayed colours of K2 (``emit_fwd``) bit-equal to K1d's at depth 50;
4. goldens: ``render(mode="pallas")`` at 200x200 against ``tests/golden``;
5. main path, render: ``prepare_scene`` + ``render(mode="pallas")`` at
   1000x1000, depth 50, for each scene: launches counted from zero around
   one render, render times with CUDA events, per-phase K1 times, counters,
   K1's bound, and the full-size image against the plain version;
6. main path, fwd+bwd: ``make_render_pallas_diff`` at 1000x1000, depth 50,
   with the scene's ``pallas_diff_config``, then ``loss.backward()`` for
   ``loss = (f(spheres, cam) ** 2).sum()``: launches counted from zero
   around one step (K1d once a phase, K2 once a segment), finite non-zero
   gradients, step times with CUDA events, per-launch K1d and K2 times, one
   profiled step, the bounds, and the gradient against the plain engine on
   the card.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENES = ("rgbbox", "irreg")
SIZE, DEPTH = 1000, 50          # the main path's image and bounce cap
CHECK_SIZE = 200                # phases 2 to 4
REPEATS = 5                     # timed renders per scene
FB_REPEATS = 3                  # timed fwd+bwd steps per round

# H100 SXM published peaks at a 700 W power limit: 67 TFLOP/s float32
# outside the tensor cores, i.e. 33.5e12 lane operations a second with a
# fused multiply-add counted as 2 flops; 3.35 TB/s of HBM.
FP32_LANE_OPS_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
# lane operations per unit of counted work, counted in csrc/megakernel.cu
OPS_PER_SLOT = 30               # one (ray, sphere) test of the visit loop
OPS_PER_CULL_ROW = 25           # one AABB slab test and occlusion gate
OPS_PER_BOUNCE = 60             # per-bounce set-up, readback and shading
STATE_BYTES = 13 * 4            # the ray state a phase reads or writes
# K2's lane operations per replayed step, counted in csrc/replay_bwd.cu and
# csrc/ray_math.cuh (a square root or a division counted as one): a bounce
# replayed in pass 1 (110) and replayed and reversed in pass 2 (254), or a
# step that ends the path (a miss: its colour, then the carry's seed)
OPS_PER_K2_BOUNCE = 364
OPS_PER_K2_END = 65
K2_SCRATCH_BYTES = 2 * 9 * 4    # o, d, light of a step, written and read
PAY_BYTES = 28                  # the winner's 7 fields, at a bounce
F32_EPS = 2.0 ** -24            # float32 unit roundoff

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
    """K1 with each launch repeated by its plain version on the same inputs
    on the card; any bit of difference fails the phase."""

    def __init__(self, mk, label: str):
        self.mk, self.label = mk, label
        self.checks = 0
        self.max_abs_err = 0.0

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
        out = self.mk.megakernel(scene, params, n_rays, tile, **kw)
        ref = self.mk.megakernel_reference(scene, params, n_rays, tile, **kw)
        what = "state rows" if kw.get("emit_state") else "packed image"
        self.compare(what, out[0], ref[0])
        if out[1] is not None:
            self.compare("counters", out[1], ref[1], packed=False)
        if kw.get("record_depth") is not None:
            self.compare("records", out[2], ref[2], packed=False)
            if out[3] is not None:
                # pay is defined only at bounces
                bnc = out[2] >= 0
                self.compare("pay at bounces",
                             out[3][:, :7].permute(1, 0, 2)[:, bnc],
                             ref[3][:, :7].permute(1, 0, 2)[:, bnc])
        return out


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
    since the kernel adds it with float32 atomics in no fixed order."""

    def __init__(self, label: str):
        from raytracers_tpu_torch.grad import replay_bwd as rb
        self.rb, self.label = rb, label
        self.checks = 0
        self.max_abs_err = 0.0          # per-ray outputs and the table
        self.table_err_share = 0.0      # largest error / its bound

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
            bound = (count[:, None] + 1.0) * F32_EPS * mag
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
        return out


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


def _prepare(port, name: str, size: int):
    from raytracers_tpu_torch.render.api import prepare_scene
    sc = port.scenes.by_name(name)
    return prepare_scene(sc, size, size, with_pallas=True, with_bvh=False)


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
            f"comparisons (K1a scanline+block d1/d{DEPTH}, K1b schedule "
            f"{schedule} prefixes {prefix}, K1c counters {two_stats['slot_tests']}"
            f" slot tests)")
        checkers[name] = chk
    return checkers


def _diff_scene(port, name: str, size: int):
    """A scene's spheres and camera on the card, as a user of the fwd+bwd
    engine passes them, and the engine's class config."""
    from raytracers_tpu_torch.geometry import camera
    from raytracers_tpu_torch.render.api import pallas_diff_config
    from raytracers_tpu_torch.render.megakernel import build_pallas_scene
    sc = port.scenes.by_name(name)
    cam = camera(sc.look_from, sc.look_at, (0.0, 1.0, 0.0), sc.fov, 1.0)
    layout = build_pallas_scene(sc.spheres)
    return sc.spheres, cam, layout, pallas_diff_config(layout.n_clusters)


def _grads(f, spheres, cam):
    """One fwd+bwd step: loss = sum(f(spheres, cam) ** 2), backward; returns
    the image and the gradients (centre, radius, colour, then the camera's
    origin, llc, horizontal, vertical)."""
    from raytracers_tpu_torch.geometry import Camera, Spheres
    sph = Spheres(*(t.detach().requires_grad_(True) for t in spheres))
    c = Camera(*(t.detach().requires_grad_(True) for t in cam))
    img = f(sph, c)
    (img * img).sum().backward()
    return img.detach(), [t.grad for t in (*sph, *c)]


def phase_diff_kernels_vs_plain(port) -> dict:
    """K1d and K2 against their plain versions at CHECK_SIZE; returns the
    checkers by scene."""
    import torch
    from raytracers_tpu_torch.grad import replay_bwd as rb
    from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
    from raytracers_tpu_torch.render import megakernel as mk
    size = CHECK_SIZE
    checkers = {}
    for name in SCENES:
        spheres, cam, ps, (tile, block, schedule, prefix) = _diff_scene(
            port, name, size)
        k1 = Checked(mk, f"{name} {size}x{size} K1d")
        k2 = CheckedK2(f"{name} {size}x{size}")
        # K1d single-phase, scanline and block, and multi-phase
        cols = {}
        for blk in (None, block):
            cols[blk], _, rec, pay = mk.render_pallas_record(
                ps, cam, size, size, max_depth=DEPTH, tile=tile,
                with_pay=True, block=blk, kernel=k1)
        k1.compare("block-tiled colours against scanline",
                   cols[block].reshape(-1), cols[None].reshape(-1))
        two, _ = mk.render_pallas_record_twophase(
            ps, cam, size, size, max_depth=DEPTH, tile=tile, block=block,
            schedule=schedule, sort_prefix=prefix, kernel=k1)
        k1.compare("multi-phase colours against single-phase",
                   two.reshape(-1), cols[block].reshape(-1))
        # K2's replayed colours against K1d's, depth 50, block tiles
        ro = mk._ray_order(cam, size, size, tile, block, 0.0, None, DEPTH)
        gcot = torch.zeros(rb.N_GCOT, ro.n_rays, device=rec.device)
        _, _, fwd = k2(ro.params, rec, pay, gcot, tile=tile,
                       block_tiled=True, emit_fwd=True)
        rep = mk._to_image(ro, fwd, size, size).permute(1, 2, 0)
        k1.compare(f"K2 replayed colours against K1d's at depth {DEPTH}",
                   rep.reshape(-1), cols[block].reshape(-1))
        # the engine whole-path and at the class config, every launch of
        # both kernels checked; the segmented gradient against the
        # whole-path one within the slot tables' summation slack
        whole = make_render_pallas_diff(size, size, max_depth=DEPTH,
                                        tile=tile, block=block,
                                        fwd_kernel=k1, bwd_kernel=k2)
        seg = make_render_pallas_diff(size, size, max_depth=DEPTH, tile=tile,
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
                                 "finite or is zero")
            # per-ray cotangents are bit-equal; only the order of the slot
            # tables' sums differs
            rel = float((a - b).abs().max() / a.abs().max())
            if rel > 1e-3:
                raise SmokeError(f"{name}: segmented gradient differs from "
                                 f"the whole-path one by {rel} of its max")
        log(f"[kernel=plain] {name} {size}x{size}: K1d {k1.checks} and K2 "
            f"{k2.checks} comparisons (records and pay bit-equal, per-ray "
            f"cotangents and carries bit-equal, slot tables within "
            f"{k2.table_err_share:.3f} of their bound; schedule {schedule} "
            f"prefixes {prefix}; replayed colours bit-equal at d{DEPTH})")
        checkers[name] = (k1, k2)
    return checkers


def phase_goldens(port) -> None:
    import numpy as np
    from raytracers_tpu_torch.image import pixel_to_rgb, read_ppm
    from raytracers_tpu_torch.render.api import render
    preps = {}
    for name, depth, fname, max_mis, max_delta in GOLDENS:
        prep = preps.get(name) or _prepare(port, name, CHECK_SIZE)
        preps[name] = prep
        img = render(prep, CHECK_SIZE, CHECK_SIZE, mode="pallas",
                     max_depth=depth).cpu().numpy()
        ref = read_ppm(str(ROOT / "tests" / "golden" / fname))
        mis = float((img != ref).mean())
        delta = float(np.abs(pixel_to_rgb(img).astype(np.int32)
                             - pixel_to_rgb(ref).astype(np.int32)).mean())
        log(f"[golden] {fname}: mismatch {mis} (limit {max_mis}), "
            f"mean |drgb| {delta} (limit {max_delta})")
        if mis > max_mis or delta > max_delta:
            raise SmokeError(f"golden {fname} out of tolerance")


def _device_profile(fn) -> dict | None:
    """One call of ``fn`` under torch.profiler: device time by kernel name,
    the device's busy time and the span from its first kernel's start to
    its last kernel's end.  None where the profiler saw no device kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    kernels.sort(key=lambda e: e.time_range.start)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    span_ms = (kernels[-1].time_range.end - kernels[0].time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # idle gaps between consecutive kernels, with the kernels around them
    gaps = sorted(((b.time_range.start - a.time_range.end) / 1e3,
                   a.name[:40], b.name[:40])
                  for a, b in zip(kernels, kernels[1:]))[::-1]
    k1_gap_ms = sum(g for g, a, b in gaps
                    if g > 0 and ("megakernel" in a or "megakernel" in b))
    return dict(device_busy_ms=busy_ms, device_span_ms=span_ms,
                device_idle_share=1.0 - busy_ms / span_ms,
                n_kernels=len(kernels),
                top_kernels_ms=[[name[:60], us / 1e3] for name, us in top],
                largest_gaps_ms=[list(g) for g in gaps[:5]],
                gaps_next_to_k1_ms=k1_gap_ms)


def _k1_bound(stats: dict, n_phases: int, n_rays: int):
    """Least time K1 could take for one render's counted work: operations
    over the FP32 lane-op rate, or the ray state each phase must read and
    write over HBM, whichever is larger."""
    ops = (stats["slot_tests"] * OPS_PER_SLOT
           + stats["cull_rows"] * OPS_PER_CULL_ROW
           + stats["ray_bounces"] * OPS_PER_BOUNCE)
    nbytes = STATE_BYTES * n_rays * (2 * n_phases - 1)
    ops_ms = ops / FP32_LANE_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def phase_main_path(port, name: str, checker) -> dict:
    import torch
    from raytracers_tpu_torch.render import megakernel as mk
    from raytracers_tpu_torch.render.api import (pallas_config, render,
                                                 render_stats)
    from raytracers_tpu_torch.utils.timing import cuda_ms
    prep_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prep = _prepare(port, name, SIZE)
        torch.cuda.synchronize()
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    ps, cam = prep.pallas, prep.cam
    tile, block, schedule, prefix = pallas_config(ps.n_clusters)
    n_phases = len(schedule) + 1

    render(prep, SIZE, SIZE, mode="pallas")                    # warm-up
    torch.cuda.synchronize()
    mk.megakernel.launches = 0
    img = render(prep, SIZE, SIZE, mode="pallas")
    torch.cuda.synchronize()
    launches = mk.megakernel.launches
    if launches != n_phases:
        raise SmokeError(f"{name}: the main path launched K1 {launches} "
                         f"times, not {n_phases}")
    if img.shape != (SIZE, SIZE) or img.dtype != torch.int32:
        raise SmokeError(f"{name}: image {tuple(img.shape)} {img.dtype}")

    # three rounds of REPEATS renders, each timed as one event pair
    render_ms = [cuda_ms(lambda: render(prep, SIZE, SIZE, mode="pallas"),
                         warmup=0, runs=REPEATS) for _ in range(3)]
    mean_ms = sum(render_ms) / len(render_ms)

    timed = Timed(mk.megakernel, n_phases)
    for _ in range(REPEATS):
        mk.render_pallas_twophase(ps, cam, SIZE, SIZE, max_depth=DEPTH,
                                  tile=tile, block=block, schedule=schedule,
                                  sort_prefix=prefix, kernel=timed)
    k1_phase_ms = timed.phase_ms()
    k1_ms = sum(k1_phase_ms)

    profiled = _device_profile(lambda: render(prep, SIZE, SIZE, mode="pallas"))
    if profiled is None:
        log(f"[main] {name}: torch.profiler saw no device kernels")

    stats = render_stats(prep, SIZE, SIZE, max_depth=DEPTH)
    n_rays = (-(-SIZE // block[0]) * block[0]) * (-(-SIZE // block[1])
                                                  * block[1])
    bound_ms, bound_by = _k1_bound(stats, n_phases, n_rays)

    plain = Timed(mk.megakernel_reference, n_phases)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_img = mk.render_pallas_twophase(
        ps, cam, SIZE, SIZE, max_depth=DEPTH, tile=tile, block=block,
        schedule=schedule, sort_prefix=prefix, kernel=plain)
    torch.cuda.synchronize()
    plain_render_ms = (time.perf_counter() - t0) * 1e3
    plain_ms = sum(plain.phase_ms())
    checker.compare(f"{SIZE}x{SIZE} image against the plain render",
                    img.reshape(-1), plain_img.reshape(-1))

    res = dict(scene=name, clusters=ps.n_clusters, tile=tile, block=block,
               schedule=schedule, sort_prefix=prefix,
               prepare_ms=prep_ms, render_ms=render_ms,
               render_ms_mean=mean_ms, mrays_per_s=SIZE * SIZE / mean_ms / 1e3,
               k1_launches=launches, k1_phase_ms=k1_phase_ms, k1_ms=k1_ms,
               sort_and_glue_ms=mean_ms - k1_ms,
               slot_tests=stats["slot_tests"],
               ray_bounces=stats["ray_bounces"],
               cull_rows=stats["cull_rows"],
               phase_slot_tests=stats["phase_slot_tests"],
               k1_bound_ms=bound_ms, k1_bound_by=bound_by,
               k1_bound_share=bound_ms / k1_ms,
               plain_k1_ms=plain_ms, plain_render_ms=plain_render_ms,
               profile=profiled)
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


def _k1d_bound(launches, n_rays: int):
    """Least time of one step's K1d launches: K1's operation count from the
    counters, or the bytes (ray state in and out of each phase, the records
    and the pay at bounces) over HBM, whichever is larger."""
    stats = {k: sum(l[k] for l in launches)
             for k in ("slot_tests", "cull_rows", "ray_bounces")}
    ops = (stats["slot_tests"] * OPS_PER_SLOT
           + stats["cull_rows"] * OPS_PER_CULL_ROW
           + stats["ray_bounces"] * OPS_PER_BOUNCE)
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


def _index_add_ms(captured, n_slots: int) -> float:
    """The library call for K2's slot reduction: one ``index_add_`` of each
    segment's per-bounce cotangents onto the slot table, timed with CUDA
    events on the main path's inputs and summed over the segments.  Only
    the bounce steps' rows are added (the others carry zeros, and sending
    them to one slot would time the contention of that slot instead)."""
    import torch
    from raytracers_tpu_torch.grad import replay_bwd as rb
    from raytracers_tpu_torch.utils.timing import cuda_ms
    total = 0.0
    for args, kw in captured.calls:
        step, _, _ = rb.replay_bwd(*args, **dict(kw, reduce_slots=None))
        ids = args[1].reshape(-1)
        bnc = ids >= 0
        src = step[:, :7].permute(0, 2, 1).reshape(-1, 7)[bnc].contiguous()
        idx = ids[bnc].long()
        del step
        tab = torch.zeros(n_slots, 7, dtype=torch.float32, device=src.device)
        total += cuda_ms(lambda: tab.index_add_(0, idx, src), warmup=1,
                         runs=3)
    return total


def phase_fwdbwd(port, name: str) -> dict:
    """The fwd+bwd main path at SIZE, depth DEPTH."""
    import torch
    from raytracers_tpu_torch.grad import replay_bwd as rb
    from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
    from raytracers_tpu_torch.render import megakernel as mk
    from raytracers_tpu_torch.utils.timing import cuda_ms
    spheres, cam, ps, (tile, block, schedule, prefix) = _diff_scene(
        port, name, SIZE)
    n_phases = len(schedule) + 1
    n_slots = ps.order.numel()
    cfg = dict(max_depth=DEPTH, tile=tile, block=block, schedule=schedule,
               sort_prefix=prefix)
    f = make_render_pallas_diff(SIZE, SIZE, **cfg)
    step = lambda: _grads(f, spheres, cam)                      # noqa: E731

    step()                                                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.megakernel.launches = rb.replay_bwd.launches = 0
    img, grads = step()
    torch.cuda.synchronize()
    launches = (mk.megakernel.launches, rb.replay_bwd.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != (n_phases, n_phases):
        raise SmokeError(f"{name}: one fwd+bwd step launched K1d and K2 "
                         f"{launches} times, not {n_phases} each")
    if img.shape != (SIZE, SIZE, 3) or not torch.isfinite(img).all():
        raise SmokeError(f"{name}: image {tuple(img.shape)} not finite")
    for g, what in zip(grads, ("centre", "radius", "colour", "origin",
                               "llc", "horizontal", "vertical")):
        if not torch.isfinite(g).all() or float(g.abs().max()) == 0.0:
            raise SmokeError(f"{name}: the {what} gradient is not finite "
                             "or is zero")

    fwdbwd_ms = [cuda_ms(step, warmup=0, runs=FB_REPEATS) for _ in range(3)]
    mean_ms = sum(fwdbwd_ms) / len(fwdbwd_ms)

    t_k1d = Timed(mk.megakernel, n_phases)
    t_k2 = Timed(rb.replay_bwd, n_phases)
    f_timed = make_render_pallas_diff(SIZE, SIZE, fwd_kernel=t_k1d,
                                      bwd_kernel=t_k2, **cfg)
    for _ in range(FB_REPEATS):
        _grads(f_timed, spheres, cam)
    k1d_ms, k2_ms = t_k1d.phase_ms(), t_k2.phase_ms()[::-1]    # by segment

    profiled = _device_profile(step)
    if profiled is None:
        log(f"[fwdbwd] {name}: torch.profiler saw no device kernels")

    counted, captured = Counted(mk), Captured(rb.replay_bwd)
    _grads(make_render_pallas_diff(SIZE, SIZE, fwd_kernel=counted,
                                   bwd_kernel=captured, **cfg), spheres, cam)
    n_rays = _n_rays(block)
    (k1d_bound, k1d_by), stats = _k1d_bound(counted.launches, n_rays)
    (k2_bound, k2_by), k2_scratch_ms = _k2_bound(counted.launches, n_rays,
                                                 n_slots)
    library_ms = _index_add_ms(captured, n_slots)
    del captured

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
    # sphere gradients: the kernel's slot tables sum in no fixed order, the
    # plain engine's in float64; per sphere they may differ by (count + 2
    # segments + 2) unit roundoffs of the sum of magnitudes
    ordv = ps.order.reshape(-1).long()
    real = ordv >= 0
    n_sph = spheres.center.shape[0]
    f64 = dict(dtype=torch.float64, device=ordv.device)
    mag = torch.zeros(n_sph, 7, **f64).index_add_(0, ordv[real],
                                                  p_k2.mag[real])
    count = torch.zeros(n_sph, **f64).index_add_(0, ordv[real],
                                                 p_k2.count[real])
    bound = (count[:, None] + 2 * n_phases + 2) * F32_EPS * mag
    got = torch.cat([grads[0], grads[1][:, None], grads[2]], 1).double()
    want = torch.cat([grads_p[0], grads_p[1][:, None], grads_p[2]],
                     1).double()
    sph_err = (got - want).abs()
    if (sph_err > bound).any():
        i = int((sph_err > bound).nonzero()[0, 0])
        raise SmokeError(f"{name}: sphere {i}'s gradient {got[i].tolist()} "
                         f"against the plain {want[i].tolist()}, bound "
                         f"{bound[i].tolist()}")
    cam_rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(grads[3:], grads_p[3:]))
    if cam_rel > 1e-6:
        raise SmokeError(f"{name}: the camera gradient differs from the "
                         f"plain engine's by {cam_rel} of its max")
    share = sph_err / torch.where(bound > 0, bound, 1.0)

    res = dict(scene=name, clusters=ps.n_clusters, tile=tile, block=block,
               schedule=schedule, sort_prefix=prefix,
               fwdbwd_ms=fwdbwd_ms, fwdbwd_ms_mean=mean_ms,
               k1d_launches=launches[0], k2_launches=launches[1],
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
               plain_k1d_ms=sum(p_k1d.phase_ms()),
               plain_k2_ms=sum(p_k2.timed.phase_ms()),
               plain_step_ms=plain_step_ms,
               grad_max_abs=[float(g.abs().max()) for g in grads],
               sphere_grad_max_abs_err=float(sph_err.max()),
               sphere_grad_rel_err=float(sph_err.max() / want.abs().max()),
               sphere_grad_err_share_of_bound=float(share.max()),
               camera_grad_rel_err=cam_rel,
               loss=float((img * img).sum()), profile=profiled)
    log(f"[fwdbwd] {json.dumps(res)}")
    return res


def _n_rays(block) -> int:
    return (-(-SIZE // block[0]) * block[0]) * (-(-SIZE // block[1])
                                                * block[1])


def _kernels_record(checkers, diff_checkers, results, fb_results) -> list:
    """One entry per kernel and scene: K1 from the render main path, K1d
    and K2 from the fwd+bwd main path; ``max_abs_err`` from the kernel
    against plain checks (K2's includes its slot tables)."""
    from raytracers_tpu_torch.render import _cuda
    src = {k: str(_cuda.source(k).relative_to(ROOT)) for k in _cuda.KERNELS}
    where = f"{SIZE}x{SIZE} d{DEPTH}"
    out = []
    for r in results:
        out.append(dict(
            name=f"K1 megakernel ({r['scene']} {where})", route="cuda",
            source=src["megakernel"],
            replaces="raytracers_tpu/render/pallas_kernel.py:319",
            launches=r["k1_launches"],
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
            launches=r["k1d_launches"], max_abs_err=k1.max_abs_err,
            ms=r["k1d_ms"], plain_ms=r["plain_k1d_ms"],
            bound_ms=r["k1d_bound_ms"], bound_by=r["k1d_bound_by"],
            library_ms=None))
        out.append(dict(
            name=f"K2 replay_bwd ({r['scene']} fwd+bwd {where})",
            route="cuda", source=src["replay_bwd"],
            replaces="raytracers_tpu/grad/pallas_replay_bwd.py:104",
            launches=r["k2_launches"], max_abs_err=k2.max_abs_err,
            table_err_share_of_bound=k2.table_err_share,
            ms=r["k2_ms"], plain_ms=r["plain_k2_ms"],
            bound_ms=r["k2_bound_ms"], bound_by=r["k2_bound_by"],
            library_ms=r["k2_library_ms"]))
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
        checkers = phase_kernel_vs_plain(port)
        diff_checkers = phase_diff_kernels_vs_plain(port)
        phase_goldens(port)
        results = [phase_main_path(port, name, checkers[name])
                   for name in SCENES]
        fb_results = [phase_fwdbwd(port, name) for name in SCENES]
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": _kernels_record(checkers, diff_checkers,
                                                 results, fb_results)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
