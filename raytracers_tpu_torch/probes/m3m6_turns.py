"""M3 and M6 of two builds of their sources, in turns on one card.

It builds ``csrc/microbench.cu`` and ``csrc/microbench_v5.cu`` as they
stand (``change``) and those of another checkout under ``--parent DIR``
(``parent``, e.g. the parent commit unpacked with ``git archive``), and
the side builds below, one nvcc a source, all together (``turns.build``).  M1 runs once, whole, on the change's
build: its division and 1/x chains give FCHK's rate
(``microbench.fchk_lanes_per_cycle``), which M1's recounted bound takes.
Then ``microbench.run_m3`` and ``microbench_v5.run_m6`` run whole on each
build in turns (parent, change, change, parent, twice).  The parent's C
entries take the change's codes; its M6 kernels read the (8, W) table
for both ways (``launch_gather``).  Each route is held bit for bit to its
plain version on the TPU probes' inputs and the seeded ones, and carries
the device's own time where its window is under
``microbench.DEVICE_MS_BELOW``.  Then side builds of the change's sources,
one constant rewritten in each (``SIDES``), run in turns with the change:
the shuffle way's lanes a column (the card's sweep of k), M6's slots
between neighbouring lanes and the order of the ``ldg`` way's two halves
(the wavefronts and lines a warp's load takes at the same bytes,
``load_model``) and the shared way staged once a tile.  It
prints a line a route with the medians of its turns, the parent's beside
the change's, and writes a JSON record:

    python -m raytracers_tpu_torch.probes.m3m6_turns --parent build/parent \\
        --out docs/M3M6_TURNS_H100.json --record docs/MICROBENCH_H100.json \\
        --record-v5 docs/MICROBENCH_V5_H100.json

``--record FILE`` replaces the M3 entries of that probe record by the
change's last turn, recounts its M1 entries' bounds (``fma_pipes``; their
times and M1's weights stay) and replaces its SASS counts by the change's
build; ``--record-v5 FILE`` does the same for M6 in the M5/M6 record.  It
needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import numpy as np
import torch

from . import microbench as mb
from . import microbench_v5 as v5
from .turns import ORDER, build, medians, rewrite, use

KERNELS = ("microbench", "microbench_v5")
ROW_KEYS = ("probe", "label", "bound_ms", "bound_by", "bound_row",
            "old_bound_ms")
# side builds: name -> (kernel, [(a line of its source, its rewrite)]):
# the shuffle way's lanes a column; M6's slots between neighbouring lanes,
# with the ldg way's halves in the kernel's order (every lane's lower half
# first, as K1 reads them) or its upper half first where bit 2 of the lane
# is set (``_alt``); the shared way staged once a tile
SHUFFLE_K, STRIDES = (2, 4, 16, 32), (1, 2, 4, 37)
_ALT_ORDER = ("const float4 lo = __ldg(p), hi = __ldg(p + 1);",
              "const int swap = (threadIdx.x >> 2) & 1;\n"
              "        const float4 a = __ldg(p + swap), "
              "b = __ldg(p + (swap ^ 1));\n"
              "        const float4 lo = swap ? b : a, hi = swap ? a : b;")


def _stride(s):
    return ("constexpr int kSlotStride = 37;",
            f"constexpr int kSlotStride = {s};")


SIDES = {
    **{f"shuffle_k{k}": ("microbench", [(
        "constexpr int kShuffleLanes = 8;",
        f"constexpr int kShuffleLanes = {k};")]) for k in SHUFFLE_K},
    **{f"stride{s}": ("microbench_v5", [_stride(s)])
       for s in STRIDES if s != 37},
    **{f"stride{s}_alt": ("microbench_v5", [_stride(s), _ALT_ORDER])
       for s in STRIDES},
    "smem_each_tile": ("microbench_v5", [(
        "const int blocks = resident > 0 && resident < tiles ? resident : "
        "tiles;", "const int blocks = tiles;")])}
SIDE_ORDER = ("change", *SIDES, *reversed(SIDES), "change") * 2


def launch_gather(salt, table, n_lanes, chunks, way, iters):
    """M6's C entry on ``table`` as given, under ``gather``'s label: the
    parent's kernels read the (8, W) table for both ways, and the change's
    ``ldg`` a table already slot-major (``ldg_copy_share``)."""
    out = torch.empty((n_lanes // v5.T, 1, v5.T), device=salt.device)
    return mb._launch(v5.gather_label(chunks, way, n_lanes), out, 1,
                      v5.GATHER_WAYS.index(way), chunks, 0, iters, n_lanes,
                      salt, table, None, out, kernel="microbench_v5")


def _turn(dev, name, log):
    return mb.run_m3(dev, log) + (v5._run_m6(dev, log, launch_gather)
                                  if name == "parent" else v5.run_m6(dev, log))


def rows_of(turns, log=print, tag="m3m6") -> list:
    """A row an entry name (M3: a route; M6: a route, width, lane count and
    input): each build's times by turn, their medians, shares and the
    parent's median over the change's where the parent has the route;
    logged under ``[tag]``."""
    rows = {}
    for t in turns:
        for e in t["entries"]:
            row = rows.setdefault(e["name"], dict(
                name=e["name"], **{k: e.get(k) for k in ROW_KEYS},
                ms={}, ms_seeded={}, device_ms={}))
            n = t["build"]
            row["ms"].setdefault(n, []).append(e["ms"])
            if "ms_seeded" in e:
                row["ms_seeded"].setdefault(n, []).append(e["ms_seeded"])
            if e.get("device_ms") is not None:
                row["device_ms"].setdefault(n, []).append(e["device_ms"])
    for row in rows.values():
        for k in ("ms", "ms_seeded", "device_ms"):
            row[f"median_{k}"] = medians(row[k])
        med = row["median_ms"]
        row["share"] = {n: row["bound_ms"] / m for n, m in med.items()}
        row["parent_over_change"] = (med["parent"] / med["change"]
                                     if {"parent", "change"} <= med.keys()
                                     else None)
        dev = row["median_device_ms"]
        log(f"[{tag}] {row['name']}: " + "; ".join(
            f"{n} {m:.4f} ms ({row['share'][n]:.3f} of {row['bound_ms']:.4f}"
            f" on {row['bound_row']}; old {row['old_bound_ms']:.4f})"
            + (f", device {dev[n]:.4f}" if n in dev else "")
            for n, m in med.items())
            + (f"; parent / change {row['parent_over_change']:.3f}"
               if row["parent_over_change"] else ""))
    return list(rows.values())


def host_floor(dev, log=print) -> dict:
    """The host's cost of a call: the windowed time of each M3 route but
    the serial loop and each M6 way at 8,192 lanes with 0 iterations,
    where the kernel does no work."""
    salt = torch.tensor([mb.SALT], device=dev)
    out = {}
    for dtype, way in mb.reduce_routes():
        if way != "serial":
            v = mb._reduce_inputs(dtype, "tpu", dev)
            out[mb.reduce_label(dtype, way)] = mb._timed(
                lambda: mb.reduce_min(v, 0, mb.REDUCE_GRID, way),
                min_window_ms=50.0)[0]
    tbl = torch.from_numpy(v5.gather_inputs("tpu", 4)).to(dev)
    for way in v5.GATHER_WAYS:
        out[v5.gather_label(4, way, v5.LANES[0])] = mb._timed(
            lambda: v5.gather(salt, tbl, v5.LANES[0], 4, way, 0),
            min_window_ms=50.0)[0]
    for k, ms in out.items():
        log(f"[m3m6] host floor, {k} with 0 iterations: {ms:.4f} ms")
    return out


def ldg_copy_share(dev, log=print) -> list:
    """M6's ``ldg`` at 1,048,576 lanes with its slot-major copy made in
    each call (the route) and made once before the window (the kernel on a
    table already slot-major), in turns (with, without, without, with)."""
    salt = torch.tensor([mb.SALT], device=dev)
    n = v5.LANES[-1]
    out = []
    for chunks in v5.CHUNKS:
        tbl = torch.from_numpy(v5.gather_inputs("seeded", chunks)).to(dev)
        pre = v5.slot_major(tbl)
        ref = v5.gather_plain(salt, tbl, n, chunks)
        calls = {"with": lambda: v5.gather(salt, tbl, n, chunks, "ldg"),
                 "without": lambda: launch_gather(salt, pre, n, chunks, "ldg",
                                                  v5.GATHER_ITERS)}
        ms = {"with": [], "without": []}
        for k in ("with", "without", "without", "with"):
            t, y, _, _ = mb._timed(calls[k], min_window_ms=50.0)
            mb._bit_equal(f"M6 ldg c{chunks} {k} the copy", y, ref)
            ms[k].append(t)
        med = medians(ms)
        out.append(dict(chunks=chunks, lanes=n, ms=ms, median_ms=med))
        log(f"[m3m6] M6 ldg c{chunks} {n}: the copy in the call "
            f"{med['with']:.4f} ms, made once {med['without']:.4f} ms")
    return out


def side_sources() -> dict:
    """``SIDES`` written out (``turns.rewrite``): {name: {kernel: path}}."""
    return {name: {kernel: rewrite(kernel, name, edits)}
            for name, (kernel, edits) in SIDES.items()}


def load_model(stride: int, width: int, alt: bool,
               iters: int = v5.GATHER_ITERS) -> dict:
    """A warp's 16-byte ``ldg`` loads where lane j reads slot (j * stride
    + i) mod width of the slot-major table (32 bytes a slot, 4 a 128-byte
    line), its lower half first, as the kernel, or (``alt``) its upper
    half first where bit 2 of j is set; averaged over the warps of
    a 512-lane tile, the steps and the two loads: the distinct lines a
    load touches, and its wavefronts (L1 serves a 16-byte unit from each
    of 8 bank groups a wavefront; lanes at one address share it), with
    the least time of 1M lanes' 64 steps at one wavefront a cycle an SM."""
    lane = np.arange(v5.T)
    first = (lane >> 2) & 1 if alt else 0 * lane
    warps = v5.T // 32
    lines = waves = 0
    for i in range(iters):
        slot = (lane * stride + i) % width
        lines += 2 * sum(len(set(w)) for w in (slot // 4).reshape(warps, 32)
                         .tolist())
        for half in (first, first ^ 1):
            for w in (2 * slot + half).reshape(warps, 32).tolist():
                waves += max(collections.Counter(u % 8 for u in set(w))
                             .values())
    loads = 2 * iters * warps
    per_load = waves / loads
    cycles = 2 * per_load * v5.LANES[-1] / 32 * iters / mb.N_SMS
    return dict(lines=lines / loads, wavefronts=per_load,
                wavefront_ms=cycles / mb.SM_CLOCK_HZ * 1e3)


def strided_plain(tbl, n_lanes, chunks, stride, iters=v5.GATHER_ITERS):
    """``gather_plain`` with lane j's slots starting at j * ``stride``."""
    width = chunks * 128
    lid = torch.arange(v5.T, device=tbl.device)
    acc = torch.zeros(v5.T, device=tbl.device)
    for i in range(iters):
        f = tbl[:, (lid * stride + i) % width]
        s = torch.zeros_like(acc)
        for fld in range(8):
            s = s + f[fld]
        acc = acc + s
    return acc.reshape(1, 1, v5.T).expand(n_lanes // v5.T, 1, v5.T)


def _side_calls(dev) -> dict:
    """{build: {label: (call, its reference)}}: M3's shuffle way on the TPU
    probe's keys for the change and each k; M6's ``ldg`` at 1M lanes, both
    widths, on the seeded tables for the change and each stride and order,
    and the shared way for the change and the staging once a tile."""
    salt = torch.tensor([mb.SALT], device=dev)
    n = v5.LANES[-1]
    m3 = {}
    for dtype in mb.REDUCE_DTYPES:
        v = mb._reduce_inputs(dtype, "tpu", dev)
        m3[mb.reduce_label(dtype, "shuffle")] = (
            lambda v=v: mb.reduce_min(v, mb.REDUCE_ITERS, mb.REDUCE_GRID,
                                      "shuffle"),
            mb.reduce_plain(v, mb.REDUCE_ITERS, mb.REDUCE_GRID))
    tbls = {c: torch.from_numpy(v5.gather_inputs("seeded", c)).to(dev)
            for c in v5.CHUNKS}

    def m6(way, stride=v5.SLOT_STRIDE):
        return {v5.gather_label(c, way, n): (
            lambda c=c: v5.gather(salt, tbls[c], n, c, way),
            strided_plain(tbls[c], n, c, stride)) for c in v5.CHUNKS}
    calls = {"change": {**m3, **m6("ldg"), **m6("smem")}}
    calls.update({f"shuffle_k{k}": m3 for k in SHUFFLE_K})
    calls.update({f"stride{s}": m6("ldg", s) for s in STRIDES if s != 37})
    calls.update({f"stride{s}_alt": m6("ldg", s) for s in STRIDES})
    calls["smem_each_tile"] = m6("smem")
    return calls


def side_turns(libs: dict, dev, log=print) -> dict:
    """Each side build's calls (``_side_calls``) in ``SIDE_ORDER``, the
    change's among them: windowed times, the device's own time of the M3
    calls, each output bit-equal to its reference; medians by build and
    label, and ``load_model`` of each stride, order and width."""
    from ..utils.profiling import device_ms
    calls = _side_calls(dev)
    ms: dict = {}
    dev_ms: dict = {}
    for name in SIDE_ORDER:
        use(libs, "change")
        use(libs, name)
        for label, (fn, ref) in calls[name].items():
            t, y, _, _ = mb._timed(fn, min_window_ms=50.0)
            mb._bit_equal(f"{label} ({name})", y, ref.expand_as(y))
            ms.setdefault(label, {}).setdefault(name, []).append(t)
            if label.startswith("M3"):
                dev_ms.setdefault(label, {}).setdefault(name, []).append(
                    device_ms(fn, t, clock_hz=mb.SM_CLOCK_HZ))
    use(libs, "change")
    out = dict(order=SIDE_ORDER, ms=ms, device_ms=dev_ms,
               median_ms={k: medians(v) for k, v in ms.items()},
               median_device_ms={k: medians(v) for k, v in dev_ms.items()},
               load_model={f"stride{s}{k} c{c}": load_model(
                   s, c * 128, k == "_alt") for s in STRIDES
                   for k in ("", "_alt") for c in v5.CHUNKS})
    for label, med in out["median_ms"].items():
        dmed = out["median_device_ms"].get(label, {})
        log(f"[m3m6] side {label}: " + "; ".join(
            f"{n} {m:.4f} ms" + (f" (device {dmed[n]:.4f})" if n in dmed
                                 else "") for n, m in med.items()))
    for k, m in out["load_model"].items():
        log(f"[m3m6] {k}: {m['lines']:.3f} lines and {m['wavefronts']:.3f} "
            f"wavefronts a warp's load, {m['wavefront_ms']:.4f} ms at 1M "
            "lanes")
    return out


def profiled(dev, log=print) -> dict:
    """torch.profiler's device time of one call (``device_profile``, 20
    calls) beside ``device_ms``'s, for each M3 route but the serial loop
    and each M6 way at 8,192 lanes, on the change's build; last, since a
    profiled process pays more host time a launch afterwards."""
    from ..utils.profiling import device_ms, device_profile
    salt = torch.tensor([mb.SALT], device=dev)
    keys = {d: mb._reduce_inputs(d, "tpu", dev) for d in mb.REDUCE_DTYPES}
    tbl = torch.from_numpy(v5.gather_inputs("tpu", 4)).to(dev)
    calls = {mb.reduce_label(d, w): (lambda d=d, w=w: mb.reduce_min(
        keys[d], mb.REDUCE_ITERS, mb.REDUCE_GRID, w))
        for d, w in mb.reduce_routes() if w != "serial"}
    calls.update({v5.gather_label(4, w, v5.LANES[0]): (
        lambda w=w: v5.gather(salt, tbl, v5.LANES[0], 4, w))
        for w in v5.GATHER_WAYS})
    out = {}
    for name, fn in calls.items():
        window = mb._timed(fn, min_window_ms=50.0)[0]
        events = device_ms(fn, window, clock_hz=mb.SM_CLOCK_HZ)
        prof = device_profile(lambda: [fn() for _ in range(20)])
        out[name] = dict(events_ms=events,
                         profiler_ms=prof["device_busy_ms"] / 20,
                         kernels_ms={n: t / 20 for n, t
                                     in prof["top_kernels_ms"]})
        log(f"[m3m6] {name}: device {events:.4f} ms by events, "
            f"{out[name]['profiler_ms']:.4f} by torch.profiler")
    return out


def run(libs: dict, log=print) -> dict:
    """M1 once on the change's build, then ``run_m3`` and ``run_m6`` on the
    parent's and the change's builds in ``libs`` (``turns.build``'s) in
    turns, ``side_turns``, then on the change's ``host_floor``,
    ``ldg_copy_share`` and ``profiled``; the record of the call: M1's
    entries and FCHK's rate, every turn's entries, a row an entry name,
    those four and the SASS counts of every build's M3 and M6 kernels."""
    dev = torch.device("cuda")
    card = mb._smi("name,power.limit")
    log(f"[m3m6] {card}")
    use(libs, "change")
    with mb.ClockSampler() as clocks:
        m1 = mb.run_m1(dev, clocks, log)
    fchk = mb.fchk_lanes_per_cycle(m1)
    log(f"[m3m6] FCHK {fchk:.3f} lanes a cycle an SM (division over 1/x, "
        "8 streams)")
    turns = []
    for name in ORDER:
        use(libs, name)
        log(f"[m3m6] turn {len(turns) + 1} of {len(ORDER)}: {name}")
        turns.append(dict(build=name, entries=_turn(dev, name, log)))
    side = side_turns(libs, dev, log)
    floor = host_floor(dev, log)
    copy = ldg_copy_share(dev, log)
    prof = profiled(dev, log)
    sass = {n: {f: c for _, so in b.values()
                for f, c in mb.sass_counts(str(so))[0].items()
                if "reduce_" in f or "gather_" in f}
            for n, b in libs.items()}
    return dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                script="raytracers_tpu_torch/probes/m3m6_turns.py",
                order=ORDER, m1=m1, fchk_lanes_per_cycle=fchk,
                rows=rows_of(turns, log), host_floor_ms=floor,
                side=side, ldg_copy=copy, profiled=prof, sass=sass,
                turns=turns)


def recount_m1(e: dict) -> dict:
    """An M1 entry of a record with its bound recounted by row
    (``fma_pipes``), the bound it had kept beside it as ``old_*``."""
    if "bound_row" in e:
        return e
    pipes = mb.fma_pipes(mb.FMA_N, e["streams"], e["iters"], e["mode"])
    bound_ms, bound_by, row = mb.pipe_bound(pipes, e["bytes"])
    return dict(e, old_bound_ms=e["bound_ms"], old_bound_by=e["bound_by"],
                old_share=e["share"], pipes=pipes, bound_ms=bound_ms,
                bound_by=bound_by, bound_row=row, share=bound_ms / e["ms"])


def rerecord(path: Path, rec: dict, probe: str, so: Path, log=print) -> None:
    """Replace the ``probe`` (M3 or M6) entries of the probe record at
    ``path`` by the change's last turn in ``rec`` (``run``'s), in place;
    recount its M1 entries; replace its SASS counts by those of the
    change's build at ``so``."""
    out = json.loads(path.read_text())
    new = [e for e in [t for t in rec["turns"] if t["build"] == "change"][-1]
           ["entries"] if e["probe"] == probe]
    at = next(i for i, e in enumerate(out["entries"]) if e["probe"] == probe)
    rest = [recount_m1(e) if e["probe"] == "M1" else e
            for e in out["entries"] if e["probe"] != probe]
    out["entries"] = rest[:at] + new + rest[at:]
    out["sass"] = mb.sass_counts(str(so))[0]
    out[f"{probe.lower()}_run"] = {k: rec[k] for k in ("card", "torch",
                                                       "cuda", "script")}
    if probe == "M3":
        out["fchk_lanes_per_cycle"] = rec["fchk_lanes_per_cycle"]
    path.write_text(json.dumps(out, indent=1) + "\n")
    log(f"[m3m6] wrote {probe} into {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracers_tpu_torch.probes.m3m6_turns",
        description="M3 and M6 of two builds of their sources, in turns")
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout whose csrc/ holds the parent sources")
    ap.add_argument("--out", default=None, help="where the JSON goes")
    ap.add_argument("--record", type=Path, default=None,
                    help="an M1-M4 probe record whose M3 entries to replace")
    ap.add_argument("--record-v5", type=Path, default=None,
                    help="an M5/M6 probe record whose M6 entries to replace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("m3m6_turns measures on the card; no CUDA device")
    libs = build(args.parent, *KERNELS, sides=side_sources())
    rec = run(libs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
        print(f"[m3m6] wrote {args.out}")
    for path, probe, kernel in ((args.record, "M3", "microbench"),
                                (args.record_v5, "M6", "microbench_v5")):
        if path is not None:
            rerecord(path, rec, probe, libs["change"][kernel][1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
