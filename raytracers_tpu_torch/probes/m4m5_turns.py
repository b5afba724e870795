"""M4 and M5, the visit probes, of two builds of their sources in turns on
one card, and the sweep of k lanes a ray.

It builds ``csrc/microbench.cu`` and ``csrc/microbench_v5.cu`` as they
stand (``change``) and those of another checkout under ``--parent DIR``
(``parent``, e.g. the parent commit unpacked with ``git archive``), and
the side builds below, one nvcc a source, all together (``turns.build``).
M1's weights, which the bounds charge for a root and 1/a, are measured
once.  Then ``microbench.run_m4`` and ``microbench_v5.run_m5`` run
whole on each build in turns (parent, change, change, parent, twice; the
parent's through ``_run_m4`` and ``_run_m5``): the parent's ``thread``
and ``warp`` (its C entries' way codes 0 and 1), the change's ``thread``
and ``lanes``, every width, payload and ray count on both inputs, each
bit-equal to its plain version, with the device's own time under
``microbench.VISIT_DEVICE_MS_BELOW``.  Then side builds of the change's
sources, lines rewritten (``side_specs``), run in turns with the change
(change, sides, the sides reversed, change, twice): k lanes a ray in {4,
8, 16, 32} at every M5 width and for M4, in K1's slot-major layout and on
the field-major (8, rows) copy (made before the calls; M4's loads of a
row rewritten for it, ``M4_FIELD``), M4's shifted table added by each
lane where the change forms it once a visit in shared memory
(``M4_SHIFT``), and the visit kernels' launch bounds asking for one block
an SM at least; each on the TPU probes' inputs (``mxu`` for M5) at every
ray count, bit-equal before it is timed.  It prints a line a row with the
medians, the sweep by k with the k each probe and width would take at the
TPU probe's size (8,192 rays for M5, 4,096 for M4), and writes a JSON
record:

    python -m raytracers_tpu_torch.probes.m4m5_turns --parent build/parent \\
        --out docs/M4M5_TURNS_H100.json --record docs/MICROBENCH_H100.json \\
        --record-v5 docs/MICROBENCH_V5_H100.json

``--record FILE`` replaces the M4 entries of that probe record by the
change's last turn, and its SASS counts by the change's build
(``m3m6_turns.rerecord``); ``--record-v5 FILE`` does the same for M5.  It
needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from functools import partial
from pathlib import Path

import torch

from ..render import _cuda
from . import microbench as mb
from . import microbench_v5 as v5
from .m3m6_turns import rerecord, rows_of
from .turns import ORDER, build, medians, rewrite, use

KERNELS = ("microbench", "microbench_v5")
SWEEP_K = (4, 8, 16, 32)
# the parent's C entries' way codes and lanes a ray
PARENT_WAYS = {"thread": (0, 1), "warp": (1, 32)}
# the lines of the sources a side build rewrites, as format strings
M5_LANES = "constexpr int kVisitLanes[3] = {{{}, {}, {}}};"
M5_FIELD = "constexpr bool kFieldMajor[3] = {{{}, {}, {}}};"
M4_LANES = "constexpr int kVisitLanes = {};"
# M4's source reads K1's slot-major table and forms the shifted table once
# a visit: (its lines, a side's) for the field-major (8, 128) copy, a
# 4-byte load a field, and for the shift added by each lane
M4_FIELD = ("""\
  const float4* p = reinterpret_cast<const float4*>(t + 8 * row);
  float4 lo, hi;
  if constexpr (kShifted) {
    lo = p[0];
    hi = p[1];
  } else {
    lo = __ldg(p);
    hi = __ldg(p + 1);
  }
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
""", """\
#pragma unroll
  for (int f = 0; f < 8; ++f)
    if constexpr (kShifted) v[f] = t[f * kRows + row];
    else v[f] = __ldg(t + f * kRows + row);
""")
M4_SHIFT = ("  constexpr bool kStage = kLanes > 1;",
            "  constexpr bool kStage = false;")
# the visit kernels' launch bounds: 256 threads a block, and the blocks an
# SM should hold at least, which ptxas's register budget follows
BOUNDS = "__launch_bounds__({})\nvisit_lanes("


def _find(kernel: str, fmt: str) -> tuple:
    """The values in the one line of ``kernel``'s source that ``fmt``
    formats."""
    pat = re.escape(fmt).replace(r"\{\}", "(true|false|[0-9]+(?:, [0-9]+)?)")
    pat = pat.replace(r"\{\{", r"\{").replace(r"\}\}", r"\}")
    found = re.findall(pat, _cuda.source(kernel).read_text())
    if len(found) != 1:
        raise ValueError(f"{kernel}: {fmt!r} matches {len(found)} lines")
    return found[0] if isinstance(found[0], tuple) else (found[0],)


def _layout(flag: str) -> str:
    return "field" if flag == "true" else "slot"


def _flag(layout: str) -> str:
    return "true" if layout == "field" else "false"


def change_spec() -> dict:
    """The sources' lanes way: (k, layout) of M5 by width (``m5``) and of
    M4 (``m4``, K1's slot-major layout), whether M4 forms the shifted table
    once a visit (``shift``, which it does), and the visit kernels' launch
    bounds (``bounds``, the two sources' alike)."""
    m5 = {r: (int(k), _layout(f)) for r, k, f in zip(
        v5.ROWS, _find("microbench_v5", M5_LANES),
        _find("microbench_v5", M5_FIELD))}
    bounds = {_find(kernel, BOUNDS)[0] for kernel in KERNELS}
    if len(bounds) != 1:
        raise ValueError("the M4 and M5 sources differ in launch bounds")
    return dict(m5=m5, m4=(int(_find("microbench", M4_LANES)[0]), "slot"),
                shift=True, bounds=bounds.pop())


def side_specs() -> dict:
    """{name: spec} of the side builds, as ``change_spec``'s: k in
    ``SWEEP_K`` at every width in K1's slot-major layout (``k4``, ...) and
    in the field-major one (``field_k4``, ...), M4's shift added by each
    lane (``shift_each``), and the visit kernels' launch bounds asking for
    one block an SM at least (``min_blocks1``), or none where the change
    asks for it; none that equals the change."""
    ch = change_spec()
    specs = {f"{'field_' if layout == 'field' else ''}k{k}": dict(
        ch, m5=dict.fromkeys(v5.ROWS, (k, layout)), m4=(k, layout))
        for layout in mb.VISIT_LAYOUTS for k in SWEEP_K}
    specs["shift_each"] = dict(ch, shift=False)
    specs["min_blocks0" if ", " in ch["bounds"] else "min_blocks1"] = dict(
        ch, bounds="256" if ", " in ch["bounds"] else "256, 1")
    return {n: s for n, s in specs.items() if side_edits(s)}


def side_edits(spec: dict) -> dict:
    """{kernel: [(a line of its source, its rewrite)]} that turn the
    change's sources into ``spec``'s; a kernel that needs none is left
    out."""
    ch = change_spec()
    out: dict = {}

    def edit(kernel, fmt, old, new):
        if old != new:
            out.setdefault(kernel, []).append((fmt.format(*old),
                                               fmt.format(*new)))
    edit("microbench_v5", M5_LANES, [ch["m5"][r][0] for r in v5.ROWS],
         [spec["m5"][r][0] for r in v5.ROWS])
    edit("microbench_v5", M5_FIELD, [_flag(ch["m5"][r][1]) for r in v5.ROWS],
         [_flag(spec["m5"][r][1]) for r in v5.ROWS])
    edit("microbench", M4_LANES, [ch["m4"][0]], [spec["m4"][0]])
    if spec["m4"][1] == "field":
        out.setdefault("microbench", []).append(M4_FIELD)
    if not spec["shift"]:
        out.setdefault("microbench", []).append(M4_SHIFT)
    for kernel in KERNELS:
        edit(kernel, BOUNDS, [ch["bounds"]], [spec["bounds"]])
    return out


def side_sources() -> dict:
    """``side_specs`` written out (``turns.rewrite``): {name: {kernel:
    path}}."""
    return {name: {kernel: rewrite(kernel, name, edits)
                   for kernel, edits in side_edits(spec).items()}
            for name, spec in side_specs().items()}


def launch_m4(way, code, salt, sphT, sph8, n_rays, iters):
    """M4's C entry with way code ``code`` (lanes a ray; the parent's 0
    and 1), under ``way``'s label, on the tables as given."""
    out = torch.empty((n_rays // mb.T, 8, mb.T), device=salt.device)
    return mb._launch(mb.visit_label(way, n_rays), out, 3, code, 0, iters,
                      n_rays, salt, sphT, sph8, out)


def launch_m5(way, code, salt, sphT, sph8, n_rays, rows, payload, iters):
    """M5's C entry, as ``launch_m4``."""
    out = torch.empty((n_rays // v5.T, 8, v5.T), device=salt.device)
    return mb._launch(v5.visit_label(rows, payload, way, n_rays), out, 0,
                      code, rows, v5.PAYLOADS.index(payload), iters, n_rays,
                      salt, sphT, sph8, out, kernel="microbench_v5")


def parent_calls() -> tuple[dict, dict]:
    """``microbench._run_m4``'s and ``microbench_v5._run_m5``'s calls of
    the parent's builds: its ``thread`` and ``warp`` by its C entries' way
    codes."""
    m4_calls, m5_calls = {}, {}
    for way, (code, lanes) in PARENT_WAYS.items():
        m4_calls[way] = (lanes, partial(launch_m4, way, code))
        m5_calls[way] = (dict.fromkeys(v5.ROWS, (lanes, "slot")),
                         partial(launch_m5, way, code))
    return m4_calls, m5_calls


def _turn(dev, name, weights, log):
    if name == "parent":
        m4c, m5c = parent_calls()
        return (mb._run_m4(dev, weights, log, m4c)
                + v5._run_m5(dev, weights, log, m5c))
    return mb.run_m4(dev, weights, log) + v5.run_m5(dev, weights, log)


def _table(t, layout):
    """The table a build of ``layout`` reads: ``t`` (rows, 8) as it is, or
    its field-major (8, rows) copy."""
    return t if layout == "slot" else v5.field_major(t)


def side_calls(dev, spec: dict, kernels) -> dict:
    """{label: (call, its reference)} of a build of ``spec`` whose
    ``kernels`` were rewritten (all of them for the change): M5's lanes
    way, ``mxu``, at every width and ray count, and M4's lanes way at every
    ray count, on the TPU probes' inputs, through the C entry at the
    build's k, on a table in the build's layout made before the calls."""
    salt = torch.tensor([mb.SALT], device=dev)
    calls = {}
    if "microbench_v5" in kernels:
        for rows in v5.ROWS:
            sphT, sph8 = v5._dev_inputs(v5.visit_v5_inputs("tpu", rows), dev)
            ref = v5.visit_v5_tile(*v5.visit_v5_state_plain(
                salt, sphT, sph8, rows, "mxu", v5.ITERS))
            k, layout = spec["m5"][rows]
            tbl = _table(sphT, layout)
            for n in v5.RAYS:
                calls[f"M5 r{rows} {n}"] = (partial(
                    launch_m5, "lanes", k, salt, tbl, sph8, n, rows, "mxu",
                    v5.ITERS), ref)
    if "microbench" in kernels:
        sphT, sph8 = (torch.from_numpy(x).to(dev)
                      for x in mb.visit_inputs("tpu"))
        krun, pay = mb.visit_state_plain(salt, sphT, sph8)
        k, layout = spec["m4"]
        tbl = _table(sphT, layout)
        for n in mb.VISIT_RAYS:
            calls[f"M4 {n}"] = (partial(launch_m4, "lanes", k, salt, tbl,
                                        sph8, n, mb.VISIT_ITERS),
                                pay + krun.float())
    return calls


def side_turns(libs: dict, dev, log=print) -> dict:
    """Each side build's calls (``side_calls``) and the change's, in
    turns (change, sides, the sides reversed, change, twice): windowed
    times and the device's own under
    ``VISIT_DEVICE_MS_BELOW``, each output bit-equal to its reference;
    medians by label and build."""
    specs = {"change": change_spec(), **side_specs()}
    kernels = {n: libs[n].keys() for n in specs}
    calls = {n: side_calls(dev, s, kernels[n]) for n, s in specs.items()}
    order = tuple(specs)
    order = (*order, *reversed(order)) * 2
    ms: dict = {}
    dev_ms: dict = {}
    for name in order:
        use(libs, "change")
        use(libs, name)
        for label, (fn, ref) in calls[name].items():
            t, y, _, _ = mb._timed(fn, min_window_ms=50.0)
            mb._bit_equal(f"{label} ({name})", y, ref.expand_as(y))
            ms.setdefault(label, {}).setdefault(name, []).append(t)
            d = mb._device_entry(fn, t, mb.VISIT_DEVICE_MS_BELOW)
            if d:
                dev_ms.setdefault(label, {}).setdefault(name, []).append(
                    d["device_ms"])
    use(libs, "change")
    out = dict(order=order, specs=specs, ms=ms, device_ms=dev_ms,
               median_ms={k: medians(v) for k, v in ms.items()},
               median_device_ms={k: medians(v) for k, v in dev_ms.items()})
    for label, med in out["median_ms"].items():
        dmed = out["median_device_ms"].get(label, {})
        log(f"[m4m5] side {label}: " + "; ".join(
            f"{n} {m:.4f} ms" + (f" (device {dmed[n]:.4f})" if n in dmed
                                 else "") for n, m in med.items()))
    return out


def sweep(side: dict, log=print) -> dict:
    """From ``side_turns``' medians: each probe, width and ray count's time
    by k in the change's layout at that width (the device's own where it
    was taken), the other layout, the shift and the launch bounds as
    sides, and the k each would take at the TPU probe's size."""
    specs = side["specs"]
    ch = specs["change"]

    def route(spec, label):
        return spec["m4"] if label.startswith("M4") else spec["m5"][
            int(label.split()[1][1:])]
    rows, pick = {}, {}
    for label, med in side["median_ms"].items():
        dmed = side["median_device_ms"].get(label, {})
        by = {n: dmed.get(n, m) for n, m in med.items()}
        row = dict(by_k={}, sides={})
        for n, t in by.items():
            s = specs[n]
            (k, layout), own = route(s, label), route(ch, label)[1]
            if layout == own and all(s[x] == ch[x]
                                     for x in ("shift", "bounds")):
                row["by_k"][k] = t
            else:
                row["sides"][n] = dict(k=k, layout=layout, ms=t, **{
                    x: s[x] for x in ("shift", "bounds")})
        rows[label] = row
        best = min(row["by_k"], key=row["by_k"].get)
        log(f"[m4m5] sweep {label}: " + ", ".join(
            f"k{k} {t:.4f}" for k, t in sorted(row["by_k"].items()))
            + "".join(f"; {n} (k{v['k']}) {v['ms']:.4f}"
                      for n, v in row["sides"].items()) + f"; best k{best}")
        n = int(label.split()[-1])
        if n == (v5.RAYS[0] if label.startswith("M5") else mb.VISIT_RAYS[0]):
            pick[label] = best
    return dict(rows=rows, pick_at_probe_size=pick)


def load_models() -> dict:
    """``visit_load_model`` of each probe, layout and k."""
    return {f"{probe} {layout}": {k: mb.visit_load_model(k, layout, fields)
                                  for k in (1, *SWEEP_K)}
            for probe, fields in (("M4", mb.VISIT_FIELDS),
                                  ("M5", v5.VISIT_FIELDS))
            for layout in mb.VISIT_LAYOUTS}


def ptxas(libs: dict) -> dict:
    """Each build's ptxas lines (registers, spills) of its visit kernels,
    from ``turns.build``'s reports."""
    out = {}
    for name, built in libs.items():
        for kernel, (_, so) in built.items():
            log = Path(so).with_suffix(".log")
            text = log.read_text() if log.exists() else ""
            lines = text.splitlines()
            out[f"{name} {kernel}"] = [
                " ".join(x.strip() for x in lines[i:i + 4])
                for i, a in enumerate(lines)
                if "visit_" in a and "Compiling entry" in a]
    return out


def run(libs: dict, log=print) -> dict:
    """M1's weights once on the change's build, then ``run_m4`` and
    ``run_m5`` on the parent's and the change's builds in turns,
    ``side_turns`` and the ``sweep``; the record of the call."""
    dev = torch.device("cuda")
    card = mb._smi("name,power.limit")
    log(f"[m4m5] {card}")
    use(libs, "change")
    weights = mb.measure_mul_equivalents(dev)
    log(f"[m4m5] weights {weights}")
    turns = []
    for name in ORDER:
        use(libs, name)
        log(f"[m4m5] turn {len(turns) + 1} of {len(ORDER)}: {name}")
        turns.append(dict(build=name, entries=_turn(dev, name, weights,
                                                    log)))
    use(libs, "change")
    side = side_turns(libs, dev, log)
    sass = {n: {f: c for _, so in b.values()
                for f, c in mb.sass_counts(str(so))[0].items()
                if "visit_" in f}
            for n, b in libs.items()}
    return dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                script="raytracers_tpu_torch/probes/m4m5_turns.py",
                order=ORDER, mul_equivalents=weights,
                rows=rows_of(turns, log, tag="m4m5"), side=side,
                sweep=sweep(side, log), load_model=load_models(),
                ptxas=ptxas(libs), sass=sass, turns=turns)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracers_tpu_torch.probes.m4m5_turns",
        description="M4 and M5 of two builds of their sources, in turns, "
                    "and the sweep of k lanes a ray")
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout whose csrc/ holds the parent sources")
    ap.add_argument("--out", default=None, help="where the JSON goes")
    ap.add_argument("--record", type=Path, default=None,
                    help="an M1-M4 probe record whose M4 entries to replace")
    ap.add_argument("--record-v5", type=Path, default=None,
                    help="an M5/M6 probe record whose M5 entries to replace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("m4m5_turns measures on the card; no CUDA device")
    libs = build(args.parent, *KERNELS, sides=side_sources())
    rec = run(libs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
        print(f"[m4m5] wrote {args.out}")
    for path, probe, kernel in ((args.record, "M4", "microbench"),
                                (args.record_v5, "M5", "microbench_v5")):
        if path is not None:
            rerecord(path, rec, probe, libs["change"][kernel][1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
