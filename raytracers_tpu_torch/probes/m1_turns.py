"""M1, the FP32 issue probe, of two builds of its source in turns on one
card, and side builds of the source's loop control, FFMA's operand and
launch shape.

It builds ``csrc/microbench.cu`` as it stands (``change``) and that of
another checkout under ``--parent DIR`` (``parent``, e.g. the parent commit
unpacked with ``git archive``), and side builds of the change's source, one
line rewritten in each (``turns.rewrite``): the FP32 steps' loop unrolled
8, 16, 32 and 64 times (``UNROLL``); FFMA's m read from the constant bank
or from a register, at unroll 8 and at the change's (``CONST_M``: the
chains it is read there at, ``SCOPES``); 128, 256 and 512 threads a block
(``BLOCK``); the MUFU steps' loop unrolled 8 and 32 times
(``MUFU_UNROLL``); one nvcc a source, all together (``turns.build``).  The
plain versions' outputs are formed once on the card
(``microbench.fma_refs``).  Then
``microbench._run_m1`` runs whole on each build in turns (parent, change,
change, parent, twice), and on the change and the side builds in turns
(change, sides, the sides reversed, change, twice): every one of the 15
variants, held against ``fma_plain`` before it is timed (bit-equal; FFMA
within its steps' ulps), with the device's own time under
``microbench.M1_DEVICE_MS_BELOW``.  For each build it reads the SASS of
the FP32 chains' main loop (``loop_sass``): the instructions a pass, the
FP32 ones, each FP32 instruction with its registers and ``.reuse`` flags,
and the share of the FP32 pipe a pass allows at one and at two issue
cycles an FP32 instruction (``microbench.fma_issue_share``).  It prints a
line a variant with the medians and writes a JSON record:

    python -m raytracers_tpu_torch.probes.m1_turns --parent build/parent \\
        --out docs/M1_TURNS_H100.json --record docs/MICROBENCH_H100.json

``--record FILE`` replaces the M1 entries of that probe record by the
change's last turn and its SASS counts by the change's build; the record's
weights (``mul_equivalents``, FCHK's rate), which M4's bounds were taken
at, stay, and this run's stand beside them under ``m1_run``.  It needs the
card and nvcc.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import sys
from pathlib import Path

import torch

from ..render import _cuda
from . import microbench as mb
from .m3m6_turns import rows_of
from .turns import ORDER, build, rewrite, use

KERNEL = "microbench"
# the lines of csrc/microbench.cu a side build rewrites, as format strings
UNROLL = "constexpr int kFmaUnroll = {};"
MUFU_UNROLL = "constexpr int kMufuUnroll = {};"
BLOCK = "constexpr int kFmaBlock = {};"
CONST_M = "constexpr bool kFmaConstM = {};"
# the chains a thread at which FFMA reads m from the constant bank
SCOPES = {"x1": "kMode == kFma && kStreams == 1", "all": "kMode == kFma",
          "none": "false"}
SWEEP_UNROLL = (8, 16, 32, 64)
SWEEP_BLOCK = (128, 256, 512)
SWEEP_MUFU_UNROLL = (8, 32)
# the kernels whose main loop's SASS is read: (mode, chains a thread)
LOOP_KERNELS = tuple((mode, s) for mode in ("mul_add", "fma")
                     for s, _ in mb.FMA_CASES)
FP32_OPS = ("FFMA", "FMUL", "FADD")


def _find(fmt: str, text: str | None = None) -> str:
    """The value in the one line of the source (or of ``text``) that
    ``fmt`` formats."""
    pat = re.escape(fmt).replace(r"\{\}", "(.+)")
    found = re.findall(pat, text or _cuda.source(KERNEL).read_text())
    if len(found) != 1:
        raise ValueError(f"{KERNEL}: {fmt!r} matches {len(found)} lines")
    return found[0]


def change_spec(text: str | None = None) -> dict:
    """The source's (or ``text``'s) M1 schedule: the FP32 steps' unroll,
    the MUFU steps', the chains at which FFMA reads m from the constant bank
    (a key of ``SCOPES``) and the threads a block."""
    scope = _find(CONST_M, text)
    names = [k for k, v in SCOPES.items() if v == scope]
    if not names:
        raise ValueError(f"{KERNEL}: kFmaConstM = {scope!r} is none of "
                         f"{SCOPES}")
    return dict(unroll=int(_find(UNROLL, text)),
                mufu_unroll=int(_find(MUFU_UNROLL, text)), const_m=names[0],
                block=int(_find(BLOCK, text)))


def spec_name(spec: dict) -> str:
    return (f"unroll{spec['unroll']}_mufu{spec['mufu_unroll']}_m_"
            f"{spec['const_m']}_block{spec['block']}")


def side_specs() -> dict:
    """{name: spec} of the side builds, as ``change_spec``'s: each FP32
    unroll of ``SWEEP_UNROLL``; m from a register (``none``) and from the
    constant bank at every chain count (``all``) and at one chain (``x1``),
    at unroll 8 and at the change's; each block of ``SWEEP_BLOCK``; each
    MUFU unroll of ``SWEEP_MUFU_UNROLL``; none that equals the change, each
    once."""
    ch = change_spec()
    specs = [dict(ch, unroll=u) for u in SWEEP_UNROLL]
    specs += [dict(ch, unroll=u, const_m=c) for u in (8, ch["unroll"])
              for c in SCOPES]
    specs += [dict(ch, block=b) for b in SWEEP_BLOCK]
    specs += [dict(ch, mufu_unroll=u) for u in SWEEP_MUFU_UNROLL]
    out = {}
    for s in specs:
        if s != ch:
            out.setdefault(spec_name(s), s)
    return out


def side_edits(spec: dict) -> list:
    """[(a line of the source, its rewrite)] that turn the change's source
    into ``spec``'s."""
    ch = change_spec()
    out = []
    for key, fmt, val in (("unroll", UNROLL, str), ("block", BLOCK, str),
                          ("mufu_unroll", MUFU_UNROLL, str),
                          ("const_m", CONST_M, SCOPES.get)):
        if spec[key] != ch[key]:
            out.append((fmt.format(val(ch[key])), fmt.format(val(spec[key]))))
    return out


def side_sources() -> dict:
    """``side_specs`` written out (``turns.rewrite``): {name: {kernel:
    path}}."""
    return {name: {KERNEL: rewrite(KERNEL, name, side_edits(spec))}
            for name, spec in side_specs().items()}


# ---------------------------------------------------------------- SASS

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_]*)(\S*)\s*([^;]*);")


def sass_functions(text: str) -> dict:
    """{function: its lines} of a ``cuobjdump -sass`` listing."""
    out: dict = {}
    fn = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
        elif fn is not None:
            out[fn].append(line)
    return out


def loop_pass(lines) -> dict | None:
    """The main loop of a function's SASS lines (cuobjdump's, which give
    a branch's target as an address): of the loops that a backward branch
    closes, the one with the most FP32 instructions.  Its instructions,
    the FP32 ones (FFMA, FMUL, FADD), the others, the count of each opcode,
    each FP32 instruction's form (registers and ``.reuse`` flags) with its
    count, and the pass's share of the FP32 pipe at one and at two issue
    cycles an FP32 instruction (``fma_issue_share``); None where no loop
    holds an FP32 instruction."""
    instrs = [(int(m.group(1), 16), m.group(3), m.group(3) + m.group(4),
               m.group(5).strip())
              for m in map(_INSTR.search, lines) if m]
    best = None
    for addr, op, _, args in instrs:
        if op != "BRA" or not re.fullmatch(r"0x[0-9a-f]+", args) or (
                int(args, 16) > addr):
            continue
        body = [x for x in instrs if int(args, 16) <= x[0] <= addr]
        fp32 = [x for x in body if x[1] in FP32_OPS]
        if fp32 and (best is None or len(fp32) > len(best[1])):
            best = (body, fp32)
    if best is None:
        return None
    body, fp32 = best
    n, f = len(body), len(fp32)
    forms = collections.Counter(f"{full} {args}" for _, _, full, args in fp32)
    return dict(instructions=n, fp32=f, other=n - f,
                opcodes=dict(collections.Counter(x[2] for x in body)),
                fp32_forms=dict(forms),
                reuse=sum(a.count(".reuse") for *_, a in fp32),
                share_one_cycle=mb.fma_issue_share(f, n - f, 1),
                share_two_cycles=mb.fma_issue_share(f, n - f, 2))


def loop_sass(so) -> dict:
    """``loop_pass`` of each kernel of ``LOOP_KERNELS`` in the library at
    ``so``, by its label."""
    _, text = mb.sass_counts(str(so))
    fns = sass_functions(text)
    out = {}
    for mode, streams in LOOP_KERNELS:
        code = mb.FMA_MODES.index(mode)
        hits = [f for f in fns if re.search(
            rf"fma_probeILi{code}ELi{streams}E", f)]
        if len(hits) != 1:
            raise RuntimeError(f"{so}: {len(hits)} kernels of M1 {mode} "
                               f"x{streams}")
        out[mb.fma_label(mode, streams)] = dict(function=hits[0],
                                                **(loop_pass(fns[hits[0]])
                                                   or {}))
    return out


# ---------------------------------------------------------------- turns

def side_turns(libs: dict, dev, clocks, refs, log=print) -> list:
    """``_run_m1`` on the change and each side build in turns (change,
    sides, the sides reversed, change, twice): [{build, entries}]."""
    sides = [n for n in libs if n not in ("parent", "change")]
    order = ("change", *sides, *reversed(sides), "change") * 2
    turns = []
    for i, name in enumerate(order):
        use(libs, name)
        log(f"[m1] side turn {i + 1} of {len(order)}: {name}")
        turns.append(dict(build=name, entries=mb._run_m1(dev, clocks, log,
                                                         refs)))
    use(libs, "change")
    return turns


def fma_x1(rows: list) -> dict:
    """{build: median ms} of the one-chain FFMA row, fastest first."""
    row = next(r for r in rows if r["label"] == mb.fma_label("fma", 1))
    med = {n: row["median_device_ms"].get(n, m)
           for n, m in row["median_ms"].items()}
    return dict(sorted(med.items(), key=lambda kv: kv[1]))


def run(libs: dict, log=print) -> dict:
    """The plain versions once, then ``_run_m1`` on the parent's and the
    change's builds in turns and on the change and the side builds in
    turns; each build's loop SASS; the record of the call."""
    dev = torch.device("cuda")
    card = mb._smi("name,power.limit")
    log(f"[m1] {card}")
    refs = mb.fma_refs(dev)
    turns = []
    with mb.ClockSampler() as clocks:
        for name in ORDER:
            use(libs, name)
            log(f"[m1] turn {len(turns) + 1} of {len(ORDER)}: {name}")
            turns.append(dict(build=name, entries=mb._run_m1(dev, clocks, log,
                                                             refs)))
        side = side_turns(libs, dev, clocks, refs, log)
        samples = [m for _, m, _ in clocks.samples]
    use(libs, "change")
    rows = rows_of(turns, log, tag="m1")
    side_rows = rows_of(side, log, tag="m1 side")
    sass = {n: loop_sass(b[KERNEL][1]) for n, b in libs.items()}
    for n, by in sass.items():
        for label, s in by.items():
            log(f"[m1] sass {n} {label}: {s.get('instructions')} "
                f"instructions a pass, {s.get('fp32')} FP32, "
                f"{s.get('reuse')} .reuse; {s.get('fp32_forms')}")
    pick = fma_x1(side_rows)
    log(f"[m1] fma x1 by build: {pick}")
    specs = {"change": change_spec(), **side_specs()}
    return dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                script="raytracers_tpu_torch/probes/m1_turns.py",
                order=ORDER, specs=specs,
                clocks_sm_mhz=dict(min=min(samples, default=None),
                                   max=max(samples, default=None),
                                   samples=len(samples)),
                rows=rows, side_rows=side_rows, fma_x1_by_build=pick,
                sass=sass, turns=turns, side_turns=side)


def rerecord(path: Path, rec: dict, so: Path, log=print) -> None:
    """Replace the M1 entries of the probe record at ``path`` by the
    change's last turn in ``rec`` (``run``'s) and its SASS counts by the
    change's build at ``so``, in place; the record's weights stay, this
    run's go beside them."""
    out = json.loads(path.read_text())
    new = [t for t in rec["turns"] if t["build"] == "change"][-1]["entries"]
    at = next(i for i, e in enumerate(out["entries"]) if e["probe"] == "M1")
    rest = [e for e in out["entries"] if e["probe"] != "M1"]
    out["entries"] = rest[:at] + new + rest[at:]
    out["sass"] = mb.sass_counts(str(so))[0]
    out["m1_run"] = dict({k: rec[k] for k in ("card", "torch", "cuda",
                                               "script")},
                         mul_equivalents=mb.mul_equivalents(new),
                         fchk_lanes_per_cycle=mb.fchk_lanes_per_cycle(new))
    path.write_text(json.dumps(out, indent=1) + "\n")
    log(f"[m1] wrote M1 into {path}; this run's weights "
        f"{out['m1_run']['mul_equivalents']}, the record's "
        f"{out['mul_equivalents']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracers_tpu_torch.probes.m1_turns",
        description="M1 of two builds of its source and side builds, in "
                    "turns")
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout whose csrc/ holds the parent source")
    ap.add_argument("--out", default=None, help="where the JSON goes")
    ap.add_argument("--record", type=Path, default=None,
                    help="an M1-M4 probe record whose M1 entries to replace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("m1_turns measures on the card; no CUDA device")
    libs = build(args.parent, KERNEL, sides=side_sources())
    rec = run(libs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
        print(f"[m1] wrote {args.out}")
    if args.record is not None:
        rerecord(args.record, rec, libs["change"][KERNEL][1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
