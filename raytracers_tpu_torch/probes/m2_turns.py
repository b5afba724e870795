"""M2, the dot probe, of two builds of its source, in turns on one card.

It builds ``csrc/microbench.cu`` as it stands (``change``) and the
``csrc/microbench.cu`` of another checkout under ``--parent DIR``
(``parent``, e.g. the parent commit unpacked with ``git archive``), one
nvcc each, started together (``turns.build``).  Then it runs
``microbench.run_m2`` on each build in turns (parent, change, change,
parent, twice): every M2 kind and route timed as phase 10 of
``chip_smoke.py`` times it, with ``torch.bmm`` at the route's precision
beside it in every turn.  The change's outputs are held as phase 10 holds
them (the FP32 loop bit-equal to ``dot_plain``, the TF32 routes within
``dot_tolerance``); the parent's errors are only recorded, since its TF32
routes sum in another order.  It prints ``run_m2``'s lines and a line a
kind and route with the medians, and writes a JSON record:

    python -m raytracers_tpu_torch.probes.m2_turns --parent build/parent \\
        --out docs/M2_TURNS_H100.json --record docs/MICROBENCH_H100.json

``--record FILE`` replaces the M2 entries of that probe record with the
change's last turn, and its SASS counts with the change's build; M1, M3,
M4 and M1's weights stay as they are.  It needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

from . import microbench as mb
from .turns import ORDER, build, medians, use

def run(libs: dict, log=print) -> dict:
    """``run_m2`` on each build in ``libs`` (``turns.build``'s) in turns;
    the record of the run: every turn's entries and a row a kind and
    route."""
    dev = torch.device("cuda")
    card = mb._smi("name,power.limit")
    log(f"[m2] {card}")
    turns = []
    for name in ORDER:
        use(libs, name)
        log(f"[m2] turn {len(turns) + 1} of {len(ORDER)}: {name}")
        turns.append(dict(build=name, entries=mb.run_m2(
            dev, log, hold=name == "change")))
    use(libs, "change")
    rows = []
    for j, first in enumerate(turns[0]["entries"]):
        row = {k: first[k] for k in ("kind", "route", "bound_ms", "bound_by",
                                     "library_precision")}
        row.update(ms={}, ms_seeded={}, library_ms=[], max_abs_err={},
                   err_share_of_product_term={})
        for t in turns:
            e, n = t["entries"][j], t["build"]
            row["ms"].setdefault(n, []).append(e["ms"])
            row["ms_seeded"].setdefault(n, []).append(e["ms_seeded"])
            row["library_ms"].append(e["library_ms"])
            row["max_abs_err"][n] = max(row["max_abs_err"].get(n, 0.0),
                                        e["max_abs_err"])
            row["err_share_of_product_term"][n] = e[
                "err_share_of_product_term"]
        row["median_ms"] = medians(row["ms"])
        row["share"] = {n: row["bound_ms"] / m
                        for n, m in row["median_ms"].items()}
        log(f"[m2] {first['label']}: " + "; ".join(
            f"{n} {m:.4f} ms ({row['share'][n]:.3f} of "
            f"{row['bound_ms']:.4f})" for n, m in row["median_ms"].items())
            + f"; bmm ({row['library_precision']}) "
            f"{statistics.median(row['library_ms']):.4f} ms")
        rows.append(row)
    sass = {n: {f: c for f, c in mb.sass_counts(str(b["microbench"][1]))[0]
                .items() if "dot_" in f} for n, b in libs.items()}
    return dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                script="raytracers_tpu_torch/probes/m2_turns.py",
                order=ORDER, rows=rows, sass=sass, turns=turns)


def rerecord(path: Path, rec: dict, so: Path, log=print) -> None:
    """Replace the M2 entries of the probe record at ``path`` with the
    change's last turn in ``rec`` (``run``'s), and the record's SASS counts
    with those of the change's build at ``so``."""
    probe = json.loads(path.read_text())
    m2 = [t for t in rec["turns"] if t["build"] == "change"][-1]["entries"]
    entries = [e for e in probe["entries"] if e["probe"] != "M2"]
    at = next(i for i, e in enumerate(entries) if e["probe"] == "M3")
    probe["entries"] = entries[:at] + m2 + entries[at:]
    probe["sass"] = mb.sass_counts(str(so))[0]
    probe["m2_run"] = {k: rec[k] for k in ("card", "torch", "cuda", "script")}
    path.write_text(json.dumps(probe, indent=1) + "\n")
    log(f"[m2] wrote M2 into {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracers_tpu_torch.probes.m2_turns",
        description="M2 of two builds of csrc/microbench.cu, in turns")
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout whose csrc/microbench.cu is the parent")
    ap.add_argument("--out", default=None, help="where the JSON goes")
    ap.add_argument("--record", type=Path, default=None,
                    help="a probe record whose M2 entries to replace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("m2_turns measures on the card; no CUDA device")
    libs = build(args.parent, "microbench")
    rec = run(libs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
        print(f"[m2] wrote {args.out}")
    if args.record is not None:
        rerecord(args.record, rec, libs["change"]["microbench"][1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
