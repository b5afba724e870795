"""M7, the tensor-core quadratic probe, of two builds of its source, in
turns on one card.

It builds ``csrc/microbench_mxuquad.cu`` as it stands (``change``) and the
one of another checkout under ``--parent DIR`` (``parent``, e.g. the
parent commit unpacked with ``git archive``), one nvcc each, started
together (``turns.build``).  M1's weights, which the bounds charge for
a root and 1/a, are measured once.  Then ``microbench_mxuquad.run_m7``
runs on each build in turns (parent, change, change, parent, twice): the
TPU probe's five variants on both inputs at 8,192 and 1,048,576 rays,
timed and held as phase 10 of ``chip_smoke.py`` holds them (``vpu``
bit-equal, ``mxuquad``'s product within ``product_tolerance`` and its visit
bit-equal given it), with ``torch.matmul`` of the bf16 operands beside
them.  In the same call, on the change's build: rows128 ``mxuquad1`` at
1,048,576 rays with 256 and 128 visits in turns (the product is issued
every visit, so the ratio is about 0.5), and every ``mxuquad`` variant at
both sizes with each partition (1, 2 and 4 warpgroups a tile).  It prints
a line a variant with the medians and writes a JSON record:

    python -m raytracers_tpu_torch.probes.m7_turns --parent build/parent \\
        --out docs/M7_TURNS_H100.json --record docs/MICROBENCH_MXUQUAD_H100.json

``--record FILE`` replaces the M7 entries of that probe record (and the
weights they were bounded with) by the change's last turn, and its SASS
counts by the change's build.  It needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

from . import microbench as mb
from . import microbench_mxuquad as mq
from .turns import ORDER, build, medians, use

KERNEL = "microbench_mxuquad"
PARTS = (1, 2, 4)


def _inputs(dev, rows, splits, which="tpu"):
    return tuple(torch.from_numpy(x).to(dev)
                 for x in mq.mxuquad_inputs(which, rows, splits))


def _ms(fn):
    return mb._timed(fn, min_window_ms=50.0)[0]


def iters_ratio(dev, log=print) -> dict:
    """rows128 ``mxuquad1`` at 1,048,576 rays, tpu inputs, with 256 and 128
    visits in turns (256, 128, 128, 256); the medians and their ratio."""
    salt = torch.tensor([mb.SALT], device=dev)
    ins = _inputs(dev, 128, 1)
    ms = {256: [], 128: []}
    for iters in (256, 128, 128, 256):
        ms[iters].append(_ms(lambda: mq.visit_mxuquad(
            salt, *ins, 1 << 20, 128, "mxuquad", 1, iters)))
    med = {k: statistics.median(v) for k, v in ms.items()}
    out = dict(ms=ms, median_ms=med, ratio_128_to_256=med[128] / med[256])
    log(f"[m7] rows128_mxuquad1 1048576: 256 visits {med[256]:.4f} ms, 128 "
        f"visits {med[128]:.4f} ms, ratio {out['ratio_128_to_256']:.4f}")
    return out


def partitions(dev, log=print) -> list:
    """Every ``mxuquad`` variant at both sizes, tpu inputs, with each
    partition; ``rule`` is the one the kernel takes."""
    salt = torch.tensor([mb.SALT], device=dev)
    rows_out = []
    for rows, mode, splits in mq.VARIANTS:
        if mode != "mxuquad":
            continue
        ins = _inputs(dev, rows, splits)
        for n in mq.RAYS:
            ms = {p: _ms(lambda: mq.visit_mxuquad(
                salt, *ins, n, rows, mode, splits, mq.ITERS, _parts=p))
                for p in PARTS}
            rows_out.append(dict(variant=mq.tag(rows, mode, splits), rays=n,
                                 rule=mq.mxuquad_parts(n), ms=ms))
            log(f"[m7] {mq.tag(rows, mode, splits)} {n}: " + ", ".join(
                f"{p} parts {t:.4f} ms" for p, t in ms.items())
                + f" (rule {mq.mxuquad_parts(n)})")
    return rows_out


def run(libs: dict, log=print) -> dict:
    """``run_m7`` on each build in ``libs`` (``turns.build``'s) in turns,
    then ``iters_ratio`` and ``partitions`` on the change's; the record of
    the call: every turn's entries and a row a variant, input and size."""
    dev = torch.device("cuda")
    card = mb._smi("name,power.limit")
    log(f"[m7] {card}")
    weights = mb.measure_mul_equivalents(dev)
    turns = []
    for name in ORDER:
        use(libs, name)
        log(f"[m7] turn {len(turns) + 1} of {len(ORDER)}: {name}")
        turns.append(dict(build=name, entries=mq.run_m7(dev, weights, log)))
    use(libs, "change")
    rows = []
    for j, first in enumerate(turns[0]["entries"]):
        row = {k: first[k] for k in ("name", "rows", "mode", "splits", "rays",
                                     "input", "bound_ms", "bound_by")}
        row.update(ms={}, library_ms=[], err_share_of_bound={})
        for t in turns:
            e, n = t["entries"][j], t["build"]
            row["ms"].setdefault(n, []).append(e["ms"])
            row["library_ms"].append(e["library_ms"])
            if "err_share_of_bound" in e:
                row["err_share_of_bound"][n] = max(
                    row["err_share_of_bound"].get(n, 0.0),
                    e["err_share_of_bound"])
        row["median_ms"] = medians(row["ms"])
        row["share"] = {n: row["bound_ms"] / m
                        for n, m in row["median_ms"].items()}
        row["parent_over_change"] = (row["median_ms"]["parent"]
                                     / row["median_ms"]["change"])
        lib = [x for x in row["library_ms"] if x is not None]
        row["library_median_ms"] = statistics.median(lib) if lib else None
        log(f"[m7] {first['name']}: " + "; ".join(
            f"{n} {m:.4f} ms ({row['share'][n]:.3f} of "
            f"{row['bound_ms']:.4f})" for n, m in row["median_ms"].items())
            + f"; parent / change {row['parent_over_change']:.3f}")
        rows.append(row)
    ratio = iters_ratio(dev, log)
    parts = partitions(dev, log)
    sass = {n: {f: c for f, c in mb.sass_counts(str(b[KERNEL][1]))[0].items()
                if "visit_" in f} for n, b in libs.items()}
    return dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                script="raytracers_tpu_torch/probes/m7_turns.py",
                mul_equivalents=weights, order=ORDER, rows=rows,
                iters_ratio=ratio, partitions=parts, sass=sass, turns=turns)


def rerecord(path: Path, rec: dict, so: Path, log=print) -> None:
    """Replace the M7 entries of the probe record at ``path`` by the
    change's last turn in ``rec`` (``run``'s) and the weights they were
    bounded with, and the record's SASS counts by those of the change's
    build at ``so``."""
    probe = json.loads(path.read_text())
    probe["entries"] = [e for e in probe["entries"] if e["probe"] != "M7"] + [
        t for t in rec["turns"] if t["build"] == "change"][-1]["entries"]
    probe["mul_equivalents"] = rec["mul_equivalents"]
    probe["sass"] = mb.sass_counts(str(so))[0]
    probe["m7_run"] = {k: rec[k] for k in ("card", "torch", "cuda", "script")}
    path.write_text(json.dumps(probe, indent=1) + "\n")
    log(f"[m7] wrote M7 into {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracers_tpu_torch.probes.m7_turns",
        description="M7 of two builds of csrc/microbench_mxuquad.cu, in turns")
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout whose csrc/microbench_mxuquad.cu is the "
                         "parent")
    ap.add_argument("--out", default=None, help="where the JSON goes")
    ap.add_argument("--record", type=Path, default=None,
                    help="a probe record whose M7 entries to replace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("m7_turns measures on the card; no CUDA device")
    libs = build(args.parent, KERNEL)
    rec = run(libs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
        print(f"[m7] wrote {args.out}")
    if args.record is not None:
        rerecord(args.record, rec, libs["change"][KERNEL][1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
