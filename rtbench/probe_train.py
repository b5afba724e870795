"""The ``train`` cell's numbers along one rolling fit: the readings its
limits are set from, at the steps a run can check, from the window's
first units to its last.

    python3 -m rtbench.probe_train --seeds 1 2 3 --steps 5 54 1000 6000
    python3 -m rtbench.probe_train --seeds 1 --steps 5 54 2000 \\
        --fault frozen

For each seed it runs the cell's fit as a run does, step after step, and
at each of ``--steps`` compares that step with the float32 reference from
the same state, and the control (the reference in bfloat16 in the
program's place) with it.  With ``--fault`` the program runs with one of
``train_faults.FAULTS`` planted from the first step, and only its numbers
are read.  One JSON line a step, then the largest program reading and
the smallest control reading of each number, and each reading's verdict
under the cell's limits.  The benchmark's own runs never run this module.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

WORKLOAD = "rgbbox.train"


def along(seed: int, steps, device, fault: str | None = None,
          control: bool = True, config_override=None):
    """Yield the readings at each of ``steps`` of one fit."""
    from . import calibrate, run
    from .train_faults import FAULTS
    spec = run.load_cell(WORKLOAD, False)
    config = dict(spec["config"], **(config_override or {}))
    driver = run.setup(config, spec["mix"], seed, device)
    if fault is not None:
        driver.run = FAULTS[fault](driver.run)
    want = set(steps)
    try:
        for i in range(max(want) + 1):
            out = driver.run(i)
            driver.wait()
            if i not in want:
                continue
            ref, info = driver.reference(i)
            row = dict(seed=seed, step=i,
                       program=driver.compare(out, ref, info))
            if fault is not None:
                row["fault"] = fault
            elif control:
                ctl, _ = driver.reference(i, dtype=calibrate.CONTROL_DTYPE)
                row["control"] = driver.compare(ctl, ref, info)
            yield row
    finally:
        driver.release()


def main(argv=None) -> int:
    from . import check, run
    from .train_faults import FAULTS
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--no-control", action="store_true")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_train: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    limits = run.load_cell(WORKLOAD, False)["limits"]
    rows = []
    for seed in a.seeds:
        for r in along(seed, a.steps, device, a.fault, not a.no_control):
            r["correct"] = check.verdict(r["program"], limits)[0]
            if "control" in r:
                r["control_correct"] = check.verdict(r["control"],
                                                     limits)[0]
            rows.append(r)
            print(json.dumps(r), flush=True)
    summary = dict(seeds=a.seeds, steps=a.steps, fault=a.fault,
                   correct=[r["correct"] for r in rows],
                   program_max={k: max(r["program"][k] for r in rows)
                                for k in rows[0]["program"]})
    if "control" in rows[0]:
        summary["control_correct"] = [r["control_correct"] for r in rows]
        summary["control_min"] = {k: min(r["control"][k] for r in rows)
                                  for k in rows[0]["control"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
