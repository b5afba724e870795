"""The comparison that decides ``correct`` has to fail where it should, at a
size a test run holds (CPU, the plain versions of the program's kernels):

* the control, the reference computed in bfloat16 (the precision below the
  configurations' float32) in the program's place, fails each cell's
  limits;
* a whole run with the timed path broken underneath comes out not
  correct, for each fault a cell can have (``calibrate.FAULTS``): half the
  frame or half the step's pixels left out (the step's loss the mean over
  the rest), an answer altered where it is produced, a step that leaves
  the leaves' gradients unset, the paths cut at 8 segments;
* the same run unbroken comes out correct.

The card's own readings at the cells' sizes are PERF.md's."""
import json
from pathlib import Path

import pytest
import torch

from rtbench import calibrate, check, run

torch.set_num_threads(4)
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SIDE = {"render": 48, "grad": 64}
SEED = 2 ** 31 + 7


def _small(cell):
    side = SIDE[cell.split(".")[1]]
    return dict(width=side, height=side)


def _limits(cell):
    return json.loads((ROOT / "rtbench" / "limits" / f"{cell}.json")
                      .read_text())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    r = calibrate.readings(cell, SEED, CPU, _small(cell))
    ok, table = check.verdict(r["control"], _limits(cell))
    assert not ok, table


def _cases():
    for cell in CELLS:
        for name in calibrate.FAULTS:
            if name == "unset" and cell.endswith(".render"):
                continue        # a frame has no state to leave unchanged
            yield cell, name


@pytest.mark.parametrize("cell, fault", list(_cases()))
def test_broken_run_is_not_correct(cell, fault):
    out = run.run(cell, SEED, 0.2, False, device=CPU,
                  config_override=_small(cell),
                  wrap=calibrate.FAULTS[fault])
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run.run(cell, SEED, 0.2, False, device=CPU,
                  config_override=_small(cell))
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and set(out["metrics"]) >= {"setup_s"}
