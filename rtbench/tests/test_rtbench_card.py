"""On the card, at the cells' own sizes: a short run of each cell comes out
correct, and the control (the reference in bfloat16 in the program's
place) and the program with its paths cut at 8 segments fail the cell's
limits.  Skips without a card.

    python -m pytest rtbench/tests/test_rtbench_card.py -q -p no:cacheprovider
"""
import json
from pathlib import Path

import pytest
import torch

from rtbench import calibrate, check, run

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    out = run.run(cell, 2 ** 32 + 11, 1.0, False)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_full_size(card, cell):
    r = calibrate.readings(cell, 2 ** 32 + 12, card)
    limits = json.loads((ROOT / "rtbench" / "limits" / f"{cell}.json")
                        .read_text())
    assert check.verdict(r["program"], limits)[0]
    assert not check.verdict(r["control"], limits)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_paths_cut_at_8_fail_at_full_size(card, cell):
    r = calibrate.readings(cell, 2 ** 32 + 13, card, fault="depth8")
    limits = json.loads((ROOT / "rtbench" / "limits" / f"{cell}.json")
                        .read_text())
    assert not check.verdict(r["program"], limits)[0], r["program"]
