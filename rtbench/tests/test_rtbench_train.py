"""The ``rgbbox.train`` cell at a size a test run holds (CPU, the plain
versions of the program's kernels, a gloo process group of one rank over a
``HashStore``):

* a whole run of the port's train step comes out correct against
  ``reference_train.py``, and the control (the reference in bfloat16 in
  the program's place) does not;
* the reference's Adam equals a first and a second step worked by hand;
* the driver can be built twice in one process, as the counted unit of a
  traced run builds it (``spans._count_unit``);
* a run with the timed path broken underneath comes out not correct, for
  each fault of ``train_faults.FAULTS``; the paths cut at 8 also at full
  size on the card;
* the fit rolls through every step, and the scales of the comparison do
  not shrink with it.

The card's own readings at the cell's size are PERF.md's."""
import json
import math
from pathlib import Path

import pytest
import torch

from rtbench import calibrate, check, reference_train, run
from rtbench.drivers import train
from rtbench.train_faults import FAULTS, depth8

torch.set_num_threads(4)
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[2]
CELL = "rgbbox.train"
SMALL = dict(width=64, height=64, max_depth=8)
# paths cut at 8 need a deeper configuration to cut
DEEP = dict(width=48, height=48, max_depth=50)
SEED = 2 ** 31 + 7


def _limits():
    return json.loads((ROOT / "rtbench" / "limits" / f"{CELL}.json")
                      .read_text())


def test_sound_run_is_correct():
    out = run.run(CELL, SEED, 0.2, False, device=CPU, config_override=SMALL)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and set(out["metrics"]) >= {"setup_s"}
    assert set(out["checks"]) == set(_limits())


def test_control_fails():
    r = calibrate.readings(CELL, SEED, CPU, SMALL)
    assert "float64" not in r        # the step cell's look keys elsewhere
    assert check.verdict(r["program"], _limits())[0], r["program"]
    ok, table = check.verdict(r["control"], _limits())
    assert not ok, table


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_run_is_not_correct(fault):
    out = run.run(CELL, SEED, 0.2, False, device=CPU,
                  config_override=DEEP if fault == "depth8" else SMALL,
                  wrap=FAULTS[fault])
    assert out["correct"] is False, out["checks"]


def test_adam_by_hand():
    """Two steps of optax's Adam on one value, worked on paper: the first
    moves it by lr whatever the gradient's size, the second by
    lr m̂ / (√v̂ + eps) with both moments bias-corrected."""
    lr, b1, b2, eps = 0.1, 0.9, 0.999, 1e-8
    p, m, v = (torch.tensor([1.0], dtype=torch.float64),
               torch.zeros(1, dtype=torch.float64),
               torch.zeros(1, dtype=torch.float64))
    p, m, v = reference_train.adam(p, torch.tensor([4.0], dtype=p.dtype),
                                   m, v, 0, lr, b1, b2, eps)
    assert float(m) == pytest.approx(0.4) and float(v) == pytest.approx(
        0.016)
    p1 = 1.0 - lr * 4.0 / (4.0 + eps)
    assert float(p) == pytest.approx(p1, abs=1e-15)
    p, m, v = reference_train.adam(p, torch.tensor([-2.0], dtype=p.dtype),
                                   m, v, 1, lr, b1, b2, eps)
    m2, v2 = 0.9 * 0.4 + 0.1 * -2.0, 0.999 * 0.016 + 0.001 * 4.0
    assert float(m) == pytest.approx(m2) and float(v) == pytest.approx(v2)
    step2 = lr * (m2 / (1 - 0.81)) / (math.sqrt(v2 / (1 - 0.999 ** 2))
                                      + eps)
    assert float(p) == pytest.approx(p1 - step2, abs=1e-15)


def test_driver_twice_in_one_process():
    """A second driver, built while the first holds the process group,
    leaves the group to it; each runs a step; the group goes with the
    driver that made it."""
    import torch.distributed as dist
    spec = run.load_cell(CELL, False)
    config = dict(spec["config"], **SMALL)
    first = train.Driver(config, spec["mix"], SEED, CPU)
    second = train.Driver(config, spec["mix"], SEED, CPU)
    try:
        assert first.owns_group and not second.owns_group
        for d in (first, second):
            d.run(0)
            d.wait()
        assert torch.equal(first.latest[0], second.latest[0])
        second.release()
        assert dist.is_initialized()
    finally:
        first.release()
    assert not dist.is_initialized()
    third = train.Driver(config, spec["mix"], SEED, CPU)
    assert third.owns_group
    third.release()


def test_one_fit_rolls_through_the_steps():
    """The state before each step is the state after the step before it,
    Adam's count rises by one a step, and the kept copies are the fit's
    start, the first ``check_within`` steps after the warm-up and the
    latest."""
    spec = run.load_cell(CELL, False)
    mix = dict(spec["mix"], check_within=2, warmup_units=1)
    d = train.Driver(dict(spec["config"], **SMALL), mix, SEED, CPU)
    try:
        outs = [d.run(i) for i in range(6)]
    finally:
        d.release()
    assert sorted(d.before) == [0, 1, 2, 5]
    assert all(outs[i + 1][0] is outs[i][2] for i in range(5))
    assert [o[2][1] for o in outs] == [1, 2, 3, 4, 5, 6]
    assert d.inputs(5).count == 5 and d.inputs(0).count == 0


def test_scales_do_not_shrink_with_the_fit():
    """``compare``'s scales are the target's energy and the float32
    reference's first moment after the fit's first step, computed once,
    whatever step or precision is compared."""
    spec = run.load_cell(CELL, False)
    d = train.Driver(dict(spec["config"], **SMALL), spec["mix"], SEED, CPU)
    try:
        for i in range(3):
            d.run(i)
    finally:
        d.release()
    _, late = d.reference(2, dtype=torch.bfloat16)
    new, _, _ = reference_train.step(
        d.inputs(0), d.masks, d.mix, d.cam, d.goal, d.W, d.H, d.D)
    assert late["first_moment"] == float(new.m[2].double().norm()) > 0
    assert d.reference(1)[1]["first_moment"] == late["first_moment"]
    assert late["target_energy"] == float((d.goal.double() ** 2).sum())


@pytest.mark.cuda
def test_paths_cut_at_8_fail_at_full_size():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = run.run(CELL, 2 ** 32 + 13, 1.0, False, wrap=depth8)
    assert out["correct"] is False, out["checks"]
