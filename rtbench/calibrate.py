"""The readings that a cell's limits are set from: the program's and the
control's numbers on many seeds, in one process.

    python3 -m rtbench.calibrate --workload <cell> --seeds 1 2 3 ...
    python3 -m rtbench.calibrate --workload <cell> --seeds 1 2 3 \\
        --fault depth8

For each seed it draws the cell's inputs, runs the program's units as a
run does (the warm-up, then one more unit, whose outputs are compared),
computes the float32 reference once and compares with it the program's
outputs and the control's: the reference itself computed in bfloat16, the
precision below the configuration's float32, put in the program's place.
In a step cell it also reads how far float32 alone moves the reference's
gradients, and which segments and pixels carry that (``look_float64``).
One JSON line a seed, then the largest program reading and the smallest
control reading of each number, and each seed's verdict under the cell's
limits.

With ``--fault`` the program runs with one of ``FAULTS`` planted under its
timed path, and only its numbers are read: the limits have to find each
fault.  The benchmark's own runs never run this module.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

CONTROL_DTYPE = torch.bfloat16
# the look drops the segments (or pixels) whose own sphere test, or whose
# path's least, stands this close to the cancellation of its
# discriminant (disc / b²), or whose path ran more than this many segments
TAUS = (1e-6, 1e-4, 1e-2)
LENGTHS = (2, 4, 8)


# -- faults planted under the timed path: each wraps the driver's ``run``

def _half_left_out(fn):
    """The frame's lower half never rendered; the step's loss over the
    upper half, times two."""
    driver = fn.__self__
    if not hasattr(driver, "target"):
        def frame(i):
            img = fn(i).clone()
            img[img.shape[0] // 2:] = 0
            return img
        return frame

    def step(i):
        from raytracers_tpu_torch.geometry import Camera, Spheres
        sph = Spheres(*(t.detach().requires_grad_(True)
                        for t in driver.variants[i % len(driver.variants)]))
        cam = Camera(*(t.detach().requires_grad_(True) for t in driver.cam))
        img = driver.f(sph, cam)
        h = img.shape[0] // 2
        (2.0 * ((img[:h] - driver.target[:h]) ** 2).sum()).backward()
        return img.detach(), [t.grad for t in (*sph, *cam)]
    return step


def _altered(fn):
    """Each answer's red and blue swapped where it is produced: the packed
    frame's channels, the step's colour image and colour gradient."""
    def unit(i):
        out = fn(i)
        if isinstance(out, torch.Tensor):
            return ((out & 0xFF) << 16) | (out & 0xFF00) | ((out >> 16)
                                                            & 0xFF)
        img, grads = out
        grads = list(grads)
        grads[2] = grads[2].flip(-1)
        return img.flip(-1), grads
    return unit


def _unset(fn):
    """The step runs but hands back no gradient: zeros in every leaf."""
    def unit(i):
        img, grads = fn(i)
        return img, [torch.zeros_like(g) for g in grads]
    return unit


def _depth8(fn):
    """The program's paths cut at 8 segments, the reference's at the
    configuration's depth: every phase of the schedule after the eighth
    bounce left out, as a later phase or the tail dropped would."""
    driver = fn.__self__
    if not hasattr(driver, "target"):
        from raytracers_tpu_torch.render.api import render

        def frame(i):
            return render(driver.prepared[i % len(driver.prepared)],
                          driver.H, driver.W, mode="pallas", max_depth=8)
        return frame
    from raytracers_tpu_torch.grad.pallas_diff import make_render_pallas_diff
    engine, total = dict(driver.engine, schedule=(), sort_prefix=()), 0
    for depth, prefix in zip(driver.engine["schedule"],
                             driver.engine["sort_prefix"]):
        if total + depth >= 8:
            break       # the engine's phases have to end before its depth
        total += depth
        engine["schedule"] += (depth,)
        engine["sort_prefix"] += (prefix,)
    driver.f = make_render_pallas_diff(driver.W, driver.H, max_depth=8,
                                       **engine)
    return fn


FAULTS = {"half": _half_left_out, "altered": _altered, "unset": _unset,
          "depth8": _depth8}


# -- the look: where float32 moves the reference's gradients

def _gap(a, b, keep, rows, n_rows):
    """The float32 gap of a leaf built from the kept segments (or pixels)
    ``a`` and ``b``: the sums by ``rows`` (None: one row of 3 columns
    per leaf of the camera), the worst leaf's norm of the difference over
    the float64 sum's."""
    a, b = a[keep], b[keep]
    if rows is None:
        sa, sb = a.sum(0).reshape(-1, 3), b.sum(0).reshape(-1, 3)
        return max(float((x - y).norm() / y.norm().clamp_min(1e-300))
                   for x, y in zip(sa, sb))
    sa = torch.zeros(n_rows, a.shape[1], dtype=a.dtype, device=a.device)
    sb = torch.zeros_like(sa)
    sa.index_add_(0, rows[keep], a)
    sb.index_add_(0, rows[keep], b)
    return float((sa - sb).norm() / sb.norm().clamp_min(1e-300))


def _carriers(a, b, cond, path_cond, length, rows=None, n_rows=0) -> dict:
    """Which of the segments (or pixels) ``a`` / ``b`` (float32 / float64
    replay) carry the gap: the share of sum(gap²) that the 10 largest
    hold, the largest own and path conditioning and the least path length
    among those 10, and the gap with those under each ``TAUS`` (own,
    path) or over each ``LENGTHS`` dropped from both sides."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    g2 = (a - b).norm(dim=1) ** 2
    top = torch.topk(g2, min(10, g2.numel())).indices
    out = dict(top10_share=float(g2[top].sum() / g2.sum().clamp_min(1e-300)),
               top10_cond_max=float(cond[top].max()),
               top10_path_cond_max=float(path_cond[top].max()),
               top10_length_min=int(length[top].min()),
               all=_gap(a, b, torch.ones_like(cond, dtype=torch.bool), rows,
                        n_rows))
    for tau in TAUS:
        out[f"cond>={tau:g}"] = _gap(a, b, cond >= tau, rows, n_rows)
        out[f"path_cond>={tau:g}"] = _gap(a, b, path_cond >= tau, rows,
                                          n_rows)
    for n in LENGTHS:
        keep = length <= n
        out[f"length<={n}"] = _gap(a, b, keep, rows, n_rows)
        out[f"length<={n}_share"] = float(keep.double().mean())
    return out


def _attribution(p32: dict, p64: dict, bounces, n_spheres: int) -> dict:
    """Where the float32 gap of each leaf lies (``_carriers``): the
    centre's and the radius's by segment, the camera's by pixel."""
    seg, pix = p64["segment"], p64["pixel"]
    path_cond = pix["conditioning"]
    length = bounces.reshape(-1).to(path_cond.device)
    out = {leaf: _carriers(p32["segment"][leaf], seg[leaf],
                           seg["conditioning"], path_cond[seg["pixel"]],
                           length[seg["pixel"]], seg["sphere"], n_spheres)
           for leaf in ("centre", "radius")}
    out["camera"] = _carriers(p32["pixel"]["grad"], pix["grad"], path_cond,
                              path_cond, length)
    return out


def look_float64(driver, i: int) -> dict:
    """The reference's own float32 gradients against a float64 replay of
    the same paths with the same cotangent: how far float32 alone moves
    each leaf's gradient (``check.gradients``' numbers), and which
    segments and pixels carry it (``attribution``)."""
    from . import check, reference
    spheres, cam = driver.inputs(i)
    img, info = reference.trace(spheres, cam, driver.W, driver.H, driver.D,
                                record=True)
    cot = 2.0 * (img - driver.target)
    path = info["path"]
    p32, p64 = {}, {}
    g32 = reference.replay(spheres, cam, driver.W, driver.H, path, cot,
                           probe=p32)
    g64 = reference.replay(spheres, cam, driver.W, driver.H, path, cot,
                           dtype=torch.float64, probe=p64)
    res = check.gradients(g32, g64)
    res["attribution"] = _attribution(p32, p64, info["bounces"],
                                      spheres[0].shape[0])
    return res


def readings(workload: str, seed: int, device, config_override=None,
             fault: str | None = None) -> dict:
    """The program's and the control's numbers for one seed, with the
    reference's and the control's seconds, and in a step cell
    ``look_float64``'s numbers; with ``fault`` the program's alone, with
    that fault planted."""
    from . import run
    spec = run.load_cell(workload, False)
    config = dict(spec["config"], **(config_override or {}))
    mix = spec["mix"]
    driver = run.setup(config, mix, seed, device)
    if fault is not None:
        driver.run = FAULTS[fault](driver.run)
    for i in range(mix["warmup_units"] + 1):
        out = driver.run(i)
        driver.wait()
    driver.release()
    t0 = time.perf_counter()
    ref, info = driver.reference(i)
    driver.wait()
    t1 = time.perf_counter()
    res = dict(seed=seed, program=driver.compare(out, ref, info),
               reference_s=t1 - t0, work={k: info[k] for k in (
                   "hits", "misses")})
    if fault is not None:
        res["fault"] = fault
        return res
    if hasattr(driver, "target"):
        res["float64"] = look_float64(driver, i)
    t2 = time.perf_counter()
    ctl, _ = driver.reference(i, dtype=CONTROL_DTYPE)
    res["control"] = driver.compare(ctl, ref, info)
    driver.wait()
    res["control_s"] = time.perf_counter() - t2
    return res


def main(argv=None) -> int:
    from . import check, run
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(FAULTS))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    limits = run.load_cell(a.workload, False)["limits"]
    rows = []
    for seed in a.seeds:
        r = readings(a.workload, seed, device, fault=a.fault)
        r["correct"] = check.verdict(r["program"], limits)[0]
        if "control" in r:
            r["control_correct"] = check.verdict(r["control"], limits)[0]
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = dict(
        workload=a.workload, seeds=a.seeds, fault=a.fault,
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
