"""Run one cell of the benchmark once and print its result line.

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  In order: load the cell (``BENCHMARK.json``
names its configuration and traffic mix, each a file under ``rtbench/``);
build or load the program's kernels (the port keeps them in
``build/kernels/`` of the checkout, and the run keeps Python's bytecode in
``build/pycache/``) and draw the inputs from the seed;
warm up on the cell's own shapes; run the window; check a sample of the
window's outputs, drawn from the seed, against the plain reference; print
one JSON line.  The mix names its driver (``rtbench/drivers/<driver>.py``)
and the configuration its scene generator (``rtbench/generators/``), each
found by name.

With ``--trace 0`` the window lasts ``--seconds`` and the line carries the
cell's end-to-end metrics; with ``--trace 1`` the window is the mix's
``trace_units`` units under torch.profiler and the line carries the
cell's per-layer metrics, the device's busy and window seconds and a
breakdown.  Each metric is read by ``rtbench/metrics/<name>.py``.

The run refuses, with no result line, where no CUDA card is present or
fewer than the cell asks for, and where jax, jaxlib, flax or the JAX
package is loaded once the window has closed: it looks when the window
closes and again after the check and the metric readers, just before the
line is printed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracers_tpu")


class Refused(Exception):
    """The run cannot give a result: it exits non-zero and prints none."""


def load_cell(name: str, trace: bool) -> dict:
    """The cell's configuration, mix, limits and metric entries, found by
    the names in ``BENCHMARK.json``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if name in m.get("workloads", [name])]
    return dict(
        cell=cell, metrics=metrics,
        config=json.loads((ROOT / cfg["file"]).read_text()),
        mix=json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                       .read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()))


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "rtbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_if_forbidden(when: str):
    found = loaded_forbidden()
    if found:
        raise Refused(f"loaded {when}: " + ", ".join(found))


def setup(config: dict, mix: dict, seed: int, device):
    """The mix's driver, ``drivers/<driver>.py``, set up for the seed."""
    module = importlib.import_module(f"rtbench.drivers.{mix['driver']}")
    return module.Driver(config, mix, seed, device)


class Run:
    """What the metric readers read: ``window`` (host clock) and, in a
    traced run, ``trace``."""

    def __init__(self, window, trace=None):
        self.window, self.trace = window, trace


def _sample(seed: int, mix: dict) -> set:
    """The units checked besides the window's last: ``check_units`` drawn
    from the seed among the first ``check_within``."""
    rng = random.Random(seed)
    return {rng.randrange(mix["check_within"])
            for _ in range(mix["check_units"])}


def _window(driver, seconds: float, n_units: int | None, keep: set,
            first: int):
    """Units from ``first`` on, each submitted after the last completed,
    until ``seconds`` have passed or, in a traced window, ``n_units`` are
    done, with the harness's spans around each call; returns the
    latencies, the window's length, and the outputs of the units in
    ``keep`` and of the last, by index."""
    import torch
    span = (torch.profiler.record_function if n_units is not None
            else lambda name: contextlib.nullcontext())
    lat, kept = [], {}
    i = first
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        with span("rtbench.submit"):
            out = driver.run(i)
        with span("rtbench.sync"):
            driver.wait()
        te = time.perf_counter()
        lat.append(te - ts)
        if i - first in keep:
            kept[i] = out
        i += 1
        done = (len(lat) >= n_units if n_units is not None
                else te - t0 >= seconds)
        if done:
            kept[i - 1] = out
            return lat, te - t0, kept


def _power_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def run(workload: str, seed: int, seconds: float, trace: bool,
        device=None, config_override: dict | None = None,
        wrap=None) -> dict:
    """One run of ``workload``; returns the result line's object.

    ``device`` None means the CUDA card, and refuses without one; tests
    pass "cpu" with a ``config_override`` (a smaller image) and ``wrap``,
    which wraps the driver's ``run`` to plant a fault."""
    spec = load_cell(workload, trace)
    chips = spec["cell"]["chips"]
    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(f"{workload} needs {chips} CUDA card(s); "
                          f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    from . import check
    from .trace import Trace, Window

    config = dict(spec["config"], **(config_override or {}))
    mix = spec["mix"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    marks = [("torch", time.perf_counter())]
    driver = setup(config, mix, seed, device)
    marks.append(("inputs", time.perf_counter()))
    if wrap is not None:
        driver.run = wrap(driver.run)
    for i in range(mix["warmup_units"]):
        driver.run(i)
        driver.wait()
        marks.append(("first_unit" if i == 0 else "warmup",
                      time.perf_counter()))
    setup_s = time.perf_counter() - T_START
    # where set-up went: torch and the CUDA context, the inputs drawn and
    # the program set up, the first unit (kernels built or loaded), the rest
    parts, last = {}, T_START
    for name, t in marks:
        parts[name] = parts.get(name, 0.0) + t - last
        last = t

    keep = _sample(seed, mix)
    first = mix["warmup_units"]
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            lat, window_s, kept = _window(driver, seconds,
                                          mix["trace_units"], keep, first)
    else:
        lat, window_s, kept = _window(driver, seconds, None, keep, first)
    window = Window(lat, window_s, setup_s)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    refuse_if_forbidden("once the window closed")

    # the check, once the window has closed and the peak is read
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings, works = [], []
    for i in sorted(kept):
        ref, info = driver.reference(i)
        readings.append(driver.compare(kept[i], ref, info))
        works.append({k: info[k] for k in ("pixels", "spheres", "hits",
                                           "misses")})
        del ref, info
    correct, table = check.verdict(check.worst(readings), spec["limits"])
    work = {k: sum(w[k] for w in works) / len(works) for k in works[0]}
    check_s = time.perf_counter() - t_check

    metrics, extra = {}, {}
    tr = None
    if trace:
        tr = Trace.from_profile(prof, len(lat), work)
        extra["busy_s"] = tr.busy_s
        extra["window_s"] = tr.window_s
    r = Run(window, tr)
    for m in spec["metrics"]:
        value = reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(platform="gpu" if cuda else device.type,
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=chips, memory_peak_bytes=peak, **extra)
    out = dict(correct=correct, attempted=len(lat), failed=0,
               metrics=metrics, device=dev)
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["power"] = _power_limit() if cuda else None
    out["setup_parts_s"] = parts
    out["unit_p95_ms"] = window.p95_ms()
    out["checked_units"] = sorted(kept)
    out["check_s"] = check_s
    out["checks"] = table
    # the check and the readers ran after the first look: look again
    refuse_if_forbidden("after the check and the metric readers")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        cpus = load_cell(a.workload, bool(a.trace))["mix"].get("cpus")
    except Refused as e:
        print(f"rtbench: refused: {e}", file=sys.stderr)
        return 2
    if cpus:
        # the mix's last cores for the harness and every thread it starts,
        # fixed before torch loads (PERF.md §2: frames read steadier on one
        # core; a step's backward runs on a thread of its own and slows)
        os.sched_setaffinity(0, set(sorted(os.sched_getaffinity(0))[-cpus:]))
    # caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    # Python's bytecode too, written even where PYTHONDONTWRITEBYTECODE is
    # set: an installation of torch that ships no bytecode would otherwise
    # be compiled from its 2,000 sources in every run's set-up (PERF.md §2)
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    import torch
    torch.set_num_threads(1)
    try:
        out = run(a.workload, a.seed, a.seconds, bool(a.trace))
    except Refused as e:
        print(f"rtbench: refused: {e}", file=sys.stderr)
        return 2
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
