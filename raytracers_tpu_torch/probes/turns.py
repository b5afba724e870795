"""Probes of two builds of a kernel source, timed in turns on one card.

A probe that compares a redesigned kernel with its parent builds the
parent's source (from another checkout, e.g. the parent commit unpacked
with ``git archive``) and this checkout's, one nvcc a source, all started
together, into ``build/turns/``; then it runs the same Python on each
build in turns, ``ORDER``: parent, change, change, parent, twice, so that
drift on the card falls on both alike.  ``m2_turns``, ``m7_turns``,
``m3m6_turns`` and ``m4m5_turns`` are such probes.  A probe may also build
side variants of this checkout's sources (``rewrite``: named lines
replaced), to time in turns with the change.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
from pathlib import Path

from ..render import _cuda

OUT_DIR = _cuda.BUILD_DIR.parent / "turns"
ORDER = ("parent", "change", "change", "parent") * 2


def rewrite(kernel: str, name: str, edits) -> Path:
    """A side variant of this checkout's source of ``kernel``: for each
    (old, new) of ``edits`` the one occurrence of old replaced by new,
    written to ``OUT_DIR`` as ``<kernel>_<name>.cu`` (it includes
    ``csrc/``'s headers through ``build``'s ``-I``)."""
    text = _cuda.source(kernel).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{kernel}: {old!r} occurs {text.count(old)} "
                             "times")
        text = text.replace(old, new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"{kernel}_{name}.cu"
    path.write_text(text)
    return path


def build(parent: Path, *kernels: str, sides: dict | None = None) -> dict:
    """{"parent", "change", and each side's name}: {kernel: (the loaded
    library, its path)} of each of ``kernels``' sources
    (``render/_cuda.KERNELS``) in ``parent`` and in this checkout, and of
    ``sides`` ({name: {kernel: source path}}, e.g. ``rewrite``'s), one nvcc
    a source, all started together; nvcc's report (ptxas's registers and
    spills) beside each library, as ``<library>.log``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(name, kernel, path) for kernel in kernels for name, path in (
        ("parent", parent / "raytracers_tpu_torch" / "csrc"
         / _cuda.KERNELS[kernel][0]), ("change", _cuda.source(kernel)))]
    jobs += [(name, kernel, path) for name, srcs in (sides or {}).items()
             for kernel, path in srcs.items()]
    procs = {}
    for name, kernel, path in jobs:
        so = OUT_DIR / f"{kernel}_{name}.so"
        procs[name, kernel] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}", "-o",
             str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs: dict = {name: {} for name, _, _ in jobs}
    for (name, kernel), (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} {kernel}:\n{err}")
        so.with_suffix(".log").write_text(err)     # ptxas's report
        lib = ctypes.CDLL(str(so.resolve()))
        _, fn_name, argtypes = _cuda.KERNELS[kernel]
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        libs[name][kernel] = (lib, so)
    return libs


def use(libs: dict, name: str) -> None:
    """Launch the kernels of ``build``'s ``libs[name]`` from now on."""
    for kernel, (lib, _) in libs[name].items():
        _cuda._libs[kernel] = lib


def medians(times: dict) -> dict:
    """{build: [ms of each turn]} -> {build: median ms}."""
    return {n: statistics.median(t) for n, t in times.items()}
