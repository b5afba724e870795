"""Builds and loads the CUDA kernels of ``csrc/`` at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library of its own with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/kernels/`` of the checkout, named by a hash of the
source, the headers of ``csrc/`` and the flags, so an edited source is
rebuilt and an unchanged one is reused.  ``build_all`` starts one ``nvcc``
for each source that needs it, all together, and waits for them.

The flags keep IEEE float32 arithmetic: ``-fmad=false`` stops nvcc from
contracting a multiply and an add into an FMA (which would move rays by an
ulp against the plain versions), and the default ``-prec-div=true
-prec-sqrt=true`` stay; ``--use_fast_math`` is never used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

_p, _i = ctypes.c_void_p, ctypes.c_int
# kernel -> (source, launch function, its ctypes argument types)
KERNELS = {
    "megakernel": ("megakernel.cu", "rt_megakernel_launch",
                   [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _p,
                    _p, _p, _p, _p, _p, _i, _i, _i, _i, _p]),
    "replay_bwd": ("replay_bwd.cu", "rt_replay_bwd_launch",
                   [_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                    _p]),
    "traversal": ("traversal.cu", "rt_traversal_launch",
                  [_p, _p, _p, _p, _i, _i, _i, _i, _p, _i, _i, _i, _p]),
}

_lock = threading.Lock()
_libs: dict = {}
build_info: dict = {}     # kernel -> path, seconds, ptxas report of its build


def source(name: str) -> Path:
    return CSRC / KERNELS[name][0]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha256(source(name).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_all(names=tuple(KERNELS)) -> None:
    """Compile every kernel of ``names`` whose library of the same sources
    and flags is not there yet: one nvcc each, all started together."""
    started = []
    for name in names:
        out = _target(name)
        if out.exists():
            build_info.setdefault(name, dict(path=str(out), seconds=0.0,
                                             log="(cached)"))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in started:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source(name).name}:\n{err}")
            continue
        os.replace(tmp, out)
        build_info[name] = dict(path=str(out),
                                seconds=time.perf_counter() - t0,
                                log=err.strip())
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str):
    """The launch function of kernel ``name``, with its ctypes signature."""
    with _lock:
        if name not in _libs:
            build_all((name,))
            lib = ctypes.CDLL(build_info[name]["path"])
            _, fn_name, argtypes = KERNELS[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = _i
            lib.rt_error_string.argtypes = [_i]
            lib.rt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return getattr(_libs[name], KERNELS[name][1])


def error_string(name: str, code: int) -> str:
    msg = _libs[name].rt_error_string(code).decode()
    return f"CUDA error {code} ({msg})"
