"""The native C++ renderer of ``native/raytracer.cpp``, built and loaded by
the port.

Counterpart of ``raytracers_tpu.native``, with its entry points and
signatures: an independent CPU reference renderer (the one that made
``tests/golden``, and the oracle the card's renders are held against), the
reference driver's separate-phase timing (BVH ms, render ms) and a P3 PPM
writer.  Scenes come in as the port's ``Spheres`` on any device and are
copied to the host; images come back as numpy arrays.

The port builds the library itself at first use, with the system ``g++``,
into ``build/native/`` of the checkout (never into ``native/``), named by a
hash of the source, the compiler, the flags and the host CPU, written
through a temporary file and ``os.replace`` so that processes building at
once do not see each other's half-written file.  The flags are
``native/Makefile``'s plus ``-ffp-contract=off``: GCC's GNU mode contracts
``a * b + c`` into fused multiply-adds wherever ``-march=native`` offers
FMA, and the goldens were made without contraction: with it, the goldens
of depth 2 and more are not reproduced.  Never ``-ffast-math``: the slab
test relies on IEEE infinities.

The native renderer is a CPU program: its times are the host CPU's
(``host_cpu`` names it), never the card's.  Without a compiler, or where
the build fails, every entry point raises ``NativeUnavailable`` naming the
command that failed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _ROOT / "native" / "raytracer.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-fopenmp", "-Wall", "-fPIC",
            "-ffp-contract=off")


class NativeUnavailable(RuntimeError):
    pass


def _cpuinfo() -> dict:
    """The first processor's fields of /proc/cpuinfo (empty elsewhere)."""
    try:
        with open("/proc/cpuinfo") as f:
            text = f.read().split("\n\n")[0]
    except OSError:
        return {}
    return dict((k.strip(), v.strip()) for k, _, v in
                (line.partition(":") for line in text.splitlines()))


def host_cpu() -> str:
    """The host CPU's model name, vendor and whether it has FMA (which the
    build's ``-march=native`` would contract into without
    ``-ffp-contract=off``), and the threads the renderer's OpenMP loop runs
    on (``OMP_NUM_THREADS``, else the CPUs this process may use)."""
    cpu = _cpuinfo()
    fma = "fma" if "fma" in cpu.get("flags", "").split() else "no fma"
    threads = os.environ.get("OMP_NUM_THREADS") or len(os.sched_getaffinity(0))
    return (f"{cpu.get('model name', 'unknown')} "
            f"({cpu.get('vendor_id', 'unknown vendor')}, {fma}), "
            f"{threads} threads")


def build(build_dir: Path = BUILD_DIR) -> Path:
    """The library built from ``SOURCE`` with ``CXXFLAGS`` for this host
    under ``build_dir``: reused where it is there, else compiled."""
    cpu = _cpuinfo()
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (CXX, *CXXFLAGS, cpu.get("model name", ""),
                 cpu.get("flags", "")):
        h.update(part.encode() + b"\0")
    out = Path(build_dir) / f"libraytracer_native_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeUnavailable(f"{' '.join(cmd)} could not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"{' '.join(cmd)} failed with exit code "
                                f"{proc.returncode}:\n{proc.stderr.strip()}")
    os.replace(tmp, out)
    return out


_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int32)
_DP = ctypes.POINTER(ctypes.c_double)
_i = ctypes.c_int
_SCENE = [_FP, _FP, _FP, _i, _FP, _FP, ctypes.c_float, _i, _i, _i]


@lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(build()))
    lib.rt_render.argtypes = _SCENE + [_IP]
    lib.rt_render.restype = _i
    lib.rt_bench.argtypes = _SCENE + [_i, _DP, _DP, _IP]
    lib.rt_bench.restype = _i
    lib.rt_ppm.argtypes = [_IP, _i, _i, ctypes.c_char_p, ctypes.c_long]
    lib.rt_ppm.restype = ctypes.c_long
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype)


def _scene_args(spheres, look_from, look_at, fov, width, height,
                max_depth) -> tuple:
    """The C arguments of a scene and its view, checked (each pointer keeps
    its array alive)."""
    c = _host(spheres.center, np.float32)
    r = _host(spheres.radius, np.float32)
    col = _host(spheres.color, np.float32)
    n = r.shape[0] if r.ndim == 1 else -1
    if n < 1 or c.shape != (n, 3) or col.shape != (n, 3):
        raise ValueError(f"spheres: centre {c.shape}, radius {r.shape}, "
                         f"colour {col.shape}; want (N, 3), (N,), (N, 3)")
    lf, la = _host(look_from, np.float32), _host(look_at, np.float32)
    if lf.shape != (3,) or la.shape != (3,):
        raise ValueError(f"look_from {lf.shape}, look_at {la.shape}: "
                         "want (3,) each")
    if min(width, height, max_depth) < 1:
        raise ValueError(f"width {width}, height {height}, max_depth "
                         f"{max_depth}: each must be positive")
    return (c.ctypes.data_as(_FP), r.ctypes.data_as(_FP),
            col.ctypes.data_as(_FP), n, lf.ctypes.data_as(_FP),
            la.ctypes.data_as(_FP), float(fov), width, height, max_depth)


def render(spheres, look_from, look_at, fov, width, height,
           max_depth: int = 50) -> np.ndarray:
    """Render with the native CPU renderer -> packed int32 (h, w)."""
    lib = _lib()
    args = _scene_args(spheres, look_from, look_at, fov, width, height,
                       max_depth)
    out = np.zeros(width * height, np.int32)
    rc = lib.rt_render(*args, out.ctypes.data_as(_IP))
    if rc != 0:
        raise RuntimeError(f"rt_render failed with code {rc}")
    return out.reshape(height, width)


def bench(spheres, look_from, look_at, fov, width, height,
          max_depth: int = 50, runs: int = 10):
    """Native CPU baseline timing: returns (bvh_ms, render_ms, image), the
    milliseconds averaged over ``runs`` BVH builds and ``runs`` renders on
    the host CPU."""
    lib = _lib()
    if runs < 1:
        raise ValueError(f"runs {runs}: must be positive")
    args = _scene_args(spheres, look_from, look_at, fov, width, height,
                       max_depth)
    out = np.zeros(width * height, np.int32)
    bvh_ms, render_ms = ctypes.c_double(), ctypes.c_double()
    rc = lib.rt_bench(*args, runs, ctypes.byref(bvh_ms),
                      ctypes.byref(render_ms), out.ctypes.data_as(_IP))
    if rc != 0:
        raise RuntimeError(f"rt_bench failed with code {rc}")
    return bvh_ms.value, render_ms.value, out.reshape(height, width)


def ppm_bytes(rgb, height: int, width: int) -> bytes:
    """Fast P3 serialization of an (h*w, 3) uint8 array via the C writer."""
    lib = _lib()
    rgb = _host(rgb, np.int32)
    if rgb.shape != (height * width, 3):
        raise ValueError(f"rgb {rgb.shape}: want ({height * width}, 3)")
    packed = np.ascontiguousarray(
        (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2], np.int32)
    ptr = packed.ctypes.data_as(_IP)
    size = lib.rt_ppm(ptr, height, width, None, 0)
    buf = ctypes.create_string_buffer(size)
    lib.rt_ppm(ptr, height, width, buf, size)
    return buf.raw


# ---- the pixels where a depth-1 render differs from the native oracle ----

# Relative distance within which a float64 quantity counts as at its edge.
# The two renderers trace rays a few float32 ulps apart: the oracle rounds
# its field of view in float32 steps (``vfov * (float)M_PI / 180.0f``)
# where the port rounds it once from float64, and K1 takes u = i * (1 /
# width) where the oracle divides.  On the 17 pixels of rgbbox and irreg at
# 1000x1000 that differ, the edges lie within 1.2e-7 (2^-23); 2^-20 leaves
# a margin of 8.
EDGE_TOL = 2.0 ** -20


def explain_depth1(spheres, cam, width: int, height: int, pixels,
                   port_img, native_img) -> list:
    """Why each pixel (row, col) of ``pixels`` differs between two depth-1
    renders: the port's ``port_img`` and the oracle's ``native_img``, both
    packed (h, w).  At depth 1 a ray that hits is black and one that
    misses takes the sky's colour, so a pixel can differ in two ways:

    * ``grazing``: black against sky, where the pixel's ray, recomputed in
      float64 from the port's camera, passes a sphere (its root beyond the
      scene epsilon) whose discriminant b^2 - a*c lies within EDGE_TOL of
      zero relative to b^2 + |a*c|;
    * ``quantization``: two sky colours one step apart in each channel that
      differs, where that channel's float64 255.99 * colour lies within
      EDGE_TOL of an integer, relative to its value.

    (Which of two hits wins, which key-floor ties decide, never changes a
    depth-1 pixel: both are black.)  Returns one dict per pixel, with
    ``kind`` None where neither holds."""
    f64 = dict(dtype=torch.float64, device="cpu")
    c = spheres.center.detach().to(**f64)
    r = spheres.radius.detach().to(**f64)
    llc, hor, ver, org = (x.detach().to(**f64) for x in
                          (cam.llc, cam.horizontal, cam.vertical, cam.origin))
    out = []
    for j, i in pixels:
        j, i = int(j), int(i)
        got, want = int(port_img[j, i]), int(native_img[j, i])
        d = llc + (i / width) * hor + ((height - j) / height) * ver - org
        oc = org - c
        a = d @ d
        b = oc @ d
        ac = a * ((oc * oc).sum(1) - r * r)
        rel = (b * b - ac).abs() / (b * b + ac.abs())
        ahead = -b / a > 0.1                   # the roots' middle, t > eps
        rel = torch.where(ahead, rel, torch.inf)
        k = int(rel.argmin())
        sky = [(1.0 - t) + t * s for s in (0.5, 0.7, 1.0)
               for t in [0.5 * (float(d[1] / d.norm()) + 1.0)]]
        x = [255.99 * s for s in sky]
        edge = [abs(v - round(v)) / v for v in x]
        steps = [abs(((got >> s) & 0xFF) - ((want >> s) & 0xFF))
                 for s in (16, 8, 0)]
        info = dict(pixel=(j, i), port=hex(got), native=hex(want),
                    sphere=k, disc_rel=float(rel[k]),
                    channel_edge_rel=min(edge))
        if (got == 0) != (want == 0) and float(rel[k]) <= EDGE_TOL:
            info["kind"] = "grazing"
        elif got and want and max(steps) == 1 and all(
                e <= EDGE_TOL for e, s in zip(edge, steps) if s):
            info["kind"] = "quantization"
        else:
            info["kind"] = None
        out.append(info)
    return out
