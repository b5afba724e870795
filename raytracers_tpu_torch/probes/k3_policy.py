"""K3's warp policy on an NVIDIA Hopper card: the measurement behind the
constants of ``csrc/traversal.cu``.

K3's kernel picks, each iteration of a warp, a leaf round when at least
``kLeafEighths`` / 8 of its walking lanes wait at leaves, a shading when at
least ``kShadeEighths`` / 8 of its lanes with rays wait to shade, and splits
a leaf round over the lanes where that takes fewer slot passes than K with
each group charged ``kSplitOverhead`` more.  None of them changes a pixel;
all change the time.  This script builds copies of the kernel's source with
other values of the three (one nvcc each, all started together, into
``build/k3_policy/``), and times each copy against the source's own, in
turns (the variants in order, then in reverse), on K3's cells:
``render_traversal`` of rgbbox and irreg at 1000x1000, depth 50, and of the
14,400-sphere soup of its global-memory path.  Every image must equal the
source's bit for bit.  It prints a line a variant and writes a JSON record:

    python -m raytracers_tpu_torch.probes.k3_policy --out K3_POLICY_H100.json

It needs the card and nvcc; it times nothing elsewhere.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from .. import scenes
from ..geometry import camera
from ..render import _cuda
from ..render import traversal as tr
from ..utils.timing import cuda_ms
from .microbench import _smi

SIZE, DEPTH = 1000, 50
# the soup of the global-memory path: spheres, seed, extent, camera z
SOUP = (14_400, 5, 200.0, 260.0)
# name -> (kLeafEighths, kShadeEighths, kSplitOverhead); "source" is the
# kernel as committed, the others move one of its constants
VARIANTS = {
    "source": None,
    "tpu_quarter": (2, 2, 1),        # the TPU's quarter, split at 1
    "leaf_half": (4, 2, 8),
    "leaf_all": (8, 2, 8),           # only when no lane is at an inner node
    "shade_at_once": (6, 0, 8),
    "shade_half": (6, 4, 8),
    "shade_last": (6, 9, 8),         # only when no lane walks
    "overhead_3": (6, 2, 3),
    "overhead_20": (6, 2, 20),
    "never_split": (6, 2, 1000),
}
CONSTANTS = ("kLeafEighths", "kShadeEighths", "kSplitOverhead")


def source_values(text: str) -> tuple:
    """The source's values of the three constants."""
    return tuple(int(re.search(rf"constexpr int {c} = (\d+);", text)[1])
                 for c in CONSTANTS)


def variant_source(text: str, values: tuple) -> str:
    for c, v in zip(CONSTANTS, values):
        text, n = re.subn(rf"constexpr int {c} = \d+;",
                          f"constexpr int {c} = {v};", text)
        if n != 1:
            raise RuntimeError(f"{c} is not defined once in the source")
    return text


def build(out_dir: Path) -> dict:
    """Each variant's launch function, built from a rewritten copy."""
    text = _cuda.source("traversal").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, values in VARIANTS.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text if values is None
                       else variant_source(text, values))
        so = out_dir / f"{name}.so"
        procs.append((name, so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}", "-o",
             str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, so, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        lib = ctypes.CDLL(str(so.resolve()))
        lib.rt_traversal_launch.argtypes = _cuda.KERNELS["traversal"][2]
        lib.rt_traversal_launch.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def cells() -> dict:
    """K3's cells on the card: tables, C, K and camera."""
    out = {}
    for name in ("rgbbox", "irreg"):
        sc = scenes.by_name(name)
        cam = camera(sc.look_from, sc.look_at, (0.0, 1.0, 0.0), sc.fov, 1.0)
        out[name] = (*tr.build_traversal_scene(sc.spheres), cam)
    n, seed, extent, z = SOUP
    sph = scenes.random_spheres(n, seed=seed, extent=extent)
    cam = camera((0.0, 0.0, z), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0, 1.0)
    out["soup14k"] = (*tr.build_traversal_scene(sph), cam)
    return out


def run(turns: int = 2, rounds: int = 2, renders: int = 5) -> dict:
    """Every variant on every cell, ``rounds`` rounds of ``renders``
    renders a turn (each round one CUDA-event pair); the kernel's warp
    rounds of one render each."""
    if not torch.cuda.is_available():
        raise RuntimeError("k3_policy times K3 on the card; none is here")
    libs = build(_cuda.BUILD_DIR.parent / "k3_policy")
    text = _cuda.source("traversal").read_text()
    values = {n: v or source_values(text) for n, v in VARIANTS.items()}
    cs = cells()
    ms = {v: {c: [] for c in cs} for v in VARIANTS}
    counters = {v: {} for v in VARIANTS}
    ref = {}
    order = list(VARIANTS)
    held = _cuda._libs.get("traversal")
    try:
        for turn in range(turns):
            for v in order if turn % 2 == 0 else order[::-1]:
                _cuda._libs["traversal"] = libs[v]
                for c, (scene, C, K, cam) in cs.items():
                    def call():
                        return tr.render_traversal(scene, C, K, cam, SIZE,
                                                   SIZE, max_depth=DEPTH)
                    img = call()
                    torch.cuda.synchronize()
                    ref.setdefault(c, img)
                    if not torch.equal(img, ref[c]):
                        raise RuntimeError(f"{v} on {c}: the image differs "
                                           "from the source's")
                    ms[v][c] += [cuda_ms(call, warmup=0, runs=renders)
                                 for _ in range(rounds)]
                    if turn == 0:
                        cnt = torch.zeros(len(tr.COUNTERS),
                                          dtype=torch.int64, device="cuda")
                        tr.render_traversal(
                            scene, C, K, cam, SIZE, SIZE, max_depth=DEPTH,
                            kernel=lambda *a, **kw: tr.traversal_kernel(
                                *a, counters=cnt, **kw))
                        counters[v][c] = dict(zip(tr.COUNTERS,
                                                  cnt.tolist()))
    finally:
        if held is None:
            _cuda._libs.pop("traversal", None)
        else:
            _cuda._libs["traversal"] = held
    return dict(
        card=_smi("name,power.limit"), size=SIZE, depth=DEPTH,
        constants=CONSTANTS, cells={c: dict(clusters=C, leaf_size=K)
                                    for c, (_, C, K, _) in cs.items()},
        variants={v: dict(values=values[v], ms=ms[v],
                          mean_ms={c: sum(x) / len(x)
                                   for c, x in ms[v].items()},
                          counters=counters[v]) for v in VARIANTS})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="where to write the JSON record")
    args = ap.parse_args(argv)
    rec = run()
    print(rec["card"])
    for v, r in rec["variants"].items():
        print(v, r["values"], {c: round(m, 4)
                               for c, m in r["mean_ms"].items()})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
