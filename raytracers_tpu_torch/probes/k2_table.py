"""K2's slot table on an NVIDIA Hopper card: what the table's accumulation
costs, against a K2 that writes no table at all.

K2 (``csrc/replay_bwd.cu``) sums each bounce's 7 sphere cotangents into a
slot table.  This script builds copies of the kernel's source with the
table's accumulation (``table_add``) and pass 2's loop rewritten, one nvcc
each, all started together, into ``build/k2_table/``:

* ``none``: no table writes, the kernel otherwise unchanged: the floor
  that any accumulation can approach;
* ``lane``: each lane adds its own bounce with 7 float32 atomics, in a
  pass-2 loop of its own path's length (the kernel before the warp
  schedule);
* ``lane-uniform``: the same atomics inside the warp-uniform loop;
* ``warp``: the source as committed: the lanes of one slot summed in
  registers, one atomic row-add a group;
* ``warp-end``: ``warp`` with each lane at its own k = L - 1 - i instead of
  every lane at the warp's step k;
* ``parent`` (with ``--parent FILE``): another K2 source, e.g. the parent
  commit's, built as it stands.

It captures the inputs of every K2 launch of one fwd+bwd step at 1000x1000,
depth 50, ``pallas_diff_config``, of rgbbox and irreg at cluster widths 128
and 64, and times every variant on each launch with CUDA events, in turns
(the variants in order, then in reverse).  Each variant's per-ray outputs
must equal the source's bit for bit, its table lie within the bound of a
float32 sum in any order (but ``none``'s), and its counters equal
``grad/replay_bwd_model.warp_groups``' counts.  It prints a line a variant
and segment (ms, bounces, atomic row-adds) and writes a JSON record:

    python -m raytracers_tpu_torch.probes.k2_table --out docs/K2_TABLE_H100.json

It needs the card and nvcc; it times nothing elsewhere.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from .. import scenes
from ..geometry import Camera, Spheres, camera
from ..grad import replay_bwd as rb
from ..grad import replay_bwd_model as model
from ..grad.pallas_diff import make_render_pallas_diff
from ..render import _cuda
from ..render.api import pallas_diff_config
from ..render.megakernel import _ptr, build_pallas_scene
from ..utils.timing import cuda_ms
from .microbench import _smi

SIZE, DEPTH = 1000, 50
CELLS = (("rgbbox", 128), ("irreg", 128), ("rgbbox", 64), ("irreg", 64))
F32_EPS, F32_FTZ = 2.0 ** -24, 2.0 ** -125

_SIGNATURE = "__device__ __forceinline__ int table_add("
_LANE_BODY = """{
  if (e < 0) return 0;
  float* row = table + (size_t)e * 7;
#pragma unroll
  for (int r = 0; r < 7; ++r) atomicAdd(row + r, cot[r]);
  return 1;
}"""
_UNIFORM = "const int Lw = __reduce_max_sync(kFull, L);"
_DEPTH_K = "const int k = Lw - 1 - i;\n    const bool active = k < L;"
_END_K = "const int k = L - 1 - i;\n    const bool active = k >= 0;"
# name -> (table_add's body or None for the source's, the rewrites)
VARIANTS = {
    "none": ("{ return 0; }", ()),
    "lane": (_LANE_BODY, ((_UNIFORM, "const int Lw = L;"),)),
    "lane-uniform": (_LANE_BODY, ()),
    "warp": (None, ()),
    "warp-end": (None, ((_DEPTH_K, _END_K),)),
}
SASS_OPS = ("MATCH", "SHFL", "VOTE", "REDUX", "REDG", "ATOMG", "RED", "ATOM")


def _replace_once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source does not hold {old!r} once")
    return text.replace(old, new)


def variant_source(text: str, body: str | None, rewrites=()) -> str:
    """The source with ``table_add``'s body replaced and ``rewrites``
    made, each of whose old strings it must hold once."""
    if body is not None:
        at = text.index(_SIGNATURE)
        open_ = text.index("{\n", at)
        close = text.index("\n}\n", open_) + 2
        text = text[:open_] + body + text[close:]
    for old, new in rewrites:
        text = _replace_once(text, old, new)
    return text


def _has_counters(text: str) -> bool:
    launch = re.search(r"rt_replay_bwd_launch\(([^)]*)\)", text, re.S)
    return launch is not None and "counters" in launch[1]


def build(out_dir: Path, parent: Path | None = None) -> dict:
    """Each variant's library and whether its launch takes counters."""
    text = _cuda.source("replay_bwd").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: (variant_source(text, body, rw), _cuda.CSRC)
               for name, (body, rw) in VARIANTS.items()}
    if parent is not None:
        sources = {"parent": (parent.read_text(), parent.parent), **sources}
    procs = []
    for name, (src_text, inc) in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(src_text)
        so = out_dir / f"{name}.so"
        procs.append((name, so, _has_counters(src_text), subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{inc}", "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    libs = {}
    for name, so, counters, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        lib = ctypes.CDLL(str(so.resolve()))
        args = list(_cuda.KERNELS["replay_bwd"][2])
        if not counters:
            del args[10]
        lib.rt_replay_bwd_launch.argtypes = args
        lib.rt_replay_bwd_launch.restype = ctypes.c_int
        libs[name] = (lib, counters, so)
    return libs


def sass_counts(so: Path) -> dict | None:
    """Static counts of the warp and atomic instructions in the library's
    SASS, by opcode (None where cuobjdump is not found)."""
    tool = shutil.which("cuobjdump") or str(
        Path(_cuda._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        return None
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     out.stdout)
    return {op: sum(1 for o in ops if o == op) for op in SASS_OPS}


def capture(name: str, width: int) -> dict:
    """The inputs of every K2 launch of one fwd+bwd step, by segment."""
    sc = scenes.by_name(name)
    cam = camera(sc.look_from, sc.look_at, (0.0, 1.0, 0.0), sc.fov, 1.0)
    cw = None if width == 128 else width
    layout = build_pallas_scene(sc.spheres, cluster_width=cw)
    tile, block, schedule, prefix = pallas_diff_config(
        build_pallas_scene(sc.spheres).n_clusters)
    calls = []

    def kernel(*args, **kw):
        calls.append((args, kw))
        return rb.replay_bwd(*args, **kw)

    f = make_render_pallas_diff(SIZE, SIZE, max_depth=DEPTH, tile=tile,
                                block=block, schedule=schedule,
                                sort_prefix=prefix, cluster_width=cw,
                                bwd_kernel=kernel)
    sph = Spheres(*(t.detach().requires_grad_(True) for t in sc.spheres))
    c = Camera(*(t.detach().requires_grad_(True) for t in cam))
    img = f(sph, c)
    (img * img).sum().backward()
    torch.cuda.synchronize()
    return dict(calls=calls[::-1], n_slots=layout.order.numel(),
                clusters=layout.n_clusters)


class Launch:
    """One captured K2 launch, replayed by direct calls into a variant's
    library on buffers allocated once (the table is zeroed only for the
    checked launch: the timed ones add onto it)."""

    def __init__(self, args, kw, n_slots: int):
        params, rec, pay, gcot = args
        self.args, self.kw, self.n_slots = args, kw, n_slots
        self.state = kw.get("state_rows")
        D, n = rec.shape
        f32 = dict(dtype=torch.float32, device=rec.device)
        self.scratch = torch.empty(D, rb.N_CARRY, n, **f32)
        self.table = torch.zeros(n_slots, 7, **f32)
        self.cotray = torch.empty(rb.N_CARRY if self.state is not None
                                  else 6, n, **f32)
        self.counters = torch.zeros(len(rb.COUNTERS), dtype=torch.int64,
                                    device=rec.device)

    def __call__(self, lib, counters: bool, count: bool = False):
        params, rec, pay, gcot = self.args
        D, n = rec.shape
        ptrs = [_ptr(params), _ptr(rec), _ptr(pay), _ptr(gcot),
                _ptr(self.state), _ptr(self.scratch), None, _ptr(self.table),
                _ptr(self.cotray), None]
        if counters:
            ptrs.append(_ptr(self.counters) if count else None)
        rc = lib.rt_replay_bwd_launch(
            *ptrs, D, n, self.kw["tile"],
            int(bool(self.kw.get("block_tiled", False))),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"replay_bwd launch failed: CUDA error {rc}")

    def checked(self, lib, counters: bool):
        """One launch on a zeroed table: (cotray, table, counters)."""
        self.table.zero_()
        self.counters.zero_()
        self(lib, counters, count=counters)
        torch.cuda.synchronize()
        return (self.cotray.clone(), self.table.clone(),
                self.counters.tolist() if counters else None)


def _table_bound(launch: Launch):
    """The float64 table and its bound from the per-step cotangents."""
    params, rec, pay, gcot = launch.args
    step, _, _ = rb.replay_bwd(params, rec, pay, gcot,
                               **dict(launch.kw, reduce_slots=None))
    S = launch.n_slots
    exact = rb.slot_table(rec, step, S)
    mag = rb.slot_table(rec, step, S, absolute=True)
    ids = rec.reshape(-1)
    count = torch.zeros(S, dtype=torch.float64, device=rec.device)
    count.index_add_(0, ids.clamp(min=0).long(), (ids >= 0).double())
    bound = ((count[:, None] + 1.0) * F32_EPS * mag
             + count[:, None] * F32_FTZ)
    return exact, bound


def _want_counters(v: str, groups: dict, bounces: int):
    """The counters a variant must report on a launch, or None."""
    if v == "none":
        return [0, groups["depth"].warp_iterations]
    if v == "lane-uniform":
        return [bounces, groups["depth"].warp_iterations]
    if v == "warp":
        g = groups["depth"]
        return [g.row_adds, g.warp_iterations]
    if v == "warp-end":
        g = groups["end"]
        return [g.row_adds, g.warp_iterations]
    # lane: each lane runs its own path, and lane 0's counts its warp's
    # iterations; parent: no counters
    return None


def run(parent: Path | None = None, turns: int = 2, rounds: int = 2,
        runs: int = 10, log=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("k2_table times K2 on the card; none is here")
    libs = build(_cuda.BUILD_DIR.parent / "k2_table", parent)
    names = list(libs)
    cells, launches, checks = {}, {}, {}
    for scene, width in CELLS:
        key = f"{scene} W={width}"
        cap = capture(scene, width)
        ls = [Launch(a, kw, cap["n_slots"]) for a, kw in cap["calls"]]
        launches[key] = ls
        segs = []
        for launch in ls:
            rec = launch.args[1]
            groups = {a: model.warp_groups(rec, a) for a in model.ALIGNS}
            g = groups["depth"]
            segs.append(dict(depth=rec.shape[0], rays=rec.shape[1],
                             live=int((rec[0] != -2).sum()),
                             bounces=g.bounces, per_bounce=g.per_bounce(),
                             model={a: dict(row_adds=x.row_adds,
                                            warp_iterations=x.warp_iterations,
                                            conflict=x.conflict)
                                    for a, x in groups.items()}))
            checks.setdefault(key, []).append(
                (groups, _table_bound(launch)))
        cells[key] = dict(scene=scene, cluster_width=width,
                          clusters=cap["clusters"], slots=cap["n_slots"],
                          segments=segs)

    counters = {v: {} for v in names}
    for key, ls in launches.items():
        refs = {}
        for v in ["warp"] + [x for x in names if x != "warp"]:
            lib, has_cnt, _ = libs[v]
            per_seg = []
            for s, launch in enumerate(ls):
                ray, tab, cnt = launch.checked(lib, has_cnt)
                groups, (exact, bound) = checks[key][s]
                if v == "warp":
                    refs[s] = ray
                elif not torch.equal(ray.view(torch.int32),
                                     refs[s].view(torch.int32)):
                    raise RuntimeError(f"{v} on {key} segment {s}: the "
                                       "per-ray outputs differ from the "
                                       "source's")
                if v != "none":
                    err = (tab.double() - exact).abs()
                    if (err > bound).any():
                        raise RuntimeError(f"{v} on {key} segment {s}: the "
                                           "table is outside its bound")
                want = _want_counters(v, groups,
                                      cells[key]["segments"][s]["bounces"])
                if want is not None and cnt != want:
                    raise RuntimeError(f"{v} on {key} segment {s}: counters "
                                       f"{cnt}, the model's {want}")
                per_seg.append(cnt)
            counters[v][key] = per_seg

    ms = {v: {key: [[] for _ in ls] for key, ls in launches.items()}
          for v in names}
    for turn in range(turns):
        for v in names if turn % 2 == 0 else names[::-1]:
            lib, has_cnt, _ = libs[v]
            for key, ls in launches.items():
                for s, launch in enumerate(ls):
                    ms[v][key][s] += [
                        cuda_ms(lambda: launch(lib, has_cnt), warmup=1,
                                runs=runs) for _ in range(rounds)]
    variants = {}
    for v in names:
        variants[v] = {}
        for key in launches:
            mean = [sum(x) / len(x) for x in ms[v][key]]
            variants[v][key] = dict(ms=ms[v][key], mean_ms=mean,
                                    total_ms=sum(mean),
                                    counters=counters[v][key])
            for s, m in enumerate(mean):
                seg = cells[key]["segments"][s]
                cnt = counters[v][key][s]
                log(f"[k2_table] {v} {key} segment {s}: {m:.4f} ms, "
                    f"{seg['bounces']} bounces, row-adds "
                    f"{cnt[0] if cnt else 'not counted'}")
    for key, c in cells.items():
        for s, seg in enumerate(c["segments"]):
            log(f"[k2_table] {key} segment {s} per bounce (warp): "
                + ", ".join(f"{op} {x:.3f}"
                            for op, x in seg["per_bounce"].items()))
    return dict(card=_smi("name,power.limit"), size=SIZE, depth=DEPTH,
                counters=list(rb.COUNTERS), order=names, turns=turns,
                rounds=rounds, runs=runs, cells=cells, variants=variants,
                sass={v: sass_counts(so) for v, (_, _, so) in libs.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="where to write the JSON record")
    ap.add_argument("--parent", type=Path, default=None,
                    help="another replay_bwd.cu to time beside the variants")
    args = ap.parse_args(argv)
    rec = run(args.parent)
    print(rec["card"])
    for v, r in rec["variants"].items():
        print(v, {c: round(x["total_ms"], 4) for c, x in r.items()})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
