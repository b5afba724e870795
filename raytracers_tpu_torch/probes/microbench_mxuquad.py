"""M7 on an NVIDIA Hopper card: the counterpart of ``tools/microbench_mxuquad.py``.

The TPU probe asked whether b and c of the visit's quadratic could come
from one small matrix product a visit instead of the FP32 chain:

    b  = o.d - c.d            G's b row [-cx -cy -cz 0 0 0 1 0 0 ...]
    c2 = |o|^2 - 2c.o + |c|^2 - r^2
                              G's c row [0 0 0 -2cx -2cy -2cz 0 1 |c|^2-r^2 ...]
    F  = [dx dy dz ox oy oz o.d |o|^2 1 0 ...]   per ray, (16, 512)

with bf16 operands and float32 accumulation, G (2 rows splits, 16) stacking
its splits (hi, mid and lo bf16 parts of each row for splits = 3), the
products summed over splits.  This asks it of the H100's tensor cores, in
hand-written CUDA (``csrc/microbench_mxuquad.cu``):

* mode ``vpu``: M5's ``mxu`` visit, the FP32 chain, one thread per ray;
  bit-equal to its plain version;
* mode ``mxuquad``: one bf16 ``mma.sync.m16n8k16`` per 8 sphere rows, 8
  rays and split (the depth of 16 is the 16 features), then the rest of
  the visit warp-cooperatively, the key's minimum over rows by shuffles.
  Tensor-core sums are not IEEE, so the kernel's product is held within a
  stated bound of the float64 product of the bf16-rounded operands
  (``product_tolerance``), and the visit after it bit for bit against the
  plain visit given that product.

The wrapper launches its kernel for CUDA tensors (counted in
``microbench.LAUNCHES`` under the variant's label) and takes the plain
version for CPU tensors.  ``run()`` drives the TPU probe's five variants
(``main``, tools/microbench_mxuquad.py:151-153) at its 8,192 rays and at
1,048,576, and counts the rays whose winning row equals the ``vpu`` visit's
on the same spheres; ``main`` writes ``docs/MICROBENCH_MXUQUAD_H100.json``:

    python -m raytracers_tpu_torch.probes.microbench_mxuquad        # on the card
    python -m raytracers_tpu_torch.probes.microbench_mxuquad --device cpu

The ``torch.matmul`` of the bf16 operands timed beside ``mxuquad`` is a
yardstick: no result of the port goes through it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.platform import resolve_device
from . import microbench_v5 as v5
from .microbench import (F32, FP32_LANE_OPS_PER_S, HBM_BYTES_PER_S, I32,
                         SALT, ProbeMismatch, _bit_equal, _c, _entry,
                         _expect, _launch, _on_card, _plain_timed, _smi,
                         _timed, measure_mul_equivalents, sass_counts)

T, ITERS, INPUTS = v5.T, v5.ITERS, v5.INPUTS
MODES = ("vpu", "mxuquad")
SPLITS = (1, 3)
ROWS = (32, 64, 128)
# the TPU probe's variants (rows, mode, splits), in its order
VARIANTS = ((128, "vpu", 1), (128, "mxuquad", 1), (128, "mxuquad", 3),
            (32, "vpu", 1), (32, "mxuquad", 3))
RAYS = (v5.GRID * T, 1 << 20)
N_FEATURES = 16
BF16_FLOPS_PER_S = 989e12         # H100 SXM dense bf16 (NVIDIA's data sheet)
TPU_G = 0.05                      # tools/microbench_mxuquad.py:142

RECORD = (Path(__file__).resolve().parents[2] / "docs"
          / "MICROBENCH_MXUQUAD_H100.json")


def label(rows: int, mode: str, splits: int, n_rays: int) -> str:
    return f"M7 {tag(rows, mode, splits)} {n_rays}"


def tag(rows: int, mode: str, splits: int) -> str:
    """The TPU probe's name of a variant (tools/microbench_mxuquad.py:155)."""
    return f"rows{rows}_{mode}{splits if mode == 'mxuquad' else ''}"


def visit_mxuquad(salt, sphT, sph8, G, n_rays, rows, mode="vpu", splits=1,
                  iters=ITERS, tap=None):
    """M7: ``iters`` visits of ``rows`` spheres by ``n_rays`` fake rays (lane
    j % 512); out (n_rays / 512, 8, 512) = pay + float(krun).  ``vpu``: b
    and c from ``sphT`` (rows, 8) by the FP32 chain, as M5's ``mxu``;
    ``mxuquad``: from G (2 rows splits, 16) @ F, bf16 products summed in
    float32, b + salt * c * 1e-20 at visit c.  ``sph8`` (8, rows) holds the
    payload.  ``tap``: (2 rows, 512) float32 that receives tile 0's summed
    product (b rows, then c rows) of visit 0 (``mxuquad`` only)."""
    _expect(salt, (1,), F32, "salt")
    _expect(sphT, (rows, 8), F32, "M7 sphT")
    _expect(sph8, (8, rows), F32, "M7 sph8")
    _expect(G, (2 * rows * splits, N_FEATURES), F32, "M7 G")
    if (rows not in ROWS or mode not in MODES or splits not in SPLITS
            or n_rays < T or n_rays % T or iters < 0):
        raise ValueError(f"M7: rows {rows}, mode {mode!r}, splits {splits}, "
                         f"{n_rays} rays, iters {iters}")
    if tap is not None:
        if mode != "mxuquad":
            raise ValueError("M7: only mxuquad has a product to tap")
        _expect(tap, (2 * rows, T), F32, "M7 tap")
    ts = (salt, sphT, sph8, G) + ((tap,) if tap is not None else ())
    if not _on_card(*ts):
        if tap is not None:
            tap.copy_(product_plain(G, features(salt), rows, splits).float())
        return visit_mxuquad_plain(salt, sphT, sph8, G, n_rays, rows, mode,
                                   splits, iters)
    out = torch.empty((n_rays // T, 8, T), dtype=F32, device=salt.device)
    return _launch(label(rows, mode, splits, n_rays), out, MODES.index(mode),
                   rows, splits, iters, n_rays, salt,
                   sphT if mode == "vpu" else G, sph8, out, tap,
                   kernel="microbench_mxuquad")


def features(salt) -> torch.Tensor:
    """F (16, 512) float32: [dx dy dz ox oy oz o.d |o|^2 1 0 ...] of the fake
    rays (tools/microbench_mxuquad.py:64-70), before its bf16 cast."""
    ox, oy, oz, dx, dy, dz, _, _ = v5.fake_rays(salt)
    odot = (ox * dx + oy * dy) + oz * dz
    o2 = (ox * ox + oy * oy) + oz * oz
    one = torch.ones_like(ox)
    zero = torch.zeros((N_FEATURES - 9, T), dtype=F32, device=ox.device)
    return torch.cat([torch.stack([dx, dy, dz, ox, oy, oz, odot, o2, one]),
                      zero])


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to bf16 (to nearest, ties to even) and back."""
    return x.to(torch.bfloat16).to(F32)


def product_plain(G, F, rows, splits) -> torch.Tensor:
    """(2 rows, 512) float64: sum over splits of bf16(G_i) @ bf16(F).  Each
    bf16 product has at most 16 significant bits and is exact; the sums
    round at float64's 2^-53."""
    Fd = bf16(F).double()
    Gd = bf16(G).double()
    n = 2 * rows
    return sum(Gd[i * n:(i + 1) * n] @ Fd for i in range(splits))


def product_magnitude(G, F, rows, splits) -> torch.Tensor:
    """sum over splits of |bf16(G_i)| @ |bf16(F)|, float64 (2 rows, 512)."""
    Fd = bf16(F).double().abs()
    Gd = bf16(G).double().abs()
    n = 2 * rows
    return sum(Gd[i * n:(i + 1) * n] @ Fd for i in range(splits))


def product_tolerance(G, F, rows, splits) -> torch.Tensor:
    """Bound on |kernel's summed product - float64|.  Each mma.sync adds 16
    exact bf16 products in float32 with truncation, not rounding to
    nearest: each of the 16 terms can lose up to 2^-23 of the largest
    magnitude, and the result one more, so 17 * 2^-23 of the split's
    magnitude sum; the float32 sum over splits rounds once an add, 2^-24
    of the magnitudes so far."""
    mag = product_magnitude(G, F, rows, splits)
    return (17 * 2.0 ** -23 + (splits - 1) * 2.0 ** -24) * mag


def visit_mxuquad_state_plain(salt, sphT, sph8, G, rows, mode="vpu",
                              splits=1, iters=ITERS, bc=None):
    """One tile's krun (512,) int32 and pay (8, 512) float32.  ``vpu``: M5's
    ``mxu`` visit.  ``mxuquad``: b and c from ``bc`` (2 rows, 512) float32,
    the summed product, by default the float64 product rounded once; the
    kernel's bc comes from the tensor cores, so the kernel's visit equals
    this one given the kernel's product."""
    if mode == "vpu":
        return v5.visit_v5_state_plain(salt, sphT, sph8, rows, "mxu",
                                       iters)[:2]
    if bc is None:
        bc = product_plain(G, features(salt), rows, splits).float()
    _, _, _, _, _, _, a, inv_a = v5.fake_rays(salt)
    mask = v5.key_mask(rows, "mxu")
    krun = torch.full((T,), v5.MISS_KEY, dtype=I32, device=salt.device)
    pay = torch.zeros((8, T), dtype=F32, device=salt.device)
    tiny = _c(1e-20, salt)
    for c in range(iters):
        b = bc[:rows] + (salt * _c(float(c), salt)) * tiny
        kmin = v5.visit_keys(b, bc[rows:], a, inv_a, mask, rows).amin(0)
        imp = kmin < krun
        pay = torch.where(imp, sph8[:, (kmin & (rows - 1)).long()], pay)
        krun = torch.minimum(krun, kmin)
    return krun, pay


def visit_mxuquad_plain(salt, sphT, sph8, G, n_rays, rows, mode="vpu",
                        splits=1, iters=ITERS, bc=None):
    krun, pay = visit_mxuquad_state_plain(salt, sphT, sph8, G, rows, mode,
                                          splits, iters, bc)
    return (pay + krun.float()).expand(n_rays // T, 8, T)


def g_rows(sphT: np.ndarray) -> np.ndarray:
    """G's b and c rows (2 rows, 16) float64 from a (rows, 8) table whose
    column 7 is r^2 (M5's layout), as the TPU probe's docstring writes
    them."""
    rows = sphT.shape[0]
    c = sphT[:, :3].astype(np.float64)
    g = np.zeros((2 * rows, N_FEATURES))
    g[:rows, :3] = -c
    g[:rows, 6] = 1.0
    g[rows:, 3:6] = -2.0 * c
    g[rows:, 7] = 1.0
    g[rows:, 8] = (c * c).sum(1) - sphT[:, 7].astype(np.float64)
    return g


def bf16_split(g: np.ndarray, splits: int) -> np.ndarray:
    """(splits * n, 16) float32: g rounded to float32, then for 3 splits its
    hi, mid and lo bf16 parts (g - hi, g - hi - mid), each exactly a bf16
    value, stacked; for 1 split g itself (the kernel rounds it)."""
    g32 = torch.from_numpy(g.astype(np.float32))
    if splits == 1:
        return g32.numpy()
    hi = bf16(g32)
    mid = bf16(g32 - hi)
    lo = bf16(g32 - hi - mid)
    return torch.cat([hi, mid, lo]).numpy()


def mxuquad_inputs(kind: str, rows: int, splits: int):
    """(sphT, sph8, G) float32 numpy arrays: M5's spheres of ``kind`` and
    G = 0.05 everywhere (``tpu``, the TPU probe's fill) or the b and c rows
    of the seeded spheres (``seeded``)."""
    sphT, sph8 = v5.visit_v5_inputs(kind, rows)
    if kind == "tpu":
        G = np.full((2 * rows * splits, N_FEATURES), TPU_G, np.float32)
    else:
        G = bf16_split(g_rows(sphT), splits)
    return sphT, sph8, G


# ---------------------------------------------------------------- bounds

# Lane operations of one (ray, sphere row) test of mxuquad after the
# product: the salt term's add 1, the splits' sums 2 (splits - 1), then as
# M5 from disc on: disc 3, its test and select 2, -b 1, t0 2, t1 2, the
# root's test and select 2, t > eps, the and, tv's select 3, the key 2, the
# minimum 1 = 19 + 2 (splits - 1), plus the square root.  Per ray and visit
# as M5's mxu (10); per tile and visit the salt term's 2 products; per ray
# the set-up (12 and 1/a), the features (o.d 5, |o|^2 5, 9 bf16 casts) and
# the output (8 adds and a conversion).
MXQ_ROW_OPS, MXQ_RAY_OPS = 19, 12 + 19 + 9


def visit_mxuquad_work(n_rays, rows, mode, splits, iters, sqrt_ops, div_ops):
    """(FP32 lane operations, bf16 tensor-core flops, bytes) of one launch:
    the product 2 (2 rows splits) 16 flops a ray and visit."""
    if mode == "vpu":
        ops, nbytes = v5.visit_v5_work(n_rays, rows, "mxu", iters, sqrt_ops,
                                       div_ops)
        return ops, 0, nbytes
    per_row = MXQ_ROW_OPS + 2 * (splits - 1) + sqrt_ops
    ops = (n_rays * iters * (rows * per_row + v5.VISIT_RAY_VISIT_OPS["mxu"])
           + (n_rays // T) * iters * 2 + n_rays * (MXQ_RAY_OPS + div_ops))
    flops = n_rays * iters * 2 * (2 * rows * splits) * N_FEATURES
    nbytes = 4 * (2 * rows * splits * N_FEATURES + 8 * rows + 8 * n_rays + 1)
    return ops, flops, nbytes


def bound_work(ops, flops):
    """(work, peak rate) of the operations that take longer at their peak:
    FP32 lane operations at 33.5e12 a second, or bf16 tensor-core flops at
    989e12; ``_entry`` sets them against the bytes."""
    return max((ops, FP32_LANE_OPS_PER_S), (flops, BF16_FLOPS_PER_S),
               key=lambda w: w[0] / w[1])


# ---------------------------------------------------------------- runs

def _matmul_ms(G, F, n_rays, rows, splits):
    """The library call: one torch.matmul of the bf16 operands, G (2 rows
    splits, 16) @ F (16, n_rays), times the visits."""
    from ..utils.timing import cuda_ms
    Gb = G.to(torch.bfloat16)
    Fb = F.to(torch.bfloat16).repeat(1, n_rays // T)
    return ITERS * cuda_ms(lambda: torch.matmul(Gb, Fb), warmup=1, runs=5)


def run_m7(dev, weights, log=print):
    """The TPU probe's five variants on the card, on both inputs, at 8,192
    and 1,048,576 rays: timed; ``vpu`` bit-equal to its plain version;
    ``mxuquad``'s product within ``product_tolerance`` of the float64
    product and its visit bit-equal to the plain visit given that product;
    the rays whose winning row equals the ``vpu`` visit's counted."""
    salt = torch.tensor([SALT], dtype=F32, device=dev)
    F = features(salt)
    out = []
    v5.warm_plain(salt)
    for which in INPUTS:
        vpu_krun = {}
        for rows, mode, splits in VARIANTS:
            sphT, sph8, G = (torch.from_numpy(x).to(dev)
                             for x in mxuquad_inputs(which, rows, splits))
            if rows not in vpu_krun:
                vpu_krun[rows] = v5.visit_v5_state_plain(
                    salt, sphT, sph8, rows, "mxu", ITERS)[0]
            state, plain_ms = _plain_timed(lambda: visit_mxuquad_state_plain(
                salt, sphT, sph8, G, rows, mode, splits, ITERS))
            extra = {}
            if mode == "mxuquad":
                exact = product_plain(G, F, rows, splits)
                tol = product_tolerance(G, F, rows, splits)
            for n_rays in RAYS:
                name = f"{label(rows, mode, splits, n_rays)} rays ({which})"
                tap = (torch.empty((2 * rows, T), dtype=F32, device=dev)
                       if mode == "mxuquad" else None)
                ms, y, _, runs = _timed(
                    lambda: visit_mxuquad(salt, sphT, sph8, G, n_rays, rows,
                                          mode, splits, ITERS, tap),
                    min_window_ms=50.0)
                err = 0.0
                if mode == "vpu":
                    ref = (state[1] + state[0].float()).expand_as(y)
                else:
                    gap = (tap.double() - exact).abs()
                    if not bool((gap <= tol).all()):
                        g = int((gap - tol).argmax())
                        raise ProbeMismatch(
                            f"{name}: |product - float64| "
                            f"{gap.flatten()[g].item():.3e} > bound "
                            f"{tol.flatten()[g].item():.3e}")
                    err = float(gap.max())
                    krun, pay = visit_mxuquad_state_plain(
                        salt, sphT, sph8, G, rows, mode, splits, ITERS,
                        bc=tap)
                    ref = (pay + krun.float()).expand_as(y)
                    m = rows - 1
                    extra = dict(
                        err_share_of_bound=float((gap / tol).max()),
                        winners_as_vpu=int(((krun & m)
                                            == (vpu_krun[rows] & m)).sum()),
                        winners_as_float64_product=int(
                            ((krun & m) == (state[0] & m)).sum()),
                        keys_as_float64_product=int((krun == state[0]).sum()))
                _bit_equal(name, y, ref)
                ops, flops, nbytes = visit_mxuquad_work(
                    n_rays, rows, mode, splits, ITERS, weights["sqrt"],
                    weights["rcp"])
                work, rate = bound_work(ops, flops)
                lib_ms = (_matmul_ms(G, F, n_rays, rows, splits)
                          if mode == "mxuquad" else None)
                e = _entry("M7", name, label(rows, mode, splits, n_rays), ms,
                           runs, (work, nbytes, rate), plain_ms, err, lib_ms,
                           rows=rows, mode=mode, splits=splits, rays=n_rays,
                           input=which, fp32_ops=ops, tc_flops=flops,
                           tc_bound_ms=flops / BF16_FLOPS_PER_S * 1e3,
                           ns_per_ray_visit=ms * 1e6 / (n_rays * ITERS),
                           **extra)
                what = ("bit-equal" if mode == "vpu" else
                        f"product within {extra['err_share_of_bound']:.3f} "
                        f"of its bound, visit bit-equal given it; winners as "
                        f"vpu on {extra['winners_as_vpu']} of {T} rays, as "
                        f"the float64 product on "
                        f"{extra['winners_as_float64_product']}")
                log(f"[probe] {name}: {ms:.4f} ms, "
                    f"{e['ns_per_ray_visit']:.4f} ns a ray-visit, bound "
                    f"{e['bound_ms']:.4f} ({e['share']:.4f}), matmul {lib_ms}; "
                    f"{what}")
                out.append(e)
    return out


def run(device=None, log=print, weights=None) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("run() measures on the card; the CPU takes "
                           "cpu_smoke()")
    card = _smi("name,power.limit")
    log(f"[probe] {card}")
    t0 = time.perf_counter()
    if weights is None:
        weights = measure_mul_equivalents(dev)
    m7 = run_m7(dev, weights, log)
    log(f"[probe] M7 in {time.perf_counter() - t0:.1f} s")
    return dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                peaks=dict(fp32_lane_ops_per_s=FP32_LANE_OPS_PER_S,
                           bf16_flops_per_s=BF16_FLOPS_PER_S,
                           hbm_bytes_per_s=HBM_BYTES_PER_S),
                mul_equivalents=weights, entries=m7)


def cpu_smoke(log=print) -> dict:
    """The plain versions at a small size on the CPU; nothing is timed."""
    salt = torch.tensor([SALT], dtype=F32)
    res = {}
    for which in INPUTS:
        for rows, mode, splits in VARIANTS:
            sphT, sph8, G = (torch.from_numpy(x)
                             for x in mxuquad_inputs(which, rows, splits))
            res[f"M7 {tag(rows, mode, splits)} ({which})"] = visit_mxuquad(
                salt, sphT, sph8, G, T, rows, mode, splits, iters=4)
    for k, v in res.items():
        log(f"[probe=cpu] {k}: {tuple(v.shape)} {v.dtype}, "
            f"finite {bool(torch.isfinite(v).all())}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracers_tpu_torch.probes.microbench_mxuquad",
        description="M7 of tools/microbench_mxuquad.py on the CUDA card; "
                    "writes docs/MICROBENCH_MXUQUAD_H100.json")
    ap.add_argument("--device", default=None,
                    help="'cpu': run the plain versions at a small size "
                         "and time nothing (default: the CUDA card)")
    ap.add_argument("--out", default=str(RECORD),
                    help="where the card's record goes")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        cpu_smoke()
        return 0
    from ..render import _cuda
    rec = run(dev)
    rec["sass"] = sass_counts(_cuda.build_info["microbench_mxuquad"]["path"])[0]
    Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
    print(f"[probe] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
