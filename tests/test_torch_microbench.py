"""The probes M1-M4 of the port (``raytracers_tpu_torch/probes``) against the
TPU probes of ``tools/microbench_tpu.py``.

The TPU kernels (``fma_kernel``, ``dot_kernel``, ``reduce_kernel``,
``visit_kernel``) run here under ``pl.pallas_call(..., interpret=True)`` at
grid 1 and a few iterations, with the ``BlockSpec``-free whole-array
defaults, loaded from the file without editing it.  The port's plain
versions are held against them:

* fma within (iters + streams) float32 ulps of the result: XLA's CPU code
  contracts ``a * m + d`` into one rounding, the port rounds twice (an ulp
  a step at most, and one a stream in the sum);
* the dots within float32 accumulation, (K + iters) * 2^-23 * sum|a||b|
  (XLA sums in its own order);
* the reductions exactly;
* the visit's ``krun`` and ``pay`` exactly on the TPU probe's spheres.  On a
  seeded set the key floors differ (ROADMAP queue 3): the TPU probe's
  formulation cancels (disc = q^2 + ll + pc, terms of ~1e3 for a disc of
  ~1e-3), and XLA contracts its multiply-adds.  The winning rows and the
  payloads agree; the port's formula with those contractions emulated
  gives JAX's keys.

The kernels themselves are CUDA and run only on the card: the ``cuda``
cases below skip here and hold each variant against its plain version
there (``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_microbench.py -m cuda``; ``chip_smoke.py`` phase 10 does
the same at the TPU probes' sizes).
"""
import functools
import importlib.util
import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracers_tpu_torch.probes import microbench as mb

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
T, LANE = mb.T, mb.ROWS
SALT = np.float32(mb.SALT)
ULP = 2.0 ** -23
_JX = {}


def _jx():
    """JAX, jax.numpy, Pallas and tools/microbench_tpu.py, imported at first
    use: the card's machine has no JAX, and runs only the ``cuda`` cases."""
    if not _JX:
        import jax
        import jax.numpy as jnp
        from jax.experimental import pallas as pl
        spec = importlib.util.spec_from_file_location(
            "tpu_microbench", ROOT / "tools" / "microbench_tpu.py")
        mbt = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mbt)
        _JX.update(jax=jax, jnp=jnp, pl=pl, mbt=mbt)
    return types.SimpleNamespace(**_JX)


def _salt():
    return torch.tensor([SALT])


def _pallas(kernel, out_shape, dtype, *args):
    j = _jx()
    f = j.pl.pallas_call(kernel, grid=(1,),
                         out_shape=j.jax.ShapeDtypeStruct(out_shape, dtype),
                         interpret=True)
    return np.asarray(f(j.jnp.array([[SALT]], j.jnp.float32), *args))


# ---------------------------------------------------------------- M1

@pytest.mark.parametrize("streams,iters", [(8, 8), (4, 8), (1, 16)])
def test_fma_plain_vs_jax(streams, iters):
    j = _jx()
    o = _pallas(functools.partial(j.mbt.fma_kernel, streams=streams,
                                  iters=iters), (1, LANE, T), j.jnp.float32)
    p = mb.fma_plain(_salt(), LANE * T, streams, iters).numpy()
    p = p.reshape(1, LANE, T)
    tol = (iters + streams) * ULP * np.abs(o.astype(np.float64))
    assert (np.abs(p.astype(np.float64) - o) <= tol).all()


@pytest.mark.parametrize("mode", ["mul_add", "sqrt", "div", "rcp"])
def test_fma_plain_modes_are_ieee_float32(mode):
    """The plain chains equal a numpy float32 replay (IEEE: numpy's float32
    square root, division and products are correctly rounded)."""
    n, streams, iters = 64, 4, 20
    got = mb.fma_plain(_salt(), n, streams, iters, mode).numpy()
    f = np.float32
    base = SALT
    accs = [f(base + f(u)) for u in range(streams)]
    m, d = f(f(base * f(0.5)) + f(0.9999)), f(base + f(1e-7))
    step = {"mul_add": lambda a: f(f(a * m) + d), "sqrt": np.sqrt,
            "div": lambda a: f(m / a), "rcp": lambda a: f(f(1.0) / a)}[mode]
    for _ in range(iters):
        accs = [step(a) for a in accs]
    want = accs[0]
    for a in accs[1:]:
        want = f(want + a)
    assert (got.view(np.int32) == np.full(n, want).view(np.int32)).all()


def test_fma_plain_fused_within_its_bound():
    """The FMA variant's plain version rounds a*m + d in float64 first:
    within an ulp a step of a float32 FMA replay (numpy's float64 product
    of two float32 values is exact)."""
    iters, streams = 64, 8
    got = mb.fma_plain(_salt(), 8, streams, iters, "fma").numpy()
    f = np.float32
    accs = [f(SALT + f(u)) for u in range(streams)]
    m, d = f(f(SALT * f(0.5)) + f(0.9999)), f(SALT + f(1e-7))
    for _ in range(iters):
        accs = [f(np.float64(a) * np.float64(m) + np.float64(d))
                for a in accs]
    want = accs[0]
    for a in accs[1:]:
        want = f(want + a)
    assert np.abs(got - want).max() <= (iters + streams) * ULP * abs(want)


# ---------------------------------------------------------------- M2

@pytest.mark.parametrize("which", ["tpu", "seeded"])
@pytest.mark.parametrize("kind", ["pair", "pairT", "payload"])
def test_dot_plain_vs_jax(kind, which):
    iters = 4
    a, b = mb._dot_inputs(kind, which, "cpu")
    so = mb.DOT_SHAPES[kind][2]
    j = _jx()
    o = _pallas(functools.partial(j.mbt.dot_kernel, iters=iters, kind=kind),
                (1,) + so, j.jnp.float32, j.jnp.asarray(a.numpy()),
                j.jnp.asarray(b.numpy()))
    p = mb.dot_plain(_salt(), a, b, kind, iters, 1).numpy()
    _, mag, _ = mb.dot_reference(_salt(), a, b, kind, iters)
    k = mb.DOT_SHAPES[kind][1][0]
    tol = (k + iters) * ULP * mag.numpy()[None]
    assert (np.abs(p.astype(np.float64) - o) <= tol).all()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit bits), to nearest, ties away from
    zero, as cvt.rna.tf32.f32 does."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("route", ["tf32", "3xtf32"])
@pytest.mark.parametrize("kind", ["pair", "payload"])
def test_dot_tolerance_admits_tf32_and_rejects_a_wrong_product(kind, route):
    """A CPU model of the TF32 routes (operands rounded as cvt.rna does,
    3xTF32's hi/lo split, exact products, float32 sums) lies within
    ``dot_tolerance`` of the float64 sum; a product with b's columns
    shuffled does not."""
    iters = 16
    a, b = mb._dot_inputs(kind, "seeded", "cpu")
    L = mb._dot_lhs(_salt(), a, kind, iters)
    hi_l, hi_b = _tf32(L), _tf32(b)
    if route == "tf32":
        r = (hi_l.double() @ hi_b.double())
    else:
        lo_l, lo_b = _tf32(L - hi_l), _tf32(b - hi_b)
        r = (lo_l.double() @ hi_b.double() + hi_l.double() @ lo_b.double()
             + hi_l.double() @ hi_b.double())
    acc = torch.zeros(r.shape[1:])
    for i in range(iters):
        acc = acc + r[i].float()
    exact, mag, running = mb.dot_reference(_salt(), a, b, kind, iters)
    tol = mb.dot_tolerance(route, kind, mag, running)
    assert bool(((acc.double() - exact).abs() <= tol).all())
    perm = torch.randperm(b.shape[1], generator=torch.Generator().manual_seed(0))
    wrong = mb.dot_plain(_salt(), a, b[:, perm], kind, iters, 1)[0]
    assert not bool(((wrong.double() - exact).abs() <= tol).all())


# ---------------------------------------------------------------- M3

@pytest.mark.parametrize("dtype", ["f32", "int32"])
def test_reduce_plain_vs_jax(dtype):
    iters = 8
    j = _jx()
    jt = j.jnp.int32 if dtype == "int32" else j.jnp.float32
    o = _pallas(functools.partial(j.mbt.reduce_kernel, iters=iters,
                                  dtype=dtype), (1, 1, T), jt)
    v0 = mb._reduce_inputs(dtype, "tpu", "cpu")
    p = mb.reduce_plain(v0, iters, 1).numpy()
    assert p.dtype == o.dtype and (p == o).all()


def test_reduce_plain_on_seeded_keys():
    """The sum of the column minima of v + i, against numpy."""
    for dtype in ("f32", "int32"):
        v0 = mb._reduce_inputs(dtype, "seeded", "cpu")
        got = mb.reduce_plain(v0, 5, 2).numpy()
        v = v0.numpy()
        want = np.zeros(T, v.dtype)
        for i in range(5):
            want = want + (v + v.dtype.type(i)).min(0)
        assert got.shape == (2, 1, T) and (got == want[None, None]).all()


# ---------------------------------------------------------------- M4

class _Lax:
    """jax.lax with fori_loop's final carry re-encoded into what the TPU
    kernel writes: (0, krun's bits as float32) or (0, pay)."""

    def __init__(self, what):
        self.what = what

    def __getattr__(self, name):
        return getattr(_jx().jax.lax, name)

    def fori_loop(self, lo, hi, body, init):
        j = _jx()
        krun, pay = j.jax.lax.fori_loop(lo, hi, body, init)
        if self.what == "krun":
            pay = j.jnp.broadcast_to(
                j.jax.lax.bitcast_convert_type(krun, j.jnp.float32), pay.shape)
        return j.jnp.zeros_like(krun), pay


class _Jax:
    def __init__(self, what):
        self.lax = _Lax(what)

    def __getattr__(self, name):
        return getattr(_jx().jax, name)


def _jax_visit(monkeypatch, sphT, sph8, iters):
    """JAX's visit under interpret mode, unchanged but for its loop's final
    carry, read out exactly: krun (256,) int32 and pay (8, 256)."""
    j = _jx()
    args = ((1, 8, T), j.jnp.float32, j.jnp.asarray(sphT), j.jnp.asarray(sph8))
    kernel = functools.partial(j.mbt.visit_kernel, iters=iters)
    out = {}
    for what in ("krun", "pay"):
        monkeypatch.setattr(j.mbt, "jax", _Jax(what))
        out[what] = _pallas(kernel, *args)[0]
    monkeypatch.setattr(j.mbt, "jax", j.jax)
    plain = _pallas(kernel, *args)[0]
    krun = out["krun"][0].view(np.int32)
    # the unpatched kernel writes exactly pay + float(krun)
    assert (plain == out["pay"] + krun.astype(np.float32)).all()
    return krun, out["pay"]


def _plain_visit(which, iters):
    sphT, sph8 = mb.visit_inputs(which)
    k, p = mb.visit_state_plain(_salt(), torch.from_numpy(sphT),
                                torch.from_numpy(sph8), iters)
    return sphT, sph8, k.numpy(), p.numpy()


def test_visit_plain_vs_jax_tpu_inputs(monkeypatch):
    sphT, sph8, k, p = _plain_visit("tpu", 4)
    kj, pj = _jax_visit(monkeypatch, sphT, sph8, 4)
    assert (k == kj).all()
    assert (p.view(np.int32) == pj.view(np.int32)).all()
    out = mb.visit_plain(_salt(), torch.from_numpy(sphT),
                         torch.from_numpy(sph8), 2 * T, 4).numpy()
    assert out.shape == (2, 8, T) and (out == (pj + kj.astype(np.float32))).all()


def _contracted_keys(sphT, iters):
    """The port's visit keys with XLA's contractions emulated: a*b + c
    rounded once in the ray set-up, the pair dots and q*q + ll."""
    f64 = np.float64
    f = np.float32

    def fma(a, b, c):
        return (f64(a) * f64(b) + f64(c)).astype(f)

    lid = np.arange(T, dtype=f)
    ox, oy = fma(lid, f(1e-3), SALT), lid * f(2e-3)
    oz, dz = np.full(T, f(30)), np.full(T, f(-1))
    dx, dy = fma(lid, f(1e-4), f(0.1)), fma(lid, f(-1e-4), f(0.2))
    a = fma(dz, dz, fma(dy, dy, dx * dx))
    p = fma(oz, dz, fma(oy, dy, ox * dx))
    m2 = fma(oz, oz, fma(oy, oy, ox * ox))
    pc = fma(p, p, -(a * m2))
    a2, p2 = f(2) * a, f(2) * p
    z = np.zeros(T, f)
    gq = [dx, dy, dz, z, z, z, z, z]
    gl = [fma(a2, ox, -(p2 * dx)), fma(a2, oy, -(p2 * dy)),
          fma(a2, oz, -(p2 * dz)), z, z, z, z, -a]
    inv_a = f(1) / a
    krun = np.full(T, 0x7F000000, np.int32)
    rows = np.arange(LANE, dtype=np.int32)[:, None]
    for i in range(iters):
        lhs = sphT + SALT * f(i)
        q, ll = lhs[:, 0:1] * gq[0], lhs[:, 0:1] * gl[0]
        for k in range(1, 8):
            q = fma(lhs[:, k:k + 1], gq[k], q)
            ll = fma(lhs[:, k:k + 1], gl[k], ll)
        disc = fma(q, q, ll) + pc
        pos = disc > 0
        sq = np.sqrt(np.where(pos, disc, f(1)))
        t0, t1 = ((q - p) - sq) * inv_a, ((q - p) + sq) * inv_a
        t = np.where(t0 > f(0.1), t0, t1)
        tv = np.where(pos & (t > f(0.1)), t, f(1e9)).astype(f)
        kmin = ((tv.view(np.int32) & ~0x7F) | rows).min(0)
        krun = np.where(kmin < krun, kmin, krun)
    return krun


def test_visit_seeded_vs_jax_differs_by_contraction(monkeypatch):
    """ROADMAP queue 3: on the seeded spheres the key floors of JAX's visit
    and the port's differ; the winning rows and their payloads agree (but
    on two rays), and the port's formula with XLA's contractions emulated
    gives JAX's keys."""
    iters = 4
    sphT, sph8, k, p = _plain_visit("seeded", iters)
    kj, pj = _jax_visit(monkeypatch, sphT, sph8, iters)
    same_key = k == kj
    same_row = (k & 0x7F) == (kj & 0x7F)
    assert (p[:, same_key] == pj[:, same_key]).all()
    assert (p[:, same_row] == pj[:, same_row]).all()
    assert same_row.sum() >= T - 2 and same_key.sum() < T // 4
    assert (_contracted_keys(sphT, iters) == kj).sum() >= T - 1


def test_visit_inputs():
    """The TPU probe's spheres are all alike and every ray misses them
    (row 0's miss key wins); the seeded ones lie ahead of every ray and
    spread the winners over many rows."""
    miss = np.int32(np.array(1e9, np.float32).view(np.int32) & ~0x7F)
    _, _, k, _ = _plain_visit("tpu", 2)
    assert (k == miss).all()
    _, _, k, _ = _plain_visit("seeded", 2)
    assert (k < miss).all() and len(np.unique(k & 0x7F)) >= 8


# ---------------------------------------------------------------- wrappers

def test_wrappers_take_the_plain_version_on_the_cpu():
    before = dict(mb.LAUNCHES)
    s = _salt()
    assert torch.equal(mb.fma(s, 256, 4, 8, "sqrt"),
                       mb.fma_plain(s, 256, 4, 8, "sqrt"))
    a, b = mb._dot_inputs("pairT", "seeded", "cpu")
    for route in mb.DOT_ROUTES:
        assert torch.equal(mb.dot(s, a, b, "pairT", 3, 2, route),
                           mb.dot_plain(s, a, b, "pairT", 3, 2))
    v = mb._reduce_inputs("int32", "seeded", "cpu")
    assert torch.equal(mb.reduce_min(v, 3, 2, "redux"),
                       mb.reduce_plain(v, 3, 2))
    sphT, sph8 = (torch.from_numpy(x) for x in mb.visit_inputs("seeded"))
    assert torch.equal(mb.visit(s, sphT, sph8, 512, 2, "warp"),
                       mb.visit_plain(s, sphT, sph8, 512, 2))
    assert dict(mb.LAUNCHES) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    s = _salt()
    a, b = mb._dot_inputs("pair", "tpu", "cpu")
    bad = [lambda: mb.fma(s, 64, 3, 4),
           lambda: mb.fma(s, 64, 8, 4, "exp"),
           lambda: mb.fma(s.double(), 64, 8, 4),
           lambda: mb.dot(s, a.t().contiguous(), b, "pair"),
           lambda: mb.dot(s, a, b, "pair", 4, 1, "fp16"),
           lambda: mb.reduce_min(mb._reduce_inputs("f32", "tpu", "cpu"),
                                 4, 1, "redux"),
           lambda: mb.reduce_min(torch.zeros(LANE, T, dtype=torch.int64)),
           lambda: mb.visit(s, torch.zeros(LANE, 8), torch.zeros(8, LANE),
                            300)]
    for f in bad:
        with pytest.raises(ValueError):
            f()


def test_work_counts():
    """The bounds' operation counts follow the shapes: M1 2 lane operations
    a step uncontracted, 1 otherwise; M2's FP32 loop 2MNK + MK a product,
    its TF32 routes 2MNK flops (3x for 3xTF32)."""
    ops, nbytes = mb.fma_work(100, 8, 10, "mul_add")
    assert ops == 100 * (8 * 10 * 2 + 18) and nbytes == 404
    assert mb.fma_work(100, 8, 10, "sqrt")[0] == 100 * (80 + 18)
    ops, _, rate = mb.dot_work("payload", "fp32", 2, 3)
    assert ops == 6 * (8 * 128 + 2 * 8 * 256 * 128)
    assert rate == mb.FP32_LANE_OPS_PER_S
    ops, _, rate = mb.dot_work("pair", "3xtf32", 2, 3)
    assert ops == 6 * 3 * 2 * 128 * 256 * 8 and rate == mb.TF32_FLOPS_PER_S
    assert mb._bound(33.5e9, 0.0) == (pytest.approx(1.0), "operations")


# ---------------------------------------------------------------- entry

def test_cpu_entry_point_times_nothing_and_writes_nothing(capsys):
    before = mb.RECORD.stat().st_mtime_ns if mb.RECORD.exists() else None
    assert mb.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[probe=cpu]" in out and " ms" not in out
    after = mb.RECORD.stat().st_mtime_ns if mb.RECORD.exists() else None
    assert after == before


def test_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.run()


def test_record_and_the_bounds_weights():
    """docs/MICROBENCH_H100.json is the card's record: its name and power
    limit, sampled clocks, every probe variant; chip_smoke.py charges a
    square root and a division at the record's weights (a division as the
    1/x the kernels issue)."""
    import chip_smoke
    rec = json.loads(mb.RECORD.read_text())
    assert rec["card"].startswith("NVIDIA H100") and " W" in rec["card"]
    assert rec["clocks_sm_mhz"]["samples"] > 0
    w = rec["mul_equivalents"]
    assert chip_smoke.SQRT_OPS == pytest.approx(w["sqrt"], rel=0.01)
    assert chip_smoke.DIV_OPS == pytest.approx(w["rcp"], rel=0.01)
    labels = {e["label"] for e in rec["entries"]}
    assert len(labels) == (len(mb.FMA_MODES) * len(mb.FMA_CASES)
                           + len(mb.DOT_KINDS) * len(mb.DOT_ROUTES) + 5
                           + len(mb.VISIT_WAYS) * len(mb.VISIT_RAYS))
    for e in rec["entries"]:
        assert e["ms"] > 0 and e["bound_ms"] > 0 and math.isfinite(e["share"])
        assert e["bound_by"] in ("operations", "bytes")
    assert chip_smoke.OPS_PER_SLOT == pytest.approx(29 + chip_smoke.SQRT_OPS)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the probes are CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [1, 4, 8])
@pytest.mark.parametrize("mode", mb.FMA_MODES)
def test_card_fma_equals_plain(cuda, mode, streams):
    s = torch.tensor([SALT], device=cuda)
    n0 = mb.LAUNCHES[mb.fma_label(mode, streams)]
    y = mb.fma(s, 3000, streams, 24, mode)
    assert mb.LAUNCHES[mb.fma_label(mode, streams)] == n0 + 1
    ref = mb.fma_plain(s, 3000, streams, 24, mode)
    if mode == "fma":
        tol = (24 + streams) * ULP * float(ref.abs().max())
        assert float((y - ref).abs().max()) <= tol
    else:
        assert torch.equal(y.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("route", mb.DOT_ROUTES)
@pytest.mark.parametrize("kind", mb.DOT_KINDS)
def test_card_dot_equals_plain(cuda, kind, route):
    s = torch.tensor([SALT], device=cuda)
    a, b = mb._dot_inputs(kind, "seeded", cuda)
    y = mb.dot(s, a, b, kind, 8, 3, route)
    if route == "fp32":
        ref = mb.dot_plain(s, a, b, kind, 8, 3)
        assert torch.equal(y.view(torch.int32), ref.view(torch.int32))
    else:
        exact, mag, running = mb.dot_reference(s, a, b, kind, 8)
        tol = mb.dot_tolerance(route, kind, mag, running)
        assert bool(((y.double() - exact).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,way", [("f32", "serial"), ("f32", "shuffle"),
                                       ("int32", "serial"),
                                       ("int32", "shuffle"),
                                       ("int32", "redux")])
def test_card_reduce_equals_plain(cuda, dtype, way):
    v = mb._reduce_inputs(dtype, "seeded", cuda)
    assert torch.equal(mb.reduce_min(v, 9, 3, way), mb.reduce_plain(v, 9, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("which", mb.VISIT_INPUTS)
@pytest.mark.parametrize("way", mb.VISIT_WAYS)
def test_card_visit_equals_plain(cuda, way, which):
    s = torch.tensor([SALT], device=cuda)
    sphT, sph8 = (torch.from_numpy(x).to(cuda) for x in mb.visit_inputs(which))
    y = mb.visit(s, sphT, sph8, 4 * T, 5, way)
    ref = mb.visit_plain(s, sphT, sph8, 4 * T, 5)
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))
