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
from hypothesis import given, settings
from hypothesis import strategies as st

from raytracers_tpu_torch.probes import microbench as mb

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
T, LANE = mb.T, mb.ROWS
SALT = np.float32(mb.SALT)
ULP = 2.0 ** -23
_JX = {}
# iteration counts that cross the edges of the M2 kernels' schedules
# (csrc/microbench.cu): the TF32 payload kernel's wgmma batch (kBatch, 8),
# the TF32 rows kernel's stage (kGroup, 16), the FP32 payload kernel's
# chunk (kChunk, 128)
DOT_EDGE_ITERS = (0, 1) + tuple(e + d for e in (8, 16, 128)
                                for d in (-1, 0, 1))


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


@pytest.mark.parametrize("fp32,other,cycles,share", [
    (16, 3, 1, 16 / 19),     # mul_add x1 at unroll 8: FMUL + FADD a step
    (64, 3, 1, 64 / 67),     # fma x8 at unroll 8
    (8, 3, 1, 8 / 11),       # fma x1 at unroll 8
    (8, 3, 2, 8 / 19),       # the same, each FFMA two issue cycles
    (32, 3, 1, 32 / 35)])    # fma x1 at unroll 32
def test_fma_issue_share(fp32, other, cycles, share):
    """The issue model of M1's step loop: FP32 instructions over the issue
    cycles of a pass, one warp instruction a cycle a scheduler."""
    assert mb.fma_issue_share(fp32, other, cycles) == pytest.approx(share)


def _sass_listing():
    """A ``cuobjdump -sass`` listing of one kernel in the form of CUDA 12's:
    a remainder loop of one FFMA, then a main loop of four, each closed by
    a backward branch to an address."""
    rows = [(0x00, "LDC R1, c[0x0][0x28]"),
            (0x10, "LDG.E R2, desc[UR4][R2.64]"),
            (0x20, "FFMA R5, R5, R2, R3"),
            (0x30, "IADD3 R4, R4, -0x1, RZ"),
            (0x40, "ISETP.NE.AND P0, PT, R4, RZ, PT"),
            (0x50, "@P0 BRA 0x20"),
            (0x60, "FFMA R5, R5, c[0x3][0x0], R3"),
            (0x70, "FFMA R5, R5, c[0x3][0x0], R3"),
            (0x80, "FFMA R5, R5, c[0x3][0x0], R3.reuse"),
            (0x90, "FFMA R5, R5, c[0x3][0x0], R3"),
            (0xa0, "IADD3 R6, R6, 0x4, RZ"),
            (0xb0, "ISETP.NE.AND P0, PT, R6, RZ, PT"),
            (0xc0, "@P0 BRA 0x60"),
            (0xd0, "STG.E desc[UR4][R8.64], R5"),
            (0xe0, "EXIT"),
            (0xf0, "BRA 0xf0")]
    out = ["\tcode for sm_90a",
           "\t\tFunction : _ZN4_GLOBAL9fma_probeILi1ELi1EEEvPKfPfii",
           '\t.headerflags\t@"EF_CUDA_SM90"']
    for addr, ins in rows:
        pred, _, rest = ins.partition(" ") if ins.startswith("@") else (
            "", "", ins)
        out.append(f"        /*{addr:04x}*/   {pred:>15} {rest} ;"
                   f"        /* 0x000fe20000000f00 */")
        out.append(" " * 60 + "/* 0x000fca0000000000 */")
    return "\n".join(out) + "\n"


def test_m1_loop_pass_reads_the_main_loop():
    """The SASS reader of ``m1_turns``: the loop a backward branch closes
    with the most FP32 instructions; its FP32 forms with their registers
    and .reuse flags, and the issue model's shares of the pass."""
    from raytracers_tpu_torch.probes import m1_turns as tm
    fns = tm.sass_functions(_sass_listing())
    (fn, lines), = fns.items()
    assert "fma_probeILi1ELi1E" in fn
    p = tm.loop_pass(lines)
    assert (p["instructions"], p["fp32"], p["other"]) == (7, 4, 3)
    assert p["fp32_forms"] == {"FFMA R5, R5, c[0x3][0x0], R3": 3,
                               "FFMA R5, R5, c[0x3][0x0], R3.reuse": 1}
    assert p["reuse"] == 1 and p["opcodes"]["BRA"] == 1
    assert p["share_one_cycle"] == pytest.approx(4 / 7)
    assert p["share_two_cycles"] == pytest.approx(4 / 11)
    assert tm.loop_pass(lines[:3]) is None


def test_m1_turns_side_builds_rewrite_one_line_each(tmp_path, monkeypatch):
    """Each side build of ``m1_turns`` rewrites lines of
    ``csrc/microbench.cu`` that occur there exactly once, and the rewritten
    source reads back as the side's spec: the step loop unrolled 8, 16, 32
    and 64 times; m from a register and from the constant bank at unroll 8
    and at the change's; 128, 256 and 512 threads a block; the MUFU steps
    unrolled 8 and 32 times."""
    from raytracers_tpu_torch.probes import m1_turns as tm
    from raytracers_tpu_torch.probes import turns
    from raytracers_tpu_torch.render import _cuda
    monkeypatch.setattr(turns, "OUT_DIR", tmp_path)
    text = _cuda.source("microbench").read_text()
    ch = tm.change_spec()
    specs = tm.side_specs()
    seen = [ch, *specs.values()]
    assert {s["unroll"] for s in seen} >= set(tm.SWEEP_UNROLL)
    assert {s["block"] for s in seen} >= set(tm.SWEEP_BLOCK)
    assert {s["mufu_unroll"] for s in seen} >= set(tm.SWEEP_MUFU_UNROLL)
    for u in (8, ch["unroll"]):
        assert {s["const_m"] for s in seen if s["unroll"] == u
                and s["block"] == ch["block"]
                and s["mufu_unroll"] == ch["mufu_unroll"]} == set(tm.SCOPES)
    assert ch not in specs.values()
    for name, spec in specs.items():
        edits = tm.side_edits(spec)
        assert edits
        for old, _ in edits:
            assert text.count(old) == 1, old
            assert len([ln for ln in text.splitlines() if old in ln]) == 1
        path = turns.rewrite("microbench", name, edits)
        assert tm.change_spec(path.read_text()) == spec


def test_m1_turns_rerecord(tmp_path, monkeypatch):
    """--record puts the change's last turn in place of the record's M1
    entries, before M2, and keeps the record's weights, this run's beside
    them."""
    from raytracers_tpu_torch.probes import m1_turns as tm
    rec = json.loads(mb.RECORD.read_text())
    m1 = [e for e in rec["entries"] if e["probe"] == "M1"]
    turns = [dict(build=b, entries=[dict(e, ms=e["ms"] * (1 + i))
                                    for e in m1])
             for i, b in enumerate(tm.ORDER)]
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(rec))
    monkeypatch.setattr(mb, "sass_counts", lambda so: ({"k": {}}, ""))
    tm.rerecord(path, dict(turns=turns, card="c", torch="t", cuda="u",
                           script="s"), Path("x.so"), log=lambda *a: None)
    out = json.loads(path.read_text())
    last = max(i for i, b in enumerate(tm.ORDER) if b == "change")
    new = [e for e in out["entries"] if e["probe"] == "M1"]
    assert [e["ms"] for e in new] == [e["ms"] * (1 + last) for e in m1]
    assert [e["probe"] for e in out["entries"]] == [e["probe"]
                                                    for e in rec["entries"]]
    assert out["mul_equivalents"] == rec["mul_equivalents"]
    assert out["m1_run"]["mul_equivalents"] == mb.mul_equivalents(new)
    assert out["m1_run"]["fchk_lanes_per_cycle"] == (
        mb.fchk_lanes_per_cycle(new))
    assert out["sass"] == {"k": {}} and out["m1_run"]["card"] == "c"


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


def _toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, truncated toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _tensor_core_model(a, b, kind, route, iters):
    """The TF32 routes' schedule with the tensor cores' rounding modelled:
    operands rounded as cvt.rna does, each k8 step's exact products added
    to the float32 sum and truncated toward zero (lo.hi, hi.lo, hi.hi for
    3xTF32).  pair, pairT: one sum over every iteration; payload: r_i from
    zero, then acc + r_i in float32."""
    L = mb._dot_lhs(_salt(), a, kind, iters)
    lh, bh = _tf32(L), _tf32(b)
    terms = ([(lh, bh)] if route == "tf32" else
             [(_tf32(L - lh), bh), (lh, _tf32(b - bh)), (lh, bh)])
    run = torch.zeros(L.shape[1], b.shape[1])
    acc = torch.zeros_like(run)
    for i in range(iters):
        d = torch.zeros_like(run) if kind == "payload" else run
        for k0 in range(0, b.shape[0], 8):
            for x, y in terms:
                d = _toward_zero(d.double() + x[i, :, k0:k0 + 8].double()
                                 @ y[k0:k0 + 8].double())
        if kind == "payload":
            acc = acc + d
        else:
            run = d
    return acc if kind == "payload" else run


@pytest.mark.parametrize("route", ["tf32", "3xtf32"])
@pytest.mark.parametrize("kind", ["pair", "payload"])
def test_dot_tolerance_admits_truncating_tensor_core_steps(kind, route):
    """The kernels' sum trees with every k8 step truncated: within
    ``dot_tolerance``; payload's bound, derived for r_i summed from zero,
    lies below the one charged when every step adds into the running sum."""
    iters = 16
    a, b = mb._dot_inputs(kind, "seeded", "cpu")
    got = _tensor_core_model(a, b, kind, route, iters)
    exact, mag, running = mb.dot_reference(_salt(), a, b, kind, iters)
    tol = mb.dot_tolerance(route, kind, mag, running)
    assert bool(((got.double() - exact).abs() <= tol).all())
    if kind == "payload":
        split = 3 if route == "3xtf32" else 1
        every_step = (mb.DOT_EPS[route] * mag + 2.0 ** -22
                      * (split * mag + 16 * split * running))
        assert bool((tol < every_step).all())


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


# k of the card's sweep (probes/m3m6_turns.py): the kernels keep 8 lanes a
# column for the shuffle way and 32 for the redux way (mb.REDUCE_LANES)
SWEEP_LANES = (2, 4, 8, 16, 32)


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """The int32 image of float32 keys on which a REDUX route for float
    keys takes its minimum: b ^ ((b >> 31) & 0x7fffffff) on the bits b, so
    that integer order is float order for every non-NaN key (-0 below +0);
    it is its own inverse.  The card measured that route at every k and
    the shuffle way beat it (docs/M3M6_SWEEP_H100.json), so the kernels
    take REDUX on int32 keys only; the model keeps the claim checked."""
    b = v.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _from_order_key(k: torch.Tensor) -> torch.Tensor:
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _lanes_model(v0, iters, lanes, way):
    """The k-lane route of csrc/microbench.cu on the CPU: lane ``sub`` of a
    column's ``lanes`` holds rows ``rows[sub::lanes]``, takes their minimum
    as a tree (w[e] = min(w[e], w[e + h]), h halving; a tie keeps the left
    operand, so a -0/+0 tie may yield either zero), then the group's
    minimum by a butterfly (the same tie rule) or, for ``redux``, the
    minimum of the keys (of the order keys for float keys); acc adds it,
    keys get + 1."""
    v = v0.numpy().copy()
    one = v.dtype.type(1)
    acc = np.zeros(T, v.dtype)

    def tmin(a, b):
        return np.where(b < a, b, a)
    for _ in range(iters):
        parts = []
        for sub in range(lanes):
            w = [v[r] for r in range(sub, LANE, lanes)]
            h = len(w) // 2
            while h >= 1:
                w = [tmin(w[e], w[e + h]) for e in range(h)] + w[2 * h:]
                h //= 2
            parts.append(w[0])
        if way == "redux":
            keys = np.stack(parts)
            if keys.dtype == np.float32:
                keys = _order_key(torch.from_numpy(keys)).numpy()
            m = keys.min(0)
            if v.dtype == np.float32:
                m = _from_order_key(torch.from_numpy(m)).numpy()
        else:
            o = lanes // 2
            while o >= 1:
                parts = [tmin(parts[t], parts[t ^ o]) for t in range(lanes)]
                o //= 2
            m = parts[0]
        acc = acc + m
        v = v + one
    return acc


_SPECIAL = [0.0, -0.0, -1.0, 1.0, -2.0, 2.5, -3.5e-39, 3.5e-39, -1e30,
            1e30, float("inf"), -float("inf")]


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False), min_size=1,
                max_size=64),
       st.sampled_from(["float32", "int32"]),
       st.sampled_from(SWEEP_LANES), st.sampled_from(["shuffle", "redux"]),
       st.integers(0, 2 ** 32 - 1))
def test_lanes_model_equals_reduce_plain(pool, dtype, lanes, way, seed):
    """A tree minimum of 128/k keys in any grouping, across k lanes by a
    butterfly or by the order keys' minimum, summed as acc, equals
    reduce_plain bit for bit: keys drawn from a few values, with -0/+0,
    ties and infinities among them, so columns meet ties of both zeros;
    the rows dealt to the lanes in a random order."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        vals = np.array([int(x) % 2001 - 1000 if math.isfinite(x) else 7
                         for x in pool], np.int32)
    else:
        vals = np.array(pool + _SPECIAL, np.float32)
    keys = rng.choice(vals, (LANE, T))
    v0 = torch.from_numpy(keys[rng.permutation(LANE)])
    got = _lanes_model(v0, 3, lanes, way)
    want = mb.reduce_plain(torch.from_numpy(keys), 3, 1).numpy()[0, 0]
    assert (got.view(np.int32) == want.view(np.int32)).all()


@settings(max_examples=200, deadline=None)
@given(st.floats(width=32, allow_nan=False),
       st.floats(width=32, allow_nan=False))
def test_order_key_orders_and_round_trips(a, b):
    """_order_key: integer order is float order for every non-NaN float32
    (-0 below +0), and _from_order_key inverts it bit for bit."""
    x = torch.tensor([a, b], dtype=torch.float32)
    k = _order_key(x)
    assert torch.equal(_from_order_key(k).view(torch.int32),
                       x.view(torch.int32))
    fa, fb = float(x[0]), float(x[1])
    if fa < fb:
        assert int(k[0]) < int(k[1])
    elif fa > fb:
        assert int(k[0]) > int(k[1])
    elif math.copysign(1, fa) == math.copysign(1, fb):
        assert int(k[0]) == int(k[1])
    else:
        assert (int(k[0]) < int(k[1])) == (math.copysign(1, fa) < 0)


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
    for dtype, way in mb.reduce_routes():
        v = mb._reduce_inputs(dtype, "seeded", "cpu")
        assert torch.equal(mb.reduce_min(v, 3, 2, way),
                           mb.reduce_plain(v, 3, 2))
    sphT, sph8 = (torch.from_numpy(x) for x in mb.visit_inputs("seeded"))
    assert torch.equal(mb.visit(s, sphT, sph8, 512, 2, "lanes"),
                       mb.visit_plain(s, sphT, sph8, 512, 2))
    assert dict(mb.LAUNCHES) == before


def test_visit_ways_and_their_codes(monkeypatch):
    """The C entry's code of an M4 way is its lanes a ray: 1 for the thread
    way, the build's k (``VISIT_LANES``) for the lanes way; another way
    (the parent's ``warp`` among them) is refused before any launch."""
    assert mb.VISIT_WAYS == ("thread", "lanes")
    seen = []
    monkeypatch.setattr(mb, "_on_card", lambda *ts: True)
    monkeypatch.setattr(mb, "_launch", lambda label, out, *args, **kw:
                        seen.append((label, args[1])))
    s = _salt()
    sphT, sph8 = (torch.from_numpy(x) for x in mb.visit_inputs("tpu"))
    mb.visit(s, sphT, sph8, 512, 2, "thread")
    mb.visit(s, sphT, sph8, 512, 2, "lanes")
    assert seen == [("M4 thread 512", 1), ("M4 lanes 512", mb.VISIT_LANES)]
    for way in ("warp", "lanes8", ""):
        with pytest.raises(ValueError):
            mb.visit(s, sphT, sph8, 512, 2, way)
    assert len(seen) == 2


def test_reduce_routes_and_their_codes(monkeypatch):
    """Five routes, one label each (REDUX takes int32 keys only); the C
    entry's variant is the way (0 serial, 1 shuffle, 2 redux) and its arg
    the dtype (0 f32, 1 int32), as the parent's kernels take them."""
    routes = mb.reduce_routes()
    assert routes == [("f32", "serial"), ("f32", "shuffle"),
                      ("int32", "serial"), ("int32", "shuffle"),
                      ("int32", "redux")]
    assert len({mb.reduce_label(*r) for r in routes}) == len(routes)
    assert mb.reduce_label("f32", "shuffle") == "M3 f32 shuffle"
    assert mb.REDUCE_LANES == {"serial": 1, "shuffle": 8, "redux": 32}
    seen = []
    monkeypatch.setattr(mb, "_on_card", lambda *ts: True)
    monkeypatch.setattr(mb, "_launch",
                        lambda label, out, *args, **kw: seen.append(
                            (label,) + args[:3]))
    for dtype, way in routes:
        mb.reduce_min(mb._reduce_inputs(dtype, "tpu", "cpu"), 4, 1, way)
    codes = {label: (way, arg) for label, _, way, arg in seen}
    assert codes == {"M3 f32 serial": (0, 0), "M3 f32 shuffle": (1, 0),
                     "M3 int32 serial": (0, 1), "M3 int32 shuffle": (1, 1),
                     "M3 int32 redux": (2, 1)}


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
           lambda: mb.reduce_min(mb._reduce_inputs("int32", "tpu", "cpu"),
                                 4, 1, "butterfly"),
           lambda: mb.reduce_min(mb._reduce_inputs("int32", "tpu", "cpu"),
                                 -1, 1, "shuffle"),
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


def test_recounted_bounds_by_row():
    """The recounted bounds: each row of the CUDA C++ Programming Guide's
    throughput table (compute capability 9.0) on 132 SMs at 1980 MHz; the
    slowest row bounds.  M3: float32 keys by their 127 minima a column at
    64 a cycle, int32 by their 129 integer adds at 64; M1: a root or 1/x
    one MUFU at 16 a cycle a step, a division two (FCHK timed at MUFU's
    rate), the uncontracted loop two FP32 instructions at 128."""
    sm_s = 132 * 1.98e9
    nbytes = 4 * (LANE * T + 16 * T)
    ms, by, row = mb.pipe_bound(mb.reduce_pipes(512, 16, "f32"), nbytes)
    assert (by, row) == ("operations", "minmax")
    assert ms == pytest.approx(16 * 512 * 127 * T / (64 * sm_s) * 1e3)
    assert ms == pytest.approx(0.01592, abs=1e-5)
    ms, by, row = mb.pipe_bound(mb.reduce_pipes(512, 16, "int32"), nbytes)
    assert row == "int_add"
    assert ms == pytest.approx(16 * 512 * 129 * T / (64 * sm_s) * 1e3)
    steps = mb.FMA_N * 8 * 256
    for mode, mufu in (("sqrt", 1), ("rcp", 1), ("div", 2)):
        ms, by, row = mb.pipe_bound(mb.fma_pipes(mb.FMA_N, 8, 256, mode),
                                    4 * (mb.FMA_N + 1))
        assert (by, row) == ("operations", "mufu")
        assert ms == pytest.approx(mufu * steps / (16 * sm_s) * 1e3)
    ms, _, row = mb.pipe_bound(mb.fma_pipes(mb.FMA_N, 8, 256, "mul_add"), 0)
    assert row == "fp32" and ms == pytest.approx(
        (2 * steps + mb.FMA_N * 18) / (128 * sm_s) * 1e3)
    # at 1980 MHz fp32's row is the data sheet's lane-operation rate
    assert 128 * sm_s == pytest.approx(mb.FP32_LANE_OPS_PER_S, rel=2e-3)
    # bytes bound where HBM is the slowest row
    assert mb.pipe_bound({"fp32": 1}, 3.35e9) == (
        pytest.approx(1.0), "bytes", "hbm_bytes")


@pytest.mark.parametrize("k,slot", [(1, 2), (4, 2), (8, 4), (16, 8),
                                    (32, 16)])
def test_visit_load_model(k, slot):
    """L1 wavefronts for 32 of M4's (ray, row) tests at k lanes a ray: the
    slot-major row's two 16-byte loads fall in an even and an odd bank
    group, k distinct rows a load, so 2 ceil(k / 4); the field-major copy
    takes one wavefront a field, 8 at any k."""
    assert mb.visit_load_model(k, "slot", mb.VISIT_FIELDS) == slot
    assert mb.visit_load_model(k, "field", mb.VISIT_FIELDS) == 8
    with pytest.raises(ValueError):
        mb.visit_load_model(k, "tiled", mb.VISIT_FIELDS)


def test_visit_pipes_bound_by_row():
    """M4's bound by row at 1M rays: every lane operation on fp32 (57.35
    ms with a root and 1/a at M1's weights), and the fewest L1 wavefronts
    any route's loads need, 2 for 32 tests (slot-major at k = 1 or 4), at
    1 a cycle an SM: 8.22 ms, so the operations bind whatever the route.  A
    route's own wavefronts are a diagnostic beside the bound: 65.73 ms for
    the parent's warp a ray (k = 32, 16 for 32 tests), a quarter of that at
    k = 8."""
    w = json.loads(mb.RECORD.read_text())["mul_equivalents"]
    n = 1 << 20
    ops, nbytes = mb.visit_work(n, 256, w["sqrt"], w["rcp"])
    assert mb.visit_least_wavefronts(mb.VISIT_FIELDS) == 2
    pipes = mb.visit_pipes(n, 256, w["sqrt"], w["rcp"])
    assert pipes["fp32"] == ops
    assert pipes["l1_wavefronts"] == n * 256 * 128 / 32 * 2
    terms = mb.pipe_terms(pipes, nbytes)
    assert terms["fp32"] == pytest.approx(57.35, abs=0.1)
    assert terms["l1_wavefronts"] == pytest.approx(65.73 / 8, abs=0.01)
    assert mb.pipe_bound(pipes, nbytes)[1:] == ("operations", "fp32")
    tests = mb.visit_tests(n, 256)
    warp = mb.visit_route_ms(tests, 32, "slot", mb.VISIT_FIELDS)
    assert warp == pytest.approx(65.73, abs=0.01)
    assert mb.visit_route_ms(tests, 8, "slot", mb.VISIT_FIELDS) == (
        pytest.approx(warp / 4))
    assert mb.visit_route_ms(tests, 32, "field", mb.VISIT_FIELDS) == (
        pytest.approx(warp / 2))
    e = mb._entry("M4", "x", "x", 76.572, 3, (ops, nbytes,
                                             mb.FP32_LANE_OPS_PER_S),
                  1.0, 0.0, pipes=pipes)
    assert e["pipe_ms"] == terms
    assert e["share"] == pytest.approx(terms["fp32"] / 76.572)


def test_entry_keeps_the_old_bound_beside_the_recount():
    e = mb._entry("M3", "x", "x", 0.05, 3,
                  (*mb.reduce_work(512, 16), mb.FP32_LANE_OPS_PER_S), 1.0,
                  0.0, pipes=mb.reduce_pipes(512, 16, "f32"))
    assert e["old_bound_ms"] == pytest.approx(0.016026, abs=1e-6)
    assert e["old_share"] == pytest.approx(e["old_bound_ms"] / 0.05)
    assert e["bound_row"] == "minmax" and e["bound_by"] == "operations"
    assert e["share"] == pytest.approx(e["bound_ms"] / 0.05)
    plain = mb._entry("M2", "x", "x", 0.05, 3, (1.0, 0.0, 1.0), 1.0, 0.0)
    assert "old_bound_ms" not in plain


def test_fchk_rate_from_the_record():
    """FCHK's rate, from the record's 8-stream division and 1/x chains:
    one MUFU's rate (16 lanes a cycle an SM) within 5%, which is why the
    division's bound counts it on mufu's row."""
    rec = json.loads(mb.RECORD.read_text())
    m1 = [e for e in rec["entries"] if e["probe"] == "M1"]
    assert mb.fchk_lanes_per_cycle(m1) == pytest.approx(16.0, rel=0.05)


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
                           + len(mb.DOT_KINDS) * len(mb.DOT_ROUTES)
                           + len(mb.reduce_routes())
                           + len(mb.VISIT_WAYS) * len(mb.VISIT_RAYS))
    for e in rec["entries"]:
        assert e["ms"] > 0 and e["bound_ms"] > 0 and math.isfinite(e["share"])
        assert e["bound_by"] in ("operations", "bytes")
    assert chip_smoke.OPS_PER_SLOT == pytest.approx(29 + chip_smoke.SQRT_OPS)


def test_turns_rows_and_rerecord(tmp_path, monkeypatch):
    """The M3/M6 turns probe's bookkeeping on the CPU: a row an entry name
    with each build's medians, the parent's only where it has the route;
    --record puts the change's last M3 turn in place of the record's M3,
    recounts the M1 bounds and keeps M1's times and weights."""
    from raytracers_tpu_torch.probes import m3m6_turns as tm

    def e(name, ms, **kw):
        return dict(probe="M3", name=name, label=name, ms=ms, bound_ms=0.016,
                    bound_by="operations", bound_row="minmax",
                    old_bound_ms=0.016, ms_seeded=ms, **kw)
    turns = []
    for i, b in enumerate(tm.ORDER):
        es = [e("M3 f32 shuffle", 0.05 + i * 1e-4)]
        if b == "change":
            es.append(e("M3 f32 k-lane", 0.03, device_ms=0.027))
        turns.append(dict(build=b, entries=es))
    rows = {r["name"]: r for r in tm.rows_of(turns, log=lambda *a: None)}
    k32, k4 = rows["M3 f32 shuffle"], rows["M3 f32 k-lane"]
    assert len(k32["ms"]["parent"]) == len(k32["ms"]["change"]) == 4
    assert k32["parent_over_change"] == pytest.approx(
        k32["median_ms"]["parent"] / k32["median_ms"]["change"])
    assert "parent" not in k4["ms"] and k4["parent_over_change"] is None
    assert k4["median_device_ms"] == {"change": 0.027}
    rec = json.loads(mb.RECORD.read_text())
    for x in rec["entries"]:          # M1 as the record held it before
        if x["probe"] == "M1" and "bound_row" in x:
            x.update(bound_ms=x.pop("old_bound_ms"),
                     bound_by=x.pop("old_bound_by"), share=x.pop("old_share"))
            del x["pipes"], x["bound_row"]
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(rec))
    monkeypatch.setattr(mb, "sass_counts", lambda so: ({"k": {}}, ""))
    tm.rerecord(path, dict(turns=turns, card="c", torch="t", cuda="u",
                           script="s", fchk_lanes_per_cycle=16.0), "M3",
                Path("x.so"), log=lambda *a: None)
    out = json.loads(path.read_text())
    m3 = [x for x in out["entries"] if x["probe"] == "M3"]
    assert [x["name"] for x in m3] == ["M3 f32 shuffle", "M3 f32 k-lane"]
    assert [x["probe"] for x in out["entries"]] == sorted(
        (x["probe"] for x in out["entries"]), key=lambda p: int(p[1:]))
    old_m1 = [x for x in rec["entries"] if x["probe"] == "M1"]
    new_m1 = [x for x in out["entries"] if x["probe"] == "M1"]
    for a, b in zip(old_m1, new_m1):
        assert b["ms"] == a["ms"] and b["old_bound_ms"] == a["bound_ms"]
        assert b["bound_row"] == ("fp32" if a["mode"] in ("mul_add", "fma")
                                  else "mufu")
    assert out["mul_equivalents"] == rec["mul_equivalents"]
    assert out["fchk_lanes_per_cycle"] == 16.0 and out["sass"] == {"k": {}}
    assert [tm.recount_m1(b) for b in new_m1] == new_m1     # once only


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
@pytest.mark.parametrize("streams", [1, 8])
@pytest.mark.parametrize("mode", mb.FMA_MODES)
def test_card_fma_crosses_the_unroll(cuda, mode, streams):
    """Step counts on both sides of the step loop's unroll (a pass and
    the remainder, ``m1_turns.change_spec``: the FP32 steps' and the MUFU
    steps') and of a block, every variant against its plain version as
    above."""
    from raytracers_tpu_torch.probes import m1_turns as tm
    spec = tm.change_spec()
    s = torch.tensor([SALT], device=cuda)
    n = 2 * spec["block"] + 5
    unroll = spec["unroll" if mode in ("mul_add", "fma") else "mufu_unroll"]
    for iters in (0, 1, unroll - 1, unroll, 2 * unroll + 3):
        y = mb.fma(s, n, streams, iters, mode)
        ref = mb.fma_plain(s, n, streams, iters, mode)
        if mode == "fma":
            tol = (iters + streams) * ULP * float(ref.abs().max())
            assert float((y - ref).abs().max()) <= tol, iters
        else:
            assert torch.equal(y.view(torch.int32), ref.view(torch.int32)), (
                iters)


@pytest.mark.cuda
def test_card_fma_loop_sass(cuda):
    """The FP32 chains' main loop as the source builds it (``m1_turns``):
    kFmaUnroll steps a pass, FMUL + FADD a step uncontracted and one FFMA
    otherwise; where FFMA reads m from the constant bank (kFmaConstM) each
    FFMA of the loop reads two registers, m from a uniform register that
    ULDC filled from the bank."""
    from raytracers_tpu_torch.probes import m1_turns as tm
    from raytracers_tpu_torch.render import _cuda
    _cuda.load("microbench")
    spec = tm.change_spec()
    loops = tm.loop_sass(_cuda.build_info["microbench"]["path"])
    for (mode, streams), label in zip(tm.LOOP_KERNELS, loops):
        p = loops[label]
        per_step = 2 if mode == "mul_add" else 1
        assert p["fp32"] == spec["unroll"] * streams * per_step, (label, p)
        if mode == "fma" and (spec["const_m"] == "all" or (
                spec["const_m"] == "x1" and streams == 1)):
            for f in p["fp32_forms"]:
                srcs = f.split(" ", 1)[1].split(", ")[1:]
                assert sum(x.startswith("R") for x in srcs) == 2, (label, f)
                assert any(x.startswith(("UR", "c[")) for x in srcs), (
                    label, f)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("iters", DOT_EDGE_ITERS)
@pytest.mark.parametrize("route", mb.DOT_ROUTES)
@pytest.mark.parametrize("kind", mb.DOT_KINDS)
def test_card_dot_equals_plain(cuda, kind, route, iters, grid):
    """Each route at the kernels' batch and chunk edges: the FP32 loop
    bit-equal to dot_plain, the TF32 routes within dot_tolerance, every
    tile of the grid alike."""
    s = torch.tensor([SALT], device=cuda)
    a, b = mb._dot_inputs(kind, "seeded", cuda)
    n0 = mb.LAUNCHES[mb.dot_label(kind, route)]
    y = mb.dot(s, a, b, kind, iters, grid, route)
    assert mb.LAUNCHES[mb.dot_label(kind, route)] == n0 + 1
    assert y.shape == (grid,) + mb.DOT_SHAPES[kind][2]
    if route == "fp32":
        ref = mb.dot_plain(s, a, b, kind, iters, grid)
        assert torch.equal(y.view(torch.int32), ref.view(torch.int32))
    else:
        exact, mag, running = mb.dot_reference(s, a, b, kind, iters)
        tol = mb.dot_tolerance(route, kind, mag, running)
        assert bool(((y.double() - exact).abs() <= tol).all())
        assert bool((y == y[:1]).all())


@pytest.mark.cuda
def test_card_dot_sass_runs_tf32_on_wgmma(cuda):
    """The TF32 and 3xTF32 kernels issue HGMMA; no M2 kernel holds an FFMA
    (the FP32 loop is uncontracted)."""
    from raytracers_tpu_torch.render import _cuda
    _cuda.load("microbench")
    counts, _ = mb.sass_counts(_cuda.build_info["microbench"]["path"])
    dots = {f: c for f, c in counts.items() if "dot_" in f}
    tf32 = [f for f in dots if "dot_tf32" in f]
    assert len(dots) == 9 and len(tf32) == 6
    assert all(dots[f].get("HGMMA", 0) > 0 for f in tf32)
    assert not [f for f, c in dots.items() if "FFMA" in c]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["tpu", "seeded"])
@pytest.mark.parametrize("iters", [0, 1, 4, 9])
@pytest.mark.parametrize("dtype,way", mb.reduce_routes())
def test_card_reduce_equals_plain(cuda, dtype, way, iters, which):
    """Every route bit-equal to reduce_plain; 9 iterations cross the
    in-flight batch of 4 and its remainder, 1 is the remainder alone."""
    v = mb._reduce_inputs(dtype, which, cuda)
    label = mb.reduce_label(dtype, way)
    n0 = mb.LAUNCHES[label]
    y = mb.reduce_min(v, iters, 3, way)
    assert mb.LAUNCHES[label] == n0 + 1
    assert torch.equal(y, mb.reduce_plain(v, iters, 3))


@pytest.mark.cuda
def test_card_reduce_keeps_ties_of_zeros_and_infinities(cuda):
    """Float keys of -0, +0, infinities and ties in every column: every
    route bit-equal to reduce_plain (a -0/+0 tie cannot change acc)."""
    rng = np.random.default_rng(3)
    vals = np.array(_SPECIAL, np.float32)
    v = torch.from_numpy(rng.choice(vals, (LANE, T))).to(cuda)
    for dtype, way in mb.reduce_routes():
        if dtype == "f32":
            assert torch.equal(mb.reduce_min(v, 6, 2, way).view(
                torch.int32), mb.reduce_plain(v, 6, 2).view(torch.int32))


def _minima(c: dict, is_f32: bool) -> int:
    """Two-operand minima in a kernel's SASS counts: FMNMX for float keys;
    for int32 keys VIMNMX, IMNMX and VIADDMNMX (an add fused with a
    minimum), and VIMNMX3 (three inputs) as two."""
    if is_f32:
        return c.get("FMNMX", 0)
    return (c.get("VIMNMX", 0) + c.get("IMNMX", 0) + c.get("VIADDMNMX", 0)
            + 2 * c.get("VIMNMX3", 0))


@pytest.mark.cuda
def test_card_reduce_serial_sass_keeps_the_minima_in_the_loop(cuda):
    """The serial loop issues 127 minima an iteration for either key type:
    127 compare-and-selects for float keys, and for int32 keys 63
    three-input VIMNMX3 and one VIMNMX."""
    from raytracers_tpu_torch.render import _cuda
    _cuda.load("microbench")
    counts, _ = mb.sass_counts(_cuda.build_info["microbench"]["path"])
    serial = {f: c for f, c in counts.items() if "reduce_serial" in f}
    assert len(serial) == 2
    for f, c in serial.items():
        is_f32 = "reduce_serialIf" in f
        mins = c.get("FSETP", 0) if is_f32 else _minima(c, False)
        assert mins >= 127, (f, c)


@pytest.mark.cuda
def test_card_reduce_sass_keeps_the_minima_in_the_loop(cuda):
    """The k-lane kernels (the shuffle way at k = 8 for both key types,
    the redux way at k = 32 for int32 keys): every iteration's minima are
    issued (at least 5 (128/k - 1) two-operand minima, a VIMNMX3 counting
    two and a VIADDMNMX one; 4 in-flight iterations and the remainder's: no
    minimum is taken once and shifted by the increments), float minima as
    FMNMX (no compare and select), log2(k) shuffles an iteration on the
    shuffle way and one REDUX on the redux way; the keys stay in registers
    (no local memory)."""
    from raytracers_tpu_torch.render import _cuda
    _cuda.load("microbench")
    counts, _ = mb.sass_counts(_cuda.build_info["microbench"]["path"])
    lanes = {f: c for f, c in counts.items() if "reduce_lanes" in f}
    assert sorted((f.split("reduce_lanesI")[1][0],
                   int(f.split("Li")[1].split("E")[0]),
                   f.split("ELb")[1][0]) for f in lanes) == [
        ("f", 8, "0"), ("i", 8, "0"), ("i", 32, "1")]
    for f, c in lanes.items():
        is_f32 = "reduce_lanesIfLi" in f
        k = int(f.split("Li")[1].split("E")[0])
        redux = f.split("ELb")[1][0] == "1"
        assert _minima(c, is_f32) >= 5 * (128 // k - 1), (f, c)
        if is_f32:
            assert not c.get("FSETP") and not c.get("FSEL"), (f, c)
        if redux:
            assert c.get("REDUX", 0) >= 5 and not c.get("SHFL"), (f, c)
        else:
            rounds = int(math.log2(k))
            assert c.get("SHFL", 0) >= 5 * rounds, (f, c)
            assert c["SHFL"] % rounds == 0, (f, c)
        assert "LDL" not in c and "STL" not in c, (f, c)


@pytest.mark.cuda
@pytest.mark.parametrize("which", mb.VISIT_INPUTS)
@pytest.mark.parametrize("way", mb.VISIT_WAYS)
def test_card_visit_equals_plain(cuda, way, which):
    s = torch.tensor([SALT], device=cuda)
    sphT, sph8 = (torch.from_numpy(x).to(cuda) for x in mb.visit_inputs(which))
    y = mb.visit(s, sphT, sph8, 4 * T, 5, way)
    ref = mb.visit_plain(s, sphT, sph8, 4 * T, 5)
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 16, 32])
def test_card_visit_refuses_a_k_not_built(cuda, k):
    """The lanes way runs at the build's k only: another k, given to the C
    entry as its way code (``m4m5_turns.launch_m4``), is refused, and the
    launch raises without being counted."""
    from raytracers_tpu_torch.probes import m4m5_turns as tm
    s = torch.tensor([SALT], device=cuda)
    sphT, sph8 = (torch.from_numpy(x).to(cuda) for x in mb.visit_inputs("tpu"))
    if k == mb.VISIT_LANES:
        pytest.skip("the build's own k")
    n0 = mb.LAUNCHES[mb.visit_label("lanes", T)]
    with pytest.raises(RuntimeError, match="launch failed"):
        tm.launch_m4("lanes", k, s, sphT, sph8, T, 2)
    assert mb.LAUNCHES[mb.visit_label("lanes", T)] == n0


@pytest.mark.cuda
def test_card_visit_sass(cuda):
    """M4's two visit kernels (k = 1 and the build's k): no local memory;
    every FFMA one of the two refinement steps of a sqrtf's or 1/a's MUFU
    (-fmad=false contracts nothing else); the lanes way folds its key by
    log2 k shuffles (or one REDUX at k = 32) and the thread way by none."""
    from raytracers_tpu_torch.render import _cuda
    _cuda.load("microbench")
    counts, _ = mb.sass_counts(_cuda.build_info["microbench"]["path"])
    visits = {f: c for f, c in counts.items() if "visit_lanes" in f}
    assert len(visits) == 2, visits
    for f, c in visits.items():
        k = int(f.split("visit_lanesILi")[1].split("E")[0])
        assert "LDL" not in c and "STL" not in c, (f, c)
        assert c.get("MUFU", 0) >= 1 and c.get("FFMA", 0) == 2 * c["MUFU"], (
            f, c)
        if k == 1:
            assert not c.get("SHFL") and not c.get("REDUX"), (f, c)
        elif k == 32:
            assert c.get("REDUX", 0) >= 1, (f, c)
        else:
            assert c.get("SHFL", 0) >= int(math.log2(k)), (f, c)
