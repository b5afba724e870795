"""The probe M7 of the port (``probes/microbench_mxuquad.py``) against the TPU
probe of ``tools/microbench_mxuquad.py``.

The TPU kernel (``visit_kernel``) runs here under ``pl.pallas_call(...,
interpret=True)`` at grid 1 and a few iterations, with the whole-array
defaults, loaded from the file without editing it.  Its loop's final carry
is read bit for bit by wrapping ``jax.lax.fori_loop``; its product is read
by wrapping ``jax.lax.dot_general`` and running the loop's body once.

* ``vpu``: krun and pay exactly on the TPU probe's spheres, at 32 and 128
  rows; on the seeded spheres the winning rows agree but on two rays
  (XLA's contractions, ROADMAP queue 3, as M5);
* ``mxuquad``, splits 1 and 3: JAX's summed product within
  ``product_tolerance`` of the float64 product of the bf16-rounded
  operands, which the port builds (F from the fake rays, G from the
  spheres); and the visit after the product, given JAX's product, equal
  to the port's plain visit given it;
* the kernel's design on the CPU: its fragments and shared-memory layout
  (``layout_model``) cover every (ray, sphere row, b | c) once, and its
  partition of the visits folded by key (``visit_mxuquad_parts_model``)
  equals the plain visit bit for bit; the model's constants are the
  kernel's.

The kernels are CUDA and run only on the card: the ``cuda`` cases skip
here (``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_microbench_mxuquad.py -m cuda``; ``chip_smoke.py`` phase
10 runs the TPU probe's five variants at its sizes).
"""
import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracers_tpu_torch.probes import microbench as mb
from raytracers_tpu_torch.probes import microbench_mxuquad as mq
from raytracers_tpu_torch.probes import microbench_v5 as v5

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
T = mq.T
SALT = np.float32(mb.SALT)
ITERS = 4
_JX = {}


def _jx():
    """JAX, Pallas and tools/microbench_mxuquad.py, imported at first use:
    the card's machine has no JAX, and runs only the ``cuda`` cases."""
    if not _JX:
        import jax
        import jax.numpy as jnp
        from jax.experimental import pallas as pl
        spec = importlib.util.spec_from_file_location(
            "tpu_microbench_mxuquad", ROOT / "tools" / "microbench_mxuquad.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _JX.update(jax=jax, jnp=jnp, pl=pl, mod=mod)
    return types.SimpleNamespace(**_JX)


def _salt():
    return torch.tensor([SALT])


class _Lax:
    """jax.lax whose fori_loop returns, as pay (with krun zeroed), krun's
    bits, pay, or 8 rows ``sel`` of the body's summed bf16 product at
    visit 0."""

    def __init__(self, what, sel=None, rows=0, splits=1):
        self.what, self.sel, self.rows, self.splits = what, sel, rows, splits
        self.bc = None

    def __getattr__(self, name):
        return getattr(_jx().jax.lax, name)

    def dot_general(self, lhs, rhs, *a, **kw):
        out = _jx().jax.lax.dot_general(lhs, rhs, *a, **kw)
        if lhs.dtype == _jx().jnp.bfloat16:
            self.bc = out
        return out

    def fori_loop(self, lo, hi, body, init):
        j = _jx()
        krun, pay = j.jax.lax.fori_loop(lo, hi, body, init)
        if self.what == "krun":
            pay = j.jnp.broadcast_to(
                j.jax.lax.bitcast_convert_type(krun, j.jnp.float32), pay.shape)
        elif self.what == "bc":
            body(0, init)
            n = 2 * self.rows
            bc = sum(self.bc[i * n:(i + 1) * n] for i in range(self.splits))
            pay = j.jnp.concatenate([bc[r:r + 1] for r in self.sel])
        return j.jnp.zeros_like(krun), pay


class _Jax:
    def __init__(self, lax):
        self.lax = lax

    def __getattr__(self, name):
        return getattr(_jx().jax, name)


def _run(monkeypatch, lax, inputs, rows, mode, splits, iters=ITERS):
    j = _jx()
    sphT, sph8, G = inputs
    kernel = functools.partial(j.mod.visit_kernel, iters=iters, rows=rows,
                               mode=mode, splits=splits)
    f = j.pl.pallas_call(
        kernel, grid=(1,),
        out_shape=j.jax.ShapeDtypeStruct((1, 8, T), j.jnp.float32),
        interpret=True)
    monkeypatch.setattr(j.mod, "jax", _Jax(lax) if lax else j.jax)
    out = np.asarray(f(j.jnp.array([[SALT]], j.jnp.float32),
                       j.jnp.asarray(sphT[None]), j.jnp.asarray(sph8[None]),
                       j.jnp.asarray(G[None])))[0]
    monkeypatch.setattr(j.mod, "jax", j.jax)
    return out


def _jax_state(monkeypatch, inputs, rows, mode, splits):
    """krun (512,) int32 and pay (8, 512) of JAX's visit."""
    k = _run(monkeypatch, _Lax("krun"), inputs, rows, mode, splits)
    p = _run(monkeypatch, _Lax("pay"), inputs, rows, mode, splits)
    return k[0].view(np.int32), p


def _jax_product(monkeypatch, inputs, rows, splits, sel):
    return _run(monkeypatch, _Lax("bc", sel, rows, splits), inputs, rows,
                "mxuquad", splits)


def _t(inputs):
    return tuple(torch.from_numpy(x) for x in inputs)


# ---------------------------------------------------------------- vpu

@pytest.mark.parametrize("rows", [128, 32])
def test_vpu_plain_vs_jax_tpu_inputs(monkeypatch, rows):
    inputs = mq.mxuquad_inputs("tpu", rows, 1)
    kj, pj = _jax_state(monkeypatch, inputs, rows, "vpu", 1)
    k, p = mq.visit_mxuquad_state_plain(_salt(), *_t(inputs), rows, "vpu", 1,
                                        ITERS)
    assert (k.numpy() == kj).all()
    assert (p.numpy().view(np.int32) == pj.view(np.int32)).all()
    out = mq.visit_mxuquad_plain(_salt(), *_t(inputs), 2 * T, rows, "vpu", 1,
                                 ITERS).numpy()
    assert (out == pj + kj.astype(np.float32)).all()
    plain = _run(monkeypatch, None, inputs, rows, "vpu", 1)
    assert (plain == pj + kj.astype(np.float32)).all()


@pytest.mark.parametrize("rows", [128, 32])
def test_vpu_seeded_vs_jax_winners_agree(monkeypatch, rows):
    """As M5's seeded case: XLA's contractions move some key floors; the
    winning rows and their payloads agree but on two rays."""
    inputs = mq.mxuquad_inputs("seeded", rows, 1)
    kj, pj = _jax_state(monkeypatch, inputs, rows, "vpu", 1)
    k, p = mq.visit_mxuquad_state_plain(_salt(), *_t(inputs), rows, "vpu", 1,
                                        ITERS)
    same = (k.numpy() & (rows - 1)) == (kj & (rows - 1))
    assert same.sum() >= T - 2
    assert (p.numpy()[:, same] == pj[:, same]).all()


# ---------------------------------------------------------------- mxuquad

def _sel(rows):
    return [0, 1, rows // 2, rows - 1, rows, rows + 1, rows + rows // 2,
            2 * rows - 1]


@pytest.mark.parametrize("rows,splits,which", [(32, 1, "seeded"),
                                               (32, 3, "seeded"),
                                               (128, 1, "tpu"),
                                               (128, 3, "seeded"),
                                               (32, 3, "tpu")])
def test_mxuquad_product_vs_jax_within_bound(monkeypatch, rows, splits,
                                             which):
    """JAX's summed product (bf16 operands, float32 sums) lies within the
    stated bound of the float64 product of the port's bf16-rounded F and
    G: the features, G's rows and their split match the TPU kernel's."""
    inputs = mq.mxuquad_inputs(which, rows, splits)
    sel = _sel(rows)
    got = _jax_product(monkeypatch, inputs, rows, splits, sel)
    G = torch.from_numpy(inputs[2])
    F = mq.features(_salt())
    exact = mq.product_plain(G, F, rows, splits)[sel].numpy()
    tol = mq.product_tolerance(G, F, rows, splits)[sel].numpy()
    assert (np.abs(got.astype(np.float64) - exact) <= tol).all()
    assert np.abs(exact).max() > 0


@pytest.mark.parametrize("splits", [1, 3])
def test_mxuquad_visit_given_jax_product_equals_plain(monkeypatch, splits):
    """Given JAX's own product (read 8 rows a call), the port's plain visit
    gives JAX's krun and pay bit for bit on the TPU probe's G."""
    rows = 32
    inputs = mq.mxuquad_inputs("tpu", rows, splits)
    bc = np.concatenate([
        _jax_product(monkeypatch, inputs, rows, splits,
                     list(range(r, r + 8))) for r in range(0, 2 * rows, 8)])
    kj, pj = _jax_state(monkeypatch, inputs, rows, "mxuquad", splits)
    k, p = mq.visit_mxuquad_state_plain(_salt(), *_t(inputs), rows,
                                        "mxuquad", splits, ITERS,
                                        bc=torch.from_numpy(bc))
    assert (k.numpy() == kj).all()
    assert (p.numpy().view(np.int32) == pj.view(np.int32)).all()


def test_product_tolerance_admits_float32_sums_and_rejects_a_wrong_product():
    """A float32 model of the product (exact bf16 products, summed in
    float32 in feature order, then over splits) lies within the bound; a
    product with two features swapped does not."""
    rows, splits = 64, 3
    _, _, G = mq.mxuquad_inputs("seeded", rows, splits)
    G = torch.from_numpy(G)
    F = mq.features(_salt())
    Gb, Fb = mq.bf16(G), mq.bf16(F)
    n = 2 * rows
    total = None
    for i in range(splits):
        acc = torch.zeros(n, T)
        for k in range(mq.N_FEATURES):
            acc = acc + (Gb[i * n:(i + 1) * n, k:k + 1] * Fb[k:k + 1]).float()
        total = acc if total is None else total + acc
    exact = mq.product_plain(G, F, rows, splits)
    tol = mq.product_tolerance(G, F, rows, splits)
    assert bool(((total.double() - exact).abs() <= tol).all())
    wrong = mq.product_plain(G, F[[1, 0] + list(range(2, 16))], rows, splits)
    assert not bool(((wrong - exact).abs() <= tol).all())


# ---------------------------------------------------------------- inputs

def test_g_rows_are_the_quadratic():
    """G's rows dotted with [d o o.d |o|^2 1 0..] give b = (o - c).d and
    c = |o - c|^2 - r^2 (float64); a 3-split sums back to G's float32
    values exactly; the TPU probe's G is 0.05 everywhere."""
    rows = 64
    sphT, _ = v5.visit_v5_inputs("seeded", rows)
    g = mq.g_rows(sphT)
    F = mq.features(_salt()).double().numpy()
    o, d = F[3:6], F[0:3]
    c = sphT[:, :3].astype(np.float64)
    bc = g @ F
    oc = o[None] - c[:, :, None]
    b = (oc * d[None]).sum(1)
    cq = (oc * oc).sum(1) - sphT[:, 7:8]
    assert np.allclose(bc[:rows], b, rtol=0, atol=1e-9 * np.abs(F).max() ** 2)
    # o.d and |o|^2 are float32 features: 2^-24 of |o|^2 ~ 900
    assert np.allclose(bc[rows:], cq, rtol=0, atol=1e-4)
    s3 = mq.bf16_split(g, 3).astype(np.float64)
    n = 2 * rows
    assert (s3[:n] + s3[n:2 * n] + s3[2 * n:] == g.astype(np.float32)).all()
    assert (mq.bf16(torch.from_numpy(mq.bf16_split(g, 3))).numpy()
            == mq.bf16_split(g, 3)).all()
    _, _, G = mq.mxuquad_inputs("tpu", 32, 3)
    assert G.shape == (192, 16) and (G == np.float32(0.05)).all()


def test_variants_are_the_tpu_probes():
    assert [mq.tag(*v) for v in mq.VARIANTS] == [
        "rows128_vpu", "rows128_mxuquad1", "rows128_mxuquad3", "rows32_vpu",
        "rows32_mxuquad3"]


# ---------------------------------------------------------------- wrappers

def test_wrapper_takes_the_plain_version_on_the_cpu():
    before = dict(mb.LAUNCHES)
    s = _salt()
    for rows, mode, splits in mq.VARIANTS:
        inputs = _t(mq.mxuquad_inputs("seeded", rows, splits))
        tap = torch.empty(2 * rows, T) if mode == "mxuquad" else None
        y = mq.visit_mxuquad(s, *inputs, 1024, rows, mode, splits, 2, tap,
                             _parts=2 if mode == "mxuquad" else None)
        assert torch.equal(y, mq.visit_mxuquad_plain(s, *inputs, 1024, rows,
                                                     mode, splits, 2))
        if tap is not None:
            assert torch.equal(tap, mq.product_plain(
                inputs[2], mq.features(s), rows, splits).float())
    assert dict(mb.LAUNCHES) == before


def test_wrapper_rejects_what_the_kernels_do_not_take():
    s = _salt()
    sphT, sph8, G = _t(mq.mxuquad_inputs("tpu", 32, 1))
    bad = [lambda: mq.visit_mxuquad(s, sphT, sph8, G, 1024, 32, "mxu"),
           lambda: mq.visit_mxuquad(s, sphT, sph8, G, 1024, 32, "mxuquad", 3),
           lambda: mq.visit_mxuquad(s, sphT, sph8, G, 1000, 32),
           lambda: mq.visit_mxuquad(s, sphT, sph8, G.double(), 1024, 32),
           lambda: mq.visit_mxuquad(s, sphT, sph8, G, 1024, 32, "vpu", 1, 4,
                                    torch.empty(64, T)),
           lambda: mq.visit_mxuquad(s, sphT, sph8, G, 1024, 32, "mxuquad", 1,
                                    4, torch.empty(32, T)),
           lambda: mq.visit_mxuquad(s, sphT, sph8, G, 1024, 32, "mxuquad", 1,
                                    4, _parts=3),
           lambda: mq.visit_mxuquad(s, sphT, sph8, G, 1024, 32, "mxuquad", 1,
                                    4, _parts=0),
           lambda: mq.visit_mxuquad(s, sphT, sph8, G, 1024, 32, "vpu", 1, 4,
                                    _parts=1)]
    for f in bad:
        with pytest.raises(ValueError):
            f()


def test_work_counts():
    """vpu as M5's mxu; mxuquad 19 + 2 (splits - 1) lane operations and a
    root a (ray, row) test, 2 (2 rows splits) 16 tensor-core flops a
    ray-visit, and the tensor cores bound it only when their flops take
    longer than the FP32 tail."""
    assert mq.visit_mxuquad_work(1024, 32, "vpu", 1, 4, 8.0, 9.0)[:2] == (
        v5.visit_v5_work(1024, 32, "mxu", 4, 8.0, 9.0)[0], 0)
    ops, flops, nbytes = mq.visit_mxuquad_work(1024, 32, "mxuquad", 3, 4,
                                               8.0, 9.0)
    assert ops == (1024 * 4 * (32 * (19 + 4 + 8.0) + 10) + 2 * 4 * 2
                   + 1024 * (40 + 9.0))
    assert flops == 1024 * 4 * 2 * 192 * 16
    assert nbytes == 4 * (192 * 16 + 8 * 32 + 8 * 1024 + 1)
    assert mq.bound_work(ops, flops) == (ops, mb.FP32_LANE_OPS_PER_S)
    assert mq.bound_work(1.0, 1e3) == (1e3, mq.BF16_FLOPS_PER_S)


# ---------------------------------------------------------------- the design

@pytest.mark.parametrize("rows", mq.ROWS)
@pytest.mark.parametrize("splits", mq.SPLITS)
def test_layout_covers_each_pair_once(rows, splits):
    """visit_mma's accumulators hold each (split, ray, sphere row, b | c)
    of a tile in exactly one (warp, lane, chunk, register); A's fragment
    each (ray, feature) once; and each chunk's descriptor reads G^T, bf16,
    with sphere row k's b and c in columns 2k and 2k + 1."""
    G = mq.mxuquad_inputs("seeded", rows, splits)[2]
    lay = mq.layout_model(rows, splits, G)
    assert lay["d"].shape == (splits, mq.TILE, rows, 2)
    assert (lay["d"] == 1).all()
    assert (lay["a"] == 1).all()
    Gb = mq.bf16(torch.from_numpy(G)).numpy()
    n = 2 * rows
    for sp in range(splits):
        assert (lay["b"][sp][:, 0::2] == Gb[sp * n:sp * n + rows].T).all()
        assert (lay["b"][sp][:, 1::2] == Gb[sp * n + rows:(sp + 1) * n].T).all()


@pytest.mark.parametrize("rows,splits,which", [(32, 3, "tpu"),
                                               (128, 1, "tpu"),
                                               (64, 3, "seeded"),
                                               (128, 3, "seeded")])
@pytest.mark.parametrize("iters", [0, 1, 5, 7])
def test_parts_model_equals_plain(rows, splits, which, iters):
    """Visits split into 1-4 contiguous parts, each from the miss key, folded
    by the least key with the payload of its row: krun and pay bit for bit
    the plain visit's, also where the parts do not divide the visits, a
    part has none, or there is no visit (the miss key, pay 0)."""
    ins = _t(mq.mxuquad_inputs(which, rows, splits))
    k, p = mq.visit_mxuquad_state_plain(_salt(), *ins, rows, "mxuquad",
                                        splits, iters)
    for parts in (1, 2, 3, 4):
        km, pm = mq.visit_mxuquad_parts_model(_salt(), ins[1], ins[2], rows,
                                              splits, iters, parts)
        assert torch.equal(km, k)
        assert torch.equal(pm.view(torch.int32), p.view(torch.int32))


def test_partition_rule_and_constants_are_the_kernels():
    """mxuquad_parts: 4 warpgroups a tile at the TPU's 8,192 rays, 2 at
    16,896, 1 from 33,792 (528 warpgroups) on; TILE, MAX_PARTS,
    FILL_WARPGROUPS, CHUNK_COLS and the descriptor's strides as in
    csrc/microbench_mxuquad.cu."""
    assert [mq.mxuquad_parts(n) for n in (512, 8192, 16896, 33280, 33792,
                                          1 << 20)] == [4, 4, 2, 2, 1, 1]
    src = (ROOT / "raytracers_tpu_torch" / "csrc"
           / "microbench_mxuquad.cu").read_text()
    assert f"kTile = {mq.TILE};" in src
    assert f"kMaxParts = {mq.MAX_PARTS};" in src
    assert f"kFillWarpgroups = {mq.FILL_WARPGROUPS};" in src
    assert (f"kN = kSplits == 1 ? {mq.CHUNK_COLS[1]} : {mq.CHUNK_COLS[3]};"
            in src)
    assert "kLbo = 128, kSbo = 256;" in src
    assert "mma.sync" not in src and "HMMA" not in src


# ---------------------------------------------------------------- entry

def test_cpu_entry_point_times_nothing_and_writes_nothing(capsys):
    before = mq.RECORD.stat().st_mtime_ns if mq.RECORD.exists() else None
    assert mq.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[probe=cpu]" in out and " ms" not in out
    assert out.count("M7 ") == 2 * len(mq.VARIANTS)
    after = mq.RECORD.stat().st_mtime_ns if mq.RECORD.exists() else None
    assert after == before


def test_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mq.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mq.run()


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the probes are CUDA kernels")
    return torch.device("cuda")


# (visits, rays): the parts' edges (1 visit for 4 parts, an odd count, the
# full 256), 4 parts a tile at 512 and 8,192 rays, 2 at 16,896, 1 at 34,304
# (536 tiles, a partial second wave of 528 warpgroups)
ITERS_RAYS = ((1, 512), (6, 8192), (37, 34304), (256, 8192), (256, 16896))


def _card_check(cuda, rows, mode, splits, which, iters, n, parts=None):
    s = torch.tensor([SALT], device=cuda)
    inputs = tuple(x.to(cuda) for x in _t(mq.mxuquad_inputs(which, rows,
                                                            splits)))
    tap = (torch.full((2 * rows, T), float("nan"), device=cuda)
           if mode == "mxuquad" else None)
    lab = mq.label(rows, mode, splits, n)
    n0 = mb.LAUNCHES[lab]
    y = mq.visit_mxuquad(s, *inputs, n, rows, mode, splits, iters, tap,
                         _parts=parts)
    assert mb.LAUNCHES[lab] == n0 + 1
    if tap is not None:
        F = mq.features(s)
        gap = (tap.double() - mq.product_plain(inputs[2], F, rows, splits))
        assert bool((gap.abs() <= mq.product_tolerance(inputs[2], F, rows,
                                                       splits)).all())
    ref = mq.visit_mxuquad_plain(s, *inputs, n, rows, mode, splits, iters,
                                 bc=tap)
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("iters,n", ITERS_RAYS)
@pytest.mark.parametrize("which", mq.INPUTS)
@pytest.mark.parametrize("rows,mode,splits", mq.VARIANTS)
def test_card_visit_against_plain(cuda, rows, mode, splits, which, iters, n):
    _card_check(cuda, rows, mode, splits, which, iters, n)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("rows,splits", [(32, 1), (64, 3), (128, 1),
                                         (128, 3)])
def test_card_mxuquad_each_partition(cuda, rows, splits, parts):
    """Every partition the kernel takes, whatever the rule would pick, at
    a visit count that none of them divides."""
    _card_check(cuda, rows, "mxuquad", splits, "seeded", 7, 8192, parts)


@pytest.mark.cuda
def test_card_mxuquad_sass_runs_on_wgmma(cuda):
    """Every mxuquad instantiation (rows 32/64/128, splits 1/3) issues HGMMA
    and no HMMA."""
    from raytracers_tpu_torch.render import _cuda
    _cuda.load("microbench_mxuquad")
    counts, _ = mb.sass_counts(_cuda.build_info["microbench_mxuquad"]["path"])
    mma = {f: c for f, c in counts.items() if "visit_mma" in f}
    assert len(mma) == 6
    for f, c in mma.items():
        assert c.get("HGMMA", 0) > 0 and "HMMA" not in c, (f, c)
