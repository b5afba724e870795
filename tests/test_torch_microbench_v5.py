"""The probes M5 and M6 of the port (``probes/microbench_v5.py``) against the
TPU probes of ``tools/microbench_v5.py``.

The TPU kernels (``visit_kernel``, ``gather_kernel``) run here under
``pl.pallas_call(..., interpret=True)`` at grid 1 and a few iterations,
with the whole-array defaults, loaded from the file without editing it.
The visit writes (pay + float(krun)) + float(cidx), which loses krun's low
bits, so its loop's final carry is read bit for bit by wrapping
``jax.lax.fori_loop`` (the kernel's text untouched).  The port's plain
versions are held against them:

* the visit's krun, pay and cidx exactly on the TPU probe's spheres, for
  all 3 widths x 2 payloads;
* on the seeded spheres the winning rows and their payloads (or winning
  visits) agree; the key floors differ on some rays, and the port's formula
  with XLA's CPU contractions emulated gives JAX's keys (ROADMAP queue 3);
* the gather exactly, for 1 and 4 chunks, on both tables.

The kernels are CUDA and run only on the card: the ``cuda`` cases skip
here and hold each variant against its plain version there
(``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_microbench_v5.py -m cuda``; ``chip_smoke.py`` phase 10
does the same at the TPU probe's sizes).
"""
import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracers_tpu_torch.probes import microbench as mb
from raytracers_tpu_torch.probes import microbench_v5 as v5

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
T = v5.T
SALT = np.float32(mb.SALT)
ITERS = 4
_JX = {}


def _jx():
    """JAX, jax.numpy, Pallas and tools/microbench_v5.py, imported at first
    use: the card's machine has no JAX, and runs only the ``cuda`` cases."""
    if not _JX:
        import jax
        import jax.numpy as jnp
        from jax.experimental import pallas as pl
        spec = importlib.util.spec_from_file_location(
            "tpu_microbench_v5", ROOT / "tools" / "microbench_v5.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _JX.update(jax=jax, jnp=jnp, pl=pl, mod=mod)
    return types.SimpleNamespace(**_JX)


def _salt():
    return torch.tensor([SALT])


def _pallas(kernel, out_shape, *args):
    j = _jx()
    f = j.pl.pallas_call(
        kernel, grid=(1,),
        out_shape=j.jax.ShapeDtypeStruct(out_shape, j.jnp.float32),
        interpret=True)
    return np.asarray(f(j.jnp.array([[SALT]], j.jnp.float32), *args))


# ---------------------------------------------------------------- M5

class _Lax:
    """jax.lax with fori_loop's final carry (krun, pay, cidx) re-encoded so
    that the kernel writes one of them exactly: krun's bits as float32,
    pay, or float(cidx), with krun and cidx zeroed."""

    def __init__(self, what):
        self.what = what

    def __getattr__(self, name):
        return getattr(_jx().jax.lax, name)

    def fori_loop(self, lo, hi, body, init):
        j = _jx()
        krun, pay, cidx = j.jax.lax.fori_loop(lo, hi, body, init)
        if self.what == "krun":
            pay = j.jnp.broadcast_to(
                j.jax.lax.bitcast_convert_type(krun, j.jnp.float32), pay.shape)
        elif self.what == "cidx":
            pay = j.jnp.broadcast_to(cidx.astype(j.jnp.float32), pay.shape)
        return j.jnp.zeros_like(krun), pay, j.jnp.zeros_like(cidx)


class _Jax:
    def __init__(self, what):
        self.lax = _Lax(what)

    def __getattr__(self, name):
        return getattr(_jx().jax, name)


def _jax_visit(monkeypatch, sphT, sph8, rows, payload, iters=ITERS,
               grazing=0):
    """JAX's visit under interpret mode, its final carry read out exactly:
    krun (512,) int32, pay (8, 512), cidx (512,) int32."""
    j = _jx()
    args = ((1, 8, T), j.jnp.asarray(sphT[None]), j.jnp.asarray(sph8[None]))
    kernel = functools.partial(j.mod.visit_kernel, iters=iters, rows=rows,
                               payload=payload)
    out = {}
    for what in ("krun", "pay", "cidx"):
        monkeypatch.setattr(j.mod, "jax", _Jax(what))
        out[what] = _pallas(kernel, *args)[0]
    monkeypatch.setattr(j.mod, "jax", j.jax)
    plain = _pallas(kernel, *args)[0]
    krun = out["krun"][0].view(np.int32)
    cidx = out["cidx"][0].astype(np.int32)
    # the unpatched kernel writes (pay + float(krun)) + float(cidx); on the
    # seeded spheres XLA compiles it with other contractions, which can
    # flip a grazing ray or two
    want = (out["pay"] + krun.astype(np.float32)) + cidx.astype(np.float32)
    assert (plain != want).any(0).sum() <= grazing
    return krun, out["pay"], cidx


def _plain_visit(which, rows, payload, iters=ITERS):
    sphT, sph8 = v5.visit_v5_inputs(which, rows)
    k, p, c = v5.visit_v5_state_plain(_salt(), torch.from_numpy(sphT),
                                      torch.from_numpy(sph8), rows, payload,
                                      iters)
    return sphT, sph8, k.numpy(), p.numpy(), c.numpy()


@pytest.mark.parametrize("payload", v5.PAYLOADS)
@pytest.mark.parametrize("rows", v5.ROWS)
def test_visit_plain_vs_jax_tpu_inputs(monkeypatch, rows, payload):
    sphT, sph8, k, p, c = _plain_visit("tpu", rows, payload)
    kj, pj, cj = _jax_visit(monkeypatch, sphT, sph8, rows, payload)
    assert (k == kj).all() and (c == cj).all()
    assert (p.view(np.int32) == pj.view(np.int32)).all()
    out = v5.visit_v5_plain(_salt(), torch.from_numpy(sphT),
                            torch.from_numpy(sph8), 2 * T, rows, payload,
                            ITERS).numpy()
    want = (pj + kj.astype(np.float32)) + cj.astype(np.float32)
    assert out.shape == (2, 8, T) and (out == want).all()


@pytest.mark.parametrize("payload", v5.PAYLOADS)
@pytest.mark.parametrize("rows", v5.ROWS)
def test_visit_seeded_vs_jax_winners_agree(monkeypatch, rows, payload):
    """ROADMAP queue 3: on the seeded spheres XLA's CPU code contracts the
    quadratic's multiply-adds and the key floors of some rays move (b^2 -
    a c cancels); the winning rows agree on all but two rays and, where
    they agree, so do the payloads."""
    sphT, sph8, k, p, c = _plain_visit("seeded", rows, payload)
    kj, pj, cj = _jax_visit(monkeypatch, sphT, sph8, rows, payload,
                            grazing=2)
    m = rows - 1
    same_row = (k & m) == (kj & m)
    assert same_row.sum() >= T - 2
    assert (p[:, same_row].view(np.int32)
            == pj[:, same_row].view(np.int32)).all()
    assert (k == kj).sum() >= T // 3


_NO_FMA = """
import importlib.util, json, sys
import numpy as np
spec = importlib.util.spec_from_file_location("t", sys.argv[1])
t = importlib.util.module_from_spec(spec)
spec.loader.exec_module(t)
class MP:
    def setattr(self, o, n, v):
        setattr(o, n, v)
res = {}
for rows in t.v5.ROWS:
    for payload in t.v5.PAYLOADS:
        sphT, sph8, k, p, c = t._plain_visit("seeded", rows, payload)
        kj, pj, cj = t._jax_visit(MP(), sphT, sph8, rows, payload)
        res[f"{rows} {payload}"] = [int((k == kj).sum()), int((c == cj).sum()),
                                    int((p.view(np.int32) == pj.view(np.int32)).all(0).sum())]
print(json.dumps(res))
"""


def test_visit_seeded_vs_jax_without_fma_is_exact():
    """The gap above is XLA's contraction and nothing else: with XLA's CPU
    code held to SSE4.2, which has no fused multiply-add, JAX's visit gives
    the port's krun, pay and cidx bit for bit on the seeded spheres, for
    every width and payload."""
    import json
    import os
    import subprocess
    import sys
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _NO_FMA, __file__], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {f"{r} {p}": [T, T, T] for r in v5.ROWS
                   for p in v5.PAYLOADS}


def test_visit_inputs():
    """The TPU probe's spheres are all alike and every ray misses them (row
    0's miss key wins at the first visit); the seeded ones lie on the rays'
    paths and spread the winners over many rows at every width."""
    for rows in v5.ROWS:
        miss = np.int32(np.array(1e9, np.float32).view(np.int32) & ~(rows - 1))
        _, _, k, _, c = _plain_visit("tpu", rows, "mxu", 2)
        assert (k == miss).all() and (c == 0).all()
        sphT, _, k, _, _ = _plain_visit("seeded", rows, "mxu", 2)
        assert (k < miss).sum() >= T // 2 and len(np.unique(k & (rows - 1))) >= 8
        assert sphT.shape == (rows, 8) and (sphT[:, 7] > 0).all()
        assert (sphT[:, 7] <= 0.1 ** 2 + 1e-7).all()      # r^2, not |c|^2 - r^2


# ---------------------------------------------------------------- M6

@pytest.mark.parametrize("which", v5.INPUTS)
@pytest.mark.parametrize("chunks", v5.CHUNKS)
def test_gather_plain_vs_jax(chunks, which):
    iters = 6
    j = _jx()
    tbl = v5.gather_inputs(which, chunks)
    o = _pallas(functools.partial(j.mod.gather_kernel, iters=iters,
                                  chunks=chunks), (1, 1, T),
                j.jnp.asarray(tbl))
    p = v5.gather_plain(_salt(), torch.from_numpy(tbl), 2 * T, chunks,
                        iters).numpy()
    assert p.shape == (2, 1, T)
    assert (p.view(np.int32) == o.view(np.int32)).all()


def test_gather_plain_is_the_field_order_sum():
    """acc += ((((0 + f0) + f1) + ...) + f7) at slot (lane * 37 + i) mod W,
    against a numpy float32 replay."""
    chunks, iters = 4, 9
    tbl = v5.gather_inputs("seeded", chunks)
    got = v5.gather_plain(_salt(), torch.from_numpy(tbl), T, chunks,
                          iters).numpy()[0, 0]
    acc = np.zeros(T, np.float32)
    lid = np.arange(T)
    for i in range(iters):
        f = tbl[:, (lid * 37 + i) % (chunks * 128)]
        s = np.zeros(T, np.float32)
        for fld in range(8):
            s = s + f[fld]
        acc = acc + s
    assert (got.view(np.int32) == acc.view(np.int32)).all()
    assert len(np.unique(tbl)) == tbl.size


# ---------------------------------------------------------------- wrappers

def _m5_inputs(which, rows, dev="cpu"):
    return tuple(torch.from_numpy(x).to(dev)
                 for x in v5.visit_v5_inputs(which, rows))


def test_wrappers_take_the_plain_version_on_the_cpu():
    before = dict(mb.LAUNCHES)
    s = _salt()
    for way in v5.VISIT_WAYS:
        sphT, sph8 = _m5_inputs("seeded", 64)
        assert torch.equal(v5.visit_v5(s, sphT, sph8, 1024, 64, "defer", way,
                                       iters=3),
                           v5.visit_v5_plain(s, sphT, sph8, 1024, 64, "defer",
                                             3))
    for way in v5.GATHER_WAYS:
        tbl = torch.from_numpy(v5.gather_inputs("seeded", 1))
        assert torch.equal(v5.gather(s, tbl, 1024, 1, way, iters=3),
                           v5.gather_plain(s, tbl, 1024, 1, 3))
    assert dict(mb.LAUNCHES) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    s = _salt()
    sphT, sph8 = _m5_inputs("tpu", 32)
    tbl = torch.ones(8, 512)
    bad = [lambda: v5.visit_v5(s, sphT, sph8, 1024, 64),
           lambda: v5.visit_v5(s, sphT, sph8, 1000, 32),
           lambda: v5.visit_v5(s, sphT, sph8, 1024, 32, "onehot"),
           lambda: v5.visit_v5(s, sphT, sph8, 1024, 32, "mxu", "block"),
           lambda: v5.visit_v5(s.double(), sphT, sph8, 1024, 32),
           lambda: v5.visit_v5(s, torch.ones(16, 8), torch.ones(8, 16), 1024,
                               16),
           lambda: v5.gather(s, tbl, 1024, 1),
           lambda: v5.gather(s, tbl, 1024, 4, "tex"),
           lambda: v5.gather(s, tbl, 256, 4),
           lambda: v5.gather(s, tbl.t(), 1024, 4)]
    for f in bad:
        with pytest.raises(ValueError):
            f()


def test_wrappers_reject_mixed_devices():
    s = _salt()
    sphT, sph8 = _m5_inputs("tpu", 32)
    with pytest.raises(ValueError):
        v5.visit_v5(s.to("meta"), sphT, sph8, 1024, 32)


def test_work_counts():
    """M5: 32 lane operations and a root per (ray, row), 10 (mxu) or 3
    (defer) per ray-visit, the table shift per tile-visit, the set-up and
    output per ray; M6: 12 a lane-step; bytes of inputs and outputs."""
    ops, nbytes = v5.visit_v5_work(1024, 32, "mxu", 4, 8.0, 9.0)
    assert ops == 1024 * 4 * (32 * 40 + 10) + 2 * 4 * 33 + 1024 * 39
    assert nbytes == 4 * (2 * 32 * 8 + 8 * 1024 + 1)
    ops_d, _ = v5.visit_v5_work(1024, 32, "defer", 4, 8.0, 9.0)
    assert ops - ops_d == 1024 * 4 * 7
    assert v5.gather_work(1024, 4, 64) == (1024 * 64 * 12,
                                           4 * (8 * 512 + 1024 + 1))


def test_width_ratios():
    m5 = [dict(input="tpu", payload="mxu", way="thread", rays=512, rows=r,
               ms=float(r)) for r in v5.ROWS]
    assert v5.width_ratios(m5) == {"tpu mxu thread 512": {"32": 0.25,
                                                          "64": 0.5}}


# ---------------------------------------------------------------- entry

def test_cpu_entry_point_times_nothing_and_writes_nothing(capsys):
    before = v5.RECORD.stat().st_mtime_ns if v5.RECORD.exists() else None
    assert v5.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[probe=cpu]" in out and " ms" not in out
    after = v5.RECORD.stat().st_mtime_ns if v5.RECORD.exists() else None
    assert after == before


def test_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        v5.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        v5.run()


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the probes are CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", v5.INPUTS)
@pytest.mark.parametrize("way", v5.VISIT_WAYS)
@pytest.mark.parametrize("payload", v5.PAYLOADS)
@pytest.mark.parametrize("rows", v5.ROWS)
def test_card_visit_equals_plain(cuda, rows, payload, way, which):
    s = torch.tensor([SALT], device=cuda)
    sphT, sph8 = _m5_inputs(which, rows, cuda)
    label = v5.visit_label(rows, payload, way, 4 * T)
    n0 = mb.LAUNCHES[label]
    y = v5.visit_v5(s, sphT, sph8, 4 * T, rows, payload, way, iters=7)
    assert mb.LAUNCHES[label] == n0 + 1
    ref = v5.visit_v5_plain(s, sphT, sph8, 4 * T, rows, payload, 7)
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("which", v5.INPUTS)
@pytest.mark.parametrize("way", v5.GATHER_WAYS)
@pytest.mark.parametrize("chunks", v5.CHUNKS)
def test_card_gather_equals_plain(cuda, chunks, way, which):
    s = torch.tensor([SALT], device=cuda)
    tbl = torch.from_numpy(v5.gather_inputs(which, chunks)).to(cuda)
    y = v5.gather(s, tbl, 3 * T, chunks, way, iters=11)
    ref = v5.gather_plain(s, tbl, 3 * T, chunks, 11)
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))
