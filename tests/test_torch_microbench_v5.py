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


def test_gather_ways_and_their_codes(monkeypatch):
    """Each way's code of the C entry (its index, as the parent's) and the
    layout its kernel reads: __ldg the slot-major (W, 8) copy, made in the
    call; shared memory the (8, W) table as it is."""
    assert v5.GATHER_WAYS == ("ldg", "smem")
    seen = []
    monkeypatch.setattr(v5, "_on_card", lambda *ts: True)
    monkeypatch.setattr(v5, "_launch", lambda label, out, *args, **kw:
                        seen.append((label, args[1], args[7])))
    s = _salt()
    tbl = torch.from_numpy(v5.gather_inputs("seeded", 4))
    for way in v5.GATHER_WAYS:
        v5.gather(s, tbl, 1024, 4, way, 3)
    (l0, c0, t0), (l1, c1, t1) = seen
    assert (l0, c0, l1, c1) == ("M6 paygather_c4 ldg 1024", 0,
                                "M6 paygather_c4 smem 1024", 1)
    assert torch.equal(t0, tbl.T.contiguous()) and t1 is tbl


@pytest.mark.parametrize("chunks", v5.CHUNKS)
def test_slot_major_copy(chunks):
    """The ldg way's table: the (W, 8) copy, equal to tbl.T.contiguous(),
    slot s's 8 fields in row s as 32 contiguous bytes, K1's layout."""
    tbl = torch.from_numpy(v5.gather_inputs("seeded", chunks))
    sm = v5.slot_major(tbl)
    assert sm.is_contiguous() and sm.shape == (chunks * 128, 8)
    assert torch.equal(sm, tbl.T.contiguous())
    flat = sm.reshape(-1)
    for slot in (0, 37, chunks * 128 - 1):
        assert torch.equal(flat[8 * slot:8 * slot + 8], tbl[:, slot])


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
           lambda: v5.gather(s, tbl, 1024, 4, "ldg_fields"),
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


def test_recounted_gather_bound():
    """M6's recounted bound: 32 bytes a lane-step through L1 or shared
    memory at 128 bytes a cycle an SM, 132 SMs, 1980 MHz; at 1M lanes and
    64 steps 2^31 bytes, 0.0642 ms, far above its HBM bytes."""
    nbytes = v5.gather_work(1 << 20, 4, 64)[1]
    ms, by, row = mb.pipe_bound(v5.gather_pipes(1 << 20, 64), nbytes)
    assert (by, row) == ("bytes", "l1_bytes")
    assert ms == pytest.approx(2.0 ** 31 / (128 * 132 * 1.98e9) * 1e3)
    assert ms == pytest.approx(0.0642, abs=1e-4)
    assert nbytes / 3.35e12 * 1e3 < ms / 10


def test_turns_side_builds_rewrite_one_line_each(tmp_path, monkeypatch):
    """Each side build of the M3/M6 turns probe rewrites lines that occur
    once in this tree's sources, so a source edit cannot leave a side
    build equal to the change unnoticed; a line that is not there once is
    refused."""
    from raytracers_tpu_torch.probes import m3m6_turns as tm
    from raytracers_tpu_torch.probes import turns
    monkeypatch.setattr(turns, "OUT_DIR", tmp_path)
    paths = tm.side_sources()
    assert set(paths) == set(tm.SIDES)
    for name, (kernel, edits) in tm.SIDES.items():
        text = paths[name][kernel].read_text()
        for old, new in edits:
            assert new in text and (old == new or old not in text), name
    assert "kSlotStride = 1;" in paths["stride1_alt"]["microbench_v5"] \
        .read_text()
    with pytest.raises(ValueError):
        turns.rewrite("microbench_v5", "x", [("__ldg(", "ldg(")])
    with pytest.raises(ValueError):
        turns.rewrite("microbench_v5", "x", [("no such line", "")])


@pytest.mark.parametrize("stride,waves,waves_alt,lines", [
    (1, 8, 4, 8.75), (2, 16, 8, 16.5), (4, 32, 16, 32.0), (37, 8, 4, 25.75)])
def test_ldg_load_model(stride, waves, waves_alt, lines):
    """The ldg way's loads at W = 128: lanes in one of L1's 8 16-byte bank
    groups at different addresses take a wavefront each; with every lower
    half first (the kernel, K1's order) a load meets 4 groups, alternated
    by lane bit 2 all 8; 4 wavefronts a load are the bytes bound."""
    from raytracers_tpu_torch.probes import m3m6_turns as tm
    k1, alt = tm.load_model(stride, 128, False), tm.load_model(stride, 128,
                                                               True)
    assert (k1["wavefronts"], alt["wavefronts"]) == (waves, waves_alt)
    assert k1["lines"] == alt["lines"] == lines
    bound = mb.pipe_bound(v5.gather_pipes(1 << 20, 64), 0)[0]
    assert alt["wavefront_ms"] == pytest.approx(bound * waves_alt / 4)
    assert tm.load_model(37, 512, False)["lines"] == 32.0


@pytest.mark.parametrize("chunks", v5.CHUNKS)
def test_strided_plain_at_the_probe_stride_is_gather_plain(chunks):
    from raytracers_tpu_torch.probes import m3m6_turns as tm
    s = _salt()
    tbl = torch.from_numpy(v5.gather_inputs("seeded", chunks))
    assert torch.equal(tm.strided_plain(tbl, 1024, chunks, v5.SLOT_STRIDE)
                       .view(torch.int32),
                       v5.gather_plain(s, tbl, 1024, chunks).view(torch.int32))
    assert not torch.equal(tm.strided_plain(tbl, 1024, chunks, 1),
                           v5.gather_plain(s, tbl, 1024, chunks))


@pytest.mark.parametrize("rows", v5.ROWS)
def test_visit_v5_load_model(rows):
    """L1 wavefronts for 32 of M5's (ray, row) tests at k lanes a ray:
    row_bc's 16 bytes at byte 0 (an even bank group) and r^2 at byte 28
    (an odd one), k distinct rows a load: 2, 2, 4, 8, 16 at k = 1, 4, 8,
    16, 32 at every width; the field-major copy, a load for each of cx,
    cy, cz and r^2, 4 at any k."""
    got = [mb.visit_load_model(k, "slot", v5.VISIT_FIELDS, rows)
           for k in (1, 4, 8, 16, 32)]
    assert got == [2, 2, 4, 8, 16]
    assert {mb.visit_load_model(k, "field", v5.VISIT_FIELDS, rows)
            for k in (1, 4, 8, 16, 32)} == {4}


def test_visit_v5_pipes():
    """M5's bound by row: its operations (41.98 ms at W = 128 and 1M rays)
    and the fewest L1 wavefronts any route's loads need, 2 for 32 tests
    (slot-major at k = 1 or 4; field-major takes 4), so the operations
    bind.  The parent's warp a ray (k = 32) takes 16 wavefronts for 32
    tests, 65.73 ms at one a cycle an SM on 132 SMs at 1980 MHz, within
    0.5% of the 65.4154 ms it measured (PR 7): a route's own time, kept
    beside the bound as a diagnostic."""
    w = dict(sqrt=8.8351, rcp=8.7689)
    n = 1 << 20
    for rows in v5.ROWS:
        assert mb.visit_least_wavefronts(v5.VISIT_FIELDS, rows) == 2
    pipes = v5.visit_v5_pipes(n, 128, "mxu", 256, w["sqrt"], w["rcp"])
    assert pipes["fp32"] == v5.visit_v5_work(n, 128, "mxu", 256, w["sqrt"],
                                             w["rcp"])[0]
    assert pipes["l1_wavefronts"] == n * 256 * 4 * 2
    ms, by, row = mb.pipe_bound(pipes, 0)
    assert (by, row) == ("operations", "fp32")
    assert ms == pytest.approx(41.98, rel=0.01)
    warp = mb.visit_route_ms(n * 256 * 128, 32, "slot", v5.VISIT_FIELDS, 128)
    assert warp == pytest.approx(n * 256 * 4 * 16 / (132 * 1.98e9) * 1e3)
    assert warp == pytest.approx(65.73, abs=0.01)
    assert mb.visit_route_ms(n * 256 * 128, 8, "slot", v5.VISIT_FIELDS,
                             128) == pytest.approx(warp / 4)


def test_visit_lanes_equal_the_sources():
    """The wrappers' k and layout of the lanes way (``VISIT_LANES``,
    ``VISIT_LAYOUT``) are the ones the sources build (csrc/microbench_v5.cu
    and microbench.cu kVisitLanes, M5's field-major flags), with M4 on K1's
    slot-major table, its shifted table formed once a visit."""
    from raytracers_tpu_torch.probes import m4m5_turns as tm
    ch = tm.change_spec()
    assert ch["m5"] == {r: (v5.VISIT_LANES[r], v5.VISIT_LAYOUT[r])
                        for r in v5.ROWS}
    assert ch["m4"] == (mb.VISIT_LANES, "slot")
    assert ch["shift"] is True and ch["bounds"] == "256"
    assert all(k in mb.LANE_COUNTS for k in (*v5.VISIT_LANES.values(),
                                             mb.VISIT_LANES))


def test_lanes_way_reads_its_layout(monkeypatch):
    """The lanes way passes the field-major copy, made in the call, where
    ``VISIT_LAYOUT`` says so, and the table as it is elsewhere; the thread
    way always reads K1's slot-major table."""
    seen = []
    monkeypatch.setattr(v5, "_on_card", lambda *ts: True)
    monkeypatch.setattr(v5, "_launch", lambda label, out, *args, **kw:
                        seen.append((label, args[1], args[7])))
    s = _salt()
    for rows in v5.ROWS:
        sphT, sph8 = _m5_inputs("seeded", rows)
        for way in v5.VISIT_WAYS:
            v5.visit_v5(s, sphT, sph8, T, rows, "mxu", way, 2)
            label, code, tbl = seen.pop()
            lanes, layout = v5.way_route(way, rows)
            assert code == lanes and label.endswith(f"{way} {T}")
            want = v5.field_major(sphT) if layout == "field" else sphT
            assert torch.equal(tbl, want) and tbl.is_contiguous()
            assert (tbl is sphT) == (layout == "slot")
    assert v5.way_route("thread", 64) == (1, "slot")


def test_m4m5_side_builds_rewrite_their_lines(tmp_path, monkeypatch):
    """The M4/M5 turns probe's side builds: k in {4, 8, 16, 32} in the
    slot-major and the field-major layout (M4's loads of a row rewritten
    for it), M4's shift added by each lane, the visit kernels asking for
    one block an SM at least; each rewrites lines that occur once, only in
    the sources it changes, and none equals the change."""
    from raytracers_tpu_torch.probes import m4m5_turns as tm
    from raytracers_tpu_torch.probes import turns
    monkeypatch.setattr(turns, "OUT_DIR", tmp_path)
    specs = tm.side_specs()
    ch = tm.change_spec()
    assert ch["bounds"] == "256"
    sweep = {f"{p}k{k}" for p in ("", "field_") for k in tm.SWEEP_K}
    assert set(specs) == sweep | {"shift_each", "min_blocks1"}
    assert specs["field_k16"]["m5"] == dict.fromkeys(v5.ROWS, (16, "field"))
    assert specs["k4"]["m4"] == (4, "slot")
    assert set(tm.side_edits(specs["shift_each"])) == {"microbench"}
    assert specs["shift_each"]["shift"] is False and ch["shift"] is True
    assert tm.side_edits(specs["shift_each"]) == {"microbench": [tm.M4_SHIFT]}
    assert tm.M4_FIELD in tm.side_edits(specs["field_k32"])["microbench"]
    assert tm.M4_FIELD not in tm.side_edits(specs["k4"])["microbench"]
    paths = tm.side_sources()
    for name, spec in specs.items():
        for kernel, edits in tm.side_edits(spec).items():
            text = paths[name][kernel].read_text()
            for old, new in edits:
                assert new in text and old not in text, (name, old)
    assert "kVisitLanes[3] = {32, 32, 32};" in paths["field_k32"][
        "microbench_v5"].read_text()
    assert "__launch_bounds__(256, 1)\nvisit_lanes(" in paths[
        "min_blocks1"]["microbench"].read_text()
    assert tm.side_edits(ch) == {}


def test_m4m5_parent_calls_take_the_parent_codes(monkeypatch):
    """The parent's builds are launched by their own way codes (thread 0,
    warp 1) under labels of their own ways."""
    from raytracers_tpu_torch.probes import m4m5_turns as tm
    seen = []
    monkeypatch.setattr(mb, "_launch", lambda label, out, *args, **kw:
                        seen.append((label, args[0], args[1])))
    m4, m5 = tm.parent_calls()
    s = _salt()
    for way, (lanes, fn) in m4.items():
        fn(s, None, None, 512, 3)
    for way, (route, fn) in m5.items():
        assert route == dict.fromkeys(
            v5.ROWS, ({"thread": 1, "warp": 32}[way], "slot"))
        fn(s, None, None, 512, 64, "defer", 3)
    assert seen == [("M4 thread 512", 3, 0), ("M4 warp 512", 3, 1),
                    ("M5 visit_r64_defer thread 512", 0, 0),
                    ("M5 visit_r64_defer warp 512", 0, 1)]


def test_m4m5_sweep_picks_k_at_the_probe_size():
    """The sweep reads each build's median (the device's own where taken)
    by k on the change's layout, keeps the other layout and the shift as
    sides, and picks the fastest k at 8,192 rays (M5) and 4,096 (M4)."""
    from raytracers_tpu_torch.probes import m4m5_turns as tm
    ch = dict(m5={32: (8, "field"), 64: (8, "slot"), 128: (8, "slot")},
              m4=(8, "slot"), shift=False, bounds="256")

    def all_at(k, layout):
        return dict(ch, m5=dict.fromkeys(v5.ROWS, (k, layout)),
                    m4=(k, layout))
    specs = {"change": ch, "k4": all_at(4, "slot"),
             "field_k8": all_at(8, "field"),
             "shift_once": dict(ch, shift=True)}
    med = {"M5 r128 8192": {"change": 0.5, "k4": 0.45, "field_k8": 0.4},
           "M5 r32 8192": {"change": 0.2, "k4": 0.25, "field_k8": 0.2},
           "M5 r128 1048576": {"change": 50.0, "k4": 55.0, "field_k8": 52.0},
           "M4 4096": {"change": 0.3, "k4": 0.35, "shift_once": 0.2}}
    side = dict(specs=specs, median_ms=med,
                median_device_ms={"M5 r128 8192": {"change": 0.48}})
    out = tm.sweep(side, log=lambda *a: None)
    assert out["rows"]["M5 r128 8192"]["by_k"] == {8: 0.48, 4: 0.45}
    assert out["rows"]["M5 r128 8192"]["sides"]["field_k8"]["ms"] == 0.4
    # at 32 rows the change is field-major: the slot-major k4 is the side
    assert out["rows"]["M5 r32 8192"]["by_k"] == {8: 0.2}
    assert out["rows"]["M5 r32 8192"]["sides"]["k4"]["layout"] == "slot"
    assert out["rows"]["M4 4096"]["sides"]["shift_once"]["shift"] is True
    assert out["pick_at_probe_size"] == {"M5 r128 8192": 4,
                                         "M5 r32 8192": 8, "M4 4096": 8}


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
@pytest.mark.parametrize("lanes", [3 * T, 1 << 20])
@pytest.mark.parametrize("which", v5.INPUTS)
@pytest.mark.parametrize("way", v5.GATHER_WAYS)
@pytest.mark.parametrize("chunks", v5.CHUNKS)
def test_card_gather_equals_plain(cuda, chunks, way, which, lanes):
    """Every way and width bit-equal to gather_plain, at a few tiles and at
    1M lanes, where the shared ways' blocks loop over several tiles; 11
    steps cross the unrolled loop's remainder."""
    s = torch.tensor([SALT], device=cuda)
    tbl = torch.from_numpy(v5.gather_inputs(which, chunks)).to(cuda)
    label = v5.gather_label(chunks, way, lanes)
    n0 = mb.LAUNCHES[label]
    y = v5.gather(s, tbl, lanes, chunks, way, iters=11)
    assert mb.LAUNCHES[label] == n0 + 1
    ref = v5.gather_plain(s, tbl, lanes, chunks, 11)
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_card_gather_sass(cuda):
    """No gather kernel holds a MUFU (the slot steps by an increment and a
    mask); the __ldg way reads a slot as two 16-byte loads (LDG.128, two a
    lane-step of the unrolled body and of its remainder) and makes no
    other load."""
    from raytracers_tpu_torch.render import _cuda
    _cuda.load("microbench_v5")
    counts, _ = mb.sass_counts(_cuda.build_info["microbench_v5"]["path"])
    gathers = {f: c for f, c in counts.items() if "gather_probe" in f}
    assert len(gathers) == 2 * len(v5.GATHER_WAYS)
    assert not [f for f, c in gathers.items() if c.get("MUFU")]
    for f, c in gathers.items():
        way = int(f.split("ELi")[1][0])
        if way == 0:
            assert c.get("LDG.128", 0) >= 2 and c["LDG.128"] % 2 == 0
            assert c["LDG"] == c["LDG.128"]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 16, 32])
def test_card_visit_refuses_a_k_not_built(cuda, k):
    """The lanes way runs at the build's k of the width only: another k,
    given to the C entry as its way code (``m4m5_turns.launch_m5``), is
    refused, and the launch raises without being counted."""
    from raytracers_tpu_torch.probes import m4m5_turns as tm
    s = torch.tensor([SALT], device=cuda)
    sphT, sph8 = _m5_inputs("tpu", 64, cuda)
    if k == v5.VISIT_LANES[64]:
        pytest.skip("the build's own k")
    label = v5.visit_label(64, "mxu", "lanes", T)
    n0 = mb.LAUNCHES[label]
    with pytest.raises(RuntimeError, match="launch failed"):
        tm.launch_m5("lanes", k, s, v5.field_major(sphT), sph8, T, 64, "mxu",
                     2)
    assert mb.LAUNCHES[label] == n0


@pytest.mark.cuda
def test_card_visit_sass(cuda):
    """M5's visit kernels, a thread a ray and the build's k at each width,
    both payloads: no local memory; every FFMA one of the two refinement
    steps of a sqrtf's or 1/a's MUFU (-fmad=false contracts nothing else);
    the lanes way folds by log2 k shuffles (one REDUX at k = 32), the
    thread way by none."""
    from raytracers_tpu_torch.render import _cuda
    _cuda.load("microbench_v5")
    counts, _ = mb.sass_counts(_cuda.build_info["microbench_v5"]["path"])
    visits = {f: c for f, c in counts.items() if "visit_lanes" in f}
    assert len(visits) == 2 * len(v5.ROWS) * len(v5.PAYLOADS), visits
    for f, c in visits.items():
        k = int(f.split("visit_lanes")[1].split("ELi")[-1].split("E")[0])
        assert "LDL" not in c and "STL" not in c, (f, c)
        assert c.get("MUFU", 0) >= 1 and c.get("FFMA", 0) == 2 * c["MUFU"], (
            f, c)
        if k == 1:
            assert not c.get("SHFL") and not c.get("REDUX"), (f, c)
        elif k == 32:
            assert c.get("REDUX", 0) >= 1, (f, c)
        else:
            assert c.get("SHFL", 0) >= int(np.log2(k)), (f, c)
