"""The port's timing, profiling and metrics utilities, the bounds' shared
operation counts, and the L0/L1 helpers ``vec3``, ``scale``, ``enclosing``
and ``hit_record`` against the JAX package's.

Mirrors ``tests/test_utils.py:52,78`` (``bench_fn``, ``PhaseTimer`` on a
host lambda; ``Metrics``) and ``tests/test_vec.py:9,15,33,42``.  The helpers
are bit-equal to JAX's on numpy inputs made from a seed; ``hit_record`` at
depth 1 on JAX's own primary rays and hits.
"""
import gzip
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from raytracers_tpu import camera as jcamera
from raytracers_tpu import scenes as jscenes
from raytracers_tpu import vec as jvec
from raytracers_tpu.geometry import hit_record as jhit_record
from raytracers_tpu.render.bruteforce import make_closest_hit as jclosest
from raytracers_tpu.render.tracer import primary_rays as jprimary_rays
from raytracers_tpu_torch import vec
from raytracers_tpu_torch.geometry import hit_record
from raytracers_tpu_torch.utils import profiling, timing

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _eq(port, ref):
    """Bit-equal, NaN where the other is NaN (whatever its payload)."""
    port, ref = port.numpy(), np.asarray(ref)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(port), nan)
    np.testing.assert_array_equal(_bits(port)[~nan], _bits(ref)[~nan])


def test_bench_fn_and_phase_timer():
    timer = timing.PhaseTimer()
    dt = timer.measure("noop", lambda: torch.ones(4), warmup=1, runs=2)
    assert dt >= 0
    assert timer.report() == {"noop": dt}
    calls = []
    assert timing.bench_fn(lambda x: calls.append(x), 7, warmup=1,
                           runs=3) >= 0
    assert calls == [7] * 4


def test_bench_salted_and_batched():
    seen = []
    dt = timing.bench_salted(lambda x: seen.append(x) or torch.tensor(x),
                             lambda k: (k,), warmup=2, runs=3)
    assert dt >= 0 and seen == [-1, -2, 0, 1, 2]
    seeds = []

    def make(k):
        def fn(seed):
            seeds.append(seed)
            time.sleep(1e-3)
            return torch.tensor(seed) * k
        return fn

    per = timing.bench_batched(make, runs=2, k=4)
    assert seeds == [-1.0, -2.0, 0.0, 1.0]
    assert 1e-3 / 4 <= per < 1.0


def test_wait_walks_nested_outputs_on_the_host():
    out = {"a": (torch.ones(2), [torch.zeros(1)]), "b": 3}
    assert timing.wait(out) is out           # no CUDA tensor: no sync


def test_profiling_metrics():
    m = profiling.Metrics(100, 50, "rgbbox", device="cpu")
    m.phase("bvh", 0.002).phase("render", 0.01)
    data = m.data
    assert data["platform"] == "cpu" and data["n_devices"] == 1
    assert data["render_ms"] == 10.0 and data["bvh_ms"] == 2.0
    assert abs(data["mrays_per_s"] - 100 * 50 / 0.01 / 1e6) < 1e-9
    assert data["mrays_per_s_per_chip"] == data["mrays_per_s"]


def test_metrics_dump_and_timed(tmp_path, capsys):
    m = profiling.Metrics(8, 8, "irreg", device="cpu").phase("render", 0.5)
    path = tmp_path / "m.json"
    assert m.dump(str(path)) == json.loads(path.read_text())
    got = []
    with profiling.timed("Rendering", sink=lambda k, v: got.append((k, v))):
        pass
    assert got and got[0][0] == "Rendering" and got[0][1] >= 0
    assert "Rendering in " in capsys.readouterr().err


def test_device_kernel_ms_sums_only_kernel_events(tmp_path):
    """Two traces (plain and gzipped) in nested folders: the kernel events'
    durations summed by name, exactly; host ops, runtime calls, copies,
    sets, metadata and instant events ignored."""
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "dur": 1.5},
          {"ph": "X", "cat": "kernel", "name": "k2", "dur": 250.0},
          {"ph": "X", "cat": "cpu_op", "name": "k1", "dur": 99.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "dur": 5.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 7.0},
          {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 2.0},
          {"ph": "i", "cat": "kernel", "name": "k1"},
          {"ph": "M", "name": "process_name", "args": {"name": "GPU 0"}}]
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "h_1.pt.trace.json").write_text(
        json.dumps({"traceEvents": ev}))
    with gzip.open(tmp_path / "h_2.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": ev[:1]}, f)
    (tmp_path / "notes.json").write_text(json.dumps({"traceEvents": ev}))
    assert profiling.device_kernel_ms(str(tmp_path)) == {
        "k1": (1.5 + 1.5) / 1e3, "k2": 250.0 / 1e3}


def test_device_trace_on_the_host_has_no_device_kernels(tmp_path):
    with profiling.device_trace(str(tmp_path / "tr")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json.gz")
    with gzip.open(tmp_path / "tr" / files[0], "rt") as f:
        assert json.load(f)["traceEvents"]
    assert profiling.device_kernel_ms(str(tmp_path / "tr")) == {}
    assert profiling.device_events(prof) == []
    assert profiling.device_profile(lambda: torch.ones(8).sum()) is None


def test_vpu_ceiling_reads_the_card_record():
    with open(os.path.join(REPO, "docs", "MICROBENCH_H100.json")) as f:
        rec = json.load(f)
    m1 = [e["lane_ops_per_s"] for e in rec["entries"]
          if e["probe"] == "M1" and e["mode"] in ("mul_add", "fma")]
    got = profiling.vpu_ceiling_lane_ops(rec)
    assert got == max(m1)
    assert got <= rec["peaks"]["fp32_lane_ops_per_s"]
    with open(os.path.join(REPO, "docs", "MICROBENCH.json")) as f:
        with pytest.raises(ValueError, match="peaks"):
            profiling.vpu_ceiling_lane_ops(json.load(f))


@pytest.mark.parametrize("name", [
    "FP32_LANE_OPS_PER_S", "HBM_BYTES_PER_S", "SQRT_OPS", "DIV_OPS",
    "OPS_PER_SLOT", "OPS_PER_SLOT_NEAR", "OPS_PER_CULL_ROW", "OPS_PER_GATE",
    "OPS_PER_BOUNCE", "OPS_PER_HIT", "OPS_PER_MIRROR", "STATE_BYTES",
    "OPS_PER_K2_BOUNCE", "OPS_PER_K2_END", "K2_SCRATCH_BYTES", "PAY_BYTES",
    "K3_OPS", "device_profile"])
def test_chip_smoke_reads_the_moved_constants(name):
    assert getattr(chip_smoke, name) is getattr(profiling, name)


def test_operation_counts_keep_their_values():
    assert profiling.CULL_OPS_PER_ROW is profiling.OPS_PER_CULL_ROW
    assert profiling.OPS_PER_SLOT == 29 + 8.78
    assert profiling.OPS_PER_K2_BOUNCE == 351 + 6 * 8.78 + 7 * 8.71
    assert profiling.K3_OPS["hit_bounces"] == 73 + 2 * 8.78 + 6 * 8.71
    from raytracers_tpu_torch.probes import microbench
    assert microbench.FP32_LANE_OPS_PER_S is profiling.FP32_LANE_OPS_PER_S
    assert microbench.HBM_BYTES_PER_S is profiling.HBM_BYTES_PER_S


# ---- the L0/L1 helpers against JAX ----------------------------------------

def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("args", [
    (1.0, 2.0, 3.0),
    ("grid", 1.0, 2.0),          # tests/test_vec.py:15's broadcast
    ("x", "y", "z")])
def test_vec3_bit_equal(args):
    comps = {"grid": np.zeros((4, 5), np.float32), "x": _rand((6,), 1),
             "y": _rand((6,), 2), "z": _rand((6,), 3)}
    vals = [comps.get(a, a) if isinstance(a, str) else a for a in args]
    port = vec.vec3(*[torch.from_numpy(v) if isinstance(v, np.ndarray)
                      else v for v in vals])
    ref = jvec.vec3(*vals)
    assert tuple(port.shape) == ref.shape and port.dtype == torch.float32
    _eq(port, ref)


def test_vec3_dtype_and_device():
    v = vec.vec3(1, 2, 3, dtype=torch.float64)
    assert v.dtype == torch.float64 and v.device.type == "cpu"
    assert v.tolist() == [1.0, 2.0, 3.0]


def test_scale_bit_equal():
    v, s = _rand((7, 3), 4), _rand((7,), 5)
    _eq(vec.scale(torch.from_numpy(s), torch.from_numpy(v)),
        jvec.scale(s, v))
    _eq(vec.scale(2.0, torch.from_numpy(v[0])), jvec.scale(2.0, v[0]))


def test_enclosing_bit_equal_and_nan_propagating():
    a = jvec.Aabb(_rand((9, 3), 6), _rand((9, 3), 7))
    b = jvec.Aabb(_rand((9, 3), 8), _rand((9, 3), 9))
    b.min[0, 1] = np.nan
    a.max[2, 0] = np.nan
    port = vec.enclosing(vec.Aabb(*map(torch.from_numpy, a)),
                         vec.Aabb(*map(torch.from_numpy, b)))
    ref = jvec.enclosing(a, b)
    assert np.isnan(port.min[0, 1].item()) and np.isnan(port.max[2, 0].item())
    _eq(port.min, ref.min)
    _eq(port.max, ref.max)
    _eq(vec.centre(port), jvec.centre(ref))


def test_hit_record_bit_equal_at_depth1():
    """JAX's primary rays of rgbbox at 32x32 and their closest hits; both
    packages' ``hit_record`` on the hitting rays (p = o + t d, the normal
    (p - c) * (1 / r)), op by op."""
    sc = jscenes.rgbbox()
    cam = jcamera(sc.look_from, sc.look_at, (0., 1., 0.), sc.fov, 1.0)
    o, d = jprimary_rays(cam, 32, 32)
    idx, t = jclosest(sc.spheres, "precise")(o, d)
    hit = np.asarray(idx) >= 0
    assert 0 < hit.sum() < hit.size
    k = np.asarray(idx)[hit]
    args = [np.asarray(x)[hit] for x in (t, o, d)] + [
        np.asarray(f)[k] for f in sc.spheres]
    ref = jhit_record(*map(jnp.asarray, args))
    port = hit_record(*map(torch.from_numpy, args))
    for p, r in zip(port, ref):
        _eq(p, r)
