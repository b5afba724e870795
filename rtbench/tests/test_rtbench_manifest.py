"""BENCHMARK.json against the contract's shape, and every name in it found
as a file of the benchmark; the imports of the harness and the
reference."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "raytracers_tpu"}
# the reference and what it imports may use nothing of the program either
REFERENCE = ("reference.py", "scenes.py", "check.py", "roofline.py")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves_to_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    cfg = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert (ROOT / cfg["file"]).is_file()
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    driver = _defines(HERE / "drivers" / f"{mix['driver']}.py", "Driver")
    assert {n.name for n in driver.body if isinstance(n, ast.FunctionDef)
            } >= {"run", "wait", "inputs", "release", "reference", "compare"}
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json")
                        .read_text())
    assert limits and all(v > 0 for v in limits.values())
    reported = [m["name"] for m in METRICS
                if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in reported and len(reported) >= 3


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert cfg["file"].startswith("rtbench/configs/")
    _defines(HERE / "generators" / f"{data['generator']['name']}.py",
             "spheres")


def _defines(path: Path, name: str):
    """``path`` is a module of the benchmark with a top-level ``name``."""
    assert NAME.match(path.stem) and "." not in path.stem, path
    found = [n for n in ast.parse(path.read_text()).body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             and n.name == name]
    assert found, (path, name)
    return found[0]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_has_its_reader(metric):
    path = HERE / "metrics" / f"{metric['name']}.py"
    tree = ast.parse(path.read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
               for n in tree.body)
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["per_layer"]:
        moved = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        for w in metric["workloads"]:
            assert w in moved.get("workloads", [w])
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    texts = ([w["why"] for w in BENCH["workloads"]]
             + [c["why"] for c in BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_in_the_benchmark(path):
    found = _imports(path)
    assert not found & FORBIDDEN, found
    if (path.name in REFERENCE and path.parent == HERE
            or path.parent == HERE / "generators"):
        assert "raytracers_tpu_torch" not in found


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, rtbench.reference, rtbench.check, "
            "rtbench.roofline, rtbench.scenes, rtbench.generators.box_walls, "
            "rtbench.generators.plane; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True).stdout
    loaded = set(ast.literal_eval(out))
    assert not loaded & (FORBIDDEN | {"raytracers_tpu_torch"}), loaded


def test_refuses_without_a_card():
    """With no card the run exits non-zero and prints no result line,
    rather than falling back to the host."""
    code = ("import torch, sys; torch.cuda.is_available = lambda: False; "
            "from rtbench import run; sys.exit(run.main(['--workload', "
            "'rgbbox.render', '--seed', '1', '--seconds', '1']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                       capture_output=True)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "refused" in p.stderr


def test_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the run exits non-zero and prints no result line."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import torch, sys; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "from rtbench import run; sys.exit(run.main(['--workload', "
            "'rgbbox.render', '--seed', '1', '--seconds', '1']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       text=True, capture_output=True)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


# JAX loaded before the window, or by a metric reader after the check
PLANT_JAX = {
    "before the window": "sys.modules['jax'] = types.ModuleType('jax')\n",
    "in a metric reader": (
        "real = run.reader\n"
        "def reader(name):\n"
        "    read = real(name)\n"
        "    def planted(r):\n"
        "        sys.modules['jax'] = types.ModuleType('jax')\n"
        "        return read(r)\n"
        "    return planted\n"
        "run.reader = reader\n"),
}


@pytest.mark.parametrize("where", sorted(PLANT_JAX))
def test_refuses_once_jax_is_loaded(where):
    """A run in whose process JAX is loaded once the window has closed,
    by the program or by anything the harness runs after it, gives no
    result."""
    code = ("import sys, types, torch\nfrom rtbench import run\n"
            + PLANT_JAX[where] +
            "try:\n"
            "    run.run('irreg.render', 1, 0.01, False, device='cpu', "
            "config_override=dict(width=8, height=8))\n"
            "except run.Refused as e:\n"
            "    print('refused', e); sys.exit(0)\n"
            "sys.exit(1)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                       capture_output=True)
    assert p.returncode == 0 and "jax" in p.stdout, p.stdout + p.stderr
