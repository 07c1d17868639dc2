"""The harness: BENCHMARK.json against the contract's rules, the loader
(with a throwaway configuration, traffic mix and metric added as files and
entries only), the result line's schema, the metric readers on a made-up
trace, and the import rules."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.trace import Trace, gaps_us, union_us

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and (PKG / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    used = {w["config"] for w in cells.values()}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in cells.values():
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (PKG / "traffic" / f"{w['traffic']}.json").exists()
        mine = [m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                if w["name"] in m.get("workloads", cells)]
        assert {"setup_s"} < {m["name"] for m in mine if m in BENCH["end_to_end"]}
        assert any(m in BENCH["per_layer"] for m in mine)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_find_cell_and_metrics():
    for w in BENCH["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.config["code"] == w["config"] and hasattr(cell.driver, "run")
        for m in cell.per_layer:
            assert callable(harness.load_metric(m["name"]).read)


def test_result_line_schema():
    out = harness.Outcome(10, 0, {}, {}, [harness.Check("frames_wrong", 0, 0)], 123)
    metrics = {"setup_s": {"value": 1.5, "unit": "s"}}
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 123}
    line = json.loads(harness.result_line(out, metrics, device, None))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["checks"] == {"frames_wrong": {"value": 0, "limit": 0}}
    out.checks.append(harness.Check("points_wrong", 1, 0))
    line = json.loads(harness.result_line(out, metrics, device, {"device_ops": [],
                                                                 "idle_gaps": []}))
    assert line["correct"] is False and list(line)[-2:] == ["breakdown", "checks"]


LAYERED = "void (anonymous namespace)::layered_minsum_kernel<float, 2>(float const*)"


def made_up_trace():
    # window 0-1000 µs: two kernels, one copy alone, a range around 600-800
    return Trace((0.0, 1000.0),
                 kernels=[(LAYERED, 100.0, 400.0),
                          ("gemm_kernel", 600.0, 700.0), ("cat_kernel", 720.0, 800.0)],
                 copies=[("Memcpy HtoD (Pinned -> Device)", 0.0, 100.0)],
                 ranges=[("portbench.encode_bits", 600.0, 800.0)],
                 host=[("aten::copy_", 400.0, 600.0), ("cudaLaunchKernel", 590.0, 599.0)])


def test_trace_readers():
    t = made_up_trace()
    assert union_us(t.kernels, t.window) == 480.0
    assert gaps_us(t.ops(), t.window) == [(400.0, 600.0), (700.0, 720.0), (800.0, 1000.0)]
    assert t.busy_s() == pytest.approx(580e-6)
    assert t.kernel_time_s("layered_minsum_kernel") == pytest.approx(300e-6)
    assert t.time_in_ranges_s("portbench.encode_bits") == pytest.approx(180e-6)
    assert t.time_in_ranges_s("absent") is None
    assert t.top_ops(1) == [[LAYERED, pytest.approx(300e-6)]]
    assert t.kernel_time_s("minsum_kernel") == 0.0
    idle = dict(t.idle_by_host(10))
    assert idle["aten::copy_"] == pytest.approx(200e-6)
    assert idle["(python, in no profiled operation)"] == pytest.approx(220e-6)
    counts = {"frames": 16384, "batches": 1, "sweeps": 16384 * 20, "dtype": "float32",
              "trials": 8192}
    cfg = json.loads((PKG / "configs" / "TM8192.json").read_text())
    got = {m: harness.load_metric(m).read(t, counts, cfg)
           for m in ("device_idle_pct.stream", "copy_in_ms.stream", "layered_roofline_pct.stream",
                     "encoder_roofline_pct.waterfall")}
    assert got["device_idle_pct.stream"] == pytest.approx(52.0)
    assert got["copy_in_ms.stream"] == pytest.approx(0.1)
    bound = 20 * 30720 * 16384 * 20 / 67e12
    assert got["layered_roofline_pct.stream"] == pytest.approx(100 * bound / 300e-6)
    assert got["encoder_roofline_pct.waterfall"] == pytest.approx(
        100 * 2 * 4096 * 4096 * 8192 / 1979e12 / 180e-6)
    bf = Trace((0.0, 1.0), kernels=[("(anonymous namespace)::bitflip_kernel(unsigned char const*)",
                                     0.0, 1.0)])
    assert harness.load_metric("bitflip_roofline_pct.waterfall").read(
        bf, {"trials": 1, "sweeps": 1}, cfg) > 0
    no_kernel = Trace((0.0, 1.0), kernels=[("other", 0.0, 1.0)])
    assert harness.load_metric("bitflip_roofline_pct.waterfall").read(
        no_kernel, {"trials": 1, "sweeps": 1}, cfg) is None


def test_forbidden_compared_whole():
    assert harness.forbidden_loaded(["labrador_ldpc_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_loaded(["labrador_ldpc_tpu.ops", "jax.numpy"]) == \
        ["jax", "labrador_ldpc_tpu"]


def imports_of(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def reads_benchmarks_dir(path: Path) -> bool:
    """A string constant (docstrings aside) naming the JAX package's
    benchmarks/ directory."""
    needle = "bench" + "marks"
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return any(isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs
               and re.search(rf"(^|/){needle}(/|$)", n.value) for n in ast.walk(tree))


def test_sources_import_rules():
    files = sorted(PKG.rglob("*.py"))
    assert files
    for f in files:
        found = imports_of(f)
        assert not found & set(harness.FORBIDDEN), f
        if "reference" in f.relative_to(PKG).parts:
            assert "labrador_ldpc_tpu_torch" not in found, f
        assert not reads_benchmarks_dir(f), f


def test_dry_runs_hold_no_forbidden_module():
    """Every cell's dry run in one fresh process; then sys.modules."""
    code = ("import sys, json\n"
            "from portbench.run import main\n"
            f"for w in {[w['name'] for w in BENCH['workloads']]!r}:\n"
            "    assert main(['--workload', w, '--seed', '12', '--seconds', '1', '--trace', '0',"
            " '--dry-run']) == 0\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "check frames_wrong: 0 (limit 0) ok" in out.stderr
    assert "check points_wrong: 0 (limit 0) ok" in out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "labrador_ldpc_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_new_cell_is_files_and_entries(tmp_path):
    """A throwaway configuration, traffic mix, metric and cell: new files in
    a copy of portbench/ and new entries in its BENCHMARK.json only."""
    pkg = tmp_path / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((PKG / "configs" / "TC512.json").read_text())
    (pkg / "configs" / "TC512b.json").write_text(json.dumps(dict(cfg, name="TC512b")))
    tr = json.loads((PKG / "traffic" / "perftest_sweep.json").read_text())
    tr["dry_run"]["calls"] = [{"snrs": [2.5]}]
    (pkg / "traffic" / "one_point.json").write_text(json.dumps(tr))
    (pkg / "metrics" / "calls_seen.waterfall.py").write_text(
        "def read(trace, counts, config):\n    return float(counts['trials'])\n")
    bench["configs"].append(dict(bench["configs"][1], name="TC512b",
                                 file="portbench/configs/TC512b.json"))
    bench["workloads"].append({"name": "tc512b.one_point", "config": "TC512b",
                               "traffic": "one_point", "chips": 1, "why": "throwaway"})
    bench["per_layer"].append({"name": "calls_seen.waterfall", "unit": "trials",
                               "better": "higher", "source": "program_counter",
                               "layer": "waterfall", "moves": "waterfall_trials_per_s",
                               "workloads": ["tc512b.one_point"]})
    for m in bench["end_to_end"]:
        if m["name"] == "waterfall_trials_per_s":
            m["workloads"].append("tc512b.one_point")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from portbench import harness\n"
            "from portbench.run import main\n"
            "cell = harness.find_cell('tc512b.one_point')\n"
            "assert [m['name'] for m in cell.per_layer] == ['calls_seen.waterfall']\n"
            "assert [m['name'] for m in cell.end_to_end] == ['waterfall_trials_per_s', 'setup_s']\n"
            "metric = harness.load_metric('calls_seen.waterfall')\n"
            "assert metric.read(None, {'trials': 3}, {}) == 3\n"
            "assert main(['--workload', 'tc512b.one_point', '--seed', '5', '--seconds', '1',"
            " '--trace', '0', '--dry-run']) == 0\n")
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "judged point 2.5" in out.stderr


def test_no_card_no_result():
    """A measured run without a card exits non-zero and prints no line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run has
    no program to measure: it exits non-zero and prints no result."""
    shutil.copytree(PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--dry-run"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "labrador_ldpc_tpu_torch" in out.stderr
