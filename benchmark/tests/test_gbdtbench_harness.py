"""The harness end to end at a tiny size on the CPU: a cell's run, its
check failing under each planted fault and under the control, the
modules a run loads, a cell added as files only, and a multi-rank
traffic on two gloo ranks."""
import ast
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, make_run

FORBIDDEN = {"jax", "jaxlib", "flax", "lightgbm_tpu"}

#: drives one cell on the CPU in a fresh process and prints its result
#: line and the forbidden modules it loaded
DRIVE = r"""
import json, sys, time, torch
sys.path[:0] = ["benchmark", "."]
from gbdtbench import runner, spec
cell, rows, rank, world, coord = sys.argv[1:6]
run = runner.Run(spec.Spec(cell, root="."), 12345678912, 0.5, False,
                 torch.device("cpu"), time.perf_counter(), rank=int(rank),
                 world=int(world), coord=coord or None, rows=int(rows))
out = runner.execute(run)
print(json.dumps({"out": out, "bad": runner.forbidden_modules(),
                  "report": runner.rank_report(run)}))
"""


def _drive(root, cell, rows, rank=0, world=1, coord=""):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.Popen(
        [sys.executable, "-c", DRIVE, cell, str(rows), str(rank),
         str(world), coord], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_tiny_cell_runs_and_loads_no_jax():
    got = _result(_drive(ROOT, "higgs-train-f32", 6000))
    assert got["out"]["correct"], got["out"]["checks"]
    assert got["out"]["attempted"] >= 1
    assert "train_ms_per_tree" in got["out"]["metrics"]
    assert got["bad"] == []


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _py_files(*parts):
    top = os.path.join(BENCH, *parts)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_reference_imports_nothing_of_the_program():
    for path in _py_files("reference"):
        names = _imports(path)
        assert not names & (FORBIDDEN | {"lightgbm_tpu_torch", "gbdtbench"}), \
            (path, names)


def test_harness_imports_no_jax_nor_the_jax_package():
    paths = list(_py_files("gbdtbench")) + list(_py_files("metrics")) \
        + [os.path.join(BENCH, "run.py"), os.path.join(BENCH,
                                                       "calibrate.py")]
    for path in paths:
        names = _imports(path)
        assert not names & (FORBIDDEN | {"bench", "chip_smoke"}), \
            (path, names)


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter"])
def test_each_training_fault_fails_the_check(fault):
    from gbdtbench import faults, runner
    run = make_run("higgs-train-f32", 6000)
    with faults.plant(fault):
        out = runner.execute(run)
    assert out["correct"] is False, out["checks"]


def _tiny_budget_cell(tmp_path, num_leaves=7):
    """A copy of the benchmark with a cell whose trees the leaf budget
    binds at a tiny size: the training cell at ``num_leaves``."""
    dst = _copy_benchmark(tmp_path)
    b = dst / "benchmark"
    t = json.loads((b / "traffic" / "train-f32.json").read_text())
    t["params"]["num_leaves"] = num_leaves
    (b / "traffic" / "train-f32-small.json").write_text(json.dumps(t))
    (b / "limits" / "higgs-train-small.json").write_text(
        (b / "limits" / "higgs-train-f32.json").read_text())
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "higgs-train-small",
                               "config": "higgs",
                               "traffic": "train-f32-small", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_ms_per_tree":
            m["workloads"].append("higgs-train-small")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(dst)


@pytest.mark.parametrize("fault,number", [("halve", "leaf_shortfall"),
                                          ("order", "frontier_regret")])
def test_each_tree_shape_fault_fails_the_check(tmp_path, fault, number):
    from gbdtbench import faults, runner
    root = _tiny_budget_cell(tmp_path)
    out = runner.execute(make_run("higgs-train-small", 6000, root=root))
    assert out["correct"] is True, out["checks"]
    run = make_run("higgs-train-small", 6000, root=root)
    with faults.plant(fault):
        out = runner.execute(run)
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]
    assert out["correct"] is False


def test_sound_tiny_run_passes_the_same_limits():
    from gbdtbench import runner
    out = runner.execute(make_run("higgs-train-f32", 6000))
    assert out["correct"] is True, out["checks"]


def test_training_control_fails_a_limit():
    from gbdtbench.drivers import train
    run = make_run("higgs-train-f32", 8000)
    got = train.control(run, "tf32")
    limits = run.spec.limits
    assert any(got[k] > limits[k] for k in got if k in limits), got


def _copy_benchmark(tmp_path):
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_*.sh"))
    return dst


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if "__pycache__" not in p:
                out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_predict_cell_and_its_fault(tmp_path):
    dst = _copy_benchmark(tmp_path)
    traffic = dst / "benchmark" / "traffic" / "predict-500k.json"
    t = json.loads(traffic.read_text())
    t["model"]["trees"] = 20
    traffic.write_text(json.dumps(t))
    got = _result(_drive(dst, "higgs-predict-500k", 3000))
    assert got["out"]["correct"], got["out"]["checks"]
    assert {"predict_rows_per_s", "predict_p95_ms", "setup_s"} \
        <= set(got["out"]["metrics"])
    sys.path.insert(0, str(dst / "benchmark"))
    try:
        from gbdtbench import faults, runner
        run = make_run("higgs-predict-500k", 3000, root=str(dst))
        with faults.plant("alter"):
            out = runner.execute(run)
        assert out["correct"] is False
    finally:
        sys.path.remove(str(dst / "benchmark"))


def test_a_cell_is_added_as_files_only(tmp_path):
    dst = _copy_benchmark(tmp_path)
    before = _digests(dst / "benchmark")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    b = dst / "benchmark"
    cfg = json.loads((b / "configs" / "higgs.json").read_text())
    cfg["name"] = "tiny"
    cfg["data"]["num_features"] = 6
    (b / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (b / "traffic" / "tiny-mix.json").write_text(json.dumps({
        "driver": "train", "params": {"num_iterations": 1000000,
                                      "num_leaves": 7},
        "warmup_iterations": 2, "checked_trees": 3, "score_rows": 1000,
        "trace_iterations": 1}))
    (b / "limits" / "tiny-cell.json").write_text(json.dumps({
        "bin_bounds_mismatch": 0, "bin_matrix_mismatch": 0,
        "split_regret": 2e-3, "leaf_gap": 5e-3, "leaf_gap_median": 4e-6,
        "score_gap": 1e-4, "leaf_shortfall": 0, "frontier_regret": 1e-3}))
    (b / "metrics" / "trees_in_window.py").write_text(
        "def read(run):\n    return run.window.get('trees')\n")
    bench["configs"].append({"name": "tiny", "source": "https://example.org",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "trees_in_window", "unit": "trees",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny-cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_ms_per_tree":
            m["workloads"].append("tiny-cell")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    got = _result(_drive(dst, "tiny-cell", 4000))
    assert got["out"]["correct"], got["out"]["checks"]
    assert got["out"]["metrics"]["trees_in_window"]["value"] >= 1
    after = _digests(dst / "benchmark")
    assert {p: d for p, d in after.items() if p in before} == before


def test_two_gloo_ranks_rehearse_a_multi_rank_traffic(tmp_path,
                                                      monkeypatch):
    dst = _copy_benchmark(tmp_path)
    b = dst / "benchmark"
    t = json.loads((b / "traffic" / "train-dp4-f32.json").read_text())
    t["ranks"] = 2
    t["trace_iterations"] = 1
    (b / "traffic" / "train-dp2-f32.json").write_text(json.dumps(t))
    (b / "limits" / "higgs-train-dp2.json").write_text(
        (b / "limits" / "higgs-train-f32.json").read_text())
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "higgs-train-dp2", "config": "higgs",
                               "traffic": "train-dp2-f32", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_ms_per_tree":
            m["workloads"].append("higgs-train-dp2")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [_drive(dst, "higgs-train-dp2", 8000, r, 2, coord)
             for r in range(2)]
    try:
        got = _result(procs[0], timeout=900)
        other = _result(procs[1], timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert got["out"]["correct"], got["out"]["checks"]
    assert got["out"]["device"]["count"] == 2
    # every rank reports the forbidden modules its process holds, and
    # rank 0 refuses a result where any rank holds one
    from gbdtbench import runner
    report = other["report"]
    assert report["forbidden"] == [] and other["bad"] == []
    monkeypatch.setattr(runner, "forbidden_modules", lambda: [])
    out = dict(got["out"], device=dict(got["out"]["device"],
                                       memory_peak_bytes=5))
    assert runner.gather(out, [dict(report, memory_peak_bytes=9)]) == []
    assert out["device"]["memory_peak_bytes"] == 9
    assert runner.gather(out, [report, dict(report, forbidden=["jax"])]) \
        == ["jax"]


@pytest.mark.cuda
def test_tiny_cell_on_the_card(cuda_device):
    from gbdtbench import runner
    out = runner.execute(make_run("higgs-train-f32", 20000, device="cuda"))
    assert out["correct"] is True, out["checks"]
    assert out["device"]["kind"].startswith("NVIDIA")


@pytest.mark.cuda
def test_predict_control_fails_at_the_cell_size(cuda_device):
    from gbdtbench.drivers import predict
    for seed in (1, 2, 3):
        run = make_run("higgs-predict-500k", 0, device="cuda", seed=seed)
        assert predict.control(run) > run.spec.limits["predict_gap"]
