"""The metric readers against a hand-made trace, and the least-time
counts against hand counts on a 3-leaf tree."""
import types

import numpy as np
import pytest
import torch

from gbdtbench import layer, roofline, spec
from gbdtbench.trace import TraceView, breakdown
from reference import model_text as MT

US = 1e-6


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


TRACE = [
    _ev("user_annotation", "bench.traced", 0, 1000),
    _ev("user_annotation", "tel.histogram", 100, 100),
    _ev("cuda_runtime", "cudaLaunchKernel", 150, 5, 1),
    _ev("kernel", "histk", 300, 50, 1),
    _ev("cpu_op", "aten::add", 600, 20),
    _ev("cuda_runtime", "cudaLaunchKernel", 605, 5, 2),
    _ev("kernel", "other", 700, 100, 2),
    _ev("cuda_runtime", "cudaMemcpyAsync", 810, 5, 3),
    _ev("gpu_memcpy", "Memcpy HtoD", 820, 30, 3),
    {"ph": "i", "cat": "kernel", "name": "not a range", "ts": 5},
]

#: root (100 rows) -> leaf 0 (30) and node 1 (70) -> leaves 1 (40), 2 (30)
TREE = {"num_leaves": 3, "split_feature": np.array([0, 1]),
        "threshold": np.array([0.0, 0.5]), "decision_type": np.array([2, 2]),
        "left_child": np.array([~0, ~1]), "right_child": np.array([1, ~2]),
        "leaf_value": np.array([1.0, 2.0, 3.0]),
        "leaf_count": np.array([30, 40, 30]),
        "internal_count": np.array([100, 70]), "split_gain": np.zeros(2)}


def _run(**kw):
    view = TraceView(TRACE)
    run = types.SimpleNamespace(view=view, traced_span=(0.0, 1000 * US),
                                layer={}, window={}, **kw)
    return run


def test_trace_view_reads_the_hand_made_trace():
    v = TraceView(TRACE)
    assert len(v.device) == 3
    assert v.busy(0, 1000 * US) == pytest.approx(180 * US)
    assert layer.idle_share(_run()) == pytest.approx(82.0)
    hist = v.launched_in(v.ranges("tel.histogram"))
    assert [e["name"] for e in hist] == ["histk"]
    flat = [t for gap in v.gaps(0, 1000 * US) for t in gap]
    assert flat == pytest.approx(
        [0, 300 * US, 350 * US, 700 * US, 800 * US, 820 * US, 850 * US,
         1000 * US])
    assert v.host_at(150 * US) == "tel.histogram"
    assert v.host_at(610 * US) == "aten::add"
    assert v.host_at(900 * US) == "bench.traced"
    b = breakdown(v, 0, 1000 * US)
    assert b["device_ops"][0] == ["other", pytest.approx(100 * US)]
    names = dict((k, v) for k, v in b["idle_gaps"])
    assert names["tel.histogram"] == pytest.approx(300 * US)


def test_a_kernel_without_its_launch_is_not_placed():
    v = TraceView(TRACE[:3] + [_ev("kernel", "lost", 300, 50, 99)])
    assert v.launched_in(v.ranges("tel.histogram")) is None


def test_launch_and_copy_readers():
    s = spec.Spec("higgs-predict-500k")
    run = _run(spec=s)
    run.layer.update({"trace_calls": 2, "trace_iterations": 2})
    assert s.reader("launches_per_tree")(run) == pytest.approx(1.5)
    run.view.host.append({"name": "bench.predict", "cat": "user_annotation",
                          "t0": 0.0, "dur": 1000 * US, "t1": 1000 * US,
                          "tid": 1, "pid": 1, "corr": None})
    assert s.reader("h2d_ms_per_call")(run) == pytest.approx(30 * US * 1e3
                                                             / 2)
    assert s.reader("predict_kernel_ms_per_call")(run) == pytest.approx(
        150 * US * 1e3 / 2)


def test_tree_counts_by_hand():
    assert roofline.child_rows(TREE).tolist() == [[30, 70], [40, 30]]
    assert roofline.histogram_rows(TREE, 100) == 100 + 30 + 30
    assert roofline.routed_rows(TREE) == 100 + 70
    # 160 rows x (2 features x 1 B + 8 B of gradients) + 3 histograms of
    # 2 features x 4 bins x 3 channels x 4 B
    assert roofline.histogram_bytes([TREE], 100, 2, 1.0, 8.0, 4, 4) \
        == 1600 + 288
    # + the gradient pass and score update, 100 x (4 + 4 + 8 + 8) B, and
    # 170 routed rows x 1 B
    assert roofline.iteration_bytes([TREE], 100, 2, 1.0, 8.0, 4, 4) \
        == 1888 + 2400 + 170
    assert MT.leaf_depths(TREE).tolist() == [1, 2, 2]
    X = torch.tensor([[-1.0, 0.0], [1.0, 0.0], [1.0, 1.0], [1.0, 2.0]],
                     dtype=torch.float64)
    assert MT.leaf_index(X, TREE).tolist() == [0, 1, 2, 2]
    assert MT.node_visits(X, [TREE]) == 1 + 2 + 2 + 2
    assert MT.raw_scores(X, [TREE]).tolist() == [1.0, 2.0, 3.0, 3.0]
    # 10 rows x 2 features x 8 B + 2 nodes x 16 B + 3 leaves x 8 B
    # + 10 scores x 4 B, against 25 visits
    assert roofline.predict_least_seconds(10, 2, 8, [TREE], 25) \
        == pytest.approx(256 / 3.35e12)


def test_shares_stay_under_one_hundred():
    s = spec.Spec("higgs-train-f32")
    run = _run(spec=s)
    run.layer.update({"trees": [TREE], "trace_first": 0,
                      "trace_iterations": 1, "num_data": 100})
    run.window = {"seconds": 1.0, "trees": 10}
    share = s.reader("hist_roofline")(run)
    assert 0 < share < 100
    assert 0 < s.reader("mfu.train")(run) < 100
