"""Shared arithmetic of the metric readers (``benchmark/metrics``): the
traced part's trees, calls and device events, and the least times of
their work (``roofline.py``)."""
from __future__ import annotations

from typing import List, Optional

from . import roofline


def traced_trees(run) -> List[dict]:
    a = run.layer["trace_first"]
    return run.layer["trees"][a:a + run.layer["trace_iterations"]]


def work_shape(run):
    """(features, bin bytes a row and feature at the configuration's
    storage, gradient bytes a row at the cell's precision, bins, bytes
    of a histogram entry)."""
    p = run.spec.params()
    max_bin = int(p.get("max_bin", 255))
    bin_bytes = 1.0 if max_bin > 16 else 0.5
    grad_bytes = 2.0 if p.get("quantized_grad") else 8.0
    return (int(run.spec.config["data"]["num_features"]), bin_bytes,
            grad_bytes, max_bin, 4)


def hist_least_s(run, trees) -> float:
    F, bb, gb, B, e = work_shape(run)
    return roofline.least_seconds(roofline.histogram_bytes(
        trees, run.layer["num_data"], F, bb, gb, B, e))


def iteration_least_s(run, trees) -> float:
    F, bb, gb, B, e = work_shape(run)
    return roofline.least_seconds(roofline.iteration_bytes(
        trees, run.layer["num_data"], F, bb, gb, B, e))


def in_ranges(run, name: str) -> Optional[list]:
    """Device events launched inside the traced part's ``name`` ranges
    (None where one cannot be placed)."""
    lo, hi = run.traced_span
    spans = [(a, b) for a, b in run.view.ranges(name)
             if a >= lo and b <= hi]
    return run.view.launched_in(spans)


def idle_share(run) -> Optional[float]:
    if run.view is None:
        return None
    lo, hi = run.traced_span
    if hi <= lo:
        return None
    return 100.0 * (1.0 - run.view.busy(lo, hi) / (hi - lo))
