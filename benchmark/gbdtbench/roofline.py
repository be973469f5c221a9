"""Least times: the work that the configuration's algorithm needs for the
run's inputs, over the card's published peaks.

A least time is the larger of the bytes over the memory bandwidth and
the operations over the peak rate that fits them.  Each input byte is
read once and each output byte written once, whatever a kernel reads
again, so the counts hold whichever kernel does the work; where a count
cannot be exact it errs low.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

#: NVIDIA's published H100 SXM figures (dense, at the 700 W limit):
#: HBM3 bandwidth and the rates used here
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_ops_per_s": 67e12}


def child_rows(tree: Dict[str, np.ndarray]) -> np.ndarray:
    """(splits, 2) rows of each split's left and right child."""
    def count(c):
        return (tree["internal_count"][c] if c >= 0
                else tree["leaf_count"][~c])
    return np.array([[count(a), count(b)] for a, b in
                     zip(tree["left_child"], tree["right_child"])],
                    dtype=np.int64).reshape(-1, 2)


def histogram_rows(tree: Dict[str, np.ndarray], num_data: int) -> int:
    """Rows whose histogram the tree needs: the root's, and the smaller
    child's of every split (the larger is the parent's less it)."""
    return int(num_data + child_rows(tree).min(axis=1).sum())


def routed_rows(tree: Dict[str, np.ndarray]) -> int:
    """Row moves of the tree: every row of every split node."""
    return int(child_rows(tree).sum())


def histogram_bytes(trees: List[dict], num_data: int, num_features: int,
                    bin_bytes: float, grad_bytes: float,
                    num_bins: int, hist_entry_bytes: int) -> float:
    """Bytes of the histograms of ``trees``: each histogram row's bins
    and gradients read once, each histogram (features x bins x 3
    channels) written once."""
    total = 0.0
    for t in trees:
        rows = histogram_rows(t, num_data)
        hists = 1 + max(t["num_leaves"] - 1, 0)
        total += rows * (num_features * bin_bytes + grad_bytes)
        total += hists * num_features * num_bins * 3 * hist_entry_bytes
    return total


def iteration_bytes(trees: List[dict], num_data: int, num_features: int,
                    bin_bytes: float, grad_bytes: float, num_bins: int,
                    hist_entry_bytes: int) -> float:
    """Bytes of whole boosting iterations: the histograms, the gradient
    pass (a score and a label read, the gradients written at the cell's
    precision), the score update (a score read and written, float32)
    and the routing (one bin byte read a row of a split node)."""
    per_iter = num_data * (4 + 4 + grad_bytes) + num_data * 8
    route = sum(routed_rows(t) for t in trees) * bin_bytes
    return (histogram_bytes(trees, num_data, num_features, bin_bytes,
                            grad_bytes, num_bins, hist_entry_bytes)
            + per_iter * len(trees) + route)


def least_seconds(nbytes: float, ops: float = 0.0,
                  ops_peak: float = PEAKS["fp32_ops_per_s"]) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / ops_peak)


def predict_least_seconds(rows: int, num_features: int, input_bytes: int,
                          trees: List[dict], visits: int) -> float:
    """One scoring call: the larger of its bytes (the rows, the model's
    nodes and leaves, one float32 score a row) and its node visits, one
    operation each."""
    nodes = sum(max(t["num_leaves"] - 1, 0) for t in trees)
    leaves = sum(t["num_leaves"] for t in trees)
    nbytes = rows * num_features * input_bytes + nodes * 16 + leaves * 8 \
        + rows * 4
    return least_seconds(nbytes, float(visits))
