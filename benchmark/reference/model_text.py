"""Plain reference of LightGBM's model text and of scoring with it.

A model text (gbdt_model_text.cpp, v2.1) is a header of ``key=value``
lines, then one ``Tree=<i>`` block per tree with ``num_leaves``,
``split_feature``, ``threshold``, ``decision_type``, ``left_child``,
``right_child`` (a negative child ``c`` is leaf ``~c``), ``leaf_value``,
``leaf_count``, ``internal_count``, ``split_gain`` and ``shrinkage``.

A numerical node sends a row left when its value is at or below the
threshold.  ``decision_type`` holds the default direction in bit 1 and
the missing type in bits 2-3 (0 none, 1 zero, 2 NaN): a NaN (missing
type NaN) or a zero (missing type zero) takes the default direction, and
a NaN under another missing type counts as 0.  Categorical nodes (bit 0)
are refused.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

K_ZERO_THRESHOLD = 1e-35

_INT = ("split_feature", "decision_type", "left_child", "right_child",
        "leaf_count", "internal_count")
_FLOAT = ("threshold", "leaf_value", "split_gain")


def parse(text: str) -> List[Dict[str, np.ndarray]]:
    """The trees of a model text, in order."""
    trees = []
    for block in re.split(r"^Tree=\d+\s*$", text, flags=re.M)[1:]:
        block = block.split("end of trees")[0]
        kv = dict(line.split("=", 1) for line in block.splitlines()
                  if "=" in line)
        t: Dict[str, np.ndarray] = {"num_leaves": int(kv["num_leaves"])}
        if int(kv.get("num_cat", "0")) > 0:
            raise ValueError("the reference scores numerical splits only")
        for k in _INT:
            t[k] = np.array(kv.get(k, "").split(), dtype=np.int64)
        for k in _FLOAT:
            t[k] = np.array(kv.get(k, "").split(), dtype=np.float64)
        trees.append(t)
    return trees


def _goes_left(x: torch.Tensor, thr: torch.Tensor,
               dt: torch.Tensor) -> torch.Tensor:
    if bool((dt & 1).any()):
        raise ValueError("categorical split in the model")
    missing = (dt >> 2) & 3
    default_left = (dt & 2) > 0
    nan = torch.isnan(x)
    xv = torch.where(nan & (missing != 2), torch.zeros_like(x), x)
    use_default = (nan & (missing == 2)) | (
        (missing == 1) & (xv.abs() <= K_ZERO_THRESHOLD))
    return torch.where(use_default, default_left, xv <= thr)


def leaf_index(X: torch.Tensor, tree: Dict[str, np.ndarray]) -> torch.Tensor:
    """(N,) leaf of every row of X (float64, on the device) in one tree."""
    dev = X.device
    n = X.shape[0]
    if tree["num_leaves"] <= 1:
        return torch.zeros(n, dtype=torch.long, device=dev)
    sf = torch.as_tensor(tree["split_feature"], device=dev)
    thr = torch.as_tensor(tree["threshold"], device=dev, dtype=X.dtype)
    dt = torch.as_tensor(tree["decision_type"], device=dev)
    lc = torch.as_tensor(tree["left_child"], device=dev)
    rc = torch.as_tensor(tree["right_child"], device=dev)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    rows = torch.arange(n, device=dev)
    leaf = torch.empty(n, dtype=torch.long, device=dev)
    while rows.numel():
        x = X[rows, sf[node]]
        nxt = torch.where(_goes_left(x, thr[node], dt[node]), lc[node],
                          rc[node])
        done = nxt < 0
        leaf[rows[done]] = ~nxt[done]
        rows, node = rows[~done], nxt[~done]
    return leaf


def raw_scores(X: torch.Tensor, trees: List[Dict[str, np.ndarray]],
               rows_per_block: int = 1 << 20,
               dtype=torch.float64) -> torch.Tensor:
    """(N,) sum of the trees' leaf values, tree by tree over blocks of
    rows (one class).  ``dtype`` is the precision of the rows, the
    thresholds, the leaf values and the sum (float64 by default)."""
    out = torch.zeros(X.shape[0], dtype=dtype, device=X.device)
    for a in range(0, X.shape[0], rows_per_block):
        xb = X[a:a + rows_per_block].to(dtype)
        acc = torch.zeros(xb.shape[0], dtype=dtype, device=X.device)
        for t in trees:
            if dtype != torch.float64:
                t = dict(t, threshold=t["threshold"].astype(np.float32))
            lv = torch.as_tensor(t["leaf_value"], device=X.device,
                                 dtype=dtype)
            acc += lv[leaf_index(xb, t)]
        out[a:a + rows_per_block] = acc
    return out


def node_visits(X: torch.Tensor, trees: List[Dict[str, np.ndarray]],
                rows_per_block: int = 1 << 17) -> int:
    """Internal nodes that all rows of X pass through in all trees (the
    traversal's node visits)."""
    total = 0
    for t in trees:
        if t["num_leaves"] <= 1:
            continue
        depth = leaf_depths(t)
        d = torch.as_tensor(depth, device=X.device)
        for a in range(0, X.shape[0], rows_per_block):
            xb = X[a:a + rows_per_block].to(torch.float64)
            total += int(d[leaf_index(xb, t)].sum())
    return total


def leaf_depths(tree: Dict[str, np.ndarray]) -> np.ndarray:
    """Depth of every leaf (the root's children are at depth 1)."""
    L = tree["num_leaves"]
    if L <= 1:
        return np.zeros(1, dtype=np.int64)
    node_depth = np.zeros(L - 1, dtype=np.int64)
    out = np.zeros(L, dtype=np.int64)
    for i in range(L - 1):
        for c in (tree["left_child"][i], tree["right_child"][i]):
            if c >= 0:
                node_depth[c] = node_depth[i] + 1
            else:
                out[~c] = node_depth[i] + 1
    return out
