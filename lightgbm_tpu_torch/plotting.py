"""Plotting utilities (port of lightgbm_tpu/plotting.py; reference: python-package/lightgbm/plotting.py:
plot_importance :22, plot_metric :131, plot_tree/create_tree_digraph
:387).  matplotlib/graphviz are optional imports, mirroring the
reference's compat gating: neither is imported until a plot is asked
for.
"""
from __future__ import annotations

from typing import Optional

import numpy as np



def _check_matplotlib():
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        raise ImportError("You must install matplotlib to plot")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim=None, ylim=None, title="Feature importance",
                    xlabel="Feature importance", ylabel="Features",
                    importance_type="split", max_num_features=None,
                    ignore_zero=True, figsize=None, grid=True, **kwargs):
    plt = _check_matplotlib()
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    importance = booster.feature_importance(importance_type)
    names = booster.feature_names
    tuples = sorted(zip(names, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [t for t in tuples if t[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("cannot plot importance; no nonzero importances")
    labels, values = zip(*tuples)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, str(int(x) if importance_type == "split"
                              else round(x, 2)), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster_or_record, metric: Optional[str] = None,
                dataset_names=None, ax=None, xlim=None, ylim=None,
                title="Metric during training", xlabel="Iterations",
                ylabel="auto", figsize=None, grid=True):
    plt = _check_matplotlib()
    if isinstance(booster_or_record, dict):
        eval_results = booster_or_record
    elif hasattr(booster_or_record, "evals_result_"):
        eval_results = booster_or_record.evals_result_
    else:
        raise TypeError("booster_or_record must be a dict of eval results "
                        "or a fitted LGBMModel")
    if not eval_results:
        raise ValueError("eval results are empty")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    names = dataset_names or list(eval_results.keys())
    metric_name = metric
    for name in names:
        metrics = eval_results[name]
        if metric_name is None:
            metric_name = next(iter(metrics))
        if metric_name not in metrics:
            continue
        values = metrics[metric_name]
        ax.plot(range(1, len(values) + 1), values, label=name)
    ax.legend(loc="best")
    if title:
        ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(metric_name if ylabel == "auto" else ylabel)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        name=None, comment=None, **kwargs):
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("You must install graphviz to plot tree")
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    if getattr(booster, 'gbdt', None) is not None:
        booster._sync_models()
    if tree_index >= len(booster.models):
        raise IndexError("tree_index is out of range")
    tree = booster.models[tree_index]
    show_info = show_info or []
    graph = Digraph(name=name, comment=comment, **kwargs)

    def add(node, parent=None, decision=None):
        if node < 0:
            leaf = -node - 1
            name_ = f"leaf{leaf}"
            label = f"leaf {leaf}: {tree.leaf_value[leaf]:g}"
            if "leaf_count" in show_info:
                label += f"\ncount: {tree.leaf_count[leaf]}"
            graph.node(name_, label=label)
        else:
            name_ = f"split{node}"
            feat = tree.split_feature[node]
            fname = (booster.feature_names[feat]
                     if feat < len(booster.feature_names)
                     else f"Column_{feat}")
            label = f"{fname}"
            if tree.decision_type[node] & 1:
                label += " in categories"
            else:
                label += f" <= {tree.threshold[node]:g}"
            if "split_gain" in show_info:
                label += f"\ngain: {tree.split_gain[node]:g}"
            if "internal_count" in show_info:
                label += f"\ncount: {tree.internal_count[node]}"
            graph.node(name_, label=label)
            add(tree.left_child[node], name_, "yes")
            add(tree.right_child[node], name_, "no")
        if parent is not None:
            graph.edge(parent, name_, decision)

    add(0 if tree.num_leaves > 1 else -1)
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None,
              show_info=None, **kwargs):
    plt = _check_matplotlib()
    try:
        import io
        from PIL import Image
    except ImportError:
        raise ImportError("You must install PIL to plot tree")
    graph = create_tree_digraph(booster, tree_index, show_info, **kwargs)
    s = graph.pipe(format="png")
    img = Image.open(io.BytesIO(s))
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ax.imshow(img)
    ax.axis("off")
    return ax
