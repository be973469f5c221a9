"""Gradient boosting: one tree per iteration, scores kept on the device.

Port of the plain-GBDT path of lightgbm_tpu/boosting/gbdt.py
(train_one_iter: gradients, tree growth, score update from the exit
route's per-row leaf values or, on the plans without one, from each
row's leaf, validation scores through the binned tree walk).  Bagging, DART, GOSS, RF, custom objectives and chunked dispatch
are not ported yet.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..learner.grower import TreeGrower
from ..metrics import Metric, create_metrics
from ..objectives import create_objective
from ..ops.histogram import leaf_value_broadcast
from ..ops.predict import predict_binned
from ..tree import Tree
from ..utils.device import resolve_device
from ..utils.log import Log


class _ValidSet:
    """Per-validation-set device state (the ScoreUpdater analog)."""

    def __init__(self, dataset: Dataset, init_score: float,
                 metrics: List[Metric], device: torch.device):
        self.bins = torch.from_numpy(np.ascontiguousarray(
            dataset.logical_group_bins())).to(device)
        self.scores = torch.full((dataset.num_data,), init_score,
                                 dtype=torch.float32, device=device)
        self.metrics = metrics


class GBDT:
    """Gradient Boosting Decision Tree trainer (binary objective)."""

    def __init__(self, config: Config, train_set: Dataset):
        if config.boosting_type != "gbdt":
            raise NotImplementedError(
                f"boosting_type={config.boosting_type} is not ported yet")
        if config.bagging_freq > 0 and config.bagging_fraction < 1.0:
            raise NotImplementedError("bagging is not ported yet")
        if train_set.metadata.init_score is not None:
            raise NotImplementedError("init_score is not ported yet")
        self.config = config
        self.device = resolve_device(config)
        self.train_set = train_set
        self.num_data = train_set.num_data
        self.objective = create_objective(config)
        self.objective.init(train_set.metadata, self.num_data, self.device)
        self.shrinkage_rate = config.learning_rate
        self.grower = TreeGrower(train_set, config, self.device)
        self.models: List[Tree] = []
        self.iter_ = 0
        self.train_metrics: List[Metric] = []
        self.valid_sets: List[_ValidSet] = []
        self.valid_names: List[str] = []

        self.init_score = 0.0
        if config.boost_from_average:
            self.init_score = float(self.objective.boost_from_score())
        base = np.full(self.num_data, self.init_score, dtype=np.float32)
        self.scores = torch.from_numpy(self.grower.pad_rows(base)).to(
            self.device)
        self._full_counts = torch.from_numpy(self.grower.pad_rows(
            np.ones(self.num_data, dtype=np.float32))).to(self.device)
        self._feat_rng = np.random.RandomState(config.feature_fraction_seed)

    # ------------------------------------------------------------------
    def add_valid(self, valid_set: Dataset, name: str) -> None:
        if valid_set.feature_infos() != self.train_set.feature_infos():
            Log.fatal(f"validation set {name!r} is not bin-aligned to "
                      "the training data — create it with "
                      "reference=<train dataset>")
        metrics = create_metrics(self.config)
        for m in metrics:
            m.init(valid_set.metadata, valid_set.num_data, self.device)
        self.valid_sets.append(_ValidSet(valid_set, self.init_score,
                                         metrics, self.device))
        self.valid_names.append(name)

    def add_train_metrics(self) -> None:
        self.train_metrics = create_metrics(self.config)
        for m in self.train_metrics:
            m.init(self.train_set.metadata, self.num_data, self.device)

    # ------------------------------------------------------------------
    def _feature_mask(self) -> torch.Tensor:
        """Per-tree feature sampling (reference serial_tree_learner.cpp
        252-345 BeforeTrain), drawn on the host."""
        f = self.config.feature_fraction
        F = self.grower.num_features
        mask = np.ones(F, dtype=bool)
        if f < 1.0:
            used = max(1, int(round(F * f)))
            mask[:] = False
            mask[self._feat_rng.choice(F, size=used, replace=False)] = True
        return torch.from_numpy(mask).to(self.device)

    def train_one_iter(self) -> bool:
        """One boosting iteration (reference gbdt.cpp:386-481).  Returns
        True when training must stop (the tree found no split)."""
        g, h = self.objective.get_gradients(self.scores[:self.num_data])
        pad = self.grower.n_padded - self.num_data
        if pad:
            g = torch.nn.functional.pad(g, (0, pad))
            h = torch.nn.functional.pad(h, (0, pad))
        counts = self._full_counts
        keep = counts > 0
        g, h = g * keep, h * keep
        tree, leaf_id, row_val = self.grower.train_tree(
            g, h, counts, self._feature_mask())
        if tree["num_leaves"] <= 1:
            # a no-split tree contributes nothing; the reference stops
            # here (gbdt.cpp:427-460) and so does the JAX package's
            # deferred check, which drops the tree
            Log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements.")
            return True
        shrink = torch.tensor(self.shrinkage_rate, dtype=torch.float32,
                              device=self.device)
        if row_val is None:
            # plans without a fused exit route: look each row's leaf
            # value up (lightgbm_tpu/boosting/gbdt.py:517-523)
            row_val = leaf_value_broadcast(leaf_id, tree["leaf_value"])
        self.scores = self.scores + row_val * shrink
        g_ = self.grower
        for vs in self.valid_sets:
            pv = predict_binned(tree, vs.bins, g_.f_group, g_.g2f_lut,
                                g_.f_missing, g_.f_default_bin,
                                g_.f_num_bin)
            vs.scores = vs.scores + pv * shrink
        arrs = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in tree.items()}
        t = Tree.from_grower_arrays(arrs, self.train_set)
        t.apply_shrinkage(self.shrinkage_rate)
        if self.iter_ == 0 and self.init_score != 0.0:
            # fold the init score into the first tree (gbdt.cpp:452-454)
            t.leaf_value += self.init_score
            t.internal_value += self.init_score
        self.models.append(t)
        self.iter_ += 1
        return False

    # ------------------------------------------------------------------
    def eval_metrics(self, which: str = "all"
                     ) -> List[Tuple[str, str, float, bool]]:
        """(dataset_name, metric_name, value, bigger_is_better) rows."""
        out = []
        if self.train_metrics and which in ("all", "train"):
            s = self.scores[:self.num_data]
            for m in self.train_metrics:
                for name, v in zip(m.names(), m.eval(s, self.objective)):
                    out.append(("training", name, v, m.bigger_is_better))
        if which in ("all", "valid"):
            for vs, vname in zip(self.valid_sets, self.valid_names):
                for m in vs.metrics:
                    for name, v in zip(m.names(),
                                       m.eval(vs.scores, self.objective)):
                        out.append((vname, name, v, m.bigger_is_better))
        return out

    @property
    def num_trees(self) -> int:
        return len(self.models)


def create_boosting(config: Config, train_set: Dataset,
                    custom_objective: bool = False) -> GBDT:
    if custom_objective:
        raise NotImplementedError("custom objectives are not ported yet")
    return GBDT(config, train_set)


__all__ = ["GBDT", "create_boosting"]
