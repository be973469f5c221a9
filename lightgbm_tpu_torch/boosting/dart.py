"""DART: Dropouts meet Multiple Additive Regression Trees.

Port of lightgbm_tpu/boosting/dart.py (reference src/boosting/
dart.hpp:26-201): before each iteration, drop earlier iterations with
a probability proportional to their weight (or uniform), take their
values out of the training scores (re-predicted over the training bins
by the binned walk), shrink the new trees by 1/(1+k), then put the
dropped trees back at k/(k+1) of their weight (or the xgboost mode's
k/(k+lr)).  Each tree's cumulative rescale is multiplied into its host
model where the JAX package multiplies it: at ``flush_models``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..config import Config
from ..dataset import Dataset
from .gbdt import GBDT


class DART(GBDT):
    def __init__(self, config: Config, train_set: Dataset, **kwargs):
        super().__init__(config, train_set, **kwargs)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []   # current weight an iteration
        self.sum_weight = 0.0
        self.drop_index: List[int] = []

    def _before_boosting(self) -> None:
        self._dropping_trees()

    def _dropping_trees(self) -> None:
        """reference dart.hpp:86-136 DroppingTrees."""
        cfg = self.config
        self.drop_index = []
        is_skip = self._drop_rng.rand() < cfg.skip_drop
        if not is_skip and self.iter_ > 0:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                inv_avg = len(self.tree_weight) / max(self.sum_weight, 1e-30)
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate,
                                    cfg.max_drop * inv_avg
                                    / max(self.sum_weight, 1e-30))
                for i in range(self.iter_):
                    if self._drop_rng.rand() < \
                            drop_rate * self.tree_weight[i] * inv_avg:
                        self.drop_index.append(i)
                        if len(self.drop_index) >= cfg.max_drop > 0:
                            break
            else:
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / self.iter_)
                for i in range(self.iter_):
                    if self._drop_rng.rand() < drop_rate:
                        self.drop_index.append(i)
                        if len(self.drop_index) >= cfg.max_drop > 0:
                            break
        # the dropped trees' values out of the training scores
        bins = self._train_bins() if self.drop_index else None
        for i in self.drop_index:
            w = self.tree_weight[i]
            for k in range(self.num_class):
                t = self.device_trees[i * self.num_class + k]
                self.scores[k] += -w * self._predict_tree(t, bins)
        k_drop = len(self.drop_index)
        lr = cfg.learning_rate
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = lr / (1.0 + k_drop)
        else:
            self.shrinkage_rate = lr if k_drop == 0 else lr / (lr + k_drop)

    def _after_iteration(self) -> None:
        """Put the dropped trees back at their new weight (reference
        dart.hpp:147-186) and record the new trees' weight."""
        cfg = self.config
        k = float(len(self.drop_index))
        bins = self._train_bins() if self.drop_index else None
        for i in self.drop_index:
            w = self.tree_weight[i]
            if not cfg.xgboost_dart_mode:
                new_w = w * (k / (k + 1.0))
            else:
                new_w = w * (k / (k + cfg.learning_rate))
            for ki in range(self.num_class):
                idx = i * self.num_class + ki
                t = self.device_trees[idx]
                self.scores[ki] += new_w * self._predict_tree(t, bins)
                for vs in self.valid_sets:
                    vs.scores[ki] += (new_w - w) * self._predict_tree(
                        t, vs.bins)
                scale = new_w / w if w != 0 else 0.0
                self._tree_scale[self._scale_offset + idx] *= scale
            if not cfg.uniform_drop:
                self.sum_weight -= w * (1.0 / (k + 1.0)
                                        if not cfg.xgboost_dart_mode
                                        else 1.0 / (k + cfg.learning_rate))
            self.tree_weight[i] = new_w
        self.tree_weight.append(self.shrinkage_rate)
        self.sum_weight += self.shrinkage_rate
