"""RF: random forest mode.

Port of lightgbm_tpu/boosting/rf.py (reference src/boosting/
rf.hpp:18-180): gradients fixed once from zero scores, bagging and
``feature_fraction`` below 1 required, no shrinkage, leaf values
converted through the objective's output transform, and the tracked
scores the running mean of the trees' outputs.  The model text carries
``average_output``, so ``Booster.predict`` returns the mean.
"""
from __future__ import annotations

import torch

from ..config import Config
from ..dataset import Dataset
from ..ops.histogram import leaf_value_broadcast
from ..utils.log import Log
from .gbdt import GBDT


def _running_mean(total: torch.Tensor, t: float) -> torch.Tensor:
    """``total / (t + 1)`` as one f32 division (torch divides a CUDA
    tensor by a host scalar through its reciprocal)."""
    return total / torch.tensor(t + 1.0, dtype=torch.float32,
                                device=total.device)


class RF(GBDT):
    def __init__(self, config: Config, train_set: Dataset, **kwargs):
        super().__init__(config, train_set, **kwargs)
        if config.num_class > 1:
            Log.fatal("cannot use RF for multi-class")
        if not (config.bagging_freq > 0 and 0 < config.bagging_fraction < 1):
            Log.fatal("RF requires bagging "
                      "(bagging_freq > 0, bagging_fraction in (0,1))")
        if not (0 < config.feature_fraction < 1):
            Log.fatal("RF requires feature_fraction in (0, 1)")
        self.shrinkage_rate = 1.0
        self.average_output = True
        self.init_score = 0.0
        # fixed gradients from zero scores (reference rf.hpp:82-88)
        if self.objective is not None:
            self._fixed_g, self._fixed_h = self._gradients(
                torch.zeros_like(self.scores))

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One tree a class on the fixed gradients of this iteration's
        bag; the scores become the mean of the trees so far.  Custom
        gradients train as the JAX package's RF does: the plain
        custom-gradient iteration at shrinkage 1."""
        if grad is not None and hess is not None:
            return super().train_one_iter(grad, hess)
        counts = self._bagging_counts(self.iter_)
        g, h = self._mask_gradients(self._fixed_g, self._fixed_h, counts)
        t = float(self.iter_)
        for k in range(self.num_class):
            fmask = self._feature_mask()
            tree, leaf_id, _ = self.grower.train_tree(
                g[k], h[k], counts, fmask, qkey=self._host_qkey(k))
            if self.objective.is_renew_tree_output:
                self._renew_leaf_values(tree, leaf_id, k, counts)
            # leaf values in output space (reference rf.hpp
            # ConvertTreeOutput)
            tree["leaf_value"] = self.objective.convert_output(
                tree["leaf_value"])
            total = self.scores * t
            total[k] += leaf_value_broadcast(leaf_id, tree["leaf_value"])
            self.scores = _running_mean(total, t)
            for vs in self.valid_sets:
                vt = vs.scores * t
                vt[k] += self._predict_tree(tree, vs.bins)
                vs.scores = _running_mean(vt, t)
            self._keep_tree(tree, 1.0, 0.0)
        self.iter_ += 1
        return False

    def eval_metrics(self, which: str = "all"):
        """The scores are means of converted outputs already: the
        metrics take them without the objective's transform."""
        saved = self.objective
        self.objective = None
        try:
            return super().eval_metrics(which)
        finally:
            self.objective = saved
