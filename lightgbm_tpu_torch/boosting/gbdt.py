"""Gradient boosting: K trees an iteration, (K, N) scores kept on the
device.

Port of the plain-GBDT path of lightgbm_tpu/boosting/gbdt.py
(train_one_iter: gradients per class or the caller's own, tree
growth, the leaf refit of the renewing objectives, score update from
the exit route's per-row leaf values or from each row's leaf,
validation scores through the binned tree walk; init scores and
boost_from_average; early stopping on the validation metrics and
rollback of the last iteration).  Bagging, DART, GOSS, RF and chunked
dispatch are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..learner.grower import TreeGrower
from ..metrics import Metric, create_metrics
from ..objectives import create_objective
from ..ops.histogram import leaf_value_broadcast
from ..ops.percentile import leaf_percentiles
from ..ops.predict import predict_binned
from ..tree import Tree
from ..utils.device import resolve_device
from ..utils.log import Log


def _score_rows(metadata, num_class: int, num_data: int,
                init_score: float) -> np.ndarray:
    """(K, N) f32 starting scores: the dataset's init score laid out
    class-major, plus the boost-from-average score."""
    base = np.zeros((num_class, num_data), dtype=np.float32)
    if metadata.init_score is not None:
        base += metadata.init_score.reshape(
            num_class, num_data).astype(np.float32)
    base += init_score
    return base


class _ValidSet:
    """Per-validation-set device state (the ScoreUpdater analog)."""

    def __init__(self, dataset: Dataset, num_class: int, init_score: float,
                 metrics: List[Metric], device: torch.device):
        self.bins = torch.from_numpy(np.ascontiguousarray(
            dataset.logical_group_bins())).to(device)
        self.scores = torch.from_numpy(_score_rows(
            dataset.metadata, num_class, dataset.num_data,
            init_score)).to(device)
        self.metrics = metrics


class GBDT:
    """Gradient Boosting Decision Tree trainer: K trees an iteration
    (K = 1 but for the multiclass objectives)."""

    def __init__(self, config: Config, train_set: Dataset,
                 custom_objective: bool = False):
        if config.boosting_type != "gbdt":
            raise NotImplementedError(
                f"boosting_type={config.boosting_type} is not ported yet")
        if config.bagging_freq > 0 and config.bagging_fraction < 1.0:
            raise NotImplementedError("bagging is not ported yet")
        if train_set.metadata.query_boundaries is not None:
            raise NotImplementedError(
                "query groups are not ported yet (lambdarank)")
        self.config = config
        self.device = resolve_device(config)
        self.train_set = train_set
        self.num_data = train_set.num_data
        # custom gradients (fobj) train without an objective
        self.objective = None if custom_objective else \
            create_objective(config)
        if self.objective is not None:
            self.objective.init(train_set.metadata, self.num_data,
                                self.device)
        self.num_class = config.num_tree_per_iteration
        self.shrinkage_rate = config.learning_rate
        self.grower = TreeGrower(train_set, config, self.device)
        self.models: List[Tree] = []
        # this session's trees as the grower built them (bin space, on
        # the device) and the shrinkage each was added with: what
        # rollback_one_iter subtracts
        self.device_trees: List[dict] = []
        self._tree_shrink: List[float] = []
        self.iter_ = 0
        self.train_metrics: List[Metric] = []
        self.valid_sets: List[_ValidSet] = []
        self.valid_names: List[str] = []

        # boost_from_average (reference gbdt.cpp:362-384): one class and
        # no init score only
        self.init_score = 0.0
        if (self.objective is not None and config.boost_from_average
                and self.num_class == 1
                and train_set.metadata.init_score is None):
            self.init_score = float(self.objective.boost_from_score())
        base = _score_rows(train_set.metadata, self.num_class,
                           self.num_data, self.init_score)
        self.scores = torch.from_numpy(np.stack(
            [self.grower.pad_rows(b) for b in base])).to(self.device)
        self._full_counts = torch.from_numpy(self.grower.pad_rows(
            np.ones(self.num_data, dtype=np.float32))).to(self.device)
        self._feat_rng = np.random.RandomState(config.feature_fraction_seed)
        # early stopping state per validation row of eval_metrics
        self._best_score: Dict[int, float] = {}
        self._best_iter: Dict[int, int] = {}
        self.best_iteration = -1

    # ------------------------------------------------------------------
    def add_valid(self, valid_set: Dataset, name: str) -> None:
        if valid_set.feature_infos() != self.train_set.feature_infos():
            Log.fatal(f"validation set {name!r} is not bin-aligned to "
                      "the training data — create it with "
                      "reference=<train dataset>")
        # storage-layout gate (lightgbm_tpu/boosting/gbdt.py:275-290):
        # equal feature_infos do not imply an equal matrix layout, since
        # the same data constructed under another bin_packing packs and
        # reorders its groups differently, and the validation rows are
        # scored with the TRAINING set's group map
        def _lay(ds):
            lay = getattr(ds, "bin_layout", None)
            return lay.to_state() if lay is not None else None
        if valid_set is not self.train_set and \
                _lay(valid_set) != _lay(self.train_set):
            Log.fatal(f"validation set {name!r} has a different bin-matrix "
                      f"storage layout ({_lay(valid_set)}) than the "
                      f"training data ({_lay(self.train_set)}) — construct "
                      "it with reference=<train dataset> or the same "
                      "bin_packing setting")
        metrics = create_metrics(self.config)
        for m in metrics:
            m.init(valid_set.metadata, valid_set.num_data, self.device)
        self.valid_sets.append(_ValidSet(valid_set, self.num_class,
                                         self.init_score, metrics,
                                         self.device))
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

    def _gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K, n_padded) gradients and hessians of the current scores,
        zero on padded rows (lightgbm_tpu/boosting/gbdt.py:304-325)."""
        s = self.scores[:, :self.num_data]
        if self.num_class == 1:
            g, h = self.objective.get_gradients(s[0])
            g, h = g[None, :], h[None, :]
        else:
            g, h = self.objective.get_gradients(s.t())
            g, h = g.t(), h.t()
        pad = self.grower.n_padded - self.num_data
        if pad:
            g = torch.nn.functional.pad(g, (0, pad))
            h = torch.nn.functional.pad(h, (0, pad))
        keep = self._full_counts > 0
        return g * keep, h * keep

    def _renew_leaf_values(self, tree, leaf_id: torch.Tensor,
                           k: int) -> None:
        """Re-fit the leaf values to the objective's percentile of the
        residuals in each leaf (RenewTreeOutput; lightgbm_tpu/boosting/
        gbdt.py:1255-1294), in place."""
        n = self.num_data
        obj = self.objective
        residual = obj._label_dev - self.scores[k, :n]
        if hasattr(obj, "_label_weight_dev"):
            w = obj._label_weight_dev          # MAPE's label weights
        else:
            w = obj._weight_dev
        # in-bag rows only: the rest take leaf -1 and are ignored
        lid = torch.where(self._full_counts[:n] > 0, leaf_id[:n],
                          torch.full_like(leaf_id[:n], -1))
        new_values = leaf_percentiles(residual, lid, self.config.num_leaves,
                                      obj.renew_alpha, w)
        tree["leaf_value"] = torch.where(tree["leaf_count"] > 0, new_values,
                                         tree["leaf_value"])

    def _custom_gradients(self, grad, hess
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The caller's (N,) or (N, K) host gradients as (K, n_padded)
        f32 on the device, zero on padded rows (lightgbm_tpu/boosting/
        gbdt.py _train_one_iter_custom: a flat buffer read class-major,
        as the reference's UpdateOneIterCustom reads it)."""
        pad = self.grower.n_padded - self.num_data

        def dev(a):
            a = np.asarray(a, dtype=np.float32).reshape(self.num_class,
                                                        self.num_data)
            return torch.from_numpy(np.pad(a, ((0, 0), (0, pad)))).to(
                self.device)
        keep = self._full_counts > 0
        return dev(grad) * keep, dev(hess) * keep

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration (reference gbdt.cpp:386-481): K trees
        on the gradients of the scores before the iteration, or on the
        caller's ``grad``/``hess`` (shape (N,) or (N, K); the custom
        objective path, lightgbm_tpu/boosting/gbdt.py:940-1000).
        Returns True when training must stop: no class's tree found a
        split."""
        if grad is not None and hess is not None:
            g, h = self._custom_gradients(grad, hess)
        elif self.objective is None:
            Log.fatal("No objective and no custom gradients")
        else:
            g, h = self._gradients()
        counts = self._full_counts
        shrink = torch.tensor(self.shrinkage_rate, dtype=torch.float32,
                              device=self.device)
        renew = (self.objective is not None
                 and self.objective.is_renew_tree_output)
        g_ = self.grower
        trees = []
        for k in range(self.num_class):
            tree, leaf_id, row_val = g_.train_tree(
                g[k], h[k], counts, self._feature_mask())
            if renew:
                self._renew_leaf_values(tree, leaf_id, k)
            # a tree that could not split contributes nothing (the
            # reference skips its score update, gbdt.cpp:427-460)
            ok = float(tree["num_leaves"] > 1)
            tree["leaf_value"] = tree["leaf_value"] * ok
            if row_val is not None and not renew:
                # the exit route carried each row's leaf value
                delta = row_val * ok * shrink
            else:
                delta = leaf_value_broadcast(leaf_id,
                                             tree["leaf_value"]) * shrink
            self.scores[k] += delta
            for vs in self.valid_sets:
                vs.scores[k] += self._predict_tree(tree, vs.bins) * shrink
            trees.append(tree)
        if max(t["num_leaves"] for t in trees) <= 1:
            # no class split: the iteration is dropped and training
            # stops at once (the JAX package finds it later and rolls
            # back, ROADMAP queue 3)
            Log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements.")
            return True
        for tree in trees:
            arrs = {key: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                          else v) for key, v in tree.items()}
            t = Tree.from_grower_arrays(arrs, self.train_set)
            t.apply_shrinkage(self.shrinkage_rate)
            if self.iter_ == 0 and self.init_score != 0.0:
                # fold the init score into the first iteration's tree
                # (gbdt.cpp:452-454)
                t.leaf_value += self.init_score
                t.internal_value += self.init_score
            self.models.append(t)
            self.device_trees.append(tree)
            self._tree_shrink.append(self.shrinkage_rate)
        self.iter_ += 1
        return False

    def _predict_tree(self, tree: dict, bins: torch.Tensor) -> torch.Tensor:
        """One grown tree's unshrunk leaf values of binned (N, G) rows."""
        g_ = self.grower
        return predict_binned(tree, bins, g_.f_group, g_.g2f_lut,
                              g_.f_missing, g_.f_default_bin, g_.f_num_bin)

    def rollback_one_iter(self) -> None:
        """Take the last iteration's K trees out of the model and their
        shrunk values out of the training and validation scores
        (lightgbm_tpu/boosting/gbdt.py:1367-1400; reference
        gbdt.cpp:483-499).  Trees of an ``init_model`` stay.  The
        fused plans keep only the transposed bins on the device: the
        training rows are walked through its transposed view, no
        second copy.  The f32 subtraction need not restore the old
        scores bit for bit."""
        if len(self.device_trees) < self.num_class:
            return
        g_ = self.grower
        bins = g_.bins if g_.bins is not None else g_.binsT.t()
        for k in reversed(range(self.num_class)):
            tree = self.device_trees.pop()
            shrink = self._tree_shrink.pop()
            self.models.pop()
            self.scores[k] += -shrink * self._predict_tree(tree, bins)
            for vs in self.valid_sets:
                vs.scores[k] += -shrink * self._predict_tree(tree, vs.bins)
        self.iter_ -= 1

    def check_early_stopping(self, results, iteration: int) -> bool:
        """Stop as soon as any validation metric has not improved for
        ``early_stopping_round`` iterations; ``best_iteration`` (1-based)
        comes from the metric that stopped it (lightgbm_tpu/boosting/
        gbdt.py:1331-1351; reference gbdt.cpp:582-639)."""
        rounds = self.config.early_stopping_round
        if rounds <= 0:
            return False
        for i, (dname, _mname, value, bigger) in enumerate(results):
            if dname == "training":
                continue
            score = value if bigger else -value
            if i not in self._best_score or score > self._best_score[i]:
                self._best_score[i] = score
                self._best_iter[i] = iteration
            elif iteration - self._best_iter[i] >= rounds:
                self.best_iteration = self._best_iter[i] + 1
                return True
        return False

    # ------------------------------------------------------------------
    def eval_metrics(self, which: str = "all"
                     ) -> List[Tuple[str, str, float, bool]]:
        """(dataset_name, metric_name, value, bigger_is_better) rows."""
        out = []
        if self.train_metrics and which in ("all", "train"):
            s = self._scores_for_eval(self.scores[:, :self.num_data])
            for m in self.train_metrics:
                for name, v in zip(m.names(), m.eval(s, self.objective)):
                    out.append(("training", name, v, m.bigger_is_better))
        if which in ("all", "valid"):
            for vs, vname in zip(self.valid_sets, self.valid_names):
                s = self._scores_for_eval(vs.scores)
                for m in vs.metrics:
                    for name, v in zip(m.names(), m.eval(s, self.objective)):
                        out.append((vname, name, v, m.bigger_is_better))
        return out

    def _scores_for_eval(self, scores: torch.Tensor) -> torch.Tensor:
        """(K, N) scores as the metrics take them: (N,), or (N, K)."""
        return scores[0] if self.num_class == 1 else scores.t()

    @property
    def num_trees(self) -> int:
        return len(self.models)


def create_boosting(config: Config, train_set: Dataset,
                    custom_objective: bool = False) -> GBDT:
    return GBDT(config, train_set, custom_objective=custom_objective)


__all__ = ["GBDT", "create_boosting"]
