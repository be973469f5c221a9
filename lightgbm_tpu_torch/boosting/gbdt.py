"""Gradient boosting: K trees an iteration, (K, N) scores kept on the
device.

Port of the plain-GBDT path of lightgbm_tpu/boosting/gbdt.py
(train_one_iter: gradients per class or the caller's own, tree
growth, the leaf refit of the renewing objectives, score update from
the exit route's per-row leaf values or from each row's leaf,
validation scores through the binned tree walk; init scores and
boost_from_average; early stopping on the validation metrics and
rollback of the last iteration), with bagging and the random streams of
the JAX package drawn bit for bit (``utils/prng.py``): the per-iteration
key of the objective path, the bag stream of the custom-gradient path,
and the stochastic int8 rounding keys.  DART, GOSS and RF plug in
through the same hooks as in the JAX package (``_before_boosting``,
``_after_iteration``, ``_sample_rows``, ``_sample_rows_fused``,
``_sample_active``).  The JAX package's multi-iteration fused chunks
have no counterpart: each iteration is one host-driven step.
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
from ..utils import prng
from ..utils.device import resolve_device, rows_to_device
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
    """Per-validation-set device state (the ScoreUpdater analog): the
    set's (N, cols) storage matrix as it holds it (sub-byte under the
    training set's layout, which add_valid's gate guarantees) and its
    scores."""

    def __init__(self, dataset: Dataset, num_class: int, init_score: float,
                 metrics: List[Metric], device: torch.device):
        self.bins = rows_to_device(dataset.group_bins, device)
        self.scores = torch.from_numpy(_score_rows(
            dataset.metadata, num_class, dataset.num_data,
            init_score)).to(device)
        self.metrics = metrics


class GBDT:
    """Gradient Boosting Decision Tree trainer: K trees an iteration
    (K = 1 but for the multiclass objectives)."""

    def __init__(self, config: Config, train_set: Dataset,
                 custom_objective: bool = False):
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
        # DART's rescales: the cumulative scale of each model tree and
        # the scale already multiplied into it; flush_models() applies
        # the difference where the JAX package's flush does, so the
        # model text rounds the same.  Trees of an init_model come
        # first (_scale_offset of them).
        self._tree_scale: List[float] = []
        self._applied_scale: List[float] = []
        self._scale_offset = 0
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
        # the random streams (lightgbm_tpu/boosting/gbdt.py:146-148): one
        # iteration key a boosting iteration on the objective path (bag
        # draw, GOSS draw, stochastic rounding); a split of _bag_rng at
        # each fresh bag on the custom-gradient path and in RF
        self._bag_rng = prng.PRNGKey(config.bagging_seed)
        self._iter_key_rng = np.random.RandomState(config.bagging_seed)
        self._bag_mask = None      # custom path / RF: the current bag
        self._bag_state = None     # objective path: the current bag
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

    def _gradients(self, scores: torch.Tensor = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K, n_padded) gradients and hessians of ``scores`` (the
        current scores by default), zero on padded rows
        (lightgbm_tpu/boosting/gbdt.py:304-325)."""
        s = (self.scores if scores is None else scores)[:, :self.num_data]
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

    def _renew_leaf_values(self, tree, leaf_id: torch.Tensor, k: int,
                           counts: torch.Tensor) -> None:
        """Re-fit the leaf values to the objective's percentile of the
        residuals of the in-bag rows in each leaf (RenewTreeOutput;
        lightgbm_tpu/boosting/gbdt.py:1255-1294), in place."""
        n = self.num_data
        obj = self.objective
        residual = obj._label_dev - self.scores[k, :n]
        if hasattr(obj, "_label_weight_dev"):
            w = obj._label_weight_dev          # MAPE's label weights
        else:
            w = obj._weight_dev
        # in-bag rows only: the rest take leaf -1 and are ignored
        lid = torch.where(counts[:n] > 0, leaf_id[:n],
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

    # ------------------------------------------------------------------
    # row sampling and the random streams
    def _bagging_counts(self, iteration: int):
        """The bag of the custom-gradient path and RF: a fresh mask from
        a split of ``_bag_rng`` every ``bagging_freq`` iterations
        (lightgbm_tpu/boosting/gbdt.py:327-339), as 0/1 counts."""
        cfg = self.config
        if cfg.bagging_freq <= 0 or cfg.bagging_fraction >= 1.0:
            return self._full_counts
        if iteration % cfg.bagging_freq == 0 or self._bag_mask is None:
            self._bag_rng, sub = prng.split(self._bag_rng)
            self._bag_mask = self._draw_bag(sub)
        return self._bag_mask.to(torch.float32)

    def _draw_bag(self, key):
        """A bag from ``key``: the rows whose uniform falls below
        ``bagging_fraction``, padding rows left out."""
        u = prng.uniform(key, (self.grower.n_padded,), self.device)
        return (u < self.config.bagging_fraction) & (self._full_counts > 0)

    def _use_bagging_fused(self) -> bool:
        """Whether the objective path draws a bag (GOSS replaces
        bagging)."""
        cfg = self.config
        return cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0

    def _mask_gradients(self, g, h, counts):
        """Zero the gradients of the rows out of the bag (row weights
        are inside the objective's gradients already)."""
        mask = counts > 0
        return g * mask, h * mask

    def _quant_stochastic(self) -> bool:
        """Whether the int8 weights round stochastically:
        ``quant_stochastic_rounding`` 1/0, or with -1 (auto) the
        objective's ``need_stochastic_quant`` (lambdarank)."""
        if not self.grower.plan.quant:
            return False
        mode = int(getattr(self.config, "quant_stochastic_rounding", -1))
        if mode >= 0:
            return bool(mode)
        return (self.objective is not None
                and getattr(self.objective, "need_stochastic_quant", False))

    def _host_qkey(self, class_idx: int):
        """The stochastic-rounding key of a tree on the custom-gradient
        path and in RF: its own draw of ``_iter_key_rng``
        (lightgbm_tpu/boosting/gbdt.py:447-455)."""
        if not self._quant_stochastic():
            return None
        seed = int(self._iter_key_rng.randint(0, 2**31 - 1))
        return prng.fold_in(prng.PRNGKey(seed), class_idx)

    # hooks for DART/GOSS/RF ------------------------------------------
    def _before_boosting(self) -> None:
        """Before the gradients (DART drops trees here)."""

    def _after_iteration(self) -> None:
        """After the iteration's trees are in (DART renormalizes)."""

    def _sample_rows(self, g, h, counts):
        """Row sampling of the custom-gradient path (GOSS)."""
        return g, h, counts

    def _sample_rows_fused(self, g, h, counts, key):
        """Row sampling of the objective path, from the iteration
        key's second half (GOSS)."""
        return g, h, counts

    def _sample_active(self) -> bool:
        """Whether _sample_rows_fused samples this iteration."""
        return False

    # ------------------------------------------------------------------
    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration (reference gbdt.cpp:386-481): K trees
        on the gradients of the scores before the iteration, or on the
        caller's ``grad``/``hess`` (shape (N,) or (N, K); the custom
        objective path, lightgbm_tpu/boosting/gbdt.py:940-1000).
        Returns True when training must stop: no class's tree found a
        split.

        The objective path follows the JAX package's fused step
        (lightgbm_tpu/boosting/gbdt.py:479-530, :806-835): one
        ``randint`` of ``_iter_key_rng`` keys the iteration; the first
        half of ``split(key)`` draws the bag (fresh on the first
        iteration and every ``bagging_freq``), the second GOSS's
        sample, and ``fold_in(fold_in(key, 0x51AB), k)`` rounds class
        k's int8 weights when rounding is stochastic."""
        if grad is not None and hess is not None:
            return self._train_one_iter_custom(grad, hess)
        if self.objective is None:
            Log.fatal("No objective and no custom gradients")
        self._before_boosting()
        cfg = self.config
        use_bag = self._use_bagging_fused()
        fresh_bag = use_bag and (self._bag_state is None
                                 or self.iter_ % cfg.bagging_freq == 0)
        if self._bag_state is None:
            self._bag_state = self._full_counts > 0
        key = prng.PRNGKey(int(self._iter_key_rng.randint(0, 2**31 - 1)))
        fmasks = [self._feature_mask() for _ in range(self.num_class)]
        g, h = self._gradients()
        kb, ks = prng.split(key)
        if use_bag:
            if fresh_bag:
                self._bag_state = self._draw_bag(kb)
            counts = self._bag_state.to(torch.float32)
        else:
            counts = self._full_counts
        if self._sample_active():
            g, h, counts = self._sample_rows_fused(g, h, counts, ks)
        g, h = self._mask_gradients(g, h, counts)
        qkeys = [None] * self.num_class
        if self._quant_stochastic():
            kq = prng.fold_in(key, 0x51AB)
            qkeys = [prng.fold_in(kq, k) for k in range(self.num_class)]
        return self._grow_iteration(g, h, counts, fmasks, qkeys)

    def _train_one_iter_custom(self, grad, hess) -> bool:
        """The caller's gradients (lightgbm_tpu/boosting/gbdt.py
        _train_one_iter_custom): the bag from ``_bagging_counts``, the
        GOSS sample from ``_sample_rows``, a rounding key a tree from
        ``_host_qkey``."""
        self._before_boosting()
        g, h = self._custom_gradients(grad, hess)
        counts = self._bagging_counts(self.iter_)
        g, h, counts = self._sample_rows(g, h, counts)
        g, h = self._mask_gradients(g, h, counts)
        fmasks, qkeys = [], []
        for k in range(self.num_class):
            fmasks.append(self._feature_mask())
            qkeys.append(self._host_qkey(k))
        return self._grow_iteration(g, h, counts, fmasks, qkeys)

    def _grow_iteration(self, g, h, counts, fmasks, qkeys) -> bool:
        """Grow the iteration's K trees on the sampled gradients, add
        them to the training and validation scores, and keep them."""
        shrink = torch.tensor(self.shrinkage_rate, dtype=torch.float32,
                              device=self.device)
        renew = (self.objective is not None
                 and self.objective.is_renew_tree_output)
        g_ = self.grower
        trees = []
        for k in range(self.num_class):
            tree, leaf_id, row_val = g_.train_tree(
                g[k], h[k], counts, fmasks[k], qkey=qkeys[k])
            if renew:
                self._renew_leaf_values(tree, leaf_id, k, counts)
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
            # back, ROADMAP queue 3); DART's renormalization of the
            # trees it dropped still runs, as in the JAX package
            self._after_iteration()
            Log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements.")
            return True
        for tree in trees:
            self._keep_tree(tree, self.shrinkage_rate,
                            self.init_score if self.iter_ == 0 else 0.0)
        self._after_iteration()
        self.iter_ += 1
        return False

    def _keep_tree(self, tree: dict, shrinkage: float, bias: float) -> None:
        """Add a grown tree to the model: host text form, shrunk, with
        ``bias`` (the init score of the first iteration, gbdt.cpp:
        452-454) folded in; the device form stays for DART and
        rollback."""
        arrs = {key: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                      else v) for key, v in tree.items()}
        t = Tree.from_grower_arrays(arrs, self.train_set)
        t.apply_shrinkage(shrinkage)
        if bias != 0.0:
            t.leaf_value += bias
            t.internal_value += bias
        self.models.append(t)
        self.device_trees.append(tree)
        self._tree_shrink.append(shrinkage)
        self._tree_scale.append(1.0)
        self._applied_scale.append(1.0)

    def flush_models(self) -> bool:
        """Multiply each model tree by the part of its DART scale not
        yet in it (lightgbm_tpu/boosting/gbdt.py flush_models, which
        the JAX package runs where the Booster reads its trees).
        Returns whether any tree changed."""
        changed = False
        for i, t in enumerate(self.models):
            if self._applied_scale[i] != self._tree_scale[i]:
                r = self._tree_scale[i] / self._applied_scale[i]
                t.leaf_value *= r
                t.internal_value *= r
                t.shrinkage *= r
                self._applied_scale[i] = self._tree_scale[i]
                changed = True
        return changed

    def add_foreign_trees(self, models: List[Tree]) -> None:
        """An init_model's trees, ahead of this session's."""
        self.models.extend(models)
        self._tree_scale.extend([1.0] * len(models))
        self._applied_scale.extend([1.0] * len(models))
        self._scale_offset += len(models)

    def _train_bins(self) -> torch.Tensor:
        """The training rows' (n_padded, cols) storage bins: the fused
        plans keep only the transposed matrix, walked through its
        transposed view."""
        g_ = self.grower
        return g_.bins if g_.bins is not None else g_.binsT.t()

    def _predict_tree(self, tree: dict, bins: torch.Tensor) -> torch.Tensor:
        """One grown tree's unshrunk leaf values of binned rows, stored in
        the training set's layout ((N, cols), the grower's pack spec)."""
        g_ = self.grower
        return predict_binned(tree, bins, g_.f_group, g_.g2f_lut,
                              g_.f_missing, g_.f_default_bin, g_.f_num_bin,
                              g_.pack_P)

    def rollback_one_iter(self) -> None:
        """Take the last iteration's K trees out of the model and their
        shrunk values out of the training and validation scores
        (lightgbm_tpu/boosting/gbdt.py:1367-1400; reference
        gbdt.cpp:483-499).  Trees of an ``init_model`` stay.  The f32
        subtraction need not restore the old scores bit for bit."""
        if len(self.device_trees) < self.num_class:
            return
        bins = self._train_bins()
        for k in reversed(range(self.num_class)):
            tree = self.device_trees.pop()
            shrink = self._tree_shrink.pop()
            self.models.pop()
            self._tree_scale.pop()
            self._applied_scale.pop()
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


__all__ = ["GBDT"]
