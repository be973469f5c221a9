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

An objective-path iteration is one retried unit
(``reliability/retry.py retry_call`` behind the ``gbdt.train_one_iter``
fault seam, lightgbm_tpu/boosting/gbdt.py:836-876): its random draws
(iteration key, feature masks, bag) precede it, it keeps every tree
and score delta in locals, and the booster's state changes only once
the last class's tree has grown, so a retry trains the identical
iteration.  ``capture_state``/``restore_state`` carry the full training
state through a checkpoint as host objects.
"""
from __future__ import annotations

import time
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
from ..reliability.checkpoint import CheckpointError
from ..reliability.faults import FAULTS
from ..reliability.retry import RetryPolicy, retry_call
from ..telemetry import TELEMETRY
from ..tree import Tree
from ..utils import prng
from ..utils.device import resolve_device, rows_to_device
from ..utils.log import Log, PhaseTimer


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
                 custom_objective: bool = False, policy=None):
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
        # ``policy``: the data learner's row layout over an explicit mesh
        # (parallel/mesh.py ShardingPolicy); None builds it from config
        self.grower = TreeGrower(train_set, config, self.device,
                                 policy=policy)
        # multi-host (the device plane's finalize_global; JAX
        # gbdt.py:104-116): the row tensors below hold this rank's block
        # of the per-rank-padded global layout
        self._mh = self.grower._mh_local is not None
        if self._mh and self.objective is not None:
            if self.objective.is_renew_tree_output:
                Log.fatal(
                    "multi-host training does not support "
                    "RenewTreeOutput objectives (l1/huber/quantile/"
                    f"mape) yet — got {self.objective.name}; the "
                    "percentile refit needs a global sort across hosts")
            self.objective.repad_device_arrays(self._local_padded)
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
        self.scores = torch.stack([self._local_padded(b) for b in base])
        self._full_counts = self._local_padded(
            np.ones(self.num_data, dtype=np.float32))
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
        # the verdict of the last iteration (no class split: training
        # is over), which a checkpoint carries
        self._stopped = False
        self.timer = PhaseTimer()
        # trees kept since the last flush_models (its trees_flushed)
        self._unflushed = 0
        self._retry_policy = RetryPolicy.from_config(config)

    def _local_padded(self, arr: np.ndarray) -> torch.Tensor:
        """A global (N,) or (N, ...) row array as this process's padded
        rows on the device: padded to n_padded (per rank, multi-host)
        and, multi-host, cut to this rank's block."""
        g = self.grower
        return torch.from_numpy(np.ascontiguousarray(
            g.local_rows(g.pad_rows(np.asarray(arr))))).to(self.device)

    # ------------------------------------------------------------------
    def add_valid(self, valid_set: Dataset, name: str) -> None:
        if self._mh:
            Log.fatal("multi-host training does not support validation "
                      "sets yet (metric scores live sharded across "
                      "hosts) — evaluate after training instead")
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
        s = self.scores if scores is None else scores
        if not self._mh:
            s = s[:, :self.num_data]
        # multi-host the objective's arrays follow the per-rank padded
        # layout, so the gradients run full width (the padded rows'
        # values are zeroed below)
        if self.num_class == 1:
            g, h = self.objective.get_gradients(s[0])
            g, h = g[None, :], h[None, :]
        else:
            g, h = self.objective.get_gradients(s.t())
            g, h = g.t(), h.t()
        pad = self.grower.local_padded - g.shape[1]
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
        if self._mh:
            Log.fatal("multi-host training does not support custom "
                      "gradient functions yet (host gradients cannot "
                      "follow the sharded row layout)")
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
        # drawn over the global padded rows, so every rank cuts its
        # block of the one bag
        u = self.grower.local_rows(
            prng.uniform(key, (self.grower.n_padded,), self.device))
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
        tm = TELEMETRY
        t0 = time.perf_counter() if tm.on else 0.0
        self._before_boosting()
        self.timer.start("tree")
        cfg = self.config
        use_bag = self._use_bagging_fused()
        fresh_bag = use_bag and (self._bag_state is None
                                 or self.iter_ % cfg.bagging_freq == 0)
        bag = (self._full_counts > 0 if self._bag_state is None
               else self._bag_state)
        # the draws precede the retried unit, which keeps every result
        # in locals; a failed iteration restores the streams, so a
        # later call trains the identical iteration
        rng_snap = (self._iter_key_rng.get_state(),
                    self._feat_rng.get_state())
        key = prng.PRNGKey(int(self._iter_key_rng.randint(0, 2**31 - 1)))
        fmasks = [self._feature_mask() for _ in range(self.num_class)]
        kb, ks = prng.split(key)
        if fresh_bag:
            bag = self._draw_bag(kb)
        span = tm.start_span("boost_iter", iteration=self.iter_)

        def _iteration():
            FAULTS.fault_point("gbdt.train_one_iter")
            g, h = self._gradients()
            counts = bag.to(torch.float32) if use_bag \
                else self._full_counts
            if self._sample_active():
                g, h, counts = self._sample_rows_fused(g, h, counts, ks)
            g, h = self._mask_gradients(g, h, counts)
            qkeys = [None] * self.num_class
            if self._quant_stochastic():
                kq = prng.fold_in(key, 0x51AB)
                qkeys = [prng.fold_in(kq, k)
                         for k in range(self.num_class)]
            return self._grow_trees(g, h, counts, fmasks, qkeys)

        try:
            with tm.span("host_dispatch"):
                grown = retry_call(
                    self._dispatch_guard(_iteration, "gbdt.train_one_iter"),
                    policy=self._retry_policy, seam="gbdt.train_one_iter")
            if tm.on:
                tm.add("host_dispatch_ms", (time.perf_counter() - t0) * 1e3)
                tm.fence_ready(self.device)
                tm.add("trees_dispatched", self.num_class)
                tm.add("iterations", 1)
        except BaseException:
            self._iter_key_rng.set_state(rng_snap[0])
            self._feat_rng.set_state(rng_snap[1])
            self.timer.stop("tree")
            tm.end_span(span)
            raise
        tm.end_span(span)
        if tm.on and self.grower.policy.nproc > 1:
            # per-host step wall -> fleet max/min/mean + straggler ratio
            # through a tiny allgather (every process runs this loop in
            # lockstep, so the collective is safe here)
            from ..parallel.monitor import record_step_wall
            record_step_wall(time.perf_counter() - t0)
        self._bag_state = bag
        stop = self._commit_iteration(*grown)
        self.timer.stop("tree")
        if not stop:
            self._transport_epoch_tick()
        return stop

    def _transport_epoch_tick(self) -> None:
        """Elastic-membership epoch boundary (the WorldLedger protocol,
        parallel/transport.py; lightgbm_tpu/boosting/gbdt.py:903-935):
        with a TCP transport active, every ``transport_epoch_iters``
        completed iterations all participants tick the coordinator —
        dead peers retire (degraded continuation per
        ``sharded_allow_degraded``), and waiting joiners are admitted
        with this model's ``capture_state()`` as handoff (a joiner
        restoring it trains the exact iterations the world trains
        next).  Strictly BETWEEN iterations, so a collective can never
        race a membership change; with an unchanged world the tick is
        one tiny control round."""
        from ..parallel import transport as _transport
        tp = _transport.active()
        if tp is None or tp.world_size < 1:
            return
        if self.iter_ % max(1, tp.epoch_every) != 0:
            return

        def _handoff() -> bytes:
            import pickle as _pickle
            state, _stopped = self.capture_state()
            return _pickle.dumps(state, protocol=4)

        info = tp.epoch_tick(
            handoff=_handoff,
            allow_degraded=bool(getattr(self.config,
                                        "sharded_allow_degraded", False)))
        if info.get("changed"):
            Log.warning(
                f"transport epoch {info['epoch']}: world is now "
                f"{info['world_size']} (dead={info['dead']}, "
                f"admitted={info['admitted']}) — training continues "
                "on the reformed membership")

    def _dispatch_guard(self, fn, seam: str):
        """Bound the retried iteration by ``watchdog_dispatch_s``
        (lightgbm_tpu/boosting/gbdt.py _dispatch_guard): past the
        deadline the all-thread stacks are dumped and a classified
        ``StallError`` (transient) reaches ``retry_call``.  Disarmed (0,
        the default) this returns ``fn`` untouched."""
        wd = float(getattr(self.config, "watchdog_dispatch_s", 0.0) or 0.0)
        if wd <= 0:
            return fn
        from ..reliability.watchdog import run_with_deadline

        def _bounded():
            return run_with_deadline(fn, wd, phase="dispatch", seam=seam)
        return _bounded

    def _train_one_iter_custom(self, grad, hess) -> bool:
        """The caller's gradients (lightgbm_tpu/boosting/gbdt.py
        _train_one_iter_custom): the bag from ``_bagging_counts``, the
        GOSS sample from ``_sample_rows``, a rounding key a tree from
        ``_host_qkey``."""
        self._before_boosting()
        self.timer.start("boosting")
        g, h = self._custom_gradients(grad, hess)
        self.timer.stop("boosting")
        self.timer.start("bagging")
        counts = self._bagging_counts(self.iter_)
        g, h, counts = self._sample_rows(g, h, counts)
        g, h = self._mask_gradients(g, h, counts)
        self.timer.stop("bagging")
        self.timer.start("tree")
        fmasks, qkeys = [], []
        for k in range(self.num_class):
            fmasks.append(self._feature_mask())
            qkeys.append(self._host_qkey(k))
        stop = self._commit_iteration(*self._grow_trees(g, h, counts,
                                                        fmasks, qkeys))
        self.timer.stop("tree")
        if TELEMETRY.on:
            TELEMETRY.add("trees_dispatched", self.num_class)
            TELEMETRY.add("iterations", 1)
        if not stop:
            self._transport_epoch_tick()
        return stop

    def _grow_trees(self, g, h, counts, fmasks, qkeys):
        """Grow the iteration's K trees on the sampled gradients.
        Changes no state of the booster: returns the trees and each
        class's training and validation score deltas, which
        ``_commit_iteration`` adds."""
        shrink = torch.tensor(self.shrinkage_rate, dtype=torch.float32,
                              device=self.device)
        renew = (self.objective is not None
                 and self.objective.is_renew_tree_output)
        g_ = self.grower
        trees, deltas, valid_deltas = [], [], []
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
                deltas.append(row_val * ok * shrink)
            else:
                deltas.append(leaf_value_broadcast(
                    leaf_id, tree["leaf_value"]) * shrink)
            valid_deltas.append([self._predict_tree(tree, vs.bins) * shrink
                                 for vs in self.valid_sets])
            trees.append(tree)
        return trees, deltas, valid_deltas

    def _commit_iteration(self, trees, deltas, valid_deltas) -> bool:
        """Add an iteration's score deltas and keep its trees.  Returns
        True when training must stop: no class's tree found a split."""
        for k, (delta, vds) in enumerate(zip(deltas, valid_deltas)):
            self.scores[k] += delta
            for vs, vd in zip(self.valid_sets, vds):
                vs.scores[k] += vd
        if max(t["num_leaves"] for t in trees) <= 1:
            # no class split: the iteration is dropped and training
            # stops at once (the JAX package finds it later and rolls
            # back, ROADMAP queue 3); DART's renormalization of the
            # trees it dropped still runs, as in the JAX package
            self._after_iteration()
            Log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements.")
            self._stopped = True
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
        t = Tree.from_grower_arrays(self.grower.emit_tree_record(tree),
                                    self.train_set)
        t.apply_shrinkage(shrinkage)
        if bias != 0.0:
            t.leaf_value += bias
            t.internal_value += bias
        self.models.append(t)
        self.device_trees.append(tree)
        self._tree_shrink.append(shrinkage)
        self._tree_scale.append(1.0)
        self._applied_scale.append(1.0)
        self._unflushed += 1

    def flush_models(self) -> bool:
        """Multiply each model tree by the part of its DART scale not
        yet in it (lightgbm_tpu/boosting/gbdt.py flush_models, which
        the JAX package runs where the Booster reads its trees).
        Returns whether any tree changed.  The trees kept since the
        last flush count into ``trees_flushed`` under a ``model_flush``
        span, where the JAX package materializes its queued trees."""
        if self._unflushed:
            span = TELEMETRY.start_span("model_flush",
                                        entries=self._unflushed)
            TELEMETRY.add("trees_flushed", self._unflushed)
            self._unflushed = 0
            TELEMETRY.end_span(span)
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
        bins = self.grower.train_bins()
        for k in reversed(range(self.num_class)):
            tree = self.device_trees.pop()
            shrink = self._tree_shrink.pop()
            self.models.pop()
            self._tree_scale.pop()
            self._applied_scale.pop()
            self._unflushed = max(0, self._unflushed - 1)
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
    # crash-safe checkpointing (lightgbm_tpu/boosting/gbdt.py:1138-1240)
    def can_checkpoint(self) -> bool:
        """Whether full-state checkpointing covers this booster: plain
        GBDT and GOSS (their entire random state lives in the captured
        streams).  DART re-scales finished trees from host-side drop
        state and RF keeps running means of converted outputs; neither
        round-trips through capture_state, as in the JAX package."""
        return type(self).__name__ in ("GBDT", "GOSS") and not self._mh

    def capture_state(self) -> Tuple[dict, bool]:
        """Snapshot the full training state for a checkpoint, as host
        objects only (the device tensors copied back to numpy): the
        trees, the score rows, the bag and random streams and the
        early-stopping bookkeeping, everything a resumed run needs to
        grow byte-identical trees.  Returns (state, stopped), stopped
        being the last iteration's verdict (no class split)."""
        self.flush_models()

        def host(t):
            return None if t is None else t.cpu().numpy()
        state = {
            "iter_": self.iter_,
            "models": list(self.models),
            "tree_scale": list(self._tree_scale),
            "applied_scale": list(self._applied_scale),
            "tree_shrink": list(self._tree_shrink),
            # informational only: restore_state sets scale_offset to
            # len(models) (restored trees are host-only, like an
            # init_model's)
            "scale_offset": self._scale_offset,
            "shrinkage_rate": self.shrinkage_rate,
            "init_score": self.init_score,
            "scores": host(self.scores),
            "valid_scores": [host(vs.scores) for vs in self.valid_sets],
            "bag_state": host(self._bag_state),
            "bag_mask": host(self._bag_mask),
            # a key as the JAX package keeps it: two uint32 words
            "bag_rng": self._bag_rng.numpy().astype(np.uint32),
            "iter_key_rng": self._iter_key_rng.get_state(),
            "feat_rng": self._feat_rng.get_state(),
            "best_score": dict(self._best_score),
            "best_iter": dict(self._best_iter),
            "best_iteration": self.best_iteration,
            "num_class": self.num_class,
            "num_data": self.num_data,
            "n_padded": self.grower.n_padded,
            "num_valid": len(self.valid_sets),
        }
        if hasattr(self, "_goss_key"):          # GOSS host-path stream
            state["goss_key"] = self._goss_key.numpy().astype(np.uint32)
        return state, self._stopped

    def restore_state(self, state: dict) -> None:
        """Adopt a ``capture_state`` snapshot on a freshly constructed
        booster over the same dataset (the caller checked the
        fingerprint): the arrays go back to this booster's device in
        their dtype and layout.  Raises CheckpointError on a shape or
        identity mismatch rather than training on garbage."""
        if state.get("num_class") != self.num_class or \
                state.get("num_data") != self.num_data or \
                state.get("n_padded") != self.grower.n_padded or \
                state.get("num_valid") != len(self.valid_sets):
            raise CheckpointError(
                "checkpoint state does not match this training setup "
                f"(saved num_data={state.get('num_data')}/"
                f"num_class={state.get('num_class')}/padded="
                f"{state.get('n_padded')}/valid={state.get('num_valid')}"
                f" vs {self.num_data}/{self.num_class}/"
                f"{self.grower.n_padded}/{len(self.valid_sets)})")

        def dev(a, dtype):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(np.asarray(a, dtype))).to(self.device)
        self.iter_ = int(state["iter_"])
        # in place: Booster.models aliases this list
        self.models[:] = state["models"]
        self._tree_scale[:] = state["tree_scale"]
        self._applied_scale[:] = state["applied_scale"]
        self._tree_shrink[:] = state["tree_shrink"]
        # restored trees live on the host only, like an init_model's:
        # the in-session binned scan (device trees only) stands down
        self._scale_offset = len(self.models)
        self.shrinkage_rate = float(state["shrinkage_rate"])
        self.init_score = float(state["init_score"])
        self.scores = dev(state["scores"], np.float32)
        for vs, arr in zip(self.valid_sets, state["valid_scores"]):
            vs.scores = dev(arr, np.float32)
        self._bag_state = dev(state["bag_state"], bool)
        self._bag_mask = dev(state.get("bag_mask"), bool)
        self._bag_rng = torch.from_numpy(
            np.asarray(state["bag_rng"], np.uint32).astype(np.int64))
        self._iter_key_rng.set_state(state["iter_key_rng"])
        self._feat_rng.set_state(state["feat_rng"])
        self._best_score = dict(state["best_score"])
        self._best_iter = dict(state["best_iter"])
        self.best_iteration = int(state["best_iteration"])
        if "goss_key" in state and hasattr(self, "_goss_key"):
            self._goss_key = torch.from_numpy(
                np.asarray(state["goss_key"], np.uint32).astype(np.int64))
        self.device_trees = []
        self._unflushed = 0

    # ------------------------------------------------------------------
    def eval_metrics(self, which: str = "all"
                     ) -> List[Tuple[str, str, float, bool]]:
        """(dataset_name, metric_name, value, bigger_is_better) rows."""
        self.timer.start("metric")
        try:
            with TELEMETRY.span("eval_metrics"):
                return self._eval_metrics_impl(which)
        finally:
            self.timer.stop("metric")

    def _eval_metrics_impl(self, which: str):
        out = []
        if self.train_metrics and which in ("all", "train"):
            s = self._scores_for_eval(self._global_scores())
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

    def _global_scores(self) -> torch.Tensor:
        """The (K, N) training scores of every row: multi-host, the
        ranks' rows gathered in rank order over the host group (the
        metrics cover the global rows, as the JAX package's do)."""
        if not self._mh:
            return self.scores[:, :self.num_data]
        from ..parallel.distributed import _allgather
        local = self.scores[:, :self.grower._mh_local].cpu().numpy()
        got = _allgather(np.ascontiguousarray(local))     # (P, K, n_l)
        return torch.from_numpy(np.ascontiguousarray(np.concatenate(
            list(got), axis=1))).to(self.device)

    def _scores_for_eval(self, scores: torch.Tensor) -> torch.Tensor:
        """(K, N) scores as the metrics take them: (N,), or (N, K)."""
        return scores[0] if self.num_class == 1 else scores.t()

    @property
    def num_trees(self) -> int:
        return len(self.models)


__all__ = ["GBDT"]
