"""Training entry points: train() and cv().

Port of lightgbm_tpu/engine.py: validation sets with the eval log
(``verbose_eval``) and ``evals_result``, callbacks, early stopping (by
parameter, argument or callback), custom ``fobj``/``feval``,
``learning_rates``, continued training from ``init_model``, and k-fold
cross-validation.  The JAX package's multi-iteration fused chunks (and
their OOM ladder) have no counterpart here: the port dispatches one
iteration at a time.  Checkpoints, snapshots and ``resume`` are not
ported yet.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .booster import Booster
from .config import PARAM_ALIASES, Config
from .dataset import Dataset
from .utils.log import Log


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          init_model: Optional[Union[str, Booster]] = None,
          feature_name: Union[str, Sequence[str]] = "auto",
          categorical_feature: Union[str, Sequence] = "auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None,
          verbose_eval: Union[bool, int] = True,
          learning_rates: Optional[Union[Sequence[float],
                                         Callable]] = None,
          keep_training_booster: bool = False,
          callbacks: Optional[Sequence[Callable]] = None) -> Booster:
    """Train a gradient-boosted model (lightgbm_tpu/engine.py train,
    without ``resume``).  ``params["device"]`` is "cuda" by default
    (raises without a CUDA device) or "cpu" when asked.

    ``fobj(scores, train_set) -> (grad, hess)`` replaces the objective;
    ``feval(scores, train_set)`` adds ``("feval", name, value,
    bigger_is_better)`` rows to the evaluation; ``learning_rates`` (a
    list or a callable of the iteration) is a ``reset_parameter``
    callback; ``init_model`` (a path or a Booster) seeds the training
    scores with its raw predictions and precedes the new trees.  With
    early stopping ``best_iteration`` is the best validation iteration,
    else -1.  With ``keep_training_booster`` the returned booster keeps
    its training state (``booster.gbdt``), else it is released."""
    params = dict(params or {})
    if feature_name != "auto" and hasattr(train_set, "set_feature_name"):
        train_set.set_feature_name(feature_name)
    if categorical_feature != "auto" \
            and hasattr(train_set, "set_categorical_feature"):
        train_set.set_categorical_feature(categorical_feature)
    if learning_rates is not None:
        from .callback import reset_parameter
        callbacks = list(callbacks or []) + [
            reset_parameter(learning_rate=learning_rates)]
    if early_stopping_rounds is not None and not any(
            k in params for k in ("early_stopping_round",
                                  "early_stopping_rounds", "early_stopping")):
        params["early_stopping_round"] = early_stopping_rounds
    has_num_iter = "num_iterations" in params or any(
        PARAM_ALIASES.get(str(k).lower()) == "num_iterations"
        for k in params)
    if not has_num_iter:
        params["num_iterations"] = num_boost_round
    config = Config.from_params(params)
    num_boost_round = config.num_iterations
    Log.set_level(config.verbose)

    core_train = train_set.construct(config) \
        if hasattr(train_set, "construct") else train_set
    booster = Booster(config=config, train_set=core_train,
                      init_model=init_model,
                      custom_objective=fobj is not None)
    names = list(valid_names or [])
    valid_sets = list(valid_sets or [])
    while len(names) < len(valid_sets):
        names.append(f"valid_{len(names)}")
    for vs, name in zip(valid_sets, names):
        if vs is train_set or vs is core_train:
            booster.gbdt.add_train_metrics()
            continue
        # validation sets bin with the training mappers
        core = (vs.construct_aligned(core_train, config)
                if hasattr(vs, "construct_aligned") else vs)
        booster.gbdt.add_valid(core, name)
    if config.is_training_metric and not booster.gbdt.train_metrics:
        booster.gbdt.add_train_metrics()

    eval_freq = (verbose_eval if isinstance(verbose_eval, int)
                 and not isinstance(verbose_eval, bool)
                 else config.output_freq)
    if evals_result is not None:
        evals_result.clear()
    callbacks = list(callbacks or [])
    stopped_early = False
    for iteration in range(num_boost_round):
        for cb in callbacks:
            if getattr(cb, "before_iteration", False):
                cb(_CallbackEnv(booster, params, iteration,
                                num_boost_round, None))
        if fobj is not None:
            grad, hess = fobj(booster._current_train_scores(), core_train)
            stop = booster.gbdt.train_one_iter(grad, hess)
        else:
            stop = booster.gbdt.train_one_iter()
        if stop:
            break
        results = booster.gbdt.eval_metrics()
        if feval is not None:
            fr = feval(booster._current_train_scores(), core_train)
            if fr is not None:
                for name, val, bigger in (fr if isinstance(fr, list)
                                          else [fr]):
                    results.append(("feval", name, val, bigger))
        if evals_result is not None:
            for dname, mname, value, _ in results:
                evals_result.setdefault(dname, collections.OrderedDict()) \
                    .setdefault(mname, []).append(value)
        if verbose_eval and results and eval_freq > 0 \
                and (iteration + 1) % eval_freq == 0:
            msg = "\t".join(f"{d}'s {m}: {v:g}" for d, m, v, _ in results)
            Log.info(f"[{iteration + 1}]\t{msg}")
        env = _CallbackEnv(booster, params, iteration, num_boost_round,
                           list(results))
        for cb in callbacks:
            if not getattr(cb, "before_iteration", False):
                try:
                    cb(env)
                except EarlyStopException as e:
                    booster.best_iteration = e.best_iteration + 1
                    stopped_early = True
        if stopped_early:
            break
        if booster.gbdt.check_early_stopping(results, iteration):
            booster.best_iteration = booster.gbdt.best_iteration
            Log.info(f"Early stopping at iteration {iteration + 1}, best "
                     f"iteration is {booster.best_iteration}")
            stopped_early = True
            break
    if not stopped_early:
        booster.best_iteration = -1
    booster._sync_models()
    return booster if keep_training_booster else booster.free_dataset()


class EarlyStopException(Exception):
    """Raised by a callback to end training; ``best_iteration`` is
    0-based (lightgbm_tpu/engine.py EarlyStopException)."""

    def __init__(self, best_iteration: int, best_score=None):
        super().__init__(best_iteration)
        self.best_iteration = best_iteration
        self.best_score = best_score


_CallbackEnv = collections.namedtuple(
    "LightGBMCallbackEnv",
    ["model", "params", "iteration", "end_iteration",
     "evaluation_result_list"])


class CVBooster:
    """The folds' boosters (lightgbm_tpu/engine.py CVBooster): a method
    called on it is called on every fold's booster and returns the
    list of results."""

    def __init__(self, boosters=None):
        self.boosters = list(boosters or [])
        self.best_iteration = -1

    def _append(self, booster):
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs)
                    for b in self.boosters]
        return handler


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, early_stopping_rounds=None, seed: int = 0,
       callbacks=None, verbose_eval=None,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """K-fold cross-validation (lightgbm_tpu/engine.py cv).  The folds
    come from ``np.random.RandomState(seed)`` as in the JAX package
    (stratified by label for the classification objectives); each fold
    is binned anew from the raw rows and trained with ``params``
    (``device`` included) against its held-out rows.  Returns the
    ``<metric>-mean`` and ``<metric>-stdv`` lists over the folds, and
    ``cvbooster`` with ``return_cvbooster``.  ``init_model`` and
    ``callbacks`` are accepted and not used, as in the JAX package."""
    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    config = Config.from_params(params)
    # the raw rows, before construct may free them: each fold is binned
    # anew from them
    lazy_data = getattr(train_set, "data", None)
    if hasattr(train_set, "construct"):
        train_set = train_set.construct(config)
    label = train_set.metadata.label
    n = train_set.num_data
    rng = np.random.RandomState(seed)

    if folds is None:
        idx = np.arange(n)
        if stratified and config.objective in ("binary", "multiclass",
                                               "multiclassova"):
            folds = _stratified_folds(label, nfold, rng, shuffle)
        else:
            if shuffle:
                rng.shuffle(idx)
            folds = [(np.setdiff1d(idx, idx[i::nfold], assume_unique=False),
                      idx[i::nfold]) for i in range(nfold)]

    raw = train_set._raw_data
    if raw is None and lazy_data is not None:
        from .basic import _is_sparse, _to_matrix
        raw = (lazy_data.tocsr() if _is_sparse(lazy_data)
               else _to_matrix(lazy_data))
    if raw is None:
        Log.fatal("cv requires the Dataset's raw data: pass an in-memory "
                  "matrix, or construct it with free_raw_data=False")
    if hasattr(raw, "tocsr"):
        raw = raw.tocsr()             # row slices

    weight = train_set.metadata.weight
    results: Dict[str, List[float]] = collections.defaultdict(list)
    boosters = []
    fold_evals = []
    for train_idx, test_idx in folds:
        dtrain = Dataset.from_matrix(
            raw[train_idx], label=label[train_idx],
            weight=None if weight is None else weight[train_idx],
            config=config,
            categorical_features=train_set._categorical_features)
        dtest = Dataset.from_matrix(
            raw[test_idx], label=label[test_idx],
            weight=None if weight is None else weight[test_idx],
            config=config, reference=dtrain)
        er: dict = {}
        bst = train(params, dtrain, num_boost_round, valid_sets=[dtest],
                    valid_names=["valid"], fobj=fobj, feval=feval,
                    early_stopping_rounds=early_stopping_rounds,
                    evals_result=er, verbose_eval=False,
                    keep_training_booster=True)
        boosters.append(bst)
        fold_evals.append(er.get("valid", {}))

    if fold_evals and fold_evals[0]:
        num_iters = min(len(next(iter(fe.values()))) for fe in fold_evals)
        for mname in fold_evals[0]:
            for i in range(num_iters):
                vals = [fe[mname][i] for fe in fold_evals]
                results[f"{mname}-mean"].append(float(np.mean(vals)))
                results[f"{mname}-stdv"].append(float(np.std(vals)))
    out = dict(results)
    if return_cvbooster:
        cvb = CVBooster(boosters)
        cvb.best_iteration = max((b.best_iteration for b in boosters),
                                 default=-1)
        out["cvbooster"] = cvb
    return out


def _stratified_folds(label, nfold, rng, shuffle):
    """Each class's rows, shuffled by ``rng``, dealt to the folds in
    turn (lightgbm_tpu/engine.py _stratified_folds)."""
    classes = np.unique(label)
    fold_test = [[] for _ in range(nfold)]
    for c in classes:
        idx = np.nonzero(label == c)[0]
        if shuffle:
            rng.shuffle(idx)
        for i in range(nfold):
            fold_test[i].append(idx[i::nfold])
    folds = []
    all_idx = np.arange(len(label))
    for i in range(nfold):
        test = np.concatenate(fold_test[i])
        folds.append((np.setdiff1d(all_idx, test), test))
    return folds
