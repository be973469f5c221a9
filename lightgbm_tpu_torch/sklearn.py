"""scikit-learn estimator wrappers (port of lightgbm_tpu/sklearn.py).

The estimators train and predict on the CUDA device unless
``device="cpu"`` is passed among their keyword parameters.  Without
scikit-learn installed they keep working on plain base classes.

Mirrors the reference sklearn API (reference:
python-package/lightgbm/sklearn.py:127 LGBMModel, :599 LGBMRegressor,
:629 LGBMClassifier, :739 LGBMRanker, plus the custom objective/eval
function adapters at :17-126).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from .basic import Dataset
from .booster import Booster
from .engine import train as _train
from .utils.log import Log

try:  # sklearn integration is optional (reference compat.py gating)
    from sklearn.base import (BaseEstimator as _SKBase,
                              ClassifierMixin as _SKClassifier,
                              RegressorMixin as _SKRegressor)
except ImportError:  # pragma: no cover
    _SKBase = object

    class _SKClassifier:  # type: ignore
        pass

    class _SKRegressor:  # type: ignore
        pass


class _ObjectiveFunctionWrapper:
    """Adapts sklearn-style fobj(y_true, y_pred) -> (grad, hess)
    (reference sklearn.py:17-77)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.metadata.label[:dataset.num_data]
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds,
                                   dataset.metadata.get_field("group"))
        else:
            raise TypeError(f"Self-defined objective takes 2 or 3 "
                            f"arguments, got {argc}")
        return grad, hess


class _EvalFunctionWrapper:
    """Adapts sklearn-style feval (reference sklearn.py:78-126)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.metadata.label[:dataset.num_data]
        argc = self.func.__code__.co_argcount
        if argc == 3:
            return [self.func(labels, preds)]
        if argc == 4:
            return [self.func(labels, preds, dataset.metadata.weight)]
        raise TypeError("Self-defined eval function takes 3 or 4 arguments")


class LGBMModel(_SKBase):
    """Base estimator (reference sklearn.py:127-598)."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=100,
                 subsample_for_bin=200000, objective=None, class_weight=None,
                 min_split_gain=0.0, min_child_weight=1e-3,
                 min_child_samples=20, subsample=1.0, subsample_freq=0,
                 colsample_bytree=1.0, reg_alpha=0.0, reg_lambda=0.0,
                 random_state=None, n_jobs=-1, silent=True,
                 importance_type="split", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._n_features = None
        self._classes = None
        self._n_classes = None
        self._evals_result = None
        self._best_iteration = -1
        self._best_score: Dict[str, Dict[str, float]] = {}
        self._objective = objective

    # -- sklearn protocol -------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {k: getattr(self, k) for k in (
            "boosting_type", "num_leaves", "max_depth", "learning_rate",
            "n_estimators", "subsample_for_bin", "objective", "class_weight",
            "min_split_gain", "min_child_weight", "min_child_samples",
            "subsample", "subsample_freq", "colsample_bytree", "reg_alpha",
            "reg_lambda", "random_state", "n_jobs", "silent",
            "importance_type")}
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for k, v in params.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self._other_params[k] = v
        return self

    # ---------------------------------------------------------------------
    def _default_objective(self) -> str:
        return "regression"

    def _build_params(self) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbose": -1 if self.silent else 1,
        }
        if self.random_state is not None:
            params["seed"] = int(self.random_state)
        obj = self.objective
        if obj is None or callable(obj):
            params["objective"] = self._default_objective()
        else:
            params["objective"] = obj
        params.update(self._other_params)
        return params

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_group=None, eval_metric=None,
            early_stopping_rounds=None, verbose=False, callbacks=None):
        params = self._build_params()
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        fobj = _ObjectiveFunctionWrapper(self.objective) \
            if callable(self.objective) else None
        feval = _EvalFunctionWrapper(eval_metric) \
            if callable(eval_metric) else None

        y_fit = self._process_label(np.asarray(y))
        train_set = Dataset(X, label=y_fit, weight=sample_weight,
                            group=group, init_score=init_score,
                            categorical_feature=self._other_params.get(
                                "categorical_feature", "auto"))
        valid_sets = []
        valid_names = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    vw = (eval_sample_weight or {}).get(i) \
                        if isinstance(eval_sample_weight, dict) \
                        else (eval_sample_weight[i]
                              if eval_sample_weight else None)
                    vg = (eval_group[i] if eval_group else None)
                    valid_sets.append(train_set.create_valid(
                        vx, label=self._process_label(np.asarray(vy)),
                        weight=vw, group=vg))
                valid_names.append((eval_names or {}).get(i)
                                   if isinstance(eval_names, dict)
                                   else (eval_names[i] if eval_names
                                         else f"valid_{i}"))
        evals_result: Dict = {}
        self._Booster = _train(
            params, train_set,
            num_boost_round=self.n_estimators,
            valid_sets=valid_sets, valid_names=valid_names,
            fobj=fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result, verbose_eval=verbose,
            callbacks=callbacks)
        self._evals_result = evals_result
        self._best_iteration = self._Booster.best_iteration
        # best_score_ (reference sklearn.py): per-dataset per-metric
        # value at the best iteration (last iteration when no early
        # stopping fired)
        self._best_score: Dict[str, Dict[str, float]] = {}
        at = (self._best_iteration - 1) if self._best_iteration and \
            self._best_iteration > 0 else -1
        for dname, metrics in evals_result.items():
            self._best_score[dname] = {
                mname: vals[at] for mname, vals in metrics.items()
                if vals}
        self._n_features = train_set.num_feature()
        # sklearn's check_is_fitted detects fitted state from instance
        # attributes with a trailing underscore
        self.n_features_in_ = self._n_features
        return self

    def _process_label(self, y):
        return y

    def predict(self, X, raw_score=False, num_iteration=None,
                pred_leaf=False, pred_contrib=False, **kwargs):
        """Extra keyword arguments (e.g. ``device=True`` to force the
        bucketed device predictor for serving-shaped micro-batches)
        forward to Booster.predict."""
        if self._Booster is None:
            raise RuntimeError("Estimator not fitted")
        return self._Booster.predict(
            X, num_iteration=num_iteration or -1, raw_score=raw_score,
            pred_leaf=pred_leaf, pred_contrib=pred_contrib, **kwargs)

    # -- attributes -------------------------------------------------------
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise RuntimeError("No booster found; call fit first")
        return self._Booster

    @property
    def best_iteration_(self):
        return self._best_iteration

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def feature_importances_(self):
        return self.booster_.feature_importance(self.importance_type)

    @property
    def n_features_(self):
        return self._n_features

    @property
    def best_score_(self):
        """reference sklearn.py: {dataset: {metric: value}} at the
        best iteration."""
        if self._Booster is None:
            raise RuntimeError("No booster found; call fit first")
        return self._best_score

    @property
    def objective_(self):
        """reference sklearn.py: the concrete objective used to fit."""
        if self._Booster is None:
            raise RuntimeError("No booster found; call fit first")
        return self.objective if self.objective is not None \
            else self._default_objective()

    def apply(self, X, num_iteration=None):
        """reference sklearn.py LGBMModel.apply: predicted leaf index
        of every tree for every sample."""
        if self._Booster is None:
            raise RuntimeError("Estimator not fitted")
        return self._Booster.predict(X, num_iteration=num_iteration
                                     or -1, pred_leaf=True)


class LGBMRegressor(_SKRegressor, LGBMModel):
    # mixin first: sklearn's __sklearn_tags__/estimator_type resolution
    # walks the MRO and the mixin must precede the BaseEstimator subclass
    def _default_objective(self):
        return "regression"


class LGBMClassifier(_SKClassifier, LGBMModel):
    def _default_objective(self):
        if self._n_classes is not None and self._n_classes > 2:
            return "multiclass"
        return "binary"

    def fit(self, X, y, **kwargs):
        y = np.asarray(y)
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        if self._n_classes > 2 and not callable(self.objective) \
                and (self.objective is None
                     or self.objective in ("multiclass", "multiclassova",
                                           "softmax", "ova", "ovr")):
            self._other_params.setdefault("num_class", self._n_classes)
        return super().fit(X, y, **kwargs)

    def _process_label(self, y):
        lut = {c: i for i, c in enumerate(self._classes)}
        return np.asarray([lut[v] for v in y], dtype=np.float64)

    def predict(self, X, raw_score=False, num_iteration=None,
                pred_leaf=False, pred_contrib=False, **kwargs):
        result = self.predict_proba(X, raw_score, num_iteration,
                                    pred_leaf, pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        idx = np.argmax(result, axis=1)
        return self._classes[idx]

    def predict_proba(self, X, raw_score=False, num_iteration=None,
                      pred_leaf=False, pred_contrib=False, **kwargs):
        result = super().predict(X, raw_score, num_iteration, pred_leaf,
                                 pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:   # binary: (n,) prob of positive class
            return np.column_stack([1.0 - result, result])
        return result

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes


class LGBMRanker(LGBMModel):
    def _default_objective(self):
        return "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        return super().fit(X, y, group=group, **kwargs)
