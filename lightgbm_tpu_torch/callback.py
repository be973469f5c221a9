"""Training callbacks (port of lightgbm_tpu/callback.py; reference
python-package/lightgbm/callback.py).

Each callback receives the engine's ``_CallbackEnv`` (model, params,
iteration, end_iteration, evaluation_result_list) after every
iteration, or before it where ``before_iteration`` is set.
"""
from __future__ import annotations

import collections
from typing import Callable, List

from .engine import EarlyStopException
from .utils.log import Log


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Log the evaluation rows every ``period`` iterations."""
    def _callback(env):
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            msg = "\t".join(f"{d}'s {m}: {v:g}"
                            for d, m, v, _ in env.evaluation_result_list)
            Log.info(f"[{env.iteration + 1}]\t{msg}")
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: dict) -> Callable:
    """Append each evaluation row to ``eval_result[dataset][metric]``."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dict")
    eval_result.clear()

    def _callback(env):
        for dname, mname, value, _ in env.evaluation_result_list or []:
            eval_result.setdefault(dname, collections.OrderedDict()) \
                .setdefault(mname, []).append(value)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Before each iteration, set each parameter to its list's entry
    for the iteration or its callable's value of it; ``learning_rate``
    is the shrinkage of the next trees."""
    def _callback(env):
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration:
                    raise ValueError(
                        f"Length of list {key} has to be {env.end_iteration}")
                new_params[key] = value[env.iteration]
            elif callable(value):
                new_params[key] = value(env.iteration)
            else:
                raise ValueError(
                    "Only list and callable values are supported as a "
                    "parameter of reset_parameter")
        if "learning_rate" in new_params and env.model is not None:
            env.model.gbdt.shrinkage_rate = new_params["learning_rate"]
        if new_params:
            env.params.update(new_params)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Raise EarlyStopException once a validation metric has not
    improved for ``stopping_rounds`` iterations (only the first metric
    with ``first_metric_only``); training rows never stop it."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []

    def _init(env):
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            Log.info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds.")
        for _, _, _, bigger in env.evaluation_result_list:
            best_iter.append(0)
            if bigger:
                best_score.append(float("-inf"))
                cmp_op.append(lambda a, b: a > b)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda a, b: a < b)
            best_score_list.append(None)

    def _callback(env):
        if not best_score:
            _init(env)
        for i, (dname, _mname, value, _) in \
                enumerate(env.evaluation_result_list):
            if best_score_list[i] is None or cmp_op[i](value, best_score[i]):
                best_score[i] = value
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if dname == "training":
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    Log.info(f"Early stopping, best iteration is:"
                             f"[{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if first_metric_only:
                break
    _callback.order = 30
    return _callback


__all__ = ["print_evaluation", "record_evaluation", "reset_parameter",
           "early_stopping"]
