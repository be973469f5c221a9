"""Training entry point: train().

Port of lightgbm_tpu/engine.py's train for this slice: validation sets
with the eval log (``verbose_eval``) and ``evals_result``.  Callbacks,
early stopping, checkpoints and continued training are not ported yet.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Optional, Sequence, Union

from .booster import Booster
from .config import PARAM_ALIASES, Config
from .dataset import Dataset
from .utils.log import Log


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          evals_result: Optional[dict] = None,
          verbose_eval: Union[bool, int] = True,
          keep_training_booster: bool = False) -> Booster:
    """Train a gradient-boosted model.  ``params["device"]`` is "cuda"
    by default (raises without a CUDA device) or "cpu" when asked.
    With ``keep_training_booster`` the returned booster keeps its
    training state (``booster.gbdt``), else it is released."""
    params = dict(params or {})
    has_num_iter = "num_iterations" in params or any(
        PARAM_ALIASES.get(str(k).lower()) == "num_iterations"
        for k in params)
    if not has_num_iter:
        params["num_iterations"] = num_boost_round
    config = Config.from_params(params)
    if config.early_stopping_round > 0:
        raise NotImplementedError("early stopping is not ported yet")
    num_boost_round = config.num_iterations
    Log.set_level(config.verbose)

    core_train = train_set.construct(config) \
        if hasattr(train_set, "construct") else train_set
    booster = Booster(config=config, train_set=core_train)
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
    for iteration in range(num_boost_round):
        if booster.gbdt.train_one_iter():
            break
        results = booster.gbdt.eval_metrics()
        if evals_result is not None:
            for dname, mname, value, _ in results:
                evals_result.setdefault(dname, collections.OrderedDict()) \
                    .setdefault(mname, []).append(value)
        if verbose_eval and results and eval_freq > 0 \
                and (iteration + 1) % eval_freq == 0:
            msg = "\t".join(f"{d}'s {m}: {v:g}" for d, m, v, _ in results)
            Log.info(f"[{iteration + 1}]\t{msg}")
    return booster if keep_training_booster else booster.free_dataset()
