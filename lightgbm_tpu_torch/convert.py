"""Carry trained models across from the JAX package.

Both packages keep trees as the same struct of numpy arrays and write
the same model text, so moving a model needs no retraining:

* :func:`trees_from_jax` turns ``lightgbm_tpu`` ``Tree`` objects (or
  dicts of their fields) into port :class:`~lightgbm_tpu_torch.tree.Tree`
  objects;
* :func:`booster_from_jax` builds a port Booster from a ``lightgbm_tpu``
  Booster;
* :func:`level_ensemble_from_numpy` uploads ``tree.flatten_ensemble``'s
  numpy dict (from either package) as the port's LevelEnsemble tensors.

Nothing here imports the JAX package: the inputs are duck-typed.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from .ops.predict import level_ensemble_from_numpy  # noqa: F401
from .tree import Tree

_TREE_ARRAYS = {
    "split_feature": np.int32, "split_gain": np.float64,
    "threshold": np.float64, "decision_type": np.int32,
    "left_child": np.int32, "right_child": np.int32,
    "leaf_value": np.float64, "leaf_count": np.int64,
    "internal_value": np.float64, "internal_count": np.int64,
}


def _field(src: Any, name: str):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def trees_from_jax(models: Iterable[Any]) -> List[Tree]:
    """JAX-package trees (objects or dicts with the Tree fields) ->
    port Trees with copied arrays."""
    out = []
    for src in models:
        t = Tree(int(_field(src, "num_leaves")))
        for name, dt in _TREE_ARRAYS.items():
            setattr(t, name, np.array(_field(src, name), dtype=dt))
        t.shrinkage = float(_field(src, "shrinkage"))
        t.num_cat = int(_field(src, "num_cat"))
        t.cat_boundaries = [int(x) for x in _field(src, "cat_boundaries")]
        t.cat_threshold = [int(x) for x in _field(src, "cat_threshold")]
        out.append(t)
    return out


def booster_from_jax(jax_booster: Any,
                     params: Optional[Dict[str, Any]] = None):
    """A port Booster holding the trees, header and pandas category
    lists of a JAX-package Booster (``params`` sets the port booster's
    device)."""
    from .booster import Booster
    bst = Booster(params=params)
    for name in ("num_class", "num_tree_per_iteration", "max_feature_idx",
                 "objective_str", "average_output", "best_iteration"):
        setattr(bst, name, getattr(jax_booster, name))
    bst.feature_names = list(jax_booster.feature_names)
    bst.feature_infos = list(jax_booster.feature_infos)
    bst.models = trees_from_jax(jax_booster.models)
    cats = getattr(jax_booster, "pandas_categorical", None)
    bst.pandas_categorical = [list(c) for c in cats] if cats else None
    return bst
