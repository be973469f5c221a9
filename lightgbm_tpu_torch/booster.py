"""Booster: the trained model — training session, prediction, model
text in and out.

Port of lightgbm_tpu/booster.py for this slice: the training side, the
device predictor over the ensemble level descent (kernel C; the JAX
package's _ServingPredictor without its lane pool, shape buckets and
OOM ladder), and save/load in the same model text format, so a model
saved by either package loads in the other.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .config import Config, canonical_objective
from .dataset import Dataset
from .ops.predict import (interleave_hi_lo, level_ensemble_from_numpy,
                          pack_level_records, predict_level_ensemble)
from .tree import Tree, flatten_ensemble
from .utils.device import resolve_device
from .utils.log import Log

MODEL_VERSION = "v2"

# rows per device dispatch of the predictor
_PREDICT_CHUNK_ROWS = 1 << 20


class _DevicePredictor:
    """One ensemble slice resident on a device as kernel C's node
    records, packed once; scores (n, F) raw features in row chunks."""

    def __init__(self, models: List[Tree], num_class: int,
                 device: torch.device):
        flat = flatten_ensemble(models, num_class)
        self.depth = int(flat.pop("depth"))
        self.records = pack_level_records(
            level_ensemble_from_numpy(flat, device))
        self.device = device
        self.num_class = max(num_class, 1)

    def __call__(self, data: np.ndarray) -> np.ndarray:
        n = data.shape[0]
        out = np.empty((n, self.num_class), np.float64)
        for s in range(0, n, _PREDICT_CHUNK_ROWS):
            x2 = torch.from_numpy(interleave_hi_lo(
                data[s:s + _PREDICT_CHUNK_ROWS])).to(self.device)
            out[s:s + x2.shape[0]] = predict_level_ensemble(
                self.records, x2, depth=self.depth).cpu().numpy()
        return out


def _objective_to_string(config: Config) -> str:
    """The model text's ``objective=`` value (lightgbm_tpu/booster.py
    _objective_to_string)."""
    o = config.objective
    if o == "binary":
        return f"binary sigmoid:{config.sigmoid:g}"
    if o in ("multiclass", "multiclassova"):
        s = f"{o} num_class:{config.num_class}"
        if o == "multiclassova":
            s += f" sigmoid:{config.sigmoid:g}"
        return s
    if o == "regression" and config.reg_sqrt:
        return "regression sqrt"
    return o


class Booster:
    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 config: Optional[Config] = None):
        self.config = config or Config.from_params(params or {})
        self.gbdt = None
        self.best_iteration = -1
        self.models: List[Tree] = []
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.max_feature_idx = 0
        self.objective_str = "regression"
        self.average_output = False
        self._predictor = None
        if model_file is not None:
            with open(model_file) as f:
                self._load_from_string(f.read())
            return
        if model_str is not None:
            self._load_from_string(model_str)
            return
        if train_set is None:
            return
        if hasattr(train_set, "construct") and callable(train_set.construct):
            train_set = train_set.construct(self.config)
        from .boosting import create_boosting
        self.gbdt = create_boosting(self.config, train_set)
        self.models = self.gbdt.models      # shared list, grows in place
        self.num_class = self.config.num_class
        self.num_tree_per_iteration = self.config.num_tree_per_iteration
        self.feature_names = train_set.feature_names
        self.feature_infos = train_set.feature_infos()
        self.max_feature_idx = train_set.num_total_features - 1
        self.objective_str = _objective_to_string(self.config)

    # ------------------------------------------------------------------
    def update(self) -> bool:
        if self.gbdt is None:
            Log.fatal("Cannot update: booster has no training session")
        self._predictor = None
        return self.gbdt.train_one_iter()

    @property
    def current_iteration(self) -> int:
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    def num_trees(self) -> int:
        return len(self.models)

    def num_feature(self) -> int:
        return self.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        return list(self.feature_names)

    def eval(self) -> List:
        return self.gbdt.eval_metrics() if self.gbdt else []

    def free_dataset(self) -> "Booster":
        """Release the training state (binned device matrix, scores);
        prediction keeps working, update() errors."""
        self.gbdt = None
        return self

    # ------------------------------------------------------------------
    def _used_models(self, num_iteration: int) -> List[Tree]:
        k = max(self.num_tree_per_iteration, 1)
        total = len(self.models)
        if num_iteration is None or num_iteration <= 0:
            num_iteration = self.best_iteration
        count = total if num_iteration <= 0 else min(total,
                                                     num_iteration * k)
        return self.models[:count]

    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False,
                pred_leaf: bool = False) -> np.ndarray:
        """Prediction on raw features.  Scores come from the device
        level descent (f32 accumulation; routing identical to the host
        walk through the two-float threshold compare) on the booster's
        device (``device`` in params: "cuda" by default, "cpu" when
        asked).  ``pred_leaf`` walks the trees on the host."""
        from .basic import _to_matrix
        data = _to_matrix(data)
        if data.ndim == 1:
            data = data[None, :]
        models = self._used_models(num_iteration)
        if pred_leaf:
            out = np.zeros((data.shape[0], len(models)), dtype=np.int32)
            for i, t in enumerate(models):
                out[:, i] = t.predict_leaf(data)
            return out
        k = max(self.num_tree_per_iteration, 1)
        if not models:
            raw = np.zeros((data.shape[0], k))
        else:
            key = len(models)
            if self._predictor is None or self._predictor[0] != key:
                self._predictor = (key, _DevicePredictor(
                    models, k, resolve_device(self.config)))
            raw = self._predictor[1](np.asarray(data, np.float64))
        if not raw_score:
            raw = self._convert_output(raw)
        return raw[:, 0] if k == 1 else raw

    def _convert_output(self, raw: np.ndarray) -> np.ndarray:
        """Raw scores -> outputs by the model's objective string
        (lightgbm_tpu/booster.py _convert_output): sigmoid for binary
        and multiclassova, softmax for multiclass, exp for the log-link
        objectives, the inverse of ``sqrt`` regression, and the
        cross-entropy links; any other objective returns the raw
        score."""
        obj = canonical_objective(self.objective_str.split()[0]
                                  if self.objective_str else "")
        if obj in ("binary", "multiclassova"):
            m = re.search(r"sigmoid:([0-9.eE+-]+)", self.objective_str)
            sig = float(m.group(1)) if m else 1.0
            return 1.0 / (1.0 + np.exp(-sig * raw))
        if obj == "multiclass":
            e = np.exp(raw - raw.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        if obj in ("poisson", "gamma", "tweedie"):
            return np.exp(raw)
        if obj == "regression" and "sqrt" in self.objective_str:
            return np.sign(raw) * raw * raw
        if obj == "cross_entropy":
            return 1.0 / (1.0 + np.exp(-raw))
        if obj == "cross_entropy_lambda":
            return np.log1p(np.exp(raw))
        return raw

    # ------------------------------------------------------------------
    def save_model(self, filename: str, num_iteration: int = -1) -> None:
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration))

    def model_to_string(self, num_iteration: int = -1) -> str:
        """reference gbdt_model_text.cpp:235-315 SaveModelToString."""
        models = self._used_models(num_iteration)
        out = ["tree", f"version={MODEL_VERSION}",
               f"num_class={self.num_class}",
               f"num_tree_per_iteration={self.num_tree_per_iteration}",
               "label_index=0",
               f"max_feature_idx={self.max_feature_idx}",
               f"objective={self.objective_str}"]
        if self.average_output:
            out.append("average_output")
        out.append("feature_names=" + " ".join(self.feature_names))
        out.append("feature_infos=" + " ".join(self.feature_infos))
        tree_strs = [f"Tree={i}\n{t.to_string()}\n"
                     for i, t in enumerate(models)]
        out.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        out.append("")
        text = "\n".join(out) + "\n" + "".join(tree_strs)
        imp = self.feature_importance("split", num_iteration)
        pairs = [(int(v), self.feature_names[i]) for i, v in enumerate(imp)
                 if v > 0]
        pairs.sort(key=lambda p: -p[0])
        text += "\nfeature importances:\n"
        for v, name in pairs:
            text += f"{name}={v}\n"
        return text

    def model_from_string(self, model_str: str) -> "Booster":
        """Replace this booster's model with one read from model text
        (either package's)."""
        self._load_from_string(model_str)
        return self

    def _load_from_string(self, text: str) -> None:
        """reference gbdt_model_text.cpp:317+ LoadModelFromString."""
        header, _, rest = text.partition("Tree=0")
        kv = {}
        for line in header.splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        self.num_class = int(kv.get("num_class", "1"))
        self.num_tree_per_iteration = int(
            kv.get("num_tree_per_iteration", "1"))
        self.max_feature_idx = int(kv.get("max_feature_idx", "0"))
        self.objective_str = kv.get("objective", "regression")
        self.feature_names = kv.get("feature_names", "").split()
        self.feature_infos = kv.get("feature_infos", "").split()
        self.average_output = "average_output" in header.splitlines()
        self.models = []
        self._predictor = None
        if not rest:
            return
        for block in re.split(r"Tree=\d+\n", "Tree=0" + rest):
            block = block.strip()
            if not block or block.startswith("feature importances"):
                continue
            block = block.split("\nfeature importances")[0]
            if "num_leaves" in block:
                self.models.append(Tree.from_string(block))

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        """reference gbdt.h FeatureImportance."""
        imp = np.zeros(self.max_feature_idx + 1, dtype=np.float64)
        for t in self._used_models(num_iteration):
            for i in range(t.num_leaves - 1):
                f = t.split_feature[i]
                imp[f] += 1 if importance_type == "split" \
                    else max(t.split_gain[i], 0.0)
        return imp
