"""Booster: the trained model — training session, prediction, model
text in and out.

Port of lightgbm_tpu/booster.py for this slice: the training side
(continued training from ``init_model``, custom gradients, rollback,
validation sets, refit), the device predictor over the ensemble level
descent (kernel C; the JAX package's _ServingPredictor without its lane
pool, shape buckets and OOM ladder), sparse input in dense row chunks,
and save/load in the same model text format, so a model saved by
either package loads in the other.
"""
from __future__ import annotations

import copy
import json
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
                 config: Optional[Config] = None,
                 init_model=None, custom_objective: bool = False):
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
        self.pandas_categorical = None
        self._train_data_name = "training"
        self._attrs: Dict[str, str] = {}
        self._datasets_freed = False
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
        self.gbdt = create_boosting(self.config, train_set,
                                    custom_objective=custom_objective)
        self.models = self.gbdt.models      # shared list, grows in place
        self.num_class = self.config.num_class
        self.num_tree_per_iteration = self.config.num_tree_per_iteration
        self.feature_names = train_set.feature_names
        self.feature_infos = train_set.feature_infos()
        self.max_feature_idx = train_set.num_total_features - 1
        self.pandas_categorical = getattr(train_set, "pandas_categorical",
                                          None)
        self.objective_str = _objective_to_string(self.config)
        self.average_output = getattr(self.gbdt, "average_output", False)
        if init_model is not None:
            base = (Booster(model_file=init_model,
                            params={"device": self.config.device})
                    if isinstance(init_model, str) else init_model)
            self._continue_from(base, train_set)

    def _continue_from(self, base: "Booster", train_set: Dataset) -> None:
        """Continued training (lightgbm_tpu/booster.py _continue_from):
        the base model's raw scores of the training rows, through
        kernel C on this booster's device, are added to the starting
        scores (on top of boost_from_average, as the JAX package does),
        and its trees precede the new ones.  Multiclass scores are laid
        out class-major by a transpose (the JAX package reshapes the
        (N, K) prediction instead, ROADMAP queue 3)."""
        raw = train_set._raw_data
        if raw is None:
            Log.fatal("Continued training (init_model) requires raw "
                      "data on the Dataset — construct it with "
                      "free_raw_data=False")
        base._sync_models()
        pred = base._on_device(self.config.device).predict(
            raw, raw_score=True)
        pred = pred.reshape(1, -1) if pred.ndim == 1 else pred.T
        g = self.gbdt
        pad = g.grower.n_padded - train_set.num_data
        g.scores += torch.from_numpy(np.pad(
            pred.astype(np.float32), ((0, 0), (0, pad)))).to(g.device)
        g.add_foreign_trees(base.models)

    def _on_device(self, device: str) -> "Booster":
        """This booster, or a shallow copy that predicts on ``device``."""
        if self.config.device == device:
            return self
        other = copy.copy(self)
        other.config = copy.copy(self.config)
        other.config.device = device
        other.gbdt = None
        other._predictor = None
        return other

    # ------------------------------------------------------------------
    def _require_session(self, what: str) -> None:
        if self.gbdt is None:
            Log.fatal(f"Cannot {what}: booster has no training session "
                      "(file-loaded model or datasets were freed)")

    def update(self, train_set=None, fobj=None) -> bool:
        """One iteration; with ``fobj`` its (grad, hess) of the current
        training scores replace the objective's (lightgbm_tpu/
        booster.py update).  True when training must stop."""
        self._require_session("update")
        self._predictor = None
        if fobj is not None:
            grad, hess = fobj(self._current_train_scores(),
                              self.gbdt.train_set)
            return self.gbdt.train_one_iter(grad, hess)
        return self.gbdt.train_one_iter()

    def rollback_one_iter(self) -> "Booster":
        self._require_session("rollback")
        self.gbdt.rollback_one_iter()
        self._predictor = None
        return self

    def _current_train_scores(self) -> np.ndarray:
        """The training rows' raw scores, (N,) or class-major (K * N,)."""
        s = self.gbdt.scores[:, :self.gbdt.num_data].cpu().numpy()
        return s[0] if self.num_tree_per_iteration == 1 else s.reshape(-1)

    @property
    def current_iteration(self) -> int:
        return self.gbdt.iter_ if self.gbdt else \
            len(self.models) // max(self.num_tree_per_iteration, 1)

    def _sync_models(self) -> None:
        """Bring the host trees up to date with the training session's
        DART rescales (lightgbm_tpu/booster.py _sync_models: the JAX
        package flushes where the model is read, and so does the port,
        so both round the same)."""
        if self.gbdt is not None and self.gbdt.flush_models():
            self._predictor = None

    def num_trees(self) -> int:
        self._sync_models()
        return len(self.models)

    def num_feature(self) -> int:
        return self.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        return list(self.feature_names)

    # ------------------------------------------------------------------
    def eval(self) -> List:
        if self.gbdt is None:
            return []
        out = self.gbdt.eval_metrics()
        if self._train_data_name != "training":
            k = sum(len(m.names()) for m in self.gbdt.train_metrics)
            out = [(self._train_data_name, m, v, b) if i < k
                   else (d, m, v, b)
                   for i, (d, m, v, b) in enumerate(out)]
        return out

    def eval_train(self) -> List:
        """The training set's metric rows only."""
        if self.gbdt is None:
            if self._datasets_freed:
                Log.fatal("Booster datasets were freed (free_dataset) "
                          "— cannot evaluate training metrics")
            return []
        if not self.gbdt.train_metrics:
            self.gbdt.add_train_metrics()
        return [(self._train_data_name, m, v, b)
                for _d, m, v, b in self.gbdt.eval_metrics("train")]

    def eval_valid(self) -> List:
        """The validation sets' metric rows only."""
        return self.gbdt.eval_metrics("valid") if self.gbdt else []

    def add_valid(self, data, name: str) -> "Booster":
        """Add a validation set; a lazy one is bin-aligned to the
        training data first (lightgbm_tpu/booster.py add_valid)."""
        self._require_session("add validation data")
        if hasattr(data, "construct_aligned"):
            data = data.construct_aligned(self.gbdt.train_set, self.config)
        self.gbdt.add_valid(data, name)
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """``learning_rate`` for the next trees, and plain config
        scalars (lightgbm_tpu/booster.py reset_parameter)."""
        if "learning_rate" in params and self.gbdt is not None:
            self.gbdt.shrinkage_rate = float(params["learning_rate"])
        for k, v in params.items():
            if k != "learning_rate" and hasattr(self.config, k):
                cur = getattr(self.config, k)
                try:
                    if isinstance(cur, bool):
                        setattr(self.config, k, str(v).lower()
                                in ("1", "true", "yes", "on"))
                    else:
                        setattr(self.config, k, type(cur)(v))
                except (TypeError, ValueError):
                    pass
        return self

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        self._sync_models()
        return float(self.models[int(tree_id)].leaf_value[int(leaf_id)])

    def attr(self, key: str) -> Optional[str]:
        return self._attrs.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        """String attributes; a value of None deletes the key."""
        for k, v in kwargs.items():
            if v is None:
                self._attrs.pop(k, None)
            else:
                self._attrs[k] = str(v)
        return self

    def free_dataset(self) -> "Booster":
        """Release the training state (binned device matrix, scores);
        prediction keeps working, update() errors."""
        if self.gbdt is not None:
            self._sync_models()
            self.best_iteration = max(self.best_iteration,
                                      self.gbdt.best_iteration)
            self.gbdt = None
            self._datasets_freed = True
        return self

    # ------------------------------------------------------------------
    def _used_models(self, num_iteration: int) -> List[Tree]:
        self._sync_models()
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
        asked).  ``pred_leaf`` walks the trees on the host.  A scipy
        sparse matrix goes through in dense row chunks of at most
        128 MB, narrowed to the columns the used trees split on where
        that halves the width (lightgbm_tpu/booster.py:562-590).  A
        model with ``average_output`` (random forest) returns the mean
        over its iterations, with no output transform.  A pandas
        frame's category columns encode against the training frame's
        categories (``pandas_categorical``); an unseen category is
        NaN."""
        from .basic import _is_sparse, _to_matrix
        if _is_sparse(data):
            return self._predict_sparse(data, num_iteration, raw_score,
                                        pred_leaf)
        data = _to_matrix(data, self.pandas_categorical)
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
            raw = self._predictor[1](data)
        if self.average_output:
            # random-forest leaves are in output space already
            if models:
                raw = raw / (len(models) // k)
        elif not raw_score:
            raw = self._convert_output(raw)
        return raw[:, 0] if k == 1 else raw

    def _predict_sparse(self, data, num_iteration, raw_score, pred_leaf):
        csr = data.tocsr()
        width = csr.shape[1]
        bst = self
        compact = self._compact_for_sparse(num_iteration, width)
        if compact is not None:
            bst, used = compact
            csr = csr[:, used]
            width = used.size
            num_iteration = -1          # the clone's models are sliced
        chunk = max(1, (128 << 20) // max(8 * width, 1))
        parts = [bst.predict(np.asarray(csr[i:i + chunk].todense(),
                                        dtype=np.float64),
                             num_iteration=num_iteration,
                             raw_score=raw_score, pred_leaf=pred_leaf)
                 for i in range(0, csr.shape[0], chunk)]
        return np.concatenate(parts, axis=0)

    def _compact_for_sparse(self, num_iteration: int, width: int):
        """A shallow clone whose trees index only the columns the used
        trees split on, and those columns' ids; None where fewer than
        half the columns would go (lightgbm_tpu/booster.py
        _compact_for_sparse).  Absent sparse entries are 0.0 either
        way, so the scores are the dense call's."""
        models = self._used_models(num_iteration)
        feats = [t.split_feature for t in models if t.num_leaves > 1]
        if not feats:
            return None
        used = np.unique(np.concatenate(feats)).astype(np.int64)
        if used.size * 2 >= width:
            return None
        remap = np.zeros(width, dtype=np.int32)
        remap[used] = np.arange(used.size, dtype=np.int32)
        bst = copy.copy(self)
        bst.gbdt = None
        bst.best_iteration = 0
        bst._predictor = None
        bst.models = []
        for t in models:
            ct = copy.copy(t)
            if t.num_leaves > 1:
                ct.split_feature = remap[t.split_feature]
            bst.models.append(ct)
        bst.max_feature_idx = int(used.size) - 1
        return bst, used

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
        if self.pandas_categorical:
            # the trailing mapping line of the reference python package
            text += "\npandas_categorical:%s\n" % json.dumps(
                self.pandas_categorical, default=str)
        return text

    def model_from_string(self, model_str: str) -> "Booster":
        """Replace this booster's model with one read from model text
        (either package's)."""
        self._load_from_string(model_str)
        return self

    def _load_from_string(self, text: str) -> None:
        """reference gbdt_model_text.cpp:317+ LoadModelFromString, and
        the python package's trailing ``pandas_categorical:`` line."""
        self.pandas_categorical = None
        for line in reversed(text.rstrip().splitlines()[-3:]):
            if line.startswith("pandas_categorical:"):
                try:
                    self.pandas_categorical = json.loads(
                        line[len("pandas_categorical:"):])
                except ValueError:
                    pass
                text = text[:text.rfind("pandas_categorical:")]
                break
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

    # ------------------------------------------------------------------
    def dump_model(self, num_iteration: int = -1) -> Dict[str, Any]:
        """JSON model dump (lightgbm_tpu/booster.py dump_model;
        reference gbdt_model_text.cpp DumpModel / Tree::ToJSON)."""
        models = self._used_models(num_iteration)

        def node_json(tree: Tree, node: int):
            if node < 0:
                leaf = -node - 1
                return {"leaf_index": leaf,
                        "leaf_value": float(tree.leaf_value[leaf]),
                        "leaf_count": int(tree.leaf_count[leaf])}
            dt = int(tree.decision_type[node])
            is_cat = bool(dt & 1)
            missing = {0: "None", 1: "Zero", 2: "NaN"}[(dt >> 2) & 3]
            out = {
                "split_index": int(node),
                "split_feature": int(tree.split_feature[node]),
                "split_gain": float(tree.split_gain[node]),
                "threshold": float(tree.threshold[node]),
                "decision_type": "==" if is_cat else "<=",
                "default_left": bool(dt & 2),
                "missing_type": missing,
                "internal_value": float(tree.internal_value[node]),
                "internal_count": int(tree.internal_count[node]),
                "left_child": node_json(tree, int(tree.left_child[node])),
                "right_child": node_json(tree, int(tree.right_child[node])),
            }
            if is_cat:
                ci = int(tree.threshold[node])
                lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
                out["cat_threshold"] = list(tree.cat_threshold[lo:hi])
            return out

        return {
            "name": "tree",
            "version": MODEL_VERSION,
            "num_class": self.num_class,
            "num_tree_per_iteration": self.num_tree_per_iteration,
            "label_index": 0,
            "max_feature_idx": self.max_feature_idx,
            "objective": self.objective_str,
            "average_output": self.average_output,
            "feature_names": list(self.feature_names),
            "tree_info": [
                {"tree_index": i, "num_leaves": t.num_leaves,
                 "num_cat": t.num_cat, "shrinkage": t.shrinkage,
                 "tree_structure": node_json(
                     t, 0 if t.num_leaves > 1 else -1)}
                for i, t in enumerate(models)],
        }

    # ------------------------------------------------------------------
    def refit(self, data, label, params: Optional[Dict[str, Any]] = None
              ) -> "Booster":
        """Refit the leaf values on new data, keeping every tree's
        structure (lightgbm_tpu/booster.py refit; reference gbdt.cpp
        RefitTree): tree by tree, the objective's gradients of the
        scores so far are summed in each leaf the rows land in
        (``pred_leaf``, a host walk) and the leaf takes the regularised
        output times the tree's shrinkage.  The gradients are computed
        on this booster's device."""
        from .dataset import Metadata
        from .objectives import create_objective
        from .ops.split import calculate_leaf_output
        params = dict(params or {})
        params.setdefault("objective", self.objective_str.split()[0])
        params.setdefault("device", self.config.device)
        if self.num_tree_per_iteration > 1:
            params.setdefault("num_class", self.num_tree_per_iteration)
        config = Config.from_params(params)
        device = resolve_device(config)
        n = data.shape[0]
        meta = Metadata(n)
        meta.set_label(label)
        objective = create_objective(config)
        objective.init(meta, n, device)
        k = max(self.num_tree_per_iteration, 1)
        leaf_preds = self.predict(data, pred_leaf=True)   # (n, trees)
        scores = np.zeros((n, k), dtype=np.float64)

        def f32(v):
            return torch.tensor(v, dtype=torch.float32)

        for i, tree in enumerate(self.models):
            cls = i % k
            s = torch.from_numpy(
                (scores if k > 1 else scores[:, 0]).astype(np.float32))
            g, h = objective.get_gradients(s.to(device))
            g, h = g.cpu().numpy(), h.cpu().numpy()
            if k > 1:
                g, h = g[:, cls], h[:, cls]
            lp = leaf_preds[:, i]
            shrink = tree.shrinkage if tree.shrinkage != 0 else 1.0
            for leaf in range(tree.num_leaves):
                mask = lp == leaf
                if not mask.any():
                    continue
                out = float(calculate_leaf_output(
                    f32(float(g[mask].sum())), f32(float(h[mask].sum())),
                    config.lambda_l1, config.lambda_l2,
                    config.max_delta_step))
                tree.leaf_value[leaf] = out * shrink
                tree.leaf_count[leaf] = int(mask.sum())
            scores[:, cls] += tree.leaf_value[lp]
        self._predictor = None
        return self

    # ------------------------------------------------------------------
    def __getstate__(self):
        return {"model_str": self.model_to_string(),
                "best_iteration": self.best_iteration,
                "device": self.config.device}

    def __setstate__(self, state):
        self.__init__(model_str=state["model_str"],
                      params={"device": state.get("device", "cuda")})
        self.best_iteration = state.get("best_iteration", -1)
