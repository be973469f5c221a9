"""Booster: the trained model — training session, prediction, model
text in and out.

Port of lightgbm_tpu/booster.py: the training side (continued training
from ``init_model``, custom gradients, rollback, validation sets,
refit), prediction on every path of the JAX package (the bucketed,
chunk-streamed serving predictor over kernel C with its OOM ladder, the
in-session binned scan, the per-tree raw scan, the host walk with
``pred_leaf``, ``pred_contrib`` and ``pred_early_stop``), sparse input
in dense row chunks, and save/load in the same model text format, so a
model saved by either package loads in the other.
"""
from __future__ import annotations

import copy
import json
import re
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .config import Config, canonical_objective
from .dataset import Dataset
from .ops.predict import (PREDICT_TELEMETRY, level_ensemble_from_numpy,
                          pack_level_records, predict_level_ensemble,
                          split_hi_lo_device)
from .tree import Tree, flatten_ensemble
from .utils.device import resolve_device, rows_to_device
from .utils.log import Log

MODEL_VERSION = "v2"

# transient device bytes a chunk of predict_chunk_rows=auto may take
# (two chunks in flight), as in the JAX package
_PREDICT_CHUNK_BUDGET_BYTES = 256 << 20

#: rows x trees from which predict(device=None) takes the device paths
#: that have no buckets (the in-session binned scan; the scan and
#: bucket-off predictors) on the card, as the JAX package does on a TPU
_DEVICE_PREDICT_MIN_WORK = 2_000_000


#: guards the serving predictor's process-wide state: the counters of
#: ``PREDICT_TELEMETRY`` and ``TELEMETRY``, the set of launch shapes
#: below, and each booster's predictor cache (lanes call one predictor
#: from several threads, as the JAX package's ``_serving_lock`` guards)
_SERVING_LOCK = threading.RLock()

#: (ensemble shape, bucket) pairs dispatched so far in this process.  A
#: dispatch whose pair is new counts as a bucket miss: in the JAX package
#: a miss is a new jit trace, once per (ensemble shape, bucket) in the
#: process, so a second booster of the same shape hits there and here
_DISPATCHED_SHAPES: set = set()


def reset_dispatched_shapes() -> None:
    """Forget the dispatched (shape, bucket) pairs (the next dispatch of
    each counts as a miss again, as after a JAX jit cache clear)."""
    with _SERVING_LOCK:
        _DISPATCHED_SHAPES.clear()


def round_up_bucket(m: int, min_bucket: int) -> int:
    """The serving bucket ladder: the smallest power-of-two multiple of
    ``min_bucket`` covering ``m`` rows (lightgbm_tpu/booster.py
    round_up_bucket)."""
    b = max(1, int(min_bucket))
    while b < m:
        b <<= 1
    return b


def _off(value) -> bool:
    return str(value).lower() in ("off", "false", "0")


class _InFlight(NamedTuple):
    """One dispatched chunk: its (bucket, K) scores on the device, its
    first row, its row count and its bucket."""
    scores: torch.Tensor
    start: int
    rows: int
    bucket: int


class _ServingPredictor:
    """Shape-bucketed, chunk-streamed device predictor over one ensemble
    slice (lightgbm_tpu/booster.py _ServingPredictor): the ensemble
    packed once as kernel C's node records on ``device``.

    Batch sizes round up to power-of-two row buckets (pad rows scored
    and dropped); batches above the chunk cap stream through the device
    in full-bucket chunks with at most two chunks' results in flight.
    The buckets and dispatches are the JAX package's for the same batch
    sizes and settings; kernel C has no per-shape program, so here a
    bucket fixes the launch shape only.  Each chunk's f64 rows are
    copied to ``device`` as they are (a pageable copy, which CUDA
    stages through its own buffers) and split into (hi, lo) pairs
    there (``split_hi_lo_device``); on the CPU (tensors of a
    ``device="cpu"`` booster) the same chunks go through the plain
    versions.  Under an out-of-memory error (``is_oom``) the bucket
    halves and the slice is retried on the same device; the learned cap
    sticks."""

    def __init__(self, models: List[Tree], num_class: int, config,
                 device: torch.device, cls_onehot: np.ndarray = None):
        flat = flatten_ensemble(models, num_class)
        self.depth = int(flat.pop("depth"))
        if cls_onehot is not None:
            flat["cls_onehot"] = cls_onehot
        self.records = pack_level_records(
            level_ensemble_from_numpy(flat, device))
        r = self.records
        # the launch-shape key of a bucket miss (the JAX jit's key: the
        # ensemble's array shapes and its depth)
        self.shape_key = ("level", tuple(r.walk.shape), tuple(r.meta.shape),
                          tuple(r.leaves.shape), tuple(r.cats.shape),
                          r.num_class, self.depth)
        self.num_trees = len(models)
        self.device = device
        self.num_class = max(num_class, 1)
        self.bucketed = not _off(getattr(config, "predict_bucket", "auto"))
        self.min_bucket = max(1, int(getattr(
            config, "predict_min_bucket_rows", 16)))
        self.chunk_rows = int(getattr(config, "predict_chunk_rows", 0))
        self.oom_downshift = bool(getattr(config, "oom_downshift", True))
        self._oom_cap: Optional[int] = None
        self._oom_warned = False

    # ------------------------------------------------------------------
    def _chunk_cap(self, two_f: int) -> int:
        if self.chunk_rows > 0:
            cap = self.chunk_rows
        else:
            # per-row transients of the JAX descent: the (N, 2F) hi/lo
            # matrix + the (N, T) node state, (N, 2T) gather indices and
            # (N, T) values (the same formula, so the same buckets)
            bytes_per_row = 4 * (two_f + 8 * max(self.num_trees, 1))
            cap = _PREDICT_CHUNK_BUDGET_BYTES // max(bytes_per_row, 1)
            cap = max(4096, min(1 << 20, cap))
        if self.bucketed:
            cap = 1 << (max(cap, 1).bit_length() - 1)
        return cap

    def _bucket(self, m: int, cap: int) -> int:
        if not self.bucketed:
            return m
        return min(round_up_bucket(m, self.min_bucket), cap)

    # ------------------------------------------------------------------
    def _dispatch(self, x2: torch.Tensor) -> torch.Tensor:
        """Kernel C on a bucket's (b, 2F) rows (its plain version on the
        CPU), behind the ``predict.dispatch`` fault seam."""
        from .reliability.faults import FAULTS
        FAULTS.fault_point("predict.dispatch")
        return predict_level_ensemble(self.records, x2, depth=self.depth)

    def _launch(self, data: np.ndarray, s: int, m: int,
                b: int) -> _InFlight:
        """Copy rows ``[s, s + m)`` to the device, split them into a
        (b, 2F) bucket (pad rows zero) and dispatch kernel C."""
        x64 = torch.from_numpy(np.ascontiguousarray(data[s:s + m])).to(
            self.device)
        x2 = torch.empty((b, 2 * data.shape[1]), dtype=torch.float32,
                         device=self.device)
        x2[m:].zero_()
        split_hi_lo_device(x64, out=x2[:m])
        return _InFlight(self._dispatch(x2), s, m, b)

    def _drain(self, chunk: _InFlight, out: np.ndarray) -> None:
        """Read a chunk's scores back into its rows of ``out``."""
        out[chunk.start:chunk.start + chunk.rows] = \
            chunk.scores[:chunk.rows].cpu().numpy()

    def _recover_oom(self, e: BaseException, bucket_rows: int,
                     pending: list, s: int) -> int:
        """A failed dispatch or drain: an out-of-memory error halves the
        serving ladder (warned once) and returns the row to restart
        from; anything else, or an OOM at a one-row bucket, re-raises.
        The chunks in flight are discarded, not drained, and re-run at
        the smaller bucket on the same device."""
        from .reliability.retry import is_oom
        from .telemetry import TELEMETRY as tm
        if not (self.oom_downshift and is_oom(e)) or bucket_rows <= 1:
            raise e
        restart = min((c.start for c in pending), default=s)
        pending.clear()
        self._oom_cap = max(1, bucket_rows // 2)
        tm.add("oom_downshifts", 1)
        tm.journal.emit("oom_downshift", seam="predict.dispatch",
                        bucket=bucket_rows, new_cap=self._oom_cap)
        tm.flight.dump("oom_downshift", seam="predict.dispatch",
                       bucket=bucket_rows, new_cap=self._oom_cap)
        if not self._oom_warned:
            self._oom_warned = True
            Log.warning(
                "out of memory during a serving dispatch at bucket "
                f"{bucket_rows} ({e}); downshifting to bucket "
                f"{self._oom_cap} and retrying the slice")
        return restart

    def __call__(self, data: np.ndarray) -> np.ndarray:
        """(n, F) float64 raw features -> (n, K) float64 raw scores (f32
        sums on the device, routing identical to the host walk).

        Telemetry (the JAX package's names): a ``predict`` span a call
        with a ``predict_dispatch``/``predict_drain`` child a chunk; the
        counters ``predict_requests``, ``predict_dispatches``,
        ``predict_rows``, ``predict_pad_rows`` and
        ``predict_bucket_hit``/``_miss`` (a miss: the first dispatch of
        its (ensemble shape, bucket) pair in the process); the
        histograms ``predict_latency_ms`` (the call), ``predict_drain_ms``
        (a chunk's readback, where the call waits on the device) and
        ``predict_queue_depth`` (chunks in flight at each dispatch); the
        ``predict_stream_depth`` gauge."""
        from .telemetry import TELEMETRY as tm
        data = np.asarray(data, dtype=np.float64)
        n = data.shape[0]
        if n == 0:
            return np.zeros((0, self.num_class))
        t0 = time.perf_counter() if tm.on else 0.0
        span = tm.start_span("predict", rows=n)
        try:
            return self._call_impl(data, n, tm)
        finally:
            # the ladder's re-raise paths must not leave the request
            # span unrecorded
            tm.end_span(span)
            if tm.on:
                tm.observe("predict_latency_ms",
                           (time.perf_counter() - t0) * 1e3)

    def _note_dispatch(self, tm, m: int, b: int, f: int,
                       depth: int) -> None:
        """Count one dispatch of ``m`` rows of ``f`` features in a bucket
        of ``b`` rows, ``depth`` chunks now in flight."""
        from .telemetry import DEPTH_BOUNDS
        key = (self.shape_key, b, f)
        with _SERVING_LOCK:
            miss = key not in _DISPATCHED_SHAPES
            _DISPATCHED_SHAPES.add(key)
            PREDICT_TELEMETRY["dispatches"] += 1
            PREDICT_TELEMETRY["rows"] += m
            PREDICT_TELEMETRY["buckets"].add(b)
        if tm.on:
            tm.add("predict_dispatches", 1)
            tm.add("predict_rows", m)
            tm.add("predict_pad_rows", b - m)
            tm.add("predict_bucket_miss" if miss else "predict_bucket_hit", 1)
            tm.gauge_max("predict_stream_depth", depth)
            tm.observe("predict_queue_depth", depth, bounds=DEPTH_BOUNDS)

    def _call_impl(self, data: np.ndarray, n: int, tm) -> np.ndarray:
        if tm.on:
            tm.add("predict_requests", 1)
        cap = self._chunk_cap(2 * data.shape[1])
        if self._oom_cap is not None:
            cap = max(1, min(cap, self._oom_cap))
        out = np.empty((n, self.num_class), np.float32)
        pending: list = []
        s = 0
        while s < n or pending:
            if pending and (s >= n or len(pending) >= 2):
                # at most two chunks in flight; an OOM surfacing at the
                # readback takes the ladder as one at the dispatch does
                t0 = time.perf_counter() if tm.on else 0.0
                try:
                    with tm.span("predict_drain"):
                        self._drain(pending[0], out)
                except Exception as e:
                    s = self._recover_oom(e, pending[0].bucket, pending, s)
                    cap = max(1, min(cap, self._oom_cap))
                    continue
                if tm.on:
                    tm.observe("predict_drain_ms",
                               (time.perf_counter() - t0) * 1e3)
                pending.pop(0)
                continue
            m = min(cap, n - s)
            b = self._bucket(m, cap)
            try:
                with tm.span("predict_dispatch", bucket=b):
                    chunk = self._launch(data, s, m, b)
            except Exception as e:
                s = self._recover_oom(e, b, pending, s)
                cap = max(1, min(cap, self._oom_cap))
                continue
            pending.append(chunk)
            self._note_dispatch(tm, m, b, data.shape[1], len(pending))
            s += m
        if tm.on:
            tm.sample_memory(device=self.device.type == "cuda")
        return out.astype(np.float64)


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
        # set when the host trees change after training (refit): the
        # session's device trees no longer match them, and the binned
        # scan must not serve from them
        self._device_stale = False
        self._predictor_cache = None    # (len(models), {key: predictor})
        self._raw_stack_cache = None    # (len(models), RawTreeStack)
        # the QualityProfile engine.train attaches under quality=on;
        # save_model persists it beside the model file
        self.quality_profile = None
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
        pred = base._without_session(self.config.device).predict(
            raw, raw_score=True)
        pred = pred.reshape(1, -1) if pred.ndim == 1 else pred.T
        g = self.gbdt
        pad = g.grower.n_padded - train_set.num_data
        g.scores += torch.from_numpy(np.pad(
            pred.astype(np.float32), ((0, 0), (0, pad)))).to(g.device)
        g.add_foreign_trees(base.models)

    def _without_session(self, device: str) -> "Booster":
        """This booster, or a shallow copy of it without its training
        session, predicting on ``device``: a seed is scored through the
        serving predictor (kernel C), never the binned scan."""
        if self.config.device == device and self.gbdt is None:
            return self
        other = Booster.__new__(Booster)     # copy.copy would pickle
        other.__dict__.update(self.__dict__)
        other.config = copy.copy(self.config)
        other.config.device = device
        other.gbdt = None
        other._drop_predictors()
        return other

    def _drop_predictors(self) -> None:
        """Forget the device predictors built from the host trees (they
        are rebuilt at the next call)."""
        self._predictor_cache = None
        self._raw_stack_cache = None

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
        self._drop_predictors()
        if fobj is not None:
            grad, hess = fobj(self._current_train_scores(),
                              self.gbdt.train_set)
            return self.gbdt.train_one_iter(grad, hess)
        return self.gbdt.train_one_iter()

    def rollback_one_iter(self) -> "Booster":
        self._require_session("rollback")
        self.gbdt.rollback_one_iter()
        self._drop_predictors()
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
            self._drop_predictors()

    def num_trees(self) -> int:
        self._sync_models()
        return len(self.models)

    def num_feature(self) -> int:
        return self.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        return list(self.feature_names)

    def reset_training_data(self, train_set: Dataset) -> None:
        """Swap the training dataset, keeping the trained model
        (lightgbm_tpu/booster.py reset_training_data; reference c_api.cpp
        ResetTrainingData): the new data must have the same feature
        count, and the trees so far seed its scores as in continued
        training (so it needs its raw rows: ``free_raw_data=False``).
        The iteration count carries over."""
        from .boosting import create_boosting
        if hasattr(train_set, "construct") and callable(train_set.construct):
            train_set = train_set.construct(self.config)
        self._sync_models()
        old = None
        if self.models:
            old = Booster.__new__(Booster)
            old.__dict__.update(self.__dict__)
            old.gbdt = None
            old.models = list(self.models)
            old._drop_predictors()
        nf = train_set.num_total_features
        if self.models and nf != self.max_feature_idx + 1:
            Log.fatal("reset_training_data: feature count mismatch "
                      f"({nf} vs model's {self.max_feature_idx + 1})")
        old_iter = self.current_iteration
        self.gbdt = create_boosting(self.config, train_set)
        self.models = self.gbdt.models
        self.feature_names = train_set.feature_names
        self.feature_infos = train_set.feature_infos()
        self.max_feature_idx = nf - 1
        self._drop_predictors()
        if old is not None:
            self._continue_from(old, train_set)
            self.gbdt.iter_ = old_iter
        self._device_stale = False

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

    def free_network(self) -> "Booster":
        """reference basic.py Booster.free_network (see
        LGBM_NetworkFree)."""
        return self

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """reference basic.py Booster.set_network: accepted for call
        compatibility; multi-process training goes through
        parallel.distributed.initialize with collective_transport=tcp
        (the host-side plane) or xla (torch.distributed, each process
        holding only its own rows) (warns like LGBM_NetworkInit)."""
        from .capi import LGBM_NetworkInit
        LGBM_NetworkInit(machines if isinstance(machines, str)
                         else ",".join(machines), local_listen_port,
                         listen_time_out, num_machines)
        return self

    # ------------------------------------------------------------------
    def _resolve_tree_count(self, total: int, num_iteration: int) -> int:
        """``num_iteration`` (or ``best_iteration`` where it is <= 0) as
        a tree count, shared by the host and device paths so both slice
        the same trees (lightgbm_tpu/booster.py _resolve_tree_count)."""
        k = max(self.num_tree_per_iteration, 1)
        if num_iteration is None or num_iteration <= 0:
            if self.best_iteration > 0:
                num_iteration = self.best_iteration
            else:
                return total
        return min(total, num_iteration * k)

    def _used_models(self, num_iteration: int) -> List[Tree]:
        self._sync_models()
        return self.models[:self._resolve_tree_count(len(self.models),
                                                     num_iteration)]

    def _n_used_trees(self, num_iteration: int) -> int:
        total = (len(self.gbdt.device_trees) if self.gbdt is not None
                 else len(self.models))
        return self._resolve_tree_count(total, num_iteration)

    def _on_card(self) -> bool:
        """Whether the booster's device is the card: where the JAX
        package asks for a TPU backend, the port asks this."""
        return str(self.config.device).lower() == "cuda"

    def _predict_impl(self) -> str:
        k = str(getattr(self.config, "predict_kernel", "auto")).lower()
        return "level" if k in ("auto", "") else k

    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False,
                pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0,
                device: Optional[bool] = None) -> np.ndarray:
        """Prediction on raw features (lightgbm_tpu/booster.py predict;
        reference gbdt_prediction.cpp:9-100, SHAP through
        tree.PredictContrib, the margin early stop of
        prediction_early_stop.cpp:13-80).

        ``device``: True takes a device path, False the host walk (f64),
        None picks as the JAX package does, the card standing for its
        TPU: on the card, an in-session single-class booster takes the
        binned scan from 2,000,000 rows x trees, and every other batch
        the bucketed serving predictor (kernel C); with
        ``predict_kernel=scan`` or ``predict_bucket=off`` the device
        path takes batches from 2,000,000 rows x trees only.  A
        ``device="cpu"`` booster takes the serving predictor on the CPU
        (kernel C's plain version) under None.  The device paths sum in
        f32 and route as the host walk does (the two-float threshold
        compare).  ``pred_leaf``, ``pred_contrib`` and
        ``pred_early_stop`` walk the trees on the host.  A scipy sparse
        matrix goes through in dense row chunks of at most 128 MB,
        narrowed to the columns the used trees split on where that
        halves the width (not for ``pred_contrib``).  A model with
        ``average_output`` (random forest) returns the mean over its
        iterations, with no output transform.  A pandas frame's category
        columns encode against the training frame's categories
        (``pandas_categorical``); an unseen category is NaN."""
        from .basic import _is_sparse, _to_matrix
        kw = dict(num_iteration=num_iteration, raw_score=raw_score,
                  pred_leaf=pred_leaf, pred_contrib=pred_contrib,
                  pred_early_stop=pred_early_stop,
                  pred_early_stop_freq=pred_early_stop_freq,
                  pred_early_stop_margin=pred_early_stop_margin,
                  device=device)
        if _is_sparse(data):
            return self._predict_sparse(data, kw)
        data = _to_matrix(data, self.pandas_categorical)
        if data.ndim == 1:
            data = data[None, :]
        n = data.shape[0]
        k = max(self.num_tree_per_iteration, 1)
        if not pred_leaf and not pred_contrib and not pred_early_stop:
            if self._can_device_predict(n, num_iteration, device):
                # in-session single-class models: the binned scan
                raw = self._device_predict_raw(data, num_iteration)[:, None]
                if not raw_score and not self.average_output:
                    raw = self._convert_output(raw)
                return raw[:, 0]
            if self._can_device_predict_loaded(n, num_iteration, device):
                raw, used = self._device_predict_loaded(data,
                                                        num_iteration)
                return self._finish_device_scores(raw, used,
                                                  raw_score=raw_score)
        models = self._used_models(num_iteration)
        if pred_leaf:
            out = np.zeros((n, len(models)), dtype=np.int32)
            for i, t in enumerate(models):
                out[:, i] = t.predict_leaf(data)
            return out
        if pred_contrib:
            from .shap import predict_contrib
            return predict_contrib(self, data, models)
        raw = np.zeros((n, k), dtype=np.float64)
        if pred_early_stop and not self.average_output:
            # a row whose margin exceeds the threshold skips the
            # remaining trees, checked every pred_early_stop_freq
            # iterations (binary |score|, multiclass top-2 gap)
            active = np.ones(n, dtype=bool)
            for i, t in enumerate(models):
                if not active.any():
                    break
                raw[active, i % k] += t.predict(data[active])
                if (i + 1) % (pred_early_stop_freq * k) == 0:
                    if k == 1:
                        margin = np.abs(raw[:, 0])
                    else:
                        part = np.partition(raw, k - 2, axis=1)
                        margin = part[:, -1] - part[:, -2]
                    active &= margin < pred_early_stop_margin
        else:
            for i, t in enumerate(models):
                raw[:, i % k] += t.predict(data)
        raw = self._add_init_and_average(raw, len(models))
        if not raw_score and not self.average_output:
            raw = self._convert_output(raw)
        return raw[:, 0] if k == 1 else raw

    def _predict_sparse(self, data, kw: dict) -> np.ndarray:
        csr = data.tocsr()
        width = csr.shape[1]
        bst = self
        compact = None if kw["pred_contrib"] else \
            self._compact_for_sparse(kw["num_iteration"], width)
        if compact is not None:
            bst, used = compact
            csr = csr[:, used]
            width = used.size
            kw = dict(kw, num_iteration=-1)     # the clone's models are
            #                                     sliced
        chunk = max(1, (128 << 20) // max(8 * width, 1))
        parts = [bst.predict(np.asarray(csr[i:i + chunk].todense(),
                                        dtype=np.float64), **kw)
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
        bst._drop_predictors()
        bst._device_stale = False
        bst.models = []
        for t in models:
            ct = copy.copy(t)
            if t.num_leaves > 1:
                ct.split_feature = remap[t.split_feature]
            bst.models.append(ct)
        bst.max_feature_idx = int(used.size) - 1
        return bst, used

    # ------------------------------------------------------------------
    def _can_device_predict(self, n: int, num_iteration: int,
                            device: Optional[bool]) -> bool:
        """The binned scan serves single-class in-session models whose
        device trees all count at their shrinkage (no DART rescale, no
        init_model trees, no random-forest mean)."""
        if device is False or self.gbdt is None or self._device_stale:
            return False
        g = self.gbdt
        ok = (self.num_tree_per_iteration == 1
              and not self.average_output
              and g._scale_offset == 0
              and len(g.device_trees) > 0
              and all(s == 1.0 for s in g._tree_scale))
        if not ok:
            return False
        if device is True:
            return True
        return self._on_card() and \
            n * self._n_used_trees(num_iteration) >= _DEVICE_PREDICT_MIN_WORK

    def _device_predict_raw(self, data: np.ndarray,
                            num_iteration: int) -> np.ndarray:
        """Raw scores by the binned scan (lightgbm_tpu/booster.py
        _device_predict_raw): the rows binned with the training mappers,
        then each device tree walked over the bins (``predict_binned``,
        torch ops) and added at its shrinkage to the init score (the
        session's trees do not hold it), in f32 on the session's device.
        The rows are binned into the training set's storage layout and
        uploaded as stored (sub-byte under a pack spec)."""
        g = self.gbdt
        vcore = Dataset.from_matrix(np.asarray(data, dtype=np.float64),
                                    config=g.config, reference=g.train_set)
        vbins = rows_to_device(vcore.group_bins, g.device)
        n_trees = self._n_used_trees(num_iteration)
        total = torch.full((vbins.shape[0],), float(g.init_score),
                           dtype=torch.float32, device=g.device)
        shrinks = torch.tensor(g._tree_shrink[:n_trees],
                               dtype=torch.float32, device=g.device)
        for tree, sh in zip(g.device_trees[:n_trees], shrinks):
            total = total + sh * g._predict_tree(tree, vbins)
        return total.cpu().numpy()

    def _can_device_predict_loaded(self, n: int, num_iteration: int,
                                   device: Optional[bool]) -> bool:
        """The serving predictor (or the raw scan) serves any model with
        host trees: loaded, multiclass, DART, init_model, RF."""
        if device is False:
            return False
        total = len(self.models) or (
            len(self.gbdt.device_trees) if self.gbdt is not None else 0)
        if total == 0:
            return False
        if device is True or not self._on_card():
            return True
        if self._predict_impl() != "scan" \
                and not _off(getattr(self.config, "predict_bucket", "auto")):
            # buckets: a batch of any size reuses its bucket's shape
            return True
        n_trees = self._resolve_tree_count(total, num_iteration)
        return n * n_trees >= _DEVICE_PREDICT_MIN_WORK

    def _serving_predictor(self, count: int,
                           device=None) -> _ServingPredictor:
        """The serving predictor of the first ``count`` trees on
        ``device`` (the booster's by default), built once per (model
        count, tree count, device): the records upload once a device."""
        dev = resolve_device(self.config) if device is None \
            else torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (count, dev)
        # under the lock: two lanes asking at once build and upload the
        # records once
        with _SERVING_LOCK:
            cache = self._predictor_cache
            if cache is None or cache[0] != len(self.models):
                cache = (len(self.models), {})
                self._predictor_cache = cache
            if key not in cache[1]:
                cache[1][key] = _ServingPredictor(
                    self.models[:count], max(self.num_tree_per_iteration, 1),
                    self.config, dev)
            return cache[1][key]

    def warm_predictor(self, batch_sizes=(1,), num_iteration: int = -1,
                       log: bool = False, devices=None) -> "Booster":
        """Serving warm-up (lightgbm_tpu/booster.py warm_predictor):
        builds the serving predictor (its records on the device, the
        kernel library) and scores a batch of zeros of each size in
        ``batch_sizes``, so the first request finds them ready.  It drives the serving predictor directly: predict() would
        send an in-session booster's batch to the binned scan.
        ``devices``: torch devices to warm, each its own predictor; None
        warms the booster's device.  ``log``: each bucket's warm-up wall
        as an info line.  Run after training for
        ``predict_warm_buckets``."""
        self._sync_models()
        if not self.models:
            return self
        count = self._resolve_tree_count(len(self.models), num_iteration)
        if count == 0 or self._predict_impl() == "scan":
            return self
        f = self.max_feature_idx + 1
        for dev in (tuple(devices) if devices else (None,)):
            pred = self._serving_predictor(count, dev)
            for b in batch_sizes:
                m = max(int(b), 1)
                t0 = time.perf_counter()
                pred(np.zeros((m, f)))
                if log:
                    bucket = pred._bucket(m, pred._chunk_cap(2 * f))
                    Log.info(f"warm_predictor: batch {m} -> bucket {bucket} "
                             f"on {pred.device} warmed in "
                             f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        return self

    def _device_predict_loaded(self, data: np.ndarray, num_iteration: int):
        """((n, K) float64 raw scores, trees used) by the serving
        predictor (kernel C), or the per-tree raw scan with
        ``predict_kernel=scan``; the tree count resolves as the host
        path's does."""
        self._sync_models()
        count = self._resolve_tree_count(len(self.models), num_iteration)
        k = max(self.num_tree_per_iteration, 1)
        if count == 0:
            return np.zeros((data.shape[0], k)), 0
        if self._predict_impl() == "scan":
            return self._device_predict_scan(data, count, k), count
        return self._serving_predictor(count)(data), count

    def _device_predict_scan(self, data: np.ndarray, count: int,
                             k: int) -> np.ndarray:
        """The per-tree raw scan (predict_kernel=scan): each tree walked
        over the (hi, lo) rows split on the device, its values added to
        its class in tree order (torch ops)."""
        from .ops.predict import (predict_raw_ensemble, slice_raw_stack,
                                  stack_host_trees)
        dev = resolve_device(self.config)
        cache = self._raw_stack_cache
        if cache is None or cache[0] != len(self.models):
            cache = (len(self.models), stack_host_trees(self.models, dev))
            self._raw_stack_cache = cache
        stack = slice_raw_stack(cache[1], count)
        x2 = split_hi_lo_device(torch.from_numpy(np.ascontiguousarray(
            data, dtype=np.float64)).to(dev))
        out = predict_raw_ensemble(
            stack, x2[:, 0::2].contiguous(), x2[:, 1::2].contiguous(),
            torch.arange(count) % k,
            torch.zeros((k, data.shape[0]), dtype=torch.float32, device=dev))
        return out.cpu().numpy().T.astype(np.float64)

    def _finish_device_scores(self, raw: np.ndarray, used: int,
                              raw_score: bool = False) -> np.ndarray:
        """The host finish of a device raw-score block: the random
        forest's mean, the output transform, the single-class squeeze
        (lightgbm_tpu/booster.py _finish_device_scores)."""
        k = max(self.num_tree_per_iteration, 1)
        raw = self._add_init_and_average(raw, used)
        if not raw_score and not self.average_output:
            raw = self._convert_output(raw)
        return raw[:, 0] if k == 1 else raw

    def _add_init_and_average(self, raw, num_models):
        if self.average_output and num_models:
            raw = raw / (num_models // max(self.num_tree_per_iteration, 1))
        return raw

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
        text = self.model_to_string(num_iteration)
        with open(filename, "w") as f:
            f.write(text)
        prof = getattr(self, "quality_profile", None)
        if prof is not None:
            from .quality import model_fingerprint, profile_path
            if model_fingerprint(text) == prof.fingerprint:
                # the profile is bound to the FULL model it was built
                # from: persisted beside the file so a later task=serve
                # arms drift monitors from disk
                path = prof.save(profile_path(filename))
                Log.info(f"quality profile saved to {path}")
            else:
                # e.g. a num_iteration-sliced save: the sidecar would
                # trip the fingerprint refusal at serve time
                Log.debug("quality profile not saved beside "
                          f"{filename}: the written model text does "
                          "not match the profiled model (sliced "
                          "save?)")

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
        self._drop_predictors()
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
        # the leaf values changed in place: the session's device trees
        # are stale, and the predictors are rebuilt from the host trees
        self._device_stale = True
        self._drop_predictors()
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
