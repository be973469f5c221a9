"""Flat C-API-compatible function surface (port of
lightgbm_tpu/capi.py).

The reference exposes its core through ~90 flat C functions
(reference: include/LightGBM/c_api.h, src/c_api.cpp) that the Python,
R and Java bindings call through ctypes/.Call/JNI.  Here the core is a
Python/PyTorch program, so the C API's role is played by this module:
the same function names, handle discipline and 0/-1 +
``LGBM_GetLastError`` error convention (reference c_api.h:765-788
API_BEGIN/END), implemented over the port's ``Dataset`` and
``Booster``.  (The C library that embeds CPython to serve these names
to C, R and Java hosts is not ported yet.)

Handles are opaque integers from a process-local registry, mirroring
the reference's pointer handles.  Boosters train and predict on the
CUDA device unless ``device=cpu`` is among their parameters (a loaded
model takes it through ``LGBM_BoosterResetParameter``).
``LGBM_Network*`` succeed for call compatibility, as the JAX package's
do; multi-process training goes through ``parallel.distributed``.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Dataset
from .booster import Booster
from .config import Config
from .utils.log import Log

_lock = threading.Lock()
_handles: Dict[int, Any] = {}
_next_handle = [1]
_last_error = [""]


def _register(obj) -> int:
    with _lock:
        h = _next_handle[0]
        _next_handle[0] += 1
        _handles[h] = obj
        return h


def _get(handle: int):
    obj = _handles.get(int(handle))
    if obj is None:
        raise KeyError(f"invalid handle {handle}")
    return obj


def _api(fn):
    """API_BEGIN/API_END analog: catch everything, stash the message,
    return -1 (reference c_api.h:771-788)."""
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:           # noqa: BLE001 — C boundary
            _last_error[0] = f"{type(e).__name__}: {e}"
            return -1
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _session(bst):
    """gbdt of an active training session; clean error otherwise
    (file-loaded model, or free_dataset ended the session)."""
    if bst.gbdt is None:
        raise RuntimeError("booster has no training session "
                           "(file-loaded model or datasets were freed)")
    return bst.gbdt


def LGBM_GetLastError() -> str:
    """reference c_api.h:46-50."""
    return _last_error[0]


def _parse_params(parameters: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for tok in (parameters or "").replace("\n", " ").split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------
@_api
def LGBM_DatasetCreateFromMat(data, parameters: str, reference=None,
                              out=None) -> int:
    """reference c_api.h:128-147 (row-major float matrix).  ``out`` is
    a one-element list receiving the handle (the C out-pointer)."""
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(np.asarray(data, dtype=np.float64), reference=ref,
                 free_raw_data=False,
                 params=params)
    out[0] = _register(ds)
    return 0


@_api
def LGBM_DatasetCreateFromCSR(indptr, indices, data, num_col: int,
                              parameters: str, reference=None,
                              out=None) -> int:
    """reference c_api.h:147-180 (CSR rows).  Stays sparse end-to-end:
    the Dataset bins CSC columns directly, never densifying the whole
    matrix."""
    from scipy import sparse as sp
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    mat = sp.csr_matrix(
        (np.asarray(data, dtype=np.float64),
         np.asarray(indices, dtype=np.int32),
         np.asarray(indptr, dtype=np.int64)),
        shape=(len(indptr) - 1, int(num_col)))
    ds = Dataset(mat, reference=ref, params=params,
                 free_raw_data=False)
    out[0] = _register(ds)
    return 0


@_api
def LGBM_DatasetCreateFromCSC(col_ptr, indices, data, num_row: int,
                              parameters: str, reference=None,
                              out=None) -> int:
    """reference c_api.h:183-216 (CSC columns)."""
    from scipy import sparse as sp
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    mat = sp.csc_matrix(
        (np.asarray(data, dtype=np.float64),
         np.asarray(indices, dtype=np.int32),
         np.asarray(col_ptr, dtype=np.int64)),
        shape=(int(num_row), len(col_ptr) - 1))
    ds = Dataset(mat, reference=ref, params=params,
                 free_raw_data=False)
    out[0] = _register(ds)
    return 0


@_api
def LGBM_DatasetCreateFromSampledColumn(sample_data, sample_indices,
                                        num_col: int, num_per_col,
                                        num_sample_row: int,
                                        num_total_row: int,
                                        parameters: str, out=None) -> int:
    """reference c_api.h:68-97: fit mappers from per-column samples and
    await PushRows chunks.  ``sample_data``/``sample_indices`` are
    per-column lists (values, row indices within the sample)."""
    from .dataset import Dataset as CoreDataset
    params = _parse_params(parameters)
    cfg = Config.from_params(params)
    vals = [np.asarray(sample_data[j], dtype=np.float64)[:num_per_col[j]]
            for j in range(num_col)]
    rows = [np.asarray(sample_indices[j], dtype=np.int64)[:num_per_col[j]]
            for j in range(num_col)]
    core = CoreDataset.from_sampled_columns(
        vals, rows, int(num_sample_row), int(num_total_row), config=cfg)
    out[0] = _register(_PushableDataset(core))
    return 0


class _PushableDataset:
    """Wrapper so Booster creation accepts a pushed core dataset (the
    lazy-Dataset protocol expects .construct()/set_field)."""

    def __init__(self, core):
        self._core = core

    def construct(self, config=None):
        return self._core

    def set_field(self, name, data):
        self._core.metadata.set_field(name, data)
        return self

    def get_field(self, name):
        return self._core.metadata.get_field(name)

    def num_data(self):
        return self._core.num_data

    def num_feature(self):
        return self._core.num_total_features


@_api
def LGBM_DatasetPushRows(handle, data, num_row: int, num_col: int,
                         start_row: int) -> int:
    """reference c_api.h:100-120."""
    ds = _get(handle)
    chunk = np.asarray(data, dtype=np.float64).reshape(num_row, num_col)
    ds._core.push_rows(chunk, int(start_row))
    if ds._core._pushed_rows >= ds._core.num_data:
        ds._core.finish_load()
    return 0


@_api
def LGBM_DatasetPushRowsByCSR(handle, indptr, indices, data,
                              num_col: int, start_row: int) -> int:
    """reference c_api.h:122-145."""
    ds = _get(handle)
    ds._core.push_rows_csr(indptr, indices, data, int(start_row))
    if ds._core._pushed_rows >= ds._core.num_data:
        ds._core.finish_load()
    return 0


@_api
def LGBM_DatasetCreateFromFile(filename: str, parameters: str,
                               reference=None, out=None) -> int:
    """reference c_api.h:53-66.  Constructed eagerly: the reference's
    c_api parses and bins the file at create (c_api.cpp
    DatasetLoader::LoadFromFile), so C callers may query num_data /
    num_feature immediately."""
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(str(filename), reference=ref, params=params,
                 free_raw_data=False)
    ds.construct()
    out[0] = _register(ds)
    return 0


@_api
def LGBM_DatasetSetField(handle, field_name: str, field_data) -> int:
    """reference c_api.h:223-238."""
    _get(handle).set_field(field_name, np.asarray(field_data))
    return 0


@_api
def LGBM_DatasetGetField(handle, field_name: str, out=None) -> int:
    """reference c_api.h:240-256."""
    out[0] = _get(handle).get_field(field_name)
    return 0


@_api
def LGBM_DatasetGetNumData(handle, out=None) -> int:
    out[0] = _get(handle).num_data()
    return 0


@_api
def LGBM_DatasetGetNumFeature(handle, out=None) -> int:
    out[0] = _get(handle).num_feature()
    return 0


@_api
def LGBM_DatasetSaveBinary(handle, filename: str) -> int:
    """reference c_api.h:204-211."""
    _get(handle).save_binary(str(filename))
    return 0


@_api
def LGBM_DatasetFree(handle) -> int:
    with _lock:
        _handles.pop(int(handle), None)
    return 0


# ---------------------------------------------------------------------------
# Booster
# ---------------------------------------------------------------------------
@_api
def LGBM_BoosterCreate(train_data, parameters: str, out=None) -> int:
    """reference c_api.h:316-325."""
    cfg = Config.from_params(_parse_params(parameters))
    ds = _get(train_data)
    core = ds.construct(cfg) if hasattr(ds, "construct") else ds
    bst = Booster(config=cfg, train_set=core)
    out[0] = _register(bst)
    return 0


@_api
def LGBM_BoosterCreateFromModelfile(filename: str, out_num_iterations=None,
                                    out=None) -> int:
    """reference c_api.h:327-337."""
    bst = Booster(model_file=str(filename))
    if out_num_iterations is not None:
        out_num_iterations[0] = bst.current_iteration
    out[0] = _register(bst)
    return 0


@_api
def LGBM_BoosterLoadModelFromString(model_str: str, out_num_iterations=None,
                                    out=None) -> int:
    bst = Booster(model_str=model_str)
    if out_num_iterations is not None:
        out_num_iterations[0] = bst.current_iteration
    out[0] = _register(bst)
    return 0


@_api
def LGBM_BoosterFree(handle) -> int:
    with _lock:
        _handles.pop(int(handle), None)
    return 0


@_api
def LGBM_BoosterAddValidData(handle, valid_data) -> int:
    """reference c_api.h:348-355."""
    bst = _get(handle)
    vs = _get(valid_data)
    core = vs.construct(bst.config) if hasattr(vs, "construct") else vs
    _session(bst).add_valid(core, f"valid_{len(bst.gbdt.valid_sets)}")
    return 0


@_api
def LGBM_BoosterGetNumClasses(handle, out=None) -> int:
    out[0] = _get(handle).num_class
    return 0


@_api
def LGBM_BoosterUpdateOneIter(handle, is_finished=None) -> int:
    """reference c_api.h:401-408."""
    fin = _get(handle).update()
    if is_finished is not None:
        is_finished[0] = 1 if fin else 0
    return 0


@_api
def LGBM_BoosterUpdateOneIterCustom(handle, grad, hess,
                                    is_finished=None) -> int:
    """reference c_api.h:410-422 (custom objective gradients)."""
    fin = _get(handle).update(fobj=lambda *_: (np.asarray(grad),
                                               np.asarray(hess)))
    if is_finished is not None:
        is_finished[0] = 1 if fin else 0
    return 0


@_api
def LGBM_BoosterRollbackOneIter(handle) -> int:
    _get(handle).rollback_one_iter()
    return 0


@_api
def LGBM_BoosterGetCurrentIteration(handle, out=None) -> int:
    out[0] = _get(handle).current_iteration
    return 0


@_api
def LGBM_BoosterGetEval(handle, data_idx: int, out=None) -> int:
    """reference c_api.h:458-472: metric values for one dataset
    (0 = training, i = i-th validation set)."""
    bst = _get(handle)
    g = _session(bst)
    if data_idx == 0 and not g.train_metrics:
        g.add_train_metrics()
    results = g.eval_metrics()
    names = ["training"] + g.valid_names
    want = names[data_idx] if data_idx < len(names) else None
    out[0] = [v for (dname, _m, v, _b) in results if dname == want]
    return 0


@_api
def LGBM_BoosterPredictForMat(handle, data, predict_type: int = 0,
                              num_iteration: int = -1, out=None) -> int:
    """reference c_api.h:610-635.  predict_type: 0 normal, 1 raw score,
    2 leaf index, 3 contrib (SHAP)."""
    bst = _get(handle)
    out[0] = bst.predict(np.asarray(data, dtype=np.float64),
                         num_iteration=num_iteration,
                         raw_score=(predict_type == 1),
                         pred_leaf=(predict_type == 2),
                         pred_contrib=(predict_type == 3))
    return 0


@_api
def LGBM_BoosterPredictForCSR(handle, indptr, indices, data, num_col: int,
                              predict_type: int = 0,
                              num_iteration: int = -1, out=None) -> int:
    """reference c_api.h:574-607: CSR prediction (row-chunked densify
    inside Booster.predict — never the whole matrix)."""
    from scipy import sparse as sp
    bst = _get(handle)
    mat = sp.csr_matrix(
        (np.asarray(data, dtype=np.float64),
         np.asarray(indices, dtype=np.int32),
         np.asarray(indptr, dtype=np.int64)),
        shape=(len(indptr) - 1, int(num_col)))
    out[0] = bst.predict(mat, num_iteration=num_iteration,
                         raw_score=(predict_type == 1),
                         pred_leaf=(predict_type == 2),
                         pred_contrib=(predict_type == 3))
    return 0


@_api
def LGBM_BoosterSaveModel(handle, num_iteration: int, filename: str) -> int:
    """reference c_api.h:674-683."""
    _get(handle).save_model(str(filename), num_iteration=num_iteration)
    return 0


@_api
def LGBM_BoosterSaveModelToString(handle, num_iteration: int = -1,
                                  out=None) -> int:
    out[0] = _get(handle).model_to_string(num_iteration=num_iteration)
    return 0


@_api
def LGBM_BoosterDumpModel(handle, num_iteration: int = -1, out=None) -> int:
    """JSON dump (reference c_api.h:694-704)."""
    out[0] = _get(handle).dump_model(num_iteration=num_iteration)
    return 0


@_api
def LGBM_BoosterFeatureImportance(handle, num_iteration: int = -1,
                                  importance_type: int = 0,
                                  out=None) -> int:
    """reference c_api.h:717-728; 0 = split counts, 1 = total gain."""
    out[0] = _get(handle).feature_importance(
        importance_type="split" if importance_type == 0 else "gain",
        num_iteration=num_iteration)
    return 0


@_api
def LGBM_BoosterGetEvalCounts(handle, out=None) -> int:
    """reference c_api.h:430-437: number of metrics per dataset (so C
    callers can size the LGBM_BoosterGetEval result buffer)."""
    bst = _get(handle)
    g = _session(bst)
    if not g.train_metrics:
        g.add_train_metrics()
    out[0] = sum(len(m.names()) for m in g.train_metrics)
    return 0


@_api
def LGBM_BoosterGetEvalNames(handle, out=None) -> int:
    """reference c_api.h:439-446."""
    bst = _get(handle)
    g = _session(bst)
    if not g.train_metrics:
        g.add_train_metrics()
    names: List[str] = []
    for m in g.train_metrics:
        names.extend(m.names())
    out[0] = names
    return 0


# ---------------------------------------------------------------------------
# Network (distributed seam — reference c_api.h:749-762)
# ---------------------------------------------------------------------------
@_api
def LGBM_NetworkInit(machines: str, local_listen_port: int,
                     listen_time_out: int, num_machines: int) -> int:
    """The reference's socket rendezvous (JAX capi.py:468-480): kept
    for call compatibility, warns and succeeds.  Multi-process training
    goes through ``parallel.distributed.initialize`` (every process
    passes the coordinator's address, the world size and its rank) on
    one of two planes: ``collective_transport=tcp`` (the host-side TCP
    transport, every process holding the whole bin matrix) or
    ``collective_transport=xla`` (torch.distributed over NCCL, or gloo
    on the CPU; every process holding only its own rows, with
    ``tree_learner=data``)."""
    if num_machines > 1:
        Log.warning("LGBM_NetworkInit: use "
                    "parallel.distributed.initialize + "
                    "collective_transport=tcp, or collective_transport=xla "
                    "(torch.distributed) with tree_learner=data, instead; "
                    "the machines list is not a rendezvous of the port")
    return 0


@_api
def LGBM_NetworkFree() -> int:
    return 0


@_api
def LGBM_NetworkInitWithFunctions(num_machines: int, rank: int,
                                  reduce_scatter_ext_fun=None,
                                  allgather_ext_fun=None) -> int:
    """The reference's external-collective injection seam
    (c_api.h:760-762; JAX capi.py:486-507).  Training's collectives
    are the port's own (the mesh's shard sums, the tcp plane), so the
    installed callables only serve the host-side simulation API
    (parallel/collectives.py ExternalCollectives); warns so an
    embedder expecting the reference's transport injection knows to
    use parallel.distributed.initialize with collective_transport=tcp or
    xla."""
    from .parallel import collectives
    if num_machines > 1:
        Log.warning(
            "LGBM_NetworkInitWithFunctions: injected collectives are "
            "NOT used by training (the port runs its own collectives); "
            "they are only reachable through the host-side simulation "
            "API. Use parallel.distributed.initialize + "
            "collective_transport=tcp, or collective_transport=xla "
            "(torch.distributed), for real multi-process training.")
    collectives.install_external(num_machines, rank,
                                 reduce_scatter_ext_fun,
                                 allgather_ext_fun)
    return 0


# ---------------------------------------------------------------------------
# getter tail (reference c_api.h:316-739) — the long tail third-party
# bindings end up needing
# ---------------------------------------------------------------------------
@_api
def LGBM_DatasetGetSubset(handle, used_row_indices, num_used_row_indices,
                          parameters: str, out=None) -> int:
    """reference c_api.h:195-210 — bagging-style row subset sharing the
    parent's bin mappers."""
    ds = _get(handle)
    idx = np.asarray(used_row_indices,
                     dtype=np.int64)[:int(num_used_row_indices)]
    sub = ds.subset(idx, params=_parse_params(parameters) or None)
    out[0] = _register(sub)
    return 0


@_api
def LGBM_DatasetSetFeatureNames(handle, feature_names,
                                num_feature_names: int) -> int:
    """reference c_api.h:212-218."""
    ds = _get(handle)
    names = [str(feature_names[i]) for i in range(int(num_feature_names))]
    ds.feature_name = names
    core = getattr(ds, "_core", None)
    if core is not None and not callable(getattr(core, "construct", None)):
        core.feature_names = names
    return 0


@_api
def LGBM_DatasetGetFeatureNames(handle, out_strs=None, out_len=None
                                ) -> int:
    """reference c_api.h:220-230 (out_strs: list receiving the
    names)."""
    ds = _get(handle)
    names = None
    core = getattr(ds, "_core", None)
    if core is not None:
        names = getattr(core, "feature_names", None)
    if names is None:
        names = getattr(ds, "feature_name", None)
    if names in (None, "auto"):
        names = []
    out_strs[:] = list(names)
    if out_len is not None:
        out_len[0] = len(names)
    return 0


@_api
def LGBM_BoosterMerge(handle, other_handle) -> int:
    """reference c_api.h:330-338 — append the other booster's trees."""
    bst = _get(handle)
    other = _get(other_handle)
    bst._sync_models()
    other._sync_models()
    import copy as _copy
    # deep copies: merged trees must not alias the source booster's
    # mutable Tree objects (SetLeafValue on one would corrupt the other)
    bst.models.extend(_copy.deepcopy(t) for t in other.models)
    if bst.gbdt is not None:
        # keep the per-model scale bookkeeping aligned so later
        # flushes can reconcile (the foreign trees are final: scale 1)
        for _ in other.models:
            bst.gbdt._tree_scale.append(1.0)
            bst.gbdt._applied_scale.append(1.0)
    bst._drop_predictors()
    bst._device_stale = True   # in-session stacks no longer match
    return 0


@_api
def LGBM_BoosterNumberOfTotalModel(handle, out_models=None) -> int:
    """reference c_api.h:376-383."""
    out_models[0] = _get(handle).num_trees()
    return 0


@_api
def LGBM_BoosterGetNumPredict(handle, data_idx: int,
                              out_len=None) -> int:
    """reference c_api.h:520-530 — prediction count for train (0) or
    valid set data_idx-1."""
    bst = _get(handle)
    g = _session(bst)
    if data_idx == 0:
        n = g.num_data
    else:
        n = g.valid_sets[data_idx - 1].num_data
    out_len[0] = n * max(bst.num_tree_per_iteration, 1)
    return 0


@_api
def LGBM_BoosterGetPredict(handle, data_idx: int, out_len=None,
                           out_result=None) -> int:
    """reference c_api.h:532-548 / gbdt.cpp:691-728 GetPredictAt:
    converted (sigmoid/softmax) scores of the training set (0) or
    validation set data_idx-1, class-major."""
    bst = _get(handle)
    g = _session(bst)
    if data_idx == 0:
        raw = g.scores[:, :g.num_data]
    else:
        vs = g.valid_sets[data_idx - 1]
        raw = vs.scores
    raw = raw.cpu().numpy().astype(np.float64)
    k = max(bst.num_tree_per_iteration, 1)
    conv = raw.T  # (n, k)
    if not bst.average_output:
        conv = bst._convert_output(conv)
    flat = np.asarray(conv).T.reshape(-1)  # class-major like reference
    n = flat.shape[0]
    if out_result is not None:
        out_result[:n] = flat
    if out_len is not None:
        out_len[0] = n
    return 0


@_api
def LGBM_BoosterGetLeafValue(handle, tree_idx: int, leaf_idx: int,
                             out_val=None) -> int:
    """reference c_api.h:433-443."""
    bst = _get(handle)
    bst._sync_models()
    out_val[0] = float(bst.models[int(tree_idx)].leaf_value[int(leaf_idx)])
    return 0


@_api
def LGBM_BoosterSetLeafValue(handle, tree_idx: int, leaf_idx: int,
                             val: float) -> int:
    """reference c_api.h:445-456 — host-tree mutation invalidates the
    device predict caches (same staleness rule as refit)."""
    bst = _get(handle)
    bst._sync_models()
    bst.models[int(tree_idx)].leaf_value[int(leaf_idx)] = float(val)
    bst._device_stale = True
    bst._drop_predictors()
    return 0


@_api
def LGBM_BoosterResetParameter(handle, parameters: str) -> int:
    """reference c_api.h:395-403 — currently learning_rate (the
    parameter the reference's reset path exercises in tests) plus any
    plain config scalars."""
    _get(handle).reset_parameter(_parse_params(parameters))
    return 0


@_api
def LGBM_BoosterPredictForFile(handle, data_filename: str,
                               data_has_header: int, predict_type: int,
                               num_iteration: int, parameter: str,
                               result_filename: str) -> int:
    """reference c_api.h:495-518 — batch file prediction written as
    one row per line (tab-separated for multi-output)."""
    bst = _get(handle)
    from .cli import write_predictions
    from .data_loader import load_file
    cfg = Config.from_params(dict(_parse_params(parameter),
                                  has_header=bool(data_has_header)))
    X, _, _ = load_file(str(data_filename), cfg)
    pred = bst.predict(
        X, num_iteration=int(num_iteration),
        raw_score=predict_type == 1, pred_leaf=predict_type == 2,
        pred_contrib=predict_type == 3)
    write_predictions(str(result_filename), pred, X.shape[0])
    return 0


# ---------------------------------------------------------------------------
# round-4 tail: the 7 symbols the r3 audit found missing
# ---------------------------------------------------------------------------
def LGBM_SetLastError(msg: str) -> int:
    """reference c_api.h:768 — let embedders (custom objectives calling
    back into the host) set the error slot themselves."""
    _last_error[0] = str(msg)
    return 0


@_api
def LGBM_DatasetCreateByReference(reference, num_total_row: int,
                                  out=None) -> int:
    """reference c_api.h: create an empty dataset aligned to an
    existing one's bin mappers, awaiting PushRows chunks — the
    streaming path used when workers bin against a coordinator's
    mappers."""
    from .dataset import Dataset as CoreDataset
    ref_obj = _get(reference)
    ref_core = ref_obj.construct() if hasattr(ref_obj, "construct") \
        else ref_obj
    core = CoreDataset.from_reference_for_push(ref_core,
                                               int(num_total_row))
    out[0] = _register(_PushableDataset(core))
    return 0


@_api
def LGBM_BoosterResetTrainingData(handle, train_data) -> int:
    """reference c_api.h:352-360: swap the training dataset of an
    existing booster (continued training on refreshed data)."""
    bst = _get(handle)
    ds = _get(train_data)
    core = ds.construct(bst.config) if hasattr(ds, "construct") else ds
    bst.reset_training_data(core)
    return 0


@_api
def LGBM_BoosterGetNumFeature(handle, out=None) -> int:
    """reference c_api.h:443-450 (LGBM_BoosterGetNumFeature)."""
    out[0] = _get(handle).num_feature()
    return 0


@_api
def LGBM_BoosterGetFeatureNames(handle, out_strs=None,
                                out_len=None) -> int:
    """reference c_api.h:430-441: feature names of the booster's
    model (post-training they come from the model, not the dataset)."""
    names = list(_get(handle).feature_name())
    if out_len is not None:
        out_len[0] = len(names)
    if out_strs is not None:
        out_strs[0] = names
    return 0


@_api
def LGBM_BoosterCalcNumPredict(handle, num_row: int, predict_type: int,
                               num_iteration: int = -1,
                               out_len=None) -> int:
    """reference c_api.h:520-535: result-buffer size for a prediction
    call — rows x per-row outputs (classes, leaves, or contribs)."""
    bst = _get(handle)
    ncls = bst.num_tree_per_iteration
    cur = bst.current_iteration
    # reference semantics: num_iteration <= 0 means all iterations
    n_iter = cur if num_iteration <= 0 else min(int(num_iteration), cur)
    if predict_type == 2:                      # leaf indices
        per_row = ncls * n_iter
    elif predict_type == 3:                    # SHAP contribs
        per_row = ncls * (bst.num_feature() + 1)
    else:                                      # raw / normal
        per_row = ncls
    out_len[0] = int(num_row) * per_row
    return 0


@_api
def LGBM_BoosterPredictForCSC(handle, col_ptr, indices, data,
                              num_row: int, predict_type: int = 0,
                              num_iteration: int = -1, out=None) -> int:
    """reference c_api.h:626-659: CSC prediction — the transposed
    sibling of the CSR path (converted column-major -> row-major
    sparse, then the same chunked sparse predict)."""
    from scipy import sparse as sp
    bst = _get(handle)
    ncol = len(col_ptr) - 1
    mat = sp.csc_matrix(
        (np.asarray(data, dtype=np.float64),
         np.asarray(indices, dtype=np.int32),
         np.asarray(col_ptr, dtype=np.int64)),
        shape=(int(num_row), ncol)).tocsr()
    out[0] = bst.predict(mat, num_iteration=num_iteration,
                         raw_score=(predict_type == 1),
                         pred_leaf=(predict_type == 2),
                         pred_contrib=(predict_type == 3))
    return 0
