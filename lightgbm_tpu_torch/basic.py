"""User-facing Dataset (lazy): wraps raw data and constructs the binned
core dataset when training starts, so bin mappers are fitted with the
final parameter set exactly once (port of lightgbm_tpu/basic.py).

``data`` is a numpy, scipy-sparse or pandas matrix, or the path of a
file: a binary cache (``save_binary``; sniffed by its token), else a
csv/tsv/libsvm text file, parsed whole (``data_loader.load_file``) or,
with ``use_two_round_loading``, streamed twice (a reservoir sample for
the bin mappers, then the rows chunk by chunk into the bin matrix).
``sharded_shards > 1`` is refused: sharded construction is not ported.

Categorical columns come from ``categorical_feature`` (indices or
column names) or, with ``"auto"``, a pandas frame's ``category``
columns; those encode as their category codes, and a validation or
prediction frame encodes against the training categories
(``pandas_categorical``).  pandas is never imported unless the caller
hands in a pandas object."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np

from .config import Config
from .dataset import Dataset as CoreDataset
from .utils.log import Log


class Dataset:
    """Lazy dataset handle (the lgb.Dataset analog).  With
    ``free_raw_data`` (the default, as in the JAX package and the
    reference) the raw matrix is dropped once the bins are built;
    continued training (``init_model``) needs it kept.  ``group`` (query
    sizes) goes to the core's ``Metadata``, for lambdarank and the rank
    metrics."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, Sequence[str]] = "auto",
                 categorical_feature: Union[str, Sequence] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._core: Optional[CoreDataset] = None

    def construct(self, config: Optional[Config] = None) -> CoreDataset:
        if self._core is not None:
            return self._core
        if config is None:
            config = Config.from_params(self.params)
        if config.sharded_shards > 1 and self.reference is None:
            Log.fatal("sharded construction (sharded_shards > 1) is not "
                      "ported yet; drop sharded_shards")
        data = self.data
        label = self.label
        if isinstance(data, str):
            from .dataset_io import is_binary_file, load_binary
            if is_binary_file(data):
                # a saved binary cache loads wherever a text file would
                # (the reference sniffs its token on every file load);
                # the run's bin_packing is checked against the cache's
                self._core = load_binary(data, config=config)
                return self._set_given_fields()
        streaming_ok = (isinstance(data, str)
                        and config.use_two_round_loading
                        and self.reference is None
                        and not isinstance(self.categorical_feature,
                                           (list, tuple)))
        if (isinstance(data, str) and config.use_two_round_loading
                and not streaming_ok):
            Log.warning("two_round loading does not support reference-"
                        "aligned or explicitly-categorical datasets yet; "
                        "falling back to in-RAM loading")
        if streaming_ok:
            # two-round streaming: the float matrix never exists
            from .data_loader import load_file_streaming
            self._core = load_file_streaming(data, config)
            self._core.pandas_categorical = None
            return self._set_given_fields()
        if isinstance(data, str):
            from .data_loader import load_file
            data, label_from_file, extras = load_file(data, config)
            if label is None:
                label = label_from_file
            if self.weight is None and extras.get("weight") is not None:
                self.weight = extras["weight"]
            if self.group is None and extras.get("group") is not None:
                self.group = extras["group"]
            # (a <data>.init side file is applied only when streaming,
            # as in lightgbm_tpu/basic.py)
            if self.categorical_feature == "auto" \
                    and extras.get("categorical_feature"):
                # the CLI's categorical_column, resolved by the loader
                # into indices of the returned columns
                self.categorical_feature = extras["categorical_feature"]
        ref_core = None
        if self.reference is not None:
            ref_core = self.reference.construct(config) \
                if hasattr(self.reference, "construct") else self.reference
        # validation frames encode pandas categoricals against the
        # training set's category lists
        train_cats = getattr(ref_core, "pandas_categorical", None)
        pandas_cats = (train_cats if train_cats is not None
                       else _pandas_categories(self.data))
        data = _to_matrix(data, train_cats)
        if _is_sparse(data) and not config.is_enable_sparse:
            # is_enable_sparse=false: bin the dense matrix
            data = np.ascontiguousarray(
                np.asarray(data.todense(), dtype=np.float64))
        names, cats = self._resolve_columns()
        self._core = CoreDataset.from_matrix(
            data, label=label, weight=self.weight, group=self.group,
            config=config, categorical_features=cats, feature_names=names,
            reference=ref_core)
        self._core.pandas_categorical = pandas_cats
        # (K, N) class-major, flattened (or (N,) with one class)
        self._core.metadata.set_init_score(self.init_score)
        if self.free_raw_data:
            self._core._raw_data = None
            self.data = None
        return self._core

    def _set_given_fields(self) -> CoreDataset:
        """A core read from a file (a binary cache, or two-round
        streaming) takes the label, weight, group, init score and
        feature names given to this handle over the file's."""
        core = self._core
        if self.label is not None:
            core.metadata.set_label(self.label)
        if self.weight is not None:
            core.metadata.set_weight(self.weight)
        if self.group is not None:
            core.metadata.set_group(self.group)
        if self.init_score is not None:
            core.metadata.set_init_score(self.init_score)
        if isinstance(self.feature_name, (list, tuple)):
            core.feature_names = list(self.feature_name)
        return core

    def construct_aligned(self, ref_core, config) -> CoreDataset:
        """Construct with bins aligned to ``ref_core`` unless a
        reference was set explicitly."""
        if self._core is None and self.reference is None:
            self.reference = ref_core
        return self.construct(config)

    def set_label(self, label):
        self.label = label
        if self._core is not None:
            self._core.metadata.set_label(label)
        return self

    def set_weight(self, weight):
        self.weight = weight
        if self._core is not None:
            self._core.metadata.set_weight(weight)
        return self

    def set_group(self, group):
        self.group = group
        if self._core is not None:
            self._core.metadata.set_group(group)
        return self

    def set_init_score(self, init_score):
        self.init_score = init_score
        if self._core is not None:
            self._core.metadata.set_init_score(init_score)
        return self

    def set_field(self, name, data):
        if name == "label":
            return self.set_label(data)
        if name == "weight":
            return self.set_weight(data)
        if name in ("group", "query"):
            return self.set_group(data)
        if name == "init_score":
            return self.set_init_score(data)
        Log.fatal(f"Unknown field {name}")

    def get_field(self, name):
        if self._core is not None:
            return self._core.metadata.get_field(name)
        return {"label": self.label, "weight": self.weight,
                "group": self.group, "init_score": self.init_score}.get(name)

    def get_label(self):
        return self.get_field("label")

    def get_weight(self):
        return self.get_field("weight")

    def get_group(self):
        return self.get_field("group")

    def get_init_score(self):
        return self.get_field("init_score")

    def num_data(self) -> int:
        if self._core is not None:
            return self._core.num_data
        d = self.data
        if isinstance(d, str):
            Log.fatal("Cannot get num_data before construction of a "
                      "file-backed Dataset")
        if _is_sparse(d):
            return d.shape[0]
        return _to_matrix(d).shape[0]

    def num_feature(self) -> int:
        if self._core is not None:
            return self._core.num_total_features
        if _is_sparse(self.data):
            return self.data.shape[1]
        return _to_matrix(self.data).shape[1]

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Align this dataset's bin mappers to another's (reference
        basic.py Dataset.set_reference).  Must precede construct."""
        if self._core is not None and reference is not self.reference:
            Log.fatal("Cannot set reference after the Dataset has "
                      "been constructed; create a new Dataset")
        self.reference = reference
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        """Name the columns (lightgbm_tpu/basic.py set_feature_name)."""
        if isinstance(feature_name, (list, tuple)):
            nf = None
            if self._core is not None:
                nf = self._core.num_total_features
            elif getattr(self.data, "ndim", 0) == 2:
                nf = self.data.shape[1]
            if nf is not None and len(feature_name) != nf:
                Log.fatal(f"Length of feature_name "
                          f"({len(feature_name)}) does not match the "
                          f"number of features ({nf})")
            if self._core is not None:
                self._core.feature_names = list(feature_name)
        self.feature_name = feature_name
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """Set the categorical columns (lightgbm_tpu/basic.py
        set_categorical_feature): they shape the bin mappers, so a
        different set after construction is fatal."""
        if self._core is not None and \
                categorical_feature != self.categorical_feature:
            Log.fatal("Cannot set categorical feature after the "
                      "Dataset has been constructed; create a new "
                      "Dataset")
        self.categorical_feature = categorical_feature
        return self

    def get_ref_chain(self, ref_limit: int = 100) -> set:
        """The set of datasets reachable through ``.reference`` links
        (reference basic.py Dataset.get_ref_chain)."""
        head = self
        chain = set()
        count = 0
        while count < ref_limit:
            chain.add(head)
            if head.reference is not None and head.reference not in chain:
                head = head.reference
                count += 1
            else:
                break
        return chain

    def subset(self, used_indices, params=None) -> "Dataset":
        if self.data is None:
            Log.fatal("Cannot subset: raw data was freed — construct "
                      "the Dataset with free_raw_data=False")
        if _is_sparse(self.data):
            data = self.data.tocsr()[used_indices]
        else:
            data = _to_matrix(self.data)[used_indices]
        label = (None if self.label is None
                 else np.asarray(self.label)[used_indices])
        weight = (None if self.weight is None
                  else np.asarray(self.weight)[used_indices])
        return Dataset(data, label=label, weight=weight,
                       feature_name=self.feature_name,
                       categorical_feature=self.categorical_feature,
                       params=params or self.params, reference=self)

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       feature_name=self.feature_name,
                       categorical_feature=self.categorical_feature,
                       params=params or self.params)

    def save_binary(self, filename: str) -> "Dataset":
        from .dataset_io import save_binary
        save_binary(self.construct(), filename)
        return self


    def _resolve_columns(self):
        """(feature names or None, categorical column indices):
        ``categorical_feature`` names resolve against the feature names
        (given, or a pandas frame's columns), and ``"auto"`` takes a
        pandas frame's ``category`` columns (lightgbm_tpu/basic.py
        _resolve_columns)."""
        feature_names = None
        if isinstance(self.feature_name, (list, tuple)):
            feature_names = list(self.feature_name)
        elif _is_pandas(self.data):
            feature_names = [str(c) for c in self.data.columns]
        cat_indices = []
        cf = self.categorical_feature
        if isinstance(cf, (list, tuple)):
            for c in cf:
                if isinstance(c, str):
                    if feature_names and c in feature_names:
                        cat_indices.append(feature_names.index(c))
                    else:
                        Log.warning(f"Unknown categorical column {c}")
                else:
                    cat_indices.append(int(c))
        elif cf == "auto" and _is_pandas(self.data):
            for i, dtype in enumerate(self.data.dtypes):
                if str(dtype) == "category":
                    cat_indices.append(i)
        return feature_names, cat_indices


def _is_sparse(obj) -> bool:
    return hasattr(obj, "tocsc") and hasattr(obj, "nnz")


def _is_pandas(obj) -> bool:
    """A pandas object, told by its type's module (pandas itself is not
    imported)."""
    return type(obj).__module__.startswith("pandas") and \
        hasattr(obj, "dtypes")


def _to_matrix(data, pandas_categorical=None) -> np.ndarray:
    """Raw input -> float64 matrix (sparse input stays sparse).  A
    pandas frame's category columns encode as their category codes;
    with ``pandas_categorical`` (the training frame's category lists,
    in categorical-column order) the codes are taken against those
    lists, so a frame with reordered or fewer categories maps the same
    way, and an unseen category becomes NaN (lightgbm_tpu/basic.py
    _to_matrix)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.astype(np.float64, copy=False))
    if _is_pandas(data) and not hasattr(data, "columns"):
        # a Series: one row of raw features
        return np.ascontiguousarray(np.asarray(data, dtype=np.float64))
    if _is_pandas(data):
        import pandas as pd
        n_cat = sum(1 for c in data.columns
                    if str(data[c].dtype) == "category")
        if pandas_categorical is not None \
                and n_cat != len(pandas_categorical):
            raise ValueError(
                "train and valid/predict dataset categorical_feature do "
                f"not match: trained with {len(pandas_categorical)} "
                f"categorical columns, got {n_cat}")
        cols = []
        i_cat = 0
        for c in data.columns:
            col = data[c]
            if str(col.dtype) == "category":
                if pandas_categorical is not None:
                    codes = pd.Categorical(
                        col, categories=pandas_categorical[i_cat]
                    ).codes.astype(np.float64)
                    codes[codes < 0] = np.nan
                else:
                    codes = col.cat.codes.to_numpy().astype(np.float64)
                cols.append(codes)
                i_cat += 1
            else:
                cols.append(col.to_numpy().astype(np.float64))
        return np.ascontiguousarray(np.stack(cols, axis=1))
    if _is_sparse(data):
        return data.tocsc()
    return np.ascontiguousarray(np.asarray(data, dtype=np.float64))


def _pandas_categories(data):
    """The category lists of a pandas frame's category columns, in
    column order (the model's ``pandas_categorical``), or None."""
    if not _is_pandas(data):
        return None
    cats = [list(data[c].cat.categories) for c in data.columns
            if str(data[c].dtype) == "category"]
    return cats or None
