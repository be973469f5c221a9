"""User-facing Dataset (lazy): wraps raw data and constructs the binned
core dataset when training starts, so bin mappers are fitted with the
final parameter set exactly once (port of lightgbm_tpu/basic.py for
in-memory numpy, scipy-sparse and pandas input).

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
        ref_core = None
        if self.reference is not None:
            ref_core = self.reference.construct(config) \
                if hasattr(self.reference, "construct") else self.reference
        # validation frames encode pandas categoricals against the
        # training set's category lists
        train_cats = getattr(ref_core, "pandas_categorical", None)
        pandas_cats = (train_cats if train_cats is not None
                       else _pandas_categories(self.data))
        data = _to_matrix(self.data, train_cats)
        names, cats = self._resolve_columns()
        self._core = CoreDataset.from_matrix(
            data, label=self.label, weight=self.weight, group=self.group,
            config=config, categorical_features=cats, feature_names=names,
            reference=ref_core)
        self._core.pandas_categorical = pandas_cats
        # (K, N) class-major, flattened (or (N,) with one class)
        self._core.metadata.set_init_score(self.init_score)
        if self.free_raw_data:
            self._core._raw_data = None
            self.data = None
        return self._core

    def construct_aligned(self, ref_core, config) -> CoreDataset:
        """Construct with bins aligned to ``ref_core`` unless a
        reference was set explicitly."""
        if self._core is None and self.reference is None:
            self.reference = ref_core
        return self.construct(config)

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
