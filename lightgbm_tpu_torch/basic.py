"""User-facing Dataset (lazy): wraps raw data and constructs the binned
core dataset when training starts, so bin mappers are fitted with the
final parameter set exactly once (port of lightgbm_tpu/basic.py for
in-memory numpy / scipy-sparse input)."""
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
    sizes) goes to the core's ``Metadata``; training with groups waits
    for lambdarank and raises."""

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
        data = _to_matrix(self.data)
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, (list, tuple)) else None)
        cats = ([int(c) for c in self.categorical_feature]
                if isinstance(self.categorical_feature, (list, tuple))
                else [])
        self._core = CoreDataset.from_matrix(
            data, label=self.label, weight=self.weight, group=self.group,
            config=config, categorical_features=cats, feature_names=names,
            reference=ref_core)
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
        """Categorical columns are not ported yet: a non-empty list
        raises."""
        if isinstance(categorical_feature, (list, tuple)) \
                and len(categorical_feature) > 0:
            raise NotImplementedError(
                "categorical features are not ported yet")
        self.categorical_feature = categorical_feature
        return self


def _is_sparse(obj) -> bool:
    return hasattr(obj, "tocsc") and hasattr(obj, "nnz")


def _to_matrix(data) -> np.ndarray:
    """Raw input -> float64 matrix (sparse input stays sparse)."""
    if _is_sparse(data):
        return data.tocsc()
    return np.ascontiguousarray(np.asarray(data, dtype=np.float64))
