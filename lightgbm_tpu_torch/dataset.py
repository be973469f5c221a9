"""Binned dataset: the host side of the device training matrix.

TPU-native re-design of the reference's Dataset/FeatureGroup/Metadata
(reference: include/LightGBM/dataset.h:282-609, feature_group.h:18-230,
src/io/dataset.cpp, src/io/metadata.cpp).  Key representation change:
instead of per-group Bin objects (dense/sparse/4-bit) in row order plus
leaf-ordered sparse copies, the whole training set is ONE packed
``(num_data, num_groups)`` uint8 matrix that lives in HBM, sharded over
the mesh row axis for data-parallel training.  Exclusive-feature-bundle
groups keep the reference's bin-offset scheme (offset 0 = shared default
slot, feature_group.h:34-51/128-136) so EFB plugs in without kernel
changes; the per-feature view is recovered on device by a precomputed
``(F, max_bin)`` gather map plus the FixHistogram default-bin
reconstruction (dataset.cpp:776-795).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .binning import (BIN_CATEGORICAL, MISSING_NAN, BinMapper,
                      find_bin_mappers, resolve_construct_threads)
from .config import Config
from .packing import (CRUMB_MAX_BIN, NIBBLE_MAX_BIN, BinLayout,
                      build_layout, resolve_bin_packing)
from .utils.log import Log


class Metadata:
    """Labels, weights, query boundaries, init scores
    (reference dataset.h:36-248, src/io/metadata.cpp)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label = np.zeros(num_data, dtype=np.float32)
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None  # (num_queries+1,)
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label: Sequence[float]) -> None:
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            Log.fatal(f"Length of label ({len(label)}) != num_data ({self.num_data})")
        self.label = label

    def set_weight(self, weight: Optional[Sequence[float]]) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        if len(weight) != self.num_data:
            Log.fatal(f"Length of weight ({len(weight)}) != num_data ({self.num_data})")
        self.weight = weight

    def set_group(self, group: Optional[Sequence[int]]) -> None:
        """``group`` is per-query sizes (python API convention); converted
        to cumulative boundaries (reference metadata.cpp query_boundaries_)."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).reshape(-1)
        bounds = np.concatenate([[0], np.cumsum(group)])
        if bounds[-1] != self.num_data:
            Log.fatal(f"Sum of query counts ({bounds[-1]}) != num_data ({self.num_data})")
        self.query_boundaries = bounds.astype(np.int32)

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        if init_score is None:
            self.init_score = None
            return
        arr = np.asarray(init_score, dtype=np.float64).reshape(-1)
        if len(arr) % self.num_data != 0:
            Log.fatal("Initial score size doesn't match data size")
        self.init_score = arr

    @property
    def num_queries(self) -> int:
        if self.query_boundaries is None:
            return 0
        return len(self.query_boundaries) - 1

    def get_field(self, name: str):
        if name == "label":
            return self.label
        if name == "weight":
            return self.weight
        if name == "init_score":
            return self.init_score
        if name == "group":
            if self.query_boundaries is None:
                return None
            return np.diff(self.query_boundaries)
        Log.fatal(f"Unknown field {name}")

    def set_field(self, name: str, data) -> None:
        if name == "label":
            self.set_label(data)
        elif name == "weight":
            self.set_weight(data)
        elif name == "init_score":
            self.set_init_score(data)
        elif name in ("group", "query"):
            self.set_group(data)
        else:
            Log.fatal(f"Unknown field {name}")


class FeatureView:
    """Per-feature device-facing metadata: where the feature's bins live
    inside its group column and how missing values are encoded."""

    __slots__ = ("feature_idx", "group", "sub", "offset", "num_bin",
                 "default_bin", "missing_type", "is_categorical", "mapper",
                 "collapsed_default")

    def __init__(self, feature_idx: int, group: int, sub: int, offset: int,
                 mapper: BinMapper, collapsed_default: bool):
        self.feature_idx = feature_idx
        self.group = group
        self.sub = sub
        self.offset = offset          # group-bin index of this feature's bin
        self.num_bin = mapper.num_bin
        self.default_bin = mapper.default_bin
        self.missing_type = mapper.missing_type
        self.is_categorical = mapper.bin_type == BIN_CATEGORICAL
        self.mapper = mapper
        # True when the feature shares the group's bin-0 default slot
        # (multi-feature bundles, feature_group.h:128-136)
        self.collapsed_default = collapsed_default


class Dataset:
    """The binned training matrix + metadata (host side).

    ``group_bins`` is the packed (num_data, num_groups) uint8 matrix; the
    device training path uploads it once per training run (the analog of
    GPUTreeLearner::AllocateGPUMemory's one-time upload,
    gpu_tree_learner.cpp:234-556).
    """

    def __init__(self):
        self.num_data = 0
        self.num_total_features = 0
        self.mappers: List[BinMapper] = []
        self.used_features: List[int] = []       # real idx of non-trivial features
        self.features: List[FeatureView] = []    # one per used feature
        # STORAGE bin matrix: (N, G) uint8 when bin_layout is None;
        # nibble-packed (N, bin_layout.cols) otherwise (packing.py —
        # the first packed_groups groups ride two per byte)
        self.group_bins: Optional[np.ndarray] = None
        self.bin_layout: Optional[BinLayout] = None
        self.group_num_bin: List[int] = []
        self.group_is_multi: List[bool] = []
        self.metadata: Metadata = Metadata(0)
        self.feature_names: List[str] = []
        self.max_bin = 255
        self.config: Optional[Config] = None
        self.monotone_constraints: Optional[np.ndarray] = None
        self._raw_data: Optional[np.ndarray] = None
        self._categorical_features: List[int] = []
        # a pandas training frame's category lists (set by basic.Dataset)
        self.pandas_categorical: Optional[list] = None
        self._bundles: List[List[int]] = []

    # ------------------------------------------------------------------
    @property
    def num_features(self) -> int:
        return len(self.features)

    @property
    def num_groups(self) -> int:
        return len(self.group_num_bin)

    @property
    def label(self) -> np.ndarray:
        return self.metadata.label

    # reference-compatible accessors: custom fobj/feval callbacks are
    # handed this core object and expect the python package's
    # Dataset.get_label()/get_weight()/get_group() surface
    def get_field(self, name: str):
        return self.metadata.get_field(name)

    def get_label(self):
        return self.get_field("label")

    def get_weight(self):
        return self.get_field("weight")

    def get_group(self):
        return self.get_field("group")

    def get_init_score(self):
        return self.get_field("init_score")

    # ------------------------------------------------------------------
    @classmethod
    def from_matrix(cls, data: np.ndarray, label=None, weight=None,
                    group=None, init_score=None,
                    config: Optional[Config] = None,
                    categorical_features: Optional[Sequence[int]] = None,
                    feature_names: Optional[Sequence[str]] = None,
                    reference: Optional["Dataset"] = None) -> "Dataset":
        """Build from an in-memory float matrix or a scipy sparse
        matrix — the analog of LGBM_DatasetCreateFromMat / FromCSR/CSC
        -> CostructFromSampleData (reference c_api.cpp:424+,
        dataset_loader.cpp:488-610; sparse classes
        src/io/sparse_bin.hpp:68-456).

        Sparse input is NEVER densified whole: sampling, EFB conflict
        counting and bin-matrix construction all walk the CSC columns,
        so host memory is bounded by nnz + the packed (N, G) uint8
        output (the per-bundle-densify design — the uint8 matrix IS the
        HBM-resident training representation)."""
        config = config or Config()
        sparse = hasattr(data, "tocsc") and hasattr(data, "nnz")
        if sparse:
            data = data.tocsc()
            data.sort_indices()
        else:
            data = np.asarray(data, dtype=np.float64)
            if data.ndim != 2:
                raise ValueError("data must be 2-dimensional")
        num_data, num_features = data.shape

        self = cls()
        self.config = config
        self.num_data = num_data
        self.num_total_features = num_features
        self.max_bin = config.max_bin
        self.feature_names = list(feature_names) if feature_names else [
            f"Column_{i}" for i in range(num_features)]

        if reference is not None:
            # validation sets share the training set's bin mappers
            # (reference basic.py reference-alignment / dataset.h CopyFeatureMapperFrom)
            if reference.num_total_features != num_features:
                Log.fatal("Validation data has different number of features "
                          f"({num_features} vs {reference.num_total_features})")
            self.mappers = reference.mappers
            self.used_features = list(reference.used_features)
            self.max_bin = reference.max_bin
            self._build_groups(reference=reference)
        else:
            cat_set = set(categorical_features or [])
            sampler = (_sample_feature_values_sparse if sparse
                       else _sample_feature_values)
            sample_vals, total_cnt, sample_rows = sampler(
                data, config.bin_construct_sample_cnt, config.data_random_seed)
            self.mappers = self._fit_mappers(sample_vals, total_cnt,
                                             config, cat_set)
            self.used_features = [i for i, m in enumerate(self.mappers)
                                  if not m.is_trivial]
            if not self.used_features:
                Log.warning("There are no meaningful features; "
                            "all features are constant or filtered")
            self._build_groups(reference=None, sample_nonzero=sample_rows,
                               sample_cnt=total_cnt)

        if sparse:
            self._bin_data_sparse(data)
        else:
            self._bin_data(data)
        self._raw_data = data
        self._categorical_features = list(categorical_features or [])
        self.metadata = Metadata(num_data)
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weight(weight)
        self.metadata.set_group(group)
        self.metadata.set_init_score(init_score)
        self._resolve_monotone(config)
        return self

    # ------------------------------------------------------------------
    @classmethod
    def from_sampled_columns(cls, sample_vals: List[np.ndarray],
                             sample_rows: List[np.ndarray],
                             total_sample: int, num_data: int,
                             config: Optional[Config] = None,
                             categorical_features=None,
                             feature_names=None) -> "Dataset":
        """Streaming construction, step 1: fit bin mappers from sampled
        per-column values, allocate the packed (N, G) uint8 matrix, and
        return a dataset awaiting ``push_rows`` chunks + ``finish_load``
        — the two-round / LGBM_DatasetCreateFromSampledColumn +
        PushRows protocol (reference c_api.h:68-145,
        dataset_loader.cpp:180-265).  The float matrix never exists:
        peak host memory is samples + one chunk + the uint8 matrix.

        Args:
          sample_vals: per-feature sampled non-zero (or NaN) values.
          sample_rows: per-feature row indices of those values within
            the sample (feeds EFB conflict counting).
          total_sample: number of sampled rows (zeros implicit).
          num_data: full row count being pushed.
        """
        config = config or Config()
        self = cls()
        self.config = config
        self.num_data = num_data
        self.num_total_features = len(sample_vals)
        self.max_bin = config.max_bin
        self.feature_names = list(feature_names) if feature_names else [
            f"Column_{i}" for i in range(len(sample_vals))]
        cat_set = set(categorical_features or [])
        self.mappers = self._fit_mappers(sample_vals, total_sample,
                                         config, cat_set)
        self.used_features = [i for i, m in enumerate(self.mappers)
                              if not m.is_trivial]
        self._build_groups(reference=None, sample_nonzero=sample_rows,
                           sample_cnt=total_sample)
        self._init_push_storage(list(categorical_features or []))
        return self

    @classmethod
    def from_reference_for_push(cls, ref: "Dataset",
                                num_data: int) -> "Dataset":
        """Streaming construction aligned to an existing dataset's bin
        mappers (reference LGBM_DatasetCreateByReference, c_api.h —
        the distributed/streaming analog of validation-set alignment):
        allocates the packed matrix for ``num_data`` rows and awaits
        ``push_rows`` chunks + ``finish_load``."""
        self = cls()
        self.config = ref.config
        self.num_data = int(num_data)
        self.num_total_features = ref.num_total_features
        self.max_bin = ref.max_bin
        self.feature_names = list(ref.feature_names)
        self.mappers = ref.mappers
        self.used_features = list(ref.used_features)
        self._build_groups(reference=ref)
        self._init_push_storage(list(
            getattr(ref, "_categorical_features", [])))
        return self

    def _init_push_storage(self, categorical_features) -> None:
        """Shared streaming-construction tail (from_sampled_columns /
        from_reference_for_push): allocate the packed matrix, prefill
        implicit-zero bins so sparse (CSR) pushes only write stored
        entries, and arm the pushed-row counter."""
        self.group_bins = np.zeros(
            (self.num_data, self._storage_cols()), dtype=np.uint8)
        for f in self.features:
            if not f.collapsed_default:
                zb = int(np.asarray(
                    self.mappers[f.feature_idx].value_to_bin(
                        np.zeros(1)))[0])
                if zb != 0:
                    if self.bin_layout is not None:
                        self.bin_layout.fill_group(self.group_bins,
                                                   f.group, zb)
                    else:
                        self.group_bins[:, f.group] = zb
        self.metadata = Metadata(self.num_data)
        self._categorical_features = categorical_features
        self._resolve_monotone(self.config)
        self._pushed_rows = 0

    def push_rows(self, chunk: np.ndarray, row_start: int) -> None:
        """Streaming construction, step 2: bin one dense float chunk
        (reference LGBM_DatasetPushRows, c_api.h:100-120)."""
        chunk = np.asarray(chunk, dtype=np.float64)
        if chunk.ndim == 1:
            chunk = chunk[None, :]
        self._bin_rows_dense(chunk, row_start)
        # actual pushed-row COUNT (not a high-water mark): chunks may
        # arrive in any order (reference allows thread-partitioned
        # arbitrary start_row), so only the sum of chunk sizes can tell
        # when every row has arrived
        self._pushed_rows = getattr(self, "_pushed_rows", 0) \
            + chunk.shape[0]

    def push_rows_csr(self, indptr, indices, values,
                      row_start: int) -> None:
        """Streaming CSR chunk push (reference LGBM_DatasetPushRowsByCSR,
        c_api.h:122-145): only stored entries are written; implicit
        zeros were prefilled at creation."""
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int32)
        values = np.asarray(values, dtype=np.float64)
        nrows = len(indptr) - 1
        row_of = np.repeat(np.arange(nrows, dtype=np.int64),
                           np.diff(indptr)) + row_start
        order = np.argsort(indices, kind="stable")
        cols_s, rows_s, vals_s = indices[order], row_of[order], values[order]
        bounds = np.searchsorted(cols_s, np.arange(
            self.num_total_features + 1))
        for f in self.features:
            j = f.feature_idx
            lo, hi = bounds[j], bounds[j + 1]
            if lo == hi:
                continue
            m = self.mappers[j]
            col = m.value_to_bin(vals_s[lo:hi])
            rr = rows_s[lo:hi]
            if not f.collapsed_default:
                self._write_group_rows(f.group, rr,
                                       col.astype(np.uint8))
            else:
                gb = col + f.offset
                if m.default_bin == 0:
                    gb -= 1
                keep = col != m.default_bin
                self._write_group_rows(f.group, rr[keep],
                                       gb[keep].astype(np.uint8))
        self._pushed_rows = getattr(self, "_pushed_rows", 0) + nrows

    def _write_group_rows(self, group: int, rows, vals) -> None:
        """Scattered per-group bin write, storage-layout aware (nibble
        read-modify-write when the group is packed)."""
        if self.bin_layout is None:
            self.group_bins[rows, group] = vals
        else:
            self.bin_layout.write_group(self.group_bins, group, vals,
                                        rows=rows)

    def _storage_cols(self) -> int:
        """Byte columns of the storage bin matrix."""
        return (self.bin_layout.cols if self.bin_layout is not None
                else self.num_groups)

    def logical_group_bins(self) -> Optional[np.ndarray]:
        """The logical (N, G) group-bin view — unpacks a nibble-packed
        storage matrix (fresh array), passes the legacy matrix through.
        Parity checks and host-side per-group readers only; the device
        path streams the STORAGE matrix and unpacks in-register."""
        if self.group_bins is None or self.bin_layout is None:
            return self.group_bins
        return self.bin_layout.unpack_rows(np.asarray(self.group_bins))

    def finish_load(self) -> "Dataset":
        """End of streaming pushes (reference FinishLoad)."""
        pushed = getattr(self, "_pushed_rows", self.num_data)
        if pushed < self.num_data:
            Log.warning(f"finish_load: only {pushed} of {self.num_data} "
                        "rows were pushed")
        return self

    # ------------------------------------------------------------------
    def _fit_mappers(self, sample_vals: List[np.ndarray],
                     total_sample_cnt: int, config: Config,
                     cat_set: set) -> List[BinMapper]:
        """The ONE bin-mapper fit path — in-RAM (`from_matrix`) and
        two-round streaming (`from_sampled_columns`) construction both
        route through here, so the threaded fit cannot diverge between
        them.  Per-feature fits fan across ``construct_threads`` host
        threads (numpy sort/searchsorted release the GIL); results are
        byte-identical at every thread count."""
        threads = resolve_construct_threads(config)
        return find_bin_mappers(
            sample_vals, total_sample_cnt, config.max_bin,
            config.min_data_in_bin, config.min_data_in_leaf, cat_set,
            config.use_missing, config.zero_as_missing,
            num_threads=threads)

    # ------------------------------------------------------------------
    def _build_groups(self, reference: Optional["Dataset"],
                      sample_nonzero: Optional[List[np.ndarray]] = None,
                      sample_cnt: int = 0) -> None:
        """Assign features to groups.  With EFB disabled (or until the
        bundler finds conflicts-free bundles) every used feature is its
        own single-feature group with identity bin mapping.
        Multi-feature bundles follow the reference offset scheme
        (feature_group.h:34-51): group bin 0 is the shared default slot,
        each feature occupies [offset, offset+num_bin-1) with its
        default bin collapsed into slot 0."""
        self._build_groups_impl(reference, sample_nonzero, sample_cnt)

    def _build_groups_impl(self, reference: Optional["Dataset"],
                           sample_nonzero: Optional[List[np.ndarray]],
                           sample_cnt: int) -> None:
        if reference is not None:
            self.features = reference.features
            self.group_num_bin = reference.group_num_bin
            self.group_is_multi = reference.group_is_multi
            self._bundles = reference._bundles
            # aligned datasets share the training set's storage layout
            # (group order AND nibble packing) — a packed train matrix
            # with an unpacked validation matrix would split every
            # device code path in two
            self.bin_layout = getattr(reference, "bin_layout", None)
            return
        bundles = _find_bundles(self, sample_nonzero, sample_cnt)
        pack_mode = resolve_bin_packing(self.config)
        if pack_mode != "8bit" and bundles:
            # narrowest-first group order (packing.py layout): groups
            # whose bin count fits a crumb come first (auto/2bit — the
            # three-section layout), then nibble-narrow groups, wide
            # groups follow.  4bit keeps the two-section sort so its
            # matrices stay byte-for-byte what r18 caches hold.  Stable
            # within each section (by first feature index, the legacy
            # order), so the reorder is deterministic; trees are
            # invariant to group numbering — histograms expand to
            # per-FEATURE space before the split finder ever sees them
            if pack_mode in ("auto", "2bit"):
                bundles.sort(key=lambda b: (
                    0 if _bundle_num_bin(self, b) <= CRUMB_MAX_BIN
                    else (1 if _bundle_num_bin(self, b) <= NIBBLE_MAX_BIN
                          else 2),
                    b[0]))
            else:
                bundles.sort(key=lambda b: (
                    0 if _bundle_num_bin(self, b) <= NIBBLE_MAX_BIN
                    else 1,
                    b[0]))
        self._bundles = bundles
        self.features = [None] * 0
        feats: List[FeatureView] = []
        self.group_num_bin = []
        self.group_is_multi = []
        for gidx, bundle in enumerate(bundles):
            if len(bundle) == 1:
                fidx = bundle[0]
                m = self.mappers[fidx]
                feats.append(FeatureView(fidx, gidx, 0, 0, m,
                                         collapsed_default=False))
                self.group_num_bin.append(m.num_bin)
                self.group_is_multi.append(False)
            else:
                total = 1  # bin 0 = shared default slot
                for sub, fidx in enumerate(bundle):
                    m = self.mappers[fidx]
                    offset = total
                    nb = m.num_bin
                    if m.default_bin == 0:
                        nb -= 1
                    feats.append(FeatureView(fidx, gidx, sub, offset, m,
                                             collapsed_default=True))
                    total += nb
                self.group_num_bin.append(total)
                self.group_is_multi.append(True)
        # order features by real index for stable downstream numbering
        feats.sort(key=lambda f: f.feature_idx)
        self.features = feats
        self.bin_layout = build_layout(
            pack_mode, self.group_num_bin,
            group_features=bundles,
            feature_names=self.feature_names)

    # ------------------------------------------------------------------
    def _bin_data(self, data: np.ndarray) -> None:
        self.group_bins = np.zeros(
            (self.num_data, self._storage_cols()), dtype=np.uint8)
        self._bin_rows_dense(data, 0)

    def _bin_rows_dense(self, data: np.ndarray, row_start: int) -> None:
        """Bin a dense float chunk into group_bins[row_start:...] —
        shared by whole-matrix construction and the PushRows streaming
        path (reference Dataset::PushOneRow via FeatureGroup::PushData,
        feature_group.h:128-136).  Native fast paths now cover ALL
        three feature classes — numerical (``ltpu_bin_dense[_mt]``),
        categorical lookup (``ltpu_bin_cat``) and EFB bundle
        offset/default-collapse writes (``ltpu_bin_bundle``) — with the
        per-feature Python mapper as the fallback for any feature the
        library can't take.

        Nibble-packed datasets bin through a bounded LOGICAL scratch
        chunk and pack it straight into the storage matrix
        (``ltpu_pack_nibbles`` / the numpy fallback): the full-width
        8-bit matrix never exists — peak extra memory is one scratch
        chunk, regardless of N."""
        out = self.group_bins[row_start:row_start + data.shape[0]]
        if self.bin_layout is None:
            self._bin_rows_dense_into(data, out)
            return
        lay = self.bin_layout
        lib = self._native_lib()
        step = max(1, int(getattr(self.config, "streaming_chunk_rows",
                                  65536) or 65536))
        for i in range(0, data.shape[0], step):
            chunk = np.asarray(data[i:i + step])
            scratch = np.zeros((chunk.shape[0], self.num_groups),
                               dtype=np.uint8)
            self._bin_rows_dense_into(chunk, scratch)
            lay.pack_rows(scratch, out=out[i:i + chunk.shape[0]], lib=lib)

    def _bin_rows_dense_into(self, data: np.ndarray, out) -> None:
        native_feats = [f for f in self.features
                        if not f.is_categorical and not f.collapsed_default]
        rest = [f for f in self.features if f not in native_feats]
        lib = self._native_lib()
        xc = None
        if lib is not None and data.shape[0]:
            xc = np.ascontiguousarray(data, dtype=np.float64)
        if native_feats and xc is not None \
                and self._try_native_bin_dense(xc, out, native_feats, lib):
            pass
        else:
            rest = self.features
        for f in rest:
            if xc is not None \
                    and self._try_native_bin_rest(xc, out, f, lib):
                continue
            col = self.mappers[f.feature_idx].value_to_bin(
                data[:, f.feature_idx])
            if not f.collapsed_default:
                out[:, f.group] = col.astype(np.uint8)
            else:
                # bundle write: non-default values land at offset (+ the
                # default-at-0 slot removal), defaults stay at group bin 0.
                # (reference feature_group.h:128-136)
                gb = col + f.offset
                if f.mapper.default_bin == 0:
                    gb -= 1
                is_default = col == f.mapper.default_bin
                keep = ~is_default
                out[keep, f.group] = gb[keep].astype(np.uint8)

    # ------------------------------------------------------------------
    def _native_lib(self):
        """libltpu handle, or None when ``native_binning=false`` or the
        library is unavailable (build failure, missing g++ — the Python
        mapper path then serves every feature, byte for byte alike)."""
        cfg = self.config
        if cfg is not None and not getattr(cfg, "native_binning", True):
            return None
        from .native import get_lib
        return get_lib()

    def _try_native_bin_dense(self, xc: np.ndarray, out, feats,
                              lib) -> bool:
        """Numerical value->bin through the native library: the
        compare-count loop of native/src/bin_dense.cpp takes the same
        float64 'left'-side search as the mappers' ``value_to_bin``
        (reference ValueToBin, bin.h:450-486), so the bytes are the
        same, and ``ltpu_bin_dense_mt`` fans the row blocks over
        ``construct_threads`` host threads.  ``feats`` is the
        numerical non-bundled subset of features this call handles.
        Disable with ``native_binning=false``."""
        import ctypes
        if self.group_bins is None or xc.shape[0] == 0:
            return False
        n, f_total = xc.shape
        nfu = len(feats)
        bounds_parts = []
        off = [0]
        use_nan = np.zeros(nfu, np.uint8)
        nan_bin = np.zeros(nfu, np.int64)
        fidx = np.zeros(nfu, np.int64)
        for j, f in enumerate(feats):
            m = self.mappers[f.feature_idx]
            n_search = m.num_bin - (1 if m.missing_type == MISSING_NAN
                                    else 0)
            bounds_parts.append(np.asarray(
                m.bin_upper_bound[:n_search - 1], np.float64))
            off.append(off[-1] + len(bounds_parts[-1]))
            use_nan[j] = 1 if m.missing_type == MISSING_NAN else 0
            nan_bin[j] = m.num_bin - 1
            fidx[j] = f.feature_idx
        bounds_flat = (np.concatenate(bounds_parts) if off[-1]
                       else np.zeros(1, np.float64))
        boff = np.asarray(off, np.int64)
        res = np.empty((nfu, n), np.uint8)

        def p(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        # threaded over disjoint row ranges — byte-identical to the
        # serial walk at every thread count (no accumulation)
        lib.ltpu_bin_dense_mt(
            p(xc, ctypes.c_double), n, f_total, p(fidx, ctypes.c_long), nfu,
            p(bounds_flat, ctypes.c_double), p(boff, ctypes.c_long),
            p(use_nan, ctypes.c_ubyte), p(nan_bin, ctypes.c_long),
            p(res, ctypes.c_ubyte), resolve_construct_threads(self.config))
        cols = np.asarray([f.group for f in feats], np.int64)
        if out.flags.c_contiguous and out.dtype == np.uint8 \
                and out.shape[0] == n:
            # out.shape[0] == n guards the raw-pointer write: a clamped
            # group_bins slice (out-of-range push_rows row_start) must
            # fall through to the numpy path, which raises a broadcast
            # error instead of writing past the buffer
            # blocked-transpose write: numpy's strided per-column
            # assignment dominated wide-matrix prep (see bin_dense.cpp)
            lib.ltpu_scatter_cols(p(res, ctypes.c_ubyte), nfu, n,
                                  p(cols, ctypes.c_long),
                                  p(out, ctypes.c_ubyte), out.shape[1])
        else:
            for j, f in enumerate(feats):
                out[:, f.group] = res[j]
        return True

    def _try_native_bin_rest(self, xc: np.ndarray, out, f, lib) -> bool:
        """Native value->bin for the features ``ltpu_bin_dense`` does
        not cover: categorical lookup (``ltpu_bin_cat``) and EFB bundle
        offset/default-collapse writes (``ltpu_bin_bundle``).  Returns
        False (leaving the Python fallback to run) when the output slice
        can't take a raw strided write or a categorical mapper has no
        categories."""
        import ctypes
        n = xc.shape[0]
        if n == 0:
            return True
        if not (out.flags.c_contiguous and out.dtype == np.uint8
                and out.shape[0] == n):
            # same clamped-slice guard as the scatter path above
            return False
        m = self.mappers[f.feature_idx]
        stride = out.shape[1]
        out_col = ctypes.cast(out.ctypes.data + f.group,
                              ctypes.POINTER(ctypes.c_ubyte))

        def p(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        if f.is_categorical:
            fn_cat = lib.ltpu_bin_cat
            if not m.categorical_2_bin:
                return False
            if getattr(m, "_cat_lut", None) is None:
                m._build_cat_cache()
            lut = np.ascontiguousarray(m._cat_lut, dtype=np.int32)
            if not f.collapsed_default:
                fn_cat(p(xc, ctypes.c_double), n, xc.shape[1],
                       f.feature_idx, p(lut, ctypes.c_int32), len(lut),
                       m.num_bin - 1, out_col, stride)
                return True
            tmp = np.empty(n, np.uint8)
            fn_cat(p(xc, ctypes.c_double), n, xc.shape[1],
                   f.feature_idx, p(lut, ctypes.c_int32), len(lut),
                   m.num_bin - 1, p(tmp, ctypes.c_ubyte), 1)
            lib.ltpu_bin_bundle(p(tmp, ctypes.c_ubyte), n, f.offset,
                                m.default_bin, out_col, stride)
            return True
        # numerical feature inside a multi-feature bundle: bin through
        # the shared dense kernel into a scratch row, then apply the
        # bundle write
        n_search = m.num_bin - (1 if m.missing_type == MISSING_NAN else 0)
        bounds = np.ascontiguousarray(
            m.bin_upper_bound[:n_search - 1], np.float64)
        if not len(bounds):
            bounds = np.zeros(1, np.float64)
            boff = np.asarray([0, 0], np.int64)
        else:
            boff = np.asarray([0, len(bounds)], np.int64)
        use_nan = np.asarray(
            [1 if m.missing_type == MISSING_NAN else 0], np.uint8)
        nan_bin = np.asarray([m.num_bin - 1], np.int64)
        fidx = np.asarray([f.feature_idx], np.int64)
        tmp = np.empty(n, np.uint8)
        lib.ltpu_bin_dense(p(xc, ctypes.c_double), n, xc.shape[1],
                           p(fidx, ctypes.c_long), 1,
                           p(bounds, ctypes.c_double), p(boff, ctypes.c_long),
                           p(use_nan, ctypes.c_ubyte),
                           p(nan_bin, ctypes.c_long), p(tmp, ctypes.c_ubyte))
        lib.ltpu_bin_bundle(p(tmp, ctypes.c_ubyte), n, f.offset,
                            m.default_bin, out_col, stride)
        return True

    # ------------------------------------------------------------------
    def _bin_data_sparse(self, csc) -> None:
        """Bin a CSC matrix column-by-column into the packed (N, G)
        uint8 matrix: implicit zeros land in each feature's zero bin
        (== its default bin, the GreedyFindBin contract) without ever
        materializing a dense float column (reference sparse path:
        src/io/sparse_bin.hpp Push / feature_group.h:128-136).  The
        per-column loop fans over ``construct_threads`` host threads,
        one task per GROUP (bundled features share a group column, so
        group granularity keeps every output column single-writer);
        numpy's searchsorted releases the GIL, and the result is
        byte-identical at every thread count."""
        N = self.num_data
        lay = self.bin_layout
        out = np.zeros((N, self._storage_cols()), dtype=np.uint8)
        indptr, indices, values = csc.indptr, csc.indices, csc.data

        def bin_feature(f) -> None:
            m = self.mappers[f.feature_idx]
            j = f.feature_idx
            rows = indices[indptr[j]:indptr[j + 1]]
            vals = values[indptr[j]:indptr[j + 1]]
            col = m.value_to_bin(vals.astype(np.float64))
            zero_bin = int(np.asarray(
                m.value_to_bin(np.zeros(1)))[0])
            if not f.collapsed_default:
                if zero_bin != 0:
                    if lay is not None:
                        lay.fill_group(out, f.group, zero_bin)
                    else:
                        out[:, f.group] = zero_bin
                cb = col.astype(np.uint8)
                if lay is not None:
                    lay.write_group(out, f.group, cb, rows=rows)
                else:
                    out[rows, f.group] = cb
            else:
                gb = col + f.offset
                if m.default_bin == 0:
                    gb -= 1
                keep = col != m.default_bin
                gbk = gb[keep].astype(np.uint8)
                if lay is not None:
                    lay.write_group(out, f.group, gbk, rows=rows[keep])
                else:
                    out[rows[keep], f.group] = gbk

        # task key = STORAGE byte column, not logical group: two
        # nibble-packed groups share a byte, and the read-modify-write
        # nibble updates need every byte single-writer under threading
        by_group: Dict[int, list] = {}
        for f in self.features:
            key = lay.byte_of(f.group) if lay is not None else f.group
            by_group.setdefault(key, []).append(f)

        def bin_group(feats) -> None:
            for f in feats:
                bin_feature(f)

        threads = resolve_construct_threads(self.config)
        if threads > 1 and len(by_group) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    max_workers=min(threads, len(by_group))) as ex:
                # consume the iterator so a worker exception
                # propagates instead of vanishing
                list(ex.map(bin_group, by_group.values()))
        else:
            for feats in by_group.values():
                bin_group(feats)
        self.group_bins = out

    # ------------------------------------------------------------------
    def _resolve_monotone(self, config: Config) -> None:
        mc = config.monotone_constraints
        if mc:
            arr = np.zeros(len(self.features), dtype=np.int8)
            for j, f in enumerate(self.features):
                if f.feature_idx < len(mc):
                    arr[j] = mc[f.feature_idx]
            self.monotone_constraints = arr
        else:
            self.monotone_constraints = None

    # ------------------------------------------------------------------
    def feature_bin_maps(self) -> Tuple[np.ndarray, np.ndarray]:
        """Device gather map from group histograms to per-feature
        histograms.

        Returns ``(bin_map, needs_fix)`` where ``bin_map[f, b]`` is the
        flattened (group, group_bin) index holding feature ``f``'s bin
        ``b`` (or -1 when the bin's count must be reconstructed from leaf
        totals — the FixHistogram path, dataset.cpp:776-795), and
        ``needs_fix[f]`` is that reconstructed bin's index (or -1)."""
        F = self.num_features
        B = self.max_feature_bin
        bin_map = np.full((F, B), -1, dtype=np.int32)
        fix_bin = np.full(F, -1, dtype=np.int32)
        for j, f in enumerate(self.features):
            for b in range(f.num_bin):
                if not f.collapsed_default:
                    bin_map[j, b] = f.group * self.max_group_bin + b
                else:
                    if b == f.mapper.default_bin:
                        fix_bin[j] = b
                        continue
                    gb = b + f.offset - (1 if f.mapper.default_bin == 0 else 0)
                    bin_map[j, b] = f.group * self.max_group_bin + gb
        return bin_map, fix_bin

    @property
    def max_group_bin(self) -> int:
        return max(self.group_num_bin) if self.group_num_bin else 1

    @property
    def max_feature_bin(self) -> int:
        return max((f.num_bin for f in self.features), default=1)

    # ------------------------------------------------------------------
    def feature_meta_arrays(self) -> Dict[str, np.ndarray]:
        """Per-used-feature metadata arrays shipped to the device split
        finder."""
        F = self.num_features
        num_bin = np.array([f.num_bin for f in self.features], dtype=np.int32)
        default_bin = np.array([f.default_bin for f in self.features],
                               dtype=np.int32)
        missing_type = np.array([f.missing_type for f in self.features],
                                dtype=np.int32)
        is_cat = np.array([f.is_categorical for f in self.features],
                          dtype=bool)
        mono = (self.monotone_constraints if self.monotone_constraints
                is not None else np.zeros(F, dtype=np.int8))
        return dict(num_bin=num_bin, default_bin=default_bin,
                    missing_type=missing_type, is_categorical=is_cat,
                    monotone=mono.astype(np.int32))

    # ------------------------------------------------------------------
    def real_feature_index(self, inner_idx: int) -> int:
        return self.features[inner_idx].feature_idx

    def inner_feature_index(self, real_idx: int) -> int:
        for j, f in enumerate(self.features):
            if f.feature_idx == real_idx:
                return j
        return -1

    def feature_infos(self) -> List[str]:
        return [m.feature_info_str() for m in self.mappers]


# ---------------------------------------------------------------------------
def _bundle_num_bin(ds: "Dataset", bundle: List[int]) -> int:
    """A bundle's group bin count — the same arithmetic the
    `_build_groups_impl` packing loop applies (shared default slot +
    per-feature widths minus the default-at-0 removals)."""
    if len(bundle) == 1:
        return ds.mappers[bundle[0]].num_bin
    total = 1
    for fidx in bundle:
        m = ds.mappers[fidx]
        total += m.num_bin - (1 if m.default_bin == 0 else 0)
    return total


def _sample_feature_values(data: np.ndarray, sample_cnt: int, seed: int
                           ) -> Tuple[List[np.ndarray], int,
                                      List[np.ndarray]]:
    """Row-sample then collect per-feature non-zero (and NaN) values for
    bin finding (reference dataset_loader.cpp:649-754 sampling +
    bin.cpp:207 contract: zeros are implicit).  Also returns per-feature
    non-zero row indices within the sample, feeding the EFB bundler."""
    num_data = data.shape[0]
    if num_data > sample_cnt:
        rng = np.random.RandomState(seed)
        idx = rng.choice(num_data, size=sample_cnt, replace=False)
        idx.sort()
        sample = data[idx]
    else:
        sample = data
    out, rows = split_sample_columns(sample)
    return out, sample.shape[0], rows


def split_sample_columns(sample: np.ndarray):
    """Per-column non-zero/NaN values + their row indices — the shared
    sampling contract (zeros implicit; reference bin.cpp:207)."""
    vals, rows = [], []
    for j in range(sample.shape[1]):
        col = sample[:, j]
        keep = np.isnan(col) | (np.abs(col) > 1e-35)
        vals.append(col[keep])
        rows.append(np.nonzero(keep)[0].astype(np.int64))
    return vals, rows


def _sample_feature_values_sparse(csc, sample_cnt: int, seed: int
                                  ) -> Tuple[List[np.ndarray], int,
                                             List[np.ndarray]]:
    """Sparse analog of :func:`_sample_feature_values`: row-sample the
    CSC matrix (via a CSR slice) and collect each column's stored
    values/rows — zeros stay implicit, exactly the reference sampling
    contract (dataset_loader.cpp:649-754 + bin.cpp:207)."""
    num_data = csc.shape[0]
    if num_data > sample_cnt:
        rng = np.random.RandomState(seed)
        idx = rng.choice(num_data, size=sample_cnt, replace=False)
        idx.sort()
        sample = csc.tocsr()[idx].tocsc()
        sample.sort_indices()
    else:
        sample = csc
    total = sample.shape[0]
    indptr, indices, values = sample.indptr, sample.indices, sample.data
    out = []
    rows = []
    for j in range(sample.shape[1]):
        v = values[indptr[j]:indptr[j + 1]].astype(np.float64)
        r = indices[indptr[j]:indptr[j + 1]]
        keep = np.isnan(v) | (np.abs(v) > 1e-35)
        out.append(v[keep])
        rows.append(r[keep].astype(np.int64))
    return out, total, rows


def _find_bundles(ds: Dataset, sample_nonzero: Optional[List[np.ndarray]]
                  = None, sample_cnt: int = 0) -> List[List[int]]:
    """Exclusive feature bundling (reference dataset.cpp:66-210
    FindGroups/FastFeatureBundling): greedily pack mutually-exclusive
    sparse features into shared bin columns, tolerating
    ``max_conflict_rate`` collisions, with the 256-bins-per-group cap
    the GPU learner imposes (dataset.cpp:76,90-91) — which is exactly
    the uint8 packed-column constraint here.

    ``sample_nonzero``: per-feature sorted row indices (within the
    sample) where the feature is non-default.  When absent (e.g.
    reloaded binary cache) falls back to single-feature groups.
    """
    cfg = ds.config
    if (sample_nonzero is None or cfg is None or not cfg.enable_bundle
            or not cfg.is_enable_bundle):
        return [[fidx] for fidx in ds.used_features]

    # NOTE on packing: bundling is IDENTICAL across every bin_packing
    # mode.  Capping bundles at a nibble's 16 bins was tried and
    # rejected — a different bundling reconstructs default-bin mass
    # through a different FixHistogram subtraction order, which breaks
    # the byte-identical-trees bar by f32 ulps.  Wide bundles instead
    # split OUT of the packed section into byte-wide storage columns
    # (packing.py two-section layout), preserving exact parity.
    max_group_bins = 256
    max_conflict = int(cfg.max_conflict_rate * max(sample_cnt, 1))
    # order by non-zero count descending (densest placed first,
    # mirroring the reference's sorted-by-count greedy pass)
    order = sorted(ds.used_features,
                   key=lambda f: -len(sample_nonzero[f]))
    bundles: List[List[int]] = []
    bundle_rows: List[np.ndarray] = []
    bundle_bins: List[int] = []
    bundle_conflicts: List[int] = []
    for fidx in order:
        m = ds.mappers[fidx]
        nb = m.num_bin - (1 if m.default_bin == 0 else 0)
        rows = sample_nonzero[fidx]
        placed = False
        # a feature covering most rows can't bundle with anything
        if len(rows) * 2 < sample_cnt:
            for bi in range(len(bundles)):
                if bundle_bins[bi] + nb > max_group_bins:
                    continue
                conflicts = np.intersect1d(bundle_rows[bi], rows,
                                           assume_unique=True).size
                if bundle_conflicts[bi] + conflicts <= max_conflict:
                    bundles[bi].append(fidx)
                    bundle_rows[bi] = np.union1d(bundle_rows[bi], rows)
                    bundle_bins[bi] += nb
                    bundle_conflicts[bi] += conflicts
                    placed = True
                    break
        if not placed:
            bundles.append([fidx])
            bundle_rows.append(rows)
            bundle_bins.append(nb + 1)  # + shared default slot
            bundle_conflicts.append(0)
    # stable order: by first (lowest) feature index
    for b in bundles:
        b.sort()
    bundles.sort(key=lambda b: b[0])
    return bundles
