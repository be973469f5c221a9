"""Host-side binning pipeline: value -> bin discretization.

TPU-native re-design of the reference's BinMapper
(reference: include/LightGBM/bin.h:59-207, src/io/bin.cpp:73-390).
Semantics are preserved — GreedyFindBin's count-balanced boundary
placement, the zero-as-one-bin split, the MissingType {None, Zero, NaN}
state machine, categorical most-frequent-first mapping with the 99%%
coverage cut — but the runtime mapping path is vectorized
(``np.searchsorted`` over all rows at once) instead of a per-value
binary search, because the output feeds a packed ``(N, F)`` uint8
device matrix rather than per-feature Bin objects.
"""
from __future__ import annotations

import math
import os
from bisect import bisect_left
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .utils.log import Log

K_ZERO_THRESHOLD = 1e-35  # reference: meta.h:40
_INF = float("inf")

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1

MISSING_TYPE_NAMES = {MISSING_NONE: "none", MISSING_ZERO: "zero",
                      MISSING_NAN: "nan"}


def _next_after_up(a: float) -> float:
    """Smallest double strictly greater than a (reference common.h:842)."""
    return math.nextafter(a, _INF)


def _double_equal_ordered(a: float, b: float) -> bool:
    """b <= nextafter(a, inf) — reference common.h:837."""
    return b <= _next_after_up(a)


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Count-balanced bin boundary search (reference bin.cpp:73-150).

    Returns ascending bin upper bounds ending with +inf.  Few distinct
    values get one bin each (respecting min_data_in_bin); many distinct
    values get boundaries targeting ~total/max_bin samples per bin, with
    'big' values (count >= mean bin size) pinned to their own bins.
    """
    num_distinct = len(distinct_values)
    assert max_bin > 0
    bounds: List[float] = []
    if num_distinct <= max_bin:
        cur = 0
        for i in range(num_distinct - 1):
            cur += int(counts[i])
            if cur >= min_data_in_bin:
                val = _next_after_up(
                    (float(distinct_values[i]) + float(distinct_values[i + 1])) / 2.0)
                if not bounds or not _double_equal_ordered(bounds[-1], val):
                    bounds.append(val)
                    cur = 0
        bounds.append(_INF)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = total_cnt - int(counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    # The reference walks every distinct value accumulating counts until
    # a boundary triggers (bin.cpp:104-136).  Equivalent but O(bins):
    # jump straight to each boundary with searchsorted — a boundary at j
    # is the first index where (a) j is big, (b) accumulated >= mean, or
    # (c) j+1 is big and accumulated >= mean/2.
    cum = np.cumsum(counts)                                # (D,)
    rest_cum = np.cumsum(np.where(is_big, 0, counts))      # (D,)
    big_pos = np.flatnonzero(is_big)                       # ascending
    uppers: List[float] = []
    lowers: List[float] = [float(distinct_values[0])]
    i = 0
    last = num_distinct - 1                                # exclusive walk end
    while i < last and len(uppers) < max_bin - 1:
        base = cum[i - 1] if i > 0 else 0
        # bisect_left == np.searchsorted(..., side="left") exactly (both
        # return the first index whose element >= the needle, comparing
        # the int64 counts against the float target as float64) but
        # skips numpy's ~40 us per-call dispatch — this walk issues
        # O(features x bins) probes and dominated mapper fitting
        # (a) next big value at/after i
        bi = bisect_left(big_pos, i)
        j1 = int(big_pos[bi]) if bi < len(big_pos) else num_distinct
        # (b) first j with cum[j] - base >= mean_bin_size
        j2 = bisect_left(cum, base + mean_bin_size)
        # (c) first big-successor position p-1 >= the half-mean point
        half_at = bisect_left(cum, base + max(1.0, mean_bin_size * 0.5))
        bj = bisect_left(big_pos, max(i, half_at) + 1)
        j3 = int(big_pos[bj]) - 1 if bj < len(big_pos) else num_distinct
        # clamp to the walk position: when mean_bin_size hits 0 (all
        # non-big samples exhausted) the scalar loop makes every
        # remaining value its own bin, i.e. the boundary is at i itself
        j = max(i, min(j1, j2, j3))
        if j >= last:
            break
        uppers.append(float(distinct_values[j]))
        lowers.append(float(distinct_values[j + 1]))
        if not is_big[j]:
            rest_bin_cnt -= 1
            mean_bin_size = (rest_sample_cnt - rest_cum[j]) \
                / max(rest_bin_cnt, 1)
        i = j + 1
    for i in range(len(uppers)):
        val = _next_after_up((uppers[i] + lowers[i + 1]) / 2.0)
        if not bounds or not _double_equal_ordered(bounds[-1], val):
            bounds.append(val)
    bounds.append(_INF)
    return bounds


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray,
                                  counts: np.ndarray, max_bin: int,
                                  total_sample_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """Split the value line into (-inf, -eps], (-eps, eps], (eps, inf) and
    bin the negative/positive sides separately so that zero always owns
    exactly one bin (reference bin.cpp:151-206)."""
    dv = np.asarray(distinct_values, dtype=np.float64)
    cnt = np.asarray(counts, dtype=np.int64)
    left_mask = dv <= -K_ZERO_THRESHOLD
    right_mask = dv > K_ZERO_THRESHOLD
    zero_mask = ~left_mask & ~right_mask
    left_cnt_data = int(cnt[left_mask].sum())
    cnt_zero = int(cnt[zero_mask].sum())
    right_cnt_data = int(cnt[right_mask].sum())

    nonleft = np.nonzero(~left_mask)[0]
    left_cnt = int(nonleft[0]) if len(nonleft) else len(dv)

    bounds: List[float] = []
    if left_cnt > 0:
        denom = max(total_sample_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bounds = greedy_find_bin(dv[:left_cnt], cnt[:left_cnt], left_max_bin,
                                 left_cnt_data, min_data_in_bin)
        bounds[-1] = -K_ZERO_THRESHOLD

    right_idx = np.nonzero(right_mask)[0]
    right_start = int(right_idx[0]) if len(right_idx) else -1
    if right_start >= 0:
        right_max_bin = max_bin - 1 - len(bounds)
        assert right_max_bin > 0
        right_bounds = greedy_find_bin(dv[right_start:], cnt[right_start:],
                                       right_max_bin, right_cnt_data,
                                       min_data_in_bin)
        bounds.append(K_ZERO_THRESHOLD)
        bounds.extend(right_bounds)
    else:
        bounds.append(_INF)
    return bounds


def _need_filter(cnt_in_bin: Sequence[int], total_cnt: int, filter_cnt: int,
                 bin_type: int) -> bool:
    """True if no split of this feature can put >= filter_cnt samples on
    both sides (reference bin.cpp:49-71)."""
    if bin_type == BIN_NUMERICAL:
        left = 0
        for c in cnt_in_bin[:-1]:
            left += c
            if left >= filter_cnt and total_cnt - left >= filter_cnt:
                return False
        return True
    if len(cnt_in_bin) <= 2:
        for c in cnt_in_bin[:-1]:
            if c >= filter_cnt and total_cnt - c >= filter_cnt:
                return False
        return True
    return False


class BinMapper:
    """Per-feature value->bin mapping (reference bin.h:59-207).

    Attributes mirror the reference's serialized state: ``num_bin``,
    ``missing_type``, ``is_trivial``, ``sparse_rate``, ``bin_type``,
    ``bin_upper_bound`` (numerical) or ``bin_2_categorical`` /
    ``categorical_2_bin`` (categorical), ``min_val``/``max_val``,
    ``default_bin``.
    """

    __slots__ = ("num_bin", "missing_type", "is_trivial", "sparse_rate",
                 "bin_type", "bin_upper_bound", "bin_2_categorical",
                 "categorical_2_bin", "min_val", "max_val", "default_bin",
                 "_cat_lut")

    def __init__(self):
        self.num_bin = 1
        self.missing_type = MISSING_NONE
        self.is_trivial = True
        self.sparse_rate = 0.0
        self.bin_type = BIN_NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([_INF])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: dict = {}
        self.min_val = 0.0
        self.max_val = 0.0
        self.default_bin = 0
        # category -> bin lookup table, materialized once at fit time
        # (and rebuilt on binary-cache load): per-chunk streaming
        # binning used to re-np.fromiter the dict on EVERY call
        self._cat_lut: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int, min_split_data: int,
                 bin_type: int = BIN_NUMERICAL, use_missing: bool = True,
                 zero_as_missing: bool = False) -> None:
        """Fit the mapping from sampled non-zero values
        (reference bin.cpp:207-390).  ``total_sample_cnt`` includes the
        implicit zeros not present in ``values``."""
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        na_cnt = int(nan_mask.sum())
        values = values[~nan_mask]
        if not use_missing:
            self.missing_type = MISSING_NONE
            na_cnt = 0
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NONE if na_cnt == 0 else MISSING_NAN
        if self.missing_type != MISSING_NAN:
            na_cnt = 0

        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)

        distinct, counts = self._distinct_with_zero(values, zero_cnt)
        self.min_val = float(distinct[0])
        self.max_val = float(distinct[-1])
        num_distinct = len(distinct)

        if bin_type == BIN_NUMERICAL:
            if self.missing_type == MISSING_NAN:
                bounds = find_bin_with_zero_as_one_bin(
                    distinct, counts, max_bin - 1, total_sample_cnt - na_cnt,
                    min_data_in_bin)
                bounds.append(float("nan"))
            else:
                bounds = find_bin_with_zero_as_one_bin(
                    distinct, counts, max_bin, total_sample_cnt,
                    min_data_in_bin)
                if self.missing_type == MISSING_ZERO and len(bounds) == 2:
                    self.missing_type = MISSING_NONE
            self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
            self.num_bin = len(bounds)
            assert self.num_bin <= max_bin
            cnt_in_bin = np.zeros(self.num_bin, dtype=np.int64)
            search_bounds = self.bin_upper_bound[:self.num_bin - 1] \
                if self.missing_type == MISSING_NAN else self.bin_upper_bound
            idx = np.searchsorted(search_bounds[:-1] if len(search_bounds) else [],
                                  distinct, side="left")
            # idx = first bin whose upper bound >= value
            np.add.at(cnt_in_bin, idx, counts)
            if self.missing_type == MISSING_NAN:
                cnt_in_bin[self.num_bin - 1] = na_cnt
        else:
            cnt_in_bin = self._fit_categorical(distinct, counts, max_bin,
                                               min_data_in_bin,
                                               total_sample_cnt, na_cnt)

        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and _need_filter(
                cnt_in_bin.tolist(), total_sample_cnt, min_split_data,
                bin_type):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(np.zeros(1))[0])
            if bin_type == BIN_CATEGORICAL:
                assert self.default_bin > 0
        self.sparse_rate = float(cnt_in_bin[self.default_bin]) / max(
            total_sample_cnt, 1)

    # ------------------------------------------------------------------
    @staticmethod
    def _distinct_with_zero(values: np.ndarray,
                            zero_cnt: int) -> Tuple[np.ndarray, np.ndarray]:
        """Distinct sorted values with the implicit zero spliced in at its
        ordered position carrying ``zero_cnt`` (reference bin.cpp:234-269).
        Near-equal doubles (within one ulp) are merged keeping the larger.
        Vectorized: runs of near-equal values become groups (a group's
        value is its max = last element); the zero splice lands at the
        adjacent negative->positive group boundary."""
        values = np.sort(np.asarray(values, dtype=np.float64))
        n = len(values)
        if n == 0:
            return (np.asarray([0.0]),
                    np.asarray([zero_cnt], dtype=np.int64))
        new_grp = np.empty(n, dtype=bool)
        new_grp[0] = True
        # chain rule matches the scalar loop: compare each value to its
        # RAW predecessor (merged groups keep the larger value)
        new_grp[1:] = values[1:] > np.nextafter(values[:-1], _INF)
        starts = np.flatnonzero(new_grp)
        ends = np.append(starts[1:], n) - 1
        distinct = values[ends]
        counts = np.diff(np.append(starts, n)).astype(np.int64)
        if values[0] > 0.0 and zero_cnt > 0:
            distinct = np.concatenate([[0.0], distinct])
            counts = np.concatenate([[zero_cnt], counts])
        elif values[-1] < 0.0 and zero_cnt > 0:
            distinct = np.concatenate([distinct, [0.0]])
            counts = np.concatenate([counts, [zero_cnt]])
        else:
            # splice between the last negative and first positive group
            # (suppressed when an exact-zero group sits between them,
            # matching the scalar loop's strict sign checks)
            k = int(np.searchsorted(distinct, 0.0, side="left"))
            if 0 < k < len(distinct) and distinct[k - 1] < 0.0 \
                    and distinct[k] > 0.0:
                distinct = np.insert(distinct, k, 0.0)
                counts = np.insert(counts, k, zero_cnt)
        return distinct, counts.astype(np.int64)

    # ------------------------------------------------------------------
    def _fit_categorical(self, distinct: np.ndarray, counts: np.ndarray,
                         max_bin: int, min_data_in_bin: int,
                         total_sample_cnt: int, na_cnt: int) -> np.ndarray:
        """Most-frequent-first category->bin mapping with 99%% coverage cut
        (reference bin.cpp:303-368), at most 256 bins (the JAX package,
        which stores a byte a bin too, wraps bins past 255 around)."""
        int_vals: List[int] = []
        int_cnts: List[int] = []
        for v, c in zip(distinct, counts):
            iv = int(v)
            if iv < 0:
                na_cnt += int(c)
                Log.warning("Met negative value in categorical features, "
                            "will convert it to NaN")
            elif int_vals and iv == int_vals[-1]:
                int_cnts[-1] += int(c)
            else:
                int_vals.append(iv)
                int_cnts.append(int(c))
        # sort by count descending (stable)
        order = sorted(range(len(int_vals)), key=lambda i: -int_cnts[i])
        int_vals = [int_vals[i] for i in order]
        int_cnts = [int_cnts[i] for i in order]
        # bin 0 must not map category 0 (bin 0 is the group's shared
        # default slot downstream)
        if int_vals and int_vals[0] == 0:
            if len(int_vals) == 1:
                int_vals.append(int_vals[0] + 1)
                int_cnts.append(0)
            int_vals[0], int_vals[1] = int_vals[1], int_vals[0]
            int_cnts[0], int_cnts[1] = int_cnts[1], int_cnts[0]

        cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
        self.categorical_2_bin = {}
        self.bin_2_categorical = []
        self.num_bin = 0
        used_cnt = 0
        max_bin = min(len(int_vals), max_bin)
        # the 99% cut may take more than max_bin categories, but the bin
        # matrix stores a byte a value: past 256 bins (255 with a NaN
        # bin to come) the rarest categories share the last bin, as the
        # cut ones do, where a wider bin would wrap around
        byte_cap = 256 - (1 if na_cnt > 0 else 0)
        cnt_in_bin: List[int] = []
        cur = 0
        while cur < len(int_vals) and (used_cnt < cut_cnt
                                       or self.num_bin < max_bin):
            if int_cnts[cur] < min_data_in_bin and cur > 1:
                break
            if self.num_bin >= byte_cap:
                Log.warning(f"categorical feature: {len(int_vals) - cur} "
                            f"rare categories share the last of {byte_cap} "
                            "bins (one byte a bin)")
                break
            self.bin_2_categorical.append(int_vals[cur])
            self.categorical_2_bin[int_vals[cur]] = self.num_bin
            used_cnt += int_cnts[cur]
            cnt_in_bin.append(int_cnts[cur])
            self.num_bin += 1
            cur += 1
        if cur == len(int_vals) and na_cnt > 0:
            self.bin_2_categorical.append(-1)
            self.categorical_2_bin[-1] = self.num_bin
            cnt_in_bin.append(0)
            self.num_bin += 1
        if cur == len(int_vals) and na_cnt == 0:
            self.missing_type = MISSING_NONE
        elif na_cnt == 0:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN
        cnt_in_bin[-1] += int(total_sample_cnt - used_cnt)
        self._build_cat_cache()
        return np.asarray(cnt_in_bin, dtype=np.int64)

    # ------------------------------------------------------------------
    def _build_cat_cache(self) -> None:
        """Materialize the category->bin dense lookup table.

        ``lut[k]`` holds category ``k``'s bin for 0 <= k <= max_key and
        the unseen bin (``num_bin - 1``) everywhere else; one trailing
        slot keeps the ``iv <= max_key`` range test a plain length
        compare.  Built at fit time and on binary-cache load (mappers
        pickled by an older version lack the slot and rebuild lazily in
        :meth:`value_to_bin`)."""
        if not self.categorical_2_bin:
            self._cat_lut = None
            return
        keys = np.fromiter(self.categorical_2_bin.keys(), dtype=np.int64)
        vals = np.fromiter(self.categorical_2_bin.values(), dtype=np.int32)
        max_key = int(keys.max())
        lut = np.full(max_key + 2, self.num_bin - 1, dtype=np.int32)
        pos_keys = keys >= 0
        lut[keys[pos_keys]] = vals[pos_keys]
        self._cat_lut = lut

    # ------------------------------------------------------------------
    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin (reference bin.h:450-486 ValueToBin)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_NUMERICAL:
            nan_mask = np.isnan(values)
            v = np.where(nan_mask, 0.0, values)
            n_search = self.num_bin - (1 if self.missing_type == MISSING_NAN
                                       else 0)
            # first bin whose upper bound >= value
            bins = np.searchsorted(self.bin_upper_bound[:n_search - 1], v,
                                   side="left").astype(np.int32)
            if self.missing_type == MISSING_NAN:
                bins = np.where(nan_mask, self.num_bin - 1, bins)
            return bins
        with np.errstate(invalid="ignore"):   # NaN cast is overwritten
            iv = values.astype(np.int64)
        iv = np.where(np.isnan(values), -1, iv)
        out = np.full(len(values), self.num_bin - 1, dtype=np.int32)
        lut = getattr(self, "_cat_lut", None)
        if lut is None and self.categorical_2_bin:
            # mapper deserialized from an older pickle: rebuild once
            self._build_cat_cache()
            lut = self._cat_lut
        if lut is not None:
            max_key = len(lut) - 2
            in_range = (iv >= 0) & (iv <= max_key)
            out[in_range] = lut[iv[in_range]]
        return out

    # ------------------------------------------------------------------
    def to_state(self) -> dict:
        """JSON-serializable frozen-mapper state — the portable form of
        the fitted table (the quality profile carries one per feature
        so serving-side drift monitors can bin rows WITHOUT the
        training dataset; docs/MODEL_MONITORING.md).  Round-trips
        exactly through :meth:`from_state`: bounds serialize via
        ``float.hex`` so the binary-search boundaries are bit-identical
        after a JSON trip (repr would survive too, but hex is explicit
        about the contract)."""
        state = {
            "num_bin": int(self.num_bin),
            "missing_type": int(self.missing_type),
            "bin_type": int(self.bin_type),
            "min_val": float(self.min_val),
            "max_val": float(self.max_val),
            "default_bin": int(self.default_bin),
            "is_trivial": bool(self.is_trivial),
        }
        if self.bin_type == BIN_NUMERICAL:
            state["bin_upper_bound"] = [
                float(b).hex() for b in np.asarray(self.bin_upper_bound)]
        else:
            state["bin_2_categorical"] = [int(c)
                                          for c in self.bin_2_categorical]
        return state

    @classmethod
    def from_state(cls, state: dict) -> "BinMapper":
        """Rebuild a fitted mapper from :meth:`to_state` output;
        ``value_to_bin`` on the result is bit-identical to the
        original's."""
        m = cls()
        m.num_bin = int(state["num_bin"])
        m.missing_type = int(state["missing_type"])
        m.bin_type = int(state["bin_type"])
        m.min_val = float(state["min_val"])
        m.max_val = float(state["max_val"])
        m.default_bin = int(state["default_bin"])
        m.is_trivial = bool(state.get("is_trivial", False))
        if m.bin_type == BIN_NUMERICAL:
            m.bin_upper_bound = np.asarray(
                [float.fromhex(b) if isinstance(b, str) else float(b)
                 for b in state["bin_upper_bound"]], dtype=np.float64)
        else:
            m.bin_2_categorical = [int(c)
                                   for c in state["bin_2_categorical"]]
            m.categorical_2_bin = {c: i for i, c
                                   in enumerate(m.bin_2_categorical)}
            m._build_cat_cache()
        return m

    # ------------------------------------------------------------------
    def bin_to_value(self, bin_idx: int) -> float:
        """Representative threshold value for a bin (used by model text
        format: the split threshold written is the bin's upper bound)."""
        if self.bin_type == BIN_NUMERICAL:
            return float(self.bin_upper_bound[bin_idx])
        return float(self.bin_2_categorical[bin_idx])

    # ------------------------------------------------------------------
    def feature_info_str(self) -> str:
        """The model-file `feature_infos` entry (reference
        dataset.h:556-568): `[min:max]` for numerical, `a:b:c` for
        categorical, `none` for trivial."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_NUMERICAL:
            return f"[{self.min_val:g}:{self.max_val:g}]"
        return ":".join(str(c) for c in self.bin_2_categorical)

    def __repr__(self):
        kind = "num" if self.bin_type == BIN_NUMERICAL else "cat"
        return (f"BinMapper({kind}, num_bin={self.num_bin}, "
                f"missing={MISSING_TYPE_NAMES[self.missing_type]}, "
                f"trivial={self.is_trivial}, default_bin={self.default_bin})")


def resolve_construct_threads(config) -> int:
    """Resolve ``Config.construct_threads`` ("auto" or a positive
    integer) to a concrete thread count.  auto = the host core count —
    dataset construction is per-feature host work (numpy
    sort/searchsorted and the native binner release the GIL), so it
    scales with cores, not feature count."""
    spec = "auto" if config is None else getattr(config,
                                                 "construct_threads", "auto")
    s = str(spec).lower()
    if s == "auto":
        return max(1, os.cpu_count() or 1)
    n = int(float(s))
    if n <= 0:            # 0 = auto in any spelling ("0", "0.0", "00")
        return max(1, os.cpu_count() or 1)
    return n


def find_bin_mappers(sample_values: List[np.ndarray], total_sample_cnt: int,
                     max_bin: int, min_data_in_bin: int, min_split_data: int,
                     categorical_features: Optional[set] = None,
                     use_missing: bool = True,
                     zero_as_missing: bool = False,
                     num_threads: int = 1) -> List[BinMapper]:
    """Fit one BinMapper per feature from per-feature sampled non-zero
    values (reference dataset_loader.cpp:523-605; the reference fans
    this loop over OpenMP threads, dataset_loader.cpp:569 —
    ``num_threads > 1`` is the analog here).  Each feature's fit is a
    pure function of its own sample column, so the result is
    byte-identical at every thread count; ``ThreadPoolExecutor.map``
    preserves feature order."""
    categorical_features = categorical_features or set()

    def fit_one(fidx: int) -> BinMapper:
        m = BinMapper()
        bt = BIN_CATEGORICAL if fidx in categorical_features \
            else BIN_NUMERICAL
        m.find_bin(sample_values[fidx], total_sample_cnt, max_bin,
                   min_data_in_bin, min_split_data, bt, use_missing,
                   zero_as_missing)
        return m

    n = len(sample_values)
    if num_threads <= 1 or n <= 1:
        return [fit_one(i) for i in range(n)]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(num_threads, n)) as ex:
        return list(ex.map(fit_one, range(n)))
