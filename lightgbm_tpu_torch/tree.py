"""Host-side tree model: struct-of-arrays, prediction, serialization.

Mirrors the reference Tree (include/LightGBM/tree.h:20-392,
src/io/tree.cpp) — array-of-nodes with negative-encoded leaf children,
``decision_type`` bitfield (bit0 categorical, bit1 default-left,
bits2-3 missing type — tree.h:14-15,183-202) and the v2.1.1 text format
(Tree::ToString), the same text the JAX package writes and reads.  The
device grower (learner/grower.py) emits bin-space tree arrays;
``Tree.from_grower_arrays`` converts thresholds to real values through
the BinMappers so saved models are interchangeable with the
reference's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2
K_ZERO_THRESHOLD = 1e-35


def ensemble_cat_width(models: List["Tree"]) -> int:
    """Widest per-node categorical bitset (in uint32 words) across an
    ensemble — the padded W of every device tree stack."""
    W = 1
    for t in models:
        for i in range(t.num_leaves - 1):
            if t.decision_type[i] & K_CATEGORICAL_MASK:
                ci = int(t.threshold[i])
                W = max(W, t.cat_boundaries[ci + 1] - t.cat_boundaries[ci])
    return W


def tree_cat_words(t: "Tree", width: int) -> np.ndarray:
    """One tree's per-node categorical bitsets as a dense
    (num_leaves-1, width) uint32 block (zero-padded)."""
    m = max(t.num_leaves - 1, 0)
    cw = np.zeros((m, width), np.uint32)
    for i in range(m):
        if t.decision_type[i] & K_CATEGORICAL_MASK:
            ci = int(t.threshold[i])
            lo, hi = t.cat_boundaries[ci], t.cat_boundaries[ci + 1]
            words = np.asarray(t.cat_threshold[lo:hi], dtype=np.uint32)
            cw[i, :len(words)] = words
    return cw


def split_threshold_parts(thr: np.ndarray):
    """f64 thresholds -> (hi, lo) f32 pair for the device two-float
    compare.  +-inf thresholds (a split keeping the NaN/overflow bin on
    one side) must keep lo finite: inf - inf is NaN, and a NaN residual
    poisons the compare into always-right, diverging from the host
    walk's ``fv <= +inf`` (the r7 fix — ONE definition, shared by every
    device tree stacker)."""
    hi = thr.astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = (thr - hi.astype(np.float64)).astype(np.float32)
    return hi, np.where(np.isnan(lo), np.float32(0), lo)


def flatten_ensemble(models: List["Tree"], num_class: int = 1
                     ) -> Dict[str, np.ndarray]:
    """Ensemble-level SoA node layout for the level-synchronous device
    descent (ops/predict.py predict_level_ensemble).

    The per-tree node arrays of the whole ensemble land in ONE flat
    node axis — tree ``t``'s node ``i`` at flat slot ``t*M + i`` (M =
    the batch max node count) — with child pointers PRE-RESOLVED into
    that flat space (internal child ``c`` -> ``t*M + c``; leaf ``l`` ->
    ``-(t*L + l) - 1``, indexing the flat leaf-value vector), so the
    descent never forms ``t*M + node`` on device and one (N, T) gather
    per small table serves every tree at once.  The split feature is
    pre-DOUBLED (``2*f``) to index the interleaved (N, 2F) hi/lo
    matrix: a single take_along_axis per level fetches BOTH float
    parts of the two-float threshold compare for every (row, tree)
    pair — the whole-ensemble replacement for the per-tree scan's two
    full-matrix gathers per node step.

    Returns the LevelEnsemble field dict (numpy; feat2/thr_hi/thr_lo/
    dtype_/left/right/leaf_value/cat_words/root/cls_onehot) plus the
    static ``depth`` bound (max tree depth — the unrolled level count
    that settles every row).
    """
    T = len(models)
    if T == 0:
        raise ValueError("flatten_ensemble needs at least one tree")
    M = max(max(t.num_leaves - 1 for t in models), 1)
    L = M + 1
    W = ensemble_cat_width(models)
    feat2 = np.zeros((T, M), np.int32)
    thr = np.zeros((T, M), np.float64)
    dt = np.zeros((T, M), np.int32)
    left = np.zeros((T, M), np.int64)
    right = np.zeros((T, M), np.int64)
    lv = np.zeros((T, L), np.float32)
    cw = np.zeros((T, M, W), np.uint32)
    root = np.zeros(T, np.int32)
    depth = 0
    for k, t in enumerate(models):
        m = t.num_leaves - 1
        if m <= 0:
            # stump: the root IS leaf 0 — encode it settled
            lv[k, 0] = t.leaf_value[0] if len(t.leaf_value) else 0.0
            root[k] = -(k * L) - 1
            continue
        root[k] = k * M
        depth = max(depth, t.max_depth())
        feat2[k, :m] = 2 * t.split_feature[:m]
        thr[k, :m] = t.threshold[:m]
        dt[k, :m] = t.decision_type[:m]
        # child pointers resolved into the flat node/leaf spaces
        for arr, out in ((t.left_child, left), (t.right_child, right)):
            c = np.asarray(arr[:m], np.int64)
            out[k, :m] = np.where(c >= 0, k * M + c, -(k * L + (-c - 1)) - 1)
        lv[k, :t.num_leaves] = t.leaf_value[:t.num_leaves]
        cw[k, :m] = tree_cat_words(t, W)
    hi, lo = split_threshold_parts(thr)
    k_cls = max(num_class, 1)
    cls_onehot = np.zeros((T, k_cls), np.float32)
    cls_onehot[np.arange(T), np.arange(T) % k_cls] = 1.0
    return {
        "feat2": feat2.reshape(-1),
        "thr_hi": hi.reshape(-1),
        "thr_lo": lo.reshape(-1),
        "dtype_": dt.reshape(-1),
        "left": left.reshape(-1).astype(np.int32),
        "right": right.reshape(-1).astype(np.int32),
        "leaf_value": lv.reshape(-1),
        "cat_words": cw.reshape(-1).view(np.int32),
        "root": root,
        "cls_onehot": cls_onehot,
        "depth": depth,
    }


def _make_decision_type(is_cat: bool, default_left: bool,
                        missing_type: int) -> int:
    dt = 0
    if is_cat:
        dt |= K_CATEGORICAL_MASK
    if default_left:
        dt |= K_DEFAULT_LEFT_MASK
    dt |= (missing_type & 3) << 2
    return dt


def _construct_bitset(values: List[int]) -> List[int]:
    """Common::ConstructBitset (reference utils/common.h:815-824)."""
    if not values:
        return []
    n_words = max(values) // 32 + 1
    words = [0] * n_words
    for v in values:
        words[v // 32] |= (1 << (v % 32))
    return words


class Tree:
    """One decision tree in model space (real thresholds/categories)."""

    def __init__(self, num_leaves: int):
        self.num_leaves = num_leaves
        m = max(num_leaves - 1, 0)
        self.split_feature = np.zeros(m, dtype=np.int32)   # real feature idx
        self.split_gain = np.zeros(m, dtype=np.float64)
        self.threshold = np.zeros(m, dtype=np.float64)
        self.decision_type = np.zeros(m, dtype=np.int32)
        self.left_child = np.zeros(m, dtype=np.int32)
        self.right_child = np.zeros(m, dtype=np.int32)
        self.leaf_value = np.zeros(num_leaves, dtype=np.float64)
        self.leaf_count = np.zeros(num_leaves, dtype=np.int64)
        self.internal_value = np.zeros(m, dtype=np.float64)
        self.internal_count = np.zeros(m, dtype=np.int64)
        self.shrinkage = 1.0
        # categorical storage (reference tree.h cat_boundaries_/cat_threshold_)
        self.num_cat = 0
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []

    # ------------------------------------------------------------------
    @classmethod
    def from_grower_arrays(cls, arrs: Dict[str, np.ndarray],
                           dataset) -> "Tree":
        """Convert device TreeArrays (bin space) to model space."""
        num_leaves = int(arrs["num_leaves"])
        t = cls(num_leaves)
        m = num_leaves - 1
        if m <= 0:
            t.leaf_value[0] = float(arrs["leaf_value"][0])
            t.leaf_count[0] = int(arrs["leaf_count"][0])
            return t
        feats = dataset.features
        t.leaf_value = arrs["leaf_value"][:num_leaves].astype(np.float64)
        t.leaf_count = np.round(
            arrs["leaf_count"][:num_leaves]).astype(np.int64)
        t.split_gain = arrs["node_gain"][:m].astype(np.float64)
        t.internal_value = arrs["node_value"][:m].astype(np.float64)
        t.internal_count = np.round(arrs["node_count"][:m]).astype(np.int64)
        t.left_child = arrs["node_left"][:m].astype(np.int32)
        t.right_child = arrs["node_right"][:m].astype(np.int32)
        node_feat = arrs["node_feature"][:m]
        node_thr = arrs["node_threshold"][:m]
        node_dl = arrs["node_default_left"][:m]
        node_cat = arrs["node_is_cat"][:m]
        cat_mask = arrs["node_cat_mask"][:m]
        for i in range(m):
            fv = feats[int(node_feat[i])]
            t.split_feature[i] = fv.feature_idx
            if node_cat[i]:
                cats = [fv.mapper.bin_2_categorical[b]
                        for b in np.nonzero(cat_mask[i][:fv.num_bin])[0]
                        if fv.mapper.bin_2_categorical[b] >= 0]
                words = _construct_bitset(cats)
                t.threshold[i] = t.num_cat
                t.num_cat += 1
                t.cat_boundaries.append(t.cat_boundaries[-1] + len(words))
                t.cat_threshold.extend(words)
                t.decision_type[i] = _make_decision_type(
                    True, False, fv.missing_type)
            else:
                t.threshold[i] = fv.mapper.bin_to_value(int(node_thr[i]))
                t.decision_type[i] = _make_decision_type(
                    False, bool(node_dl[i]), fv.missing_type)
        return t

    # ------------------------------------------------------------------
    def apply_shrinkage(self, rate: float) -> None:
        """reference tree.h:139 Shrinkage()."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate

    # ------------------------------------------------------------------
    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """Vectorized GetLeaf (reference tree.h:487-499): returns the
        leaf index per row of raw feature matrix X."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int32)
        active = node >= 0
        cat_bounds = np.asarray(self.cat_boundaries, dtype=np.int64)
        cat_words = np.asarray(self.cat_threshold, dtype=np.uint32)
        if cat_words.size == 0:
            cat_words = np.zeros(1, dtype=np.uint32)
        # every step resolves one level; bounded by num_leaves
        for _ in range(self.num_leaves):
            if not active.any():
                break
            idx = node[active]
            fvals = X[active, self.split_feature[idx]]
            dt = self.decision_type[idx]
            is_cat = (dt & K_CATEGORICAL_MASK) > 0
            default_left = (dt & K_DEFAULT_LEFT_MASK) > 0
            mtype = (dt >> 2) & 3
            thr = self.threshold[idx]
            nan_mask = np.isnan(fvals)
            fv = np.where(nan_mask & (mtype != 2), 0.0, fvals)
            is_zero = (fv > -K_ZERO_THRESHOLD) & (fv <= K_ZERO_THRESHOLD)
            use_default = ((mtype == 1) & is_zero) | \
                          ((mtype == 2) & np.isnan(fv))
            go_left = np.where(use_default, default_left, fv <= thr)
            if is_cat.any():
                # each categorical row's bit in its node's bitset: the
                # category (truncated toward zero; NaN and negatives go
                # right) indexes a word of the node's slice of the flat
                # cat_threshold words
                j = np.nonzero(is_cat)[0]
                v = fvals[j]
                ok = ~np.isnan(v)
                iv = np.where(ok, np.trunc(np.where(ok, v, 0.0)), -1.0)
                ci = thr[j].astype(np.int64)
                lo, hi = cat_bounds[ci], cat_bounds[ci + 1]
                word = np.floor_divide(iv, 32.0)
                ok &= (iv >= 0) & (word < hi - lo)
                at = np.where(ok, lo + np.where(ok, word, 0.0), 0
                              ).astype(np.int64)
                bit = np.where(ok, iv - 32.0 * word, 0.0).astype(np.int64)
                hit = ok & (((cat_words[at] >> bit.astype(np.uint32)) & 1)
                            > 0)
                go_left = go_left.copy()
                go_left[j] = hit
            nxt = np.where(go_left, self.left_child[idx],
                           self.right_child[idx])
            node[active] = nxt
            active = node >= 0
        return (-node - 1).astype(np.int32)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.leaf_value[self.predict_leaf(X)]

    # ------------------------------------------------------------------
    def max_depth(self) -> int:
        if self.num_leaves <= 1:
            return 0
        depth = np.zeros(self.num_leaves - 1, dtype=np.int32)
        leaf_depth = np.zeros(self.num_leaves, dtype=np.int32)
        for i in range(self.num_leaves - 1):
            for child in (self.left_child[i], self.right_child[i]):
                if child >= 0:
                    depth[child] = depth[i] + 1
                else:
                    leaf_depth[-child - 1] = depth[i] + 1
        return int(leaf_depth.max())

    # ------------------------------------------------------------------
    def to_string(self) -> str:
        """v2.1.1 Tree::ToString (reference src/io/tree.cpp)."""
        m = self.num_leaves - 1
        out = []
        out.append(f"num_leaves={self.num_leaves}")
        out.append(f"num_cat={self.num_cat}")
        out.append("split_feature=" + _join_int(self.split_feature[:m]))
        out.append("split_gain=" + _join_float(self.split_gain[:m]))
        out.append("threshold=" + _join_float(self.threshold[:m], 20))
        out.append("decision_type=" + _join_int(self.decision_type[:m]))
        out.append("left_child=" + _join_int(self.left_child[:m]))
        out.append("right_child=" + _join_int(self.right_child[:m]))
        out.append("leaf_value=" + _join_float(self.leaf_value, 20))
        out.append("leaf_count=" + _join_int(self.leaf_count))
        out.append("internal_value=" + _join_float(self.internal_value[:m]))
        out.append("internal_count=" + _join_int(self.internal_count[:m]))
        if self.num_cat > 0:
            out.append("cat_boundaries=" + _join_int(self.cat_boundaries))
            out.append("cat_threshold=" + _join_int(self.cat_threshold))
        out.append(f"shrinkage={self.shrinkage:g}")
        out.append("")
        return "\n".join(out)

    # ------------------------------------------------------------------
    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in text.splitlines():
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        num_leaves = int(kv["num_leaves"])
        t = cls(num_leaves)
        t.num_cat = int(kv.get("num_cat", "0"))
        m = num_leaves - 1

        def ints(key, n):
            if n == 0 or key not in kv or not kv[key].strip():
                return np.zeros(n, dtype=np.int64)
            return np.array(kv[key].split(), dtype=np.int64)

        def floats(key, n):
            if n == 0 or key not in kv or not kv[key].strip():
                return np.zeros(n, dtype=np.float64)
            return np.array(kv[key].split(), dtype=np.float64)

        t.split_feature = ints("split_feature", m).astype(np.int32)
        t.split_gain = floats("split_gain", m)
        t.threshold = floats("threshold", m)
        t.decision_type = ints("decision_type", m).astype(np.int32)
        t.left_child = ints("left_child", m).astype(np.int32)
        t.right_child = ints("right_child", m).astype(np.int32)
        t.leaf_value = floats("leaf_value", num_leaves)
        t.leaf_count = ints("leaf_count", num_leaves)
        t.internal_value = floats("internal_value", m)
        t.internal_count = ints("internal_count", m)
        if t.num_cat > 0:
            t.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split()]
            t.cat_threshold = [int(x) for x in kv["cat_threshold"].split()]
        t.shrinkage = float(kv.get("shrinkage", "1"))
        return t

    # ------------------------------------------------------------------
    def leaf_output(self, leaf: int) -> float:
        return float(self.leaf_value[leaf])

    def set_leaf_output(self, leaf: int, value: float) -> None:
        self.leaf_value[leaf] = value


def _join_int(arr) -> str:
    return " ".join(str(int(x)) for x in arr)


def _join_float(arr, precision: int = 10) -> str:
    return " ".join(f"{float(x):.{precision}g}" for x in arr)
