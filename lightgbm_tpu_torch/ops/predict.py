"""Device prediction: the ensemble level descent (serving), its
co-batched form over several models, the per-tree raw-feature scan,
the f64 -> (hi, lo) split on the device, and the binned single-tree
walk (validation scores during training).

Port of lightgbm_tpu/ops/predict.py.  ``predict_level_ensemble`` runs
the hand-written CUDA kernel C (csrc/predict_level.cu) on CUDA tensors
and its plain PyTorch version on CPU tensors.  The kernel reads the
ensemble as node records (:class:`LevelRecords`, packed once per
ensemble from the JAX package's LevelEnsemble layout by
:func:`pack_level_records`); ``predict_level_ensemble_plain`` keeps the
JAX function's form on the LevelEnsemble, which the kernel is held
against.  The raw-feature scan (``predict_raw_ensemble``) and the
binned walk are plain XLA in the JAX package and torch ops here.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .partition import packed_select_params

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

K_ZERO_THRESHOLD = 1e-35
K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2

# the serving predictor's counters (lightgbm_tpu/ops/predict.py
# PREDICT_TELEMETRY): ``dispatches`` device calls, ``rows`` the rows
# they scored (pad rows not counted), ``buckets`` the padded row-bucket
# shapes served.  ``traces`` counts jit retraces in the JAX package;
# nothing here compiles per shape (kernel C is built once), so it stays 0.
PREDICT_TELEMETRY = {"traces": 0, "dispatches": 0, "rows": 0,
                     "buckets": set()}


def reset_predict_telemetry() -> None:
    PREDICT_TELEMETRY.update(traces=0, dispatches=0, rows=0, buckets=set())


class LevelEnsemble(NamedTuple):
    """Flat SoA node tensors of a whole ensemble (tree.flatten_ensemble
    layout): node axis = t*M + i, leaf axis = t*L + l, child pointers
    pre-resolved into those spaces, feat2 pre-doubled for the
    interleaved hi/lo feature matrix."""
    feat2: torch.Tensor        # (T*M,) int32 = 2 * feature
    thr_hi: torch.Tensor       # (T*M,) f32
    thr_lo: torch.Tensor       # (T*M,) f32 residual (finite)
    dtype_: torch.Tensor       # (T*M,) int32 decision_type bitfield
    left: torch.Tensor         # (T*M,) int32 flat child (negative = leaf)
    right: torch.Tensor        # (T*M,) int32
    leaf_value: torch.Tensor   # (T*L,) f32
    cat_words: torch.Tensor    # (T*M*W,) int32 per-node category bitset
    root: torch.Tensor         # (T,) int32 initial node (stumps settled)
    cls_onehot: torch.Tensor   # (T, K) f32 tree -> class accumulator


def level_ensemble_from_numpy(flat: dict, device) -> LevelEnsemble:
    """tree.flatten_ensemble's numpy dict (either package's) ->
    LevelEnsemble tensors on ``device`` (the ``depth`` entry is
    ignored)."""
    return LevelEnsemble(**{k: torch.from_numpy(np.ascontiguousarray(
        flat[k])).to(device) for k in LevelEnsemble._fields})


def split_hi_lo(X: np.ndarray):
    """float64 matrix -> (hi, lo) f32 pair with hi + lo == X to ~48
    mantissa bits (enough to reproduce f64 threshold decisions on any
    f32-representable data)."""
    X = np.asarray(X, dtype=np.float64)
    hi = X.astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = (X - hi.astype(np.float64)).astype(np.float32)
    return hi, np.where(np.isnan(lo), np.float32(0), lo)


def interleave_hi_lo(X: np.ndarray) -> np.ndarray:
    """(n, F) float64 -> (n, 2F) f32 with hi/lo parts interleaved."""
    hi, lo = split_hi_lo(X)
    x2 = np.empty((hi.shape[0], 2 * hi.shape[1]), np.float32)
    x2[:, 0::2] = hi
    x2[:, 1::2] = lo
    return x2


def split_hi_lo_device(X64: torch.Tensor, out=None) -> torch.Tensor:
    """:func:`interleave_hi_lo` in torch ops on ``X64``'s device: an (n,
    F) float64 tensor -> the (n, 2F) float32 matrix of each value's
    (hi, lo) pair, bit for bit the numpy function's.  hi is the value
    rounded to f32 (+-inf past the f32 range); lo is the f64 residual
    rounded to f32, 0 where it is NaN (a NaN or +-inf value), -+inf past
    the range.  Neither cast flushes f32 subnormals (torch's casts keep
    them on the CPU and the card).  ``out``: a contiguous (n, 2F) f32
    tensor on the same device to write, returned."""
    if X64.dtype != torch.float64 or X64.dim() != 2:
        raise ValueError("X64 must be an (n, F) float64 tensor")
    n, F = X64.shape
    if out is None:
        out = torch.empty((n, 2 * F), dtype=torch.float32,
                          device=X64.device)
    elif out.dtype != torch.float32 or tuple(out.shape) != (n, 2 * F) \
            or not out.is_contiguous() or out.device != X64.device:
        raise ValueError(f"out must be a contiguous ({n}, {2 * F}) float32 "
                         f"tensor on {X64.device}")
    pairs = out.view(n, F, 2)
    hi = pairs[..., 0]
    hi.copy_(X64)
    lo = X64 - hi.to(torch.float64)
    pairs[..., 1].copy_(lo.masked_fill_(torch.isnan(lo), 0.0))
    return out


def _goes_left(vhi, vlo, dt, thr_hi, thr_lo, node_words, W: int):
    """_level_step's rule (lightgbm_tpu/ops/predict.py:195-229) for
    every (row, tree) pair: the two-float threshold compare with its inf
    guard, the NaN / zero missing-value defaults (NaN read as 0 where
    the missing type is not NaN), and the categorical bitset test after
    a saturating float -> int32 truncation.  ``node_words(w)`` returns
    word ``w`` (in [0, W)) of each pair's node's category bitset."""
    is_cat = (dt & K_CATEGORICAL_MASK) > 0
    dleft = (dt & K_DEFAULT_LEFT_MASK) > 0
    mtype = (dt >> 2) & 3
    nan_mask = torch.isnan(vhi)
    conv = nan_mask & (mtype != MISSING_NAN)
    zero = torch.zeros((), device=vhi.device)
    fhi = torch.where(conv, zero, vhi)
    flo = torch.where(conv, zero, vlo)
    is_zero = (fhi > -K_ZERO_THRESHOLD) & (fhi <= K_ZERO_THRESHOLD)
    use_default = ((mtype == MISSING_ZERO) & is_zero) | \
                  ((mtype == MISSING_NAN) & torch.isnan(fhi))
    d = torch.where(fhi == thr_hi, flo - thr_lo,
                    (fhi - thr_hi) + (flo - thr_lo))
    num_left = torch.where(use_default, dleft, d <= 0.0)
    # float -> int32 truncation, saturating (XLA's convert semantics)
    v_int = torch.where(
        nan_mask, torch.full_like(fhi, -1.0),
        fhi.clamp(-2147483648.0, 2147483520.0)).to(torch.int32)
    in_range = (v_int >= 0) & (v_int < W * 32)
    word = node_words(torch.div(v_int, 32, rounding_mode="floor").clamp(
        0, W - 1).long())
    bit = torch.bitwise_right_shift(
        word.to(torch.int64) & 0xFFFFFFFF, torch.remainder(v_int, 32)) & 1
    cat_left = in_range & (bit > 0)
    return torch.where(is_cat, cat_left, num_left)


def _level_step(stack: LevelEnsemble, X2: torch.Tensor, node: torch.Tensor,
                T: int, W: int) -> torch.Tensor:
    """Advance every (row, tree) pair one level.  ``node`` is (N, T)
    flat node ids; negative = settled leaf (kept as-is)."""
    nid = node.clamp(min=0).long()
    f2 = stack.feat2[nid].long()                         # (N, T)
    go_left = _goes_left(
        torch.gather(X2, 1, f2), torch.gather(X2, 1, f2 + 1),
        stack.dtype_[nid], stack.thr_hi[nid], stack.thr_lo[nid],
        lambda w: stack.cat_words[nid * W + w], W)
    nxt = torch.where(go_left, stack.left[nid], stack.right[nid])
    return torch.where(node >= 0, nxt, node)


def predict_level_ensemble_plain(stack: LevelEnsemble, X2: torch.Tensor, *,
                                 depth: int) -> torch.Tensor:
    """Plain version of kernel C on the JAX package's input: all-trees
    level descent over an interleaved (N, 2F) hi/lo matrix -> (N, K) f32
    class-accumulated raw scores, summed by a matrix product as the JAX
    function sums them."""
    T = stack.root.shape[0]
    W = stack.cat_words.shape[0] // max(stack.feat2.shape[0], 1)
    n = X2.shape[0]
    node = stack.root[None, :].expand(n, T).contiguous()
    for _ in range(depth):
        node = _level_step(stack, X2, node, T, W)
    leaf = (-node - 1).clamp(0, stack.leaf_value.shape[0] - 1).long()
    vals = stack.leaf_value[leaf]                        # (N, T)
    return vals @ stack.cls_onehot                       # (N, K)


# ---------------------------------------------------------------------------
# kernel C's input: the ensemble as node records
# ---------------------------------------------------------------------------
class LevelRecords(NamedTuple):
    """A LevelEnsemble packed once for kernel C (:func:`pack_level_records`).

    Trees are stored in class-major order: position p holds tree
    ``meta[p, 0]``, all trees of class 0 first, each class's trees in
    tree order, so a row adds each class's trees in tree order and
    walks every tree once.  Node i of the tree at position p is record
    ``p * M + i``; leaf l is ``leaves[p * L + l]``.  A node's 16-byte
    walk record is::

        walk[., 0] = feat2 << 5 | nan_left << 4 | decision_type
        walk[., 1] = thr_hi bits,  walk[., 2] = thr_lo bits
        walk[., 3] = left & 0xFFFF | right << 16

    with feat2 = 2 * feature, nan_left where a NaN value goes at the
    node read as numerical (which the kernel would otherwise work out
    from the missing type on every visit), and the children as
    tree-local codes (i >= 0: node i of the same tree; -(l) - 1: leaf l
    of it), valid while a tree has at most 32,767 nodes and 32,768
    leaves.  ``links`` keeps the flat child ids as the
    LevelEnsemble has them (the walk reads them past that size), and a
    node's category words are ``cats[(p * M + i) * W:][:W]``."""
    walk: torch.Tensor     # (T*M, 4) int32
    links: torch.Tensor    # (T*M, 2) int32 flat {left, right}
    meta: torch.Tensor     # (T, 4) int32 {tree, class, local root, starts
                           # its class (1: the first tree of its class)}
    leaves: torch.Tensor   # (T*L,) f32
    cats: torch.Tensor     # (T*M*W,) int32
    num_class: int
    leaf0: int             # leaves index of flat leaf 0 (what a row
                           # unsettled after ``depth`` levels adds)
    max_feat2: int         # largest feat2 of a reachable node (-1: none)
    has_cat: bool          # some node is categorical
    empty_classes: bool    # some class has no tree (its score is 0)


def record_dims(rec: LevelRecords):
    """(T, M, L, W): trees, nodes a tree, leaves a tree, category words a
    node."""
    T = rec.meta.shape[0]
    M = rec.walk.shape[0] // T
    return T, M, rec.leaves.shape[0] // T, rec.cats.shape[0] // (T * M)


def _uses_links(M: int, L: int) -> bool:
    """Children past the walk record's 16-bit tree-local codes."""
    return M > 32767 or L > 32768


def _local(g: torch.Tensor, t: torch.Tensor, M: int, L: int):
    """Flat child ids -> tree-local codes of tree ``t``."""
    return torch.where(g >= 0, g - t * M, g + t * L)


def _reachable(root, left, right, T: int, M: int, L: int) -> torch.Tensor:
    """(T*M,) bool: the nodes a walk can reach.  Raises where a root or a
    reachable node's child lies outside its own tree (the walk reads one
    tree's records at a time)."""
    def in_tree(g, t):
        lf = -g - 1
        return torch.where(g >= 0, (g >= t * M) & (g < (t + 1) * M),
                           (lf >= t * L) & (lf < (t + 1) * L))

    if not bool(in_tree(root, torch.arange(T)).all()):
        raise ValueError("LevelEnsemble: a root lies outside its tree")
    reach = torch.zeros(T * M, dtype=torch.bool)
    front = root[root >= 0]
    while front.numel():
        reach[front] = True
        ch = torch.cat([left[front], right[front]])
        if not bool(in_tree(ch, torch.cat([front // M] * 2)).all()):
            raise ValueError("LevelEnsemble: a reachable node's child lies "
                             "outside its tree")
        nxt = ch[ch >= 0].unique()
        front = nxt[~reach[nxt]]
    return reach


def _nan_left(s: LevelEnsemble) -> torch.Tensor:
    """(T*M,) bool: where _goes_left sends a NaN value (its lo part 0, as
    split_hi_lo makes it) at each node, read as numerical: the default
    direction under the zero and NaN missing types, else the compare of
    (0, 0), to which the NaN is converted."""
    nan = torch.full_like(s.thr_hi, float("nan"))
    zero = torch.zeros_like(nan)
    return _goes_left(nan, zero, s.dtype_ & ~K_CATEGORICAL_MASK, s.thr_hi,
                      s.thr_lo, lambda w: zero.to(torch.int32), 1)


def pack_level_records(stack: LevelEnsemble) -> LevelRecords:
    """Pack a LevelEnsemble into kernel C's node records, once per
    ensemble (plain torch on the host; the result lies on the stack's
    device).  Raises on what the records cannot hold: a cls_onehot row
    that is not one-hot, a decision type past 4 bits, an odd or negative
    feat2 or one from 2**26, a root or reachable child outside its
    tree.  :func:`unpack_level_records` gives every field back bit for
    bit."""
    dev = stack.feat2.device
    s = LevelEnsemble(*(t.detach().to("cpu") for t in stack))
    if s.cls_onehot.dim() != 2 or s.root.dim() != 1:
        raise ValueError("LevelEnsemble: cls_onehot must be (T, K), root "
                         "(T,)")
    T, K = s.cls_onehot.shape
    TM = s.feat2.shape[0]
    if T < 1 or K < 1 or s.root.shape[0] != T or TM < T or TM % T \
            or s.leaf_value.shape[0] % T or s.cat_words.shape[0] % TM \
            or s.cat_words.shape[0] < TM \
            or any(getattr(s, f).shape != (TM,) for f in (
                "thr_hi", "thr_lo", "dtype_", "left", "right")):
        raise ValueError("LevelEnsemble: field lengths do not stack T "
                         "trees of M nodes, L leaves and W >= 1 category "
                         "words a node")
    M, L, W = TM // T, s.leaf_value.shape[0] // T, s.cat_words.shape[0] // TM
    cls = s.cls_onehot
    if not bool((((cls == 0) | (cls == 1)).all()) & (cls.sum(1) == 1).all()):
        raise ValueError("LevelEnsemble: every cls_onehot row must be "
                         "one-hot")
    f2, dt = s.feat2.long(), s.dtype_.long()
    if bool(((dt < 0) | (dt > 15)).any()):
        raise ValueError("LevelEnsemble: decision types must fit 4 bits")
    if bool(((f2 < 0) | (f2 >= 1 << 26) | (f2 % 2 != 0)).any()):
        raise ValueError("LevelEnsemble: feat2 must be 2 * feature with "
                         "feature < 2**25")
    left, right, root = s.left.long(), s.right.long(), s.root.long()
    reach = _reachable(root, left, right, T, M, L)
    t_node = torch.arange(TM) // M
    lr = (_local(left, t_node, M, L) & 0xFFFF) \
        | ((_local(right, t_node, M, L) & 0xFFFF) << 16)
    lr = torch.where(lr >= 1 << 31, lr - (1 << 32), lr)
    walk = torch.stack([(f2 << 5) | (_nan_left(s).long() << 4) | dt,
                        s.thr_hi.view(torch.int32).long(),
                        s.thr_lo.view(torch.int32).long(), lr], 1)
    tree_class = cls.argmax(1)
    order = torch.sort(tree_class, stable=True).indices
    cls_p = tree_class[order]
    starts = torch.ones(T, dtype=torch.long)
    starts[1:] = (cls_p[1:] != cls_p[:-1]).long()
    meta = torch.stack([order, cls_p, _local(root[order], order, M, L),
                        starts], 1)

    def by_position(a, width):
        return a.reshape(T, width)[order].reshape(a.shape).contiguous()

    return LevelRecords(
        walk=by_position(walk.to(torch.int32), M * 4).to(dev),
        links=by_position(torch.stack([s.left, s.right], 1), M * 2).to(dev),
        meta=meta.to(torch.int32).contiguous().to(dev),
        leaves=by_position(s.leaf_value, L).to(dev),
        cats=by_position(s.cat_words, M * W).to(dev),
        num_class=int(K),
        leaf0=int((order == 0).nonzero()[0, 0]) * L,
        max_feat2=int(f2[reach].max()) if bool(reach.any()) else -1,
        has_cat=bool((dt & K_CATEGORICAL_MASK).any()),
        empty_classes=int(tree_class.unique().numel()) < K)


def unpack_level_records(rec: LevelRecords) -> LevelEnsemble:
    """The LevelEnsemble that :func:`pack_level_records` packed."""
    T, M, L, W = record_dims(rec)
    inv = torch.argsort(rec.meta[:, 0].long())

    def by_tree(a, width):
        return a.reshape(T, width)[inv].reshape(a.shape).contiguous()

    walk = by_tree(rec.walk, M * 4)
    links = by_tree(rec.links, M * 2)
    meta = rec.meta[inv]
    t = torch.arange(T, device=meta.device, dtype=torch.int32)
    rl = meta[:, 2]
    return LevelEnsemble(
        feat2=walk[:, 0] >> 5, thr_hi=walk[:, 1].contiguous().view(
            torch.float32),
        thr_lo=walk[:, 2].contiguous().view(torch.float32),
        dtype_=walk[:, 0] & 15, left=links[:, 0].contiguous(),
        right=links[:, 1].contiguous(), leaf_value=by_tree(rec.leaves, L),
        cat_words=by_tree(rec.cats, M * W),
        root=torch.where(rl >= 0, rl + t * M, rl - t * L),
        cls_onehot=torch.nn.functional.one_hot(
            meta[:, 1].long(), rec.num_class).to(torch.float32))


def _walk_records(rec: LevelRecords, X2: torch.Tensor, depth: int):
    """Kernel C's walk over the records in torch ops: (N, T) final
    tree-local codes (position order) and the node visits it made (the
    (row, tree) pairs still walking at each level, summed)."""
    T, M, L, W = record_dims(rec)
    n, dev = X2.shape[0], X2.device
    base = (torch.arange(T, device=dev) * M)[None, :]
    t_pos = rec.meta[:, 0].long()[None, :]
    node = rec.meta[:, 2][None, :].expand(n, T).contiguous()
    visits = 0
    for _ in range(depth):
        live = node >= 0
        n_live = int(live.sum())
        if n_live == 0:
            break
        visits += n_live
        idx = base + node.clamp(min=0).long()
        w = rec.walk[idx]                                # (N, T, 4)
        f2 = (w[..., 0] >> 5).long()
        go_left = _goes_left(
            torch.gather(X2, 1, f2), torch.gather(X2, 1, f2 + 1),
            w[..., 0] & 15, w[..., 1].view(torch.float32),
            w[..., 2].view(torch.float32),
            lambda wi: rec.cats[idx * W + wi], W)
        if _uses_links(M, L):
            g = rec.links[idx]
            nxt = _local(torch.where(go_left, g[..., 0], g[..., 1]).long(),
                         t_pos, M, L)
        else:
            lr = w[..., 3]
            nxt = torch.where(go_left, ((lr & 0xFFFF) ^ 0x8000) - 0x8000,
                              torch.div(lr, 65536, rounding_mode="floor"))
        node = torch.where(live, nxt.to(torch.int32), node)
    return node, visits


def predict_level_records_plain(rec: LevelRecords, X2: torch.Tensor, *,
                                depth: int) -> torch.Tensor:
    """Plain version of kernel C on its own input (the records): (N, K)
    f32 raw scores, each row's class sum adding its trees in tree order
    from 0.0, as the kernel adds them (so the two agree bit for bit)."""
    T, M, L, W = record_dims(rec)
    node, _ = _walk_records(rec, X2, depth)
    leaf = (-node - 1).clamp(min=0).long() \
        + (torch.arange(T, device=X2.device) * L)[None, :]
    vals = torch.where(node < 0, rec.leaves[leaf], rec.leaves[rec.leaf0])
    out = torch.zeros((X2.shape[0], rec.num_class), dtype=torch.float32,
                      device=X2.device)
    for j, c in enumerate(rec.meta[:, 1].tolist()):
        out[:, c] += vals[:, j]
    return out


def level_visits(rec: LevelRecords, X2: torch.Tensor, depth: int) -> int:
    """Node visits of the walk on this input: the sum over rows and
    trees of the path length (what the kernel's visit bound counts)."""
    return _walk_records(rec, X2, depth)[1]


# ---------------------------------------------------------------------------
# kernel C's launch plan
# ---------------------------------------------------------------------------
#: threads (rows) a CTA of the shared tier: 256 where two CTAs share an
#: SM, else 512
PREDICT_BLOCKS = (256, 512)
#: the shared memory an H100 CTA may opt in to (227 KB)
PREDICT_SMEM_LIMIT = 232448
#: the shared memory each of two CTAs on one SM may take (the SM's 228
#: KB, less 1 KB a CTA, halved)
PREDICT_SMEM_PAIR = 115712
#: batches from this many rows take the shared tier, smaller ones the
#: global tier: for an ensemble in one chunk, and for one in several
#: (where every tile copies every chunk, so a wave of tiles must fill the
#: card first); the crossings measured on the card (PERF.md §6, PR 9)
SHARED_TIER_MIN_ROWS = 16384
SHARED_TIER_MIN_ROWS_CHUNKED = 32768


class LevelPlan(NamedTuple):
    """How kernel C walks one batch.  ``tier`` "shared": CTAs of
    ``threads`` threads, a row each, copy ``trees_per_chunk`` trees'
    records, meta and leaf values (and their category words where
    ``cat_shared``) into shared memory, chunk after chunk, with the
    tile's (hi, lo) pairs staged there too where ``stage_x``;
    ``smem_bytes`` a CTA.  "global": a warp a row, its lanes on 32 trees
    at a time, reading the records from device memory (children from
    ``links`` where ``links``)."""
    tier: str
    links: bool
    stage_x: bool
    cat_shared: bool
    threads: int
    trees_per_chunk: int
    chunks: int
    smem_bytes: int


def level_plan(rec: LevelRecords, n: int, f2: int, *, tier=None,
               chunk_bytes=None) -> LevelPlan:
    """Kernel C's plan for ``n`` rows of an (n, ``f2``) matrix.  Without
    ``tier``, a batch takes the shared tier where its trees fit shared
    memory and it has SHARED_TIER_MIN_ROWS rows (SHARED_TIER_MIN_ROWS_
    CHUNKED where the ensemble takes several chunks), else the global
    tier.  In the shared tier, an ensemble that fits one chunk beside a
    256-row tile within PREDICT_SMEM_PAIR takes CTAs of 256 threads (two
    an SM); any other, 512 (one an SM, as many warps, and each chunk's
    copy amortised over twice the rows).  ``chunk_bytes`` caps a chunk's
    shared bytes (records, meta, leaf values, category words; by default
    what the limit leaves beside the staged rows) and takes 512-thread
    CTAs; the kernel refuses a CTA past PREDICT_SMEM_LIMIT."""
    T, M, L, W = record_dims(rec)
    links = _uses_links(M, L)
    per_tree = M * 16 + 16 + L * 4
    cat_tree = M * W * 4
    fits = not links and per_tree <= PREDICT_SMEM_LIMIT
    if tier not in (None, "shared", "global"):
        raise ValueError(f"unknown tier {tier!r}")
    global_plan = LevelPlan("global", links, False, False, 0, T, 1, 0)
    if tier == "global" or (tier is None and not fits):
        return global_plan
    if not fits:
        raise ValueError("a tree's records do not fit shared memory (or "
                         "need flat child ids): use the global tier")
    row_bytes = ((f2 // 2) | 1) * 8          # a staged row: F | 1 pairs
    whole = T * (per_tree + (cat_tree if rec.has_cat else 0))
    threads = PREDICT_BLOCKS[0] if chunk_bytes is None and \
        whole + PREDICT_BLOCKS[0] * row_bytes <= PREDICT_SMEM_PAIR \
        else PREDICT_BLOCKS[1]
    x_bytes = threads * row_bytes
    stage_x = x_bytes + per_tree <= PREDICT_SMEM_LIMIT
    budget = chunk_bytes if chunk_bytes is not None else \
        PREDICT_SMEM_LIMIT - (x_bytes if stage_x else 0)
    cat_shared = rec.has_cat and per_tree + cat_tree <= budget
    per = per_tree + (cat_tree if cat_shared else 0)
    if budget < per:
        raise ValueError(f"chunk_bytes {budget} holds no tree ({per} "
                         "bytes)")
    tpc = min(T, budget // per)
    chunks = -(-T // tpc)
    if tier is None and n < (SHARED_TIER_MIN_ROWS if chunks == 1
                             else SHARED_TIER_MIN_ROWS_CHUNKED):
        return global_plan
    return LevelPlan("shared", False, stage_x, cat_shared, threads, tpc,
                     chunks,
                     tpc * per + (x_bytes if stage_x else 0))


def predict_level_ensemble(ens, X2: torch.Tensor, *, depth: int,
                           tier=None, chunk_bytes=None) -> torch.Tensor:
    """Ensemble level descent: (N, K) f32 raw scores of the interleaved
    (N, 2F) hi/lo matrix ``X2``.  ``ens`` is a LevelRecords, or a
    LevelEnsemble packed here (pack once and pass the records where an
    ensemble serves many calls).  Kernel C (csrc/predict_level.cu) on
    CUDA tensors, in the tier :func:`level_plan` picks (``tier`` and
    ``chunk_bytes`` as there); its plain version
    :func:`predict_level_records_plain` on CPU tensors.  Kernel C
    replaces the Pallas kernel in predict_level_ensemble_pallas
    (lightgbm_tpu/ops/predict.py:326).  Each row's class sum adds its
    trees in tree order from 0.0 whatever the tier, chunk or grid; the
    JAX function sums them by a matrix product
    (:func:`predict_level_ensemble_plain`), and the two agree to |d| <=
    1e-5 * (1 + |score|)."""
    if X2.dtype != torch.float32 or X2.dim() != 2 \
            or not X2.is_contiguous():
        raise ValueError("X2 must be a contiguous (N, 2F) float32 matrix")
    rec = ens if isinstance(ens, LevelRecords) else pack_level_records(ens)
    for name, dt in (("walk", torch.int32), ("links", torch.int32),
                     ("meta", torch.int32), ("leaves", torch.float32),
                     ("cats", torch.int32)):
        t = getattr(rec, name)
        if t.dtype != dt or not t.is_contiguous() or t.device != X2.device:
            raise ValueError(f"LevelRecords.{name}: expected contiguous "
                             f"{dt} on {X2.device}")
    n, f2 = X2.shape
    if rec.max_feat2 + 1 >= f2 and rec.max_feat2 >= 0:
        raise ValueError(f"X2 has {f2 // 2} features; the ensemble splits "
                         f"on feature {rec.max_feat2 // 2}")
    if X2.device.type == "cpu":
        return predict_level_records_plain(rec, X2, depth=depth)
    if X2.device.type != "cuda":
        raise ValueError(f"unsupported device {X2.device}")
    if X2.data_ptr() % 8:
        raise ValueError("X2 must be 8-byte aligned (its (hi, lo) pairs "
                         "are read as float2)")
    out = (torch.zeros if rec.empty_classes else torch.empty)(
        (n, rec.num_class), dtype=torch.float32, device=X2.device)
    if n == 0:
        return out
    plan = level_plan(rec, n, f2, tier=tier, chunk_bytes=chunk_bytes)
    sms = 0
    if plan.tier == "shared":
        from .histogram import _num_sms
        sms = _num_sms(X2.device.index or 0)
    kernels.launch(*level_launch_args(rec, plan, X2, out, depth, sms))
    return out


def level_launch_args(rec: LevelRecords, plan: LevelPlan, X2: torch.Tensor,
                      out: torch.Tensor, depth: int, sms: int) -> tuple:
    """(kernel name, its C entry point's arguments but the stream) of one
    launch of kernel C's tier ``plan.tier``; ``sms``: the card's SMs."""
    T, M, L, W = record_dims(rec)
    n, f2 = X2.shape
    if plan.tier == "shared":
        cat_mode = (1 if plan.cat_shared else 2) if rec.has_cat else 0
        return ("predict_level", rec.walk.data_ptr(), rec.meta.data_ptr(),
                rec.leaves.data_ptr(), rec.cats.data_ptr(), X2.data_ptr(),
                out.data_ptr(), n, f2 // 2, plan.threads,
                int(plan.stage_x), T, M, L, W, rec.num_class,
                plan.trees_per_chunk, int(depth), rec.leaf0, cat_mode,
                plan.smem_bytes, sms)
    return ("predict_level_global", rec.walk.data_ptr(), rec.links.data_ptr(),
            rec.meta.data_ptr(), rec.leaves.data_ptr(), rec.cats.data_ptr(),
            X2.data_ptr(), out.data_ptr(), n, f2, T, M, L, W, rec.num_class,
            int(depth), rec.leaf0, int(plan.links), int(rec.has_cat))


# ---------------------------------------------------------------------------
# the co-batched descent: several models' ensembles in one launch
# ---------------------------------------------------------------------------
def _stack_dims(s: LevelEnsemble):
    """(T, M, L, W, K) of a LevelEnsemble."""
    T = s.root.shape[0]
    TM = s.feat2.shape[0]
    return (T, TM // T, s.leaf_value.shape[0] // T, s.cat_words.shape[0] // TM,
            s.cls_onehot.shape[1])


def cobatch_level_ensembles(stacks: Sequence[LevelEnsemble]
                            ) -> Tuple[LevelEnsemble, tuple]:
    """Concatenate member ensembles along the tree axis into one
    LevelEnsemble (what the JAX package's serving co-batcher builds by
    flattening the members' trees together): M, L and W re-padded to the
    members' maximum, the flat child and root ids rebased into the
    re-padded spaces, and ``cls_onehot`` block-diagonal, member g's trees
    accumulating into columns ``[k0_g, k0_g + K_g)``.  Returns (the
    stack on the first member's device, ``segments``: one ``(tree
    offset, tree count, class offset, class count)`` a member)."""
    if not stacks:
        raise ValueError("cobatch_level_ensembles needs a member")
    dims = [_stack_dims(s) for s in stacks]
    M = max(d[1] for d in dims)
    L = max(d[2] for d in dims)
    W = max(d[3] for d in dims)
    K = sum(d[4] for d in dims)
    parts = {f: [] for f in LevelEnsemble._fields}
    segments = []
    t0 = k0 = 0
    for s, (T, Mg, Lg, Wg, Kg) in zip(stacks, dims):
        s = LevelEnsemble(*(x.detach().cpu() for x in s))

        def padded(a, shape, full):
            out = torch.zeros(full, dtype=a.dtype)
            out[tuple(slice(0, n) for n in shape)] = a.reshape(shape)
            return out.reshape(-1)

        def rebase(g):
            # flat ids of this member's spaces -> the co-batch's; the
            # tree of an id is read off the id itself
            g = g.long()
            lf = -g - 1
            return torch.where(
                g >= 0, (t0 + g // Mg) * M + g % Mg,
                -((t0 + lf // Lg) * L + lf % Lg) - 1).to(torch.int32)

        for f in ("feat2", "thr_hi", "thr_lo", "dtype_"):
            parts[f].append(padded(getattr(s, f), (T, Mg), (T, M)))
        for f in ("left", "right"):
            parts[f].append(padded(rebase(getattr(s, f)), (T, Mg), (T, M)))
        parts["leaf_value"].append(padded(s.leaf_value, (T, Lg), (T, L)))
        parts["cat_words"].append(padded(s.cat_words, (T, Mg, Wg),
                                         (T, M, W)))
        parts["root"].append(rebase(s.root))
        onehot = torch.zeros((T, K), dtype=torch.float32)
        onehot[:, k0:k0 + Kg] = s.cls_onehot
        parts["cls_onehot"].append(onehot)
        segments.append((t0, T, k0, Kg))
        t0 += T
        k0 += Kg
    dev = stacks[0].root.device
    return (LevelEnsemble(**{f: torch.cat(v).to(dev)
                             for f, v in parts.items()}), tuple(segments))


def predict_level_ensemble_cobatch(stacks, X2: torch.Tensor, *, depth: int,
                                   segments=None) -> torch.Tensor:
    """Co-batched level descent (lightgbm_tpu/ops/predict.py
    predict_level_ensemble_cobatch): several models scored on the same
    rows by ONE launch of kernel C with K = sum K_g, (N, sum K_g) f32,
    member g's raw scores in columns ``[k0_g, k0_g + K_g)``.  ``stacks``:
    the members' LevelEnsembles (concatenated here by
    :func:`cobatch_level_ensembles`), or their concatenation already
    made (a LevelEnsemble, or LevelRecords packed from it) with its
    ``segments``; ``depth``: the members' largest depth (a settled walk
    stays settled).  Kernel C adds each class's trees in tree order from
    0.0 whatever the tier, tree chunk or grid, and a member's trees keep
    their order, so each member's columns are its solo
    :func:`predict_level_ensemble` call bit for bit (the JAX package's
    byte-identity contract)."""
    if isinstance(stacks, (LevelEnsemble, LevelRecords)):
        if segments is None:
            raise ValueError("a concatenated ensemble needs its segments")
        ens = stacks
    else:
        ens, made = cobatch_level_ensembles(list(stacks))
        if segments is not None and tuple(map(tuple, segments)) != made:
            raise ValueError(f"segments {segments} do not match the "
                             f"members' {made}")
        segments = made
    T, K = (ens.meta.shape[0], ens.num_class) \
        if isinstance(ens, LevelRecords) else ens.cls_onehot.shape
    t_end = k_end = 0
    for t0, tn, k0, kn in segments:
        if t0 != t_end or k0 != k_end:
            raise ValueError(f"segments {segments} do not tile the trees "
                             "and classes in order")
        t_end, k_end = t0 + tn, k0 + kn
    if (t_end, k_end) != (T, K):
        raise ValueError(f"segments {segments} cover {t_end} trees and "
                         f"{k_end} classes of {T} and {K}")
    return predict_level_ensemble(ens, X2, depth=depth)


# ---------------------------------------------------------------------------
# the raw-feature per-tree scan (predict_kernel=scan)
# ---------------------------------------------------------------------------
class RawTreeStack(NamedTuple):
    """T host trees stacked into fixed-shape tensors for the raw-feature
    per-tree scan (lightgbm_tpu/ops/predict.py RawTreeStack), padded to
    the largest node, leaf and category-word counts; plus each tree's
    depth, known on the host, which bounds its walk."""
    num_leaves: torch.Tensor   # (T,) int32
    feature: torch.Tensor      # (T, M) int32 real feature index
    thr_hi: torch.Tensor       # (T, M) f32 threshold high part
    thr_lo: torch.Tensor       # (T, M) f32 threshold residual
    dtype_: torch.Tensor       # (T, M) int32 decision_type bitfield
    left: torch.Tensor         # (T, M) int32 (negative = ~leaf)
    right: torch.Tensor        # (T, M) int32
    leaf_value: torch.Tensor   # (T, L) f32
    cat_words: torch.Tensor    # (T, M, W) int32 per-node category bitset
    depth: tuple               # (T,) python ints: levels to settle a row


def stack_host_trees(models: List, device=None) -> RawTreeStack:
    """A host Tree list as one RawTreeStack on ``device`` (leaf values
    carry shrinkage and DART rescales already, as on the host)."""
    from ..tree import (ensemble_cat_width, split_threshold_parts,
                        tree_cat_words)
    T = len(models)
    M = max(max(t.num_leaves - 1 for t in models), 1)
    L = M + 1
    W = ensemble_cat_width(models)
    nl = np.zeros(T, np.int32)
    feat = np.zeros((T, M), np.int32)
    thr = np.zeros((T, M), np.float64)
    dt = np.zeros((T, M), np.int32)
    left = np.zeros((T, M), np.int32)
    right = np.zeros((T, M), np.int32)
    lv = np.zeros((T, L), np.float64)
    cw = np.zeros((T, M, W), np.uint32)
    for k, t in enumerate(models):
        m = t.num_leaves - 1
        nl[k] = t.num_leaves
        if m <= 0:
            lv[k, 0] = t.leaf_value[0] if len(t.leaf_value) else 0.0
            continue
        feat[k, :m] = t.split_feature[:m]
        thr[k, :m] = t.threshold[:m]
        dt[k, :m] = t.decision_type[:m]
        left[k, :m] = t.left_child[:m]
        right[k, :m] = t.right_child[:m]
        lv[k, :t.num_leaves] = t.leaf_value[:t.num_leaves]
        cw[k, :m] = tree_cat_words(t, W)
    hi, lo = split_threshold_parts(thr)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return RawTreeStack(
        num_leaves=dev(nl), feature=dev(feat), thr_hi=dev(hi),
        thr_lo=dev(lo), dtype_=dev(dt), left=dev(left), right=dev(right),
        leaf_value=dev(lv.astype(np.float32)),
        cat_words=dev(cw.view(np.int32)),
        depth=tuple(int(t.max_depth()) for t in models))


def slice_raw_stack(stack: RawTreeStack, count: int) -> RawTreeStack:
    """The first ``count`` trees of a RawTreeStack."""
    return RawTreeStack(*(x[:count] for x in stack[:-1]),
                        depth=stack.depth[:count])


def _walk_raw(stack: RawTreeStack, t: int, Xhi: torch.Tensor,
              Xlo: torch.Tensor) -> torch.Tensor:
    """Tree ``t`` of the stack over raw features: (N,) f32 leaf values
    (lightgbm_tpu/ops/predict.py _walk_raw, the device form of
    Tree.predict_leaf), by _goes_left's rule.  The walk runs the tree's
    host-known depth in levels; the JAX function loops until no row is
    left walking, which reads a flag back every level."""
    n = Xhi.shape[0]
    depth = stack.depth[t]
    W = stack.cat_words.shape[-1]
    cats = stack.cat_words[t].reshape(-1)
    node = torch.full((n,), 0 if depth > 0 else -1, dtype=torch.int32,
                      device=Xhi.device)
    for _ in range(depth):
        nid = node.clamp(min=0).long()
        feat = stack.feature[t][nid].long()[:, None]
        go_left = _goes_left(
            torch.gather(Xhi, 1, feat)[:, 0], torch.gather(Xlo, 1, feat)[:, 0],
            stack.dtype_[t][nid], stack.thr_hi[t][nid], stack.thr_lo[t][nid],
            lambda w: cats[nid * W + w], W)
        nxt = torch.where(go_left, stack.left[t][nid], stack.right[t][nid])
        node = torch.where(node >= 0, nxt, node)
    lv = stack.leaf_value[t]
    return lv[(-node - 1).clamp(0, lv.shape[0] - 1).long()]


def predict_raw_ensemble(stack: RawTreeStack, Xhi: torch.Tensor,
                         Xlo: torch.Tensor, cls: torch.Tensor,
                         k_total: torch.Tensor) -> torch.Tensor:
    """Every stacked tree over raw features, each tree's output added
    into its class row (lightgbm_tpu/ops/predict.py
    predict_raw_ensemble): ``cls`` (T,) the class of each tree,
    ``k_total`` the (K, N) starting scores.  Returns (K, N) f32 raw
    scores, each class's trees added in tree order as ``carry.at[c]
    .add`` adds them, so the result is the JAX function's bit for bit.
    Torch ops on either device: the JAX function is plain XLA."""
    out = k_total.to(torch.float32).expand(
        k_total.shape[0], Xhi.shape[0]).clone()
    for t, c in enumerate(cls.tolist()):
        out[c] = out[c] + _walk_raw(stack, t, Xhi, Xlo)
    return out


def predict_binned(tree: dict, bins: torch.Tensor, f_group: torch.Tensor,
                   g2f_lut: torch.Tensor, f_missing: torch.Tensor,
                   f_default_bin: torch.Tensor, f_num_bin: torch.Tensor,
                   packed_groups: int = 0) -> torch.Tensor:
    """Evaluate one grown tree (bin-space TreeArrays dict of tensors) on
    a binned (N, G) uint8 matrix, or under the pack spec
    ``packed_groups`` its (N, cols) sub-byte storage (each row's chosen
    storage byte gathered and widened, lightgbm_tpu/ops/predict.py
    :100-107); returns (N,) f32 leaf values (unshrunk).  Plain torch:
    the walk is depth-synchronous and ends when every row has
    settled."""
    n = bins.shape[0]
    b_dim = tree["node_cat_mask"].shape[1]
    cat_flat = tree["node_cat_mask"].reshape(-1)
    num_leaves = int(tree["num_leaves"])
    node = torch.zeros(n, dtype=torch.int32, device=bins.device) \
        if num_leaves > 1 else \
        torch.full((n,), -1, dtype=torch.int32, device=bins.device)
    while bool((node >= 0).any()):
        is_internal = node >= 0
        nid = node.clamp(min=0).long()
        feat = tree["node_feature"][nid].long()
        grp = f_group[feat]
        if packed_groups:
            byte_idx, shift, mask = packed_select_params(
                grp.to(torch.int32), packed_groups)
            byte = torch.gather(bins, 1, byte_idx.long()[:, None])[:, 0]
            gb = ((byte.to(torch.int32) >> shift) & mask).long()
        else:
            gb = torch.gather(bins, 1, grp.long()[:, None])[:, 0].long()
        fb = g2f_lut[feat, gb]
        thr = tree["node_threshold"][nid]
        dleft = tree["node_default_left"][nid]
        mtype = f_missing[feat]
        is_nan_bin = fb == (f_num_bin[feat] - 1)
        is_def_bin = fb == f_default_bin[feat]
        cmp_left = fb <= thr
        num_left = torch.where(
            (mtype == MISSING_NAN) & is_nan_bin, dleft,
            torch.where((mtype == MISSING_ZERO) & is_def_bin, dleft,
                        cmp_left))
        cat_left = cat_flat[nid * b_dim + fb.clamp(0, b_dim - 1).long()]
        go_left = torch.where(tree["node_is_cat"][nid], cat_left, num_left)
        nxt = torch.where(go_left, tree["node_left"][nid],
                          tree["node_right"][nid])
        node = torch.where(is_internal, nxt, node)
    leaf = (-node - 1).clamp(0, tree["leaf_value"].shape[0] - 1).long()
    return tree["leaf_value"][leaf]
