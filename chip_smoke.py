#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one CUDA card.

    python3 chip_smoke.py              # on a machine with one H100
    python3 chip_smoke.py --rehearse   # CPU rehearsal at a tiny size

Phases, in order; any failure exits nonzero:
  1. print the card (nvidia-smi name and power limit) and build the
     CUDA kernels from lightgbm_tpu_torch/csrc, one nvcc per source;
  2. hold each kernel against its plain PyTorch version on the card at
     the bench shapes (1,000,000 rows, 28 groups, 63 bins, 255 leaves,
     frontier widths 42/84/126 and a width above 126, NaN /
     zero-default / categorical route rows, and a tree's first round:
     every row in one slot).  Integer outputs (leaf ids, int32
     histograms, the count channel) bit for bit; the f32 channels of
     the float-weight histograms (D, E, F) within one f32 ulp of the
     bin's absolute sum (both sides add the same bf16 values in f64 and
     round once), with the count of bins that differ between two
     launches on one input; the ensemble predict kernel within
     |d| <= 1e-5 * (1 + |score|).  Each kernel is timed (median of
     CUDA-event timed launches) beside its bound, its plain version's
     time and, for the histograms of f32 weights, one torch.matmul that
     computes the same histogram;
  3. train through lgb.train at the bench shape (1,000,000 x 28
     synthetic binary task, 255 leaves, max_bin 63) on the card, each
     run with the launch counters zeroed just before it and read just
     after: 10 trees with quantized int8 gradients (kernels A, B), 10
     trees with f32 gradients (the fused_streamed plan, kernel D), 3
     trees of the pre_onehot plan (kernel E's pre_packed entry point),
     3 more without its strip ladder (the pre entry point) and 3 of the
     pallas plan (kernel F);
  4. predict held-out rows through Booster.predict on the card (kernel
     C, counted with the quantized run), compare with the plain-version
     predict, and check the AUC;
then print one JSON line with every kernel's numbers and, last, the
result line.  Without a CUDA device (or with --rehearse, which runs the
same phases on the CPU at a tiny size with the plain versions) it
prints no result and exits nonzero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

MEM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
TOL_PREDICT = 1e-5               # |d| <= TOL * (1 + |score|)
F32_ULP = 2.0 ** -23             # f32 channels: |d| <= F32_ULP * S
#: the bench configuration (bench.py rows 77-84) on the port's device
BENCH_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
                "learning_rate": 0.1, "min_sum_hessian_in_leaf": 100,
                "min_data_in_leaf": 1, "quantized_grad": True,
                "hist_compute_dtype": "bfloat16", "verbose": 0}


def make_data(n, f, seed=7, w=None):
    """Synthetic binary task (the bench's generator): a sparse linear
    concept plus one interaction, logistic label noise."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    if w is None:
        w = rng.randn(f) * (rng.rand(f) > 0.3)
    logit = X[:, :f] @ w + 0.5 * np.sin(3 * X[:, 0]) * X[:, 1]
    y = (logit + rng.logistic(size=n) > 0).astype(np.float32)
    return X.astype(np.float64), y, w


def auc_score(y, s):
    """Tie-aware AUC (rank-sum formulation)."""
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), np.float64)
    ss = s[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and ss[j + 1] == ss[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    pos = y > 0
    npos, nneg = pos.sum(), (~pos).sum()
    return float((ranks[pos].sum() - npos * (npos + 1) / 2) / (npos * nneg))


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, dev, reps: int) -> float:
    """Median per-call milliseconds of ``fn`` over ``reps`` calls, each
    bracketed by CUDA events (wall clock on the CPU)."""
    import torch
    fn()                                           # warm-up
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 2 inputs
# ---------------------------------------------------------------------------
def random_route_table(rng, L, G, B, cat_frac=0.2):
    """A pending route table over L leaves: half of them split, with a
    mix of missing types (none / zero / NaN), default directions,
    categorical left-sets and right slots numbered after the leaves."""
    import torch
    from lightgbm_tpu_torch.ops.partition import build_route_table

    active = rng.rand(L) < 0.5
    nsplit = int(active.sum())
    rs = np.zeros(L, np.int32)
    rs[active] = np.arange(L, L + nsplit)
    nb = np.full(L, B, np.int32)
    cols = dict(
        split_mask=active, feat_group=rng.randint(0, G, L),
        fb_lo=np.zeros(L), fb_hi=np.full(L, B), fb_shift=np.zeros(L),
        fb_oor=nb - 1, is_cat=rng.rand(L) < cat_frac,
        threshold=rng.randint(0, B - 1, L),
        default_left=rng.rand(L) < 0.5, missing_type=rng.randint(0, 3, L),
        default_bin=rng.randint(0, B, L), num_bin=nb,
        cat_mask=rng.rand(L, B) < 0.5, right_slot=rs)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in cols.items()}
    return build_route_table(**t)


def random_trees(rng, T, depth, F, cat_features):
    """T random complete trees (plus one stump) with NaN / zero missing
    types, +-inf thresholds and categorical bitset nodes."""
    from lightgbm_tpu_torch.tree import Tree, _construct_bitset
    trees = []
    for k in range(T):
        if k == T - 1:
            t = Tree(1)
            t.leaf_value[0] = rng.randn()
            trees.append(t)
            continue
        m = 2 ** depth - 1
        t = Tree(m + 1)
        for i in range(m):
            f = int(rng.randint(0, F))
            t.split_feature[i] = f
            lc, rc = 2 * i + 1, 2 * i + 2
            t.left_child[i] = lc if lc < m else -(lc - m) - 1
            t.right_child[i] = rc if rc < m else -(rc - m) - 1
            if f in cat_features and rng.rand() < 0.7:
                words = _construct_bitset(
                    sorted(set(rng.randint(0, 40, 6).tolist())))
                t.threshold[i] = t.num_cat
                t.num_cat += 1
                t.cat_boundaries.append(t.cat_boundaries[-1] + len(words))
                t.cat_threshold.extend(words)
                t.decision_type[i] = 1
            else:
                t.threshold[i] = (np.inf if rng.rand() < 0.05 else
                                  -np.inf if rng.rand() < 0.05 else
                                  float(rng.randn()))
                t.decision_type[i] = ((2 if rng.rand() < 0.5 else 0)
                                      | (int(rng.randint(0, 3)) << 2))
        t.leaf_value = rng.randn(m + 1) * 0.1
        trees.append(t)
    return trees


def split_rows(leaf, table) -> int:
    """Rows whose pre-route leaf splits: the only rows whose bin the
    routing reads (csrc/route.cuh returns before the load otherwise)."""
    L = table.shape[0]
    ok = (leaf >= 0) & (leaf < L)
    return int((ok & (table[leaf.clamp(0, L - 1).long(), 10] > 0.5)).sum())


def check_kernels(dev, n, rehearse, card):
    """Phase 2: every kernel against its plain version.  Returns
    {kernel: numbers}."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import predict as P
    from lightgbm_tpu_torch.tree import flatten_ensemble

    rng = np.random.RandomState(11)
    G, B, L = 28, 63, 255
    reps = 3 if rehearse else 20
    out = {}
    binsT = torch.from_numpy(rng.randint(0, B, (G, n)).astype(np.uint8)).to(dev)
    leaf = rng.randint(0, L, n).astype(np.int32)
    leaf[rng.rand(n) < 0.01] = -1                       # padded rows
    leaf = torch.from_numpy(leaf).to(dev)
    grad = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    hess = torch.from_numpy(rng.rand(n).astype(np.float32) * 0.25).to(dev)
    counts = (leaf >= 0).to(torch.float32)
    wq, scales = H.quantize_gradients(grad * counts, hess * counts, counts)
    wT = wq.t().contiguous()
    table = random_route_table(rng, L, G, B).to(dev)

    # ---- kernel A at each frontier width of the JAX lane ladder, then
    # on a tree's first round: every row in the root, nothing to route,
    # one slot (the worst case for the histogram atomics)
    first = (torch.where(leaf >= 0, 0, -1).to(torch.int32),
             torch.zeros_like(table), torch.zeros(1, dtype=torch.int32,
                                                  device=dev))
    for W in (42, 84, 126, "first round"):
        if W == "first round":
            lf, tb, slots = first
        else:
            lf, tb = leaf, table
            slots = torch.from_numpy(rng.permutation(2 * L)[:W].astype(
                np.int32)).to(dev)
        h_k, l_k = H.fused_route_hist(binsT, wT, lf, tb, slots, B)
        h_p, l_p = H.fused_route_hist_plain(binsT, wT, lf, tb, slots, B)
        if not (torch.equal(h_k, h_p) and torch.equal(l_k, l_p)):
            raise AssertionError(f"fused_route_hist W={W}: kernel != plain "
                                 f"(hist max |d| "
                                 f"{(h_k - h_p).abs().max().item()})")
        if W not in (126, "first round"):
            continue
        ms = time_ms(lambda: H.fused_route_hist(
            binsT, wT, lf, tb, slots, B), dev, reps)
        plain = time_ms(lambda: H.fused_route_hist_plain(
            binsT, wT, lf, tb, slots, B), dev, 3)
        n_hit = int(((l_p[:, None] == slots[None, :]).any(1)
                     & (l_p >= 0)).sum())
        # leaf ids in and out for every row, the chosen group's bin for
        # rows of splitting leaves, all G bins and 12 weight bytes for
        # rows that land in a slot, the table, the histogram
        nbytes = (8 * n + split_rows(lf, tb) + n_hit * (G + 12)
                  + tb.numel() * 4 + h_k.numel() * 4)
        bound = nbytes / MEM_BYTES_PER_S * 1e3
        label = "first round (W=1)" if W == "first round" else f"W={W}"
        print(f"[phase 2] fused_route_hist {label}: {ms:.4f} ms "
              f"(bound {bound:.4f} ms, bytes; plain {plain:.3f} ms;"
              f" {n_hit} of {n} rows in slots; {card})")
        if W == 126:
            out["fused_route_hist"] = dict(max_abs_err=0, ms=ms,
                                           plain_ms=plain, bound_ms=bound)
        else:
            out["fused_route_hist"].update(ms_first_round=ms,
                                           plain_ms_first_round=plain,
                                           bound_ms_first_round=bound)

    # ---- kernel B
    values = torch.from_numpy(rng.randn(L).astype(np.float32)).to(dev)
    lk, vk = H.route_apply_tiled(binsT, leaf, table, values)
    lp, vp = H.route_apply_plain(binsT, leaf, table, values)
    if not (torch.equal(lk, lp) and torch.equal(
            vk.view(torch.int32), vp.view(torch.int32))):
        raise AssertionError("route_apply: kernel != plain")
    b_ms = time_ms(lambda: H.route_apply_tiled(binsT, leaf, table, values),
                   dev, reps)
    b_plain = time_ms(lambda: H.route_apply_plain(binsT, leaf, table,
                                                  values), dev, 3)
    b_bound = ((12 * n + split_rows(leaf, table)
                + (table.numel() + 6 * L) * 4)
               / MEM_BYTES_PER_S * 1e3)
    print(f"[phase 2] route_apply: {b_ms:.4f} ms (bound {b_bound:.4f} ms, "
          f"bytes; plain {b_plain:.3f} ms; {card})")
    out["route_apply"] = dict(max_abs_err=0.0, ms=b_ms, plain_ms=b_plain,
                              bound_ms=b_bound)

    # ---- kernel C on random ensembles with NaN / zero / categorical
    F = 28
    cats = {3, 7}
    trees = random_trees(rng, 10, 8, F, cats)
    flat = flatten_ensemble(trees, 1)
    depth = int(flat.pop("depth"))
    stack = P.level_ensemble_from_numpy(flat, dev)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.05] = np.nan
    X[rng.rand(n, F) < 0.05] = 0.0
    for c in cats:
        X[:, c] = rng.randint(-1, 45, n)
    x2 = torch.from_numpy(P.interleave_hi_lo(X)).to(dev)
    c_err = compare_predict(stack, x2, depth)
    c_ms = time_ms(lambda: P.predict_level_ensemble(stack, x2, depth=depth),
                   dev, reps)
    c_plain = time_ms(lambda: P.predict_level_ensemble_plain(
        stack, x2, depth=depth), dev, 3)
    print(f"[phase 2] predict_level (synthetic, 10 trees, depth {depth}): "
          f"{c_ms:.4f} ms (plain {c_plain:.3f} ms, max |d| {c_err:.3g}; "
          f"{card})")
    return out


def compare_predict(stack, x2, depth) -> float:
    """Kernel C against its plain version; returns max |d|."""
    from lightgbm_tpu_torch.ops import predict as P
    got = P.predict_level_ensemble(stack, x2, depth=depth)
    want = P.predict_level_ensemble_plain(stack, x2, depth=depth)
    d = (got - want).abs()
    if not bool((d <= TOL_PREDICT * (1 + want.abs())).all()):
        raise AssertionError(f"predict_level: kernel != plain (max |d| "
                             f"{d.max().item()})")
    return float(d.max())


# ---------------------------------------------------------------------------
# phase 2, kernels D, E and F (f32 or int8 weights, streamed one-hot or
# row-major bins)
# ---------------------------------------------------------------------------
def hist_bound(n_rows_read, n_hit, row_bytes, hist, n_adds):
    """(bound ms, "bytes" | "operations"): ``n_rows_read`` bytes read
    for every row, ``row_bytes`` more for each of the ``n_hit`` rows in
    a slot, the f32 histogram written once; ``n_adds`` f32 adds at the
    card's f32 rate."""
    nbytes = n_rows_read + n_hit * row_bytes + hist.numel() * 4
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_adds / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hold_hist(name, got, want, S) -> float:
    """A histogram kernel against its plain version: int32 bit for bit;
    f32 with the count channel exact and grad/hess within F32_ULP * S.
    Returns max |d|."""
    import torch
    if got.dtype == torch.int32:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain (int32)")
        return 0.0
    d = (got - want).abs()
    if not torch.equal(got[..., 2], want[..., 2]):
        raise AssertionError(f"{name}: count channel differs")
    if not bool((d <= F32_ULP * S).all()):
        raise AssertionError(f"{name}: kernel != plain beyond one f32 ulp "
                             f"of the absolute sum (max |d| "
                             f"{d.max().item()})")
    return float(d.max())


def unstable_bins(fn) -> int:
    """Bins whose bits differ between two launches on one input."""
    import torch
    a, b = fn(), fn()
    a = a[0] if isinstance(a, tuple) else a
    b = b[0] if isinstance(b, tuple) else b
    diff = a.contiguous().view(torch.int32) != b.contiguous().view(
        torch.int32)
    return int(diff.any(dim=-1).sum())


def library_ms(leaf, slots, wT, oh_bf16, dev, reps):
    """One torch call computing the same histogram: the slot-masked
    (3W, N) bf16 weight matrix times the pack-1 (N, G*B) bf16 one-hot,
    f32 out (torch.mm's out_dtype, which torch has on CUDA only; the CPU
    rehearsal times the bf16-out product).  Timed here only; the port
    never calls it."""
    import torch
    W = slots.shape[0]
    m = (leaf[None, :] == slots[:, None]) & (slots[:, None] >= 0)
    lhs = (m[None] * wT[:, None, :]).reshape(3 * W, -1).to(torch.bfloat16)
    kw = {"out_dtype": torch.float32} if dev.type == "cuda" else {}
    ms = time_ms(lambda: torch.mm(lhs, oh_bf16, **kw), dev, reps)
    del lhs
    return ms


def check_float_kernels(dev, n, rehearse, card):
    """Phase 2 for kernels D, E (pre_packed, pre) and F against their
    plain versions.  Returns {kernel: numbers}."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    rng = np.random.RandomState(13)
    G, B, L = 28, 63, 255
    reps = 3 if rehearse else 20
    binsT = torch.from_numpy(rng.randint(0, B, (G, n)).astype(np.uint8)).to(dev)
    bins = binsT.t().contiguous()
    leaf = rng.randint(0, L, n).astype(np.int32)
    leaf[rng.rand(n) < 0.01] = -1                       # padded rows
    leaf = torch.from_numpy(leaf).to(dev)
    counts = (leaf >= 0).to(torch.float32)
    grad = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev) * counts
    hess = torch.from_numpy(rng.rand(n).astype(np.float32) * 0.25).to(
        dev) * counts
    wT = torch.stack([grad, hess, counts]).contiguous()         # (3, N)
    w = wT.t().contiguous()                                     # (N, 3)
    wq, _ = H.quantize_gradients(grad, hess, counts)
    wqT = wq.t().contiguous()
    table = random_route_table(rng, L, G, B).to(dev)
    t0 = time.perf_counter()
    ohb = {1: H.precompute_bin_onehot(bins, max_group_bin=B),
           4: H.precompute_bin_onehot_packed(bins, max_group_bin=B, pack=4)}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"[phase 2] one-hots built in {time.perf_counter() - t0:.2f} s "
          f"(pack 1: {ohb[1].shape[1]} B/row, pack 4: {ohb[4].shape[1]} "
          "B/row)")
    oh_bf16 = ohb[1].to(torch.bfloat16)
    root = torch.where(leaf >= 0, 0, -1).to(torch.int32)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    out = {}

    def slots_of(W, span):
        return torch.from_numpy(rng.permutation(span)[:W].astype(
            np.int32)).to(dev)

    def n_hit(lf, slots):
        return int(torch.isin(lf, slots[slots >= 0]).sum())

    def record(name, label, ms, plain, bound, by, lib, err, unstable,
               hit, main):
        print(f"[phase 2] {name} {label}: {ms:.4f} ms (bound {bound:.4f} "
              f"ms, {by}; plain {plain:.3f} ms; library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}; max |d| "
              f"{err:.3g}; {unstable} bins differ between two launches; "
              f"{hit} of {n} rows in slots; {card})")
        if main:
            out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=bound, bound_by=by, library_ms=lib,
                             unstable_bins=unstable)
        else:
            tag = label.replace(" (W=1)", "").replace(" ", "_").replace(
                "=", "")
            out[name].update({f"ms_{tag}": ms, f"plain_ms_{tag}": plain,
                              f"bound_ms_{tag}": bound,
                              f"library_ms_{tag}": lib})

    # ---- kernel D: pack 4 (the bench's auto pack) and pack 1, f32 and
    # int8 weights, the lane-ladder widths and the first round
    for pack, wname, W in [(4, "f32", 42), (4, "f32", 84), (4, "f32", 126),
                           (4, "f32", 0), (4, "int8", 126), (4, "int8", 0),
                           (1, "f32", 126), (1, "f32", 0), (1, "int8", 42)]:
        first = W == 0
        lf, tb = (root, torch.zeros_like(table)) if first else (leaf, table)
        slots = one if first else slots_of(W, 2 * L)
        ww = wT if wname == "f32" else wqT
        kw = dict(max_group_bin=B, pack=pack, num_groups=G)

        def run(lf=lf, tb=tb, slots=slots, ww=ww, kw=kw, pack=pack):
            return H.fused_onehot_hist(ohb[pack], binsT, ww, lf, tb, slots,
                                       **kw)
        h_k, l_k = run()
        h_p, l_p = H.fused_onehot_hist_plain(ohb[pack], binsT, ww, lf, tb,
                                             slots, **kw)
        label = (f"pack {pack} {wname} "
                 + ("first round (W=1)" if first else f"W={W}"))
        if not torch.equal(l_k, l_p):
            raise AssertionError(f"fused_onehot_hist {label}: leaf ids "
                                 "differ")
        S = None if wname == "int8" else H.onehot_hist_plain(
            ohb[pack], wT.t().abs(), l_p, slots, **kw)
        err = hold_hist(f"fused_onehot_hist {label}", h_k, h_p, S)
        if not ((pack, wname) == (4, "f32") and W in (126, 0)
                or (pack, wname, W) in ((1, "f32", 126), (4, "int8", 126))):
            continue
        ms = time_ms(run, dev, reps)
        plain = time_ms(lambda: H.fused_onehot_hist_plain(
            ohb[pack], binsT, ww, lf, tb, slots, **kw), dev, 3)
        hit = n_hit(l_p, slots)
        # a row in a slot needs its weights and the G*B/pack one-hot
        # bytes that hold columns (not the planes' zero padding)
        bound, by = hist_bound(8 * n + split_rows(lf, tb) + tb.numel() * 4,
                               hit, 12 + G * B // pack, h_k, hit * G * 3)
        lib = library_ms(l_p, slots, wT, oh_bf16, dev, reps) \
            if wname == "f32" else None
        record("fused_onehot_hist", "main" if W == 126 and pack == 4
               and wname == "f32" else label, ms, plain, bound, by, lib,
               err, unstable_bins(run), hit,
               W == 126 and pack == 4 and wname == "f32")

    # ---- kernel E: pre_packed up to 126 slots, pre above; final leaf ids
    for entry, wname, W in [("hist_pre_packed", "f32", 42),
                            ("hist_pre_packed", "f32", 84),
                            ("hist_pre_packed", "f32", 126),
                            ("hist_pre_packed", "f32", 0),
                            ("hist_pre_packed", "int8", 126),
                            ("hist_pre", "f32", L), ("hist_pre", "int8", L),
                            ("hist_pre", "f32", 0)]:
        first = W == 0
        lf = root if first else leaf
        slots = one if first else (
            torch.arange(L, dtype=torch.int32, device=dev) if W == L
            else slots_of(W, L))
        ww = w if wname == "f32" else wq
        kw = dict(max_group_bin=B, pack=4, num_groups=G)
        fn = getattr(H, entry)

        def run(fn=fn, lf=lf, slots=slots, ww=ww, kw=kw):
            return fn(ohb[4], ww, lf, slots, **kw)
        h_k = run()
        h_p = getattr(H, entry + "_plain")(ohb[4], ww, lf, slots, **kw)
        label = f"{wname} " + ("first round (W=1)" if first else f"W={W}")
        S = None if wname == "int8" else H.onehot_hist_plain(
            ohb[4], w.abs(), lf, slots, **kw)
        err = hold_hist(f"{entry} {label}", h_k, h_p, S)
        main = wname == "f32" and W in (126, L)
        if not (main or (wname == "f32" and first)):
            continue
        ms = time_ms(run, dev, reps)
        plain = time_ms(lambda: getattr(H, entry + "_plain")(
            ohb[4], ww, lf, slots, **kw), dev, 3)
        hit = n_hit(lf, slots)
        bound, by = hist_bound(4 * n, hit, 12 + G * B // 4, h_k,
                               hit * G * 3)
        lib = library_ms(lf, slots, wT, oh_bf16, dev, reps)
        record(entry, "main" if main else label, ms, plain, bound, by, lib,
               err, unstable_bins(run), hit, main)

    # ---- kernel F: row-major bins, f32 weights
    for W in (42, 84, 126, 0):
        first = W == 0
        lf = root if first else leaf
        slots = one if first else slots_of(W, L)

        def run(lf=lf, slots=slots):
            return H.bins_hist(bins, w, lf, slots, B)
        h_k = run()
        h_p = H.bins_hist_plain(bins, w, lf, slots, B)
        label = "first round (W=1)" if first else f"W={W}"
        S = H.bins_hist_plain(bins, w.abs(), lf, slots, B)
        err = hold_hist(f"bins_hist {label}", h_k, h_p, S)
        if W not in (126, 0):
            continue
        ms = time_ms(run, dev, reps)
        plain = time_ms(lambda: H.bins_hist_plain(bins, w, lf, slots, B),
                        dev, 3)
        hit = n_hit(lf, slots)
        bound, by = hist_bound(4 * n, hit, 12 + G, h_k, hit * G * 3)
        # the library call reads the pack-1 one-hot, which F never reads
        lib = library_ms(lf, slots, wT, oh_bf16, dev, reps)
        record("bins_hist", "main" if W == 126 else label, ms, plain, bound,
               by, lib, err, unstable_bins(run), hit, W == 126)
    del oh_bf16, ohb
    return out


def train_plan(lgb, kernels, params, train_ds, valid_ds, rounds, dev,
               card, label):
    """Phase 3: one lgb.train run with the launch counters zeroed just
    before it.  Returns (booster, held-out AUC of the last round,
    launches during the run)."""
    import torch
    evals = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    bst = lgb.train(params, train_ds, rounds, valid_sets=[valid_ds],
                    valid_names=["valid"], evals_result=evals,
                    verbose_eval=False)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    auc = evals["valid"]["auc"][-1]
    print(f"[phase 3] {label}: trained {bst.num_trees()} trees in "
          f"{train_s:.2f} s: {1e3 * train_s / rounds:.1f} ms/tree (wall of "
          f"lgb.train / rounds, card {card}); held-out AUC {auc:.4f}; "
          f"launches {launches}")
    return bst, auc, dict(kernels.LAUNCHES)


def main(argv) -> int:
    rehearse = "--rehearse" in argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    try:
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch.ops import kernels
        from lightgbm_tpu_torch.ops import predict as P
    except ImportError as e:
        print(f"chip_smoke: lightgbm_tpu_torch not importable ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    dev = torch.device("cpu" if rehearse else "cuda")
    n_rows, n_valid = (4096, 2048) if rehearse else (1_000_000, 200_000)

    # ---- phase 1: the card and the kernel build
    card = "cpu rehearsal" if rehearse else card_line()
    print(f"[phase 1] card: {card}")
    if not rehearse:
        t0 = time.perf_counter()
        kernels.build_kernels()
        print(f"[phase 1] kernels built in {time.perf_counter() - t0:.1f} s")
        for name, log in kernels.BUILD_LOG.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[phase 1] {name}: {line.strip()}")

    # ---- phase 2: kernels against their plain versions
    numbers = check_kernels(dev, n_rows, rehearse, card)
    numbers.update(check_float_kernels(dev, n_rows, rehearse, card))
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- phase 3: train through lgb.train on the card
    X, y, w = make_data(n_rows, 28, seed=7)
    Xv, yv, _ = make_data(n_valid, 28, seed=8, w=w)
    params = dict(BENCH_PARAMS, metric=["auc"], device=dev.type)
    cfg = lgb.Config.from_params(params)
    t0 = time.perf_counter()
    train_ds = lgb.Dataset(X, label=y)
    train_ds.construct(cfg)
    valid_ds = lgb.Dataset(Xv, label=yv, reference=train_ds)
    print(f"[phase 3] binned {n_rows} x 28 in "
          f"{time.perf_counter() - t0:.1f} s")
    # the float-gradient plans: the default (fused_streamed), the
    # streamed one-hot without the fused route (pre_onehot: its strip
    # ladder takes the pre_packed entry point for every round of a
    # 126-wide frontier, and the pre entry point without the ladder),
    # and no one-hot budget (pallas)
    fparams = dict(params, quantized_grad=False)
    plan_runs = {}          # kernel -> {run label: launches in that run}
    # (10 trees must reach a held-out AUC above 0.8; 3 trees above 0.75)
    for label, extra, rounds, want in [
            ("f32 fused_streamed", {}, 10,
             ("fused_onehot_hist", "route_apply")),
            ("f32 pre_onehot", {"hist_fused_route": False}, 3,
             ("hist_pre_packed",)),
            ("f32 pre_onehot without the strip ladder",
             {"hist_fused_route": False, "hist_packed_dispatch": False}, 3,
             ("hist_pre",)),
            ("f32 pallas", {"hist_onehot_budget_mb": 0}, 3,
             ("bins_hist",))]:
        _, f_auc, f_launches = train_plan(
            lgb, kernels, dict(fparams, **extra), train_ds, valid_ds,
            rounds, dev, card, label)
        floor = 0.8 if rounds >= 10 else 0.75
        if f_auc <= floor:
            raise AssertionError(f"{label}: held-out AUC {f_auc:.4f} is "
                                 f"not above {floor}")
        for name in want:
            if not rehearse and f_launches[name] <= 0:
                raise AssertionError(f"{label} did not launch {name}")
        for name, count in f_launches.items():
            if count:
                plan_runs.setdefault(name, {})[label] = count
    # the quantized main path last, so Booster.predict below counts
    # into the same window (kernels A, B, then C)
    bst, valid_auc, q_launches = train_plan(lgb, kernels, params, train_ds,
                                            valid_ds, 10, dev, card,
                                            "int8 fused_tiled")
    for name, count in q_launches.items():
        if count:
            plan_runs.setdefault(name, {})["int8 fused_tiled"] = count

    # ---- phase 4: predict through Booster.predict on the card
    t0 = time.perf_counter()
    prob = bst.predict(Xv)
    predict_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    auc = auc_score(yv, prob)
    print(f"[phase 4] predicted {n_valid} rows in {predict_s * 1e3:.1f} ms;"
          f" AUC {auc:.4f}; launches {launches}; {card}")
    pred = bst._predictor[1]
    x2 = torch.from_numpy(P.interleave_hi_lo(Xv)).to(dev)
    c_err = compare_predict(pred.stack, x2, pred.depth)
    reps = 3 if rehearse else 20
    c_ms = time_ms(lambda: P.predict_level_ensemble(
        pred.stack, x2, depth=pred.depth), dev, reps)
    c_plain = time_ms(lambda: P.predict_level_ensemble_plain(
        pred.stack, x2, depth=pred.depth), dev, 3)
    K = 1
    c_bound = (x2.numel() * 4 + n_valid * K * 4
               + sum(t.numel() * t.element_size() for t in pred.stack)
               ) / MEM_BYTES_PER_S * 1e3
    print(f"[phase 4] predict_level ({bst.num_trees()} trees, depth "
          f"{pred.depth}): {c_ms:.4f} ms (bound {c_bound:.4f} ms, bytes; "
          f"plain {c_plain:.3f} ms; max |d| {c_err:.3g}; {card})")
    numbers["predict_level"] = dict(max_abs_err=c_err, ms=c_ms,
                                    plain_ms=c_plain, bound_ms=c_bound)
    host = np.zeros(n_valid)
    for t in bst.models:
        host += t.predict(Xv)
    raw = bst.predict(Xv, raw_score=True)
    if np.abs(raw - host).max() > TOL_PREDICT * (1 + np.abs(host).max()):
        raise AssertionError("device predict disagrees with the host walk")

    if not rehearse:
        for name in ("fused_route_hist", "route_apply"):
            if launches[name] <= 0:
                raise AssertionError(f"training did not launch {name}")
        if launches["predict_level"] <= 0:
            raise AssertionError("Booster.predict did not launch "
                                 "predict_level")
    if not (np.isfinite(prob).all() and prob.shape == (n_valid,)):
        raise AssertionError("predictions are not finite or wrong shape")
    if auc <= 0.8 or valid_auc <= 0.8:
        raise AssertionError(f"held-out AUC {auc:.4f} / {valid_auc:.4f} "
                             "is not above 0.8")
    if rehearse:
        print("chip_smoke: rehearsal finished on the CPU; no result")
        return 3

    replaces = {
        "fused_route_hist": ("lightgbm_tpu_torch/csrc/fused_route_hist.cu",
                             "lightgbm_tpu/ops/histogram.py:1412"),
        "route_apply": ("lightgbm_tpu_torch/csrc/route_apply.cu",
                        "lightgbm_tpu/ops/histogram.py:1632"),
        "predict_level": ("lightgbm_tpu_torch/csrc/predict_level.cu",
                          "lightgbm_tpu/ops/predict.py:326"),
    }
    onehot = "lightgbm_tpu_torch/csrc/onehot_hist.cu"
    replaces.update({
        "fused_onehot_hist": (onehot, "lightgbm_tpu/ops/histogram.py:1272"),
        "hist_pre_packed": (onehot, "lightgbm_tpu/ops/histogram.py:769"),
        "hist_pre": (onehot, "lightgbm_tpu/ops/histogram.py:727"),
        "bins_hist": ("lightgbm_tpu_torch/csrc/bins_hist.cu",
                      "lightgbm_tpu/ops/histogram.py:224"),
    })
    rows = []
    for name, (src, rep) in replaces.items():
        # launches: the quantized main path's window (A, B, C), else
        # the one float run that drives the kernel; launches_by_run
        # lists every phase-3 run that launched it.  Numbers beyond the
        # contract's keys (first-round and other timings, unstable
        # bins) follow them in the same object
        runs = plan_runs.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep,
                     "launches": launches[name] or sum(runs.values()),
                     "launches_by_run": runs,
                     "bound_by": "bytes", "library_ms": None,
                     **numbers[name]})
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
