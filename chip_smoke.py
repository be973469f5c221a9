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
     the float-weight histograms (D, E, F, K) within one f32 ulp of the
     bin's absolute sum (both sides add the same bf16 values in f64 and
     round once), with the count of bins that differ between two
     launches on one input; the ensemble predict kernel C in both its
     tiers (records in shared memory; a warp a row from device memory)
     within |d| <= 1e-5 * (1 + |score|) and the two tiers bit for bit,
     on 10 random depth-8 trees at 1,000,000 rows, 500 at 200,000
     (many chunks) and 500 with K = 5 classes at 200,000 (100 trees a
     class, chunks that end inside a class), each with its byte bound
     and its bound from the node visits the plain walk counts.  The
     int8 kernels G (tiled_hist), H (route_only), I (bins_hist_q,
     bins_hist_q_packed) and J (seg_hist, on the leaf partition of the
     leaf ids, whose build is timed too) are checked at W=126 and on
     the first round too, I's pallas_q entry and J also over all 255
     leaves, I at 255 bins.  Each kernel
     is timed (median of CUDA-event timed launches) beside its bound,
     its plain version's time and one torch call that computes the same
     histogram (torch.mm of bf16 operands for the f32 weights,
     torch._int_mm of int8 ones for the int8 weights, D's included);
     the kernels on shared-memory histograms (A, G, I, D, E, F, K) also
     print the launch geometry their wrappers pass (slots and groups
     per CTA, private copies, slot chunks, grid, threads, shared-memory
     bytes per CTA); A, G and I are also held and timed on a tree's
     first round over the bench's own binned rows (make_data's quantile
     bins, not uniform ones) with its first-round weights, beside one
     torch._int_mm of that histogram; kernels B and H are timed as
     their wrappers' calls and as their one launch alone, by CUDA events
     and by the profiler's device time; J (with its run-plan geometry)
     by both too; H's bound also with every 32-byte bin sector its
     routed rows touch read whole;
  3. train through lgb.train at the bench shape (1,000,000 x 28
     synthetic binary task, 255 leaves, max_bin 63) on the card, each
     run with the launch counters zeroed just before it and read just
     after, and each resolving the plan named: 10 trees with f32
     gradients (the fused_streamed plan, kernel D), 3 trees of the
     pre_onehot plan (kernel E's pre_packed entry point), 3 more
     without its strip ladder (the pre entry point), 3 of the pallas
     plan (kernel F) and 3 of pallas_paired (kernel K), whose model
     texts must be equal; 3 int8 trees each of fused_tiled (A, B),
     q_tiled(split_route) (H, G, then B), seg_tiled(leaf_partition) (H,
     J, then B), q_tiled (G), q_onthefly (I's q_packed entry) and
     pallas(quantized) (I's pallas_q entry), whose model texts must be
     equal; 10 trees of the default config (the xla plan, no kernel);
     3 int8 trees each of fused_tiled and seg_tiled without the
     histogram cache (a second pass of A, or of J on the round's
     partition, over the parent slots), whose model texts must be
     equal; 5 trees of lgb.train({"objective": "binary"}) with no other
     key on 50,000 rows (the xla plan); last 10 trees with quantized
     int8 gradients on the main path (kernels A, B);
  4. predict held-out rows through Booster.predict on the card (kernel
     C's shared tier, then 16 rows through its global tier, counted
     with the quantized run), print a warm call's wall and the serving
     predictor's steps (the copy of the f64 rows to the card, their
     split into (hi, lo) pairs on the card, kernel C, the readback, the
     output transform, and the host interleave the split replaced), hold both tiers against the plain version on the
     buckets the path launches them on (200,000 rows zero-padded to
     their 262,144-row bucket, and 16 rows), time the global tier on
     the buckets of 1 and 1,000 rows, compare with the host walk, and
     check the AUC;
  5. train other objectives at the bench shape on the fused_tiled plan
     (kernels A and B, counters zeroed before each run), the label
     X @ w + 0.5 sin(3 X0) X1 + N(0, 1): (a) regression, 3 trees, whose
     held-out l2 must fall each tree and end below the held-out label
     variance; (b) regression_l1, 3 trees (leaves re-fit to residual
     medians after kernel B routes), whose held-out l1 must fall; (c)
     multiclass on the label's quintiles, 2 iterations of 5 trees,
     whose held-out multi_logloss must fall and end below ln 5; predict
     (c)'s held-out rows through Booster.predict (kernel C with K = 5;
     rows must sum to 1 within 1e-5) and hold C's two tiers on its
     ensemble at 200,000 and 16 rows against the plain version;
  6. drive the training front door at the bench shape on the
     fused_tiled plan, the launch counters zeroed before each run and
     printed after it (A and B must launch where trees grow, C where
     Booster.predict runs): (a) early_stopping_rounds=2 against the
     200,000 held-out rows with labels drawn from a seed independently
     of X (it must stop early, 1 <= best_iteration < iterations
     trained, one evaluation an iteration; predict() must equal
     predict(num_iteration=best_iteration) bit for bit); (b) 3 trees,
     then 2 more with init_model (C predicts the training rows' seed;
     the base trees unchanged, the held-out log loss lower); (c) 2
     iterations with a numpy binary fobj, whose first tree must equal
     the built-in objective's with boost_from_average=false; (d) 4
     iterations, then rollback_one_iter: the 3-tree model text; (e) that
     text with an average_output line: C's prediction within 1e-5 of the
     host walk's iteration mean; (f) the held-out rows as CSR, 100 zero
     columns wider (the model narrowed to its used columns): equal to the
     dense prediction; (g) cv, 3 folds x 3 rounds at 300,000 rows;
  7. categorical features and forced splits at the bench shape: the
     last four columns replaced by Zipf-like categories (3, 12, 60 and
     400 of them, each moving the logit; 3% of the held-out values
     unseen in training, 2% NaN), counters zeroed before each run:
     (a) fused_tiled, 10 trees with the four columns categorical
     (kernels A and B; one-hot splits on the 3-category column and
     sorted-mode splits of several categories must appear, held-out
     AUC above 0.75), beside the same run with the columns numeric,
     and the device events a grower round of each (torch.profiler,
     one more iteration); (d) Booster.predict of (a)'s model through
     kernel C within 1e-5 of the host walk and of the held-out set's
     binned walk, pred_leaf landing the host walk's leaves; (b)
     seg_tiled, 3 trees (H, J, B), whose model text must equal (a)'s
     first 3 trees; (c) a forced-split spec (the root on a category,
     its left child on a numeric threshold), 3 trees, each forced as
     specified, and a spec with an impossible threshold falling back to
     (a)'s root;
  8. the random streams and lambdarank, every run on fused_tiled with
     the counters zeroed before it, its every kernel A and B call tapped
     and held bit for bit against the plain versions on the run's own
     inputs after it, and its ms an iteration printed with the card:
     (a) bagging at the bench shape (fraction 0.7 every 2 iterations,
     feature_fraction 0.8, 6 trees): each iteration's bag equal to its
     recomputation on the host from the same key stream
     (utils/prng.py), each tree's root count its bag's size, the in-bag
     share within 0.5% of 0.7; (b) GOSS (top 0.2, other 0.1, learning
     rate 0.5, 5 iterations, sampling from the third): each sample equal
     to its recomputation on the host from the card's own gradients and
     key, each root count the top rows plus the Bernoulli keeps; (c)
     DART (drop rate 0.5, no skip, 5 iterations): some iteration drops,
     and Booster.predict (kernel C) of 200,000 training rows within
     1e-5 x (1 + |s|) of the tracked training scores; (d) RF (bagging
     0.632 every iteration, feature_fraction 0.8, 5 trees): kernel C's
     mean within 1e-5 of the host walk's, its held-out AUC beside phase
     3's; (e) lambdarank at bench.py's ranking shape (18,900 queries of
     60-180 documents, ~2.27M rows x 136 features, 136 groups; 2,000
     held-out queries), bench.py's parameters, int8 weights rounded
     stochastically, 5 iterations: the held-out NDCG@10 of the port's
     metric equal to bench.py's ndcg_at_k on the same scores within
     1e-6, Booster.predict (kernel C) of the held-out rows within 1e-5 x
     (1 + |s|) of the tracked held-out scores, both of C's tiers held
     against the plain version at 136 features (rows read from device
     memory, not staged), the NDCG@10 of Booster.predict's scores
     clearing the untrained one by 0.03, and the lambdas of the last scores on the
     card within 1e-6 of the largest of the same torch ops on the CPU;
  9. prediction beyond the level descent, the counters zeroed first and
     only the path's calls counted (C's launches join phase 4's): (a)
     phase 4's breakdown of a warm 200,000-row call again, and the
     predictor's pageable upload of those rows against staging them
     in pinned memory for a side stream, alternated, the same bits;
     (b) batch sizes 1, 15, 16, 17, 33, 100, 1000 and 4097, each one
     dispatch in its bucket, bit for bit kernel C's plain version on
     that padded bucket and within rtol 2e-5 of the host walk, with its
     median
     latency over 20 warm calls; (c) predict_chunk_rows=16384 on
     200,000 rows: 13 dispatches, bit for bit one dispatch; (d) an
     injected torch.OutOfMemoryError: the bucket halves on the card and
     the scores stay bit for bit; (e) phase 3's binary, phase 5's
     regression and 5-class models co-batched in one launch of C, each
     member's columns bit for bit its solo launch and the whole the
     plain version's; (f) predict_kernel=scan and (g) the binned scan
     of a 10-tree booster that keeps its session (200,000 rows x 10
     trees: the 2M switch) against kernel C within 1e-5 x (1 + |s|),
     with their ms; (h) pred_contrib of 200 rows (each row's
     contributions summing to its raw score within 1e-5) and
     pred_early_stop (signs kept; a 1e9 margin the host walk bit for
     bit), with their ms;
 10. sub-byte bin storage (bin_packing), each run's launches counted on
     their own: (a) the bench rows at max_bin 15, fused_tiled 10 trees
     under 4bit (28 nibble groups stored in 14 bytes a row) and 8bit:
     the texts equal once the bin_packing echo is stripped, the resident
     bin matrix's bytes of each, every A and B call of the 4bit run held
     bit for bit against its plain version on the same storage, and
     kernels A and G at W=126 and on a tree's first round timed on the
     storage and on the logical matrix unpacked from it, each beside its
     bound from the bytes of the matrix it reads; (b) the bench rows
     with 8 columns rounded to 3 values and 8 to 12 under auto (8 crumb,
     8 nibble and 12 wide groups at max_bin 63): q_tiled(split_route),
     seg_tiled(leaf_partition), fused_streamed, pre_onehot and xla, 3
     trees each, every text equal to its 8bit run's and every A, G, J,
     B, H and D call held against its plain version on the storage; (c)
     (a)'s validation scores and the in-session binned scan of the
     held-out rows equal to the 8bit run's bit for bit;
 11. the file entry point, every run's launches counted on their own
     and added to the kernels' counts, in a temporary directory the
     phase removes: (a) the bench's training and held-out rows written
     as TSV, label first, in %.17g (bytes and seconds printed); (b)
     data_loader.load_file of both files through the native parser (the
     library must have loaded), and np.loadtxt of the held-out file,
     each bit for bit the rows written, with their seconds; (c) cli.run
     of a conf written from BENCH_PARAMS (10 trees, the held-out file
     as valid_data, is_save_binary_file): its bins phase 2's byte for
     byte, its model text phase 3's main-path text, and A and B launched
     as often as on phase 3's main path (90 and 10), with the training's
     ms/tree beside phase 3's; (d) the .bin cache (c) wrote loaded as a
     memmap byte-equal to (c)'s bins, and 3 trees trained from it equal
     to (c)'s first 3, with the load's seconds; (e) one-round and
     two-round loading (every row sampled, 65,536-row chunks) byte for
     byte, and construction and the binning pass alone with
     native_binning on and off, with their seconds; (f) task=predict on
     the held-out file (kernel C must launch): each line the %g of
     Booster.predict of the in-memory rows; (g) task=convert_model
     compiled with g++ -O2 -shared and run on 10,000 held-out rows,
     within 1e-10 of the f64 host walk and TOL_PREDICT of kernel C; (h)
     LGBMClassifier with the bench parameters, 3 trees (A and B must
     launch), predict_proba[:, 1] bit for bit booster_.predict; the C
     API's LGBM_DatasetCreateFromFile -> LGBM_BoosterCreate -> 3
     LGBM_BoosterUpdateOneIter equal to lgb.train on the file, and
     LGBM_DatasetCreateByReference + LGBM_DatasetPushRows in 65,536-row
     chunks byte-identical to (c)'s bins; the phase's wall printed;
then print one JSON line with every kernel's numbers and, last, the
result line.  Without a CUDA device (or with --rehearse, which runs the
same phases on the CPU at a tiny size with the plain versions) it
prints no result and exits nonzero.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time

import numpy as np

MEM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
TOL_PREDICT = 1e-5               # |d| <= TOL * (1 + |score|)
#: phase 7 (a)'s held-out AUC floor: between the categorical model's
#: 0.8182 and the same columns treated as numeric, 0.7546 (PERF.md)
AUC_FLOOR_CATEGORICAL = 0.79
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


def device_ms(fn, reps: int, split: bool = False):
    """Mean device milliseconds of one call of ``fn``: the summed time of
    the device work (kernels, memory sets and copies) its ``reps`` calls
    put on the card, from torch.profiler, without the host's time between
    them.  A call whose host work outlasts its device work shows less
    here than between two CUDA events.  With ``split``, {device event
    name: mean ms a call} instead.  A profiling session that recorded no
    device event (seen once on the card) is repeated, up to three; if
    all three record none, None (not measured), never 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()                                           # warm-up
    torch.cuda.synchronize()
    per = {}
    for _ in range(3):      # a session that recorded no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {e.key: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
               / 1e3 / reps
               for e in prof.key_averages()
               if getattr(e.device_type, "name", "") == "CUDA"}
        if per:
            return per if split else sum(per.values())
    return None


def kernel_name(key: str) -> str:
    """The function name in a profiler event's demangled signature
    ("void (anonymous namespace)::seg_plan_kernel(int const*, ...)" ->
    "seg_plan_kernel"); other events as they are."""
    m = re.search(r"(\w+)(?:<[^>]*>)?\(", key)
    return m.group(1) if m else key


# ---------------------------------------------------------------------------
# phase 2 inputs
# ---------------------------------------------------------------------------
def random_route_table(rng, L, G, B, cat_frac=0.2, cat_groups=None):
    """A pending route table over L leaves: half of them split, with a
    mix of missing types (none / zero / NaN), default directions,
    categorical left-sets and right slots numbered after the leaves.
    With ``cat_groups``, the categorical leaves split those groups."""
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
    if cat_groups is not None:
        cat = cols["is_cat"]
        cols["feat_group"][cat] = rng.choice(cat_groups, int(cat.sum()))
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


def bin_sectors(leaf, table, n) -> int:
    """The 32-byte sectors of the (G, n) bins that the routing reads:
    one per distinct (chosen group, row // 32) of the rows whose leaf
    splits (neighbouring rows of leaves that split on different groups
    read different sectors)."""
    import torch
    L = table.shape[0]
    lf = leaf.clamp(0, L - 1).long()
    ok = (leaf >= 0) & (leaf < L) & (table[lf, 10] > 0.5)
    grp = (table[lf, 0] * 256 + table[lf, 1]).long()
    row = torch.arange(n, device=leaf.device)
    addr = (grp * n + row)[ok]
    return int(torch.unique(addr // 32).numel())


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
    oh = int8_onehot(binsT.t().contiguous(), B)

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
        # the library call histograms the post-route leaves (it cannot
        # route)
        lib = int8_library_ms(l_p, slots, wT, oh, dev, reps)
        label = "first round (W=1)" if W == "first round" else f"W={W}"
        print(f"[phase 2] fused_route_hist {label}: {ms:.4f} ms "
              f"(bound {bound:.4f} ms, bytes; plain {plain:.3f} ms; "
              f"library {lib:.4f} ms; {n_hit} of {n} rows in slots; "
              f"{card})")
        print_geometry("fused_route_hist", label, n, slots.shape[0], G, B,
                       0, dev)
        if W == 126:
            out["fused_route_hist"] = dict(max_abs_err=0, ms=ms,
                                           plain_ms=plain, bound_ms=bound,
                                           library_ms=lib)
        else:
            out["fused_route_hist"].update(ms_first_round=ms,
                                           plain_ms_first_round=plain,
                                           bound_ms_first_round=bound,
                                           library_ms_first_round=lib)
    del oh

    # ---- kernel B: the wrapper's call, and its one launch alone (the
    # outputs allocated once)
    values = torch.from_numpy(rng.randn(L).astype(np.float32)).to(dev)
    lk, vk = H.route_apply_tiled(binsT, leaf, table, values)
    lp, vp = H.route_apply_plain(binsT, leaf, table, values)
    if not (torch.equal(lk, lp) and torch.equal(
            vk.view(torch.int32), vp.view(torch.int32))):
        raise AssertionError("route_apply: kernel != plain")
    b_ms = time_ms(lambda: H.route_apply_tiled(binsT, leaf, table, values),
                   dev, reps)
    b_launch = b_device = None              # not measured on the CPU
    if dev.type == "cuda":
        from lightgbm_tpu_torch.ops import kernels
        args = (binsT.data_ptr(), leaf.data_ptr(), table.data_ptr(),
                values.data_ptr(), lk.data_ptr(), vk.data_ptr(), n, G, L,
                table.shape[1], H._num_sms(dev.index or 0), 0)
        b_launch = time_ms(lambda: kernels.launch("route_apply", *args),
                           dev, reps)
        b_device = device_ms(lambda: H.route_apply_tiled(
            binsT, leaf, table, values), reps)
    b_plain = time_ms(lambda: H.route_apply_plain(binsT, leaf, table,
                                                  values), dev, 3)
    # leaf ids in and out, values out, the chosen group's bin for rows of
    # splitting leaves, the table and the leaf values
    b_bound = ((12 * n + split_rows(leaf, table)
                + (table.numel() + L) * 4)
               / MEM_BYTES_PER_S * 1e3)
    print(f"[phase 2] route_apply: {b_ms:.4f} ms the call, "
          f"{fmt_ms(b_launch)} its launch (CUDA events around each), "
          f"{fmt_ms(b_device)} of device time a call (profiler) (bound "
          f"{b_bound:.4f} ms, bytes; "
          f"plain {b_plain:.3f} ms; {card})")
    out["route_apply"] = dict(max_abs_err=0.0, ms=b_ms, plain_ms=b_plain,
                              bound_ms=b_bound, launch_ms=b_launch,
                              device_ms=b_device)

    # ---- kernel C in both tiers, on random ensembles with NaN / zero /
    # categorical nodes: (b) 10 depth-8 trees at the phase's rows, (c)
    # 500 at 200,000 rows (many chunks of shared memory), (k5) 500 with
    # K = 5 classes, 100 a class, at 200,000 rows: a class's sum crosses
    # the chunks that end inside it
    F = 28
    cats = {3, 7}
    for key, T, K, rows in (("b", 10, 1, n), ("c", 500, 1, min(n, 200_000)),
                            ("k5", 500, 5, min(n, 200_000))):
        trees = random_trees(rng, T, 8, F, cats)
        flat = flatten_ensemble(trees, K)
        depth = int(flat.pop("depth"))
        stack = P.level_ensemble_from_numpy(flat, dev)
        if K > 1:
            per_class = T // K
            plan = P.level_plan(P.pack_level_records(stack), rows, 2 * F,
                                tier="shared")
            if plan.chunks < 2 or per_class % plan.trees_per_chunk == 0:
                raise AssertionError(
                    f"({key}): chunks of {plan.trees_per_chunk} trees do "
                    f"not end inside a class of {per_class}")
        X = rng.randn(rows, F)
        X[rng.rand(rows, F) < 0.05] = np.nan
        X[rng.rand(rows, F) < 0.05] = 0.0
        for c in cats:
            X[:, c] = rng.randint(-1, 45, rows)
        x2 = torch.from_numpy(P.interleave_hi_lo(X)).to(dev)
        res = check_level(P, stack, x2, depth, dev, reps, card,
                          f"({key}) {T} depth-8 trees, K = {K}, {rows} rows")
        for name, nums in res.items():
            out.setdefault(name, {}).update(
                {f"{k}_{key}": v for k, v in nums.items()})
    return out


def smem_bytes_per_s():
    """The card's shared-memory rate: SMs x 128 bytes a clock x the
    highest SM clock nvidia-smi reports (None without a card)."""
    import torch
    if not torch.cuda.is_available():
        return None
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    mhz = float(r.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * mhz * 1e6


def level_bounds(P, rec, x2, depth):
    """Kernel C's two bounds (ms): the bytes it must move (the rows read
    once, the scores written once, the records, meta, leaf values and,
    with categorical nodes, category words read once) over the memory
    rate, and its node visits (the plain walk's sum of path lengths) x
    the 16-byte walk record over the shared-memory rate (None without a
    card); and the visits."""
    n = x2.shape[0]
    tables = [rec.walk, rec.meta, rec.leaves] + ([rec.cats]
                                                 if rec.has_cat else [])
    nbytes = (x2.numel() * 4 + n * rec.num_class * 4
              + sum(t.numel() * t.element_size() for t in tables))
    visits = P.level_visits(rec, x2, depth)
    rate = smem_bytes_per_s()
    return (nbytes / MEM_BYTES_PER_S * 1e3,
            None if rate is None else visits * 16 / rate * 1e3, visits)


def check_level(P, stack, x2, depth, dev, reps, card, label,
                phase=2):
    """Kernel C's two tiers on one input: each held against the plain
    version (the JAX form's, a matrix product) within TOL_PREDICT, the
    two bit-identical; timed by CUDA events and by the profiler's device
    time beside the plain version and both bounds.  Returns
    {"predict_level": numbers, "predict_level_global": numbers}."""
    import torch
    rec = P.pack_level_records(stack)
    want = P.predict_level_ensemble_plain(stack, x2, depth=depth)
    got = {}
    for tier in ("shared", "global"):
        got[tier] = P.predict_level_ensemble(rec, x2, depth=depth, tier=tier)
        compare_level(got[tier], want, f"predict_level {tier} {label}")
    if not torch.equal(got["shared"].view(torch.int32),
                       got["global"].view(torch.int32)):
        raise AssertionError(f"predict_level {label}: the tiers differ")
    plain = time_ms(lambda: P.predict_level_ensemble_plain(
        stack, x2, depth=depth), dev, 3)
    bound, visit_bound, visits = level_bounds(P, rec, x2, depth)
    res = {}
    for tier, name in (("shared", "predict_level"),
                       ("global", "predict_level_global")):
        def call(tier=tier):
            return P.predict_level_ensemble(rec, x2, depth=depth, tier=tier)
        ms = time_ms(call, dev, reps)
        device = device_ms(call, reps) if dev.type == "cuda" else None
        err = float((got[tier] - want).abs().max())
        plan = P.level_plan(rec, x2.shape[0], x2.shape[1], tier=tier)
        print(f"[phase {phase}] {name} {label}: {ms:.4f} ms the call "
              f"(events), {fmt_ms(device)} device (profiler) (bound "
              f"{bound:.4f} ms, "
              f"bytes; {fmt_ms(visit_bound)} counting {visits} node visits "
              f"x 16 B of shared memory; plain {plain:.3f} ms; max |d| "
              f"{err:.3g}; {plan.chunks} chunk(s) of "
              f"{plan.trees_per_chunk} trees, rows staged: "
              f"{plan.stage_x}; {card})")
        res[name] = dict(ms=ms, device_ms=device, plain_ms=plain,
                         bound_ms=bound, bound_ms_visits=visit_bound,
                         visits=visits, max_abs_err=err)
    return res


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def compare_level(got, want, label) -> float:
    """Kernel C's scores against the plain version's; returns max |d|."""
    d = (got - want).abs()
    if not bool((d <= TOL_PREDICT * (1 + want.abs())).all()):
        raise AssertionError(f"{label}: kernel != plain (max |d| "
                             f"{d.max().item()})")
    return float(d.max())


def served(bst):
    """The serving predictor Booster.predict scores ``bst``'s used trees
    with on its device (kernel C's records and their depth)."""
    return bst._serving_predictor(bst._resolve_tree_count(len(bst.models),
                                                          -1))


def launched_x2(P, pred, X, dev):
    """The (b, 2F) f32 bucket the serving predictor ``pred`` launches
    kernel C on for the rows ``X`` (one chunk): the rows split into
    (hi, lo) pairs on ``dev``, the pad rows zero."""
    import torch
    n, F = X.shape
    cap = pred._chunk_cap(2 * F)
    if n > cap:
        raise AssertionError(f"{n} rows take several chunks (cap {cap})")
    x2 = torch.zeros((pred._bucket(n, cap), 2 * F), dtype=torch.float32,
                     device=dev)
    P.split_hi_lo_device(torch.from_numpy(np.ascontiguousarray(X)).to(dev),
                         out=x2[:n])
    return x2


def predict_breakdown(bst, X, dev, reps=3):
    """Booster.predict's wall on ``X`` (a warm call: the predictor and
    its records are built) and the serving predictor's steps timed one
    by one: the copy of the f64 rows to the card, their split into (hi,
    lo) pairs on the card, kernel C, the readback, the output
    transform; beside them the host f64 -> hi/lo interleave the split
    replaced.  ``X`` fits one chunk.  Medians of ``reps`` calls, ms."""
    import torch
    from lightgbm_tpu_torch.basic import _to_matrix
    from lightgbm_tpu_torch.ops import predict as P
    pred = served(bst)
    data = np.ascontiguousarray(_to_matrix(X), np.float64)
    n, F = data.shape
    cap = pred._chunk_cap(2 * F)
    if n > cap:
        raise AssertionError(f"{n} rows take several chunks (cap {cap})")
    b = pred._bucket(n, cap)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    steps = ("wall", "copy to the card", "split on the card", "kernel C",
             "readback", "output transform", "host interleave (replaced)")
    parts = {k: [] for k in steps}
    for _ in range(reps):
        sync()
        t = [time.perf_counter()]
        bst.predict(X)
        sync()
        t.append(time.perf_counter())
        x64 = torch.from_numpy(data).to(dev)
        sync()
        t.append(time.perf_counter())
        x2 = torch.empty((b, 2 * F), dtype=torch.float32, device=dev)
        x2[n:].zero_()
        P.split_hi_lo_device(x64, out=x2[:n])
        sync()
        t.append(time.perf_counter())
        scores = pred._dispatch(x2)
        sync()
        t.append(time.perf_counter())
        host = scores[:n].cpu().numpy()
        t.append(time.perf_counter())
        bst._finish_device_scores(host.astype(np.float64), pred.num_trees)
        t.append(time.perf_counter())
        P.interleave_hi_lo(data)
        t.append(time.perf_counter())
        for k, a, z in zip(steps, t, t[1:]):
            parts[k].append((z - a) * 1e3)
    return {k: float(np.median(v)) for k, v in parts.items()}


def upload_ab(P, pred, X, dev, reps):
    """One chunk of ``X``'s rows through the serving predictor's steps,
    uploaded two ways and alternated (pinned, pageable, pageable,
    pinned) ``reps`` times: "pageable" is the predictor's own,
    torch.from_numpy(rows).to(card) and scores.cpu(); "pinned" copies
    the f64 rows into a reused pinned buffer and from there to the card
    on a side stream, the scores read back into pinned memory.  Each
    then splits the rows on the card and runs kernel C on the
    zero-padded bucket.
    Checks that both give the same bits; returns their median walls,
    ms (None off the card)."""
    import torch
    if dev.type != "cuda":
        return {"pinned": None, "pageable": None}
    data = np.ascontiguousarray(X, dtype=np.float64)
    n, F = data.shape
    b = pred._bucket(n, pred._chunk_cap(2 * F))
    host_x = torch.empty((n, F), dtype=torch.float64, pin_memory=True)
    host_out = torch.empty((n, pred.num_class), dtype=torch.float32,
                           pin_memory=True)
    side = torch.cuda.Stream(dev)

    def finish(x64):
        x2 = torch.empty((b, 2 * F), dtype=torch.float32, device=dev)
        x2[n:].zero_()
        P.split_hi_lo_device(x64, out=x2[:n])
        return pred._dispatch(x2)[:n]

    def pinned():
        host_x.numpy()[:] = data
        main = torch.cuda.current_stream(dev)
        with torch.cuda.stream(side):
            x64 = host_x.to(dev, non_blocking=True)
        main.wait_stream(side)
        x64.record_stream(main)
        host_out.copy_(finish(x64), non_blocking=True)
        torch.cuda.synchronize()
        return host_out.numpy().copy()

    def pageable():
        return finish(torch.from_numpy(data).to(dev)).cpu().numpy()

    if not np.array_equal(pinned(), pageable()):
        raise AssertionError("the pinned and pageable uploads differ")
    times = {"pinned": [], "pageable": []}
    for _ in range(reps):
        for name, fn in (("pinned", pinned), ("pageable", pageable),
                         ("pageable", pageable), ("pinned", pinned)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


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


def record_kernel(out, n, card, name, label, ms, plain, bound, by, lib, err,
                  unstable, hit, main):
    """Print one timed phase-2 case and file its numbers under ``name``:
    the contract's keys for the main case, suffixed keys for the
    others."""
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
        tag = label.replace(" (W=1)", "").replace(" ", "_").replace("=", "")
        out[name].update({f"ms_{tag}": ms, f"plain_ms_{tag}": plain,
                          f"bound_ms_{tag}": bound,
                          f"library_ms_{tag}": lib})


def int8_onehot(bins, B):
    """The (N, G*B) int8 bin one-hot, its columns zero-padded to a
    multiple of 8 (1764 -> 1768) as torch._int_mm wants, laid out
    column-major: the int8 product's fast form takes its right operand
    so (a row-major one-hot ran several times slower on the H100).
    Filled in row chunks, so that no second copy of it is ever whole
    (19.7 GB at phase 8 (e)'s 2.26M rows x 136 groups)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    n, G = bins.shape
    ohT = torch.zeros((-(-G * B // 8) * 8, n), dtype=torch.int8,
                      device=bins.device)
    step = 1 << 18
    for i in range(0, n, step):
        ohT[:G * B, i:i + step] = H.precompute_bin_onehot(
            bins[i:i + step], max_group_bin=B).t()
    return ohT.t()


def int8_library_ms(leaf, slots, wT, oh_i8, dev, reps):
    """One torch call computing the int8 histogram: torch._int_mm of the
    slot-masked (3W, N) int8 weights by the (N, G*B) int8 one-hot, int32
    out.  _int_mm wants more than 16 rows and a multiple of 8 in the
    other dimensions: the weight rows are zero-padded to a multiple of 8
    of at least 24, and N must be a multiple of 8.  Timed here only; the
    port never calls it."""
    import torch
    W, n = slots.shape[0], leaf.shape[0]
    if n % 8:
        raise ValueError(f"torch._int_mm needs N % 8 == 0, got {n}")
    m = (leaf[None, :] == slots[:, None]) & (slots[:, None] >= 0)
    rows = max(24, -(-3 * W // 8) * 8)
    lhs = torch.zeros((rows, n), dtype=torch.int8, device=leaf.device)
    lhs[:3 * W] = (m[None] * wT[:, None, :]).reshape(3 * W, n)
    ms = time_ms(lambda: torch._int_mm(lhs, oh_i8), dev, reps)
    del lhs, m
    return ms


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


#: the int32 shared-memory histograms (csrc/hist_i32.cuh): A and G on the
#: transposed bins, I behind its two entry points on the row-major ones
I32_KERNELS = ("fused_route_hist", "tiled_hist", "bins_hist_q",
               "bins_hist_q_packed")


def print_geometry(name, label, n, W, G, B, row_bytes, dev):
    """Print the launch geometry (ops/histogram.py) that a redesigned
    kernel's wrapper passes for these shapes: for the f32 kernels slots
    per CTA, copies, groups per CTA, slot chunks, grid, threads and
    shared bytes (the kernel shares the grid's x CTAs out over the slot
    chunks itself, from the leaf ids); for the int32 kernels A and G
    slots and groups per CTA, grid, threads and shared bytes; for the
    int32 kernels A, G and I slots and groups per CTA, grid, threads,
    rows a thread and shared bytes."""
    from lightgbm_tpu_torch.ops import histogram as H
    sms = H._num_sms(dev.index or 0) if dev.type == "cuda" else H.H100_SMS
    if name in I32_KERNELS:
        p = H.frontier_hist_plan(n, W, G, B, sms)
        print(f"[phase 2] {name} {label} geometry: {p.slots_per_cta} slots "
              f"per CTA, {p.groups_per_cta} groups per CTA, grid "
              f"{list(p.grid)} (row CTAs, group chunks, slot chunks), "
              f"{p.threads} threads, {p.rows_per_thread} rows a thread, "
              f"{p.smem_bytes} B of shared memory per CTA")
        return
    p = (H.bins_hist_plan(n, W, G, B, sms) if name.startswith("bins")
         else H.onehot_hist_plan(n, W, G, B, row_bytes, sms))
    print(f"[phase 2] {name} {label} geometry: {p.slots_per_cta} slots per "
          f"CTA, {p.copies} copies, {p.groups_per_cta} groups per CTA, "
          f"{p.chunks} slot chunks, grid {list(p.grid)}, {p.threads} "
          f"threads{' owning columns' if p.cols else ''}, {p.smem_bytes} B "
          "of shared memory per CTA")


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
    # the int8 library call's column-major one-hot (D with int8 weights)
    oh_i8 = int8_onehot(bins, B)
    root = torch.where(leaf >= 0, 0, -1).to(torch.int32)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    out = {}

    def slots_of(W, span):
        return torch.from_numpy(rng.permutation(span)[:W].astype(
            np.int32)).to(dev)

    def n_hit(lf, slots):
        return int(torch.isin(lf, slots[slots >= 0]).sum())

    def record(*args):
        record_kernel(out, n, card, *args)

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
        lib = (library_ms(l_p, slots, wT, oh_bf16, dev, reps)
               if wname == "f32" else
               int8_library_ms(l_p, slots, wqT, oh_i8, dev, reps))
        main = W == 126 and pack == 4 and wname == "f32"
        record("fused_onehot_hist", "main" if main else label, ms, plain,
               bound, by, lib, err, unstable_bins(run), hit, main)
        if wname == "f32":
            print_geometry("fused_onehot_hist", label, n, slots.shape[0], G,
                           B, ohb[pack].shape[1], dev)

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
        print_geometry(entry, label, n, slots.shape[0], G, B,
                       ohb[4].shape[1], dev)

    # ---- kernels F and K (F's function behind the paired plan's entry
    # point): row-major bins, f32 weights
    for entry, W in [("bins_hist", W) for W in (42, 84, 126, 0)] + [
            ("bins_hist_paired", W) for W in (126, 0)]:
        first = W == 0
        lf = root if first else leaf
        slots = one if first else slots_of(W, L)
        fn, plain_fn = getattr(H, entry), getattr(H, entry + "_plain")

        def run(lf=lf, slots=slots, fn=fn):
            return fn(bins, w, lf, slots, B)
        h_k = run()
        h_p = plain_fn(bins, w, lf, slots, B)
        label = "first round (W=1)" if first else f"W={W}"
        S = H.bins_hist_plain(bins, w.abs(), lf, slots, B)
        err = hold_hist(f"{entry} {label}", h_k, h_p, S)
        if W not in (126, 0):
            continue
        ms = time_ms(run, dev, reps)
        plain = time_ms(lambda: plain_fn(bins, w, lf, slots, B), dev, 3)
        hit = n_hit(lf, slots)
        bound, by = hist_bound(4 * n, hit, 12 + G, h_k, hit * G * 3)
        # the library call reads the pack-1 one-hot, which F never reads
        lib = library_ms(lf, slots, wT, oh_bf16, dev, reps)
        record(entry, "main" if W == 126 else label, ms, plain, bound,
               by, lib, err, unstable_bins(run), hit, W == 126)
        print_geometry(entry, label, n, slots.shape[0], G, B, 0, dev)
    del oh_bf16, oh_i8, ohb
    # ---- the xla plan's histogram (the default config's; torch ops, no
    # kernel) at W=126 and on the first round, rows padded to the
    # grower's chunk; its count channel must equal kernel F's
    chunk = H._pick_chunk(n, G, B, 4, min_chunk=1024)
    pad = -n % chunk
    xb = torch.nn.functional.pad(bins, (0, 0, 0, pad))
    xg, xh, xc = (torch.nn.functional.pad(v, (0, pad))
                  for v in (grad, hess, counts))
    for W in (126, 0):
        lf = root if W == 0 else leaf
        slots = one if W == 0 else slots_of(W, L)
        xl = torch.nn.functional.pad(lf, (0, pad), value=-1)

        def run(xl=xl, slots=slots):
            return H.compute_group_histograms(
                xb, xg, xh, xc, xl, num_leaves=L, max_group_bin=B,
                chunk=chunk, slots=slots)
        if not torch.equal(run()[..., 2], H.bins_hist(bins, w, lf, slots,
                                                      B)[..., 2]):
            raise AssertionError(f"xla histogram W={W}: counts differ from "
                                 "kernel F's")
        ms = time_ms(run, dev, 3)
        print(f"[phase 2] xla histogram (torch ops) "
              f"{'first round (W=1)' if W == 0 else f'W={W}'}: {ms:.4f} ms "
              f"(chunk {chunk}, {xb.shape[0] // chunk} chunks; {card})")
    del xb
    return out


# ---------------------------------------------------------------------------
# phase 2, kernels G, H and I (int8 weights without the fused route)
# ---------------------------------------------------------------------------
def check_quant_kernels(dev, n, rehearse, card):
    """Phase 2 for kernels G (tiled_hist), H (route_only) and I behind
    its two entry points (bins_hist_q, bins_hist_q_packed) against their
    plain versions: int32 histograms and leaf ids bit for bit, with the
    count of bins that differ between two launches.  The library time of
    every int8 histogram (A's too) is one torch._int_mm of the same
    function.  Returns {kernel: numbers}."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops.partition import block_slots

    rng = np.random.RandomState(17)
    G, B, L = 28, 63, 255
    reps = 3 if rehearse else 20
    binsT = torch.from_numpy(rng.randint(0, B, (G, n)).astype(np.uint8)).to(dev)
    bins = binsT.t().contiguous()
    # the bf16 branch of the TPU body: 255 bins, some bins >= B
    bins255 = torch.from_numpy(rng.randint(0, 256, (n, G)).astype(
        np.uint8)).to(dev)
    leaf = rng.randint(0, L, n).astype(np.int32)
    leaf[rng.rand(n) < 0.01] = -1                       # padded rows
    leaf = torch.from_numpy(leaf).to(dev)
    counts = (leaf >= 0).to(torch.float32)
    grad = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev) * counts
    hess = torch.from_numpy(rng.rand(n).astype(np.float32) * 0.25).to(
        dev) * counts
    wq, _ = H.quantize_gradients(grad, hess, counts)          # (N, 3)
    wqT = wq.t().contiguous()                                 # (3, N)
    table = random_route_table(rng, L, G, B).to(dev)
    oh = int8_onehot(bins, B)
    root = torch.where(leaf >= 0, 0, -1).to(torch.int32)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    all_leaves = torch.arange(L, dtype=torch.int32, device=dev)
    out = {}

    def record(*args):
        record_kernel(out, n, card, *args)

    # ---- kernel G and kernel I's q_packed entry: the lane-ladder widths
    # and the first round; kernel I's pallas_q entry: W=126, the first
    # round, every leaf, and 255 bins
    cases = [("tiled_hist", W, B) for W in (42, 84, 126, 0)]
    cases += [("bins_hist_q_packed", W, B) for W in (42, 84, 126, 0)]
    cases += [("bins_hist_q", W, B) for W in (126, 0, L)]
    cases += [("bins_hist_q", 126, 255)]
    for name, W, b in cases:
        first = W == 0
        lf = root if first else leaf
        slots = one if first else all_leaves if W == L else torch.from_numpy(
            rng.permutation(L)[:W].astype(np.int32)).to(dev)
        if name == "tiled_hist":
            args = (binsT, wqT, lf, slots, b)
            plain = H.tiled_hist_plain
        else:
            args = (bins255 if b == 255 else bins, wq, lf, slots, b)
            plain = H.bins_hist_plain
        fn = getattr(H, name)
        h_k = fn(*args)
        label = ("first round (W=1)" if first else "all 255 leaves"
                 if W == L else f"W={W}") + (", B=255" if b == 255 else "")
        err = hold_hist(f"{name} {label}", h_k, plain(*args), None)
        if b != B or W not in (126, 0, L):
            continue
        ms = time_ms(lambda: fn(*args), dev, reps)
        plain_ms = time_ms(lambda: plain(*args), dev, 3)
        hit = int(torch.isin(lf, slots).sum())
        bound, by = hist_bound(4 * n, hit, 12 + G, h_k, hit * G * 3)
        lib = int8_library_ms(lf, slots, wqT, oh, dev, reps)
        main = W == 126
        record(name, "main" if main else label, ms, plain_ms, bound, by, lib,
               err, unstable_bins(lambda: fn(*args)), hit, main)
        print_geometry(name, label, n, slots.shape[0], G, b, 0, dev)
    # ---- kernel J: the leaf partition of the leaf ids (timed: sort,
    # searchsorted, scatter and the two gathers), then the segment
    # histogram at W=126, on the first round and over all 255 leaves.
    # The partition wants a multiple of its block: the rows are padded
    # as the grower pads them (leaf -1, zero weights)
    pad = -n % H.SEG_BLOCK
    binsT_x = torch.nn.functional.pad(binsT, (0, pad))
    wqT_x = torch.nn.functional.pad(wqT, (0, pad))
    for W in (126, 0, L):
        first = W == 0
        lf = root if first else leaf
        slots = one if first else all_leaves if W == L else torch.from_numpy(
            rng.permutation(L)[:W].astype(np.int32)).to(dev)
        lf_x = torch.nn.functional.pad(lf, (0, pad), value=-1)
        part_ms = time_ms(lambda: partition(binsT_x, wqT_x, lf_x, L), dev,
                          3 if rehearse else 10)
        binsT_p, wT_p, blk_leaf = partition(binsT_x, wqT_x, lf_x, L)
        blk_slot = block_slots(blk_leaf, slots, L)
        args = (binsT_p, wT_p, blk_slot, slots.shape[0], B)
        label = ("first round (W=1)" if first else "all 255 leaves"
                 if W == L else f"W={W}")
        err = hold_hist(f"seg_hist {label}", H.seg_hist(*args),
                        H.seg_hist_plain(*args), None)
        ms = time_ms(lambda: H.seg_hist(*args), dev, reps)
        parts = (device_ms(lambda: H.seg_hist(*args), reps, split=True)
                 if dev.type == "cuda" else None) or {}
        dms = sum(parts.values()) if parts else None
        # each launch's share: the zero fill, the run plan, the histogram
        launch_ms = ", ".join(
            f"{kernel_name(k)} {v:.4f}" for k, v in parts.items())
        plain_ms = time_ms(lambda: H.seg_hist_plain(*args), dev, 3)
        hit = int(torch.isin(lf, slots).sum())
        live = int(((blk_slot >= 0) & (blk_slot < slots.shape[0])).sum())
        # blk_slot for every block, the weights of every row of a live
        # block (gap rows too), the G bin bytes of each row in a slot
        bound, by = hist_bound(4 * blk_slot.numel() + 12 * live * H.SEG_BLOCK,
                               hit, G, H.seg_hist(*args), hit * G * 3)
        lib = int8_library_ms(lf, slots, wqT, oh, dev, reps)
        main = W == 126
        print(f"[phase 2] leaf partition {label}: {part_ms:.4f} ms (sort, "
              f"searchsorted, scatter, two gathers; {live} live blocks of "
              f"{blk_slot.numel()}; {card})")
        record("seg_hist", "main" if main else label, ms, plain_ms, bound,
               by, lib, err, unstable_bins(lambda: H.seg_hist(*args)), hit,
               main)
        tag = "" if main else "_" + label.replace(" (W=1)", "").replace(
            " ", "_")
        out["seg_hist"][f"partition_ms{tag}"] = part_ms
        out["seg_hist"][f"device_ms{tag}"] = dms
        sms = H._num_sms(dev.index or 0) if dev.type == "cuda" \
            else H.H100_SMS
        p = H.seg_hist_plan(binsT_p.shape[1], G, B, slots.shape[0], sms)
        runs = H.seg_runs(blk_slot, slots.shape[0], p.ctas,
                          H.SEG_BLOCK // p.rows_per_thread)[-1]
        print(f"[phase 2] seg_hist {label}: "
              f"{'not measured' if dms is None else f'{dms:.4f} ms'} of "
              f"device time a call (profiler: {launch_ms or 'no launch'}); "
              f"geometry: a grid of {p.ctas} x {p.grid_y} CTAs sharing "
              f"the live rows, {runs.shape[0]} runs (one atomic flush "
              f"each), {p.slots_per_cta} slots' histograms a CTA at once, "
              f"{p.groups_per_cta} groups per CTA, {p.threads} threads, "
              f"{p.rows_per_thread} rows an item, {p.smem_bytes} B of "
              f"shared memory per CTA ({card})")
        del binsT_p, wT_p
    del binsT_x, wqT_x
    # ---- kernel H: a pending table, and the zero table of a tree's
    # first round (nothing routes)
    for tb, label in ((table, "main"), (torch.zeros_like(table),
                                        "first round")):
        l_k = H.route_only_tiled(binsT, leaf, tb)
        if not torch.equal(l_k, H.route_only_plain(binsT, leaf, tb)):
            raise AssertionError(f"route_only {label}: kernel != plain")
        if label != "main":
            if not torch.equal(l_k, leaf):
                raise AssertionError("route_only moved rows on a zero table")
            continue
        ms = time_ms(lambda: H.route_only_tiled(binsT, leaf, table), dev,
                     reps)
        h_launch = h_device = h_launch_device = None  # not on the CPU
        if dev.type == "cuda":
            from lightgbm_tpu_torch.ops import kernels
            args = (binsT.data_ptr(), leaf.data_ptr(), table.data_ptr(),
                    l_k.data_ptr(), n, G, L, table.shape[1],
                    H._num_sms(dev.index or 0), 0)
            h_launch = time_ms(lambda: kernels.launch("route_only", *args),
                               dev, reps)
            h_launch_device = device_ms(
                lambda: kernels.launch("route_only", *args), reps)
            h_device = device_ms(lambda: H.route_only_tiled(
                binsT, leaf, table), reps)
        plain_ms = time_ms(lambda: H.route_only_plain(binsT, leaf, table),
                           dev, 3)
        # leaf ids in and out, the chosen group's bin for rows of
        # splitting leaves, the table
        bound = ((8 * n + split_rows(leaf, table) + table.numel() * 4)
                 / MEM_BYTES_PER_S * 1e3)
        # the same with each 32-byte sector of bins that those rows'
        # bytes lie in read whole
        sectors = bin_sectors(leaf, table, n)
        bound_sec = ((8 * n + 32 * sectors + table.numel() * 4)
                     / MEM_BYTES_PER_S * 1e3)
        moved = int((l_k != leaf).sum())
        print(f"[phase 2] route_only: {ms:.4f} ms the call, "
              f"{fmt_ms(h_launch)} its launch (CUDA events around each), "
              f"{fmt_ms(h_device)} of device time a call and "
              f"{fmt_ms(h_launch_device)} a launch (profiler) (bound "
              f"{bound:.4f} ms, bytes; {bound_sec:.4f} ms counting the "
              f"{sectors} 32-byte bin sectors the routed rows touch; "
              f"plain {plain_ms:.3f} ms; {moved} of {n} rows moved; "
              f"{card})")
        out["route_only"] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by="bytes",
                                 library_ms=None, launch_ms=h_launch,
                                 device_ms=h_device,
                                 launch_device_ms=h_launch_device,
                                 bound_ms_sectors=bound_sec)
    del oh
    return out


def check_bench_first_round(dev, bins, B, y, rehearse, card):
    """Phase 2, kernels A, G and I on a tree's first round over the
    bench's own binned rows (make_data, quantile bins, not uniform ones)
    and its first-round weights (binary gradients at the mean label,
    quantized): every row in one slot, nothing to route.  A and G read
    the transposed bins and weights, I (its pallas_q entry) the row-major
    ones.  Bit for bit against the plain versions, timed beside their
    bound and one torch._int_mm of the same histogram.  Returns {kernel:
    extra numbers}."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    n, G = bins.shape
    reps = 3 if rehearse else 20
    bins_rm = torch.from_numpy(np.ascontiguousarray(bins)).to(dev)
    binsT = bins_rm.t().contiguous()
    p = float(y.mean())
    grad = torch.from_numpy((p - y).astype(np.float32)).to(dev)
    hess = torch.full((n,), p * (1 - p), dtype=torch.float32, device=dev)
    wq, _ = H.quantize_gradients(grad, hess, torch.ones_like(grad))
    wT = wq.t().contiguous()
    leaf = torch.zeros(n, dtype=torch.int32, device=dev)
    slots = torch.zeros(1, dtype=torch.int32, device=dev)
    table = torch.zeros((1, 16), dtype=torch.float32, device=dev)
    want = H.tiled_hist_plain(binsT, wT, leaf, slots, B)
    oh = int8_onehot(bins_rm, B)
    lib = int8_library_ms(leaf, slots, wT, oh, dev, reps)
    del oh
    label = "first round on make_data bins"
    out = {}
    for name, run in (
            ("fused_route_hist", lambda: H.fused_route_hist(
                binsT, wT, leaf, table, slots, B)[0]),
            ("tiled_hist", lambda: H.tiled_hist(binsT, wT, leaf, slots, B)),
            ("bins_hist_q", lambda: H.bins_hist_q(bins_rm, wq, leaf, slots,
                                                  B))):
        got = run()
        err = hold_hist(f"{name} {label}", got, want, None)
        if not torch.equal(run(), got):
            raise AssertionError(f"{name} {label}: two launches differ")
        ms = time_ms(run, dev, reps)
        # every row's leaf id (A writes one too), its weights and G bins
        nbytes = (8 if name == "fused_route_hist" else 4) * n \
            + n * (12 + G) + got.numel() * 4
        bound = nbytes / MEM_BYTES_PER_S * 1e3
        print(f"[phase 2] {name} {label} (W=1, {G} groups, {B} bins): "
              f"{ms:.4f} ms (bound {bound:.4f} ms, bytes; library "
              f"{lib:.4f} ms; max |d| {err:.3g}; {n} of {n} rows in the "
              f"slot; {card})")
        print_geometry(name, label, n, 1, G, B, 0, dev)
        out[name] = {"ms_first_round_make_data": ms,
                     "bound_ms_first_round_make_data": bound,
                     "library_ms_first_round_make_data": lib}
    return out


def partition(binsT, wT, leaf, L):
    """The seg_tiled plan's partition of a round (the grower's
    _build_partition): the block-aligned leaf permutation and the
    partitioned bins and weights."""
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops.partition import (apply_partition,
                                                  build_leaf_partition)
    perm, blk_leaf, _ = build_leaf_partition(leaf, num_slots=L,
                                             block=H.SEG_BLOCK)
    return (apply_partition(binsT, perm, axis=1),
            apply_partition(wT, perm, axis=1), blk_leaf)


def train_plan(lgb, kernels, params, train_ds, valid_ds, rounds, dev,
               card, label, plan=None):
    """Phase 3: one lgb.train run with the launch counters zeroed just
    before it; with ``plan``, the run must resolve that histogram plan.
    Returns (booster, held-out AUC of the last round, launches during
    the run, ms/tree)."""
    import torch
    evals = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    bst = lgb.train(params, train_ds, rounds, valid_sets=[valid_ds],
                    valid_names=["valid"], evals_result=evals,
                    verbose_eval=False, keep_training_booster=plan is not None)
    if plan is not None and bst.gbdt.grower.plan.name != plan:
        raise AssertionError(f"{label}: resolved the "
                             f"{bst.gbdt.grower.plan.name} plan, not {plan}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    auc = evals["valid"]["auc"][-1]
    print(f"[phase 3] {label}: trained {bst.num_trees()} trees in "
          f"{train_s:.2f} s: {1e3 * train_s / rounds:.1f} ms/tree (wall of "
          f"lgb.train / rounds, card {card}); held-out AUC {auc:.4f}; "
          f"launches {launches}")
    return bst, auc, dict(kernels.LAUNCHES), 1e3 * train_s / rounds


def train_objective(lgb, kernels, params, train_ds, valid_ds, rounds, dev,
                    card, label, metric):
    """Phase 5: one lgb.train run of another objective, the launch
    counters zeroed just before it; it must resolve fused_tiled and
    launch kernels A and B (their plain versions in the rehearsal).
    Returns (booster, the held-out metric after each iteration)."""
    import torch
    evals = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    bst = lgb.train(params, train_ds, rounds, valid_sets=[valid_ds],
                    valid_names=["valid"], evals_result=evals,
                    verbose_eval=False, keep_training_booster=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    plan = bst.gbdt.grower.plan.name
    if plan != "fused_tiled":
        raise AssertionError(f"{label}: resolved the {plan} plan, not "
                             "fused_tiled")
    if dev.type == "cuda":
        for name in ("fused_route_hist", "route_apply"):
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"{label} did not launch {name}")
    curve = evals["valid"][metric]
    print(f"[phase 5] {label}: {bst.num_trees()} trees in {train_s:.2f} s: "
          f"{1e3 * train_s / bst.num_trees():.1f} ms/tree (wall of lgb.train "
          f"over trees; card {card}); held-out {metric} by iteration "
          f"{[round(v, 6) for v in curve]}; launches {launches}")
    return bst, curve


def check_objectives(lgb, kernels, P, params, X, w, Xv, dev, card, reps,
                     texts):
    """Phase 5: regression, regression_l1 and multiclass (5 classes)
    through lgb.train at the bench shape, each on the fused_tiled plan
    through kernels A and B, held-out metrics checked; the multiclass
    booster's Booster.predict through kernel C with K = 5, and C's two
    tiers on its ensemble held against the plain version.  The
    regression and 5-class model texts go into ``texts`` (phase 9
    co-batches them)."""
    import torch
    rng = np.random.RandomState(21)

    def concept(Z):
        return (Z @ w + 0.5 * np.sin(3 * Z[:, 0]) * Z[:, 1]
                + rng.randn(Z.shape[0]))

    y, yv = concept(X), concept(Xv)
    cuts = np.quantile(y, [0.2, 0.4, 0.6, 0.8])
    base = {k: v for k, v in params.items()
            if k not in ("objective", "metric")}
    ref = lgb.Dataset(X, label=y)
    runs = {}
    for label, obj, rounds, metric, ys in (
            ("(a) regression", {"objective": "regression"}, 3, "l2", (y, yv)),
            ("(b) regression_l1", {"objective": "regression_l1"}, 3, "l1",
             (y, yv)),
            ("(c) multiclass", {"objective": "multiclass", "num_class": 5},
             2, "multi_logloss",
             (np.digitize(y, cuts), np.digitize(yv, cuts)))):
        # binned before the timed run, as phase 3's rows are
        run_params = dict(base, **obj)
        cfg = lgb.Config.from_params(run_params)
        train_ds = ref if ys[0] is y else lgb.Dataset(X, label=ys[0],
                                                      reference=ref)
        valid_ds = lgb.Dataset(Xv, label=ys[1], reference=ref)
        valid_ds.construct_aligned(train_ds.construct(cfg), cfg)
        bst, curve = train_objective(lgb, kernels, run_params, train_ds,
                                     valid_ds, rounds, dev, card, label,
                                     metric)
        if not all(b < a for a, b in zip(curve, curve[1:])):
            raise AssertionError(f"{label}: held-out {metric} does not fall "
                                 f"iteration over iteration: {curve}")
        runs[label] = (bst, curve)
    texts.update(regression=runs["(a) regression"][0].model_to_string(),
                 multiclass=runs["(c) multiclass"][0].model_to_string())
    l2_end, var = runs["(a) regression"][1][-1], float(np.var(yv))
    if l2_end >= var:
        raise AssertionError(f"(a): held-out l2 {l2_end} is not below the "
                             f"held-out label variance {var}")
    bst, curve = runs["(c) multiclass"]
    if bst.num_trees() != 10 or curve[-1] >= np.log(5):
        raise AssertionError(f"(c): {bst.num_trees()} trees, held-out "
                             f"multi_logloss {curve[-1]} (ln 5 = "
                             f"{np.log(5):.6f})")
    print(f"[phase 5] (a) held-out l2 {l2_end:.6f} against the held-out "
          f"label variance {var:.6f}; (c) multi_logloss {curve[-1]:.6f} "
          f"against ln 5 = {np.log(5):.6f}")

    # Booster.predict of the 5-class model: kernel C with K = 5
    kernels.reset_launches()
    t0 = time.perf_counter()
    prob = bst.predict(Xv)
    predict_ms = (time.perf_counter() - t0) * 1e3
    launched = kernels.LAUNCHES["predict_level"]
    if prob.shape != (Xv.shape[0], 5) or not np.isfinite(prob).all():
        raise AssertionError(f"(c): predictions of shape {prob.shape}")
    if np.abs(prob.sum(axis=1) - 1.0).max() > 1e-5:
        raise AssertionError("(c): the class probabilities do not sum to 1")
    if dev.type == "cuda" and launched <= 0:
        raise AssertionError("(c): Booster.predict did not launch "
                             "predict_level")
    print(f"[phase 5] (c) Booster.predict of {Xv.shape[0]} rows x 5 "
          f"classes in {predict_ms:.1f} ms (the first call; predict_level "
          f"launches {launched}; {card})")
    pred = served(bst)
    stack = P.unpack_level_records(pred.records)
    x2 = torch.from_numpy(P.interleave_hi_lo(Xv)).to(dev)
    at = f"(c) 10 trees, K = 5, depth {pred.depth}"
    main = check_level(P, stack, x2, pred.depth, dev, reps, card,
                       f"{at}, {Xv.shape[0]} rows", phase=5)
    few = check_level(P, stack, x2[:16].contiguous(), pred.depth, dev,
                      reps, card, f"{at}, 16 rows", phase=5)
    return {"predict_level": {f"{k}_multiclass": v for k, v in
                              main["predict_level"].items()},
            "predict_level_global": {f"{k}_multiclass_16_rows": v for k, v
                                     in few["predict_level_global"].items()}}


def front_door_run(lgb, kernels, dev, label, fn):
    """Phase 6: one front-door call with the launch counters zeroed
    just before it and read just after.  Returns (its result, its wall
    seconds, the launches)."""
    import torch
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    print(f"[phase 6] {label}: {wall:.2f} s; launches {launches}")
    return out, wall, launches


def need_launches(dev, label, launches, names):
    if dev.type != "cuda":
        return
    for name in names:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{label} did not launch {name}")


def logloss(y, p):
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def check_front_door(lgb, kernels, params, train_ds, X, y, Xv, yv, dev,
                     card, plan_runs):
    """Phase 6: the training front door at the bench shape on the
    fused_tiled plan (kernels A and B train, kernel C predicts), each
    run's launches counted on their own: (a) early stopping against
    held-out labels drawn independently of X, (b) continued training
    from init_model (C seeds the training rows), (c) a numpy fobj
    against the built-in objective, (d) rollback_one_iter, (e) a
    random-forest (average_output) model through C, (f) CSR input
    through C at the used columns only, (g) cv.  Returns the numbers
    for the kernels line."""
    import scipy.sparse as sp
    train = ("fused_route_hist", "route_apply")

    def counted(label, launches):
        for name, count in launches.items():
            plan_runs.setdefault(name, {})[f"phase 6 {label}"] = count

    # (a) early stopping on a validation set whose labels carry nothing
    # of X: its log loss worsens from the second tree on
    noise = np.random.RandomState(31).randint(0, 2, len(yv)).astype(float)
    noise_ds = lgb.Dataset(Xv, label=noise, reference=train_ds)
    a_params = dict(params, metric=["binary_logloss"])
    cfg = lgb.Config.from_params(a_params)      # binned before the clock
    noise_ds.construct_aligned(train_ds.construct(cfg), cfg)
    evals = {}
    rounds = 10
    bst, wall, launches = front_door_run(
        lgb, kernels, dev, "(a) early_stopping_rounds=2",
        lambda: lgb.train(a_params, train_ds, rounds, valid_sets=[noise_ds],
                          valid_names=["noise"], evals_result=evals,
                          early_stopping_rounds=2, verbose_eval=False))
    trained = bst.num_trees()
    curve = evals["noise"]["binary_logloss"]
    if not (trained < rounds and 1 <= bst.best_iteration < trained
            and len(curve) == trained):
        raise AssertionError(f"(a): {trained} trees of {rounds}, "
                             f"best_iteration {bst.best_iteration}, "
                             f"{len(curve)} evaluations")
    need_launches(dev, "(a)", launches, train)
    counted("(a)", launches)
    a_ms = 1e3 * wall / trained
    p_default = bst.predict(Xv)
    p_best = bst.predict(Xv, num_iteration=bst.best_iteration)
    if not np.array_equal(p_default, p_best):
        raise AssertionError("(a): predict() differs from "
                             "predict(num_iteration=best_iteration)")
    print(f"[phase 6] (a) stopped after {trained} of {rounds} iterations, "
          f"best_iteration {bst.best_iteration}, held-out log loss "
          f"{[round(v, 6) for v in curve]}: {a_ms:.1f} ms an iteration "
          f"(wall of lgb.train over iterations, the evaluation included; "
          f"{card})")
    del bst

    # (b) 3 trees, then 2 more from init_model: kernel C seeds the
    # training rows' scores with the 3-tree model's raw prediction
    valid_ds = lgb.Dataset(Xv, label=yv, reference=train_ds)
    base, _, launches = front_door_run(
        lgb, kernels, dev, "(b) 3 trees",
        lambda: lgb.train(params, train_ds, 3, verbose_eval=False))
    counted("(b) base", launches)
    base_text = base.model_to_string()
    base_trees = [t.to_string() for t in base.models]
    seed_ms = []
    predict = base.predict

    def timed_predict(*a, **k):
        import torch
        t0 = time.perf_counter()
        r = predict(*a, **k)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seed_ms.append((time.perf_counter() - t0) * 1e3)
        return r
    base.predict = timed_predict
    cont, _, launches = front_door_run(
        lgb, kernels, dev, "(b) 2 more trees from init_model",
        lambda: lgb.train(params, train_ds, 2, init_model=base,
                          valid_sets=[valid_ds], verbose_eval=False))
    del base.predict
    need_launches(dev, "(b)", launches, train + ("predict_level",))
    counted("(b)", launches)
    if cont.num_trees() != 5 or [
            t.to_string() for t in cont.models[:3]] != base_trees:
        raise AssertionError("(b): the base trees changed")
    ll_base = logloss(yv, base.predict(Xv))
    ll_cont = logloss(yv, cont.predict(Xv))
    if not ll_cont < ll_base:
        raise AssertionError(f"(b): held-out log loss {ll_cont} is not "
                             f"below the base's {ll_base}")
    print(f"[phase 6] (b) seeding call (Booster.predict of {len(y)} "
          f"training rows, raw): {seed_ms[0]:.1f} ms; held-out log loss "
          f"{ll_base:.6f} -> {ll_cont:.6f} ({card})")
    del cont

    # (c) a numpy binary fobj: at score 0 its gradients are +-0.5 and
    # its hessians 0.25 exactly, the built-in objective's
    def fobj(scores, ds):
        s = np.asarray(scores, np.float32)
        p = (np.float32(1) / (np.float32(1) + np.exp(-s))).astype(np.float32)
        lab = ds.get_label().astype(np.float32)
        return p - lab, p * (np.float32(1) - p)
    no_avg = dict(params, boost_from_average=False)
    builtin, _, launches = front_door_run(
        lgb, kernels, dev, "(c) built-in objective, 1 tree",
        lambda: lgb.train(no_avg, train_ds, 1, verbose_eval=False))
    counted("(c) built-in", launches)
    custom, _, launches = front_door_run(
        lgb, kernels, dev, "(c) numpy fobj, 2 iterations",
        lambda: lgb.train(no_avg, train_ds, 2, fobj=fobj, verbose_eval=False))
    need_launches(dev, "(c)", launches, train)
    counted("(c) fobj", launches)
    if custom.models[0].to_string() != builtin.models[0].to_string():
        raise AssertionError("(c): the fobj run's first tree differs from "
                             "the built-in objective's")
    print("[phase 6] (c) the fobj run's first tree equals the built-in "
          "objective's")
    del builtin, custom

    # (d) 4 iterations, then rollback: the 3-tree model of (b)
    four, _, launches = front_door_run(
        lgb, kernels, dev, "(d) 4 iterations, then rollback_one_iter",
        lambda: lgb.train(params, train_ds, 4, verbose_eval=False,
                          keep_training_booster=True).rollback_one_iter())
    counted("(d)", launches)
    if four.model_to_string() != base_text:
        raise AssertionError("(d): the rolled-back model differs from the "
                             "3-iteration run's")
    print("[phase 6] (d) after rollback_one_iter the model text equals the "
          "3-iteration run's")
    del four

    # (e) the same trees as a random forest: the iterations' mean
    rf_text = base_text.replace("\nfeature_names=",
                                "\naverage_output\nfeature_names=", 1)
    rf = lgb.Booster(model_str=rf_text, params={"device": dev.type})
    got, _, launches = front_door_run(
        lgb, kernels, dev, "(e) average_output model, Booster.predict",
        lambda: rf.predict(Xv))
    need_launches(dev, "(e)", launches, ("predict_level",))
    counted("(e)", launches)
    host = sum(t.predict(Xv) for t in rf.models) / len(rf.models)
    err_e = float(np.abs(got - host).max())
    if err_e > 1e-5:
        raise AssertionError(f"(e): max |d| {err_e} from the host walk's "
                             "iteration mean")
    print(f"[phase 6] (e) average_output: max |d| {err_e:.3g} from the host "
          "walk's iteration mean")

    # (f) the held-out rows as CSR, 100 zero columns wider: the model is
    # narrowed to its used columns and C runs at that width
    csr = sp.hstack([sp.csr_matrix(Xv), sp.csr_matrix((len(yv), 100))],
                    format="csr")
    dense = rf.predict(Xv, raw_score=True)
    got, _, launches = front_door_run(
        lgb, kernels, dev, "(f) CSR held-out rows, Booster.predict",
        lambda: rf.predict(csr, raw_score=True))
    need_launches(dev, "(f)", launches, ("predict_level",))
    counted("(f)", launches)
    used = rf._compact_for_sparse(-1, csr.shape[1])[1].size
    if not np.array_equal(got, dense):
        raise AssertionError(f"(f): CSR input at {used} columns predicts "
                             f"otherwise than dense: max |d| "
                             f"{np.abs(got - dense).max()}")
    print(f"[phase 6] (f) CSR of {csr.shape[1]} columns narrowed to {used}: "
          "equal to the dense prediction bit for bit")
    del rf

    # (g) cv: 3 folds x 3 rounds, each fold binned anew
    m = min(len(y), 300_000)
    res, cv_s, launches = front_door_run(
        lgb, kernels, dev, f"(g) cv, 3 folds x 3 rounds at {m} rows",
        lambda: lgb.cv(params, lgb.Dataset(X[:m], label=y[:m]), 3, nfold=3,
                       seed=5))
    need_launches(dev, "(g)", launches, train)
    counted("(g)", launches)
    aucs = res["auc-mean"]
    if len(aucs) != 3 or not aucs[-1] > 0.75:
        raise AssertionError(f"(g): auc-mean {aucs}")
    print(f"[phase 6] (g) cv: {cv_s:.2f} s wall (binning included); "
          f"auc-mean {[round(v, 6) for v in aucs]}, auc-stdv "
          f"{[round(v, 6) for v in res['auc-stdv']]} ({card})")
    return {"fused_route_hist": {"phase6_a_ms_per_iteration": a_ms,
                                 "phase6_cv_s": cv_s},
            "predict_level": {"phase6_seed_ms": seed_ms[0],
                              "phase6_rf_max_abs_err": err_e}}


# ---------------------------------------------------------------------------
# phase 7: categorical features and forced splits at the bench shape
# ---------------------------------------------------------------------------
#: the bench's last four columns become categories of these cardinalities:
#: 3 takes the one-hot mode (max_cat_to_onehot 4), 12 and 60 the sorted
#: mode, 400 more than max_bin 63 allows (the 99% cut and the "other" bin)
CAT_COLUMNS = (24, 25, 26, 27)
CAT_CARDS = (3, 12, 60, 400)


def make_cat_data(n, seed, unseen=0.0, nan=0.0):
    """make_data's rows with CAT_COLUMNS replaced by integer categories
    drawn Zipf-like (p ~ 1 / rank^1.1, the ranks' labels shuffled) from
    the row seed.  The concept (numeric weights, a random logit offset a
    category, the labels' shuffle) comes from one fixed seed, so every
    row set shares it; the numeric weights are scaled by 0.3, so the
    categories carry most of the signal.  ``unseen`` of the rows take a
    category never drawn in training (no offset) and ``nan`` of them
    NaN (no offset), per column.  Returns (X, y, the concept's logit,
    its numeric columns' part)."""
    concept = np.random.RandomState(71)
    w = concept.randn(28) * (concept.rand(28) > 0.3) * 0.3
    w[list(CAT_COLUMNS)] = 0.0
    offsets = [concept.randn(k) * 1.2 for k in CAT_CARDS]
    labels = [concept.permutation(k) for k in CAT_CARDS]
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 28).astype(np.float32).astype(np.float64)
    numeric = X @ w + 0.5 * np.sin(3 * X[:, 0]) * X[:, 1]
    logit = numeric.copy()
    for col, k, off, lab in zip(CAT_COLUMNS, CAT_CARDS, offsets, labels):
        p = 1.0 / np.arange(1, k + 1) ** 1.1
        rank = rng.choice(k, size=n, p=p / p.sum())
        X[:, col] = lab[rank]
        logit += off[rank]
        u = rng.rand(n)
        new = u < unseen
        X[new, col] = k + rng.randint(0, 5, int(new.sum()))
        logit[new] -= off[rank[new]]
        gone = (u >= unseen) & (u < unseen + nan)
        X[gone, col] = np.nan
        logit[gone] -= off[rank[gone]]
    y = (logit + rng.logistic(size=n) > 0).astype(np.float32)
    return X, y, logit, numeric


def cat_splits(models):
    """(feature, categories in the node's left set) of every categorical
    split of ``models``."""
    out = []
    for t in models:
        for i in range(t.num_leaves - 1):
            if t.decision_type[i] & 1:
                c = int(t.threshold[i])
                words = t.cat_threshold[t.cat_boundaries[c]:
                                        t.cat_boundaries[c + 1]]
                cats = {32 * j + b for j, wd in enumerate(words)
                        for b in range(32) if (wd >> b) & 1}
                out.append((int(t.split_feature[i]), cats))
    return out


def device_events_per_round(lgb, kernels, bst, dev):
    """One more iteration of ``bst`` under torch.profiler: (device events
    (kernels, memory sets and copies), grower rounds, their ratio, {op
    kind: (events, device ms) a round}); the rounds are kernel A's
    launches, one a round, and an op kind is a device event's function
    name (kernel_name).  None on the CPU or when the profiler recorded
    no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        return None
    for _ in range(3):      # a profile that recorded no device event
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bst.update()
            torch.cuda.synchronize()
        rounds = kernels.LAUNCHES["fused_route_hist"]
        kinds = {}
        for e in prof.key_averages():
            if getattr(e.device_type, "name", "") != "CUDA":
                continue
            n, us = kinds.get(kernel_name(e.key), (0, 0.0))
            kinds[kernel_name(e.key)] = (n + e.count, us + getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0)))
        events = sum(n for n, _ in kinds.values())
        if events and rounds:
            return events, rounds, events / rounds, {
                k: (n / rounds, us / 1e3 / rounds)
                for k, (n, us) in kinds.items()}
    return None


def event_breakdown(cat, num, top=12):
    """The op kinds whose device events a round grow most from the
    numeric run ``num`` to the categorical run ``cat`` (each
    device_events_per_round's last item): lines of (kind, events and
    device ms a round in both)."""
    def get(run, k):
        return run.get(k, (0, 0.0))
    kinds = sorted(set(cat) | set(num),
                   key=lambda k: get(num, k)[0] - get(cat, k)[0])[:top]
    return [f"{k}: {get(cat, k)[0]:.1f} events {get(cat, k)[1]:.4f} ms "
            f"categorical, {get(num, k)[0]:.1f} events {get(num, k)[1]:.4f} "
            "ms numeric" for k in kinds]


class CallTap:
    """Records each call to the named functions of ``owner`` (a module,
    learner/grower.py's kernel entry points by default, or a class) while
    it is entered: (arguments, keywords, result), tensor arguments of
    fewer than 2^22 elements cloned (a table, leaf ids, weights, values;
    the bins are held as they are).  The calls run as they would
    untapped; the records let them be held against the plain versions
    after the run, outside its launch counts (phases 7 and 8)."""

    def __init__(self, *names, owner=None):
        if owner is None:
            from lightgbm_tpu_torch.learner import grower as owner
        self.module, self.names, self.real = owner, names, {}
        self.calls = {n: [] for n in names}

    def __enter__(self):
        import torch

        def keep(a):
            return (a.clone() if isinstance(a, torch.Tensor)
                    and a.numel() < 1 << 22 else a)

        def tap(name, fn):
            def tapped(*args, **kw):
                kept = [keep(a) for a in args]
                out = fn(*args, **kw)
                self.calls[name].append((kept, kw, out))
                return out
            return tapped
        for n in self.names:
            self.real[n] = getattr(self.module, n)
            setattr(self.module, n, tap(n, self.real[n]))
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.module, n, fn)


def cat_high_rows(binsT, leaf, table, low=64, packed_groups=0):
    """Rows whose leaf splits on a categorical left set and whose chosen
    group's bin is ``low`` or above: rows that the route reads past the
    first ``low`` / 8 bytes of the left set for (``binsT`` the sub-byte
    storage under ``packed_groups``)."""
    from lightgbm_tpu_torch.ops.histogram import groups_of_storage
    from lightgbm_tpu_torch.ops.partition import packed_select_params
    G = groups_of_storage(binsT.shape[0], packed_groups)
    L = table.shape[0]
    lf = leaf.clamp(0, L - 1).long()
    ok = ((leaf >= 0) & (leaf < L) & (table[lf, 10] > 0.5)
          & (table[lf, 7] > 0.5))
    grp = (table[lf, 0] * 256 + table[lf, 1]).long().clamp(0, G - 1)
    if not packed_groups:
        gb = binsT.gather(0, grp[None]).squeeze(0)
    else:
        byte, shift, mask = packed_select_params(grp.int(), packed_groups)
        gb = (binsT.gather(0, byte.long()[None]).squeeze(0).int()
              >> shift) & mask
    return int((ok & (gb >= low)).sum())


def hold_tapped(tap, label):
    """Phases 7, 8 and 10: every kernel call a tapped run made, held bit
    for bit against the kernel's plain version on the same inputs (A's,
    G's and J's dequantized histograms, A's, B's, D's and H's leaf ids,
    B's row values; D's f32 histogram within one f32 ulp of each bin's
    absolute sum, hold_hist), on the byte-wide bins or the sub-byte
    storage the call was given.  Returns {kernel: (calls held, rows
    routed by a categorical bin of 64 or above)}."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    out = {}

    def tally(name, high):
        calls, rows = out.get(name, (0, 0))
        out[name] = (calls + 1, rows + high)

    def spec_of(args, kw, at):
        return args[at] if len(args) > at else kw.get("packed_groups", 0)

    for args, kw, got in tap.calls.get(
            "compute_group_histograms_fused_tiled", ()):
        binsT, wT, scales, leaf, table, slots = args
        spec = kw.get("packed_groups", 0)
        h, lp = H.fused_route_hist_plain(binsT, wT, leaf, table, slots,
                                         kw["max_group_bin"], spec)
        if not (torch.equal(got[0], h.to(torch.float32) * scales)
                and torch.equal(got[1], lp)):
            raise AssertionError(f"{label}: kernel A's call "
                                 f"{out.get('fused_route_hist', (0,))[0]} "
                                 "differs from its plain version")
        tally("fused_route_hist", cat_high_rows(binsT, leaf, table,
                                                packed_groups=spec))
    for args, kw, got in tap.calls.get(
            "compute_group_histograms_q_tiled", ()):
        binsT, wT, scales, leaf, slots = args
        want = H.tiled_hist_plain(binsT, wT, leaf, slots,
                                  kw["max_group_bin"],
                                  kw.get("packed_groups", 0))
        if not torch.equal(got, want.to(torch.float32) * scales):
            raise AssertionError(f"{label}: kernel G's histogram differs "
                                 "from its plain version")
        tally("tiled_hist", 0)
    for args, kw, got in tap.calls.get("compute_group_histograms_fused",
                                       ()):
        ohb, binsT, wT, scales, leaf, table, slots = args
        spec = kw.get("packed_groups", 0)
        hk = dict(max_group_bin=kw["max_group_bin"], pack=kw["pack"],
                  num_groups=kw["num_groups"])
        hp, lp = H.fused_onehot_hist_plain(ohb, binsT, wT, leaf, table,
                                           slots, packed_groups=spec, **hk)
        if not torch.equal(got[1], lp):
            raise AssertionError(f"{label}: kernel D's route differs from "
                                 "its plain version")
        if kw.get("quant"):
            if not torch.equal(got[0], hp.to(torch.float32) * scales):
                raise AssertionError(f"{label}: kernel D's int8 histogram "
                                     "differs from its plain version")
        else:
            hold_hist(f"{label}: kernel D", got[0], hp, H.onehot_hist_plain(
                ohb, wT.t().abs(), lp, slots, **hk))
        tally("fused_onehot_hist", cat_high_rows(binsT, leaf, table,
                                                 packed_groups=spec))
    for args, kw, got in tap.calls.get("route_apply_tiled", ()):
        binsT, leaf, table, values = args[:4]
        spec = spec_of(args, kw, 4)
        lp, vp = H.route_apply_plain(binsT, leaf, table, values, spec)
        if not (torch.equal(got[0], lp) and torch.equal(
                got[1].view(torch.int32), vp.view(torch.int32))):
            raise AssertionError(f"{label}: kernel B's exit route differs "
                                 "from its plain version")
        tally("route_apply", cat_high_rows(binsT, leaf, table,
                                           packed_groups=spec))
    for args, kw, got in tap.calls.get("route_only_tiled", ()):
        binsT, leaf, table = args[:3]
        spec = spec_of(args, kw, 3)
        if not torch.equal(got, H.route_only_plain(binsT, leaf, table,
                                                   spec)):
            raise AssertionError(f"{label}: kernel H's route differs from "
                                 "its plain version")
        tally("route_only", cat_high_rows(binsT, leaf, table,
                                          packed_groups=spec))
    for args, kw, got in tap.calls.get(
            "compute_group_histograms_seg_tiled", ()):
        binsT_p, wT_p, scales, blk_slot = args
        want = H.seg_hist_plain(binsT_p, wT_p, blk_slot, kw["num_out"],
                                kw["max_group_bin"],
                                packed_groups=kw.get("packed_groups", 0))
        if not torch.equal(got, want.to(torch.float32) * scales):
            raise AssertionError(f"{label}: kernel J's histogram differs "
                                 "from its plain version")
        tally("seg_hist", 0)
    return out


def hold_wide_tables(bst, dev, card):
    """Phase 7: kernels A, B, H and J on the grower's own (G, N) bins of
    the categorical run ``bst`` (max_group_bin 256: the 400-category
    column) under a random route table of 255 leaves whose categorical
    leaves split the categorical columns' groups with random left sets
    over all 256 bins, bit for bit against the plain versions; at least
    one row must be routed by a bin of 64 or above.  Returns the rows
    so routed."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops.partition import block_slots
    g = bst.gbdt.grower
    binsT, B, L, W = g.binsT, g.max_group_bin, 255, 126
    G, n = binsT.shape
    rng = np.random.RandomState(27)
    table = random_route_table(rng, L, G, B, cat_frac=0.5,
                               cat_groups=g.f_group[g.cat_idx].cpu().numpy()
                               ).to(dev)
    leaf = rng.randint(0, L, n).astype(np.int32)
    leaf[rng.rand(n) < 0.01] = -1
    leaf = torch.from_numpy(leaf).to(dev)
    grad = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    hess = torch.from_numpy(rng.rand(n).astype(np.float32) * 0.25).to(dev)
    counts = (leaf >= 0).to(torch.float32)
    wq, _ = H.quantize_gradients(grad * counts, hess * counts, counts)
    wT = wq.t().contiguous()
    slots = torch.from_numpy(rng.permutation(2 * L)[:W].astype(
        np.int32)).to(dev)
    values = torch.from_numpy(rng.randn(L).astype(np.float32)).to(dev)
    h_k, l_k = H.fused_route_hist(binsT, wT, leaf, table, slots, B)
    h_p, l_p = H.fused_route_hist_plain(binsT, wT, leaf, table, slots, B)
    if not (torch.equal(h_k, h_p) and torch.equal(l_k, l_p)):
        raise AssertionError("phase 7 wide table: kernel A != plain")
    lk, vk = H.route_apply_tiled(binsT, leaf, table, values)
    lp, vp = H.route_apply_plain(binsT, leaf, table, values)
    if not (torch.equal(lk, lp) and torch.equal(
            vk.view(torch.int32), vp.view(torch.int32))):
        raise AssertionError("phase 7 wide table: kernel B != plain")
    if not torch.equal(H.route_only_tiled(binsT, leaf, table),
                       H.route_only_plain(binsT, leaf, table)):
        raise AssertionError("phase 7 wide table: kernel H != plain")
    # J on the partition of the routed rows (padded as the grower pads)
    pad = -n % H.SEG_BLOCK
    binsT_p, wT_p, blk_leaf = partition(
        torch.nn.functional.pad(binsT, (0, pad)),
        torch.nn.functional.pad(wT, (0, pad)),
        torch.nn.functional.pad(l_p, (0, pad), value=-1), 2 * L)
    args = (binsT_p, wT_p, block_slots(blk_leaf, slots, 2 * L), W, B)
    hold_hist("phase 7 wide table: seg_hist", H.seg_hist(*args),
              H.seg_hist_plain(*args), None)
    high = cat_high_rows(binsT, leaf, table)
    if high == 0:
        raise AssertionError("phase 7 wide table: no row was routed by a "
                             "categorical bin of 64 or above")
    print(f"[phase 7] kernels A, B, H and J on (a)'s {G} x {n} bins "
          f"(max_group_bin {B}) under a random 255-leaf table of "
          f"{table.shape[1]} columns: equal to the plain versions bit for "
          f"bit; {high} rows routed by a categorical bin of 64 or above "
          f"({card})")
    return high



def check_categorical(lgb, kernels, params, dev, card, n_rows, n_valid,
                      p3_ms, plan_runs):
    """Phase 7: categorical columns and forced splits at the bench shape
    through lgb.train (kernels A and B on fused_tiled; H and J on
    seg_tiled) and Booster.predict (kernel C), each run's launches
    counted on their own; every kernel call of (a) and (b) held against
    its plain version after the run, and A, B, H and J on (a)'s bins
    under a table whose left sets reach bin 255.  ``p3_ms`` is phase
    3's numeric fused_tiled ms/tree.  Returns the numbers for the
    kernels line."""
    import os
    import tempfile

    import torch
    cols = list(CAT_COLUMNS)
    t0 = time.perf_counter()
    X, y, _, _ = make_cat_data(n_rows, 17)
    Xv, yv, concept, numeric = make_cat_data(n_valid, 18, unseen=0.03,
                                             nan=0.02)
    cfg = lgb.Config.from_params(params)
    sets = {}
    for kind, cats in (("categorical", cols), ("numeric", [])):
        d = lgb.Dataset(X, label=y, categorical_feature=cats)
        v = lgb.Dataset(Xv, label=yv, reference=d)
        v.construct_aligned(d.construct(cfg), cfg)  # binned before the clock
        sets[kind] = (d, v)
    core = sets["categorical"][0].construct(cfg)
    bins = [core.features[j].num_bin for j in range(len(core.features))
            if core.features[j].feature_idx in cols]
    print(f"[phase 7] {n_rows} training and {n_valid} held-out rows, "
          f"columns {cols} categorical with {list(CAT_CARDS)} categories "
          f"({bins} bins; 3% of held-out values unseen, 2% NaN), binned "
          f"in {time.perf_counter() - t0:.1f} s; on the held-out rows the "
          f"concept's own logit scores AUC {auc_score(yv, concept):.4f}, "
          f"its numeric columns' part {auc_score(yv, numeric):.4f}")

    def run(label, run_params, kind, rounds, want, tap=None):
        d, v = sets[kind]
        evals = {}
        kernels.reset_launches()
        t1 = time.perf_counter()
        with tap or contextlib.nullcontext():
            bst = lgb.train(run_params, d, rounds, valid_sets=[v],
                            valid_names=["valid"], evals_result=evals,
                            verbose_eval=False, keep_training_booster=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1) / rounds
        launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
        need_launches(dev, label, launches, want)
        for name, count in launches.items():
            plan_runs.setdefault(name, {})[f"phase 7 {label}"] = count
        auc = evals["valid"]["auc"][-1]
        print(f"[phase 7] {label}: plan {bst.gbdt.grower.plan.name}, "
              f"{bst.num_trees()} trees, {ms:.1f} ms/tree (wall of lgb.train "
              f"over trees; {card}); held-out AUC {auc:.4f}; launches "
              f"{launches}")
        return bst, ms, auc, launches

    def hold(tap, label):
        held = hold_tapped(tap, label)
        tap.calls.clear()
        print(f"[phase 7] {label}: every kernel call held bit for bit "
              "against its plain version on the same inputs (kernel: "
              "calls, rows routed by a categorical bin of 64 or above): "
              f"{held}")
        for name, (calls, high) in held.items():
            extra.setdefault(name, {})[f"phase7_{label[1]}_held_calls"] = \
                calls
            extra[name][f"phase7_{label[1]}_high_cat_rows"] = high

    extra = {}
    train = ("fused_route_hist", "route_apply")
    # (a) fused_tiled, 10 trees, the four columns categorical; then the
    # same rows with the four columns numeric
    tap = CallTap("compute_group_histograms_fused_tiled",
                    "route_apply_tiled")
    bst_a, a_ms, a_auc, a_launch = run("(a) categorical fused_tiled",
                                       params, "categorical", 10, train,
                                       tap)
    if bst_a.gbdt.grower.plan.name != "fused_tiled":
        raise AssertionError("(a) did not resolve fused_tiled")
    hold(tap, "(a) categorical fused_tiled")
    wide = hold_wide_tables(bst_a, dev, card)
    splits = cat_splits(bst_a.models)
    onehot = [s for f, s in splits if f == cols[0]]
    sorted_multi = [s for f, s in splits if f in cols[1:] and len(s) > 1]
    if not onehot or not sorted_multi:
        raise AssertionError(f"(a): {len(onehot)} one-hot splits on column "
                             f"{cols[0]}, {len(sorted_multi)} sorted-mode "
                             "splits of several categories")
    # the rehearsal's 4,000 rows reach 0.76
    floor = AUC_FLOOR_CATEGORICAL if n_rows >= 1_000_000 else 0.75
    if a_auc <= floor:
        raise AssertionError(f"(a): held-out AUC {a_auc:.4f} is not above "
                             f"{floor}")
    bst_n, n_ms, n_auc, _ = run("(a) the same columns numeric", params,
                                "numeric", 10, train)
    per_tree = {k: a_launch.get(k, 0) / 10 for k in train}
    print(f"[phase 7] (a) {len(splits)} categorical splits ({len(onehot)} "
          f"one-hot on column {cols[0]}, {len(sorted_multi)} sorted-mode "
          f"with several categories); AUC {a_auc:.4f} categorical, "
          f"{n_auc:.4f} numeric; {a_ms:.1f} ms/tree categorical, {n_ms:.1f} "
          f"numeric, phase 3's numeric fused_tiled "
          f"{fmt_ms(p3_ms)}; launches a tree {per_tree} ({card})")

    # (d) Booster.predict of (a)'s model through kernel C, against the
    # host walk, pred_leaf and the held-out set's binned walk.  (a)'s
    # booster keeps its training session, and its predict() of 200,000
    # rows x 10 trees takes the binned scan on the card (the JAX
    # package's rule from 2M rows x trees): the model loaded from its
    # text (thresholds and leaves to 20 digits, the same trees) goes
    # through C
    served_a = lgb.Booster(model_str=bst_a.model_to_string(),
                           params={"device": dev.type})
    kernels.reset_launches()
    t1 = time.perf_counter()
    raw = served_a.predict(Xv, raw_score=True)
    d_ms = 1e3 * (time.perf_counter() - t1)
    d_launch = {k: n for k, n in kernels.LAUNCHES.items() if n}
    if dev.type == "cuda" and d_launch.get("predict_level", 0) <= 0:
        raise AssertionError("(d): Booster.predict did not launch "
                             "predict_level")
    for name, count in d_launch.items():
        plan_runs.setdefault(name, {})["phase 7 (d)"] = count
    host = np.zeros(n_valid)
    for t in bst_a.models:
        host += t.predict(Xv)
    err_d = float(np.abs(raw - host).max())
    if err_d > TOL_PREDICT * (1 + np.abs(host).max()):
        raise AssertionError(f"(d): kernel C is {err_d:.3g} from the host "
                             "walk")
    leaves = bst_a.predict(Xv, pred_leaf=True)
    by_leaf = np.zeros(n_valid)
    for i, t in enumerate(bst_a.models):
        by_leaf += t.leaf_value[leaves[:, i]]
    if not np.array_equal(leaves, np.stack(
            [t.predict_leaf(Xv) for t in bst_a.models], axis=1)) \
            or np.abs(by_leaf - host).max() > 1e-9 * (1 + np.abs(host).max()):
        raise AssertionError("(d): pred_leaf does not land the host walk's "
                             "leaves")
    # the held-out set's scores from training (the binned walk through
    # the bin masks) on the rows whose categories training saw; an
    # unseen or NaN category is binned into the last bin, which on a
    # column with every category kept and no NaN is a category of its
    # own, so there the binned walk may go where the category set does
    # not (as in the JAX package)
    odd = np.isnan(Xv[:, cols]).any(axis=1) | (
        Xv[:, cols] >= np.array(CAT_CARDS)).any(axis=1)
    binned = bst_a.gbdt.valid_sets[0].scores.reshape(-1).cpu().numpy(
        ).astype(np.float64)
    err_binned = float(np.abs(binned - raw)[~odd].max())
    if err_binned > TOL_PREDICT * (1 + np.abs(host).max()):
        raise AssertionError(f"(d): the held-out set's binned walk is "
                             f"{err_binned:.3g} from kernel C")
    odd_off = int((np.abs(binned - raw)[odd] > TOL_PREDICT * (
        1 + np.abs(host).max())).sum())
    pred_auc = auc_score(yv, 1.0 / (1.0 + np.exp(-raw)))
    print(f"[phase 7] (d) Booster.predict of {n_valid} rows ({int(odd.sum())} "
          f"with an unseen or NaN category): {d_ms:.1f} ms, launches "
          f"{d_launch}; max |d| {err_d:.3g} from the host walk over every "
          f"row; {err_binned:.3g} from the binned walk of training over "
          f"the rows of seen categories ({odd_off} of the others score "
          f"otherwise there); pred_leaf lands the host walk's leaves; AUC "
          f"{pred_auc:.4f} ({card})")

    # the device events a round: the categorical finder's cost
    ev_cat = device_events_per_round(lgb, kernels, bst_a, dev)
    ev_num = device_events_per_round(lgb, kernels, bst_n, dev)
    if ev_cat and ev_num:
        print(f"[phase 7] (a) device events a grower round (torch.profiler, "
              f"one more iteration): categorical {ev_cat[0]} over "
              f"{ev_cat[1]} rounds = {ev_cat[2]:.1f}, numeric {ev_num[0]} "
              f"over {ev_num[1]} rounds = {ev_num[2]:.1f} ({card}); the op "
              "kinds that grow most, a round:")
        for line in event_breakdown(ev_cat[3], ev_num[3]):
            print(f"[phase 7]   {line}")
    else:
        print("[phase 7] (a) device events a grower round: not measured")
    del bst_n

    # (b) seg_tiled, 3 trees: (a)'s first 3 trees
    tap = CallTap("route_only_tiled", "compute_group_histograms_seg_tiled",
                    "route_apply_tiled")
    bst_b, b_ms, _, _ = run("(b) categorical seg_tiled",
                            dict(params, hist_leaf_partition="on"),
                            "categorical", 3,
                            ("route_only", "seg_hist", "route_apply"), tap)
    if bst_b.gbdt.grower.plan.name != "seg_tiled(leaf_partition)":
        raise AssertionError("(b) did not resolve seg_tiled")
    hold(tap, "(b) categorical seg_tiled")
    if bst_b.model_to_string() != bst_a.model_to_string(3):
        raise AssertionError("(b): the seg_tiled model text differs from "
                             "(a)'s first 3 trees")
    print("[phase 7] (b) the seg_tiled model text equals (a)'s first 3 "
          "trees")
    del bst_b

    # (c) forced splits from a JSON spec: the root on column 25's most
    # frequent category, its left child on column 0 at 0.0; then an
    # impossible threshold, which falls back to (a)'s root
    cat = int(np.bincount(X[:, cols[1]].astype(int)).argmax())
    tmp = tempfile.mkdtemp()
    spec = os.path.join(tmp, "forced.json")
    bad = os.path.join(tmp, "impossible.json")
    with open(spec, "w") as f:
        json.dump({"feature": cols[1], "threshold": cat,
                   "left": {"feature": 0, "threshold": 0.0}}, f)
    with open(bad, "w") as f:
        json.dump({"feature": 0, "threshold": 1e9}, f)
    try:
        bst_c, c_ms, _, _ = run("(c) forced splits", dict(
            params, forcedsplits_filename=spec), "categorical", 3, train)
        for i, t in enumerate(bst_c.models):
            left = int(t.left_child[0])
            if not (int(t.split_feature[0]) == cols[1]
                    and t.decision_type[0] & 1 and left >= 0
                    and int(t.split_feature[left]) == 0
                    and abs(t.threshold[left]) < 0.1):
                raise AssertionError(f"(c): tree {i} is not forced as the "
                                     "spec says")
        root_cats = [s for f, s in cat_splits([bst_c.models[0]])][0]
        if root_cats != {cat}:
            raise AssertionError(f"(c): the root's left set is {root_cats}, "
                                 f"not {{{cat}}}")
        del bst_c
        bst_f, _, _, _ = run("(c) an impossible threshold", dict(
            params, forcedsplits_filename=bad), "categorical", 1, train)
        ta, tf = bst_a.models[0], bst_f.models[0]
        if (int(tf.split_feature[0]), tf.threshold[0]) != (
                int(ta.split_feature[0]), ta.threshold[0]):
            raise AssertionError("(c): the impossible spec did not fall back "
                                 "to the unforced root")
        del bst_f
    finally:
        for path in (spec, bad):
            if os.path.exists(path):
                os.remove(path)
        os.rmdir(tmp)
    print(f"[phase 7] (c) every tree's root splits column {cols[1]} on "
          f"category {cat} and its left child column 0 at 0.0; the "
          "impossible threshold fell back to (a)'s root")
    del bst_a
    for name in ("fused_route_hist", "route_apply", "route_only",
                 "seg_hist"):
        extra.setdefault(name, {})["phase7_wide_table_max_abs_err"] = 0.0
    extra["route_apply"]["phase7_wide_table_high_cat_rows"] = wide
    extra["fused_route_hist"].update({
                "phase7_a_ms_per_tree": a_ms,
                "phase7_numeric_ms_per_tree": n_ms,
                "phase7_auc_categorical": a_auc,
                "phase7_auc_numeric": n_auc,
                "phase7_launches_per_tree": per_tree,
                "phase7_device_events_per_round": {
                    "categorical": ev_cat and ev_cat[2],
                    "numeric": ev_num and ev_num[2]},
                "phase7_b_ms_per_tree": b_ms,
                "phase7_c_ms_per_tree": c_ms})
    extra["predict_level"] = {"phase7_d_ms": d_ms,
                              "phase7_d_max_abs_err": err_d}
    return extra


# ---------------------------------------------------------------------------
# phase 8: the random streams (bagging, GOSS, DART, RF, stochastic int8
# rounding) and lambdarank over query groups
# ---------------------------------------------------------------------------
#: bench.py run_ltr_scale's shape (bench.py:538-556): training queries,
#: held-out queries, and its gate over the untrained NDCG@10
LTR_QUERIES, LTR_VALID_QUERIES = 18_900, 2_000
NDCG_GATE = 0.03
#: the lambdas on the card against the same torch ops on the CPU,
#: |d| <= LAMBDA_TOL * max |g| (tests/test_torch_lambdarank.py's bound
#: against the JAX package)
LAMBDA_TOL = 1e-6


def make_ltr_data(n_queries, f=136, seed=11, docs_lo=60, docs_hi=180,
                  w=None):
    """Synthetic MS-LTR-shaped ranking task (bench.py make_ltr_data):
    variable-size queries, graded 0-4 relevance from a noisy latent
    score with a per-query offset."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(docs_lo, docs_hi + 1, size=n_queries)
    n = int(sizes.sum())
    X = rng.randn(n, f).astype(np.float32)
    if w is None:
        w = (rng.randn(f) * (rng.rand(f) > 0.5)).astype(np.float32)
    latent = X @ w + np.repeat(rng.randn(n_queries) * 2.0, sizes) \
        + rng.randn(n).astype(np.float32) * 2.0
    qs = np.quantile(latent, [0.55, 0.78, 0.90, 0.97])
    y = np.digitize(latent, qs).astype(np.float32)
    return X.astype(np.float64), y, sizes, w


def ndcg_at_k(y, s, sizes, k=10):
    """Mean NDCG@k over queries, gain 2^label - 1, log2 discounts
    (bench.py ndcg_at_k)."""
    out = []
    start = 0
    for sz in sizes:
        yl = y[start:start + sz]
        sl = s[start:start + sz]
        start += sz
        kk = min(k, sz)
        order = np.argsort(-sl, kind="stable")[:kk]
        gains = 2.0 ** yl[order] - 1
        disc = 1.0 / np.log2(np.arange(2, kk + 2))
        dcg = float(np.sum(gains * disc))
        best = np.sort(yl)[::-1][:kk]
        idcg = float(np.sum((2.0 ** best - 1) * disc))
        out.append(dcg / idcg if idcg > 0 else 0.0)
    return float(np.mean(out))


def after_each_iteration(read):
    """A training callback that keeps ``read(gbdt)`` after every
    iteration; returns (callback, the list it fills)."""
    seen = []

    def callback(env):
        seen.append(read(env.model.gbdt))
    return callback, seen


def bag_masks_on_host(seed, n_iter, freq, frac, n, n_padded):
    """The objective path's bag of each iteration recomputed on the host
    from its key stream (utils/prng.py): one randint of
    RandomState(bagging_seed) an iteration, PRNGKey of it, the first
    half of its split drawing n_padded uniforms every ``freq``
    iterations; padded rows never in."""
    import torch
    from lightgbm_tpu_torch.utils import prng
    rs = np.random.RandomState(seed)
    out, mask = [], None
    for it in range(n_iter):
        kb, _ = prng.split(prng.PRNGKey(int(rs.randint(0, 2**31 - 1))))
        if it % freq == 0 or mask is None:
            mask = (prng.uniform(kb, (n_padded,)) < frac) & (
                torch.arange(n_padded) < n)
        out.append(mask)
    return out


def root_count(tree) -> int:
    return int(tree.internal_count[0] if tree.num_leaves > 1
               else tree.leaf_count[0])


def check_sampling(lgb, kernels, params, train_ds, valid_ds, X, Xv, yv,
                   dev, card, rehearse, p3_auc, plan_runs):
    """Phase 8: bagging, GOSS, DART and RF at the bench shape and
    lambdarank at bench.py's ranking shape, all on fused_tiled through
    lgb.train (kernels A and B; every call tapped and held against the
    plain versions after its run) and Booster.predict (kernel C), each
    run's launches counted on their own.  Returns the numbers for the
    kernels line."""
    import torch
    from lightgbm_tpu_torch.boosting.goss import GOSS
    from lightgbm_tpu_torch.ops import histogram as kernels_api
    from lightgbm_tpu_torch.ops import predict as P
    train = ("fused_route_hist", "route_apply")
    extra = {"fused_route_hist": {}, "route_apply": {}, "predict_level": {}}
    n = X.shape[0]

    def run(label, run_params, rounds, tset, vset, callbacks=(), taps=(),
            time_a=False):
        evals = {}
        tap = CallTap("compute_group_histograms_fused_tiled",
                      "route_apply_tiled")
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for t in (tap,) + tuple(taps):
                stack.enter_context(t)
            bst = lgb.train(run_params, tset, rounds, valid_sets=[vset],
                            valid_names=["valid"], evals_result=evals,
                            verbose_eval=False, keep_training_booster=True,
                            callbacks=list(callbacks))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / rounds
        launches = {k: c for k, c in kernels.LAUNCHES.items() if c}
        need_launches(dev, label, launches, train)
        if bst.gbdt.grower.plan.name != "fused_tiled":
            raise AssertionError(f"{label}: resolved "
                                 f"{bst.gbdt.grower.plan.name}")
        for name, count in launches.items():
            plan_runs.setdefault(name, {})[f"phase 8 {label}"] = count
        if time_a:
            time_kernel_a(tap, label)
        held = hold_tapped(tap, label)
        for name, (calls, _) in held.items():
            extra[name][f"phase8_{label[1]}_held_calls"] = calls
        extra["fused_route_hist"][f"phase8_{label[1]}_ms_per_iter"] = ms
        metric = next(iter(evals["valid"].values()))[-1]
        print(f"[phase 8] {label}: {bst.num_trees()} trees, {ms:.1f} ms an "
              f"iteration (wall of lgb.train over iterations, the "
              f"evaluation and this phase's per-iteration readback "
              f"included; {card}); held-out "
              f"{next(iter(evals['valid']))} {metric:.4f}; launches "
              f"{launches}; every A and B call held bit for bit against "
              f"its plain version (kernel: calls) "
              f"{ {k: c for k, (c, _) in held.items()} }")
        return bst, ms, metric, evals

    def time_kernel_a(tap, label):
        """Kernel A on two of the run's own calls (a tree's first round,
        every row in one slot; and its middle call), events around the
        wrapper's call, beside the bytes bound: each landed row's bins,
        weights and leaf id read and its leaf id written once; and the
        library call, one torch._int_mm of the same int32 histogram from
        the calls' post-route leaf ids (the column-major int8 one-hot of
        the run's bins built once for both, then freed)."""
        calls = tap.calls["compute_group_histograms_fused_tiled"]
        oh = int8_onehot(calls[0][0][0].t(), calls[0][1]["max_group_bin"])
        for which, (args, kw, got) in (("first round", calls[0]),
                                       ("middle call",
                                        calls[len(calls) // 2])):
            binsT, slots = args[0], args[5]
            G, N = binsT.shape
            landed = int(torch.isin(got[1], slots).sum())
            ms = time_ms(
                lambda: kernels_api.compute_group_histograms_fused_tiled(
                    *args, **kw), dev, 1 if rehearse else 10)
            bound = (landed * (G + 12) + 8 * N) / MEM_BYTES_PER_S * 1e3
            lib = int8_library_ms(got[1], slots, args[1], oh, dev,
                                  1 if rehearse else 10)
            key = "first" if which == "first round" else "middle"
            extra["fused_route_hist"][f"phase8_{label[1]}_{key}_ms"] = ms
            extra["fused_route_hist"][
                f"phase8_{label[1]}_{key}_bound_ms"] = bound
            extra["fused_route_hist"][
                f"phase8_{label[1]}_{key}_library_ms"] = lib
            print(f"[phase 8] {label}: kernel A at {G} groups, {which} "
                  f"({slots.shape[0]} slots, {landed} rows landed): "
                  f"{ms:.4f} ms the call (events), bound {bound:.4f} ms "
                  f"(bytes), library (torch._int_mm) {lib:.4f} ms "
                  f"({card})")
        del oh
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def predicted(label, fn):
        kernels.reset_launches()
        out = fn()
        launches = {k: c for k, c in kernels.LAUNCHES.items() if c}
        need_launches(dev, label, launches, ("predict_level",))
        for name, count in launches.items():
            plan_runs.setdefault(name, {})[f"phase 8 {label}"] = count
        return out

    # (a) bagging: each iteration's bag recomputed on the host
    a_params = dict(params, bagging_fraction=0.7, bagging_freq=2,
                    feature_fraction=0.8)
    seed = lgb.Config.from_params(a_params).bagging_seed
    keep_mask, masks = after_each_iteration(lambda g: g._bag_state.cpu())
    bst, _, a_auc, _ = run("(a) bagging", a_params, 6, train_ds, valid_ds,
                           (keep_mask,))
    want = bag_masks_on_host(seed, 6, 2, 0.7, n, bst.gbdt.grower.n_padded)
    for it, (got, mask) in enumerate(zip(masks, want)):
        if not torch.equal(got, mask):
            raise AssertionError(f"(a): iteration {it}'s bag differs from "
                                 "the host's recomputation")
        if root_count(bst.models[it]) != int(mask.sum()):
            raise AssertionError(f"(a): tree {it}'s root count "
                                 f"{root_count(bst.models[it])} is not its "
                                 f"bag's {int(mask.sum())}")
    shares = [float(m[:n].float().mean()) for m in masks[::2]]
    # 0.5%, or four standard deviations of the share where that is wider
    # (the rehearsal's few rows)
    if max(abs(s - 0.7) for s in shares) > max(
            0.005, 4 * (0.7 * 0.3 / n) ** 0.5):
        raise AssertionError(f"(a): in-bag shares {shares}")
    print(f"[phase 8] (a) the 6 bags equal their host recomputation bit for "
          f"bit; each tree's root count is its bag's size; in-bag shares of "
          f"the 3 fresh bags {[round(s, 5) for s in shares]}")
    extra["fused_route_hist"]["phase8_a_in_bag_shares"] = shares
    del bst

    # (b) GOSS: sampling from iteration int(1 / 0.5) = 2; every sample
    # recomputed on the host from the card's own gradients and key
    b_params = dict(params, boosting_type="goss", top_rate=0.2,
                    other_rate=0.1, learning_rate=0.5)
    gtap = CallTap("_goss_sample", owner=GOSS)
    bst, _, b_auc, _ = run("(b) GOSS", b_params, 5, train_ds, valid_ds,
                           taps=(gtap,))
    samples = gtap.calls["_goss_sample"]
    if len(samples) != 3:
        raise AssertionError(f"(b): {len(samples)} sampled iterations, "
                             "not 3")
    top_k = int(n * 0.2)
    kept = []
    for j, (args, _, got) in enumerate(samples):
        booster, g, h, counts, key = args
        want = GOSS._goss_sample(booster, g.cpu(), h.cpu(), counts.cpu(),
                                 key)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
            raise AssertionError(f"(b): iteration {2 + j}'s sample differs "
                                 "from the host's recomputation")
        keep = want[2] > 0
        score = (g.cpu() * h.cpu()).abs().sum(0)
        score = torch.where(counts.cpu() > 0, score,
                            torch.full_like(score, float("-inf")))
        n_top = int((score >= torch.topk(score, top_k).values[-1]).sum())
        tree = bst.models[2 + j]
        if n_top < top_k or root_count(tree) != int(keep.sum()):
            raise AssertionError(f"(b): tree {2 + j}: {n_top} top rows, "
                                 f"root count {root_count(tree)}, "
                                 f"{int(keep.sum())} kept")
        kept.append((n_top, int(keep.sum()) - n_top))
    print(f"[phase 8] (b) the 3 samples equal their host recomputation bit "
          f"for bit; (top rows, Bernoulli keeps) {kept} (top_k {top_k}, "
          f"other_k {int(n * 0.1)}), each the tree's root count")
    extra["fused_route_hist"]["phase8_b_top_and_kept"] = kept
    del bst

    # (c) DART: the trees' rescales against the tracked training scores
    c_params = dict(params, boosting_type="dart", drop_rate=0.5,
                    skip_drop=0.0)
    keep_drops, drops = after_each_iteration(lambda g: list(g.drop_index))
    bst, _, c_auc, _ = run("(c) DART", c_params, 5, train_ds, valid_ds,
                           (keep_drops,))
    if not any(drops):
        raise AssertionError("(c): no iteration dropped a tree")
    m = min(n, 200_000)
    tracked = bst.gbdt.scores[0, :m].cpu().numpy().astype(np.float64)
    raw = predicted("(c) predict", lambda: bst.predict(X[:m],
                                                       raw_score=True))
    err_c = float((np.abs(raw - tracked) / (1 + np.abs(tracked))).max())
    if err_c > TOL_PREDICT:
        raise AssertionError(f"(c): Booster.predict is {err_c:.3g} from the "
                             "tracked training scores")
    print(f"[phase 8] (c) drops {drops}, tree scales "
          f"{[round(v, 6) for v in bst.gbdt._tree_scale]}; Booster.predict "
          f"of {m} training rows within {err_c:.3g} x (1 + |s|) of the "
          "tracked training scores")
    extra["predict_level"]["phase8_c_max_rel_err"] = err_c
    del bst

    # (d) RF: kernel C's mean against the host walk's
    d_params = dict(params, boosting_type="rf", bagging_fraction=0.632,
                    bagging_freq=1, feature_fraction=0.8)
    bst, _, d_auc, _ = run("(d) RF", d_params, 5, train_ds, valid_ds)
    prob = predicted("(d) predict", lambda: bst.predict(Xv))
    host = np.mean([t.predict(Xv) for t in bst.models], axis=0)
    err_d = float(np.abs(prob - host).max())
    if err_d > TOL_PREDICT:
        raise AssertionError(f"(d): kernel C's mean is {err_d:.3g} from the "
                             "host walk's")
    print(f"[phase 8] (d) Booster.predict (the mean of 5 trees) within "
          f"{err_d:.3g} of the host walk's mean; held-out AUC "
          f"{auc_score(yv, prob):.4f} (phase 3's 10 boosted trees "
          f"{p3_auc:.4f})")
    extra["predict_level"]["phase8_d_max_abs_err"] = err_d
    del bst

    # (e) lambdarank at bench.py's ranking shape
    nq, nvq, lo, hi = ((300, 100, 20, 60) if rehearse
                       else (LTR_QUERIES, LTR_VALID_QUERIES, 60, 180))
    t0 = time.perf_counter()
    XL, yL, sizes, wL = make_ltr_data(nq, docs_lo=lo, docs_hi=hi)
    XLv, yLv, sizes_v, _ = make_ltr_data(nvq, seed=12, w=wL, docs_lo=lo,
                                         docs_hi=hi)
    e_params = {"objective": "lambdarank", "num_leaves": 255, "max_bin": 63,
                "learning_rate": 0.1, "verbose": 0, "min_data_in_leaf": 1,
                "min_sum_hessian_in_leaf": 100.0,
                "hist_compute_dtype": "bfloat16", "quantized_grad": True,
                "metric": "ndcg", "ndcg_eval_at": [10], "device": dev.type}
    cfg = lgb.Config.from_params(e_params)
    dL = lgb.Dataset(XL, label=yL, group=sizes)
    core = dL.construct(cfg)
    vL = lgb.Dataset(XLv, label=yLv, group=sizes_v, reference=dL)
    vL.construct_aligned(core, cfg)
    nL = core.num_data
    del XL
    print(f"[phase 8] (e) {nq} queries of {lo}-{hi} documents ({nL} rows) x "
          f"136 features, {nvq} held-out queries ({len(yLv)} rows): made "
          f"and binned once in {time.perf_counter() - t0:.1f} s, "
          f"{core.num_groups} groups")
    bst, e_ms, ndcg, _ = run("(e) lambdarank", e_params, 5, dL, vL,
                             time_a=True)
    if bst.gbdt.grower.num_groups != 136:
        raise AssertionError(f"(e): {bst.gbdt.grower.num_groups} groups")
    if not bst.gbdt._quant_stochastic():
        raise AssertionError("(e): lambdarank did not round stochastically")
    tracked_v = bst.gbdt.valid_sets[0].scores[0].cpu().numpy()
    ndcg_np = ndcg_at_k(yLv, tracked_v.astype(np.float64), sizes_v)
    if abs(ndcg - ndcg_np) > 1e-6:
        raise AssertionError(f"(e): the port's NDCG@10 {ndcg} is not "
                             f"bench.py's ndcg_at_k {ndcg_np}")
    pv = predicted("(e) predict", lambda: bst.predict(XLv, raw_score=True))
    # kernel C against the binned walk's held-out scores, row by row
    err_e = float((np.abs(pv - tracked_v) / (1 + np.abs(tracked_v))).max())
    if err_e > TOL_PREDICT:
        raise AssertionError(f"(e): Booster.predict is {err_e:.3g} x (1 + "
                             "|s|) from the tracked held-out scores")
    # and both tiers against the plain version at 136 features, where a
    # 512-row tile of (hi, lo) pairs no longer fits beside a tree: the
    # rows are read from device memory (stage_x off)
    pred = served(bst)
    x2 = torch.from_numpy(P.interleave_hi_lo(XLv)).to(dev)
    stage_x = P.level_plan(pred.records, x2.shape[0], x2.shape[1],
                           tier="shared").stage_x
    if not rehearse and stage_x:
        raise AssertionError("(e): the ranking model's rows are staged")
    held_c = check_level(P, P.unpack_level_records(pred.records), x2,
                         pred.depth, dev, 1 if rehearse else 5, card,
                         f"(e) {bst.num_trees()} ranking trees, depth "
                         f"{pred.depth}, {x2.shape[0]} rows x "
                         f"{XLv.shape[1]} features", phase=8)
    del x2
    ndcg_pred = ndcg_at_k(yLv, pv, sizes_v)
    ndcg0 = ndcg_at_k(yLv, np.zeros(len(yLv)), sizes_v)
    if not ndcg_pred >= ndcg0 + NDCG_GATE:
        raise AssertionError(f"(e): held-out NDCG@10 {ndcg_pred:.4f} does "
                             f"not clear the untrained {ndcg0:.4f} by "
                             f"{NDCG_GATE}")
    obj = bst.gbdt.objective
    s = bst.gbdt.scores[0, :nL]
    g_dev, h_dev = obj.get_gradients(s)
    host_obj = type(obj)(obj.config)
    host_obj.init(core.metadata, nL, torch.device("cpu"))
    g_cpu, h_cpu = host_obj.get_gradients(s.cpu())
    err_g = float((g_dev.cpu() - g_cpu).abs().max() / g_cpu.abs().max())
    err_h = float((h_dev.cpu() - h_cpu).abs().max() / h_cpu.abs().max())
    if max(err_g, err_h) > LAMBDA_TOL:
        raise AssertionError(f"(e): the card's lambdas are {err_g:.3g} "
                             f"(hessians {err_h:.3g}) of the largest from "
                             "the CPU's")
    lam_ms = time_ms(lambda: obj.get_gradients(s), dev,
                     1 if rehearse else 3)
    print(f"[phase 8] (e) held-out NDCG@10 {ndcg:.6f} by the port's metric, "
          f"{ndcg_np:.6f} by bench.py's ndcg_at_k on the same scores; "
          f"{ndcg_pred:.6f} on Booster.predict's scores (within "
          f"{err_e:.3g} x (1 + |s|) of the tracked ones; rows staged: "
          f"{stage_x}) against "
          f"{ndcg0:.6f} untrained; the card's lambdas of the last scores "
          f"within {err_g:.3g} (hessians {err_h:.3g}) of the largest from "
          f"the CPU's; one lambda pass {lam_ms:.1f} ms ({card})")
    extra["predict_level"]["phase8_e_max_rel_err_tracked"] = err_e
    for name, nums in held_c.items():
        extra.setdefault(name, {}).update(
            {f"phase8_e_{k}": v for k, v in nums.items()})
    extra["fused_route_hist"].update(
        phase8_e_groups=bst.gbdt.grower.num_groups, phase8_e_ndcg10=ndcg,
        phase8_e_ndcg10_untrained=ndcg0, phase8_e_lambda_ms=lam_ms,
        phase8_e_lambda_max_rel_err=max(err_g, err_h),
        phase8_auc={"a": a_auc, "b": b_auc, "c": c_auc, "d": d_auc})
    del bst
    return extra


# ---------------------------------------------------------------------------
# phase 9: prediction beyond the level descent
# ---------------------------------------------------------------------------
#: phase 9 (b)'s batch sizes: around the 16-row bucket, and a bucket
#: past 4,096
BATCH_SIZES = (1, 15, 16, 17, 33, 100, 1000, 4097)
#: phase 9 (c)'s chunk: 200,000 rows stream in 13 dispatches
CHUNK_ROWS = 16384


def wall_ms(fn, dev, reps):
    """Median host wall of ``fn`` over ``reps`` warm calls, each ended by
    a synchronize, ms (Booster.predict returns numpy, so its call
    includes the readback)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def check_serving(lgb, kernels, P, bst, texts, params, train_ds, Xv, dev,
                  card, rehearse):
    """Phase 9: the serving predictor and the other prediction paths of
    Booster.predict on the card at the bench's width, ``bst`` phase 3's
    model (its session freed, as lgb.train returns it), ``texts`` phase
    5's regression and 5-class models.  The counters are zeroed first;
    only the path's own calls are counted (comparisons and timing
    repeats are not).  Returns (numbers for predict_level, {kernel:
    launches on the path})."""
    import torch
    from lightgbm_tpu_torch.tree import flatten_ensemble
    kernels.reset_launches()
    path = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def drive(fn):
        before = dict(kernels.LAUNCHES)
        out = fn()
        sync()
        for k, v in kernels.LAUNCHES.items():
            if v > before[k]:
                path[k] = path.get(k, 0) + v - before[k]
        return out, sum(kernels.LAUNCHES[k] - before[k]
                        for k in ("predict_level", "predict_level_global"))

    def within(got, want, label, tol=TOL_PREDICT):
        err = float((np.abs(got - want) / (1 + np.abs(want))).max())
        if err > tol:
            raise AssertionError(f"(9{label}): {err:.3g} x (1 + |s|) from "
                                 "kernel C's scores")
        return err

    def same_bits(got, want, label):
        if not np.array_equal(np.asarray(got, np.float64),
                              np.asarray(want, np.float64)):
            raise AssertionError(f"phase 9 {label}: not bit for bit")

    res = {}
    n, F = Xv.shape
    reps = 2 if rehearse else 5
    on_card = dev.type == "cuda"      # kernel C launches (else the plain)
    text = bst.model_to_string()
    pred = served(bst)
    # (a) a warm 200,000-row call, step by step
    drive(lambda: bst.predict(Xv))
    parts = predict_breakdown(bst, Xv, dev, reps)
    print(f"[phase 9] (a) Booster.predict of {n} rows, warm (median of "
          f"{reps}): {parts['wall']:.2f} ms wall; " + "; ".join(
              f"{k} {v:.2f} ms" for k, v in parts.items() if k != "wall")
          + f" ({card})")
    res["phase9_a_ms_by_step"] = parts
    ab = upload_ab(P, pred, Xv, dev, reps)
    print(f"[phase 9] (a) one chunk of {n} rows, upload A/B (medians of "
          f"{2 * reps}, alternated): the predictor's pageable copy "
          f"{fmt_ms(ab['pageable'])}, pinned staging on a side stream "
          f"{fmt_ms(ab['pinned'])}, the same bits ({card})")
    res["phase9_a_upload_ab_ms"] = ab

    # (b) batch sizes around the buckets: kernel C's plain version on
    # the same padded bucket bit for bit, the host walk within 2e-5
    sizes = [m for m in BATCH_SIZES if m <= n]
    host = np.zeros(max(sizes))
    for t in bst.models:
        host += t.predict(Xv[:max(sizes)])
    cap = pred._chunk_cap(2 * F)
    lat = {}
    for m in sizes:
        P.reset_predict_telemetry()
        got, c = drive(lambda: bst.predict(Xv[:m], raw_score=True))
        b = pred._bucket(m, cap)
        if (on_card and c != 1) or P.PREDICT_TELEMETRY["buckets"] != {b}:
            raise AssertionError(f"(9b) {m} rows: {c} launches of C, buckets "
                                 f"{P.PREDICT_TELEMETRY['buckets']}")
        plain = P.predict_level_records_plain(
            pred.records, launched_x2(P, pred, Xv[:m], dev),
            depth=pred.depth)
        same_bits(got, plain[:m, 0].cpu().numpy(), f"(b) {m} rows")
        if not np.allclose(got, host[:m], rtol=2e-5, atol=2e-7):
            raise AssertionError(f"(9b) {m} rows: not within 2e-5 of the "
                                 "host walk")
        lat[m] = wall_ms(lambda: bst.predict(Xv[:m]), dev,
                         3 if rehearse else 20)
    print("[phase 9] (b) Booster.predict median latency, 20 warm calls: "
          + ", ".join(f"{m} rows {v:.3f} ms" for m, v in lat.items())
          + f"; each bit for bit kernel C's plain version on its bucket "
          f"({card})")
    res["phase9_b_latency_ms"] = lat

    # (c) 200,000 rows in chunks of 16,384: 13 dispatches, the same bits
    whole = bst.predict(Xv, raw_score=True)
    chunked = lgb.Booster(model_str=text, params={
        "device": dev.type, "predict_chunk_rows": CHUNK_ROWS})
    P.reset_predict_telemetry()
    got, c = drive(lambda: chunked.predict(Xv, raw_score=True))
    want_n = -(-n // CHUNK_ROWS)
    if P.PREDICT_TELEMETRY["dispatches"] != want_n or (on_card
                                                       and c != want_n):
        raise AssertionError(f"(9c): {P.PREDICT_TELEMETRY['dispatches']} "
                             f"dispatches, {c} launches of C, not {want_n}")
    same_bits(got, whole, "(c) chunk stream")
    c_ms = wall_ms(lambda: chunked.predict(Xv), dev, reps)
    print(f"[phase 9] (c) {n} rows in chunks of {CHUNK_ROWS}: {want_n} "
          f"dispatches (buckets {sorted(P.PREDICT_TELEMETRY['buckets'])}), "
          f"bit for bit one dispatch; {c_ms:.2f} ms warm against "
          f"{parts['wall']:.2f} in one ({card})")
    res["phase9_c_ms"] = c_ms

    # (d) the OOM ladder: an out-of-memory error at the first chunk's
    # dispatch halves the bucket, on the card
    cp = served(chunked)
    fired = []
    dispatch = cp._dispatch

    def failing(x2):
        if not fired:
            fired.append(x2.shape[0])
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return dispatch(x2)

    cp._dispatch = failing
    P.reset_predict_telemetry()
    got, c = drive(lambda: chunked.predict(Xv, raw_score=True))
    del cp._dispatch
    same_bits(got, whole, "(d) after the OOM ladder")
    if len(fired) != 1 or cp._oom_cap != fired[0] // 2 \
            or max(P.PREDICT_TELEMETRY["buckets"]) != cp._oom_cap:
        raise AssertionError(f"(9d): fired {fired}, cap {cp._oom_cap}, "
                             f"buckets {P.PREDICT_TELEMETRY['buckets']}")
    print(f"[phase 9] (d) an injected OutOfMemoryError at bucket "
          f"{fired[0]}: the ladder retried at {cp._oom_cap} on "
          f"{cp.device} ({P.PREDICT_TELEMETRY['dispatches']} dispatches, "
          f"{c} launches of C), the scores bit for bit")

    # (e) co-batch: the binary, regression and 5-class models in one
    # launch, each member's columns its solo launch bit for bit
    members = [bst] + [lgb.Booster(model_str=texts[k],
                                   params={"device": dev.type})
                       for k in ("regression", "multiclass")]
    stacks, depths = [], []
    for mb in members:
        flat = flatten_ensemble(mb.models, max(mb.num_tree_per_iteration, 1))
        depths.append(int(flat.pop("depth")))
        stacks.append(P.level_ensemble_from_numpy(flat, dev))
    x2 = P.split_hi_lo_device(torch.from_numpy(Xv).to(dev))
    ens, segments = P.cobatch_level_ensembles(stacks)
    rec = P.pack_level_records(ens)
    depth = max(depths)
    fused, c = drive(lambda: P.predict_level_ensemble_cobatch(
        rec, x2, depth=depth, segments=segments))
    if (on_card and c != 1) or fused.shape != (n, 7):
        raise AssertionError(f"(9e): {c} launches, shape {fused.shape}")
    same_bits(fused.cpu().numpy(), P.predict_level_records_plain(
        rec, x2, depth=depth).cpu().numpy(), "(e) against the plain version")
    recs = [P.pack_level_records(st) for st in stacks]
    for (t0, tn, k0, kn), r, d in zip(segments, recs, depths):
        solo = P.predict_level_ensemble(r, x2, depth=d)
        same_bits(fused[:, k0:k0 + kn].cpu().numpy(), solo.cpu().numpy(),
                  f"(e) member at trees {t0}-{t0 + tn - 1}")
    plan = P.level_plan(rec, n, x2.shape[1])
    e_ms = time_ms(lambda: P.predict_level_ensemble(rec, x2, depth=depth),
                   dev, reps)
    solo_ms = sum(time_ms(lambda r=r, d=d: P.predict_level_ensemble(
        r, x2, depth=d), dev, reps) for r, d in zip(recs, depths))
    print(f"[phase 9] (e) co-batch of {len(members)} models "
          f"({sum(s[1] for s in segments)} trees, K = 7, segments "
          f"{segments}) in one launch of C ({plan.tier} tier, "
          f"{plan.chunks} chunk(s) of {plan.trees_per_chunk} trees): "
          f"{e_ms:.4f} ms against {solo_ms:.4f} for the three solo "
          f"launches; each member bit for bit its solo launch ({card})")
    res.update(phase9_e_ms=e_ms, phase9_e_solo_ms=solo_ms)
    del x2

    # (f) the per-tree raw scan (predict_kernel=scan)
    scan = lgb.Booster(model_str=text, params={"device": dev.type,
                                              "predict_kernel": "scan"})
    got, c = drive(lambda: scan.predict(Xv, raw_score=True))
    err_f = within(got, whole, "f")
    if c:
        raise AssertionError("(9f): the scan launched kernel C")
    f_ms = wall_ms(lambda: scan.predict(Xv), dev, reps)
    print(f"[phase 9] (f) predict_kernel=scan: {f_ms:.2f} ms warm for {n} "
          f"rows against kernel C's {parts['wall']:.2f}; within {err_f:.3g} "
          f"x (1 + |s|) of C ({card})")
    res.update(phase9_f_ms=f_ms, phase9_f_max_rel_err=err_f)

    # (g) the binned scan: a 10-tree booster that keeps its session, at
    # 200,000 rows x 10 trees (the 2M switch), against kernel C
    sess = lgb.train(params, train_ds, 10, verbose_eval=False,
                     keep_training_booster=True)
    if not rehearse and not sess._can_device_predict(n, -1, None):
        raise AssertionError("(9g): 200,000 rows x 10 trees in session did "
                             "not route to the binned scan")
    P.reset_predict_telemetry()
    got, c = drive(lambda: sess.predict(Xv, raw_score=True, device=True))
    if c or P.PREDICT_TELEMETRY["dispatches"]:
        raise AssertionError("(9g): the binned scan launched kernel C")
    via_c = sess._device_predict_loaded(Xv, -1)[0][:, 0]
    err_g = within(got, via_c, "g")
    g_ms = wall_ms(lambda: sess.predict(Xv, device=True), dev, reps)
    gc_ms = wall_ms(lambda: sess._device_predict_loaded(Xv, -1), dev, reps)
    print(f"[phase 9] (g) binned scan of {n} rows x 10 trees in session: "
          f"{g_ms:.2f} ms warm (binning the rows included) against kernel "
          f"C's {gc_ms:.2f} ms on the same booster; within {err_g:.3g} x "
          f"(1 + |s|) ({card})")
    res.update(phase9_g_ms=g_ms, phase9_g_kernel_c_ms=gc_ms,
               phase9_g_max_rel_err=err_g)
    del sess

    # (h) pred_contrib on 200 rows, pred_early_stop on all
    rows = Xv[:200]
    t0 = time.perf_counter()
    contrib = bst.predict(rows, pred_contrib=True)
    h_ms = (time.perf_counter() - t0) * 1e3
    raw200 = bst.predict(rows, raw_score=True, device=False)
    err_h = float(np.abs(contrib.sum(axis=1) - raw200).max())
    if contrib.shape != (200, F + 1) or err_h > 1e-5:
        raise AssertionError(f"(9h): contributions of shape {contrib.shape} "
                             f"sum {err_h:.3g} from the raw scores")
    full = bst.predict(Xv, raw_score=True, device=False)
    t0 = time.perf_counter()
    early = bst.predict(Xv, raw_score=True, pred_early_stop=True,
                        pred_early_stop_freq=2, pred_early_stop_margin=1.5)
    es_ms = (time.perf_counter() - t0) * 1e3
    loose = bst.predict(Xv, raw_score=True, pred_early_stop=True,
                        pred_early_stop_freq=2, pred_early_stop_margin=1e9)
    if not (np.array_equal(np.sign(early), np.sign(full))
            and np.array_equal(loose, full)):
        raise AssertionError("(9h): pred_early_stop changed a decision, or "
                             "its 1e9 margin the scores")
    stopped = int((np.abs(early - full) > 0).sum())
    print(f"[phase 9] (h) pred_contrib of 200 rows x {F} features: "
          f"{h_ms:.1f} ms (host TreeSHAP), rows sum to the raw score within "
          f"{err_h:.3g}; pred_early_stop (margin 1.5 every 2 trees) of {n} "
          f"rows: {es_ms:.1f} ms, {stopped} rows stopped early, signs kept "
          f"({card})")
    res.update(phase9_h_contrib_ms=h_ms, phase9_h_early_stop_ms=es_ms)
    if not rehearse and not (path.get("predict_level", 0)
                             and path.get("predict_level_global", 0)):
        raise AssertionError(f"phase 9 did not launch both tiers of C: "
                             f"{path}")
    print(f"[phase 9] launches on the path: {path}")
    return res, path


# ---------------------------------------------------------------------------
# phase 10: sub-byte bin storage on the card
# ---------------------------------------------------------------------------
#: phase 10 (a)'s max_bin: every bench column fits a nibble under 4bit
PACKED_MAX_BIN = 15


def strip_packing(text: str) -> str:
    """A model text without its bin_packing echo, the one line the
    storage layout may change."""
    return re.sub(r"\[bin_packing: \w+\]", "", text)


def mixed_width_rows(X):
    """Phase 10 (b)'s rows: the bench rows with 8 columns rounded to 3
    values (crumbs under auto), 8 to 12 values (nibbles), and 12 left
    as they are (wide at max_bin 63)."""
    Xm = X.copy()
    Xm[:, :8] = np.clip(np.round(Xm[:, :8]), -1, 1)
    Xm[:, 8:16] = np.clip(np.round(Xm[:, 8:16] * 2), -6, 5)
    return Xm


def time_packed_hist(binsT, spec, B, dev, reps, card, rng):
    """Phase 10 (a): kernels A and G at W=126 (a random pending table
    over 255 leaves) and on a tree's first round (every row in one
    slot, nothing routed), on the sub-byte storage ``binsT`` and on the
    logical matrix unpacked from it, each held bit for bit against its
    plain version (and the two matrices' results against each other)
    and timed (CUDA events, median) beside its bound: the bytes it must
    move, a landed row's bins counted at the width of the matrix read
    (storage bytes, or one a group).  Returns {kernel: numbers}."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    cols, n = binsT.shape
    G = H.groups_of_storage(cols, spec)
    logical = H.unpack_bins_cols(binsT.t(), num_groups=G,
                                 packed_groups=spec).t().contiguous()
    L = 255
    leaf = rng.randint(0, L, n).astype(np.int32)
    leaf[rng.rand(n) < 0.01] = -1
    leaf = torch.from_numpy(leaf).to(dev)
    counts = (leaf >= 0).to(torch.float32)
    grad = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    wq, _ = H.quantize_gradients(grad * counts, 0.25 * counts, counts)
    wT = wq.t().contiguous()
    table = random_route_table(rng, L, G, B).to(dev)
    cases = {
        "W=126": (leaf, table, torch.from_numpy(rng.permutation(2 * L)[
            :126].astype(np.int32)).to(dev)),
        "first round": (torch.where(leaf >= 0, 0, -1).to(torch.int32),
                        torch.zeros_like(table),
                        torch.zeros(1, dtype=torch.int32, device=dev))}
    out = {"fused_route_hist": {}, "tiled_hist": {}}
    for label, (lf, tb, slots) in cases.items():
        key = "w126" if label == "W=126" else "first"
        for name in out:
            res = {}
            for what, mat, m_spec in (("storage", binsT, spec),
                                      ("logical", logical, 0)):
                if name == "fused_route_hist":
                    def fn():
                        return H.fused_route_hist(mat, wT, lf, tb, slots, B,
                                                  m_spec)
                    want = H.fused_route_hist_plain(mat, wT, lf, tb, slots,
                                                    B, m_spec)
                    got = fn()
                    ok = torch.equal(got[0], want[0]) and torch.equal(
                        got[1], want[1])
                    post, hist = want[1], want[0]
                    # leaf ids in and out, a splitting leaf's row's bin
                    # byte, the table
                    fixed = 8 * n + split_rows(lf, tb) + tb.numel() * 4
                else:
                    def fn():
                        return H.tiled_hist(mat, wT, lf, slots, B, m_spec)
                    hist = H.tiled_hist_plain(mat, wT, lf, slots, B, m_spec)
                    ok = torch.equal(fn(), hist)
                    post, fixed = lf, 4 * n
                if not ok:
                    raise AssertionError(f"phase 10 (a) {name} {label} on "
                                         f"the {what} matrix: kernel != "
                                         "plain")
                res[what] = hist
                n_hit = int(((post[:, None] == slots[None, :]).any(1)
                             & (post >= 0)).sum())
                nbytes = fixed + n_hit * (mat.shape[0] + 12) \
                    + hist.numel() * 4
                bound = nbytes / MEM_BYTES_PER_S * 1e3
                ms = time_ms(fn, dev, reps)
                out[name].update({f"phase10_{key}_{what}_ms": ms,
                                  f"phase10_{key}_{what}_bound_ms": bound})
                print(f"[phase 10] (a) {name} {label} on the {what} matrix "
                      f"({mat.shape[0]} x {n} bytes): {ms:.4f} ms (events; "
                      f"bound {bound:.4f} ms, bytes: {n_hit} rows landed at "
                      f"{mat.shape[0] + 12} B; {card})")
            if not torch.equal(res["storage"], res["logical"]):
                raise AssertionError(f"phase 10 (a) {name} {label}: the "
                                     "storage's histogram differs from the "
                                     "logical matrix's")
    out.update(time_packed_routes(binsT, logical, spec, B, wT, grad * counts,
                                  counts, *cases["W=126"], dev, reps, card,
                                  rng))
    return out


def time_packed_routes(binsT, logical, spec, B, wT, grad, counts, leaf,
                       table, slots, dev, reps, card, rng):
    """Phase 10 (a), W=126 (``leaf``, ``table``, ``slots`` of
    time_packed_hist): kernels B and H, J on the leaf partition, and
    D's routing launch (its device time from the profiler, beside the
    whole call's events), on the storage and on the logical matrix, each
    held against its plain version (and the two matrices' results
    against each other) and timed beside its bytes bound.  Returns
    {kernel: numbers}."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops.partition import block_slots
    G, n = logical.shape
    L, W = 255, slots.shape[0]
    values = torch.from_numpy(rng.randn(L).astype(np.float32)).to(dev)
    wf = torch.stack([grad, 0.25 * counts, counts]).contiguous()
    pad = -n % H.SEG_BLOCK
    leaf_x = torch.nn.functional.pad(leaf, (0, pad), value=-1)
    wT_x = torch.nn.functional.pad(wT, (0, pad))
    splits = split_rows(leaf, table)
    route_bytes = 8 * n + splits + table.numel() * 4
    hit = int(torch.isin(leaf, slots).sum())
    ohb = H.precompute_bin_onehot(logical.t(), max_group_bin=B)
    out = {k: {} for k in ("route_apply", "route_only", "seg_hist",
                           "fused_onehot_hist")}
    res = {}
    for what, mat, m_spec in (("storage", binsT, spec),
                              ("logical", logical, 0)):
        # slots are leaf ids below 2L (new right children past L)
        binsT_p, wT_p, blk_leaf = partition(
            torch.nn.functional.pad(mat, (0, pad)), wT_x, leaf_x, 2 * L)
        blk = block_slots(blk_leaf, slots, 2 * L)
        live = int(((blk >= 0) & (blk < W)).sum())
        dkw = dict(max_group_bin=B, pack=1, num_groups=G,
                   packed_groups=m_spec)
        jobs = {
            "route_apply": (
                lambda: H.route_apply_tiled(mat, leaf, table, values, m_spec),
                lambda: H.route_apply_plain(mat, leaf, table, values, m_spec),
                route_bytes + 4 * n + 4 * L),
            "route_only": (
                lambda: H.route_only_tiled(mat, leaf, table, m_spec),
                lambda: H.route_only_plain(mat, leaf, table, m_spec),
                route_bytes),
            "seg_hist": (
                lambda: H.seg_hist(binsT_p, wT_p, blk, W, B,
                                   packed_groups=m_spec),
                lambda: H.seg_hist_plain(binsT_p, wT_p, blk, W, B,
                                         packed_groups=m_spec),
                4 * blk.numel() + 12 * live * H.SEG_BLOCK
                + hit * mat.shape[0] + W * G * B * 12),
            "fused_onehot_hist": (
                lambda: H.fused_onehot_hist(ohb, mat, wf, leaf, table,
                                            slots, **dkw),
                lambda: H.fused_onehot_hist_plain(ohb, mat, wf, leaf, table,
                                                  slots, **dkw),
                route_bytes)}
        for name, (fn, plain, nbytes) in jobs.items():
            got, want = fn(), plain()
            if name == "seg_hist":
                ok = torch.equal(got, want)
            elif name == "route_only":
                ok = torch.equal(got, want)
            elif name == "route_apply":
                ok = torch.equal(got[0], want[0]) and torch.equal(
                    got[1].view(torch.int32), want[1].view(torch.int32))
            else:
                ok = torch.equal(got[1], want[1])
                hold_hist(f"phase 10 (a) D on the {what} matrix", got[0],
                          want[0], H.onehot_hist_plain(
                              ohb, wf.t().abs(), want[1], slots,
                              max_group_bin=B, pack=1, num_groups=G))
            if not ok:
                raise AssertionError(f"phase 10 (a) {name} on the {what} "
                                     "matrix: kernel != plain")
            res[(name, what)] = got[0] if isinstance(got, tuple) else got
            bound = nbytes / MEM_BYTES_PER_S * 1e3
            ms = time_ms(fn, dev, reps)
            nums = {f"phase10_w126_{what}_ms": ms,
                    f"phase10_w126_{what}_bound_ms": bound}
            detail = f"{ms:.4f} ms the call (events)"
            if name == "fused_onehot_hist" and dev.type == "cuda":
                parts = device_ms(fn, reps, split=True) or {}
                route = sum(v for k, v in parts.items()
                            if kernel_name(k) == "route_rows_kernel")
                nums[f"phase10_w126_{what}_route_device_ms"] = route
                detail += f", its routing launch {route:.4f} ms (device)"
            out[name].update(nums)
            what_bound = ", the routing" if name == "fused_onehot_hist" \
                else ""
            print(f"[phase 10] (a) {name} W=126 on the {what} matrix "
                  f"({mat.shape[0]} x {n} bytes): {detail}; bound "
                  f"{bound:.4f} ms (bytes{what_bound}; {card})")
    for name in out:
        if not torch.equal(res[(name, "storage")], res[(name, "logical")]):
            raise AssertionError(f"phase 10 (a) {name}: the storage's result "
                                 "differs from the logical matrix's")
    return out


def check_packed(lgb, kernels, params, X, y, Xv, yv, dev, card, rehearse,
                 plan_runs):
    """Phase 10: sub-byte bin storage through lgb.train on the card.  (a)
    the bench rows at max_bin 15, fused_tiled 10 trees under 4bit and
    8bit (the texts equal, the resident bin matrix's bytes, every A and
    B call of the 4bit run held, A and G timed on the storage and on the
    logical matrix); (b) the mixed-width rows under auto (crumbs,
    nibbles, wide groups) on five plans, 3 trees each, every text equal
    to its 8bit run's and every A, G, J, B, H and D call held; (c)
    (a)'s validation scores and in-session binned scan equal to the
    8bit run's bit for bit.  Each run's launches are counted on their
    own.  Returns the numbers for the kernels line."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.packing import pack_spec, storage_cols
    t_phase = time.perf_counter()
    reps = 3 if rehearse else 20
    extra = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def dataset(Xt, yt, run_params, valid=None):
        cfg = lgb.Config.from_params(run_params)
        d = lgb.Dataset(Xt, label=yt, free_raw_data=False)
        core = d.construct(cfg)
        v = None
        if valid is not None:
            v = lgb.Dataset(valid[0], label=valid[1], reference=d)
            v.construct_aligned(core, cfg)
        return d, v

    def run(label, run_params, d, v, rounds, plan, want, names=()):
        tap = CallTap(*names) if names else contextlib.nullcontext()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with tap:
            bst = lgb.train(run_params, d, rounds,
                            valid_sets=[v] if v is not None else [],
                            verbose_eval=False, keep_training_booster=True)
        sync()
        ms = 1e3 * (time.perf_counter() - t0) / rounds
        launches = {k: c for k, c in kernels.LAUNCHES.items() if c}
        need_launches(dev, label, launches, want)
        g = bst.gbdt.grower
        if g.plan.name != plan:
            raise AssertionError(f"phase 10 {label}: resolved the "
                                 f"{g.plan.name} plan, not {plan}")
        for name, count in launches.items():
            plan_runs.setdefault(name, {})[f"phase 10 {label}"] = count
        held = {}
        if names:
            held = hold_tapped(tap, f"phase 10 {label}")
            for name, (calls, _) in held.items():
                extra.setdefault(name, {})[
                    f"phase10_{label.split()[0][1]}_{plan}_held_calls"] = \
                    calls
        print(f"[phase 10] {label}: plan {plan}, pack spec {g.pack_P}, "
              f"{bst.num_trees()} trees, {ms:.1f} ms/tree (wall of "
              f"lgb.train over trees; {card}); resident bin matrix "
              f"{g.resident_bin_bytes()} bytes; launches {launches}"
              + (f"; every kernel call held bit for bit against its plain "
                 f"version on the same inputs (kernel: calls, rows routed "
                 f"by a categorical bin of 64 or above) {held}"
                 if names else ""))
        return bst

    # ---- (a) the bench rows at max_bin 15: 4bit stores 28 nibble groups
    # in 14 bytes a row
    p_a = dict(params, max_bin=PACKED_MAX_BIN)
    t0 = time.perf_counter()
    sets = {m: dataset(X, y, dict(p_a, bin_packing=m), (Xv, yv))
            for m in ("8bit", "4bit")}
    print(f"[phase 10] (a) binned {X.shape[0]} + {Xv.shape[0]} rows x "
          f"{X.shape[1]} at max_bin {PACKED_MAX_BIN} under 8bit and 4bit in "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    boosters = {}
    for mode in ("8bit", "4bit"):
        d, v = sets[mode]
        boosters[mode] = run(
            f"(a) {mode}", dict(p_a, bin_packing=mode), d, v, 10,
            "fused_tiled", ("fused_route_hist", "route_apply"),
            ("compute_group_histograms_fused_tiled", "route_apply_tiled")
            if mode == "4bit" else ())
    b8, b4 = boosters["8bit"], boosters["4bit"]
    g8, g4 = b8.gbdt.grower, b4.gbdt.grower
    G = g4.num_groups
    if g4.pack_P != pack_spec(G) or g4.binsT.shape != (
            storage_cols(G, g4.pack_P), g4.n_padded):
        raise AssertionError(f"phase 10 (a): 4bit holds "
                             f"{tuple(g4.binsT.shape)} under spec "
                             f"{g4.pack_P}")
    if strip_packing(b4.model_to_string()) != strip_packing(
            b8.model_to_string()):
        raise AssertionError("phase 10 (a): the 4bit model text differs "
                             "from the 8bit one")
    logical = H.unpack_bins_cols(g4.binsT.t(), num_groups=G,
                                 packed_groups=g4.pack_P)
    if not torch.equal(logical, g8.binsT.t()):
        raise AssertionError("phase 10 (a): the 4bit storage does not hold "
                             "the 8bit run's bins")
    del logical
    r8, r4 = g8.resident_bin_bytes(), g4.resident_bin_bytes()
    print(f"[phase 10] (a) the 4bit model text equals the 8bit one; "
          f"resident bin matrix {r4 / 1e6:.1f} MB ({tuple(g4.binsT.shape)}) "
          f"against {r8 / 1e6:.1f} MB ({tuple(g8.binsT.shape)}) under 8bit "
          f"({card})")
    extra.setdefault("fused_route_hist", {}).update(
        phase10_resident_bytes_4bit=r4, phase10_resident_bytes_8bit=r8)
    for name, nums in time_packed_hist(g4.binsT, g4.pack_P,
                                       g4.max_group_bin, dev, reps, card,
                                       np.random.RandomState(41)).items():
        extra.setdefault(name, {}).update(nums)

    # ---- (c) (a)'s validation scores and in-session binned scan
    s8 = b8.gbdt.valid_sets[0].scores
    s4 = b4.gbdt.valid_sets[0].scores
    vb = b4.gbdt.valid_sets[0].bins
    if vb.shape != (Xv.shape[0], storage_cols(G, g4.pack_P)):
        raise AssertionError(f"phase 10 (c): the validation set holds "
                             f"{tuple(vb.shape)}")
    if not torch.equal(s8, s4):
        raise AssertionError("phase 10 (c): the 4bit validation scores "
                             "differ from the 8bit ones")
    scan = {}
    for mode, bst in boosters.items():
        t0 = time.perf_counter()
        scan[mode] = bst._device_predict_raw(Xv, -1)
        scan[mode + "_ms"] = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(scan["8bit"], scan["4bit"]):
        raise AssertionError("phase 10 (c): the 4bit binned scan differs "
                             "from the 8bit one")
    print(f"[phase 10] (c) validation scores of {Xv.shape[0]} rows (held "
          f"as {tuple(vb.shape)} storage) and the in-session binned scan of "
          f"them equal the 8bit run's bit for bit; the scan "
          f"{scan['4bit_ms']:.1f} ms under 4bit, {scan['8bit_ms']:.1f} ms "
          f"under 8bit (binning included; {card})")
    del boosters, b8, b4, g8, g4, sets, s8, s4, vb
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- (b) mixed widths under auto: crumbs, nibbles and wide groups
    Xm = mixed_width_rows(X)
    default = {k: v for k, v in params.items()
               if k not in ("quantized_grad", "hist_compute_dtype")}
    t0 = time.perf_counter()
    sets = {m: dataset(Xm, y, dict(params, bin_packing=m)
                       )[0] for m in ("8bit", "auto")}
    print(f"[phase 10] (b) binned the mixed-width rows under 8bit and auto "
          f"in {time.perf_counter() - t0:.1f} s ({card})")
    for plan, run_params, want, names in [
            ("q_tiled(split_route)", dict(params, hist_split_route=True),
             ("route_only", "tiled_hist", "route_apply"),
             ("route_only_tiled", "compute_group_histograms_q_tiled",
              "route_apply_tiled")),
            ("seg_tiled(leaf_partition)",
             dict(params, hist_leaf_partition="on"),
             ("route_only", "seg_hist", "route_apply"),
             ("route_only_tiled", "compute_group_histograms_seg_tiled",
              "route_apply_tiled")),
            ("fused_streamed", dict(params, quantized_grad=False),
             ("fused_onehot_hist", "route_apply"),
             ("compute_group_histograms_fused", "route_apply_tiled")),
            ("pre_onehot", dict(params, quantized_grad=False,
                                hist_fused_route=False),
             ("hist_pre_packed",), ()),
            ("xla", default, (), ())]:
        texts, specs = {}, {}
        for mode in ("8bit", "auto"):
            bst = run(f"(b) {mode} {plan}", dict(run_params, bin_packing=mode),
                      sets[mode], None, 3, plan, want,
                      names if mode == "auto" else ())
            texts[mode] = bst.model_to_string()
            specs[mode] = bst.gbdt.grower.pack_P
            del bst
        if strip_packing(texts["auto"]) != strip_packing(texts["8bit"]):
            raise AssertionError(f"phase 10 (b) {plan}: the auto model text "
                                 "differs from the 8bit one")
        print(f"[phase 10] (b) {plan}: the auto model text (pack spec "
              f"{specs['auto']}: P {specs['auto'] & 0xFFFF}, C "
              f"{specs['auto'] >> 16}) equals the 8bit one")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    print(f"[phase 10] done in {secs:.1f} s ({card})")
    extra.setdefault("fused_route_hist", {})["phase10_s"] = secs
    return extra


# ---------------------------------------------------------------------------
# phase 11: the file entry point (text files, binary caches, two-round
# streaming, PushRows, the CLI, codegen, the sklearn wrapper, the C API)
# ---------------------------------------------------------------------------
def _bench_conf(params) -> list:
    """BENCH_PARAMS (with the run's device and metric) as CLI key=value
    pairs."""
    out = []
    for k, v in params.items():
        if isinstance(v, bool):
            v = "true" if v else "false"
        elif isinstance(v, (list, tuple)):
            v = ",".join(str(x) for x in v)
        out.append(f"{k}={v}")
    return out


def _launched(kernels) -> dict:
    return {k: v for k, v in kernels.LAUNCHES.items() if v}


def _sync(dev):
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize()


def check_file_entry(lgb, kernels, params, X, y, Xv, yv, core, main_text,
                     main_launches, main_ms, dev, card, rehearse):
    """Phase 11.  ``core`` is phase 2's binned training rows,
    ``main_text`` phase 3's main-path model text, ``main_launches`` its
    launches and ``main_ms`` its ms/tree.  Returns {kernel: launches}
    of the phase's runs."""
    import ctypes
    import os
    import shutil
    import tempfile

    import lightgbm_tpu_torch.capi as capi
    import lightgbm_tpu_torch.cli as cli
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.data_loader import load_file
    from lightgbm_tpu_torch.dataset import Dataset as CoreDataset
    t_phase = time.perf_counter()
    total = {}

    def count(label, launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"[phase 11] {label}: launches {launches}")

    tmp = tempfile.mkdtemp(prefix="ltt_phase11_")
    try:
        # (a) the training and held-out rows as TSV, label first, %.17g
        train_p, valid_p = (os.path.join(tmp, "train.tsv"),
                            os.path.join(tmp, "valid.tsv"))
        t0 = time.perf_counter()
        for p, A, lab in ((train_p, X, y), (valid_p, Xv, yv)):
            np.savetxt(p, np.column_stack([lab, A]), fmt="%.17g",
                       delimiter="\t")
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(train_p) + os.path.getsize(valid_p)
        print(f"[phase 11] (a) wrote {len(y)} + {len(yv)} rows as TSV, "
              f"{nbytes} bytes, in {write_s:.2f} s (host CPU)")

        # (b) the native loader on both files; np.loadtxt on the
        # held-out file; each bit for bit the rows written
        if not native.loaded():
            raise AssertionError("the native host library did not load: "
                                 f"{native.LOAD_ERROR}")
        cfg = lgb.Config.from_params(params)
        parse = {}
        for name, p, A, lab in (("train", train_p, X, y),
                                ("held-out", valid_p, Xv, yv)):
            t0 = time.perf_counter()
            got, glab, _ = load_file(p, cfg)
            parse[name] = time.perf_counter() - t0
            if got.tobytes() != A.tobytes() or glab.tobytes() != \
                    lab.astype(np.float64).tobytes():
                raise AssertionError(f"(b) the native parse of the {name} "
                                     "file is not the rows written")
        t0 = time.perf_counter()
        ref = np.loadtxt(valid_p, delimiter="\t")
        loadtxt_s = time.perf_counter() - t0
        if ref[:, 1:].tobytes() != Xv.tobytes():
            raise AssertionError("(b) np.loadtxt of the held-out file is not "
                                 "the rows written")
        mb = os.path.getsize(train_p) / 1e8
        vmb = os.path.getsize(valid_p) / 1e8
        print(f"[phase 11] (b) native parse: training file "
              f"{parse['train']:.2f} s ({parse['train'] / mb:.2f} s per 100 "
              f"MB), held-out {parse['held-out']:.2f} s; np.loadtxt of the "
              f"held-out file {loadtxt_s:.2f} s ({loadtxt_s / vmb:.2f} s per "
              "100 MB); both bit for bit the rows written (host CPU)")

        # (c) the CLI trains 10 trees on the card from the files
        model_p = os.path.join(tmp, "model.txt")
        conf_p = os.path.join(tmp, "train.conf")
        with open(conf_p, "w") as f:
            f.write("\n".join(_bench_conf(params) + [
                "task=train", f"data={train_p}", f"valid_data={valid_p}",
                "num_trees=10", "is_save_binary_file=true",
                f"output_model={model_p}"]) + "\n")
        seen = {}
        orig_train = cli._train

        def timed_train(p, train_set, *a, **k):
            # the training set and the held-out file loaded first, so
            # the timed part is lgb.train's trees
            seen["core"] = train_set.construct()
            for v in k.get("valid_sets") or []:
                v.construct()
            _sync(dev)
            t0 = time.perf_counter()
            out = orig_train(p, train_set, *a, **k)
            _sync(dev)
            seen["train_s"] = time.perf_counter() - t0
            return out
        cli._train = timed_train
        try:
            kernels.reset_launches()
            t0 = time.perf_counter()
            cli.run([f"config={conf_p}"])
            _sync(dev)
            cli_s = time.perf_counter() - t0
            c_launches = _launched(kernels)
        finally:
            cli._train = orig_train
        count("(c) cli train", c_launches)
        core_c = seen["core"]
        if np.asarray(core_c.group_bins).tobytes() != \
                np.asarray(core.group_bins).tobytes():
            raise AssertionError("(c) the CLI's bins differ from phase 2's")
        text_c = open(model_p).read()
        if text_c != main_text:
            raise AssertionError("(c) the CLI's model text differs from "
                                 "phase 3's main-path text")
        for name in ("fused_route_hist", "route_apply"):
            if not rehearse and c_launches.get(name, 0) \
                    != main_launches.get(name, 0):
                raise AssertionError(
                    f"(c) {name} launched {c_launches.get(name, 0)} times, "
                    f"phase 3's main path {main_launches.get(name, 0)}")
        cli_ms = 1e3 * seen["train_s"] / 10
        print(f"[phase 11] (c) cli.run: {cli_s:.2f} s in all (parse, "
              f"binning, the cache written, 10 trees, the model saved); the "
              f"training itself {cli_ms:.1f} ms/tree against phase 3's "
              f"{main_ms:.1f} ms/tree; the model text equals phase 3's "
              f"main-path text; {card}")

        # (d) the binary cache (c) wrote: a memmap, byte-equal to (c)'s
        # core; 3 trees from it are (c)'s first 3
        cache_p = train_p + ".bin"
        t0 = time.perf_counter()
        cache_core = lgb.Dataset(cache_p, params=params).construct()
        cache_s = time.perf_counter() - t0
        if not isinstance(cache_core.group_bins, np.memmap) or \
                np.asarray(cache_core.group_bins).tobytes() != \
                np.asarray(core_c.group_bins).tobytes():
            raise AssertionError("(d) the cache is not a memmap of (c)'s "
                                 "bins")
        kernels.reset_launches()
        b3 = lgb.train(params, lgb.Dataset(cache_p, params=params), 3,
                       verbose_eval=False)
        _sync(dev)
        count("(d) 3 trees from the cache", _launched(kernels))
        first3 = lgb.Booster(model_str=text_c, params={"device": dev.type}
                             ).model_to_string(num_iteration=3)
        if b3.model_to_string() != first3:
            raise AssertionError("(d) 3 trees from the cache differ from "
                                 "(c)'s first 3")
        cache_bytes = os.path.getsize(cache_p)
        print(f"[phase 11] (d) cache load {cache_s:.3f} s ({cache_bytes} "
              f"bytes, memmapped) against the parse's "
              f"{parse['train']:.2f} s and binning below; 3 trees from it "
              "equal (c)'s first 3 (host CPU)")

        # (e) two-round streaming against one-round loading, every row
        # sampled
        full = dict(params, bin_construct_sample_cnt=max(len(y), 1000000))
        t0 = time.perf_counter()
        one = lgb.Dataset(train_p, params=full).construct()
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = lgb.Dataset(train_p, params=dict(
            full, use_two_round_loading=True,
            streaming_chunk_rows=65536)).construct()
        two_s = time.perf_counter() - t0
        if np.asarray(one.group_bins).tobytes() != \
                np.asarray(two.group_bins).tobytes():
            raise AssertionError("(e) two-round bins differ from one-round")
        build_s, bin_s = {}, {}
        for on in (True, False):
            c = lgb.Config.from_params(dict(params, native_binning=on))
            t0 = time.perf_counter()
            b = CoreDataset.from_matrix(X, label=y, config=c)
            build_s[on] = time.perf_counter() - t0
            t0 = time.perf_counter()
            b._bin_data(X)              # the value -> bin pass alone
            bin_s[on] = time.perf_counter() - t0
            if np.asarray(b.group_bins).tobytes() != \
                    np.asarray(core.group_bins).tobytes():
                raise AssertionError(f"(e) native_binning={on} bins differ")
        print(f"[phase 11] (e) one-round {one_s:.2f} s, two-round "
              f"{two_s:.2f} s (65,536-row chunks), the bins byte-identical; "
              f"construction of {len(y)} x {X.shape[1]} in RAM (200,000-row "
              f"sample, mapper fit, binning): native {build_s[True]:.2f} s, "
              f"numpy {build_s[False]:.2f} s; the binning pass alone: native "
              f"{bin_s[True]:.3f} s, numpy {bin_s[False]:.3f} s "
              f"({bin_s[False] / max(bin_s[True], 1e-9):.2f}x; host CPU)")

        # (f) task=predict on the held-out file: kernel C; each line the
        # %g of Booster.predict of the in-memory rows
        pred_p = os.path.join(tmp, "pred.txt")
        kernels.reset_launches()
        cli.run(["task=predict", f"data={valid_p}", f"input_model={model_p}",
                 f"output_result={pred_p}", f"device={dev.type}",
                 "verbose=-1"])
        f_launches = _launched(kernels)
        count("(f) cli predict", f_launches)
        if not rehearse and not f_launches.get("predict_level", 0) \
                + f_launches.get("predict_level_global", 0):
            raise AssertionError("(f) task=predict did not launch kernel C")
        loaded = lgb.Booster(model_file=model_p, params={"device": dev.type})
        want = [f"{v:g}" for v in loaded.predict(Xv)]
        if open(pred_p).read().splitlines() != want:
            raise AssertionError("(f) the predict file differs from "
                                 "Booster.predict")
        print(f"[phase 11] (f) task=predict: {len(want)} lines, each the %g "
              "of Booster.predict of the held-out rows")

        # (g) task=convert_model, compiled and run on 10,000 rows
        cpp_p, so_p = (os.path.join(tmp, "model.cpp"),
                       os.path.join(tmp, "model.so"))
        cli.run(["task=convert_model", f"input_model={model_p}",
                 f"convert_model={cpp_p}", f"device={dev.type}",
                 "verbose=-1"])
        t0 = time.perf_counter()
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", cpp_p, "-o", so_p],
                       check=True, timeout=300)
        gxx_s = time.perf_counter() - t0
        lib = ctypes.CDLL(so_p)
        lib.PredictRaw.argtypes = [ctypes.POINTER(ctypes.c_double)] * 2
        m = min(10_000, len(yv))
        rows = np.ascontiguousarray(Xv[:m])
        got = np.zeros(m)
        out = np.zeros(1)
        dp = ctypes.POINTER(ctypes.c_double)
        for i in range(m):
            lib.PredictRaw(rows[i].ctypes.data_as(dp), out.ctypes.data_as(dp))
            got[i] = out[0]
        host = sum(t.predict(rows) for t in loaded.models)
        kernel_c = loaded.predict(rows, raw_score=True)
        err_host = float(np.abs(got - host).max())
        err_c = float(np.abs(got - kernel_c).max())
        if err_host > 1e-10:
            raise AssertionError(f"(g) the C++ is {err_host} from the host "
                                 "walk")
        if err_c > TOL_PREDICT * (1 + np.abs(host).max()):
            raise AssertionError(f"(g) the C++ is {err_c} from kernel C")
        print(f"[phase 11] (g) convert_model: g++ -O2 in {gxx_s:.1f} s; on "
              f"{m} held-out rows max |d| {err_host:.3g} from the f64 host "
              f"walk, {err_c:.3g} from kernel C")

        # (h) the sklearn wrapper and the C API
        sk = {"max_bin": params["max_bin"],
              "quantized_grad": params["quantized_grad"],
              "hist_compute_dtype": params["hist_compute_dtype"],
              "device": dev.type}
        kernels.reset_launches()
        clf = lgb.LGBMClassifier(
            n_estimators=3, num_leaves=params["num_leaves"],
            learning_rate=params["learning_rate"],
            min_child_weight=params["min_sum_hessian_in_leaf"],
            min_child_samples=params["min_data_in_leaf"], **sk)
        clf.fit(X, y)
        _sync(dev)
        h_launches = _launched(kernels)
        count("(h) LGBMClassifier.fit", h_launches)
        if not rehearse and not (h_launches.get("fused_route_hist")
                                 and h_launches.get("route_apply")):
            raise AssertionError("(h) LGBMClassifier.fit did not launch A "
                                 "and B")
        proba = clf.predict_proba(Xv)[:, 1]
        if proba.tobytes() != clf.booster_.predict(Xv).tobytes():
            raise AssertionError("(h) predict_proba[:, 1] is not "
                                 "booster_.predict")
        pstr = " ".join(_bench_conf(params))
        dh, bh, text = [None], [None], [None]
        kernels.reset_launches()
        for rc in (capi.LGBM_DatasetCreateFromFile(train_p, pstr, None, dh),
                   capi.LGBM_BoosterCreate(dh[0], pstr, bh),
                   *(capi.LGBM_BoosterUpdateOneIter(bh[0], [0])
                     for _ in range(3)),
                   capi.LGBM_BoosterSaveModelToString(bh[0], -1, text)):
            if rc != 0:
                raise AssertionError(f"(h) C API: {capi.LGBM_GetLastError()}")
        count("(h) C API from the file", _launched(kernels))
        kernels.reset_launches()
        want_text = lgb.train(params, lgb.Dataset(train_p, params=params), 3,
                              verbose_eval=False).model_to_string()
        count("(h) lgb.train on the file", _launched(kernels))
        if text[0] != want_text:
            raise AssertionError("(h) the C API's 3-tree text differs from "
                                 "lgb.train's")
        ph = [None]
        if capi.LGBM_DatasetCreateByReference(dh[0], len(y), ph) != 0:
            raise AssertionError(f"(h) {capi.LGBM_GetLastError()}")
        t0 = time.perf_counter()
        for s in range(0, len(y), 65536):
            chunk = X[s:s + 65536]
            if capi.LGBM_DatasetPushRows(ph[0], chunk, len(chunk),
                                         X.shape[1], s) != 0:
                raise AssertionError(f"(h) {capi.LGBM_GetLastError()}")
        push_s = time.perf_counter() - t0
        pushed = capi._get(ph[0]).construct()
        if np.asarray(pushed.group_bins).tobytes() != \
                np.asarray(core_c.group_bins).tobytes():
            raise AssertionError("(h) the pushed rows' bins differ from (c)'s")
        for h_ in (bh[0],):
            capi.LGBM_BoosterFree(h_)
        for h_ in (dh[0], ph[0]):
            capi.LGBM_DatasetFree(h_)
        print(f"[phase 11] (h) LGBMClassifier: predict_proba[:, 1] bit for "
              "bit booster_.predict; the C API's file -> booster -> 3 "
              "iterations text equals lgb.train's; "
              f"LGBM_DatasetCreateByReference + PushRows in 65,536-row "
              f"chunks ({push_s:.2f} s) byte-identical to (c)'s bins")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[phase 11] wall {time.perf_counter() - t_phase:.1f} s ({card})")
    return total


def main(argv) -> int:
    t_start = time.perf_counter()
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
    # (the rehearsal's rows, like the card's, are no multiple of 512)
    n_rows, n_valid = (4000, 2048) if rehearse else (1_000_000, 200_000)

    # ---- phase 1: the card and the kernel build
    card = "cpu rehearsal" if rehearse else card_line()
    print(f"[phase 1] card: {card}")
    if not rehearse:
        t0 = time.perf_counter()
        kernels.build_kernels()
        print(f"[phase 1] kernels built in {time.perf_counter() - t0:.1f} s")
        # each entry function's registers and spills, under its mangled
        # name (the template arguments show which instantiation: e.g.
        # hist_i32_kernelILi4ELb0ELb1E is <4, transposed, packed>)
        for name, log in kernels.BUILD_LOG.items():
            for line in log.splitlines():
                m = re.search(r"Function properties for (\S+)", line)
                if m:
                    print(f"[phase 1] {name}: {m.group(1)}")
                elif "registers" in line or "spill" in line:
                    print(f"[phase 1] {name}:   {line.strip()}")

    # the bench rows, binned once: phase 2's make_data first round and
    # phase 3's training
    X, y, w = make_data(n_rows, 28, seed=7)
    Xv, yv, _ = make_data(n_valid, 28, seed=8, w=w)
    params = dict(BENCH_PARAMS, metric=["auc"], device=dev.type)
    cfg = lgb.Config.from_params(params)
    t0 = time.perf_counter()
    train_ds = lgb.Dataset(X, label=y, free_raw_data=False)
    core = train_ds.construct(cfg)
    valid_ds = lgb.Dataset(Xv, label=yv, reference=train_ds)
    print(f"[phase 2] binned {n_rows} x 28 in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 2: kernels against their plain versions
    numbers = check_kernels(dev, n_rows, rehearse, card)
    numbers.update(check_float_kernels(dev, n_rows, rehearse, card))
    numbers.update(check_quant_kernels(dev, n_rows, rehearse, card))
    for name, extra in check_bench_first_round(
            dev, core.logical_group_bins(), core.max_group_bin, y, rehearse,
            card).items():
        numbers[name].update(extra)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- phase 3: train through lgb.train on the card
    # the float-gradient plans: the default (fused_streamed), the
    # streamed one-hot without the fused route (pre_onehot: its strip
    # ladder takes the pre_packed entry point for every round of a
    # 126-wide frontier, and the pre entry point without the ladder),
    # no one-hot budget (pallas) and the paired kernel (pallas_paired,
    # whose model text must equal pallas's: kernels F and K compute one
    # function).  Then the int8 plans without the fused route, 3 trees
    # each, whose model text must equal the 3-tree fused_tiled model's
    # byte for byte (integer histograms make it exact whichever kernel
    # built them): the split route (kernel H, then G; B at exit), the
    # leaf partition (H, the partition, J; B at exit), q_tiled (G),
    # q_onthefly (I's q_packed entry at every round of a 126-wide
    # frontier) and the quantized pallas body (I's pallas_q entry).
    # Then the default config (no quantized_grad, hist_compute_dtype
    # float32: the xla plan, torch ops and no kernel), and fused_tiled
    # and seg_tiled without the histogram cache (histogram_pool_size
    # below it: each round's second pass over the parent slots), whose
    # two model texts must be equal
    fparams = dict(params, quantized_grad=False)
    otf = {"hist_kernel_tiled": False, "hist_fused_route": False}
    default = {k: v for k, v in params.items()
               if k not in ("quantized_grad", "hist_compute_dtype")}
    no_cache = dict(params, histogram_pool_size=0.001)
    plan_runs = {}          # kernel -> {run label: launches in that run}
    texts = {}              # run label -> model text
    # run label -> the earlier run whose model text it must equal
    same_text = {"f32 pallas_paired": "f32 pallas",
                 "int8 no cache, seg_tiled": "int8 no cache, fused_tiled"}
    same_text.update({k: "int8 fused_tiled, 3 trees" for k in (
        "int8 q_tiled(split_route)", "int8 seg_tiled(leaf_partition)",
        "int8 q_tiled", "int8 q_onthefly", "int8 pallas(quantized)")})
    # (10 trees must reach a held-out AUC above 0.8; 3 trees above 0.75)
    for label, run_params, rounds, plan, want in [
            ("f32 fused_streamed", fparams, 10, "fused_streamed",
             ("fused_onehot_hist", "route_apply")),
            ("f32 pre_onehot", dict(fparams, hist_fused_route=False), 3,
             "pre_onehot", ("hist_pre_packed",)),
            ("f32 pre_onehot without the strip ladder",
             dict(fparams, hist_fused_route=False,
                  hist_packed_dispatch=False), 3, "pre_onehot",
             ("hist_pre",)),
            ("f32 pallas", dict(fparams, hist_onehot_budget_mb=0), 3,
             "pallas", ("bins_hist",)),
            ("f32 pallas_paired", dict(fparams, hist_kernel="paired"), 3,
             "pallas_paired", ("bins_hist_paired",)),
            ("int8 fused_tiled, 3 trees", params, 3, "fused_tiled",
             ("fused_route_hist", "route_apply")),
            ("int8 q_tiled(split_route)",
             dict(params, hist_split_route=True), 3, "q_tiled(split_route)",
             ("route_only", "tiled_hist", "route_apply")),
            ("int8 seg_tiled(leaf_partition)",
             dict(params, hist_leaf_partition="on"), 3,
             "seg_tiled(leaf_partition)",
             ("route_only", "seg_hist", "route_apply")),
            ("int8 q_tiled", dict(params, hist_fused_route=False), 3,
             "q_tiled", ("tiled_hist",)),
            ("int8 q_onthefly", dict(params, **otf), 3, "q_onthefly",
             ("bins_hist_q_packed",)),
            ("int8 pallas(quantized)",
             dict(params, hist_quant_onthefly=False,
                  hist_onehot_budget_mb=0, **otf), 3, "pallas(quantized)",
             ("bins_hist_q",)),
            ("default config", default, 10, "xla", ()),
            ("int8 no cache, fused_tiled", no_cache, 3, "fused_tiled",
             ("fused_route_hist", "route_apply")),
            ("int8 no cache, seg_tiled",
             dict(no_cache, hist_leaf_partition="on"), 3,
             "seg_tiled(leaf_partition)",
             ("route_only", "seg_hist", "route_apply"))]:
        r_bst, r_auc, r_launches, _ = train_plan(
            lgb, kernels, run_params, train_ds, valid_ds, rounds, dev, card,
            label, plan)
        floor = 0.8 if rounds >= 10 else 0.75
        if r_auc <= floor:
            raise AssertionError(f"{label}: held-out AUC {r_auc:.4f} is "
                                 f"not above {floor}")
        for name in want:
            if not rehearse and r_launches[name] <= 0:
                raise AssertionError(f"{label} did not launch {name}")
        for name, count in r_launches.items():
            if count:
                plan_runs.setdefault(name, {})[label] = count
        texts[label] = r_bst.model_to_string()
        ref = same_text.get(label)
        if ref is not None:
            if texts[label] != texts[ref]:
                raise AssertionError(f"{label}: the model text differs from "
                                     f"the {ref} model's")
            print(f"[phase 3] {label}: model text equals the {ref} model's")
        del r_bst
    # without the cache a left child's histogram is dequantized directly,
    # not parent minus right in f32: the leaf values move in the last
    # bits, and a near-tie between two thresholds may fall the other way
    for key in ("split_feature=", "threshold="):
        same = [ln for ln in texts["int8 no cache, fused_tiled"].splitlines()
                if ln.startswith(key)] == [
            ln for ln in texts["int8 fused_tiled, 3 trees"].splitlines()
            if ln.startswith(key)]
        print(f"[phase 3] no cache: every tree's {key[:-1]} line equals the "
              f"cached 3-tree fused_tiled model's: {same}")
    # {"objective": "binary"} and no other key (device defaults to the
    # card): 5 trees on the first 50,000 rows
    m = min(n_rows, 50_000)
    t0 = time.perf_counter()
    bare = lgb.train(dict({"objective": "binary"},
                          **({"device": "cpu"} if rehearse else {})),
                     lgb.Dataset(X[:m], label=y[:m]), 5, verbose_eval=False,
                     keep_training_booster=True)
    bare_auc = auc_score(yv, bare.predict(Xv))
    print(f"[phase 3] lgb.train({{'objective': 'binary'}}) on {m} rows: "
          f"plan {bare.gbdt.grower.plan.name}, 5 trees in "
          f"{time.perf_counter() - t0:.2f} s, held-out AUC {bare_auc:.4f} "
          f"({card})")
    if bare.gbdt.grower.plan.name != "xla" or bare_auc <= 0.75:
        raise AssertionError("the bare default config did not train the "
                             "xla plan to a held-out AUC above 0.75")
    del bare
    # the quantized main path last, so Booster.predict below counts
    # into the same window (kernels A, B, then C)
    bst, valid_auc, q_launches, q_ms = train_plan(
        lgb, kernels, params, train_ds, valid_ds, 10, dev, card,
        "int8 fused_tiled")
    for name, count in q_launches.items():
        if count:
            plan_runs.setdefault(name, {})["int8 fused_tiled"] = count
    main_text = bst.model_to_string()      # phase 11 (c) holds the CLI's

    # ---- phase 4: predict through Booster.predict on the card: the
    # held-out rows (kernel C's shared tier; the first call also
    # flattens the ensemble and packs its records), then 16 of them (the
    # global tier), both in the main path's counted window
    t0 = time.perf_counter()
    prob = bst.predict(Xv)
    predict_s = time.perf_counter() - t0
    prob16 = bst.predict(Xv[:16])
    launches = dict(kernels.LAUNCHES)
    auc = auc_score(yv, prob)
    print(f"[phase 4] predicted {n_valid} rows in {predict_s * 1e3:.1f} ms "
          f"(the first call, which builds the predictor), then 16 rows; AUC "
          f"{auc:.4f}; launches {launches}; {card}")
    parts = predict_breakdown(bst, Xv, dev)
    print(f"[phase 4] Booster.predict of {n_valid} rows, a warm call "
          f"(median of 3): {parts['wall']:.2f} ms wall; the serving "
          "predictor's steps one by one: " + "; ".join(
              f"{k} {v:.2f} ms" for k, v in parts.items() if k != "wall")
          + f" ({card})")
    # each tier held and timed on the bucket the path launches it on
    pred = served(bst)
    x2 = launched_x2(P, pred, Xv, dev)
    reps = 3 if rehearse else 20
    at = f"{bst.num_trees()} trees, depth {pred.depth}"
    stack = P.unpack_level_records(pred.records)     # the plain version's
    main_rows = check_level(P, stack, x2, pred.depth, dev, reps, card,
                            f"(a) {at}, {n_valid} rows in a bucket of "
                            f"{x2.shape[0]}", phase=4)
    few_rows = check_level(P, stack, launched_x2(P, pred, Xv[:16], dev),
                           pred.depth, dev, reps, card, f"{at}, 16 rows",
                           phase=4)
    # each tier's own numbers at the batch the main path gives it, the
    # other batch's beside them
    numbers.setdefault("predict_level", {}).update(
        main_rows["predict_level"], predict_first_call_ms=predict_s * 1e3,
        predict_ms_by_step=parts,
        **{f"{k}_16_rows": v for k, v in few_rows["predict_level"].items()})
    numbers.setdefault("predict_level_global", {}).update(
        few_rows["predict_level_global"],
        **{f"{k}_a": v for k, v in main_rows["predict_level_global"].items()})
    for rows in (1, 1000):
        xs = launched_x2(P, pred, Xv[:rows], dev)
        ms = time_ms(lambda: P.predict_level_ensemble(
            pred.records, xs, depth=pred.depth), dev, reps)
        tier = P.level_plan(pred.records, xs.shape[0], xs.shape[1]).tier
        print(f"[phase 4] predict_level at {rows} rows (a bucket of "
              f"{xs.shape[0]}, {tier} tier): {ms:.4f} ms the call (events; "
              f"{card})")
        numbers["predict_level_global"][f"ms_{rows}_rows"] = ms
    if not np.array_equal(prob16, prob[:16]):
        raise AssertionError("16 rows predict otherwise alone than in the "
                             "batch")
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
        for name in ("predict_level", "predict_level_global"):
            if launches[name] <= 0:
                raise AssertionError(f"Booster.predict did not launch "
                                     f"{name}")
    if not (np.isfinite(prob).all() and prob.shape == (n_valid,)):
        raise AssertionError("predictions are not finite or wrong shape")
    if auc <= 0.8 or valid_auc <= 0.8:
        raise AssertionError(f"held-out AUC {auc:.4f} / {valid_auc:.4f} "
                             "is not above 0.8")

    # ---- phase 5: the regression, L1 and 5-class objectives through
    # lgb.train and Booster.predict on the card
    texts = {}
    for name, extra in check_objectives(lgb, kernels, P, params, X, w, Xv,
                                        dev, card, reps, texts).items():
        numbers[name].update(extra)

    # ---- phase 6: the training front door (early stopping,
    # init_model, fobj, rollback, average_output, CSR input, cv)
    for name, extra in check_front_door(lgb, kernels, params, train_ds, X,
                                        y, Xv, yv, dev, card,
                                        plan_runs).items():
        numbers[name].update(extra)

    # ---- phase 7: categorical features and forced splits
    for name, extra in check_categorical(lgb, kernels, params, dev, card,
                                         n_rows, n_valid, q_ms,
                                         plan_runs).items():
        numbers[name].update(extra)

    # ---- phase 8: bagging, GOSS, DART, RF and lambdarank
    for name, extra in check_sampling(lgb, kernels, params, train_ds,
                                      valid_ds, X, Xv, yv, dev, card,
                                      rehearse, valid_auc,
                                      plan_runs).items():
        numbers[name].update(extra)

    # ---- phase 9: the serving predictor, co-batch, the scans,
    # pred_contrib and pred_early_stop
    served_numbers, serving_launches = check_serving(
        lgb, kernels, P, bst, texts, params, train_ds, Xv, dev, card,
        rehearse)
    numbers["predict_level"].update(served_numbers)

    # ---- phase 10: sub-byte bin storage (4bit, auto) on the card
    for name, extra in check_packed(lgb, kernels, params, X, y, Xv, yv,
                                    dev, card, rehearse, plan_runs).items():
        numbers[name].update(extra)

    # ---- phase 11: the file entry point (text files, the binary cache,
    # two-round streaming, the CLI, codegen, sklearn and the C API)
    file_launches = check_file_entry(lgb, kernels, params, X, y, Xv, yv,
                                     core, main_text, q_launches, q_ms, dev,
                                     card, rehearse)
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
        "predict_level_global": ("lightgbm_tpu_torch/csrc/predict_level.cu",
                                 "lightgbm_tpu/ops/predict.py:326"),
    }
    onehot = "lightgbm_tpu_torch/csrc/onehot_hist.cu"
    replaces.update({
        "fused_onehot_hist": (onehot, "lightgbm_tpu/ops/histogram.py:1272"),
        "hist_pre_packed": (onehot, "lightgbm_tpu/ops/histogram.py:769"),
        "hist_pre": (onehot, "lightgbm_tpu/ops/histogram.py:727"),
        "bins_hist": ("lightgbm_tpu_torch/csrc/bins_hist.cu",
                      "lightgbm_tpu/ops/histogram.py:224"),
        "bins_hist_paired": ("lightgbm_tpu_torch/csrc/bins_hist.cu",
                             "lightgbm_tpu/ops/histogram.py:273"),
        "tiled_hist": ("lightgbm_tpu_torch/csrc/fused_route_hist.cu",
                       "lightgbm_tpu/ops/histogram.py:1021"),
        "route_only": ("lightgbm_tpu_torch/csrc/route_apply.cu",
                       "lightgbm_tpu/ops/histogram.py:1654"),
        "bins_hist_q": ("lightgbm_tpu_torch/csrc/bins_hist.cu",
                        "lightgbm_tpu/ops/histogram.py:381"),
        "bins_hist_q_packed": ("lightgbm_tpu_torch/csrc/bins_hist.cu",
                               "lightgbm_tpu/ops/histogram.py:897"),
        "seg_hist": ("lightgbm_tpu_torch/csrc/seg_hist.cu",
                     "lightgbm_tpu/ops/histogram.py:1520"),
    })
    rows = []
    for name, (src, rep) in replaces.items():
        # launches: the quantized main path's window (A, B, both tiers
        # of C), else
        # the sum over the phase-3 runs that drove the kernel, which
        # launches_by_run lists one by one.  Numbers beyond the
        # contract's keys (first-round and other timings, unstable
        # bins) follow them in the same object
        runs = plan_runs.get(name, {})
        if serving_launches.get(name):
            runs["phase 9"] = serving_launches[name]
        if file_launches.get(name):
            runs["phase 11"] = file_launches[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep,
                     "launches": (launches[name] + serving_launches.get(
                         name, 0) + file_launches.get(name, 0))
                     or sum(runs.values()),
                     "launches_by_run": runs,
                     "bound_by": "bytes", "library_ms": None,
                     **numbers[name]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the kernel "
          "build included")
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
