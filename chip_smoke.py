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
     two-round loading of the held-out file (every row sampled,
     65,536-row chunks) byte for
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
 12. online serving through kernel C (serving/ and task=serve), the
     launch counters zeroed before (a) and read after (f), every response
     checked against Booster.predict of the same rows after that window:
     (a) phase 3's main-path model published from its saved text into a
     ModelRegistry with the implicit warm ladder (16 ... 1024), the warm
     wall printed, and a ServingFrontend on an ephemeral port; (b) 16
     client threads POST held-out rows in requests of 1-64 rows as JSON,
     CSV and application/x-ltpu-f32 (answered in f64 bytes): every reply
     bit for bit Booster.predict, fewer dispatches than requests, each a
     launch of C, and up to 4 coalesced dispatches tapped and held bit for
     bit against predict_level_records_plain on their padded bucket; (c)
     phase 5's regression model published as v2 under the same traffic:
     each reply wholly its version's, no error status, then a rollback and
     v1 again; (d) serve_lanes=2 on the one card: (b)'s bits, both lanes
     dispatching on GET /models; (e) serve_cobatch=on over the binary,
     regression and 5-class models: each reply bit for bit its model's
     solo predict, one launch of C a coalesced batch; (f)
     serving.request:1:RuntimeError answers 500 once, predict.dispatch:1:oom
     halves the bucket with the same bits, a 5 s hang past
     watchdog_serve_s=0.5 answers 503 {"stall": true}, and a burst
     against serve_queue_depth=1 sheds with 503 and Retry-After; (g)
     python -m lightgbm_tpu_torch task=serve in a subprocess: the port from
     its log line, one JSON request equal to Booster.predict, /metrics
     with the serving families, then (h)'s load, SIGTERM and exit code 0;
     (h) against (g)'s process, the median and p99 request latency at 1,
     16 and 256 rows a request with 1 and 16 clients (JSON; the clients in
     a process of their own, ``--load-clients``), rows/s, dispatches a
     request (its /metrics), and C's ms a dispatch at each warm bucket
     (CUDA events; device time by the profiler);
 13. crash-safe, observable training on the main path (bench shape,
     fused_tiled, kernels A and B), from a binary cache of phase 2's
     bins written once, every 10-tree text held byte for byte against
     phase 3's main-path text: (a) telemetry off, counters and trace in
     turns, A and B launching as in phase 3, torch.cuda.synchronize
     counted (0 at off), the grower's gauges, iterations and
     trees_dispatched, the trace export holding train, boost_iter and
     the five grower phases (a 1-tree seg_tiled run for the partition),
     ms/tree each; (b) a child process killed by SIGKILL at the 8th
     iteration (checkpoint_freq=2: rolling files 6 and 4), a second one
     resuming with resume=auto to phase 3's text, and a bit-flipped
     checkpoint named by resume= failing loudly; the checkpoint's
     bytes, save ms, resume ms and kill-to-model wall; (c) snapshots
     every 3 iterations, the newest 2 kept, each predicting as the final
     model's first trees; (d) an injected ConnectionError retried to
     phase 3's text, and propagating with dispatch_retries=0; (f) the
     dataset.cache_io and native.entry seams failing loudly with a
     flight dump naming them; (e) three seeds of
     chaos:<seed>:2:gbdt.train_one_iter and of chaos:<seed>:2:checkpoint.io
     at 100,000 rows and 5 trees, each child restarted with resume=auto
     until it completes (three failures at most) and judged by the
     invariant registry, beside (g) python -m lightgbm_tpu_torch
     task=train with telemetry_out and telemetry_prom_out; (h) the
     numbers with the card's name and power limit;
 14. models in production at the bench shape on kernels A, B and C,
     with the card's name and power limit beside every number: (a)
     quality=on, 10 trees: phase 3's text, A and B as in phase 3, the
     profile's feature counts each the bincount of its bins, the
     capture's ms, the sidecar's bytes, and the profile's sample scores
     against the served ones; (b) quality_sample_rate=0.25 through a
     registry and the HTTP frontend: every reply bit for bit
     Booster.predict, held-out rows under quality_psi_warn, feature 3
     shifted by 3 sigma named with one warning on a fresh monitor, the
     quality_* gauges on /metrics, GET /quality/m, 1-row latency with the
     monitor off and on and the observer's ms; (c) an slo_rules file (a
     p99 latency rule, a shed-ratio rule): a serving.request slow:300
     fault makes GET /slo answer 503, journals slo_breach and makes
     `python -m lightgbm_tpu_torch.slo check` exit 1; cleared, it
     recovers and the check exits 0; (d) one continue-mode cycle of the
     continuous lane on the bench rows and phase 3's model with two
     100,000-row slices (5 trees, 20% held out), published while 4
     clients send requests: no reply fails, each is its version's
     Booster.predict, every reply after the cutover the new version's,
     torch.cuda.synchronize never called; ms by phase, and again with
     no client; (e) a lane child (``--lane-child``) SIGKILLed at each
     phase's continuous.cycle seam and at the 4th iteration of its train
     phase (continuous_checkpoint_freq=2), each restarted: the published
     model byte for byte (d)'s, ledger_converges, no_partial_artifacts,
     loud_failure and resume_byte_identical hold, kill-to-published
     wall; (f) a live-metric regression rolls the registry back, a
     refit-mode cycle moves leaf values only, and python -m
     lightgbm_tpu_torch task=serve with continuous_ingest_dir publishes a
     dropped slice and exits 0 on SIGTERM;
 15. data-parallel training: (a) the tcp plane — two ``--dist-child``
     processes on the card, each with half of the bench rows and
     collective_transport=tcp, rendezvous, gather their boundary
     candidates (bin_construct_sample_cnt = the row count) and the bin
     rows, and train 10 main-path trees through GBDT.train_one_iter:
     both ranks' mapper fingerprints and global bins equal the parent's
     single-process construction, both model texts are byte for byte
     the parent's single-process run, and each child launches A and B
     as often as it does; the rendezvous, the candidate and bin gathers
     (bytes, ms), ms a tree, the straggler ratio and one
     TcpTransport.exchange_histograms round of a (126, 28, 64, 3) f32
     histogram under f32/q16/q8 (ms, wire bytes, bit for bit the host
     codec); (b) the codec on CUDA tensors: the first round's xla
     histograms of the two row halves through exchange_histograms
     under f32/q16/q8, bit for bit the same call on CPU copies (the
     mesh codec, the JAX mesh's arithmetic; under f32 also the host
     codec's sum), q16's wire bytes half of f32's and q8's a quarter; (c) the mesh:
     tree_learner=data with mesh_shape=(2,) on one card warns and
     trains the serial text; the data learner's two shards (on two
     cards where there are two, else both on this card) train
     regression_l1 on the xla plan to the serial text — at the bench
     rows under f32, and under q16 and q8 on a 512-row set whose
     integer histograms the codec ships exactly;
 16. the other parallel learners and sharded construction (every shard
     on this card, or one a card where there are several): (a) the
     feature learner (the vertical partition) on 2 and 4 shards trains
     regression_l1 (63 leaves, so the serial frontier never binds; the
     xla plan; every histogram integral) to the serial text byte for
     byte, and binary at the bench params to a held-out AUC above 0.75
     in 3 trees, ms/tree against the serial xla plan; (b) the voting
     learner: with top_k=14 (every feature selected) the data learner's
     l1 text but for splits whose features tie in gain over the same
     rows (a tie goes to the first feature in vote order); with top_k=5
     at the bench params its wire bytes a round are two shards' (L, 10,
     B, 3) f32 histograms and (L, 28) votes (the counters), ms/tree and
     logloss against the data learner; with top_k=5 on 20,000 rows
     (regression_l1) split for split the same run on the CPU, leaves
     within 1e-6 relative; (c) sharded_shards=4 on the bench rows
     (bin_construct_sample_cnt = the row count) with a temporary shard
     cache: the fingerprint and bins are phase 15's single-matrix
     construction's, 10 fused_tiled trees on the shards are its text
     byte for byte with A and B launched as often, a reload from the
     cache (memmapped) trains the same text, the data learner over the
     shards placed per device trains the serial l1 text; build, save
     and load s and bytes; (d) elastic rejoin: three ``--rejoin-child``
     ranks on 99,999 rows with transport_epoch_iters=1, rank 2 killed
     at its third epoch boundary, a joiner admitted from rank 0's
     shard-cache manifest and the captured state: ranks 0, 1 and 3
     finish the single-process 8-tree text on a world of 3, each
     launching A and B;
 17. the row-sharded multi-process plane (collective_transport=xla,
     torch.distributed): (a) two ``--plane-child`` ranks on the one card
     over gloo (gloo stages the CUDA tensors through the host: the
     plane's logic on the card, not NCCL's speed) train the data learner
     on the first bench rows that fill a whole number of xla chunks a
     rank (bin_construct_sample_cnt = those rows), 10 trees at the bench
     params: both ranks' texts byte for byte each other's and the
     parent's single-process 2-shard mesh run on the same rows, each
     rank's resident bin bytes half of that run's; rendezvous s,
     construction s, ms/tree a rank, histogram wire bytes a tree, the
     straggler ratio; (b) one exchange_histograms_ranks of a
     (126, 28, 64, 3) f32 histogram a rank under f32, q16 and q8 across
     the two ranks, bit for bit exchange_histograms over the same two
     histograms on the card, its ms and wire bytes; (c) with two or more
     visible cards the same run as (a) over NCCL, one card a rank, its
     text byte for byte (a)'s; with one card it prints why (c) did not
     run;
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
        # sampled, on the held-out file (its 200,000 rows: the training
        # file's two-round pass took ~25 s of the script)
        full = dict(params, bin_construct_sample_cnt=max(len(yv), 1000000))
        t0 = time.perf_counter()
        one = lgb.Dataset(valid_p, params=full).construct()
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = lgb.Dataset(valid_p, params=dict(
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
        print(f"[phase 11] (e) the held-out file ({len(yv)} rows): one-round "
              f"{one_s:.2f} s, two-round {two_s:.2f} s (65,536-row chunks), "
              f"the bins byte-identical; "
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


def http_call(port, path, body=None, ctype="application/json", accept=None,
              method=None, timeout=60):
    """One HTTP request to the serving listener: (status, headers,
    body bytes); an error status is returned, not raised."""
    import urllib.error
    import urllib.request
    headers = {"Content-Type": ctype}
    if accept:
        headers["Accept"] = accept
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers, method=method)
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


#: phase 12's three wire formats: JSON and CSV bodies answered in JSON,
#: and the f32 binary frame answered in raw f64 (Accept)
WIRE_FORMATS = ("json", "csv", "f32")


def encode_rows(fmt, rows):
    """(body, content type, accept, the rows the server sees)."""
    if fmt == "json":
        return (json.dumps({"rows": rows.tolist()}).encode(),
                "application/json", None, rows)
    if fmt == "csv":
        return ("\n".join(",".join(repr(float(v)) for v in row)
                          for row in rows).encode(), "text/csv", None, rows)
    # (imported here: the load generator, which sends JSON, need not
    # import torch)
    from lightgbm_tpu_torch.serving import BINARY_F32, BINARY_F64
    r32 = np.ascontiguousarray(rows, dtype="<f4")
    return r32.tobytes(), BINARY_F32, BINARY_F64, r32.astype(np.float64)


def decode_reply(fmt, status, headers, raw):
    """(version, float64 predictions) of a 200 reply."""
    if status != 200:
        raise AssertionError(f"HTTP {status}: {raw[:300]!r}")
    if fmt == "f32":
        return (int(headers["X-Model-Version"]),
                np.frombuffer(raw, dtype="<f8").copy())
    obj = json.loads(raw)
    return obj["version"], np.asarray(obj["predictions"], dtype=np.float64)


def run_clients(port, model, plan, n_clients, rows_of):
    """``plan``: (format, start, n) requests, shared round robin by
    ``n_clients`` threads; returns {i: (version, predictions, seconds of
    the HTTP round trip)}; a reply other than 200 fails the run.  The
    clients run in this process, sharing its interpreter lock with the
    server's threads (phase 12 (h) measures from a process of its own,
    ``load_clients``)."""
    import threading
    out, errors = {}, []

    def client(c):
        for i in range(c, len(plan), n_clients):
            fmt, s, n = plan[i]
            body, ctype, accept, _ = encode_rows(fmt, rows_of(s, n))
            t0 = time.perf_counter()
            try:
                st, hd, raw = http_call(port, f"/predict/{model}", body,
                                        ctype, accept)
                dt = time.perf_counter() - t0
                out[i] = decode_reply(fmt, st, hd, raw) + (dt,)
            except Exception as e:    # reported below, with the request
                errors.append((i, repr(e)[:300]))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"client errors {errors[:3]} "
                             f"({len(errors)} in all)")
    return out


def load_clients(argv) -> int:
    """``chip_smoke.py --load-clients PORT MODEL ROWS CLIENTS PER SEED F``:
    phase 12 (h)'s load generator, run in a process of its own so that
    its threads do not share the server's interpreter lock: CLIENTS
    threads each POST PER JSON requests of ROWS random rows of F
    features, one after another; prints one JSON line {"ms": [round
    trip of each answered request], "shed": n, "wall_s": s}."""
    import threading
    port, model = int(argv[0]), argv[1]
    rows_n, clients, per, seed, f = (int(a) for a in argv[2:7])
    rng = np.random.RandomState(seed)
    bodies = [encode_rows("json", rng.randn(rows_n, f))[0]
              for _ in range(min(per * clients, 64))]
    ms, shed, errors = [], [], []

    def client(c):
        for j in range(per):
            body = bodies[(c * per + j) % len(bodies)]
            t0 = time.perf_counter()
            try:
                st, _, raw = http_call(port, f"/predict/{model}", body)
            except OSError as e:        # refused, reset, timed out
                errors.append(repr(e)[:200])
                continue
            dt = (time.perf_counter() - t0) * 1e3
            if st == 200:
                ms.append(dt)
            elif st == 503:
                shed.append(dt)
            else:
                errors.append(f"HTTP {st}: {raw[:200]!r}")

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors:
        print(f"load clients: {errors[:3]}", file=sys.stderr)
        return 1
    print(json.dumps({"ms": ms, "shed": len(shed), "wall_s": wall}))
    return 0


def check_online_serving(lgb, kernels, P, main_text, texts, Xv, dev, card,
                         rehearse):
    """Phase 12: online serving on the card (serving/: the micro-batcher,
    lanes, co-batcher, registry and HTTP frontend, and task=serve).
    ``main_text`` is phase 3's 10-tree main-path model, ``texts`` phase
    5's regression and multiclass models.  The launch counters are zeroed
    just before (a) and read just after (f); every response is checked
    against Booster.predict of the same rows after that window.  Returns
    ({kernel: launches}, numbers for predict_level_global)."""
    import os
    import shutil
    import tempfile
    import threading

    import torch

    from lightgbm_tpu_torch.reliability.faults import FAULTS
    from lightgbm_tpu_torch.serving import ModelRegistry, ServingFrontend
    from lightgbm_tpu_torch.telemetry import TELEMETRY as TM
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    C = ("predict_level", "predict_level_global")
    tmp = tempfile.mkdtemp(prefix="ltt_phase12_")
    paths = {}
    for name, text in (("main", main_text), ("reg", texts["regression"]),
                       ("mc", texts["multiclass"])):
        paths[name] = os.path.join(tmp, f"{name}.txt")
        with open(paths[name], "w") as f:
            f.write(text)
    base = {"device": dev.type, "verbose": -1, "telemetry": "counters"}
    # (b)-(e) check bits, swaps, lanes and fusion under 16 clients in
    # this process, whose threads share one interpreter lock: admission
    # control is held off there (a shed is a 503, which (c) forbids) and
    # tested in (f); (h) measures under the default serve_shed_deadline_ms
    no_shed = {"serve_shed_deadline_ms": 60_000.0}

    def config(**over):
        return lgb.Config.from_params(dict(base, **over))

    def c_launches():
        return sum(kernels.LAUNCHES[k] for k in C)

    def rows_of(s, n):
        return Xv[s:s + n]

    # on the card each publish warms the implicit ladder; the CPU's
    # implicit warm is empty, and the rehearsal warms the same ladder
    # explicitly, so no first dispatch builds a predictor under load
    cpu_warm = None if on_card else tuple(16 << i for i in range(7))

    def publish(reg, name, path, **kw):
        return reg.publish(name, path, warm=cpu_warm, **kw)

    rng = np.random.RandomState(12)
    n_req = 96 if rehearse else 192
    plan = []
    for i in range(n_req):
        n = int(rng.randint(1, 65))
        plan.append((WIRE_FORMATS[i % 3], int(rng.randint(0, len(Xv) - n)),
                     n))
    numbers, answers = {}, {}
    frontend = None
    try:
        # ---- the counted window: (a)-(f) drive only the serving path
        kernels.reset_launches()
        TM.reset()
        P.reset_predict_telemetry()
        # (a) publish with the implicit warm ladder, then the frontend
        cfg = config(**no_shed)
        reg = ModelRegistry(cfg)
        ladder = reg._default_warm({})
        t0 = time.perf_counter()
        e1 = publish(reg, "m", paths["main"])
        warm_s = time.perf_counter() - t0
        frontend = ServingFrontend(reg, cfg)
        port = frontend.start(0).server_address[1]
        print(f"[phase 12] (a) published 'm' v1 ({e1.booster.num_trees()} "
              f"trees) with the implicit warm ladder {list(ladder)} in "
              f"{warm_s * 1e3:.1f} ms ({len(ladder)} launches of C); the "
              f"frontend on port {port} ({card})")
        if on_card and ladder != tuple(16 << i for i in range(7)):
            raise AssertionError(f"(12a): warm ladder {ladder}")
        # (b) 16 clients, mixed sizes and formats; the first dispatches
        # tapped (their bucket and scores kept for the plain version)
        pred1 = served(e1.booster)
        tapped, orig = [], pred1._dispatch

        def tap(x2):
            # a bucket past 64 rows holds several requests (each has
            # at most 64): a coalesced dispatch
            out = orig(x2)
            if len(tapped) < 4 and x2.shape[0] > 64:
                tapped.append((x2.clone(), out.clone()))
            return out

        pred1._dispatch = tap
        P.reset_predict_telemetry()
        c0 = c_launches()
        answers["b"] = run_clients(port, "m", plan, 16, rows_of)
        b_disp = P.PREDICT_TELEMETRY["dispatches"]
        b_launch = c_launches() - c0
        del pred1._dispatch
        if b_disp >= n_req or (on_card and b_launch != b_disp):
            raise AssertionError(f"(12b): {b_disp} dispatches, {b_launch} "
                                 f"launches of C for {n_req} requests")
        print(f"[phase 12] (b) {n_req} requests of 1-64 rows (JSON, CSV, "
              f"f32 -> f64) from 16 clients: {b_disp} coalesced dispatches "
              f"({b_launch} launches of C)")
        # (c) hot swap under (b)'s traffic (the plan four times over):
        # phase 5's regression model as v2 once a quarter of the
        # requests were answered, then a rollback
        swap = {}
        c_plan = plan * 4
        base_n = TM.counters().get("serve_http_requests", 0)

        def swapper():
            end = time.perf_counter() + 60
            while TM.counters().get("serve_http_requests", 0) - base_n \
                    < len(c_plan) // 4 and time.perf_counter() < end:
                time.sleep(0.001)
            swap["entry"] = publish(reg, "m", paths["reg"])

        th = threading.Thread(target=swapper)
        th.start()
        answers["c"] = run_clients(port, "m", c_plan, 16, rows_of)
        th.join(120)
        versions = sorted({v for v, _, _ in answers["c"].values()})
        if "entry" not in swap or versions != [1, 2]:
            raise AssertionError(f"(12c): versions served {versions}")
        e1b = reg.rollback("m")
        answers["c_after"] = run_clients(port, "m", plan[:24], 4, rows_of)
        print(f"[phase 12] (c) v2 published under traffic "
              f"({len(c_plan)} requests): versions served {versions}, no "
              f"error status; rolled back to v{e1b.version}")
        frontend.stop(drain=True)
        frontend = None
        # (d) two lanes simulated on the one card
        cfg_d = config(serve_lanes="2", **no_shed)
        reg_d = ModelRegistry(cfg_d)
        e_d = publish(reg_d, "m", paths["main"])
        frontend = ServingFrontend(reg_d, cfg_d)
        port = frontend.start(0).server_address[1]
        answers["d"] = run_clients(port, "m", plan, 16, rows_of)
        st, _, raw = http_call(port, "/models", method="GET")
        fleet = json.loads(raw)["_fleet"]
        lanes = [ln["dispatches"] for ln in fleet["lanes"]]
        if fleet["n_lanes"] != 2 or min(lanes) < 1:
            raise AssertionError(f"(12d): fleet {fleet}")
        print(f"[phase 12] (d) serve_lanes=2 on one card: dispatches by "
              f"lane {lanes}")
        frontend.stop(drain=True)
        frontend = None
        # (e) co-batching: the binary, regression and 5-class models
        cfg_e = config(serve_cobatch="on", **no_shed)
        reg_e = ModelRegistry(cfg_e)
        members = ("main", "reg", "mc")
        ents = {m: publish(reg_e, m, paths[m],
                           predict_kwargs={"device": True})
                for m in members}
        group = ents["main"].cobatch
        if group is None or any(ents[m].cobatch is not group
                                for m in members):
            raise AssertionError("(12e): the three models did not fuse")
        frontend = ServingFrontend(reg_e, cfg_e)
        port = frontend.start(0).server_address[1]
        TM.reset()
        c0 = c_launches()
        e_plan = [(members[i % 3],) + plan[i] for i in range(n_req)]
        outs_e, errs = {}, []

        def e_client(c):
            for i in range(c, len(e_plan), 16):
                m, fmt, s, n = e_plan[i]
                body, ctype, accept, _ = encode_rows(fmt, rows_of(s, n))
                try:
                    outs_e[i] = decode_reply(fmt, *http_call(
                        port, f"/predict/{m}", body, ctype, accept))
                except Exception as e:
                    errs.append(repr(e)[:200])

        ts = [threading.Thread(target=e_client, args=(c,))
              for c in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)
        if errs:
            raise AssertionError(f"(12e): {errs[:3]}")
        cnt = TM.counters()
        e_launch = c_launches() - c0
        fused_d = cnt.get("serve_cobatch_dispatches", 0)
        fused_m = cnt.get("serve_cobatch_fused_models", 0)
        if (on_card and e_launch != fused_d) or fused_m <= fused_d:
            raise AssertionError(f"(12e): {e_launch} launches of C, "
                                 f"{fused_d} co-batched dispatches of "
                                 f"{fused_m} member batches")
        print(f"[phase 12] (e) co-batch of {list(group.names)}: "
              f"{len(e_plan)} requests, {fused_d} fused dispatches "
              f"carrying {fused_m} member batches, {e_launch} launches of "
              "C (one a coalesced batch)")
        frontend.stop(drain=True)
        frontend = None
        # (f) faults: a handler crash, an OOM at the dispatch and a
        # hang past the serving deadline, then a burst against a
        # one-request queue
        cfg_f = config(watchdog_serve_s=0.5)
        reg_f = ModelRegistry(cfg_f)
        e_f = publish(reg_f, "m", paths["main"])
        frontend = ServingFrontend(reg_f, cfg_f)
        port = frontend.start(0).server_address[1]
        body64, _, _, rows64 = encode_rows("json", Xv[:64])
        FAULTS.configure("serving.request:1:RuntimeError")
        st1, _, _ = http_call(port, "/predict/m", body64)
        st2, _, raw2 = http_call(port, "/predict/m", body64)
        FAULTS.configure("predict.dispatch:1:oom")
        st3, _, raw3 = http_call(port, "/predict/m", body64)
        cap = served(e_f.booster)._oom_cap
        FAULTS.configure("predict.dispatch:1:hang:5000")
        st4, hd4, raw4 = http_call(port, "/predict/m", body64)
        FAULTS.reset()
        for t in threading.enumerate():      # the abandoned hang ends
            if t.name.startswith("ltpu-deadline-"):
                t.join(30)
        if (st1, st2, st3, st4) != (500, 200, 200, 503) \
                or not json.loads(raw4).get("stall") \
                or hd4.get("Retry-After") is None or cap != 32:
            raise AssertionError(f"(12f): statuses {(st1, st2, st3, st4)}, "
                                 f"OOM cap {cap}")
        answers["f"] = [json.loads(raw2)["predictions"],
                        json.loads(raw3)["predictions"]]
        frontend.stop(drain=True)
        frontend = None
        cfg_q = config(serve_queue_depth=1, serve_batch_deadline_ms=0.0)
        reg_q = ModelRegistry(cfg_q)
        publish(reg_q, "m", paths["main"])
        frontend = ServingFrontend(reg_q, cfg_q)
        port = frontend.start(0).server_address[1]
        gate, inside = threading.Event(), threading.Event()
        batcher = reg_q.get("m").batcher
        real = batcher.predict

        def gated(rows):
            inside.set()
            gate.wait(60)
            return real(rows)

        batcher.predict = gated
        admitted = []
        body1, _, _, _ = encode_rows("json", Xv[:1])
        first = threading.Thread(target=lambda: admitted.append(
            http_call(port, "/predict/m", body1)))
        first.start()
        inside.wait(60)
        second = threading.Thread(target=lambda: admitted.append(
            http_call(port, "/predict/m", body1)))
        second.start()
        end = time.perf_counter() + 60
        while batcher.depth() < 1 and time.perf_counter() < end:
            time.sleep(0.001)
        shed = [http_call(port, "/predict/m", body1) for _ in range(8)]
        gate.set()
        first.join(60)
        second.join(60)
        batcher.predict = real
        codes = sorted(s_ for s_, _, _ in admitted)
        if codes != [200, 200] or any(
                s_ != 503 or not h.get("Retry-After") for s_, h, _ in shed):
            raise AssertionError(f"(12f) burst: admitted {codes}, shed "
                                 f"{[s_ for s_, _, _ in shed]}")
        frontend.stop(drain=True)
        frontend = None
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        print(f"[phase 12] (f) serving.request:1:RuntimeError -> {st1} then "
              f"{st2}; predict.dispatch:1:oom -> {st3} at bucket cap {cap}; "
              f"watchdog_serve_s=0.5 with a 5 s hang -> {st4} "
              f"{{'stall': true}}; serve_queue_depth=1: 8 of a burst shed "
              f"with 503 and Retry-After {shed[0][1].get('Retry-After')}")
        print(f"[phase 12] (a)-(f) launches {launches}")
        # ---- the checks against Booster.predict (not counted)
        b1 = e1.booster
        b2 = swap["entry"].booster
        want = {1: {}, 2: {}}
        for i, (fmt, s, n) in enumerate(plan):
            rows = encode_rows(fmt, rows_of(s, n))[3]
            want[1][i] = b1.predict(rows)
            want[2][i] = b2.predict(rows)
        for label in ("b", "c", "c_after", "d"):
            for i, (v, got, _) in answers[label].items():
                if label != "c" and v != 1:
                    raise AssertionError(f"(12{label}) request {i}: v{v}")
                if not np.array_equal(got, want[v][i % n_req]):
                    raise AssertionError(f"(12{label}) request {i}: not bit "
                                         f"for bit v{v}'s Booster.predict")
        for i, (_, got, _) in answers["b"].items():
            if not np.array_equal(answers["d"][i][1], got):
                raise AssertionError(f"(12d) request {i}: not (b)'s bits")
        for i, (x2, out) in enumerate(tapped):
            plain = P.predict_level_records_plain(pred1.records, x2,
                                                  depth=pred1.depth)
            if not torch.equal(out.view(torch.int32),
                               plain.view(torch.int32)):
                raise AssertionError(f"(12b) tapped dispatch {i} (bucket "
                                     f"{x2.shape[0]}): kernel C != plain")
        for i, (m, fmt, s, n) in enumerate(e_plan):
            rows = encode_rows(fmt, rows_of(s, n))[3]
            v, got = outs_e[i]
            if not np.array_equal(got, np.asarray(
                    ents[m].booster.predict(rows, device=True),
                    np.float64).reshape(got.shape)):
                raise AssertionError(f"(12e) {m} request {i}: not bit for "
                                     "bit its solo predict")
        ref64 = e_f.booster.predict(rows64).tolist()
        if answers["f"] != [ref64, ref64]:
            raise AssertionError("(12f): the replies after the fault and "
                                 "through the OOM ladder differ from "
                                 "Booster.predict")
        print(f"[phase 12] every response of (b)-(f) bit for bit its "
              f"version's Booster.predict (JSON by repr, f64 bytes); "
              f"{len(tapped)} tapped coalesced dispatches (buckets "
              f"{[int(x.shape[0]) for x, _ in tapped]}) bit for bit "
              "predict_level_records_plain")
        # (g) task=serve in a subprocess, and (h) the load generator (a
        # process of its own) against it: a serving process that holds
        # the model and nothing of the phases before
        lat = {}

        def measure(port):
            for rows_n in (1, 16, 256):
                for clients in (1, 16):
                    per = (4 if clients == 1 else 2) if rehearse else \
                        (60 if clients == 1 else 20)
                    before = scrape_counters(port)
                    r = subprocess.run(
                        [sys.executable, os.path.abspath(__file__),
                         "--load-clients", str(port), "main", str(rows_n),
                         str(clients), str(per),
                         str(rows_n * 100 + clients), str(Xv.shape[1])],
                        capture_output=True, text=True, timeout=600)
                    if r.returncode != 0:
                        raise AssertionError(f"(12h) load clients: "
                                             f"{r.stderr}")
                    res = json.loads(r.stdout.strip().splitlines()[-1])
                    after = scrape_counters(port)
                    ms = np.asarray(res["ms"])
                    n_req = per * clients
                    def delta(k):
                        return after.get(k, 0) - before.get(k, 0)

                    def mean(h):
                        return delta(h + "_sum") / max(delta(h + "_count"),
                                                       1)

                    key = f"{rows_n}_rows_{clients}_clients"
                    lat[key] = {
                        "requests": n_req, "shed": res["shed"],
                        "median_ms": float(np.median(ms)),
                        "p99_ms": float(np.percentile(ms, 99)),
                        "rows_per_s": rows_n * len(ms) / res["wall_s"],
                        "dispatches_per_request":
                            delta("predict_dispatches") / max(len(ms), 1),
                        # the server's own view (its histograms' means):
                        # the route handler, and the coalescing wait in it
                        "server_request_ms": mean("serve_request_ms"),
                        "server_queue_wait_ms": mean("serve_queue_wait_ms"),
                        "server_predict_ms": mean("predict_latency_ms")}
                    print(f"[phase 12] (h) {rows_n} rows a request, "
                          f"{clients} client(s), {n_req} requests "
                          f"({res['shed']} shed with 503): median "
                          f"{lat[key]['median_ms']:.3f} ms, p99 "
                          f"{lat[key]['p99_ms']:.3f} ms, "
                          f"{lat[key]['rows_per_s']:.0f} rows/s, "
                          f"{lat[key]['dispatches_per_request']:.3f} "
                          "dispatches a request; the server's mean "
                          f"handler {lat[key]['server_request_ms']:.3f} "
                          "ms, of it queue wait "
                          f"{lat[key]['server_queue_wait_ms']:.3f}, a "
                          "dispatch's predict "
                          f"{lat[key]['server_predict_ms']:.3f} ms "
                          f"(task=serve; {card})")

        g_s = serve_cli(paths["main"], Xv, b1, dev, tmp, measure)
        print(f"[phase 12] (g) task=serve: one JSON request equal to "
              f"Booster.predict, /metrics scraped, (h)'s load served, "
              f"SIGTERM -> exit 0, {g_s:.1f} s")
        # (h) C's ms a dispatch at each serving bucket
        cfg_h = config()
        reg_h = ModelRegistry(cfg_h)
        e_h = publish(reg_h, "m", paths["main"])
        pred_h = served(e_h.booster)
        c_ms, c_dev = {}, {}
        for b in reg_h._default_warm({}) or (16, 64, 256, 1024):
            x2 = launched_x2(P, pred_h, Xv[:b], dev)

            def launch(x2=x2):
                return P.predict_level_ensemble(pred_h.records, x2,
                                                depth=pred_h.depth)

            c_ms[b] = time_ms(launch, dev, 3 if rehearse else 50)
            c_dev[b] = device_ms(launch, 50) if on_card else None
            tier = P.level_plan(pred_h.records, b, x2.shape[1]).tier
            print(f"[phase 12] (h) kernel C at bucket {b} ({tier} tier): "
                  f"{c_ms[b]:.4f} ms a dispatch ("
                  + ("CUDA events" if on_card else "wall clock")
                  + f"), {fmt_ms(c_dev[b])} device (profiler; {card})")
        reg_h.close()
        numbers.update(phase12_latency=lat, phase12_c_ms_by_bucket=c_ms,
                       phase12_c_device_ms_by_bucket=c_dev,
                       phase12_warm_ms=warm_s * 1e3)
    finally:
        FAULTS.reset()
        if frontend is not None:
            frontend.stop(drain=True)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[phase 12] wall {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches, numbers


def scrape_counters(port) -> dict:
    """The counters and histogram sums and counts of a serving process's
    ``/metrics`` (``ltpu_x_total`` -> ``x``, ``ltpu_h_sum`` -> ``h_sum``,
    ``ltpu_h_count`` -> ``h_count``)."""
    st, _, raw = http_call(port, "/metrics", method="GET")
    if st != 200:
        raise AssertionError(f"/metrics answered {st}")
    out = {}
    for line in raw.decode().splitlines():
        m = re.match(r"ltpu_(\w+?)(_total|_sum|_count) (\S+)$", line)
        if m:
            key = m.group(1) + ("" if m.group(2) == "_total"
                                else m.group(2))
            out[key] = float(m.group(3))
    return out


def serve_cli(model_path, Xv, bst, dev, tmp, load):
    """Phase 12 (g): ``python -m lightgbm_tpu_torch task=serve`` in a
    subprocess on ``model_path``: the port from its endpoint line, one
    JSON request (equal to ``bst.predict``), a /metrics scrape, then
    ``load(port)`` ((h)'s measurement), SIGTERM and exit code 0.
    Returns its wall seconds."""
    import os
    import signal
    t0 = time.perf_counter()
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-u", "-m", "lightgbm_tpu_torch", "task=serve",
           f"input_model={model_path}", "serve_port=0", "telemetry=counters"]
    if dev.type == "cpu":
        cmd.append("device=cpu")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=tmp)
    lines, port = [], None
    try:
        end = time.perf_counter() + 300
        while time.perf_counter() < end:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"http://127\.0\.0\.1:(\d+)/predict/main", line)
            if m:
                port = int(m.group(1))
                break
        if port is None:
            raise AssertionError("(12g): no endpoint line:\n"
                                 + "".join(lines[-20:]))
        body, _, _, rows = encode_rows("json", Xv[:5])
        st, hd, raw = http_call(port, "/predict/main", body)
        if decode_reply("json", st, hd, raw)[1].tolist() != \
                bst.predict(rows).tolist():
            raise AssertionError("(12g): the reply differs from "
                                 "Booster.predict")
        st, _, prom = http_call(port, "/metrics", method="GET")
        if b"ltpu_serve_http_requests_total" not in prom \
                or b"ltpu_predict_" not in prom:
            raise AssertionError("(12g): /metrics lacks the serving "
                                 "families")
        load(port)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(60)
            raise
    rest = proc.stdout.read()
    if rc != 0:
        raise AssertionError(f"(12g): task=serve exited {rc}:\n"
                             + "".join(lines[-10:]) + rest[-2000:])
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 13: crash-safe, observable training on the card
# ---------------------------------------------------------------------------
#: phase 13 (e)'s chaos runs: rows, trees, seeds and seam globs
CHAOS_ROWS = 100_000
CHAOS_TREES = 5
CHAOS_SEEDS = (1, 2, 3)
CHAOS_GLOBS = ("gbdt.train_one_iter", "checkpoint.io")
#: the grower's phases (learner/grower.py), each a span at telemetry=trace
GROWER_PHASES = ("histogram", "partition", "split_finder", "apply_split",
                 "tree_record")


def train_child(argv) -> int:
    """``--train-child SPEC``: one lgb.train run in a process of its own
    (phase 13 (b), (e)), which a SIGKILL may end.  SPEC is a JSON file:
    the binary cache to train from, the params, the rounds, the model
    path, and whether to print the counters after every iteration.
    Prints one JSON line an iteration (with ``report``) and one at the
    end: the wall, the launches, the counters and the spans' ms."""
    with open(argv[0]) as f:
        spec = json.load(f)
    import torch

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.telemetry import TELEMETRY
    params = spec["params"]
    ds = lgb.Dataset(spec["cache"], params=params)
    ds.construct()

    def report(env):
        print(json.dumps({"iteration": env.iteration + 1,
                          "counters": TELEMETRY.counters()}), flush=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    bst = lgb.train(params, ds, spec["rounds"], verbose_eval=False,
                    callbacks=[report] if spec.get("report") else None)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bst.save_model(spec["out"])
    spans = {}
    for name, _t, dur, *_ in TELEMETRY.events_snapshot():
        spans[name] = spans.get(name, 0.0) + dur * 1e3
    print(json.dumps({"done": True, "wall_s": wall,
                      "launches": _launched(kernels),
                      "counters": TELEMETRY.counters(), "span_ms": spans}),
          flush=True)
    return 0


def run_train_child(spec, path, timeout=300):
    """Write ``spec`` to ``path`` and run ``--train-child`` on it from the
    repo root.  Returns (exit code, the JSON lines it printed, its
    stderr's tail, wall seconds of the process)."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("LTPU_FAULT_PLAN", None)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--train-child", path], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = []
    for ln in r.stdout.splitlines():
        if ln.startswith("{"):
            try:
                lines.append(json.loads(ln))
            except ValueError:
                pass
    return r.returncode, lines, r.stderr[-2000:], wall


def _add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def chaos_run(seed, glob_, cache, params, ref_path, workroot):
    """Phase 13 (e): one seeded chaos plan against a training child,
    restarted with resume=auto until it completes or has failed three
    times; the invariant registry judges what it left.  Returns (the
    plan, the exit codes, the violations, the launches of its runs)."""
    import glob as _glob
    import os

    from lightgbm_tpu_torch.reliability.chaos import chaos_spec
    from lightgbm_tpu_torch.reliability.invariants import (ChaosContext,
                                                           run_invariants)
    spec = chaos_spec(seed, 2, glob_)
    wd = os.path.join(workroot, f"chaos_{seed}_{glob_.split('.')[0]}")
    os.makedirs(wd)
    model = os.path.join(wd, "model.txt")
    p = dict(params, checkpoint_freq=1, output_model=model,
             retry_backoff_s=0.0, watchdog_dispatch_s=3.0,
             watchdog_checkpoint_s=3.0,
             flight_recorder_out=os.path.join(wd, "flight"))
    rcs, launches = [], {}
    while len([rc for rc in rcs if rc != 0]) < 3:
        run = dict(p, fault_plan=spec) if not rcs else p
        rc, lines, err, _ = run_train_child(
            {"cache": cache, "params": run, "rounds": CHAOS_TREES,
             "out": model}, os.path.join(wd, f"spec{len(rcs)}.json"))
        rcs.append(rc)
        if lines and lines[-1].get("done"):
            _add_launches(launches, lines[-1]["launches"])
        if rc == 0:
            break
    ctx = ChaosContext(
        workdir=wd, reference_model=ref_path, final_model=model,
        exit_code=rcs[0], work_lost=rcs[0] != 0,
        flight_dumps=_glob.glob(os.path.join(wd, "*.flight.json")),
        seed=seed, plan=spec)
    found = [f"{name}: {v}" for name, vs in run_invariants(ctx).items()
             for v in vs]
    if rcs[-1] != 0:
        found.append(f"the run did not complete in {len(rcs)} starts "
                     f"(exit codes {rcs})")
    return spec, rcs, found, launches


def check_crash_safe(lgb, kernels, params, core, X, y, main_text,
                     main_launches, dev, card, rehearse):
    """Phase 13.  ``core`` is phase 2's binned training rows, ``main_text``
    phase 3's main-path model text and ``main_launches`` its launches.
    Returns (the phase's launches by kernel, its numbers)."""
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from lightgbm_tpu_torch import dataset_io, native
    from lightgbm_tpu_torch.reliability import checkpoint as ck
    from lightgbm_tpu_torch.reliability.faults import FAULTS
    from lightgbm_tpu_torch.telemetry import TELEMETRY as TM
    t_phase = time.perf_counter()
    total, numbers = {}, {}
    A, B = "fused_route_hist", "route_apply"

    def need(label, got, want_text=main_text):
        if got != want_text:
            raise AssertionError(f"phase 13 {label}: the model text differs "
                                 "from phase 3's main-path text")

    def held_launches(label, launches):
        _add_launches(total, launches)
        if rehearse:
            return
        for k in (A, B):
            if launches.get(k, 0) != main_launches.get(k, 0):
                raise AssertionError(
                    f"phase 13 {label}: {k} launched {launches.get(k, 0)} "
                    f"times, phase 3's main path {main_launches.get(k, 0)}")

    tmp = tempfile.mkdtemp(prefix="ltt_phase13_")
    try:
        # the bench rows' cache, written once; its own 10-tree text is
        # held against phase 3's in (a)
        cache = os.path.join(tmp, "bench.bin")
        t0 = time.perf_counter()
        dataset_io.save_binary(core, cache)
        print(f"[phase 13] wrote the bench rows' binary cache "
              f"({os.path.getsize(cache)} bytes) in "
              f"{time.perf_counter() - t0:.2f} s")

        def from_cache():
            return lgb.Dataset(cache, params=params)

        # (a) telemetry off, counters and trace on the main path, in
        # turns, twice
        real_sync = torch.cuda.synchronize
        ms_tree = {}
        for rnd, mode in enumerate(("off", "counters", "trace") * 2):
            TM.configure(mode)
            TM.reset()
            ds = from_cache()
            ds.construct()
            syncs = [0]

            def counted_sync(*a, **k):
                syncs[0] += 1
                return real_sync(*a, **k)
            kernels.reset_launches()
            torch.cuda.synchronize = counted_sync
            try:
                t0 = time.perf_counter()
                bst = lgb.train(params, ds, 10, verbose_eval=False,
                                keep_training_booster=True)
                _sync(dev)
                wall = time.perf_counter() - t0
            finally:
                torch.cuda.synchronize = real_sync
            n_sync = syncs[0] - (dev.type == "cuda")   # _sync's own call
            launches = _launched(kernels)
            held_launches(f"(a) telemetry={mode}", launches)
            need(f"(a) telemetry={mode}", bst.model_to_string())
            ms_tree.setdefault(mode, []).append(1e3 * wall / 10)
            c, g = TM.counters(), TM.gauges()
            if mode == "off":
                if c or g or TM.events_snapshot():
                    raise AssertionError("phase 13 (a): telemetry=off "
                                         "recorded something")
                if n_sync != 0:
                    raise AssertionError(
                        f"phase 13 (a): telemetry=off called "
                        f"torch.cuda.synchronize {n_sync} times in training "
                        "(the parent's training path calls it nowhere)")
            else:
                want = {"grower.hist_kernel": "fused_tiled",
                        "bin_matrix_bytes":
                            bst.gbdt.grower.resident_bin_bytes()}
                for key, val in want.items():
                    if g.get(key) != val:
                        raise AssertionError(f"phase 13 (a) {mode}: gauge "
                                             f"{key} = {g.get(key)}, not {val}")
                if c.get("iterations") != 10 or \
                        c.get("trees_dispatched") != 10:
                    raise AssertionError(f"phase 13 (a) {mode}: counters "
                                         f"{c}")
            if mode == "trace" and rnd < 3:
                # seg_tiled builds the leaf partition: 1 tree for its phase
                kernels.reset_launches()
                lgb.train(dict(params, hist_leaf_partition="on"),
                          from_cache(), 1, verbose_eval=False)
                _add_launches(total, _launched(kernels))
                _, perfetto = TM.export(os.path.join(tmp, "trace"))
                with open(perfetto) as f:
                    names = {e["name"] for e in json.load(f)["traceEvents"]
                             if e.get("ph") == "X"}
                miss = {"train", "boost_iter", *GROWER_PHASES} - names
                if miss:
                    raise AssertionError(f"phase 13 (a): the trace export "
                                         f"lacks {sorted(miss)}")
                print(f"[phase 13] (a) the trace export ({perfetto}) holds "
                      f"train, boost_iter and {', '.join(GROWER_PHASES)}; "
                      f"{len(TM.events_snapshot())} spans")
            print(f"[phase 13] (a) telemetry={mode}: {ms_tree[mode][-1]:.1f} "
                  f"ms/tree (wall of lgb.train / 10), model text equal to "
                  f"phase 3's, torch.cuda.synchronize {n_sync} times, "
                  f"launches {launches}; gauges {dict(g)}; {card}")
            del bst
        TM.configure("off")
        TM.reset()
        numbers["ms_tree"] = ms_tree

        # (b) SIGKILL at the 8th iteration, then resume=auto
        bdir = os.path.join(tmp, "b")
        os.makedirs(bdir)
        model = os.path.join(bdir, "model.txt")
        pb = dict(params, checkpoint_freq=2, output_model=model)
        rc, lines, err, _ = run_train_child(
            {"cache": cache, "params": dict(
                pb, telemetry="counters",
                fault_plan="gbdt.train_one_iter:8:kill"),
             "rounds": 10, "out": model, "report": True},
            os.path.join(bdir, "kill.json"))
        if rc != -9 or os.path.exists(model):
            raise AssertionError(f"phase 13 (b): the killed child exited "
                                 f"{rc}, not by SIGKILL: {err}")
        t_kill = time.perf_counter()
        kept = [it for it, _ in ck.list_checkpoints(model + ".ckpt")]
        if kept != [6, 4] or len(lines) != 7:
            raise AssertionError(f"phase 13 (b): after the kill the rolling "
                                 f"checkpoints are {kept}, not [6, 4] "
                                 f"(iterations reported: {len(lines)})")
        c1 = lines[-1]["counters"]
        ck_bytes = os.path.getsize(ck.checkpoint_file(model + ".ckpt", 6))
        save_ms = c1["checkpoint_save_ms"] / c1["checkpoint_saves"]
        rc, lines, err, resume_wall = run_train_child(
            {"cache": cache, "params": dict(pb, telemetry="spans"),
             "rounds": 10, "out": model}, os.path.join(bdir, "resume.json"))
        kill_to_model = time.perf_counter() - t_kill
        if rc != 0 or not lines or not lines[-1].get("done"):
            raise AssertionError(f"phase 13 (b): the resumed child exited "
                                 f"{rc}: {err}")
        _add_launches(total, lines[-1]["launches"])
        with open(model) as f:
            need("(b) resumed after SIGKILL", f.read())
        resume_ms = lines[-1]["span_ms"].get("checkpoint_resume")
        if resume_ms is None:
            raise AssertionError("phase 13 (b): the resumed child recorded "
                                 "no checkpoint_resume span")
        # the read the resume scan makes before that span: open, sha256,
        # unpickle (warm: the file was just written)
        t0 = time.perf_counter()
        ck.read_checkpoint(ck.checkpoint_file(model + ".ckpt", 10))
        read_ms = 1e3 * (time.perf_counter() - t0)
        # one bit flipped: an explicit resume= path fails loudly
        flipped = os.path.join(bdir, "flipped.ckpt")
        blob = bytearray(open(ck.checkpoint_file(model + ".ckpt", 10),
                              "rb").read())
        blob[len(blob) // 2] ^= 0x10
        with open(flipped, "wb") as f:
            f.write(bytes(blob))
        try:
            lgb.train(pb, from_cache(), 10, verbose_eval=False,
                      resume=flipped)
        except ck.CheckpointError as e:
            loud = str(e)
        else:
            raise AssertionError("phase 13 (b): a bit-flipped checkpoint "
                                 "named by resume= did not fail the run")
        print(f"[phase 13] (b) SIGKILL at iteration 8 (exit -9), rolling "
              f"checkpoints {kept}; resume=auto finished 10 trees, model "
              f"text byte for byte phase 3's; a flipped bit fails loudly "
              f"({loud[:80]}...); checkpoint {ck_bytes} bytes, save "
              f"{save_ms:.2f} ms (checkpoint_save_ms / saves, {c1['checkpoint_saves']:g} "
              f"saves), read {read_ms:.2f} ms (warm), restore "
              f"{resume_ms:.2f} ms (checkpoint_resume span), "
              f"the resumed process {resume_wall:.2f} s, kill to saved model "
              f"{kill_to_model:.2f} s; {card}")
        numbers.update(checkpoint_bytes=ck_bytes, checkpoint_save_ms=save_ms,
                       checkpoint_read_ms=read_ms,
                       checkpoint_resume_ms=resume_ms,
                       resume_process_s=resume_wall,
                       kill_to_model_s=kill_to_model)

        # (c) snapshots every 3 iterations, the newest 2 kept
        cdir = os.path.join(tmp, "c")
        os.makedirs(cdir)
        model_c = os.path.join(cdir, "model.txt")
        kernels.reset_launches()
        bst = lgb.train(dict(params, snapshot_freq=3, snapshot_keep=2,
                             output_model=model_c), from_cache(), 10,
                        verbose_eval=False)
        held_launches("(c) snapshots", _launched(kernels))
        need("(c) snapshots", bst.model_to_string())
        snaps = sorted(os.path.basename(p) for p in os.listdir(cdir))
        if snaps != ["model.txt.snapshot_iter_6", "model.txt.snapshot_iter_9"]:
            raise AssertionError(f"phase 13 (c): left {snaps}")
        final = lgb.Booster(model_str=main_text,
                            params={"device": dev.type})
        rows = X[:20_000]
        for it in (6, 9):
            snap = lgb.Booster(model_file=os.path.join(
                cdir, f"model.txt.snapshot_iter_{it}"),
                params={"device": dev.type})
            first = lgb.Booster(
                model_str=final.model_to_string(num_iteration=it),
                params={"device": dev.type})
            got = snap.predict(rows, raw_score=True)
            want = first.predict(rows, raw_score=True)
            if snap.num_trees() != it or not np.array_equal(got, want):
                raise AssertionError(f"phase 13 (c): snapshot_iter_{it} does "
                                     f"not predict as the first {it} trees")
        print(f"[phase 13] (c) snapshot_freq=3, snapshot_keep=2: {snaps}, "
              "each predicting bit for bit as the final model's first 6 / 9 "
              "trees; no *.tmp file")
        del bst

        # (d) a retried iteration, then retries exhausted
        TM.configure("counters")
        TM.reset()
        FAULTS.configure("gbdt.train_one_iter:3:ConnectionError")
        kernels.reset_launches()
        bst = lgb.train(dict(params, dispatch_retries=2, retry_backoff_s=0.0),
                        from_cache(), 10, verbose_eval=False)
        held_launches("(d) retried", _launched(kernels))
        need("(d) retried", bst.model_to_string())
        c = TM.counters()
        if c.get("retries") != 1 or c.get("faults_injected") != 1 \
                or c.get("retry_exhausted_total"):
            raise AssertionError(f"phase 13 (d): retry counters {c}")
        FAULTS.configure("gbdt.train_one_iter:3:ConnectionError")
        kernels.reset_launches()
        try:
            lgb.train(dict(params, dispatch_retries=0), from_cache(), 10,
                      verbose_eval=False)
        except ConnectionError:
            pass
        else:
            raise AssertionError("phase 13 (d): with dispatch_retries=0 the "
                                 "injected error did not propagate")
        _add_launches(total, _launched(kernels))
        FAULTS.reset()
        print(f"[phase 13] (d) ConnectionError at iteration 3: one retry "
              f"(retries {c.get('retries'):g}, faults_injected "
              f"{c.get('faults_injected'):g}), the text phase 3's; with "
              "dispatch_retries=0 it propagates")
        del bst

        # (f) the dataset cache and native seams fail loudly
        fdir = os.path.join(tmp, "f")
        TM.flight.arm(os.path.join(fdir, "flight"))
        for seam, exc, call in (
                ("dataset.cache_io", OSError,
                 lambda: from_cache().construct()),
                ("native.entry", RuntimeError,
                 lambda: lgb.Dataset(X[:2000], label=y[:2000],
                                     params=params).construct())):
            FAULTS.configure(f"{seam}:1:{exc.__name__}")
            try:
                call()
            except exc as e:
                if "injected at seam" not in str(e):
                    raise
            else:
                raise AssertionError(f"phase 13 (f): {seam} did not fail")
            with open(TM.flight.dumps[-1]) as f:
                if json.load(f).get("seam") != seam:
                    raise AssertionError(f"phase 13 (f): the flight dump "
                                         f"does not name {seam}")
            FAULTS.reset()
            print(f"[phase 13] (f) {seam}:1:{exc.__name__} failed loudly; "
                  f"the flight dump {TM.flight.dumps[-1]} names the seam")
        TM.flight.disarm()
        TM.configure("off")
        TM.reset()
        if not native.loaded():
            raise AssertionError("phase 13 (f): the native library did not "
                                 "load again after the injected fault")

        # (e) chaos plans and (g) the CLI's exports, side by side
        m = min(CHAOS_ROWS, X.shape[0])
        small = os.path.join(tmp, "chaos.bin")
        dataset_io.save_binary(lgb.Dataset(X[:m], label=y[:m],
                                           params=params).construct(),
                               small)
        ref = os.path.join(tmp, "chaos_ref.txt")
        kernels.reset_launches()
        lgb.train(params, lgb.Dataset(small, params=params), CHAOS_TREES,
                  verbose_eval=False).save_model(ref)
        _add_launches(total, _launched(kernels))
        gdir = os.path.join(tmp, "g")
        os.makedirs(gdir)
        conf = os.path.join(gdir, "train.conf")
        with open(conf, "w") as f:
            f.write("\n".join(_bench_conf(params) + [
                "task=train", f"data={cache}", "num_trees=10",
                f"output_model={gdir}/model.txt", "telemetry=counters",
                f"telemetry_out={gdir}/run",
                f"telemetry_prom_out={gdir}/run.prom"]) + "\n")

        def cli_run():
            root = os.path.dirname(os.path.abspath(__file__))
            env = dict(os.environ, PYTHONPATH=root)
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                                f"config={conf}"], cwd=root, env=env,
                               capture_output=True, text=True, timeout=300)
            return r, time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=7) as ex:
            g_fut = ex.submit(cli_run)
            futs = [ex.submit(chaos_run, seed, g_, small, params, ref, tmp)
                    for g_ in CHAOS_GLOBS for seed in CHAOS_SEEDS]
            results = [f.result() for f in futs]
            cli_r, cli_s = g_fut.result()
        chaos_s = time.perf_counter() - t0
        bad = []
        for spec, rcs, found, launches in results:
            _add_launches(total, launches)
            print(f"[phase 13] (e) plan {spec}: exit codes {rcs}; "
                  f"violations {found or 'none'}")
            bad.extend(f"{spec}: {v}" for v in found)
        if bad:
            raise AssertionError("phase 13 (e): " + "; ".join(bad))
        print(f"[phase 13] (e) {len(results)} chaos plans at {m} rows x "
              f"{CHAOS_TREES} trees: resume_byte_identical, "
              f"no_partial_artifacts and loud_failure hold; {chaos_s:.1f} s "
              "with (g) beside them")
        if cli_r.returncode != 0:
            raise AssertionError(f"phase 13 (g): the CLI exited "
                                 f"{cli_r.returncode}: {cli_r.stderr[-2000:]}")
        with open(os.path.join(gdir, "model.txt")) as f:
            need("(g) the CLI", f.read())
        prom = open(os.path.join(gdir, "run.prom")).read()
        want = ["ltpu_iterations_total", "ltpu_grower_frontier_width",
                "ltpu_grower_rows_padded", "ltpu_bin_matrix_bytes"]
        miss = [w for w in want if w not in prom]
        jsonl = [json.loads(ln) for ln in open(os.path.join(gdir,
                                                            "run.jsonl"))]
        if miss or jsonl[-1].get("type") != "snapshot" or \
                jsonl[-1]["counters"].get("iterations") != 10:
            raise AssertionError(f"phase 13 (g): the exports lack {miss} or "
                                 "the JSONL snapshot")
        print(f"[phase 13] (g) python -m lightgbm_tpu_torch task=train with "
              f"telemetry=counters: {cli_s:.1f} s, the model text phase 3's, "
              f"{len(jsonl)} JSONL lines, the Prometheus file holds "
              f"{', '.join(want)}")
        wall = time.perf_counter() - t_phase
        numbers["phase_s"] = wall
        per_mode = "; ".join(
            f"{m} " + ", ".join(f"{v:.1f}" for v in ms_tree[m])
            for m in ("off", "counters", "trace"))
        print(f"[phase 13] (h) ms/tree in turns ({per_mode}); "
              f"checkpoint {ck_bytes} bytes, save {save_ms:.2f} ms, read "
              f"{read_ms:.2f} ms, restore {resume_ms:.2f} ms; kill to resumed "
              "model "
              f"{kill_to_model:.2f} s; phase 13 {wall:.1f} s; {card}")
        print(f"[phase 13] launches {total}")
        return total, numbers
    finally:
        FAULTS.reset()
        TM.flight.disarm()
        TM.configure("off")
        TM.reset()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 14: models in production (quality profiles and drift monitors, the
# SLO engine, the continuous train -> eval -> publish lane)
# ---------------------------------------------------------------------------
#: phase 14 (d)'s lane: two slices of this many rows, 5 new trees a cycle,
#: the last 20% of each slice held out for the gate
LANE_SLICE_ROWS = 100_000
LANE_ITERATIONS = 5
LANE_HOLDOUT = 0.2
#: (b)'s drift: this feature of the held-out rows shifted by 3 sigma
DRIFT_FEATURE = 3
#: (e)'s kill points: the continuous.cycle seam's call at each phase
#: entry, and the 4th iteration of the train phase (mid-cycle checkpoints
#: every 2 iterations)
KILL_POINTS = (("ingest", "continuous.cycle:1:kill"),
               ("train", "continuous.cycle:2:kill"),
               ("eval", "continuous.cycle:3:kill"),
               ("publish", "continuous.cycle:4:kill"),
               ("mid-train", "gbdt.train_one_iter:4:kill"))


def write_slice(path, X, y):
    """One ingest slice: the label, then the features, comma-separated
    (%.17g: the parser reads back the same doubles)."""
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.17g")


def first_cycle(lane, limit_s=600):
    """Start ``lane`` (its worker runs a cycle at its first poll) and wait
    for that cycle's decision; a failed cycle raises."""
    from lightgbm_tpu_torch.telemetry import TELEMETRY
    t0 = time.perf_counter()
    lane.start(mount_routes=False)
    while lane.last_cycle is None:
        if TELEMETRY.counters().get("continuous_cycle_failures") \
                or time.perf_counter() - t0 > limit_s:
            raise AssertionError(f"continuous lane {lane.name!r}: the "
                                 "cycle failed")
        time.sleep(0.002)
    return lane.last_cycle


def lane_child(argv) -> int:
    """``--lane-child SPEC``: one continuous-lane cycle in a process of its
    own (phase 14 (e)), which a SIGKILL may end.  SPEC is a JSON file: the
    lane's config (state and ingest directories, fault plan, flight
    recorder), the train params, the base model file and the base rows
    (.npy).  Prints one JSON line at the end: the wall, whether the cycle
    resumed, the gate's decision and the launches."""
    with open(argv[0]) as f:
        spec = json.load(f)
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.continuous import ContinuousLane
    from lightgbm_tpu_torch.ops import kernels
    X, y = np.load(spec["X"]), np.load(spec["y"])
    lane = ContinuousLane(lgb.Config.from_params(spec["config"]), None,
                          name="main", base_model=spec["base_model"],
                          base_data=X, base_label=y,
                          train_params=spec["params"])
    kernels.reset_launches()
    t0 = time.perf_counter()
    # the daemon's own worker runs the cycle (its first poll)
    rec = first_cycle(lane)
    lane.stop()
    print(json.dumps({"done": True, "wall_s": time.perf_counter() - t0,
                      "resumed": rec["resumed"], "accept": rec["accept"],
                      "candidate_metric": rec["candidate_metric"],
                      "launches": _launched(kernels)}), flush=True)
    return 0


def run_lane_child(spec, path, timeout=600):
    """Write ``spec`` to ``path`` and run ``--lane-child`` on it from the
    repo root: (exit code, its last JSON line or None, stderr's tail,
    wall seconds)."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("LTPU_FAULT_PLAN", None)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--lane-child", path], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    last = None
    for ln in r.stdout.splitlines():
        if ln.startswith('{"done"'):
            last = json.loads(ln)
    return r.returncode, last, r.stderr[-2000:], wall


def serve_lane_cli(conf_args, model, data, ingest, tmp):
    """Phase 14 (f): ``python -m lightgbm_tpu_torch task=serve`` with the
    continuous lane beside the frontend, until its ledger shows the
    dropped slice published; then SIGTERM.  Returns (exit code, the
    ledger, its output's tail, wall seconds)."""
    import os
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, "-u", "-m", "lightgbm_tpu_torch", "task=serve",
           f"input_model={model}", f"data={data}", "serve_port=0",
           f"continuous_ingest_dir={ingest}", "continuous_poll_s=0.5",
           "continuous_iterations=2"] + conf_args + ["verbose=1"]
    t0 = time.perf_counter()
    log = open(os.path.join(tmp, "serve_lane.log"), "w+")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=tmp)
    ledger_path = os.path.join(ingest, ".continuous", "ledger.json")
    led = {}
    try:
        end = time.perf_counter() + 400
        while time.perf_counter() < end and proc.poll() is None:
            if os.path.exists(ledger_path):
                with open(ledger_path) as f:
                    led = json.load(f)
                if led.get("published") or led.get("quarantined"):
                    break
            time.sleep(0.2)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(60)
            raise
    log.seek(0)
    out = log.read()
    log.close()
    return rc, led, out, time.perf_counter() - t0


def check_production(lgb, kernels, params, train_ds, core, X, y, w, Xv,
                     main_text, main_launches, dev, card, rehearse):
    """Phase 14.  ``core`` is phase 2's binned rows (``train_ds``'s, raw
    rows kept), ``w`` the concept make_data drew for them, ``main_text``
    phase 3's main-path model text and ``main_launches`` its launches.
    Returns (the phase's launches by kernel, its numbers)."""
    import io
    import os
    import shutil
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from lightgbm_tpu_torch import slo
    from lightgbm_tpu_torch.continuous import ContinuousLane
    from lightgbm_tpu_torch.quality import build_profile, profile_path
    from lightgbm_tpu_torch.quality.profile import score_counts, strided_rows
    from lightgbm_tpu_torch.reliability.faults import FAULTS
    from lightgbm_tpu_torch.reliability.invariants import (ChaosContext,
                                                           run_invariants)
    from lightgbm_tpu_torch.serving import ModelRegistry, ServingFrontend
    from lightgbm_tpu_torch.telemetry import TELEMETRY as TM
    t_phase = time.perf_counter()
    total, numbers = {}, {}
    A, B = "fused_route_hist", "route_apply"
    C = ("predict_level", "predict_level_global")
    slice_rows = 400 if rehearse else LANE_SLICE_ROWS
    tmp = tempfile.mkdtemp(prefix="ltt_phase14_")
    reg = frontend = reg_off = lane = None
    try:
        TM.configure("counters")
        TM.reset()
        # the slices (the bench's concept, new rows) and the children's
        # base rows
        t0 = time.perf_counter()
        ingest = os.path.join(tmp, "ingest")
        os.makedirs(ingest)
        slices = [make_data(slice_rows, 28, seed=s, w=w)[:2]
                  for s in (21, 22, 23)]
        for i in (0, 1):
            write_slice(os.path.join(ingest, f"s{i}.csv"), *slices[i])
        xs_path, ys_path = (os.path.join(tmp, "X.npy"),
                            os.path.join(tmp, "y.npy"))
        np.save(xs_path, X)
        np.save(ys_path, y)
        print(f"[phase 14] wrote 2 slices of {slice_rows} rows and the base "
              f"rows in {time.perf_counter() - t0:.1f} s")

        # (a) profile capture on the main path
        qparams = dict(params, quality="on")
        kernels.reset_launches()
        t0 = time.perf_counter()
        bst = lgb.train(qparams, train_ds, 10, verbose_eval=False,
                        keep_training_booster=True)
        _sync(dev)
        train_s = time.perf_counter() - t0
        launches = _launched(kernels)
        _add_launches(total, launches)
        if bst.model_to_string() != main_text:
            raise AssertionError("phase 14 (a): the quality=on model text "
                                 "differs from phase 3's")
        if not rehearse and any(launches.get(k, 0) != main_launches.get(k, 0)
                                for k in (A, B)):
            raise AssertionError(f"phase 14 (a): launches {launches}, phase "
                                 f"3's main path {main_launches}")
        prof = bst.quality_profile
        if prof is None:
            raise AssertionError("phase 14 (a): quality=on left no profile")
        qcfg = lgb.Config.from_params(qparams)
        cap = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = build_profile(bst, core, qcfg)
            cap.append(1e3 * (time.perf_counter() - t0))
        if again.to_dict() != prof.to_dict():
            raise AssertionError("phase 14 (a): a second capture differs")
        lbins = core.logical_group_bins()
        for f in core.features:
            want = np.bincount(lbins[:, f.group], minlength=f.num_bin)
            if f.collapsed_default or not np.array_equal(
                    prof.features[f.feature_idx]["counts"], want):
                raise AssertionError(f"phase 14 (a): feature "
                                     f"{f.feature_idx}'s counts are not the "
                                     "bincount of its bins")
        model_path = os.path.join(tmp, "main.txt")
        bst.save_model(model_path)
        side = os.path.getsize(profile_path(model_path))
        # the profile scored its sample in the session (below 2M rows x
        # trees the serving predictor, kernel C; from 2M the binned
        # scan); serving scores a loaded copy through C
        sample = strided_rows(X, int(qcfg.quality_profile_rows))
        prof_scores = np.asarray(bst.predict(sample)).reshape(-1)
        served_scores = lgb.Booster(model_file=model_path, params={
            "device": dev.type}).predict(sample)
        edges = np.asarray(prof.score["edges"])
        moved = np.nonzero(np.searchsorted(edges, prof_scores) !=
                           np.searchsorted(edges, served_scores))[0]
        same_counts = np.array_equal(score_counts(served_scores, edges),
                                     prof.score["counts"])
        first = ("none" if not len(moved) else
                 f"row {moved[0]}: {prof_scores[moved[0]]!r} (profile) "
                 f"against {served_scores[moved[0]]!r} (served)")
        print(f"[phase 14] (a) quality=on, 10 trees: {train_s:.2f} s, the "
              f"model text phase 3's, launches {launches}; capture "
              f"{min(cap):.1f} ms (build_profile again, best of 3: "
              f"{', '.join(f'{c:.1f}' for c in cap)}), 28 feature counts "
              f"each the bincount of its bins, the sidecar {side} bytes; "
              f"the profile's {len(sample)} sample scores against the "
              f"served ones (kernel C): {len(moved)} rows in another "
              f"bucket, counts equal {same_counts}, max |d| "
              f"{np.abs(prof_scores - served_scores).max():.3g}, first "
              f"{first}; {card}")
        numbers.update(capture_ms=min(cap), sidecar_bytes=side,
                       profile_bucket_moves=int(len(moved)))
        del bst, again

        # (b) drift monitors through the registry and the frontend
        scfg = lgb.Config.from_params(dict(params, quality_sample_rate=0.25,
                                           telemetry="counters"))
        reg = ModelRegistry(scfg)
        frontend = ServingFrontend(reg, scfg)
        entry = reg.publish("m", model_path)
        mon = entry.monitor
        if mon is None or mon.stride != 4:
            raise AssertionError("phase 14 (b): no monitor armed at stride 4")
        port = frontend.start(0).server_address[1]
        direct = lgb.Booster(model_file=model_path,
                             params={"device": dev.type})
        per = 25 if rehearse else 500
        n_req = 40

        def send(rows_of, label):
            got = run_clients(port, "m", [("json", i * per, per)
                                          for i in range(n_req)], 4, rows_of)
            for i, (_v, preds, _dt) in got.items():
                want = direct.predict(rows_of(i * per, per))
                if not np.array_equal(preds, want):
                    raise AssertionError(f"phase 14 (b) {label}: reply {i} "
                                         "is not Booster.predict")
            return got
        send(lambda s, n: Xv[s:s + n], "held-out")
        if not mon.wait_observed(n_req * per):
            raise AssertionError("phase 14 (b): the monitor did not observe")
        calm = mon.report()
        if calm["worst_feature_psi"] >= calm["psi_warn"]:
            raise AssertionError(f"phase 14 (b): unshifted rows drift "
                                 f"({calm['worst_feature_psi']})")
        # (the first refresh scores the first sampled batch alone: a
        # small one can pass psi_warn by sampling noise, as in the JAX
        # monitor; calm["warned"] says whether it did)
        warns0 = TM.counters().get("quality_drift_warns", 0)
        # the shifted rows against a fresh monitor: the same file
        # published again (v2)
        entry = reg.publish("m", model_path)
        mon = entry.monitor
        Xs = np.array(Xv[n_req * per:2 * n_req * per])
        Xs[:, DRIFT_FEATURE] += 3.0 * X[:, DRIFT_FEATURE].std()
        send(lambda s, n: Xs[s:s + n], "shifted")
        if not mon.wait_observed(n_req * per):
            raise AssertionError("phase 14 (b): the monitor did not observe")
        rep = mon.report()
        if rep["worst_feature"] != DRIFT_FEATURE or not rep["warned"] \
                or TM.counters().get("quality_drift_warns") != warns0 + 1:
            raise AssertionError(f"phase 14 (b): the shift of feature "
                                 f"{DRIFT_FEATURE} was not named once: "
                                 f"{rep['worst_feature']}, {rep['warned']}")
        st, _, prom = http_call(port, "/metrics", method="GET")
        want_g = [f"ltpu_quality_psi_m_f{DRIFT_FEATURE}",
                  "ltpu_quality_worst_feature_psi_m",
                  "ltpu_quality_score_psi_m", "ltpu_quality_sampled_rows_m"]
        miss = [g for g in want_g if g.encode() not in prom]
        st_q, _, body_q = http_call(port, "/quality/m", method="GET")
        if st != 200 or miss or st_q != 200 or \
                json.loads(body_q)["worst_feature"] != DRIFT_FEATURE:
            raise AssertionError(f"phase 14 (b): /metrics lacks {miss} or "
                                 f"/quality/m answered {st_q}")
        # 1-row latency with the monitor off and on, in turns; the
        # observer's own ms on a sampled dispatch
        reg_off = ModelRegistry(lgb.Config.from_params(dict(
            params, quality="off")))
        if reg_off.publish("m", model_path).monitor is not None:
            raise AssertionError("phase 14 (b): quality=off armed a monitor")
        lat = {"off": [], "on": []}
        for rnd in range(6):
            for key, r in (("off", reg_off), ("on", reg)):
                for i in range(100):
                    row = Xv[(rnd * 100 + i) % len(Xv)][None, :]
                    t0 = time.perf_counter()
                    r.predict("m", row)
                    lat[key].append(1e3 * (time.perf_counter() - t0))
        probe = type(mon)(prof, entry.booster,
                          lgb.Config.from_params(dict(
                              params, quality_sample_rate=1.0)), name="probe")
        obs = []
        for i in range(200):
            row = Xv[i][None, :]
            pred = direct.predict(row)
            t0 = time.perf_counter()
            probe.observe(row, pred)
            obs.append(1e3 * (time.perf_counter() - t0))
        med = {k: float(np.median(v)) for k, v in lat.items()}
        p99 = {k: float(np.percentile(v, 99)) for k, v in lat.items()}
        obs_ms = float(np.median(obs))
        share = obs_ms / 4 / med["on"]
        print(f"[phase 14] (b) quality_sample_rate=0.25 through the registry "
              f"and frontend: {2 * n_req} requests of {per} rows, every "
              f"reply bit for bit Booster.predict; unshifted worst PSI "
              f"{calm['worst_feature_psi']:.4f} (f{calm['worst_feature']}) "
              f"under {calm['psi_warn']} over {calm['sampled_rows']} sampled "
              f"rows (a warning on the first refresh: {calm['warned']}); "
              f"feature {DRIFT_FEATURE} shifted by 3 sigma, against a fresh "
              f"monitor (v2): named (PSI {rep['worst_feature_psi']:.3f}), one "
              f"warning, score PSI {rep['score_psi']:.3f}, the quality_* "
              f"gauges on /metrics, GET /quality/m 200; 1-row request "
              f"latency median {med['off']:.3f} ms off, {med['on']:.3f} ms "
              f"on (p99 {p99['off']:.3f} / {p99['on']:.3f}); the observer "
              f"{obs_ms:.3f} ms a sampled dispatch, {100 * share:.1f}% of a "
              f"monitored request at stride 4 (it runs after the reply); "
              f"{card}")
        numbers.update(calm_psi=calm["worst_feature_psi"],
                       calm_warned=calm["warned"],
                       latency_ms_off=med["off"], latency_ms_on=med["on"],
                       observer_ms=obs_ms, observer_share=share)

        # (c) the SLO engine on the same listener
        rules = os.path.join(tmp, "slo.json")
        with open(rules, "w") as f:
            json.dump({"fast_window_s": 1.0, "slow_window_s": 2.0, "rules": [
                {"name": "p99_latency", "kind": "quantile",
                 "hist": "serve_request_ms", "q": 0.99, "max_ms": 200},
                {"name": "shed_ratio", "kind": "ratio",
                 "num": "serve_shed_requests", "den": "serve_requests",
                 "max": 0.01}]}, f)
        lgb.Config.from_params(dict(params, slo_rules=rules,
                                    slo_eval_interval_s=60))
        TM.reset()
        one = encode_rows("json", Xv[:1])[0]
        stop = threading.Event()

        def traffic():
            while not stop.is_set():
                http_call(port, "/predict/m", one)

        def slo_status():
            return http_call(port, "/slo", method="GET")[0]
        for _ in range(200):
            http_call(port, "/predict/m", one)
        clean = slo_status()
        FAULTS.configure("serving.request:1:slow:300:x100000")
        t0 = time.perf_counter()
        feeders = [threading.Thread(target=traffic) for _ in range(4)]
        for t in feeders:
            t.start()
        time.sleep(1.2)
        breach = slo_status()
        breach_s = time.perf_counter() - t0
        root = os.path.dirname(os.path.abspath(__file__))
        r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch.slo",
                            "check", "--url", f"http://127.0.0.1:{port}"],
                           cwd=root, env=dict(os.environ, PYTHONPATH=root),
                           capture_output=True, text=True, timeout=120)
        FAULTS.reset()
        t_clear = time.perf_counter()
        recovered = None
        while time.perf_counter() - t_clear < 20:
            time.sleep(0.25)
            if slo_status() == 200:
                recovered = time.perf_counter() - t_clear
                break
        stop.set()
        for t in feeders:
            t.join(60)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_ok = slo.main(["check", "--url", f"http://127.0.0.1:{port}"])
        kinds = {e["kind"] for e in TM.journal.events()}
        slo.install(None)
        if (clean, breach, r.returncode, rc_ok) != (200, 503, 1, 0) \
                or recovered is None or "slo_breach" not in kinds \
                or "slo_recover" not in kinds:
            raise AssertionError(
                f"phase 14 (c): /slo {clean} then {breach}, check rc "
                f"{r.returncode} ({r.stdout[-300:]}), recovered "
                f"{recovered}, rc {rc_ok}, journal {kinds}")
        print(f"[phase 14] (c) slo_rules (p99 of serve_request_ms <= 200 ms, "
              f"shed ratio <= 0.01; windows 1 s / 2 s): GET /slo {clean}, "
              f"then serving.request slow:300 -> 503 after {breach_s:.1f} s, "
              f"slo_breach journaled, `python -m lightgbm_tpu_torch.slo "
              f"check` rc {r.returncode}; the fault cleared, recovered in "
              f"{recovered:.2f} s (slo_recover), check rc {rc_ok}")
        TM.reset()

        # (d) one continue-mode cycle on the bench rows and phase 3's model
        base_path = os.path.join(tmp, "base.txt")
        with open(base_path, "w") as f:
            f.write(main_text)
        lane_cfg = dict(params, continuous_ingest_dir=ingest,
                        continuous_iterations=LANE_ITERATIONS,
                        continuous_eval_holdout=LANE_HOLDOUT,
                        continuous_poll_s=3600, telemetry="counters")
        lane = ContinuousLane(lgb.Config.from_params(dict(
            lane_cfg, continuous_state_dir=os.path.join(tmp, "state_d"))),
            reg, name="main", base_model=base_path, base_data=X,
            base_label=y, train_params=params)
        marks = []
        enter = lane._phase

        def timed_phase(phase, cycle):
            marks.append((phase, time.perf_counter()))
            return enter(phase, cycle)
        lane._phase = timed_phase
        Xq = Xv[:64]
        body_q = encode_rows("json", Xq)[0]
        replies, errors, shed = [], [], []

        def client():
            # a request every ~2 ms a client; a 503 is admission control
            # shedding (counted apart), any other status a failure
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    st, hd, raw = http_call(port, "/predict/main", body_q)
                    if st == 503:
                        shed.append(t0)
                    else:
                        replies.append((t0, time.perf_counter() - t0)
                                       + decode_reply("json", st, hd, raw))
                except Exception as e:   # reported below
                    errors.append(repr(e)[:300])
                time.sleep(0.002)
        stop.clear()
        clients = [threading.Thread(target=client) for _ in range(4)]
        real_sync = torch.cuda.synchronize
        syncs = [0]

        def counted_sync(*a, **k):
            syncs[0] += 1
            return real_sync(*a, **k)
        # start() publishes the base model (v_base) and mounts
        # /continuous; its worker runs the cycle at its first poll
        kernels.reset_launches()
        torch.cuda.synchronize = counted_sync
        try:
            t0 = time.perf_counter()
            lane.start()
            v_base = reg.get("main").version
            for t in clients:
                t.start()
            while lane.last_cycle is None:
                if TM.counters().get("continuous_cycle_failures") or \
                        time.perf_counter() - t0 > 600:
                    raise AssertionError("phase 14 (d): the cycle failed")
                time.sleep(0.002)
            t_end = time.perf_counter()
            rec = lane.last_cycle
        finally:
            torch.cuda.synchronize = real_sync
        cycle_launches = _launched(kernels)
        time.sleep(0.3)
        stop.set()
        for t in clients:
            t.join(60)
        _add_launches(total, cycle_launches)
        cand_path = os.path.join(lane.state_dir, "model_cycle_1.txt")
        with open(cand_path) as f:
            cand_text = f.read()
        v_new = reg.get("main").version
        want = {v_base: lgb.Booster(model_file=base_path, params={
            "device": dev.type}).predict(Xq), v_new: lgb.Booster(
                model_file=cand_path, params={"device": dev.type}).predict(Xq)}
        bad = [v for _t, _d, v, p in replies
               if v not in want or not np.array_equal(p, want[v])]
        after = [v for t, _d, v, _p in replies if t > t_end]
        if not rec["accept"] or v_new == v_base or errors or bad \
                or not after or set(after) != {v_new}:
            raise AssertionError(
                f"phase 14 (d): accept {rec['accept']}, versions {v_base} -> "
                f"{v_new}, {len(errors)} failed replies {errors[:2]}, {len(bad)} "
                f"replies of no version, after the cutover {set(after)}")
        if syncs[0]:
            raise AssertionError(f"phase 14 (d): torch.cuda.synchronize was "
                                 f"called {syncs[0]} times during the cycle")
        if not rehearse and not (cycle_launches.get(A) and
                                 cycle_launches.get(B) and
                                 any(cycle_launches.get(k) for k in C)):
            raise AssertionError(f"phase 14 (d): launches {cycle_launches}")
        def phase_ms(marks, t_end):
            names = [p for p, _ in marks]
            if names != ["ingest", "train", "eval", "publish"]:
                raise AssertionError(f"phase 14 (d): phases {names}")
            ends = [t for _, t in marks[1:]] + [t_end]
            return {p: 1e3 * (e - s) for (p, s), e in zip(marks, ends)}
        by_phase = phase_ms(marks, t_end)
        t_train, t_eval = marks[1][1], marks[2][1]
        lat_train = [1e3 * d for t, d, _v, _p in replies
                     if t_train <= t < t_eval]
        lat_after = [1e3 * d for t, d, _v, _p in replies if t > t_end]
        print(f"[phase 14] (d) one continue-mode cycle (base {X.shape[0]} "
              f"rows and phase 3's 10 trees, 2 slices of {slice_rows} rows, "
              f"{LANE_ITERATIONS} new trees, {LANE_HOLDOUT:.0%} of each slice "
              f"held out): {rec['metric']} {rec['candidate_metric']:.5f} "
              f"against {rec['current_metric']:.5f}, published v{v_new} while "
              f"4 clients sent {len(replies) + len(shed)} requests: none "
              f"failed, {len(shed)} shed (503), each answer wholly its "
              f"version's Booster.predict, {len(after)} after the "
              f"cutover all v{v_new}; a request's median "
              f"{np.median(lat_train or [np.nan]):.2f} ms while the lane "
              f"trained, {np.median(lat_after or [np.nan]):.2f} after the "
              f"cutover; torch.cuda.synchronize 0 times; ms by "
              f"phase " + ", ".join(f"{p} {v:.0f}" for p, v in
                                   by_phase.items())
              + f" ({1e3 * (t_end - t0):.0f} from start(); ingest bins the "
              f"base rows once); launches {cycle_launches} (C: the seed, the "
              f"gate, the warm-up and the clients); {card}")
        # the same cycle again, no client, on a fresh state directory
        lane2 = ContinuousLane(lgb.Config.from_params(dict(
            lane_cfg, continuous_state_dir=os.path.join(tmp, "state_d2"))),
            None, name="main", base_model=base_path, base_data=X,
            base_label=y, train_params=params)
        marks2 = []
        enter2 = lane2._phase

        def timed_phase2(phase, cycle):
            marks2.append((phase, time.perf_counter()))
            return enter2(phase, cycle)
        lane2._phase = timed_phase2
        kernels.reset_launches()
        first_cycle(lane2)
        t_end2 = time.perf_counter()
        lane2.stop()
        _add_launches(total, _launched(kernels))
        by_phase2 = phase_ms(marks2, t_end2)
        with open(os.path.join(lane2.state_dir, "model_cycle_1.txt")) as f:
            if f.read() != cand_text:
                raise AssertionError("phase 14 (d): the cycle without "
                                     "clients trained other bytes")
        print(f"[phase 14] (d) the same cycle with no client, on a fresh "
              f"state directory: the same candidate bytes; ms by phase "
              + ", ".join(f"{p} {v:.0f}" for p, v in by_phase2.items())
              + f"; {card}")
        numbers.update(cycle_ms_by_phase=by_phase2,
                       cycle_ms_by_phase_under_clients=by_phase,
                       cycle_shed=len(shed),
                       request_ms_while_training=float(np.median(
                           lat_train or [np.nan])),
                       cycle_launches=cycle_launches)

        # (e) SIGKILL at each phase, then a restarted lane, side by side
        # with (f)'s task=serve
        cli_ingest = os.path.join(tmp, "cli_ingest")
        os.makedirs(cli_ingest)
        write_slice(os.path.join(cli_ingest, "s0.csv"),
                    slices[2][0][:slice_rows // 4],
                    slices[2][1][:slice_rows // 4])
        m_cli = min(X.shape[0], 50_000)
        cli_data = os.path.join(tmp, "cli_base.csv")
        write_slice(cli_data, X[:m_cli], y[:m_cli])

        def replay(label, plan):
            wd = os.path.join(tmp, f"kill_{label}")
            os.makedirs(wd)
            spec = {"config": dict(
                lane_cfg, continuous_state_dir=os.path.join(wd, "state"),
                continuous_checkpoint_freq=2, fault_plan=plan,
                flight_recorder_out=os.path.join(wd, "flight")),
                "params": params, "base_model": base_path, "X": xs_path,
                "y": ys_path}
            rc_k, _, err_k, _ = run_lane_child(spec, os.path.join(
                wd, "kill.json"))
            t_kill = time.perf_counter()
            spec["config"].pop("fault_plan")
            rc_r, last, err_r, _ = run_lane_child(spec, os.path.join(
                wd, "resume.json"))
            wall = time.perf_counter() - t_kill
            state = os.path.join(wd, "state")
            got = None
            if os.path.exists(os.path.join(state, "model_cycle_1.txt")):
                with open(os.path.join(state, "model_cycle_1.txt")) as f:
                    got = f.read()
            ctx = ChaosContext(
                workdir=wd, ledger_path=os.path.join(state, "ledger.json"),
                exit_code=rc_k, work_lost=True,
                flight_dumps=[os.path.join(wd, p) for p in os.listdir(wd)
                              if p.endswith(".flight.json")],
                reference_model=cand_path,
                final_model=os.path.join(state, "model_cycle_1.txt"))
            found = [f"{n}: {v}" for n, vs in run_invariants(ctx, [
                "ledger_converges", "no_partial_artifacts", "loud_failure",
                "resume_byte_identical"]).items() for v in vs]
            return (label, rc_k, rc_r, last, got, found, wall,
                    err_k[-300:], err_r[-300:])
        conf = _bench_conf(params)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(KILL_POINTS) + 1) as ex:
            cli_fut = ex.submit(serve_lane_cli, conf, base_path, cli_data,
                                cli_ingest, tmp)
            results = list(ex.map(lambda kp: replay(*kp), KILL_POINTS))
            cli_rc, cli_led, cli_out, cli_s = cli_fut.result()
        replay_s = time.perf_counter() - t0
        walls = {}
        for (label, rc_k, rc_r, last, got, found, wall, err_k,
             err_r) in results:
            if last:
                _add_launches(total, last["launches"])
            ok = (rc_k == -9 and rc_r == 0 and last is not None
                  and got == cand_text and not found
                  and last["accept"] == rec["accept"]
                  and last["resumed"] is (label != "ingest"))
            print(f"[phase 14] (e) killed at {label}: exit {rc_k}, the "
                  f"restarted lane exit {rc_r} (resumed "
                  f"{last and last['resumed']}), published model byte for "
                  f"byte (d)'s: {got == cand_text}; invariants "
                  f"{found or 'hold'}; kill to published {wall:.1f} s; "
                  f"launches {last and last['launches']}")
            if not ok:
                raise AssertionError(f"phase 14 (e) {label}: {err_k} | "
                                     f"{err_r}")
            walls[label] = wall
        print(f"[phase 14] (e) {len(results)} kill points, each a process "
              f"killed and one restarted, all at once beside (f)'s "
              f"task=serve: {replay_s:.1f} s; ledger_converges, "
              f"no_partial_artifacts, loud_failure and resume_byte_identical "
              f"hold; {card}")
        numbers["kill_to_published_s"] = walls

        # (f) rollback, refit, and task=serve with the lane
        if lane.report_live_metric(rec["candidate_metric"]) is not False:
            raise AssertionError("phase 14 (f): a steady live metric rolled "
                                 "back")
        worse = rec["candidate_metric"] + (-0.05 if rec.get(
            "bigger_is_better") else 0.05)
        if lane.report_live_metric(worse) is not True \
                or reg.get("main").version != v_base:
            raise AssertionError("phase 14 (f): the live regression did not "
                                 "roll the registry back")
        body_1 = encode_rows("json", Xq)[0]
        v, back = decode_reply("json", *http_call(port, "/predict/main",
                                                  body_1))
        if v != v_base or not np.array_equal(back, want[v_base]):
            raise AssertionError("phase 14 (f): after the rollback the reply "
                                 "is not the base version's")
        rdir = os.path.join(tmp, "refit")
        os.makedirs(rdir)
        write_slice(os.path.join(rdir, "s2.csv"), *slices[2])
        refit_lane = ContinuousLane(lgb.Config.from_params(dict(
            lane_cfg, continuous_ingest_dir=rdir, continuous_mode="refit",
            continuous_publish_max_regression=1.0)), None, name="main",
            base_model=base_path, base_data=X, base_label=y,
            train_params=params)
        kernels.reset_launches()
        t0 = time.perf_counter()
        rrec = first_cycle(refit_lane)
        refit_lane.stop()
        refit_s = time.perf_counter() - t0
        _add_launches(total, _launched(kernels))
        base_b = lgb.Booster(model_str=main_text, params={"device": dev.type})
        refit_b = lgb.Booster(model_file=os.path.join(
            refit_lane.state_dir, "model_cycle_1.txt"),
            params={"device": dev.type})

        def structure(b):
            return [(t.num_leaves, list(t.split_feature[:t.num_leaves - 1]),
                     list(t.threshold[:t.num_leaves - 1])) for t in b.models]
        moved_leaves = sum(int(np.sum(a.leaf_value[:a.num_leaves]
                                      != b.leaf_value[:b.num_leaves]))
                           for a, b in zip(refit_b.models, base_b.models))
        if structure(refit_b) != structure(base_b) or not moved_leaves:
            raise AssertionError("phase 14 (f): the refit cycle changed the "
                                 "structure or no leaf")
        if cli_rc != 0 or not cli_led.get("published") \
                or "continuous-training lane armed" not in cli_out:
            raise AssertionError(f"phase 14 (f): task=serve with the lane "
                                 f"exited {cli_rc}, ledger {cli_led}:\n"
                                 f"{cli_out[-3000:]}")
        print(f"[phase 14] (f) a live metric {worse:.5f} against the "
              f"published {rec['candidate_metric']:.5f} rolled the registry "
              f"back to v{v_base} (replies its bits again); a refit-mode "
              f"cycle ({refit_s:.1f} s, accept {rrec['accept']}) kept every "
              f"split and moved {moved_leaves} leaf values; python -m "
              f"lightgbm_tpu_torch task=serve with continuous_ingest_dir "
              f"published {cli_led['last_good']} and exited 0 on SIGTERM "
              f"({cli_s:.1f} s)")
        wall = time.perf_counter() - t_phase
        numbers["phase_s"] = wall
        print(f"[phase 14] capture {numbers['capture_ms']:.1f} ms; observer "
              f"{obs_ms:.3f} ms a sampled dispatch; cycle ms by phase "
              + ", ".join(f"{p} {v:.0f}" for p, v in by_phase2.items())
              + " (" + ", ".join(f"{p} {v:.0f}" for p, v in by_phase.items())
              + " under 4 clients)"
              + "; kill to published " + ", ".join(
                  f"{k} {v:.1f} s" for k, v in walls.items())
              + f"; phase 14 {wall:.1f} s; {card}")
        print(f"[phase 14] launches {total}")
        return total, numbers
    finally:
        FAULTS.reset()
        slo.install(None)
        if lane is not None:
            lane.stop(timeout_s=60)
        if frontend is not None:
            frontend.stop(drain=True)
        for r_ in (reg, reg_off):
            if r_ is not None:
                r_.close()
        TM.configure("off")
        TM.reset()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 15: data-parallel training (the tcp plane, the codec on the card,
# the mesh's data learner)
# ---------------------------------------------------------------------------
#: phase 15 (a)'s TcpTransport.exchange_histograms round: W=126 leaves, the
#: bench's 28 groups and 64 bins, 3 channels
EXCHANGE_SHAPE = (126, 28, 64, 3)


def dist_child(argv) -> int:
    """``--dist-child SPEC``: one rank of phase 15 (a)'s tcp plane in a
    process of its own.  SPEC is a JSON file: the coordinator address,
    the world, this rank, the bench rows and the params.  Builds its half
    of the bench rows, rendezvous, constructs (construct_sharded,
    finalize_global), trains ``rounds`` trees through
    GBDT.train_one_iter and runs one exchange_histograms round a codec;
    prints one JSON line."""
    import hashlib

    with open(argv[0]) as f:
        spec = json.load(f)
    import torch

    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.parallel import collectives as C
    from lightgbm_tpu_torch.parallel import distributed as D
    from lightgbm_tpu_torch.parallel import transport as T
    from lightgbm_tpu_torch.sharded import binfind
    from lightgbm_tpu_torch.telemetry import TELEMETRY

    rank, world, n = spec["rank"], spec["world"], spec["n_rows"]
    dev = torch.device(spec["params"]["device"])
    # counters with the device fence: the straggler monitor's gather
    TELEMETRY.configure("counters", fence=True)
    cfg = Config.from_params(dict(spec["params"],
                                  collective_transport="tcp"))
    X, y, _ = make_data(n, 28, seed=7)
    per = n // world
    Xl, yl = X[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    if dev.type == "cuda":
        torch.zeros(1, device=dev)          # the CUDA context first
    t0 = time.perf_counter()
    D.initialize(coordinator_address=spec["coord"], num_processes=world,
                 process_id=rank, config=cfg)
    out = {"rank": rank, "rendezvous_s": time.perf_counter() - t0}
    tp = T.active()

    def counter(name):
        return TELEMETRY.counters().get(name, 0)

    gather_remote = binfind.gather_merge_remote

    def timed_gather(cand, transport):
        b0, t = counter("collective_tcp_allgather_bytes"), \
            time.perf_counter()
        merged = gather_remote(cand, transport)
        out["cand_ms"] = (time.perf_counter() - t) * 1e3
        out["cand_bytes"] = counter("collective_tcp_allgather_bytes") - b0
        return merged
    binfind.gather_merge_remote = timed_gather
    allgather = D._allgather
    gathers = []

    def timed_allgather(arr):
        t = time.perf_counter()
        got = allgather(arr)
        gathers.append((int(got.nbytes), (time.perf_counter() - t) * 1e3))
        return got
    D._allgather = timed_allgather
    t0 = time.perf_counter()
    ds = D.construct_sharded(Xl, label=yl, config=cfg)
    ds = D.finalize_global(ds)
    out["construct_s"] = time.perf_counter() - t0
    out["bins_bytes"], out["bins_ms"] = gathers[-1]
    out["fingerprint"] = binfind.mapper_fingerprint(ds.mappers, ds._bundles,
                                                    ds.max_bin)
    out["bins_sha"] = hashlib.sha256(
        np.ascontiguousarray(ds.group_bins).tobytes()).hexdigest()
    g = GBDT(cfg, ds)
    kernels.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(spec["rounds"]):
        g.train_one_iter()
    _sync(dev)
    out["ms_tree"] = (time.perf_counter() - t0) * 1e3 / spec["rounds"]
    out["launches"] = _launched(kernels)
    g.flush_models()
    out["model_sha"] = hashlib.sha256("".join(
        t.to_string() for t in g.models).encode()).hexdigest()
    gauges = TELEMETRY.gauges()
    out["straggler_ratio"] = gauges.get("straggler_ratio")
    out["straggler_ratio_peak"] = gauges.get("straggler_ratio_peak")
    # one exchange round a codec: every rank's histogram from its seed,
    # so each rank can hold the wire result against the host codec
    hists = [(np.random.RandomState(100 + r).randn(*EXCHANGE_SHAPE)
              * 40).astype(np.float32) for r in range(world)]
    out["exchange"] = {}
    for mode in C.HIST_EXCHANGE_MODES:
        tp.barrier()
        b0 = counter("collective_tcp_hist_exchange_bytes")
        t = time.perf_counter()
        got = tp.exchange_histograms(hists[rank], mode)
        ms = (time.perf_counter() - t) * 1e3
        want = C.host_exchange_histograms(hists, mode=mode)
        out["exchange"][mode] = {
            "ms": ms,
            "wire_bytes": counter("collective_tcp_hist_exchange_bytes") - b0,
            "bit_for_bit": bool(np.array_equal(got.view(np.uint32),
                                               want.view(np.uint32)))}
    tp.barrier()
    tp.close()
    print(json.dumps(out), flush=True)
    return 0


def _dist_reference(lgb, kernels, params, X, y, rounds, dev):
    """The parent's single-process construction and run that phase 15
    (a)'s ranks must equal: (fingerprint, bins sha, model sha, launches,
    the core, the model trees)."""
    import hashlib

    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.sharded import binfind
    cfg = lgb.Config.from_params(params)
    core = lgb.Dataset(X, label=y).construct(cfg)
    fp = binfind.mapper_fingerprint(core.mappers, core._bundles,
                                    core.max_bin)
    bins_sha = hashlib.sha256(
        np.ascontiguousarray(core.group_bins).tobytes()).hexdigest()
    g = GBDT(cfg, core)
    kernels.reset_launches()
    for _ in range(rounds):
        g.train_one_iter()
    _sync(dev)
    launches = _launched(kernels)
    g.flush_models()
    text = "".join(t.to_string() for t in g.models)
    return (fp, bins_sha, hashlib.sha256(text.encode()).hexdigest(),
            launches, core, g.models)


def _two_shard_policy(cfg, devs):
    """The data learner's policy over ``devs`` (two cards, or one card
    twice: both shards on it)."""
    from lightgbm_tpu_torch.parallel import mesh as M
    return M.ShardingPolicy(cfg, M.Mesh(devs, (len(devs),), ("data",)))


def _train_texts(lgb, cfg, core, rounds, dev, policy=None):
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    g = GBDT(cfg, core, policy=policy)
    for _ in range(rounds):
        g.train_one_iter()
    _sync(dev)
    g.flush_models()
    return "".join(t.to_string() for t in g.models), g


def check_distributed(lgb, kernels, params, X, y, dev, card, rehearse):
    """Phase 15 (see the module docstring).  Returns ({kernel name:
    launches in the phase}, numbers)."""
    import os
    import socket
    import tempfile

    import torch

    from lightgbm_tpu_torch.parallel import collectives as C
    from lightgbm_tpu_torch.telemetry import TELEMETRY
    t_phase = time.perf_counter()
    n = X.shape[0]
    rounds = 10
    total = {}
    numbers = {}
    dparams = dict(params, bin_construct_sample_cnt=n, verbose=-1)
    dparams.pop("metric", None)

    # ---- (a) the tcp plane: the parent's reference, then two ranks
    t0 = time.perf_counter()
    fp, bins_sha, model_sha, ref_launches, core, models = _dist_reference(
        lgb, kernels, dparams, X, y, rounds, dev)
    ref_s = time.perf_counter() - t0
    _add_launches(total, ref_launches)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("LTPU_FAULT_PLAN", None)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            for r in range(2):
                path = os.path.join(tmp, f"rank{r}.json")
                with open(path, "w") as f:
                    json.dump({"coord": coord, "rank": r, "world": 2,
                               "n_rows": n, "rounds": rounds,
                               "params": dparams}, f)
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--dist-child", path], cwd=root, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        children_s = time.perf_counter() - t0
    ranks = []
    for p, (out, err) in zip(procs, outs):
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"phase 15 (a): a rank exited "
                                 f"{p.returncode}: {err[-3000:]}")
        ranks.append(lines[-1])
    for r in ranks:
        tag = f"phase 15 (a) rank {r['rank']}"
        if r["fingerprint"] != fp or r["bins_sha"] != bins_sha:
            raise AssertionError(f"{tag}: mappers or global bins differ "
                                 "from the single-process construction")
        if r["model_sha"] != model_sha:
            raise AssertionError(f"{tag}: the {rounds}-tree model text is "
                                 "not the single-process text")
        want = {k: ref_launches.get(k, 0)
                for k in ("fused_route_hist", "route_apply")}
        got = {k: r["launches"].get(k, 0) for k in want}
        if got != want or (not rehearse and not got["fused_route_hist"]):
            raise AssertionError(f"{tag}: launches {r['launches']}, the "
                                 f"single-process run {ref_launches}")
        for mode, e in r["exchange"].items():
            if not e["bit_for_bit"]:
                raise AssertionError(f"{tag}: the tcp {mode} exchange is "
                                     "not the host codec's")
        _add_launches(total, r["launches"])
        print(f"[phase 15] (a) rank {r['rank']}: rendezvous "
              f"{r['rendezvous_s']:.3f} s; candidate gather "
              f"{r['cand_bytes']} B in {r['cand_ms']:.1f} ms; bin allgather "
              f"{r['bins_bytes']} B in {r['bins_ms']:.1f} ms; construct "
              f"{r['construct_s']:.2f} s; {r['ms_tree']:.2f} ms/tree "
              f"({rounds} trees, launches {r['launches']}); straggler "
              f"ratio {r['straggler_ratio']} (peak "
              f"{r['straggler_ratio_peak']}) ({card})")
        for mode, e in r["exchange"].items():
            print(f"[phase 15] (a) rank {r['rank']}: exchange_histograms "
                  f"{EXCHANGE_SHAPE} {mode}: {e['ms']:.2f} ms, "
                  f"{e['wire_bytes']} wire bytes ({card})")
    print(f"[phase 15] (a) both ranks: mapper fingerprint {fp[:16]}, bins "
          f"{bins_sha[:16]} and the {rounds}-tree text {model_sha[:16]} "
          f"equal the single-process run's ({ref_s:.1f} s; the two ranks "
          f"{children_s:.1f} s)")
    numbers["tcp"] = {"ranks": ranks, "reference_s": ref_s,
                      "children_s": children_s}
    # what phase 16 holds its sharded construction against
    ref = {"core": core, "dparams": dparams, "fingerprint": fp,
           "bins_sha": bins_sha, "model_sha": model_sha,
           "launches": ref_launches}

    # ---- (b) the codec on CUDA tensors: the first round's xla
    # histograms of the two row halves
    cfg = lgb.Config.from_params(dparams)
    from lightgbm_tpu_torch.learner.grower import TreeGrower
    from lightgbm_tpu_torch.ops.histogram import compute_group_histograms
    g2 = TreeGrower(core, cfg, dev,
                    policy=_two_shard_policy(cfg, [dev, dev]))
    yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
    p = float(y.mean())
    halves = []
    for (lo, hi), b, v in zip(g2.policy.row_ranges, g2.shard_bins,
                              g2.shard_valid):
        grad = torch.zeros(hi - lo, device=dev)
        real = min(hi, n) - lo
        grad[:real] = p - yd[lo:lo + real]
        hess = torch.where(v, p * (1 - p), 0.0).to(torch.float32)
        halves.append(compute_group_histograms(
            b, grad, hess, v.to(torch.float32),
            torch.where(v, 0, -1).to(torch.int32), num_leaves=1,
            max_group_bin=core.max_group_bin, chunk=g2.shard_chunk))
    level = TELEMETRY.level
    wire = {}
    try:
        for mode in C.HIST_EXCHANGE_MODES:
            TELEMETRY.configure("counters")
            TELEMETRY.reset()
            t0 = time.perf_counter()
            got = C.exchange_histograms(halves, mode=mode)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            wire[mode] = TELEMETRY.counters()[
                "collective_hist_exchange_bytes"]
            cpu = C.exchange_histograms([h.cpu() for h in halves],
                                        mode=mode)
            host = C.host_exchange_histograms(
                [h.cpu().numpy() for h in halves], mode=mode)
            bits = got.cpu().numpy().view(np.uint32)
            if not np.array_equal(bits, cpu.numpy().view(np.uint32)):
                raise AssertionError(f"phase 15 (b) {mode}: the card's "
                                     "exchange is not the CPU's bit for bit")
            # the mesh codec reconstructs q16/q8 in the JAX mesh's
            # arithmetic, the host codec in numpy's: f32 agrees
            same_host = np.array_equal(bits, host.view(np.uint32))
            if mode == "f32" and not same_host:
                raise AssertionError("phase 15 (b) f32: the card's exchange "
                                     "is not the host codec's sum")
            host_err = float(np.abs(got.cpu().numpy() - host).max())
            print(f"[phase 15] (b) exchange_histograms {mode} of two "
                  f"{tuple(halves[0].shape)} halves on {dev.type}: "
                  f"{ms:.2f} ms, {wire[mode]} wire bytes, bit for bit the "
                  f"CPU call; the host codec's bits: {same_host} (max "
                  f"|d| {host_err:.3g}) ({card})")
    finally:
        TELEMETRY.configure(level)
        TELEMETRY.reset()
    if wire["q16"] * 2 != wire["f32"] or wire["q8"] * 4 != wire["f32"]:
        raise AssertionError(f"phase 15 (b): wire bytes {wire}")
    numbers["codec_wire_bytes"] = wire
    del g2, halves

    # ---- (c) the mesh on this machine
    serial3 = "".join(t.to_string() for t in models[:3])
    mesh_cfg = lgb.Config.from_params(dict(dparams, tree_learner="data",
                                           mesh_shape=(2,), verbose=0))
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    err = __import__("io").StringIO()
    with contextlib.redirect_stderr(err):
        text, g = _train_texts(lgb, mesh_cfg, core, 3, dev)
    if dev.type == "cuda" and cards < 2:
        if g.grower.policy.mesh is not None or "falling back to serial" \
                not in err.getvalue() or text != serial3:
            raise AssertionError("phase 15 (c): mesh_shape=(2,) on one card "
                                 "did not warn and train the serial text")
        print("[phase 15] (c) tree_learner=data, mesh_shape=(2,) on one "
              "card: warned and trained the serial 3-tree text")
    devs = ([torch.device("cuda", 0), torch.device("cuda", 1)]
            if cards >= 2 else [dev, dev])
    l1 = dict(dparams, objective="regression_l1", hist_kernel="xla")
    lcfg = lgb.Config.from_params(l1)
    serial_l1, _ = _train_texts(lgb, lcfg, core, 3, dev)
    t0 = time.perf_counter()
    text, g = _train_texts(lgb, lcfg, core, 3, dev,
                           policy=_two_shard_policy(lcfg, devs))
    mesh_s = time.perf_counter() - t0
    if not g.grower.sharded or text != serial_l1:
        raise AssertionError("phase 15 (c): the 2-shard regression_l1 text "
                             "(f32) differs from the serial text")
    ref["serial_l1"] = serial_l1
    rng = np.random.RandomState(7)
    Xs = rng.uniform(0, 1, (512, 4))
    ys = 2.0 * (Xs[:, 0] > 0.5) + (Xs[:, 1] > 0.25) + 0.01 * Xs[:, 2]
    small = dict(l1, num_leaves=5, min_data_in_leaf=5, max_bin=16,
                 min_sum_hessian_in_leaf=1e-3)
    scfg = lgb.Config.from_params(small)
    score = lgb.Dataset(Xs, label=ys).construct(scfg)
    want, _ = _train_texts(lgb, scfg, score, 3, dev)
    for mode in C.HIST_EXCHANGE_MODES:
        mcfg = lgb.Config.from_params(dict(small, hist_exchange=mode))
        got, _ = _train_texts(lgb, mcfg, score, 3, dev,
                              policy=_two_shard_policy(mcfg, devs))
        if got != want:
            raise AssertionError(f"phase 15 (c): the 2-shard {mode} text of "
                                 "the 512-row set differs from the serial")
    where = "two cards" if cards >= 2 else "one card, both shards on it"
    print(f"[phase 15] (c) data learner, 2 shards ({where}): regression_l1 "
          f"on the xla plan, {n} rows, 3 trees in {mesh_s:.1f} s, the serial "
          "text under f32; 512 rows: the serial text under f32, q16, q8")
    wall = time.perf_counter() - t_phase
    print(f"[phase 15] wall {wall:.1f} s ({card})")
    print(f"[phase 15] launches {total}")
    numbers["wall_s"] = wall
    return total, numbers, ref


# ---------------------------------------------------------------------------
# phase 16: the feature and voting learners, sharded construction with
# the shard cache, and the elastic rejoin from a shard cache
# ---------------------------------------------------------------------------
#: phase 16 (a)/(b)'s regression_l1 leaves: below 127, so the serial
#: rounds' frontier width (min(L - 1, 126)) never binds and the serial
#: and the full-frontier learners split the same leaves each round
PHASE16_L1_LEAVES = 63
#: phase 16 (b)'s slice for the card-against-CPU voting run
VOTE_SLICE_ROWS = 20_000
#: phase 16 (d): three equal rank shards of the first rows, and trees
REJOIN_ROWS = 99_999
REJOIN_ITERS = 8


def _mesh_policy(cfg, devs, axis):
    """A one-axis ShardingPolicy over ``devs`` (several cards, or one
    card several times: every shard on it)."""
    from lightgbm_tpu_torch.parallel import mesh as M
    return M.ShardingPolicy(cfg, M.Mesh(devs, (len(devs),), (axis,)))


def _shard_devices(dev, k):
    import torch
    if dev.type == "cuda" and torch.cuda.device_count() >= k:
        return [torch.device("cuda", i) for i in range(k)]
    return [dev] * k


def _timed_texts(lgb, cfg, core, rounds, dev, policy=None):
    """(model text, GBDT, ms a tree) of ``rounds`` trees."""
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    g = GBDT(cfg, core, policy=policy)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(rounds):
        g.train_one_iter()
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / rounds
    g.flush_models()
    return "".join(t.to_string() for t in g.models), g, ms


def _raw_scores(g, X):
    return np.sum([t.predict(X) for t in g.models], axis=0)


def rejoin_child(argv) -> int:
    """``--rejoin-child SPEC``: one process of phase 16 (d).  Role
    ``rank``: rendezvous on the tcp plane with
    transport_epoch_iters=1 and sharded_allow_degraded, construct its
    third of the rows (construct_sharded, finalize_global), rank 0
    publishing the shard cache's directory as handoff_meta, rank 2
    killed at its third epoch boundary; role ``joiner``: wait for the
    trigger file, TcpTransport.join, load the shard cache and
    restore_state.  Both train to ``iters`` trees, a 0.4 s admission
    window after each, and print one JSON line."""
    import hashlib
    import os
    import pickle

    with open(argv[0]) as f:
        spec = json.load(f)
    import torch

    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.parallel import distributed as D
    from lightgbm_tpu_torch.parallel import transport as T
    from lightgbm_tpu_torch.reliability.faults import FAULTS
    from lightgbm_tpu_torch.sharded import load_shard_cache

    dev = torch.device(spec["params"]["device"])
    if dev.type == "cuda":
        torch.zeros(1, device=dev)          # the CUDA context first
    cfg = Config.from_params(dict(spec["params"], collective_transport="tcp",
                                  transport_epoch_iters=1,
                                  sharded_allow_degraded=True))
    iters = spec["iters"]
    if spec["role"] == "joiner":
        deadline = time.time() + 300
        while not os.path.exists(spec["trigger"]):
            if time.time() > deadline:
                raise SystemExit("the trigger file never appeared")
            time.sleep(0.05)
        tp = T.TcpTransport.join(spec["coord"], config=cfg)
        T.install(tp)
        t0 = time.perf_counter()
        ds = load_shard_cache(tp.handoff["meta"]["manifest_dir"],
                              config=cfg)
        load_s = time.perf_counter() - t0
        g = GBDT(cfg, ds)
        g.restore_state(pickle.loads(tp.handoff["state"]))
        rank = tp.rank
    else:
        rank, world, n = spec["rank"], spec["world"], spec["n_rows"]
        X, y, _ = make_data(spec["n_all"], 28, seed=7)
        per = n // world
        sl = slice(rank * per, (rank + 1) * per)
        D.initialize(coordinator_address=spec["coord"],
                     num_processes=world, process_id=rank, config=cfg)
        tp = T.active()
        if rank == 0:
            tp.handoff_meta = {"manifest_dir": spec["cache_dir"]}
        ds = D.finalize_global(D.construct_sharded(X[sl], label=y[sl],
                                                   config=cfg))
        g = GBDT(cfg, ds)
        load_s = None
        if rank == 2:
            # configure restarts the per-seam counters: the third
            # training epoch boundary, not a construction round
            FAULTS.configure("transport.round:3:kill")
    joined_at = g.iter_
    kernels.reset_launches()
    t0 = time.perf_counter()
    while g.iter_ < iters:
        g.train_one_iter()
        time.sleep(0.4)
    _sync(dev)
    wall = time.perf_counter() - t0
    g.flush_models()
    text = "".join(t.to_string() for t in g.models)
    print(json.dumps({"rank": rank, "world": tp.world_size,
                      "joined_at": joined_at, "load_s": load_s,
                      "train_s": wall, "launches": _launched(kernels),
                      "model_sha": hashlib.sha256(text.encode()
                                                  ).hexdigest()}),
          flush=True)
    tp.close()
    return 0


def check_rejoin(lgb, kernels, dparams, X, y, dev, card, rehearse, tmp):
    """Phase 16 (d).  Returns ({kernel: launches}, numbers)."""
    import hashlib
    import os
    import socket

    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.sharded import ShardedDataset, save_shard_cache
    t_d = time.perf_counter()
    n = min(REJOIN_ROWS, X.shape[0] - X.shape[0] % 3)
    rparams = dict(dparams, bin_construct_sample_cnt=n)
    rcfg = lgb.Config.from_params(rparams)
    g = GBDT(rcfg, lgb.Dataset(X[:n], label=y[:n]).construct(rcfg))
    kernels.reset_launches()
    for _ in range(REJOIN_ITERS):
        g.train_one_iter()
    _sync(dev)
    ref_launches = _launched(kernels)
    g.flush_models()
    want = hashlib.sha256("".join(t.to_string() for t in g.models
                                  ).encode()).hexdigest()
    cache_dir = os.path.join(tmp, "rejoin_cache")
    save_shard_cache(ShardedDataset.construct_sharded(
        X[:n], label=y[:n], config=rcfg, num_shards=3), cache_dir)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("LTPU_FAULT_PLAN", None)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    trigger = os.path.join(tmp, "rank2-dead")
    common = {"coord": coord, "iters": REJOIN_ITERS, "params": rparams,
              "trigger": trigger}
    specs = [dict(common, role="rank", rank=r, world=3, n_rows=n,
                  n_all=X.shape[0], cache_dir=cache_dir) for r in range(3)]
    specs.append(dict(common, role="joiner"))
    procs = []
    t0 = time.perf_counter()
    try:
        for i, spec in enumerate(specs):
            path = os.path.join(tmp, f"rejoin{i}.json")
            with open(path, "w") as f:
                json.dump(spec, f)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--rejoin-child", path], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        rc2 = procs[2].wait(timeout=300)
        if rc2 != -9:
            raise AssertionError(f"phase 16 (d): rank 2 exited {rc2}, not "
                                 "by the injected kill: "
                                 f"{procs[2].communicate()[1][-3000:]}")
        with open(trigger, "w") as f:
            f.write("go")
        outs = [p.communicate(timeout=300) for p in (procs[0], procs[1],
                                                     procs[3])]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    children_s = time.perf_counter() - t0
    lines = []
    for p, (out, err) in zip((procs[0], procs[1], procs[3]), outs):
        got = [json.loads(ln) for ln in out.splitlines()
               if ln.startswith("{")]
        if p.returncode != 0 or not got:
            raise AssertionError(f"phase 16 (d): a finisher exited "
                                 f"{p.returncode}: {err[-3000:]}")
        lines.append(got[-1])
    total = {}
    if sorted(r["rank"] for r in lines) != [0, 1, 3]:
        raise AssertionError(f"phase 16 (d): the finishers' ranks {lines}")
    for r in lines:
        tag = f"phase 16 (d) rank {r['rank']}"
        if r["model_sha"] != want or r["world"] != 3:
            raise AssertionError(f"{tag}: world {r['world']}; its "
                                 f"{REJOIN_ITERS}-tree text equals the "
                                 "single-process text: "
                                 f"{r['model_sha'] == want}")
        for k in ("fused_route_hist", "route_apply"):
            if not rehearse and not r["launches"].get(k):
                raise AssertionError(f"{tag}: launched no {k}: "
                                     f"{r['launches']}")
        _add_launches(total, r["launches"])
    joiner = next(r for r in lines if r["rank"] == 3)
    if joiner["joined_at"] < 3:
        raise AssertionError(f"phase 16 (d): the joiner joined at "
                             f"iteration {joiner['joined_at']}")
    wall = time.perf_counter() - t_d
    print(f"[phase 16] (d) elastic rejoin, {n} rows on three ranks on "
          f"{dev.type}: rank 2 killed at its third epoch boundary, a "
          f"joiner took rank 3 at iteration {joiner['joined_at']} from the "
          f"shard cache (load {joiner['load_s']:.3f} s) and the captured "
          f"state; ranks 0, 1, 3 finished the single-process "
          f"{REJOIN_ITERS}-tree text on a world of 3; launches "
          + "; ".join(f"rank {r['rank']} {r['launches']}" for r in lines)
          + f" (single process {ref_launches}); processes {children_s:.1f} "
          f"s, (d) {wall:.1f} s ({card})")
    return total, {"rows": n, "children_s": children_s, "wall_s": wall,
                   "ranks": lines}


def check_sharded_learners(lgb, kernels, params, X, y, Xv, yv, dev, card,
                           rehearse, ref):
    """Phase 16 (see the module docstring).  Returns ({kernel name:
    launches in the phase}, numbers)."""
    import hashlib
    import os
    import shutil
    import tempfile

    import torch

    from lightgbm_tpu_torch.sharded import (ShardedDataset,
                                            mapper_fingerprint,
                                            save_shard_cache)
    from lightgbm_tpu_torch.telemetry import TELEMETRY
    t_phase = time.perf_counter()
    n = X.shape[0]
    core, dparams = ref["core"], ref["dparams"]
    total, numbers = {}, {}

    # ---- (a) the feature learner
    l1 = dict(dparams, objective="regression_l1", hist_kernel="xla",
              num_leaves=PHASE16_L1_LEAVES)
    lcfg = lgb.Config.from_params(l1)
    serial_l1, _, serial_ms = _timed_texts(lgb, lcfg, core, 3, dev)
    fcfg = lgb.Config.from_params(dict(l1, tree_learner="feature"))
    for k in (2, 4):
        text, g, ms = _timed_texts(
            lgb, fcfg, core, 3, dev,
            policy=_mesh_policy(fcfg, _shard_devices(dev, k), "feature"))
        if not g.grower.is_feature_par or text != serial_l1:
            raise AssertionError(f"phase 16 (a): the {k}-shard feature "
                                 "learner's regression_l1 text differs "
                                 "from the serial text")
        numbers[f"feature_l1_{k}_ms_tree"] = ms
        print(f"[phase 16] (a) feature learner, {k} shards x "
              f"{core.num_groups // k} groups: regression_l1, "
              f"{PHASE16_L1_LEAVES} leaves, 3 trees byte for byte the "
              f"serial xla text; {ms:.1f} ms/tree (serial xla "
              f"{serial_ms:.1f}) ({card})")
    xcfg = lgb.Config.from_params(dict(dparams, hist_kernel="xla"))
    _, gx, xla_ms = _timed_texts(lgb, xcfg, core, 3, dev)
    xla_auc = auc_score(yv, _raw_scores(gx, Xv))
    del gx
    bcfg = lgb.Config.from_params(dict(dparams, tree_learner="feature"))
    _, g, ms = _timed_texts(lgb, bcfg, core, 3, dev, policy=_mesh_policy(
        bcfg, _shard_devices(dev, 2), "feature"))
    auc = auc_score(yv, _raw_scores(g, Xv))
    del g
    if auc <= 0.75:
        raise AssertionError(f"phase 16 (a): the feature learner's held-out "
                             f"AUC {auc:.4f} is not above 0.75")
    numbers.update(feature_binary_ms_tree=ms, feature_binary_auc=auc,
                   serial_xla_ms_tree=xla_ms, serial_xla_auc=xla_auc)
    print(f"[phase 16] (a) feature learner, 2 shards, binary at the bench "
          f"params (255 leaves): 3 trees {ms:.1f} ms/tree, held-out AUC "
          f"{auc:.4f}; the serial xla plan {xla_ms:.1f} ms/tree, AUC "
          f"{xla_auc:.4f} ({card})")

    # ---- (b) the voting learner
    devs2 = _shard_devices(dev, 2)
    vcfg = lgb.Config.from_params(dict(l1, tree_learner="voting", top_k=14))
    dcfg = lgb.Config.from_params(dict(l1, tree_learner="data"))
    text_v, gv, vms = _timed_texts(lgb, vcfg, core, 3, dev,
                                   policy=_mesh_policy(vcfg, devs2, "data"))
    text_d, gd, dms = _timed_texts(lgb, dcfg, core, 3, dev,
                                   policy=_mesh_policy(dcfg, devs2, "data"))
    del gv, gd
    if text_v != text_d:
        raise AssertionError("phase 16 (b): voting with top_k=14 is not the "
                             "data learner's regression_l1 text")
    print(f"[phase 16] (b) voting, top_k=14 (every feature selected), 2 "
          f"shards: regression_l1 3 trees byte for byte the data learner's "
          f"text ({vms:.1f} against {dms:.1f} ms/tree) ({card})")
    level = TELEMETRY.level
    wire = {}
    try:
        for name, extra in (("voting", {"tree_learner": "voting",
                                        "top_k": 5}),
                            ("data", {"tree_learner": "data"})):
            cfg = lgb.Config.from_params(dict(dparams, **extra))
            TELEMETRY.configure("counters")
            TELEMETRY.reset()
            _, g, ms = _timed_texts(lgb, cfg, core, 3, dev,
                                    policy=_mesh_policy(cfg, devs2, "data"))
            c = TELEMETRY.counters()
            TELEMETRY.configure(level)
            ll = logloss(yv, 1 / (1 + np.exp(-(_raw_scores(g, Xv)
                                               + g.init_score))))
            gr = g.grower
            wire[name] = {
                "ms_tree": ms, "logloss": ll,
                "hist_bytes": c.get("collective_hist_exchange_bytes", 0),
                "hist_calls": c.get("collective_hist_exchange_calls", 0),
                "vote_bytes": c.get("collective_allreduce_bytes", 0),
                "L": gr.num_leaves, "B": gr.max_feature_bin,
                "G": gr.num_groups, "F": gr.num_features}
            del g
    finally:
        TELEMETRY.configure(level)
        TELEMETRY.reset()
    v = wire["voting"]
    rounds_v = v["hist_calls"] // 2
    per_round = (v["hist_bytes"] + v["vote_bytes"]) / max(1, rounds_v)
    want = 2 * (v["L"] * 10 * v["B"] * 3 * 4 + v["L"] * v["F"] * 4)
    if v["hist_bytes"] != rounds_v * 2 * v["L"] * 10 * v["B"] * 12 \
            or per_round != want:
        raise AssertionError(f"phase 16 (b): voting's wire bytes {v}")
    d_ = wire["data"]
    full = 2 * d_["L"] * d_["G"] * d_["B"] * 12
    print(f"[phase 16] (b) voting, top_k=5, 2 shards, binary at the bench "
          f"params: {per_round:.0f} wire bytes a round (two shards' "
          f"({v['L']}, 10, {v['B']}, 3) f32 histograms and ({v['L']}, "
          f"{v['F']}) votes, {rounds_v} rounds in 3 trees); the data "
          f"learner {d_['hist_bytes'] / max(1, d_['hist_calls'] // 2):.0f} "
          f"a pass ({d_['hist_calls'] // 2} passes; an ({d_['L']}, "
          f"{d_['G']}, {d_['B']}, 3) pass of two shards is {full}); "
          f"{v['ms_tree']:.1f} against {d_['ms_tree']:.1f} ms/tree, "
          f"held-out logloss {v['logloss']:.5f} against "
          f"{d_['logloss']:.5f} ({card})")
    numbers["voting"] = wire
    m = min(VOTE_SLICE_ROWS, n)
    scfg = lgb.Config.from_params(dict(l1, tree_learner="voting", top_k=5,
                                       bin_construct_sample_cnt=m))
    score = lgb.Dataset(X[:m], label=y[:m]).construct(scfg)
    ccfg = lgb.Config.from_params(dict(l1, tree_learner="voting", top_k=5,
                                       bin_construct_sample_cnt=m,
                                       device="cpu"))
    _, gc, _ = _timed_texts(lgb, scfg, score, 3, dev, policy=_mesh_policy(
        scfg, devs2, "data"))
    _, gh, _ = _timed_texts(lgb, ccfg, score, 3, torch.device("cpu"),
                            policy=_mesh_policy(ccfg, [torch.device("cpu")]
                                                * 2, "data"))
    worst = 0.0
    for i, (tc, th) in enumerate(zip(gc.models, gh.models)):
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "decision_type"):
            if not np.array_equal(getattr(tc, f), getattr(th, f)):
                raise AssertionError(f"phase 16 (b): tree {i}'s {f} differs "
                                     "between the card and the CPU")
        worst = max(worst, float(np.max(np.abs(tc.leaf_value - th.leaf_value)
                                        / np.maximum(np.abs(th.leaf_value),
                                                     1e-30))))
    if worst > 1e-6:
        raise AssertionError(f"phase 16 (b): leaves {worst:.3g} apart")
    print(f"[phase 16] (b) voting, top_k=5, 2 shards, regression_l1 on "
          f"{m} rows: 3 trees on {dev.type} split for split the CPU run, "
          f"leaves within {worst:.3g} relative ({card})")
    del gc, gh, score

    # ---- (c) sharded construction on the main path
    tmp = tempfile.mkdtemp(prefix="phase16_")
    try:
        cache_dir = os.path.join(tmp, "cache")
        sparams = dict(dparams, sharded_shards=4, sharded_cache_dir=cache_dir)
        scfg = lgb.Config.from_params(sparams)
        t0 = time.perf_counter()
        sds = ShardedDataset.construct_sharded(X, label=y, config=scfg)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_shard_cache(sds, cache_dir)
        save_s = time.perf_counter() - t0
        cache_bytes = sum(os.path.getsize(os.path.join(cache_dir, f))
                          for f in os.listdir(cache_dir))
        fp = mapper_fingerprint(sds.mappers, sds._bundles, sds.max_bin)
        bins_sha = hashlib.sha256(np.ascontiguousarray(
            sds.assembled_group_bins()).tobytes()).hexdigest()
        if fp != ref["fingerprint"] or bins_sha != ref["bins_sha"]:
            raise AssertionError("phase 16 (c): the sharded construction's "
                                 "mappers or bins differ from the single "
                                 "matrix's")
        main_cfg = lgb.Config.from_params(dparams)
        kernels.reset_launches()
        text, g, ms = _timed_texts(lgb, main_cfg, sds, 10, dev)
        launches = _launched(kernels)
        if g.grower.plan.name != "fused_tiled" or g.grower.sharded:
            raise AssertionError(f"phase 16 (c): plan {g.grower.plan.name}")
        del g
        sha = hashlib.sha256(text.encode()).hexdigest()
        ab = {k: launches.get(k, 0) for k in ("fused_route_hist",
                                               "route_apply")}
        if sha != ref["model_sha"] or ab != {
                k: ref["launches"].get(k, 0) for k in ab} or (
                not rehearse and not ab["fused_route_hist"]):
            raise AssertionError(f"phase 16 (c): the 10 main-path trees on "
                                 f"the shards (launches {launches}) are not "
                                 "the single-matrix text "
                                 f"(launches {ref['launches']})")
        _add_launches(total, launches)
        t0 = time.perf_counter()
        re = lgb.Dataset(X, label=y, params=sparams).construct()
        load_s = time.perf_counter() - t0
        if not isinstance(re.shard_bins[0], np.memmap):
            raise AssertionError("phase 16 (c): the reload is not memmapped")
        kernels.reset_launches()
        text2, _, ms2 = _timed_texts(lgb, main_cfg, re, 10, dev)
        _add_launches(total, _launched(kernels))
        if text2 != text:
            raise AssertionError("phase 16 (c): the reloaded shards train "
                                 "another text")
        print(f"[phase 16] (c) sharded_shards=4 on {n} rows: constructed in "
              f"{build_s:.2f} s (fingerprint and bins the single matrix's), "
              f"cache saved in {save_s:.2f} s ({cache_bytes} bytes), "
              f"reloaded in {load_s:.3f} s (memmapped); 10 fused_tiled trees "
              f"on the shards concatenated on {dev.type}, byte for byte the "
              f"single-matrix text, launches {ab} as it launches them; "
              f"{ms:.1f} ms/tree, from the reload {ms2:.1f} ({card})")
        lcfg255 = lgb.Config.from_params(dict(dparams, objective=
                                              "regression_l1",
                                              hist_kernel="xla",
                                              tree_learner="data"))
        pol = _mesh_policy(lcfg255, devs2, "data")
        text, g, ms = _timed_texts(lgb, lcfg255, re, 3, dev, policy=pol)
        if not g.grower.sharded or text != ref["serial_l1"]:
            raise AssertionError("phase 16 (c): the data learner over the "
                                 "placed shards differs from the serial l1 "
                                 "text")
        del g, re, sds
        print(f"[phase 16] (c) the data learner over the reloaded shards, "
              f"each device's rows placed from them: regression_l1 3 trees "
              f"byte for byte the serial text ({ms:.1f} ms/tree) ({card})")
        numbers["shard_cache"] = {"build_s": build_s, "save_s": save_s,
                                  "load_s": load_s, "bytes": cache_bytes,
                                  "ms_tree": ms, "reload_ms_tree": ms2}

        # ---- (d) the elastic rejoin from a shard cache
        d_launches, numbers["rejoin"] = check_rejoin(
            lgb, kernels, dparams, X, y, dev, card, rehearse, tmp)
        _add_launches(total, d_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    numbers["wall_s"] = wall
    print(f"[phase 16] wall {wall:.1f} s ({card})")
    print(f"[phase 16] launches {total}")
    return total, numbers


# ---------------------------------------------------------------------------
# phase 17: the row-sharded multi-process plane (collective_transport=xla)
# ---------------------------------------------------------------------------
#: phase 17's trees a run
PLANE_TREES = 10


def plane_rows(n, num_groups, max_group_bin, world):
    """(rows, chunk): the first of ``n`` rows that fill a whole number of
    xla chunks on each of ``world`` ranks (the grower's chunk of the
    global count, ops/histogram.py _pick_chunk, bf16 weights), so no
    rank pads and the ranks' layout is the single-process mesh's."""
    from lightgbm_tpu_torch.ops.histogram import _pick_chunk
    chunk = _pick_chunk(n, num_groups, max_group_bin, 2, min_chunk=1024)
    rows = n // (world * chunk) * world * chunk
    if not rows or _pick_chunk(rows, num_groups, max_group_bin, 2,
                               min_chunk=1024) != chunk:
        raise AssertionError(f"phase 17: {n} rows hold no whole chunks of "
                             f"{chunk} on {world} ranks")
    return rows, chunk


def _plane_params(params, rows, device):
    return dict(params, device=device, tree_learner="data",
                collective_transport="xla", bin_construct_sample_cnt=rows,
                verbose=-1)


def plane_child(argv) -> int:
    """``--plane-child SPEC``: one rank of phase 17.  SPEC is a JSON file:
    the coordinator address, the world, this rank, the backend, the
    rows of make_data(n_make) to train on, the params and the trees.
    Joins the plane, constructs its rows (construct_sharded,
    finalize_global), trains the data learner through
    GBDT.train_one_iter and runs one exchange_histograms_ranks a codec;
    prints one JSON line."""
    import hashlib

    with open(argv[0]) as f:
        spec = json.load(f)
    import torch
    import torch.distributed as dist

    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.parallel import collectives as C
    from lightgbm_tpu_torch.parallel import distributed as D
    from lightgbm_tpu_torch.telemetry import TELEMETRY

    rank, world, rows = spec["rank"], spec["world"], spec["rows"]
    cfg = Config.from_params(spec["params"])
    TELEMETRY.configure("counters", fence=True)
    X, y, _ = make_data(spec["n_make"], 28, seed=7)
    per = rows // world
    Xl, yl = X[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    del X, y
    t0 = time.perf_counter()
    D.initialize(spec["coord"], world, rank, config=cfg,
                 backend=spec["backend"])
    pl = D.plane()
    dev = pl.device
    out = {"rank": rank, "rendezvous_s": time.perf_counter() - t0,
           "backend": pl.backend, "device": str(dev)}
    t0 = time.perf_counter()
    ds = D.finalize_global(D.construct_sharded(Xl, label=yl, config=cfg))
    out["construct_s"] = time.perf_counter() - t0
    g = GBDT(cfg, ds)
    out["resident"] = g.grower.resident_bin_bytes()
    out["shard_rows"] = int(g.grower.shard_bins[0].shape[0])
    out["plan"] = g.grower.plan.name
    TELEMETRY.reset()
    kernels.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(spec["trees"]):
        g.train_one_iter()
    _sync(dev)
    out["ms_tree"] = (time.perf_counter() - t0) * 1e3 / spec["trees"]
    out["launches"] = _launched(kernels)
    c = TELEMETRY.counters()
    out["wire_bytes_tree"] = c.get("collective_hist_exchange_bytes",
                                   0) / spec["trees"]
    out["straggler_ratio"] = TELEMETRY.gauges().get("straggler_ratio")
    g.flush_models()
    text = "".join(t.to_string() for t in g.models)
    out["model_sha"] = hashlib.sha256(text.encode()).hexdigest()
    # (b) one exchange a codec: every rank's histogram from its seed, so
    # each rank holds the cross-rank result against the in-process codec
    # over all of them on its card
    hists = [torch.from_numpy((np.random.RandomState(100 + r).randn(
        *EXCHANGE_SHAPE) * 40).astype(np.float32)).to(dev)
        for r in range(world)]
    coll = C.ProcessGroupCollectives(pl)
    out["exchange"] = {}
    for mode in C.HIST_EXCHANGE_MODES:
        want = C.exchange_histograms(hists, mode=mode)
        TELEMETRY.reset()
        dist.barrier()
        _sync(dev)
        t = time.perf_counter()
        got = C.exchange_histograms_ranks(hists[rank], mode, coll)
        _sync(dev)
        ms = (time.perf_counter() - t) * 1e3
        c = TELEMETRY.counters()
        out["exchange"][mode] = {
            "ms": ms, "wire_bytes": c["collective_hist_exchange_bytes"],
            "scale_bytes": c.get("collective_hist_exchange_scale_bytes", 0),
            "bit_for_bit": bool(torch.equal(
                got.view(torch.int32), want.view(torch.int32)))}
    TELEMETRY.configure("off")
    D.shutdown()
    print(json.dumps(out), flush=True)
    return 0


def run_plane_children(world, backend, rows, n_make, params, trees, env_extra,
                       tmp, timeout=600):
    """Start ``world`` ``--plane-child`` ranks and return their JSON
    lines (rank order); fails naming the rank that exited nonzero.  Every
    child still running at the end is killed."""
    import os
    import socket
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root, **env_extra)
    env.pop("LTPU_FAULT_PLAN", None)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    procs = []
    try:
        for r in range(world):
            path = os.path.join(tmp, f"plane{world}_{backend}_{r}.json")
            with open(path, "w") as f:
                json.dump({"coord": coord, "rank": r, "world": world,
                           "backend": backend, "rows": rows,
                           "n_make": n_make, "params": params,
                           "trees": trees}, f)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--plane-child",
                 path], cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"phase 17: {backend} rank {r} of {world} "
                                 f"exited {p.returncode}: {err[-3000:]}")
        ranks.append(lines[-1])
    return ranks


def _plane_reference(lgb, params, X, y, rows, world, dev, trees):
    """The single-process ``world``-shard mesh on the same rows, every
    shard on ``dev``: (text sha, resident bin bytes, ms/tree, the serial
    matrix's bytes)."""
    import hashlib
    cfg = lgb.Config.from_params(params)
    core = lgb.Dataset(X[:rows], label=y[:rows]).construct(cfg)
    text, g, ms = _timed_texts(lgb, cfg, core, trees, dev,
                               policy=_mesh_policy(cfg, [dev] * world,
                                                   "data"))
    if not g.grower.sharded or g.grower.n_padded != rows:
        raise AssertionError(f"phase 17: the {world}-shard reference pads "
                             f"{rows} rows to {g.grower.n_padded}")
    return (hashlib.sha256(text.encode()).hexdigest(),
            g.grower.resident_bin_bytes(), ms,
            int(core.group_bins.nbytes))


def check_plane(lgb, kernels, params, X, y, core, dev, card, rehearse,
                worlds=(2,)):
    """Phase 17 (see the module docstring).  ``worlds``: the NCCL worlds
    (c) runs where there are as many cards (chip_smoke.py: 2;
    scripts/torch_dist_check.py: 2 and 4).  Returns the numbers."""
    import os
    import tempfile

    import torch
    t_phase = time.perf_counter()
    trees = 2 if rehearse else PLANE_TREES
    numbers = {}
    if rehearse:
        # the rehearsal's rows hold no whole chunk: two chunks' worth
        from lightgbm_tpu_torch.ops.histogram import _pick_chunk
        X, y, _ = make_data(2 * _pick_chunk(
            1 << 30, core.num_groups, core.max_group_bin, 2,
            min_chunk=1024), 28, seed=7)
    rows, chunk = plane_rows(X.shape[0], core.num_groups,
                             core.max_group_bin, 2)
    pparams = _plane_params(params, rows, dev.type)
    pparams.pop("metric", None)
    t0 = time.perf_counter()
    ref_sha, ref_resident, ref_ms, serial_bytes = _plane_reference(
        lgb, pparams, X, y, rows, 2, dev, trees)
    ref_s = time.perf_counter() - t0
    print(f"[phase 17] (a) {rows} of {X.shape[0]} rows: {rows // 2} a rank, "
          f"{rows // 2 // chunk} chunks of {chunk}; the single-process "
          f"2-shard mesh on {dev.type}: {trees} trees, {ref_ms:.1f} ms/tree, "
          f"resident bins {ref_resident} B ({ref_s:.1f} s with its "
          f"construction) ({card})")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    # (a) on one card: the children see only the first visible card
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    one_card = {"CUDA_VISIBLE_DEVICES": first} if cards else {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = run_plane_children(2, "gloo", rows, X.shape[0], pparams,
                                   trees, one_card, tmp)
        children_s = time.perf_counter() - t0
        for r in ranks:
            tag = f"phase 17 (a) rank {r['rank']}"
            if r["model_sha"] != ref_sha:
                raise AssertionError(f"{tag}: the {trees}-tree text is not "
                                     "the single-process 2-shard mesh's")
            if r["resident"] * 2 != ref_resident or \
                    r["shard_rows"] * 2 != rows:
                raise AssertionError(
                    f"{tag}: resident bins {r['resident']} B on "
                    f"{r['shard_rows']} rows, the 2-shard run's "
                    f"{ref_resident} B on {rows}")
            if r["plan"] != "xla" or r["launches"]:
                raise AssertionError(f"{tag}: plan {r['plan']}, launches "
                                     f"{r['launches']}")
            print(f"[phase 17] (a) rank {r['rank']} ({r['backend']} on "
                  f"{r['device']}): rendezvous {r['rendezvous_s']:.3f} s; "
                  f"construct {r['construct_s']:.2f} s; {r['ms_tree']:.1f} "
                  f"ms/tree; histogram wire {r['wire_bytes_tree']:.0f} B a "
                  f"tree; resident bins {r['resident']} B (the serial "
                  f"matrix {serial_bytes} B); straggler ratio "
                  f"{r['straggler_ratio']} ({card})")
            for mode, e in r["exchange"].items():
                if not e["bit_for_bit"]:
                    raise AssertionError(f"{tag}: the cross-rank {mode} "
                                         "exchange is not the in-process "
                                         "codec's")
                print(f"[phase 17] (b) rank {r['rank']}: "
                      f"exchange_histograms_ranks {EXCHANGE_SHAPE} {mode} "
                      f"over {r['backend']}: {e['ms']:.2f} ms, "
                      f"{e['wire_bytes']} wire bytes + {e['scale_bytes']} "
                      f"scale bytes, bit for bit the in-process codec "
                      f"({card})")
        print(f"[phase 17] (a) both ranks: the {trees}-tree text "
              f"{ref_sha[:16]} is the single-process 2-shard mesh's; each "
              f"rank holds half its bins (the two ranks {children_s:.1f} s)")
        numbers["gloo"] = {"ranks": ranks, "rows": rows, "chunk": chunk,
                           "reference_ms_tree": ref_ms,
                           "reference_resident": ref_resident,
                           "children_s": children_s}
        # (c) NCCL, one card a rank
        for world in worlds:
            if rehearse or cards < world:
                why = ("the CPU rehearsal has no NCCL" if rehearse else
                       f"{cards} visible card(s): NCCL needs one card a "
                       f"rank, {world} ranks need {world}")
                print(f"[phase 17] (c) NCCL with {world} ranks did not run: "
                      f"{why}")
                continue
            w_rows, w_chunk = plane_rows(X.shape[0], core.num_groups,
                                         core.max_group_bin, world)
            wparams = _plane_params(params, w_rows, "cuda")
            wparams.pop("metric", None)
            want = ref_sha
            if w_rows != rows:
                want = _plane_reference(lgb, wparams, X, y, w_rows, world,
                                        dev, trees)[0]
            t0 = time.perf_counter()
            nccl = run_plane_children(world, "nccl", w_rows, X.shape[0],
                                      wparams, trees, {}, tmp)
            w_s = time.perf_counter() - t0
            for r in nccl:
                if r["model_sha"] != want:
                    raise AssertionError(
                        f"phase 17 (c) NCCL rank {r['rank']} of {world}: "
                        "the text differs from the single-process mesh's")
                print(f"[phase 17] (c) NCCL rank {r['rank']} of {world} on "
                      f"{r['device']}: {r['ms_tree']:.1f} ms/tree; "
                      f"construct {r['construct_s']:.2f} s; "
                      + "; ".join(f"{m} exchange {e['ms']:.2f} ms"
                                  for m, e in r["exchange"].items())
                      + f" ({card})")
            same = ("(a)'s" if w_rows == rows else
                    f"the single-process {world}-shard mesh's")
            print(f"[phase 17] (c) NCCL, {world} ranks on {world} cards, "
                  f"{w_rows} rows: every rank's text {want[:16]} is "
                  f"{same} ({w_s:.1f} s) ({card})")
            numbers[f"nccl{world}"] = {"ranks": nccl, "rows": w_rows,
                                       "children_s": w_s}
    wall = time.perf_counter() - t_phase
    numbers["wall_s"] = wall
    print(f"[phase 17] wall {wall:.1f} s ({card})")
    return numbers


def main(argv) -> int:
    if argv[:1] == ["--plane-child"]:
        return plane_child(argv[1:])
    if argv[:1] == ["--dist-child"]:
        return dist_child(argv[1:])
    if argv[:1] == ["--rejoin-child"]:
        return rejoin_child(argv[1:])
    if argv[:1] == ["--load-clients"]:
        return load_clients(argv[1:])
    if argv[:1] == ["--train-child"]:
        return train_child(argv[1:])
    if argv[:1] == ["--lane-child"]:
        return lane_child(argv[1:])
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

    # ---- phase 12: online serving (micro-batcher, lanes, co-batcher,
    # registry, HTTP frontend, task=serve) through kernel C
    serve_launches, serve_numbers = check_online_serving(
        lgb, kernels, P, main_text, texts, Xv, dev, card, rehearse)
    numbers["predict_level_global"].update(serve_numbers)

    # ---- phase 13: crash-safe, observable training (checkpoints,
    # snapshots, resume, retries, chaos plans, telemetry) on kernels A, B
    crash_launches, crash_numbers = check_crash_safe(
        lgb, kernels, params, core, X, y, main_text, q_launches, dev, card,
        rehearse)
    numbers["fused_route_hist"]["phase13"] = crash_numbers

    # ---- phase 14: models in production (quality profiles and drift
    # monitors, the SLO engine, the continuous lane) on kernels A, B, C
    prod_launches, prod_numbers = check_production(
        lgb, kernels, params, train_ds, core, X, y, w, Xv, main_text,
        q_launches, dev, card, rehearse)
    numbers["fused_route_hist"]["phase14"] = prod_numbers

    # ---- phase 15: data-parallel training (the tcp plane on kernels A
    # and B, the codec on the card, the mesh's data learner)
    dist_launches, dist_numbers, dist_ref = check_distributed(
        lgb, kernels, params, X, y, dev, card, rehearse)
    numbers["fused_route_hist"]["phase15"] = dist_numbers

    # ---- phase 16: the feature and voting learners, sharded
    # construction and the shard cache on kernels A and B, the elastic
    # rejoin from a shard cache
    shard_launches, shard_numbers = check_sharded_learners(
        lgb, kernels, params, X, y, Xv, yv, dev, card, rehearse, dist_ref)
    numbers["fused_route_hist"]["phase16"] = shard_numbers

    # ---- phase 17: the row-sharded multi-process plane (torch.distributed;
    # the data learner on the xla plan, no kernel)
    plane_numbers = check_plane(lgb, kernels, params, X, y, core, dev, card,
                                rehearse)
    numbers["fused_route_hist"]["phase17"] = plane_numbers
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
        if serve_launches.get(name):
            runs["phase 12"] = serve_launches[name]
        if crash_launches.get(name):
            runs["phase 13"] = crash_launches[name]
        if prod_launches.get(name):
            runs["phase 14"] = prod_launches[name]
        if dist_launches.get(name):
            runs["phase 15"] = dist_launches[name]
        if shard_launches.get(name):
            runs["phase 16"] = shard_launches[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep,
                     "launches": (launches[name] + serving_launches.get(
                         name, 0) + file_launches.get(name, 0)
                         + serve_launches.get(name, 0)
                         + crash_launches.get(name, 0)
                         + prod_launches.get(name, 0)
                         + dist_launches.get(name, 0)
                         + shard_launches.get(name, 0))
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
