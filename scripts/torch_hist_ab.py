#!/usr/bin/env python3
"""Time the histogram kernels A, G, I, J (int8 weights) and D, E, F, K
(f32 weights) and the route passes B and H of two trees on one card, in
turns.

    git archive <commit> | tar -x -C build/ab_parent   # the other tree
    python3 scripts/torch_hist_ab.py --parent build/ab_parent
                                     [--rounds | --texts | --only H,B]

Runs the other tree, this tree, this tree, the other tree, each in its
own process that imports lightgbm_tpu_torch from that tree (building its
kernels into that tree's build/kernels), and times each kernel's wrapper
at chip_smoke.py's phase-2 bench shape (1,000,000 rows, 28 groups, 63
bins; the same seeded inputs): A (fused route + int8 histogram) at
W=126 with a pending route table and on a tree's first round, G at
W=126 and on the first round, I through both entry points (pallas_q,
q_packed) at W=126 and on the first round and through pallas_q over all
255 leaves, B's call (route_apply_tiled) and its one launch alone with
a pending route table, B's call over 2,000 and 6,000 leaves, H's call
(route_only_tiled) and its one launch alone with the same table, J (seg_hist) on the leaf partition of the
leaf ids at the first round, W=126 and all 255 leaves, D (pack 4, f32)
at W=126 with a pending
route table and on the first round, E pre_packed at W=126 and on the
first round, E pre over all 255 leaves and on the first round, F and K
at W=126 and on the first round.  Prints for each the median of CUDA
events around single calls (which includes the host's time where it
outlasts the device's) and, as "(device)", the mean device time of a
call from torch.profiler, the card's name and power limit, and writes
chiprun_out/hist_ab.json.  --only PREFIXES (comma-separated) times only
the cases whose names start with one of them (with --rounds, the
kernels named).

With --rounds it times kernels A, D, I, J and H where training runs
them instead: each process trains two trees of the fused_tiled plan
(int8 gradients, kernel A), two of the fused_streamed plan (f32
gradients, kernel D), two of the q_onthefly plan (int8 gradients,
kernel I through q_packed up to 126 slots, pallas_q beyond), two of the
seg_tiled(leaf_partition) plan (kernel J on each round's partition) and
two of the q_tiled(split_route) plan (kernel H at the start of each
round; its W is the leaves that split) on chip_smoke.py's
workload (make_data 1,000,000 x 28, BENCH_PARAMS, with quantized_grad
off for D), keeps the inputs of each second tree's launches, one a
grower round, and times the kernel again on each (the median of
CUDA-event timed launches, and the profiler's device time).  Prints
each round's width W, its landed rows, the largest slot's share of them
and both trees' times, the sums per tree, and writes
chiprun_out/hist_ab_rounds.json.

With --texts each process trains ten trees of the main path (the
fused_tiled plan, BENCH_PARAMS) on the same workload and prints the
sha256 of the model text; the script exits 1 unless all four digests
are equal (the int32 histograms make the trees exact whichever kernel
built them), and writes chiprun_out/hist_ab_texts.json.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_ms(cs, fn, reps: int) -> float:
    """chip_smoke.py device_ms, refusing a measurement the profiler did
    not make (no device event in three sessions)."""
    ms = cs.device_ms(fn, reps)
    if ms is None:
        raise RuntimeError("torch.profiler recorded no device event")
    return ms


def time_tree(root: str, n: int, reps: int, only=None,
              check: bool = True) -> dict:
    """{case: median ms} of the kernels of the tree at ``root`` (with
    ``only``, the cases whose name starts with one of its prefixes;
    without ``check``, J's cases are not held against the plain
    version)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    if not os.path.abspath(H.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {H.__file__}, not the tree at {root}")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    rng = np.random.RandomState(13)
    G, B, L = 28, 63, 255
    binsT = torch.from_numpy(rng.randint(0, B, (G, n)).astype(np.uint8)).to(
        dev)
    bins = binsT.t().contiguous()
    leaf = rng.randint(0, L, n).astype(np.int32)
    leaf[rng.rand(n) < 0.01] = -1
    leaf = torch.from_numpy(leaf).to(dev)
    counts = (leaf >= 0).to(torch.float32)
    grad = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev) * counts
    hess = torch.from_numpy(rng.rand(n).astype(np.float32) * 0.25).to(
        dev) * counts
    wT = torch.stack([grad, hess, counts]).contiguous()
    w = wT.t().contiguous()
    table = cs.random_route_table(rng, L, G, B).to(dev)
    oh4 = H.precompute_bin_onehot_packed(bins, max_group_bin=B, pack=4)
    root_leaf = torch.where(leaf >= 0, 0, -1).to(torch.int32)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    s126 = torch.from_numpy(rng.permutation(2 * L)[:126].astype(
        np.int32)).to(dev)
    s126_l = torch.from_numpy(rng.permutation(L)[:126].astype(np.int32)).to(
        dev)
    all_l = torch.arange(L, dtype=torch.int32, device=dev)
    kw = dict(max_group_bin=B, pack=4, num_groups=G)
    zt = torch.zeros_like(table)
    wq, _ = H.quantize_gradients(grad, hess, counts)
    wqT = wq.t().contiguous()
    values = torch.from_numpy(rng.randn(L).astype(np.float32)).to(dev)
    b_launch = _route_apply_launch(binsT, leaf, table, values)
    h_launch = _route_only_launch(binsT, leaf, table)
    seg = _seg_cases(cs, H, binsT, wqT, leaf, root_leaf, one, s126_l,
                     all_l, L, B, check)
    # B past its shared route records (1,228 leaves) and past its shared
    # value pairs (6,144)
    b_wide = {}
    for Lw in (2000, 6000):
        lw = rng.randint(0, Lw, n).astype(np.int32)
        lw[rng.rand(n) < 0.01] = -1
        b_wide[Lw] = (torch.from_numpy(lw).to(dev),
                      cs.random_route_table(rng, Lw, G, B).to(dev),
                      torch.from_numpy(rng.randn(Lw).astype(
                          np.float32)).to(dev))
    cases = {
        "A W=126": lambda: H.fused_route_hist(binsT, wqT, leaf, table, s126,
                                              B),
        "A first round": lambda: H.fused_route_hist(binsT, wqT, root_leaf,
                                                    zt, one, B),
        "G W=126": lambda: H.tiled_hist(binsT, wqT, leaf, s126_l, B),
        "G first round": lambda: H.tiled_hist(binsT, wqT, root_leaf, one, B),
        "I pallas_q W=126": lambda: H.bins_hist_q(bins, wq, leaf, s126_l, B),
        "I q_packed W=126": lambda: H.bins_hist_q_packed(bins, wq, leaf,
                                                         s126_l, B),
        "I pallas_q first round": lambda: H.bins_hist_q(bins, wq, root_leaf,
                                                        one, B),
        "I q_packed first round": lambda: H.bins_hist_q_packed(
            bins, wq, root_leaf, one, B),
        "I pallas_q all 255": lambda: H.bins_hist_q(bins, wq, leaf, all_l,
                                                    B),
        "B call": lambda: H.route_apply_tiled(binsT, leaf, table, values),
        "B launch": b_launch,
        **{f"B call L={Lw}": (lambda a=a: H.route_apply_tiled(binsT, *a))
           for Lw, a in b_wide.items()},
        "H call": lambda: H.route_only_tiled(binsT, leaf, table),
        "H launch": h_launch,
        **seg,
        "D W=126": lambda: H.fused_onehot_hist(oh4, binsT, wT, leaf, table,
                                               s126, **kw),
        "D first round": lambda: H.fused_onehot_hist(
            oh4, binsT, wT, root_leaf, zt, one, **kw),
        "E pre_packed W=126": lambda: H.hist_pre_packed(oh4, w, leaf,
                                                        s126_l, **kw),
        "E pre_packed first round": lambda: H.hist_pre_packed(
            oh4, w, root_leaf, one, **kw),
        "E pre all 255": lambda: H.hist_pre(oh4, w, leaf, all_l, **kw),
        "E pre first round": lambda: H.hist_pre(oh4, w, root_leaf, one,
                                                **kw),
        "F W=126": lambda: H.bins_hist(bins, w, leaf, s126_l, B),
        "F first round": lambda: H.bins_hist(bins, w, root_leaf, one, B),
        "K W=126": lambda: H.bins_hist_paired(bins, w, leaf, s126_l, B),
        "K first round": lambda: H.bins_hist_paired(bins, w, root_leaf, one,
                                                    B),
    }
    if only:
        cases = {k: fn for k, fn in cases.items() if k.startswith(only)}
    out = {k: cs.time_ms(fn, dev, reps) for k, fn in cases.items()}
    out.update({f"{k} (device)": _device_ms(cs, fn, reps)
                for k, fn in cases.items()})
    return out


def _route_apply_launch(binsT, leaf, table, values):
    """Kernel B's one launch on preallocated outputs, with the arguments
    of the tree's own C entry point: the (L,) values beside the plain
    table and the card's SMs, or (an earlier tree, 10 arguments) the
    table with its six value columns built first, outside the timed
    launch."""
    import torch
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops.histogram import _num_sms
    n, (L, K) = leaf.shape[0], table.shape
    bufs = [torch.empty_like(leaf),
            torch.empty(n, dtype=torch.float32, device=leaf.device)]
    if len(kernels.KERNELS["route_apply"][2]) == 10:
        from lightgbm_tpu_torch.ops.partition import extend_table_with_values
        bufs.append(extend_table_with_values(table, values).contiguous())
        tab, sms = (bufs[2].data_ptr(),), ()
    else:
        tab = (table.data_ptr(), values.data_ptr())
        sms = (_num_sms(leaf.device.index or 0),)
        if len(kernels.KERNELS["route_apply"][2]) == 13:
            sms += (0,)             # the pack spec: byte-wide bins
    ptrs = (binsT.data_ptr(), leaf.data_ptr(), *tab, bufs[0].data_ptr(),
            bufs[1].data_ptr(), n, binsT.shape[0], L, K, *sms)

    def run():
        kernels.launch("route_apply", *ptrs)
        return bufs                 # the buffers live as long as run
    return run


def _route_only_launch(binsT, leaf, table):
    """Kernel H's one launch on a preallocated output, with the
    arguments of the tree's own C entry point (the card's SMs since H
    became B's template, then the pack spec since the sub-byte storage;
    an earlier tree takes neither)."""
    import torch
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops.histogram import _num_sms
    out = torch.empty_like(leaf)
    nargs = len(kernels.KERNELS["route_only"][2])
    sms = (((_num_sms(leaf.device.index or 0),) if nargs >= 10 else ())
           + ((0,) if nargs == 11 else ()))
    ptrs = (binsT.data_ptr(), leaf.data_ptr(), table.data_ptr(),
            out.data_ptr(), leaf.shape[0], binsT.shape[0], *table.shape,
            *sms)

    def run():
        kernels.launch("route_only", *ptrs)
        return out
    return run


def _seg_cases(cs, H, binsT, wqT, leaf, root_leaf, one, s126, all_l, L, B,
               check=True):
    """Kernel J's cases on the leaf partition of the leaf ids, built as
    chip_smoke.py's phase 2 builds it (rows padded to a multiple of the
    block with leaf -1 and zero weights): the first round, W=126 and all
    255 leaves, each held bit for bit against the plain version first
    (with ``check``)."""
    import torch
    from lightgbm_tpu_torch.ops.partition import block_slots
    pad = -leaf.shape[0] % H.SEG_BLOCK
    binsT_x = torch.nn.functional.pad(binsT, (0, pad))
    wqT_x = torch.nn.functional.pad(wqT, (0, pad))
    cases = {}
    for label, lf, slots in (("first round", root_leaf, one),
                             ("W=126", leaf, s126),
                             ("all 255", leaf, all_l)):
        lf_x = torch.nn.functional.pad(lf, (0, pad), value=-1)
        binsT_p, wT_p, blk_leaf = cs.partition(binsT_x, wqT_x, lf_x, L)
        args = (binsT_p, wT_p, block_slots(blk_leaf, slots, L),
                slots.shape[0], B)
        if check and not torch.equal(H.seg_hist(*args),
                                     H.seg_hist_plain(*args)):
            raise AssertionError(f"J {label}: kernel != plain")
        cases[f"J {label}"] = lambda args=args: H.seg_hist(*args)
    return cases


def _slot_rounds(args, at_slots, leaf):
    """(W, landed rows, the largest slot's rows) of a histogram launch
    over the slots at ``at_slots`` of its arguments."""
    slots = args[at_slots]
    hits = (leaf[None, :] == slots[:, None]) & (slots[:, None] >= 0)
    per = hits.sum(1)
    return int(slots.shape[0]), int(per.sum()), int(per.max())


def _seg_round(args):
    """(W, rows with a nonzero weight in a live block, the largest
    slot's) of a kernel J launch (binsT_p, wT_p, blk_slot, num_out, B[,
    block])."""
    import torch
    wT_p, blk_slot, W = args[1:4]
    rows = (wT_p != 0).any(0).reshape(blk_slot.shape[0], -1).sum(1)
    live = (blk_slot >= 0) & (blk_slot < W)
    per = torch.zeros(W + 1, dtype=torch.long, device=rows.device)
    per.index_add_(0, torch.where(live, blk_slot, W).long(), rows)
    return W, int(per[:W].sum()), int(per[:W].max())


def _route_round(args):
    """(leaves that split, rows of those leaves, the largest leaf's) of
    a kernel H launch (binsT, leaf_id, route_tab)."""
    import torch
    _, leaf, table = args
    L = table.shape[0]
    split = table[:, 10] > 0.5
    ok = (leaf >= 0) & (leaf < L)
    lf = torch.where(ok, leaf, L).long()
    per = torch.bincount(lf, minlength=L + 1)[:L] * split
    return int(split.sum()), int(per.sum()), int(per.max())


#: --rounds: kernel -> (plan, its wrappers (in ops/histogram.py, or the
#: grower's own name for one it imports), BENCH_PARAMS changes, a
#: function of (args, kwargs, the call) giving (W, landed rows, the
#: largest slot's rows)); A and D histogram the rows after their
#: routing (the call's second output), I the leaf ids of its arguments
ROUND_KERNELS = {
    "A": ("fused_tiled", ("fused_route_hist",), {},
          lambda a, k, d: _slot_rounds(a, 4, d(*a, **k)[1])),
    "D": ("fused_streamed", ("fused_onehot_hist",),
          {"quantized_grad": False},
          lambda a, k, d: _slot_rounds(a, 5, d(*a, **k)[1])),
    "I": ("q_onthefly", ("bins_hist_q_packed", "bins_hist_q"),
          {"hist_kernel_tiled": False, "hist_fused_route": False},
          lambda a, k, d: _slot_rounds(a, 3, a[2])),
    "J": ("seg_tiled(leaf_partition)", ("seg_hist",),
          {"hist_leaf_partition": "on"}, lambda a, k, d: _seg_round(a)),
    "H": ("q_tiled(split_route)", ("route_only_tiled",),
          {"hist_split_route": True}, lambda a, k, d: _route_round(a)),
}


def capture_rounds(root: str, kernel: str, X, y, trees: int = 2):
    """[(wrapper, args, kwargs)] of the last tree's launches of the
    kernel, in order, of ``trees`` trees of its plan trained with the
    tree at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.boosting import create_boosting
    from lightgbm_tpu_torch.learner import grower as GR
    from lightgbm_tpu_torch.ops import histogram as H
    if not os.path.abspath(H.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {H.__file__}, not the tree at {root}")
    cs = _chip_smoke()
    plan, wrappers, change, _ = ROUND_KERNELS[kernel]
    cfg = lgb.Config.from_params(dict(cs.BENCH_PARAMS, **change))
    gbdt = create_boosting(cfg, lgb.Dataset(X, label=y).construct(cfg))
    if gbdt.grower.plan.name != plan:
        raise RuntimeError(f"plan {gbdt.grower.plan.name}, not {plan}")
    # the grower calls some wrappers by its own imported name
    mods = [m for m in (H, GR) if any(hasattr(m, w) for w in wrappers)]
    calls = []
    kept = {(m, w): getattr(m, w) for m in mods for w in wrappers
            if hasattr(m, w)}

    def keeper(d):
        def kept_call(*args, **kwargs):
            calls.append((d, args, kwargs))
            return d(*args, **kwargs)
        return kept_call
    for (m, w), d in kept.items():
        setattr(m, w, keeper(d))
    try:
        for _ in range(trees):
            calls.clear()
            gbdt.train_one_iter()
    finally:
        for (m, w), d in kept.items():
            setattr(m, w, d)
    return list(calls)


def time_rounds(kernel, calls, reps: int) -> list:
    """[{W, landed, top_share, ms}] of the kernel on each kept launch."""
    import torch
    cs = _chip_smoke()
    describe = ROUND_KERNELS[kernel][3]
    out = []
    for d, args, kwargs in calls:
        W, landed, top = describe(args, kwargs, d)
        ms = cs.time_ms(lambda: d(*args, **kwargs), torch.device("cuda"),
                        reps)
        dms = _device_ms(cs, lambda: d(*args, **kwargs), reps)
        out.append(dict(W=W, landed=landed, top_share=top / max(landed, 1),
                        ms=ms, device_ms=dms))
    return out


def text_digest(root: str, trees: int = 10) -> dict:
    """{plan, trees, sha256 of the model text} of ``trees`` main-path
    trees trained with the tree at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import lightgbm_tpu_torch as lgb
    if not os.path.abspath(lgb.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {lgb.__file__}, not the tree at {root}")
    cs = _chip_smoke()
    X, y, _ = cs.make_data(1_000_000, 28, seed=7)
    bst = lgb.train(dict(cs.BENCH_PARAMS), lgb.Dataset(X, label=y), trees,
                    verbose_eval=False, keep_training_booster=True)
    text = bst.model_to_string()
    return dict(plan=bst.gbdt.grower.plan.name, trees=bst.num_trees(),
                sha256=hashlib.sha256(text.encode()).hexdigest())


def texts_main(parent: str, card: str) -> int:
    runs = _runs("--text-root", parent)
    if runs is None:
        return 1
    print(f"card: {card}")
    for label, r in runs:
        print(f"{label}: plan {r['plan']}, {r['trees']} trees, model text "
              f"sha256 {r['sha256']}")
    same = len({r["sha256"] for _, r in runs}) == 1
    print(f"model texts byte-identical across parent and change: {same}")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "hist_ab_texts.json"),
              "w") as fh:
        json.dump(dict(card=card, runs=runs, identical=same), fh, indent=1)
    return 0 if same else 1


def _runs(flag: str, parent: str, extra=()):
    runs = []
    for label, root in (("parent", parent), ("change", HERE),
                        ("change", HERE), ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            flag, root, *extra], capture_output=True,
                           text=True)
        if r.returncode != 0:
            print(r.stdout, r.stderr, file=sys.stderr)
            return None
        runs.append((label, json.loads(r.stdout.strip().splitlines()[-1])))
    return runs


def rounds_main(parent: str, card: str, only=None) -> int:
    runs = _runs("--time-rounds", parent,
                 ("--only", ",".join(only)) if only else ())
    if runs is None:
        return 1
    print(f"card: {card}")
    record = {"card": card}
    for kernel, (plan, *_) in ROUND_KERNELS.items():
        if kernel not in runs[0][1]:
            continue
        print(f"kernel {kernel}, one launch a grower round of a {plan} tree"
              + (" (W: leaves that split; landed: their rows)"
                 if kernel == "H" else ""))
        print(f"{'round':>5} {'W':>4} {'landed':>8} {'top slot':>8} "
              f"{'parent ms (run 1, 4)':>22} {'change ms (run 2, 3)':>22}  "
              "ratio")
        par = [r[kernel] for lab, r in runs if lab == "parent"]
        chg = [r[kernel] for lab, r in runs if lab == "change"]
        if any(len(r) != len(par[0]) for r in par + chg):
            print("the trees ran different rounds", file=sys.stderr)
            return 1
        for key in ("ms", "device_ms"):
            print(f"{key}: CUDA events around each launch" if key == "ms"
                  else f"{key}: device time a launch (profiler)")
            for i, c in enumerate(chg[0]):
                p = [r[i][key] for r in par]
                m = [r[i][key] for r in chg]
                print(f"{i:>5} {c['W']:>4} {c['landed']:>8} "
                      f"{c['top_share']:>8.3f} {p[0]:>10.4f} {p[1]:>10.4f}  "
                      f"{m[0]:>10.4f} {m[1]:>10.4f}  "
                      f"{np.mean(m) / np.mean(p):.3f}")
            sums = {lab: [sum(x[key] for x in r) for r in rs]
                    for lab, rs in (("parent", par), ("change", chg))}
            print(f"kernel {kernel} per tree ({key}): parent "
                  + ", ".join(f"{x:.4f}" for x in sums["parent"])
                  + " ms; change "
                  + ", ".join(f"{x:.4f}" for x in sums["change"])
                  + f" ms ({card})")
        record[kernel] = dict(plan=plan, parent=par, change=chg, sums=sums)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "hist_ab_rounds.json"),
              "w") as fh:
        json.dump(record, fh, indent=1)
    return 0


def main(argv) -> int:
    only = (tuple(argv[argv.index("--only") + 1].split(","))
            if "--only" in argv else None)
    if "--time-root" in argv:
        root = argv[argv.index("--time-root") + 1]
        print(json.dumps(time_tree(root, 1_000_000, 20, only,
                                   "--no-check" not in argv)))
        return 0
    if "--text-root" in argv:
        print(json.dumps(text_digest(argv[argv.index("--text-root") + 1])))
        return 0
    if "--time-rounds" in argv:
        root = argv[argv.index("--time-rounds") + 1]
        X, y, _ = _chip_smoke().make_data(1_000_000, 28, seed=7)
        out = {}
        for kernel in ROUND_KERNELS:
            if only and kernel not in only:
                continue
            calls = capture_rounds(root, kernel, X, y)
            out[kernel] = time_rounds(kernel, calls, 10)
        print(json.dumps(out))
        return 0
    if "--parent" not in argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent = argv[argv.index("--parent") + 1]
    cs = _chip_smoke()
    card = cs.card_line()
    if "--rounds" in argv:
        return rounds_main(parent, card, only)
    if "--texts" in argv:
        return texts_main(parent, card)
    runs = _runs("--time-root", parent,
                 ("--only", ",".join(only)) if only else ())
    if runs is None:
        return 1
    print(f"card: {card}")
    print(f"{'case':<26} {'parent ms (run 1, 4)':>22} "
          f"{'change ms (run 2, 3)':>22}  ratio")
    table = {}
    for case in runs[0][1]:
        p = [r[case] for lab, r in runs if lab == "parent"]
        c = [r[case] for lab, r in runs if lab == "change"]
        ratio = np.mean(c) / np.mean(p)
        table[case] = dict(parent_ms=p, change_ms=c, ratio=ratio)
        print(f"{case:<26} {p[0]:>10.4f} {p[1]:>10.4f}  {c[0]:>10.4f} "
              f"{c[1]:>10.4f}  {ratio:.3f}")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "hist_ab.json"), "w") as fh:
        json.dump(dict(card=card, cases=table), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
