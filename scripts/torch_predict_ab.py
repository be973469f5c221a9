#!/usr/bin/env python3
"""Time kernel C (the ensemble level descent) of two trees on one card,
in turns.

    git archive <commit> | tar -x -C build/ab_parent   # the other tree
    python3 scripts/torch_predict_ab.py --parent build/ab_parent [--tiers]
        [--change DIR] [--reuse]

First trains the bench's main path (chip_smoke.py make_data 1,000,000 x
28, BENCH_PARAMS, 10 trees of 255 leaves) with this tree and keeps its
model text and 200,000 held-out rows under build/predict_ab/.  Then runs
the other tree, this tree, this tree, the other tree, each in its own
process that imports lightgbm_tpu_torch from that tree (building its
kernels into that tree's build/kernels), loads the model text, and
times ``predict_level_ensemble`` on:

  (a) the 200,000 held-out rows through the bench's 10 trees;
  (b) 1,000,000 rows through 10 random depth-8 trees with NaN, zero and
      categorical nodes (chip_smoke.py random_trees, phase 2's inputs);
  (c) 200,000 rows through 500 random depth-8 trees;
  (d) 200,000 rows through 30 random depth-8 trees of K = 3 classes;
  (e) the first 1, 16 and 1,000 held-out rows through (a)'s trees.

--change DIR times the tree in DIR in this tree's place; --reuse keeps
the trained model and rows already in build/predict_ab/.  A tree whose
predict module has ``pack_level_records`` is given the
records packed once (as its Booster keeps them); an earlier tree the
LevelEnsemble.  Prints for each case the median of CUDA events around
single calls and, as "(device)", the mean device time of a call from
torch.profiler, with the card's name and power limit, the change's plan
and both of its bounds (chip_smoke.py level_bounds: bytes, and node
visits over the shared-memory rate), and writes
chiprun_out/predict_ab.json.

With --tiers, this tree alone times both tiers of kernel C on (a)'s and
(c)'s ensembles at 1 to 200,000 rows (the rows of (a) repeated), by
both clocks, for the choice of ops/predict.py SHARED_TIER_MIN_ROWS, and
writes chiprun_out/predict_tiers.json.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(HERE, "build", "predict_ab")
LATENCY_ROWS = (1, 16, 1000)
TIER_ROWS = (1, 16, 64, 256, 1024, 4096, 16384, 65536, 200_000)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prepare(cs) -> None:
    """Train the bench's 10 trees with this tree; keep the model text and
    the held-out rows in WORK."""
    sys.path.insert(0, HERE)
    import lightgbm_tpu_torch as lgb
    X, y, w = cs.make_data(1_000_000, 28, seed=7)
    Xv, _, _ = cs.make_data(200_000, 28, seed=8, w=w)
    bst = lgb.train(dict(cs.BENCH_PARAMS), lgb.Dataset(X, label=y), 10,
                    verbose_eval=False)
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(WORK, "model.txt"), "w") as fh:
        fh.write(bst.model_to_string())
    np.save(os.path.join(WORK, "xv.npy"), Xv)


def _ensembles(cs, root: str):
    """{name: (ensemble as the tree's wrapper takes it, depth, LevelPlan
    or None)} and the rows of each case, for the tree at ``root``."""
    import torch
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import predict as P
    from lightgbm_tpu_torch.tree import flatten_ensemble
    if not os.path.abspath(P.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {P.__file__}, not the tree at {root}")
    dev = torch.device("cuda")
    packed = hasattr(P, "pack_level_records")

    def ens(trees, k):
        flat = flatten_ensemble(trees, k)
        depth = int(flat.pop("depth"))
        stack = P.level_ensemble_from_numpy(flat, dev)
        return (P.pack_level_records(stack) if packed else stack), depth

    def x2_of(X):
        return torch.from_numpy(P.interleave_hi_lo(X)).to(dev)

    with open(os.path.join(WORK, "model.txt")) as fh:
        bench = lgb.Booster(model_str=fh.read(),
                            params={"device": "cuda"}).models
    xv = np.load(os.path.join(WORK, "xv.npy"))
    rng = np.random.RandomState(11)
    cats = {3, 7}

    def rows(n):
        X = rng.randn(n, 28)
        X[rng.rand(n, 28) < 0.05] = np.nan
        X[rng.rand(n, 28) < 0.05] = 0.0
        for c in cats:
            X[:, c] = rng.randint(-1, 45, n)
        return x2_of(X)

    a = ens(bench, 1)
    xa = x2_of(xv)
    cases = {"(a) 200,000 rows, bench 10 trees": (a, xa),
             "(b) 1,000,000 rows, 10 depth-8 trees": (
                 ens(cs.random_trees(rng, 10, 8, 28, cats), 1),
                 rows(1_000_000)),
             "(c) 200,000 rows, 500 depth-8 trees": (
                 ens(cs.random_trees(rng, 500, 8, 28, cats), 1),
                 rows(200_000)),
             "(d) 200,000 rows, 30 trees, K=3": (
                 ens(cs.random_trees(rng, 30, 8, 28, cats), 3),
                 rows(200_000))}
    for n in LATENCY_ROWS:
        cases[f"(e) {n} rows, bench 10 trees"] = (
            a, xa[:n].contiguous())
    return cases, P, packed


def _device_ms(cs, fn, reps):
    ms = cs.device_ms(fn, reps)
    if ms is None:
        raise RuntimeError("torch.profiler recorded no device event")
    return ms


def time_tree(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    cs = _chip_smoke()
    dev = torch.device("cuda")
    cases, P, packed = _ensembles(cs, root)
    out = {}
    for name, ((e, depth), x2) in cases.items():
        def fn(e=e, x2=x2, depth=depth):
            return P.predict_level_ensemble(e, x2, depth=depth)
        out[name] = cs.time_ms(fn, dev, 20)
        out[f"{name} (device)"] = _device_ms(cs, fn, 20)
        if packed:
            out[f"{name} plan"] = str(P.level_plan(e, x2.shape[0],
                                                   x2.shape[1]))
            out[f"{name} bounds"] = cs.level_bounds(P, e, x2, depth)
    return out


def time_tiers() -> dict:
    """{ensemble: {rows: {tier: [events ms, device ms]}}} of this tree."""
    sys.path.insert(0, HERE)
    import torch
    cs = _chip_smoke()
    dev = torch.device("cuda")
    cases, P, _ = _ensembles(cs, HERE)
    out = {}
    for name in ("(a) 200,000 rows, bench 10 trees",
                 "(c) 200,000 rows, 500 depth-8 trees"):
        (rec, depth), x2 = cases[name]
        out[name] = {}
        for n in TIER_ROWS:
            x = x2[:n].contiguous()
            out[name][n] = {}
            for tier in ("global", "shared"):
                def fn(x=x, tier=tier):
                    return P.predict_level_ensemble(rec, x, depth=depth,
                                                    tier=tier)
                reps = 20 if n < 65536 or "500" not in name else 5
                out[name][n][tier] = [cs.time_ms(fn, dev, reps),
                                      _device_ms(cs, fn, reps)]
    return out


def tiers_main(card: str) -> int:
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--tiers-run"], capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout, r.stderr, file=sys.stderr)
        return 1
    res = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"card: {card}")
    for name, by_n in res.items():
        print(f"{name}: ms a call by CUDA events / device time (profiler)")
        print(f"{'rows':>8} {'global':>22} {'shared':>22}")
        for n, t in by_n.items():
            g, s = t["global"], t["shared"]
            print(f"{n:>8} {g[0]:>10.4f} {g[1]:>10.4f}  {s[0]:>10.4f} "
                  f"{s[1]:>10.4f}")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "predict_tiers.json"),
              "w") as fh:
        json.dump(dict(card=card, tiers=res), fh, indent=1)
    return 0


def main(argv) -> int:
    if "--time-root" in argv:
        print(json.dumps(time_tree(argv[argv.index("--time-root") + 1])))
        return 0
    if "--tiers-run" in argv:
        print(json.dumps(time_tiers()))
        return 0
    cs = _chip_smoke()
    card = cs.card_line()
    change = (argv[argv.index("--change") + 1] if "--change" in argv
              else HERE)
    if "--reuse" not in argv or not os.path.exists(
            os.path.join(WORK, "model.txt")):
        prepare(cs)
    if "--tiers" in argv:
        rc = tiers_main(card)
        if rc or "--parent" not in argv:
            return rc
    if "--parent" not in argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent = argv[argv.index("--parent") + 1]
    runs = []
    for label, root in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time-root", root], capture_output=True,
                           text=True)
        if r.returncode != 0:
            print(r.stdout, r.stderr, file=sys.stderr)
            return 1
        runs.append((label, json.loads(r.stdout.strip().splitlines()[-1])))
    print(f"card: {card}")
    print(f"{'case':<44} {'parent ms (run 1, 4)':>22} "
          f"{'change ms (run 2, 3)':>22}  ratio")
    table = {}
    for case in runs[1][1]:
        if case.endswith(" plan"):
            print(f"  change {case}: {runs[1][1][case]}")
            continue
        if case.endswith(" bounds"):
            b, v, visits = runs[1][1][case]
            table[case] = dict(bytes_ms=b, visits_ms=v, visits=visits)
            print(f"  {case}: {b:.4f} ms (bytes), {v:.4f} ms ({visits} node "
                  f"visits x 16 B of shared memory)")
            continue
        p = [r[case] for lab, r in runs if lab == "parent"]
        c = [r[case] for lab, r in runs if lab == "change"]
        ratio = np.mean(c) / np.mean(p)
        table[case] = dict(parent_ms=p, change_ms=c, ratio=ratio)
        print(f"{case:<44} {p[0]:>10.4f} {p[1]:>10.4f}  {c[0]:>10.4f} "
              f"{c[1]:>10.4f}  {ratio:.3f}")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "predict_ab.json"),
              "w") as fh:
        json.dump(dict(card=card, cases=table), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
