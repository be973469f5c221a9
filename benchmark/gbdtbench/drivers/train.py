"""Training cells: one ``lightgbm_tpu_torch.train`` call over the
configuration's rows.

Set-up makes the rows from the seed, constructs the ``Dataset`` (timed
apart as ``construct_s``) and starts ``train`` with a round count that
the window never reaches.  A training callback (the public callback
API) ends set-up after ``warmup_iterations`` iterations, synchronising
the device, and starts the window; at the first iteration end past
``--seconds`` it synchronises again and closes it.  Traced, the profiler
then records ``trace_iterations`` more iterations, each in a
``bench.iteration`` range.  The callback then ends training with
``EarlyStopException``.

The check, once the program's state is freed, holds the run to the
plain reference (``benchmark/reference``): the bin upper bounds and the
bin matrix exactly; the first ``checked_trees`` trees' splits and leaf
values (``split_regret``, ``leaf_gap``), their leaf counts
(``leaf_shortfall``) and which leaves they split (``frontier_regret``);
the training scores at the window's end on a sample of rows drawn from
the seed (``score_gap``).

A traffic with ``ranks`` > 1 runs one process a rank (rank 0 starts the
others), each on its own card and its block of the rows, joined by the
program's device plane (``collective_transport=xla``); rank 0 checks.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import data as D
from ..trace import Capture

ROUNDS = 1_000_000


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _params(run) -> Dict:
    p = run.spec.params()
    p.update({"device": run.device.type, "verbose": -1,
              "telemetry": "trace" if run.trace else "off"})
    if run.world > 1:
        p.update({"num_machines": run.world, "tree_learner": "data",
                  "collective_transport": "xla"})
    return p


class Window:
    """The training callback that measures the window."""

    def __init__(self, run, warmup: int, traced: int):
        self.run, self.warmup, self.traced = run, warmup, traced
        self.t0 = self.t1 = None
        self.first = None
        self.trees = 0
        self.cap = self.rf = self.outer = None
        self.left = traced
        self.trace_first = None
        self.tw0 = self.tw1 = None

    def _stop(self, it):
        from lightgbm_tpu_torch import EarlyStopException
        raise EarlyStopException(it)

    def __call__(self, env):
        run, it = self.run, env.iteration
        dev = run.device
        if it == self.warmup - 1:
            _sync(dev)
            self.t0 = time.perf_counter()
            run.setup_s = self.t0 - run.t_start
            self.first = it + 1
            return
        if self.t0 is None:
            return
        if self.t1 is None:
            if time.perf_counter() - self.t0 < run.seconds:
                return
            _sync(dev)
            self.t1 = time.perf_counter()
            self.trees = it - self.first + 1
            if not run.trace:
                self._stop(it)
            self.cap = Capture().__enter__()
            self.trace_first = it + 1
            self.tw0 = time.perf_counter()
            self.outer = torch.profiler.record_function("bench.traced")
            self.outer.__enter__()
        else:
            self.rf.__exit__(None, None, None)
            self.left -= 1
            if self.left == 0:
                _sync(dev)
                self.outer.__exit__(None, None, None)
                self.tw1 = time.perf_counter()
                self.cap.__exit__(None, None, None)
                self._stop(it)
        self.rf = torch.profiler.record_function("bench.iteration")
        self.rf.__enter__()


def _local(run, arr):
    if run.world <= 1 or arr is None:
        return arr
    per = len(arr) // run.world
    return arr[run.rank * per:(run.rank + 1) * per]


def execute(run) -> None:
    import lightgbm_tpu_torch as lgb
    tr, dev = run.traffic, run.device
    params = _params(run)
    rows = D.make_rows(run.config, run.seed, dev, run.rows)
    X = rows["X"].to(torch.float64).cpu().numpy()
    y = rows["y"].cpu().numpy()
    group = rows["group"]
    del rows
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    if run.world > 1:
        from lightgbm_tpu_torch.config import Config
        from lightgbm_tpu_torch.parallel import distributed as dist
        cfg = Config.from_params(params)
        dist.initialize(run.coord, run.world, run.rank, config=cfg,
                        backend="nccl" if dev.type == "cuda" else "gloo")
        t = time.perf_counter()
        train_set = dist.finalize_global(dist.construct_sharded(
            _local(run, X), label=_local(run, y), config=cfg))
        core = train_set
    else:
        t = time.perf_counter()
        train_set = lgb.Dataset(X, label=y, group=group, params=params)
        core = train_set.construct()
    run.layer["construct_s"] = time.perf_counter() - t
    kept = {"bounds": [np.array(m.bin_upper_bound) for m in core.mappers],
            "features": [(f.feature_idx, f.group, f.offset,
                          bool(core.group_is_multi[f.group]))
                         for f in core.features],
            "bins": core.logical_group_bins()}
    win = Window(run, int(tr["warmup_iterations"]),
                 int(tr.get("trace_iterations", 0)))
    booster = lgb.train(params, train_set, num_boost_round=ROUNDS,
                        callbacks=[win], keep_training_booster=True)
    if win.t1 is None:
        raise RuntimeError("training ended before the window closed")
    run.memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
    run.attempted = win.trees
    run.window = {"seconds": win.t1 - win.t0, "trees": win.trees}
    kept["text"] = booster.model_to_string()
    # a rank's training scores are its own block's rows
    kept["scores"] = booster._current_train_scores()[:len(_local(run, y))]
    if run.trace:
        run.view = win.cap.view()
        spans = run.view.ranges("bench.traced")
        run.traced_span = spans[0] if spans else (0.0, 0.0)
        run.layer.update({"trace_first": win.trace_first,
                          "trace_iterations": win.traced,
                          "trace_wall_s": win.tw1 - win.tw0})
    del booster, train_set, core
    if run.world > 1:
        from lightgbm_tpu_torch.parallel import distributed as dist
        dist.shutdown()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kept["X"], kept["y"], kept["group"] = X, y, group
    run.layer["trees"] = _trees(kept["text"])
    run.layer["num_data"] = len(y)
    if run.rank == 0:
        check(run, kept)


def _trees(text: str) -> List[dict]:
    from reference import model_text
    return model_text.parse(text)


def reference_inputs(run, X: np.ndarray, y: np.ndarray, group):
    """(X float64 on the device, reference bounds and bins, the exact
    gradient function, the tree params) for the whole row set."""
    from reference import binning as RB
    from reference import objectives as RO
    p = run.spec.params()
    dev = run.device
    Xd = torch.as_tensor(X, device=dev)
    bounds = RB.bin_bounds(X, int(p.get("max_bin", 255)),
                           int(p.get("min_data_in_bin", 3)),
                           int(p.get("bin_construct_sample_cnt", 200000)),
                           int(p.get("data_random_seed", 1)),
                           ranks=run.world)
    bins = RB.bin_matrix(Xd, bounds)
    yd = torch.as_tensor(y, device=dev)
    if p.get("objective") == "lambdarank":
        lr = RO.Lambdarank(y, group, dev,
                           max_position=int(p.get("max_position", 20)))
        grad = lr.gradients
    else:
        def grad(score):
            return RO.binary_gradients(score, yd)
    cfg = {"learning_rate": float(p.get("learning_rate", 0.1)),
           "num_leaves": int(p.get("num_leaves", 31)),
           "lambda_l2": float(p.get("lambda_l2", 0.0)),
           "min_data_in_leaf": float(p.get("min_data_in_leaf", 20)),
           "min_sum_hessian_in_leaf": float(
               p.get("min_sum_hessian_in_leaf", 1e-3))}
    return Xd, bounds, bins, grad, cfg


def _median_floor(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x.abs(), x.abs().median())


def check(run, kept: Dict) -> None:
    """Compare the program's outputs with the plain reference."""
    from reference import gbdt as RG
    from reference import model_text as MT
    dev = run.device
    Xd, bounds, bins, grad, cfg = reference_inputs(run, kept["X"],
                                                   kept["y"], kept["group"])
    run.check("bin_bounds_mismatch", sum(
        not (len(a) == len(b) and np.array_equal(a, b))
        for a, b in zip(kept["bounds"], bounds)) + abs(
        len(kept["bounds"]) - len(bounds)))
    n_local = kept["bins"].shape[0]
    prog = torch.as_tensor(kept["bins"], device=dev)
    bad = 0
    for f, g, off, multi in kept["features"]:
        want = bins[:n_local, f].to(torch.int32) + off
        bad += int((prog[:, g].to(torch.int32) != want).sum()) \
            if not multi else n_local
    bad += n_local * (len(bounds) - len(kept["features"]))
    run.check("bin_matrix_mismatch", bad)
    del prog
    trees = run.layer["trees"]
    judged = RG.judge(Xd, bins, bounds, grad,
                      trees[:int(run.traffic["checked_trees"])], cfg)
    run.layer["where"] = judged["where"]
    run.check("split_regret", judged["split_regret"])
    run.check("leaf_gap", judged["leaf_gap"])
    run.check("leaf_gap_median", judged["leaf_gap_median"])
    run.check("leaf_shortfall", judged["leaf_shortfall"])
    run.check("frontier_regret", judged["frontier_regret"])
    n = min(n_local, int(run.traffic.get("score_rows", n_local)))
    gen = D.generator(run.seed ^ 0x5C0BE, "cpu")
    idx = torch.randperm(n_local, generator=gen)[:n].to(dev)
    want = MT.raw_scores(Xd[idx], trees)
    have = torch.as_tensor(np.asarray(kept["scores"]), device=dev)[idx]
    run.check("score_gap", float(((have.to(torch.float64) - want).abs()
                                  / _median_floor(want)).max()))


def control(run, precision: str) -> Dict[str, float]:
    """The control: the reference grower in the program's place, on
    gradients held at ``precision``, for the checked trees; the judge's
    readings of its trees."""
    from reference import gbdt as RG
    from reference import model_text as MT
    rows = D.make_rows(run.config, run.seed, run.device, run.rows)
    X = rows["X"].to(torch.float64).cpu().numpy()
    y = rows["y"].cpu().numpy()
    group = rows["group"]
    del rows
    Xd, bounds, bins, grad, cfg = reference_inputs(run, X, y, group)
    score = torch.zeros(Xd.shape[0], dtype=torch.float64, device=run.device)
    trees = []
    for _ in range(int(run.traffic["checked_trees"])):
        g, h = RG.precision_cast(*grad(score), precision)
        t = RG.grow(bins, bounds, g, h, cfg)
        trees.append(t)
        lv = torch.as_tensor(t["leaf_value"], device=run.device)
        score = score + lv[MT.leaf_index(Xd, t)]
    return RG.judge(Xd, bins, bounds, grad, trees, cfg)
