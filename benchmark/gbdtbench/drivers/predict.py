"""Scoring cells: ``Booster.predict`` on batches of a table, back to back
from one client (a closed loop).

Set-up draws ``batches`` float64 batches of ``batch_rows`` rows from the
seed, writes a random model text of ``model.trees`` leaf-wise trees on
the configuration's ``max_bin`` boundaries of its rows, the same for
every seed (``data.random_model_text``), loads it with ``Booster(model_str=...)``
as a scoring service loads a trained file, and scores every batch once.
The window calls ``predict`` on the batches in turn until ``--seconds``
have passed, timing each call on the host clock; a call's output is a
host array, so each call ends when its scores are there.  Traced, the
profiler then records ``trace_calls`` more calls, each in a
``bench.predict`` range.

The check, once the booster is freed: the reference scores each batch
from the same model text in float64 (``reference/model_text.py``), and
``predict_gap`` is the largest difference of a probability, over every
call's rows at ``sample_rows`` positions drawn from the seed and over
the last call's rows of each batch in full.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import data as D
from ..trace import Capture
from .train import _sync


def execute(run) -> None:
    import lightgbm_tpu_torch as lgb
    tr, dev = run.traffic, run.device
    n = int(run.rows or tr["batch_rows"])
    dev_batches = D.score_rows(run.config, run.seed, n, int(tr["batches"]),
                               dev)
    text = model_text(run, n)
    batches = [b.cpu().numpy() for b in dev_batches]
    del dev_batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    booster = lgb.Booster(params={"device": dev.type, "verbose": -1},
                          model_str=text)
    for b in batches:
        booster.predict(b)
    _sync(dev)
    gen = D.generator(run.seed ^ 0x5A3E, "cpu")
    pos = torch.randperm(n, generator=gen)[:int(tr["sample_rows"])].numpy()
    sampled, last, lat = [], {}, []
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    k = 0
    while time.perf_counter() - t0 < run.seconds:
        i = k % len(batches)
        a = time.perf_counter()
        out = booster.predict(batches[i])
        lat.append(time.perf_counter() - a)
        sampled.append((i, out[pos]))
        last[i] = out
        k += 1
    t1 = time.perf_counter()
    run.attempted = k
    run.window = {"seconds": t1 - t0, "calls": k, "rows": k * n,
                  "latencies": lat}
    if run.trace:
        calls = int(tr["trace_calls"])
        with Capture() as cap:
            with torch.profiler.record_function("bench.traced"):
                for j in range(calls):
                    with torch.profiler.record_function("bench.predict"):
                        booster.predict(batches[j % len(batches)])
                _sync(dev)
        run.view = cap.view()
        spans = run.view.ranges("bench.traced")
        run.traced_span = spans[0] if spans else (0.0, 0.0)
        run.layer["trace_calls"] = calls
    run.memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
    del booster
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from reference import model_text as MT
    trees = MT.parse(text)
    run.layer.update({"trees": trees, "rows": n,
                      "num_features": batches[0].shape[1]})
    want = [torch.sigmoid(MT.raw_scores(torch.as_tensor(b, device=dev),
                                        trees)).cpu().numpy()
            for b in batches]
    if run.trace:
        run.layer["visits"] = MT.node_visits(
            torch.as_tensor(batches[0], device=dev), trees)
    gap = 0.0
    for i, got in sampled:
        gap = max(gap, float(np.abs(got - want[i][pos]).max()))
    for i, got in last.items():
        gap = max(gap, float(np.abs(got - want[i]).max()))
    run.check("predict_gap", gap if sampled else float("inf"))


def model_text(run, n: int) -> str:
    """The served model: the same for every seed (it stands for the one
    trained file that the deployment serves), on the boundaries of a
    batch drawn from the concept's seed."""
    edges = D.bin_edges(D.score_rows(run.config, D.CONCEPT_SEED, n, 1,
                                     run.device)[0],
                        int(run.config["params"].get("max_bin", 255)))
    return D.random_model_text(run.config, run.traffic["model"], edges,
                               D.CONCEPT_SEED)


def control(run) -> float:
    """The control: the reference in float32 (rows, thresholds, leaf
    values and sums) in the program's place, over every row of every
    batch; its largest gap to the float64 reference."""
    from reference import model_text as MT
    tr, dev = run.traffic, run.device
    n = int(run.rows or tr["batch_rows"])
    batches = D.score_rows(run.config, run.seed, n, int(tr["batches"]), dev)
    trees = MT.parse(model_text(run, n))
    gap = 0.0
    for b in batches:
        want = torch.sigmoid(MT.raw_scores(b, trees))
        low = torch.sigmoid(MT.raw_scores(b, trees, dtype=torch.float32))
        gap = max(gap, float((low.to(torch.float64) - want).abs().max()))
    return gap
