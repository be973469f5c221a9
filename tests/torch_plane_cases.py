"""Inputs and the worker of the device-plane tests
(tests/test_torch_distributed.py): ``collective_transport=xla`` with
``device=cpu``, torch.distributed over gloo between real processes.

The worker imports only the port and numpy (this module included); the
JAX references run in the pytest parent.  ``launch`` starts a world of
workers, ``finish`` collects each rank's results (an ``.npz`` of
arrays, its ``str`` entries the messages) and kills every worker still
running when the time limit passes.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: rows a rank trains: one xla chunk of 28 groups x 64 bins in f32
#: (ops/histogram.py _pick_chunk), so every rank's rows fill whole chunks,
#: the per-rank layout has no pad and equals the single-process mesh's
ROWS_PER_RANK = 9216
TRAIN_PARAMS = {"objective": "binary", "verbose": -1, "num_leaves": 15,
                "min_data_in_leaf": 5, "max_bin": 63,
                "tree_learner": "data"}
TREES = 6
#: the binning run's sample quota: below a rank's 2,000 rows, so each
#: rank draws its sample (seed + 7919 * rank)
BIN_SAMPLE = 1000
#: the other runs on the plane, 3 trees each: (name, params over
#: TRAIN_PARAMS)
LEARNERS = {"voting": {"tree_learner": "voting", "top_k": 5},
            "q16": {"hist_exchange": "q16"}}
#: the codec's histograms: (leaves, groups, bins, 3) at each bin count
CODEC_SHAPE = (7, 5)
CODEC_BINS = (15, 64)
CODEC_MODES = ("f32", "q16", "q8")


def train_data(world):
    rng = np.random.RandomState(0)
    n = ROWS_PER_RANK * world
    X = rng.randn(n, 28)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.2 * rng.randn(n) > 0).astype(float)
    return X, y


def bin_data():
    """tests/test_distributed.py's binning data: 30% zeros."""
    rng = np.random.RandomState(0)
    X = rng.randn(4000, 6)
    X[rng.rand(4000, 6) < 0.3] = 0.0
    return X, (X[:, 0] > 0).astype(float)


def meta_data(world, n_local=50, k=3):
    """Per-rank rows with weights and a class-major (k, n_local) init
    score, for finalize_global's metadata layout."""
    out = []
    for r in range(world):
        rng = np.random.RandomState(40 + r)
        out.append((rng.randn(n_local, 4), rng.randint(0, k, n_local)
                    .astype(float), rng.uniform(0.5, 2.0, n_local),
                    rng.randn(k, n_local).reshape(-1)))
    return out


def codec_hists(world, bins):
    """Each rank's histogram: smooth float gradient sums and an integral
    count channel (the codec's exact path)."""
    out = []
    for r in range(world):
        rng = np.random.RandomState(100 + r)
        h = (rng.randn(*CODEC_SHAPE, bins, 3) * 40).astype(np.float32)
        h[..., 2] = rng.randint(0, 60, CODEC_SHAPE + (bins,))
        out.append(h)
    return out


def coll_inputs(world):
    """Each rank's (tensor, gain, payload) for the plane's collectives:
    6 rows (a whole chunk a rank at 2 and 3 ranks), gains tied between
    ranks 1 and 2."""
    out = []
    for r in range(world):
        rng = np.random.RandomState(200 + r)
        out.append((rng.randn(6, 5).astype(np.float32),
                    np.float32([3.0, 7.0, 7.0][r]),
                    np.arange(4, dtype=np.float32) + 10 * r))
    return out


def rank_slice(n, world, rank):
    per = n // world
    return slice(rank * per, (rank + 1) * per)


_WORKER = r"""
import json, sys
spec = json.loads(sys.argv[1])
sys.path.insert(0, spec["tests"])
import numpy as np
import torch
import torch.distributed as dist
import torch_plane_cases as C
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.parallel import collectives as PC
from lightgbm_tpu_torch.parallel import distributed as D
from lightgbm_tpu_torch.telemetry import TELEMETRY

world, rank = spec["world"], spec["rank"]
base = {"device": "cpu", "collective_transport": "xla", "verbose": -1}
D.initialize(spec["coord"], world, rank, config=Config.from_params(base))
assert D.plane().backend == "gloo" and D._process_index() == rank
res = {}


def cfg(**kw):
    return Config.from_params(dict(base, **kw))


def error(fn):
    try:
        fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


if "bins" in spec["tasks"]:
    X, y = C.bin_data()
    sl = C.rank_slice(len(X), world, rank)
    ds = D.construct_sharded(X[sl], label=y[sl], config=cfg(
        objective="binary", bin_construct_sample_cnt=C.BIN_SAMPLE))
    res["bins_infos"] = "|".join(ds.feature_infos())
    res["bins"] = ds.group_bins

if "train" in spec["tasks"]:
    TELEMETRY.configure("counters", fence=True)
    X, y = C.train_data(world)
    sl = C.rank_slice(len(X), world, rank)
    c = cfg(**C.TRAIN_PARAMS)
    ds = D.finalize_global(D.construct_sharded(X[sl], label=y[sl], config=c))
    g = GBDT(c, ds)
    res["shard_shape"] = np.array(g.grower.shard_bins[0].shape)
    res["resident"] = g.grower.resident_bin_bytes()
    res["n_padded"] = g.grower.n_padded
    g.add_train_metrics()
    for _ in range(C.TREES):
        g.train_one_iter()
    g.flush_models()
    res["text"] = "".join(t.to_string() for t in g.models)
    res["train_metric"] = np.array([v for *_, v, _b in g.eval_metrics("train")])
    res["straggler"] = TELEMETRY.gauges().get("straggler_ratio", -1.0)
    TELEMETRY.configure("off")

if "learners" in spec["tasks"]:
    # the voting learner and the data learner under q16, 3 trees each
    X, y = C.train_data(world)
    sl = C.rank_slice(len(X), world, rank)
    for name, over in C.LEARNERS.items():
        c = cfg(**dict(C.TRAIN_PARAMS, **over))
        g = GBDT(c, D.finalize_global(D.construct_sharded(
            X[sl], label=y[sl], config=c)))
        for _ in range(3):
            g.train_one_iter()
        g.flush_models()
        res[f"text_{name}"] = "".join(t.to_string() for t in g.models)

if "codec" in spec["tasks"]:
    TELEMETRY.configure("counters")
    coll = PC.ProcessGroupCollectives(D.plane())
    handed = []
    real = dist.all_reduce, dist.all_gather

    def all_reduce(t, *a, **k):
        handed.append(str(t.dtype))
        return real[0](t, *a, **k)

    def all_gather(out, t, *a, **k):
        handed.append(str(t.dtype))
        return real[1](out, t, *a, **k)
    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    for bins in C.CODEC_BINS:
        h = torch.from_numpy(C.codec_hists(world, bins)[rank])
        for mode in C.CODEC_MODES:
            TELEMETRY.reset()
            res[f"codec_{mode}_{bins}"] = PC.exchange_histograms_ranks(
                h, mode, coll).numpy()
            res[f"wire_{mode}_{bins}"] = TELEMETRY.counters()[
                "collective_hist_exchange_bytes"]
    dist.all_reduce, dist.all_gather = real
    res["handed"] = ",".join(sorted(set(handed)))
    x, gain, pay = (torch.from_numpy(np.asarray(a))
                    for a in C.coll_inputs(world)[rank])
    for name, got in (("sum", coll.allreduce_sum([x])),
                      ("reduce_scatter", coll.reduce_scatter([x])),
                      ("all_gather", coll.all_gather([x])),
                      ("min", coll.global_min([x])),
                      ("max", coll.global_max([x])),
                      ("mean", coll.global_mean([x])),
                      ("argmax", coll.argmax_sync([gain], [pay]))):
        res[f"coll_{name}"] = got[0].numpy()
    TELEMETRY.configure("off")

if "meta" in spec["tasks"]:
    Xl, yl, wl, il = C.meta_data(world)[rank]
    c = cfg(objective="multiclass", num_class=3, tree_learner="data",
            min_data_in_leaf=2)
    ds = D.construct_sharded(Xl, label=yl, weight=wl, config=c)
    ds.metadata.set_init_score(il)
    ds = D.finalize_global(ds)
    res["md_label"] = ds.metadata.label
    res["md_weight"] = ds.metadata.weight
    res["md_init"] = ds.metadata.init_score
    g = GBDT(c, ds)
    res["pad_label"] = g.grower.pad_rows(ds.metadata.label)
    res["scores"] = g.scores.numpy()
    res["counts"] = g._full_counts.numpy()
    res["per_host"] = g.grower._mh_per_host

if "refuse" in spec["tasks"]:
    X, y = C.train_data(world)
    sl = C.rank_slice(len(X), world, rank)
    c = cfg(**C.TRAIN_PARAMS)
    ds = D.finalize_global(D.construct_sharded(X[sl], label=y[sl], config=c))
    res["err_l1"] = error(lambda: GBDT(cfg(**dict(
        C.TRAIN_PARAMS, objective="regression_l1")), ds))
    res["err_serial"] = error(lambda: GBDT(cfg(**dict(
        C.TRAIN_PARAMS, tree_learner="serial")), ds))
    res["err_feature"] = error(lambda: GBDT(cfg(**dict(
        C.TRAIN_PARAMS, tree_learner="feature")), ds))
    res["err_valid"] = error(lambda: GBDT(c, ds).add_valid(ds, "v"))
    from lightgbm_tpu_torch.boosting.goss import GOSS
    res["err_goss"] = error(lambda: GOSS(c, ds))
    n_l = sl.stop - sl.start
    res["err_query"] = error(lambda: D.finalize_global(D.construct_sharded(
        X[sl], label=y[sl], group=[n_l // 2, n_l - n_l // 2], config=c)))

np.savez(spec["out"], **res)
D.shutdown()
print("DONE", rank, flush=True)
"""


def _free_coord():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def launch(world, tasks, outdir):
    """Start ``world`` worker processes running ``tasks``; returns
    (processes, their result paths)."""
    coord = _free_coord()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs, paths = [], []
    for r in range(world):
        path = os.path.join(str(outdir), f"w{world}_r{r}.npz")
        spec = {"coord": coord, "world": world, "rank": r, "tasks": tasks,
                "out": path, "tests": os.path.join(REPO, "tests")}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO))
        paths.append(path)
    return procs, paths


def finish(procs, paths, timeout=120):
    """Each rank's results as a dict; raises AssertionError naming the
    rank whose process failed.  Every worker is killed on the way out,
    so a hung rank cannot hang the suite."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, (out, err), path) in enumerate(zip(procs, outs, paths)):
        assert p.returncode == 0 and f"DONE {r}" in out, \
            f"rank {r} exited {p.returncode}: {err[-3000:]}"
        with np.load(path) as z:
            results.append({k: (str(z[k]) if z[k].dtype.kind == "U"
                                else z[k]) for k in z.files})
    return results
