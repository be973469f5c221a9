"""Multi-process training of the port on the tcp plane
(``collective_transport=tcp``): real processes on the CPU, the port's
``parallel/distributed.py`` and ``sharded/binfind.py`` against the
JAX package's single-process runs.

* Two processes rendezvous, gather their boundary candidates over the
  wire and fit mappers equal to each other and to the JAX package's
  single-process fit of the same 2,000 rows (tests/test_distributed.py's
  binning data); then, on tests/test_distributed.py's training data,
  ``finalize_global`` gathers the labels and the bin rows in rank order
  and both train 8 trees whose text is byte for byte the port's
  single-process text.  That text equals the JAX package's
  single-process text split for split, leaves within 1e-5 (the xla
  plan's known divergence, ROADMAP.md queue 3).
* Three processes with ``transport_epoch_iters=1`` and
  ``sharded_allow_degraded=true``: rank 2 is killed at its third epoch
  boundary (``transport.round:3:kill``); both survivors reform the world
  and finish with the uninterrupted single-process text.
* The elastic rejoin (tests/test_distributed.py's
  test_three_process_elastic_rejoin_byte_identical): rank 0 writes the
  shard cache of the 1,800 rows and publishes its directory as
  ``handoff_meta``; after rank 2's kill a fresh process joins, takes
  rank 3, loads the cache (``load_shard_cache``) and the captured state
  (``restore_state``), and every finisher's text is byte for byte the
  uninterrupted single-process text.
* The device plane (``collective_transport=xla``, ``device=cpu``:
  torch.distributed over gloo; the workers in tests/torch_plane_cases.py):
  two processes sample their own rows and fit the mappers and bins the
  JAX package's ``sample_local_rows`` + gather fit (the JAX side run in
  this process, its rank patched in); two and three processes train the
  data learner holding only their own rows, every rank's text byte for
  byte the port's single-process 2- and 3-shard mesh text (each rank's
  rows fill whole chunks, so the layouts agree) and split for split the
  JAX package's 2-device mesh; the cross-rank histogram codec bit for
  bit the in-process one; ``finalize_global``'s metadata and
  ``pad_rows`` in the JAX layout; GOSS on two and three ranks, and two
  ranks holding two CPU shards each (f32, q16, q8 and the voting
  learner), each byte for byte the single-process mesh of as many
  shards; and the refusals the JAX package makes.
"""
import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_plane_cases as PC

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "verbose": -1, "num_leaves": 15,
          "min_data_in_leaf": 5}
STRUCTURE = ("split_feature", "threshold", "left_child", "right_child",
             "leaf_count", "internal_count", "decision_type")

_WORKER = r"""
import hashlib, sys, time
import numpy as np
coord, nproc, pid, iters = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4])
elastic = sys.argv[5] == "1"
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.parallel import distributed as D
from lightgbm_tpu_torch.parallel import transport as T
from lightgbm_tpu_torch.reliability.faults import FAULTS
P = {"objective": "binary", "verbose": -1, "num_leaves": 15,
     "min_data_in_leaf": 5, "device": "cpu", "collective_transport": "tcp"}
if elastic:
    P.update(transport_epoch_iters=1, sharded_allow_degraded=True)
cfg = Config.from_params(P)
D.initialize(coordinator_address=coord, num_processes=nproc,
             process_id=pid, config=cfg)
tp = T.active()
assert tp is not None and tp.world_size == nproc
assert D._num_processes() == nproc and D._process_index() == pid

def digest(b):
    return hashlib.sha256(b).hexdigest()

if not elastic:
    # tests/test_distributed.py's binning data: 30% zeros
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 6)
    X[rng.rand(2000, 6) < 0.3] = 0.0
    y = (X[:, 0] > 0).astype(float)
    sl = slice(pid * 1000, (pid + 1) * 1000)
    ds = D.construct_sharded(X[sl], label=y[sl], config=cfg)
    print(f"MAPPERS {pid} {digest('|'.join(ds.feature_infos()).encode())} "
          f"{ds.num_data} {ds.num_groups}", flush=True)
rng = np.random.RandomState(0)
N = 1800 if elastic else 2000
X = rng.randn(N, 6)
noise = 0.0 if elastic else 0.2 * rng.randn(N)
y = (X[:, 0] - 0.5 * X[:, 1] + noise > 0).astype(float)
sl = slice(pid * (N // nproc), (pid + 1) * (N // nproc))
ds = D.finalize_global(D.construct_sharded(X[sl], label=y[sl], config=cfg))
assert ds.num_data == N and ds.group_bins.shape[0] == N
g = GBDT(cfg, ds)
if elastic and pid == 2:
    # configure restarts the per-seam counters, so construction rounds
    # do not shift the target
    FAULTS.configure("transport.round:3:kill")
while g.iter_ < iters:
    g.train_one_iter()
g.flush_models()
model = "".join(t.to_string() for t in g.models).encode()
print(f"RANK {pid} {digest(model)} {len(g.models)} "
      f"{digest(np.ascontiguousarray(ds.group_bins).tobytes())} "
      f"{tp.world_size}", flush=True)
"""


_REJOIN_WORKER = r"""
import hashlib, sys, time
import numpy as np
coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cache_dir, iters = sys.argv[4], int(sys.argv[5])
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.parallel import distributed as D
from lightgbm_tpu_torch.parallel import transport as T
from lightgbm_tpu_torch.reliability.faults import FAULTS
P = {"objective": "binary", "verbose": -1, "num_leaves": 15,
     "min_data_in_leaf": 5, "device": "cpu"}
cfg = Config.from_params(dict(P, collective_transport="tcp",
                              transport_epoch_iters=1,
                              sharded_allow_degraded=True))
rng = np.random.RandomState(0)
N = 1800
X = rng.randn(N, 6)
y = (X[:, 0] - 0.5 * X[:, 1] > 0).astype(float)
if pid == 0:
    # the shard cache is the data half of the joiner's handoff
    from lightgbm_tpu_torch.sharded import ShardedDataset, save_shard_cache
    save_shard_cache(ShardedDataset.construct_sharded(
        X, label=y, config=Config.from_params(P), num_shards=nproc),
        cache_dir)
D.initialize(coordinator_address=coord, num_processes=nproc,
             process_id=pid, config=cfg)
tp = T.active()
if pid == 0:
    tp.handoff_meta = {"manifest_dir": cache_dir}
sl = slice(pid * (N // nproc), (pid + 1) * (N // nproc))
ds = D.finalize_global(D.construct_sharded(X[sl], label=y[sl], config=cfg))
g = GBDT(cfg, ds)
if pid == 2:
    FAULTS.configure("transport.round:3:kill")
while g.iter_ < iters:
    g.train_one_iter()      # ticks the epoch boundary
    time.sleep(0.4)         # the joiner's admission window
g.flush_models()
model = "".join(t.to_string() for t in g.models).encode()
print(f"RANK {pid} {hashlib.sha256(model).hexdigest()} {tp.world_size} 0",
      flush=True)
"""

_JOINER = r"""
import hashlib, os, pickle, sys, time
coord, trigger, iters = sys.argv[1], sys.argv[2], int(sys.argv[3])
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.parallel import transport as T
from lightgbm_tpu_torch.sharded import load_shard_cache
cfg = Config.from_params({"objective": "binary", "verbose": -1,
                          "num_leaves": 15, "min_data_in_leaf": 5,
                          "device": "cpu", "collective_transport": "tcp",
                          "transport_epoch_iters": 1,
                          "sharded_allow_degraded": True})
deadline = time.time() + 120
while not os.path.exists(trigger):
    if time.time() > deadline:
        raise SystemExit("the trigger file never appeared")
    time.sleep(0.05)
tp = T.TcpTransport.join(coord, config=cfg)
T.install(tp)
g = GBDT(cfg, load_shard_cache(tp.handoff["meta"]["manifest_dir"],
                               config=cfg))
g.restore_state(pickle.loads(tp.handoff["state"]))
joined_at = g.iter_
while g.iter_ < iters:
    g.train_one_iter()
    time.sleep(0.4)
g.flush_models()
model = "".join(t.to_string() for t in g.models).encode()
print(f"RANK {tp.rank} {hashlib.sha256(model).hexdigest()} "
      f"{tp.world_size} {joined_at}", flush=True)
"""


def _free_coord():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return f"localhost:{port}"


def _launch(nproc, iters, elastic):
    coord = _free_coord()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, coord, str(nproc), str(i),
         str(iters), "1" if elastic else "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for i in range(nproc)]


def _finish(procs, timeout=150):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _lines(outs, tag):
    return {ln.split()[1]: ln.split()[2:] for _, out, _ in outs
            for ln in out.splitlines() if ln.startswith(tag + " ")}


def _data(n, noise):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 6)
    eps = 0.2 * rng.randn(n) if noise else 0.0
    return X, (X[:, 0] - 0.5 * X[:, 1] + eps > 0).astype(float)


def _digest(b):
    return hashlib.sha256(b).hexdigest()


def _port_single(X, y, iters):
    cfg = Config.from_params(dict(PARAMS, device="cpu"))
    ds = tlgb.Dataset(X, label=y).construct(cfg)
    g = GBDT(cfg, ds)
    for _ in range(iters):
        g.train_one_iter()
    g.flush_models()
    return (g.models, _digest(np.ascontiguousarray(ds.group_bins).tobytes()))


@pytest.fixture(scope="module")
def two():
    return _finish(_launch(2, 8, elastic=False))


def test_two_processes_fit_the_single_process_mappers(two):
    for rc, out, err in two:
        assert rc == 0, out + err[-3000:]
    maps = _lines(two, "MAPPERS")
    assert set(maps) == {"0", "1"}
    assert maps["0"] == maps["1"]
    assert maps["0"][1:] == ["1000", maps["0"][2]]
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 6)
    X[rng.rand(2000, 6) < 0.3] = 0.0
    y = (X[:, 0] > 0).astype(float)
    jds = jlgb.Dataset(X, label=y).construct(
        JConfig.from_params({"objective": "binary", "verbose": -1}))
    assert maps["0"][0] == _digest("|".join(jds.feature_infos()).encode())
    assert int(maps["0"][2]) == jds.num_groups


def test_two_processes_train_the_single_process_text(two):
    for rc, out, err in two:
        assert rc == 0, out + err[-3000:]
    ranks = _lines(two, "RANK")
    assert set(ranks) == {"0", "1"}
    assert ranks["0"] == ranks["1"]
    X, y = _data(2000, noise=True)
    models, bins = _port_single(X, y, 8)
    text = "".join(t.to_string() for t in models)
    assert ranks["0"] == [_digest(text.encode()), "8", bins, "2"]
    # the JAX package's single-process run (tests/test_distributed.py
    # _single_process_reference)
    jcfg = JConfig.from_params(dict(PARAMS))
    jg = JGBDT(jcfg, jlgb.Dataset(X, label=y).construct(jcfg))
    for _ in range(8):
        jg.train_one_iter()
    jg.flush_models(final=True)
    assert len(jg.models) == len(models) == 8
    for i, (jt, tt) in enumerate(zip(jg.models, models)):
        for f in STRUCTURE:
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f),
                                          f"tree {i} {f}")
        scale = float(np.abs(jt.leaf_value).max())
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=f"tree {i}")


def test_killed_rank_leaves_survivors_on_the_single_process_text():
    iters = 8
    outs = _finish(_launch(3, iters, elastic=True))
    rc2 = outs[2][0]
    assert rc2 == -9, (rc2, outs[2][2][-2000:])
    for rc, out, err in outs[:2]:
        assert rc == 0, out + err[-3000:]
    ranks = _lines(outs, "RANK")
    assert set(ranks) == {"0", "1"}
    assert ranks["0"] == ranks["1"]
    X, y = _data(1800, noise=False)
    models, bins = _port_single(X, y, iters)
    text = "".join(t.to_string() for t in models)
    # the degraded world of 2 finished the uninterrupted text
    assert ranks["0"] == [_digest(text.encode()), str(iters), bins, "2"]


def test_elastic_rejoin_from_the_shard_cache(tmp_path):
    """Rank 2 dies at its third epoch boundary; the survivors degrade
    to a world of 2; a fresh process joins with rank 3 from the shard
    cache's manifest and the captured state; all three finish the
    uninterrupted single-process text on a world of 3."""
    iters = 10
    coord = _free_coord()
    cache_dir = str(tmp_path / "shards")
    trigger = str(tmp_path / "rank2-dead")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _REJOIN_WORKER, coord, "3", str(i),
         cache_dir, str(iters)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
        for i in range(3)]
    joiner = subprocess.Popen(
        [sys.executable, "-c", _JOINER, coord, trigger, str(iters)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        rc2 = ranks[2].wait(timeout=150)
        assert rc2 == -9, (rc2, ranks[2].communicate()[1][-2000:])
        with open(trigger, "w") as f:
            f.write("go")
        outs = _finish([ranks[0], ranks[1], joiner])
    finally:
        for p in ranks + [joiner]:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, out + err[-3000:]
    lines = _lines(outs, "RANK")
    # the joiner took the fresh rank 3, never the dead rank 2
    assert set(lines) == {"0", "1", "3"}, lines
    X, y = _data(1800, noise=False)
    models, _ = _port_single(X, y, iters)
    text = _digest("".join(t.to_string() for t in models).encode())
    for r, (sha, world, joined_at) in lines.items():
        assert sha == text and world == "3", (r, lines)
    assert int(lines["3"][2]) >= 3


# ---------------------------------------------------------------------------
# the device plane: torch.distributed over gloo
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """A two-process and a three-process world, run side by side: each
    rank's results, by world."""
    out = tmp_path_factory.mktemp("plane")
    two = PC.launch(2, ["bins", "train", "learners", "codec", "meta",
                        "refuse", "goss", "local"], out)
    three = PC.launch(3, ["train", "codec", "goss"], out)
    try:
        r2 = PC.finish(*two)
    finally:
        r3 = PC.finish(*three)
    return {2: r2, 3: r3}


def _port_mesh(world):
    """The port's single-process ``world``-shard CPU mesh on the same
    rows: (text, GBDT, training metric)."""
    X, y = PC.train_data(world)
    cfg = Config.from_params(dict(PC.TRAIN_PARAMS, device="cpu",
                                  mesh_shape=(world,)))
    g = GBDT(cfg, tlgb.Dataset(X, label=y).construct(cfg))
    g.add_train_metrics()
    for _ in range(PC.TREES):
        g.train_one_iter()
    g.flush_models()
    return ("".join(t.to_string() for t in g.models), g,
            [v for *_, v, _b in g.eval_metrics("train")])


def test_plane_ranks_fit_the_jax_sampled_mappers(planes, monkeypatch):
    """Each rank samples BIN_SAMPLE / 2 of its 2,000 rows with seed +
    7919 * rank; the JAX package's construct_sharded, fed the same
    gathered samples, fits the same mappers and bins each rank's rows
    the same, byte for byte."""
    from lightgbm_tpu.parallel import distributed as JD
    X, y = PC.bin_data()
    cfg = JConfig.from_params({"objective": "binary", "verbose": -1,
                               "bin_construct_sample_cnt": PC.BIN_SAMPLE})
    world = 2
    sls = [PC.rank_slice(len(X), world, r) for r in range(world)]
    monkeypatch.setattr(JD, "_num_processes", lambda: world)
    samples = []
    for r, sl in enumerate(sls):
        monkeypatch.setattr(JD, "_process_index", lambda r=r: r)
        samples.append(JD.sample_local_rows(
            X[sl], PC.BIN_SAMPLE // world, cfg.data_random_seed))
    gathered = np.stack(samples)
    monkeypatch.setattr(JD, "_allgather", lambda a: gathered)
    for r, (sl, got) in enumerate(zip(sls, planes[2])):
        monkeypatch.setattr(JD, "_process_index", lambda r=r: r)
        jds = JD.construct_sharded(X[sl], label=y[sl], config=cfg)
        assert got["bins_infos"] == "|".join(jds.feature_infos()), r
        np.testing.assert_array_equal(got["bins"], jds.group_bins)
    # the ranks' samples differ (their seeds do), so the fit is the
    # combined sample's, not one rank's
    assert not np.array_equal(samples[0], samples[1])


@pytest.mark.parametrize("world", [2, 3])
def test_plane_ranks_train_the_single_process_mesh_text(planes, world):
    """Each rank holds only its own rows (its grower's bins: this
    rank's ROWS_PER_RANK rows, no pad), the f32 exchange sums the ranks
    in rank order, and every rank's text is byte for byte the
    single-process ``world``-shard mesh's; the training metric covers
    the global rows."""
    ranks = planes[world]
    text, g, metric = _port_mesh(world)
    for r, got in enumerate(ranks):
        assert got["text"] == text, r
        assert tuple(got["shard_shape"]) == (PC.ROWS_PER_RANK, 28)
        assert int(got["resident"]) * world == g.grower.resident_bin_bytes()
        assert int(got["n_padded"]) == g.grower.n_padded
        assert list(got["train_metric"]) == metric
        assert float(got["straggler"]) >= 1.0


@pytest.mark.parametrize("name", list(PC.LEARNERS))
def test_plane_voting_and_q16_train_the_mesh_text(planes, name):
    """The voting learner (its vote sum and its f32 histogram sum over
    the plane) and the data learner under q16: two ranks' 3-tree texts
    byte for byte the single-process 2-shard mesh's."""
    X, y = PC.train_data(2)
    cfg = Config.from_params(dict(PC.TRAIN_PARAMS, device="cpu",
                                  mesh_shape=(2,), **PC.LEARNERS[name]))
    g = GBDT(cfg, tlgb.Dataset(X, label=y).construct(cfg))
    for _ in range(3):
        g.train_one_iter()
    g.flush_models()
    text = "".join(t.to_string() for t in g.models)
    assert g.grower.is_voting == (name == "voting")
    for r, got in enumerate(planes[2]):
        assert got[f"text_{name}"] == text, r


@pytest.mark.parametrize("world", [2, 3])
def test_plane_goss_trains_the_mesh_text(planes, world):
    """GOSS on the plane (its k-th score from the ranks' gathered top k,
    its rest count summed across the ranks, each rank's block of the
    global uniform draw), sampling from the third tree: every rank's
    text byte for byte the single-process ``world``-shard mesh's."""
    from lightgbm_tpu_torch.boosting import create_boosting
    X, y = PC.train_data(world)
    cfg = Config.from_params(dict(PC.TRAIN_PARAMS, device="cpu",
                                  mesh_shape=(world,), **PC.GOSS_PARAMS))
    g = create_boosting(cfg, tlgb.Dataset(X, label=y).construct(cfg))
    assert g._sample_active() is False
    for _ in range(PC.GOSS_TREES):
        g.train_one_iter()
    assert g._sample_active()
    g.flush_models()
    text = "".join(t.to_string() for t in g.models)
    for r, got in enumerate(planes[world]):
        assert got["goss_class"] == "GOSS"
        assert got["text_goss"] == text, r


@pytest.mark.parametrize("name", list(PC.LOCAL_CASES))
def test_plane_local_shards_train_the_mesh_text(planes, name):
    """Two ranks with LOCAL_SHARDS CPU shards each (``mesh_shape=(4,)``
    on a world of two): each rank holds two shards of half its rows,
    half the 4-shard mesh's resident bins, and its 3-tree text is byte
    for byte the single-process 4-shard mesh's, under the f32, q16 and
    q8 exchanges and the voting learner."""
    X, y = PC.train_data(2)
    n = 2 * PC.LOCAL_SHARDS
    cfg = Config.from_params(dict(PC.TRAIN_PARAMS, device="cpu",
                                  mesh_shape=(n,), **PC.LOCAL_CASES[name]))
    g = GBDT(cfg, tlgb.Dataset(X, label=y).construct(cfg))
    resident = g.grower.resident_bin_bytes()
    for _ in range(3):
        g.train_one_iter()
    g.flush_models()
    text = "".join(t.to_string() for t in g.models)
    assert len(g.grower.shard_bins) == n
    for r, got in enumerate(planes[2]):
        assert int(got[f"local_shards_{name}"]) == PC.LOCAL_SHARDS
        assert int(got[f"local_resident_{name}"]) * 2 == resident, r
        assert got[f"local_text_{name}"] == text, r


def test_plane_text_matches_the_jax_mesh_split_for_split(planes):
    """The ranks' text against the JAX package's 2-device mesh: split
    for split, leaves within 5e-5 of the tree's largest.  On these rows
    the xla plan's known f32 divergence (ROADMAP.md queue 3) reaches
    2.3e-5 of the largest leaf between the two meshes, and 2.1e-5
    between the two packages' serial learners, so 1e-5 does not hold
    here for either pair."""
    X, y = PC.train_data(2)
    jcfg = JConfig.from_params(dict(PC.TRAIN_PARAMS, mesh_shape=(2,)))
    jg = JGBDT(jcfg, jlgb.Dataset(X, label=y).construct(jcfg))
    for _ in range(PC.TREES):
        jg.train_one_iter()
    jg.flush_models(final=True)
    from lightgbm_tpu_torch.tree import Tree
    models = [Tree.from_string("num_leaves=" + b) for b in
              planes[2][0]["text"].split("num_leaves=")[1:]]
    assert len(jg.models) == len(models) == PC.TREES
    for i, (jt, tt) in enumerate(zip(jg.models, models)):
        for f in STRUCTURE:
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f),
                                          f"tree {i} {f}")
        scale = float(np.abs(jt.leaf_value).max())
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                                   atol=5e-5 * scale, err_msg=f"tree {i}")


@pytest.mark.parametrize("mode", ["f32", "q16", "q8"])
def test_plane_codec_bit_for_bit_the_in_process_codec(planes, mode):
    """exchange_histograms_ranks on every rank of the 2- and 3-process
    worlds, at 15 and 64 bins: the bits of the in-process
    exchange_histograms over the ranks' histograms; the wire counter
    the int payload (q16: 2 bytes a value, all-gathered as bytes — no
    int16 tensor reaches gloo)."""
    from lightgbm_tpu_torch.parallel.collectives import exchange_histograms
    width = {"f32": 4, "q16": 2, "q8": 1}[mode]
    for world, ranks in planes.items():
        for bins in PC.CODEC_BINS:
            hs = PC.codec_hists(world, bins)
            want = exchange_histograms([torch.from_numpy(h) for h in hs],
                                       mode=mode).numpy()
            for r, got in enumerate(ranks):
                tag = f"world {world} bins {bins} rank {r}"
                np.testing.assert_array_equal(
                    got[f"codec_{mode}_{bins}"].view(np.uint32),
                    want.view(np.uint32), tag)
                assert int(got[f"wire_{mode}_{bins}"]) == \
                    hs[0].size * width, tag
            assert "int16" not in ranks[0]["handed"]


def test_plane_collectives_equal_the_in_process_collectives(planes):
    """ProcessGroupCollectives on every rank of both worlds: the results
    of the in-process Collectives over the ranks' tensors, bit for bit
    (argmax_sync: the lowest rank of a tie)."""
    from lightgbm_tpu_torch.parallel.collectives import Collectives
    ops = {"sum": "allreduce_sum", "reduce_scatter": "reduce_scatter",
           "all_gather": "all_gather", "min": "global_min",
           "max": "global_max", "mean": "global_mean"}
    for world, ranks in planes.items():
        ins = PC.coll_inputs(world)
        coll = Collectives("data")
        xs = [torch.from_numpy(x) for x, _, _ in ins]
        want = {k: getattr(coll, m)(xs) for k, m in ops.items()}
        want["argmax"] = coll.argmax_sync(
            [torch.tensor(g) for _, g, _ in ins],
            [torch.from_numpy(p) for _, _, p in ins])
        assert want["argmax"][0].tolist() == [10.0, 11.0, 12.0, 13.0]
        for r, got in enumerate(ranks):
            for k, w in want.items():
                np.testing.assert_array_equal(
                    got[f"coll_{k}"].view(np.uint32),
                    w[r].numpy().view(np.uint32), f"{world} {r} {k}")


def test_launcher_env_fills_what_initialize_is_not_given(monkeypatch):
    from lightgbm_tpu_torch.parallel import distributed as D
    for k, v in {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234",
                 "WORLD_SIZE": "4", "RANK": "3"}.items():
        monkeypatch.setenv(k, v)
    assert D._launcher_env(None, None, None) == ("10.0.0.1:1234", 4, 3)
    assert D._launcher_env("h:1", 2, 0) == ("h:1", 2, 0)


def test_plane_metadata_and_padding_in_the_jax_layout(planes,
                                                      monkeypatch):
    """finalize_global's labels, weights and 3-class init score equal
    the JAX package's finalize_global fed the same per-rank metadata;
    pad_rows equals JAX pad_rows; each rank's scores and counts are its
    block of the per-rank-padded layout (JAX place_score_rows)."""
    from types import SimpleNamespace

    from lightgbm_tpu.dataset import Metadata as JMetadata
    from lightgbm_tpu.learner.grower import TreeGrower as JTreeGrower
    from lightgbm_tpu.parallel import distributed as JD
    world = 2
    parts = PC.meta_data(world)
    n_l = len(parts[0][1])
    queue = [np.stack([np.array([n_l])] * world),
             np.stack([p[1].astype(np.float32) for p in parts]),
             np.stack([p[2].astype(np.float32) for p in parts]),
             np.stack([p[3] for p in parts])]
    monkeypatch.setattr(JD, "_num_processes", lambda: world)
    monkeypatch.setattr(JD, "_allgather", lambda a: queue.pop(0))
    md = JMetadata(n_l)
    md.set_label(parts[0][1])
    md.set_weight(parts[0][2])
    md.set_init_score(parts[0][3])
    jds = JD.finalize_global(SimpleNamespace(num_data=n_l, metadata=md))
    assert jds._multihost and jds.num_data == world * n_l
    ph = int(planes[2][0]["per_host"])
    jg = SimpleNamespace(_mh_local=n_l, _mh_per_host=ph, _mh_nproc=world)
    base = jds.metadata.init_score.reshape(3, world * n_l).astype(np.float32)
    for r, got in enumerate(planes[2]):
        np.testing.assert_array_equal(got["md_label"], jds.metadata.label)
        np.testing.assert_array_equal(got["md_weight"], jds.metadata.weight)
        np.testing.assert_array_equal(got["md_init"],
                                      jds.metadata.init_score)
        np.testing.assert_array_equal(
            got["pad_label"], JTreeGrower.pad_rows(jg, jds.metadata.label))
        blk = slice(r * ph, (r + 1) * ph)
        np.testing.assert_array_equal(
            got["scores"], np.stack([JTreeGrower.pad_rows(jg, b)
                                     for b in base])[:, blk])
        np.testing.assert_array_equal(
            got["counts"], JTreeGrower.pad_rows(
                jg, np.ones(world * n_l, np.float32))[blk])


def test_plane_refuses_what_the_jax_package_refuses(planes):
    for got in planes[2]:
        assert got["err_l1"].endswith(
            "multi-host training does not support RenewTreeOutput "
            "objectives (l1/huber/quantile/mape) yet — got regression_l1;"
            " the percentile refit needs a global sort across hosts")
        assert got["err_query"].endswith(
            "multi-host ranking (query groups) is not supported yet — "
            "queries must not span hosts")
        assert got["err_valid"].endswith(
            "multi-host training does not support validation sets yet "
            "(metric scores live sharded across hosts) — evaluate after "
            "training instead")
        assert got["err_serial"].startswith("ValueError: a row-sharded")
        assert got["err_feature"].startswith(
            "NotImplementedError: tree_learner=feature on the device plane")


@pytest.mark.parametrize("mode", ["auto", "xla", "tcp"])
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_resolve_transport_mode_as_the_jax_package(mode, world, device,
                                                   monkeypatch):
    """device=cuda (with NCCL) stands for the JAX package's non-CPU
    backend, device=cpu for its CPU client."""
    import jax

    from lightgbm_tpu.parallel import transport as JT
    from lightgbm_tpu_torch.parallel import transport as T
    if device == "cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.distributed, "is_nccl_available",
                            lambda: True)
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    got = T.resolve_transport_mode(
        Config(collective_transport=mode, device=device), world)
    want = JT.resolve_transport_mode(
        JConfig(collective_transport=mode), world)
    assert got == want
