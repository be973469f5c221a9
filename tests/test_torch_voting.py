"""The voting learner on a CPU mesh (the grower's full-frontier voting
rounds) against the JAX package's mesh run with the same ``mesh_shape``,
on tests/test_parallel.py:88's 40-feature rows with ``top_k=5``.

It is held split for split on regression_l1, whose integral histograms
make every local gain the JAX package's bits.  On binary the local
gains are not: the JAX finder runs compiled, and XLA's fused f32
arithmetic gives gains that differ from the port's op-by-op torch ones
in the last bits (the sigmoid's ``exp`` moves the gradients too, from
the second tree).  A vote is a gain compared with the leaf's top_k-th,
and small leaves tie there within a few ulps, so a vote flips and the
trees part after a few trees (scripts/torch_vote_edge.py finds the
first flip; the leaf totals and the local histograms are not the
cause).  So on binary the first tree is held split for split and the
run's logloss within 1e-2, and every round of all ten trees is held
to the JAX package's voting rule applied to the port's own local
gains: the features it exchanges and the histograms it ships.  A
voting round's exchange is pinned from the port's counters, and forced
splits are ignored with the JAX package's warning.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.learner.grower import TreeGrower
from torch_parallel_cases import data as _data
from torch_parallel_cases import one_torch_thread  # noqa: F401
from torch_parallel_cases import params as _params
from torch_parallel_cases import structure_and_leaves as _structure_and_leaves
from torch_parallel_cases import train as _train


def _vote_data():
    """tests/test_parallel.py:88's 40-feature rows."""
    return _data(1200, 40, seed=3)


@pytest.fixture(scope="module")
def binary_runs():
    """The port's 10-tree binary voting run on the vote rows, once a
    shard count for the module's tests: ``run(shards)`` gives (booster,
    last training logloss, its voting rounds).  A round is (each shard's
    (feature histograms, local gains) from the split finders, the parts
    handed to ``exchange_histograms``), recorded by spies that only
    record."""
    from lightgbm_tpu_torch.learner import grower as TG
    from lightgbm_tpu_torch.parallel import collectives as TC
    runs = {}

    def run(shards):
        if shards in runs:
            return runs[shards]
        local, rounds = [], []
        run_finders, exchange = TG.run_split_finders, TC.exchange_histograms

        def spy_finders(feat_hist, *a):
            res, gains = run_finders(feat_hist, *a)
            local.append((feat_hist, gains))
            return res, gains

        def spy_exchange(parts, *a, **k):
            rounds.append((list(local), list(parts)))
            local.clear()
            return exchange(parts, *a, **k)

        X, y = _vote_data()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TG, "run_split_finders", spy_finders)
            mp.setattr(TC, "exchange_histograms", spy_exchange)
            bst, ll = _train(tlgb, X, y, _params(
                "voting", device="cpu", top_k=5, mesh_shape=(shards,),
                mesh_axes=("data",)))
        runs[shards] = (bst, ll, rounds)
        return runs[shards]
    return run


@pytest.mark.parametrize("shards", [2, 4])
def test_voting_learner_against_the_jax_mesh(shards, binary_runs):
    X, yb = _vote_data()
    y = X[:, 0] * 2 - X[:, 1] + 0.3 * np.random.RandomState(1).randn(
        X.shape[0])
    p = {"objective": "regression_l1", "num_leaves": 15, "verbose": -1,
         "tree_learner": "voting", "top_k": 5, "mesh_shape": (shards,),
         "mesh_axes": ("data",), "metric": "l1"}
    jb = jlgb.train(p, jlgb.Dataset(X, label=y), 10)
    bst = tlgb.train(dict(p, device="cpu"), tlgb.Dataset(X, label=y), 10,
                     keep_training_booster=True)
    g = bst.gbdt.grower
    assert g.is_voting and g.sharded and len(g.shard_bins) == shards
    _structure_and_leaves(jb.models, bst.models, 10)
    # binary on the same rows: the first tree split for split, the run
    # within 1e-2 of the JAX logloss (see the module docstring)
    pb = _params("voting", top_k=5, mesh_shape=(shards,),
                 mesh_axes=("data",))
    bst, ll, _ = binary_runs(shards)
    jb, jll = _train(jlgb, X, yb, pb)
    _structure_and_leaves(jb.models[:1], bst.models[:1], 1)
    assert ll < 0.4 and abs(ll - jll) < 1e-2


@pytest.mark.parametrize("shards", [2, 4])
def test_voting_selection_follows_the_jax_rule_every_round(shards,
                                                           binary_runs):
    """Every voting round of ten binary trees: the features whose
    histograms the port exchanges are those the JAX package's voting
    lines (grower.py:1706-1716: ``lax.top_k``'s k-th local gain, the
    votes, their psum, ``lax.top_k`` of the vote totals) select from
    the port's own local gains, and each shard ships exactly its local
    histograms of them, in that order."""
    import jax
    import jax.numpy as jnp
    top_k = 5
    _, _, rounds = binary_runs(shards)
    assert len(rounds) >= 30
    for i, (shard_local, parts) in enumerate(rounds):
        assert len(shard_local) == len(parts) == shards, i
        votes = []
        for _, gains in shard_local:
            g = jnp.asarray(gains.numpy())
            kth = jax.lax.top_k(g, top_k)[0][:, -1:]
            votes.append(((g >= kth) & jnp.isfinite(g)).astype(jnp.float32))
        total = sum(votes[1:], votes[0]).sum(axis=0)
        sel = np.array(jax.lax.top_k(total, 2 * top_k)[1])
        for s, ((feat_hist, _), part) in enumerate(zip(shard_local, parts)):
            assert torch.equal(part, feat_hist[:, torch.from_numpy(sel)]), \
                (i, s)


def test_voting_round_ships_the_compact_histograms():
    """The volume pin of tests/test_parallel.py:74-121, read from the
    port's counters: every voting round sums (L, 2 top_k, B, 3) f32
    histograms and (L, F) f32 votes across the shards, never the full
    (L, F, B, 3) histograms."""
    from lightgbm_tpu_torch.telemetry import TELEMETRY
    X, y = _vote_data()
    top_k = 5
    cfg = Config.from_params(_params("voting", device="cpu", top_k=top_k,
                                     mesh_shape=(2,)))
    core = tlgb.Dataset(X, label=y).construct(cfg)
    g = TreeGrower(core, cfg, torch.device("cpu"))
    L, F, B = g.num_leaves, g.num_features, g.max_feature_bin
    assert F == 40
    n = g.n_padded
    grad = torch.from_numpy(g.pad_rows(0.5 - y.astype(np.float32)))
    hess = torch.from_numpy(g.pad_rows(np.full(len(y), 0.25, np.float32)))
    cnt = torch.from_numpy(g.pad_rows(np.ones(len(y), np.float32)))
    TELEMETRY.configure("counters")
    TELEMETRY.reset()
    try:
        tree, leaf_id, _ = g.train_tree(grad, hess, cnt,
                                        torch.ones(F, dtype=torch.bool))
        c = TELEMETRY.counters()
    finally:
        TELEMETRY.configure("off")
        TELEMETRY.reset()
    assert tree["num_leaves"] > 1 and leaf_id.shape == (n,)
    calls = c["collective_hist_exchange_calls"]
    assert calls > 0 and calls % 2 == 0
    assert c["collective_hist_exchange_bytes"] == calls * L * 2 * top_k \
        * B * 3 * 4
    assert c["collective_allreduce_calls"] == calls
    assert c["collective_allreduce_bytes"] == calls * L * F * 4
    assert "collective_hist_exchange_scale_bytes" not in c


def test_forced_splits_are_ignored_under_voting(tmp_path, capsys):
    import json
    spec = tmp_path / "forced.json"
    spec.write_text(json.dumps({"feature": 1, "threshold": 0.0}))
    X, y = _data(300, 4)
    bst, _ = _train(tlgb, X, y, _params(
        "voting", device="cpu", verbose=0, mesh_shape=(2,),
        forcedsplits_filename=str(spec)), rounds=1)
    assert bst.gbdt.grower.is_voting and bst.gbdt.grower.forced_count == 0
    cap = capsys.readouterr()
    assert "forced splits are not supported with tree_learner=voting" \
        in cap.out + cap.err
