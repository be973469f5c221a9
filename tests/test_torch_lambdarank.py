"""Lambdarank and the ranking metrics in the port against the JAX package.

* The padded (queries, M) layout, the inverse max DCG at
  ``max_position`` and the label gains equal the JAX objective's.
* Gradients and hessians of the same seeded scores, over ragged queries
  (one-document queries, ties, weights), within 1e-6 of the largest
  |gradient| (|hessian|).  What differs is the order of the pair sums
  (torch's own; XLA's CPU order is ``ops/split.py sum_f32``),
  ``jnp.log2``'s ``log`` in the rank discount and the ``exp`` of the
  pair's sigmoid, which XLA's CPU backend and torch round differently in
  the last bit: with XLA's order and the JAX package's ``log`` and
  ``exp`` substituted the port's lambdas equal the JAX ones bit for bit
  (ROADMAP queue 3).
* ``ndcg@k`` and ``map@k`` equal the JAX metrics (k up to past the
  longest query).
* A few iterations of lambdarank on ``examples/lambdarank`` (3,750 rows
  in 150 queries, held out 1,250 in 50) train the same trees (split
  features, thresholds, child links, counts, the leaf of every row) with
  leaf values within 1e-4 of each tree's largest, the held-out NDCG
  within 1e-6 and predictions within 1e-6.  The example's text files are
  read with ``np.loadtxt`` (label in column 0): the port has no file
  loader yet.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import metrics as JM
from lightgbm_tpu import objectives as JO
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu_torch import metrics as TM
from lightgbm_tpu_torch import objectives as TO
from lightgbm_tpu_torch.dataset import Metadata as TMetadata

EXAMPLE = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                       "lambdarank")
CPU = torch.device("cpu")


def _queries(seed=0, n_queries=60, weighted=False):
    """Ragged queries (1-39 documents), graded labels 0-4, scores with
    ties."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 40, size=n_queries)
    n = int(sizes.sum())
    label = rng.randint(0, 5, size=n).astype(np.float32)
    score = (rng.randn(n) * 2).astype(np.float32)
    score[:12] = 0.5
    score[rng.rand(n) < 0.1] = -1.0
    weight = (rng.rand(n) + 0.5).astype(np.float32) if weighted else None
    return sizes, label, score, weight


def _pair(sizes, label, weight=None, **params):
    n = len(label)
    jm, tm = JMetadata(n), TMetadata(n)
    for m in (jm, tm):
        m.set_label(label)
        m.set_group(sizes)
        m.set_weight(weight)
    p = dict({"objective": "lambdarank"}, **params)
    jo = JO.create_objective(jlgb.Config.from_params(p))
    to = TO.create_objective(tlgb.Config.from_params(dict(p, device="cpu")))
    jo.init(jm, n)
    to.init(tm, n, CPU)
    return jo, to


@pytest.mark.parametrize("params", [{}, {"max_position": 3},
                                    {"label_gain": [0, 1, 3, 7, 20]}])
def test_layout_and_inverse_max_dcg(params):
    sizes, label, _, _ = _queries()
    jo, to = _pair(sizes, label, **params)
    q = len(sizes)
    assert to._q_chunk == jo._q_chunk
    qidx = np.asarray(jo._qidx)
    np.testing.assert_array_equal(
        np.where(to._qmask.numpy(), to._safe_idx.numpy(), -1), qidx)
    assert to._inv_max_dcg.numpy().tobytes() == \
        np.asarray(jo._inv_max_dcg).tobytes()
    assert (to._inv_max_dcg.numpy()[:q] > 0).any()
    np.testing.assert_array_equal(to._label_gain_dev.numpy(),
                                  np.asarray(jo._label_gain_dev))
    np.testing.assert_array_equal(to._qlabel.numpy(), np.asarray(jo._qlabel))


def test_query_chunks_bound_the_pair_tensor():
    """Past 2^25 pair entries a chunk holds fewer queries; the padding
    queries are empty."""
    sizes = np.full(40, 1200)
    label = np.zeros(sizes.sum(), np.float32)
    label[::7] = 2
    jo, to = _pair(sizes, label)
    assert to._q_chunk == jo._q_chunk == (1 << 25) // 1200 ** 2
    assert to._qmask.shape[0] % to._q_chunk == 0
    assert not to._qmask[40:].any()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_gradients(seed, weighted):
    sizes, label, score, weight = _queries(seed, weighted=weighted)
    jo, to = _pair(sizes, label, weight)
    jg, jh = (np.asarray(a) for a in
              jax.jit(jo.get_gradients)(jnp.asarray(score)))
    tg, th = (a.numpy() for a in to.get_gradients(torch.from_numpy(score)))
    assert tg.shape == th.shape == (len(label),)
    np.testing.assert_allclose(tg, jg, rtol=0,
                               atol=1e-6 * np.abs(jg).max())
    np.testing.assert_allclose(th, jh, rtol=0,
                               atol=1e-6 * np.abs(jh).max())
    # a one-document query has no pair: zero gradient and hessian
    start = np.concatenate([[0], np.cumsum(sizes)])
    for q in np.flatnonzero(sizes == 1):
        assert tg[start[q]] == 0 and th[start[q]] == 0


def test_gradients_bit_exact_with_the_jax_transcendentals(monkeypatch):
    """The classification of the difference: with XLA's CPU order of
    the pair sums (``sum_f32``) and XLA's ``log`` (in ``jnp.log2``) and
    ``exp`` in place of torch's, the port's lambdas equal the JAX
    package's bit for bit."""
    from lightgbm_tpu_torch.ops.split import sum_f32
    sizes, label, score, weight = _queries(2, weighted=True)
    jo, to = _pair(sizes, label, weight)
    jg, jh = (np.asarray(a) for a in
              jax.jit(jo.get_gradients)(jnp.asarray(score)))
    j_log2, j_exp = jax.jit(jnp.log2), jax.jit(jnp.exp)

    def via(fn):
        return lambda x: torch.from_numpy(
            np.array(fn(jnp.asarray(x.numpy()))))
    monkeypatch.setattr(TO, "pair_sum", lambda x, dim: sum_f32(
        x.transpose(1, 2) if dim == 1 else x))
    monkeypatch.setattr(TO, "log2_xla", via(j_log2))
    monkeypatch.setattr(torch, "exp", via(j_exp))
    tg, th = (a.numpy() for a in to.get_gradients(torch.from_numpy(score)))
    assert tg.tobytes() == jg.tobytes()
    assert th.tobytes() == jh.tobytes()


def test_needs_query_information():
    from lightgbm_tpu_torch.utils.log import LightGBMError
    n = 50
    meta = TMetadata(n)
    meta.set_label(np.zeros(n))
    obj = TO.create_objective(tlgb.Config.from_params(
        {"objective": "lambdarank", "device": "cpu"}))
    with pytest.raises(LightGBMError, match="query"):
        obj.init(meta, n, CPU)
    for name in ("ndcg", "map"):
        met = TM.create_metrics(tlgb.Config.from_params(
            {"metric": name, "device": "cpu"}))[0]
        with pytest.raises(LightGBMError, match="query"):
            met.init(meta, n, CPU)


@pytest.mark.parametrize("name", ["ndcg", "map", "lambdarank",
                                  "mean_average_precision"])
def test_rank_metrics(name):
    sizes, label, score, _ = _queries(3)
    n = len(label)
    params = {"metric": name, "ndcg_eval_at": [1, 3, 5, 10, 50]}
    jmet = JM.create_metrics(jlgb.Config.from_params(params))[0]
    tmet = TM.create_metrics(tlgb.Config.from_params(
        dict(params, device="cpu")))[0]
    assert type(tmet).__name__ == type(jmet).__name__
    assert tmet.bigger_is_better
    jm, tm = JMetadata(n), TMetadata(n)
    for m in (jm, tm):
        m.set_label(label)
        m.set_group(sizes)
    jmet.init(jm, n)
    tmet.init(tm, n, CPU)
    assert tmet.names() == jmet.names()
    want = jmet.eval(jnp.asarray(score))
    got = tmet.eval(torch.from_numpy(score))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert all(0 < v <= 1 for v in got)


def _example(part):
    d = np.loadtxt(os.path.join(EXAMPLE, f"rank.{part}"), delimiter="\t")
    q = np.loadtxt(os.path.join(EXAMPLE, f"rank.{part}.query"),
                   dtype=np.int64)
    return d[:, 1:], d[:, 0], q


@pytest.fixture(scope="module")
def example_runs():
    X, y, q = _example("train")
    Xt, yt, qt = _example("test")
    params = {"objective": "lambdarank", "metric": "ndcg",
              "ndcg_eval_at": [1, 3, 5], "num_leaves": 31,
              "learning_rate": 0.1, "verbose": -1, "max_bin": 63,
              "quantized_grad": True, "hist_compute_dtype": "bfloat16"}
    out = {"Xt": Xt, "X": X}
    for side, pkg, more in (
            ("jax", jlgb, {"force_pallas_interpret": True,
                           "compile_cache_dir": ""}),
            ("port", tlgb, {"device": "cpu"})):
        ev = {}
        d = pkg.Dataset(X, label=y, group=q)
        v = pkg.Dataset(Xt, label=yt, group=qt, reference=d)
        out[side] = pkg.train(dict(params, **more), d, 4, valid_sets=[v],
                              evals_result=ev, verbose_eval=False,
                              keep_training_booster=True)
        out[side + " evals"] = ev
    return out


def test_example_trains_the_same_trees(example_runs):
    jm, tm = example_runs["jax"].models, example_runs["port"].models
    assert len(jm) == len(tm) == 4
    assert example_runs["port"].gbdt._quant_stochastic()
    for i, (jt, tt) in enumerate(zip(jm, tm)):
        assert jt.num_leaves == tt.num_leaves == 31
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f),
                                          f"tree {i} {f}")
        np.testing.assert_allclose(
            tt.leaf_value, jt.leaf_value, rtol=0,
            atol=1e-4 * np.abs(jt.leaf_value).max())
    for X in (example_runs["X"], example_runs["Xt"]):
        np.testing.assert_array_equal(
            example_runs["port"].predict(X, pred_leaf=True),
            example_runs["jax"].predict(X, pred_leaf=True))


def test_example_metrics_and_predictions(example_runs):
    jv = example_runs["jax evals"]["valid_0"]
    tv = example_runs["port evals"]["valid_0"]
    assert list(tv) == list(jv) == ["ndcg@1", "ndcg@3", "ndcg@5"]
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], rtol=0, atol=1e-6)
    assert tv["ndcg@5"][-1] > tv["ndcg@5"][0]
    Xt = example_runs["Xt"]
    np.testing.assert_allclose(example_runs["port"].predict(Xt),
                               example_runs["jax"].predict(Xt, device=False),
                               rtol=0, atol=1e-6)
    text = example_runs["port"].model_to_string()
    assert "objective=lambdarank" in text.splitlines()
