"""Forced splits (``forcedsplits_filename``) in lightgbm_tpu_torch
against lightgbm_tpu, on the CPU.

* ``gather_split_at_threshold`` and ``forced_split_block`` against the
  JAX functions run op by op, on the same seeded histograms: numerical
  features of each missing type, categorical ones (one-hot at the
  threshold bin, out of range refused), invalid gains and leaves with
  no spec; equal, NaNs in the same places.  Their sums follow XLA's CPU
  reduction order (``ops/split.py sum_f32``), pinned against
  ``jnp.sum`` from one to many windows of 32.
* tests/test_forced_splits.py's three cases through both packages: the
  forced root and its forced left child, a spec on an unused feature
  ignored, and an impossible threshold falling back to the best split.
  The forced nodes are equal in both packages.
* The grower with a forced spec on a categorical root equals the JAX
  grower run op by op: tests/test_torch_categorical.py
  ``test_port_grower_equals_the_jax_tree_op_by_op[forced]``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch.ops import split as TS

CFG = dict(lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
           min_gain_to_split=0.0)


def _hist(L, B, seed):
    rng = np.random.RandomState(seed)
    c = rng.randint(0, 60, size=(L, B)).astype(np.float32)
    c[rng.rand(L, B) < 0.2] = 0
    g = (rng.randn(L, B) * c * 0.3).astype(np.float32)
    h = (c * rng.uniform(0.1, 0.3, size=(L, B))).astype(np.float32)
    hist = np.stack([g, h, c], -1)
    return hist, hist[..., 0].sum(1), hist[..., 1].sum(1), hist[..., 2].sum(1)


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), what)
    np.testing.assert_array_equal(np.where(np.isnan(a), 0, a),
                                  np.where(np.isnan(b), 0, b), what)


@pytest.mark.parametrize("B", [16, 40])
@pytest.mark.parametrize("cfg", [{}, {"lambda_l1": 1.0, "lambda_l2": 2.0,
                                      "max_delta_step": 0.7,
                                      "min_gain_to_split": 5.0}],
                         ids=["plain", "regularized"])
def test_gather_split_at_threshold(B, cfg):
    cfg = dict(CFG, **cfg)
    L = 48
    hist, sg, sh, sc = _hist(L, B, B)
    rng = np.random.RandomState(1)
    thr = rng.randint(0, B, L).astype(np.int32)
    nb = rng.randint(B // 2, B + 1, L).astype(np.int32)
    mt = rng.randint(0, 3, L).astype(np.int32)
    db = rng.randint(0, 5, L).astype(np.int32)
    is_cat = rng.rand(L) < 0.4
    args = (hist, thr, sg, sh, sc, nb, mt, db, is_cat)
    jr = JS.gather_split_at_threshold(*map(jnp.asarray, args), cfg)
    tr = TS.gather_split_at_threshold(*map(torch.from_numpy, args), cfg)
    for i, (a, b) in enumerate(zip(jr, tr)):
        _equal(a, b.numpy(), f"output {i}")
    gain = np.asarray(jr[0])
    assert np.isfinite(gain).any() and np.isinf(gain).any()
    # a categorical threshold past the used bins is refused
    assert np.isinf(gain[is_cat & (thr >= nb - (mt != 0))]).all()


def test_forced_split_block():
    W, F, B = 12, 4, 40
    rng = np.random.RandomState(2)
    hist = np.stack([_hist(W, B, 10 + f)[0] for f in range(F)], 1)
    totals = hist[:, 0].sum(1)
    spec = rng.randint(-1, 3, W).astype(np.int32)
    ff = np.array([2, 0, 3], np.int32)
    ft = np.array([5, 17, 2], np.int32)
    nb = np.array([40, 33, 12, 8], np.int32)
    mt = np.array([2, 0, 1, 0], np.int32)
    db = np.array([0, 3, 1, 0], np.int32)
    is_cat = np.array([False, False, True, True])
    args = (hist, spec, ff, ft, totals[:, 0], totals[:, 1], totals[:, 2],
            nb, mt, db, is_cat)
    jb = JS.forced_split_block(*map(jnp.asarray, args), CFG)
    tb = TS.forced_split_block(*map(torch.from_numpy, args), CFG)
    _equal(jb, tb.numpy(), "block")
    assert np.isinf(np.asarray(jb)[spec < 0, TS.FORCED_GAIN]).all()
    assert np.isfinite(np.asarray(jb)[spec >= 0, TS.FORCED_GAIN]).any()


def test_sums_follow_the_xla_cpu_order():
    """``sum_f32`` adds in the order ``jnp.sum`` takes on XLA's CPU
    backend (windows of 32, padded evenly at both ends), bit for bit on
    values spanning six decades, at every length to 40 and at lengths
    around one, two, three and many windows."""
    rng = np.random.RandomState(0)
    for n in list(range(1, 41)) + [63, 64, 65, 96, 97, 100, 127, 128,
                                   129, 255, 256, 300, 1025]:
        x = (rng.randn(8, n) * 10 ** rng.uniform(-3, 3, (8, n))
             ).astype(np.float32)
        want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(
            jnp.asarray(x)))
        np.testing.assert_array_equal(TS.sum_f32(torch.from_numpy(x)).numpy(),
                                      want, f"length {n}")


# ---------------------------------------------------------------------------
# tests/test_forced_splits.py's cases through both packages
# ---------------------------------------------------------------------------
def _make_data(n=600, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3)
    # feature 1 is by far the best split; feature 0 is weak
    y = (X[:, 1] > 0).astype(float) * 2.0 + 0.1 * (X[:, 0] > 0.5)
    return X, y


PARAMS = {"objective": "regression", "num_leaves": 8, "min_data_in_leaf": 5,
          "verbose": -1}
PLANS = {"xla": {}, "fused_tiled": {"quantized_grad": True,
                                     "hist_compute_dtype": "bfloat16"}}


def _train_both(X, y, spec, tmp_path, plan, rounds):
    fn = None
    if spec is not None:
        fn = str(tmp_path / "forced.json")
        with open(fn, "w") as f:
            json.dump(spec, f)
    params = dict(PARAMS, **PLANS[plan])
    if fn:
        params["forcedsplits_filename"] = fn
    jb = jlgb.train(dict(params, force_pallas_interpret=True),
                    jlgb.Dataset(X, label=y), rounds)
    tb = tlgb.train(dict(params, device="cpu"), tlgb.Dataset(X, label=y),
                    rounds, verbose_eval=False, keep_training_booster=True)
    assert tb.gbdt.grower.plan.name == plan
    return (jb.dump_model()["tree_info"], tb.dump_model()["tree_info"],
            jb, tb)


def _node(tree, *path):
    node = tree["tree_structure"]
    for step in path:
        node = node[step]
    return node


@pytest.mark.parametrize("plan", list(PLANS))
def test_forced_root_split(tmp_path, plan):
    X, y = _make_data()
    spec = {"feature": 0, "threshold": 0.5,
            "left": {"feature": 2, "threshold": -0.25}}
    jt, tt, jb, tb = _train_both(X, y, spec, tmp_path, plan, 3)
    for trees in (jt, tt):
        for tree in trees:
            root = _node(tree)
            assert root["split_feature"] == 0
            assert abs(root["threshold"] - 0.5) < 0.3
            left = _node(tree, "left_child")
            assert left["split_feature"] == 2
            assert abs(left["threshold"] - (-0.25)) < 0.3
    for j, t in zip(jt, tt):
        for path in ((), ("left_child",)):
            for key in ("split_feature", "threshold", "internal_count"):
                assert _node(j, *path)[key] == _node(t, *path)[key]
    # without forcing, the root split would be feature 1
    jt0, tt0, _, _ = _train_both(X, y, None, tmp_path, plan, 1)
    assert _node(jt0[0])["split_feature"] == 1
    assert _node(tt0[0])["split_feature"] == 1
    pred = tb.predict(X)
    assert np.mean((pred - y) ** 2) < np.var(y)


@pytest.mark.parametrize("plan", list(PLANS))
def test_forced_split_unused_feature_ignored(tmp_path, plan):
    X, y = _make_data()
    X[:, 2] = 7.0      # constant -> dropped from training
    jt, tt, _, tb = _train_both(X, y, {"feature": 2, "threshold": 1.0},
                                tmp_path, plan, 2)
    assert tb.gbdt.grower.forced_count == 0
    assert _node(jt[0])["split_feature"] == _node(tt[0])["split_feature"] == 1


@pytest.mark.parametrize("plan", list(PLANS))
def test_forced_split_bad_gain_falls_back(tmp_path, plan):
    X, y = _make_data()
    # threshold far outside the data range -> empty side, gain invalid
    jt, tt, _, tb = _train_both(X, y, {"feature": 0, "threshold": 1e9},
                                tmp_path, plan, 2)
    assert tb.gbdt.grower.forced_count == 1
    for j, t in zip(jt, tt):
        assert _node(j)["split_feature"] == _node(t)["split_feature"] == 1
        assert _node(j)["threshold"] == _node(t)["threshold"]
