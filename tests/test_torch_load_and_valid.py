"""Loading a model of any objective, and validation-set alignment, in the
port against the JAX package.

* A model trained by ``lightgbm_tpu`` and loaded from its text by both
  packages' ``Booster(model_str=...)`` predicts the same outputs: the
  port's output transform (booster.py ``_convert_output``) follows the
  reference's table for every objective string in it (softmax,
  sigmoid with its ``sigmoid:`` parameter, exp, the inverse of ``sqrt``
  regression, the cross-entropy links) and returns the raw score for
  the identity objectives.  Both sides evaluate the same trees in f64
  on the host and the port's level descent in f32, so outputs agree
  within 1e-6 relative.
* A validation set constructed under another ``bin_packing`` than the
  training set is refused ("storage layout"): its groups are packed and
  ordered differently, and the port scores validation rows with the
  training set's group map.  A ``reference=``-aligned set trains.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.utils.log import LightGBMError

#: objective params -> the label the objective needs
OBJECTIVES = {
    "binary": ({"objective": "binary", "sigmoid": 0.7}, "binary"),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, "class"),
    "multiclassova": ({"objective": "multiclassova", "num_class": 3,
                       "sigmoid": 1.3}, "class"),
    "poisson": ({"objective": "poisson"}, "count"),
    "gamma": ({"objective": "gamma"}, "positive"),
    "tweedie": ({"objective": "tweedie"}, "count"),
    "regression sqrt": ({"objective": "regression", "reg_sqrt": True},
                        "real"),
    "cross_entropy": ({"objective": "cross_entropy"}, "unit"),
    "cross_entropy_lambda": ({"objective": "cross_entropy_lambda"}, "unit"),
    "regression": ({"objective": "regression"}, "real"),
    "huber": ({"objective": "huber"}, "real"),
}


def _data(kind, n=600, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    z = X[:, 0] - 0.5 * X[:, 1] + 0.3 * rng.randn(n)
    y = {"binary": (z > 0).astype(float),
         "class": np.digitize(z, [-0.5, 0.5]).astype(float),
         "count": rng.poisson(np.exp(0.5 * z)).astype(float),
         "positive": np.exp(0.5 * z) + 0.1,
         "real": 3.0 * z,
         "unit": 1.0 / (1.0 + np.exp(-2.0 * z))}[kind]
    return X, y


@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_loaded_model_output_matches_reference(objective):
    params, kind = OBJECTIVES[objective]
    X, y = _data(kind)
    jb = jlgb.train(dict(params, num_leaves=7, min_data_in_leaf=5,
                         verbose=-1, compile_cache_dir=""),
                    jlgb.Dataset(X, label=y), 3, verbose_eval=False)
    text = jb.model_to_string()
    ref = jlgb.Booster(model_str=text)
    port = tlgb.Booster(model_str=text, params={"device": "cpu"})
    assert port.objective_str == ref.objective_str
    want, got = ref.predict(X), port.predict(X)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    # the transform was applied where the table has one
    raw = port.predict(X, raw_score=True)
    transformed = objective not in ("regression", "huber")
    assert (not np.allclose(got, raw)) == transformed


def _compact_data(n=900, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0.8).astype(np.float64)
    return X, y


def _compact_params(**kw):
    p = {"objective": "binary", "max_bin": 15, "num_iterations": 3,
         "num_leaves": 6, "min_data_in_leaf": 5, "verbose": -1,
         "device": "cpu"}
    p.update(kw)
    return p


def test_valid_set_layout_mismatch_refused():
    X, y = _compact_data()
    p4 = _compact_params(bin_packing="4bit")
    v8 = tlgb.Dataset(X, label=y,
                      params=_compact_params(bin_packing="8bit")).construct()
    with pytest.raises(LightGBMError, match="storage layout"):
        tlgb.train(p4, tlgb.Dataset(X, label=y), valid_sets=[v8],
                   verbose_eval=False)
    # reference-aligned valid sets share the layout and train fine
    d4 = tlgb.Dataset(X, label=y)
    evals = {}
    tlgb.train(dict(p4, metric=["binary_logloss"]), d4,
               valid_sets=[tlgb.Dataset(X, label=y, reference=d4)],
               valid_names=["v"], evals_result=evals, verbose_eval=False)
    assert len(evals["v"]["binary_logloss"]) == 3


def test_random_forest_model_averages_its_iterations():
    """A ``boosting=rf`` model carries ``average_output``: its raw score
    is the iterations' mean and its leaves are already in output space,
    so no sigmoid follows (lightgbm_tpu/booster.py
    _add_init_and_average)."""
    X, y = _data("binary")
    jb = jlgb.train({"objective": "binary", "boosting": "rf",
                     "bagging_freq": 1, "bagging_fraction": 0.7,
                     "feature_fraction": 0.8,
                     "num_leaves": 7, "min_data_in_leaf": 5, "verbose": -1,
                     "compile_cache_dir": ""},
                    jlgb.Dataset(X, label=y), 5, verbose_eval=False)
    text = jb.model_to_string()
    assert "\naverage_output\n" in text
    ref = jlgb.Booster(model_str=text)
    port = tlgb.Booster(model_str=text, params={"device": "cpu"})
    for raw in (False, True):
        want = ref.predict(X, raw_score=raw, device=False)
        got = port.predict(X, raw_score=raw)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the mean is over the iterations used, best_iteration included
    np.testing.assert_allclose(port.predict(X, num_iteration=2),
                               ref.predict(X, num_iteration=2, device=False),
                               rtol=0, atol=1e-6)
    assert 0.0 < port.predict(X).min() and port.predict(X).max() < 1.0


def _sparse_model(width):
    """A 5-tree binary model on a wide, mostly-zero matrix: it splits on
    a few of ``width`` columns."""
    import scipy.sparse as sp
    rng = np.random.RandomState(11)
    n = 800
    X = np.where(rng.rand(n, width) < 0.15, rng.randn(n, width), 0.0)
    X[:, 2] = rng.randn(n)
    X[:, 5] = np.where(rng.rand(n) < 0.5, rng.randn(n), 0.0)
    X[:, 0] = rng.randn(n)
    y = (X[:, 0] + X[:, 2] + X[:, 5] + 0.3 * rng.randn(n) > 0).astype(float)
    jb = jlgb.train({"objective": "binary", "num_leaves": 5,
                     "min_data_in_leaf": 20, "verbose": -1,
                     "compile_cache_dir": ""},
                    jlgb.Dataset(X, label=y), 5, verbose_eval=False)
    return jb, sp.csr_matrix(X), X


@pytest.mark.parametrize("width", [40, 6])
def test_sparse_matrix_predicts_as_the_reference(width):
    """CSR input is densified in row chunks, narrowed to the columns the
    used trees split on when that is under half the width (40 columns),
    else whole (6); both routes give the JAX package's sparse
    predictions and the port's own dense ones, ``pred_leaf`` too."""
    jb, csr, X = _sparse_model(width)
    text = jb.model_to_string()
    ref = jlgb.Booster(model_str=text)
    port = tlgb.Booster(model_str=text, params={"device": "cpu"})
    used = np.unique(np.concatenate([t.split_feature for t in port.models]))
    assert (used.size * 2 < width) == (width == 40)
    for kw in ({}, {"raw_score": True}, {"num_iteration": 3}):
        want = ref.predict(csr, **kw)
        np.testing.assert_allclose(port.predict(csr, **kw), want,
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(port.predict(csr, **kw),
                                      port.predict(X, **kw))
    np.testing.assert_array_equal(port.predict(csr, pred_leaf=True),
                                  ref.predict(csr, pred_leaf=True))
    np.testing.assert_array_equal(port.predict(csr.tocsc(), pred_leaf=True),
                                  port.predict(X, pred_leaf=True))
