"""k-fold cross-validation in the port against the JAX package: the
folds index for index, the ``<metric>-mean``/``<metric>-stdv`` lists and
the ``CVBooster`` of the folds' boosters.

The folds come from ``np.random.RandomState(seed)`` in both packages
(stratified by label for binary).  Each fold is binned anew from the raw
rows and trained on tests/test_torch_train.py's main path (the JAX side
in Pallas interpret mode, the port on its kernels' plain versions) for
two rounds.  A fold's 2,667 rows give the JAX package's compiled tree
program FMAs from the first tree on (ROADMAP queue 3), so the folds'
trees are held with tests/test_torch_objectives_train.py's tolerance:
structure equal, leaves within 1e-5 of the tree's largest.  The
log-loss lists agree within 1e-6; the AUC lists within 1e-5, since two
held-out scores that close the order of a pair of a fold's 1,333 rows
move its AUC by 2.3e-6 a pair.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu.engine as jengine
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.engine as tengine
import torch_front_door_cases as C

ROUNDS = 2


@pytest.mark.parametrize("objective,shuffle", [
    ("binary", True), ("binary", False), ("regression", True),
    ("regression", False)])
def test_folds_index_for_index(monkeypatch, objective, shuffle):
    """The rows each fold trains and holds out (stratified for binary),
    read from the datasets cv builds; the rows carry their index as a
    feature and training is replaced by a recorder."""
    X, y = C.train_rows()
    ids = np.arange(len(y), dtype=np.float64)[:, None]
    folds = {}
    for name, pkg, mod, extra in (("jax", jlgb, jengine, C.JAX),
                                  ("port", tlgb, tengine, C.PORT)):
        seen = []

        def record(params, dtrain, num_boost_round, valid_sets=None,
                   **kw):
            seen.append((dtrain._raw_data[:, 0],
                         valid_sets[0]._raw_data[:, 0]))
            return object()

        monkeypatch.setattr(mod, "train", record)
        pkg.cv(dict(C.PARAMS, objective=objective, **extra),
               pkg.Dataset(np.hstack([ids, X]), label=y), ROUNDS, nfold=3,
               shuffle=shuffle, seed=11)
        folds[name] = seen
    assert len(folds["port"]) == 3
    for (jtr, jte), (ttr, tte) in zip(folds["jax"], folds["port"]):
        np.testing.assert_array_equal(ttr, jtr)
        np.testing.assert_array_equal(tte, jte)
        assert len(np.intersect1d(ttr, tte)) == 0
        assert len(ttr) + len(tte) == len(y)


@pytest.fixture(scope="module")
def cv_runs():
    X, y = C.train_rows()
    out = {}
    for name, pkg, extra in (("jax", jlgb, C.JAX), ("port", tlgb, C.PORT)):
        out[name] = pkg.cv(dict(C.PARAMS, **extra), pkg.Dataset(X, label=y),
                           ROUNDS, nfold=3, seed=3, return_cvbooster=True)
    return out


def test_cv_mean_and_stdv(cv_runs):
    j, t = cv_runs["jax"], cv_runs["port"]
    assert sorted(t) == sorted(j) == sorted(
        ["auc-mean", "auc-stdv", "binary_logloss-mean",
         "binary_logloss-stdv", "cvbooster"])
    for key in ("binary_logloss-mean", "binary_logloss-stdv"):
        assert len(t[key]) == ROUNDS
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-6)
    for key in ("auc-mean", "auc-stdv"):
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-5)


def test_cvbooster(cv_runs):
    jb, tb = cv_runs["jax"]["cvbooster"], cv_runs["port"]["cvbooster"]
    assert len(tb.boosters) == 3 and tb.best_iteration == -1
    for jf, tf in zip(jb.boosters, tb.boosters):
        C.assert_same_trees(jf.models, tf.models, of_largest=True)
        assert tf.gbdt is not None            # the folds stay trainable
    Xv, _, _ = C.valid_rows()
    got = tb.predict(Xv)
    want = jb.predict(Xv, device=False)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert tb.num_trees() == [ROUNDS] * 3
