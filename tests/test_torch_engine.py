"""The training front door of the port against the JAX package:
early stopping (by parameter, by argument and by callback, with
``first_metric_only``), ``evals_result``, ``best_iteration`` and predict
at the default ``num_iteration``, the ``record_evaluation`` and
``print_evaluation`` callbacks, ``learning_rates`` as a list and as a
callable and the ``reset_parameter`` callback, and ``feval`` rows.

Both packages train tests/test_torch_train.py's main path (the JAX side
in Pallas interpret mode, the port on its kernels' plain versions) with
two validation sets: the held-out labels, and labels drawn from a seed
independently of X, on which the validation metrics get worse and early
stopping fires.  Trees are held with tests/test_torch_train.py's
tolerances, metric values within 1e-5, predictions within 1e-6.

After an iteration that grew no tree the port stops at once; the JAX
package finds such an iteration later and keeps evaluating the same
model until then (ROADMAP queue 3).  test_no_split_tail pins what
differs.
"""
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import torch_front_door_cases as C

#: a few rounds: the two packages' f32 gradients differ in the last bit
#: from the second tree on (ROADMAP queue 3), and the leaves' noise grows
#: with each tree past tests/test_torch_train.py's 1e-5 after five
ROUNDS = 4
LRS = [0.1, 0.08, 0.06, 0.05]


def _train(pkg, extra, rounds=ROUNDS, callbacks=(), n_valid=2, **kw):
    params = dict(C.PARAMS, **extra, **kw.pop("params", {}))
    d, valid = C.datasets(pkg)
    ev = {}
    bst = pkg.train(params, d, rounds, valid_sets=valid[:n_valid],
                    evals_result=ev,
                    verbose_eval=False, callbacks=list(callbacks), **kw)
    return bst, ev


@pytest.fixture(scope="module")
def by_param():
    """Early stopping by parameter, with a feval and the record and
    print callbacks (verbose on, the printed lines caught)."""
    out = {}
    for name, pkg, extra, log in (("jax", jlgb, C.JAX,
                                   "lightgbm_tpu.utils.log"),
                                  ("port", tlgb, C.PORT,
                                   "lightgbm_tpu_torch.utils.log")):
        import importlib
        logmod = importlib.import_module(log)
        lines = []
        logmod.set_sink(lambda tag, msg: lines.append(msg))
        rec = {}
        try:
            bst, ev = _train(
                pkg, extra, feval=C.error_rate,
                params={"early_stopping_round": 2, "verbose": 1},
                callbacks=[pkg.record_evaluation(rec),
                           pkg.print_evaluation(1)])
        finally:
            logmod.set_sink(None)
        out[name] = dict(bst=bst, ev=ev, rec=rec,
                         printed=[m for m in lines if m.startswith("[")])
    return out


def test_early_stopping_by_param(by_param):
    j, t = by_param["jax"], by_param["port"]
    assert 1 <= t["bst"].best_iteration < ROUNDS - 1
    assert t["bst"].best_iteration == j["bst"].best_iteration
    trained = len(t["ev"]["valid_0"]["auc"])
    assert t["bst"].num_trees() == trained < ROUNDS
    C.assert_same_evals(j["ev"], t["ev"])
    C.assert_same_trees(j["bst"].models, t["bst"].models)


def test_feval_rows(by_param):
    j, t = by_param["jax"], by_param["port"]
    assert list(t["ev"]) == ["valid_0", "valid_1", "feval"]
    np.testing.assert_allclose(t["ev"]["feval"]["error"],
                               j["ev"]["feval"]["error"], rtol=0, atol=1e-12)


def test_predict_at_best_iteration(by_param):
    j, t = by_param["jax"], by_param["port"]
    Xv, _, _ = C.valid_rows()
    tb = t["bst"]
    np.testing.assert_array_equal(
        tb.predict(Xv), tb.predict(Xv, num_iteration=tb.best_iteration))
    assert not np.array_equal(tb.predict(Xv), tb.predict(Xv,
                                                         num_iteration=99))
    np.testing.assert_allclose(tb.predict(Xv),
                               j["bst"].predict(Xv, device=False),
                               rtol=0, atol=1e-6)


def test_record_and_print_evaluation(by_param):
    for side in ("jax", "port"):
        s = by_param[side]
        assert s["rec"] == s["ev"]
    t = by_param["port"]
    n = len(t["ev"]["valid_0"]["auc"])
    assert len(t["printed"]) == len(by_param["jax"]["printed"]) == n
    rows = [(d, m) for d in t["ev"] for m in t["ev"][d]]
    for i, line in enumerate(t["printed"]):
        assert line == f"[{i + 1}]\t" + "\t".join(
            f"{d}'s {m}: {t['ev'][d][m][i]:g}" for d, m in rows)


@pytest.mark.parametrize("how", ["argument", "callback"])
def test_early_stopping_by_argument_and_callback(by_param, how):
    """The argument sets the parameter; the callback stops on the same
    rows, so both stop where the parameter does."""
    j = by_param["jax"]
    if how == "argument":
        bst, ev = _train(tlgb, C.PORT, feval=C.error_rate,
                         early_stopping_rounds=2)
    else:
        bst, ev = _train(tlgb, C.PORT, feval=C.error_rate,
                         callbacks=[tlgb.early_stopping(2, verbose=False)])
    assert bst.best_iteration == j["bst"].best_iteration
    C.assert_same_evals(j["ev"], ev)
    C.assert_same_trees(j["bst"].models, bst.models)


@pytest.fixture(scope="module")
def jax_first_metric_only():
    """The JAX package stopping by callback on the first metric only,
    with a learning rate a round."""
    return _train(jlgb, C.JAX, learning_rates=LRS, callbacks=[
        jlgb.early_stopping(2, first_metric_only=True, verbose=False)])


def test_first_metric_only(by_param, jax_first_metric_only):
    """Only valid_0's AUC (held-out labels, improving) can stop the
    run: it trains every round, where the worsening valid_1 stops the
    other runs."""
    jb, jev = jax_first_metric_only
    bst, ev = _train(tlgb, C.PORT, learning_rates=LRS, callbacks=[
        tlgb.early_stopping(2, first_metric_only=True, verbose=False)])
    assert bst.best_iteration == jb.best_iteration == -1
    assert bst.num_trees() == ROUNDS > by_param["port"]["bst"].num_trees()
    C.assert_same_evals(jev, ev)
    C.assert_same_trees(jb.models, bst.models)


@pytest.mark.parametrize("schedule", ["list", "callable", "callback"])
def test_learning_rate_schedules(jax_first_metric_only, schedule):
    """A learning rate a round, as a list, a callable or a
    reset_parameter callback: each tree carries its own shrinkage."""
    jb, jev = jax_first_metric_only
    stop = tlgb.early_stopping(2, first_metric_only=True, verbose=False)
    if schedule == "list":
        bst, ev = _train(tlgb, C.PORT, learning_rates=LRS, callbacks=[stop])
    elif schedule == "callable":
        bst, ev = _train(tlgb, C.PORT, learning_rates=lambda i: LRS[i],
                         callbacks=[stop])
    else:
        bst, ev = _train(tlgb, C.PORT, callbacks=[
            tlgb.reset_parameter(learning_rate=LRS), stop])
    assert [t.shrinkage for t in bst.models] == pytest.approx(LRS)
    C.assert_same_evals(jev, ev)
    C.assert_same_trees(jb.models, bst.models)


def test_no_split_tail():
    """Trees stop splitting after three iterations (learning rate 1,
    min_sum_hessian_in_leaf 300; the held-out labels only).  Both
    packages keep the same three trees.  The port stops at once, with
    three evaluation rows and no best iteration; the JAX package keeps
    evaluating the same model until its deferred check, repeating the
    third row, and its early stopping fires on those repeats."""
    extra = {"learning_rate": 1.0, "min_sum_hessian_in_leaf": 300.0,
             "early_stopping_round": 2}
    jb, jev = _train(jlgb, C.JAX, rounds=8, n_valid=1, params=extra)
    tb, tev = _train(tlgb, C.PORT, rounds=8, n_valid=1, params=extra)
    C.assert_same_trees(jb.models, tb.models)
    assert tb.num_trees() == 3
    for d in tev:
        for m in tev[d]:
            assert len(tev[d][m]) == 3
            np.testing.assert_allclose(tev[d][m], jev[d][m][:3], rtol=1e-5)
            assert jev[d][m][3:] == [jev[d][m][2]] * (len(jev[d][m]) - 3)
    assert tb.best_iteration == -1
    assert jb.best_iteration == 3 and len(jev["valid_0"]["auc"]) == 5
    Xv, _, _ = C.valid_rows()
    np.testing.assert_allclose(tb.predict(Xv), jb.predict(Xv, device=False),
                               rtol=0, atol=1e-6)


def test_feature_name_argument():
    """``feature_name`` names a lazy training set's columns, as in the
    JAX package's model text."""
    names = [f"f{i}" for i in range(8)]
    texts = {}
    for name, pkg, extra in (("jax", jlgb, C.JAX), ("port", tlgb, C.PORT)):
        X, y = C.train_rows()
        bst = pkg.train(dict(C.PARAMS, **extra), pkg.Dataset(X, label=y), 1,
                        feature_name=names, verbose_eval=False)
        texts[name] = [ln for ln in bst.model_to_string().splitlines()
                       if ln.startswith("feature_names=")]
    assert texts["port"] == texts["jax"] == [
        "feature_names=" + " ".join(names)]


@pytest.mark.parametrize("case", ["categorical_feature", "group",
                                  "init_model_without_raw_data"])
def test_front_door_refusals(case):
    """The front door's edge cases: categorical columns train as in the
    JAX package (column 0, the label's strongest, cut into 13
    categories, NaN kept); query groups train as in the JAX package
    (a binary objective carries them and grows the same trees);
    continued training needs the raw rows kept."""
    X, y = C.train_rows()
    params = dict(C.PARAMS, **C.PORT)
    if case == "categorical_feature":
        X[:, 0] = np.floor(np.clip(X[:, 0] + 3.0, 0.0, 6.4) * 2.0)
        jb = jlgb.train(dict(C.PARAMS, **C.JAX), jlgb.Dataset(X, label=y), 2,
                        categorical_feature=[0], verbose_eval=False)
        tb = tlgb.train(params, tlgb.Dataset(X, label=y), 2,
                        categorical_feature=[0], verbose_eval=False)
        # leaves within 1e-5 of the tree's largest: the JAX package's
        # FMAs (ROADMAP queue 3)
        C.assert_same_trees(jb.models, tb.models, of_largest=True)
        assert [t.cat_threshold for t in tb.models] == [
            list(t.cat_threshold) for t in jb.models]
        assert any(t.num_cat for t in tb.models)
    elif case == "group":
        jb = jlgb.train(dict(C.PARAMS, **C.JAX),
                        jlgb.Dataset(X, label=y, group=[2000, 2000]), 2,
                        verbose_eval=False)
        tb = tlgb.train(params, tlgb.Dataset(X, label=y, group=[2000, 2000]),
                        2, verbose_eval=False)
        C.assert_same_trees(jb.models, tb.models, of_largest=True)
        assert tb.num_trees() == 2
    else:
        from lightgbm_tpu_torch.utils.log import LightGBMError
        base = tlgb.train(params, tlgb.Dataset(X, label=y), 1,
                          verbose_eval=False)
        with pytest.raises(LightGBMError, match="free_raw_data=False"):
            tlgb.train(params, tlgb.Dataset(X, label=y), 1,
                       init_model=base, verbose_eval=False)
