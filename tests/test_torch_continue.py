"""Continued training and the Booster's training methods in the port
against the JAX package: ``init_model`` as a Booster and as a file,
``update``/``rollback_one_iter``, a custom ``fobj``, ``refit``,
``dump_model``, ``add_valid``/``eval_train``/``eval_valid``, string
attributes and a pickle round trip.

Both packages train tests/test_torch_train.py's main path (the JAX side
in Pallas interpret mode, the port on its kernels' plain versions);
trees are held with that file's tolerances, predictions within 1e-6.

What the port does as the JAX package does, and these tests pin:

* ``init_model`` seeds the training scores with the base model's raw
  prediction of the training rows, and boost_from_average still adds
  its score on top (folded into the first new tree).  The port predicts
  the seed through the level descent in f32, the JAX package through
  its host walk in f64: seeds agree within 1e-6.  Validation sets start
  from boost_from_average's score alone, without the base model.
* A multiclass seed is laid out class-major by a transpose in the port;
  the JAX package reshapes the (N, K) prediction (ROADMAP queue 3).
* ``rollback_one_iter`` subtracts each tree at the shrinkage it was
  added with; the JAX package, once its trees are on the host, at the
  current learning rate (ROADMAP queue 3).
"""
import pickle

import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import torch_front_door_cases as C


def _train(pkg, extra, rounds, **kw):
    d, valid = C.datasets(pkg, free_raw_data=False)
    ev = {}
    params = dict(C.PARAMS, **extra, **kw.pop("params", {}))
    bst = pkg.train(params, d, rounds, valid_sets=valid[:1],
                    evals_result=ev, verbose_eval=False, **kw)
    return bst, ev


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages: a 3-round base kept for training, and 2 more
    rounds continued from the JAX base (before anything updates it)."""
    out = {}
    for name, pkg, extra in (("jax", jlgb, C.JAX), ("port", tlgb, C.PORT)):
        base, base_ev = _train(pkg, extra, 3, keep_training_booster=True)
        out[name] = dict(base=base, base_ev=base_ev,
                         base_text=base.model_to_string())
    path = tmp_path_factory.mktemp("init") / "jax_base.txt"
    out["jax"]["base"].save_model(str(path))
    out["path"] = str(path)
    out["jax"]["cont"] = _train(jlgb, C.JAX, 2,
                                init_model=out["jax"]["base"])
    return out


def test_bases_match(runs):
    C.assert_same_trees(runs["jax"]["base"].models,
                        runs["port"]["base"].models)


@pytest.mark.parametrize("init", ["booster", "file"])
def test_init_model(runs, init):
    """2 rounds on top of the port's base (a Booster) or of the JAX
    base's model file: the base trees stay as they were, the new ones
    and the evaluation match the JAX package's continued run."""
    jcont, jev = runs["jax"]["cont"]
    base = runs["port"]["base"] if init == "booster" else runs["path"]
    tcont, tev = _train(tlgb, C.PORT, 2, init_model=base)
    assert tcont.num_trees() == 5 and tcont.current_iteration == 5
    base_models = (runs["port"]["base"].models if init == "booster"
                   else tlgb.Booster(model_file=runs["path"],
                                     params=C.PORT).models)
    for tb, tt in zip(base_models, tcont.models[:3]):
        assert tb.to_string() == tt.to_string()
    C.assert_same_trees(jcont.models, tcont.models)
    C.assert_same_evals(jev, tev)
    X, _ = C.train_rows()
    np.testing.assert_allclose(tcont.predict(X),
                               jcont.predict(X, device=False),
                               rtol=0, atol=1e-6)


#: objective -> (its params, its label from X)
SEED_CASES = {
    "binary": ({}, lambda X, y: y),
    "regression": ({"objective": "regression", "metric": ["l2"]},
                   lambda X, y: 3.0 * np.nan_to_num(X[:, 0]) + 1.5),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "metric": ["multi_logloss"]},
                   lambda X, y: np.digitize(np.nan_to_num(X[:, 0]),
                                            [-0.5, 0.5]).astype(float)),
}


@pytest.mark.parametrize("objective", list(SEED_CASES))
def test_init_model_seed(objective):
    """The starting scores of a continued run, before any new tree:
    the base's raw prediction of the training rows plus
    boost_from_average's score (non-zero for regression: the label
    mean; binary has none), equal in both packages within 1e-6.  For
    3 classes the port lays the (N, K) prediction out class-major (its
    transpose); the JAX package reshapes it to (K, N), which mixes the
    classes (ROADMAP queue 3)."""
    extra, label = SEED_CASES[objective]
    X, y = C.train_rows()
    y = label(X, y)
    params = dict(C.PARAMS, **extra)
    base = tlgb.train(dict(params, **C.PORT), tlgb.Dataset(X, label=y), 2,
                      verbose_eval=False)
    raw = base.predict(X, raw_score=True)
    raw = raw.T if raw.ndim == 2 else raw[None, :]
    seeds, offsets = {}, {}
    for name, pkg, extra_pkg, b in (
            ("port", tlgb, C.PORT, base),
            ("jax", jlgb, C.JAX,
             jlgb.Booster(model_str=base.model_to_string()))):
        cfg = pkg.Config.from_params(dict(params, **extra_pkg))
        core = pkg.Dataset(X, label=y, free_raw_data=False).construct(cfg)
        bst = pkg.Booster(config=cfg, train_set=core, init_model=b)
        seeds[name] = np.asarray(bst._current_train_scores()).reshape(
            raw.shape[0], -1)
        offsets[name] = bst.gbdt.init_score
    assert offsets["port"] == offsets["jax"]
    assert (offsets["port"] != 0.0) == (objective == "regression")
    np.testing.assert_allclose(seeds["port"], raw + offsets["port"], rtol=0,
                               atol=1e-6 * (1 + np.abs(raw).max()))
    if objective != "multiclass":
        np.testing.assert_allclose(seeds["jax"], seeds["port"], rtol=0,
                                   atol=1e-6 * (1 + np.abs(raw).max()))
    else:
        mixed = raw.T.reshape(raw.shape)
        np.testing.assert_allclose(seeds["jax"], mixed, rtol=0, atol=1e-6)
        assert not np.allclose(seeds["jax"], seeds["port"])


def test_update_and_rollback(runs):
    """update() grows a 4th iteration at the learning rate that
    reset_parameter set, rollback_one_iter() takes it out of the model
    and of the scores with that shrinkage: the 3-round model text
    again, the scores within 1e-6 relative (an f32 subtraction)."""
    texts, trees = {}, {}
    for name in ("jax", "port"):
        b = runs[name]["base"]
        s0 = np.array(b._current_train_scores())
        v0 = b.eval_valid()
        b.reset_parameter({"learning_rate": 0.05})
        assert b.update() is False
        trees[name] = b.models[3] if name == "port" else None
        if name == "jax":
            b._sync_models()
            trees[name] = b.models[3]
        assert b.num_trees() == 4 and trees[name].shrinkage == 0.05
        b.rollback_one_iter()
        b.reset_parameter({"learning_rate": 0.1})
        texts[name] = b.model_to_string()
        assert texts[name] == runs[name]["base_text"]
        assert b.current_iteration == 3
        np.testing.assert_allclose(b._current_train_scores(), s0,
                                   rtol=1e-6, atol=1e-7)
        for (d, m, v, _), (d1, m1, v1, _) in zip(v0, b.eval_valid()):
            assert (d, m) == (d1, m1)
            np.testing.assert_allclose(v1, v, rtol=1e-6)
    C.assert_same_trees([trees["jax"]], [trees["port"]])


def test_rollback_after_a_learning_rate_change():
    """An iteration grown at learning rate 0.05, then the rate set back
    to 0.1, then rolled back: the port subtracts the tree at the 0.05
    it was added with and restores the scores; the JAX package, once
    its trees are flushed to the host (here by num_trees()), subtracts
    at the current 0.1 (ROADMAP queue 3)."""
    restored = {}
    for name, pkg, extra in (("jax", jlgb, C.JAX), ("port", tlgb, C.PORT)):
        b, _ = _train(pkg, extra, 1, keep_training_booster=True)
        s0 = np.array(b._current_train_scores())
        b.reset_parameter({"learning_rate": 0.05})
        b.update()
        assert b.num_trees() == 2
        b.reset_parameter({"learning_rate": 0.1})
        b.rollback_one_iter()
        restored[name] = np.allclose(b._current_train_scores(), s0,
                                     rtol=1e-6, atol=1e-7)
    assert restored == {"port": True, "jax": False}


def test_fobj_against_builtin_objective():
    """A numpy binary log-loss fobj with boost_from_average off: at
    score 0 the gradients are exactly +-0.5 and the hessians 0.25, so
    the first tree is the built-in objective's bit for bit; both
    packages' fobj runs, with a feval, match."""
    no_avg = {"boost_from_average": False, "metric": ["auc"]}
    runs = {}
    for name, pkg, extra in (("jax", jlgb, C.JAX), ("port", tlgb, C.PORT)):
        runs[name] = _train(pkg, extra, 2, params=no_avg,
                            fobj=C.logloss_grad, feval=C.error_rate)
    builtin, _ = _train(tlgb, C.PORT, 1, params=no_avg)
    port = runs["port"][0]
    assert port.models[0].to_string() == builtin.models[0].to_string()
    C.assert_same_trees(runs["jax"][0].models, port.models)
    C.assert_same_evals(runs["jax"][1], runs["port"][1])
    assert list(runs["port"][1]) == ["valid_0", "feval"]


def test_refit(runs):
    """Leaf values refit on other rows, structure kept: both packages
    give the same leaves and predictions on the JAX base's text."""
    Xr, yr = C.data(1500, 7)
    text = runs["jax"]["base_text"]
    jb = jlgb.Booster(model_str=text).refit(Xr, yr)
    tb = tlgb.Booster(model_str=text, params=C.PORT).refit(Xr, yr)
    before = tlgb.Booster(model_str=text, params=C.PORT)
    for jt, tt, bt in zip(jb.models, tb.models, before.models):
        np.testing.assert_array_equal(tt.split_feature, bt.split_feature)
        np.testing.assert_array_equal(tt.leaf_count, jt.leaf_count)
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                                   atol=1e-9)
    assert not np.allclose(tb.models[1].leaf_value,
                           before.models[1].leaf_value)
    np.testing.assert_allclose(tb.predict(Xr), jb.predict(Xr, device=False),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_iteration", [-1, 2])
def test_dump_model(runs, num_iteration):
    text = runs["jax"]["base_text"]
    assert tlgb.Booster(model_str=text, params=C.PORT).dump_model(
        num_iteration) == jlgb.Booster(model_str=text).dump_model(
            num_iteration)


def test_add_valid_and_eval(runs):
    """A validation set added after training, the training metrics
    under another name, and each evaluation's rows, in both packages."""
    Xv, _, noise = C.valid_rows()
    rows = {}
    for name, pkg in (("jax", jlgb), ("port", tlgb)):
        b = runs[name]["base"]
        ref = b.gbdt.train_set
        b.add_valid(pkg.Dataset(Xv, label=noise, reference=ref), "extra")
        b.set_train_data_name("train")
        rows[name] = (b.eval_train(), b.eval_valid(), b.eval())
    for jr, tr in zip(rows["jax"], rows["port"]):
        assert [r[:2] for r in tr] == [r[:2] for r in jr]
        assert [r[3] for r in tr] == [r[3] for r in jr]
        np.testing.assert_allclose([r[2] for r in tr], [r[2] for r in jr],
                                   rtol=1e-5)
    assert {r[0] for r in rows["port"][2]} == {"train", "valid_0", "extra"}


def test_attributes_leaf_output_and_pickle(runs):
    text = runs["jax"]["base_text"]
    tb = tlgb.Booster(model_str=text, params=C.PORT)
    jb = jlgb.Booster(model_str=text)
    assert tb.get_leaf_output(2, 5) == jb.get_leaf_output(2, 5)
    tb.set_attr(stage="base", owner="x")
    tb.set_attr(owner=None)
    assert tb.attr("stage") == "base" and tb.attr("owner") is None
    tb.best_iteration = 2
    back = pickle.loads(pickle.dumps(tb))
    # the state is the model text at best_iteration, as in the JAX
    # package
    assert back.best_iteration == 2 and back.config.device == "cpu"
    assert back.num_trees() == 2
    assert back.model_to_string() == tb.model_to_string()
    Xv, _, _ = C.valid_rows()
    np.testing.assert_array_equal(back.predict(Xv), tb.predict(Xv))
    np.testing.assert_array_equal(back.predict(Xv),
                                  tb.predict(Xv, num_iteration=2))
