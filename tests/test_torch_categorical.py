"""Categorical features in lightgbm_tpu_torch against lightgbm_tpu, on
the CPU (the port's kernels through their plain versions, the JAX
package's Pallas kernels in interpret mode).

* The finder alone: ``find_categorical_splits``, ``build_cat_bitset``,
  ``run_split_finders`` and ``find_best_split_block`` on the same
  seeded histograms, run op by op on the JAX side: gains within 1e-6
  relative (equal in practice), thresholds, directions and masks equal,
  over one-hot and sorted modes, ``cat_smooth=0`` (NaN sort keys), tied
  scores, ``max_cat_threshold=1``, ``min_data_in_group`` chains that
  skip candidates, regularization, and NaN- and None-missing features.
* The grower: a tree grown by the JAX grower op by op
  (``jax.disable_jit()``) equals the port's bit for bit, bitsets
  included; ``lgb.train`` against the JAX package's compiled program
  holds the structure and the bitsets, leaves within 1e-5 (XLA's FMAs,
  ROADMAP queue 3); every int8 plan grows fused_tiled's model text.
* The front door: pandas ``category`` columns (``"auto"``), columns by
  name, ``pandas_categorical`` through save, load and predict (unseen
  categories are NaN), ``set_categorical_feature`` after construction,
  a JAX model carried across by ``booster_from_jax``, a validation set
  with early stopping, and ``rollback_one_iter``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import torch_front_door_cases as C
from lightgbm_tpu.learner.grower import TreeGrower as JGrower
from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch.convert import booster_from_jax
from lightgbm_tpu_torch.learner.grower import TreeGrower as TGrower
from lightgbm_tpu_torch.ops import split as TS
from lightgbm_tpu_torch.utils.log import LightGBMError

#: the port's parameters on the quantized main path (fused_tiled)
BASE = {"num_leaves": 15, "max_bin": 63, "verbose": -1,
        "min_data_in_leaf": 5, "quantized_grad": True,
        "hist_compute_dtype": "bfloat16"}
CATS = [1, 3, 4]


def cat_data(n=4000, seed=1, kind="real"):
    """Six columns: 1 takes 3 categories (one-hot mode), 3 about 40
    drawn Zipf-like (sorted mode), 4 takes 12 with 5% NaN; each
    category adds an offset to the target."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[:, 1] = rng.randint(0, 3, n)
    X[:, 3] = rng.zipf(1.5, n) % 40
    X[:, 4] = rng.randint(0, 12, n)
    X[rng.rand(n) < 0.05, 4] = np.nan
    off = rng.randn(50)
    z = (X[:, 0] + off[X[:, 3].astype(int)]
         + 0.7 * off[X[:, 1].astype(int) + 40]
         + 0.5 * off[np.nan_to_num(X[:, 4]).astype(int)]
         + 0.3 * rng.randn(n))
    if kind == "real":
        return X, z.astype(np.float32)
    return X, (z > np.median(z)).astype(float)


# ---------------------------------------------------------------------------
# the finder alone
# ---------------------------------------------------------------------------
FINDER_CFG = dict(lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
                  min_data_in_leaf=5.0, min_sum_hessian_in_leaf=1e-3,
                  min_gain_to_split=0.0, cat_smooth=10.0, cat_l2=10.0,
                  max_cat_threshold=32, max_cat_to_onehot=4,
                  min_data_in_group=100.0)
FINDER_CASES = {
    "sorted": {},
    "onehot": {"max_cat_to_onehot": 20},
    "cat_smooth_0": {"cat_smooth": 0.0},
    "max_cat_threshold_1": {"max_cat_threshold": 1},
    "group_chain_skips": {"min_data_in_group": 300.0},
    "group_chain_small": {"min_data_in_group": 5.0},
    "regularized": {"lambda_l1": 2.0, "lambda_l2": 1.5,
                    "max_delta_step": 0.8, "cat_l2": 3.0},
    "ties": {},
}
#: per feature: bins, missing type (NaN-missing 2, None 0)
FINDER_META = (np.array([16, 12, 4, 9, 16], np.int32),
               np.array([0, 2, 0, 2, 2], np.int32))


def finder_inputs(case, seed, L=6, B=16):
    rng = np.random.RandomState(seed)
    F = len(FINDER_META[0])
    c = rng.randint(0, 60, size=(L, F, B)).astype(np.float32)
    c[rng.rand(L, F, B) < 0.2] = 0
    g = (rng.randn(L, F, B) * c * 0.3).astype(np.float32)
    h = (c * rng.uniform(0.1, 0.3, size=(L, F, B))).astype(np.float32)
    if case == "ties":
        # equal ratios inside a feature, and two identical features
        g[:, :, 4:9] = g[:, :, 4:5]
        h[:, :, 4:9] = h[:, :, 4:5]
        c[:, :, 4:9] = c[:, :, 4:5]
        g[:, 4], h[:, 4], c[:, 4] = g[:, 0], h[:, 0], c[:, 0]
    hist = np.stack([g, h, c], -1)
    sums = hist[:, 0].sum(1)
    lim = np.full(L, np.inf, np.float32)
    return hist, sums[:, 0], sums[:, 1], sums[:, 2], -lim, lim


def _assert_result(jr, tr, what):
    for name, a, b in zip(jr._fields, jr, tr):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind == "f":
            fin = np.isfinite(a)
            np.testing.assert_array_equal(fin, np.isfinite(b),
                                          f"{what} {name}")
            np.testing.assert_allclose(b[fin], a[fin], rtol=1e-6,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(b, a, f"{what} {name}")


@pytest.mark.parametrize("case", list(FINDER_CASES))
def test_categorical_finder_and_bitset(case):
    cfg = dict(FINDER_CFG, **FINDER_CASES[case])
    nb, mt = FINDER_META
    for seed in (0, 1):
        args = finder_inputs(case, seed)
        hist, sg, sh, sc, mn, mx = args
        jr = JS.find_categorical_splits(
            jnp.asarray(hist), jnp.asarray(sg), jnp.asarray(sh),
            jnp.asarray(sc), jnp.asarray(nb), jnp.asarray(mt),
            jnp.asarray(mn), jnp.asarray(mx), cfg)
        T = torch.from_numpy
        tr = TS.find_categorical_splits(T(hist), T(sg), T(sh), T(sc), T(nb),
                                        T(mt), T(mn), T(mx), cfg)
        _assert_result(jr, tr, case)
        # every feature's mask, not only the winners'
        L, F = hist.shape[:2]
        for f in range(F):
            thr = np.array(jr.threshold)[:, f]
            cdir = np.array(jr.cat_dir)[:, f]
            jm = JS.build_cat_bitset(
                jnp.asarray(hist[:, f]), jnp.asarray(thr), jnp.asarray(cdir),
                jnp.asarray(np.full(L, nb[f])), jnp.asarray(np.full(L, mt[f])),
                cfg)
            tm = TS.build_cat_bitset(T(hist[:, f]), T(thr), T(cdir),
                                     T(np.full(L, nb[f])),
                                     T(np.full(L, mt[f])), cfg)
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if case == "onehot":
        assert (np.asarray(jr.cat_dir) == 0).all()
    if case == "sorted":
        dirs = np.asarray(jr.cat_dir)
        assert (dirs[:, nb <= 4] == 0).all()
        assert set(np.unique(dirs[:, nb > 4])) <= {-1, 1}


def test_nan_sort_keys_go_last():
    """``cat_smooth=0``: an empty bin's key ``0 / 0`` is NaN.  Both
    libraries' stable sorts put it after every number and after the
    ``+inf`` keys of the bins out of range, in bin order (so with empty
    bins the sorted mode's first ``n_used`` positions reach past the
    eligible bins, in the JAX package as here)."""
    rng = np.random.RandomState(3)
    c = rng.randint(1, 60, size=(4, 16)).astype(np.float32)
    g = (rng.randn(4, 16) * c).astype(np.float32)
    h = (0.2 * c).astype(np.float32)
    for a in (c, g, h):
        a[:, 2:5] = 0.0
    in_range = np.arange(16) < 11
    key = np.where(in_range, g / h, np.inf)
    assert np.isnan(key[:, 2:5]).all() and np.isfinite(key[:, 5:11]).all()
    want = np.asarray(jnp.argsort(jnp.asarray(key), axis=1))
    order, n_used = TS._cat_sort(*map(torch.from_numpy, (g, h, c)),
                                 torch.from_numpy(in_range)[None], 0.0)
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(n_used.numpy(), 11)
    np.testing.assert_array_equal(order.numpy()[:, 8:13],
                                  np.tile(np.arange(11, 16), (4, 1)))
    np.testing.assert_array_equal(order.numpy()[:, 13:],
                                  np.tile([2, 3, 4], (4, 1)))


@pytest.mark.parametrize("case", ["sorted", "cat_smooth_0", "ties"])
def test_finder_block_on_mixed_features(case):
    """The categorical finder on the categorical features alone,
    scattered into the numerical result, gives the JAX package's
    ``where`` over every feature; the packed block (winner and its bin
    mask) is equal."""
    cfg = dict(FINDER_CFG, **FINDER_CASES[case])
    nb, mt = FINDER_META
    is_cat = np.array([True, False, True, True, False])
    hist, sg, sh, sc, mn, mx = finder_inputs(case, 4)
    F = hist.shape[1]
    db = np.zeros(F, np.int32)
    mono = np.zeros(F, np.int32)
    fmask = np.array([True, True, True, True, False])
    J = jnp.asarray
    jres, jg = JS.run_split_finders(J(hist), J(sg), J(sh), J(sc), J(mn),
                                    J(mx), cfg, J(nb), J(mt), J(db), J(mono),
                                    J(is_cat), J(fmask), True)
    jb = JS.find_best_split_block(J(hist), J(sg), J(sh), J(sc), J(mn),
                                  J(mx), cfg, J(nb), J(mt), J(db), J(mono),
                                  J(is_cat), J(fmask), True)
    T = torch.from_numpy
    targs = (T(hist), T(sg), T(sh), T(sc), T(mn), T(mx), cfg, T(nb), T(mt),
             T(db), T(mono), T(is_cat), T(fmask), True,
             T(np.nonzero(is_cat)[0]))
    tres, tg = TS.run_split_finders(*targs)
    _assert_result(jres, tres, case)
    fin = np.isfinite(np.asarray(jg))
    np.testing.assert_array_equal(np.isfinite(tg.numpy()), fin)
    tb = TS.find_best_split_block(*targs)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
    np.testing.assert_array_equal(tb.numpy()[:, TS.CAND_COLS:],
                                  np.asarray(jb)[:, TS.CAND_COLS:])


# ---------------------------------------------------------------------------
# the grower and lgb.train
# ---------------------------------------------------------------------------
TREE_FIELDS = ("leaf_value", "leaf_weight", "leaf_count", "node_feature",
               "node_threshold", "node_gain", "node_value", "node_weight",
               "node_is_cat", "node_cat_mask", "node_left", "node_right",
               "node_default_left")


#: a forced spec: the root on category 2 of column 3, its left child on
#: column 2 at -0.25, that node's right child on category 1 of column 1
FORCED = {"feature": 3, "threshold": 2,
          "left": {"feature": 2, "threshold": -0.25,
                   "right": {"feature": 1, "threshold": 1}}}


@pytest.mark.parametrize("case", ["sorted", "onehot", "forced"])
def test_port_grower_equals_the_jax_tree_op_by_op(case, tmp_path):
    """Regression gradients through the JAX grower with every op
    compiled alone and through the port's grower, on the quantized plan
    with categorical columns (sorted mode, one-hot mode, and a forced
    spec whose first split is categorical): the same tree, bit for bit,
    bin masks and leaf ids included.  4,000 rows, so both sum the root
    in row order."""
    extra = {"sorted": {},
             "onehot": {"max_cat_to_onehot": 16, "cat_smooth": 0.0},
             "forced": {"forcedsplits_filename": str(tmp_path / "f.json")}
             }[case]
    with open(tmp_path / "f.json", "w") as f:
        json.dump(FORCED, f)
    X, y = cat_data()
    params = dict(BASE, objective="regression", num_leaves=7,
                  min_data_in_group=20, **extra)
    jcore = jlgb.Dataset(X, label=y, categorical_feature=CATS).construct(
        jlgb.Config.from_params(params))
    tcfg = tlgb.Config.from_params(dict(params, device="cpu"))
    tcore = tlgb.Dataset(X, label=y, categorical_feature=CATS).construct(
        tcfg)
    jg = JGrower(jcore, jlgb.Config.from_params(
        dict(params, force_pallas_interpret=True)))
    tg = TGrower(tcore, tcfg, torch.device("cpu"))
    assert tg.plan.name == "fused_tiled" and tg.has_categorical
    n, npad = len(y), tg.n_padded
    g = np.zeros(npad, np.float32)
    g[:n] = np.float32(y.mean()) - y
    h = np.zeros(npad, np.float32)
    h[:n] = 1.0
    fm = np.ones(X.shape[1], bool)
    with jax.disable_jit():
        jt, jl, _ = jg.train_tree(jnp.asarray(g), jnp.asarray(h),
                                  jnp.asarray(h), jnp.asarray(fm))
    tt, tl, _ = tg.train_tree(torch.from_numpy(g), torch.from_numpy(h),
                              torch.from_numpy(h), torch.from_numpy(fm))
    assert int(jt.num_leaves) == tt["num_leaves"] == 7
    assert tt["node_is_cat"].any()
    if case == "forced":
        assert tg.forced_count == 3
        nf, lc = tt["node_feature"].tolist(), tt["node_left"].tolist()
        assert nf[0] == 3 and nf[lc[0]] == 2
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                      tt[f].numpy(), f)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())


def _same_cat_trees(jmodels, tmodels):
    """Structure and bitsets equal, leaves within 1e-5 of the tree's
    largest (the JAX package's FMAs)."""
    C.assert_same_trees(jmodels, tmodels, of_largest=True)
    for jt, tt in zip(jmodels, tmodels):
        assert jt.num_cat == tt.num_cat
        assert list(jt.cat_boundaries) == list(tt.cat_boundaries)
        assert list(jt.cat_threshold) == list(tt.cat_threshold)


def test_train_matches_the_jax_package():
    """``lgb.train`` with ``categorical_feature`` on the quantized plan:
    both packages grow the same structure and category sets, in both
    modes; predictions within 1e-5."""
    X, y = cat_data(kind="class")
    params = dict(BASE, objective="binary")
    jb = jlgb.train(dict(params, **C.JAX), jlgb.Dataset(X, label=y), 3,
                    categorical_feature=CATS)
    tb = tlgb.train(dict(params, **C.PORT), tlgb.Dataset(X, label=y), 3,
                    categorical_feature=CATS, verbose_eval=False)
    _same_cat_trees(jb.models, tb.models)
    text = tb.model_to_string()
    dts = set()
    for ln in text.splitlines():
        if ln.startswith("decision_type="):
            dts |= {int(v) for v in ln.split("=")[1].split()}
    assert any(d & 1 for d in dts)
    cat_feats = {int(f) for t in tb.models
                 for f, d in zip(t.split_feature, t.decision_type) if d & 1}
    assert {1, 3} <= cat_feats                  # one-hot and sorted
    np.testing.assert_allclose(tb.predict(X), jb.predict(X, device=False),
                               rtol=0, atol=1e-5)
    # the host walk (pred_leaf) on values training never saw: negative,
    # fractional, huge, NaN and unseen categories
    odd = X[:400].copy()
    odd[:50, 3] = -2.5
    odd[50:100, 3] = 0.7
    odd[100:150, 4] = 1e12
    odd[150:200, 1] = np.nan
    odd[200:250, 3] = 45.0
    odd[250:300, 1] = -0.4
    np.testing.assert_array_equal(tb.predict(odd, pred_leaf=True),
                                  jb.predict(odd, pred_leaf=True))


INT8_PLANS = {
    "q_tiled(split_route)": {"hist_split_route": True},
    "seg_tiled(leaf_partition)": {"hist_leaf_partition": "on"},
    "q_tiled": {"hist_fused_route": False},
    "q_onthefly": {"hist_kernel_tiled": False, "hist_fused_route": False},
    "pallas(quantized)": {"hist_kernel_tiled": False,
                          "hist_fused_route": False,
                          "hist_quant_onthefly": False,
                          "hist_onehot_budget_mb": 0},
}


def _port_text(params, rounds=3):
    X, y = cat_data(kind="class")
    bst = tlgb.train(dict(params, **C.PORT), tlgb.Dataset(X, label=y),
                     rounds, categorical_feature=CATS, verbose_eval=False,
                     keep_training_booster=True)
    return bst.gbdt.grower.plan.name, bst.model_to_string()


@pytest.mark.parametrize("plan", list(INT8_PLANS))
def test_every_int8_plan_grows_the_fused_tiled_text(plan):
    """Integer histograms: every int8 plan routes the same bitsets and
    grows fused_tiled's categorical model text byte for byte."""
    params = dict(BASE, objective="binary")
    name, ref = _port_text(params)
    assert name == "fused_tiled"
    name, text = _port_text(dict(params, **INT8_PLANS[plan]))
    assert name == plan
    assert text == ref


FLOAT_PLANS = {
    "pre_onehot": {"hist_fused_route": False},
    "pallas": {"hist_onehot_budget_mb": 0},
    "pallas_paired": {"hist_kernel": "paired"},
}


@pytest.mark.parametrize("plan", ["xla"] + list(FLOAT_PLANS))
def test_float_plans_train_categorical_columns(plan):
    """Float gradients: the default config (xla) grows the JAX package's
    structure and category sets; the bf16 one-hot and bin-matrix plans,
    whose f32 histograms are exact sums, grow fused_streamed's text."""
    X, y = cat_data(kind="class")
    base = {k: v for k, v in BASE.items() if k != "quantized_grad"}
    params = dict(base, objective="binary")
    if plan == "xla":
        params.pop("hist_compute_dtype")
        jb = jlgb.train(dict(params, **C.JAX), jlgb.Dataset(X, label=y), 3,
                        categorical_feature=CATS)
        tb = tlgb.train(dict(params, **C.PORT), tlgb.Dataset(X, label=y), 3,
                        categorical_feature=CATS, verbose_eval=False,
                        keep_training_booster=True)
        assert tb.gbdt.grower.plan.name == "xla"
        _same_cat_trees(jb.models, tb.models)
        return
    name, ref = _port_text(params)
    assert name == "fused_streamed"
    name, text = _port_text(dict(params, **FLOAT_PLANS[plan]))
    assert name == plan
    assert text == ref


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------
def _frame(X):
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({f"c{i}": X[:, i] for i in range(X.shape[1])})
    for i in (1, 3):
        codes = X[:, i].astype(int)
        df[f"c{i}"] = pd.Categorical.from_codes(
            codes, categories=[f"k{j}" for j in range(codes.max() + 1)])
    return df


def _predict_frame(df):
    """A predict frame with the categories reordered, one category
    unseen in training and one row missing."""
    pd = pytest.importorskip("pandas")
    out = df.copy()
    col = out["c3"].astype(str).to_numpy()
    col[:7] = "never_seen"
    col[7] = None
    out["c3"] = pd.Categorical(col)
    out["c1"] = out["c1"].cat.reorder_categories(
        list(reversed(out["c1"].cat.categories)))
    return out


def test_pandas_auto_categories_save_load_predict(tmp_path):
    """A frame's ``category`` columns are categorical by default; the
    model text carries ``pandas_categorical``; a frame with reordered,
    unseen and missing categories predicts through the training
    categories, in the port as in the JAX package, before and after a
    save and load (JAX model text included)."""
    X, y = cat_data(kind="class")
    df = _frame(X)
    params = dict(BASE, objective="binary")
    jb = jlgb.train(dict(params, **C.JAX), jlgb.Dataset(df, label=y), 2)
    tb = tlgb.train(dict(params, **C.PORT), tlgb.Dataset(df, label=y), 2,
                    verbose_eval=False)
    _same_cat_trees(jb.models, tb.models)
    assert tb.pandas_categorical == jb.pandas_categorical
    assert len(tb.pandas_categorical) == 2
    tline = [ln for ln in tb.model_to_string().splitlines()
             if ln.startswith("pandas_categorical:")]
    jline = [ln for ln in jb.model_to_string().splitlines()
             if ln.startswith("pandas_categorical:")]
    assert tline == jline and len(tline) == 1
    pdf = _predict_frame(df)
    want = jb.predict(pdf, device=False)
    got = tb.predict(pdf)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    path = str(tmp_path / "m.txt")
    tb.save_model(path)
    loaded = tlgb.Booster(model_file=path, params=C.PORT)
    assert loaded.pandas_categorical == tb.pandas_categorical
    np.testing.assert_array_equal(loaded.predict(pdf), got)
    from_jax = tlgb.Booster(model_str=jb.model_to_string(), params=C.PORT)
    assert from_jax.pandas_categorical == jb.pandas_categorical
    np.testing.assert_allclose(from_jax.predict(pdf), want, rtol=0,
                               atol=1e-5)
    crossed = booster_from_jax(jb, params=C.PORT)
    assert crossed.pandas_categorical == jb.pandas_categorical
    np.testing.assert_allclose(crossed.predict(pdf), want, rtol=0,
                               atol=1e-5)


def test_categorical_columns_by_name():
    """``categorical_feature`` names resolve against ``feature_name``:
    the same model as the same columns by index, in both packages."""
    X, y = cat_data(kind="class")
    names = [f"f{i}" for i in range(X.shape[1])]
    params = dict(BASE, objective="binary")
    by_name = tlgb.train(dict(params, **C.PORT), tlgb.Dataset(X, label=y),
                         2, feature_name=names,
                         categorical_feature=[names[i] for i in CATS],
                         verbose_eval=False)
    jb = jlgb.train(dict(params, **C.JAX), jlgb.Dataset(X, label=y), 2,
                    feature_name=names,
                    categorical_feature=[names[i] for i in CATS])
    _same_cat_trees(jb.models, by_name.models)
    by_index = tlgb.train(dict(params, **C.PORT),
                          tlgb.Dataset(X, label=y, feature_name=names), 2,
                          categorical_feature=CATS, verbose_eval=False)
    assert by_index.model_to_string() == by_name.model_to_string()


def test_set_categorical_feature_after_construction_is_fatal():
    X, y = cat_data(n=1000)
    ds = tlgb.Dataset(X, label=y, categorical_feature=[1])
    ds.construct(tlgb.Config.from_params(C.PORT))
    ds.set_categorical_feature([1])               # unchanged: allowed
    with pytest.raises(LightGBMError, match="after the Dataset has been"):
        ds.set_categorical_feature([1, 3])


def test_validation_early_stopping_and_rollback():
    """A categorical model with a validation set (scored by the binned
    walk through the bin masks) whose labels carry nothing of X: the
    same evaluations, stop and ``best_iteration`` as the JAX package;
    after ``rollback_one_iter`` the validation scores and predictions
    are those of a run one iteration shorter."""
    X, y = cat_data()
    Xv, _ = cat_data(n=1500, seed=2)
    noise = np.random.RandomState(5).randn(len(Xv))
    params = dict(BASE, objective="regression", metric=["l2", "l1"],
                  learning_rate=0.3)

    def run(pkg, extra, rounds, early=None):
        d = pkg.Dataset(X, label=y)
        v = pkg.Dataset(Xv, label=noise, reference=d)
        ev = {}
        bst = pkg.train(dict(params, **extra), d, rounds, valid_sets=[v],
                        categorical_feature=CATS, evals_result=ev,
                        early_stopping_rounds=early, verbose_eval=False,
                        keep_training_booster=True)
        return bst, ev

    jb, jev = run(jlgb, C.JAX, 8, early=2)
    tb, tev = run(tlgb, C.PORT, 8, early=2)
    n = tb.num_trees()
    assert 1 <= tb.best_iteration < n < 8
    _same_cat_trees(jb.models, tb.models)
    C.assert_same_evals(jev, tev)
    assert tb.best_iteration == jb.best_iteration
    before = tb.predict(Xv, raw_score=True, num_iteration=n)
    last = tb.models[-1].predict(Xv)
    tb.rollback_one_iter()
    assert tb.num_trees() == n - 1
    np.testing.assert_allclose(
        tb.predict(Xv, raw_score=True, num_iteration=n - 1), before - last,
        rtol=0, atol=1e-5)
    short, sev = run(tlgb, C.PORT, n - 1)
    assert short.model_to_string() == tb.model_to_string(n - 1)
    got = {r[1]: r[2] for r in tb.eval_valid()}
    for m in ("l2", "l1"):
        np.testing.assert_allclose(got[m], sev["valid_0"][m][-1], rtol=1e-6)


def test_categories_past_a_byte_share_the_last_bin():
    """The 99% cut may keep more categories than a byte of bin index
    holds.  The port keeps 256 bins and the rarest categories share the
    last one (as the cut ones do), so every stored bin is the mapper's;
    the JAX package keeps 296 bins here and its stored bytes wrap bins
    past 255 around to 0-39 (ROADMAP queue 3)."""
    rng = np.random.RandomState(0)
    n = 20000
    X = rng.randn(n, 3)
    X[:, 1] = rng.randint(0, 300, n)
    y = X[:, 0] + (X[:, 1] % 7) * 0.2
    params = {"max_bin": 63, "verbose": -1}
    stored = {}
    for name, pkg, extra in (("jax", jlgb, {}), ("port", tlgb, C.PORT)):
        core = pkg.Dataset(X, label=y, categorical_feature=[1]).construct(
            pkg.Config.from_params(dict(params, **extra)))
        f = [f for f in core.features if f.feature_idx == 1][0]
        gb = core.logical_group_bins() if name == "port" else core.group_bins
        stored[name] = (f.num_bin, gb[:, f.group].astype(np.int64),
                        f.mapper.value_to_bin(X[:, 1]))
    nb, got, want = stored["port"]
    assert nb == 256
    np.testing.assert_array_equal(got, want)
    nb, got, want = stored["jax"]
    assert nb == 296 and (got != want).sum() > 0
    np.testing.assert_array_equal(got, want % 256)
    bst = tlgb.train(dict(BASE, objective="regression", **C.PORT),
                     tlgb.Dataset(X, label=y), 2, categorical_feature=[1],
                     verbose_eval=False, keep_training_booster=True)
    binned = bst.gbdt.scores.reshape(-1)[:n].numpy()
    np.testing.assert_allclose(bst.predict(X, raw_score=True), binned,
                               rtol=0, atol=1e-5)


def test_cv_with_categorical_columns():
    """``cv`` bins each fold anew with the training set's categorical
    columns: the same fold results as the JAX package's."""
    X, y = cat_data(n=3000)
    params = dict(BASE, objective="regression", metric=["l2"])
    res = {}
    for name, pkg, extra in (("jax", jlgb, C.JAX), ("port", tlgb, C.PORT)):
        res[name] = pkg.cv(dict(params, **extra),
                           pkg.Dataset(X, label=y, categorical_feature=CATS),
                           num_boost_round=2, nfold=2, seed=4)
    assert list(res["port"]) == list(res["jax"]) == ["l2-mean", "l2-stdv"]
    np.testing.assert_allclose(res["port"]["l2-mean"], res["jax"]["l2-mean"],
                               rtol=1e-5)
