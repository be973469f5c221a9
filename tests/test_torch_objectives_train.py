"""lgb.train in both packages on the objectives beyond binary.

The JAX side runs its main-path plan (quantized int8 gradients, the
fused route + histogram kernel and the exit-route kernel in Pallas
interpret mode), the port the same plan with its kernels' plain
versions on the CPU: 2,000 rows, 15 leaves, 3 iterations.

What stays equal, and why not more:

* The port computes what the JAX package's operations compute, one by
  one: a tree grown by the JAX grower with ``jax.disable_jit()`` (every
  op compiled alone) equals the port's bit for bit, on regression
  gradients whose root sums cancel.
* ``lgb.train`` runs the JAX tree as one compiled program, and XLA's CPU
  backend contracts a multiply that feeds an add or subtract inside one
  fusion into an FMA, rounding once where the port rounds twice.  The
  first values that move are splits' gains and their children's sums
  of hessians: where the dequantized right child ``q * scale`` fuses
  into the histogram subtraction ``parent - right``, and in the gain
  ``2*g*out + h*out*out``, the compiled tree rounds once.  A fused
  ``c - q * s`` is checked below to round like the FMA.  So every
  tree's split structure (features, thresholds, children, counts) is
  held equal, and its leaf values within a relative tolerance of the
  tree's largest leaf: 1e-5 for regression, multiclass and poisson
  (whose ``exp`` adds last-bit noise from the second tree on), 1e-6
  for regression_l1, whose leaf values are percentiles of the residuals
  (refit after the exit route, which still routes).
* Where a gradient sits on an int8 rounding boundary, one ulp moves its
  quantized value by one step (1/127 of the tree's largest gradient)
  and a split can change; none of the four objectives compared here
  meets one on this data.
* The root sums follow XLA's CPU order for the contraction (8 lanes and
  4 accumulators below 4,096 rows, row by row from there), held bit for
  bit below against the JAX package's ``compute_leaf_totals``.

Every other ported objective trains downhill on its default metric in
the port, and names its metric and its model-text objective as the JAX
package does.  A JAX multiclass model crosses over through
``convert.booster_from_jax`` and through its model text, both ways.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import metrics as JM
from lightgbm_tpu.learner.grower import TreeGrower as JGrower
from lightgbm_tpu.ops.histogram import compute_leaf_totals
from lightgbm_tpu_torch.booster import _objective_to_string
from lightgbm_tpu_torch.convert import booster_from_jax
from lightgbm_tpu_torch.learner.grower import TreeGrower as TGrower
from lightgbm_tpu_torch.ops.histogram import compute_root_totals

ROUNDS = 3
N = 2000
BASE = {"num_leaves": 15, "max_bin": 63, "verbose": -1,
        "min_data_in_leaf": 5, "quantized_grad": True,
        "hist_compute_dtype": "bfloat16"}
STRUCTURE = ("split_feature", "threshold", "left_child", "right_child",
             "leaf_count", "internal_count")


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n, 6) < 0.03] = np.nan
    Z = np.nan_to_num(X)
    z = Z[:, 0] - 0.5 * Z[:, 1] + 0.5 * np.sin(2 * Z[:, 2]) \
        + 0.3 * rng.randn(n)
    return X, z


def _label(kind, z):
    return {"real": 3.0 * z + 0.5,
            "class": np.digitize(z, [-0.6, 0.6]).astype(float),
            "count": np.random.RandomState(9).poisson(
                np.exp(0.5 * z)).astype(float),
            "positive": np.exp(0.5 * z) + 0.1,
            "unit": 1.0 / (1.0 + np.exp(-2.0 * z)),
            "mape": 3.0 * z + 10.0}[kind]


def _train_both(params, kind, init_score=None):
    X, z = _data()
    y = _label(kind, z)
    jev, tev = {}, {}
    jd = jlgb.Dataset(X, label=y, init_score=init_score)
    jb = jlgb.train(dict(BASE, **params, force_pallas_interpret=True,
                         compile_cache_dir=""), jd, ROUNDS,
                    valid_sets=[jd], evals_result=jev, verbose_eval=False,
                    keep_training_booster=True)
    td = tlgb.Dataset(X, label=y, init_score=init_score)
    tb = tlgb.train(dict(BASE, **params, device="cpu"), td, ROUNDS,
                    valid_sets=[td], evals_result=tev, verbose_eval=False,
                    keep_training_booster=True)
    return dict(X=X, y=y, jb=jb, tb=tb, jev=jev, tev=tev)


_RUNS = {
    "regression": ({"objective": "regression"}, "real"),
    "regression_l1": ({"objective": "regression_l1"}, "real"),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, "class"),
    "poisson": ({"objective": "poisson"}, "count"),
}


@pytest.fixture(scope="module")
def runs():
    return {}


def _run(runs, name):
    if name not in runs:
        params, kind = _RUNS[name]
        runs[name] = _train_both(params, kind)
    return runs[name]


def _hold_trees(r, rtol):
    jm, tm = r["jb"].models, r["tb"].models
    assert len(jm) == len(tm) == ROUNDS * r["tb"].num_tree_per_iteration
    for i, (jt, tt) in enumerate(zip(jm, tm)):
        assert jt.num_leaves == tt.num_leaves, i
        for f in STRUCTURE:
            np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f),
                                          f"tree {i} {f}")
        np.testing.assert_array_equal(jt.decision_type & ~2,
                                      tt.decision_type & ~2)
        scale = float(np.abs(jt.leaf_value).max())
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=rtol,
                                   atol=rtol * scale, err_msg=f"tree {i}")


@pytest.mark.parametrize("name,rtol", [("regression", 1e-5),
                                       ("regression_l1", 1e-6),
                                       ("multiclass", 1e-5),
                                       ("poisson", 1e-5)])
def test_trees_match_the_reference(runs, name, rtol):
    r = _run(runs, name)
    assert r["jb"].gbdt.grower.use_fused and r["jb"].gbdt.grower.use_quant
    assert r["tb"].gbdt.grower.plan.name == "fused_tiled"
    _hold_trees(r, rtol)
    assert r["tb"].objective_str == r["jb"].objective_str
    assert list(r["tev"]["training"]) == list(r["jev"]["training"])
    for m, want in r["jev"]["training"].items():
        np.testing.assert_allclose(r["tev"]["training"][m], want, rtol=1e-5)


def test_regression_l1_refits_its_leaves(runs):
    """regression_l1's leaves are the residual medians, not kernel B's
    Newton values: the first tree is bit for bit the JAX package's."""
    r = _run(runs, "regression_l1")
    jt, tt = r["jb"].models[0], r["tb"].models[0]
    np.testing.assert_array_equal(tt.leaf_value, jt.leaf_value)
    assert r["jb"].gbdt.objective.is_renew_tree_output


def test_multiclass_predictions_and_model_text(runs, tmp_path):
    r = _run(runs, "multiclass")
    jb, tb, X = r["jb"], r["tb"], r["X"]
    assert tb.num_trees() == 3 * ROUNDS
    pt = tb.predict(X)
    assert pt.shape == (N, 3)
    np.testing.assert_allclose(pt.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(pt, jb.predict(X, device=False), atol=1e-5)
    # the port's model text in the JAX package, and the JAX text in the
    # port: the same trees predict the same outputs
    tb.save_model(str(tmp_path / "port.txt"))
    j_from_t = jlgb.Booster(model_file=str(tmp_path / "port.txt"))
    np.testing.assert_allclose(j_from_t.predict(X, device=False), pt,
                               rtol=0, atol=1e-6)
    jtext = jb.model_to_string()
    t_from_j = tlgb.Booster(model_str=jtext, params={"device": "cpu"})
    assert t_from_j.model_to_string() == jtext
    np.testing.assert_allclose(t_from_j.predict(X),
                               jb.predict(X, device=False), rtol=0,
                               atol=1e-6)
    conv = booster_from_jax(jb, params={"device": "cpu"})
    assert conv.model_to_string() == jtext
    np.testing.assert_allclose(conv.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True, device=False),
                               rtol=0, atol=1e-6)


def test_regression_with_init_score():
    """An init score replaces boost_from_average: the scores start from
    it, no tree carries a bias, and both packages grow the same trees."""
    X, z = _data()
    init = np.linspace(-1.0, 1.0, N)
    r = _train_both({"objective": "regression"}, "real", init_score=init)
    assert r["tb"].gbdt.init_score == r["jb"].gbdt.init_score == 0.0
    _hold_trees(r, 1e-5)
    raw = r["tb"].predict(X, raw_score=True)
    np.testing.assert_allclose(raw, r["jb"].predict(X, raw_score=True,
                                                    device=False),
                               atol=1e-5)


def test_port_grower_equals_the_jax_tree_op_by_op():
    """Regression gradients through the JAX grower with every op compiled
    alone (``jax.disable_jit()``) and through the port's grower: the
    same tree, bit for bit.  4,000 rows, so both sum the root in row
    order (ops/histogram.py XLA_CPU_VECTOR_DOT_ROWS)."""
    X, z = _data(seed=1, n=4000)
    y = (3.0 * z).astype(np.float32)
    params = dict(BASE, objective="regression", num_leaves=7)
    jcore = jlgb.Dataset(X, label=y).construct(
        jlgb.Config.from_params(params))
    tcfg = tlgb.Config.from_params(dict(params, device="cpu"))
    tcore = tlgb.Dataset(X, label=y).construct(tcfg)
    jg = JGrower(jcore, jlgb.Config.from_params(
        dict(params, force_pallas_interpret=True)))
    tg = TGrower(tcore, tcfg, torch.device("cpu"))
    n, npad = len(y), tg.n_padded
    assert jg.n_padded == npad
    g = np.zeros(npad, np.float32)
    g[:n] = np.float32(y.mean()) - y
    h = np.zeros(npad, np.float32)
    h[:n] = 1.0
    fm = np.ones(6, bool)
    with jax.disable_jit():
        jt, jl, _ = jg.train_tree(jnp.asarray(g), jnp.asarray(h),
                                  jnp.asarray(h), jnp.asarray(fm))
    tt, tl, _ = tg.train_tree(torch.from_numpy(g), torch.from_numpy(h),
                              torch.from_numpy(h), torch.from_numpy(fm))
    assert int(jt.num_leaves) == tt["num_leaves"] == 7
    for f in ("leaf_value", "leaf_weight", "leaf_count", "node_feature",
              "node_threshold", "node_gain", "node_value", "node_weight"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                      tt[f].numpy(), f)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())


@pytest.mark.parametrize("rows", [1024, 2048, 3072, 4096, 8192])
def test_root_totals_sum_in_the_xla_cpu_order(rows):
    rng = np.random.RandomState(rows)
    g, h = (rng.randn(2, rows) * 3).astype(np.float32)
    c = np.ones(rows, np.float32)
    valid = np.arange(rows) < rows - 37
    want = jax.jit(compute_leaf_totals, static_argnums=4)(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(c),
        jnp.asarray(np.where(valid, 0, -1).astype(np.int32)), 1)
    got = compute_root_totals(torch.from_numpy(g), torch.from_numpy(h),
                              torch.from_numpy(c), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])


def test_xla_contracts_a_fused_multiply_subtract():
    """The op the compiled tree program rounds once: ``c - q * s``."""
    rng = np.random.RandomState(0)
    c = (rng.randn(4096) * 100).astype(np.float32)
    q = rng.randint(-20000, 20000, 4096).astype(np.int32)
    s = np.float32(0.0052493)
    fused = np.asarray(jax.jit(
        lambda c, q, s: c - q.astype(jnp.float32) * s)(c, q, s))
    once = (c.astype(np.float64)
            - q.astype(np.float64) * np.float64(s)).astype(np.float32)
    port = (torch.from_numpy(c) - torch.from_numpy(q).to(torch.float32)
            * float(s)).numpy()
    np.testing.assert_array_equal(fused, once)
    assert (port != fused).any()


#: the objectives the reference tests above do not train, each with its
#: label kind
SWEEP = {
    "regression sqrt": ({"objective": "regression", "reg_sqrt": True},
                        "real"),
    "huber": ({"objective": "huber"}, "real"),
    "fair": ({"objective": "fair"}, "real"),
    "quantile": ({"objective": "quantile", "alpha": 0.7}, "real"),
    "mape": ({"objective": "mape"}, "mape"),
    "gamma": ({"objective": "gamma"}, "positive"),
    "tweedie": ({"objective": "tweedie"}, "count"),
    "multiclassova": ({"objective": "multiclassova", "num_class": 3},
                      "class"),
    "cross_entropy": ({"objective": "cross_entropy"}, "unit"),
    "cross_entropy_lambda": ({"objective": "cross_entropy_lambda"},
                             "unit"),
}


@pytest.mark.parametrize("name", list(SWEEP))
def test_every_other_objective_trains_downhill(name):
    params, kind = SWEEP[name]
    X, z = _data()
    y = _label(kind, z)
    ds = tlgb.Dataset(X, label=y)
    ev = {}
    bst = tlgb.train(dict(BASE, **params, device="cpu"),
                     ds, 5, valid_sets=[ds], evals_result=ev,
                     verbose_eval=False)
    jcfg = jlgb.Config.from_params(params)
    jmetric = JM.create_metrics(jcfg)[0].name
    (metric, values), = ev["training"].items()
    assert metric == jmetric
    assert values[-1] < values[0] and len(values) == 5
    assert bst.objective_str == jlgb.Booster._objective_to_string(
        types.SimpleNamespace(config=jcfg))
    assert bst.objective_str == _objective_to_string(
        tlgb.Config.from_params(dict(params, device="cpu")))
    k = bst.num_tree_per_iteration
    p = bst.predict(X)
    assert p.shape == ((N,) if k == 1 else (N, k)) and np.isfinite(p).all()
