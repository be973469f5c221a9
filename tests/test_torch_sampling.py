"""Bagging, GOSS, DART and RF in the port against the JAX package, and the
stochastic int8 rounding.

Each case trains a binary model of a few trees in both packages on the
same seeded rows (the JAX side on its quantized main-path plan, Pallas in
interpret mode on the CPU), one iteration at a time, and holds:

* the random streams bit for bit after every iteration: the bag mask of
  the objective path (``_bag_state``), the bag mask and key of the
  custom-gradient path (``_bag_mask``, ``_bag_rng``), GOSS's host key,
  DART's drop list, its shrinkage and every tree's scale;
* the first tree bit for bit, and every tree's structure (split
  features, thresholds, child links, leaf and node counts, the missing
  types; the default-left bit is not compared, see tests/test_torch_
  train.py), and the leaf every training row lands in;
* the model text line for line but for the lines of f32 sums
  (``split_gain``, ``leaf_value``, ``leaf_weight``, ``internal_value``,
  ``internal_weight``, ``tree_sizes``) and ``decision_type``: the
  ``shrinkage`` lines carry DART's rescales;
* every tree's leaf values within 1e-4 of its largest: from the second
  tree on the sigmoid's ``exp`` differs in the last bit between the two
  packages (ROADMAP queue 3), which moves leaf values by ~1e-7 and, where
  a weight lies that close to an int8 rounding step (stochastic rounding)
  or a row's |g*h| to GOSS's k-th score, a leaf by one quantum;
* ``Booster.predict`` within 1e-6 (1e-5 for GOSS, whose amplification
  of the sampled rows' weights by (n - top_k) / other_k = 8 scales that
  noise).

With stochastic rounding on the objective path, the fifth tree's
rounding of one weight falls the other way (the ``exp`` again), and a
threshold moves across bins that hold no training row: there the
thresholds are not compared, the rows' leaves are.

Byte-for-byte model text is out of reach on these paths for the reasons
ROADMAP queue 3 gives (the ``exp``, and the FMAs XLA contracts in the
JAX package's compiled split gains and score updates); what is random is
held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops.histogram import quantize_gradients as j_quantize
from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.ops.histogram import quantize_gradients
from lightgbm_tpu_torch.utils import prng

ROUNDS = 5
PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "verbose": -1, "min_data_in_leaf": 5, "quantized_grad": True,
          "hist_compute_dtype": "bfloat16"}
BAG = {"bagging_fraction": 0.7, "bagging_freq": 2, "feature_fraction": 0.8}
DART = {"boosting_type": "dart", "drop_rate": 0.5, "skip_drop": 0.0}
GOSS = {"boosting_type": "goss", "learning_rate": 0.5, "top_rate": 0.2,
        "other_rate": 0.1}
RF = {"boosting_type": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
      "feature_fraction": 0.8}
#: case -> (extra params, custom gradients, flush after iteration 3)
CASES = {
    "bagging": (BAG, False, False),
    "bagging, stochastic rounding": (
        {"bagging_fraction": 0.5, "bagging_freq": 1,
         "quant_stochastic_rounding": 1}, False, False),
    "bagging, fobj": (BAG, True, False),
    "bagging, fobj, stochastic rounding": (
        dict(BAG, quant_stochastic_rounding=1), True, False),
    "goss": (GOSS, False, False),
    "goss, fobj": (GOSS, True, False),
    "dart": (DART, False, False),
    "dart, flushed mid-run": (DART, False, True),
    "dart, xgboost mode": (dict(DART, xgboost_dart_mode=True), False, False),
    "dart, uniform drop": (dict(DART, uniform_drop=True, max_drop=2),
                           False, False),
    "rf": (RF, False, False),
}
#: cases whose thresholds may move across empty bins (see above)
LOOSE_THRESHOLDS = {"bagging, stochastic rounding"}
FLOAT_LINES = ("split_gain=", "leaf_value=", "leaf_weight=",
               "internal_value=", "internal_weight=", "tree_sizes=",
               "decision_type=")


def _data(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[rng.rand(n, 8) < 0.05] = np.nan
    y = (X[:, 0] - 0.5 * np.nan_to_num(X[:, 1]) + 0.3 * rng.randn(n)
         > 0).astype(float)
    return X, y


def _fobj(y):
    def fobj(score, _ds):
        p = 1.0 / (1.0 + np.exp(-np.asarray(score, np.float64)))
        return (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)
    return fobj


def _streams(gbdt):
    """The random state after an iteration, as numpy (None if absent)."""
    def arr(v):
        return None if v is None else np.asarray(
            v.cpu() if isinstance(v, torch.Tensor) else v)
    out = {k: arr(getattr(gbdt, k, None))
           for k in ("_bag_state", "_bag_mask", "_bag_rng", "_goss_key")}
    for k in ("_bag_rng", "_goss_key"):       # uint32 words either way
        if out[k] is not None:
            out[k] = out[k].astype(np.int64)
    out["drop_index"] = list(getattr(gbdt, "drop_index", []))
    out["shrinkage_rate"] = gbdt.shrinkage_rate
    out["tree_scale"] = list(gbdt._tree_scale)
    return out


_RUNS = {}


def _run(case):
    if case in _RUNS:
        return _RUNS[case]
    extra, custom, flush = CASES[case]
    X, y = _data()
    fobj = _fobj(y) if custom else None
    out = {"X": X}
    for side, pkg, more in (
            ("jax", jlgb, {"force_pallas_interpret": True,
                           "compile_cache_dir": ""}),
            ("port", tlgb, {"device": "cpu"})):
        bst = pkg.train(dict(PARAMS, **extra, **more),
                        pkg.Dataset(X, label=y), 1, fobj=fobj,
                        keep_training_booster=True)
        streams = [_streams(bst.gbdt)]
        for it in range(1, ROUNDS):
            bst.update(fobj=fobj)
            streams.append(_streams(bst.gbdt))
            if flush and it == 2:
                assert bst.num_trees() == 3       # reads the trees
        assert bst.num_trees() == ROUNDS          # both flush here
        out[side] = bst
        out[side + " streams"] = streams
    _RUNS[case] = out
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_random_streams_are_bit_exact(case):
    r = _run(case)
    for it, (js, ts) in enumerate(zip(r["jax streams"], r["port streams"])):
        for key in js:
            if isinstance(js[key], np.ndarray) or isinstance(
                    ts[key], np.ndarray):
                assert (js[key] is None) == (ts[key] is None), (it, key)
                if js[key] is not None:
                    np.testing.assert_array_equal(ts[key], js[key],
                                                  f"{key}, iteration {it}")
            else:
                assert ts[key] == js[key], (it, key)
    if case.startswith("dart"):
        assert any(s["drop_index"] for s in r["port streams"])
    if case.startswith("bagging"):
        masks = [s["_bag_mask" if "fobj" in case else "_bag_state"]
                 for s in r["port streams"]]
        n = r["X"].shape[0]
        share = masks[0][:n].mean()
        assert abs(share - CASES[case][0]["bagging_fraction"]) < 0.05
        assert not masks[0][n:].any()          # padded rows never in


@pytest.mark.parametrize("case", list(CASES))
def test_trees_match(case):
    r = _run(case)
    jm, tm = r["jax"].models, r["port"].models
    assert len(jm) == len(tm) == ROUNDS
    for i, (jt, tt) in enumerate(zip(jm, tm)):
        assert jt.num_leaves == tt.num_leaves
        fields = ["split_feature", "left_child", "right_child",
                  "leaf_count", "internal_count"]
        if case not in LOOSE_THRESHOLDS:
            fields.append("threshold")
        if i == 0:
            fields += ["leaf_value", "internal_value", "decision_type"]
        for f in fields:
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f),
                                          f"tree {i} {f}")
        np.testing.assert_array_equal(jt.decision_type & ~2,
                                      tt.decision_type & ~2)
        scale = np.abs(jt.leaf_value).max()
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=0,
                                   atol=1e-4 * scale, err_msg=f"tree {i}")
        assert tt.shrinkage == jt.shrinkage, f"tree {i}"
    X = r["X"]
    np.testing.assert_array_equal(r["port"].predict(X, pred_leaf=True),
                                  r["jax"].predict(X, pred_leaf=True))


@pytest.mark.parametrize("case", list(CASES))
def test_model_text_and_predictions(case):
    r = _run(case)
    skip = FLOAT_LINES + (("threshold=",) if case in LOOSE_THRESHOLDS
                          else ())
    jt = [ln for ln in r["jax"].model_to_string().splitlines()
          if not ln.startswith(skip)]
    tt = [ln for ln in r["port"].model_to_string().splitlines()
          if not ln.startswith(skip)]
    assert tt == jt
    X = r["X"]
    np.testing.assert_allclose(r["port"].predict(X),
                               r["jax"].predict(X, device=False), rtol=0,
                               atol=1e-5 if case.startswith("goss") else 1e-6)


def test_rf_averages_converted_leaves():
    r = _run("rf")
    bst, X = r["port"], r["X"]
    assert "average_output" in bst.model_to_string().splitlines()
    host = np.mean([t.predict(X) for t in bst.models], axis=0)
    np.testing.assert_allclose(bst.predict(X), host, rtol=0, atol=1e-6)
    # leaves are probabilities (sigmoid of the fitted value)
    assert all(((t.leaf_value > 0) & (t.leaf_value < 1)).all()
               for t in bst.models)


def test_rf_metrics_skip_the_transform():
    X, y = _data()
    Xv, yv = _data(1000, 1)
    evals = {}
    for side, pkg, more in (
            ("jax", jlgb, {"force_pallas_interpret": True,
                           "compile_cache_dir": ""}),
            ("port", tlgb, {"device": "cpu"})):
        d = pkg.Dataset(X, label=y)
        evals[side] = {}
        pkg.train(dict(PARAMS, metric="binary_logloss", **RF, **more), d, 3,
                  valid_sets=[pkg.Dataset(Xv, label=yv, reference=d)],
                  evals_result=evals[side], verbose_eval=False)
    got = evals["port"]["valid_0"]["binary_logloss"]
    want = evals["jax"]["valid_0"]["binary_logloss"]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < 0.6


@pytest.mark.parametrize("classes", [1, 3])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2])
def test_quantize_gradients_with_a_key(seed, classes):
    """Stochastic int8 rounding bit for bit against the JAX function, on
    long-tailed gradients (a few large, most far below a step), with
    the fused path's per-class keys."""
    rng = np.random.RandomState(seed % 1000)
    n = 5000
    g = (rng.standard_cauchy(n) * 1e-3).astype(np.float32)
    h = np.abs(rng.randn(n)).astype(np.float32) * 0.01
    c = (rng.rand(n) < 0.7).astype(np.float32)
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 0x51AB)
    tk = prng.fold_in(prng.PRNGKey(seed), 0x51AB)
    for k in range(classes):
        jw, js = j_quantize(jnp.asarray(g), jnp.asarray(h), jnp.asarray(c),
                            key=jax.random.fold_in(jk, k))
        tw, ts = quantize_gradients(torch.from_numpy(g), torch.from_numpy(h),
                                    torch.from_numpy(c),
                                    key=prng.fold_in(tk, k))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        assert np.abs(tw.numpy()[:, :2]).max() <= 127
        # stochastic, not nearest: some small gradients round away
        # from zero
        near = np.round(g / ts.numpy()[0])
        assert (tw.numpy()[:, 0] != near).any()


@pytest.mark.parametrize("ties", [False, True])
def test_goss_sample_matches(ties):
    """GOSS's keep set and scales on the same gradients and key, with
    rows out of the bag and (``ties``) many rows equal at the k-th
    score, as ``lax.top_k`` and ``>=`` keep them."""
    r = _run("goss")
    jg, tg = r["jax"].gbdt, r["port"].gbdt
    n_pad = tg.grower.n_padded
    rng = np.random.RandomState(3)
    g = rng.randn(1, n_pad).astype(np.float32)
    if ties:
        g = np.round(g * 4) / 4
    h = np.full((1, n_pad), 0.25, np.float32)
    c = np.ones(n_pad, np.float32)
    c[tg.num_data:] = 0
    c[rng.rand(n_pad) < 0.1] = 0
    jout = jg._goss_sample(jnp.asarray(g), jnp.asarray(h), jnp.asarray(c),
                           jax.random.PRNGKey(11))
    tout = tg._goss_sample(torch.from_numpy(g), torch.from_numpy(h),
                           torch.from_numpy(c), prng.PRNGKey(11))
    for j, t in zip(jout, tout):
        assert t.numpy().tobytes() == np.asarray(j).tobytes()
    kept = tout[2].numpy() > 0
    top_k = int(tg.num_data * 0.2)
    assert kept.sum() > top_k


@pytest.mark.parametrize("kind,name", [("gbdt", "GBDT"), ("goss", "GOSS"),
                                       ("dart", "DART"), ("rf", "RF")])
def test_create_boosting(kind, name):
    X, y = _data(600)
    cfg = tlgb.Config.from_params(dict(
        PARAMS, device="cpu",
        **(RF if kind == "rf" else {"boosting_type": kind})))
    core = tlgb.Dataset(X, label=y).construct(cfg)
    assert type(create_boosting(cfg, core)).__name__ == name


def test_rf_requires_bagging():
    X, y = _data(600)
    from lightgbm_tpu_torch.utils.log import LightGBMError
    with pytest.raises((LightGBMError, ValueError), match="bagging"):
        tlgb.train(dict(PARAMS, boosting_type="rf", feature_fraction=0.8,
                        device="cpu"), tlgb.Dataset(X, label=y), 1)
