"""The port's metrics against the JAX package's.

Every ported metric evaluates the same seeded labels, row weights (with
and without) and raw scores in both packages, through the objective's
output transform where the training loop passes one, and the values
agree within 1e-6 relative: both sum in f32, in different orders, and
XLA's ``log``/``exp`` and torch's differ in the last bit.  The default
metric of each objective, the registry's aliases and the names a config
resolves to are the JAX package's.
"""
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

N = 1200

#: metric -> (objective whose transform the loop applies, its params,
#: label kind)
CASES = {
    "l2": ("regression", {}, "real"),
    "rmse": ("regression", {"reg_sqrt": True}, "real"),
    "l1": ("regression_l1", {}, "real"),
    "quantile": ("quantile", {"alpha": 0.3}, "real"),
    "huber": ("huber", {"alpha": 1.3}, "real"),
    "fair": ("fair", {"fair_c": 0.7}, "real"),
    "poisson": ("poisson", {}, "count"),
    "mape": ("mape", {}, "real"),
    "gamma": ("gamma", {}, "positive"),
    "gamma-deviance": ("gamma", {}, "positive"),
    "tweedie": ("tweedie", {"tweedie_variance_power": 1.3}, "count"),
    "binary_logloss": ("binary", {"sigmoid": 0.8}, "binary"),
    "binary_error": ("binary", {}, "binary"),
    "auc": ("binary", {}, "binary"),
    "multi_logloss": ("multiclass", {"num_class": 4}, "class"),
    "multi_logloss ova": ("multiclassova", {"num_class": 4}, "class"),
    "multi_error": ("multiclass", {"num_class": 4}, "class"),
    "cross_entropy": ("cross_entropy", {}, "unit"),
    "cross_entropy_lambda": ("cross_entropy_lambda", {}, "unit"),
    "kldiv": ("cross_entropy", {}, "unit"),
}


def _labels(kind, rng):
    z = rng.randn(N)
    return {"real": 3.0 * z + 0.5,
            "count": rng.poisson(np.exp(0.5 * z)).astype(float),
            "positive": np.exp(0.5 * z) + 0.1,
            "binary": (z > 0).astype(float),
            "class": rng.randint(0, 4, N).astype(float),
            "unit": 1.0 / (1.0 + np.exp(-2.0 * z))}[kind]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_metric_matches_reference(case, weighted):
    name = case.split()[0]
    objective, extra, kind = CASES[case]
    params = dict({"objective": objective, "metric": [name]}, **extra)
    rng = np.random.RandomState(5)
    y = _labels(kind, rng)
    w = rng.uniform(0.2, 2.0, N) if weighted else None
    jcfg = jlgb.Config.from_params(params)
    tcfg = tlgb.Config.from_params(dict(params, device="cpu"))
    jm, tm = JMetadata(N), TMetadata(N)
    for m in (jm, tm):
        m.set_label(y)
        m.set_weight(w)
    jo, to = JO.create_objective(jcfg), TO.create_objective(tcfg)
    jo.init(jm, N)
    to.init(tm, N, torch.device("cpu"))
    K = to.num_model_per_iteration
    score = (rng.randn(*((N,) if K == 1 else (N, K))) * 0.8
             + 0.3).astype(np.float32)
    (jmet,), (tmet,) = JM.create_metrics(jcfg), TM.create_metrics(tcfg)
    assert type(tmet).__name__ == type(jmet).__name__
    assert tmet.names() == jmet.names()
    assert tmet.bigger_is_better == jmet.bigger_is_better
    jmet.init(jm, N)
    tmet.init(tm, N, torch.device("cpu"))
    want = jmet.eval(jnp.asarray(score), jo)
    got = tmet.eval(torch.from_numpy(score), to)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_default_metric_table():
    assert TM.DEFAULT_METRIC_FOR_OBJECTIVE == \
        JM._DEFAULT_METRIC_FOR_OBJECTIVE
    assert {k: v.__name__ for k, v in TM._METRIC_REGISTRY.items()} == {
        k: v.__name__ for k, v in JM._METRIC_REGISTRY.items()}


@pytest.mark.parametrize("objective", sorted(
    set(TO._OBJECTIVE_REGISTRY) | {"l2", "mae", "xentropy", "softmax"}))
def test_config_resolves_the_reference_metrics(objective):
    """An objective (or an alias of one) with no metric named gets the
    JAX package's default metric."""
    params = {"objective": objective}
    if objective in ("multiclass", "multiclassova", "softmax"):
        params["num_class"] = 3
    jnames = [m.name for m in JM.create_metrics(
        jlgb.Config.from_params(params))]
    tnames = [m.name for m in TM.create_metrics(
        tlgb.Config.from_params(dict(params, device="cpu")))]
    assert tnames == jnames and len(tnames) == 1
