"""The port's objectives and leaf percentiles against the JAX package's.

Every ported objective gets the same seeded labels (with and without row
weights) and raw scores in both packages: gradients, hessians,
``boost_from_score`` and ``convert_output`` are held equal.  The JAX
gradients run compiled (``jax.jit``), as training runs them.

* Bit for bit where no transcendental function enters: L2 with and
  without ``reg_sqrt``, L1, huber, fair, quantile and MAPE.  None of
  these has a multiply feeding an add, so XLA's CPU backend contracts
  nothing into an FMA and no ulp of slack is needed.
* Within 1e-6 relative for poisson, gamma, tweedie, both multiclass
  objectives and both cross-entropies, each element against its own
  magnitude or, where terms cancel, against the array's largest:
  XLA's ``exp``/``log1p``/logistic and torch's differ in the last bit,
  XLA contracts the multiply-adds of tweedie's and the weighted
  cross_entropy_lambda's hessians into FMAs, and those hessians
  subtract such values.
* ``boost_from_score`` is numpy on the host in both packages: equal.

``leaf_percentiles`` (the renewing objectives' leaf refit) is held bit
for bit against the JAX function called op by op, weighted and
unweighted, over empty leaves, negative leaf ids, one-row leaves and
residuals that tie with unequal weights.  XLA's sort is not stable, so
tied rows might carry their weights in another order than the port's
stable sorts; at these sizes its CPU sort keeps them in row order, so
the weighted running sums agree to the bit.  Compiled, XLA contracts
the interpolation ``lo * (1 - t) + hi * t`` (and, weighted, the
threshold ``alpha * total - c``) into FMAs: the compiled function is
held within 4 ulps of the largest result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import objectives as JO
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.ops.percentile import leaf_percentiles as j_percentiles
from lightgbm_tpu_torch import objectives as TO
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.ops.percentile import leaf_percentiles

N = 1500

#: objective -> (extra params, label kind, bit for bit)
CASES = {
    "regression": ({}, "real", True),
    "regression sqrt": ({"objective": "regression", "reg_sqrt": True},
                        "real", True),
    "regression_l1": ({}, "real", True),
    "huber": ({"alpha": 1.3}, "real", True),
    "fair": ({"fair_c": 0.7}, "real", True),
    "quantile": ({"alpha": 0.3}, "real", True),
    "mape": ({}, "real", True),
    "poisson": ({"poisson_max_delta_step": 0.5}, "count", False),
    "gamma": ({}, "positive", False),
    "tweedie": ({"tweedie_variance_power": 1.3}, "count", False),
    "multiclass": ({"num_class": 4}, "class", False),
    "multiclassova": ({"num_class": 4, "sigmoid": 1.3}, "class", False),
    "cross_entropy": ({}, "unit", False),
    "cross_entropy_lambda": ({}, "unit", False),
}


def _labels(kind, rng):
    z = rng.randn(N)
    return {"real": 3.0 * z + 0.5,
            "count": rng.poisson(np.exp(0.5 * z)).astype(float),
            "positive": np.exp(0.5 * z) + 0.1,
            "class": rng.randint(0, 4, N).astype(float),
            "unit": 1.0 / (1.0 + np.exp(-2.0 * z))}[kind]


def _pair(name, weighted):
    extra, kind, exact = CASES[name]
    params = dict({"objective": name.split()[0]}, **extra)
    rng = np.random.RandomState(11)
    y = _labels(kind, rng)
    w = rng.uniform(0.2, 2.0, N) if weighted else None
    jm, tm = JMetadata(N), TMetadata(N)
    for m in (jm, tm):
        m.set_label(y)
        m.set_weight(w)
    jo = JO.create_objective(jlgb.Config.from_params(params))
    to = TO.create_objective(tlgb.Config.from_params(dict(params,
                                                          device="cpu")))
    jo.init(jm, N)
    to.init(tm, N, torch.device("cpu"))
    K = to.num_model_per_iteration
    shape = (N,) if K == 1 else (N, K)
    score = (rng.randn(*shape) * 0.8).astype(np.float32)
    return jo, to, score, exact


def _close(got, want, exact, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if exact:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), what)
    else:
        np.testing.assert_allclose(
            got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()),
            err_msg=what)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_gradients_and_hessians(name, weighted):
    jo, to, score, exact = _pair(name, weighted)
    jg, jh = jax.jit(jo.get_gradients)(jnp.asarray(score))
    tg, th = to.get_gradients(torch.from_numpy(score))
    _close(tg.numpy(), jg, exact, f"{name} gradients")
    _close(th.numpy(), jh, exact, f"{name} hessians")
    assert to.num_model_per_iteration == jo.num_model_per_iteration
    for flag in ("is_constant_hessian", "is_renew_tree_output",
                 "renew_alpha"):
        assert getattr(to, flag) == getattr(jo, flag), flag


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_boost_from_score_and_output(name, weighted):
    jo, to, score, exact = _pair(name, weighted)
    assert to.boost_from_score() == jo.boost_from_score()
    _close(to.convert_output(torch.from_numpy(score)).numpy(),
           jo.convert_output(jnp.asarray(score)), exact,
           f"{name} convert_output")


def test_lambdarank_is_not_ported():
    """Lambdarank is ported now (the test keeps its id): the factory
    builds it as the JAX package does, with its stochastic-rounding
    flag, and its gradients over three queries match (bit for bit
    apart from the ``log``/``exp`` last bits, tests/test_torch_
    lambdarank.py)."""
    params = {"objective": "lambdarank", "sigmoid": 1.5}
    jo = JO.create_objective(jlgb.Config.from_params(params))
    to = TO.create_objective(tlgb.Config.from_params(dict(params,
                                                          device="cpu")))
    assert type(to).__name__ == type(jo).__name__ == "LambdarankNDCG"
    assert to.need_stochastic_quant and jo.need_stochastic_quant
    assert to.sigmoid == jo.sigmoid == 1.5
    np.testing.assert_array_equal(to.label_gain, jo.label_gain)
    n, sizes = 30, [12, 1, 17]
    rng = np.random.RandomState(4)
    label = rng.randint(0, 4, n).astype(np.float32)
    score = rng.randn(n).astype(np.float32)
    jm, tm = JMetadata(n), TMetadata(n)
    for m in (jm, tm):
        m.set_label(label)
        m.set_group(sizes)
    jo.init(jm, n)
    to.init(tm, n, torch.device("cpu"))
    jg, jh = jax.jit(jo.get_gradients)(jnp.asarray(score))
    tg, th = to.get_gradients(torch.from_numpy(score))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jh)).max())


def _percentile_case(seed, ties):
    """Residuals (rounded to halves when ``ties``, so many rows of a
    leaf tie), leaf ids with negative ids, an empty leaf (3), one-row
    leaves (5 and 6) and unequal weights."""
    rng = np.random.RandomState(seed)
    n, L = 1200, 9
    r = (rng.randn(n) * 2).astype(np.float32)
    if ties:
        r = (np.round(r * 2) / 2).astype(np.float32)
    lid = rng.choice([-1, 0, 1, 2, 4, 7, 8], n).astype(np.int32)
    lid[[17, 400]] = [5, 6]
    w = rng.choice([0.25, 0.5, 1.0, 3.0], n).astype(np.float32)
    return r, lid, L, w


@pytest.mark.parametrize("alpha", [0.5, 0.1, 0.77])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_leaf_percentiles_bit_for_bit(alpha, weighted, ties):
    r, lid, L, w = _percentile_case(3, ties)
    ww = w if weighted else None
    want = np.asarray(j_percentiles(
        jnp.asarray(r), jnp.asarray(lid), L, alpha,
        None if ww is None else jnp.asarray(ww)))
    got = leaf_percentiles(torch.from_numpy(r), torch.from_numpy(lid), L,
                           alpha, None if ww is None else torch.from_numpy(ww))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert got[3] == 0.0                      # the empty leaf
    assert got[5] == r[17] and got[6] == r[400]   # one-row leaves


@pytest.mark.parametrize("weighted", [False, True])
def test_leaf_percentiles_against_the_compiled_function(weighted):
    r, lid, L, w = _percentile_case(4, False)
    ww = w if weighted else None
    fn = jax.jit(j_percentiles, static_argnums=(2, 3))
    want = np.asarray(fn(jnp.asarray(r), jnp.asarray(lid), L, 0.5,
                         None if ww is None else jnp.asarray(ww)))
    got = leaf_percentiles(torch.from_numpy(r), torch.from_numpy(lid), L,
                           0.5, None if ww is None else torch.from_numpy(ww))
    ulp = np.spacing(np.abs(want).max().astype(np.float32))
    assert (np.abs(got.numpy() - want) <= 4 * ulp).all()
