"""The port's threefry streams (lightgbm_tpu_torch/utils/prng.py) against
``jax.random`` bit for bit, on the installed jax's defaults
(``threefry2x32`` with ``jax_threefry_partitionable``): keys from seeds,
``split``, ``fold_in`` with the stochastic-rounding tag and class
indices, and ``uniform`` over shapes of odd and even length, two
dimensions, and the padded row count of a training set, which both
packages' growers compute alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.utils import prng

SEEDS = [0, 1, 2**31 - 2]


def _same_key(jkey, tkey):
    np.testing.assert_array_equal(np.asarray(jkey).astype(np.int64),
                                  tkey.numpy())


def test_installed_jax_defaults():
    """The layout the port follows; a jax whose defaults differ needs
    the port changed with it."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_from_seed(seed):
    _same_key(jax.random.PRNGKey(seed), prng.PRNGKey(seed))


@pytest.mark.parametrize("num", [2, 3, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, num):
    _same_key(jax.random.split(jax.random.PRNGKey(seed), num),
              prng.split(prng.PRNGKey(seed), num))


@pytest.mark.parametrize("data", [0, 1, 2, 0x51AB, 2**32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    tk = prng.fold_in(prng.PRNGKey(seed), data)
    _same_key(jk, tk)
    # the per-class keys of the stochastic rounding: fold_in twice
    for k in range(3):
        _same_key(jax.random.fold_in(jk, k), prng.fold_in(tk, k))


def _padded_rows():
    """A training set's padded row count, taken from the port's grower."""
    X = np.random.RandomState(0).randn(3001, 5)
    bst = tlgb.train({"objective": "regression", "device": "cpu",
                      "verbose": -1, "num_leaves": 4},
                     tlgb.Dataset(X, label=X[:, 0]), 1,
                     keep_training_booster=True)
    return bst.gbdt.grower.n_padded


@pytest.mark.parametrize("shape", [(1,), (7,), (128,), (3, 5), "n_padded"])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed, shape):
    if shape == "n_padded":
        shape = (_padded_rows(),)
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    # from the root key and from the halves the bagging step splits
    for a, b in [(jk, tk)] + list(zip(jax.random.split(jk),
                                      prng.split(tk))):
        ju = np.asarray(jax.random.uniform(a, shape))
        tu = prng.uniform(b, shape).numpy()
        assert tu.dtype == np.float32 and tu.shape == ju.shape
        assert tu.tobytes() == ju.tobytes()
        assert tu.min() >= 0.0 and tu.max() < 1.0


def test_random_bits():
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    jb = np.asarray(jax.random.bits(jk, (33,), dtype=jnp.uint32))
    np.testing.assert_array_equal(jb.astype(np.int64),
                                  prng.random_bits(tk, (33,)).numpy())


def test_negative_seed_is_refused():
    with pytest.raises(ValueError, match="non-negative"):
        prng.PRNGKey(-1)


@pytest.mark.parametrize("n,dtype", [(1000, "float32"), (3001, "bfloat16"),
                                     (20000, "bfloat16")])
def test_padded_rows_match_the_jax_grower(n, dtype):
    """The bag's uniforms are drawn over the padded rows: both growers
    must pad a training set to the same count, or the draws land on
    other rows."""
    X = np.random.RandomState(1).randn(n, 6)
    params = {"objective": "regression", "verbose": -1, "num_leaves": 4,
              "hist_compute_dtype": dtype, "max_bin": 63}
    jb = jlgb.train(dict(params, compile_cache_dir=""),
                    jlgb.Dataset(X, label=X[:, 0]), 1,
                    keep_training_booster=True)
    tb = tlgb.train(dict(params, device="cpu"),
                    tlgb.Dataset(X, label=X[:, 0]), 1,
                    keep_training_booster=True)
    assert tb.gbdt.grower.n_padded == jb.gbdt.grower.n_padded >= n


def test_draws_on_another_device_keep_the_key_on_the_host():
    """A key never leaves the host: a draw names its device."""
    k = prng.PRNGKey(3)
    assert k.device.type == "cpu"
    u = prng.uniform(prng.split(k)[1], (10,), torch.device("cpu"))
    assert u.device.type == "cpu"
