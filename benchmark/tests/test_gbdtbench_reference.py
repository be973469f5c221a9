"""The port at a tiny size on the CPU, held to the plain reference layer
by layer: the bin bounds and matrix, the gradients, a root histogram,
the grown trees' splits and leaf values, and scoring from a model
text."""
import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb
from conftest import BENCH
from gbdtbench import data as D
from reference import binning as RB
from reference import gbdt as RG
from reference import model_text as MT
from reference import objectives as RO

CFG = {"learning_rate": 0.1, "num_leaves": 31, "lambda_l2": 0.0,
       "min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 5.0}


def _config(name):
    return json.load(open(os.path.join(BENCH, "configs", name + ".json")))


def _rows(n=6000, seed=3):
    r = D.make_rows(_config("higgs"), seed, "cpu", rows=n)
    return r["X"].double().numpy(), r["y"].numpy()


@pytest.mark.parametrize("n,max_bin,sample", [(5000, 63, 200000),
                                              (30000, 15, 20000),
                                              (12000, 255, 5000)])
def test_bins_match(n, max_bin, sample):
    X, y = _rows(n)
    X[:, 3] = np.round(X[:, 3] * 4) / 4        # few distinct values
    X[::7, 5] = 0.0                            # zeros
    params = {"max_bin": max_bin, "bin_construct_sample_cnt": sample,
              "device": "cpu", "verbose": -1}
    core = lgb.Dataset(X, label=y, params=params).construct()
    want = RB.bin_bounds(X, max_bin, 3, sample, 1)
    for m, b in zip(core.mappers, want):
        assert np.array_equal(m.bin_upper_bound, b)
    bins = RB.bin_matrix(torch.as_tensor(X), want).numpy()
    assert np.array_equal(core.logical_group_bins(), bins)


def test_binary_gradients_match():
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.objectives import create_objective
    X, y = _rows(2000)
    md = Metadata(len(y))
    md.set_label(y)
    obj = create_objective(Config.from_params({"objective": "binary"}))
    obj.init(md, len(y), torch.device("cpu"))
    score = torch.randn(len(y), dtype=torch.float32)
    g, h = obj.get_gradients(score)
    rg, rh = RO.binary_gradients(score.double(), torch.as_tensor(y))
    assert torch.allclose(g.double(), rg, rtol=1e-6, atol=1e-7)
    assert torch.allclose(h.double(), rh, rtol=1e-6, atol=1e-7)


def test_lambdarank_gradients_match():
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.objectives import create_objective
    r = D.make_rows(_config("mslr"), 5, "cpu", rows=3000)
    y, sizes = r["y"].numpy(), r["group"]
    md = Metadata(len(y))
    md.set_label(y)
    md.set_group(sizes)
    obj = create_objective(Config.from_params({"objective": "lambdarank"}))
    obj.init(md, len(y), torch.device("cpu"))
    score = torch.randn(len(y), dtype=torch.float32)
    g, h = obj.get_gradients(score)
    rg, rh = RO.Lambdarank(y, sizes, "cpu").gradients(score.double())
    scale = rg.abs().max()
    assert float((g.double() - rg).abs().max() / scale) < 1e-5
    assert float((h.double() - rh).abs().max() / rh.abs().max()) < 1e-5


def test_root_histogram_matches():
    from lightgbm_tpu_torch.ops.histogram import compute_group_histograms
    X, y = _rows(4096)
    bounds = RB.bin_bounds(X, 63, 3, 200000, 1)
    bins = RB.bin_matrix(torch.as_tensor(X), bounds)
    g = torch.randn(len(y), dtype=torch.float64)
    h = torch.rand(len(y), dtype=torch.float64)
    port = compute_group_histograms(
        bins.contiguous(), g.float(), h.float(), torch.ones(len(y)),
        torch.zeros(len(y), dtype=torch.int32), num_leaves=1,
        max_group_bin=64)
    ref = RG._hist(bins, torch.arange(len(y)), torch.zeros(len(y),
                                                          dtype=torch.long),
                   1, g, h, 64)
    assert torch.allclose(port.double().reshape(ref.shape), ref,
                          rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("extra", [{}, {"objective": "lambdarank"}])
def test_grown_trees_follow_the_reference(extra):
    if extra:
        r = D.make_rows(_config("mslr"), 4, "cpu", rows=4000)
        X, y, group = r["X"].double().numpy(), r["y"].numpy(), r["group"]
        grad = RO.Lambdarank(y, group, "cpu").gradients
    else:
        X, y = _rows(8000)
        group = None
        yd = torch.as_tensor(y)

        def grad(s):
            return RO.binary_gradients(s, yd)
    params = {"objective": "binary", "max_bin": 63, "num_leaves": 31,
              "min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 5.0,
              "device": "cpu", "verbose": -1, **extra}
    bst = lgb.train(params, lgb.Dataset(X, label=y, group=group,
                                        params=params), 3)
    trees = MT.parse(bst.model_to_string())
    Xd = torch.as_tensor(X)
    bounds = RB.bin_bounds(X, 63, 3, 200000, 1)
    got = RG.judge(Xd, RB.bin_matrix(Xd, bounds), bounds, grad, trees, CFG)
    assert got["split_regret"] < 1e-6
    assert got["leaf_gap_median"] < 1e-5
    assert got["leaf_shortfall"] == 0
    assert got["frontier_regret"] < 1e-6


def test_reference_grower_is_its_own_judge():
    X, y = _rows(6000)
    Xd, yd = torch.as_tensor(X), torch.as_tensor(y)
    bounds = RB.bin_bounds(X, 63, 3, 200000, 1)
    bins = RB.bin_matrix(Xd, bounds)
    g, h = RO.binary_gradients(torch.zeros(len(y), dtype=torch.float64), yd)
    tree = RG.grow(bins, bounds, g, h, CFG)
    assert tree["num_leaves"] == 31
    got = RG.judge(Xd, bins, bounds, lambda s: RO.binary_gradients(s, yd),
                   [tree], CFG)
    assert got["split_regret"] == 0.0 and got["leaf_gap"] < 1e-12
    assert got["leaf_shortfall"] == 0 and got["frontier_regret"] == 0.0
    # judged against a larger leaf budget, the same tree is short
    short = RG.judge(Xd, bins, bounds, lambda s: RO.binary_gradients(s, yd),
                     [tree], dict(CFG, num_leaves=63))
    assert short["leaf_shortfall"] == 32


def test_node_rounds():
    # node 0 splits first, its children 1 and 2 together next, then 3,
    # a child of 1; each leaf was made by the node that holds it
    tree = {"num_leaves": 5,
            "left_child": np.array([1, 3, ~2, ~0]),
            "right_child": np.array([2, ~1, ~3, ~4])}
    rounds, maker = RG.node_rounds(tree)
    assert rounds.tolist() == [0, 1, 1, 2]
    assert maker.tolist() == [3, 1, 2, 2, 3]


def test_scores_match_predict():
    X, y = _rows(5000)
    params = {"objective": "binary", "num_leaves": 15, "device": "cpu",
              "verbose": -1}
    bst = lgb.train(params, lgb.Dataset(X, label=y, params=params), 5)
    text = bst.model_to_string()
    port = lgb.Booster(params={"device": "cpu", "verbose": -1},
                       model_str=text).predict(X[:700], raw_score=True)
    ref = MT.raw_scores(torch.as_tensor(X[:700]), MT.parse(text)).numpy()
    assert np.abs(port - ref).max() < 1e-5
