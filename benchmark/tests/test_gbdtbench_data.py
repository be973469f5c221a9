"""The inputs: the same seed gives the same rows, query sizes and model
text; another seed gives other rows of the same concept."""
import json
import os

import numpy as np
import torch
from conftest import BENCH
from gbdtbench import data as D


def _cfg(name):
    return json.load(open(os.path.join(BENCH, "configs", name + ".json")))


def test_binary_rows_repeat_by_seed():
    cfg = _cfg("higgs")
    a = D.make_rows(cfg, 2 ** 33 + 5, "cpu", rows=3000)
    b = D.make_rows(cfg, 2 ** 33 + 5, "cpu", rows=3000)
    c = D.make_rows(cfg, 2 ** 33 + 6, "cpu", rows=3000)
    assert torch.equal(a["X"], b["X"]) and torch.equal(a["y"], b["y"])
    assert not torch.equal(a["X"], c["X"])
    assert a["X"].shape == (3000, 28) and set(a["y"].unique().tolist()) \
        == {0.0, 1.0}


def test_ranking_rows_repeat_by_seed():
    cfg = _cfg("mslr")
    a = D.make_rows(cfg, 11, "cpu", rows=2400)
    b = D.make_rows(cfg, 11, "cpu", rows=2400)
    assert np.array_equal(a["group"], b["group"])
    assert torch.equal(a["X"], b["X"]) and torch.equal(a["y"], b["y"])
    assert a["group"].min() >= 60 and a["group"].max() <= 180
    assert a["X"].shape == (int(a["group"].sum()), 136)
    assert set(a["y"].unique().tolist()) <= {0.0, 1.0, 2.0, 3.0, 4.0}


def test_model_text_repeats_and_parses():
    from reference import model_text as MT
    cfg = _cfg("higgs")
    X = D.score_rows(cfg, 3, 4000, 1, "cpu")[0]
    edges = D.bin_edges(X, 63)
    model = {"trees": 3, "num_leaves": 31, "leaf_scale": 0.1}
    t1 = D.random_model_text(cfg, model, edges, 3)
    assert t1 == D.random_model_text(cfg, model, edges, 3)
    assert t1 != D.random_model_text(cfg, model, edges, 4)
    trees = MT.parse(t1)
    assert [t["num_leaves"] for t in trees] == [31, 31, 31]
    for t in trees:
        # every node reached once: 30 internal nodes, 31 leaves
        kids = np.concatenate([t["left_child"], t["right_child"]])
        assert sorted(kids[kids >= 0].tolist()) == list(range(1, 30))
        assert sorted((~kids[kids < 0]).tolist()) == list(range(31))
