"""The parallel learners on a CPU mesh (parallel/mesh.py; the grower's
row-sharded histogram and its full-frontier voting and feature rounds)
against the port's serial run and the JAX package's mesh run with the
same ``mesh_shape``.

The shards sum their f32 histograms in another order than the serial
xla plan, so, as in tests/test_parallel.py, a binary run is held to the
serial run's training logloss within 1e-3 and its predictions within
1e-2.  Against the JAX mesh run the split structure is equal and the
leaves agree within 1e-5 of the tree's largest (the xla plan's known
divergence, ROADMAP.md queue 3).  That comparison sets
``min_gain_to_split=1e-3``: on this data the second tree's last split
has a gain of 3e-5, f32 cancellation noise in both packages, and its
threshold differs between the two packages' serial runs already.

The feature learner (2 and 4 shards on the vertical partition, and the
serial fallback where 4 shards do not divide 10 groups) and the data
learner on a 2 x 2 ("data", "feature") mesh are held the same way, as
is a categorical column under the feature and the voting learner
(tests/test_torch_voting.py holds the rest of the voting learner).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.parallel import mesh as M

from torch_parallel_cases import STRUCTURE
from torch_parallel_cases import data as _data
from torch_parallel_cases import one_torch_thread  # noqa: F401
from torch_parallel_cases import params as _params
from torch_parallel_cases import structure_and_leaves as _structure_and_leaves
from torch_parallel_cases import train as _train


@pytest.fixture(scope="module")
def serial():
    X, y = _data()
    return _train(tlgb, X, y, _params("serial", device="cpu"))


@pytest.mark.parametrize("shards", [2, 4])
def test_data_learner_against_serial_and_the_jax_mesh(serial, shards):
    X, y = _data()
    mesh = {"mesh_shape": (shards,), "mesh_axes": ("data",)}
    bst, ll = _train(tlgb, X, y, _params("data", device="cpu", **mesh))
    g = bst.gbdt.grower
    assert g.sharded and g.plan.name == "xla"
    assert [hi - lo for lo, hi in g.policy.row_ranges] == \
        [g.n_padded // shards] * shards
    bst_s, ll_s = serial
    assert abs(ll - ll_s) < 1e-3
    assert np.max(np.abs(bst.predict(X[:200])
                         - bst_s.predict(X[:200]))) < 1e-2
    floor = {"min_gain_to_split": 1e-3}
    bst, ll = _train(tlgb, X, y, _params("data", device="cpu", **mesh,
                                         **floor))
    jb, jll = _train(jlgb, X, y, _params("data", **mesh, **floor))
    assert jb.gbdt.grower.policy.mesh.size == shards
    assert jb.gbdt.grower.n_padded == g.n_padded
    assert abs(ll - jll) < 1e-5
    assert len(jb.models) == len(bst.models) == 10
    for i, (jt, tt) in enumerate(zip(jb.models, bst.models)):
        assert jt.num_leaves == tt.num_leaves, i
        for f in STRUCTURE:
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f),
                                          f"tree {i} {f}")
        scale = float(np.abs(jt.leaf_value).max())
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=f"tree {i}")


def test_goss_on_the_data_mesh_against_the_jax_mesh():
    """GOSS on a 2-shard data mesh, sampling from the third tree
    (learning_rate 0.5): split for split the JAX package's GOSS on its
    2-device mesh, leaves within 1e-5 of the tree's largest (the gain
    floor of the test above)."""
    X, y = _data()
    p = {"mesh_shape": (2,), "mesh_axes": ("data",), "boosting": "goss",
         "learning_rate": 0.5, "top_rate": 0.2, "other_rate": 0.2,
         "min_gain_to_split": 1e-3}
    bst, ll = _train(tlgb, X, y, _params("data", device="cpu", **p), 6)
    jb, jll = _train(jlgb, X, y, _params("data", **p), 6)
    assert type(bst.gbdt).__name__ == type(jb.gbdt).__name__ == "GOSS"
    assert bst.gbdt.grower.sharded and bst.gbdt._sample_active()
    assert abs(ll - jll) < 1e-5
    _structure_and_leaves(jb.models, bst.models, 6)


def test_one_device_trains_serial(serial):
    """tree_learner=data on a mesh of one device trains the serial
    learner (the JAX package's config.py:1106-1108)."""
    X, y = _data()
    bst, _ = _train(tlgb, X, y, _params("data", device="cpu",
                                        mesh_shape=(1,)))
    assert not bst.gbdt.grower.sharded
    assert bst.gbdt.grower.policy.mesh is None
    assert bst.model_to_string() == serial[0].model_to_string()


def test_mesh_larger_than_the_devices_warns_and_trains_serial(serial,
                                                              capsys):
    X, y = _data()
    n = M.CPU_MESH_DEVICES * 2
    bst, _ = _train(tlgb, X, y, _params("data", device="cpu",
                                        mesh_shape=(n,), verbose=0))
    assert bst.gbdt.grower.policy.mesh is None
    cap = capsys.readouterr()
    assert f"mesh_shape ({n},) needs {n} devices, have " \
        f"{M.CPU_MESH_DEVICES}; falling back to serial" in cap.out + cap.err
    assert bst.model_to_string() == serial[0].model_to_string()


def test_mesh_devices_and_policy():
    cfg = Config.from_params({"tree_learner": "data", "device": "cpu"})
    mesh = M.build_mesh(cfg)
    assert mesh.size == M.CPU_MESH_DEVICES
    assert mesh.shape == {"data": M.CPU_MESH_DEVICES}
    assert M.build_mesh(Config.from_params({"device": "cpu"})) is None
    pol = M.ShardingPolicy(cfg, M.build_mesh(Config.from_params(
        {"device": "cpu", "mesh_shape": (2,)})))
    pol.set_rows(8)
    assert pol.row_ranges == [(0, 4), (4, 8)]
    parts = pol.place_rows(np.arange(8))
    assert [p.tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert pol.gather_rows(parts, "cpu").tolist() == list(range(8))
    with pytest.raises(ValueError, match="do not divide"):
        pol.set_rows(9)
    if not torch.cuda.is_available():
        assert M.mesh_devices("cuda") == []


@pytest.mark.parametrize("shape,axes,world,want", [
    ((), (), 2, 1), ((4,), (), 2, 2), ((8,), ("data",), 2, 4),
    ((2, 2), ("data", "feature"), 2, 1), ((2, 4), ("feature", "data"), 2, 2),
    ((4,), ("feature", "data"), 2, 1)])
def test_local_shards_of_a_device_plane_rank(shape, axes, world, want):
    """The row shards a rank of a ``world``-process plane holds (and so
    the cards it binds from LOCAL_RANK x L on): the row axis of
    ``mesh_shape`` over the world; 1 without a ``mesh_shape`` or with
    axes that do not name it (the mesh refuses those when it builds)."""
    cfg = Config.from_params({"mesh_shape": shape, "mesh_axes": axes,
                              "device": "cpu"})
    assert M.local_shards(cfg, world) == want


def test_mesh_axes_and_policy_per_learner():
    """The feature learner's default mesh takes the feature axis; a
    multi-axis mesh shards rows over ``data`` whatever the learner; a
    feature learner on a data axis shards rows (no vertical partition);
    axes must name every dimension."""
    mk = {"device": "cpu"}
    mesh = M.build_mesh(Config.from_params(dict(mk, tree_learner="feature")))
    assert mesh.shape == {"feature": M.CPU_MESH_DEVICES}
    pol = M.ShardingPolicy(Config.from_params(
        dict(mk, tree_learner="feature")), mesh)
    assert pol.feature_axis == "feature" and pol.row_axis is None
    pol.set_rows(16)
    assert pol.row_ranges is None
    for learner in ("serial", "data", "feature", "voting"):
        cfg = Config.from_params(dict(mk, tree_learner=learner,
                                      mesh_shape=(2, 2),
                                      mesh_axes=("feature", "data")))
        pol = M.ShardingPolicy(cfg, M.build_mesh(cfg))
        assert pol.row_axis == "data" and pol.feature_axis is None
        pol.set_rows(8)
        assert pol.row_ranges == [(0, 4), (4, 8)]
        assert len(pol.row_devices) == 2 and len(pol.devices) == 4
    with pytest.raises(ValueError, match="mesh_axes"):
        M.build_mesh(Config.from_params(dict(mk, mesh_shape=(2, 2))))
    pol = M.ShardingPolicy(Config.from_params(dict(mk)), M.build_mesh(
        Config.from_params(dict(mk, mesh_shape=(2,)))))
    pol.set_rows(8)
    blocks = [np.arange(10).reshape(5, 2).astype(np.uint8),
              np.arange(10, 16).reshape(3, 2).astype(np.uint8)]
    got = pol.place_row_shards(blocks, 8)
    assert [t.tolist() for t in got] == [
        [[0, 1], [2, 3], [4, 5], [6, 7]], [[8, 9], [10, 11], [12, 13],
                                           [14, 15]]]
    got = pol.place_row_shards(blocks[:1], 8)
    assert got[1].tolist() == [[8, 9], [0, 0], [0, 0], [0, 0]]
    serial = M.ShardingPolicy(Config.from_params(mk), None)
    assert serial.place_row_shards(blocks, 10, "cpu").shape == (10, 2)


@pytest.mark.parametrize("shards,features,partitioned", [
    (2, 10, True), (4, 12, True), (4, 10, False)],
    ids=["2-shards", "4-shards", "4-shards-fallback"])
def test_feature_learner_against_the_jax_mesh(shards, features,
                                              partitioned):
    """The vertical partition where the mesh divides the groups; 10
    groups on 4 shards run the serial rounds on replicated bins (the
    JAX package's constraint-sharded fallback)."""
    X, y = _data(f=features)
    mesh = {"mesh_shape": (shards,), "mesh_axes": ("feature",),
            "min_gain_to_split": 1e-3}
    bst, ll = _train(tlgb, X, y, _params("feature", device="cpu", **mesh))
    g = bst.gbdt.grower
    assert g.is_feature_par == partitioned and not g.sharded
    assert g.policy.feature_axis == "feature" and g.plan.name == "xla"
    if partitioned:
        assert [t.shape for t in g.feature_bins] == \
            [(g.n_padded, features // shards)] * shards
    jb, jll = _train(jlgb, X, y, _params("feature", **mesh))
    assert jb.gbdt.grower._is_feature_par == partitioned
    assert abs(ll - jll) < 1e-5
    _structure_and_leaves(jb.models, bst.models, 10)


def test_data_learner_on_a_two_axis_mesh():
    """mesh_shape=(2, 2) over ("data", "feature"): the rows shard over
    the data axis, the feature axis replicates (JAX mesh.py:97)."""
    X, y = _data()
    mesh = {"mesh_shape": (2, 2), "mesh_axes": ("data", "feature"),
            "min_gain_to_split": 1e-3}
    bst, ll = _train(tlgb, X, y, _params("data", device="cpu", **mesh))
    g = bst.gbdt.grower
    assert g.sharded and g.policy.mesh.size == 4
    assert g.policy.row_axis == "data" and len(g.shard_bins) == 2
    jb, jll = _train(jlgb, X, y, _params("data", **mesh))
    assert abs(ll - jll) < 1e-5
    _structure_and_leaves(jb.models, bst.models, 10)


@pytest.mark.parametrize("learner", ["feature", "voting"])
def test_categorical_column_under_feature_and_voting(learner):
    """A 12-category column: the feature learner's winner carries its
    categorical bitset, the voting learner's compact finder its own."""
    rng = np.random.RandomState(5)
    X = rng.randn(1200, 8)
    X[:, 2] = rng.randint(0, 12, 1200)
    y = X[:, 0] + 0.8 * np.isin(X[:, 2], [1, 4, 7, 9]) \
        + 0.2 * rng.randn(1200)
    p = {"objective": "regression_l1", "num_leaves": 15, "verbose": -1,
         "tree_learner": learner, "mesh_shape": (2,), "cat_smooth": 1.0,
         "mesh_axes": ("feature" if learner == "feature" else "data",),
         "top_k": 2}
    jb = jlgb.train(p, jlgb.Dataset(X, label=y, categorical_feature=[2]),
                    10)
    bst = tlgb.train(dict(p, device="cpu"),
                     tlgb.Dataset(X, label=y, categorical_feature=[2]), 10,
                     keep_training_booster=True)
    g = bst.gbdt.grower
    assert (g.is_feature_par, g.is_voting) == (learner == "feature",
                                               learner == "voting")
    assert sum(int((t.decision_type & 1).sum()) for t in bst.models) > 0
    _structure_and_leaves(jb.models, bst.models, 10)
