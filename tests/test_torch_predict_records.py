"""Kernel C's input and plain walk on the CPU: the node records
(ops/predict.py LevelRecords), the chunk plan and the tier choice.

* ``pack_level_records`` unpacks back to every LevelEnsemble field bit
  for bit, on the corner ensembles of tests/test_torch_kernels.py and on
  tests/torch_predict_cases.py's ensembles (stumps, categorical nodes of
  two words, K = 3, more nodes than a chunk holds, a tree past 16-bit
  child codes);
* the records' walk lands every (row, tree) pair on the leaf the JAX
  package's ``predict_level_ensemble`` and its Pallas kernel (interpret
  mode) land it on, bit for bit, and ``predict_level_records_plain``
  agrees with both within 1e-6 (the sums' order differs: tree order
  against a matrix product);
* the chunk plan covers every tree once, in order, within 227 KB; the
  tier choice at 1, 16, 1,000 and 200,000 rows.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import predict as JPR
from lightgbm_tpu_torch.ops import predict as P

import torch_predict_cases as C
from test_torch_kernels import _ENSEMBLES, _VALS, _models

#: the random ensembles held against the JAX package ("500 trees" only
#: packs: its JAX walk is the same code at 50x the size)
RANDOM = ["bench-like", "K=3", "categorical", "stumps only", "wide tree"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _corner(case):
    """(flat dict, depth, probe rows) of a corner ensemble, flattened by
    the JAX package."""
    from lightgbm_tpu.tree import flatten_ensemble
    flat = flatten_ensemble(_models(_ENSEMBLES[case]).models, 1)
    depth = int(flat.pop("depth"))
    return flat, depth, np.array([[a, b] for a in _VALS for b in _VALS])


def _random(name, n=300):
    flat, depth, _, F, cats = C.ensemble(name)
    return flat, depth, C.rows(n, F, cats=cats)


CASES = [("corner", c) for c in sorted(_ENSEMBLES)] + \
    [("random", c) for c in RANDOM]


def _case(kind, name):
    return _corner(name) if kind == "corner" else _random(name)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("kind,name", CASES + [("random", "500 trees"),
                                               ("random", "K=5, 500 trees")])
def test_pack_unpacks_every_field_bit_for_bit(kind, name):
    flat, _, _ = _case(kind, name) if name in RANDOM or kind == "corner" \
        else C.ensemble(name)[:3]
    stack = P.level_ensemble_from_numpy(flat, "cpu")
    rec = P.pack_level_records(stack)
    back = P.unpack_level_records(rec)
    for f in P.LevelEnsemble._fields:
        a, b = getattr(stack, f), getattr(back, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(_bits(a), _bits(b)), f
    T, M, L, W = P.record_dims(rec)
    assert rec.walk.shape == (T * M, 4) and rec.cats.shape == (T * M * W,)
    if name.endswith("500 trees"):    # more nodes than a chunk holds
        assert P.level_plan(rec, 200_000, 56).chunks > 1


def _jax_per_tree(flat, x2, depth, pallas):
    """(N, T) leaf values of the JAX function (or its Pallas kernel in
    interpret mode): the class accumulator replaced by the identity, so
    the product returns each tree's value as it is."""
    jflat = dict(flat, cls_onehot=np.eye(flat["root"].shape[0],
                                         dtype=np.float32))
    stack = JPR.LevelEnsemble(**{k: jnp.asarray(v) for k, v in jflat.items()})
    if pallas:
        n = x2.shape[0]
        pad = np.zeros((-n % 16, x2.shape[1]), np.float32)
        out = JPR.predict_level_ensemble_pallas(
            stack, jnp.asarray(np.concatenate([x2, pad])), depth=depth,
            tile=16, interpret=True)
        return np.asarray(out)[:n]
    return np.asarray(JPR.predict_level_ensemble(stack, jnp.asarray(x2),
                                                 depth=depth))


def _port_per_tree(rec, x2, depth):
    """(N, T) leaf values of the records' walk, in tree order."""
    T, M, L, W = P.record_dims(rec)
    node, _ = P._walk_records(rec, x2, depth)
    leaf = (-node - 1).clamp(min=0).long() + (torch.arange(T) * L)[None, :]
    vals = torch.where(node < 0, rec.leaves[leaf], rec.leaves[rec.leaf0])
    return vals[:, torch.argsort(rec.meta[:, 0].long())].numpy()


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("kind,name", CASES)
def test_records_walk_lands_where_jax_lands(kind, name, pallas):
    """Every (row, tree) pair's leaf value, bit for bit: the walk over
    the records takes the JAX package's path."""
    flat, depth, X = _case(kind, name)
    x2 = P.interleave_hi_lo(X)
    rec = P.pack_level_records(P.level_ensemble_from_numpy(flat, "cpu"))
    want = _jax_per_tree(flat, x2, depth, pallas)
    got = _port_per_tree(rec, _t(x2), depth)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kind,name", CASES)
def test_records_plain_matches_jax(kind, name):
    """predict_level_records_plain (tree-order sums from 0.0) == the JAX
    predict_level_ensemble and its Pallas kernel in interpret mode
    within 1e-6, and == a sequential f32 sum of the JAX per-tree values
    bit for bit."""
    from lightgbm_tpu.ops.predict import LevelEnsemble as JLE
    flat, depth, X = _case(kind, name)
    x2 = P.interleave_hi_lo(X)
    rec = P.pack_level_records(P.level_ensemble_from_numpy(flat, "cpu"))
    got = P.predict_level_records_plain(rec, _t(x2), depth=depth).numpy()
    stack = JLE(**{k: jnp.asarray(v) for k, v in flat.items()})
    want = np.asarray(JPR.predict_level_ensemble(stack, jnp.asarray(x2),
                                                 depth=depth))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    n = x2.shape[0]
    pad = np.zeros((-n % 16, x2.shape[1]), np.float32)
    want_k = np.asarray(JPR.predict_level_ensemble_pallas(
        stack, jnp.asarray(np.concatenate([x2, pad])), depth=depth,
        tile=16, interpret=True))[:n]
    np.testing.assert_allclose(got, want_k, rtol=0, atol=1e-6)
    per_tree = _jax_per_tree(flat, x2, depth, False)
    seq = np.zeros_like(got)
    for t, k in enumerate(np.argmax(flat["cls_onehot"], axis=1)):
        seq[:, k] = (seq[:, k] + per_tree[:, t]).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), seq.view(np.int32))


@pytest.mark.parametrize("name", RANDOM)
def test_visits_count_the_live_pairs_of_each_level(name):
    """level_visits (the visit bound's count) == the (row, tree) pairs
    still walking at each level of the JAX form's plain walk."""
    flat, depth, X = _random(name, n=200)
    stack = P.level_ensemble_from_numpy(flat, "cpu")
    x2 = _t(P.interleave_hi_lo(X))
    T = stack.root.shape[0]
    W = stack.cat_words.shape[0] // stack.feat2.shape[0]
    node = stack.root[None, :].expand(x2.shape[0], T).contiguous()
    want = 0
    for _ in range(depth):
        want += int((node >= 0).sum())
        node = P._level_step(stack, x2, node, T, W)
    assert P.level_visits(P.pack_level_records(stack), x2, depth) == want


@pytest.mark.parametrize("name,F", [("bench-like", 28), ("500 trees", 28),
                                    ("K=3", 28), ("K=5, 500 trees", 28),
                                    ("categorical", 8),
                                    ("bench-like", 100), ("stumps only", 28)])
def test_chunk_plan_covers_every_tree_once_in_order(name, F):
    """The shared tier's chunks take consecutive positions, every tree
    once, in class-major tree order, within the card's 227 KB a CTA."""
    flat, _, _ = C.ensemble(name)[:3]
    rec = P.pack_level_records(P.level_ensemble_from_numpy(flat, "cpu"))
    T, M, L, W = P.record_dims(rec)
    plan = P.level_plan(rec, 200_000, 2 * F, tier="shared")
    tpc = plan.trees_per_chunk
    spans = [list(range(c * tpc, min(T, (c + 1) * tpc)))
             for c in range(plan.chunks)]
    assert sum(spans, []) == list(range(T))
    tree, cls = rec.meta[:, 0].tolist(), rec.meta[:, 1].tolist()
    assert sorted(tree) == list(range(T))
    assert sorted(zip(cls, tree)) == list(zip(cls, tree))
    assert plan.smem_bytes <= P.PREDICT_SMEM_LIMIT
    per = M * 16 + 16 + L * 4 + (M * W * 4 if plan.cat_shared else 0)
    # 256-thread CTAs (two an SM) where the ensemble fits one chunk
    # beside a 256-row tile in half the SM's shared memory, else 512 (a
    # staged row holds F | 1 pairs, so that a warp's rows meet 32 banks)
    pair = T * per + 256 * (F | 1) * 8 <= P.PREDICT_SMEM_PAIR
    assert plan.threads == (256 if pair else 512)
    assert plan.stage_x == (F <= 28)
    x = plan.threads * (F | 1) * 8
    assert plan.smem_bytes == tpc * per + (x if plan.stage_x else 0)
    if plan.threads == 256:
        assert plan.chunks == 1 and plan.smem_bytes <= P.PREDICT_SMEM_PAIR
    if name.endswith("500 trees"):
        assert plan.chunks > 1
    if name.startswith("K=5"):            # a chunk ends inside a class
        assert (T // 5) % tpc != 0
    # the category words join the chunk
    assert plan.cat_shared == rec.has_cat


@pytest.mark.parametrize("name,n,tier", [
    ("bench-like", 1, "global"), ("bench-like", 16, "global"),
    ("bench-like", 1000, "global"), ("bench-like", 200_000, "shared"),
    ("bench-like", 16383, "global"), ("bench-like", 16384, "shared"),
    ("500 trees", 16384, "global"), ("500 trees", 32767, "global"),
    ("500 trees", 32768, "shared"), ("500 trees", 200_000, "shared")])
def test_tier_choice(name, n, tier):
    """The global tier below SHARED_TIER_MIN_ROWS rows (an ensemble in
    one chunk) or SHARED_TIER_MIN_ROWS_CHUNKED (in several), the shared
    tier from there."""
    flat, _, _ = C.ensemble(name)[:3]
    rec = P.pack_level_records(P.level_ensemble_from_numpy(flat, "cpu"))
    plan = P.level_plan(rec, n, 56)
    assert plan.tier == tier and not plan.links
    chunks = P.level_plan(rec, n, 56, tier="shared").chunks
    assert (chunks == 1) == (name == "bench-like")
    least = P.SHARED_TIER_MIN_ROWS if chunks == 1 else \
        P.SHARED_TIER_MIN_ROWS_CHUNKED
    assert (n >= least) == (tier == "shared")


def test_wide_trees_take_the_global_tier_with_flat_ids():
    flat, _, _ = C.ensemble("wide tree")[:3]
    rec = P.pack_level_records(P.level_ensemble_from_numpy(flat, "cpu"))
    plan = P.level_plan(rec, 200_000, 24)
    assert plan.tier == "global" and plan.links
    with pytest.raises(ValueError, match="global tier"):
        P.level_plan(rec, 200_000, 24, tier="shared")


def test_chunk_bytes_below_one_tree_raises():
    flat, _, _ = C.ensemble("K=3")[:3]
    rec = P.pack_level_records(P.level_ensemble_from_numpy(flat, "cpu"))
    with pytest.raises(ValueError, match="holds no tree"):
        P.level_plan(rec, 5000, 56, tier="shared", chunk_bytes=100)


def _flat_of(case="bench-like"):
    return C.ensemble(case)[0]


@pytest.mark.parametrize("fault", ["not one-hot", "child in another tree",
                                   "root in another tree", "odd feat2",
                                   "decision type past 4 bits"])
def test_pack_refuses_what_records_cannot_hold(fault):
    flat = {k: v.copy() for k, v in _flat_of("K=3").items()}
    M = flat["feat2"].shape[0] // flat["root"].shape[0]
    if fault == "not one-hot":
        flat["cls_onehot"][2] = 0.5
    elif fault == "child in another tree":
        flat["left"][M] = 0                    # tree 1's root -> tree 0
    elif fault == "root in another tree":
        flat["root"][1] = 0
    elif fault == "odd feat2":
        flat["feat2"][0] = 3
    else:
        flat["dtype_"][0] = 16
    with pytest.raises(ValueError):
        P.pack_level_records(P.level_ensemble_from_numpy(flat, "cpu"))


def test_unreachable_nodes_may_point_anywhere():
    """flatten_ensemble pads a tree with nodes whose children are flat id
    0; they are never walked, so they pack (and unpack as they were)."""
    flat = _flat_of("stumps only")
    assert (flat["left"] == 0).all()
    stack = P.level_ensemble_from_numpy(flat, "cpu")
    back = P.unpack_level_records(P.pack_level_records(stack))
    assert torch.equal(back.left, stack.left)


def test_wrapper_takes_records_or_an_ensemble_and_checks_features():
    flat, depth, X = _random("K=3", n=50)
    stack = P.level_ensemble_from_numpy(flat, "cpu")
    rec = P.pack_level_records(stack)
    x2 = _t(P.interleave_hi_lo(X))
    a = P.predict_level_ensemble(rec, x2, depth=depth)
    b = P.predict_level_ensemble(stack, x2, depth=depth)
    assert a.shape == (50, 3) and torch.equal(a, b)
    with pytest.raises(ValueError, match="features"):
        P.predict_level_ensemble(rec, x2[:, :8].contiguous(), depth=depth)


@pytest.mark.parametrize("kind,name", CASES)
def test_nan_left_bit_is_where_a_nan_goes(kind, name):
    """The walk record's nan_left bit: the default direction under the
    zero and NaN missing types, else the JAX package's two-float compare
    of (0, 0), to which a NaN is converted."""
    flat, _, _ = _case(kind, name)
    rec = P.pack_level_records(P.level_ensemble_from_numpy(flat, "cpu"))
    back = P.unpack_level_records(rec)
    inv = torch.argsort(rec.meta[:, 0].long())
    T, M, _, _ = P.record_dims(rec)
    bit = (rec.walk[:, 0].reshape(T, M)[inv].reshape(-1) >> 4) & 1
    dt = back.dtype_.numpy()
    mtype = (dt >> 2) & 3
    zero = jnp.zeros(dt.shape, jnp.float32)
    cmp = np.asarray(JPR._two_float_left(zero, zero, jnp.asarray(flat["thr_hi"]),
                                         jnp.asarray(flat["thr_lo"])))
    want = np.where((mtype == 1) | (mtype == 2), (dt & 2) > 0, cmp)
    np.testing.assert_array_equal(bit.numpy().astype(bool), want)


@pytest.mark.parametrize("name", ["bench-like", "K=3", "stumps only",
                                  "wide tree"])
@pytest.mark.parametrize("tier", ["shared", "global"])
def test_launch_arguments_match_the_entry_points(name, tier):
    """level_launch_args gives each tier's C entry point (ops/kernels.py
    KERNELS) its argument count, pointers where it takes pointers and
    the plan's numbers in the places the entry point reads them."""
    from lightgbm_tpu_torch.ops import kernels
    flat, depth, X = _random(name, n=40)
    rec = P.pack_level_records(P.level_ensemble_from_numpy(flat, "cpu"))
    x2 = _t(P.interleave_hi_lo(X))
    if name == "wide tree" and tier == "shared":
        tier = "global"                    # its trees take flat ids
    plan = P.level_plan(rec, 40, x2.shape[1], tier=tier)
    out = torch.empty((40, rec.num_class))
    name_, *args = P.level_launch_args(rec, plan, x2, out, depth, 132)
    argtypes = kernels.KERNELS[name_][2]
    assert name_ == ("predict_level" if tier == "shared"
                     else "predict_level_global")
    assert len(args) + 1 == len(argtypes)          # and the stream
    import ctypes
    for a, t in zip(args, argtypes):
        assert isinstance(a, int)
        if t is ctypes.c_int:
            assert -2 ** 31 <= a < 2 ** 31
    T, M, L, W = P.record_dims(rec)
    npt = 7 if tier == "global" else 6               # the pointers
    assert args[npt] == 40 and args[npt + 1] == (
        x2.shape[1] if tier == "global" else x2.shape[1] // 2)
    if tier == "shared":
        assert args[npt + 2:npt + 9] == [plan.threads,
                                         int(plan.stage_x), T, M, L, W,
                                         rec.num_class]
        assert args[-2:] == [plan.smem_bytes, 132]
    else:
        assert args[npt + 2:npt + 7] == [T, M, L, W, rec.num_class]
        assert args[-2:] == [int(plan.links), int(rec.has_cat)]


def test_class_sums_cross_the_chunks_in_tree_order():
    """K = 5, 100 trees a class, chunks ending inside classes: the
    records' plain walk adds each class's trees in tree order (the
    kernel's order in both tiers, held on the card), bit for bit a
    sequential f32 sum of the per-tree values, and within 1e-5 *
    (1 + |score|) of the JAX form's plain version (a matrix product)."""
    flat, depth, X = _random("K=5, 500 trees", n=200)
    stack = P.level_ensemble_from_numpy(flat, "cpu")
    rec = P.pack_level_records(stack)
    x2 = _t(P.interleave_hi_lo(X))
    got = P.predict_level_records_plain(rec, x2, depth=depth)
    per_tree = _port_per_tree(rec, x2, depth)
    seq = np.zeros((x2.shape[0], 5), np.float32)
    for t, k in enumerate(np.argmax(flat["cls_onehot"], axis=1)):
        seq[:, k] = (seq[:, k] + per_tree[:, t]).astype(np.float32)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  seq.view(np.int32))
    want = P.predict_level_ensemble_plain(stack, x2, depth=depth)
    assert bool(((got - want).abs() <= 1e-5 * (1 + want.abs())).all())
