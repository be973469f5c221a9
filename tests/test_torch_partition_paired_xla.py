"""The port's last three plans against the JAX package: the leaf
partition and kernel J (seg_tiled), kernel K (pallas_paired), the XLA
histogram (the default config's plan), and training without the
histogram cache.

Same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernel in interpret mode, as the JAX package's own tests run it
on the CPU) and the port's counterpart on CPU tensors, which runs each
kernel's plain PyTorch version:

* build_leaf_partition and apply_partition byte for byte, on the cases
  of tests/test_partition.py (negative leaves, empty and dominant
  leaves);
* kernel J's int32 histogram bit for bit against
  compute_group_histograms_seg_tiled, on the cases of
  tests/test_histogram_kernel.py and at B = 255, and the dequantized
  histogram as the JAX function computes it;
* kernel K against compute_group_histograms_pallas_paired: counts
  exact, grad/hess within ``F32_TOL * S`` of each bin's sum S of
  |bf16(w)| (the TPU body sums each row block in f32, the port sums in
  f64 and rounds once);
* compute_group_histograms against the JAX XLA form at float32 and
  bfloat16, with negative slots: counts exact, grad/hess within
  ``F32_TOL * S`` (both sides add the same products in another order);
* training end to end: seg_tiled grows fused_tiled's model text and
  pallas_paired grows pallas's, byte for byte; the default config
  (hist_compute_dtype=float32, the xla plan) and its bfloat16 variant
  grow the JAX package's trees; without the histogram cache the int8
  plans grow one model text among them, with the JAX package's no-cache
  trees.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds each against its plain version there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import partition as JP
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import partition as TP

F32_TOL = 1e-5
_ONES = jnp.ones(3, jnp.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ---------------------------------------------------------------------------
# the leaf partition
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,L,block", [(256, 3, 64), (1024, 17, 128),
                                       (512, 255, 256)])
def test_leaf_partition_is_byte_identical(n, L, block):
    rng = np.random.RandomState(n + L)
    leaf = rng.randint(-1, L, n).astype(np.int32)
    leaf[rng.rand(n) < 0.3] = min(2, L - 1)          # a dominant leaf
    leaf[leaf == 1] = 0                              # an empty one
    want = JP.build_leaf_partition(jnp.asarray(leaf), num_slots=L,
                                   block=block)
    got = TP.build_leaf_partition(_t(leaf), num_slots=L, block=block)
    assert got[0].shape == (TP.partition_capacity(n, L, block),)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert got[2][1] == 0 and (got[1] == -1).any()
    binsT = rng.randint(0, 256, (5, n)).astype(np.uint8)
    wT = rng.randint(-127, 128, (3, n)).astype(np.int32)
    for arr, axis in ((binsT, 1), (wT, 1), (leaf, 0)):
        w = np.asarray(JP.apply_partition(jnp.asarray(arr), want[0],
                                          axis=axis))
        g = TP.apply_partition(_t(arr), got[0], axis=axis)
        assert g.dtype == torch.from_numpy(arr).dtype
        np.testing.assert_array_equal(w, g.numpy())


# ---------------------------------------------------------------------------
# kernel J: seg_tiled
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,N,G,B,L,block", [
    (7, 1024, 4, 8, 10, 128), (8, 2048, 5, 63, 20, 256),
    (9, 2048, 3, 255, 20, 256)])
def test_seg_tiled_matches_jax_interpret(seed, N, G, B, L, block):
    """Negative slots, empty leaves, padded rows and bins >= B."""
    rng = np.random.RandomState(seed)
    leaf = rng.randint(-1, L, N).astype(np.int32)
    bins = rng.randint(0, min(B + 2, 256), (N, G)).astype(np.uint8)
    cnt = (leaf >= 0).astype(np.float32)
    grad = rng.randn(N).astype(np.float32) * cnt
    hess = np.abs(rng.randn(N)).astype(np.float32) * cnt
    wq, scales = TH.quantize_gradients(_t(grad), _t(hess), _t(cnt))
    slots = rng.permutation(L)[:6].astype(np.int32)
    slots[3] = -1
    perm, blk_leaf, _ = TP.build_leaf_partition(_t(leaf), num_slots=L,
                                                block=block)
    binsT_p = TP.apply_partition(_t(bins.T), perm, axis=1)
    wT_p = TP.apply_partition(wq.t().contiguous(), perm, axis=1)
    inv = np.full(L + 1, -1, np.int32)
    for i, s in enumerate(slots):
        if s >= 0:
            inv[s] = i
    blk = blk_leaf.numpy()
    blk_slot = np.where(blk >= 0, inv[np.clip(blk, 0, L)], -1).astype(
        np.int32)
    W = slots.shape[0]
    want = np.asarray(JH.compute_group_histograms_seg_tiled(
        jnp.asarray(binsT_p.numpy()), jnp.asarray(wT_p.numpy()), _ONES,
        jnp.asarray(blk_slot), num_out=W, max_group_bin=B, block=block,
        interpret=True))
    raw = TH.seg_hist(binsT_p, wT_p, _t(blk_slot), W, B, block)
    assert raw.dtype == torch.int32 and raw.shape == (W, G, B, 3)
    np.testing.assert_array_equal(raw.numpy(), want.astype(np.int32))
    got = TH.compute_group_histograms_seg_tiled(
        binsT_p, wT_p, scales, _t(blk_slot), num_out=W, max_group_bin=B,
        block=block)
    np.testing.assert_array_equal(
        got.numpy(), want.astype(np.float32) * scales.numpy())
    # the same histogram as kernel G's over the unpartitioned rows
    np.testing.assert_array_equal(raw.numpy(), TH.tiled_hist(
        _t(bins.T), wq.t().contiguous(), _t(leaf), _t(slots), B).numpy())
    assert raw[..., 2].sum() > 0 and (raw[3] == 0).all()


def test_seg_hist_rejects_bad_inputs():
    binsT = torch.zeros((3, 1024), dtype=torch.uint8)
    wT = torch.zeros((3, 1024), dtype=torch.int32)
    blk = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):          # n_cap not a block multiple
        TH.seg_hist(binsT[:, :1000].contiguous(), wT[:, :1000].contiguous(),
                    blk, 1, 8, 512)
    with pytest.raises(ValueError):          # one blk_slot entry too many
        TH.seg_hist(binsT, wT, torch.zeros(3, dtype=torch.int32), 1, 8, 512)
    with pytest.raises(TypeError):           # f32 weights
        TH.seg_hist(binsT, wT.float(), blk, 1, 8, 512)


# ---------------------------------------------------------------------------
# kernel K: pallas_paired
# ---------------------------------------------------------------------------
def _float_case(seed, N, G, B, L):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (N, G)).astype(np.uint8)
    bins[rng.rand(N, G) < 0.03] = min(B + 1, 255)      # bins >= B
    leaf = rng.randint(0, L, N).astype(np.int32)
    leaf[rng.rand(N) < 0.05] = -1
    cnt = (leaf >= 0).astype(np.float32)
    grad = rng.randn(N).astype(np.float32) * cnt
    hess = (rng.rand(N) * 0.25).astype(np.float32) * cnt
    return rng, bins, leaf, grad, hess, cnt


def _assert_f32_hist(got, want, S):
    """Counts exact; grad/hess within F32_TOL of each bin's sum S of
    absolute weights."""
    got = got.numpy()
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    assert (np.abs(got - want) <= F32_TOL * S + 1e-30).all()


@pytest.mark.parametrize("W", [None, 1, 40, 130])
@pytest.mark.parametrize("B", [63, 255])
def test_pallas_paired_matches_jax_interpret(B, W):
    G, L, N = 5, 140, 2048
    rng, bins, leaf, grad, hess, cnt = _float_case(B + (W or 0), N, G, B, L)
    slots = None
    if W is not None:
        slots = rng.permutation(L)[:W].astype(np.int32)
        slots[rng.rand(W) < 0.1] = -1
    jh = JH.compute_group_histograms_pallas_paired(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), jnp.asarray(leaf), num_leaves=L, max_group_bin=B,
        block=1024, interpret=True,
        slots=None if slots is None else jnp.asarray(slots))
    th = TH.compute_group_histograms_pallas_paired(
        _t(bins), _t(grad), _t(hess), _t(cnt), _t(leaf), num_leaves=L,
        max_group_bin=B, slots=None if slots is None else _t(slots))
    sl = _t(slots) if slots is not None else torch.arange(
        L, dtype=torch.int32)
    w = _t(np.stack([grad, hess, cnt], axis=1))
    S = TH.bins_hist_plain(_t(bins), w.abs(), _t(leaf), sl, B).numpy()
    _assert_f32_hist(th, np.asarray(jh), S)
    assert th[..., 2].sum() > 0
    # kernel F's function: the two plain versions agree bit for bit
    assert torch.equal(TH.bins_hist_paired(_t(bins), w, _t(leaf), sl, B),
                       TH.bins_hist(_t(bins), w, _t(leaf), sl, B))


# ---------------------------------------------------------------------------
# the XLA form
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W", [None, 1, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_group_histograms_matches_jax(dtype, W):
    G, B, L, N = 4, 63, 50, 2048
    rng, bins, leaf, grad, hess, cnt = _float_case(W or 1, N, G, B, L)
    slots = None
    if W is not None:
        slots = rng.permutation(L)[:W].astype(np.int32)
        slots[rng.rand(W) < 0.2] = -1
    kw = dict(num_leaves=L, max_group_bin=B, compute_dtype=dtype,
              chunk=1024)
    jh = np.asarray(JH.compute_group_histograms(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), jnp.asarray(leaf),
        slots=None if slots is None else jnp.asarray(slots), **kw))
    th = TH.compute_group_histograms(
        _t(bins), _t(grad), _t(hess), _t(cnt), _t(leaf),
        slots=None if slots is None else _t(slots), **kw)
    assert th.dtype == torch.float32 and th.shape == jh.shape
    sl = _t(slots) if slots is not None else torch.arange(
        L, dtype=torch.int32)
    w = np.stack([grad, hess, cnt], axis=1)
    if dtype == "bfloat16":
        w = TH.bf16_round(_t(w)).numpy()
    else:
        # the exact f32 weights: the bf16-rounding plain version would
        # not do, so accumulate |w| directly
        assert (TH.bf16_round(_t(w)).numpy() != w).any()
    S = np.zeros(jh.shape)
    wa = np.abs(w).astype(np.float64)
    sl_np = sl.numpy()
    for i, s in enumerate(sl_np):
        rows = np.flatnonzero((leaf == s) & (s >= 0))
        for g in range(G):
            ok = bins[rows, g] < B
            np.add.at(S[i, g], bins[rows[ok], g], wa[rows[ok]])
    _assert_f32_hist(th, jh, S)
    assert th[..., 2].sum() > 0


def test_compute_group_histograms_refuses_tf32():
    bins = torch.zeros((1024, 2), dtype=torch.uint8)
    z = torch.zeros(1024)
    leaf = torch.zeros(1024, dtype=torch.int32)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            TH.compute_group_histograms(bins, z, z, z, leaf, num_leaves=2,
                                        max_group_bin=4)
    finally:
        torch.set_float32_matmul_precision(prev)
    with pytest.raises(ValueError, match="chunk"):
        TH.compute_group_histograms(bins[:1000], z[:1000], z[:1000],
                                    z[:1000], leaf[:1000], num_leaves=2,
                                    max_group_bin=4, chunk=1024)


# ---------------------------------------------------------------------------
# the plans end to end
# ---------------------------------------------------------------------------
ROUNDS = 5


def _data(n, seed):
    """tests/test_torch_train.py's data: NaNs, a zero-heavy column."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[rng.rand(n, 8) < 0.05] = np.nan
    X[:, 3] = np.where(rng.rand(n) < 0.3, 0.0, X[:, 3])
    y = (X[:, 0] - 0.5 * np.nan_to_num(X[:, 1]) + 0.3 * rng.randn(n)
         > 0).astype(float)
    return X, y


def _port(params, rounds=ROUNDS):
    X, y = _data(4000, 0)
    return tlgb.train(dict(params, device="cpu"), tlgb.Dataset(X, label=y),
                      rounds, verbose_eval=False, keep_training_booster=True)


def _jax(params, rounds=ROUNDS):
    X, y = _data(4000, 0)
    return jlgb.train(dict(params, compile_cache_dir=""),
                      jlgb.Dataset(X, label=y), rounds, verbose_eval=False,
                      keep_training_booster=True)


def _hold_trees(jb, tb, rtol):
    """Equal tree structure; from the second tree on the default-left bit
    is left out (ROADMAP queue 3: the gradients' last-bit difference,
    XLA's ``exp``, can flip a tie between the two scan directions);
    leaf values within ``rtol``, the first tree's bit for bit;
    predictions within 1e-5."""
    assert len(jb.models) == len(tb.models) == ROUNDS
    for i, (jt, tt) in enumerate(zip(jb.models, tb.models)):
        assert jt.num_leaves == tt.num_leaves
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), f)
        keep = ~2 if i else ~0
        np.testing.assert_array_equal(jt.decision_type & keep,
                                      tt.decision_type & keep)
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value,
                                   rtol=rtol if i else 0, atol=1e-9)
    X, _ = _data(4000, 0)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X, device=False),
                               rtol=0, atol=1e-5)


_Q = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
      "verbose": -1, "min_data_in_leaf": 5, "quantized_grad": True,
      "hist_compute_dtype": "bfloat16"}
_F = dict(_Q, quantized_grad=False)


def test_seg_tiled_grows_the_fused_tiled_text():
    seg = _port(dict(_Q, hist_leaf_partition="on"))
    assert seg.gbdt.grower.plan.name == "seg_tiled(leaf_partition)"
    assert seg.model_to_string() == _port(_Q).model_to_string()


def test_pallas_paired_grows_the_pallas_text():
    paired = _port(dict(_F, hist_kernel="paired"))
    assert paired.gbdt.grower.plan.name == "pallas_paired"
    pallas = _port(dict(_F, hist_onehot_budget_mb=0))
    assert pallas.gbdt.grower.plan.name == "pallas"
    assert paired.model_to_string() == pallas.model_to_string()


@pytest.mark.parametrize("extra", [{}, {"hist_compute_dtype": "bfloat16",
                                        "hist_kernel": "xla"}],
                         ids=["default", "xla_bf16"])
def test_default_config_matches_jax(extra):
    """The default config, {"objective": "binary"} plus small sizes,
    resolves the xla plan in both packages.  Its f32 histograms carry
    the gradients' last-bit differences where the bf16 plans round them
    away, so leaf values past the first tree are held within 1e-5."""
    params = dict({"objective": "binary", "num_leaves": 15,
                   "verbose": -1, "min_data_in_leaf": 5}, **extra)
    tb = _port(params)
    jb = _jax(params)
    g = jb.gbdt.grower
    assert not (g.use_pallas or g.use_quant)
    assert tb.gbdt.grower.plan.name == "xla"
    _hold_trees(jb, tb, rtol=1e-5)


def test_no_cache_models():
    """histogram_pool_size below the cache: no subtraction, both
    children histogrammed directly.  The int8 plans grow one model text
    among them (fused_tiled, seg_tiled through its partition's second
    pass, q_tiled), and the JAX package's no-cache trees.  Not the
    cached model's text: a direct left histogram dequantizes its int32
    sums once, where parent minus right subtracts two dequantized f32
    sums, so leaf values move in the last bits and a tie between two
    thresholds can fall the other way; the JAX package's cached and
    no-cache models differ in just the same places."""
    nc = dict(_Q, histogram_pool_size=0.001)
    ref = _port(nc)
    assert not ref.gbdt.grower.use_hist_cache
    text = ref.model_to_string()
    for extra, plan in (({"hist_leaf_partition": "on"},
                         "seg_tiled(leaf_partition)"),
                        ({"hist_fused_route": False}, "q_tiled")):
        bst = _port(dict(nc, **extra))
        assert bst.gbdt.grower.plan.name == plan
        assert bst.model_to_string() == text, plan
    jb = _jax(dict(nc, force_pallas_interpret=True))
    assert not jb.gbdt.grower.use_hist_cache and jb.gbdt.grower.use_fused
    _hold_trees(jb, ref, rtol=1e-5)
