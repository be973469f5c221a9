"""The port's int8 plans without the fused route against the JAX package.

Same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernel in interpret mode) and the port's counterpart on CPU
tensors, which runs the kernel's plain PyTorch version:

* kernel G (``compute_group_histograms_q_tiled``), kernel H
  (``route_only_tiled``) and kernel I behind its two entry points
  (``compute_group_histograms_pallas_q``, ``compute_group_histograms_q_packed``):
  the int32 histogram and the leaf ids bit for bit, and the dequantized
  histogram as the JAX function computes it from them; at B = 15, 63
  and 255 (the TPU bodies' int8 and bf16 one-hot branches), frontier
  widths 1 to 150, duplicate and negative slots, padded rows (leaf -1)
  and bins >= B;
* the strip ladder of the q_onthefly plan: which entry point each round
  takes, and that the choice does not change the model;
* training end to end on the four plans (q_tiled with and without the
  split route, q_onthefly, the quantized pallas body): the JAX plan's
  name, equal tree structure, leaf values within 1e-5 relative,
  predictions within 1e-5, and a model text equal byte for byte to the
  port's own fused_tiled model (integer histograms make it exact,
  whichever kernel built them).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds each against its plain version there.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu.learner.grower as JG
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.learner.grower import TreeGrower as JTreeGrower
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import partition as JP
from lightgbm_tpu_torch.learner import grower as TG
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import partition as TP

N, G, L = 4096, 6, 60


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _case(seed, B, W):
    """Bins (some >= B), leaf ids (some padded), int8 weights and scales,
    and W slots with duplicates, empty leaves and negative entries."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (N, G)).astype(np.uint8)
    bins[rng.rand(N, G) < 0.03] = min(B + 1, 255)
    leaf = rng.randint(0, L, N).astype(np.int32)
    leaf[rng.rand(N) < 0.05] = -1
    cnt = (leaf >= 0).astype(np.float32)
    grad = rng.randn(N).astype(np.float32) * cnt
    hess = (rng.rand(N) * 0.25).astype(np.float32) * cnt
    wq, scales = TH.quantize_gradients(_t(grad), _t(hess), _t(cnt))
    slots = rng.randint(0, L + 5, W).astype(np.int32)
    slots[rng.rand(W) < 0.1] = -1
    slots[0] = rng.randint(0, L)                # a leaf that holds rows
    if W > 1:
        slots[-1] = slots[0]                    # a duplicate slot
    return bins, leaf, wq, scales, slots


def _strips(W):
    return max(1, -(-W // JH.PACKED_STRIP))


def _hold(raw, jax_unit, got, scales, W):
    """The port's int32 histogram equals the JAX function's (run with
    unit scales, exact below 2^24) bit for bit; the port's dequantized
    entry equals the JAX function's own product of the two."""
    want = np.asarray(jax_unit)[:W]
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(raw.numpy(), want.astype(np.int32))
    assert (want == want.astype(np.int32)).all()
    np.testing.assert_array_equal(
        got.numpy(), want.astype(np.float32) * scales.numpy())
    assert raw[..., 2].sum() > 0


_ONES = jnp.ones(3, jnp.float32)


# ---------------------------------------------------------------------------
# kernel G: q_tiled
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W", [1, 5, 42, 84, 126])
@pytest.mark.parametrize("B", [15, 63, 255])
def test_q_tiled_matches_jax_interpret(B, W):
    bins, leaf, wq, scales, slots = _case(B + W, B, W)
    binsT, wT = bins.T.copy(), wq.t().contiguous()
    jh = JH.compute_group_histograms_q_tiled(
        jnp.asarray(binsT), jnp.asarray(wT.numpy()), _ONES,
        jnp.asarray(leaf), jnp.asarray(slots), max_group_bin=B,
        strips=_strips(W), interpret=True)
    raw = TH.tiled_hist(_t(binsT), wT, _t(leaf), _t(slots), B)
    got = TH.compute_group_histograms_q_tiled(
        _t(binsT), wT, scales, _t(leaf), _t(slots), max_group_bin=B)
    _hold(raw, jh, got, scales, W)


# ---------------------------------------------------------------------------
# kernel H: route_only
# ---------------------------------------------------------------------------
def _route_args(rng, B):
    """Route-table columns over L leaves: two thirds split, with every
    missing type, both default directions and categorical left-sets."""
    sm = rng.rand(L) < 0.67
    rs = np.zeros(L, np.int32)
    rs[sm] = L + np.arange(sm.sum())
    return dict(
        split_mask=sm, feat_group=rng.randint(0, G, L).astype(np.int32),
        fb_lo=np.zeros(L, np.int32), fb_hi=np.full(L, B, np.int32),
        fb_shift=np.zeros(L, np.int32), fb_oor=np.full(L, B - 1, np.int32),
        is_cat=(np.arange(L) % 4 == 3),
        threshold=rng.randint(0, B - 1, L).astype(np.int32),
        default_left=(np.arange(L) % 2 == 0),
        missing_type=(np.arange(L) % 3).astype(np.int32),
        default_bin=rng.randint(0, B, L).astype(np.int32),
        num_bin=np.full(L, B, np.int32), cat_mask=rng.rand(L, B) > 0.5,
        right_slot=rs)


@pytest.mark.parametrize("B", [15, 63, 255])
def test_route_only_matches_jax_interpret(B):
    """Leaf ids bit for bit; rows of padded leaves and of leaves past
    the table stay put."""
    bins, leaf, _, _, _ = _case(B, B, 1)
    leaf[::97] = L + 3                          # no table row
    rng = np.random.RandomState(B)
    args = _route_args(rng, B)
    jt = JP.build_route_table(*[jnp.asarray(v) for v in args.values()])
    tt = TP.build_route_table(**{k: _t(v) for k, v in args.items()})
    binsT = bins.T.copy()
    want = np.asarray(JH.route_only_tiled(
        jnp.asarray(binsT), jnp.asarray(leaf), jt, block=N, interpret=True))
    got = TH.route_only_tiled(_t(binsT), _t(leaf), tt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    moved = got.numpy() != leaf
    assert moved.any() and (leaf[moved] >= 0).all()
    assert (got.numpy()[leaf >= L] == leaf[leaf >= L]).all()


# ---------------------------------------------------------------------------
# kernel I: pallas_q (every leaf or a slot list) and q_packed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W", [None, 1, 42, 126, 150])
@pytest.mark.parametrize("B", [15, 63, 255])
def test_pallas_q_matches_jax_interpret(B, W):
    bins, leaf, wq, scales, slots = _case(3 * B + (W or 0), B, W or 1)
    js = None if W is None else jnp.asarray(slots)
    ts = None if W is None else _t(slots)
    jh = JH.compute_group_histograms_pallas_q(
        jnp.asarray(bins), jnp.asarray(wq.numpy()), _ONES,
        jnp.asarray(leaf), num_leaves=L, max_group_bin=B, interpret=True,
        slots=js)
    got = TH.compute_group_histograms_pallas_q(
        _t(bins), wq, scales, _t(leaf), num_leaves=L, max_group_bin=B,
        slots=ts)
    sl = ts if W is not None else torch.arange(L, dtype=torch.int32)
    raw = TH.bins_hist_q(_t(bins), wq, _t(leaf), sl, B)
    assert got.shape[0] == (L if W is None else W)
    _hold(raw, jh, got, scales, got.shape[0])


@pytest.mark.parametrize("W", [1, 5, 42, 84, 126])
@pytest.mark.parametrize("B", [15, 63, 255])
def test_q_packed_matches_jax_interpret(B, W):
    bins, leaf, wq, scales, slots = _case(5 * B + W, B, W)
    jh = JH.compute_group_histograms_q_packed(
        jnp.asarray(bins), jnp.asarray(wq.numpy()), _ONES,
        jnp.asarray(leaf), jnp.asarray(slots), max_group_bin=B,
        strips=_strips(W), interpret=True)
    raw = TH.bins_hist_q_packed(_t(bins), wq, _t(leaf), _t(slots), B)
    got = TH.compute_group_histograms_q_packed(
        _t(bins), wq, scales, _t(leaf), _t(slots), max_group_bin=B)
    _hold(raw, jh, got, scales, W)


def test_int8_entry_points_agree_on_one_input():
    """The three int8 oracles (bins, transposed bins, and kernel A with
    an empty route table) compute one function."""
    B, W = 63, 42
    bins, leaf, wq, _, slots = _case(1, B, W)
    binsT, wT = _t(bins.T.copy()), wq.t().contiguous()
    h_i = TH.bins_hist_q(_t(bins), wq, _t(leaf), _t(slots), B)
    h_g = TH.tiled_hist(binsT, wT, _t(leaf), _t(slots), B)
    h_a, l_a = TH.fused_route_hist(binsT, wT, _t(leaf),
                                   torch.zeros((L, 23)), _t(slots), B)
    assert torch.equal(h_i, h_g) and torch.equal(h_i, h_a)
    np.testing.assert_array_equal(l_a.numpy(), leaf)


def test_int8_wrappers_reject_bad_inputs():
    bins = torch.zeros((16, 3), dtype=torch.uint8)
    wq = torch.zeros((16, 3), dtype=torch.int32)
    leaf = torch.zeros(16, dtype=torch.int32)
    slots = torch.zeros(2, dtype=torch.int32)
    ones = torch.ones(3)
    with pytest.raises(TypeError):           # f32 weights on kernel I
        TH.bins_hist_q(bins, wq.float(), leaf, slots, 8)
    with pytest.raises(ValueError):          # more than 126 slots
        TH.compute_group_histograms_q_packed(
            bins, wq, ones, leaf, torch.zeros(127, dtype=torch.int32),
            max_group_bin=8)
    with pytest.raises(ValueError):          # (N, 3) where (3, N) is due
        TH.tiled_hist(bins.t().contiguous(), wq, leaf, slots, 8)
    with pytest.raises(ValueError):          # B above 256
        TH.tiled_hist(bins.t().contiguous(), wq.t().contiguous(), leaf,
                      slots, 257)
    with pytest.raises(ValueError):          # a table of 14 columns
        TH.route_only_tiled(bins.t().contiguous(), leaf,
                            torch.zeros((4, 14)))


# ---------------------------------------------------------------------------
# the strip ladder of q_onthefly past a 126-wide frontier
# ---------------------------------------------------------------------------
def _data(n, seed):
    """tests/test_torch_train.py's data: NaNs, a zero-heavy column."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[rng.rand(n, 8) < 0.05] = np.nan
    X[:, 3] = np.where(rng.rand(n) < 0.3, 0.0, X[:, 3])
    y = (X[:, 0] - 0.5 * np.nan_to_num(X[:, 1]) + 0.3 * rng.randn(n)
         > 0).astype(float)
    return X, y


def test_q_onthefly_ladder_picks_the_kernel_not_the_model(monkeypatch):
    """A 200-wide frontier puts the quantized plan on q_onthefly (the
    tiled kernels stop at 126) in both packages; its rounds take q_packed
    up to 84 new leaves and pallas_q above, and the model equals the one
    grown with pallas_q on every round (hist_packed_dispatch=false)."""
    params = {"objective": "binary", "num_leaves": 511, "max_bin": 63,
              "verbose": -1, "min_data_in_leaf": 3, "quantized_grad": True,
              "hist_compute_dtype": "bfloat16", "frontier_width": 200}
    # a concept in every feature, so that most leaves split each round
    # and some rounds add more than 84 leaves
    rng = np.random.RandomState(2)
    X = rng.randn(4000, 8)
    y = (np.sin(3 * X).sum(1) + 0.5 * rng.randn(4000) > 0).astype(float)
    jcfg = JConfig.from_params(dict(params, force_pallas_interpret=True))
    g = JTreeGrower(jlgb.Dataset(X, label=y).construct(jcfg), jcfg)
    assert g.use_quant_otf and not g.use_tiled and not g.use_fused
    calls = []

    def spy(name):
        fn = getattr(TG, name)

        def wrapped(*a, **kw):
            sl = kw["slots"] if "slots" in kw else a[4]
            calls.append((name, sl.shape[0]))
            return fn(*a, **kw)
        monkeypatch.setattr(TG, name, wrapped)

    spy("compute_group_histograms_q_packed")
    spy("compute_group_histograms_pallas_q")
    text = {}
    for ladder in (True, False):
        calls.clear()
        bst = tlgb.train(dict(params, device="cpu",
                              hist_packed_dispatch=ladder),
                         tlgb.Dataset(X, label=y), 1, verbose_eval=False,
                         keep_training_booster=True)
        assert bst.gbdt.grower.plan.name == "q_onthefly"
        text[ladder] = bst.model_to_string()
        if ladder:
            assert {k for n, k in calls
                    if n.endswith("q_packed")} <= set(range(1, 85))
            assert {k for n, k in calls if n.endswith("pallas_q")}
            assert all(k > 84 for n, k in calls if n.endswith("pallas_q"))
        else:
            assert {n for n, _ in calls} == {
                "compute_group_histograms_pallas_q"}
    assert text[True] == text[False]
    assert bst.models[0].num_leaves == 511


# ---------------------------------------------------------------------------
# the four plans end to end
# ---------------------------------------------------------------------------
ROUNDS = 5
_E2E = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
        "verbose": -1, "min_data_in_leaf": 5, "quantized_grad": True,
        "hist_compute_dtype": "bfloat16"}
_OTF = {"hist_kernel_tiled": False, "hist_fused_route": False}
_PLANS = {
    "q_tiled(split_route)": {"hist_split_route": True},
    "q_tiled": {"hist_fused_route": False},
    "q_onthefly": _OTF,
    "pallas(quantized)": dict(_OTF, hist_quant_onthefly=False,
                              hist_onehot_budget_mb=0),
}


def _jax_plan_name(g):
    """The JAX grower's plan name for the four plans (grower.py:592-605
    folds the split-route variant into q_tiled's telemetry name)."""
    if g.use_tiled:
        if not g.use_fused:
            return "q_tiled"
        return "q_tiled(split_route)" if g.split_route else "fused_tiled"
    if g.use_quant_otf:
        return "q_onthefly"
    if g.use_pallas and g.use_quant and not g.use_pre_ohb \
            and not g.use_fused:
        return "pallas(quantized)"
    return "other"


@pytest.fixture(scope="module")
def fused_tiled_text():
    X, y = _data(4000, 0)
    return tlgb.train(dict(_E2E, device="cpu"), tlgb.Dataset(X, label=y),
                      ROUNDS, verbose_eval=False).model_to_string()


@pytest.fixture(scope="module", params=sorted(_PLANS))
def trained(request):
    # the JAX grower calls these two entry points without its interpret
    # seam; bind it here (test-side only) so the CPU run reaches the
    # same Pallas bodies in interpret mode
    mp = pytest.MonkeyPatch()
    for name in ("compute_group_histograms_pallas_q",
                 "compute_group_histograms_q_packed"):
        mp.setattr(JG, name, functools.partial(getattr(JH, name),
                                               interpret=True))
    params = dict(_E2E, **_PLANS[request.param])
    X, y = _data(4000, 0)
    try:
        jb = jlgb.train(dict(params, force_pallas_interpret=True,
                             compile_cache_dir=""), jlgb.Dataset(X, label=y),
                        ROUNDS, verbose_eval=False,
                        keep_training_booster=True)
    finally:
        mp.undo()
    tb = tlgb.train(dict(params, device="cpu"), tlgb.Dataset(X, label=y),
                    ROUNDS, verbose_eval=False, keep_training_booster=True)
    return dict(name=request.param, X=X, jb=jb, tb=tb)


def test_plan_is_the_jax_plan(trained):
    g, tp = trained["jb"].gbdt.grower, trained["tb"].gbdt.grower.plan
    assert _jax_plan_name(g) == tp.name == trained["name"]
    assert (tp.quant, tp.fused, tp.tiled) == (g.use_quant, g.use_fused,
                                              g.use_tiled)


def test_trees_match(trained):
    """Every tree's structure is equal; from the second tree on the
    default-left bit is left out (ROADMAP queue 3: XLA's ``exp`` moves
    the int8 scales enough to flip a tie between scan directions)."""
    jm, tm = trained["jb"].models, trained["tb"].models
    assert len(jm) == len(tm) == ROUNDS
    for i, (jt, tt) in enumerate(zip(jm, tm)):
        assert jt.num_leaves == tt.num_leaves
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), f)
        keep = ~2 if i else ~0
        np.testing.assert_array_equal(jt.decision_type & keep,
                                      tt.decision_type & keep)
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                                   atol=1e-9)
    pj = trained["jb"].predict(trained["X"], device=False)
    pt = trained["tb"].predict(trained["X"])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)


def test_model_equals_fused_tiled(trained, fused_tiled_text):
    assert trained["tb"].model_to_string() == fused_tiled_text
