"""The port's float-gradient plans against the JAX package.

Same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernels in interpret mode, as the JAX package's own tests run
them on the CPU) and the port's counterpart on CPU tensors, which runs
each kernel's plain PyTorch version:

* the one-hot builders, byte for byte (pack 1, 2 and 4, plane padding
  included), and the bf16 rounding of the weights, bit for bit;
* kernel D (fused route + streamed one-hot histogram), kernel E (its
  ``pre_packed`` and ``pre`` entry points) and kernel F (row-major
  bins): leaf ids, int8-weight histograms and the count channel exact;
  the f32 grad/hess channels within ``|d| <= F32_TOL * S``, where S is
  the bin's sum of |bf16(w)|.  Both sides add the same bf16 values; the
  TPU body (and its interpret run) sums each row block in f32 and then
  the blocks in grid order, the port sums in f64 and rounds once, so
  the two differ by the JAX side's f32 rounding, at most about
  (rows per bin) * 2^-24 * S and far less in practice;
* apply_splits and leaf_value_broadcast, bit for bit;
* plan resolution against the JAX grower's flags, and the row-bound /
  hist_precision repairs;
* training end to end on each ported float plan (and the int8 variants
  of the streamed plans): same plan, same tree structure, leaf values
  within 1e-5 relative, predictions within 1e-5.

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
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.learner import grower as TG
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import partition as TP

F32_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _route_args(rng, L, G, B, n_active):
    """Route-table columns over L leaves: the first n_active split, with
    every missing type (none / zero-default / NaN), both default
    directions and categorical left-sets; the rest are inactive."""
    sm = np.zeros(L, bool)
    sm[:n_active] = True
    rs = np.zeros(L, np.int32)
    rs[:n_active] = L - n_active + np.arange(n_active)
    return dict(
        split_mask=sm,
        feat_group=rng.randint(0, G, L).astype(np.int32),
        fb_lo=np.zeros(L, np.int32), fb_hi=np.full(L, B, np.int32),
        fb_shift=np.zeros(L, np.int32),
        fb_oor=np.full(L, B - 1, np.int32),
        is_cat=(np.arange(L) % 4 == 3),
        threshold=rng.randint(0, B - 1, L).astype(np.int32),
        default_left=(np.arange(L) % 2 == 0),
        missing_type=(np.arange(L) % 3).astype(np.int32),
        default_bin=rng.randint(0, B, L).astype(np.int32),
        num_bin=np.full(L, B, np.int32),
        cat_mask=rng.rand(L, B) > 0.5,
        right_slot=rs)


def _case(seed, N, G, B, L):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (N, G)).astype(np.uint8)
    leaf = rng.randint(0, L - 4, N).astype(np.int32)
    leaf[rng.rand(N) < 0.05] = -1                       # padded rows
    cnt = (leaf >= 0).astype(np.float32)
    cnt[rng.rand(N) < 0.05] = 0.0                       # out-of-bag rows
    grad = rng.randn(N).astype(np.float32) * cnt
    hess = (rng.rand(N) * 0.25).astype(np.float32) * cnt
    return rng, bins, leaf, grad, hess, cnt


def _onehots(bins, B, pack):
    """(JAX one-hot, port one-hot) of the same bins."""
    jb = jnp.asarray(bins)
    if pack == 1:
        j = JH.precompute_bin_onehot(jb, max_group_bin=B)
        t = TH.precompute_bin_onehot(_t(bins), max_group_bin=B)
    else:
        j = JH.precompute_bin_onehot_packed(jb, max_group_bin=B, pack=pack)
        t = TH.precompute_bin_onehot_packed(_t(bins), max_group_bin=B,
                                            pack=pack)
    return j, t


def _abs_sums(ohb, w, leaf, slots, B, pack, G):
    """S: each bin's sum of |bf16(w)| (the tolerance's scale)."""
    return TH.onehot_hist_plain(ohb, w.abs(), leaf, slots, max_group_bin=B,
                                pack=pack, num_groups=G).numpy()


def _assert_f32_hist(got, want, S):
    """Channels 0 and 1 within F32_TOL * S; the count channel exact."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    assert (np.abs(got - want)[..., :2] <= F32_TOL * S[..., :2]).all(), \
        np.abs(got - want).max()


# ---------------------------------------------------------------------------
# (a) one-hot builders, (b) bf16 rounding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pack", [1, 2, 4])
@pytest.mark.parametrize("G,B", [(5, 16), (8, 63), (3, 12)])
def test_onehot_builders_are_byte_identical(G, B, pack):
    rng = np.random.RandomState(G * B + pack)
    bins = rng.randint(0, B + 2, (700, G)).astype(np.uint8)  # some >= B
    j, t = _onehots(bins, B, pack)
    assert t.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert t.shape[1] == TH.onehot_width(G, B, pack)


def test_bf16_rounding_matches_jax():
    f = np.float32
    base = [0.0, -0.0, 1.0, -1.0, 3.14159, -2.5e-3, 1e-38, -1e-39, 1e-45,
            3.4e38, -3.4e38, 65504.0, 1.0 / 3.0]
    # exact halfway cases between two bf16 values (ties to even) and
    # one ulp either side of them
    ties = []
    for hi in (0x3F80, 0x3F81, 0xBF80, 0x4049, 0x0001, 0x8003):
        mid = np.uint32(hi << 16 | 0x8000)
        ties += [mid, mid - 1, mid + 1]
    rng = np.random.RandomState(0)
    x = np.concatenate([np.array(base, f), np.array(ties, np.uint32).view(f),
                        (rng.randn(5000) * 10.0 ** rng.randint(-30, 30, 5000)
                         ).astype(f)])
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = TH.bf16_round(_t(x)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


# ---------------------------------------------------------------------------
# (c) kernels D, E and F against the Pallas bodies in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("pack", [1, 2, 4])
@pytest.mark.parametrize("G,B,W,strips", [(6, 16, 30, 1), (4, 63, 70, 2),
                                          (8, 21, 110, 3)])
def test_fused_onehot_hist_matches_jax_interpret(G, B, W, strips, pack,
                                                 quant):
    """Kernel D's plain version == _fused_kernel_body in interpret mode:
    new leaf ids exact, int8-weight histograms exact, f32 channels
    within the stated tolerance; NaN / zero-default / categorical route
    rows and inert (negative) slots."""
    N, L = 1024, W + 24
    rng, bins, leaf, grad, hess, cnt = _case(G * B + pack, N, G, B, L)
    args = _route_args(rng, L, G, B, n_active=L // 2)
    jt = JP.build_route_table(*[jnp.asarray(v) for v in args.values()])
    tt = TP.build_route_table(**{k: _t(v) for k, v in args.items()})
    jo, to = _onehots(bins, B, pack)
    slots = rng.permutation(L)[:W].astype(np.int32)
    slots[rng.rand(W) < 0.1] = -1                       # inert entries
    if quant:
        wq, scales = TH.quantize_gradients(_t(grad), _t(hess), _t(cnt))
        wT = wq.t().contiguous()
    else:
        wT, scales = _t(np.stack([grad, hess, cnt])), None
    jh, jl = JH.compute_group_histograms_fused(
        jo, jnp.asarray(bins.T), jnp.asarray(wT.numpy()),
        None if scales is None else jnp.asarray(scales.numpy()),
        jnp.asarray(leaf), jt, jnp.asarray(slots), max_group_bin=B,
        block=256, strips=strips, quant=quant, interpret=True, pack=pack,
        num_groups=G)
    th, tl = TH.compute_group_histograms_fused(
        to, _t(bins.T), wT, scales, _t(leaf), tt, _t(slots),
        max_group_bin=B, quant=quant, pack=pack, num_groups=G)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    assert (tl.numpy() != leaf).any()          # the table routed rows
    if quant:
        raw, _ = TH.fused_onehot_hist(to, _t(bins.T), wT, _t(leaf), tt,
                                      _t(slots), max_group_bin=B, pack=pack,
                                      num_groups=G)
        assert raw.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(jh)[:W], th.numpy())
    else:
        S = _abs_sums(to, wT.t(), tl, _t(slots), B, pack, G)
        _assert_f32_hist(th, np.asarray(jh)[:W], S)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("pack", [1, 2, 4])
@pytest.mark.parametrize("entry", ["pre_packed", "pre", "pre_all_leaves"])
def test_pre_hist_matches_jax_interpret(entry, pack, quant):
    """Kernel E's plain version behind each entry point ==
    _hist_kernel_body_pre_packed / _hist_kernel_body_pre in interpret
    mode (pre_packed at 2 strips; pre over more than 126 slots, and over
    every leaf when no slots are given)."""
    G, B = 6, 16
    N = 1024
    W = {"pre_packed": 70, "pre": 150, "pre_all_leaves": None}[entry]
    L = 160
    _, bins, leaf, grad, hess, cnt = _case(31 + pack, N, G, B, L)
    rng = np.random.RandomState(pack)
    jo, to = _onehots(bins, B, pack)
    if quant:
        w, scales = TH.quantize_gradients(_t(grad), _t(hess), _t(cnt))
    else:
        w, scales = _t(np.stack([grad, hess, cnt], axis=1)), None
    jw = jnp.asarray(w.numpy())
    js = None if scales is None else jnp.asarray(scales.numpy())
    slots = None
    if W is not None:
        slots = rng.permutation(L + 10)[:W].astype(np.int32)
        slots[rng.rand(W) < 0.1] = -1
    if entry == "pre_packed":
        jh = JH.compute_group_histograms_pre_packed(
            jo, jw, js, jnp.asarray(leaf), jnp.asarray(slots),
            max_group_bin=B, block=256, strips=2, quant=quant,
            interpret=True, pack=pack, num_groups=G)
        th = TH.compute_group_histograms_pre_packed(
            to, w, scales, _t(leaf), _t(slots), max_group_bin=B,
            quant=quant, pack=pack, num_groups=G)
    else:
        jh = JH.compute_group_histograms_pre(
            jo, jw, js, jnp.asarray(leaf), num_leaves=L, max_group_bin=B,
            block=256, quant=quant, interpret=True,
            slots=None if slots is None else jnp.asarray(slots), pack=pack,
            num_groups=G)
        th = TH.compute_group_histograms_pre(
            to, w, scales, _t(leaf), num_leaves=L, max_group_bin=B,
            quant=quant, slots=None if slots is None else _t(slots),
            pack=pack, num_groups=G)
    want = np.asarray(jh)[:th.shape[0]]
    if quant:
        np.testing.assert_array_equal(want, th.numpy())
    else:
        sl = (_t(slots) if slots is not None
              else torch.arange(L, dtype=torch.int32))
        _assert_f32_hist(th, want, _abs_sums(to, w, _t(leaf), sl, B, pack,
                                             G))


@pytest.mark.parametrize("W", [None, 1, 40, 130])
def test_bins_hist_matches_jax_interpret(W):
    """Kernel F's plain version == _hist_kernel_body in interpret mode:
    bins >= B and negative slots match nothing; every leaf when no slots
    are given."""
    G, B, L, N = 5, 63, 140, 2048
    rng, bins, leaf, grad, hess, cnt = _case(W or 0, N, G, B, L)
    bins[rng.rand(N, G) < 0.03] = B + 1                # out-of-range bins
    slots = None
    if W is not None:
        slots = rng.permutation(L)[:W].astype(np.int32)
        slots[rng.rand(W) < 0.1] = -1
    jh = JH.compute_group_histograms_pallas(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), jnp.asarray(leaf), num_leaves=L, max_group_bin=B,
        block=512, interpret=True,
        slots=None if slots is None else jnp.asarray(slots))
    th = TH.compute_group_histograms_pallas(
        _t(bins), _t(grad), _t(hess), _t(cnt), _t(leaf), num_leaves=L,
        max_group_bin=B, slots=None if slots is None else _t(slots))
    sl = _t(slots) if slots is not None else torch.arange(
        L, dtype=torch.int32)
    w_abs = _t(np.abs(np.stack([grad, hess, cnt], axis=1)))
    S = TH.bins_hist_plain(_t(bins), w_abs, _t(leaf), sl, B).numpy()
    _assert_f32_hist(th, np.asarray(jh), S)
    assert th[..., 2].sum() > 0


def test_plain_versions_sum_bf16_weights_exactly():
    """The port's f32 histograms are the exactly rounded sums of the
    bf16-rounded weights (f64 accumulation, one rounding)."""
    G, B, L, N = 3, 8, 5, 3000
    _, bins, leaf, grad, hess, cnt = _case(9, N, G, B, L)
    w = np.stack([grad, hess, cnt], axis=1)
    wb = TH.bf16_round(_t(w)).numpy().astype(np.float64)
    want = np.zeros((L, G, B, 3))
    for r in range(N):
        if leaf[r] >= 0:
            for g in range(G):
                want[leaf[r], g, bins[r, g]] += wb[r]
    slots = _t(np.arange(L, dtype=np.int32))
    got_f = TH.bins_hist(_t(bins), _t(w), _t(leaf), slots, B)
    got_e = TH.hist_pre(TH.precompute_bin_onehot(_t(bins), max_group_bin=B),
                        _t(w), _t(leaf), slots, max_group_bin=B, pack=1,
                        num_groups=G)
    np.testing.assert_array_equal(got_f.numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(got_e.numpy(), want.astype(np.float32))


def test_float_wrappers_reject_bad_inputs():
    G, B, N = 3, 8, 16
    ohb = torch.zeros((N, G * B), dtype=torch.int8)
    w = torch.zeros((N, 3))
    leaf = torch.zeros(N, dtype=torch.int32)
    slots = torch.zeros(2, dtype=torch.int32)
    kw = dict(max_group_bin=B, pack=1, num_groups=G)
    with pytest.raises(ValueError):          # wrong one-hot width
        TH.hist_pre(ohb[:, :-1].contiguous(), w, leaf, slots, **kw)
    with pytest.raises(ValueError):          # pack must divide G*B
        TH.hist_pre(ohb, w, leaf, slots, max_group_bin=B, pack=4,
                    num_groups=G - 1)
    with pytest.raises(TypeError):           # f64 weights
        TH.hist_pre(ohb, w.double(), leaf, slots, **kw)
    with pytest.raises(TypeError):           # quant flag vs weight type
        TH.compute_group_histograms_pre_packed(ohb, w, None, leaf, slots,
                                               max_group_bin=B, quant=True)
    with pytest.raises(ValueError):          # more than 126 slots
        TH.compute_group_histograms_pre_packed(
            ohb, w, None, leaf, torch.zeros(127, dtype=torch.int32),
            max_group_bin=B)
    with pytest.raises(ValueError):          # bins / weights mismatch
        TH.bins_hist(torch.zeros((N, G), dtype=torch.uint8), w[:4], leaf,
                     slots, B)


# ---------------------------------------------------------------------------
# (d) apply_splits and leaf_value_broadcast
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G,B", [(6, 16), (4, 63)])
def test_apply_splits_matches_jax(G, B):
    N, L = 1500, 40
    rng, bins, leaf, _, _, _ = _case(G + B, N, G, B, L)
    args = _route_args(rng, L, G, B, n_active=25)
    want = np.asarray(JP.apply_splits(jnp.asarray(bins), jnp.asarray(leaf),
                                      *[jnp.asarray(v)
                                        for v in args.values()]))
    got = TP.apply_splits(_t(bins), _t(leaf),
                          *[_t(v) for v in args.values()]).numpy()
    np.testing.assert_array_equal(want, got)
    assert (got != leaf).any()


def test_leaf_value_broadcast_matches_jax():
    rng = np.random.RandomState(3)
    L, N = 50, 3000
    values = (rng.randn(L) * 10.0 ** rng.randint(-6, 4, L)).astype(np.float32)
    leaf = rng.randint(-1, L + 3, N).astype(np.int32)   # padded / past L
    want = np.asarray(JH.leaf_value_broadcast(jnp.asarray(leaf),
                                              jnp.asarray(values)))
    got = TH.leaf_value_broadcast(_t(leaf), _t(values)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))
    assert (got[leaf < 0] == 0).all()


# ---------------------------------------------------------------------------
# plan resolution
# ---------------------------------------------------------------------------
_X = np.random.RandomState(5).randn(3000, 6)
_Y = (_X[:, 0] > 0).astype(float)
_BASE = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbose": -1, "quantized_grad": False,
         "hist_compute_dtype": "bfloat16"}
_KNOBS = {
    "default": {},
    "no_fused_route": {"hist_fused_route": False},
    "no_budget": {"hist_onehot_budget_mb": 0},
    "pack1": {"hist_onehot_pack": 1},
    "wide_frontier": {"num_leaves": 255, "frontier_width": 200},
    "quant": {"quantized_grad": True},
    "quant_untiled": {"quantized_grad": True, "hist_kernel_tiled": False},
    "quant_pre": {"quantized_grad": True, "hist_kernel_tiled": False,
                  "hist_fused_route": False, "hist_quant_onthefly": False},
    "quant_otf": {"quantized_grad": True, "hist_kernel_tiled": False,
                  "hist_fused_route": False},
    "quant_q_tiled": {"quantized_grad": True, "hist_fused_route": False},
    "split_route": {"quantized_grad": True, "hist_split_route": True},
    "f32_precision": {"quantized_grad": True, "hist_precision": "f32"},
    "paired": {"hist_kernel": "paired"},
    "xla_kernel": {"hist_kernel": "xla"},
    "f32_compute": {"hist_compute_dtype": "float32"},
    "nibble_fused": {"bin_packing": "4bit", "max_bin": 15},
    "nibble_no_budget": {"bin_packing": "4bit", "max_bin": 15,
                         "hist_onehot_budget_mb": 0},
}


def _jax_plan_name(g):
    """The JAX grower's telemetry plan name (grower.py:592-605), with
    the port's spelling of the variants the telemetry name folds."""
    if g.leaf_part:
        return "seg_tiled(leaf_partition)"
    if g.use_tiled:
        if not g.use_fused:
            return "q_tiled"
        return "q_tiled(split_route)" if g.split_route else "fused_tiled"
    if g.use_fused:
        return "fused_streamed"
    if g.use_quant_otf:
        return "q_onthefly"
    if g.use_pre_ohb:
        return "pre_onehot"
    if g.use_pallas:
        return "pallas_paired" if g.pallas_paired else (
            "pallas(quantized)" if g.use_quant else "pallas")
    return "xla"


@pytest.mark.parametrize("knobs", sorted(_KNOBS))
def test_plan_matches_jax_grower(knobs):
    params = dict(_BASE, **_KNOBS[knobs])
    jcfg = JConfig.from_params(dict(params, force_pallas_interpret=True))
    jds = jlgb.Dataset(_X, label=_Y).construct(jcfg)
    g = JTreeGrower(jds, jcfg)
    tcfg = TConfig.from_params(dict(params, device="cpu"))
    tds = tlgb.Dataset(_X, label=_Y).construct(tcfg)
    frontier = min(tcfg.num_leaves - 1, tcfg.frontier_width or 126)
    lay = tds.bin_layout
    assert (lay.device_spec if lay is not None else 0) == g.pack_P
    plan = TG.resolve_plan(tcfg, n_padded=g.n_padded,
                           num_groups=tds.num_groups,
                           max_group_bin=tds.max_group_bin,
                           frontier=frontier, pack_P=g.pack_P)
    assert plan.name == _jax_plan_name(g)
    assert (plan.quant, plan.fused, plan.tiled, plan.pre_ohb) == (
        g.use_quant, g.use_fused, g.use_tiled, g.use_pre_ohb)
    assert plan.ohb_pack == g.ohb_pack
    bst = tlgb.train(dict(params, device="cpu"), tlgb.Dataset(_X, label=_Y),
                     1, verbose_eval=False, keep_training_booster=True)
    assert bst.gbdt.grower.plan == plan
    assert bst.gbdt.grower.n_padded == g.n_padded


def test_row_bound_and_precision_repairs(capsys):
    """Past the int32 accumulator bound (a small bound passed in, not
    17M rows) quantized_grad trains the float plan with the JAX
    package's warning; hist_precision=f32 ignores quantized_grad;
    hist_precision=tiered past the bound raises."""
    shape = dict(num_groups=28, max_group_bin=63, frontier=126)
    tlgb.utils.log.Log.set_level(0)
    q = TConfig.from_params({"quantized_grad": True,
                             "hist_compute_dtype": "bfloat16"})
    assert TG.resolve_plan(q, n_padded=4096, quant_row_limit=8192,
                           **shape).name == "fused_tiled"
    plan = TG.resolve_plan(q, n_padded=16384, quant_row_limit=8192, **shape)
    assert plan.name == "fused_streamed" and not plan.quant
    assert "quantized_grad disabled" in capsys.readouterr().err
    f32 = TConfig.from_params({"quantized_grad": True,
                               "hist_precision": "f32",
                               "hist_compute_dtype": "bfloat16"})
    plan = TG.resolve_plan(f32, n_padded=4096, **shape)
    assert plan.name == "fused_streamed" and not plan.quant
    assert "quantized_grad ignored" in capsys.readouterr().err
    tiered = TConfig.from_params({"hist_precision": "tiered",
                                  "hist_compute_dtype": "bfloat16"})
    assert TG.resolve_plan(tiered, n_padded=4096, quant_row_limit=8192,
                           **shape).quant
    with pytest.raises(ValueError, match="tiered"):
        TG.resolve_plan(tiered, n_padded=16384, quant_row_limit=8192,
                        **shape)
    assert TG.QUANT_ROW_LIMIT * 127 < 2 ** 31 <= (TG.QUANT_ROW_LIMIT + 1) * 127


# ---------------------------------------------------------------------------
# (e) the slice end to end
# ---------------------------------------------------------------------------
ROUNDS = 5
_E2E = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
        "verbose": -1, "min_data_in_leaf": 5, "quantized_grad": False,
        "hist_compute_dtype": "bfloat16"}
_PLANS = {
    "fused_streamed": {},
    "pre_onehot": {"hist_fused_route": False},
    "pallas": {"hist_onehot_budget_mb": 0},
    "fused_streamed_int8": {"quantized_grad": True,
                            "hist_kernel_tiled": False},
    "pre_onehot_int8": {"quantized_grad": True, "hist_kernel_tiled": False,
                        "hist_fused_route": False,
                        "hist_quant_onthefly": False},
}


def _data(n, seed):
    """tests/test_torch_train.py's data: NaNs, a zero-heavy column."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[rng.rand(n, 8) < 0.05] = np.nan
    X[:, 3] = np.where(rng.rand(n) < 0.3, 0.0, X[:, 3])
    y = (X[:, 0] - 0.5 * np.nan_to_num(X[:, 1]) + 0.3 * rng.randn(n)
         > 0).astype(float)
    return X, y


@pytest.fixture(scope="module", params=sorted(_PLANS))
def trained(request):
    # the JAX grower calls these three entry points without its
    # interpret seam; bind it here (test-side only) so the CPU run
    # reaches the same Pallas bodies in interpret mode
    mp = pytest.MonkeyPatch()
    for name in ("compute_group_histograms_pre",
                 "compute_group_histograms_pre_packed",
                 "compute_group_histograms_pallas"):
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
    return dict(name=request.param.replace("_int8", ""), X=X, jb=jb, tb=tb)


def test_plan_is_the_jax_plan(trained):
    g, tp = trained["jb"].gbdt.grower, trained["tb"].gbdt.grower.plan
    assert _jax_plan_name(g) == tp.name == trained["name"]
    assert {"fused_streamed": (True, True), "pre_onehot": (False, True),
            "pallas": (False, False)}[tp.name] == (g.use_fused, g.use_pre_ohb)
    assert g.ohb_pack == tp.ohb_pack == 4


def test_trees_match(trained):
    """Every tree's structure is equal.  On the int8 variants the
    default-left bit is left out from the second tree on: a leaf with no
    missing values scores both scan directions equally up to rounding,
    and the gradients' last-bit difference (XLA's ``exp``, ROADMAP
    queue 3) moves the int8 scales enough to flip that tie."""
    jm, tm = trained["jb"].models, trained["tb"].models
    assert len(jm) == len(tm) == ROUNDS
    quant = trained["tb"].gbdt.grower.plan.quant
    for i, (jt, tt) in enumerate(zip(jm, tm)):
        assert jt.num_leaves == tt.num_leaves
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), f)
        keep = ~2 if quant and i else ~0
        np.testing.assert_array_equal(jt.decision_type & keep,
                                      tt.decision_type & keep)
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                                   atol=1e-9)
    pj = trained["jb"].predict(trained["X"], device=False)
    pt = trained["tb"].predict(trained["X"])
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
