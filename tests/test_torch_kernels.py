"""The port's kernel modules against the JAX package, op by op.

Same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernels in interpret mode, as the JAX package's own tests run
them on the CPU) and the port's counterpart on CPU tensors, which runs
the kernel's plain PyTorch version:

* fused route + histogram (kernel A) and exit route (kernel B):
  int32 histograms, leaf ids and row values bit for bit, on route
  tables with NaN / zero-default / categorical / inactive leaves;
* ensemble level descent (kernel C): within 1e-6 on +-inf thresholds,
  NaN, stumps and categoricals;
* quantization, route tables, prefix sums and the split finder.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds each against its plain version there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import partition as JP
from lightgbm_tpu.ops import predict as JPR
from lightgbm_tpu.ops import split as JS
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import partition as TP
from lightgbm_tpu_torch.ops import predict as TPR
from lightgbm_tpu_torch.ops import split as TS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _route_args(rng, L, G, B, n_active):
    """Route-table columns over L leaves: the first n_active split, with
    every missing type, both default directions and categorical
    left-sets; the rest are inactive."""
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


def _tables(args):
    jt = JP.build_route_table(*[jnp.asarray(v) for v in args.values()])
    tt = TP.build_route_table(**{k: _t(v) for k, v in args.items()})
    return jt, tt


def _case(seed, N, G, B, L):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (N, G)).astype(np.uint8)
    leaf = rng.randint(0, L - 4, N).astype(np.int32)
    leaf[rng.rand(N) < 0.05] = -1                       # padded rows
    grad = rng.randn(N).astype(np.float32)
    hess = (rng.rand(N) * 0.25).astype(np.float32)
    cnt = (leaf >= 0).astype(np.float32)
    grad *= cnt
    hess *= cnt
    args = _route_args(rng, L, G, B, n_active=L // 2)
    return rng, bins, leaf, grad, hess, cnt, args


def test_route_table_matches_jax():
    rng = np.random.RandomState(0)
    args = _route_args(rng, 40, 9, 21, 17)
    jt, tt = _tables(args)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


def test_quantize_gradients_matches_jax():
    rng = np.random.RandomState(1)
    g = (rng.randn(5000) * 0.4).astype(np.float32)
    h = (rng.rand(5000) * 0.25).astype(np.float32)
    c = (rng.rand(5000) > 0.1).astype(np.float32)
    jw, js = JH.quantize_gradients(jnp.asarray(g), jnp.asarray(h),
                                   jnp.asarray(c))
    tw, ts = TH.quantize_gradients(_t(g), _t(h), _t(c))
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("G,B,W,strips", [(6, 16, 10, 1), (5, 63, 60, 2),
                                          (3, 31, 100, 3)])
def test_fused_route_hist_matches_jax_interpret(G, B, W, strips):
    """Kernel A's plain version == the Pallas fused tiled kernel in
    interpret mode: int32 histogram (through unit scales), dequantized
    histogram and post-route leaf ids, bit for bit."""
    N, L = 1024, W + 24
    rng, bins, leaf, grad, hess, cnt, args = _case(G * B, N, G, B, L)
    jt, tt = _tables(args)
    wq, scales = TH.quantize_gradients(_t(grad), _t(hess), _t(cnt))
    wT = wq.t().contiguous()
    slots = rng.permutation(L)[:W].astype(np.int32)
    slots[rng.rand(W) < 0.1] = -1                       # inert entries
    for sc in (np.ones(3, np.float32), scales.numpy()):
        jh, jl = JH.compute_group_histograms_fused_tiled(
            jnp.asarray(bins.T), jnp.asarray(wT.numpy()), jnp.asarray(sc),
            jnp.asarray(leaf), jt, jnp.asarray(slots), max_group_bin=B,
            block=256, strips=strips, interpret=True)
        th, tl = TH.compute_group_histograms_fused_tiled(
            _t(bins.T), wT, _t(sc), _t(leaf), tt, _t(slots),
            max_group_bin=B)
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        np.testing.assert_array_equal(np.asarray(jh)[:W], th.numpy())
    assert (tl.numpy() != leaf).any()          # the table routed rows


@pytest.mark.parametrize("G,B", [(6, 16), (4, 63)])
def test_route_apply_matches_jax_interpret(G, B):
    """Kernel B's plain version == the Pallas exit-route kernel in
    interpret mode: leaf ids and bf16-split row values bit for bit."""
    N, L = 1024, 40
    rng, bins, leaf, _, _, _, args = _case(7 + B, N, G, B, L)
    jt, tt = _tables(args)
    values = (rng.randn(L) * 3).astype(np.float32)
    jl, jv = JH.route_apply_tiled(jnp.asarray(bins.T), jnp.asarray(leaf),
                                  jt, jnp.asarray(values), block=256,
                                  interpret=True)
    tl, tv = TH.route_apply_tiled(_t(bins.T), _t(leaf), tt, _t(values))
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jv).view(np.int32),
                                  tv.numpy().view(np.int32))
    # the row values are the bf16-split reassembly, not the raw values
    assert (tv.numpy()[leaf >= 0] == 0).sum() < N


def test_split3_matches_jax():
    v = (np.random.RandomState(3).randn(300) * 7).astype(np.float32)
    for a, b in zip(JP._split3_bf16(jnp.asarray(v)), TP._split3_bf16(_t(v))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("B", [2, 16, 17, 63, 255])
def test_cumsum_order_matches_jax(B):
    x = (np.random.RandomState(B).randint(-127, 128, (7, 5, B))
         .astype(np.float32) * np.float32(0.0123457))
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=2))(x))
    np.testing.assert_array_equal(want, TS.cumsum_f32(_t(x)).numpy())


def test_expand_and_leaf_totals_match_jax():
    rng = np.random.RandomState(4)
    hist = rng.randn(3, 4, 10, 3).astype(np.float32)
    bin_map = np.arange(4 * 10, dtype=np.int32).reshape(4, 10)
    bin_map[1, 7:] = -1
    fix_bin = np.array([-1, -1, 2, -1], np.int32)
    tot = rng.randn(3, 3).astype(np.float32)
    je = JH.expand_feature_histograms(jnp.asarray(hist), jnp.asarray(bin_map),
                                      jnp.asarray(fix_bin), jnp.asarray(tot))
    te = TH.expand_feature_histograms(_t(hist), _t(bin_map), _t(fix_bin),
                                      _t(tot))
    np.testing.assert_allclose(np.asarray(je), te.numpy(), rtol=1e-6)
    n = 4096
    g = rng.randn(n).astype(np.float32)
    h = rng.rand(n).astype(np.float32)
    c = np.ones(n, np.float32)
    lid = np.zeros(n, np.int32)
    lid[-96:] = -1
    jt = jax.jit(JH.compute_leaf_totals, static_argnums=4)(g, h, c, lid, 1)
    tt = TH.compute_root_totals(_t(g), _t(h), _t(c), _t(lid >= 0))
    np.testing.assert_array_equal(np.asarray(jt)[0], tt.numpy())


def test_split_finder_matches_jax():
    """Same histograms -> same thresholds, directions, left sums and
    outputs; gains agree to f32 rounding (XLA may fuse a multiply-add)."""
    rng = np.random.RandomState(0)
    W, F, B = 6, 8, 63
    q = rng.randint(-127, 128, (W, F, B, 3)).astype(np.float32)
    q[..., 2] = np.abs(q[..., 2])
    hist = (q * np.array([0.0123, 0.0041, 1.0], np.float32)).astype(
        np.float32)
    sg = hist[:, 0, :, 0].sum(1).astype(np.float32)
    sh = (hist[:, 0, :, 1].sum(1) + 50).astype(np.float32)
    cnt = hist[:, 0, :, 2].sum(1).astype(np.float32)
    nb = np.full(F, 63, np.int32)
    nb[2] = 40
    mt = np.array([0, 1, 2, 0, 2, 1, 0, 2], np.int32)
    db = np.zeros(F, np.int32)
    db[5] = 7
    mono = np.zeros(F, np.int32)
    mc = np.full(W, -np.inf, np.float32)
    xc = np.full(W, np.inf, np.float32)
    cfg = dict(lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
               min_data_in_leaf=5.0, min_sum_hessian_in_leaf=1e-3,
               min_gain_to_split=0.0)
    fm = np.ones(F, bool)
    ic = np.zeros(F, bool)
    jb = np.asarray(jax.jit(lambda *a: JS.find_best_split_block(
        *a, cfg, nb, mt, db, mono, ic, fm, False))(hist, sg, sh, cnt, mc,
                                                   xc))
    tb = TS.find_best_split_block(
        _t(hist), _t(sg), _t(sh), _t(cnt), _t(mc), _t(xc), cfg, _t(nb),
        _t(mt), _t(db), _t(mono), _t(ic), _t(fm), False,
        _t(np.nonzero(ic)[0])).numpy()
    cols = [TS.CAND_FEATURE, TS.CAND_THRESHOLD, TS.CAND_DEFAULT_LEFT,
            TS.CAND_LSG, TS.CAND_LSH, TS.CAND_LSC, TS.CAND_LOUT,
            TS.CAND_ROUT]
    np.testing.assert_array_equal(jb[:, cols], tb[:, cols])
    np.testing.assert_allclose(jb[:, TS.CAND_GAIN], tb[:, TS.CAND_GAIN],
                               rtol=2e-6)


# ---------------------------------------------------------------------------
# kernel C: ensemble level descent
# ---------------------------------------------------------------------------
_HEAD = ("tree\nversion=v2\nnum_class=1\nnum_tree_per_iteration=1\n"
         "label_index=0\nmax_feature_idx=1\nobjective=regression\n"
         "feature_names=f0 f1\nfeature_infos=[-1e+30:1e+30] [-1e+30:1e+30]\n"
         "tree_sizes=1\n\n")
_INF = ("num_leaves=3\nnum_cat=0\nsplit_feature=0 1\nsplit_gain=1 1\n"
        "threshold=inf -inf\ndecision_type={dt} {dt}\nleft_child=1 -1\n"
        "right_child=-1 -2\nleaf_value=0.5 -1.25 2.75\nleaf_count=2 2 2\n"
        "internal_value=0 0\ninternal_count=6 4\nshrinkage=1\n")
_STUMP = ("num_leaves=1\nnum_cat=0\nleaf_value=0.625\nleaf_count=7\n"
          "shrinkage=1\n")
_PLAIN = ("num_leaves=2\nnum_cat=0\nsplit_feature=0\nsplit_gain=1\n"
          "threshold=0.25\ndecision_type={dt}\nleft_child=-1\n"
          "right_child=-2\nleaf_value=1.5 -0.75\nleaf_count=3 4\n"
          "internal_value=0\ninternal_count=7\nshrinkage=1\n")
_CAT = ("num_leaves=3\nnum_cat=2\nsplit_feature=1 0\nsplit_gain=1 1\n"
        "threshold=0 1\ndecision_type=1 1\nleft_child=1 -1\n"
        "right_child=-1 -2\nleaf_value=0.25 -0.5 1.75\nleaf_count=2 2 2\n"
        "internal_value=0 0\ninternal_count=6 4\ncat_boundaries=0 1 3\n"
        "cat_threshold=10 1 2\nshrinkage=1\n")


def _models(blocks):
    import lightgbm_tpu as jlgb
    text = _HEAD + "".join(f"Tree={i}\n{b}\n" for i, b in enumerate(blocks))
    return jlgb.Booster(model_str=text)


_VALS = [-np.inf, -5.0, -1e-40, 0.0, 0.25, 1.0, 3.0, 33.0, 40.0, 5.0,
         np.inf, np.nan]
_ENSEMBLES = {
    "inf_none": [_INF.format(dt=0)],
    "inf_nan": [_INF.format(dt=8), _PLAIN.format(dt=10)],
    "zero": [_PLAIN.format(dt=4), _PLAIN.format(dt=6), _STUMP],
    "stumps": [_STUMP, _STUMP],
    "categorical": [_CAT, _PLAIN.format(dt=8), _STUMP],
}


@pytest.mark.parametrize("case", sorted(_ENSEMBLES))
def test_level_ensemble_matches_jax(case):
    """Kernel C's plain version == predict_level_ensemble and
    predict_level_ensemble_pallas (interpret) on corner-case ensembles;
    the flat tables come from the JAX package and cross over through
    convert.level_ensemble_from_numpy."""
    from lightgbm_tpu.tree import flatten_ensemble
    from lightgbm_tpu_torch.convert import level_ensemble_from_numpy
    jb = _models(_ENSEMBLES[case])
    flat = flatten_ensemble(jb.models, 1)
    depth = int(flat.pop("depth"))
    probe = np.array([[a, b] for a in _VALS for b in _VALS])
    x2 = TPR.interleave_hi_lo(probe)
    stack = JPR.LevelEnsemble(**{k: jnp.asarray(v) for k, v in flat.items()})
    want = np.asarray(JPR.predict_level_ensemble(stack, jnp.asarray(x2),
                                                 depth=depth))
    want_k = np.asarray(JPR.predict_level_ensemble_pallas(
        stack, jnp.asarray(x2), depth=depth, tile=16, interpret=True))
    got = TPR.predict_level_ensemble(
        level_ensemble_from_numpy(flat, "cpu"), _t(x2), depth=depth).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want_k, rtol=0, atol=1e-6)
    # the host walk (f64), on the rows it takes (it refuses +-inf
    # categories)
    fin = ~np.isinf(probe).any(axis=1)
    host = sum(t.predict(probe[fin]) for t in jb.models)
    np.testing.assert_allclose(got[fin, 0], host, rtol=1e-6, atol=1e-6)


def test_wrappers_reject_bad_inputs():
    bins = torch.zeros((3, 8), dtype=torch.uint8)
    wT = torch.zeros((3, 8), dtype=torch.int32)
    leaf = torch.zeros(8, dtype=torch.int32)
    tab = torch.zeros((4, 17))
    slots = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        TH.fused_route_hist(bins.to(torch.int32), wT, leaf, tab, slots, 4)
    with pytest.raises(ValueError):
        TH.fused_route_hist(bins, wT[:, :4].contiguous(), leaf, tab, slots, 4)
    with pytest.raises(ValueError):
        TH.fused_route_hist(bins.t(), wT, leaf, tab, slots, 4)
    with pytest.raises(ValueError):
        TH.route_apply_tiled(bins, leaf, tab, torch.zeros(3))
