"""Sub-byte bin storage (bin_packing=4bit, 2bit, auto) in the port
against the JAX package.

The device matrix is the storage matrix: (cols, N) transposed or
(N, cols), ``cols = storage_cols(G, spec)``, and every reader widens the
crumbs and nibbles itself.  The same numpy inputs, made from a seed, go
through the JAX function (its Pallas kernel in interpret mode, with
``packed_groups`` the pack spec) and the port's counterpart on CPU
tensors, which runs the kernel's plain version, over three layouts:
4bit (7 nibble groups), 2bit (6 crumb groups) and auto (3 crumb, 3
nibble and 2 wide groups: C % 4 != 0 and P - C odd, so a storage byte
holds the last crumbs and a 4-group tile straddles the sections):

* ``unpack_bins_cols`` and ``packed_select_params`` against the JAX
  functions and ``BinLayout.byte_of/shift_of/width_mask``;
* the plain versions of kernels A, G, J, B, H and D's routing on the
  storage against the Pallas bodies, bit for bit (int32 histograms, leaf
  ids, B's row values), and against themselves on the logical matrix;
* the XLA histogram (integer weights: exact sums), the one-hot builders,
  ``apply_splits`` and ``predict_binned`` on the storage;
* end to end: each packed-capable plan's model text under 4bit, 2bit
  and auto equal to its 8bit text with the ``bin_packing`` echo
  stripped; fused_tiled against ``lightgbm_tpu.train`` on the parameters
  of tests/test_compact_bins.py's interpret seam test; the plans without
  a packed path resolving as the JAX grower resolves them; and a
  packed run that trains, validates, rolls back and scans without ever
  unpacking the matrix on the host.

The CUDA kernels run only on the card: tests/test_torch_cuda.py holds
each packed launch against its plain version there.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Dataset as JDataset
from lightgbm_tpu.learner.grower import TreeArrays
from lightgbm_tpu.learner.grower import TreeGrower as JTreeGrower
from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import partition as JP
from lightgbm_tpu.ops import predict as JPR
from lightgbm_tpu_torch import packing as TPK
from lightgbm_tpu_torch.dataset import Dataset as TDataset
from lightgbm_tpu_torch.learner import grower as TG
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import partition as TP
from lightgbm_tpu_torch.ops import predict as TPR
from lightgbm_tpu_torch.utils.log import Log

#: layout -> (G, P, C, B): G logical groups, the first C crumbs and the
#: next P - C nibbles, B bins a group (a nibble of 15 and the wide
#: groups' B and B + 1 match nothing)
LAYOUTS = {"4bit": (7, 7, 0, 15), "2bit": (6, 6, 6, 4),
           "auto": (8, 6, 3, 63)}
N, L = 1024, 40
_ONES = jnp.ones(3, jnp.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _strip(text: str) -> str:
    return re.sub(r"\[bin_packing: \w+\]", "", text)


def _route_args(rng, G, B):
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
        threshold=rng.randint(0, 3, L).astype(np.int32),
        default_left=(np.arange(L) % 2 == 0),
        missing_type=(np.arange(L) % 3).astype(np.int32),
        default_bin=rng.randint(0, 4, L).astype(np.int32),
        num_bin=np.full(L, B, np.int32), cat_mask=rng.rand(L, B) > 0.5,
        right_slot=rs)


def _case(name, seed=0):
    """The layout, its logical (N, G) bins and their (N, cols) storage,
    leaf ids (5% padded), int8 weights, W = 30 slots with inert entries,
    and the route table's columns."""
    G, P, C, B = LAYOUTS[name]
    lay = TPK.BinLayout(name, G, P, C)
    rng = np.random.RandomState(seed + G)
    top = np.array([4] * C + [16] * (P - C) + [B + 2] * (G - P))
    logical = (rng.rand(N, G) * top).astype(np.uint8)
    leaf = rng.randint(0, L - 4, N).astype(np.int32)
    leaf[rng.rand(N) < 0.05] = -1
    cnt = (leaf >= 0).astype(np.float32)
    grad = rng.randn(N).astype(np.float32) * cnt
    hess = (rng.rand(N) * 0.25).astype(np.float32) * cnt
    wq, _ = TH.quantize_gradients(_t(grad), _t(hess), _t(cnt))
    slots = rng.permutation(L + 8)[:30].astype(np.int32)
    slots[rng.rand(30) < 0.1] = -1
    return dict(lay=lay, spec=lay.device_spec, G=G, B=B, logical=logical,
                storage=lay.pack_rows(logical), leaf=leaf,
                wT=wq.t().contiguous(), slots=slots,
                args=_route_args(rng, G, B), rng=rng)


def _tables(args):
    jt = JP.build_route_table(*[jnp.asarray(v) for v in args.values()])
    tt = TP.build_route_table(**{k: _t(v) for k, v in args.items()})
    return jt, tt


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# layout arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_unpack_and_select_match_jax(name):
    c = _case(name)
    lay, spec, G = c["lay"], c["spec"], c["G"]
    assert c["storage"].shape[1] == lay.cols < G
    got = TH.unpack_bins_cols(_t(c["storage"]), num_groups=G,
                              packed_groups=spec)
    assert got.dtype == torch.uint8
    _eq(got, c["logical"])
    _eq(JH.unpack_bins_cols(jnp.asarray(c["storage"]), num_groups=G,
                            packed_groups=spec), got)
    grp = torch.arange(G, dtype=torch.int32)
    sel = TP.packed_select_params(grp, spec)
    jsel = JP.packed_select_params(jnp.asarray(grp.numpy()), spec)
    want = ([lay.byte_of(g) for g in range(G)],
            [lay.shift_of(g) for g in range(G)],
            [lay.width_mask(g) for g in range(G)])
    for t, j, w in zip(sel, jsel, want):
        _eq(t, w)
        _eq(j, w)
    assert TH.groups_of_storage(lay.cols, spec) == G
    with pytest.raises(ValueError):
        TH.groups_of_storage(TPK.packed_bytes(spec) - 1, spec)


# ---------------------------------------------------------------------------
# kernels A, G, J, B, H and D's routing: plain versions on the storage
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_fused_route_and_tiled_hist_on_storage(name):
    """Kernel A (route, then histogram) and G: the JAX bodies in
    interpret mode on the storage, bit for bit; the same plain versions
    on the logical matrix give the same bits."""
    c = _case(name)
    spec, B, wT = c["spec"], c["B"], c["wT"]
    sT, lT = c["storage"].T.copy(), c["logical"].T.copy()
    jt, tt = _tables(c["args"])
    leaf, slots = c["leaf"], c["slots"]
    W = len(slots)
    jh, jl = JH.compute_group_histograms_fused_tiled(
        jnp.asarray(sT), jnp.asarray(wT.numpy()), _ONES, jnp.asarray(leaf),
        jt, jnp.asarray(slots), max_group_bin=B, block=256, strips=1,
        interpret=True, packed_groups=spec)
    th, tl = TH.fused_route_hist(_t(sT), wT, _t(leaf), tt, _t(slots), B,
                                 spec)
    assert th.dtype == torch.int32
    _eq(jl, tl)
    _eq(np.asarray(jh)[:W], th)
    assert (tl.numpy() != leaf).any() and th[..., 2].sum() > 0
    lh, ll = TH.fused_route_hist_plain(_t(lT), wT, _t(leaf), tt, _t(slots),
                                       B)
    assert torch.equal(lh, th) and torch.equal(ll, tl)
    # kernel G on the routed leaf ids
    jg = JH.compute_group_histograms_q_tiled(
        jnp.asarray(sT), jnp.asarray(wT.numpy()), _ONES, jnp.asarray(
            tl.numpy()), jnp.asarray(slots), max_group_bin=B, strips=1,
        block=256,
        interpret=True, packed_groups=spec)
    tg = TH.tiled_hist(_t(sT), wT, tl, _t(slots), B, spec)
    _eq(np.asarray(jg)[:W], tg)
    assert torch.equal(tg, th)
    assert torch.equal(TH.tiled_hist_plain(_t(lT), wT, tl, _t(slots), B),
                       tg)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_seg_hist_on_storage(name):
    """Kernel J over the leaf partition of the storage's columns: the
    JAX body in interpret mode, bit for bit, and the logical matrix's
    partition the same."""
    c = _case(name)
    spec, B, wT = c["spec"], c["B"], c["wT"]
    leaf = _t(c["leaf"])
    perm, blk_leaf, _ = TP.build_leaf_partition(leaf, num_slots=L + 8,
                                                block=128)
    sT_p = TP.apply_partition(_t(c["storage"].T.copy()), perm, axis=1)
    lT_p = TP.apply_partition(_t(c["logical"].T.copy()), perm, axis=1)
    wT_p = TP.apply_partition(wT, perm, axis=1)
    blk = TP.block_slots(blk_leaf, _t(np.abs(c["slots"])), L + 8)
    W = len(c["slots"])
    want = JH.compute_group_histograms_seg_tiled(
        jnp.asarray(sT_p.numpy()), jnp.asarray(wT_p.numpy()), _ONES,
        jnp.asarray(blk.numpy()), num_out=W, max_group_bin=B, block=128,
        interpret=True, packed_groups=spec)
    got = TH.seg_hist(sT_p, wT_p, blk, W, B, 128, packed_groups=spec)
    _eq(want, got)
    assert got[..., 2].sum() > 0
    assert torch.equal(TH.seg_hist_plain(lT_p, wT_p, blk, W, B, 128), got)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_route_apply_and_route_only_on_storage(name):
    """Kernels B and H: leaf ids and B's bf16-split row values bit for
    bit with the JAX bodies on the storage and with the logical
    matrix."""
    c = _case(name)
    spec, leaf = c["spec"], c["leaf"]
    sT, lT = c["storage"].T.copy(), c["logical"].T.copy()
    jt, tt = _tables(c["args"])
    values = (c["rng"].randn(2 * L) * 3).astype(np.float32)[:L]
    jl, jv = JH.route_apply_tiled(jnp.asarray(sT), jnp.asarray(leaf), jt,
                                  jnp.asarray(values), block=256,
                                  interpret=True, packed_groups=spec)
    tl, tv = TH.route_apply_tiled(_t(sT), _t(leaf), tt, _t(values), spec)
    _eq(jl, tl)
    _eq(np.asarray(jv).view(np.int32), tv.numpy().view(np.int32))
    ll, lv = TH.route_apply_plain(_t(lT), _t(leaf), tt, _t(values))
    assert torch.equal(ll, tl) and torch.equal(lv, tv)
    jh = JH.route_only_tiled(jnp.asarray(sT), jnp.asarray(leaf), jt,
                             block=N, interpret=True, packed_groups=spec)
    th = TH.route_only_tiled(_t(sT), _t(leaf), tt, spec)
    _eq(jh, th)
    assert torch.equal(th, tl) and (th.numpy() != leaf).any()
    assert torch.equal(TH.route_only_plain(_t(lT), _t(leaf), tt), th)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_fused_onehot_route_on_storage(name):
    """Kernel D with int8 weights: its routing over the storage and its
    histogram of the one-hot built from the storage, bit for bit with
    the JAX body in interpret mode, and the one-hot equal to JAX's."""
    c = _case(name)
    spec, B, G, wT = c["spec"], c["B"], c["G"], c["wT"]
    sT = c["storage"].T.copy()
    jt, tt = _tables(c["args"])
    leaf, slots = c["leaf"], c["slots"]
    jo = JH.precompute_bin_onehot(jnp.asarray(c["storage"]),
                                  max_group_bin=B, packed_groups=spec)
    to = TH.precompute_bin_onehot(_t(c["storage"]), max_group_bin=B,
                                  packed_groups=spec)
    _eq(jo, to)
    jh, jl = JH.compute_group_histograms_fused(
        jo, jnp.asarray(sT), jnp.asarray(wT.numpy()), _ONES,
        jnp.asarray(leaf), jt, jnp.asarray(slots), max_group_bin=B,
        block=256, strips=1, quant=True, interpret=True,
        packed_groups=spec)
    th, tl = TH.fused_onehot_hist(to, _t(sT), wT, _t(leaf), tt, _t(slots),
                                  max_group_bin=B, pack=1, num_groups=G,
                                  packed_groups=spec)
    assert th.dtype == torch.int32
    _eq(jl, tl)
    _eq(np.asarray(jh)[:len(slots)], th)
    lh, ll = TH.fused_onehot_hist_plain(
        to, _t(c["logical"].T.copy()), wT, _t(leaf), tt, _t(slots),
        max_group_bin=B, pack=1, num_groups=G)
    assert torch.equal(lh, th) and torch.equal(ll, tl)


# ---------------------------------------------------------------------------
# the torch-op readers: XLA histogram, one-hot builders, apply_splits,
# predict_binned
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_xla_histogram_and_onehots_on_storage(name):
    """The XLA form widens each row chunk: with integer weights its f32
    sums are exact, so the port on the storage equals the JAX function
    and the port on the logical matrix bit for bit; the planar one-hots
    of every pack that divides G * B equal JAX's."""
    c = _case(name)
    spec, B, G = c["spec"], c["B"], c["G"]
    rng = c["rng"]
    leaf = c["leaf"]
    grad = rng.randint(-3, 4, N).astype(np.float32)
    hess = rng.randint(0, 4, N).astype(np.float32)
    cnt = (leaf >= 0).astype(np.float32)
    kw = dict(num_leaves=L, max_group_bin=B, chunk=256)
    jh = JH.compute_group_histograms(
        jnp.asarray(c["storage"]), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), jnp.asarray(leaf), packed_groups=spec, **kw)
    th = TH.compute_group_histograms(
        _t(c["storage"]), _t(grad), _t(hess), _t(cnt), _t(leaf),
        packed_groups=spec, **kw)
    _eq(jh, th)
    assert torch.equal(th, TH.compute_group_histograms(
        _t(c["logical"]), _t(grad), _t(hess), _t(cnt), _t(leaf), **kw))
    for pack in (2, 4):
        if G * B % pack:
            continue
        _eq(JH.precompute_bin_onehot_packed(
                jnp.asarray(c["storage"]), max_group_bin=B, pack=pack,
                packed_groups=spec),
            TH.precompute_bin_onehot_packed(
                _t(c["storage"]), max_group_bin=B, pack=pack,
                packed_groups=spec))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_apply_splits_on_storage(name):
    c = _case(name)
    spec, args, leaf = c["spec"], c["args"], c["leaf"]
    want = JP.apply_splits(jnp.asarray(c["storage"]), jnp.asarray(leaf),
                           *[jnp.asarray(v) for v in args.values()],
                           packed_groups=spec)
    got = TP.apply_splits(_t(c["storage"]), _t(leaf),
                          *[_t(v) for v in args.values()],
                          packed_groups=spec)
    _eq(want, got)
    assert torch.equal(got, TP.apply_splits(
        _t(c["logical"]), _t(leaf), *[_t(v) for v in args.values()]))


#: end-to-end rows: 3 columns of 3 values (crumbs under 2bit and auto),
#: 3 of 8 values (nibbles), 2 continuous (wide at max_bin 63)
def _plan_data(n=1500, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 8)
    X[:, :3] = np.round(X[:, :3] * 2) / 2
    X[:, 3:6] = np.round(X[:, 3:6] * 7) / 7
    y = (X[:, 0] + 0.5 * X[:, 3] + X[:, 6] - 0.3 * X[:, 2]
         + 0.2 * rng.randn(n) > 1.2).astype(np.float64)
    return X, y


#: layout -> (max_bin, the spec the end-to-end rows take)
PLAN_LAYOUTS = {"4bit": (15, TPK.pack_spec(8)),
                "2bit": (4, TPK.pack_spec(8, 8)),
                "auto": (63, TPK.pack_spec(6, 3))}
BASE = {"objective": "binary", "num_leaves": 8, "min_data_in_leaf": 5,
        "verbose": -1, "device": "cpu"}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_predict_binned_on_storage(name):
    """A grown tree's walk over the storage equals the JAX walk over the
    same storage and the port's walk over the logical matrix."""
    X, y = _plan_data()
    mb, spec = PLAN_LAYOUTS[name]
    bst = tlgb.train(dict(BASE, max_bin=mb, bin_packing=name),
                     tlgb.Dataset(X, label=y), 2, keep_training_booster=True)
    g = bst.gbdt.grower
    assert g.pack_P == spec
    tree = bst.gbdt.device_trees[-1]
    storage = bst.gbdt.train_set.group_bins
    args = [g.f_group, g.g2f_lut, g.f_missing, g.f_default_bin, g.f_num_bin]
    got = TPR.predict_binned(tree, _t(storage), *args, spec)
    jtree = TreeArrays(**{f: jnp.asarray(np.asarray(tree[f]))
                          for f in TreeArrays._fields})
    want = JPR.predict_binned(jtree, jnp.asarray(storage),
                              *[jnp.asarray(a.numpy()) for a in args],
                              max_steps=7, packed_groups=spec)
    _eq(want, got)
    logical = _t(bst.gbdt.train_set.logical_group_bins())
    assert torch.equal(got, TPR.predict_binned(tree, logical, *args))


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------
PLANS = {
    "fused_tiled": {"quantized_grad": True,
                    "hist_compute_dtype": "bfloat16"},
    "q_tiled(split_route)": {"quantized_grad": True,
                             "hist_compute_dtype": "bfloat16",
                             "hist_split_route": True},
    "seg_tiled(leaf_partition)": {"quantized_grad": True,
                                  "hist_compute_dtype": "bfloat16",
                                  "hist_leaf_partition": "on"},
    "fused_streamed": {"hist_compute_dtype": "bfloat16"},
    "pre_onehot": {"hist_compute_dtype": "bfloat16",
                   "hist_fused_route": False},
    "xla": {},
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_packed_model_text_equals_8bit(plan):
    """Each packed-capable plan grows under 4bit, 2bit and auto the
    model it grows under 8bit, on the storage matrix."""
    X, y = _plan_data()
    for name, (mb, spec) in PLAN_LAYOUTS.items():
        params = dict(BASE, max_bin=mb, **PLANS[plan])
        texts = {}
        for mode in ("8bit", name):
            bst = tlgb.train(dict(params, bin_packing=mode),
                             tlgb.Dataset(X, label=y), 3,
                             keep_training_booster=True)
            g = bst.gbdt.grower
            assert g.plan.name == plan
            cols = TPK.storage_cols(8, g.pack_P) if g.pack_P else 8
            held = g.binsT if g.binsT is not None else g.bins.t()
            assert held.shape == (cols, g.n_padded)
            texts[mode] = bst.model_to_string()
        assert g.pack_P == spec
        assert _strip(texts[name]) == _strip(texts["8bit"]), (plan, name)


def test_fused_tiled_matches_lightgbm_tpu_train():
    """tests/test_compact_bins.py's interpret seam parameters under
    4bit, with hist_compute_dtype=bfloat16 (without it both packages
    resolve the xla plan): the port's fused_tiled trees are the JAX
    package's, split for split, leaf values within 1e-5 (the two differ
    in the last f32 bits under 8bit too: XLA contracts multiply-adds and
    its exp moves the int8 scales, ROADMAP queue 3)."""
    rng = np.random.RandomState(7)
    X = rng.rand(700, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0.8).astype(np.float64)
    p = {"objective": "binary", "max_bin": 15, "num_iterations": 3,
         "num_leaves": 6, "min_data_in_leaf": 5, "verbose": -1,
         "quantized_grad": True, "hist_compute_dtype": "bfloat16",
         "bin_packing": "4bit"}
    jb = jlgb.train(dict(p, force_pallas_interpret=True),
                    jlgb.Dataset(X, label=y), keep_training_booster=True)
    tb = tlgb.train(dict(p, device="cpu"), tlgb.Dataset(X, label=y),
                    keep_training_booster=True)
    jg = jb.gbdt.grower
    assert tb.gbdt.grower.plan.name == "fused_tiled"
    assert jg.use_tiled and jg.use_fused and not jg.split_route
    assert tb.gbdt.grower.pack_P == jg.pack_P == 6
    assert len(jb.models) == len(tb.models) == 3
    for jt, tt in zip(jb.models, tb.models):
        assert jt.num_leaves == tt.num_leaves
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "decision_type", "leaf_count"):
            _eq(getattr(jt, f)[:jt.num_leaves - 1 if "leaf" not in f
                               else jt.num_leaves],
                getattr(tt, f)[:tt.num_leaves - 1 if "leaf" not in f
                               else tt.num_leaves])
        np.testing.assert_allclose(tt.leaf_value[:tt.num_leaves],
                                   jt.leaf_value[:jt.num_leaves],
                                   rtol=1e-5, atol=1e-7)


def _jax_plan(g):
    """The JAX grower's plan among the ones a packed dataset can take."""
    if not g.use_pallas:
        return "xla"
    if g.use_pre_ohb:
        return "pre_onehot"
    return "pallas_paired" if g.pallas_paired else (
        "q_onthefly" if g.use_quant_otf else "pallas")


@pytest.mark.parametrize("plan,extra,packed_plan", [
    ("pallas", {"hist_onehot_budget_mb": 0}, "xla"),
    ("pallas_paired", {"hist_kernel": "paired"}, "xla"),
    ("q_onthefly", {"quantized_grad": True, "hist_kernel_tiled": False,
                    "hist_fused_route": False}, "pre_onehot")])
def test_plans_without_a_packed_path(plan, extra, packed_plan, capsys,
                                     monkeypatch):
    """pallas, pallas_paired and q_onthefly read byte-wide bins.  On a
    packed dataset both packages resolve the same plan: pallas and
    pallas_paired the xla plan, with the warning; q_onthefly, whose
    on-the-fly one-hot the JAX grower turns off for a packed matrix, the
    streamed one-hot of the storage (pre_onehot, int8 weights), whose
    model is the 8bit q_onthefly model."""
    monkeypatch.setattr(Log, "level", 1)    # the warnings, whatever ran
    X, y = _plan_data(n=600)
    params = dict(BASE, max_bin=15, hist_compute_dtype="bfloat16",
                  **extra)
    texts = {}
    for mode in ("8bit", "4bit"):
        cfg = tlgb.Config.from_params(dict(params, bin_packing=mode))
        core = TDataset.from_matrix(X, label=y, config=cfg)
        capsys.readouterr()
        g = TG.TreeGrower(core, cfg, torch.device("cpu"))
        err = capsys.readouterr().err
        jcfg = JConfig.from_params(dict(params, bin_packing=mode,
                                        force_pallas_interpret=True))
        jg = JTreeGrower(JDataset.from_matrix(X, label=y, config=jcfg), jcfg)
        want = plan if mode == "8bit" else packed_plan
        assert g.plan.name == _jax_plan(jg) == want
        assert ("no nibble-packed input path" in err) == (
            mode == "4bit" and want == "xla")
        if plan == "q_onthefly":
            texts[mode] = tlgb.train(dict(params, bin_packing=mode),
                                     tlgb.Dataset(X, label=y),
                                     3).model_to_string()
    if texts:
        assert _strip(texts["4bit"]) == _strip(texts["8bit"])


def test_packed_run_never_unpacks_on_the_host(monkeypatch):
    """A packed run trains, validates, rolls back and takes the binned
    scan with Dataset.logical_group_bins raising: the grower holds the
    (cols, n_padded) storage, and the validation scores, the rolled-back
    text and the scan equal the 8bit run's bit for bit."""
    X, y = _plan_data()
    Xv, yv = _plan_data(n=700, seed=5)
    params = dict(BASE, max_bin=63, metric="binary_logloss",
                  **PLANS["fused_tiled"])
    out = {}
    for mode in ("8bit", "auto"):
        if mode == "auto":
            def refuse(self):
                raise AssertionError("the storage matrix was unpacked")
            monkeypatch.setattr(TDataset, "logical_group_bins", refuse)
        train = tlgb.Dataset(X, label=y)
        valid = tlgb.Dataset(Xv, label=yv, reference=train)
        res = {}
        bst = tlgb.train(dict(params, bin_packing=mode), train, 4,
                         valid_sets=[valid], evals_result=res,
                         keep_training_booster=True, verbose_eval=False)
        g = bst.gbdt.grower
        cols = TPK.storage_cols(8, g.pack_P) if g.pack_P else 8
        assert g.binsT.shape == (cols, g.n_padded)
        assert g.resident_bin_bytes() == cols * g.n_padded
        scores = bst.gbdt.valid_sets[0].scores.clone()
        bst.rollback_one_iter()
        out[mode] = (res, scores, bst.model_to_string(),
                     bst._device_predict_raw(Xv, -1), g.resident_bin_bytes())
    (r8, s8, t8, p8, b8), (ra, sa, ta, pa, ba) = out["8bit"], out["auto"]
    assert ba * 8 == b8 * 5                      # 5 storage bytes for 8
    assert r8 == ra and torch.equal(s8, sa)
    assert _strip(t8) == _strip(ta)
    _eq(p8, pa)
