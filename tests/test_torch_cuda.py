"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``cuda`` marker; skipped without a CUDA device).  No jax here:
the card machine runs these with ``python -m pytest -m cuda
tests/test_torch_cuda.py``.

Integer outputs (leaf ids, int32 histograms, the count channel) are
held bit for bit.  The f32 grad/hess channels of kernels D, E and F are
sums of the same bf16 values accumulated in f64 by both sides (atomics
on the card, index_add_ in the plain version) and rounded once, so they
agree to one f32 ulp of the bin's absolute sum S (``F32_ULP * S``)."""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops import kernels
from lightgbm_tpu_torch.ops import predict as P
from lightgbm_tpu_torch.ops.partition import build_route_table
from lightgbm_tpu_torch.tree import Tree, flatten_ensemble

pytestmark = pytest.mark.cuda

F32_ULP = 2.0 ** -23


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _inputs(dev, N=5000, G=7, B=63, L=48, seed=5):
    rng = np.random.RandomState(seed)
    binsT = torch.from_numpy(rng.randint(0, B, (G, N)).astype(np.uint8))
    leaf = rng.randint(0, L - 4, N).astype(np.int32)
    leaf[rng.rand(N) < 0.05] = -1
    leaf = torch.from_numpy(leaf)
    cnt = (leaf >= 0).float()
    wq, _ = H.quantize_gradients(torch.randn(N, generator=torch.Generator(
    ).manual_seed(seed)) * cnt, torch.rand(N) * cnt, cnt)
    sm = torch.from_numpy(rng.rand(L) < 0.6)
    tab = build_route_table(
        sm, torch.from_numpy(rng.randint(0, G, L)), torch.zeros(L),
        torch.full((L,), B), torch.zeros(L), torch.full((L,), B - 1),
        torch.from_numpy(rng.rand(L) < 0.25),
        torch.from_numpy(rng.randint(0, B - 1, L)),
        torch.from_numpy(rng.rand(L) < 0.5),
        torch.from_numpy(rng.randint(0, 3, L)),
        torch.from_numpy(rng.randint(0, B, L)), torch.full((L,), B),
        torch.from_numpy(rng.rand(L, B) < 0.5),
        torch.arange(L, 2 * L))
    slots = torch.from_numpy(rng.permutation(2 * L)[:40].astype(np.int32))
    return [t.to(dev) for t in (binsT, wq.t().contiguous(), leaf, tab,
                                slots)], B


def test_fused_route_hist_kernel_matches_plain(dev):
    ins, B = _inputs(dev)
    n0 = kernels.LAUNCHES["fused_route_hist"]
    hk, lk = H.fused_route_hist(*ins, B)
    hp, lp = H.fused_route_hist_plain(*ins, B)
    assert kernels.LAUNCHES["fused_route_hist"] == n0 + 1
    assert torch.equal(hk, hp) and torch.equal(lk, lp)


def test_route_apply_kernel_matches_plain(dev):
    (binsT, _, leaf, tab, _), _ = _inputs(dev)
    vals = torch.randn(tab.shape[0], device=dev)
    lk, vk = H.route_apply_tiled(binsT, leaf, tab, vals)
    lp, vp = H.route_apply_plain(binsT, leaf, tab, vals)
    assert torch.equal(lk, lp)
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))


def test_predict_level_kernel_matches_plain(dev):
    rng = np.random.RandomState(2)
    t = Tree(4)
    t.split_feature[:] = [0, 1, 0]
    t.threshold[:] = [0.25, np.inf, -1.5]
    t.decision_type[:] = [2 | (2 << 2), 1 << 2, 0]
    t.left_child[:] = [1, -1, -3]
    t.right_child[:] = [2, -2, -4]
    t.leaf_value[:] = rng.randn(4)
    stump = Tree(1)
    stump.leaf_value[0] = 0.5
    flat = flatten_ensemble([t, stump, t], 1)
    depth = int(flat.pop("depth"))
    stack = P.level_ensemble_from_numpy(flat, dev)
    X = rng.randn(3000, 2)
    X[rng.rand(3000, 2) < 0.1] = np.nan
    X[rng.rand(3000, 2) < 0.1] = 0.0
    x2 = torch.from_numpy(P.interleave_hi_lo(X)).to(dev)
    got = P.predict_level_ensemble(stack, x2, depth=depth)
    want = P.predict_level_ensemble_plain(stack, x2, depth=depth)
    assert bool(((got - want).abs() <= 1e-5 * (1 + want.abs())).all())


def _float_inputs(dev, pack, quant, N=6000, G=7, B=36, L=48, seed=9):
    """Kernel D/E/F inputs: the route table, bins and slots of _inputs,
    the one-hot at ``pack``, and (3, N) weights, f32 or int8."""
    (binsT, wq, leaf, tab, slots), _ = _inputs(dev, N, G, B, L, seed)
    bins = binsT.t().contiguous()
    ohb = (H.precompute_bin_onehot(bins, max_group_bin=B) if pack == 1
           else H.precompute_bin_onehot_packed(bins, max_group_bin=B,
                                               pack=pack))
    g = torch.Generator().manual_seed(seed)
    cnt = (leaf >= 0).float()
    wT = wq if quant else torch.stack([
        torch.randn(N, generator=g).to(dev) * cnt,
        torch.rand(N, generator=g).to(dev) * cnt, cnt]).contiguous()
    return ohb, bins, binsT, wT, leaf, tab, slots, B, G


def _assert_close(got, want, S):
    if got.dtype == torch.int32:
        assert torch.equal(got, want)
        return
    assert torch.equal(got[..., 2], want[..., 2])
    assert bool(((got - want).abs() <= F32_ULP * S).all())


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("pack,B", [(1, 36), (1, 35), (4, 36)])
def test_fused_onehot_hist_kernel_matches_plain(dev, pack, B, quant):
    # rows of 252 bytes (4-byte loads), 245 (byte loads), 128 (16-byte)
    ohb, _, binsT, wT, leaf, tab, slots, B, G = _float_inputs(dev, pack,
                                                              quant, B=B)
    kw = dict(max_group_bin=B, pack=pack, num_groups=G)
    n0 = kernels.LAUNCHES["fused_onehot_hist"]
    hk, lk = H.fused_onehot_hist(ohb, binsT, wT, leaf, tab, slots, **kw)
    hp, lp = H.fused_onehot_hist_plain(ohb, binsT, wT, leaf, tab, slots, **kw)
    assert kernels.LAUNCHES["fused_onehot_hist"] == n0 + 1
    assert torch.equal(lk, lp)
    S = H.onehot_hist_plain(ohb, wT.t().abs(), lp, slots, **kw) \
        if not quant else None
    _assert_close(hk, hp, S)


@pytest.mark.parametrize("entry", ["hist_pre_packed", "hist_pre"])
@pytest.mark.parametrize("pack", [1, 2, 4])
def test_pre_hist_kernels_match_plain(dev, entry, pack):
    ohb, _, _, wT, leaf, _, slots, B, G = _float_inputs(dev, pack, False)
    w = wT.t().contiguous()
    if entry == "hist_pre":      # a width above the packed kernel's 126
        slots = torch.arange(-3, 150, dtype=torch.int32, device=dev)
    kw = dict(max_group_bin=B, pack=pack, num_groups=G)
    n0 = kernels.LAUNCHES[entry]
    hk = getattr(H, entry)(ohb, w, leaf, slots, **kw)
    hp = getattr(H, entry + "_plain")(ohb, w, leaf, slots, **kw)
    assert kernels.LAUNCHES[entry] == n0 + 1
    _assert_close(hk, hp, H.onehot_hist_plain(ohb, w.abs(), leaf, slots,
                                              **kw))


@pytest.mark.parametrize("first_round", [False, True])
def test_bins_hist_kernel_matches_plain(dev, first_round):
    _, bins, _, wT, leaf, _, slots, B, _ = _float_inputs(dev, 1, False)
    bins[::7, 2] = B + 3                   # bins >= B match nothing
    w = wT.t().contiguous()
    if first_round:                        # every row in one slot
        leaf = torch.where(leaf >= 0, 0, -1).to(torch.int32)
        slots = torch.zeros(1, dtype=torch.int32, device=dev)
    n0 = kernels.LAUNCHES["bins_hist"]
    hk = H.bins_hist(bins, w, leaf, slots, B)
    hp = H.bins_hist_plain(bins, w, leaf, slots, B)
    assert kernels.LAUNCHES["bins_hist"] == n0 + 1
    _assert_close(hk, hp, H.bins_hist_plain(bins, w.abs(), leaf, slots, B))
