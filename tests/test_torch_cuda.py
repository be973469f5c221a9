"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``cuda`` marker; skipped without a CUDA device).  No jax here:
the card machine runs these with ``python -m pytest -m cuda
tests/test_torch_cuda.py``.

Integer outputs (leaf ids, int32 histograms, the count channel) are
held bit for bit.  The f32 grad/hess channels of kernels D, E, F and K
are sums of the same bf16 values accumulated in f64 by both sides
(shared-memory histograms flushed with global atomics on the card,
index_add_ in the plain version) and rounded once, so they agree to one
f32 ulp of the bin's absolute sum S (``F32_ULP * S``)."""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.learner import grower
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.ops import kernels
from lightgbm_tpu_torch.ops import predict as P
from lightgbm_tpu_torch.ops.partition import (apply_partition, block_slots,
                                              build_leaf_partition,
                                              build_route_table)
from lightgbm_tpu_torch.tree import Tree, flatten_ensemble

import lightgbm_tpu_torch as tlgb
import torch_predict_cases as C

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


def _slot_cases(slots):
    """The frontier of _inputs, no slot at all, and only inert ones."""
    none = slots[:0]
    return {"frontier": slots, "W=0": none,
            "all negative": torch.full_like(slots[:5], -1)}


@pytest.mark.parametrize("case", ["frontier", "W=0", "all negative"])
def test_tiled_hist_kernel_matches_plain(dev, case):
    (binsT, wT, leaf, _, slots), B = _inputs(dev)
    slots = _slot_cases(slots)[case]
    n0 = kernels.LAUNCHES["tiled_hist"]
    hk = H.tiled_hist(binsT, wT, leaf, slots, B)
    hp = H.tiled_hist_plain(binsT, wT, leaf, slots, B)
    assert kernels.LAUNCHES["tiled_hist"] == n0 + 1
    assert hk.shape == (slots.shape[0], binsT.shape[0], B, 3)
    assert torch.equal(hk, hp)
    assert (hk.abs().sum() > 0) == (case == "frontier")


def test_route_only_kernel_matches_plain(dev):
    (binsT, _, leaf, tab, _), _ = _inputs(dev)
    n0 = kernels.LAUNCHES["route_only"]
    lk = H.route_only_tiled(binsT, leaf, tab)
    lp = H.route_only_plain(binsT, leaf, tab)
    assert kernels.LAUNCHES["route_only"] == n0 + 1
    assert torch.equal(lk, lp) and bool((lk != leaf).any())


@pytest.mark.parametrize("entry", ["bins_hist_q", "bins_hist_q_packed"])
@pytest.mark.parametrize("case", ["frontier", "W=0", "all negative",
                                  "B=255"])
def test_bins_hist_q_kernel_matches_plain(dev, entry, case):
    B = 255 if case == "B=255" else 63
    (binsT, wT, leaf, _, slots), B = _inputs(dev, B=B)
    bins = binsT.t().contiguous()
    bins[::7, 2] = 255 if B == 255 else B + 3      # bins >= B match nothing
    wq = wT.t().contiguous()
    slots = _slot_cases(slots).get(case, slots)
    n0 = kernels.LAUNCHES[entry]
    hk = getattr(H, entry)(bins, wq, leaf, slots, B)
    hp = H.bins_hist_plain(bins, wq, leaf, slots, B)
    assert kernels.LAUNCHES[entry] == n0 + 1
    assert hk.dtype == torch.int32 and torch.equal(hk, hp)


def test_route_apply_kernel_matches_plain(dev):
    (binsT, _, leaf, tab, _), _ = _inputs(dev)
    vals = torch.randn(tab.shape[0], device=dev)
    lk, vk = H.route_apply_tiled(binsT, leaf, tab, vals)
    lp, vp = H.route_apply_plain(binsT, leaf, tab, vals)
    assert torch.equal(lk, lp)
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))


#: f32 leaf values at the edges of kernel B's in-kernel bf16 split: signed
#: zeros, subnormals, values near 2^-100 and 2^100, values whose low 16
#: mantissa bits are all set or all clear
EDGE_VALUES = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 1.17e-38, -5.9e-39, 2.0 ** -100,
     -(2.0 ** -100) * 1.2345678, 2.0 ** 100, -(2.0 ** 100) * 1.9999999,
     1.0, -1.0, 3.1415927, 1.0000001, -0.33333334, 65535.996, 6.1e-5],
    dtype=np.float32)
ROUTE_APPLY_CASES = ["right children in the table", "odd rows",
                     "edge values", "leaf ids past the table",
                     "no splitting leaf", "values past shared memory"]


@pytest.mark.parametrize("case", ROUTE_APPLY_CASES)
def test_route_apply_kernel_cases(dev, case):
    """Kernel B (one launch that derives each leaf's keep and
    right-child values from the (L,) values) against its plain version
    (the six bf16-split table columns): leaf ids and the values' bits.
    _inputs' table mixes numerical splits (NaN and zero missing types)
    and categorical ones, non-splitting leaves and 5% negative leaves."""
    L = 7000 if case == "values past shared memory" else 48
    N = 5001 if case == "odd rows" else 5000
    (binsT, _, leaf, tab, _), _ = _inputs(dev, N=N, L=L)
    rng = np.random.RandomState(3)
    if case != "leaf ids past the table":     # right children below L
        rs = torch.from_numpy(rng.randint(0, L, L)).to(dev)
        tab[:, 8], tab[:, 9] = (rs // 256).float(), (rs % 256).float()
    if case == "leaf ids past the table":
        leaf = torch.where(torch.from_numpy(rng.rand(N) < 0.2).to(dev),
                           leaf + L, leaf).to(torch.int32)
    if case == "no splitting leaf":
        tab[:, 10] = 0
    vals = rng.randn(L).astype(np.float32) * np.float32(2.0) ** rng.randint(
        -30, 30, L)
    if case == "edge values":
        vals[:len(EDGE_VALUES)] = EDGE_VALUES
        vals[len(EDGE_VALUES):] = rng.choice(EDGE_VALUES,
                                             L - len(EDGE_VALUES))
    vals = torch.from_numpy(vals.astype(np.float32)).to(dev)
    n0 = kernels.LAUNCHES["route_apply"]
    lk, vk = H.route_apply_tiled(binsT, leaf, tab, vals)
    lp, vp = H.route_apply_plain(binsT, leaf, tab, vals)
    assert kernels.LAUNCHES["route_apply"] == n0 + 1
    assert torch.equal(lk, lp)
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))
    moved = bool((lk != leaf).any())
    assert moved == (case != "no splitting leaf")


@pytest.mark.parametrize("N", [5000, 5001])
@pytest.mark.parametrize("L", [1228, 1229, 6144, 6145])
def test_route_apply_kernel_shared_memory_tiers(dev, L, N):
    """Kernel B at the leaf counts where its shared memory changes form:
    route records and value pairs up to 1,228 leaves, the value pairs
    alone up to 6,144, neither past that; the 4-row and 1-row paths,
    against its plain version."""
    (binsT, _, leaf, tab, _), _ = _inputs(dev, N=N, L=L)
    rng = np.random.RandomState(4)
    rs = torch.from_numpy(rng.randint(0, L, L)).to(dev)
    tab[:, 8], tab[:, 9] = (rs // 256).float(), (rs % 256).float()
    vals = torch.from_numpy(rng.randn(L).astype(np.float32)).to(dev)
    lk, vk = H.route_apply_tiled(binsT, leaf, tab, vals)
    lp, vp = H.route_apply_plain(binsT, leaf, tab, vals)
    assert torch.equal(lk, lp)
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))
    assert bool((lk != leaf).any())


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


def _records_case(dev, name, n):
    flat, depth, _, F, cats = C.ensemble(name)
    stack = P.level_ensemble_from_numpy(flat, dev)
    x2 = torch.from_numpy(P.interleave_hi_lo(C.rows(n, F, cats=cats))).to(dev)
    return stack, P.pack_level_records(stack), x2, depth


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("n", [1, 5001])
@pytest.mark.parametrize("name", sorted(C.ENSEMBLES))
def test_predict_level_tiers_match_plain(dev, name, n):
    """Both tiers of kernel C on each test ensemble (the bench's leaf-wise
    trees, 500 trees in many chunks, K = 3, categorical bitsets of two
    words, stumps only, a tree past 16-bit child codes) at one row and at
    a row count no multiple of the tile: equal bit for bit to each other
    and to the records' plain walk (both add a row's trees in tree order
    from 0.0), within 1e-5 * (1 + |score|) of the JAX form's plain
    version (a matrix product)."""
    stack, rec, x2, depth = _records_case(dev, name, n)
    want = P.predict_level_ensemble_plain(stack, x2, depth=depth)
    plain = P.predict_level_records_plain(rec, x2, depth=depth)
    tiers = ["global"] if name == "wide tree" else ["global", "shared"]
    for tier in tiers:
        key = "predict_level" if tier == "shared" else "predict_level_global"
        n0 = kernels.LAUNCHES[key]
        got = P.predict_level_ensemble(rec, x2, depth=depth, tier=tier)
        assert kernels.LAUNCHES[key] == n0 + 1
        assert torch.equal(_bits(got), _bits(plain)), tier
        assert bool(((got - want).abs() <= 1e-5 * (1 + want.abs())).all())


@pytest.mark.parametrize("name", ["bench-like", "500 trees", "K=3",
                                  "K=5, 500 trees", "categorical"])
def test_predict_level_chunk_sizes_bit_identical(dev, name):
    """The shared tier at its own chunk plan and at chunks of two trees
    (category words in or out of shared memory), and the global tier,
    give the same bits."""
    _, rec, x2, depth = _records_case(dev, name, 3000)
    T, M, L, W = P.record_dims(rec)
    want = P.predict_level_ensemble(rec, x2, depth=depth, tier="global")
    for chunk in (None, 2 * (M * 16 + 16 + L * 4),
                  2 * (M * 16 + 16 + L * 4 + M * W * 4)):
        plan = P.level_plan(rec, 3000, x2.shape[1], tier="shared",
                            chunk_bytes=chunk)
        got = P.predict_level_ensemble(rec, x2, depth=depth, tier="shared",
                                       chunk_bytes=chunk)
        assert torch.equal(_bits(got), _bits(want)), plan


def test_predict_level_repeats_bit_identical(dev):
    """A 200,000-row launch of the shared tier, twenty times: the same
    bits every time."""
    _, rec, x2, depth = _records_case(dev, "bench-like", 200_000)
    assert P.level_plan(rec, 200_000, x2.shape[1]).tier == "shared"
    first = P.predict_level_ensemble(rec, x2, depth=depth)
    for _ in range(20):
        again = P.predict_level_ensemble(rec, x2, depth=depth)
        assert torch.equal(_bits(again), _bits(first))


def test_predict_level_refused_shared_memory_raises(dev):
    """A chunk past the card's 227 KB a CTA is refused by the launch, and
    the wrapper raises (no other tier runs instead)."""
    _, rec, x2, depth = _records_case(dev, "500 trees", 4096)
    n0 = kernels.LAUNCHES["predict_level_global"]
    with pytest.raises(RuntimeError, match="predict_level"):
        P.predict_level_ensemble(rec, x2, depth=depth, tier="shared",
                                 chunk_bytes=300_000)
    assert kernels.LAUNCHES["predict_level_global"] == n0


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


@pytest.mark.parametrize("entry", ["bins_hist", "bins_hist_paired"])
@pytest.mark.parametrize("first_round", [False, True])
def test_bins_hist_kernel_matches_plain(dev, first_round, entry):
    _, bins, _, wT, leaf, _, slots, B, _ = _float_inputs(dev, 1, False)
    bins[::7, 2] = B + 3                   # bins >= B match nothing
    w = wT.t().contiguous()
    if first_round:                        # every row in one slot
        leaf = torch.where(leaf >= 0, 0, -1).to(torch.int32)
        slots = torch.zeros(1, dtype=torch.int32, device=dev)
    n0 = kernels.LAUNCHES[entry]
    hk = getattr(H, entry)(bins, w, leaf, slots, B)
    hp = getattr(H, entry + "_plain")(bins, w, leaf, slots, B)
    assert kernels.LAUNCHES[entry] == n0 + 1
    _assert_close(hk, hp, H.bins_hist_plain(bins, w.abs(), leaf, slots, B))


@pytest.mark.parametrize("case", ["frontier", "first round", "all leaves",
                                  "B=255", "G split"])
def test_seg_hist_kernel_matches_plain(dev, case):
    """Kernel J on a real partition: the partitioned histogram equal to
    its plain version and to kernel G's over the unpartitioned rows, at
    63 and 255 bins, and at 40 groups of 255 bins, whose shared
    histogram the kernel splits over gridDim.y."""
    G, B = {"B=255": (7, 255), "G split": (40, 255)}.get(case, (7, 63))
    (binsT, wT, leaf, _, slots), B = _inputs(dev, N=20480, G=G, B=B)
    binsT[2, ::7] = 255 if B == 255 else B + 3    # bins >= B match nothing
    L = 48
    if case == "first round":
        leaf = torch.where(leaf >= 0, 0, -1).to(torch.int32)
        slots = torch.zeros(1, dtype=torch.int32, device=dev)
    elif case == "all leaves":
        slots = torch.arange(L, dtype=torch.int32, device=dev)
    else:
        slots = slots[slots < L][:20]
    perm, blk_leaf, _ = build_leaf_partition(leaf, num_slots=L,
                                             block=H.SEG_BLOCK)
    binsT_p = apply_partition(binsT, perm, axis=1)
    wT_p = apply_partition(wT, perm, axis=1)
    blk_slot = block_slots(blk_leaf, slots, L)
    W = slots.shape[0]
    n0 = kernels.LAUNCHES["seg_hist"]
    hk = H.seg_hist(binsT_p, wT_p, blk_slot, W, B)
    hp = H.seg_hist_plain(binsT_p, wT_p, blk_slot, W, B)
    assert kernels.LAUNCHES["seg_hist"] == n0 + 1
    assert hk.dtype == torch.int32 and torch.equal(hk, hp)
    assert torch.equal(hk, H.tiled_hist_plain(binsT, wT, leaf, slots, B))
    assert torch.equal(hk, H.seg_hist(binsT_p, wT_p, blk_slot, W, B))


def _seg_operands(dev, n_cap, G=7, B=63, seed=4, offset=0):
    """Partition-shaped operands of kernel J: (G, n_cap) bins with some
    bins >= B and (3, n_cap) int8 weights with 10% zero (gap) rows, as
    views ``offset`` elements into their storage (an odd offset breaks
    the 4-row alignment)."""
    rng = np.random.RandomState(seed)
    bins = torch.zeros(G * n_cap + offset, dtype=torch.uint8)
    bins[offset:] = torch.from_numpy(rng.randint(0, B + 4, G * n_cap).astype(
        np.uint8))
    w = torch.zeros(3 * n_cap + offset, dtype=torch.int32)
    wv = rng.randint(-127, 128, (3, n_cap)).astype(np.int32)
    wv[:, rng.rand(n_cap) < 0.1] = 0
    w[offset:] = torch.from_numpy(wv.ravel())
    bins, w = bins.to(dev), w.to(dev)
    return (bins[offset:].view(G, n_cap), w[offset:].view(3, n_cap))


def _seg_block_map(case, nblk, rng):
    """(blk_slot, num_out) of a block map no leaf partition makes."""
    if case == "many one-block slots":
        return rng.permutation(nblk).astype(np.int32), nblk
    if case == "slots interleaved block by block":
        return (np.arange(nblk) % 7).astype(np.int32), 7
    if case == "random slots, dead and out-of-range blocks":
        return rng.randint(-3, 60, nblk).astype(np.int32), 50
    # one slot over many runs, then its tail split by a dead block
    m = np.zeros(nblk, np.int32)
    m[nblk // 2] = -1
    return m, 1


def _seg_launch(binsT_p, wT_p, blk_slot, W, B, fill=0):
    """Kernel J's launch as ops/histogram.py _seg_hist_cuda makes it,
    with its output and its plan's scratch filled with ``fill`` first:
    (hist, and the plan the launch built: order over the live blocks,
    boff)."""
    G, n_cap = binsT_p.shape
    nblk = n_cap // H.SEG_BLOCK
    dev = binsT_p.device
    plan, args = H._seg_plan(n_cap, G, B, W, H.i32_aligned(binsT_p, wT_p),
                             H.SEG_BLOCK, dev.index or 0)
    hist = torch.full((W, G, B, 3), fill, dtype=torch.int32, device=dev)
    meta = torch.full((plan.meta_words,), fill, dtype=torch.int32,
                      device=dev)
    kernels.launch("seg_hist", binsT_p.data_ptr(), wT_p.data_ptr(),
                   blk_slot.data_ptr(), hist.data_ptr(), n_cap, G, B, W,
                   H.SEG_BLOCK, args, meta.data_ptr(), 0)
    boff = meta[2 * nblk:2 * nblk + W + 1]
    return hist, (meta[nblk:nblk + int(boff[-1])], boff)


@pytest.mark.parametrize("case", [
    "one slot over many runs", "many one-block slots",
    "slots interleaved block by block",
    "random slots, dead and out-of-range blocks",
    "1 row a thread (operands at an odd offset)"])
def test_seg_hist_kernel_block_maps(dev, case):
    """Kernel J on block maps its plan must cut however the slots lie
    (400 blocks shared by 264 CTAs: slots of one block up to one slot
    over every CTA), bit for bit against its plain version, and the plan
    its first launch built equal to ops/histogram.py seg_runs: the same
    slot offsets, each slot's blocks listed together (in any order
    within the slot)."""
    nblk, G, B = 400, 7, 63
    n_cap = nblk * H.SEG_BLOCK
    rng = np.random.RandomState(6)
    odd = case.startswith("1 row")
    binsT_p, wT_p = _seg_operands(dev, n_cap, G, B, offset=1 if odd else 0)
    bs, W = _seg_block_map("one slot over many runs" if odd else case,
                           nblk, rng)
    blk_slot = torch.from_numpy(bs).to(dev)
    plan = H.seg_hist_plan(n_cap, G, B, W, H._num_sms(dev.index or 0),
                           H.i32_aligned(binsT_p, wT_p))
    assert plan.rows_per_thread == (1 if odd else 4)
    n0 = kernels.LAUNCHES["seg_hist"]
    hk, got = _seg_launch(binsT_p, wT_p, blk_slot, W, B)
    assert kernels.LAUNCHES["seg_hist"] == n0 + 1
    hp = H.seg_hist_plain(binsT_p, wT_p, blk_slot, W, B)
    assert hk.dtype == torch.int32 and torch.equal(hk, hp)
    assert torch.equal(H.seg_hist(binsT_p, wT_p, blk_slot, W, B), hp)
    assert bool(hk[..., 2].abs().sum() > 0)
    want = H.seg_runs(blk_slot, W, plan.ctas,
                      H.SEG_BLOCK // plan.rows_per_thread)
    assert torch.equal(got[1], want[1])
    key = blk_slot.long() * nblk
    o_k, o_p = got[0].long(), want[0].long()
    assert bool((torch.diff(blk_slot[o_k]) >= 0).all())
    assert torch.equal(torch.sort(key[o_k] + o_k).values, key[o_p] + o_p)


@pytest.mark.parametrize("blocks", [[0, -1], [-1, 0], [0, 0], [0, 1],
                                    [1, 0], [-1, 3, 0, -1], [2, -1, 0, 1]])
@pytest.mark.parametrize("odd", [False, True])
def test_seg_hist_kernel_few_live_blocks(dev, blocks, odd):
    """Kernel J on two to four 512-row blocks, its output and its plan's
    scratch filled with a sentinel before the launch.  At 4 rows an item
    one or two live blocks are 128 or 256 items, fewer than the 264
    CTAs, so some CTAs have no share: the output is still every word
    the plain version's, bit for bit (the launch zeroes it), on the
    4-row path and on the 1-row one (operands at an odd offset), and the
    plan's offsets equal seg_runs'."""
    G, B = 7, 63
    n_cap = len(blocks) * H.SEG_BLOCK
    W = max(blocks) + 1
    binsT_p, wT_p = _seg_operands(dev, n_cap, G, B, offset=int(odd))
    blk_slot = torch.tensor(blocks, dtype=torch.int32, device=dev)
    plan = H._seg_plan(n_cap, G, B, W, H.i32_aligned(binsT_p, wT_p),
                       H.SEG_BLOCK, dev.index or 0)[0]
    assert plan.rows_per_thread == (1 if odd else 4)
    want = H.seg_runs(blk_slot, W, plan.ctas,
                      H.SEG_BLOCK // plan.rows_per_thread)
    hp = H.seg_hist_plain(binsT_p, wT_p, blk_slot, W, B)
    for fill in (0x7f7f7f7f, -1):
        hk, (_, boff) = _seg_launch(binsT_p, wT_p, blk_slot, W, B, fill)
        assert torch.equal(hk, hp), fill
        assert torch.equal(boff, want[1]), fill
    assert torch.equal(H.seg_hist(binsT_p, wT_p, blk_slot, W, B), hp)


def test_seg_hist_first_round_repeats_bit_identical(dev):
    """A tree's first round at the bench shape through the leaf
    partition: 1,000,000 rows of 28 groups in one slot, all 264 CTAs'
    runs added with atomics into the same 5,292 words; twenty launches
    leave the same bits, equal to the plain version."""
    N, G, B = 1_000_448, 28, 63
    rng = np.random.RandomState(8)
    binsT = torch.from_numpy(rng.randint(0, B, (G, N)).astype(
        np.uint8)).to(dev)
    leaf = torch.zeros(N, dtype=torch.int32, device=dev)
    leaf[1_000_000:] = -1
    cnt = (leaf >= 0).float()
    grad = torch.from_numpy(rng.randn(N).astype(np.float32)).to(dev)
    wq, _ = H.quantize_gradients(grad * cnt, cnt * 0.25, cnt)
    perm, blk_leaf, _ = build_leaf_partition(leaf, num_slots=255,
                                             block=H.SEG_BLOCK)
    binsT_p = apply_partition(binsT, perm, axis=1)
    wT_p = apply_partition(wq.t().contiguous(), perm, axis=1)
    slots = torch.zeros(1, dtype=torch.int32, device=dev)
    blk_slot = block_slots(blk_leaf, slots, 255)

    def run():
        return H.seg_hist(binsT_p, wT_p, blk_slot, 1, B)
    first = run()
    for _ in range(20):
        assert torch.equal(run(), first)
    assert torch.equal(first, H.seg_hist_plain(binsT_p, wT_p, blk_slot, 1,
                                               B))
    assert int(first[..., 2].sum()) == 1_000_000 * G


ROUTE_ONLY_TABLES = ["numerical and categorical", "numerical only",
                     "categorical only", "zero table",
                     "leaf ids past the table",
                     "records past shared memory"]


@pytest.mark.parametrize("table", ROUTE_ONLY_TABLES)
@pytest.mark.parametrize("path", ["4 rows a thread", "1 row: odd N",
                                  "1 row: leaf ids at an odd offset"])
def test_route_only_kernel_cases(dev, path, table):
    """Kernel H (kernel B's launch with its values off) against its plain
    version on its 4-row and 1-row paths: _inputs' table mixes NaN and
    zero missing types, categorical splits and non-splitting leaves; 5%
    of the rows have a negative leaf.  2,000 leaves' records (64 KB)
    outgrow a CTA's 48 KB, so each row reads the table."""
    N = 5001 if path == "1 row: odd N" else 5000
    L = 2000 if table == "records past shared memory" else 48
    (binsT, _, leaf, tab, _), _ = _inputs(dev, N=N, L=L)
    rng = np.random.RandomState(4)
    if table == "numerical only":
        tab[:, 7] = 0
    elif table == "categorical only":
        tab[:, 7] = 1
    elif table == "zero table":
        tab = torch.zeros_like(tab)
    elif table == "leaf ids past the table":
        leaf = torch.where(torch.from_numpy(rng.rand(N) < 0.2).to(dev),
                           leaf + L, leaf).to(torch.int32)
    if path == "1 row: leaf ids at an odd offset":
        buf = torch.empty(N + 1, dtype=torch.int32, device=dev)
        buf[1:] = leaf
        leaf = buf[1:]
        assert leaf.data_ptr() % 16 != 0
    n0 = kernels.LAUNCHES["route_only"]
    lk = H.route_only_tiled(binsT, leaf, tab)
    assert kernels.LAUNCHES["route_only"] == n0 + 1
    lp = H.route_only_plain(binsT, leaf, tab)
    assert torch.equal(lk, lp)
    assert bool((lk != leaf).any()) == (table != "zero table")


# ---------------------------------------------------------------------------
# The f64 shared-memory designs of kernels D, E (streamed one-hot) and F, K
# (bin matrix) at the edges of their launch geometry
# ---------------------------------------------------------------------------
EDGE_CASES = ["W=2S-1", "W=2S", "W=2S+1", "W=kS-1", "W=kS", "W=kS+1",
              "duplicate and negative slots", "first round",
              "B=255 group split", "first round, B=255 group split",
              "zero weights, bins >= B"]


def _edge_inputs(dev, case, cap_of):
    """Inputs of one edge case: (bins, binsT, wT, leaf, tab, slots, B, G).
    ``cap_of(N, G, B)`` is the kernel's slots per CTA on a wide frontier,
    so the W cases straddle two slot chunks (2S) or the k-th, the first
    past the one-hot's column-owner frontiers (kS)."""
    G, B = (40, 255) if case.endswith("group split") else (7, 36)
    N = 6000
    (binsT, _, leaf, tab, slots), _ = _inputs(dev, N, G, B, 48, seed=9)
    bins = binsT.t().contiguous()
    g = torch.Generator().manual_seed(3)
    cnt = (leaf >= 0).float()
    wT = torch.stack([torch.randn(N, generator=g).to(dev) * cnt,
                      torch.rand(N, generator=g).to(dev) * cnt,
                      cnt]).contiguous()
    span = torch.from_numpy(np.random.RandomState(4).permutation(96).astype(
        np.int32)).to(dev)
    if case.startswith("W="):
        S = cap_of(N, G, B)
        k = 2 if "2S" in case else H.COLS_MAX_SLOTS // S + 1
        W = k * S + (-1 if case.endswith("-1") else
                     1 if case.endswith("+1") else 0)
        slots = span[:W] if W <= 96 else torch.arange(
            W, dtype=torch.int32, device=dev) % 48
    elif case == "duplicate and negative slots":
        slots = torch.cat([span[:10], span[3:6], torch.full(
            (4,), -1, dtype=torch.int32, device=dev), span[:2]])
    elif case.startswith("first round"):
        leaf = torch.where(leaf >= 0, 0, -1).to(torch.int32)
        tab = torch.zeros_like(tab)
        slots = torch.zeros(1, dtype=torch.int32, device=dev)
    elif case == "zero weights, bins >= B":
        wT[:, ::5] = 0.0                       # rows with no weight at all
        wT[0, 1::7] = 0.0                      # one channel zero
        bins[::3, 2] = B + 4
        binsT = bins.t().contiguous()
    return bins, binsT, wT, leaf, tab, slots, B, G


def _onehot_cap(pack):
    def cap(N, G, B):
        return H.onehot_hist_plan(N, 1000, G, B,
                                  H.onehot_width(G, B, pack)).slots_per_cta
    return cap


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("pack", [1, 2, 4])
@pytest.mark.parametrize("entry", ["fused_onehot_hist", "hist_pre_packed",
                                   "hist_pre"])
def test_onehot_f64_kernel_edges(dev, entry, pack, case):
    bins, binsT, wT, leaf, tab, slots, B, G = _edge_inputs(
        dev, case, _onehot_cap(pack))
    ohb = (H.precompute_bin_onehot(bins, max_group_bin=B) if pack == 1
           else H.precompute_bin_onehot_packed(bins, max_group_bin=B,
                                               pack=pack))
    kw = dict(max_group_bin=B, pack=pack, num_groups=G)
    plan = H.onehot_hist_plan(leaf.shape[0], slots.shape[0], G, B,
                              ohb.shape[1])
    if case.endswith("group split"):
        assert plan.grid[2] > 1
    assert plan.cols == (slots.shape[0] <= H.COLS_MAX_SLOTS)
    n0 = kernels.LAUNCHES[entry]
    if entry == "fused_onehot_hist":
        hk, lk = H.fused_onehot_hist(ohb, binsT, wT, leaf, tab, slots, **kw)
        hp, lp = H.fused_onehot_hist_plain(ohb, binsT, wT, leaf, tab, slots,
                                           **kw)
        assert torch.equal(lk, lp)              # leaf_out under chunking
        lf = lp
    else:
        w = wT.t().contiguous()
        hk = getattr(H, entry)(ohb, w, leaf, slots, **kw)
        hp = getattr(H, entry + "_plain")(ohb, w, leaf, slots, **kw)
        lf = leaf
    assert kernels.LAUNCHES[entry] == n0 + 1
    assert hk.shape == (slots.shape[0], G, B, 3)
    _assert_close(hk, hp, H.onehot_hist_plain(ohb, wT.t().abs(), lf, slots,
                                              **kw))
    assert hk[..., 2].sum() > 0


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("entry", ["bins_hist", "bins_hist_paired"])
def test_bins_f64_kernel_edges(dev, entry, case):
    def cap(N, G, B):
        return H.bins_hist_plan(N, 1000, G, B).slots_per_cta
    bins, _, wT, leaf, _, slots, B, G = _edge_inputs(dev, case, cap)
    w = wT.t().contiguous()
    plan = H.bins_hist_plan(leaf.shape[0], slots.shape[0], G, B)
    if case.endswith("group split"):
        assert plan.grid[2] > 1
    n0 = kernels.LAUNCHES[entry]
    hk = getattr(H, entry)(bins, w, leaf, slots, B)
    hp = getattr(H, entry + "_plain")(bins, w, leaf, slots, B)
    assert kernels.LAUNCHES[entry] == n0 + 1
    assert hk.shape == (slots.shape[0], G, B, 3)
    _assert_close(hk, hp, H.bins_hist_plain(bins, w.abs(), leaf, slots, B))
    assert hk[..., 2].sum() > 0


def _one_slot_launch(dev, entry, N, leaf_of, W, seed=9):
    """Kernel ``entry`` (D, E pre_packed or F) on N rows whose leaf ids
    ``leaf_of(leaf, slots)`` makes from _float_inputs' leaf ids and W
    frontier slots; returns (launch, plain version, |weights| sums)."""
    ohb, bins, binsT, wT, leaf, tab, _, B, G = _float_inputs(
        dev, 4, False, N=N, seed=seed)
    slots = torch.arange(W, dtype=torch.int32, device=dev) * 3
    leaf = leaf_of(leaf, slots)
    tab = torch.zeros_like(tab)           # no split pending: ids unchanged
    kw = dict(max_group_bin=B, pack=4, num_groups=G)
    w = wT.t().contiguous()
    if entry == "fused_onehot_hist":
        def run():
            return H.fused_onehot_hist(ohb, binsT, wT, leaf, tab, slots,
                                       **kw)[0]

        def plain():
            return H.fused_onehot_hist_plain(ohb, binsT, wT, leaf, tab,
                                             slots, **kw)[0]
    elif entry == "hist_pre_packed":
        def run():
            return H.hist_pre_packed(ohb, w, leaf, slots, **kw)

        def plain():
            return H.hist_pre_packed_plain(ohb, w, leaf, slots, **kw)
    else:
        def run():
            return H.bins_hist(bins, w, leaf, slots, B)

        def plain():
            return H.bins_hist_plain(bins, w, leaf, slots, B)
    S = H.onehot_hist_plain(ohb, w.abs(), leaf, slots, **kw)
    return run, plain, S


@pytest.mark.parametrize("entry", ["fused_onehot_hist", "hist_pre_packed"])
def test_onehot_f64_first_round_repeats_bit_identical(dev, entry):
    """600,000 rows in one slot: every CTA scans and lists many batches,
    crossing the list's flush point, and twenty launches leave the same
    bits (each thread reads the list's count before the next batch may
    add to it), equal to the plain version."""
    run, plain, S = _one_slot_launch(
        dev, entry, 600_000, lambda leaf, slots: torch.where(
            leaf >= 0, 0, -1).to(torch.int32), 1)
    first = run()
    for _ in range(20):
        assert torch.equal(run(), first)
    _assert_close(first, plain(), S)


@pytest.mark.parametrize("W", [16, 64, 126])
@pytest.mark.parametrize("entry", ["fused_onehot_hist", "hist_pre_packed",
                                   "bins_hist"])
def test_f64_kernels_on_a_skewed_frontier(dev, entry, W):
    """A tree's middle round: one slot holds 60% of the rows, a few others
    the rest, half the slots none.  The kernel shares its CTAs out over
    the slot chunks by a sample of the leaf ids; the histogram equals the
    plain version and repeats bit for bit."""
    def skewed(leaf, slots):
        g = torch.Generator().manual_seed(W)
        n = leaf.shape[0]
        pick = torch.randint(1, W // 2, (n,), generator=g)
        big = torch.rand(n, generator=g) < 0.6
        ids = torch.where(big, 0, pick).to(leaf.device)
        return torch.where(leaf >= 0, slots[ids], -1).to(torch.int32)
    run, plain, S = _one_slot_launch(dev, entry, 200_000, skewed, W)
    first = run()
    for _ in range(3):
        assert torch.equal(run(), first)
    _assert_close(first, plain(), S)


# ---------------------------------------------------------------------------
# The int32 shared-memory histogram of kernels A (fused route + histogram)
# and G (histogram only), csrc/hist_i32.cuh, against their plain versions
# ---------------------------------------------------------------------------
I32_CASES = ["W=1", "first round", "W=42", "W=126", "W=0", "all negative",
             "duplicate and negative slots", "B=255 slot chunks", "skewed",
             "bins >= B, zero weights", "slots past the table",
             "odd rows, slots past the table"]


def _i32_inputs(dev, case, N=20000, G=7, L=160, seed=21):
    """(binsT, wT, leaf, tab, slots, B) of one case: _inputs over L
    leaves (post-route leaf ids below 2L), then the case's edits.  N is
    a multiple of 4 (the kernel's 4-rows-a-thread loop) except in the
    odd-rows case (one row a thread)."""
    B = 255 if case.startswith("B=255") else 63
    if case.startswith("odd rows"):
        N += 3
    (binsT, wT, leaf, tab, _), B = _inputs(dev, N, G, B, L, seed)
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(
        2 * L).astype(np.int32)).to(dev)
    W = {"W=1": 1, "W=42": 42, "W=0": 0}.get(case, 126)
    slots = perm[:W]
    if case == "W=1":                    # a leaf that holds rows
        slots = perm[perm < L - 4][:1]
    if case == "first round":
        leaf = torch.where(leaf >= 0, 0, -1).to(torch.int32)
        tab = torch.zeros_like(tab)
        slots = torch.zeros(1, dtype=torch.int32, device=dev)
    elif case == "all negative":
        slots = torch.full((5,), -1, dtype=torch.int32, device=dev)
    elif case == "duplicate and negative slots":
        slots = torch.cat([perm[:10], perm[3:6], torch.full(
            (4,), -1, dtype=torch.int32, device=dev), perm[:2]])
    elif case == "skewed":                   # one slot holds 90% of rows
        g = torch.Generator().manual_seed(seed)
        big = (torch.rand(N, generator=g) < 0.9).to(dev)
        other = slots[torch.randint(1, W, (N,), generator=g).to(dev)]
        leaf = torch.where(leaf >= 0, torch.where(big, slots[0], other),
                           -1).to(torch.int32)
        tab = torch.zeros_like(tab)
    elif case == "bins >= B, zero weights":
        binsT[2, ::3] = B + 4
        wT[:, ::5] = 0                          # rows with no weight
        wT[0, 1::7] = 0                         # one channel zero
    elif case.endswith("slots past the table"):  # leaf ids >= SLOT_TABLE
        far = H.SLOT_TABLE + 1000
        g = torch.Generator().manual_seed(seed)
        move = (torch.rand(N, generator=g) < 0.5).to(dev)
        leaf = torch.where(move & (leaf >= 0), leaf + far, leaf).to(
            torch.int32)
        slots = torch.cat([perm[:20], perm[:12] + far, perm[:1] + far])
    return binsT, wT.contiguous(), leaf, tab, slots, B


@pytest.mark.parametrize("case", I32_CASES)
@pytest.mark.parametrize("entry", ["fused_route_hist", "tiled_hist"])
def test_i32_kernel_matches_plain(dev, entry, case):
    binsT, wT, leaf, tab, slots, B = _i32_inputs(dev, case)
    G, N = binsT.shape
    plan = H.frontier_hist_plan(N, slots.shape[0], G, B)
    if case.startswith("B=255"):
        assert plan.grid[2] > 1                 # the slot-chunk path
    assert plan.rows_per_thread == (1 if case.startswith("odd") else 4)
    n0 = kernels.LAUNCHES[entry]
    if entry == "fused_route_hist":
        hk, lk = H.fused_route_hist(binsT, wT, leaf, tab, slots, B)
        hp, lp = H.fused_route_hist_plain(binsT, wT, leaf, tab, slots, B)
        assert torch.equal(lk, lp)
    else:
        hk = H.tiled_hist(binsT, wT, leaf, slots, B)
        hp = H.tiled_hist_plain(binsT, wT, leaf, slots, B)
    assert kernels.LAUNCHES[entry] == n0 + 1
    assert hk.dtype == torch.int32 and hk.shape == (slots.shape[0], G, B, 3)
    assert torch.equal(hk, hp)
    empty = case in ("W=0", "all negative")
    assert bool(hk[..., 2].sum() > 0) != empty


#: kernel I's cases: A's and G's, then every one of 255 leaves as a slot,
#: and row-major pointers not aligned for 4 rows a thread
I_CASES = I32_CASES + ["W=255 every leaf", "unaligned pointers"]


@pytest.mark.parametrize("case", I_CASES)
@pytest.mark.parametrize("entry", ["bins_hist_q", "bins_hist_q_packed"])
def test_i_kernel_matches_plain(dev, entry, case):
    """Kernel I: the same histogram on the row-major bins (N, G) and
    weights (N, 3) through either entry point, bit for bit."""
    binsT, wT, leaf, _, slots, B = _i32_inputs(
        dev, "W=126" if case in ("W=255 every leaf", "unaligned pointers")
        else case)
    G, N = binsT.shape
    bins, wq = binsT.t().contiguous(), wT.t().contiguous()
    if case == "W=255 every leaf":
        g = torch.Generator().manual_seed(4)
        leaf = torch.where(leaf >= 0, torch.randint(
            0, 255, (N,), generator=g).to(dev), -1).to(torch.int32)
        slots = torch.arange(255, dtype=torch.int32, device=dev)
    if case == "unaligned pointers":           # views one element in
        b1 = torch.empty(N * G + 1, dtype=torch.uint8, device=dev)
        b1[1:] = bins.reshape(-1)
        bins = b1[1:].view(N, G)
        w1 = torch.empty(N * 3 + 1, dtype=torch.int32, device=dev)
        w1[1:] = wq.reshape(-1)
        wq = w1[1:].view(N, 3)
    plan = H.frontier_hist_plan(N, slots.shape[0], G, B,
                                aligned=H.i32_aligned(bins, wq, leaf))
    if case.startswith("B=255"):
        assert plan.grid[2] > 1                 # the slot-chunk path
    four = not (case.startswith("odd") or case == "unaligned pointers")
    assert plan.rows_per_thread == (4 if four else 1)
    n0 = kernels.LAUNCHES[entry]
    hk = getattr(H, entry)(bins, wq, leaf, slots, B)
    hp = H.bins_hist_plain(bins, wq, leaf, slots, B)
    assert kernels.LAUNCHES[entry] == n0 + 1
    assert hk.dtype == torch.int32 and hk.shape == (slots.shape[0], G, B, 3)
    assert torch.equal(hk, hp)
    empty = case in ("W=0", "all negative")
    assert bool(hk[..., 2].sum() > 0) != empty


@pytest.mark.parametrize("entry", ["fused_route_hist", "tiled_hist",
                                   "bins_hist_q", "bins_hist_q_packed"])
def test_i32_first_round_repeats_bit_identical(dev, entry):
    """1,000,000 rows of 28 groups in one slot, the bench's first round:
    every CTA adds into the same bins and flushes into the same 5,292
    words; twenty launches leave the same bits, equal to the plain
    version."""
    N, G, B = 1_000_000, 28, 63
    rng = np.random.RandomState(8)
    binsT = torch.from_numpy(rng.randint(0, B, (G, N)).astype(
        np.uint8)).to(dev)
    leaf = torch.zeros(N, dtype=torch.int32, device=dev)
    grad = torch.from_numpy(rng.randn(N).astype(np.float32)).to(dev)
    hess = torch.full((N,), 0.25, device=dev)
    wq, _ = H.quantize_gradients(grad, hess, torch.ones_like(grad))
    wT = wq.t().contiguous()
    slots = torch.zeros(1, dtype=torch.int32, device=dev)
    tab = torch.zeros((4, 16), dtype=torch.float32, device=dev)
    bins, wq = binsT.t().contiguous(), wq.contiguous()
    if entry == "fused_route_hist":
        def run():
            return H.fused_route_hist(binsT, wT, leaf, tab, slots, B)[0]
    elif entry == "tiled_hist":
        def run():
            return H.tiled_hist(binsT, wT, leaf, slots, B)
    else:
        def run():
            return getattr(H, entry)(bins, wq, leaf, slots, B)
    first = run()
    for _ in range(20):
        assert torch.equal(run(), first)
    assert torch.equal(first, H.tiled_hist_plain(binsT, wT, leaf, slots, B))
    assert int(first[..., 2].sum()) == N * G


def _objective_data(kind, n=20_000, F=10, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.02] = np.nan
    Z = np.nan_to_num(X)
    z = Z[:, 0] - 0.5 * Z[:, 1] + 0.5 * np.sin(2 * Z[:, 2]) \
        + 0.3 * rng.randn(n)
    y = 3.0 * z if kind == "real" else np.digitize(z, [-1.0, -0.3, 0.3,
                                                        1.0]).astype(float)
    return X, y


@pytest.mark.parametrize("params,kind,rounds", [
    ({"objective": "regression"}, "real", 3),
    ({"objective": "multiclass", "num_class": 5}, "class", 2)],
    ids=["regression", "multiclass"])
def test_objective_trains_on_the_card_as_on_the_cpu(dev, monkeypatch,
                                                    params, kind, rounds):
    """The main path (fused_tiled: kernels A and B) on another objective:
    the card's trees have the CPU run's split structure, and leaf values
    within 1e-6 of the tree's largest; from a multiclass model's second
    iteration on, within 1e-5: the softmax's ``exp`` differs in the last
    bit between the card and the CPU, and a gradient on an int8 rounding
    boundary moves one step.  Each tree's root sums are f32
    sums in another order on each device (torch's on the card, XLA's CPU
    order on the CPU), and a near-tie between two splits can follow
    that order (the 5-class model's first tree on this data, whose
    gradients take two values): so the CPU run takes the card run's
    root sums, and everything else is computed on each device."""
    X, y = _objective_data(kind)
    base = dict(params, num_leaves=31, max_bin=63, min_data_in_leaf=5,
                quantized_grad=True, hist_compute_dtype="bfloat16",
                verbose=-1)
    real = grower.compute_root_totals
    card_roots = []

    def card_root(*args):
        out = real(*args)
        card_roots.append(out.cpu())
        return out

    def cpu_root(*args):
        return card_roots.pop(0)

    n0 = kernels.LAUNCHES["fused_route_hist"], kernels.LAUNCHES["route_apply"]
    models = {}
    for device, root in (("cuda", card_root), ("cpu", cpu_root)):
        monkeypatch.setattr(grower, "compute_root_totals", root)
        bst = tlgb.train(dict(base, device=device), tlgb.Dataset(X, label=y),
                         rounds, verbose_eval=False,
                         keep_training_booster=True)
        assert bst.gbdt.grower.plan.name == "fused_tiled"
        models[device] = bst.models
    assert not card_roots
    assert kernels.LAUNCHES["fused_route_hist"] > n0[0]
    assert kernels.LAUNCHES["route_apply"] > n0[1]
    k = params.get("num_class", 1)
    assert len(models["cuda"]) == len(models["cpu"]) == rounds * k
    for i, (ct, pt) in enumerate(zip(models["cuda"], models["cpu"])):
        for f in ("split_feature", "threshold", "left_child",
                  "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(ct, f), getattr(pt, f),
                                          f"tree {i} {f}")
        tol = 1e-6 if k == 1 or i < k else 1e-5
        scale = float(np.abs(pt.leaf_value).max())
        np.testing.assert_allclose(ct.leaf_value, pt.leaf_value, rtol=tol,
                                   atol=tol * scale, err_msg=f"tree {i}")


def _categorical_data(n=50_000, seed=12):
    """Columns 1 (3 categories), 3 (about 60, Zipf-like), 4 (12, with
    NaNs) and 5 (300, more than max_bin 63: 256 bins, so the route
    table's left sets reach bits past 64) are categorical; each category
    moves the target."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[:, 1] = rng.randint(0, 3, n)
    X[:, 3] = rng.zipf(1.3, n) % 60
    X[:, 4] = rng.randint(0, 12, n)
    X[rng.rand(n) < 0.05, 4] = np.nan
    X[:, 5] = rng.randint(0, 300, n)
    off = rng.randn(80)
    off5 = rng.randn(300)
    y = (X[:, 0] + off[X[:, 3].astype(int)]
         + 0.7 * off[X[:, 1].astype(int) + 60]
         + 0.5 * off[np.nan_to_num(X[:, 4]).astype(int) + 64]
         + 0.8 * off5[X[:, 5].astype(int)]
         + 0.3 * rng.randn(n))
    return X, y


def test_categorical_training_on_the_card_as_on_the_cpu(dev, monkeypatch):
    """Categorical columns on the main path (fused_tiled: kernel A routes
    the bitsets the split finder grew, kernel B routes them at exit):
    the card's trees have the CPU run's structure and category sets,
    leaves within 1e-6 of the tree's largest.  The CPU run takes the
    card run's root sums (each device sums them in its own order)."""
    X, y = _categorical_data()
    params = {"objective": "regression", "num_leaves": 31, "max_bin": 63,
              "min_data_in_leaf": 5, "quantized_grad": True,
              "hist_compute_dtype": "bfloat16", "verbose": -1}
    real = grower.compute_root_totals
    card_roots = []

    def card_root(*args):
        out = real(*args)
        card_roots.append(out.cpu())
        return out

    def cpu_root(*args):
        return card_roots.pop(0)

    n0 = kernels.LAUNCHES["fused_route_hist"], kernels.LAUNCHES["route_apply"]
    models = {}
    for device, root in (("cuda", card_root), ("cpu", cpu_root)):
        monkeypatch.setattr(grower, "compute_root_totals", root)
        ds = tlgb.Dataset(X, label=y)
        bst = tlgb.train(dict(params, device=device), ds, 3,
                         categorical_feature=[1, 3, 4, 5], verbose_eval=False,
                         keep_training_booster=True)
        assert bst.gbdt.grower.plan.name == "fused_tiled"
        assert bst.gbdt.grower.max_group_bin == 256
        models[device] = bst.models
    assert not card_roots
    assert kernels.LAUNCHES["fused_route_hist"] > n0[0]
    assert kernels.LAUNCHES["route_apply"] > n0[1]
    assert any(t.num_cat for t in models["cuda"])
    # some left set of column 5 holds a category binned at 64 or above
    high = set()
    mapper = ds.construct().mappers[5]
    for t in models["cuda"]:
        for i in range(t.num_leaves - 1):
            if t.decision_type[i] & 1 and t.split_feature[i] == 5:
                c = int(t.threshold[i])
                words = t.cat_threshold[t.cat_boundaries[c]:
                                        t.cat_boundaries[c + 1]]
                cats = [32 * j + b for j, wd in enumerate(words)
                        for b in range(32) if (wd >> b) & 1]
                high |= {k for k, b in zip(cats, mapper.value_to_bin(
                    np.array(cats, np.float64))) if b >= 64}
    assert high
    for i, (ct, pt) in enumerate(zip(models["cuda"], models["cpu"])):
        for f in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(ct, f), getattr(pt, f),
                                          f"tree {i} {f}")
        assert ct.cat_boundaries == pt.cat_boundaries, f"tree {i}"
        assert ct.cat_threshold == pt.cat_threshold, f"tree {i}"
        scale = float(np.abs(pt.leaf_value).max())
        np.testing.assert_allclose(ct.leaf_value, pt.leaf_value, rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=f"tree {i}")


# ---------------------------------------------------------------------------
# the random streams and lambdarank on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 7, 1 << 20, 1_001_472])
def test_uniform_on_the_card_as_on_the_cpu(dev, n):
    """utils/prng.py is integer arithmetic: the card's draws are the
    host's bit for bit."""
    from lightgbm_tpu_torch.utils import prng
    key = prng.split(prng.PRNGKey(3))[0]
    got = prng.uniform(key, (n,), dev)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), prng.uniform(key, (n,)))


def test_stochastic_quantize_on_the_card_as_on_the_cpu(dev):
    from lightgbm_tpu_torch.utils import prng
    rng = np.random.RandomState(2)
    n = 100_000
    g = torch.from_numpy((rng.standard_cauchy(n) * 1e-3).astype(np.float32))
    h = torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32))
    c = torch.from_numpy((rng.rand(n) < 0.7).astype(np.float32))
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(9), 0x51AB), 0)
    w_cpu, s_cpu = H.quantize_gradients(g, h, c, key=key)
    w_dev, s_dev = H.quantize_gradients(g.to(dev), h.to(dev), c.to(dev),
                                        key=key)
    assert torch.equal(s_dev.cpu(), s_cpu)
    assert torch.equal(w_dev.cpu(), w_cpu)


def _sampling_data(n=20000, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 10)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.5 * rng.randn(n) > 0).astype(float)
    return X, y


@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.7, "bagging_freq": 2, "feature_fraction": 0.8},
    {"boosting_type": "goss", "learning_rate": 0.5},
    {"boosting_type": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
    {"boosting_type": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
     "feature_fraction": 0.8}], ids=["bagging", "goss", "dart", "rf"])
def test_sampling_trains_on_the_card_as_on_the_cpu(dev, monkeypatch, extra):
    """Bagging, GOSS, DART and RF on the main path: the card's bags and
    samples are the CPU run's (the CPU run takes the card run's root
    sums and gradients, as each device rounds those its own way), so
    the trees have the same structure and the leaves agree within 1e-6
    of the tree's largest."""
    from lightgbm_tpu_torch.boosting import gbdt as B
    X, y = _sampling_data()
    params = dict({"objective": "binary", "num_leaves": 31, "max_bin": 63,
                   "min_data_in_leaf": 5, "quantized_grad": True,
                   "hist_compute_dtype": "bfloat16", "verbose": -1},
                  **extra)
    real_root, real_grad = grower.compute_root_totals, B.GBDT._gradients
    taken = {"root": [], "grad": []}

    def card_root(*a):
        out = real_root(*a)
        taken["root"].append(out.cpu())
        return out

    def card_grad(self, scores=None):
        g, h = real_grad(self, scores)
        taken["grad"].append((g.cpu(), h.cpu()))
        return g, h
    models, states = {}, {}
    for device in ("cuda", "cpu"):
        if device == "cuda":
            monkeypatch.setattr(grower, "compute_root_totals", card_root)
            monkeypatch.setattr(B.GBDT, "_gradients", card_grad)
        else:
            monkeypatch.setattr(grower, "compute_root_totals",
                                lambda *a: taken["root"].pop(0))
            monkeypatch.setattr(B.GBDT, "_gradients",
                                lambda self, s=None: taken["grad"].pop(0))
        bst = tlgb.train(dict(params, device=device),
                         tlgb.Dataset(X, label=y), 5, verbose_eval=False,
                         keep_training_booster=True)
        assert bst.gbdt.grower.plan.name == "fused_tiled"
        models[device] = bst.models
        states[device] = [getattr(bst.gbdt, k, None) for k in
                          ("_bag_state", "_bag_mask")]
    assert not taken["root"] and not taken["grad"]
    for a, b in zip(*states.values()):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.cpu(), b)
    for tc, tt in zip(models["cuda"], models["cpu"]):
        for f in ("split_feature", "threshold", "left_child",
                  "right_child", "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(tt, f))
        np.testing.assert_allclose(tc.leaf_value, tt.leaf_value, rtol=0,
                                   atol=1e-6 * np.abs(tt.leaf_value).max())


def test_lambdarank_gradients_on_the_card_as_on_the_cpu(dev):
    """The lambdas of ragged queries (one chunk and several) on the
    card within 1e-6 of the largest of the same torch ops on the CPU
    (each device's ``exp``/``log`` round their own way)."""
    from lightgbm_tpu_torch import objectives as TO
    from lightgbm_tpu_torch.dataset import Metadata
    rng = np.random.RandomState(5)
    for sizes in (rng.randint(1, 40, 300), rng.randint(60, 181, 2500)):
        n = int(sizes.sum())
        meta = Metadata(n)
        meta.set_label(rng.randint(0, 5, n))
        meta.set_group(sizes)
        score = torch.from_numpy((rng.randn(n) * 2).astype(np.float32))
        out = {}
        for d in (dev, torch.device("cpu")):
            obj = TO.create_objective(tlgb.Config.from_params(
                {"objective": "lambdarank", "device": d.type}))
            obj.init(meta, n, d)
            out[d.type] = [t.cpu() for t in obj.get_gradients(score.to(d))]
        for a, b in zip(out["cuda"], out["cpu"]):
            assert (a - b).abs().max() <= 1e-6 * b.abs().max()


# ---------------------------------------------------------------------------
# sub-byte bin storage: kernels A, G, J, B, H and D's routing on the
# packed (cols, N) matrix, each launch against its plain version on the
# same storage and against the plain version on the logical matrix
# ---------------------------------------------------------------------------
#: layout -> (G, P, C, B) of tests/test_torch_packed_bins.py: 4bit, 2bit,
#: and auto with C % 4 != 0 and P - C odd (B = 63: 2 groups a CTA at
#: W=126, so group chunks start inside a crumb byte)
PACKED_LAYOUTS = {"4bit": (7, 7, 0, 15), "2bit": (6, 6, 6, 4),
                  "auto": (8, 6, 3, 63)}


def _packed_inputs(dev, name, case, N=20000, L=160, seed=31):
    """(storageT, logicalT, wT, leaf, tab, slots, B, spec) of one layout
    and case: bins some of which are >= B, 5% padded rows, a route table
    with categorical and every missing type over L (or, case "table",
    2000) leaves, 126 slots (case "first round": every row in slot 0 and
    nothing routed; "slots past the table": half the rows' leaf ids past
    SLOT_TABLE; "odd rows": N + 3 rows, one a thread)."""
    from lightgbm_tpu_torch.packing import BinLayout
    G, P, C, B = PACKED_LAYOUTS[name]
    lay = BinLayout(name, G, P, C)
    if case == "odd rows":
        N += 3
    if case == "table":
        L = 2000
    rng = np.random.RandomState(seed + G)
    top = np.array([4] * C + [16] * (P - C) + [B + 2] * (G - P))
    logical = (rng.rand(N, G) * top).astype(np.uint8)
    leaf = rng.randint(0, L - 4, N).astype(np.int32)
    leaf[rng.rand(N) < 0.05] = -1
    cnt = (leaf >= 0).astype(np.float32)
    wq, _ = H.quantize_gradients(
        torch.from_numpy(rng.randn(N).astype(np.float32) * cnt),
        torch.from_numpy(rng.rand(N).astype(np.float32) * cnt),
        torch.from_numpy(cnt))
    sm = torch.from_numpy(rng.rand(L) < 0.6)
    tab = build_route_table(
        sm, torch.from_numpy(rng.randint(0, G, L)), torch.zeros(L),
        torch.full((L,), B), torch.zeros(L), torch.full((L,), B - 1),
        torch.from_numpy(rng.rand(L) < 0.25),
        torch.from_numpy(rng.randint(0, 3, L)),
        torch.from_numpy(rng.rand(L) < 0.5),
        torch.from_numpy(rng.randint(0, 3, L)),
        torch.from_numpy(rng.randint(0, 4, L)), torch.full((L,), B),
        torch.from_numpy(rng.rand(L, B) < 0.5),
        torch.arange(L, 2 * L))
    slots = torch.from_numpy(rng.permutation(2 * L)[:126].astype(np.int32))
    leaf = torch.from_numpy(leaf)
    if case == "first round":
        leaf = torch.where(leaf >= 0, 0, -1).to(torch.int32)
        tab = torch.zeros_like(tab)
        slots = torch.zeros(1, dtype=torch.int32)
    elif case == "slots past the table":
        far = H.SLOT_TABLE + 1000
        move = torch.from_numpy(rng.rand(N) < 0.5)
        leaf = torch.where(move & (leaf >= 0), leaf + far, leaf).to(
            torch.int32)
        slots = torch.cat([slots[:20], slots[:12] + far, slots[:1] + far])
    storageT = torch.from_numpy(lay.pack_rows(logical).T.copy())
    logicalT = torch.from_numpy(logical.T.copy())
    return ([t.to(dev) for t in (storageT, logicalT, wq.t().contiguous(),
                                 leaf, tab, slots)]
            + [B, lay.device_spec])


@pytest.mark.parametrize("case", ["W=126", "first round", "odd rows",
                                  "slots past the table"])
@pytest.mark.parametrize("name", sorted(PACKED_LAYOUTS))
@pytest.mark.parametrize("entry", ["fused_route_hist", "tiled_hist"])
def test_packed_i32_kernel_matches_plain(dev, entry, name, case):
    sT, lT, wT, leaf, tab, slots, B, spec = _packed_inputs(dev, name, case)
    n0 = kernels.LAUNCHES[entry]
    if entry == "fused_route_hist":
        hk, lk = H.fused_route_hist(sT, wT, leaf, tab, slots, B, spec)
        hp, lp = H.fused_route_hist_plain(sT, wT, leaf, tab, slots, B, spec)
        hl, ll = H.fused_route_hist_plain(lT, wT, leaf, tab, slots, B)
        assert torch.equal(lk, lp) and torch.equal(ll, lp)
    else:
        hk = H.tiled_hist(sT, wT, leaf, slots, B, spec)
        hp = H.tiled_hist_plain(sT, wT, leaf, slots, B, spec)
        hl = H.tiled_hist_plain(lT, wT, leaf, slots, B)
    assert kernels.LAUNCHES[entry] == n0 + 1
    assert torch.equal(hk, hp) and torch.equal(hp, hl)
    assert hk[..., 2].sum() > 0


@pytest.mark.parametrize("case", ["records", "table", "odd rows"])
@pytest.mark.parametrize("name", sorted(PACKED_LAYOUTS))
@pytest.mark.parametrize("entry", ["route_apply", "route_only"])
def test_packed_route_kernel_matches_plain(dev, entry, name, case):
    """B and H on the storage: route records in shared memory (up to
    1,228 leaves for B), each row selecting from the table past them,
    and one row a thread."""
    sT, lT, wT, leaf, tab, slots, B, spec = _packed_inputs(dev, name, case)
    n0 = kernels.LAUNCHES[entry]
    if entry == "route_apply":
        values = torch.randn(tab.shape[0], generator=torch.Generator(
        ).manual_seed(3)).to(dev)
        lk, vk = H.route_apply_tiled(sT, leaf, tab, values, spec)
        lp, vp = H.route_apply_plain(sT, leaf, tab, values, spec)
        ll, vl = H.route_apply_plain(lT, leaf, tab, values)
        assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))
        assert torch.equal(vl, vp)
    else:
        lk = H.route_only_tiled(sT, leaf, tab, spec)
        lp = H.route_only_plain(sT, leaf, tab, spec)
        ll = H.route_only_plain(lT, leaf, tab)
    assert kernels.LAUNCHES[entry] == n0 + 1
    assert torch.equal(lk, lp) and torch.equal(ll, lp)
    assert bool((lk != leaf).any())


@pytest.mark.parametrize("name", sorted(PACKED_LAYOUTS))
def test_packed_seg_hist_matches_plain(dev, name):
    sT, lT, wT, leaf, _, slots, B, spec = _packed_inputs(dev, name, "W=126")
    N = sT.shape[1]
    pad = -N % H.SEG_BLOCK
    leaf_x = torch.nn.functional.pad(leaf, (0, pad), value=-1)
    perm, blk_leaf, _ = build_leaf_partition(leaf_x, num_slots=320,
                                             block=H.SEG_BLOCK)
    sT_p, lT_p, wT_p = (apply_partition(
        torch.nn.functional.pad(t, (0, pad)), perm, axis=1)
        for t in (sT, lT, wT))
    blk = block_slots(blk_leaf, slots, 320)
    n0 = kernels.LAUNCHES["seg_hist"]
    hk = H.seg_hist(sT_p, wT_p, blk, slots.shape[0], B, packed_groups=spec)
    assert kernels.LAUNCHES["seg_hist"] == n0 + 1
    hp = H.seg_hist_plain(sT_p, wT_p, blk, slots.shape[0], B,
                          packed_groups=spec)
    assert torch.equal(hk, hp)
    assert torch.equal(hp, H.seg_hist_plain(lT_p, wT_p, blk, slots.shape[0],
                                            B))
    assert hk[..., 2].sum() > 0


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", sorted(PACKED_LAYOUTS))
def test_packed_fused_onehot_hist_matches_plain(dev, name, quant):
    """Kernel D: its routing over the storage (the f32 weights' routing
    launch, the int8 weights' inline routing) and the histogram of the
    one-hot built from the storage."""
    sT, lT, wq, leaf, tab, slots, B, spec = _packed_inputs(dev, name,
                                                          "W=126")
    G = lT.shape[0]
    ohb = H.precompute_bin_onehot(sT.t(), max_group_bin=B,
                                  packed_groups=spec)
    assert torch.equal(ohb, H.precompute_bin_onehot(lT.t().contiguous(),
                                                    max_group_bin=B))
    cnt = (leaf >= 0).float()
    g = torch.Generator().manual_seed(2)
    N = leaf.shape[0]
    wT = wq if quant else torch.stack([
        torch.randn(N, generator=g).to(dev) * cnt,
        torch.rand(N, generator=g).to(dev) * cnt, cnt]).contiguous()
    kw = dict(max_group_bin=B, pack=1, num_groups=G)
    n0 = kernels.LAUNCHES["fused_onehot_hist"]
    hk, lk = H.fused_onehot_hist(ohb, sT, wT, leaf, tab, slots,
                                 packed_groups=spec, **kw)
    assert kernels.LAUNCHES["fused_onehot_hist"] == n0 + 1
    hp, lp = H.fused_onehot_hist_plain(ohb, sT, wT, leaf, tab, slots,
                                       packed_groups=spec, **kw)
    _, ll = H.fused_onehot_hist_plain(ohb, lT, wT, leaf, tab, slots, **kw)
    assert torch.equal(lk, lp) and torch.equal(ll, lp)
    S = None if quant else H.onehot_hist_plain(ohb, wT.t().abs(), lp, slots,
                                               **kw)
    _assert_close(hk, hp, S)


def test_packed_first_round_repeats_bit_identical(dev):
    """Kernel A on 1,000,000 rows of 28 nibble groups (4bit, 15 bins) in
    one slot, the first round of phase 10 (a): twenty launches leave the
    same bits, equal to the plain version (the barrier hazard of ROADMAP
    queue 2)."""
    from lightgbm_tpu_torch.packing import BinLayout
    N, G, B = 1_000_000, 28, 15
    lay = BinLayout("4bit", G, G)
    rng = np.random.RandomState(8)
    sT = torch.from_numpy(lay.pack_rows(rng.randint(0, B, (N, G)).astype(
        np.uint8)).T.copy()).to(dev)
    assert sT.shape == (14, N)
    leaf = torch.zeros(N, dtype=torch.int32, device=dev)
    grad = torch.from_numpy(rng.randn(N).astype(np.float32)).to(dev)
    hess = torch.full((N,), 0.25, device=dev)
    wq, _ = H.quantize_gradients(grad, hess, torch.ones_like(grad))
    wT = wq.t().contiguous()
    slots = torch.zeros(1, dtype=torch.int32, device=dev)
    tab = torch.zeros((4, 16), dtype=torch.float32, device=dev)
    spec = lay.device_spec

    def run():
        return H.fused_route_hist(sT, wT, leaf, tab, slots, B, spec)[0]
    first = run()
    for _ in range(20):
        assert torch.equal(run(), first)
    assert torch.equal(first, H.tiled_hist_plain(sT, wT, leaf, slots, B,
                                                 spec))
    assert int(first[..., 2].sum()) == N * G

