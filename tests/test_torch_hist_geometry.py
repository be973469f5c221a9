"""Launch geometry of the f64 shared-memory histogram kernels (D, E with
the streamed one-hot, F and K with the bin matrix).

ops/histogram.py onehot_hist_plan and bins_hist_plan alone decide the
slots per CTA, the group split, the CTAs of a group chunk and the
shared-memory carve-up; the CUDA kernels only read the plan, and share
the CTAs out over the slot chunks by the rule of chunk_ctas.  These CPU
tests hold the plans to what the kernels need: no more shared memory
than an H100 CTA may use, every (slot, group) pair and every row covered
exactly once, and the same plan for the same shapes."""
import functools

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as H

GROUPS = (1, 2, 7, 13, 28, 32, 33, 40)
BINS = (2, 15, 36, 63, 64, 255)
ROWS = (1, 600, 1_000_000)


def _plan(kind, n, W, G, B):
    if kind == "bins":
        return H.bins_hist_plan(n, W, G, B)
    pack = int(kind[-1])
    if (G * B) % pack:
        return None
    return H.onehot_hist_plan(n, W, G, B, H.onehot_width(G, B, pack))


def _shapes(kind):
    for G in GROUPS:
        for B in BINS:
            for W in range(1, 256):
                p = _plan(kind, 1_000_000, W, G, B)
                if p is not None:
                    yield W, G, B, p


KINDS = ["onehot-pack1", "onehot-pack2", "onehot-pack4", "bins"]


def _payload(kind, G, B):
    return G if kind == "bins" else H.onehot_width(G, B, int(kind[-1]))


@pytest.mark.parametrize("kind", KINDS)
def test_plan_fits_shared_memory(kind):
    """The carve-up of csrc/hist_f64.cuh: the private histograms, the
    three-stage ring, the list (uint32 rows, uint16 slot masks) and its
    counter, in that order, within one CTA's 232,448 bytes."""
    for W, G, B, p in _shapes(kind):
        S, C, gc = p.slots_per_cta, p.copies, p.groups_per_cta
        where = (W, G, B, p)
        assert p.smem_bytes <= H.SMEM_PER_CTA, where
        assert S * C * gc * B * 3 * 8 <= p.off_stage, where
        assert p.row_stride % 16 == 0, where
        assert p.row_stride >= -(-_payload(kind, G, B) // 16) * 16 + 12
        assert p.off_stage % 16 == 0 and p.off_list % 16 == 0, where
        assert p.off_list >= p.off_stage + 3 * p.stage_rows * p.row_stride
        assert p.off_count >= p.off_list + 6 * p.list_rows, where
        assert p.smem_bytes >= p.off_count + 4, where
        if p.cols:                      # column owners, one slot a CTA
            assert kind != "bins" and W <= H.COLS_MAX_SLOTS, where
            assert S == C == 1 and p.threads == H.COLS_THREADS, where
            assert p.shared == (W > 1), where   # CTAs by sampled work
        else:                           # one private histogram a warp
            assert kind == "bins" or W > H.COLS_MAX_SLOTS, where
            assert p.threads == 32 * S * C <= 256, where
            assert not p.shared, where
        assert 1 <= S <= min(W, H.MAX_SLOTS_PER_CTA), where
        assert 1 <= p.stage_rows <= H.MAX_STAGE_ROWS, where
        assert p.list_rows >= H.SCAN_BATCH * p.threads, where
        # the list's space first holds the sample and the chunk counts
        assert p.list_rows >= H.MAX_SAMPLED_CHUNKS + H.CHUNK_SAMPLE + 3


@pytest.mark.parametrize("kind", KINDS)
def test_plan_covers_each_slot_group_and_row_once(kind):
    for W, G, B, p in _shapes(kind):
        gx, gy, gz = p.grid
        assert gy == 1 and gx >= p.chunks, (W, G, B, p)  # a CTA a chunk
        S, gc = p.slots_per_cta, p.groups_per_cta
        seen = [[0] * G for _ in range(W)]
        for y in range(p.chunks):
            slots = range(y * S, min(W, y * S + S))
            assert len(slots) > 0, (W, G, B, p)        # no idle chunk
            for z in range(gz):
                groups = range(z * gc, min(G, z * gc + gc))
                assert len(groups) > 0, (W, G, B, p)
                for s in slots:
                    for g in groups:
                        seen[s][g] += 1
        assert all(c == 1 for row in seen for c in row), (W, G, B, p)
    rng = np.random.RandomState(0)
    for n in ROWS:
        for W in (1, 8, 126):
            p = _plan(kind, n, W, 28, 63)
            hits = rng.randint(0, 50, p.chunks) * (rng.rand(p.chunks) < 0.7)
            for k in H.chunk_ctas(p, hits.tolist()):
                rows = [r for b, e in H.chunk_rows(n, k) for r in
                        range(b, e)]
                assert rows == list(range(n)), (n, W, k)


@pytest.mark.parametrize("kind", KINDS)
def test_plan_is_the_same_for_the_same_shapes(kind):
    for W, G, B, p in _shapes(kind):
        assert _plan(kind, 1_000_000, W, G, B) == p
        assert tuple(p.as_args()) == (
            p.slots_per_cta, p.copies, p.groups_per_cta, p.chunks,
            p.stage_rows, p.list_rows, p.off_stage, p.off_list,
            p.off_count, p.smem_bytes, *p.grid, p.threads, p.row_stride,
            p.cols, p.shared)


@pytest.mark.parametrize("kind", KINDS)
def test_plan_at_the_bench_shape(kind):
    """28 groups of 63 bins: one slot's f64 histogram (42,336 B) fits
    without a group split; a first round takes one slot per CTA (one-hot
    rows: two CTAs an SM, and so up to COLS_MAX_SLOTS slots; past them
    four private warp histograms a CTA)."""
    first = _plan(kind, 1_000_000, 1, 28, 63)
    wide = _plan(kind, 1_000_000, 255 if kind != "bins" else 126, 28, 63)
    assert first.slots_per_cta == 1 and first.chunks == 1
    assert first.grid[1:] == (1, 1)
    if kind != "bins":
        assert 2 * (first.smem_bytes + 1024) <= H.SMEM_PER_SM
        assert first.grid[0] == 2 * H.H100_SMS
        # a wide column-owner launch: more waves, toward
        # COLS_CTAS_PER_SLOT CTAs a slot
        narrow = _plan(kind, 1_000_000, H.COLS_MAX_SLOTS, 28, 63)
        assert narrow.cols and narrow.chunks == H.COLS_MAX_SLOTS
        T = narrow.grid[0]
        assert first.grid[0] <= T <= H.COLS_MAX_WAVES * first.grid[0]
        assert T >= min(H.COLS_MAX_WAVES * first.grid[0],
                        H.COLS_CTAS_PER_SLOT * narrow.chunks)
    assert wide.groups_per_cta == 28 and wide.grid[2] == 1
    assert wide.chunks == -(-(255 if kind != "bins" else 126)
                            // wide.slots_per_cta)
    if kind == "bins":              # five private 42 KB warp histograms
        assert first.copies == 5 and wide.slots_per_cta == 5
    else:                           # one 42 KB histogram, column owners
        assert first.cols and first.copies == 1
        assert wide.slots_per_cta == 4
    assert wide.copies == 1 and not wide.cols


def test_plan_splits_groups_only_past_shared_memory():
    """40 groups of 255 bins (244,800 B per slot) split over grid z; 7
    groups of 255 bins do not."""
    for p in (H.onehot_hist_plan(20480, 20, 40, 255, 10200),
              H.bins_hist_plan(20480, 20, 40, 255)):
        assert p.grid[2] > 1 and p.groups_per_cta < 40
    for p in (H.onehot_hist_plan(20480, 20, 7, 255, 1785),
              H.bins_hist_plan(20480, 20, 7, 255)):
        assert p.grid[2] == 1 and p.groups_per_cta == 7
        # column owners hold one histogram; warps one each, at least 4
        assert p.cols or p.slots_per_cta * p.copies >= H.MIN_WARPS_PER_CTA


def test_plan_of_no_slots_still_launches_one_chunk():
    """W = 0 (kernel D still routes and writes the leaf ids)."""
    for p in (H.onehot_hist_plan(5000, 0, 7, 63, 441),
              H.bins_hist_plan(5000, 0, 7, 63)):
        assert p.chunks == 1 and p.grid[1] == p.grid[2] == 1
        assert p.grid[0] >= 1


def test_chunk_ctas_follow_the_work():
    """On a column-owner launch a chunk holding a large leaf takes most of
    the CTAs and a chunk with no sampled row one or two (its leaf-id
    scan); warp launches share the CTAs equally; the sum never passes
    the grid and every chunk gets one."""
    assert H.COLS_MAX_SLOTS <= H.MAX_SAMPLED_CHUNKS
    p = H.onehot_hist_plan(1_000_000, 4, 28, 63, 512)
    assert p.shared and p.grid[0] == 264
    k = H.chunk_ctas(p, [900, 0, 30, 60])
    assert min(k) >= 1 and sum(k) <= 264
    assert k[0] > 200 and k[1] <= 2 and k[0] > k[3] > k[2] > k[1]
    assert H.chunk_ctas(H.onehot_hist_plan(1_000_000, 1, 28, 63, 512),
                        [5]) == [264]
    wide = H.onehot_hist_plan(1_000_000, 255, 28, 63, 512)
    assert not wide.shared
    assert H.chunk_ctas(wide) == [wide.grid[0] // wide.chunks] * wide.chunks
    rng = np.random.RandomState(1)
    for kind in KINDS:
        for W in list(range(1, 70)) + [126, 255]:
            p = _plan(kind, int(rng.randint(1, 2_000_000)), W, 28, 63)
            hits = (rng.randint(0, 1025, p.chunks)
                    * (rng.rand(p.chunks) < 0.5)).tolist()
            k = H.chunk_ctas(p, hits)
            assert len(k) == p.chunks and min(k) >= 1
            assert sum(k) <= p.grid[0], (kind, W, p)


# ---------------------------------------------------------------------------
# The int32 shared-memory histogram of kernels A and G (csrc/hist_i32.cuh):
# ops/histogram.py frontier_hist_plan
# ---------------------------------------------------------------------------
I32_GROUPS = (1, 2, 7, 28, 33, 40)
I32_BINS = (2, 16, 63, 64, 255)


def _i32_shapes(B):
    for G in I32_GROUPS:
        for W in range(0, 256):
            yield W, G, H.frontier_hist_plan(1_000_000, W, G, B)


@pytest.mark.parametrize("B", I32_BINS)
def test_i32_plan_fits_shared_memory(B):
    """The carve-up of csrc/hist_i32.cuh: the (S, gc, B, 3) int32
    histogram, the S slot values, chain links and far positions, the
    leaf -> slot table and its counter, in that order and 16-byte
    aligned, within one CTA's 232,448 bytes."""
    for W, G, p in _i32_shapes(B):
        S, gc = p.slots_per_cta, p.groups_per_cta
        where = (W, G, B, p)
        assert p.smem_bytes <= H.SMEM_PER_CTA, where
        assert S * gc * B * 12 <= p.off_slots, where
        assert p.off_next >= p.off_slots + 4 * S, where
        assert p.off_far >= p.off_next + 4 * S, where
        assert p.off_head >= p.off_far + 4 * S, where
        assert p.off_nfar >= p.off_head + 4 * p.table, where
        assert p.smem_bytes >= p.off_nfar + 4, where
        for off in (p.off_slots, p.off_next, p.off_far, p.off_head,
                    p.off_nfar):
            assert off % 16 == 0, where
        assert p.table == H.SLOT_TABLE and p.threads == H.I32_THREADS
        assert p.threads % 32 == 0 and p.threads <= 1024
        assert 1 <= S and 1 <= gc <= G, where


@pytest.mark.parametrize("B", I32_BINS)
def test_i32_plan_covers_each_slot_and_group_once(B):
    """Grid y chunks of gc groups and grid z chunks of S slots cover
    every (slot, group) pair exactly once, no chunk is empty, and every
    chunk has at least one CTA."""
    for W, G, p in _i32_shapes(B):
        gx, gy, gz = p.grid
        S, gc = p.slots_per_cta, p.groups_per_cta
        where = (W, G, B, p)
        assert gx >= 1 and gy >= 1 and gz >= 1, where
        if W == 0:
            assert p.grid == (1, 1, 1), where
            continue
        seen = np.zeros((W, G), np.int32)
        for y in range(gy):
            groups = range(y * gc, min(G, y * gc + gc))
            assert len(groups) > 0, where
            for z in range(gz):
                slots = range(z * S, min(W, z * S + S))
                assert len(slots) > 0, where
                seen[slots.start:slots.stop, groups.start:groups.stop] += 1
        assert (seen == 1).all(), where
        # one wave, one CTA an SM: no more CTAs than SMs (unless the
        # chunks alone outnumber them)
        assert gx * gy * gz <= max(gy * gz, H.H100_SMS), where


@pytest.mark.parametrize("n", [1, 511, 512, 513, 2048, 5000, 20482])
def test_i32_plan_covers_each_row_once(n):
    """A thread takes the run of V rows from (x * threads + t) * V, then
    every gx * threads * V rows on (t < threads): the gx CTAs of a chunk
    take every row once; V is 4 only where N is a multiple of 4 (the
    kernel then reads each run's leaf ids and weights as int4 and a
    group's bins as one word)."""
    for W in (1, 42, 126):
        p = H.frontier_hist_plan(n, W, 28, 63)
        gx, T, V = p.grid[0], p.threads, p.rows_per_thread
        assert V == (4 if n % 4 == 0 else 1)
        assert gx <= -(-n // (T * V)), (n, W, p)   # no CTA without rows
        starts = np.concatenate([np.arange((x * T + t) * V, n, gx * T * V)
                                 for x in range(gx) for t in range(T)])
        rows = (starts[:, None] + np.arange(V)[None, :]).ravel()
        rows = rows[rows < n]
        assert np.array_equal(np.sort(rows), np.arange(n)), (n, W)


def test_i32_plan_at_the_bench_shape():
    """28 groups of 63 bins, one CTA of 1024 threads an SM.  A first
    round: all 28 groups of its one slot in a CTA (21 KB), one chunk,
    every SM.  126 slots: two groups of all of them a CTA (190 KB), no
    slot chunk, 14 group chunks of 9 CTAs.  255 bins: one group of 126
    slots (385 KB) does not fit, so the slots split, one group a CTA."""
    first = H.frontier_hist_plan(1_000_000, 1, 28, 63)
    assert (first.slots_per_cta, first.groups_per_cta) == (1, 28)
    assert first.grid == (H.H100_SMS, 1, 1)
    assert first.rows_per_thread == 4 and first.threads == 1024
    wide = H.frontier_hist_plan(1_000_000, 126, 28, 63)
    assert wide.slots_per_cta == 126 and wide.grid[2] == 1
    assert wide.groups_per_cta == 2 and wide.grid[1:] == (14, 1)
    assert wide.grid[0] == H.H100_SMS // 14
    b255 = H.frontier_hist_plan(1_000_000, 126, 28, 255)
    assert b255.groups_per_cta == 1 and b255.grid[2] > 1
    assert b255.grid[0] * b255.grid[1] * b255.grid[2] >= H.H100_SMS // 2


@pytest.mark.parametrize("B", I32_BINS)
def test_i32_plan_takes_all_slots_then_fewest_group_chunks(B):
    """Where one group of all W slots fits a CTA, the plan takes every
    slot and the fewest group chunks that fit (one chunk fewer would
    not), their sizes evened out; past that, slot chunks of one group,
    as many slots as fit."""
    for W, G, p in _i32_shapes(B):
        S, gc = p.slots_per_cta, p.groups_per_cta
        if W == 0:
            continue
        if p.grid[2] == 1:
            gy = p.grid[1]
            assert S == W and gc == -(-G // gy)
            if gy > 1:
                assert H._i32_layout(S, -(-G // (gy - 1)), B)[-1] \
                    > H.SMEM_PER_CTA, (W, G, B, p)
        else:
            assert gc == 1 and H._i32_layout(W, 1, B)[-1] > H.SMEM_PER_CTA
            assert H._i32_layout(S + 1, 1, B)[-1] > H.SMEM_PER_CTA


def test_i32_plan_is_the_same_for_the_same_shapes():
    for W in (0, 1, 42, 126, 255):
        p = H.frontier_hist_plan(1_000_000, W, 28, 63)
        assert H.frontier_hist_plan(1_000_000, W, 28, 63) == p
        assert tuple(p.as_args()) == (
            p.slots_per_cta, p.groups_per_cta, p.table, *p.grid, p.threads,
            p.rows_per_thread, p.off_slots, p.off_next, p.off_far, p.off_head, p.off_nfar,
            p.smem_bytes)


# ---------------------------------------------------------------------------
# Kernel I: the same int32 histogram on the row-major bins and weights.
# The plan is the same for both layouts; 4 rows a thread only where N % 4
# == 0 and the pointers are aligned (ops/histogram.py i32_aligned)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B", I32_BINS)
def test_i32_row_major_plan_fits_and_covers_every_slot_and_group(B):
    """Every W from 0 to 255 at the bench's 28 groups, aligned or not:
    the carve-up within one CTA's shared memory, every (slot, group)
    pair in exactly one chunk, and the plan that decides 4 rows a thread
    otherwise the one of A and G."""
    for W in range(0, 256):
        for aligned in (True, False):
            p = H.frontier_hist_plan(1_000_000, W, 28, B, aligned=aligned)
            where = (W, B, aligned, p)
            assert p.smem_bytes <= H.SMEM_PER_CTA, where
            assert p.slots_per_cta * p.groups_per_cta * B * 12 \
                <= p.off_slots, where
            assert p.rows_per_thread == (4 if aligned else 1), where
            if W == 0:
                assert p.grid == (1, 1, 1), where
                continue
            gx, gy, gz = p.grid
            S, gc = p.slots_per_cta, p.groups_per_cta
            seen = np.zeros((W, 28), np.int32)
            for y in range(gy):
                for z in range(gz):
                    seen[z * S:min(W, z * S + S),
                         y * gc:min(28, y * gc + gc)] += 1
            assert (seen == 1).all(), where
            same = H.frontier_hist_plan(1_000_000, W, 28, B)
            assert p._replace(rows_per_thread=4, grid=same.grid) == same


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [1, 7, 511, 512, 513, 2048, 5000, 20482,
                               1_000_000])
def test_i32_row_major_plan_covers_each_row_once(n, aligned):
    """A thread takes the run of V rows from (x * threads + t) * V, then
    every gx * threads * V rows: the gx CTAs of a chunk take every row
    once, with V = 4 only where N % 4 == 0 and the pointers are aligned
    (row-major, the 4 rows' leaf ids are one int4 and their 12 weights
    three; each row's bins are cut from the aligned words that cover
    them, which lie inside the (N, G) matrix when N % 4 == 0)."""
    for W in (1, 42, 126, 255):
        p = H.frontier_hist_plan(n, W, 28, 63, aligned=aligned)
        gx, T, V = p.grid[0], p.threads, p.rows_per_thread
        assert V == (4 if n % 4 == 0 and aligned else 1), (n, W, p)
        assert gx <= -(-n // (T * V)), (n, W, p)
        if n > 20482:
            continue
        starts = np.concatenate([np.arange((x * T + t) * V, n, gx * T * V)
                                 for x in range(gx) for t in range(T)])
        rows = (starts[:, None] + np.arange(V)[None, :]).ravel()
        rows = rows[rows < n]
        assert np.array_equal(np.sort(rows), np.arange(n)), (n, W)


def test_i32_plan_over_every_leaf():
    """compute_group_histograms_pallas_q with slots=None: one slot per
    leaf, W = 255 at the bench shape.  One group of all 255 slots of 63
    bins (192,780 B of histogram) still fits one CTA, so 28 group chunks
    of one group over every slot and no slot chunk; 255 bins split the
    slots."""
    p = H.frontier_hist_plan(1_000_000, 255, 28, 63)
    assert (p.slots_per_cta, p.groups_per_cta) == (255, 1)
    assert p.grid[1:] == (28, 1) and p.smem_bytes <= H.SMEM_PER_CTA
    assert p.grid[0] == H.H100_SMS // 28
    wide = H.frontier_hist_plan(1_000_000, 255, 28, 255)
    assert wide.groups_per_cta == 1 and wide.grid[2] > 1
    assert wide.slots_per_cta * wide.grid[2] >= 255


def test_i32_aligned_reads_the_pointers():
    """Fresh tensors are aligned; a view one element into its storage
    is not, whichever of the three it is."""
    bins = torch.zeros((64, 28), dtype=torch.uint8)
    w = torch.zeros((64, 3), dtype=torch.int32)
    leaf = torch.zeros(64, dtype=torch.int32)
    assert H.i32_aligned(bins, w, leaf)
    assert H.i32_aligned(bins.t().contiguous(), w.t().contiguous(), leaf)
    b1 = torch.zeros(64 * 28 + 4, dtype=torch.uint8)
    w1 = torch.zeros(64 * 3 + 4, dtype=torch.int32)
    l1 = torch.zeros(64 + 4, dtype=torch.int32)
    assert H.i32_aligned(b1[4:].view(64, 28), w1[4:].view(64, 3), l1[4:])
    assert not H.i32_aligned(b1[1:65 * 28 - 27].view(64, 28), w, leaf)
    assert not H.i32_aligned(bins, w1[1:193].view(64, 3), leaf)
    assert not H.i32_aligned(bins, w, l1[2:66])


# ---------------------------------------------------------------------------
# Kernel J: the run plan over the partition blocks (ops/histogram.py
# seg_hist_plan, the geometry the wrapper passes, and seg_runs, the runs
# its first launch builds on the device)
# ---------------------------------------------------------------------------
def _partition_map(n, L, slots, seed=3, first_round=False):
    """blk_slot of a real leaf partition of n rows over L leaves (as the
    grower builds it), and its n_cap."""
    from lightgbm_tpu_torch.ops.partition import (block_slots,
                                                  build_leaf_partition)
    rng = np.random.RandomState(seed)
    n = -(-n // H.SEG_BLOCK) * H.SEG_BLOCK
    leaf = np.zeros(n, np.int32) if first_round else rng.randint(
        0, L, n).astype(np.int32)
    leaf[rng.rand(n) < 0.01] = -1
    _, blk_leaf, _ = build_leaf_partition(torch.from_numpy(leaf),
                                          num_slots=L, block=H.SEG_BLOCK)
    s = torch.tensor(slots, dtype=torch.int32)
    return block_slots(blk_leaf, s, L), blk_leaf.shape[0] * H.SEG_BLOCK


def _built_maps():
    """{label: () -> (blk_slot, n_cap, num_out)}: the bench's partitions
    (1M rows, 255 leaves) at the first round, W=126 and all 255 leaves,
    the card tests' (20,480 rows, 48 leaves), and block maps no
    partition makes: slots interleaved block by block, every block its
    own slot, one slot holding 90% of the blocks (the rest in 50), random
    slots with dead and out-of-range blocks, no live block, and maps
    whose live items number fewer than the CTAs (one live block, two
    one-block slots, two blocks of one slot)."""
    rng = np.random.RandomState(5)
    s126 = rng.permutation(255)[:126].tolist()
    s20 = rng.permutation(48)[:20].tolist()
    nblk = 2210
    skew = np.where(np.arange(nblk) < 0.9 * nblk, 0,
                    1 + np.arange(nblk) % 50)

    def fixed(a, num_out):
        return lambda: (torch.from_numpy(a.astype(np.int32)),
                        a.size * 512, num_out)

    def few(live):
        a = np.full(nblk, -1)
        a[[3, 1500][:len(live)]] = live
        return fixed(a, max(live) + 1)
    return {
        "bench first round": lambda: (*_partition_map(
            1_000_000, 255, [0], first_round=True), 1),
        "bench W=126": lambda: (*_partition_map(1_000_000, 255, s126),
                                126),
        "bench all 255 leaves": lambda: (*_partition_map(
            1_000_000, 255, list(range(255))), 255),
        "tests W=20": lambda: (*_partition_map(20480, 48, s20), 20),
        "interleaved slots": fixed(np.arange(nblk) % 7, 7),
        "one block a slot": fixed(rng.permutation(nblk), nblk),
        "one slot of 90% of the blocks": fixed(skew, 51),
        "random with dead and out-of-range blocks": fixed(
            rng.randint(-3, 60, nblk), 50),
        "no live block": fixed(np.full(nblk, -1), 4),
        "one live block": few([0]),
        "two one-block slots": few([1, 0]),
        "two blocks of one slot": few([0, 0]),
        "two blocks, the only two": fixed(np.array([0, 1]), 2),
    }


_MAPS = _built_maps()
MAPS = list(_MAPS)


@functools.lru_cache(maxsize=None)
def _map(label):
    return _MAPS[label]()


@pytest.mark.parametrize("per_blk", [128, 512])
@pytest.mark.parametrize("label", MAPS)
def test_seg_runs_cover_each_live_row_once(label, per_blk):
    """Every live row (0 <= slot < num_out; items of 4 rows or of one)
    lies in exactly one run, a run holds items of one slot and one CTA's
    share (c * items / ctas ..), a dead block lies in none, and each
    slot's blocks are listed together in block order."""
    blk_slot, n_cap, num_out = _map(label)
    p = H.seg_hist_plan(n_cap, 28, 63, num_out)
    order, boff, runs = H.seg_runs(blk_slot, num_out, p.ctas, per_blk)
    bs = blk_slot.numpy()
    live = np.flatnonzero((bs >= 0) & (bs < num_out))
    assert np.array_equal(np.sort(order.numpy()), live), label
    assert np.array_equal(bs[order.numpy()], np.sort(bs[live])), label
    items = int(boff[-1]) * per_blk
    r = runs.numpy()
    seen = np.zeros(items, np.int64)
    for cta, slot, lo, hi in r:
        assert lo < hi, (label, cta)
        seen[lo:hi] += 1
        # one slot: the first and last items' blocks are the slot's
        assert (bs[order.numpy()[[lo // per_blk, (hi - 1) // per_blk]]]
                == slot).all(), (label, cta)
        assert cta * items // p.ctas <= lo, (label, cta)
        assert hi <= (cta + 1) * items // p.ctas, (label, cta)
    assert (seen == 1).all() and items == live.size * per_blk, label


@pytest.mark.parametrize("label", MAPS)
def test_seg_runs_bound_the_flushes(label):
    """The grid is ctas CTAs whatever the map (nothing is read back to
    the host); a CTA flushes each slot it meets once, so its runs are of
    distinct slots, consecutive in the list, and all runs (each one
    atomic flush of a (G, B, 3) histogram) number at most ctas +
    num_out: one a CTA, and one more each time a share crosses into a
    slot."""
    blk_slot, n_cap, num_out = _map(label)
    p = H.seg_hist_plan(n_cap, 28, 63, num_out)
    _, boff, runs = H.seg_runs(blk_slot, num_out, p.ctas, 128)
    r = runs.numpy()
    for c in np.unique(r[:, 0]):
        slots = r[r[:, 0] == c, 1]
        assert (np.diff(slots) > 0).all(), (label, c)
    assert len(r) <= p.ctas + num_out, (label, len(r))
    assert len(np.unique(r[:, 0])) <= p.ctas
    if label == "bench first round":
        assert len(r) == p.ctas == H.SEG_CTAS_PER_SM * H.H100_SMS


@pytest.mark.parametrize("label", MAPS)
def test_seg_runs_share_the_rows_evenly(label):
    """The CTAs' shares differ by at most one item (4 rows) however the
    slots are sized: a first round, a skewed or a wide frontier load
    every CTA alike; where the items number fewer than the CTAs, a share
    is one item or none."""
    blk_slot, n_cap, num_out = _map(label)
    p = H.seg_hist_plan(n_cap, 28, 63, num_out)
    _, boff, runs = H.seg_runs(blk_slot, num_out, p.ctas, 128)
    r = runs.numpy()
    share = np.bincount(r[:, 0], weights=r[:, 3] - r[:, 2],
                        minlength=p.ctas)
    items = int(boff[-1]) * 128
    assert share.sum() == items and share.size == p.ctas
    assert share.max() - share.min() <= 1, label


@pytest.mark.parametrize("num_out", [1, 20, 126, 255, H.SEG_MAX_SLOTS])
@pytest.mark.parametrize("G, B", [(7, 63), (28, 63), (28, 255), (40, 255),
                                  (75, 255), (76, 255), (200, 255),
                                  (307, 63), (308, 63)])
def test_seg_plan_scratch_fits(num_out, G, B):
    """The buffers the wrapper allocates hold what the launches write:
    the plan (rank and order a block, an offset a slot and one more), a
    CTA's histogram and the plan's shared memory within 232,448 bytes
    (SEG_MAX_SLOTS slots at most), and group chunks that cover every
    group once.  The groups split only where one slot's histogram
    outgrows a CTA: past G * B * 12 bytes of 232,448 (76 groups of 255
    bins, 308 of 63)."""
    n_cap = 1_000_448 + 256 * H.SEG_BLOCK
    nblk = n_cap // H.SEG_BLOCK
    p = H.seg_hist_plan(n_cap, G, B, num_out)
    assert p.meta_words == 2 * nblk + num_out + 1
    K = p.slots_per_cta
    assert K >= 1
    assert p.smem_bytes == K * p.groups_per_cta * B * 12 <= H.SMEM_PER_CTA
    if K > 1:   # two CTAs of K slots fit an SM; one more slot would not
        assert H.SEG_CTAS_PER_SM * (p.smem_bytes + H.SMEM_RESERVED_PER_CTA
                                    ) <= H.SMEM_PER_SM
        assert H.SEG_CTAS_PER_SM * (
            p.smem_bytes + p.groups_per_cta * B * 12
            + H.SMEM_RESERVED_PER_CTA) > H.SMEM_PER_SM
    assert p.plan_smem >= 4 * (num_out + 1)
    assert p.plan_smem <= H.SMEM_PER_CTA and p.plan_smem % 16 == 0
    covered = np.zeros(G, np.int32)
    for y in range(p.grid_y):
        groups = range(y * p.groups_per_cta,
                       min(G, (y + 1) * p.groups_per_cta))
        assert len(groups) > 0
        covered[groups.start:groups.stop] += 1
    assert (covered == 1).all()
    assert (p.grid_y > 1) == (G * B * 12 > H.SMEM_PER_CTA)
    if p.grid_y > 1:    # the fewest chunks that fit
        assert -(-G // (p.grid_y - 1)) * B * 12 > H.SMEM_PER_CTA
    assert p.threads == H.SEG_THREADS and p.threads % 32 == 0
    assert p.ctas == H.SEG_CTAS_PER_SM * H.H100_SMS


def test_seg_plan_at_the_bench_shape():
    """1M rows padded to 1,000,448 plus 256 blocks of partition slack:
    264 CTAs (two an SM), all 28 groups of 63 bins in one 21,168-byte
    histogram a slot, 5 slots' at once (105,840 bytes a CTA), 4 rows an
    item on aligned operands and 1 otherwise, the same plan for the
    same shapes."""
    n_cap = 1_000_448 + 256 * H.SEG_BLOCK
    p = H.seg_hist_plan(n_cap, 28, 63, 126)
    assert p.ctas == 264
    assert (p.groups_per_cta, p.grid_y, p.slots_per_cta,
            p.smem_bytes) == (28, 1, 5, 5 * 21168)
    assert p.rows_per_thread == 4
    assert H.seg_hist_plan(n_cap, 28, 63, 126, aligned=False
                           ).rows_per_thread == 1
    assert H.seg_hist_plan(n_cap, 28, 63, 126, block=510
                           ).rows_per_thread == 1
    assert H.seg_hist_plan(n_cap, 28, 63, 126) == p
    assert tuple(p.as_args()) == (p.ctas, p.groups_per_cta, p.grid_y,
                                  p.threads, p.rows_per_thread,
                                  p.slots_per_cta, p.smem_bytes,
                                  p.plan_smem)


@pytest.mark.parametrize("num_out", [1, 2, 33, 126, 255, H.SEG_MAX_SLOTS])
def test_seg_plan_grid_does_not_follow_the_slots(num_out):
    """The histogram's grid and shared memory are the same at any slot
    count (the frontier's width is known on the device only): only the
    plan's shared memory and its meta buffer grow with num_out."""
    n_cap = 1_000_448 + 256 * H.SEG_BLOCK
    p = H.seg_hist_plan(n_cap, 28, 63, num_out)
    q = H.seg_hist_plan(n_cap, 28, 63, 1)
    assert p[:7] == q[:7]
    assert p.plan_smem - q.plan_smem == _round16(4 * (num_out + 1)) - 16
    assert p.meta_words - q.meta_words == num_out - 1


def _round16(x):
    return -(-x // 16) * 16


def test_seg_hist_on_the_cpu_takes_any_slot_count():
    """Kernel J's slot limit (SEG_MAX_SLOTS, its plan's shared memory)
    binds only the card: on CPU tensors seg_hist is the plain version at
    any num_out, as the JAX entry point takes any."""
    rng = np.random.RandomState(2)
    num_out = H.SEG_MAX_SLOTS + 2
    binsT = torch.from_numpy(rng.randint(0, 5, (2, 2 * H.SEG_BLOCK)).astype(
        np.uint8))
    wT = torch.from_numpy(rng.randint(-9, 9, (3, 2 * H.SEG_BLOCK)).astype(
        np.int32))
    blk_slot = torch.tensor([num_out - 1, 0], dtype=torch.int32)
    got = H.seg_hist(binsT, wT, blk_slot, num_out, 4)
    assert got.shape == (num_out, 2, 4, 3)
    assert torch.equal(got, H.seg_hist_plain(binsT, wT, blk_slot, num_out,
                                             4))
    assert int(got[num_out - 1, ..., 2].sum()) == int(
        (wT[2, :H.SEG_BLOCK] * (binsT[:, :H.SEG_BLOCK] < 4)).sum())


def test_packed_chunk_boundaries_on_pack_units():
    """The plan rounds A's and G's group chunks to whole storage bytes
    where it can (28 nibble groups of 15 bins at W=126: 4 chunks of 8,
    not of 7) and leaves the byte-wide plan as it was."""
    plain = H.frontier_hist_plan(1_000_000, 126, 28, 15)
    nib = H.frontier_hist_plan(1_000_000, 126, 28, 15, unit=2)
    assert plain.groups_per_cta == 7 and nib.groups_per_cta == 8
    assert plain.grid[1] == nib.grid[1] == 4
    assert H.pack_unit(0) == 1 and H.pack_unit(28) == 2
