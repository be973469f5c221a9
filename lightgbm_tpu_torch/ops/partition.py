"""Row routing: apply chosen splits to the per-row leaf assignment.

Port of lightgbm_tpu/ops/partition.py.  Every row carries a ``leaf_id``
and one vectorized pass re-labels the rows of every leaf split this
round.  The per-leaf split scalars live in a route table (one row per
leaf); the routing decision is evaluated per row.

Routing semantics (feature-bin space after the group->feature affine
map ``featbin = gb - shift if lo <= gb < hi else oor``):
  * NaN-missing: NaN bin (last) rides ``default_left``; other bins
    compare ``bin <= threshold``.
  * Zero-missing: the default(zero) bin rides ``default_left``; other
    bins compare.
  * None: plain compare.
  * Categorical: bit ``featbin`` of the packed left-set decides.

The functions here are the plain versions behind the routing of the
fused histogram kernel and the exit-route kernel (ops/histogram.py,
csrc/route.cuh).  They follow the Pallas kernels' table lookup: a row
whose leaf is negative or has no table row is left untouched.

Sub-byte bin storage (packing.py): a ``packed_groups`` pack spec
(``pack_spec(P, C)``, 0 for the byte-wide matrix) marks ``bins`` as the
(N, cols) storage matrix of the logical groups; the routers gather the
chosen group's storage byte and widen it, ``(byte >> shift) & mask``
(:func:`packed_select_params`), and never widen the matrix.
"""
from __future__ import annotations

import torch

from ..packing import logical_groups, packed_bytes, spec_crumb, spec_packed

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

# fixed route-table column layout (shared by the plain router below and
# the CUDA kernels' routing, csrc/route.cuh):
#   0 fg_hi, 1 fg_lo, 2 threshold, 3 default_left, 4 missing_type,
#   5 default_bin, 6 num_bin, 7 is_cat, 8 rs_hi, 9 rs_lo,
#   10 active(split_mask), 11 fb_lo, 12 fb_hi, 13 fb_shift, 14 fb_oor,
#   15.. cat bytes (ceil(B/8) packed little-endian)
ROUTE_FIXED_COLS = 15


def pack_mask_bytes(mask: torch.Tensor) -> torch.Tensor:
    """(L, B) bool -> (L, ceil(B/8)) packed little-endian byte floats
    (each < 256, exact in f32)."""
    L, B = mask.shape
    nb = (B + 7) // 8
    pad = nb * 8 - B
    if pad:
        mask = torch.cat(
            [mask, torch.zeros((L, pad), dtype=torch.bool,
                               device=mask.device)], dim=1)
    bits = mask.reshape(L, nb, 8).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=mask.device))
    return (bits * weights).sum(dim=2).to(torch.float32)


def build_route_table(split_mask, feat_group, fb_lo, fb_hi, fb_shift,
                      fb_oor, is_cat, threshold, default_left,
                      missing_type, default_bin, num_bin, cat_mask,
                      right_slot) -> torch.Tensor:
    """(L, 15 + ceil(B/8)) f32 per-leaf routing table.  Every column
    is an integer < 256 (right_slot and feat_group are split hi/lo),
    so the table reads the same whether a kernel gathers it directly
    or broadcasts it through a bf16 product as the TPU kernels do."""
    def col(v):
        return v.to(torch.float32)[:, None]

    rs = right_slot.to(torch.int32)
    fg = feat_group.to(torch.int32)
    return torch.cat([
        col(fg // 256), col(fg % 256), col(threshold), col(default_left),
        col(missing_type), col(default_bin), col(num_bin),
        col(is_cat), col(rs // 256), col(rs % 256), col(split_mask),
        col(fb_lo), col(fb_hi), col(fb_shift), col(fb_oor),
        pack_mask_bytes(cat_mask),
    ], dim=1)


def apply_splits(bins: torch.Tensor, leaf_id: torch.Tensor, split_mask,
                 feat_group, fb_lo, fb_hi, fb_shift, fb_oor, is_cat,
                 threshold, default_left, missing_type, default_bin,
                 num_bin, cat_mask, right_slot,
                 packed_groups: int = 0) -> torch.Tensor:
    """Re-label the rows of the leaves splitting this round (left
    children keep the parent slot): the route table of the splits
    applied at once to the (N, G) bins (or their (N, cols) sub-byte
    storage under ``packed_groups``), as lightgbm_tpu/ops/partition.py
    apply_splits does on the plans without a fused route."""
    table = build_route_table(
        split_mask, feat_group, fb_lo, fb_hi, fb_shift, fb_oor, is_cat,
        threshold, default_left, missing_type, default_bin, num_bin,
        cat_mask, right_slot)
    return apply_route_table(bins, leaf_id, table,
                             packed_groups=packed_groups)


def route_rows(rows: torch.Tensor, leaf_id: torch.Tensor,
               gb: torch.Tensor, with_decision: bool = False):
    """Routing decision: ``rows`` is the per-row broadcast of the route
    table ((N, 15+nb) f32, all-zero for rows with no table row), ``gb``
    the per-row bin of the chosen group.  Returns the updated leaf id
    (plus the went-right mask when ``with_decision``).

    NOTE: csrc/route.cuh ``route_row`` is the CUDA form of this logic;
    any semantic change must land in both."""
    nb = rows.shape[-1] - ROUTE_FIXED_COLS

    def icol(i):
        return rows[..., i].to(torch.int32)

    thr = icol(2)
    dleft = icol(3)
    mtype = icol(4)
    dbin = icol(5)
    nbin = icol(6)
    iscat = rows[..., 7] > 0.5
    rs = icol(8) * 256 + icol(9)
    active = (rows[..., 10] > 0.5) & (leaf_id >= 0)
    lo, hi = icol(11), icol(12)
    shift, oor = icol(13), icol(14)

    fbin = torch.where((gb >= lo) & (gb < hi), gb - shift, oor)

    is_nan_bin = fbin == nbin - 1
    is_def_bin = fbin == dbin
    cmp_left = (fbin <= thr).to(torch.int32)
    num_left = torch.where(
        (mtype == MISSING_NAN) & is_nan_bin, dleft,
        torch.where((mtype == MISSING_ZERO) & is_def_bin, dleft, cmp_left))

    byte_idx = torch.div(fbin, 8, rounding_mode="floor")
    bsel = byte_idx[..., None] == torch.arange(
        nb, dtype=torch.int32, device=rows.device)
    byte_val = torch.where(bsel, rows[..., ROUTE_FIXED_COLS:],
                           torch.zeros((), device=rows.device)
                           ).sum(dim=-1).to(torch.int32)
    cat_left = (byte_val >> torch.remainder(fbin, 8)) & 1

    go_left = torch.where(iscat, cat_left, num_left) > 0
    new_leaf = torch.where(active & ~go_left, rs, leaf_id)
    if with_decision:
        return new_leaf, active & ~go_left
    return new_leaf


def _split3_bf16(v: torch.Tensor) -> list:
    """f32 (L,) -> three bf16-exact f32 columns summing to v within
    ~2^-21 relative, built by bitmask truncation of the low 16 mantissa
    bits (lightgbm_tpu/ops/partition.py _split3_bf16).  The exit-route
    kernel reproduces the TPU kernel's row values exactly by adding
    these parts in the same order."""
    def trunc(x):
        b = x.to(torch.float32).contiguous().view(torch.int32)
        return (b & -65536).view(torch.float32)        # 0xFFFF0000

    hi = trunc(v)
    r1 = v - hi
    mid = trunc(r1)
    lo = trunc(r1 - mid)
    return [hi[:, None], mid[:, None], lo[:, None]]


def extend_table_with_values(table: torch.Tensor,
                             values: torch.Tensor) -> torch.Tensor:
    """Append the exit-route leaf-VALUE columns to a route table: the
    keep-slot and right-child values, each as three bf16-split columns
    ([ncols, ncols+6) — the layout csrc/route_apply.cu reads)."""
    rs_l = (table[:, 8].to(torch.int32) * 256
            + table[:, 9].to(torch.int32))
    v_right = values[rs_l.clamp(0, values.shape[0] - 1).long()]
    return torch.cat(
        [table] + _split3_bf16(values) + _split3_bf16(v_right), dim=1)


def gather_route_rows(table: torch.Tensor,
                      leaf_id: torch.Tensor) -> torch.Tensor:
    """Per-row route-table rows; all-zero (routes nothing) for rows
    whose leaf is negative or beyond the table — the Pallas kernels'
    one-hot broadcast gives zero there too."""
    L = table.shape[0]
    ok = (leaf_id >= 0) & (leaf_id < L)
    rows = table[leaf_id.clamp(0, L - 1).long()]
    return torch.where(ok[:, None], rows, torch.zeros((), device=rows.device))


def packed_select_params(grp: torch.Tensor, packed_groups: int):
    """Storage byte, crumb/nibble shift and width mask of the logical
    groups ``grp`` (an int32 tensor of groups in [0, G)) under the pack
    spec ``packed_groups``: the one torch form of packing.py
    ``BinLayout.byte_of/shift_of/width_mask`` (lightgbm_tpu/ops/
    partition.py packed_select_params), shared by every gather of the
    storage (``chosen_group_bins`` here, ops/predict.py
    ``predict_binned``); csrc/pack.cuh is its CUDA form.  The bin is
    ``(byte >> shift) & mask``."""
    P, C = spec_packed(packed_groups), spec_crumb(packed_groups)
    cb, pb = (C + 3) // 4, packed_bytes(packed_groups)
    is_c = grp < C
    is_n = (grp >= C) & (grp < P)
    byte_idx = torch.where(is_c, grp // 4, torch.where(
        is_n, cb + (grp - C) // 2, pb + grp - P))
    shift = torch.where(is_c, (grp % 4) * 2,
                        torch.where(is_n, ((grp - C) % 2) * 4, 0))
    mask = torch.where(is_c, 3, torch.where(is_n, 15, 255))
    return byte_idx, shift, mask


def chosen_group_bins(bins: torch.Tensor, rows: torch.Tensor,
                      packed_groups: int = 0) -> torch.Tensor:
    """Per-row bin of the route table's chosen group (0 where the group
    index is out of range).  ``bins`` is (N, G) uint8, or under
    ``packed_groups`` the (N, cols) storage of G logical groups, whose
    chosen storage byte is gathered and widened."""
    cols = bins.shape[1]
    G = logical_groups(cols, packed_groups) if packed_groups else cols
    grp = rows[:, 0].to(torch.int32) * 256 + rows[:, 1].to(torch.int32)
    ok = (grp >= 0) & (grp < G)
    grp = grp.clamp(0, G - 1)
    if packed_groups:
        byte_idx, shift, mask = packed_select_params(grp, packed_groups)
        byte = torch.gather(bins, 1, byte_idx.long()[:, None])[:, 0]
        gb = (byte.to(torch.int32) >> shift) & mask
    else:
        gb = torch.gather(bins, 1, grp.long()[:, None])[:, 0]
    return torch.where(ok, gb.to(torch.int32), torch.zeros(
        (), dtype=torch.int32, device=bins.device))


def partition_capacity(n: int, num_slots: int, block: int) -> int:
    """Row capacity of a leaf partition: each of the ``num_slots + 1``
    buckets (leaf slots plus the invalid bucket) can waste up to one
    block of alignment padding."""
    return n + (num_slots + 1) * block


def build_leaf_partition(leaf_id: torch.Tensor, *, num_slots: int,
                         block: int):
    """Stable leaf-segment permutation, byte-identical to
    lightgbm_tpu/ops/partition.py build_leaf_partition: rows stably
    sorted by leaf (negative leaf ids go to a trailing invalid bucket),
    each leaf's segment start aligned up to a ``block`` multiple, so
    every block of ``block`` partitioned rows belongs to one leaf.

    The permutation moves whole rows, so :func:`apply_partition` of a
    sub-byte storage matrix's columns (its (cols, N) transpose) keeps
    every storage byte, and with it every packed group, intact.

    Returns (perm, blk_leaf, seg_count), all int32:
      perm: (partition_capacity(N),) source row of each partitioned
        position, -1 in alignment gaps and the capacity tail;
      blk_leaf: (capacity // block,) owning leaf of each block, -1 for
        blocks holding no real row of a leaf slot;
      seg_count: (num_slots + 1,) real rows per bucket (last = invalid).
    """
    n = leaf_id.shape[0]
    if n % block:
        raise ValueError(f"N ({n}) must be a multiple of block ({block})")
    dev = leaf_id.device
    num_buckets = num_slots + 1
    lid = torch.where(leaf_id >= 0, leaf_id,
                      torch.full_like(leaf_id, num_slots)).to(torch.int32)
    sorted_lid, order = torch.sort(lid, stable=True)
    bucket_iota = torch.arange(num_buckets, dtype=torch.int32, device=dev)
    seg_first = torch.searchsorted(sorted_lid, bucket_iota).to(torch.int32)
    seg_count = (torch.searchsorted(sorted_lid, bucket_iota, right=True)
                 .to(torch.int32) - seg_first)
    aligned = (seg_count + block - 1) // block * block
    astart = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(aligned, 0, dtype=torch.int32)]
                       )[:num_buckets]
    # partitioned position of sorted entry i: its bucket's aligned start
    # plus its stable rank within the bucket
    sl = sorted_lid.long()
    pos = astart[sl] + (torch.arange(n, dtype=torch.int32, device=dev)
                        - seg_first[sl])
    n_cap = partition_capacity(n, num_slots, block)
    perm = torch.full((n_cap,), -1, dtype=torch.int32, device=dev)
    perm[pos.long()] = order.to(torch.int32)
    bstart = torch.arange(n_cap // block, dtype=torch.int32,
                          device=dev) * block
    blk_leaf = torch.searchsorted(astart, bstart, right=True).to(
        torch.int32) - 1
    safe = blk_leaf.clamp(0, num_buckets - 1).long()
    live = (bstart < astart[safe] + seg_count[safe]) & (blk_leaf < num_slots)
    return perm, torch.where(live, blk_leaf, -1), seg_count


def block_slots(blk_leaf: torch.Tensor, slots: torch.Tensor,
                num_slots: int) -> torch.Tensor:
    """Each partition block's position in ``slots`` (-1: a dead block or
    a leaf not in ``slots``), the block map the segment histogram reads
    (lightgbm_tpu/learner/grower.py _hist_kernel_seg).  ``slots`` holds
    distinct leaf ids in [0, num_slots)."""
    inv = torch.full((num_slots + 1,), -1, dtype=torch.int32,
                     device=slots.device)
    inv[slots.long()] = torch.arange(slots.shape[0], dtype=torch.int32,
                                     device=slots.device)
    return torch.where(blk_leaf >= 0,
                       inv[blk_leaf.clamp(0, num_slots).long()], -1)


def apply_partition(arr: torch.Tensor, perm: torch.Tensor,
                    axis: int = 0) -> torch.Tensor:
    """Gather ``arr`` along ``axis`` into partitioned order; gap entries
    (perm -1) are zero, masked explicitly as the JAX function does.  A
    row of bins moves whole: the (cols, N) sub-byte storage permutes as
    the (G, N) matrix does, its gap rows all-zero bytes (every packed
    group's bin 0, at zero weight)."""
    taken = arr.index_select(axis, perm.clamp(0, arr.shape[axis] - 1).long())
    shape = [1] * arr.dim()
    shape[axis] = perm.shape[0]
    return torch.where((perm >= 0).reshape(shape), taken,
                       torch.zeros((), dtype=arr.dtype, device=arr.device))


def apply_route_table(bins: torch.Tensor, leaf_id: torch.Tensor,
                      table: torch.Tensor, values=None,
                      packed_groups: int = 0):
    """Re-label rows from a packed (L, 15+nb) route table.  ``bins`` is
    the (N, G) uint8 group-bin matrix, or under ``packed_groups`` its
    (N, cols) sub-byte storage.  With ``values`` ((L,) f32 leaf values)
    also returns each row's POST-route leaf value, assembled from the
    bf16-split columns in the TPU kernel's order (0.0 on rows with a
    negative leaf)."""
    ncols = table.shape[1]
    if values is not None:
        table = extend_table_with_values(table, values)
    rows_all = gather_route_rows(table, leaf_id)
    rows = rows_all[:, :ncols]
    gb = chosen_group_bins(bins, rows, packed_groups)
    if values is None:
        return route_rows(rows, leaf_id, gb)
    new_leaf, went_right = route_rows(rows, leaf_id, gb,
                                      with_decision=True)
    vk = (rows_all[:, ncols] + rows_all[:, ncols + 1]
          + rows_all[:, ncols + 2])
    vr = (rows_all[:, ncols + 3] + rows_all[:, ncols + 4]
          + rows_all[:, ncols + 5])
    row_value = torch.where(went_right, vr, vk)
    row_value = torch.where(leaf_id >= 0, row_value,
                            torch.zeros((), device=row_value.device))
    return new_leaf, row_value
