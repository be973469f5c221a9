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
"""
from __future__ import annotations

import torch

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
                 num_bin, cat_mask, right_slot) -> torch.Tensor:
    """Re-label the rows of the leaves splitting this round (left
    children keep the parent slot): the route table of the splits
    applied at once to the (N, G) bins, as lightgbm_tpu/ops/partition.py
    apply_splits does on the plans without a fused route."""
    table = build_route_table(
        split_mask, feat_group, fb_lo, fb_hi, fb_shift, fb_oor, is_cat,
        threshold, default_left, missing_type, default_bin, num_bin,
        cat_mask, right_slot)
    return apply_route_table(bins, leaf_id, table)


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


def chosen_group_bins(bins: torch.Tensor, rows: torch.Tensor
                      ) -> torch.Tensor:
    """Per-row bin of the route table's chosen group (0 where the group
    index is out of range).  ``bins`` is (N, G) uint8."""
    G = bins.shape[1]
    grp = rows[:, 0].to(torch.int32) * 256 + rows[:, 1].to(torch.int32)
    ok = (grp >= 0) & (grp < G)
    gb = torch.gather(bins, 1, grp.clamp(0, G - 1).long()[:, None])[:, 0]
    return torch.where(ok, gb.to(torch.int32), torch.zeros(
        (), dtype=torch.int32, device=bins.device))


def apply_route_table(bins: torch.Tensor, leaf_id: torch.Tensor,
                      table: torch.Tensor, values=None):
    """Re-label rows from a packed (L, 15+nb) route table.  ``bins`` is
    the (N, G) uint8 group-bin matrix.  With ``values`` ((L,) f32 leaf
    values) also returns each row's POST-route leaf value, assembled
    from the bf16-split columns in the TPU kernel's order (0.0 on rows
    with a negative leaf)."""
    ncols = table.shape[1]
    if values is not None:
        table = extend_table_with_values(table, values)
    rows_all = gather_route_rows(table, leaf_id)
    rows = rows_all[:, :ncols]
    gb = chosen_group_bins(bins, rows)
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
