"""Per-leaf (weighted) percentiles: the leaf refit of the L1-family
objectives (RenewTreeOutput).

Port of lightgbm_tpu/ops/percentile.py.  The JAX function is plain XLA
(a two-key sort, searchsorted, a segment minimum) with no Pallas body,
so torch ops are its port on every device: a stable sort by residual
followed by a stable sort by leaf gives the (leaf, residual) order, and
``scatter_reduce("amin")`` takes each leaf's first row past the
weighted threshold.  Rows that tie on (leaf, residual) keep their row
order; XLA's unstable sort may order them otherwise, which moves the
weighted running sums (and so a weighted result) in the last bit only.
"""
from __future__ import annotations

from typing import Optional

import torch

from .split import cumsum_f32


def _sort_by_leaf_then_residual(lid: torch.Tensor, residual: torch.Tensor):
    """Row order sorted by (leaf, residual), ties in row order."""
    by_r = torch.sort(residual, stable=True).indices
    by_leaf = torch.sort(lid[by_r], stable=True).indices
    return by_r[by_leaf]


def leaf_percentiles(residual: torch.Tensor, leaf_id: torch.Tensor,
                     num_leaves: int, alpha: float,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """alpha-percentile of ``residual`` within each leaf.

    Args:
      residual: (N,) f32 values (label - prediction).
      leaf_id: (N,) int32; negative ids are ignored.
      num_leaves: L.
      weights: optional (N,) f32 weights (weighted-percentile semantics).

    Returns: (L,) f32 percentile per leaf (0 for empty leaves).
    """
    n = residual.shape[0]
    dev = residual.device
    lid = torch.where(leaf_id >= 0, leaf_id,
                      torch.full_like(leaf_id, num_leaves)).to(torch.int32)
    order = _sort_by_leaf_then_residual(lid, residual)
    s_leaf, s_r = lid[order], residual[order]
    arange_l = torch.arange(num_leaves, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(s_leaf, arange_l, side="left")
    ends = torch.searchsorted(s_leaf, arange_l, side="right")
    counts = ends - starts
    zero = torch.zeros((), dtype=residual.dtype, device=dev)
    if weights is None:
        # PercentileFun: position interpolation at alpha*(n-1)
        pos = alpha * (counts - 1).to(torch.float32)
        lo = torch.floor(pos).to(torch.int64)
        frac = pos - lo.to(torch.float32)
        i_lo = (starts + lo).clamp(0, n - 1)
        i_hi = (starts + torch.minimum(lo + 1, counts - 1)).clamp(0, n - 1)
        vals = s_r[i_lo] * (1.0 - frac) + s_r[i_hi] * frac
        return torch.where(counts > 0, vals, zero)

    s_w = weights[order]
    cumw = cumsum_f32(s_w)
    cumw_before_start = torch.where(
        starts > 0, cumw[(starts - 1).clamp(min=0)], zero)
    total_w = torch.where(
        counts > 0, cumw[(ends - 1).clamp(0, n - 1)] - cumw_before_start,
        zero)
    # WeightedPercentileFun: c_i = cum_within - w_i/2, find the first
    # c_i >= alpha * total, interpolate between neighbours
    safe_lid = s_leaf.clamp(0, num_leaves - 1).long()
    within = cumw - cumw_before_start[safe_lid]
    c = within - s_w / 2.0
    thr = alpha * total_w
    flag = (c >= thr[safe_lid]) & (s_leaf < num_leaves)
    row = torch.arange(n, dtype=torch.int64, device=dev)
    idx_cand = torch.where(flag, row, torch.full_like(row, n))
    # segment minimum; an empty segment keeps the identity (int64 max,
    # as jax.ops.segment_min's int32 max), masked below
    first = torch.full((num_leaves,), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=dev).scatter_reduce(
        0, safe_lid, idx_cand, reduce="amin")
    first = torch.where(counts > 0, first, torch.zeros_like(first))
    at_start = first <= starts
    at_end = first >= ends
    i = first.clamp(0, n - 1)
    prev = (first - 1).clamp(0, n - 1)
    c_i, c_prev = c[i], c[prev]
    t = (thr - c_prev) / torch.clamp(c_i - c_prev, min=1e-30)
    interp = s_r[prev] * (1.0 - t) + s_r[i] * t
    vals = torch.where(at_start, s_r[starts.clamp(0, n - 1)],
                       torch.where(at_end, s_r[(ends - 1).clamp(0, n - 1)],
                                   interp))
    return torch.where(counts > 0, vals, zero)
