"""Best-split search over histograms, vectorized across (leaf, feature,
bin).

Port of lightgbm_tpu/ops/split.py: every (leaf, feature, threshold,
direction) candidate is scored at once with cumulative sums and masks.
Numerical missing handling:
  * MissingType::None  — single default-left scan over all thresholds.
  * MissingType::Zero  — two scans with the default(zero) bin excluded
    from directional accumulation (zeros ride the default direction).
  * MissingType::NaN   — two scans; the NaN bin (last) is excluded from
    the default-left accumulation and rides the default direction.

Categorical features take one-hot splits at small cardinality and
otherwise the categories sorted by grad/hess ratio, scanned from both
ends (:func:`find_categorical_splits`); the chosen split's left set is
rebuilt as a bin mask (:func:`build_cat_bitset`) for the route table.
Forced splits evaluate one given (feature, threshold) per leaf
(:func:`forced_split_block`).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

K_EPSILON = 1e-15          # reference meta.h:38
K_MIN_SCORE = -math.inf

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

# packed per-leaf candidate layout (lightgbm_tpu/ops/split.py)
CAND_GAIN = 0
CAND_FEATURE = 1
CAND_THRESHOLD = 2
CAND_DEFAULT_LEFT = 3
CAND_LSG = 4
CAND_LSH = 5
CAND_LSC = 6
CAND_LOUT = 7
CAND_ROUT = 8
CAND_CAT_DIR = 9
CAND_COLS = 10            # + max_feature_bin cat-mask columns after these

# packed per-leaf forced-split candidate layout
FORCED_GAIN = 0
FORCED_THRESHOLD = 1
FORCED_DEFAULT_LEFT = 2
FORCED_LSG = 3
FORCED_LSH = 4
FORCED_LSC = 5
FORCED_LOUT = 6
FORCED_ROUT = 7
FORCED_COLS = 8

# the f32 prefix-sum order of XLA's CPU backend: 16-wide blocks summed
# left to right, plus the prefix sum (in the same order) of the earlier
# blocks' totals
_SCAN_BLOCK = 16


def _seq_cumsum(x: torch.Tensor) -> list:
    """Left-to-right f32 running sums along the last axis (a list of
    the per-position results)."""
    c = x[..., 0]
    out = [c]
    for i in range(1, x.shape[-1]):
        c = c + x[..., i]
        out.append(c)
    return out


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along the last axis in a fixed order:
    16-wide blocks summed left to right, each plus the exclusive prefix
    sum of the earlier blocks' totals, taken by this same rule.  This is
    the order the JAX package's ``jnp.cumsum`` takes on XLA's CPU
    backend at any length, so CPU runs match it bit for bit; torch.cumsum
    accumulates in another order (double on the CPU, a parallel scan on
    the card)."""
    B = x.shape[-1]
    nb = -(-B // _SCAN_BLOCK)
    pad = nb * _SCAN_BLOCK - B
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    xb = x.reshape(x.shape[:-1] + (nb, _SCAN_BLOCK))
    loc = torch.stack(_seq_cumsum(xb), dim=-1)                # (..., nb, 16)
    if nb > 1:
        tot = cumsum_f32(loc[..., -1])                        # (..., nb)
        exc = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]],
                        dim=-1)
        loc = loc + exc[..., None]
    return loc.reshape(x.shape)[..., :B]


#: XLA's CPU backend rewrites a reduction longer than this into a tree
#: of reductions over windows of this length
_REDUCE_WINDOW = 32


def sum_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 sum along the last axis in the order ``jnp.sum`` takes on
    XLA's CPU backend: up to 32 entries left to right from zero; a
    longer axis is padded with zeros evenly at both ends (the extra one
    at the end) to whole windows of 32, each window summed so, and the
    window totals summed by the same rule.  The same order on every
    device, so card and CPU runs agree bit for bit."""
    n = x.shape[-1]
    if n <= _REDUCE_WINDOW:
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n):
            acc = acc + x[..., i]
        return acc
    nw = -(-n // _REDUCE_WINDOW)
    pad = nw * _REDUCE_WINDOW - n
    x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    return sum_f32(sum_f32(x.reshape(x.shape[:-1]
                                     + (nw, _REDUCE_WINDOW))))


# ---------------------------------------------------------------------------
# Gain math (reference feature_histogram.hpp:439-501)
# ---------------------------------------------------------------------------
def threshold_l1(s, l1):
    reg = torch.clamp(s.abs() - l1, min=0.0)
    return torch.sign(s) * reg


def calculate_leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step):
    ret = -threshold_l1(sum_grad, l1) / (sum_hess + l2)
    if max_delta_step <= 0.0:
        return ret
    return torch.clamp(ret, -max_delta_step, max_delta_step)


def _leaf_output_constrained(sum_grad, sum_hess, l1, l2, max_delta_step,
                             min_c, max_c):
    ret = calculate_leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step)
    return torch.minimum(torch.maximum(ret, min_c), max_c)


def leaf_gain_given_output(sum_grad, sum_hess, l1, l2, output):
    """-(2 g out + (h + l2) out^2), rounded after every operation.  (XLA
    may contract the first product and the sum into an FMA, so gains
    can differ from the JAX package's in the last bit.)"""
    sg_l1 = threshold_l1(sum_grad, l1)
    return -(2.0 * sg_l1 * output + (sum_hess + l2) * output * output)


def leaf_split_gain(sum_grad, sum_hess, l1, l2, max_delta_step):
    out = calculate_leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step)
    return leaf_gain_given_output(sum_grad, sum_hess, l1, l2, out)


def split_gains(sl_g, sl_h, sr_g, sr_h, l1, l2, max_delta_step,
                min_c, max_c, monotone):
    """Gain of a candidate split; zero when it violates a monotone
    constraint (reference feature_histogram.hpp:454-467)."""
    lo = _leaf_output_constrained(sl_g, sl_h, l1, l2, max_delta_step,
                                  min_c, max_c)
    ro = _leaf_output_constrained(sr_g, sr_h, l1, l2, max_delta_step,
                                  min_c, max_c)
    gain = (leaf_gain_given_output(sl_g, sl_h, l1, l2, lo)
            + leaf_gain_given_output(sr_g, sr_h, l1, l2, ro))
    violates = ((monotone > 0) & (lo > ro)) | ((monotone < 0) & (lo < ro))
    return torch.where(violates, torch.zeros((), device=gain.device), gain)


class SplitResult(NamedTuple):
    """Best split per (leaf, feature) as a struct of (L, F) tensors."""
    gain: torch.Tensor
    threshold: torch.Tensor     # int32 numerical bin threshold
    default_left: torch.Tensor  # bool
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor
    cat_dir: torch.Tensor       # int32 (always 0 here)


def find_numerical_splits(hist, sum_grad, sum_hess, num_data, num_bin,
                          missing_type, default_bin, monotone, min_c,
                          max_c, cfg: Dict[str, float]) -> SplitResult:
    """Vectorized FindBestThresholdNumerical over every (leaf, feature).

    hist (L, F, B, 3) per-feature histograms; sum_grad/sum_hess/num_data
    (L,) leaf totals; num_bin/missing_type/default_bin/monotone (F,)
    metadata; min_c/max_c (L,) monotone output bounds."""
    L, F, B, _ = hist.shape
    dev = hist.device
    l1 = cfg["lambda_l1"]
    l2 = cfg["lambda_l2"]
    mds = cfg["max_delta_step"]
    min_data = cfg["min_data_in_leaf"]
    min_hess = cfg["min_sum_hessian_in_leaf"]
    min_gain = cfg["min_gain_to_split"]

    total_h = sum_hess + 2 * K_EPSILON                        # (L,)
    gain_shift = leaf_split_gain(sum_grad, total_h, l1, l2, mds)
    min_gain_shift = gain_shift + min_gain                    # (L,)

    bins = torch.arange(B, dtype=torch.int32, device=dev)
    is_default = bins[None, :] == default_bin[:, None]         # (F, B)
    is_nan_bin = bins[None, :] == (num_bin - 1)[:, None]       # (F, B)
    two_scan = (num_bin > 2) & (missing_type != MISSING_NONE)  # (F,)
    m_zero = missing_type == MISSING_ZERO
    m_nan = missing_type == MISSING_NAN
    no = torch.zeros_like(is_default)

    excl_a = torch.where(m_zero[:, None], is_default, no)
    excl_b = torch.where(m_zero[:, None], is_default,
                         torch.where((m_nan & two_scan)[:, None], is_nan_bin,
                                     no))
    keep_a = 1.0 - excl_a.to(torch.float32)
    keep_b = 1.0 - excl_b.to(torch.float32)
    # both scans' three channels in one prefix sum: (L, F, 6, B)
    h = hist.permute(0, 1, 3, 2)                              # (L, F, 3, B)
    cums = cumsum_f32(torch.cat([h * keep_a[None, :, None, :],
                                 h * keep_b[None, :, None, :]], dim=2))
    left_g_a = cums[:, :, 0]
    left_h_a = cums[:, :, 1] + K_EPSILON
    left_c_a = cums[:, :, 2]
    cum_g_b, cum_h_b, cum_c_b = cums[:, :, 3], cums[:, :, 4], cums[:, :, 5]

    # ---- scan A: default-right; only for two-scan features ----
    t_ok_a = bins[None, :] <= (num_bin - 2)[:, None]
    t_ok_a = t_ok_a & ~(m_zero[:, None] & is_default)
    t_ok_a = t_ok_a & two_scan[:, None]

    # ---- scan B: default-left ----
    right_g_b = cum_g_b[:, :, -1:] - cum_g_b
    right_h_b = cum_h_b[:, :, -1:] - cum_h_b + K_EPSILON
    right_c_b = cum_c_b[:, :, -1:] - cum_c_b
    left_g_b = sum_grad[:, None, None] - right_g_b
    left_h_b = total_h[:, None, None] - right_h_b
    left_c_b = num_data[:, None, None] - right_c_b
    last_b = torch.where(m_nan & two_scan, num_bin - 3, num_bin - 2)
    t_ok_b = bins[None, :] <= last_b[:, None]
    t_ok_b = t_ok_b & ~(m_zero[:, None]
                        & (bins[None, :] == (default_bin - 1)[:, None])
                        & (default_bin > 0)[:, None])

    neg_inf = torch.tensor(K_MIN_SCORE, device=dev)

    def candidate_gain(lg, lh, lc, t_ok):
        rg = sum_grad[:, None, None] - lg
        rh = total_h[:, None, None] - lh
        rc = num_data[:, None, None] - lc
        ok = (t_ok[None, :, :]
              & (lc >= min_data) & (rc >= min_data)
              & (lh >= min_hess) & (rh >= min_hess))
        g = split_gains(lg, lh, rg, rh, l1, l2, mds,
                        min_c[:, None, None], max_c[:, None, None],
                        monotone[None, :, None])
        return torch.where(ok & (g > min_gain_shift[:, None, None]), g,
                           neg_inf)

    gain_a = candidate_gain(left_g_a, left_h_a, left_c_a, t_ok_a)
    gain_b = candidate_gain(left_g_b, left_h_b, left_c_b, t_ok_b)

    # Selection order replicates the reference: the default-left scan
    # runs first and ties keep the first-seen maximum; within it larger
    # thresholds are seen first (right-to-left walk).
    all_gains = torch.cat([gain_b.flip(2), gain_a], dim=2)    # (L, F, 2B)
    best_gain = all_gains.amax(dim=2)
    best_idx = all_gains.argmax(dim=2)        # first maximum, like jnp
    from_b = best_idx < B
    thr = torch.where(from_b, B - 1 - best_idx, best_idx - B).to(torch.int32)
    oh_thr = bins[None, None, :] == thr.clamp(0, B - 1)[:, :, None]

    zero = torch.zeros((), device=dev)

    def pick(arr_a, arr_b):
        sel = torch.where(from_b[:, :, None], arr_b, arr_a)
        return torch.where(oh_thr, sel, zero).sum(dim=2)

    lg = pick(left_g_a, left_g_b)
    lh = pick(left_h_a, left_h_b)
    lc = pick(left_c_a, left_c_b)

    # two-bin NaN features force default-right (feature_histogram.hpp:100-103)
    force_right = (~two_scan & m_nan)[None, :]
    default_left = from_b & ~force_right

    valid = best_gain > K_MIN_SCORE
    final_gain = torch.where(valid, best_gain - min_gain_shift[:, None],
                             neg_inf)
    mc = min_c[:, None]
    xc = max_c[:, None]
    left_out = _leaf_output_constrained(lg, lh, l1, l2, mds, mc, xc)
    right_out = _leaf_output_constrained(sum_grad[:, None] - lg,
                                         total_h[:, None] - lh,
                                         l1, l2, mds, mc, xc)
    return SplitResult(
        gain=final_gain, threshold=thr, default_left=default_left,
        left_sum_grad=lg, left_sum_hess=lh - K_EPSILON, left_count=lc,
        left_output=left_out, right_output=right_out,
        cat_dir=torch.zeros_like(thr))


def _take(arr, idx):
    """``arr[..., idx]`` along the last axis for an index tensor of one
    fewer dimension (take_along_axis of one position)."""
    return torch.gather(arr, -1, idx[..., None].long())[..., 0]


def _group_chain(cs: torch.Tensor, base_ok: torch.Tensor,
                 min_data_per_group: float, steps: int) -> torch.Tensor:
    """The ``min_data_in_group`` chain along the last axis: a candidate
    is evaluated only when the count since the last evaluated candidate
    reaches ``min_data_per_group``.  Sequential over positions, one
    position at a time over the whole (..., B) batch; positions from
    ``steps`` on are never evaluated (the caller's ``base_ok`` is False
    there)."""
    cnt = torch.zeros(cs.shape[:-1], dtype=cs.dtype, device=cs.device)
    zero = torch.zeros((), dtype=cs.dtype, device=cs.device)
    # a position that may not be evaluated needs an infinite count
    need = torch.where(base_ok[..., :steps],
                       torch.tensor(min_data_per_group, dtype=cs.dtype,
                                    device=cs.device),
                       torch.tensor(math.inf, dtype=cs.dtype,
                                    device=cs.device))
    evals = []
    for i in range(steps):
        cnt = cnt + cs[..., i]
        e = cnt >= need[..., i]
        cnt = torch.where(e, zero, cnt)
        evals.append(e)
    out = torch.zeros_like(base_ok)
    if evals:
        out[..., :steps] = torch.stack(evals, dim=-1)
    return out


def _shift_used(arr: torch.Tensor, n_used: torch.Tensor) -> torch.Tensor:
    """Reverse the first n_used entries of each (l, f) row so a forward
    prefix scan over the result walks the sorted order from the back
    (the dir=-1 scan).  Entries past n_used are zero."""
    B = arr.shape[-1]
    pos = torch.arange(B, dtype=torch.int32, device=arr.device)
    idx = (n_used[..., None] - 1 - pos).expand(arr.shape)
    out = torch.gather(arr, -1, idx.clamp(0, B - 1).long())
    return torch.where(idx >= 0, out, torch.zeros((), device=arr.device))


def _cat_sort(h_g, h_h, h_c, in_range, cat_smooth):
    """The sorted mode's order: categories with at least ``cat_smooth``
    rows by ``g / (h + cat_smooth)`` ascending (stable, as jnp.argsort;
    a NaN key, an empty bin at ``cat_smooth=0``, sorts last in both
    libraries), the rest after them.  Returns (order, n_used)."""
    eligible = in_range & (h_c >= cat_smooth)
    score = h_g / (h_h + cat_smooth)
    key = torch.where(eligible, score,
                      torch.tensor(math.inf, device=score.device))
    order = torch.argsort(key, dim=-1, stable=True)
    return order, eligible.sum(dim=-1).to(torch.int32)


def find_categorical_splits(hist, sum_grad, sum_hess, num_data, num_bin,
                            missing_type, min_c, max_c,
                            cfg: Dict[str, float]) -> SplitResult:
    """Vectorized FindBestThresholdCategorical (reference
    feature_histogram.hpp:110-271) over every (leaf, feature) of
    ``hist`` (L, F, B, 3): one-hot splits for features of at most
    ``max_cat_to_onehot`` bins, otherwise categories sorted by
    grad/hess ratio and scanned from both ends.

    ``threshold`` in the result is the number of sorted categories going
    left minus one (one-hot: the single bin); ``cat_dir`` is +1/-1 for
    the scan direction (0 = one-hot).  :func:`build_cat_bitset` rebuilds
    the category set of the chosen feature."""
    L, F, B, _ = hist.shape
    dev = hist.device
    l1 = cfg["lambda_l1"]
    l2_base = cfg["lambda_l2"]
    mds = cfg["max_delta_step"]
    min_data = cfg["min_data_in_leaf"]
    min_hess = cfg["min_sum_hessian_in_leaf"]
    min_gain = cfg["min_gain_to_split"]
    cat_smooth = cfg["cat_smooth"]
    cat_l2 = cfg["cat_l2"]
    max_cat_threshold = int(cfg["max_cat_threshold"])
    max_cat_to_onehot = int(cfg["max_cat_to_onehot"])
    min_data_per_group = cfg["min_data_in_group"]

    total_h = sum_hess + 2 * K_EPSILON
    gain_shift = leaf_split_gain(sum_grad, total_h, l1, l2_base, mds)
    min_gain_shift = gain_shift + min_gain                    # (L,)
    mgs = min_gain_shift[:, None, None]
    neg_inf = torch.tensor(K_MIN_SCORE, device=dev)
    no_mono = torch.zeros((), dtype=torch.int32, device=dev)
    mc3 = min_c[:, None, None]
    xc3 = max_c[:, None, None]

    used_bin = num_bin - 1 + (missing_type == MISSING_NONE).to(torch.int32)
    bins = torch.arange(B, dtype=torch.int32, device=dev)
    in_range = bins[None, :] < used_bin[:, None]              # (F, B)
    h_g, h_h, h_c = hist[..., 0], hist[..., 1], hist[..., 2]

    # ---------------- one-hot mode ----------------
    lh1 = h_h + K_EPSILON
    rg1 = sum_grad[:, None, None] - h_g
    rh1 = total_h[:, None, None] - lh1
    rc1 = num_data[:, None, None] - h_c
    ok1 = (in_range[None] & (h_c >= min_data) & (rc1 >= min_data)
           & (h_h >= min_hess) & (rh1 >= min_hess))
    # the reference computes gain(other, this): the operand order is
    # kept (it matters only under monotone constraints, which
    # categorical features do not take)
    g1 = split_gains(rg1, rh1, h_g, lh1, l1, l2_base, mds, mc3, xc3,
                     no_mono)
    g1 = torch.where(ok1 & (g1 > mgs), g1, neg_inf)
    best1_t = g1.argmax(dim=2).to(torch.int32)
    best1_gain = _take(g1, best1_t)
    best1_lg = _take(h_g, best1_t)
    best1_lh = _take(lh1, best1_t)
    best1_lc = _take(h_c, best1_t)

    # ---------------- sorted mode ----------------
    l2s = l2_base + cat_l2
    order, n_used = _cat_sort(h_g, h_h, h_c, in_range[None], cat_smooth)
    sorted_hist = torch.gather(hist, 2, order[..., None].expand(-1, -1, -1,
                                                                 3))
    max_num_cat = torch.clamp((n_used + 1) // 2, max=max_cat_threshold)
    # both directions in one batch: (L, 2F, B), forward first
    fb = torch.cat([sorted_hist.permute(0, 1, 3, 2),
                    _shift_used(sorted_hist.permute(0, 1, 3, 2),
                                n_used[:, :, None])], dim=1)
    cum = cumsum_f32(fb)                                      # (L, 2F, 3, B)
    cum_g, cum_c = cum[:, :, 0], cum[:, :, 2]
    cum_h = cum[:, :, 1] + K_EPSILON
    mnc = torch.cat([max_num_cat, max_num_cat], dim=1)
    nu = torch.cat([n_used, n_used], dim=1)
    within = (bins < mnc[:, :, None]) & (bins < nu[:, :, None])
    rc = num_data[:, None, None] - cum_c
    rh = total_h[:, None, None] - cum_h
    base_ok = (within & (cum_c >= min_data) & (cum_h >= min_hess)
               & (rc >= min_data) & (rc >= min_data_per_group)
               & (rh >= min_hess))
    # no position past min(max_cat_threshold, ceil(B/2)) is ever within
    steps = min(B, max_cat_threshold, (B + 1) // 2)
    ok = _group_chain(fb[:, :, 2], base_ok, min_data_per_group, steps)
    rg = sum_grad[:, None, None] - cum_g
    g = split_gains(cum_g, cum_h, rg, rh, l1, l2s, mds, mc3, xc3, no_mono)
    g = torch.where(ok & (g > mgs), g, neg_inf)
    t2 = g.argmax(dim=2).to(torch.int32)                      # (L, 2F)
    g2 = _take(g, t2)
    lg2, lh2, lc2 = _take(cum_g, t2), _take(cum_h, t2), _take(cum_c, t2)
    gf, gb = g2[:, :F], g2[:, F:]
    use_fwd = gf >= gb

    def fwd_or_bwd(v):
        return torch.where(use_fwd, v[:, :F], v[:, F:])

    use_onehot = (num_bin <= max_cat_to_onehot)[None, :]      # (1, F)
    gain = torch.where(use_onehot, best1_gain, fwd_or_bwd(g2))
    # net gain (reference: output->gain = best_gain - min_gain_shift)
    gain = torch.where(gain > K_MIN_SCORE, gain - min_gain_shift[:, None],
                       neg_inf)
    thr = torch.where(use_onehot, best1_t, fwd_or_bwd(t2))
    lg = torch.where(use_onehot, best1_lg, fwd_or_bwd(lg2))
    lh = torch.where(use_onehot, best1_lh, fwd_or_bwd(lh2))
    lc = torch.where(use_onehot, best1_lc, fwd_or_bwd(lc2))
    one = torch.ones((), dtype=torch.int32, device=dev)
    cat_dir = torch.where(use_onehot, 0 * one,
                          torch.where(use_fwd, one, -one))

    # leaf outputs take the mode's l2 (plain for one-hot, + cat_l2 for
    # sorted: the reference's `l2` variable mutation)
    l2_eff = torch.where(use_onehot, torch.tensor(l2_base, device=dev),
                         torch.tensor(l2s, device=dev))
    mc = min_c[:, None]
    xc = max_c[:, None]
    left_out = _leaf_output_constrained(lg, lh, l1, l2_eff, mds, mc, xc)
    right_out = _leaf_output_constrained(sum_grad[:, None] - lg,
                                         total_h[:, None] - lh,
                                         l1, l2_eff, mds, mc, xc)
    return SplitResult(
        gain=gain, threshold=thr,
        default_left=torch.zeros_like(gain, dtype=torch.bool),
        left_sum_grad=lg, left_sum_hess=lh - K_EPSILON, left_count=lc,
        left_output=left_out, right_output=right_out, cat_dir=cat_dir)


def build_cat_bitset(hist_f, threshold, cat_dir, num_bin, missing_type,
                     cfg: Dict[str, float]) -> torch.Tensor:
    """The left-going category-bin mask of chosen categorical splits
    (reference feature_histogram.hpp:252-262): ``hist_f`` (L, B, 3) is
    each leaf's chosen feature's histogram, the rest (L,).  Returns (L,
    B) bool, True where the feature bin goes left."""
    L, B, _ = hist_f.shape
    dev = hist_f.device
    bins = torch.arange(B, dtype=torch.int32, device=dev)
    used_bin = num_bin - 1 + (missing_type == MISSING_NONE).to(torch.int32)
    in_range = bins[None, :] < used_bin[:, None]
    order, n_used = _cat_sort(hist_f[..., 0], hist_f[..., 1],
                              hist_f[..., 2], in_range, cfg["cat_smooth"])
    # sorted mode forward: the first threshold + 1 of the order;
    # backward: the last threshold + 1 of its n_used eligible entries
    k = threshold + 1
    fwd_sel = bins[None, :] < k[:, None]
    bwd_sel = ((bins[None, :] >= (n_used - k)[:, None])
               & (bins[None, :] < n_used[:, None]))
    sel = torch.where((cat_dir == 1)[:, None], fwd_sel,
                      (cat_dir == -1)[:, None] & bwd_sel)
    # selected sorted positions back to bin space
    sorted_mask = torch.zeros_like(sel).scatter_(1, order, sel)
    onehot_mask = bins[None, :] == threshold[:, None]
    return torch.where((cat_dir == 0)[:, None], onehot_mask, sorted_mask)


def gather_split_at_threshold(hist_f, threshold, sum_grad, sum_hess,
                              num_data, num_bin, missing_type, default_bin,
                              is_cat, cfg: Dict[str, float]):
    """Split info at a GIVEN (feature, threshold) per leaf: the forced-
    split evaluation (reference feature_histogram.hpp:273-413
    GatherInfoForThresholdNumerical/Categorical).

    Numerical: missing always rides left (``default_left=True``); the
    right side sums bins ``> threshold``, skipping the default bin for
    Zero-missing and the NaN bin otherwise.  Categorical: one-hot at the
    threshold bin.  A gain not above ``min_gain_shift`` is -inf (the
    forced split is then dropped).  ``hist_f`` (L, B, 3) holds each
    leaf's forced feature's histogram, the rest is (L,).  Returns (gain
    net of min_gain_shift, left_sum_grad, left_sum_hess, left_count,
    left_output, right_output, default_left), each (L,)."""
    L, B, _ = hist_f.shape
    dev = hist_f.device
    l1 = cfg["lambda_l1"]
    l2 = cfg["lambda_l2"]
    mds = cfg["max_delta_step"]
    min_gain = cfg["min_gain_to_split"]

    total_h = sum_hess + 2 * K_EPSILON
    gain_shift = leaf_split_gain(sum_grad, total_h, l1, l2, mds)
    min_gain_shift = gain_shift + min_gain

    bins = torch.arange(B, dtype=torch.int32, device=dev)

    # ---- numerical: right side = bins > threshold, minus skips ----
    m_zero = missing_type == MISSING_ZERO
    skip = torch.where(m_zero[:, None], bins[None, :] == default_bin[:, None],
                       bins[None, :] == (num_bin - 1)[:, None])
    right_sel = ((bins[None, :] > threshold[:, None])
                 & (bins[None, :] <= (num_bin - 1)[:, None]) & ~skip)
    # ---- categorical: one-hot at the threshold bin ----
    onehot = bins[None, :] == threshold[:, None]
    # both sides' three channels in one reduction: (L, 6)
    h = hist_f.permute(0, 2, 1)                               # (L, 3, B)
    sums = sum_f32(torch.cat([h * right_sel[:, None, :],
                              h * onehot[:, None, :]], dim=1))
    rg, rh, rc = sums[:, 0], sums[:, 1] + K_EPSILON, sums[:, 2]
    c_lg, c_lh, c_lc = sums[:, 3], sums[:, 4] + K_EPSILON, sums[:, 5]
    used_bin = num_bin - 1 + (missing_type == MISSING_NONE).to(torch.int32)
    cat_ok = threshold < used_bin

    lg = torch.where(is_cat, c_lg, sum_grad - rg)
    lh = torch.where(is_cat, c_lh, total_h - rh)
    lc = torch.where(is_cat, c_lc, num_data - rc)
    rg2 = sum_grad - lg
    rh2 = total_h - lh
    gain = (leaf_split_gain(lg, lh, l1, l2, mds)
            + leaf_split_gain(rg2, rh2, l1, l2, mds))
    ok = (gain > min_gain_shift) & ~torch.isnan(gain) & (~is_cat | cat_ok)
    gain = torch.where(ok, gain - min_gain_shift,
                       torch.tensor(K_MIN_SCORE, device=dev))
    left_out = calculate_leaf_output(lg, lh, l1, l2, mds)
    right_out = calculate_leaf_output(rg2, rh2, l1, l2, mds)
    return (gain, lg, lh - K_EPSILON, lc, left_out, right_out, ~is_cat)


def run_split_finders(hist, sum_grad, sum_hess, count, min_c, max_c,
                      cfg, f_num_bin, f_missing, f_default_bin, f_monotone,
                      f_is_cat, feature_mask, has_categorical: bool,
                      cat_idx):
    """Per-(leaf-row, feature) finder pass: the numerical finder, the
    categorical finder's results in the categorical features' columns,
    and the feature-mask gain fill.  Returns (res, gains).

    The JAX package runs the categorical finder over all F features and
    keeps its columns where ``f_is_cat`` (a ``where``); each column is
    computed on its own, so running it on the categorical features
    alone (``cat_idx``, the indices where ``f_is_cat``) and scattering
    the results gives the same values."""
    res = find_numerical_splits(
        hist, sum_grad, sum_hess, count, f_num_bin, f_missing,
        f_default_bin, f_monotone, min_c, max_c, cfg)
    if has_categorical:
        cat_idx = cat_idx.long()
        cat_res = find_categorical_splits(
            hist.index_select(1, cat_idx), sum_grad, sum_hess, count,
            f_num_bin[cat_idx], f_missing[cat_idx], min_c, max_c, cfg)
        res = SplitResult(*[n.index_copy(1, cat_idx, c.to(n.dtype))
                            for c, n in zip(cat_res, res)])
    gains = torch.where(feature_mask[None, :], res.gain,
                        torch.tensor(K_MIN_SCORE, device=hist.device))
    return res, gains


def find_best_split_block(feat_hist, sum_grad, sum_hess, count, min_c,
                          max_c, cfg, f_num_bin, f_missing, f_default_bin,
                          f_monotone, f_is_cat, feature_mask,
                          has_categorical: bool,
                          cat_idx) -> torch.Tensor:
    """Best split per frontier leaf as one packed (W, CAND_COLS + B)
    candidate block (column layout CAND_*; the last B columns hold the
    chosen categorical split's left bin mask)."""
    W, F, B, _ = feat_hist.shape
    dev = feat_hist.device
    res, gains = run_split_finders(
        feat_hist, sum_grad, sum_hess, count, min_c, max_c, cfg,
        f_num_bin, f_missing, f_default_bin, f_monotone, f_is_cat,
        feature_mask, has_categorical, cat_idx)
    best_gain = gains.amax(dim=1)
    best_fc = gains.argmax(dim=1).to(torch.int32)
    payload = torch.stack(
        [res.threshold.to(torch.float32),
         res.default_left.to(torch.float32),
         res.left_sum_grad, res.left_sum_hess, res.left_count,
         res.left_output, res.right_output,
         res.cat_dir.to(torch.float32)], dim=2)               # (W, F, 8)
    oh = (torch.arange(F, dtype=torch.int32, device=dev)[None, :]
          == best_fc[:, None])
    sel = torch.where(oh[:, :, None], payload,
                      torch.zeros((), device=dev)).sum(dim=1)
    if has_categorical:
        bf = best_fc.long()
        hist_chosen = feat_hist[torch.arange(W, device=dev), bf]
        cat_mask = build_cat_bitset(
            hist_chosen, sel[:, 0].to(torch.int32),
            sel[:, 7].to(torch.int32), f_num_bin[bf], f_missing[bf],
            cfg).to(torch.float32)
    else:
        cat_mask = torch.zeros((W, B), dtype=torch.float32, device=dev)
    return torch.cat([best_gain[:, None],
                      best_fc.to(torch.float32)[:, None], sel, cat_mask],
                     dim=1)


def forced_split_block(feat_hist, spec, forced_feature, forced_thr,
                       sum_grad, sum_hess, count, f_num_bin, f_missing,
                       f_default_bin, f_is_cat,
                       cfg: Dict[str, float]) -> torch.Tensor:
    """Forced-split evaluation of the frontier as one packed (W,
    FORCED_COLS) block: :func:`gather_split_at_threshold` per leaf at
    its spec node's (feature, threshold); rows with no spec get -inf
    gain.  ``spec`` is the (W,) forced-spec index (-1 = none);
    ``forced_feature``/``forced_thr`` the flat spec arrays."""
    n_spec = forced_feature.shape[0]
    s_node = spec.clamp(0, n_spec - 1).long()
    ff = forced_feature[s_node].long()
    ft = forced_thr[s_node]
    W = feat_hist.shape[0]
    hist_ff = feat_hist[torch.arange(W, device=feat_hist.device), ff]
    (fgain, flg, flh, flc, flo, fro, fdl) = gather_split_at_threshold(
        hist_ff, ft, sum_grad, sum_hess, count, f_num_bin[ff],
        f_missing[ff], f_default_bin[ff], f_is_cat[ff], cfg)
    fgain = torch.where(spec >= 0, fgain,
                        torch.tensor(K_MIN_SCORE, device=fgain.device))
    return torch.stack(
        [fgain, ft.to(torch.float32), fdl.to(torch.float32),
         flg, flh, flc, flo, fro], dim=1)
