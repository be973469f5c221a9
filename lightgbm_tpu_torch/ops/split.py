"""Best-split search over histograms, vectorized across (leaf, feature,
bin).

Port of the numerical half of lightgbm_tpu/ops/split.py: every (leaf,
feature, threshold, direction) candidate is scored at once with
cumulative sums and masks.  Missing handling:
  * MissingType::None  — single default-left scan over all thresholds.
  * MissingType::Zero  — two scans with the default(zero) bin excluded
    from directional accumulation (zeros ride the default direction).
  * MissingType::NaN   — two scans; the NaN bin (last) is excluded from
    the default-left accumulation and rides the default direction.

Categorical finders are not ported yet (the grower refuses categorical
features); the route kernels already honour categorical bitsets.
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


def run_split_finders(hist, sum_grad, sum_hess, count, min_c, max_c,
                      cfg, f_num_bin, f_missing, f_default_bin, f_monotone,
                      f_is_cat, feature_mask, has_categorical: bool):
    """Per-(leaf-row, feature) finder pass: the numerical finder and the
    feature-mask gain fill.  Returns (res, gains)."""
    if has_categorical:
        raise NotImplementedError(
            "categorical split finding is not ported yet")
    res = find_numerical_splits(
        hist, sum_grad, sum_hess, count, f_num_bin, f_missing,
        f_default_bin, f_monotone, min_c, max_c, cfg)
    gains = torch.where(feature_mask[None, :], res.gain,
                        torch.tensor(K_MIN_SCORE, device=hist.device))
    return res, gains


def find_best_split_block(feat_hist, sum_grad, sum_hess, count, min_c,
                          max_c, cfg, f_num_bin, f_missing, f_default_bin,
                          f_monotone, f_is_cat, feature_mask,
                          has_categorical: bool) -> torch.Tensor:
    """Best split per frontier leaf as one packed (W, CAND_COLS + B)
    candidate block (column layout CAND_*)."""
    W, F, B, _ = feat_hist.shape
    res, gains = run_split_finders(
        feat_hist, sum_grad, sum_hess, count, min_c, max_c, cfg,
        f_num_bin, f_missing, f_default_bin, f_monotone, f_is_cat,
        feature_mask, has_categorical)
    best_gain = gains.amax(dim=1)
    best_fc = gains.argmax(dim=1).to(torch.int32)
    payload = torch.stack(
        [res.threshold.to(torch.float32),
         res.default_left.to(torch.float32),
         res.left_sum_grad, res.left_sum_hess, res.left_count,
         res.left_output, res.right_output,
         res.cat_dir.to(torch.float32)], dim=2)               # (W, F, 8)
    oh = (torch.arange(F, dtype=torch.int32, device=feat_hist.device)[None, :]
          == best_fc[:, None])
    sel = torch.where(oh[:, :, None], payload,
                      torch.zeros((), device=payload.device)).sum(dim=1)
    cat_mask = torch.zeros((W, B), dtype=torch.float32,
                           device=feat_hist.device)
    return torch.cat([best_gain[:, None],
                      best_fc.to(torch.float32)[:, None], sel, cat_mask],
                     dim=1)
