"""Plain reference of the value-to-bin step for dense numerical columns.

LightGBM's bin finding (src/io/bin.cpp:73-390 and the row sample of
src/io/dataset_loader.cpp:649-754, v2.1): sample ``bin_construct_sample_cnt``
rows without replacement, collect each column's non-zero values, merge
values within one ulp, and place count-balanced upper bounds with
GreedyFindBin on each side of zero, zero owning one bin.  A value's bin is
the first upper bound at or above it.

Written from that description for NaN-free dense columns, in NumPy on the
host (the bounds) and PyTorch (the bin matrix).  Nothing here is imported
from the program under test.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

K_ZERO_THRESHOLD = 1e-35


def _up(a: float) -> float:
    return math.nextafter(a, math.inf)


def sample_rows(num_data: int, sample_cnt: int, seed: int,
                ranks: int = 1) -> np.ndarray:
    """Row indices of the bin-finding sample.  With ``ranks`` > 1 the
    rows are ``ranks`` equal blocks, one a process, and each block gives
    its own sample of ``sample_cnt // ranks`` rows, drawn with the seed
    ``seed + 7919 * rank``, in block order."""
    if ranks > 1:
        per = num_data // ranks
        return np.concatenate([
            r * per + sample_rows(per, max(1, sample_cnt // ranks),
                                  seed + 7919 * r)
            for r in range(ranks)])
    if num_data <= sample_cnt:
        return np.arange(num_data)
    idx = np.random.RandomState(seed).choice(num_data, size=sample_cnt,
                                             replace=False)
    idx.sort()
    return idx


def distinct_counts(values: np.ndarray, zero_cnt: int):
    """Sorted distinct values with counts: a value within one ulp above
    its predecessor joins the predecessor's run, and a run stands for its
    last (largest) value; the implicit zeros enter at their place when no
    value is zero."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if len(v) == 0:
        return np.array([0.0]), np.array([zero_cnt], dtype=np.int64)
    starts = np.flatnonzero(np.r_[True, v[1:] > np.nextafter(v[:-1],
                                                             math.inf)])
    ends = np.r_[starts[1:], len(v)]
    dist = v[ends - 1]
    cnt = (ends - starts).astype(np.int64)
    if zero_cnt > 0:
        k = int(np.searchsorted(dist, 0.0))
        if dist[0] > 0.0 or dist[-1] < 0.0 or (
                0 < k < len(dist) and dist[k - 1] < 0.0 < dist[k]):
            dist = np.insert(dist, k, 0.0)
            cnt = np.insert(cnt, k, zero_cnt)
    return dist, cnt


def greedy_bounds(dv: np.ndarray, cnt: np.ndarray, max_bin: int,
                  total: int, min_data_in_bin: int) -> List[float]:
    """GreedyFindBin (bin.cpp:73-150): ascending upper bounds, +inf last.

    The scalar walk closes a bin at the first distinct value j that is
    big (count >= the mean bin size), or that brings the bin's count to
    the mean, or that precedes a big value with the bin at half the
    mean; the mean is renewed over the values left after each bin that
    a small value closed.  Each such j is found by bisection on the
    running counts instead of value by value."""
    n = len(dv)
    bounds: List[float] = []
    if n <= max_bin:
        cur = 0
        for i in range(n - 1):
            cur += int(cnt[i])
            if cur >= min_data_in_bin:
                val = _up((float(dv[i]) + float(dv[i + 1])) / 2.0)
                if not bounds or val > _up(bounds[-1]):
                    bounds.append(val)
                    cur = 0
        bounds.append(math.inf)
        return bounds
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total // min_data_in_bin))
    mean = total / max_bin
    big = cnt >= mean
    rest_bins = max_bin - int(big.sum())
    rest_total = total - int(cnt[big].sum())
    mean = rest_total / max(rest_bins, 1)
    run = np.cumsum(cnt)
    small_run = np.cumsum(np.where(big, 0, cnt))
    big_at = np.flatnonzero(big)
    uppers: List[float] = []
    lowers: List[float] = [float(dv[0])]
    i = 0
    while i < n - 1 and len(uppers) < max_bin - 1:
        base = int(run[i - 1]) if i > 0 else 0
        b = np.searchsorted(big_at, i)
        j_big = int(big_at[b]) if b < len(big_at) else n
        j_mean = int(np.searchsorted(run, base + mean))
        half = int(np.searchsorted(run, base + max(1.0, mean * 0.5)))
        b = np.searchsorted(big_at, max(i, half) + 1)
        j_half = int(big_at[b]) - 1 if b < len(big_at) else n
        j = max(i, min(j_big, j_mean, j_half))
        if j >= n - 1:
            break
        uppers.append(float(dv[j]))
        lowers.append(float(dv[j + 1]))
        if not big[j]:
            rest_bins -= 1
            mean = (rest_total - int(small_run[j])) / max(rest_bins, 1)
        i = j + 1
    for k in range(len(uppers)):
        val = _up((uppers[k] + lowers[k + 1]) / 2.0)
        if not bounds or val > _up(bounds[-1]):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def zero_split_bounds(dv: np.ndarray, cnt: np.ndarray, max_bin: int,
                      total: int, min_data_in_bin: int) -> List[float]:
    """FindBinWithZeroAsOneBin (bin.cpp:151-206): the negative and the
    positive side binned apart, (-eps, eps] one bin."""
    left = dv <= -K_ZERO_THRESHOLD
    right = dv > K_ZERO_THRESHOLD
    zero_cnt = int(cnt[~left & ~right].sum())
    bounds: List[float] = []
    n_left = int(left.sum())
    if n_left > 0:
        left_cnt = int(cnt[left].sum())
        left_bins = max(1, int(left_cnt / max(total - zero_cnt, 1)
                               * (max_bin - 1)))
        bounds = greedy_bounds(dv[:n_left], cnt[:n_left], left_bins,
                               left_cnt, min_data_in_bin)
        bounds[-1] = -K_ZERO_THRESHOLD
    if right.any():
        start = int(np.argmax(right))
        right_bins = max_bin - 1 - len(bounds)
        rb = greedy_bounds(dv[start:], cnt[start:], right_bins,
                           int(cnt[right].sum()), min_data_in_bin)
        bounds.append(K_ZERO_THRESHOLD)
        bounds.extend(rb)
    else:
        bounds.append(math.inf)
    return bounds


def bin_bounds(X: np.ndarray, max_bin: int, min_data_in_bin: int,
               sample_cnt: int, seed: int,
               ranks: int = 1) -> List[np.ndarray]:
    """Each column's upper bounds (float64, +inf last) for NaN-free X."""
    idx = sample_rows(X.shape[0], sample_cnt, seed, ranks)
    sample = X[idx]
    total = sample.shape[0]
    out = []
    for j in range(X.shape[1]):
        col = sample[:, j]
        if np.isnan(col).any():
            raise ValueError("the reference bins NaN-free columns only")
        nz = col[np.abs(col) > K_ZERO_THRESHOLD]
        dv, cnt = distinct_counts(nz, total - len(nz))
        out.append(np.asarray(zero_split_bounds(dv, cnt, max_bin, total,
                                                min_data_in_bin)))
    return out


def bin_matrix(X: torch.Tensor, bounds: List[np.ndarray]) -> torch.Tensor:
    """(N, F) uint8 bins on X's device: the first upper bound >= x."""
    cols = []
    for j, b in enumerate(bounds):
        ub = torch.as_tensor(b[:-1], dtype=torch.float64, device=X.device)
        cols.append(torch.searchsorted(ub, X[:, j].to(torch.float64).
                                       contiguous()).to(torch.uint8))
    return torch.stack(cols, dim=1)
