"""Plain reference of the objectives' gradients, in float64.

binary (LightGBM v2.1 BinaryLogloss, sigmoid 1, labels 0/1, no start
score): with s = +1 for a positive row and -1 for a negative one,
r = -s / (1 + exp(s * score)), the gradient is r and the hessian
|r| (1 - |r|).

lambdarank (LightGBM v2.1 LambdarankNDCG, rank_objective.hpp:19-200,
label gain 2^l - 1, no truncation): in each query the documents are
ranked by descending score (ties by position); every pair (i, j) with
label_i > label_j gets

    delta = (gain_i - gain_j) |1/log2(2 + rank_i) - 1/log2(2 + rank_j)|
            / maxDCG@max_position,  divided by (0.01 + |s_i - s_j|)
            when the query's scores are not all equal,
    p     = 2 / (1 + exp(2 sigma (s_i - s_j))),
    lambda_i -= p delta, lambda_j += p delta,
    hess_i, hess_j += 2 p (2 - p) delta.
"""
from __future__ import annotations

import numpy as np
import torch


def binary_gradients(score: torch.Tensor, label: torch.Tensor):
    s = torch.where(label > 0, 1.0, -1.0).to(torch.float64)
    r = -s / (1.0 + torch.exp(s * score.to(torch.float64)))
    a = r.abs()
    return r, a * (1.0 - a)


def _inv_max_dcg(label: np.ndarray, sizes: np.ndarray, k: int,
                 gain: np.ndarray) -> np.ndarray:
    out = np.zeros(len(sizes))
    start = 0
    for q, n in enumerate(sizes):
        lab = np.sort(label[start:start + n])[::-1][:k].astype(np.int64)
        start += n
        dcg = float(np.sum(gain[lab] / np.log2(np.arange(2, len(lab) + 2))))
        out[q] = 1.0 / dcg if dcg > 0 else 0.0
    return out


class Lambdarank:
    """Pairwise lambdas of one fixed set of queries; ``gradients(score)``
    gives (grad, hess) in float64 on the scores' device."""

    def __init__(self, label: np.ndarray, sizes: np.ndarray, device,
                 max_position: int = 20, sigmoid: float = 1.0,
                 pair_budget: int = 1 << 26):
        self.sigmoid = sigmoid
        gain = 2.0 ** np.arange(31) - 1.0
        sizes = np.asarray(sizes, dtype=np.int64)
        Q, M = len(sizes), int(sizes.max())
        starts = np.r_[0, np.cumsum(sizes)[:-1]]
        slot = np.arange(M)[None, :]
        valid = slot < sizes[:, None]
        self.index = torch.as_tensor(np.where(valid, starts[:, None] + slot,
                                              0), device=device)
        self.valid = torch.as_tensor(valid, device=device)
        lab = np.where(valid, label[np.where(valid, starts[:, None] + slot,
                                             0)], 0).astype(np.int64)
        self.gain = torch.as_tensor(gain[lab], device=device)
        self.label = torch.as_tensor(lab, device=device)
        self.inv = torch.as_tensor(_inv_max_dcg(label, sizes, max_position,
                                                gain), device=device)
        self.chunk = max(1, pair_budget // (M * M))
        self.n = int(sizes.sum())

    def gradients(self, score: torch.Tensor):
        score = score.to(torch.float64)
        g = torch.zeros(self.n, dtype=torch.float64, device=score.device)
        h = torch.zeros_like(g)
        for a in range(0, self.index.shape[0], self.chunk):
            b = a + self.chunk
            idx, ok = self.index[a:b], self.valid[a:b]
            s = torch.where(ok, score[idx], -torch.inf)
            order = torch.argsort(-s, dim=1, stable=True)
            rank = torch.argsort(order, dim=1).to(torch.float64)
            disc = 1.0 / torch.log2(2.0 + rank)
            lab, gain = self.label[a:b], self.gain[a:b]
            pair = (lab[:, :, None] > lab[:, None, :]) \
                & ok[:, :, None] & ok[:, None, :]
            sv = torch.where(ok, s, 0.0)
            spread = (torch.where(ok, s, -torch.inf).amax(1)
                      != torch.where(ok, s, torch.inf).amin(1))
            ds = sv[:, :, None] - sv[:, None, :]
            delta = (gain[:, :, None] - gain[:, None, :]) \
                * (disc[:, :, None] - disc[:, None, :]).abs() \
                * self.inv[a:b, None, None]
            delta = torch.where(spread[:, None, None],
                                delta / (0.01 + ds.abs()), delta)
            p = 2.0 / (1.0 + torch.exp(2.0 * self.sigmoid
                                       * torch.where(pair, ds, 0.0)))
            lam = torch.where(pair, p * delta, 0.0)
            hes = torch.where(pair, 2.0 * p * (2.0 - p) * delta, 0.0)
            gq = lam.sum(1) - lam.sum(2)
            hq = hes.sum(1) + hes.sum(2)
            g.index_put_((idx[ok],), gq[ok])
            h.index_put_((idx[ok],), hq[ok])
        return g, h
