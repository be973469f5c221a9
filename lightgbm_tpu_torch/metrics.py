"""Evaluation metrics, computed on the training device.

Port of lightgbm_tpu/metrics.py: the regression metrics (l2, rmse, l1,
quantile, huber, fair, poisson, mape, gamma, gamma-deviance, tweedie),
the binary ones (binary_logloss, binary_error, auc), the multiclass
ones (multi_logloss, multi_error), the cross-entropies
(cross_entropy, cross_entropy_lambda, kldiv) and the ranking ones
(ndcg and map at each ``ndcg_eval_at``, over query groups), with the
registry's aliases and each objective's default metric.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import Config
from .dataset import Metadata
from .objectives import log2_xla, rank_layout, rdiv
from .ops.split import sum_f32
from .utils.log import Log


class Metric:
    name = "metric"
    bigger_is_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device) -> None:
        self.num_data = num_data
        self.label = torch.from_numpy(
            metadata.label[:num_data].astype(np.float32)).to(device)
        w = metadata.weight
        self.weight = (None if w is None else torch.from_numpy(
            w[:num_data].astype(np.float32)).to(device))
        self.sum_weight = (float(num_data) if w is None
                           else float(np.sum(w[:num_data])))

    def names(self) -> List[str]:
        return [self.name]

    def eval(self, score: torch.Tensor, objective=None) -> List[float]:
        raise NotImplementedError

    def _avg(self, loss: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            return loss.sum() / self.sum_weight
        return (loss * self.weight).sum() / self.sum_weight


class _PointwiseMetric(Metric):
    """Analog of RegressionMetric<T> (regression_metric.hpp:16-106):
    the objective's output transform is applied when there is one."""

    def loss(self, label, pred):
        raise NotImplementedError

    def finalize(self, avg_loss):
        return avg_loss

    def eval(self, score, objective=None):
        pred = score if objective is None else objective.convert_output(score)
        return [float(self.finalize(self._avg(self.loss(self.label, pred))))]


class L2Metric(_PointwiseMetric):
    name = "l2"

    def loss(self, label, pred):
        return (pred - label) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def finalize(self, avg_loss):
        return torch.sqrt(avg_loss)


class L1Metric(_PointwiseMetric):
    name = "l1"

    def loss(self, label, pred):
        return (pred - label).abs()


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def loss(self, label, pred):
        delta = label - pred
        return torch.where(delta < 0, (self.config.alpha - 1.0) * delta,
                           self.config.alpha * delta)


class HuberMetric(_PointwiseMetric):
    name = "huber"

    def loss(self, label, pred):
        a = self.config.alpha
        diff = pred - label
        return torch.where(diff.abs() <= a, 0.5 * diff * diff,
                           a * (diff.abs() - 0.5 * a))


class FairMetric(_PointwiseMetric):
    name = "fair"

    def loss(self, label, pred):
        c = self.config.fair_c
        x = (pred - label).abs()
        return c * x - c * c * torch.log1p(x / c)


class PoissonMetric(_PointwiseMetric):
    name = "poisson"

    def loss(self, label, pred):
        pred = torch.clamp(pred, min=1e-10)
        return pred - label * torch.log(pred)


class MAPEMetric(_PointwiseMetric):
    name = "mape"

    def loss(self, label, pred):
        return (label - pred).abs() / torch.clamp(label.abs(), min=1.0)


class GammaMetric(_PointwiseMetric):
    """reference regression_metric.hpp:245-261: negative gamma
    log-likelihood with unit shape (lgamma(1/psi) = 0)."""
    name = "gamma"

    def loss(self, label, pred):
        psi = 1.0
        theta = rdiv(-1.0, torch.clamp(pred, min=1e-10))
        b = -torch.log(-theta)
        c = 1.0 / psi * torch.log(label / psi) - torch.log(label)
        return -((label * theta - b) / psi + c)


class GammaDevianceMetric(_PointwiseMetric):
    name = "gamma-deviance"

    def loss(self, label, pred):
        tmp = label / torch.clamp(pred, min=1e-10)
        return tmp - torch.log(tmp) - 1.0

    def finalize(self, avg_loss):
        # the reference returns sum * 2 (no weight normalization)
        return avg_loss * self.sum_weight * 2.0


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def loss(self, label, pred):
        rho = self.config.tweedie_variance_power
        pred = torch.clamp(pred, min=1e-10)
        a = label * torch.exp((1 - rho) * torch.log(pred)) / (1 - rho)
        b = torch.exp((2 - rho) * torch.log(pred)) / (2 - rho)
        return -a + b


class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def loss(self, label, prob):
        p = prob.clamp(1e-15, 1 - 1e-15)
        return torch.where(label > 0, -torch.log(p), -torch.log(1 - p))


class BinaryErrorMetric(_PointwiseMetric):
    name = "binary_error"

    def loss(self, label, prob):
        return ((label > 0) != (prob > 0.5)).to(torch.float32)


class AUCMetric(Metric):
    """Tie-aware AUC (reference binary_metric.hpp:157-260): sum over
    distinct-score groups of neg_w * (pos_w/2 + pos_before)."""
    name = "auc"
    bigger_is_better = True

    def eval(self, score, objective=None):
        w = (torch.ones_like(self.label) if self.weight is None
             else self.weight)
        order = torch.argsort(-score, stable=True)
        s = score[order]
        lab = self.label[order]
        ww = w[order]
        zero = torch.zeros((), device=s.device)
        pos = torch.where(lab > 0, ww, zero)
        neg = torch.where(lab <= 0, ww, zero)
        changed = torch.cat([torch.zeros(1, dtype=torch.bool,
                                         device=s.device), s[1:] != s[:-1]])
        gid = torch.cumsum(changed.to(torch.int64), 0)
        n = s.shape[0]
        seg_pos = torch.zeros(n, device=s.device).index_add_(0, gid, pos)
        seg_neg = torch.zeros(n, device=s.device).index_add_(0, gid, neg)
        pos_before = torch.cat([zero[None], torch.cumsum(seg_pos, 0)[:-1]])
        accum = (seg_neg * (seg_pos * 0.5 + pos_before)).sum()
        sum_pos = pos.sum()
        denom = sum_pos * (self.sum_weight - sum_pos)
        return [float(accum / denom) if float(denom) > 0 else 1.0]


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, score, objective=None):
        # score: (N, K) raw, through the objective's transform (softmax
        # without one)
        p = (torch.softmax(score, dim=1) if objective is None
             else objective.convert_output(score))
        pt = p.gather(1, self.label.to(torch.int64)[:, None])[:, 0]
        loss = -torch.log(torch.clamp(pt, min=1e-15))
        return [float(self._avg(loss))]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score, objective=None):
        pred = torch.argmax(score, dim=1)
        wrong = (pred != self.label.to(torch.int64)).to(torch.float32)
        return [float(self._avg(wrong))]


class CrossEntropyMetric(_PointwiseMetric):
    name = "cross_entropy"

    def loss(self, label, prob):
        p = prob.clamp(1e-15, 1 - 1e-15)
        return -(label * torch.log(p) + (1 - label) * torch.log(1 - p))


class CrossEntropyLambdaMetric(Metric):
    """reference xentropy_metric.hpp xentlambda: loss on the hhat scale."""
    name = "cross_entropy_lambda"

    def eval(self, score, objective=None):
        hhat = torch.log1p(torch.exp(score))
        w = torch.ones_like(score) if self.weight is None else self.weight
        z = (1.0 - torch.exp(-w * hhat)).clamp(1e-15, 1 - 1e-15)
        loss = -(self.label * torch.log(z)
                 + (1 - self.label) * torch.log(1 - z))
        return [float(loss.sum() / self.sum_weight)]


class KLDivMetric(Metric):
    """reference xentropy_metric.hpp kldiv: cross-entropy minus the
    label entropy."""
    name = "kldiv"

    def eval(self, score, objective=None):
        p = torch.sigmoid(score).clamp(1e-15, 1 - 1e-15)
        y = self.label.clamp(0.0, 1.0)
        ye = torch.where((y > 0) & (y < 1),
                         y * torch.log(y) + (1 - y) * torch.log(1 - y),
                         torch.zeros((), device=y.device))
        ce = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        return [float(self._avg(ce + ye))]


class _RankMetric(Metric):
    """The padded (queries, M) layout NDCG and MAP share (lightgbm_tpu/
    metrics.py:281-306; reference rank_metric.hpp, dcg_calculator.cpp).
    Queries weigh equally.  Sums follow XLA's CPU order (``sum_f32``)."""

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        qb = metadata.query_boundaries
        if qb is None:
            Log.fatal(f"The {self.name} metric requires query information")
        idx = rank_layout(qb)
        self.num_queries = idx.shape[0]
        valid = idx >= 0
        self._safe_idx = torch.from_numpy(np.maximum(idx, 0)).to(device)
        self._qmask = torch.from_numpy(valid).to(device)
        lab = metadata.label[np.maximum(idx, 0)] * valid
        self._qlabel = torch.from_numpy(lab.astype(np.float32)).to(device)
        self._qweight = torch.ones(self.num_queries, dtype=torch.float32,
                                   device=device)
        self.eval_at = tuple(int(k) for k in self.config.ndcg_eval_at)

    def names(self):
        return [f"{self.name}@{k}" for k in self.eval_at]

    def _sorted_by_score(self, score, values):
        """``values`` (Q, M) in each query's descending-score order
        (stable)."""
        ps = score[self._safe_idx]
        s = torch.where(self._qmask, ps, torch.full_like(ps, float("-inf")))
        order = torch.argsort(-s, dim=1, stable=True)
        return torch.take_along_dim(values, order, dim=1)

    def _mean_over_queries(self, per_query) -> float:
        return float(sum_f32(per_query * self._qweight)
                     / sum_f32(self._qweight))


class NDCGMetric(_RankMetric):
    name = "ndcg"
    bigger_is_better = True

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        label_gain = self.config.label_gain
        if not label_gain:
            label_gain = tuple(float(2 ** i - 1) for i in range(31))
        self._gain = torch.from_numpy(
            np.asarray(label_gain, dtype=np.float32)).to(device)

    def eval(self, score, objective=None):
        qmask = self._qmask
        lab = self._qlabel.to(torch.int32).clamp(min=0).long()
        gains = self._gain[lab] * qmask
        sorted_gain = self._sorted_by_score(score, gains)
        ideal_gain = -torch.sort(-gains, dim=1).values
        M = gains.shape[1]
        discount = rdiv(1.0, log2_xla(2.0 + torch.arange(
            M, dtype=torch.float32, device=gains.device)))
        out = []
        for k in self.eval_at:
            kk = min(k, M)
            dcg = sum_f32(sorted_gain[:, :kk] * discount[None, :kk])
            maxdcg = sum_f32(ideal_gain[:, :kk] * discount[None, :kk])
            ndcg = torch.where(maxdcg > 0, dcg / maxdcg,
                               torch.ones_like(dcg))
            out.append(self._mean_over_queries(ndcg))
        return out


class MAPMetric(_RankMetric):
    name = "map"
    bigger_is_better = True

    def eval(self, score, objective=None):
        rel = (self._qlabel > 0) & self._qmask
        rel_sorted = self._sorted_by_score(score, rel)
        M = rel.shape[1]
        cum_rel = torch.cumsum(rel_sorted.to(torch.float32), dim=1)
        prec = cum_rel / torch.arange(1, M + 1, dtype=torch.float32,
                                      device=rel.device)[None, :]
        n_rel = rel.sum(dim=1).to(torch.float32)
        out = []
        for k in self.eval_at:
            kk = min(k, M)
            ap_num = sum_f32(torch.where(rel_sorted[:, :kk], prec[:, :kk],
                                         torch.zeros_like(prec[:, :kk])))
            denom = torch.clamp(n_rel, max=float(kk))
            ap = torch.where(denom > 0, ap_num / denom,
                             torch.zeros_like(ap_num))
            out.append(self._mean_over_queries(ap))
        return out


_METRIC_REGISTRY = {
    "l2": L2Metric, "mse": L2Metric, "mean_squared_error": L2Metric,
    "regression": L2Metric,
    "rmse": RMSEMetric, "root_mean_squared_error": RMSEMetric,
    "l2_root": RMSEMetric,
    "l1": L1Metric, "mae": L1Metric, "mean_absolute_error": L1Metric,
    "regression_l1": L1Metric,
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "mape": MAPEMetric, "mean_absolute_percentage_error": MAPEMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "gamma-deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "cross_entropy": CrossEntropyMetric, "xentropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "xentlambda": CrossEntropyLambdaMetric,
    "kldiv": KLDivMetric, "kullback_leibler": KLDivMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric,
    "map": MAPMetric, "mean_average_precision": MAPMetric,
}

DEFAULT_METRIC_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss", "multiclass": "multi_logloss",
    "multiclassova": "multi_logloss", "lambdarank": "ndcg",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
}


def create_metrics(config: Config,
                   names: Optional[Sequence[str]] = None) -> List[Metric]:
    """Factory (reference metric.cpp:11-53): the metrics named in the
    config, or the objective's default metric when none is."""
    names = list(names if names is not None else config.metric)
    if not names:
        default = DEFAULT_METRIC_FOR_OBJECTIVE.get(config.objective)
        names = [default] if default else []
    out = []
    for nm in names:
        nm = nm.strip().lower()
        if nm in ("", "none", "null", "na"):
            continue
        cls = _METRIC_REGISTRY.get(nm)
        if cls is None:
            Log.warning(f"Unknown metric {nm}, ignored")
            continue
        out.append(cls(config))
    return out
