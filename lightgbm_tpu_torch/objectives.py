"""Objective functions: gradients, hessians and output transforms.

Port of lightgbm_tpu/objectives.py: the regression family (L2 with and
without ``reg_sqrt``, L1, huber, fair, poisson, quantile, MAPE, gamma,
tweedie), binary, multiclass (softmax and one-vs-all) and the two
cross-entropies, and lambdarank over query groups.  Each objective is
torch ops on the training device; a multiclass objective takes and
returns (N, K).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata
from .utils.log import Log


def _percentile(values: np.ndarray, alpha: float) -> float:
    """LightGBM's PercentileFun (reference utils/common.h): index
    interpolation at alpha*(n-1) over sorted values."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    n = len(v)
    if n == 0:
        return 0.0
    if n == 1:
        return float(v[0])
    pos = alpha * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(v[lo] * (1 - frac) + v[hi] * frac)


def _weighted_percentile(values: np.ndarray, weights: np.ndarray,
                         alpha: float) -> float:
    """Weighted percentile matching WeightedPercentileFun (reference
    utils/common.h): walk the sorted values accumulating weights (each
    counted at its midpoint) until alpha * total is reached,
    interpolating between neighbours."""
    v = np.asarray(values, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    order = np.argsort(v)
    v, w = v[order], w[order]
    n = len(v)
    if n == 0:
        return 0.0
    if n == 1:
        return float(v[0])
    cum = np.cumsum(w) - w / 2.0
    threshold = alpha * w.sum()
    idx = int(np.searchsorted(cum, threshold, side="left"))
    if idx <= 0:
        return float(v[0])
    if idx >= n:
        return float(v[-1])
    t = (threshold - cum[idx - 1]) / max(cum[idx] - cum[idx - 1], 1e-30)
    return float(v[idx - 1] * (1 - t) + v[idx] * t)


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as XLA computes it: the scalar rounded to f32, then
    one division (torch's ``scalar / tensor`` multiplies by the
    reciprocal instead, off by an ulp)."""
    return torch.full_like(t, num) / t


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Row softmax in jax.nn.softmax's order: exp(x - max) over its sum."""
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


class Objective:
    """Base objective (reference objective_function.h:13-80)."""

    name = "none"
    is_constant_hessian = False
    is_renew_tree_output = False
    renew_alpha = 0.5  # percentile for renew-tree-output objectives

    def __init__(self, config: Config):
        self.config = config
        self.num_class = 1

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device) -> None:
        self.num_data = num_data
        self.device = device
        self.label = metadata.label[:num_data].astype(np.float32)
        self.weight = (None if metadata.weight is None
                       else metadata.weight[:num_data].astype(np.float32))
        self._label_dev = self._dev(self.label)
        self._weight_dev = (None if self.weight is None
                            else self._dev(self.weight))

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def repad_device_arrays(self, pad_place) -> None:
        """Multi-host layout fixup (JAX objectives.py:117-129): every
        device tensor with a leading dimension of ``num_data`` rows (the
        label, the weights and each objective's own per-row arrays) is
        re-laid as this rank's block of the per-rank-padded global
        layout.  Host-side statistics (label means, class counts) were
        computed from the unpadded global metadata in init().
        ``pad_place(np_arr) -> tensor``."""
        for name, val in list(self.__dict__.items()):
            if isinstance(val, torch.Tensor) and val.dim() >= 1 \
                    and val.shape[0] == self.num_data:
                self.__dict__[name] = pad_place(val.cpu().numpy())

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """score: (N,) raw scores, or (N, K) for a multiclass objective."""
        raise NotImplementedError

    def boost_from_score(self) -> float:
        return 0.0

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw score -> output space."""
        return raw

    def _apply_weight(self, grad, hess):
        if self._weight_dev is None:
            return grad, hess
        return grad * self._weight_dev, hess * self._weight_dev

    def _apply_row_weight(self, grad, hess):
        """(N, K) gradients times each row's weight."""
        if self._weight_dev is None:
            return grad, hess
        w = self._weight_dev[:, None]
        return grad * w, hess * w


class RegressionL2(Objective):
    """reference regression_objective.hpp:64-174"""
    name = "regression"
    is_constant_hessian = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = config.reg_sqrt

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.sqrt:
            self.label = (np.sign(self.label)
                          * np.sqrt(np.abs(self.label))).astype(np.float32)
            self._label_dev = self._dev(self.label)
        self.is_constant_hessian = self.weight is None

    def get_gradients(self, score):
        grad = score - self._label_dev
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        if self.weight is not None:
            return float(np.average(self.label, weights=self.weight))
        return float(np.mean(self.label))

    def convert_output(self, raw):
        if self.sqrt:
            return torch.sign(raw) * raw * raw
        return raw


class RegressionL1(RegressionL2):
    """reference regression_objective.hpp:175-260; constant hessian with
    median leaf refitting."""
    name = "regression_l1"
    is_renew_tree_output = True
    renew_alpha = 0.5

    def get_gradients(self, score):
        grad = torch.sign(score - self._label_dev)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        if self.weight is not None:
            return _weighted_percentile(self.label, self.weight, 0.5)
        return _percentile(self.label, 0.5)


class RegressionHuber(RegressionL2):
    """reference regression_objective.hpp:261-315"""
    name = "huber"
    is_constant_hessian = False

    def get_gradients(self, score):
        a = self.config.alpha
        diff = score - self._label_dev
        grad = torch.where(diff.abs() <= a, diff, torch.sign(diff) * a)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)


class RegressionFair(RegressionL2):
    """reference regression_objective.hpp:316-363"""
    name = "fair"
    is_constant_hessian = False

    def get_gradients(self, score):
        c = self.config.fair_c
        x = score - self._label_dev
        denom = x.abs() + c
        grad = c * x / denom
        hess = rdiv(c * c, denom * denom)
        return self._apply_weight(grad, hess)


class RegressionPoisson(RegressionL2):
    """reference regression_objective.hpp:364-444: log-link,
    loss = exp(f) - label*f."""
    name = "poisson"
    is_constant_hessian = False

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if np.min(self.label) < 0:
            Log.fatal(f"[{self.name}]: at least one target label is negative")
        if np.sum(self.label) == 0:
            Log.fatal(f"[{self.name}]: sum of labels is zero")

    def get_gradients(self, score):
        grad = torch.exp(score) - self._label_dev
        hess = torch.exp(score + self.config.poisson_max_delta_step)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        return math.log(max(RegressionL2.boost_from_score(self), 1e-30))

    def convert_output(self, raw):
        return torch.exp(raw)


class RegressionQuantile(RegressionL2):
    """reference regression_objective.hpp:445-543"""
    name = "quantile"
    is_renew_tree_output = True

    def __init__(self, config):
        super().__init__(config)
        if not (0 < config.alpha < 1):
            Log.fatal("alpha must be in (0, 1) for quantile objective")
        self.renew_alpha = config.alpha

    def get_gradients(self, score):
        a = self.config.alpha
        delta = score - self._label_dev
        grad = torch.where(delta >= 0, 1.0 - a, -a)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        if self.weight is not None:
            return _weighted_percentile(self.label, self.weight,
                                        self.config.alpha)
        return _percentile(self.label, self.config.alpha)


class RegressionMAPE(RegressionL1):
    """reference regression_objective.hpp:544-644: sign gradient scaled
    by 1/max(1,|label|)."""
    name = "mape"
    is_constant_hessian = True
    is_renew_tree_output = True
    renew_alpha = 0.5

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if np.any(np.abs(self.label) < 1):
            Log.warning("Met 'abs(label) < 1', will convert them to '1' in "
                        "Mape objective and metric.")
        lw = 1.0 / np.maximum(1.0, np.abs(self.label))
        if self.weight is not None:
            lw = lw * self.weight
        self.label_weight = lw.astype(np.float32)
        self._label_weight_dev = self._dev(self.label_weight)

    def get_gradients(self, score):
        diff = score - self._label_dev
        grad = torch.sign(diff) * self._label_weight_dev
        hess = (torch.ones_like(score) if self._weight_dev is None
                else self._weight_dev)
        return grad, hess

    def boost_from_score(self):
        return _weighted_percentile(self.label, self.label_weight, 0.5)


class RegressionGamma(RegressionPoisson):
    """reference regression_objective.hpp:645-681"""
    name = "gamma"

    def get_gradients(self, score):
        ratio = self._label_dev / torch.exp(score)
        if self._weight_dev is not None:
            # the reference applies the weight inside the ratio term only
            grad = 1.0 - ratio * self._weight_dev
            hess = ratio * self._weight_dev
        else:
            grad = 1.0 - ratio
            hess = ratio
        return grad, hess


class RegressionTweedie(RegressionPoisson):
    """reference regression_objective.hpp:682+"""
    name = "tweedie"

    def get_gradients(self, score):
        rho = self.config.tweedie_variance_power
        e1 = torch.exp((1 - rho) * score)
        e2 = torch.exp((2 - rho) * score)
        grad = -self._label_dev * e1 + e2
        hess = -self._label_dev * (1 - rho) * e1 + (2 - rho) * e2
        return self._apply_weight(grad, hess)


class BinaryLogloss(Objective):
    """reference binary_objective.hpp:13-155: labels mapped to +-1,
    is_unbalance / scale_pos_weight class weighting."""
    name = "binary"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        if self.sigmoid <= 0:
            Log.fatal(f"Sigmoid parameter {self.sigmoid} should be greater "
                      "than zero")
        if config.is_unbalance and abs(config.scale_pos_weight - 1.0) > 1e-6:
            Log.fatal("Cannot set is_unbalance and scale_pos_weight at the "
                      "same time")

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        is_pos = self.label > 0
        cnt_pos = int(is_pos.sum())
        cnt_neg = num_data - cnt_pos
        if cnt_pos == 0 or cnt_neg == 0:
            Log.warning("Only contain one class.")
        Log.info(f"Number of positive: {cnt_pos}, number of negative: "
                 f"{cnt_neg}")
        w_pos, w_neg = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.config.scale_pos_weight
        self._sign = self._dev(
            np.where(is_pos, 1.0, -1.0).astype(np.float32))
        self._lw = self._dev(
            np.where(is_pos, w_pos, w_neg).astype(np.float32))

    def get_gradients(self, score):
        s = self.sigmoid
        response = -self._sign * s / (1.0 + torch.exp(self._sign * s * score))
        abs_r = response.abs()
        grad = response * self._lw
        hess = abs_r * (s - abs_r) * self._lw
        return self._apply_weight(grad, hess)

    def convert_output(self, raw):
        return rdiv(1.0, 1.0 + torch.exp(-self.sigmoid * raw))


class MulticlassSoftmax(Objective):
    """reference multiclass_objective.hpp:16-138: K trees an iteration."""
    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        li = self.label.astype(np.int32)
        if li.min() < 0 or li.max() >= self.num_class:
            Log.fatal(f"Label must be in [0, {self.num_class})")
        self._onehot = self._dev(
            (li[:, None] == np.arange(self.num_class)[None, :])
            .astype(np.float32))

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def get_gradients(self, score):
        # score: (N, K)
        p = _softmax(score)
        grad = p - self._onehot
        hess = 2.0 * p * (1.0 - p)
        return self._apply_row_weight(grad, hess)

    def convert_output(self, raw):
        return _softmax(raw)


class MulticlassOVA(Objective):
    """reference multiclass_objective.hpp:139+: K independent binary
    losses."""
    name = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class
        self.sigmoid = config.sigmoid

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        li = self.label.astype(np.int32)
        self._sign = self._dev(
            np.where(li[:, None] == np.arange(self.num_class)[None, :],
                     1.0, -1.0).astype(np.float32))

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def get_gradients(self, score):
        s = self.sigmoid
        response = -self._sign * s / (1.0 + torch.exp(self._sign * s * score))
        abs_r = response.abs()
        return self._apply_row_weight(response, abs_r * (s - abs_r))

    def convert_output(self, raw):
        return rdiv(1.0, 1.0 + torch.exp(-self.sigmoid * raw))


class CrossEntropy(Objective):
    """reference xentropy_objective.hpp:39-141: probabilistic labels."""
    name = "cross_entropy"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.label.min() < 0 or self.label.max() > 1:
            Log.fatal("[cross_entropy]: labels must be in [0, 1]")

    def get_gradients(self, score):
        z = torch.sigmoid(score)
        grad = z - self._label_dev
        hess = z * (1.0 - z)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        if self.weight is not None:
            pavg = float(np.average(self.label, weights=self.weight))
        else:
            pavg = float(np.mean(self.label))
        pavg = min(max(pavg, 1e-15), 1 - 1e-15)
        score = math.log(pavg / (1 - pavg))
        Log.info(f"[{self.name}]: pavg={pavg:f} -> initscore={score:f}")
        return score

    def convert_output(self, raw):
        return torch.sigmoid(raw)


class CrossEntropyLambda(Objective):
    """reference xentropy_objective.hpp:142-250: alternative
    parameterization with a weight-dependent link."""
    name = "cross_entropy_lambda"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.label.min() < 0 or self.label.max() > 1:
            Log.fatal("[cross_entropy_lambda]: labels must be in [0, 1]")

    def get_gradients(self, score):
        if self._weight_dev is None:
            z = torch.sigmoid(score)
            grad = z - self._label_dev
            hess = z * (1.0 - z)
            return grad, hess
        w = self._weight_dev
        y = self._label_dev
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = rdiv(1.0, epf)
        grad = (1.0 - y / torch.clamp(z, min=1e-30)) * w / (1.0 + enf)
        c = rdiv(1.0, 1.0 - torch.clamp(z, max=1 - 1e-30))
        d = 1.0 + epf
        a = w * epf / (d * d)
        hess = c * (a + (w / d) ** 2 * (z - y) * c
                    * torch.exp(-w * hhat))  # the reference's expansion
        return grad, hess

    def boost_from_score(self):
        if self.weight is not None:
            havg = float(np.average(self.label, weights=self.weight))
        else:
            havg = float(np.mean(self.label))
        score = math.log(max(math.exp(havg) - 1.0, 1e-15))
        Log.info(f"[{self.name}]: havg={havg:f} -> initscore={score:f}")
        return score

    def convert_output(self, raw):
        return torch.log1p(torch.exp(raw))


def rank_layout(query_boundaries: np.ndarray, q_multiple: int = 1
                ) -> np.ndarray:
    """The (q_pad, M) row index of each query's documents, -1 past a
    query's end and in the padding queries (q_pad a multiple of
    ``q_multiple``).  Queries are consecutive row ranges, so the valid
    slots in row-major order are the rows 0..N-1 in order."""
    qb = np.asarray(query_boundaries, dtype=np.int64)
    sizes = np.diff(qb)
    Q, M = len(sizes), int(sizes.max())
    q_pad = -(-Q // q_multiple) * q_multiple
    idx = np.full((q_pad, M), -1, dtype=np.int64)
    pos = np.arange(M)[None, :]
    idx[:Q] = np.where(pos < sizes[:, None], qb[:-1, None] + pos, -1)
    return idx


def log2_xla(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2``: the natural log over log(2), as XLA computes it."""
    return torch.log(x) / torch.log(torch.full_like(x, 2.0))


def pair_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A query chunk's (qc, M, M) pair terms summed over ``dim``: torch's
    own order, within an ulp or two of XLA's (``ops/split.py sum_f32``
    follows XLA's CPU order, and the lambdarank tests substitute it)."""
    return x.sum(dim)


class LambdarankNDCG(Objective):
    """Pairwise lambdas weighted by |delta NDCG| (lightgbm_tpu/
    objectives.py:617-785; reference rank_objective.hpp:19-200), on a
    padded (queries, M) layout in query chunks that bound the (qc, M, M)
    pair tensors to 2^25 entries each.

    The JAX package moves scores and lambdas between the flat rows and
    the padded layout with banded one-hot matmuls, a TPU workaround for
    slow gathers whose result is an exact permutation (each row has one
    padded slot); here both directions are index gathers."""
    name = "lambdarank"
    need_accurate_prediction = False
    # pairwise lambdas are long-tailed: round-to-nearest int8 zeroes
    # most of them, so the quantized path rounds stochastically
    need_stochastic_quant = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        if self.sigmoid <= 0:
            Log.fatal("Sigmoid param should be greater than zero")
        label_gain = config.label_gain
        if not label_gain:
            label_gain = tuple(float(2 ** i - 1) for i in range(31))
        self.label_gain = np.asarray(label_gain, dtype=np.float64)
        self.optimize_pos_at = config.max_position

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        qb = metadata.query_boundaries
        if qb is None:
            Log.fatal("Lambdarank tasks require query information")
        if np.any(self.label < 0) or \
                int(self.label.max()) >= len(self.label_gain):
            Log.fatal("Label exceeds label_gain range in lambdarank")
        sizes = np.diff(qb)
        Q, M = len(sizes), int(sizes.max())
        self.num_queries, self.max_query = Q, M
        qc = max(1, min(Q, (1 << 25) // max(M * M, 1)))
        self._q_chunk = qc
        idx = rank_layout(qb, qc)
        valid = idx >= 0
        safe = np.maximum(idx, 0)
        # inverse max DCG at max_position, in f64 then f32 (reference
        # dcg_calculator.cpp)
        inv = np.zeros(idx.shape[0], dtype=np.float64)
        for q in range(Q):
            lab = np.sort(self.label[qb[q]:qb[q + 1]])[::-1]
            k = min(self.optimize_pos_at, len(lab))
            dcg = float(np.sum(self.label_gain[lab[:k].astype(np.int32)]
                               / np.log2(np.arange(2, k + 2))))
            inv[q] = 1.0 / dcg if dcg > 0 else 0.0
        self._inv_max_dcg = self._dev(inv.astype(np.float32))
        self._label_gain_dev = self._dev(self.label_gain.astype(np.float32))
        self._safe_idx = self._dev(safe)
        self._qmask = self._dev(valid)
        # the flat index of each row's padded slot
        self._slot = self._dev(np.flatnonzero(valid.reshape(-1)))
        self._qlabel = self._dev(self.label[safe].astype(np.float32)
                                 * valid)
        self._qweight = (None if self.weight is None else self._dev(
            self.weight[safe].astype(np.float32) * valid))

    def _padded_scores(self, score: torch.Tensor) -> torch.Tensor:
        """(N,) scores -> (q_pad, M), -inf outside the queries."""
        ps = score[self._safe_idx]
        return torch.where(self._qmask, ps,
                           torch.full_like(ps, float("-inf")))

    def _chunk_lambdas(self, s, mask, qlabel, inv):
        """(g, h) of one chunk of padded queries (qc, M)."""
        sig = self.sigmoid
        labels = qlabel.to(torch.int32)
        gains = self._label_gain_dev[labels.clamp(min=0).long()]
        # rank positions (descending score, stable)
        order = torch.argsort(-s, dim=1, stable=True)
        rank = torch.argsort(order, dim=1)
        discount = rdiv(1.0, log2_xla(2.0 + rank.to(torch.float32)))
        inf = torch.full_like(s, float("inf"))
        best = torch.where(mask, s, -inf).amax(dim=1, keepdim=True)
        worst = torch.where(mask, s, inf).amin(dim=1, keepdim=True)
        has_spread = (best != worst)[:, :, None]
        del inf
        # pairs (qc, M, M): i the higher label, j the lower
        pair_ok = (labels[:, :, None] > labels[:, None, :]) \
            & mask[:, :, None] & mask[:, None, :]
        ds = s[:, :, None] - s[:, None, :]
        delta = (gains[:, :, None] - gains[:, None, :]) \
            * (discount[:, :, None] - discount[:, None, :]).abs() \
            * inv[:, None, None]
        delta = torch.where(has_spread, delta / (0.01 + ds.abs()), delta)
        ds = torch.where(pair_ok, ds, torch.zeros((), device=s.device))
        p_lambda = rdiv(2.0, 1.0 + torch.exp(2.0 * ds * sig))
        del ds
        zero = torch.zeros((), device=s.device)
        lam = torch.where(pair_ok, -p_lambda * delta, zero)
        hes = torch.where(pair_ok,
                          2.0 * (p_lambda * (2.0 - p_lambda)) * delta, zero)
        del p_lambda, delta, pair_ok
        # the higher document gets +lambda, the lower -lambda; the
        # hessian adds on both
        g = pair_sum(lam, 2) - pair_sum(lam, 1)
        h = pair_sum(hes, 2) + pair_sum(hes, 1)
        return g, h

    def get_gradients(self, score):
        qc = self._q_chunk
        ps = self._padded_scores(score)
        g_all = torch.empty_like(ps)
        h_all = torch.empty_like(ps)
        for a in range(0, ps.shape[0], qc):
            b = a + qc
            g, h = self._chunk_lambdas(ps[a:b], self._qmask[a:b],
                                       self._qlabel[a:b],
                                       self._inv_max_dcg[a:b])
            if self._qweight is not None:
                g = g * self._qweight[a:b]
                h = h * self._qweight[a:b]
            g_all[a:b] = g
            h_all[a:b] = h
        # padded slots -> flat rows (+0.0: the JAX package's one-hot
        # products turn a -0.0 lambda into +0.0)
        grad = g_all.reshape(-1)[self._slot] + 0.0
        hess = h_all.reshape(-1)[self._slot] + 0.0
        return grad, hess


_OBJECTIVE_REGISTRY = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}


def create_objective(config: Config) -> Optional[Objective]:
    """Factory (reference objective_function.cpp:10-80); None for
    ``objective=none`` (custom gradients only)."""
    if config.objective == "none":
        return None
    cls = _OBJECTIVE_REGISTRY.get(config.objective)
    if cls is None:
        Log.fatal(f"Unknown objective type name: {config.objective}")
    return cls(config)
