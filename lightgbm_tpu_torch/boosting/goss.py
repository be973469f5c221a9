"""GOSS: Gradient-based One-Side Sampling.

Port of lightgbm_tpu/boosting/goss.py (reference src/boosting/
goss.hpp:88-145): keep the ``top_rate`` share of rows with the largest
|g*h|, keep each other row with probability other_k / rest, and
amplify the kept rest by (n - top_k) / other_k.  No sampling for the
first 1/learning_rate iterations.  The objective path draws from the
iteration key, the custom-gradient path from its own stream seeded
``bagging_seed + 1``.
"""
from __future__ import annotations

import torch

from ..config import Config
from ..dataset import Dataset
from ..utils import prng
from .gbdt import GBDT


class GOSS(GBDT):
    def __init__(self, config: Config, train_set: Dataset, **kwargs):
        super().__init__(config, train_set, **kwargs)
        if self._mh:
            raise NotImplementedError(
                "boosting=goss on the device plane (a multi-process "
                "row-sharded dataset): its top-rate cut needs a top-k "
                "across the ranks' gradients, not ported yet "
                "(ROADMAP.md queue 1); use boosting=gbdt or the tcp "
                "plane")
        self._goss_key = prng.PRNGKey(config.bagging_seed + 1)

    def _bagging_counts(self, iteration: int):
        # GOSS replaces bagging (reference goss.hpp Bagging)
        return self._full_counts

    def _use_bagging_fused(self) -> bool:
        return False

    def _sample_active(self) -> bool:
        return self.iter_ >= int(1.0 / self.config.learning_rate)

    def _sample_rows(self, g, h, counts):
        if not self._sample_active():
            return g, h, counts
        self._goss_key, sub = prng.split(self._goss_key)
        return self._goss_sample(g, h, counts, sub)

    def _sample_rows_fused(self, g, h, counts, key):
        return self._goss_sample(g, h, counts, key)

    def _goss_sample(self, g, h, counts, key):
        """(g, h, counts) of the sample: the top rows by the class sum
        of |g*h| (ties at the k-th score all kept, as ``>=`` against
        ``lax.top_k``'s k-th value keeps them), a Bernoulli share of
        the rest, amplified."""
        n_real = self.num_data
        in_bag = counts > 0
        score = (g * h).abs().sum(dim=0)
        score = torch.where(in_bag, score,
                            torch.full_like(score, float("-inf")))
        top_k = max(1, int(n_real * self.config.top_rate))
        other_k = max(1, int(n_real * self.config.other_rate))
        kth = torch.topk(score, top_k, sorted=True).values[-1]
        is_top = score >= kth
        rest = in_bag & ~is_top
        rest_cnt = rest.sum().clamp(min=1).to(torch.float32)
        prob = torch.tensor(float(other_k), dtype=torch.float32,
                            device=score.device) / rest_cnt
        u = prng.uniform(key, score.shape, score.device)
        sampled = rest & (u < prob)
        multiply = (n_real - top_k) / other_k
        scale = torch.where(sampled, torch.full_like(score, multiply),
                            torch.ones_like(score))[None, :]
        new_counts = torch.where(is_top | sampled, counts,
                                 torch.zeros_like(counts))
        return g * scale, h * scale, new_counts
