"""Faults planted in the program under test, for the check's own tests
and for the readings that its limits are set from (``calibrate.py``).
Each is a context manager that patches the program in this process:

- ``unchanged``: a boosting step returns its training state unchanged
  (the scores are restored after every iteration);
- ``half``: half of the rows are left out of every step (their
  gradients and hessians zeroed), the leaf values the mean over the rest;
- ``alter``: an answer altered where it is produced (a trained tree's
  first leaf value moved by 0.05; a scoring call's first score by 0.01);
- ``halve``: trees grown to half the configuration's ``num_leaves``
  (255 -> 127);
- ``order``: the grower's rounds that the leaf budget or the frontier
  width binds split the leaves whose best splits gain least, not most.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def plant(fault: str):
    if fault == "unchanged":
        from lightgbm_tpu_torch.boosting.gbdt import GBDT

        def make(orig):
            def train_one_iter(self, *a, **k):
                before = self.scores.clone()
                out = orig(self, *a, **k)
                self.scores.copy_(before)
                return out
            return train_one_iter
        return _patched(GBDT, "train_one_iter", make)
    if fault == "half":
        from lightgbm_tpu_torch.boosting.gbdt import GBDT

        def make(orig):
            def _gradients(self, *a, **k):
                g, h = orig(self, *a, **k)
                import torch
                keep = (torch.arange(g.shape[-1], device=g.device) % 2
                        == 0).to(g.dtype)
                return g * keep, h * keep
            return _gradients
        return _patched(GBDT, "_gradients", make)
    if fault == "alter":
        stack = contextlib.ExitStack()
        from lightgbm_tpu_torch.booster import Booster
        from lightgbm_tpu_torch.tree import Tree

        def make_tree(orig):
            def apply_shrinkage(self, rate):
                orig(self, rate)
                self.leaf_value[0] += 0.05
            return apply_shrinkage

        def make_predict(orig):
            def predict(self, *a, **k):
                out = orig(self, *a, **k)
                out[0] += 0.01
                return out
            return predict
        stack.enter_context(_patched(Tree, "apply_shrinkage", make_tree))
        stack.enter_context(_patched(Booster, "predict", make_predict))
        return stack
    if fault == "halve":
        import lightgbm_tpu_torch as lgb

        def make(orig):
            def train(params, *a, **k):
                params = dict(params)
                params["num_leaves"] = max(2, int(params["num_leaves"]) // 2)
                return orig(params, *a, **k)
            return train
        return _patched(lgb, "train", make)
    if fault == "order":
        import torch
        from lightgbm_tpu_torch.learner import grower

        class Torch:
            """torch, but for the sort that ranks the grower's
            candidates by gain: the finite gains go ascending."""

            def __getattr__(self, name):
                return getattr(torch, name)

            @staticmethod
            def sort(key, *a, **k):
                return torch.sort(torch.where(torch.isfinite(key), -key,
                                              key), *a, **k)
        return _patched(grower, "torch", lambda orig: Torch())
    raise ValueError(f"unknown fault {fault!r}")
