#!/usr/bin/env python3
"""Classify a split that differs between lightgbm_tpu_torch and
lightgbm_tpu: the first iteration of a 3-class model on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_near_tie.py [--seed S] [--rows N]

The rows are tests/test_torch_objectives_train.py's (``_data`` and its
3-class label), the parameters the defaults but the quantized plan
(``quantized_grad``, bfloat16 histograms).  For the first trees of
classes 0 and 1 it prints

* whether the port's tree equals the JAX grower's run op by op
  (``jax.disable_jit()``) on the same gradients, bit for bit;
* where the JAX package's compiled ``lgb.train`` tree first differs
  from the port's: the first node whose split gain differs (both
  values) and the first node whose structure differs.

Runs on the CPU only; needs both packages (and about a minute).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PARAMS = {"quantized_grad": True, "hist_compute_dtype": "bfloat16",
          "objective": "multiclass", "num_class": 3, "verbose": -1}
FIELDS = ("leaf_value", "leaf_count", "node_feature", "node_threshold",
          "node_gain", "node_left", "node_right")


def data(seed: int, n: int):
    """tests/test_torch_objectives_train.py ``_data`` and its 3-class
    label."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n, 6) < 0.03] = np.nan
    Z = np.nan_to_num(X)
    z = Z[:, 0] - 0.5 * Z[:, 1] + 0.5 * np.sin(2 * Z[:, 2]) \
        + 0.3 * rng.randn(n)
    return X, np.digitize(z, [-0.6, 0.6]).astype(float)


def first(mask) -> str:
    idx = np.nonzero(mask)[0]
    return str(int(idx[0])) if idx.size else "none"


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=4000)
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    import torch

    import lightgbm_tpu as jlgb
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu.learner.grower import TreeGrower as JGrower
    from lightgbm_tpu_torch.learner import grower as TG

    X, y = data(args.seed, args.rows)
    calls = []
    real = TG.TreeGrower.train_tree

    def record(self, g, h, c, fm):
        calls.append((g.clone(), h.clone(), c.clone(), fm.clone()))
        return real(self, g, h, c, fm)

    TG.TreeGrower.train_tree = record
    tb = tlgb.train(dict(PARAMS, device="cpu"), tlgb.Dataset(X, label=y), 1,
                    verbose_eval=False, keep_training_booster=True)
    TG.TreeGrower.train_tree = real
    jb = jlgb.train(dict(PARAMS, force_pallas_interpret=True),
                    jlgb.Dataset(X, label=y), 1)
    jcore = jlgb.Dataset(X, label=y).construct(
        jlgb.Config.from_params(PARAMS))
    jg = JGrower(jcore, jlgb.Config.from_params(
        dict(PARAMS, force_pallas_interpret=True)))
    for k in (0, 1):
        g, h, c, fm = calls[k]
        with jax.disable_jit():
            jt, jl, _ = jg.train_tree(*(jnp.asarray(t.numpy())
                                        for t in (g, h, c, fm)))
        tt, tl, _ = real(tb.gbdt.grower, g, h, c, fm)
        differ = [f for f in FIELDS if not np.array_equal(
            np.asarray(getattr(jt, f)), tt[f].numpy())]
        if not np.array_equal(np.asarray(jl), tl.numpy()):
            differ.append("leaf ids")
        print(f"class {k}: port against the JAX grower op by op: "
              + ("equal bit for bit" if not differ
                 else f"differ in {differ}"))
        cj, cp = jb.models[k], tb.models[k]
        gi = first(cj.split_gain != cp.split_gain)
        gains = ("" if gi == "none" else
                 f" ({cj.split_gain[int(gi)]:.10g} compiled, "
                 f"{cp.split_gain[int(gi)]:.10g} port)")
        struct = np.zeros(len(cp.split_feature), bool)
        for f in ("split_feature", "threshold", "left_child",
                  "right_child", "internal_count"):
            struct |= getattr(cj, f) != getattr(cp, f)
        print(f"class {k}: compiled JAX against the port: first split gain "
              f"that differs at node {gi}{gains}; first structure that "
              f"differs at node {first(struct)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
