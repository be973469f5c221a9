#!/usr/bin/env python3
"""chip_smoke.py's phase 19 (the C embedding of the C API and its C, JNI
and R hosts; GOSS on the device plane and ranks of several cards) alone,
on the visible CUDA cards.

    python3 scripts/torch_capi_check.py [--rows N]

Builds kernels A, B and C, makes chip_smoke.py's bench rows (make_data,
1,000,000 x 28 by default, and 200,000 held-out rows), trains phase 3's
main path once (fused_tiled, 10 trees, the held-out rows as a
validation set) for its model text and launch counts, predicts the
held-out rows as phase 4 does, and runs ``check_capi`` ((a) the library
in this process against that text and those predictions, (b) the C
host, (c) the JNI and R hosts) and ``check_plane_learners`` ((d) GOSS on
two gloo ranks on one card, (e) with four or more cards two NCCL ranks
of two cards each).  Prints the card (nvidia-smi name and power limit)
and the phase's lines; exits nonzero on any failed check or without a
card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_capi_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.build_kernels(["fused_route_hist", "route_apply",
                           "predict_level", "predict_level_global"])
    card = cs.card_line()
    print(f"card: {card}; kernels built in {time.perf_counter() - t0:.1f} s")
    X, y, w = cs.make_data(args.rows, 28, seed=7)
    Xv, yv, _ = cs.make_data(200_000, 28, seed=8, w=w)
    params = dict(cs.BENCH_PARAMS, metric=["auc"], device="cuda")
    dev = torch.device("cuda")
    train_ds = lgb.Dataset(X, label=y, free_raw_data=False)
    core = train_ds.construct(lgb.Config.from_params(params))
    valid_ds = lgb.Dataset(Xv, label=yv, reference=train_ds)
    bst, _, launches, _ = cs.train_plan(lgb, kernels, params, train_ds,
                                        valid_ds, 10, dev, card,
                                        "int8 fused_tiled")
    main_text = bst.model_to_string()
    prob = bst.predict(Xv)
    del bst
    t0 = time.perf_counter()
    got, _ = cs.check_capi(lgb, kernels, params, X, y, Xv, main_text,
                           launches, prob, dev, card, False)
    print(f"[phase 19] launches through the C ABI {got}")
    cs.check_plane_learners(lgb, params, X, y, core, dev, card, False)
    print(f"torch_capi_check: phase 19 in {time.perf_counter() - t0:.1f} s "
          f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
