#!/usr/bin/env python3
"""Where the port's training time goes, on one CUDA card.

    python3 scripts/torch_profile_train.py [--rows N] [--trees T] [--f32]

Trains chip_smoke.py's workload (its make_data 1,000,000 x 28 binary
task and its BENCH_PARAMS: 255 leaves, max_bin 63, quantized gradients;
with --f32, float gradients: the fused_streamed plan) with
lightgbm_tpu_torch: two warm-up trees, then T trees under
torch.profiler.  Prints the card (nvidia-smi name and power limit), the
wall ms per tree, the summed device-kernel time per tree and the
device idle share of the profiled window, each hand-written kernel's
launches and mean device ms per launch, the top CUDA kernels and host
operators by time, and writes the full table to
chiprun_out/torch_profile_train.txt.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import BENCH_PARAMS, card_line, make_data  # noqa: E402

#: the symbols of the hand-written kernels (csrc/*.cu)
KERNEL_SYMBOLS = ("fused_route_hist", "route_apply", "predict_level",
                  "onehot_hist", "bins_hist")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--trees", type=int, default=5)
    ap.add_argument("--f32", action="store_true",
                    help="float gradients (quantized_grad=false)")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.boosting import create_boosting

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    X, y, _ = make_data(args.rows, 28, seed=7)
    params = dict(BENCH_PARAMS, quantized_grad=not args.f32)
    cfg = lgb.Config.from_params(params)
    core = lgb.Dataset(X, label=y).construct(cfg)
    gbdt = create_boosting(cfg, core)
    print(f"plan: {gbdt.grower.plan.name}")
    for _ in range(2):
        gbdt.train_one_iter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.trees):
            gbdt.train_one_iter()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_time(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    dev_events = [e for e in ka
                  if getattr(e.device_type, "name", "") == "CUDA"]
    dev_us = sum(dev_time(e) for e in dev_events)
    wall_ms = 1e3 * wall / args.trees
    dev_ms = dev_us / 1e3 / args.trees
    print(f"wall {wall_ms:.1f} ms/tree (under the profiler); device "
          f"kernels {dev_ms:.2f} ms/tree; device idle share "
          f"{1 - dev_ms / wall_ms:.3f} ({card})")
    for sym in KERNEL_SYMBOLS:
        hits = [e for e in dev_events if sym in e.key]
        n = sum(e.count for e in hits)
        if n:
            us = sum(dev_time(e) for e in hits)
            print(f"kernel {sym}: {n} launches in {args.trees} trees, "
                  f"mean {us / 1e3 / n:.4f} ms per launch on the training "
                  f"path ({card})")
    try:
        by_dev = ka.table(sort_by="self_device_time_total", row_limit=25)
    except Exception:
        by_dev = ka.table(sort_by="self_cuda_time_total", row_limit=25)
    by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=25)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/torch_profile_train.txt", "w") as f:
        f.write(f"card: {card}\nplan: {gbdt.grower.plan.name}\n{by_dev}"
                f"\n\n{by_cpu}\n")
    print(by_dev)
    print(by_cpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
