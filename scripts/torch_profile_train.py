#!/usr/bin/env python3
"""Where the port's training time goes, on one CUDA card.

    python3 scripts/torch_profile_train.py [--rows N] [--trees T]
                                           [--plan PLAN] [--parent DIR]
                                           [--root DIR]

Trains chip_smoke.py's workload (its make_data 1,000,000 x 28 binary
task and its BENCH_PARAMS: 255 leaves, max_bin 63) with
lightgbm_tpu_torch under the histogram plan PLAN (default fused_tiled,
the quantized main path; ``xla`` is the default config, without
quantized_grad and with hist_compute_dtype float32; see PLANS): two
warm-up trees, then T trees under torch.profiler.  Prints the card
(nvidia-smi name and power limit), the wall ms per tree, the summed
device-kernel time per tree and the device idle share of the profiled
window, each hand-written kernel's launches and mean device ms per
launch, on seg_tiled the leaf partition's device time per round and
its share of the device time, the CUDA launches per tree (device
kernels, and memory copies and sets, from the profile), the top CUDA
kernels and host operators by time, and writes the full table to
chiprun_out/torch_profile_train.txt.  On fused_tiled it also prints
kernel A's mean device ms per call (its routing launch plus its
histogram launches), on q_onthefly and pallas(quantized) kernel I's
(its histogram launch plus the copies' sum), on seg_tiled kernel J's
(its run plan and histogram; its zero fill is a memory set).

With --parent DIR (another tree, e.g. ``git archive <commit>`` unpacked
into build/ab_parent) it profiles that tree and this one in turns
(other, this, this, other), each by this script in its own process
that imports lightgbm_tpu_torch from that tree (--root), and prints
each run's summary lines (wall, device time, launches per tree, each
kernel's mean ms per launch).
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import BENCH_PARAMS, card_line, make_data  # noqa: E402

_F32 = {"quantized_grad": False}
_OTF = {"hist_kernel_tiled": False, "hist_fused_route": False}
#: plan -> the knobs over BENCH_PARAMS that resolve it (None: drop)
PLANS = {
    "fused_tiled": {},
    "q_tiled(split_route)": {"hist_split_route": True},
    "seg_tiled": {"hist_leaf_partition": "on"},
    "q_tiled": {"hist_fused_route": False},
    "q_onthefly": _OTF,
    "pallas(quantized)": dict(_OTF, hist_quant_onthefly=False,
                              hist_onehot_budget_mb=0),
    "fused_streamed": _F32,
    "pre_onehot": dict(_F32, hist_fused_route=False),
    "pallas": dict(_F32, hist_onehot_budget_mb=0),
    "pallas_paired": dict(_F32, hist_kernel="paired"),
    "xla": {"quantized_grad": None, "hist_compute_dtype": None},
}
#: hand-written kernel (the kernels it serves) -> a pattern of its CUDA
#: symbol (re.search)
KERNEL_SYMBOLS = {
    "hist_i32, transposed (A, G)": r"hist_i32_kernel<\d+(, false)?>",
    "hist_i32, row-major (I)": r"hist_i32_kernel<\d+, true>",
    "sum_copies (A's, G's and I's copies)": "sum_copies_kernel",
    "routing_pass (A's routing)": "routing_pass_kernel",
    # B: <V, kShared> before H joined its template, <V, true, kRec,
    # kVal> since; H: <V, false, kRec, kVal>
    "route_value (B)": (r"route_value_kernel<\d+, (true|false)>"
                        r"|route_value_kernel<\d+, true(, (true|false)){2}>"),
    "route_value without values (H)": (r"route_value_kernel<\d+, false"
                                       r"(, (true|false)){2}>"),
    "route (H's first design)": r"\broute_kernel",
    "predict_level (C)": "predict_level_kernel",
    "hist_f64, one-hot rows (D, E)": "hist_f64_kernel<true",
    "route_rows (D's routing)": "route_rows_kernel",
    "hist_f64, rows of bins (F, K)": "hist_f64_kernel<false",
    "onehot_hist_q (D, E with int8 weights)": "onehot_hist_q_kernel",
    "bins_hist_q (I's first design)": "bins_hist_q_kernel",
    "seg_plan (J's run plan)": "seg_plan_kernel",
    "seg_hist (J)": "seg_hist_kernel",
}


def plan_params(plan: str) -> dict:
    params = dict(BENCH_PARAMS)
    for k, v in PLANS[plan].items():
        if v is None:
            params.pop(k)
        else:
            params[k] = v
    return params


def _dev_time(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def _device_us(prof):
    """Summed device-kernel microseconds of a profile."""
    return sum(_dev_time(e) for e in prof.key_averages()
               if getattr(e.device_type, "name", "") == "CUDA")


def in_turns(parent: str, argv) -> int:
    """Profile the tree at ``parent`` and this one in turns (other, this,
    this, other), each in its own process; print each run's summary
    lines."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rest = [a for i, a in enumerate(argv) if a != "--parent"
            and (i == 0 or argv[i - 1] != "--parent")]
    for label, root in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            *rest, "--root", os.path.abspath(root)],
                           capture_output=True, text=True, cwd=here)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        for line in r.stdout.splitlines():
            if line.startswith(("card:", "plan:", "wall ", "kernel ",
                                "leaf partition", "launches:")):
                print(f"[{label}] {line}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--trees", type=int, default=5)
    ap.add_argument("--plan", choices=sorted(PLANS), default="fused_tiled")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--root", default=None,
                    help="import lightgbm_tpu_torch from this tree")
    args = ap.parse_args()
    if args.parent is not None:
        return in_turns(args.parent, sys.argv[1:])
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import lightgbm_tpu_torch as lgb
    if args.root is not None and not os.path.abspath(lgb.__file__).startswith(
            os.path.abspath(args.root)):
        raise RuntimeError(f"imported {lgb.__file__}, not the tree at "
                           f"{args.root}")
    from lightgbm_tpu_torch.boosting import create_boosting
    from lightgbm_tpu_torch.learner.grower import TreeGrower

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    X, y, _ = make_data(args.rows, 28, seed=7)
    cfg = lgb.Config.from_params(plan_params(args.plan))
    core = lgb.Dataset(X, label=y).construct(cfg)
    gbdt = create_boosting(cfg, core)
    plan = gbdt.grower.plan.name
    print(f"plan: {plan}")
    # count the leaf partitions a profiled tree builds and keep the last
    # one's inputs, to time the partition on its own below
    parts = []
    build = TreeGrower._build_partition

    def counted(self, leaf_id, wT):
        parts.append((leaf_id, wT))
        del parts[:-1]
        counted.calls += 1
        return build(self, leaf_id, wT)
    counted.calls = 0
    TreeGrower._build_partition = counted
    for _ in range(2):
        gbdt.train_one_iter()
    torch.cuda.synchronize()
    counted.calls = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.trees):
            gbdt.train_one_iter()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_events = [e for e in ka
                  if getattr(e.device_type, "name", "") == "CUDA"]
    if not dev_events:
        raise SystemExit("torch.profiler recorded no device event: "
                         "device time not measured")
    dev_ms = _device_us(prof) / 1e3 / args.trees
    wall_ms = 1e3 * wall / args.trees
    print(f"wall {wall_ms:.1f} ms/tree (under the profiler); device "
          f"kernels {dev_ms:.2f} ms/tree; device idle share "
          f"{1 - dev_ms / wall_ms:.3f} ({card})")
    mem = sum(e.count for e in dev_events
              if e.key.startswith(("Memcpy", "Memset")))
    kern = sum(e.count for e in dev_events) - mem
    print(f"launches: {kern / args.trees:.1f} device kernels and "
          f"{mem / args.trees:.1f} memory copies or sets per tree "
          f"({card})")
    per_symbol = {}
    for label, sym in KERNEL_SYMBOLS.items():
        hits = [e for e in dev_events if re.search(sym, e.key)]
        n = sum(e.count for e in hits)
        if n:
            us = sum(_dev_time(e) for e in hits)
            per_symbol[label] = (n, us)
            print(f"kernel {label}: {n} launches in {args.trees} trees, "
                  f"mean {us / 1e3 / n:.4f} ms per launch, "
                  f"{us / 1e3 / args.trees / dev_ms:.3f} of device time "
                  f"({card})")
    labels = list(KERNEL_SYMBOLS)
    for name, plans, keys in (
            ("A (routing + histogram + copies' sum)", ("fused_tiled",),
             ("routing_pass (A's routing)", labels[0], labels[2])),
            ("I (histogram + copies' sum)",
             ("q_onthefly", "pallas(quantized)"), (labels[1], labels[2])),
            ("J (run plan + histogram)",
             ("seg_tiled(leaf_partition)",),
             ("seg_plan (J's run plan)", "seg_hist (J)"))):
        pieces = [per_symbol.get(k) for k in keys]
        if plan in plans and all(pieces):
            # one call: its first launch's count, every launch's time
            calls = pieces[0][0]
            us = sum(u for _, u in pieces)
            print(f"kernel {name}: {calls} calls in {args.trees} trees, mean "
                  f"{us / 1e3 / calls:.4f} ms per call, "
                  f"{us / 1e3 / args.trees / dev_ms:.3f} of device time "
                  f"({card})")
    if counted.calls:
        # the partition of one round (the last profiled one), alone
        grower = gbdt.grower
        reps = 20
        with profile(activities=[ProfilerActivity.CUDA]) as pp:
            for _ in range(reps):
                build(grower, *parts[-1])
            torch.cuda.synchronize()
        part_ms = _device_us(pp) / 1e3 / reps
        per_tree = counted.calls / args.trees
        print(f"leaf partition: {counted.calls} builds in {args.trees} "
              f"trees, {part_ms:.4f} device ms per build (sort, "
              f"searchsorted, scatter, two gathers; timed alone on the "
              f"last round's leaf ids), {part_ms * per_tree / dev_ms:.3f} "
              f"of device time ({card})")
    try:
        by_dev = ka.table(sort_by="self_device_time_total", row_limit=25)
    except Exception:
        by_dev = ka.table(sort_by="self_cuda_time_total", row_limit=25)
    by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=25)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/torch_profile_train.txt", "w") as f:
        f.write(f"card: {card}\nplan: {plan}\n{by_dev}"
                f"\n\n{by_cpu}\n")
    print(by_dev)
    print(by_cpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
