#!/usr/bin/env python3
"""chip_smoke.py's phases 15 (data-parallel training), 16 (the feature
and voting learners, sharded construction and the shard cache, the
elastic rejoin) and 17 (the row-sharded multi-process plane) alone, on
the visible CUDA cards.

    python3 scripts/torch_dist_check.py [--rows N] [--phases 15,16,17]

Builds kernels A and B, makes chip_smoke.py's bench rows (make_data,
1,000,000 x 28 by default, and 200,000 held-out rows) and runs its
``check_distributed``: the tcp plane's two ranks on ``cuda:0`` against
the single-process run, the codec on CUDA tensors against the CPU, and
the mesh's data learner; then ``check_sharded_learners`` on phase 15's
single-matrix construction and texts; then ``check_plane``: two ranks
of the device plane on one card over gloo against the single-process
2-shard mesh, and with two or more cards the same over NCCL, one card a
rank, with four or more cards also four NCCL ranks against the
4-shard mesh.  With two or more cards, the meshes of phases 15 and 16
put their shards on ``cuda:0``, ``cuda:1``, ...; with one, all on
``cuda:0``.  ``--phases 17`` runs phase 17 alone (16 needs 15).  Prints
the card (nvidia-smi name and power limit) and the phases' lines; exits
nonzero on any failed check or without a card.
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
    ap.add_argument("--phases", default="15,16,17")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    if 16 in phases and 15 not in phases:
        ap.error("phase 16 needs phase 15's references")
    import torch
    if not torch.cuda.is_available():
        print("torch_dist_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    if phases & {15, 16}:
        kernels.build_kernels(["fused_route_hist", "route_apply"])
    card = cs.card_line()
    print(f"card: {card}; {torch.cuda.device_count()} visible; kernels "
          f"built in {time.perf_counter() - t0:.1f} s")
    X, y, w = cs.make_data(args.rows, 28, seed=7)
    params = dict(cs.BENCH_PARAMS, device="cuda")
    dev = torch.device("cuda")
    if 15 in phases:
        _, _, ref = cs.check_distributed(lgb, kernels, params, X, y, dev,
                                         card, False)
    if 16 in phases:
        Xv, yv, _ = cs.make_data(200_000, 28, seed=8, w=w)
        cs.check_sharded_learners(lgb, kernels, params, X, y, Xv, yv, dev,
                                  card, False, ref)
    if 17 in phases:
        core = lgb.Dataset(X[:200_000], label=y[:200_000]).construct(
            lgb.Config.from_params(params))
        cs.check_plane(lgb, kernels, params, X, y, core, dev, card, False,
                       worlds=(2, 4))
    return 0


if __name__ == "__main__":
    sys.exit(main())
