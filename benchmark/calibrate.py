#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
        [--seconds 5] [--control PRECISION] [--fault NAME]
        [--rows N]

Without --control or --fault: the program's own runs, one a seed, each
a whole run of the cell (set-up, a window of --seconds, the check); with
--fault, the same with the fault planted (gbdtbench/faults.py); with
--control, the reference in the program's place at PRECISION (training:
exact, tf32; scoring: float32), no window.
Prints one JSON line a seed.  Needs the cell's CUDA device, unless
--rows cuts the rows for a CPU rehearsal.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv) -> int:
    import argparse
    import contextlib
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--rows", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    from gbdtbench import faults, runner, spec
    if args.rows:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    else:
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    s = spec.Spec(args.workload)
    drv = runner.driver(s)
    for seed in [int(x) for x in args.seeds.split(",")]:
        run = runner.Run(s, seed, args.seconds, False, dev,
                         time.perf_counter(), rows=args.rows)
        t = time.perf_counter()
        if args.control:
            readings = (drv.control(run, args.control)
                        if s.traffic["driver"] == "train"
                        else {"predict_gap": drv.control(run)})
            line = {"seed": seed, "control": args.control,
                    "readings": readings}
        else:
            plant = (faults.plant(args.fault) if args.fault
                     else contextlib.nullcontext())
            with plant:
                out = runner.execute(run)
            line = {"seed": seed, "fault": args.fault,
                    "readings": {k: c["value"]
                                 for k, c in out["checks"].items()},
                    "metrics": {k: m["value"]
                                for k, m in out["metrics"].items()},
                    "where": run.layer.get("where")}
        line["s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del run
        import gc
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
