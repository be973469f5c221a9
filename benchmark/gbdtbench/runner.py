"""One run of one cell: set-up, the measured window, the check, and the
result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell's traffic names its driver (``drivers/<driver>.py``), whose
``execute(run)`` makes the inputs, sets up the program, measures the
window (and, traced, a fixed count of operations under the profiler),
frees the program and compares its outputs with the plain reference.
Then each of the cell's metrics is read by its own reader and one JSON
line is printed last.  A run finds its card or fails: it never falls
back to the CPU.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from . import spec as _spec

#: whole top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")


class Run:
    """What one run knows: its cell, its options, and what the driver
    measured and read, for the metric readers."""

    def __init__(self, spec: "_spec.Spec", seed: int, seconds: float,
                 trace: bool, device, t_start: float, rank: int = 0,
                 world: int = 1, coord: Optional[str] = None,
                 rows: int = 0):
        self.spec = spec
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start          # the process's start (perf_counter)
        self.rank, self.world, self.coord = rank, world, coord
        self.rows = rows                # tests only: cut the rows
        self.setup_s: Optional[float] = None
        self.window: Dict = {}          # the driver's timings
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.checks: Dict[str, Dict[str, float]] = {}
        self.layer: Dict = {}           # what the traced part measured
        self.view = None                # trace.TraceView of the traced part
        self.traced_span = None         # (lo, hi) of the traced part

    @property
    def config(self) -> dict:
        return self.spec.config

    @property
    def traffic(self) -> dict:
        return self.spec.traffic

    def check(self, name: str, value: float) -> None:
        """Record one number compared, beside its limit."""
        self.checks[name] = {"value": float(value),
                             "limit": float(self.spec.limits[name])}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] <= c["limit"] for c in self.checks.values()) and \
            set(self.checks) == set(self.spec.limits)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def rank_report(run: Run) -> Dict:
    """What a rank > 0 prints last for rank 0: its device peak and the
    forbidden modules its process holds."""
    return {"memory_peak_bytes": int(run.memory_peak),
            "forbidden": forbidden_modules()}


def gather(out: Dict, reports: List[Dict]) -> List[str]:
    """Fold the other ranks' reports into rank 0's result line (the
    fullest chip's peak); the forbidden modules that any rank holds,
    this process included."""
    bad = set(forbidden_modules())
    for rep in reports:
        out["device"]["memory_peak_bytes"] = max(
            out["device"]["memory_peak_bytes"], rep["memory_peak_bytes"])
        bad |= set(rep["forbidden"])
    return sorted(bad)


def driver(spec: "_spec.Spec"):
    import importlib
    return importlib.import_module(
        f"{__package__}.drivers.{spec.traffic['driver']}")


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not found"


def result_line(run: Run) -> Dict:
    """The metrics of the run's kind, read each by its reader, with the
    device and, traced, the breakdown; the checks come last."""
    import torch
    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in run.spec.metrics(kind):
        value = run.spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": run.world, "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.trace and run.view is not None:
        from .trace import breakdown
        lo, hi = run.traced_span
        device["busy_s"] = run.view.busy(lo, hi)
        device["window_s"] = hi - lo
        out["breakdown"] = breakdown(run.view, lo, hi)
    out["checks"] = run.checks
    return out


def execute(run: Run) -> Dict:
    """Drive the cell once and return its result line (tests call this
    with a CPU device; the command refuses one)."""
    drv = driver(run.spec)
    drv.execute(run)
    gc.collect()
    return result_line(run)


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # one rank of a multi-rank cell, started by rank 0
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--coord", default=None)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    spec = _spec.Spec(args.workload)
    import torch
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    world = int(spec.traffic.get("ranks", 1))
    run = Run(spec, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", args.rank % chips), t_start,
              rank=args.rank, world=world, coord=args.coord)
    torch.cuda.set_device(run.device)
    children = []
    if world > 1 and args.rank == 0:
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            run.coord = f"127.0.0.1:{s.getsockname()[1]}"
        for r in range(1, world):
            children.append(subprocess.Popen(
                [sys.executable, os.path.abspath(sys.argv[0]), *argv,
                 "--rank", str(r), "--coord", run.coord],
                stdout=subprocess.PIPE, text=True))
    texts = []
    try:
        out = execute(run)
    finally:
        for p in children:
            try:
                texts.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if args.rank != 0:
        rep = rank_report(run)
        print(json.dumps(rep), flush=True)
        if rep["forbidden"]:
            print(f"benchmark: rank {args.rank} loaded "
                  f"{', '.join(rep['forbidden'])}", file=sys.stderr)
            return 3
        return 0
    reports = []
    for text in texts:
        try:
            reports.append(json.loads(text.strip().splitlines()[-1]))
        except (ValueError, IndexError):
            pass
    bad = gather(out, reports)
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    if len(reports) < len(children) or any(p.returncode != 0
                                           for p in children):
        print("benchmark: a rank failed: "
              f"{[p.returncode for p in children]}", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
