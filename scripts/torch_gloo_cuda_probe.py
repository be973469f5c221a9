#!/usr/bin/env python3
"""Which torch.distributed collectives the gloo backend runs on CUDA
tensors in this torch, and on which dtypes: two processes on one card.

    python3 scripts/torch_gloo_cuda_probe.py

The device plane (parallel/distributed.py, collective_transport=xla)
runs several ranks on one card over gloo and hands it CUDA tensors
through ``all_reduce`` (sum and max) and ``all_gather`` (the list form)
only (parallel/collectives.py ProcessGroupCollectives); this prints,
for those and a few others, ``ok`` or the error's type, on uint8, int8,
int16, int32, float32 and float64 tensors, and exits nonzero if one the
plane uses fails.  Needs a card; prints the torch and CUDA versions.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

#: (collective, dtype) pairs the plane hands gloo on the card
USED = [("all_reduce_sum", "float32"), ("all_reduce_max", "float32"),
        ("all_reduce_sum", "int8"), ("all_gather", "float32"),
        ("all_gather", "int8"), ("all_gather", "uint8")]


def _rank(coord: str, rank: int) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=2, rank=rank)
    out = {}
    for dt in ("uint8", "int8", "int16", "int32", "float32", "float64"):
        dtype = getattr(torch, dt)

        def t():
            return torch.full((1000,), rank + 1, dtype=dtype, device="cuda")
        tries = {
            "all_reduce_sum": lambda: dist.all_reduce(t()),
            "all_reduce_max": lambda: dist.all_reduce(
                t(), op=dist.ReduceOp.MAX),
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(t()) for _ in range(2)], t()),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(2000, dtype=dtype, device="cuda"), t()),
            "broadcast": lambda: dist.broadcast(t(), 0),
            "reduce_scatter": lambda: dist.reduce_scatter(
                t()[:500], [t()[:500], t()[:500]]),
        }
        for name, fn in tries.items():
            try:
                fn()
                torch.cuda.synchronize()
                out[f"{name} {dt}"] = "ok"
            except Exception as e:  # noqa: BLE001 - the probe's answer
                out[f"{name} {dt}"] = type(e).__name__
            dist.barrier()
    # the sum's value on the card: 1 + 2 in each element
    x = torch.full((4,), rank + 1.0, device="cuda")
    dist.all_reduce(x)
    out["sum_value"] = x.tolist()
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        _rank(sys.argv[2], int(sys.argv[3]))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", coord, str(r)], env=env,
                              stdout=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode for p in procs):
        print("torch_gloo_cuda_probe: a rank failed", file=sys.stderr)
        return 1
    got = json.loads(outs[0].strip().splitlines()[-1])
    for k, v in got.items():
        print(f"{k}: {v}")
    bad = [f"{c} {d}" for c, d in USED if got.get(f"{c} {d}") != "ok"]
    if bad or got["sum_value"] != [3.0] * 4:
        print(f"torch_gloo_cuda_probe: the plane's collectives fail: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
