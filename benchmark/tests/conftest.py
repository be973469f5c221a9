"""Paths and fixtures of the benchmark's tests: the harness and the
reference import from ``benchmark/``, the program from the repository's
root.  Tests marked ``cuda`` decide in the ``cuda_device`` fixture
whether a card exists."""
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def make_run(cell, rows, device="cpu", seconds=0.5, trace=False, seed=7,
             root=ROOT, **kw):
    import torch
    from gbdtbench import runner, spec
    return runner.Run(spec.Spec(cell, root=root), seed, seconds, trace,
                      torch.device(device), time.perf_counter(), rows=rows,
                      **kw)
