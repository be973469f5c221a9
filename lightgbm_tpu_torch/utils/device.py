"""The ``device`` rule: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(config) -> torch.device:
    """``config.device`` as a torch device.  "cuda" (the default) needs
    a visible CUDA device and raises without one — the port never
    carries on on the CPU unless ``device="cpu"`` was asked for."""
    name = str(getattr(config, "device", "cuda")).lower()
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' (the default) but no CUDA device is "
            "available; pass device='cpu' in params to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def rows_to_device(rows, device: torch.device, n_rows: int = None,
                   chunk_rows: int = 1 << 20) -> torch.Tensor:
    """A host (N, C) matrix as a tensor of ``n_rows`` >= N rows on
    ``device`` (rows past N are zero).  A writable contiguous array of
    N rows goes over whole; any other (a read-only ``np.memmap`` of a
    binary cache, or one that needs padding rows) is copied through
    ``chunk_rows``-row staging chunks into a tensor allocated on the
    device, so no second full host copy is made."""
    import numpy as np
    n = rows.shape[0]
    n_rows = n if n_rows is None else int(n_rows)
    if n_rows == n and isinstance(rows, np.ndarray) \
            and not isinstance(rows, np.memmap) \
            and rows.flags.writeable and rows.flags.c_contiguous:
        return torch.from_numpy(rows).to(device)
    out = torch.zeros((n_rows,) + tuple(rows.shape[1:]),
                      dtype=torch.from_numpy(np.zeros(0, rows.dtype)).dtype,
                      device=device)
    for i in range(0, n, chunk_rows):
        j = min(i + chunk_rows, n)
        out[i:j].copy_(torch.from_numpy(np.array(rows[i:j])))
    return out
