"""Collective-communication seam.

Port of lightgbm_tpu/parallel/collectives.py: the functional equivalent
of the reference's static Network class (reference:
include/LightGBM/network.h:86-296 — Allreduce, ReduceScatter,
Allgather, GlobalSyncUpByMin/Max/Mean, GlobalSum — and the
external-function injection point Network::Init(num_machines, rank,
reduce_scatter_fn, allgather_fn) at network.h:96 / c_api.h:760).

The JAX package's collectives run inside ``shard_map`` over a named
mesh axis; here a collective takes the list of per-shard tensors (one
a mesh device, parallel/mesh.py) and reduces them in shard order, so
the result is the same bits on the CPU and on the card.  The host
backend (numpy, single process) makes the distributed code paths
unit-testable without any devices.

Across processes (the ``collective_transport=xla`` device plane,
parallel/distributed.py) :class:`ProcessGroupCollectives` runs the same
calls over the torch.distributed process group, each rank passing its
one shard, and :func:`exchange_histograms_ranks` the histogram codec:
the bits of the in-process mesh's, since both sum in rank order.

Each collective is counted when it is called (``collective_<kind>_calls``
/ ``_bytes``).  The JAX package also reads the collectives XLA inserts
back from compiled module text (``scan_compiled_collectives``); torch
has no such text, so that part is not ported (ROADMAP.md, not ported
by design).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.split import cumsum_f32
from ..telemetry import TELEMETRY


def traced_nbytes(x) -> int:
    """Byte size of a tensor or array from its shape and dtype."""
    if isinstance(x, torch.Tensor):
        return int(x.numel() * x.element_size())
    size = 1
    for d in getattr(x, "shape", ()) or ():
        size *= int(d)
    dt = getattr(x, "dtype", None)
    return size * (int(np.dtype(dt).itemsize) if dt is not None else 4)


def _note_collective(kind: str, x) -> None:
    """Collective accounting (the JAX package's names): counts explicit
    collective calls and their payload bytes per kind.  Pure host
    Python — nothing here touches a device."""
    if TELEMETRY.on:
        TELEMETRY.add(f"collective_{kind}_calls", 1)
        TELEMETRY.add(f"collective_{kind}_bytes", traced_nbytes(x))


def _sum_in_order(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """((p0 + p1) + p2) + ... on ``device``: the order of the host
    backend's ``np.sum(np.stack(parts), axis=0)``, so a float sum is
    the same bits wherever it runs."""
    out = parts[0].to(device, copy=True)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


class Collectives:
    """Collectives over the shards of one mesh axis: each call takes the
    per-shard tensors (shard order) and returns one result per shard,
    on the shard's device.  ``axis_name`` None is the serial case: the
    input comes back unchanged."""

    def __init__(self, axis_name: Optional[str]):
        self.axis_name = axis_name

    @property
    def is_distributed(self) -> bool:
        return self.axis_name is not None

    def _everywhere(self, xs, value):
        return [value.to(x.device) for x in xs]

    # -- core three (the only ones the learners need) -----------------
    def allreduce_sum(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.axis_name is None:
            return xs
        for x in xs:
            _note_collective("allreduce", x)
        return self._everywhere(xs, _sum_in_order(xs, xs[0].device))

    def reduce_scatter(self, xs: List[torch.Tensor],
                       tiled_axis: int = 0) -> List[torch.Tensor]:
        if self.axis_name is None:
            return xs
        for x in xs:
            _note_collective("reduce_scatter", x)
        total = _sum_in_order(xs, xs[0].device)
        parts = torch.chunk(total, len(xs), dim=tiled_axis)
        return [p.to(x.device) for p, x in zip(parts, xs)]

    def all_gather(self, xs: List[torch.Tensor],
                   axis: int = 0) -> List[torch.Tensor]:
        if self.axis_name is None:
            return xs
        for x in xs:
            _note_collective("allgather", x)
        dev = xs[0].device
        return self._everywhere(xs, torch.cat([x.to(dev) for x in xs],
                                              dim=axis))

    # -- scalar sync helpers (network.h:165-257) ----------------------
    def global_sum(self, xs):
        return self.allreduce_sum(xs)

    def _reduce(self, xs, op):
        if self.axis_name is None:
            return xs
        for x in xs:
            _note_collective("allreduce", x)
        dev = xs[0].device
        out = xs[0].to(dev, copy=True)
        for x in xs[1:]:
            out = op(out, x.to(dev))
        return self._everywhere(xs, out)

    def global_min(self, xs):
        return self._reduce(xs, torch.minimum)

    def global_max(self, xs):
        return self._reduce(xs, torch.maximum)

    def global_mean(self, xs):
        if self.axis_name is None:
            return xs
        return [s / len(xs) for s in self.allreduce_sum(xs)]

    def argmax_sync(self, values, payloads):
        """Global argmax with payload broadcast — the
        SyncUpGlobalBestSplit pattern (parallel_tree_learner.h:184-207):
        every shard contributes (gain, payload); every shard ends up
        with the payload of the best gain (the first shard on a tie,
        as ``jnp.argmax``)."""
        if self.axis_name is None:
            return payloads
        for v in values:
            _note_collective("allgather", v)
        gains = torch.stack([torch.as_tensor(v).reshape(()).cpu()
                             for v in values])
        best = int(torch.argmax(gains))
        for p in payloads:
            _note_collective("allgather", p)
        return [payloads[best].to(p.device) for p in payloads]

    def rank(self, shard: int = 0) -> int:
        return 0 if self.axis_name is None else int(shard)

    def num_machines(self, xs=None) -> int:
        if self.axis_name is None:
            return 1
        return len(xs) if xs is not None else 1


class ProcessGroupCollectives(Collectives):
    """The same collectives over the processes of the device plane
    (parallel/distributed.py ``plane()``): each rank passes its shards
    (one: a rank holds one device's rows) and gets one result per
    shard, on the shard's device.  Float sums are in rank order, the
    bits of :func:`_sum_in_order` over the ranks' tensors: with two
    ranks a native all-reduce (a + b is b + a), from three on a gather
    and the ordered sum, since NCCL's and gloo's rings do not add in
    rank order.  Uses only ``all_reduce`` and ``all_gather``, the two
    collectives gloo also runs on CUDA tensors."""

    def __init__(self, plane):
        super().__init__("data")
        self.plane = plane

    @staticmethod
    def _one(xs) -> torch.Tensor:
        if len(xs) != 1:
            raise NotImplementedError(
                f"a rank of the device plane holds one shard, got "
                f"{len(xs)}: several local devices a rank are not "
                "supported (ROADMAP.md queue 1)")
        return xs[0]

    def _gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        import torch.distributed as dist
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.plane.world)]
        dist.all_gather(parts, x)
        return parts

    def sum_ranks(self, x: torch.Tensor, kind: str = "allreduce"
                  ) -> torch.Tensor:
        """The ranks' ``x`` summed in rank order (a float ``x``; integer
        sums are exact in any order and take a native all-reduce)."""
        import torch.distributed as dist
        _note_collective(kind, x)
        if self.plane.world == 2 or not x.is_floating_point():
            out = x.clone()
            dist.all_reduce(out)
            return out
        return _sum_in_order(self._gather(x), x.device)

    def allreduce_sum(self, xs):
        return [self.sum_ranks(self._one(xs))]

    def reduce_scatter(self, xs, tiled_axis: int = 0):
        x = self._one(xs)
        total = self.sum_ranks(x, "reduce_scatter")
        return [torch.chunk(total, self.plane.world,
                            dim=tiled_axis)[self.plane.rank].clone()]

    def all_gather(self, xs, axis: int = 0):
        x = self._one(xs)
        _note_collective("allgather", x)
        return [torch.cat(self._gather(x), dim=axis)]

    def _reduce(self, xs, op):
        import torch.distributed as dist
        out = self._one(xs).clone()
        _note_collective("allreduce", out)
        dist.all_reduce(out, op={torch.minimum: dist.ReduceOp.MIN,
                                 torch.maximum: dist.ReduceOp.MAX}[op])
        return [out]

    def global_mean(self, xs):
        return [s / self.plane.world for s in self.allreduce_sum(xs)]

    def argmax_sync(self, values, payloads):
        """Every rank ends with the payload of the best gain (the lowest
        rank on a tie, as ``jnp.argmax``)."""
        v = self._one(values).reshape(1).to(torch.float32)
        p = self._one(payloads)
        _note_collective("allgather", v)
        best = int(torch.argmax(torch.cat(self._gather(v)).cpu()))
        _note_collective("allgather", p)
        return [self._gather(p)[best]]

    def rank(self, shard: int = 0) -> int:
        return self.plane.rank

    def num_machines(self, xs=None) -> int:
        return self.plane.world


class HostCollectives(Collectives):
    """Single-process fake backend — the LGBM_NetworkInitWithFunctions
    analog for unit tests: simulates a k-way reduction by applying the
    reduction to caller-provided per-shard arrays."""

    def __init__(self, shards: int = 1):
        super().__init__(None)
        self.shards = shards

    def simulate_allreduce(self, per_shard_arrays):
        for a in per_shard_arrays:
            _note_collective("allreduce", a)
        return np.sum(np.stack(per_shard_arrays), axis=0)

    def simulate_reduce_scatter(self, per_shard_arrays, axis: int = 0):
        total = np.sum(np.stack(per_shard_arrays), axis=0)
        for a in per_shard_arrays:
            _note_collective("reduce_scatter", a)
        return np.array_split(total, self.shards, axis=axis)

    def simulate_allgather(self, per_shard_arrays, axis: int = 0):
        # the simulated gather carries the SAME reliability seam and
        # deadline as the real host collective (distributed._allgather)
        from ..reliability import watchdog as _watchdog
        from ..reliability.faults import FAULTS

        def _gather():
            FAULTS.fault_point("collectives.allgather")
            for a in per_shard_arrays:
                _note_collective("allgather", a)
            return np.concatenate(per_shard_arrays, axis=axis)

        return _watchdog.run_with_deadline(
            _gather, _watchdog.deadline("collective"),
            phase="host_collective", seam="collectives.allgather")


# ---------------------------------------------------------------------------
# Compressed histogram exchange (Config.hist_exchange): the data-
# parallel per-pass histogram sum is the largest recurring collective
# payload, and histogram bins are SMOOTH along the bin axis, so a delta
# code along bins concentrates values near zero and a shared
# per-(leaf, group, channel) scale quantizes the deltas to int16/int8
# at bounded reconstruction error.  Delta-coding is linear, so it
# COMMUTES with the cross-shard sum: shards quantize against one max'd
# scale, sum the narrow integers (with world-size headroom so the
# integer sum can never overflow), and the f32 histogram is rebuilt by
# a cumulative sum BEFORE the parent-subtraction step.
# ---------------------------------------------------------------------------
HIST_EXCHANGE_MODES = ("f32", "q16", "q8")


def _exchange_qparams(mode: str, world: int):
    """(qmax, int dtype) for a codec mode: the quantization ceiling
    leaves ``world``-way summation headroom inside the wire dtype."""
    bits = 16 if mode == "q16" else 8
    qmax = (2 ** (bits - 1) - 1) // max(int(world), 1)
    if qmax < 1:
        raise ValueError(
            f"hist_exchange={mode}: world size {world} leaves no "
            f"quantization levels inside int{bits}; use "
            + ("hist_exchange=q16 or f32" if mode == "q8" else
               "hist_exchange=f32"))
    return qmax, (torch.int16 if mode == "q16" else torch.int8)


def _check_mode(mode: str) -> None:
    if mode not in HIST_EXCHANGE_MODES:
        raise ValueError(f"hist_exchange must be one of "
                         f"{HIST_EXCHANGE_MODES}, got {mode!r}")


def _deltas(h: torch.Tensor) -> torch.Tensor:
    """The delta code along the bin axis (-2): bin 0, then each bin
    minus the one before."""
    return torch.cat([h[..., :1, :], torch.diff(h, dim=-2)], dim=-2)


def _delta_stat(d: torch.Tensor) -> torch.Tensor:
    """A shard's per-(leaf, group, channel) scale payload: the largest
    |delta| at bin position 0 and the largest non-integrality residual
    at position 1.  The shards' payloads are max'd."""
    return torch.cat([d.abs().amax(dim=-2, keepdim=True),
                      (d - torch.round(d)).abs().amax(dim=-2,
                                                      keepdim=True)],
                     dim=-2)


def _grid(stat: torch.Tensor, qmax: int) -> torch.Tensor:
    """The shared quantization grid from the max'd payload.  Channels
    whose deltas are integral on EVERY shard and fit qmax (the count
    channel always; grad/hess too under the unit-gradient objectives,
    e.g. regression_l1) ship verbatim on the unit grid, and the
    reconstruction is then exact."""
    amax, frac = stat[..., :1, :], stat[..., 1:, :]
    exact = (frac == 0) & (amax <= qmax)
    return torch.where(exact, torch.full_like(amax, float(qmax)),
                       torch.clamp_min(amax, 1e-30))


def _quantize(d: torch.Tensor, denom: torch.Tensor, qmax: int, qdt):
    return torch.clamp(torch.round(d / denom.to(d.device) * qmax),
                       -qmax, qmax).to(qdt)


def _dequantize(qsum: torch.Tensor, denom: torch.Tensor,
                qmax: int) -> torch.Tensor:
    """The f32 histogram from the int32 sum of the shards' integers, in
    the JAX mesh program's arithmetic: ``qsum * (denom * f32(1/qmax))``
    and the 16-wide blocked cumsum along the bins (``cumsum_f32``)."""
    recip = torch.tensor(1.0 / qmax, dtype=torch.float32,
                         device=qsum.device)
    deq = qsum.to(torch.float32) * (denom * recip)
    return cumsum_f32(deq.transpose(-1, -2)).transpose(-1, -2)


def exchange_histograms(hists: Sequence[torch.Tensor], mode: str = "f32",
                        world: Optional[int] = None) -> torch.Tensor:
    """Cross-shard histogram sum under the ``hist_exchange`` codec.
    ``hists`` holds each shard's local (L, G, B, 3) f32 histogram (bin
    axis -2) on its device; returns the reconstructed f32 global sum on
    the first shard's device, the bits of the JAX package's
    ``exchange_histograms`` under ``shard_map`` on its CPU mesh.

    "f32" sums the shards' histograms in shard order.  Under "q16"/"q8"
    the reconstruction takes the arithmetic of that compiled program,
    not the host codec's: XLA turns ``denom / qmax`` into ``denom *
    f32(1 / qmax)``, and ``jnp.cumsum`` along the bins takes the 16-wide
    blocked order of ``ops/split.py cumsum_f32`` (so the bits differ
    from :func:`host_exchange_histograms`, which the tcp plane keeps).
    "q16"/"q8" ship delta-coded integers (int16/int8 — the bytes that
    cross between devices) plus a small f32 scale payload; the wire
    bytes land in the ``collective_hist_exchange_bytes`` counter (the
    int payload) and ``collective_hist_exchange_scale_bytes`` (the
    scales)."""
    _check_mode(mode)
    hists = list(hists)
    if len(hists) == 1:
        return hists[0]
    world = len(hists) if world is None else int(world)
    dev = hists[0].device
    if mode == "f32":
        for h in hists:
            _note_collective("hist_exchange", h)
        return _sum_in_order(hists, dev)
    qmax, qdt = _exchange_qparams(mode, world)
    deltas = [_deltas(h) for h in hists]
    # ONE scale per (leaf, group, channel), shared across shards via a
    # max of the shards' maxima, so every shard quantizes against the
    # same grid and the integer sum dequantizes once
    stat = None
    for d in deltas:
        s = _delta_stat(d).to(dev)
        stat = s if stat is None else torch.maximum(stat, s)
    denom = _grid(stat, qmax)
    qsum = None
    for d in deltas:
        q = _quantize(d, denom, qmax, qdt)
        _note_collective("hist_exchange", q)
        _note_collective("hist_exchange_scale", stat)
        q = q.to(dev).to(torch.int32)
        qsum = q if qsum is None else qsum + q
    return _dequantize(qsum, denom, qmax)


def exchange_histograms_ranks(hist: torch.Tensor, mode: str,
                              coll: ProcessGroupCollectives
                              ) -> torch.Tensor:
    """:func:`exchange_histograms` across the device plane's ranks:
    this rank's (L, G, B, 3) f32 histogram in, the reconstructed global
    sum out, bit for bit the in-process codec over the ranks'
    histograms (every rank gets the same bits).

    "f32" sums in rank order (``ProcessGroupCollectives.sum_ranks``).
    "q16"/"q8": the (L, G, 2, 3) scale payloads are all-reduced with
    max, each rank quantizes against that shared grid, the integers
    are summed exactly and dequantized as in-process.  q8 all-reduces
    its int8 payload natively (``qmax = 127 // world`` leaves the
    headroom).  Neither gloo nor NCCL has int16, so q16 all-gathers its
    int16 payload viewed as bytes and each rank sums the ranks' int16
    values in int32: the wire carries 2 bytes a value.  The counters
    take what this rank puts on the wire, as the in-process codec's
    take each shard's payload: ``collective_hist_exchange_bytes`` (the
    f32 histogram, or the int payload) and, under q16/q8,
    ``collective_hist_exchange_scale_bytes``."""
    import torch.distributed as dist
    _check_mode(mode)
    if mode == "f32":
        return coll.sum_ranks(hist, "hist_exchange")
    world = coll.plane.world
    qmax, qdt = _exchange_qparams(mode, world)
    d = _deltas(hist)
    stat = _delta_stat(d)
    _note_collective("hist_exchange_scale", stat)
    dist.all_reduce(stat, op=dist.ReduceOp.MAX)
    denom = _grid(stat, qmax)
    q = _quantize(d, denom, qmax, qdt).contiguous()
    _note_collective("hist_exchange", q)
    if mode == "q8":
        dist.all_reduce(q)
        qsum = q.to(torch.int32)
    else:
        parts = coll._gather(q.view(torch.int8))
        qsum = None
        for p in parts:
            v = p.view(torch.int16).to(torch.int32)
            qsum = v if qsum is None else qsum + v
    return _dequantize(qsum, denom, qmax)


def host_exchange_histograms(per_shard_hists, mode: str = "f32"):
    """Single-process analog of :func:`exchange_histograms` over
    caller-provided per-shard numpy histograms — the
    HostCollectives.simulate_* pattern, so the codec path (and its
    byte counters) is unit-testable and benchable without devices.
    Carries the ``collectives.hist_exchange`` fault seam and the
    collective watchdog deadline exactly like the simulated
    allgather."""
    _check_mode(mode)
    from ..reliability import watchdog as _watchdog
    from ..reliability.faults import FAULTS

    def _exchange():
        FAULTS.fault_point("collectives.hist_exchange")
        world = len(per_shard_hists)
        stack = np.stack([np.asarray(a, dtype=np.float32)
                          for a in per_shard_hists])
        if mode == "f32":
            for a in per_shard_hists:
                _note_collective("hist_exchange", a)
            return np.sum(stack, axis=0)
        bits = 16 if mode == "q16" else 8
        qmax = (2 ** (bits - 1) - 1) // world
        if qmax < 1:
            raise ValueError(
                f"hist_exchange={mode}: world size {world} leaves no "
                f"quantization levels inside int{bits}")
        npdt = np.int16 if mode == "q16" else np.int8
        delta = np.concatenate(
            [stack[..., :1, :], np.diff(stack, axis=-2)], axis=-2)
        amax = np.max(np.abs(delta), axis=(0, -2), keepdims=True)[0]
        # exact-integer fast path (see exchange_histograms): integral
        # channels that fit qmax ship verbatim on the unit grid
        frac = np.max(np.abs(delta - np.round(delta)), axis=(0, -2),
                      keepdims=True)[0]
        exact = (frac == 0) & (amax <= qmax)
        denom = np.where(exact, np.float32(qmax),
                         np.maximum(amax, np.float32(1e-30)))
        q = np.clip(np.round(delta / denom * qmax),
                    -qmax, qmax).astype(npdt)
        stat = np.concatenate([amax, frac], axis=-2)
        for s in range(world):
            _note_collective("hist_exchange", q[s])
            _note_collective("hist_exchange_scale", stat)
        qsum = np.sum(q.astype(np.int32), axis=0)
        deq = qsum.astype(np.float32) * (denom / np.float32(qmax))
        return np.cumsum(deq, axis=-2, dtype=np.float32)

    return _watchdog.run_with_deadline(
        _exchange, _watchdog.deadline("collective"),
        phase="host_collective", seam="collectives.hist_exchange")


class ExternalCollectives(HostCollectives):
    """User-injected reduce-scatter/allgather callables — the direct
    analog of LGBM_NetworkInitWithFunctions (reference c_api.h:760-762,
    network.h:96).  Callables receive and return numpy arrays; used by
    embedders that bring their own transport."""

    def __init__(self, num_machines: int, rank: int,
                 reduce_scatter_fn: Optional[Callable] = None,
                 allgather_fn: Optional[Callable] = None):
        super().__init__(shards=num_machines)
        self.external_rank = rank
        self.reduce_scatter_fn = reduce_scatter_fn
        self.allgather_fn = allgather_fn

    def simulate_reduce_scatter(self, per_shard_arrays, axis: int = 0):
        if self.reduce_scatter_fn is None:
            return super().simulate_reduce_scatter(per_shard_arrays, axis)
        return self.reduce_scatter_fn(per_shard_arrays)

    def simulate_allgather(self, per_shard_arrays, axis: int = 0):
        if self.allgather_fn is None:
            return super().simulate_allgather(per_shard_arrays, axis)
        return self.allgather_fn(per_shard_arrays)


_external: Optional[ExternalCollectives] = None


def install_external(num_machines: int, rank: int,
                     reduce_scatter_fn: Optional[Callable] = None,
                     allgather_fn: Optional[Callable] = None) -> None:
    """Install a process-global external backend (the
    LGBM_NetworkInitWithFunctions seam, exposed via capi.py)."""
    global _external
    _external = ExternalCollectives(num_machines, rank,
                                    reduce_scatter_fn, allgather_fn)


def external() -> Optional[ExternalCollectives]:
    return _external
