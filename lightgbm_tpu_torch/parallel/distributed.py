"""Multi-process ingestion + rendezvous: the tcp plane and the
row-sharded device plane.

Port of lightgbm_tpu/parallel/distributed.py, the redesign of the
reference's distributed loading protocol (reference:
src/io/dataset_loader.cpp:424-456 row partitioning, :523-605 +
:828-886 distributed bin finding with mapper allgather):

  * Rendezvous: :func:`initialize`.  ``collective_transport=tcp``
    builds the host-side TCP transport (parallel/transport.py);
    ``collective_transport=xla`` (``auto`` on the card) joins a
    ``torch.distributed`` process group, the port's counterpart of
    ``jax.distributed.initialize``: NCCL across cards (one card a
    rank, the ``torchrun`` idiom), gloo on the CPU, plus a second gloo
    group that carries the host arrays (samples, metadata, the step
    wall monitor), so numpy never round-trips through a card.  The
    coordinator address plays mlist.txt's role.
  * Distributed bin finding.  tcp: every process collects the
    boundary candidates of ITS OWN row shard (sharded/binfind.py), the
    candidates are allgathered over the transport and merged in rank
    order.  xla: every process samples its own shard
    (:func:`sample_local_rows`, seed + 7919 * rank) and the samples are
    allgathered.  Either way every process fits bin mappers + EFB
    bundles from the identical combined sample.
  * Per-process binning, then :func:`finalize_global` gathers labels,
    weights and init scores in rank order.  tcp: the bin rows too, so
    every process holds the global matrix and runs the identical
    single-device program.  xla: the bins stay local — each process
    keeps only its own rows on its own devices, the grower's data
    learner histograms them there and the histograms cross processes
    under the ``hist_exchange`` codec (parallel/collectives.py).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..config import Config
from ..utils.log import Log


class DevicePlane:
    """The ``collective_transport=xla`` plane of this process: the
    torch.distributed process group :func:`initialize` joined, its
    backend, this rank's device (the first of its local devices, the
    one its collectives run on), and the gloo group that carries host
    arrays (the default group itself when that is gloo)."""

    def __init__(self, backend: str, rank: int, world: int, device,
                 host_group):
        self.backend = backend
        self.rank = rank
        self.world = world
        self.device = device
        self.host_group = host_group

    def local_devices(self, n: int) -> list:
        """This rank's ``n`` local devices, from its own: ``n`` CPU
        shards on the CPU, else the cards that follow its own (modulo
        the visible cards)."""
        import torch
        if self.device.type != "cuda":
            return [self.device] * n
        count = torch.cuda.device_count()
        return [torch.device("cuda", (self.device.index + i) % count)
                for i in range(n)]

    def close(self) -> None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


_plane: Optional[DevicePlane] = None


def plane() -> Optional[DevicePlane]:
    """The active device plane, None without one."""
    return _plane


def shutdown() -> None:
    """Leave the device plane (``jax.distributed.shutdown``): destroys
    its process groups.  A no-op without one."""
    global _plane
    if _plane is not None:
        _plane.close()
        _plane = None


def _launcher_env(coordinator_address, num_processes, process_id):
    """Fill what the caller left out from a launcher's environment
    (``torchrun``: MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK)."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    return coordinator_address, num_processes, process_id


def _bind_device(device_name: str, rank: int, n_local: int = 1):
    """This rank's device: ``cuda:(local rank x n_local % visible
    cards)`` for ``device=cuda`` (LOCAL_RANK from a launcher, else the
    rank; ``n_local`` the row shards a rank holds, on the cards from
    this one on), the CPU for ``device=cpu``."""
    import torch
    if str(device_name).lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "collective_transport=xla with device='cuda' but no CUDA "
            "device is available; pass device='cpu' (gloo) to run the "
            "plane on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda", local * n_local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _card_identity(dev) -> str:
    """A string naming ``dev``'s physical card across processes: its
    UUID where torch reports one, else the host and the index."""
    import socket

    import torch
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    if uuid is not None:
        return str(uuid)
    return f"{socket.gethostname()}:{dev.index}"  # pragma: no cover


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               config: Optional[Config] = None,
               backend: Optional[str] = None) -> None:
    """Join the multi-process rendezvous (reference Network::Init +
    Linkers ctor): every process passes the coordinator's ``host:port``,
    the world size and its own rank (a launcher's MASTER_ADDR/
    MASTER_PORT, WORLD_SIZE and RANK fill what is left out).

    ``Config.collective_transport`` selects the plane
    (parallel/transport.py resolve_transport_mode): ``tcp`` builds the
    host-side TCP transport; ``xla`` joins a torch.distributed process
    group with ``init_method=tcp://<coordinator_address>``.  Its
    ``backend`` is torch's own argument: ``nccl`` for ``device=cuda``
    and ``gloo`` for ``device=cpu`` unless given (gloo over CUDA
    tensors runs several ranks on one card).  Each rank binds
    ``cuda:(local rank x L % visible cards)``, L the row shards a rank
    holds under ``config.mesh_shape`` (parallel/mesh.py local_shards),
    and its shards go on the L cards from there; under NCCL two ranks
    bound to one card raise before NCCL runs.  The rendezvous timeout is
    ``time_out`` minutes.

    Transient rendezvous failures (coordinator still starting, port in
    TIME_WAIT) retry with bounded backoff under the config's retry
    policy and the reference ``time_out`` budget — the
    ``distributed.init`` seam in the fault harness.  A world of one
    process needs no plane and returns at once."""
    from ..reliability.faults import FAULTS
    from ..reliability.retry import RetryPolicy, retry_call
    from ..telemetry import TELEMETRY
    from . import transport as _transport

    coordinator_address, num_processes, process_id = _launcher_env(
        coordinator_address, num_processes, process_id)
    mode = _transport.resolve_transport_mode(config, num_processes)
    world = int(num_processes or 1)
    if world <= 1:
        TELEMETRY.mark_sync("rendezvous")
        return
    if coordinator_address is None or process_id is None:
        raise ValueError(
            f"collective_transport={mode} needs an explicit "
            "coordinator_address, num_processes and process_id (or a "
            "launcher's MASTER_ADDR, WORLD_SIZE and RANK)")
    rank = int(process_id)
    if mode == "tcp":
        def _init():
            FAULTS.fault_point("distributed.init")
            return _transport.TcpTransport.create(
                coordinator_address, world, rank, config=config)
    else:
        if _plane is not None:
            raise RuntimeError("the device plane is already initialized; "
                               "call parallel.distributed.shutdown() first")
        device_name = str(getattr(config, "device", "cuda"))
        be = backend or ("gloo" if device_name.lower() == "cpu"
                         else "nccl")

        from .mesh import local_shards
        n_local = local_shards(config, world) if config is not None else 1

        def _init():
            import datetime

            import torch.distributed as dist
            FAULTS.fault_point("distributed.init")
            dev = _bind_device(device_name, rank, n_local)
            minutes = float(getattr(config, "time_out", 120) or 120)
            timeout = datetime.timedelta(minutes=minutes)
            dist.init_process_group(
                be, init_method=f"tcp://{coordinator_address}",
                world_size=world, rank=rank, timeout=timeout)
            host = None if be == "gloo" else dist.new_group(
                backend="gloo", timeout=timeout)
            return DevicePlane(be, rank, world, dev, host)

    if config is None:
        policy = RetryPolicy()
    else:
        policy = RetryPolicy.from_config(config)
        policy.budget_s = config.time_out * 60.0
    got = retry_call(_init, seam="distributed.init", policy=policy)
    if mode == "tcp":
        _transport.install(got)
    else:
        _install_plane(got)
    # the rendezvous barrier exits near-simultaneously on every host:
    # mark it as the clock-sync anchor the cross-host trace merge
    # aligns shards on
    TELEMETRY.mark_sync("rendezvous")


def _install_plane(p: DevicePlane) -> None:
    """Make ``p`` the active plane; under NCCL, first check over the
    host group that no two ranks share a card (NCCL refuses that, with
    an error that does not say why)."""
    global _plane
    if p.backend == "nccl":
        import torch.distributed as dist
        ids = [None] * p.world
        dist.all_gather_object(ids, _card_identity(p.device),
                               group=p.host_group)
        if len(set(ids)) < len(ids):
            p.close()
            raise RuntimeError(
                f"collective_transport=xla over NCCL maps two ranks to "
                f"one card ({ids}); NCCL needs one card a rank — give "
                "every rank its own card, or pass backend='gloo' to run "
                "several ranks on one card")
    _plane = p


def sample_local_rows(local_data: np.ndarray, sample_cnt: int,
                      seed: int) -> np.ndarray:
    """FIXED-SIZE (sample_cnt, F+1) row sample of this host's shard:
    the collective requires identical shapes on every process, so
    shards smaller than the quota pad with rows whose trailing
    validity column is 0 (dropped after the gather).  Each host uses a
    DIFFERENT derived seed so the combined sample isn't biased toward
    identical row positions."""
    n, f = local_data.shape
    rng = np.random.RandomState(seed + 7919 * _process_index())
    out = np.zeros((sample_cnt, f + 1), dtype=np.float64)
    take = min(n, sample_cnt)
    if n <= sample_cnt:
        out[:take, :f] = np.asarray(local_data, dtype=np.float64)
    else:
        idx = rng.choice(n, size=sample_cnt, replace=False)
        idx.sort()
        out[:, :f] = np.asarray(local_data[idx], dtype=np.float64)
    out[:take, f] = 1.0
    return out


def _allgather(arr: np.ndarray) -> np.ndarray:
    """Host collective backend call — the ``collectives.allgather``
    fault seam every gather in this module routes through; returns the
    stacked (P, *shape) array in rank order (a (1, *shape) stack in a
    single process).

    Deliberately NO per-host retry: collectives are entered in
    lockstep by every process, so one host re-entering alone would
    either hang (no peer joins its retry) or pair with a peer's NEXT
    collective and gather mismatched data.  A failed collective fails
    the job loudly; recovery is job restart + checkpoint resume.

    The call BLOCKS the host, so its wall is a true fenced collective
    latency: counted in ``collective_host_allgather_bytes`` and
    observed into the ``collective_host_allgather_ms`` histogram — and,
    with ``watchdog_collective_s`` armed, deadline-bounded: a gather
    wedged past the deadline dumps all-thread stacks and raises a
    classified ``StallError``."""
    import time

    from ..reliability import watchdog as _watchdog
    from ..reliability.faults import FAULTS
    from ..telemetry import TELEMETRY as tm

    def _gather() -> np.ndarray:
        FAULTS.fault_point("collectives.allgather")
        from . import transport as _transport
        tp = _transport.active()
        if tp is not None:
            # host-side TCP plane: the Bruck allgather returns the
            # stacked (P, *shape) array
            return tp.allgather(arr)
        if _plane is not None:
            return _plane_allgather(arr)
        return np.asarray(arr)[None]

    t0 = time.perf_counter() if tm.on else 0.0
    with tm.span("collective_allgather"):
        out = _watchdog.run_with_deadline(
            _gather, _watchdog.deadline("collective"),
            phase="host_collective", seam="collectives.allgather")
    if tm.on:
        # bytes as a counter; latency ONLY as the histogram (a
        # same-named counter would collide with the histogram family in
        # the Prometheus exposition)
        tm.add("collective_host_allgather_bytes", int(out.nbytes))
        tm.observe("collective_host_allgather_ms",
                   (time.perf_counter() - t0) * 1e3)
    return out


def _plane_allgather(arr) -> np.ndarray:
    """The device plane's host allgather: ``arr``'s bytes gathered over
    the gloo host group (any dtype — gloo has no int16 — and no card
    on the way), stacked (P, *shape) in rank order.  Every rank passes
    the same shape and dtype, as ``process_allgather`` requires."""
    import torch
    import torch.distributed as dist
    a = np.ascontiguousarray(arr)
    flat = torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
    parts = [torch.empty_like(flat) for _ in range(_plane.world)]
    dist.all_gather(parts, flat, group=_plane.host_group)
    return np.stack([p.numpy().view(a.dtype).reshape(a.shape)
                     for p in parts])


def allgather_samples(local_sample: np.ndarray) -> np.ndarray:
    """(S, F+1) per-host padded sample -> (sum valid, F) combined
    sample, identical on every host."""
    gathered = _allgather(local_sample)
    flat = gathered.reshape(-1, local_sample.shape[1])
    valid = flat[:, -1] > 0.5
    return flat[valid, :-1]


def construct_sharded(local_data: np.ndarray, label=None, weight=None,
                      group=None, config: Optional[Config] = None,
                      categorical_features: Optional[Sequence[int]] = None,
                      feature_names: Optional[Sequence[str]] = None):
    """Build THIS PROCESS's shard of the distributed dataset: mappers
    and EFB bundles are fitted from the globally merged sample (equal
    on every process), then only the local rows are binned.

    Returns a core Dataset whose ``group_bins`` holds N_local rows;
    :func:`finalize_global` turns it into the global training view."""
    from ..dataset import Dataset as CoreDataset
    from ..dataset import split_sample_columns
    from . import transport as _transport
    config = config or Config()
    local_data = np.asarray(local_data, dtype=np.float64)
    tp = _transport.active()
    if tp is not None and tp.world_size > 1:
        # TCP plane: this process's candidates (sharded.binfind seam)
        # gather over the transport and merge in rank order, so the
        # fitted mappers equal the in-process sharded fit (and, quotas
        # permitting, a single-host whole-data fit)
        from ..sharded import binfind
        cand = binfind.collect_candidates(local_data, config,
                                          tp.rank, tp.world_size)
        sample_vals, sample_rows, total = \
            binfind.gather_merge_remote(cand, tp)
    else:
        # the device plane (JAX distributed.py:200-216): each rank's
        # fixed-size sample of its own rows, gathered over the host
        # group; one process gathers only its own
        local_sample = sample_local_rows(
            local_data, max(1, config.bin_construct_sample_cnt //
                            max(1, _num_processes())),
            config.data_random_seed)
        combined = allgather_samples(local_sample)
        sample_vals, sample_rows = split_sample_columns(combined)
        total = combined.shape[0]
    ds = CoreDataset.from_sampled_columns(
        sample_vals, sample_rows, total,
        local_data.shape[0], config=config,
        categorical_features=categorical_features,
        feature_names=feature_names)
    ds.push_rows(local_data, 0)
    ds.finish_load()
    if label is not None:
        ds.metadata.set_label(np.asarray(label))
    ds.metadata.set_weight(weight)
    ds.metadata.set_group(group)
    return ds


def finalize_global(ds):
    """Promote a per-process shard dataset (construct_sharded) into the
    GLOBAL training view (JAX distributed.py:234-291): labels, weights
    and init scores are allgathered into global row order (rank 0's
    rows, then rank 1's, ...) and ``num_data`` becomes the global count.

    tcp plane: the bin rows are gathered too — every process holds all
    (N_local, C) bin shards in rank order (row-wise concat is
    layout-safe for every bin_packing: packing is per-row) and runs the
    IDENTICAL deterministic single-device training program; memory is
    the full matrix per process (the tcp plane's scaling bound).

    Device plane: ``group_bins`` stays THIS process's rows, marked with
    ``_mh_local_rows`` and ``_multihost``; the grower pads them to whole
    chunks and splits them over this rank's devices, and the data
    learner exchanges histograms across processes (the redesign of reference
    data_parallel_tree_learner.cpp:117-246, where each machine trains
    on its shard and histograms are reduce-scattered).

    Both refuse what the JAX package refuses: unequal shards, and query
    groups (queries would span hosts)."""
    from ..dataset import Metadata
    from . import transport as _transport
    nproc = _num_processes()
    if nproc <= 1:
        return ds
    n_local = ds.num_data
    counts = _allgather(np.array([n_local], dtype=np.int64)).ravel()
    if not (counts == counts[0]).all():
        Log.fatal("multi-host training requires equal row shards per "
                  f"host, got {counts.tolist()} — pad the tail shard")
    if ds.metadata.query_boundaries is not None:
        Log.fatal("multi-host ranking (query groups) is not supported "
                  "yet — queries must not span hosts")
    n_global = int(counts.sum())
    md = Metadata(n_global)
    md.label = _allgather(
        np.ascontiguousarray(ds.metadata.label)).reshape(-1) \
        .astype(np.float32)
    if ds.metadata.weight is not None:
        md.weight = _allgather(
            np.ascontiguousarray(ds.metadata.weight)).reshape(-1) \
            .astype(np.float32)
    if ds.metadata.init_score is not None:
        # init_score is class-major per host ((K, n_local) flattened);
        # a naive concat would interleave hosts inside classes
        init_l = np.ascontiguousarray(ds.metadata.init_score)
        k = max(1, len(init_l) // n_local)
        gathered = _allgather(init_l).reshape(nproc, k, n_local)
        md.init_score = np.transpose(gathered, (1, 0, 2)).reshape(-1)
    ds.metadata = md
    tp = _transport.active()
    if tp is not None and tp.world_size > 1:
        bins = _allgather(np.ascontiguousarray(ds.group_bins))
        ds.group_bins = np.ascontiguousarray(
            bins.reshape(-1, bins.shape[-1]))
        ds.num_data = n_global
        ds._pushed_rows = n_global
        return ds
    ds._mh_local_rows = n_local
    ds._multihost = True
    ds.num_data = n_global
    return ds


def _num_processes() -> int:
    """World size as the ACTIVE plane sees it: the tcp transport's (a
    degraded or elastically-grown world included), else the device
    plane's process group, else 1."""
    from . import transport as _transport
    tp = _transport.active()
    if tp is not None:
        return tp.world_size
    if _plane is not None:
        return _plane.world
    return 1


def _process_index() -> int:
    """This process's rank in the active world (elastic re-joins get
    FRESH ranks, and the sampling seams derive their seeds from the
    rank actually held): the tcp transport's, else the device plane's,
    else 0."""
    from . import transport as _transport
    tp = _transport.active()
    if tp is not None:
        return tp.rank
    if _plane is not None:
        return _plane.rank
    return 0
