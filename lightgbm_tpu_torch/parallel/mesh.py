"""Device mesh construction and the sharding policy of the parallel
learners.

Port of lightgbm_tpu/parallel/mesh.py.  The JAX package expresses
parallelism as shardings over a ``jax.sharding.Mesh`` and lets XLA
insert the collectives; here a mesh is an array of torch devices and the
grower runs each shard's part on its own device:

  * ``data`` learner — rows sharded (DataParallelTreeLearner,
    data_parallel_tree_learner.cpp): each shard histograms ITS row
    range on its device and the shards' histograms are summed under
    the ``hist_exchange`` codec (parallel/collectives.py
    exchange_histograms), the reference's per-pass ReduceScatter of
    partial histograms (:147-162).
  * ``voting`` learner — rows sharded as for ``data``; each shard
    votes its top_k features per leaf and only the globally top
    2*top_k features' histograms are summed
    (voting_parallel_tree_learner.cpp).
  * ``feature`` learner — rows replicated, the bin matrix's group
    COLUMNS partitioned over the mesh (the vertical partition,
    feature_parallel_tree_learner.cpp): each shard histograms and
    searches its own groups and only the per-leaf SplitInfo election
    crosses shards.

A mesh may have several axes (``mesh_shape=(2, 2)``, ``mesh_axes=
("data", "feature")``): rows shard over the ``data`` axis whenever it is
present, whatever the learner, and the other axes replicate (JAX
mesh.py:97), so a shard's work runs once, on the shard's device at
index 0 of the other axes.

Mesh devices: with ``device=cuda`` the visible cards; with
``device=cpu`` ``CPU_MESH_DEVICES`` CPU shards, the counterpart of the
JAX tests' eight virtual CPU devices (tests/conftest.py), so a CPU
mesh runs every shard's work in this process, one after the other.

Multi-process training on the tcp plane (parallel/transport.py) needs
no mesh: every process runs the single-device program on the
replicated bins (parallel/distributed.py finalize_global).  On the
device plane (``collective_transport=xla``, torch.distributed) the mesh
spans the world on the row axis (JAX mesh.py:69-81, ``multihost``):
``world x L`` row shards, rank r holding shards r*L ... r*L+L-1 on its
L local devices (the JAX mesh over ``jax.devices()``, process-major).
Each process holds only its own rows, and its policy knows only its own
devices and row ranges.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils.log import Log

DATA_AXIS = "data"
FEATURE_AXIS = "feature"

#: CPU shards a ``device=cpu`` mesh may hold (JAX's virtual devices)
CPU_MESH_DEVICES = 8


class Mesh:
    """A mesh of torch devices: ``devices`` an object array of
    ``shape``, one name per axis (the slice of ``jax.sharding.Mesh``
    the grower reads)."""

    def __init__(self, devices: Sequence[torch.device],
                 shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        arr = np.empty(len(devices), dtype=object)
        arr[:] = list(devices)
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def mesh_devices(device=None) -> List[torch.device]:
    """The devices a mesh may take: the visible cards, or the CPU's
    virtual shards."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cpu":
        return [torch.device("cpu")] * CPU_MESH_DEVICES
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def build_mesh(config: Config, device=None) -> Optional[Mesh]:
    """Build the training mesh from config (``mesh_shape``/``mesh_axes``,
    or every device of ``device``'s kind on one axis: the ``feature``
    axis for the feature learner, else ``data``), None for a serial
    run.  Like the JAX package: a ``mesh_shape`` needing more devices
    than there are warns and trains serial, and a parallel learner on
    one device trains serial (config.py:1106-1108)."""
    from .distributed import plane
    pl = plane()
    if pl is not None and pl.world > 1:
        return _world_mesh(config, pl)
    if config.tree_learner == "serial" and not config.mesh_shape:
        return None
    devices = mesh_devices(device if device is not None
                           else getattr(config, "device", "cuda"))
    if config.mesh_shape:
        shape = tuple(int(s) for s in config.mesh_shape)
        axes = tuple(config.mesh_axes) or (DATA_AXIS,)
        if len(axes) != len(shape):
            raise ValueError(f"mesh_axes {axes} must name each of the "
                             f"{len(shape)} axes of mesh_shape {shape}")
        n = int(np.prod(shape))
        if n > len(devices):
            Log.warning(f"mesh_shape {shape} needs {n} devices, have "
                        f"{len(devices)}; falling back to serial")
            return None
        if n == 1:
            return None
        return Mesh(devices[:n], shape, axes)
    if len(devices) <= 1:
        return None
    axis = FEATURE_AXIS if config.tree_learner == "feature" else DATA_AXIS
    return Mesh(devices, (len(devices),), (axis,))


def local_shards(config: Config, world: int) -> int:
    """Row shards a rank of a ``world``-process device plane holds: the
    row axis of ``mesh_shape`` over the world (1 without a
    ``mesh_shape``)."""
    shape = tuple(int(s) for s in config.mesh_shape)
    axes = tuple(config.mesh_axes) or (DATA_AXIS,)
    if not shape or len(axes) != len(shape):
        return 1        # _world_mesh refuses a mismatch when it builds
    row = DATA_AXIS if DATA_AXIS in axes else axes[0]
    return max(1, shape[axes.index(row)] // max(1, world))


def _world_mesh(config: Config, pl) -> Optional[Mesh]:
    """The device plane's mesh: ``world x L`` devices on the row axis,
    rank r's L row shards on its local devices (a JAX mesh over
    ``jax.devices()``, whose devices are process-major).  Other axes
    replicate, as in a single process, onto the row shard's device;
    the other ranks' entries stand in as this rank's first device (a
    rank runs only its own shards).  None for the serial learner with
    no ``mesh_shape``, as in the JAX package (whose grower then cannot
    place a multi-host dataset: the grower raises).  The feature
    learner's vertical partition has no multi-host placement in the
    JAX package (JAX mesh.py place_bins :115-126): it raises, and so
    does a row axis that is not a whole number of shards a rank or
    follows a wider axis (the ranks' row blocks would not be the
    mesh's)."""
    if config.tree_learner == "feature":
        raise NotImplementedError(
            "tree_learner=feature on the device plane "
            "(collective_transport=xla): its vertical partition has no "
            "multi-process placement (the JAX package's place_bins has "
            "no multi-host branch either); use tree_learner=data or "
            "voting")
    if config.tree_learner == "serial" and not config.mesh_shape:
        return None
    shape = tuple(int(s) for s in config.mesh_shape) or (pl.world,)
    axes = tuple(config.mesh_axes) or (DATA_AXIS,)
    if len(axes) != len(shape):
        raise ValueError(f"mesh_axes {axes} must name each of the "
                         f"{len(shape)} axes of mesh_shape {shape}")
    row = DATA_AXIS if DATA_AXIS in axes else axes[0]
    k = axes.index(row)
    if shape[k] % pl.world or any(s > 1 for s in shape[:k]):
        raise NotImplementedError(
            f"mesh_shape {shape} over a device plane of {pl.world} "
            f"processes: the row axis {row!r} must hold a whole number "
            "of shards a rank and come before every other axis wider "
            "than one device")
    n_local = shape[k] // pl.world
    mine = pl.local_devices(n_local)
    lo = pl.rank * n_local
    devices = [mine[idx[k] - lo] if lo <= idx[k] < lo + n_local
               else mine[0] for idx in np.ndindex(*shape)]
    return Mesh(devices, shape, axes)


class ShardingPolicy:
    """Per-learner sharding decisions, consumed by the grower (JAX
    mesh.py ShardingPolicy).  The JAX ``row_spec`` is ``row_axis`` and,
    once the grower has padded the rows, ``row_ranges``: one (start,
    stop) a row shard in JAX's layout (rows in order, the pad at the
    tail), the shard on ``row_devices[i]``.  The JAX ``bins_spec`` (the
    feature learner's vertical partition) is ``feature_axis``."""

    def __init__(self, config: Config, mesh: Optional[Mesh]):
        from ..telemetry import TELEMETRY
        from .distributed import _num_processes, _process_index, plane
        self.mesh = mesh
        self.learner = config.tree_learner
        # processes of the active world (the tcp plane's or the device
        # plane's, else 1); on the device plane the mesh spans the
        # processes (JAX mesh.py:69-81): ``multihost``, each process
        # holding only its own row shard.  A tcp mesh is one process's
        self.nproc = _num_processes()
        self.rank = _process_index()
        self.plane = plane()
        self.multihost = (mesh is not None and self.plane is not None
                          and self.nproc > 1)
        self.row_ranges: Optional[List[Tuple[int, int]]] = None
        self.row_axis: Optional[str] = None
        self.feature_axis: Optional[str] = None
        if mesh is not None:
            axes = mesh.axis_names
            if self.learner in ("data", "voting") or DATA_AXIS in axes:
                self.row_axis = DATA_AXIS if DATA_AXIS in axes else axes[0]
            elif self.learner == "feature":
                self.feature_axis = (FEATURE_AXIS if FEATURE_AXIS in axes
                                     else axes[0])
        if TELEMETRY.on and mesh is not None:
            # topology gauges: a scraped metrics page should say what
            # fabric the run is on without reading logs
            TELEMETRY.gauge("mesh_devices", int(mesh.size))
            TELEMETRY.gauge("mesh_hosts", int(self.nproc))
            TELEMETRY.gauge("mesh_axes",
                            ",".join(f"{a}={n}" for a, n in
                                     mesh.shape.items()))

    def set_rows(self, n_padded: int) -> None:
        """Lay ``n_padded`` rows over the row axis: shard s of d holds
        rows [s * n_padded / d, (s + 1) * n_padded / d).  Multi-host,
        ``row_ranges`` holds this rank's L shards only, in the
        coordinates of its own block (rank r's shard r*L + i at rows
        [i * per, (i + 1) * per) of the rows it holds)."""
        if self.row_axis is None:
            return
        d = self.mesh.shape[self.row_axis]
        if n_padded % d:
            raise ValueError(f"{n_padded} padded rows do not divide over "
                             f"{d} mesh devices")
        per = n_padded // d
        n = d // self.nproc if self.multihost else d
        self.row_ranges = [(s * per, (s + 1) * per) for s in range(n)]

    @property
    def devices(self) -> List[torch.device]:
        return list(self.mesh.devices.ravel())

    @property
    def row_devices(self) -> List[torch.device]:
        """The row shards' devices: along the row axis, at index 0 of
        every other axis (the replicas there would repeat the work).
        Multi-host, this rank's shards' devices (its local devices)."""
        k = self.mesh.axis_names.index(self.row_axis)
        arr = np.moveaxis(self.mesh.devices, k, 0)
        devs = list(arr.reshape(arr.shape[0], -1)[:, 0])
        if self.multihost:
            n = len(devs) // self.nproc
            devs = devs[self.rank * n:(self.rank + 1) * n]
        return devs

    def place_rows(self, arr) -> List[torch.Tensor]:
        """Split a row-indexed tensor or array ((N,) or (N, ...)) into
        the shards' row ranges, each on its device.  Multi-host, ``arr``
        holds this rank's rows already (the layout the grower and the
        booster keep), split over its shards."""
        t = torch.as_tensor(arr)
        return [t[lo:hi].to(dev) for (lo, hi), dev
                in zip(self.row_ranges, self.row_devices)]

    def local_slice(self, arr, axis: int = 0):
        """This rank's rows of an ASSEMBLED global row array (rank r's
        rows at [r * N / nproc, (r + 1) * N / nproc) along ``axis``;
        JAX mesh.py _local_slice :234-241); the array itself in a
        single process."""
        if not self.multihost:
            return arr
        per = arr.shape[axis] // self.nproc
        idx = [slice(None)] * arr.ndim
        idx[axis] = slice(self.rank * per, (self.rank + 1) * per)
        return arr[tuple(idx)]

    def collectives(self):
        """The row axis's collectives: over the device plane's processes
        (each passing its local shards) multi-host, else over the
        in-process shards."""
        from .collectives import Collectives, ProcessGroupCollectives
        if self.multihost:
            return ProcessGroupCollectives(self.plane,
                                           len(self.row_devices))
        return Collectives(self.row_axis)

    def place_row_shards(self, shard_arrays, n_padded: int, device=None):
        """A sharded construction's bins (JAX mesh.py:144-215):
        ``shard_arrays`` are the participants' row blocks in row order
        (arrays or read-only memmaps; multi-host, this rank's rows and
        ``n_padded`` its padded block, JAX mesh.py place_local_rows
        :122-135).  On a row mesh, each device's
        (n_padded / d)-row block is filled from the blocks it overlaps
        (the rest is the zero tail pad) straight on its device, so the
        host never holds the concatenated matrix: returns the
        per-device list.  With no row axis, the blocks are
        concatenated, and padded, on ``device``: returns that one
        (n_padded, cols) tensor."""
        from ..utils.device import copy_rows, rows_to_device
        n = sum(int(a.shape[0]) for a in shard_arrays)
        if n > n_padded:
            raise ValueError(f"shards hold {n} rows > n_padded "
                             f"{n_padded}")
        ranges = self.row_ranges or [(0, n_padded)]
        devs = (self.row_devices if self.row_ranges is not None
                else [torch.device(device)])
        starts = np.cumsum([0] + [int(a.shape[0]) for a in shard_arrays])
        out = []
        for (lo, hi), dev in zip(ranges, devs):
            # (block, its first row, the overlap's end) of every block
            # this range overlaps
            parts = [(a, int(starts[i]), min(hi, int(starts[i + 1])))
                     for i, a in enumerate(shard_arrays)
                     if max(lo, int(starts[i])) < min(hi, int(starts[i + 1]))]
            if len(parts) == 1 and parts[0][1] <= lo:
                # one block covers the range's head: one upload, padded
                a, st, e = parts[0]
                out.append(rows_to_device(a[lo - st:e - st], dev, hi - lo))
                continue
            block = torch.zeros((hi - lo,) + tuple(shard_arrays[0].shape[1:]),
                                dtype=torch.uint8, device=dev)
            for a, st, e in parts:
                s = max(lo, st)
                copy_rows(block[s - lo:e - lo], a[s - st:e - st])
            out.append(block)
        return out if self.row_ranges is not None else out[0]

    def gather_rows(self, parts: Sequence[torch.Tensor],
                    device) -> torch.Tensor:
        """The shards' row ranges concatenated in order on ``device``.
        Multi-host, this rank's shards alone: no process gathers
        another's rows."""
        return torch.cat([p.to(device) for p in parts])

    @property
    def num_shards(self) -> int:
        return 1 if self.mesh is None else self.mesh.size
