"""Leaf-wise tree growth: the serial learner on one device and the
data, voting and feature learners on a mesh.

Port of lightgbm_tpu/learner/grower.py for the serial learner's
single-device kernel plans and the parallel learners.
:func:`resolve_plan` picks the plan the JAX grower picks for the same
config and data (grower.py:318-543, with CUDA in the role of the TPU
check); all eleven of them run here:

  fused_tiled     quantized int8 gradients: kernel A routes last
                  round's splits and histograms the new leaves in one
                  pass from the transposed bins; kernel B routes the
                  last splits at exit and returns each row's leaf value
  q_tiled(split_route)
                  (hist_split_route) kernel H routes last round's
                  splits in its own pass, then kernel G histograms the
                  new leaves from the transposed bins; B at exit
  seg_tiled(leaf_partition)
                  (hist_leaf_partition=on) kernel H routes, the rows
                  are regrouped by leaf into 512-row blocks
                  (ops/partition.py build_leaf_partition), and kernel J
                  histograms the new leaves' blocks; B at exit
  q_tiled         (hist_fused_route=false) kernel G histograms; the
                  splits are applied every round (apply_splits)
  fused_streamed  kernel D does the same from the streamed bin one-hot
                  (f32 or int8 weights); kernel B again at exit
  q_onthefly      (int8, hist_kernel_tiled=false, no fused route)
                  kernel I histograms the row-major bins: its q_packed
                  entry up to 126 slots, pallas_q beyond; splits
                  applied every round
  pre_onehot      kernel E histograms the streamed one-hot (its
                  pre_packed entry up to 126 slots, pre beyond); the
                  splits are applied every round (apply_splits)
  pallas(quantized)
                  (q_onthefly's knobs without the on-the-fly flag and
                  the one-hot over budget) kernel I's pallas_q entry;
                  splits applied every round
  pallas          kernel F histograms the row-major bins with f32
                  weights; splits applied every round
  pallas_paired   (hist_kernel=paired) kernel K, F's function; splits
                  applied every round
  xla             (the default hist_compute_dtype=float32, or
                  hist_kernel=xla) the XLA one-hot contraction in torch
                  ops, no kernel; splits applied every round

Integer histograms make every int8 plan grow the same trees as
fused_tiled, whichever kernel built them.

The JAX grower runs a tree as one ``lax.while_loop`` over frontier
rounds; here the loop is driven from the host, one round at a time, and
each round

  1. refreshes the leaves created last round: the round's histogram
     kernel builds the histograms of the new right children (routing
     the pending splits first on the fused plans); each left child is
     parent minus right (the reference's subtraction trick,
     serial_tree_learner.cpp:505-507), or, when the histogram cache
     exceeds ``histogram_pool_size``, histogrammed directly in a second
     pass over the parent slots; the split finder runs on those new
     leaves only and caches their best candidates;
  2. splits every leaf whose cached candidate clears the gain bar,
     gain-ordered within the remaining leaf budget and the frontier
     width (the JAX grower's documented batched best-first order);
  3. builds the route table of the selected splits — applied lazily by
     the next round's fused kernel (or at exit), or at once by
     apply_splits on the other plans.

Because the loop runs on the host, the round knows how many leaves are
new (one small device-to-host read per round) and runs the finder on
exactly those, where the JAX grower pads to its strip ladder; the
results are the same, row by row.  Categorical features split by the
JAX finder's one-hot and sorted modes (their bin masks go into the
route table that kernels A, B and H read); forced splits
(``forcedsplits_filename``) take each forced leaf first, at its spec's
(feature, threshold).

The data learner (``tree_learner=data``, or a ``mesh_shape``, on a mesh
of more than one device: parallel/mesh.py) runs the xla plan, as the
JAX grower does on a mesh (grower.py:335-338): each shard keeps its row
range of the bins, its leaf ids and its weights on its own device and
histograms them there (compute_group_histograms, the JAX grower's
per-shard chunk rule), the shards' histograms are summed under the
``hist_exchange`` codec (parallel/collectives.py exchange_histograms;
the JAX grower's _hist_xla_rowsharded :817-866), and the splits are
found once, on the first shard's device, from that sum (every JAX shard
finds the same splits from the same sum).  Each shard then applies the
splits to its own rows; the leaf ids are gathered in row order only at
the end of the tree, and the scores stay one tensor on the first
shard's device.  The root's sums are each shard's sum added in shard
order.  Multi-host (the device plane, parallel/distributed.py), each
process is one shard: it holds only its own rows, padded to whole
chunks of the global row count, the histograms and root sums cross
processes (rank order), every rank finds the same splits, and the leaf
ids and scores stay local (no process gathers another's rows).

The voting and feature learners (parallel/mesh.py) grow a tree in
full-frontier rounds, as the JAX grower does on a mesh (grower.py
_round_voting :1855, _round_feature :1841): every round histograms and
searches every leaf, and splits the best of them, gain-ranked within
the leaf budget (``_select_frontier``: no frontier width, no forced
splits).  Voting: each row shard histograms its rows, runs the finders
with ``min_data_in_leaf`` and ``min_sum_hessian_in_leaf`` divided by
the mesh size and votes its top_k features a leaf; the votes are
summed, the global top 2*top_k features chosen, and only their
histograms summed across shards, on which the finders run again.
Feature (the vertical partition, when the mesh divides the groups and
the storage is byte-wide): each shard histograms all rows of its own
group columns, searches its own features, and the leaf's split is the
shards' best by gain (the lowest shard on a tie); the rows are routed
on the first device, from its full copy of the bins.  A feature learner
whose groups the mesh does not divide runs the serial rounds on the
xla plan, as the JAX package's constraint-sharded fallback does.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..ops.histogram import (PACKED_STRIP, QUANT_ROW_LIMIT, QUANT_WEIGHT_MAX,
                             SEG_BLOCK, _pick_chunk, bins_hist,
                             bins_hist_paired, compute_group_histograms,
                             compute_group_histograms_fused,
                             compute_group_histograms_fused_tiled,
                             compute_group_histograms_pallas_q,
                             compute_group_histograms_pre,
                             compute_group_histograms_pre_packed,
                             compute_group_histograms_q_packed,
                             compute_group_histograms_q_tiled,
                             compute_group_histograms_seg_tiled,
                             compute_leaf_totals, compute_root_totals,
                             expand_feature_histograms,
                             onehot_width, precompute_bin_onehot,
                             precompute_bin_onehot_packed,
                             quantize_gradients, route_apply_tiled,
                             route_only_tiled)
from ..ops.partition import (ROUTE_FIXED_COLS, apply_partition, apply_splits,
                             block_slots, build_leaf_partition,
                             build_route_table)
from ..ops.split import (CAND_COLS, CAND_DEFAULT_LEFT, CAND_FEATURE,
                         CAND_GAIN, CAND_LOUT, CAND_LSC, CAND_LSG, CAND_LSH,
                         CAND_CAT_DIR, CAND_ROUT, CAND_THRESHOLD,
                         FORCED_COLS, FORCED_DEFAULT_LEFT, FORCED_GAIN,
                         FORCED_LOUT, FORCED_LSC, FORCED_LSG, FORCED_LSH,
                         FORCED_ROUT, FORCED_THRESHOLD,
                         find_best_split_block, forced_split_block,
                         run_split_finders)
from ..packing import spec_crumb, spec_packed
from ..telemetry import TELEMETRY
from ..utils.log import Log

#: plans that route the pending splits in their own pass (kernel H)
#: before the histogram
_ROUTE_FIRST = ("q_tiled(split_route)", "seg_tiled(leaf_partition)")


@dataclass(frozen=True)
class KernelPlan:
    """The grower's resolved histogram plan (the JAX grower's flags)."""

    name: str                 # the JAX telemetry name (grower.py:592-605)
    quant: bool               # int8 quantized weights (use_quant)
    ohb_pack: int             # one-hot columns per stored byte
    fused: bool               # route inside the histogram pass (use_fused)
    tiled: bool               # use_tiled
    pre_ohb: bool             # streamed one-hot, no routing (use_pre_ohb)


def resolve_plan(config: Config, *, n_padded: int, num_groups: int,
                 max_group_bin: int, frontier: int, pack_P: int = 0,
                 quant_row_limit: int = QUANT_ROW_LIMIT,
                 single_device: bool = True) -> KernelPlan:
    """The histogram plan the JAX grower resolves for this config and
    data (lightgbm_tpu/learner/grower.py:318-543), warnings included.
    Its Pallas gate asks for a single TPU device; here the port's
    kernels run wherever the grower runs (CUDA, or their plain versions
    on the CPU), so the gate is one device (``single_device``: no mesh)
    and 1024-row padding.  Raises ValueError where the JAX grower does
    (hist_precision=tiered past the int32 row bound)."""
    hk = getattr(config, "hist_kernel", "auto")
    if hk not in ("auto", "pallas", "paired", "xla"):
        Log.warning(f"unknown hist_kernel={hk!r}; using 'auto'")
        hk = "auto"
    pallas_ok = single_device and n_padded % 1024 == 0
    if hk in ("pallas", "paired") and not pallas_ok:
        Log.warning(f"hist_kernel={hk} unavailable here (needs a single "
                    "device and 1024-row padding); falling back to the "
                    "XLA histogram path")
    use_pallas = pallas_ok and (
        hk in ("pallas", "paired")
        or (hk == "auto" and config.hist_compute_dtype == "bfloat16"))
    paired = use_pallas and hk == "paired"
    rows_ok = int(n_padded) <= quant_row_limit
    precision = str(getattr(config, "hist_precision", "auto")).lower()
    if precision == "tiered" and not rows_ok:
        raise ValueError(
            f"hist_precision=tiered: {int(n_padded)} rows can overflow the "
            f"int32 histogram accumulator (requires rows * "
            f"{QUANT_WEIGHT_MAX} < 2^31, i.e. <= {quant_row_limit} rows); "
            "use hist_precision=f32 or shard the rows")
    want_quant = bool(getattr(config, "quantized_grad", False)
                      or precision == "tiered")
    if precision == "f32":
        if want_quant:
            Log.warning("hist_precision=f32: quantized_grad ignored "
                        "— histograms accumulate float32")
        want_quant = False
    use_quant = use_pallas and not paired and want_quant and rows_ok
    if want_quant and use_pallas and not use_quant and not paired:
        Log.warning("quantized_grad disabled: dataset exceeds the int32 "
                    "histogram accumulator bound (~16.9M rows)")
    if precision == "tiered" and not use_quant:
        Log.warning("hist_precision=tiered unavailable here (the "
                    "quantized accumulation tier needs a kernel-capable "
                    "single-device setup); accumulating float32 for this "
                    "run")
    use_quant_otf = use_quant and getattr(
        config, "hist_quant_onthefly", True) and not pack_P
    gbtot = num_groups * max_group_bin
    budget = int(getattr(config, "hist_onehot_budget_mb", 4096)) << 20

    def ohb_bytes(p):
        return n_padded * onehot_width(num_groups, max_group_bin, p)

    pk_cfg = int(getattr(config, "hist_onehot_pack", 0) or 0)
    if pk_cfg in (1, 2, 4) and gbtot % pk_cfg == 0:
        pack = pk_cfg
    else:
        if pk_cfg:
            Log.warning(f"hist_onehot_pack={pk_cfg} invalid for "
                        f"G*B={gbtot}; auto-selecting")
        # the pack with the fewest resident bytes; ties to the smaller
        pack = min((p for p in (1, 2, 4) if gbtot % p == 0),
                   key=lambda p: (ohb_bytes(p), p))
    use_tiled = (use_quant and frontier <= 3 * PACKED_STRIP
                 and getattr(config, "hist_kernel_tiled", True))
    use_fused = (use_pallas and not paired
                 and frontier <= 3 * PACKED_STRIP
                 and (use_tiled or ohb_bytes(pack) <= budget)
                 and getattr(config, "hist_fused_route", True))
    split_route = (use_tiled and use_fused
                   and getattr(config, "hist_split_route", False))
    if getattr(config, "hist_split_route", False) and not split_route:
        Log.warning("hist_split_route ignored: it needs the tiled fused "
                    "path (quantized_grad on a single device, frontier "
                    "within the packed ladder)")
    lp = str(getattr(config, "hist_leaf_partition", "auto")).lower()
    want_lp = lp in ("on", "true", "1")
    leaf_part = want_lp and use_tiled and use_fused
    if want_lp and not leaf_part:
        Log.warning("hist_leaf_partition=on ignored: it needs the tiled "
                    "fused path (quantized_grad on a single device, "
                    "frontier within the packed ladder)")
    use_quant_otf = use_quant_otf and not use_fused and not use_tiled
    use_pre_ohb = (use_pallas and not paired and not use_quant_otf
                   and not use_tiled and ohb_bytes(pack) <= budget)
    if use_pallas and not use_tiled and ohb_bytes(pack) > budget:
        Log.warning(f"resident one-hot ({ohb_bytes(pack) >> 20} MB at "
                    f"pack={pack}) exceeds hist_onehot_budget_mb="
                    f"{budget >> 20}; using the slower on-the-fly rebuild")
    if pack_P and use_pallas and not (use_tiled or use_fused
                                      or use_pre_ohb):
        # the remaining kernel formulations read byte-wide group columns;
        # the JAX grower sends nibble-packed datasets to its XLA form
        Log.warning("bin_packing: the selected histogram kernel has no "
                    "nibble-packed input path; using the XLA histogram "
                    "formulation for this packed dataset")
        use_pallas = paired = use_quant = use_quant_otf = False
    if leaf_part:
        name = "seg_tiled(leaf_partition)"
    elif use_tiled:
        name = ("q_tiled(split_route)" if split_route else "fused_tiled") \
            if use_fused else "q_tiled"
    elif use_fused:
        name = "fused_streamed"
    elif use_quant_otf:
        name = "q_onthefly"
    elif use_pre_ohb:
        name = "pre_onehot"
    elif use_pallas:
        name = "pallas_paired" if paired else (
            "pallas(quantized)" if use_quant else "pallas")
    else:
        name = "xla"
    return KernelPlan(name=name, quant=use_quant, ohb_pack=pack,
                      fused=use_fused, tiled=use_tiled, pre_ohb=use_pre_ohb)


class TreeGrower:
    """Grows trees for one Dataset + Config on one torch device, or on
    the devices of a mesh (the data learner)."""

    def __init__(self, dataset: Dataset, config: Config,
                 device: torch.device, policy=None):
        from ..parallel.mesh import ShardingPolicy, build_mesh
        self.config = config
        if policy is None:
            policy = ShardingPolicy(config, build_mesh(config, device))
        self.policy = policy
        if policy.mesh is not None:
            # the first shard's device holds the tree, the split finder
            # and the scores
            device = policy.devices[0]
        self.device = device
        self.num_leaves = L = config.num_leaves
        self.frontier = min(L - 1, config.frontier_width or 126)
        # histogram memory governance (the JAX grower's :237-252): over
        # the budget, no (L, G, B, 3) cache and no subtraction — both
        # children of every split are histogrammed directly
        pool = float(getattr(config, "histogram_pool_size", -1.0))
        cache_mb = (L * dataset.num_groups * dataset.max_group_bin * 12
                    ) / (1 << 20)
        self.use_hist_cache = pool < 0 or cache_mb <= pool
        if not self.use_hist_cache:
            Log.warning(f"histogram cache ({cache_mb:.0f} MB) exceeds "
                        f"histogram_pool_size ({pool:.0f} MB); disabling "
                        "histogram subtraction (children computed "
                        "directly — ~2x histogram passes)")
        self.max_group_bin = dataset.max_group_bin
        self.max_feature_bin = dataset.max_feature_bin
        self.num_groups = dataset.num_groups
        self.num_features = dataset.num_features
        meta = dataset.feature_meta_arrays()
        self.has_categorical = bool(meta["is_categorical"].any())

        n = dataset.num_data
        self.num_data = n
        # the JAX grower's padding rule off the TPU: the xla plan's row
        # chunk, so both packages pad to the same row count
        self.chunk = _pick_chunk(n, self.num_groups, self.max_group_bin,
                                 4 if config.hist_compute_dtype == "float32"
                                 else 2, min_chunk=1024)
        # multi-host (the device plane, parallel/distributed.py
        # finalize_global; JAX grower.py:270-292): this process holds
        # only ITS rows of the bin matrix, ``num_data`` is global and
        # the chunk comes from the global count.  Every rank pads its
        # rows to a whole chunk multiple, so the global layout
        # interleaves per-rank padding blocks (rank 0's rows, rank 0's
        # pad, rank 1's rows, ...); pad_rows() reproduces it for global
        # metadata and local_rows() takes this rank's block
        self._mh_local: Optional[int] = getattr(
            dataset, "_mh_local_rows", None) if getattr(
                dataset, "_multihost", False) else None
        if self._mh_local is not None and not policy.multihost:
            raise ValueError(
                "a row-sharded multi-process dataset (finalize_global on "
                "the device plane) trains on the plane's mesh: set "
                "tree_learner=data or voting (the JAX grower cannot "
                "place it on one device either)")
        if policy.multihost and self._mh_local is None:
            raise ValueError("the device plane's mesh trains a dataset "
                             "from parallel.distributed.finalize_global")
        if self._mh_local is not None:
            self._mh_nproc = policy.nproc
            self._mh_per_host = -(-self._mh_local // self.chunk) * self.chunk
            self.n_padded = self._mh_per_host * self._mh_nproc
        else:
            self.n_padded = -(-n // self.chunk) * self.chunk
        policy.set_rows(self.n_padded)
        self.sharded = policy.row_ranges is not None
        # sub-byte storage (packing.py): the device matrix IS the storage
        # matrix, and every reader widens the crumbs and nibbles itself
        # (JAX grower.py:167-176); pack_P is the pack spec, 0 when the
        # dataset is stored a byte a group
        lay = getattr(dataset, "bin_layout", None)
        self.pack_P = lay.device_spec if lay is not None else 0
        self.plan = resolve_plan(
            config, n_padded=self.n_padded, num_groups=self.num_groups,
            max_group_bin=self.max_group_bin, frontier=self.frontier,
            pack_P=self.pack_P, single_device=policy.mesh is None)
        mesh = policy.mesh
        # the full-frontier learners (JAX grower.py:566-583); a feature
        # learner the mesh cannot partition runs the serial rounds
        self.is_voting = (mesh is not None
                          and config.tree_learner == "voting")
        self.is_feature_par = (mesh is not None
                               and config.tree_learner == "feature"
                               and policy.feature_axis is not None
                               and self.num_groups % mesh.size == 0
                               and self.pack_P == 0)

        def dev(a, dtype=None):
            t = torch.as_tensor(np.asarray(a))
            return (t if dtype is None else t.to(dtype)).to(device)

        self.f_num_bin = dev(meta["num_bin"], torch.int32)
        self.f_default_bin = dev(meta["default_bin"], torch.int32)
        self.f_missing = dev(meta["missing_type"], torch.int32)
        self.f_is_cat = dev(meta["is_categorical"], torch.bool)
        # the categorical finder runs on these features only
        self.cat_idx = dev(np.nonzero(meta["is_categorical"])[0], torch.long)
        self.f_monotone = dev(meta["monotone"], torch.int32)
        self.f_group = dev([f.group for f in dataset.features], torch.int32)
        bin_map, fix_bin = dataset.feature_bin_maps()
        self.bin_map = dev(bin_map, torch.int32)
        self.fix_bin = dev(fix_bin, torch.int32)
        lo, hi, shift, oor, dense = self._build_g2f_affine(dataset)
        self.f_gb_lo = dev(lo, torch.int32)
        self.f_gb_hi = dev(hi, torch.int32)
        self.f_gb_shift = dev(shift, torch.int32)
        self.f_gb_oor = dev(oor, torch.int32)
        self.g2f_lut = dev(dense, torch.int32)
        self.cfg_scalars: Dict[str, float] = dict(
            lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
            max_delta_step=config.max_delta_step,
            min_data_in_leaf=float(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
            min_gain_to_split=config.min_gain_to_split,
            cat_smooth=config.cat_smooth, cat_l2=config.cat_l2,
            max_cat_threshold=config.max_cat_threshold,
            max_cat_to_onehot=config.max_cat_to_onehot,
            min_data_in_group=float(config.min_data_in_group))
        self.forced_count = 0
        self._load_forced_splits(dataset, config)
        self.max_depth = config.max_depth
        self.max_rounds = L - 1
        self.packed_dispatch = bool(getattr(config, "hist_packed_dispatch",
                                            True))

        valid = self.local_rows(self.pad_rows(np.ones(n, bool), False))
        self.row_valid = torch.from_numpy(valid).to(device)
        self.route_cols = ROUTE_FIXED_COLS + (self.max_feature_bin + 7) // 8
        self.binsT = self.bins = self.ohb = None
        self.feature_bins = None
        if self.sharded:
            self._place_shards(dataset, valid)
        else:
            self._place_bins(dataset)
        if self.is_feature_par:
            self._place_columns()
        self._meta_cache: Dict[torch.device, dict] = {}
        if TELEMETRY.on:
            self._plan_gauges()

    def _place_shards(self, dataset: Dataset, valid: np.ndarray) -> None:
        """The data learner's layout (JAX grower.py:296-317): each
        shard's row range of the padded storage matrix, its valid-row
        mask and its chunk on its device.  The chunk is the largest
        that divides the shard's rows and stays within the serial
        chunk's one-hot working set (JAX grower.py:832-838)."""
        pol = self.policy
        if self._mh_local is not None:
            # multi-host: this rank's rows, padded to its block
            self.shard_bins = [pol.place_local_rows(dataset.group_bins,
                                                    self._mh_per_host)]
        else:
            # each device's rows straight onto it, from the single
            # matrix or a sharded construction's row blocks (no padded
            # host copy)
            self.shard_bins = pol.place_row_shards(
                self._row_blocks(dataset), self.n_padded)
        self.shard_valid = pol.place_rows(valid)
        lo, hi = pol.row_ranges[0]
        local_n = hi - lo
        k = max(1, -(-local_n // max(1, self.chunk)))
        while local_n % k:
            k += 1
        self.shard_chunk = local_n // k

    @staticmethod
    def _row_blocks(dataset: Dataset) -> list:
        """The storage matrix's row blocks in row order: a sharded
        construction's shards, else the one matrix."""
        return getattr(dataset, "shard_bins", None) or [dataset.group_bins]

    def _place_bins(self, dataset: Dataset) -> None:
        device = self.device
        # the (N, cols) storage matrix as the dataset holds it: under a
        # pack spec, sub-byte; zero padding rows are bin 0 of every
        # group.  A sharded construction's row blocks are concatenated
        # on the device
        bins_d = self.policy.place_row_shards(self._row_blocks(dataset),
                                              self.n_padded, device)
        # transposed for the fused and tiled kernels (routing, kernel
        # G); row-major for the bin-matrix kernels and apply_splits
        self.binsT = (bins_d.t().contiguous()
                      if self.plan.fused or self.plan.tiled else None)
        self.bins = None if self.plan.fused else bins_d
        # the streamed one-hot, built once per dataset on the device
        self.ohb = None
        if self.plan.name in ("fused_streamed", "pre_onehot"):
            self.ohb = (precompute_bin_onehot(
                bins_d, max_group_bin=self.max_group_bin,
                packed_groups=self.pack_P)
                if self.plan.ohb_pack == 1 else precompute_bin_onehot_packed(
                    bins_d, max_group_bin=self.max_group_bin,
                    pack=self.plan.ohb_pack, packed_groups=self.pack_P))
        del bins_d

    #: the feature metadata the split finders read
    _FINDER_META = ("bin_map", "fix_bin", "f_num_bin", "f_missing",
                    "f_default_bin", "f_monotone", "f_is_cat")

    def _place_columns(self) -> None:
        """The feature learner's vertical partition (JAX mesh.py
        bins_spec :105-119): shard s keeps group columns [s * G / d,
        (s + 1) * G / d) of every row on its device, and the metadata of
        those groups' features (``own``, their indices; ``bin_map``
        rebased to the shard's columns).  The full matrix stays on the
        first device, where the rows are routed."""
        devs = self.policy.devices
        g_per = self.num_groups // len(devs)
        self.feature_bins, self._shard_meta = [], []
        for s, dev in enumerate(devs):
            self.feature_bins.append(
                self.bins[:, s * g_per:(s + 1) * g_per].to(dev).contiguous())
            own = torch.nonzero(self.f_group // g_per == s)[:, 0]
            m = {k: getattr(self, k)[own].to(dev) for k in self._FINDER_META}
            bm = m["bin_map"]
            m["bin_map"] = torch.where(
                bm >= 0, bm - s * g_per * self.max_group_bin, bm)
            m["own"] = own.to(dev)
            m["cat_idx"] = torch.nonzero(m["f_is_cat"])[:, 0]
            self._shard_meta.append(m)

    def _meta_on(self, dev) -> dict:
        """The feature metadata the finders read, on ``dev``."""
        dev = torch.device(dev)
        if dev not in self._meta_cache:
            self._meta_cache[dev] = {k: getattr(self, k).to(dev)
                                     for k in self._FINDER_META}
        return self._meta_cache[dev]

    def _plan_gauges(self) -> None:
        """The resolved plan as telemetry gauges (JAX grower.py:586-624).
        The JAX package's two plan names with a variant collapse as its
        gauge writes them (split route: q_tiled; quantized pallas:
        pallas).  ``bin_matrix_bytes`` is what the grower keeps on its
        device (``resident_bin_bytes``: on the plans that keep both
        layouts, twice the JAX gauge's one matrix).  The JAX package's
        ``grower.split_finder_ladder`` is a compile knob with no meaning
        here (ROADMAP.md: not ported by design), so it has no gauge."""
        tm = TELEMETRY
        name = self.plan.name
        tm.gauge("grower.hist_kernel", {"q_tiled(split_route)": "q_tiled",
                                        "pallas(quantized)": "pallas"
                                        }.get(name, name))
        tm.gauge("grower.quantized", int(self.plan.quant))
        tm.gauge("grower.hist_precision",
                 "tiered" if self.plan.quant else "f32")
        tm.gauge("bin_matrix_bytes", int(self.resident_bin_bytes()))
        tm.gauge("grower.bin_packed_groups", spec_packed(self.pack_P))
        tm.gauge("grower.bin_crumb_groups", spec_crumb(self.pack_P))
        tm.gauge("grower.frontier_width", int(self.frontier))
        tm.gauge("grower.rows_padded", int(self.n_padded))

    def emit_tree_record(self, tree: Dict[str, torch.Tensor]) -> dict:
        """A grown tree's arrays copied to the host (numpy), the record
        ``Tree.from_grower_arrays`` reads (the ``tree_record`` phase:
        JAX grower.py emit_tree_record serializes the same tree)."""
        with TELEMETRY.phase("tree_record"):
            return {key: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                          else v) for key, v in tree.items()}

    def resident_bin_bytes(self) -> int:
        """Bytes of the bin matrices the grower keeps on its device (the
        transposed and the row-major copy, where its plan keeps both):
        the storage's, so a sub-byte layout's are 2-4x fewer."""
        mats = ([self.binsT, self.bins]
                + (self.shard_bins if self.sharded else [])
                + (self.feature_bins or []))
        return sum(t.numel() * t.element_size()
                   for t in mats if t is not None)

    def train_bins(self) -> torch.Tensor:
        """The training rows' (n_padded, cols) storage bins on the
        grower's device: the fused plans keep only the transposed
        matrix, walked through its transposed view; the data learner's
        shards are gathered in row order."""
        if self.sharded:
            return self.policy.gather_rows(self.shard_bins, self.device)
        return self.bins if self.bins is not None else self.binsT.t()

    # ------------------------------------------------------------------
    def _load_forced_splits(self, dataset: Dataset, config: Config) -> None:
        """Parse ``forcedsplits_filename`` into flat spec tensors
        (lightgbm_tpu/learner/grower.py _load_forced_splits): feature
        (inner index), threshold (bin), left/right child spec index.
        Real-valued thresholds convert through the feature's bin mapper
        (the reference's Dataset::BinThreshold); a spec node on a
        feature that training does not use is dropped with its subtree,
        with a warning."""
        fn = getattr(config, "forcedsplits_filename", "")
        if not fn:
            return
        with open(fn) as f:
            spec = json.load(f)
        if not spec:
            return
        if config.tree_learner == "voting":
            Log.warning("forced splits are not supported with "
                        "tree_learner=voting; ignoring %s" % fn)
            return
        real2inner = {f.feature_idx: j
                      for j, f in enumerate(dataset.features)}
        nodes: list = []

        def rec(node) -> int:
            real_f = int(node["feature"])
            j = real2inner.get(real_f)
            if j is None:
                Log.warning("forced split on unused feature %d ignored"
                            % real_f)
                return -1
            mapper = dataset.features[j].mapper
            thr_bin = int(np.asarray(mapper.value_to_bin(
                np.array([float(node["threshold"])]))).ravel()[0])
            idx = len(nodes)
            nodes.append([j, thr_bin, -1, -1])
            if isinstance(node.get("left"), dict):
                nodes[idx][2] = rec(node["left"])
            if isinstance(node.get("right"), dict):
                nodes[idx][3] = rec(node["right"])
            return idx

        if rec(spec) < 0:
            return
        arr = torch.from_numpy(np.asarray(nodes, dtype=np.int32)
                               ).to(self.device)
        self.forced_count = len(nodes)
        self.forced_feature = arr[:, 0].contiguous()
        self.forced_thr = arr[:, 1].contiguous()
        self.forced_left = arr[:, 2].contiguous()
        self.forced_right = arr[:, 3].contiguous()

    # ------------------------------------------------------------------
    @staticmethod
    def _build_g2f_affine(dataset: Dataset):
        """Per-feature affine group-bin -> feature-bin map
        ``fb = gb - shift if lo <= gb < hi else oor`` (the scalar form of
        the reference's min_bin/max_bin/bias routing, dense_bin.hpp
        191-283), plus the dense (F, GB) table it replaces."""
        F = dataset.num_features
        GB = dataset.max_group_bin
        lo = np.zeros(F, dtype=np.int32)
        hi = np.zeros(F, dtype=np.int32)
        shift = np.zeros(F, dtype=np.int32)
        oor = np.zeros(F, dtype=np.int32)
        dense = np.zeros((F, GB), dtype=np.int32)
        for j, f in enumerate(dataset.features):
            if not f.collapsed_default:
                lo[j], hi[j] = 0, f.num_bin
                shift[j], oor[j] = 0, f.num_bin - 1
                dense[j] = np.minimum(np.arange(GB), f.num_bin - 1)
            else:
                adj = 1 if f.mapper.default_bin == 0 else 0
                lo[j] = f.offset
                hi[j] = f.offset + f.num_bin - adj
                shift[j] = f.offset - adj
                oor[j] = f.default_bin
                dense[j, :] = f.default_bin
                for b in range(f.num_bin):
                    gb = b + f.offset - adj
                    if b != f.mapper.default_bin and gb < GB:
                        dense[j, gb] = b
        gb_iota = np.arange(GB, dtype=np.int32)[None, :]
        affine = np.where((gb_iota >= lo[:, None]) & (gb_iota < hi[:, None]),
                          gb_iota - shift[:, None], oor[:, None])
        if not np.array_equal(affine, dense):  # pragma: no cover
            raise AssertionError("affine g2f map diverges from the dense "
                                 "table")
        return lo, hi, shift, oor, dense

    def pad_rows(self, arr: np.ndarray, fill=0.0) -> np.ndarray:
        """Pad a global row array ((N,) or (N, ...)) to n_padded rows
        (JAX grower.py pad_rows :731-745).  Multi-host: the padding is
        interleaved per rank, the assembled shard layout."""
        if self._mh_local is not None:
            nl, ph = self._mh_local, self._mh_per_host
            pad = np.full((ph - nl,) + tuple(arr.shape[1:]), fill,
                          dtype=arr.dtype)
            parts = []
            for h in range(self._mh_nproc):
                parts += [arr[h * nl:(h + 1) * nl], pad]
            return np.concatenate(parts)
        pad = self.n_padded - self.num_data
        if pad == 0:
            return arr
        return np.concatenate([arr, np.full((pad,) + tuple(arr.shape[1:]),
                                            fill, dtype=arr.dtype)])

    def local_rows(self, arr):
        """This process's rows of a padded global row array or tensor
        (its per-rank block multi-host; the whole array otherwise): the
        rows the grower's tensors hold."""
        return self.policy.local_slice(arr)

    @property
    def local_padded(self) -> int:
        """Rows of this process's padded tensors (n_padded in a single
        process, the per-rank block multi-host)."""
        return (self.n_padded if self._mh_local is None
                else self._mh_per_host)

    # ------------------------------------------------------------------
    def _init_tree(self) -> Dict[str, torch.Tensor]:
        L, M, B = self.num_leaves, self.num_leaves - 1, self.max_feature_bin
        d = self.device

        def z(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=d)

        return dict(
            leaf_value=z(L), leaf_weight=z(L), leaf_count=z(L),
            leaf_parent=torch.full((L,), -1, dtype=torch.int32, device=d),
            leaf_depth=z(L, torch.int32),
            node_feature=z(M, torch.int32), node_threshold=z(M, torch.int32),
            node_default_left=z(M, torch.bool), node_is_cat=z(M, torch.bool),
            node_cat_mask=z((M, B), torch.bool), node_gain=z(M),
            node_value=z(M), node_weight=z(M), node_count=z(M),
            node_left=z(M, torch.int32), node_right=z(M, torch.int32))

    def _root_state(self, grad, hess, counts):
        """The per-leaf state and the tree of a new tree: the root leaf
        holds every valid row's sums."""
        L = self.num_leaves
        d = self.device
        totals = self._root_totals(grad, hess, counts)
        st = dict(
            leaf_sum_grad=torch.zeros(L, device=d),
            leaf_sum_hess=torch.zeros(L, device=d),
            leaf_count=torch.zeros(L, device=d),
            leaf_min_c=torch.full((L,), -np.inf, device=d),
            leaf_max_c=torch.full((L,), np.inf, device=d),
            leaf_is_left=torch.zeros(L, dtype=torch.bool, device=d),
            # each leaf's forced-split spec index (-1: none); the root
            # starts at the spec's root
            leaf_forced=torch.full((L,), -1, dtype=torch.int32, device=d))
        if self.forced_count:
            st["leaf_forced"][0] = 0
        st["leaf_sum_grad"][0] = totals[0]
        st["leaf_sum_hess"][0] = totals[1]
        st["leaf_count"][0] = totals[2]
        tree = self._init_tree()
        tree["leaf_weight"][0] = totals[1]
        tree["leaf_count"][0] = totals[2]
        return st, tree

    def _root_totals(self, grad, hess, counts):
        """The root's (sum_grad, sum_hess, count).  Rows sharded, each
        shard sums its own rows and the shards' sums are added in shard
        (then rank) order — the JAX mesh's local contraction and psum —
        so a rank holds the same bits as the single-process mesh whose
        shards are the ranks' rows."""
        if not self.sharded:
            return compute_root_totals(grad, hess, counts, self.row_valid)
        if self.policy.multihost:
            part = compute_root_totals(grad, hess, counts, self.row_valid)
            return self.policy.collectives().allreduce_sum([part])[0]
        from ..parallel.collectives import _sum_in_order
        return _sum_in_order(
            [compute_root_totals(grad[lo:hi], hess[lo:hi], counts[lo:hi],
                                 self.row_valid[lo:hi])
             for lo, hi in self.policy.row_ranges], self.device)

    def train_tree(self, grad: torch.Tensor, hess: torch.Tensor,
                   counts: torch.Tensor, feature_mask: torch.Tensor,
                   qkey: Optional[torch.Tensor] = None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                              Optional[torch.Tensor]]:
        """Grow one tree.  grad/hess/counts are (n_padded,) f32 with
        zeros on padded rows (multi-host: this rank's
        ``local_padded`` rows); ``qkey`` (a ``utils/prng.py`` key) rounds
        the int8 weights stochastically.  Returns (tree arrays —
        bin-space, with ``num_leaves`` as a python int —, final leaf
        ids, each row's post-route leaf value on the fused plans, else
        None)."""
        if self.is_voting or self.is_feature_par:
            return self._train_tree_full(grad, hess, counts, feature_mask)
        L = self.num_leaves
        d = self.device
        plan = self.plan
        leaf_id = torch.where(self.row_valid, 0, -1).to(torch.int32)
        st, tree = self._root_state(grad, hess, counts)
        cand = torch.zeros((L, CAND_COLS + self.max_feature_bin), device=d)
        cand[:, CAND_GAIN] = -np.inf
        forced_cand = None
        if self.forced_count:
            forced_cand = torch.zeros((L, FORCED_COLS), device=d)
            forced_cand[:, FORCED_GAIN] = -np.inf
        hist_cache = torch.zeros(
            (L, self.num_groups, self.max_group_bin, 3),
            device=d) if self.use_hist_cache else None
        route_tab = torch.zeros((L, self.route_cols), device=d)
        # gradients are fixed for the whole tree: quantize (or stack)
        # the weights once, in the layout the plan's kernel reads
        scales = None
        if plan.quant:
            w, scales = quantize_gradients(grad, hess, counts,
                                           key=qkey)   # (N, 3)
        else:
            w = torch.stack([grad, hess, counts], dim=1)
        if plan.fused or plan.tiled:
            w = w.t().contiguous()                               # (3, N)
        if self.sharded:
            # each shard's rows of the weights and its leaf ids, on its
            # device (the data learner runs the xla plan: (N, 3) rows)
            w = self.policy.place_rows(w)
            leaf_id = [torch.where(v, 0, -1).to(torch.int32)
                       for v in self.shard_valid]

        num_leaves = 1
        parents = torch.empty(0, dtype=torch.int32, device=d)
        rights = torch.zeros(1, dtype=torch.int32, device=d)  # the root
        for round_idx in range(self.max_rounds):
            # ---- refresh the leaves created last round
            part = None
            if plan.name in _ROUTE_FIRST:
                # the pending splits in their own pass (JAX grower.py
                # :1289-1313); seg_tiled then regroups the rows by leaf
                # once for the round's passes
                leaf_id = route_only_tiled(self.binsT, leaf_id, route_tab,
                                           self.pack_P)
                if plan.name == "seg_tiled(leaf_partition)":
                    part = self._build_partition(leaf_id, w)
            right_hist, leaf_id = self._histogram(
                w, scales, leaf_id, route_tab, rights, part)
            if self.use_hist_cache:
                left_hist = hist_cache[parents.long()] - right_hist[
                    :parents.shape[0]]
            elif parents.shape[0]:
                # no cache (JAX grower.py:1325-1345): the parent slots
                # now hold the left children's rows, already routed (a
                # fused kernel's second routing of them is idempotent)
                left_hist = self._histogram(w, scales, leaf_id, route_tab,
                                            parents, part)[0]
            else:
                left_hist = right_hist[:0]
            slots = torch.cat([parents, rights]).long()
            h_new = torch.cat([left_hist, right_hist])
            if self.use_hist_cache:
                hist_cache[slots] = h_new
            with TELEMETRY.phase("split_finder"):
                cand[slots], fblock = self._find_splits(st, slots, h_new,
                                                        feature_mask)
            if fblock is not None:
                forced_cand[slots] = fblock

            # ---- select: top-W candidates by gain within the budget
            sel_c, forced_valid = self._overlay_forced(cand, forced_cand,
                                                       st["leaf_forced"])
            best_gain = sel_c[:, CAND_GAIN]
            slot = torch.arange(L, dtype=torch.int32, device=d)
            active = slot < num_leaves
            cand_m = active & (best_gain > 0.0)
            if self.max_depth > 0:
                cand_m &= tree["leaf_depth"] < self.max_depth
            key = torch.where(cand_m, best_gain,
                              torch.tensor(-np.inf, device=d))
            if forced_valid is not None:
                # a forced leaf splits first, whatever its depth or gain
                forced_valid &= active
                cand_m |= forced_valid
                key = torch.where(forced_valid,
                                  torch.tensor(np.inf, device=d), key)
            # stable descending order: ties keep the lower slot first,
            # as lax.top_k does
            top_i = torch.sort(key, descending=True, stable=True
                               ).indices[:self.frontier].to(torch.int32)
            rank = torch.full((L,), L, dtype=torch.int32, device=d)
            rank[top_i.long()] = torch.arange(top_i.shape[0],
                                              dtype=torch.int32, device=d)
            do_split = cand_m & (rank < L - num_leaves)
            k = int(do_split.sum())
            with TELEMETRY.phase("apply_split"):
                route_args = self._apply_selection(st, tree, sel_c, do_split,
                                                   rank, num_leaves,
                                                   forced_valid)
                if plan.fused:
                    # routed by the next round's kernel (or at exit)
                    route_tab = build_route_table(*route_args)
                elif k:
                    leaf_id = self._apply_splits(leaf_id, route_args)
            parents = top_i[:k]
            rights = num_leaves + torch.arange(k, dtype=torch.int32,
                                               device=d)
            num_leaves += k
            if k == 0 or num_leaves >= L:
                break
        tree["num_leaves"] = num_leaves
        if self.sharded:
            leaf_id = self.policy.gather_rows(leaf_id, d)
        if not plan.fused:
            return tree, leaf_id, None
        # the last round's splits were never routed: apply them and take
        # each row's post-route leaf value for the score update (kernel
        # B on every fused plan; the JAX package's fused_streamed plan
        # runs the same function through XLA's apply_route_table)
        leaf_id, row_val = route_apply_tiled(self.binsT, leaf_id, route_tab,
                                             tree["leaf_value"], self.pack_P)
        return tree, leaf_id, row_val

    def _apply_splits(self, leaf_id, route_args):
        """Route the rows of the selected splits (apply_splits): on the
        data learner, each shard its own rows on its device."""
        if not self.sharded:
            return apply_splits(self.bins, leaf_id, *route_args,
                                packed_groups=self.pack_P)
        return [apply_splits(b, lid, *(a.to(b.device) for a in route_args),
                             packed_groups=self.pack_P)
                for b, lid in zip(self.shard_bins, leaf_id)]

    # ------------------------------------------------------------------
    # the full-frontier rounds of the voting and feature learners
    # ------------------------------------------------------------------
    def _train_tree_full(self, grad, hess, counts, feature_mask):
        """Grow one tree in full-frontier rounds (JAX grower.py
        _round_voting :1855, _round_feature :1841): each round finds
        every leaf's best split, splits the gain-ranked best within the
        leaf budget and routes the rows at once (apply_splits)."""
        L = self.num_leaves
        st, tree = self._root_state(grad, hess, counts)
        w = torch.stack([grad, hess, counts], dim=1)
        if self.sharded:
            # voting: each shard's rows of the weights and leaf ids
            w = self.policy.place_rows(w)
            leaf_id = [torch.where(v, 0, -1).to(torch.int32)
                       for v in self.shard_valid]
        else:
            # feature: every shard reads every row
            w = [w.to(dev) for dev in self.policy.devices]
            leaf_id = torch.where(self.row_valid, 0, -1).to(torch.int32)
        num_leaves = 1
        for _ in range(self.max_rounds):
            with TELEMETRY.phase("split_finder"):
                cand = (self._voting_cand(st, w, leaf_id, feature_mask)
                        if self.is_voting else
                        self._feature_cand(st, w, leaf_id, feature_mask))
            do_split, rank, k = self._select_frontier(
                tree, cand[:, CAND_GAIN], num_leaves)
            if k == 0:
                break
            with TELEMETRY.phase("apply_split"):
                route_args = self._apply_selection(st, tree, cand, do_split,
                                                   rank, num_leaves)
                leaf_id = self._apply_splits(leaf_id, route_args)
            num_leaves += k
            if num_leaves >= L:
                break
        tree["num_leaves"] = num_leaves
        if self.sharded:
            leaf_id = self.policy.gather_rows(leaf_id, self.device)
        return tree, leaf_id, None

    def _select_frontier(self, tree, best_gain, num_leaves: int):
        """Gain-ranked splits within the leaf budget (JAX grower.py
        _select_frontier :1822-1839: no frontier width, no forced
        splits; its stable argsort keeps the lower slot first on a
        tie).  Returns (do_split, rank, k)."""
        L = self.num_leaves
        d = self.device
        active = torch.arange(L, device=d) < num_leaves
        cand_m = active & (best_gain > 0.0)
        if self.max_depth > 0:
            cand_m &= tree["leaf_depth"] < self.max_depth
        key = torch.where(cand_m, best_gain, torch.tensor(-np.inf, device=d))
        order = torch.sort(key, descending=True, stable=True).indices
        rank = torch.empty_like(order)
        rank[order] = torch.arange(L, device=d)
        do_split = cand_m & (rank < L - num_leaves)
        return do_split, rank.to(torch.int32), int(do_split.sum())

    def _local_hist(self, bins, w, leaf_id):
        """Every leaf's xla histogram of ``bins``' rows in one chunk (the
        JAX voting and feature paths' ``chunk=bins.shape[0]``)."""
        with TELEMETRY.phase("histogram"):
            return compute_group_histograms(
                bins, w[:, 0], w[:, 1], w[:, 2], leaf_id,
                num_leaves=self.num_leaves, max_group_bin=self.max_group_bin,
                compute_dtype=self.config.hist_compute_dtype,
                chunk=bins.shape[0], packed_groups=self.pack_P)

    def _feature_cand(self, st, w, leaf_id, feature_mask):
        """The feature learner's split of every leaf as candidate rows
        (JAX grower.py _feature_find_splits :1730-1820): each shard
        histograms its own groups over every row, runs the finders on
        its own features (``bin_map`` rebased to its columns), and each
        leaf takes the shard with the best gain, the lowest shard on a
        tie (the SplitInfo election), its categorical bitset
        included."""
        from ..parallel.collectives import _note_collective
        blocks = []
        for bins_l, ws, m in zip(self.feature_bins, w, self._shard_meta):
            dev = bins_l.device
            lid = leaf_id.to(dev)
            local = self._local_hist(bins_l, ws, lid)
            totals = compute_leaf_totals(ws[:, 0], ws[:, 1], ws[:, 2], lid,
                                         self.num_leaves)
            feat_hist = expand_feature_histograms(local, m["bin_map"],
                                                  m["fix_bin"], totals)
            block = find_best_split_block(
                feat_hist, totals[:, 0], totals[:, 1], totals[:, 2],
                st["leaf_min_c"].to(dev), st["leaf_max_c"].to(dev),
                self.cfg_scalars, m["f_num_bin"], m["f_missing"],
                m["f_default_bin"], m["f_monotone"], m["f_is_cat"],
                feature_mask.to(dev)[m["own"]], m["cat_idx"].numel() > 0,
                m["cat_idx"])
            # the shard's feature index back to the dataset's
            block[:, CAND_FEATURE] = m["own"][block[:, CAND_FEATURE].long()
                                              ].to(torch.float32)
            _note_collective("allgather", block)
            blocks.append(block.to(self.device))
        stack = torch.stack(blocks)                          # (d, L, C)
        best = stack[:, :, CAND_GAIN].argmax(dim=0)          # (L,)
        return stack[best, torch.arange(self.num_leaves,
                                        device=self.device)]

    def _voting_cand(self, st, w, leaf_id, feature_mask):
        """The voting learner's split of every leaf as candidate rows
        (JAX grower.py _voting_find_splits :1657-1727 and the argmax of
        _round_voting): each shard's local finders (min_data_in_leaf and
        min_sum_hessian_in_leaf over the mesh size) vote its top_k
        features a leaf, the votes are summed, the global top 2*top_k
        features' histograms alone are summed across shards, and the
        finders run on that compact set.  ``top_k``'s ties go to the
        lower feature (``lax.top_k``), so ``sel`` is a stable sort."""
        F = self.num_features
        cfg = self.cfg_scalars
        d_mesh = self.policy.mesh.size
        cfg_local = dict(cfg, min_data_in_leaf=cfg["min_data_in_leaf"]
                         / d_mesh, min_sum_hessian_in_leaf=cfg[
                             "min_sum_hessian_in_leaf"] / d_mesh)
        kk = min(int(self.config.top_k), F)
        k2 = min(2 * int(self.config.top_k), F)
        feats, votes = [], []
        for bins, ws, lid in zip(self.shard_bins, w, leaf_id):
            dev = bins.device
            m = self._meta_on(dev)
            local = self._local_hist(bins, ws, lid)
            totals = compute_leaf_totals(ws[:, 0], ws[:, 1], ws[:, 2], lid,
                                         self.num_leaves)
            feat_hist = expand_feature_histograms(local, m["bin_map"],
                                                  m["fix_bin"], totals)
            _, gains = run_split_finders(
                feat_hist, totals[:, 0], totals[:, 1], totals[:, 2],
                st["leaf_min_c"].to(dev), st["leaf_max_c"].to(dev),
                cfg_local, m["f_num_bin"], m["f_missing"],
                m["f_default_bin"], m["f_monotone"], m["f_is_cat"],
                feature_mask.to(dev), self.has_categorical,
                self.cat_idx.to(dev))
            kth = torch.sort(gains, dim=1, descending=True
                             ).values[:, kk - 1:kk]
            votes.append(((gains >= kth) & torch.isfinite(gains)
                          ).to(torch.float32))
            feats.append(feat_hist)
        total = self.policy.collectives().allreduce_sum(
            votes)[0].sum(dim=0)
        sel = torch.sort(total.to(self.device), descending=True,
                         stable=True).indices[:k2]
        hist = self._exchange([fh[:, sel.to(fh.device)] for fh in feats],
                              "f32")
        is_cat = self.f_is_cat[sel]
        block = find_best_split_block(
            hist, st["leaf_sum_grad"], st["leaf_sum_hess"],
            st["leaf_count"], st["leaf_min_c"], st["leaf_max_c"], cfg,
            self.f_num_bin[sel], self.f_missing[sel],
            self.f_default_bin[sel], self.f_monotone[sel], is_cat,
            feature_mask[sel], bool(is_cat.any()),
            torch.nonzero(is_cat)[:, 0])
        block[:, CAND_FEATURE] = sel[block[:, CAND_FEATURE].long()
                                     ].to(torch.float32)
        return block

    def _hist_rowsharded(self, w, leaf_id, slots):
        """The data learner's histogram pass (JAX grower.py
        _hist_xla_rowsharded :817-866): each shard's xla histogram of
        its own rows on its device, then the cross-shard sum under the
        ``hist_exchange`` codec, on the first shard's device."""
        local = [compute_group_histograms(
            b, ws[:, 0], ws[:, 1], ws[:, 2], lid,
            num_leaves=self.num_leaves, max_group_bin=self.max_group_bin,
            compute_dtype=self.config.hist_compute_dtype,
            chunk=self.shard_chunk, slots=slots.to(b.device),
            packed_groups=self.pack_P)
            for b, ws, lid in zip(self.shard_bins, w, leaf_id)]
        return self._exchange(local, str(getattr(
            self.config, "hist_exchange", "f32")).lower())

    def _exchange(self, local, mode: str):
        """The shards' histograms summed under the ``hist_exchange``
        codec: in this process, or multi-host across the device plane's
        ranks (each holds one shard), the same bits."""
        from ..parallel.collectives import (exchange_histograms,
                                            exchange_histograms_ranks)
        if self.policy.multihost:
            return exchange_histograms_ranks(
                local[0], mode, self.policy.collectives())
        return exchange_histograms(local, mode=mode, world=len(local))

    def _use_packed(self, k: int) -> bool:
        """The JAX strip ladder (grower.py _packed_dispatch :870-901) for
        ``k`` new leaves: the channel-packed entry point (q_packed,
        pre_packed) at every k when the frontier fits its three strips,
        else while k fits two; the full-width entry point otherwise, and
        always without hist_packed_dispatch.  The ladder picks a kernel,
        never a result: the histograms are the same."""
        return self.packed_dispatch and (k <= 2 * PACKED_STRIP or
                                         self.frontier <= 3 * PACKED_STRIP)

    def _build_partition(self, leaf_id, wT):
        """The round's leaf partition (JAX grower.py _build_partition
        :995-1010): the stable block-aligned permutation of the routed
        leaf ids and the partitioned copies of the transposed bins and
        the (3, N) int8 weights that kernel J streams (the storage's
        columns move whole, so a sub-byte layout stays packed)."""
        with TELEMETRY.phase("partition"):
            perm, blk_leaf, _ = build_leaf_partition(
                leaf_id, num_slots=self.num_leaves, block=SEG_BLOCK)
            return (apply_partition(self.binsT, perm, axis=1),
                    apply_partition(wT, perm, axis=1), blk_leaf)

    def _seg_histogram(self, part, scales, slots):
        """Kernel J over the partition ``part``: each block's owning
        leaf mapped to its position in ``slots`` (JAX grower.py
        _hist_kernel_seg :1013-1047; the JAX ladder rung is exactly
        ``len(slots)`` here)."""
        binsT_p, wT_p, blk_leaf = part
        return compute_group_histograms_seg_tiled(
            binsT_p, wT_p, scales,
            block_slots(blk_leaf, slots, self.num_leaves),
            num_out=slots.shape[0], max_group_bin=self.max_group_bin,
            packed_groups=self.pack_P)

    def _histogram(self, w, scales, leaf_id, route_tab, slots, part=None):
        """The plan's histogram pass over ``slots`` with the tree's
        weights ``w`` (in the layout the plan's kernel reads) and, on
        seg_tiled, the round's partition ``part``: returns ((W, G, B, 3)
        f32 histograms, leaf ids after the pass).  Every int8 pass ends
        in a dequantizing fix-up, one ``hist_quant_fixup`` a pass (the
        JAX package counts one a trace of its compiled step)."""
        if self.plan.quant and TELEMETRY.on:
            TELEMETRY.add("hist_quant_fixup", 1)
        with TELEMETRY.phase("histogram"):
            return self._histogram_impl(w, scales, leaf_id, route_tab,
                                        slots, part)

    def _histogram_impl(self, w, scales, leaf_id, route_tab, slots,
                        part=None):
        plan = self.plan
        B, G, spec = self.max_group_bin, self.num_groups, self.pack_P
        if plan.name == "fused_tiled":
            return compute_group_histograms_fused_tiled(
                self.binsT, w, scales, leaf_id, route_tab, slots,
                max_group_bin=B, packed_groups=spec)
        if plan.name == "seg_tiled(leaf_partition)":
            return self._seg_histogram(part, scales, slots), leaf_id
        if plan.tiled:
            # every width a tiled plan allows (<= 126) fits kernel G; the
            # JAX grower's full-width rung, which only
            # hist_packed_dispatch=false reaches there, is pallas_q on
            # the row-major bins: the same histogram
            return compute_group_histograms_q_tiled(
                self.binsT, w, scales, leaf_id, slots,
                max_group_bin=B, packed_groups=spec), leaf_id
        if plan.name == "fused_streamed":
            return compute_group_histograms_fused(
                self.ohb, self.binsT, w, scales, leaf_id, route_tab, slots,
                max_group_bin=B, quant=plan.quant, pack=plan.ohb_pack,
                num_groups=G, packed_groups=spec)
        if plan.name == "pallas":
            return bins_hist(self.bins, w, leaf_id, slots, B), leaf_id
        if plan.name == "pallas_paired":
            return bins_hist_paired(self.bins, w, leaf_id, slots,
                                    B), leaf_id
        if plan.name == "xla" and self.sharded:
            return self._hist_rowsharded(w, leaf_id, slots), leaf_id
        if plan.name == "xla":
            return compute_group_histograms(
                self.bins, w[:, 0], w[:, 1], w[:, 2], leaf_id,
                num_leaves=self.num_leaves, max_group_bin=B,
                compute_dtype=self.config.hist_compute_dtype,
                chunk=self.chunk, slots=slots, packed_groups=spec), leaf_id
        if plan.name == "pallas(quantized)":
            return compute_group_histograms_pallas_q(
                self.bins, w, scales, leaf_id, num_leaves=self.num_leaves,
                max_group_bin=B, slots=slots), leaf_id
        packed = self._use_packed(slots.shape[0])
        if plan.name == "q_onthefly":
            if packed:
                return compute_group_histograms_q_packed(
                    self.bins, w, scales, leaf_id, slots,
                    max_group_bin=B), leaf_id
            return compute_group_histograms_pallas_q(
                self.bins, w, scales, leaf_id, num_leaves=self.num_leaves,
                max_group_bin=B, slots=slots), leaf_id
        if packed:
            return compute_group_histograms_pre_packed(
                self.ohb, w, scales, leaf_id, slots, max_group_bin=B,
                quant=plan.quant, pack=plan.ohb_pack, num_groups=G), leaf_id
        return compute_group_histograms_pre(
            self.ohb, w, scales, leaf_id, num_leaves=self.num_leaves,
            max_group_bin=B, quant=plan.quant, slots=slots,
            pack=plan.ohb_pack, num_groups=G), leaf_id

    # ------------------------------------------------------------------
    def _find_splits(self, st, slots, h_w, feature_mask):
        """Best split of each leaf in ``slots`` from its group
        histograms, as packed candidate rows, and with forced splits
        the forced-split rows of the same leaves (else None; JAX
        grower.py _refresh_cand_impl)."""
        sg = st["leaf_sum_grad"][slots]
        sh = st["leaf_sum_hess"][slots]
        sc = st["leaf_count"][slots]
        totals = torch.stack([sg, sh, sc], dim=1)
        feat_hist = expand_feature_histograms(h_w, self.bin_map,
                                              self.fix_bin, totals)
        block = find_best_split_block(
            feat_hist, sg, sh, sc, st["leaf_min_c"][slots],
            st["leaf_max_c"][slots], self.cfg_scalars, self.f_num_bin,
            self.f_missing, self.f_default_bin, self.f_monotone,
            self.f_is_cat, feature_mask, self.has_categorical, self.cat_idx)
        if not self.forced_count:
            return block, None
        return block, forced_split_block(
            feat_hist, st["leaf_forced"][slots], self.forced_feature,
            self.forced_thr, sg, sh, sc, self.f_num_bin, self.f_missing,
            self.f_default_bin, self.f_is_cat, self.cfg_scalars)

    def _overlay_forced(self, cand, forced_cand, leaf_forced):
        """The candidates selection reads: with forced splits, each leaf
        whose spec's split is valid takes it in place of its best split
        (feature, gain, threshold, direction, sums, outputs, and the
        spec's bin as a one-hot mask; JAX grower.py _round :1596-1616).
        Returns (candidate rows, the forced leaves' mask or None)."""
        if not self.forced_count:
            return cand, None
        fc = forced_cand
        s_node = leaf_forced.clamp(0, self.forced_count - 1).long()
        forced_valid = (leaf_forced >= 0) & (fc[:, FORCED_GAIN] > -np.inf)
        fv = forced_valid[:, None]
        fixed = torch.stack(
            [fc[:, FORCED_GAIN],
             self.forced_feature[s_node].to(torch.float32),
             fc[:, FORCED_THRESHOLD], fc[:, FORCED_DEFAULT_LEFT],
             fc[:, FORCED_LSG], fc[:, FORCED_LSH], fc[:, FORCED_LSC],
             fc[:, FORCED_LOUT], fc[:, FORCED_ROUT]], dim=1)
        out = cand.clone()
        out[:, :CAND_CAT_DIR] = torch.where(fv, fixed, cand[:, :CAND_CAT_DIR])
        fmask = (torch.arange(self.max_feature_bin, device=cand.device)[None]
                 == fc[:, FORCED_THRESHOLD].to(torch.int64)[:, None])
        out[:, CAND_COLS:] = torch.where(fv, fmask.to(torch.float32),
                                         cand[:, CAND_COLS:])
        return out, forced_valid

    def _apply_selection(self, st, tree, cand, do_split, rank,
                         num_leaves: int, forced_valid=None) -> torch.Tensor:
        """Apply the selected splits in place: new internal nodes, child
        leaf state, monotone bounds (the reference's
        SerialTreeLearner::Split, serial_tree_learner.cpp:700-774).
        Returns the route arguments of these splits (build_route_table /
        apply_splits order)."""
        L = self.num_leaves
        d = self.device
        best_gain = cand[:, CAND_GAIN]
        best_f = cand[:, CAND_FEATURE].to(torch.int32).long()
        thr = cand[:, CAND_THRESHOLD].to(torch.int32)
        dleft = cand[:, CAND_DEFAULT_LEFT] > 0.5
        lsg, lsh, lsc = cand[:, CAND_LSG], cand[:, CAND_LSH], cand[:, CAND_LSC]
        lout, rout = cand[:, CAND_LOUT], cand[:, CAND_ROUT]
        cat_mask = cand[:, CAND_COLS:] > 0.5

        slot = torch.arange(L, dtype=torch.int32, device=d)
        right_slot = num_leaves + rank
        node_id = (num_leaves - 1) + rank
        f_is_cat = self.f_is_cat[best_f]
        f_mono = self.f_monotone[best_f]

        sel = do_split.nonzero(as_tuple=True)[0]
        nid = node_id[sel].long()
        rsl = right_slot[sel].long()
        t = tree
        # internal_value = the leaf's output before it split
        t["node_feature"][nid] = best_f[sel].to(torch.int32)
        t["node_threshold"][nid] = thr[sel]
        t["node_default_left"][nid] = dleft[sel]
        t["node_is_cat"][nid] = f_is_cat[sel]
        t["node_cat_mask"][nid] = cat_mask[sel]
        t["node_gain"][nid] = best_gain[sel]
        t["node_value"][nid] = t["leaf_value"][sel]
        t["node_weight"][nid] = st["leaf_sum_hess"][sel]
        t["node_count"][nid] = st["leaf_count"][sel]
        t["node_left"][nid] = -(slot[sel] + 1)
        t["node_right"][nid] = -(right_slot[sel] + 1)
        # parent child-pointer fixup: this leaf's slot in its parent now
        # points at the new internal node
        par = t["leaf_parent"][sel]
        is_left = st["leaf_is_left"][sel]
        has_p = par >= 0
        t["node_left"][par[has_p & is_left].long()] = \
            node_id[sel][has_p & is_left]
        t["node_right"][par[has_p & ~is_left].long()] = \
            node_id[sel][has_p & ~is_left]

        def upd(arr, left_val, right_val):
            # right children take the new slots, left children keep the
            # parent slot (values computed from the pre-split state)
            rv = right_val[sel].clone()
            lv = left_val[sel].clone()
            arr[rsl] = rv
            arr[sel] = lv

        rsg = st["leaf_sum_grad"] - lsg
        rsh = st["leaf_sum_hess"] - lsh
        rsc = st["leaf_count"] - lsc
        # monotone constraint propagation (serial_tree_learner.cpp:764-774)
        mid = (lout + rout) / 2.0
        is_num = ~f_is_cat
        lmin = torch.where(is_num & (f_mono < 0), mid, st["leaf_min_c"])
        lmax = torch.where(is_num & (f_mono > 0), mid, st["leaf_max_c"])
        rmin = torch.where(is_num & (f_mono > 0), mid, st["leaf_min_c"])
        rmax = torch.where(is_num & (f_mono < 0), mid, st["leaf_max_c"])
        new_depth = t["leaf_depth"] + 1
        upd(st["leaf_sum_grad"], lsg, rsg)
        upd(st["leaf_sum_hess"], lsh, rsh)
        upd(st["leaf_count"], lsc, rsc)
        upd(st["leaf_min_c"], lmin, rmin)
        upd(st["leaf_max_c"], lmax, rmax)
        upd(t["leaf_value"], lout, rout)
        upd(t["leaf_weight"], lsh, rsh)
        upd(t["leaf_count"], lsc, rsc)
        upd(t["leaf_parent"], node_id, node_id)
        upd(t["leaf_depth"], new_depth, new_depth)
        upd(st["leaf_is_left"], torch.ones(L, dtype=torch.bool, device=d),
            torch.zeros(L, dtype=torch.bool, device=d))
        if forced_valid is not None:
            # children of a forced split take the spec's left/right
            # sub-nodes; any other split clears the spec
            s_node = st["leaf_forced"].clamp(0, self.forced_count - 1).long()
            fap = do_split & forced_valid
            none = torch.full((L,), -1, dtype=torch.int32, device=d)
            upd(st["leaf_forced"],
                torch.where(fap, self.forced_left[s_node], none),
                torch.where(fap, self.forced_right[s_node], none))

        return (do_split, self.f_group[best_f], self.f_gb_lo[best_f],
                self.f_gb_hi[best_f], self.f_gb_shift[best_f],
                self.f_gb_oor[best_f], f_is_cat, thr, dleft,
                self.f_missing[best_f], self.f_default_bin[best_f],
                self.f_num_bin[best_f], cat_mask, right_slot)
