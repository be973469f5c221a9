"""Leaf-wise tree growth: the serial tree learner on one device.

Port of lightgbm_tpu/learner/grower.py for the serial learner's
single-device kernel plans.  :func:`resolve_plan` picks the plan the
JAX grower picks for the same config and data (grower.py:318-543, with
CUDA in the role of the TPU check); four of them run here:

  fused_tiled     quantized int8 gradients: kernel A routes last
                  round's splits and histograms the new leaves in one
                  pass from the transposed bins; kernel B routes the
                  last splits at exit and returns each row's leaf value
  fused_streamed  kernel D does the same from the streamed bin one-hot
                  (f32 or int8 weights); kernel B again at exit
  pre_onehot      kernel E histograms the streamed one-hot (its
                  pre_packed entry up to 126 slots, pre beyond); the
                  splits are applied every round (apply_splits)
  pallas          kernel F histograms the row-major bins with f32
                  weights; splits applied every round

The others (q_tiled and its split-route variant, seg_tiled, q_onthefly,
pallas_paired, the quantized pallas body, xla) raise and name the plan.

The JAX grower runs a tree as one ``lax.while_loop`` over frontier
rounds; here the loop is driven from the host, one round at a time, and
each round

  1. refreshes the leaves created last round: the round's histogram
     kernel builds the histograms of the new right children (routing
     the pending splits first on the fused plans); each left child is
     parent minus right (the reference's subtraction trick,
     serial_tree_learner.cpp:505-507); the split finder runs on those
     new leaves only and caches their best candidates;
  2. splits every leaf whose cached candidate clears the gain bar,
     gain-ordered within the remaining leaf budget and the frontier
     width (the JAX grower's documented batched best-first order);
  3. builds the route table of the selected splits — applied lazily by
     the next round's fused kernel (or at exit), or at once by
     apply_splits on the other plans.

Because the loop runs on the host, the round knows how many leaves are
new (one small device-to-host read per round) and runs the finder on
exactly those, where the JAX grower pads to its strip ladder; the
results are the same, row by row.  Training without the histogram
cache, distributed learners, forced splits and categorical features are
not ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..ops.histogram import (PACKED_STRIP, QUANT_ROW_LIMIT, QUANT_WEIGHT_MAX,
                             bins_hist, compute_group_histograms_fused,
                             compute_group_histograms_fused_tiled,
                             compute_group_histograms_pre,
                             compute_group_histograms_pre_packed,
                             compute_root_totals, expand_feature_histograms,
                             onehot_width, precompute_bin_onehot,
                             precompute_bin_onehot_packed,
                             quantize_gradients, route_apply_tiled)
from ..ops.partition import (ROUTE_FIXED_COLS, apply_splits,
                             build_route_table)
from ..ops.split import (CAND_COLS, CAND_DEFAULT_LEFT, CAND_FEATURE,
                         CAND_GAIN, CAND_LOUT, CAND_LSC, CAND_LSG, CAND_LSH,
                         CAND_ROUT, CAND_THRESHOLD, find_best_split_block)
from ..utils.log import Log

#: the plans this grower runs
PORTED_PLANS = ("fused_tiled", "fused_streamed", "pre_onehot", "pallas")


def _pick_chunk(n: int, num_groups: int, max_group_bin: int,
                itemsize: int, target_bytes: int = 1 << 26,
                min_chunk: int = 1024) -> int:
    """Row-padding granularity: the JAX grower's rule off-TPU, kept so
    both packages pad to the same row count."""
    per_row = max(num_groups * max_group_bin * itemsize, 1)
    chunk = max(min_chunk, min(n, target_bytes // per_row))
    return int(max(min_chunk, (chunk // min_chunk) * min_chunk))


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: lightgbm_tpu_torch runs the serial "
        "learner's fused_tiled, fused_streamed, pre_onehot and pallas "
        "plans (hist_compute_dtype=bfloat16, numerical features)")


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
                 quant_row_limit: int = QUANT_ROW_LIMIT) -> KernelPlan:
    """The histogram plan the JAX grower resolves for this config and
    data (lightgbm_tpu/learner/grower.py:318-543), warnings included.
    Its Pallas gate asks for a single TPU device; here the port's
    kernels run wherever the grower runs (CUDA, or their plain versions
    on the CPU) and TreeGrower refuses distributed learners first, so
    the gate is 1024-row padding.  Raises ValueError where the JAX
    grower does (hist_precision=tiered past the int32 row bound)."""
    hk = getattr(config, "hist_kernel", "auto")
    if hk not in ("auto", "pallas", "paired", "xla"):
        Log.warning(f"unknown hist_kernel={hk!r}; using 'auto'")
        hk = "auto"
    pallas_ok = n_padded % 1024 == 0
    if hk in ("pallas", "paired") and not pallas_ok:
        Log.warning(f"hist_kernel={hk} unavailable here (needs 1024-row "
                    "padding); falling back to the XLA histogram path")
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
    """Grows trees for one Dataset + Config on one torch device."""

    def __init__(self, dataset: Dataset, config: Config,
                 device: torch.device):
        self.config = config
        self.device = device
        if config.tree_learner != "serial" or config.num_machines > 1 \
                or config.mesh_shape:
            raise _not_ported(f"tree_learner={config.tree_learner}")
        if config.forcedsplits_filename:
            raise _not_ported("forced splits")
        self.num_leaves = L = config.num_leaves
        self.frontier = min(L - 1, config.frontier_width or 126)
        pool = float(getattr(config, "histogram_pool_size", -1.0))
        cache_mb = (L * dataset.num_groups * dataset.max_group_bin * 12
                    ) / (1 << 20)
        if not (pool < 0 or cache_mb <= pool):
            raise _not_ported("training without the histogram cache")
        self.max_group_bin = dataset.max_group_bin
        self.max_feature_bin = dataset.max_feature_bin
        self.num_groups = dataset.num_groups
        self.num_features = dataset.num_features
        meta = dataset.feature_meta_arrays()
        if meta["is_categorical"].any():
            raise _not_ported("categorical split finding")

        n = dataset.num_data
        self.num_data = n
        chunk = _pick_chunk(n, self.num_groups, self.max_group_bin,
                            4 if config.hist_compute_dtype == "float32"
                            else 2)
        self.n_padded = -(-n // chunk) * chunk
        lay = getattr(dataset, "bin_layout", None)
        self.plan = resolve_plan(
            config, n_padded=self.n_padded, num_groups=self.num_groups,
            max_group_bin=self.max_group_bin, frontier=self.frontier,
            pack_P=lay.device_spec if lay is not None else 0)
        if self.plan.name not in PORTED_PLANS:
            raise _not_ported(f"the {self.plan.name} histogram plan")

        def dev(a, dtype=None):
            t = torch.as_tensor(np.asarray(a))
            return (t if dtype is None else t.to(dtype)).to(device)

        self.f_num_bin = dev(meta["num_bin"], torch.int32)
        self.f_default_bin = dev(meta["default_bin"], torch.int32)
        self.f_missing = dev(meta["missing_type"], torch.int32)
        self.f_is_cat = dev(meta["is_categorical"], torch.bool)
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
            min_gain_to_split=config.min_gain_to_split)
        self.max_depth = config.max_depth
        self.max_rounds = L - 1
        self.packed_dispatch = bool(getattr(config, "hist_packed_dispatch",
                                            True))

        # the kernels read the LOGICAL (N, G) byte matrix: a nibble-
        # packed storage layout is unpacked once on the host
        bins = dataset.logical_group_bins()
        pad = self.n_padded - n
        if pad:
            bins = np.concatenate(
                [bins, np.zeros((pad, bins.shape[1]), np.uint8)])
        bins_d = torch.from_numpy(np.ascontiguousarray(bins)).to(device)
        # transposed for the fused kernels' routing; row-major for the
        # bin-reading kernel and apply_splits
        self.binsT = bins_d.t().contiguous() if self.plan.fused else None
        self.bins = None if self.plan.fused else bins_d
        # the streamed one-hot, built once per dataset on the device
        self.ohb = None
        if self.plan.name in ("fused_streamed", "pre_onehot"):
            self.ohb = (precompute_bin_onehot(
                bins_d, max_group_bin=self.max_group_bin)
                if self.plan.ohb_pack == 1 else precompute_bin_onehot_packed(
                    bins_d, max_group_bin=self.max_group_bin,
                    pack=self.plan.ohb_pack))
        del bins_d
        valid = np.zeros(self.n_padded, bool)
        valid[:n] = True
        self.row_valid = torch.from_numpy(valid).to(device)
        self.route_cols = ROUTE_FIXED_COLS + (self.max_feature_bin + 7) // 8

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
        pad = self.n_padded - self.num_data
        if pad == 0:
            return arr
        return np.concatenate([arr, np.full(pad, fill, dtype=arr.dtype)])

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

    def train_tree(self, grad: torch.Tensor, hess: torch.Tensor,
                   counts: torch.Tensor, feature_mask: torch.Tensor
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                              Optional[torch.Tensor]]:
        """Grow one tree.  grad/hess/counts are (n_padded,) f32 with
        zeros on padded rows.  Returns (tree arrays — bin-space, with
        ``num_leaves`` as a python int —, final leaf ids, each row's
        post-route leaf value on the fused plans, else None)."""
        L = self.num_leaves
        d = self.device
        plan = self.plan
        leaf_id = torch.where(self.row_valid, 0, -1).to(torch.int32)
        totals = compute_root_totals(grad, hess, counts, self.row_valid)
        st = dict(
            leaf_sum_grad=torch.zeros(L, device=d),
            leaf_sum_hess=torch.zeros(L, device=d),
            leaf_count=torch.zeros(L, device=d),
            leaf_min_c=torch.full((L,), -np.inf, device=d),
            leaf_max_c=torch.full((L,), np.inf, device=d),
            leaf_is_left=torch.zeros(L, dtype=torch.bool, device=d))
        st["leaf_sum_grad"][0] = totals[0]
        st["leaf_sum_hess"][0] = totals[1]
        st["leaf_count"][0] = totals[2]
        tree = self._init_tree()
        tree["leaf_weight"][0] = totals[1]
        tree["leaf_count"][0] = totals[2]
        cand = torch.zeros((L, CAND_COLS + self.max_feature_bin), device=d)
        cand[:, CAND_GAIN] = -np.inf
        hist_cache = torch.zeros((L, self.num_groups, self.max_group_bin, 3),
                                 device=d)
        route_tab = torch.zeros((L, self.route_cols), device=d)
        # gradients are fixed for the whole tree: quantize (or stack)
        # the weights once, in the layout the plan's kernel reads
        scales = None
        if plan.quant:
            w, scales = quantize_gradients(grad, hess, counts)  # (N, 3)
        else:
            w = torch.stack([grad, hess, counts], dim=1)
        if plan.fused:
            w = w.t().contiguous()                               # (3, N)

        num_leaves = 1
        parents = torch.empty(0, dtype=torch.int32, device=d)
        rights = torch.zeros(1, dtype=torch.int32, device=d)  # the root
        for round_idx in range(self.max_rounds):
            # ---- refresh the leaves created last round
            right_hist, leaf_id = self._histogram(
                w, scales, leaf_id, route_tab, rights)
            left_hist = hist_cache[parents.long()] - right_hist[
                :parents.shape[0]]
            slots = torch.cat([parents, rights]).long()
            h_new = torch.cat([left_hist, right_hist])
            hist_cache[slots] = h_new
            cand[slots] = self._find_splits(st, slots, h_new, feature_mask)

            # ---- select: top-W candidates by gain within the budget
            best_gain = cand[:, CAND_GAIN]
            slot = torch.arange(L, dtype=torch.int32, device=d)
            cand_m = (slot < num_leaves) & (best_gain > 0.0)
            if self.max_depth > 0:
                cand_m &= tree["leaf_depth"] < self.max_depth
            key = torch.where(cand_m, best_gain,
                              torch.tensor(-np.inf, device=d))
            # stable descending order: ties keep the lower slot first,
            # as lax.top_k does
            top_i = torch.sort(key, descending=True, stable=True
                               ).indices[:self.frontier].to(torch.int32)
            rank = torch.full((L,), L, dtype=torch.int32, device=d)
            rank[top_i.long()] = torch.arange(top_i.shape[0],
                                              dtype=torch.int32, device=d)
            do_split = cand_m & (rank < L - num_leaves)
            k = int(do_split.sum())
            route_args = self._apply_selection(st, tree, cand, do_split,
                                               rank, num_leaves)
            if plan.fused:
                # routed by the next round's kernel (or at exit)
                route_tab = build_route_table(*route_args)
            elif k:
                leaf_id = apply_splits(self.bins, leaf_id, *route_args)
            parents = top_i[:k]
            rights = num_leaves + torch.arange(k, dtype=torch.int32,
                                               device=d)
            num_leaves += k
            if k == 0 or num_leaves >= L:
                break
        tree["num_leaves"] = num_leaves
        if not plan.fused:
            return tree, leaf_id, None
        # the last round's splits were never routed: apply them and take
        # each row's post-route leaf value for the score update (kernel
        # B on both fused plans; the JAX package's fused_streamed plan
        # runs the same function through XLA's apply_route_table)
        leaf_id, row_val = route_apply_tiled(self.binsT, leaf_id, route_tab,
                                             tree["leaf_value"])
        return tree, leaf_id, row_val

    def _histogram(self, w, scales, leaf_id, route_tab, slots):
        """The plan's histogram pass over ``slots`` with the tree's
        weights ``w`` (in the layout the plan's kernel reads): returns
        ((W, G, B, 3) f32 histograms, leaf ids after the pass)."""
        plan = self.plan
        B, G = self.max_group_bin, self.num_groups
        if plan.name == "fused_tiled":
            return compute_group_histograms_fused_tiled(
                self.binsT, w, scales, leaf_id, route_tab, slots,
                max_group_bin=B)
        if plan.name == "fused_streamed":
            return compute_group_histograms_fused(
                self.ohb, self.binsT, w, scales, leaf_id, route_tab, slots,
                max_group_bin=B, quant=plan.quant, pack=plan.ohb_pack,
                num_groups=G)
        if plan.name == "pallas":
            return bins_hist(self.bins, w, leaf_id, slots, B), leaf_id
        # pre_onehot: the JAX strip ladder (_packed_dispatch) takes the
        # channel-packed kernel whenever the new leaves fit its strips
        k = slots.shape[0]
        if self.packed_dispatch and (k <= 2 * PACKED_STRIP
                                     or self.frontier <= 3 * PACKED_STRIP):
            return compute_group_histograms_pre_packed(
                self.ohb, w, scales, leaf_id, slots, max_group_bin=B,
                quant=plan.quant, pack=plan.ohb_pack, num_groups=G), leaf_id
        return compute_group_histograms_pre(
            self.ohb, w, scales, leaf_id, num_leaves=self.num_leaves,
            max_group_bin=B, quant=plan.quant, slots=slots,
            pack=plan.ohb_pack, num_groups=G), leaf_id

    # ------------------------------------------------------------------
    def _find_splits(self, st, slots, h_w, feature_mask) -> torch.Tensor:
        """Best split of each leaf in ``slots`` from its group
        histograms, as packed candidate rows."""
        sg = st["leaf_sum_grad"][slots]
        sh = st["leaf_sum_hess"][slots]
        sc = st["leaf_count"][slots]
        totals = torch.stack([sg, sh, sc], dim=1)
        feat_hist = expand_feature_histograms(h_w, self.bin_map,
                                              self.fix_bin, totals)
        return find_best_split_block(
            feat_hist, sg, sh, sc, st["leaf_min_c"][slots],
            st["leaf_max_c"][slots], self.cfg_scalars, self.f_num_bin,
            self.f_missing, self.f_default_bin, self.f_monotone,
            self.f_is_cat, feature_mask, False)

    def _apply_selection(self, st, tree, cand, do_split, rank,
                         num_leaves: int) -> torch.Tensor:
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

        return (do_split, self.f_group[best_f], self.f_gb_lo[best_f],
                self.f_gb_hi[best_f], self.f_gb_shift[best_f],
                self.f_gb_oor[best_f], f_is_cat, thr, dleft,
                self.f_missing[best_f], self.f_default_bin[best_f],
                self.f_num_bin[best_f], cat_mask, right_slot)
