"""Histogram construction: quantized gradients, the fused route +
frontier histogram and its route-free twin, the route passes (exit
route, route only), the histograms of the streamed bin one-hot, of the
bin matrix (f32 or int8 weights) and of leaf-partitioned rows, the XLA
one-hot contraction, and the per-feature view.

Port of lightgbm_tpu/ops/histogram.py for the serial learner's plans.
Every device kernel of a training round is hand-written CUDA:

  A  csrc/fused_route_hist.cu  compute_group_histograms_fused_tiled
  G  csrc/fused_route_hist.cu  compute_group_histograms_q_tiled
  B  csrc/route_apply.cu       route_apply_tiled
  H  csrc/route_apply.cu       route_only_tiled
  D  csrc/onehot_hist.cu       compute_group_histograms_fused
  E  csrc/onehot_hist.cu       compute_group_histograms_pre_packed,
                               compute_group_histograms_pre
  F  csrc/bins_hist.cu         compute_group_histograms_pallas
  K  csrc/bins_hist.cu         compute_group_histograms_pallas_paired
  I  csrc/bins_hist.cu         compute_group_histograms_pallas_q,
                               compute_group_histograms_q_packed
  J  csrc/seg_hist.cu          compute_group_histograms_seg_tiled

Each has a plain PyTorch version here with the same contract.  A
wrapper launches the kernel for CUDA tensors and takes the plain
version only for tensors on the CPU (the tests' device); there is no
fallback between the two.  compute_group_histograms, the XLA form the
JAX package runs outside any Pallas kernel, is torch ops on every
device.

Sub-byte bin storage (packing.py; the JAX package's bin_packing=4bit,
2bit, auto): every reader of the bins but kernels F, K and I takes a
``packed_groups`` pack spec (``pack_spec(P, C)``, 0 for the byte-wide
matrix).  Under a spec the bins are the storage matrix, (cols, N)
transposed or (N, cols), with ``cols = storage_cols(G, spec)``, and each
reader widens the chosen crumbs and nibbles itself: the kernels in
registers (csrc/pack.cuh), the XLA form and the one-hot builders a row
chunk at a time (:func:`unpack_bins_cols`), the plain versions the rows
they read.  Kernels F, K and I read byte-wide row-major bins only, as
their TPU bodies do: the JAX grower sends a packed dataset to the xla
plan instead.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..packing import (logical_groups, packed_bytes, spec_crumb,
                       spec_packed, storage_cols)
from ..utils import prng
from . import kernels
from .partition import ROUTE_FIXED_COLS, apply_route_table

#: int32 histogram-accumulator headroom: quantized weights are int8
#: (|q| <= 127), so a bin that swallowed every row accumulates at most
#: N * 127.
QUANT_WEIGHT_MAX = 127
#: the most rows whose quantized histograms can never overflow the int32
#: accumulator (rows * 127 < 2^31, ~16.9M rows)
QUANT_ROW_LIMIT = (2 ** 31 - 1) // QUANT_WEIGHT_MAX


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       counts: torch.Tensor, key=None):
    """Per-channel symmetric int8 quantization (one scale per tree).
    Returns ((N, 3) int32 quantized weights, (3,) f32 scales).  Without
    ``key`` the weights round half to even; with a ``key``
    (``utils/prng.py``) gradients and hessians round stochastically,
    up with the probability of the fraction, on the two halves of
    ``split(key)``, clipped to +-127 after rounding
    (lightgbm_tpu/ops/histogram.py quantize_gradients: the skewed
    pairwise lambdas of lambdarank need it, and
    ``quant_stochastic_rounding`` asks for it on any objective)."""
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=grad.device)
    # a divisor on the device: torch divides a CUDA tensor by a host
    # scalar through its reciprocal, an ulp off XLA's division
    q_max = torch.tensor(127.0, dtype=torch.float32, device=grad.device)
    s_g = torch.maximum(grad.abs().max() / q_max, tiny)
    s_h = torch.maximum(hess.abs().max() / q_max, tiny)
    if key is None:
        qg = torch.round(grad / s_g)
        qh = torch.round(hess / s_h)
    else:
        kg, kh = prng.split(key)

        def sround(x, k):
            f = torch.floor(x)
            u = prng.uniform(k, x.shape, x.device)
            return torch.clamp(f + (u < x - f).to(x.dtype), -127.0, 127.0)

        qg = sround(grad / s_g, kg)
        qh = sround(hess / s_h, kh)
    wq = torch.stack([qg, qh, counts], dim=1).to(torch.int32)
    scales = torch.stack([s_g, s_h, torch.ones_like(s_g)])
    return wq, scales


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_bins(max_group_bin: int) -> None:
    if not 1 <= max_group_bin <= 256:
        raise ValueError(f"max_group_bin {max_group_bin} not in [1, 256]")


def groups_of_storage(cols: int, packed_groups: int) -> int:
    """The logical groups G of a bin matrix ``cols`` bytes wide under the
    pack spec ``packed_groups`` (``cols`` itself when 0); raises on a
    spec those bytes cannot hold."""
    if not packed_groups:
        return cols
    P, C = spec_packed(packed_groups), spec_crumb(packed_groups)
    if not 0 <= C <= P or P == 0 or cols < packed_bytes(packed_groups):
        raise ValueError(f"pack spec {packed_groups} (P={P}, C={C}) does "
                         f"not fit {cols} storage columns")
    return logical_groups(cols, packed_groups)


def unpack_bins_cols(bins: torch.Tensor, *, num_groups: int,
                     packed_groups: int) -> torch.Tensor:
    """(n, cols) storage block -> (n, G) logical uint8 bins, as
    lightgbm_tpu/ops/histogram.py unpack_bins_cols (:56) widens a row
    chunk: crumb planes, then nibble planes, then the wide bytes.
    Identity when ``packed_groups`` is 0."""
    if packed_groups == 0:
        return bins
    P, C = spec_packed(packed_groups), spec_crumb(packed_groups)
    cb, pb = (C + 3) // 4, packed_bytes(packed_groups)
    n = bins.shape[0]
    parts = []
    if C:
        ck = bins[:, :cb].to(torch.int32)
        parts.append(torch.stack([(ck >> (2 * k)) & 3 for k in range(4)],
                                 dim=2).reshape(n, 4 * cb)[:, :C])
    if P > C:
        pk = bins[:, cb:pb].to(torch.int32)
        parts.append(torch.stack([pk & 15, (pk >> 4) & 15],
                                 dim=2).reshape(n, 2 * (pb - cb))[:, :P - C])
    if bins.shape[1] > pb:
        parts.append(bins[:, pb:].to(torch.int32))
    out = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    if out.shape[1] != num_groups:
        raise ValueError(f"storage of {bins.shape[1]} columns holds "
                         f"{out.shape[1]} groups, not {num_groups}")
    return out.to(bins.dtype)


def pack_unit(packed_groups: int) -> int:
    """Logical groups a group chunk should start on so that no storage
    byte straddles two chunks: 2 for nibbles (no crumbs), 4 where the
    crumbs end on a byte (or nothing follows them), 1 for the byte-wide
    matrix and for an ``auto`` layout whose nibbles start inside a crumb
    byte (no unit aligns both sections there)."""
    if not packed_groups:
        return 1
    P, C = spec_packed(packed_groups), spec_crumb(packed_groups)
    if C == 0:
        return 2
    return 4 if C % 4 == 0 or C == P else 1


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# Kernel A: fused route + frontier histogram
# ---------------------------------------------------------------------------
def fused_route_hist_plain(binsT: torch.Tensor, wT: torch.Tensor,
                           leaf_id: torch.Tensor, route_tab: torch.Tensor,
                           slots: torch.Tensor, max_group_bin: int,
                           packed_groups: int = 0):
    """Plain version of kernel A: returns the (W, G, B, 3) int32
    histogram of the rows whose POST-route leaf equals each slot
    (negative slots stay empty) and the (N,) post-route leaf ids; under
    ``packed_groups`` ``binsT`` is the (cols, N) sub-byte storage of the
    G logical groups."""
    new_leaf = apply_route_table(binsT.t(), leaf_id, route_tab,
                                 packed_groups=packed_groups)
    return tiled_hist_plain(binsT, wT, new_leaf, slots, max_group_bin,
                            packed_groups), new_leaf


def _fused_route_hist_cuda(binsT, wT, leaf_id, route_tab, slots,
                           max_group_bin, packed_groups):
    cols, N = binsT.shape
    G = groups_of_storage(cols, packed_groups)
    L, K = route_tab.shape
    W = slots.shape[0]
    leaf_out = torch.empty_like(leaf_id)
    hist, part, plan = _i32_buffers(N, W, G, max_group_bin, binsT.device,
                                    i32_aligned(binsT, wT, leaf_out),
                                    pack_unit(packed_groups))
    kernels.launch("fused_route_hist", binsT.data_ptr(), wT.data_ptr(),
                   leaf_id.data_ptr(), route_tab.data_ptr(),
                   slots.data_ptr(), hist.data_ptr(), leaf_out.data_ptr(),
                   N, G, max_group_bin, L, K, W, plan, part.data_ptr(),
                   packed_groups)
    return hist, leaf_out


def i32_aligned(bins: torch.Tensor, w: torch.Tensor,
                leaf_id: torch.Tensor = None) -> bool:
    """Whether the int32 histogram (kernels A, G, I, J) may read 4 rows
    a thread: the bins 4-byte aligned, the weights and the leaf ids it
    reads (J reads none) 16-byte aligned (either layout;
    :func:`frontier_hist_plan` also wants N % 4 == 0)."""
    return (bins.data_ptr() % 4 == 0 and w.data_ptr() % 16 == 0
            and (leaf_id is None or leaf_id.data_ptr() % 16 == 0))


def _i32_buffers(N, W, G, B, dev, aligned, unit=1):
    """(hist, scratch of the CTAs' copies, C plan) of one launch of
    kernel A, G or I; the kernels write every word of both."""
    plan = _i32_plan_args(N, W, G, B, aligned, dev.index or 0, unit)
    copies = plan[3]                    # grid x: one copy a CTA
    hist = torch.empty((W, G, B, 3), dtype=torch.int32, device=dev)
    part = torch.empty((copies * hist.numel(),), dtype=torch.int32,
                       device=dev)
    return hist, part, plan


def fused_route_hist(binsT: torch.Tensor, wT: torch.Tensor,
                     leaf_id: torch.Tensor, route_tab: torch.Tensor,
                     slots: torch.Tensor, max_group_bin: int,
                     packed_groups: int = 0):
    """Kernel A on CUDA tensors, its plain version on CPU tensors:
    ``(int32 hist (W, G, B, 3), new leaf ids (N,))``.

    Kernel A (csrc/fused_route_hist.cu) replaces the Pallas kernel
    _fused_kernel_body_q_tiled (lightgbm_tpu/ops/histogram.py:1412).
    On the card it is bound by its histogram adds, not by its ~48 B per
    row of traffic: one launch routes the rows, a second adds them into
    private int32 histograms in shared memory (csrc/hist_i32.cuh, the
    geometry of :func:`frontier_hist_plan`) and stores one copy a CTA,
    a third sums the copies (see the source notes there).

    Args:
      binsT: (G, N) uint8 transposed group bins, or under
        ``packed_groups`` their (cols, N) sub-byte storage (the kernel
        widens each group's storage byte in registers).
      wT: (3, N) int32 quantized weights in [-127, 127].
      leaf_id: (N,) int32 pre-route leaf ids (negative = padded row).
      route_tab: (L, 15 + nb) f32 pending route table (all-zero routes
        nothing).
      slots: (W,) int32 frontier slots; the histogram rows follow this
        order and a negative slot's row stays zero.
      packed_groups: the pack spec (packing.py pack_spec), 0: byte-wide.
    """
    _check(binsT, "binsT", torch.uint8, 2)
    _check(wT, "wT", torch.int32, 2)
    _check(leaf_id, "leaf_id", torch.int32, 1)
    _check(route_tab, "route_tab", torch.float32, 2)
    _check(slots, "slots", torch.int32, 1)
    cols, N = binsT.shape
    groups_of_storage(cols, packed_groups)
    if wT.shape != (3, N) or leaf_id.shape != (N,):
        raise ValueError(f"wT {tuple(wT.shape)} / leaf_id "
                         f"{tuple(leaf_id.shape)} do not match N={N}")
    if route_tab.shape[1] < ROUTE_FIXED_COLS:
        raise ValueError("route_tab needs at least 15 columns")
    _check_bins(max_group_bin)
    dev = _same_device(binsT, wT, leaf_id, route_tab, slots)
    if dev.type == "cuda":
        return _fused_route_hist_cuda(binsT, wT, leaf_id, route_tab, slots,
                                      max_group_bin, packed_groups)
    return fused_route_hist_plain(binsT, wT, leaf_id, route_tab, slots,
                                  max_group_bin, packed_groups)


def compute_group_histograms_fused_tiled(
        binsT: torch.Tensor, wT: torch.Tensor, scales: torch.Tensor,
        leaf_id: torch.Tensor, route_tab: torch.Tensor,
        slots: torch.Tensor, *, max_group_bin: int, packed_groups: int = 0):
    """Fused route + int8 frontier histogram, dequantized: returns
    ``(hist (W, G, B, 3) f32, new_leaf (N,))`` with the histogram rows
    following ``slots`` (the JAX entry point pads the slot list to its
    lane ladder; here the output has exactly ``len(slots)`` rows)."""
    hist, new_leaf = fused_route_hist(binsT, wT, leaf_id, route_tab, slots,
                                      max_group_bin, packed_groups)
    return hist.to(torch.float32) * scales, new_leaf


# ---------------------------------------------------------------------------
# Kernel G: kernel A's int8 frontier histogram without the routing
# ---------------------------------------------------------------------------
def tiled_hist_plain(binsT: torch.Tensor, wT: torch.Tensor,
                     leaf_id: torch.Tensor, slots: torch.Tensor,
                     max_group_bin: int,
                     packed_groups: int = 0) -> torch.Tensor:
    """Plain version of kernel G: the (W, G, B, 3) int32 histogram of
    the rows whose leaf equals each slot, from the transposed bins (or
    their (cols, N) sub-byte storage under ``packed_groups``) and
    weights."""
    return bins_hist_plain(binsT.t(), wT.t(), leaf_id, slots, max_group_bin,
                           packed_groups)


def tiled_hist(binsT: torch.Tensor, wT: torch.Tensor, leaf_id: torch.Tensor,
               slots: torch.Tensor, max_group_bin: int,
               packed_groups: int = 0) -> torch.Tensor:
    """Kernel G on CUDA tensors, its plain version on CPU tensors: the
    (W, G, B, 3) int32 histogram following ``slots``.

    Kernel G (csrc/fused_route_hist.cu, kernel A's source and its
    histogram, csrc/hist_i32.cuh) replaces the Pallas kernel
    _hist_kernel_body_q_tiled (lightgbm_tpu/ops/histogram.py:1021).
    ``binsT`` is the (G, N) uint8 transposed bin matrix (or, under the
    pack spec ``packed_groups``, its (cols, N) sub-byte storage, widened
    in registers), ``wT`` the (3, N) int32 quantized weights,
    ``leaf_id`` the (N,) current leaf ids (negative = padded row)."""
    _check(binsT, "binsT", torch.uint8, 2)
    _check(wT, "wT", torch.int32, 2)
    _check(leaf_id, "leaf_id", torch.int32, 1)
    _check_slots(slots)
    cols, N = binsT.shape
    G = groups_of_storage(cols, packed_groups)
    if wT.shape != (3, N) or leaf_id.shape != (N,):
        raise ValueError(f"wT {tuple(wT.shape)} / leaf_id "
                         f"{tuple(leaf_id.shape)} do not match N={N}")
    _check_bins(max_group_bin)
    dev = _same_device(binsT, wT, leaf_id, slots)
    if dev.type != "cuda":
        return tiled_hist_plain(binsT, wT, leaf_id, slots, max_group_bin,
                                packed_groups)
    W = slots.shape[0]
    hist, part, plan = _i32_buffers(N, W, G, max_group_bin, dev,
                                    i32_aligned(binsT, wT, leaf_id),
                                    pack_unit(packed_groups))
    kernels.launch("tiled_hist", binsT.data_ptr(), wT.data_ptr(),
                   leaf_id.data_ptr(), slots.data_ptr(), hist.data_ptr(), N,
                   G, max_group_bin, W, plan, part.data_ptr(), packed_groups)
    return hist


def compute_group_histograms_q_tiled(
        binsT: torch.Tensor, wT: torch.Tensor, scales: torch.Tensor,
        leaf_id: torch.Tensor, slots: torch.Tensor, *,
        max_group_bin: int, packed_groups: int = 0) -> torch.Tensor:
    """int8 frontier histogram of the transposed bins, dequantized:
    (W, G, B, 3) f32 following ``slots`` (the JAX entry point pads the
    slot list to its strip ladder; here the output has exactly
    ``len(slots)`` rows)."""
    hist = tiled_hist(binsT, wT, leaf_id, slots, max_group_bin,
                      packed_groups)
    return hist.to(torch.float32) * scales


# ---------------------------------------------------------------------------
# Kernel B: exit route + per-row leaf value
# ---------------------------------------------------------------------------
def route_apply_plain(binsT: torch.Tensor, leaf_id: torch.Tensor,
                      route_tab: torch.Tensor, values: torch.Tensor,
                      packed_groups: int = 0):
    """Plain version of kernel B: ``(new_leaf, row_value)``; under
    ``packed_groups`` ``binsT`` is the (cols, N) sub-byte storage."""
    return apply_route_table(binsT.t(), leaf_id, route_tab, values=values,
                             packed_groups=packed_groups)


def route_apply_tiled(binsT: torch.Tensor, leaf_id: torch.Tensor,
                      route_tab: torch.Tensor, values: torch.Tensor,
                      packed_groups: int = 0):
    """Exit route: apply the final pending route table and return each
    row's post-route leaf id and leaf value (bf16-split reassembly, 0.0
    on rows with a negative leaf).  Kernel B on CUDA tensors, the plain
    version on CPU tensors.

    Kernel B (csrc/route_apply.cu) replaces the Pallas kernel
    _route_value_kernel_body (lightgbm_tpu/ops/histogram.py:1632): one
    launch, memory-bound at ~13 B per row, that derives each leaf's
    bf16-split keep and right-child values itself from ``values`` (the
    JAX package builds them as six table columns first; see the source
    note).  Under the pack spec ``packed_groups`` ``binsT`` is the (cols,
    N) sub-byte storage; each leaf's route record then carries its
    group's storage byte, shift and mask."""
    _check(values, "values", torch.float32, 1)
    G = _check_route(binsT, leaf_id, route_tab, packed_groups)
    N = binsT.shape[1]
    L, K = route_tab.shape
    if values.shape != (L,):
        raise ValueError("route_apply_tiled: shape mismatch")
    dev = _same_device(binsT, leaf_id, route_tab, values)
    if dev.type != "cuda":
        return route_apply_plain(binsT, leaf_id, route_tab, values,
                                 packed_groups)
    leaf_out = torch.empty_like(leaf_id)
    val_out = torch.empty((N,), dtype=torch.float32, device=dev)
    kernels.launch("route_apply", binsT.data_ptr(), leaf_id.data_ptr(),
                   route_tab.data_ptr(), values.data_ptr(),
                   leaf_out.data_ptr(), val_out.data_ptr(), N, G, L, K,
                   _num_sms(dev.index or 0), packed_groups)
    return leaf_out, val_out


def _check_route(binsT, leaf_id, route_tab, packed_groups) -> int:
    """Checks of a route pass's operands; returns the logical groups."""
    _check(binsT, "binsT", torch.uint8, 2)
    _check(leaf_id, "leaf_id", torch.int32, 1)
    _check(route_tab, "route_tab", torch.float32, 2)
    cols, N = binsT.shape
    G = groups_of_storage(cols, packed_groups)
    if leaf_id.shape != (N,) or route_tab.shape[1] < ROUTE_FIXED_COLS:
        raise ValueError("route pass: shape mismatch")
    if G >= 65536:
        raise ValueError("at most 65535 feature groups (the route table "
                         "encodes the group index as two bytes)")
    return G


# ---------------------------------------------------------------------------
# Kernel H: kernel B's routing without the row values
# ---------------------------------------------------------------------------
def route_only_plain(binsT: torch.Tensor, leaf_id: torch.Tensor,
                     route_tab: torch.Tensor,
                     packed_groups: int = 0) -> torch.Tensor:
    """Plain version of kernel H: the post-route leaf ids (``binsT`` the
    (cols, N) sub-byte storage under ``packed_groups``)."""
    return apply_route_table(binsT.t(), leaf_id, route_tab,
                             packed_groups=packed_groups)


def route_only_tiled(binsT: torch.Tensor, leaf_id: torch.Tensor,
                     route_tab: torch.Tensor,
                     packed_groups: int = 0) -> torch.Tensor:
    """Apply a pending route table to the leaf ids: returns the (N,)
    post-route leaf ids.  Kernel H on CUDA tensors, the plain version on
    CPU tensors.

    Kernel H (csrc/route_apply.cu) replaces the Pallas kernel
    _route_only_kernel_body (lightgbm_tpu/ops/histogram.py:1654): kernel
    B's one launch with its values off (a grid of a few CTAs an SM, 4
    rows a thread where N and the pointers allow it), memory-bound at ~8
    B per row plus a bin byte per row of a splitting leaf.  Under the pack
    spec ``packed_groups`` ``binsT`` is the (cols, N) sub-byte storage
    (see :func:`route_apply_tiled`)."""
    G = _check_route(binsT, leaf_id, route_tab, packed_groups)
    N = binsT.shape[1]
    L, K = route_tab.shape
    dev = _same_device(binsT, leaf_id, route_tab)
    if dev.type != "cuda":
        return route_only_plain(binsT, leaf_id, route_tab, packed_groups)
    leaf_out = torch.empty_like(leaf_id)
    kernels.launch("route_only", binsT.data_ptr(), leaf_id.data_ptr(),
                   route_tab.data_ptr(), leaf_out.data_ptr(), N, G, L, K,
                   _num_sms(dev.index or 0), packed_groups)
    return leaf_out


# ---------------------------------------------------------------------------
# f32-weight histograms: weight rounding and the streamed bin one-hot
# ---------------------------------------------------------------------------
#: the JAX kernels' lane strip: 3 channels x 42 slots fill a 128-lane tile
PACKED_STRIP = 42
#: frontier slots a histogram kernel keeps in shared memory (48 KB)
MAX_KERNEL_SLOTS = 12288


# ---------------------------------------------------------------------------
# Launch geometry of the f64 shared-memory histograms (kernels D, E, F, K)
# ---------------------------------------------------------------------------
#: dynamic shared memory one CTA may use on an H100 (227 KB)
SMEM_PER_CTA = 232_448
#: shared memory of one H100 SM (228 KB); the hardware keeps 1 KB of it
#: per resident CTA
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_CTA = 1024
#: SMs of an H100 SXM, the geometry's default when no card is asked
H100_SMS = 132
#: csrc/hist_f64.cuh: at most 8 warps a CTA (one private histogram each,
#: 255 registers a thread), so at most 8 slots a CTA
MAX_SLOTS_PER_CTA = 8
#: rows a thread scans per batch (kScanBatch), ring stages, and list
#: entries beyond one batch (the list is processed when one more batch
#: might not fit)
SCAN_BATCH = 8
RING_STAGES = 3
LIST_SLACK = 1024
#: bytes of one ring stage: one-hot rows (D, E), rows of bins (F, K); a
#: stage holds at most 32 rows (a warp picks its rows with one ballot)
ONEHOT_STAGE_BYTES = 17_408
BINS_STAGE_BYTES = 1_536
MAX_STAGE_ROWS = 32
#: one-hot rows of a frontier of at most COLS_MAX_SLOTS slots: one slot
#: a CTA, whose COLS_THREADS threads each own 4 bytes of every row's
#: columns (every thread adds every landed row, however the rows fall
#: over the slots)
COLS_THREADS = 128
COLS_MAX_SLOTS = 128
#: CTAs a column-owner launch aims at for each slot (its share follows
#: the slot's work, so a large leaf needs many), in at most this many
#: waves of CTAs
COLS_CTAS_PER_SLOT = 8
COLS_MAX_WAVES = 4
#: leaf ids each CTA of a column-owner launch samples to share the CTAs
#: out over the slot chunks (kSample), and the most chunks the sample
#: serves (kMaxSampledChunks)
CHUNK_SAMPLE = 1024
MAX_SAMPLED_CHUNKS = 128
#: otherwise one private histogram a warp: the fewest a CTA keeps before
#: its groups are split
MIN_WARPS_PER_CTA = 4


class HistPlan(NamedTuple):
    """Launch geometry of one f64 shared-memory histogram launch
    (csrc/hist_f64.cuh).  The kernel reads it as given: the W slots fall
    into ``chunks`` chunks of ``slots_per_cta``, the groups into grid z
    chunks of ``groups_per_cta``, and the grid x CTAs of each group chunk
    are shared out over the slot chunks on the card, from the data
    (:func:`chunk_ctas`); the CTA has one warp per private histogram,
    ``slots_per_cta * copies`` of them, or COLS_THREADS column owners
    (``cols``); the byte offsets carve its dynamic shared memory (the
    f64 histograms start at 0); a staged row takes ``row_stride`` bytes
    (payload, then the three f32 weights at the payload's 16-byte
    round-up).  ``shared`` 1: the CTAs go to the slot chunks by their
    sampled work, else in equal shares."""
    slots_per_cta: int
    copies: int
    groups_per_cta: int
    chunks: int
    stage_rows: int
    list_rows: int
    off_stage: int
    off_list: int
    off_count: int
    smem_bytes: int
    grid: tuple
    threads: int
    row_stride: int
    cols: int              # 1: COLS_THREADS column owners, one slot
    shared: int            # 1: CTAs by sampled work (chunk_ctas)

    def as_args(self):
        """The int64 array the C entry point reads (Plan in
        csrc/hist_f64.cuh, in this order)."""
        import ctypes
        vals = (self.slots_per_cta, self.copies, self.groups_per_cta,
                self.chunks, self.stage_rows, self.list_rows,
                self.off_stage, self.off_list, self.off_count,
                self.smem_bytes, *self.grid, self.threads, self.row_stride,
                self.cols, self.shared)
        return (ctypes.c_int64 * len(vals))(*vals)


def _f64_layout(units: int, warps: int, gc: int, B: int, stage_rows: int,
                rstride: int):
    """(list_rows, off_stage, off_list, off_count, smem) of
    csrc/hist_f64.cuh with ``units`` f64 histograms and ``warps`` warps:
    the histograms, the ring, the list's rows (uint32) and slot masks
    (uint16), and the list's counter."""
    # the list's space first holds the sample that shares the CTAs out
    list_rows = max(32 * warps * SCAN_BATCH + LIST_SLACK,
                    MAX_SAMPLED_CHUNKS + CHUNK_SAMPLE + 3)
    off_stage = _round_up(units * gc * B * 3 * 8, 16)
    off_list = off_stage + RING_STAGES * stage_rows * rstride
    off_count = off_list + _round_up(6 * list_rows, 16)
    smem = off_count + 16
    return list_rows, off_stage, off_list, off_count, smem


@functools.lru_cache(maxsize=None)
def _f64_units(G: int, B: int, rstride: int, stage_bytes: int,
               cols: bool):
    """(histograms, ring stage rows, groups per CTA): more histograms
    first, then longer stages (down to half the longest), before the
    groups split (column owners: when not one histogram fits; one
    histogram a warp: when fewer than MIN_WARPS_PER_CTA fit)."""
    top = max(1, min(MAX_STAGE_ROWS, stage_bytes // rstride))
    least = 1 if cols else MIN_WARPS_PER_CTA

    def fits(units, gc, rows):
        warps = COLS_THREADS // 32 if cols else units
        return _f64_layout(units, warps, gc, B, rows,
                           rstride)[-1] <= SMEM_PER_CTA

    def most_units(gc, rows):
        return max([u for u in range(1, MAX_SLOTS_PER_CTA + 1)
                    if fits(u, gc, rows)], default=0)

    units, rows = max((most_units(G, r), r)
                      for r in range(max(1, top // 2), top + 1))
    if units >= least:
        return units, rows, G
    gc = max([g for g in range(1, G + 1) if fits(least, g, top)],
             default=1)
    return max(1, most_units(gc, top)), top, gc


def _f64_hist_plan(n: int, W: int, G: int, B: int, payload: int,
                   num_sms: int, stage_bytes: int,
                   onehot: bool) -> HistPlan:
    """One-hot rows of a frontier of at most COLS_MAX_SLOTS slots take
    one slot a CTA with column owners (two CTAs an SM at 28 x 63), so
    every landed row is added by all of a CTA's threads whichever slot it
    is in, and the kernel shares the CTAs out over the slots by their
    sampled work (:func:`chunk_ctas`; a tree's middle rounds put most
    rows in a few slots), aiming at COLS_CTAS_PER_SLOT CTAs a slot in up
    to COLS_MAX_WAVES waves.  Every other launch keeps as many histograms
    as fit beside the ring and the list (at most 8, :func:`_f64_units`),
    one a warp: S = min(W, that) slots, C copies of each, and the CTAs in
    equal shares (a warp adds only its slot's rows, so a share by the
    chunk's work would still leave its other warps idle) of one wave.
    Every slot chunk gets at least one CTA."""
    rstride = _round_up(max(payload, 1), 16) + 16
    cols = onehot and W <= COLS_MAX_SLOTS
    units, stage_rows, gc = _f64_units(G, B, rstride, stage_bytes, cols)
    S = 1 if cols else max(1, min(W, units))
    C = 1 if cols else max(1, units // S)
    threads = COLS_THREADS if cols else 32 * S * C
    list_rows, off_stage, off_list, off_count, smem = _f64_layout(
        S * C, threads // 32, gc, B, stage_rows, rstride)
    chunks, gz = max(1, -(-W // S)), -(-G // gc)
    ctas = num_sms * max(1, min(SMEM_PER_SM // (smem
                                               + SMEM_RESERVED_PER_CTA),
                                2048 // threads))
    wave = ctas // gz
    if cols:
        wave = min(COLS_MAX_WAVES * wave,
                   max(wave, COLS_CTAS_PER_SLOT * chunks))
    # no more CTAs than the rows can give 32 each
    T = max(chunks, min(wave, chunks * -(-max(n, 1) // 32)))
    return HistPlan(S, C, gc, chunks, stage_rows, list_rows, off_stage,
                    off_list, off_count, smem, (T, 1, gz), threads,
                    rstride, int(cols), int(cols and chunks > 1))


def chunk_ctas(plan: HistPlan, hits=None):
    """The CTAs of each slot chunk, as csrc/hist_f64.cuh pick_chunk shares
    a group chunk's grid x CTAs out.  With ``plan.shared`` (and at most
    MAX_SAMPLED_CHUNKS chunks) chunk c costs its landed rows' staged
    bytes plus the leaf-id scan every chunk makes, ``hits[c]`` being the
    number of its landed rows among CHUNK_SAMPLE evenly spaced leaf ids;
    otherwise every chunk costs the same.  Chunk c takes one CTA plus its
    cost's share of the rest, rounded down, so every chunk gets at least
    one CTA and the sum is at most grid x."""
    T, n = plan.grid[0], plan.chunks
    if plan.shared and n <= MAX_SAMPLED_CHUNKS:
        cost = [h * plan.row_stride + 4 * CHUNK_SAMPLE for h in hits]
    else:
        cost = [1] * n
    total, spare = sum(cost), T - n
    return [1 + spare * c // total for c in cost]


def chunk_rows(n: int, ctas: int):
    """The row ranges [begin, end) of a chunk's ``ctas`` CTAs: equal
    ranges of whole warps (csrc/hist_f64.cuh)."""
    per = _round_up(-(-n // ctas), 32)
    return [(min(n, i * per), min(n, i * per + per)) for i in range(ctas)]


def onehot_hist_plan(n: int, W: int, G: int, B: int, row_bytes: int,
                     num_sms: int = H100_SMS) -> HistPlan:
    """Geometry of kernels D and E with f32 weights: staged rows are the
    ``row_bytes``-byte one-hot rows (42 KB histograms at 28 x 63: up to
    COLS_MAX_SLOTS slots one a CTA, two CTAs an SM; a wider frontier 4
    slots a CTA, one warp each)."""
    return _f64_hist_plan(n, W, G, B, row_bytes, num_sms,
                          ONEHOT_STAGE_BYTES, True)


def bins_hist_plan(n: int, W: int, G: int, B: int,
                   num_sms: int = H100_SMS) -> HistPlan:
    """Geometry of kernels F and K: staged rows are the G bin bytes (5
    private histograms at 28 x 63)."""
    return _f64_hist_plan(n, W, G, B, G, num_sms, BINS_STAGE_BYTES, False)


# ---------------------------------------------------------------------------
# Launch geometry of the int32 shared-memory histogram (kernels A, G on
# the transposed layout, I on the row-major one)
# ---------------------------------------------------------------------------
#: csrc/hist_i32.cuh: threads of a CTA (kThreads), one CTA an SM (its
#: launch bounds keep 64 registers a thread)
I32_THREADS = 1024
#: leaf ids the CTA's leaf -> slot table maps directly (int32 heads);
#: a row with a larger leaf id scans the slots past the table
SLOT_TABLE = 2048


class I32Plan(NamedTuple):
    """Launch geometry of one int32 shared-memory histogram launch
    (csrc/hist_i32.cuh).  The kernel reads it as given: the W slots fall
    into grid z chunks of ``slots_per_cta``, the G groups into grid y
    chunks of ``groups_per_cta``, and the grid x CTAs of each (group,
    slot) chunk take every grid-x-th stride of ``threads`` runs of
    ``rows_per_thread`` rows (4 where N and the pointers allow it); the
    byte offsets carve the CTA's dynamic shared memory: the (S, gc, B, 3)
    int32 histogram at 0, then the S slot values, the S chain links, the
    S positions of slots past the table, the ``table`` leaf -> position
    heads, and the count of slots past the table."""
    slots_per_cta: int
    groups_per_cta: int
    table: int
    grid: tuple
    threads: int
    rows_per_thread: int
    off_slots: int
    off_next: int
    off_far: int
    off_head: int
    off_nfar: int
    smem_bytes: int

    def as_args(self):
        """The int64 array the C entry points read (Plan in
        csrc/hist_i32.cuh, in this order)."""
        import ctypes
        vals = (self.slots_per_cta, self.groups_per_cta, self.table,
                *self.grid, self.threads, self.rows_per_thread,
                self.off_slots, self.off_next,
                self.off_far, self.off_head, self.off_nfar, self.smem_bytes)
        return (ctypes.c_int64 * len(vals))(*vals)


def _i32_layout(S: int, gc: int, B: int):
    """(off_slots, off_next, off_far, off_head, off_nfar, smem) of a CTA
    with S slots and gc groups of B bins (csrc/hist_i32.cuh)."""
    off_slots = _round_up(S * gc * B * 12, 16)
    off_next = off_slots + _round_up(4 * S, 16)
    off_far = off_next + _round_up(4 * S, 16)
    off_head = off_far + _round_up(4 * S, 16)
    off_nfar = off_head + 4 * SLOT_TABLE
    return off_slots, off_next, off_far, off_head, off_nfar, off_nfar + 16


def _i32_most(budget: int, B: int, S: int = None, gc: int = None) -> int:
    """The most groups (given S) or slots (given gc) whose layout fits
    ``budget`` bytes; 0 if none."""
    def fits(s, g):
        return _i32_layout(s, g, B)[-1] <= budget
    lo, hi = 0, 1
    while fits(*((S, hi) if S is not None else (hi, gc))):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(*((S, mid) if S is not None else (mid, gc))):
            lo = mid
        else:
            hi = mid
    return lo


def frontier_hist_plan(n: int, W: int, G: int, B: int,
                       num_sms: int = H100_SMS,
                       aligned: bool = True, unit: int = 1) -> I32Plan:
    """Geometry of kernels A, G (transposed bins and weights) and I
    (row-major ones): one CTA of I32_THREADS threads an SM.
    Group chunks over all W slots where one group of them fits a CTA
    (126 slots x 63 bins: 95 KB, so two groups a CTA; a tree's first
    round takes all 28 groups of its one slot): as few chunks as fit,
    their groups evened out (32 slots: 4 chunks of 7, not 3 of 9 and
    one of 1: a thread adds its groups 8 at a time).
    Only where one group of all W slots overflows a CTA (126 slots x 255
    bins: 385 KB) do the slots split too, one group a CTA and as many
    slots as fit.  The SMs are shared equally over the (group, slot)
    chunks, at least one CTA each and no more than the rows need (a run
    of rows a thread: 4 rows where N % 4 == 0 and the pointers are
    ``aligned`` (:func:`i32_aligned`), so that a thread reads 4 rows'
    leaf ids and weights as int4 and their bins as words, else 1).  Each
    CTA's histogram is one copy in the (grid x, W, G, B, 3) scratch
    that a second launch sums.

    Both layouts take the same plan.  Row-major, each group chunk
    re-reads every landed row's 32-byte sector of bins (transposed, only
    its own groups' bytes; the 28 MB bin matrix of the bench shape fits
    the H100's 50 MB L2): at W=126 kernel I takes ~0.04 ms more than G
    (PERF.md).  Slot chunks of all G groups would read each row once,
    but a chunk's CTAs would then follow its slots' rows, which a tree's
    middle rounds put mostly in a few slots; group chunks cost no
    balance.

    Sub-byte storage (A, G): ``unit`` (:func:`pack_unit`) groups share a
    storage byte, and the group chunk is rounded up to a multiple of it
    where that still fits, so that no byte is read by two chunks' CTAs
    (a chunk that ends inside a byte is still right: both read it)."""
    G1, W1 = max(G, 1), max(W, 1)
    if _i32_most(SMEM_PER_CTA, B, gc=1) >= W1:
        S = W1
        gy = -(-G1 // _i32_most(SMEM_PER_CTA, B, S=S))
        gc = -(-G1 // gy)       # the same chunks, evened out
        gcu = _round_up(gc, unit)
        if gy > 1 and gcu != gc and \
                _i32_layout(S, gcu, B)[-1] <= SMEM_PER_CTA:
            gc = gcu
            gy = -(-G1 // gc)
    else:
        S, gc, gy = _i32_most(SMEM_PER_CTA, B, gc=1), 1, G1
    gz = -(-W1 // S)
    V = 4 if n % 4 == 0 and aligned else 1
    gx = max(1, min(num_sms // (gy * gz),
                    -(-max(n, 1) // (I32_THREADS * V))))
    if W == 0:                  # nothing to add: one CTA, no slot
        gx = gy = gz = 1
    return I32Plan(S, gc, SLOT_TABLE, (gx, gy, gz), I32_THREADS, V,
                   *_i32_layout(S, gc, B))


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan_args(kind: str, n: int, W: int, G: int, B: int, payload: int,
               index: int):
    """The C plan array of one f64 launch shape on card ``index`` (a
    launch of the same shapes reuses it; the kernels only read it)."""
    sms = _num_sms(index)
    plan = (bins_hist_plan(n, W, G, B, sms) if kind == "bins"
            else onehot_hist_plan(n, W, G, B, payload, sms))
    return plan.as_args()


@functools.lru_cache(maxsize=256)
def _i32_plan_args(n: int, W: int, G: int, B: int, aligned: bool,
                   index: int, unit: int = 1):
    """The C plan array of one int32 histogram launch shape on card
    ``index``."""
    return frontier_hist_plan(n, W, G, B, _num_sms(index),
                              aligned, unit).as_args()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (ties to even), returned as f32: the
    cast every TPU histogram body applies to its f32 weights before the
    bf16 x bf16 -> f32 dot (histogram.py:751-756, :805-808, :1317-1320,
    :257-261).  The CUDA kernels use ``__float2bfloat16_rn``."""
    return x.to(torch.bfloat16).to(torch.float32)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def onehot_width(num_groups: int, max_group_bin: int, pack: int) -> int:
    """Bytes per row of the streamed one-hot: G*B at pack 1, else the
    plane width G*B/pack padded up to a 128-byte multiple."""
    gb = num_groups * max_group_bin
    return gb if pack == 1 else _round_up(gb // pack, 128)


def _onehot_chunk_rows(width: int) -> int:
    """Row chunk of the one-hot builders: the JAX builder's rule, which
    keeps each chunk's transient near 100 MB."""
    chunk = max(1, (1 << 27) // max(width, 1))
    return max(256, (chunk // 256) * 256)


def precompute_bin_onehot(bins: torch.Tensor, *, max_group_bin: int,
                          packed_groups: int = 0) -> torch.Tensor:
    """(N, G) uint8 -> (N, G*B) int8 bin one-hot on the bins' device,
    byte-identical to lightgbm_tpu precompute_bin_onehot
    (histogram.py:571).  Built in row chunks so no (N, G, B) bool is
    ever whole (1.76 GB of output at 1M x 28 x 63).  Under the pack spec
    ``packed_groups`` ``bins`` is the (N, cols) sub-byte storage, each
    row chunk widened as it is read."""
    n, cols = bins.shape
    g = groups_of_storage(cols, packed_groups)
    B = max_group_bin
    out = torch.empty((n, g * B), dtype=torch.int8, device=bins.device)
    biota = torch.arange(B, dtype=torch.int32, device=bins.device)
    step = _onehot_chunk_rows(g * B)
    for i in range(0, n, step):
        bc = unpack_bins_cols(bins[i:i + step], num_groups=g,
                              packed_groups=packed_groups).to(torch.int32)
        out[i:i + step] = (bc[:, :, None] == biota).reshape(
            bc.shape[0], g * B).to(torch.int8)
    return out


def precompute_bin_onehot_packed(bins: torch.Tensor, *, max_group_bin: int,
                                 pack: int,
                                 packed_groups: int = 0) -> torch.Tensor:
    """(N, G) uint8 -> (N, round_up(G*B/pack, 128)) int8 PLANAR sub-byte
    one-hot, byte-identical to lightgbm_tpu
    precompute_bin_onehot_packed (histogram.py:615-681): byte j of a
    row carries full column ``p*GBp + j`` (GBp = G*B/pack) in bit field
    p of width 8/pack, each field 0 or 1; bytes j >= GBp are zero.
    Under the pack spec ``packed_groups`` ``bins`` is the (N, cols)
    sub-byte storage, each row chunk widened as it is read."""
    n, cols = bins.shape
    g = groups_of_storage(cols, packed_groups)
    B = max_group_bin
    gb = g * B
    if gb % pack:
        raise ValueError(f"pack ({pack}) must divide G*B ({gb})")
    gbp = gb // pack
    width = _round_up(gbp, 128)
    bits = 8 // pack
    dev = bins.device
    full = (torch.arange(pack, device=dev)[:, None] * gbp
            + torch.arange(gbp, device=dev)[None, :])          # (pack, gbp)
    gsel = (full // B).long()
    bval = (full % B).to(torch.int32)
    out = torch.zeros((n, width), dtype=torch.int8, device=dev)
    step = _onehot_chunk_rows(gb)
    for i in range(0, n, step):
        bc = unpack_bins_cols(bins[i:i + step], num_groups=g,
                              packed_groups=packed_groups).to(torch.int32)
        acc = torch.zeros((bc.shape[0], gbp), dtype=torch.int8, device=dev)
        for p in range(pack):
            plane = (bc[:, gsel[p]] == bval[p]).to(torch.int8)
            acc += plane * (1 << (p * bits))
        out[i:i + step, :gbp] = acc
    return out


def _check_onehot(ohb: torch.Tensor, num_groups: int, max_group_bin: int,
                  pack: int) -> None:
    _check(ohb, "ohb", torch.int8, 2)
    if pack not in (1, 2, 4):
        raise ValueError(f"pack must be 1, 2 or 4, got {pack}")
    gb = num_groups * max_group_bin
    if gb % pack:
        raise ValueError(f"pack ({pack}) must divide G*B ({gb})")
    want = onehot_width(num_groups, max_group_bin, pack)
    if ohb.shape[1] != want:
        raise ValueError(f"ohb has {ohb.shape[1]} bytes per row; G={num_groups}"
                         f", B={max_group_bin}, pack={pack} need {want}")


def _check_slots(slots: torch.Tensor) -> None:
    _check(slots, "slots", torch.int32, 1)
    if slots.shape[0] > MAX_KERNEL_SLOTS:
        raise ValueError(f"at most {MAX_KERNEL_SLOTS} slots per pass, got "
                         f"{slots.shape[0]}")


def _slot_rows(leaf: torch.Tensor, slots: torch.Tensor):
    """(slot position, row) of every live row whose leaf equals a slot;
    a row counts once for EVERY equal slot, as the TPU's slot one-hot
    does, and negative slots or leaves match nothing."""
    match = ((leaf[None, :] == slots[:, None]) & (slots[:, None] >= 0)
             & (leaf[None, :] >= 0))
    return match.nonzero(as_tuple=True)


def _acc_weights(w: torch.Tensor) -> torch.Tensor:
    """Accumulation form of (P, 3) weights: int32 quantized weights as
    int64 (exact), f32 weights rounded to bf16 and widened to f64."""
    if w.dtype == torch.int32:
        return w.to(torch.int64)
    return bf16_round(w).to(torch.float64)


def _finish(hist: torch.Tensor) -> torch.Tensor:
    """Accumulator -> the kernels' output type: int64 sums to int32,
    f64 sums rounded once to f32."""
    return hist.to(torch.int32 if hist.dtype == torch.int64
                   else torch.float32)


def onehot_hist_plain(ohb: torch.Tensor, w: torch.Tensor,
                      leaf_id: torch.Tensor, slots: torch.Tensor, *,
                      max_group_bin: int, pack: int,
                      num_groups: int) -> torch.Tensor:
    """Plain version of the streamed-one-hot histogram (kernel D's
    histogram half and kernel E): the (W, G, B, 3) histogram of the rows
    whose leaf equals each slot, read from the one-hot's set bits.
    ``w`` is (N, 3) (any strides): f32 weights give f32 sums of their
    bf16 roundings (accumulated in f64, rounded once), int32 quantized
    weights give exact int32 sums."""
    G, B = num_groups, max_group_bin
    gb = G * B
    gbp = gb // pack
    bits = 8 // pack
    W = slots.shape[0]
    quant = w.dtype == torch.int32
    hist = torch.zeros((W * gb, 3), device=ohb.device,
                       dtype=torch.int64 if quant else torch.float64)
    s_idx, r_idx = _slot_rows(leaf_id, slots)
    if s_idx.numel():
        wv = _acc_weights(w[r_idx])
        ob = ohb.view(torch.uint8)
        step = max(1, (1 << 24) // max(ob.shape[1], 1))
        for c0 in range(0, s_idx.numel(), step):
            rows = ob[r_idx[c0:c0 + step], :gbp]
            sc, wc = s_idx[c0:c0 + step], wv[c0:c0 + step]
            for p in range(pack):
                pi, j = ((rows >> (p * bits)) & 1).nonzero(as_tuple=True)
                hist.index_add_(0, sc[pi] * gb + p * gbp + j, wc[pi])
    return _finish(hist.reshape(W, G, B, 3))


def _onehot_vec(ohb: torch.Tensor) -> int:
    """Widest load (16, 4 or 1 bytes) that every one-hot row allows."""
    rb, ptr = ohb.shape[1], ohb.data_ptr()
    for v in (16, 4):
        if rb % v == 0 and ptr % v == 0:
            return v
    return 1


def _onehot_launch(name: str, ohb, w, leaf_id, slots, *, max_group_bin,
                   pack, num_groups, binsT=None, route_tab=None,
                   packed_groups=0):
    """Launch kernel D (``route_tab`` given; ``binsT`` stored under the
    pack spec ``packed_groups``) or E on CUDA tensors.  ``w`` is (N, 3)
    with any strides.  f32 weights take the geometry of
    :func:`onehot_hist_plan`.  Returns (hist, new leaf ids or None)."""
    G, B = num_groups, max_group_bin
    N = leaf_id.shape[0]
    W = slots.shape[0]
    quant = w.dtype == torch.int32
    acc = torch.zeros((W, G, B, 3), device=ohb.device,
                      dtype=torch.int32 if quant else torch.float64)
    route = route_tab is not None
    L, K = route_tab.shape if route else (0, 0)
    leaf_out = torch.empty_like(leaf_id) if route else None
    plan = None if quant else _plan_args(
        "onehot", N, W, G, B, ohb.shape[1], ohb.device.index or 0)
    kernels.launch(name, ohb.data_ptr(), ohb.shape[1], _onehot_vec(ohb),
                   binsT.data_ptr() if route else None, w.data_ptr(),
                   w.stride(0), w.stride(1), int(quant), leaf_id.data_ptr(),
                   route_tab.data_ptr() if route else None, slots.data_ptr(),
                   acc.data_ptr(), leaf_out.data_ptr() if route else None,
                   N, G, B, L, K, W, pack, G * B // pack, int(route), plan,
                   packed_groups)
    return (acc if quant else acc.to(torch.float32)), leaf_out


def _check_weights(w: torch.Tensor, N: int, name: str) -> None:
    if w.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"{name}: expected float32 or int32 (quantized), "
                        f"got {w.dtype}")
    if tuple(w.shape) != (N, 3):
        raise ValueError(f"{name}: expected ({N}, 3), got {tuple(w.shape)}")


# ---------------------------------------------------------------------------
# Kernel D: fused route + histogram of the streamed one-hot
# ---------------------------------------------------------------------------
def fused_onehot_hist_plain(ohb, binsT, wT, leaf_id, route_tab, slots, *,
                            max_group_bin: int, pack: int, num_groups: int,
                            packed_groups: int = 0):
    """Plain version of kernel D: route every row by the pending table
    (over the (cols, N) sub-byte storage under ``packed_groups``), then
    histogram the rows whose NEW leaf equals each slot.  Returns
    ``(hist (W, G, B, 3), new_leaf (N,))``; see onehot_hist_plain for
    the histogram's type."""
    new_leaf = apply_route_table(binsT.t(), leaf_id, route_tab,
                                 packed_groups=packed_groups)
    hist = onehot_hist_plain(ohb, wT.t(), new_leaf, slots,
                             max_group_bin=max_group_bin, pack=pack,
                             num_groups=num_groups)
    return hist, new_leaf


def fused_onehot_hist(ohb, binsT, wT, leaf_id, route_tab, slots, *,
                      max_group_bin: int, pack: int, num_groups: int,
                      packed_groups: int = 0):
    """Kernel D on CUDA tensors, its plain version on CPU tensors:
    ``(hist (W, G, B, 3), new_leaf (N,))`` — f32 sums of bf16-rounded
    f32 weights, or exact int32 sums of int32 quantized weights.

    Kernel D (csrc/onehot_hist.cu) replaces the Pallas kernel
    _fused_kernel_body (lightgbm_tpu/ops/histogram.py:1272).

    Args:
      ohb: (N, width) int8 one-hot from precompute_bin_onehot (pack 1)
        or precompute_bin_onehot_packed (pack 2, 4).
      binsT: (G, N) uint8 transposed group bins (the routing reads one),
        or under the pack spec ``packed_groups`` their (cols, N)
        sub-byte storage (the routing widens the chosen group's byte;
        the one-hot is built from the same storage by the builders).
      wT: (3, N) f32 (grad, hess, count) or int32 quantized weights.
      leaf_id: (N,) int32 pre-route leaf ids (negative = padded row).
      route_tab: (L, 15 + nb) f32 pending route table (all-zero routes
        nothing).
      slots: (W,) int32 frontier slots; the histogram rows follow this
        order and a negative slot's row stays zero.
    """
    G, B = num_groups, max_group_bin
    _check_onehot(ohb, G, B, pack)
    _check(binsT, "binsT", torch.uint8, 2)
    _check(leaf_id, "leaf_id", torch.int32, 1)
    _check(route_tab, "route_tab", torch.float32, 2)
    _check_slots(slots)
    N = ohb.shape[0]
    cols = storage_cols(G, packed_groups)
    groups_of_storage(cols, packed_groups)
    if binsT.shape != (cols, N) or leaf_id.shape != (N,):
        raise ValueError(f"binsT {tuple(binsT.shape)} / leaf_id "
                         f"{tuple(leaf_id.shape)} do not match ({cols}, "
                         f"{N})")
    if wT.dim() != 2 or not wT.is_contiguous():
        raise ValueError("wT must be a contiguous (3, N) tensor")
    _check_weights(wT.t(), N, "wT.t()")
    if route_tab.shape[1] < ROUTE_FIXED_COLS:
        raise ValueError("route_tab needs at least 15 columns")
    dev = _same_device(ohb, binsT, wT, leaf_id, route_tab, slots)
    if dev.type == "cuda":
        return _onehot_launch("fused_onehot_hist", ohb, wT.t(), leaf_id,
                              slots, max_group_bin=B, pack=pack,
                              num_groups=G, binsT=binsT, route_tab=route_tab,
                              packed_groups=packed_groups)
    return fused_onehot_hist_plain(ohb, binsT, wT, leaf_id, route_tab, slots,
                                   max_group_bin=B, pack=pack, num_groups=G,
                                   packed_groups=packed_groups)


def _groups_of(ohb, max_group_bin, pack, num_groups):
    if num_groups is not None:
        return num_groups
    if pack != 1:
        raise ValueError("num_groups is required when pack > 1")
    return ohb.shape[1] // max_group_bin


def _dequant(hist: torch.Tensor, quant: bool, scales) -> torch.Tensor:
    if not quant:
        return hist
    if hist.dtype != torch.int32 or scales is None:
        raise ValueError("quant=True needs int32 weights and scales")
    return hist.to(torch.float32) * scales


def _check_quant(w: torch.Tensor, quant: bool) -> None:
    if quant != (w.dtype == torch.int32):
        raise TypeError(f"quant={quant} does not match weights of type "
                        f"{w.dtype}")


def compute_group_histograms_fused(
        ohb: torch.Tensor, binsT: torch.Tensor, wT: torch.Tensor,
        scales, leaf_id: torch.Tensor, route_tab: torch.Tensor,
        slots: torch.Tensor, *, max_group_bin: int, quant: bool = False,
        pack: int = 1, num_groups=None, packed_groups: int = 0):
    """Fused route + frontier histogram of the streamed one-hot: returns
    ``(hist (W, G, B, 3) f32, new_leaf (N,))`` with the histogram rows
    following ``slots`` (the JAX entry point pads them to its strip
    ladder; here the output has exactly ``len(slots)`` rows).  With
    ``quant`` the int32 sums are dequantized by ``scales``."""
    _check_quant(wT, quant)
    hist, new_leaf = fused_onehot_hist(
        ohb, binsT, wT, leaf_id, route_tab, slots,
        max_group_bin=max_group_bin, pack=pack,
        num_groups=_groups_of(ohb, max_group_bin, pack, num_groups),
        packed_groups=packed_groups)
    return _dequant(hist, quant, scales), new_leaf


# ---------------------------------------------------------------------------
# Kernel E: histogram of the streamed one-hot (final leaf ids)
# ---------------------------------------------------------------------------
def _onehot_hist_entry(name: str, ohb, w, leaf_id, slots, *,
                       max_group_bin, pack, num_groups):
    G, B = num_groups, max_group_bin
    _check_onehot(ohb, G, B, pack)
    _check(leaf_id, "leaf_id", torch.int32, 1)
    _check_slots(slots)
    N = ohb.shape[0]
    if leaf_id.shape != (N,):
        raise ValueError(f"leaf_id {tuple(leaf_id.shape)} does not match "
                         f"N={N}")
    _check_weights(w, N, "w")
    dev = _same_device(ohb, w, leaf_id, slots)
    if dev.type == "cuda":
        return _onehot_launch(name, ohb, w, leaf_id, slots,
                              max_group_bin=B, pack=pack, num_groups=G)[0]
    return onehot_hist_plain(ohb, w, leaf_id, slots, max_group_bin=B,
                             pack=pack, num_groups=G)


def hist_pre_packed_plain(ohb, w, leaf_id, slots, *, max_group_bin: int,
                          pack: int, num_groups: int) -> torch.Tensor:
    """Plain version of kernel E for compute_group_histograms_pre_packed."""
    return onehot_hist_plain(ohb, w, leaf_id, slots,
                             max_group_bin=max_group_bin, pack=pack,
                             num_groups=num_groups)


def hist_pre_packed(ohb, w, leaf_id, slots, *, max_group_bin: int,
                    pack: int, num_groups: int) -> torch.Tensor:
    """Kernel E behind compute_group_histograms_pre_packed (replaces
    _hist_kernel_body_pre_packed, lightgbm_tpu/ops/histogram.py:769) on
    CUDA tensors, its plain version on CPU tensors.  ``w`` is the (N, 3)
    f32 or int32 weight matrix; returns the (W, G, B, 3) histogram."""
    return _onehot_hist_entry("hist_pre_packed", ohb, w, leaf_id, slots,
                              max_group_bin=max_group_bin, pack=pack,
                              num_groups=num_groups)


def hist_pre_plain(ohb, w, leaf_id, slots, *, max_group_bin: int,
                   pack: int, num_groups: int) -> torch.Tensor:
    """Plain version of kernel E for compute_group_histograms_pre."""
    return onehot_hist_plain(ohb, w, leaf_id, slots,
                             max_group_bin=max_group_bin, pack=pack,
                             num_groups=num_groups)


def hist_pre(ohb, w, leaf_id, slots, *, max_group_bin: int, pack: int,
             num_groups: int) -> torch.Tensor:
    """Kernel E behind compute_group_histograms_pre (replaces
    _hist_kernel_body_pre, lightgbm_tpu/ops/histogram.py:727); same
    contract as :func:`hist_pre_packed`, any number of slots."""
    return _onehot_hist_entry("hist_pre", ohb, w, leaf_id, slots,
                              max_group_bin=max_group_bin, pack=pack,
                              num_groups=num_groups)


def compute_group_histograms_pre_packed(
        ohb: torch.Tensor, w: torch.Tensor, scales, leaf_id: torch.Tensor,
        slots: torch.Tensor, *, max_group_bin: int, quant: bool = False,
        pack: int = 1, num_groups=None) -> torch.Tensor:
    """Streamed-one-hot histogram of at most 3 * PACKED_STRIP frontier
    slots: (W, G, B, 3) f32 following ``slots``.  ``w`` is (N, 3) f32
    (grad, hess, count) or, with ``quant``, int32 quantized weights
    dequantized by ``scales``."""
    _check_quant(w, quant)
    if slots.shape[0] > 3 * PACKED_STRIP:
        raise ValueError(f"at most {3 * PACKED_STRIP} slots, got "
                         f"{slots.shape[0]}")
    hist = hist_pre_packed(ohb, w, leaf_id, slots,
                           max_group_bin=max_group_bin, pack=pack,
                           num_groups=_groups_of(ohb, max_group_bin, pack,
                                                 num_groups))
    return _dequant(hist, quant, scales)


def compute_group_histograms_pre(
        ohb: torch.Tensor, w: torch.Tensor, scales, leaf_id: torch.Tensor,
        *, num_leaves: int, max_group_bin: int, quant: bool = False,
        slots=None, pack: int = 1, num_groups=None) -> torch.Tensor:
    """Streamed-one-hot histogram of every leaf (``slots`` None: rows
    0..num_leaves-1) or of the given slots, any number of them."""
    _check_quant(w, quant)
    if slots is None:
        slots = torch.arange(num_leaves, dtype=torch.int32,
                             device=leaf_id.device)
    hist = hist_pre(ohb, w, leaf_id, slots, max_group_bin=max_group_bin,
                    pack=pack, num_groups=_groups_of(ohb, max_group_bin,
                                                     pack, num_groups))
    return _dequant(hist, quant, scales)


# ---------------------------------------------------------------------------
# Kernels F and I: histogram of the row-major bin matrix, f32 or int8
# weights
# ---------------------------------------------------------------------------
def bins_hist_plain(bins: torch.Tensor, w: torch.Tensor,
                    leaf_id: torch.Tensor, slots: torch.Tensor,
                    max_group_bin: int,
                    packed_groups: int = 0) -> torch.Tensor:
    """Plain version of kernels F, G, I, J and K: the (W, G, B, 3)
    histogram of the rows whose leaf equals each slot; bins >= B match
    nothing.  ``bins`` is (N, G) and ``w`` (N, 3), any strides: f32
    weights give f32 sums of their bf16 roundings (accumulated in f64,
    rounded once), int32 quantized weights give exact int32 sums.  Under
    the pack spec ``packed_groups`` ``bins`` is the (N, cols) sub-byte
    storage, whose landed rows are widened."""
    N, cols = bins.shape
    G = groups_of_storage(cols, packed_groups)
    B = max_group_bin
    W = slots.shape[0]
    quant = w.dtype == torch.int32
    hist = torch.zeros((W * G * B, 3), device=bins.device,
                       dtype=torch.int64 if quant else torch.float64)
    s_idx, r_idx = _slot_rows(leaf_id, slots)
    if s_idx.numel():
        b = unpack_bins_cols(bins[r_idx], num_groups=G,
                             packed_groups=packed_groups).to(torch.int64)
        flat = (s_idx[:, None] * G
                + torch.arange(G, device=bins.device)[None, :]) * B + b
        ok = b < B
        wv = _acc_weights(w[r_idx])[:, None, :].expand(-1, G, -1)
        hist.index_add_(0, flat[ok], wv[ok])
    return _finish(hist.reshape(W, G, B, 3))


def _bins_hist(name: str, bins: torch.Tensor, w: torch.Tensor,
               leaf_id: torch.Tensor, slots: torch.Tensor,
               max_group_bin: int, dtype) -> torch.Tensor:
    """Kernel F or K (f32 ``w``, the geometry of :func:`bins_hist_plan`)
    or I (int32 ``w``, the geometry of :func:`frontier_hist_plan`) under
    the launch count ``name`` on CUDA tensors, the plain version on CPU
    tensors."""
    _check(bins, "bins", torch.uint8, 2)
    _check(w, "w", dtype, 2)
    _check(leaf_id, "leaf_id", torch.int32, 1)
    _check_slots(slots)
    N, G = bins.shape
    if w.shape != (N, 3) or leaf_id.shape != (N,):
        raise ValueError(f"w {tuple(w.shape)} / leaf_id "
                         f"{tuple(leaf_id.shape)} do not match N={N}")
    _check_bins(max_group_bin)
    dev = _same_device(bins, w, leaf_id, slots)
    if dev.type != "cuda":
        return bins_hist_plain(bins, w, leaf_id, slots, max_group_bin)
    W = slots.shape[0]
    if dtype == torch.int32:
        hist, part, plan = _i32_buffers(N, W, G, max_group_bin, dev,
                                        i32_aligned(bins, w, leaf_id))
        kernels.launch(name, bins.data_ptr(), w.data_ptr(),
                       leaf_id.data_ptr(), slots.data_ptr(),
                       hist.data_ptr(), N, G, max_group_bin, W, plan,
                       part.data_ptr())
        return hist
    acc = torch.zeros((W, G, max_group_bin, 3), device=dev,
                      dtype=torch.float64)
    words = int(G % 4 == 0 and bins.data_ptr() % 4 == 0)
    kernels.launch(name, bins.data_ptr(), w.data_ptr(), leaf_id.data_ptr(),
                   slots.data_ptr(), acc.data_ptr(), N, G, max_group_bin, W,
                   words, _plan_args("bins", N, W, G, max_group_bin, G,
                                     dev.index or 0))
    return acc.to(torch.float32)


def bins_hist(bins: torch.Tensor, w: torch.Tensor, leaf_id: torch.Tensor,
              slots: torch.Tensor, max_group_bin: int) -> torch.Tensor:
    """Kernel F on CUDA tensors, its plain version on CPU tensors.

    Kernel F (csrc/bins_hist.cu) replaces the Pallas kernel
    _hist_kernel_body (lightgbm_tpu/ops/histogram.py:224).  ``bins`` is
    the (N, G) uint8 row-major bin matrix, ``w`` the (N, 3) f32 weights;
    returns the (W, G, B, 3) f32 histogram following ``slots``."""
    return _bins_hist("bins_hist", bins, w, leaf_id, slots, max_group_bin,
                      torch.float32)


def bins_hist_paired_plain(bins: torch.Tensor, w: torch.Tensor,
                           leaf_id: torch.Tensor, slots: torch.Tensor,
                           max_group_bin: int) -> torch.Tensor:
    """Plain version of kernel K: kernel F's function (the paired TPU
    body computes the same histogram as _hist_kernel_body)."""
    return bins_hist_plain(bins, w, leaf_id, slots, max_group_bin)


def bins_hist_paired(bins: torch.Tensor, w: torch.Tensor,
                     leaf_id: torch.Tensor, slots: torch.Tensor,
                     max_group_bin: int) -> torch.Tensor:
    """Kernel K on CUDA tensors, its plain version on CPU tensors.

    Kernel K (csrc/bins_hist.cu, F's template behind its own entry
    point) replaces the Pallas kernel _hist_kernel_body_paired
    (lightgbm_tpu/ops/histogram.py:273), whose group pairing only fills
    the TPU's 128 lanes; same contract as :func:`bins_hist`."""
    return _bins_hist("bins_hist_paired", bins, w, leaf_id, slots,
                      max_group_bin, torch.float32)


def _byte_wide_only(packed_groups: int, name: str) -> None:
    if packed_groups:
        raise ValueError(f"{name} reads byte-wide row-major bins: its TPU "
                         "body has no sub-byte path, and the JAX grower "
                         "sends a packed dataset to the xla plan")


def bins_hist_q(bins: torch.Tensor, wq: torch.Tensor, leaf_id: torch.Tensor,
                slots: torch.Tensor, max_group_bin: int,
                packed_groups: int = 0) -> torch.Tensor:
    """Kernel I behind compute_group_histograms_pallas_q (replaces
    _hist_kernel_body_q, lightgbm_tpu/ops/histogram.py:381) on CUDA
    tensors, its plain version on CPU tensors.  ``wq`` is the (N, 3)
    int32 quantized weights; returns the (W, G, B, 3) int32 histogram
    following ``slots``.  Kernel I (csrc/bins_hist.cu) is kernel G's
    int32 shared-memory histogram (csrc/hist_i32.cuh) on the row-major
    bins and weights: the histogram launch and the sum of its copies.
    A pack spec is refused (no sub-byte path)."""
    _byte_wide_only(packed_groups, "kernel I")
    return _bins_hist("bins_hist_q", bins, wq, leaf_id, slots,
                      max_group_bin, torch.int32)


def bins_hist_q_packed(bins: torch.Tensor, wq: torch.Tensor,
                       leaf_id: torch.Tensor, slots: torch.Tensor,
                       max_group_bin: int,
                       packed_groups: int = 0) -> torch.Tensor:
    """Kernel I behind compute_group_histograms_q_packed (replaces
    _hist_kernel_body_q_packed, lightgbm_tpu/ops/histogram.py:897); same
    contract as :func:`bins_hist_q`."""
    _byte_wide_only(packed_groups, "kernel I")
    return _bins_hist("bins_hist_q_packed", bins, wq, leaf_id, slots,
                      max_group_bin, torch.int32)


def compute_group_histograms_pallas(
        bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
        counts: torch.Tensor, leaf_id: torch.Tensor, *, num_leaves: int,
        max_group_bin: int, slots=None) -> torch.Tensor:
    """f32-weight histogram from the (N, G) bins, every leaf (``slots``
    None) or the given slots: (W, G, B, 3) f32."""
    if slots is None:
        slots = torch.arange(num_leaves, dtype=torch.int32,
                             device=leaf_id.device)
    w = torch.stack([grad, hess, counts], dim=1).to(torch.float32)
    return bins_hist(bins, w, leaf_id, slots, max_group_bin)


def compute_group_histograms_pallas_paired(
        bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
        counts: torch.Tensor, leaf_id: torch.Tensor, *, num_leaves: int,
        max_group_bin: int, slots=None) -> torch.Tensor:
    """Paired-dot histogram (same contract as
    :func:`compute_group_histograms_pallas`), through kernel K."""
    if slots is None:
        slots = torch.arange(num_leaves, dtype=torch.int32,
                             device=leaf_id.device)
    w = torch.stack([grad, hess, counts], dim=1).to(torch.float32)
    return bins_hist_paired(bins, w, leaf_id, slots, max_group_bin)


def compute_group_histograms_pallas_q(
        bins: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor,
        leaf_id: torch.Tensor, *, num_leaves: int, max_group_bin: int,
        slots=None) -> torch.Tensor:
    """int8 histogram from the (N, G) bins and the (N, 3) int32
    quantized weights, every leaf (``slots`` None: rows
    0..num_leaves-1) or the given slots, any number of them:
    (W, G, B, 3) f32 dequantized by ``scales``."""
    if slots is None:
        slots = torch.arange(num_leaves, dtype=torch.int32,
                             device=leaf_id.device)
    hist = bins_hist_q(bins, wq, leaf_id, slots, max_group_bin)
    return hist.to(torch.float32) * scales


def compute_group_histograms_q_packed(
        bins: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor,
        leaf_id: torch.Tensor, slots: torch.Tensor, *,
        max_group_bin: int) -> torch.Tensor:
    """int8 histogram of at most 3 * PACKED_STRIP frontier slots from
    the (N, G) bins: (W, G, B, 3) f32 following ``slots`` (the JAX entry
    point pads to its strip ladder and truncates beyond it; here the
    output has exactly ``len(slots)`` rows and a longer list raises)."""
    if slots.shape[0] > 3 * PACKED_STRIP:
        raise ValueError(f"at most {3 * PACKED_STRIP} slots, got "
                         f"{slots.shape[0]}")
    hist = bins_hist_q_packed(bins, wq, leaf_id, slots, max_group_bin)
    return hist.to(torch.float32) * scales


# ---------------------------------------------------------------------------
# Kernel J: int8 histogram of leaf-partitioned rows
# ---------------------------------------------------------------------------
#: rows per partition block: the JAX grower's leaf_part_block
#: (lightgbm_tpu/learner/grower.py:502)
SEG_BLOCK = 512


def seg_hist_plain(binsT_p: torch.Tensor, wT_p: torch.Tensor,
                   blk_slot: torch.Tensor, num_out: int, max_group_bin: int,
                   block: int = SEG_BLOCK, *,
                   packed_groups: int = 0) -> torch.Tensor:
    """Plain version of kernel J: the (num_out, G, B, 3) int32 histogram
    of the partitioned rows, each row counted in its block's slot; a
    block whose slot is negative or >= num_out adds nothing.  Under
    ``packed_groups`` ``binsT_p`` is the partitioned (cols, n_cap)
    sub-byte storage."""
    row_slot = blk_slot.repeat_interleave(block)
    slots = torch.arange(num_out, dtype=torch.int32, device=blk_slot.device)
    return bins_hist_plain(binsT_p.t(), wT_p.t(), row_slot, slots,
                           max_group_bin, packed_groups)


#: csrc/seg_hist.cu: threads of a histogram CTA (kThreads)
SEG_THREADS = 512
#: histogram CTAs an SM (two of 512 threads fill an SM's 1024 threads at
#: 64 registers)
SEG_CTAS_PER_SM = 2
#: the most output slots of one launch: the plan's one CTA keeps an int
#: a slot (and one more) in shared memory
SEG_MAX_SLOTS = SMEM_PER_CTA // 4 - 1


class SegPlan(NamedTuple):
    """Launch geometry of kernel J (csrc/seg_hist.cu) for one shape.
    The live rows, listed slot by slot as items of ``rows_per_thread``
    rows (4 where the pointers and the block allow it), are split evenly
    over ``ctas`` CTAs by ``grid_y`` group chunks of ``groups_per_cta``
    groups; a CTA cuts its share at slot boundaries into runs, adds each
    run into its slot with device-memory atomics, and keeps up to
    ``slots_per_cta`` slots' histograms at once.  ``smem_bytes`` is a
    histogram CTA's shared memory (that many (gc, B, 3) int32
    histograms), ``plan_smem`` the plan's (an int a slot); the wrapper
    allocates ``meta_words`` int32 of plan."""
    ctas: int
    groups_per_cta: int
    grid_y: int
    threads: int
    rows_per_thread: int
    slots_per_cta: int
    smem_bytes: int
    plan_smem: int
    meta_words: int

    def as_args(self):
        """The int64 array the C entry point reads (Plan in
        csrc/seg_hist.cu, in this order)."""
        import ctypes
        vals = (self.ctas, self.groups_per_cta, self.grid_y, self.threads,
                self.rows_per_thread, self.slots_per_cta, self.smem_bytes,
                self.plan_smem)
        return (ctypes.c_int64 * len(vals))(*vals)


def seg_hist_plan(n_cap: int, G: int, B: int, num_out: int,
                  num_sms: int = H100_SMS, aligned: bool = True,
                  block: int = None) -> SegPlan:
    """Geometry of kernel J: SEG_CTAS_PER_SM CTAs an SM sharing the live
    rows evenly; all G groups of one slot in a CTA unless their
    histogram outgrows its shared memory (G * B * 12 bytes past
    232,448), then the fewest group chunks that fit, evened out; as
    many slots' histograms at once as SEG_CTAS_PER_SM CTAs fit in an
    SM's shared memory (5 at the bench's 28 groups of 63 bins)."""
    block = SEG_BLOCK if block is None else block
    nblk = n_cap // block
    G1 = max(G, 1)
    gy = -(-G1 * B * 12 // SMEM_PER_CTA)
    while -(-G1 // gy) * B * 12 > SMEM_PER_CTA:
        gy += 1
    gc = -(-G1 // gy)
    gy = -(-G1 // gc)
    V = 4 if aligned and n_cap % 4 == 0 and block % 4 == 0 else 1
    per_cta = SMEM_PER_SM // SEG_CTAS_PER_SM - SMEM_RESERVED_PER_CTA
    K = max(1, per_cta // (gc * B * 12))
    return SegPlan(SEG_CTAS_PER_SM * num_sms, gc, gy, SEG_THREADS, V, K,
                   K * gc * B * 12, _round_up(4 * (num_out + 1), 16),
                   2 * nblk + num_out + 1)


def seg_runs(blk_slot: torch.Tensor, num_out: int, ctas: int,
             per_blk: int):
    """Kernel J's plan in torch ops, as its first launch builds it on the
    device and its histogram CTAs walk it: returns (order, boff, runs).
    ``order`` lists the live blocks (0 <= slot < num_out) slot by slot,
    each slot's in block order; slot s holds positions boff[s] ..
    boff[s + 1] - 1 and items (``per_blk`` a block) boff[s] * per_blk ..
    boff[s + 1] * per_blk - 1.  ``runs`` is (R, 4) int64: the CTA, slot,
    first item and item past the last of each run, CTA c taking items c
    * items / ctas .. (c + 1) * items / ctas - 1; each run is one atomic
    flush.  The kernel's boff is this; the order of a slot's blocks in
    its list may differ from launch to launch."""
    dev = blk_slot.device
    live = (blk_slot >= 0) & (blk_slot < num_out)
    key = torch.where(live, blk_slot, num_out).long()
    order = torch.sort(key, stable=True).indices[:int(live.sum())]
    cnt = torch.bincount(key, minlength=num_out + 1)[:num_out]
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    boff = torch.cat([zero, torch.cumsum(cnt, 0)])
    items = int(boff[-1]) * per_blk
    c_lo = torch.arange(ctas + 1, device=dev) * items // ctas
    # the runs: the items between consecutive CTA and slot boundaries
    cuts = torch.unique(torch.cat([c_lo, boff * per_blk]))
    lo, hi = cuts[:-1], cuts[1:]
    slot = torch.searchsorted(boff * per_blk, lo, right=True) - 1
    cta = torch.searchsorted(c_lo, lo, right=True) - 1
    return (order.to(torch.int32), boff.to(torch.int32),
            torch.stack([cta, slot, lo, hi], 1))


@functools.lru_cache(maxsize=256)
def _seg_plan(n_cap: int, G: int, B: int, num_out: int, aligned: bool,
              block: int, index: int):
    """(plan, its C array) of one kernel J launch shape on card
    ``index``."""
    plan = seg_hist_plan(n_cap, G, B, num_out, _num_sms(index), aligned,
                         block)
    return plan, plan.as_args()


def _seg_hist_cuda(binsT_p, wT_p, blk_slot, num_out, max_group_bin, block,
                   packed_groups):
    """Kernel J's zero fill and two launches."""
    cols, n_cap = binsT_p.shape
    G = groups_of_storage(cols, packed_groups)
    dev = binsT_p.device
    plan, args = _seg_plan(n_cap, G, max_group_bin, num_out,
                           i32_aligned(binsT_p, wT_p), block,
                           dev.index or 0)
    hist = torch.empty((num_out, G, max_group_bin, 3), dtype=torch.int32,
                       device=dev)
    meta = torch.empty((plan.meta_words,), dtype=torch.int32, device=dev)
    kernels.launch("seg_hist", binsT_p.data_ptr(), wT_p.data_ptr(),
                   blk_slot.data_ptr(), hist.data_ptr(), n_cap, G,
                   max_group_bin, num_out, block, args, meta.data_ptr(),
                   packed_groups)
    return hist


def seg_hist(binsT_p: torch.Tensor, wT_p: torch.Tensor,
             blk_slot: torch.Tensor, num_out: int, max_group_bin: int,
             block: int = SEG_BLOCK, *,
             packed_groups: int = 0) -> torch.Tensor:
    """Kernel J on CUDA tensors, its plain version on CPU tensors: the
    (num_out, G, B, 3) int32 histogram of leaf-partitioned rows.

    Kernel J (csrc/seg_hist.cu) replaces the Pallas kernel
    _hist_kernel_body_seg_tiled (lightgbm_tpu/ops/histogram.py:1520):
    a plan built on the device from ``blk_slot`` (one CTA), then CTAs
    that share the live rows evenly and add a shared-memory int32
    histogram a slot they meet into the zeroed output with device-memory
    atomics (the geometry of :func:`seg_hist_plan`, the runs of
    :func:`seg_runs`).
    ``binsT_p`` is the (G, n_cap) uint8 and ``wT_p`` the (3, n_cap)
    int32 operands in partitioned order (ops/partition.py
    apply_partition; gap rows carry zero weight), ``blk_slot`` the
    (n_cap / block,) int32 output slot of each row block (-1: skip), in
    any arrangement over the blocks.  Under the pack spec
    ``packed_groups`` ``binsT_p`` is the partitioned (cols, n_cap)
    sub-byte storage, widened in registers."""
    _check(binsT_p, "binsT_p", torch.uint8, 2)
    _check(wT_p, "wT_p", torch.int32, 2)
    _check(blk_slot, "blk_slot", torch.int32, 1)
    _check_bins(max_group_bin)
    cols, n_cap = binsT_p.shape
    G = groups_of_storage(cols, packed_groups)
    if wT_p.shape != (3, n_cap):
        raise ValueError(f"wT_p {tuple(wT_p.shape)} does not match "
                         f"n_cap={n_cap}")
    if n_cap % block or blk_slot.shape != (n_cap // block,):
        raise ValueError(f"n_cap ({n_cap}) must be a multiple of block "
                         f"({block}) with one blk_slot entry per block")
    dev = _same_device(binsT_p, wT_p, blk_slot)
    if dev.type != "cuda":
        return seg_hist_plain(binsT_p, wT_p, blk_slot, num_out,
                              max_group_bin, block,
                              packed_groups=packed_groups)
    if not 0 <= num_out <= SEG_MAX_SLOTS:
        raise ValueError(f"num_out {num_out} not in [0, {SEG_MAX_SLOTS}] "
                         "(kernel J's limit)")
    if num_out == 0 or G == 0:
        return torch.zeros((num_out, G, max_group_bin, 3),
                           dtype=torch.int32, device=dev)
    return _seg_hist_cuda(binsT_p, wT_p, blk_slot, num_out, max_group_bin,
                          block, packed_groups)


def compute_group_histograms_seg_tiled(
        binsT_p: torch.Tensor, wT_p: torch.Tensor, scales: torch.Tensor,
        blk_slot: torch.Tensor, *, num_out: int, max_group_bin: int,
        block: int = SEG_BLOCK, packed_groups: int = 0) -> torch.Tensor:
    """Leaf-partitioned int8 histogram, dequantized: (num_out, G, B, 3)
    f32 (the contract of compute_group_histograms_q_tiled with the block
    map in place of the slot list), on the byte-wide bins or, under the
    pack spec ``packed_groups``, their sub-byte storage."""
    hist = seg_hist(binsT_p, wT_p, blk_slot, num_out, max_group_bin, block,
                    packed_groups=packed_groups)
    return hist.to(torch.float32) * scales


# ---------------------------------------------------------------------------
# The XLA form: one-hot contraction in torch ops (no kernel)
# ---------------------------------------------------------------------------
def _pick_chunk(n: int, num_groups: int, max_group_bin: int,
                itemsize: int, target_bytes: int = 1 << 26,
                min_chunk: int = 4096) -> int:
    """Row chunk bounding the materialized one-hot to ~64 MB
    (lightgbm_tpu/ops/histogram.py _pick_chunk); the grower passes
    ``min_chunk=1024``, the JAX grower's rule off the TPU, so both
    packages pad to the same row count."""
    per_row = max(num_groups * max_group_bin * itemsize, 1)
    chunk = max(min_chunk, min(n, target_bytes // per_row))
    return int(max(min_chunk, (chunk // min_chunk) * min_chunk))


def compute_group_histograms(bins: torch.Tensor, grad: torch.Tensor,
                             hess: torch.Tensor, counts: torch.Tensor,
                             leaf_id: torch.Tensor, *, num_leaves: int,
                             max_group_bin: int,
                             compute_dtype: str = "float32",
                             chunk=None, slots=None,
                             packed_groups: int = 0) -> torch.Tensor:
    """The XLA histogram formulation of lightgbm_tpu/ops/histogram.py
    compute_group_histograms (:131), in torch ops on the bins' device:
    per row chunk, the (C, 3W) leaf one-hot times the weights and the
    (C, G*B) bin one-hot, contracted as ONE (3W x C) @ (C x G*B) f32
    product, the chunks summed in f32.  Every leaf (``slots`` None) or
    the given slots (negative entries match nothing).

    The JAX package leaves this product to XLA outside any kernel, so it
    is a torch.matmul here.  It must run in full f32: the function
    raises when torch.get_float32_matmul_precision() is not "highest"
    (TF32 would cost ~1e-3 relative).  With ``compute_dtype="bfloat16"``
    the weights are rounded to bf16 and multiplied in f32 — the same
    products as the JAX bf16 x bf16 -> f32 dot (a bf16 matmul here would
    return a bf16 sum).

    bins (N, G) uint8 (N a multiple of ``chunk``; under the pack spec
    ``packed_groups`` the (N, cols) sub-byte storage, each row chunk
    widened as it is read, as the JAX function does), grad/hess/counts
    (N,) f32, leaf_id (N,) int32 (negative = ignore) ->
    (L|W, G, B, 3) f32."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "compute_group_histograms needs full-f32 matmuls: "
            "torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r}, not 'highest'")
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype!r}")
    _check(bins, "bins", torch.uint8, 2)
    n, cols = bins.shape
    G = groups_of_storage(cols, packed_groups)
    B = max_group_bin
    dev = bins.device
    if chunk is None:
        chunk = _pick_chunk(n, G, B, 4 if compute_dtype == "float32" else 2)
    if n % chunk:
        raise ValueError(f"N ({n}) must be padded to a multiple of chunk "
                         f"({chunk})")
    if slots is None:
        leaf_iota = torch.arange(num_leaves, dtype=torch.int32, device=dev)
    else:
        # negative slots must match nothing, padded rows' -1 included
        leaf_iota = torch.where(slots >= 0, slots, -2).to(torch.int32)
    W = leaf_iota.shape[0]
    w = torch.stack([grad, hess, counts], dim=1).to(torch.float32)
    if compute_dtype == "bfloat16":
        w = bf16_round(w)
    bin_iota = torch.arange(B, dtype=torch.int32, device=dev)
    acc = torch.zeros((3 * W, G * B), dtype=torch.float32, device=dev)
    for c0 in range(0, n, chunk):
        leaf_c = leaf_id[c0:c0 + chunk]
        # (W, C) leaf one-hot times each weight channel: rows l*3 + ch
        ohl = (leaf_iota[:, None] == leaf_c[None, :]).to(torch.float32)
        lhs = (ohl[:, None, :] * w[c0:c0 + chunk].t()[None, :, :]
               ).reshape(3 * W, -1)
        bc = unpack_bins_cols(bins[c0:c0 + chunk], num_groups=G,
                              packed_groups=packed_groups)
        rhs = (bc.to(torch.int32)[:, :, None]
               == bin_iota).reshape(-1, G * B).to(torch.float32)
        acc += lhs @ rhs
    return acc.reshape(W, 3, G, B).permute(0, 2, 3, 1).contiguous()


def leaf_value_broadcast(leaf_id: torch.Tensor,
                         values: torch.Tensor) -> torch.Tensor:
    """Per-row ``values[leaf_id]`` as the JAX package computes it
    (histogram.py:1792-1815): the sum hi + mid + lo of the value's three
    bf16-exact parts, in that order, and 0.0 for rows whose leaf is
    negative (or past the table).  A gather here where the TPU needs a
    one-hot product; the result is bit-identical."""
    from .partition import _split3_bf16
    L = values.shape[0]
    hi, mid, lo = (p[:, 0] for p in _split3_bf16(values))
    ok = (leaf_id >= 0) & (leaf_id < L)
    idx = leaf_id.clamp(0, L - 1).long()
    v = (hi[idx] + mid[idx]) + lo[idx]
    return torch.where(ok, v, torch.zeros((), device=v.device))


# ---------------------------------------------------------------------------
# Per-feature view and leaf totals (plain torch on every device)
# ---------------------------------------------------------------------------
def expand_feature_histograms(group_hist: torch.Tensor,
                              bin_map: torch.Tensor, fix_bin: torch.Tensor,
                              leaf_totals: torch.Tensor) -> torch.Tensor:
    """Per-feature view of group histograms: ``bin_map[f, b]`` is the
    flattened (group, group_bin) index holding feature f's bin b (or
    -1); bins flagged by ``fix_bin[f]`` are reconstructed from leaf
    totals (the FixHistogram path of EFB bundles).

    group_hist (L, G, B_g, 3), bin_map (F, B_f) int32, fix_bin (F,)
    int32, leaf_totals (L, 3) -> (L, F, B_f, 3) f32."""
    L = group_hist.shape[0]
    flat = group_hist.reshape(L, -1, 3)
    valid = bin_map >= 0
    safe = torch.where(valid, bin_map, torch.zeros_like(bin_map)).long()
    feat = flat[:, safe, :] * valid[None, :, :, None]
    needs_fix = fix_bin >= 0
    missing = leaf_totals[:, None, :] - feat.sum(dim=2)          # (L, F, 3)
    onehot_fix = ((torch.arange(feat.shape[2], dtype=torch.int32,
                                device=feat.device)[None, :]
                   == fix_bin[:, None]) & needs_fix[:, None])
    return feat + onehot_fix[None, :, :, None] * missing[:, :, None, :]


#: below this many rows XLA's CPU backend emits the root totals'
#: contraction as an 8-lane loop with 4 accumulators; from it on, as a
#: row-by-row loop (held against the JAX package in
#: tests/test_torch_objectives_train.py)
XLA_CPU_VECTOR_DOT_ROWS = 4096


def _xla_cpu_column_sums(w: np.ndarray) -> np.ndarray:
    """(N, C) f32 -> (C,) column sums in the order of XLA's CPU dot:
    below XLA_CPU_VECTOR_DOT_ROWS rows, 4 accumulators of 8 lanes each
    take 32 rows a step, then are added one after another and the 8
    lanes halved pairwise; at or above it, the rows one after
    another."""
    n = w.shape[0]
    if n >= XLA_CPU_VECTOR_DOT_ROWS or n % 32:
        return np.cumsum(w, axis=0, dtype=np.float32)[-1].copy()
    acc = np.zeros((4, 8) + w.shape[1:], np.float32)
    for blk in w.reshape((-1, 4, 8) + w.shape[1:]):
        acc = acc + blk
    lanes = ((acc[0] + acc[1]) + acc[2]) + acc[3]
    while lanes.shape[0] > 1:
        half = lanes.shape[0] // 2
        lanes = lanes[:half] + lanes[half:]
    return lanes[0]


def compute_root_totals(grad: torch.Tensor, hess: torch.Tensor,
                        counts: torch.Tensor,
                        row_valid: torch.Tensor) -> torch.Tensor:
    """(3,) root (sum_grad, sum_hess, count) over the rows flagged by
    ``row_valid`` — the one-leaf case of the JAX package's
    compute_leaf_totals.

    f32 sums depend on order.  On the CPU the rows are added in the
    order the JAX package's XLA CPU program uses for this contraction
    (_xla_cpu_column_sums), so CPU runs reproduce its root sums bit for
    bit; on the card torch's reduction order is used."""
    w = torch.stack([grad, hess, counts], dim=1)                 # (N, 3)
    w = torch.where(row_valid[:, None], w, torch.zeros((), device=w.device))
    if w.device.type == "cpu":
        return torch.from_numpy(_xla_cpu_column_sums(w.numpy()))
    return w.sum(dim=0)
