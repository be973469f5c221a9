"""Histogram construction: quantized gradients, the fused route +
frontier histogram, the exit route, the f32-weight histograms of the
streamed bin one-hot and of the bin matrix, and the per-feature view.

Port of lightgbm_tpu/ops/histogram.py for the serial learner's plans.
Every device kernel of a training round is hand-written CUDA:

  A  csrc/fused_route_hist.cu  compute_group_histograms_fused_tiled
  B  csrc/route_apply.cu       route_apply_tiled
  D  csrc/onehot_hist.cu       compute_group_histograms_fused
  E  csrc/onehot_hist.cu       compute_group_histograms_pre_packed,
                               compute_group_histograms_pre
  F  csrc/bins_hist.cu         compute_group_histograms_pallas

Each has a plain PyTorch version here with the same contract.  A
wrapper launches the kernel for CUDA tensors and takes the plain
version only for tensors on the CPU (the tests' device); there is no
fallback between the two.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .partition import (ROUTE_FIXED_COLS, apply_route_table,
                        extend_table_with_values)

#: int32 histogram-accumulator headroom: quantized weights are int8
#: (|q| <= 127), so a bin that swallowed every row accumulates at most
#: N * 127.
QUANT_WEIGHT_MAX = 127
#: the most rows whose quantized histograms can never overflow the int32
#: accumulator (rows * 127 < 2^31, ~16.9M rows)
QUANT_ROW_LIMIT = (2 ** 31 - 1) // QUANT_WEIGHT_MAX


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       counts: torch.Tensor):
    """Per-channel symmetric int8 quantization (one scale per tree),
    rounding half to even.  Returns ((N, 3) int32 quantized weights,
    (3,) f32 scales).  Binary training needs no stochastic rounding
    (lightgbm_tpu/boosting/gbdt.py _quant_stochastic)."""
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=grad.device)
    s_g = torch.maximum(grad.abs().max() / 127.0, tiny)
    s_h = torch.maximum(hess.abs().max() / 127.0, tiny)
    qg = torch.round(grad / s_g)
    qh = torch.round(hess / s_h)
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
                           slots: torch.Tensor, max_group_bin: int):
    """Plain version of kernel A: returns the (W, G, B, 3) int32
    histogram of the rows whose POST-route leaf equals each slot
    (negative slots stay empty) and the (N,) post-route leaf ids."""
    G, N = binsT.shape
    B = max_group_bin
    W = slots.shape[0]
    dev = binsT.device
    new_leaf = apply_route_table(binsT.t(), leaf_id, route_tab)
    match = (new_leaf[None, :] == slots[:, None]) & (slots[:, None] >= 0)
    s_idx, r_idx = match.nonzero(as_tuple=True)
    hist = torch.zeros(W * G * B, 3, dtype=torch.int64, device=dev)
    if s_idx.numel():
        bins_r = binsT[:, r_idx].to(torch.int64)             # (G, P)
        g_iota = torch.arange(G, device=dev)[:, None]
        flat = (s_idx[None, :] * G + g_iota) * B + bins_r   # (G, P)
        ok = bins_r < B
        w = wT[:, r_idx].t().to(torch.int64)                 # (P, 3)
        w = w[None].expand(G, -1, -1)
        hist.index_add_(0, flat[ok], w[ok])
    return hist.reshape(W, G, B, 3).to(torch.int32), new_leaf


def _fused_route_hist_cuda(binsT, wT, leaf_id, route_tab, slots,
                           max_group_bin):
    G, N = binsT.shape
    L, K = route_tab.shape
    W = slots.shape[0]
    hist = torch.zeros((W, G, max_group_bin, 3), dtype=torch.int32,
                       device=binsT.device)
    leaf_out = torch.empty_like(leaf_id)
    kernels.launch("fused_route_hist", binsT.data_ptr(), wT.data_ptr(),
                   leaf_id.data_ptr(), route_tab.data_ptr(),
                   slots.data_ptr(), hist.data_ptr(), leaf_out.data_ptr(),
                   N, G, max_group_bin, L, K, W)
    return hist, leaf_out


def fused_route_hist(binsT: torch.Tensor, wT: torch.Tensor,
                     leaf_id: torch.Tensor, route_tab: torch.Tensor,
                     slots: torch.Tensor, max_group_bin: int):
    """Kernel A on CUDA tensors, its plain version on CPU tensors:
    ``(int32 hist (W, G, B, 3), new leaf ids (N,))``.

    Kernel A (csrc/fused_route_hist.cu) replaces the Pallas kernel
    _fused_kernel_body_q_tiled (lightgbm_tpu/ops/histogram.py:1412).
    On the card it is bound by its histogram atomics, not by its ~48 B
    per row of traffic; one thread per row routes, then adds into every
    matching slot with int32 atomics (see the source note there).

    Args:
      binsT: (G, N) uint8 transposed group bins.
      wT: (3, N) int32 quantized weights in [-127, 127].
      leaf_id: (N,) int32 pre-route leaf ids (negative = padded row).
      route_tab: (L, 15 + nb) f32 pending route table (all-zero routes
        nothing).
      slots: (W,) int32 frontier slots; the histogram rows follow this
        order and a negative slot's row stays zero.
    """
    _check(binsT, "binsT", torch.uint8, 2)
    _check(wT, "wT", torch.int32, 2)
    _check(leaf_id, "leaf_id", torch.int32, 1)
    _check(route_tab, "route_tab", torch.float32, 2)
    _check(slots, "slots", torch.int32, 1)
    G, N = binsT.shape
    if wT.shape != (3, N) or leaf_id.shape != (N,):
        raise ValueError(f"wT {tuple(wT.shape)} / leaf_id "
                         f"{tuple(leaf_id.shape)} do not match N={N}")
    if route_tab.shape[1] < ROUTE_FIXED_COLS:
        raise ValueError("route_tab needs at least 15 columns")
    if not 1 <= max_group_bin <= 256:
        raise ValueError(f"max_group_bin {max_group_bin} not in [1, 256]")
    dev = _same_device(binsT, wT, leaf_id, route_tab, slots)
    if dev.type == "cuda":
        return _fused_route_hist_cuda(binsT, wT, leaf_id, route_tab, slots,
                                      max_group_bin)
    return fused_route_hist_plain(binsT, wT, leaf_id, route_tab, slots,
                                  max_group_bin)


def compute_group_histograms_fused_tiled(
        binsT: torch.Tensor, wT: torch.Tensor, scales: torch.Tensor,
        leaf_id: torch.Tensor, route_tab: torch.Tensor,
        slots: torch.Tensor, *, max_group_bin: int):
    """Fused route + int8 frontier histogram, dequantized: returns
    ``(hist (W, G, B, 3) f32, new_leaf (N,))`` with the histogram rows
    following ``slots`` (the JAX entry point pads the slot list to its
    lane ladder; here the output has exactly ``len(slots)`` rows)."""
    hist, new_leaf = fused_route_hist(binsT, wT, leaf_id, route_tab, slots,
                                      max_group_bin)
    return hist.to(torch.float32) * scales, new_leaf


# ---------------------------------------------------------------------------
# Kernel B: exit route + per-row leaf value
# ---------------------------------------------------------------------------
def route_apply_plain(binsT: torch.Tensor, leaf_id: torch.Tensor,
                      route_tab: torch.Tensor, values: torch.Tensor):
    """Plain version of kernel B: ``(new_leaf, row_value)``."""
    return apply_route_table(binsT.t(), leaf_id, route_tab, values=values)


def route_apply_tiled(binsT: torch.Tensor, leaf_id: torch.Tensor,
                      route_tab: torch.Tensor, values: torch.Tensor):
    """Exit route: apply the final pending route table and return each
    row's post-route leaf id and leaf value (bf16-split reassembly, 0.0
    on rows with a negative leaf).  Kernel B on CUDA tensors, the plain
    version on CPU tensors.

    Kernel B (csrc/route_apply.cu) replaces the Pallas kernel
    _route_value_kernel_body (lightgbm_tpu/ops/histogram.py:1632): one
    thread per row, memory-bound at ~13 B per row; the six value
    columns are built here before the launch (see the source note)."""
    _check(binsT, "binsT", torch.uint8, 2)
    _check(leaf_id, "leaf_id", torch.int32, 1)
    _check(route_tab, "route_tab", torch.float32, 2)
    _check(values, "values", torch.float32, 1)
    G, N = binsT.shape
    L, K = route_tab.shape
    if leaf_id.shape != (N,) or values.shape != (L,) \
            or K < ROUTE_FIXED_COLS:
        raise ValueError("route_apply_tiled: shape mismatch")
    if G >= 65536:
        raise ValueError("at most 65535 feature groups (the route table "
                         "encodes the group index as two bytes)")
    dev = _same_device(binsT, leaf_id, route_tab, values)
    if dev.type != "cuda":
        return route_apply_plain(binsT, leaf_id, route_tab, values)
    table = extend_table_with_values(route_tab, values).contiguous()
    leaf_out = torch.empty_like(leaf_id)
    val_out = torch.empty((N,), dtype=torch.float32, device=dev)
    kernels.launch("route_apply", binsT.data_ptr(), leaf_id.data_ptr(),
                   table.data_ptr(), leaf_out.data_ptr(), val_out.data_ptr(),
                   N, G, L, K)
    return leaf_out, val_out


# ---------------------------------------------------------------------------
# f32-weight histograms: weight rounding and the streamed bin one-hot
# ---------------------------------------------------------------------------
#: the JAX kernels' lane strip: 3 channels x 42 slots fill a 128-lane tile
PACKED_STRIP = 42
#: frontier slots a histogram kernel keeps in shared memory (48 KB)
MAX_KERNEL_SLOTS = 12288


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


def precompute_bin_onehot(bins: torch.Tensor, *,
                          max_group_bin: int) -> torch.Tensor:
    """(N, G) uint8 -> (N, G*B) int8 bin one-hot on the bins' device,
    byte-identical to lightgbm_tpu precompute_bin_onehot
    (histogram.py:571).  Built in row chunks so no (N, G, B) bool is
    ever whole (1.76 GB of output at 1M x 28 x 63)."""
    n, g = bins.shape
    B = max_group_bin
    out = torch.empty((n, g * B), dtype=torch.int8, device=bins.device)
    biota = torch.arange(B, dtype=torch.int32, device=bins.device)
    step = _onehot_chunk_rows(g * B)
    for i in range(0, n, step):
        bc = bins[i:i + step].to(torch.int32)
        out[i:i + step] = (bc[:, :, None] == biota).reshape(
            bc.shape[0], g * B).to(torch.int8)
    return out


def precompute_bin_onehot_packed(bins: torch.Tensor, *, max_group_bin: int,
                                 pack: int) -> torch.Tensor:
    """(N, G) uint8 -> (N, round_up(G*B/pack, 128)) int8 PLANAR sub-byte
    one-hot, byte-identical to lightgbm_tpu
    precompute_bin_onehot_packed (histogram.py:615-681): byte j of a
    row carries full column ``p*GBp + j`` (GBp = G*B/pack) in bit field
    p of width 8/pack, each field 0 or 1; bytes j >= GBp are zero."""
    n, g = bins.shape
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
        bc = bins[i:i + step].to(torch.int32)
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
                   pack, num_groups, binsT=None, route_tab=None):
    """Launch kernel D (``route_tab`` given) or E on CUDA tensors.
    ``w`` is (N, 3) with any strides.  Returns (hist, new leaf ids or
    None)."""
    G, B = num_groups, max_group_bin
    N = leaf_id.shape[0]
    W = slots.shape[0]
    quant = w.dtype == torch.int32
    acc = torch.zeros((W, G, B, 3), device=ohb.device,
                      dtype=torch.int32 if quant else torch.float64)
    route = route_tab is not None
    L, K = route_tab.shape if route else (0, 0)
    leaf_out = torch.empty_like(leaf_id) if route else None
    kernels.launch(name, ohb.data_ptr(), ohb.shape[1], _onehot_vec(ohb),
                   binsT.data_ptr() if route else None, w.data_ptr(),
                   w.stride(0), w.stride(1), int(quant), leaf_id.data_ptr(),
                   route_tab.data_ptr() if route else None, slots.data_ptr(),
                   acc.data_ptr(), leaf_out.data_ptr() if route else None,
                   N, G, B, L, K, W, pack, G * B // pack, int(route))
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
                            max_group_bin: int, pack: int, num_groups: int):
    """Plain version of kernel D: route every row by the pending table,
    then histogram the rows whose NEW leaf equals each slot.  Returns
    ``(hist (W, G, B, 3), new_leaf (N,))``; see onehot_hist_plain for
    the histogram's type."""
    new_leaf = apply_route_table(binsT.t(), leaf_id, route_tab)
    hist = onehot_hist_plain(ohb, wT.t(), new_leaf, slots,
                             max_group_bin=max_group_bin, pack=pack,
                             num_groups=num_groups)
    return hist, new_leaf


def fused_onehot_hist(ohb, binsT, wT, leaf_id, route_tab, slots, *,
                      max_group_bin: int, pack: int, num_groups: int):
    """Kernel D on CUDA tensors, its plain version on CPU tensors:
    ``(hist (W, G, B, 3), new_leaf (N,))`` — f32 sums of bf16-rounded
    f32 weights, or exact int32 sums of int32 quantized weights.

    Kernel D (csrc/onehot_hist.cu) replaces the Pallas kernel
    _fused_kernel_body (lightgbm_tpu/ops/histogram.py:1272).

    Args:
      ohb: (N, width) int8 one-hot from precompute_bin_onehot (pack 1)
        or precompute_bin_onehot_packed (pack 2, 4).
      binsT: (G, N) uint8 transposed group bins (the routing reads one).
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
    if binsT.shape != (G, N) or leaf_id.shape != (N,):
        raise ValueError(f"binsT {tuple(binsT.shape)} / leaf_id "
                         f"{tuple(leaf_id.shape)} do not match ({G}, {N})")
    if wT.dim() != 2 or not wT.is_contiguous():
        raise ValueError("wT must be a contiguous (3, N) tensor")
    _check_weights(wT.t(), N, "wT.t()")
    if route_tab.shape[1] < ROUTE_FIXED_COLS:
        raise ValueError("route_tab needs at least 15 columns")
    dev = _same_device(ohb, binsT, wT, leaf_id, route_tab, slots)
    if dev.type == "cuda":
        return _onehot_launch("fused_onehot_hist", ohb, wT.t(), leaf_id,
                              slots, max_group_bin=B, pack=pack,
                              num_groups=G, binsT=binsT, route_tab=route_tab)
    return fused_onehot_hist_plain(ohb, binsT, wT, leaf_id, route_tab, slots,
                                   max_group_bin=B, pack=pack, num_groups=G)


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
        pack: int = 1, num_groups=None):
    """Fused route + frontier histogram of the streamed one-hot: returns
    ``(hist (W, G, B, 3) f32, new_leaf (N,))`` with the histogram rows
    following ``slots`` (the JAX entry point pads them to its strip
    ladder; here the output has exactly ``len(slots)`` rows).  With
    ``quant`` the int32 sums are dequantized by ``scales``."""
    _check_quant(wT, quant)
    hist, new_leaf = fused_onehot_hist(
        ohb, binsT, wT, leaf_id, route_tab, slots,
        max_group_bin=max_group_bin, pack=pack,
        num_groups=_groups_of(ohb, max_group_bin, pack, num_groups))
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
# Kernel F: histogram of the row-major bin matrix, f32 weights
# ---------------------------------------------------------------------------
def bins_hist_plain(bins: torch.Tensor, w: torch.Tensor,
                    leaf_id: torch.Tensor, slots: torch.Tensor,
                    max_group_bin: int) -> torch.Tensor:
    """Plain version of kernel F: the (W, G, B, 3) f32 histogram (sums
    of bf16-rounded weights) of the rows whose leaf equals each slot;
    bins >= B match nothing."""
    N, G = bins.shape
    B = max_group_bin
    W = slots.shape[0]
    hist = torch.zeros((W * G * B, 3), dtype=torch.float64,
                       device=bins.device)
    s_idx, r_idx = _slot_rows(leaf_id, slots)
    if s_idx.numel():
        b = bins[r_idx].to(torch.int64)                       # (P, G)
        flat = (s_idx[:, None] * G
                + torch.arange(G, device=bins.device)[None, :]) * B + b
        ok = b < B
        wv = _acc_weights(w[r_idx])[:, None, :].expand(-1, G, -1)
        hist.index_add_(0, flat[ok], wv[ok])
    return _finish(hist.reshape(W, G, B, 3))


def bins_hist(bins: torch.Tensor, w: torch.Tensor, leaf_id: torch.Tensor,
              slots: torch.Tensor, max_group_bin: int) -> torch.Tensor:
    """Kernel F on CUDA tensors, its plain version on CPU tensors.

    Kernel F (csrc/bins_hist.cu) replaces the Pallas kernel
    _hist_kernel_body (lightgbm_tpu/ops/histogram.py:224).  ``bins`` is
    the (N, G) uint8 row-major bin matrix, ``w`` the (N, 3) f32 weights;
    returns the (W, G, B, 3) f32 histogram following ``slots``."""
    _check(bins, "bins", torch.uint8, 2)
    _check(w, "w", torch.float32, 2)
    _check(leaf_id, "leaf_id", torch.int32, 1)
    _check_slots(slots)
    N, G = bins.shape
    if w.shape != (N, 3) or leaf_id.shape != (N,):
        raise ValueError(f"w {tuple(w.shape)} / leaf_id "
                         f"{tuple(leaf_id.shape)} do not match N={N}")
    if not 1 <= max_group_bin <= 256:
        raise ValueError(f"max_group_bin {max_group_bin} not in [1, 256]")
    dev = _same_device(bins, w, leaf_id, slots)
    if dev.type != "cuda":
        return bins_hist_plain(bins, w, leaf_id, slots, max_group_bin)
    W = slots.shape[0]
    acc = torch.zeros((W, G, max_group_bin, 3), dtype=torch.float64,
                      device=dev)
    kernels.launch("bins_hist", bins.data_ptr(), w.data_ptr(),
                   leaf_id.data_ptr(), slots.data_ptr(), acc.data_ptr(), N,
                   G, max_group_bin, W)
    return acc.to(torch.float32)


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


def compute_root_totals(grad: torch.Tensor, hess: torch.Tensor,
                        counts: torch.Tensor,
                        row_valid: torch.Tensor) -> torch.Tensor:
    """(3,) root (sum_grad, sum_hess, count) over the rows flagged by
    ``row_valid`` — the one-leaf case of the JAX package's
    compute_leaf_totals.

    f32 sums depend on order.  On the CPU the rows are added one after
    another in f32 — the order the JAX package's XLA CPU program uses
    for this contraction at the test sizes — so CPU runs reproduce its
    root sums bit for bit; on the card torch's reduction order is
    used."""
    w = torch.stack([grad, hess, counts], dim=1)                 # (N, 3)
    w = torch.where(row_valid[:, None], w, torch.zeros((), device=w.device))
    if w.device.type == "cpu":
        return torch.from_numpy(np.cumsum(w.numpy(), axis=0,
                                          dtype=np.float32)[-1].copy())
    return w.sum(dim=0)
