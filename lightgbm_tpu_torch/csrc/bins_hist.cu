// Frontier histograms from the row-major bin matrix: f32 weights
// (kernels F and K) and int8-quantized weights (kernel I).  Three entry
// points, two kernels.
//
// Kernel F replaces the Pallas kernel _hist_kernel_body
// (lightgbm_tpu/ops/histogram.py:224, entry compute_group_histograms_pallas
// :544): the plan the grower takes when the streamed one-hot does not fit
// its memory budget.
//
// Kernel K replaces the Pallas kernel _hist_kernel_body_paired
// (lightgbm_tpu/ops/histogram.py:273, entry
// compute_group_histograms_pallas_paired :363), F's function with the
// per-group one-hots dotted in group pairs so that each dot fills the
// MXU's 128 lanes (B = 64 pairs to 128).  That pairing is a TPU lane
// layout and means nothing here: K is F's kernel behind its own C entry
// point, counted under its own name (ops/kernels.py).
//
// Kernel I replaces two Pallas kernels that compute the same function on
// a GPU: _hist_kernel_body_q (lightgbm_tpu/ops/histogram.py:381, entry
// compute_group_histograms_pallas_q :494), which keeps each weight
// channel in its own lanes and covers every leaf or a slot list, and
// _hist_kernel_body_q_packed (:897, entry compute_group_histograms_q_packed
// :943), which packs the three channels of up to 42 slots into one
// 128-lane tile.  The packing is a TPU lane layout; here both entry
// points launch this kernel, each counted under its own name
// (ops/kernels.py).  The TPU bodies rebuild the bin one-hot with an int8
// expansion product when B <= 127 and a bf16 one when B > 127 (bin
// indices above 127 wrap in int8); both give the exact bin, which is
// what these kernels read directly.
//
// All three TPU bodies rebuild the bin one-hot in VMEM (an expansion
// matrix product and a compare) and dot it with the slot-masked weights;
// here a row's G bin bytes are read directly and the row's weights added
// at (slot, group, bin).  A bin >= B matches nothing, as the TPU's
// per-column compare does; a negative slot matches nothing (leaf ids of
// live rows are >= 0); a row adds to every equal slot, as the TPU's slot
// one-hot does.
//
// F and K round their weights to bf16 (round-to-nearest-even, the TPU
// kernel's cast before its dot) and accumulate in f64; the wrapper rounds
// the sums once to f32 (see onehot_hist.cu for why that makes the result
// independent of the order of the adds up to f32 rounding boundaries:
// the design below changes where the f64 adds happen, not what they add).
// I adds the int32 quantized weights (in [-127, 127]) with int32 global
// atomics and no rounding: int32 atomic addition wraps modulo 2^32, which
// is associative and commutative, so every schedule leaves the same bits,
// and below QUANT_ROW_LIMIT rows (rows * 127 < 2^31) no sum wraps.
//
// What bounds F and K on an H100: the bytes in principle, 4 bytes of
// leaf id per row (once per slot chunk, from L2 after the first) and
// G + 12 bytes per row that lands in a slot: ~0.013 ms on a tree's first
// round, when every row lands in one slot.  The first design added each
// row with G * 3 global atomicAdd(double*) onto that slot's addresses:
// ~2.2 ms.  This one is bound by latency (five warps an SM, each with
// its own 42 KB histogram): ~0.55 ms on the first round, ~0.5 ms at
// W = 126 on an H100 at 700 W (chip_smoke.py, PERF.md).
//
// Design of F and K: hist_f64.cuh, shared with kernels D and E.  Slot
// chunks, group chunks over gridDim.z, and gridDim.x CTAs a group chunk
// (ops/histogram.py bins_hist_plan), shared equally over the slot
// chunks; the landed rows are listed
// and their G bin bytes and weights streamed through a cp.async ring
// (4-byte copies where G % 4 == 0); each warp owns one private
// (gc, B, 3) f64 histogram (S slots x C copies: five of 42 KB at
// 28 x 63, C = 5 on a first round, S = 5 on a wide frontier) and lane g
// adds group g of 8 rows at a time (equal bins merged first), so no two
// lanes add to one address and no shared atomic is needed (shared
// atomicAdd(double*) is a CAS loop on sm_90a).  One global f64 add per
// nonzero bin at the end.
//
// Kernel I keeps the first design: one thread per row, the frontier
// slots in shared memory, int32 global atomics.

#include <cuda_runtime.h>
#include <cstdint>

#include "hist_f64.cuh"

namespace {

// Kernels F and K: ``plan`` from ops/histogram.py bins_hist_plan;
// ``words``: G % 4 == 0 and bins 4-byte aligned (4-byte row copies)
int launch_f64(const void* bins, const void* w, const void* leaf_in,
               const void* slots, void* hist, int64_t n, int G, int B, int W,
               int words, const int64_t* plan, void* stream) {
  const ltt_f64::In in{(const uint8_t*)bins, G, (const float*)w, 3, 1,
                       (const int32_t*)leaf_in, (const int32_t*)slots,
                       (double*)hist, n, G, B, W, 1, 0};
  cudaStream_t s = (cudaStream_t)stream;
  return words ? ltt_f64::launch<false, 4>(in, plan, s)
               : ltt_f64::launch<false, 1>(in, plan, s);
}

// ---------------------------------------------------------------------------
// Kernel I: int32 weights, one thread per row, int32 global atomics
// ---------------------------------------------------------------------------
__global__ void bins_hist_q_kernel(
    const uint8_t* __restrict__ bins, const int32_t* __restrict__ w,
    const int32_t* __restrict__ leaf_in, const int32_t* __restrict__ slots,
    int32_t* __restrict__ hist, int64_t n, int G, int B, int W) {
  extern __shared__ int32_t s_slots[];
  for (int i = threadIdx.x; i < W; i += blockDim.x) s_slots[i] = slots[i];
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int leaf = leaf_in[row];
  if (leaf < 0) return;
  const int32_t w0 = __ldg(w + row * 3);
  const int32_t w1 = __ldg(w + row * 3 + 1);
  const int32_t w2 = __ldg(w + row * 3 + 2);
  if (w0 == 0 && w1 == 0 && w2 == 0) return;
  const uint8_t* r = bins + row * G;
  const int64_t slot_stride = (int64_t)G * B * 3;
  for (int s = 0; s < W; ++s) {
    if (s_slots[s] != leaf) continue;
    int32_t* h = hist + s * slot_stride;
    for (int g = 0; g < G; ++g) {
      const int bin = __ldg(r + g);
      if (bin >= B) continue;
      int32_t* p = h + ((int64_t)g * B + bin) * 3;
      if (w0) atomicAdd(p, w0);
      if (w1) atomicAdd(p + 1, w1);
      if (w2) atomicAdd(p + 2, w2);
    }
  }
}

}  // namespace

// Kernel F.  bins (n, G) uint8 row-major, w (n, 3) f32, leaf_in (n,)
// int32, slots (W,) int32 -> hist (W, G, B, 3) f64 (zeroed by the
// caller, accumulated here).  ``words``: G % 4 == 0 and bins 4-byte
// aligned; ``plan`` the launch geometry (ops/histogram.py
// bins_hist_plan).  Returns the launch's cudaGetLastError() (or the
// shared-memory attribute's error).
extern "C" int ltt_bins_hist(const void* bins, const void* w,
                             const void* leaf_in, const void* slots,
                             void* hist, int64_t n, int G, int B, int W,
                             int words, const int64_t* plan, void* stream) {
  return launch_f64(bins, w, leaf_in, slots, hist, n, G, B, W, words, plan,
                    stream);
}

// Kernel K.  The same function as kernel F, behind the pallas_paired
// plan's entry point (same arguments).
extern "C" int ltt_bins_hist_paired(const void* bins, const void* w,
                                    const void* leaf_in, const void* slots,
                                    void* hist, int64_t n, int G, int B,
                                    int W, int words, const int64_t* plan,
                                    void* stream) {
  return launch_f64(bins, w, leaf_in, slots, hist, n, G, B, W, words, plan,
                    stream);
}

// Kernel I.  bins (n, G) uint8 row-major, wq (n, 3) int32 quantized,
// leaf_in (n,) int32, slots (W,) int32 -> hist (W, G, B, 3) int32 (zeroed
// by the caller, accumulated here).  Returns cudaGetLastError().
extern "C" int ltt_bins_hist_q(const void* bins, const void* wq,
                               const void* leaf_in, const void* slots,
                               void* hist, int64_t n, int G, int B, int W,
                               void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  const size_t smem = (size_t)(W > 0 ? W : 1) * sizeof(int32_t);
  bins_hist_q_kernel<<<(unsigned)blocks, threads, smem,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (const int32_t*)wq, (const int32_t*)leaf_in,
      (const int32_t*)slots, (int32_t*)hist, n, G, B, W);
  return (int)cudaGetLastError();
}
