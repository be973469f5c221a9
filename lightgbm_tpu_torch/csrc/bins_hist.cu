// Frontier histograms from the row-major bin matrix: f32 weights
// (kernels F and K) and int8-quantized weights (kernel I).  One
// template, three entry points.
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
// layout and means nothing here: K is F's template instance behind its
// own C entry point, counted under its own name (ops/kernels.py).
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
// what this kernel reads directly.
//
// All three TPU bodies rebuild the bin one-hot in VMEM (an expansion
// matrix product and a compare) and dot it with the slot-masked
// weights; here
// each thread reads its row's G bin bytes directly and adds the row's
// weights at (slot, group, bin).  A bin >= B matches nothing, as the
// TPU's per-column compare does; a negative slot matches nothing (leaf
// ids of live rows are >= 0).
//
// F and K round their weights to bf16 (round-to-nearest-even, the TPU
// kernel's cast before its dot) and accumulate in f64 with global atomics;
// the
// wrapper rounds the sums once to f32 (see onehot_hist.cu for why that
// makes the result independent of the atomics' order up to f32 rounding
// boundaries).  I adds the int32 quantized weights (in [-127, 127]) with
// int32 atomics and no rounding: int32 atomic addition wraps modulo
// 2^32, which is associative and commutative, so every schedule leaves
// the same bits, and below QUANT_ROW_LIMIT rows (rows * 127 < 2^31) no
// sum wraps, so they are the exact sum the TPU's int32 accumulator holds.
//
// What bounds them on an H100: they stream G + 12 bytes per row that
// lands in a slot plus 4 bytes of leaf id per row (~40 MB at 1M x 28),
// but make G * 3 atomic adds per landed row, all on the same few
// addresses while the frontier is narrow: the atomics set the time.
//
// Design: one thread per row (the (N, G) rows of a warp are one
// contiguous span, so the bin loads coalesce through L1); the frontier
// slots sit in shared memory and are scanned linearly, so a row adds to
// every equal slot exactly like the TPU's slot one-hot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// F's weight as it enters the sum: the bf16 rounding of the f32 weight
__device__ __forceinline__ float load_weight(const float* w, int64_t i) {
  return __bfloat162float(__float2bfloat16_rn(__ldg(w + i)));
}
// I's weight: the int8-quantized value, exact
__device__ __forceinline__ int32_t load_weight(const int32_t* w, int64_t i) {
  return __ldg(w + i);
}

__device__ __forceinline__ void hist_add(double* p, float v) {
  atomicAdd(p, (double)v);
}
__device__ __forceinline__ void hist_add(int32_t* p, int32_t v) {
  atomicAdd(p, v);
}

template <typename WT, typename AccT>
__global__ void bins_hist_kernel(
    const uint8_t* __restrict__ bins, const WT* __restrict__ w,
    const int32_t* __restrict__ leaf_in, const int32_t* __restrict__ slots,
    AccT* __restrict__ hist, int64_t n, int G, int B, int W) {
  extern __shared__ int32_t s_slots[];
  for (int i = threadIdx.x; i < W; i += blockDim.x) s_slots[i] = slots[i];
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int leaf = leaf_in[row];
  if (leaf < 0) return;
  const WT w0 = load_weight(w, row * 3);
  const WT w1 = load_weight(w, row * 3 + 1);
  const WT w2 = load_weight(w, row * 3 + 2);
  if (w0 == WT(0) && w1 == WT(0) && w2 == WT(0)) return;
  const uint8_t* r = bins + row * G;
  const int64_t slot_stride = (int64_t)G * B * 3;
  for (int s = 0; s < W; ++s) {
    if (s_slots[s] != leaf) continue;
    AccT* h = hist + s * slot_stride;
    for (int g = 0; g < G; ++g) {
      const int bin = __ldg(r + g);
      if (bin >= B) continue;
      AccT* p = h + ((int64_t)g * B + bin) * 3;
      if (w0 != WT(0)) hist_add(p, w0);
      if (w1 != WT(0)) hist_add(p + 1, w1);
      if (w2 != WT(0)) hist_add(p + 2, w2);
    }
  }
}

template <typename WT, typename AccT>
int launch_bins_hist(const void* bins, const void* w, const void* leaf_in,
                     const void* slots, void* hist, int64_t n, int G, int B,
                     int W, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  const size_t smem = (size_t)(W > 0 ? W : 1) * sizeof(int32_t);
  bins_hist_kernel<WT, AccT><<<(unsigned)blocks, threads, smem,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (const WT*)w, (const int32_t*)leaf_in,
      (const int32_t*)slots, (AccT*)hist, n, G, B, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel F.  bins (n, G) uint8 row-major, w (n, 3) f32, leaf_in (n,)
// int32, slots (W,) int32 -> hist (W, G, B, 3) f64 (zeroed by the
// caller, accumulated here).  Returns the launch's cudaGetLastError().
extern "C" int ltt_bins_hist(const void* bins, const void* w,
                             const void* leaf_in, const void* slots,
                             void* hist, int64_t n, int G, int B, int W,
                             void* stream) {
  return launch_bins_hist<float, double>(bins, w, leaf_in, slots, hist, n,
                                         G, B, W, stream);
}

// Kernel K.  The same function as kernel F, behind the pallas_paired
// plan's entry point: bins (n, G) uint8, w (n, 3) f32, leaf_in (n,)
// int32, slots (W,) int32 -> hist (W, G, B, 3) f64 (zeroed by the
// caller).  Returns the launch's cudaGetLastError().
extern "C" int ltt_bins_hist_paired(const void* bins, const void* w,
                                    const void* leaf_in, const void* slots,
                                    void* hist, int64_t n, int G, int B,
                                    int W, void* stream) {
  return launch_bins_hist<float, double>(bins, w, leaf_in, slots, hist, n,
                                         G, B, W, stream);
}

// Kernel I.  bins (n, G) uint8 row-major, wq (n, 3) int32 quantized,
// leaf_in (n,) int32, slots (W,) int32 -> hist (W, G, B, 3) int32 (zeroed
// by the caller, accumulated here).  Returns cudaGetLastError().
extern "C" int ltt_bins_hist_q(const void* bins, const void* wq,
                               const void* leaf_in, const void* slots,
                               void* hist, int64_t n, int G, int B, int W,
                               void* stream) {
  return launch_bins_hist<int32_t, int32_t>(bins, wq, leaf_in, slots, hist,
                                            n, G, B, W, stream);
}
