// Frontier histogram from the row-major bin matrix with f32 weights
// (kernel F).
//
// Replaces the Pallas kernel _hist_kernel_body
// (lightgbm_tpu/ops/histogram.py:224, entry compute_group_histograms_pallas
// :544): the plan the grower takes when the streamed one-hot does not fit
// its memory budget.  The TPU body rebuilds the bin one-hot in VMEM
// (an expansion matrix product and a compare) and dots it with the
// slot-masked bf16 weights; here each thread reads its row's G bin bytes
// directly and adds the row's weights at (slot, group, bin).  A bin >= B
// matches nothing, as the TPU's per-column compare does; a negative slot
// matches nothing (leaf ids of live rows are >= 0).
//
// Weights are rounded to bf16 (round-to-nearest-even, the TPU kernel's
// cast before its dot) and accumulated in f64 with global atomics; the
// wrapper rounds the sums once to f32 (see onehot_hist.cu for why that
// makes the result independent of the atomics' order up to f32 rounding
// boundaries).
//
// What bounds it on an H100: it streams G + 12 bytes per row that lands
// in a slot plus 4 bytes of leaf id per row (~40 MB at 1M x 28), but makes
// G * 3 atomic adds per landed row, all on the same few addresses while
// the frontier is narrow: the atomics set the time.
//
// Design: one thread per row (the (N, G) rows of a warp are one
// contiguous span, so the bin loads coalesce through L1); the frontier
// slots sit in shared memory and are scanned linearly, so a row adds to
// every equal slot exactly like the TPU's slot one-hot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void bins_hist_kernel(
    const uint8_t* __restrict__ bins, const float* __restrict__ w,
    const int32_t* __restrict__ leaf_in, const int32_t* __restrict__ slots,
    double* __restrict__ hist, int64_t n, int G, int B, int W) {
  extern __shared__ int32_t s_slots[];
  for (int i = threadIdx.x; i < W; i += blockDim.x) s_slots[i] = slots[i];
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int leaf = leaf_in[row];
  if (leaf < 0) return;
  const float w0 = bf16_round(__ldg(w + row * 3));
  const float w1 = bf16_round(__ldg(w + row * 3 + 1));
  const float w2 = bf16_round(__ldg(w + row * 3 + 2));
  if (w0 == 0.f && w1 == 0.f && w2 == 0.f) return;
  const uint8_t* r = bins + row * G;
  const int64_t slot_stride = (int64_t)G * B * 3;
  for (int s = 0; s < W; ++s) {
    if (s_slots[s] != leaf) continue;
    double* h = hist + s * slot_stride;
    for (int g = 0; g < G; ++g) {
      const int bin = __ldg(r + g);
      if (bin >= B) continue;
      double* p = h + ((int64_t)g * B + bin) * 3;
      if (w0 != 0.f) atomicAdd(p, (double)w0);
      if (w1 != 0.f) atomicAdd(p + 1, (double)w1);
      if (w2 != 0.f) atomicAdd(p + 2, (double)w2);
    }
  }
}

}  // namespace

// bins (n, G) uint8 row-major, w (n, 3) f32, leaf_in (n,) int32, slots
// (W,) int32 -> hist (W, G, B, 3) f64 (zeroed by the caller, accumulated
// here).  Returns the launch's cudaGetLastError().
extern "C" int ltt_bins_hist(const void* bins, const void* w,
                             const void* leaf_in, const void* slots,
                             void* hist, int64_t n, int G, int B, int W,
                             void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  const size_t smem = (size_t)(W > 0 ? W : 1) * sizeof(int32_t);
  bins_hist_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (const float*)w, (const int32_t*)leaf_in,
      (const int32_t*)slots, (double*)hist, n, G, B, W);
  return (int)cudaGetLastError();
}
