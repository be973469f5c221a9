// Frontier histograms of the transposed bins with int8-quantized
// weights: the fused route + histogram (kernel A) and the same
// histogram without routing (kernel G).  One template, two entry
// points.
//
// Kernel A replaces the Pallas kernel _fused_kernel_body_q_tiled
// (lightgbm_tpu/ops/histogram.py:1412, entry point
// compute_group_histograms_fused_tiled :1464).  One pass over the rows:
// apply last round's pending route table to each row's leaf id, write
// the new leaf id, and add the row's int8-quantized (grad, hess, count)
// into the int32 histogram of every frontier slot equal to its new leaf.
//
// Kernel G replaces the Pallas kernel _hist_kernel_body_q_tiled
// (lightgbm_tpu/ops/histogram.py:1021, entry point
// compute_group_histograms_q_tiled :1056): A without the routing
// prologue.  The q_tiled plan applies its splits every round before the
// pass; the split-route plan routes first with route_only_tiled
// (csrc/route_apply.cu).  Each row's leaf id is read, never written.
//
// What bounds them on an H100: the stream is small (per row: 4 bytes of
// leaf id, A also writes 4 and reads one bin byte of a splitting leaf;
// per row in a slot G bytes of transposed bins and 12 bytes of weights:
// about 40 MB at 1M rows x 28 groups, 12 us at 3.35 TB/s), so the limit
// is the histogram update: up to 3*G atomic int32 adds per row that
// lands in a slot, many to the same few addresses while the frontier
// is narrow.
//
// Why the result does not depend on the atomics' order: int32 atomic
// addition wraps modulo 2^32, which is associative and commutative, so
// every schedule leaves the same bits; and with at most QUANT_ROW_LIMIT
// rows (rows * 127 < 2^31, checked by the grower's plan) no sum wraps,
// so those bits are the exact sum.
//
// Design: one thread per row, so every bins/weights/leaf read is
// coalesced (the bins are transposed: group g of consecutive rows is
// contiguous).  A's route-table row is gathered from global memory
// through the read-only cache (the TPU kernel's one-hot product is not
// needed: see route.cuh).  The frontier slots (at most a few hundred)
// sit in shared memory and are scanned linearly, so a row adds to EVERY
// matching slot exactly like the TPU kernel's slot one-hot (a duplicate
// slot gets the row twice, once in each of its histogram rows).  A bin
// >= B matches nothing, as the TPU's per-tile iota compare does.  The
// histogram is accumulated with fire-and-forget global atomics (RED).
// Zero weights are skipped (exact).  A shared-memory privatized
// histogram is the next step: one slot's full histogram is G*B*3*4
// bytes (21 KB at the bench shape) and 126 slots do not fit in 227 KB,
// so it needs tiling over slots or groups.

#include <cuda_runtime.h>
#include <cstdint>

#include "route.cuh"

namespace {

template <bool kRoute>
__global__ void frontier_hist_kernel(
    const uint8_t* __restrict__ binsT, const int32_t* __restrict__ wT,
    const int32_t* __restrict__ leaf_in, const float* __restrict__ table,
    const int32_t* __restrict__ slots, int32_t* __restrict__ hist,
    int32_t* __restrict__ leaf_out, int64_t n, int G, int B, int L, int K,
    int W) {
  extern __shared__ int32_t s_slots[];
  for (int i = threadIdx.x; i < W; i += blockDim.x) s_slots[i] = slots[i];
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  int leaf = leaf_in[row];
  if constexpr (kRoute) {
    bool went_right;
    leaf = ltt_route_row(binsT, n, row, G, leaf, table, L, K,
                         K - LTT_ROUTE_FIXED_COLS, &went_right);
    leaf_out[row] = leaf;
  }
  if (leaf < 0) return;
  const int32_t w0 = wT[row], w1 = wT[n + row], w2 = wT[2 * n + row];
  if ((w0 | w1 | w2) == 0) return;
  const int64_t slot_stride = (int64_t)G * B * 3;
  for (int s = 0; s < W; ++s) {
    if (s_slots[s] != leaf) continue;
    int32_t* h = hist + s * slot_stride;
    for (int g = 0; g < G; ++g) {
      const int bin = binsT[(int64_t)g * n + row];
      if (bin >= B) continue;
      int32_t* p = h + ((int64_t)g * B + bin) * 3;
      if (w0) atomicAdd(p, w0);
      if (w1) atomicAdd(p + 1, w1);
      if (w2) atomicAdd(p + 2, w2);
    }
  }
}

template <bool kRoute>
int launch_frontier_hist(const void* binsT, const void* wT,
                         const void* leaf_in, const void* table,
                         const void* slots, void* hist, void* leaf_out,
                         int64_t n, int G, int B, int L, int K, int W,
                         void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  const size_t smem = (size_t)(W > 0 ? W : 1) * sizeof(int32_t);
  frontier_hist_kernel<kRoute><<<(unsigned)blocks, threads, smem,
                                 (cudaStream_t)stream>>>(
      (const uint8_t*)binsT, (const int32_t*)wT, (const int32_t*)leaf_in,
      (const float*)table, (const int32_t*)slots, (int32_t*)hist,
      (int32_t*)leaf_out, n, G, B, L, K, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel A.  binsT (G, n) uint8, wT (3, n) int32, leaf_in (n,) int32,
// table (L, K) f32, slots (W,) int32 -> hist (W, G, B, 3) int32 (zeroed
// by the caller, accumulated here), leaf_out (n,) int32.  Returns the
// launch's cudaGetLastError().
extern "C" int ltt_fused_route_hist(
    const void* binsT, const void* wT, const void* leaf_in,
    const void* table, const void* slots, void* hist, void* leaf_out,
    int64_t n, int G, int B, int L, int K, int W, void* stream) {
  return launch_frontier_hist<true>(binsT, wT, leaf_in, table, slots, hist,
                                    leaf_out, n, G, B, L, K, W, stream);
}

// Kernel G.  The same histogram of the rows' current leaf ids: binsT
// (G, n) uint8, wT (3, n) int32, leaf_in (n,) int32, slots (W,) int32 ->
// hist (W, G, B, 3) int32 (zeroed by the caller).  Returns the launch's
// cudaGetLastError().
extern "C" int ltt_tiled_hist(const void* binsT, const void* wT,
                              const void* leaf_in, const void* slots,
                              void* hist, int64_t n, int G, int B, int W,
                              void* stream) {
  return launch_frontier_hist<false>(binsT, wT, leaf_in, nullptr, slots,
                                     hist, nullptr, n, G, B, 0, 0, W,
                                     stream);
}
