// Row routing passes: the exit route + row value (kernel B) and the
// route alone (kernel H).  One template, two entry points.
//
// Kernel B replaces the Pallas kernel _route_value_kernel_body
// (lightgbm_tpu/ops/histogram.py:1632, entry point route_apply_tiled
// :1708).  When a tree's last round has chosen its splits, those splits
// were never applied to the rows: this pass applies them and returns
// each row's post-route leaf value for the score update (0 for padded
// rows, whose leaf is negative).
//
// Kernel H replaces the Pallas kernel _route_only_kernel_body
// (lightgbm_tpu/ops/histogram.py:1654, entry point route_only_tiled
// :1668): B without the value columns.  The split-route plan runs it at
// the start of every round to apply the pending route table before the
// route-free histogram (csrc/fused_route_hist.cu, kernel G).
//
// Value parity (B): the TPU kernel does not return the f32 leaf value
// itself but hi + mid + lo of its three bf16-exact parts
// (ops/partition.py _split3_bf16), summed in f32 as (hi + mid) + lo.
// The table carries those parts as six columns after the route columns
// (keep-slot value, then right-child value), and this kernel adds them
// in the same order, so the row values equal the TPU kernel's bit for
// bit.
//
// What bounds them on an H100: memory.  Per row they read the leaf id
// and write the new one (8 bytes), read one bin byte of the chosen
// group for rows of a splitting leaf, and B writes the 4-byte value;
// the route table stays in cache.  No atomics: each row's outputs are
// written by its own thread, so the result does not depend on the
// schedule.  Design: one thread per row, coalesced leaf/value streams,
// the table row gathered through the read-only cache.

#include <cuda_runtime.h>
#include <cstdint>

#include "route.cuh"

namespace {

template <bool kValues>
__global__ void route_kernel(
    const uint8_t* __restrict__ binsT, const int32_t* __restrict__ leaf_in,
    const float* __restrict__ table, int32_t* __restrict__ leaf_out,
    float* __restrict__ val_out, int64_t n, int G, int L, int K) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int leaf = leaf_in[row];
  const int stride = kValues ? K + 6 : K;
  bool went_right;
  const int new_leaf = ltt_route_row(binsT, n, row, G, leaf, table, L,
                                     stride, K - LTT_ROUTE_FIXED_COLS,
                                     &went_right);
  leaf_out[row] = new_leaf;
  if constexpr (kValues) {
    float val = 0.0f;
    if (leaf >= 0 && leaf < L) {
      const float* v =
          table + (int64_t)leaf * stride + K + (went_right ? 3 : 0);
      val = (__ldg(v) + __ldg(v + 1)) + __ldg(v + 2);
    }
    val_out[row] = val;
  }
}

template <bool kValues>
int launch_route(const void* binsT, const void* leaf_in, const void* table,
                 void* leaf_out, void* val_out, int64_t n, int G, int L,
                 int K, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  route_kernel<kValues><<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)binsT, (const int32_t*)leaf_in, (const float*)table,
      (int32_t*)leaf_out, (float*)val_out, n, G, L, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel B.  binsT (G, n) uint8, leaf_in (n,) int32, table (L, K + 6)
// f32 -> leaf_out (n,) int32, val_out (n,) f32.  K is the route-table
// width without the six value columns.  Returns cudaGetLastError().
extern "C" int ltt_route_apply(const void* binsT, const void* leaf_in,
                               const void* table, void* leaf_out,
                               void* val_out, int64_t n, int G, int L,
                               int K, void* stream) {
  return launch_route<true>(binsT, leaf_in, table, leaf_out, val_out, n, G,
                            L, K, stream);
}

// Kernel H.  binsT (G, n) uint8, leaf_in (n,) int32, table (L, K) f32 ->
// leaf_out (n,) int32.  Returns cudaGetLastError().
extern "C" int ltt_route_only(const void* binsT, const void* leaf_in,
                              const void* table, void* leaf_out, int64_t n,
                              int G, int L, int K, void* stream) {
  return launch_route<false>(binsT, leaf_in, table, leaf_out, nullptr, n, G,
                             L, K, stream);
}
