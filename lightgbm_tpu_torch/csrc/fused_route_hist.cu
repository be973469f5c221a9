// Frontier histograms of the transposed bins with int8-quantized
// weights: the fused route + histogram (kernel A) and the same
// histogram without routing (kernel G).  One histogram kernel
// (csrc/hist_i32.cuh in its transposed layout; kernel I, bins_hist.cu,
// runs its row-major one), two entry points.
//
// Kernel A replaces the Pallas kernel _fused_kernel_body_q_tiled
// (lightgbm_tpu/ops/histogram.py:1412, entry point
// compute_group_histograms_fused_tiled :1464).  It applies last round's
// pending route table to each row's leaf id, writes the new leaf id, and
// adds the row's int8-quantized (grad, hess, count) into the int32
// histogram of every frontier slot equal to its new leaf.
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
// is the histogram update: up to 3*G int32 adds per row that lands in a
// slot, many to the same few bins while the frontier is narrow (a
// tree's first round puts every row in one slot's 5,292 words).
//
// Design (csrc/hist_i32.cuh): each CTA adds its rows into a private
// int32 histogram in shared memory (native ATOMS.ADD) and stores it as
// one copy; a second launch sums the copies, so no row adds to device
// memory.  The CTAs split the groups, not the slots: one group of every
// frontier slot fits in shared memory (126 slots x 63 bins: 95 KB), so
// every CTA sees every landed row of its rows whichever slot holds it.
// A row finds its slots through a leaf -> slot table in shared memory,
// not a scan of the W slots.  Kernel A routes first, in its own launch
// (one thread a row, csrc/route.cuh), and the histogram reads the new
// leaf ids: routing in every group-chunk CTA would repeat it gridDim.y
// times.
//
// Sub-byte bin storage (a nonzero pack spec, packing.py): binsT is the
// (cols, n) storage of the G logical groups, and both launches read it
// as stored: the routing widens the chosen group's byte (route.cuh), the
// histogram each group's 4-row word (hist_i32.cuh), in registers, the
// same bins as the byte-wide matrix's from half (nibbles) or a quarter
// (crumbs) of its bytes.
//
// Why the result does not depend on the order of the adds: int32
// addition wraps modulo 2^32, which is associative and commutative, so
// every schedule leaves the same bits; and with at most QUANT_ROW_LIMIT
// rows (rows * 127 < 2^31, checked by the grower's plan) no sum wraps,
// so those bits are the exact sum.

#include <cuda_runtime.h>
#include <cstdint>

#include "hist_i32.cuh"
#include "route.cuh"

namespace {

// Kernel A's routing launch: one thread a row applies the pending route
// table to its leaf id (kPacked: over the sub-byte storage of the spec
// (P, C), csrc/pack.cuh).
template <bool kPacked>
__global__ void routing_pass_kernel(const uint8_t* __restrict__ binsT,
                                    const int32_t* __restrict__ leaf_in,
                                    const float* __restrict__ table,
                                    int32_t* __restrict__ leaf_out,
                                    int64_t n, int G, int L, int K, int P,
                                    int C) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  bool went_right;
  leaf_out[row] = ltt_route_row<kPacked>(binsT, n, row, G, leaf_in[row],
                                         table, L, K, K - LTT_ROUTE_FIXED_COLS,
                                         &went_right, P, C);
}

}  // namespace

// Kernel A.  binsT (G, n) uint8 (spec != 0: the (cols, n) sub-byte
// storage of G logical groups, spec = P | C << 16, packing.py
// pack_spec), wT (3, n) int32, leaf_in (n,) int32, table (L, K) f32,
// slots (W,) int32 -> hist (W, G, B, 3) int32 (zeroed every word
// written), leaf_out (n,) int32; plan: the int64 launch plan of
// ops/histogram.py frontier_hist_plan; part: its (grid_x, W, G, B, 3)
// int32 scratch.  Three launches on ``stream``: the routing pass, the
// histogram of the new leaf ids, the sum of its copies.  Returns the
// first nonzero cudaGetLastError().
extern "C" int ltt_fused_route_hist(
    const void* binsT, const void* wT, const void* leaf_in,
    const void* table, const void* slots, void* hist, void* leaf_out,
    int64_t n, int G, int B, int L, int K, int W, const int64_t* plan,
    void* part, int spec, void* stream) {
  const int P = spec & 0xffff, C = spec >> 16;
  if (n > 0) {
    const int threads = 256;
    const unsigned grid = (unsigned)((n + threads - 1) / threads);
    const cudaStream_t s = (cudaStream_t)stream;
    if (spec)
      routing_pass_kernel<true><<<grid, threads, 0, s>>>(
          (const uint8_t*)binsT, (const int32_t*)leaf_in,
          (const float*)table, (int32_t*)leaf_out, n, G, L, K, P, C);
    else
      routing_pass_kernel<false><<<grid, threads, 0, s>>>(
          (const uint8_t*)binsT, (const int32_t*)leaf_in,
          (const float*)table, (int32_t*)leaf_out, n, G, L, K, 0, 0);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const ltt_i32::In in{(const uint8_t*)binsT, (const int32_t*)wT,
                       (const int32_t*)leaf_out, (const int32_t*)slots,
                       (int32_t*)hist, (int32_t*)part, n, G, B, W, P, C};
  return ltt_i32::launch<false>(in, plan, (cudaStream_t)stream);
}

// Kernel G.  The same histogram of the rows' current leaf ids: binsT
// (G, n) uint8 (or, spec != 0, the storage as for A), wT (3, n) int32,
// leaf_in (n,) int32, slots (W,) int32 -> hist (W, G, B, 3) int32 (every
// word written); plan and part as for A.  Two launches: the histogram
// and the sum of its copies.  Returns the first nonzero
// cudaGetLastError().
extern "C" int ltt_tiled_hist(const void* binsT, const void* wT,
                              const void* leaf_in, const void* slots,
                              void* hist, int64_t n, int G, int B, int W,
                              const int64_t* plan, void* part, int spec,
                              void* stream) {
  const ltt_i32::In in{(const uint8_t*)binsT, (const int32_t*)wT,
                       (const int32_t*)leaf_in, (const int32_t*)slots,
                       (int32_t*)hist, (int32_t*)part, n, G, B, W,
                       spec & 0xffff, spec >> 16};
  return ltt_i32::launch<false>(in, plan, (cudaStream_t)stream);
}
