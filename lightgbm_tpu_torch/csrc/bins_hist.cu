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
// I adds the int32 quantized weights (in [-127, 127]) with no rounding:
// int32 addition wraps modulo 2^32, which is associative and commutative,
// so every schedule leaves the same bits, and below QUANT_ROW_LIMIT rows
// (rows * 127 < 2^31) no sum wraps.
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
// Kernel I is kernel A's and G's int32 histogram (csrc/hist_i32.cuh)
// in its row-major layout: private int32 histograms in shared memory
// (native shared ATOMS.ADD), group chunks over all W slots (slot chunks
// only where one group of them overflows a CTA), a leaf -> slot table,
// one copy a CTA summed by a second launch; geometry from
// ops/histogram.py frontier_hist_plan.  A thread reads 4 rows' leaf ids
// and 12 weights as int4 and each row's bins of its group chunk as the
// aligned words that cover them.  What bounds it: the shared adds (3 * G
// a landed row) and, at a wide frontier, every group chunk's re-read of
// the rows (each chunk pulls every landed row's 32-byte sector of bins,
// mostly from L2: the 28 MB bin matrix fits the H100's 50 MB).  The
// first design (one thread a row, a scan of the W slots a row, 3 * G
// global atomics a landed row) took ~1.9 ms on a tree's first round.

#include <cuda_runtime.h>
#include <cstdint>

#include "hist_f64.cuh"
#include "hist_i32.cuh"

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
// leaf_in (n,) int32, slots (W,) int32 -> hist (W, G, B, 3) int32 (every
// word written); plan: the int64 launch plan of ops/histogram.py
// frontier_hist_plan; part: its (grid_x, W, G, B, 3) int32 scratch.  Two
// launches on ``stream``: the histogram and the sum of its copies.
// Returns the first nonzero cudaGetLastError().
extern "C" int ltt_bins_hist_q(const void* bins, const void* wq,
                               const void* leaf_in, const void* slots,
                               void* hist, int64_t n, int G, int B, int W,
                               const int64_t* plan, void* part,
                               void* stream) {
  const ltt_i32::In in{(const uint8_t*)bins, (const int32_t*)wq,
                       (const int32_t*)leaf_in, (const int32_t*)slots,
                       (int32_t*)hist, (int32_t*)part, n, G, B, W};
  return ltt_i32::launch<true>(in, plan, (cudaStream_t)stream);
}
