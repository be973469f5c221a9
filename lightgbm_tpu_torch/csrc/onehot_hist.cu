// Frontier histograms from the streamed bin one-hot: kernel D (fused
// route + histogram) and kernel E (histogram alone).
//
// Replaces three Pallas kernels of lightgbm_tpu/ops/histogram.py:
//   D  _fused_kernel_body (:1272, entry compute_group_histograms_fused
//      :1337): apply last round's pending route table to each row's leaf
//      id, write the new leaf id, then add the row into the histogram of
//      every frontier slot equal to its new leaf;
//   E  _hist_kernel_body_pre_packed (:769, entry
//      compute_group_histograms_pre_packed :1106) and _hist_kernel_body_pre
//      (:727, entry compute_group_histograms_pre :865): the same histogram
//      with final leaf ids and no routing.  The two TPU bodies differ only
//      in how they lay the three weight channels over the MXU's lanes; on
//      the GPU one kernel serves both (each entry point keeps its own
//      wrapper and launch count in ops/histogram.py).
//
// The one-hot is the caller's (N, row_bytes) byte matrix from
// precompute_bin_onehot{,_packed}: with pack = 1 byte c of a row is 1
// where group c / B holds bin c % B; with pack = 2 or 4 it is planar, byte
// j carrying full column p * gbp + j in bit (8 / pack) * p, planes padded
// with zero bytes to a 128-byte multiple (bytes j >= gbp match nothing).
// Exactly G of a row's bits are set (fewer where a bin is >= B).
//
// f32 weights (grad, hess, count) are rounded to bf16 with round-to-
// nearest-even, as the TPU kernel casts them before its bf16 x bf16 ->
// f32 dot, accumulated here in f64 and rounded once to f32 by the
// wrapper.  Why the order does not matter: an f64 sum of n bf16 values
// (8-bit significands) is exact, whatever the order, while the exponent
// span of the values plus 8 plus log2(n) is at most 53; outside that,
// each f64 add rounds by ~2^-53 of the running sum, which changes the f32
// result only where the sum lies that close to an f32 rounding boundary.
// The design below changes only where and in what grouping the f64 adds
// happen (a warp's shared histogram, then one global add per bin), not
// what they add.
//
// What bounds it on an H100: the bytes, in principle.  A landed row (one
// whose leaf is a slot) streams its one-hot row (441 of 512 bytes at pack
// 4, the bench shape) and 12 bytes of weights; every row's leaf id is
// read once per slot chunk (from L2 after the first).  On a tree's first
// round every row lands in one slot: ~0.14 ms at 3.35 TB/s.  The first
// design added each set bit with a global atomicAdd(double*): 84 global
// f64 atomics per landed row, ~2.1-2.6 ms on that round, slower than one
// bf16 torch.mm of the same histogram (~1.3 ms).  What bounds this
// design is latency: a 42 KB f64 histogram per warp leaves four warps an
// SM, so the adds (dependent shared-memory load-add-store chains) and
// the ring's round trips are not hidden.  On an H100 (700 W) the first
// round takes ~0.98 ms, a 126-wide frontier ~1.0 ms
// (chip_smoke.py, PERF.md).
//
// Design (f32 weights): hist_f64.cuh, shared with kernels F and K.  The
// landed rows are listed, their one-hot rows and weights streamed
// through a cp.async ring, and added 8 rows at a time into f64
// histograms in shared memory, with no shared atomic (shared
// atomicAdd(double*) is a CAS loop on sm_90a): each thread owns its own
// columns of a row.  A frontier of at most 128 slots (every round of a
// 255-leaf tree) takes one slot a CTA whose columns its 128 threads
// share out, two CTAs an SM, so every thread adds every landed row
// however the rows fall over the slots; the CTAs (about 8 a slot, up to
// four waves) are shared out over the slots by a sample of the leaf ids,
// so a large leaf gets the CTAs its rows need.  A wider frontier keeps 4
// slots a CTA, one warp each (lane i owns 16 bytes at i * 16 of a row),
// in equal shares.  Group chunks over gridDim.z when one slot does not
// fit.  One global f64 add per nonzero bin at the end.  Kernel D routes
// first, in its own launch behind the same entry point
// (route_rows_kernel: one thread a row writes every new leaf id once),
// and the histogram launch reads those leaf ids, so each row is routed
// once and not once for every slot chunk that scans it.
//
// int8-quantized weights (int32 in [-127, 127]) keep the first design:
// a warp per 32-row tile adds each live row with int32 global atomics,
// exact in any order (onehot_hist_q_kernel below).
//
// Sub-byte bin storage (a nonzero spec): the one-hot is built from the
// storage by the wrapper's builder (ops/histogram.py), so the histogram
// does not change; D's routing reads binsT as the (cols, n) packed
// matrix and widens the chosen group's storage byte in registers
// (csrc/route.cuh, kPacked).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hist_f64.cuh"
#include "route.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// int8-quantized weights: int32 global atomics
// ---------------------------------------------------------------------------
__device__ __forceinline__ void add3(int32_t* hist, int64_t idx, int32_t a,
                                     int32_t b, int32_t c) {
  int32_t* h = hist + idx * 3;
  if (a) atomicAdd(h, a);
  if (b) atomicAdd(h + 1, b);
  if (c) atomicAdd(h + 2, c);
}

// V bytes of a one-hot row as 32-bit words (one byte per word when V = 1)
template <int V>
struct Words {
  static constexpr int kN = V >= 4 ? V / 4 : 1;
  static constexpr int kBytesPerWord = V >= 4 ? 4 : 1;
  uint32_t w[kN];
  __device__ __forceinline__ void load(const uint8_t* p) {
    if constexpr (V == 16) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else if constexpr (V == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(p);
    }
  }
};

// Add one row's weights at every set bit of its one-hot row into the
// histogram of slot ``si``: lane i loads V bytes at i * V.
template <int V>
__device__ __forceinline__ void add_row(
    const uint8_t* __restrict__ rowp, int64_t row_bytes, int lane, int si,
    int64_t gb, int pack, int gbp, int32_t w0, int32_t w1, int32_t w2,
    int32_t* hist) {
  const int bits = 8 / pack;
  for (int64_t off = (int64_t)lane * V; off < row_bytes; off += 32 * V) {
    Words<V> x;
    x.load(rowp + off);
#pragma unroll
    for (int k = 0; k < Words<V>::kN; ++k) {
      const uint32_t word = x.w[k];
      if (word == 0) continue;
#pragma unroll
      for (int b = 0; b < Words<V>::kBytesPerWord; ++b) {
        const uint32_t byte = (word >> (8 * b)) & 0xffu;
        if (byte == 0) continue;
        const int64_t j = off + k * Words<V>::kBytesPerWord + b;
        if (j >= gbp) continue;              // plane padding
        for (int p = 0; p < pack; ++p) {
          if ((byte >> (p * bits)) & 1u)
            add3(hist, (int64_t)si * gb + (int64_t)p * gbp + j, w0, w1, w2);
        }
      }
    }
  }
}

// A warp owns a tile of 32 consecutive rows: each lane loads (and routes)
// its own row; the warp then walks the tile's live rows, matches each
// against the frontier slots in shared memory (one ballot per 32 slots,
// every equal slot) and adds it cooperatively.
template <int V, bool ROUTE, bool kPacked>
__global__ void onehot_hist_q_kernel(
    const uint8_t* __restrict__ ohb, int64_t row_bytes,
    const uint8_t* __restrict__ binsT, const int32_t* __restrict__ w,
    int64_t ws_r, int64_t ws_c, const int32_t* __restrict__ leaf_in,
    const float* __restrict__ table, const int32_t* __restrict__ slots,
    int32_t* __restrict__ hist, int32_t* __restrict__ leaf_out, int64_t n,
    int G, int B, int L, int K, int W, int pack, int gbp, int P, int C) {
  extern __shared__ int32_t s_slots[];
  for (int i = threadIdx.x; i < W; i += blockDim.x) s_slots[i] = slots[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t gb = (int64_t)G * B;
  for (int64_t base = warp * 32; base < n; base += nwarps * 32) {
    const int64_t row = base + lane;
    int leaf = -1;
    int32_t w0 = 0, w1 = 0, w2 = 0;
    if (row < n) {
      leaf = leaf_in[row];
      if constexpr (ROUTE) {
        bool went_right;
        leaf = ltt_route_row<kPacked>(binsT, n, row, G, leaf, table, L, K,
                                      K - LTT_ROUTE_FIXED_COLS, &went_right,
                                      P, C);
        leaf_out[row] = leaf;
      }
      if (leaf >= 0) {
        w0 = __ldg(w + row * ws_r);
        w1 = __ldg(w + row * ws_r + ws_c);
        w2 = __ldg(w + row * ws_r + 2 * ws_c);
      }
    }
    unsigned live = __ballot_sync(
        kFull, leaf >= 0 && (w0 != 0 || w1 != 0 || w2 != 0));
    while (live) {
      const int k = __ffs(live) - 1;
      live &= live - 1;
      const int lk = __shfl_sync(kFull, leaf, k);
      const int32_t a = __shfl_sync(kFull, w0, k);
      const int32_t b = __shfl_sync(kFull, w1, k);
      const int32_t c = __shfl_sync(kFull, w2, k);
      const uint8_t* rowp = ohb + (base + k) * row_bytes;
      for (int sb = 0; sb < W; sb += 32) {
        const int s = sb + lane;
        unsigned m = __ballot_sync(kFull, s < W && s_slots[s] == lk);
        while (m) {
          const int si = sb + __ffs(m) - 1;
          m &= m - 1;
          add_row<V>(rowp, row_bytes, lane, si, gb, pack, gbp, a, b, c,
                     hist);
        }
      }
    }
  }
}

// Kernel D's routing for f32 weights: one thread a row (route.cuh).
template <bool kPacked>
__global__ void route_rows_kernel(const uint8_t* __restrict__ binsT,
                                  const int32_t* __restrict__ leaf_in,
                                  const float* __restrict__ table,
                                  int32_t* __restrict__ leaf_out, int64_t n,
                                  int G, int L, int K, int P, int C) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  bool went_right;
  leaf_out[row] = ltt_route_row<kPacked>(binsT, n, row, G, leaf_in[row],
                                         table, L, K,
                                         K - LTT_ROUTE_FIXED_COLS,
                                         &went_right, P, C);
}

template <int V, bool ROUTE, bool kPacked>
int launch_q(const void* ohb, int64_t row_bytes, const void* binsT,
             const void* w, int64_t ws_r, int64_t ws_c, const void* leaf_in,
             const void* table, const void* slots, void* hist,
             void* leaf_out, int64_t n, int G, int B, int L, int K, int W,
             int pack, int gbp, int P, int C, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;        // grid-stride over row tiles
  const size_t smem = (size_t)(W > 0 ? W : 1) * sizeof(int32_t);
  onehot_hist_q_kernel<V, ROUTE, kPacked><<<(unsigned)blocks, threads, smem,
                                            stream>>>(
      (const uint8_t*)ohb, row_bytes, (const uint8_t*)binsT,
      (const int32_t*)w, ws_r, ws_c, (const int32_t*)leaf_in,
      (const float*)table, (const int32_t*)slots, (int32_t*)hist,
      (int32_t*)leaf_out, n, G, B, L, K, W, pack, gbp, P, C);
  return (int)cudaGetLastError();
}

template <int V, bool ROUTE>
int launch(int quant, const void* ohb, int64_t row_bytes, const void* binsT,
           const void* w, int64_t ws_r, int64_t ws_c, const void* leaf_in,
           const void* table, const void* slots, void* hist, void* leaf_out,
           int64_t n, int G, int B, int L, int K, int W, int pack, int gbp,
           const int64_t* plan, int P, int C, cudaStream_t s) {
  if (quant) {
    if constexpr (ROUTE) {
      if (P > 0)
        return launch_q<V, true, true>(ohb, row_bytes, binsT, w, ws_r, ws_c,
                                       leaf_in, table, slots, hist, leaf_out,
                                       n, G, B, L, K, W, pack, gbp, P, C, s);
    }
    return launch_q<V, ROUTE, false>(ohb, row_bytes, binsT, w, ws_r, ws_c,
                                     leaf_in, table, slots, hist, leaf_out,
                                     n, G, B, L, K, W, pack, gbp, 0, 0, s);
  }
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  if (ROUTE) {
    // kernel D: every row routed once, its new leaf id written; the
    // histogram launch (stream-ordered after it) reads those leaf ids
    const int threads = 256;
    const unsigned grid = (unsigned)((n + threads - 1) / threads);
    if (P > 0)
      route_rows_kernel<true><<<grid, threads, 0, s>>>(
          (const uint8_t*)binsT, (const int32_t*)leaf_in,
          (const float*)table, (int32_t*)leaf_out, n, G, L, K, P, C);
    else
      route_rows_kernel<false><<<grid, threads, 0, s>>>(
          (const uint8_t*)binsT, (const int32_t*)leaf_in,
          (const float*)table, (int32_t*)leaf_out, n, G, L, K, 0, 0);
    const int e = (int)cudaGetLastError();
    if (e != 0) return e;
    leaf_in = leaf_out;
  }
  const ltt_f64::In in{(const uint8_t*)ohb, row_bytes, (const float*)w,
                       ws_r, ws_c, (const int32_t*)leaf_in,
                       (const int32_t*)slots, (double*)hist, n, G, B, W,
                       pack, gbp};
  return ltt_f64::launch<true, V>(in, plan, s);
}

template <bool ROUTE>
int dispatch_vec(int vec, int quant, const void* ohb, int64_t row_bytes,
                 const void* binsT, const void* w, int64_t ws_r,
                 int64_t ws_c, const void* leaf_in, const void* table,
                 const void* slots, void* hist, void* leaf_out, int64_t n,
                 int G, int B, int L, int K, int W, int pack, int gbp,
                 const int64_t* plan, int P, int C, cudaStream_t s) {
  if (vec == 16)
    return launch<16, ROUTE>(quant, ohb, row_bytes, binsT, w, ws_r, ws_c,
                             leaf_in, table, slots, hist, leaf_out, n, G, B,
                             L, K, W, pack, gbp, plan, P, C, s);
  if (vec == 4)
    return launch<4, ROUTE>(quant, ohb, row_bytes, binsT, w, ws_r, ws_c,
                            leaf_in, table, slots, hist, leaf_out, n, G, B,
                            L, K, W, pack, gbp, plan, P, C, s);
  return launch<1, ROUTE>(quant, ohb, row_bytes, binsT, w, ws_r, ws_c,
                          leaf_in, table, slots, hist, leaf_out, n, G, B, L,
                          K, W, pack, gbp, plan, P, C, s);
}

}  // namespace

// ohb (n, row_bytes) uint8 one-hot (rows ``vec``-byte aligned, vec in
// {16, 4, 1}); w: weight (r, c) at w[r * ws_r + c * ws_c], f32 or (quant)
// int32; leaf_in (n,) int32; slots (W,) int32; hist (W, G * B, 3) f64 or
// (quant) int32, zeroed by the caller and accumulated here.  With
// ``route`` the (L, K) f32 table routes each row first over binsT (G, n)
// uint8 (spec != 0: the (cols, n) sub-byte storage of G logical groups,
// spec = P | C << 16) and leaf_out (n,) receives the new leaf ids;
// without it binsT, table, leaf_out and spec are unused.  ``plan`` is
// the f32 launch geometry (ops/histogram.py onehot_hist_plan; unused
// with quant).  Returns the
// launch's cudaGetLastError() (or the shared-memory attribute's error).
extern "C" int ltt_onehot_hist(
    const void* ohb, int64_t row_bytes, int vec, const void* binsT,
    const void* w, int64_t ws_r, int64_t ws_c, int quant,
    const void* leaf_in, const void* table, const void* slots, void* hist,
    void* leaf_out, int64_t n, int G, int B, int L, int K, int W, int pack,
    int gbp, int route, const int64_t* plan, int spec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int P = spec & 0xffff, C = spec >> 16;
  if (route)
    return dispatch_vec<true>(vec, quant, ohb, row_bytes, binsT, w, ws_r,
                              ws_c, leaf_in, table, slots, hist, leaf_out, n,
                              G, B, L, K, W, pack, gbp, plan, P, C, s);
  return dispatch_vec<false>(vec, quant, ohb, row_bytes, binsT, w, ws_r,
                             ws_c, leaf_in, table, slots, hist, leaf_out, n,
                             G, B, L, K, W, pack, gbp, plan, 0, 0, s);
}
