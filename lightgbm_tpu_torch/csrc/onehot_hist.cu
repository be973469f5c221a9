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
// Weights: f32 (grad, hess, count) rounded to bf16 with round-to-nearest-
// even, as the TPU kernel casts them before its bf16 x bf16 -> f32 dot,
// and accumulated here in f64 (global atomicAdd(double*)) and rounded
// once to f32 by the wrapper.  An f64 sum of n bf16 values (8-bit
// significands) is exact, whatever the order, while the exponent span of
// the values plus 8 plus log2(n) is at most 53; outside that, each f64 add
// rounds by ~2^-53 of the running sum, which changes the f32 result only
// where the sum lies that close to an f32 rounding boundary.  So results
// agree from run to run except at such boundaries.  Or int32 quantized
// weights in [-127, 127] accumulated exactly in int32 (QUANT).
//
// What bounds it on an H100: the stream is the one-hot rows of the rows
// that land in a slot (512 B a row at the bench shape, pack 4), 12 bytes
// of weights and 8 bytes of leaf id per row; the adds are G * 3 per
// landed row, so the atomics, not the bytes, set the time when the
// frontier is narrow (a tree's first round puts every row in one slot).
//
// Design: a warp owns a tile of 32 consecutive rows.  Each lane loads,
// routes (route.cuh) and rounds its own row's scalars, so those loads are
// coalesced; the warp then walks the tile's live rows one at a time,
// matches the row's leaf against the frontier slots held in shared memory
// with one ballot per 32 slots (a row adds to EVERY equal slot, as the
// TPU's slot one-hot does), and reads the row's one-hot cooperatively:
// lane i loads V bytes at i * V (V = 16 where the row is 16-byte aligned,
// 512 B = one load per lane at the bench shape), skips zero words and
// adds the row's weights at each set bit.  Rows in no slot never read
// their one-hot row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "route.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool QUANT>
struct Acc;

template <>
struct Acc<false> {
  using W = float;
  __device__ static void add3(void* hist, int64_t idx, W a, W b, W c) {
    double* h = static_cast<double*>(hist) + idx * 3;
    if (a != 0.f) atomicAdd(h, (double)a);
    if (b != 0.f) atomicAdd(h + 1, (double)b);
    if (c != 0.f) atomicAdd(h + 2, (double)c);
  }
  __device__ static W load(const void* w, int64_t i) {
    return bf16_round(__ldg(static_cast<const float*>(w) + i));
  }
};

template <>
struct Acc<true> {
  using W = int32_t;
  __device__ static void add3(void* hist, int64_t idx, W a, W b, W c) {
    int32_t* h = static_cast<int32_t*>(hist) + idx * 3;
    if (a) atomicAdd(h, a);
    if (b) atomicAdd(h + 1, b);
    if (c) atomicAdd(h + 2, c);
  }
  __device__ static W load(const void* w, int64_t i) {
    return __ldg(static_cast<const int32_t*>(w) + i);
  }
};

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
// histogram of slot ``si``.
template <int V, bool QUANT>
__device__ __forceinline__ void add_row(
    const uint8_t* __restrict__ rowp, int64_t row_bytes, int lane, int si,
    int64_t gb, int pack, int gbp, typename Acc<QUANT>::W w0,
    typename Acc<QUANT>::W w1, typename Acc<QUANT>::W w2, void* hist) {
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
            Acc<QUANT>::add3(hist, (int64_t)si * gb + (int64_t)p * gbp + j,
                             w0, w1, w2);
        }
      }
    }
  }
}

template <int V, bool QUANT, bool ROUTE>
__global__ void onehot_hist_kernel(
    const uint8_t* __restrict__ ohb, int64_t row_bytes,
    const uint8_t* __restrict__ binsT, const void* __restrict__ w,
    int64_t ws_r, int64_t ws_c, const int32_t* __restrict__ leaf_in,
    const float* __restrict__ table, const int32_t* __restrict__ slots,
    void* __restrict__ hist, int32_t* __restrict__ leaf_out, int64_t n,
    int G, int B, int L, int K, int W, int pack, int gbp) {
  using A = Acc<QUANT>;
  using WT = typename A::W;
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
    WT w0 = 0, w1 = 0, w2 = 0;
    if (row < n) {
      leaf = leaf_in[row];
      if constexpr (ROUTE) {
        bool went_right;
        leaf = ltt_route_row(binsT, n, row, G, leaf, table, L, K,
                             K - LTT_ROUTE_FIXED_COLS, &went_right);
        leaf_out[row] = leaf;
      }
      if (leaf >= 0) {
        w0 = A::load(w, row * ws_r);
        w1 = A::load(w, row * ws_r + ws_c);
        w2 = A::load(w, row * ws_r + 2 * ws_c);
      }
    }
    unsigned live = __ballot_sync(
        kFull, leaf >= 0 && (w0 != 0 || w1 != 0 || w2 != 0));
    while (live) {
      const int k = __ffs(live) - 1;
      live &= live - 1;
      const int lk = __shfl_sync(kFull, leaf, k);
      const WT a = __shfl_sync(kFull, w0, k);
      const WT b = __shfl_sync(kFull, w1, k);
      const WT c = __shfl_sync(kFull, w2, k);
      const uint8_t* rowp = ohb + (base + k) * row_bytes;
      for (int sb = 0; sb < W; sb += 32) {
        const int s = sb + lane;
        unsigned m = __ballot_sync(kFull, s < W && s_slots[s] == lk);
        while (m) {
          const int si = sb + __ffs(m) - 1;
          m &= m - 1;
          add_row<V, QUANT>(rowp, row_bytes, lane, si, gb, pack, gbp, a, b,
                            c, hist);
        }
      }
    }
  }
}

template <int V, bool QUANT, bool ROUTE>
int launch(const void* ohb, int64_t row_bytes, const void* binsT,
           const void* w, int64_t ws_r, int64_t ws_c, const void* leaf_in,
           const void* table, const void* slots, void* hist, void* leaf_out,
           int64_t n, int G, int B, int L, int K, int W, int pack, int gbp,
           cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;        // grid-stride over row tiles
  const size_t smem = (size_t)(W > 0 ? W : 1) * sizeof(int32_t);
  onehot_hist_kernel<V, QUANT, ROUTE><<<(unsigned)blocks, threads, smem,
                                        stream>>>(
      (const uint8_t*)ohb, row_bytes, (const uint8_t*)binsT, w, ws_r, ws_c,
      (const int32_t*)leaf_in, (const float*)table, (const int32_t*)slots,
      hist, (int32_t*)leaf_out, n, G, B, L, K, W, pack, gbp);
  return (int)cudaGetLastError();
}

template <bool QUANT, bool ROUTE>
int dispatch_vec(int vec, const void* ohb, int64_t row_bytes,
                 const void* binsT, const void* w, int64_t ws_r,
                 int64_t ws_c, const void* leaf_in, const void* table,
                 const void* slots, void* hist, void* leaf_out, int64_t n,
                 int G, int B, int L, int K, int W, int pack, int gbp,
                 cudaStream_t s) {
  if (vec == 16)
    return launch<16, QUANT, ROUTE>(ohb, row_bytes, binsT, w, ws_r, ws_c,
                                    leaf_in, table, slots, hist, leaf_out, n,
                                    G, B, L, K, W, pack, gbp, s);
  if (vec == 4)
    return launch<4, QUANT, ROUTE>(ohb, row_bytes, binsT, w, ws_r, ws_c,
                                   leaf_in, table, slots, hist, leaf_out, n,
                                   G, B, L, K, W, pack, gbp, s);
  return launch<1, QUANT, ROUTE>(ohb, row_bytes, binsT, w, ws_r, ws_c,
                                 leaf_in, table, slots, hist, leaf_out, n, G,
                                 B, L, K, W, pack, gbp, s);
}

}  // namespace

// ohb (n, row_bytes) uint8 one-hot (rows ``vec``-byte aligned, vec in
// {16, 4, 1}); w: weight (r, c) at w[r * ws_r + c * ws_c], f32 or (quant)
// int32; leaf_in (n,) int32; slots (W,) int32; hist (W, G * B, 3) f64 or
// (quant) int32, zeroed by the caller and accumulated here.  With
// ``route`` the (L, K) f32 table routes each row first over binsT (G, n)
// uint8 and leaf_out (n,) receives the new leaf ids; without it binsT,
// table and leaf_out are unused.  Returns the launch's cudaGetLastError().
extern "C" int ltt_onehot_hist(
    const void* ohb, int64_t row_bytes, int vec, const void* binsT,
    const void* w, int64_t ws_r, int64_t ws_c, int quant,
    const void* leaf_in, const void* table, const void* slots, void* hist,
    void* leaf_out, int64_t n, int G, int B, int L, int K, int W, int pack,
    int gbp, int route, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (quant && route)
    return dispatch_vec<true, true>(vec, ohb, row_bytes, binsT, w, ws_r,
                                    ws_c, leaf_in, table, slots, hist,
                                    leaf_out, n, G, B, L, K, W, pack, gbp, s);
  if (quant)
    return dispatch_vec<true, false>(vec, ohb, row_bytes, binsT, w, ws_r,
                                     ws_c, leaf_in, table, slots, hist,
                                     leaf_out, n, G, B, L, K, W, pack, gbp,
                                     s);
  if (route)
    return dispatch_vec<false, true>(vec, ohb, row_bytes, binsT, w, ws_r,
                                     ws_c, leaf_in, table, slots, hist,
                                     leaf_out, n, G, B, L, K, W, pack, gbp,
                                     s);
  return dispatch_vec<false, false>(vec, ohb, row_bytes, binsT, w, ws_r,
                                    ws_c, leaf_in, table, slots, hist,
                                    leaf_out, n, G, B, L, K, W, pack, gbp, s);
}
