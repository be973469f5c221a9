// The f64 shared-memory frontier histogram shared by kernels D, E
// (onehot_hist.cu: rows of the streamed bin one-hot) and F, K
// (bins_hist.cu: rows of the row-major bin matrix), for f32 weights.
//
// The frontier's W slots fall into chunks of S; one CTA owns one slot
// chunk, gc groups (gridDim.z chunks) and a range of rows.  Its shared
// memory holds private (gc, B, 3) f64 histograms in one of two layouts:
//  - one a warp (S * C of them): warp u = c * S + s adds the rows of
//    slot s at tile positions i with i % C == c;
//  - one-hot rows of up to 128 slots (p.cols, S = 1): one histogram,
//    whose columns the CTA's threads share out (thread t owns 4 bytes at
//    t * 4, (t + threads) * 4, ... of every row), so the CTA is small
//    enough for two a SM and all its threads add every landed row.
// The launch plan (ops/histogram.py onehot_hist_plan, bins_hist_plan)
// picks the layout, S, C, gc, the chunks, the CTAs of a group chunk
// (gridDim.x) and the shared-memory carve-up; the kernel reads it as
// given.  On a column-owner launch with several slots (p.shared: every
// round of a tree after the first) how the gridDim.x CTAs (up to four
// waves) are shared out over the slots depends on the data, so the
// kernel decides it (pick_chunk): each slot takes one CTA plus a share
// of the rest in proportion to its estimated work, its landed rows
// (counted in a sample of 1024 evenly spaced leaf ids) times the staged
// row's bytes plus the leaf-id scan every slot makes.  A large leaf thus
// gets as many CTAs as its rows need, not gridDim.x / W.  Other launches
// share the CTAs equally (a warp adds only its own slot's rows, so a
// larger share of CTAs would leave the other warps idle).  A chunk's
// CTAs split the rows into equal ranges.
//
// A CTA walks its rows in batches of 8 rows a thread:
//  1. scan: every thread matches the leaf ids of its 8 consecutive rows
//     (loaded while the batch before is scanned) against the chunk's
//     slots, held in registers.  A row matching one or more of them
//     (EVERY equal slot, as the TPU's slot one-hot does) is appended to a
//     list (row, slot mask); one shared int32 atomic (a native ATOMS.ADD)
//     a warp and a batch hands out the positions, and every thread reads
//     the list's count between two barriers, so no warp of the next batch
//     adds to it before all have read it.  The list fills over
//     batches until one more might not fit (a narrow chunk of a wide
//     frontier lists few rows a batch).
//  2. stream: the listed rows' payloads (one-hot row or G bin bytes) and
//     their three f32 weights come through a three-stage ring of cp.async
//     copies, two tiles in flight while the warps add the third.  Rows
//     that land nowhere are never read.
//  3. add, 8 rows at a time: a warp picks its rows of the tile (its
//     slot's, every C-th) with one ballot (or, with p.cols, every thread
//     takes every row); lane i owns the 16-byte chunks at i * 16
//     (+ 512 ...) of a one-hot row, lane g group g of a row of bins, so
//     no two threads add to one column.  A position set in several of
//     the 8 rows is added once with the summed weights (one in a single
//     row takes that row's weights, selected by its index), and a thread
//     issues the loads of up to 4 (one-hot) or 8 (bins) distinct columns
//     before any store, so the load-add-store chains overlap.  No shared
//     atomic is needed: on sm_90a atomicAdd(double*) on a shared address
//     compiles to a CAS loop (LDS.64 + ATOMS.CAST.SPIN.64).
// At the end the C copies of each slot are summed and every nonzero bin
// is added to device memory with one global atomicAdd(double*) (a native
// REDG.ADD.F64), each CTA starting at its own offset.
//
// Weights are rounded to bf16 (round-to-nearest-even) as they enter and
// summed in f64; see onehot_hist.cu for why the order and grouping of the
// adds does not change the f32 result but at f32 rounding boundaries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace ltt_f64 {

constexpr unsigned kFull = 0xffffffffu;
// leaf ids a thread matches per batch
constexpr int kScanBatch = 8;
// slots a CTA holds at most (ops/histogram.py MAX_SLOTS_PER_CTA)
constexpr int kMaxSlots = 8;
// leaf ids sampled to share the CTAs out over the slot chunks, and the
// most chunks the sample serves (more: an equal share each); both live
// in the list's space before the first batch (ops/histogram.py
// CHUNK_SAMPLE, MAX_SAMPLED_CHUNKS)
constexpr int kSample = 1024;
constexpr int kMaxSampledChunks = 128;
// rows a warp adds at once (positions set in several are merged first)
constexpr int kRows = 8;
// one-hot positions a lane adds at once (rows of bins: one per row)
constexpr int kPos = 4;

// The launch plan: ops/histogram.py HistPlan.as_args, in that order
struct Plan {
  int S, C, gc, chunks;
  int stage_rows, list_rows, off_stage, off_list, off_count, smem;
  int grid_x, grid_y, grid_z, threads, rstride, cols, shared;
  explicit Plan(const int64_t* a)
      : S((int)a[0]), C((int)a[1]), gc((int)a[2]), chunks((int)a[3]),
        stage_rows((int)a[4]), list_rows((int)a[5]), off_stage((int)a[6]),
        off_list((int)a[7]), off_count((int)a[8]), smem((int)a[9]),
        grid_x((int)a[10]), grid_y((int)a[11]), grid_z((int)a[12]),
        threads((int)a[13]), rstride((int)a[14]), cols((int)a[15]),
        shared((int)a[16]) {}
};

// What a launch reads and writes.  ``rows`` is the (n, row_bytes) payload
// matrix; weight (r, c) is w[r * ws_r + c * ws_c]; hist is the
// (W, G, B, 3) f64 output, zeroed by the caller.  pack / gbp describe a
// one-hot row.
struct In {
  const uint8_t* rows;
  int64_t row_bytes;
  const float* w;
  int64_t ws_r, ws_c;
  const int32_t* leaf_in;
  const int32_t* slots;
  double* hist;
  int64_t n;
  int G, B, W, pack, gbp;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int V>
__device__ __forceinline__ void copy_async(uint8_t* dst, const uint8_t* src) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
  } else if constexpr (V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
  } else {
    *dst = __ldg(src);       // rows that allow no wider copy
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Up to N adds of three weights at distinct offsets of ``h``: every load
// is issued before any store, so the load-add-store chains overlap.
template <int N>
__device__ __forceinline__ void add_distinct(double* h, const int (&q)[N],
                                             const bool (&ok)[N],
                                             const double (&a)[N][3]) {
  double v[N][3];
#pragma unroll
  for (int t = 0; t < N; ++t)
    if (ok[t]) {
      v[t][0] = h[q[t]];
      v[t][1] = h[q[t] + 1];
      v[t][2] = h[q[t] + 2];
    }
#pragma unroll
  for (int t = 0; t < N; ++t)
    if (ok[t]) {
      h[q[t]] = v[t][0] + a[t][0];
      h[q[t] + 1] = v[t][1] + a[t][1];
      h[q[t] + 2] = v[t][2] + a[t][2];
    }
}

// kRows staged one-hot rows (row ir[r] of ``tile``; ``ok[r]`` false: no
// row) into one slot's histogram ``h``.  The thread owns the chunks of NM
// mask words M (4 or 16 bytes) at first, first + step, ... of every row,
// so no two threads add to one column.  A set bit (the low bit of its
// pack field) at byte j of plane p is full column p * gbp + j.  A
// position set in one row takes that row's weights, picked by its index;
// one set in several rows (rare) is added once with their summed
// weights.  Up to kPos positions at once.
static_assert(kRows == 8, "a row index is three bits");

template <typename M>
__device__ __forceinline__ int first_bit(M x) {
  if constexpr (sizeof(M) == 8)
    return __ffsll((long long)x) - 1;
  else
    return __ffs((int)x) - 1;
}

// word k of an NM-word array, k not known at compile time (selects, so
// the array stays in registers)
template <typename M, int NM>
__device__ __forceinline__ M word(const M (&a)[NM], int k) {
  M v = a[0];
#pragma unroll
  for (int i = 1; i < NM; ++i)
    if (k == i) v = a[i];
  return v;
}

template <typename M, int NM>
__device__ __forceinline__ void add_onehot(
    const uint8_t* tile, int rstride, const int (&ir)[kRows],
    const bool (&ok)[kRows], const float (&w)[kRows][3], int64_t row_bytes,
    int first, int step, int gbp, int lg, M fmask, int c0, int c1,
    double* h) {
  static_assert((NM == 2 && sizeof(M) == 8) || (NM == 1 && sizeof(M) == 4),
                "a chunk is one 16-byte or one 4-byte load");
  for (int off = first; off < row_bytes; off += step) {
    M m[kRows][NM];
    // the chunk's positions, those set in several rows, and the rows with
    // bit 0, 1, 2 of their index set (a single row's index, three tests)
    M any[NM], dup[NM], x[3][NM];
#pragma unroll
    for (int k = 0; k < NM; ++k) {
      any[k] = dup[k] = 0;
      x[0][k] = x[1][k] = x[2][k] = 0;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint8_t* src = tile + ir[r] * rstride + off;
      if constexpr (NM * sizeof(M) == 16) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (ok[r]) v = *reinterpret_cast<const uint4*>(src);
        m[r][0] = (v.x | ((uint64_t)v.y << 32)) & fmask;
        m[r][NM - 1] = (v.z | ((uint64_t)v.w << 32)) & fmask;
      } else {
        m[r][0] = ok[r] ? *reinterpret_cast<const uint32_t*>(src) & fmask
                        : (M)0;
      }
#pragma unroll
      for (int k = 0; k < NM; ++k) {
        dup[k] |= any[k] & m[r][k];
        any[k] |= m[r][k];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if ((r >> i) & 1) x[i][k] |= m[r][k];
      }
    }
    for (;;) {
      bool more = false;
#pragma unroll
      for (int k = 0; k < NM; ++k) more |= any[k] != 0;
      if (!more) break;
      int q[kPos];
      bool take[kPos];
      double a[kPos][3];
#pragma unroll
      for (int t = 0; t < kPos; ++t) {
        take[t] = false;
        q[t] = 0;
        a[t][0] = a[t][1] = a[t][2] = 0.0;
        int k = NM;                       // the first word with a position
#pragma unroll
        for (int i = NM - 1; i >= 0; --i)
          if (any[i]) k = i;
        if (k == NM) continue;
        const int b = first_bit(word(any, k));
#pragma unroll
        for (int i = 0; i < NM; ++i)
          if (i == k) any[i] &= any[i] - 1;
        const int j = off + k * (int)sizeof(M) + (b >> 3);
        const int c = ((b & 7) >> lg) * gbp + j;
        take[t] = j < gbp && c >= c0 && c < c1;
        q[t] = take[t] ? (c - c0) * 3 : 0;
        if ((word(dup, k) >> b) & 1u) {
          // set in several rows (rare): their weights summed
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if ((word(m[r], k) >> b) & 1u) {
              a[t][0] += (double)w[r][0];
              a[t][1] += (double)w[r][1];
              a[t][2] += (double)w[r][2];
            }
        } else {
          // one row: its weights by a select on its index
          const bool i0 = (word(x[0], k) >> b) & 1u;
          const bool i1 = (word(x[1], k) >> b) & 1u;
          const bool i2 = (word(x[2], k) >> b) & 1u;
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const float s01 = i0 ? w[1][e] : w[0][e];
            const float s23 = i0 ? w[3][e] : w[2][e];
            const float s45 = i0 ? w[5][e] : w[4][e];
            const float s67 = i0 ? w[7][e] : w[6][e];
            const float s03 = i1 ? s23 : s01;
            const float s47 = i1 ? s67 : s45;
            a[t][e] = (double)(i2 ? s47 : s03);
          }
        }
      }
      add_distinct(h, q, take, a);
    }
  }
}

// kRows staged rows of bins: lane g adds at group g0 + g (g < gc); bins
// >= B match nothing; rows with equal bins are added once with their
// summed weights.
__device__ __forceinline__ void add_bins_rows(
    const uint8_t* tile, int rstride, const int (&ir)[kRows],
    const bool (&ok)[kRows], const float (&w)[kRows][3], int lane, int g0,
    int gcz, int B, double* h) {
  for (int g = lane; g < gcz; g += 32) {
    int bin[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      bin[r] = ok[r] ? tile[ir[r] * rstride + g0 + g] : B;
    int q[kRows];
    bool take[kRows];
    double a[kRows][3];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      bool first = bin[t] < B;
#pragma unroll
      for (int r = 0; r < t; ++r) first = first && bin[r] != bin[t];
      take[t] = first;
      q[t] = first ? (g * B + bin[t]) * 3 : 0;
      a[t][0] = a[t][1] = a[t][2] = 0.0;
#pragma unroll
      for (int r = t; r < kRows; ++r)
        if (bin[r] == bin[t]) {
          a[t][0] += (double)w[r][0];
          a[t][1] += (double)w[r][1];
          a[t][2] += (double)w[r][2];
        }
    }
    add_distinct(h, q, take, a);
  }
}

// The slot chunk this CTA serves, its index among the chunk's CTAs and
// their number (chunk -1: no chunk is left for it).  ``scratch`` is the
// list's space (list_rows >= kMaxSampledChunks + kSample + 3 words).
// ops/histogram.py chunk_ctas is the same rule in Python.
__device__ __forceinline__ void pick_chunk(const In& in, const Plan& p,
                                           uint32_t* scratch, int* chunk,
                                           int* idx, int* ctas) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nch = p.chunks;
  const int T = gridDim.x;
  int* s_hits = reinterpret_cast<int*>(scratch);
  int* s_leaf = s_hits + kMaxSampledChunks;
  int* s_pick = s_leaf + kSample;
  const bool sampled = p.shared && nch > 1 && nch <= kMaxSampledChunks;
  if (sampled) {
    for (int i = tid; i < nch; i += nthr) s_hits[i] = 0;
    for (int i = tid; i < kSample; i += nthr)
      s_leaf[i] = __ldg(in.leaf_in + (int64_t)i * in.n / kSample);
    __syncthreads();
    // a thread a slot: its sampled rows (every thread reads the same
    // sample word at once, a broadcast)
    const int4* s4 = reinterpret_cast<const int4*>(s_leaf);
    for (int s = tid; s < in.W; s += nthr) {
      const int sl = in.slots[s];
      if (sl < 0) continue;
      int c = 0;
      for (int i = 0; i < kSample / 4; ++i) {
        const int4 v = s4[i];
        c += (v.x == sl) + (v.y == sl) + (v.z == sl) + (v.w == sl);
      }
      if (c) atomicAdd(&s_hits[s / p.S], c);
    }
    __syncthreads();
  }
  if (warp == 0) {
    // chunk c takes 1 + spare * cost_c / total CTAs (sum <= T)
    auto cost = [&](int c) -> int64_t {
      return sampled ? (int64_t)s_hits[c] * p.rstride + 4 * kSample : 1;
    };
    int64_t total = 0;
    for (int c = lane; c < nch; c += 32) total += cost(c);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      total += __shfl_xor_sync(kFull, total, d);
    const int64_t spare = T - nch;          // >= 0: the plan's T >= chunks
    int before = 0, mine = -1, at = 0, k_mine = 0;
    for (int c0 = 0; c0 < nch && mine < 0; c0 += 32) {
      const int c = c0 + lane;
      const int k = c < nch ? 1 + (int)(spare * cost(c) / total) : 0;
      int incl = k;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      const int bx = (int)blockIdx.x - before;
      const unsigned hit = __ballot_sync(kFull, k > 0 && bx < incl &&
                                                    bx >= incl - k);
      if (hit) {
        const int l = __ffs(hit) - 1;
        mine = c0 + l;
        at = __shfl_sync(kFull, bx - (incl - k), l);
        k_mine = __shfl_sync(kFull, k, l);
      }
      before += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) {
      s_pick[0] = mine;
      s_pick[1] = at;
      s_pick[2] = k_mine;
    }
  }
  __syncthreads();
  *chunk = s_pick[0];
  *idx = s_pick[1];
  *ctas = s_pick[2];
}

template <bool ONEHOT, int V>
__global__ void __launch_bounds__(256) hist_f64_kernel(In in, Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  double* s_hist = reinterpret_cast<double*>(smem);
  uint8_t* s_ring = smem + p.off_stage;
  uint32_t* s_rows = reinterpret_cast<uint32_t*>(smem + p.off_list);
  uint16_t* s_mask = reinterpret_cast<uint16_t*>(s_rows + p.list_rows);
  int* s_cnt = reinterpret_cast<int*>(smem + p.off_count);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  int chunk, xi, nx_ctas;
  pick_chunk(in, p, s_rows, &chunk, &xi, &nx_ctas);
  if (chunk < 0) return;                // the whole CTA: no chunk left
  const int y0 = chunk * p.S;
  const int ns = max(0, min(p.S, in.W - y0));
  const int g0 = blockIdx.z * p.gc, gcz = min(p.gc, in.G - g0);
  const int unit_len = gcz * in.B * 3;
  for (int i = tid; i < p.S * p.C * unit_len; i += nthr) s_hist[i] = 0.0;
  // the chunk's slots (a negative slot matches nothing: leaves of live
  // rows are >= 0)
  int sl[kMaxSlots];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) sl[s] = s < ns ? in.slots[y0 + s] : -1;
  if (tid == 0) *s_cnt = 0;
  const int my_s = warp % p.S, my_c = warp / p.S;
  double* h = s_hist + warp * unit_len;
  // the chunk's CTAs split the rows into equal ranges of whole warps
  const int64_t per = ((in.n + nx_ctas - 1) / nx_ctas + 31) & ~(int64_t)31;
  const int64_t r_begin = min(in.n, (int64_t)xi * per);
  const int64_t r_end = min(in.n, r_begin + per);
  const int cpr = (int)(in.row_bytes / V);          // payload copies a row
  const int wofs = (int)((in.row_bytes + 15) & ~(int64_t)15);
  const int lg = in.pack == 1 ? 3 : in.pack == 2 ? 2 : 1;   // log2(8/pack)
  const uint32_t fmask = in.pack == 1   ? 0x01010101u
                         : in.pack == 2 ? 0x11111111u
                                        : 0x55555555u;
  const uint64_t fmask2 = fmask | ((uint64_t)fmask << 32);
  const int c0 = g0 * in.B, c1 = c0 + gcz * in.B;
  const int batch = kScanBatch * nthr;
  __syncthreads();
  int lf[kScanBatch];                   // this batch's leaf ids
#pragma unroll
  for (int k = 0; k < kScanBatch; ++k) {
    const int64_t row = r_begin + tid * kScanBatch + k;
    lf[k] = row < r_end ? __ldg(in.leaf_in + row) : -1;
  }
  for (int64_t base = r_begin; base < r_end; base += batch) {
    // ---- 1. scan a batch: match the chunk's slots, list; the next
    // batch's leaf ids are loaded meanwhile
    int nx[kScanBatch];
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      const int64_t row = base + batch + tid * kScanBatch + k;
      nx[k] = row < r_end ? __ldg(in.leaf_in + row) : -1;
    }
    uint32_t m[kScanBatch];
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      m[k] = 0;
#pragma unroll
      for (int s = 0; s < kMaxSlots; ++s)
        m[k] |= (uint32_t)(lf[k] >= 0 && sl[s] == lf[k]) << s;
      mine += m[k] != 0;
    }
    int incl = mine;                    // warp inclusive scan of the counts
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    int pos = 0;
    if (lane == 31 && incl) pos = atomicAdd(s_cnt, incl);
    pos = __shfl_sync(kFull, pos, 31) + incl - mine;
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k)
      if (m[k]) {
        s_rows[pos] = (uint32_t)(tid * kScanBatch + k + (base - r_begin));
        s_mask[pos] = (uint16_t)m[k];
        ++pos;
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) lf[k] = nx[k];
    const int cnt = *s_cnt;
    // every thread has read the count before the next batch adds to it
    __syncthreads();
    if (cnt + batch <= p.list_rows && base + batch < r_end) continue;
    // ---- 2. stream the listed rows through the ring, 3. add them
    const int ntiles = (cnt + p.stage_rows - 1) / p.stage_rows;
    auto issue = [&](int t) {
      if (t >= ntiles) return;
      uint8_t* dst = s_ring + (t % 3) * p.stage_rows * p.rstride;
      const int i0 = t * p.stage_rows;
      const int nr = min(p.stage_rows, cnt - i0);
      const int per = cpr + 3;
      for (int q = tid; q < nr * per; q += nthr) {
        const int i = q / per, c = q - i * per;
        const int64_t row = r_begin + s_rows[i0 + i];
        uint8_t* d = dst + i * p.rstride;
        if (c < cpr)
          copy_async<V>(d + c * V, in.rows + row * in.row_bytes + c * V);
        else
          copy_async<4>(d + wofs + 4 * (c - cpr),
                        reinterpret_cast<const uint8_t*>(
                            in.w + row * in.ws_r + (c - cpr) * in.ws_c));
      }
    };
    issue(0);
    cp_commit();
    issue(1);
    cp_commit();
    for (int t = 0; t < ntiles; ++t) {
      cp_wait<1>();
      __syncthreads();        // tile t landed; tile t - 1 fully added
      issue(t + 2);
      cp_commit();
      const uint8_t* tile = s_ring + (t % 3) * p.stage_rows * p.rstride;
      const int i0 = t * p.stage_rows;
      const int nr = min(p.stage_rows, cnt - i0);
      if (ONEHOT && p.cols) {
        // one slot a CTA: every thread adds every row of the tile, in its
        // own columns, to the histogram of each slot the row matches
        for (int i = 0; i < nr; i += kRows) {
          int ir[kRows];
          bool ok[kRows];
          uint32_t mk[kRows];
          float w[kRows][3];
          uint32_t in_any = 0;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            ir[r] = i + r < nr ? i + r : 0;
            mk[r] = i + r < nr ? s_mask[i0 + i + r] : 0u;
            in_any |= mk[r];
            const float4 v = *reinterpret_cast<const float4*>(
                tile + ir[r] * p.rstride + wofs);
            w[r][0] = bf16_round(v.x);
            w[r][1] = bf16_round(v.y);
            w[r][2] = bf16_round(v.z);
          }
          for (int s = 0; s < ns; ++s) {
            if (!((in_any >> s) & 1u)) continue;
#pragma unroll
            for (int r = 0; r < kRows; ++r) ok[r] = (mk[r] >> s) & 1u;
            add_onehot<uint32_t, 1>(tile, p.rstride, ir, ok, w,
                                    in.row_bytes, tid * 4, nthr * 4, in.gbp,
                                    lg, fmask, c0, c1, s_hist + s * unit_len);
          }
        }
        continue;
      }
      if (my_s >= ns) continue;
      // one warp a private histogram: the tile's rows this warp adds (its
      // slot's, every C-th), picked with one ballot
      unsigned mine_rows = __ballot_sync(
          kFull, lane < nr && lane % p.C == my_c &&
                     ((s_mask[i0 + (lane < nr ? lane : 0)] >> my_s) & 1u));
      while (mine_rows) {
        int ir[kRows];
        bool ok[kRows];
        float w[kRows][3];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          ok[r] = mine_rows != 0;
          ir[r] = ok[r] ? __ffs(mine_rows) - 1 : 0;
          mine_rows &= mine_rows - 1;
          const float4 v =
              *reinterpret_cast<const float4*>(tile + ir[r] * p.rstride + wofs);
          w[r][0] = ok[r] ? bf16_round(v.x) : 0.f;
          w[r][1] = ok[r] ? bf16_round(v.y) : 0.f;
          w[r][2] = ok[r] ? bf16_round(v.z) : 0.f;
        }
        if constexpr (ONEHOT)
          add_onehot<uint64_t, 2>(tile, p.rstride, ir, ok, w, in.row_bytes,
                                  lane * 16, 512, in.gbp, lg, fmask2, c0, c1,
                                  h);
        else
          add_bins_rows(tile, p.rstride, ir, ok, w, lane, g0, gcz, in.B, h);
      }
    }
    cp_wait<0>();
    __syncthreads();          // the ring and the list are free again
    if (tid == 0) *s_cnt = 0;
    __syncthreads();
  }
  // ---- flush: the C copies summed, one global f64 add per nonzero bin
  const int len = ns * unit_len;
  const int rot = len ? (int)(((int64_t)xi * len / nx_ctas) & ~31) : 0;
  for (int i = tid; i < len; i += nthr) {
    int ii = i + rot;
    if (ii >= len) ii -= len;
    const int sl = ii / unit_len, j = ii - sl * unit_len;
    double v = 0.0;
    for (int c = 0; c < p.C; ++c) v += s_hist[(c * p.S + sl) * unit_len + j];
    if (v != 0.0)
      atomicAdd(in.hist + ((int64_t)(y0 + sl) * in.G + g0) * in.B * 3 + j,
                v);
  }
}

// Set the kernel's shared-memory limit, launch it, and return the first
// CUDA error (0 when the launch was taken).
template <bool ONEHOT, int V>
int launch(const In& in, const int64_t* plan, cudaStream_t stream) {
  if (in.n <= 0) return 0;
  const Plan p(plan);
  cudaError_t e = cudaFuncSetAttribute(
      hist_f64_kernel<ONEHOT, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  hist_f64_kernel<ONEHOT, V>
      <<<dim3((unsigned)p.grid_x, (unsigned)p.grid_y, (unsigned)p.grid_z),
         (unsigned)p.threads, (size_t)p.smem, stream>>>(in, p);
  return (int)cudaGetLastError();
}

}  // namespace ltt_f64
