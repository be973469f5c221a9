// The int32 shared-memory frontier histogram with int8-quantized
// weights, shared by kernels A (fused_route_hist.cu, after its routing
// launch) and G (the same histogram without routing), which read the
// transposed bins and weights, and kernel I (bins_hist.cu), which reads
// the row-major ones.  Kernel J (seg_hist.cu) takes its transposed
// loads and its adds for a CTA of one slot.
//
// The function: hist (W, G, B, 3) int32, where slot position s holds the
// sums of (w0, w1, w2) of the rows whose leaf id equals slots[s], at
// each (group, bin).  A row is added to EVERY equal slot (a duplicate
// slot gets it twice, as the TPU's slot one-hot does), a negative slot
// or leaf matches nothing, a bin >= B matches nothing, and a row whose
// three weights are zero adds nothing.
//
// Two layouts of the same inputs (the template's kRowMajor):
//  - transposed (A, G): binsT (G, n) uint8, a group's bins of 4
//    consecutive rows in one 32-bit word; wT (3, n) int32, a channel of
//    4 rows in one int4;
//  - row-major (I): bins (n, G) uint8, a row's G bins contiguous (row
//    stride G); w (n, 3) int32, 4 rows' 12 weights in three int4.
// Everything past the loads (the shared histogram, the leaf -> slot
// table, the chains, the far list, the adds, the copies and their sum)
// is one code path for both.
//
// The transposed layout also comes packed (the template's kPacked; A, G
// and J): binsT is then the (cols, n) sub-byte storage of the G logical
// groups (csrc/pack.cuh; In's P and C), and group g's 4-row word is the
// word of storage row byte(g) widened in registers, (word >> shift) &
// (mask * 0x01010101), so that its 4 bytes are the 4 rows' bins as in the
// byte-wide word (the TPU's _bin_row_T, histogram.py:85).  A group chunk
// that starts or ends inside a storage byte reads that byte in both CTAs.
// kPacked false is the byte-wide code as it was.
//
// Layout of the work (the launch plan is Python's: ops/histogram.py
// frontier_hist_plan; the kernel reads it as given).  A CTA of 1024
// threads, one an SM, owns
//  - a group chunk of gc groups (gridDim.y),
//  - a slot chunk of S slots (gridDim.z; one chunk holding every slot
//    unless one group of all W slots overflows the CTA's shared memory,
//    e.g. 126 slots of 255 bins), and
//  - every gridDim.x-th stride of the rows.
// Its shared memory holds the private (S, gc, B, 3) int32 histogram of
// its chunks, the S slot values, a leaf -> slot-position table (the
// plan's ``table`` leaf ids, each the head of a chain of the positions
// holding that leaf) with the chains' links, and the positions of slots
// whose value the table cannot hold (rows with such a leaf scan that
// list).  Every CTA of a group chunk sees every landed row of its rows,
// however the rows fall over the slots, so a skewed frontier costs no
// balance.
//
// A thread takes 4 consecutive rows at a time where the plan says so
// (rows_per_thread: N % 4 == 0 and the pointers aligned for it; else
// 1): their leaf ids as one int4, the table's chains (no scan of the W
// slots), and if any landed, their weights as three int4 and their bins
// a tile of 8 groups at a time as 8 32-bit words, byte k of word j row
// k's bin of group j.  Transposed, word j is one load; row-major, each
// row's 8 bins are cut from the (at most 3) aligned words that cover
// them with funnel shifts and the 4 x 8 bytes transposed with byte
// permutes into the same 8 words.  Then one shared atomicAdd(int*) a
// nonzero weight, group and slot position: on sm_90a a native ATOMS.ADD,
// not a compare-and-swap loop (scripts/torch_sass_atomics.py).
//
// At the end each CTA stores its histogram with plain stores as copy
// blockIdx.x of a (grid_x, W, G, B, 3) scratch, and a second launch sums
// the grid_x copies of every word into hist.  Global atomics would cost
// more: the H100 adds ~58 G device-memory atomics a second, so a
// 126-slot launch whose CTAs flush 9 copies of its 2.7 MB histogram with
// atomics spent ~0.1 ms on them.
//
// Why the result does not depend on the schedule: shared int32 atomic
// additions and the copies' sum wrap modulo 2^32, which is associative
// and commutative, and with at most QUANT_ROW_LIMIT rows (rows * 127 <
// 2^31) no sum wraps, so every schedule leaves the exact int32 sums the
// TPU's accumulator holds.  The chains are built with atomicExch, so
// their order changes from launch to launch; a row is added once per
// position in its chain whatever the order.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "pack.cuh"

namespace ltt_i32 {

// bin bytes a thread loads before its adds
constexpr int kGroupTile = 8;
// the most threads of a CTA (ops/histogram.py I32_THREADS): one CTA an
// SM, 64 registers a thread
constexpr int kThreads = 1024;

// The launch plan: ops/histogram.py I32Plan.as_args, in that order
struct Plan {
  int S, gc, table, grid_x, grid_y, grid_z, threads, rows_per_thread;
  int off_slots, off_next, off_far, off_head, off_nfar, smem;
  explicit Plan(const int64_t* a)
      : S((int)a[0]), gc((int)a[1]), table((int)a[2]), grid_x((int)a[3]),
        grid_y((int)a[4]), grid_z((int)a[5]), threads((int)a[6]),
        rows_per_thread((int)a[7]), off_slots((int)a[8]),
        off_next((int)a[9]), off_far((int)a[10]), off_head((int)a[11]),
        off_nfar((int)a[12]), smem((int)a[13]) {}
};

// What a launch reads and writes: bins uint8 and w int32 in the
// launch's layout (transposed: (G, n) and (3, n); row-major: (n, G) and
// (n, 3)), leaf (n,) int32, slots (W,) int32 -> hist (W, G, B, 3) int32,
// every word written; part is the (grid_x, W, G, B, 3) int32 scratch of
// the CTAs' copies, every word written before it is read.  P and C: the
// pack spec of transposed bins stored sub-byte ((cols, n), P > 0), else
// 0.
struct In {
  const uint8_t* bins;
  const int32_t* w;
  const int32_t* leaf;
  const int32_t* slots;
  int32_t* hist;
  int32_t* part;
  int64_t n;
  int G, B, W;
  int P, C;
};

// Where row ``row``'s bin of group ``g`` is, and the bytes from one
// group to the next of a row.
template <bool kRowMajor>
__device__ __forceinline__ const uint8_t* bin_at(const In& in, int64_t row,
                                                 int g) {
  return kRowMajor ? in.bins + row * in.G + g
                   : in.bins + (int64_t)g * in.n + row;
}
template <bool kRowMajor>
__device__ __forceinline__ int64_t group_stride(const In& in) {
  return kRowMajor ? 1 : in.n;
}

// One row's bins of a group chunk from g0: at(k) is group g0 + k's bin.
// Byte-wide (either layout): a group every ``gs`` bytes from ``b``.
// Packed (transposed): storage row byte(g0 + k) from ``b`` (the row's
// byte of storage row 0), widened.
template <bool kPacked>
struct RowBins;
template <>
struct RowBins<false> {
  const uint8_t* b;
  int64_t gs;
  __device__ __forceinline__ int at(int k) const {
    return (int)__ldg(b + (int64_t)k * gs);
  }
};
template <>
struct RowBins<true> {
  const uint8_t* b;
  int64_t n;
  int g0, P, C;
  __device__ __forceinline__ int at(int k) const {
    const LttPackSel s = ltt_pack_select(g0 + k, P, C);
    return ((int)__ldg(b + (int64_t)s.byte * n) >> s.shift) & s.mask;
  }
};
template <bool kRowMajor, bool kPacked>
__device__ __forceinline__ RowBins<kPacked> row_bins(const In& in,
                                                     int64_t row, int g0) {
  if constexpr (kPacked)
    return {in.bins + row, in.n, g0, in.P, in.C};
  else
    return {bin_at<kRowMajor>(in, row, g0), group_stride<kRowMajor>(in)};
}

// Add one row's weights at its gcn bins (``rb``) into the (gcn, B, 3)
// histogram at ``h``.
template <class R>
__device__ __forceinline__ void add_row(int32_t* h, const R& rb, int gcn,
                                        int B, int32_t w0, int32_t w1,
                                        int32_t w2) {
  for (int gt = 0; gt < gcn; gt += kGroupTile) {
    int bin[kGroupTile];
#pragma unroll
    for (int k = 0; k < kGroupTile; ++k)
      bin[k] = gt + k < gcn ? rb.at(gt + k) : B;
#pragma unroll
    for (int k = 0; k < kGroupTile; ++k) {
      if (bin[k] >= B) continue;
      int32_t* c = h + ((gt + k) * B + bin[k]) * 3;
      if (w0) atomicAdd(c, w0);
      if (w1) atomicAdd(c + 1, w1);
      if (w2) atomicAdd(c + 2, w2);
    }
  }
}

// Add a row with leaf id ``leaf`` at every one of its slot positions:
// the table's chain from ``q``, or (a leaf past the table) the scan of
// the far list.
template <class R>
__device__ __forceinline__ void add_at_slots(
    int32_t* s_hist, const int32_t* s_slot, const int32_t* s_next,
    const int32_t* s_far, int nfar, int leaf, int q, bool far,
    int slot_words, const R& rb, int gcn, int B, int32_t w0, int32_t w1,
    int32_t w2) {
  if (far) {
    for (int f = 0; f < nfar; ++f) {
      const int qf = s_far[f];
      if (s_slot[qf] == leaf)
        add_row(s_hist + qf * slot_words, rb, gcn, B, w0, w1, w2);
    }
  } else {
    for (; q >= 0; q = s_next[q])
      add_row(s_hist + q * slot_words, rb, gcn, B, w0, w1, w2);
  }
}

// A CTA's slot chunk in shared memory: its private histogram (a slot
// position every ``slot_words`` words), slot values, chains, far list
// and leaf -> first position table.
struct Slots {
  int32_t* hist;
  const int32_t* slot;
  const int32_t* next;
  const int32_t* far;
  const int32_t* head;
  int nfar, table, slot_words;
};

// A row whose leaf id is past the table: every far slot equal to it.
// Rare, so kept out of line (its registers stay out of the row loops).
template <class R>
__device__ __noinline__ void add_far_row(const Slots& sl, int leaf,
                                         const R rb, int gcn, int B,
                                         int32_t w0, int32_t w1,
                                         int32_t w2) {
  add_at_slots(sl.hist, sl.slot, sl.next, sl.far, sl.nfar, leaf, -1, true,
               sl.slot_words, rb, gcn, B, w0, w1, w2);
}

// One row a thread (any n, any alignment): the thread's rows are tid +
// k * stride of the CTA's rows.
template <bool kRowMajor, bool kPacked>
__device__ __forceinline__ void add_rows1(const In& in, const Slots& sl,
                                          int g0, int gcn) {
  const int64_t n = in.n;
  const int64_t cs = kRowMajor ? 1 : n;       // channel stride of w
  const int64_t rs = kRowMajor ? 3 : 1;       // row stride of w
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += step) {
    const int leaf = __ldg(in.leaf + row);
    if (leaf < 0) continue;
    const bool far = leaf >= sl.table;
    const int q = far ? -1 : sl.head[leaf];
    if (far ? sl.nfar == 0 : q < 0) continue;
    const int32_t* wr = in.w + row * rs;
    const int32_t w0 = __ldg(wr), w1 = __ldg(wr + cs),
                  w2 = __ldg(wr + 2 * cs);
    if ((w0 | w1 | w2) == 0) continue;
    const RowBins<kPacked> rb = row_bins<kRowMajor, kPacked>(in, row, g0);
    if (far)
      add_far_row(sl, leaf, rb, gcn, in.B, w0, w1, w2);
    else
      add_at_slots(sl.hist, sl.slot, sl.next, sl.far, sl.nfar, leaf, q,
                   false, sl.slot_words, rb, gcn, in.B, w0, w1, w2);
  }
}

// The 4 x 4 byte transpose: byte k of col[j] = byte j of row k (rows a,
// b, c, d).
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b,
                                           uint32_t c, uint32_t d,
                                           uint32_t* col) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(c, d, 0x5140);  // c0 d0 c1 d1
  const uint32_t t2 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t t3 = __byte_perm(c, d, 0x7362);  // c2 d2 c3 d3
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// The bins of groups [g0 + gt, g0 + gt + kGroupTile) of rows r0..r0+3
// (groups past gcn read as anything; the adds skip them) as kGroupTile
// words, byte k of word j row k's bin of group gt + j.  Transposed: one
// word a group (packed: the word of the group's storage row, widened
// with the group's own shift and mask, which may differ from group to
// group of a tile where auto's sections meet).  Row-major (n % 4 == 0
// and bins 4-byte aligned, so the words covering any of its bytes lie
// inside it): a row's cnt bytes from byte offset o lie in the aligned
// words o/4 .. (o + cnt - 1)/4, at most three, cut by funnel shifts, then
// transposed.
template <bool kRowMajor, bool kPacked>
__device__ __forceinline__ void load_tile4(const In& in, int64_t r0, int g0,
                                           int gt, int gcn,
                                           uint32_t* word) {
  if constexpr (kRowMajor) {
    const int cnt = min(kGroupTile, gcn - gt);
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t o = (r0 + k) * in.G + g0 + gt;
      const uint32_t* p =
          reinterpret_cast<const uint32_t*>(in.bins) + (o >> 2);
      const int s = (int)(o & 3);
      const int last = (s + cnt - 1) >> 2;
      const uint32_t a = __ldg(p);
      const uint32_t b = last >= 1 ? __ldg(p + 1) : 0u;
      const uint32_t c = last >= 2 ? __ldg(p + 2) : 0u;
      lo[k] = __funnelshift_r(a, b, 8 * s);
      hi[k] = __funnelshift_r(b, c, 8 * s);
    }
    transpose4(lo[0], lo[1], lo[2], lo[3], word);
    transpose4(hi[0], hi[1], hi[2], hi[3], word + 4);
  } else if constexpr (kPacked) {
#pragma unroll
    for (int j = 0; j < kGroupTile; ++j) {
      word[j] = 0u;
      if (gt + j < gcn) {
        const LttPackSel s = ltt_pack_select(g0 + gt + j, in.P, in.C);
        const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(
            in.bins + (int64_t)s.byte * in.n + r0));
        word[j] = (v >> s.shift) & ((uint32_t)s.mask * 0x01010101u);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroupTile; ++j)
      word[j] = gt + j < gcn ? __ldg(reinterpret_cast<const uint32_t*>(
                                   in.bins + (int64_t)(g0 + gt + j) * in.n +
                                   r0))
                             : 0u;
  }
}

// The weights of rows r0..r0+3: w[c][k] channel c of row k, three int4
// loads in either layout.
template <bool kRowMajor>
__device__ __forceinline__ void load_weights4(const In& in, int64_t r0,
                                              int32_t (*w)[4]) {
  if constexpr (kRowMajor) {
    const int4* p = reinterpret_cast<const int4*>(in.w + r0 * 3);
    const int4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    const int32_t f[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                           b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) w[ch][k] = f[3 * k + ch];
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int4 v =
          __ldg(reinterpret_cast<const int4*>(in.w + ch * in.n + r0));
      w[ch][0] = v.x, w[ch][1] = v.y, w[ch][2] = v.z, w[ch][3] = v.w;
    }
  }
}

// Add the bins of one tile of up to kGroupTile groups (a 32-bit word a
// group: byte k is row k's bin) for row k at slot position q and its
// chain.
__device__ __forceinline__ void add_tile4(const Slots& sl, int q, int k,
                                          const uint32_t* word, int gt,
                                          int gcn, int B, int32_t w0,
                                          int32_t w1, int32_t w2) {
  for (; q >= 0; q = sl.next[q]) {
    int32_t* h = sl.hist + q * sl.slot_words;
#pragma unroll
    for (int j = 0; j < kGroupTile; ++j) {
      const int bin = (int)((word[j] >> (8 * k)) & 0xffu);
      if (gt + j >= gcn || bin >= B) continue;
      int32_t* c = h + ((gt + j) * B + bin) * 3;
      if (w0) atomicAdd(c, w0);
      if (w1) atomicAdd(c + 1, w1);
      if (w2) atomicAdd(c + 2, w2);
    }
  }
}

// Add row k's bins of one tile into the (gcn, B, 3) histogram at ``h``:
// add_tile4's body for one slot (kernel J, whose rows each have one).
// add_tile4 keeps its own copy: calling this from it made A and G
// 1.3-1.9% slower by device time on an H100 in two paired runs
// (scripts/torch_hist_ab.py), where D, whose code is apart, moved
// 0.7-0.9%.
__device__ __forceinline__ void add_tile_row(int32_t* h, int k,
                                             const uint32_t* word, int gt,
                                             int gcn, int B, int32_t w0,
                                             int32_t w1, int32_t w2) {
#pragma unroll
  for (int j = 0; j < kGroupTile; ++j) {
    const int bin = (int)((word[j] >> (8 * k)) & 0xffu);
    if (gt + j >= gcn || bin >= B) continue;
    int32_t* c = h + ((gt + j) * B + bin) * 3;
    if (w0) atomicAdd(c, w0);
    if (w1) atomicAdd(c + 1, w1);
    if (w2) atomicAdd(c + 2, w2);
  }
}

// Four consecutive rows a thread (n % 4 == 0, pointers aligned): a run
// with a landed row loads its three weight int4 and its first tile of
// bin words together.  Rows past the table go one by one through the
// far list.
template <bool kRowMajor, bool kPacked>
__device__ __forceinline__ void add_rows4(const In& in, const Slots& sl,
                                          int g0, int gcn) {
  const int64_t n = in.n;
  const int B = in.B;
  const int64_t step = ((int64_t)gridDim.x * blockDim.x) * 4;
  for (int64_t r0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       r0 < n; r0 += step) {
    const int4 lv = __ldg(reinterpret_cast<const int4*>(in.leaf + r0));
    const int leaf[4] = {lv.x, lv.y, lv.z, lv.w};
    int q[4];
    bool far[4], any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      far[k] = leaf[k] >= sl.table && sl.nfar > 0;
      q[k] = leaf[k] >= 0 && leaf[k] < sl.table ? sl.head[leaf[k]] : -1;
      any |= far[k] || q[k] >= 0;
    }
    if (!any) continue;
    uint32_t word[kGroupTile];
    load_tile4<kRowMajor, kPacked>(in, r0, g0, 0, gcn, word);
    int32_t w[3][4];
    load_weights4<kRowMajor>(in, r0, w);
    int top = -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((w[0][k] | w[1][k] | w[2][k]) == 0) q[k] = -1, far[k] = false;
      if (far[k])
        add_far_row(sl, leaf[k], row_bins<kRowMajor, kPacked>(in, r0 + k, g0),
                    gcn, B, w[0][k], w[1][k], w[2][k]);
      top = max(top, q[k]);
    }
    if (top < 0) continue;
    for (int gt = 0; gt < gcn; gt += kGroupTile) {
      if (gt > 0) load_tile4<kRowMajor, kPacked>(in, r0, g0, gt, gcn, word);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        add_tile4(sl, q[k], k, word, gt, gcn, B, w[0][k], w[1][k],
                  w[2][k]);
    }
  }
}

// V rows a thread at a time in the given layout: add_rows4 (the plan's
// rows_per_thread 4: n % 4 == 0, 16-byte aligned leaf ids and weights,
// 4-byte aligned bins) or add_rows1.
template <int V, bool kRowMajor, bool kPacked>
__global__ void __launch_bounds__(kThreads, 1)
    hist_i32_kernel(In in, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_hist = reinterpret_cast<int32_t*>(smem);
  int32_t* s_slot = reinterpret_cast<int32_t*>(smem + p.off_slots);
  int32_t* s_next = reinterpret_cast<int32_t*>(smem + p.off_next);
  int32_t* s_far = reinterpret_cast<int32_t*>(smem + p.off_far);
  int32_t* s_head = reinterpret_cast<int32_t*>(smem + p.off_head);
  int* s_nfar = reinterpret_cast<int*>(smem + p.off_nfar);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int B = in.B, G = in.G;
  const int g0 = blockIdx.y * p.gc;
  const int gcn = max(0, min(p.gc, G - g0));
  const int s0 = blockIdx.z * p.S;
  const int sn = max(0, min(p.S, in.W - s0));
  const int row3 = B * 3;
  const int len = sn * gcn * row3;
  for (int i = tid; i < len; i += nt) s_hist[i] = 0;
  for (int i = tid; i < p.table; i += nt) s_head[i] = -1;
  if (tid == 0) *s_nfar = 0;
  __syncthreads();
  // the chunk's slots: chains of positions by leaf id, or the far list
  for (int q = tid; q < sn; q += nt) {
    const int v = in.slots[s0 + q];
    s_slot[q] = v;
    if (v >= 0 && v < p.table)
      s_next[q] = atomicExch(&s_head[v], q);
    else if (v >= p.table)
      s_far[atomicAdd(s_nfar, 1)] = q;
  }
  __syncthreads();
  // read once after the barrier; nothing adds to it again
  const int nfar = *s_nfar;
  if (sn > 0 && gcn > 0) {
    const Slots sl{s_hist, s_slot, s_next, s_far, s_head, nfar, p.table,
                   gcn * row3};
    if constexpr (V == 4)
      add_rows4<kRowMajor, kPacked>(in, sl, g0, gcn);
    else
      add_rows1<kRowMajor, kPacked>(in, sl, g0, gcn);
  }
  __syncthreads();
  // store the CTA's copy: a warp per (slot, group) row of 3B words
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  int32_t* copy = in.part + (int64_t)blockIdx.x * in.W * G * row3;
  for (int pg = warp; pg < sn * gcn; pg += nwarps) {
    const int q = pg / gcn, g = pg - q * gcn;
    const int32_t* src = s_hist + pg * row3;
    int32_t* dst = copy + ((int64_t)(s0 + q) * G + g0 + g) * row3;
    for (int r = lane; r < row3; r += 32) dst[r] = src[r];
  }
}

// hist[i] = the sum over the ``copies`` CTA copies of word i (uint32
// arithmetic: the same wrap modulo 2^32 as the int32 adds).  A block of
// (32, 8) threads takes 32 consecutive words; its 8 warps each sum every
// 8th copy, then one warp adds the 8 partial sums.
__global__ void sum_copies_kernel(const int32_t* __restrict__ part,
                                  int32_t* __restrict__ hist, int64_t words,
                                  int copies) {
  __shared__ uint32_t acc[8][32];
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int64_t i = (int64_t)blockIdx.x * 32 + lane;
  uint32_t s = 0;
  if (i < words)
    for (int x = wy; x < copies; x += 8)
      s += (uint32_t)__ldg(part + (int64_t)x * words + i);
  acc[wy][lane] = s;
  __syncthreads();
  if (wy == 0 && i < words) {
    uint32_t t = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += acc[k][lane];
    hist[i] = (int32_t)t;
  }
}

// Launch the histogram on ``stream`` with the plan's geometry (shared
// memory past 48 KB opted in) and rows a thread.  Returns the first
// nonzero cudaGetLastError().
template <int V, bool kRowMajor, bool kPacked>
int launch_v(const In& in, const Plan& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      hist_i32_kernel<V, kRowMajor, kPacked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  // all of the SM's 228 KB as shared memory, so two 105 KB CTAs fit
  e = cudaFuncSetAttribute(hist_i32_kernel<V, kRowMajor, kPacked>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  hist_i32_kernel<V, kRowMajor, kPacked><<<dim3((unsigned)p.grid_x,
                                                (unsigned)p.grid_y,
                                                (unsigned)p.grid_z),
                                           (unsigned)p.threads,
                                           (size_t)p.smem, stream>>>(in, p);
  return (int)cudaGetLastError();
}

// The plan's rows a thread, byte-wide or (transposed, in.P > 0) packed.
template <int V, bool kRowMajor>
int launch_vp(const In& in, const Plan& p, cudaStream_t stream) {
  if constexpr (!kRowMajor) {
    if (in.P > 0) return launch_v<V, false, true>(in, p, stream);
  }
  return launch_v<V, kRowMajor, false>(in, p, stream);
}

// The histogram in the given layout, then the sum of its grid_x copies
// into hist.  A plan of 4 rows a thread on pointers or rows not aligned
// for it is refused (cudaErrorMisalignedAddress): the wrapper's plan
// decides, from the same pointers.  Row-major bins have no packed form
// (kernel I; in.P must be 0).
template <bool kRowMajor>
int launch(const In& in, const int64_t* plan, cudaStream_t stream) {
  const int64_t words = (int64_t)in.W * in.G * in.B * 3;
  if (words == 0) return 0;
  const Plan p(plan);
  if (p.rows_per_thread == 4) {
    const bool aligned = in.n % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(in.leaf) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(in.w) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(in.bins) % 4 == 0;
    if (!aligned) return (int)cudaErrorMisalignedAddress;
  }
  if (kRowMajor && in.P != 0) return (int)cudaErrorInvalidValue;
  const int rc = p.rows_per_thread == 4
                     ? launch_vp<4, kRowMajor>(in, p, stream)
                     : launch_vp<1, kRowMajor>(in, p, stream);
  if (rc != 0) return rc;
  sum_copies_kernel<<<(unsigned)((words + 31) / 32), dim3(32, 8), 0,
                      stream>>>(in.part, in.hist, words, p.grid_x);
  return (int)cudaGetLastError();
}

}  // namespace ltt_i32
