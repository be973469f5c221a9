// Kernel J: the int8 histogram of leaf-partitioned rows.
//
// Replaces the Pallas kernel _hist_kernel_body_seg_tiled
// (lightgbm_tpu/ops/histogram.py:1520, entry point
// compute_group_histograms_seg_tiled :1565).  The rows arrive grouped by
// leaf (ops/partition.py build_leaf_partition, apply_partition): every
// block of `block` partitioned rows belongs to one leaf, and blk_slot
// maps the block to its output slot (-1: an alignment gap, a leaf not in
// this pass, the capacity tail).  The TPU body drops the leaf one-hot
// and dots the raw (8, C) weight strip with the rebuilt bin one-hot; a
// dead block skips its compute but still pays its DMA.
//
// What bounds it on an H100: the stream is 4 bytes of blk_slot per
// block plus G + 12 bytes per row of a live block (~40 MB at 1M rows x
// 28 groups, 12 us at 3.35 TB/s); the adds (3 a group of a landed row,
// into shared memory) come next.
//
// Design: a plan launch, then the histogram, with a zero fill of the
// output before them.
//  1. The plan (one CTA): the live blocks listed slot by slot (`order`;
//     slot s holds positions boff[s] .. boff[s + 1] - 1).  Built on the
//     device from blk_slot, with no read back to the host; it makes no
//     assumption about where a slot's blocks lie.  The offsets do not
//     depend on the schedule; the order of a slot's blocks in its list
//     does (warp-aggregated shared atomics), which changes no sum.
//  2. The histogram: the live rows in list order, as `items` of V rows
//     (V consecutive rows of a block: 4 where the plan says so, else 1),
//     are split evenly over the grid's `ctas` CTAs: CTA c takes items
//     c * items / ctas .. (c + 1) * items / ctas - 1, however the slots
//     are sized.  Its share meets one or more slots (consecutive in the
//     list): it keeps up to `slots_per_cta` private (gc, B, 3) int32
//     histograms of group chunk y (gridDim.y) in shared memory at once
//     (21 KB a slot at 28 x 63: 5 of them beside the SM's other CTA), a
//     row adding into its slot's, so that a share of few slots passes
//     once, with one barrier at its end, however the slots are sized.
//     Each slot's part of the share (a run) is then added into the
//     output with one device-memory atomicAdd a nonzero word.  A
//     thread's 4 rows load as in csrc/hist_i32.cuh: a group's 4 bins in
//     one word, a channel's 4 weights in one int4; a row whose three
//     weights are zero (the gap rows apply_partition zeroes) loads no
//     bin; a bin >= B matches nothing, as the TPU's iota compare does.
// The CTAs meet at most ctas + num_out runs, so a launch makes at most
// (ctas + num_out) * G * B * 3 global atomics (2.1M at W=126 on the
// bench's shape), where the earlier design made one a nonzero bin of
// each of ~1,040 CTAs.  Storing each run as a copy and summing a slot's
// copies in a third launch (csrc/hist_i32.cuh's choice) measured 5-10%
// slower on an H100, and cutting the flush out altogether saves only
// 0.002-0.003 ms (scripts/torch_seg_flush_ab.py): an atomicAdd whose
// result is unused is, likely, a reduction the SM does not wait for.
// The group split over gridDim.y remains for a one-slot histogram past
// a CTA's shared memory (G * B > 19,370: 76 groups of 255 bins).
//
// Sub-byte bin storage (a nonzero pack spec): binsT_p is the partitioned
// (cols, n_cap) storage (the partition moves whole storage bytes), and
// a row's 4-row group words are widened in registers as in hist_i32.cuh.
//
// Why the result does not depend on the schedule: int32 atomic
// additions, shared and global, wrap modulo 2^32, which is associative
// and commutative, and below QUANT_ROW_LIMIT rows no sum wraps, so
// every schedule gives the exact int32 sums the TPU's accumulator
// holds.

#include <cuda_runtime.h>
#include <cstdint>

#include "hist_i32.cuh"

namespace {

// threads of the plan's one CTA
constexpr int kPlanThreads = 1024;
// threads of a histogram CTA (ops/histogram.py SEG_THREADS): two CTAs
// an SM at 64 registers a thread
constexpr int kThreads = 512;

// The launch plan: ops/histogram.py SegPlan.as_args, in that order
struct Plan {
  int ctas, gc, grid_y, threads, rows_per_thread, slots_per_cta, smem,
      plan_smem;
  explicit Plan(const int64_t* a)
      : ctas((int)a[0]), gc((int)a[1]), grid_y((int)a[2]),
        threads((int)a[3]), rows_per_thread((int)a[4]),
        slots_per_cta((int)a[5]), smem((int)a[6]), plan_smem((int)a[7]) {}
};

// The plan in device memory (int32 arrays, one ``meta`` buffer): rank
// (nblk) the scratch of a block's place in its slot's list, order
// (nblk) the live blocks slot by slot, boff (num_out + 1) each slot's
// first position in order.
struct Meta {
  int32_t* rank;
  int32_t* order;
  int32_t* boff;
  __host__ __device__ Meta(int32_t* meta, int nblk)
      : rank(meta), order(meta + nblk), boff(meta + 2 * nblk) {}
};

// In-place exclusive prefix sum of s[0 .. n) over one CTA (each thread
// a contiguous chunk, then the warps' and the CTA's totals).  The
// caller synchronizes before it.
__device__ void cta_exclusive_scan(int* s, int n) {
  __shared__ int warp_sum[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int per = (n + nt - 1) / nt;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += s[i];
  int inc = own;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int t = lane < (nt >> 5) ? warp_sum[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += v;
    }
    warp_sum[lane] = t;                  // inclusive over the warps
  }
  __syncthreads();
  int run = inc - own + (warp ? warp_sum[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = s[i];
    s[i] = run;
    run += v;
  }
  __syncthreads();
}

// Launch 1, one CTA: order and boff.  Shared: num_out + 1 ints, the
// counts scanned into boff.
__global__ void __launch_bounds__(kPlanThreads, 1)
    seg_plan_kernel(const int32_t* __restrict__ blk_slot, int nblk,
                    int num_out, int32_t* __restrict__ meta) {
  extern __shared__ int s_off[];
  const Meta m(meta, nblk);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  for (int s = tid; s <= num_out; s += nt) s_off[s] = 0;
  __syncthreads();
  // each live block's place in its slot's list: one shared atomic per
  // distinct slot of a warp
  for (int base = 0; base < nblk; base += nt) {
    const int b = base + tid;
    int k = b < nblk ? blk_slot[b] : -1;
    if (k >= num_out) k = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    if (k >= 0) {
      const int leader = __ffs(peers) - 1;
      int first = 0;
      if (lane == leader) first = atomicAdd(&s_off[k], __popc(peers));
      first = __shfl_sync(peers, first, leader);
      m.rank[b] = first + __popc(peers & ((1u << lane) - 1u));
    }
  }
  __syncthreads();
  cta_exclusive_scan(s_off, num_out + 1);
  for (int s = tid; s <= num_out; s += nt) m.boff[s] = s_off[s];
  for (int base = 0; base < nblk; base += nt) {
    const int b = base + tid;
    if (b >= nblk) break;
    const int k = blk_slot[b];
    if (k >= 0 && k < num_out) m.order[s_off[k] + m.rank[b]] = b;
  }
}

// Launch 2.  V rows an item (4: the plan's choice where the pointers
// and the block allow it); in.W is num_out; up to kslots slots'
// histograms in shared memory at once; kPacked: binsT is the sub-byte
// storage of in.P and in.C, widened in registers (csrc/hist_i32.cuh).
template <int V, bool kPacked>
__global__ void __launch_bounds__(kThreads, 2)
    seg_hist_kernel(ltt_i32::In in, const int32_t* __restrict__ blk_slot,
                    const int32_t* __restrict__ meta, int nblk, int block,
                    int gc, int kslots) {
  extern __shared__ __align__(16) int32_t s_hist[];
  const Meta m(const_cast<int32_t*>(meta), nblk);
  const int per_blk = block / V;
  const int64_t items = (int64_t)__ldg(m.boff + in.W) * per_blk;
  const int c = blockIdx.x, ctas = gridDim.x;
  const int lo = (int)(c * items / ctas);
  const int hi = (int)((c + 1) * items / ctas);
  if (lo >= hi) return;                   // no share (few live items)
  const int B = in.B, G = in.G;
  const int g0 = blockIdx.y * gc;
  const int gcn = min(gc, G - g0);
  const int slot_words = gcn * B * 3;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int s_last = __ldg(blk_slot + __ldg(m.order + (hi - 1) / per_blk));
  for (int x = lo; x < hi;) {
    // slots [sc, se) of the share at once, from the slot of item x
    const int sc = __ldg(blk_slot + __ldg(m.order + x / per_blk));
    const int se = min(sc + kslots, s_last + 1);
    const int end = min(hi, __ldg(m.boff + se) * per_blk);
    for (int i = tid; i < (se - sc) * slot_words; i += nt) s_hist[i] = 0;
    __syncthreads();
    for (int i = x + tid; i < end; i += nt) {
      const int q = i / per_blk;
      const int blk = __ldg(m.order + q);
      int32_t* h = s_hist + (__ldg(blk_slot + blk) - sc) * slot_words;
      const int64_t row = (int64_t)blk * block + (i - q * per_blk) * V;
      if constexpr (V == 4) {
        int32_t w[3][4];
        ltt_i32::load_weights4<false>(in, row, w);
        bool live[4], any = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          live[k] = (w[0][k] | w[1][k] | w[2][k]) != 0;
          any |= live[k];
        }
        if (!any) continue;
        for (int gt = 0; gt < gcn; gt += ltt_i32::kGroupTile) {
          uint32_t word[ltt_i32::kGroupTile];
          ltt_i32::load_tile4<false, kPacked>(in, row, g0, gt, gcn, word);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (live[k])
              ltt_i32::add_tile_row(h, k, word, gt, gcn, B, w[0][k],
                                    w[1][k], w[2][k]);
        }
      } else {
        const int32_t w0 = __ldg(in.w + row),
                      w1 = __ldg(in.w + in.n + row),
                      w2 = __ldg(in.w + 2 * in.n + row);
        if ((w0 | w1 | w2) == 0) continue;
        ltt_i32::add_row(h, ltt_i32::row_bins<false, kPacked>(in, row, g0),
                         gcn, B, w0, w1, w2);
      }
    }
    __syncthreads();
    // each slot's run into the output (the group chunk's words are
    // contiguous in the slot's (G, B, 3)); a slot without rows has none
    for (int s = sc; s < se; ++s) {
      if (__ldg(m.boff + s + 1) == __ldg(m.boff + s)) continue;
      const int32_t* src = s_hist + (s - sc) * slot_words;
      int32_t* dst = in.hist + ((int64_t)s * G + g0) * B * 3;
      for (int i = tid; i < slot_words; i += nt)
        if (src[i]) atomicAdd(dst + i, src[i]);
    }
    __syncthreads();
    x = end;
  }
}

template <int V, bool kPacked>
int launch_hist(const ltt_i32::In& in, const int32_t* blk_slot,
                const int32_t* meta, int nblk, const Plan& p, int block,
                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      seg_hist_kernel<V, kPacked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(seg_hist_kernel<V, kPacked>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  seg_hist_kernel<V, kPacked><<<dim3((unsigned)p.ctas, (unsigned)p.grid_y),
                                (unsigned)p.threads, (size_t)p.smem,
                                stream>>>(in, blk_slot, meta, nblk, block,
                                          p.gc, p.slots_per_cta);
  return (int)cudaGetLastError();
}

// The plan's rows an item, byte-wide or (in.P > 0) packed.
template <int V>
int launch_hist_vp(const ltt_i32::In& in, const int32_t* blk_slot,
                   const int32_t* meta, int nblk, const Plan& p, int block,
                   cudaStream_t stream) {
  return in.P > 0
             ? launch_hist<V, true>(in, blk_slot, meta, nblk, p, block,
                                    stream)
             : launch_hist<V, false>(in, blk_slot, meta, nblk, p, block,
                                     stream);
}

}  // namespace

// Kernel J.  binsT (G, n_cap) uint8 (spec != 0: the (cols, n_cap)
// sub-byte storage of G logical groups, spec = P | C << 16, packing.py
// pack_spec) and wT (3, n_cap) int32 in partitioned order, blk_slot
// (n_cap / block,) int32 -> hist
// (num_out, G, B, 3) int32, every word written (zeroed, then the runs
// added).  A block whose slot is negative or >= num_out adds nothing.
// plan: ops/histogram.py SegPlan.as_args; meta: its meta_words int32 of
// plan.  A plan of 4 rows an item on pointers or a block not aligned
// for it is refused (cudaErrorMisalignedAddress).  Returns the first
// nonzero error of the zero fill and the two launches.
extern "C" int ltt_seg_hist(const void* binsT, const void* wT,
                            const void* blk_slot, void* hist, int64_t n_cap,
                            int G, int B, int num_out, int block,
                            const int64_t* plan, void* meta, int spec,
                            void* stream) {
  if (num_out <= 0 || G <= 0) return 0;
  const Plan p(plan);
  const int nblk = (int)(n_cap / block);
  const int V = p.rows_per_thread;
  cudaStream_t s = (cudaStream_t)stream;
  if (V == 4) {
    const bool aligned = n_cap % 4 == 0 && block % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(binsT) % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(wT) % 16 == 0;
    if (!aligned) return (int)cudaErrorMisalignedAddress;
  }
  cudaError_t e =
      cudaMemsetAsync(hist, 0, (size_t)num_out * G * B * 3 * 4, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(seg_plan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           p.plan_smem);
  if (e != cudaSuccess) return (int)e;
  seg_plan_kernel<<<1, kPlanThreads, (size_t)p.plan_smem, s>>>(
      (const int32_t*)blk_slot, nblk, num_out, (int32_t*)meta);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const ltt_i32::In in{(const uint8_t*)binsT, (const int32_t*)wT, nullptr,
                       nullptr, (int32_t*)hist, nullptr, n_cap, G, B,
                       num_out, spec & 0xffff, spec >> 16};
  return V == 4 ? launch_hist_vp<4>(in, (const int32_t*)blk_slot,
                                    (const int32_t*)meta, nblk, p, block, s)
                : launch_hist_vp<1>(in, (const int32_t*)blk_slot,
                                    (const int32_t*)meta, nblk, p, block, s);
}
