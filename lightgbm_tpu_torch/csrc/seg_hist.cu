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
// 28 groups, 12 us at 3.35 TB/s).  Kernels A, G and I add every row into
// the histogram with global atomics, and on a tree's first round all
// rows land on one slot's 5,292 addresses: ~1.9 ms, 150x their bound.
// Here all rows of a block share one slot, so the block's histogram is
// privatized in shared memory (G*B*3 int32: 21 KB at 28 x 63) and
// flushed to device memory once, with one global atomic per nonzero
// bin: the global atomics fall from 3*G per row to at most 3*G*B per
// flush.
//
// Design: a CTA walks a run of `blocks_per_cta` consecutive partition
// blocks (consecutive blocks mostly share a slot, so it flushes only when
// the slot changes and at the end); a dead block costs one load of
// blk_slot and no stream.  Groups are split over gridDim.y so that a
// CTA's shared histogram stays within 48 KB whatever B is.  Threads
// stride over the block's rows; a row with zero weights (the gap rows
// apply_partition zeroes) adds nothing and is skipped; a bin >= B
// matches nothing, as the TPU's per-tile iota compare does.
//
// Why the result does not depend on the order: shared and global int32
// atomic additions wrap modulo 2^32, which is associative and
// commutative, and below QUANT_ROW_LIMIT rows no sum wraps, so every
// schedule gives the exact int32 sums the TPU's accumulator holds.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ void flush(int32_t* s_hist, int32_t* out, int len,
                                      int tid, int nthreads) {
  __syncthreads();
  for (int i = tid; i < len; i += nthreads) {
    const int32_t v = s_hist[i];
    if (v) {
      atomicAdd(out + i, v);
      s_hist[i] = 0;
    }
  }
  __syncthreads();
}

__global__ void seg_hist_kernel(const uint8_t* __restrict__ binsT,
                                const int32_t* __restrict__ wT,
                                const int32_t* __restrict__ blk_slot,
                                int32_t* __restrict__ hist, int64_t n_cap,
                                int G, int B, int num_out, int block,
                                int nblk, int blocks_per_cta,
                                int groups_per_cta) {
  extern __shared__ int32_t s_hist[];
  const int g0 = blockIdx.y * groups_per_cta;
  const int gc = min(groups_per_cta, G - g0);
  const int len = gc * B * 3;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int i = tid; i < len; i += nthreads) s_hist[i] = 0;
  const int b_begin = blockIdx.x * blocks_per_cta;
  const int b_end = min(b_begin + blocks_per_cta, nblk);
  // the slot whose rows the shared histogram holds (-1: none yet)
  int cur = -1;
  for (int b = b_begin; b < b_end; ++b) {
    int slot = blk_slot[b];
    if (slot >= num_out) slot = -1;
    if (slot < 0) continue;
    if (slot != cur) {
      if (cur >= 0)
        flush(s_hist, hist + ((int64_t)cur * G + g0) * B * 3, len, tid,
              nthreads);
      cur = slot;
    }
    __syncthreads();  // zeroing (or the last flush) done before the adds
    const int64_t r0 = (int64_t)b * block;
    for (int r = tid; r < block; r += nthreads) {
      const int64_t row = r0 + r;
      const int32_t w0 = wT[row], w1 = wT[n_cap + row],
                    w2 = wT[2 * n_cap + row];
      if ((w0 | w1 | w2) == 0) continue;
      for (int g = 0; g < gc; ++g) {
        const int bin = binsT[(int64_t)(g0 + g) * n_cap + row];
        if (bin >= B) continue;
        int32_t* p = s_hist + (g * B + bin) * 3;
        if (w0) atomicAdd(p, w0);
        if (w1) atomicAdd(p + 1, w1);
        if (w2) atomicAdd(p + 2, w2);
      }
    }
  }
  if (cur >= 0)
    flush(s_hist, hist + ((int64_t)cur * G + g0) * B * 3, len, tid,
          nthreads);
}

}  // namespace

// Kernel J.  binsT (G, n_cap) uint8 and wT (3, n_cap) int32 in
// partitioned order, blk_slot (n_cap / block,) int32 -> hist
// (num_out, G, B, 3) int32 (zeroed by the caller, accumulated here).  A
// block whose slot is negative or >= num_out adds nothing.  Returns the
// launch's cudaGetLastError().
extern "C" int ltt_seg_hist(const void* binsT, const void* wT,
                            const void* blk_slot, void* hist, int64_t n_cap,
                            int G, int B, int num_out, int block,
                            int blocks_per_cta, void* stream) {
  if (n_cap <= 0 || num_out <= 0 || G <= 0) return 0;
  const int nblk = (int)(n_cap / block);
  // the shared histogram within 48 KB: G split over gridDim.y
  const int max_groups = (48 * 1024) / (B * 3 * (int)sizeof(int32_t));
  if (max_groups < 1) return (int)cudaErrorInvalidValue;
  const int groups_per_cta = G < max_groups ? G : max_groups;
  const dim3 grid((nblk + blocks_per_cta - 1) / blocks_per_cta,
                  (G + groups_per_cta - 1) / groups_per_cta);
  const int threads = 256;
  const size_t smem = (size_t)groups_per_cta * B * 3 * sizeof(int32_t);
  seg_hist_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)binsT, (const int32_t*)wT, (const int32_t*)blk_slot,
      (int32_t*)hist, n_cap, G, B, num_out, block, nblk, blocks_per_cta,
      groups_per_cta);
  return (int)cudaGetLastError();
}
