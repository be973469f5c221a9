// Ensemble level descent (kernel C).
//
// Replaces the Pallas kernel inside predict_level_ensemble_pallas
// (lightgbm_tpu/ops/predict.py:326, entry point :301).  Every (row,
// tree) pair walks its tree down to a leaf with the rules of
// _level_step (predict.py:195): the two-float threshold compare of
// _two_float_left (exact f64 `value <= threshold` for f32-representable
// data, with the inf guard), NaN/zero missing-value defaults, and the
// categorical bitset test with the float value truncated to int32.
// Leaf values are summed per class.
//
// Input: the ensemble as node records (ops/predict.py LevelRecords,
// packed once an ensemble): trees in class-major order, one 16-byte
// walk record a node {feat2 << 5 | nan_left << 4 | decision type,
// thr_hi, thr_lo, the two children as 16-bit tree-local codes}, so a
// level is one 16-byte load where the flat tables took six gathers, and
// where a NaN goes is read from the record rather than worked out from
// the missing type.  A row adds each class's trees in tree order from
// 0.0f, so the output depends on neither the tier, the chunk size nor
// the grid; the TPU kernel sums by a matrix product, so the two differ
// in the last bits (held to |d| <= 1e-5 * (1 + |score|)).
//
// What bounds it on an H100: the walk.  Reading each row's (hi, lo)
// pairs once and writing its K scores is ~0.014 ms at 200,000 rows x 28
// features; the walk reads a 16-byte record and an 8-byte (hi, lo) pair
// a node visit, ~16M visits there, dependent one level on the next, at
// some 33 instructions a visit, so it needs many warps in flight.  The
// Pallas kernel keeps the whole ensemble in VMEM for the batch; shared
// memory is Hopper's counterpart but holds 227 KB a CTA, so:
//
// * Shared tier (ltt_predict_level): a CTA walks a tile of rows, one a
//   thread, two trees of one class at a time (two independent walks a
//   thread, one level of each in turn).  It copies a chunk of
//   consecutive trees' walk records, meta and leaf values (and their
//   category words where they fit) into shared memory with cp.async,
//   walks its rows through the chunk, then takes the next chunk; a
//   row's class sum stays in a register within a chunk and passes
//   between chunks through the output, which only its own thread
//   touches.  Where the tile's rows fit beside one tree (features <=
//   ~55) they are staged in shared memory too, in rows of an odd number
//   of (hi, lo) pairs, so a warp reading one feature of its 32 rows
//   meets 32 banks (staged feature-major instead, they measured 5-8%
//   slower on an H100); otherwise each pair is one 8-byte load from
//   device memory.  Where the ensemble fits one chunk beside a 256-row
//   tile in half an SM's shared memory, CTAs of 256 threads run two an
//   SM; otherwise one CTA of 512 threads takes the SM (two rows a
//   thread at 256 threads measured 24-28% slower on an H100).  A
//   one-chunk ensemble is copied once a CTA, and the grid is the CTAs
//   that fit the card at once, striding over the tiles.
// * Global tier (ltt_predict_level_global), for small batches, where
//   copying a chunk costs more than walking it: a warp a row, its lanes
//   walking 32 trees at a time with the records read from device
//   memory (flat child ids past 32,767 nodes a tree); the lanes' values
//   are then added in tree order through shuffles.
//
// Both are specialised on the categorical nodes: with none, the walk
// carries no bitset code; with some, the bitset word's load is
// predicated rather than branched on, so a warp whose rows meet both
// kinds of node does not split.
//
// No atomics: each row's outputs are written by one thread (one warp in
// the global tier), so the result does not depend on the schedule.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// the global tier's CTA: 8 warps, a row each
constexpr int kGlobalThreads = 256;
constexpr int kGlobalRows = kGlobalThreads / 32;

// the record's flag bits (ops/predict.py LevelRecords)
constexpr int kCategorical = 1;
constexpr int kDefaultLeft = 2;
constexpr int kMissingTypeBits = 12;
constexpr int kMissingZero = 4;      // missing type 1, in place
constexpr int kNanLeft = 16;

// where the category words are: none (no categorical node), in shared
// memory, in device memory
constexpr int kNoCats = 0;
constexpr int kSharedCats = 1;
constexpr int kDeviceCats = 2;

struct Records {
  const int4* walk;      // (T*M) walk records, position order
  const int2* links;     // (T*M) flat {left, right} (global tier only)
  const int4* meta;      // (T) {tree, class, local root, starts its class}
  const float* leaves;   // (T*L)
  const int32_t* cats;   // (T*M*W)
  int T, M, L, W, K;
  int leaf0;             // leaves index of flat leaf 0
};

// _level_step's rule for one row at node ``node`` (record ``r``, the
// row's (hi, lo) pair ``v``): true when the row goes left.  ``words``:
// the category words of the node's tree (W a node).
template <bool kCats>
__device__ __forceinline__ bool goes_left(const int4 r, const float2 v,
                                          const int32_t* words, int node,
                                          int W) {
  const float th = __int_as_float(r.y), tl = __int_as_float(r.z);
  const float d = (v.x == th) ? __fsub_rn(v.y, tl)
                              : __fadd_rn(__fsub_rn(v.x, th),
                                          __fsub_rn(v.y, tl));
  const bool zero_default = (r.x & kMissingTypeBits) == kMissingZero &&
                            v.x > -1e-35f && v.x <= 1e-35f;
  bool left = zero_default ? (r.x & kDefaultLeft) != 0 : d <= 0.0f;
  const bool nan_v = isnan(v.x);
  left = nan_v ? (r.x & kNanLeft) != 0 : left;
  if constexpr (kCats) {
    // bit v of the bitset, v the value truncated to int32 (saturating,
    // as XLA's convert; NaN: -1, in no set)
    const int v_int = nan_v ? -1 : __float2int_rz(v.x);
    uint32_t word = 0;
    if ((r.x & kCategorical) && (unsigned)v_int < (unsigned)(W * 32))
      word = (uint32_t)words[node * W + (v_int >> 5)];
    left = (r.x & kCategorical) ? ((word >> (v_int & 31)) & 1u) != 0 : left;
  }
  return left;
}

// The tree-local child code the record's 16-bit halves hold.
__device__ __forceinline__ int child(const int4 r, bool left) {
  return (int)((unsigned)r.w << (left ? 16 : 0)) >> 16;
}

// C independent walks down to their leaves (or ``depth`` levels), one
// level of each in turn so that their loads are in flight together:
// walk c at node ``node[c]`` of the records ``nodes[c]``, its row's
// (hi, lo) pairs at ``x[c]`` (in shared memory where kStaged, else in
// device memory, read through the read-only path).  A settled walk
// re-reads its tree's node 0 and keeps its code.
template <bool kStaged, bool kCats, int C>
__device__ __forceinline__ void descend(int (&node)[C],
                                        const int4* const (&nodes)[C],
                                        const float2* const (&x)[C],
                                        const int32_t* const (&words)[C],
                                        int W, int depth) {
  for (int d = 0; d < depth; ++d) {
    bool live = false;
#pragma unroll
    for (int c = 0; c < C; ++c) live |= node[c] >= 0;
    if (!live) break;
    int4 q[C];
    float2 v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = nodes[c][max(node[c], 0)];
#pragma unroll
    for (int c = 0; c < C; ++c)
      v[c] = kStaged ? x[c][q[c].x >> 6] : __ldg(x[c] + (q[c].x >> 6));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int next = child(
          q[c], goes_left<kCats>(q[c], v[c], words[c], max(node[c], 0), W));
      node[c] = node[c] >= 0 ? next : node[c];
    }
  }
}

// The value a walk adds: its leaf's (slot j's leaf values in shared
// memory), or flat leaf 0's where it did not settle within ``depth``.
__device__ __forceinline__ float leaf_value(const float* s_leaf, int j, int L,
                                            int node, float unsettled) {
  return node < 0 ? s_leaf[j * L - node - 1] : unsettled;
}

// Copy chunk ``c`` (positions p0 .. p0 + np) into shared memory.
template <int kCat>
__device__ __forceinline__ void load_chunk(const Records& e, int p0, int np,
                                           int4* s_walk, int4* s_meta,
                                           float* s_leaf, int32_t* s_cat) {
  const int4* gw = e.walk + (int64_t)p0 * e.M;
  const int step = blockDim.x;
  for (int i = threadIdx.x; i < np * e.M; i += step)
    __pipeline_memcpy_async(s_walk + i, gw + i, sizeof(int4));
  for (int i = threadIdx.x; i < np; i += step)
    __pipeline_memcpy_async(s_meta + i, e.meta + p0 + i, sizeof(int4));
  const float* gl = e.leaves + (int64_t)p0 * e.L;
  for (int i = threadIdx.x; i < np * e.L; i += step)
    __pipeline_memcpy_async(s_leaf + i, gl + i, sizeof(float));
  if constexpr (kCat == kSharedCats) {
    const int32_t* gc = e.cats + (int64_t)p0 * e.M * e.W;
    for (int i = threadIdx.x; i < np * e.M * e.W; i += step)
      __pipeline_memcpy_async(s_cat + i, gc + i, sizeof(int32_t));
  }
  __pipeline_commit();
}

// The shared tier: a row a thread, a tile of kBlock rows a CTA, ``tpc``
// trees a chunk; kStageX: the tile's rows staged in shared memory.
template <int kBlock, bool kStageX, int kCat>
__global__ void __launch_bounds__(kBlock)
    level_shared_kernel(Records e, const float* __restrict__ X2,
                        float* __restrict__ out, int64_t n, int F, int tpc,
                        int depth) {
  constexpr bool kCats = kCat != kNoCats;
  const int S = F | 1;
  extern __shared__ int4 smem[];
  int4* s_walk = smem;
  int4* s_meta = s_walk + (size_t)tpc * e.M;
  float2* s_x = reinterpret_cast<float2*>(s_meta + tpc);
  float* s_leaf = reinterpret_cast<float*>(s_x + (kStageX ? kBlock * S : 0));
  int32_t* s_cat = reinterpret_cast<int32_t*>(s_leaf + (size_t)tpc * e.L);
  const float2* X = reinterpret_cast<const float2*>(X2);
  const int chunks = (e.T + tpc - 1) / tpc;
  const int64_t tiles = (n + kBlock - 1) / kBlock;
  const float unsettled = __ldg(e.leaves + e.leaf0);
  const int K = e.K, M = e.M, L = e.L, W = e.W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t r0 = tile * kBlock;
    const int rows = n - r0 < kBlock ? (int)(n - r0) : kBlock;
    __syncthreads();                 // the previous tile's walk is done
    if constexpr (kStageX) {
      // row r's pair f at s_x[r * S + f], S = F | 1: a warp a row, a lane
      // a pair
      for (int r = warp; r < rows; r += kBlock / 32)
        for (int f = lane; f < F; f += 32)
          __pipeline_memcpy_async(s_x + r * S + f, X + (r0 + r) * F + f,
                                  sizeof(float2));
      __pipeline_commit();
    }
    const bool valid = threadIdx.x < rows;
    const int64_t row = r0 + threadIdx.x;
    const float2* xr = kStageX ? s_x + threadIdx.x * S : X + row * F;
    for (int c = 0; c < chunks; ++c) {
      const int p0 = c * tpc;
      const int np = min(tpc, e.T - p0);
      if (c > 0) __syncthreads();    // chunk c - 1's walk is done
      if (chunks > 1 || tile == blockIdx.x)
        load_chunk<kCat>(e, p0, np, s_walk, s_meta, s_leaf, s_cat);
      __pipeline_wait_prior(0);
      __syncthreads();
      if (!valid) continue;
      int cur = s_meta[0].y;
      // the class goes on from chunk c - 1 or starts here
      float acc = s_meta[0].w ? 0.0f : out[row * K + cur];
      for (int j = 0; j < np;) {
        const int4 m = s_meta[j];
        if (m.y != cur) {            // the first tree of the next class
          out[row * K + cur] = acc;
          acc = 0.0f;
          cur = m.y;
        }
        const int4* t0 = s_walk + j * M;
        const int32_t* w0 = kCat == kSharedCats
                                ? s_cat + j * M * W
                                : e.cats + (int64_t)(p0 + j) * M * W;
        if (j + 1 < np && s_meta[j + 1].y == m.y) {
          // trees j and j + 1 (one class) at once: two walks a thread
          int node[2] = {m.z, s_meta[j + 1].z};
          const int4* nodes[2] = {t0, t0 + M};
          const float2* x[2] = {xr, xr};
          const int32_t* words[2] = {w0, w0 + M * W};
          descend<kStageX, kCats, 2>(node, nodes, x, words, W, depth);
          acc = __fadd_rn(                                  // tree order
              __fadd_rn(acc, leaf_value(s_leaf, j, L, node[0], unsettled)),
              leaf_value(s_leaf, j + 1, L, node[1], unsettled));
          j += 2;
        } else {
          int node[1] = {m.z};
          const int4* nodes[1] = {t0};
          const float2* x[1] = {xr};
          const int32_t* words[1] = {w0};
          descend<kStageX, kCats, 1>(node, nodes, x, words, W, depth);
          acc = __fadd_rn(acc, leaf_value(s_leaf, j, L, node[0], unsettled));
          j += 1;
        }
      }
      out[row * K + cur] = acc;
    }
  }
}

// The global tier: a warp a row, lane i on the tree at position base + i.
template <bool kLinks, bool kCats>
__global__ void __launch_bounds__(kGlobalThreads)
    level_global_kernel(Records e, const float* __restrict__ X2,
                        float* __restrict__ out, int64_t n, int F2,
                        int depth) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kGlobalRows + (threadIdx.x >> 5);
  if (row >= n) return;              // the whole warp
  const float2* x = reinterpret_cast<const float2*>(X2 + row * F2);
  const int M = e.M, L = e.L, W = e.W;
  float acc = 0.0f;
  int cur = -1;
  for (int base = 0; base < e.T; base += 32) {
    const int p = base + lane;
    float v = 0.0f;
    int cls = 0;
    if (p < e.T) {
      const int4 m = __ldg(e.meta + p);
      cls = m.y;
      const int4* nodes = e.walk + (int64_t)p * M;
      const int32_t* words = e.cats + (int64_t)p * M * W;
      int node = m.z;
      for (int d = 0; d < depth && node >= 0; ++d) {
        const int4 q = __ldg(nodes + node);
        const bool left =
            goes_left<kCats>(q, __ldg(x + (q.x >> 6)), words, node, W);
        if constexpr (kLinks) {
          const int2 g2 = __ldg(e.links + (int64_t)p * M + node);
          const int g = left ? g2.x : g2.y;
          node = g >= 0 ? g - m.x * M : g + m.x * L;
        } else {
          node = child(q, left);
        }
      }
      v = __ldg(e.leaves + (node < 0 ? (int64_t)p * L - node - 1 : e.leaf0));
    }
    const int cnt = min(32, e.T - base);
    for (int i = 0; i < cnt; ++i) {  // tree order, in every lane alike
      const int ci = __shfl_sync(0xffffffffu, cls, i);
      const float vi = __shfl_sync(0xffffffffu, v, i);
      if (ci != cur) {
        if (cur >= 0 && lane == 0) out[row * e.K + cur] = acc;
        cur = ci;
        acc = 0.0f;
      }
      acc = __fadd_rn(acc, vi);
    }
  }
  if (lane == 0 && cur >= 0) out[row * e.K + cur] = acc;
}

template <int kBlock, bool kStageX, int kCat>
int launch_shared(const Records& e, const float* X2, float* out, int64_t n,
                  int F, int tpc, int depth, int smem, int sms,
                  cudaStream_t stream) {
  auto kern = level_shared_kernel<kBlock, kStageX, kCat>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return (int)rc;
  }
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kBlock,
                                                     smem);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return (int)rc;
  }
  const int64_t tiles = (n + kBlock - 1) / kBlock;
  const int64_t fill = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  kern<<<(unsigned)(tiles < fill ? tiles : fill), kBlock, smem, stream>>>(
      e, X2, out, n, F, tpc, depth);
  return (int)cudaGetLastError();
}

template <int kBlock, bool kStageX>
int launch_shared_cats(int cat_mode, const Records& e, const float* X2,
                       float* out, int64_t n, int F, int tpc, int depth,
                       int smem, int sms, cudaStream_t stream) {
  switch (cat_mode) {
    case kNoCats:
      return launch_shared<kBlock, kStageX, kNoCats>(e, X2, out, n, F, tpc,
                                                     depth, smem, sms,
                                                     stream);
    case kSharedCats:
      return launch_shared<kBlock, kStageX, kSharedCats>(
          e, X2, out, n, F, tpc, depth, smem, sms, stream);
    default:
      return launch_shared<kBlock, kStageX, kDeviceCats>(
          e, X2, out, n, F, tpc, depth, smem, sms, stream);
  }
}

template <bool kLinks, bool kCats>
void launch_global(const Records& e, const float* X2, float* out, int64_t n,
                   int F2, int depth, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kGlobalRows - 1) / kGlobalRows);
  level_global_kernel<kLinks, kCats><<<grid, kGlobalThreads, 0, stream>>>(
      e, X2, out, n, F2, depth);
}

}  // namespace

// Shared tier.  walk (T*M, 4) int32, meta (T, 4) int32, leaves (T*L,)
// f32, cats (T*M*W,) int32 (ops/predict.py LevelRecords), X2 (n, 2F) f32
// interleaved hi/lo -> out (n, K) f32 (zeroed by the caller where a class
// has no tree).  threads: 256 or 512 a CTA, a row each; stage_x: the
// tile's rows staged in shared memory; tpc trees a chunk; cat_mode: 0
// no categorical node, 1 category words in shared memory, 2 read from
// device memory; smem: the dynamic shared bytes a CTA (refused past the
// card's limit); sms: the card's SMs.  Returns the first CUDA error, 0
// on success.
extern "C" int ltt_predict_level(const void* walk, const void* meta,
                                 const void* leaves, const void* cats,
                                 const void* X2, void* out, int64_t n, int F,
                                 int threads, int stage_x, int T, int M,
                                 int L, int W, int K, int tpc, int depth,
                                 int leaf0, int cat_mode, int smem, int sms,
                                 void* stream) {
  if (n <= 0) return 0;
  const Records e{(const int4*)walk, nullptr, (const int4*)meta,
                  (const float*)leaves, (const int32_t*)cats, T, M, L, W, K,
                  leaf0};
  const float* x = (const float*)X2;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (threads == 256)
    return stage_x ? launch_shared_cats<256, true>(cat_mode, e, x, o, n, F,
                                                   tpc, depth, smem, sms, s)
                   : launch_shared_cats<256, false>(cat_mode, e, x, o, n, F,
                                                    tpc, depth, smem, sms, s);
  return stage_x ? launch_shared_cats<512, true>(cat_mode, e, x, o, n, F, tpc,
                                                 depth, smem, sms, s)
                 : launch_shared_cats<512, false>(cat_mode, e, x, o, n, F,
                                                  tpc, depth, smem, sms, s);
}

// Global tier.  The records as above plus links (T*M, 2) int32 (read
// where use_links), X2 (n, F2) f32 -> out (n, K) f32; has_cats: some
// node is categorical.  A warp a row.  Returns cudaGetLastError().
extern "C" int ltt_predict_level_global(
    const void* walk, const void* links, const void* meta,
    const void* leaves, const void* cats, const void* X2, void* out,
    int64_t n, int F2, int T, int M, int L, int W, int K, int depth,
    int leaf0, int use_links, int has_cats, void* stream) {
  if (n <= 0) return 0;
  const Records e{(const int4*)walk, (const int2*)links, (const int4*)meta,
                  (const float*)leaves, (const int32_t*)cats, T, M, L, W, K,
                  leaf0};
  const float* x = (const float*)X2;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_links)
    has_cats ? launch_global<true, true>(e, x, o, n, F2, depth, s)
             : launch_global<true, false>(e, x, o, n, F2, depth, s);
  else
    has_cats ? launch_global<false, true>(e, x, o, n, F2, depth, s)
             : launch_global<false, false>(e, x, o, n, F2, depth, s);
  return (int)cudaGetLastError();
}
