// Row routing passes: the exit route + row value (kernel B) and the
// route alone (kernel H).
//
// Kernel B replaces the Pallas kernel _route_value_kernel_body
// (lightgbm_tpu/ops/histogram.py:1632, entry point route_apply_tiled
// :1708).  When a tree's last round has chosen its splits, those splits
// were never applied to the rows: this pass applies them and returns
// each row's post-route leaf value for the score update (0 for padded
// rows, whose leaf is negative, and for leaf ids past the table).
//
// Kernel H replaces the Pallas kernel _route_only_kernel_body
// (lightgbm_tpu/ops/histogram.py:1654, entry point route_only_tiled
// :1668): B without the values.  The split-route plan runs it at the
// start of every round to apply the pending route table before the
// route-free histogram (csrc/fused_route_hist.cu, kernel G).
//
// Value parity (B): the TPU kernel does not return the f32 leaf value
// itself but hi + mid + lo of its three bf16-exact parts
// (ops/partition.py _split3_bf16), summed in f32 as (hi + mid) + lo; the
// JAX package builds those parts as six route-table columns in XLA
// before its Pallas call.  This kernel takes the plain (L,) values and
// derives the parts itself, with the same operations on the f32 bits:
// hi = v & 0xFFFF0000, mid = (v - hi) & 0xFFFF0000, lo = ((v - hi) -
// mid) & 0xFFFF0000, the subtractions and the sum as __fsub_rn /
// __fadd_rn (round to nearest, nothing contracted or reordered, no flush
// of subnormals), so the row values equal the TPU kernel's bit for bit.
// A leaf's two candidates are its own value (keep) and the value of its
// right child, leaf t[8] * 256 + t[9] clamped to [0, L - 1] (the clamp
// of ops/partition.py extend_table_with_values).
//
// What bounds them on an H100: memory.  Per row they read the leaf id
// and write the new one (8 bytes), read one bin byte of the chosen group
// for rows of a splitting leaf, and B writes the 4-byte value; the route
// table stays in cache.  No atomics: each row's outputs are written by
// its own thread, so the result does not depend on the schedule.
//
// Design of B: one launch.  A grid of a few CTAs an SM strides over the
// rows; each CTA first builds every leaf's (keep, right) value pair in
// shared memory (L * 8 bytes; past 48 KB each row derives its pair from
// the values instead), then a thread takes 4 rows at a time
// (int4 leaf ids in and out, a float4 of values out) where n % 4 == 0
// and the pointers are aligned, else one.  H keeps its first design: one
// thread per row in 256-thread CTAs.

#include <cuda_runtime.h>
#include <cstdint>

#include "route.cuh"

namespace {

constexpr int kThreads = 256;
// CTAs an SM of kernel B's grid (all of its 2048 threads)
constexpr int kCtasPerSm = 8;
// the most leaves whose value pairs B keeps in shared memory (48 KB,
// the dynamic size a launch may take without opting in)
constexpr int kSharedLeaves = 48 * 1024 / 8;

// Kernel H: one thread a row.
__global__ void route_kernel(const uint8_t* __restrict__ binsT,
                             const int32_t* __restrict__ leaf_in,
                             const float* __restrict__ table,
                             int32_t* __restrict__ leaf_out, int64_t n,
                             int G, int L, int K) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  bool went_right;
  leaf_out[row] = ltt_route_row(binsT, n, row, G, leaf_in[row], table, L,
                                K, K - LTT_ROUTE_FIXED_COLS, &went_right);
}

// (hi + mid) + lo of v's three bf16-exact parts (ops/partition.py
// _split3_bf16), in f32 round-to-nearest with no contraction.
__device__ __forceinline__ float split3_sum(float v) {
  const float hi = __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
  const float r1 = __fsub_rn(v, hi);
  const float mid = __uint_as_float(__float_as_uint(r1) & 0xFFFF0000u);
  const float lo =
      __uint_as_float(__float_as_uint(__fsub_rn(r1, mid)) & 0xFFFF0000u);
  return __fadd_rn(__fadd_rn(hi, mid), lo);
}

// Leaf l's (keep, right) row values.
__device__ __forceinline__ float2 value_pair(const float* values,
                                             const float* table, int l,
                                             int L, int K) {
  const float* t = table + (int64_t)l * K;
  const int rs = (int)__ldg(t + 8) * 256 + (int)__ldg(t + 9);
  return make_float2(split3_sum(__ldg(values + l)),
                     split3_sum(__ldg(values + min(max(rs, 0), L - 1))));
}

struct RouteIn {
  const uint8_t* binsT;
  const int32_t* leaf_in;
  const float* table;
  const float* values;
  int32_t* leaf_out;
  float* val_out;
  int64_t n;
  int G, L, K;
};

// Route row ``row`` of leaf ``leaf``; returns its value and sets
// ``*out`` to its new leaf.
template <bool kShared>
__device__ __forceinline__ float route_value(const RouteIn& in,
                                             const float2* s_val,
                                             int64_t row, int leaf,
                                             int* out) {
  bool right;
  *out = ltt_route_row(in.binsT, in.n, row, in.G, leaf, in.table, in.L,
                       in.K, in.K - LTT_ROUTE_FIXED_COLS, &right);
  if (leaf < 0 || leaf >= in.L) return 0.0f;
  const float2 v = kShared ? s_val[leaf]
                           : value_pair(in.values, in.table, leaf, in.L,
                                        in.K);
  return right ? v.y : v.x;
}

// Kernel B: V rows a thread (4: n % 4 == 0 and the leaf and value
// pointers 16-byte aligned), the grid striding over the rows; with
// kShared the value pairs of all L leaves in shared memory.
template <int V, bool kShared>
__global__ void __launch_bounds__(kThreads)
    route_value_kernel(RouteIn in) {
  extern __shared__ float2 s_val[];
  if constexpr (kShared) {
    for (int l = threadIdx.x; l < in.L; l += blockDim.x)
      s_val[l] = value_pair(in.values, in.table, l, in.L, in.K);
    __syncthreads();
  }
  const int64_t step = (int64_t)gridDim.x * blockDim.x * V;
  for (int64_t r0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
       r0 < in.n; r0 += step) {
    if constexpr (V == 4) {
      const int4 lv =
          __ldg(reinterpret_cast<const int4*>(in.leaf_in + r0));
      int4 lo;
      float4 vo;
      vo.x = route_value<kShared>(in, s_val, r0, lv.x, &lo.x);
      vo.y = route_value<kShared>(in, s_val, r0 + 1, lv.y, &lo.y);
      vo.z = route_value<kShared>(in, s_val, r0 + 2, lv.z, &lo.z);
      vo.w = route_value<kShared>(in, s_val, r0 + 3, lv.w, &lo.w);
      *reinterpret_cast<int4*>(in.leaf_out + r0) = lo;
      *reinterpret_cast<float4*>(in.val_out + r0) = vo;
    } else {
      int lo;
      in.val_out[r0] =
          route_value<kShared>(in, s_val, r0, __ldg(in.leaf_in + r0), &lo);
      in.leaf_out[r0] = lo;
    }
  }
}

template <int V, bool kShared>
int launch_b(const RouteIn& in, int sms, cudaStream_t stream) {
  const int64_t need = (in.n + (int64_t)kThreads * V - 1) / (kThreads * V);
  const int64_t grid = need < (int64_t)sms * kCtasPerSm
                           ? need : (int64_t)sms * kCtasPerSm;
  const size_t smem = kShared ? (size_t)in.L * sizeof(float2) : 0;
  route_value_kernel<V, kShared><<<(unsigned)grid, kThreads, smem,
                                   stream>>>(in);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel B.  binsT (G, n) uint8, leaf_in (n,) int32, table (L, K) f32
// (the pending route table), values (L,) f32 (the tree's leaf values)
// -> leaf_out (n,) int32, val_out (n,) f32; sms: the card's SMs (the
// grid is kCtasPerSm CTAs an SM).  One launch.  Returns
// cudaGetLastError().
extern "C" int ltt_route_apply(const void* binsT, const void* leaf_in,
                               const void* table, const void* values,
                               void* leaf_out, void* val_out, int64_t n,
                               int G, int L, int K, int sms, void* stream) {
  if (n <= 0) return 0;
  const RouteIn in{(const uint8_t*)binsT, (const int32_t*)leaf_in,
                   (const float*)table, (const float*)values,
                   (int32_t*)leaf_out, (float*)val_out, n, G, L, K};
  const bool v4 = n % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(leaf_in) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(leaf_out) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(val_out) % 16 == 0;
  const bool shared = L <= kSharedLeaves;
  cudaStream_t s = (cudaStream_t)stream;
  if (v4)
    return shared ? launch_b<4, true>(in, sms, s)
                  : launch_b<4, false>(in, sms, s);
  return shared ? launch_b<1, true>(in, sms, s)
                : launch_b<1, false>(in, sms, s);
}

// Kernel H.  binsT (G, n) uint8, leaf_in (n,) int32, table (L, K) f32 ->
// leaf_out (n,) int32.  Returns cudaGetLastError().
extern "C" int ltt_route_only(const void* binsT, const void* leaf_in,
                              const void* table, void* leaf_out, int64_t n,
                              int G, int L, int K, void* stream) {
  if (n <= 0) return 0;
  route_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                 (cudaStream_t)stream>>>(
      (const uint8_t*)binsT, (const int32_t*)leaf_in, (const float*)table,
      (int32_t*)leaf_out, n, G, L, K);
  return (int)cudaGetLastError();
}
