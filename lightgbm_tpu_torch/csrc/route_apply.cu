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
// Design: one template, one launch each.  A grid of a few CTAs an SM
// strides over the rows; a thread takes 4 rows at a time (int4 leaf ids
// in and out, for B a float4 of values out) where n % 4 == 0 and the
// pointers are aligned, else one.  Each CTA first decodes every leaf's
// route row into a 32-byte record in shared memory (csrc/route.cuh
// ltt_route_rec: a row then reads two int4 of shared memory, not ~10
// table words, and a thread issues its 4 rows' bin loads together) and,
// with its values on (B), builds every leaf's (keep, right) value pair
// beside it.  Past 48 KB of records (1,536 leaves for H, 1,228 for B
// with its pairs) each row reads the table instead; B keeps its value
// pairs in shared memory up to 6,144 leaves, and past that each row
// builds its own.  With the values off (H) there is no value pair and no
// value store.
//
// Sub-byte storage (the template's kPacked, a nonzero spec): binsT is the
// (cols, n) packed matrix of G logical groups (csrc/pack.cuh), and each
// leaf's record holds its chosen group's storage byte, shift and mask in
// place of the group (csrc/route.cuh ltt_route_rec), decoded once a CTA
// like the rest of the record, so that a row reads its storage byte and
// widens it in registers; past the records' shared memory each row
// selects from the table itself.

#include <cuda_runtime.h>
#include <cstdint>

#include "route.cuh"

namespace {

constexpr int kThreads = 256;
// CTAs an SM of the grid (all of its 2048 threads)
constexpr int kCtasPerSm = 8;
// the shared memory a CTA keeps its leaves' route records (32 bytes)
// and, for B, value pairs (8 bytes) in: 48 KB, the dynamic size a
// launch may take without opting in; past it each row reads the table
// and the values
constexpr int kSharedBytes = 48 * 1024;

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
  const float* values;  // B only
  int32_t* leaf_out;
  float* val_out;       // B only
  int64_t n;
  int G, L, K;
  int P, C;             // the pack spec (kPacked only)
};

// Route row ``row`` of leaf ``leaf``, whose chosen group's bin is
// ``gb`` where the records are shared (kRec: ltt_route_rec_bin; the
// table path reads it itself); returns its value (kValues, from the
// shared pairs where kVal; else 0) and sets ``*out`` to its new leaf.
template <bool kValues, bool kRec, bool kVal, bool kPacked>
__device__ __forceinline__ float route_value(const RouteIn& in,
                                             const int4* s_rec,
                                             const float2* s_val,
                                             int64_t row, int gb, int leaf,
                                             int* out) {
  bool right;
  const int nb = in.K - LTT_ROUTE_FIXED_COLS;
  *out = kRec
             ? ltt_route_rec_leaf(leaf, gb, s_rec, in.table, in.K, nb, &right)
             : ltt_route_row<kPacked>(in.binsT, in.n, row, in.G, leaf,
                                      in.table, in.L, in.K, nb, &right, in.P,
                                      in.C);
  if constexpr (!kValues) {
    return 0.0f;
  } else {
    if (leaf < 0 || leaf >= in.L) return 0.0f;
    const float2 v = kVal ? s_val[leaf]
                          : value_pair(in.values, in.table, leaf, in.L,
                                       in.K);
    return right ? v.y : v.x;
  }
}

// Kernels B (kValues) and H: V rows a thread (4: n % 4 == 0 and the
// leaf and value pointers 16-byte aligned), the grid striding over the
// rows; in shared memory, decoded once a CTA, every leaf's route record
// (kRec, csrc/route.cuh) and, for B, its value pair (kVal); kPacked: the
// bins stored sub-byte.
template <int V, bool kValues, bool kRec, bool kVal, bool kPacked>
__global__ void __launch_bounds__(kThreads)
    route_value_kernel(RouteIn in) {
  extern __shared__ int4 s_raw[];
  int4* s_rec = s_raw;
  float2* s_val = reinterpret_cast<float2*>(s_raw + (kRec ? 2 * in.L : 0));
  if constexpr (kRec || kVal) {
    for (int l = threadIdx.x; l < in.L; l += blockDim.x) {
      if constexpr (kRec)
        ltt_route_rec<kPacked>(in.table, l, in.K, s_rec + 2 * l, in.G, in.P,
                               in.C);
      if constexpr (kVal)
        s_val[l] = value_pair(in.values, in.table, l, in.L, in.K);
    }
    __syncthreads();
  }
  const int64_t step = (int64_t)gridDim.x * blockDim.x * V;
  for (int64_t r0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
       r0 < in.n; r0 += step) {
    if constexpr (V == 4) {
      const int4 lv =
          __ldg(reinterpret_cast<const int4*>(in.leaf_in + r0));
      const int leaf[4] = {lv.x, lv.y, lv.z, lv.w};
      // with the records shared, the four rows' bin loads are issued
      // before any of them is used
      int gb[4] = {-1, -1, -1, -1};
      if constexpr (kRec) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          gb[k] = ltt_route_rec_bin<kPacked>(in.binsT, in.n, r0 + k, in.G,
                                             leaf[k], in.L, s_rec);
      }
      int out[4];
      float val[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        val[k] = route_value<kValues, kRec, kVal, kPacked>(
            in, s_rec, s_val, r0 + k, gb[k], leaf[k], &out[k]);
      *reinterpret_cast<int4*>(in.leaf_out + r0) =
          make_int4(out[0], out[1], out[2], out[3]);
      if constexpr (kValues)
        *reinterpret_cast<float4*>(in.val_out + r0) =
            make_float4(val[0], val[1], val[2], val[3]);
    } else {
      int lo;
      const int leaf = __ldg(in.leaf_in + r0);
      const int gb = kRec ? ltt_route_rec_bin<kPacked>(in.binsT, in.n, r0,
                                                       in.G, leaf, in.L,
                                                       s_rec)
                          : -1;
      const float v = route_value<kValues, kRec, kVal, kPacked>(
          in, s_rec, s_val, r0, gb, leaf, &lo);
      if constexpr (kValues) in.val_out[r0] = v;
      in.leaf_out[r0] = lo;
    }
  }
}

template <int V, bool kValues, bool kRec, bool kVal, bool kPacked>
int launch(const RouteIn& in, int sms, cudaStream_t stream) {
  const int64_t need = (in.n + (int64_t)kThreads * V - 1) / (kThreads * V);
  const int64_t grid = need < (int64_t)sms * kCtasPerSm
                           ? need : (int64_t)sms * kCtasPerSm;
  const size_t smem = (size_t)in.L * ((kRec ? 2 * sizeof(int4) : 0) +
                                      (kVal ? sizeof(float2) : 0));
  route_value_kernel<V, kValues, kRec, kVal, kPacked>
      <<<(unsigned)grid, kThreads, smem, stream>>>(in);
  return (int)cudaGetLastError();
}

// 4 rows a thread where n % 4 == 0 and the leaf pointers (and B's value
// pointer) are 16-byte aligned.
bool rows4(const RouteIn& in) {
  return in.n % 4 == 0 &&
         reinterpret_cast<uintptr_t>(in.leaf_in) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(in.leaf_out) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(in.val_out) % 16 == 0;
}

// B at V rows a thread: records and value pairs shared where both fit
// kSharedBytes, the value pairs alone where they fit, else neither.
template <int V, bool kPacked>
int launch_b(const RouteIn& in, int sms, cudaStream_t stream) {
  const int64_t L = in.L;
  if (L * 40 <= kSharedBytes)             // a 32-byte record, an 8-byte pair
    return launch<V, true, true, true, kPacked>(in, sms, stream);
  if (L * 8 <= kSharedBytes)
    return launch<V, true, false, true, kPacked>(in, sms, stream);
  return launch<V, true, false, false, kPacked>(in, sms, stream);
}

// H at V rows a thread: the records shared where they fit kSharedBytes.
template <int V, bool kPacked>
int launch_h(const RouteIn& in, int sms, cudaStream_t stream) {
  if ((int64_t)in.L * 32 <= kSharedBytes)
    return launch<V, false, true, false, kPacked>(in, sms, stream);
  return launch<V, false, false, false, kPacked>(in, sms, stream);
}

// B (kValues) or H at 4 rows a thread where rows4 allows it, else 1.
template <bool kValues, bool kPacked>
int launch_bh(const RouteIn& in, int sms, cudaStream_t s) {
  const bool v4 = rows4(in);
  if constexpr (kValues)
    return v4 ? launch_b<4, kPacked>(in, sms, s)
              : launch_b<1, kPacked>(in, sms, s);
  else
    return v4 ? launch_h<4, kPacked>(in, sms, s)
              : launch_h<1, kPacked>(in, sms, s);
}

}  // namespace

// Kernel B.  binsT (G, n) uint8 (spec != 0: the (cols, n) sub-byte
// storage of G logical groups, spec = P | C << 16, packing.py
// pack_spec), leaf_in (n,) int32, table (L, K) f32 (the pending route
// table), values (L,) f32 (the tree's leaf values) -> leaf_out (n,)
// int32, val_out (n,) f32; sms: the card's SMs (the grid is kCtasPerSm
// CTAs an SM).  One launch.  Returns cudaGetLastError().
extern "C" int ltt_route_apply(const void* binsT, const void* leaf_in,
                               const void* table, const void* values,
                               void* leaf_out, void* val_out, int64_t n,
                               int G, int L, int K, int sms, int spec,
                               void* stream) {
  if (n <= 0) return 0;
  const RouteIn in{(const uint8_t*)binsT, (const int32_t*)leaf_in,
                   (const float*)table, (const float*)values,
                   (int32_t*)leaf_out, (float*)val_out, n, G, L, K,
                   spec & 0xffff, spec >> 16};
  cudaStream_t s = (cudaStream_t)stream;
  return spec ? launch_bh<true, true>(in, sms, s)
              : launch_bh<true, false>(in, sms, s);
}

// Kernel H.  binsT (G, n) uint8 (or, spec != 0, the storage as for B),
// leaf_in (n,) int32, table (L, K) f32 -> leaf_out (n,) int32; sms: the
// card's SMs.  B's launch without values.  Returns cudaGetLastError().
extern "C" int ltt_route_only(const void* binsT, const void* leaf_in,
                              const void* table, void* leaf_out, int64_t n,
                              int G, int L, int K, int sms, int spec,
                              void* stream) {
  if (n <= 0) return 0;
  const RouteIn in{(const uint8_t*)binsT, (const int32_t*)leaf_in,
                   (const float*)table, nullptr, (int32_t*)leaf_out,
                   nullptr, n, G, L, K, spec & 0xffff, spec >> 16};
  cudaStream_t s = (cudaStream_t)stream;
  return spec ? launch_bh<false, true>(in, sms, s)
              : launch_bh<false, false>(in, sms, s);
}
