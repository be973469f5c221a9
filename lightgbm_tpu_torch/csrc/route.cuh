// Per-row split routing shared by the routing passes of the fused
// route+histogram kernels and by the exit-route and route-only kernels.
//
// CUDA form of lightgbm_tpu_torch/ops/partition.py route_rows (and of
// the TPU kernels' _route_prologue_T, lightgbm_tpu/ops/histogram.py:1140).
// The TPU broadcasts the per-leaf route table to rows through a bf16
// one-hot matrix product; here each thread gathers its leaf's table row
// directly.  Every route column is an integer below 256, so the gather
// reads the same numbers the product produced.
#pragma once

#include <cstdint>

#define LTT_MISSING_ZERO 1
#define LTT_MISSING_NAN 2
#define LTT_ROUTE_FIXED_COLS 15

// Route one row.  ``table`` is the (L, stride) f32 route table, ``nb``
// the number of categorical byte columns after the 15 fixed ones.
// Returns the post-route leaf; ``went_right`` says whether the row moved
// to the right child.  Rows whose leaf is negative or has no table row
// are left untouched, as are rows of leaves that do not split.
__device__ __forceinline__ int ltt_route_row(
    const uint8_t* __restrict__ binsT, int64_t n, int64_t row, int G,
    int leaf, const float* __restrict__ table, int L, int stride, int nb,
    bool* went_right) {
  *went_right = false;
  if (leaf < 0 || leaf >= L) return leaf;
  const float* t = table + (int64_t)leaf * stride;
  if (!(__ldg(t + 10) > 0.5f)) return leaf;
  const int grp = (int)__ldg(t + 0) * 256 + (int)__ldg(t + 1);
  const int gb = (grp >= 0 && grp < G)
                     ? (int)__ldg(binsT + (int64_t)grp * n + row) : 0;
  const int lo = (int)__ldg(t + 11), hi = (int)__ldg(t + 12);
  const int shift = (int)__ldg(t + 13), oor = (int)__ldg(t + 14);
  const int fbin = (gb >= lo && gb < hi) ? gb - shift : oor;
  int go_left;
  if (__ldg(t + 7) > 0.5f) {
    // categorical: bit fbin of the packed left-set bytes
    int byte_val = 0;
    if (fbin >= 0 && fbin < 8 * nb)
      byte_val = (int)__ldg(t + LTT_ROUTE_FIXED_COLS + (fbin >> 3));
    go_left = (byte_val >> (fbin & 7)) & 1;
  } else {
    const int thr = (int)__ldg(t + 2), dleft = (int)__ldg(t + 3);
    const int mtype = (int)__ldg(t + 4), dbin = (int)__ldg(t + 5);
    const int nbin = (int)__ldg(t + 6);
    if (mtype == LTT_MISSING_NAN && fbin == nbin - 1)
      go_left = dleft;
    else if (mtype == LTT_MISSING_ZERO && fbin == dbin)
      go_left = dleft;
    else
      go_left = fbin <= thr ? 1 : 0;
  }
  if (go_left > 0) return leaf;
  *went_right = true;
  return (int)__ldg(t + 8) * 256 + (int)__ldg(t + 9);
}
