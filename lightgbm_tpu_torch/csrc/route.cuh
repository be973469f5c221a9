// Per-row split routing shared by the routing passes of the fused
// route+histogram kernels and by the exit-route and route-only kernels.
//
// CUDA form of lightgbm_tpu_torch/ops/partition.py route_rows (and of
// the TPU kernels' _route_prologue_T, lightgbm_tpu/ops/histogram.py:1140).
// The TPU broadcasts the per-leaf route table to rows through a bf16
// one-hot matrix product; here each thread gathers its leaf's table row
// directly.  Every route column is an integer below 256, so the gather
// reads the same numbers the product produced.
//
// Each function has a byte-wide form (kPacked false: binsT is the (G, n)
// logical matrix) and a packed one (kPacked: binsT is the (cols, n)
// sub-byte storage of the spec (P, C), csrc/pack.cuh): the chosen
// group's storage byte is read and widened, (byte >> shift) & mask, as
// _route_prologue_T's packed select does (histogram.py:1176-1187).  The
// byte-wide form is the code it was before the packed one existed.
#pragma once

#include <climits>
#include <cstdint>

#include "pack.cuh"

#define LTT_MISSING_ZERO 1
#define LTT_MISSING_NAN 2
#define LTT_ROUTE_FIXED_COLS 15

// Route one row.  ``table`` is the (L, stride) f32 route table, ``nb``
// the number of categorical byte columns after the 15 fixed ones, G the
// logical groups, (P, C) the pack spec (kPacked only).  Returns the
// post-route leaf; ``went_right`` says whether the row moved to the
// right child.  Rows whose leaf is negative or has no table row are left
// untouched, as are rows of leaves that do not split.
template <bool kPacked>
__device__ __forceinline__ int ltt_route_row(
    const uint8_t* __restrict__ binsT, int64_t n, int64_t row, int G,
    int leaf, const float* __restrict__ table, int L, int stride, int nb,
    bool* went_right, int P, int C) {
  *went_right = false;
  if (leaf < 0 || leaf >= L) return leaf;
  const float* t = table + (int64_t)leaf * stride;
  if (!(__ldg(t + 10) > 0.5f)) return leaf;
  const int grp = (int)__ldg(t + 0) * 256 + (int)__ldg(t + 1);
  int gb = 0;
  if constexpr (kPacked) {
    if (grp >= 0 && grp < G) {
      const LttPackSel s = ltt_pack_select(grp, P, C);
      gb = ((int)__ldg(binsT + (int64_t)s.byte * n + row) >> s.shift) &
           s.mask;
    }
  } else {
    gb = (grp >= 0 && grp < G) ? (int)__ldg(binsT + (int64_t)grp * n + row)
                               : 0;
  }
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

// A leaf's route row decoded once into two int4 (the routing kernels B
// and H keep every leaf's in shared memory, so a row reads 32 bytes of
// shared memory instead of ~10 table words; a leaf that does not split
// costs one table read):
//   r[0] = {chosen group (INT_MIN: the leaf does not split; kPacked: its
//           select, storage byte | shift << 16 | mask << 20, the mask 0
//           for a group past G, which reads as bin 0), right child,
//           lo | hi << 16, shift | oor << 16}
//   r[1] = {threshold, default_left | missing_type << 8 | is_cat << 16,
//           default bin, num_bin}
// lo, hi, shift and oor are kept in 16 bits and default_left and
// missing_type in 8: every route column is an integer below 256, so the
// record routes as the table does.
// The select's storage byte fits its 16 bits: cols <= G < 65536.
template <bool kPacked>
__device__ __forceinline__ void ltt_route_rec(const float* __restrict__ table,
                                              int leaf, int stride, int4* r,
                                              int G, int P, int C) {
  const float* t = table + (int64_t)leaf * stride;
  if (!(__ldg(t + 10) > 0.5f)) {    // no split: nothing else is read
    r[0] = make_int4(INT_MIN, 0, 0, 0);
    r[1] = make_int4(0, 0, 0, 0);
    return;
  }
  int grp = (int)__ldg(t + 0) * 256 + (int)__ldg(t + 1);
  if constexpr (kPacked) {
    if (grp >= 0 && grp < G) {
      const LttPackSel s = ltt_pack_select(grp, P, C);
      grp = s.byte | (s.shift << 16) | (s.mask << 20);
    } else {
      grp = 0;
    }
  }
  r[0] = make_int4(
      grp,
      (int)__ldg(t + 8) * 256 + (int)__ldg(t + 9),
      ((int)__ldg(t + 11) & 0xffff) | ((int)__ldg(t + 12) << 16),
      ((int)__ldg(t + 13) & 0xffff) | ((int)__ldg(t + 14) << 16));
  r[1] = make_int4((int)__ldg(t + 2),
                   ((int)__ldg(t + 3) & 0xff) |
                       (((int)__ldg(t + 4) & 0xff) << 8) |
                       ((__ldg(t + 7) > 0.5f ? 1 : 0) << 16),
                   (int)__ldg(t + 5), (int)__ldg(t + 6));
}

// The chosen group's bin of row ``row`` of leaf ``leaf`` (0 for a group
// past G), or -1 where the row does not route (its leaf is negative, has
// no record or does not split), from the records ``rec`` (two int4 a
// leaf; kPacked: records of ltt_route_rec<true>).
template <bool kPacked>
__device__ __forceinline__ int ltt_route_rec_bin(
    const uint8_t* __restrict__ binsT, int64_t n, int64_t row, int G,
    int leaf, int L, const int4* rec) {
  if (leaf < 0 || leaf >= L) return -1;
  const int grp = rec[2 * leaf].x;
  if (grp == INT_MIN) return -1;
  if constexpr (kPacked) {
    return ((int)__ldg(binsT + (int64_t)(grp & 0xffff) * n + row) >>
            ((grp >> 16) & 0xf)) &
           (grp >> 20);
  } else {
    return (grp >= 0 && grp < G) ? (int)__ldg(binsT + (int64_t)grp * n + row)
                                 : 0;
  }
}

// ltt_route_row from the records ``rec`` for a row of leaf ``leaf``
// whose chosen group's bin is ``gb`` (ltt_route_rec_bin; -1: the row
// does not route); the categorical left-set bytes are read from the
// table.
__device__ __forceinline__ int ltt_route_rec_leaf(
    int leaf, int gb, const int4* rec, const float* __restrict__ table,
    int stride, int nb, bool* went_right) {
  *went_right = false;
  if (gb < 0) return leaf;
  const int4 a = rec[2 * leaf], b = rec[2 * leaf + 1];
  const int lo = (short)(a.z & 0xffff), hi = a.z >> 16;
  const int shift = (short)(a.w & 0xffff), oor = a.w >> 16;
  const int fbin = (gb >= lo && gb < hi) ? gb - shift : oor;
  int go_left;
  if ((b.y >> 16) & 1) {
    int byte_val = 0;
    if (fbin >= 0 && fbin < 8 * nb)
      byte_val = (int)__ldg(table + (int64_t)leaf * stride +
                            LTT_ROUTE_FIXED_COLS + (fbin >> 3));
    go_left = (byte_val >> (fbin & 7)) & 1;
  } else {
    const int dleft = b.y & 0xff, mtype = (b.y >> 8) & 0xff;
    if (mtype == LTT_MISSING_NAN && fbin == b.w - 1)
      go_left = dleft;
    else if (mtype == LTT_MISSING_ZERO && fbin == b.z)
      go_left = dleft;
    else
      go_left = fbin <= b.x ? 1 : 0;
  }
  if (go_left > 0) return leaf;
  *went_right = true;
  return a.y;
}
