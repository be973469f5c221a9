// The sub-byte storage of the bin matrix (lightgbm_tpu_torch/packing.py,
// the JAX package's r18 nibble and r21 crumb layouts), as the device
// readers widen it.  A pack spec (P, C) says that the first C logical
// groups are 2-bit crumbs, four to a storage byte (group 4j + k in bits
// 2k..2k+1 of byte j), the next P - C are 4-bit nibbles, two to a byte
// after the ceil(C/4) crumb bytes (the first of a pair in the low
// nibble), and every later group takes a byte of its own.  Each storage
// byte is a row of the transposed (cols, n) matrix, so a 32-bit word
// holds one storage byte of 4 consecutive rows.
//
// CUDA form of lightgbm_tpu_torch/ops/partition.py packed_select_params
// (the JAX package's BinLayout.byte_of / shift_of / width_mask): logical
// group g's storage byte, and the shift and mask that widen it,
// (byte >> shift) & mask.  Every reader of the packed matrix (the
// routing of route.cuh, the histogram loads of hist_i32.cuh) takes its
// select from here and widens in registers; nothing unpacks the matrix
// into a buffer.
#pragma once

struct LttPackSel {
  int byte, shift, mask;
};

// g: a logical group in [0, G); P, C: the spec's sub-byte and crumb
// group counts (0 <= C <= P).
__device__ __forceinline__ LttPackSel ltt_pack_select(int g, int P, int C) {
  const int cb = (C + 3) >> 2;
  if (g < C) return {g >> 2, (g & 3) << 1, 0x3};
  if (g < P) return {cb + ((g - C) >> 1), ((g - C) & 1) << 2, 0xF};
  return {cb + ((P - C + 1) >> 1) + g - P, 0, 0xFF};
}
