// The 64-bit sort keys and the warp's candidate buffer shared by kernel C
// (topk_values.cu) and kernel F (rank_merge.cu).
//
// A key is (ordered value bits << 32) | column: keys order as a stable
// sort by value orders the entries. The value bits map to an unsigned
// integer that rises with the float (negative floats have all bits
// flipped, others the sign bit set), and -0.0 is keyed as +0.0 (they
// compare equal, so the column decides). A warp keeps one buffer of
// candidate keys in shared memory; when it is full, a bitonic sort by the
// warp keeps the k smallest and sets the threshold to the k-th key.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace vers {

constexpr unsigned long long PAD_KEY = ~0ull;

// Unsigned bits that rise with the float; -0.0 as +0.0.
__device__ inline unsigned order_bits(float v) {
  const unsigned u = v == 0.f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ inline unsigned long long make_key(float v, int col) {
  return ((unsigned long long)order_bits(v) << 32) | (unsigned)col;
}

// The float a key was made from (+0.0 for either zero).
__device__ inline float key_value(unsigned long long key) {
  const unsigned o = (unsigned)(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Ascending bitonic sort of buf[0, n), n a power of two, by one warp.
__device__ inline void warp_sort(unsigned long long* buf, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < n / 2; i += 32) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = buf[lo], b = buf[hi];
        if ((a > b) == up) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncwarp();
    }
}

// Sort the cnt keys of buf, keep the k smallest, and set the threshold
// to the k-th key and its value (PAD_KEY, +inf while fewer than k are
// held).
__device__ inline void prune(unsigned long long* buf, int& cnt,
                             unsigned long long& thr_key, float& thr, int k,
                             int lane) {
  int n = 32;
  while (n < cnt) n <<= 1;
  for (int i = cnt + lane; i < n; i += 32) buf[i] = PAD_KEY;
  __syncwarp();
  warp_sort(buf, n, lane);
  cnt = min(cnt, k);
  thr_key = cnt == k ? buf[k - 1] : PAD_KEY;
  thr = cnt == k ? key_value(thr_key) : CUDART_INF_F;
}

}  // namespace vers
