// Kernel C: the k smallest values of each row of a (Q, W) f32 array,
// carrying an int32 id per entry.
//
// Replaces vers_tpu/ops/pallas_topk.py:pallas_topk_values (body
// _values_kernel). The TPU kernel walks column chunks in order and merges
// each into a carried (QT, k) set by k extract-min passes, carried
// entries first: equal values come out in ascending column order, i.e.
// a stable sort by value. Its callers are stage 2 of the bucket scan
// (kernel D), which hands it the bucket table, and kernel A, which hands
// it the best sets of its corpus splits.
//
// Bound on the H100: reading the values once (Q * W * 4 bytes; 16384 x
// 8960 is 0.59 GB, ~0.18 ms at 3.35 TB/s). There is no reuse, so the
// design is one warp per row streaming 16-byte loads (two in flight per
// lane, eight rows a block) against ONE threshold per row, the row's
// current k-th value:
//  * An entry is a candidate only if its 64-bit key, (ordered value
//    bits << 32) | column, is below the key of the current k-th entry:
//    k entries are ahead of any other and it cannot be a winner. One
//    float compare of a lane's least value against the k-th value
//    rejects most loads before any key is made. (The key compare, not a
//    strict float compare, decides: a lane holds four neighbouring
//    columns, so the k-th entry may sit at a higher column than an
//    equal value tested after it.)
//  * The few entries that pass are appended to one candidate buffer per
//    row in shared memory (ballot + prefix popcount) as keys. The buffer
//    holds CAP keys (a power of two near 4 k, chosen by the host): when
//    it is full, a bitonic sort by the warp keeps the k smallest and
//    tightens the threshold. After a prune at n columns seen, a later
//    entry passes with probability k / n, so the columns seen grow by
//    CAP / k from prune to prune: a handful of sorts per row, not one
//    insertion per entry. Shared memory per row is 8 CAP bytes whatever
//    the lane count.
//  * Keys order as a stable sort by value orders the entries: the value
//    bits map to an unsigned integer that rises with the float (negative
//    floats have all bits flipped, others the sign bit set), -0.0 is
//    keyed as +0.0 (they compare equal, so the column decides), and the
//    column fills the low word. +inf and NaN are never candidates, so
//    only finite values (and -inf, whose id is -1 as in the plain
//    version) are written; the rest of a row stays the wrapper's
//    (+inf, -1). The winners' values and ids are gathered from the
//    inputs at their columns, k loads in parallel.
//  * Rows of at most 32 entries (kernel A's second pass over two splits
//    of k = 10) take a route without shared memory: one key per lane and
//    a bitonic sort by shuffles.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): the loads and
// the reject compare alone take 0.20-0.21 ms of the 0.26 ms at k = 10 and
// of the 0.37 ms at k = 32; two loads in flight per lane beat one, four
// and eight, which hold the candidate work of a step back.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "topk_keys.cuh"

namespace vers {

constexpr int VWARPS = 8;    // rows per block, one warp each
constexpr int VLOADS = 2;    // 16-byte loads in flight per lane
constexpr int VSTEP = 128;   // columns a warp takes with one load each
constexpr unsigned FULL = 0xffffffffu;

// Write the row's winners: values and ids gathered at their columns.
__device__ inline void write_winner(const float* __restrict__ vals,
                                    const int* __restrict__ ids,
                                    float* __restrict__ out_d,
                                    int* __restrict__ out_i, size_t row, int W,
                                    int k, int t, unsigned long long key) {
  const size_t at = row * W + (unsigned)(key & 0xffffffffu);
  const float v = vals[at];
  out_d[row * k + t] = v;
  out_i[row * k + t] = isinf(v) ? -1 : ids[at];
}

// VEC: W % 4 == 0 and 16-byte aligned rows: lane j of a step holds
// columns 4 j .. 4 j + 3. Otherwise 4-byte loads, lane j holding columns
// j, j + 32, j + 64, j + 96.
template <bool VEC>
__global__ void __launch_bounds__(VWARPS * 32)
topk_values_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                   float* __restrict__ out_d, int* __restrict__ out_i, int Q,
                   int W, int k, int cap) {
  extern __shared__ unsigned long long keys[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * VWARPS + warp;
  if (row >= Q) return;  // no block-wide barrier below
  unsigned long long* buf = keys + (size_t)warp * cap;
  const float* v = vals + (size_t)row * W;
  int cnt = 0;
  unsigned long long thr_key = PAD_KEY;
  float thr = CUDART_INF_F;

  for (int c0 = 0; c0 < W; c0 += VSTEP * VLOADS) {
    float x[VLOADS][4];
#pragma unroll
    for (int u = 0; u < VLOADS; ++u) {
      const int base = c0 + u * VSTEP;
      if (VEC) {
        const int c = base + 4 * lane;
        float4 f = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                               CUDART_INF_F);
        if (c < W) f = __ldcs(reinterpret_cast<const float4*>(v + c));
        x[u][0] = f.x, x[u][1] = f.y, x[u][2] = f.z, x[u][3] = f.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = base + 32 * j + lane;
          x[u][j] = c < W ? __ldcs(v + c) : CUDART_INF_F;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < VLOADS; ++u) {
      const float least =
          fminf(fminf(x[u][0], x[u][1]), fminf(x[u][2], x[u][3]));
      if (!__any_sync(FULL, least <= thr)) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + u * VSTEP + (VEC ? 4 * lane + j : 32 * j + lane);
        const unsigned long long key = make_key(x[u][j], col);
        const bool finite = x[u][j] < CUDART_INF_F;  // not +inf, not NaN
        bool pass = finite && key < thr_key;
        unsigned b = __ballot_sync(FULL, pass);
        if (!b) continue;
        if (cnt + __popc(b) > cap) {  // full: keep k, tighten, test again
          prune(buf, cnt, thr_key, thr, k, lane);
          pass = finite && key < thr_key;
          b = __ballot_sync(FULL, pass);
        }
        if (pass) buf[cnt + __popc(b & ((1u << lane) - 1u))] = key;
        cnt += __popc(b);
      }
    }
  }
  prune(buf, cnt, thr_key, thr, k, lane);
  for (int t = lane; t < cnt; t += 32)
    write_winner(vals, ids, out_d, out_i, (size_t)row, W, k, t, buf[t]);
}

// Rows of at most 32 entries: one key per lane, sorted by shuffles.
__global__ void __launch_bounds__(VWARPS * 32)
topk_values_narrow_kernel(const float* __restrict__ vals,
                          const int* __restrict__ ids,
                          float* __restrict__ out_d, int* __restrict__ out_i,
                          int Q, int W, int k) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * VWARPS + warp;
  if (row >= Q) return;
  const float x = lane < W ? vals[(size_t)row * W + lane] : CUDART_INF_F;
  unsigned long long key = x < CUDART_INF_F ? make_key(x, lane) : PAD_KEY;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long other = __shfl_xor_sync(FULL, key, stride);
      const bool up = (lane & size) == 0, low = (lane & stride) == 0;
      key = (low == up) ? min(key, other) : max(key, other);
    }
  if (lane < k && key != PAD_KEY)
    write_winner(vals, ids, out_d, out_i, (size_t)row, W, k, lane, key);
}

}  // namespace vers

// cap: keys of a row's candidate buffer, a power of two >= k + 32.
extern "C" int vers_topk_values(const float* vals, const int* ids,
                                float* out_d, int* out_i, int Q, int W, int k,
                                int cap, void* stream) {
  using namespace vers;
  if (Q <= 0) return 0;
  if (k <= 0 || W <= 0 || cap < k + 32 || (cap & (cap - 1)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Q + VWARPS - 1) / VWARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (W <= 32) {
    topk_values_narrow_kernel<<<grid, VWARPS * 32, 0, st>>>(vals, ids, out_d,
                                                            out_i, Q, W, k);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)VWARPS * cap * sizeof(unsigned long long);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  auto kernel = vec ? topk_values_kernel<true> : topk_values_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, VWARPS * 32, smem, st>>>(vals, ids, out_d, out_i, Q, W, k, cap);
  return (int)cudaGetLastError();
}
