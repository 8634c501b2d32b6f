// Kernel F: the binned search's cross-probe merge. Each query's top k
// over the rows kernel B wrote for its live probe ranks, in one launch.
//
// Replaces no TPU kernel: the JAX package unsorts the scan's rows, masks
// gated ranks and folds the p ranks of k candidates with batched rank
// selects (vers_tpu/ops/binned.py merge_probe_results), plain jnp that
// XLA fuses. The port ran the same ops eagerly (``rank_merge_plain``):
// at the adaptive walk's depth (p = 263 on a 2048-list index with 263
// empty lists, Q = 16384, k = 10) it materialised 43M candidates and
// ~(Q p / 2) (2k)^2 compares a round, ~37.6 ms a call on the H100,
// though a query has one or two live ranks: gated ranks carry the
// sentinel bin num_bins and all-+inf rows.
//
// Bound on the H100: bytes. A query needs its p probe flags (int64) and,
// for each live rank, one entry of the inverse pair order and the k
// (distance, id) entries of that rank's row, and writes k results: at
// the adaptive depth ~35 MB of flags and ~2 MB of live rows, ~0.01 ms
// at 3.35 TB/s. There is no arithmetic to speak of, so the design keeps
// every load a query needs in flight at once and reads nothing else:
//  * One warp per query, eight to a block. A lane loads the flags of 4
//    ranks, 32 apart (128 ranks a round, coalesced 8-byte loads), and a
//    ballot per 32 ranks finds the live ones; a chunk of 32 ranks with
//    none costs a load and a ballot. The ranks need not be gated as a
//    suffix (a shard of the sharded IVF gates clusters it does not own).
//  * The live ranks of a chunk are compacted into shared memory (their
//    stacked row, inv[r Q + q], loaded by the lane that found the rank,
//    all at once), then the warp reads their n k entries as one flat
//    range, four entries a lane in flight.
//  * Candidates are kernel C's 64-bit keys (topk_keys.cuh) with the
//    column r k + j of entry j of rank r: equal values go to the lower
//    column, the order the plain merge's rank selects and stable sort
//    give (-0.0 keyed as +0.0, as they compare equal). An entry passes if
//    it is finite and its key is below the current k-th key; passing keys
//    go to the warp's buffer of cap keys, pruned by a bitonic sort when
//    full, so a query whose nearest lists are all empty or short, with
//    all 263 ranks live, streams them through the same threshold.
//  * The winners' distances are written with their own bits (read again
//    at their columns), their ids from kernel B's ids, or mapped through
//    the padded corpus's row ids; slots past the finite candidates are
//    (+inf, -1). Kernel B never writes -inf or NaN distances for finite
//    rows; where they arise the plain merge's paths treat them
//    differently from one another, and this kernel drops them.
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "topk_keys.cuh"

namespace vers {
namespace rmerge {

constexpr int FWARPS = 8;   // queries per block, one warp each
constexpr int FLAGS = 4;    // probe flags a lane loads at once
constexpr int FLOADS = 4;   // candidate entries a lane loads at once
constexpr unsigned FULL = 0xffffffffu;

template <bool MAP_IDS>
__global__ void __launch_bounds__(FWARPS * 32)
rank_merge_kernel(const float* __restrict__ res_d,
                  const int* __restrict__ res_i,
                  const long long* __restrict__ inv,
                  const long long* __restrict__ probes,
                  const int* __restrict__ s2o, float* __restrict__ out_d,
                  int* __restrict__ out_i, int Q, int p, int stride, int k,
                  int cap, int num_bins) {
  extern __shared__ unsigned long long keys[];
  __shared__ long long live_row[FWARPS][32];
  __shared__ int live_rank[FWARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = blockIdx.x * FWARPS + warp;
  if (q >= Q) return;  // no block-wide barrier below
  unsigned long long* buf = keys + (size_t)warp * cap;
  long long* rows = live_row[warp];
  int* ranks = live_rank[warp];
  const long long* flags = probes + (size_t)q * stride;
  int cnt = 0;
  unsigned long long thr_key = PAD_KEY;
  float thr = CUDART_INF_F;

  for (int r0 = 0; r0 < p; r0 += 32 * FLAGS) {
    bool live[FLAGS];
#pragma unroll
    for (int u = 0; u < FLAGS; ++u) {
      const int r = r0 + 32 * u + lane;
      live[u] = r < p && __ldcs(flags + r) < (long long)num_bins;
    }
#pragma unroll
    for (int u = 0; u < FLAGS; ++u) {
      const unsigned m = __ballot_sync(FULL, live[u]);
      if (!m) continue;
      if (live[u]) {
        const int r = r0 + 32 * u + lane, s = __popc(m & ((1u << lane) - 1u));
        rows[s] = inv[(size_t)r * Q + q];
        ranks[s] = r;
      }
      __syncwarp();
      const int n = __popc(m) * k;  // entries of the chunk's live rows
      for (int t0 = 0; t0 < n; t0 += 32 * FLOADS) {
        float v[FLOADS];
        int col[FLOADS];
#pragma unroll
        for (int w = 0; w < FLOADS; ++w) {
          const int t = t0 + 32 * w + lane;
          v[w] = CUDART_INF_F;
          col[w] = 0;
          if (t < n) {
            const int s = t / k, j = t - s * k;
            v[w] = res_d[rows[s] * k + j];
            col[w] = ranks[s] * k + j;
          }
        }
#pragma unroll
        for (int w = 0; w < FLOADS; ++w) {
          if (!__any_sync(FULL, v[w] <= thr)) continue;
          const unsigned long long key = make_key(v[w], col[w]);
          const bool finite = fabsf(v[w]) < CUDART_INF_F;  // not NaN either
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
      __syncwarp();  // the next chunk rewrites rows and ranks
    }
  }
  prune(buf, cnt, thr_key, thr, k, lane);
  for (int t = lane; t < k; t += 32) {
    float v = CUDART_INF_F;
    int id = -1;
    if (t < cnt) {
      const unsigned c = (unsigned)(buf[t] & 0xffffffffu);
      const unsigned r = c / (unsigned)k, j = c - r * (unsigned)k;
      const size_t at = (size_t)inv[(size_t)r * Q + q] * k + j;
      v = res_d[at];
      const int pos = res_i[at];
      id = pos < 0 ? -1 : (MAP_IDS ? s2o[pos] : pos);
    }
    out_d[(size_t)q * k + t] = v;
    out_i[(size_t)q * k + t] = id;
  }
}

}  // namespace rmerge
}  // namespace vers

// res_d, res_i: kernel B's (rows, k) results over the stacked pairs; inv:
// (p Q,) int64, the stacked row of pair (rank r, query q) at r Q + q;
// probes: (Q, p) int64 rows `stride` apart (the probe stage's top-p is a
// slice of a wider sort), num_bins where a rank is gated; s2o: the padded
// corpus's row ids (int32) when ids are padded positions, else null;
// out_d, out_i: (Q, k). cap: keys of a query's candidate buffer, a power
// of two in [k + 32, 512].
extern "C" int vers_rank_merge(const float* res_d, const int* res_i,
                               const long long* inv, const long long* probes,
                               const int* s2o, float* out_d, int* out_i, int Q,
                               int p, int stride, int k, int cap, int num_bins,
                               void* stream) {
  using namespace vers::rmerge;
  if (Q <= 0) return 0;
  if (k <= 0 || k > 128 || p <= 0 || stride < p || cap < k + 32 ||
      cap > 512 || (cap & (cap - 1)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Q + FWARPS - 1) / FWARPS);
  // at most 8 x 512 keys: 32 KB, under the 48 KB a launch takes unasked
  const size_t smem = (size_t)FWARPS * cap * sizeof(unsigned long long);
  cudaStream_t st = (cudaStream_t)stream;
  if (s2o)
    rank_merge_kernel<true><<<grid, FWARPS * 32, smem, st>>>(
        res_d, res_i, inv, probes, s2o, out_d, out_i, Q, p, stride, k, cap,
        num_bins);
  else
    rank_merge_kernel<false><<<grid, FWARPS * 32, smem, st>>>(
        res_d, res_i, inv, probes, s2o, out_d, out_i, Q, p, stride, k, cap,
        num_bins);
  return (int)cudaGetLastError();
}
