// The HNSW layer-0 inline beam's step (ops/beam_inline.inline_step) as
// one kernel: for every query at once, pick the best unexpanded beam
// entries, score their neighbours in the projected space from the
// inline table, drop the ids already seen, keep the best r and score
// those on their full-dim bf16 rows, and merge the result into the
// beam, which is updated in place.
//
// Replaces no Pallas kernel: the JAX package's step
// (vers_tpu/ops/beam_inline.py) is plain jnp code that XLA fuses on the
// TPU. The port ran it as ~50 PyTorch ops a step, each writing its
// intermediates, (Q, E*deg, dp) gathers and their f32 copies among them,
// to device memory.
//
// Bound on the H100: bytes. A query's step reads E inline rows of
// deg * dp bf16 (4 x 32 x 64: 16 KB), E adjacency rows (512 B), r
// full-dim bf16 rows (96 x 300: 57.6 KB) and its own state (~1.2 KB);
// at 16384 queries that is ~1.24 GB, 0.37 ms at 3.35 TB/s. Its
// arithmetic is ~2.6 MFLOP a query, far below the ridge, and every
// selection is over at most 1024 entries. So the design keeps every
// intermediate out of device memory and keeps loads in flight:
//  * One warp a query, eight queries a block; the warp's state, its
//    candidates and its full-dim query live in shared memory, its part
//    of the projected query in registers. A block takes 40 KB of shared
//    memory at the benchmark's widths and at most 181 KB at the widest
//    (ef 256, 512 candidates, all refined, d 1024): one block an SM.
//  * Picks: e rounds of a warp minimum over 64-bit keys (ordered value
//    bits, position), so ties go to the lower position as the stable
//    sorts of the plain step send them.
//  * Dedup: the candidates' ids and the beam's go into a hash table in
//    shared memory (shared-memory atomics: compare-and-swap for the
//    slot, minimum for the least column, -1 for the beam), so a
//    candidate is live iff its id's least column is its own: not in the
//    beam, not repeated at a lower column. Dropped candidates load
//    nothing.
//  * Projected dots: the E*deg candidates' dp-wide blocks as one flat
//    list of 16-byte chunks, lane j of load i taking chunk 32 i + j, so
//    each load instruction reads 512 contiguous bytes of one inline row.
//    A candidate's dp/8 chunks lie in dp/8 neighbouring lanes; the sums
//    of dp/8 loads are reduced across those lanes by a transposing
//    butterfly (dp/8 - 1 shuffles for dp/8 candidates), which leaves
//    every lane with one candidate's dot.
//  * Top-r and merge by a bitonic sort of 64-bit keys (ordered value
//    bits, position) in shared memory, padded to a power of two: keys
//    are distinct, so the sort orders as the plain step's stable sorts
//    do, ties to the lower position. A beam already in order (as every
//    merge leaves it) is not sorted again: the candidates are, and each
//    entry's rank in the merged order is its own index plus a binary
//    search of the other list.
//  * Full-dim dots: four rows at a time, the lanes striding along each
//    row by the widest load that the row pitch and the table's address
//    allow (16, 8, 4 or 2 bytes: 8 bytes for d = 300), three loads a
//    row a lane in flight (one of 16 bytes), the row sums reduced
//    across the warp by the same transposing butterfly.
// Products of two bf16 values are exact in f32, so the kernel and the
// plain step differ only in the order of their f32 sums.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace vers {
namespace beam {

constexpr int WARPS = 8;   // queries per block, one warp each
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NONE = ~0ull;

// Unsigned bits that rise with the float; -0.0 as +0.0, every NaN above
// +inf.
__device__ __forceinline__ unsigned order_bits(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned u = v == 0.f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool finite(float v) {
  return fabsf(v) < CUDART_INF_F;
}

// acc + the dot of N packed bf16 pairs, as exact f32 products.
template <int N>
__device__ __forceinline__ float dot_words(const unsigned (&x)[N],
                                           const unsigned (&q)[N], float acc) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(q[i] << 16), acc);
    acc = fmaf(__uint_as_float(x[i] & 0xffff0000u),
               __uint_as_float(q[i] & 0xffff0000u), acc);
  }
  return acc;
}

// VW bf16 values at p (aligned to 2 VW bytes) as packed words; VW == 1
// leaves the upper half zero.
template <int VW>
struct Chunk {
  static constexpr int N = VW >= 2 ? VW / 2 : 1;
  unsigned w[N];
  __device__ __forceinline__ void load(const unsigned short* p) {
    if constexpr (VW == 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (VW == 4) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x, w[1] = v.y;
    } else if constexpr (VW == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      w[0] = __ldg(p);
    }
  }
  // the same from shared memory
  __device__ __forceinline__ void load_shared(const unsigned short* p) {
    if constexpr (VW == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (VW == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else if constexpr (VW == 2) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      w[0] = *p;
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = 0u;
  }
};

// Sums R values across each aligned group of W lanes (R <= W, powers of
// two) and returns, in every lane, the group's sum of
// v[(lane / (W / R)) % R]: the first log2(R) levels of the butterfly
// halve the values each lane carries, the rest sum one.
template <int R, int W>
__device__ __forceinline__ float reduce_rows(float (&v)[R], int lane) {
#pragma unroll
  for (int n = R; n > 1; n >>= 1) {
    const int s = W * n / (2 * R);
    const bool upper = lane & s;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? v[i] : v[i + n / 2];
      const float keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, s);
    }
  }
  float x = v[0];
#pragma unroll
  for (int s = W / (2 * R); s >= 1; s >>= 1) x += __shfl_xor_sync(FULL, x, s);
  return x;
}

struct Args {
  float* beam_d;             // (Q, ef), updated in place
  long long* beam_i;         // (Q, ef)
  unsigned char* expanded;   // (Q, ef) bool
  const unsigned short* qp;  // (Q, dp) bf16 projected queries
  const unsigned short* qn;  // (Q, d) bf16 full-dim queries (r > 0)
  const int* adj;            // (n_pad, deg)
  const unsigned short* tab; // (n_pad, deg * dp) bf16 inline table
  const unsigned short* vecs;// (n_pad, d) bf16 full-dim rows (r > 0)
  unsigned char* active;     // 0-d bool, zero before the launch
  int Q, ef, e, deg, n_pad, r, d;
  int qwords, slots, words;  // shared words of the full-dim query, the
                             // table's slots, a warp's words
};

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// A warp's shared memory, in 4-byte words: the full-dim query (16-byte
// aligned); one region of `slots` 8-byte entries, first the dedup's hash
// table, then the sorts' keys; the beam (value, id, expanded); the
// picked rows; the live masks of the candidates; the candidates (id,
// value); the refined ones (id, value).
__host__ __device__ inline int query_words(int d) { return (d + 7) / 8 * 4; }
__host__ __device__ inline int table_slots(int ef, int e, int deg) {
  return pow2_at_least(ef + e * deg);
}
__host__ __device__ inline int warp_words(int ef, int e, int deg, int r,
                                          int d) {
  const int m = e * deg;
  return (query_words(d) + 2 * table_slots(ef, e, deg) + 3 * ef + e +
          (m + 31) / 32 + 2 * m + 2 * r + 3) / 4 * 4;
}

// Ascending bitonic sort of buf[0, n), n a power of two, by one warp.
__device__ inline void warp_sort(unsigned long long* buf, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < n / 2; i += 32) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long x = buf[lo], y = buf[hi];
        if ((x > y) == up) {
          buf[lo] = y;
          buf[hi] = x;
        }
      }
      __syncwarp();
    }
}

__device__ __forceinline__ unsigned long long sort_key(float v, int pos) {
  return ((unsigned long long)order_bits(v) << 32) | (unsigned)pos;
}

// The table's slot of `id` (>= 0), inserted if absent, its least column
// lowered to `col`: open addressing, Fibonacci hashing and linear probes
// over `slots` (a power of two >= 2, at least the distinct ids inserted).
__device__ __forceinline__ int insert(int* ids, int* cols, int slots, int id,
                                      int col) {
  int h = (int)(((unsigned)id * 2654435761u) >> (33 - __ffs(slots)));
  while (true) {
    const int prev = atomicCAS(ids + h, -1, id);
    if (prev == -1 || prev == id) {
      atomicMin(cols + h, col);
      return h;
    }
    h = (h + 1) & (slots - 1);
  }
}

// Writes an entry of the new beam at `at`: its distance, its id (-1
// where the distance is not finite) and its expanded flag. Returns
// whether it is still to expand.
__device__ __forceinline__ bool put(const Args& a, size_t at, float v, int id,
                                   int ex) {
  id = finite(v) ? id : -1;
  a.beam_d[at] = v;
  a.beam_i[at] = id;
  a.expanded[at] = (unsigned char)ex;
  return !ex && id >= 0;
}

template <int P, int VW>
__global__ void __launch_bounds__(WARPS * 32, 4) beam_step_kernel(Args a) {
  // full-dim rows scored at a time, and the loads along each of them a
  // lane issues at once (fewer with 16-byte loads, whose registers would
  // spill)
  constexpr int ROWS = 4;
  constexpr int UNROLL = VW == 8 ? 1 : 3;
  extern __shared__ __align__(16) unsigned smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= a.Q) return;  // no block-wide barrier below
  const int ef = a.ef, e = a.e, deg = a.deg, r = a.r, d = a.d;
  const int m = e * deg, n_c = r ? r : m, slots = a.slots;
  unsigned* base = smem + (size_t)warp * a.words;
  unsigned short* sq = reinterpret_cast<unsigned short*>(base);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(base + a.qwords);
  int* tab_ids = reinterpret_cast<int*>(keys);
  int* tab_cols = tab_ids + slots;
  float* bd = reinterpret_cast<float*>(keys + slots);
  int* bi = reinterpret_cast<int*>(bd + ef);
  int* be = bi + ef;
  int* rows = be + ef;
  unsigned* live = reinterpret_cast<unsigned*>(rows + e);
  int* cn = reinterpret_cast<int*>(live + (m + 31) / 32);
  float* cd = reinterpret_cast<float*>(cn + m);
  int* rn = r ? reinterpret_cast<int*>(cd + m) : cn;
  float* rd = r ? reinterpret_cast<float*>(rn + r) : cd;

  // 1. The state and the full-dim query into shared memory, this lane's
  //    chunk of the projected query into registers; the table emptied.
  const size_t row0 = (size_t)q * ef;
  for (int j = lane; j < ef; j += 32) {
    bd[j] = a.beam_d[row0 + j];
    bi[j] = (int)a.beam_i[row0 + j];
    be[j] = a.expanded[row0 + j];
  }
  if (r)
    for (int j = lane; j < d; j += 32) sq[j] = a.qn[(size_t)q * d + j];
  const int p = lane % P;
  Chunk<8> qv;
  qv.load(a.qp + (size_t)q * (P * 8) + p * 8);
  for (int j = lane; j < slots; j += 32) {
    tab_ids[j] = -1;
    tab_cols[j] = INT_MAX;
  }
  __syncwarp();

  // 2. Pick the e best unexpanded live entries, best first; mark them.
  for (int t = 0; t < e; ++t) {
    unsigned long long best = NONE;
    for (int j = lane; j < ef; j += 32)
      if (!be[j] && bi[j] >= 0 && bd[j] < CUDART_INF_F)
        best = min(best, sort_key(bd[j], j));
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1)
      best = min(best, __shfl_xor_sync(FULL, best, s));
    const int j = (int)(best & 0xffffffffu);
    const int row = best == NONE ? -1 : min(bi[j], a.n_pad - 1);
    if (lane == 0) {
      rows[t] = row;
      if (row >= 0) be[j] = 1;
    }
    __syncwarp();
  }

  // 3. The candidates' ids: the picked rows' neighbours, -1 past the picks;
  //    each id into the table with its column, the beam's ids with -1.
  for (int c = lane; c < m; c += 32) {
    const int t = c / deg;
    const int row = rows[t];
    const int id =
        row >= 0 ? __ldg(a.adj + (size_t)row * deg + (c - t * deg)) : -1;
    cn[c] = id;
    if (id >= 0) insert(tab_ids, tab_cols, slots, id, c);
  }
  for (int j = lane; j < ef; j += 32)
    if (bi[j] >= 0) insert(tab_ids, tab_cols, slots, bi[j], -1);
  __syncwarp();

  // 4. Dedup: a candidate is live if its id is no beam id and stands at
  //    no lower column, i.e. its id's least column is its own.
  for (int c0 = 0; c0 < m; c0 += 32) {
    const int c = c0 + lane;
    bool ok = false;
    if (c < m && cn[c] >= 0)
      ok = tab_cols[insert(tab_ids, tab_cols, slots, cn[c], c)] == c;
    const unsigned mask = __ballot_sync(FULL, ok);
    if (lane == 0) live[c0 / 32] = mask;
  }
  __syncwarp();

  // 5. Projected distances of the live candidates, +inf for the rest.
  for (int c0 = 0; c0 < m; c0 += 32) {
    const unsigned mask = live[c0 / 32];
    float v[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = c0 + i * (32 / P) + lane / P;
      Chunk<8> x;
      x.zero();
      if ((mask >> (c - c0)) & 1u) {
        const int t = c / deg;
        x.load(a.tab + ((size_t)rows[t] * deg + (c - t * deg)) * (P * 8) +
               p * 8);
      }
      v[i] = dot_words(x.w, qv.w, 0.f);
    }
    const float dot = reduce_rows<P, P>(v, lane);
    const int c = c0 + p * (32 / P) + lane / P;
    if (c < m) cd[c] = (mask >> (c - c0)) & 1u ? 1.f - dot : CUDART_INF_F;
  }
  __syncwarp();

  if (r) {
    // 6. The r best candidates by (projected distance, column), -1 where
    //    that distance is not finite ...
    const int n = pow2_at_least(m);
    for (int c = lane; c < n; c += 32)
      keys[c] = c < m ? sort_key(cd[c], c) : NONE;
    __syncwarp();
    warp_sort(keys, n, lane);
    for (int s = lane; s < r; s += 32) {
      const int c = (int)(keys[s] & 0xffffffffu);
      rn[s] = finite(cd[c]) ? cn[c] : -1;
    }
    __syncwarp();
    // ... and their exact distances on the full-dim rows.
    const int nch = d / VW;
    for (int s0 = 0; s0 < r; s0 += ROWS) {
      int ids[ROWS];
      float acc[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        ids[i] = s0 + i < r ? rn[s0 + i] : -1;
        ids[i] = min(ids[i], a.n_pad - 1);
        acc[i] = 0.f;
      }
      for (int u0 = lane; u0 < nch; u0 += 32 * UNROLL) {
        Chunk<VW> x[UNROLL][ROWS];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const int u = u0 + 32 * k;
            x[k][i].zero();
            if (u < nch && ids[i] >= 0)
              x[k][i].load(a.vecs + (size_t)ids[i] * d + u * VW);
          }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int u = u0 + 32 * k;
          if (u < nch) {
            Chunk<VW> qc;
            qc.load_shared(sq + u * VW);
#pragma unroll
            for (int i = 0; i < ROWS; ++i)
              acc[i] = dot_words(x[k][i].w, qc.w, acc[i]);
          }
        }
      }
      const float dot = reduce_rows<ROWS, 32>(acc, lane);
      const int i = lane / (32 / ROWS);
      if (lane % (32 / ROWS) == 0 && s0 + i < r)
        rd[s0 + i] = rn[s0 + i] >= 0 ? 1.f - dot : CUDART_INF_F;
    }
    __syncwarp();
  }

  // 7. Merge: the ef first of (beam, candidates) by (distance, position),
  //    -1 where the distance is not finite, expanded flags carried.
  bool act = false;
  bool sorted = true;
  for (int j = lane; j + 1 < ef; j += 32)
    sorted &= order_bits(bd[j]) <= order_bits(bd[j + 1]);
  if (__all_sync(FULL, sorted)) {
    // The beam is in order (as every merge leaves it): sort the
    // candidates alone and place each entry at its rank, its position
    // in its own list plus the entries of the other list before it.
    const int n = pow2_at_least(n_c);
    for (int s = lane; s < n; s += 32)
      keys[s] = s < n_c ? sort_key(rd[s], ef + s) : NONE;
    __syncwarp();
    warp_sort(keys, n, lane);
    for (int j = lane; j < ef; j += 32) {
      const unsigned long long key = sort_key(bd[j], j);
      int lo = 0, hi = n_c;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (keys[mid] < key) lo = mid + 1; else hi = mid;
      }
      if (j + lo < ef) act |= put(a, row0 + j + lo, bd[j], bi[j], be[j]);
    }
    for (int s = lane; s < n_c && s < ef; s += 32) {
      const unsigned long long key = keys[s];
      int lo = 0, hi = ef;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (sort_key(bd[mid], mid) < key) lo = mid + 1; else hi = mid;
      }
      const int c = (int)(key & 0xffffffffu) - ef;
      if (s + lo < ef) act |= put(a, row0 + s + lo, rd[c], rn[c], 0);
    }
  } else {
    const int n = pow2_at_least(ef + n_c);
    for (int j = lane; j < n; j += 32)
      keys[j] = j < ef ? sort_key(bd[j], j)
                : j < ef + n_c ? sort_key(rd[j - ef], j) : NONE;
    __syncwarp();
    warp_sort(keys, n, lane);
    for (int t = lane; t < ef; t += 32) {
      const int pos = (int)(keys[t] & 0xffffffffu);
      act |= pos < ef ? put(a, row0 + t, bd[pos], bi[pos], be[pos])
                      : put(a, row0 + t, rd[pos - ef], rn[pos - ef], 0);
    }
  }
  if (__any_sync(FULL, act) && lane == 0) *a.active = 1;
}

template <int P, int VW>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const size_t smem = (size_t)WARPS * a.words * 4;
  cudaError_t err = cudaFuncSetAttribute(
      beam_step_kernel<P, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  beam_step_kernel<P, VW><<<(a.Q + WARPS - 1) / WARPS, WARPS * 32, smem, st>>>(
      a);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_vw(const Args& a, int vw, cudaStream_t st) {
  switch (vw) {
    case 8: return launch<P, 8>(a, st);
    case 4: return launch<P, 4>(a, st);
    case 2: return launch<P, 2>(a, st);
    case 1: return launch<P, 1>(a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace beam
}  // namespace vers

// One step for Q queries. dp in {32, 64}; 1 <= e <= ef <= 256;
// e * deg <= 512; 0 <= r <= e * deg; with r > 0, 1 <= d <= 1024 and vw
// (bf16 values a full-dim load takes: 8, 4, 2 or 1) dividing d with the
// table's address aligned to 2 vw bytes; qp and the inline table 16-byte
// aligned. `active` must hold 0: the kernel stores 1 there if some query
// has an unexpanded finite entry after the step.
extern "C" int vers_beam_step(float* beam_d, long long* beam_i,
                              unsigned char* expanded, const void* qp,
                              const void* qn, const int* adj, const void* tab,
                              const void* vecs, unsigned char* active, int Q,
                              int ef, int e, int deg, int n_pad, int dp, int r,
                              int d, int vw, void* stream) {
  using namespace vers::beam;
  if (Q <= 0) return 0;
  const int m = e * deg;
  if ((dp != 32 && dp != 64) || e < 1 || e > ef || ef > 256 || deg < 1 ||
      m > 512 || r < 0 || r > m || n_pad < 1)
    return (int)cudaErrorInvalidValue;
  if (r && (d < 1 || d > 1024 || (vw != 8 && vw != 4 && vw != 2 && vw != 1) ||
            d % vw))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.beam_d = beam_d, a.beam_i = beam_i, a.expanded = expanded;
  a.qp = static_cast<const unsigned short*>(qp);
  a.qn = static_cast<const unsigned short*>(qn);
  a.adj = adj;
  a.tab = static_cast<const unsigned short*>(tab);
  a.vecs = static_cast<const unsigned short*>(vecs);
  a.active = active;
  a.Q = Q, a.ef = ef, a.e = e, a.deg = deg, a.n_pad = n_pad, a.r = r;
  a.d = r ? d : 0;
  if (!r) vw = 1;
  a.qwords = query_words(a.d);
  a.slots = table_slots(ef, e, deg);
  a.words = warp_words(ef, e, deg, r, a.d);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dp == 64 ? launch_vw<8>(a, vw, st) : launch_vw<4>(a, vw, st));
}
