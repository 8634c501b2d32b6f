// Kernel B: the IVF packed binned scan.
//
// Replaces vers_tpu/ops/pallas_binned.py:pallas_packed_scan (body
// _kernel, merge _merge_topk(ids=...)). Work item w pairs query block
// qb[w] (q_blk bin-sorted query rows) with corpus group gb[w] (r_blk
// group-major rows). A query is scored only against rows of its own bin.
// The TPU grid runs the items in order and carries a query block's best
// set in VMEM across the CONSECUTIVE items that share its qb: init on
// the first visit, flush on the last.
//
// Hopper blocks run in no order, so the carry cannot cross blocks. A
// unit is (work item w, 64-row part y of its query block); block i of
// the grid takes one unit. Two walks share every step below the unit:
//  * The run walk. Block (w, y) returns at once unless item w is the
//    first of its run of equal qb; the first block owns the run for query
//    rows [qb * q_blk + 64 y, + 64): it walks the run's groups in item
//    order and writes the part's best sets once at the end.
//  * The split walk. Block (w, y), whichever item of its run w is,
//    walks group gb[w] alone and writes only the part's rows whose bins
//    lie in the group's bin range (its rows' lowest and highest bin);
//    without such a row it returns at once. The rows are
//    bin-sorted, so these form one slice; bins lie whole in one group and
//    the ranges of groups are disjoint, so no two blocks write one row. A
//    row's best set only ever takes entries of its own bin, met in the
//    same tiles in the same order either way, so the two walks agree bit
//    for bit, with no carry across blocks and no merge pass.
// The rule (ops/cuda_binned.split_walk, from shapes and the card's SM
// count, so a CUDA graph captures one walk): the split walk when the run
// walk's units, (stacked rows / q_blk) x parts, are fewer than the SMs.
// There one query block spans nearly every list (64 queries at nprobe 2:
// 128 pairs, one block), and two blocks would walk every group of its run
// one after the other; the split walk gives each group of the run its own
// block. Where runs are short and blocks many, the run walk keeps one
// query tile across a run's groups. Timed on the H100 (1M x 300, 2048
// lists, nprobe 1 and 2): the split walk wins up to 130 units (1.07x to
// 37x), at 258 units either walk wins by ~10% as the probes fall (the
// run walk's longest run, which shapes do not show), and at 514 the run
// walk wins by 8%; the edge stays at the SM count.
// Output rows no block writes keep the (+inf, -1) the wrapper fills them
// with (padding, gated ranks, and in the split walk empty lists).
// Invalid work items all park on one scratch query block whose rows are
// padding (qbin < 0); a block whose query rows are all padding returns.
//
// Bound on the H100: bytes. Each probed bin's rows are needed once
// (1.2 GB at nprobe 2 of the 1M x 300 layout: 0.37 ms at 3.35 TB/s),
// the products that count are few (every stacked row against its own
// bin: 2.8e10 tf32 flop, 0.06 ms). What the kernel issues is more: a
// tile is a 64 x 128 product whatever the bins of its rows, and 64
// bin-sorted query rows span several bins, so most of a tile is masked
// (the share comes from the tiles each block reports, `walked`). The
// design, with the pieces of kernel A (distance_tile.cuh):
//  * Products on the tensor cores: wgmma m64n64k8 tf32 in the 3xTF32
//    split, f32 accurate. wgmma's 64-row tile was taken over mma.sync's
//    16-row fragments, which could skip fragments whose bins miss a
//    tile: kernel A's history on this card has the wgmma route more
//    than twice as fast per issued product, which is about what the
//    finer skipping would save.
//  * The 64 query rows stay resident in shared memory for the whole run
//    (as f32; split into A fragments in registers per slice), where they
//    were re-read and re-transposed for every chunk.
//  * Before any product the block lists the live tiles of its walk: in
//    the run walk a tile is live if one of its rows has a bin inside the
//    part's [lowest, highest] query bin, in the split walk if one of its
//    rows has the bin of one of the rows the block writes (a binary
//    search over their ascending bins); skipping the others only drops
//    +inf candidates. One warp tests a tile, twelve tiles a round.
//  * Half of the producer warpgroup (two warps) streams the live tiles'
//    128 x 32 slices by TMA (cp.async when rows are not 16-byte aligned)
//    through a ring of three slots on mbarriers, splits each landed slice
//    into tf32 hi and lo and stages the tile's bins and |x|^2; two
//    consumer warpgroups multiply 64 corpus rows each while the next
//    slices land.
//  * Filter, then merge: at a tile's end a consumer keeps an entry only
//    if its row's bin equals the query's and its distance beats the
//    query's current k-th (a bit per entry, atomicOr only sets bits).
//    The other half of the producer warpgroup merges, one thread per
//    query row: the set bits in ascending row order by strict-less
//    insertion, so carried entries win ties, then the lower padded row,
//    as in the TPU kernel. A query meets its bin's first tile with no
//    k-th yet, so every row of it is a candidate: such a merge takes as
//    long as a tile's products, and runs beside the next tile's instead
//    of holding the ring. Best sets hold padded positions; the ids are
//    gathered once at the flush.
//  * One block per SM (the ring and the resident tile fill its shared
//    memory), so the hardware hands a free SM the next block, and two
//    small kernels ahead of the scan order the blocks by the corpus
//    rows they will test, heaviest first: the SMs end closer together,
//    where 514 blocks all resident at once ended with the SM that drew
//    the longest runs. In the split walk each unit is costed by its own
//    group alone.
// The kernel is deterministic: a repeat call is bit-identical. Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md) at nprobe 2: 1.49 ms,
// of which the loads and handshakes alone take 0.77 ms, the hi/lo split
// 0.18, the products 0.18 and filter and merge 0.35, one after the other
// (a ring of three leaves no slack to hide them); 81% of the products
// issued are masked.
#include <climits>
#include <cstdint>

#include "distance_tile.cuh"

namespace vers {
namespace pscan {

using namespace dtk;

constexpr int RING = 3;             // slots in the ring of staged slices
constexpr int LIST = 512;           // live tiles listed per batch
constexpr int WARPS = THREADS / 32;  // tiles tested per round
constexpr int SPLITTERS = 64;  // of the producer warpgroup: load and split
constexpr int MERGERS = PRODUCERS - SPLITTERS;  // ... and merge, one a row
constexpr int SUNITS = SLICE / 4 / SPLITTERS;   // 16-byte units a splitter
constexpr int KREG = 16;  // best sets up to this k merge in registers
constexpr unsigned FULL = 0xffffffffu;
static_assert(MERGERS == QT, "one merger thread per query row");
static_assert(CT % SPLITTERS == 0, "splitters stage a tile's rows evenly");

// Without TMA: features [k0, k0 + DK) of corpus rows [g0, g0 + CT) into
// the slice dst by 4-byte cp.async, rows >= r_end and features >= d as
// zeros. Splitter p copies the 16-byte units that it splits, so its own
// cp.async.wait_group is enough before it converts them.
__device__ inline void copy_units(float* dst, const float* __restrict__ x,
                                  long long g0, long long r_end, int d, int k0,
                                  int p) {
#pragma unroll
  for (int i = 0; i < SUNITS; ++i) {
    const int u = i * SPLITTERS + p, r = u / 8;
    const int c = k0 + ((u % 8) ^ (r % 8)) * 4;  // the unit's first feature
    for (int e = 0; e < 4; ++e) {
      const bool ok = g0 + r < r_end && c + e < d;
      cp_async4(dst + u * 4 + e, ok ? x + (g0 + r) * d + c + e : x, ok);
    }
  }
}

// Byte offsets into the dynamic shared memory (from a 1024-byte aligned
// base): kernel A's layout (ring of slices and their lo parts, resident
// query tile, distance tile, candidate masks, norms, kth distances), then
// per ring slot the tile's |x|^2 and bins, the query rows' bins, the list
// of live tiles, the round's candidates, the block's state, the
// mbarriers and the best sets.
struct Layout {
  int qp;
  size_t xs, lo, qs, dist, mask, qq, kth, xx, rbin, qbin, list, cand, state,
      bar, bd, bi, bytes;
};

// state words
enum { BIN_LO, BIN_HI, ROW_LO, ROW_HI, N_LIST, NEXT, DONE, N_STATE };

__host__ __device__ inline Layout make_layout(int d, int k, bool resident) {
  Layout L;
  const int d8 = (d + 7) / 8 * 8;
  L.qp = resident ? (d8 % 16 ? d8 : d8 + 8) : 0;
  size_t o = 0;
  L.xs = o;
  o += (size_t)RING * SLICE * sizeof(float);
  L.lo = o;
  o += (size_t)RING * SLICE * sizeof(float);
  L.qs = o;
  o += (size_t)QT * L.qp * sizeof(float);
  L.dist = o;
  o += (size_t)QT * DP * sizeof(float);
  L.mask = o;
  o += (size_t)QT * MASKW * sizeof(unsigned);
  L.qq = o;
  o += QT * sizeof(float);
  L.kth = o;
  o += QT * sizeof(float);
  L.xx = o;
  o += (size_t)RING * CT * sizeof(float);
  L.rbin = o;
  o += (size_t)RING * CT * sizeof(int);
  L.qbin = o;
  o += QT * sizeof(int);
  L.list = o;
  o += LIST * sizeof(int);
  L.cand = o;
  o += WARPS * sizeof(int);
  L.state = o;
  o += N_STATE * sizeof(int);
  o = (o + 7) / 8 * 8;
  L.bar = o;
  o += (size_t)(3 * RING + 2) * sizeof(uint64_t);
  L.bd = o;
  o += (size_t)k * QT * sizeof(float);
  L.bi = o;
  o += (size_t)k * QT * sizeof(int);
  L.bytes = o + 1024;  // room to align the base
  return L;
}

// Merge the candidates of query row r (bits of mask, values in dist)
// into its best set held in registers, sorted ascending over slots
// [0, k), k <= KREG (later slots are scratch). Candidates come in
// ascending column order and enter only on a strictly smaller distance
// than the k-th, behind any equal value: carried entries win ties, then
// the lower row. Clears the row's bits; kth is the set's k-th distance.
template <int KREG>
__device__ inline void merge_row_regs(int r, unsigned* mask, const float* dist,
                                      float (&bv)[KREG], int (&bp)[KREG], int k,
                                      float& kth, int row0) {
  for (int w = 0; w < MASKW; ++w) {
    unsigned bits = mask[r * MASKW + w];
    if (!bits) continue;
    mask[r * MASKW + w] = 0;
    while (bits) {
      const int c = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      const float v = dist[r * DP + c];
      if (!(v < kth)) continue;
#pragma unroll
      for (int j = KREG - 1; j >= 0; --j) {
        if (bv[j] <= v) continue;  // stays; so does every slot before it
        const bool here = j == 0 || bv[j > 0 ? j - 1 : 0] <= v;
        bv[j] = here ? v : bv[j > 0 ? j - 1 : 0];
        bp[j] = here ? row0 + c : bp[j > 0 ? j - 1 : 0];
      }
#pragma unroll
      for (int j = 0; j < KREG; ++j)
        if (j == k - 1) kth = bv[j];
    }
  }
}

// Whether the ascending s[0, n) holds v.
__device__ inline bool holds(const int* s, int n, int v) {
  int lo = 0, hi = n;  // the first index with s[i] >= v
  while (lo < hi) {
    const int m = (lo + hi) / 2;
    if (s[m] < v)
      lo = m + 1;
    else
      hi = m;
  }
  return lo < n && s[lo] == v;
}

// The lowest and highest of a warp's lo and hi.
__device__ inline void warp_range(int& lo, int& hi) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, off));
    hi = max(hi, __shfl_xor_sync(FULL, hi, off));
  }
}

// Split 16-byte unit u of a landed slice in place to its tf32 hi part
// and write its lo part to lo (same layout).
__device__ inline void split_unit(float* xs, float* lo, int u) {
  const float4 v = *reinterpret_cast<const float4*>(xs + u * 4);
  uint4 h, l;
  split3(v.x, h.x, l.x);
  split3(v.y, h.y, l.y);
  split3(v.z, h.z, l.z);
  split3(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(xs + u * 4) = h;
  *reinterpret_cast<uint4*>(lo + u * 4) = l;
}

// The plan: heavy blocks first. A block is handed to an SM as one falls
// free, so blocks taken in the order of the work list leave the SMs that
// drew long runs late working alone at the end. A unit is (work item,
// 64-row part of its query block), unit = item * parts + part.
// plan_cost_kernel gives each working unit the count of corpus rows it
// will test, one warp a unit, and 0 to the units that return at once:
// in the run walk, the rows its run holds inside the part's bin range
// (units of a run's first item only); in the split walk, the rows of its
// own group whose bins are those of the part's rows in the group.
// plan_order_kernel sorts the units by (cost descending, unit) in one
// block, and block i of the scan takes unit order[i].
constexpr int PLAN_MAX = 4096;  // units one block sorts in shared memory
constexpr int PLAN_WARPS = 8;

__global__ void __launch_bounds__(PLAN_WARPS * 32)
plan_cost_kernel(const int* __restrict__ qbin, const int* __restrict__ qb,
                 const int* __restrict__ gb, const int* __restrict__ rbin,
                 unsigned long long* __restrict__ keys, int n_rows, int W,
                 int parts, int q_blk, int r_blk, int split) {
  const int u = blockIdx.x * PLAN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (u >= W * parts) return;
  const int w = u / parts, y0 = (u % parts) * QT;
  const int block = qb[w];
  const int row0 = block * q_blk + y0;
  const int nq = min(min(QT, q_blk - y0), n_rows - row0);
  unsigned cost = 0;
  if (split) {
    // the group's bin range, then the part's rows [s0, s1) inside it
    const int* rb = rbin + (size_t)gb[w] * r_blk;
    int lo = INT_MAX, hi = -1;
    for (int c = lane; c < r_blk; c += 32)
      if (rb[c] >= 0) lo = min(lo, rb[c]), hi = max(hi, rb[c]);
    warp_range(lo, hi);
    int s0 = INT_MAX, s1 = -1;
    for (int r = lane; r < nq; r += 32) {
      const int b = qbin[row0 + r];
      if (b >= lo && b <= hi) s0 = min(s0, r), s1 = max(s1, r + 1);
    }
    warp_range(s0, s1);
    if (s0 < s1)
      for (int c = lane; c < r_blk; c += 32)
        cost += holds(qbin + row0 + s0, s1 - s0, rb[c]);
  } else if (w == 0 || qb[w - 1] != block) {
    int lo = INT_MAX, hi = -1;
    for (int r = lane; r < nq; r += 32) {
      const int b = qbin[row0 + r];
      if (b >= 0) lo = min(lo, b), hi = max(hi, b);
    }
    warp_range(lo, hi);
    if (hi >= 0)
      for (int v = w; v < W && qb[v] == block; ++v) {
        const int* rb = rbin + (size_t)gb[v] * r_blk;
        for (int c = lane; c < r_blk; c += 32) cost += rb[c] >= lo && rb[c] <= hi;
      }
  }
  for (int off = 16; off > 0; off >>= 1)
    cost += __shfl_xor_sync(FULL, cost, off);
  if (lane == 0)
    keys[u] = ((unsigned long long)(0xffffffffu - cost) << 32) | (unsigned)u;
}

__global__ void __launch_bounds__(1024)
plan_order_kernel(const unsigned long long* __restrict__ keys,
                  int* __restrict__ order, int units, int n) {
  extern __shared__ unsigned long long sorted[];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    sorted[i] = i < units ? keys[i] : ~0ull;
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = sorted[lo], b = sorted[hi];
        if ((a > b) == up) {
          sorted[lo] = b;
          sorted[hi] = a;
        }
      }
      __syncthreads();
    }
  for (int i = threadIdx.x; i < units; i += blockDim.x)
    order[i] = (int)(sorted[i] & 0xffffffffu);
}

// SPLIT: the split walk, else the run walk (a template parameter, so the
// run walk carries none of the split walk's tests)
template <bool RESIDENT, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
packed_scan_kernel(const __grid_constant__ CUtensorMap map,
                   const float* __restrict__ q_stack,
                   const int* __restrict__ qbin, const int* __restrict__ qb,
                   const int* __restrict__ gb, const float* __restrict__ corpus,
                   const int* __restrict__ rbin, const float* __restrict__ xx,
                   const int* __restrict__ ids, float* __restrict__ out_d,
                   int* __restrict__ out_i, const int* __restrict__ order,
                   int* __restrict__ walked, int n_rows, int n_corpus, int d, int W, int q_blk,
                   int r_blk, int k, int cosine, int tma) {
  // unit = item * parts + 64-row part, in the plan's order
  const int parts = (q_blk + QT - 1) / QT;
  const int unit = order ? order[blockIdx.x] : blockIdx.x;
  const int w = unit / parts;
  const int block = qb[w];
  if (!SPLIT && w > 0 && qb[w - 1] == block) return;  // not the first visit
  const int y0 = (unit % parts) * QT;
  const int row0 = block * q_blk + y0;
  const int nq = min(min(QT, q_blk - y0), n_rows - row0);
  if (nq <= 0) return;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const Layout L = make_layout(d, k, RESIDENT);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* lo = reinterpret_cast<float*>(smem + L.lo);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* dist = reinterpret_cast<float*>(smem + L.dist);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + L.mask);
  float* qq = reinterpret_cast<float*>(smem + L.qq);
  float* kth = reinterpret_cast<float*>(smem + L.kth);
  float* xxs = reinterpret_cast<float*>(smem + L.xx);
  int* rbs = reinterpret_cast<int*>(smem + L.rbin);
  int* qbins = reinterpret_cast<int*>(smem + L.qbin);
  int* list = reinterpret_cast<int*>(smem + L.list);
  int* cand = reinterpret_cast<int*>(smem + L.cand);
  int* state = reinterpret_cast<int*>(smem + L.state);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // TMA landed
  uint64_t* ready = full + RING;   // split, for the consumers
  uint64_t* empty = ready + RING;  // consumed, for a refill
  uint64_t* filtered = empty + RING;  // a tile's candidates, for the merge
  uint64_t* merged = filtered + 1;  // ... merged: kth, dist, mask free
  float* bd = reinterpret_cast<float*>(smem + L.bd);
  int* bi = reinterpret_cast<int*>(smem + L.bi);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the block's query bins; all padding: nothing to do
  const int my_bin = tid < nq ? qbin[row0 + tid] : -1;
  if (tid < QT) qbins[tid] = my_bin;
  if (!__syncthreads_or(my_bin >= 0)) return;

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&ready[i], SPLITTERS);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_init(filtered, CONSUMERS);
    mbar_init(merged, MERGERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    state[BIN_LO] = INT_MAX;
    state[BIN_HI] = -1;
    state[ROW_LO] = INT_MAX;
    state[ROW_HI] = -1;
    state[NEXT] = 0;
    state[DONE] = 0;
  }
  __syncthreads();
  if (SPLIT) {
    // the group's bin range (the lowest and highest bin of its rows),
    // then the rows of the part inside it: none, nothing to do
    const int* rg = rbin + (size_t)gb[w] * r_blk;
    int g_lo = INT_MAX, g_hi = -1;
    for (int c = tid; c < r_blk; c += THREADS)
      if (rg[c] >= 0) g_lo = min(g_lo, rg[c]), g_hi = max(g_hi, rg[c]);
    warp_range(g_lo, g_hi);
    if (lane == 0) {
      atomicMin(&state[BIN_LO], g_lo);
      atomicMax(&state[BIN_HI], g_hi);
    }
    __syncthreads();
    const bool mine = my_bin >= state[BIN_LO] && my_bin <= state[BIN_HI];
    if (mine) {
      atomicMin(&state[ROW_LO], tid);
      atomicMax(&state[ROW_HI], tid);
    }
    if (!__syncthreads_or(mine)) return;
  } else if (my_bin >= 0) {
    atomicMin(&state[BIN_LO], my_bin);
    atomicMax(&state[BIN_HI], my_bin);
  }
  const float* qt = q_stack + (size_t)row0 * d;
  // the resident tile stores features 8j + t, 8j + t + 4 at 8j + 2t, + 1
  if (RESIDENT) {
    for (int e = tid; e < QT * L.qp; e += THREADS) {
      const int r = e / L.qp, p = e % L.qp;
      const int c = (p & ~7) + (p & 7) / 2 + 4 * (p & 1);
      qs[e] = (r < nq && c < d) ? qt[(size_t)r * d + c] : 0.f;
    }
  }
  for (int r = warp; r < QT; r += WARPS) {
    float a = 0.f;
    if (r < nq)
      for (int c = lane; c < d; c += 32) {
        const float v = qt[(size_t)r * d + c];
        a = fmaf(v, v, a);
      }
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(FULL, a, off);
    if (lane == 0) {
      qq[r] = a;
      kth[r] = CUDART_INF_F;
    }
  }
  for (int e = tid; e < k * QT; e += THREADS) {
    bd[e] = CUDART_INF_F;
    bi[e] = -1;
  }
  for (int e = tid; e < QT * MASKW; e += THREADS) mask[e] = 0u;
  __syncthreads();
  // the rows the block writes, [s0, s1), and the bins a live tile holds:
  // every row of the part and its bin range (the run walk), or the
  // part's rows in the group, whose ascending bins a tile is tested
  // against exactly (the split walk)
  const int s0 = SPLIT ? state[ROW_LO] : 0;
  const int s1 = SPLIT ? state[ROW_HI] + 1 : nq;
  const int bin_lo = SPLIT ? qbins[s0] : state[BIN_LO];
  const int bin_hi = SPLIT ? qbins[s1 - 1] : state[BIN_HI];
  const int v_end = SPLIT ? w + 1 : W;  // past the walk's last item

  const int ntile = (r_blk + CT - 1) / CT;  // tiles per group
  const int nk = (d + DK - 1) / DK;         // slices per tile
  const int d8 = (d + 7) / 8 * 8;           // MMA depth
  int g_slices = 0, g_tiles = 0;  // slices and tiles of the batches so far

  for (;;) {
    // -- list the next batch of live tiles, in item and row order ----
    if (tid == 0) state[N_LIST] = 0;
    __syncthreads();
    for (;;) {
      const int e = state[NEXT] + warp;  // this warp's candidate tile
      const int v = w + e / ntile;
      int base = -2;  // past the walk's end
      if (v < v_end && qb[v] == block) {
        const int c0 = (e % ntile) * CT;
        const long long b0 = (long long)gb[v] * r_blk + c0;
        const int nx = min(CT, r_blk - c0);
        bool hit = false;
        for (int c = lane; c < nx; c += 32) {
          const int rb = rbin[b0 + c];
          hit |= rb >= bin_lo && rb <= bin_hi &&
                 (!SPLIT || holds(qbins + s0, s1 - s0, rb));
        }
        base = __any_sync(FULL, hit) ? (int)b0 : -1;
      }
      if (lane == 0) cand[warp] = base;
      __syncthreads();
      if (tid == 0) {
        int n = state[N_LIST];
        for (int i = 0; i < WARPS; ++i) {
          if (cand[i] == -2) {
            state[DONE] = 1;
            break;
          }
          if (cand[i] >= 0) list[n++] = cand[i];
        }
        state[N_LIST] = n;
        state[NEXT] += WARPS;
      }
      __syncthreads();
      if (state[DONE] || state[N_LIST] + WARPS > LIST) break;
    }
    const int n_list = state[N_LIST];
    const bool last = state[DONE] != 0;
    const int nsteps = n_list * nk;

    if (tid >= CONSUMERS + SPLITTERS) {
      // Mergers, one thread per query row: each tile's candidates, once
      // the consumers have filtered them, while the next tile is loaded
      // and multiplied.
      const int r = tid - CONSUMERS - SPLITTERS;
      if (k <= KREG) {  // the row's best set in registers for the batch
        float bv[KREG];
        int bp[KREG];
#pragma unroll
        for (int j = 0; j < KREG; ++j) {
          bv[j] = j < k ? bd[j * QT + r] : CUDART_INF_F;
          bp[j] = j < k ? bi[j * QT + r] : -1;
        }
        float kr = kth[r];
        for (int t = 0; t < n_list; ++t) {
          mbar_wait(filtered, (uint32_t)(g_tiles + t) & 1u);
          if (r < nq) {
            merge_row_regs<KREG>(r, mask, dist, bv, bp, k, kr, list[t]);
            kth[r] = kr;
          }
          mbar_arrive(merged);
        }
#pragma unroll
        for (int j = 0; j < KREG; ++j)
          if (j < k) {
            bd[j * QT + r] = bv[j];
            bi[j * QT + r] = bp[j];
          }
      } else {
        for (int t = 0; t < n_list; ++t) {
          mbar_wait(filtered, (uint32_t)(g_tiles + t) & 1u);
          if (r < nq)
            kth[r] = merge_row(r, mask, dist, bd, bi, k, kth[r],
                               (long long)list[t]);
          mbar_arrive(merged);
        }
      }
    } else if (tid >= CONSUMERS) {
      // Splitters: local slice s (global g_slices + s) lands in slot
      // (g_slices + s) % RING by TMA or their own cp.async copies, is split
      // into hi (in place) and lo and handed to the consumers (ready);
      // once they release it (empty), its slot takes the slice RING later.
      // A tile's bins and |x|^2 go with its last slice.
      const int p = tid - CONSUMERS;
      auto fill = [&](int s) {
        const int t = s / nk, k0 = (s - t * nk) * DK;
        float* dst = xs + (size_t)((g_slices + s) % RING) * SLICE;
        if (tma) {
          if (p == 0)
            tma_slice(dst, &map, k0, list[t], &full[(g_slices + s) % RING]);
        } else {
          copy_units(dst, corpus, list[t], n_corpus, d, k0, p);
        }
      };
      for (int s = 0; s < RING; ++s) {
        const int g = g_slices + s;
        if (s < nsteps && (p == 0 || !tma)) {
          if (g >= RING) mbar_wait(&empty[g % RING], (uint32_t)(g / RING - 1) & 1u);
          fill(s);
        }
        if (!tma) cp_async_commit();
      }
      int rb[CT / SPLITTERS];
      float xv[CT / SPLITTERS];
      for (int s = 0; s < nsteps; ++s) {
        const int g = g_slices + s, slot = g % RING;
        const int t = s / nk, j = s - t * nk;
        if (j == 0) {  // this thread's rows of the tile
          const int g0 = list[t], nx = min(CT, r_blk - g0 % r_blk);
#pragma unroll
          for (int i = 0; i < CT / SPLITTERS; ++i) {
            const int c = i * SPLITTERS + p;
            rb[i] = c < nx ? rbin[g0 + c] : -1;
            xv[i] = c < nx ? xx[g0 + c] : 0.f;
          }
        }
        if (tma)
          mbar_wait(&full[slot], (uint32_t)(g / RING) & 1u);
        else if (s == 0)
          cp_async_wait<RING - 1>();
        else
          cp_async_wait<RING - 2>();
#pragma unroll
        for (int i = 0; i < SUNITS; ++i)
          split_unit(xs + (size_t)slot * SLICE, lo + (size_t)slot * SLICE,
                     i * SPLITTERS + p);
        if (j == nk - 1) {
#pragma unroll
          for (int i = 0; i < CT / SPLITTERS; ++i) {
            rbs[slot * CT + i * SPLITTERS + p] = rb[i];
            xxs[slot * CT + i * SPLITTERS + p] = xv[i];
          }
        }
        // the generic-proxy writes above, before wgmma's async-proxy reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&ready[slot]);
        if (s >= 1) {  // refill the slot of slice s - 1
          if (s - 1 + RING < nsteps && (p == 0 || !tma)) {
            mbar_wait(&empty[(g - 1) % RING], (uint32_t)((g - 1) / RING) & 1u);
            fill(s - 1 + RING);
          }
          if (!tma) cp_async_commit();
        }
      }
      if (!tma) cp_async_wait<0>();
    } else {
      // Consumers: per slice, the A fragments (queries, split in
      // registers) and 12 wgmmas into the tile's accumulators; at a
      // tile's end, the bin test, the distances and the filter.
      const int g4 = lane / 4, t4 = lane % 4;
      const int wg = warp / 4;               // corpus rows 64 wg + ...
      const int qr0 = (warp % 4) * 16 + g4;  // the thread's rows qr0, + 8
      // features c + t4 and c + t4 + 4 of query row r (c a multiple of 8)
      auto qval = [&](int r, int c) -> float2 {
        if (RESIDENT)
          return *reinterpret_cast<const float2*>(qs + r * L.qp + c + 2 * t4);
        const bool ok = r < nq;
        const float* pq = qt + (size_t)r * d + c + t4;
        return make_float2(ok && c + t4 < d ? __ldg(pq) : 0.f,
                           ok && c + t4 + 4 < d ? __ldg(pq + 4) : 0.f);
      };
      float acc[32] = {};
      for (int s = 0; s < nsteps; ++s) {
        const int g = g_slices + s, slot = g % RING;
        const int t = s / nk, j = s - t * nk;
        const int nks = min(DK, d8 - j * DK) / 8;  // 8-feature steps
        uint32_t ah[DK / 8][4], al[DK / 8][4];
#pragma unroll
        for (int ks = 0; ks < DK / 8; ++ks) {  // steps past d8 multiply zeros
          const bool live = ks < nks;
          const float2 top = live ? qval(qr0, j * DK + ks * 8) : float2{};
          const float2 bot = live ? qval(qr0 + 8, j * DK + ks * 8) : float2{};
          split3(top.x, ah[ks][0], al[ks][0]);
          split3(bot.x, ah[ks][1], al[ks][1]);
          split3(top.y, ah[ks][2], al[ks][2]);
          split3(bot.y, ah[ks][3], al[ks][3]);
          pin(ah[ks]);
          pin(al[ks]);
        }
        mbar_wait(&ready[slot], (uint32_t)(g / RING) & 1u);
        const float* xb = xs + (size_t)slot * SLICE + wg * 64 * DK;
        const float* lb = lo + (size_t)slot * SLICE + wg * 64 * DK;
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DK / 8; ++ks) {
          const uint64_t dh = b_desc(xb, ks * 32), dl = b_desc(lb, ks * 32);
          wgmma_tf32(acc, al[ks], dh, j > 0 || ks > 0);  // a tile starts at 0
          wgmma_tf32(acc, ah[ks], dl, 1);
          wgmma_tf32(acc, ah[ks], dh, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
        if (j == nk - 1) {
          // the tile is done: bins, distances and filter (the last tile's
          // merge has freed kth, dist and mask)
          const int tg = g_tiles + t;
          if (tg > 0) mbar_wait(merged, (uint32_t)(tg - 1) & 1u);
          const float* x2 = xxs + slot * CT;
          const int* rb = rbs + slot * CT;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = qr0 + 8 * h;
            const int bin = r < nq ? qbins[r] : -1;
            if (bin < 0) continue;
            const float qr = qq[r], kr = kth[r];
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = 64 * wg + 8 * jj + 2 * t4 + e;
                if (rb[c] != bin) continue;  // rows past the group: bin -1
                const float v =
                    distance(acc[4 * jj + 2 * h + e], qr, x2[c], cosine);
                if (v < kr) {
                  dist[r * DP + c] = v;
                  atomicOr(&mask[r * MASKW + c / 32], 1u << (c % 32));
                }
              }
          }
          mbar_arrive(filtered);
        }
        mbar_arrive(&empty[slot]);
      }
    }
    __syncthreads();  // the batch is merged; list and state may change
    g_slices += nsteps;
    g_tiles += n_list;
    if (last) break;
  }

  // the rows' best sets, ascending: the id of each padded position, -1
  // wherever the distance is inf
  for (int e = tid; e < (s1 - s0) * k; e += THREADS) {
    const int r = s0 + e / k, t = e % k;
    const float v = bd[t * QT + r];
    const int pos = bi[t * QT + r];
    const size_t o = (size_t)(row0 + r) * k + t;
    out_d[o] = v;
    out_i[o] = v == CUDART_INF_F ? -1 : (ids ? ids[pos] : pos);
  }
  // for the tests and the timing tools: the live tiles this block walked
  if (walked && tid == 0)
    walked[order ? order[blockIdx.x] : blockIdx.x] = g_tiles;
}

template <bool RESIDENT>
int launch(const CUtensorMap& map, const float* q_stack, const int* qbin,
           const int* qb, const int* gb, const float* corpus, const int* rbin,
           const float* xx, const int* ids, float* out_d, int* out_i,
           const int* order, int* walked, int n_rows, int n_corpus, int d,
           int W, int q_blk, int r_blk, int k, int cosine, int tma, int split,
           cudaStream_t stream) {
  const size_t smem = make_layout(d, k, RESIDENT).bytes;
  auto kernel = split ? packed_scan_kernel<RESIDENT, true>
                      : packed_scan_kernel<RESIDENT, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)W * ((q_blk + QT - 1) / QT);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      map, q_stack, qbin, qb, gb, corpus, rbin, xx, ids, out_d, out_i, order,
      walked, n_rows, n_corpus, d, W, q_blk, r_blk, k, cosine, tma);
  return (int)cudaGetLastError();
}

}  // namespace pscan
}  // namespace vers

// The tile sizes and the plan's limit, for the host mirror of the walk
// (ops/cuda_binned.py keeps the same three): out[0..3) = QT, CT, PLAN_MAX.
extern "C" int vers_packed_scan_constants(int* out) {
  out[0] = vers::dtk::QT;
  out[1] = vers::dtk::CT;
  out[2] = vers::pscan::PLAN_MAX;
  return 0;
}

// walked: null, or one int per (work item, 64-row part) that the caller
// filled with -1; a block that does work writes the count of live tiles
// it walked there. split: 1 for the split walk, 0 for the run walk (the
// caller's rule, ops/cuda_binned.split_walk).
extern "C" int vers_packed_scan(const float* q_stack, const int* qbin,
                                const int* qb, const int* gb,
                                const float* corpus, const int* rbin,
                                const float* xx, const int* ids, float* out_d,
                                int* out_i, int* plan, int* walked, int n_rows,
                                int n_corpus, int d, int W, int q_blk,
                                int r_blk, int k, int cosine, int split,
                                void* stream) {
  namespace ps = vers::pscan;
  namespace dtk = vers::dtk;
  if (W <= 0 || n_rows <= 0) return 0;
  if (d <= 0 || k <= 0 || q_blk <= 0 || r_blk <= 0 || n_corpus <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  // TMA needs 16-byte aligned rows; otherwise 4-byte cp.async copies
  const int tma = d % 4 == 0 && reinterpret_cast<uintptr_t>(corpus) % 16 == 0;
  CUtensorMap map = {};
  if (tma) {
    e = dtk::encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float),
                       corpus, n_corpus, d, dtk::CT, dtk::DK);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  // plan: scratch of 3 ints a unit (the 64-bit sort keys, then the
  // order), or null; without it, or past PLAN_MAX units, blocks go in
  // list order
  const int parts = (q_blk + dtk::QT - 1) / dtk::QT;
  const long long units = (long long)W * parts;
  const int* order = nullptr;
  if (plan && units <= ps::PLAN_MAX) {
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(plan);
    ps::plan_cost_kernel<<<((int)units + ps::PLAN_WARPS - 1) / ps::PLAN_WARPS,
                           ps::PLAN_WARPS * 32, 0, st>>>(
        qbin, qb, gb, rbin, keys, n_rows, W, parts, q_blk, r_blk, split);
    int n = 2;
    while (n < units) n <<= 1;
    ps::plan_order_kernel<<<1, 1024, n * sizeof(unsigned long long), st>>>(
        keys, plan + 2 * units, (int)units, n);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    order = plan + 2 * units;
  }
#define VERS_B_ARGS                                                          \
  map, q_stack, qbin, qb, gb, corpus, rbin, xx, ids, out_d, out_i, order,   \
      walked, n_rows, n_corpus, d, W, q_blk, r_blk, k, cosine, tma, split, st
  // the resident query tile where it fits, else queries read through L1
  if (ps::make_layout(d, k, true).bytes <= (size_t)max_smem)
    return ps::launch<true>(VERS_B_ARGS);
  if (ps::make_layout(d, k, false).bytes <= (size_t)max_smem)
    return ps::launch<false>(VERS_B_ARGS);
#undef VERS_B_ARGS
  return (int)cudaErrorInvalidValue;
}
