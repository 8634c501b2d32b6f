// Kernel A: exact k-NN over a flat corpus with a fused streaming top-k.
//
// Replaces vers_tpu/ops/pallas_topk.py:pallas_distance_topk (body
// _kernel, merge _merge_topk). The TPU grid is (query tile, corpus
// chunk) and carries the best set in VMEM along its sequential chunk
// axis, with the product on the MXU in the corpus's own dtype (f32 or
// bf16) at the caller's precision: HIGHEST (f32 from several bf16
// passes), HIGH (bf16_3x) or DEFAULT (one bf16 pass). Each of the six
// (corpus dtype, precision) pairs is a route of this kernel (Route,
// distance_tile.cuh); the TPU's meaning of each is ops/topk.product_operands.
//
// Design on the H100. The grid is (query tile, corpus split), query tile
// fastest so that the blocks in flight share one split in L2. A split is
// a contiguous range of 128-row tiles; the host picks the route's plan
// (ops/cuda_topk.kernel_plan: query tile, ring slots, where the query
// parts live, split count). Each block walks its split in ascending row
// order and writes its ascending (query tile, k) best set into columns
// [split * k, split * k + k) of a (Q, S * k) table; kernel C then takes
// the final k of each row (S = 1 writes the result directly). Splits are
// in row order and kernel C keeps column order among equal values, so
// ties still go to the lower row.
//
// Bound on the H100: the dot products on the tensor cores, 2 Q N d flop
// (9.8e12 at 16384 x 1M x 300) times the route's products, and the
// corpus streamed once per query tile from L2 (one read from HBM at
// small Q). A block is three warpgroups: a producer warpgroup that
// stages the corpus into a ring of shared-memory slots, sums |x|^2 from
// what lands and merges each tile's candidates into the best sets, and
// two consumer warpgroups that run the MMAs and at a tile's end filter
// the distances (a candidate beats its row's kth best). The kernel is
// deterministic.
//
// The f32 corpus at HIGHEST (this file) multiplies by wgmma m64n64k8
// .tf32 in the 3xTF32 split (distance_tile.cuh), f32 accurate, three MMAs
// a product, over 64-query tiles and 128 x 32 slices that TMA lands in a
// ring of three slots (128-byte swizzle, zeros past the corpus); the
// producers split each landed slice into tf32 hi (in place) and lo; the
// consumers keep the queries resident as f32 where they fit and split
// them into A fragments in registers. Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md): at Q = 2048 the loads alone take about half
// the time (38.5 GB from L2 at ~3.6 TB/s).
//
// The five bf16 routes (distance_bf16.cu, whose note has the design and
// its measured limits) multiply bf16 parts with wgmma .bf16 over
// 64-feature slices: the query parts made once a block and resident as
// wgmma's A operand, a 128-query tile where two slots fit beside it
// (half the L2 traffic), a slice's MMAs in flight while the next is
// waited for, the corpus staged by TMA (the 600-byte rows of a bf16
// corpus at d = 300 as even and odd rows), an f32 corpus converted in
// place, a merge a row a lane with a warp-wide rank merge for rows with
// many candidates, and a split of one wave of blocks. On the H100 they
// run at 1.4-2.3x the times of their first port (PERF.md §6).
#include <cstdint>

#include "distance_tile.cuh"

namespace vers {
namespace dtk {

template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
distance_topk_kernel(const __grid_constant__ CUtensorMap map,
                     const float* __restrict__ q, const void* __restrict__ xv,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     int ld_out, int Q, int d, int n_valid, int split_rows,
                     int k, int cosine, int tma) {
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
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // TMA landed
  uint64_t* ready = full + NS;   // split, for the consumers
  uint64_t* empty = ready + NS;  // consumed, for a refill
  uint64_t* filtered = empty + NS;  // a tile's candidates, for the merge
  uint64_t* merged = filtered + 1;  // ... merged: kth, dist, mask free
  float* bd = reinterpret_cast<float*>(smem + L.bd);
  int* bi = reinterpret_cast<int*>(smem + L.bi);

  const int q0 = blockIdx.x * QT;
  const int nq = min(QT, Q - q0);
  const float* qt = q + (size_t)q0 * d;
  const long long r_begin = (long long)blockIdx.y * split_rows;
  const long long r_end = min(r_begin + split_rows, (long long)n_valid);
  const int ntile = r_end > r_begin ? (int)((r_end - r_begin + CT - 1) / CT) : 0;
  const int nk = (d + DK - 1) / DK;  // slices per tile
  const int nsteps = ntile * nk;
  const int dm = (d + 7) / 8 * 8;  // MMA depth

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&ready[i], PRODUCERS);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_init(filtered, CONSUMERS);
    mbar_init(merged, PRODUCERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the resident tile stores features 8j + t, 8j + t + 4 at 8j + 2t, + 1
  if (RESIDENT) {
    for (int e = tid; e < QT * L.qp; e += THREADS) {
      const int r = e / L.qp, p = e % L.qp;
      const int c = (p & ~7) + (p & 7) / 2 + 4 * (p & 1);
      qs[e] = (r < nq && c < d) ? qt[(size_t)r * d + c] : 0.f;
    }
  }
  for (int r = warp; r < QT; r += THREADS / 32) {
    float a = 0.f;
    if (r < nq)
      for (int c = lane; c < d; c += 32) {
        const float v = qt[(size_t)r * d + c];
        a = fmaf(v, v, a);
      }
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
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

  if (tid >= CONSUMERS) {
    // Producers: slice s lands in slot s % NS (TMA, or their own
    // cp.async copies), is split into hi (in place) and lo, with |x|^2,
    // and handed to the consumers (ready); once they release it (empty),
    // its slot takes slice s + NS. The producers also merge each tile's
    // candidates once the consumers have filtered them.
    const int p = tid - CONSUMERS;
    auto merge = [&](int t) {
      mbar_wait(filtered, (uint32_t)t & 1u);
      if (p < nq)
        kth[p] = merge_row(p, mask, dist, bd, bi, k, kth[p],
                           r_begin + (long long)t * CT);
      mbar_arrive(merged);
    };
    auto fill = [&](int s) {
      const int t = s / nk, k0 = (s - t * nk) * DK;
      const long long g0 = r_begin + (long long)t * CT;
      float* dst = xs + (size_t)(s % NS) * SLICE;
      if (tma) {
        if (p == 0) tma_slice(dst, &map, k0, (int)g0, &full[s % NS]);
      } else {
        copy_units(dst, static_cast<const float*>(xv), g0, r_end, d, k0, p);
      }
    };
    for (int s = 0; s < NS; ++s) {
      if (s < nsteps) fill(s);
      if (!tma) cp_async_commit();
    }
    float xacc[UNITS] = {};
    for (int s = 0; s < nsteps; ++s) {
      const int slot = s % NS;
      if (tma)
        mbar_wait(&full[slot], (uint32_t)(s / NS) & 1u);
      else if (s == 0)
        cp_async_wait<NS - 1>();
      else
        cp_async_wait<NS - 2>();
      float* xslot = xs + (size_t)slot * SLICE;
      float* lslot = lo + (size_t)slot * SLICE;
#pragma unroll
      for (int i = 0; i < UNITS; ++i)
        split_unit(xslot, lslot, i * PRODUCERS + p, xacc[i]);
      if (s % nk == nk - 1) {  // the tile's |x|^2, rows 16 i + p / 8
#pragma unroll
        for (int i = 0; i < UNITS; ++i) {
          float v = xacc[i];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          if (lane % 8 == 0) xxs[slot * CT + 16 * i + p / 8] = v;
          xacc[i] = 0.f;
        }
      }
      // the generic-proxy writes above, before wgmma's async-proxy reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&ready[slot]);
      if (s >= 1 && s % nk == 0) merge(s / nk - 1);
      if (s >= 1) {  // refill the slot of slice s - 1
        if (s - 1 + NS < nsteps && (p == 0 || !tma)) {
          mbar_wait(&empty[(s - 1) % NS], (uint32_t)((s - 1) / NS) & 1u);
          fill(s - 1 + NS);
        }
        if (!tma) cp_async_commit();
      }
    }
    if (nsteps > 0) merge(ntile - 1);
    if (!tma) cp_async_wait<0>();
  } else {
    // Consumers: per slice, the A fragments (queries, split in
    // registers) and the 12 wgmmas into the tile's accumulators; at a
    // tile's end, the distances and the filter.
    const int g = lane / 4, t4 = lane % 4;
    const int wg = warp / 4;              // corpus rows 64 wg + ...
    const int qr0 = (warp % 4) * 16 + g;  // the thread's query rows qr0, + 8
    // 3xTF32: features c + t4 and c + t4 + 4 of query row r (c a
    // multiple of 8)
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
      const int slot = s % NS;
      const int t = s / nk, j = s - t * nk;
      const int nks = min(DK, dm - j * DK) / 8;  // MMA steps
      const float* xb = xs + (size_t)slot * SLICE + wg * 64 * DK;
      const float* lb = lo + (size_t)slot * SLICE + wg * 64 * DK;
      uint32_t ah[DK / 8][4], al[DK / 8][4];
#pragma unroll
      for (int ks = 0; ks < DK / 8; ++ks) {  // steps past dm multiply zeros
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
      mbar_wait(&ready[slot], (uint32_t)(s / NS) & 1u);
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
        // the tile is done: distances and filter (the last tile's merge
        // has freed kth, dist and mask)
        if (t > 0) mbar_wait(merged, (uint32_t)(t - 1) & 1u);
        const long long g0 = r_begin + (long long)t * CT;
        const int nx = (int)min((long long)CT, r_end - g0);
        const float* xx = xxs + slot * CT;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = qr0 + 8 * h;
          if (r >= nq) continue;
          const float qr = qq[r], kr = kth[r];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 64 * wg + 8 * jj + 2 * t4 + e;
              if (c >= nx) continue;
              const float v =
                  distance(acc[4 * jj + 2 * h + e], qr, xx[c], cosine);
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
  __syncthreads();

  // this split's best set, ascending, id -1 wherever the distance is inf
  for (int e = tid; e < nq * k; e += THREADS) {
    const int r = e / k, t = e % k;
    const float v = bd[t * QT + r];
    const size_t o = (size_t)(q0 + r) * ld_out + (size_t)blockIdx.y * k + t;
    out_d[o] = v;
    out_i[o] = v == CUDART_INF_F ? -1 : bi[t * QT + r];
  }
}

// The corpus as a TMA tensor (n_rows x d f32, boxes of CT rows x DK
// features, 128-byte swizzle, zeros outside). Needs 16-byte rows.
inline cudaError_t corpus_map(CUtensorMap* map, const float* x, int n_rows,
                              int d) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), x,
                   n_rows, d, CT, DK);
}

template <bool RESIDENT>
int launch(const CUtensorMap& map, const float* q, const float* x,
           float* out_d, int* out_i, int Q, int d, int n_valid, int k,
           int cosine, int n_split, int split_rows, int tma,
           cudaStream_t stream) {
  const size_t smem = make_layout(d, k, RESIDENT).bytes;
  auto kernel = distance_topk_kernel<RESIDENT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + QT - 1) / QT, n_split);
  kernel<<<grid, THREADS, smem, stream>>>(map, q, x, out_d, out_i, n_split * k,
                                          Q, d, n_valid, split_rows, k, cosine,
                                          tma);
  return (int)cudaGetLastError();
}

// distance_bf16.cu: the bf16 routes' launch and occupancy.
int launch_b16(int route, const float* q, const void* x, float* out_d,
               int* out_i, int Q, int n_rows, int d, int n_valid, int k,
               int cosine, int n_split, int split_rows, int gran, int qt,
               int ns, int resident, int max_smem, cudaStream_t stream);
int occupancy_b16(int route, int d, int k, int qt, int ns, int resident,
                  int* blocks);

inline int route_of(int x_bf16, int precision) {
  return x_bf16 ? (precision == 0   ? HIGHEST_B16
                   : precision == 1 ? HIGH_B16
                                    : DEFAULT_B16)
                : (precision == 0   ? HIGHEST_F32
                   : precision == 1 ? HIGH_F32
                                    : DEFAULT_F32);
}

inline int max_smem_optin(int* max_smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(
      max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace dtk
}  // namespace vers

// out_d / out_i are (Q, n_split * k): block (i, s) writes rows of query
// tile i, columns [s * k, s * k + k). Split s covers corpus rows
// [s * split_rows, (s + 1) * split_rows) below n_valid. x is (n_rows, d)
// f32, or bf16 when x_bf16; precision 0 = "highest", 1 = "high", 2 =
// "default". The plan (query_tile, slots, resident) is the host's
// (ops/cuda_topk.kernel_plan); a plan this card's shared memory cannot
// hold, or one the route does not have, is refused. The f32 "highest"
// route has one plan: 64 queries, NS slots, its query tile resident where
// it fits (k <= 31 at d = 300; 216 KB at k = 10), else read through L1.
extern "C" int vers_distance_topk(const float* q, const void* x, float* out_d,
                                  int* out_i, int Q, int n_rows, int d,
                                  int n_valid, int k, int cosine, int n_split,
                                  int split_rows, int x_bf16, int precision,
                                  int query_tile, int slots, int resident,
                                  void* stream) {
  using namespace vers::dtk;
  if (Q <= 0) return 0;
  if (d <= 0 || k <= 0 || n_split <= 0 || n_split > 65535 || split_rows <= 0 ||
      split_rows % CT != 0 || precision < 0 || precision > 2)
    return (int)cudaErrorInvalidValue;
  if (n_valid > n_rows) n_valid = n_rows;
  if (n_valid < 0) n_valid = 0;
  int max_smem = 0;
  int e = max_smem_optin(&max_smem);
  if (e != 0) return e;
  const int route = route_of(x_bf16, precision);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  cudaStream_t st = (cudaStream_t)stream;
  if (route != HIGHEST_F32) {
    // where TMA cannot stage the corpus (distance_bf16.cu corpus_maps), a
    // bf16 corpus is copied by 4-byte cp.async pieces, or 2-byte loads
    // where its rows are not 4-byte aligned (8-byte pieces measured slower
    // than 4-byte ones, PERF.md §6)
    const int gran = x_bf16 && (d % 2 || xa % 4) ? 2 : 4;
    return launch_b16(route, q, x, out_d, out_i, Q, n_rows, d, n_valid, k,
                      cosine, n_split, split_rows, gran, query_tile, slots,
                      resident, max_smem, st);
  }
  const bool fits = make_layout(d, k, true).bytes <= (size_t)max_smem;
  if (query_tile != QT || slots != NS || resident != (int)fits ||
      make_layout(d, k, false).bytes > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  // TMA needs 16-byte aligned rows; otherwise 4-byte cp.async copies
  const int tma = d % 4 == 0 && xa % 16 == 0;
  const float* xf = static_cast<const float*>(x);
  CUtensorMap map = {};
  if (tma) {
    e = (int)corpus_map(&map, xf, n_rows, d);
    if (e != 0) return e;
  }
  if (fits)
    return launch<true>(map, q, xf, out_d, out_i, Q, d, n_valid, k, cosine,
                        n_split, split_rows, tma, st);
  return launch<false>(map, q, xf, out_d, out_i, Q, d, n_valid, k, cosine,
                       n_split, split_rows, tma, st);
}

// A plan's shared-memory bytes a block and the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into out[0], out[1].
extern "C" int vers_distance_topk_plan(int d, int k, int x_bf16,
                                       int precision, int query_tile,
                                       int slots, int resident, int* out) {
  using namespace vers::dtk;
  if (precision < 0 || precision > 2 || d <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  const int route = route_of(x_bf16, precision);
  if (route != HIGHEST_F32) {
    out[0] = (int)make_layout_b(route, d, k, query_tile, slots, resident).bytes;
    return occupancy_b16(route, d, k, query_tile, slots, resident, &out[1]);
  }
  const size_t smem = make_layout(d, k, resident).bytes;
  out[0] = (int)smem;
  const auto kernel =
      resident ? distance_topk_kernel<true> : distance_topk_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel,
                                                            THREADS, smem);
}

extern "C" const char* vers_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
