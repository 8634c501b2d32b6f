// Kernel A: exact k-NN over a flat corpus with a fused streaming top-k.
//
// Replaces vers_tpu/ops/pallas_topk.py:pallas_distance_topk (body
// _kernel, merge _merge_topk). The TPU grid is (query tile, corpus
// chunk) and carries the best set in VMEM along its sequential chunk
// axis, with the product on the MXU in the corpus's own dtype (f32 or
// bf16) at the caller's precision: HIGHEST (f32 from several bf16
// passes), HIGH (bf16_3x) or DEFAULT (one bf16 pass). Each of the six
// (corpus dtype, precision) pairs is a route of this kernel (Route
// below); the TPU's meaning of each is ops/topk.product_operands.
//
// Design on the H100. The grid is (query tile, corpus split), query tile
// fastest so that the blocks in flight share one split in L2. A split is
// a contiguous range of 128-row tiles; the host picks the number of
// splits S from Q, N and the SM count so that at least two blocks per SM
// are launched at any Q, where one block per query tile would leave most
// SMs idle at small Q. Each block
// walks its split in ascending row order and writes its ascending (64, k)
// best set into columns [split * k, split * k + k) of a (Q, S * k)
// table; kernel C then takes the final k of each row (S = 1 writes the
// result directly). Splits are in row order and kernel C keeps column
// order among equal values, so ties still go to the lower row.
//
// Bound on the H100: the 2 Q N d flop of the dot products (9.8e12 at
// 16384 x 1M x 300), and the corpus streamed once per 64-query tile, so
// (Q / 64) x 1.2 GB from L2 (one read from HBM at small Q, 0.36 ms at
// 3.35 TB/s). The products run on the tensor cores as warpgroup MMAs:
// an f32 corpus at HIGHEST as wgmma m64n64k8 .tf32 in the 3xTF32 split
// (distance_tile.cuh), f32 accurate, three MMAs per product; every other
// route as wgmma m64n64k16 .bf16 over bf16 parts of the operands (one
// such MMA takes the time of one tf32 k8 MMA over twice the features):
// one MMA for DEFAULT, three for HIGH (two over a bf16 corpus), three
// for a bf16 corpus at HIGHEST (the query in three bf16 parts against
// the exact row). At DEFAULT that is 9.94 ms at 16384 x 1M x 300.
//
// A block is three warpgroups. The producer warpgroup streams 128 x 32
// slices of the corpus into a ring of three shared-memory slots by TMA
// (mbarriers; 128-byte swizzle, zeros past the corpus), splits each
// landed slice into tf32 hi (in place) and lo (beside it), which wgmma
// reads as B, sums |x|^2 from it (no pass over the corpus outside the
// kernel), and merges each tile's candidates. The two consumer
// warpgroups keep the 64 queries resident as f32, split them into A
// fragments in registers (a resident hi/lo copy at d = 300 would not
// fit beside the ring), multiply 64 corpus rows each, and at a tile's end
// filter its distances: an entry is a candidate only if it beats its
// row's kth distance (a bit in a per-row mask; atomicOr only sets bits,
// so the order of the atomics does not matter). The merge walks the set
// bits in ascending column order with strict-less sorted insertion. The
// kernel is deterministic. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md): at Q = 2048 the loads alone take about half the time (38.5
// GB from L2 at ~3.6 TB/s), and the split, the A fragments and the MMAs
// add to it rather than hide behind it; a 128-query tile or cluster
// multicast would halve the L2 traffic.
//
// The bf16 routes keep that structure with 64-feature slices (128 bf16
// bytes a row, the same 16 KB slot and swizzle) and split the resident
// f32 queries into bf16 parts in registers. A bf16 corpus is staged by
// cp.async in 16-byte pieces where its rows are 16-byte aligned (d % 8 ==
// 0) and in 4-byte pieces otherwise (d = 300: 600-byte rows, which a TMA
// map cannot stride; d odd: 2-byte loads), with no copy of the store; the
// producers sum |x|^2 from the landed slice. An f32 corpus on a bf16 route
// is read by the producers into registers and stored as its bf16 parts
// (its |x|^2 from the f32 values). Features past d are zeros in both
// operands up to the 16-feature MMA step.
#include <cstdint>

#include "distance_tile.cuh"

namespace vers {
namespace dtk {

// The operand routes. HIGHEST_F32 is the 3xTF32 route above; the others
// multiply bf16 operands with wgmma .bf16 (distance_tile.cuh). A bf16
// corpus at "highest" splits each query into three bf16 parts, which hold
// all of its f32 mantissa, against the exact bf16 rows: three bf16 MMAs
// where the TF32 split would take two at half the rate. "high" is the
// TPU's bf16_3x (hi*hi + hi*lo + lo*hi over hi = bf16(v), lo = bf16(v -
// hi); a bf16 corpus has lo = 0), "default" one bf16 product. |q|^2 and
// |x|^2 are always f32 sums of the operands as given.
enum Route : int {
  HIGHEST_F32 = 0,  // f32 corpus, precision "highest"
  HIGHEST_B16 = 1,  // bf16 corpus, "highest"
  HIGH_B16 = 2,     // bf16 corpus, "high"
  DEFAULT_B16 = 3,  // bf16 corpus, "default"
  HIGH_F32 = 4,     // f32 corpus, "high"
  DEFAULT_F32 = 5,  // f32 corpus, "default"
};

template <int ROUTE>
struct RouteTraits {
  static constexpr bool BF = ROUTE != HIGHEST_F32;  // bf16 MMAs
  static constexpr bool XB16 =
      ROUTE == HIGHEST_B16 || ROUTE == HIGH_B16 || ROUTE == DEFAULT_B16;
  static constexpr int AP = ROUTE == HIGHEST_B16 ? 3
                            : ROUTE == HIGH_B16 || ROUTE == HIGH_F32 ? 2
                                                                     : 1;
  static constexpr int BP = ROUTE == HIGH_F32 ? 2 : 1;  // corpus parts
  static constexpr int KF = BF ? 16 : 8;                // features an MMA
  static constexpr int DKS = BF ? 64 : DK;              // ... a slice
};

template <bool RESIDENT, int ROUTE>
__global__ void __launch_bounds__(THREADS, 1)
distance_topk_kernel(const __grid_constant__ CUtensorMap map,
                     const float* __restrict__ q, const void* __restrict__ xv,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     int ld_out, int Q, int d, int n_valid, int split_rows,
                     int k, int cosine, int tma, int gran) {
  using R = RouteTraits<ROUTE>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const Layout L = make_layout(d, k, RESIDENT, R::BF);
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
  const int nk = (d + R::DKS - 1) / R::DKS;  // slices per tile
  const int nsteps = ntile * nk;
  const int dm = (d + R::KF - 1) / R::KF * R::KF;  // MMA depth

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
  // the 3xTF32 resident tile stores features 8j + t, 8j + t + 4 at
  // 8j + 2t, + 1; the bf16 routes' tile is row-major
  if (RESIDENT) {
    for (int e = tid; e < QT * L.qp; e += THREADS) {
      const int r = e / L.qp, p = e % L.qp;
      const int c = R::BF ? p : (p & ~7) + (p & 7) / 2 + 4 * (p & 1);
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
    // its slot takes slice s + NS. On the bf16 routes a bf16 corpus lands
    // as it is (cp.async) and only its |x|^2 is summed; an f32 corpus is
    // read straight into registers and stored as bf16 parts. The
    // producers also merge each tile's candidates once the consumers
    // have filtered them.
    const int p = tid - CONSUMERS;
    auto merge = [&](int t) {
      mbar_wait(filtered, (uint32_t)t & 1u);
      if (p < nq)
        kth[p] = merge_row(p, mask, dist, bd, bi, k, kth[p],
                           r_begin + (long long)t * CT);
      mbar_arrive(merged);
    };
    auto fill = [&](int s) {
      const int t = s / nk, k0 = (s - t * nk) * R::DKS;
      const long long g0 = r_begin + (long long)t * CT;
      float* dst = xs + (size_t)(s % NS) * SLICE;
      if constexpr (ROUTE == HIGHEST_F32) {
        if (tma) {
          if (p == 0) tma_slice(dst, &map, k0, (int)g0, &full[s % NS]);
        } else {
          copy_units(dst, static_cast<const float*>(xv), g0, r_end, d, k0, p);
        }
      } else if constexpr (R::XB16) {
        copy_units_bf16(dst, static_cast<const uint16_t*>(xv), g0, r_end, d,
                        k0, p, gran);
      }  // an f32 corpus on a bf16 route is read when its slice is due
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
      if constexpr (ROUTE == HIGHEST_F32) {
#pragma unroll
        for (int i = 0; i < UNITS; ++i)
          split_unit(xslot, lslot, i * PRODUCERS + p, xacc[i]);
      } else if constexpr (R::XB16) {
#pragma unroll
        for (int i = 0; i < UNITS; ++i)
          square_unit_bf16(xslot, i * PRODUCERS + p, xacc[i]);
      } else {
        // the slot was released before its refill wait (iteration
        // s - NS + 1); all loads first, then the conversions
        const int t = s / nk, k0 = (s - t * nk) * R::DKS;
        const long long g0 = r_begin + (long long)t * CT;
        float v[UNITS][8];
#pragma unroll
        for (int i = 0; i < UNITS; ++i)
          load_unit_f32(v[i], static_cast<const float*>(xv), g0, r_end, d, k0,
                        i * PRODUCERS + p, gran == 16);
#pragma unroll
        for (int i = 0; i < UNITS; ++i)
          store_unit_bf16<R::BP>(v[i], xslot, lslot, i * PRODUCERS + p,
                                 xacc[i]);
      }
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
    // registers) and the wgmmas into the tile's accumulators (12 on the
    // 3xTF32 route; on a bf16 route 4 per product of parts); at a tile's
    // end, the distances and the filter.
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
    // bf16 routes: features c and c + 1 of query row r (c even)
    auto qpair = [&](int r, int c) -> float2 {
      if (RESIDENT)
        return *reinterpret_cast<const float2*>(qs + r * L.qp + c);
      const bool ok = r < nq;
      const float* pq = qt + (size_t)r * d + c;
      return make_float2(ok && c < d ? __ldg(pq) : 0.f,
                         ok && c + 1 < d ? __ldg(pq + 1) : 0.f);
    };
    float acc[32] = {};
    for (int s = 0; s < nsteps; ++s) {
      const int slot = s % NS;
      const int t = s / nk, j = s - t * nk;
      const int nks = min(R::DKS, dm - j * R::DKS) / R::KF;  // MMA steps
      const float* xb = xs + (size_t)slot * SLICE + wg * 64 * DK;
      const float* lb = lo + (size_t)slot * SLICE + wg * 64 * DK;
      if constexpr (ROUTE == HIGHEST_F32) {
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
      } else {
        // a[ks][part]: the A fragment of MMA step ks, query part `part`
        uint32_t a[4][R::AP][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {  // steps past dm multiply zeros
          const bool live = ks < nks;
          const int c = j * R::DKS + ks * 16 + 2 * t4;
          const float2 v[4] = {live ? qpair(qr0, c) : float2{},
                               live ? qpair(qr0 + 8, c) : float2{},
                               live ? qpair(qr0, c + 8) : float2{},
                               live ? qpair(qr0 + 8, c + 8) : float2{}};
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            uint32_t lo16[R::AP], hi16[R::AP];
            split_bf16<R::AP>(v[f].x, lo16);
            split_bf16<R::AP>(v[f].y, hi16);
#pragma unroll
            for (int pa = 0; pa < R::AP; ++pa)
              a[ks][pa][f] = lo16[pa] | (hi16[pa] << 16);
          }
#pragma unroll
          for (int pa = 0; pa < R::AP; ++pa) pin(a[ks][pa]);
        }
        mbar_wait(&ready[slot], (uint32_t)(s / NS) & 1u);
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t dh = b_desc(xb, ks * 32);
          const int first = j > 0 || ks > 0;  // a tile starts at 0
          if constexpr (R::BP == 2) {  // lo*hi + hi*lo + hi*hi
            wgmma_bf16_rs(acc, a[ks][1], dh, first);
            wgmma_bf16_rs(acc, a[ks][0], b_desc(lb, ks * 32), 1);
            wgmma_bf16_rs(acc, a[ks][0], dh, 1);
          } else {  // the smallest query part first
#pragma unroll
            for (int pa = R::AP - 1; pa >= 0; --pa)
              wgmma_bf16_rs(acc, a[ks][pa], dh, pa == R::AP - 1 ? first : 1);
          }
        }
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

template <bool RESIDENT, int ROUTE>
int launch(const CUtensorMap& map, const float* q, const void* x,
           float* out_d, int* out_i, int Q, int d, int n_valid, int k,
           int cosine, int n_split, int split_rows, int tma, int gran,
           cudaStream_t stream) {
  const size_t smem =
      make_layout(d, k, RESIDENT, RouteTraits<ROUTE>::BF).bytes;
  auto kernel = distance_topk_kernel<RESIDENT, ROUTE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + QT - 1) / QT, n_split);
  kernel<<<grid, THREADS, smem, stream>>>(map, q, x, out_d, out_i, n_split * k,
                                          Q, d, n_valid, split_rows, k, cosine,
                                          tma, gran);
  return (int)cudaGetLastError();
}

template <bool RESIDENT>
int launch_route(int route, const CUtensorMap& map, const float* q,
                 const void* x, float* out_d, int* out_i, int Q, int d,
                 int n_valid, int k, int cosine, int n_split, int split_rows,
                 int tma, int gran, cudaStream_t st) {
#define VERS_ROUTE(R)                                                      \
  case R:                                                                  \
    return launch<RESIDENT, R>(map, q, x, out_d, out_i, Q, d, n_valid, k,  \
                               cosine, n_split, split_rows, tma, gran, st);
  switch (route) {
    VERS_ROUTE(HIGHEST_F32)
    VERS_ROUTE(HIGHEST_B16)
    VERS_ROUTE(HIGH_B16)
    VERS_ROUTE(DEFAULT_B16)
    VERS_ROUTE(HIGH_F32)
    VERS_ROUTE(DEFAULT_F32)
  }
#undef VERS_ROUTE
  return (int)cudaErrorInvalidValue;
}

}  // namespace dtk
}  // namespace vers

// out_d / out_i are (Q, n_split * k): block (i, s) writes rows of query
// tile i, columns [s * k, s * k + k). Split s covers corpus rows
// [s * split_rows, (s + 1) * split_rows) below n_valid. x is (n_rows, d)
// f32, or bf16 when x_bf16; precision 0 = "highest", 1 = "high", 2 =
// "default".
extern "C" int vers_distance_topk(const float* q, const void* x, float* out_d,
                                  int* out_i, int Q, int n_rows, int d,
                                  int n_valid, int k, int cosine, int n_split,
                                  int split_rows, int x_bf16, int precision,
                                  void* stream) {
  using namespace vers::dtk;
  if (Q <= 0) return 0;
  if (d <= 0 || k <= 0 || n_split <= 0 || n_split > 65535 || split_rows <= 0 ||
      split_rows % CT != 0 || precision < 0 || precision > 2)
    return (int)cudaErrorInvalidValue;
  if (n_valid > n_rows) n_valid = n_rows;
  if (n_valid < 0) n_valid = 0;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const int route = x_bf16 ? (precision == 0   ? HIGHEST_B16
                              : precision == 1 ? HIGH_B16
                                               : DEFAULT_B16)
                           : (precision == 0   ? HIGHEST_F32
                              : precision == 1 ? HIGH_F32
                                               : DEFAULT_F32);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  // TMA needs 16-byte aligned rows; otherwise 4-byte cp.async copies
  const int tma = route == HIGHEST_F32 && d % 4 == 0 && xa % 16 == 0;
  // the widest piece the rows' alignment allows (see copy_units_bf16 and
  // load_unit_f32)
  const int gran = x_bf16 ? (d % 8 == 0 && xa % 16 == 0  ? 16
                             : d % 2 == 0 && xa % 4 == 0 ? 4
                                                         : 2)
                          : (d % 4 == 0 && xa % 16 == 0 ? 16 : 4);
  CUtensorMap map = {};
  if (tma) {
    e = corpus_map(&map, static_cast<const float*>(x), n_rows, d);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const bool bf = route != HIGHEST_F32;
  // the resident query tile where it fits (k <= 31 at d = 300; 216 KB
  // at k = 10), else queries read through L1 (k = 128 at d = 300: 197 KB)
  if (make_layout(d, k, true, bf).bytes <= (size_t)max_smem)
    return launch_route<true>(route, map, q, x, out_d, out_i, Q, d, n_valid, k,
                              cosine, n_split, split_rows, tma, gran, st);
  if (make_layout(d, k, false, bf).bytes <= (size_t)max_smem)
    return launch_route<false>(route, map, q, x, out_d, out_i, Q, d, n_valid,
                               k, cosine, n_split, split_rows, tma, gran, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vers_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
