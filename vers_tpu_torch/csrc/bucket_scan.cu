// Kernel D: the bucket-min scan of the flat "bucket" engine (stage 1).
//
// Replaces vers_tpu/ops/pallas_bucket.py:bucket_scan_topk (body
// _kernel). For each query it reduces the distances to all corpus rows
// to a table of running minima: row r falls in bucket (superchunk
// r / span, lane r % 128), and table column s * 128 + lane holds the
// bucket's smallest distance and its row, the lowest row on ties. Inputs
// are rounded to bf16 and products summed in f32, as on the TPU's MXU;
// qq comes from the bf16-rounded queries, xx (from the f32 corpus) from
// the wrapper, rows >= n_valid are +inf and never win.
//
// On the TPU the corpus-chunk axis runs in order and VMEM scratch
// carries the minima across a superchunk's chunks. A bucket never spans
// superchunks, so here the superchunk is a parallel grid axis: block
// (x, y) owns 128 queries and superchunk y and walks its 128-row groups
// in ascending order. The query tile is the fastest grid axis, so the
// blocks in flight share one superchunk of corpus rows in L2.
//
// Bound on the H100: the dot products, 2 Q N d bf16 flop (9.8e12 at
// 16384 x 1M x 300: 9.9 ms at 989 TFLOP/s); the bytes (the bf16 corpus
// once, the table out) take 0.5 ms. Each SM also receives every corpus
// row once per 128 queries (Q / 128 x the bf16 corpus from L2), about
// one byte per 128 flop, which the card delivers at about the tensor
// cores' pace. Design:
//  * 384 threads, one block per SM: a producer warpgroup (40 registers
//    by setmaxnreg) and two consumer warpgroups (232), 64 queries each.
//  * The bf16 query tile (128 x d_pad) is loaded once by TMA and stays
//    resident; where it does not fit beside the ring (d_pad > 512) each
//    ring slot carries the query slice beside the corpus slice.
//  * One producer thread streams the superchunk's 128-row groups as
//    128 x 64 bf16 slices (16 KB, 128-byte swizzle, zeros past d_pad)
//    by TMA into a ring of up to NS_MAX slots on mbarriers (as many as
//    shared memory holds); one producer warp stages each group's per-row
//    bias (|x|^2, 0 for cosine, +inf past n_valid).
//  * Each consumer warpgroup multiplies its 64 queries by the group's
//    128 rows with wgmma.m64n128k16 bf16 -> f32, A and B from shared
//    memory. The 64 x 128 accumulator is one group: accumulator column
//    = bucket lane. The strict-less (min, row) update runs in the
//    accumulator's own layout: each thread keeps 64 minima and, per
//    minimum, the ordinal of its group in the superchunk (16 bits, two
//    per register; 32 bits when a superchunk has more than 65536
//    groups). The row is the group's first row plus the register's
//    fixed column.
#include <cstdint>

#include <cuda_bf16.h>

#include "distance_tile.cuh"

namespace vers {
namespace bucket {

using dtk::mbar_arrive;
using dtk::mbar_expect;
using dtk::mbar_init;
using dtk::mbar_wait;
using dtk::smem_addr;
using dtk::sw128_desc;
using dtk::tma_2d;
using dtk::wgmma_commit;
using dtk::wgmma_fence;

constexpr int QB = 128;              // queries per block: 64 per warpgroup
constexpr int GR = 128;              // corpus rows per group: one per lane
constexpr int KS = 64;               // bf16 features per slice (128 bytes)
constexpr int XSLICE = GR * KS * 2;  // bytes of a corpus slice
constexpr int QSLICE = QB * KS * 2;  // bytes of a query slice
constexpr int CONSUMERS = 256;       // 2 warpgroups: wgmma and the update
constexpr int CWARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 128;  // + 1 producer warpgroup
constexpr int NS_MAX = 8;            // ring slots, at most
constexpr int NS_MIN = 6;            // ... and at least, with a resident tile
constexpr int XB = 2;                // per-group bias buffers
constexpr int ORD16 = 65536;         // groups a 16-bit ordinal covers

// Byte offsets into the dynamic shared memory (from a 1024-byte aligned
// base): the resident query tile (nk slices of 128 rows x 128 bytes), the
// ring of ns slots (each a corpus slice, then the query slice when the
// tile is not resident), the bias buffers and the mbarriers (full and
// empty per slot; bias full and empty per buffer; the query tile).
struct Layout {
  size_t qs, xs, slot, bias, bar, bytes;
};

__host__ __device__ inline Layout make_layout(int nk, bool resident, int ns) {
  Layout L;
  size_t o = 0;
  L.qs = o;
  if (resident) o += (size_t)nk * QSLICE;
  L.xs = o;
  L.slot = resident ? XSLICE : XSLICE + QSLICE;
  o += ns * L.slot;
  L.bias = o;
  o += XB * GR * sizeof(float);
  L.bar = o;
  o += (2 * NS_MAX + 2 * XB + 1) * sizeof(uint64_t);
  L.bytes = o + 1024;  // room to align the base
  return L;
}

template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ inline void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc = (scale ? acc : 0) + A x B^T, m64n128k16 bf16 -> f32, A (64
// queries x 16 features) and B (128 rows x 16 features) K-major in
// shared memory. Per warp w of the warpgroup (g = lane / 4, t = lane %
// 4), d[4j + 2h + e] = (query 16w + g + 8h, row 8j + 2t + e).
__device__ inline void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db,
                                  int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale)
      : "memory");
}

// The ordinal store: two 16-bit ordinals per register, or one 32-bit.
template <bool WIDE>
struct Ordinals {
  uint32_t v[WIDE ? 64 : 32];
  __device__ inline void set(int i, uint32_t g) {
    if (WIDE)
      v[i] = g;
    else if (i & 1)
      v[i >> 1] = (v[i >> 1] & 0xFFFFu) | (g << 16);
    else
      v[i >> 1] = (v[i >> 1] & 0xFFFF0000u) | g;
  }
  __device__ inline uint32_t get(int i) const {
    if (WIDE) return v[i];
    return (i & 1) ? v[i >> 1] >> 16 : v[i >> 1] & 0xFFFFu;
  }
};

// The strict-less update of group g from its accumulator: minimum
// i = 4 j + 2 h + e holds (query row h, group column 8 j + 2 t + e).
// dist = max(base + bias + mul acc, lo), i.e. max((qq + xx) - 2 acc, 0),
// or (1 + 0) - acc for cosine, rounded as the plain version rounds.
template <bool WIDE>
__device__ inline void update(const float (&acc)[64], float (&best)[64],
                              Ordinals<WIDE>& ord, const float* bias, int t,
                              float base0, float base1, float mul, float lo,
                              uint32_t g) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 x2 = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const float v = fmaxf(
            fmaf(mul, acc[i], (h ? base1 : base0) + (e ? x2.y : x2.x)), lo);
        if (v < best[i]) {
          best[i] = v;
          ord.set(i, g);
        }
      }
    }
  }
}

template <bool RESIDENT, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
bucket_scan_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap qmap,
                   const float* __restrict__ qq, const float* __restrict__ xx,
                   float* __restrict__ out_d, int* __restrict__ out_i, int Q,
                   int d_pad, int n_valid, int span, int W, int cosine,
                   int ns) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int nk = (d_pad + KS - 1) / KS;  // slices per group
  const Layout L = make_layout(nk, RESIDENT, ns);
  float* bias = reinterpret_cast<float*>(smem + L.bias);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // TMA landed
  uint64_t* empty = full + NS_MAX;   // consumed by every consumer warp
  uint64_t* xfull = empty + NS_MAX;  // a group's bias staged
  uint64_t* xempty = xfull + XB;     // ... read
  uint64_t* qfull = xempty + XB;     // the resident query tile landed

  const int q0 = blockIdx.x * QB;
  const int sc = blockIdx.y;
  const long long r_begin = (long long)sc * span;
  const long long r_end = min(r_begin + span, (long long)n_valid);
  const int ngroups =
      r_end > r_begin ? (int)((r_end - r_begin + GR - 1) / GR) : 0;
  const int nsteps = ngroups * nk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int i = 0; i < ns; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CWARPS);
    }
    for (int i = 0; i < XB; ++i) {
      mbar_init(&xfull[i], 32);
      mbar_init(&xempty[i], CWARPS);
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CWARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == CWARPS && lane == 0 && nsteps > 0) {
      // TMA issue: the query tile once, then step s of the walk (group
      // s / nk, features (s % nk) * 64) into slot s % ns once every
      // consumer warp has released the slot's previous step
      if (RESIDENT) {
        mbar_expect(qfull, nk * QSLICE);
        for (int j = 0; j < nk; ++j)
          tma_2d(smem + L.qs + (size_t)j * QSLICE, &qmap, j * KS, q0, qfull);
      }
      // slot = s % ns, round = (s / ns) & 1, row and col of step s
      int slot = 0, col = 0, row = (int)r_begin;
      uint32_t round = 0;
      for (int s = 0; s < nsteps; ++s) {
        if (s >= ns) mbar_wait(&empty[slot], round ^ 1u);
        unsigned char* dst = smem + L.xs + (size_t)slot * L.slot;
        mbar_expect(&full[slot], (int)L.slot);
        tma_2d(dst, &xmap, col, row, &full[slot]);
        if (!RESIDENT) tma_2d(dst + XSLICE, &qmap, col, q0, &full[slot]);
        if (++slot == ns) slot = 0, round ^= 1u;
        if ((col += KS) >= d_pad) col = 0, row += GR;
      }
    } else if (warp == CWARPS + 1) {
      // each group's bias per row: |x|^2 (0 for cosine), +inf past n_valid
      for (int g = 0; g < ngroups; ++g) {
        const int b = g % XB;
        if (g >= XB) mbar_wait(&xempty[b], (uint32_t)(g / XB - 1) & 1u);
        const long long row0 = r_begin + (long long)g * GR;
        for (int c = lane; c < GR; c += 32) {
          const long long r = row0 + c;
          bias[b * GR + c] = r < r_end ? (cosine ? 0.f : xx[r]) : CUDART_INF_F;
        }
        mbar_arrive(&xfull[b]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
    const int r0 = q0 + 64 * wg + 16 * w + g;  // the thread's rows r0, r0 + 8
    const float mul = cosine ? -1.f : -2.f;
    const float lo = cosine ? -CUDART_INF_F : 0.f;
    const float base0 = cosine ? 1.f : (r0 < Q ? qq[r0] : 0.f);
    const float base1 = cosine ? 1.f : (r0 + 8 < Q ? qq[r0 + 8] : 0.f);
    float acc[64];
    float best[64];
    Ordinals<WIDE> ord;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      best[i] = CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < (WIDE ? 64 : 32); ++i) ord.v[i] = 0u;
    if (RESIDENT && nsteps > 0) mbar_wait(qfull, 0);
    const uint32_t xs = smem_addr(smem + L.xs);
    const uint32_t qa = RESIDENT ? smem_addr(smem + L.qs) + wg * (QSLICE / 2)
                                 : xs + XSLICE + wg * (QSLICE / 2);
    auto release = [&](int slot) {
      if (lane == 0) mbar_arrive(&empty[slot]);
    };
    int slot = 0, prev = 0;  // slot = s % ns for step s = gi * nk + j
    uint32_t round = 0;      // (s / ns) & 1

    for (int gi = 0; gi < ngroups; ++gi) {
      pin(acc);
      for (int j = 0; j < nk; ++j) {
        mbar_wait(&full[slot], round);
        const uint32_t b = xs + slot * (uint32_t)L.slot;
        const uint32_t a = qa + (RESIDENT ? j * QSLICE : slot * (uint32_t)L.slot);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)  // past d_pad both sides are 0
          wgmma_bf16(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32),
                     j > 0 || kk > 0);
        wgmma_commit();
        if (j > 0) {  // the previous slice's products are done
          wgmma_wait<1>();
          release(prev);
        }
        prev = slot;
        if (++slot == ns) slot = 0, round ^= 1u;
      }
      wgmma_wait<0>();
      pin(acc);
      release(prev);

      mbar_wait(&xfull[gi % XB], (uint32_t)(gi / XB) & 1u);
      update(acc, best, ord, bias + (gi % XB) * GR, t, base0, base1, mul, lo,
             (uint32_t)gi);
      __syncwarp();
      if (lane == 0) mbar_arrive(&xempty[gi % XB]);
    }

    // the block's slice of the table: row = group start + fixed column
    const size_t col0 = (size_t)sc * GR + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= Q) continue;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int i = 4 * jj + 2 * h, c = 8 * jj + 2 * t;
        const size_t o = (size_t)r * W + col0 + 8 * jj;
        int2 rows;
        rows.x = best[i] == CUDART_INF_F
                     ? -1
                     : (int)(r_begin + (long long)ord.get(i) * GR + c);
        rows.y = best[i + 1] == CUDART_INF_F
                     ? -1
                     : (int)(r_begin + (long long)ord.get(i + 1) * GR + c + 1);
        *reinterpret_cast<float2*>(out_d + o) = make_float2(best[i], best[i + 1]);
        *reinterpret_cast<int2*>(out_i + o) = rows;
      }
    }
  }
}

template <bool RESIDENT, bool WIDE>
int launch(const CUtensorMap& xmap, const CUtensorMap& qmap, const float* qq,
           const float* xx, float* out_d, int* out_i, int Q, int d_pad,
           int n_valid, int span, int n_super, int cosine, int ns,
           cudaStream_t stream) {
  const size_t smem = make_layout((d_pad + KS - 1) / KS, RESIDENT, ns).bytes;
  auto kernel = bucket_scan_kernel<RESIDENT, WIDE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + QB - 1) / QB, n_super);
  kernel<<<grid, THREADS, smem, stream>>>(xmap, qmap, qq, xx, out_d, out_i, Q,
                                          d_pad, n_valid, span, n_super * GR,
                                          cosine, ns);
  return (int)cudaGetLastError();
}

}  // namespace bucket
}  // namespace vers

// q (Q x d_pad) and x (n_rows x d_pad) bf16, zero past the features;
// qq (Q,) and xx (n_rows,) f32; out_d / out_i (Q, n_super * 128), which
// the kernel writes in full.
extern "C" int vers_bucket_scan(const void* q, const void* x, const float* qq,
                                const float* xx, float* out_d, int* out_i,
                                int Q, int n_rows, int d_pad, int n_valid,
                                int span, int n_super, int cosine,
                                void* stream) {
  using namespace vers::bucket;
  if (Q <= 0 || n_super <= 0) return 0;
  if (d_pad <= 0 || d_pad % 16 != 0 || span <= 0 || span % GR != 0 ||
      n_super > 65535 || n_rows <= 0 ||
      (long long)n_super * span < (long long)n_rows ||
      (long long)(n_super - 1) * span >= (long long)n_rows ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_valid > n_rows) n_valid = n_rows;
  if (n_valid < 0) n_valid = 0;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  // the resident query tile beside at least NS_MIN slots, else each slot
  // carries its query slice; as many slots as fit, up to NS_MAX
  const int nk = (d_pad + KS - 1) / KS;
  const bool resident =
      make_layout(nk, true, NS_MIN).bytes <= (size_t)max_smem;
  int ns = NS_MAX;
  while (ns > 2 && make_layout(nk, resident, ns).bytes > (size_t)max_smem)
    --ns;
  if (make_layout(nk, resident, ns).bytes > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  const bool wide = span / GR > ORD16;
  CUtensorMap xmap = {}, qmap = {};
  e = vers::dtk::encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                           n_rows, d_pad, GR, KS);
  if (e != cudaSuccess) return (int)e;
  e = vers::dtk::encode_2d(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, Q,
                           d_pad, QB, KS);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
#define VERS_D_ARGS                                                       \
  xmap, qmap, qq, xx, out_d, out_i, Q, d_pad, n_valid, span, n_super, cosine, \
      ns, st
  if (resident)
    return wide ? launch<true, true>(VERS_D_ARGS) : launch<true, false>(VERS_D_ARGS);
  return wide ? launch<false, true>(VERS_D_ARGS) : launch<false, false>(VERS_D_ARGS);
#undef VERS_D_ARGS
}
