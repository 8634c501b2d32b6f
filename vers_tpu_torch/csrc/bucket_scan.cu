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
// (x, y) owns 64 queries and superchunk y, walks its 128-row groups in
// ascending order, keeps the 64 x 128 (min, row) pairs in registers
// (32 per thread) with strict-less updates, and writes its slice of the
// table once. The query tile is the fastest grid axis, so the blocks in
// flight share one superchunk of corpus rows in L2.
//
// Bound on the H100: the dot products, 2 * Q * N * d flop (9.9e12 at
// 16384 x 1M x 300). They run on the tensor cores as bf16 WMMA 16x16x16
// fragments with f32 accumulation (products of bf16 values are exact in
// f32). Each 64 x 128 group tile goes through shared memory once for the
// bucket update. Corpus traffic from L2 is (Q / 64) x the bf16 corpus.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

namespace vers {
namespace bucket {

using namespace nvcuda;

constexpr int BQ = 64;            // query rows per block
constexpr int BR = 128;           // corpus rows per group: one per lane
constexpr int KC = 64;            // feature columns per shared-memory stage
constexpr int KPAD = KC + 8;      // pitch of the staged slices (bf16)
constexpr int DPITCH = BR + 4;    // pitch of the group's dot tile (f32)
constexpr int NT = 256;           // 8 warps, each a 16 x 64 strip
constexpr int PER = BQ * BR / NT; // (query, lane) pairs per thread

struct Smem {
  __nv_bfloat16 qs[BQ][KPAD];
  __nv_bfloat16 xs[BR][KPAD];
  float dot[BQ][DPITCH];
  float qq[BQ];
};

// Stage columns [k0, k0 + KC) of nr rows of a (.., d_pad) bf16 matrix
// into dst, 8 values (16 bytes) per load; missing rows and columns read
// as zeros.
template <int ROWS>
__device__ inline void stage(__nv_bfloat16 (*dst)[KPAD],
                             const __nv_bfloat16* __restrict__ src, int nr,
                             int d_pad, int k0) {
  for (int e = threadIdx.x; e < ROWS * (KC / 8); e += NT) {
    const int r = e / (KC / 8), c = k0 + (e % (KC / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nr && c < d_pad)
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * d_pad + c);
    *reinterpret_cast<uint4*>(&dst[r][c - k0]) = v;
  }
}

__global__ void __launch_bounds__(NT)
bucket_scan_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ qq, const float* __restrict__ xx,
                   float* __restrict__ out_d, int* __restrict__ out_i, int Q,
                   int d_pad, int n_valid, int span, int W, int cosine) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Q - q0);
  const int sc = blockIdx.y;
  const long long r_begin = (long long)sc * span;
  const long long r_end = min(r_begin + span, (long long)n_valid);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;  // warp strip: rows wr*16, cols wc*64
  const int lane = tid % BR, rb = tid / BR; // update pairs: rows rb + 2 i

  if (tid < BQ) s.qq[tid] = tid < nq ? qq[q0 + tid] : 0.f;
  float best[PER];
  int brow[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    best[i] = CUDART_INF_F;
    brow[i] = -1;
  }
  const __nv_bfloat16* qt = q + (size_t)q0 * d_pad;

  for (long long g0 = r_begin; g0 < r_end; g0 += BR) {
    const int ng = (int)min((long long)BR, r_end - g0);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k0 = 0; k0 < d_pad; k0 += KC) {
      stage<BQ>(s.qs, qt, nq, d_pad, k0);
      stage<BR>(s.xs, x + (size_t)g0 * d_pad, ng, d_pad, k0);
      __syncthreads();
      const int kmax = min(KC, d_pad - k0);
      for (int kk = 0; kk < kmax; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, &s.qs[wr * 16][kk], KPAD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> b;
          wmma::load_matrix_sync(b, &s.xs[wc * 64 + j * 16][kk], KPAD);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(&s.dot[wr * 16][wc * 64 + j * 16], acc[j],
                              DPITCH, wmma::mem_row_major);
    __syncthreads();

    // strict-less bucket update in ascending row order: lowest row wins
    if (lane < ng) {
      const int row = (int)(g0 + lane);
      const float xr = xx[row];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int r = rb + 2 * i;
        const float dt = s.dot[r][lane];
        const float dist =
            cosine ? 1.f - dt : fmaxf(s.qq[r] + xr - 2.f * dt, 0.f);
        if (dist < best[i]) {
          best[i] = dist;
          brow[i] = row;
        }
      }
    }
    // the next write of s.dot comes after the next group's barriers
  }

  const size_t col = (size_t)sc * BR + lane;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = rb + 2 * i;
    if (r < nq) {
      out_d[(size_t)(q0 + r) * W + col] = best[i];
      out_i[(size_t)(q0 + r) * W + col] = brow[i];
    }
  }
}

}  // namespace bucket
}  // namespace vers

extern "C" int vers_bucket_scan(const void* q, const void* x, const float* qq,
                                const float* xx, float* out_d, int* out_i,
                                int Q, int n_rows, int d_pad, int n_valid,
                                int span, int n_super, int cosine,
                                void* stream) {
  using namespace vers::bucket;
  if (Q <= 0 || n_super <= 0) return 0;
  if (d_pad <= 0 || d_pad % 8 != 0 || span <= 0 || span % BR != 0 ||
      n_super > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_valid > n_rows) n_valid = n_rows;
  if (n_valid < 0) n_valid = 0;
  const size_t smem = sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      bucket_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + BQ - 1) / BQ, n_super);
  bucket_scan_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(x), qq, xx, out_d, out_i, Q,
      d_pad, n_valid, span, n_super * BR, cosine);
  return (int)cudaGetLastError();
}
