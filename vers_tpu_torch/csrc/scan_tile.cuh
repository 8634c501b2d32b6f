// Shared pieces of the two scan kernels (distance_topk.cu,
// packed_scan.cu): an f32 distance tile computed with CUDA-core FMAs
// from shared-memory staged slices, and a per-query running top-k kept
// in shared memory by sorted insertion.
//
// Tie rule. Both TPU kernels merge each corpus chunk into the carried
// best set so that the carried entries win ties, then the lower column
// (vers_tpu/ops/pallas_topk.py:_merge_topk). Walking the candidates in
// ascending row order and inserting only on a STRICTLY smaller distance
// keeps equal distances in arrival order, which is the same rule.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace vers {

constexpr int QT = 64;        // query rows per block
constexpr int CT = 128;       // corpus rows per chunk
constexpr int DK = 16;        // feature columns per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads; each owns a 4 x 8 sub-tile

struct TileSmem {
  float qs[DK][QT + 1];    // query slice, transposed (+1: bank spread)
  float xs[DK][CT + 1];    // corpus slice, transposed
  float dist[QT][CT + 1];  // the chunk's distance tile
  float qq[QT];            // squared query norms
  int qbin[QT];            // packed scan: bin of each query row
  int rbin[CT];            // packed scan: bin of each corpus row
  int cid[CT];             // id written for each corpus column
};

// Dynamic shared memory: TileSmem, then the (k, QT) best distances and
// the (k, QT) best ids, stored rank-major so a warp's rows hit distinct
// banks.
__host__ __device__ inline size_t smem_bytes(int k) {
  return sizeof(TileSmem) + (size_t)k * QT * (sizeof(float) + sizeof(int));
}

// Squared norms of the block's nq query rows (rows >= nq get 0), one
// warp per row, lanes striding the feature axis.
__device__ inline void query_norms(const float* __restrict__ q, int nq,
                                   int ldq, int d, TileSmem& s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < QT; r += THREADS / 32) {
    float acc = 0.f;
    if (r < nq) {
      const float* row = q + (size_t)r * ldq;
      for (int c = lane; c < d; c += 32) acc = fmaf(row[c], row[c], acc);
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s.qq[r] = acc;
  }
}

// acc[i][j] = dot(query row ty + 16 i, corpus row tx + 16 j) over the
// d features, for the nq query rows at q and the nx corpus rows at x
// (missing rows read as zeros). Ends on a barrier, so the slices may be
// overwritten right after.
__device__ inline void tile_dots(const float* __restrict__ q, int nq, int ldq,
                                 const float* __restrict__ x, int nx, int ldx,
                                 int d, TileSmem& s, float (&acc)[4][8]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += DK) {
    for (int e = tid; e < QT * DK; e += THREADS) {
      const int r = e / DK, kk = e % DK, c = k0 + kk;
      s.qs[kk][r] = (r < nq && c < d) ? q[(size_t)r * ldq + c] : 0.f;
    }
    for (int e = tid; e < CT * DK; e += THREADS) {
      const int r = e / DK, kk = e % DK, c = k0 + kk;
      s.xs[kk][r] = (r < nx && c < d) ? x[(size_t)r * ldx + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.qs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = s.xs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The TPU kernels' distance: max(|q|^2 + |x|^2 - 2 q.x, 0), or 1 - q.x
// for cosine.
__device__ inline float distance(float dot, float qq, float xx, int cosine) {
  return cosine ? 1.f - dot : fmaxf(qq + xx - 2.f * dot, 0.f);
}

__device__ inline void init_best(float* bd, int* bi, int k) {
  for (int e = threadIdx.x; e < k * QT; e += THREADS) {
    bd[e] = CUDART_INF_F;
    bi[e] = -1;
  }
}

// Merge the distance tile's first nx columns into the best sets of the
// block's first nq rows: one thread per row, columns in ascending order,
// strict-less sorted insertion. Column c carries id s.cid[c].
__device__ inline void merge_tile(TileSmem& s, float* bd, int* bi, int k,
                                  int nq, int nx) {
  const int r = threadIdx.x;
  if (r >= QT || r >= nq) return;
  float kth = bd[(k - 1) * QT + r];
  for (int c = 0; c < nx; ++c) {
    const float v = s.dist[r][c];
    if (v < kth) {
      int t = k - 1;
      while (t > 0) {
        const float prev = bd[(t - 1) * QT + r];
        if (prev <= v) break;
        bd[t * QT + r] = prev;
        bi[t * QT + r] = bi[(t - 1) * QT + r];
        --t;
      }
      bd[t * QT + r] = v;
      bi[t * QT + r] = s.cid[c];
      kth = bd[(k - 1) * QT + r];
    }
  }
}

// Write the best sets of rows [0, nq) to out rows row0.., ascending,
// with id -1 wherever the distance is infinite.
__device__ inline void flush_best(const float* bd, const int* bi, int k,
                                  int nq, float* __restrict__ out_d,
                                  int* __restrict__ out_i, size_t row0) {
  for (int e = threadIdx.x; e < nq * k; e += THREADS) {
    const int r = e / k, t = e % k;
    const float v = bd[t * QT + r];
    out_d[(row0 + r) * k + t] = v;
    out_i[(row0 + r) * k + t] = v == CUDART_INF_F ? -1 : bi[t * QT + r];
  }
}

}  // namespace vers
