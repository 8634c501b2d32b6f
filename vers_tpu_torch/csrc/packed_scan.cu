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
// Hopper blocks run in no order, so the carry cannot cross blocks.
// Instead block (w, y) returns at once unless item w is the first of
// its run of equal qb; the first block walks the whole run, w, w+1, ...,
// every chunk of every group in order, for query rows
// [qb*q_blk + y*QT, +QT), and writes their best sets once at the end.
// Output rows of blocks without a run keep the (+inf, -1) the wrapper
// fills them with.
//
// Invalid work items all park on one scratch query block whose rows are
// padding (qbin < 0); a run of them would be scanned serially on one SM
// for nothing, so a block whose query rows are all padding returns.
//
// Bound on the H100: f32 FMAs on the CUDA cores, as kernel A. Most of a
// group's rows belong to bins other than a given query's and are masked;
// a chunk whose bins all lie outside the block's query-bin range is
// skipped before any dot product (skipping only drops +inf candidates,
// so results are unchanged).
#include <climits>

#include "scan_tile.cuh"

namespace vers {

__global__ void __launch_bounds__(THREADS)
packed_scan_kernel(const float* __restrict__ q_stack,
                   const int* __restrict__ qbin, const int* __restrict__ qb,
                   const int* __restrict__ gb, const float* __restrict__ corpus,
                   const int* __restrict__ rbin, const float* __restrict__ xx,
                   const int* __restrict__ ids, float* __restrict__ out_d,
                   int* __restrict__ out_i, int n_rows, int d, int W,
                   int q_blk, int r_blk, int k, int cosine) {
  const int w = blockIdx.x;
  const int block = qb[w];
  if (w > 0 && qb[w - 1] == block) return;  // not the first visit
  const int y0 = blockIdx.y * QT;
  const int row0 = block * q_blk + y0;
  const int nq = min(min(QT, q_blk - y0), n_rows - row0);
  if (nq <= 0) return;

  extern __shared__ float4 smem_raw[];
  TileSmem& s = *reinterpret_cast<TileSmem*>(smem_raw);
  float* bd = reinterpret_cast<float*>(&s + 1);
  int* bi = reinterpret_cast<int*>(bd + (size_t)k * QT);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  // the block's live query bins and their range
  const int my_bin = tid < nq ? qbin[row0 + tid] : -1;
  if (tid < QT) s.qbin[tid] = my_bin;
  if (!__syncthreads_or(my_bin >= 0)) return;  // all padding
  __shared__ int bin_lo, bin_hi;
  if (tid == 0) {
    bin_lo = INT_MAX;
    bin_hi = -1;
  }
  __syncthreads();
  if (my_bin >= 0) {
    atomicMin(&bin_lo, my_bin);
    atomicMax(&bin_hi, my_bin);
  }
  const float* qt = q_stack + (size_t)row0 * d;
  init_best(bd, bi, k);
  query_norms(qt, nq, d, d, s);
  __syncthreads();
  const int lo = bin_lo, hi = bin_hi;

  float acc[4][8];
  for (int v = w; v < W && qb[v] == block; ++v) {
    const size_t base = (size_t)gb[v] * r_blk;
    for (int c0 = 0; c0 < r_blk; c0 += CT) {
      const int nx = min(CT, r_blk - c0);
      const int rb = tid < nx ? rbin[base + c0 + tid] : -1;
      // barrier: also orders this chunk's staging after the last merge
      if (!__syncthreads_or(rb >= lo && rb <= hi)) continue;
      if (tid < CT) {
        s.rbin[tid] = rb;
        s.cid[tid] = tid < nx ? (ids ? ids[base + c0 + tid]
                                     : (int)(base + c0 + tid))
                              : -1;
      }
      tile_dots(qt, nq, d, corpus + (base + c0) * d, nx, d, d, s, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qbr = s.qbin[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 16 * j;
          const bool ok = c < nx && qbr >= 0 && qbr == s.rbin[c];
          s.dist[r][c] =
              ok ? distance(acc[i][j], s.qq[r], xx[base + c0 + c], cosine)
                 : CUDART_INF_F;
        }
      }
      __syncthreads();
      merge_tile(s, bd, bi, k, nq, nx);
    }
  }
  __syncthreads();
  flush_best(bd, bi, k, nq, out_d, out_i, (size_t)row0);
}

}  // namespace vers

extern "C" int vers_packed_scan(const float* q_stack, const int* qbin,
                                const int* qb, const int* gb,
                                const float* corpus, const int* rbin,
                                const float* xx, const int* ids, float* out_d,
                                int* out_i, int n_rows, int d, int W,
                                int q_blk, int r_blk, int k, int cosine,
                                void* stream) {
  using namespace vers;
  if (W <= 0 || n_rows <= 0) return 0;
  const size_t smem = smem_bytes(k);
  cudaError_t e = cudaFuncSetAttribute(
      packed_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(W, (q_blk + QT - 1) / QT);
  packed_scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q_stack, qbin, qb, gb, corpus, rbin, xx, ids, out_d, out_i, n_rows, d,
      W, q_blk, r_blk, k, cosine);
  return (int)cudaGetLastError();
}
