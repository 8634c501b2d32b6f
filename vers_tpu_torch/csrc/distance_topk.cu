// Kernel A: exact k-NN over a flat corpus with a fused streaming top-k.
//
// Replaces vers_tpu/ops/pallas_topk.py:pallas_distance_topk (body
// _kernel, merge _merge_topk). The TPU grid is (query tile, corpus
// chunk) and carries the best set in VMEM along its sequential chunk
// axis. Hopper blocks run in parallel and in no order, so here each
// block owns one tile of QT queries and walks every corpus chunk itself,
// in ascending order, keeping the (QT, k) best set in shared memory.
//
// Bound on the H100: f32 FMAs on the CUDA cores (no TF32, as the TPU's
// Precision.HIGHEST). Each block rereads the corpus, so device-memory
// traffic is (Q / QT) x corpus bytes; with QT = 64 the tile does 16
// FMAs per byte staged, which keeps it on the FMA side of the roofline.
// A 4 x 8 register sub-tile per thread amortises shared-memory reads.
// The merge inserts only candidates that beat the row's kth distance,
// which after the first chunks is rare, so it costs little next to the
// dot products.
#include "scan_tile.cuh"

namespace vers {

__global__ void __launch_bounds__(THREADS)
distance_topk_kernel(const float* __restrict__ q, const float* __restrict__ x,
                     const float* __restrict__ xx, float* __restrict__ out_d,
                     int* __restrict__ out_i, int Q, int d, int n_valid, int k,
                     int cosine) {
  extern __shared__ float4 smem_raw[];
  TileSmem& s = *reinterpret_cast<TileSmem*>(smem_raw);
  float* bd = reinterpret_cast<float*>(&s + 1);
  int* bi = reinterpret_cast<int*>(bd + (size_t)k * QT);

  const int q0 = blockIdx.x * QT;
  const int nq = min(QT, Q - q0);
  const float* qt = q + (size_t)q0 * d;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  init_best(bd, bi, k);
  query_norms(qt, nq, d, d, s);
  __syncthreads();

  float acc[4][8];
  for (int c0 = 0; c0 < n_valid; c0 += CT) {
    const int nx = min(CT, n_valid - c0);
    if (tid < CT) s.cid[tid] = c0 + tid;
    tile_dots(qt, nq, d, x + (size_t)c0 * d, nx, d, d, s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        s.dist[r][c] = c < nx ? distance(acc[i][j], s.qq[r], xx[c0 + c], cosine)
                              : CUDART_INF_F;
      }
    }
    __syncthreads();
    merge_tile(s, bd, bi, k, nq, nx);
    __syncthreads();
  }
  flush_best(bd, bi, k, nq, out_d, out_i, (size_t)q0);
}

}  // namespace vers

extern "C" int vers_distance_topk(const float* q, const float* x,
                                  const float* xx, float* out_d, int* out_i,
                                  int Q, int n_rows, int d, int n_valid, int k,
                                  int cosine, void* stream) {
  using namespace vers;
  if (Q <= 0) return 0;
  if (n_valid > n_rows) n_valid = n_rows;
  const size_t smem = smem_bytes(k);
  cudaError_t e = cudaFuncSetAttribute(
      distance_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + QT - 1) / QT);
  distance_topk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, x, xx, out_d, out_i, Q, d, n_valid, k, cosine);
  return (int)cudaGetLastError();
}

extern "C" const char* vers_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
