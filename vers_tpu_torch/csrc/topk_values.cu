// Kernel C: the k smallest values of each row of a (Q, W) f32 array,
// carrying an int32 id per entry.
//
// Replaces vers_tpu/ops/pallas_topk.py:pallas_topk_values (body
// _values_kernel). The TPU kernel walks column chunks in order and merges
// each into a carried (QT, k) set by k extract-min passes, carried
// entries first: equal values come out in ascending column order, i.e.
// a stable sort by value. Its caller is stage 2 of the bucket scan
// (kernel D), which hands it the bucket table.
//
// Bound on the H100: reading the values once (Q * W * 4 bytes; 16384 x
// 8960 is 0.59 GB, ~0.18 ms at 3.35 TB/s). There is no reuse, so the
// design is one warp per row with coalesced reads: lane j takes columns
// j, j + 32, ... in ascending order, four loads in flight, and keeps its
// own k smallest by strict-less sorted insertion in shared memory (so a
// lane's list is ordered by (value, column)). Once a lane holds k
// entries, most values fail the one compare against its k-th and cost a
// load and a compare. A warp merge then extracts the minimum (value,
// column) over the 32 list heads k times, which is the stable order.
// Only the k winners' ids are read.
#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace vers {

constexpr int VWARPS = 4;  // rows per block, one warp each
constexpr int VUNROLL = 4; // loads in flight per lane

__global__ void __launch_bounds__(VWARPS * 32)
topk_values_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                   float* __restrict__ out_d, int* __restrict__ out_i, int Q,
                   int W, int k) {
  extern __shared__ float4 smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * VWARPS + warp;
  if (row >= Q) return;  // no block-wide barrier below
  // this warp's lists, rank-major: entry t of lane j at [t * 32 + j]
  float* ld = reinterpret_cast<float*>(smem_raw) + (size_t)warp * k * 32;
  int* lc = reinterpret_cast<int*>(reinterpret_cast<float*>(smem_raw) +
                                   (size_t)VWARPS * k * 32) +
            (size_t)warp * k * 32;
  for (int t = 0; t < k; ++t) {
    ld[t * 32 + lane] = CUDART_INF_F;
    lc[t * 32 + lane] = INT_MAX;
  }

  const float* v = vals + (size_t)row * W;
  float kth = CUDART_INF_F;
  for (int c0 = lane; c0 < W; c0 += 32 * VUNROLL) {
    float x[VUNROLL];
#pragma unroll
    for (int u = 0; u < VUNROLL; ++u) {
      const int c = c0 + 32 * u;
      x[u] = c < W ? v[c] : CUDART_INF_F;
    }
#pragma unroll
    for (int u = 0; u < VUNROLL; ++u) {
      if (x[u] < kth) {
        int t = k - 1;
        while (t > 0) {
          const float prev = ld[(t - 1) * 32 + lane];
          if (prev <= x[u]) break;
          ld[t * 32 + lane] = prev;
          lc[t * 32 + lane] = lc[(t - 1) * 32 + lane];
          --t;
        }
        ld[t * 32 + lane] = x[u];
        lc[t * 32 + lane] = c0 + 32 * u;
        kth = ld[(k - 1) * 32 + lane];
      }
    }
  }
  __syncwarp();

  // k extract-min rounds over the 32 list heads, ordered by (value,
  // column); every lane ends a round with the same winner
  int head = 0;
  for (int t = 0; t < k; ++t) {
    const float hv = head < k ? ld[head * 32 + lane] : CUDART_INF_F;
    const int hc = head < k ? lc[head * 32 + lane] : INT_MAX;
    float mv = hv;
    int mc = hc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, mv, off);
      const int oc = __shfl_xor_sync(0xffffffffu, mc, off);
      if (ov < mv || (ov == mv && oc < mc)) {
        mv = ov;
        mc = oc;
      }
    }
    // only finite values were inserted: the rest of the row stays at the
    // wrapper's (+inf, -1)
    if (mv == CUDART_INF_F) break;
    if (hc == mc) ++head;
    if (lane == 0) {
      out_d[(size_t)row * k + t] = mv;
      out_i[(size_t)row * k + t] = isinf(mv) ? -1 : ids[(size_t)row * W + mc];
    }
  }
}

}  // namespace vers

extern "C" int vers_topk_values(const float* vals, const int* ids,
                                float* out_d, int* out_i, int Q, int W, int k,
                                void* stream) {
  using namespace vers;
  if (Q <= 0) return 0;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)VWARPS * k * 32 * (sizeof(float) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      topk_values_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + VWARPS - 1) / VWARPS);
  topk_values_kernel<<<grid, VWARPS * 32, smem, (cudaStream_t)stream>>>(
      vals, ids, out_d, out_i, Q, W, k);
  return (int)cudaGetLastError();
}
