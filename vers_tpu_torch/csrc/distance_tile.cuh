// Tile pieces of kernel A (distance_topk.cu): a ring of corpus slices
// loaded by TMA, f32-accurate dot products on the tensor cores by the
// 3xTF32 split with warpgroup MMAs (wgmma), and the filtered merge into
// per-query best sets.
//
// 3xTF32. Each f32 operand v splits into hi = tf32(v), rounded to
// nearest with ties away from zero as PTX's cvt.rna.tf32.f32 rounds (raw
// f32 bits fed to a tf32 MMA would be truncated), and lo = v - hi, which
// the MMA reads truncated to tf32. hi*hi + hi*lo + lo*hi keeps ~21 of
// f32's 24 mantissa bits of every product; the dropped lo*lo term is
// below 2^-22 of it. The products are exact in the tensor core and
// summed in f32.
//
// wgmma.m64n64k8 .tf32: A (64 queries x 8 features) from registers, B
// (64 corpus rows x 8 features) from shared memory, both K-major. Per
// warp w of the warpgroup (g = lane / 4, t = lane % 4) A is
// a0 (16w + g, t), a1 (16w + g + 8, t), a2 (16w + g, t + 4),
// a3 (16w + g + 8, t + 4), and the 32 accumulators are, for each 8-row
// corpus group j, d[4j + 2h + e] = (query 16w + g + 8h, row 8j + 2t + e).
// A staged slice (128 rows x 32 features) has rows of 128 bytes in the
// 128-byte swizzle that TMA writes and wgmma reads: 16-byte chunk c of
// row r sits at chunk c ^ (r % 8). The resident query tile stores
// features 8j + t and 8j + t + 4 side by side, so that (a0, a2) and
// (a1, a3) are 8-byte loads.
//
// The bf16 routes (a bf16 corpus, precisions "high" and "default") use
// wgmma.m64n64k16 .bf16 instead: the same 16 KB slot holds a 128-row x
// 64-feature bf16 slice in the same 128-byte swizzle (chunk = 8
// features), and A is per warp a0 (16w + g, 2t..2t+1), a1 (16w + g + 8,
// 2t..2t+1), a2 (16w + g, 2t+8..2t+9), a3 (16w + g + 8, 2t+8..2t+9), two
// bf16 a register, the lower feature in the low half. The resident query
// tile of those routes is row-major. A product of two bf16 values is
// exact in the tensor core; the sums are f32.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace vers {
namespace dtk {

constexpr int QT = 64;        // query rows per block (wgmma M)
constexpr int CT = 128;       // corpus rows per tile: 64 per warpgroup
constexpr int DK = 32;        // features per pipeline stage
constexpr int SLICE = CT * DK;  // floats per staged slice
constexpr int DP = CT + 4;    // pitch of the distance tile
constexpr int CONSUMERS = 256;  // 2 warpgroups: wgmma and the epilogue
constexpr int PRODUCERS = 128;  // 1 warpgroup: loads and the hi/lo split
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int MASKW = CT / 32;  // candidate bit words per query row
constexpr int UNITS = SLICE / 4 / PRODUCERS;  // 16-byte units per producer
constexpr int NS = 3;         // slots in the ring of staged slices

// Byte offsets into the dynamic shared memory (from a 1024-byte aligned
// base, as the swizzle needs): the ring of NS slices (each split in place
// to its tf32 hi part) and their lo parts, the resident query tile (f32;
// absent when it does not fit), the distance tile, candidate masks,
// norms, kth distances, |x|^2 per slot, the mbarriers (full, ready and
// empty per slot; filtered, merged) and the best sets. The query pitch
// qp, 8 or 24 mod 32 floats, makes the 8-byte fragment loads of a half
// warp (rows g, features 2t, 2t + 1) hit 32 distinct banks.
struct Layout {
  int qp;
  size_t xs, lo, qs, dist, mask, qq, kth, xx, bar, bd, bi, bytes;
};

// bf: the bf16 routes, whose MMA steps are 16 features deep.
__host__ __device__ inline Layout make_layout(int d, int k, bool resident,
                                              bool bf = false) {
  Layout L;
  const int dm = bf ? (d + 15) / 16 * 16 : (d + 7) / 8 * 8;  // MMA depth
  L.qp = resident ? (dm % 16 ? dm : dm + 8) : 0;
  size_t o = 0;
  L.xs = o;
  o += (size_t)NS * SLICE * sizeof(float);
  L.lo = o;
  o += (size_t)NS * SLICE * sizeof(float);
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
  o += (size_t)NS * CT * sizeof(float);
  L.bar = o;
  o += (size_t)(3 * NS + 2) * sizeof(uint64_t);
  L.bd = o;
  o += (size_t)k * QT * sizeof(float);
  L.bi = o;
  o += (size_t)k * QT * sizeof(int);
  L.bytes = o + 1024;  // room to align the base
  return L;
}

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Arrive on bar and have its phase also wait for `bytes` of TMA data.
__device__ inline void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// TMA: the box at (col, row) of a 2-D tensor map into dst, completing
// on bar. Out-of-range rows and columns land as zeros.
__device__ inline void tma_2d(void* dst, const CUtensorMap* map, int col,
                              int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

// TMA: slice rows [row, row + CT), features [col, col + DK) of the
// corpus into dst, completing on bar (which expects the bytes first).
__device__ inline void tma_slice(float* dst, const CUtensorMap* map, int col,
                                 int row, uint64_t* bar) {
  mbar_expect(bar, (int)(SLICE * sizeof(float)));
  tma_2d(dst, map, col, row, bar);
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// Without TMA (rows not 16-byte aligned): 4-byte cp.async with zero fill
// (valid == false copies nothing and writes zeros) into the same layout.
__device__ inline void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Without TMA: features [k0, k0 + DK) of corpus rows [g0, g0 + CT) into
// the slice dst by cp.async, rows >= r_end and features >= d as zeros.
// Producer p copies the 16-byte units that split_unit has it convert, so
// its own cp.async.wait_group is enough before it converts them.
__device__ inline void copy_units(float* dst, const float* __restrict__ x,
                                  long long g0, long long r_end, int d, int k0,
                                  int p) {
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = i * PRODUCERS + p, r = u / 8;
    const int c = k0 + ((u % 8) ^ (r % 8)) * 4;  // the unit's first feature
    for (int e = 0; e < 4; ++e) {
      const bool ok = g0 + r < r_end && c + e < d;
      cp_async4(dst + u * 4 + e, ok ? x + (g0 + r) * d + c + e : x, ok);
    }
  }
}

// cp.async of N bytes (4 or 16) with zero fill: valid == false copies
// nothing and writes N zero bytes.
template <int N>
__device__ inline void cp_async_n(void* dst, const void* src, bool valid) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N), "r"(valid ? N : 0)
                 : "memory");
}

// A bf16 corpus: features k0 .. k0 + 63 of corpus rows [g0, g0 + CT) into
// the slice dst (128-byte rows, 16-byte unit u = row u / 8, features
// k0 + 8 ((u % 8) ^ (row % 8)) ..), rows >= r_end and features >= d as
// zeros. No TMA: a row of d bf16 is 16-byte aligned only when d % 8 == 0.
// gran 16 copies a unit by one cp.async, gran 4 by four (d even), and
// gran 2 (d odd) loads it by plain 2-byte loads and stores it. Producer p
// copies the units it later sums (square_unit_bf16), so its own
// cp.async.wait_group is enough before it reads them.
__device__ inline void copy_units_bf16(float* dst,
                                       const uint16_t* __restrict__ x,
                                       long long g0, long long r_end, int d,
                                       int k0, int p, int gran) {
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = i * PRODUCERS + p, r = u / 8;
    const int c = k0 + ((u % 8) ^ (r % 8)) * 8;  // the unit's first feature
    const bool row = g0 + r < r_end;
    const uint16_t* src = x + (g0 + r) * d + c;
    unsigned char* out = reinterpret_cast<unsigned char*>(dst) + u * 16;
    if (gran == 16) {
      cp_async_n<16>(out, row && c < d ? src : x, row && c < d);
    } else if (gran == 4) {
      for (int e = 0; e < 4; ++e) {
        const bool ok = row && c + 2 * e < d;
        cp_async_n<4>(out + 4 * e, ok ? src + 2 * e : x, ok);
      }
    } else {
      uint32_t w[4];
      for (int e = 0; e < 4; ++e) {
        const uint32_t a = row && c + 2 * e < d ? __ldg(src + 2 * e) : 0u;
        const uint32_t b = row && c + 2 * e + 1 < d ? __ldg(src + 2 * e + 1) : 0u;
        w[e] = a | (b << 16);
      }
      *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The squares of the 8 bf16 values of unit u of a landed slice, widened
// to f32, added to xacc.
__device__ inline void square_unit_bf16(const float* xs, int u, float& xacc) {
  const uint4 v = *reinterpret_cast<const uint4*>(xs + u * 4);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float a = __uint_as_float(w[e] << 16);
    const float b = __uint_as_float(w[e] & 0xFFFF0000u);
    xacc = fmaf(a, a, xacc);
    xacc = fmaf(b, b, xacc);
  }
}

// bf16 bits of v rounded to nearest even, as torch and XLA round f32 to
// bf16 (finite v), and the value of such bits.
__device__ inline uint32_t bf16_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}
__device__ inline float bf16_value(uint32_t b) { return __uint_as_float(b << 16); }

// v as P bf16 parts, each the rounding of what the parts before it leave
// (each residual is exact in f32): P = 1 is bf16(v); P = 2 the TPU's
// bf16_3x split hi + lo; P = 3 holds all 24 bits of an f32 mantissa.
template <int P>
__device__ inline void split_bf16(float v, uint32_t (&part)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    part[i] = bf16_bits(v);
    v -= bf16_value(part[i]);
  }
}

// An f32 corpus on a bf16 route: the 8 features of unit u (as in
// copy_units_bf16) of corpus rows [g0, g0 + CT), loaded straight from
// global memory (two 16-byte loads when vec: rows 16-byte aligned),
// zeros past r_end and d.
__device__ inline void load_unit_f32(float (&v)[8],
                                     const float* __restrict__ x, long long g0,
                                     long long r_end, int d, int k0, int u,
                                     bool vec) {
  const int r = u / 8, c = k0 + ((u % 8) ^ (r % 8)) * 8;
  const bool row = g0 + r < r_end;
  const float* src = x + (g0 + r) * d + c;
  if (vec) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 a =
        row && c < d ? __ldg(reinterpret_cast<const float4*>(src)) : z;
    const float4 b =
        row && c + 4 < d ? __ldg(reinterpret_cast<const float4*>(src + 4)) : z;
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = row && c + e < d ? __ldg(src + e) : 0.f;
  }
}

// ... stored as P bf16 parts (split_bf16): part 0 into the slice xs,
// part 1 into lo, at unit u; the squares of the f32 values go to xacc.
template <int P>
__device__ inline void store_unit_bf16(const float (&v)[8], float* xs,
                                       float* lo, int u, float& xacc) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t a[P], b[P];
    split_bf16<P>(v[2 * e], a);
    split_bf16<P>(v[2 * e + 1], b);
    h[e] = a[0] | (b[0] << 16);
    l[e] = P > 1 ? a[P - 1] | (b[P - 1] << 16) : 0u;
    xacc = fmaf(v[2 * e], v[2 * e], xacc);
    xacc = fmaf(v[2 * e + 1], v[2 * e + 1], xacc);
  }
  *reinterpret_cast<uint4*>(xs + u * 4) = make_uint4(h[0], h[1], h[2], h[3]);
  if (P > 1)
    *reinterpret_cast<uint4*>(lo + u * 4) = make_uint4(l[0], l[1], l[2], l[3]);
}

// The split. A tf32 MMA reads the top 19 bits of each operand and
// ignores the 13 below. hi: add half a tf32 ulp to the magnitude (the
// sign bit is apart) and clear the 13 bits, which rounds v to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds; lo = v - hi, exact in
// f32, passed as it is (the MMA reads it truncated: 2^-21 of v).
__device__ inline void split3(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// Split 16-byte unit u (row u / 8) of a landed slice in place to its
// tf32 hi part and write its lo part to lo (same layout); add its squares
// to xacc. Producer p converts units i * PRODUCERS + p: every access is
// 16 consecutive bytes per thread, consecutive across a warp, and a row's
// 8 units are 8 consecutive threads.
__device__ inline void split_unit(float* xs, float* lo, int u, float& xacc) {
  const float4 v = *reinterpret_cast<const float4*>(xs + u * 4);
  uint4 h, l;
  split3(v.x, h.x, l.x);
  split3(v.y, h.y, l.y);
  split3(v.z, h.z, l.z);
  split3(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(xs + u * 4) = h;
  *reinterpret_cast<uint4*>(lo + u * 4) = l;
  xacc = fmaf(v.x, v.x, xacc);
  xacc = fmaf(v.y, v.y, xacc);
  xacc = fmaf(v.z, v.z, xacc);
  xacc = fmaf(v.w, v.w, xacc);
}

// Descriptor of a K-major operand in the 128-byte swizzle (rows of 128
// bytes, 8-row groups 1024 bytes apart) at shared address a: its row
// block's 1024-byte aligned start plus the byte offset along the row.
// b_desc: the 64-row x 8-feature B operand at row block p plus k_bytes.
__device__ inline uint64_t sw128_desc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ inline uint64_t b_desc(const float* p, int k_bytes) {
  return sw128_desc(smem_addr(p) + k_bytes);
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// acc = (scale ? acc : 0) + A (registers) x B (descriptor)^T,
// m64n64k8 tf32.
__device__ inline void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                  uint64_t desc, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale)
      : "memory");
}

// acc = (scale ? acc : 0) + A (registers) x B (descriptor)^T,
// m64n64k16 bf16 -> f32, B K-major.
__device__ inline void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                     uint64_t desc, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale)
      : "memory");
}

// Pin registers at this point of the volatile asm sequence: the A
// fragments are computed before the wgmma fence and the accumulators are
// not touched while the wgmmas run (otherwise ptxas fences between them).
__device__ inline void pin(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]));
}
__device__ inline void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// cuTensorMapEncodeTiled, looked up at run time with
// cudaGetDriverEntryPoint (no link to libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A row-major (rows x cols) matrix of elem-byte values as a TMA tensor:
// boxes of box_rows x box_cols, 128-byte swizzle, zeros outside. Needs
// 16-byte aligned rows and a box row of at most 128 bytes.
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                             int elem, const void* p, long long rows,
                             long long cols, int box_rows, int box_cols) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !encode)
      return cudaErrorSymbolNotFound;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(p), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The TPU kernel's distance: max(|q|^2 + |x|^2 - 2 q.x, 0), or 1 - q.x
// for cosine.
__device__ inline float distance(float dot, float qq, float xx, int cosine) {
  return cosine ? 1.f - dot : fmaxf(qq + xx - 2.f * dot, 0.f);
}

// Merge the candidates of query row r (bits of mask, values in dist)
// into its best set (bd, bi: rank-major, QT apart) in ascending column
// order by strict-less sorted insertion, so equal distances keep row
// order. Clears the row's bits and returns the row's new kth distance.
__device__ inline float merge_row(int r, unsigned* mask, const float* dist,
                                  float* bd, int* bi, int k, float kth,
                                  long long row0) {
  for (int w = 0; w < MASKW; ++w) {
    unsigned bits = mask[r * MASKW + w];
    if (!bits) continue;
    mask[r * MASKW + w] = 0;
    while (bits) {
      const int c = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      const float v = dist[r * DP + c];
      if (!(v < kth)) continue;
      int t = k - 1;
      while (t > 0) {
        const float prev = bd[(t - 1) * QT + r];
        if (prev <= v) break;
        bd[t * QT + r] = prev;
        bi[t * QT + r] = bi[(t - 1) * QT + r];
        --t;
      }
      bd[t * QT + r] = v;
      bi[t * QT + r] = (int)(row0 + c);
      kth = bd[(k - 1) * QT + r];
    }
  }
  return kth;
}

}  // namespace dtk
}  // namespace vers
