// Kernel A's five bf16 routes (distance_topk.cu has the kernel's entry
// point, its f32 "highest" route and the design they share): a bf16
// corpus at "highest", "high" or "default", and an f32 corpus at "high"
// or "default". Every product is a wgmma .bf16 over bf16 parts of the
// operands, as ops/topk.product_operands rounds them: hi = bf16(v),
// lo = bf16(v - hi), the third part bf16 of the rest.
//
// Bound on the H100: the bf16 MMAs, 2 Q N d flop a query part a corpus
// part (9.94 ms at "default", 16384 x 1M x 300, 989 TFLOP/s), and the
// corpus streamed once per query tile from L2 (600 MB a pass for the bf16
// store at d = 300). Per block the design does about that:
//
// * Query parts resident, made once. At block start all 384 threads turn
//   the block's f32 queries into their AP bf16 parts (AP = 1 at
//   "default", 2 at "high", 3 for a bf16 corpus at "highest") in shared
//   memory, laid out as wgmma's A operand (64-feature slices of 128-byte
//   rows in the 128-byte swizzle), so every MMA reads A and B from shared
//   memory and nothing is re-split per tile.
// * A 128-query tile where it fits. The two consumer warpgroups take 64
//   query rows each against the same staged corpus slice (m64n128k16),
//   so the corpus is read from L2 once per 128 queries: half the traffic
//   of a 64-query tile, where the two warpgroups split the slice's 128
//   rows instead (m64n64k16).
// * MMAs in flight. A consumer issues a slice's MMAs (all its 16-feature
//   steps and all parts), commits them as one group and waits only for
//   the previous slice's group (wgmma.wait_group 1) before it releases
//   that slice's slot.
// * The corpus staged by TMA, no copy of it made. Producer 0 issues each
//   128-row x 64-feature slice into a ring of slots, `slots` - 1 slices
//   ahead of the consumers, on an mbarrier. Rows 16-byte aligned (a bf16
//   corpus with d % 8 == 0, an f32 one with d % 4 == 0) land in one box;
//   the 600-byte rows of a bf16 corpus at d = 300 (d % 8 == 4), whose odd
//   rows start 8 bytes off 16, as two: the even rows swizzled into slot
//   rows 0-63, the odd rows unswizzled 144 bytes a row from the 16-byte
//   aligned column d - 4 over the slot's second half, which the producers
//   move 8 bytes into place; the filter maps slot rows back to corpus
//   rows (2c and 2c - 127), so ties keep row order. An f32 corpus is
//   turned into its bf16 parts in place (hi in the first 16 KB, lo in the
//   second), by cvt.rn.bf16x2. Other rows (odd d, d % 4 == 2, a base
//   off 16 bytes) are copied by 4-byte cp.async pieces or 2-byte loads
//   (8-byte pieces measured slower than 4-byte ones before TMA took the
//   main path over). The producers also sum |x|^2 from
//   the landed slice (not for cosine, which needs none), a tile's at a
//   time, double-buffered, for the consumers' epilogue.
// * A filter and a merge that scale with k. At a tile's end each
//   consumer turns its accumulators into distances in place and writes
//   those that beat its row's kth best into the block's distance tile and
//   its warpgroup's copy of the row's candidate bits (the row's four
//   lanes joined by shuffles, no atomics). The producers merge, a row a
//   lane: a lone candidate (most rows that have any, once the best sets
//   have filled) is put in place by its row's lane (binary search, then
//   a shift with no data-dependent exit); a row with more goes through
//   the warp's rank merge: the 32 lanes compact the candidates (column
//   order), rank each against the others (branch-free, four at a 16-byte
//   load) and against the sorted best set (binary search), rank each
//   best entry against the candidates, and write every entry whose rank
//   is below k to its place. The order is strict-less, ties to the
//   carried set and then to the lower row. Best sets are row-major at an
//   odd pitch (k | 1), so both a lane a row and a warp a row meet no bank
//   conflicts.
//
// The plan (query tile, slots, resident parts, splits) is the host's
// (ops/cuda_topk.kernel_plan); make_layout_b (distance_tile.cuh) is its
// shared-memory arithmetic (227 KB a block). It takes the 128-query tile
// where its resident parts leave room for two slots (measured faster
// than 64 queries with three to eight), else 64 queries with resident
// parts, else the RS path (queries split a slice at a time in
// registers, one slice in flight), which lost to resident parts at any
// slot count; then as many slots as fit. At d = 300 and k = 10:
// "default" runs 128 queries with three slots over a bf16 corpus and two
// over an f32 one; "high" (160 KB of parts at 128 queries) and a bf16
// corpus at "highest" (240 KB) run 64; a 256-query tile never fits (its
// distance tile alone is 128 KB beside 160 KB of parts at "default").
// Where the producers only stage and sum (a bf16 corpus, 128-query
// tiles) they give registers to the consumers (setmaxnreg 120 / 192).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/time_kernel_a.py,
// PERF.md §6): at Q = 16384 over 1M x 300, k = 10, 12-29% of the
// bound on the five routes ("default" over a bf16 corpus 53 ms, 19%);
// what remains is the epilogue (filter and merge: 17 ms of 53 at
// "default" by ablation), the staging and the MMAs.
#include <cstdint>

#include <cuda_bf16.h>

#include "distance_tile.cuh"

namespace vers {
namespace dtk {

namespace {

constexpr int NSMAX = 8;           // most slots in the ring
constexpr int PART = CT * 128;     // bytes of a bf16 part of a slice
constexpr int UNITS_B = CT * 8 / PRODUCERS;  // 16-byte units a producer a slice

template <int ROUTE>
struct B16Traits {
  static constexpr bool XB16 =
      ROUTE == HIGHEST_B16 || ROUTE == HIGH_B16 || ROUTE == DEFAULT_B16;
  static constexpr int AP = route_query_parts(ROUTE);
  static constexpr int BP = ROUTE == HIGH_F32 ? 2 : 1;  // corpus parts
  // an f32 corpus lands as f32 (32 KB) and is converted in place
  static constexpr int SLOT = XB16 ? PART : 2 * PART;
};

__device__ inline float bf16_value(uint32_t b) {
  return __uint_as_float(b << 16);
}

// bf16 bits of v rounded to nearest even, as torch and XLA round f32 to
// bf16 (finite v).
__device__ inline uint32_t bf16_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

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

// An arrive on bar once this thread's cp.async copies so far have
// landed (the barrier counts it among its expected arrivals).
__device__ inline void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Where TMA cannot land the corpus (corpus_maps: odd d, d % 4 == 2, a
// base off 16 bytes, one row), each producer copies its units. A bf16
// corpus: features k0 .. k0 + 63 of corpus rows [g0, g0 + CT) into the
// part at dst (unit u = 16 bytes: row u / 8, features k0 + 8 ((u % 8) ^
// (row % 8)) ..), rows >= r_end and features >= d as zeros, by four
// 4-byte cp.async a unit (gran 4: d even) or by 2-byte loads and a store
// (gran 2).
__device__ inline void copy_units_b16(unsigned char* dst,
                                      const uint16_t* __restrict__ x,
                                      long long g0, long long r_end, int d,
                                      int k0, int p, int gran) {
#pragma unroll
  for (int i = 0; i < UNITS_B; ++i) {
    const int u = i * PRODUCERS + p, r = u / 8;
    const int c = k0 + ((u % 8) ^ (r % 8)) * 8;  // the unit's first feature
    const bool row = g0 + r < r_end;
    const uint16_t* src = x + (g0 + r) * d + c;
    unsigned char* out = dst + u * 16;
    if (gran == 2) {
      uint32_t w[4];
      for (int e = 0; e < 4; ++e) {
        const uint32_t a = row && c + 2 * e < d ? __ldg(src + 2 * e) : 0u;
        const uint32_t b =
            row && c + 2 * e + 1 < d ? __ldg(src + 2 * e + 1) : 0u;
        w[e] = a | (b << 16);
      }
      *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int e = 0; e < 4; ++e) {
        const bool ok = row && c + 2 * e < d;
        cp_async4(reinterpret_cast<float*>(out + 4 * e),
                  reinterpret_cast<const float*>(ok ? src + 2 * e : x), ok);
      }
    }
  }
}

// An f32 corpus: the same units' 8 f32 features each (32 bytes at dst +
// 32 u), by eight 4-byte cp.async.
__device__ inline void copy_units_f32(unsigned char* dst,
                                      const float* __restrict__ x,
                                      long long g0, long long r_end, int d,
                                      int k0, int p) {
#pragma unroll
  for (int i = 0; i < UNITS_B; ++i) {
    const int u = i * PRODUCERS + p, r = u / 8;
    const int c = k0 + ((u % 8) ^ (r % 8)) * 8;
    const bool row = g0 + r < r_end;
    const float* src = x + (g0 + r) * d + c;
    float* out = reinterpret_cast<float*>(dst + u * 32);
    for (int e = 0; e < 8; ++e) {
      const bool ok = row && c + e < d;
      cp_async4(out + e, ok ? src + e : x, ok);
    }
  }
}

// The squares of the 8 bf16 values of unit u of a landed part, widened
// to f32, added to xacc.
__device__ inline void square_unit_b16(const unsigned char* part, int u,
                                       float& xacc) {
  const uint4 v = *reinterpret_cast<const uint4*>(part + u * 16);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float a = __uint_as_float(w[e] << 16);
    const float b = __uint_as_float(w[e] & 0xFFFF0000u);
    xacc = fmaf(a, a, xacc);
    xacc = fmaf(b, b, xacc);
  }
}

// An f32 slot's units in place: all producers read their units' f32
// values (from 256-byte rows as TMA lands them where `rows`, else 32
// bytes a unit at 32 u as copy_units_f32 lands them), meet at named
// barrier 1, then write the BP bf16 parts (part 0 over the slot's first
// 16 KB, part 1 over the second) and add the squares of the f32 values to
// xacc.
template <int BP>
__device__ inline void convert_slot_f32(unsigned char* slot, int p,
                                        float (&xacc)[UNITS_B], bool squares,
                                        bool rows) {
  float4 v[UNITS_B][2];
#pragma unroll
  for (int i = 0; i < UNITS_B; ++i) {
    const int u = i * PRODUCERS + p, r = u / 8;
    const float4* src = reinterpret_cast<const float4*>(
        slot + (rows ? r * 256 + ((u % 8) ^ (r % 8)) * 32 : u * 32));
    v[i][0] = src[0];
    v[i][1] = src[1];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
#pragma unroll
  for (int i = 0; i < UNITS_B; ++i) {
    const float f[8] = {v[i][0].x, v[i][0].y, v[i][0].z, v[i][0].w,
                        v[i][1].x, v[i][1].y, v[i][1].z, v[i][1].w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // a pair a cvt.rn.bf16x2 (as split_bf16)
      const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      h[e] = *reinterpret_cast<const uint32_t*>(&hi);
      if (BP > 1) {
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(f[2 * e] - __low2float(hi),
                                  f[2 * e + 1] - __high2float(hi));
        l[e] = *reinterpret_cast<const uint32_t*>(&lo);
      }
      if (squares) {
        xacc[i] = fmaf(f[2 * e], f[2 * e], xacc[i]);
        xacc[i] = fmaf(f[2 * e + 1], f[2 * e + 1], xacc[i]);
      }
    }
    const int u = i * PRODUCERS + p;
    *reinterpret_cast<uint4*>(slot + u * 16) = make_uint4(h[0], h[1], h[2], h[3]);
    if (BP > 1)
      *reinterpret_cast<uint4*>(slot + PART + u * 16) =
          make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The RS path's query fragments: features c and c + 1 of query row r
// (c even), read through L1.
__device__ inline float2 query_pair(const float* __restrict__ qt, int r,
                                    int c, int nq, int d) {
  const bool ok = r < nq;
  const float* pq = qt + (size_t)r * d + c;
  return make_float2(ok && c < d ? __ldg(pq) : 0.f,
                     ok && c + 1 < d ? __ldg(pq + 1) : 0.f);
}

// acc = (scale ? acc : 0) + A (registers) x B (descriptor)^T,
// m64n64k16 bf16 -> f32, B K-major.
__device__ inline void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
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

// acc = (scale ? acc : 0) + A (descriptor) x B (descriptor)^T,
// m64n64k16 bf16 -> f32, both K-major in the 128-byte swizzle.
__device__ inline void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale)
      : "memory");
}

// ... m64n128k16.
__device__ inline void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
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

template <int N>
__device__ inline void pin_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Merge the candidates of the tile that starts at corpus row row0 into
// the best sets of the query rows pw, pw + 4, ... (producer warp pw of
// 4, a row a lane). A row's candidates are the set bits of its four mask
// words (the OR of the two copies), bit c for the tile's row c, their
// distances in its row of the distance tile. A lone candidate (most rows
// that have any, once the best sets have filled) is inserted by the
// row's lane; rows with more go through the warp's rank merge (the
// header note), one at a time.
__device__ inline void merge_tile(int pw, int lane, const unsigned* mask,
                                  float* dist, float* bd, int* bi, float* kth,
                                  int k, int qt, int nq, long long row0) {
  const unsigned FULL = 0xffffffffu;
  const unsigned lt = (1u << lane) - 1u;  // lanes below this one
  const int kp = k | 1;  // a row's best set, an odd pitch apart
  const int own = pw + 4 * lane;
  uint4 m = make_uint4(0u, 0u, 0u, 0u);
  if (own < nq) {  // the two consumer warpgroups' copies
    const uint4 a = *reinterpret_cast<const uint4*>(mask + own * MASKW);
    const uint4 b =
        *reinterpret_cast<const uint4*>(mask + (qt + own) * MASKW);
    m = make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  }
  // a row with one candidate: its lane inserts it after the entries at or
  // below it (ties go to the carried set), all such rows at once
  const int n_own = __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
  if (n_own == 1) {
    const int c = m.x ? __ffs(m.x) - 1
                  : m.y ? 31 + __ffs(m.y)
                  : m.z ? 63 + __ffs(m.z)
                        : 95 + __ffs(m.w);
    const float v = dist[own * CT + c];
    int lo = 0, hi = k - 1;  // its place: the first entry above it
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (bd[own * kp + mid] <= v)
        lo = mid + 1;
      else
        hi = mid;
    }
#pragma unroll 4
    for (int t = k - 1; t > lo; --t) {
      bd[own * kp + t] = bd[own * kp + t - 1];
      bi[own * kp + t] = bi[own * kp + t - 1];
    }
    bd[own * kp + lo] = v;
    bi[own * kp + lo] = (int)(row0 + c);
    kth[own] = bd[own * kp + k - 1];
  }
  // the rows with more, one at a time by the whole warp
  unsigned act = __ballot_sync(FULL, n_own > 1);
  while (act) {
    const int src = __ffs(act) - 1;
    act &= act - 1;
    const int r = pw + 4 * src;
    const unsigned w[4] = {__shfl_sync(FULL, m.x, src),
                           __shfl_sync(FULL, m.y, src),
                           __shfl_sync(FULL, m.z, src),
                           __shfl_sync(FULL, m.w, src)};
    float* drow = dist + r * CT;
    // this lane's candidates: columns 32 i + lane, their ranks in column
    // order (ci, -1 where none)
    float cv[4];
    int ci[4], n = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool on = (w[i] >> lane) & 1u;
      ci[i] = on ? n + __popc(w[i] & lt) : -1;
      cv[i] = on ? drow[32 * i + lane] : 0.f;
      n += __popc(w[i]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i)  // compacted in place, column order
      if (ci[i] >= 0) drow[ci[i]] = cv[i];
    __syncwarp();
    // this lane's best entries t = lane + 32 i, and each candidate's
    // place among the best: the entries at or below it (binary search)
    float bv[4];
    int bid[4], bpos[4], cpos[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = lane + 32 * i;
      bv[i] = t < k ? bd[r * kp + t] : CUDART_INF_F;
      bid[i] = t < k ? bi[r * kp + t] : -1;
      bpos[i] = t;
      cpos[i] = 0;
      if (ci[i] >= 0) {
        int lo = 0, hi = k;  // first entry above cv
        while (lo < hi) {
          const int mid = (lo + hi) / 2;
          if (bd[r * kp + mid] <= cv[i])
            lo = mid + 1;
          else
            hi = mid;
        }
        cpos[i] = lo;
      }
    }
    const int bw = (k + 31) / 32;  // best entries a lane, at most
    for (int j0 = 0; j0 < n; j0 += 4) {  // four candidates a 16-byte load
      const float4 v4 = *reinterpret_cast<const float4*>(drow + j0);
      const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;
        const float v = j < n ? vs[q] : CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // (bitwise, so that no lane branches)
          cpos[i] += (ci[i] >= 0) & ((v < cv[i]) | ((v == cv[i]) & (j < ci[i])));
          if (i < bw) bpos[i] += v < bv[i];
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (lane + 32 * i < k && bpos[i] < k) {
        bd[r * kp + bpos[i]] = bv[i];
        bi[r * kp + bpos[i]] = bid[i];
      }
      if (ci[i] >= 0 && cpos[i] < k) {
        bd[r * kp + cpos[i]] = cv[i];
        bi[r * kp + cpos[i]] = (int)(row0 + 32 * i + lane);
      }
    }
    __syncwarp();
    if (lane == 0) kth[r] = bd[r * kp + k - 1];
  }
}

// A tile's epilogue for one consumer thread (query rows r0, r0 + 8; slot
// columns ccol0 + 8 jj + 2 t4 + e): the distances from the accumulators,
// and those below the row's kth best into the distance tile and the
// warpgroup's copy of the row's mask words (the row's four lanes t4
// joined by shuffles). PAIR: the slot holds the tile's even rows in
// columns 0-63 and its odd rows in 64-127 (the TMA pairs of a bf16
// corpus whose rows are 8-byte aligned), so column c is the tile's row
// 2c or 2c - 127.
template <bool PAIR, int NW>
__device__ inline void filter_tile(float (&acc)[NW / 2], int r0, int t4,
                                   int ccol0, int copy, int nq, int nx,
                                   const float* qq, const float* kth,
                                   const float* xx, float* dist,
                                   unsigned* mask, int qt, int cosine) {
  const float q0 = r0 < nq ? qq[r0] : 0.f, q1 = r0 + 8 < nq ? qq[r0 + 8] : 0.f;
#pragma unroll
  for (int jj = 0; jj < NW / 8; ++jj)  // the distances, in place
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xc = cosine ? 0.f : xx[ccol0 + 8 * jj + 2 * t4 + e];
      acc[4 * jj + e] = distance(acc[4 * jj + e], q0, xc, cosine);
      acc[4 * jj + 2 + e] = distance(acc[4 * jj + 2 + e], q1, xc, cosine);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const bool row = r < nq;
    const float kr = row ? kth[r] : 0.f;
    float* drow = dist + r * CT;  // (stores at immediate offsets)
    unsigned bits[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int jj = 0; jj < NW / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = ccol0 + 8 * jj + 2 * t4 + e;
        const int lr = PAIR ? (c < 64 ? 2 * c : 2 * c - 127) : c;
        // the row's mask word, known here: PAIR puts rows 32 w .. of the
        // tile at jj = 2 w, 2 w + 1 (and 8 more where NW = 128); else
        // word jj / 4 of the warpgroup's columns
        const int w = PAIR ? (jj % 8) / 2 : jj / 4;
        const float v = acc[4 * jj + 2 * h + e];
        if (row && lr < nx && v < kr) {
          drow[lr] = v;
          bits[w] |= 1u << (lr % 32);
        }
      }
    unsigned b[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {  // a row's lanes t4 = 0..3
      b[w] = bits[w];
      b[w] |= __shfl_xor_sync(0xffffffffu, b[w], 1);
      b[w] |= __shfl_xor_sync(0xffffffffu, b[w], 2);
    }
    // the 64 columns of a warpgroup of a 64-query tile are words 2 copy,
    // 2 copy + 1 of the row (unless PAIR)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (row && t4 == 0)
        mask[(copy * qt + r) * MASKW + w] =
            PAIR || NW == 128 ? b[w] : (w / 2 == copy ? b[w % 2] : 0u);
  }
}

// QTT: queries a block (128: warpgroup w multiplies query rows 64 w ..
// against the slice's 128 rows; 64: both multiply the 64 queries, against
// slice rows 64 w ..). RES: query parts resident in shared memory (SS
// MMAs); else the RS path (QTT = 64).
template <int ROUTE, int QTT, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
distance_b16_kernel(const __grid_constant__ CUtensorMap map0,
                    const __grid_constant__ CUtensorMap map1,
                    const float* __restrict__ q, const void* __restrict__ xv,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    int ld_out, int Q, int d, int n_valid, int split_rows,
                    int k, int cosine, int stage, int gran, int ns) {
  using R = B16Traits<ROUTE>;
  static_assert(QTT == 64 || (QTT == 128 && RES), "plan");
  constexpr int NW = QTT == 128 ? 128 : 64;  // MMA N: slice rows a warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const LayoutB L = make_layout_b(ROUTE, d, k, QTT, ns, RES);
  unsigned char* ring = smem + L.ring;
  unsigned char* abuf = smem + L.a;
  float* dist = reinterpret_cast<float*>(smem + L.dist);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + L.mask);
  float* qq = reinterpret_cast<float*>(smem + L.qq);
  float* kth = reinterpret_cast<float*>(smem + L.kth);
  float* xxs = reinterpret_cast<float*>(smem + L.xx);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // landed
  uint64_t* ready = full + ns;   // converted (an f32 corpus)
  uint64_t* empty = ready + ns;  // consumed, for a refill
  uint64_t* xready = empty + ns;  // a tile's |x|^2, 2 buffers
  uint64_t* filtered = xready + 2;  // a tile's candidates, for the merge
  uint64_t* merged = filtered + 1;  // ... merged: kth, dist, mask free
  float* bd = reinterpret_cast<float*>(smem + L.bd);  // row r at r * kp
  int* bi = reinterpret_cast<int*>(smem + L.bi);
  const int kp = k | 1;

  const int q0 = blockIdx.x * QTT;
  const int nq = min(QTT, Q - q0);
  const float* qt = q + (size_t)q0 * d;
  const long long r_begin = (long long)blockIdx.y * split_rows;
  const long long r_end = min(r_begin + split_rows, (long long)n_valid);
  const int ntile = r_end > r_begin ? (int)((r_end - r_begin + CT - 1) / CT) : 0;
  const int nk = (d + 63) / 64;  // slices a tile
  const int nsteps = ntile * nk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int i = 0; i < ns; ++i) {
      mbar_init(&full[i], stage ? 1 : PRODUCERS);  // TMA: one expect_tx
      mbar_init(&ready[i], PRODUCERS);
      mbar_init(&empty[i], THREADS / 32);  // every warp done with it
    }
    mbar_init(&xready[0], PRODUCERS);
    mbar_init(&xready[1], PRODUCERS);
    mbar_init(filtered, CONSUMERS);
    mbar_init(merged, PRODUCERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (RES) {  // the queries' AP bf16 parts, as wgmma's A operand
    for (int e = tid; e < QTT * nk * 8; e += THREADS) {
      const int r = e / (nk * 8), j = e % (nk * 8) / 8, ch = e % 8;
      const int c0 = j * 64 + ch * 8;
      uint32_t w[R::AP][4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int c = c0 + 2 * f;
        const float a = r < nq && c < d ? qt[(size_t)r * d + c] : 0.f;
        const float b = r < nq && c + 1 < d ? qt[(size_t)r * d + c + 1] : 0.f;
        uint32_t pa[R::AP], pb[R::AP];
        split_bf16<R::AP>(a, pa);
        split_bf16<R::AP>(b, pb);
#pragma unroll
        for (int i = 0; i < R::AP; ++i) w[i][f] = pa[i] | (pb[i] << 16);
      }
#pragma unroll
      for (int i = 0; i < R::AP; ++i)
        *reinterpret_cast<uint4*>(abuf + ((size_t)(i * nk + j) * QTT + r) * 128 +
                                  ((ch ^ (r % 8)) * 16)) =
            make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]);
    }
  }
  for (int r = warp; r < QTT; r += THREADS / 32) {
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
  for (int e = tid; e < kp * QTT; e += THREADS) {
    bd[e] = CUDART_INF_F;
    bi[e] = -1;
  }
  for (int e = tid; e < 2 * QTT * MASKW; e += THREADS) mask[e] = 0u;
  __syncthreads();

  if (tid >= CONSUMERS) {
    // Producers. Iteration s stages slice s into slot s % ns once every
    // warp is done with the slot's slice s - ns (empty): by TMA (`stage`
    // 1: rows in order; 2: a bf16 corpus whose rows are only 8-byte
    // aligned, as even and odd rows, each a 16-byte aligned 2d-wide
    // matrix, into slot rows 0-63 and 64-127), issued by producer 0 and
    // landing on full[slot]; else by every producer's cp.async copies,
    // which arrive on full[slot] as they land. Before that the iteration
    // takes slice u = s - ns + 1, the oldest in flight, once landed: its
    // |x|^2 (kept per tile in xx, double-buffered, for the consumers'
    // epilogue: xready), and an f32 corpus's conversion in place (then
    // ready). Tile t's candidates are merged once slice (t + 1) nk has
    // landed, when the consumers have filtered them and before they need
    // the merged best sets, at tile t + 1's end. Where the producers only
    // stage and sum (a bf16 corpus, 128-query tiles) they give registers
    // to the consumers: 128 x 48 given, 256 x 24 taken (the kernel starts
    // at the launch bound's 168; measured against 104 / 200 and none,
    // PERF.md §6).
    if constexpr (R::XB16 && QTT == 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 120;\n" ::: "memory");
    const int p = tid - CONSUMERS, pw = p / 32;
    const bool squares = !cosine;
    const int lag = ns - 1;
    auto merge = [&](int t) {
      mbar_wait(filtered, (uint32_t)t & 1u);
      merge_tile(pw, lane, mask, dist, bd, bi, kth, k, QTT, nq,
                 r_begin + (long long)t * CT);
      mbar_arrive(merged);
    };
    float xacc[UNITS_B] = {};
    for (int s = 0; s < nsteps + lag; ++s) {
      const int u = s - lag;
      if (u >= 0) {
        const int slot = u % ns, t = u / nk;
        unsigned char* sp = ring + (size_t)slot * L.slot;
        mbar_wait(&full[slot], (uint32_t)(u / ns) & 1u);
        if constexpr (R::XB16) {
          if (stage == 2) {
            // the odd rows (slot rows 64..127, units i >= 4 of this
            // thread) from their 144-byte rows, landed over the slot's
            // second half from byte 8192, 8 bytes in, into place: every
            // producer reads its units, then all write (named barrier 1);
            // then the generic-proxy writes before wgmma's reads
            uint4 v[UNITS_B / 2];
#pragma unroll
            for (int i = UNITS_B / 2; i < UNITS_B; ++i) {
              const int u = i * PRODUCERS + p, r = u / 8;
              const unsigned char* src =
                  sp + PART / 2 + (r - 64) * 144 + 8 + ((u % 8) ^ (r % 8)) * 16;
              const uint2 a = *reinterpret_cast<const uint2*>(src);
              const uint2 b = *reinterpret_cast<const uint2*>(src + 8);
              v[i - UNITS_B / 2] = make_uint4(a.x, a.y, b.x, b.y);
            }
            asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
#pragma unroll
            for (int i = UNITS_B / 2; i < UNITS_B; ++i)
              *reinterpret_cast<uint4*>(sp + (i * PRODUCERS + p) * 16) =
                  v[i - UNITS_B / 2];
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(&ready[slot]);
          }
          if (squares)
#pragma unroll
            for (int i = 0; i < UNITS_B; ++i)
              square_unit_b16(sp, i * PRODUCERS + p, xacc[i]);
        } else {
          convert_slot_f32<R::BP>(sp, p, xacc, squares, stage != 0);
          // the generic-proxy writes, before wgmma's async-proxy reads
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(&ready[slot]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
        if (u % nk == nk - 1) {  // the tile's |x|^2, rows 16 i + p / 8
          if (squares)
#pragma unroll
            for (int i = 0; i < UNITS_B; ++i) {
              float v = xacc[i];
              v += __shfl_xor_sync(0xffffffffu, v, 1);
              v += __shfl_xor_sync(0xffffffffu, v, 2);
              v += __shfl_xor_sync(0xffffffffu, v, 4);
              if (lane % 8 == 0) xxs[(t & 1) * CT + 16 * i + p / 8] = v;
              xacc[i] = 0.f;
            }
          mbar_arrive(&xready[t & 1]);
        }
        if (u >= nk && u % nk == 0) merge(t - 1);
      }
      if (s < nsteps && (stage == 0 || p == 0)) {
        const int slot = s % ns, t = s / nk, k0 = (s - t * nk) * 64;
        if (s >= ns) mbar_wait(&empty[slot], (uint32_t)(s / ns - 1) & 1u);
        const long long g0 = r_begin + (long long)t * CT;
        unsigned char* dst = ring + (size_t)slot * L.slot;
        if (stage == 1) {
          mbar_expect(&full[slot], R::SLOT);
          tma_2d(dst, &map0, k0, (int)g0, &full[slot]);
        } else if (stage == 2) {  // even rows in place, odd rows staged
          mbar_expect(&full[slot], PART / 2 + 64 * 144);
          tma_2d(dst, &map0, k0, (int)(g0 / 2), &full[slot]);
          tma_2d(dst + PART / 2, &map1, d + k0 - 4, (int)(g0 / 2),
                 &full[slot]);
        } else {
          if constexpr (R::XB16)
            copy_units_b16(dst, static_cast<const uint16_t*>(xv), g0, r_end,
                           d, k0, p, gran);
          else
            copy_units_f32(dst, static_cast<const float*>(xv), g0, r_end, d,
                           k0, p);
          if (gran == 2)  // plain loads and stores
            mbar_arrive(&full[slot]);
          else
            cp_async_arrive(&full[slot]);
        }
      }
    }
    if (nsteps > 0) merge(ntile - 1);
  } else {
    if constexpr (R::XB16 && QTT == 128)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 192;\n" ::: "memory");
    // Consumers: per slice, the MMAs into the tile's accumulators (one
    // group, the previous slice's waited for); at a tile's end, the
    // distances and the filter.
    const int g = lane / 4, t4 = lane % 4;
    const int wg = warp / 4;
    const int qrow0 = QTT == 128 ? 64 * wg : 0;  // the warpgroup's queries
    const int ccol0 = QTT == 128 ? 0 : 64 * wg;  // ... and slice rows
    const int qr0 = qrow0 + (warp % 4) * 16 + g;  // the thread's rows qr0, + 8
    const uint32_t a_base = smem_addr(abuf) + qrow0 * 128;
    const size_t a_part = (size_t)nk * QTT * 128;  // bytes of a query part
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    int s = 0, slot = 0;
    for (int t = 0; t < ntile; ++t) {
      pin_acc(acc);
      for (int j = 0; j < nk; ++j, ++s) {
        const int prev = slot;
        slot = s % ns;
        const uint32_t xb =
            smem_addr(ring + (size_t)slot * L.slot) + ccol0 * 128;
        // a bf16 corpus as it landed (its odd rows moved into place at
        // stage 2), an f32 one once converted
        mbar_wait(R::XB16 && stage != 2 ? &full[slot] : &ready[slot],
                  (uint32_t)(s / ns) & 1u);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if constexpr (RES) {
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {  // steps past d multiply zeros
            const int first = j > 0 || ks > 0;  // a tile starts at 0
            const uint32_t aa = a_base + (uint32_t)(j * QTT * 128 + ks * 32);
            const uint64_t dh = sw128_desc(xb + ks * 32);
            if constexpr (R::BP == 2) {  // lo*hi + hi*lo + hi*hi
              wgmma_ss(acc, sw128_desc(aa + (uint32_t)a_part), dh, first);
              wgmma_ss(acc, sw128_desc(aa), sw128_desc(xb + PART + ks * 32), 1);
              wgmma_ss(acc, sw128_desc(aa), dh, 1);
            } else {  // the smallest query part first
#pragma unroll
              for (int pa = R::AP - 1; pa >= 0; --pa)
                wgmma_ss(acc, sw128_desc(aa + (uint32_t)(pa * a_part)), dh,
                         pa == R::AP - 1 ? first : 1);
            }
          }
          wgmma_commit();
          if (j > 0) {  // the previous slice's products are done
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(&empty[prev]);
          }
        } else {
          // a[ks][part]: the A fragment of MMA step ks, query part `part`
          uint32_t a[4][R::AP][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const int c = j * 64 + ks * 16 + 2 * t4;  // zeros past d
            const float2 v[4] = {query_pair(qt, qr0, c, nq, d),
                                 query_pair(qt, qr0 + 8, c, nq, d),
                                 query_pair(qt, qr0, c + 8, nq, d),
                                 query_pair(qt, qr0 + 8, c + 8, nq, d)};
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
          pin_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint64_t dh = sw128_desc(xb + ks * 32);
            const int first = j > 0 || ks > 0;
            if constexpr (R::BP == 2) {
              wgmma_rs_n64(acc, a[ks][1], dh, first);
              wgmma_rs_n64(acc, a[ks][0], sw128_desc(xb + PART + ks * 32), 1);
              wgmma_rs_n64(acc, a[ks][0], dh, 1);
            } else {
#pragma unroll
              for (int pa = R::AP - 1; pa >= 0; --pa)
                wgmma_rs_n64(acc, a[ks][pa], dh, pa == R::AP - 1 ? first : 1);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();  // the fragments' registers are reused
          if (j < nk - 1 && lane == 0) mbar_arrive(&empty[slot]);
        }
      }
      wgmma_wait<0>();
      pin_acc(acc);
      if (lane == 0) mbar_arrive(&empty[slot]);
      // the tile is done: distances and filter (the last tile's merge
      // has freed kth, dist and mask)
      if (t > 0) mbar_wait(merged, (uint32_t)(t - 1) & 1u);
      mbar_wait(&xready[t & 1], (uint32_t)(t >> 1) & 1u);
      const long long g0 = r_begin + (long long)t * CT;
      const int nx = (int)min((long long)CT, r_end - g0);
      const float* xx = xxs + (t & 1) * CT;
      const int copy = QTT == 128 ? 0 : wg;
      if (stage == 2)
        filter_tile<true, NW>(acc, qr0, t4, ccol0, copy, nq, nx, qq, kth, xx,
                              dist, mask, QTT, cosine);
      else
        filter_tile<false, NW>(acc, qr0, t4, ccol0, copy, nq, nx, qq, kth, xx,
                               dist, mask, QTT, cosine);
      mbar_arrive(filtered);
    }
    // this split's best set, ascending, id -1 wherever the distance is
    // inf, once the last tile is merged
    if (ntile > 0) mbar_wait(merged, (uint32_t)(ntile - 1) & 1u);
    for (int e = tid; e < nq * k; e += CONSUMERS) {
      const int r = e / k, t = e % k;
      const float v = bd[r * kp + t];
      const size_t o = (size_t)(q0 + r) * ld_out + (size_t)blockIdx.y * k + t;
      out_d[o] = v;
      out_i[o] = v == CUDART_INF_F ? -1 : bi[r * kp + t];
    }
  }
}

using KernelB16 = void (*)(CUtensorMap, CUtensorMap, const float*,
                           const void*, float*, int*, int, int, int, int, int,
                           int, int, int, int, int);

template <int ROUTE>
KernelB16 kernel_for(int qt, int resident) {
  if (qt == 128) return resident ? distance_b16_kernel<ROUTE, 128, true> : nullptr;
  return resident ? distance_b16_kernel<ROUTE, 64, true>
                  : distance_b16_kernel<ROUTE, 64, false>;
}

KernelB16 b16_kernel(int route, int qt, int resident) {
  if (qt != 64 && qt != 128) return nullptr;
  switch (route) {
    case HIGHEST_B16: return kernel_for<HIGHEST_B16>(qt, resident);
    case HIGH_B16: return kernel_for<HIGH_B16>(qt, resident);
    case DEFAULT_B16: return kernel_for<DEFAULT_B16>(qt, resident);
    case HIGH_F32: return kernel_for<HIGH_F32>(qt, resident);
    case DEFAULT_F32: return kernel_for<DEFAULT_F32>(qt, resident);
  }
  return nullptr;
}

}  // namespace

// How a route stages its corpus (the kernel's `stage`) and, for TMA, its
// maps: 1 where rows are 16-byte aligned (a bf16 corpus with d % 8 == 0,
// an f32 one with d % 4 == 0; boxes of 128 rows x 64 features, 128-byte
// swizzle for bf16, none for f32); 2 for a bf16 corpus with d % 8 == 4,
// whose odd rows start 8 bytes off 16 (600-byte rows at d = 300): the
// even rows as an (ceil(n/2), d) matrix 4d bytes a row, 64 x 64 boxes
// swizzled into slot rows 0-63; the odd rows as the columns d .. 2d - 1
// of an (n / 2, 2d) one, in unswizzled 64 x 72 boxes from the 16-byte
// aligned column d - 4 + k0, which the producers move into slot rows
// 64-127; else 0 (cp.async).
int corpus_maps(int route, const void* x, int n_rows, int d, CUtensorMap* m0,
                CUtensorMap* m1, int* stage) {
  const bool b16 = route == HIGHEST_B16 || route == HIGH_B16 ||
                   route == DEFAULT_B16;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  *stage = 0;
  if (xa % 16 || n_rows < 1) return 0;
  if (b16 && d % 8 == 0) {
    *stage = 1;
    return (int)encode_2d(m0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, n_rows,
                          d, CT, 64);
  }
  if (b16 && d % 4 == 0 && n_rows >= 2) {
    *stage = 2;
    cudaError_t e = encode_2d(m0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                              (n_rows + 1) / 2, d, CT / 2, 64, 2LL * d);
    if (e != cudaSuccess) return (int)e;
    return (int)encode_2d(m1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                          n_rows / 2, 2LL * d, CT / 2, 72, 0, false);
  }
  if (!b16 && d % 4 == 0) {
    *stage = 1;
    return (int)encode_2d(m0, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, n_rows, d,
                          CT, 64, 0, false);
  }
  return 0;
}

int launch_b16(int route, const float* q, const void* x, float* out_d,
               int* out_i, int Q, int n_rows, int d, int n_valid, int k,
               int cosine, int n_split, int split_rows, int gran, int qt,
               int ns, int resident, int max_smem, cudaStream_t stream) {
  const KernelB16 kernel = b16_kernel(route, qt, resident);
  if (!kernel || ns < 2 || ns > NSMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout_b(route, d, k, qt, ns, resident).bytes;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  CUtensorMap m0 = {}, m1 = {};
  int stage = 0;
  int e = corpus_maps(route, x, n_rows, d, &m0, &m1, &stage);
  if (e != 0) return e;
  e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != 0) return e;
  const dim3 grid((Q + qt - 1) / qt, n_split);
  kernel<<<grid, THREADS, smem, stream>>>(m0, m1, q, x, out_d, out_i,
                                          n_split * k, Q, d, n_valid,
                                          split_rows, k, cosine, stage, gran,
                                          ns);
  return (int)cudaGetLastError();
}

int occupancy_b16(int route, int d, int k, int qt, int ns, int resident,
                  int* blocks) {
  const KernelB16 kernel = b16_kernel(route, qt, resident);
  if (!kernel) return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout_b(route, d, k, qt, ns, resident).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            THREADS, smem);
}

}  // namespace dtk
}  // namespace vers
