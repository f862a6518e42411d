// Hopper tensor-core helpers shared by the pair pool forward (sa_pair_pool.cu),
// its backward (sa_pair_pool_bwd.cu), the prep forward and backward
// (sa_prep.cu, sa_prep_bwd.cu) and the f32 prep (sa_prep_f32.cu):
// shared-memory addresses, bulk copies (TMA, 1D) counted by mbarriers, bf16x2
// arithmetic, wgmma descriptors, fences and products (bf16, and TF32 split
// in two for true-f32 products), the column sums of an accumulator, the
// fixed-order sum of per-CTA records, the wide pools' cp.async copies of a
// weight block into the core layout, and cluster ranks, peer addresses and
// the cluster barrier.
//
// Shared-memory operands use the no-swizzle ("interleave") core-matrix layout:
// a (rows x cols) bf16 matrix is stored as 8x8 cores of 128 bytes, core
// (r/8, c/8) at ((r/8) * (cols/8) + c/8) * 64 elements, element (r%8)*8 + c%8
// inside it. The same bytes serve a wgmma operand two ways:
//   K-major  (rows = M or N, cols = K): lbo = 128, sbo = cols * 16;
//   MN-major (cols = M or N, rows = K; the transpose flag set): sbo = 128
//            between M/N core blocks, lbo = cols * 16 between K core blocks
//            (CUTLASS's canonical GMMA layouts, cute/atom/mma_traits_sm90_gmma.hpp).
// A TF32 operand has cores of 8 rows x 4 values (16 bytes a row) and is only
// K-major: core (r/8, c/4) at ((r/8) * (cols/4) + c/4) * 32 elements, element
// (r%8)*4 + c%4 inside it; lbo = 128, sbo = cols * 32; a k8 step is two cores
// along K (256 bytes).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- bulk copies (TMA, 1D) and their mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

// Expect `bytes` more on the mbarrier `bar` (its one arrival for this phase).
__device__ __forceinline__ void bulk_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the stage's reads
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16) from global to shared, counted
// by the mbarrier `bar`, which was told to expect it; issued by one thread.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// bulk_expect and bulk_load of one copy.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  bulk_expect(bar, bytes);
  bulk_load(dst, src, bytes, bar);
}

// Wait for phase `parity` of the mbarrier `bar`; a copy that never lands
// traps instead of hanging the card.
__device__ __forceinline__ void bulk_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 22)) __trap();
  }
}

// One bulk copy of `bytes` (a multiple of 16) from shared to global, in the
// issuing thread's bulk group; the writers fenced (fence_async) and synced.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// At most n of the thread's bulk stores still read shared memory.
template <int n>
__device__ __forceinline__ void bulk_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(n) : "memory");
}

// Every bulk store of the thread has completed.
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared-memory writes of this thread made visible to bulk copies and wgmma.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bf16x2 relu(a + b), the sum rounded once to bf16
__device__ __forceinline__ uint32_t add_relu_bf16x2(uint32_t a, uint32_t b) {
  uint32_t s, r;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(s) : "r"(a), "r"(b));
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(s), "r"(0u));
  return r;
}

// (lo, hi) -> bf16x2, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// wgmma descriptor of a no-swizzle operand: lbo and sbo in bytes (see above).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// Keeps the compiler from moving register reads or writes across an
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int n>
__device__ __forceinline__ void fence_regs(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int n>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Stage a row-major (K, N) bf16 matrix as its transpose, the (N, K) core
// layout above (a K-major wgmma B operand): a thread gathers the 8 k-values of
// one 16-byte core row, so the global reads coalesce and the stores do not
// conflict.
template <int THREADS>
__device__ __forceinline__ void stage_kmajor(uint16_t* dst, const uint16_t* __restrict__ src,
                                             int K, int N) {
  for (int i = threadIdx.x; i < K * N / 8; i += THREADS) {
    const int n = i % N, kb = i / N;
    const uint16_t* s = src + (size_t)(8 * kb) * N + n;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = uint32_t(s[2 * e * N]) | (uint32_t(s[(2 * e + 1) * N]) << 16);
    *reinterpret_cast<uint4*>(dst + ((size_t)(n / 8) * (K / 8) + kb) * 64 + (n % 8) * 8) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}


// ---- wgmma products and the column sums of an accumulator, shared by the
// pool backward (sa_pair_pool_bwd.cu) and the prep backward (sa_prep_bwd.cu)

#define EDA_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x N, f32) (+)= A (64 x 16) @ B (16 x N), both bf16 in shared memory;
// TA / TB: the operand is MN-major. d[4j + e] is row g (e < 2) or g + 8,
// column 8j + 2t + e % 2 (g = lane / 4, t = lane % 4, rows from 16 * warp).
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : EDA_D8(0)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : EDA_D8(0), EDA_D8(8)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : EDA_D8(0), EDA_D8(8), EDA_D8(16), EDA_D8(24)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  } else {
    static_assert(N == 128, "wgmma widths");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : EDA_D8(0), EDA_D8(8), EDA_D8(16), EDA_D8(24), EDA_D8(32), EDA_D8(40), EDA_D8(48),
          EDA_D8(56)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
  }
}
#undef EDA_D8


// ---- TF32 products of f32 values split in two (3xTF32)
//
// v = hi + lo with hi = tf32(v) and lo = tf32(v - hi), both rounded to
// nearest (cvt.rna); a product a b is taken as a_hi b_lo + a_lo b_hi +
// a_hi b_hi, f32 sums, the a_lo b_lo term dropped: within a few f32 ulps of
// a true f32 product, where one TF32 product keeps 10 mantissa bits.

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

#define EDA_T8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x N, f32) (+)= A (64 x 8, TF32 registers) @ B (8 x N, TF32 shared,
// K-major). a[0..3] are A's (row g, k t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4); d as in wgmma_ss (g = lane / 4, t = lane % 4, rows from 16 * warp).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : EDA_T8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : EDA_T8(0), EDA_T8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : EDA_T8(0), EDA_T8(8), EDA_T8(16), EDA_T8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else {
    static_assert(N == 128, "wgmma widths");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : EDA_T8(0), EDA_T8(8), EDA_T8(16), EDA_T8(24), EDA_T8(32), EDA_T8(40), EDA_T8(48),
          EDA_T8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
}
#undef EDA_T8

// D (+)= A B in 3xTF32 over one k8 step: A split in registers (ah, al), B's
// hi and lo copies at the descriptors bh, bl; the small terms first.
template <int N>
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[N / 2], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], uint64_t bh, uint64_t bl,
                                             int accumulate) {
  wgmma_tf32<N>(d, ah, bl, accumulate);
  wgmma_tf32<N>(d, al, bh, 1);
  wgmma_tf32<N>(d, ah, bh, 1);
}

// A 64-row product over a tile's 64 rows (K = 64, four k16 steps) of two
// MN-major operands: X^T (M = 64 columns of X from m0) times Y (N columns
// from n0), X and Y (64 x XC, 64 x YC) in the core layout.
template <int N>
__device__ __forceinline__ void wgmma_rows(float (&d)[N / 2], uint32_t x, int XC, int m0,
                                           uint32_t y, int YC, int n0, int accumulate) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_ss<N, 1, 1>(d, make_desc(x + (m0 / 8) * 128 + s * 32 * XC, XC * 16, 128),
                      make_desc(y + (n0 / 8) * 128 + s * 32 * YC, YC * 16, 128),
                      accumulate || s > 0);
}

// The value, opaque to the compiler: a descriptor built from it is built
// where it is used, not hoisted ahead and held in registers across phases.
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// ROWS x COLS of a row-major bf16 matrix (row stride LD) into the core layout
// at `dst` (rows of cores = ROWS / 8), 16 bytes a cp.async by each of THREADS
// threads, committed as one group: the wide pools' weight streams. A warp
// moves 8 rows of 4 cores: 64 contiguous bytes a row from global, 512
// contiguous bytes to shared. The thread index is opaque, so the offsets are
// computed here, not hoisted out of a caller's loop and held in registers.
template <int THREADS, int ROWS, int COLS, int LD>
__device__ __forceinline__ void copy_core(uint32_t dst, const uint16_t* __restrict__ src) {
  constexpr int Q = COLS / 8;  // cores a row of cores
  static_assert(ROWS * Q % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int n = 0; n < ROWS * Q / THREADS; ++n) {
    const int i = (int)opaque(threadIdx.x) + n * THREADS;
    const int kr = i & 7, q = (i >> 3) % Q, kb = (i >> 3) / Q;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     dst + ((kb * Q + q) * 64 + kr * 8) * 2),
                 "l"(src + (8 * kb + kr) * LD + 8 * q));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ---- thread block clusters (the wide pool forward, the prep backward at c1 256)

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of the same shared-memory byte in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t peer(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Every thread of the cluster's CTAs: their shared-memory writes before it,
// peers' included, are seen after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// x / c, correctly rounded, from rc = RN(1/c): q = RN(x rc) corrected once,
// RN(q + (x - q c) rc) (Markstein's theorem; no division's slow path).
__device__ __forceinline__ float div_real(float x, float c, float rc) {
  const float q = x * rc;
  return __fmaf_rn(__fmaf_rn(-q, c, x), rc, q);
}

// x / c: a LayerNorm statistic over the c real channels of rows that a kernel
// instantiated for C channels holds zero-padded past c (the padding adds
// nothing to the sums), rc = RN(1/c). At c == C, every instantiated width
// being a power of two, the exact multiply by 1/C; otherwise div_real. Both
// are the plain versions' sum / c.
template <int C>
__device__ __forceinline__ float div_width(float x, float c, float rc) {
  return c == (float)C ? x * (1.f / C) : div_real(x, c, rc);
}

// Offset, in elements, of (r, c) in the core layout of a matrix of `cols` columns.
__device__ __forceinline__ int core_at(int r, int c, int cols) {
  return ((r >> 3) * (cols >> 3) + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

// One step of the transposing butterfly sum: lanes whose bit `m` is clear keep
// the first n/2 sums, the others the last n/2.
template <int n>
__device__ __forceinline__ void sum_step(float* v, int m, bool up) {
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const float send = up ? v[i] : v[i + n / 2];
    const float keep = up ? v[i + n / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

// Column sums over a warp's 16 rows: v[jj] (jj < NV) is the thread's two
// rows summed at its column jj (column 8 (jj / 2) + 2t + jj % 2 of the
// thread's columns); afterwards an owning lane (col_owner) adds the sum of
// column col_base(lane) + i to run[i], i < col_regs(NV).
template <int NV>
__device__ __forceinline__ void column_sums(float (&v)[NV], int lane, float* run) {
  sum_step<NV>(v, 16, lane & 16);
  if constexpr (NV >= 8) {
    sum_step<NV / 2>(v, 8, lane & 8);
    sum_step<NV / 4>(v, 4, lane & 4);
#pragma unroll
    for (int i = 0; i < NV / 8; ++i) run[i] += v[i];
  } else if constexpr (NV == 4) {
    sum_step<2>(v, 8, lane & 8);
    run[0] += v[0] + __shfl_xor_sync(0xffffffffu, v[0], 4);
  } else {
    static_assert(NV == 2, "column sums");
    const float s = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 8);
    run[0] += s + __shfl_xor_sync(0xffffffffu, s, 4);
  }
}
__host__ __device__ constexpr int col_regs(int nv) { return nv >= 8 ? nv / 8 : 1; }
template <int NV>
__device__ __forceinline__ int col_base(int lane) {
  if constexpr (NV >= 8)
    return ((lane & 16) ? NV / 2 : 0) + ((lane & 8) ? NV / 4 : 0) + ((lane & 4) ? NV / 8 : 0);
  else if constexpr (NV == 4)
    return ((lane & 16) ? 2 : 0) + ((lane & 8) ? 1 : 0);
  else
    return (lane & 16) ? 1 : 0;
}
template <int NV>
__device__ __forceinline__ bool col_owner(int lane) {
  return NV >= 8 || (NV == 4 ? !(lane & 4) : !(lane & 12));
}

// A column sum over the tile of a thread's CW columns (ds2 with PROD: dln *
// xhat; dlb2, db2 without): the thread's two rows, then the butterfly over
// the warp's rows, half of the columns at a time from 64 columns on.
template <int CW>
struct Fold {
  static constexpr int NV = CW / 4, NH = NV >= 16 ? 2 : 1, NVH = NV / NH;
  static constexpr int NRH = col_regs(NVH), NR = NH * NRH;
  // the column (of the thread's CW) of run[i]
  static __device__ __forceinline__ int column(int i, int lane, int t4) {
    const int jj = (i / NRH) * NVH + col_base<NVH>(lane) + i % NRH;
    return 8 * (jj / 2) + 2 * t4 + (jj & 1);
  }
};
template <int CW, bool PROD>
__device__ __forceinline__ void fold_columns(const float (&a)[CW / 2], const float (&x)[CW / 2],
                                             int lane, float* run) {
  using F = Fold<CW>;
#pragma unroll
  for (int h = 0; h < F::NH; ++h) {
    float v[F::NVH];
#pragma unroll
    for (int jj = 0; jj < F::NVH; ++jj) {
      const int i = 4 * ((h * F::NVH + jj) / 2) + (jj & 1);
      v[jj] = PROD ? a[i] * x[i] + a[i + 2] * x[i + 2] : a[i] + a[i + 2];
    }
    column_sums<F::NVH>(v, lane, run + h * F::NRH);
  }
}


// out[e] = sum over i < n of records[i][e], in order: 8 fixed groups of
// records summed in parallel, then the groups in order. Launch with
// (P + 31) / 32 blocks of 32 kGroups threads. (A template, so that a file
// that includes this header without launching it builds no copy.)
template <int kGroups>
__global__ void __launch_bounds__(32 * kGroups)
reduce_records(const float* __restrict__ records, int n, int P, float* __restrict__ out) {
  __shared__ float part[kGroups][32];
  const int e = blockIdx.x * 32 + threadIdx.x % 32;
  const int grp = threadIdx.x / 32;
  const int i0 = (int)((long long)n * grp / kGroups);
  const int i1 = (int)((long long)n * (grp + 1) / kGroups);
  float s = 0.f;
  if (e < P) {
#pragma unroll 8
    for (int i = i0; i < i1; ++i) s += records[(size_t)i * P + e];
  }
  part[grp][threadIdx.x % 32] = s;
  __syncthreads();
  if (grp == 0 && e < P) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) t += part[k][threadIdx.x];
    out[e] = t;
  }
}

}  // namespace wg
