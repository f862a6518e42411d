// Hopper tensor-core helpers shared by the pair pool forward (sa_pair_pool.cu)
// and backward (sa_pair_pool_bwd.cu): shared-memory addresses, bf16x2
// arithmetic, wgmma descriptors and the wgmma group fences.
//
// Shared-memory operands use the no-swizzle ("interleave") core-matrix layout:
// a (rows x cols) bf16 matrix is stored as 8x8 cores of 128 bytes, core
// (r/8, c/8) at ((r/8) * (cols/8) + c/8) * 64 elements, element (r%8)*8 + c%8
// inside it. The same bytes serve a wgmma operand two ways:
//   K-major  (rows = M or N, cols = K): lbo = 128, sbo = cols * 16;
//   MN-major (cols = M or N, rows = K; the transpose flag set): sbo = 128
//            between M/N core blocks, lbo = cols * 16 between K core blocks
//            (CUTLASS's canonical GMMA layouts, cute/atom/mma_traits_sm90_gmma.hpp).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

}  // namespace wg
