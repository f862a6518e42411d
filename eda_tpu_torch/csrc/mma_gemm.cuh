// Tiled matrix products on the tensor cores through mma.sync (HMMA), shared by
// the width-4 backbone's training kernels (sa_pair_pool_bwd_512.cu, the pool
// backward at (512, 512, 1024); sa_prep_bwd_512.cu, the prep backward at c1
// 257-512): C (M x N, f32) = A (M x K) B (K x N), over a K range a CTA, with
// either operand K-contiguous or M/N-contiguous in device memory, so that
// X = H W, dH = D W^T and dW = H^T D all run on one kernel without a
// transposed copy.
//
// Two element types:
//   bf16   mma.m16n8k16, f32 sums in the tensor cores over the CTA's K range;
//   float  true-f32 products as 3xTF32 (wgmma.cuh: a_hi b_lo + a_lo b_hi +
//          a_hi b_hi, mma.m16n8k8), each 16-deep K chunk into a fresh
//          accumulator that the CUDA cores add into the running sum (IEEE,
//          round to nearest): the tensor cores round their sums toward zero,
//          and one accumulator over a long K misses the f32 tolerances
//          (csrc/sa_prep_512.cu's note).
//
// A CTA of 8 warps computes a 128 x 128 tile of C, a warp 64 x 32 (2 x 4
// warps); K runs in chunks of 64 bytes a row (32 bf16, 16 f32), two chunks in
// shared memory, the next one's cp.async copies in flight while this one's
// products run. A K-contiguous operand's chunk is stored [128][64 B + 16 B],
// an M/N-contiguous one's [chunk K][128 + 8 values]: with those pads the
// fragment reads (ldmatrix, .trans for the M/N-contiguous bf16 operand;
// 32-bit loads for f32) meet no bank conflict. blockIdx.z takes K range z of
// the split (split-K), writing its partial product to C + z * strideC, so
// that a long K (the rows of a weight gradient) is added later in a fixed
// order (wg::reduce_records): no atomics, every sum the same on every run.
//
// Operands: 16-byte aligned bases and leading dimensions that are multiples
// of 16 bytes. A 16-byte copy is taken whole when it starts inside the
// operand (row < rows, and its first value < the contiguous extent), else
// zero-filled, so a contiguous extent that is no multiple of 8 (bf16) or 4
// (f32) values must be followed by zeros up to the next one in memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mg {

constexpr int kBM = 128, kBN = 128;  // a CTA's tile of C
constexpr int kThreads = 256;        // 8 warps: 2 along M x 4 along N
constexpr int kChunkBytes = 64;      // K bytes a chunk row

template <typename T>
struct Dims {
  static constexpr int VEC = 16 / sizeof(T);              // values a 16-byte copy
  static constexpr int BK = kChunkBytes / sizeof(T);      // K a chunk: 32 bf16, 16 f32
  static constexpr int LDK = BK + VEC;                    // a K-contiguous row, padded
  static constexpr int LDM = kBM + 8;                     // an M/N-contiguous row, padded
  // one operand's chunk, the larger of its two layouts
  static constexpr int ELEMS = kBM * LDK > BK * LDM ? kBM * LDK : BK * LDM;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

// One operand's chunk into shared memory: a (rows x K) K-contiguous block
// (KM) or a (K x rows) rows-contiguous one, rows r0 .. + 128 and K k0 .. + BK
// of a matrix with `rows` rows, K extent `kend` and leading dimension ld.
template <typename T, bool KM>
__device__ __forceinline__ void load_chunk(T* dst, const T* __restrict__ src, int ld, int r0,
                                           int rows, int k0, int kend, int tid) {
  using D = Dims<T>;
  constexpr int kCopies = kBM * D::BK / D::VEC;  // 512 16-byte copies a chunk
#pragma unroll
  for (int i = tid; i < kCopies; i += kThreads) {
    int r, k;
    if constexpr (KM) {
      r = i / (D::BK / D::VEC);
      k = (i % (D::BK / D::VEC)) * D::VEC;
    } else {
      k = i / (kBM / D::VEC);
      r = (i % (kBM / D::VEC)) * D::VEC;
    }
    const bool valid = r0 + r < rows && k0 + k < kend;
    const T* from = valid ? (KM ? src + (size_t)(r0 + r) * ld + k0 + k
                                : src + (size_t)(k0 + k) * ld + r0 + r)
                          : src;
    cp16(smem_addr(dst + (KM ? r * D::LDK + k : k * D::LDM + r)), from, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32_of(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(v);
  lo = tf32_of(v - __uint_as_float(hi));
}

// A(m, k) = AK ? A[m * lda + k] : A[k * lda + m]; B(k, n) = BK ? B[n * ldb + k]
// : B[k * ldb + n]; C[z * strideC + m * ldc + n] = sum over k of split z.
template <typename T, bool AK, bool BK>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B, int ldb,
            float* __restrict__ C, int ldc, long long strideC, int M, int N, int K, int kper) {
  using D = Dims<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  __shared__ __align__(128) T sa[2][D::ELEMS];
  __shared__ __align__(128) T sb[2][D::ELEMS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 2, wn = warp / 2;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int kb = blockIdx.z * kper, ke = min(K, kb + kper);
  const int chunks = ke > kb ? (ke - kb + D::BK - 1) / D::BK : 0;
  C += blockIdx.z * strideC;

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int s, int c) {
    const int k0 = kb + c * D::BK;
    load_chunk<T, AK>(sa[s], A, lda, m0, M, k0, ke, tid);
    load_chunk<T, BK>(sb[s], B, ldb, n0, N, k0, ke, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (chunks > 0) load(0, 0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      load((c + 1) & 1, c + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const T* As = sa[c & 1];
    const T* Bs = sb[c & 1];
    if constexpr (!kF32) {
#pragma unroll
      for (int kk = 0; kk < D::BK; kk += 16) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mb = wm * 64 + 16 * i;
          if constexpr (AK) {
            ldsm_x4(a[i], smem_addr(As + (mb + (lane & 15)) * D::LDK + kk + (lane >> 4) * 8));
          } else {
            const int q = lane >> 3, r = lane & 7;
            ldsm_x4_t(a[i], smem_addr(As + (kk + (q >> 1) * 8 + r) * D::LDM + mb + (q & 1) * 8));
          }
        }
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          const int nb = wn * 32 + 8 * j;
          const int q = lane >> 3, r = lane & 7;
          uint32_t f[4];
          if constexpr (BK)
            ldsm_x4(f, smem_addr(Bs + (nb + (q >> 1) * 8 + r) * D::LDK + kk + (q & 1) * 8));
          else
            ldsm_x4_t(f, smem_addr(Bs + (kk + (q & 1) * 8 + r) * D::LDM + nb + (q >> 1) * 8));
          b[j][0] = f[0];
          b[j][1] = f[1];
          b[j + 1][0] = f[2];
          b[j + 1][1] = f[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    } else {
      const float* Af = reinterpret_cast<const float*>(As);
      const float* Bf = reinterpret_cast<const float*>(Bs);
      float fresh[4][4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) fresh[i][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D::BK; kk += 8) {
        uint32_t ahi[4][4], alo[4][4], bhi[4][2], blo[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mb = wm * 64 + 16 * i;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = mb + g + 8 * (e & 1), k = kk + t + 4 * (e >> 1);
            split_tf32(AK ? Af[m * D::LDK + k] : Af[k * D::LDM + m], ahi[i][e], alo[i][e]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn * 32 + 8 * j + g;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = kk + t + 4 * e;
            split_tf32(BK ? Bf[n * D::LDK + k] : Bf[k * D::LDM + n], bhi[j][e], blo[j][e]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_tf32(fresh[i][j], ahi[i], blo[j][0], blo[j][1]);
            mma_tf32(fresh[i][j], alo[i], bhi[j][0], bhi[j][1]);
            mma_tf32(fresh[i][j], ahi[i], bhi[j][0], bhi[j][1]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], fresh[i][j][e]);
    }
    __syncthreads();  // the chunk is read before the copies after the next overwrite it
  }

  // fragment e of tile (i, j): row g (e < 2) or g + 8, column 2 t + e % 2
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 64 + 16 * i + g + 8 * (e >> 1);
        const int n = n0 + wn * 32 + 8 * j + 2 * t + (e & 1);
        if (m < M && n < N) C[(size_t)m * ldc + n] = acc[i][j][e];
      }
}

// C (+ z * M * ldc for split z) = A B over `splits` equal K ranges, each a
// multiple of the chunk; returns cudaGetLastError().
template <typename T, bool AK, bool BK>
cudaError_t gemm(const T* A, int lda, const T* B, int ldb, float* C, int ldc, int M, int N, int K,
                 int splits, cudaStream_t s) {
  using D = Dims<T>;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (((lda | ldb) % D::VEC) || ((reinterpret_cast<uintptr_t>(A) |
                                  reinterpret_cast<uintptr_t>(B)) & 15) || splits < 1)
    return cudaErrorInvalidValue;
  int kper = (K + splits - 1) / splits;
  kper = (kper + D::BK - 1) / D::BK * D::BK;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, splits);
  if (grid.y > 65535 || splits > 65535) return cudaErrorInvalidValue;
  gemm_kernel<T, AK, BK><<<grid, kThreads, 0, s>>>(A, lda, B, ldb, C, ldc,
                                                   (long long)M * ldc, M, N, K, kper);
  return cudaGetLastError();
}

}  // namespace mg
