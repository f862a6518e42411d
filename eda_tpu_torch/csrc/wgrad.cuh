// Weight gradients as split-row outer-product sums, shared by the backward
// kernels (sa_prep_bwd.cu, sa_pair_pool_bwd.cu):
//
//   out[k][c] = sum over valid rows r of X[r][k] * Y[r][c]        (f32 sums)
//
// X is a bf16 activation matrix (or, for the prep backward, the raw f32
// points, rounded here to bf16([xyz / r ; f]) as the forward rounds them) and
// Y a bf16 cotangent matrix. The TPU kernels keep such sums in a VMEM block
// resident across their sequential grid; on the card CTAs run in parallel, so
// each CTA sums one chunk of rows into its own partial (first pass) and
// reduce_partials adds the partials in chunk order (second pass): no atomics,
// and the result does not depend on the schedule.
//
// A row r is valid when counts is null, or when (r % cap) < counts[r / cap]:
// the pair-pool backward stores each center's live rows at the front of its
// cap-row slot range.
//
// First pass layout: CTA (chunk, k-tile of 32) with 256 threads; thread t owns
// k = 32 * tile + t / 8 and the channels c = t % 8 + 8 j. Rows stream through
// shared memory 32 at a time as f32; a sub-tile without a valid row is skipped.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace wgrad {

constexpr int kThreads = 256;
constexpr int kRows = 32;   // rows per shared-memory sub-tile
constexpr int kKTile = 32;  // X columns per CTA

__device__ __forceinline__ float bf16_bits_to_float(uint16_t u) {
  return __uint_as_float(uint32_t(u) << 16);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// PTS: X is (rows, nk) f32 points whose first 3 columns are divided by radius.
template <int J, bool PTS>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const void* __restrict__ X, const uint16_t* __restrict__ Y,
               long long n_rows, int nk, int nc, const int* __restrict__ counts,
               int cap, int rows_per_chunk, float radius, float* __restrict__ partial) {
  __shared__ float xs[kRows][kKTile + 1];
  __shared__ float ys[kRows][8 * J];
  __shared__ int any_valid;
  const int tid = threadIdx.x;
  const int kl = tid / 8, cg = tid % 8;
  const int k0 = blockIdx.y * kKTile;
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = min(n_rows, r0 + rows_per_chunk);

  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;

  for (long long rt = r0; rt < r1; rt += kRows) {
    __syncthreads();  // the previous sub-tile has been consumed
    if (tid == 0) any_valid = 0;
    __syncthreads();
    if (tid < kRows) {
      const long long r = rt + tid;
      bool ok = r < r1;
      if (ok && counts != nullptr) ok = (int)(r % cap) < counts[r / cap];
      if (ok) any_valid = 1;
    }
    __syncthreads();
    if (!any_valid) continue;  // every row of the sub-tile is past its center's count
    for (int i = tid; i < kRows * kKTile; i += kThreads) {
      const int rr = i / kKTile, kk = i % kKTile;
      const long long r = rt + rr;
      const int k = k0 + kk;
      bool ok = r < r1 && k < nk;
      if (ok && counts != nullptr) ok = (int)(r % cap) < counts[r / cap];
      float v = 0.f;
      if (ok) {
        if constexpr (PTS) {
          const float p = static_cast<const float*>(X)[r * nk + k];
          v = round_bf16(k < 3 ? p / radius : p);
        } else {
          v = bf16_bits_to_float(static_cast<const uint16_t*>(X)[r * nk + k]);
        }
      }
      xs[rr][kk] = v;
    }
    for (int i = tid; i < kRows * 8 * J; i += kThreads) {
      const int rr = i / (8 * J), c = i % (8 * J);
      const long long r = rt + rr;
      bool ok = r < r1 && c < nc;
      if (ok && counts != nullptr) ok = (int)(r % cap) < counts[r / cap];
      ys[rr][c] = ok ? bf16_bits_to_float(Y[r * nc + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kRows; ++rr) {
      const float x = xs[rr][kl];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[j] = fmaf(x, ys[rr][cg + 8 * j], acc[j]);
    }
  }
  const int k = k0 + kl;
  if (k >= nk) return;
  float* out = partial + ((size_t)blockIdx.x * nk + k) * nc;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = cg + 8 * j;
    if (c < nc) out[c] = acc[j];
  }
}

// out[e] = sum over i < n_parts of partial[i][e], in order.
__global__ void reduce_partials(const float* __restrict__ partial, int n_parts,
                                long long n_elem, float* __restrict__ out) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n_elem;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < n_parts; ++i) s += partial[(size_t)i * n_elem + e];
    out[e] = s;
  }
}

inline int n_chunks(long long n_rows, int rows_per_chunk) {
  return (int)((n_rows + rows_per_chunk - 1) / rows_per_chunk);
}

template <bool PTS>
cudaError_t launch_partial(const void* X, const uint16_t* Y, long long n_rows, int nk,
                           int nc, const int* counts, int cap, int rows_per_chunk,
                           float radius, float* partial, cudaStream_t s) {
  dim3 grid(n_chunks(n_rows, rows_per_chunk), (nk + kKTile - 1) / kKTile);
  if (grid.x == 0) return cudaSuccess;
#define WGRAD_LAUNCH(JJ)                                                          \
  if (nc <= 8 * JJ) {                                                             \
    partial_kernel<JJ, PTS><<<grid, kThreads, 0, s>>>(X, Y, n_rows, nk, nc, counts, \
                                                      cap, rows_per_chunk, radius,  \
                                                      partial);                     \
    return cudaGetLastError();                                                    \
  }
  WGRAD_LAUNCH(1)
  WGRAD_LAUNCH(2)
  WGRAD_LAUNCH(4)
  WGRAD_LAUNCH(8)
  WGRAD_LAUNCH(16)
  WGRAD_LAUNCH(32)
#undef WGRAD_LAUNCH
  return cudaErrorInvalidValue;
}

inline cudaError_t launch_reduce(const float* partial, int n_parts, long long n_elem,
                                 float* out, cudaStream_t s) {
  long long blocks = (n_elem + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks == 0) return cudaSuccess;
  reduce_partials<<<(unsigned)blocks, 256, 0, s>>>(partial, n_parts, n_elem, out);
  return cudaGetLastError();
}

// out (nk, nc) = X^T Y over the valid rows, through partial (n_chunks, nk, nc).
template <bool PTS>
cudaError_t weight_grad(const void* X, const uint16_t* Y, long long n_rows, int nk, int nc,
                        const int* counts, int cap, int rows_per_chunk, float radius,
                        float* partial, float* out, cudaStream_t s) {
  cudaError_t err = launch_partial<PTS>(X, Y, n_rows, nk, nc, counts, cap, rows_per_chunk,
                                        radius, partial, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(partial, n_chunks(n_rows, rows_per_chunk), (long long)nk * nc, out, s);
}

}  // namespace wgrad
