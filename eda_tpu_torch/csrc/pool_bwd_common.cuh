// The pieces the pair-pool backward kernels share (csrc/sa_pair_pool_bwd.cu and
// csrc/sa_pair_pool_bwd_wide_compact.cu): a hash table of window positions, the
// LayerNorm statistics of a 64-row tile in the wgmma accumulator layout, and the
// fixed-order sum of the blocks' dA records.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace pool_bwd {

using namespace wg;

constexpr int kRows = 64;  // rows of a wgmma tile
constexpr uint32_t kEmpty = 0xffffffffu;  // an empty hash slot
constexpr float kEps = 1e-5f;

// A warp's hash table of 2^LOG slots keyed by window position rel; an entry
// is (rel << OB) | o, o < 2^OB the channel.
template <int LOG>
__device__ __forceinline__ uint32_t hash_slot(int rel) {
  return (uint32_t(rel) * 2654435761u) >> (32 - LOG);
}

// Insert (rel, o) into a warp's table: the slot of rel keeps the smallest o.
template <int LOG, int OB>
__device__ __forceinline__ void hash_insert(uint32_t* T, int rel, int o) {
  const uint32_t key = (uint32_t(rel) << OB) | uint32_t(o);
  uint32_t h = hash_slot<LOG>(rel);
  while (true) {
    const uint32_t old = atomicCAS(&T[h], kEmpty, key);
    if (old == kEmpty) return;
    if ((old >> OB) == uint32_t(rel)) {
      atomicMin(&T[h], key);
      return;
    }
    h = (h + 1) & ((1u << LOG) - 1);
  }
}
template <int LOG, int OB>
__device__ __forceinline__ int hash_leader(const uint32_t* T, int rel) {
  uint32_t h = hash_slot<LOG>(rel);
  while ((T[h] >> OB) != uint32_t(rel)) h = (h + 1) & ((1u << LOG) - 1);
  return int(T[h] & ((1u << OB) - 1));
}

// ---- The per-tile LayerNorm of h1 in the accumulator layout. Warpgroup wg holds the C2 / 2 = H2 columns c2 = wg H2 .. of
// a tile's 64 rows, a thread its rows r0 and r0 + 8 at columns c2 + 8 j + 2 t4
// (and + 1). A row's sums over C2: the quad's, then the two warpgroups'
// halves added in order through shared memory (xs: [2 uses][2 warpgroups][64
// rows][2] floats).

// the thread's rows' partial sums (a, b) into its warpgroup's slot of `use`
__device__ __forceinline__ void row_sums_put(float (&a)[2], float (&b)[2], float* xs, int use,
                                             int wg, int r0, int t4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h] += __shfl_xor_sync(0xffffffffu, a[h], 1);
    a[h] += __shfl_xor_sync(0xffffffffu, a[h], 2);
    b[h] += __shfl_xor_sync(0xffffffffu, b[h], 1);
    b[h] += __shfl_xor_sync(0xffffffffu, b[h], 2);
    if (t4 == 0)
      *reinterpret_cast<float2*>(xs + ((2 * use + wg) * kRows + r0 + 8 * h) * 2) =
          make_float2(a[h], b[h]);
  }
}

// after a barrier: the rows' sums of `use`, the two warpgroups' halves in order
__device__ __forceinline__ void row_sums_get(float (&a)[2], float (&b)[2], const float* xs,
                                             int use, int r0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 p0 = *reinterpret_cast<const float2*>(xs + (2 * use * kRows + r0 + 8 * h) * 2);
    const float2 p1 =
        *reinterpret_cast<const float2*>(xs + ((2 * use + 1) * kRows + r0 + 8 * h) * 2);
    a[h] = p0.x + p1.x;
    b[h] = p0.y + p1.y;
  }
}

// a row's mean and rstd from its sums of z and z^2 over C2 columns
template <int C2>
__device__ __forceinline__ void row_stats(const float (&sum)[2], const float (&sq)[2], float c2f,
                                          float rc2, float (&mean)[2], float (&rstd)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] = div_width<C2>(sum[h], c2f, rc2);
    const float var = fmaxf(div_width<C2>(sq[h], c2f, rc2) - mean[h] * mean[h], 0.f);
    rstd[h] = rsqrtf(var + kEps);
  }
}

// LN forward: acc (X, the warpgroup's columns) becomes z = X + b2; the rows'
// mean and rstd (a CTA barrier)
template <int C2, int H2>
__device__ __forceinline__ void ln_stats(float (&acc)[H2 / 2], const float* b2s, float* xs,
                                         int wg, int r0, int t4, float c2f, float rc2,
                                         float (&mean)[2], float (&rstd)[2]) {
  const int c2 = wg * H2;
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < H2 / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float z = acc[4 * j + e] + b2s[c2 + 8 * j + 2 * t4 + (e & 1)];
      acc[4 * j + e] = z;
      sum[e / 2] += z;
      sq[e / 2] += z * z;
    }
  }
  row_sums_put(sum, sq, xs, 0, wg, r0, t4);
  __syncthreads();
  row_sums_get(sum, sq, xs, 0, r0);
  row_stats<C2>(sum, sq, c2f, rc2, mean, rstd);
}

// dA (B, N, C1): for each point, the dA records of the windows that cover it,
// added in block order. A CTA takes kReducePoints points of one batch row;
// its first warp lists the blocks whose window meets them, in order.
constexpr int kReducePoints = 64;

template <int C1>
__global__ void __launch_bounds__(256)
reduce_dA(const float* __restrict__ da_records, const int* __restrict__ starts, int n_blk,
          int N, int W, float* __restrict__ dA) {
  extern __shared__ int hits[];  // [n_blk] block, [n_blk] its window's start
  __shared__ int n_hits;
  const int b = blockIdx.y, p0 = blockIdx.x * kReducePoints;
  const int p1 = min(p0 + kReducePoints, N);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int j0 = 0; j0 < n_blk; j0 += 32) {
      const int j = j0 + lane;
      int s = 0;
      bool hit = false;
      if (j < n_blk) {
        s = min(max(starts[(size_t)b * n_blk + j], 0), N - W);
        hit = s < p1 && s + W > p0;
      }
      const uint32_t mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int k = n + __popc(mask & ((1u << lane) - 1u));
        hits[k] = j;
        hits[n_blk + k] = s;
      }
      n += __popc(mask);
    }
    if (lane == 0) n_hits = n;
  }
  __syncthreads();
  const int n = n_hits;
  for (int i = threadIdx.x; i < kReducePoints * (C1 / 4); i += blockDim.x) {
    const int p = p0 + i / (C1 / 4), q = i % (C1 / 4);
    if (p >= p1) break;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < n; ++k) {
      const int rel = p - hits[n_blk + k];
      if (rel < 0 || rel >= W) continue;
      const float4 v = *reinterpret_cast<const float4*>(
          da_records + (((size_t)b * n_blk + hits[k]) * W + rel) * C1 + 4 * q);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>(dA + ((size_t)b * N + p) * C1 + 4 * q) = acc;
  }
}

}  // namespace pool_bwd
