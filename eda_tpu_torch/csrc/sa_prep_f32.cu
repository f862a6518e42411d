// Fused SA layer-0 prep in f32, forward and backward, on CUDA cores:
//   A = LN([xyz/r ; f] @ W1 + b1) -> f32
//
// Replaces the TPU kernels eda_tpu/ops/pallas/sa_prep.py:_prep_fwd and
// _prep_bwd at dtype=float32 (bodies _fwd_kernel and _bwd_kernel), which the
// model reaches with ModelConfig(use_bf16=False). The TPU kernel's 128-lane
// padding of A and its xyz copy are TPU DMA layouts: A keeps its width c1.
//
// Rounding points, as the plain version and the TPU kernel at f32:
//   1. xyz / r as an IEEE f32 division;
//   2. x = [xyz/r ; f] @ W1 as true f32 products (explicit FMAs in K order;
//      no TF32, which would round the operands), then + b1 in f32;
//   3. one-pass LayerNorm statistics over the c1 channels (mean = S1 / c1,
//      var = max(S2 / c1 - mean^2, 0), eps 1e-5), 1 / sqrt(var + eps) in IEEE;
//   4. (x - mean) * rstd * scale + lnb in f32.
// The backward recomputes x the same way, takes dA in f32 unrounded, and
// returns dpts, dW1, db1, dscale and dlnb with
//   dx = rstd (g scale - m1 - xhat m2),  m1 = mean(g scale),
//   m2 = mean(g scale xhat),  dpts = dx W1^T (its xyz columns / r).
//
// Bound on this card: bytes. At batch 8 of the flagship, SA1 (400 000 points,
// in_dim 6, c1 64) moves 9.6 MB in and 102 MB out forward (~0.033 ms at
// 3.35 TB/s); its 2 in_dim c1 flops a point are ~1% of the f32 peak's time.
//
// Design (a simple kernel pair, right before fast):
//   * Forward: one warp per group of 4 rows; W1 (f32, row stride c1 | 1) and
//     the vectors staged once per CTA in shared memory; the group's rows
//     copied to shared memory (xyz divided there); each lane owns the columns
//     lane + 32 j and runs the K loop as FMAs for the 4 rows at once; the row
//     sums and sums of squares by a warp butterfly; coalesced stores.
//   * Backward, three kernels and two record reductions:
//     rows: as the forward to xhat, then dx by two more warp butterflies,
//       written to a scratch (rows, c1); dpts with the lanes over K (the odd
//       row stride of W1 keeps those reads conflict-free); db1, dscale and
//       dlnb as per-lane running sums in row order, one record per warp.
//       The grid is a function of the row count only, so each warp's rows
//       and their order are fixed.
//     dW1: CTAs over (32 x 32 tile of W1, chunk of 2048 rows), each summing
//       xin^T dx over its chunk in row order into its own record.
//     reduce_records (wgmma.cuh) adds the records in a fixed order.
//   Every output is a fixed-order sum: bit-identical across launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;              // rows a warp computes at once
constexpr int kMaxCtas = 264;         // rows kernels: grid cap (fixed, so sums are fixed)
constexpr int kChunk = 2048;          // dW1: rows a CTA sums
constexpr int kTile = 32;             // dW1: the tile of W1 a CTA owns
constexpr int kMaxC1 = 256;
constexpr float kEps = 1e-5f;
constexpr int kMaxSharedBytes = 232448;

__host__ __device__ inline int ld_of(int c1) { return c1 | 1; }

// shared floats: W1, the vectors, each warp's rows (and, backward, its dx rows)
__host__ __device__ inline size_t fwd_floats(int K, int C) {
  return (size_t)K * ld_of(C) + 3 * C + (size_t)kWarps * kRows * K;
}
__host__ __device__ inline size_t bwd_floats(int K, int C) {
  return (size_t)K * ld_of(C) + 2 * C + (size_t)kWarps * kRows * (K + C);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Stage W1 (K x C, row-major) at row stride ld_of(C); the group's rows of pts
// into xw with xyz / r (rows past nr zero).
__device__ __forceinline__ void stage_w1(float* w, const float* __restrict__ w1, int K, int C) {
  const int ld = ld_of(C);
  for (int i = threadIdx.x; i < K * C; i += blockDim.x) w[(i / C) * ld + i % C] = w1[i];
}

__device__ __forceinline__ void load_rows(float* xw, const float* __restrict__ src, int nr,
                                          int K, float radius, int lane) {
  for (int i = lane; i < kRows * K; i += 32) {
    float v = 0.f;
    if (i < nr * K) {
      v = src[i];
      if (i % K < 3) v = v / radius;
    }
    xw[i] = v;
  }
  __syncwarp();
}

// x[r][j] = sum_k xin[r][k] W1[k][lane + 32 j] + b1, FMAs in K order
template <int NC>
__device__ __forceinline__ void project(float (&x)[kRows][NC], const float* xw, const float* w,
                                        const float* b1s, int K, int C, int lane) {
  const int ld = ld_of(C);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) x[r][j] = 0.f;
  for (int k = 0; k < K; ++k) {
    float wv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      wv[j] = c < C ? w[k * ld + c] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float xv = xw[r * K + k];
#pragma unroll
      for (int j = 0; j < NC; ++j) x[r][j] = __fmaf_rn(xv, wv[j], x[r][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    const float b = c < C ? b1s[c] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) x[r][j] = c < C ? x[r][j] + b : 0.f;
  }
}

// one-pass LayerNorm statistics of a row held across the warp (zero past C)
template <int NC>
__device__ __forceinline__ void ln_stats(const float (&x)[NC], int C, float& mean,
                                         float& rstd) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    s1 += x[j];
    s2 += x[j] * x[j];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  mean = s1 / (float)C;
  const float var = fmaxf(s2 / (float)C - mean * mean, 0.f);
  rstd = 1.f / sqrtf(var + kEps);
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
prep_fwd_f32(const float* __restrict__ pts, long long n_rows, int K, int C,
             const float* __restrict__ w1, const float* __restrict__ b1,
             const float* __restrict__ scale, const float* __restrict__ lnb, float radius,
             float* __restrict__ out) {
  extern __shared__ float sm[];
  float* w = sm;
  float* b1s = w + (size_t)K * ld_of(C);
  float* ss = b1s + C;
  float* lbs = ss + C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xw = lbs + C + (size_t)warp * kRows * K;
  stage_w1(w, w1, K, C);
  for (int i = threadIdx.x; i < C; i += kThreads) {
    b1s[i] = b1[i];
    ss[i] = scale[i];
    lbs[i] = lnb[i];
  }
  __syncthreads();
  const long long n_groups = (n_rows + kRows - 1) / kRows;
  for (long long grp = (long long)blockIdx.x * kWarps + warp; grp < n_groups;
       grp += (long long)gridDim.x * kWarps) {
    const long long r0 = grp * kRows;
    const int nr = (int)min((long long)kRows, n_rows - r0);
    load_rows(xw, pts + r0 * K, nr, K, radius, lane);
    float x[kRows][NC];
    project<NC>(x, xw, w, b1s, K, C, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) break;
      float mean, rstd;
      ln_stats<NC>(x[r], C, mean, rstd);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c < C) out[(r0 + r) * C + c] = (x[r][j] - mean) * rstd * ss[c] + lbs[c];
      }
    }
    __syncwarp();  // xw is rewritten by the next group
  }
}

// Backward rows: dx to the scratch, dpts, and the warp's record of
// [db1; dscale; dlnb] (3 C floats).
template <int NC>
__global__ void __launch_bounds__(kThreads)
prep_bwd_rows_f32(const float* __restrict__ pts, const float* __restrict__ dA,
                  long long n_rows, int K, int C, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ scale, float radius,
                  float* __restrict__ dpts, float* __restrict__ dx_out,
                  float* __restrict__ vec_records) {
  extern __shared__ float sm[];
  const int ld = ld_of(C);
  float* w = sm;
  float* b1s = w + (size_t)K * ld;
  float* ss = b1s + C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xw = ss + C + (size_t)warp * kRows * (K + C);
  float* dxw = xw + kRows * K;
  stage_w1(w, w1, K, C);
  for (int i = threadIdx.x; i < C; i += kThreads) {
    b1s[i] = b1[i];
    ss[i] = scale[i];
  }
  __syncthreads();
  float db[NC], dsc[NC], dlb[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) db[j] = dsc[j] = dlb[j] = 0.f;
  const long long n_groups = (n_rows + kRows - 1) / kRows;
  for (long long grp = (long long)blockIdx.x * kWarps + warp; grp < n_groups;
       grp += (long long)gridDim.x * kWarps) {
    const long long r0 = grp * kRows;
    const int nr = (int)min((long long)kRows, n_rows - r0);
    load_rows(xw, pts + r0 * K, nr, K, radius, lane);
    float x[kRows][NC];
    project<NC>(x, xw, w, b1s, K, C, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) break;
      float mean, rstd;
      ln_stats<NC>(x[r], C, mean, rstd);
      float xhat[NC], dxh[NC], g[NC];
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        g[j] = c < C ? dA[(r0 + r) * C + c] : 0.f;
        xhat[j] = c < C ? (x[r][j] - mean) * rstd : 0.f;
        dxh[j] = c < C ? g[j] * ss[c] : 0.f;
        m1 += dxh[j];
        m2 += dxh[j] * xhat[j];
      }
      m1 = warp_sum(m1) / (float)C;
      m2 = warp_sum(m2) / (float)C;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c >= C) continue;
        const float dx = rstd * (dxh[j] - m1 - xhat[j] * m2);
        dsc[j] += g[j] * xhat[j];
        dlb[j] += g[j];
        db[j] += dx;
        dx_out[(r0 + r) * C + c] = dx;
        dxw[r * C + c] = dx;
      }
    }
    __syncwarp();
    // dpts[r][k] = sum_c dx[r][c] W1[k][c], lanes over k
    for (int k = lane; k < K; k += 32) {
      float dp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dp[r] = 0.f;
      for (int c = 0; c < C; ++c) {
        const float wv = w[k * ld + c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) dp[r] = __fmaf_rn(dxw[r * C + c], wv, dp[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) dpts[(r0 + r) * K + k] = k < 3 ? dp[r] / radius : dp[r];
    }
    __syncwarp();  // xw and dxw are rewritten by the next group
  }
  float* rec = vec_records + ((size_t)blockIdx.x * kWarps + warp) * 3 * C;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    if (c < C) {
      rec[c] = db[j];
      rec[C + c] = dsc[j];
      rec[2 * C + c] = dlb[j];
    }
  }
}

// dW1 partial of one (32 x 32 tile of W1, chunk of rows): xin^T dx in row order.
__global__ void __launch_bounds__(kThreads)
prep_bwd_dw1_f32(const float* __restrict__ pts, const float* __restrict__ dx,
                 long long n_rows, int K, int C, float radius, float* __restrict__ w_records) {
  __shared__ float xs[kTile][kTile + 1], ds[kTile][kTile + 1];
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;  // ty: 8 groups of 4 k
  const int k0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const long long row0 = (long long)blockIdx.z * kChunk;
  const long long row1 = min(row0 + kChunk, n_rows);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long t0 = row0; t0 < row1; t0 += kTile) {
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile, q = i % kTile;
      const long long row = t0 + r;
      float xv = 0.f, dv = 0.f;
      if (row < row1) {
        if (k0 + q < K) {
          xv = pts[row * K + k0 + q];
          if (k0 + q < 3) xv = xv / radius;
        }
        if (c0 + q < C) dv = dx[row * C + c0 + q];
      }
      xs[r][q] = xv;
      ds[r][q] = dv;
    }
    __syncthreads();
    const int n = (int)min((long long)kTile, row1 - t0);
    for (int r = 0; r < n; ++r) {
      const float dv = ds[r][tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = __fmaf_rn(xs[r][4 * ty + i], dv, acc[i]);
    }
    __syncthreads();
  }
  float* rec = w_records + (size_t)blockIdx.z * K * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i, c = c0 + tx;
    if (k < K && c < C) rec[(size_t)k * C + c] = acc[i];
  }
}

int rows_ctas(long long n_rows) {
  const long long groups = (n_rows + kRows - 1) / kRows;
  return (int)std::max(1LL, std::min((long long)kMaxCtas, (groups + kWarps - 1) / kWarps));
}

int n_chunks(long long n_rows) { return (int)std::max(1LL, (n_rows + kChunk - 1) / kChunk); }

template <int NC>
cudaError_t launch_fwd(const float* pts, long long n_rows, int K, int C, const float* w1,
                       const float* b1, const float* scale, const float* lnb, float radius,
                       float* out, cudaStream_t s) {
  const size_t bytes = fwd_floats(K, C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(prep_fwd_f32<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prep_fwd_f32<NC>, kThreads,
                                                      bytes);
  if (err != cudaSuccess) return err;
  const long long groups = (n_rows + kRows - 1) / kRows;
  const long long need = (groups + kWarps - 1) / kWarps;
  const int grid = (int)std::max(1LL, std::min(need, (long long)sms * std::max(per_sm, 1)));
  prep_fwd_f32<NC><<<grid, kThreads, bytes, s>>>(pts, n_rows, K, C, w1, b1, scale, lnb, radius,
                                                  out);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_bwd(const float* pts, const float* dA, long long n_rows, int K, int C,
                       const float* w1, const float* b1, const float* scale, float radius,
                       float* dpts, float* wout, float* scratch, cudaStream_t s) {
  const int ctas = rows_ctas(n_rows), chunks = n_chunks(n_rows);
  float* dx = scratch;
  float* w_records = dx + (size_t)n_rows * C;
  float* vec_records = w_records + (size_t)chunks * K * C;
  const size_t bytes = bwd_floats(K, C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(prep_bwd_rows_f32<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  prep_bwd_rows_f32<NC><<<ctas, kThreads, bytes, s>>>(pts, dA, n_rows, K, C, w1, b1, scale,
                                                       radius, dpts, dx, vec_records);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dim3 grid((K + kTile - 1) / kTile, (C + kTile - 1) / kTile, chunks);
  prep_bwd_dw1_f32<<<grid, kThreads, 0, s>>>(pts, dx, n_rows, K, C, radius, w_records);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wg::reduce_records<8><<<(K * C + 31) / 32, 256, 0, s>>>(w_records, chunks, K * C, wout);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wg::reduce_records<8><<<(3 * C + 31) / 32, 256, 0, s>>>(vec_records, ctas * kWarps, 3 * C,
                                                          wout + (size_t)K * C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest in_dim the forward (bwd = 0) or the backward (bwd = 1) takes at this
// c1 (0 if c1 is unsupported).
int sa_prep_f32_max_in_dim(int c1, int bwd) {
  if (c1 <= 0 || c1 > kMaxC1) return 0;
  int K = 3;
  while ((bwd ? bwd_floats(K + 1, c1) : fwd_floats(K + 1, c1)) * sizeof(float) <=
         (size_t)kMaxSharedBytes)
    ++K;
  return K;
}

// Floats of the backward's scratch: dx (n_rows, c1), the dW1 records and the
// warps' vector records.
long long sa_prep_bwd_f32_scratch(long long n_rows, int in_dim, int c1) {
  return n_rows * c1 + (long long)n_chunks(n_rows) * in_dim * c1 +
         (long long)rows_ctas(n_rows) * kWarps * 3 * c1;
}

#define EDA_PREP_F32_DISPATCH(CALL)                           \
  switch ((c1 + 31) / 32) {                                   \
    case 1: return CALL(1); case 2: return CALL(2);           \
    case 3: return CALL(3); case 4: return CALL(4);           \
    case 5: return CALL(5); case 6: return CALL(6);           \
    case 7: return CALL(7); case 8: return CALL(8);           \
    default: return cudaErrorInvalidValue;                    \
  }

// pts: (n_rows, in_dim) f32; w1: (in_dim, c1) f32; b1/scale/lnb: (c1,) f32;
// out: (n_rows, c1) f32. Returns cudaGetLastError().
int sa_prep_f32_launch(const float* pts, long long n_rows, int in_dim, int c1,
                       const float* w1, const float* b1, const float* scale, const float* lnb,
                       float radius, float* out, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (in_dim < 3 || in_dim > sa_prep_f32_max_in_dim(c1, 0)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EDA_FWD(NC) launch_fwd<NC>(pts, n_rows, in_dim, c1, w1, b1, scale, lnb, radius, out, s)
  EDA_PREP_F32_DISPATCH(EDA_FWD)
#undef EDA_FWD
}

// pts: (n_rows, in_dim) f32; dA: (n_rows, c1) f32; w1: (in_dim, c1) f32;
// b1/scale: (c1,) f32. Outputs: dpts (n_rows, in_dim) f32; wout (in_dim c1 +
// 3 c1) f32 = [dW1 (in_dim, c1); db1; dscale; dlnb]. Scratch:
// sa_prep_bwd_f32_scratch floats. Returns cudaGetLastError().
int sa_prep_bwd_f32_launch(const float* pts, const float* dA, long long n_rows, int in_dim,
                           int c1, const float* w1, const float* b1, const float* scale,
                           float radius, float* dpts, float* wout, float* scratch,
                           void* stream) {
  if (n_rows <= 0) return cudaErrorInvalidValue;
  if (in_dim < 3 || in_dim > sa_prep_f32_max_in_dim(c1, 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EDA_BWD(NC) \
  launch_bwd<NC>(pts, dA, n_rows, in_dim, c1, w1, b1, scale, radius, dpts, wout, scratch, s)
  EDA_PREP_F32_DISPATCH(EDA_BWD)
#undef EDA_BWD
}

#undef EDA_PREP_F32_DISPATCH

}  // extern "C"
