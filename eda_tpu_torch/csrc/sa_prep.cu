// Fused SA layer-0 prep forward on Hopper:
//   A = LN(bf16(bf16([xyz/r ; f]) @ bf16(W1)) + bf16(b1)) -> bf16
//
// Replaces the TPU kernel eda_tpu/ops/pallas/sa_prep.py:_prep_fwd (body
// _fwd_kernel). The 128-lane padding of A and the 128-lane f32 xyz copy that
// kernel also emits are TPU DMA layouts: here A keeps its real width c1 and
// the pair kernel reads xyz directly.
//
// Rounding points, in order, as the plain version and the TPU kernel:
//   1. xyz / r as an IEEE f32 division (no reciprocal multiply);
//   2. [xyz/r ; f] and W1 rounded to bf16;
//   3. products accumulated in f32 (bf16 x bf16 products are exact, so an FMA
//      rounds like a multiply then an add), the sum rounded once to bf16;
//   4. + bf16(b1), rounded to bf16;
//   5. one-pass LayerNorm stats in f32 over the c1 real channels, eps 1e-5;
//   6. scale and bias in f32, written as bf16.
//
// Bound on this card: bytes. Per point it reads (3 + C) f32 and writes c1
// bf16 (SA1: 24 B in, 128 B out; 7.6 MB per 50 000-point scene), against
// 2 * (3 + C) * c1 flops. Design: one warp per point, lane l owning channels
// l, l+32, ...; W1 is staged once per CTA in shared memory (SA3/4: 259 x 128
// bf16, 66 KB) so the only device traffic is the point row in and the A row
// out, each touched once and coalesced across the warp.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-5f;
constexpr int kMaxSharedBytes = 232448;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

size_t shared_bytes(int in_dim, int c1) {
  return align16((size_t)in_dim * c1 * sizeof(__nv_bfloat16)) +
         (size_t)kWarps * in_dim * sizeof(float);
}

template <int Q>  // channels per lane: c1 <= 32 * Q
__global__ void __launch_bounds__(kThreads)
sa_prep_kernel(const float* __restrict__ pts, long long n_rows, int in_dim, int c1,
               const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ scale, const float* __restrict__ lnb,
               float radius, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  float* rows = reinterpret_cast<float*>(
      smem + align16((size_t)in_dim * c1 * sizeof(__nv_bfloat16)));

  for (int i = threadIdx.x; i < in_dim * c1; i += kThreads) ws[i] = w1[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* row = rows + (size_t)warp * in_dim;

  float bq[Q], sq[Q], lq[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = lane + 32 * q;
    bq[q] = c < c1 ? bf16_round(b1[c]) : 0.f;
    sq[q] = c < c1 ? scale[c] : 0.f;
    lq[q] = c < c1 ? lnb[c] : 0.f;
  }

  for (long long r = (long long)blockIdx.x * kWarps + warp; r < n_rows;
       r += (long long)gridDim.x * kWarps) {
    const float* p = pts + r * in_dim;
    for (int k = lane; k < in_dim; k += 32) {
      const float v = p[k];
      row[k] = bf16_round(k < 3 ? v / radius : v);
    }
    __syncwarp();

    float acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = 0.f;
    for (int k = 0; k < in_dim; ++k) {
      const float a = row[k];
      const __nv_bfloat16* wk = ws + (size_t)k * c1;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = lane + 32 * q;
        if (c < c1) acc[q] = fmaf(a, __bfloat162float(wk[c]), acc[q]);
      }
    }
    __syncwarp();  // the row buffer is rewritten for the next point

    float x[Q];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = lane + 32 * q;
      x[q] = c < c1 ? bf16_round(bf16_round(acc[q]) + bq[q]) : 0.f;
      s1 += x[q];
      s2 += x[q] * x[q];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = s1 / c1;
    const float var = fmaxf(s2 / c1 - mean * mean, 0.f);
    const float rstd = rsqrtf(var + kEps);
    __nv_bfloat16* o = out + r * c1;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = lane + 32 * q;
      if (c < c1) o[c] = __float2bfloat16_rn((x[q] - mean) * rstd * sq[q] + lq[q]);
    }
  }
}

template <int Q>
cudaError_t launch(const float* pts, long long n_rows, int in_dim, int c1,
                   const __nv_bfloat16* w1, const float* b1, const float* scale,
                   const float* lnb, float radius, __nv_bfloat16* out,
                   cudaStream_t s) {
  const size_t smem = shared_bytes(in_dim, c1);
  cudaError_t err = cudaFuncSetAttribute(
      sa_prep_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  long long blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks > 132 * 16) blocks = 132 * 16;
  sa_prep_kernel<Q><<<(unsigned)blocks, kThreads, smem, s>>>(
      pts, n_rows, in_dim, c1, w1, b1, scale, lnb, radius, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest in_dim that fits shared memory for this c1 (0 if c1 is unsupported).
int sa_prep_max_in_dim(int c1) {
  if (c1 <= 0 || c1 > 256) return 0;
  int in_dim = 1;
  while (shared_bytes(in_dim + 1, c1) <= (size_t)kMaxSharedBytes) ++in_dim;
  return in_dim;
}

// pts: (n_rows, in_dim) f32; w1: (in_dim, c1) bf16; b1/scale/lnb: (c1,) f32;
// out: (n_rows, c1) bf16. Returns cudaGetLastError().
int sa_prep_launch(const float* pts, long long n_rows, int in_dim, int c1,
                   const void* w1, const float* b1, const float* scale,
                   const float* lnb, float radius, void* out, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (in_dim < 3 || in_dim > sa_prep_max_in_dim(c1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(w1);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (c1 <= 32) return launch<1>(pts, n_rows, in_dim, c1, w, b1, scale, lnb, radius, o, s);
  if (c1 <= 64) return launch<2>(pts, n_rows, in_dim, c1, w, b1, scale, lnb, radius, o, s);
  if (c1 <= 128) return launch<4>(pts, n_rows, in_dim, c1, w, b1, scale, lnb, radius, o, s);
  return launch<8>(pts, n_rows, in_dim, c1, w, b1, scale, lnb, radius, o, s);
}

}  // extern "C"
