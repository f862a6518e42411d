// Fused SA layer-0 prep backward at c1 from 257 to 512 (the width-4 backbone's
// SA2-4: c1 512 at in_dim 515 and 1027), in bf16 ("K7",
// sa_prep_bwd_512_launch) and in f32 ("K7f", sa_prep_bwd_f32_512_launch).
//
// Replaces, at these widths, the TPU kernel eda_tpu/ops/pallas/sa_prep.py:
// _prep_bwd (body _bwd_kernel, :82). It computes ops/cuda/sa_prep.py:
// sa_prep_bwd_plain with the rounding points of csrc/sa_prep_bwd.cu (bf16) and
// csrc/sa_prep_f32.cu (f32): per point row
//   x_in = rnd([xyz / r ; f])                  xyz / r an IEEE division
//   x    = rnd(rnd(x_in @ rnd(W1)) + rnd(b1))  (f32: x_in @ W1 + b1, 3xTF32)
//   xhat = (x - mean) * rstd                   one-pass statistics over the
//                                              c1 real channels, eps 1e-5
//   g = rnd(dA); dxhat = g * scale
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//   dpts = rnd(dx) @ rnd(W1)^T, its xyz columns divided by r
//   dW1 = x_in^T rnd(dx);  db1 = sum dx;  dscale = sum g xhat;  dlnb = sum g
// with rnd the rounding to bf16 (K7) or none (K7f).
//
// Bound on this card: bytes in bf16 (the points in, dA in, dpts out; three
// (rows x in_dim x c1) products, below the bf16 ridge at these shapes), the
// products in f32 (three TF32 products a true-f32 product).
//
// Design, simple first (its time in PERF.md beside its bound). W1 at in_dim
// 1027 (1 MiB in bf16, 2 MiB in f32) fits no CTA and no portable cluster,
// and the LayerNorm backward needs both row means over all 512 columns before
// any dx exists, so the step runs as a few launches through device memory,
// each simple:
//   1. x_in, the layer's input rounded as the forward rounds it, rows padded
//      with zeros to a multiple of 32 values;
//   2. X = x_in W1 (mma_gemm.cuh: mma.sync tiles of 128 x 128, W1 read as it
//      lies, rows = K);
//   3. a warp a row: x, the statistics, xhat, dx and rnd(dx), 16 columns a
//      lane, the row sums by shuffles; each warp's column sums of dx, g xhat
//      and g into a record of its own (a fixed grid of warps, each over the
//      rows w, w + warps, ...);
//   4. dpts = rnd(dx) W1^T (W1 read as the K-contiguous B), then the xyz
//      columns divided by r;
//   5. dW1 = x_in^T rnd(dx), the rows split into equal ranges, each range's
//      partial product a record;
//   6. the records added in order (wgmma.cuh, reduce_records): no atomics,
//      every output the same on every launch.
// The wrapper hands W1, b1 and scale over zero-padded to 512 columns (x there
// is 0 and adds nothing to the sums, divided by the real c1), dA at its real
// c1; dx is 0 past c1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_gemm.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kCols = 512;         // c1, padded
constexpr int kKAlign = 32;        // x_in's rows padded to a multiple of this
constexpr int kMaxInDim = 2048;    // the forward's limit at these widths
constexpr int kRowCtas = 128;      // the row kernel's fixed grid
constexpr int kRowWarps = kRowCtas * 8;
constexpr int kSplitRows = 2048;   // rows of a dW1 split, at least
constexpr int kMaxSplits = 64;
constexpr float kEps = 1e-5f;

__host__ __device__ inline size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

int k_pad(int in_dim) { return (in_dim + kKAlign - 1) / kKAlign * kKAlign; }

int splits(long long n_rows) {
  const long long s = (n_rows + kSplitRows - 1) / kSplitRows;
  return (int)(s < 1 ? 1 : s > kMaxSplits ? kMaxSplits : s);
}

// The scratch of a call, carved in this order.
struct Scratch {
  size_t x_in, x, dxb, part, rec, total;
  Scratch(long long n_rows, int in_dim, size_t elem) {
    size_t o = 0;
    x_in = o;  o += align256((size_t)n_rows * k_pad(in_dim) * elem);
    x = o;     o += align256((size_t)n_rows * kCols * 4);
    dxb = o;   o += align256((size_t)n_rows * kCols * elem);
    part = o;  o += align256((size_t)kRowWarps * 3 * kCols * 4);
    rec = o;   o += align256((size_t)splits(n_rows) * in_dim * kCols * 4);
    total = o;
  }
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ uint16_t to_t<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ float to_t<float>(float v) {
  return v;
}

template <typename T>
__device__ __forceinline__ float from_t(T v);
template <>
__device__ __forceinline__ float from_t<uint16_t>(uint16_t v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
template <>
__device__ __forceinline__ float from_t<float>(float v) {
  return v;
}

// 1. x_in (n_rows, kp): xyz / r and the features, rounded to T, zero past in_dim
template <typename T>
__global__ void build_xin(const float* __restrict__ pts, long long n_rows, int in_dim, int kp,
                          float radius, T* __restrict__ x_in) {
  const long long n = n_rows * kp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / kp;
    const int k = (int)(i % kp);
    float v = 0.f;
    if (k < in_dim) {
      v = pts[r * in_dim + k];
      if (k < 3) v = v / radius;
    }
    x_in[i] = to_t<T>(v);
  }
}

// 3. the LayerNorm backward of a row a warp; lane l holds columns 4 l + 128 i + e
template <typename T>
__global__ void __launch_bounds__(256)
ln_backward(const float* __restrict__ X, const T* __restrict__ dA, long long n_rows, int c1,
            const float* __restrict__ b1, const float* __restrict__ scale, T* __restrict__ dxb,
            float* __restrict__ part) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int lane = threadIdx.x % 32;
  const int wid = blockIdx.x * 8 + threadIdx.x / 32;
  const float inv = 1.f / (float)c1;
  float bias[16], sc[16], s_dx[16], s_gx[16], s_g[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = 4 * lane + 128 * (i / 4) + i % 4;
    bias[i] = kBf16 ? bf16r(b1[j]) : b1[j];
    sc[i] = scale[j];
    s_dx[i] = s_gx[i] = s_g[i] = 0.f;
  }
  for (long long r = wid; r < n_rows; r += kRowWarps) {
    float x[16], g[16];
    const float* xr = X + r * kCols;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(xr + 4 * lane + 128 * q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = 4 * lane + 128 * (i / 4) + i % 4;
      x[i] = kBf16 ? bf16r(bf16r(x[i]) + bias[i]) : x[i] + bias[i];
      g[i] = j < c1 ? from_t<T>(dA[r * c1 + j]) : 0.f;
      s += x[i];
      sq += x[i] * x[i];
    }
#pragma unroll
    for (int m = 16; m >= 1; m /= 2) {
      s += __shfl_xor_sync(0xffffffffu, s, m);
      sq += __shfl_xor_sync(0xffffffffu, sq, m);
    }
    const float mean = s * inv;
    const float var = fmaxf(sq * inv - mean * mean, 0.f);
    const float rstd = rsqrtf(var + kEps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      x[i] = (x[i] - mean) * rstd;  // xhat
      const float dxh = g[i] * sc[i];
      m1 += dxh;
      m2 += dxh * x[i];
    }
#pragma unroll
    for (int m = 16; m >= 1; m /= 2) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, m);
      m2 += __shfl_xor_sync(0xffffffffu, m2, m);
    }
    m1 = m1 * inv;
    m2 = m2 * inv;
    T* out = dxb + r * kCols;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = 4 * lane + 128 * (i / 4) + i % 4;
      const float dxh = g[i] * sc[i];
      const float dx = j < c1 ? rstd * (dxh - m1 - x[i] * m2) : 0.f;
      out[j] = to_t<T>(dx);
      s_dx[i] += dx;
      s_gx[i] += g[i] * x[i];
      s_g[i] += g[i];
    }
  }
  float* rec = part + (size_t)wid * 3 * kCols;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = 4 * lane + 128 * (i / 4) + i % 4;
    rec[j] = s_dx[i];
    rec[kCols + j] = s_gx[i];
    rec[2 * kCols + j] = s_g[i];
  }
}

// 4b. dpts's xyz columns divided by r
__global__ void scale_xyz(float* __restrict__ dpts, long long n_rows, int in_dim, float radius) {
  const long long n = n_rows * 3;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float* p = dpts + (i / 3) * in_dim + i % 3;
    *p = *p / radius;
  }
}

int grid_of(long long n, int threads) {
  const long long b = (n + threads - 1) / threads;
  return (int)(b < 1 ? 1 : b > 4096 ? 4096 : b);
}

template <typename T>
int launch(const float* pts, const void* dA, long long n_rows, int in_dim, int c1,
           const void* w1, const float* b1, const float* scale, float radius, float* dpts,
           float* wout, void* scratch, void* stream) {
  if (n_rows <= 0) {
    return (int)cudaMemsetAsync(wout, 0, (size_t)(in_dim + 3) * kCols * 4,
                                static_cast<cudaStream_t>(stream));
  }
  if (in_dim < 3 || in_dim > kMaxInDim || c1 < 1 || c1 > kCols) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w1) & 15) || (reinterpret_cast<uintptr_t>(scratch) & 255) ||
      n_rows > (1ll << 30))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc(n_rows, in_dim, sizeof(T));
  auto* base = static_cast<unsigned char*>(scratch);
  T* x_in = reinterpret_cast<T*>(base + sc.x_in);
  float* X = reinterpret_cast<float*>(base + sc.x);
  T* dxb = reinterpret_cast<T*>(base + sc.dxb);
  float* part = reinterpret_cast<float*>(base + sc.part);
  float* rec = reinterpret_cast<float*>(base + sc.rec);
  const T* w = static_cast<const T*>(w1);
  const int kp = k_pad(in_dim);
  const int M = (int)n_rows;

  build_xin<T><<<grid_of(n_rows * kp, 256), 256, 0, s>>>(pts, n_rows, in_dim, kp, radius, x_in);
  cudaError_t err = mg::gemm<T, true, false>(x_in, kp, w, kCols, X, kCols, M, kCols, in_dim, 1, s);
  if (err != cudaSuccess) return err;
  ln_backward<T><<<kRowCtas, 256, 0, s>>>(X, static_cast<const T*>(dA), n_rows, c1, b1, scale,
                                         dxb, part);
  err = mg::gemm<T, true, true>(dxb, kCols, w, kCols, dpts, in_dim, M, in_dim, kCols, 1, s);
  if (err != cudaSuccess) return err;
  scale_xyz<<<grid_of(n_rows * 3, 256), 256, 0, s>>>(dpts, n_rows, in_dim, radius);
  const int S = splits(n_rows);
  err = mg::gemm<T, false, false>(x_in, kp, dxb, kCols, rec, kCols, in_dim, kCols, M, S, s);
  if (err != cudaSuccess) return err;
  const int P = in_dim * kCols;
  wg::reduce_records<8><<<(P + 31) / 32, 256, 0, s>>>(rec, S, P, wout);
  wg::reduce_records<8><<<(3 * kCols + 31) / 32, 256, 0, s>>>(part, kRowWarps, 3 * kCols,
                                                              wout + P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest in_dim the kernels take at width c1 (0: c1 unsupported).
int sa_prep_bwd_512_max_in_dim(int c1) { return c1 < 1 || c1 > kCols ? 0 : kMaxInDim; }

// Bytes of scratch a call takes (f32: K7f's).
long long sa_prep_bwd_512_scratch_bytes(long long n_rows, int in_dim, int f32) {
  return (long long)Scratch(n_rows, in_dim, f32 ? 4 : 2).total;
}

// pts: (n_rows, in_dim) f32; dA: (n_rows, c1) bf16; w1: (in_dim, 512) bf16 and
// b1 / scale: (512,) f32, zero past the real c1. Outputs: dpts (n_rows,
// in_dim) f32 and wout ((in_dim + 3) * 512) f32 = [dW1 (in_dim, 512); db1;
// dscale; dlnb], zero past c1. scratch: sa_prep_bwd_512_scratch_bytes,
// 256-byte aligned. Returns cudaGetLastError().
int sa_prep_bwd_512_launch(const float* pts, const void* dA, long long n_rows, int in_dim,
                           int c1, const void* w1, const float* b1, const float* scale,
                           float radius, float* dpts, float* wout, void* scratch, void* stream) {
  return launch<uint16_t>(pts, dA, n_rows, in_dim, c1, w1, b1, scale, radius, dpts, wout,
                          scratch, stream);
}

// As sa_prep_bwd_512_launch in f32: dA (n_rows, c1) f32, unrounded; w1
// (in_dim, 512) f32.
int sa_prep_bwd_f32_512_launch(const float* pts, const void* dA, long long n_rows, int in_dim,
                               int c1, const void* w1, const float* b1, const float* scale,
                               float radius, float* dpts, float* wout, void* scratch,
                               void* stream) {
  return launch<float>(pts, dA, n_rows, in_dim, c1, w1, b1, scale, radius, dpts, wout, scratch,
                       stream);
}

}  // extern "C"
