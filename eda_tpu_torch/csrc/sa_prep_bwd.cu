// Fused SA layer-0 prep backward on Hopper.
//
// Replaces the TPU kernel eda_tpu/ops/pallas/sa_prep.py:_prep_bwd (body
// _bwd_kernel). The forward (sa_prep.cu) is
//   x = bf16(bf16(bf16([xyz/r ; f]) @ bf16(W1)) + bf16(b1)),  A = LN(x)
// with one-pass LayerNorm statistics. Given dA (bf16, as the TPU wrapper
// rounds it), per point:
//   xhat = (x - mean) * rstd                   recomputed with the forward's
//                                              rounding points
//   dscale += dA * xhat,  dlnb += dA
//   dxhat = dA * scale
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//   db1 += dx,  dW1 += bf16([xyz/r ; f])^T bf16(dx)
//   dpts = bf16(dx) @ bf16(W1)^T, its xyz columns divided by r
//
// Bound on this card: bytes. Per point it reads (3 + C) f32 and c1 bf16 and
// writes (3 + C) f32; dW1 is a (3+C) x c1 sum over B*N rows (400 000 at SA1).
// Design: pass 1 runs one warp per point (lane l owns channels l, l+32, ...)
// with W1 and W1^T staged in shared memory; it writes dpts, the rounded dx
// rows to a scratch matrix, and one partial of db1 / dscale / dlnb per CTA.
// Pass 2 (wgrad.cuh) forms dW1 from the points and the dx rows in chunks of
// rows with one partial each, and pass 3 adds the partials in order. No
// global atomics: the weight gradients are the same from run to run.

#include "wgrad.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-5f;
constexpr int kMaxSharedBytes = 232448;
constexpr int kMaxCtas = 132 * 8;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// W1 [k][c] and W1^T [c][k] as bf16, then per warp a point row and a dx row.
size_t shared_bytes(int in_dim, int c1) {
  return 2 * align16((size_t)in_dim * c1 * 2) + (size_t)kWarps * (in_dim + c1) * 4 +
         (size_t)kWarps * 3 * c1 * 4;
}

template <int Q>  // channels per lane: c1 <= 32 * Q
__global__ void __launch_bounds__(kThreads)
sa_prep_bwd_rows(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ dA,
                 long long n_rows, int in_dim, int c1,
                 const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ scale, float radius,
                 float* __restrict__ dpts, __nv_bfloat16* __restrict__ dx_rows,
                 float* __restrict__ vec_partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + align16((size_t)in_dim * c1 * 2));
  float* rows = reinterpret_cast<float*>(smem + 2 * align16((size_t)in_dim * c1 * 2));
  float* red = rows + (size_t)kWarps * (in_dim + c1);  // [warp][3][c1]

  for (int i = threadIdx.x; i < in_dim * c1; i += kThreads) {
    const __nv_bfloat16 v = w1[i];
    ws[i] = v;
    wt[(size_t)(i % c1) * in_dim + i / c1] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* row = rows + (size_t)warp * (in_dim + c1);
  float* dxr = row + in_dim;

  float bq[Q], sq[Q], acc_db[Q], acc_ds[Q], acc_dl[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = lane + 32 * q;
    bq[q] = c < c1 ? bf16_round(b1[c]) : 0.f;
    sq[q] = c < c1 ? scale[c] : 0.f;
    acc_db[q] = acc_ds[q] = acc_dl[q] = 0.f;
  }

  for (long long r = (long long)blockIdx.x * kWarps + warp; r < n_rows;
       r += (long long)gridDim.x * kWarps) {
    const float* p = pts + r * in_dim;
    for (int k = lane; k < in_dim; k += 32) {
      const float v = p[k];
      row[k] = bf16_round(k < 3 ? v / radius : v);
    }
    __syncwarp();

    // recompute x and the LayerNorm statistics exactly as the forward
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
    float x[Q], g[Q];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = lane + 32 * q;
      x[q] = c < c1 ? bf16_round(bf16_round(acc[q]) + bq[q]) : 0.f;
      g[q] = c < c1 ? __bfloat162float(dA[r * c1 + c]) : 0.f;
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

    float xhat[Q], dxhat[Q];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      xhat[q] = (x[q] - mean) * rstd;
      acc_ds[q] += g[q] * xhat[q];
      acc_dl[q] += g[q];
      dxhat[q] = g[q] * sq[q];
      m1 += dxhat[q];
      m2 += dxhat[q] * xhat[q];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, off);
      m2 += __shfl_xor_sync(0xffffffffu, m2, off);
    }
    m1 /= c1;
    m2 /= c1;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = lane + 32 * q;
      if (c < c1) {
        const float dx = rstd * (dxhat[q] - m1 - xhat[q] * m2);
        acc_db[q] += dx;
        const __nv_bfloat16 dxb = __float2bfloat16_rn(dx);
        dx_rows[r * c1 + c] = dxb;
        dxr[c] = __bfloat162float(dxb);
      }
    }
    __syncwarp();

    // dpts[k] = sum_c bf16(dx)[c] * W1[k][c]; xyz columns divided by r
    for (int k = lane; k < in_dim; k += 32) {
      const __nv_bfloat16* wk = wt;
      float s = 0.f;
      for (int c = 0; c < c1; ++c) s = fmaf(dxr[c], __bfloat162float(wk[(size_t)c * in_dim + k]), s);
      dpts[r * in_dim + k] = k < 3 ? s / radius : s;
    }
    __syncwarp();  // the row buffers are rewritten for the next point
  }

  // per-CTA partials of db1, dscale, dlnb
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = lane + 32 * q;
    if (c < c1) {
      red[((size_t)warp * 3 + 0) * c1 + c] = acc_db[q];
      red[((size_t)warp * 3 + 1) * c1 + c] = acc_ds[q];
      red[((size_t)warp * 3 + 2) * c1 + c] = acc_dl[q];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * c1; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(size_t)w * 3 * c1 + i];
    vec_partial[(size_t)blockIdx.x * 3 * c1 + i] = s;
  }
}

template <int Q>
cudaError_t launch_rows(const float* pts, const __nv_bfloat16* dA, long long n_rows,
                        int in_dim, int c1, const __nv_bfloat16* w1, const float* b1,
                        const float* scale, float radius, float* dpts,
                        __nv_bfloat16* dx_rows, float* vec_partial, int n_ctas,
                        cudaStream_t s) {
  const size_t smem = shared_bytes(in_dim, c1);
  cudaError_t err = cudaFuncSetAttribute(
      sa_prep_bwd_rows<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sa_prep_bwd_rows<Q><<<n_ctas, kThreads, smem, s>>>(pts, dA, n_rows, in_dim, c1, w1, b1,
                                                     scale, radius, dpts, dx_rows,
                                                     vec_partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// CTAs of the row pass for n_rows points (the wrapper sizes vec_partial with it).
int sa_prep_bwd_ctas(long long n_rows) {
  long long blocks = (n_rows + kWarps - 1) / kWarps;
  return (int)(blocks < kMaxCtas ? (blocks > 0 ? blocks : 1) : kMaxCtas);
}

// Largest in_dim that fits shared memory for this c1 (0 if c1 is unsupported).
int sa_prep_bwd_max_in_dim(int c1) {
  if (c1 <= 0 || c1 > 256) return 0;
  int in_dim = 1;
  while (shared_bytes(in_dim + 1, c1) <= (size_t)kMaxSharedBytes) ++in_dim;
  return in_dim;
}

// pts: (n_rows, in_dim) f32; dA: (n_rows, c1) bf16; w1: (in_dim, c1) bf16;
// b1/scale: (c1,) f32. Outputs: dpts (n_rows, in_dim) f32, dw1 (in_dim, c1)
// f32, vec_out (3, c1) f32 = [db1; dscale; dlnb]. Scratch: dx_rows (n_rows,
// c1) bf16, vec_partial (sa_prep_bwd_ctas(n_rows), 3 * c1) f32, w_partial
// (ceil(n_rows / rows_per_chunk), in_dim, c1) f32. Returns cudaGetLastError().
int sa_prep_bwd_launch(const float* pts, const void* dA, long long n_rows, int in_dim,
                       int c1, const void* w1, const float* b1, const float* scale,
                       float radius, int rows_per_chunk, float* dpts, float* dw1,
                       float* vec_out, void* dx_rows, float* vec_partial,
                       float* w_partial, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (in_dim < 3 || in_dim > sa_prep_bwd_max_in_dim(c1) || rows_per_chunk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const __nv_bfloat16*>(dA);
  const auto* w = static_cast<const __nv_bfloat16*>(w1);
  auto* dxr = static_cast<__nv_bfloat16*>(dx_rows);
  const int n_ctas = sa_prep_bwd_ctas(n_rows);
  cudaError_t err;
#define EDA_ROWS(Q)                                                                 \
  launch_rows<Q>(pts, g, n_rows, in_dim, c1, w, b1, scale, radius, dpts, dxr, vec_partial, \
                 n_ctas, s)
  if (c1 <= 32)
    err = EDA_ROWS(1);
  else if (c1 <= 64)
    err = EDA_ROWS(2);
  else if (c1 <= 128)
    err = EDA_ROWS(4);
  else
    err = EDA_ROWS(8);
#undef EDA_ROWS
  if (err != cudaSuccess) return err;
  err = wgrad::weight_grad<true>(pts, reinterpret_cast<const uint16_t*>(dxr), n_rows, in_dim,
                                 c1, nullptr, 1, rows_per_chunk, radius, w_partial, dw1, s);
  if (err != cudaSuccess) return err;
  return wgrad::launch_reduce(vec_partial, n_ctas, 3LL * c1, vec_out, s);
}

}  // extern "C"
