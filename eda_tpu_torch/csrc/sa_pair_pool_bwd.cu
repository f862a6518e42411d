// Fused set-abstraction pair-pool backward on Hopper, in two variants.
//
// Replaces the TPU kernels of eda_tpu/ops/pallas/sa_kernel.py:
// sa_pair_pool_bwd_pallas with compact=True (_make_bwd_compact_kernel, "K5",
// chosen at SA1) and compact=False (_make_bwd_kernel, "K6", SA2-4).
//
// The forward pooled z = h1 @ W3 + b3 over in-radius pairs, with
//   h0 = bf16(relu(A_p + bc_c)),  h1 = bf16(relu(LN(h0 @ W2 + b2) * s2 + lb2))
// and exported, per (center c, channel o), the global rank of the winning
// point. The cotangent g[c, o] flows to that pair only. Per pair row the
// kernel recomputes h0 -> h1 and backpropagates through W3, the LayerNorm and
// W2. The two variants differ in what a row is and where bf16 rounds:
//   compact:  one row per (center, channel) with a one-hot cotangent; the row
//             adds bf16(dh0) into dA;
//   windowed: one row per winning point of a center, with the cotangents of
//             all channels it won; the row adds dh0 into dA in exact f32.
// Both round the row cotangent to bf16 before W3^T and dx to bf16 before
// W2^T, and sum db_c, db2, db3 and the LayerNorm gradients in f32 unrounded.
//
// Bound on this card: operations. The TPU kernels recompute whole window
// tiles (windowed) or select winner rows by 0/1 matmuls (compact); here a row
// gathers its A row by index, and only rows that carry a cotangent run: a row
// with zero cotangent adds exact zeros on the TPU. Per row the two W2 products
// cost 2 * c1 * c2 flops and the W3^T product c2 per won channel.
//
// Design. Pass 1: one CTA per (batch row, block of 16 centers), 8 warps; W2,
// W2^T and W3^T sit in shared memory. Per center the CTA lists its live rows
// (windowed: the distinct in-window winners, found with a window-sized map in
// shared memory), then each warp runs whole rows, lane l owning channels l,
// l+32, .... dA is shared by overlapping windows of other CTAs, so rows add
// into an f32 dA with atomicAdd (the TPU's read-modify-write is safe only on
// its sequential grid); db_c is summed per center in shared memory. Each row
// also stores h0, bf16(dx), h1 and its bf16 cotangent in scratch slots, and
// each CTA one partial of db2, ds2, dlb2, db3. Pass 2 (wgrad.cuh) forms dW2 =
// H0^T DX and dW3 = H1^T D from the slots in chunks of rows with one partial
// each; pass 3 adds the partials in order.

#include <climits>

#include "wgrad.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCenters = 16;
constexpr float kEps = 1e-5f;
constexpr int kMaxSharedBytes = 232448;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bits_to_float(uint16_t u) {
  return __uint_as_float(uint32_t(u) << 16);
}
__device__ __forceinline__ uint16_t float_to_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Layout {
  size_t w2, w2t, w3t, map, row_of, row_pos, row_ch, gs, bufs, red, total;
  __host__ __device__ Layout(int c1, int c2, int c3, int W, int Q) {
    size_t o = 0;
    w2 = o;      o += align16((size_t)c1 * c2 * 2);
    w2t = o;     o += align16((size_t)c2 * c1 * 2);
    w3t = o;     o += align16((size_t)c3 * c2 * 2);
    map = o;     o += align16((size_t)W * 4);
    row_of = o;  o += align16((size_t)c3 * 4);
    row_pos = o; o += align16((size_t)c3 * 4);
    row_ch = o;  o += align16((size_t)c3 * 4);
    gs = o;      o += align16((size_t)c3 * 4 + 16);  // + the row count
    bufs = o;    o += align16((size_t)kWarps * 2 * 32 * Q * 4);
    red = o;     o += align16((size_t)kWarps * 3 * 32 * Q * 4);
    total = o;
  }
};

template <bool COMPACT, int Q>  // Q: channels per lane, c1 and c2 <= 32 * Q
__global__ void __launch_bounds__(kThreads)
pool_bwd_rows(const uint16_t* __restrict__ A, const uint16_t* __restrict__ bc,
              const float* __restrict__ g, const int* __restrict__ win,
              const int* __restrict__ starts, const uint16_t* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ s2,
              const float* __restrict__ lb2, const uint16_t* __restrict__ w3,
              int N, int M, int c1, int c2, int c3, int W,
              float* __restrict__ dA, float* __restrict__ dbc,
              uint16_t* __restrict__ H0, uint16_t* __restrict__ DX,
              uint16_t* __restrict__ H1, uint16_t* __restrict__ D,
              int* __restrict__ counts, float* __restrict__ vec_partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(c1, c2, c3, COMPACT ? 0 : W, Q);
  uint16_t* w2s = reinterpret_cast<uint16_t*>(smem + L.w2);    // [k][c]
  uint16_t* w2t = reinterpret_cast<uint16_t*>(smem + L.w2t);   // [c][k]
  uint16_t* w3t = reinterpret_cast<uint16_t*>(smem + L.w3t);   // [o][c]
  int* map = reinterpret_cast<int*>(smem + L.map);             // window pos -> leader channel
  int* row_of = reinterpret_cast<int*>(smem + L.row_of);       // channel -> row
  int* row_pos = reinterpret_cast<int*>(smem + L.row_pos);     // row -> window pos
  int* row_ch = reinterpret_cast<int*>(smem + L.row_ch);       // row -> first channel
  float* gs = reinterpret_cast<float*>(smem + L.gs);           // the center's cotangent
  int* n_rows = reinterpret_cast<int*>(gs + c3);
  float* bufs = reinterpret_cast<float*>(smem + L.bufs);       // [warp][h0 | dx]
  float* red = reinterpret_cast<float*>(smem + L.red);         // [warp][3][32Q]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int n_blocks = M / kCenters;
  const int m0 = blockIdx.x * kCenters;
  int start = starts[(size_t)b * n_blocks + blockIdx.x];
  start = min(max(start, 0), N - W);

  for (int i = tid; i < c1 * c2; i += kThreads) {
    const uint16_t v = w2[i];
    w2s[i] = v;
    w2t[(size_t)(i % c2) * c1 + i / c2] = v;
  }
  for (int i = tid; i < c2 * c3; i += kThreads)
    w3t[(size_t)(i % c3) * c2 + i / c3] = w3[i];

  float b2q[Q], s2q[Q], lb2q[Q];
  float acc_db2[Q], acc_ds2[Q], acc_dlb2[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = lane + 32 * q;
    b2q[q] = c < c2 ? b2[c] : 0.f;
    s2q[q] = c < c2 ? s2[c] : 0.f;
    lb2q[q] = c < c2 ? lb2[c] : 0.f;
    acc_db2[q] = acc_ds2[q] = acc_dlb2[q] = 0.f;
  }
  float acc_db3 = 0.f;  // channel tid (c3 <= 256)
  float* h0b = bufs + (size_t)warp * 64 * Q;
  float* dxb = h0b + 32 * Q;

  for (int cc = 0; cc < kCenters; ++cc) {
    const int m = m0 + cc;
    const size_t cm = (size_t)b * M + m;
    __syncthreads();  // the previous center's lists and buffers are free
    for (int o = tid; o < c3; o += kThreads) {
      gs[o] = g[cm * c3 + o];
      row_of[o] = -1;
    }
    if (!COMPACT)
      for (int i = tid; i < W; i += kThreads) map[i] = INT_MAX;
    if (tid == 0) *n_rows = 0;
    __syncthreads();

    // ---- the center's live rows
    if (COMPACT) {
      for (int o = tid; o < c3; o += kThreads) {
        if (gs[o] != 0.f) {
          const int r = atomicAdd(n_rows, 1);
          row_of[o] = r;
          row_pos[r] = win[cm * c3 + o] - start;
          row_ch[r] = o;
        }
      }
    } else {
      for (int o = tid; o < c3; o += kThreads) {
        const int rel = win[cm * c3 + o] - start;
        if (gs[o] != 0.f && rel >= 0 && rel < W) atomicMin(&map[rel], o);
      }
      __syncthreads();
      for (int o = tid; o < c3; o += kThreads) {
        const int rel = win[cm * c3 + o] - start;
        if (gs[o] != 0.f && rel >= 0 && rel < W && map[rel] == o) {
          const int r = atomicAdd(n_rows, 1);
          row_of[o] = r;
          row_pos[r] = rel;
          row_ch[r] = o;
        }
      }
      __syncthreads();
      for (int o = tid; o < c3; o += kThreads) {
        const int rel = win[cm * c3 + o] - start;
        if (gs[o] != 0.f && rel >= 0 && rel < W && map[rel] != o) row_of[o] = row_of[map[rel]];
      }
    }
    __syncthreads();
    const int nr = *n_rows;
    if (tid < c3) acc_db3 += (COMPACT || row_of[tid] >= 0) ? gs[tid] : 0.f;

    float acc_dbc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc_dbc[q] = 0.f;

    for (int r = warp; r < nr; r += kWarps) {
      const int rel = row_pos[r];
      const bool in_win = rel >= 0 && rel < W;
      const size_t slot = cm * c3 + r;
      // recompute h0 and h1 at the row's pair
      float h0pre[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int k = lane + 32 * q;
        float v = 0.f;
        if (k < c1) {
          const float a = in_win ? bits_to_float(A[((size_t)b * N + start + rel) * c1 + k]) : 0.f;
          v = a + bits_to_float(bc[cm * c1 + k]);
          const float h0 = bf16_round(fmaxf(v, 0.f));
          h0b[k] = h0;
          H0[slot * c1 + k] = float_to_bits(h0);
        }
        h0pre[q] = v;
      }
      __syncwarp();
      float x[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) x[q] = 0.f;
      for (int k = 0; k < c1; ++k) {
        const float hk = h0b[k];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int c = lane + 32 * q;
          if (c < c2) x[q] = fmaf(hk, bits_to_float(w2s[(size_t)k * c2 + c]), x[q]);
        }
      }
      float s1 = 0.f, sq = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = lane + 32 * q;
        x[q] = c < c2 ? x[q] + b2q[q] : 0.f;
        s1 += x[q];
        sq += x[q] * x[q];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      }
      const float mean = s1 / c2;
      const float var = fmaxf(sq / c2 - mean * mean, 0.f);
      const float rstd = rsqrtf(var + kEps);
      float xhat[Q], h1[Q], dh[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = lane + 32 * q;
        xhat[q] = (x[q] - mean) * rstd;
        h1[q] = c < c2 ? bf16_round(fmaxf(xhat[q] * s2q[q] + lb2q[q], 0.f)) : 0.f;
        if (c < c2) H1[slot * c2 + c] = float_to_bits(h1[q]);
        dh[q] = 0.f;
      }
      // the row's cotangent: bf16 into D, and dh1 = bf16(d) @ W3^T
      for (int o = lane; o < c3; o += 32)
        D[slot * c3 + o] = float_to_bits(row_of[o] == r ? gs[o] : 0.f);
      if (COMPACT) {
        const int o = row_ch[r];
        const float go = bf16_round(gs[o]);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int c = lane + 32 * q;
          if (c < c2) dh[q] = go * bits_to_float(w3t[(size_t)o * c2 + c]);
        }
      } else {
        for (int o = row_ch[r]; o < c3; ++o) {
          if (row_of[o] != r) continue;
          const float go = bf16_round(gs[o]);
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int c = lane + 32 * q;
            if (c < c2) dh[q] = fmaf(go, bits_to_float(w3t[(size_t)o * c2 + c]), dh[q]);
          }
        }
      }
      // interior LayerNorm + ReLU backward
      float dxhat[Q];
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float dln = h1[q] > 0.f ? dh[q] : 0.f;
        acc_ds2[q] += dln * xhat[q];
        acc_dlb2[q] += dln;
        dxhat[q] = dln * s2q[q];
        m1 += dxhat[q];
        m2 += dxhat[q] * xhat[q];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m1 += __shfl_xor_sync(0xffffffffu, m1, off);
        m2 += __shfl_xor_sync(0xffffffffu, m2, off);
      }
      m1 /= c2;
      m2 /= c2;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = lane + 32 * q;
        if (c < c2) {
          const float dx = rstd * (dxhat[q] - m1 - xhat[q] * m2);
          acc_db2[q] += dx;
          const float dxr = bf16_round(dx);
          dxb[c] = dxr;
          DX[slot * c2 + c] = float_to_bits(dxr);
        }
      }
      __syncwarp();
      // dh0 = bf16(dx) @ W2^T, through the first ReLU
      float dh0[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) dh0[q] = 0.f;
      for (int c = 0; c < c2; ++c) {
        const float dv = dxb[c];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int k = lane + 32 * q;
          if (k < c1) dh0[q] = fmaf(dv, bits_to_float(w2t[(size_t)c * c1 + k]), dh0[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int k = lane + 32 * q;
        if (k < c1) {
          const float v = h0pre[q] > 0.f ? dh0[q] : 0.f;
          acc_dbc[q] += v;
          if (in_win)
            atomicAdd(&dA[((size_t)b * N + start + rel) * c1 + k], COMPACT ? bf16_round(v) : v);
        }
      }
      __syncwarp();  // h0b / dxb are rewritten by the warp's next row
    }

    // db_c: the center's rows summed over the warps, in warp order
#pragma unroll
    for (int q = 0; q < Q; ++q) red[(size_t)warp * 3 * 32 * Q + lane + 32 * q] = acc_dbc[q];
    __syncthreads();
    for (int k = tid; k < c1; k += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[(size_t)w * 3 * 32 * Q + k];
      dbc[cm * c1 + k] = s;
    }
    if (tid == 0) counts[cm] = nr;
  }

  // per-CTA partials of db2, ds2, dlb2 and db3
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float* rw = red + (size_t)warp * 3 * 32 * Q + lane + 32 * q;
    rw[0] = acc_db2[q];
    rw[32 * Q] = acc_ds2[q];
    rw[64 * Q] = acc_dlb2[q];
  }
  __syncthreads();
  const size_t width = 3 * (size_t)c2 + c3;
  float* out = vec_partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * width;
  for (int i = tid; i < 3 * c2; i += kThreads) {
    const int part = i / c2, c = i % c2;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(size_t)w * 3 * 32 * Q + part * 32 * Q + c];
    out[i] = s;
  }
  if (tid < c3) out[3 * c2 + tid] = acc_db3;
}

template <bool COMPACT, int Q>
cudaError_t launch_rows(const uint16_t* A, const uint16_t* bc, const float* g,
                        const int* win, const int* starts, const uint16_t* w2,
                        const float* b2, const float* s2, const float* lb2,
                        const uint16_t* w3, int B, int N, int M, int c1, int c2, int c3,
                        int W, float* dA, float* dbc, uint16_t* H0, uint16_t* DX,
                        uint16_t* H1, uint16_t* D, int* counts, float* vec_partial,
                        cudaStream_t s) {
  const Layout L(c1, c2, c3, COMPACT ? 0 : W, Q);
  if (L.total > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pool_bwd_rows<COMPACT, Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return err;
  dim3 grid(M / kCenters, B);
  pool_bwd_rows<COMPACT, Q><<<grid, kThreads, L.total, s>>>(
      A, bc, g, win, starts, w2, b2, s2, lb2, w3, N, M, c1, c2, c3, W, dA, dbc, H0, DX, H1,
      D, counts, vec_partial);
  return cudaGetLastError();
}

template <bool COMPACT>
int launch(const void* A, const void* bc, const float* g, const int* win,
           const int* starts, const void* w2, const float* b2, const float* s2,
           const float* lb2, const void* w3, int B, int N, int M, int c1, int c2, int c3,
           int W, int rows_per_chunk, float* dA, float* dbc, float* dw2, float* dw3,
           float* vec_out, void* H0, void* DX, void* H1, void* D, int* counts,
           float* vec_partial, float* w2_partial, float* w3_partial, void* stream) {
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (M % kCenters || W <= 0 || W > N || c3 > kThreads || rows_per_chunk <= 0 ||
      c1 <= 0 || c2 <= 0 || c3 <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint16_t*>(A);
  const auto* bcv = static_cast<const uint16_t*>(bc);
  const auto* w2v = static_cast<const uint16_t*>(w2);
  const auto* w3v = static_cast<const uint16_t*>(w3);
  auto* h0 = static_cast<uint16_t*>(H0);
  auto* dx = static_cast<uint16_t*>(DX);
  auto* h1 = static_cast<uint16_t*>(H1);
  auto* d = static_cast<uint16_t*>(D);
  const int cmax = c1 > c2 ? c1 : c2;
  cudaError_t err;
#define EDA_ROWS(Q)                                                                \
  launch_rows<COMPACT, Q>(a, bcv, g, win, starts, w2v, b2, s2, lb2, w3v, B, N, M, c1, \
                          c2, c3, W, dA, dbc, h0, dx, h1, d, counts, vec_partial, s)
  if (cmax <= 32)
    err = EDA_ROWS(1);
  else if (cmax <= 64)
    err = EDA_ROWS(2);
  else if (cmax <= 128)
    err = EDA_ROWS(4);
  else
    return cudaErrorInvalidValue;
#undef EDA_ROWS
  if (err != cudaSuccess) return err;
  const long long slots = (long long)B * M * c3;
  err = wgrad::weight_grad<false>(h0, dx, slots, c1, c2, counts, c3, rows_per_chunk, 1.f,
                                  w2_partial, dw2, s);
  if (err != cudaSuccess) return err;
  err = wgrad::weight_grad<false>(h1, d, slots, c2, c3, counts, c3, rows_per_chunk, 1.f,
                                  w3_partial, dw3, s);
  if (err != cudaSuccess) return err;
  return wgrad::launch_reduce(vec_partial, B * (M / kCenters), 3LL * c2 + c3, vec_out, s);
}

}  // namespace

extern "C" {

// A: (B, N, c1) bf16; bc: (B, M, c1) bf16; g: (B, M, c3) f32; win: (B, M, c3)
// int32 global winner ranks; starts: (B, M/16) int32 window starts (multiples
// of 16 in [0, N-W]); w2: (c1, c2) bf16; b2/s2/lb2: (c2,) f32; w3: (c2, c3)
// bf16. Outputs: dA (B, N, c1) f32, ZEROED by the caller (rows add into it);
// dbc (B, M, c1) f32; dw2 (c1, c2), dw3 (c2, c3) f32; vec_out (3*c2 + c3) f32
// = [db2; ds2; dlb2; db3]. Scratch: H0 (B*M*c3, c1), DX and H1 (B*M*c3, c2),
// D (B*M*c3, c3) bf16; counts (B*M) int32; vec_partial (B*M/16, 3*c2 + c3);
// w2_partial (ceil(B*M*c3 / rows_per_chunk), c1, c2) and w3_partial (same
// chunks, c2, c3) f32. c1, c2 <= 128, c3 <= 256. Returns cudaGetLastError().
#define EDA_POOL_BWD_ARGS                                                          \
  const void *A, const void *bc, const float *g, const int *win, const int *starts, \
      const void *w2, const float *b2, const float *s2, const float *lb2,          \
      const void *w3, int B, int N, int M, int c1, int c2, int c3, int W,          \
      int rows_per_chunk, float *dA, float *dbc, float *dw2, float *dw3,           \
      float *vec_out, void *H0, void *DX, void *H1, void *D, int *counts,          \
      float *vec_partial, float *w2_partial, float *w3_partial, void *stream
#define EDA_POOL_BWD_CALL                                                          \
  A, bc, g, win, starts, w2, b2, s2, lb2, w3, B, N, M, c1, c2, c3, W, rows_per_chunk, \
      dA, dbc, dw2, dw3, vec_out, H0, DX, H1, D, counts, vec_partial, w2_partial,  \
      w3_partial, stream

int sa_pool_bwd_compact_launch(EDA_POOL_BWD_ARGS) { return launch<true>(EDA_POOL_BWD_CALL); }
int sa_pool_bwd_window_launch(EDA_POOL_BWD_ARGS) { return launch<false>(EDA_POOL_BWD_CALL); }

}  // extern "C"
