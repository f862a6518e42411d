// Set-abstraction pair-pool backward at (c1, c2, c3) = (512, 512, 1024), the
// width-4 backbone's SA2-4 (Group-Free-3D's Pointnet2Backbone(width=4)), and
// every narrower triple above (256, 256, 512), which the wrapper zero-pads to
// these widths (c2_real, the LayerNorm's divisor).
//
// Replaces, at these widths, the TPU kernel eda_tpu/ops/pallas/sa_kernel.py:
// sa_pair_pool_bwd_pallas, windowed (:399, "K6", sa_pool_bwd_512_window_launch)
// and compact (:649, "K5", sa_pool_bwd_512_compact_launch). It computes
// ops/cuda/sa_pool_bwd.py:sa_pool_bwd_plain with the rounding points of
// csrc/sa_pair_pool_bwd.cu: per pair row (a center and the point that won
// some of its channels, with the cotangents d of those channels)
//   h0 = bf16(relu(A_p + bc_c)),  x = h0 @ W2 + b2 (f32 sums),
//   xhat = (x - mean) * rstd (one-pass statistics over c2_real),
//   h1 = bf16(relu(xhat * s2 + lb2));
//   dW3 += h1^T bf16(d),  dh = bf16(d) @ W3^T,  dln = dh where h1 > 0,
//   dx = rstd * (dln s2 - mean(dln s2) - xhat * mean(dln s2 xhat)),
//   dW2 += h0^T bf16(dx),  dh0 = bf16(dx) @ W2^T where h0 > 0,
//   db_c += dh0,  dA_p += dh0 (windowed: exact f32; compact: bf16(dh0)),
// db2, ds2, dlb2 and db3 f32 sums. A windowed row is one distinct in-window
// winner of a center with a nonzero cotangent; a compact row one channel with
// a nonzero cotangent (a winner outside the window gathers a zero A row and
// adds nothing to dA). A row of zero cotangents adds zero to every output, so
// neither variant makes one.
//
// Bound on this card: operations. A row costs the three (512 x 512) products
// (x, dh0, dW2) and, per won channel, a W3^T row and a dW3 column.
//
// Design, simple first (its time in PERF.md beside its bound). At these
// widths one row's operands (W2 512 KiB and W3 1 MiB in bf16, h0, x, h1 and
// dx of 512 values) fit no CTA with a row tile's state, so the rows are
// gathered once and the step runs through device memory:
//   1. sa_pool_bwd_512_rows: a CTA a center finds its rows (the first live
//      channel of each in-window winner, by a shared-memory min over the
//      window) and counts them; one CTA turns the counts into row offsets.
//      The wrapper reads the row count (one host sync) and allocates.
//   2. a CTA a center writes its rows (center, point) and their bf16(d),
//      dense (rows x 1024), rows in the order of their first channel;
//   3. H0 rows, then X = H0 W2, the LayerNorm forward (a warp a row: xhat,
//      rstd, H1), dH = D W3^T, the LayerNorm backward (a warp a row: bf16
//      dx, each warp's column sums of dx, dln xhat and dln in a record of its
//      own), dH0 = dX W2^T: the products on the tensor cores through
//      mma_gemm.cuh (mma.sync tiles of 128 x 128);
//   4. dW3 = H1^T D and dW2 = H0^T dX, the rows split into equal ranges, each
//      range's partial product a record; db3 from g in fixed ranges of
//      centers;
//   5. a CTA a block of 16 centers adds its rows' dh0 into db_c (registers)
//      and into the block's window record (dA of its W points), row by row;
//      a second kernel adds the window records into dA in block order;
//   6. every record added in a fixed order (wgmma.cuh, reduce_records): no
//      atomics on any sum, so two launches give every output bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_gemm.cuh"
#include "wgmma.cuh"

namespace {

constexpr int C1 = 512, C2 = 512, C3 = 1024;
constexpr int kCenters = 16;       // centers a window block
constexpr int kThreads = 256;
constexpr int kLnCtas = 264;       // the LayerNorm backward's fixed grid (2 an SM)
constexpr int kLnWarps = kLnCtas * 8;
constexpr int kG3Parts = 64;       // fixed ranges of centers for db3
constexpr int kSplitRows = 2048;   // rows of a weight-gradient split, at least
constexpr int kMaxSplits = 128;
constexpr int kMaxWindow = 32768;  // the row search's window in shared memory
constexpr float kEps = 1e-5f;
constexpr int kNone = 0x7fffffff;

__host__ __device__ inline size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

int splits(long long rows) {
  const long long s = (rows + kSplitRows - 1) / kSplitRows;
  return (int)(s < 1 ? 1 : s > kMaxSplits ? kMaxSplits : s);
}

// The scratch of a call of `rows` pair rows, carved in this order.
struct Scratch {
  size_t ctr, pt, h0, h1, d, dxb, x, dh, rstd, rec2, rec3, part, part3, da, total;
  Scratch(long long rows, int blocks, int W) {
    const size_t R = (size_t)rows;
    const int S = splits(rows);
    size_t o = 0;
    ctr = o;   o += align256(R * 4);
    pt = o;    o += align256(R * 4);
    h0 = o;    o += align256(R * C1 * 2);
    h1 = o;    o += align256(R * C2 * 2);
    d = o;     o += align256(R * C3 * 2);
    dxb = o;   o += align256(R * C2 * 2);
    x = o;     o += align256(R * C2 * 4);
    dh = o;    o += align256(R * C2 * 4);
    rstd = o;  o += align256(R * 4);
    rec2 = o;  o += align256((size_t)S * C1 * C2 * 4);
    rec3 = o;  o += align256((size_t)S * C2 * C3 * 4);
    part = o;  o += align256((size_t)kLnWarps * 3 * C2 * 4);
    part3 = o; o += align256((size_t)kG3Parts * C3 * 4);
    da = o;    o += align256((size_t)blocks * W * C1 * 4);
    total = o;
  }
};

__device__ __forceinline__ int window_start(const int* starts, int blk, int N, int W) {
  return min(max(starts[blk], 0), N - W);
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The block-wide exclusive prefix of v over the threads in order, and the total.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = v;
#pragma unroll
  for (int m = 1; m < 32; m *= 2) {
    const int u = __shfl_up_sync(0xffffffffu, inc, m);
    if (lane >= m) inc += u;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before += warp_sums[w];
    total += warp_sums[w];
  }
  __syncthreads();
  return before + inc - v;
}

// The first live channel of each window point of the center (windowed), in
// first[W]: a row leads with the channel c whose point's first[] is c.
template <bool COMPACT>
__device__ __forceinline__ void find_leaders(const int* win, const float* g, int start, int W,
                                             int* first) {
  if constexpr (!COMPACT) {
    for (int i = threadIdx.x; i < W; i += kThreads) first[i] = kNone;
    __syncthreads();
    for (int c = threadIdx.x; c < C3; c += kThreads) {
      const int rel = win[c] - start;
      if (g[c] != 0.f && rel >= 0 && rel < W) atomicMin(&first[rel], c);
    }
    __syncthreads();
  }
}

template <bool COMPACT>
__device__ __forceinline__ bool leads(const int* win, const float* g, int c, int start, int W,
                                      const int* first) {
  if (g[c] == 0.f) return false;
  if constexpr (COMPACT) return true;
  const int rel = win[c] - start;
  return rel >= 0 && rel < W && first[rel] == c;
}

// 1a. each center's row count into offsets[center]
template <bool COMPACT>
__global__ void __launch_bounds__(kThreads)
count_rows(const int* __restrict__ winners, const float* __restrict__ g,
           const int* __restrict__ starts, int N, int M, int W, int* __restrict__ offsets) {
  extern __shared__ int first[];
  __shared__ int warp_sums[kThreads / 32];
  const int cid = blockIdx.x, b = cid / M, m = cid % M;
  const int start = window_start(starts, b * (M / kCenters) + m / kCenters, N, W);
  const int* win = winners + (size_t)cid * C3;
  const float* gc = g + (size_t)cid * C3;
  find_leaders<COMPACT>(win, gc, start, W, first);
  int n = 0;
  for (int c = threadIdx.x; c < C3; c += kThreads)
    n += leads<COMPACT>(win, gc, c, start, W, first);
  int total;
  block_scan(n, warp_sums, total);
  if (threadIdx.x == 0) offsets[cid] = total;
}

// 1b. counts (offsets[0 .. n)) into exclusive offsets, offsets[n] the total
__global__ void __launch_bounds__(1024) scan_offsets(int* __restrict__ offsets, int n) {
  __shared__ int sums[1024];
  const int t = threadIdx.x;
  const int per = (n + 1023) / 1024;
  const int i0 = min(n, t * per), i1 = min(n, i0 + per);
  int s = 0;
  for (int i = i0; i < i1; ++i) s += offsets[i];
  sums[t] = s;
  __syncthreads();
  for (int d = 1; d < 1024; d *= 2) {
    const int v = t >= d ? sums[t - d] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int run = sums[t] - s;
  for (int i = i0; i < i1; ++i) {
    const int c = offsets[i];
    offsets[i] = run;
    run += c;
  }
  if (t == 1023) offsets[n] = sums[1023];
}

// 2. each center's rows: (center, point or -1) and bf16(d) into D (zeroed)
template <bool COMPACT>
__global__ void __launch_bounds__(kThreads)
fill_rows(const int* __restrict__ winners, const float* __restrict__ g,
          const int* __restrict__ starts, int N, int M, int W, const int* __restrict__ offsets,
          int* __restrict__ ctr, int* __restrict__ pt, uint16_t* __restrict__ D) {
  extern __shared__ int first[];  // [W], then rowid[C3]
  __shared__ int warp_sums[kThreads / 32];
  int* rowid = first + (COMPACT ? 0 : W);
  const int cid = blockIdx.x, b = cid / M, m = cid % M;
  const int start = window_start(starts, b * (M / kCenters) + m / kCenters, N, W);
  const int* win = winners + (size_t)cid * C3;
  const float* gc = g + (size_t)cid * C3;
  find_leaders<COMPACT>(win, gc, start, W, first);
  constexpr int kPer = C3 / kThreads;  // channels a thread, contiguous, in order
  bool lead[kPer];
  int n = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    lead[i] = leads<COMPACT>(win, gc, kPer * threadIdx.x + i, start, W, first);
    n += lead[i];
  }
  int total;
  int rank = block_scan(n, warp_sums, total);
  const int off = offsets[cid];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = kPer * threadIdx.x + i;
    if (!lead[i]) continue;
    const int rel = win[c] - start;
    rowid[c] = rank;
    ctr[off + rank] = cid;
    pt[off + rank] = rel >= 0 && rel < W ? start + rel : -1;
    ++rank;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C3; c += kThreads) {
    const float v = gc[c];
    if (v == 0.f) continue;
    int leader = c;
    if constexpr (!COMPACT) {
      const int rel = win[c] - start;
      if (rel < 0 || rel >= W) continue;
      leader = first[rel];
    }
    D[(size_t)(off + rowid[leader]) * C3 + c] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
}

// 3a. H0 rows: bf16(relu(A_p + bc_c)), a zero A row where the point is -1
__global__ void h0_rows(const uint16_t* __restrict__ A, const uint16_t* __restrict__ bc,
                        const int* __restrict__ ctr, const int* __restrict__ pt, long long rows,
                        int N, int M, uint16_t* __restrict__ H0) {
  const long long n = rows * (C1 / 8);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (C1 / 8);
    const int q = (int)(i % (C1 / 8));
    const int c = ctr[r], p = pt[r], b = c / M;
    const uint4 cb = *reinterpret_cast<const uint4*>(bc + (size_t)c * C1 + 8 * q);
    const uint4 a = p >= 0 ? *reinterpret_cast<const uint4*>(A + ((size_t)b * N + p) * C1 + 8 * q)
                           : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(H0 + r * C1 + 8 * q) =
        make_uint4(wg::add_relu_bf16x2(a.x, cb.x), wg::add_relu_bf16x2(a.y, cb.y),
                   wg::add_relu_bf16x2(a.z, cb.z), wg::add_relu_bf16x2(a.w, cb.w));
  }
}

// lane l of a warp holds a row's columns 4 l + 128 q + e (q, e < 4)
__device__ __forceinline__ int col_of(int lane, int i) { return 4 * lane + 128 * (i / 4) + i % 4; }

// 3b. the LayerNorm forward of a row a warp: X -> xhat in place, rstd, H1
__global__ void __launch_bounds__(256)
ln_forward(float* __restrict__ X, long long rows, const float* __restrict__ b2,
           const float* __restrict__ s2, const float* __restrict__ lb2, float c2,
           float* __restrict__ rstd_out, uint16_t* __restrict__ H1) {
  const int lane = threadIdx.x % 32;
  const long long r = blockIdx.x * 8ll + threadIdx.x / 32;
  if (r >= rows) return;
  float* xr = X + r * C2;
  float x[16];
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(xr + 4 * lane + 128 * q);
    const float4 bb = *reinterpret_cast<const float4*>(b2 + 4 * lane + 128 * q);
    x[4 * q] = v.x + bb.x;
    x[4 * q + 1] = v.y + bb.y;
    x[4 * q + 2] = v.z + bb.z;
    x[4 * q + 3] = v.w + bb.w;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    s += x[i];
    sq += x[i] * x[i];
  }
#pragma unroll
  for (int m = 16; m >= 1; m /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, m);
    sq += __shfl_xor_sync(0xffffffffu, sq, m);
  }
  const float mean = s / c2;
  const float var = fmaxf(sq / c2 - mean * mean, 0.f);
  const float rstd = rsqrtf(var + kEps);
  if (lane == 0) rstd_out[r] = rstd;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float xh[4], y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * lane + 128 * q + e;
      xh[e] = (x[4 * q + e] - mean) * rstd;
      y[e] = fmaxf(xh[e] * s2[j] + lb2[j], 0.f);
    }
    *reinterpret_cast<float4*>(xr + 4 * lane + 128 * q) = make_float4(xh[0], xh[1], xh[2], xh[3]);
    *reinterpret_cast<uint2*>(H1 + r * C2 + 4 * lane + 128 * q) =
        make_uint2(wg::pack_bf16x2(y[0], y[1]), wg::pack_bf16x2(y[2], y[3]));
  }
}

__device__ __forceinline__ bool positive(uint16_t h) { return h != 0 && !(h & 0x8000); }

// 3c. the LayerNorm backward of a row a warp (rows w, w + kLnWarps, ...):
// bf16(dx) into dxb, the warp's column sums of dx, dln xhat and dln in its record
__global__ void __launch_bounds__(256)
ln_backward(const float* __restrict__ dH, const float* __restrict__ X,
            const uint16_t* __restrict__ H1, const float* __restrict__ rstd_in, long long rows,
            const float* __restrict__ s2, float c2, uint16_t* __restrict__ dxb,
            float* __restrict__ part) {
  const int lane = threadIdx.x % 32;
  const int wid = blockIdx.x * 8 + threadIdx.x / 32;
  float sc[16], s_dx[16], s_lx[16], s_l[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    sc[i] = s2[col_of(lane, i)];
    s_dx[i] = s_lx[i] = s_l[i] = 0.f;
  }
  for (long long r = wid; r < rows; r += kLnWarps) {
    float dln[16], xh[16];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 d = *reinterpret_cast<const float4*>(dH + r * C2 + 4 * lane + 128 * q);
      const float4 v = *reinterpret_cast<const float4*>(X + r * C2 + 4 * lane + 128 * q);
      const uint2 h = *reinterpret_cast<const uint2*>(H1 + r * C2 + 4 * lane + 128 * q);
      const float dd[4] = {d.x, d.y, d.z, d.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
      const uint16_t hh[4] = {(uint16_t)(h.x & 0xffff), (uint16_t)(h.x >> 16),
                              (uint16_t)(h.y & 0xffff), (uint16_t)(h.y >> 16)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dln[4 * q + e] = positive(hh[e]) ? dd[e] : 0.f;
        xh[4 * q + e] = vv[e];
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float dxh = dln[i] * sc[i];
      m1 += dxh;
      m2 += dxh * xh[i];
    }
#pragma unroll
    for (int m = 16; m >= 1; m /= 2) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, m);
      m2 += __shfl_xor_sync(0xffffffffu, m2, m);
    }
    m1 = m1 / c2;
    m2 = m2 / c2;
    const float rstd = rstd_in[r];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float dx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * q + e;
        dx[e] = rstd * (dln[i] * sc[i] - m1 - xh[i] * m2);
        s_dx[i] += dx[e];
        s_lx[i] += dln[i] * xh[i];
        s_l[i] += dln[i];
      }
      *reinterpret_cast<uint2*>(dxb + r * C2 + 4 * lane + 128 * q) =
          make_uint2(wg::pack_bf16x2(dx[0], dx[1]), wg::pack_bf16x2(dx[2], dx[3]));
    }
  }
  float* rec = part + (size_t)wid * 3 * C2;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = col_of(lane, i);
    rec[j] = s_dx[i];
    rec[C2 + j] = s_lx[i];
    rec[2 * C2 + j] = s_l[i];
  }
}

// 4. db3's partial sums over kG3Parts fixed ranges of centers: g where the
// channel's winner lies in the window (windowed), every g (compact)
template <bool COMPACT>
__global__ void db3_parts(const float* __restrict__ g, const int* __restrict__ winners,
                          const int* __restrict__ starts, int B, int N, int M, int W,
                          float* __restrict__ part3) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = B * M, k = blockIdx.y;
  const int i0 = (int)((long long)n * k / kG3Parts), i1 = (int)((long long)n * (k + 1) / kG3Parts);
  float s = 0.f;
  for (int i = i0; i < i1; ++i) {
    const float v = g[(size_t)i * C3 + c];
    if constexpr (COMPACT) {
      s += v;
    } else {
      const int b = i / M, m = i % M;
      const int rel = winners[(size_t)i * C3 + c] -
                      window_start(starts, b * (M / kCenters) + m / kCenters, N, W);
      if (rel >= 0 && rel < W) s += v;
    }
  }
  part3[(size_t)k * C3 + c] = s;
}

// 5a. a CTA a block of 16 centers, a thread 4 columns: each row's dh0 (dH0
// where h0 > 0) into db_c and into the block's window record (zeroed), in row
// order; compact rows add bf16(dh0)
template <bool COMPACT>
__global__ void __launch_bounds__(128)
scatter_rows(const float* __restrict__ dH0, const uint16_t* __restrict__ H0,
             const int* __restrict__ pt, const int* __restrict__ offsets,
             const int* __restrict__ starts, int N, int M, int W, float* __restrict__ dbc,
             float* __restrict__ da) {
  const int blk = blockIdx.x, nb = M / kCenters;
  const int b = blk / nb, j = blk % nb;
  const int start = window_start(starts, blk, N, W);
  const int q = 4 * threadIdx.x;
  float* rec = da + (size_t)blk * W * C1;
  for (int m = 0; m < kCenters; ++m) {
    const int cid = b * M + j * kCenters + m;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = offsets[cid]; r < offsets[cid + 1]; ++r) {
      float4 v = *reinterpret_cast<const float4*>(dH0 + (size_t)r * C1 + q);
      const uint2 h = *reinterpret_cast<const uint2*>(H0 + (size_t)r * C1 + q);
      v.x = positive(h.x & 0xffff) ? v.x : 0.f;
      v.y = positive(h.x >> 16) ? v.y : 0.f;
      v.z = positive(h.y & 0xffff) ? v.z : 0.f;
      v.w = positive(h.y >> 16) ? v.w : 0.f;
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
      const int p = pt[r];
      if (p < 0) continue;
      if constexpr (COMPACT) v = make_float4(bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w));
      float4* to = reinterpret_cast<float4*>(rec + (size_t)(p - start) * C1 + q);
      float4 o = *to;
      o.x += v.x;
      o.y += v.y;
      o.z += v.z;
      o.w += v.w;
      *to = o;
    }
    *reinterpret_cast<float4*>(dbc + (size_t)cid * C1 + q) = acc;
  }
}

// 5b. dA: the window records that cover each point, added in block order
__global__ void gather_da(const float* __restrict__ da, const int* __restrict__ starts, int B,
                          int N, int M, int W, float* __restrict__ dA) {
  const int nb = M / kCenters;
  const long long n = (long long)B * N * (C1 / 4);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int q = 4 * (int)(i % (C1 / 4));
    const long long row = i / (C1 / 4);
    const int b = (int)(row / N), p = (int)(row % N);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < nb; ++j) {
      const int blk = b * nb + j;
      const int s = window_start(starts, blk, N, W);
      if (p < s || p >= s + W) continue;
      const float4 v = *reinterpret_cast<const float4*>(da + ((size_t)blk * W + p - s) * C1 + q);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>(dA + row * C1 + q) = acc;
  }
}

int grid_of(long long n, int threads) {
  const long long b = (n + threads - 1) / threads;
  return (int)(b < 1 ? 1 : b > 8192 ? 8192 : b);
}

size_t search_smem(bool compact, int W, bool fill) {
  return (compact ? 0 : (size_t)W * 4) + (fill ? (size_t)C3 * 4 : 0);
}

template <bool COMPACT>
cudaError_t set_smem(int W) {
  cudaError_t err = cudaFuncSetAttribute(count_rows<COMPACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)search_smem(COMPACT, W, false));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fill_rows<COMPACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)search_smem(COMPACT, W, true));
}

bool bad_shape(int B, int N, int M, int W) {
  return B < 0 || M < 0 || M % kCenters || W <= 0 || W > N || W > kMaxWindow;
}

template <bool COMPACT>
int rows_launch(const int* winners, const float* g, const int* starts, int B, int N, int M, int W,
                int* offsets, cudaStream_t s) {
  if (bad_shape(B, N, M, W)) return cudaErrorInvalidValue;
  const int n = B * M;
  if (n == 0) return (int)cudaMemsetAsync(offsets, 0, 4, s);
  cudaError_t err = set_smem<COMPACT>(W);
  if (err != cudaSuccess) return err;
  count_rows<COMPACT><<<n, kThreads, search_smem(COMPACT, W, false), s>>>(winners, g, starts, N,
                                                                         M, W, offsets);
  scan_offsets<<<1, 1024, 0, s>>>(offsets, n);
  return (int)cudaGetLastError();
}

template <bool COMPACT>
int launch(const void* A_, const void* bc_, const float* g, const int* winners, const int* starts,
           const void* w2_, const float* b2, const float* s2, const float* lb2, const void* w3_,
           int B, int N, int M, int c2_real, int W, const int* offsets, long long rows,
           float* dA, float* dbc, float* out, void* scratch, cudaStream_t s) {
  if (bad_shape(B, N, M, W) || c2_real < 1 || c2_real > C2 || rows < 0 || rows > (1ll << 30))
    return cudaErrorInvalidValue;
  const auto* A = static_cast<const uint16_t*>(A_);
  const auto* bc = static_cast<const uint16_t*>(bc_);
  const auto* w2 = static_cast<const uint16_t*>(w2_);
  const auto* w3 = static_cast<const uint16_t*>(w3_);
  if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(bc) |
       reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(w3)) & 15 ||
      reinterpret_cast<uintptr_t>(scratch) & 255)
    return cudaErrorInvalidValue;
  const int nb = M / kCenters, blocks = B * nb;
  const Scratch sc(rows, blocks, W);
  auto* base = static_cast<unsigned char*>(scratch);
  int* ctr = reinterpret_cast<int*>(base + sc.ctr);
  int* pt = reinterpret_cast<int*>(base + sc.pt);
  uint16_t* H0 = reinterpret_cast<uint16_t*>(base + sc.h0);
  uint16_t* H1 = reinterpret_cast<uint16_t*>(base + sc.h1);
  uint16_t* D = reinterpret_cast<uint16_t*>(base + sc.d);
  uint16_t* dxb = reinterpret_cast<uint16_t*>(base + sc.dxb);
  float* X = reinterpret_cast<float*>(base + sc.x);
  float* dH = reinterpret_cast<float*>(base + sc.dh);
  float* rstd = reinterpret_cast<float*>(base + sc.rstd);
  float* rec2 = reinterpret_cast<float*>(base + sc.rec2);
  float* rec3 = reinterpret_cast<float*>(base + sc.rec3);
  float* part = reinterpret_cast<float*>(base + sc.part);
  float* part3 = reinterpret_cast<float*>(base + sc.part3);
  float* da = reinterpret_cast<float*>(base + sc.da);
  const int R = (int)rows, S = splits(rows);
  const float c2 = (float)c2_real;
  float* dw3 = out + C1 * C2;
  float* vec = dw3 + C2 * C3;

  cudaError_t err = set_smem<COMPACT>(W);
  if (err != cudaSuccess) return err;
  if (R > 0) {
    err = cudaMemsetAsync(D, 0, (size_t)R * C3 * 2, s);
    if (err != cudaSuccess) return err;
    fill_rows<COMPACT><<<B * M, kThreads, search_smem(COMPACT, W, true), s>>>(
        winners, g, starts, N, M, W, offsets, ctr, pt, D);
    h0_rows<<<grid_of((long long)R * (C1 / 8), 256), 256, 0, s>>>(A, bc, ctr, pt, rows, N, M, H0);
    err = mg::gemm<uint16_t, true, false>(H0, C1, w2, C2, X, C2, R, C2, C1, 1, s);
    if (err != cudaSuccess) return err;
    ln_forward<<<(R + 7) / 8, 256, 0, s>>>(X, rows, b2, s2, lb2, c2, rstd, H1);
    // dH = bf16(d) W3^T: W3 (C2, C3) is the K-contiguous B of (k = C3, n = C2)
    err = mg::gemm<uint16_t, true, true>(D, C3, w3, C3, dH, C2, R, C2, C3, 1, s);
    if (err != cudaSuccess) return err;
  }
  ln_backward<<<kLnCtas, 256, 0, s>>>(dH, X, H1, rstd, rows, s2, c2, dxb, part);
  if (R > 0) {
    // dH0 = bf16(dx) W2^T into dH's buffer
    err = mg::gemm<uint16_t, true, true>(dxb, C2, w2, C2, dH, C1, R, C1, C2, 1, s);
    if (err != cudaSuccess) return err;
  }
  // the weight gradients' partial products, a record a split of the rows
  err = mg::gemm<uint16_t, false, false>(H1, C2, D, C3, rec3, C3, C2, C3, R, S, s);
  if (err != cudaSuccess) return err;
  err = mg::gemm<uint16_t, false, false>(H0, C1, dxb, C2, rec2, C2, C1, C2, R, S, s);
  if (err != cudaSuccess) return err;
  db3_parts<COMPACT><<<dim3(C3 / 256, kG3Parts), 256, 0, s>>>(g, winners, starts, B, N, M, W,
                                                               part3);
  wg::reduce_records<8><<<(C1 * C2 + 31) / 32, 256, 0, s>>>(rec2, S, C1 * C2, out);
  wg::reduce_records<8><<<(C2 * C3 + 31) / 32, 256, 0, s>>>(rec3, S, C2 * C3, dw3);
  wg::reduce_records<8><<<(3 * C2 + 31) / 32, 256, 0, s>>>(part, kLnWarps, 3 * C2, vec);
  wg::reduce_records<8><<<(C3 + 31) / 32, 256, 0, s>>>(part3, kG3Parts, C3, vec + 3 * C2);
  // dA and db_c
  if (blocks > 0) {
    err = cudaMemsetAsync(da, 0, (size_t)blocks * W * C1 * 4, s);
    if (err != cudaSuccess) return err;
    scatter_rows<COMPACT><<<blocks, 128, 0, s>>>(dH, H0, pt, offsets, starts, N, M, W, dbc, da);
  }
  if ((long long)B * N > 0)
    gather_da<<<grid_of((long long)B * N * (C1 / 4), 256), 256, 0, s>>>(da, starts, B, N, M, W,
                                                                        dA);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The row search's widest window (the window points' first channels in shared memory).
int sa_pool_bwd_512_max_window() { return kMaxWindow; }

// Bytes of scratch a call of `rows` pair rows takes (blocks = B * M / 16).
long long sa_pool_bwd_512_scratch_bytes(long long rows, int blocks, int W) {
  return (long long)Scratch(rows, blocks, W).total;
}

// The pair rows of each center: offsets (B * M + 1) int32, exclusive, the
// last the number of rows. winners, g: (B, M, 1024) int32 / f32; starts (B,
// M / 16) int32. compact: the compact rows (every nonzero cotangent), else the
// windowed ones (every distinct in-window winner with a nonzero cotangent).
int sa_pool_bwd_512_rows(const int* winners, const float* g, const int* starts, int B, int N,
                         int M, int W, int compact, int* offsets, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return compact ? rows_launch<true>(winners, g, starts, B, N, M, W, offsets, s)
                 : rows_launch<false>(winners, g, starts, B, N, M, W, offsets, s);
}

// A: (B, N, 512) bf16; bc: (B, M, 512) bf16; g: (B, M, 1024) f32; winners:
// (B, M, 1024) int32; starts: (B, M/16) int32; w2: (512, 512), w3: (512, 1024)
// bf16; b2, s2, lb2: (512,) f32; a narrower layer zero-padded, c2_real its
// interior width. offsets and rows from sa_pool_bwd_512_rows (the same
// variant); scratch: sa_pool_bwd_512_scratch_bytes(rows, B * M / 16, W),
// 256-byte aligned. Outputs: dA (B, N, 512), dbc (B, M, 512) and out = [dW2;
// dW3; db2; ds2; dlb2; db3], f32. Returns cudaGetLastError().
int sa_pool_bwd_512_window_launch(const void* A, const void* bc, const float* g,
                                  const int* winners, const int* starts, const void* w2,
                                  const float* b2, const float* s2, const float* lb2,
                                  const void* w3, int B, int N, int M, int c2_real, int W,
                                  const int* offsets, long long rows, float* dA, float* dbc,
                                  float* out, void* scratch, void* stream) {
  return launch<false>(A, bc, g, winners, starts, w2, b2, s2, lb2, w3, B, N, M, c2_real, W,
                       offsets, rows, dA, dbc, out, scratch, static_cast<cudaStream_t>(stream));
}

// As sa_pool_bwd_512_window_launch, the compact variant.
int sa_pool_bwd_512_compact_launch(const void* A, const void* bc, const float* g,
                                   const int* winners, const int* starts, const void* w2,
                                   const float* b2, const float* s2, const float* lb2,
                                   const void* w3, int B, int N, int M, int c2_real, int W,
                                   const int* offsets, long long rows, float* dA, float* dbc,
                                   float* out, void* scratch, void* stream) {
  return launch<true>(A, bc, g, winners, starts, w2, b2, s2, lb2, w3, B, N, M, c2_real, W,
                      offsets, rows, dA, dbc, out, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
