// In-radius mask of the fused SA pair pool's "pre" radius test, on Hopper.
//
// Replaces the TPU kernel eda_tpu/ops/pallas/sa_mask.py:sa_radius_mask (body
// _make_mask_kernel, "K9a"). For every block of 16 rank-sorted centers and
// every point of its window (W points from the block's window start, a
// multiple of 16 inside [0, N-W]) it writes one byte per center:
//   o    = the block's first center,  p' = p - o,  c' = c - o
//   psq  = |p'|^2,  csq = |c'|^2                     (sums x, y, z)
//   d2t  = p'x(-2c'x) + p'y(-2c'y) + p'z(-2c'z) + psq + csq
//   mask = d2t <= r^2
// all in f32, in that order, never contracted into an FMA (the build passes
// --fmad=false). The pair pool's "pre" variant (csrc/sa_pair_pool.cu) reads
// the mask in place of coordinates.
//
// The layout is the port's own: (B, M/16, W, 16) bytes, row w the window's
// point w, so the pool reads 128 contiguous bytes per 8-point tile. The TPU
// kernel's 128-aligned start, its W+112-row blocks, the offsets and the far
// fill of padding lanes (sa_mask.py:30-34, 55-58, 148-159) exist only for
// Mosaic's lane alignment and are not reproduced.
//
// Bound on this card: bytes. Per (window row, center) it does 10 f32
// operations and writes one byte, and it needs the cloud's xyz once, so at
// SA1 of a batch of 8 (50 000 points, W = 1024, 128 blocks of 16 per scene)
// it must move ~22 MB (16.8 MB of mask, 4.8 MB of xyz) against ~170 MFLOP.
// Overlapping windows read a point's 12 bytes again, mostly from L2.
//
// Design: a CTA of 8 warps takes 256 R consecutive rows of one block's window
// (R = 4 from W = 1024 up: SA1 is one CTA a block, one wave of 1024 CTAs; R
// = 1 below: SA2-4 are one short wave, a CTA a block). Its chain to memory is
// as short as the layout allows: the window start and the 16 centers are
// loaded together, then each warp issues every load of its 32 R rows' points
// (contiguous: 12 R 16-byte loads a warp, 3 a lane at R = 4) before any test,
// while 16 threads turn the centers into shared terms; one barrier, then each
// lane tests its rows (from the warp's copy in shared memory, a stride of 3
// words: no bank conflict) and writes each row's 16 bytes as one store,
// neighbouring lanes on neighbouring rows. A window whose points are not
// 16-byte aligned in memory, and a warp's rows past W, load word by word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCenters = 16;

template <int R>  // rows a thread
__global__ void __launch_bounds__(kThreads)
sa_mask_kernel(const float* __restrict__ xyz, const float* __restrict__ cen,
               const int* __restrict__ starts, int N, int M, int W, float r2, bool aligned,
               uint8_t* __restrict__ mask) {
  constexpr int kWarpRows = 32 * R;
  constexpr int kWarpVec = kWarpRows * 3 / 4;  // 16-byte loads of a warp's points
  constexpr int kLaneVec = (kWarpVec + 31) / 32;
  __shared__ float m2c[kCenters][3];  // -2 c'
  __shared__ float csq[kCenters];
  __shared__ float origin[3];
  __shared__ __align__(16) float pts[kWarps][kWarpRows * 3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int n_blocks = M / kCenters;
  const size_t cell = (size_t)b * n_blocks + blockIdx.y;
  const float* cb = cen + ((size_t)b * M + (size_t)blockIdx.y * kCenters) * 3;
  float c[3], o[3];
  if (tid < kCenters) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      c[e] = cb[tid * 3 + e];
      o[e] = cb[e];
    }
  }
  // the window start floored to 16 (two's complement: & ~15 floors), in [0, N-W]
  const int start = min(max(starts[cell] & ~15, 0), N - W);

  // the warp's rows [w0, w0 + rows) of the window, copied to its buffer
  const int w0 = (blockIdx.x * kWarps + warp) * kWarpRows;
  const int rows = min(kWarpRows, W - w0);
  float* buf = pts[warp];
  if (rows > 0) {
    const float* src = xyz + ((size_t)b * N + start + w0) * 3;
    if (rows == kWarpRows && aligned && (((size_t)b * N + start) & 3) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4 v[kLaneVec];
#pragma unroll
      for (int i = 0; i < kLaneVec; ++i)
        if (lane + 32 * i < kWarpVec) v[i] = __ldg(src4 + lane + 32 * i);
#pragma unroll
      for (int i = 0; i < kLaneVec; ++i)
        if (lane + 32 * i < kWarpVec) reinterpret_cast<float4*>(buf)[lane + 32 * i] = v[i];
    } else {
      for (int i = lane; i < rows * 3; i += 32) buf[i] = __ldg(src + i);
    }
  }
  if (tid < kCenters) {
    const float cx = c[0] - o[0], cy = c[1] - o[1], cz = c[2] - o[2];
    m2c[tid][0] = -2.f * cx;
    m2c[tid][1] = -2.f * cy;
    m2c[tid][2] = -2.f * cz;
    csq[tid] = cx * cx + cy * cy + cz * cz;
    if (tid == 0) {
      origin[0] = o[0];
      origin[1] = o[1];
      origin[2] = o[2];
    }
  }
  __syncthreads();

  uint4* out = reinterpret_cast<uint4*>(mask + (cell * W + w0) * kCenters);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int w = lane + 32 * i;
    if (w >= rows) break;
    const float px = buf[3 * w] - origin[0];
    const float py = buf[3 * w + 1] - origin[1];
    const float pz = buf[3 * w + 2] - origin[2];
    const float psq = px * px + py * py + pz * pz;
    uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < kCenters; ++k) {
      const float d2t = px * m2c[k][0] + py * m2c[k][1] + pz * m2c[k][2] + psq + csq[k];
      if (d2t <= r2) word[k / 4] |= 1u << (8 * (k % 4));
    }
    out[w] = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

template <int R>
cudaError_t launch(const float* xyz, const float* cen, const int* starts, int B, int N, int M,
                   int W, float r2, uint8_t* mask, cudaStream_t s) {
  dim3 grid((W + kThreads * R - 1) / (kThreads * R), M / kCenters, B);
  const bool aligned = !(reinterpret_cast<uintptr_t>(xyz) & 15);
  sa_mask_kernel<R><<<grid, kThreads, 0, s>>>(xyz, cen, starts, N, M, W, r2, aligned, mask);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz: (B, N, 3) f32 rank-sorted points; cen: (B, M, 3) f32 centers in rank
// order, M a multiple of 16; starts: (B, M/16) int32 window starts, floored to
// a multiple of 16 and clamped to [0, N-W] here; mask: (B, M/16, W, 16) uint8, 1 where the
// window's point w lies within the radius of the block's center c. Returns
// cudaGetLastError().
int sa_radius_mask_launch(const float* xyz, const float* cen, const int* starts, int B,
                          int N, int M, int W, float r2, uint8_t* mask, void* stream) {
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (M % kCenters || W <= 0 || W > N || B > 65535 || M / kCenters > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return W >= 1024 ? launch<4>(xyz, cen, starts, B, N, M, W, r2, mask, s)
                   : launch<1>(xyz, cen, starts, B, N, M, W, r2, mask, s);
}

}  // extern "C"
