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
// One CTA per (batch row, block): the 16 centers' terms sit in
// shared memory, each thread takes window rows in turn and stores its 16
// mask bytes as one 16-byte write; neighbouring threads write neighbouring
// rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCenters = 16;

__global__ void __launch_bounds__(kThreads)
sa_mask_kernel(const float* __restrict__ xyz, const float* __restrict__ cen,
               const int* __restrict__ starts, int N, int M, int W, float r2,
               uint8_t* __restrict__ mask) {
  __shared__ float m2c[kCenters][3];  // -2 c'
  __shared__ float csq[kCenters];
  __shared__ float origin[3];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int n_blocks = M / kCenters;
  const size_t cell = (size_t)b * n_blocks + blockIdx.x;
  const float* cb = cen + ((size_t)b * M + (size_t)blockIdx.x * kCenters) * 3;
  if (tid < kCenters) {
    const float cx = cb[tid * 3] - cb[0];
    const float cy = cb[tid * 3 + 1] - cb[1];
    const float cz = cb[tid * 3 + 2] - cb[2];
    m2c[tid][0] = -2.f * cx;
    m2c[tid][1] = -2.f * cy;
    m2c[tid][2] = -2.f * cz;
    csq[tid] = cx * cx + cy * cy + cz * cz;
  }
  if (tid < 3) origin[tid] = cb[tid];
  int start = starts[cell];
  start = min(max(start, 0), N - W);
  __syncthreads();

  const float* x_win = xyz + ((size_t)b * N + start) * 3;
  uint4* out = reinterpret_cast<uint4*>(mask + cell * W * kCenters);
  for (int w = tid; w < W; w += kThreads) {
    const float px = x_win[(size_t)w * 3] - origin[0];
    const float py = x_win[(size_t)w * 3 + 1] - origin[1];
    const float pz = x_win[(size_t)w * 3 + 2] - origin[2];
    const float psq = px * px + py * py + pz * pz;
    uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < kCenters; ++c) {
      const float d2t = px * m2c[c][0] + py * m2c[c][1] + pz * m2c[c][2] + psq + csq[c];
      if (d2t <= r2) word[c / 4] |= 1u << (8 * (c % 4));
    }
    out[w] = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

}  // namespace

extern "C" {

// xyz: (B, N, 3) f32 rank-sorted points; cen: (B, M, 3) f32 centers in rank
// order, M a multiple of 16; starts: (B, M/16) int32 window starts (multiples
// of 16, clamped to [0, N-W]); mask: (B, M/16, W, 16) uint8, 1 where the
// window's point w lies within the radius of the block's center c. Returns
// cudaGetLastError().
int sa_radius_mask_launch(const float* xyz, const float* cen, const int* starts, int B,
                          int N, int M, int W, float r2, uint8_t* mask, void* stream) {
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (M % kCenters || W <= 0 || W > N) return cudaErrorInvalidValue;
  dim3 grid(M / kCenters, B);
  sa_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, cen, starts, N, M, W, r2, mask);
  return cudaGetLastError();
}

}  // extern "C"
