// Fused set-abstraction pair pool forward on Hopper.
//
// Replaces the TPU kernel eda_tpu/ops/pallas/sa_kernel.py:sa_pair_pool_pallas
// (body _make_kernel) under each radius test (d2_mode), without winner export
// (serving) and with it (training):
//   "pair"  sa_pair_pool_launch ("K3"), sa_pair_pool_winners_launch ("K4")
//   "mxu"   sa_pair_pool_mxu_launch, sa_pair_pool_mxu_winners_launch ("K8")
//   "pre"   sa_pair_pool_pre_launch, sa_pair_pool_pre_winners_launch ("K9b")
//
// One CTA per (batch row, block of 16 rank-sorted centers). The block pairs
// with the W points of its window, which starts at a multiple of 16. For every
// (center c, point p) pair:
//   h0 = bf16(relu(f32(A_p) + f32(bc_c)))
//   h1 = bf16(relu(LN(h0 @ W2 + b2)))        f32 sums of bf16 products,
//                                            one-pass LN stats, eps 1e-5
//   z  = h1 @ W3 + b3                        f32 pre-activation
// and the output is max over in-radius pairs of z, -1e9 where a center has no
// point of its window in range. The radius test (f32, never contracted into an
// FMA: the build passes --fmad=false) is the template parameter D2:
//   kPair  |p-c|^2 <= r^2, the squares summed x, y, z;
//   kMxu   the TPU's expansion about the block's first center o
//          (sa_kernel.py:251-255, 279-289): p' = p-o, c' = c-o,
//          psq = |p'|^2, csq = |c'|^2 (sums x, y, z),
//          pc = (-2p'x)c'x + (-2p'y)c'y + (-2p'z)c'z + csq, in iff pc <= r^2 - psq;
//   kPre   reads the (W, 16) byte mask of csrc/sa_mask.cu for its block and
//          loads no coordinates at all (no xyz window, no centers), which is
//          the point of the TPU's "pre" mode: no xyz window DMA.
// Only the radius test differs; the pair MLP, the max and the winners do not.
//
// Bound on this card: operations. A pair costs 2*(c1*c2 + c2*c3) flops
// (SA1: 24.6 K, SA2-4: 98.3 K); a 50 000-point scene's four layers need
// 96.6 GFLOP against 989 TFLOP/s of bf16 tensor cores, while the bytes are
// only A's window reads and the (M, c3) output. This first version runs the
// two pair matmuls on CUDA cores in f32 (67 TFLOP/s peak), so it cannot come
// near that bound; its design keeps every pair tensor on chip so that the
// only device traffic is the A/xyz windows and the output: W2 and W3 sit in
// shared memory for the CTA's lifetime (SA2-4: 96 KB), each 8-point tile of
// the window goes through h0 -> h1 in shared memory, and the running max of
// each (center, channel) stays in a register of the thread that owns it.
//
// Thread layout (256 threads): thread t owns center c = t / 16 and channel
// group g = t % 16. The 16 threads of a center form a half-warp, so the
// LayerNorm sums over a pair's channels reduce with four shuffles.
//
// Winner export (WIN): next to each running max the thread keeps the window
// position of its point, with the TPU kernel's tie rule
// (sa_kernel.py:357-382): the window runs in tiles of wc = min(128, W) rows;
// inside a tile the LAST of equal maxima wins, across tiles a strictly larger
// value is needed, so the earlier tile keeps a tie. Points arrive in window
// order, so: take a point if its value is larger, or equal and in the same
// tile as the current winner. A center with no in-radius point exports global
// rank 0. The output is the winner's global rank, window start + position.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCenters = 16;  // centers per CTA (the window block)
constexpr int kGroups = 16;   // channel groups per center
constexpr int kTile = 8;      // window points per tile
constexpr float kEps = 1e-5f;
constexpr float kNeg = -1e9f;
constexpr int kMaxSharedBytes = 232448;

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bits_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bits_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Load n (1, 2, 4 or 8) consecutive bf16 values as floats.
template <int n>
__device__ __forceinline__ void load_bf16(const uint16_t* p, float* out) {
  if constexpr (n == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    out[0] = bits_lo(v.x); out[1] = bits_hi(v.x);
    out[2] = bits_lo(v.y); out[3] = bits_hi(v.y);
    out[4] = bits_lo(v.z); out[5] = bits_hi(v.z);
    out[6] = bits_lo(v.w); out[7] = bits_hi(v.w);
  } else if constexpr (n == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = bits_lo(v.x); out[1] = bits_hi(v.x);
    out[2] = bits_lo(v.y); out[3] = bits_hi(v.y);
  } else if constexpr (n == 2) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    out[0] = bits_lo(v); out[1] = bits_hi(v);
  } else {
    out[0] = __uint_as_float(uint32_t(*p) << 16);
  }
}

__device__ __forceinline__ void store_tile(uint16_t* dst, const float* v) {
  uint4 u;
  u.x = uint32_t(bf16_bits(v[0])) | (uint32_t(bf16_bits(v[1])) << 16);
  u.y = uint32_t(bf16_bits(v[2])) | (uint32_t(bf16_bits(v[3])) << 16);
  u.z = uint32_t(bf16_bits(v[4])) | (uint32_t(bf16_bits(v[5])) << 16);
  u.w = uint32_t(bf16_bits(v[6])) | (uint32_t(bf16_bits(v[7])) << 16);
  *reinterpret_cast<uint4*>(dst) = u;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared memory carve-up, in bytes, shared by the kernel and the launcher.
struct Layout {
  size_t w2, w3, bct, h0, h1, at, xt, mt, prm, total;
  __host__ __device__ Layout(int c1, int c2, int c3) {
    size_t o = 0;
    w2 = o;  o += align16((size_t)c1 * c2 * 2);
    w3 = o;  o += align16((size_t)c2 * c3 * 2);
    bct = o; o += align16((size_t)c1 * kCenters * 4);
    h0 = o;  o += align16((size_t)c1 * kCenters * kTile * 2);
    h1 = o;  o += align16((size_t)c2 * kCenters * kTile * 2);
    at = o;  o += align16((size_t)kTile * c1 * 2);
    xt = o;  o += align16((size_t)kTile * 3 * 4);
    mt = o;  o += align16((size_t)kTile * kCenters);
    prm = o; o += align16((size_t)(3 * c2 + c3) * 4);
    total = o;
  }
};

enum D2 { kPair, kMxu, kPre };

template <int C2, int C3, bool WIN, int D2>
__global__ void __launch_bounds__(kThreads)
sa_pair_pool_kernel(const uint16_t* __restrict__ A, const float* __restrict__ xyz,
                    const uint16_t* __restrict__ bc, const float* __restrict__ cen,
                    const uint8_t* __restrict__ mask,
                    const int* __restrict__ starts, const uint16_t* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ s2,
                    const float* __restrict__ lb2, const uint16_t* __restrict__ w3,
                    const float* __restrict__ b3, int N, int M, int c1, int W,
                    float r2, int wc, float* __restrict__ out, int* __restrict__ winners) {
  constexpr int CPT1 = C2 / kGroups;            // interior channels per thread
  constexpr int CPT2 = C3 / kGroups;            // output channels per thread
  constexpr int CH2 = CPT2 < 8 ? CPT2 : 8;      // output channels per pass
  static_assert(C2 % kGroups == 0 && C3 % kGroups == 0, "widths");
  static_assert(CPT1 <= 8 && CPT2 % CH2 == 0, "widths");

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(c1, C2, C3);
  uint16_t* w2s = reinterpret_cast<uint16_t*>(smem + L.w2);
  uint16_t* w3s = reinterpret_cast<uint16_t*>(smem + L.w3);
  float* bct = reinterpret_cast<float*>(smem + L.bct);   // [k][center]
  uint16_t* h0s = reinterpret_cast<uint16_t*>(smem + L.h0);  // [k][center][p]
  uint16_t* h1s = reinterpret_cast<uint16_t*>(smem + L.h1);  // [k][center][p]
  uint16_t* ats = reinterpret_cast<uint16_t*>(smem + L.at);  // [p][k]
  float* xts = reinterpret_cast<float*>(smem + L.xt);        // [p][3]
  uint8_t* mts = smem + L.mt;                                 // [p][center] (kPre)
  float* b2s = reinterpret_cast<float*>(smem + L.prm);
  float* s2s = b2s + C2;
  float* lb2s = s2s + C2;
  float* b3s = lb2s + C2;

  const int tid = threadIdx.x;
  const int c = tid / kGroups;
  const int g = tid % kGroups;
  const int b = blockIdx.y;
  const int n_blocks = M / kCenters;
  const int m0 = blockIdx.x * kCenters;
  int start = starts[(size_t)b * n_blocks + blockIdx.x];
  start = min(max(start, 0), N - W);  // keeps every window read inside the cloud

  {
    const uint4* src = reinterpret_cast<const uint4*>(w2);
    uint4* dst = reinterpret_cast<uint4*>(w2s);
    for (int i = tid; i < c1 * C2 / 8; i += kThreads) dst[i] = src[i];
    src = reinterpret_cast<const uint4*>(w3);
    dst = reinterpret_cast<uint4*>(w3s);
    for (int i = tid; i < C2 * C3 / 8; i += kThreads) dst[i] = src[i];
  }
  for (int i = tid; i < c1 * kCenters; i += kThreads) {
    const int cc = i % kCenters, k = i / kCenters;
    bct[i] = __uint_as_float(uint32_t(bc[((size_t)b * M + m0 + cc) * c1 + k]) << 16);
  }
  for (int i = tid; i < C2; i += kThreads) {
    b2s[i] = b2[i];
    s2s[i] = s2[i];
    lb2s[i] = lb2[i];
  }
  for (int i = tid; i < C3; i += kThreads) b3s[i] = b3[i];
  // kPair: the center; kMxu: c' = c - o, -2 o and csq; kPre: nothing
  float cx = 0.f, cy = 0.f, cz = 0.f, ox = 0.f, oy = 0.f, oz = 0.f, csq = 0.f;
  if constexpr (D2 != kPre) {
    const float* cp = cen + ((size_t)b * M + m0 + c) * 3;
    cx = cp[0];
    cy = cp[1];
    cz = cp[2];
  }
  if constexpr (D2 == kMxu) {
    const float* op = cen + ((size_t)b * M + m0) * 3;  // the block's first center
    ox = op[0];
    oy = op[1];
    oz = op[2];
    cx -= ox;
    cy -= oy;
    cz -= oz;
    csq = cx * cx + cy * cy + cz * cz;
  }

  float best[CPT2];
  int win[CPT2];  // window position of the winner, -1 for none (WIN only)
#pragma unroll
  for (int j = 0; j < CPT2; ++j) {
    best[j] = kNeg;
    win[j] = -1;
  }
  __syncthreads();

  const uint16_t* a_win = A + ((size_t)b * N + start) * c1;
  const float* x_win = D2 == kPre ? nullptr : xyz + ((size_t)b * N + start) * 3;
  const uint8_t* m_win =
      D2 == kPre ? mask + ((size_t)b * n_blocks + blockIdx.x) * W * kCenters : nullptr;

  for (int t0 = 0; t0 < W; t0 += kTile) {
    const int np = min(kTile, W - t0);
    // 1. stage the tile's A rows and coordinates, or its mask rows (zeros
    //    past the window end)
    {
      const uint4* src = reinterpret_cast<const uint4*>(a_win + (size_t)t0 * c1);
      uint4* dst = reinterpret_cast<uint4*>(ats);
      for (int i = tid; i < kTile * c1 / 8; i += kThreads) {
        const int p = (i * 8) / c1;
        dst[i] = p < np ? src[i] : make_uint4(0, 0, 0, 0);
      }
      if constexpr (D2 == kPre) {
        if (tid < kTile * kCenters)
          mts[tid] = tid / kCenters < np ? m_win[(size_t)t0 * kCenters + tid] : 0;
      } else {
        if (tid < kTile * 3) xts[tid] = tid / 3 < np ? x_win[(size_t)t0 * 3 + tid] : 0.f;
      }
    }
    __syncthreads();

    // 2. h0 = bf16(relu(A_p + bc_c)) for the 16 x 8 pairs of the tile
    for (int i = tid; i < c1 * kCenters; i += kThreads) {
      const int k = i / kCenters;
      const float bv = bct[i];
      float v[kTile];
#pragma unroll
      for (int p = 0; p < kTile; ++p) {
        const float a = __uint_as_float(uint32_t(ats[p * c1 + k]) << 16);
        v[p] = fmaxf(a + bv, 0.f);
      }
      store_tile(h0s + (size_t)i * kTile, v);
    }
    __syncthreads();

    // 3. interior layer: h1 = bf16(relu(LN(h0 @ W2 + b2))); radius mask
    unsigned in_radius = 0;
#pragma unroll
    for (int p = 0; p < kTile; ++p) {
      bool in;
      if constexpr (D2 == kPre) {
        in = mts[p * kCenters + c] != 0;
      } else if constexpr (D2 == kMxu) {
        const float px = xts[p * 3] - ox;
        const float py = xts[p * 3 + 1] - oy;
        const float pz = xts[p * 3 + 2] - oz;
        const float psq = px * px + py * py + pz * pz;
        const float pc = (-2.f * px) * cx + (-2.f * py) * cy + (-2.f * pz) * cz + csq;
        in = pc <= r2 - psq;
      } else {
        const float dx = xts[p * 3] - cx;
        const float dy = xts[p * 3 + 1] - cy;
        const float dz = xts[p * 3 + 2] - cz;
        in = dx * dx + dy * dy + dz * dz <= r2;
      }
      if (p < np && in) in_radius |= 1u << p;
    }
    {
      float acc[kTile][CPT1];
#pragma unroll
      for (int p = 0; p < kTile; ++p)
#pragma unroll
        for (int j = 0; j < CPT1; ++j) acc[p][j] = 0.f;
      for (int k = 0; k < c1; ++k) {
        float h[kTile], w[CPT1];
        load_bf16<8>(h0s + ((size_t)k * kCenters + c) * kTile, h);
        load_bf16<CPT1>(w2s + (size_t)k * C2 + g * CPT1, w);
#pragma unroll
        for (int p = 0; p < kTile; ++p)
#pragma unroll
          for (int j = 0; j < CPT1; ++j) acc[p][j] = fmaf(h[p], w[j], acc[p][j]);
      }
      float mean[kTile], rstd[kTile];
#pragma unroll
      for (int p = 0; p < kTile; ++p) {
        float s1 = 0.f, sq = 0.f;
#pragma unroll
        for (int j = 0; j < CPT1; ++j) {
          const float z = acc[p][j] + b2s[g * CPT1 + j];
          acc[p][j] = z;
          s1 += z;
          sq += z * z;
        }
#pragma unroll
        for (int off = 1; off < kGroups; off <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
        }
        mean[p] = s1 / C2;
        const float var = fmaxf(sq / C2 - mean[p] * mean[p], 0.f);
        rstd[p] = rsqrtf(var + kEps);
      }
#pragma unroll
      for (int j = 0; j < CPT1; ++j) {
        const int ch = g * CPT1 + j;
        float v[kTile];
#pragma unroll
        for (int p = 0; p < kTile; ++p)
          v[p] = fmaxf((acc[p][j] - mean[p]) * rstd[p] * s2s[ch] + lb2s[ch], 0.f);
        store_tile(h1s + ((size_t)ch * kCenters + c) * kTile, v);
      }
    }
    __syncthreads();

    // 4. last layer z = h1 @ W3 + b3, folded into the running masked max
#pragma unroll
    for (int pass = 0; pass < CPT2 / CH2; ++pass) {
      float acc[kTile][CH2];
#pragma unroll
      for (int p = 0; p < kTile; ++p)
#pragma unroll
        for (int j = 0; j < CH2; ++j) acc[p][j] = 0.f;
      const int ch0 = g * CPT2 + pass * CH2;
      for (int k = 0; k < C2; ++k) {
        float h[kTile], w[CH2];
        load_bf16<8>(h1s + ((size_t)k * kCenters + c) * kTile, h);
        load_bf16<CH2>(w3s + (size_t)k * C3 + ch0, w);
#pragma unroll
        for (int p = 0; p < kTile; ++p)
#pragma unroll
          for (int j = 0; j < CH2; ++j) acc[p][j] = fmaf(h[p], w[j], acc[p][j]);
      }
#pragma unroll
      for (int j = 0; j < CH2; ++j) {
        const float bias = b3s[ch0 + j];
#pragma unroll
        for (int p = 0; p < kTile; ++p) {
          if (!(in_radius & (1u << p))) continue;
          const float v = acc[p][j] + bias;
          if constexpr (WIN) {
            const int pos = t0 + p;
            float& bj = best[pass * CH2 + j];
            int& wj = win[pass * CH2 + j];
            if (v > bj || (v == bj && wj >= 0 && pos / wc == wj / wc)) {
              bj = v;
              wj = pos;
            }
          } else {
            best[pass * CH2 + j] = fmaxf(best[pass * CH2 + j], v);
          }
        }
      }
    }
  }

  const size_t o = ((size_t)b * M + m0 + c) * C3 + g * CPT2;
#pragma unroll
  for (int j = 0; j < CPT2; ++j) {
    out[o + j] = best[j];
    if constexpr (WIN) winners[o + j] = win[j] >= 0 ? start + win[j] : 0;
  }
}

template <int C2, int C3, bool WIN, int D2>
cudaError_t launch(const uint16_t* A, const float* xyz, const uint16_t* bc,
                   const float* cen, const uint8_t* mask, const int* starts,
                   const uint16_t* w2, const float* b2, const float* s2, const float* lb2,
                   const uint16_t* w3, const float* b3, int B, int N, int M, int c1,
                   int W, float r2, float* out, int* winners, cudaStream_t s) {
  const Layout L(c1, C2, C3);
  if (L.total > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sa_pair_pool_kernel<C2, C3, WIN, D2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return err;
  dim3 grid(M / kCenters, B);
  const int wc = W < 128 ? W : 128;
  sa_pair_pool_kernel<C2, C3, WIN, D2><<<grid, kThreads, L.total, s>>>(
      A, xyz, bc, cen, mask, starts, w2, b2, s2, lb2, w3, b3, N, M, c1, W, r2, wc, out,
      winners);
  return cudaGetLastError();
}

template <bool WIN, int D2>
int dispatch(const void* A, const float* xyz, const void* bc, const float* cen,
             const uint8_t* mask, const int* starts, const void* w2, const float* b2,
             const float* s2, const float* lb2, const void* w3, const float* b3, int B,
             int N, int M, int c1, int c2, int c3, int W, float r2, float* out,
             int* winners, void* stream) {
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (M % kCenters || c1 % 8 || c1 <= 0 || W <= 0 || W > N)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint16_t*>(A);
  const auto* bcv = static_cast<const uint16_t*>(bc);
  const auto* w2v = static_cast<const uint16_t*>(w2);
  const auto* w3v = static_cast<const uint16_t*>(w3);
#define EDA_SA_LAUNCH(X, Y)                                                     \
  if (c2 == X && c3 == Y)                                                       \
    return launch<X, Y, WIN, D2>(a, xyz, bcv, cen, mask, starts, w2v, b2, s2, lb2, \
                                 w3v, b3, B, N, M, c1, W, r2, out, winners, s);
  EDA_SA_LAUNCH(16, 32)
  EDA_SA_LAUNCH(32, 64)
  EDA_SA_LAUNCH(64, 128)
  EDA_SA_LAUNCH(128, 256)
#undef EDA_SA_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// A: (B, N, c1) bf16; xyz: (B, N, 3) f32; bc: (B, M, c1) bf16; cen: (B, M, 3)
// f32; starts: (B, M/16) int32 window starts (multiples of 16, clamped to
// [0, N-W]); w2: (c1, c2) bf16; b2/s2/lb2: (c2,) f32; w3: (c2, c3) bf16;
// b3: (c3,) f32; out: (B, M, c3) f32. (c2, c3) must be one of (16, 32),
// (32, 64), (64, 128), (128, 256); c1 a multiple of 8. Returns
// cudaGetLastError().
int sa_pair_pool_launch(const void* A, const float* xyz, const void* bc,
                        const float* cen, const int* starts, const void* w2,
                        const float* b2, const float* s2, const float* lb2,
                        const void* w3, const float* b3, int B, int N, int M,
                        int c1, int c2, int c3, int W, float r2, float* out,
                        void* stream) {
  return dispatch<false, kPair>(A, xyz, bc, cen, nullptr, starts, w2, b2, s2, lb2, w3, b3,
                                B, N, M, c1, c2, c3, W, r2, out, nullptr, stream);
}

// As sa_pair_pool_launch, plus winners: (B, M, c3) int32 global rank of the
// point whose pair gave each pooled value (0 where out is -1e9).
int sa_pair_pool_winners_launch(const void* A, const float* xyz, const void* bc,
                                const float* cen, const int* starts, const void* w2,
                                const float* b2, const float* s2, const float* lb2,
                                const void* w3, const float* b3, int B, int N, int M,
                                int c1, int c2, int c3, int W, float r2, float* out,
                                int* winners, void* stream) {
  return dispatch<true, kPair>(A, xyz, bc, cen, nullptr, starts, w2, b2, s2, lb2, w3, b3,
                               B, N, M, c1, c2, c3, W, r2, out, winners, stream);
}

// As sa_pair_pool_launch with the expansion-formula radius test ("mxu").
int sa_pair_pool_mxu_launch(const void* A, const float* xyz, const void* bc,
                            const float* cen, const int* starts, const void* w2,
                            const float* b2, const float* s2, const float* lb2,
                            const void* w3, const float* b3, int B, int N, int M,
                            int c1, int c2, int c3, int W, float r2, float* out,
                            void* stream) {
  return dispatch<false, kMxu>(A, xyz, bc, cen, nullptr, starts, w2, b2, s2, lb2, w3, b3,
                               B, N, M, c1, c2, c3, W, r2, out, nullptr, stream);
}

int sa_pair_pool_mxu_winners_launch(const void* A, const float* xyz, const void* bc,
                                    const float* cen, const int* starts, const void* w2,
                                    const float* b2, const float* s2, const float* lb2,
                                    const void* w3, const float* b3, int B, int N, int M,
                                    int c1, int c2, int c3, int W, float r2, float* out,
                                    int* winners, void* stream) {
  return dispatch<true, kMxu>(A, xyz, bc, cen, nullptr, starts, w2, b2, s2, lb2, w3, b3,
                              B, N, M, c1, c2, c3, W, r2, out, winners, stream);
}

// As sa_pair_pool_launch with the radius test read from mask ("pre"):
// (B, M/16, W, 16) uint8, row w of block j the window point starts[j] + w
// (csrc/sa_mask.cu). No coordinates and no radius.
int sa_pair_pool_pre_launch(const void* A, const void* bc, const uint8_t* mask,
                            const int* starts, const void* w2, const float* b2,
                            const float* s2, const float* lb2, const void* w3,
                            const float* b3, int B, int N, int M, int c1, int c2, int c3,
                            int W, float* out, void* stream) {
  return dispatch<false, kPre>(A, nullptr, bc, nullptr, mask, starts, w2, b2, s2, lb2, w3,
                               b3, B, N, M, c1, c2, c3, W, 0.f, out, nullptr, stream);
}

int sa_pair_pool_pre_winners_launch(const void* A, const void* bc, const uint8_t* mask,
                                    const int* starts, const void* w2, const float* b2,
                                    const float* s2, const float* lb2, const void* w3,
                                    const float* b3, int B, int N, int M, int c1, int c2,
                                    int c3, int W, float* out, int* winners,
                                    void* stream) {
  return dispatch<true, kPre>(A, nullptr, bc, nullptr, mask, starts, w2, b2, s2, lb2, w3,
                              b3, B, N, M, c1, c2, c3, W, 0.f, out, winners, stream);
}

}  // extern "C"
