// Fused SA layer-0 prep backward on Hopper's tensor cores.
//
// Replaces the TPU kernel eda_tpu/ops/pallas/sa_prep.py:_prep_bwd (body
// _bwd_kernel). The forward (sa_prep.cu) is
//   x = bf16(bf16(P @ bf16(W1)) + bf16(b1)),  A = LN(x),  P = bf16([xyz/r ; f])
// with one-pass LayerNorm statistics. Given dA (bf16, as the TPU wrapper
// rounds it), per point:
//   xhat = (x - mean) * rstd                   recomputed with the forward's
//                                              rounding points
//   dscale += dA * xhat,  dlnb += dA
//   dxhat = dA * scale
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//   db1 += dx,  dW1 += P^T bf16(dx)
//   dpts = bf16(dx) @ bf16(W1)^T, its xyz columns divided by r
//
// Bound on this card: bytes. Per point it reads (3 + C) f32 and c1 bf16 and
// writes (3 + C) f32 (SA1 at batch 8: 400 000 rows, 70 MB); the three
// products are 6 (3 + C) c1 flops a point, far below the tensor-core peak.
//
// Design: one kernel over tiles of 64 rows, one warpgroup a CTA, plus the
// fixed-order sum of the CTAs' records (wgmma.cuh, reduce_records). Each
// point row and each dA row is read once, dpts is written once, and nothing
// of the size of the rows goes back to device memory. Per tile:
//   1. P (64 x K, K = in_dim padded to 16) goes to shared memory in the
//      no-swizzle core layout; X = P W1 runs as wgmma (B = W1 staged once per
//      CTA, transposed, as a K-major operand), over all c1 columns up to 128
//      (in chunks of 64 beyond, x kept in shared memory between the passes);
//      x = bf16(bf16(X) + bf16(b1)) in the accumulator layout.
//   2. The LayerNorm statistics over the real c1 columns by quad shuffles;
//      the backward in the same layout (dA loaded straight into it). db1,
//      dscale and dlnb fold into a few running sums a lane (the transposing
//      butterfly of wgmma.cuh) and stay in registers across the tiles.
//   3. bf16(dx) goes to shared memory; dpts = bf16(dx) W1^T is a wgmma that
//      reads W1 transposed (MN-major) from the same staged copy, 64 columns
//      a product (16 at SA1's K = 16).
//   4. dW1^T = bf16(dx)^T P over the tile's 64 rows, both operands read
//      MN-major from the tile buffers. When it is small (K = 16, c1 <= 64:
//      SA1) the sum stays in registers across the CTA's tiles; otherwise each
//      tile adds its product into the CTA's own f32 record, the element's
//      owner reading and writing it.
// Padding rows, K columns and c1 columns are zero in P, W1, b1, scale and dA;
// dx is masked to the real columns, so no padding reaches an output. Clouds
// whose P tile does not fit beside W1 stage P in K chunks (X accumulates
// over them; dW1 stages them again). Every weight and vector gradient is a
// fixed-order sum: bit-identical across launches, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // rows per tile (the wgmma M)
constexpr float kEps = 1e-5f;
constexpr int kMaxSharedBytes = 232448;
constexpr int kCtasPerSm = 8;
constexpr int kSms = 132;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }
__host__ __device__ constexpr int c1_pad(int c1) {
  return c1 <= 16 ? 16 : c1 <= 32 ? 32 : c1 <= 64 ? 64 : c1 <= 128 ? 128 : 256;
}

// The shared buffers of a CTA: W1^T (C1P x KP), the P tile (64 x KC), the dx
// tile (64 x max(64, C1P)), the x stash (bf16, [value][thread]), the warps'
// column sums, and bf16(b1) and scale.
struct Layout {
  size_t w1, p, dx, xs, red, bs, ss, total;
  __host__ __device__ Layout(int KP, int KC, int C1P) {
    const int DXC = C1P < 64 ? 64 : C1P;
    size_t o = 0;
    w1 = o;  o += align128((size_t)C1P * KP * 2);
    p = o;   o += align128((size_t)kRows * KC * 2);
    dx = o;  o += align128((size_t)kRows * DXC * 2);
    xs = o;  o += C1P > 128 ? align128((size_t)kRows * C1P * 2) : 0;
    red = o; o += align128((size_t)4 * 3 * C1P * 4);
    bs = o;  o += align128((size_t)C1P * 4);
    ss = o;  o += align128((size_t)C1P * 4);
    total = o;
  }
};

bool fits(int in_dim, int c1, int KC) {
  return Layout(round16(in_dim), KC, c1_pad(c1)).total <= (size_t)kMaxSharedBytes;
}

// K columns of P staged at once: all of them if they fit, else the most that do
int k_chunk(int in_dim, int c1) {
  for (int KC = round16(in_dim); KC >= 16; KC -= 16)
    if (fits(in_dim, c1, KC)) return KC;
  return 0;
}

// the dW1 sum held in registers (8 floats a thread) instead of the record
bool holds_dw1(int in_dim, int c1) { return round16(in_dim) == 16 && c1 <= 64; }

int ctas(long long n_rows, int in_dim, int c1) {
  const long long tiles = (n_rows + kRows - 1) / kRows;
  const long long cap = (long long)kSms * (holds_dw1(in_dim, c1) ? kCtasPerSm : 2);
  return (int)(tiles < cap ? (tiles > 0 ? tiles : 1) : cap);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_bits(uint32_t u) { return __uint_as_float(u << 16); }

// dA at (row, c) and (row, c + 1), zero outside the real rows and columns
__device__ __forceinline__ void load_g(const uint16_t* __restrict__ dA, long long row, int c,
                                       int c1, long long n_rows, float& g0, float& g1) {
  g0 = g1 = 0.f;
  if (row >= n_rows || c >= c1) return;
  const uint16_t* p = dA + row * c1 + c;
  if (!(c1 & 1) && c + 1 < c1) {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(p));
    g0 = bf16_bits(v & 0xffffu);
    g1 = bf16_bits(v >> 16);
  } else {
    g0 = bf16_bits(__ldg(p));
    if (c + 1 < c1) g1 = bf16_bits(__ldg(p + 1));
  }
}

template <int C1P, bool HOLD>
__global__ void __launch_bounds__(kThreads)
prep_bwd_tiles(const float* __restrict__ pts, const uint16_t* __restrict__ dA,
               long long n_rows, int in_dim, int c1, int KC,
               const uint16_t* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ scale, float radius, float* __restrict__ dpts,
               float* __restrict__ records) {
  // columns of one X chunk: all of them up to 128; at 256 four chunks of 64,
  // so that a chunk's x and dA values fit in registers beside the rest
  constexpr int CW = C1P <= 128 ? C1P : 64;
  constexpr int NCH = C1P / CW;
  constexpr int DXC = C1P < 64 ? 64 : C1P;
  constexpr int NV = CW / 2;                 // accumulator values a thread
  constexpr int DN = HOLD ? 16 : 64;         // columns of a dpts or dW1 product
  using F = Fold<CW>;
  const int KP = round16(in_dim);
  const int nkc = (KP + KC - 1) / KC;        // K chunks of P
  const Layout L(KP, KC, C1P);

  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* w1s = reinterpret_cast<uint16_t*>(smem + L.w1);
  uint16_t* ps = reinterpret_cast<uint16_t*>(smem + L.p);
  uint16_t* dxs = reinterpret_cast<uint16_t*>(smem + L.dx);
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + L.xs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* bs = reinterpret_cast<float*>(smem + L.bs);
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  const uint32_t w1_base = smem_u32(w1s), p_base = smem_u32(ps), dx_base = smem_u32(dxs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g4;  // the thread's rows r0 and r0 + 8 of a tile
  const int RF = (in_dim + 3) * c1;
  float* rec = records + (size_t)blockIdx.x * RF;

  // W1^T as a (C1P x KP) K-major operand, zero padded; the dx tile's padding
  // columns stay zero
  for (int k = warp; k < KP; k += 4)
    for (int c = lane; c < C1P; c += 32)
      w1s[core_at(c, k, KP)] = (k < in_dim && c < c1) ? w1[(size_t)k * c1 + c] : uint16_t(0);
  for (int i = tid; i < kRows * DXC / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(dxs)[i] = 0u;
  for (int c = tid; c < C1P; c += kThreads) {
    bs[c] = c < c1 ? bf16_round(b1[c]) : 0.f;
    ss[c] = c < c1 ? scale[c] : 0.f;
  }

  // P columns [k0, k0 + KC) of the tile's rows, bf16 with xyz divided by r;
  // element i = r KC + k of the tile goes to thread i % 128 (all threads busy
  // at SA1's KC = 16), its (r, k) stepped without a division
  const int step_r = kThreads / KC, step_k = kThreads % KC;
  auto stage_p = [&](long long row0, int k0) {
    for (int r = tid / KC, k = tid % KC; r < kRows;) {
      float v = 0.f;
      if (row0 + r < n_rows && k0 + k < in_dim) {
        v = pts[(row0 + r) * in_dim + k0 + k];
        if (k0 + k < 3) v = v / radius;
      }
      ps[core_at(r, k, KC)] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      r += step_r;
      k += step_k;
      if (k >= KC) {
        k -= KC;
        ++r;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  float run[NCH][3][F::NR];  // column sums of db1, dscale, dlnb
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < F::NR; ++i) run[ch][q][i] = 0.f;
  float accw[8];  // dW1^T (64 x 16) when held
#pragma unroll
  for (int i = 0; i < 8; ++i) accw[i] = 0.f;

  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  int done = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++done) {
    const long long row0 = tile * kRows;
    const long long rows[2] = {row0 + r0, row0 + r0 + 8};
    if (nkc == 1) stage_p(row0, 0);  // also orders the prologue's stores

    // ---- 1. x = bf16(bf16(P W1) + bf16(b1)), a chunk of CW columns at a time
    float xa[NV], ga[NV];
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      for (int kc = 0; kc < nkc; ++kc) {
        if (nkc > 1) stage_p(row0, kc * KC);
        const uint32_t pb = opaque(p_base);
        const uint32_t wb = opaque(w1_base) + (ch * CW / 8) * KP * 16 + (kc * KC / 8) * 128;
        wgmma_fence();
        for (int s = 0; s < KC / 16; ++s)
          wgmma_ss<CW, 0, 0>(xa, make_desc(pb + 256 * s, 128, KC * 16),
                             make_desc(wb + 256 * s, 128, KP * 16), kc > 0 || s > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(xa);
        if (nkc > 1) __syncthreads();  // the chunk is read: the next may replace it
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = ch * CW + 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
        const float x = bf16_round(bf16_round(xa[i]) + bs[c]);
        xa[i] = x;
        s1[h] += x;
        s2[h] += x * x;
        if (NCH > 1) xs[(size_t)(ch * NV + i) * kThreads + tid] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
      }
    }
    float mean[2], rstd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], m);
        s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], m);
      }
      mean[h] = s1[h] / c1;
      rstd[h] = rsqrtf(fmaxf(s2[h] / c1 - mean[h] * mean[h], 0.f) + kEps);
    }

    // xa <- xhat, ga <- dA of chunk ch (x from the stash when there are chunks)
    auto load_chunk = [&](int ch) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int h = (i >> 1) & 1;
        if (NCH > 1) xa[i] = bf16_bits(xs[(size_t)(ch * NV + i) * kThreads + tid]);
        xa[i] = (xa[i] - mean[h]) * rstd[h];
      }
#pragma unroll
      for (int i = 0; i < NV; i += 2) {
        const int c = ch * CW + 8 * (i / 4) + 2 * t4;
        load_g(dA, rows[(i >> 1) & 1], c, c1, n_rows, ga[i], ga[i + 1]);
      }
    };

    // ---- 2. the LayerNorm backward's row means; dscale and dlnb
    float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      load_chunk(ch);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = ch * CW + 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
        const float dxh = ga[i] * ss[c];
        m1[h] += dxh;
        m2[h] += dxh * xa[i];
      }
      fold_columns<CW, true>(ga, xa, lane, run[ch][1]);
      fold_columns<CW, false>(ga, ga, lane, run[ch][2]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        m1[h] += __shfl_xor_sync(0xffffffffu, m1[h], m);
        m2[h] += __shfl_xor_sync(0xffffffffu, m2[h], m);
      }
      m1[h] /= c1;
      m2[h] /= c1;
    }

    // ---- dx over the real columns; db1; bf16(dx) to the dx tile
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      if (NCH > 1) load_chunk(ch);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = ch * CW + 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
        ga[i] = c < c1 ? rstd[h] * (ga[i] * ss[c] - m1[h] - xa[i] * m2[h]) : 0.f;
      }
      fold_columns<CW, false>(ga, ga, lane, run[ch][0]);
#pragma unroll
      for (int i = 0; i < NV; i += 2) {
        const int c = ch * CW + 8 * (i / 4) + 2 * t4, r = r0 + 8 * ((i >> 1) & 1);
        *reinterpret_cast<uint32_t*>(dxs + core_at(r, c, DXC)) = pack_bf16x2(ga[i], ga[i + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // ---- 3. dpts = bf16(dx) W1^T (W1 read MN-major), DN columns at a time
    // (the last block's columns past K read the next buffer and are dropped)
    for (int n0 = 0; n0 < KP; n0 += DN) {
      float acc[DN / 2];
      const uint32_t db = opaque(dx_base), wb = opaque(w1_base) + (n0 / 8) * 128;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < C1P / 16; ++s)
        wgmma_ss<DN, 0, 1>(acc, make_desc(db + 256 * s, 128, DXC * 16),
                           make_desc(wb + s * 32 * KP, KP * 16, 128), s > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) {
        const long long row = rows[(i >> 1) & 1];
        const int k = n0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        if (row < n_rows && k < in_dim) dpts[row * in_dim + k] = k < 3 ? acc[i] / radius : acc[i];
      }
    }

    // ---- 4. dW1^T += bf16(dx)^T P over the tile's rows
    if constexpr (HOLD) {
      wgmma_fence();
      wgmma_rows<16>(accw, opaque(dx_base), DXC, 0, opaque(p_base), KC, 0, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(accw);
    } else {
      for (int kc = 0; kc < nkc; ++kc) {
        if (nkc > 1) {
          __syncthreads();
          stage_p(row0, kc * KC);
        }
        for (int mb = 0; mb < DXC / 64; ++mb) {
          for (int n0 = 0; n0 < KC; n0 += DN) {
            float acc[DN / 2];
            wgmma_fence();
            wgmma_rows<DN>(acc, opaque(dx_base), DXC, 64 * mb, opaque(p_base), KC, n0, 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
#pragma unroll
            for (int i = 0; i < DN / 2; ++i) {
              const int c = 64 * mb + r0 + 8 * ((i >> 1) & 1);
              const int n = n0 + 8 * (i / 4) + 2 * t4 + (i & 1), k = kc * KC + n;
              if (c < c1 && n < KC && k < in_dim) {
                float* e = rec + (size_t)k * c1 + c;
                *e = done > 0 ? *e + acc[i] : acc[i];
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the tile buffers are rewritten by the next tile
  }

  if constexpr (HOLD) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = r0 + 8 * ((i >> 1) & 1), k = 8 * (i / 4) + 2 * t4 + (i & 1);
      if (c < c1 && k < in_dim) rec[(size_t)k * c1 + c] = accw[i];
    }
  }
  // the column sums: each warp its rows, then the four warps in order
  if (col_owner<F::NVH>(lane)) {
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int i = 0; i < F::NR; ++i)
          red[(warp * 3 + q) * C1P + ch * CW + F::column(i, lane, t4)] = run[ch][q][i];
  }
  __syncthreads();
  for (int i = tid; i < 3 * c1; i += kThreads) {
    const int q = i / c1, c = i % c1;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += red[(w * 3 + q) * C1P + c];
    rec[(size_t)in_dim * c1 + i] = s;
  }
}

template <int C1P, bool HOLD>
cudaError_t launch(const float* pts, const uint16_t* dA, long long n_rows, int in_dim, int c1,
                   int KC, const uint16_t* w1, const float* b1, const float* scale,
                   float radius, float* dpts, float* wout, float* records, cudaStream_t s) {
  const Layout L(round16(in_dim), KC, C1P);
  cudaError_t err = cudaFuncSetAttribute(prep_bwd_tiles<C1P, HOLD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return err;
  const int n_ctas = ctas(n_rows, in_dim, c1);
  prep_bwd_tiles<C1P, HOLD><<<n_ctas, kThreads, L.total, s>>>(
      pts, dA, n_rows, in_dim, c1, KC, w1, b1, scale, radius, dpts, records);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P = (in_dim + 3) * c1;
  reduce_records<8><<<(P + 31) / 32, 256, 0, s>>>(records, n_ctas, P, wout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// CTAs of the tile kernel for n_rows points: the wrapper gives each a record
// of (in_dim + 3) * c1 floats.
int sa_prep_bwd_ctas(long long n_rows, int in_dim, int c1) { return ctas(n_rows, in_dim, c1); }

// Largest in_dim that fits shared memory for this c1 (0 if c1 is unsupported).
int sa_prep_bwd_max_in_dim(int c1) {
  if (c1 <= 0 || c1 > 256) return 0;
  int in_dim = 3;
  while (fits(in_dim + 1, c1, 16)) ++in_dim;
  return in_dim;
}

// pts: (n_rows, in_dim) f32; dA: (n_rows, c1) bf16; w1: (in_dim, c1) bf16;
// b1/scale: (c1,) f32. Outputs: dpts (n_rows, in_dim) f32 and wout
// ((in_dim + 3) * c1) f32 = [dW1 (in_dim, c1); db1; dscale; dlnb]. Scratch:
// records (sa_prep_bwd_ctas(n_rows, in_dim, c1), (in_dim + 3) * c1) f32.
// Returns cudaGetLastError().
int sa_prep_bwd_launch(const float* pts, const void* dA, long long n_rows, int in_dim,
                       int c1, const void* w1, const float* b1, const float* scale,
                       float radius, float* dpts, float* wout, float* records, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (in_dim < 3 || in_dim > sa_prep_bwd_max_in_dim(c1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const uint16_t*>(dA);
  const auto* w = static_cast<const uint16_t*>(w1);
  const int KC = k_chunk(in_dim, c1);
  const bool hold = holds_dw1(in_dim, c1);
#define EDA_PREP_BWD(C1P)                                                                    \
  if (c1_pad(c1) == C1P)                                                                    \
    return hold ? (int)launch<C1P, (C1P <= 64)>(pts, g, n_rows, in_dim, c1, KC, w, b1,       \
                                                 scale, radius, dpts, wout, records, s)      \
                : (int)launch<C1P, false>(pts, g, n_rows, in_dim, c1, KC, w, b1, scale,      \
                                          radius, dpts, wout, records, s);
  EDA_PREP_BWD(16)
  EDA_PREP_BWD(32)
  EDA_PREP_BWD(64)
  EDA_PREP_BWD(128)
  EDA_PREP_BWD(256)
#undef EDA_PREP_BWD
  return cudaErrorInvalidValue;
}

}  // extern "C"
