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
//      MN-major from the tile buffers. When it is small (K = 16, c1 <= 128:
//      SA1) the sum stays in registers across the CTA's tiles (8 floats a
//      thread a 64 columns of c1) and the CTAs are not capped at two an SM;
//      otherwise each tile adds its product into the CTA's own f32 record,
//      the element's owner reading and writing it.
// At the width-2 backbone's SA1 (c1 128, dW1 held) a tile's P rows are read
// as float4 from their contiguous span and its dA pairs all in flight before
// their first use (the general path waits on each load in turn); that
// instance needs the points 16-byte and dA 4-byte aligned, and c1 even (an
// odd c1 of 65-128 at K = 16 runs the record path).
// Padding rows, K columns and c1 columns are zero in P, W1, b1, scale and dA;
// dx is masked to the real columns, so no padding reaches an output. Clouds
// whose P tile does not fit beside W1 stage P in K chunks (X accumulates
// over them; dW1 stages them again). Where W1 does not fit whole beside a
// 16-column P chunk (c1 256 past in_dim ~288, as the width-2 backbone's SA3
// and SA4 at in_dim 515: W1 alone is 264 KiB), it streams (STREAM): for
// step 1 each 64-column chunk's rows of W1 come by 16-byte cp.async into
// shared memory in its natural layout (rows = K, read MN-major), for step 3
// each block of 64 W1 rows (read K-major).
// At c1 = 256 and in_dim up to 528 (the width-2 backbone's SA2-4) the tiles
// run on persistent clusters of four CTAs instead (prep_bwd_cluster, its note
// below), one record a cluster: one warpgroup takes 190-300 us a tile there on
// an H100, each phase a chain of dependent loads and products. Every weight
// and vector gradient is a fixed-order sum: bit-identical across launches, no
// atomics.

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

// The shared buffers of a CTA: W1^T (C1P x KP; streamed: KC x CW rows of W1
// or 64 x C1P, whichever is larger), the P tile (64 x KC), the dx tile (64 x
// max(64, C1P)), the x stash (bf16, [value][thread]), the warps' column sums,
// and bf16(b1) and scale.
struct Layout {
  size_t w1, p, dx, xs, red, bs, ss, total;
  __host__ __device__ Layout(int KP, int KC, int C1P, bool stream = false) {
    const int DXC = C1P < 64 ? 64 : C1P;
    const size_t piece = (size_t)KC * (C1P <= 128 ? C1P : 64), block = (size_t)64 * C1P;
    size_t o = 0;
    w1 = o;  o += align128((stream ? (piece > block ? piece : block) : (size_t)C1P * KP) * 2);
    p = o;   o += align128((size_t)kRows * KC * 2);
    dx = o;  o += align128((size_t)kRows * DXC * 2);
    xs = o;  o += C1P > 128 ? align128((size_t)kRows * C1P * 2) : 0;
    red = o; o += align128((size_t)4 * 3 * C1P * 4);
    bs = o;  o += align128((size_t)C1P * 4);
    ss = o;  o += align128((size_t)C1P * 4);
    total = o;
  }
};

bool fits(int in_dim, int c1, int KC, bool stream = false) {
  return Layout(round16(in_dim), KC, c1_pad(c1), stream).total <= (size_t)kMaxSharedBytes;
}

// The largest in_dim the kernel takes. Shared memory sets no limit (W1
// streams); this is the largest the card checks (chip_smoke.py).
constexpr int kMaxInDim = 2048;

// K columns of P staged at once: all of them if they fit, else the most that
// do; with W1 streamed, as few equal chunks as fit (then `stream` is set)
int k_chunk(int in_dim, int c1, bool& stream) {
  stream = false;
  for (int KC = round16(in_dim); KC >= 16; KC -= 16)
    if (fits(in_dim, c1, KC)) return KC;
  stream = true;
  const int KP = round16(in_dim);
  int n = 1;
  while (!fits(in_dim, c1, round16((KP + n - 1) / n), true)) ++n;
  return round16((KP + n - 1) / n);
}

// the dW1 sum held in registers (8 floats a thread a 64 columns of c1)
// instead of the record; above c1 64 only for an even c1 (the batched dA
// pair loads of that instance)
bool holds_dw1(int in_dim, int c1) {
  return round16(in_dim) == 16 && (c1 <= 64 || (c1 <= 128 && c1 % 2 == 0));
}

bool cluster_route(int in_dim, int c1);
int clusters(long long tiles, int in_dim);

// The records the kernel adds: a CTA's each (a cluster's each on the cluster
// route); 0 if the cluster kernel cannot be placed.
int ctas(long long n_rows, int in_dim, int c1) {
  const long long tiles = (n_rows + kRows - 1) / kRows;
  if (cluster_route(in_dim, c1)) return clusters(tiles > 0 ? tiles : 1, in_dim);
  const long long cap = (long long)kSms * (holds_dw1(in_dim, c1) ? kCtasPerSm : 2);
  return (int)(tiles < cap ? (tiles > 0 ? tiles : 1) : cap);
}

bool misaligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) & (bytes - 1);
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

template <int C1P, bool HOLD, bool STREAM>
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
  constexpr int MB = DXC / 64;               // 64-column blocks of c1 (dW1's rows)
  // the width-2 backbone's SA1 (c1 128, dW1 held): a tile's P and dA loads
  // in flight together before their first use (c1 even, the points 16-byte
  // and dA 4-byte aligned: holds_dw1 and the launcher see to it)
  constexpr bool BATCH = HOLD && C1P == 128;
  using F = Fold<CW>;
  const int KP = round16(in_dim);
  const int nkc = (KP + KC - 1) / KC;        // K chunks of P
  const Layout L(KP, KC, C1P, STREAM);

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

  // W1^T as a (C1P x KP) K-major operand, zero padded (STREAM: W1 comes
  // with the products, stage_w1); the dx tile's padding columns stay zero
  if constexpr (!STREAM) {
    for (int k = warp; k < KP; k += 4)
      for (int c = lane; c < C1P; c += 32)
        w1s[core_at(c, k, KP)] = (k < in_dim && c < c1) ? w1[(size_t)k * c1 + c] : uint16_t(0);
  }
  // STREAM: W1's rows [k0, k0 + nk) and columns [c0, c0 + nc) into its buffer
  // in the natural core layout (rows = K), zero past in_dim and c1; 16-byte
  // cp.async where a core row lies inside, a warp on 8 rows of 4 cores
  const bool vec = c1 % 8 == 0 && !(reinterpret_cast<uintptr_t>(w1) & 15);
  auto stage_w1 = [&](int k0, int nk, int c0, int nc) {
    const int Q = nc / 8;
    for (int i = tid; i < nk * Q; i += kThreads) {
      const int kr = i & 7, q = (i >> 3) % Q, k = ((i >> 3) / Q) * 8 + kr;
      const int n = c0 + 8 * q;
      uint16_t* dst = w1s + core_at(k, 8 * q, nc);
      if (vec && k0 + k < in_dim && n < c1) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
                     "l"(w1 + (size_t)(k0 + k) * c1 + n));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = k0 + k < in_dim && n + e < c1 ? w1[(size_t)(k0 + k) * c1 + n + e]
                                                 : uint16_t(0);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };
  for (int i = tid; i < kRows * DXC / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(dxs)[i] = 0u;
  if constexpr (BATCH) {  // the P tile's padding columns, which stage_p leaves
    for (int i = tid; i < kRows * KC / 2; i += kThreads) reinterpret_cast<uint32_t*>(ps)[i] = 0u;
    __syncthreads();
  }
  for (int c = tid; c < C1P; c += kThreads) {
    bs[c] = c < c1 ? bf16_round(b1[c]) : 0.f;
    ss[c] = c < c1 ? scale[c] : 0.f;
  }

  // P columns [k0, k0 + KC) of the tile's rows, bf16 with xyz divided by r;
  // element i = r KC + k of the tile goes to thread i % 128 (all threads busy
  // at SA1's KC = 16), its (r, k) stepped without a division
  const int step_r = kThreads / KC, step_k = kThreads % KC;
  auto stage_p = [&](long long row0, int k0) {
    if constexpr (BATCH) {
      // the tile's rows whole (K = 16 >= in_dim): one contiguous span of nr
      // in_dim floats, 16-byte aligned (a tile starts at 64 in_dim floats),
      // read as float4; the padding columns stay zero from the prologue, rows
      // past n_rows are zeroed
      const int nr = (int)(n_rows - row0 < kRows ? n_rows - row0 : kRows);
      const int total = nr * in_dim;
      const float* src = pts + row0 * in_dim;
      for (int i0 = tid; i0 < (total + 3) / 4; i0 += 4 * kThreads) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kThreads;
          if (4 * i + 3 < total) {
            v[u] = __ldg(reinterpret_cast<const float4*>(src) + i);
          } else {
            v[u].x = 4 * i < total ? __ldg(src + 4 * i) : 0.f;
            v[u].y = 4 * i + 1 < total ? __ldg(src + 4 * i + 1) : 0.f;
            v[u].z = 4 * i + 2 < total ? __ldg(src + 4 * i + 2) : 0.f;
            v[u].w = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kThreads;
          const float e4[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
          int r = (4 * i) / in_dim, k = 4 * i - r * in_dim;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * i + e < total)
              ps[core_at(r, k, KC)] =
                  __bfloat16_as_ushort(__float2bfloat16_rn(k < 3 ? e4[e] / radius : e4[e]));
            if (++k == in_dim) {
              k = 0;
              ++r;
            }
          }
        }
      }
      for (int i = tid; i < (kRows - nr) * KC; i += kThreads)
        ps[core_at(nr + i / KC, i % KC, KC)] = 0;
    } else {
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
  float accw[MB][8];  // dW1^T (c1 x 16) when held, a 64-row block each
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < 8; ++i) accw[mb][i] = 0.f;

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
        if constexpr (STREAM) {
          stage_w1(kc * KC, KC, ch * CW, CW);
          const uint32_t wb = opaque(w1_base);
          wgmma_fence();
          for (int s = 0; s < KC / 16; ++s)
            wgmma_ss<CW, 0, 1>(xa, make_desc(pb + 256 * s, 128, KC * 16),
                               make_desc(wb + s * 32 * CW, CW * 16, 128), kc > 0 || s > 0);
        } else {
          const uint32_t wb = opaque(w1_base) + (ch * CW / 8) * KP * 16 + (kc * KC / 8) * 128;
          wgmma_fence();
          for (int s = 0; s < KC / 16; ++s)
            wgmma_ss<CW, 0, 0>(xa, make_desc(pb + 256 * s, 128, KC * 16),
                               make_desc(wb + 256 * s, 128, KP * 16), kc > 0 || s > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(xa);
        // the chunk (and a streamed W1's rows) is read: the next may replace it
        if (nkc > 1 || STREAM) __syncthreads();
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
      if constexpr (BATCH) {
        // every pair's load in flight before the first use (c1 even: a pair
        // never straddles the real columns' end)
        uint32_t raw[NV / 2];
#pragma unroll
        for (int i = 0; i < NV; i += 2) {
          const int c = ch * CW + 8 * (i / 4) + 2 * t4;
          const long long row = rows[(i >> 1) & 1];
          raw[i / 2] = row < n_rows && c < c1
                           ? __ldg(reinterpret_cast<const unsigned int*>(dA + row * c1 + c))
                           : 0u;
        }
#pragma unroll
        for (int i = 0; i < NV; i += 2) {
          ga[i] = bf16_bits(raw[i / 2] & 0xffffu);
          ga[i + 1] = bf16_bits(raw[i / 2] >> 16);
        }
      } else {
#pragma unroll
        for (int i = 0; i < NV; i += 2) {
          const int c = ch * CW + 8 * (i / 4) + 2 * t4;
          load_g(dA, rows[(i >> 1) & 1], c, c1, n_rows, ga[i], ga[i + 1]);
        }
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
      const uint32_t db = opaque(dx_base);
      if constexpr (STREAM) {
        // W1's rows [n0, n0 + DN), read K-major (N = the rows)
        stage_w1(n0, DN, 0, C1P);
        const uint32_t wb = opaque(w1_base);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < C1P / 16; ++s)
          wgmma_ss<DN, 0, 0>(acc, make_desc(db + 256 * s, 128, DXC * 16),
                             make_desc(wb + 256 * s, 128, C1P * 16), s > 0);
      } else {
        const uint32_t wb = opaque(w1_base) + (n0 / 8) * 128;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < C1P / 16; ++s)
          wgmma_ss<DN, 0, 1>(acc, make_desc(db + 256 * s, 128, DXC * 16),
                             make_desc(wb + s * 32 * KP, KP * 16, 128), s > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (STREAM) __syncthreads();  // the block is read: the next may replace it
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
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
        wgmma_rows<16>(accw[mb], opaque(dx_base), DXC, 64 * mb, opaque(p_base), KC, 0, 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) fence_regs(accw[mb]);
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
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 64 * mb + r0 + 8 * ((i >> 1) & 1), k = 8 * (i / 4) + 2 * t4 + (i & 1);
        if (c < c1 && k < in_dim) rec[(size_t)k * c1 + c] = accw[mb][i];
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

// ---- c1 256 on a cluster of four CTAs: the width-2 backbone's SA2-4

constexpr int kQuarters = 4;      // CTAs of a cluster, one a quarter of c1
constexpr int kQW = 64;           // c1 columns of a CTA
constexpr int kClusterMaxKP = 528;  // in_dim padded to 16: W1's quarter and P whole in shared memory
constexpr int kPRows = kRows / kQuarters;  // P rows each CTA converts for the cluster

// W1's quarter (its KP x kQW block, rows = K), the P tile (64 x KP), the tile's bf16(dx)
// quarter (64 x kQW), the dpts partial blocks the CTA sums ([rank][64][64]
// f32), the LayerNorm row sums of each rank ([2 uses][rank][64][2]), the
// warps' column sums and bf16(b1) and scale of the quarter.
struct ClusterLayout {
  size_t w1, p, dx, slots, lnx, red, bs, ss, total;
  __host__ __device__ ClusterLayout(int KP) {
    size_t o = 0;
    w1 = o;    o += align128((size_t)kQW * KP * 2);
    p = o;     o += align128((size_t)kRows * KP * 2);
    dx = o;    o += align128((size_t)kRows * kQW * 2);
    slots = o; o += align128((size_t)kQuarters * kRows * 64 * 4);
    lnx = o;   o += align128((size_t)2 * kQuarters * kRows * 2 * 4);
    red = o;   o += align128((size_t)4 * 3 * kQW * 4);
    bs = o;    o += align128((size_t)kQW * 4);
    ss = o;    o += align128((size_t)kQW * 4);
    total = o;
  }
};

bool cluster_route(int in_dim, int c1) { return c1 == 256 && round16(in_dim) <= kClusterMaxKP; }

// Persistent clusters at c1 = 256, in_dim up to 528 (on one warpgroup, as
// prep_bwd_tiles runs the other widths, every phase of such a tile is a chain
// of dependent loads and products). Cluster j of n (n = min(tiles, the
// clusters the card holds at once)) takes tiles j, j + n, ... in order and
// keeps one record. CTA q of a cluster holds W1's columns 64 q .. in shared
// memory for its life (no stream) and, a tile at a time,
//   1. converts the tile's P rows 16 q .. and stores them into every CTA's P;
//   2. computes X_q = P W1_q, its quarter of x, and the rows' partial
//      LayerNorm sums, which every CTA adds in rank order (distributed shared
//      memory, cluster barriers); the same for the backward's row means;
//   3. adds dW1's columns (dx_q^T P) into the cluster's record (each element
//      by the thread that holds it) and keeps its columns' db1, dscale and
//      dlnb in registers;
//   4. computes dpts's partial over its c1 quarter, dx_q W1_q^T, in 64-column
//      blocks: block b's partials go to CTA b % 4, which adds the four in rank
//      order and writes dpts.
// A tile's last cluster barrier (step 4) follows every CTA's last read of its
// P, dx and row sums, so the next tile may write them. Every sum has a fixed
// order: bit-identical across launches, no atomics.
__global__ void __cluster_dims__(kQuarters, 1, 1) __launch_bounds__(kThreads, 1)
prep_bwd_cluster(const float* __restrict__ pts, const uint16_t* __restrict__ dA,
                 long long n_rows, int in_dim, int c1, const uint16_t* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ scale, float radius,
                 float* __restrict__ dpts, float* __restrict__ records) {
  using F = Fold<kQW>;
  constexpr int NV = kQW / 2;  // accumulator values a thread
  const int KP = round16(in_dim);
  const ClusterLayout L(KP);
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* w1s = reinterpret_cast<uint16_t*>(smem + L.w1);
  uint16_t* ps = reinterpret_cast<uint16_t*>(smem + L.p);
  uint16_t* dxs = reinterpret_cast<uint16_t*>(smem + L.dx);
  float* slots = reinterpret_cast<float*>(smem + L.slots);
  float* lnx = reinterpret_cast<float*>(smem + L.lnx);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* bs = reinterpret_cast<float*>(smem + L.bs);
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  const uint32_t w1_base = smem_u32(w1s), p_base = smem_u32(ps), dx_base = smem_u32(dxs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g4;  // the thread's rows r0 and r0 + 8 of a tile
  const int q = (int)cluster_rank(), c0 = kQW * q;  // the CTA's first column of c1
  const int cl = blockIdx.x / kQuarters, n_cl = gridDim.x / kQuarters;
  float* rec = records + (size_t)cl * (in_dim + 3) * c1;

  // W1's quarter in its natural layout (rows = K, zero past in_dim), 16-byte
  // cp.async copies all in flight; bf16(b1) and scale of the quarter
  for (int i = tid; i < KP * kQW / 8; i += kThreads) {
    const int k = i / (kQW / 8), cb = i % (kQW / 8);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     w1_base + 2 * core_at(k, 8 * cb, kQW)),
                 "l"(w1 + (size_t)(k < in_dim ? k : 0) * c1 + c0 + 8 * cb),
                 "r"(k < in_dim ? 16 : 0));
  }
  for (int c = tid; c < kQW; c += kThreads) {
    bs[c] = bf16_round(b1[c0 + c]);
    ss[c] = scale[c0 + c];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  cluster_sync();  // every CTA of the cluster runs before any writes into a peer

  float run[3][F::NR];  // the quarter's db1, dscale and dlnb column sums
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < F::NR; ++i) run[k][i] = 0.f;

  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  int done = 0;
  for (long long tile = cl; tile < n_tiles; tile += n_cl, ++done) {
    const long long row0 = tile * kRows;
    const long long rows[2] = {row0 + r0, row0 + r0 + 8};

    // ---- 1. P rows 16 q .. + 16 (bf16, xyz divided by r) into every CTA's
    // P, a 16-byte core row at a time, all of a thread's loads in flight at
    // once (16 x 66 core rows at KP 528: 9 a thread)
    {
      constexpr int U = (kPRows * kClusterMaxKP / 8 + kThreads - 1) / kThreads;
      const int nk = KP / 8, n = kPRows * nk;
      for (int i0 = tid; i0 < n; i0 += U * kThreads) {
        float v[U][8];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * kThreads, r = kPRows * q + i / nk, k0 = 8 * (i % nk);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[u][e] = i < n && row0 + r < n_rows && k0 + e < in_dim
                          ? __ldg(pts + (row0 + r) * in_dim + k0 + e)
                          : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * kThreads, r = kPRows * q + i / nk, k0 = 8 * (i % nk);
          if (i >= n) break;
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lo = k0 + 2 * e < 3 ? v[u][2 * e] / radius : v[u][2 * e];
            const float hi = k0 + 2 * e + 1 < 3 ? v[u][2 * e + 1] / radius : v[u][2 * e + 1];
            w[e] = uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
                   (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
          }
          const uint32_t at = p_base + 2 * core_at(r, k0, KP);
#pragma unroll
          for (int d = 0; d < kQuarters; ++d)
            asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(peer(at, d)),
                         "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                         : "memory");
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    cluster_sync();  // the tile's P is whole in every CTA
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

    // ---- 2. X_q = P W1_q; x = bf16(bf16(X) + bf16(b1)); the rows' partial sums
    float xa[NV], ga[NV];
    {
      const uint32_t pb = opaque(p_base), wb = opaque(w1_base);
      wgmma_fence();
      for (int s = 0; s < KP / 16; ++s)  // W1's rows read MN-major
        wgmma_ss<kQW, 0, 1>(xa, make_desc(pb + 256 * s, 128, KP * 16),
                            make_desc(wb + s * 32 * kQW, kQW * 16, 128), s > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(xa);
    }
    // a row's sums of this CTA's columns into every CTA's slot q of `use`;
    // then the four slots added in rank order
    const auto exchange = [&](int use, float (&a)[2], float (&b)[2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
          a[h] += __shfl_xor_sync(0xffffffffu, a[h], m);
          b[h] += __shfl_xor_sync(0xffffffffu, b[h], m);
        }
        if (t4 == 0) {
          const uint32_t at = smem_u32(lnx + ((use * kQuarters + q) * kRows + r0 + 8 * h) * 2);
#pragma unroll
          for (int d = 0; d < kQuarters; ++d)
            asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(peer(at, d)),
                         "f"(a[h]), "f"(b[h])
                         : "memory");
        }
      }
      cluster_sync();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[h] = b[h] = 0.f;
#pragma unroll
        for (int d = 0; d < kQuarters; ++d) {
          const float2 v = *reinterpret_cast<const float2*>(
              lnx + ((use * kQuarters + d) * kRows + r0 + 8 * h) * 2);
          a[h] += v.x;
          b[h] += v.y;
        }
      }
    };
    float mean[2], rstd[2];
    {
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
        const float x = bf16_round(bf16_round(xa[i]) + bs[c]);
        xa[i] = x;
        s1[h] += x;
        s2[h] += x * x;
      }
      exchange(0, s1, s2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mean[h] = s1[h] / c1;
        rstd[h] = rsqrtf(fmaxf(s2[h] / c1 - mean[h] * mean[h], 0.f) + kEps);
      }
    }
    // xhat and the quarter's dA (every pair's load in flight before the first use)
    {
      uint32_t raw[NV / 2];
#pragma unroll
      for (int i = 0; i < NV; i += 2) {
        const int c = c0 + 8 * (i / 4) + 2 * t4;
        const long long row = rows[(i >> 1) & 1];
        raw[i / 2] =
            row < n_rows ? __ldg(reinterpret_cast<const unsigned int*>(dA + row * c1 + c)) : 0u;
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) xa[i] = (xa[i] - mean[(i >> 1) & 1]) * rstd[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < NV; i += 2) {
        ga[i] = bf16_bits(raw[i / 2] & 0xffffu);
        ga[i + 1] = bf16_bits(raw[i / 2] >> 16);
      }
    }
    // the backward's row means, dscale and dlnb; dx of the real columns, db1;
    // bf16(dx) to the quarter's dx tile
    {
      float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
        const float dxh = ga[i] * ss[c];
        m1[h] += dxh;
        m2[h] += dxh * xa[i];
      }
      fold_columns<kQW, true>(ga, xa, lane, run[1]);
      fold_columns<kQW, false>(ga, ga, lane, run[2]);
      exchange(1, m1, m2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m1[h] /= c1;
        m2[h] /= c1;
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
        ga[i] = rstd[h] * (ga[i] * ss[c] - m1[h] - xa[i] * m2[h]);
      }
      fold_columns<kQW, false>(ga, ga, lane, run[0]);
#pragma unroll
      for (int i = 0; i < NV; i += 2) {
        const int c = 8 * (i / 4) + 2 * t4, r = r0 + 8 * ((i >> 1) & 1);
        *reinterpret_cast<uint32_t*>(dxs + core_at(r, c, kQW)) = pack_bf16x2(ga[i], ga[i + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // ---- 3. dW1's columns: dW1_q^T += bf16(dx_q)^T P, 64 K columns at a
    // time, into the cluster's record; each block's record loads are issued a
    // block ahead, in flight while the last block's product runs and is
    // written (the last block's columns past KP read the next buffer and are
    // dropped)
    {
      // the thread's record elements of the block at n0 (0 at the first tile)
      const auto load_old = [&](int n0, float (&old)[32]) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = c0 + r0 + 8 * ((i >> 1) & 1), k = n0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          old[i] = done > 0 && k < in_dim ? rec[(size_t)k * c1 + c] : 0.f;
        }
      };
      float old[32];
      load_old(0, old);
      for (int n0 = 0; n0 < KP; n0 += 64) {
        float acc[32], next[32];
        wgmma_fence();
        wgmma_rows<64>(acc, opaque(dx_base), kQW, 0, opaque(p_base), KP, n0, 0);
        wgmma_commit();
        load_old(n0 + 64, next);
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = c0 + r0 + 8 * ((i >> 1) & 1), k = n0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          if (k < in_dim) rec[(size_t)k * c1 + c] = old[i] + acc[i];
          old[i] = next[i];
        }
      }
    }

    // ---- 4. dpts: the partial over the quarter, dx_q W1_q^T, a 64-column
    // block at a time into the slot q of the block's owner (rank b % 4); the
    // owner adds the four slots in rank order, four blocks a round
    const int nb = (in_dim + 63) / 64;
    for (int b0 = 0; b0 < nb; b0 += kQuarters) {
      for (int d = 0; d < kQuarters && b0 + d < nb; ++d) {
        float acc[32];
        // W1's rows 64 (b0 + d) .. read K-major (N = the rows; past KP the
        // next buffer's bytes, dropped)
        const uint32_t db = opaque(dx_base), wb = opaque(w1_base) + (8 * (b0 + d)) * kQW * 16;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kQW / 16; ++s)
          wgmma_ss<64, 0, 0>(acc, make_desc(db + 256 * s, 128, kQW * 16),
                             make_desc(wb + 256 * s, 128, kQW * 16), s > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t at = smem_u32(slots + (q * kRows + r0 + 8 * h) * 64 + 8 * j + 2 * t4);
            asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(peer(at, d)),
                         "f"(acc[4 * j + 2 * h]), "f"(acc[4 * j + 2 * h + 1])
                         : "memory");
          }
      }
      cluster_sync();  // the round's partials have landed
      if (b0 + q < nb) {
        // four columns a thread at a time, two such of each slot's loads in flight
        const int k0 = 64 * (b0 + q);
        for (int e0 = 4 * tid; e0 < kRows * 64; e0 += 2 * 4 * kThreads) {
          float4 v[2][kQuarters];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int d = 0; d < kQuarters; ++d)
              v[u][d] =
                  *reinterpret_cast<const float4*>(slots + d * kRows * 64 + e0 + u * 4 * kThreads);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = e0 + u * 4 * kThreads, r = e / 64;
            float sum[4] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w};
#pragma unroll
            for (int d = 1; d < kQuarters; ++d) {
              sum[0] += v[u][d].x;
              sum[1] += v[u][d].y;
              sum[2] += v[u][d].z;
              sum[3] += v[u][d].w;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int k = k0 + e % 64 + j;
              if (row0 + r < n_rows && k < in_dim)
                dpts[(row0 + r) * in_dim + k] = k < 3 ? sum[j] / radius : sum[j];
            }
          }
        }
      }
      cluster_sync();  // the slots are read: the next round or tile may fill them
    }
  }

  // ---- the column sums of the quarter: each warp its rows, then the four
  // warps in order
  if (col_owner<F::NVH>(lane)) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < F::NR; ++i)
        red[(warp * 3 + k) * kQW + F::column(i, lane, t4)] = run[k][i];
  }
  __syncthreads();
  for (int i = tid; i < 3 * kQW; i += kThreads) {
    const int k = i / kQW, c = i % kQW;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += red[(w * 3 + k) * kQW + c];
    rec[(size_t)in_dim * c1 + k * c1 + c0 + c] = s;
  }
}

// The clusters of a launch over `tiles` tiles: as many as the card holds at
// once (one CTA an SM), at most one a tile; 0 if it holds none.
int clusters(long long tiles, int in_dim) {
  const ClusterLayout L(round16(in_dim));
  if (L.total > (size_t)kMaxSharedBytes) return 0;
  if (cudaFuncSetAttribute(prep_bwd_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)L.total) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kQuarters * kSms, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = L.total;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, prep_bwd_cluster, &config) != cudaSuccess) return 0;
  return (int)(tiles < n ? tiles : n);
}

cudaError_t launch_cluster(const float* pts, const uint16_t* dA, long long n_rows, int in_dim,
                           int c1, const uint16_t* w1, const float* b1, const float* scale,
                           float radius, float* dpts, float* wout, float* records,
                           cudaStream_t s) {
  const long long tiles = (n_rows + kRows - 1) / kRows;
  const int n_cl = clusters(tiles, in_dim);  // also sets the shared memory size
  if (n_cl <= 0) return cudaErrorInvalidConfiguration;
  prep_bwd_cluster<<<(unsigned)(kQuarters * n_cl), kThreads, ClusterLayout(round16(in_dim)).total,
                     s>>>(pts, dA, n_rows, in_dim, c1, w1, b1, scale, radius, dpts, records);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P = (in_dim + 3) * c1;
  reduce_records<8><<<(P + 31) / 32, 256, 0, s>>>(records, n_cl, P, wout);
  return cudaGetLastError();
}

template <int C1P, bool HOLD, bool STREAM>
cudaError_t launch(const float* pts, const uint16_t* dA, long long n_rows, int in_dim, int c1,
                   int KC, const uint16_t* w1, const float* b1, const float* scale,
                   float radius, float* dpts, float* wout, float* records, cudaStream_t s) {
  const Layout L(round16(in_dim), KC, C1P, STREAM);
  cudaError_t err = cudaFuncSetAttribute(prep_bwd_tiles<C1P, HOLD, STREAM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return err;
  const int n_ctas = ctas(n_rows, in_dim, c1);
  prep_bwd_tiles<C1P, HOLD, STREAM><<<n_ctas, kThreads, L.total, s>>>(
      pts, dA, n_rows, in_dim, c1, KC, w1, b1, scale, radius, dpts, records);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P = (in_dim + 3) * c1;
  reduce_records<8><<<(P + 31) / 32, 256, 0, s>>>(records, n_ctas, P, wout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Records of the kernel for n_rows points (CTAs of the tile kernel, clusters
// of the cluster kernel; 0 if it cannot run): the wrapper gives each
// (in_dim + 3) * c1 floats.
int sa_prep_bwd_ctas(long long n_rows, int in_dim, int c1) { return ctas(n_rows, in_dim, c1); }

// Largest in_dim the kernel takes for this c1 (0 if c1 is unsupported).
int sa_prep_bwd_max_in_dim(int c1) { return c1 <= 0 || c1 > 256 ? 0 : kMaxInDim; }

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
  // the cluster kernel's 16-byte W1 and 4-byte dA loads and the batched
  // loads of the held c1-128 instance (16-byte points, 4-byte dA) need them
  // aligned (the wrapper sees to it)
  const bool hold = holds_dw1(in_dim, c1);
  if (cluster_route(in_dim, c1)) {
    if (misaligned(w1, 16) || misaligned(dA, 4)) return cudaErrorInvalidValue;
    return (int)launch_cluster(pts, g, n_rows, in_dim, c1, w, b1, scale, radius, dpts, wout,
                               records, s);
  }
  if (hold && c1_pad(c1) == 128 && (misaligned(pts, 16) || misaligned(dA, 4)))
    return cudaErrorInvalidValue;
  bool streamed = false;
  const int KC = k_chunk(in_dim, c1, streamed);
#define EDA_PREP_BWD(C1P)                                                                    \
  if (c1_pad(c1) == C1P)                                                                    \
    return hold       ? (int)launch<C1P, (C1P <= 128), false>(pts, g, n_rows, in_dim, c1, KC, \
                                                             w, b1, scale, radius, dpts,     \
                                                             wout, records, s)               \
           : streamed ? (int)launch<C1P, false, true>(pts, g, n_rows, in_dim, c1, KC, w, b1,  \
                                                      scale, radius, dpts, wout, records, s) \
                      : (int)launch<C1P, false, false>(pts, g, n_rows, in_dim, c1, KC, w, b1, \
                                                       scale, radius, dpts, wout, records, s);
  EDA_PREP_BWD(16)
  EDA_PREP_BWD(32)
  EDA_PREP_BWD(64)
  EDA_PREP_BWD(128)
  EDA_PREP_BWD(256)
#undef EDA_PREP_BWD
  return cudaErrorInvalidValue;
}

}  // extern "C"
