// Fused SA layer-0 prep forward on Hopper's tensor cores:
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
//   3. products accumulated in f32 (wgmma; bf16 x bf16 products are exact),
//      the sum rounded once to bf16;
//   4. + bf16(b1), rounded to bf16;
//   5. one-pass LayerNorm stats in f32 over the c1 real channels, eps 1e-5;
//   6. scale and bias in f32, written as bf16.
// The prep backward (sa_prep_bwd.cu) recomputes x with the same wgmma
// product.
//
// Bound on this card: bytes. Per point it reads (3 + C) f32 and writes c1
// bf16: at batch 8, SA1 (400 000 points, 24 B in, 128 B out) 60.8 MB, 0.018
// ms at 3.35 TB/s; its 2 (3 + C) c1 flops a point are far below the
// tensor-core peak.
//
// Design: a persistent grid of one-warpgroup CTAs over tiles of 64 points
// (the wgmma M), as many CTAs as fit on the card, each walking tiles
// blockIdx.x, + gridDim.x, ...
//   * Copies are bulk copies (TMA, 1D) where they can be: one request moves a
//     whole contiguous block and reports to an mbarrier, so a CTA's copies
//     do not queue up as 16-byte requests do (with 16-byte cp.async copies
//     the prologue was most of a CTA's time at SA2-4).
//   * W1 is staged once per CTA in the no-swizzle core layout with rows = K,
//     which wgmma reads as an MN-major B operand: one bulk copy lands it
//     row-major in a ring stage, and each thread moves 16-byte chunks (8
//     columns of a row, one core row) into place. Padding rows (K up to a
//     multiple of 16) and columns (c1 up to 16/32/64/128/256) are zero.
//     Where W1 does not fit a stage, 16-byte cp.async copies go straight into
//     the core layout.
//   * A tile's points are 64 * in_dim contiguous f32: one bulk copy each,
//     into a ring of raw stages (two where the tiles are many), so the next
//     tiles' points are in flight while this tile computes. From the ring
//     each thread converts core rows of 8 K values (xyz / r, bf16) into the P
//     tile, a K-major A operand, neighbouring threads on neighbouring rows.
//     Where the ring does not fit beside W1 (large in_dim at wide c1), and for
//     a ragged last tile whose bytes are no multiple of 16, the P tile is
//     converted straight from device memory, in K chunks if need be.
//   * X = P W1 runs as wgmma over up to 128 columns a chunk (c1 = 256: two
//     chunks); x = bf16(bf16(X) + bf16(b1)) in the accumulator layout, its
//     row sums and sums of squares reduced over the quad by two shuffles,
//     x kept packed as bf16 in registers.
//   * The normalized rows go, 64 columns at a time, through a shared stage
//     (16-byte chunks XOR-swizzled by row, so the quads' writes do not
//     conflict) and out as coalesced 16-byte stores; the ragged last tile is
//     masked. The stage shares its bytes with the P tile, which is free once
//     the tile's products are done.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // points per tile (the wgmma M)
constexpr float kEps = 1e-5f;
constexpr int kMaxSharedBytes = 232448;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }
__host__ __device__ constexpr int c1_pad(int c1) {
  return c1 <= 16 ? 16 : c1 <= 32 ? 32 : c1 <= 64 ? 64 : c1 <= 128 ? 128 : 256;
}
// columns of the output stage: 64, or all of them below
__host__ __device__ constexpr int piece_cols(int C1P) { return C1P < 64 ? C1P : 64; }

// The shared buffers of a CTA: W1 (KP x C1P, rows = K), bf16(b1), scale and
// lnb (f32), with a ring its stages' mbarriers and `ring` raw stages of a
// tile's points (64 x in_dim f32 each), and the P tile (64 x KC bf16), whose
// bytes the output stage (64 x piece_cols bf16) reuses.
struct Layout {
  size_t w1, prm, bars, raw, stage, p, total;
  __host__ __device__ Layout(int in_dim, int KC, int C1P, int ring) {
    size_t o = 0;
    w1 = o;    o += align128((size_t)round16(in_dim) * C1P * 2);
    prm = o;   o += align128((size_t)3 * C1P * 4);
    bars = o;  o += ring > 0 ? 128 : 0;
    raw = o;   stage = align128((size_t)kRows * in_dim * 4);  o += ring * stage;
    p = o;
    const size_t pb = (size_t)kRows * KC * 2, ob = (size_t)kRows * piece_cols(C1P) * 2;
    o += align128(pb > ob ? pb : ob);
    total = o;
  }
};

bool fits(int in_dim, int c1, int KC, int ring) {
  return Layout(in_dim, KC, c1_pad(c1), ring).total <= (size_t)kMaxSharedBytes;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes from global to shared
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int C1P>
__global__ void __launch_bounds__(kThreads)
sa_prep_kernel(const float* __restrict__ pts, long long n_rows, int in_dim, int c1, int KC,
               int ring, bool vec, const uint16_t* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ scale,
               const float* __restrict__ lnb, float radius, uint16_t* __restrict__ out) {
  constexpr int CW = C1P < 128 ? C1P : 128;  // columns of one product
  constexpr int NCH = C1P / CW;
  constexpr int NV = CW / 2;                 // accumulator values a thread
  constexpr int PW = piece_cols(C1P);        // columns of the output stage
  constexpr int PQ = PW / 8;                 // its 16-byte chunks a row
  const int KP = round16(in_dim);
  const int nkc = (KP + KC - 1) / KC;        // K chunks of the P tile
  const Layout L(in_dim, KC, C1P, ring);

  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* w1s = reinterpret_cast<uint16_t*>(smem + L.w1);
  uint16_t* ps = reinterpret_cast<uint16_t*>(smem + L.p);
  uint16_t* os = ps;  // the output stage, once the tile's products are done
  float* bs = reinterpret_cast<float*>(smem + L.prm);
  float* ss = bs + C1P;
  float* ls = ss + C1P;
  const uint32_t w1_base = smem_u32(w1s), p_base = smem_u32(ps);
  const uint32_t raw_base = smem_u32(smem + L.raw);
  const float* raw = reinterpret_cast<const float*>(smem + L.raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g4;  // the thread's rows r0 and r0 + 8 of a tile
  const long long n_tiles = (n_rows + kRows - 1) / kRows;

  // a ring stage's bulk copy has landed: one mbarrier a stage, and the
  // parity of its next phase (bit s)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint32_t parity = 0;
  auto bar = [&](int st) { return smem_u32(&bars[st]); };
  auto stage_wait = [&](int st) {
    bulk_wait(bar(st), (parity >> st) & 1u);
    parity ^= 1u << st;
  };
  if (tid == 0) {
    for (int st = 0; st < ring; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar(st)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // W1, zero padded. With a ring, where W1 fits a stage and its rows are
  // 16-byte aligned (vec: c1 % 8 == 0), one bulk copy lands it row-major in
  // stage 0 and the threads move its 16-byte chunks into the core layout;
  // else 16-byte cp.async copies straight into the core layout (vec), row k
  // and chunk q of copy i = k q1 + q stepped without a division; else element
  // by element.
  const int q1 = c1 / 8;
  const uint32_t w1_bytes = (uint32_t)in_dim * c1 * 2;
  const bool w1_bulk = ring > 0 && vec && w1_bytes <= L.stage;
  if (vec) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < (KP - in_dim) * (C1P / 8); i += kThreads)  // padding rows
      *reinterpret_cast<uint4*>(w1s + core_at(in_dim + i / (C1P / 8), 8 * (i % (C1P / 8)),
                                              C1P)) = zero;
    const int qp = C1P / 8 - q1;  // padding chunks of the real rows
    for (int i = tid; i < in_dim * qp; i += kThreads)
      *reinterpret_cast<uint4*>(w1s + core_at(i / qp, 8 * (q1 + i % qp), C1P)) = zero;
  }
  const int sk = kThreads / (q1 > 0 ? q1 : 1), sq = kThreads % (q1 > 0 ? q1 : 1);
  if (w1_bulk) {
    if (tid == 0) bulk_copy(raw_base, w1, w1_bytes, bar(0));
    stage_wait(0);
    const uint4* rows = reinterpret_cast<const uint4*>(raw);
    for (int k = tid / q1, q = tid % q1; k < in_dim;) {
      *reinterpret_cast<uint4*>(w1s + core_at(k, 8 * q, C1P)) = rows[k * q1 + q];
      k += sk;
      q += sq;
      if (q >= q1) {
        q -= q1;
        ++k;
      }
    }
    __syncthreads();  // stage 0 is read: the tiles may land there
  } else if (vec) {
    for (int k = tid / q1, q = tid % q1; k < in_dim;) {
      cp_async16(smem_u32(w1s + core_at(k, 8 * q, C1P)), w1 + (size_t)k * c1 + 8 * q);
      k += sk;
      q += sq;
      if (q >= q1) {
        q -= q1;
        ++k;
      }
    }
  } else {
    for (int i = tid; i < KP * C1P; i += kThreads) {
      const int k = i / C1P, n = i - k * C1P;
      w1s[core_at(k, n, C1P)] = (k < in_dim && n < c1) ? w1[(size_t)k * c1 + n] : uint16_t(0);
    }
  }
  cp_async_commit();

  // A tile's points come by one bulk copy into ring stage `st` when their
  // bytes are a multiple of 16 (all tiles but a ragged last one, which is
  // converted from device memory); issued by thread 0.
  auto bulk_tile = [&](long long tile) {
    return tile < n_tiles && ((n_rows - tile * kRows < kRows ? n_rows - tile * kRows : kRows) *
                              in_dim) % 4 == 0;
  };
  auto fetch = [&](long long tile, int st) {
    if (tid == 0 && bulk_tile(tile)) {
      const long long row0 = tile * kRows;
      const long long rows = n_rows - row0 < kRows ? n_rows - row0 : kRows;
      bulk_copy(raw_base + (uint32_t)(st * L.stage), pts + row0 * in_dim,
                (uint32_t)(rows * in_dim * 4), bar(st));
    }
  };
  for (int st = 0; st < ring; ++st) fetch(blockIdx.x + (long long)st * gridDim.x, st);
  // the vectors, while the copies are in flight
  for (int c = tid; c < C1P; c += kThreads) {
    bs[c] = c < c1 ? bf16_round(b1[c]) : 0.f;
    ss[c] = c < c1 ? scale[c] : 0.f;
    ls[c] = c < c1 ? lnb[c] : 0.f;
  }

  // One 16-byte core row of the P tile: the 8 K values v of row r from
  // column 8 kq of the chunk (k0 its first), xyz divided by r, as bf16.
  auto put = [&](int r, int kq, int k0, float (&v)[8]) {
    if (k0 + kq == 0) {
#pragma unroll
      for (int e = 0; e < 3; ++e) v[e] = __fdiv_rn(v[e], radius);
    }
    *reinterpret_cast<uint4*>(ps + core_at(r, 8 * kq, KC)) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                   pack_bf16x2(v[6], v[7]));
  };
  // The P tile's K columns [k0, k0 + KC), zero past in_dim and past the real
  // rows, from the ring stage `slot` (k0 = 0) or from device memory; a thread
  // writes whole core rows, neighbouring threads on neighbouring rows (an odd
  // in_dim puts their loads in distinct banks).
  auto convert_raw = [&](long long row0, int slot) {
    const float* src = raw + (size_t)slot * (L.stage / 4);
    for (int i = tid; i < kRows * (KC / 8); i += kThreads) {
      const int r = i % kRows, kq = i / kRows;
      const bool live = row0 + r < n_rows;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = 8 * kq + e;
        v[e] = live && k < in_dim ? src[r * in_dim + k] : 0.f;
      }
      put(r, kq, 0, v);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };
  auto convert_global = [&](long long row0, int k0) {
    const float* src = pts + row0 * in_dim;
    for (int i = tid; i < kRows * (KC / 8); i += kThreads) {
      const int r = i % kRows, kq = i / kRows;
      const bool live = row0 + r < n_rows;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + 8 * kq + e;
        v[e] = live && k < in_dim ? __ldg(src + (size_t)r * in_dim + k) : 0.f;
      }
      put(r, kq, k0, v);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  int slot = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;
    if (ring > 0) {
      cp_async_wait_all();  // W1's copies, where they were not one bulk copy
      if (bulk_tile(tile)) {
        stage_wait(slot);  // this tile's points have landed; the next stay in flight
        convert_raw(row0, slot);
      } else {
        convert_global(row0, 0);
      }
      fetch(tile + (long long)ring * gridDim.x, slot);  // the stage is free again
      slot = slot + 1 == ring ? 0 : slot + 1;
    } else {
      cp_async_wait_all();
      __syncthreads();
      if (nkc == 1) convert_global(row0, 0);
    }

    // ---- x = bf16(bf16(P W1) + bf16(b1)) a chunk of CW columns at a time,
    // kept packed as bf16; the LayerNorm's row sums
    uint32_t xs[NCH][NV / 2];
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      float acc[NV];
      for (int kc = 0; kc < nkc; ++kc) {
        if (nkc > 1) convert_global(row0, kc * KC);
        const uint32_t pb = opaque(p_base);
        const uint32_t wb = opaque(w1_base) + (ch * CW / 8) * 128 + kc * KC * C1P * 2;
        wgmma_fence();
        for (int s = 0; s < KC / 16; ++s)
          wgmma_ss<CW, 0, 1>(acc, make_desc(pb + 256 * s, 128, KC * 16),
                             make_desc(wb + s * 32 * C1P, C1P * 16, 128), kc > 0 || s > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if (nkc > 1) __syncthreads();  // the chunk is read: the next may replace it
      }
#pragma unroll
      for (int i = 0; i < NV; i += 2) {
        const int c = ch * CW + 8 * (i / 4) + 2 * t4, h = (i >> 1) & 1;
        const float2 b = *reinterpret_cast<const float2*>(bs + c);
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[e] = bf16_round(bf16_round(acc[i + e]) + (e ? b.y : b.x));
          s1[h] += x[e];
          s2[h] += x[e] * x[e];
        }
        xs[ch][i / 2] = pack_bf16x2(x[0], x[1]);
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
      mean[h] = __fdiv_rn(s1[h], (float)c1);
      rstd[h] = rsqrtf(fmaxf(__fdiv_rn(s2[h], (float)c1) - mean[h] * mean[h], 0.f) + kEps);
    }
    if (nkc == 1) __syncthreads();  // every warp's products have read the P tile

    // ---- the normalized rows, PW columns at a time, through the stage
#pragma unroll
    for (int pc = 0; pc < C1P / PW; ++pc) {
      if (pc * PW >= c1) continue;  // uniform: c1 is the CTA's
#pragma unroll
      for (int jj = 0; jj < PW / 8; ++jj) {
        const int j = pc * (PW / 8) + jj;  // n8 block of the row
        const int ch = j / (CW / 8), jc = j % (CW / 8);
        const int c = 8 * j + 2 * t4;
        const float2 sc = *reinterpret_cast<const float2*>(ss + c);
        const float2 lb = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t v = xs[ch][2 * jc + h];
          const float y0 = (__uint_as_float(v << 16) - mean[h]) * rstd[h] * sc.x + lb.x;
          const float y1 = (__uint_as_float(v & 0xffff0000u) - mean[h]) * rstd[h] * sc.y + lb.y;
          const int r = r0 + 8 * h;
          const int q = jj ^ (r & (PQ - 1));
          *reinterpret_cast<uint32_t*>(os + r * PW + 8 * q + 2 * t4) = pack_bf16x2(y0, y1);
        }
      }
      __syncthreads();
      for (int i = tid; i < kRows * PQ; i += kThreads) {
        const int r = i / PQ, q = i - r * PQ, col = pc * PW + 8 * q;
        if (row0 + r >= n_rows || col >= c1) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(os + r * PW + 8 * (q ^ (r & (PQ - 1))));
        uint16_t* dst = out + (row0 + r) * c1 + col;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col + e < c1) dst[e] = uint16_t(wv[e / 2] >> (16 * (e & 1)));
        }
      }
      __syncthreads();  // the stage (and the P tile) is rewritten next
    }
  }
}

// The largest K chunk of the P tile that fits without a ring: a divisor of
// KP, so that no chunk reads W1 rows past its end
int k_chunk(int in_dim, int c1) {
  const int KP = round16(in_dim);
  int KC = KP;
  while (KC > 16 && (KP % KC || !fits(in_dim, c1, KC, 0))) KC -= 16;
  return KC;
}

// The ring stages and K chunk of a launch: the whole P tile, and two raw
// stages where the tiles are many (SA1: the copies of later tiles overlap
// this one's work), one where they are few (more CTAs fit an SM); without
// room for a stage, the P tile straight from device memory, in K chunks if
// it does not fit whole.
void plan(long long n_rows, int in_dim, int c1, int sms, int& KC, int& ring) {
  const long long tiles = (n_rows + kRows - 1) / kRows;
  KC = round16(in_dim);
  for (ring = tiles > 4LL * sms ? 2 : 1; ring > 0; --ring)
    if (fits(in_dim, c1, KC, ring)) return;
  KC = k_chunk(in_dim, c1);
}

template <int C1P>
cudaError_t launch(const float* pts, long long n_rows, int in_dim, int c1,
                   const uint16_t* w1, const float* b1, const float* scale, const float* lnb,
                   float radius, uint16_t* out, cudaStream_t s) {
  int dev = 0, sms = 0, KC = 0, ring = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  plan(n_rows, in_dim, c1, sms, KC, ring);
  // the ring's 16-byte copies need 16-byte aligned points; W1's and A's
  // rows are 16-byte aligned where c1 % 8 == 0
  if ((reinterpret_cast<uintptr_t>(pts) & 15) && ring > 0) {
    ring = 0;
    KC = k_chunk(in_dim, c1);
  }
  const bool vec = c1 % 8 == 0 && !(reinterpret_cast<uintptr_t>(w1) & 15) &&
                   !(reinterpret_cast<uintptr_t>(out) & 15);
  const size_t smem = Layout(in_dim, KC, C1P, ring).total;
  err = cudaFuncSetAttribute(sa_prep_kernel<C1P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sa_prep_kernel<C1P>, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (n_rows + kRows - 1) / kRows;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int ctas = (int)(tiles < cap ? tiles : cap);
  sa_prep_kernel<C1P><<<ctas, kThreads, smem, s>>>(pts, n_rows, in_dim, c1, KC, ring, vec, w1,
                                                   b1, scale, lnb, radius, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest in_dim the kernel takes for this c1 (0 if c1 is unsupported).
int sa_prep_max_in_dim(int c1) {
  if (c1 <= 0 || c1 > 256) return 0;
  int in_dim = 3;
  while (fits(in_dim + 1, c1, 16, 0)) ++in_dim;
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
  const auto* w = static_cast<const uint16_t*>(w1);
  auto* o = static_cast<uint16_t*>(out);
#define EDA_PREP(C1P)  \
  if (c1_pad(c1) == C1P) \
    return launch<C1P>(pts, n_rows, in_dim, c1, w, b1, scale, lnb, radius, o, s);
  EDA_PREP(16)
  EDA_PREP(32)
  EDA_PREP(64)
  EDA_PREP(128)
  EDA_PREP(256)
#undef EDA_PREP
  return cudaErrorInvalidValue;
}

}  // extern "C"
