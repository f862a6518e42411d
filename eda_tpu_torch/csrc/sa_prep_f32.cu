// Fused SA layer-0 prep in f32, forward and backward, on Hopper:
//   A = LN([xyz/r ; f] @ W1 + b1) -> f32
//
// Replaces the TPU kernels eda_tpu/ops/pallas/sa_prep.py:_prep_fwd and
// _prep_bwd at dtype=float32 (bodies _fwd_kernel and _bwd_kernel), which the
// model reaches with ModelConfig(use_bf16=False). The TPU kernel's 128-lane
// padding of A and its xyz copy are TPU DMA layouts: A keeps its width c1.
//
// Rounding points, as the plain version and the TPU kernel at f32:
//   1. xyz / r as an IEEE f32 division;
//   2. x = [xyz/r ; f] @ W1 as f32 products: f32 FMAs in K order (the FMA
//      route), or 3xTF32 on the tensor cores (each operand split into
//      hi = tf32(v) and lo = tf32(v - hi), hi lo + lo hi + hi hi summed in
//      f32, wgmma.cuh), within a few f32 ulps of the f32 product where one
//      TF32 product would round the operands to 10 bits; then + b1 in f32;
//   3. one-pass LayerNorm statistics over the c1 channels (mean = S1 / c1,
//      var = max(S2 / c1 - mean^2, 0), eps 1e-5), 1 / sqrt(var + eps) in IEEE;
//   4. (x - mean) * rstd * scale + lnb in f32.
// The backward recomputes x the same way, takes dA in f32 unrounded, and
// returns dpts, dW1, db1, dscale and dlnb with
//   dx = rstd (g scale - m1 - xhat m2),  m1 = mean(g scale),
//   m2 = mean(g scale xhat),  dpts = dx W1^T (its xyz columns / r),
//   dW1 = [xyz/r ; f]^T dx,
// its products as the forward's (f32 FMAs, or 3xTF32).
//
// Bound on this card. At batch 8 of the flagship, SA1 (400 000 points, in_dim
// 6, c1 64) is bound by bytes: 102 MB of A out forward, 121 MB moved backward
// (0.031 / 0.036 ms at 3.35 TB/s). SA2-4 (16 384 / 8 192 / 4 096 points,
// in_dim 131 / 259 / 259, c1 128) are bound by their products: a true-f32
// product runs fastest as three TF32 products (495 TFLOP/s, ~165 effective).
//
// Design: a persistent grid of one-warpgroup CTAs over tiles of 64 rows, the
// tile-to-CTA assignment a function of the row count only (tile blockIdx.x,
// + gridDim.x, ...), so that every sum has a fixed order and every output is
// bit-identical across launches.
//   * A tile's points (64 x in_dim f32, contiguous) and, backward, its dA rows
//     come by bulk copies (TMA, 1D) counted by an mbarrier, into a ring of
//     stages (two where they fit beside the rest and the CTA has more than one
//     tile, so the next tile's loads overlap this one's math). A ragged last
//     tile whose bytes are no multiple of 16, or an unaligned pointer, is
//     copied by the threads instead.
//   * A tile's output (A, or dpts) goes from its stage in shared memory to
//     device memory by one bulk store, coalesced whatever the width.
//   * FMA route (in_dim <= 8: SA1's widths, where it measured faster than the
//     tensor route; and c1 above 128): each quad of threads owns two rows at
//     a time, each thread 4-column chunks of them; W1 (8 x c1) sits in shared
//     memory; the LayerNorm statistics and the dpts sums close over the quad
//     by two shuffles. Backward, dx and g xhat go to shared tiles, and one
//     column pass adds dW1 (in registers across the CTA's tiles) and db1,
//     dscale, dlnb over the tile's rows in row order.
//   * Tensor route (in_dim > 8, c1 <= 128: SA2-4): a prologue kernel splits
//     W1 into TF32 hi / lo once per launch, in the layouts the products read,
//     into a small buffer in device memory (split_w1); its chunks stream
//     through a second ring (two to four stages) from L2, so any in_dim up to
//     the points' stage fits (645 forward, 391 backward at c1 128), or stay
//     in the ring when a tile's chunks all fit it. Per tile:
//       X = P W1: A = P from registers (read from the tile's stage, xyz / r,
//         split), B the K-major W1^T chunks of 32 K values; the next chunk's
//         A fragments are built while a chunk's products run. The LayerNorm
//         in the accumulator layout (quad shuffles); forward, A to the stage
//         and out.
//       Backward: the LayerNorm backward in the same layout, a column half at
//         a time (g read from the stage twice, never held whole beside xhat);
//         dscale, dlnb and db1 as column sums folded in registers across tiles
//         (wgmma.cuh); dx split and stored transposed into shared memory (its
//         hi half over the consumed dA). dW1 = P^T dx per 64-row block of
//         k_in, A = P^T from registers, B = dx^T, added to the CTA's own
//         record in tile order (float2 rows, whole sectors). dpts = dx W1^T
//         per 64 k_in columns, A = dx read back from dx^T, B the W1 chunks,
//         into the points' stage and out.
//     No (rows, c1) intermediate goes to device memory.
//   * reduce_records (wgmma.cuh) adds the CTAs' records in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr int kThreads = 128;          // one warpgroup
constexpr int kRows = 64;              // rows a tile (the wgmma M)
constexpr int kChunk = 32;             // K values of an X chunk
constexpr int kDRows = 64;             // k_in rows of a dpts chunk
constexpr int kFmaMaxIn = 8;           // in_dim of the FMA route
constexpr int kMaxRing = 4;            // W1 chunk stages
constexpr float kEps = 1e-5f;
constexpr int kMaxSharedBytes = 232448;
constexpr size_t kSmBytes = 233472;    // shared memory of an SM
constexpr int kSms = 132;              // grid sizes are a function of the rows only

__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }
__host__ __device__ constexpr int round64(int n) { return (n + 63) / 64 * 64; }
// columns of a dpts chunk: c1 (padded) up to 64, else half of it
__host__ __device__ constexpr int dpts_cols(int CP) { return CP < 64 ? CP : 64; }
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ constexpr int c1_pad(int c1) {
  return c1 <= 16 ? 16 : c1 <= 32 ? 32 : c1 <= 64 ? 64 : c1 <= 128 ? 128 : 256;
}

// Shared memory of the tensor route: mbarriers (tiles, then W1 chunks);
// b1, scale (and forward lnb); T tile stages (points, then dA, whose bytes
// take dx^T hi; forward, the points' bytes take A out); dx^T lo; R W1 chunk
// stages (hi and lo of an X chunk, 32 K values by CP, or of a dpts chunk, 64
// k_in rows by dpts_cols(CP)).
struct TcLayout {
  size_t bars, vec, tiles, pbytes, tstage, dxlo, wring, wstage, total;
  __host__ __device__ TcLayout(int in_dim, int c1, int CP, bool bwd, int T, int R) {
    size_t o = 0;
    bars = o;   o += 64;
    vec = o;    o += (size_t)(bwd ? 2 : 3) * CP * 4;
    pbytes = align16((size_t)kRows * in_dim * 4);
    const size_t ab = (size_t)kRows * (bwd ? CP : c1) * 4;
    tstage = bwd ? pbytes + ab : (pbytes > ab ? pbytes : ab);
    tiles = o;  o += T * tstage;
    dxlo = o;   o += bwd ? (size_t)kRows * CP * 4 : 0;
    wstage = (size_t)8 * kDRows * dpts_cols(CP);  // at least an X chunk's 8 kChunk CP
    wring = o;  o += R * wstage;
    total = o;
  }
};

// Shared memory of the FMA route: mbarriers; W1 (8 x CP); b1, scale, lnb; T
// tile stages (points, then dA); two output stages; backward the scaled
// points, dx and g xhat of the tile.
struct FmaLayout {
  size_t bars, w1, vec, tiles, pbytes, tstage, outs, ostage, ps, dxs, gxs, total;
  __host__ __device__ FmaLayout(int in_dim, int c1, int CP, bool bwd, int T) {
    size_t o = 0;
    bars = o;   o += 64;
    w1 = o;     o += (size_t)kFmaMaxIn * CP * 4;
    vec = o;    o += (size_t)3 * CP * 4;
    pbytes = align16((size_t)kRows * in_dim * 4);
    tstage = pbytes + (bwd ? align16((size_t)kRows * c1 * 4) : 0);
    tiles = o;  o += T * tstage;
    ostage = align16((size_t)kRows * (bwd ? in_dim : c1) * 4);
    outs = o;   o += 2 * ostage;
    ps = o;     o += bwd ? (size_t)kRows * kFmaMaxIn * 4 : 0;
    dxs = o;    o += bwd ? (size_t)kRows * CP * 4 : 0;
    gxs = o;    o += bwd ? (size_t)kRows * CP * 4 : 0;
    total = o;
  }
};

// W1 split into TF32 hi / lo in the layouts of the tensor route's products,
// zero past in_dim and c1, in whole chunks (so that every chunk's products
// are one unconditional sequence), each chunk its hi then its lo part in the
// K-major TF32 core layout:
//   X chunks q: K values 32 q .. 32 q + 32, CP rows (c) x 32 columns (k);
//   backward, then dpts chunks (b, h), b-major: k_in rows 64 b .. 64 b + 64 x
//     DC = dpts_cols(CP) columns (c from DC h).
// One thread a destination float, so that the stores coalesce.
__global__ void split_w1(const float* __restrict__ w1, int in_dim, int c1, int CP, int bwd,
                         float* __restrict__ dst) {
  const int DC = dpts_cols(CP), n1 = 2 * CP * round32(in_dim);
  const int n = n1 + (bwd ? 2 * CP * round64(in_dim) : 0);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    int k, c, lo;
    if (i < n1) {
      const int q = i / (2 * kChunk * CP);
      int off = i - q * 2 * kChunk * CP;
      lo = off >= kChunk * CP;
      off -= lo * kChunk * CP;
      const int core = off >> 5;
      c = (core / (kChunk / 4)) * 8 + ((off & 31) >> 2);
      k = kChunk * q + (core % (kChunk / 4)) * 4 + (off & 3);
    } else {
      const int e = i - n1, q = e / (2 * kDRows * DC), b = q / (CP / DC), h = q % (CP / DC);
      int off = e - q * 2 * kDRows * DC;
      lo = off >= kDRows * DC;
      off -= lo * kDRows * DC;
      const int core = off >> 5;
      k = kDRows * b + (core / (DC / 4)) * 8 + ((off & 31) >> 2);
      c = DC * h + (core % (DC / 4)) * 4 + (off & 3);
    }
    const float v = (k < in_dim && c < c1) ? w1[(size_t)k * c1 + c] : 0.f;
    uint32_t hi, lw;
    tf32_split(v, hi, lw);
    dst[i] = __uint_as_float(lo ? lw : hi);
  }
}

// The sum over a quad (lanes 4 g .. 4 g + 3) of each lane's v, the same in
// every lane of the quad.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// mean and 1 / sqrt(var + eps) from a row's sum and sum of squares over c
// channels (rc = RN(1 / c); div_real divides correctly rounded)
__device__ __forceinline__ void ln_stats(float s1, float s2, float c, float rc, float& mean,
                                         float& rstd) {
  mean = div_real(s1, c, rc);
  const float var = fmaxf(div_real(s2, c, rc) - mean * mean, 0.f);
  rstd = 1.f / sqrtf(var + kEps);
}

// The tile ring both routes share: its mbarriers and parities, and the fetch
// of a tile by bulk copies (or by the threads).
struct Tiles {
  const float* pts;
  const float* dA;
  long long n_rows;
  int my_tiles, in_dim, c1, T;
  bool bulk, bwd;
  unsigned char* stages;
  size_t pbytes, tstage;
  uint64_t* bars;  // a stage's rows landed: bars[st]
  uint32_t parity = 0;

  __device__ long long tile(int it) const { return blockIdx.x + (long long)it * gridDim.x; }
  __device__ int rows(long long tile) const {
    return (int)min((long long)kRows, n_rows - tile * kRows);
  }
  __device__ float* stage(int st) const {
    return reinterpret_cast<float*>(stages + st * tstage);
  }
  __device__ float* dA_stage(int st) const { return stage(st) + pbytes / 4; }
  __device__ bool by_bulk(long long tile) const {
    const int nr = rows(tile);
    return bulk && (nr * in_dim) % 4 == 0 && (!bwd || (nr * c1) % 4 == 0);
  }
  __device__ uint32_t bar(int st) const { return smem_u32(&bars[st]); }

  // thread 0: the CTA's tile `it` into stage st by bulk copies
  __device__ void fetch(int it, int st) const {
    if (it >= my_tiles) return;
    const long long t = tile(it);
    if (!by_bulk(t)) return;
    const int nr = rows(t);
    const uint32_t pb = (uint32_t)nr * in_dim * 4, gb = bwd ? (uint32_t)nr * c1 * 4 : 0u;
    bulk_expect(bar(st), pb + gb);
    bulk_load(smem_u32(stage(st)), pts + t * kRows * in_dim, pb, bar(st));
    if (bwd) bulk_load(smem_u32(dA_stage(st)), dA + t * kRows * c1, gb, bar(st));
  }

  // all threads: the tile `it` has landed in stage st
  __device__ void arrive(int it, int st) {
    const long long t = tile(it);
    if (by_bulk(t)) {
      bulk_wait(bar(st), (parity >> st) & 1u);
      parity ^= 1u << st;
      return;
    }
    const int nr = rows(t);
    float* P = stage(st);
    const float* src = pts + t * kRows * in_dim;
    for (int i = threadIdx.x; i < nr * in_dim; i += kThreads) P[i] = src[i];
    if (bwd) {
      float* G = dA_stage(st);
      const float* gs = dA + t * kRows * c1;
      for (int i = threadIdx.x; i < nr * c1; i += kThreads) G[i] = gs[i];
    }
    __syncthreads();
  }
};

// All threads, after writing `count` floats of a tile's output to the stage
// O: one bulk store to dst where it can be (thread 0), else copies.
__device__ __forceinline__ void store_tile(const float* O, float* dst, int count, bool bulk) {
  fence_async();
  __syncthreads();
  if (bulk && count % 4 == 0) {
    if (threadIdx.x == 0) bulk_store(dst, smem_u32(O), (uint32_t)count * 4);
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = O[i];
    __syncthreads();
  }
}

// ---- tensor route

template <int CP, bool BWD>
__global__ void __launch_bounds__(kThreads, 1)
prep_tc(const float* __restrict__ pts, const float* __restrict__ dA, long long n_rows,
        int in_dim, int c1, const float* __restrict__ wsplit, const float* __restrict__ b1,
        const float* __restrict__ scale, const float* __restrict__ lnb, float radius, int T,
        int R, bool bulk, float* __restrict__ out, float* __restrict__ records) {
  constexpr int NV = CP / 2;               // accumulator values a thread
  constexpr int FH = CP > 64 ? 2 : 1;      // column halves of the LayerNorm backward
  constexpr int FW = CP / FH;              // and their width
  using F = Fold<FW>;
  constexpr int DC = dpts_cols(CP);        // columns of a dpts chunk
  const int nX = round32(in_dim) / kChunk;  // W1 chunks of X
  const int nB = round64(in_dim) / kDRows;  // k_in blocks of dpts, CP / DC chunks each
  const int NQ = BWD ? nX + nB * (CP / DC) : nX;  // W1 chunks a tile
  const TcLayout L(in_dim, c1, CP, BWD, T, R);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* bs = reinterpret_cast<float*>(smem + L.vec);
  float* ss = bs + CP;
  float* ls = ss + CP;  // forward
  float* dxlo = reinterpret_cast<float*>(smem + L.dxlo);
  const uint32_t wring = smem_u32(smem + L.wring);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g4;  // the thread's rows r0 and r0 + 8 of a tile
  const float rr = 1.f / radius, fc1 = (float)c1, rc1 = 1.f / fc1;
  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  Tiles tl{pts, dA, n_rows, (int)((n_tiles - 1 - blockIdx.x) / gridDim.x) + 1, in_dim, c1, T,
           bulk, BWD, smem + L.tiles, L.pbytes, L.tstage, bars};
  float* rec = BWD ? records + (size_t)blockIdx.x * (in_dim + 3) * c1 : nullptr;

  // The W1 ring: the CTA's chunks in order (each tile's NQ, X then dpts), the
  // k-th in stage k % R. Thread 0 issues them (pj, pit: the next chunk to
  // issue and its tile; pst its stage); the threads take them (wst, wpar).
  // Where a tile's NQ chunks fit the ring (R == NQ) they are issued once and
  // stay: chunk j in stage j for every tile.
  const bool resident = R == NQ;
  int pj = 0, pit = 0, pst = 0, wst = 0;
  uint32_t wpar = 0;
  auto issue_chunk = [&]() {
    if (pit >= (resident ? 1 : tl.my_tiles)) return;
    const bool x = pj < nX;
    const uint32_t bytes = x ? 8u * kChunk * CP : 8u * kDRows * DC;
    const size_t off = x ? (size_t)2 * kChunk * CP * pj
                         : (size_t)2 * kChunk * CP * nX + (size_t)2 * kDRows * DC * (pj - nX);
    bulk_copy(wring + (uint32_t)pst * (uint32_t)L.wstage, wsplit + off, bytes,
              smem_u32(&bars[T + pst]));
    pst = pst + 1 == R ? 0 : pst + 1;
    if (++pj == NQ) {
      pj = 0;
      ++pit;
    }
  };
  // all threads: the next chunk has landed; returns its stage's address
  auto take_chunk = [&]() {
    bulk_wait(smem_u32(&bars[T + wst]), (wpar >> wst) & 1u);
    if (!resident) wpar ^= 1u << wst;
    return wring + (uint32_t)wst * (uint32_t)L.wstage;
  };
  // after every warp's products read the chunk taken last: its stage takes
  // the chunk R further on
  auto release_chunk = [&]() {
    if (resident) {  // phase 0 of every stage stays complete
      wst = wst + 1 == R ? 0 : wst + 1;
      return;
    }
    __syncthreads();
    wst = wst + 1 == R ? 0 : wst + 1;
    if (tid == 0) issue_chunk();
  };

  if (tid == 0) {
    for (int i = 0; i < T + R; ++i) mbar_init(smem_u32(&bars[i]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < CP; c += kThreads) {
    bs[c] = c < c1 ? b1[c] : 0.f;
    ss[c] = c < c1 ? scale[c] : 0.f;
    if (!BWD) ls[c] = c < c1 ? lnb[c] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < T; ++i) tl.fetch(i, i);
    for (int i = 0; i < R; ++i) issue_chunk();
  }

  float run[FH][3][F::NR];  // backward: column sums of db1, dscale, dlnb per column half
#pragma unroll
  for (int hh = 0; hh < FH; ++hh)
#pragma unroll
    for (int v = 0; v < 3; ++v)
#pragma unroll
      for (int i = 0; i < F::NR; ++i) run[hh][v][i] = 0.f;

  for (int it = 0, st = 0; it < tl.my_tiles; ++it, st = st + 1 == T ? 0 : st + 1) {
    const long long tile = tl.tile(it), row0 = tile * kRows;
    const int nr = tl.rows(tile);
    tl.arrive(it, st);
    float* P = tl.stage(st);
    // [xyz/r ; f] at (row r of the tile, column k), zero past the rows and
    // in_dim; branch-free, so that a fragment's loads issue back to back
    auto pval = [&](int r, int k) {
      const bool on = r < nr && k < in_dim;
      const float v = P[on ? r * in_dim + k : 0];
      return on ? (k < 3 ? div_real(v, radius, rr) : v) : 0.f;
    };

    // ---- X = P W1, 3xTF32, a W1 chunk of 32 K values at a time; forward,
    // the next chunk's A fragments are built while this chunk's products run
    // (the backward has no registers to spare for a second set)
    float acc[NV];
    uint32_t fa[2][2][4][4];  // [buffer][hi, lo][k8 step][register]
    auto build = [&](uint32_t (&f)[2][4][4], int q) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = kChunk * q + 8 * s + t4;
        tf32_split(pval(r0, k), f[0][s][0], f[1][s][0]);
        tf32_split(pval(r0 + 8, k), f[0][s][1], f[1][s][1]);
        tf32_split(pval(r0, k + 4), f[0][s][2], f[1][s][2]);
        tf32_split(pval(r0 + 8, k + 4), f[0][s][3], f[1][s][3]);
      }
    };
    auto products = [&](uint32_t (&f)[2][4][4], uint32_t (&next)[2][4][4], int q) {
      const uint32_t wb = opaque(take_chunk());
      const uint32_t lo = (uint32_t)CP * kChunk * 4;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_tf32x3<CP>(acc, f[0][s], f[1][s], make_desc(wb + 256 * s, 128, kChunk * 32),
                         make_desc(wb + lo + 256 * s, 128, kChunk * 32), q > 0 || s > 0);
      wgmma_commit();
      if (!BWD && q + 1 < nX) build(next, q + 1);
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        fence_regs(f[0][s]);
        fence_regs(f[1][s]);
      }
      release_chunk();
    };
    if constexpr (BWD) {
      for (int q = 0; q < nX; ++q) {
        build(fa[0], q);
        products(fa[0], fa[0], q);
      }
    } else {
      build(fa[0], 0);
      for (int q = 0; q < nX; q += 2) {
        products(fa[0], fa[1], q);
        if (q + 1 < nX) products(fa[1], fa[0], q + 1);
      }
    }

    // ---- x = X + b1; the LayerNorm statistics by quad shuffles
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
      const float x = acc[i] + bs[c];
      acc[i] = x;
      s1[h] += x;
      s2[h] += x * x;
    }
    float mean[2], rstd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ln_stats(quad_sum(s1[h]), quad_sum(s2[h]), fc1, rc1, mean[h], rstd[h]);
    const bool pair = !(c1 & 1);

    if constexpr (!BWD) {
      __syncthreads();  // every warp has read its points: the stage takes A
      float* O = P;
#pragma unroll
      for (int i = 0; i < NV; i += 2) {
        const int c = 8 * (i / 4) + 2 * t4, h = (i >> 1) & 1, r = r0 + 8 * h;
        if (r >= nr || c >= c1) continue;
        const float y0 = (acc[i] - mean[h]) * rstd[h] * ss[c] + ls[c];
        const float y1 = (acc[i + 1] - mean[h]) * rstd[h] * ss[c + 1] + ls[c + 1];
        float* o = O + r * c1 + c;
        if (pair) {
          *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
        } else {
          o[0] = y0;
          if (c + 1 < c1) o[1] = y1;
        }
      }
      store_tile(O, out + row0 * c1, nr * c1, bulk);
      if (tid == 0) {
        bulk_store_read_wait<0>();
        tl.fetch(it + T, st);
      }
    } else {
      // ---- the LayerNorm backward in the accumulator layout, a half of the
      // columns at a time: g = dA read from the stage twice (once for the
      // column sums of dscale and dlnb and the row means m1, m2; once for dx),
      // so that it is never held whole beside xhat; acc <- xhat <- dx
      const float* G = tl.dA_stage(st);
      auto load_g = [&](float (&gh)[FW / 2], int hh) {
#pragma unroll
        for (int i = 0; i < FW / 2; i += 2) {
          const int c = FW * hh + 8 * (i / 4) + 2 * t4, r = r0 + 8 * ((i >> 1) & 1);
          float v0 = 0.f, v1 = 0.f;
          if (r < nr && c < c1) {
            const float* p = G + r * c1 + c;
            if (pair) {
              const float2 v = *reinterpret_cast<const float2*>(p);
              v0 = v.x;
              v1 = v.y;
            } else {
              v0 = p[0];
              if (c + 1 < c1) v1 = p[1];
            }
          }
          gh[i] = v0;
          gh[i + 1] = v1;
        }
      };
      auto half = [&](int hh) -> float (&)[FW / 2] {
        return *reinterpret_cast<float (*)[FW / 2]>(&acc[FW / 2 * hh]);
      };
      float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < FH; ++hh) {
        float gh[FW / 2];
        load_g(gh, hh);
        float (&xh)[FW / 2] = half(hh);
#pragma unroll
        for (int i = 0; i < FW / 2; ++i) {
          const int c = FW * hh + 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
          xh[i] = (xh[i] - mean[h]) * rstd[h];
          const float dxh = gh[i] * ss[c];
          m1[h] += dxh;
          m2[h] += dxh * xh[i];
        }
        fold_columns<FW, true>(gh, xh, lane, run[hh][1]);
        fold_columns<FW, false>(gh, gh, lane, run[hh][2]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m1[h] = div_real(quad_sum(m1[h]), fc1, rc1);
        m2[h] = div_real(quad_sum(m2[h]), fc1, rc1);
      }
#pragma unroll
      for (int hh = 0; hh < FH; ++hh) {
        float gh[FW / 2];
        load_g(gh, hh);
        float (&xh)[FW / 2] = half(hh);
#pragma unroll
        for (int i = 0; i < FW / 2; ++i) {  // xhat <- dx, zero past c1
          const int c = FW * hh + 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
          xh[i] = c < c1 ? rstd[h] * (gh[i] * ss[c] - m1[h] - xh[i] * m2[h]) : 0.f;
        }
        fold_columns<FW, false>(xh, xh, lane, run[hh][0]);
      }

      // ---- dx^T (CP x 64, K-major over the tile's rows), hi over dA, lo apart
      __syncthreads();  // every warp has read its dA
      float* dxhi = tl.dA_stage(st);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = 8 * (i / 4) + 2 * t4 + (i & 1), r = r0 + 8 * ((i >> 1) & 1);
        const int off = ((c >> 3) * (kRows / 4) + (r >> 2)) * 32 + (c & 7) * 4 + (r & 3);
        uint32_t hi, lo;
        tf32_split(acc[i], hi, lo);
        dxhi[off] = __uint_as_float(hi);
        dxlo[off] = __uint_as_float(lo);
      }
      fence_async();
      __syncthreads();

      // ---- dW1 (k_in x c) = P^T dx over the tile's rows, a 64-row block of
      // k_in at a time, into the CTA's record in tile order
      const uint32_t dh = smem_u32(dxhi), dl = smem_u32(dxlo);
      for (int m0 = 0; m0 < in_dim; m0 += 64) {
        const int ka = m0 + r0;  // the fragment's k_in rows ka and ka + 8
        float aw[NV];
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int r = 8 * (4 * half + s) + t4;
            tf32_split(pval(r, ka), ah[s][0], al[s][0]);
            tf32_split(pval(r, ka + 8), ah[s][1], al[s][1]);
            tf32_split(pval(r + 4, ka), ah[s][2], al[s][2]);
            tf32_split(pval(r + 4, ka + 8), ah[s][3], al[s][3]);
          }
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t o = (4 * half + s) * 256;
            wgmma_tf32x3<CP>(aw, ah[s], al[s], make_desc(opaque(dh) + o, 128, 2048),
                             make_desc(opaque(dl) + o, 128, 2048), half > 0 || s > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(aw);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            fence_regs(ah[s]);
            fence_regs(al[s]);
          }
        }
        // the thread's pairs of columns as float2, so that a warp's accesses
        // cover whole 32-byte sectors (eight rows of 8 columns); a row's
        // earlier sums all loaded before any store
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (ka + 8 * h >= in_dim) continue;
          float* row = rec + (size_t)(ka + 8 * h) * c1;
          float2 o[NV / 4];
#pragma unroll
          for (int j = 0; j < NV / 4; ++j) {
            const int c = 8 * j + 2 * t4;
            o[j] = make_float2(0.f, 0.f);
            if (it > 0 && c < c1) {
              if (pair) {
                o[j] = *reinterpret_cast<const float2*>(row + c);
              } else {
                o[j].x = row[c];
                if (c + 1 < c1) o[j].y = row[c + 1];
              }
            }
          }
#pragma unroll
          for (int j = 0; j < NV / 4; ++j) {
            const int c = 8 * j + 2 * t4;
            if (c >= c1) continue;
            const float2 v = make_float2(o[j].x + aw[4 * j + 2 * h], o[j].y + aw[4 * j + 2 * h + 1]);
            if (pair) {
              *reinterpret_cast<float2*>(row + c) = v;
            } else {
              row[c] = v.x;
              if (c + 1 < c1) row[c + 1] = v.y;
            }
          }
        }
      }

      // ---- dpts = dx W1^T, a block of 64 k_in columns at a time over its
      // CP / DC chunks, into the points' stage; A = dx, its split halves read
      // back from dx^T, GK k8 steps at a time
      __syncthreads();  // every warp has read its points: the stage takes dpts
      float* D = P;
      constexpr int GK = DC / 8 < 4 ? DC / 8 : 4;
      for (int b = 0; b < nB; ++b) {
        float ad[kDRows / 2];
#pragma unroll
        for (int h = 0; h < CP / DC; ++h) {
          const uint32_t wb = opaque(take_chunk());
          const uint32_t lo = (uint32_t)kDRows * DC * 4;
#pragma unroll
          for (int s0 = 0; s0 < DC / 8; s0 += GK) {
            // A's (row, k) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of k8 step s
            uint32_t fh[GK][4], fl[GK][4];
#pragma unroll
            for (int s = 0; s < GK; ++s)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int c = DC * h + 8 * (s0 + s) + t4 + 4 * (j >> 1), r = r0 + 8 * (j & 1);
                const int off = ((c >> 3) * (kRows / 4) + (r >> 2)) * 32 + (c & 7) * 4 + (r & 3);
                fh[s][j] = __float_as_uint(dxhi[off]);
                fl[s][j] = __float_as_uint(dxlo[off]);
              }
            wgmma_fence();
#pragma unroll
            for (int s = 0; s < GK; ++s)
              wgmma_tf32x3<kDRows>(ad, fh[s], fl[s], make_desc(wb + 256 * (s0 + s), 128, DC * 32),
                                   make_desc(wb + lo + 256 * (s0 + s), 128, DC * 32),
                                   h > 0 || s0 + s > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(ad);
#pragma unroll
            for (int s = 0; s < GK; ++s) {
              fence_regs(fh[s]);
              fence_regs(fl[s]);
            }
          }
          release_chunk();
        }
#pragma unroll
        for (int i = 0; i < kDRows / 2; ++i) {
          const int k = kDRows * b + 8 * (i / 4) + 2 * t4 + (i & 1);
          const int r = r0 + 8 * ((i >> 1) & 1);
          if (r < nr && k < in_dim) D[r * in_dim + k] = k < 3 ? div_real(ad[i], radius, rr) : ad[i];
        }
      }
      store_tile(D, out + row0 * in_dim, nr * in_dim, bulk);
      if (tid == 0) {
        bulk_store_read_wait<0>();
        tl.fetch(it + T, st);
      }
    }
  }

  if constexpr (BWD) {
    // the column sums: each warp its rows, then the four warps in order
    float* red = dxlo;  // free once the tiles are done
    __syncthreads();
    if (col_owner<F::NVH>(lane)) {
#pragma unroll
      for (int hh = 0; hh < FH; ++hh)
#pragma unroll
        for (int v = 0; v < 3; ++v)
#pragma unroll
          for (int i = 0; i < F::NR; ++i)
            red[(warp * 3 + v) * CP + FW * hh + F::column(i, lane, t4)] = run[hh][v][i];
    }
    __syncthreads();
    for (int i = tid; i < 3 * c1; i += kThreads) {
      const int v = i / c1, c = i % c1;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) s += red[(w * 3 + v) * CP + c];
      rec[(size_t)in_dim * c1 + i] = s;
    }
  }
  if (tid == 0) bulk_store_wait();
}

// ---- FMA route

// n floats (1, 2, 4 or 8) from 16-byte-aligned shared memory
template <int n>
__device__ __forceinline__ void load_floats(float (&v)[n], const float* p) {
  if constexpr (n == 1) {
    v[0] = p[0];
  } else if constexpr (n == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < n; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      v[i] = a.x;
      v[i + 1] = a.y;
      v[i + 2] = a.z;
      v[i + 3] = a.w;
    }
  }
}

template <int CP, bool BWD>
__global__ void __launch_bounds__(kThreads)
prep_fma(const float* __restrict__ pts, const float* __restrict__ dA, long long n_rows,
         int in_dim, int c1, const float* __restrict__ w1, const float* __restrict__ b1,
         const float* __restrict__ scale, const float* __restrict__ lnb, float radius, int T,
         bool bulk, float* __restrict__ out, float* __restrict__ records) {
  constexpr int K = kFmaMaxIn;
  constexpr int NI = CP / 16;                       // 4-column chunks a thread owns in a row
  constexpr int ROWS = CP <= 128 ? 2 : 1;           // rows a thread computes at once
  constexpr int CW = CP < kThreads ? CP : kThreads; // columns a column pass covers at once
  constexpr int KG = K * CW / kThreads;             // dW1 rows (k) a thread sums
  constexpr int NCC = CP / CW;                      // columns a thread sums
  const FmaLayout L(in_dim, c1, CP, BWD, T);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* w1s = reinterpret_cast<float*>(smem + L.w1);
  float* bs = reinterpret_cast<float*>(smem + L.vec);
  float* ss = bs + CP;
  float* ls = ss + CP;
  float* ps = reinterpret_cast<float*>(smem + L.ps);
  float* dxs = reinterpret_cast<float*>(smem + L.dxs);
  float* gxs = reinterpret_cast<float*>(smem + L.gxs);

  const int tid = threadIdx.x, qd = tid >> 2, q = tid & 3;
  const int pc = tid % CW, pk = (tid / CW) * KG;  // the column passes' column and first k
  const float rr = 1.f / radius, fc1 = (float)c1, rc1 = 1.f / fc1;
  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  Tiles tl{pts, dA, n_rows, (int)((n_tiles - 1 - blockIdx.x) / gridDim.x) + 1, in_dim, c1, T,
           bulk, BWD, smem + L.tiles, L.pbytes, L.tstage, bars};
  const int W = BWD ? in_dim : c1;  // output floats a row
  const bool vec4 = !(c1 & 3);

  if (tid == 0) {
    for (int i = 0; i < T; ++i) mbar_init(smem_u32(&bars[i]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < K * CP; i += kThreads) {
    const int k = i / CP, c = i % CP;
    w1s[i] = (k < in_dim && c < c1) ? w1[(size_t)k * c1 + c] : 0.f;
  }
  for (int c = tid; c < CP; c += kThreads) {
    bs[c] = c < c1 ? b1[c] : 0.f;
    ss[c] = c < c1 ? scale[c] : 0.f;
    ls[c] = (!BWD && c < c1) ? lnb[c] : 0.f;
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < T; ++i) tl.fetch(i, i);

  float accw[NCC][KG], vsum[3][NCC];  // backward: dW1 (pk + j, pc + CW cc); db1, dscale, dlnb
#pragma unroll
  for (int cc = 0; cc < NCC; ++cc) {
#pragma unroll
    for (int j = 0; j < KG; ++j) accw[cc][j] = 0.f;
#pragma unroll
    for (int v = 0; v < 3; ++v) vsum[v][cc] = 0.f;
  }

  for (int it = 0, st = 0; it < tl.my_tiles; ++it, st = st + 1 == T ? 0 : st + 1) {
    const long long tile = tl.tile(it), row0 = tile * kRows;
    const int nr = tl.rows(tile);
    tl.arrive(it, st);
    const float* P = tl.stage(st);
    const float* G = tl.dA_stage(st);
    if (tid == 0) bulk_store_read_wait<1>();  // the output stage's store two tiles ago
    __syncthreads();
    float* O = reinterpret_cast<float*>(smem + L.outs + (it & 1) * L.ostage);

    // the quad's rows qd and qd + 32, ROWS at once: the thread's columns
    // 16 i + 4 q + e of each
#pragma unroll 1
    for (int r1 = 0; r1 < 2; r1 += ROWS) {
      int rw[ROWS];
      bool live[ROWS];
      float p[ROWS][K];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        rw[u] = qd + 32 * (r1 + u);
        live[u] = rw[u] < nr;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          p[u][k] = (live[u] && k < in_dim) ? P[rw[u] * in_dim + k] : 0.f;
          if (k < 3) p[u][k] = div_real(p[u][k], radius, rr);
        }
        if (BWD && q == 0) {
          float4* pr = reinterpret_cast<float4*>(ps + rw[u] * K);
          pr[0] = make_float4(p[u][0], p[u][1], p[u][2], p[u][3]);
          pr[1] = make_float4(p[u][4], p[u][5], p[u][6], p[u][7]);
        }
      }
      // x = [xyz/r ; f] W1 + b1, FMAs in K order
      float x[ROWS][NI][4];
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[u][i][e] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k >= in_dim) break;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const float4 w = *reinterpret_cast<const float4*>(w1s + k * CP + 16 * i + 4 * q);
#pragma unroll
          for (int u = 0; u < ROWS; ++u) {
            x[u][i][0] = __fmaf_rn(p[u][k], w.x, x[u][i][0]);
            x[u][i][1] = __fmaf_rn(p[u][k], w.y, x[u][i][1]);
            x[u][i][2] = __fmaf_rn(p[u][k], w.z, x[u][i][2]);
            x[u][i][3] = __fmaf_rn(p[u][k], w.w, x[u][i][3]);
          }
        }
      }
      float mean[ROWS], rstd[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const float4 b = *reinterpret_cast<const float4*>(bs + 16 * i + 4 * q);
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[u][i][e] += bv[e];
            s1 += x[u][i][e];
            s2 += x[u][i][e] * x[u][i][e];
          }
        }
        ln_stats(quad_sum(s1), quad_sum(s2), fc1, rc1, mean[u], rstd[u]);
      }

      if constexpr (!BWD) {
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int c = 16 * i + 4 * q;
          const float4 sc4 = *reinterpret_cast<const float4*>(ss + c);
          const float4 lb4 = *reinterpret_cast<const float4*>(ls + c);
          const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w}, lb[4] = {lb4.x, lb4.y, lb4.z, lb4.w};
#pragma unroll
          for (int u = 0; u < ROWS; ++u) {
            if (!live[u] || c >= c1) continue;
            float y[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) y[e] = (x[u][i][e] - mean[u]) * rstd[u] * sc[e] + lb[e];
            float* o = O + rw[u] * c1 + c;
            if (vec4) {
              *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (c + e < c1) o[e] = y[e];
            }
          }
        }
      } else {
        // g = dA; xhat; the row means m1, m2; dx (in x's place) and g xhat to
        // the tile's shared copies
        float g[ROWS][NI][4], m1[ROWS], m2[ROWS];
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          m1[u] = m2[u] = 0.f;
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const int c = 16 * i + 4 * q;
            if (live[u] && vec4 && c < c1) {
              const float4 v = *reinterpret_cast<const float4*>(G + rw[u] * c1 + c);
              g[u][i][0] = v.x;
              g[u][i][1] = v.y;
              g[u][i][2] = v.z;
              g[u][i][3] = v.w;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                g[u][i][e] = (live[u] && c + e < c1) ? G[rw[u] * c1 + c + e] : 0.f;
            }
            const float4 sc4 = *reinterpret_cast<const float4*>(ss + c);
            const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              x[u][i][e] = (x[u][i][e] - mean[u]) * rstd[u];  // xhat
              const float dxh = g[u][i][e] * sc[e];
              m1[u] += dxh;
              m2[u] += dxh * x[u][i][e];
            }
          }
          m1[u] = div_real(quad_sum(m1[u]), fc1, rc1);
          m2[u] = div_real(quad_sum(m2[u]), fc1, rc1);
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const int c = 16 * i + 4 * q;
            const float4 sc4 = *reinterpret_cast<const float4*>(ss + c);
            const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
            float gx[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              gx[e] = g[u][i][e] * x[u][i][e];
              x[u][i][e] = c + e < c1
                               ? rstd[u] * (g[u][i][e] * sc[e] - m1[u] - x[u][i][e] * m2[u])
                               : 0.f;  // x <- dx
            }
            *reinterpret_cast<float4*>(dxs + rw[u] * CP + c) =
                make_float4(x[u][i][0], x[u][i][1], x[u][i][2], x[u][i][3]);
            *reinterpret_cast<float4*>(gxs + rw[u] * CP + c) =
                make_float4(gx[0], gx[1], gx[2], gx[3]);
          }
        }
        // dpts[k] = sum_c dx[c] W1[k][c]: the thread's columns in order, then the quad
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k >= in_dim) break;
          float d[ROWS];
#pragma unroll
          for (int u = 0; u < ROWS; ++u) d[u] = 0.f;
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const float4 w = *reinterpret_cast<const float4*>(w1s + k * CP + 16 * i + 4 * q);
#pragma unroll
            for (int u = 0; u < ROWS; ++u) {
              d[u] = __fmaf_rn(x[u][i][0], w.x, d[u]);
              d[u] = __fmaf_rn(x[u][i][1], w.y, d[u]);
              d[u] = __fmaf_rn(x[u][i][2], w.z, d[u]);
              d[u] = __fmaf_rn(x[u][i][3], w.w, d[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < ROWS; ++u) {
            const float v = quad_sum(d[u]);
            if (live[u] && (k & 3) == q)
              O[rw[u] * in_dim + k] = k < 3 ? div_real(v, radius, rr) : v;
          }
        }
      }
    }

    store_tile(O, out + row0 * W, nr * W, bulk);  // backward: also orders dx and g xhat
    if constexpr (BWD) {
      // dW1 (pk + j, pc + CW cc) and, for the first CW threads, db1, dscale,
      // dlnb of column pc + CW cc: the tile's rows in order, their loads
      // RB rows at a time (a row past nr adds an exact zero)
      constexpr int RB = 4;
      for (int rb = 0; rb < nr; rb += RB) {
        float pv[RB][KG], d[RB][NCC], gx[RB][NCC], ga[RB][NCC];
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          const int r = rb + u;
          const bool on = r < nr;
          load_floats(pv[u], ps + (on ? r : 0) * K + pk);
#pragma unroll
          for (int cc = 0; cc < NCC; ++cc) {
            const int c = pc + CW * cc;
            d[u][cc] = on ? dxs[r * CP + c] : 0.f;
            gx[u][cc] = on && tid < CW ? gxs[r * CP + c] : 0.f;
            ga[u][cc] = on && tid < CW && c < c1 ? G[r * c1 + c] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < RB; ++u)
#pragma unroll
          for (int cc = 0; cc < NCC; ++cc) {
#pragma unroll
            for (int j = 0; j < KG; ++j) accw[cc][j] = __fmaf_rn(pv[u][j], d[u][cc], accw[cc][j]);
            vsum[0][cc] += d[u][cc];
            vsum[1][cc] += gx[u][cc];
            vsum[2][cc] += ga[u][cc];
          }
      }
      __syncthreads();  // the stage and the tiles are read
    }
    if (tid == 0) tl.fetch(it + T, st);
  }

  if constexpr (BWD) {
    float* rec = records + (size_t)blockIdx.x * (in_dim + 3) * c1;
#pragma unroll
    for (int cc = 0; cc < NCC; ++cc) {
      const int c = pc + CW * cc;
      if (c >= c1) continue;
#pragma unroll
      for (int j = 0; j < KG; ++j)
        if (pk + j < in_dim) rec[(size_t)(pk + j) * c1 + c] = accw[cc][j];
      if (tid < CW)
#pragma unroll
        for (int v = 0; v < 3; ++v) rec[(size_t)(in_dim + v) * c1 + c] = vsum[v][cc];
    }
  }
  if (tid == 0) bulk_store_wait();
}

// ---- launch plans

// The route, widths and rings of a launch; a function of the rows and the
// widths only (so are the grid and with it every sum's order).
struct Plan {
  bool tc = false;
  int CP = 0, T = 0, R = 0, grid = 0;
  size_t smem = 0;
};

int per_sm(size_t smem, int cap) {
  return std::max(1, std::min(cap, (int)(kSmBytes / (smem + 1024))));
}

bool make_plan(long long n_rows, int in_dim, int c1, bool bwd, Plan& p) {
  if (n_rows < 1 || in_dim < 3 || c1 < 1 || c1 > 256) return false;
  const long long tiles = (n_rows + kRows - 1) / kRows;
  p.CP = c1_pad(c1);
  if (in_dim <= kFmaMaxIn) {
    p.tc = false;
    p.R = 0;
    for (p.T = bwd ? 2 : 4; p.T >= 1; --p.T) {
      p.smem = FmaLayout(in_dim, c1, p.CP, bwd, p.T).total;
      if (p.smem <= (size_t)kMaxSharedBytes) {
        p.grid = (int)std::min(tiles, (long long)kSms * per_sm(p.smem, 4));
        return true;
      }
    }
    return false;
  }
  if (c1 > 128) return false;
  p.tc = true;
  const int nq = round32(in_dim) / kChunk +                 // W1 chunks a tile
                 (bwd ? round64(in_dim) / kDRows * (p.CP / dpts_cols(p.CP)) : 0);
  for (p.T = tiles > kSms ? 2 : 1; p.T >= 1; --p.T)
    for (p.R = std::min(kMaxRing, nq); p.R >= std::min(2, nq); --p.R) {
      p.smem = TcLayout(in_dim, c1, p.CP, bwd, p.T, p.R).total;
      if (p.smem <= (size_t)kMaxSharedBytes) {
        p.grid = (int)std::min(tiles, (long long)kSms * per_sm(p.smem, 2));
        return true;
      }
    }
  return false;
}

// Floats of the split W1 (tensor route) and the CTAs' records (backward).
long long split_floats(const Plan& p, int in_dim, bool bwd) {
  return p.tc ? 2LL * p.CP * (round32(in_dim) + (bwd ? round64(in_dim) : 0)) : 0;
}

bool aligned(const void* p) { return !(reinterpret_cast<uintptr_t>(p) & 15); }

template <int CP, bool BWD>
cudaError_t launch(const Plan& p, const float* pts, const float* dA, long long n_rows,
                   int in_dim, int c1, const float* w1, const float* b1, const float* scale,
                   const float* lnb, float radius, float* out, float* wout, float* scratch,
                   cudaStream_t s) {
  const bool bulk = aligned(pts) && aligned(out) && (!BWD || aligned(dA));
  float* records = scratch + split_floats(p, in_dim, BWD);
  cudaError_t err = cudaSuccess;
  if constexpr (CP <= 128) {
    if (p.tc) {
      const long long n = split_floats(p, in_dim, BWD);
      const int blocks = (int)std::min((n + 255) / 256, 2LL * kSms);
      split_w1<<<blocks, 256, 0, s>>>(w1, in_dim, c1, CP, BWD, scratch);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      err = cudaFuncSetAttribute(prep_tc<CP, BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)p.smem);
      if (err != cudaSuccess) return err;
      prep_tc<CP, BWD><<<p.grid, kThreads, p.smem, s>>>(pts, dA, n_rows, in_dim, c1, scratch,
                                                        b1, scale, lnb, radius, p.T, p.R, bulk,
                                                        out, records);
    }
  }
  if (!p.tc) {
    err = cudaFuncSetAttribute(prep_fma<CP, BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
    if (err != cudaSuccess) return err;
    prep_fma<CP, BWD><<<p.grid, kThreads, p.smem, s>>>(pts, dA, n_rows, in_dim, c1, w1, b1,
                                                       scale, lnb, radius, p.T, bulk, out,
                                                       records);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (BWD) {
    const int P = (in_dim + 3) * c1;
    reduce_records<8><<<(P + 31) / 32, 256, 0, s>>>(records, p.grid, P, wout);
    err = cudaGetLastError();
  }
  return err;
}

template <bool BWD>
cudaError_t dispatch(const float* pts, const float* dA, long long n_rows, int in_dim, int c1,
                     const float* w1, const float* b1, const float* scale, const float* lnb,
                     float radius, float* out, float* wout, float* scratch, cudaStream_t s) {
  Plan p;
  if (!make_plan(n_rows, in_dim, c1, BWD, p)) return cudaErrorInvalidValue;
  if (p.tc && !aligned(scratch)) return cudaErrorInvalidValue;
#define EDA_PREP_F32(W)                                                                  \
  if (p.CP == W)                                                                         \
    return launch<W, BWD>(p, pts, dA, n_rows, in_dim, c1, w1, b1, scale, lnb, radius, out, \
                          wout, scratch, s);
  EDA_PREP_F32(16)
  EDA_PREP_F32(32)
  EDA_PREP_F32(64)
  EDA_PREP_F32(128)
  EDA_PREP_F32(256)
#undef EDA_PREP_F32
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest in_dim the forward (bwd = 0) or the backward (bwd = 1) takes at this
// c1: the tensor route's, whose points' stage grows with in_dim, up to c1
// 128; the FMA route's 8 above; 0 if c1 is unsupported.
int sa_prep_f32_max_in_dim(int c1, int bwd) {
  if (c1 < 1 || c1 > 256) return 0;
  Plan p;
  int in_dim = kFmaMaxIn;
  while (make_plan(1, in_dim + 1, c1, bwd, p)) ++in_dim;
  return in_dim;
}

// Floats of a launch's scratch: the split W1 (tensor route), then the CTAs'
// records (backward).
long long sa_prep_f32_scratch(long long n_rows, int in_dim, int c1, int bwd) {
  Plan p;
  if (!make_plan(n_rows, in_dim, c1, bwd, p)) return 0;
  return split_floats(p, in_dim, bwd) + (bwd ? (long long)p.grid * (in_dim + 3) * c1 : 0);
}

// pts: (n_rows, in_dim) f32; w1: (in_dim, c1) f32; b1/scale/lnb: (c1,) f32;
// out: (n_rows, c1) f32; scratch: sa_prep_f32_scratch(n_rows, in_dim, c1, 0)
// floats. Returns cudaGetLastError().
int sa_prep_f32_launch(const float* pts, long long n_rows, int in_dim, int c1,
                       const float* w1, const float* b1, const float* scale, const float* lnb,
                       float radius, float* out, float* scratch, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  return dispatch<false>(pts, nullptr, n_rows, in_dim, c1, w1, b1, scale, lnb, radius, out,
                         nullptr, scratch, static_cast<cudaStream_t>(stream));
}

// pts: (n_rows, in_dim) f32; dA: (n_rows, c1) f32; w1: (in_dim, c1) f32;
// b1/scale: (c1,) f32. Outputs: dpts (n_rows, in_dim) f32; wout (in_dim c1 +
// 3 c1) f32 = [dW1 (in_dim, c1); db1; dscale; dlnb]. Scratch:
// sa_prep_f32_scratch(n_rows, in_dim, c1, 1) floats. Returns cudaGetLastError().
int sa_prep_bwd_f32_launch(const float* pts, const float* dA, long long n_rows, int in_dim,
                           int c1, const float* w1, const float* b1, const float* scale,
                           float radius, float* dpts, float* wout, float* scratch,
                           void* stream) {
  if (n_rows <= 0) return cudaErrorInvalidValue;
  return dispatch<true>(pts, dA, n_rows, in_dim, c1, w1, b1, scale, nullptr, radius, dpts,
                        wout, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
