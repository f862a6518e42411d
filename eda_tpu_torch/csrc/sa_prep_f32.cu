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
// The width-2 backbone's SA2-4 (in_dim 259 / 515 / 515, c1 256) do 5.4 GFLOP
// of such products a forward, three times that a backward.
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
//   * Tensor route (in_dim > 8, c1 up to 256: SA2-4; the forward above c1
//     128 on clusters, below): a prologue kernel splits W1 into TF32 hi / lo
//     once per launch, in the layouts the products read, into a small
//     buffer in device memory (split_w1); its chunks stream through a second
//     ring (two to four stages) from L2, so any in_dim up to the points'
//     stage fits (645 forward, 391 backward at c1 128), or stay in the ring
//     when a tile's chunks all fit it. Per tile:
//       X = P W1: A = P from registers (read from the tile's stage, xyz / r,
//         split), B the K-major W1^T chunks of 32 K values by up to 128
//         columns (the direct backward above c1 128: two chunks a K step, one
//         a column half); in the forward the next chunk's A fragments are
//         built while a chunk's products run.
//         The LayerNorm in the accumulator layout (quad shuffles); forward, A
//         to the stage and out.
//       Backward: the LayerNorm backward in the same layout, a column slice
//         at a time (g read from the stage twice, never held whole beside
//         xhat); dscale, dlnb and db1 as column sums folded in registers
//         across tiles (wgmma.cuh); dx split and stored transposed into shared
//         memory (its hi half over the consumed dA). dW1 = P^T dx per 64-row
//         block of k_in (and 128 columns), A = P^T from registers, B = dx^T,
//         added to the CTA's own record in tile order (float2 rows, whole
//         sectors). dpts = dx W1^T per 64 k_in columns, A = dx read back from
//         dx^T, B the W1 chunks, into the points' stage and out.
//     No (rows, c1) intermediate goes to device memory.
//   * The backward above c1 128 ("direct": the width-2 backbone's SA2-4)
//     computes the same, but its points' tile, dA and dx^T together (257 KB
//     at in_dim 515) do not fit a block's shared memory, nor a 128-value
//     accumulator its registers beside the LayerNorm backward's: the points
//     and dA are read from device memory (L2) straight into the fragments;
//     X runs a column half at a time (its chunks taken half-major), and each
//     thread puts x = X + b1 into dx^T lo's place at its own dx^T offsets, so
//     that the LayerNorm backward reads it back a 64-column slice at a time
//     and writes dx^T over it, no thread touching another's values; dpts is
//     written from the accumulators. Shared memory holds dx^T (hi and lo),
//     the W1 ring and the column sums (added per tile by the lane that owns
//     a column, so their order stays fixed). Its in_dim is bound by
//     kDirectMaxIn only.
//   * The backward at c1 = 256 with few tiles (no more than kSms / kNQ = 66:
//     the width-2 backbone's SA4 at batch 8 or less, where the direct
//     backward leaves half the SMs idle) runs on clusters of two CTAs
//     (prep_tc_cluster, its note below): c1 a half a CTA, W1's half chunks
//     streaming (split_w1_cluster), the LayerNorm sums added in rank order
//     across the cluster, dpts a block of 64 k_in columns a CTA from both
//     CTAs' dx^T, one record a cluster.
//   * The forward above c1 128 (the width-2 backbone's SA2-4) runs on
//     persistent clusters of two CTAs (prep_fwd_cluster, its note below): c1
//     a half a CTA, one or two consumer warpgroups a CTA (a tile each) and a
//     producer warp streaming W1's half chunks through full / empty
//     mbarriers, W1 split once a W1 by the caller (sa_prep_f32_split_w1),
//     each thread's points a few K steps ahead by cp.async, one product group
//     in flight, the LayerNorm sums added across the pair. Its in_dim is
//     bound by kDirectMaxIn only.
//   * reduce_records (wgmma.cuh) adds the CTAs' (clusters') records in a
//     fixed order.

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
constexpr int kXCols = 128;            // c1 columns of an X chunk (wider c1 in two)
constexpr int kDirectMaxIn = 2048;     // in_dim of the direct backward (c1 above 128)
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
// columns of an X chunk: c1 (padded) up to 128, else half of it
__host__ __device__ constexpr int x_cols(int CP) { return CP < kXCols ? CP : kXCols; }

// Shared memory of the tensor route: mbarriers (tiles, then W1 chunks);
// b1, scale (and forward lnb); T tile stages (points, then dA, whose bytes
// take dx^T hi; forward, the points' bytes take A out); the direct backward's
// dx^T hi apart (it has no tile stages); dx^T lo; the direct backward's
// column sums (four warps' rows of db1, dscale, dlnb); R W1 chunk stages (hi
// and lo of an X chunk, 32 K values by x_cols(CP), or of a dpts chunk, 64
// k_in rows by dpts_cols(CP)).
struct TcLayout {
  size_t bars, vec, tiles, pbytes, tstage, dxhi, dxlo, red, wring, wstage, total;
  __host__ __device__ TcLayout(int in_dim, int c1, int CP, bool bwd, int T, int R) {
    const bool direct = bwd && CP > kXCols;
    size_t o = 0;
    bars = o;   o += 64;
    vec = o;    o += (size_t)(bwd ? 2 : 3) * CP * 4;
    pbytes = align16((size_t)kRows * in_dim * 4);
    const size_t ab = (size_t)kRows * (bwd ? CP : c1) * 4;
    tstage = direct ? 0 : bwd ? pbytes + ab : (pbytes > ab ? pbytes : ab);
    tiles = o;  o += T * tstage;
    dxhi = o;   o += direct ? (size_t)kRows * CP * 4 : 0;
    dxlo = o;   o += bwd ? (size_t)kRows * CP * 4 : 0;
    red = o;    o += direct ? (size_t)4 * 3 * CP * 4 : 0;
    wstage = (size_t)8 * kDRows * dpts_cols(CP);  // at least an X chunk's 8 kChunk x_cols(CP)
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
//   X chunks (q, h), q-major: K values 32 q .. 32 q + 32, XW = x_cols(CP)
//     rows (c from XW h) x 32 columns (k);
//   backward, then dpts chunks (b, h), b-major: k_in rows 64 b .. 64 b + 64 x
//     DC = dpts_cols(CP) columns (c from DC h).
// One thread a destination float, so that the stores coalesce.
__global__ void split_w1(const float* __restrict__ w1, int in_dim, int c1, int CP, int bwd,
                         float* __restrict__ dst) {
  const int DC = dpts_cols(CP), XW = x_cols(CP), n1 = 2 * CP * round32(in_dim);
  const int n = n1 + (bwd ? 2 * CP * round64(in_dim) : 0);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    int k, c, lo;
    if (i < n1) {
      const int qh = i / (2 * kChunk * XW), q = qh / (CP / XW), h = qh % (CP / XW);
      int off = i - qh * 2 * kChunk * XW;
      lo = off >= kChunk * XW;
      off -= lo * kChunk * XW;
      const int core = off >> 5;
      c = XW * h + (core / (kChunk / 4)) * 8 + ((off & 31) >> 2);
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
  constexpr int XW = x_cols(CP);           // columns of an X chunk
  constexpr int NH = CP / XW;              // X chunks a K step (column halves of c1)
  constexpr bool DIRECT = BWD && CP > kXCols;  // points and dA from device memory
  constexpr int FH = CP > 128 ? 4 : CP > 64 ? 2 : 1;  // column slices of the LayerNorm backward
  constexpr int FW = CP / FH;              // and their width
  using F = Fold<FW>;
  constexpr int DC = dpts_cols(CP);        // columns of a dpts chunk
  const int nX = round32(in_dim) / kChunk;  // K steps of X, NH W1 chunks each
  const int nB = round64(in_dim) / kDRows;  // k_in blocks of dpts, CP / DC chunks each
  const int nXQ = NH * nX;                  // W1 chunks of X
  const int NQ = BWD ? nXQ + nB * (CP / DC) : nXQ;  // W1 chunks a tile
  const TcLayout L(in_dim, c1, CP, BWD, T, R);

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* bs = reinterpret_cast<float*>(smem + L.vec);
  float* ss = bs + CP;
  float* ls = ss + CP;  // forward
  float* dxlo = reinterpret_cast<float*>(smem + L.dxlo);
  // the column sums of the four warps: direct, added per tile; else written
  // once the tiles are done, over dx^T lo
  float* red = DIRECT ? reinterpret_cast<float*>(smem + L.red) : dxlo;
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
    const bool x = pj < nXQ;
    // the direct backward takes X's chunks a column half at a time
    const int xq = DIRECT ? pj % nX * NH + pj / nX : pj;
    const uint32_t bytes = x ? 8u * kChunk * XW : 8u * kDRows * DC;
    const size_t off = x ? (size_t)2 * kChunk * XW * xq
                         : (size_t)2 * kChunk * XW * nXQ + (size_t)2 * kDRows * DC * (pj - nXQ);
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
  if constexpr (DIRECT)
    for (int i = tid; i < 4 * 3 * CP; i += kThreads) red[i] = 0.f;
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < T; ++i) tl.fetch(i, i);
    for (int i = 0; i < R; ++i) issue_chunk();
  }

  // backward: column sums of db1, dscale, dlnb per column slice, across the
  // tiles (direct: per tile, then added to `red`)
  float run[DIRECT ? 1 : FH][3][F::NR];
#pragma unroll
  for (int hh = 0; hh < (DIRECT ? 1 : FH); ++hh)
#pragma unroll
    for (int v = 0; v < 3; ++v)
#pragma unroll
      for (int i = 0; i < F::NR; ++i) run[hh][v][i] = 0.f;
  // direct: a tile's column sums t of slice hh, output v, into the warp's row
  // of `red` by the lane that owns each column
  auto add_sums = [&](const float (&t)[F::NR], int hh, int v) {
    if (col_owner<F::NVH>(lane)) {
#pragma unroll
      for (int i = 0; i < F::NR; ++i)
        red[(warp * 3 + v) * CP + FW * hh + F::column(i, lane, t4)] += t[i];
    }
  };

  for (int it = 0, st = 0; it < tl.my_tiles; ++it, st = st + 1 == T ? 0 : st + 1) {
    const long long tile = tl.tile(it), row0 = tile * kRows;
    const int nr = tl.rows(tile);
    if constexpr (!DIRECT) tl.arrive(it, st);
    float* P = tl.stage(st);
    const float* Pin = DIRECT ? pts + row0 * in_dim : P;  // the tile's points
    // [xyz/r ; f] at (row r of the tile, column k), zero past the rows and
    // in_dim; branch-free, so that a fragment's loads issue back to back
    auto pval = [&](int r, int k) {
      const bool on = r < nr && k < in_dim;
      const float v = Pin[on ? r * in_dim + k : 0];
      return on ? (k < 3 ? div_real(v, radius, rr) : v) : 0.f;
    };

    const bool pair = !(c1 & 1);
    // ---- X = P W1, 3xTF32, a K step of 32 values at a time: its A fragments
    // from the points (xyz / r, split), B a W1 chunk of 32 K values by XW
    // columns (above c1 128, NH chunks a K step, one a column half of the
    // accumulator)
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
    constexpr uint32_t xlo = (uint32_t)XW * kChunk * 4;  // a chunk's lo part
    // backward: dx^T (CP x 64, K-major over the tile's rows) split, hi over
    // the consumed dA (direct: apart), lo apart; g = dA at the accumulator
    // layout's (row, column) pairs of column slice hh, zero past the rows and c1
    float* dxhi = DIRECT ? reinterpret_cast<float*>(smem + L.dxhi) : tl.dA_stage(st);
    const float* G = DIRECT ? dA + row0 * c1 : tl.dA_stage(st);
    auto load_g = [&](float (&gh)[FW / 2], int hh) {
#pragma unroll
      for (int i = 0; i < FW / 2; i += 2) {
        const int c = FW * hh + 8 * (i / 4) + 2 * t4, r = r0 + 8 * ((i >> 1) & 1);
        float v0 = 0.f, v1 = 0.f;
        if (r < nr && c < c1) {
          const float* p = G + r * c1 + c;
          if (pair && !DIRECT) {
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
    // (row r, column c) of dx^T in the TF32 core layout
    auto at = [](int c, int r) {
      return ((c >> 3) * (kRows / 4) + (r >> 2)) * 32 + (c & 7) * 4 + (r & 3);
    };

    if constexpr (DIRECT) {
      // ---- X a column half at a time (the A fragments built again for the
      // second), x = X + b1 put by each thread into dx^T lo's place at its
      // own dx^T offsets, so that no thread reads another's; the LayerNorm
      // backward then reads x back a column slice at a time, and holds no
      // whole row of the tile in registers
      __syncthreads();  // every warp has read the last tile's dx^T
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll 1
      for (int h = 0; h < NH; ++h) {
        float xa[XW / 2];
        for (int q = 0; q < nX; ++q) {
          build(fa[0], q);
          const uint32_t wb = opaque(take_chunk());
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_tf32x3<XW>(xa, fa[0][0][s], fa[0][1][s],
                             make_desc(wb + 256 * s, 128, kChunk * 32),
                             make_desc(wb + xlo + 256 * s, 128, kChunk * 32), q > 0 || s > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(xa);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            fence_regs(fa[0][0][s]);
            fence_regs(fa[0][1][s]);
          }
          release_chunk();
        }
#pragma unroll
        for (int i = 0; i < XW / 2; ++i) {
          const int c = XW * h + 8 * (i / 4) + 2 * t4 + (i & 1), rh = (i >> 1) & 1;
          const float x = xa[i] + bs[c];
          s1[rh] += x;
          s2[rh] += x * x;
          dxlo[at(c, r0 + 8 * rh)] = x;
        }
      }
      float mean[2], rstd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ln_stats(quad_sum(s1[h]), quad_sum(s2[h]), fc1, rc1, mean[h], rstd[h]);
      // the row means m1, m2 and the column sums of dscale and dlnb
      float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll 1
      for (int hh = 0; hh < FH; ++hh) {
        float gh[FW / 2], xh[FW / 2];
        load_g(gh, hh);
#pragma unroll
        for (int i = 0; i < FW / 2; ++i) {
          const int c = FW * hh + 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
          xh[i] = (dxlo[at(c, r0 + 8 * h)] - mean[h]) * rstd[h];
          const float dxh = gh[i] * ss[c];
          m1[h] += dxh;
          m2[h] += dxh * xh[i];
        }
        float t1[F::NR] = {}, t2[F::NR] = {};
        fold_columns<FW, true>(gh, xh, lane, t1);
        fold_columns<FW, false>(gh, gh, lane, t2);
        add_sums(t1, hh, 1);
        add_sums(t2, hh, 2);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m1[h] = div_real(quad_sum(m1[h]), fc1, rc1);
        m2[h] = div_real(quad_sum(m2[h]), fc1, rc1);
      }
      // dx (zero past c1), its column sums (db1), split over x into dx^T
#pragma unroll 1
      for (int hh = 0; hh < FH; ++hh) {
        float gh[FW / 2], dx[FW / 2];
        load_g(gh, hh);
#pragma unroll
        for (int i = 0; i < FW / 2; ++i) {
          const int c = FW * hh + 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
          const int off = at(c, r0 + 8 * h);
          const float xhat = (dxlo[off] - mean[h]) * rstd[h];
          dx[i] = c < c1 ? rstd[h] * (gh[i] * ss[c] - m1[h] - xhat * m2[h]) : 0.f;
          uint32_t hi, lo;
          tf32_split(dx[i], hi, lo);
          dxhi[off] = __uint_as_float(hi);
          dxlo[off] = __uint_as_float(lo);
        }
        float t0[F::NR] = {};
        fold_columns<FW, false>(dx, dx, lane, t0);
        add_sums(t0, hh, 0);
      }
      fence_async();
      __syncthreads();
    } else {
      // in the forward (c1 <= 128: wider forwards run prep_fwd_cluster), the
      // next step's A fragments are built while this step's products run
      // (the backward has no registers to spare for a second set)
      float acc[NV];
      auto products = [&](uint32_t (&f)[2][4][4], uint32_t (&next)[2][4][4], int q) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint32_t wb = opaque(take_chunk());
          float (&d)[XW / 2] = *reinterpret_cast<float (*)[XW / 2]>(&acc[XW / 2 * h]);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_tf32x3<XW>(d, f[0][s], f[1][s], make_desc(wb + 256 * s, 128, kChunk * 32),
                             make_desc(wb + xlo + 256 * s, 128, kChunk * 32), q > 0 || s > 0);
          wgmma_commit();
          if (!BWD && q + 1 < nX) build(next, q + 1);
          wgmma_wait<0>();
          fence_regs(acc);
          if (h + 1 == NH) {
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              fence_regs(f[0][s]);
              fence_regs(f[1][s]);
            }
          }
          release_chunk();
        }
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
        // ---- the LayerNorm backward in the accumulator layout, a column
        // slice at a time: g = dA read from the stage twice (once for the
        // column sums of dscale and dlnb and the row means m1, m2; once for
        // dx), so that it is never held whole beside xhat; acc <- xhat <- dx
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

        __syncthreads();  // every warp has read its dA
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = 8 * (i / 4) + 2 * t4 + (i & 1), r = r0 + 8 * ((i >> 1) & 1);
          const int off = at(c, r);
          uint32_t hi, lo;
          tf32_split(acc[i], hi, lo);
          dxhi[off] = __uint_as_float(hi);
          dxlo[off] = __uint_as_float(lo);
        }
        fence_async();
        __syncthreads();
      }
    }

    if constexpr (BWD) {
      // ---- dW1 (k_in x c) = P^T dx over the tile's rows, a 64-row block of
      // k_in (and XW columns) at a time, into the CTA's record in tile order
      const uint32_t dh = smem_u32(dxhi), dl = smem_u32(dxlo);
      for (int m0 = 0; m0 < in_dim; m0 += 64) {
        const int ka = m0 + r0;  // the fragment's k_in rows ka and ka + 8
#pragma unroll 1
        for (int h2 = 0; h2 < NH; ++h2) {
          const uint32_t ho = (uint32_t)h2 * XW * kRows * 4;  // dx^T rows of the columns
          float aw[XW / 2];
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
              const uint32_t o = ho + (4 * half + s) * 256;
              wgmma_tf32x3<XW>(aw, ah[s], al[s], make_desc(opaque(dh) + o, 128, 2048),
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
            float2 o[XW / 8];
#pragma unroll
            for (int j = 0; j < XW / 8; ++j) {
              const int c = XW * h2 + 8 * j + 2 * t4;
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
            for (int j = 0; j < XW / 8; ++j) {
              const int c = XW * h2 + 8 * j + 2 * t4;
              if (c >= c1) continue;
              const float2 v =
                  make_float2(o[j].x + aw[4 * j + 2 * h], o[j].y + aw[4 * j + 2 * h + 1]);
              if (pair) {
                *reinterpret_cast<float2*>(row + c) = v;
              } else {
                row[c] = v.x;
                if (c + 1 < c1) row[c + 1] = v.y;
              }
            }
          }
        }
      }

      // ---- dpts = dx W1^T, a block of 64 k_in columns at a time over its
      // CP / DC chunks, into the points' stage (direct: into device memory);
      // A = dx, its split halves read back from dx^T, GK k8 steps at a time
      __syncthreads();  // every warp has read its points: the stage takes dpts
      float* D = DIRECT ? out + row0 * in_dim : P;
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
      if constexpr (!DIRECT) {
        store_tile(D, out + row0 * in_dim, nr * in_dim, bulk);
        if (tid == 0) {
          bulk_store_read_wait<0>();
          tl.fetch(it + T, st);
        }
      }
    }
  }

  if constexpr (BWD) {
    // the column sums: each warp its rows, then the four warps in order
    __syncthreads();
    if constexpr (!DIRECT) {
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
    }
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

// ---- the backward at c1 256 on a cluster of CTAs, c1 split among them

// CTAs of the cluster backward's cluster (clusters of four, a 64-column
// quarter of c1 each, measured slower on an H100), and c1's columns of each
constexpr int kNQ = 2, kQW = 256 / kNQ;
constexpr int kPChunk = 2 * kDRows * 32;  // floats of a dpts W1 chunk: 64 k_in x 32 columns, hi and lo
constexpr int kQRing = 8;                 // W1 chunk stages at most
constexpr int kQMinRing = 3;              // and at least
constexpr int kStageLd = 68;              // row stride of the dpts stage

// Floats of an X chunk of 32 K values by kQW columns (hi and lo), and of a
// ring stage, which holds an X chunk or a dpts chunk.
constexpr int kXChunk = 2 * kChunk * kQW;
constexpr int kStage = kXChunk > kPChunk ? kXChunk : kPChunk;

// Shared memory of the cluster backward: mbarriers (the W1 chunks); b1 and
// scale of the CTA's columns; dx_q^T hi and lo (kQW columns x 64 rows, the
// TF32 core layout); the stage (the tile's dA columns, the record elements of
// a dW1 block, or dpts rows); the LayerNorm row sums of each rank ([2 uses][rank][64][2]); the
// warps' column sums; R W1 chunk stages.
struct ClusterLayout {
  size_t bars, vec, dxhi, dxlo, stage, lnx, red, wring, total;
  __host__ __device__ ClusterLayout(int R) {
    const size_t rows = (size_t)kRows * kStageLd * 4, rec = (size_t)kThreads * (kQW / 2) * 4;
    const size_t g = (size_t)kRows * (kQW + 8) * 4;  // dA's columns
    const size_t st = rows > rec ? rows : rec;
    size_t o = 0;
    bars = o;   o += 128;
    vec = o;    o += (size_t)2 * kQW * 4;
    dxhi = o;   o += (size_t)kQW * kRows * 4;
    dxlo = o;   o += (size_t)kQW * kRows * 4;
    stage = o;  o += st > g ? st : g;
    lnx = o;    o += (size_t)2 * kNQ * kRows * 2 * 4;
    red = o;    o += (size_t)4 * 3 * kQW * 4;
    wring = o;  o += (size_t)R * kStage * 4;
    total = o;
  }
};

// The cluster backward's route: c1 = 256 on the tensor route, in_dim up to
// kDirectMaxIn (the points come from device memory, so shared memory sets no
// limit), where the tiles are no more than the clusters the card can hold
// (kSms / kNQ): there the direct backward, one tile a CTA, leaves
// SMs idle; with more tiles it measured faster (PERF.md §6).
bool cluster_route(long long tiles, int in_dim, int c1, bool bwd) {
  return bwd && c1 == 256 && in_dim > kFmaMaxIn && in_dim <= kDirectMaxIn &&
         tiles <= kSms / kNQ;
}

// W1 stages of the cluster backward: as many as fit, up to kQRing.
int cluster_ring() {
  int R = kQRing;
  while (R > kQMinRing && ClusterLayout(R).total > (size_t)kMaxSharedBytes) --R;
  return R;
}

// dpts blocks (64 columns of k_in) that CTA q adds up: b = q, q + kNQ, ...
__host__ __device__ inline int owned_blocks(int nB, int q) { return (nB - q + kNQ - 1) / kNQ; }
// floats of a rank's share of the split W1: its X chunks, then its dpts
// chunks (rank 0 has the most blocks)
__host__ __device__ inline long long rank_floats(int in_dim) {
  return (long long)(round32(in_dim) / kChunk) * kXChunk +
         8LL * owned_blocks(round64(in_dim) / kDRows, 0) * kPChunk;
}

// W1 split into TF32 hi / lo for the cluster backward, rank-major: rank q's
// chunks in the order its CTA takes them a tile, each its hi then its lo part
// in the K-major TF32 core layout:
//   X chunks j < nX (XChunk floats): K values 32 j .. 32 j + 32 (columns) x
//     c1's columns kQW q .. kQW q + kQW (rows);
//   then the dpts chunks (kPChunk floats) of q's blocks b = q, q + kNQ, ...,
//     for each block and each quarter p of c1 and half h: k_in rows 64 b ..
//     64 b + 64 x c1 columns 64 p + 32 h .. + 32.
// Zero past in_dim; one thread a destination float.
__global__ void split_w1_cluster(const float* __restrict__ w1, int in_dim, int c1,
                                 float* __restrict__ dst) {
  const int nX = round32(in_dim) / kChunk, nB = round64(in_dim) / kDRows;
  const long long per = rank_floats(in_dim), xf = (long long)nX * kXChunk;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < kNQ * per;
       i += (long long)gridDim.x * blockDim.x) {
    const int qtr = (int)(i / per);
    const long long e = i - qtr * per;
    int k = in_dim, c = 0;  // zero unless set
    int off, cols;
    if (e < xf) {  // X chunk j: rows = c1 columns, kQW of them; columns = 32 K values
      const int j = (int)(e / kXChunk);
      off = (int)(e - (long long)j * kXChunk);
      cols = kChunk;
      const int lo = off >= kXChunk / 2;
      off -= lo * (kXChunk / 2);
      const int core = off >> 5;
      c = kQW * qtr + (core / (cols / 4)) * 8 + ((off & 31) >> 2);
      k = kChunk * j + (core % (cols / 4)) * 4 + (off & 3);
      uint32_t hi, lw;
      const float v = k < in_dim ? w1[(size_t)k * c1 + c] : 0.f;
      tf32_split(v, hi, lw);
      dst[i] = __uint_as_float(lo ? lw : hi);
      continue;
    }
    const int jj = (int)((e - xf) / kPChunk);
    off = (int)(e - xf - (long long)jj * kPChunk);
    const int lo = off >= kPChunk / 2;
    off -= lo * (kPChunk / 2);
    const int core = off >> 5;
    if (jj < 8 * owned_blocks(nB, qtr)) {  // rows = 64 k_in, columns = 32 of c1
      const int b = qtr + kNQ * (jj >> 3), p = (jj & 7) >> 1, h = jj & 1;
      k = kDRows * b + (core >> 3) * 8 + ((off & 31) >> 2);
      c = 64 * p + 32 * h + (core & 7) * 4 + (off & 3);
    }
    uint32_t hi, lw;
    const float v = k < in_dim ? w1[(size_t)k * c1 + c] : 0.f;
    tf32_split(v, hi, lw);
    dst[i] = __uint_as_float(lo ? lw : hi);
  }
}

// One f32 from shared memory at a shared::cluster address (peer()).
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// The backward at c1 = 256 on persistent clusters of kNQ CTAs, where the
// tiles are at most kSms / kNQ = 66 (cluster_route: the width-2 backbone's
// SA4 at batch 8 or less; there the direct backward, one warpgroup a tile,
// left half the SMs idle). Cluster j of n (n = min(tiles, the clusters the
// card holds at once, max_clusters)) takes tiles j, j + n, ... and keeps one
// record: on an H100, which holds 66, one tile a cluster; a card that holds
// fewer, or a cap set by sa_prep_f32_set_max_clusters, makes the clusters
// take several (a launch with one tile a cluster and the tile loop and the
// record's read-modify-write removed compiled to 188 registers in place of
// 254 and ran 20% slower). CTA q holds c1's columns kQW q .. (a 64 x kQW
// accumulator, dx_q^T in shared memory) and, a tile at a time:
//   1. X_q = P W1_q in 3xTF32, a K step of 32 a product group: A from the
//      points in device memory (the tile's rows, read through L1), B the
//      CTA's W1 chunks streaming through a ring of bulk copies
//      (split_w1_cluster);
//   2. dA's columns into the stage by cp.async; the LayerNorm statistics and
//      the backward's row means, each added in rank order across the cluster
//      (distributed shared memory), the backward a 64-column slice at a time;
//      db1, dscale, dlnb folded in registers across the tiles; dx_q split
//      into dx_q^T in shared memory;
//   3. dW1's columns, P^T dx_q a 64-row block of k_in in two product groups
//      (A = P^T from the points, B = dx_q^T), added into the cluster's record
//      (the block's record elements come into the stage by cp.async while
//      the products run); a cluster barrier: every dx^T is written;
//   4. dpts for its blocks of 64 k_in columns (b = q, q + kNQ, ...): the full
//      dx W1^T, A = dx's quarters of 64 columns from their CTAs' dx^T in
//      order, B the block's W1 chunks; each block's rows through the stage, a
//      warp's lanes on consecutive columns.
// In X and dW1 a group's next operands are loaded once its products are
// issued, so the loads run during them (issuing a group while the last one
// still ran, or loading dpts's next values into a second buffer, left too
// few registers: the compiler serialized the products, C7512, or spilled).
// Every sum has a fixed order: bit-identical across launches, no atomics.
__global__ void __cluster_dims__(kNQ, 1, 1) __launch_bounds__(kThreads, 1)
prep_tc_cluster(const float* __restrict__ pts, const float* __restrict__ dA, long long n_rows,
                int in_dim, const float* __restrict__ wsplit, const float* __restrict__ b1,
                const float* __restrict__ scale, float radius, int R,
                float* __restrict__ dpts, float* __restrict__ records) {
  constexpr int NV = kQW / 2;  // accumulator values a thread
  constexpr int FW = 64, FH = kQW / FW;  // column slices of the LayerNorm backward
  using F = Fold<FW>;
  constexpr int c1 = 256;
  constexpr uint32_t kXLo = kXChunk / 2 * 4, kPLo = kPChunk / 2 * 4;  // bytes to a chunk's lo part
  const int nX = round32(in_dim) / kChunk, nB = round64(in_dim) / kDRows;
  const ClusterLayout L(R);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* bs = reinterpret_cast<float*>(smem + L.vec);
  float* ss = bs + kQW;
  float* dxhi = reinterpret_cast<float*>(smem + L.dxhi);
  float* dxlo = reinterpret_cast<float*>(smem + L.dxlo);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* lnx = reinterpret_cast<float*>(smem + L.lnx);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const uint32_t wring = smem_u32(smem + L.wring);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g4;  // the thread's rows r0 and r0 + 8 of a tile
  const int q = (int)cluster_rank(), c0 = kQW * q;  // the CTA's first column of c1
  const int cl = blockIdx.x / kNQ, n_cl = gridDim.x / kNQ;
  const int n_own = owned_blocks(nB, q);
  const int NQc = nX + 8 * n_own;  // W1 chunks the CTA takes a tile
  const float rr = 1.f / radius, fc1 = (float)c1, rc1 = 1.f / fc1;
  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  const int my_tiles = (int)((n_tiles - 1 - cl) / n_cl) + 1;
  float* rec = records + (size_t)cl * (in_dim + 3) * c1;
  const float* wq = wsplit + (size_t)q * rank_floats(in_dim);
  auto bar = [&](int i) { return smem_u32(&bars[i]); };

  // The W1 ring: the CTA's chunks in order (each tile's NQc), the k-th in
  // stage k % R; thread 0 issues them (pj, pit: the next chunk and its tile;
  // pst its stage), the threads take them (wst, wpar) and release them in
  // order.
  int pj = 0, pit = 0, pst = 0, wst = 0;
  uint32_t wpar = 0;
  auto issue_chunk = [&]() {
    if (pit >= my_tiles) return;
    const bool x = pj < nX;
    const float* src = x ? wq + (size_t)pj * kXChunk
                         : wq + (size_t)nX * kXChunk + (size_t)(pj - nX) * kPChunk;
    bulk_copy(wring + (uint32_t)pst * (kStage * 4), src, (x ? kXChunk : kPChunk) * 4, bar(pst));
    pst = pst + 1 == R ? 0 : pst + 1;
    if (++pj == NQc) {
      pj = 0;
      ++pit;
    }
  };
  auto take_chunk = [&]() {
    bulk_wait(bar(wst), (wpar >> wst) & 1u);
    wpar ^= 1u << wst;
    const uint32_t at = wring + (uint32_t)wst * (kStage * 4);
    wst = wst + 1 == R ? 0 : wst + 1;
    return opaque(at);
  };
  // after every warp's products read the n chunks taken longest ago
  auto release_chunks = [&](int n) {
    __syncthreads();
    if (tid == 0)
      for (int i = 0; i < n; ++i) issue_chunk();
  };

  if (tid == 0) {
    for (int i = 0; i < R; ++i) mbar_init(bar(i));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < R; ++i) issue_chunk();
  }
  for (int c = tid; c < kQW; c += kThreads) {
    bs[c] = b1[c0 + c];
    ss[c] = scale[c0 + c];
  }
  __syncthreads();  // the mbarriers are initialized before any thread waits on them
  cluster_sync();   // every CTA of the cluster runs before any reads or writes a peer

  float run[FH][3][F::NR];  // the CTA's db1, dscale and dlnb column sums, by slice
#pragma unroll
  for (int hh = 0; hh < FH; ++hh)
#pragma unroll
    for (int v = 0; v < 3; ++v)
#pragma unroll
      for (int i = 0; i < F::NR; ++i) run[hh][v][i] = 0.f;

  // a row's partial sums of this CTA's columns (after the quad's) into every
  // CTA's slot q of `use`; then the kNQ slots added in rank order
  const auto exchange = [&](int use, float (&a)[2], float (&b)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[h] = quad_sum(a[h]);
      b[h] = quad_sum(b[h]);
      if (t4 == 0) {
        const uint32_t at = smem_u32(lnx + ((use * kNQ + q) * kRows + r0 + 8 * h) * 2);
#pragma unroll
        for (int d = 0; d < kNQ; ++d)
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
      for (int d = 0; d < kNQ; ++d) {
        const float2 v = *reinterpret_cast<const float2*>(
            lnx + ((use * kNQ + d) * kRows + r0 + 8 * h) * 2);
        a[h] += v.x;
        b[h] += v.y;
      }
    }
  };
  // (row r, column c) of dx_q^T in the TF32 core layout
  auto at = [](int c, int r) {
    return ((c >> 3) * (kRows / 4) + (r >> 2)) * 32 + (c & 7) * 4 + (r & 3);
  };

  for (int it = 0; it < my_tiles; ++it) {
    const long long row0 = (cl + (long long)it * n_cl) * kRows;
    const int nr = (int)(n_rows - row0 < kRows ? n_rows - row0 : kRows);
    const float* P = pts + row0 * in_dim;

    // the point at (row r of the tile, column k), loaded with the row and
    // column clamped to the tile's; pfix then makes it [xyz/r ; f], zero past
    // the rows and in_dim. Split so that a load's value is first used where
    // the next group's products need it.
    auto pload = [&](int r, int k) {
      return __ldg(P + (r < nr ? r : 0) * in_dim + (k < in_dim ? k : 0));
    };
    auto pfix = [&](float v, int r, int k) {
      return r < nr && k < in_dim ? (k < 3 ? div_real(v, radius, rr) : v) : 0.f;
    };

    // ---- 1. X_q = P W1_q, 3xTF32, a K step of 32 values (a W1 chunk) a
    // product group: A's (row, k) = (r0, t), (r0 + 8, t), (r0, t + 4),
    // (r0 + 8, t + 4) of k8 step s, value e of step s at row r0 + 8 (e & 1),
    // k 8 s + t + 4 (e >> 1); step j + 1's values are loaded once step j's
    // products are issued, and stay in flight while they run
    float acc[NV];
    {
      float pv[16];
      // (lane-derived offsets opaque: recomputed a call, not held in registers
      // across the loop)
      auto load = [&](int j) {
        const int lr = (int)opaque(r0), lk = kChunk * j + (int)opaque(t4);
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pv[4 * s + e] = pload(lr + 8 * (e & 1), lk + 8 * s + 4 * (e >> 1));
      };
      load(0);
      for (int j = 0; j < nX; ++j) {
        uint32_t fh[4][4], fl[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tf32_split(pfix(pv[4 * s + e], r0 + 8 * (e & 1), kChunk * j + 8 * s + t4 + 4 * (e >> 1)),
                       fh[s][e], fl[s][e]);
        const uint32_t wb = take_chunk();
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_tf32x3<kQW>(acc, fh[s], fl[s], make_desc(wb + 256 * s, 128, kChunk * 32),
                           make_desc(wb + kXLo + 256 * s, 128, kChunk * 32), j > 0 || s > 0);
        wgmma_commit();
        if (j + 1 < nX) load(j + 1);
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          fence_regs(fh[s]);
          fence_regs(fl[s]);
        }
        release_chunks(1);
      }
    }
    // dA's columns of the tile into the stage (64 x kQW, row stride kQW + 8) by
    // cp.async, in flight during the LayerNorm statistics and their exchange
    {
      constexpr int Q4 = kQW / 4;  // 16-byte pieces a row
      for (int i = tid; i < kRows * Q4; i += kThreads) {
        const int r = i / Q4, cq = i % Q4;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_u32(stage + r * (kQW + 8) + 4 * cq)),
                     "l"(dA + (row0 + (r < nr ? r : 0)) * c1 + c0 + 4 * cq), "r"(r < nr ? 16 : 0));
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    // ---- 2. x = X + b1; the LayerNorm statistics; its backward in the
    // accumulator layout, a 64-column slice at a time with g = dA read from
    // the stage (twice: never held whole beside xhat); acc <- xhat
    float mean[2], rstd[2];
    {
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
        const float x = acc[i] + bs[c];
        acc[i] = x;
        s1[h] += x;
        s2[h] += x * x;
      }
      exchange(0, s1, s2);
#pragma unroll
      for (int h = 0; h < 2; ++h) ln_stats(s1[h], s2[h], fc1, rc1, mean[h], rstd[h]);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // every thread's dA pieces have landed
    // g of slice hh at the accumulator layout's (row, column) pairs
    auto load_g = [&](float (&gh)[FW / 2], int hh) {
#pragma unroll
      for (int i = 0; i < FW / 2; i += 2) {
        const int c = FW * hh + 8 * (i / 4) + 2 * t4, r = r0 + 8 * ((i >> 1) & 1);
        const float2 v = *reinterpret_cast<const float2*>(stage + r * (kQW + 8) + c);
        gh[i] = v.x;
        gh[i + 1] = v.y;
      }
    };
    auto slice = [&](int hh) -> float (&)[FW / 2] {
      return *reinterpret_cast<float (*)[FW / 2]>(&acc[FW / 2 * hh]);
    };
    {
      float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < FH; ++hh) {
        float gh[FW / 2];
        load_g(gh, hh);
        float (&xh)[FW / 2] = slice(hh);
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
      exchange(1, m1, m2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m1[h] = div_real(m1[h], fc1, rc1);
        m2[h] = div_real(m2[h], fc1, rc1);
      }
      // dx, its column sums (db1), split into dx_q^T
#pragma unroll
      for (int hh = 0; hh < FH; ++hh) {
        float gh[FW / 2];
        load_g(gh, hh);
        float (&xh)[FW / 2] = slice(hh);
#pragma unroll
        for (int i = 0; i < FW / 2; ++i) {
          const int c = FW * hh + 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
          gh[i] = rstd[h] * (gh[i] * ss[c] - m1[h] - xh[i] * m2[h]);
          const int off = at(c, r0 + 8 * h);
          uint32_t hi, lo;
          tf32_split(gh[i], hi, lo);
          dxhi[off] = __uint_as_float(hi);
          dxlo[off] = __uint_as_float(lo);
        }
        fold_columns<FW, false>(gh, gh, lane, run[hh][0]);
      }
    }
    fence_async();
    __syncthreads();

    // ---- 3. dW1's columns (k_in x the CTA's) += P^T dx_q over the tile's
    // rows, a 64-row block of k_in at a time in two product groups (k8 steps
    // 4 hf .. 4 hf + 3), into the cluster's record: A = P^T, value e of k8
    // step s at tile row 8 s + t + 4 (e >> 1), k_in m0 + r0 + 8 (e & 1). The
    // second group's values load while the first's products run, the block's
    // record elements (into the stage, by cp.async) and the next block's
    // values while the second's do.
    {
      const uint32_t dh = smem_u32(dxhi), dl = smem_u32(dxlo);
      float pv[16];
      auto load = [&](int m0, int hf) {
        const int lr = 32 * hf + (int)opaque(t4), lk = m0 + (int)opaque(r0);
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pv[4 * s + e] = pload(lr + 8 * s + 4 * (e >> 1), lk + 8 * (e & 1));
      };
      float aw[NV];
      auto half = [&](int m0, int hf, uint32_t (&f)[2][4][4]) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tf32_split(pfix(pv[4 * s + e], 8 * (4 * hf + s) + t4 + 4 * (e >> 1),
                            m0 + r0 + 8 * (e & 1)),
                       f[0][s][e], f[1][s][e]);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t o = (4 * hf + s) * 256;
          wgmma_tf32x3<kQW>(aw, f[0][s], f[1][s], make_desc(opaque(dh) + o, 128, 2048),
                           make_desc(opaque(dl) + o, 128, 2048), hf > 0 || s > 0);
        }
        wgmma_commit();
      };
      load(0, 0);
      for (int m0 = 0; m0 < in_dim; m0 += kDRows) {
        uint32_t fa[2][4][4];
        half(m0, 0, fa);
        load(m0, 1);
        wgmma_wait<0>();
        fence_regs(aw);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          fence_regs(fa[0][s]);
          fence_regs(fa[1][s]);
        }
        half(m0, 1, fa);
        // the thread's record elements of the block (none at the first tile)
        // by 8-byte cp.async into the stage (its own NV floats), so that no
        // register waits for them during the products
        if (it > 0) {
          const int lk = m0 + (int)opaque(r0), lc = c0 + 2 * (int)opaque(t4);
          const uint32_t dst = smem_u32(stage + opaque(tid) * NV);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = lk + 8 * h;
            const float* src = rec + (size_t)(k < in_dim ? k : 0) * c1 + lc;
            const uint32_t bytes = k < in_dim ? 8 : 0;
#pragma unroll
            for (int j = 0; j < kQW / 8; ++j)
              asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                               dst + 4 * (4 * j + 2 * h)),
                           "l"(src + 8 * j), "r"(bytes));
          }
          asm volatile("cp.async.commit_group;\n" ::: "memory");
        }
        if (m0 + kDRows < in_dim) load(m0 + kDRows, 0);
        wgmma_wait<0>();
        fence_regs(aw);
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          fence_regs(fa[0][s]);
          fence_regs(fa[1][s]);
        }
#pragma unroll
        for (int j = 0; j < kQW / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = m0 + r0 + 8 * h, c = c0 + 8 * j + 2 * t4;
            const float2 o = it > 0 ? *reinterpret_cast<const float2*>(stage + tid * NV + 4 * j + 2 * h)
                                    : make_float2(0.f, 0.f);
            if (k < in_dim)
              *reinterpret_cast<float2*>(rec + (size_t)k * c1 + c) =
                  make_float2(o.x + aw[4 * j + 2 * h], o.y + aw[4 * j + 2 * h + 1]);
          }
      }
    }
    cluster_sync();  // every dx^T is written

    // ---- 4. dpts for the CTA's blocks b = q, q + kNQ, ...: for each quarter p
    // of c1 (64 columns, in CTA p / (4 / kNQ)'s dx^T) and half h (32 columns),
    // a product group with A = dx's columns (value j of k8 step s at row
    // r0 + 8 (j & 1), column 32 h + 8 s + t + 4 (j >> 1) of the quarter) and
    // B the block's W1 chunk (p, h)
    {
      const uint32_t dh = smem_u32(dxhi), dl = smem_u32(dxlo);
      auto load = [&](int ph, uint32_t (&v)[2][4][4]) {
        const int p = ph >> 1, src = p * kNQ / 4;
        const int lc = 64 * (p - src * (4 / kNQ)) + 32 * (ph & 1) + (int)opaque(t4);
        const int lr = (int)opaque(r0);
        const uint32_t hb = peer(dh, src), lb = peer(dl, src);
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const uint32_t off = 4 * at(lc + 8 * s + 4 * (jj >> 1), lr + 8 * (jj & 1));
            v[0][s][jj] = __float_as_uint(ld_cluster(hb + off));
            v[1][s][jj] = __float_as_uint(ld_cluster(lb + off));
          }
      };
      for (int ob = 0; ob < n_own; ++ob) {
        const int k0 = kDRows * (q + kNQ * ob);
        float ad[32];
#pragma unroll 1
        for (int ph = 0; ph < 8; ++ph) {
          uint32_t f[2][4][4];
          load(ph, f);
          const uint32_t wb = take_chunk();
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_tf32x3<kDRows>(ad, f[0][s], f[1][s], make_desc(wb + 256 * s, 128, 32 * 32),
                                 make_desc(wb + kPLo + 256 * s, 128, 32 * 32), ph > 0 || s > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(ad);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            fence_regs(f[0][s]);
            fence_regs(f[1][s]);
          }
          release_chunks(1);
        }
        // the block's rows through the stage: warp w writes and stores its
        // own rows 16 w .. 16 w + 15, its lanes on consecutive columns
#pragma unroll
        for (int i = 0; i < 32; ++i)
          stage[(r0 + 8 * ((i >> 1) & 1)) * kStageLd + 8 * (i / 4) + 2 * t4 + (i & 1)] = ad[i];
        __syncwarp();
#pragma unroll 4
        for (int i = 0; i < kRows / 4; ++i) {
          const int r = 16 * warp + i;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = lane + 32 * h, k = k0 + col;
            const float v = stage[r * kStageLd + col];
            if (r < nr && k < in_dim)
              dpts[(row0 + r) * in_dim + k] = k < 3 ? div_real(v, radius, rr) : v;
          }
        }
        __syncwarp();
      }
    }
    // the next tile's first exchange barrier follows every CTA's dpts reads
    // of the dx^T it then writes again
  }

  // ---- the column sums of the CTA's columns: each warp its rows, then the
  // four warps in order
  if (col_owner<F::NVH>(lane)) {
#pragma unroll
    for (int hh = 0; hh < FH; ++hh)
#pragma unroll
      for (int v = 0; v < 3; ++v)
#pragma unroll
        for (int i = 0; i < F::NR; ++i)
          red[(warp * 3 + v) * kQW + FW * hh + F::column(i, lane, t4)] = run[hh][v][i];
  }
  __syncthreads();
  for (int i = tid; i < 3 * kQW; i += kThreads) {
    const int v = i / kQW, c = i % kQW;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += red[(w * 3 + v) * kQW + c];
    rec[(size_t)in_dim * c1 + v * c1 + c0 + c] = s;
  }
  cluster_sync();  // no CTA leaves while a peer may still read its dx^T
}

// ---- the forward at c1 256 on clusters of two CTAs, c1 split between them

constexpr int kFRing = 6;   // W1 half-chunk stages of the cluster forward, at most
constexpr int kPDepth = 4;  // K steps of a thread's points in flight

// Shared memory of the cluster forward: mbarriers (the ring's full and empty
// stages; the peer's LayerNorm sums landed, per warpgroup and slot); b1,
// scale and lnb of the CTA's columns; the LayerNorm row sums the peer sent
// ([warpgroup][slot][64 rows][2]); each warpgroup's points ring (kPDepth K
// steps of its threads' 16 A values, [step][value][thread]); R stages of an
// X half chunk (32 K values by kQW columns, hi then lo).
struct FwdLayout {
  size_t bars, vec, lnx, pring, wring, total;
  __host__ __device__ FwdLayout(int NW, int R) {
    size_t o = 0;
    bars = o;   o += 256;
    vec = o;    o += (size_t)3 * kQW * 4;
    lnx = o;    o += (size_t)NW * 2 * kRows * 2 * 4;
    pring = (o + 127) & ~size_t(127);
    o = pring + (size_t)NW * kPDepth * 16 * kThreads * 4;
    wring = (o + 127) & ~size_t(127);
    total = wring + (size_t)R * kXChunk * 4;
  }
};

__device__ __forceinline__ void mbar_init_count(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// One arrival on the CTA's own mbarrier.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival on a peer's mbarrier (a shared::cluster address, peer()),
// releasing this thread's earlier accesses to the cluster.
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// bulk_wait with cluster-scope acquire: the accesses peers released before
// their arrivals are seen after it.
__device__ __forceinline__ void cluster_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 22)) __trap();
  }
}

// tf32_split in integer operations (cvt.rna.tf32 compiles to a longer
// sequence that also keeps NaN and infinity apart): the same hi and lo for
// a finite v; a NaN or infinite v still makes its row NaN.
__device__ __forceinline__ void tf32_split_rna(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// 4 bytes from global to shared memory, asynchronously (this thread's group).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// The forward at c1 256 (above 128) on persistent clusters of kNQ = 2 CTAs:
// CTA q computes c1's columns kQW q .. kQW q + kQW of the cluster's tiles,
// NW at a time (a "set"), one a consumer warpgroup. Cluster j of n takes
// sets j, j + n, ... (n: the clusters the card holds, at most one a set);
// every output depends on its own tile only, so the grid changes no bit of
// it.
//   * W1's X half chunks for the CTA's columns (split once a W1 by split_w1,
//     its (K step, half q) chunks) stream through a ring of R stages, each
//     guarded by a full and an empty mbarrier (a consumer warp's arrival
//     each); every set takes all of them, so a chunk serves NW tiles. A
//     producer warp issues each chunk once its stage is free (issuing from a
//     consumer thread put divergent code between the product groups, and
//     ptxas then serialized every wgmma).
//   * A thread's A values of the next kPDepth - 1 K steps are in flight at
//     once (4-byte cp.async into its own slots of its warpgroup's points
//     ring; the wait is the thread's own, with no barrier).
//   * A consumer warpgroup runs X_q = P W1_q in 3xTF32 a K step of 32 values
//     a product group (A from the ring, xyz / r and split in registers; B
//     the stage), and keeps one group in flight: step j + 1's A fragments
//     are built and its group issued while step j's runs, into a second set
//     of fragment registers (the half-width accumulator leaves room for
//     them), and step j's stage is released once wgmma_wait<1> shows its
//     group done. No CTA-wide barrier a chunk.
//   * The LayerNorm statistics: the row sums over the CTA's columns go to the
//     peer's shared memory (CTA 1 - q; st.shared::cluster, then an
//     arrival on the peer's mbarrier of that warpgroup and slot, slots
//     alternating by set), and S = S_0 + S_1 in both (two terms: the same
//     bits); then A's columns of the CTA straight from the accumulators to
//     device memory (a warp's stores whole 32-byte sectors). These sums are
//     the only accesses to the peer, so a CTA that has seen the last set's
//     leaves without a cluster barrier.
// Bound: SA2-4's products (operations). A W1 chunk is read from L2 once a
// set of NW tiles, where the tile kernel read it once a tile.
template <int NW>
__global__ void __cluster_dims__(kNQ, 1, 1) __launch_bounds__(NW * kThreads + 32, 1)
prep_fwd_cluster(const float* __restrict__ pts, long long n_rows, int in_dim, int c1,
                 const float* __restrict__ wsplit, const float* __restrict__ b1,
                 const float* __restrict__ scale, const float* __restrict__ lnb, float radius,
                 int R, float* __restrict__ out) {
  constexpr int NV = kQW / 2;                  // accumulator values a thread
  constexpr uint32_t kBytes = kXChunk * 4;     // a chunk's bytes
  const FwdLayout L(NW, R);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* bs = reinterpret_cast<float*>(smem + L.vec);
  float* ss = bs + kQW;
  float* ls = ss + kQW;
  float* lnx = reinterpret_cast<float*>(smem + L.lnx);
  const uint32_t wring = smem_u32(smem + L.wring);
  auto full = [&](int s) { return smem_u32(&bars[s]); };
  auto empty = [&](int s) { return smem_u32(&bars[R + s]); };
  auto landed = [&](int w, int slot) { return smem_u32(&bars[2 * R + 2 * w + slot]); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = (int)cluster_rank(), c0 = kQW * q;  // the CTA's first column of c1
  const int cl = blockIdx.x / kNQ, n_cl = gridDim.x / kNQ;
  const int nX = round32(in_dim) / kChunk;  // K steps, a chunk each
  const long long n_tiles = (n_rows + kRows - 1) / kRows;
  const long long n_sets = (n_tiles + NW - 1) / NW;
  const int my_sets = (int)((n_sets - 1 - cl) / n_cl) + 1;

  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init_count(full(s), 1);
      mbar_init_count(empty(s), 4 * NW);  // a consumer warp's arrival each
    }
    for (int i = 0; i < 2 * NW; ++i) mbar_init_count(smem_u32(&bars[2 * R + i]), 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < kQW; c += blockDim.x) {
    const bool on = c0 + c < c1;
    bs[c] = on ? b1[c0 + c] : 0.f;
    ss[c] = on ? scale[c0 + c] : 0.f;
    ls[c] = on ? lnb[c0 + c] : 0.f;
  }
  __syncthreads();  // the mbarriers are initialized before any thread waits on them
  cluster_sync();   // and the peer's before any thread arrives on them

  if (warp == 4 * NW) {
    // ---- the producer warp: the CTA's chunks of every set in order (each
    // set's nX), chunk k into stage k % R once its use k - R is released
    if (lane == 0) {
      const float* wq = wsplit + (size_t)q * kXChunk;
      int st = 0;
      uint32_t ph = 0;  // the parity of stage st's use
      for (int set = 0, k = 0; set < my_sets; ++set)
        for (int j = 0; j < nX; ++j, ++k) {
          if (k >= R) bulk_wait(empty(st), ph ^ 1u);
          bulk_copy(wring + (uint32_t)st * kBytes, wq + (size_t)j * kNQ * kXChunk, kBytes,
                    full(st));
          if (++st == R) {
            st = 0;
            ph ^= 1u;
          }
        }
    }
    return;
  }

  const int w = warp >> 2;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * (warp & 3) + g4;  // the thread's rows r0 and r0 + 8 of a tile
  const float rr = 1.f / radius, fc1 = (float)c1, rc1 = 1.f / fc1;
  const bool pair = !(c1 & 1);
  // the thread's slots of its warpgroup's points ring
  float* pr = reinterpret_cast<float*>(smem + L.pring) + (size_t)w * kPDepth * 16 * kThreads +
              (tid & (kThreads - 1));
  int s = 0;
  uint32_t ph = 0;  // the stage of the next chunk and the parity of its use
  auto next_stage = [&]() {
    if (++s == R) {
      s = 0;
      ph ^= 1u;
    }
  };
  auto release = [&](int st) {  // a warp has done with stage st
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };

  for (int set = 0; set < my_sets; ++set) {
    const long long tile = (cl + (long long)set * n_cl) * NW + w;
    if (tile >= n_tiles) {
      // no tile for this warpgroup in the cluster's last set (nor for its
      // peer's): it takes and releases the set's chunks all the same
      for (int j = 0; j < nX; ++j) {
        bulk_wait(full(s), ph);
        release(s);
        next_stage();
      }
      continue;
    }
    const long long row0 = tile * kRows;
    const int nr = (int)(n_rows - row0 < kRows ? n_rows - row0 : kRows);
    const float* P = pts + row0 * in_dim;
    // the thread's rows of the tile, clamped to its last
    const int ro0 = (r0 < nr ? r0 : nr - 1) * in_dim;
    const int ro1 = (r0 + 8 < nr ? r0 + 8 : nr - 1) * in_dim;

    // The thread's A values of K step j into slot j % kPDepth of its ring
    // (value 4 s + e at row r0 + 8 (e & 1), k 32 j + 8 s + t + 4 (e >> 1)); a
    // commit a step, so that its waits count steps. Rows past the tile's take
    // its last row and k past in_dim its last column: finite values, which
    // meet W1's zero rows past in_dim, or make rows that are not stored.
    auto fetch = [&](int j) {
      if (j < nX) {
        float* d = pr + (j % kPDepth) * 16 * kThreads;
        const int k0 = kChunk * j + t4;
        const float* p0 = P + ro0 + k0;
        const float* p1 = P + ro1 + k0;
        if (kChunk * (j + 1) <= in_dim) {
#pragma unroll
          for (int s4 = 0; s4 < 4; ++s4)
#pragma unroll
            for (int eh = 0; eh < 2; ++eh) {
              cp_async4(d + (4 * s4 + 2 * eh) * kThreads, p0 + 8 * s4 + 4 * eh);
              cp_async4(d + (4 * s4 + 2 * eh + 1) * kThreads, p1 + 8 * s4 + 4 * eh);
            }
        } else {
          const int last = in_dim - 1 - k0;
#pragma unroll
          for (int s4 = 0; s4 < 4; ++s4)
#pragma unroll
            for (int eh = 0; eh < 2; ++eh) {
              const int o = min(8 * s4 + 4 * eh, last);
              cp_async4(d + (4 * s4 + 2 * eh) * kThreads, p0 + o);
              cp_async4(d + (4 * s4 + 2 * eh + 1) * kThreads, p1 + o);
            }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    // step j's values from the ring ([xyz/r ; f]: at j = 0 the thread's
    // first two values of lanes t < 3 are xyz), split into hi and lo
    auto split = [&](uint32_t (&f)[2][4][4], int j) {
      const float* d = pr + (j % kPDepth) * 16 * kThreads;
      const bool xyz = j == 0 && t4 < 3;
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = d[(4 * s4 + e) * kThreads];
          if (s4 == 0 && e < 2) v = xyz ? div_real(v, radius, rr) : v;
          tf32_split_rna(v, f[0][s4][e], f[1][s4][e]);
        }
    };
    float acc[NV];
    uint32_t fa[2][2][4][4];  // [buffer][hi, lo][k8 step][register]
    int prev = 0;             // the stage of the group issued before this one
    // K step j: a later step's values fetched; step j's fragments into f and
    // its product group issued; then step j - 1's group is done: its stage
    // released, its fragments (other) free
    auto step = [&](uint32_t (&f)[2][4][4], uint32_t (&other)[2][4][4], int j) {
      fetch(j + kPDepth - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kPDepth - 1) : "memory");
      split(f, j);
      bulk_wait(full(s), ph);
      const uint32_t wb = opaque(wring + (uint32_t)s * kBytes);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4)
        wgmma_tf32x3<kQW>(acc, f[0][s4], f[1][s4], make_desc(wb + 256 * s4, 128, kChunk * 32),
                          make_desc(wb + kBytes / 2 + 256 * s4, 128, kChunk * 32),
                          j > 0 || s4 > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        fence_regs(other[0][s4]);
        fence_regs(other[1][s4]);
      }
      if (j > 0) release(prev);
      prev = s;
      next_stage();
    };
    for (int j = 0; j + 1 < kPDepth; ++j) fetch(j);
    for (int j = 0; j < nX; j += 2) {
      step(fa[0], fa[1], j);
      if (j + 1 < nX) step(fa[1], fa[0], j + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(prev);

    // ---- x = X + b1; the row sums over the CTA's columns, then both CTAs'
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;
      const float x = acc[i] + bs[c];
      acc[i] = x;
      s1[h] += x;
      s2[h] += x * x;
    }
    const int slot = set & 1;
    float* mine = lnx + (size_t)(w * 2 + slot) * kRows * 2;  // the peer's sums land here
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s1[h] = quad_sum(s1[h]);
      s2[h] = quad_sum(s2[h]);
    }
    if (t4 == 0) {
      const uint32_t other = (uint32_t)(q ^ 1);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         peer(smem_u32(mine + (r0 + 8 * h) * 2), other)),
                     "f"(s1[h]), "f"(s2[h])
                     : "memory");
      mbar_arrive_peer(peer(landed(w, slot), other));
    }
    cluster_wait(landed(w, slot), (uint32_t)(set >> 1) & 1u);
    float mean[2], rstd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 o = *reinterpret_cast<const float2*>(mine + (r0 + 8 * h) * 2);
      ln_stats(s1[h] + o.x, s2[h] + o.y, fc1, rc1, mean[h], rstd[h]);
    }

    // ---- A's columns of the CTA: a warp's stores cover eight rows of 32 bytes
    float* O = out + row0 * c1;
#pragma unroll
    for (int i = 0; i < NV; i += 2) {
      const int cw = 8 * (i / 4) + 2 * t4, c = c0 + cw, h = (i >> 1) & 1, r = r0 + 8 * h;
      if (r >= nr || c >= c1) continue;
      const float y0 = (acc[i] - mean[h]) * rstd[h] * ss[cw] + ls[cw];
      const float y1 = (acc[i + 1] - mean[h]) * rstd[h] * ss[cw + 1] + ls[cw + 1];
      float* o = O + (size_t)r * c1 + c;
      if (pair) {
        *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
      } else {
        o[0] = y0;
        if (c + 1 < c1) o[1] = y1;
      }
    }
  }
  // no barrier before leaving: the peer's last access to this CTA, its sums
  // and arrival of the last set, was seen complete above (a final cluster
  // barrier measured 3% slower at the width-2 backbone's SA2-4)
}

// ---- launch plans

// The route, widths and rings of a launch; a function of the rows and the
// widths only (so are the grid and with it every sum's order; on the cluster
// route the grid is the clusters the card holds, cluster_count).
struct Plan {
  bool tc = false, cluster = false, fwd_cluster = false;
  int CP = 0, T = 0, R = 0, NW = 0, grid = 0;
  size_t smem = 0;
};

// The most clusters a cluster backward runs (0: no cap), set by
// sa_prep_f32_set_max_clusters.
int max_clusters = 0;

// The clusters of a cluster kernel of `threads` a CTA over `units` tiles (or
// sets of tiles): as many as the card holds at once, at most one a unit and,
// given `cap`, at most max_clusters; 0 if it holds none. Also sets the
// kernel's shared memory size.
template <typename Kernel>
int cluster_count(Kernel* kernel, int threads, long long units, size_t smem, bool cap) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kNQ * kSms, 1, 1);  // a multiple of every cluster size
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &config) != cudaSuccess) return 0;
  if (cap && max_clusters > 0 && max_clusters < n) n = max_clusters;
  return (int)(units < n ? units : n);
}

// The clusters of the backward's cluster route over `tiles` tiles.
int bwd_clusters(long long tiles, size_t smem) {
  return cluster_count(prep_tc_cluster, kThreads, tiles, smem, true);
}

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
  p.tc = true;
  if (cluster_route(tiles, in_dim, c1, bwd)) {  // the grid: bwd_clusters at the launch
    p.cluster = true;
    p.T = 0;
    p.R = cluster_ring();
    p.smem = ClusterLayout(p.R).total;
    return true;
  }
  if (!bwd && p.CP > kXCols) {  // the cluster forward; the grid: cluster_count at the launch
    if (in_dim > kDirectMaxIn) return false;
    p.fwd_cluster = true;
    p.T = 0;
    // a warpgroup a CTA (a cluster a tile, two SMs on it) while the tiles fit
    // the clusters an H100 holds, else two (a cluster two tiles at a time,
    // each chunk of W1 serving both); each measured the faster of the two
    // where it runs (the width-2 backbone's SA4, and SA2-3)
    p.NW = tiles > kSms / kNQ ? 2 : 1;
    for (p.R = kFRing; FwdLayout(p.NW, p.R).total > (size_t)kMaxSharedBytes; --p.R) {
    }
    p.smem = FwdLayout(p.NW, p.R).total;
    return true;
  }
  const bool direct = bwd && p.CP > kXCols;  // no tile stages
  if (direct && in_dim > kDirectMaxIn) return false;
  const int nq = p.CP / x_cols(p.CP) * (round32(in_dim) / kChunk) +  // W1 chunks a tile
                 (bwd ? round64(in_dim) / kDRows * (p.CP / dpts_cols(p.CP)) : 0);
  for (p.T = direct ? 0 : tiles > kSms ? 2 : 1; p.T >= (direct ? 0 : 1); --p.T)
    for (p.R = std::min(kMaxRing, nq); p.R >= std::min(2, nq); --p.R) {
      p.smem = TcLayout(in_dim, c1, p.CP, bwd, p.T, p.R).total;
      if (p.smem <= (size_t)kMaxSharedBytes) {
        p.grid = (int)std::min(tiles, (long long)kSms * per_sm(p.smem, 2));
        return true;
      }
    }
  return false;
}

// Floats of the split W1 in a launch's scratch (tensor route; the cluster
// backward's rank-major; the cluster forward takes its split from the caller).
long long split_floats(const Plan& p, int in_dim, bool bwd) {
  if (p.cluster) return kNQ * rank_floats(in_dim);
  if (p.fwd_cluster) return 0;
  return p.tc ? 2LL * p.CP * (round32(in_dim) + (bwd ? round64(in_dim) : 0)) : 0;
}

bool aligned(const void* p) { return !(reinterpret_cast<uintptr_t>(p) & 15); }

// The cluster forward's launch: W1 split by the caller (split_w1's layout).
template <int NW>
cudaError_t launch_fwd_cluster(const Plan& p, const float* pts, long long n_rows, int in_dim,
                               int c1, const float* wsplit, const float* b1, const float* scale,
                               const float* lnb, float radius, float* out, cudaStream_t s) {
  // the float2 stores of A and the chunks' bulk copies
  if (!wsplit || !aligned(wsplit) || (!(c1 & 1) && reinterpret_cast<uintptr_t>(out) % 8))
    return cudaErrorInvalidValue;
  const long long sets = ((n_rows + kRows - 1) / kRows + NW - 1) / NW;
  const int threads = NW * kThreads + 32;
  const int n_cl = cluster_count(prep_fwd_cluster<NW>, threads, sets, p.smem, false);
  if (n_cl <= 0) return cudaErrorInvalidConfiguration;
  prep_fwd_cluster<NW><<<kNQ * n_cl, threads, p.smem, s>>>(
      pts, n_rows, in_dim, c1, wsplit, b1, scale, lnb, radius, p.R, out);
  return cudaGetLastError();
}

template <int CP, bool BWD>
cudaError_t launch(const Plan& p, const float* pts, const float* dA, long long n_rows,
                   int in_dim, int c1, const float* w1, const float* b1, const float* scale,
                   const float* lnb, float radius, float* out, float* wout, const float* wsplit,
                   float* scratch, cudaStream_t s) {
  const bool bulk = aligned(pts) && aligned(out) && (!BWD || aligned(dA));
  float* records = scratch + split_floats(p, in_dim, BWD);
  cudaError_t err = cudaSuccess;
  if constexpr (CP == 256 && BWD) {
    if (p.cluster) {
      // dA's 16-byte cp.async pieces need it 16-byte aligned (the wrapper sees
      // to it)
      if (!aligned(dA)) return cudaErrorInvalidValue;
      const long long n = split_floats(p, in_dim, BWD);
      split_w1_cluster<<<(int)std::min((n + 255) / 256, 2LL * kSms), 256, 0, s>>>(w1, in_dim, c1,
                                                                                   scratch);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      const int n_cl = bwd_clusters((n_rows + kRows - 1) / kRows, p.smem);
      if (n_cl <= 0) return cudaErrorInvalidConfiguration;
      prep_tc_cluster<<<kNQ * n_cl, kThreads, p.smem, s>>>(
          pts, dA, n_rows, in_dim, scratch, b1, scale, radius, p.R, out, records);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      const int P = (in_dim + 3) * c1;
      reduce_records<8><<<(P + 31) / 32, 256, 0, s>>>(records, n_cl, P, wout);
      return cudaGetLastError();
    }
  }
  if (p.tc) {
    if constexpr (CP == 256 && !BWD) {  // make_plan puts all of these on the cluster route
      return p.NW == 2 ? launch_fwd_cluster<2>(p, pts, n_rows, in_dim, c1, wsplit, b1, scale,
                                               lnb, radius, out, s)
                       : launch_fwd_cluster<1>(p, pts, n_rows, in_dim, c1, wsplit, b1, scale,
                                               lnb, radius, out, s);
    } else {
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
  } else {
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
                     float radius, float* out, float* wout, const float* wsplit, float* scratch,
                     cudaStream_t s) {
  Plan p;
  if (!make_plan(n_rows, in_dim, c1, BWD, p)) return cudaErrorInvalidValue;
  if (p.tc && !aligned(scratch)) return cudaErrorInvalidValue;
#define EDA_PREP_F32(W)                                                                  \
  if (p.CP == W)                                                                         \
    return launch<W, BWD>(p, pts, dA, n_rows, in_dim, c1, w1, b1, scale, lnb, radius, out, \
                          wout, wsplit, scratch, s);
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
// c1: the tensor route's, whose points' stage grows with in_dim (above c1
// 128, where both read the points from device memory: kDirectMaxIn); 0 if c1
// is unsupported.
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
  const int records = p.cluster ? bwd_clusters((n_rows + kRows - 1) / kRows, p.smem) : p.grid;
  return split_floats(p, in_dim, bwd) + (bwd ? (long long)records * (in_dim + 3) * c1 : 0);
}


// The forward's route at these rows and widths (make_plan): 0 the FMA route,
// 1 the tensor route (prep_tc), 2 + NW - 1 the cluster forward with NW
// consumer warpgroups a CTA; -1 if it takes none.
int sa_prep_f32_forward_route(long long n_rows, int in_dim, int c1) {
  Plan p;
  if (!make_plan(n_rows, in_dim, c1, false, p)) return -1;
  return !p.tc ? 0 : p.fwd_cluster ? 1 + p.NW : 1;
}

// Most 64-row tiles the backward runs on its cluster route (c1 256); with
// more it runs the direct backward.
int sa_prep_f32_cluster_max_tiles() { return kSms / kNQ; }

// Caps the clusters of the backward's cluster route at n (0: as many as the
// card holds, the default), so that each cluster takes several tiles in turn
// on a card that holds one for every tile. Takes effect at the next scratch
// size and launch, which must see the same cap.
void sa_prep_f32_set_max_clusters(int n) { max_clusters = n > 0 ? n : 0; }

// Floats of W1 split for the forward's cluster route (c1 above 128), which
// takes it from the caller (sa_prep_f32_split_w1) so that it is split once a
// W1 and not once a launch; 0 where the forward's plan splits W1 itself.
long long sa_prep_f32_split_floats(long long n_rows, int in_dim, int c1) {
  Plan p;
  if (!make_plan(n_rows, in_dim, c1, false, p) || !p.fwd_cluster) return 0;
  return 2LL * p.CP * round32(in_dim);
}

// w1: (in_dim, c1) f32 -> dst: sa_prep_f32_split_floats(., in_dim, c1) floats,
// 16-byte aligned. Returns cudaGetLastError().
int sa_prep_f32_split_w1(const float* w1, int in_dim, int c1, float* dst, void* stream) {
  const int CP = c1_pad(c1);
  const long long n = 2LL * CP * round32(in_dim);
  split_w1<<<(int)std::min((n + 255) / 256, 2LL * kSms), 256, 0,
             static_cast<cudaStream_t>(stream)>>>(w1, in_dim, c1, CP, 0, dst);
  return cudaGetLastError();
}

// pts: (n_rows, in_dim) f32; w1: (in_dim, c1) f32; b1/scale/lnb: (c1,) f32;
// out: (n_rows, c1) f32; wsplit: W1 split by sa_prep_f32_split_w1 where
// sa_prep_f32_split_floats is above 0 (else unused, may be NULL); scratch:
// sa_prep_f32_scratch(n_rows, in_dim, c1, 0) floats. Returns cudaGetLastError().
int sa_prep_f32_launch(const float* pts, long long n_rows, int in_dim, int c1,
                       const float* w1, const float* b1, const float* scale, const float* lnb,
                       float radius, float* out, const float* wsplit, float* scratch,
                       void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  return dispatch<false>(pts, nullptr, n_rows, in_dim, c1, w1, b1, scale, lnb, radius, out,
                         nullptr, wsplit, scratch, static_cast<cudaStream_t>(stream));
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
                        wout, nullptr, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
