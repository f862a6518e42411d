// Fused set-abstraction pair-pool backward on Hopper's tensor cores, in two
// variants.
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
//   compact:  one row per (center, channel) with g != 0 and a one-hot
//             cotangent; a winner outside the window gathers a zero A row;
//             the row adds bf16(dh0) into dA (nothing when outside);
//   windowed: one row per distinct in-window winner of a center, with the
//             cotangents of all live channels it won; the row adds dh0 into
//             dA in exact f32.
// Both round the row cotangent to bf16 before W3^T and dx to bf16 before
// W2^T, and sum db_c, db2, db3 and the LayerNorm gradients in f32 unrounded.
//
// Bound on this card (chip_smoke.py, pool_bwd_bound): the live rows' work,
// 2 c1 c2 flops each for h0 W2, dx W2^T and dW2 per row and 4 c2 per won
// channel for W3^T and dW3, at the bf16 tensor-core peak, or the bytes of
// A, b_c, g, the winners and dA, whichever is longer. At batch 8 of the
// flagship model: K5 (SA1) 0.053 ms, set by bytes; K6 (SA2-4) 0.040 ms, set
// by operations. Past the products, the dA adds (one f32 add per row and c1
// channel, 133 M at SA1) and at SA2-4 the weight-gradient record updates.
//
// Design. One CTA of two warpgroups (256 threads) per (batch row, block of 16
// centers), the forward's window block. Each product's 64 tile rows are the
// wgmma M; the two warpgroups take half of its columns each.
//   * Rows. Each warp lists the live rows of its centers in channel order: a
//     ballot prefix over g != 0 (compact), or (windowed) the distinct
//     in-window winners, deduplicated in a 512-slot hash table per warp keyed
//     by window position (the smallest channel of a position leads its row,
//     so the row order is fixed whatever the atomics' order). A row's window
//     position is kept with it. A center's rows are contiguous and the
//     centers follow each other, packed into 64-row tiles; the last tile's
//     spare rows carry zero cotangents.
//   * Per tile, everything in shared memory in the no-swizzle core-matrix
//     layout of wgmma.cuh, which wgmma reads K-major or, with the transpose
//     flag, MN-major, so each tile matrix is stored once:
//       H0 = bf16(relu(A + bc)) gathered by row (16-byte loads in flight
//            while D is built, bf16x2 add),
//       D  = the rows' bf16 cotangents (rows x c3, one-hot for compact).
//     GEMM1 X = H0 W2 and GEMM2 dh1 = D W3^T are issued together; the LN
//     statistics come from X in the accumulator (quad shuffles, then the two
//     warpgroups' halves added in order through shared memory) while GEMM2
//     runs; h1 goes to shared memory for dW3 and h1 > 0 stays as bits. The
//     LN + ReLU backward runs in the accumulator layout: db2, ds2 and dlb2
//     are folded by a transposing lane butterfly into a few running sums a
//     lane. bf16(dx) goes to shared memory; GEMM3 dh0 = DX W2^T reads W2
//     transposed (MN-major) from the copy GEMM1 reads. The compact variant
//     runs GEMM2 over its one-hot D as well: one code path for both. The
//     per-tile LayerNorm (ln_stats, ln_h1, ln_relu_backward), the row sums'
//     exchange and the record's column sums (write_column_sums) are device
//     helpers that the three kernels share (pool_bwd_wide: the exchange and
//     the column sums; its LayerNorm keeps xhat in shared memory).
//   * Weight gradients on the tensor cores, over live rows only: dW2 =
//     H0^T DX and dW3 = H1^T D read both operands MN-major from the tile's
//     buffers, K = the tile's 64 rows. At (64, 64, 128) and narrower the two
//     f32 sums stay in registers across the CTA's tiles (48 a thread at SA1);
//     at (128, 128, 256) (windowed rows: K6 at SA2-4, where a block's tiles
//     are few) they would take 192, and each tile's product is added in 64 x
//     64 chunks to the CTA's own f32 record in device memory by the thread
//     that owns the element (no atomics; the record's loads are in flight
//     while the chunk's product runs). A second kernel adds the records in a
//     fixed order. Every weight and vector gradient and db_c is a fixed-order
//     sum: bit-identical across launches.
//   * The compact rows at (128, 128, 256), 64 tiles a block at the width-2
//     backbone's SA1, run pool_bwd_compact (its note below): one persistent
//     CTA an SM, the one-hot products a quarter of the channels at a time,
//     the weight-gradient sums in shared memory, no per-tile record update.
//   * dh0 goes through shared memory (f32, swizzled): the threads of a column
//     add each center's rows into db_c in row order. dA is shared by the
//     overlapping windows of other CTAs, so each CTA adds into its own f32
//     record of its window (W x c1, zeroed by the launcher; pool_bwd_compact
//     zeroes its blocks' own): per tile, the
//     first row of each position leads, sums the tile's rows of that position
//     in row order (compact: each bf16(dh0)) and adds the sum to the record;
//     the tile's leaders hold distinct positions and the tiles follow each
//     other, so no atomics. A second kernel (reduce_dA) adds, for each point,
//     the records of the windows that cover it in block order. dA is a
//     fixed-order sum too: the backward is bit-identical across launches.
//   * Descriptors are built from shared addresses made opaque where they are
//     used (`opaque`), so the compiler does not hoist them out of the tile
//     loop and hold them in registers across the phases.
//   * Scratch: one record of c1 c2 + c2 c3 + 3 c2 + c3 floats per CTA (SA2:
//     512 CTAs, 99 MB at batch 8) and one dA record of W c1 floats per block
//     (SA1: 1024 blocks, 268 MB at batch 8), no pair-row buffers.
//   * The windowed rows at (256, 256, 512) (the width-2 backbone's SA2-4) run
//     pool_bwd_wide (the compact rows there, the width-4 backbone's SA1, run
//     csrc/sa_pair_pool_bwd_wide_compact.cu): the same rows and sums, with W2 (128 KiB) and W3 (256 KiB) streamed from L2
//     through a ring, since the tile buffers alone take most of a block's
//     shared memory (its note below). Its hash tables have 1024 slots a warp
//     (up to min(c3, W) = 512 winners a center). Its record is 197 888 floats
//     (792 KB): a read-modify-write of it every tile would move 1.5 MB
//     through device memory a tile, as records this large do not stay in L2.
//     So one persistent CTA an SM keeps one record and folds up to
//     kWideStage staged tiles into it at a time. SA2 at batch 8: 132 records
//     (104 MB), 198 MB of staged tiles and 134 MB of dA records (W c1 floats
//     a block), where a CTA a block would hold 512 records (405 MB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pool_bwd_common.cuh"

namespace {

using namespace pool_bwd;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kCenters = 16;
constexpr int kHash = 512;     // hash slots per warp (c3 <= 256 entries)
constexpr int kHashLog = 9, kHashOb = 8;  // log2(kHash); the bits of a channel in a key
constexpr int kMaxSharedBytes = 232448;

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }
__host__ __device__ constexpr int pad64(int c) { return c < 64 ? 64 : c; }
__host__ __device__ constexpr size_t max3(size_t a, size_t b, size_t c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// floats of a CTA's record and of the output: dW2, dW3, db2, ds2, dlb2, db3
__host__ __device__ constexpr int record_floats(int c1, int c2, int c3) {
  return c1 * c2 + c2 * c3 + 3 * c2 + c3;
}

template <int C1, int C2, int C3>
struct Layout {
  size_t w2, w3, h0, h1, dx, u, bc, row_of, row_rel, gb, dbc, vec, xs, meta, rstart, total;
  __host__ __device__ Layout() {
    size_t o = 0;
    w2 = o;     o += align128((size_t)C2 * C1 * 2);          // rows c, cols k
    w3 = o;     o += align128((size_t)C2 * C3 * 2);          // rows c, cols o
    h0 = o;     o += align128((size_t)kRows * pad64(C1) * 2);
    h1 = o;     o += align128((size_t)kRows * pad64(C2) * 2);
    dx = o;     o += align128((size_t)kRows * C2 * 2);
    // D (bf16), then dh0 (f32); the hash tables before the tiles, the
    // vector partials after them
    u = o;      o += align128(max3((size_t)kRows * C3 * 2, (size_t)kRows * C1 * 4,
                                   max3((size_t)kWarps * kHash * 4,
                                        (size_t)kWarps * 3 * C2 * 4, 0)));
    bc = o;     o += align128((size_t)kCenters * C1 * 2);
    row_of = o; o += align128((size_t)kCenters * C3 * 2);    // (center, channel) -> row
    row_rel = o; o += align128((size_t)kCenters * C3 * 4);   // (center, row) -> window pos
    gb = o;     o += align128((size_t)kCenters * C3 * 2);    // bf16(g) of the centers
    dbc = o;    o += align128((size_t)kCenters * C1 * 4);
    vec = o;    o += align128((size_t)3 * C2 * 4);
    xs = o;     o += align128((size_t)4 * kRows * 2 * 4);    // LN row sums of each half
    meta = o;   o += align128((size_t)5 * kRows * 4);
    rstart = o; o += align128((size_t)(kCenters + 1) * 4);
    total = o;
  }
};

// No memory access moves across it: later loads stay later (and out of
// registers until then).
__device__ __forceinline__ void compiler_fence() { asm volatile("" ::: "memory"); }

// f32 (r, c) of the dh0 tile, its columns XOR-swizzled by row
template <int C1>
__device__ __forceinline__ int dh0_at(int r, int c) {
  return r * C1 + (c ^ (((r & 7) << 3) & (C1 - 1)));
}

// acc (z) becomes xhat; h1 = bf16(relu(xhat s2 + lb2)) into the h1 tile (row
// stride ld); pos_bits: h1 > 0, one bit an accumulator
template <int H2>
__device__ __forceinline__ void ln_h1(float (&acc)[H2 / 2], const float (&mean)[2],
                                      const float (&rstd)[2], const float* s2s, const float* lb2s,
                                      uint16_t* h1s, int ld, int wg, int r0, int t4,
                                      uint32_t (&pos_bits)[(H2 / 2 + 31) / 32]) {
#pragma unroll
  for (int i = 0; i < (H2 / 2 + 31) / 32; ++i) pos_bits[i] = 0u;
#pragma unroll
  for (int j = 0; j < H2 / 8; ++j) {
    const int c = wg * H2 + 8 * j + 2 * t4;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xh = (acc[4 * j + e] - mean[e / 2]) * rstd[e / 2];
      acc[4 * j + e] = xh;
      const float pre = xh * s2s[c + (e & 1)] + lb2s[c + (e & 1)];
      // h1 = bf16(relu(pre)) > 0 exactly where pre > 0
      if (pre > 0.f) pos_bits[(4 * j + e) / 32] |= 1u << ((4 * j + e) % 32);
      y[e] = fmaxf(pre, 0.f);
    }
    *reinterpret_cast<uint32_t*>(h1s + core_at(r0, c, ld)) = pack_bf16x2(y[0], y[1]);
    *reinterpret_cast<uint32_t*>(h1s + core_at(r0 + 8, c, ld)) = pack_bf16x2(y[2], y[3]);
  }
}

// LN + ReLU backward: accd (dh1) becomes dln (zero where h1 = 0), then
// dxhat, then dx; bf16(dx) into the dx tile (row stride C2); the thread's
// db2, ds2 and dlb2 column sums added into run[0], run[1], run[2] (a CTA
// barrier)
template <int C2, int H2>
__device__ __forceinline__ void ln_relu_backward(
    float (&accd)[H2 / 2], const float (&xhat)[H2 / 2],
    const uint32_t (&pos_bits)[(H2 / 2 + 31) / 32], const float (&rstd)[2], const float* s2s,
    uint16_t* dxs, float* xs, int wg, int r0, int t4, int lane, float c2f, float rc2,
    float (&run)[3][Fold<H2>::NR]) {
  const int c2 = wg * H2;
#pragma unroll
  for (int i = 0; i < H2 / 2; ++i)
    if (!((pos_bits[i / 32] >> (i % 32)) & 1u)) accd[i] = 0.f;
  fold_columns<H2, true>(accd, xhat, lane, run[1]);   // ds2
  fold_columns<H2, false>(accd, xhat, lane, run[2]);  // dlb2
  float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < H2 / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float dxh = accd[4 * j + e] * s2s[c2 + 8 * j + 2 * t4 + (e & 1)];
      accd[4 * j + e] = dxh;
      m1[e / 2] += dxh;
      m2[e / 2] += dxh * xhat[4 * j + e];
    }
  }
  row_sums_put(m1, m2, xs, 1, wg, r0, t4);
  __syncthreads();
  row_sums_get(m1, m2, xs, 1, r0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m1[h] = div_width<C2>(m1[h], c2f, rc2);
    m2[h] = div_width<C2>(m2[h], c2f, rc2);
  }
#pragma unroll
  for (int j = 0; j < H2 / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      accd[4 * j + e] = rstd[e / 2] * (accd[4 * j + e] - m1[e / 2] - xhat[4 * j + e] * m2[e / 2]);
    const int c = c2 + 8 * j + 2 * t4;
    *reinterpret_cast<uint32_t*>(dxs + core_at(r0, c, C2)) =
        pack_bf16x2(accd[4 * j], accd[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dxs + core_at(r0 + 8, c, C2)) =
        pack_bf16x2(accd[4 * j + 2], accd[4 * j + 3]);
  }
  fold_columns<H2, false>(accd, xhat, lane, run[0]);  // db2
}

// The record's column sums: each thread's db2, ds2 and dlb2 sums (run + q NR,
// its rows at its warpgroup's columns) through `red` (4 x 3 x C2 floats), the
// four warps of a warpgroup added in order into out[0 .. 3 C2) (a CTA barrier)
template <int C2, int H2>
__device__ __forceinline__ void write_column_sums(const float* run, float* red, float* out,
                                                  int tid) {
  using F = Fold<H2>;
  const int lane = tid % 32, wq = (tid / 32) % 4, t4 = lane % 4, c2 = (tid / 128) * H2;
  if (col_owner<F::NVH>(lane)) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < F::NR; ++i)
        red[(wq * 3 + q) * C2 + c2 + F::column(i, lane, t4)] = run[q * F::NR + i];
  }
  __syncthreads();
  for (int i = tid; i < 3 * C2; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += red[w * 3 * C2 + i];
    out[i] = s;
  }
}

template <int C1, int C2, int C3, bool COMPACT>
__global__ void __launch_bounds__(kThreads, 1)
pool_bwd_tiles(const uint16_t* __restrict__ A, const uint16_t* __restrict__ bc,
               const float* __restrict__ g, const int* __restrict__ win,
               const int* __restrict__ starts, const uint16_t* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ s2,
               const float* __restrict__ lb2, const uint16_t* __restrict__ w3, int N, int M,
               int W, float c2f, float rc2, float* __restrict__ dbc,
               float* __restrict__ records, float* __restrict__ da_records) {
  constexpr int CP1 = pad64(C1), CP2 = pad64(C2);
  constexpr int P = record_floats(C1, C2, C3);
  // a warpgroup's columns of each product: C2 of GEMM1, GEMM2, dW2; C1 of
  // GEMM3; C3 of dW3
  constexpr int H1 = C1 / 2, H2 = C2 / 2, H3 = C3 / 2;
  // both weight-gradient sums held in registers across the tiles
  constexpr bool HOLD = (CP1 * C2 + CP2 * C3) / kThreads <= 48;
  constexpr int NO = C3 / 32;  // a lane's channels when listing
  using F = Fold<H2>;
  static_assert(C1 % 16 == 0 && C2 % 16 == 0 && C3 % 32 == 0 && C3 <= 256, "widths");
  static_assert(HOLD || (C1 % 128 == 0 && C2 % 128 == 0 && C3 % 128 == 0), "chunked widths");

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<C1, C2, C3> L;
  uint16_t* w2s = reinterpret_cast<uint16_t*>(smem + L.w2);
  uint16_t* w3s = reinterpret_cast<uint16_t*>(smem + L.w3);
  uint16_t* h0s = reinterpret_cast<uint16_t*>(smem + L.h0);
  uint16_t* h1s = reinterpret_cast<uint16_t*>(smem + L.h1);
  uint16_t* dxs = reinterpret_cast<uint16_t*>(smem + L.dx);
  uint16_t* ds = reinterpret_cast<uint16_t*>(smem + L.u);
  float* dh0s = reinterpret_cast<float*>(smem + L.u);
  uint32_t* hash = reinterpret_cast<uint32_t*>(smem + L.u);
  float* red = reinterpret_cast<float*>(smem + L.u);
  uint16_t* bcs = reinterpret_cast<uint16_t*>(smem + L.bc);
  int16_t* row_of = reinterpret_cast<int16_t*>(smem + L.row_of);
  int* row_rel = reinterpret_cast<int*>(smem + L.row_rel);
  uint16_t* gbs = reinterpret_cast<uint16_t*>(smem + L.gb);
  float* dbcs = reinterpret_cast<float*>(smem + L.dbc);
  float* b2s = reinterpret_cast<float*>(smem + L.vec);
  float* s2s = b2s + C2;
  float* lb2s = s2s + C2;
  float* xs = reinterpret_cast<float*>(smem + L.xs);  // [2 uses][2 warpgroups][64 rows][2]
  int* mpos = reinterpret_cast<int*>(smem + L.meta);  // tile row -> A row, or -1
  int* mcc = mpos + kRows;                            // tile row -> center, or -1
  int* mloc = mcc + kRows;                            // tile row -> row of its center
  int* mnext = mloc + kRows;  // tile row -> the tile's next row of its position, or -1
  int* mlead = mnext + kRows; // tile row -> 1 where it is its position's first row
  int* rstart = reinterpret_cast<int*>(smem + L.rstart);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = tid / 128, wq = warp % 4;  // warpgroup; its warp: tile rows 16 wq ..
  const int g8 = lane / 4, t4 = lane % 4;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kCenters;
  const size_t cm0 = (size_t)b * M + m0;  // the CTA's first center
  int start = starts[(size_t)b * gridDim.x + blockIdx.x];
  start = min(max(start, 0), N - W);
  float* rec = records + ((size_t)b * gridDim.x + blockIdx.x) * P;
  float* drec = da_records + ((size_t)b * gridDim.x + blockIdx.x) * (size_t)W * C1;
  const int pos0 = b * N + start;  // the A row of the window's first point

  // ---- weights, vectors, the centers' bc; zero the padded tiles and db_c
  stage_kmajor<kThreads>(w2s, w2, C1, C2);
  for (int i = tid; i < C2 * C3 / 8; i += kThreads) {  // W3 rows are already K-major
    const int r = i / (C3 / 8), cb = i % (C3 / 8);
    *reinterpret_cast<uint4*>(w3s + core_at(r, 8 * cb, C3)) =
        *reinterpret_cast<const uint4*>(w3 + (size_t)r * C3 + 8 * cb);
  }
  for (int i = tid; i < kCenters * C1 / 8; i += kThreads)
    reinterpret_cast<uint4*>(bcs)[i] = reinterpret_cast<const uint4*>(bc + cm0 * C1)[i];
  for (int i = tid; i < C2; i += kThreads) {
    b2s[i] = b2[i];
    s2s[i] = s2[i];
    lb2s[i] = lb2[i];
  }
  for (int i = tid; i < kRows * CP1 / 8; i += kThreads)
    reinterpret_cast<uint4*>(h0s)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < kRows * CP2 / 8; i += kThreads)
    reinterpret_cast<uint4*>(h1s)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < kCenters * C1; i += kThreads) dbcs[i] = 0.f;

  // ---- each warp lists its centers' live rows, in channel order
  {
    uint32_t* T = hash + warp * kHash;
    const uint32_t lt = (1u << lane) - 1u;
    for (int cc = warp; cc < kCenters; cc += kWarps) {
      const float* gc = g + (cm0 + cc) * C3;
      const int* wc = win + (cm0 + cc) * C3;
      int16_t* rof = row_of + cc * C3;
      int* rrel = row_rel + cc * C3;
      for (int o = lane; o < C3; o += 32)
        gbs[cc * C3 + o] = __bfloat16_as_ushort(__float2bfloat16_rn(gc[o]));
      int n = 0;
      if constexpr (COMPACT) {
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          const int o = 32 * i + lane;
          const bool live = gc[o] != 0.f;
          const int rel = wc[o] - start;
          const uint32_t mask = __ballot_sync(0xffffffffu, live);
          const int idx = n + __popc(mask & lt);
          rof[o] = live ? idx : -1;
          if (live) rrel[idx] = rel >= 0 && rel < W ? rel : -1;  // outside: a zero A row
          n += __popc(mask);
        }
      } else {
        for (int i = lane; i < kHash; i += 32) T[i] = kEmpty;
        __syncwarp();
        int rel[NO];
        bool live[NO];
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          const int o = 32 * i + lane;
          rel[i] = wc[o] - start;
          live[i] = gc[o] != 0.f && rel[i] >= 0 && rel[i] < W;
          if (live[i]) hash_insert<kHashLog, kHashOb>(T, rel[i], o);
        }
        __syncwarp();
        int lead[NO];
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          const int o = 32 * i + lane;
          lead[i] = live[i] ? hash_leader<kHashLog, kHashOb>(T, rel[i]) : -1;
          const uint32_t mask = __ballot_sync(0xffffffffu, lead[i] == o);
          const int idx = n + __popc(mask & lt);
          if (lead[i] == o) {
            rof[o] = idx;
            rrel[idx] = rel[i];
          }
          n += __popc(mask);
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          const int o = 32 * i + lane;
          if (lead[i] < 0) rof[o] = -1;
          else if (lead[i] != o) rof[o] = rof[lead[i]];
        }
        __syncwarp();  // the table is cleared for the warp's next center
      }
      if (lane == 0) rstart[cc + 1] = n;
    }
  }
  __syncthreads();
  if (tid == 0) {
    rstart[0] = 0;
    for (int cc = 0; cc < kCenters; ++cc) rstart[cc + 1] += rstart[cc];
  }
  // db3: the live channels' cotangents, summed over the centers in order
  for (int o = tid; o < C3; o += kThreads) {
    float s = 0.f;
    for (int cc = 0; cc < kCenters; ++cc)
      if (row_of[cc * C3 + o] >= 0) s += g[(cm0 + cc) * C3 + o];
    rec[C1 * C2 + C2 * C3 + 3 * C2 + o] = s;
  }
  __syncthreads();

  const int nr = rstart[kCenters];
  const int tiles = (nr + kRows - 1) / kRows;
  const uint32_t w2_base = smem_u32(w2s), w3_base = smem_u32(w3s);
  const uint32_t h0_base = smem_u32(h0s), h1_base = smem_u32(h1s);
  const uint32_t dx_base = smem_u32(dxs), d_base = smem_u32(ds);
  const int r0 = 16 * wq + g8;  // the thread's tile rows r0, r0 + 8
  const int c2 = wg * H2;       // the warpgroup's first column of C2 (C1: wg * H1)

  float run[3][F::NR];  // db2, ds2, dlb2 column sums
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < F::NR; ++i) run[q][i] = 0.f;
  float acc_w2[HOLD ? H2 / 2 : 1], acc_w3[HOLD ? H3 / 2 : 1];
#pragma unroll
  for (int i = 0; i < (HOLD ? H2 / 2 : 1); ++i) acc_w2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (HOLD ? H3 / 2 : 1); ++i) acc_w3[i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int rows = min(kRows, nr - t * kRows);
    // ---- the tile's rows: center, row of the center, A row
    if (tid < kRows) {
      const int r = t * kRows + tid;
      int cc = -1, loc = 0, pos = -1;
      if (tid < rows) {
        cc = 0;
        while (rstart[cc + 1] <= r) ++cc;
        loc = r - rstart[cc];
        const int rel = row_rel[cc * C3 + loc];
        if (rel >= 0) pos = b * N + start + rel;
      }
      mcc[tid] = cc;
      mloc[tid] = loc;
      mpos[tid] = pos;
    }
    __syncthreads();
    // ---- the tile's rows of one position: the first leads, each links the next
    if (tid < rows) {
      const int pos = mpos[tid];
      int nx = -1, lead = pos >= 0;
      for (int r = 0; r < rows; ++r) {
        if (mpos[r] != pos) continue;
        if (r < tid) lead = 0;
        else if (r > tid && nx < 0) nx = r;
      }
      mnext[tid] = nx;
      mlead[tid] = lead;
    }
    // ---- H0 = bf16(relu(A + bc)) and D, 16 bytes a thread at a time (the
    // 8 threads of a quarter warp on the 8 rows of one core: no conflicts).
    // The thread's A loads are in flight while D is built.
    constexpr int NA = (kRows * C1 / 8 + kThreads - 1) / kThreads;
    uint4 a[NA];
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      const int i = tid + k * kThreads;
      const int kb = (i >> 3) % (C1 / 8), r = ((i >> 3) / (C1 / 8)) * 8 + (i & 7);
      const int pos = i < kRows * C1 / 8 ? mpos[r] : -1;
      a[k] = pos >= 0 ? __ldg(reinterpret_cast<const uint4*>(A + (size_t)pos * C1) + kb)
                      : make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < kRows * C3 / 8; i += kThreads) {
      const int ob = (i >> 3) % (C3 / 8), r = ((i >> 3) / (C3 / 8)) * 8 + (i & 7);
      const int cc = mcc[r];
      uint4 v = make_uint4(0, 0, 0, 0);
      if (cc >= 0) {
        const int16_t loc = int16_t(mloc[r]);
        const uint4 ro = reinterpret_cast<const uint4*>(row_of + cc * C3)[ob];
        const uint4 gb = reinterpret_cast<const uint4*>(gbs + cc * C3)[ob];
        const uint32_t rw[4] = {ro.x, ro.y, ro.z, ro.w}, gw[4] = {gb.x, gb.y, gb.z, gb.w};
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = (int16_t(rw[e] & 0xffffu) == loc ? gw[e] & 0xffffu : 0u) |
                 (int16_t(rw[e] >> 16) == loc ? gw[e] & 0xffff0000u : 0u);
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(ds + core_at(r, 8 * ob, C3)) = v;
    }
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      const int i = tid + k * kThreads;
      if (i >= kRows * C1 / 8) break;
      const int kb = (i >> 3) % (C1 / 8), r = ((i >> 3) / (C1 / 8)) * 8 + (i & 7);
      const int cc = mcc[r];
      uint4 v = make_uint4(0, 0, 0, 0);
      if (cc >= 0) {
        const uint4 c = reinterpret_cast<const uint4*>(bcs + cc * C1)[kb];
        v = make_uint4(add_relu_bf16x2(a[k].x, c.x), add_relu_bf16x2(a[k].y, c.y),
                       add_relu_bf16x2(a[k].z, c.z), add_relu_bf16x2(a[k].w, c.w));
      }
      *reinterpret_cast<uint4*>(h0s + core_at(r, 8 * kb, CP1)) = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // ---- GEMM1 X = H0 W2 and GEMM2 dh1 = D W3^T, issued together; each
    // warpgroup computes its H2 columns
    float acc1[H2 / 2], accd[H2 / 2];
    {
      const uint32_t h0b = opaque(h0_base), w2b = opaque(w2_base) + (c2 / 8) * C1 * 16;
      const uint32_t db = opaque(d_base), w3b = opaque(w3_base) + (c2 / 8) * C3 * 16;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < C1 / 16; ++s)
        wgmma_ss<H2, 0, 0>(acc1, make_desc(h0b + 256 * s, 128, CP1 * 16),
                           make_desc(w2b + 256 * s, 128, C1 * 16), s > 0);
      wgmma_commit();
#pragma unroll
      for (int s = 0; s < C3 / 16; ++s)
        wgmma_ss<H2, 0, 0>(accd, make_desc(db + 256 * s, 128, C3 * 16),
                           make_desc(w3b + 256 * s, 128, C3 * 16), s > 0);
      wgmma_commit();
    }
    wgmma_wait<1>();
    fence_regs(acc1);

    // ---- LN forward in the accumulator: acc1 becomes xhat; h1 to shared
    float mean[2], rstd[2];
    ln_stats<C2, H2>(acc1, b2s, xs, wg, r0, t4, c2f, rc2, mean, rstd);
    uint32_t pos_bits[(H2 / 2 + 31) / 32];  // h1 > 0, one bit an accumulator
    ln_h1<H2>(acc1, mean, rstd, s2s, lb2s, h1s, CP2, wg, r0, t4, pos_bits);
    wgmma_wait<0>();
    fence_regs(accd);

    // ---- LN + ReLU backward: accd becomes dln, then dxhat, then dx
    ln_relu_backward<C2, H2>(accd, acc1, pos_bits, rstd, s2s, dxs, xs, wg, r0, t4, lane, c2f,
                             rc2, run);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // ---- weight gradients over the tile's rows: dW2 = H0^T DX, dW3 = H1^T D,
    // each warpgroup its half of the columns
    if constexpr (HOLD) {
      wgmma_fence();
      wgmma_rows<H2>(acc_w2, opaque(h0_base), CP1, 0, opaque(dx_base), C2, c2, 1);
      wgmma_rows<H3>(acc_w3, opaque(h1_base), CP2, 0, opaque(d_base), C3, wg * H3, 1);
      wgmma_commit();
    } else {
      // 64 x 64 chunks added to the CTA's record by the element's owner; a
      // chunk's record loads are in flight while its product runs
      auto chunk = [&](uint32_t x, int XC, int mi, uint32_t y, int YC, int ni, float* out) {
        float acc[32];
        wgmma_fence();
        wgmma_rows<64>(acc, opaque(x), XC, 64 * mi, opaque(y), YC, 64 * ni, 0);
        wgmma_commit();
        float* base = out + (size_t)(64 * mi + r0) * YC + 64 * ni + 2 * t4;
        float2 old[16];
#pragma unroll
        for (int k = 0; k < 16; ++k)
          old[k] = t > 0 ? *reinterpret_cast<const float2*>(base + (k & 1) * 8 * YC + 8 * (k >> 1))
                         : make_float2(0.f, 0.f);
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int j = k >> 1, h = k & 1;
          *reinterpret_cast<float2*>(base + h * 8 * YC + 8 * j) =
              make_float2(old[k].x + acc[4 * j + 2 * h], old[k].y + acc[4 * j + 2 * h + 1]);
        }
      };
      // warpgroup wg takes the chunks of column blocks ni = 2k + wg. The row
      // blocks mi stay a loop: unrolled, the chunks' addresses were computed
      // ahead and held in registers, and the kernel spilled.
#pragma unroll 1
      for (int mi = 0; mi < C1 / 64; ++mi)
#pragma unroll
        for (int k = 0; k < C2 / 128; ++k)
          chunk(h0_base, CP1, mi, dx_base, C2, 2 * k + wg, rec);
#pragma unroll 1
      for (int mi = 0; mi < C2 / 64; ++mi)
#pragma unroll
        for (int k = 0; k < C3 / 128; ++k)
          chunk(h1_base, CP2, mi, d_base, C3, 2 * k + wg, rec + C1 * C2);
    }

    // ---- GEMM3 dh0 = bf16(dx) W2^T (W2 read MN-major), each warpgroup its
    // H1 columns
    float acc3[H1 / 2];
    {
      const uint32_t dxb = opaque(dx_base), w2b = opaque(w2_base) + (wg * H1 / 8) * 128;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < C2 / 16; ++s)
        wgmma_ss<H1, 0, 1>(acc3, make_desc(dxb + 256 * s, 128, C2 * 16),
                           make_desc(w2b + s * 32 * C1, C1 * 16, 128), s > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc3);
    if constexpr (HOLD) {
      fence_regs(acc_w2);
      fence_regs(acc_w3);
    }
    __syncthreads();  // every product that reads D is done: dh0 takes its place
    // dh0 through the first ReLU (h0 > 0 exactly where A + bc > 0; the sign
    // bit is masked off, since max(-0, 0) may keep -0)
#pragma unroll
    for (int j = 0; j < H1 / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, c = wg * H1 + 8 * j + 2 * t4;
        const uint32_t hb = *reinterpret_cast<const uint32_t*>(h0s + core_at(r, c, CP1));
        const float2 v = make_float2((hb & 0x7fffu) ? acc3[4 * j + 2 * h] : 0.f,
                                     (hb & 0x7fff0000u) ? acc3[4 * j + 2 * h + 1] : 0.f);
        *reinterpret_cast<float2*>(dh0s + dh0_at<C1>(r, c)) = v;
      }
    }
    __syncthreads();
    // db_c: each center's rows, in row order, center by center
    if (tid < C1) {
      for (int cc = mcc[0], r = 0; r < rows; ++cc) {
        const int end = min(rstart[cc + 1] - t * kRows, rows);
        float s = 0.f;
#pragma unroll 4
        for (; r < end; ++r) s += dh0s[dh0_at<C1>(r, tid)];
        dbcs[cc * C1 + tid] += s;
      }
    }
    // dA: each leader adds its position's rows, in row order, into the record
    for (int i = tid; i < rows * (C1 / 4); i += kThreads) {
      const int r = i / (C1 / 4), q = i % (C1 / 4);
      if (!mlead[r]) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int n = r; n >= 0; n = mnext[n]) {
        float4 u = *reinterpret_cast<const float4*>(dh0s + dh0_at<C1>(n, 4 * q));
        if constexpr (COMPACT) {
          u.x = __bfloat162float(__float2bfloat16_rn(u.x));
          u.y = __bfloat162float(__float2bfloat16_rn(u.y));
          u.z = __bfloat162float(__float2bfloat16_rn(u.z));
          u.w = __bfloat162float(__float2bfloat16_rn(u.w));
        }
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      float4* dst = reinterpret_cast<float4*>(drec + (size_t)(mpos[r] - pos0) * C1 + 4 * q);
      float4 o = *dst;
      o.x += v.x;
      o.y += v.y;
      o.z += v.z;
      o.w += v.w;
      *dst = o;
    }
    __syncthreads();  // the tile's buffers are rewritten by the next tile
  }

  // ---- the CTA's record: weight gradients, column sums; db_c
  if constexpr (HOLD) {
#pragma unroll
    for (int j = 0; j < H2 / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r0 + 8 * h < C1)
          *reinterpret_cast<float2*>(rec + (r0 + 8 * h) * C2 + c2 + 8 * j + 2 * t4) =
              make_float2(acc_w2[4 * j + 2 * h], acc_w2[4 * j + 2 * h + 1]);
#pragma unroll
    for (int j = 0; j < H3 / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r0 + 8 * h < C2)
          *reinterpret_cast<float2*>(rec + C1 * C2 + (r0 + 8 * h) * C3 + wg * H3 + 8 * j +
                                     2 * t4) =
              make_float2(acc_w3[4 * j + 2 * h], acc_w3[4 * j + 2 * h + 1]);
  } else if (tiles == 0) {
    for (int i = tid; i < C1 * C2 + C2 * C3; i += kThreads) rec[i] = 0.f;
  }
  write_column_sums<C2, H2>(run[0], red, rec + C1 * C2 + C2 * C3, tid);
  for (int i = tid; i < kCenters * C1; i += kThreads) dbc[cm0 * C1 + i] = dbcs[i];
}

// ---- the compact kernel at (c1, c2, c3) = (128, 128, 256): the width-2
// backbone's SA1, 4.16 M live rows (65 000 tiles) at batch 8

constexpr int kCpC1 = 128, kCpC2 = 128, kCpC3 = 256;
constexpr int kCpQ = 64;              // channels a quarter of c3
constexpr int kCpNQ = kCpC3 / kCpQ;   // quarters
constexpr int kCpAccLd = kCpQ + 8;    // f32 row stride of the dW3 quarter sums (no conflicts)

struct CompactLayout {
  size_t w2, w3q, h0, h1, dx, dq, dw2, acc, rows, dbc, vec, xs, meta, masks, qs, total;
  __host__ __device__ CompactLayout() {
    size_t o = 0;
    w2 = o;    o += align128((size_t)kCpC1 * kCpC2 * 2);
    w3q = o;   o += align128((size_t)kCpC2 * kCpQ * 2);    // W3's columns of a quarter
    h0 = o;    o += align128((size_t)kRows * kCpC1 * 2);
    h1 = o;    o += align128((size_t)kRows * kCpC2 * 2);  // h1, then dx: dh0 (f32) takes both
    dx = o;    o += align128((size_t)kRows * kCpC2 * 2);
    dq = o;    o += align128((size_t)kRows * kCpQ * 2);
    dw2 = o;   o += align128((size_t)kCpC1 * kCpC2 * 4);
    acc = o;   o += align128((size_t)kCpC2 * kCpAccLd * 4);
    rows = o;  o += align128((size_t)kCenters * kCpC3 * 2);
    dbc = o;   o += align128((size_t)kCenters * kCpC1 * 4);
    vec = o;   o += align128((size_t)3 * kCpC2 * 4);
    xs = o;    o += align128((size_t)4 * kRows * 2 * 4);
    meta = o;  o += align128((size_t)10 * kRows * 4);  // two tiles' rows, positions
    masks = o; o += align128((size_t)kCenters * (kCpC3 / 32) * 4);
    qs = o;    o += align128((size_t)(kCpNQ * (kCenters + 1) + 2 * (kCpNQ + 1) + 1) * 4);
    total = o;
  }
};
static_assert((size_t)kRows * kCpC2 * 2 * 2 >= (size_t)kRows * kCpC1 * 4,
              "dh0 fits in h1's and dx's bytes");

// Row r of a tile whose rows start at list entry `first` (n rows in all):
// its center, channel, A row (-1 outside the window) and bf16(g) bits, from
// the row list and device memory; past the tile's rows -1, 0, -1, 0.
struct TileRow {
  int cc = -1, o = 0, pos = -1, gb = 0;
};
__device__ __forceinline__ TileRow tile_row(const int16_t* rowl, int first, int n, int r,
                                            const float* __restrict__ g,
                                            const int* __restrict__ win, size_t cm0, int start,
                                            int W, int pos0) {
  TileRow v;
  if (r < n) {
    const int e = rowl[first + r];
    v.cc = e >> 8;
    v.o = e & 255;
    const size_t at = (cm0 + v.cc) * kCpC3 + v.o;
    const float gv = g[at];
    const int rel = win[at] - start;
    if (rel >= 0 && rel < W) v.pos = pos0 + rel;
    v.gb = __bfloat16_as_ushort(__float2bfloat16_rn(gv));
  }
  return v;
}

// `bytes` (a multiple of 16) at `p` into L2, without waiting
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// The distinct positions of a tile's 64 rows, by one warp (lane l holds rows
// l and l + 32; a key < 0 is no position): rank[r] the index of row r's
// position among them in order of first appearance (-1 for none), pos[p] the
// position of index p, *n their number.
__device__ __forceinline__ void rank_rows(int key_lo, int key_hi, int lane, int* rank,
                                          int* pos, int* n) {
  const int klo = key_lo >= 0 ? key_lo : -1 - lane, khi = key_hi >= 0 ? key_hi : -33 - lane;
  const uint32_t m_lo = __match_any_sync(0xffffffffu, klo);
  const uint32_t m_hi = __match_any_sync(0xffffffffu, khi);
  int first_lo = -1;  // the first low row with the high row's key
  for (int j = 0; j < 32; ++j)
    if (__shfl_sync(0xffffffffu, klo, j) == khi && first_lo < 0) first_lo = j;
  const uint32_t below = (1u << lane) - 1u;
  const bool lead_lo = key_lo >= 0 && !(m_lo & below);
  const bool lead_hi = key_hi >= 0 && !(m_hi & below) && first_lo < 0;
  const uint32_t l_lo = __ballot_sync(0xffffffffu, lead_lo);
  const uint32_t l_hi = __ballot_sync(0xffffffffu, lead_hi);
  const auto rank_lo = [&](int lead) { return __popc(l_lo & ((1u << lead) - 1u)); };
  const auto rank_hi = [&](int lead) { return __popc(l_lo) + __popc(l_hi & ((1u << lead) - 1u)); };
  const int r_lo = key_lo >= 0 ? rank_lo(__ffs(m_lo) - 1) : -1;
  const int r_hi = key_hi < 0 ? -1 : first_lo >= 0 ? rank_lo(first_lo) : rank_hi(__ffs(m_hi) - 1);
  rank[lane] = r_lo;
  rank[32 + lane] = r_hi;
  if (lead_lo) pos[r_lo] = key_lo;
  if (lead_hi) pos[r_hi] = key_hi;
  if (lane == 0) *n = __popc(l_lo) + __popc(l_hi);
}

// dW2's sums in shared memory: (row k, column c) at k C2 + (c ^ 8 (k % 4)),
// so that the accumulator layout's float2 adds do not conflict
__device__ __forceinline__ int dw2_at(int k, int c) { return k * kCpC2 + (c ^ ((k & 3) << 3)); }

// The compact rows at (128, 128, 256), one persistent CTA an SM. A CTA a block
// that added each tile's dW2 and dense dW3 products (64 x 64 chunks) to the
// block's record in device memory (pool_bwd_tiles) would move 393 KB of
// read-modify-write a tile, 26 GB a batch-8 call, and run GEMM2 and dW3 over
// the one-hot D as dense products. Here:
//   * CTA i of ctas = min(blocks, SMs) takes blocks i, i + ctas, ... in order
//     and keeps one record; reduce_records adds ctas records.
//   * A block's rows go quarter by quarter of c3 (channels 64 q .. + 64),
//     center by center, in channel order; a quarter starts a new tile.
//   * The one-hot products cover the tile's quarter only: D_q (64 rows x 64
//     channels, one bf16(g) a row) times the quarter's W3 columns (GEMM2, K =
//     64; the columns staged at the quarter's first tile) and H1^T D_q (dW3's
//     quarter), a quarter of the dense products' work; exact products as
//     before.
//   * dW2 = H0^T DX is summed over all the CTA's tiles in shared memory (f32):
//     each tile's product, 64 rows at a time, added by the thread that holds
//     it. dW3's tile product likewise into the quarter's sums, added to the
//     record once a quarter. No weight-gradient sum lives in registers
//     across the tile, so the tile's products have the registers they need.
//   * dA: a tile's rows of one position are summed by a one-hot product,
//     P^T bf16(dh0) (positions x rows times rows x c1: the rows' exact bf16
//     values, f32 sums), and each position's sums added to its record row by
//     the thread that holds them, the loads in flight together. db_c is
//     summed on the CUDA cores meanwhile, a half of the rows a warpgroup.
//     A block's dA record is zeroed by its CTA at the block's start, in the
//     background of its work, where a memset pass over all of them (537 MB
//     at batch 8) took 0.16 ms of the call's 5.7 on an H100.
//   * A tile's rows (list entry, g, winner) are loaded during the last tile,
//     and its A rows and dA record rows sent to L2 then; a quarter's record
//     columns go to L2 at its last tile.
// Shared memory: W2 32 KiB, W3's quarter, H0, h1 and dx 16 KiB each (dh0 in
// h1's and dx's bytes), D_q 8 KiB, dW2 64 KiB, the dW3 quarter 36 KiB, the row
// list and db_c 8 KiB each, vectors and row metadata 7 KiB: 232 320 bytes.
__global__ void __launch_bounds__(kThreads, 1)
pool_bwd_compact(const uint16_t* __restrict__ A, const uint16_t* __restrict__ bc,
                 const float* __restrict__ g, const int* __restrict__ win,
                 const int* __restrict__ starts, const uint16_t* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ s2,
                 const float* __restrict__ lb2, const uint16_t* __restrict__ w3, int B, int N,
                 int M, int W, float c2f, float rc2, float* __restrict__ dbc,
                 float* __restrict__ records, float* __restrict__ da_records) {
  constexpr int C1 = kCpC1, C2 = kCpC2, C3 = kCpC3;
  constexpr int P = record_floats(C1, C2, C3);
  constexpr int H1 = C1 / 2, H2 = C2 / 2;
  constexpr int NO = C3 / 32;  // a lane's channels when listing
  using F = Fold<H2>;
  static_assert(C3 == kThreads, "db3: one channel a thread");
  static_assert(H1 == H2 && H2 == kCpQ, "one accumulator size");

  extern __shared__ __align__(128) unsigned char smem[];
  const CompactLayout L;
  uint16_t* w2s = reinterpret_cast<uint16_t*>(smem + L.w2);
  uint16_t* w3q = reinterpret_cast<uint16_t*>(smem + L.w3q);  // rows k, the quarter's columns
  uint16_t* h0s = reinterpret_cast<uint16_t*>(smem + L.h0);
  uint16_t* h1s = reinterpret_cast<uint16_t*>(smem + L.h1);
  uint16_t* dxs = reinterpret_cast<uint16_t*>(smem + L.dx);
  uint16_t* dqs = reinterpret_cast<uint16_t*>(smem + L.dq);
  float* dh0s = reinterpret_cast<float*>(smem + L.h1);   // over h1 and dx
  float* dw2s = reinterpret_cast<float*>(smem + L.dw2);  // dW2 (dw2_at)
  float* accq = reinterpret_cast<float*>(smem + L.acc);  // dW3 quarter: [k][channel]
  float* red = accq;  // the column sums' partials, at the end
  int16_t* rowl = reinterpret_cast<int16_t*>(smem + L.rows);  // center << 8 | channel
  float* dbcs = reinterpret_cast<float*>(smem + L.dbc);
  float* b2s = reinterpret_cast<float*>(smem + L.vec);
  float* s2s = b2s + C2;
  float* lb2s = s2s + C2;
  float* xs = reinterpret_cast<float*>(smem + L.xs);  // [2 uses][2 warpgroups][64 rows][2]
  // a tile's rows, two tiles' in turn ([4][64] each): row -> A row, or -1;
  // center, or -1; channel (0 past the rows); bf16(g) bits (0 past the rows)
  int* meta = reinterpret_cast<int*>(smem + L.meta);
  int* mrank = meta + 8 * kRows;  // row -> the index of its position in the tile, or -1
  int* mppos = mrank + kRows;     // index -> the A row of the tile's position
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + L.masks);  // [center][32 channels] live
  int* qoff = reinterpret_cast<int*>(smem + L.qs);  // [quarter][center] rows before; [q][16] all
  int* qbase = qoff + kCpNQ * (kCenters + 1);       // [q] the quarter's first row of the list
  int* qtile = qbase + kCpNQ + 1;                    // [q] the quarter's first tile
  int* mnpos = qtile + kCpNQ + 1;                    // the tile's number of positions

  const int n_blk = M / kCenters;
  float* rec = records + (size_t)blockIdx.x * P;
  const uint32_t w2_base = smem_u32(w2s), w3_base = smem_u32(w3q), h0_base = smem_u32(h0s);
  const uint32_t h1_base = smem_u32(h1s), dx_base = smem_u32(dxs), dq_base = smem_u32(dqs);

  // ---- weights and vectors, once; the sums zeroed, and the record's dW3,
  // which the quarters add to (each element by the thread that adds to it)
  {
    const int tid = threadIdx.x;
    stage_kmajor<kThreads>(w2s, w2, C1, C2);
    for (int i = tid; i < C2; i += kThreads) {
      b2s[i] = b2[i];
      s2s[i] = s2[i];
      lb2s[i] = lb2[i];
    }
    for (int i = tid; i < C1 * C2; i += kThreads) dw2s[i] = 0.f;
    for (int i = tid; i < C2 * kCpAccLd; i += kThreads) accq[i] = 0.f;
    for (int q = 0; q < kCpNQ; ++q)
      for (int i = tid; i < C2 * kCpQ; i += kThreads)
        rec[C1 * C2 + (i / kCpQ) * C3 + kCpQ * q + i % kCpQ] = 0.f;
  }

  float run[3][F::NR];  // db2, ds2, dlb2 column sums
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < F::NR; ++i) run[q][i] = 0.f;
  float db3 = 0.f;  // channel threadIdx.x

  // ---- the CTA's blocks of 16 centers, blockIdx.x + gridDim.x k, in order
  for (int blk = blockIdx.x; blk < B * n_blk; blk += gridDim.x) {
    // the thread's index opaque in each block, so that the many offsets
    // derived from it are computed where they are used
    const int tid = (int)opaque(threadIdx.x);
    const int warp = tid / 32, lane = tid % 32;
    const int b = blk / n_blk;
    const size_t cm0 = (size_t)b * M + (blk % n_blk) * kCenters;
    int start = starts[blk];
    start = min(max(start, 0), N - W);
    const int pos0 = b * N + start;  // the A row of the window's first point
    float* drec = da_records + (size_t)blk * W * C1;
    // the block's dA record zeroed here, in the background of the block's
    // work, instead of by a memset pass over all records; the block's adds
    // into it follow the barriers below
    for (int i = tid; i < W * C1 / 4; i += kThreads)
      reinterpret_cast<float4*>(drec)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();  // the last block's tables are read
    for (int i = tid; i < kCenters * C1; i += kThreads) dbcs[i] = 0.f;
    // each warp its centers' live channels
    for (int cc = warp; cc < kCenters; cc += kWarps) {
      const float* gc = g + (cm0 + cc) * C3;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const uint32_t m = __ballot_sync(0xffffffffu, gc[32 * i + lane] != 0.f);
        if (lane == 0) masks[cc * NO + i] = m;
      }
    }
    // db3: the live channels' cotangents, over the block's centers in order
    {
      float s = 0.f;
      for (int cc = 0; cc < kCenters; ++cc) {
        const float gv = g[(cm0 + cc) * C3 + tid];
        if (gv != 0.f) s += gv;
      }
      db3 += s;
    }
    __syncthreads();
    if (tid < kCpNQ) {  // a quarter's rows before each center
      int n = 0;
      for (int cc = 0; cc < kCenters; ++cc) {
        qoff[tid * (kCenters + 1) + cc] = n;
        n += __popc(masks[cc * NO + 2 * tid]) + __popc(masks[cc * NO + 2 * tid + 1]);
      }
      qoff[tid * (kCenters + 1) + kCenters] = n;
    }
    __syncthreads();
    if (tid == 0) {
      qbase[0] = qtile[0] = 0;
      for (int q = 0; q < kCpNQ; ++q) {
        const int n = qoff[q * (kCenters + 1) + kCenters];
        qbase[q + 1] = qbase[q] + n;
        qtile[q + 1] = qtile[q] + (n + kRows - 1) / kRows;
      }
    }
    __syncthreads();
    // the row list: each warp its centers' rows
    for (int cc = warp; cc < kCenters; cc += kWarps) {
      const uint32_t lt = (1u << lane) - 1u;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int q = i / 2;
        const uint32_t m = masks[cc * NO + i];
        if ((m >> lane) & 1u) {
          const int at = qbase[q] + qoff[q * (kCenters + 1) + cc] +
                         ((i & 1) ? __popc(masks[cc * NO + i - 1]) : 0) + __popc(m & lt);
          rowl[at] = int16_t((cc << 8) | (32 * i + lane));
        }
      }
    }
    __syncthreads();

    const int tiles = qtile[kCpNQ];
    // tile t's quarter, first row of the list and rows
    const auto tile_range = [&](int t, int& q, int& first, int& rows) {
      q = 0;
      while (qtile[q + 1] <= t) ++q;
      first = qbase[q] + (t - qtile[q]) * kRows;
      rows = min(kRows, qbase[q + 1] - first);
    };
    // a tile's rows into meta buffer `buf`, row tid % 64 (the dA record row
    // into L2); the first tile's here, each next tile's during the last one
    const auto put_row = [&](int buf, int r, const TileRow& v) {
      int* m = meta + buf * 4 * kRows;
      m[r] = v.pos;
      m[kRows + r] = v.cc;
      m[2 * kRows + r] = v.o;
      m[3 * kRows + r] = v.gb;
      if (v.pos >= 0) prefetch_l2(drec + (size_t)(v.pos - pos0) * C1, C1 * 4);
    };
    if (tid < kRows && tiles > 0) {
      int q0, f0, n0;
      tile_range(0, q0, f0, n0);
      put_row(0, tid, tile_row(rowl, f0, n0, tid, g, win, cm0, start, W, pos0));
    }
    __syncthreads();
    for (int t = 0; t < tiles; ++t) {
      const int tid = (int)opaque(threadIdx.x);
      const int warp = tid / 32, lane = tid % 32;
      const int wg = tid / 128;                 // warpgroup
      const int g8 = lane / 4, t4 = lane % 4;
      const int r0 = 16 * (warp % 4) + g8;      // the thread's tile rows r0, r0 + 8
      const int c2 = wg * H2;                   // the warpgroup's first column of C2 (and C1)
      int q, first, rows;  // the tile's quarter, first row of the list, rows
      tile_range(t, q, first, rows);
      const int* mpos = meta + (t & 1) * 4 * kRows;  // the tile's rows
      const int* mcc = mpos + kRows;
      const int* mo = mcc + kRows;
      const int* mg = mo + kRows;
      // ---- the quarter's first tile: its W3 columns (rows c2, K-major); its
      // last: into L2, the record columns that it adds to
      if (t == qtile[q])
        for (int i = tid; i < C2 * kCpQ / 8; i += kThreads) {
          const int k = i / (kCpQ / 8), cb = i % (kCpQ / 8);
          *reinterpret_cast<uint4*>(w3q + core_at(k, 8 * cb, kCpQ)) =
              __ldg(reinterpret_cast<const uint4*>(w3 + (size_t)k * C3 + kCpQ * q + 8 * cb));
        }
      if (t + 1 == qtile[q + 1] && tid >= 2 * kRows)
        for (int k = tid - 2 * kRows; k < C2; k += kThreads - 2 * kRows)
          prefetch_l2(rec + C1 * C2 + (size_t)k * C3 + kCpQ * q, kCpQ * 4);
      // ---- the next tile's rows, by warps 2-3: the loads issued here, the
      // rows stored (and its A rows and dA record rows sent to L2) once
      // GEMM1 and GEMM2 are issued
      TileRow next;
      if (tid >= kRows && tid < 2 * kRows && t + 1 < tiles) {
        int qn, fn, nn;
        tile_range(t + 1, qn, fn, nn);
        next = tile_row(rowl, fn, nn, tid - kRows, g, win, cm0, start, W, pos0);
      }
      // ---- H0 = bf16(relu(A + bc)), 16 bytes a thread at a time (the 8
      // threads of a quarter warp on the 8 rows of one core: no conflicts)
      {
        constexpr int NA = kRows * C1 / 8 / kThreads;
        uint4 a[NA], c[NA];
#pragma unroll
        for (int k = 0; k < NA; ++k) {
          const int i = tid + k * kThreads;
          const int kb = (i >> 3) % (C1 / 8), r = ((i >> 3) / (C1 / 8)) * 8 + (i & 7);
          const int pos = mpos[r], cc = mcc[r];
          a[k] = pos >= 0 ? __ldg(reinterpret_cast<const uint4*>(A + (size_t)pos * C1) + kb)
                          : make_uint4(0, 0, 0, 0);
          c[k] = cc >= 0 ? __ldg(reinterpret_cast<const uint4*>(bc + (cm0 + cc) * C1) + kb)
                         : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int k = 0; k < NA; ++k) {
          const int i = tid + k * kThreads;
          const int kb = (i >> 3) % (C1 / 8), r = ((i >> 3) / (C1 / 8)) * 8 + (i & 7);
          uint4 v = make_uint4(0, 0, 0, 0);
          if (mcc[r] >= 0)
            v = make_uint4(add_relu_bf16x2(a[k].x, c[k].x), add_relu_bf16x2(a[k].y, c[k].y),
                           add_relu_bf16x2(a[k].z, c[k].z), add_relu_bf16x2(a[k].w, c[k].w));
          *reinterpret_cast<uint4*>(h0s + core_at(r, 8 * kb, C1)) = v;
        }
      }
      // D_q: row r holds bf16(g) at its channel of the quarter (zero past the rows)
      for (int i = tid; i < kRows * kCpQ / 8; i += kThreads) {
        const int ob = (i >> 3) % (kCpQ / 8), r = ((i >> 3) / (kCpQ / 8)) * 8 + (i & 7);
        const int o = mo[r] & (kCpQ - 1);
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (o / 8 == ob) w[(o & 7) / 2] = uint32_t(mg[r]) << (16 * (o & 1));
        *reinterpret_cast<uint4*>(dqs + core_at(r, 8 * ob, kCpQ)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
      fence_async();
      __syncthreads();

      // ---- GEMM1 X = H0 W2 and GEMM2 dh1 = D_q W3_q^T, issued together;
      // each warpgroup computes its H2 columns
      float acc1[H2 / 2], accd[H2 / 2];
      {
        const uint32_t h0b = opaque(h0_base), w2b = opaque(w2_base) + (c2 / 8) * C1 * 16;
        const uint32_t db = opaque(dq_base), w3b = opaque(w3_base) + (c2 / 8) * kCpQ * 16;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < C1 / 16; ++s)
          wgmma_ss<H2, 0, 0>(acc1, make_desc(h0b + 256 * s, 128, C1 * 16),
                             make_desc(w2b + 256 * s, 128, C1 * 16), s > 0);
        wgmma_commit();
#pragma unroll
        for (int s = 0; s < kCpQ / 16; ++s)
          wgmma_ss<H2, 0, 0>(accd, make_desc(db + 256 * s, 128, kCpQ * 16),
                             make_desc(w3b + 256 * s, 128, kCpQ * 16), s > 0);
        wgmma_commit();
      }
      // the tile's distinct positions, while they run (rows past the tile's
      // have position -1)
      if (tid < 32) rank_rows(mpos[tid], mpos[tid + 32], tid, mrank, mppos, mnpos);
      wgmma_wait<1>();
      fence_regs(acc1);

      // ---- LN forward in the accumulator: acc1 becomes xhat; h1 to shared
      float mean[2], rstd[2];
      ln_stats<C2, H2>(acc1, b2s, xs, wg, r0, t4, c2f, rc2, mean, rstd);
      uint32_t pos_bits[(H2 / 2 + 31) / 32];  // h1 > 0, one bit an accumulator
      ln_h1<H2>(acc1, mean, rstd, s2s, lb2s, h1s, C2, wg, r0, t4, pos_bits);
      wgmma_wait<0>();
      fence_regs(accd);

      // ---- LN + ReLU backward: accd becomes dln, then dxhat, then dx
      ln_relu_backward<C2, H2>(accd, acc1, pos_bits, rstd, s2s, dxs, xs, wg, r0, t4, lane, c2f,
                               rc2, run);
      fence_async();
      __syncthreads();

      // ---- the tile's dW3 H1^T D_q (warpgroup wg its rows 64 wg ..) and the
      // first half of its dW2 H0^T DX (rows 0-63, the warpgroup's columns),
      // then GEMM3 dh0 = bf16(dx) W2^T (W2 read MN-major), issued together;
      // dW2's second half (rows 64-127) once the first products are added.
      // Each tile product is added into its sums by the thread that holds it;
      // acc1 and accd hold them in turn.
      float acc3[H1 / 2];
      {
        wgmma_fence();
        wgmma_rows<kCpQ>(acc1, opaque(h1_base), C2, 64 * wg, opaque(dq_base), kCpQ, 0, 0);
        wgmma_rows<H2>(accd, opaque(h0_base), C1, 0, opaque(dx_base), C2, c2, 0);
        wgmma_commit();
        const uint32_t dxb = opaque(dx_base), w2b = opaque(w2_base) + (wg * H1 / 8) * 128;
#pragma unroll
        for (int s = 0; s < C2 / 16; ++s)
          wgmma_ss<H1, 0, 1>(acc3, make_desc(dxb + 256 * s, 128, C2 * 16),
                             make_desc(w2b + s * 32 * C1, C1 * 16, 128), s > 0);
        wgmma_commit();
      }
      wgmma_wait<1>();
      fence_regs(acc1);
      fence_regs(accd);
      auto add_tile = [&](const float(&v)[H2 / 2], float* base, int ld, int k0, int col0,
                          bool swz) {
#pragma unroll
        for (int j = 0; j < H2 / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = k0 + r0 + 8 * h, c = col0 + 8 * j + 2 * t4;
            float2* a = reinterpret_cast<float2*>(base + (swz ? dw2_at(k, c) : k * ld + c));
            const float2 o = *a;
            *a = make_float2(o.x + v[4 * j + 2 * h], o.y + v[4 * j + 2 * h + 1]);
          }
      };
      add_tile(acc1, accq, kCpAccLd, 64 * wg, 0, false);
      add_tile(accd, dw2s, C2, 0, c2, true);
      wgmma_fence();
      wgmma_rows<H2>(accd, opaque(h0_base), C1, 64, opaque(dx_base), C2, c2, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc3);
      fence_regs(accd);
      add_tile(accd, dw2s, C2, 64, c2, true);
      __syncthreads();  // every reader of h1, dx and D_q is done
      // dh0 through the first ReLU (h0 > 0 exactly where A + bc > 0; the sign
      // bit is masked off, since max(-0, 0) may keep -0): f32 in h1's and dx's
      // bytes for db_c, bf16 in H0's place for dA (each thread reads the
      // signs of its own elements before it writes them)
#pragma unroll
      for (int j = 0; j < H1 / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h, c = wg * H1 + 8 * j + 2 * t4;
          uint32_t* hp = reinterpret_cast<uint32_t*>(h0s + core_at(r, c, C1));
          const uint32_t hb = *hp;
          const float2 v = make_float2((hb & 0x7fffu) ? acc3[4 * j + 2 * h] : 0.f,
                                       (hb & 0x7fff0000u) ? acc3[4 * j + 2 * h + 1] : 0.f);
          *reinterpret_cast<float2*>(dh0s + dh0_at<C1>(r, c)) = v;
          *hp = pack_bf16x2(v.x, v.y);
        }
      }
      // P^T in D_q's place: (position index p, row r) is 1 where row r has
      // the tile's p-th position
      for (int i = tid; i < kRows * kRows / 8; i += kThreads) {
        const int rb = (i >> 3) % (kRows / 8), pi = ((i >> 3) / (kRows / 8)) * 8 + (i & 7);
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = (mrank[8 * rb + 2 * e] == pi ? 0x3f80u : 0u) |
                 (mrank[8 * rb + 2 * e + 1] == pi ? 0x3f800000u : 0u);
        *reinterpret_cast<uint4*>(dqs + core_at(pi, 8 * rb, kRows)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
      fence_async();
      __syncthreads();
      // ---- dA of the tile's positions: P^T bf16(dh0) (the rows' exact bf16
      // values summed in f32; warpgroup wg its columns 64 wg ..), while db_c
      // runs on the CUDA cores
      {
        const uint32_t pb = opaque(dq_base), hb = opaque(h0_base) + (wg * H1 / 8) * 128;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kRows / 16; ++s)
          wgmma_ss<H1, 0, 1>(acc1, make_desc(pb + 256 * s, 128, kRows * 16),
                             make_desc(hb + s * 32 * C1, C1 * 16, 128), s > 0);
        wgmma_commit();
      }
      // db_c: the thread of a column and a half of the rows adds them, in row
      // order, into their centers' sums (a center's rows of the quarter are
      // adjacent); the second half's first center after the first half's
      {
        const int c = tid % C1, half = tid / C1, r1 = min(rows, 32 * half + 32);
        float s = 0.f, held = 0.f;
        int held_cc = -1;
        for (int rb = 32 * half; rb < r1; rb += 4) {  // four rows' loads in flight
          float v[4];
          int cc[5];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            v[u] = rb + u < r1 ? dh0s[dh0_at<C1>(rb + u, c)] : 0.f;
            cc[u] = mcc[rb + u];  // -1 past the tile's rows
          }
          cc[4] = rb + 4 < kRows ? mcc[rb + 4] : -1;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (rb + u >= r1) break;
            s += v[u];
            if (rb + u + 1 == r1 || cc[u + 1] != cc[u]) {
              if (half == 1 && held_cc < 0) {
                held_cc = cc[u];
                held = s;
              } else {
                dbcs[cc[u] * C1 + c] += s;
              }
              s = 0.f;
            }
          }
        }
        __syncthreads();
        if (held_cc >= 0) dbcs[held_cc * C1 + c] += held;
      }
      wgmma_wait<0>();
      fence_regs(acc1);
      // each position's sums into its record row, the loads in flight together
      {
        const int n = *mnpos;
        float2 old[H1 / 4];
        float* dst[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          dst[h] = r0 + 8 * h < n ? drec + (size_t)(mppos[r0 + 8 * h] - pos0) * C1 + wg * H1 + 2 * t4
                                  : nullptr;
#pragma unroll
        for (int j = 0; j < H1 / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            old[2 * j + h] = dst[h] ? *reinterpret_cast<const float2*>(dst[h] + 8 * j)
                                    : make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < H1 / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (dst[h])
              *reinterpret_cast<float2*>(dst[h] + 8 * j) =
                  make_float2(old[2 * j + h].x + acc1[4 * j + 2 * h],
                              old[2 * j + h].y + acc1[4 * j + 2 * h + 1]);
      }
      // the next tile's rows (loaded at this one's start), and its A rows into L2
      if (tid >= kRows && tid < 2 * kRows && t + 1 < tiles) {
        put_row((t + 1) & 1, tid - kRows, next);
        if (next.pos >= 0) prefetch_l2(A + (size_t)next.pos * C1, C1 * 2);
      }
      __syncthreads();  // the tile's buffers are rewritten by the next tile
      // the quarter's last tile: its dW3 columns into the record (the loads
      // in flight together), the sums zeroed for the next quarter
      if (t + 1 == qtile[q + 1]) {
        constexpr int NF = C2 * kCpQ / kThreads, NB = 16;
#pragma unroll
        for (int u0 = 0; u0 < NF; u0 += NB) {
          float old[NB];
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            const int i = tid + (u0 + u) * kThreads;
            old[u] = rec[C1 * C2 + (i / kCpQ) * C3 + kCpQ * q + i % kCpQ];
          }
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            const int i = tid + (u0 + u) * kThreads;
            float* a = accq + (i / kCpQ) * kCpAccLd + i % kCpQ;
            rec[C1 * C2 + (i / kCpQ) * C3 + kCpQ * q + i % kCpQ] = old[u] + *a;
            *a = 0.f;
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < kCenters * C1; i += kThreads) dbc[cm0 * C1 + i] = dbcs[i];
  }  // the CTA's blocks

  // ---- the CTA's record: dW2, the column sums, db3 (dW3 is added above)
  const int tid = threadIdx.x;
  __syncthreads();  // the sums' last adds and the quarter sums' last reads
  for (int i = tid; i < C1 * C2; i += kThreads) rec[i] = dw2s[dw2_at(i / C2, i % C2)];
  write_column_sums<C2, H2>(run[0], red, rec + C1 * C2 + C2 * C3, tid);
  rec[C1 * C2 + C2 * C3 + 3 * C2 + tid] = db3;
}

// ---- the wide kernel: (c1, c2, c3) = (256, 256, 512), weights streamed

constexpr int kWideC1 = 256, kWideC2 = 256, kWideC3 = 512;
constexpr int kWideHashLog = 10, kWideHashOb = 9;  // 1024 slots a warp for up to 512 entries
constexpr int kWideSlots = 4;  // ring slots
constexpr int kWideSlotBytes = 8192;
constexpr int kWideChunk = 16;  // K of a ring step
// ring steps of a tile: GEMM1's W2 row chunks, GEMM2's W3 column chunks,
// GEMM3's W2 column chunks
constexpr int kWideG1 = kWideC1 / kWideChunk, kWideG2 = kWideC3 / kWideChunk;
constexpr int kWideSteps = kWideG1 + kWideG2 + kWideC2 / kWideChunk;
// the staged operands of a tile, images of its buffers in their core layout:
// H0, H1 and bf16(dx) (64 x 256 bf16), of up to kWideStage tiles a fold
constexpr int kWideStage = 16;
constexpr int kWideTileElems = kRows * kWideC2;
constexpr uint32_t kWideTileBytes = kWideTileElems * 2;
constexpr int kWideSlotElems = 3 * kWideTileElems;  // a tile's slot: H0, H1, bf16(dx)
static_assert(kWideC1 == kWideC2, "one image size");

struct WideLayout {
  size_t h0, h1, u, ring, row_of, row_ch, gb, runs, vec, xs, meta, rstart, bars, total;
  __host__ __device__ WideLayout() {
    size_t o = 0;
    h0 = o;     o += (size_t)kRows * kWideC1 * 2;
    h1 = o;     o += (size_t)kRows * kWideC2 * 2;  // h1, then bf16(dx)
    // D (bf16) then dh0 (f32); the hash tables before the tiles, the column
    // sums after them
    u = o;      o += (size_t)kRows * kWideC3 * 2;
    ring = o;   o += (size_t)kWideSlots * kWideSlotBytes;
    row_of = o; o += (size_t)kCenters * kWideC3 * 2;  // (center, channel) -> row
    row_ch = o; o += (size_t)kCenters * kWideC3 * 2;  // (center, row) -> its channel
    gb = o;     o += (size_t)kCenters * kWideC3 * 2;  // bf16(g) of the centers
    runs = o;   o += (size_t)kThreads * 3 * Fold<kWideC2 / 2>::NR * 4;  // column sums
    vec = o;    o += (size_t)3 * kWideC2 * 4;
    xs = o;     o += (size_t)4 * kRows * 2 * 4;
    meta = o;   o += (size_t)5 * kRows * 4;
    rstart = o; o += align128((size_t)(kCenters + 1) * 4);
    bars = o;   o += 128;  // the fold's two mbarriers
    total = o;
  }
};

// Ring step j of a tile (chunks of kWideChunk = 16 along K): j < 16 the W2
// rows 16 j .. + 16 (rows = K: GEMM1's MN-major B); then the W3 columns
// 16 (j - 16) .. + 16 of every row (rows = N: GEMM2's K-major B = W3^T); then
// the W2 columns 16 (j - 48) .. + 16 of every row (GEMM3's K-major B = W2^T).
__device__ __forceinline__ void wide_fetch(uint32_t dst, const uint16_t* __restrict__ w2,
                                           const uint16_t* __restrict__ w3, int j) {
  if (j < kWideG1)
    copy_core<kThreads, kWideChunk, kWideC2, kWideC2>(dst, w2 + j * kWideChunk * kWideC2);
  else if (j < kWideG1 + kWideG2)
    copy_core<kThreads, kWideC2, kWideChunk, kWideC3>(dst, w3 + (j - kWideG1) * kWideChunk);
  else
    copy_core<kThreads, kWideC1, kWideChunk, kWideC2>(
        dst, w2 + (j - kWideG1 - kWideG2) * kWideChunk);
}

// The wide layer's tiles: the rows and the sums of pool_bwd_tiles, with W2
// and W3 streamed from L2 through a ring of four 8 KiB slots, three steps
// ahead (64 steps a tile: 16 for GEMM1, 32 for GEMM2, 16 for GEMM3), so that
// the tile buffers fit: H0, h1 and D (whose bytes dh0 takes). At c2 256 a
// warpgroup's X and dh1 accumulators are 64 registers a thread each, too
// many to hold together beside the rest, so the order differs: after the LN
// forward (h1 to shared) xhat waits in shared memory (half in H0's bytes,
// half in h1's once H1's staging copy has read h1) while GEMM2 runs, and the
// LN backward reads it back where it is used; bf16(dx) then takes h1's
// place, and H0 is gathered again for GEMM3's ReLU mask and dA. The row list
// keeps each row's channel instead of its window position (the winner gives
// the position); bf16(g) stays in shared memory, bc is read from L2, db_c is
// added into the output in place (the CTA owns its block's rows).
// The weight gradients do not go to the record tile by tile: one CTA an SM
// (the grid is ctas = min(blocks, SMs); CTA i takes blocks i, i + ctas, ...
// in order, so every sum's order is fixed) copies each tile's H0, H1 and
// bf16(dx) into its staging slots in device memory (96 KiB a tile, kWideStage
// tiles) and, after the last slot's tile or at its block's end, folds them:
// dW2 = H0^T DX and dW3 = H1^T D (D rebuilt from the block's tables) with K =
// 64 rows a staged tile in the accumulator, six passes of 64 x 256 a
// warpgroup (odd passes take the tiles backwards, so that the last pass's
// latest loads are read again from L2), the staged images loaded one tile
// ahead into the tile buffers, the pass's record rows prefetched into L2,
// and one read-modify-write of the CTA's record a fold. Shared memory: H0,
// h1 / dx 32 KiB each, D / dh0 64 KiB, the ring 32 KiB, row_of, row_ch and
// bf16(g) 16 KiB each, the threads' column sums 12 KiB, vectors, row
// metadata and the fold's barriers 6.5 KiB: 231 936 bytes.
__global__ void __launch_bounds__(kThreads, 1)
pool_bwd_wide(const uint16_t* __restrict__ A, const uint16_t* __restrict__ bc,
              const float* __restrict__ g, const int* __restrict__ win,
              const int* __restrict__ starts, const uint16_t* __restrict__ w2,
              const float* __restrict__ b2, const float* __restrict__ s2,
              const float* __restrict__ lb2, const uint16_t* __restrict__ w3, int B, int N,
              int M, int W, float c2f, float rc2, float* __restrict__ dbc,
              float* __restrict__ records, float* __restrict__ da_records,
              uint16_t* __restrict__ stage) {
  constexpr int C1 = kWideC1, C2 = kWideC2, C3 = kWideC3;
  constexpr int P = record_floats(C1, C2, C3);
  constexpr int H1 = C1 / 2, H2 = C2 / 2;
  constexpr int NO = C3 / 32;  // a lane's channels when listing
  using F = Fold<H2>;
  static_assert(C1 == kThreads, "db_c: one column a thread");
  constexpr int KS = kWideChunk / 16;  // k16 steps a ring step

  extern __shared__ __align__(128) unsigned char smem[];
  const WideLayout L;
  uint16_t* h0s = reinterpret_cast<uint16_t*>(smem + L.h0);
  uint16_t* h1s = reinterpret_cast<uint16_t*>(smem + L.h1);
  uint16_t* dxs = h1s;  // bf16(dx) takes h1's place
  float* stash = reinterpret_cast<float*>(smem + L.h0);  // xhat's first half, in H0's bytes
  uint16_t* ds = reinterpret_cast<uint16_t*>(smem + L.u);
  float* dh0s = reinterpret_cast<float*>(smem + L.u);
  uint32_t* hash = reinterpret_cast<uint32_t*>(smem + L.u);
  float* red = reinterpret_cast<float*>(smem + L.u);
  int16_t* row_of = reinterpret_cast<int16_t*>(smem + L.row_of);
  int16_t* row_ch = reinterpret_cast<int16_t*>(smem + L.row_ch);
  uint16_t* gbs = reinterpret_cast<uint16_t*>(smem + L.gb);
  float* b2s = reinterpret_cast<float*>(smem + L.vec);
  float* s2s = b2s + C2;
  float* lb2s = s2s + C2;
  float* xs = reinterpret_cast<float*>(smem + L.xs);  // [2 uses][2 warpgroups][64 rows][2]
  int* mpos = reinterpret_cast<int*>(smem + L.meta);  // tile row -> A row, or -1
  int* mcc = mpos + kRows;                            // tile row -> center, or -1
  int* mloc = mcc + kRows;                            // tile row -> row of its center
  int* mnext = mloc + kRows;  // tile row -> the tile's next row of its position, or -1
  int* mlead = mnext + kRows; // tile row -> 1 where it is its position's first row
  int* rstart = reinterpret_cast<int*>(smem + L.rstart);
  const uint32_t ring = smem_u32(smem + L.ring);

  const int tid = threadIdx.x;
  const int n_blk = M / kCenters;
  float* rec = records + (size_t)blockIdx.x * P;
  // the CTA's staging slots: [tile][H0, H1, bf16(dx)]
  const auto staged = [&](int j, int op) {
    return stage + ((size_t)blockIdx.x * kWideStage + j) * kWideSlotElems +
           (size_t)op * kWideTileElems;
  };
  const uint32_t fold_bar = smem_u32(smem + L.bars);  // the fold's two buffers landed
  // the block's b M + m0, window start, b N + start and index, read back at
  // each tile rather than held in registers across the tiles
  int* blk_vals = reinterpret_cast<int*>(smem + L.bars + 16);

  // ---- vectors, once
  for (int i = tid; i < C2; i += kThreads) {
    b2s[i] = b2[i];
    s2s[i] = s2[i];
    lb2s[i] = lb2[i];
  }
  if (tid == 0) {
    mbar_init(fold_bar);
    mbar_init(fold_bar + 8);
  }
  // the thread's db2, ds2, dlb2 column sums (run(q) + i), in shared memory:
  // registers are what this kernel lacks
  auto run = [&](int q) {
    return reinterpret_cast<float*>(smem + L.runs) + ((int)opaque(tid) * 3 + q) * F::NR;
  };
#pragma unroll
  for (int i = 0; i < 3 * F::NR; ++i) run(0)[i] = 0.f;
  bool folded = false;     // the record holds a fold (alike in every thread)
  uint32_t fold_phase = 0;  // bit b: the phase parity of the fold's barrier b

  // ---- the CTA's blocks of 16 centers, blockIdx.x + gridDim.x k, in order
  for (int blk = blockIdx.x; blk < B * n_blk; blk += gridDim.x) {
    const int b = blk / n_blk;
    const int m0 = (blk % n_blk) * kCenters;
    const size_t cm0 = (size_t)b * M + m0;
    int start = starts[blk];
    start = min(max(start, 0), N - W);
    __syncthreads();  // the last block's tables and buffers are read
    if (tid == 0) {
      blk_vals[0] = (int)cm0;
      blk_vals[1] = start;
      blk_vals[2] = b * N + start;
      blk_vals[3] = blk;
    }
    for (int cc = 0; cc < kCenters; ++cc) dbc[(cm0 + cc) * C1 + tid] = 0.f;

    // ---- each warp lists its centers' live rows, in channel order (the lane
    // opaque: its channel offsets are computed for each block, not hoisted
    // out of the block loop and held in registers through the tiles)
    {
      const int lane = (int)opaque(tid) % 32, warp = (int)opaque(tid) / 32;
      uint32_t* T = hash + warp * (1 << kWideHashLog);
      const uint32_t lt = (1u << lane) - 1u;
      for (int cc = warp; cc < kCenters; cc += kWarps) {
        const float* gc = g + (cm0 + cc) * C3;
        const int* wc = win + (cm0 + cc) * C3;
        int16_t* rof = row_of + cc * C3;
        int16_t* rch = row_ch + cc * C3;
        for (int o = lane; o < C3; o += 32)
          gbs[cc * C3 + o] = __bfloat16_as_ushort(__float2bfloat16_rn(gc[o]));
        int n = 0;
        for (int i = lane; i < (1 << kWideHashLog); i += 32) T[i] = kEmpty;
        __syncwarp();
        int rel[NO];
        bool live[NO];
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          const int o = 32 * i + lane;
          rel[i] = wc[o] - start;
          live[i] = gc[o] != 0.f && rel[i] >= 0 && rel[i] < W;
          if (live[i]) hash_insert<kWideHashLog, kWideHashOb>(T, rel[i], o);
        }
        __syncwarp();
        int lead[NO];
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          const int o = 32 * i + lane;
          lead[i] = live[i] ? hash_leader<kWideHashLog, kWideHashOb>(T, rel[i]) : -1;
          const uint32_t mask = __ballot_sync(0xffffffffu, lead[i] == o);
          const int idx = n + __popc(mask & lt);
          if (lead[i] == o) {
            rof[o] = idx;
            rch[idx] = o;
          }
          n += __popc(mask);
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          const int o = 32 * i + lane;
          if (lead[i] < 0) rof[o] = -1;
          else if (lead[i] != o) rof[o] = rof[lead[i]];
        }
        __syncwarp();  // the table is cleared for the warp's next center
        if (lane == 0) rstart[cc + 1] = n;
      }
    }
    __syncthreads();
    if (tid == 0) {
      rstart[0] = 0;
      for (int cc = 0; cc < kCenters; ++cc) rstart[cc + 1] += rstart[cc];
    }
    // db3: the live channels' cotangents, summed over the block's centers in
    // order, then over the CTA's blocks (in its record: the first block writes)
    for (int o = tid; o < C3; o += kThreads) {
      float s = 0.f;
      for (int cc = 0; cc < kCenters; ++cc)
        if (row_of[cc * C3 + o] >= 0) s += g[(cm0 + cc) * C3 + o];
      float* db3 = rec + C1 * C2 + C2 * C3 + 3 * C2 + o;
      *db3 = blk == (int)blockIdx.x ? s : *db3 + s;
    }
    __syncthreads();

    const int nr = rstart[kCenters];
    const int tiles = (nr + kRows - 1) / kRows;
    const uint32_t h0_base = smem_u32(h0s), h1_base = smem_u32(h1s), d_base = smem_u32(ds);
    const uint32_t dx_base = h1_base;

    // Ring step `step`: its copy has landed for every thread (each waits for
    // its own, then the barrier; the copies of the next kWideSlots - 2 steps
    // may still fly), and every warp has waited for the products of step - 1,
    // so step + kWideSlots - 1 may take their slot. One copy group a step (an
    // empty one past the block's last), so the count of groups in flight is
    // fixed. Returns the step's slot.
    int step = 0;
    const auto fetch = [&](int f) {
      if (f < tiles * kWideSteps)
        wide_fetch(ring + (f % kWideSlots) * kWideSlotBytes, w2, w3, f % kWideSteps);
      else
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    for (int f = 0; f < kWideSlots - 1; ++f) fetch(f);
    auto ring_step = [&]() -> uint32_t {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kWideSlots - 2) : "memory");
      fence_async();
      __syncthreads();
      fetch(step + kWideSlots - 1);
      const uint32_t slot = ring + (step % kWideSlots) * kWideSlotBytes;
      ++step;
      return slot;
    };

    for (int t = 0; t < tiles; ++t) {
      const int j = t % kWideStage;  // the tile's staging slot
      const volatile int* bv = blk_vals;
      const size_t cm0 = (size_t)bv[0];
      const int start = bv[1], pos0 = bv[2];
      float* drec = da_records + (size_t)bv[3] * W * C1;
      // The thread's index and what derives from it, opaque at each tile, so
      // that the many addresses built from them are computed where they are
      // used, not hoisted out of the loop and held in registers across it.
      const int tid = (int)opaque(threadIdx.x);
      const int lane = tid % 32, t4 = lane % 4, wg = tid / 128;
      const int r0 = 16 * ((tid / 32) % 4) + lane / 4;  // the thread's tile rows r0, r0 + 8
      const int c2 = wg * H2;  // the warpgroup's first column of C2 (C1: wg * H1)
      const int rows = min(kRows, nr - t * kRows);
      // ---- the tile's rows: center, row of the center, A row (from the
      // winner of the row's channel; -1 outside the window)
      if (tid < kRows) {
        const int r = t * kRows + tid;
        int cc = -1, loc = 0, pos = -1;
        if (tid < rows) {
          cc = 0;
          while (rstart[cc + 1] <= r) ++cc;
          loc = r - rstart[cc];
          const int rel = win[(cm0 + cc) * C3 + row_ch[cc * C3 + loc]] - start;
          if (rel >= 0 && rel < W) pos = pos0 + rel;
        }
        mcc[tid] = cc;
        mloc[tid] = loc;
        mpos[tid] = pos;
      }
      __syncthreads();
      // ---- the tile's rows of one position: the first leads, each links the next
      if (tid < rows) {
        const int pos = mpos[tid];
        int nx = -1, lead = pos >= 0;
        for (int r = 0; r < rows; ++r) {
          if (mpos[r] != pos) continue;
          if (r < tid) lead = 0;
          else if (r > tid && nx < 0) nx = r;
        }
        mnext[tid] = nx;
        mlead[tid] = lead;
      }
      // ---- H0 = bf16(relu(A + bc)), 16 bytes a thread at a time (the 8
      // threads of a quarter warp on the 8 rows of one core: no conflicts)
      auto build_h0 = [&]() {
        constexpr int NA = kRows * C1 / 8 / kThreads;
        const int tid_o = (int)opaque(tid);  // offsets computed here, not hoisted
        uint4 a[NA];
#pragma unroll
        for (int k = 0; k < NA; ++k) {
          const int i = tid_o + k * kThreads;
          const int kb = (i >> 3) % (C1 / 8), r = ((i >> 3) / (C1 / 8)) * 8 + (i & 7);
          const int pos = mpos[r];
          a[k] = pos >= 0 ? __ldg(reinterpret_cast<const uint4*>(A + (size_t)pos * C1) + kb)
                          : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int k = 0; k < NA; ++k) {
          const int i = tid_o + k * kThreads;
          const int kb = (i >> 3) % (C1 / 8), r = ((i >> 3) / (C1 / 8)) * 8 + (i & 7);
          const int cc = mcc[r];
          uint4 v = make_uint4(0, 0, 0, 0);
          if (cc >= 0) {
            const uint4 c = __ldg(reinterpret_cast<const uint4*>(bc + (cm0 + cc) * C1) + kb);
            v = make_uint4(add_relu_bf16x2(a[k].x, c.x), add_relu_bf16x2(a[k].y, c.y),
                           add_relu_bf16x2(a[k].z, c.z), add_relu_bf16x2(a[k].w, c.w));
          }
          *reinterpret_cast<uint4*>(h0s + core_at(r, 8 * kb, C1)) = v;
        }
      };
      // D, the rows' bf16 cotangents, and H0
      {
        for (int i = (int)opaque(tid); i < kRows * C3 / 8; i += kThreads) {
          const int ob = (i >> 3) % (C3 / 8), r = ((i >> 3) / (C3 / 8)) * 8 + (i & 7);
          const int cc = mcc[r];
          uint4 v = make_uint4(0, 0, 0, 0);
          if (cc >= 0) {
            const int16_t loc = int16_t(mloc[r]);
            const uint4 ro = reinterpret_cast<const uint4*>(row_of + cc * C3)[ob];
            const uint4 gb = reinterpret_cast<const uint4*>(gbs + cc * C3)[ob];
            const uint32_t rw[4] = {ro.x, ro.y, ro.z, ro.w}, gw[4] = {gb.x, gb.y, gb.z, gb.w};
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[e] = (int16_t(rw[e] & 0xffffu) == loc ? gw[e] & 0xffffu : 0u) |
                     (int16_t(rw[e] >> 16) == loc ? gw[e] & 0xffff0000u : 0u);
            v = make_uint4(w[0], w[1], w[2], w[3]);
          }
          *reinterpret_cast<uint4*>(ds + core_at(r, 8 * ob, C3)) = v;
        }
      }
      build_h0();
      fence_async();
      __syncthreads();
      if (tid == 0) bulk_store(staged(j, 0), h0_base, kWideTileBytes);  // H0 to the slot

      // ---- GEMM1 X = H0 W2 (W2's rows by ring step, read MN-major), each
      // warpgroup its H2 columns
      // One accumulator array for every product of the tile, X, dh1, dh0 and
      // the dW chunks in turn: each wgmma accumulator is a block of consecutive
      // registers, and one block for all of them leaves the rest unfragmented.
      static_assert(H1 == H2, "one accumulator block");
      float acc[H2 / 2];
      float(&acc1)[H2 / 2] = acc;
#pragma unroll 1
      for (int j = 0; j < kWideG1; ++j) {
        const uint32_t slot = ring_step();
        const uint32_t h0b = opaque(h0_base);
        wgmma_fence();
#pragma unroll
        for (int e = 0; e < KS; ++e)
          wgmma_ss<H2, 0, 1>(acc1, make_desc(h0b + 256 * (KS * j + e), 128, C1 * 16),
                             make_desc(slot + e * 32 * C2 + (c2 / 8) * 128, C2 * 16, 128),
                             j > 0 || e > 0);
        wgmma_commit();
        wgmma_wait<0>();
      }
      fence_regs(acc1);

      // ---- LN forward in the accumulator: acc1 becomes xhat. A row's
      // statistics: the quad's sums, then both warpgroups' halves in order
      // through shared memory.
      float mean[2], rstd[2];
      {
        float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
        const int cb = (int)opaque(c2 + 2 * t4);
#pragma unroll
        for (int j = 0; j < H2 / 8; ++j) {
          const float2 bias = *reinterpret_cast<const float2*>(b2s + cb + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float z = acc1[4 * j + e] + (e & 1 ? bias.y : bias.x);
            acc1[4 * j + e] = z;
            sum[e / 2] += z;
            sq[e / 2] += z * z;
          }
          compiler_fence();
        }
        row_sums_put(sum, sq, xs, 0, wg, r0, t4);
        if (tid == 0) bulk_store_read_wait<0>();  // H0's staging copy has read it
        __syncthreads();  // also: both warpgroups' GEMM1 products have read H0
        row_sums_get(sum, sq, xs, 0, r0);
        row_stats<C2>(sum, sq, c2f, rc2, mean, rstd);
      }
      // xhat, and h1 > 0 (exactly where xhat s2 + lb2 > 0) as bits. The
      // thread's xhat waits in shared memory ([value][thread]) while GEMM2
      // runs, its first half in H0's bytes (both warpgroups' GEMM1 products
      // and H0's staging copy have read H0: the LN statistics' barrier), its
      // second in h1's; h1 = bf16(relu(xhat s2 + lb2)) itself is rebuilt from
      // it after GEMM2, for its staging copy. A compiler fence a column block
      // keeps the scale and bias loads of later blocks from being issued early
      // into registers the kernel lacks.
      constexpr int NX = H2 / 4;  // values a thread stashes in each place
      uint32_t pos_bits[(H2 / 2 + 31) / 32] = {};  // one bit an accumulator
      const int cp = (int)opaque(c2 + 2 * t4), tp = (int)opaque(tid);
      float* stash2 = reinterpret_cast<float*>(h1s) - NX * kThreads;  // values NX.. in h1's bytes
      const auto xhat_at = [&](int i) -> float& {
        return i < NX ? stash[i * kThreads + tp] : stash2[i * kThreads + tp];
      };
      const auto xhat = [&](int i) { return xhat_at(i); };
      // h1's pre-activation and its value, as the forward computes them
      const auto h1_pre = [&](float xh, float sc, float sh) { return xh * sc + sh; };
#pragma unroll
      for (int j = 0; j < H2 / 8; ++j) {
        const int c = cp + 8 * j;
        const float2 sc = *reinterpret_cast<const float2*>(s2s + c);
        const float2 sh = *reinterpret_cast<const float2*>(lb2s + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float xh = (acc1[i] - mean[e / 2]) * rstd[e / 2];
          if (h1_pre(xh, e & 1 ? sc.y : sc.x, e & 1 ? sh.y : sh.x) > 0.f)
            pos_bits[i / 32] |= 1u << (i % 32);
          xhat_at(i) = xh;
        }
        compiler_fence();
      }

      // ---- GEMM2 dh1 = D W3^T (W3's columns by ring step, K-major), each
      // warpgroup its H2 columns
      float(&accd)[H2 / 2] = acc;
#pragma unroll 1
      for (int j = 0; j < kWideG2; ++j) {
        const uint32_t slot = ring_step();
        const uint32_t db = opaque(d_base);
        wgmma_fence();
#pragma unroll
        for (int e = 0; e < KS; ++e)
          wgmma_ss<H2, 0, 0>(accd, make_desc(db + 256 * (KS * j + e), 128, C3 * 16),
                             make_desc(slot + (c2 / 8) * kWideChunk * 16 + 256 * e, 128,
                                       kWideChunk * 16),
                             j > 0 || e > 0);
        wgmma_commit();
        wgmma_wait<0>();
      }
      fence_regs(accd);

      // ---- LN + ReLU backward: accd becomes dln, then dxhat, then dx; bf16(dx)
      // takes h1's place
      {
#pragma unroll
        for (int i = 0; i < H2 / 2; ++i)
          if (!((pos_bits[i / 32] >> (i % 32)) & 1u)) accd[i] = 0.f;
        // ds2 (dln * xhat) column sums, as fold_columns; dlb2 (dln)
#pragma unroll
        for (int h = 0; h < F::NH; ++h) {
          float v[F::NVH];
#pragma unroll
          for (int jj = 0; jj < F::NVH; ++jj) {
            const int i = 4 * ((h * F::NVH + jj) / 2) + (jj & 1);
            v[jj] = accd[i] * xhat(i) + accd[i + 2] * xhat(i + 2);
            if (jj % 4 == 3) compiler_fence();
          }
          column_sums<F::NVH>(v, lane, run(1) + h * F::NRH);
        }
        fold_columns<H2, false>(accd, accd, lane, run(2));
        float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < H2 / 8; ++j) {
          const float2 sc = *reinterpret_cast<const float2*>(s2s + cp + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dxh = accd[4 * j + e] * (e & 1 ? sc.y : sc.x);
            accd[4 * j + e] = dxh;
            m1[e / 2] += dxh;
            m2[e / 2] += dxh * xhat(4 * j + e);
          }
          compiler_fence();
        }
        row_sums_put(m1, m2, xs, 1, wg, r0, t4);
        __syncthreads();  // also: both warpgroups' GEMM2 products have read D
        // h1 = bf16(relu(xhat s2 + lb2)) again, into D's bytes, for its staging copy
        {
          uint16_t* h1d = ds;
          const int rp = (int)opaque(r0);
#pragma unroll 1
          for (int j = 0; j < H2 / 8; ++j) {
            const int c = cp + 8 * j;
            const float2 sc = *reinterpret_cast<const float2*>(s2s + c);
            const float2 sh = *reinterpret_cast<const float2*>(lb2s + c);
            float y[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              y[e] = fmaxf(h1_pre(xhat(4 * j + e), e & 1 ? sc.y : sc.x, e & 1 ? sh.y : sh.x), 0.f);
            *reinterpret_cast<uint32_t*>(h1d + core_at(rp, c, C2)) = pack_bf16x2(y[0], y[1]);
            *reinterpret_cast<uint32_t*>(h1d + core_at(rp + 8, c, C2)) = pack_bf16x2(y[2], y[3]);
          }
        }
        row_sums_get(m1, m2, xs, 1, r0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m1[h] = div_width<C2>(m1[h], c2f, rc2);
          m2[h] = div_width<C2>(m2[h], c2f, rc2);
        }
#pragma unroll
        for (int i = 0; i < H2 / 2; ++i) {
          const int h = (i >> 1) & 1;
          accd[i] = rstd[h] * (accd[i] - m1[h] - xhat(i) * m2[h]);
          if (i % 8 == 7) compiler_fence();
        }
        fold_columns<H2, false>(accd, accd, lane, run(0));  // db2
      }
      // every thread has read its stash: bf16(dx) takes h1's place, and H0 is
      // gathered again, for GEMM3's ReLU mask and dA; h1 goes to its slot
      fence_async();
      __syncthreads();
      if (tid == 0) bulk_store(staged(j, 1), d_base, kWideTileBytes);
      {
        const int rp = (int)opaque(r0), cp = (int)opaque(c2 + 2 * t4);
#pragma unroll
        for (int j = 0; j < H2 / 8; ++j) {
          const int c = cp + 8 * j;
          *reinterpret_cast<uint32_t*>(dxs + core_at(rp, c, C2)) =
              pack_bf16x2(accd[4 * j], accd[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(dxs + core_at(rp + 8, c, C2)) =
              pack_bf16x2(accd[4 * j + 2], accd[4 * j + 3]);
        }
      }
      build_h0();
      fence_async();
      __syncthreads();
      if (tid == 0) bulk_store(staged(j, 2), dx_base, kWideTileBytes);  // bf16(dx) too

      // ---- GEMM3 dh0 = bf16(dx) W2^T (W2's columns by ring step, K-major),
      // each warpgroup its H1 columns
      float(&acc3)[H1 / 2] = acc;
#pragma unroll 1
      for (int j = 0; j < C2 / kWideChunk; ++j) {
        const uint32_t slot = ring_step();
        const uint32_t dxb = opaque(dx_base);
        wgmma_fence();
#pragma unroll
        for (int e = 0; e < KS; ++e)
          wgmma_ss<H1, 0, 0>(acc3, make_desc(dxb + 256 * (KS * j + e), 128, C2 * 16),
                             make_desc(slot + (wg * H1 / 8) * kWideChunk * 16 + 256 * e, 128,
                                       kWideChunk * 16),
                             j > 0 || e > 0);
        wgmma_commit();
        wgmma_wait<0>();
      }
      fence_regs(acc3);
      if (tid == 0) bulk_store_read_wait<0>();  // H1's staging copy has read D's bytes
      __syncthreads();  // every product that reads D is done: dh0 takes its place
      // dh0 through the first ReLU (h0 > 0 exactly where A + bc > 0; the sign
      // bit is masked off, since max(-0, 0) may keep -0)
      {
        // addresses from here on, not held from the tile's start
        const int rp = (int)opaque(r0), cp = (int)opaque(wg * H1 + 2 * t4);
#pragma unroll
        for (int j = 0; j < H1 / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rp + 8 * h, c = cp + 8 * j;
            const uint32_t hb = *reinterpret_cast<const uint32_t*>(h0s + core_at(r, c, C1));
            const float2 v = make_float2((hb & 0x7fffu) ? acc3[4 * j + 2 * h] : 0.f,
                                         (hb & 0x7fff0000u) ? acc3[4 * j + 2 * h + 1] : 0.f);
            *reinterpret_cast<float2*>(dh0s + dh0_at<C1>(r, c)) = v;
          }
        }
      }
      __syncthreads();
      // db_c: each center's rows, in row order, center by center, added into
      // the output by the thread of the column
      for (int cc = mcc[0], r = 0; r < rows; ++cc) {
        const int end = min(rstart[cc + 1] - t * kRows, rows);
        float s = 0.f;
#pragma unroll 4
        for (; r < end; ++r) s += dh0s[dh0_at<C1>(r, tid)];
        dbc[(cm0 + cc) * C1 + tid] += s;
      }
      // dA: each leader adds its position's rows, in row order, into the record
      for (int i = tid; i < rows * (C1 / 4); i += kThreads) {
        const int r = i / (C1 / 4), q = i % (C1 / 4);
        if (!mlead[r]) continue;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int n = r; n >= 0; n = mnext[n]) {
          const float4 u = *reinterpret_cast<const float4*>(dh0s + dh0_at<C1>(n, 4 * q));
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        float4* dst = reinterpret_cast<float4*>(drec + (size_t)(mpos[r] - pos0) * C1 + 4 * q);
        float4 o = *dst;
        o.x += v.x;
        o.y += v.y;
        o.z += v.z;
        o.w += v.w;
        *dst = o;
      }
      if (tid == 0) bulk_store_read_wait<0>();  // bf16(dx)'s staging copy has read it
      __syncthreads();  // the tile's buffers are rewritten by the next tile or the fold

      // ---- the fold, after the last staging slot's tile or the block's last
      // tile: dW2 = H0^T DX and dW3 = H1^T D over the staged tiles' rows (K =
      // 64 a tile) in the accumulator, added to the CTA's record once
      if (j == kWideStage - 1 || t == tiles - 1) {
        const int n = j + 1, t0 = t - j;
        if (tid == 0) {
          bulk_store_wait();
          asm volatile("fence.proxy.async;\n" ::: "memory");  // the slots, for the bulk loads
        }
        fence_async();  // the tile buffers' last generic accesses, before the bulk loads
        __syncthreads();
        // two buffers of 64 KiB: H0's and h1's bytes, D's; X (H0 or H1) then Y (DX or D)
        const auto fbuf = [&](int i) { return (i & 1) ? ds : h0s; };
        // pass 0-1 dW2, rows 64 (2 pass + wg) of c1, all c2 columns; pass 2-5
        // dW3, rows 64 (2 a + wg) of c2 (a = pass % 2), c3 columns 256 h .. + 256
        // (h = (pass - 2) / 2); two accumulators of 128 columns
#pragma unroll 1
        for (int pass = 0; pass < 6; ++pass) {
          const bool w3p = pass >= 2;
          const int mi = 2 * (pass % 2) + wg;
          const int n0 = w3p ? 256 * ((pass - 2) / 2) : 0;
          // the pass's i-th staged tile: odd passes take them backwards, so that
          // the last pass's latest loads are the first to be read again (in L2)
          const auto si = [&](int i) { return (pass & 1) ? n - 1 - i : i; };
          const auto load = [&](int i) {  // that tile's X (and DX) into buffer i & 1
            if (tid != 0) return;
            const uint32_t bar = fold_bar + 8 * (i & 1), dst = smem_u32(fbuf(i));
            if (w3p) {
              bulk_copy(dst, staged(si(i), 1), kWideTileBytes, bar);
            } else {
              bulk_expect(bar, 2 * kWideTileBytes);
              bulk_load(dst, staged(si(i), 0), kWideTileBytes, bar);
              bulk_load(dst + kWideTileBytes, staged(si(i), 2), kWideTileBytes, bar);
            }
          };
          if (folded && tid < 128) {  // the pass's record rows into L2 while its tiles run
            const int ldr = w3p ? C3 : C2;
            const float* rp =
                (w3p ? rec + C1 * C2 : rec) + (size_t)(128 * (pass % 2) + tid) * ldr + n0;
            asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(rp), "r"(256 * 4)
                         : "memory");
          }
          float facc[2][64];
          load(0);
#pragma unroll 1
          for (int i = 0; i < n; ++i) {
            if (i + 1 < n) load(i + 1);
            uint16_t* yp = fbuf(i) + kWideTileElems;
            if (w3p) {
              // D's columns n0 .. + 256 of the tile, from the tables
              for (int e = (int)opaque(tid); e < kRows * 256 / 8; e += kThreads) {
                const int ob = (e >> 3) % 32, r = ((e >> 3) / 32) * 8 + (e & 7);
                const int R = (t0 + si(i)) * kRows + r;
                uint4 v = make_uint4(0, 0, 0, 0);
                if (R < nr) {
                  int cc = 0;
                  while (rstart[cc + 1] <= R) ++cc;
                  const int16_t loc = int16_t(R - rstart[cc]);
                  const uint4 ro = *reinterpret_cast<const uint4*>(row_of + cc * C3 + n0 + 8 * ob);
                  const uint4 gq = *reinterpret_cast<const uint4*>(gbs + cc * C3 + n0 + 8 * ob);
                  const uint32_t rw[4] = {ro.x, ro.y, ro.z, ro.w}, gw[4] = {gq.x, gq.y, gq.z, gq.w};
                  uint32_t w[4];
#pragma unroll
                  for (int q = 0; q < 4; ++q)
                    w[q] = (int16_t(rw[q] & 0xffffu) == loc ? gw[q] & 0xffffu : 0u) |
                           (int16_t(rw[q] >> 16) == loc ? gw[q] & 0xffff0000u : 0u);
                  v = make_uint4(w[0], w[1], w[2], w[3]);
                }
                *reinterpret_cast<uint4*>(yp + core_at(r, 8 * ob, 256)) = v;
              }
              fence_async();
            }
            bulk_wait(fold_bar + 8 * (i & 1), (fold_phase >> (i & 1)) & 1u);
            fold_phase ^= 1u << (i & 1);
            __syncthreads();
            // X^T (its columns 64 mi ..) times Y over the tile's 64 rows, the
            // descriptors built where they are used
            const uint32_t xb = smem_u32(fbuf(i)) + (64 * mi / 8) * 128;
            const uint32_t yb = smem_u32(fbuf(i)) + kWideTileBytes;
            wgmma_fence();
#pragma unroll
            for (int s = 0; s < 4; ++s)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                wgmma_ss<128, 1, 1>(facc[h], make_desc(opaque(xb + s * 32 * 256), 256 * 16, 128),
                                    make_desc(opaque(yb + h * 16 * 128 + s * 32 * 256), 256 * 16,
                                              128),
                                    i > 0 || s > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(facc[0]);
            fence_regs(facc[1]);
            __syncthreads();  // buffer i & 1 is free for tile i + 2
          }
          // into the record, by the element's owner: the first fold writes
          float* out = w3p ? rec + C1 * C2 + n0 : rec;
          const int ld = w3p ? C3 : C2;
          float* base = out + (size_t)(64 * mi + r0) * ld + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int q = 0; q < 16; q += 8) {
              float2 old[16];
#pragma unroll
              for (int k = 0; k < 16; ++k) {
                const int jj = q + k / 2, hh = k % 2;
                old[k] = folded ? *reinterpret_cast<const float2*>(base + hh * 8 * ld + 128 * h +
                                                                    8 * jj)
                                : make_float2(0.f, 0.f);
              }
#pragma unroll
              for (int k = 0; k < 16; ++k) {
                const int jj = q + k / 2, hh = k % 2;
                *reinterpret_cast<float2*>(base + hh * 8 * ld + 128 * h + 8 * jj) =
                    make_float2(old[k].x + facc[h][4 * jj + 2 * hh],
                                old[k].y + facc[h][4 * jj + 2 * hh + 1]);
              }
            }
          }
        }
        folded = true;
      }
    }

  }  // the CTA's blocks

  // ---- the CTA's record: weight gradients (a CTA without rows), column sums, db3
  if (!folded)
    for (int i = tid; i < C1 * C2 + C2 * C3; i += kThreads) rec[i] = 0.f;
  __syncthreads();  // the tile buffers' last reads, before the partials take them
  write_column_sums<C2, H2>(run(0), red, rec + C1 * C2 + C2 * C3, tid);
}

template <int C1, int C2, int C3, bool COMPACT>
cudaError_t launch(const uint16_t* A, const uint16_t* bc, const float* g, const int* win,
                   const int* starts, const uint16_t* w2, const float* b2, const float* s2,
                   const float* lb2, const uint16_t* w3, int B, int N, int M, int W,
                   int c2_real, float* dA, float* dbc, float* wout, float* records,
                   float* da_records, cudaStream_t s) {
  constexpr int P = record_floats(C1, C2, C3);
  const Layout<C1, C2, C3> L;
  if (L.total > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  const int n_blk = M / kCenters, n_rec = B * n_blk;
  const size_t hit_bytes = (size_t)2 * n_blk * sizeof(int);
  if (hit_bytes > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err;
  if (n_rec > 0) {
    err = cudaMemsetAsync(da_records, 0, (size_t)n_rec * W * C1 * sizeof(float), s);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(pool_bwd_tiles<C1, C2, C3, COMPACT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return err;
    dim3 grid(n_blk, B);
    pool_bwd_tiles<C1, C2, C3, COMPACT><<<grid, kThreads, L.total, s>>>(
        A, bc, g, win, starts, w2, b2, s2, lb2, w3, N, M, W, (float)c2_real,
        1.f / (float)c2_real, dbc, records, da_records);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (B > 0 && N > 0) {
    err = cudaFuncSetAttribute(reduce_dA<C1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)hit_bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((N + kReducePoints - 1) / kReducePoints, B);
    reduce_dA<C1><<<grid, 256, hit_bytes, s>>>(da_records, starts, n_blk, N, W, dA);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  reduce_records<8><<<(P + 31) / 32, 256, 0, s>>>(records, n_rec, P, wout);
  return cudaGetLastError();
}

cudaError_t launch_wide(const uint16_t* A, const uint16_t* bc, const float* g, const int* win,
                        const int* starts, const uint16_t* w2, const float* b2, const float* s2,
                        const float* lb2, const uint16_t* w3, int B, int N, int M, int W,
                        int c2_real, float* dA, float* dbc, float* wout, float* records,
                        float* da_records, uint16_t* stage, int ctas, cudaStream_t s) {
  constexpr int C1 = kWideC1, P = record_floats(kWideC1, kWideC2, kWideC3);
  const WideLayout L;
  if (L.total > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  const int n_blk = M / kCenters, n_rec = B * n_blk;
  const size_t hit_bytes = (size_t)2 * n_blk * sizeof(int);
  if (hit_bytes > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  // one record a CTA, each CTA over blocks blockIdx.x + ctas k (fixed: the
  // sums' order does not depend on the scheduling)
  if (n_rec > 0 && (ctas <= 0 || ctas > n_rec || stage == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (n_rec > 0) {
    err = cudaMemsetAsync(da_records, 0, (size_t)n_rec * W * C1 * sizeof(float), s);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(pool_bwd_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L.total);
    if (err != cudaSuccess) return err;
    pool_bwd_wide<<<ctas, kThreads, L.total, s>>>(
        A, bc, g, win, starts, w2, b2, s2, lb2, w3, B, N, M, W, (float)c2_real,
        1.f / (float)c2_real, dbc, records, da_records, stage);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (B > 0 && N > 0) {
    err = cudaFuncSetAttribute(reduce_dA<C1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)hit_bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((N + kReducePoints - 1) / kReducePoints, B);
    reduce_dA<C1><<<grid, 256, hit_bytes, s>>>(da_records, starts, n_blk, N, W, dA);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  reduce_records<8><<<(P + 31) / 32, 256, 0, s>>>(records, n_rec > 0 ? ctas : 0, P, wout);
  return cudaGetLastError();
}

cudaError_t launch_compact(const uint16_t* A, const uint16_t* bc, const float* g, const int* win,
                           const int* starts, const uint16_t* w2, const float* b2, const float* s2,
                           const float* lb2, const uint16_t* w3, int B, int N, int M, int W,
                           int c2_real, float* dA, float* dbc, float* wout, float* records,
                           float* da_records, int ctas, cudaStream_t s) {
  constexpr int C1 = kCpC1, P = record_floats(kCpC1, kCpC2, kCpC3);
  const CompactLayout L;
  if (L.total > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  const int n_blk = M / kCenters, n_rec = B * n_blk;
  const size_t hit_bytes = (size_t)2 * n_blk * sizeof(int);
  if (hit_bytes > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  // one record a CTA, each CTA over blocks blockIdx.x + ctas k (fixed: the
  // sums' order does not depend on the scheduling)
  if (n_rec > 0 && (ctas <= 0 || ctas > n_rec)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (n_rec > 0) {  // (the kernel zeroes each block's dA record)
    err = cudaFuncSetAttribute(pool_bwd_compact, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L.total);
    if (err != cudaSuccess) return err;
    pool_bwd_compact<<<ctas, kThreads, L.total, s>>>(
        A, bc, g, win, starts, w2, b2, s2, lb2, w3, B, N, M, W, (float)c2_real,
        1.f / (float)c2_real, dbc, records, da_records);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (B > 0 && N > 0) {
    err = cudaFuncSetAttribute(reduce_dA<C1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)hit_bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((N + kReducePoints - 1) / kReducePoints, B);
    reduce_dA<C1><<<grid, 256, hit_bytes, s>>>(da_records, starts, n_blk, N, W, dA);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  reduce_records<8><<<(P + 31) / 32, 256, 0, s>>>(records, n_rec > 0 ? ctas : 0, P, wout);
  return cudaGetLastError();
}

template <bool COMPACT>
int dispatch(const void* A, const void* bc, const float* g, const int* win, const int* starts,
             const void* w2, const float* b2, const float* s2, const float* lb2, const void* w3,
             int B, int N, int M, int c1, int c2, int c3, int c2_real, int W, float* dA,
             float* dbc, float* wout, float* records, float* da_records, void* stage, int ctas,
             void* stream) {
  if (B < 0 || M < 0 || M % kCenters || W <= 0 || W > N || c2_real <= 0 || c2_real > c2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint16_t*>(A);
  const auto* bcv = static_cast<const uint16_t*>(bc);
  const auto* w2v = static_cast<const uint16_t*>(w2);
  const auto* w3v = static_cast<const uint16_t*>(w3);
#define EDA_BWD_LAUNCH(X, Y, Z)                                                             \
  if (c1 == X && c2 == Y && c3 == Z)                                                        \
    return launch<X, Y, Z, COMPACT>(a, bcv, g, win, starts, w2v, b2, s2, lb2, w3v, B, N, M, \
                                    W, c2_real, dA, dbc, wout, records, da_records, s);
  EDA_BWD_LAUNCH(16, 16, 32)
  EDA_BWD_LAUNCH(32, 32, 64)
  EDA_BWD_LAUNCH(64, 64, 128)
  if (c1 == kCpC1 && c2 == kCpC2 && c3 == kCpC3) {
    // compact rows at (128, 128, 256) run pool_bwd_compact (no tile kernel
    // is built for them); windowed rows the tile kernel
    if constexpr (COMPACT)
      return launch_compact(a, bcv, g, win, starts, w2v, b2, s2, lb2, w3v, B, N, M, W, c2_real,
                            dA, dbc, wout, records, da_records, ctas, s);
    else
      EDA_BWD_LAUNCH(128, 128, 256)
  }
#undef EDA_BWD_LAUNCH
  // windowed rows at (256, 256, 512) run pool_bwd_wide; the compact rows there run
  // csrc/sa_pair_pool_bwd_wide_compact.cu (no kernel of this file takes them)
  if (c1 == kWideC1 && c2 == kWideC2 && c3 == kWideC3 && !COMPACT)
    return launch_wide(a, bcv, g, win, starts, w2v, b2, s2, lb2, w3v, B, N, M, W, c2_real, dA,
                       dbc, wout, records, da_records, static_cast<uint16_t*>(stage), ctas, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// A: (B, N, c1) bf16; bc: (B, M, c1) bf16; g: (B, M, c3) f32; win: (B, M, c3)
// int32 global winner ranks; starts: (B, M/16) int32 window starts (multiples
// of 16 in [0, N-W]); w2: (c1, c2) bf16; b2/s2/lb2: (c2,) f32; w3: (c2, c3)
// bf16. (c1, c2, c3) is one of (16, 16, 32), (32, 32, 64), (64, 64, 128),
// (128, 128, 256), the model's layer widths, or (256, 256, 512), the width-2
// backbone's (pool_bwd_wide, windowed rows only: the compact ones at these
// widths run csrc/sa_pair_pool_bwd_wide_compact.cu); narrower layers come
// zero-padded
// to one of them (zero W2 and W3 rows and columns, b2, s2, lb2, g past the
// real widths) and c2_real <= c2 is the real interior width, the LayerNorm's
// divisor. Outputs: dA (B, N, c1) f32; dbc (B, M, c1) f32; wout
// (c1 c2 + c2 c3 + 3 c2 + c3) f32 = [dW2 (c1, c2); dW3 (c2, c3); db2; ds2;
// dlb2; db3]. Scratch: records (B * M/16, the same length) f32 and
// da_records (B * M/16, W, c1) f32 (M/16 <= 29056); at (256, 256, 512), and
// for the compact rows at (128, 128, 256), records (ctas, the same length),
// one a CTA of ctas (1 <= ctas <= B * M/16) that each take every ctas-th
// block; at (256, 256, 512) also stage (ctas, 16 x 3 x 64 x 256) bf16, the
// CTAs' staged tiles (unused otherwise: NULL; ctas 0 where a CTA takes a block).
// Returns cudaGetLastError().
#define EDA_POOL_BWD_ARGS                                                              \
  const void *A, const void *bc, const float *g, const int *win, const int *starts,    \
      const void *w2, const float *b2, const float *s2, const float *lb2,              \
      const void *w3, int B, int N, int M, int c1, int c2, int c3, int c2_real, int W, \
      float *dA, float *dbc, float *wout, float *records, float *da_records,           \
      void *stage, int ctas, void *stream
#define EDA_POOL_BWD_CALL                                                             \
  A, bc, g, win, starts, w2, b2, s2, lb2, w3, B, N, M, c1, c2, c3, c2_real, W, dA, dbc, \
      wout, records, da_records, stage, ctas, stream

int sa_pool_bwd_compact_launch(EDA_POOL_BWD_ARGS) { return dispatch<true>(EDA_POOL_BWD_CALL); }
int sa_pool_bwd_window_launch(EDA_POOL_BWD_ARGS) { return dispatch<false>(EDA_POOL_BWD_CALL); }

}  // extern "C"
