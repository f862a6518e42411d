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
//     runs GEMM2 over its one-hot D as well: one code path for both.
//   * Weight gradients on the tensor cores, over live rows only: dW2 =
//     H0^T DX and dW3 = H1^T D read both operands MN-major from the tile's
//     buffers, K = the tile's 64 rows. At (64, 64, 128) and narrower the two
//     f32 sums stay in registers across the CTA's tiles (48 a thread at SA1);
//     at (128, 128, 256) they would take 192, and each tile's product is
//     added in 64 x 64 chunks to the CTA's own f32 record in device memory by
//     the thread that owns the element (no atomics; the record's loads are
//     in flight while the chunk's product runs). A second kernel adds the
//     records in a fixed order. Every weight and vector gradient and db_c is
//     a fixed-order sum: bit-identical across launches.
//   * dh0 goes through shared memory (f32, swizzled): the threads of a column
//     add each center's rows into db_c in row order. dA is shared by the
//     overlapping windows of other CTAs, so each CTA adds into its own f32
//     record of its window (W x c1, zeroed by the launcher): per tile, the
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
//     512 CTAs, 99 MB at batch 8) and one dA record of W c1 floats per CTA
//     (SA1: 1024 CTAs, 268 MB at batch 8), no pair-row buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kCenters = 16;
constexpr int kRows = 64;      // rows per wgmma tile
constexpr int kHash = 512;     // hash slots per warp (c3 <= 256 entries)
constexpr uint32_t kEmpty = 0xffffffffu;
constexpr float kEps = 1e-5f;
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

__device__ __forceinline__ uint32_t hash_slot(int rel) {
  return (uint32_t(rel) * 2654435761u) >> 23;  // 9 bits: kHash slots
}

// Insert (rel, o) into a warp's table: the slot of rel keeps the smallest o.
__device__ __forceinline__ void hash_insert(uint32_t* T, int rel, int o) {
  const uint32_t key = (uint32_t(rel) << 8) | uint32_t(o);
  uint32_t h = hash_slot(rel);
  while (true) {
    const uint32_t old = atomicCAS(&T[h], kEmpty, key);
    if (old == kEmpty) return;
    if ((old >> 8) == uint32_t(rel)) {
      atomicMin(&T[h], key);
      return;
    }
    h = (h + 1) & (kHash - 1);
  }
}
__device__ __forceinline__ int hash_leader(const uint32_t* T, int rel) {
  uint32_t h = hash_slot(rel);
  while ((T[h] >> 8) != uint32_t(rel)) h = (h + 1) & (kHash - 1);
  return int(T[h] & 0xffu);
}

// f32 (r, c) of the dh0 tile, its columns XOR-swizzled by row
template <int C1>
__device__ __forceinline__ int dh0_at(int r, int c) {
  return r * C1 + (c ^ (((r & 7) << 3) & (C1 - 1)));
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
          if (live[i]) hash_insert(T, rel[i], o);
        }
        __syncwarp();
        int lead[NO];
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          const int o = 32 * i + lane;
          lead[i] = live[i] ? hash_leader(T, rel[i]) : -1;
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

    // ---- LN forward in the accumulator: acc1 becomes xhat; h1 to shared.
    // A row's statistics: the quad's sums, then both warpgroups' halves in
    // order through shared memory.
    float mean[2], rstd[2];
    {
      float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < H2 / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float z = acc1[4 * j + e] + b2s[c2 + 8 * j + 2 * t4 + (e & 1)];
          acc1[4 * j + e] = z;
          sum[e / 2] += z;
          sq[e / 2] += z * z;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
        sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
        if (t4 == 0)
          *reinterpret_cast<float2*>(xs + (wg * kRows + r0 + 8 * h) * 2) =
              make_float2(sum[h], sq[h]);
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 p0 = *reinterpret_cast<const float2*>(xs + (r0 + 8 * h) * 2);
        const float2 p1 = *reinterpret_cast<const float2*>(xs + (kRows + r0 + 8 * h) * 2);
        mean[h] = div_width<C2>(p0.x + p1.x, c2f, rc2);
        const float var = fmaxf(div_width<C2>(p0.y + p1.y, c2f, rc2) - mean[h] * mean[h], 0.f);
        rstd[h] = rsqrtf(var + kEps);
      }
    }
    uint32_t pos_bits[(H2 / 2 + 31) / 32] = {};  // h1 > 0, one bit an accumulator
#pragma unroll
    for (int j = 0; j < H2 / 8; ++j) {
      const int c = c2 + 8 * j + 2 * t4;
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xh = (acc1[4 * j + e] - mean[e / 2]) * rstd[e / 2];
        acc1[4 * j + e] = xh;
        const float pre = xh * s2s[c + (e & 1)] + lb2s[c + (e & 1)];
        // h1 = bf16(relu(pre)) > 0 exactly where pre > 0
        if (pre > 0.f) pos_bits[(4 * j + e) / 32] |= 1u << ((4 * j + e) % 32);
        y[e] = fmaxf(pre, 0.f);
      }
      *reinterpret_cast<uint32_t*>(h1s + core_at(r0, c, CP2)) = pack_bf16x2(y[0], y[1]);
      *reinterpret_cast<uint32_t*>(h1s + core_at(r0 + 8, c, CP2)) = pack_bf16x2(y[2], y[3]);
    }
    wgmma_wait<0>();
    fence_regs(accd);

    // ---- LN + ReLU backward: accd becomes dln, then dxhat, then dx
    {
#pragma unroll
      for (int i = 0; i < H2 / 2; ++i)
        if (!((pos_bits[i / 32] >> (i % 32)) & 1u)) accd[i] = 0.f;
      fold_columns<H2, true>(accd, acc1, lane, run[1]);   // ds2
      fold_columns<H2, false>(accd, acc1, lane, run[2]);  // dlb2
      float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < H2 / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dxh = accd[4 * j + e] * s2s[c2 + 8 * j + 2 * t4 + (e & 1)];
          accd[4 * j + e] = dxh;
          m1[e / 2] += dxh;
          m2[e / 2] += dxh * acc1[4 * j + e];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m1[h] += __shfl_xor_sync(0xffffffffu, m1[h], 1);
        m1[h] += __shfl_xor_sync(0xffffffffu, m1[h], 2);
        m2[h] += __shfl_xor_sync(0xffffffffu, m2[h], 1);
        m2[h] += __shfl_xor_sync(0xffffffffu, m2[h], 2);
        if (t4 == 0)
          *reinterpret_cast<float2*>(xs + ((2 + wg) * kRows + r0 + 8 * h) * 2) =
              make_float2(m1[h], m2[h]);
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 p0 = *reinterpret_cast<const float2*>(xs + (2 * kRows + r0 + 8 * h) * 2);
        const float2 p1 = *reinterpret_cast<const float2*>(xs + (3 * kRows + r0 + 8 * h) * 2);
        m1[h] = div_width<C2>(p0.x + p1.x, c2f, rc2);
        m2[h] = div_width<C2>(p0.y + p1.y, c2f, rc2);
      }
#pragma unroll
      for (int j = 0; j < H2 / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          accd[4 * j + e] =
              rstd[e / 2] * (accd[4 * j + e] - m1[e / 2] - acc1[4 * j + e] * m2[e / 2]);
        const int c = c2 + 8 * j + 2 * t4;
        *reinterpret_cast<uint32_t*>(dxs + core_at(r0, c, C2)) =
            pack_bf16x2(accd[4 * j], accd[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dxs + core_at(r0 + 8, c, C2)) =
            pack_bf16x2(accd[4 * j + 2], accd[4 * j + 3]);
      }
      fold_columns<H2, false>(accd, acc1, lane, run[0]);  // db2
    }
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
  // the column sums: warp wq of warpgroup wg owns its rows at the wg's columns
  if (col_owner<F::NVH>(lane)) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < F::NR; ++i)
        red[(wq * 3 + q) * C2 + c2 + F::column(i, lane, t4)] = run[q][i];
  }
  __syncthreads();
  for (int i = tid; i < 3 * C2; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += red[w * 3 * C2 + i];
    rec[C1 * C2 + C2 * C3 + i] = s;
  }
  for (int i = tid; i < kCenters * C1; i += kThreads) dbc[cm0 * C1 + i] = dbcs[i];
}

// dA (B, N, C1): for each point, the dA records of the windows that cover it,
// added in block order. A CTA takes kReducePoints points of one batch row;
// its first warp lists the blocks whose window meets them, in order.
constexpr int kReducePoints = 64;

template <int C1>
__global__ void __launch_bounds__(256)
reduce_dA(const float* __restrict__ da_records, const int* __restrict__ starts, int n_blk,
          int N, int W, float* __restrict__ dA) {
  extern __shared__ int hits[];  // [n_blk] block, [n_blk] its window's start
  __shared__ int n_hits;
  const int b = blockIdx.y, p0 = blockIdx.x * kReducePoints;
  const int p1 = min(p0 + kReducePoints, N);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int j0 = 0; j0 < n_blk; j0 += 32) {
      const int j = j0 + lane;
      int s = 0;
      bool hit = false;
      if (j < n_blk) {
        s = min(max(starts[(size_t)b * n_blk + j], 0), N - W);
        hit = s < p1 && s + W > p0;
      }
      const uint32_t mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int k = n + __popc(mask & ((1u << lane) - 1u));
        hits[k] = j;
        hits[n_blk + k] = s;
      }
      n += __popc(mask);
    }
    if (lane == 0) n_hits = n;
  }
  __syncthreads();
  const int n = n_hits;
  for (int i = threadIdx.x; i < kReducePoints * (C1 / 4); i += blockDim.x) {
    const int p = p0 + i / (C1 / 4), q = i % (C1 / 4);
    if (p >= p1) break;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < n; ++k) {
      const int rel = p - hits[n_blk + k];
      if (rel < 0 || rel >= W) continue;
      const float4 v = *reinterpret_cast<const float4*>(
          da_records + (((size_t)b * n_blk + hits[k]) * W + rel) * C1 + 4 * q);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>(dA + ((size_t)b * N + p) * C1 + 4 * q) = acc;
  }
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

template <bool COMPACT>
int dispatch(const void* A, const void* bc, const float* g, const int* win, const int* starts,
             const void* w2, const float* b2, const float* s2, const float* lb2, const void* w3,
             int B, int N, int M, int c1, int c2, int c3, int c2_real, int W, float* dA,
             float* dbc, float* wout, float* records, float* da_records, void* stream) {
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
  EDA_BWD_LAUNCH(128, 128, 256)
#undef EDA_BWD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// A: (B, N, c1) bf16; bc: (B, M, c1) bf16; g: (B, M, c3) f32; win: (B, M, c3)
// int32 global winner ranks; starts: (B, M/16) int32 window starts (multiples
// of 16 in [0, N-W]); w2: (c1, c2) bf16; b2/s2/lb2: (c2,) f32; w3: (c2, c3)
// bf16. (c1, c2, c3) is one of (16, 16, 32), (32, 32, 64), (64, 64, 128),
// (128, 128, 256), the model's layer widths; narrower layers come zero-padded
// to one of them (zero W2 and W3 rows and columns, b2, s2, lb2, g past the
// real widths) and c2_real <= c2 is the real interior width, the LayerNorm's
// divisor. Outputs: dA (B, N, c1) f32; dbc (B, M, c1) f32; wout
// (c1 c2 + c2 c3 + 3 c2 + c3) f32 = [dW2 (c1, c2); dW3 (c2, c3); db2; ds2;
// dlb2; db3]. Scratch: records (B * M/16, the same length) f32 and
// da_records (B * M/16, W, c1) f32 (M/16 <= 29056). Returns cudaGetLastError().
#define EDA_POOL_BWD_ARGS                                                              \
  const void *A, const void *bc, const float *g, const int *win, const int *starts,    \
      const void *w2, const float *b2, const float *s2, const float *lb2,              \
      const void *w3, int B, int N, int M, int c1, int c2, int c3, int c2_real, int W, \
      float *dA, float *dbc, float *wout, float *records, float *da_records, void *stream
#define EDA_POOL_BWD_CALL                                                             \
  A, bc, g, win, starts, w2, b2, s2, lb2, w3, B, N, M, c1, c2, c3, c2_real, W, dA, dbc, \
      wout, records, da_records, stream

int sa_pool_bwd_compact_launch(EDA_POOL_BWD_ARGS) { return dispatch<true>(EDA_POOL_BWD_CALL); }
int sa_pool_bwd_window_launch(EDA_POOL_BWD_ARGS) { return dispatch<false>(EDA_POOL_BWD_CALL); }

}  // extern "C"
