// Set-abstraction pair-pool backward, compact rows at (c1, c2, c3) = (256, 256, 512):
// the width-4 backbone's SA1 (W = 1024, 8.32 M live rows at batch 8), and every
// narrower compact call above (128, 128, 256), which the wrapper zero-pads to these
// widths (c2_real, the LayerNorm's divisor).
//
// Replaces, for these rows, the TPU kernel eda_tpu/ops/pallas/sa_kernel.py:
// sa_pair_pool_bwd_pallas with compact=True (_make_bwd_compact_kernel, "K5"). It
// computes ops/cuda/sa_pool_bwd.py:sa_pool_bwd_plain (compact): one row per
// (center, channel o) with g != 0, whose cotangent is one-hot, and per row
//   h0 = bf16(relu(A_p + bc_c)) (a zero A row where the winner p lies outside
//   the window), x = h0 W2 + b2, xhat = (x - mean) rstd, h1 = bf16(relu(xhat s2 +
//   lb2)); dh1 = bf16(g_o) W3[:, o], dln = dh1 where h1 > 0, dx = rstd (dln s2 -
//   mean(dln s2) - xhat mean(dln s2 xhat)); dh0 = bf16(dx) W2^T where h0 > 0;
//   db_c += dh0, dA_p += bf16(dh0) (nothing outside the window),
//   dW2 += h0^T bf16(dx), dW3[:, o] += h1 bf16(g_o), db2 += dx, ds2 += dln xhat,
//   dlb2 += dln, db3[o] += g_o.
// The rounding points are the plain version's; every other sum is f32, summed in
// a fixed order (no atomics on any sum), so two launches agree bit for bit.
//
// Bound on this card (chip_smoke.py, pool_bwd_bound): pool_bwd_ops counts 6 c1 c2
// flops a row and 4 c2 a won channel (3.316 ms at W4X's SA1, batch 8, at the bf16
// peak). This kernel does less tensor work than that count: per row GEMM3 (2 c1
// c2) and two one-hot products over the tile's positions (the position sums of
// bf16(dx) and of bf16(dh0): 2 x 2 x 32 c2); per distinct (center, position) X =
// h0 W2 (2 c1 c2, a 64-row tile a group of up to 32 positions) and its part of
// dW2 (3 x 2 c1 c2); dh1 and dW3 are exact products on the CUDA cores.
//
// Design. What held the wide kernel's compact rows back (pool_bwd_wide, built for
// windowed rows): dense products over a one-hot D (57% of its tensor work), H0,
// H1 and bf16(dx) of every tile staged through device memory, and the forward
// recomputed for each of a center's ~500 rows, which share ~56 winning points
// (~9 rows a point at W4X's SA1). Here:
//   * One persistent CTA an SM (two warpgroups), CTA i over blocks i, i + ctas,
//     ... of 16 centers in order, center by center, with one record of c1 c2 + c2
//     c3 + 3 c2 + c3 floats; reduce_records adds the ctas records in order.
//   * A center's positions: its live channels' window offsets (one key for all
//     winners outside the window) deduplicated in a hash table, a position
//     leading with its smallest channel, positions in the order of their leaders;
//     its rows ordered by (position, channel).
//   * Groups of up to kGP = 32 positions: H0 of the positions (a 64-row tile,
//     rows past the group zero), X = H0 W2 on the tensor cores, the LayerNorm
//     forward in the accumulator; xhat (f32) and rstd of the positions stay in
//     shared memory for the group's rows. Each position's h1 and h0 go to a row
//     of the CTA's buffer in device memory.
//   * The group's rows in tiles of 64: the LayerNorm backward a warp a row on the
//     CUDA cores (dh1 = bf16(g_o) times the row o of W3^T, an exact product a
//     column: no product over a one-hot D; the row sums of four rows by one
//     transposing butterfly), bf16(dx) into the tile; then GEMM3 dh0 = bf16(dx)
//     W2^T and S^T += bf16(dx)^T P (P: row r -> its position, one-hot) on the
//     tensor cores; dh0 through h0's ReLU (bits of the positions), db_c's column
//     sums folded in registers (a tile holds one center's rows); dA of the tile's
//     positions by a one-hot product of bf16(dh0), added to the block's dA record
//     (W x c1 f32, zeroed by the CTA at the block's start) by the thread that
//     holds each sum. At the group's end S, the f32 sums of bf16(dx) over each
//     position's rows, goes to the positions' buffer rows.
//   * The weight gradients at the block's end (or where the buffer would
//     overflow). dW2 = H0^T S over the buffer's positions: S split exactly into
//     three bf16 parts (hi = bf16(S), mid = bf16(S - hi), lo = S - hi - mid), so
//     that H0^T (hi + mid + lo) is three products of exact bf16 products summed
//     in f32: the rows' h0^T bf16(dx) products summed in another order, a
//     position's rows first; K = 16 positions a step through a four-stage
//     cp.async ring, 64 columns of c2 at a time, added to the record by the
//     element's owner. dW3: for each column o and 16 rows of c2, the centers'
//     h1 slices of the position that won o (a map (center, channel) -> buffer
//     row), times bf16(g_o), summed over the centers in order (exact products,
//     f32 sums), added to the record's column. The record takes dW2 and dW3
//     once a block: their 768 KiB of sums fit no CTA beside W2 and the tiles.
//   * db2, ds2, dlb2: a lane's 8 columns (ln_col) over its warp's rows in
//     registers, the 8 warps added in order at the CTA's end; db3 over each
//     block's centers, added to the record a block at a time.
//   * dA: reduce_dA adds, for each point, the records of the windows that cover
//     it in block order. Every output is a fixed-order sum.
//   * Shared memory (219 264 bytes): W2 resident (128 KiB, stored transposed in
//     the core layout, read K-major by GEMM1 and MN-major by GEMM3); a 32 KiB
//     region for H0 of the positions, then xhat (32 x 256 f32); a 32 KiB tile for
//     bf16(dx), then bf16(dh0); both regions the weight passes' ring and slices
//     between groups; the two one-hot P operands (8 KiB, the hash table's and
//     db_c's partials' bytes between tiles); the center's position and row
//     lists, vectors, LayerNorm row sums (13 KiB).
//   * Scratch: a record a CTA (792 KB; 104 MB at 132 CTAs), the buffer
//     (kMaxBufRows rows of 2 KiB a CTA: 264 MiB at 132 CTAs), the map (32
//     KiB a CTA), and the dA records (W c1 floats a block: 1 GiB at W4X's SA1,
//     batch 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pool_bwd_common.cuh"

namespace {

using namespace pool_bwd;

constexpr int C1 = 256, C2 = 256, C3 = 512;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kCenters = 16;   // centers a window block
constexpr int kGP = 32;        // positions a group
constexpr int kHashLog = 10, kHashOb = 9;  // 1024 slots for up to 512 keys; 9 channel bits
constexpr int kMaxSharedBytes = 232448;
constexpr int kMaxBufRows = 1024;  // the dW3 pass stages a 32-byte slice of each row
constexpr int kBufRowElems = C2 + C1 + 2 * C2;  // a buffer row: h1, h0 (bf16), S (f32)
constexpr int kRecord = C1 * C2 + C2 * C3 + 3 * C2 + C3;  // dW2, dW3, db2, ds2, dlb2, db3
static_assert(C3 == 2 * kThreads && C1 == kThreads, "two channels and one column a thread");
static_assert(kMaxBufRows >= C3, "the buffer holds a center's positions");
static_assert(4 * (16 * C1 * 2 + 16 * 64 * 4) + 3 * 16 * 64 * 2 <= 2 * kRows * C1 * 2 &&
                  kMaxBufRows * 32 + kCenters * C3 * 4 <= 2 * kRows * C1 * 2,
              "the weight pass's stages fit H0's and the tile's bytes");

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

struct Layout {
  size_t w2, x, d, p2, p2a, vec, xs, rstd, m0, pair_of, rank, rowl, pkey, pstart, meta, total;
  __host__ __device__ Layout() {
    size_t o = 0;
    w2 = o;      o += align128((size_t)C2 * C1 * 2);
    x = o;       o += align128((size_t)kRows * C1 * 2);   // H0 (64 rows), xhat (32 x C2 f32)
    d = o;       o += align128((size_t)kRows * C2 * 2);   // bf16(dx), then bf16(dh0)
    p2 = o;      o += align128((size_t)kGP * kRows * 2);  // P^T: (position, row)
    p2a = o;     o += align128((size_t)kGP * kRows * 2);  // the in-window positions' P^T
    vec = o;     o += align128((size_t)3 * C2 * 4);
    xs = o;      o += align128((size_t)4 * kRows * 2 * 4);  // LN row sums of each half
    rstd = o;    o += align128((size_t)kGP * 4);
    m0 = o;      o += align128((size_t)kGP * (C1 / 32) * 4);  // h0 > 0, a bit a column
    pair_of = o; o += align128((size_t)C3 * 2);  // channel -> position, or -1
    rank = o;    o += align128((size_t)C3 * 2);  // channel -> rank among its position's
    rowl = o;    o += align128((size_t)C3 * 2);  // row -> channel
    pkey = o;    o += align128((size_t)C3 * 4);  // position -> window offset (W: outside)
    pstart = o;  o += align128((size_t)(C3 + 1) * 4);  // position -> its first row
    meta = o;    o += align128((size_t)3 * kRows * 4 + 24 * 4);  // a tile's rows; counters
    total = o;
  }
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 16 bytes from global to shared memory, in the thread's open cp.async group
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// `bytes` (a multiple of 16) at `p` into L2, without waiting
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// f32 xhat of position p at column c: row p, its 4-column groups XOR-swizzled by p % 8
__device__ __forceinline__ int xhat_at(int p, int c) { return p * C2 + (c ^ ((p & 7) << 2)); }
// The LayerNorm backward's columns of lane l, a warp a row: 4 l .. + 4 and 128 + 4 l .. + 4
// (e < 4, e >= 4), so that each 16-byte load or store of the warp is contiguous
__device__ __forceinline__ int ln_col(int lane, int e) { return 4 * lane + (e & 3) + 32 * (e & 4); }

__global__ void __launch_bounds__(kThreads, 1)
pool_bwd_compact_wide(const uint16_t* __restrict__ A, const uint16_t* __restrict__ bc,
                      const float* __restrict__ g, const int* __restrict__ win,
                      const int* __restrict__ starts, const uint16_t* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ s2,
                      const float* __restrict__ lb2, const uint16_t* __restrict__ w3t, int B,
                      int N, int M, int W, float c2f, float rc2, float* __restrict__ dbc,
                      float* __restrict__ records, float* __restrict__ da_records,
                      uint16_t* __restrict__ pbuf, int* __restrict__ pmap) {
  using F = Fold<C1 / 2>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L;
  uint16_t* w2s = reinterpret_cast<uint16_t*>(smem + L.w2);
  uint16_t* h0s = reinterpret_cast<uint16_t*>(smem + L.x);  // H0 of the positions
  float* xtab = reinterpret_cast<float*>(smem + L.x);       // xhat of the positions
  uint16_t* ds = reinterpret_cast<uint16_t*>(smem + L.d);   // bf16(dx), then bf16(dh0)
  uint16_t* p2t = reinterpret_cast<uint16_t*>(smem + L.p2);
  uint16_t* p2at = reinterpret_cast<uint16_t*>(smem + L.p2a);
  uint32_t* hash = reinterpret_cast<uint32_t*>(smem + L.p2);  // between tiles
  float* dred = reinterpret_cast<float*>(smem + L.p2);        // db_c's partials, likewise
  float* b2s = reinterpret_cast<float*>(smem + L.vec);
  float* s2s = b2s + C2;
  float* lb2s = s2s + C2;
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* rtab = reinterpret_cast<float*>(smem + L.rstd);
  uint32_t* m0tab = reinterpret_cast<uint32_t*>(smem + L.m0);
  int16_t* pair_of = reinterpret_cast<int16_t*>(smem + L.pair_of);
  int16_t* rnk = reinterpret_cast<int16_t*>(smem + L.rank);
  int16_t* rowl = reinterpret_cast<int16_t*>(smem + L.rowl);
  int* pkey = reinterpret_cast<int*>(smem + L.pkey);
  int* pstart = reinterpret_cast<int*>(smem + L.pstart);
  int* mp = reinterpret_cast<int*>(smem + L.meta);  // tile row -> position in the group, or -1
  int* mo = mp + kRows;                             // tile row -> channel
  float* mgb = reinterpret_cast<float*>(mo + kRows);  // tile row -> bf16(g)
  // positions, rows, the group's in-window positions, the tile's positions (two
  // words); then the leaders' ballots
  int* misc = mp + 3 * kRows;
  uint32_t* words = reinterpret_cast<uint32_t*>(misc + 8);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = tid / 128, wq = warp % 4, g8 = lane / 4, t4 = lane % 4;
  const int r0 = 16 * wq + g8;  // the thread's accumulator rows r0, r0 + 8
  const uint32_t lt = (1u << lane) - 1u;
  const int n_blk = M / kCenters;
  float* rec = records + (size_t)blockIdx.x * kRecord;
  float* rec3 = rec + C1 * C2;
  // the CTA's buffer of position rows: h1 and h0 (bf16), S (f32), kMaxBufRows each
  uint16_t* hbuf = pbuf + (size_t)blockIdx.x * kMaxBufRows * kBufRowElems;
  uint16_t* h0buf = hbuf + (size_t)kMaxBufRows * C2;
  float* sbuf = reinterpret_cast<float*>(h0buf + (size_t)kMaxBufRows * C1);
  int* map = pmap + (size_t)blockIdx.x * kCenters * C3;
  const uint32_t w2_base = smem_u32(w2s), x_base = smem_u32(h0s), d_base = smem_u32(ds);
  const uint32_t p2_base = smem_u32(p2t), p2a_base = smem_u32(p2at);

  // ---- W2 (transposed: rows c2, columns c1), vectors; the record's weight sums zeroed
  stage_kmajor<kThreads>(w2s, w2, C1, C2);
  for (int i = tid; i < C2; i += kThreads) {
    b2s[i] = b2[i];
    s2s[i] = s2[i];
    lb2s[i] = lb2[i];
  }
  for (int i = tid; i < (C1 * C2 + C2 * C3) / 4; i += kThreads)
    reinterpret_cast<float4*>(rec)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_async();

  float run[3][8];  // db2, ds2, dlb2 of the lane's columns (ln_col), over its warp's rows
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) run[q][e] = 0.f;

  // ---- the CTA's blocks of 16 centers, blockIdx.x + gridDim.x k, in order
  for (int blk = blockIdx.x; blk < B * n_blk; blk += gridDim.x) {
    const int b = blk / n_blk;
    const size_t cm0 = (size_t)b * M + (blk % n_blk) * kCenters;
    int start = starts[blk];
    start = min(max(start, 0), N - W);
    const int pos0 = b * N + start;  // the A row of the window's first point
    float* drec = da_records + (size_t)blk * W * C1;
    for (int i = tid; i < W * C1 / 4; i += kThreads)
      reinterpret_cast<float4*>(drec)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    // db3 (channels tid, tid + 256): the block's centers in order, added to the
    // record's (the CTA's first block writes it)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
      for (int cc = 0; cc < kCenters; ++cc) {
        const float gv = g[(cm0 + cc) * C3 + tid + kThreads * h];
        if (gv != 0.f) s += gv;
      }
      float* db3 = rec + C1 * C2 + C2 * C3 + 3 * C2 + tid + kThreads * h;
      *db3 = blk == (int)blockIdx.x ? s : __ldcg(db3) + s;
    }

    // The weight gradients of centers [c0, c1), whose n positions are the
    // buffer's first n rows. dW2 += H0^T (hi + mid + lo)(S), 64 columns of c2 at
    // a time (each warpgroup its 128 rows of c1, two 64-row blocks), K = 16
    // positions a step through a four-stage cp.async ring in shared memory
    // (H0's and the tile's bytes: no group is open); added to the record by the
    // element's owner. Then dW3: for each 16 rows of c2,
    // the rows' h1 slices staged; each thread its channels o = tid, tid + 256
    // over the centers in order (exact products, f32 sums), added to the
    // record's columns.
    const auto weight_pass = [&](int c0, int c1, int n) {
      __syncthreads();  // the centers' h1, h0 and S rows and map entries are written
      if (n > 0) {
        // KP positions a step through a ring of four stages that cp.async fills
        // three steps ahead: the positions' H0 rows (the core layout) and S's 64
        // columns (f32, 256 bytes a row); the step's three bf16 parts of S beside
        constexpr int KP = 16, NST = 4, H0B = KP * C1 * 2, STAGE = H0B + KP * 64 * 4;
        unsigned char* ring = smem + L.x;
        uint16_t* parts = reinterpret_cast<uint16_t*>(ring + NST * STAGE);  // [3][KP x 64]
        const int steps = (n + KP - 1) / KP;
        const auto fetch = [&](int t, int nc) {  // one copy group a step (empty past the last)
          if (t < steps) {
            unsigned char* st = ring + (t % NST) * STAGE;
            const int k0 = KP * t;
#pragma unroll
            for (int u = 0; u < KP * C1 / 8 / kThreads; ++u) {
              const int i = tid + kThreads * u;
              const int kb = (i >> 3) % (C1 / 8), r = ((i >> 3) / (C1 / 8)) * 8 + (i & 7);
              uint16_t* dst = reinterpret_cast<uint16_t*>(st) + core_at(r, 8 * kb, C1);
              if (k0 + r < n) cp_async16(dst, h0buf + (size_t)(k0 + r) * C1 + 8 * kb);
              else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
            }
            const int r = tid / 16, q = tid % 16;  // S: 16 bytes a thread
            float* dst = reinterpret_cast<float*>(st + H0B) + r * 64 + 4 * q;
            if (k0 + r < n) cp_async16(dst, sbuf + (size_t)(k0 + r) * C2 + 64 * nc + 4 * q);
            else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
          asm volatile("cp.async.commit_group;\n" ::: "memory");
        };
#pragma unroll 1
        for (int nc = 0; nc < C2 / 64; ++nc) {
          float acc[2][32];
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;
          __syncthreads();  // the ring's last readers are done
#pragma unroll 1
          for (int t = 0; t < NST - 1; ++t) fetch(t, nc);
#pragma unroll 1
          for (int t = 0; t < steps; ++t) {
            asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 2) : "memory");
            fence_async();
            __syncthreads();  // step t's rows landed; step t - 1's readers are done
            fetch(t + NST - 1, nc);
            {  // S's parts: hi = bf16(S), mid = bf16(S - hi), lo = S - hi - mid
              const int r = tid / 16, c = 4 * (tid % 16);
              const float4 sv = *reinterpret_cast<const float4*>(
                  ring + (t % NST) * STAGE + H0B + (r * 64 + c) * 4);
              const float v[4] = {sv.x, sv.y, sv.z, sv.w};
              uint16_t pt[3][4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float hi = bf16_round(v[e]), r1 = v[e] - hi;
                const float mid = bf16_round(r1);
                pt[0][e] = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
                pt[1][e] = __bfloat16_as_ushort(__float2bfloat16_rn(mid));
                pt[2][e] = __bfloat16_as_ushort(__float2bfloat16_rn(r1 - mid));
              }
#pragma unroll
              for (int k = 0; k < 3; ++k)
                *reinterpret_cast<uint2*>(parts + k * KP * 64 + core_at(r, c, 64)) =
                    make_uint2(pt[k][0] | (uint32_t(pt[k][1]) << 16),
                               pt[k][2] | (uint32_t(pt[k][3]) << 16));
            }
            fence_async();
            __syncthreads();
            const uint32_t h = opaque(x_base) + (t % NST) * STAGE, pb = smem_u32(parts);
            wgmma_fence();
#pragma unroll
            for (int mb = 0; mb < 2; ++mb)
#pragma unroll
              for (int k = 0; k < 3; ++k)
                wgmma_ss<64, 1, 1>(acc[mb],
                                   make_desc(h + ((wg * 128 + 64 * mb) / 8) * 128, C1 * 16, 128),
                                   make_desc(pb + k * KP * 64 * 2, 64 * 16, 128), 1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc[0]);
            fence_regs(acc[1]);
          }
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            float* base = rec + (size_t)(wg * 128 + 64 * mb + r0) * C2 + 64 * nc + 2 * t4;
            float2 old[16];
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                old[2 * j + hh] = __ldcg(reinterpret_cast<const float2*>(base + hh * 8 * C2 + 8 * j));
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                *reinterpret_cast<float2*>(base + hh * 8 * C2 + 8 * j) =
                    make_float2(old[2 * j + hh].x + acc[mb][4 * j + 2 * hh],
                                old[2 * j + hh].y + acc[mb][4 * j + 2 * hh + 1]);
          }
        }
        __syncthreads();  // the ring is read before the slices below take its bytes
      }
      // dW3: the centers' entries into shared memory, a word a (center, channel):
      // its buffer row (low half, -1: none) and bf16(g) (high half); then for
      // each 16 rows of c2 the rows' 32-byte h1 slices
      uint4* slices = reinterpret_cast<uint4*>(smem + L.x);  // [row][2]
      uint32_t* ent = reinterpret_cast<uint32_t*>(smem + L.x + kMaxBufRows * 32);  // [center][o]
      for (int i = tid; i < (c1 - c0) * C3; i += kThreads) {
        const uint32_t gb = __bfloat16_as_ushort(__float2bfloat16_rn(g[(cm0 + c0) * C3 + i]));
        ent[i] = (uint32_t(__ldcg(map + c0 * C3 + i)) & 0xffffu) | (gb << 16);
      }
      for (int i = tid; i < C2 * C3 / 256; i += kThreads)  // the record's dW3 into L2
        prefetch_l2(rec3 + (size_t)i * 256, 1024);
#pragma unroll 1
      for (int kc = 0; kc < C2 / 16; ++kc) {
        for (int i = tid; i < n * 2; i += kThreads)
          slices[i] = __ldcg(reinterpret_cast<const uint4*>(hbuf + (size_t)(i / 2) * C2 + 16 * kc) +
                             i % 2);
        __syncthreads();
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
          const int o = tid + kThreads * h;
          float acc[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll 4
          for (int cc = 0; cc < c1 - c0; ++cc) {
            const uint32_t w = ent[cc * C3 + o];
            const int e = int16_t(w & 0xffffu);
            if (e < 0) continue;
            const float gb = hi_bf16(w);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const uint4 v = slices[e * 2 + q];
              const uint32_t hw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                acc[8 * q + 2 * k] += lo_bf16(hw[k]) * gb;
                acc[8 * q + 2 * k + 1] += hi_bf16(hw[k]) * gb;
              }
            }
          }
          float* col = rec3 + (size_t)(16 * kc) * C3 + o;
          float old[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) old[i] = __ldcg(col + (size_t)i * C3);
#pragma unroll
          for (int i = 0; i < 16; ++i) col[(size_t)i * C3] = old[i] + acc[i];
        }
        __syncthreads();  // the slices are read before the next ones
      }
    };

    int c_lo = 0, used = 0;  // the h1 buffer holds centers [c_lo, cc): `used` rows
#pragma unroll 1
    for (int cc = 0; cc < kCenters; ++cc) {
      const size_t cm = cm0 + cc;
      // ---- the center's positions and rows (the next center's g and winners into L2)
      if (tid < 2 && cc + 1 < kCenters)
        prefetch_l2(tid ? (const void*)(win + (cm + 1) * C3) : (const void*)(g + (cm + 1) * C3),
                    C3 * 4);
      for (int i = tid; i < (1 << kHashLog); i += kThreads) hash[i] = kEmpty;
      for (int i = tid; i <= C3; i += kThreads) pstart[i] = 0;
      __syncthreads();
      bool live[2];
      int key[2], lead[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = tid + kThreads * h;
        live[h] = g[cm * C3 + o] != 0.f;
        const int rel = win[cm * C3 + o] - start;
        key[h] = rel >= 0 && rel < W ? rel : W;  // all winners outside: one key
        if (live[h]) hash_insert<kHashLog, kHashOb>(hash, key[h], o);
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lead[h] = live[h] ? hash_leader<kHashLog, kHashOb>(hash, key[h]) : -1;
        const uint32_t m = __ballot_sync(0xffffffffu, lead[h] == tid + kThreads * h);
        if (lane == 0) words[warp + kWarps * h] = m;  // channels 32 (warp + 8 h) ..
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = tid + kThreads * h, w = warp + kWarps * h;
        if (lead[h] == o) {  // a leader: its position's index in channel order
          int n = __popc(words[w] & lt);
          for (int k = 0; k < w; ++k) n += __popc(words[k]);
          pair_of[o] = int16_t(n);
          pkey[n] = key[h];
        }
      }
      if (tid == 0) {
        int n = 0;
        for (int k = 0; k < 2 * kWarps; ++k) n += __popc(words[k]);
        misc[0] = n;
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = tid + kThreads * h;
        if (lead[h] < 0) pair_of[o] = -1;
        else if (lead[h] != o) pair_of[o] = pair_of[lead[h]];
      }
      __syncthreads();
      // ranks within each position in channel order, the positions' row counts
      // (warp 0), then their first rows
      if (warp == 0) {
#pragma unroll 1
        for (int k = 0; k < C3 / 32; ++k) {
          const int o = 32 * k + lane, p = pair_of[o];
          const uint32_t peers = __match_any_sync(0xffffffffu, p);
          const int rk = p >= 0 ? pstart[1 + p] + __popc(peers & lt) : -1;
          __syncwarp();
          if (p >= 0 && (peers >> lane) == 1u) pstart[1 + p] += __popc(peers);
          rnk[o] = int16_t(rk);
          __syncwarp();
        }
        const int np = misc[0];
        int carry = 0;
#pragma unroll 1
        for (int p0 = 0; p0 < np; p0 += 32) {
          const int p = p0 + lane;
          int v = p < np ? pstart[1 + p] : 0;
#pragma unroll
          for (int m = 1; m < 32; m *= 2) {
            const int u = __shfl_up_sync(0xffffffffu, v, m);
            if (lane >= m) v += u;
          }
          if (p < np) pstart[1 + p] = carry + v;
          carry += __shfl_sync(0xffffffffu, v, 31);
        }
        if (lane == 0) misc[1] = carry;  // the center's rows
      }
      __syncthreads();
      const int npos = misc[0], nrows = misc[1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = tid + kThreads * h, p = pair_of[o];
        if (p >= 0) rowl[pstart[p] + rnk[o]] = int16_t(o);
      }
      for (int p = tid; p < npos; p += kThreads)  // the positions' A rows into L2
        if (pkey[p] < W) prefetch_l2(A + (size_t)(pos0 + pkey[p]) * C1, C1 * 2);
      if (nrows == 0) {
        dbc[cm * C1 + tid] = 0.f;
        for (int o = tid; o < C3; o += kThreads) map[cc * C3 + o] = -1;
        __syncthreads();  // the tables are read before the next center's
        continue;
      }
      if (used + npos > kMaxBufRows) {  // the buffer is full: the weight gradients of its centers
        weight_pass(c_lo, cc, used);
        c_lo = cc;
        used = 0;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = tid + kThreads * h;
        map[cc * C3 + o] = pair_of[o] >= 0 ? used + pair_of[o] : -1;
      }
      float dbc_run[F::NR];  // db_c's column sums of the thread's columns
#pragma unroll
      for (int i = 0; i < F::NR; ++i) dbc_run[i] = 0.f;

      // ---- the center's groups of up to kGP positions
#pragma unroll 1
      for (int p_lo = 0; p_lo < npos; p_lo += kGP) {
        const int np = min(kGP, npos - p_lo);
        const int row_lo = pstart[p_lo], row_hi = p_lo + np < npos ? pstart[p_lo + np] : nrows;
        // H0 of the positions (64 rows; rows past np zero), and into the buffer:
        // 16 bytes a thread at a time, the 8 threads of a quarter warp on the 8
        // rows of one core
        const auto build_h0 = [&]() {
          for (int i = tid; i < kRows * C1 / 8; i += kThreads) {
            const int kb = (i >> 3) % (C1 / 8), r = ((i >> 3) / (C1 / 8)) * 8 + (i & 7);
            const int k = r < np ? pkey[p_lo + r] : W;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (r < np) {
              const uint4 a = k < W ? __ldg(reinterpret_cast<const uint4*>(
                                          A + (size_t)(pos0 + k) * C1) + kb)
                                    : make_uint4(0u, 0u, 0u, 0u);
              const uint4 c = __ldg(reinterpret_cast<const uint4*>(bc + cm * C1) + kb);
              v = make_uint4(add_relu_bf16x2(a.x, c.x), add_relu_bf16x2(a.y, c.y),
                             add_relu_bf16x2(a.z, c.z), add_relu_bf16x2(a.w, c.w));
            }
            *reinterpret_cast<uint4*>(h0s + core_at(r, 8 * kb, C1)) = v;
            if (r < np)
              *reinterpret_cast<uint4*>(h0buf + (size_t)(used + p_lo + r) * C1 + 8 * kb) = v;
          }
        };
        build_h0();
        if (tid == 0) {  // the group's in-window positions
          uint32_t m = 0u;
          for (int p = 0; p < np; ++p)
            if (pkey[p_lo + p] < W) m |= 1u << p;
          misc[2] = int(m);
        }
        fence_async();
        __syncthreads();
        {  // h0 > 0 (the sign bit masked off: max(-0, 0) may keep -0), before xhat
           // takes H0's bytes
          const int p = tid >> 3, w = tid & 7;
          uint32_t bits = 0u;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint4 v = *reinterpret_cast<const uint4*>(h0s + core_at(p, 32 * w + 8 * q, C1));
            const uint32_t hw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (hw[k] & 0x7fffu) bits |= 1u << (8 * q + 2 * k);
              if (hw[k] & 0x7fff0000u) bits |= 1u << (8 * q + 2 * k + 1);
            }
          }
          m0tab[p * (C1 / 32) + w] = bits;
        }
        // ---- GEMM1 X = H0 W2, each warpgroup its 128 columns of c2
        float acc[64];
        {
          const uint32_t h0b = opaque(x_base), w2b = opaque(w2_base) + (wg * 128 / 8) * C1 * 16;
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < C1 / 16; ++s)
            wgmma_ss<128, 0, 0>(acc, make_desc(h0b + 256 * s, 128, C1 * 16),
                                make_desc(w2b + 256 * s, 128, C1 * 16), s > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
        }
        // ---- the LayerNorm forward: xhat and rstd of the positions into the table
        // (the barrier in ln_stats: both warpgroups' GEMM1 and the bits have read
        // H0), h1 into the buffer
        {
          float mean[2], rstd[2];
          ln_stats<C2, C2 / 2>(acc, b2s, xs, wg, r0, t4, c2f, rc2, mean, rstd);
          const int cp = (int)opaque(wg * 128 + 2 * t4);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = cp + 8 * j;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = r0 + 8 * hh;
              const float x0 = (acc[4 * j + 2 * hh] - mean[hh]) * rstd[hh];
              const float x1 = (acc[4 * j + 2 * hh + 1] - mean[hh]) * rstd[hh];
              if (r < np) {
                *reinterpret_cast<float2*>(xtab + xhat_at(r, c)) = make_float2(x0, x1);
                const float y0 = fmaxf(x0 * s2s[c] + lb2s[c], 0.f);
                const float y1 = fmaxf(x1 * s2s[c + 1] + lb2s[c + 1], 0.f);
                *reinterpret_cast<uint32_t*>(hbuf + (size_t)(used + p_lo + r) * C2 + c) =
                    pack_bf16x2(y0, y1);
              }
            }
          }
          if (t4 == 0 && wg == 0)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              if (r0 + 8 * hh < np) rtab[r0 + 8 * hh] = rstd[hh];
        }
        __syncthreads();
        const uint32_t inwin = uint32_t(misc[2]);

        // S^T: the f32 sums of bf16(dx) over each position's rows (c2 rows 128 wg +
        // 64 mb + .., positions 8 j + 2 t4 ..), over the group's tiles
        float accS[2][16];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int i = 0; i < 16; ++i) accS[mb][i] = 0.f;

#pragma unroll 1
        for (int t0 = row_lo; t0 < row_hi; t0 += kRows) {
          const int rows = min(kRows, row_hi - t0);
          // ---- the tile's rows: position in the group, channel, bf16(g)
          if (tid < kRows) {
            int p = -1, o = 0;
            float gb = 0.f;
            if (tid < rows) {
              o = rowl[t0 + tid];
              p = pair_of[o] - p_lo;
              gb = bf16_round(g[cm * C3 + o]);
            }
            mp[tid] = p;
            mo[tid] = o;
            mgb[tid] = gb;
            const uint32_t present = __reduce_or_sync(0xffffffffu, p >= 0 ? 1u << p : 0u);
            if (lane == 0) misc[4 + warp] = int(present);
          }
          __syncthreads();
          if (tid < kGP && ((uint32_t(misc[4] | misc[5]) & inwin) >> tid & 1u))
            prefetch_l2(drec + (size_t)pkey[p_lo + tid] * C1, C1 * 4);  // (added to below)
          // P^T (position p, row r) = 1 where row r has position p; P_A^T the same
          // for the in-window positions
          {
            const int rb = (tid >> 3) % (kRows / 8), p = ((tid >> 3) / (kRows / 8)) * 8 + (tid & 7);
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[e] = (mp[8 * rb + 2 * e] == p ? 0x3f80u : 0u) |
                     (mp[8 * rb + 2 * e + 1] == p ? 0x3f800000u : 0u);
            const uint4 v = make_uint4(w[0], w[1], w[2], w[3]);
            *reinterpret_cast<uint4*>(p2t + core_at(p, 8 * rb, kRows)) = v;
            *reinterpret_cast<uint4*>(p2at + core_at(p, 8 * rb, kRows)) =
                (inwin >> p) & 1u ? v : make_uint4(0u, 0u, 0u, 0u);
          }
          // ---- the LayerNorm backward, a warp a row (rows r = warp + 8 i), the
          // lane's columns c .. c + 8: bf16(dx) into the tile
          // (two passes of four rows: each row's W3^T loads in flight together, the
          // four rows' eight row sums by one transposing butterfly)
          float sc[8], sh[8];  // s2 and lb2 of the lane's columns
          {
            const float4 s0 = *reinterpret_cast<const float4*>(s2s + 4 * lane);
            const float4 s1 = *reinterpret_cast<const float4*>(s2s + 128 + 4 * lane);
            const float4 h0 = *reinterpret_cast<const float4*>(lb2s + 4 * lane);
            const float4 h1 = *reinterpret_cast<const float4*>(lb2s + 128 + 4 * lane);
            const float a[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
            const float b[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              sc[e] = a[e];
              sh[e] = b[e];
            }
          }
#pragma unroll 1
          for (int i0 = 0; i0 < kRows / kWarps; i0 += 4) {
            uint2 w3v[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = warp + kWarps * (i0 + i);
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
                w3v[i][hf] = r < rows ? __ldg(reinterpret_cast<const uint2*>(
                                            w3t + (size_t)mo[r] * C2 + 128 * hf + 4 * lane))
                                      : make_uint2(0u, 0u);
            }
            float xh[4][8], dxh[4][8], v[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = warp + kWarps * (i0 + i);
              float m1 = 0.f, m2 = 0.f;
#pragma unroll
              for (int e = 0; e < 8; ++e) xh[i][e] = dxh[i][e] = 0.f;
              if (r < rows) {
                const int p = mp[r];
                const float gb = mgb[r];
                const float4 xa = *reinterpret_cast<const float4*>(xtab + xhat_at(p, 4 * lane));
                const float4 xb =
                    *reinterpret_cast<const float4*>(xtab + xhat_at(p, 128 + 4 * lane));
                const float x8[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
                const uint32_t ww[4] = {w3v[i][0].x, w3v[i][0].y, w3v[i][1].x, w3v[i][1].y};
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  const float w3e = e & 1 ? hi_bf16(ww[e / 2]) : lo_bf16(ww[e / 2]);
                  const float dh = gb * w3e;  // exact: one bf16 product
                  const float dln = x8[e] * sc[e] + sh[e] > 0.f ? dh : 0.f;  // h1 > 0
                  run[1][e] += dln * x8[e];
                  run[2][e] += dln;
                  xh[i][e] = x8[e];
                  dxh[i][e] = dln * sc[e];
                  m1 += dxh[i][e];
                  m2 += dxh[i][e] * x8[e];
                }
              }
              v[2 * i] = m1;
              v[2 * i + 1] = m2;
            }
            // row sum q (row q / 2, m1 or m2) ends in the lanes whose bits 16, 8, 4
            // spell q (one value in each: the butterfly's last two steps are
            // symmetric), and is read from there by every lane
            sum_step<8>(v, 16, lane & 16);
            sum_step<4>(v, 8, lane & 8);
            sum_step<2>(v, 4, lane & 4);
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
            float sums[8];
#pragma unroll
            for (int q = 0; q < 8; ++q)
              sums[q] = __shfl_sync(0xffffffffu, v[0], 16 * (q >> 2) + 8 * ((q >> 1) & 1) + 4 * (q & 1));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = warp + kWarps * (i0 + i);
              uint2 out[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};
              if (r < rows) {
                const float rs = rtab[mp[r]];
                const float m1 = div_width<C2>(sums[2 * i], c2f, rc2);
                const float m2 = div_width<C2>(sums[2 * i + 1], c2f, rc2);
                float dx[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  dx[e] = rs * ((dxh[i][e] - m1) - xh[i][e] * m2);
                  run[0][e] += dx[e];
                }
#pragma unroll
                for (int hf = 0; hf < 2; ++hf)
                  out[hf] = make_uint2(pack_bf16x2(dx[4 * hf], dx[4 * hf + 1]),
                                       pack_bf16x2(dx[4 * hf + 2], dx[4 * hf + 3]));
              }
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
                *reinterpret_cast<uint2*>(ds + core_at(r, 128 * hf + 4 * lane, C2)) = out[hf];
            }
          }
          fence_async();
          __syncthreads();
          // ---- GEMM3 dh0 = bf16(dx) W2^T (W2 read MN-major; each warpgroup its 128
          // columns of c1) and S^T += bf16(dx)^T P (M = c2, each warpgroup its 128)
          float acc3[64];
          {
            const uint32_t dxb = opaque(d_base), w2b = opaque(w2_base) + (wg * 128 / 8) * 128;
            const uint32_t pb = opaque(p2_base);
            wgmma_fence();
#pragma unroll
            for (int s = 0; s < C2 / 16; ++s)
              wgmma_ss<128, 0, 1>(acc3, make_desc(dxb + 256 * s, 128, C2 * 16),
                                  make_desc(w2b + s * 32 * C1, C1 * 16, 128), s > 0);
#pragma unroll
            for (int mb = 0; mb < 2; ++mb)
#pragma unroll
              for (int s = 0; s < kRows / 16; ++s)
                wgmma_ss<32, 1, 0>(accS[mb],
                                   make_desc(dxb + ((wg * 128 + 64 * mb) / 8) * 128 + s * 32 * C2,
                                             C2 * 16, 128),
                                   make_desc(pb + 256 * s, 128, kRows * 16), 1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc3);
            fence_regs(accS[0]);
            fence_regs(accS[1]);
          }
          // ---- dh0 through h0's ReLU (the bits of the row's position); db_c's
          // column sums (the tile's rows are one center's)
          {
            const int cp = (int)opaque(wg * 128 + 2 * t4);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int p = mp[r0 + 8 * hh];
              const uint32_t* bits = m0tab + (p >= 0 ? p : 0) * (C1 / 32);
#pragma unroll
              for (int j = 0; j < 16; ++j) {
                const int c = cp + 8 * j;
                const uint32_t w = p >= 0 ? bits[c / 32] >> (c & 31) : 0u;
                if (!(w & 1u)) acc3[4 * j + 2 * hh] = 0.f;
                if (!(w & 2u)) acc3[4 * j + 2 * hh + 1] = 0.f;
              }
            }
            fold_columns<C1 / 2, false>(acc3, acc3, lane, dbc_run);
          }
          __syncthreads();  // both warpgroups' products have read bf16(dx) and P
          {  // bf16(dh0) in bf16(dx)'s place
            const int cp = (int)opaque(wg * 128 + 2 * t4);
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                *reinterpret_cast<uint32_t*>(ds + core_at(r0 + 8 * hh, cp + 8 * j, C1)) =
                    pack_bf16x2(acc3[4 * j + 2 * hh], acc3[4 * j + 2 * hh + 1]);
          }
          fence_async();
          __syncthreads();
          // ---- dA of the tile's positions: bf16(dh0)^T P_A (M = c1, each
          // warpgroup its 128; the rows' exact bf16 values summed in f32), added
          // to the block's record by the thread that holds each sum
          {
            // the record values first (their loads in flight while the product runs)
            const uint32_t live_pos = uint32_t(misc[4] | misc[5]) & inwin;
            int row[8];  // the record offsets of the thread's positions
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int p = 8 * (k / 2) + 2 * t4 + (k & 1);
              row[k] = (live_pos >> p) & 1u ? pkey[p_lo + p] * C1 : -1;
            }
            float old[2][16];
#pragma unroll
            for (int mb = 0; mb < 2; ++mb)
#pragma unroll
              for (int i = 0; i < 16; ++i) {
                const int k = 2 * (i / 4) + (i & 1);
                const int c = wg * 128 + 64 * mb + r0 + 8 * ((i / 2) & 1);
                old[mb][i] = row[k] >= 0 ? __ldcg(drec + row[k] + c) : 0.f;
              }
            float accA[2][16];
            const uint32_t hb = opaque(d_base), pab = opaque(p2a_base);
            wgmma_fence();
#pragma unroll
            for (int mb = 0; mb < 2; ++mb)
#pragma unroll
              for (int s = 0; s < kRows / 16; ++s)
                wgmma_ss<32, 1, 0>(accA[mb],
                                   make_desc(hb + ((wg * 128 + 64 * mb) / 8) * 128 + s * 32 * C1,
                                             C1 * 16, 128),
                                   make_desc(pab + 256 * s, 128, kRows * 16), s > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(accA[0]);
            fence_regs(accA[1]);
#pragma unroll
            for (int mb = 0; mb < 2; ++mb)
#pragma unroll
              for (int i = 0; i < 16; ++i) {
                const int k = 2 * (i / 4) + (i & 1);
                const int c = wg * 128 + 64 * mb + r0 + 8 * ((i / 2) & 1);
                if (row[k] >= 0) drec[row[k] + c] = old[mb][i] + accA[mb][i];
              }
          }
          __syncthreads();  // the tile's buffers are rewritten by the next tile
        }  // the group's tiles

        // ---- S of the group's positions into the buffer (dW2 at the block's end)
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int p = 8 * (i / 4) + 2 * t4 + (i & 1);
            const int c = wg * 128 + 64 * mb + r0 + 8 * ((i / 2) & 1);
            if (p < np) sbuf[(size_t)(used + p_lo + p) * C2 + c] = accS[mb][i];
          }
      }  // the center's groups

      // ---- db_c: the 4 warps of each warpgroup added in order (dred: [4][C1])
      if (col_owner<F::NVH>(lane))
#pragma unroll
        for (int i = 0; i < F::NR; ++i)
          dred[wq * C1 + wg * 128 + F::column(i, lane, t4)] = dbc_run[i];
      __syncthreads();
      {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) s += dred[w * C1 + tid];
        dbc[cm * C1 + tid] = s;
      }
      __syncthreads();  // dred's bytes are the next center's hash table
      used += npos;
    }  // the block's centers
    weight_pass(c_lo, kCenters, used);
  }  // the CTA's blocks

  // ---- the record's column sums (the 8 warps in order)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + L.x);  // [8 warps][3][C2], over x and d
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(warp * 3 + q) * C2 + ln_col(lane, e)] = run[q][e];
  __syncthreads();
  for (int i = tid; i < 3 * C2; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * 3 * C2 + i];
    rec[C1 * C2 + C2 * C3 + i] = s;
  }
}

}  // namespace

extern "C" {

// A: (B, N, 256) bf16; bc: (B, M, 256) bf16; g: (B, M, 512) f32; win: (B, M, 512)
// int32 global winner ranks; starts: (B, M/16) int32 window starts (multiples of 16
// in [0, N-W]); w2: (256, 256) bf16; b2/s2/lb2: (256,) f32; w3t: W3^T, (512, 256)
// bf16 (row o is W3's column o); narrower layers come zero-padded (zero W2 and W3
// rows and columns, b2, s2, lb2, g past the real widths) and c2_real <= 256 is the
// real interior width, the LayerNorm's divisor. Outputs: dA (B, N, 256) f32; dbc
// (B, M, 256) f32; wout (256 256 + 256 512 + 3 256 + 512) f32 = [dW2; dW3; db2;
// ds2; dlb2; db3]. Scratch: records (ctas, the same length) f32, da_records (B *
// M/16, W, 256) f32 (M/16 <= 29056), pbuf (ctas, 1024, 1024) bf16 (a
// row: h1 and h0 in bf16, S in f32) and pmap (ctas, 16, 512) int32; ctas (1 <= ctas <= B * M/16) CTAs that each take every ctas-th
// block. Returns cudaGetLastError().
int sa_pool_bwd_wide_compact_launch(const void* A, const void* bc, const float* g,
                                    const int* win, const int* starts, const void* w2,
                                    const float* b2, const float* s2, const float* lb2,
                                    const void* w3t, int B, int N, int M, int c2_real, int W,
                                    float* dA, float* dbc, float* wout, float* records,
                                    float* da_records, void* pbuf, int* pmap, int ctas,
                                    void* stream) {
  if (B < 0 || M < 0 || M % kCenters || W <= 0 || W > N || W >= (1 << 22) || c2_real <= 0 ||
      c2_real > C2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L;
  if (L.total > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  const int n_blk = M / kCenters, n_rec = B * n_blk;
  const size_t hit_bytes = (size_t)2 * n_blk * sizeof(int);
  if (hit_bytes > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  if (n_rec > 0 && (ctas <= 0 || ctas > n_rec)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (n_rec > 0) {  // (the kernel zeroes each block's dA record and its own record)
    err = cudaFuncSetAttribute(pool_bwd_compact_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L.total);
    if (err != cudaSuccess) return err;
    pool_bwd_compact_wide<<<ctas, kThreads, L.total, s>>>(
        static_cast<const uint16_t*>(A), static_cast<const uint16_t*>(bc), g, win, starts,
        static_cast<const uint16_t*>(w2), b2, s2, lb2, static_cast<const uint16_t*>(w3t), B, N,
        M, W, (float)c2_real, 1.f / (float)c2_real, dbc, records, da_records,
        static_cast<uint16_t*>(pbuf), pmap);
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
  reduce_records<8><<<(kRecord + 31) / 32, 256, 0, s>>>(records, n_rec > 0 ? ctas : 0, kRecord,
                                                         wout);
  return cudaGetLastError();
}

}  // extern "C"
