// Fused set-abstraction pair pool forward at (c1, c2, c3) = (512, 512, 1024),
// the width-4 backbone's SA2-4 (Group-Free-3D's Pointnet2Backbone(width=4)),
// on Hopper's tensor cores.
//
// Replaces, at these widths, the TPU kernel
// eda_tpu/ops/pallas/sa_kernel.py:sa_pair_pool_pallas (body _make_kernel, tile
// :262-382) without winner export (serving and evaluation) and with it
// (training, template WIN), under each radius test (d2_mode):
//   "pair"  sa_pair_pool_512_launch      ("K3"),  sa_pair_pool_512_winners_launch      ("K4")
//   "mxu"   sa_pair_pool_512_mxu_launch  ("K8"),  sa_pair_pool_512_mxu_winners_launch  ("K8w")
//   "pre"   sa_pair_pool_512_pre_launch  ("K9b"), sa_pair_pool_512_pre_winners_launch  ("K9bw")
// It computes csrc/sa_pair_pool.cu's function (see its note): per (center c,
// point p) pair of a block of 16 rank-sorted centers and its window
//   h0 = bf16(relu(f32(A_p) + f32(bc_c)))
//   h1 = bf16(relu(LN(h0 @ W2 + b2)))        f32 sums of bf16 products,
//                                            one-pass LN stats, eps 1e-5
//   z  = h1 @ W3 + b3                        f32 pre-activation
// and the output is the max over in-radius pairs of z, -1e9 where a center has
// no point of its window in range. The radius tests (template D2) and the
// padded variant (PAD: a narrower layer zero-padded to these widths divides
// its LN sums by the real c2) are that kernel's.
//
// Bound on this card: operations. A pair costs 2 (c1 c2 + c2 c3) = 1 572 864
// flops, 4x the width-2 backbone's; the bytes are A's windows, the weights
// and the (M, 1024) f32 output.
//
// Why a kernel of its own. W2 (512 KiB) and W3 (1 MiB) fit neither one CTA's
// 227 KB nor a portable cluster (8 CTAs would hold 192 KiB of weights each,
// beside a 64 KiB h1 block and the A rows), and a 64-row tile's X = h0 W2
// (64 x 512 f32) is 256 registers a thread for one warpgroup. So:
//   * W2 and W3 stream from L2 through a ring of four 32 KiB stages, one bulk
//     copy (TMA, 1D) a stage, issued by thread 0 as soon as every warp has
//     released the stage's last chunk (no producer warp: with 9 warps an SM
//     sub-partition holds 3, which caps a thread at 168 registers, fewer than
//     the 128 accumulators and the rest need without spilling). The wrapper lays the
//     weights out once a call in the order they are read (pack_xl in
//     ops/cuda/sa_kernel.py): W2, then W3 in four passes of 256 columns, each
//     matrix in the no-swizzle core layout with rows = K, which wgmma reads
//     as an MN-major B operand; a chunk (32 K rows of W2, 64 of a W3 pass) is
//     32 contiguous KiB. An item (a center and a 64-point tile of its window
//     with a pair in radius) reads 48 chunks: 16 of W2, 8 of each W3 pass.
//   * Two warpgroups share an item: GEMM1 X = h0 W2 (K = 512), each
//     warpgroup 256 of X's columns (one m64n256 accumulator, 128 registers);
//     each row's LN sums (sum, sum of squares, f32, one pass) over its 256
//     columns go through shared memory to the other warpgroup and are added
//     in warpgroup order; then GEMM2 z = h1 W3 in four passes of 256 columns,
//     each warpgroup 128 of them (one accumulator), folded into the lanes'
//     running max.
//   * h0 and h1 share one 64 x 512 bf16 buffer (the K-major A operand of both
//     products): h0 = relu(A + bc_c) is written by all threads from A's rows
//     (16-byte loads, 64 contiguous bytes a row, rows past the window's end
//     zero); h1 overwrites it once both warpgroups' GEMM1 products are done.
//   * The radius test runs once per stage of up to 1024 window points, into
//     16 x (points / 32) bits; a (center, 64-point) tile with no pair in
//     radius is no item (exact: it leaves the max unchanged). Every item
//     reads the same 48 chunks, so a stage's chunk sequence follows from its
//     count of items. A center's running max (16 values a lane) waits in
//     shared memory across its tiles (in registers it pushed the 255-register
//     threads into spilling); at its end the 4 warps of a warpgroup combine,
//     a column a thread, with the earlier
//     stages' partial read back from the output by the thread that wrote it;
//     b3 is added after the max (x -> x + b3 is monotone).
// Each weight byte is read from L2 once per item, 1.5 MiB for 64 pair rows:
// the kernel is simple first, and its time stands in PERF.md beside its bound.
// Shared memory of a CTA, 226 816 bytes (one CTA an SM):
//     weight ring  4 x 32 KiB              131 072
//     h0 / h1      64 x 512 bf16            65 536
//     bits         16 x 32 words             2 048
//     b2, s2, lb2, b3                       10 240
//     LN sums      2 x 64 x 8                1 024
//     partials     2 x 4 passes x 4 warps
//                  x 128 x 4               16 384
//     centers, barriers                        512
//
// Winner export (WIN): the tie rule of csrc/sa_pair_pool.cu (its note): the
// window cut in tiles of wc = min(128, W) points, the last of equal maxima
// inside a tile, the earlier tile across tiles, as the total order on (value,
// rank q = (nt-1-tile)*wc + (p mod wc)) that every combine here takes: the
// fold of a warp's 16 rows, the running max across a center's 64-point items
// (which are not the rule's 128-point tiles: the order needs no alignment
// between them), the 4 warps at a center's end and the earlier stages'
// partial read back from the output. The two warpgroups own disjoint
// columns, so no combine crosses them. The running max's ranks (16 KiB) take
// the room of one ring stage: the ring has three (98 304 bytes; 210 432 in
// all), and the winners kernels keep the 255-register budget of the others
// (the rank of a row is formed in the fold, from the tile's row).

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr int C1 = 512, C2 = 512, C3 = 1024;
constexpr int kCenters = 16;                     // centers per CTA (the window block)
constexpr int kRows = 64;                        // window points per GEMM tile
constexpr int kGroups = 2;                       // warpgroups
constexpr int kThreads = 128 * kGroups;
constexpr int kXCols = 256;                      // a warpgroup's columns of X
constexpr int kZCols = 128;                      // a warpgroup's columns of a GEMM2 pass
constexpr int kPassCols = kGroups * kZCols;      // GEMM2 columns a pass: 256
constexpr int kPasses = C3 / kPassCols;          // 4
constexpr int kChunkBytes = 32768;               // a weight chunk
constexpr int kK1 = kChunkBytes / (C2 * 2);      // K rows of a W2 chunk (all 512 columns): 32
constexpr int kK2 = kChunkBytes / (kPassCols * 2);  // K rows of a W3 chunk (a pass's columns): 64
constexpr int kChunks1 = C1 / kK1;               // 16
constexpr int kChunks2 = C2 / kK2;               // 8 a pass
constexpr int kItemChunks = kChunks1 + kPasses * kChunks2;  // 48
// ring stages: three with winner export, whose ranks take a stage's room
__host__ __device__ constexpr int ring_stages(bool win) { return win ? 3 : 4; }
constexpr int kStagePts = 1024;                  // window points of a radius-test stage
constexpr int kWords = kStagePts / 32;
constexpr float kEps = 1e-5f;
constexpr float kNeg = -1e9f;
constexpr uint32_t kMinusInfBits = 0xff800000u;  // -inf: the max of no value
constexpr int kMaxSharedBytes = 232448;
static_assert(C2 == C1 && kChunks2 * kK2 == C2, "GEMM2's K runs over the h buffer");

struct Layout {
  size_t ring, h, bits, prm, stats, part, part_q, cen, bar, total;
  __host__ __device__ explicit Layout(bool win) {
    size_t o = 0;
    ring = o;  o += (size_t)ring_stages(win) * kChunkBytes;
    h = o;     o += (size_t)kRows * C1 * 2;
    bits = o;  o += (size_t)kCenters * kWords * 4;
    prm = o;   o += (size_t)(3 * C2 + C3) * 4;
    stats = o; o += (size_t)kGroups * kRows * 8;
    part = o;  o += (size_t)kGroups * kPasses * 4 * kZCols * 4;
    part_q = o; o += win ? (size_t)kGroups * kPasses * 4 * kZCols * 4 : 0;
    cen = o;   o += 384;
    bar = o;   o += 128;
    total = o;
  }
};

enum D2 { kPair, kMxu, kPre };

__device__ __forceinline__ void mbar_init_n(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A descriptor built where it is used (its address opaque), so that a
// product's descriptors are not computed ahead and held in registers.
__device__ __forceinline__ uint64_t desc_at(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return make_desc(opaque(addr), lbo, sbo);
}

#define EDA_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 256, f32) (+)= A (64 x 16, K-major) @ B (16 x 256, MN-major), both
// bf16 in shared memory: one accumulator of 128 registers a thread, d[4j + e]
// row g (e < 2) or g + 8, column 8j + 2t + e % 2 (as wgmma_ss in wgmma.cuh).
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : EDA_D8(0), EDA_D8(8), EDA_D8(16), EDA_D8(24), EDA_D8(32), EDA_D8(40), EDA_D8(48),
        EDA_D8(56), EDA_D8(64), EDA_D8(72), EDA_D8(80), EDA_D8(88), EDA_D8(96), EDA_D8(104),
        EDA_D8(112), EDA_D8(120)
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef EDA_D8

// Two floats of shared memory at `addr`, and 32 bits stored there, in program
// order with the other volatile accesses. The LN loops over a thread's 128
// accumulator values address them from one opaque base plus a constant a
// column pair, so that no address or vector is computed ahead and held.
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// One step of the transposing butterfly max: lanes whose bit `m` is clear keep
// the first n/2 values, the others the last n/2, each the max with lane ^ m's.
template <int n>
__device__ __forceinline__ void max_step(float* v, int m, bool up) {
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const float send = up ? v[i] : v[i + n / 2];
    const float keep = up ? v[i + n / 2] : v[i];
    v[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, m));
  }
}

// The max over a warp's 16 rows of one 32-column block of an accumulator
// (16 values a thread: rows g, g + 8, columns 8j + 2t4 + e), the rows masked
// by in0 / in1; afterwards lane l holds column 8 (i / 2) + 2 t4 + i % 2 with
// i = 4 [l & 16] + 2 [l & 8] + [l & 4].
__device__ __forceinline__ float fold32(const float* acc, bool in0, bool in1, int lane) {
  const float none = __uint_as_float(kMinusInfBits);
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = i / 2, e = i % 2;
    v[i] = fmaxf(in0 ? acc[4 * j + e] : none, in1 ? acc[4 * j + 2 + e] : none);
  }
  max_step<8>(v, 16, lane & 16);
  max_step<4>(v, 8, lane & 8);
  max_step<2>(v, 4, lane & 4);
  return v[0];
}

// The larger of (va, qa) and (vb, qb) under the tie rule's total order: the
// larger value, then the larger rank q.
__device__ __forceinline__ void combine(float& va, int& qa, float vb, int qb) {
  const bool take = vb > va || (vb == va && qb > qa);
  va = take ? vb : va;
  qa = take ? qb : qa;
}

// max_step carrying each value's rank, combined in the total order.
template <int n>
__device__ __forceinline__ void max_step_q(float* v, int* q, int m, bool up) {
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const float send_v = up ? v[i] : v[i + n / 2];
    const int send_q = up ? q[i] : q[i + n / 2];
    float keep_v = up ? v[i + n / 2] : v[i];
    int keep_q = up ? q[i + n / 2] : q[i];
    combine(keep_v, keep_q, __shfl_xor_sync(0xffffffffu, send_v, m),
            __shfl_xor_sync(0xffffffffu, send_q, m));
    v[i] = keep_v;
    q[i] = keep_q;
  }
}

// fold32 with winner export: rows g and g + 8 carry ranks q0 and q1; returns
// the lane's value and sets its rank.
__device__ __forceinline__ float fold32_q(const float* acc, bool in0, bool in1, int q0, int q1,
                                          int lane, int& q_out) {
  const float none = __uint_as_float(kMinusInfBits);
  float v[8];
  int q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = i / 2, e = i % 2;
    v[i] = in0 ? acc[4 * j + e] : none;
    q[i] = q0;
    combine(v[i], q[i], in1 ? acc[4 * j + 2 + e] : none, q1);
  }
  max_step_q<8>(v, q, 16, lane & 16);
  max_step_q<4>(v, q, 8, lane & 8);
  max_step_q<2>(v, q, 4, lane & 4);
  q_out = q[0];
  return v[0];
}

// The weight ring: chunk n of a stage (48 an item, item after item) lands in
// ring stage n % kRing, counted by its mbarrier full; every warp arrives on
// empty once its products are done with it, and thread 0 then copies chunk n
// + kRing into the stage. Plain inline members, not lambdas: a lambda called
// from several places may become a call, and its saved registers a spill.
template <int kRing>
struct Ring {
  uint32_t ring, full0, empty0;
  const uint16_t* wpack;
  uint32_t n;           // chunks consumed so far (the same in every thread)
  uint32_t stage0, end; // the stage's first chunk, and one past its last

  // chunk m into its stage (thread 0)
  __device__ __forceinline__ void issue(uint32_t m) const {
    const uint32_t s = m % kRing;
    bulk_copy(ring + s * kChunkBytes,
              wpack + (size_t)((m - stage0) % kItemChunks) * (kChunkBytes / 2), kChunkBytes,
              full0 + 8 * s);
  }
  // a stage of `items` items from chunk n on: thread 0 fills the free ring
  __device__ __forceinline__ void begin(int items, int tid) {
    stage0 = n;
    end = n + (uint32_t)items * kItemChunks;
    if (tid == 0)
      for (uint32_t m = n; m < end && m < n + kRing; ++m) issue(m);
  }
  // waits for chunk n; returns its address
  __device__ __forceinline__ uint32_t wait() const {
    const uint32_t s = n % kRing;
    bulk_wait(full0 + 8 * s, (n / kRing) & 1);
    return ring + s * kChunkBytes;
  }
  // the warp is done with chunk m (after wgmma_wait); thread 0, once every
  // warp is, copies chunk m + kRing into its stage
  __device__ __forceinline__ void release(uint32_t m, int tid, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (m % kRing));
    if (tid == 0 && m + kRing < end) {
      bulk_wait(empty0 + 8 * (m % kRing), (m / kRing) & 1);
      issue(m + kRing);
    }
  }
};

template <int D2, bool PAD, bool WIN>
__global__ void __launch_bounds__(kThreads, 1)
sa_pair_pool_512(const uint16_t* __restrict__ A, const float* __restrict__ xyz,
                 const uint16_t* __restrict__ bc, const float* __restrict__ cen,
                 const uint8_t* __restrict__ mask, const int* __restrict__ starts,
                 const uint16_t* __restrict__ wpack, const float* __restrict__ b2,
                 const float* __restrict__ s2, const float* __restrict__ lb2,
                 const float* __restrict__ b3, int N, int M, int W, float c2, float rc2,
                 float r2, float* __restrict__ out, int* __restrict__ winners) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRing = ring_stages(WIN);
  const Layout L(WIN);
  const uint32_t base = smem_u32(smem);
  const uint32_t h_base = base + L.h;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L.bits);  // [center][kWords]
  float* b2s = reinterpret_cast<float*>(smem + L.prm);
  float* s2s = b2s + C2;
  float* lb2s = s2s + C2;
  float* b3s = lb2s + C2;
  float2* stats = reinterpret_cast<float2*>(smem + L.stats);  // [warpgroup][row]
  float* part = reinterpret_cast<float*>(smem + L.part);  // [warpgroup][pass][warp][128]
  int* part_q = reinterpret_cast<int*>(smem + L.part_q);  // their ranks (WIN)
  float* cens = reinterpret_cast<float*>(smem + L.cen);       // [center][4], then o
  // per ring stage: its chunk landed (full), every warp has read it (empty)
  const uint32_t full0 = base + L.bar, empty0 = full0 + 8 * kRing;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int n_blocks = M / kCenters;
  const int m0 = blockIdx.x * kCenters;
  int start = starts[(size_t)b * n_blocks + blockIdx.x];
  start = min(max(start, 0), N - W);  // keeps every window read inside the cloud
  const int wc = W < 128 ? W : 128;   // the tie rule's tiles (WIN)
  const int nt = (W + wc - 1) / wc;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init_n(full0 + 8 * s, 1);
      mbar_init_n(empty0 + 8 * s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < C2; i += kThreads) {
    b2s[i] = b2[i];
    s2s[i] = s2[i];
    lb2s[i] = lb2[i];
  }
  for (int i = tid; i < C3; i += kThreads) b3s[i] = b3[i];
  // kPair: the center; kMxu: c' = c - o and csq, o after the 16 centers
  if (D2 != kPre && tid < kCenters) {
    const float* cp = cen + ((size_t)b * M + m0 + tid) * 3;
    float cx = cp[0], cy = cp[1], cz = cp[2], csq = 0.f;
    if constexpr (D2 == kMxu) {
      const float* op = cen + ((size_t)b * M + m0) * 3;  // the block's first center
      cx -= op[0];
      cy -= op[1];
      cz -= op[2];
      csq = cx * cx + cy * cy + cz * cz;
      if (tid == 0) {
        cens[kCenters * 4] = op[0];
        cens[kCenters * 4 + 1] = op[1];
        cens[kCenters * 4 + 2] = op[2];
      }
    }
    cens[tid * 4] = cx;
    cens[tid * 4 + 1] = cy;
    cens[tid * 4 + 2] = cz;
    cens[tid * 4 + 3] = csq;
  }
  __syncthreads();

  const int stages = (W + kStagePts - 1) / kStagePts;
  Ring<kRing> rg{base + (uint32_t)L.ring, full0, empty0, wpack, 0u, 0u, 0u};
  for (int st = 0; st < stages; ++st) {
    const int s0 = st * kStagePts;  // the stage's first window point
    const int sw = min(kStagePts, W - s0);
    const int tiles = (sw + kRows - 1) / kRows;
    const int nwords = 2 * tiles;
    if (st > 0) __syncthreads();  // every warp is done with the last stage's bits and chunks

    // ---- the radius test of every (center, stage point), as bits
    for (int wi = warp; wi < nwords; wi += kThreads / 32) {
      const int p = s0 + wi * 32 + lane;
      const bool valid = p < W;
      if constexpr (D2 == kPre) {
        const uint8_t* m_win = mask + ((size_t)b * n_blocks + blockIdx.x) * W * kCenters;
        const uint4 row = valid ? *reinterpret_cast<const uint4*>(m_win + (size_t)p * kCenters)
                                : make_uint4(0, 0, 0, 0);
        const uint32_t w[4] = {row.x, row.y, row.z, row.w};
#pragma unroll
        for (int c = 0; c < kCenters; ++c) {
          const bool in = valid && ((w[c / 4] >> (8 * (c % 4))) & 0xffu) != 0;
          const uint32_t word = __ballot_sync(0xffffffffu, in);
          if (lane == 0) bits[c * kWords + wi] = word;
        }
      } else {
        const float* xp = xyz + ((size_t)b * N + start + (valid ? p : 0)) * 3;
        const float x = xp[0], y = xp[1], z = xp[2];
        float px = 0.f, py = 0.f, pz = 0.f, psq = 0.f;
        if constexpr (D2 == kMxu) {
          px = x - cens[kCenters * 4];
          py = y - cens[kCenters * 4 + 1];
          pz = z - cens[kCenters * 4 + 2];
          psq = px * px + py * py + pz * pz;
        }
#pragma unroll
        for (int c = 0; c < kCenters; ++c) {
          const float cx = cens[c * 4], cy = cens[c * 4 + 1], cz = cens[c * 4 + 2];
          bool in;
          if constexpr (D2 == kMxu) {
            const float pc =
                (-2.f * px) * cx + (-2.f * py) * cy + (-2.f * pz) * cz + cens[c * 4 + 3];
            in = pc <= r2 - psq;
          } else {
            const float dx = x - cx, dy = y - cy, dz = z - cz;
            in = dx * dx + dy * dy + dz * dz <= r2;
          }
          const uint32_t word = __ballot_sync(0xffffffffu, valid && in);
          if (lane == 0) bits[c * kWords + wi] = word;
        }
      }
    }
    __syncthreads();

    // ---- the stage's chunks: 48 an item, item after item; thread 0 keeps the
    // ring full, each chunk's copy issued once every warp released its stage
    int items = 0;
    for (int i = 0; i < kCenters * tiles; ++i)
      items += (bits[(i / tiles) * kWords + 2 * (i % tiles)] |
                bits[(i / tiles) * kWords + 2 * (i % tiles) + 1]) != 0;
    rg.begin(items, tid);

    // ---- warpgroup wg computes X's columns 256 wg .. + 255 and each GEMM2
    // pass's 128 wg .. + 127
    const int wg = tid / 128, wt = tid % 128;
    const int wq = wt / 32;                 // warp of the warpgroup: tile rows 16 wq ..
    const int g = lane / 4, t4 = lane % 4;  // the thread's rows r0, r0 + 8; columns 2 t4 (+1)
    const int r0 = 16 * wq + g;
    const int base_i = ((lane & 16) ? 4 : 0) + ((lane & 8) ? 2 : 0) + ((lane & 4) ? 1 : 0);
    const int fold_col = 8 * (base_i / 2) + 2 * t4 + base_i % 2;  // within a 32-column block

    // X (the warpgroup's columns 256 wg .. + 255) = h0 (the h buffer, 64 x
    // 512, K-major) W2, over 16 chunks of 32 K rows
    const auto gemm1 = [&](float (&acc)[128]) {
#pragma unroll 1
      for (int ch = 0; ch < kChunks1; ++ch, ++rg.n) {
        const uint32_t wb = rg.wait() + (kXCols * wg / 8) * 128;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kK1 / 16; ++k)
          wgmma_ss_n256(acc, desc_at(h_base + (kK1 / 16 * ch + k) * 256, 128, C1 * 16),
                        desc_at(wb + k * 16 * C2 * 2, C2 * 16, 128), ch > 0 || k > 0);
        wgmma_commit();
        if (ch > 0) {
          wgmma_wait<1>();
          rg.release(rg.n - 1, tid, lane);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      rg.release(rg.n - 1, tid, lane);
    };
    // z (the warpgroup's 128 columns of a pass) = h1 (the h buffer) W3's pass,
    // over 8 chunks of 64 K rows
    const auto gemm2 = [&](float (&acc)[64]) {
#pragma unroll 1
      for (int ch = 0; ch < kChunks2; ++ch, ++rg.n) {
        const uint32_t wb = rg.wait() + (kZCols * wg / 8) * 128;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kK2 / 16; ++k)
          wgmma_ss<128, 0, 1>(acc, desc_at(h_base + (kK2 / 16 * ch + k) * 256, 128, C1 * 16),
                              desc_at(wb + k * 16 * kPassCols * 2, kPassCols * 16, 128),
                              ch > 0 || k > 0);
        wgmma_commit();
        if (ch > 0) {
          wgmma_wait<1>();
          rg.release(rg.n - 1, tid, lane);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      rg.release(rg.n - 1, tid, lane);
    };

    // the warp's running max of a center, [pass][128 columns], a lane's
    // columns 32 k + fold_col (k < 4) its own
    float* mine = part + (wg * kPasses * 4 + wq) * kZCols;
    int* mine_q = part_q + (wg * kPasses * 4 + wq) * kZCols;
    for (int c = 0; c < kCenters; ++c) {
#pragma unroll
      for (int i = 0; i < kPasses * 4; ++i) {
        mine[(i / 4) * 4 * kZCols + 32 * (i % 4) + fold_col] = __uint_as_float(kMinusInfBits);
        if constexpr (WIN) mine_q[(i / 4) * 4 * kZCols + 32 * (i % 4) + fold_col] = 0;
      }
      const uint16_t* bcp = bc + ((size_t)b * M + m0 + c) * C1;

      for (int t = 0; t < tiles; ++t) {
        const uint32_t lo = bits[c * kWords + 2 * t], hi = bits[c * kWords + 2 * t + 1];
        if ((lo | hi) == 0) continue;  // no pair of the tile in radius
        const uint32_t word = wq < 2 ? lo : hi;
        const int sh = r0 & 31;
        const bool in0 = (word >> sh) & 1u, in1 = (word >> (sh + 8)) & 1u;

        // 1. h0 = relu(A + bc_c) into the h buffer once both warpgroups' last
        // products are done with it: a warp moves 8 rows of 4 cores; a
        // thread adds bc_c's chunks (tid / 8) and + 32
        __syncthreads();
        const int p0 = s0 + t * kRows;
        const uint32_t h0_at = opaque(h_base + (((tid >> 3) * 64) + (tid & 7) * 8) * 2);
#pragma unroll 4
        for (int n = 0; n < 16; ++n) {
          const int r = 8 * (n >> 1) + (tid & 7), q = (tid >> 3) + 32 * (n & 1);
          const int p = p0 + r;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (p < W) {
            const uint4 a =
                __ldg(reinterpret_cast<const uint4*>(A + ((size_t)b * N + start + p) * C1 + 8 * q));
            const uint4 cb = __ldg(reinterpret_cast<const uint4*>(bcp + 8 * q));
            v = make_uint4(add_relu_bf16x2(a.x, cb.x), add_relu_bf16x2(a.y, cb.y),
                           add_relu_bf16x2(a.z, cb.z), add_relu_bf16x2(a.w, cb.w));
          }
          // core (r / 8, q) of the K-major h buffer
          const uint32_t dst = h0_at + ((n >> 1) * (C1 / 8) + 32 * (n & 1)) * 128;
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x),
                       "r"(v.y), "r"(v.z), "r"(v.w));
        }
        fence_async();  // h0 is read by wgmma, through the async proxy
        __syncthreads();

        {
          // 2. X = h0 W2 over the warpgroup's 256 columns
          float x[128];
          gemm1(x);

          // 3. each row's LN sums: the thread's columns, the quad's, then the
          // other warpgroup's, added in warpgroup order
          // the thread's first column pair of b2, s2, lb2 and of h1's rows r0 and r0 + 8
          const uint32_t vec = opaque(smem_u32(b2s + kXCols * wg + 2 * t4));
          const uint32_t hrow = opaque(
              h_base + (((r0 >> 3) * (C1 / 8) + kXCols * wg / 8) * 64 + (r0 & 7) * 8 + 2 * t4) * 2);
          float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float2 bias = lds2(vec + 32 * j);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float z = x[4 * j + e] + (e % 2 ? bias.y : bias.x);
              x[4 * j + e] = z;
              sum[e / 2] += z;
              sq[e / 2] = __fmaf_rn(z, z, sq[e / 2]);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
            sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
            sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
            sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
          }
          if (t4 == 0) {
            stats[wg * kRows + r0] = make_float2(sum[0], sq[0]);
            stats[wg * kRows + r0 + 8] = make_float2(sum[1], sq[1]);
          }
          __syncthreads();  // both warpgroups' sums, and both GEMM1s done with h0
          float mean_r[2], rstd[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 u = stats[r0 + 8 * h], v = stats[kRows + r0 + 8 * h];
            const float s = u.x + v.x, q = u.y + v.y;
            const float mean = PAD ? div_real(s, c2, rc2) : s * (1.f / C2);
            const float var =
                fmaxf((PAD ? div_real(q, c2, rc2) : q * (1.f / C2)) - mean * mean, 0.f);
            rstd[h] = rsqrtf(var + kEps);
            mean_r[h] = -mean * rstd[h];
          }

          // 4. h1 = bf16(relu(LN)) over h0 in the h buffer
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float2 sc = lds2(vec + 4 * C2 + 32 * j), sf = lds2(vec + 8 * C2 + 32 * j);
            float y[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float xn = __fmaf_rn(x[4 * j + e], rstd[e / 2], mean_r[e / 2]);
              y[e] = fmaxf(__fmaf_rn(xn, e % 2 ? sc.y : sc.x, e % 2 ? sf.y : sf.x), 0.f);
            }
            sts32(hrow + 128 * j, pack_bf16x2(y[0], y[1]));          // row r0
            sts32(hrow + 8192 + 128 * j, pack_bf16x2(y[2], y[3]));   // row r0 + 8
          }
        }
        fence_async();
        __syncthreads();

        // 5. z = h1 W3 in passes of 256 columns, the warpgroup's 128 of each
        // folded into the running max
#pragma unroll 1
        for (int ps = 0; ps < kPasses; ++ps) {
          float z[64];
          gemm2(z);
          if constexpr (WIN) {
            // the ranks of the thread's rows r0 and r0 + 8 (window points p0, p0 + 8)
            const int p0 = s0 + t * kRows + r0, p1 = p0 + 8;
            const int q0 = (nt - 1 - p0 / wc) * wc + p0 % wc;
            const int q1 = (nt - 1 - p1 / wc) * wc + p1 % wc;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int at = ps * 4 * kZCols + 32 * k + fold_col;
              int qn;
              const float vn = fold32_q(z + 16 * k, in0, in1, q0, q1, lane, qn);
              float mv = mine[at];
              int mq = mine_q[at];
              combine(mv, mq, vn, qn);
              mine[at] = mv;
              mine_q[at] = mq;
            }
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float* m = mine + ps * 4 * kZCols + 32 * k + fold_col;
              *m = fmaxf(*m, fold32(z + 16 * k, in0, in1, lane));
            }
          }
        }
      }

      // the center: the 4 warps' partials, a column a thread and pass; the
      // earlier stages' partial from the output; b3 and -1e9 at the last stage
      bar_sync(2 + wg, 128);
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        const float* ours = part + (wg * kPasses + ps) * 4 * kZCols;
        const int* ours_q = part_q + (wg * kPasses + ps) * 4 * kZCols;
        float v = ours[wt];
        int q = WIN ? ours_q[wt] : 0;
#pragma unroll
        for (int w = 1; w < 4; ++w) {
          if constexpr (WIN)
            combine(v, q, ours[w * kZCols + wt], ours_q[w * kZCols + wt]);
          else
            v = fmaxf(v, ours[w * kZCols + wt]);
        }
        const int col = kPassCols * ps + kZCols * wg + wt;
        const size_t o = ((size_t)b * M + m0 + c) * C3 + col;
        if (st > 0) {  // the same thread wrote (out, winners)[o] at the last stage
          if constexpr (WIN)
            combine(v, q, out[o], winners[o]);
          else
            v = fmaxf(v, out[o]);
        }
        if (st + 1 < stages) {
          out[o] = v;
          if constexpr (WIN) winners[o] = q;
        } else {
          const float zmax = v + b3s[col];
          const bool hit = zmax > kNeg;
          out[o] = hit ? zmax : kNeg;
          if constexpr (WIN) winners[o] = hit ? start + (nt - 1 - q / wc) * wc + q % wc : 0;
        }
      }
      bar_sync(2 + wg, 128);  // the partials are rewritten next
    }
  }
}

template <int D2, bool PAD, bool WIN>
cudaError_t launch(const uint16_t* A, const float* xyz, const uint16_t* bc, const float* cen,
                   const uint8_t* mask, const int* starts, const uint16_t* wpack,
                   const float* b2, const float* s2, const float* lb2, const float* b3, int B,
                   int N, int M, int W, int c2_real, float r2, float* out, int* winners,
                   cudaStream_t s) {
  const Layout L(WIN);
  if (L.total > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  auto* kernel = sa_pair_pool_512<D2, PAD, WIN>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  dim3 grid(M / kCenters, B);
  kernel<<<grid, kThreads, L.total, s>>>(A, xyz, bc, cen, mask, starts, wpack, b2, s2, lb2, b3,
                                         N, M, W, (float)c2_real, 1.f / (float)c2_real, r2, out,
                                         winners);
  return cudaGetLastError();
}

template <int D2, bool WIN>
int dispatch(const void* A, const float* xyz, const void* bc, const float* cen,
             const uint8_t* mask, const int* starts, const void* wpack, const float* b2,
             const float* s2, const float* lb2, const float* b3, int B, int N, int M,
             int c2_real, int W, float r2, float* out, int* winners, void* stream) {
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (M % kCenters || W <= 0 || W > N || c2_real <= 0 || c2_real > C2)
    return cudaErrorInvalidValue;
  // the 16-byte loads of A's rows and bc's, and the bulk copies of the weights
  if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(bc) |
       reinterpret_cast<uintptr_t>(wpack)) & 15)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint16_t*>(A);
  const auto* bcv = static_cast<const uint16_t*>(bc);
  const auto* wp = static_cast<const uint16_t*>(wpack);
  return c2_real == C2
             ? launch<D2, false, WIN>(a, xyz, bcv, cen, mask, starts, wp, b2, s2, lb2, b3, B, N,
                                      M, W, c2_real, r2, out, winners, s)
             : launch<D2, true, WIN>(a, xyz, bcv, cen, mask, starts, wp, b2, s2, lb2, b3, B, N,
                                     M, W, c2_real, r2, out, winners, s);
}

}  // namespace

extern "C" {

// A: (B, N, 512) bf16; xyz: (B, N, 3) f32; bc: (B, M, 512) bf16; cen: (B, M, 3)
// f32; starts: (B, M/16) int32 window starts (multiples of 16, clamped to
// [0, N-W]); wpack: W2 (512, 512) and W3 (512, 1024) bf16 as ops/cuda/
// sa_kernel.py:pack_xl lays them out (3 x 512 x 512 values); b2/s2/lb2:
// (512,) f32; b3: (1024,) f32; out: (B, M, 1024) f32. A narrower layer comes
// zero-padded to these widths and c2_real <= 512 is its real interior width,
// the LayerNorm's divisor. Any window 0 < W <= N. Returns cudaGetLastError().
int sa_pair_pool_512_launch(const void* A, const float* xyz, const void* bc, const float* cen,
                            const int* starts, const void* wpack, const float* b2,
                            const float* s2, const float* lb2, const float* b3, int B, int N,
                            int M, int c2_real, int W, float r2, float* out, void* stream) {
  return dispatch<kPair, false>(A, xyz, bc, cen, nullptr, starts, wpack, b2, s2, lb2, b3, B,
                                N, M, c2_real, W, r2, out, nullptr, stream);
}

// As sa_pair_pool_512_launch with the expansion-formula radius test ("mxu").
int sa_pair_pool_512_mxu_launch(const void* A, const float* xyz, const void* bc,
                                const float* cen, const int* starts, const void* wpack,
                                const float* b2, const float* s2, const float* lb2,
                                const float* b3, int B, int N, int M, int c2_real, int W,
                                float r2, float* out, void* stream) {
  return dispatch<kMxu, false>(A, xyz, bc, cen, nullptr, starts, wpack, b2, s2, lb2, b3, B, N,
                               M, c2_real, W, r2, out, nullptr, stream);
}

// As sa_pair_pool_512_launch with the radius test read from mask ("pre"):
// (B, M/16, W, 16) uint8, row w of block j the window point starts[j] + w
// (csrc/sa_mask.cu). No coordinates and no radius.
int sa_pair_pool_512_pre_launch(const void* A, const void* bc, const uint8_t* mask,
                                const int* starts, const void* wpack, const float* b2,
                                const float* s2, const float* lb2, const float* b3, int B,
                                int N, int M, int c2_real, int W, float* out, void* stream) {
  return dispatch<kPre, false>(A, nullptr, bc, nullptr, mask, starts, wpack, b2, s2, lb2, b3, B,
                               N, M, c2_real, W, 0.f, out, nullptr, stream);
}

// The winners variants (training): as the launchers above, and winners
// (B, M, 1024) int32, the global rank of each pooled value's point under the
// tie rule, 0 where no pair was in radius.
int sa_pair_pool_512_winners_launch(const void* A, const float* xyz, const void* bc,
                                    const float* cen, const int* starts, const void* wpack,
                                    const float* b2, const float* s2, const float* lb2,
                                    const float* b3, int B, int N, int M, int c2_real, int W,
                                    float r2, float* out, int* winners, void* stream) {
  return dispatch<kPair, true>(A, xyz, bc, cen, nullptr, starts, wpack, b2, s2, lb2, b3, B, N,
                               M, c2_real, W, r2, out, winners, stream);
}

int sa_pair_pool_512_mxu_winners_launch(const void* A, const float* xyz, const void* bc,
                                        const float* cen, const int* starts, const void* wpack,
                                        const float* b2, const float* s2, const float* lb2,
                                        const float* b3, int B, int N, int M, int c2_real, int W,
                                        float r2, float* out, int* winners, void* stream) {
  return dispatch<kMxu, true>(A, xyz, bc, cen, nullptr, starts, wpack, b2, s2, lb2, b3, B, N, M,
                              c2_real, W, r2, out, winners, stream);
}

int sa_pair_pool_512_pre_winners_launch(const void* A, const void* bc, const uint8_t* mask,
                                        const int* starts, const void* wpack, const float* b2,
                                        const float* s2, const float* lb2, const float* b3,
                                        int B, int N, int M, int c2_real, int W, float* out,
                                        int* winners, void* stream) {
  return dispatch<kPre, true>(A, nullptr, bc, nullptr, mask, starts, wpack, b2, s2, lb2, b3, B,
                              N, M, c2_real, W, 0.f, out, winners, stream);
}

}  // extern "C"
