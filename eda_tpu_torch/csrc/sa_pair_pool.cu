// Fused set-abstraction pair pool forward on Hopper's tensor cores.
//
// Replaces the TPU kernel eda_tpu/ops/pallas/sa_kernel.py:sa_pair_pool_pallas
// (body _make_kernel, tile :262-382) under each radius test (d2_mode), without
// winner export (serving) and with it (training):
//   "pair"  sa_pair_pool_launch ("K3"), sa_pair_pool_winners_launch ("K4")
//   "mxu"   sa_pair_pool_mxu_launch ("K8"), sa_pair_pool_mxu_winners_launch ("K8w")
//   "pre"   sa_pair_pool_pre_launch ("K9b"), sa_pair_pool_pre_winners_launch ("K9bw")
//
// One CTA per (batch row, block of 16 rank-sorted centers). The block pairs
// with the W points of its window, which starts at a multiple of 16. For every
// (center c, point p) pair:
//   h0 = bf16(relu(f32(A_p) + f32(bc_c)))
//   h1 = bf16(relu(LN(h0 @ W2 + b2)))        f32 sums of bf16 products,
//                                            one-pass LN stats, eps 1e-5
//   z  = h1 @ W3 + b3                        f32 pre-activation
// and the output is the max over in-radius pairs of z, -1e9 where a center has
// no point of its window in range. The radius test (f32, never contracted into
// an FMA: the build passes --fmad=false) is the template parameter D2:
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
// Bound on this card: operations. A pair costs 2*(c1*c2 + c2*c3) flops (SA1
// 24.6 K, SA2-4 98.3 K). The windows the kernel computes hold 773 GFLOP per
// batch-8 forward of the flagship model (0.78 ms at 989 TFLOP/s of dense bf16
// tensor cores); the in-radius pairs alone, 12.7% of them, need 0.099 ms. The
// bytes are A's windows (mostly L2 hits: neighbouring blocks' windows overlap),
// the weights once per CTA and the (M, c3) output.
//
// Design. Both products run as wgmma (bf16 in, f32 sums) on 64-row tiles:
// GEMM row r of a tile is window point 64*k + r of ONE center, so the masked
// max is a reduction over rows inside one center and the winner's position is
// the row. The CTA has three warpgroups; each takes every third center and
// walks its window chunk by chunk, so that one warpgroup's CUDA-core work runs
// while another's products are on the tensor cores (three beat two by 7-16%,
// PERF.md; four would leave 128 registers a thread, fewer than the widest
// kernels use).
//   * Shared memory holds for the CTA's life W2 and W3, transposed into the
//     K-major no-swizzle core-matrix layout the wgmma descriptors read (8x8
//     bf16 cores, 128 bytes each; a thread gathers the 8 k-values of one
//     16-byte core row, so the global reads coalesce and the stores do not
//     conflict), and the LN and bias vectors. The A window (x c1 bf16, 16-byte
//     chunks XOR-swizzled by row so that ldmatrix is conflict-free) comes in
//     stages of as many 64-row tiles as the rest of the 227 KB leaves room for,
//     with the in-radius bits of every (center, point) of the stage. At the
//     flagship model's windows a stage is the whole window (SA1 1024 rows, 128
//     KB; SA2-4 256 rows), so A is read once per CTA. A wider window (W = N on
//     the dense path, or the wide sa_windows settings) runs in several equal
//     stages: each center's partial max and winner rank wait in the output
//     buffers, read back and combined by the same thread in the next stage, so
//     any W runs; the next stage's loads do not overlap this stage's products.
//   * The radius test runs once per stage, into 16 x rows bits (one ballot
//     per 32 points and center). A (center, 64-point) tile whose 64
//     bits are all 0 leaves the max unchanged, so both of its products are
//     skipped: exact, and one shared load decides for the whole warpgroup. On
//     the flagship model's data 62% / 46% / 34% / 29% of the tiles of SA1-4
//     are skipped (PERF.md).
//   * GEMM1 takes A from registers: the A rows come by ldmatrix in the m64k16
//     fragment layout, get bc_c added and relu'd as bf16x2 (add.rn.bf16x2 of
//     two bf16 values is the f32 sum rounded once, as the reference rounds).
//   * LN in the accumulator: a row's c2 channels lie in the 4 threads of a
//     quad, so each statistic is a sum in the thread and two shfl_xor. h1 is
//     then packed from the f32 accumulator layout straight into the bf16
//     A-register fragments of GEMM2 (the accumulator's n8 blocks 2s and 2s+1
//     are k-slice s), so h1 never touches shared memory.
//   * GEMM2 runs in passes of 64 columns into two accumulators in turn: the
//     tensor cores compute pass h + 1 while pass h is masked and maxed. b3 is
//     added after the max: x -> x + b3 is monotone, so the max is the same.
//   * The max over a tile's 64 rows: a thread's two rows combine, then a
//     transposing butterfly over the 8 lanes of a column group (xor 16, 8, 4)
//     halves the values each step, so 16 values a pass take 14 shuffles and
//     each lane keeps a running max of 2 (value, position) pairs per pass
//     across the chunks. At the end of a center the 4 warps' partials combine
//     through shared memory.
//   * Widths: the kernels are instantiated for the model's four (c1, c2, c3)
//     triples. A narrower layer comes zero-padded to the next one by the
//     wrapper (zero channels add nothing to any sum, and zero s2 and lb2 keep
//     h1 at 0 past c2); its variant (PAD) divides the LN sums by the real c2,
//     a correctly rounded quotient (div_real), where the unpadded kernels
//     multiply by 1/C2, exactly, C2 being a power of two.

// Winner export (WIN): the TPU kernel's tie rule (sa_kernel.py:357-382) cuts
// the window in tiles of wc = min(128, W) points; inside a tile the LAST of
// equal maxima wins, across tiles the earlier tile keeps a tie. The reduction
// here runs in no window order, so every combine takes the larger of two
// (value, position) pairs under the total order that rule defines: the larger
// value, then the smaller wc-tile, then the larger position. That order is
// associative, so any reduction tree finds the same winner. A position is
// carried as its rank q = (nt-1-tile)*wc + (p mod wc), larger is better. A
// center with no in-radius point exports global rank 0; the output is the
// winner's global rank, window start + position.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr int kWarpgroups = 3;  // centers taken in turn: 6 / 5 / 5 of the 16
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kCenters = 16;  // centers per CTA (the window block)
constexpr int kRows = 64;     // window points per GEMM tile
constexpr int kPassCols = 64; // GEMM2 columns per pass (32 accumulators a thread)
constexpr float kEps = 1e-5f;
constexpr float kNeg = -1e9f;
constexpr int kMaxSharedBytes = 232448;
constexpr uint32_t kMinusInfBits = 0xff800000u;  // -inf: the max of no value

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Shared memory carve-up, in bytes, shared by the kernel and the launcher.
// rows: the window points of one stage, a multiple of 64.
struct Layout {
  size_t a, w2, w3, part, bits, prm, cen, total;
  __host__ __device__ Layout(int c1, int c2, int c3, int rows, bool win) {
    size_t o = 0;
    a = o;    o += align128((size_t)rows * c1 * 2);
    w2 = o;   o += align128((size_t)c1 * c2 * 2);
    w3 = o;   o += align128((size_t)c2 * c3 * 2);
    part = o; o += align128((size_t)2 * kWarpgroups * 4 * c3 * (win ? 8 : 4));
    bits = o; o += align128((size_t)kCenters * (rows / 32) * 4);
    prm = o;  o += align128((size_t)(3 * c2 + c3) * 4);
    cen = o;  o += align128((size_t)(kCenters + 1) * 4 * 4);
    total = o;
  }
};

enum D2 { kPair, kMxu, kPre };

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

#define EDA_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x N, f32) (+)= A (64 x 16, bf16 registers) @ B (16 x N, bf16 shared).
// d holds the thread's N/2 accumulator values: d[4j + e] is row g, column
// 8j + 2t + e, and d[4j + 2 + e] row g + 8 (g = lane / 4, t = lane % 4, rows
// counted from 16 * warp).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : EDA_D8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : EDA_D8(0), EDA_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : EDA_D8(0), EDA_D8(8), EDA_D8(16), EDA_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  } else {
    static_assert(N == 128, "wgmma widths");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : EDA_D8(0), EDA_D8(8), EDA_D8(16), EDA_D8(24), EDA_D8(32), EDA_D8(40), EDA_D8(48),
          EDA_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
}
#undef EDA_D8

// The larger of (va, qa) and (vb, qb): the larger value, then the larger q.
template <bool WIN>
__device__ __forceinline__ void combine(float& va, int& qa, float vb, int qb) {
  if constexpr (WIN) {
    const bool take = vb > va || (vb == va && qb > qa);
    va = take ? vb : va;
    qa = take ? qb : qa;
  } else {
    va = fmaxf(va, vb);
  }
}

// One step of the transposing butterfly: lanes whose bit `m` is clear keep the
// first n/2 values and send the rest to lane ^ m, the others keep the last
// n/2; afterwards v[i] (i < n/2) holds the combine of both lanes' value i + (up
// ? n/2 : 0).
template <int n, bool WIN>
__device__ __forceinline__ void reduce_step(float* v, int* q, int m, bool up) {
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const float send_v = up ? v[i] : v[i + n / 2];
    float keep_v = up ? v[i + n / 2] : v[i];
    const float got_v = __shfl_xor_sync(0xffffffffu, send_v, m);
    int keep_q = 0, got_q = 0;
    if constexpr (WIN) {
      const int send_q = up ? q[i] : q[i + n / 2];
      keep_q = up ? q[i + n / 2] : q[i];
      got_q = __shfl_xor_sync(0xffffffffu, send_q, m);
    }
    combine<WIN>(keep_v, keep_q, got_v, got_q);
    v[i] = keep_v;
    if constexpr (WIN) q[i] = keep_q;
  }
}

// LN of the tile's rows over their c2 real channels of C2 (a row's channels
// lie in the 4 threads of a quad: two shuffles per statistic), relu and bf16,
// packed as GEMM2's A fragments: the accumulator's n8 blocks 2s and 2s+1 are
// k-slice s. Padding channels (zero W2 columns, b2, s2, lb2) come out 0.
template <int C2, bool PAD>
__device__ __forceinline__ void ln_fragments(float (&acc)[C2 / 2], const float* b2s,
                                             const float* s2s, const float* lb2s, int t4,
                                             float c2, float rc2, uint32_t (&hf)[C2 / 16][4]) {
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < C2 / 8; ++j) {
    const float2 bias = *reinterpret_cast<const float2*>(b2s + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float z = acc[4 * j + e] + (e % 2 ? bias.y : bias.x);
      acc[4 * j + e] = z;
      sum[e / 2] += z;
      sq[e / 2] = __fmaf_rn(z, z, sq[e / 2]);
    }
  }
  float mean_r[2], rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
    sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
    const float mean = PAD ? div_real(sum[h], c2, rc2) : sum[h] * (1.f / C2);
    const float var = fmaxf((PAD ? div_real(sq[h], c2, rc2) : sq[h] * (1.f / C2)) - mean * mean,
                            0.f);
    rstd[h] = rsqrtf(var + kEps);
    mean_r[h] = -mean * rstd[h];
  }
#pragma unroll
  for (int j = 0; j < C2 / 8; ++j) {
    const float2 sc = *reinterpret_cast<const float2*>(s2s + 8 * j + 2 * t4);
    const float2 sh = *reinterpret_cast<const float2*>(lb2s + 8 * j + 2 * t4);
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xn = __fmaf_rn(acc[4 * j + e], rstd[e / 2], mean_r[e / 2]);
      y[e] = fmaxf(__fmaf_rn(xn, e % 2 ? sc.y : sc.x, e % 2 ? sh.y : sh.x), 0.f);
    }
    // n8 block j is half (j % 2) of k-slice j / 2: registers 0, 1 or 2, 3
    hf[j / 2][2 * (j % 2)] = pack_bf16x2(y[0], y[1]);
    hf[j / 2][2 * (j % 2) + 1] = pack_bf16x2(y[2], y[3]);
  }
}

// One GEMM2 pass of a tile folded into the lane's running max: the thread's
// two rows (masked by in0, in1) combine, the transposing butterfly over the
// column group's 8 lanes leaves NV / 8 values a lane, and those fold into
// run_v / run_q.
template <int NV, bool WIN>
__device__ __forceinline__ void fold_max(const float* acc, bool in0, bool in1, int q0, int q1,
                                         int lane, float* run_v, int* run_q) {
  const float none = __uint_as_float(kMinusInfBits);
  float v[NV];
  int q[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i / 2, e = i % 2;
    v[i] = in0 ? acc[4 * j + e] : none;
    q[i] = q0;
    combine<WIN>(v[i], q[i], in1 ? acc[4 * j + 2 + e] : none, q1);
  }
  reduce_step<NV, WIN>(v, q, 16, lane & 16);
  reduce_step<NV / 2, WIN>(v, q, 8, lane & 8);
  reduce_step<NV / 4, WIN>(v, q, 4, lane & 4);
#pragma unroll
  for (int i = 0; i < NV / 8; ++i) combine<WIN>(run_v[i], run_q[i], v[i], q[i]);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int C1, int C2, int C3, bool WIN, int D2, bool PAD>
__global__ void __launch_bounds__(kThreads, 1)
sa_pair_pool_kernel(const uint16_t* __restrict__ A, const float* __restrict__ xyz,
                    const uint16_t* __restrict__ bc, const float* __restrict__ cen,
                    const uint8_t* __restrict__ mask, const int* __restrict__ starts,
                    const uint16_t* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ s2, const float* __restrict__ lb2,
                    const uint16_t* __restrict__ w3, const float* __restrict__ b3, int N,
                    int M, int W, int rows, float c2, float rc2, float r2,
                    float* __restrict__ out,
                    int* __restrict__ winners) {
  constexpr int NP = C3 < kPassCols ? C3 : kPassCols;  // GEMM2 columns per pass
  constexpr int PASSES = C3 / NP;
  constexpr int NV = NP / 4;               // a thread's values of a pass, per row pair
  constexpr int NR = NV / 8;               // a lane's values after the row reduction
  constexpr int NK1 = C1 / 16;             // k16 steps of GEMM1
  static_assert(NR >= 1 && C3 % NP == 0 && C1 % 16 == 0 && C2 % 16 == 0, "widths");

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(C1, C2, C3, rows, WIN);
  uint16_t* w2s = reinterpret_cast<uint16_t*>(smem + L.w2);
  uint16_t* w3s = reinterpret_cast<uint16_t*>(smem + L.w3);
  float* part_v = reinterpret_cast<float*>(smem + L.part);         // [buf][wg][warp][C3]
  int* part_q = reinterpret_cast<int*>(part_v + 2 * kWarpgroups * 4 * C3);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + L.bits);     // [center][rows / 32]
  float* b2s = reinterpret_cast<float*>(smem + L.prm);
  float* s2s = b2s + C2;
  float* lb2s = s2s + C2;
  float* b3s = lb2s + C2;
  float* cens = reinterpret_cast<float*>(smem + L.cen);  // [center][4], then o

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int n_blocks = M / kCenters;
  const int m0 = blockIdx.x * kCenters;
  int start = starts[(size_t)b * n_blocks + blockIdx.x];
  start = min(max(start, 0), N - W);  // keeps every window read inside the cloud
  constexpr int kc = C1 / 8;          // 16-byte chunks of an A row
  constexpr int swz = (kc < 8 ? kc : 8) - 1;  // chunk c of row r lies at c ^ (r & swz)
  const uint32_t a_smem = smem_u32(smem + L.a);

  const int wg = tid / 128, wt = tid % 128;
  const int wq = wt / 32;                 // warp of the warpgroup: tile rows 16 wq ..
  const int g = lane / 4, t4 = lane % 4;  // the thread's rows g, g + 8; columns 2 t4 (+1)
  const int wc = W < 128 ? W : 128;
  const int nt = (W + wc - 1) / wc;
  const uint32_t w2_base = smem_u32(w2s), w3_base = smem_u32(w3s);
  constexpr uint32_t sbo1 = C1 * 16, sbo2 = C2 * 16;
  // ldmatrix: lanes 0-7 / 8-15 / 16-23 / 24-31 address rows 0-7 / 8-15 / 0-7 /
  // 8-15 of the warp's 16, k-chunks 2s / 2s / 2s+1 / 2s+1
  const int ld_row = 16 * wq + (lane & 7) + (lane & 8);
  const int ld_chunk = lane >> 4;
  // after the butterfly, lane value i is the pass's value base_i + i
  const int base_i = ((lane & 16) ? NV / 2 : 0) + ((lane & 8) ? NV / 4 : 0) +
                     ((lane & 4) ? NV / 8 : 0);
  const int stages = (W + rows - 1) / rows;
  int buf = 0;
  for (int st = 0; st < stages; ++st) {
    const int s0 = st * rows;  // the stage's first window point
    const int sw = min(rows, W - s0);
    const int swp = (sw + kRows - 1) / kRows * kRows;
    if (st > 0) __syncthreads();  // every warpgroup is done with the last stage

    // 1. the stage's A rows, asynchronously; rows past the window end are zeros
    {
      const uint16_t* a_win = A + ((size_t)b * N + start + s0) * C1;
      for (int i = tid; i < swp * kc; i += kThreads) {
        const int r = i / kc, ch = i % kc;
        const uint32_t dst = a_smem + r * C1 * 2 + ((ch ^ (r & swz)) << 4);
        if (r < sw) {
          cp_async16(dst, a_win + (size_t)r * C1 + ch * 8);
        } else {
          asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst), "r"(0u));
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    // the first stage: weights, vectors and centers, while A is on its way
    if (st == 0) {
      stage_kmajor<kThreads>(w2s, w2, C1, C2);
      stage_kmajor<kThreads>(w3s, w3, C2, C3);
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
    }

    // 2. the radius test of every (center, stage point), as bits
    const int nwords = swp / 32;
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
          if (lane == 0) bits[c * nwords + wi] = word;
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
          if (lane == 0) bits[c * nwords + wi] = word;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // the staged weights are read by wgmma, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // 3. per warpgroup: every third center, the stage in 64-row tiles
    for (int c = wg; c < kCenters; c += kWarpgroups, buf ^= 1) {
      uint32_t bcf[NK1][2];  // bc_c at columns 16 s + 2 t4 (+1) and + 8
      const uint16_t* bcp = bc + ((size_t)b * M + m0 + c) * C1 + 2 * t4;
#pragma unroll
      for (int s = 0; s < NK1; ++s) {
        bcf[s][0] = *reinterpret_cast<const uint32_t*>(bcp + 16 * s);
        bcf[s][1] = *reinterpret_cast<const uint32_t*>(bcp + 16 * s + 8);
      }
      float run_v[PASSES * NR];
      int run_q[PASSES * NR];
#pragma unroll
      for (int i = 0; i < PASSES * NR; ++i) {
        run_v[i] = __uint_as_float(kMinusInfBits);
        run_q[i] = 0;
      }

      for (int k = 0; k < swp / kRows; ++k) {
        const uint32_t lo = bits[c * nwords + 2 * k], hi = bits[c * nwords + 2 * k + 1];
        if ((lo | hi) == 0) continue;  // no pair of the tile in radius
        const uint32_t word = wq < 2 ? lo : hi;
        const int sh = (16 * wq + g) & 31;
        const bool in0 = (word >> sh) & 1u, in1 = (word >> (sh + 8)) & 1u;
        int q0 = 0, q1 = 0;
        if constexpr (WIN) {
          const int p0 = s0 + k * kRows + 16 * wq + g, p1 = p0 + 8;
          q0 = (nt - 1 - p0 / wc) * wc + p0 % wc;
          q1 = (nt - 1 - p1 / wc) * wc + p1 % wc;
        }

        // h0 = relu(A + bc) as GEMM1's register A operand
        uint32_t af[NK1][4];
        const int row = k * kRows + ld_row;
#pragma unroll
        for (int s = 0; s < NK1; ++s) {
          const int ch = 2 * s + ld_chunk;
          ldmatrix_x4(af[s], a_smem + row * C1 * 2 + ((ch ^ (row & swz)) << 4));
#pragma unroll
          for (int i = 0; i < 4; ++i) af[s][i] = add_relu_bf16x2(af[s][i], bcf[s][i >> 1]);
        }
        float acc1[C2 / 2];
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < NK1; ++s)
          wgmma_rs<C2>(acc1, af[s], make_desc(w2_base + 256 * s, 128, sbo1), s > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc1);
#pragma unroll
        for (int s = 0; s < NK1; ++s) fence_regs(af[s]);

        uint32_t hf[C2 / 16][4];
        ln_fragments<C2, PAD>(acc1, b2s, s2s, lb2s, t4, c2, rc2, hf);

        // z = h1 @ W3 in passes of NP columns into two accumulators in turn:
        // the tensor cores run pass h + 1 while pass h is masked and maxed
        float acc2[2][NP / 2];
        auto start_pass = [&](float (&acc)[NP / 2], int h) {
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < C2 / 16; ++s)
            wgmma_rs<NP>(acc, hf[s],
                         make_desc(w3_base + h * (NP / 8) * sbo2 + 256 * s, 128, sbo2), s > 0);
          wgmma_commit();
        };
        start_pass(acc2[0], 0);
        if (PASSES > 1) start_pass(acc2[1], 1);
#pragma unroll
        for (int h = 0; h < PASSES; ++h) {
          float(&acc)[NP / 2] = acc2[h % 2];
          if (h + 1 < PASSES) {
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          fence_regs(acc);
          fold_max<NV, WIN>(acc, in0, in1, q0, q1, lane, run_v + h * NR, run_q + h * NR);
          if (h + 2 < PASSES) start_pass(acc, h + 2);
        }
#pragma unroll
        for (int s = 0; s < C2 / 16; ++s) fence_regs(hf[s]);
      }

      // the 4 warps' partials through shared memory; then the earlier stages'
      // partial from the output buffers, and b3 and the output at the last stage
      const size_t pbase = ((size_t)buf * kWarpgroups + wg) * 4;
#pragma unroll
      for (int h = 0; h < PASSES; ++h) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int ii = base_i + i;
          const int col = h * NP + 8 * (ii / 2) + 2 * t4 + ii % 2;
          part_v[(pbase + wq) * C3 + col] = run_v[h * NR + i];
          if constexpr (WIN) part_q[(pbase + wq) * C3 + col] = run_q[h * NR + i];
        }
      }
      bar_sync(1 + wg, 128);
      for (int col = wt; col < C3; col += 128) {
        float v = part_v[pbase * C3 + col];
        int q = WIN ? part_q[pbase * C3 + col] : 0;
#pragma unroll
        for (int w = 1; w < 4; ++w)
          combine<WIN>(v, q, part_v[(pbase + w) * C3 + col],
                       WIN ? part_q[(pbase + w) * C3 + col] : 0);
        const size_t o = ((size_t)b * M + m0 + c) * C3 + col;
        // the same thread wrote (out, winners)[o] at the last stage
        if (st > 0) combine<WIN>(v, q, out[o], WIN ? winners[o] : 0);
        if (st + 1 < stages) {
          out[o] = v;
          if constexpr (WIN) winners[o] = q;
          continue;
        }
        const float zmax = v + b3s[col];
        const bool hit = zmax > kNeg;
        out[o] = hit ? zmax : kNeg;
        if constexpr (WIN) {
          const int p = (nt - 1 - q / wc) * wc + q % wc;
          winners[o] = hit ? start + p : 0;
        }
      }
    }
  }
}

template <int C1, int C2, int C3, bool WIN, int D2, bool PAD>
cudaError_t launch(const uint16_t* A, const float* xyz, const uint16_t* bc,
                   const float* cen, const uint8_t* mask, const int* starts,
                   const uint16_t* w2, const float* b2, const float* s2, const float* lb2,
                   const uint16_t* w3, const float* b3, int B, int N, int M, int W,
                   int c2_real, float r2, float* out, int* winners, cudaStream_t s) {
  // the window in equal stages of whole 64-row tiles, as few as shared memory allows
  const int tiles = (W + kRows - 1) / kRows;
  int most = min(tiles, kMaxSharedBytes / (kRows * C1 * 2));
  while (most > 1 && Layout(C1, C2, C3, most * kRows, WIN).total > (size_t)kMaxSharedBytes)
    --most;
  const int stages = (tiles + most - 1) / most;
  const int rows = (tiles + stages - 1) / stages * kRows;
  const Layout L(C1, C2, C3, rows, WIN);
  if (L.total > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sa_pair_pool_kernel<C1, C2, C3, WIN, D2, PAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return err;
  dim3 grid(M / kCenters, B);
  sa_pair_pool_kernel<C1, C2, C3, WIN, D2, PAD><<<grid, kThreads, L.total, s>>>(
      A, xyz, bc, cen, mask, starts, w2, b2, s2, lb2, w3, b3, N, M, W, rows,
      (float)c2_real, 1.f / (float)c2_real, r2, out, winners);
  return cudaGetLastError();
}

template <bool WIN, int D2>
int dispatch(const void* A, const float* xyz, const void* bc, const float* cen,
             const uint8_t* mask, const int* starts, const void* w2, const float* b2,
             const float* s2, const float* lb2, const void* w3, const float* b3, int B,
             int N, int M, int c1, int c2, int c3, int c2_real, int W, float r2, float* out,
             int* winners, void* stream) {
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (M % kCenters || W <= 0 || W > N || c2_real <= 0 || c2_real > c2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint16_t*>(A);
  const auto* bcv = static_cast<const uint16_t*>(bc);
  const auto* w2v = static_cast<const uint16_t*>(w2);
  const auto* w3v = static_cast<const uint16_t*>(w3);
  // a layer padded to (c1, c2, c3) divides its LayerNorm sums by its real c2
#define EDA_SA_LAUNCH(X, Y, Z)                                                              \
  if (c1 == X && c2 == Y && c3 == Z)                                                        \
    return c2_real == c2                                                                    \
               ? launch<X, Y, Z, WIN, D2, false>(a, xyz, bcv, cen, mask, starts, w2v, b2, s2, \
                                                 lb2, w3v, b3, B, N, M, W, c2_real, r2, out, \
                                                 winners, s)                               \
               : launch<X, Y, Z, WIN, D2, true>(a, xyz, bcv, cen, mask, starts, w2v, b2, s2,  \
                                                lb2, w3v, b3, B, N, M, W, c2_real, r2, out,  \
                                                winners, s);
  EDA_SA_LAUNCH(16, 16, 32)
  EDA_SA_LAUNCH(32, 32, 64)
  EDA_SA_LAUNCH(64, 64, 128)
  EDA_SA_LAUNCH(128, 128, 256)
#undef EDA_SA_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// A: (B, N, c1) bf16; xyz: (B, N, 3) f32; bc: (B, M, c1) bf16; cen: (B, M, 3)
// f32; starts: (B, M/16) int32 window starts (multiples of 16, clamped to
// [0, N-W]); w2: (c1, c2) bf16; b2/s2/lb2: (c2,) f32; w3: (c2, c3) bf16;
// b3: (c3,) f32; out: (B, M, c3) f32. (c1, c2, c3) must be one of (16, 16,
// 32), (32, 32, 64), (64, 64, 128), (128, 128, 256), the model's layer widths;
// narrower layers come zero-padded to one of them (zero W2 and W3 rows and
// columns, zero b2, s2, lb2 and b3 past the real widths) and c2_real <= c2 is
// the real interior width, the LayerNorm's divisor. Any window 0 < W <= N.
// Returns cudaGetLastError().
int sa_pair_pool_launch(const void* A, const float* xyz, const void* bc,
                        const float* cen, const int* starts, const void* w2,
                        const float* b2, const float* s2, const float* lb2,
                        const void* w3, const float* b3, int B, int N, int M,
                        int c1, int c2, int c3, int c2_real, int W, float r2, float* out,
                        void* stream) {
  return dispatch<false, kPair>(A, xyz, bc, cen, nullptr, starts, w2, b2, s2, lb2, w3, b3,
                                B, N, M, c1, c2, c3, c2_real, W, r2, out, nullptr, stream);
}

// As sa_pair_pool_launch, plus winners: (B, M, c3) int32 global rank of the
// point whose pair gave each pooled value (0 where out is -1e9).
int sa_pair_pool_winners_launch(const void* A, const float* xyz, const void* bc,
                                const float* cen, const int* starts, const void* w2,
                                const float* b2, const float* s2, const float* lb2,
                                const void* w3, const float* b3, int B, int N, int M,
                                int c1, int c2, int c3, int c2_real, int W, float r2, float* out,
                                int* winners, void* stream) {
  return dispatch<true, kPair>(A, xyz, bc, cen, nullptr, starts, w2, b2, s2, lb2, w3, b3,
                               B, N, M, c1, c2, c3, c2_real, W, r2, out, winners, stream);
}

// As sa_pair_pool_launch with the expansion-formula radius test ("mxu").
int sa_pair_pool_mxu_launch(const void* A, const float* xyz, const void* bc,
                            const float* cen, const int* starts, const void* w2,
                            const float* b2, const float* s2, const float* lb2,
                            const void* w3, const float* b3, int B, int N, int M,
                            int c1, int c2, int c3, int c2_real, int W, float r2, float* out,
                            void* stream) {
  return dispatch<false, kMxu>(A, xyz, bc, cen, nullptr, starts, w2, b2, s2, lb2, w3, b3,
                               B, N, M, c1, c2, c3, c2_real, W, r2, out, nullptr, stream);
}

int sa_pair_pool_mxu_winners_launch(const void* A, const float* xyz, const void* bc,
                                    const float* cen, const int* starts, const void* w2,
                                    const float* b2, const float* s2, const float* lb2,
                                    const void* w3, const float* b3, int B, int N, int M,
                                    int c1, int c2, int c3, int c2_real, int W, float r2,
                                    float* out, int* winners, void* stream) {
  return dispatch<true, kMxu>(A, xyz, bc, cen, nullptr, starts, w2, b2, s2, lb2, w3, b3,
                              B, N, M, c1, c2, c3, c2_real, W, r2, out, winners, stream);
}

// As sa_pair_pool_launch with the radius test read from mask ("pre"):
// (B, M/16, W, 16) uint8, row w of block j the window point starts[j] + w
// (csrc/sa_mask.cu). No coordinates and no radius.
int sa_pair_pool_pre_launch(const void* A, const void* bc, const uint8_t* mask,
                            const int* starts, const void* w2, const float* b2,
                            const float* s2, const float* lb2, const void* w3,
                            const float* b3, int B, int N, int M, int c1, int c2, int c3,
                            int c2_real, int W, float* out, void* stream) {
  return dispatch<false, kPre>(A, nullptr, bc, nullptr, mask, starts, w2, b2, s2, lb2, w3,
                               b3, B, N, M, c1, c2, c3, c2_real, W, 0.f, out, nullptr, stream);
}

int sa_pair_pool_pre_winners_launch(const void* A, const void* bc, const uint8_t* mask,
                                    const int* starts, const void* w2, const float* b2,
                                    const float* s2, const float* lb2, const void* w3,
                                    const float* b3, int B, int N, int M, int c1, int c2,
                                    int c3, int c2_real, int W, float* out, int* winners,
                                    void* stream) {
  return dispatch<true, kPre>(A, nullptr, bc, nullptr, mask, starts, w2, b2, s2, lb2, w3,
                              b3, B, N, M, c1, c2, c3, c2_real, W, 0.f, out, winners, stream);
}

}  // extern "C"
