// Fused SA layer-0 prep forward at c1 from 257 to 512 (the width-4 backbone's
// SA2-4: c1 512 at in_dim 515 and 1027), in bf16 and in f32, on Hopper's
// tensor cores:
//   bf16:  A = LN(bf16(bf16([xyz/r ; f]) @ bf16(W1)) + bf16(b1))  ->  bf16
//   f32:   A = LN([xyz/r ; f] @ W1 + b1)                          ->  f32
//
// Replaces, at these widths, the TPU kernel eda_tpu/ops/pallas/sa_prep.py:
// _prep_fwd (body _fwd_kernel) at dtype bf16 ("K2", sa_prep_512_launch) and
// f32 ("K2f", sa_prep_f32_512_launch). The rounding points are those of
// csrc/sa_prep.cu (bf16: xyz / r as an IEEE division; the input and W1 in
// bf16; f32 sums of the products rounded once to bf16; + bf16(b1) rounded to
// bf16) and of csrc/sa_prep_f32.cu (f32: products as 3xTF32, wgmma.cuh, then
// + b1 in f32); the one-pass LayerNorm statistics over the c1 real channels
// (eps 1e-5) and scale and bias in f32, as both. The wrapper hands W1, b1,
// scale and lnb over zero-padded to 512 columns; a padded column of x is 0
// and adds nothing to the sums, which are divided by the real c1.
//
// Bound on this card: bytes in bf16 (per point (3 + C) f32 in, c1 bf16 out;
// 2 (3 + C) c1 flops a point, far below the bf16 peak), the products in f32
// (three TF32 products a true-f32 product, 165 TFLOP/s effective).
//
// Design: a cluster of two CTAs a 64-row tile (the wgmma M), CTA q owning
// columns 256 q .. + 255 of X, each of its two warpgroups 128 of them (an
// m64n128 accumulator, 64 registers a thread). K runs in chunks,
// double-buffered in shared memory: a chunk's points (xyz / r; bf16 in the
// core layout, or f32 rows padded to 36 floats) and the CTA's columns of its
// W1 rows (bf16: 16-byte cp.async copies into the core layout with rows = K,
// zero past in_dim, which wgmma reads MN-major; f32: split into TF32 hi / lo
// on the fly into two K-major core layouts). The next chunk's loads are
// issued while this chunk's products run. Each chunk's products go to a fresh
// accumulator, added into the running sum by the CUDA cores (IEEE, round to
// nearest): the tensor cores round their f32 sums toward zero, and over the
// 3 x 256 product groups of an f32 chunk stream at in_dim 2048 one
// accumulator lost up to ~4e-5 of a unit row (the f32 tolerance is 2e-5).
// W1 comes from L2 once per tile (1 MiB at in_dim 1027 in bf16, 2 MiB in
// f32): simple first, its time in PERF.md beside its bound. Each row's
// LayerNorm sums (the thread's columns, the quad's, then both CTAs' two
// warpgroups in order, through distributed shared memory) close the tile; the
// normalized values go straight from the accumulator layout to device memory.
//
// Shared memory of a CTA: bf16 2 x (16 KiB of points + 64 KiB of W1), f32 2
// x (9 KiB + 64 KiB); the vectors (3 KiB) and the LN sums (2 KiB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr int kCols = 512;               // c1, padded
constexpr int kCluster = 2;              // CTAs a tile, kHalf columns each
constexpr int kHalf = kCols / kCluster;
constexpr int kGroups = 2;               // warpgroups a CTA: 128 columns each
constexpr int kThreads = 128 * kGroups;
constexpr int kRows = 64;                // points a tile
constexpr int kKC = 128;                 // K of a bf16 chunk (eight k16 steps)
constexpr int kKF = 32;                  // K of an f32 chunk (four k8 steps)
constexpr int kPStride = kKF + 4;        // an f32 chunk's row of points, padded
constexpr float kEps = 1e-5f;
constexpr int kMaxInDim = 2048;          // the largest in_dim taken (the others' limit)
constexpr int kMaxSharedBytes = 232448;

// The shared buffers of a CTA: two chunks of its W1 columns (wb bytes
// each), two point chunks (pb each), its columns of bf16(b1) or b1, scale and
// lnb, and the LN sums of both CTAs' warpgroups ([rank][warpgroup][row]).
struct Layout {
  size_t pb, wb, w, p, prm, stats, total;
  __host__ __device__ explicit Layout(bool f32) {
    pb = f32 ? (size_t)kRows * kPStride * 4 : (size_t)kRows * kKC * 2;
    wb = f32 ? 2 * (size_t)kKF * kHalf * 4 : (size_t)kKC * kHalf * 2;
    size_t o = 0;
    w = o;     o += 2 * wb;
    p = o;     o += 2 * pb;
    prm = o;   o += (size_t)3 * kHalf * 4;
    stats = o; o += (size_t)kCluster * kGroups * kRows * 8;
    total = o;
  }
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

// Both CTAs' warpgroups' LN sums of row r, added in (rank, warpgroup) order.
__device__ __forceinline__ float2 row_sums(const float2* stats, int r) {
  float2 t = stats[r];
#pragma unroll
  for (int w = 1; w < kCluster * kGroups; ++w) {
    t.x += stats[w * kRows + r].x;
    t.y += stats[w * kRows + r].y;
  }
  return t;
}

template <bool F32>
__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kThreads, 1)
sa_prep_512(const float* __restrict__ pts, long long n_rows, int in_dim, int c1,
            const void* __restrict__ w1v, const float* __restrict__ b1,
            const float* __restrict__ scale, const float* __restrict__ lnb, float radius,
            void* __restrict__ outv) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(F32);
  const size_t pb = L.pb, wb = L.wb;
  const uint32_t base = smem_u32(smem);
  float* bs = reinterpret_cast<float*>(smem + L.prm);
  float* ss = bs + kHalf;
  float* ls = ss + kHalf;
  float2* stats = reinterpret_cast<float2*>(smem + L.stats);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp / 4, wq = warp % 4;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * wq + g;  // the thread's rows r0 and r0 + 8 of the tile
  const int n0 = 128 * wg;     // the warpgroup's first column of the CTA's
  const int rank = (int)cluster_rank();
  const int q0 = kHalf * rank;  // the CTA's first column of c1
  const long long row0 = (long long)blockIdx.x * kRows;
  const int KC = F32 ? kKF : kKC;
  const int nk = (in_dim + KC - 1) / KC;

  for (int c = tid; c < kHalf; c += kThreads) {
    bs[c] = F32 ? b1[q0 + c] : bf16_round(b1[q0 + c]);
    ss[c] = scale[q0 + c];
    ls[c] = lnb[q0 + c];
  }

  // chunk kc (K columns k0 .. k0 + KC - 1) into buffer `buf`
  const auto load = [&](int kc, int buf) {
    const int k0 = kc * KC;
    if constexpr (F32) {
      const float* w1 = static_cast<const float*>(w1v);
      // the CTA's columns of W1's rows k0 .. + 15 split into TF32 hi / lo: a
      // thread a (column n, 4 consecutive k) core row of each, neighbouring
      // threads on neighbouring columns
      const uint32_t bh = base + L.w + buf * wb, bl = bh + wb / 2;
#pragma unroll
      for (int j = 0; j < kHalf * (kKF / 4) / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int n = i % kHalf, kq = i / kHalf;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + 4 * kq + e;
          tf32_split(k < in_dim ? __ldg(w1 + (size_t)k * kCols + q0 + n) : 0.f, hi[e], lo[e]);
        }
        const uint32_t at = (((n >> 3) * (kKF / 4) + kq) * 32 + (n & 7) * 4) * 4;
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(bh + at), "r"(hi[0]),
                     "r"(hi[1]), "r"(hi[2]), "r"(hi[3]));
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(bl + at), "r"(lo[0]),
                     "r"(lo[1]), "r"(lo[2]), "r"(lo[3]));
      }
      // the points: 64 rows of 16 f32, xyz / r, zero past in_dim and n_rows
      float* ps = reinterpret_cast<float*>(smem + L.p + buf * pb);
#pragma unroll 1
      for (int i = tid; i < kRows * kKF; i += kThreads) {
        const int r = i / kKF, k = k0 + i % kKF;
        float v = row0 + r < n_rows && k < in_dim ? __ldg(pts + (row0 + r) * in_dim + k) : 0.f;
        if (k < 3) v = __fdiv_rn(v, radius);
        ps[r * kPStride + i % kKF] = v;
      }
    } else {
      const uint16_t* w1 = static_cast<const uint16_t*>(w1v);
      // the CTA's columns of W1's rows k0 .. + 63: a warp moves 8 rows of 4
      // cores (64 contiguous bytes a row from global, 512 to shared), zero
      // past in_dim
      const uint32_t wbuf = base + L.w + buf * wb;
#pragma unroll 1
      for (int j = 0; j < kKC * kHalf / 8 / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int kr = i & 7, q = (i >> 3) % (kHalf / 8), kb = (i >> 3) / (kHalf / 8);
        const int k = k0 + 8 * kb + kr;
        cp_async16_zfill(wbuf + ((kb * (kHalf / 8) + q) * 64 + kr * 8) * 2,
                         w1 + (size_t)(k < in_dim ? k : 0) * kCols + q0 + 8 * q, k < in_dim);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      // the points: a thread a 16-byte core row (8 K values of one row) as
      // bf16, neighbouring threads on neighbouring rows
      const uint32_t pbuf = base + L.p + buf * pb;
#pragma unroll 1
      for (int i = tid; i < kRows * (kKC / 8); i += kThreads) {
        const int r = i % kRows, kq = i / kRows;
        const bool live = row0 + r < n_rows;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = k0 + 8 * kq + e;
          v[e] = live && k < in_dim ? __ldg(pts + (row0 + r) * in_dim + k) : 0.f;
        }
        if (k0 + 8 * kq == 0) {  // xyz / r
#pragma unroll
          for (int e = 0; e < 3; ++e) v[e] = __fdiv_rn(v[e], radius);
        }
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         pbuf + 2 * core_at(r, 8 * kq, kKC)),
                     "r"(pack_bf16x2(v[0], v[1])), "r"(pack_bf16x2(v[2], v[3])),
                     "r"(pack_bf16x2(v[4], v[5])), "r"(pack_bf16x2(v[6], v[7])));
      }
    }
  };

  float acc[64], part[64];  // the running sum; a chunk's products
  load(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    fence_async();    // the chunk's shared stores are read by wgmma
    __syncthreads();  // chunk kc is whole; every warpgroup is done with chunk kc - 1
    wgmma_fence();
    if constexpr (F32) {
      const float* ps = reinterpret_cast<const float*>(smem + L.p + buf * pb);
      const uint32_t bh = base + L.w + buf * wb + (n0 / 8) * (kKF * 32), bl = bh + wb / 2;
#pragma unroll
      for (int s = 0; s < kKF / 8; ++s) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + 8 * (i & 1), k = 8 * s + t4 + 4 * (i >> 1);
          tf32_split(ps[r * kPStride + k], ah[i], al[i]);
        }
        wgmma_tf32x3<128>(part, ah, al, make_desc(bh + s * 256, 128, kKF * 32),
                          make_desc(bl + s * 256, 128, kKF * 32), s > 0);
      }
    } else {
      const uint32_t pbuf = base + L.p + buf * pb;
      const uint32_t wbuf = base + L.w + buf * wb + (n0 / 8) * 128;
#pragma unroll
      for (int s = 0; s < kKC / 16; ++s)
        wgmma_ss<128, 0, 1>(part, make_desc(pbuf + s * 256, 128, kKC * 16),
                            make_desc(wbuf + s * 2 * kHalf * 16, kHalf * 16, 128), s > 0);
    }
    wgmma_commit();
    if (kc + 1 < nk) load(kc + 1, buf ^ 1);  // while the products run
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = kc > 0 ? acc[i] + part[i] : part[i];
  }

  // x = X + b1 (bf16: bf16(bf16(X) + bf16(b1))); each row's LN sums
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int c = n0 + 8 * (i / 4) + 2 * t4 + (i & 1), h = (i >> 1) & 1;  // the CTA's column
    const float x = F32 ? acc[i] + bs[c] : bf16_round(bf16_round(acc[i]) + bs[c]);
    acc[i] = x;
    s1[h] += x;
    s2[h] += x * x;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], m);
      s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], m);
    }
  }
  if (t4 == 0) {  // into both CTAs' sums, at [rank][warpgroup]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t at = smem_u32(stats + (rank * kGroups + wg) * kRows + r0 + 8 * h);
#pragma unroll
      for (int d = 0; d < kCluster; ++d)
        asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(peer(at, d)),
                     "f"(s1[h]), "f"(s2[h])
                     : "memory");
    }
  }
  cluster_sync();  // both CTAs' sums have landed (no CTA touches a peer after it)
  float mean[2], rstd[2];
  const float cf = (float)c1, rc = 1.f / cf;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 t = row_sums(stats, r0 + 8 * h);
    if constexpr (F32) {  // csrc/sa_prep_f32.cu's ln_stats
      mean[h] = div_real(t.x, cf, rc);
      rstd[h] = 1.f / sqrtf(fmaxf(div_real(t.y, cf, rc) - mean[h] * mean[h], 0.f) + kEps);
    } else {              // csrc/sa_prep.cu's
      mean[h] = __fdiv_rn(t.x, cf);
      rstd[h] = rsqrtf(fmaxf(__fdiv_rn(t.y, cf) - mean[h] * mean[h], 0.f) + kEps);
    }
  }

  // the normalized values straight to device memory, columns below c1
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int cl = n0 + 8 * (i / 4) + 2 * t4, c = q0 + cl, h = (i >> 1) & 1;
    const long long row = row0 + r0 + 8 * h;
    if (row >= n_rows || c >= c1) continue;
    const float2 sc = *reinterpret_cast<const float2*>(ss + cl);
    const float2 lb = *reinterpret_cast<const float2*>(ls + cl);
    const float y0 = (acc[i] - mean[h]) * rstd[h] * sc.x + lb.x;
    const float y1 = (acc[i + 1] - mean[h]) * rstd[h] * sc.y + lb.y;
    if constexpr (F32) {
      float* o = static_cast<float*>(outv) + row * c1 + c;
      if (c + 1 < c1 && !(c1 & 1)) {
        *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
      } else {
        o[0] = y0;
        if (c + 1 < c1) o[1] = y1;
      }
    } else {
      uint16_t* o = static_cast<uint16_t*>(outv) + row * c1 + c;
      const uint32_t v = pack_bf16x2(y0, y1);
      if (c + 1 < c1 && !(c1 & 1)) {
        *reinterpret_cast<uint32_t*>(o) = v;
      } else {
        o[0] = uint16_t(v);
        if (c + 1 < c1) o[1] = uint16_t(v >> 16);
      }
    }
  }
}

template <bool F32>
int launch(const float* pts, long long n_rows, int in_dim, int c1, const void* w1,
           const float* b1, const float* scale, const float* lnb, float radius, void* out,
           void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (in_dim < 3 || in_dim > kMaxInDim || c1 < 1 || c1 > kCols) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorInvalidValue;  // the 16-byte copies of W1's rows; the paired stores
  const Layout L(F32);
  if (L.total > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  auto* kernel = sa_prep_512<F32>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  const long long tiles = (n_rows + kRows - 1) / kRows;
  kernel<<<dim3((unsigned)tiles, kCluster), kThreads, L.total,
           static_cast<cudaStream_t>(stream)>>>(pts, n_rows, in_dim, c1, w1, b1, scale, lnb,
                                                radius, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The widths the kernels take: c1 up to 512 (narrower layers than 257 run
// csrc/sa_prep.cu and csrc/sa_prep_f32.cu), in_dim 3 to 2048.
int sa_prep_512_max_in_dim(int c1) { return c1 < 1 || c1 > kCols ? 0 : kMaxInDim; }

// pts: (n_rows, in_dim) f32; w1: (in_dim, 512) bf16, zero past the real c1;
// b1/scale/lnb: (512,) f32, zero past c1; out: (n_rows, c1) bf16.
// Returns cudaGetLastError().
int sa_prep_512_launch(const float* pts, long long n_rows, int in_dim, int c1, const void* w1,
                       const float* b1, const float* scale, const float* lnb, float radius,
                       void* out, void* stream) {
  return launch<false>(pts, n_rows, in_dim, c1, w1, b1, scale, lnb, radius, out, stream);
}

// As sa_prep_512_launch in f32: w1 (in_dim, 512) f32; out (n_rows, c1) f32.
int sa_prep_f32_512_launch(const float* pts, long long n_rows, int in_dim, int c1,
                           const void* w1, const float* b1, const float* scale, const float* lnb,
                           float radius, void* out, void* stream) {
  return launch<true>(pts, n_rows, in_dim, c1, w1, b1, scale, lnb, radius, out, stream);
}

}  // extern "C"
