// Furthest point sampling on Hopper.
//
// Replaces the TPU kernel eda_tpu/ops/pallas/fps.py:furthest_point_sample_pallas
// (body _fps_kernel). Index 0 is picked first; each of the M - 1 further steps
// folds the distance to the last pick into a running min-distance per point
// and picks the point whose min-distance is largest (the lowest index on ties).
//
// Bound on this card: the steps are serial. The work is ~12 instructions per
// point and step (0.15 GFLOP per 8192-point row at M = 2048, ~2 us at the f32
// peak), but each step needs the previous step's pick, so the time is the
// latency of M - 1 steps: the points' update, an argmax over the row and the
// broadcast of the pick's coordinates. An operations bound cannot be reached
// by a serial loop; what the design can do is shorten each step.
//
// Design. One row per cluster of C CTAs (thread block clusters, C in 1, 2, 4,
// 8; fps_cluster_size picks 8 from 1024 points up, else 1), which spreads
// the row's points over C SMs. Together the cluster has at most 32 warps, so
// a step has at most 32 candidates.
//   * Each thread keeps its P points' x, y, z and min-distance in registers
//     for the whole loop (P <= 8, N <= 8192: SA1's 8192-point presample is 8
//     points a thread over 1024 threads); a step reads no memory but the
//     candidates.
//   * A warp reduces its threads' best with __reduce_max_sync on an ordered
//     integer key and __reduce_min_sync on the index among the maxima; its
//     lanes 0..C-1 write (key, index, x, y, z) into the warp's slot in every
//     CTA of the cluster (the coordinates come from the CTA's shared copy of
//     its points).
//   * One barrier a step, on double-buffered slots: __syncthreads in a CTA
//     alone; in a cluster, the slot buffer's mbarrier, which st.async (data
//     and completion in one message) fills with the C W candidates' bytes.
//     Then every warp reduces the slots itself and takes the winner's
//     coordinates with a shuffle: no second barrier and no broadcast of the
//     pick. A buffer is written again two steps later, which no CTA reaches
//     before every warp has sent the step in between, that is, has read the
//     buffer.
//   * Clouds of more than 8192 points run a variant that keeps the
//     min-distances in a global scratch row and reads the coordinates through
//     L1 (in clusters of 8 too).
//
// Bit-exactness: the file is compiled with --fmad=false, so
// d = (dx*dx + dy*dy) + dz*dz rounds exactly like the plain PyTorch version.
// Padding points (|p|^2 <= 1e-3) start with min-distance -1, which min() keeps
// forever: the plain version's score for an invalid point. An all-padding row
// therefore picks index 0 at every step, as the plain version does.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;  // threads of a cluster: 32 candidate slots
constexpr int kSlots = 32;
constexpr int kRegPoints = 8;      // points a thread in registers, at most
constexpr int kMaxRegN = kMaxThreads * kRegPoints;
constexpr float kPadGuard = 1e-3f;
constexpr float kBig = 1e10f;

struct __align__(16) Slot {
  int key, idx;
  float x, y, z, pad[3];
};

// A float as an int that orders like the float, -inf lowest.
__device__ __forceinline__ int ordered(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ unsigned cluster_rank() { return blockIdx.x; }

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A CTA's two slot barriers, one a buffer: each phase completes when the
// CTA's own expect_tx arrival is in and the C W candidates' bytes have landed.
constexpr int kSlotBytes = 20;  // key, index, x, y, z

__device__ __forceinline__ void init_slot_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bars[b])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Send a candidate into slot `slot` of CTA `rank` of the cluster, counted by
// that CTA's barrier `bar` (st.async: the data and its completion in one
// message, no round trip).
__device__ __forceinline__ void send_slot(Slot* slot, uint64_t* bar, unsigned rank, int key,
                                          int idx, float x, float y, float z) {
  uint32_t rs, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rs) : "r"(smem_addr(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(rs), "r"(key), "r"(idx), "r"(__float_as_uint(x)), "r"(__float_as_uint(y)), "r"(rb)
      : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(rs + 16), "r"(__float_as_uint(z)), "r"(rb)
               : "memory");
}

__device__ __forceinline__ void wait_slots(uint64_t* bar, int bytes, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (threadIdx.x == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes)
                 : "memory");
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// The rest of step j after each thread found its best (value bv, index bi):
// the warp's candidate to its slot in every CTA of the cluster, one barrier
// (__syncthreads, or the slot barrier of buffer j % 2), then every warp
// reduces the slots. Returns the pick and its coordinates. `coords(i, x, y,
// z)` reads a point of this CTA.
template <bool kCluster, class Coords>
__device__ __forceinline__ int step_pick(Slot (*slots)[kSlots], uint64_t* bars, int j, float bv,
                                         int bi, const Coords& coords, float& x1, float& y1,
                                         float& z1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5, buf = j & 1;
  const unsigned C = kCluster ? gridDim.x : 1, rank = kCluster ? cluster_rank() : 0;
  const int key = ordered(bv);
  const int wk = __reduce_max_sync(0xffffffffu, key);
  const int wi = __reduce_min_sync(0xffffffffu, key == wk ? bi : INT_MAX);
  if (lane < (int)C) {
    float x = 0.f, y = 0.f, z = 0.f;
    if (wk != ordered(-INFINITY)) coords(wi, x, y, z);
    Slot* slot = &slots[buf][rank * W + warp];
    if constexpr (kCluster) {
      send_slot(slot, &bars[buf], lane, wk, wi, x, y, z);
    } else {
      *reinterpret_cast<int4*>(slot) = make_int4(wk, wi, __float_as_int(x), __float_as_int(y));
      slot->z = z;
    }
  }
  if constexpr (kCluster) wait_slots(&bars[buf], (int)C * W * kSlotBytes, ((j - 1) >> 1) & 1);
  else __syncthreads();
  Slot s;
  if (lane < (int)C * W) {
    s = slots[buf][lane];
  } else {
    s.key = INT_MIN;
    s.idx = INT_MAX;
    s.x = s.y = s.z = 0.f;
  }
  const int k2 = __reduce_max_sync(0xffffffffu, s.key);
  const int i2 = __reduce_min_sync(0xffffffffu, s.key == k2 ? s.idx : INT_MAX);
  const int src = __ffs(__ballot_sync(0xffffffffu, s.key == k2 && s.idx == i2)) - 1;
  x1 = __shfl_sync(0xffffffffu, s.x, src);
  y1 = __shfl_sync(0xffffffffu, s.y, src);
  z1 = __shfl_sync(0xffffffffu, s.z, src);
  return i2;
}

// Points in registers: thread t of CTA r holds points r T P + t + k T, k < P.
// The CTA's points' coordinates are also in shared memory (for the slots).
template <int P, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
fps_regs(const float* __restrict__ xyz, int N, int M, int* __restrict__ out) {
  __shared__ Slot slots[2][kSlots];
  __shared__ uint64_t bars[2];
  extern __shared__ float cs[];  // x, y, z of the CTA's T P points
  const int T = blockDim.x, tid = threadIdx.x, chunk = T * P;
  const unsigned rank = kCluster ? cluster_rank() : 0;
  const int base = rank * chunk;
  const int b = blockIdx.y;
  const float* p = xyz + (size_t)b * N * 3;

  float px[P], py[P], pz[P], md[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int n = base + tid + k * T;
    px[k] = py[k] = pz[k] = 0.f;
    md[k] = -INFINITY;  // past N: never picked
    if (n < N) {
      px[k] = p[3 * n];
      py[k] = p[3 * n + 1];
      pz[k] = p[3 * n + 2];
      const float mag = px[k] * px[k] + py[k] * py[k] + pz[k] * pz[k];
      md[k] = mag > kPadGuard ? kBig : -1.0f;
    }
    cs[tid + k * T] = px[k];
    cs[chunk + tid + k * T] = py[k];
    cs[2 * chunk + tid + k * T] = pz[k];
  }
  if (rank == 0 && tid == 0) out[(size_t)b * M] = 0;
  float x1 = p[0], y1 = p[1], z1 = p[2];
  if constexpr (kCluster) init_slot_barriers(bars);
  // the peers have started, their barriers are set up, the coordinates copied
  if constexpr (kCluster) cluster_barrier();
  else __syncthreads();

  auto coords = [&](int i, float& x, float& y, float& z) {
    const int l = i - base;
    x = cs[l];
    y = cs[chunk + l];
    z = cs[2 * chunk + l];
  };
  for (int j = 1; j < M; ++j) {
    float bv = -INFINITY;
    int bk = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float dx = px[k] - x1, dy = py[k] - y1, dz = pz[k] - z1;
      const float d = dx * dx + dy * dy + dz * dz;
      const float m = fminf(md[k], d);
      md[k] = m;
      if (m > bv) {  // ascending k is ascending index: the first maximum wins ties
        bv = m;
        bk = k;
      }
    }
    const int pick = step_pick<kCluster>(slots, bars, j, bv, base + tid + bk * T, coords, x1, y1, z1);
    if (rank == 0 && tid == 0) out[(size_t)b * M + j] = pick;
  }
  if constexpr (kCluster) cluster_barrier();  // no peer still writes into this CTA
}

// More than kMaxRegN points: min-distances in a global scratch row, the
// coordinates read from device memory (L1); CTA r takes points [r S, r S + S).
template <bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
fps_scratch(const float* __restrict__ xyz, int N, int M, int* __restrict__ out,
            float* __restrict__ scratch) {
  __shared__ Slot slots[2][kSlots];
  __shared__ uint64_t bars[2];
  const int T = blockDim.x, tid = threadIdx.x;
  const unsigned C = kCluster ? gridDim.x : 1, rank = kCluster ? cluster_rank() : 0;
  const int S = (N + C - 1) / C;
  const int lo = rank * S, hi = min(N, lo + S);
  const int b = blockIdx.y;
  const float* p = xyz + (size_t)b * N * 3;
  float* md = scratch + (size_t)b * N;

  for (int n = lo + tid; n < hi; n += T) {
    const float x = p[3 * n], y = p[3 * n + 1], z = p[3 * n + 2];
    md[n] = x * x + y * y + z * z > kPadGuard ? kBig : -1.0f;
  }
  if (rank == 0 && tid == 0) out[(size_t)b * M] = 0;
  float x1 = p[0], y1 = p[1], z1 = p[2];
  if constexpr (kCluster) init_slot_barriers(bars);
  if constexpr (kCluster) cluster_barrier();
  else __syncthreads();

  auto coords = [&](int i, float& x, float& y, float& z) {
    x = __ldg(p + 3 * i);
    y = __ldg(p + 3 * i + 1);
    z = __ldg(p + 3 * i + 2);
  };
  for (int j = 1; j < M; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int n = lo + tid; n < hi; n += T) {
      const float dx = __ldg(p + 3 * n) - x1, dy = __ldg(p + 3 * n + 1) - y1,
                  dz = __ldg(p + 3 * n + 2) - z1;
      const float d = dx * dx + dy * dy + dz * dz;
      const float m = fminf(md[n], d);
      md[n] = m;
      if (m > bv) {
        bv = m;
        bi = n;
      }
    }
    const int pick = step_pick<kCluster>(slots, bars, j, bv, bi, coords, x1, y1, z1);
    if (rank == 0 && tid == 0) out[(size_t)b * M + j] = pick;
  }
  if constexpr (kCluster) cluster_barrier();  // no peer still writes into this CTA
}

int ceil_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Launch `kernel` on a (C, B) grid in clusters of C CTAs.
template <class... KArgs, class... Args>
cudaError_t launch_clusters(void (*kernel)(KArgs...), int C, int B, int T, size_t smem,
                            cudaStream_t s, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int P>
cudaError_t launch_regs(const float* xyz, int B, int N, int M, int C, int* out,
                        cudaStream_t s) {
  const int T = ((N + C * P - 1) / (C * P) + 31) / 32 * 32;
  const size_t smem = (size_t)3 * T * P * sizeof(float);
  if (C == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_regs<P, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    fps_regs<P, false><<<dim3(1, B), T, smem, s>>>(xyz, N, M, out);
    return cudaGetLastError();
  }
  return launch_clusters(fps_regs<P, true>, C, B, T, smem, s, xyz, N, M, out);
}

}  // namespace

extern "C" {

// 1 when an N-point cloud runs the scratch variant and the caller must pass
// a (B, N) float scratch buffer to fps_launch.
int fps_needs_scratch(int N) { return N > kMaxRegN; }

// The cluster size the kernel takes for an N-point row. chip_smoke.py's sweep
// at the model's four FPS shapes (batch 8, H100): 8 is fastest from N = 1024
// up (1024 to 8192 points: 0.41-0.46 us a step, against 0.57-1.08 with 1),
// 1 at N = 512 (0.34 us against 0.38), where a step's work is too small to
// pay for the messages between SMs.
int fps_cluster_size(int N) { return N >= 1024 ? 8 : 1; }

// xyz: (B, N, 3) f32 contiguous; out: (B, M) int32; cluster: CTAs a row (1,
// 2, 4 or 8; 0 for fps_cluster_size(N)). Returns cudaGetLastError().
int fps_launch(const float* xyz, int B, int N, int M, int cluster, int* out, float* scratch,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (N <= 0) return cudaErrorInvalidValue;
  const int C = cluster ? cluster : fps_cluster_size(N);
  if (C != 1 && C != 2 && C != 4 && C != 8) return cudaErrorInvalidValue;
  if (fps_needs_scratch(N)) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const int T = kMaxThreads / C;
    if (C == 1) {
      fps_scratch<false><<<dim3(1, B), T, 0, s>>>(xyz, N, M, out, scratch);
      return cudaGetLastError();
    }
    cudaError_t err = launch_clusters(fps_scratch<true>, C, B, T, 0, s, xyz, N, M, out, scratch);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  const int P = ceil_pow2((N + kMaxThreads - 1) / kMaxThreads);
  cudaError_t err;
  switch (P) {
    case 1: err = launch_regs<1>(xyz, B, N, M, C, out, s); break;
    case 2: err = launch_regs<2>(xyz, B, N, M, C, out, s); break;
    case 4: err = launch_regs<4>(xyz, B, N, M, C, out, s); break;
    default: err = launch_regs<8>(xyz, B, N, M, C, out, s); break;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
