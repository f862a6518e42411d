// Furthest point sampling on Hopper.
//
// Replaces the TPU kernel eda_tpu/ops/pallas/fps.py:furthest_point_sample_pallas
// (body _fps_kernel). Follows the CUDA original that file cites
// (sampling_gpu.cu:75-134): one CTA per batch row walks the M serial steps;
// each step folds the distance to the last pick into a running min-distance
// vector and takes its argmax (lowest index on ties).
//
// Bound on this card: the work is ~9 flops per point per step, which at
// M=2048, N=8192 is 0.15 GFLOP per row, ~2 us against the 67 TFLOP/s f32
// peak. The real bound is latency: M dependent steps, each a block-wide
// reduction with two barriers, and only B CTAs in flight. The design keeps
// every per-step access on chip: coordinates and min-distances live in
// dynamic shared memory (16 bytes per point: 128 KB for the 8192-point SA1
// presample) so a step touches no device memory; clouds too large for shared
// memory keep min-distances in a global scratch row instead.
//
// Bit-exactness: the file is compiled with --fmad=false, so
// d = (dx*dx + dy*dy) + dz*dz rounds exactly like the plain PyTorch version.
// Padding points (|p|^2 <= 1e-3) start with min-distance -1: min() keeps them
// at -1 forever, which is the plain version's score for an invalid point.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kPadGuard = 1e-3f;
constexpr float kBig = 1e10f;
constexpr int kMaxSharedBytes = 232448 - 1024;  // H100 opt-in limit, minus static use

__device__ __forceinline__ void keep_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int N, int M, int* __restrict__ out,
           float* __restrict__ scratch) {
  extern __shared__ float smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int pick;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* p = xyz + (size_t)b * N * 3;
  float* xs = smem;
  float* ys = smem + N;
  float* zs = smem + 2 * (size_t)N;
  float* mind = kShared ? smem + 3 * (size_t)N : scratch + (size_t)b * N;

  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float x = p[3 * n], y = p[3 * n + 1], z = p[3 * n + 2];
    if (kShared) {
      xs[n] = x;
      ys[n] = y;
      zs[n] = z;
    }
    const float mag = x * x + y * y + z * z;
    mind[n] = mag > kPadGuard ? kBig : -1.0f;
  }
  if (threadIdx.x == 0) out[(size_t)b * M] = 0;
  __syncthreads();

  int last = 0;
  for (int j = 1; j < M; ++j) {
    const float x1 = kShared ? xs[last] : p[3 * last];
    const float y1 = kShared ? ys[last] : p[3 * last + 1];
    const float z1 = kShared ? zs[last] : p[3 * last + 2];
    float bv = -FLT_MAX;
    int bi = N;
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const float dx = (kShared ? xs[n] : p[3 * n]) - x1;
      const float dy = (kShared ? ys[n] : p[3 * n + 1]) - y1;
      const float dz = (kShared ? zs[n] : p[3 * n + 2]) - z1;
      const float d = dx * dx + dy * dy + dz * dz;
      const float m = fminf(mind[n], d);
      mind[n] = m;
      if (m > bv) {  // ascending n: the first maximum wins ties
        bv = m;
        bi = n;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      keep_better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        keep_better(bv, bi, ov, oi);
      }
      if (lane == 0) {
        pick = bi;
        out[(size_t)b * M + j] = bi;
      }
    }
    __syncthreads();
    last = pick;
  }
}

size_t shared_bytes(int N) { return (size_t)N * 4 * sizeof(float); }

}  // namespace

extern "C" {

// 1 when an N-point cloud does not fit in shared memory and the caller must
// pass a (B, N) float scratch buffer to fps_launch.
int fps_needs_scratch(int N) { return shared_bytes(N) > (size_t)kMaxSharedBytes; }

// xyz: (B, N, 3) f32 contiguous; out: (B, M) int32. Returns cudaGetLastError().
int fps_launch(const float* xyz, int B, int N, int M, int* out, float* scratch,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (N <= 0) return cudaErrorInvalidValue;
  if (fps_needs_scratch(N)) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    fps_kernel<false><<<B, kThreads, 0, s>>>(xyz, N, M, out, scratch);
  } else {
    const size_t smem = shared_bytes(N);
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    fps_kernel<true><<<B, kThreads, smem, s>>>(xyz, N, M, out, nullptr);
  }
  return cudaGetLastError();
}

}  // extern "C"
