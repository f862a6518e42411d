"""The rate of the TF32 ``wgmma`` products the f32 prep kernels issue, alone.

One CTA an SM (132) runs ``--groups`` product groups of 12 ``m64nNk8`` TF32
``wgmma`` with A from registers and B from shared memory, one group kept in
flight (``wgmma_wait<1>``), all into one accumulator, as ``prep_fwd_cluster``
(``csrc/sa_prep_f32.cu``) issues a K step's 3xTF32 products; the variants: N
128 with one and with two warpgroups a CTA, N 256, and N 128 with the next
group's A fragments loaded from shared memory and split between groups (as
the kernel builds them). Nothing else runs, so the rate is what the products
alone reach against the 494.7 TFLOP/s TF32 peak. The source is compiled with
``nvcc`` into ``build/tools/`` at the repository root. Prints one JSON line
with the card's name and power limit; without CUDA it exits non-zero:

    python -m eda_tpu_torch.tools.wgmma_rate
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

PEAK_TF32 = 494.7e12  # flop/s, H100 SXM, dense
# (name, N, warpgroups a CTA, fragments rebuilt between groups)
VARIANTS = (("n128", 128, 1, 0), ("n128 two warpgroups", 128, 2, 0), ("n256", 256, 1, 0),
            ("n128 fragments rebuilt", 128, 1, 1))


def _mma(n: int) -> str:
    outs = ", ".join(f"%{i}" for i in range(n // 2))
    regs = ", ".join(f'"+f"(d[{i}])' for i in range(n // 2))
    a = n // 2
    return (f"__device__ __forceinline__ void mma{n}(float* d, const uint32_t* a, "
            f"uint64_t desc) {{\n"
            f'  asm volatile("wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 {{{outs}}}, '
            f'{{%{a}, %{a + 1}, %{a + 2}, %{a + 3}}}, %{a + 4}, 1, 1, 1;\\n"\n'
            f'    : {regs}\n    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));\n}}\n')


SOURCE = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
""" + _mma(128) + _mma(256) + r"""
__device__ __forceinline__ uint64_t desc(uint32_t addr) {  // K-major, lbo 128, sbo 1024
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32);
}
template <int N, int REBUILD>
__global__ void __launch_bounds__(256, 1) rate(int groups, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < 16384; i += blockDim.x) sf[i] = 1e-3f * (i & 63);
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const int t = threadIdx.x & 127;
  float acc[N / 2];
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t f0[4][4], f1[4][4];
  for (int s = 0; s < 4; ++s)
    for (int i = 0; i < 4; ++i) f0[s][i] = f1[s][i] = __float_as_uint(1e-3f * (t + i));
  auto group = [&](uint32_t (&f)[4][4], uint32_t (&g)[4][4]) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      if constexpr (N == 128) mma128(acc, f[k & 3], desc(base + 256 * (k & 3)));
      else mma256(acc, f[k & 3], desc(base + 256 * (k & 3)));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if constexpr (REBUILD) {  // the next group's fragments: 16 values split in two
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = sf[8192 + (4 * s + i) * 128 + t];
          const uint32_t h = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
          g[s][i] = (__float_as_uint(v - __uint_as_float(h)) + 0x1000u) & 0xffffe000u;
        }
    }
  };
  for (int it = 0; it < groups; it += 2) {
    group(f0, f1);
    group(f1, f0);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int N, int REBUILD>
void run(const char* name, int wgs, int groups) {
  float* out;
  cudaMalloc(&out, 132 * 256 * 4);
  auto k = rate<N, REBUILD>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  k<<<132, 128 * wgs, 65536>>>(16, out);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  k<<<132, 128 * wgs, 65536>>>(groups, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * 64 * N * 8 * 12 * (double)groups * wgs * 132;
  printf("%s\t%f\t%f\t%s\n", name, ms, flop / (ms * 1e-3), cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main(int argc, char** argv) {
  const int groups = argc > 1 ? atoi(argv[1]) : 2000;
""" + "".join(f'  run<{n}, {r}>("{name}", {w}, groups);\n'
             for name, n, w, r in VARIANTS) + "  return 0;\n}\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=2000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wgmma_rate: no CUDA device", file=sys.stderr)
        return 1
    from eda_tpu_torch.bench import card_line
    from eda_tpu_torch.ops.cuda import build

    out_dir = build.BUILD_DIR.parent / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, exe = out_dir / "wgmma_rate.cu", out_dir / "wgmma_rate"
    src.write_text(SOURCE)
    subprocess.run([build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                    "-o", str(exe), str(src)], check=True, capture_output=True, text=True)
    lines = subprocess.run([str(exe), str(args.groups)], check=True, capture_output=True,
                           text=True).stdout.splitlines()
    rows = []
    for line in lines:
        name, ms, rate, err = line.split("\t")
        if err != "no error":
            raise RuntimeError(f"wgmma_rate {name}: {err}")
        rows.append({"variant": name, "ms": float(ms), "tflops": float(rate) / 1e12,
                     "share_of_peak": float(rate) / PEAK_TF32})
    print(json.dumps({"card": card_line(), "groups": args.groups, "variants": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
