"""Furthest point sampling: the CUDA kernel ``csrc/fps.cu`` and its plain version.

Counterpart of ``eda_tpu/ops/pallas/fps.py`` (kernel) and
``eda_tpu/ops/pointops.py:furthest_point_sample`` (plain version). Index 0 is
picked first, ties go to the lowest index, and points with ``|p|^2 <= 1e-3``
(zero padding of short scenes) are never picked.
"""

from __future__ import annotations

import ctypes

import torch

from eda_tpu_torch.ops.cuda.build import Kernel, c_function, ptr, register, require_cuda

PAD_GUARD = 1e-3
BIG = 1e10

KERNEL = register(Kernel(
    "fps", "fps_launch",
    (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p),
    replaces="eda_tpu/ops/pallas/fps.py:116",
))


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS: (B, N, 3) -> (B, npoint) int32 indices.

    The distance is summed as ``(dx*dx + dy*dy) + dz*dz``, the order the
    kernel uses, so both pick the same indices bit for bit.
    """
    xyz = xyz.float()
    B, N, _ = xyz.shape
    x, y, z = (xyz[..., i].contiguous() for i in range(3))
    valid = (x * x + y * y + z * z) > PAD_GUARD
    mind = torch.full((B, N), BIG, dtype=torch.float32, device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((B, 1), dtype=torch.int64, device=xyz.device)
    neg = torch.full_like(mind, -1.0)
    for i in range(1, npoint):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        last = torch.where(valid, mind, neg).argmax(dim=1, keepdim=True)
        out[:, i] = last[:, 0].int()
    return out


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS of a (B, N, 3) cloud: the kernel on CUDA, the plain version on the CPU."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    return fps_cluster(xyz, npoint, 0)


def fps_cluster(xyz: torch.Tensor, npoint: int, cluster: int) -> torch.Tensor:
    """The FPS kernel with ``cluster`` CTAs a row (1, 2, 4 or 8; 0: the
    kernel's choice for N, ``cluster_size``)."""
    require_cuda(xyz)
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps takes (B, N, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    B, N, _ = xyz.shape
    if N < 1 or npoint < 1:
        raise ValueError(f"fps needs N >= 1 and npoint >= 1, got N={N}, npoint={npoint}")
    if cluster not in (0, 1, 2, 4, 8):
        raise ValueError(f"fps takes clusters of 1, 2, 4 or 8 CTAs, got {cluster}")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    scratch = None
    if c_function("fps", "fps_needs_scratch", [ctypes.c_int])(N):
        scratch = torch.empty((B, N), dtype=torch.float32, device=xyz.device)
    KERNEL(ptr(xyz), B, N, npoint, cluster, ptr(out), ptr(scratch))
    return out


def cluster_size(n_points: int) -> int:
    """The CTAs a row that the kernel takes for ``n_points``-point clouds."""
    return c_function("fps", "fps_cluster_size", [ctypes.c_int])(n_points)
