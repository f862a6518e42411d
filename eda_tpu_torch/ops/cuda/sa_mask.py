"""The ``pre`` radius mask: the CUDA kernel ``csrc/sa_mask.cu`` and its plain version.

Counterpart of ``eda_tpu/ops/pallas/sa_mask.py:sa_radius_mask``. For every
block of 16 rank-sorted centers and every point ``w`` of the block's window
(``window_starts`` as the pool uses them), all in f32 and in this order::

    o = the block's first center,  p' = p - o,  c' = c - o
    psq = |p'|^2,  csq = |c'|^2                              # sums x, y, z
    d2t = p'x (-2 c'x) + p'y (-2 c'y) + p'z (-2 c'z) + psq + csq
    mask[b, block, w, c] = d2t <= r^2

The mask is window-relative, (B, M // 16, W, 16) ``uint8``: row ``w`` is the
point at the window start + ``w``, and no row lies past the cloud. The TPU
mask instead covers ``[start128, start128 + mask_window(W))`` with per-block
offsets, a layout Mosaic's lane alignment needs; row ``w`` here is its row
``offs + w``.
"""

from __future__ import annotations

import ctypes

import torch

from eda_tpu_torch.ops.cuda.build import Kernel, ptr, register, require_cuda
from eda_tpu_torch.ops.cuda.sa_kernel import BLOCK, window_starts

KERNEL = register(Kernel(
    "sa_mask", "sa_radius_mask_launch",
    (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_void_p),
    replaces="eda_tpu/ops/pallas/sa_mask.py:184",
))


def sa_radius_mask_plain(xyz, cen_xyz, starts, *, radius: float, window: int) -> torch.Tensor:
    """Plain PyTorch mask, term by term as the kernel."""
    B, N, _ = xyz.shape
    n_blocks = cen_xyz.shape[1] // BLOCK
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    starts = window_starts(starts.long(), N, window)
    pos = (starts[..., None] + torch.arange(window, device=xyz.device)).view(B, -1, 1)
    p = xyz.float().gather(1, pos.expand(-1, -1, 3)).view(B, n_blocks, window, 1, 3)
    cen = cen_xyz.float().view(B, n_blocks, 1, BLOCK, 3)
    origin = cen[:, :, :, :1]
    p, c = p - origin, cen - origin
    psq = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]
    csq = c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1] + c[..., 2] * c[..., 2]
    d2t = (p[..., 0] * (-2 * c[..., 0]) + p[..., 1] * (-2 * c[..., 1])
           + p[..., 2] * (-2 * c[..., 2]) + psq + csq)
    return (d2t <= r2).to(torch.uint8)


def sa_radius_mask(xyz, cen_xyz, starts, *, radius: float, window: int) -> torch.Tensor:
    """In-radius mask per (window row, center): the kernel on CUDA, the plain
    version on the CPU.

    Args:
        xyz: (B, N, 3) f32 rank-sorted coordinates.
        cen_xyz: (B, M, 3) f32 center coordinates in rank order, M % 16 == 0.
        starts: (B, M // 16) int window starts, floored to 16 here.
        radius, window: as the pair pool.

    Returns:
        (B, M // 16, window, 16) uint8, 1 where the window's point lies within
        the radius of the block's center.
    """
    if xyz.device.type == "cpu":
        return sa_radius_mask_plain(xyz, cen_xyz, starts, radius=radius, window=window)
    B, N, _ = xyz.shape
    M = cen_xyz.shape[1]
    starts = starts.to(torch.int32).contiguous()  # the kernel floors and clamps them
    require_cuda(xyz, cen_xyz, starts)
    if xyz.dtype != torch.float32 or cen_xyz.dtype != torch.float32:
        raise ValueError("sa_radius_mask takes float32 coordinates")
    if (M % BLOCK or xyz.shape != (B, N, 3) or cen_xyz.shape != (B, M, 3)
            or starts.shape != (B, M // BLOCK) or not 0 < window <= N):
        raise ValueError("sa_radius_mask input shapes do not agree")
    mask = torch.empty((B, M // BLOCK, window, BLOCK), dtype=torch.uint8, device=xyz.device)
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    KERNEL(ptr(xyz), ptr(cen_xyz), ptr(starts), B, N, M, window, r2, ptr(mask))
    return mask
