"""SA pair-MLP max-pool forward: the CUDA kernel ``csrc/sa_pair_pool.cu`` and its plain version.

Counterpart of ``eda_tpu/ops/pallas/sa_kernel.py:sa_pair_pool_pallas`` with
``d2_mode="pair"`` and no winner export. Centers come in blocks of 16 (rank
order); each block pairs with the ``window`` points that start at its window
start floored to a multiple of 16. Per pair (center c, point p)::

    h0 = bf16(relu(f32(A_p) + f32(bc_c)))
    h1 = bf16(relu(LN(h0 @ W2 + b2)))      # f32 sums of bf16 products
    z  = h1 @ W3 + b3                      # f32 pre-activation

and the output is the max of z over the pairs with ``|p - c|^2 <= r^2`` (f32),
-1e9 for a center with no point of its window in range. The pair MLP has one
interior layer, as every configuration of the model does.
"""

from __future__ import annotations

import ctypes

import torch

from eda_tpu_torch.ops.cuda.build import Kernel, ptr, register, require_cuda
from eda_tpu_torch.ops.cuda.sa_prep import bf16_round, ln_one_pass

BLOCK = 16  # centers per window block
NEG = -1e9
PLAIN_MAX_PAIRS = 1 << 22  # pairs the plain version holds at once (SA1's grid is ~1 GB a scene)
# (c2, c3) widths the kernel is instantiated for (csrc/sa_pair_pool.cu)
WIDTHS = ((16, 32), (32, 64), (64, 128), (128, 256))

KERNEL = register(Kernel(
    "sa_pair_pool", "sa_pair_pool_launch",
    (ctypes.c_void_p,) * 11
    + (ctypes.c_int,) * 7 + (ctypes.c_float, ctypes.c_void_p),
    replaces="eda_tpu/ops/pallas/sa_kernel.py:1271",
))


def window_starts(starts: torch.Tensor, n_points: int, window: int) -> torch.Tensor:
    """Window starts as the kernel uses them: floored to 16, inside [0, N - W]."""
    return torch.clamp((starts // 16) * 16, 0, n_points - window)


def sa_pair_pool_plain(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3,
                       *, radius: float, window: int) -> torch.Tensor:
    """Plain PyTorch pair pool, in chunks of center blocks.

    The matmuls run in f32 on bf16-rounded operands: the products are exact,
    so each sum is an f32 sum of bf16 products as in the kernel.
    """
    B, N, c1 = A.shape
    M = b_c.shape[1]
    n_blocks = M // BLOCK
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    starts = window_starts(starts.long(), N, window)
    w2f, w3f = bf16_round(w2.float()), bf16_round(w3.float())
    b2, s2, lb2, b3 = (v.float() for v in (b2, s2, lb2, b3))
    offs = torch.arange(window, device=A.device)
    chunk = max(1, PLAIN_MAX_PAIRS // (B * BLOCK * window))
    out = torch.empty((B, M, w3.shape[1]), dtype=torch.float32, device=A.device)
    for j0 in range(0, n_blocks, chunk):
        j1 = min(n_blocks, j0 + chunk)
        nb = j1 - j0
        pos = (starts[:, j0:j1, None] + offs).reshape(B, nb * window, 1)
        a_w = A.float().gather(1, pos.expand(-1, -1, c1)).view(B, nb, 1, window, c1)
        x_w = xyz.float().gather(1, pos.expand(-1, -1, 3)).view(B, nb, 1, window, 3)
        bc = b_c[:, j0 * BLOCK:j1 * BLOCK].float().view(B, nb, BLOCK, 1, c1)
        cen = cen_xyz[:, j0 * BLOCK:j1 * BLOCK].float().view(B, nb, BLOCK, 1, 3)
        h = bf16_round(torch.relu(a_w + bc))  # (B, nb, 16, W, c1)
        h = bf16_round(torch.relu(ln_one_pass(h @ w2f + b2, s2, lb2)))
        z = h @ w3f + b3
        d = x_w - cen
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        z = torch.where((d2 <= r2)[..., None], z, torch.full_like(z, NEG))
        out[:, j0 * BLOCK:j1 * BLOCK] = z.amax(dim=3).reshape(B, nb * BLOCK, -1)
    return out


def sa_pair_pool(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3,
                 *, radius: float, window: int) -> torch.Tensor:
    """Windowed masked-max pair MLP: the kernel on CUDA, the plain version on the CPU.

    Args:
        A: (B, N, c1) bf16 pre-normalized per-point projections.
        xyz: (B, N, 3) f32 sorted coordinates.
        b_c: (B, M, c1) bf16 per-center offsets, centers in rank order.
        cen_xyz: (B, M, 3) f32 center coordinates (rank order).
        starts: (B, M // 16) int window starts, floored to 16 here.
        w2, b2, s2, lb2: interior layer (c1, c2) kernel, bias, LN scale and bias.
        w3, b3: last layer (c2, c3) kernel and bias.

    Returns:
        (B, M, c3) f32 pooled last-layer pre-activations; -1e9 rows for centers
        with no in-radius point in their window.
    """
    if A.device.type == "cpu":
        return sa_pair_pool_plain(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2,
                                  w3, b3, radius=radius, window=window)
    B, N, c1 = A.shape
    M = b_c.shape[1]
    c2, c3 = w3.shape
    w2, w3 = (w.to(torch.bfloat16).contiguous() for w in (w2, w3))
    b2, s2, lb2, b3 = (v.float().contiguous() for v in (b2, s2, lb2, b3))
    starts = window_starts(starts.to(torch.int32), N, window).to(torch.int32).contiguous()
    require_cuda(A, xyz, b_c, cen_xyz, starts, w2, b2, s2, lb2, w3, b3)
    if A.dtype != torch.bfloat16 or b_c.dtype != torch.bfloat16:
        raise ValueError("sa_pair_pool takes bf16 A and b_c")
    if xyz.dtype != torch.float32 or cen_xyz.dtype != torch.float32:
        raise ValueError("sa_pair_pool takes float32 coordinates")
    if (c2, c3) not in WIDTHS or c1 % 8 or w2.shape != (c1, c2):
        raise ValueError(f"sa_pair_pool kernel takes (c2, c3) in {WIDTHS} and c1 % 8 == 0, "
                         f"got c1={c1}, c2={c2}, c3={c3}")
    if (M % BLOCK or xyz.shape != (B, N, 3) or b_c.shape != (B, M, c1)
            or cen_xyz.shape != (B, M, 3) or starts.shape != (B, M // BLOCK)
            or not 0 < window <= N):
        raise ValueError("sa_pair_pool input shapes do not agree")
    out = torch.empty((B, M, c3), dtype=torch.float32, device=A.device)
    r2 = torch.tensor(radius * radius, dtype=torch.float32).item()
    KERNEL(ptr(A), ptr(xyz), ptr(b_c), ptr(cen_xyz), ptr(starts), ptr(w2), ptr(b2),
           ptr(s2), ptr(lb2), ptr(w3), ptr(b3), B, N, M, c1, c2, c3, window, r2,
           ptr(out))
    return out
