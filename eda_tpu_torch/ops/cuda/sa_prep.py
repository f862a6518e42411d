"""Fused SA layer-0 prep forward: the CUDA kernel ``csrc/sa_prep.cu`` and its plain version.

Counterpart of ``eda_tpu/ops/pallas/sa_prep.py:sa_prep`` (forward)::

    A = LN(bf16(bf16([xyz/r ; f]) @ bf16(W1)) + bf16(b1))  ->  bf16

with one-pass LayerNorm statistics over the c1 channels (eps 1e-5). ``A`` keeps
its real width c1; the TPU kernel's 128-lane padding and xyz copy are not
reproduced.
"""

from __future__ import annotations

import ctypes

import torch

from eda_tpu_torch.ops.cuda.build import Kernel, c_function, ptr, register, require_cuda

EPS = 1e-5

KERNEL = register(Kernel(
    "sa_prep", "sa_prep_launch",
    (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_float, ctypes.c_void_p),
    replaces="eda_tpu/ops/pallas/sa_prep.py:142",
))


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).float()


def ln_one_pass(x: torch.Tensor, scale, bias, eps: float = EPS) -> torch.Tensor:
    """f32 LayerNorm over the last axis with one-pass stats: var = E[x^2] - E[x]^2."""
    c = x.shape[-1]
    mean = x.sum(-1, keepdim=True) / c
    var = torch.clamp((x * x).sum(-1, keepdim=True) / c - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def sa_prep_plain(pts, w1, b1, scale, lnb, *, radius: float) -> torch.Tensor:
    """Plain PyTorch prep: (B, N, 3 + C) f32 points -> (B, N, c1) bf16 ``A``."""
    # a tensor divisor: a Python-scalar divisor may become a reciprocal multiply
    xyz = pts[..., :3] / pts.new_tensor(radius)
    x = bf16_round(torch.cat([xyz, pts[..., 3:]], -1))
    prod = bf16_round(x @ bf16_round(w1.float()))
    h = bf16_round(prod + bf16_round(b1.float()))
    return ln_one_pass(h, scale.float(), lnb.float()).to(torch.bfloat16)


def sa_prep(pts, w1, b1, scale, lnb, *, radius: float) -> torch.Tensor:
    """Layer-0 projection ``A``: the kernel on CUDA, the plain version on the CPU.

    Args:
        pts: (B, N, 3 + C) f32 sorted points, xyz first, not yet divided by r.
        w1: (3 + C, c1) layer-0 kernel; b1 / scale / lnb: (c1,) bias and
            LayerNorm scale / bias.
        radius: SA ball radius.

    Returns:
        (B, N, c1) bf16.
    """
    if pts.device.type == "cpu":
        return sa_prep_plain(pts, w1, b1, scale, lnb, radius=radius)
    B, N, in_dim = pts.shape
    c1 = w1.shape[1]
    w1 = w1.to(torch.bfloat16).contiguous()
    b1, scale, lnb = (v.float().contiguous() for v in (b1, scale, lnb))
    require_cuda(pts, w1, b1, scale, lnb)
    if pts.dtype != torch.float32:
        raise ValueError(f"sa_prep takes float32 points, got {pts.dtype}")
    if w1.shape[0] != in_dim or any(v.shape != (c1,) for v in (b1, scale, lnb)):
        raise ValueError("sa_prep parameter shapes do not match the points")
    max_in = c_function("sa_prep", "sa_prep_max_in_dim", [ctypes.c_int])(c1)
    if not 3 <= in_dim <= max_in:
        raise ValueError(f"sa_prep kernel takes c1 <= 256 and in_dim <= {max_in}, "
                         f"got c1={c1}, in_dim={in_dim}")
    out = torch.empty((B, N, c1), dtype=torch.bfloat16, device=pts.device)
    KERNEL(ptr(pts), B * N, in_dim, c1, ptr(w1), ptr(b1), ptr(scale), ptr(lnb),
           float(radius), ptr(out))
    return out
