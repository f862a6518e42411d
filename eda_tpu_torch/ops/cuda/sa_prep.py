"""Fused SA layer-0 prep: the CUDA kernels ``csrc/sa_prep.cu`` (forward) and
``csrc/sa_prep_bwd.cu`` (backward), each with its plain version.

Counterpart of ``eda_tpu/ops/pallas/sa_prep.py:sa_prep`` (``_prep_fwd`` and
``_prep_bwd``)::

    A = LN(bf16(bf16([xyz/r ; f]) @ bf16(W1)) + bf16(b1))  ->  bf16

with one-pass LayerNorm statistics over the c1 channels (eps 1e-5). ``A`` keeps
its real width c1; the TPU kernel's 128-lane padding and xyz copy are not
reproduced. The backward takes dA in bf16 (the TPU wrapper rounds it there),
recomputes the LayerNorm statistics with the forward's rounding points, and
returns dpts, dW1, db1, dscale and dlnb.
"""

from __future__ import annotations

import ctypes

import torch

from eda_tpu_torch.ops.cuda.build import Kernel, c_function, ptr, register, require_cuda

EPS = 1e-5
ROWS_PER_CHUNK = 4096  # rows per dW1 partial (csrc/wgrad.cuh)

KERNEL = register(Kernel(
    "sa_prep", "sa_prep_launch",
    (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_float, ctypes.c_void_p),
    replaces="eda_tpu/ops/pallas/sa_prep.py:142",
))
BWD_KERNEL = register(Kernel(
    "sa_prep_bwd", "sa_prep_bwd_launch",
    (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int)
    + (ctypes.c_void_p,) * 6,
    replaces="eda_tpu/ops/pallas/sa_prep.py:178",
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


def _recompute(pts, w1, b1, radius: float):
    """(bf16-rounded layer-0 input, x before the LayerNorm), rounded as the kernel rounds."""
    # a tensor divisor: a Python-scalar divisor may become a reciprocal multiply
    xyz = pts[..., :3] / pts.new_tensor(radius)
    x_in = bf16_round(torch.cat([xyz, pts[..., 3:]], -1))
    x = bf16_round(bf16_round(x_in @ bf16_round(w1.float())) + bf16_round(b1.float()))
    return x_in, x


def sa_prep_plain(pts, w1, b1, scale, lnb, *, radius: float) -> torch.Tensor:
    """Plain PyTorch prep: (B, N, 3 + C) f32 points -> (B, N, c1) bf16 ``A``."""
    _, x = _recompute(pts, w1, b1, radius)
    return ln_one_pass(x, scale.float(), lnb.float()).to(torch.bfloat16)


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



def sa_prep_bwd_plain(pts, dA, w1, b1, scale, *, radius: float):
    """Plain PyTorch prep backward: (dpts, dW1, db1, dscale, dlnb), all f32."""
    in_dim, c1 = w1.shape
    x_in, x = _recompute(pts.float(), w1, b1, radius)
    mean = x.sum(-1, keepdim=True) / c1
    var = torch.clamp((x * x).sum(-1, keepdim=True) / c1 - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + EPS)
    xhat = (x - mean) * rstd
    g = dA.to(torch.bfloat16).float()
    dxhat = g * scale.float()
    m1 = dxhat.sum(-1, keepdim=True) / c1
    m2 = (dxhat * xhat).sum(-1, keepdim=True) / c1
    dx = rstd * (dxhat - m1 - xhat * m2)
    dxb = bf16_round(dx)
    dp = dxb @ bf16_round(w1.float()).T
    dpts = torch.cat([dp[..., :3] / pts.new_tensor(radius), dp[..., 3:]], -1)
    rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    dw1 = rows(x_in).T @ rows(dxb)
    return (dpts, dw1, rows(dx).sum(0), rows(g * xhat).sum(0), rows(g).sum(0))


def sa_prep_bwd(pts, dA, w1, b1, scale, *, radius: float):
    """Backward of ``sa_prep``: the kernel on CUDA, the plain version on the CPU.

    Args:
        pts: (B, N, 3 + C) f32 points as the forward got them.
        dA: (B, N, c1) cotangent of ``A``, rounded to bf16 here.
        w1, b1, scale: the forward's layer-0 kernel, bias and LayerNorm scale.

    Returns:
        (dpts (B, N, 3 + C), dW1 (3 + C, c1), db1, dscale, dlnb (c1,)), f32.
    """
    if pts.device.type == "cpu":
        return sa_prep_bwd_plain(pts, dA, w1, b1, scale, radius=radius)
    B, N, in_dim = pts.shape
    c1 = w1.shape[1]
    dA = dA.to(torch.bfloat16).contiguous()
    w1 = w1.to(torch.bfloat16).contiguous()
    b1, scale = (v.float().contiguous() for v in (b1, scale))
    require_cuda(pts, dA, w1, b1, scale)
    if pts.dtype != torch.float32 or dA.shape != (B, N, c1):
        raise ValueError("sa_prep_bwd takes float32 points and a (B, N, c1) cotangent")
    max_in = c_function("sa_prep_bwd", "sa_prep_bwd_max_in_dim", [ctypes.c_int])(c1)
    if w1.shape[0] != in_dim or not 3 <= in_dim <= max_in:
        raise ValueError(f"sa_prep_bwd kernel takes c1 <= 256 and in_dim <= {max_in}, "
                         f"got c1={c1}, in_dim={in_dim}")
    rows = B * N
    n_ctas = c_function("sa_prep_bwd", "sa_prep_bwd_ctas", [ctypes.c_longlong])(rows)
    n_chunks = -(-rows // ROWS_PER_CHUNK)
    f32 = dict(dtype=torch.float32, device=pts.device)
    dpts = torch.empty((B, N, in_dim), **f32)
    dw1 = torch.empty((in_dim, c1), **f32)
    vec = torch.empty((3, c1), **f32)
    dx_rows = torch.empty((rows, c1), dtype=torch.bfloat16, device=pts.device)
    vec_partial = torch.empty((n_ctas, 3 * c1), **f32)
    w_partial = torch.empty((n_chunks, in_dim, c1), **f32)
    BWD_KERNEL(ptr(pts), ptr(dA), rows, in_dim, c1, ptr(w1), ptr(b1), ptr(scale),
               float(radius), ROWS_PER_CHUNK, ptr(dpts), ptr(dw1), ptr(vec), ptr(dx_rows),
               ptr(vec_partial), ptr(w_partial))
    return dpts, dw1, vec[0], vec[1], vec[2]
