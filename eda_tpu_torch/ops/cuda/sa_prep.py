"""Fused SA layer-0 prep: the CUDA kernels ``csrc/sa_prep.cu`` (forward) and
``csrc/sa_prep_bwd.cu`` (backward) in bf16, ``csrc/sa_prep_f32.cu`` (both) in
f32, each with its plain version.

Counterpart of ``eda_tpu/ops/pallas/sa_prep.py:sa_prep`` (``_prep_fwd`` and
``_prep_bwd``) at the model's compute dtype::

    bf16:  A = LN(bf16(bf16([xyz/r ; f]) @ bf16(W1)) + bf16(b1))  ->  bf16
    f32:   A = LN([xyz/r ; f] @ W1 + b1)                          ->  f32

with one-pass LayerNorm statistics over the c1 channels (eps 1e-5). ``A`` keeps
its real width c1; the TPU kernel's 128-lane padding and xyz copy are not
reproduced. The backward takes dA in the compute dtype (the TPU wrapper rounds
it there: to bf16, or not at all in f32), recomputes the LayerNorm statistics
with the forward's rounding points, and returns dpts, dW1, db1, dscale and dlnb.
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
BWD_KERNEL = register(Kernel(
    "sa_prep_bwd", "sa_prep_bwd_launch",
    (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float)
    + (ctypes.c_void_p,) * 3,
    replaces="eda_tpu/ops/pallas/sa_prep.py:178",
))
F32_KERNEL = register(Kernel(
    "sa_prep_f32", "sa_prep_f32_launch",
    (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int)
    + (ctypes.c_void_p,) * 4 + (ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p),
    replaces="eda_tpu/ops/pallas/sa_prep.py:142",
))
BWD_F32_KERNEL = register(Kernel(
    "sa_prep_f32", "sa_prep_bwd_f32_launch",
    (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int)
    + (ctypes.c_void_p,) * 3 + (ctypes.c_float,) + (ctypes.c_void_p,) * 3,
    replaces="eda_tpu/ops/pallas/sa_prep.py:178",
))
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).float()


def ln_one_pass(x: torch.Tensor, scale, bias, eps: float = EPS, c: int | None = None):
    """f32 LayerNorm over the last axis with one-pass stats: var = E[x^2] - E[x]^2.

    ``c`` is the real width when the axis carries zero padding past it (the
    sums are the real channels' sums, divided by ``c``); by default the axis'.
    """
    c = c or x.shape[-1]
    mean = x.sum(-1, keepdim=True) / c
    var = torch.clamp((x * x).sum(-1, keepdim=True) / c - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def rounding(compute_dtype: torch.dtype):
    """The rounding to ``compute_dtype`` of f32 values: to bf16 and back, or none."""
    if compute_dtype == torch.bfloat16:
        return bf16_round
    if compute_dtype == torch.float32:
        return lambda x: x
    raise ValueError(f"the SA layers compute in bf16 or f32, not {compute_dtype}")


def _recompute(pts, w1, b1, radius: float, compute_dtype=torch.bfloat16):
    """(layer-0 input, x before the LayerNorm), rounded as the kernel rounds."""
    rnd = rounding(compute_dtype)
    # a tensor divisor: a Python-scalar divisor may become a reciprocal multiply
    xyz = pts[..., :3] / pts.new_tensor(radius)
    x_in = rnd(torch.cat([xyz, pts[..., 3:]], -1))
    x = rnd(rnd(x_in @ rnd(w1.float())) + rnd(b1.float()))
    return x_in, x


def sa_prep_plain(pts, w1, b1, scale, lnb, *, radius: float,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch prep: (B, N, 3 + C) f32 points -> (B, N, c1) ``A`` in compute_dtype."""
    _, x = _recompute(pts, w1, b1, radius, compute_dtype)
    return ln_one_pass(x, scale.float(), lnb.float()).to(compute_dtype)


def max_in_dim(c1: int) -> int:
    """The largest in_dim the bf16 prep kernel takes at width c1 (0: c1 unsupported)."""
    return c_function("sa_prep", "sa_prep_max_in_dim", [ctypes.c_int])(c1)


def max_in_dim_f32(c1: int, backward: bool = False) -> int:
    """The largest in_dim the f32 prep forward (or backward) kernel takes at width c1:
    its tensor-core route's up to c1 128, its CUDA-core route's 8 above."""
    return c_function("sa_prep_f32", "sa_prep_f32_max_in_dim",
                      [ctypes.c_int, ctypes.c_int])(c1, int(backward))


def _f32_scratch(rows: int, in_dim: int, c1: int, backward: bool, device) -> torch.Tensor:
    """The f32 kernels' scratch: W1 split for the tensor cores, the CTAs' records."""
    n = c_function("sa_prep_f32", "sa_prep_f32_scratch",
                   [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int],
                   ctypes.c_longlong)(rows, in_dim, c1, int(backward))
    return torch.empty((n,), dtype=torch.float32, device=device)


def _check_widths(name: str, in_dim: int, c1: int, max_in: int) -> None:
    if not 3 <= in_dim <= max_in:
        raise ValueError(f"{name} kernel takes c1 <= 256 and in_dim <= {max_in}, "
                         f"got c1={c1}, in_dim={in_dim}")


def sa_prep(pts, w1, b1, scale, lnb, *, radius: float,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Layer-0 projection ``A``: the kernel on CUDA, the plain version on the CPU.

    Args:
        pts: (B, N, 3 + C) f32 sorted points, xyz first, not yet divided by r.
        w1: (3 + C, c1) layer-0 kernel; b1 / scale / lnb: (c1,) bias and
            LayerNorm scale / bias.
        radius: SA ball radius.
        compute_dtype: bf16 (K2) or f32 (K2f).

    Returns:
        (B, N, c1) in compute_dtype.
    """
    if pts.device.type == "cpu":
        return sa_prep_plain(pts, w1, b1, scale, lnb, radius=radius,
                             compute_dtype=compute_dtype)
    rounding(compute_dtype)
    B, N, in_dim = pts.shape
    c1 = w1.shape[1]
    f32 = compute_dtype == torch.float32
    w1 = w1.to(compute_dtype).contiguous()
    b1, scale, lnb = (v.float().contiguous() for v in (b1, scale, lnb))
    require_cuda(pts, w1, b1, scale, lnb)
    if pts.dtype != torch.float32:
        raise ValueError(f"sa_prep takes float32 points, got {pts.dtype}")
    if w1.shape[0] != in_dim or any(v.shape != (c1,) for v in (b1, scale, lnb)):
        raise ValueError("sa_prep parameter shapes do not match the points")
    _check_widths("sa_prep", in_dim, c1, max_in_dim_f32(c1) if f32 else max_in_dim(c1))
    out = torch.empty((B, N, c1), dtype=compute_dtype, device=pts.device)
    args = (ptr(pts), B * N, in_dim, c1, ptr(w1), ptr(b1), ptr(scale), ptr(lnb), float(radius),
            ptr(out))
    if f32:
        scratch = _f32_scratch(B * N, in_dim, c1, False, pts.device)
        F32_KERNEL(*args, ptr(scratch))
    else:
        KERNEL(*args)
    return out


def sa_prep_bwd_plain(pts, dA, w1, b1, scale, *, radius: float, compute_dtype=torch.bfloat16):
    """Plain PyTorch prep backward: (dpts, dW1, db1, dscale, dlnb), all f32."""
    rnd = rounding(compute_dtype)
    in_dim, c1 = w1.shape
    x_in, x = _recompute(pts.float(), w1, b1, radius, compute_dtype)
    mean = x.sum(-1, keepdim=True) / c1
    var = torch.clamp((x * x).sum(-1, keepdim=True) / c1 - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + EPS)
    xhat = (x - mean) * rstd
    g = dA.to(compute_dtype).float()
    dxhat = g * scale.float()
    m1 = dxhat.sum(-1, keepdim=True) / c1
    m2 = (dxhat * xhat).sum(-1, keepdim=True) / c1
    dx = rstd * (dxhat - m1 - xhat * m2)
    dxb = rnd(dx)
    dp = dxb @ rnd(w1.float()).T
    dpts = torch.cat([dp[..., :3] / pts.new_tensor(radius), dp[..., 3:]], -1)
    rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    dw1 = rows(x_in).T @ rows(dxb)
    return (dpts, dw1, rows(dx).sum(0), rows(g * xhat).sum(0), rows(g).sum(0))


def sa_prep_bwd(pts, dA, w1, b1, scale, *, radius: float, compute_dtype=torch.bfloat16):
    """Backward of ``sa_prep``: the kernel on CUDA, the plain version on the CPU.

    Args:
        pts: (B, N, 3 + C) f32 points as the forward got them.
        dA: (B, N, c1) cotangent of ``A``, rounded to compute_dtype here
            (bf16: K7; f32, unrounded: K7f).
        w1, b1, scale: the forward's layer-0 kernel, bias and LayerNorm scale.

    Returns:
        (dpts (B, N, 3 + C), dW1 (3 + C, c1), db1, dscale, dlnb (c1,)), f32.
    """
    if pts.device.type == "cpu":
        return sa_prep_bwd_plain(pts, dA, w1, b1, scale, radius=radius,
                                 compute_dtype=compute_dtype)
    rounding(compute_dtype)
    if compute_dtype == torch.float32:
        return _prep_bwd_f32(pts, dA, w1, b1, scale, radius=radius)
    B, N, in_dim = pts.shape
    c1 = w1.shape[1]
    dA = dA.to(torch.bfloat16).contiguous()
    w1 = w1.to(torch.bfloat16).contiguous()
    b1, scale = (v.float().contiguous() for v in (b1, scale))
    require_cuda(pts, dA, w1, b1, scale)
    if pts.dtype != torch.float32 or dA.shape != (B, N, c1):
        raise ValueError("sa_prep_bwd takes float32 points and a (B, N, c1) cotangent")
    if w1.shape[0] != in_dim:
        raise ValueError("sa_prep_bwd parameter shapes do not match the points")
    _check_widths("sa_prep_bwd", in_dim, c1,
                  c_function("sa_prep_bwd", "sa_prep_bwd_max_in_dim", [ctypes.c_int])(c1))
    rows = B * N
    n_ctas = c_function("sa_prep_bwd", "sa_prep_bwd_ctas",
                        [ctypes.c_longlong, ctypes.c_int, ctypes.c_int])(rows, in_dim, c1)
    f32 = dict(dtype=torch.float32, device=pts.device)
    dpts = torch.empty((B, N, in_dim), **f32)
    wout = torch.empty(((in_dim + 3) * c1,), **f32)
    records = torch.empty((n_ctas, (in_dim + 3) * c1), **f32)
    BWD_KERNEL(ptr(pts), ptr(dA), rows, in_dim, c1, ptr(w1), ptr(b1), ptr(scale),
               float(radius), ptr(dpts), ptr(wout), ptr(records))
    vec = wout[in_dim * c1:].view(3, c1)
    return dpts, wout[:in_dim * c1].view(in_dim, c1), vec[0], vec[1], vec[2]


def _prep_bwd_f32(pts, dA, w1, b1, scale, *, radius: float):
    """K7f: the f32 prep backward on CUDA, dA unrounded."""
    B, N, in_dim = pts.shape
    c1 = w1.shape[1]
    dA = dA.float().contiguous()
    w1 = w1.float().contiguous()
    b1, scale = (v.float().contiguous() for v in (b1, scale))
    require_cuda(pts, dA, w1, b1, scale)
    if pts.dtype != torch.float32 or dA.shape != (B, N, c1) or w1.shape[0] != in_dim:
        raise ValueError("sa_prep_bwd takes float32 points and a (B, N, c1) cotangent")
    _check_widths("sa_prep_bwd", in_dim, c1, max_in_dim_f32(c1, backward=True))
    rows = B * N
    f32 = dict(dtype=torch.float32, device=pts.device)
    dpts = torch.empty((B, N, in_dim), **f32)
    wout = torch.empty(((in_dim + 3) * c1,), **f32)
    if rows == 0:
        wout.zero_()
    else:
        scratch = _f32_scratch(rows, in_dim, c1, True, pts.device)
        BWD_F32_KERNEL(ptr(pts), ptr(dA), rows, in_dim, c1, ptr(w1), ptr(b1), ptr(scale),
                       float(radius), ptr(dpts), ptr(wout), ptr(scratch))
    vec = wout[in_dim * c1:].view(3, c1)
    return dpts, wout[:in_dim * c1].view(in_dim, c1), vec[0], vec[1], vec[2]
