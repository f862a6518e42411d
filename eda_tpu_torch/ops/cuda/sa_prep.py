"""Fused SA layer-0 prep: the CUDA kernels ``csrc/sa_prep.cu`` (forward) and
``csrc/sa_prep_bwd.cu`` (backward) in bf16, ``csrc/sa_prep_f32.cu`` (both) in
f32, up to c1 256, and ``csrc/sa_prep_512.cu`` (the forward) and
``csrc/sa_prep_bwd_512.cu`` (the backward), both dtypes, c1 257 to 512, each
with its plain version. Wider layers raise on CUDA (ROADMAP item 8.3).

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
from collections import OrderedDict

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
    + (ctypes.c_void_p,) * 4 + (ctypes.c_float,) + (ctypes.c_void_p,) * 3,
    replaces="eda_tpu/ops/pallas/sa_prep.py:142",
))
BWD_F32_KERNEL = register(Kernel(
    "sa_prep_f32", "sa_prep_bwd_f32_launch",
    (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int)
    + (ctypes.c_void_p,) * 3 + (ctypes.c_float,) + (ctypes.c_void_p,) * 3,
    replaces="eda_tpu/ops/pallas/sa_prep.py:178",
))
_XL_ARGS = ((ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int)
            + (ctypes.c_void_p,) * 4 + (ctypes.c_float, ctypes.c_void_p))
KERNEL_XL = register(Kernel("sa_prep_512", "sa_prep_512_launch", _XL_ARGS,
                            replaces="eda_tpu/ops/pallas/sa_prep.py:142"))
F32_KERNEL_XL = register(Kernel("sa_prep_512", "sa_prep_f32_512_launch", _XL_ARGS,
                                replaces="eda_tpu/ops/pallas/sa_prep.py:142"))
_BWD_XL_ARGS = ((ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int)
                + (ctypes.c_void_p,) * 3 + (ctypes.c_float,) + (ctypes.c_void_p,) * 3)
BWD_KERNEL_XL = register(Kernel("sa_prep_bwd_512", "sa_prep_bwd_512_launch", _BWD_XL_ARGS,
                                replaces="eda_tpu/ops/pallas/sa_prep.py:178"))
BWD_F32_KERNEL_XL = register(Kernel("sa_prep_bwd_512", "sa_prep_bwd_f32_512_launch",
                                    _BWD_XL_ARGS, replaces="eda_tpu/ops/pallas/sa_prep.py:178"))
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)
# The widest c1 of csrc/sa_prep.cu, csrc/sa_prep_bwd.cu and csrc/sa_prep_f32.cu,
# and of csrc/sa_prep_512.cu and csrc/sa_prep_bwd_512.cu above it.
WIDE_C1, XL_C1 = 256, 512
WIDER_ITEM = "ROADMAP item 8.3"  # layers wider than the kernels take, on CUDA


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
    if c1 > WIDE_C1:
        return c_function("sa_prep_512", "sa_prep_512_max_in_dim", [ctypes.c_int])(c1)
    return c_function("sa_prep", "sa_prep_max_in_dim", [ctypes.c_int])(c1)


def cluster_max_in_dim(c1: int) -> int:
    """The largest in_dim the bf16 prep forward runs on its cluster route at width c1
    (0: none; c1 256 from in_dim 433); one more runs the single-CTA plan, W1 streamed."""
    return c_function("sa_prep", "sa_prep_cluster_max_in_dim", [ctypes.c_int])(c1)


# csrc/sa_prep_f32.cu's kFmaMaxIn, and the clusters of two CTAs an H100 holds
# (kSms / kNQ): the f32 forward's routes change there
F32_FMA_MAX_IN, F32_CLUSTER_TILES = 8, 66
F32_FORWARD_ROUTES = ("fma", "tensor", "cluster x1", "cluster x2")
F32_XL_ROUTE = "c1 512"  # above c1 256: csrc/sa_prep_512.cu, a 2-CTA cluster a tile


def f32_forward_route(rows: int, in_dim: int, c1: int) -> str:
    """The route of the f32 forward (K2f) at these rows and widths, as
    ``make_plan`` in ``csrc/sa_prep_f32.cu`` picks it (from the rows and widths
    only): "fma" (in_dim up to 8, the CUDA cores), "tensor" (``prep_tc``, c1 up
    to 128) or, above c1 128, ``prep_fwd_cluster`` with one consumer warpgroup a
    CTA ("cluster x1": a cluster of two CTAs a 64-row tile, at most 66 tiles) or
    two ("cluster x2": two tiles a cluster at a time); above c1 256
    ``F32_XL_ROUTE``. ``f32_forward_route_cuda`` asks the library."""
    if c1 > WIDE_C1:
        return F32_XL_ROUTE
    if in_dim <= F32_FMA_MAX_IN:
        return "fma"
    if c1 <= 128:
        return "tensor"
    return "cluster x2" if -(-rows // 64) > F32_CLUSTER_TILES else "cluster x1"


def f32_forward_route_cuda(rows: int, in_dim: int, c1: int) -> str:
    """``f32_forward_route`` as the kernel library's plan gives it (needs the built library)."""
    if c1 > WIDE_C1:
        if not 3 <= in_dim <= max_in_dim_f32(c1):
            raise ValueError(f"the f32 prep forward takes no route at ({rows}, {in_dim}, {c1})")
        return F32_XL_ROUTE
    route = c_function("sa_prep_f32", "sa_prep_f32_forward_route",
                       [ctypes.c_longlong, ctypes.c_int, ctypes.c_int])(rows, in_dim, c1)
    if route < 0:
        raise ValueError(f"the f32 prep forward takes no route at ({rows}, {in_dim}, {c1})")
    return F32_FORWARD_ROUTES[route]


def cluster_max_tiles_f32() -> int:
    """The most 64-row tiles the f32 prep backward runs on its cluster route (c1 256,
    any in_dim it takes); with more it runs the direct backward."""
    return c_function("sa_prep_f32", "sa_prep_f32_cluster_max_tiles", [])()


def set_max_clusters_f32(n: int) -> None:
    """Cap the clusters of the f32 prep backward's cluster route at ``n`` (0: as many
    as the card holds, the default). An H100 holds a cluster for every tile that
    route takes; a cap below the tiles makes each cluster take several in turn, as
    on a card that holds fewer."""
    c_function("sa_prep_f32", "sa_prep_f32_set_max_clusters", [ctypes.c_int], None)(n)


def max_in_dim_f32(c1: int, backward: bool = False) -> int:
    """The largest in_dim the f32 prep forward (or backward) kernel takes at width c1
    (0: c1 unsupported): its tensor-core route's, set by the points' tile in shared
    memory (645 / 391 at c1 128), or by a fixed 2048 above c1 128, where both read
    the points from device memory (the forward on clusters of two CTAs, the backward
    too at few tiles); above c1 256 2048 (csrc/sa_prep_512.cu,
    csrc/sa_prep_bwd_512.cu)."""
    if c1 > WIDE_C1:
        return max_in_dim_bwd_xl(c1) if backward else max_in_dim(c1)
    return c_function("sa_prep_f32", "sa_prep_f32_max_in_dim",
                      [ctypes.c_int, ctypes.c_int])(c1, int(backward))


def _f32_scratch(rows: int, in_dim: int, c1: int, backward: bool, device) -> torch.Tensor:
    """The f32 kernels' scratch: W1 split for the tensor cores, the CTAs' records."""
    n = c_function("sa_prep_f32", "sa_prep_f32_scratch",
                   [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int],
                   ctypes.c_longlong)(rows, in_dim, c1, int(backward))
    return torch.empty((n,), dtype=torch.float32, device=device)


# W1 split for the f32 forward's cluster route, by W1: (data_ptr, device, shape,
# stride) -> (W1, its version when split, the split). Each entry holds its W1,
# so no other tensor takes its memory while the entry lives; the last few are kept.
_SPLITS: "OrderedDict[tuple, tuple]" = OrderedDict()
_SPLITS_KEPT = 8


def f32_w1_split(rows: int, w1: torch.Tensor):
    """W1 split into TF32 hi / lo for the f32 forward where its plan takes the split
    from the caller (the cluster route, c1 above 128), else None.

    Made once a version of W1: an in-place update (the optimizer's step, a loaded
    state) bumps ``w1._version`` and the next call splits it again; a write through
    ``w1.data`` bumps no version and is not seen."""
    in_dim, c1 = w1.shape
    n = c_function("sa_prep_f32", "sa_prep_f32_split_floats",
                   [ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
                   ctypes.c_longlong)(rows, in_dim, c1)
    if n == 0:
        return None
    key = (w1.data_ptr(), w1.device, tuple(w1.shape), w1.stride())
    hit = _SPLITS.get(key)
    if hit is not None and hit[1] == w1._version:
        _SPLITS.move_to_end(key)
        return hit[2]
    split = torch.empty((n,), dtype=torch.float32, device=w1.device)
    status = c_function("sa_prep_f32", "sa_prep_f32_split_w1",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p])(ptr(w1), in_dim, c1, ptr(split),
                                           ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if status != 0:
        raise RuntimeError(f"CUDA kernel split_w1 failed to launch: cudaError_t {status}")
    _SPLITS[key] = (w1, w1._version, split)
    _SPLITS.move_to_end(key)
    while len(_SPLITS) > _SPLITS_KEPT:
        _SPLITS.popitem(last=False)
    return split


def max_in_dim_bwd_xl(c1: int) -> int:
    """The largest in_dim the c1-512 backward (csrc/sa_prep_bwd_512.cu) takes at width c1."""
    return c_function("sa_prep_bwd_512", "sa_prep_bwd_512_max_in_dim", [ctypes.c_int])(c1)


def _check_widths(name: str, c1: int) -> None:
    """Raise unless the kernels take width c1: up to ``XL_C1``; wider layers on
    CUDA are ``WIDER_ITEM``."""
    if not 1 <= c1 <= XL_C1:
        raise ValueError(f"{name} kernels take c1 from 1 to {XL_C1}, got c1={c1}: wider "
                         f"layers on CUDA are {WIDER_ITEM}")


def _check_in_dim(name: str, in_dim: int, c1: int, max_in: int) -> None:
    if not 3 <= in_dim <= max_in:
        raise ValueError(f"{name} kernel takes in_dim from 3 to {max_in} at c1 {c1}, "
                         f"got in_dim={in_dim}")


def _pad_columns(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` zero-padded to ``n`` entries on its last axis, contiguous, 16-byte aligned."""
    t = torch.nn.functional.pad(t, (0, n - t.shape[-1])).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    _check_widths("sa_prep", c1)
    f32 = compute_dtype == torch.float32
    w1 = w1.to(compute_dtype).contiguous()
    b1, scale, lnb = (v.float().contiguous() for v in (b1, scale, lnb))
    require_cuda(pts, w1, b1, scale, lnb)
    if pts.dtype != torch.float32:
        raise ValueError(f"sa_prep takes float32 points, got {pts.dtype}")
    if w1.shape[0] != in_dim or any(v.shape != (c1,) for v in (b1, scale, lnb)):
        raise ValueError("sa_prep parameter shapes do not match the points")
    _check_in_dim("sa_prep", in_dim, c1, max_in_dim_f32(c1) if f32 else max_in_dim(c1))
    out = torch.empty((B, N, c1), dtype=compute_dtype, device=pts.device)
    if c1 > WIDE_C1:  # csrc/sa_prep_512.cu: the vectors and W1's columns padded to 512
        w1, b1, scale, lnb = (_pad_columns(t, XL_C1) for t in (w1, b1, scale, lnb))
        (F32_KERNEL_XL if f32 else KERNEL_XL)(ptr(pts), B * N, in_dim, c1, ptr(w1), ptr(b1),
                                              ptr(scale), ptr(lnb), float(radius), ptr(out))
        return out
    # the bf16 cluster route's 16-byte W1 copies need its base 16-byte aligned
    w1 = w1 if f32 or w1.data_ptr() % 16 == 0 else w1.clone()
    args = (ptr(pts), B * N, in_dim, c1, ptr(w1), ptr(b1), ptr(scale), ptr(lnb), float(radius),
            ptr(out))
    if f32:
        scratch = _f32_scratch(B * N, in_dim, c1, False, pts.device)
        F32_KERNEL(*args, ptr(f32_w1_split(B * N, w1)), ptr(scratch))
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
    _check_widths("sa_prep_bwd", w1.shape[1])
    if w1.shape[1] > WIDE_C1:
        return _prep_bwd_xl(pts, dA, w1, b1, scale, radius=radius, compute_dtype=compute_dtype)
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
    _check_in_dim("sa_prep_bwd", in_dim, c1,
                  c_function("sa_prep_bwd", "sa_prep_bwd_max_in_dim", [ctypes.c_int])(c1))
    # the kernel's vector loads need 16-byte aligned rows' bases: a view that
    # starts elsewhere is copied
    pts, dA, w1 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (pts, dA, w1))
    rows = B * N
    n_ctas = c_function("sa_prep_bwd", "sa_prep_bwd_ctas",
                        [ctypes.c_longlong, ctypes.c_int, ctypes.c_int])(rows, in_dim, c1)
    if n_ctas < 1:
        raise RuntimeError(f"sa_prep_bwd: the kernel cannot be placed at in_dim {in_dim}, c1 {c1}")
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
    _check_in_dim("sa_prep_bwd", in_dim, c1, max_in_dim_f32(c1, backward=True))
    # the cluster route's 16-byte dA copies need its base aligned
    dA = dA if dA.data_ptr() % 16 == 0 else dA.clone()
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


def _prep_bwd_xl(pts, dA, w1, b1, scale, *, radius: float, compute_dtype):
    """K7 / K7f at c1 257-512 (csrc/sa_prep_bwd_512.cu): W1, b1 and scale
    zero-padded to ``XL_C1`` columns, dA at its real c1."""
    f32 = compute_dtype == torch.float32
    B, N, in_dim = pts.shape
    c1 = w1.shape[1]
    pts = pts.contiguous()
    dA = dA.to(compute_dtype).contiguous()
    require_cuda(pts, dA, w1, b1, scale)
    if pts.dtype != torch.float32 or dA.shape != (B, N, c1) or w1.shape[0] != in_dim:
        raise ValueError("sa_prep_bwd takes float32 points and a (B, N, c1) cotangent")
    w1 = _pad_columns(w1.to(compute_dtype), XL_C1)
    b1, scale = (_pad_columns(v.float(), XL_C1) for v in (b1, scale))
    _check_in_dim("sa_prep_bwd", in_dim, c1, max_in_dim_bwd_xl(c1))
    rows = B * N
    f32d = dict(dtype=torch.float32, device=pts.device)
    dpts = torch.empty((B, N, in_dim), **f32d)
    wout = torch.empty(((in_dim + 3) * XL_C1,), **f32d)
    nbytes = c_function("sa_prep_bwd_512", "sa_prep_bwd_512_scratch_bytes",
                        [ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
                        ctypes.c_longlong)(rows, in_dim, int(f32))
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=pts.device)
    (BWD_F32_KERNEL_XL if f32 else BWD_KERNEL_XL)(
        ptr(pts), ptr(dA), rows, in_dim, c1, ptr(w1), ptr(b1), ptr(scale),
        float(radius), ptr(dpts), ptr(wout), ptr(scratch))
    vec = wout[in_dim * XL_C1:].view(3, XL_C1)[:, :c1]
    return dpts, wout[:in_dim * XL_C1].view(in_dim, XL_C1)[:, :c1], vec[0], vec[1], vec[2]
