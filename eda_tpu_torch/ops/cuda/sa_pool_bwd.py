"""SA pair-pool backward: the CUDA kernels ``csrc/sa_pair_pool_bwd.cu`` and their plain version.

Counterpart of ``eda_tpu/ops/pallas/sa_kernel.py:sa_pair_pool_bwd_pallas``.
The forward (``sa_kernel.sa_pair_pool_winners``) pooled, per (center, channel),
the pre-activation ``z = h1 @ W3 + b3`` of one winning pair; the cotangent
``g`` of the pooled values flows to those pairs only. Per pair row the backward
recomputes::

    h0 = bf16(relu(A_p + bc_c)),   h1 = bf16(relu(LN(h0 @ W2 + b2) * s2 + lb2))

and backpropagates through W3, the LayerNorm and W2. It returns ``dA``,
``db_c``, ``dW2``, ``db2``, ``ds2``, ``dlb2``, ``dW3`` and ``db3``.

Two variants, as on the TPU (``tests/test_sa_kernel_interpret.py:293-436``):

* compact (``compact=True``): one row per (center, channel) with a one-hot
  cotangent; the row adds ``bf16(dh0)`` into ``dA``. A winner outside the
  center's window gathers a zero ``A`` row and adds nothing to ``dA``.
* windowed (``compact=False``): one row per distinct in-window winner of a
  center, with the cotangents of every channel it won; the row adds ``dh0``
  into ``dA`` in exact f32.

Every output is a fixed-order sum on the card (``dA`` through per-window
records added in block order), so two launches on the same inputs agree bit
for bit.

Both round the row cotangent to bf16 before ``W3^T`` and ``dx`` to bf16 before
``W2^T``, and sum ``db_c``, ``db2``, ``db3`` and the LayerNorm gradients in f32.
The model picks compact where the TPU does (``compact_backward``).
"""

from __future__ import annotations

import ctypes

import torch

from eda_tpu_torch.ops.cuda.build import Kernel, ptr, register, require_cuda
from eda_tpu_torch.ops.cuda.sa_kernel import BLOCK, kernel_widths, pad_widths, window_starts
from eda_tpu_torch.ops.cuda.sa_prep import EPS, bf16_round

PLAIN_MAX_ELEMS = 1 << 23  # (center, row, channel) elements the plain version holds at once

_ARGTYPES = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,) * 5
COMPACT_KERNEL = register(Kernel(
    "sa_pair_pool_bwd", "sa_pool_bwd_compact_launch", _ARGTYPES,
    replaces="eda_tpu/ops/pallas/sa_kernel.py:649",
))
WINDOW_KERNEL = register(Kernel(
    "sa_pair_pool_bwd", "sa_pool_bwd_window_launch", _ARGTYPES,
    replaces="eda_tpu/ops/pallas/sa_kernel.py:399",
))


def compact_backward(window: int, c_out: int) -> bool:
    """The TPU's choice (``eda_tpu/ops/fused_sa.py:370-374``): compact when the
    winner-slot grid (c_out rounded up to 128 lanes) is smaller than the window."""
    return window % 128 == 0 and -(-c_out // 128) * 128 < window


def sa_pool_bwd_plain(A, b_c, g, winners, starts, w2, b2, s2, lb2, w3, *,
                      window: int, compact: bool, c2_real: int | None = None):
    """Plain PyTorch pair-pool backward, in chunks of centers.

    ``c2_real`` is the real interior width of operands that
    ``sa_kernel.pad_widths`` padded: the LayerNorm's divisor.

    Returns (dA (B, N, c1), db_c (B, M, c1), dW2, db2, ds2, dlb2, dW3, db3), f32.
    """
    B, N, c1 = A.shape
    M = b_c.shape[1]
    c2, c3 = w3.shape
    n_ln = c2_real or c2
    dev = A.device
    w2f, w3f = bf16_round(w2.float()), bf16_round(w3.float())
    b2, s2, lb2 = (v.float() for v in (b2, s2, lb2))
    start = window_starts(starts.long(), N, window).repeat_interleave(BLOCK, dim=1)  # (B, M)
    f32 = dict(dtype=torch.float32, device=dev)
    dA = torch.zeros((B * N, c1), **f32)
    dbc = torch.empty((B, M, c1), **f32)
    dw2, dw3 = torch.zeros((c1, c2), **f32), torch.zeros((c2, c3), **f32)
    db2, ds2, dlb2, db3 = (torch.zeros(c, **f32) for c in (c2, c2, c2, c3))
    chunk = max(1, PLAIN_MAX_ELEMS // (B * c3 * max(c1, c2, c3)))
    for m0 in range(0, M, chunk):
        m1 = min(M, m0 + chunk)
        win = winners[:, m0:m1].long()  # (B, mc, c3)
        gc = g[:, m0:m1].float()
        rel = win - start[:, m0:m1, None]
        in_win = (rel >= 0) & (rel < window)
        if compact:
            # one row per (center, channel); the row's cotangent is one-hot
            row_w = torch.ones_like(in_win)
            d = torch.diag_embed(gc)  # (B, mc, c3 rows, c3)
        else:
            # one row per distinct live winner: its first channel leads it
            live = in_win & (gc != 0)
            same = (win[..., :, None] == win[..., None, :]) & live[..., None, :]
            earlier = torch.ones(c3, c3, dtype=torch.bool, device=dev).tril(-1)
            row_w = live & ~(same & earlier).any(-1)
            d = torch.where(same, gc[..., None, :], torch.zeros((), **f32))
        d = torch.where(row_w[..., None], d, torch.zeros((), **f32))
        idx = (torch.arange(B, device=dev)[:, None, None] * N
               + torch.where(in_win, win, 0).clamp(0, N - 1))  # (B, mc, c3)
        aw = A.reshape(B * N, c1)[idx].float()
        aw = torch.where(in_win[..., None], aw, torch.zeros((), **f32))
        h0pre = aw + b_c[:, m0:m1, None].float()
        h0 = bf16_round(torch.relu(h0pre))
        x = h0 @ w2f + b2
        mean = x.sum(-1, keepdim=True) / n_ln
        var = torch.clamp((x * x).sum(-1, keepdim=True) / n_ln - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + EPS)
        xhat = (x - mean) * rstd
        h1 = bf16_round(torch.relu(xhat * s2 + lb2))
        dbf = bf16_round(d)
        rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
        dw3 += rows(h1).T @ rows(dbf)
        db3 += rows(d).sum(0)
        dh = dbf @ w3f.T
        dln = torch.where(h1 > 0, dh, torch.zeros((), **f32))
        ds2 += rows(dln * xhat).sum(0)
        dlb2 += rows(dln).sum(0)
        dxhat = dln * s2
        mm1 = dxhat.sum(-1, keepdim=True) / n_ln
        mm2 = (dxhat * xhat).sum(-1, keepdim=True) / n_ln
        dx = rstd * (dxhat - mm1 - xhat * mm2)
        dx = torch.where(row_w[..., None], dx, torch.zeros((), **f32))
        db2 += rows(dx).sum(0)
        dxb = bf16_round(dx)
        dw2 += rows(h0).T @ rows(dxb)
        dh0 = torch.where(h0pre > 0, dxb @ w2f.T, torch.zeros((), **f32))
        dbc[:, m0:m1] = dh0.sum(2)
        add = bf16_round(dh0) if compact else dh0
        add = torch.where((in_win & row_w)[..., None], add, torch.zeros((), **f32))
        dA.index_add_(0, idx.reshape(-1), rows(add))
    return dA.view(B, N, c1), dbc, dw2, db2, ds2, dlb2, dw3, db3


def sa_pool_bwd(A, b_c, g, winners, starts, w2, b2, s2, lb2, w3, *,
                window: int, compact: bool):
    """Pair-pool backward: the kernel on CUDA, the plain version on the CPU.

    Args:
        A: (B, N, c1) bf16 per-point projections, as the forward got them.
        b_c: (B, M, c1) bf16 per-center offsets (rank order, M % 16 == 0).
        g: (B, M, c3) f32 cotangent of the pooled pre-activations.
        winners: (B, M, c3) int32 global winner ranks from the forward.
        starts: (B, M // 16) window starts (floored to 16 here, as the forward).
        w2, b2, s2, lb2: interior layer kernel (c1, c2), bias, LN scale and bias.
        w3: last layer kernel (c2, c3).
        window: window length; compact: the compact variant (see module doc).

    Returns:
        (dA, db_c, dW2, db2, ds2, dlb2, dW3, db3), f32.
    """
    if A.device.type == "cpu":
        return sa_pool_bwd_plain(A, b_c, g, winners, starts, w2, b2, s2, lb2, w3,
                                 window=window, compact=compact)
    B, N, c1 = A.shape
    M = b_c.shape[1]
    c2, c3 = w3.shape
    if A.dtype != torch.bfloat16 or b_c.dtype != torch.bfloat16:
        raise ValueError("sa_pool_bwd takes bf16 A and b_c")
    if w2.shape != (c1, c2) or b_c.shape[-1] != c1:
        raise ValueError("sa_pool_bwd widths do not agree")
    if g.shape != (B, M, c3) or winners.shape != (B, M, c3):
        raise ValueError("sa_pool_bwd input shapes do not agree")
    widths = kernel_widths(c1, c2, c3)
    if widths != (c1, c2, c3):
        A, b_c, w2, b2, s2, lb2, w3, _, g, winners = pad_widths(
            widths, A, b_c, w2, b2, s2, lb2, w3, g=g, winners=winners)
    C1, C2, C3 = widths
    A, b_c = A.contiguous(), b_c.contiguous()
    w2, w3 = (w.to(torch.bfloat16).contiguous() for w in (w2, w3))
    b2, s2, lb2 = (v.float().contiguous() for v in (b2, s2, lb2))
    g = g.float().contiguous()
    winners = winners.to(torch.int32).contiguous()
    starts = window_starts(starts.to(torch.int32), N, window).to(torch.int32).contiguous()
    require_cuda(A, b_c, g, winners, starts, w2, b2, s2, lb2, w3)
    if M % BLOCK or b_c.shape[:2] != (B, M) or starts.shape != (B, M // BLOCK) \
            or not 0 < window <= N:
        raise ValueError("sa_pool_bwd input shapes do not agree")
    # one f32 record per CTA (16 centers): [dW2; dW3; db2; ds2; dlb2; db3], and
    # its window's dA contributions, which a second kernel adds in block order
    n_w2, n_w3 = C1 * C2, C2 * C3
    f32 = dict(dtype=torch.float32, device=A.device)
    dA = torch.empty((B, N, C1), **f32)
    dbc = torch.empty((B, M, C1), **f32)
    out = torch.empty(n_w2 + n_w3 + 3 * C2 + C3, **f32)
    records = torch.empty((B * M // BLOCK, out.numel()), **f32)
    da_records = torch.empty((B * M // BLOCK, window, C1), **f32)
    kernel = COMPACT_KERNEL if compact else WINDOW_KERNEL
    kernel(ptr(A), ptr(b_c), ptr(g), ptr(winners), ptr(starts), ptr(w2), ptr(b2), ptr(s2),
           ptr(lb2), ptr(w3), B, N, M, C1, C2, C3, c2, window, ptr(dA), ptr(dbc), ptr(out),
           ptr(records), ptr(da_records))
    dw2, dw3 = out[:n_w2].view(C1, C2), out[n_w2:n_w2 + n_w3].view(C2, C3)
    vec = out[n_w2 + n_w3:]
    return (dA[..., :c1], dbc[..., :c1], dw2[:c1, :c2], vec[:c2], vec[C2:C2 + c2],
            vec[2 * C2:2 * C2 + c2], dw3[:c2, :c3], vec[3 * C2:3 * C2 + c3])
