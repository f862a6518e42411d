"""Fused set abstraction forward: neighbourhood MLP + max pool without neighbour indices.

Counterpart of ``eda_tpu/ops/fused_sa.py:fused_set_abstraction`` on its TPU
serving path (``impl="pallas"``)::

    out_c = max over { p : |x_p - x_c| <= r } of MLP([(x_p - x_c)/r ; f_p])

Layer 0 is linear, so ``W1 @ [dx ; f] = A_p + b_c`` with a per-point
projection ``A`` (the prep kernel, LayerNorm'd on the point grid) and a
per-center offset ``b_c``. The pair kernel runs the interior layer and the
last layer on (center, point) pairs inside a Morton window, and the caller
maxes in the center's own point and applies the last LayerNorm + ReLU.

The port follows the pair kernel's window semantics on every device: blocks
of 16 rank-sorted centers, each with a window starting at the midpoint
center's rank minus W/2, clipped and floored to a multiple of 16. Points must
arrive Morton-sorted (the data pipeline presorts them), or the window must
cover the cloud.

With gradients on, the prep and the pool run as autograd functions, as the
JAX package's ``impl="pallas_train"`` does: the prep forward (K2) with its
backward kernel (K7), and the pool forward with winner export (K4) with the
compact (K5) or windowed (K6) backward, chosen by the TPU's rule. With
gradients off the serving pool (K3) runs. The per-center offset ``b_c`` and
the recomputed self term stay plain autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from eda_tpu_torch.ops.cuda.sa_kernel import BLOCK, sa_pair_pool, sa_pair_pool_winners
from eda_tpu_torch.ops.cuda.sa_pool_bwd import compact_backward, sa_pool_bwd
from eda_tpu_torch.ops.cuda.sa_prep import bf16_round, sa_prep, sa_prep_bwd
from eda_tpu_torch.ops.pointops import gather_points


class SAParams(NamedTuple):
    """Parameters of one fused SA layer: per layer i, kernels[i] (C_in, C_out),
    biases[i], ln_scales[i] and ln_biases[i] (C_out,). Layer 0's input is
    [dxyz/r ; features], so kernels[0] has 3 + C rows."""

    kernels: Tuple[torch.Tensor, ...]
    biases: Tuple[torch.Tensor, ...]
    ln_scales: Tuple[torch.Tensor, ...]
    ln_biases: Tuple[torch.Tensor, ...]


class _Prep(torch.autograd.Function):
    """``A = sa_prep(pts, ...)`` with the prep backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, pts, w1, b1, scale, lnb, radius):
        ctx.save_for_backward(pts, w1, b1, scale)
        ctx.radius = radius
        return sa_prep(pts, w1, b1, scale, lnb, radius=radius)

    @staticmethod
    def backward(ctx, dA):
        pts, w1, b1, scale = ctx.saved_tensors
        dpts, dw1, db1, dscale, dlnb = sa_prep_bwd(pts, dA, w1, b1, scale, radius=ctx.radius)
        return dpts, dw1, db1, dscale, dlnb, None


class _Pool(torch.autograd.Function):
    """The pair pool with winner export; its gradient is the pair-pool backward
    kernel (compact or windowed). Geometry and window starts get none."""

    @staticmethod
    def forward(ctx, A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3, radius, window):
        out, winners = sa_pair_pool_winners(A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3,
                                            radius=radius, window=window)
        ctx.save_for_backward(A, b_c, winners, starts, w2, b2, s2, lb2, w3)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, g):
        A, b_c, winners, starts, w2, b2, s2, lb2, w3 = ctx.saved_tensors
        dA, dbc, dw2, db2, ds2, dlb2, dw3, db3 = sa_pool_bwd(
            A, b_c, g, winners, starts, w2, b2, s2, lb2, w3, window=ctx.window,
            compact=compact_backward(ctx.window, w3.shape[1]))
        # the TPU wrapper hands dA and db_c back in A's and b_c's dtype
        return (dA.to(A.dtype), None, dbc.to(b_c.dtype), None, None,
                dw2, db2, ds2, dlb2, dw3, db3, None, None)


def layer_norm(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """f32 LayerNorm over the last axis with two-pass stats."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def window_starts(ranks: torch.Tensor, n_points: int, window: int, dense: bool):
    """(B, M_pad // 16) window starts: midpoint rank of each 16-center block - W/2, clipped."""
    B, m_total = ranks.shape
    if dense:
        return torch.zeros((B, m_total // BLOCK), dtype=torch.int32, device=ranks.device)
    mids = ranks.view(B, m_total // BLOCK, BLOCK)[:, :, BLOCK // 2]
    return torch.clamp(mids - window // 2, 0, n_points - window).int()


def fused_set_abstraction(
    xyz: torch.Tensor,
    features: torch.Tensor,
    center_idx: torch.Tensor,
    params: SAParams,
    *,
    radius: float,
    window: int,
    block: int = 64,
):
    """Fused SA forward in rank order.

    Args:
        xyz: (B, N, 3) f32 Morton-sorted points (any order when window >= N).
        features: (B, N, C) f32 per-point features (C may be 0).
        center_idx: (B, M) indices of the centers (FPS output).
        params: SAParams of a three-layer MLP.
        radius: ball radius; window: window length (>= N means dense).
        block: centers are padded to a multiple of ``block`` (the last
            center's rank repeats), which fixes the 16-center blocks' windows.

    Returns:
        (features, ranks): (B, M, C_out) f32 pooled features in ascending
        center-index order, and the (B, M) ascending center indices.
    """
    B, N, _ = xyz.shape
    M = center_idx.shape[1]
    w1 = params.kernels[0]
    if w1.shape[0] != 3 + features.shape[-1]:
        raise ValueError(f"layer-0 kernel {tuple(w1.shape)} does not take 3 + {features.shape[-1]} inputs")
    if len(params.kernels) != 3:
        raise ValueError("the fused SA pair kernel takes a three-layer MLP")
    dense = window >= N
    if block % BLOCK:
        raise ValueError(f"block must be a multiple of {BLOCK}, got {block}")
    W = min(window, N)
    ranks = torch.sort(center_idx.long(), dim=1).values
    train = torch.is_grad_enabled() and (
        features.requires_grad or any(p.requires_grad for group in params for p in group))

    # per-point projection A = LN([xyz/r ; f] @ W1 + b1), in bf16
    pts = torch.cat([xyz, features], -1).contiguous()
    prep_args = (w1, params.biases[0], params.ln_scales[0], params.ln_biases[0])
    if train:
        A = _Prep.apply(pts, *prep_args, radius)
    else:
        A = sa_prep(pts, *prep_args, radius=radius)
    # per-center offset b_c = -(x_c / r) @ W1[:3]
    cen_xyz = gather_points(xyz, ranks)
    cen_scaled = cen_xyz / cen_xyz.new_tensor(radius)
    b_c = (-bf16_round(cen_scaled) @ bf16_round(w1[:3].float())).to(torch.bfloat16)

    n_blocks = -(-M // block)
    m_pad = n_blocks * block - M
    ranks_p, b_c_p, cen_p = ranks, b_c, cen_xyz
    if m_pad:
        # edge-pad so the last block's window midpoint stays on a real center
        ranks_p = torch.cat([ranks, ranks[:, -1:].expand(-1, m_pad)], 1)
        b_c_p = torch.cat([b_c, b_c.new_zeros(B, m_pad, b_c.shape[-1])], 1)
        cen_p = torch.cat([cen_xyz, cen_xyz[:, -1:].expand(-1, m_pad, -1)], 1)
    starts = window_starts(ranks_p, N, W, dense)
    k, b, s, lb = params
    pool_args = (A, xyz.contiguous(), b_c_p.contiguous(), cen_p.contiguous(), starts,
                 k[1], b[1], s[1], lb[1], k[2], b[2])
    if train:
        outs = _Pool.apply(*pool_args, radius, W)[:, :M]
    else:
        outs = sa_pair_pool(*pool_args, radius=radius, window=W)[:, :M]

    # The center's own point always lies in its ball, but a block-shared
    # window may miss it: max in the self term, recomputed from its inputs.
    self_in = torch.cat([cen_scaled, gather_points(features, ranks)], -1)
    h = bf16_round(bf16_round(self_in) @ bf16_round(w1.float()))
    h = bf16_round(h + bf16_round(b[0].float()))
    h = bf16_round(layer_norm(h, s[0], lb[0]))
    h = bf16_round(torch.relu(h + b_c.float()))
    for i in (1, 2):
        h = bf16_round(h @ bf16_round(k[i].float()))
        h = bf16_round(h + bf16_round(b[i].float()))
        if i == 1:
            h = bf16_round(torch.relu(layer_norm(h, s[1], lb[1])))
    outs = torch.maximum(outs, h)
    # last LayerNorm + ReLU on the pooled centers
    return torch.relu(layer_norm(outs, s[2], lb[2])), ranks
