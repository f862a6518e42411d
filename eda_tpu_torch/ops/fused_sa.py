"""Fused set abstraction forward: neighbourhood MLP + max pool without neighbour indices.

Counterpart of ``eda_tpu/ops/fused_sa.py:fused_set_abstraction`` on its TPU
serving path (``impl="pallas"``)::

    out_c = max over { p : |x_p - x_c| <= r } of MLP([(x_p - x_c)/r ; f_p])

Layer 0 is linear, so ``W1 @ [dx ; f] = A_p + b_c`` with a per-point
projection ``A`` (the prep kernel, LayerNorm'd on the point grid) and a
per-center offset ``b_c``. The pair kernel runs the interior layer and the
last layer on (center, point) pairs inside a Morton window, and the caller
maxes in the center's own point and applies the last LayerNorm + ReLU.

The port follows the reference's choice of path on every device. A window W
= min(window, N) that is a multiple of min(128, W) runs the kernels, with the
pair kernel's window semantics: blocks of 16 rank-sorted centers, each with a
window starting at the midpoint center's rank minus W/2, clipped and floored
to a multiple of 16. Any other window (e.g. 192, or a dense window over a
cloud of 50 000 points) runs what the reference falls back to there
(``eda_tpu/ops/fused_sa.py:576-581``): layer 0 as a bf16 matmul plus bias with
a two-pass LayerNorm, and ``scan_pool``, the plain twin of the reference's
``_scan_pool`` (blocks of ``block`` centers, windows around the rank of the
center at offset block/2, not floored), on the CPU and on CUDA alike, its
gradients from autograd. Points must arrive Morton-sorted (the data pipeline
presorts them), or the window must cover the cloud.

With gradients on, the prep and the pool run as autograd functions, as the
JAX package's ``impl="pallas_train"`` does: the prep forward (K2) with its
backward kernel (K7), and the pool forward with winner export (K4) with the
compact (K5) or windowed (K6) backward, chosen by the TPU's rule. With
gradients off the serving pool (K3) runs. The per-center offset ``b_c`` and
the recomputed self term stay plain autograd.

The pool's radius test is resolved once per call (``resolve_d2_mode``: the
``EDA_SA_D2`` environment variable, else ``pair``). ``mxu`` runs the
expansion-formula pool (K8); ``pre`` runs the mask kernel (K9a) and then the
pool that reads the mask (K9b). The backward does not depend on the mode: it
reads only the winners.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from eda_tpu_torch.ops.cuda.sa_kernel import (
    BLOCK,
    resolve_d2_mode,
    sa_pair_pool,
    sa_pair_pool_winners,
)
from eda_tpu_torch.ops.cuda.sa_mask import sa_radius_mask
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
    kernel (compact or windowed). Geometry, window starts and mask get none."""

    @staticmethod
    def forward(ctx, A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3, radius, window,
                d2_mode, mask):
        out, winners = sa_pair_pool_winners(A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3,
                                            radius=radius, window=window, d2_mode=d2_mode,
                                            mask=mask)
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
                dw2, db2, ds2, dlb2, dw3, db3, None, None, None, None)


def layer_norm(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """f32 LayerNorm over the last axis with two-pass stats."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def runs_kernels(window: int, n_points: int) -> bool:
    """Whether a layer runs the kernels: its window W = min(window, N) is a
    multiple of min(128, W), the reference's test for its Pallas pool."""
    W = min(window, n_points)
    return W % min(128, W) == 0


def plain_prep(pts: torch.Tensor, w1, b1, scale, lnb, *, radius: float) -> torch.Tensor:
    """Layer 0 where the reference has no Pallas kernel: bf16(x_in @ W1 + b1),
    two-pass LayerNorm, bf16. (B, N, 3 + C) raw points -> (B, N, c1) f32
    holding bf16 values."""
    xyz = pts[..., :3] / pts.new_tensor(radius)
    x_in = bf16_round(torch.cat([xyz, pts[..., 3:]], -1))
    h = bf16_round(bf16_round(x_in @ bf16_round(w1.float())) + bf16_round(b1.float()))
    return bf16_round(layer_norm(h, scale, lnb))


def scan_pool(A, xyz, b_c, cen_xyz, ranks, params: SAParams, *, radius: float, window: int,
              block: int, dense: bool) -> torch.Tensor:
    """Plain twin of ``eda_tpu/ops/fused_sa.py:_scan_pool``: the windowed
    masked-max pair MLP, block by block.

    Blocks of ``block`` rank-sorted centers; block i pairs with the W points
    from clip(ranks[i * block + block // 2] - W // 2, 0, N - W) (0 if dense).
    h0 = relu(bf16(A + b_c)); each layer bf16(bf16(h @ W) + bf16(b)); the
    interior layer's LayerNorm (two-pass) + ReLU in f32, then bf16; the last
    layer's pre-activations max-pooled over the in-radius pairs (-1e9 where
    none). Each block is recomputed in the backward, as ``jax.checkpoint``
    does there.

    Args:
        A: (B, N, c1) layer-0 projection; b_c / cen_xyz / ranks: (B, M_pad, .)
            per-center offsets, coordinates and ranks, M_pad a multiple of block.

    Returns:
        (B, M_pad, c_out) f32 pooled pre-activations in rank order.
    """
    B, N, c1 = A.shape
    kernels, biases, scales, lbiases = params
    r2 = radius * radius

    def block_compute(a_win, xyz_win, bc_blk, cen_blk):
        h = torch.relu(bf16_round(a_win[:, None] + bc_blk[:, :, None].float()))
        for i in (1, 2):
            h = bf16_round(bf16_round(h @ bf16_round(kernels[i].float()))
                           + bf16_round(biases[i].float()))
            if i == 1:
                h = bf16_round(torch.relu(layer_norm(h, scales[1], lbiases[1])))
        d2 = ((xyz_win[:, None] - cen_blk[:, :, None]) ** 2).sum(-1)
        return torch.amax(torch.where((d2 <= r2)[..., None], h, h.new_tensor(-1e9)), dim=2)

    offsets = torch.arange(window, device=A.device)
    outs = []
    for lo in range(0, ranks.shape[1], block):
        if dense:
            start = torch.zeros_like(ranks[:, 0])
        else:
            start = torch.clamp(ranks[:, lo + block // 2] - window // 2, 0, N - window)
        idx = (start[:, None] + offsets)[..., None]
        args = (A.gather(1, idx.expand(-1, -1, c1)), xyz.gather(1, idx.expand(-1, -1, 3)),
                b_c[:, lo:lo + block], cen_xyz[:, lo:lo + block])
        if torch.is_grad_enabled():
            outs.append(checkpoint(block_compute, *args, use_reentrant=False))
        else:
            outs.append(block_compute(*args))
    return torch.cat(outs, 1)


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
            center's rank repeats), which fixes the 16-center blocks' windows
            of the kernels and is the block of ``scan_pool``.

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
    kernels = runs_kernels(window, N)

    # per-point projection A = LN([xyz/r ; f] @ W1 + b1), in bf16
    pts = torch.cat([xyz, features], -1).contiguous()
    prep_args = (w1, params.biases[0], params.ln_scales[0], params.ln_biases[0])
    if not kernels:
        A = plain_prep(pts, *prep_args, radius=radius)
    elif train:
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
    k, b, s, lb = params
    if kernels:
        starts = window_starts(ranks_p, N, W, dense)
        xyz, cen_p = xyz.contiguous(), cen_p.contiguous()
        mode = resolve_d2_mode()
        mask = (sa_radius_mask(xyz, cen_p, starts, radius=radius, window=W)
                if mode == "pre" else None)
        pool_args = (A, xyz, b_c_p.contiguous(), cen_p, starts, k[1], b[1], s[1], lb[1], k[2],
                     b[2])
        if train:
            outs = _Pool.apply(*pool_args, radius, W, mode, mask)[:, :M]
        else:
            outs = sa_pair_pool(*pool_args, radius=radius, window=W, d2_mode=mode,
                                mask=mask)[:, :M]
    else:
        outs = scan_pool(A, xyz, b_c_p, cen_p, ranks_p, params, radius=radius, window=W,
                         block=block, dense=dense)[:, :M]

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
