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
gradients from autograd. ``impl`` picks a path by name, as the reference's
does: ``"xla"`` that fallback at any window, ``"winner"`` the same prep with
``winner_pool`` (the reference's opt-in ``_winner_pool``: the scan's forward
with winner export, and a backward that recomputes the pair MLP at the
winners only), plain PyTorch on every device, as the reference's is XLA.

Windows need points in Morton order. With ``presorted`` (the data pipeline
sorts on the host, and the backbone chains its layers in rank order) center
indices are ranks already. Otherwise the layer sorts the points itself
(``eda_tpu/ops/fused_sa.py:549-573``): a stable sort of ``morton_keys`` at
cell size ``radius``, xyz and features gathered into that order, each center
mapped to its sorted rank through the inverse permutation, the ranks sorted,
and the outputs returned in ``center_idx`` order at the end. A window that
covers the cloud needs no order.

With gradients on, the prep and the pool run as autograd functions, as the
JAX package's ``impl="pallas_train"`` does: the prep forward (K2) with its
backward kernel (K7), and the pool forward with winner export (K4) with the
compact (K5) or windowed (K6) backward, chosen by the TPU's rule. With
gradients off the serving pool (K3) runs. The per-center offset ``b_c`` and
the recomputed self term stay plain autograd.

``compute_dtype`` is the model's (``ModelConfig.use_bf16``): bf16 rounds where
the reference rounds in bf16; f32 runs layer 0 as the f32 prep kernels (K2f,
K7f), computes ``b_c``, ``scan_pool`` and the self term in f32, and rounds A
and ``b_c`` to bf16 only inside the pools, as the reference's pair kernels
take them (``eda_tpu/ops/pallas/sa_kernel.py:953-954``): the pool backward's
dA and db_c come back in f32.

On CUDA the serving and training kernels take widths up to (512, 512, 1024):
a training step whose layers would run the kernels wider raises before its
first launch (``check_trainable``; wider layers on CUDA are ROADMAP item 8.3).

The pool's radius test is resolved once per call (``resolve_d2_mode``: the
``EDA_SA_D2`` environment variable, else ``pair``). ``mxu`` runs the
expansion-formula pool (K8); ``pre`` runs the mask kernel (K9a) and then the
pool that reads the mask (K9b). The backward does not depend on the mode: it
reads only the winners.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from eda_tpu_torch.ops.cuda.sa_kernel import (
    BLOCK,
    kernel_widths,
    resolve_d2_mode,
    sa_pair_pool,
    sa_pair_pool_winners,
)
from eda_tpu_torch.ops.cuda.sa_mask import sa_radius_mask
from eda_tpu_torch.ops.cuda.sa_pool_bwd import compact_backward, sa_pool_bwd
from eda_tpu_torch.ops.cuda.sa_prep import rounding, sa_prep, sa_prep_bwd
from eda_tpu_torch.ops.pointops import gather_points, gather_shared

IMPLS = (None, "xla", "winner")


def morton_keys(xyz: torch.Tensor, cell_size: float, origin: float = -50.0) -> torch.Tensor:
    """Z-order key per point: interleaved 10-bit cell coordinates, (..., 3) -> (...,) int32.

    Bit for bit ``eda_tpu/ops/fused_sa.py:morton_keys`` as the JAX model runs
    it, compiled: XLA turns ``(xyz - origin) / cell_size`` into a product with
    the f32 reciprocal of ``cell_size`` (an eager division differs at a few
    cell boundaries), so the port multiplies by that reciprocal in f32. The
    cells are floored, saturated to 0 below the origin as XLA's float-to-
    unsigned conversion does, clipped to 1023; the bits spread in int64.
    """
    inv = torch.tensor(cell_size, dtype=torch.float32).reciprocal().to(xyz.device)
    cells = torch.floor((xyz.float() - origin) * inv).clamp(0, 1023).long()

    def spread(v):  # abcdefghij -> a__b__c__d__e__f__g__h__i__j
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    key = spread(cells[..., 0]) | (spread(cells[..., 1]) << 1) | (spread(cells[..., 2]) << 2)
    return key.int()


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
    def forward(ctx, pts, w1, b1, scale, lnb, radius, compute_dtype):
        ctx.save_for_backward(pts, w1, b1, scale)
        ctx.radius, ctx.compute_dtype = radius, compute_dtype
        return sa_prep(pts, w1, b1, scale, lnb, radius=radius, compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, dA):
        pts, w1, b1, scale = ctx.saved_tensors
        dpts, dw1, db1, dscale, dlnb = sa_prep_bwd(pts, dA, w1, b1, scale, radius=ctx.radius,
                                                   compute_dtype=ctx.compute_dtype)
        return dpts, dw1, db1, dscale, dlnb, None, None


class _Pool(torch.autograd.Function):
    """The pair pool with winner export; its gradient is the pair-pool backward
    kernel (compact or windowed). Geometry, window starts and mask get none.

    A and b_c are rounded to bf16 here, for the kernels only: f32 A and b_c
    (the f32 model) get their gradients back in f32, unrounded."""

    @staticmethod
    def forward(ctx, A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3, radius, window,
                d2_mode, mask):
        dtypes = A.dtype, b_c.dtype
        A, b_c = A.to(torch.bfloat16), b_c.to(torch.bfloat16)
        out, winners = sa_pair_pool_winners(A, xyz, b_c, cen, starts, w2, b2, s2, lb2, w3, b3,
                                            radius=radius, window=window, d2_mode=d2_mode,
                                            mask=mask)
        ctx.save_for_backward(A, b_c, winners, starts, w2, b2, s2, lb2, w3)
        ctx.window, ctx.dtypes = window, dtypes
        return out

    @staticmethod
    def backward(ctx, g):
        A, b_c, winners, starts, w2, b2, s2, lb2, w3 = ctx.saved_tensors
        dA, dbc, dw2, db2, ds2, dlb2, dw3, db3 = sa_pool_bwd(
            A, b_c, g, winners, starts, w2, b2, s2, lb2, w3, window=ctx.window,
            compact=compact_backward(ctx.window, w3.shape[1]))
        # the TPU wrapper hands dA and db_c back in A's and b_c's dtype
        a_dtype, bc_dtype = ctx.dtypes
        return (dA.to(a_dtype), None, dbc.to(bc_dtype), None, None,
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


def check_trainable(params: SAParams, *, window: int, n_points: int) -> None:
    """Raise where a training step would run this layer's kernels (on CUDA) at
    widths the training kernels lack (above (512, 512, 1024)): called by the
    backbone before its first launch, so that such a step launches nothing."""
    if runs_kernels(window, n_points):
        kernel_widths(params.kernels[0].shape[1], *params.kernels[2].shape,
                      what="the fused SA layer's training kernels")


def plain_prep(pts: torch.Tensor, w1, b1, scale, lnb, *, radius: float,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Layer 0 where the reference has no Pallas kernel: x_in @ W1 + b1 and a
    two-pass LayerNorm, each rounded to compute_dtype. (B, N, 3 + C) raw points
    -> (B, N, c1) f32 holding compute_dtype values."""
    rnd = rounding(compute_dtype)
    xyz = pts[..., :3] / pts.new_tensor(radius)
    x_in = rnd(torch.cat([xyz, pts[..., 3:]], -1))
    h = rnd(rnd(x_in @ rnd(w1.float())) + rnd(b1.float()))
    return rnd(layer_norm(h, scale, lnb))


def _pair_weights(params: SAParams) -> tuple:
    """(w2, b2, s2, lb2, w3, b3): the pair MLP's interior and last layer."""
    k, b, s, lb = params
    return k[1], b[1], s[1], lb[1], k[2], b[2]


def _pair_mlp(h0, w2, b2, s2, lb2, w3, b3, rnd, diagonal: bool = False):
    """The pair MLP after layer 0: the interior layer with LayerNorm + ReLU,
    then the last layer's pre-activation, each product and bias rounded. With
    ``diagonal``, h0's rows are (..., c_out, c1) and row k feeds only output
    channel k: the diagonal of the last product."""
    h = rnd(rnd(h0 @ rnd(w2.float())) + rnd(b2.float()))
    h = rnd(torch.relu(layer_norm(h, s2, lb2)))
    z = torch.einsum("...kc,ck->...k", h, rnd(w3.float())) if diagonal else h @ rnd(w3.float())
    return rnd(rnd(z) + rnd(b3.float()))


def _block_starts(ranks, lo: int, block: int, window: int, n_points: int, dense: bool):
    """(B,) start of block ``lo``'s window: the rank at offset block/2 - W/2, clipped."""
    if dense:
        return torch.zeros_like(ranks[:, 0])
    return torch.clamp(ranks[:, lo + block // 2] - window // 2, 0, n_points - window)


def _pool_blocks(A, xyz, b_c, cen_xyz, ranks, weights, *, radius: float, window: int,
                 block: int, dense: bool, compute_dtype, with_winners: bool):
    """The scan's blocks: (B, M_pad, c_out) pooled pre-activations, and with
    ``with_winners`` the (B, M_pad, c_out) int64 global rank of each pooled
    value's point (the first maximum in window order, as ``jnp.argmax``; an
    all-masked row's is the window's first point). ``weights`` as
    ``_pair_weights``."""
    B, N, c1 = A.shape
    r2 = radius * radius
    rnd = rounding(compute_dtype)

    def block_compute(a_win, xyz_win, bc_blk, cen_blk):
        h0 = torch.relu(rnd(a_win[:, None] + bc_blk[:, :, None].float()))
        h = _pair_mlp(h0, *weights, rnd)
        d2 = ((xyz_win[:, None] - cen_blk[:, :, None]) ** 2).sum(-1)
        masked = torch.where((d2 <= r2)[..., None], h, h.new_tensor(-1e9))
        if with_winners:
            return torch.max(masked, dim=2)
        return torch.amax(masked, dim=2)

    offsets = torch.arange(window, device=A.device)
    outs, wins = [], []
    for lo in range(0, ranks.shape[1], block):
        start = _block_starts(ranks, lo, block, window, N, dense)
        idx = (start[:, None] + offsets)[..., None]
        args = (A.gather(1, idx.expand(-1, -1, c1)), xyz.gather(1, idx.expand(-1, -1, 3)),
                b_c[:, lo:lo + block], cen_xyz[:, lo:lo + block])
        if with_winners:
            out, pos = block_compute(*args)
            wins.append(pos + start[:, None, None])
        elif torch.is_grad_enabled():
            out = checkpoint(block_compute, *args, use_reentrant=False)
        else:
            out = block_compute(*args)
        outs.append(out)
    if with_winners:
        return torch.cat(outs, 1), torch.cat(wins, 1)
    return torch.cat(outs, 1)


def scan_pool(A, xyz, b_c, cen_xyz, ranks, params: SAParams, *, radius: float, window: int,
              block: int, dense: bool, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain twin of ``eda_tpu/ops/fused_sa.py:_scan_pool``: the windowed
    masked-max pair MLP, block by block.

    Blocks of ``block`` rank-sorted centers; block i pairs with the W points
    from clip(ranks[i * block + block // 2] - W // 2, 0, N - W) (0 if dense).
    h0 = relu(bf16(A + b_c)); each layer bf16(bf16(h @ W) + bf16(b)); the
    interior layer's LayerNorm (two-pass) + ReLU in f32, then bf16; the last
    layer's pre-activations max-pooled over the in-radius pairs (-1e9 where
    none). In f32 (``compute_dtype``) nothing is rounded. Each block is
    recomputed in the backward, as ``jax.checkpoint`` does there.

    Args:
        A: (B, N, c1) layer-0 projection; b_c / cen_xyz / ranks: (B, M_pad, .)
            per-center offsets, coordinates and ranks, M_pad a multiple of block.

    Returns:
        (B, M_pad, c_out) f32 pooled pre-activations in rank order.
    """
    return _pool_blocks(A, xyz, b_c, cen_xyz, ranks, _pair_weights(params), radius=radius,
                        window=window, block=block, dense=dense, compute_dtype=compute_dtype,
                        with_winners=False)


class _WinnerPool(torch.autograd.Function):
    """``scan_pool`` whose backward recomputes the pair MLP only at the
    winning (center, channel) pairs (``eda_tpu/ops/fused_sa.py:_winner_pool``).

    Forward: the scan with winner export. Backward, block by block: gather A
    at the c_out winners of each center, run layer 0's ReLU and the pair MLP
    on those rows, keep the diagonal (winner slot k feeds out-channel k) and
    take its vector-Jacobian product with the cotangent. The gathered rows'
    gradients are added into dA in a fixed order (``gather_shared``), the
    parameters' block by block; geometry, ranks and the window get none."""

    @staticmethod
    def forward(ctx, A, b_c, w2, b2, s2, lb2, w3, b3, xyz, cen_xyz, ranks, statics):
        radius, window, block, dense, compute_dtype = statics
        weights = (w2, b2, s2, lb2, w3, b3)
        outs, winners = _pool_blocks(A, xyz, b_c, cen_xyz, ranks, weights, radius=radius,
                                     window=window, block=block, dense=dense,
                                     compute_dtype=compute_dtype, with_winners=True)
        ctx.save_for_backward(A, b_c, winners, *weights)
        ctx.block, ctx.compute_dtype = block, compute_dtype
        return outs

    @staticmethod
    def backward(ctx, g):
        A, b_c, winners, *weights = ctx.saved_tensors
        rnd = rounding(ctx.compute_dtype)
        B, N, c1 = A.shape
        K = winners.shape[-1]
        block = ctx.block
        leaves = [w.detach().requires_grad_() for w in weights]
        a_leaf = A.detach().requires_grad_()
        d_weights = [torch.zeros_like(w) for w in weights]
        dbc, dA = torch.empty_like(b_c), torch.zeros_like(A)
        with torch.enable_grad():
            for lo in range(0, b_c.shape[1], block):
                rows = winners[:, lo:lo + block].reshape(B, -1)
                bc = b_c[:, lo:lo + block].detach().requires_grad_()
                a_w = gather_shared(a_leaf, rows).view(B, -1, K, c1)
                h0 = torch.relu(rnd(a_w + bc[:, :, None].float()))
                z = _pair_mlp(h0, *leaves, rnd, diagonal=True)
                grads = torch.autograd.grad(z, [a_leaf, bc] + leaves, g[:, lo:lo + block])
                dA += grads[0]
                dbc[:, lo:lo + block] = grads[1]
                for acc, d in zip(d_weights, grads[2:]):
                    acc += d
        return (dA, dbc, *d_weights, None, None, None, None)


def winner_pool(A, xyz, b_c, cen_xyz, ranks, params: SAParams, *, radius: float, window: int,
                block: int, dense: bool, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``scan_pool`` with the winner-recompute backward (``_WinnerPool``): the
    same values, and gradients equal to the scan's up to ties between equal
    pair values. Arguments and result as ``scan_pool``."""
    return _WinnerPool.apply(A, b_c, *_pair_weights(params), xyz, cen_xyz, ranks,
                             (radius, window, block, dense, compute_dtype))


def _sort_points(xyz, features, center_idx, radius: float):
    """The device sort (``eda_tpu/ops/fused_sa.py:549-573``): (sorted xyz,
    sorted features, ranks of the centers in the sorted domain, ascending, and
    the order that restores ``center_idx``'s from them)."""
    B, N, _ = xyz.shape
    order = torch.sort(morton_keys(xyz, radius), dim=1, stable=True).indices
    sxyz, sfeats = gather_points(xyz, order), gather_points(features, order)
    # the inverse permutation: position in the sorted domain of each input point
    iota = torch.arange(N, device=xyz.device).expand(B, N)
    fwd_perm = torch.empty_like(order).scatter_(1, order, iota)
    ranks, center_order = torch.sort(fwd_perm.gather(1, center_idx.long()), dim=1, stable=True)
    return sxyz, sfeats, ranks, center_order


def fused_set_abstraction(
    xyz: torch.Tensor,
    features: torch.Tensor,
    center_idx: torch.Tensor,
    params: SAParams,
    *,
    radius: float,
    window: int,
    block: int = 64,
    compute_dtype: torch.dtype = torch.bfloat16,
    presorted: bool = True,
    impl: Optional[str] = None,
    return_rank_order: bool = True,
):
    """Fused SA forward.

    Args:
        xyz: (B, N, 3) f32 points, Morton-sorted with ``presorted`` (any order
            when window >= N).
        features: (B, N, C) f32 per-point features (C may be 0).
        center_idx: (B, M) indices of the centers (FPS output).
        params: SAParams of a three-layer MLP.
        radius: ball radius; window: window length (>= N means dense).
        block: centers are padded to a multiple of ``block`` (the last
            center's rank repeats), which is the block of ``scan_pool`` and
            ``winner_pool`` and, a multiple of 16, fixes the kernels' windows.
        compute_dtype: bf16 or f32, the model's (see the module docstring).
        presorted: the points arrive in Morton order, so center indices are
            ranks; otherwise the layer sorts them (module docstring).
        impl: None for the reference's TPU path (the kernels where they run,
            else the XLA fallback), ``"xla"`` for the fallback, ``"winner"``
            for ``winner_pool``.
        return_rank_order: also return the ascending center indices and keep
            the outputs in that order; only for presorted or dense layers,
            where ranks are indices of the input.

    Returns:
        (B, M, C_out) f32 pooled features in ``center_idx`` order; with
        ``return_rank_order`` (features in ascending center-index order, the
        (B, M) ascending center indices).
    """
    B, N, _ = xyz.shape
    M = center_idx.shape[1]
    w1 = params.kernels[0]
    if w1.shape[0] != 3 + features.shape[-1]:
        raise ValueError(f"layer-0 kernel {tuple(w1.shape)} does not take 3 + {features.shape[-1]} inputs")
    if len(params.kernels) != 3:
        raise ValueError("the fused SA pair kernel takes a three-layer MLP")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    dense = window >= N
    if return_rank_order and not (presorted or dense):
        raise ValueError("return_rank_order needs ranks to be input-domain indices, which "
                         "only holds for presorted or dense layers")
    kernels = impl is None and runs_kernels(window, N)
    if kernels and block % BLOCK:
        raise ValueError(f"block must be a multiple of {BLOCK} where the kernels run, got {block}")
    W = min(window, N)
    center_order = None  # the rank order's positions in center_idx; None: the same order
    if dense and not return_rank_order:
        ranks = center_idx.long()  # any order: the window covers everything
    elif presorted or dense:
        ranks, center_order = torch.sort(center_idx.long(), dim=1, stable=True)
    else:
        xyz, features, ranks, center_order = _sort_points(xyz, features, center_idx, radius)
    train = torch.is_grad_enabled() and (
        features.requires_grad or any(p.requires_grad for group in params for p in group))
    cd = compute_dtype
    rnd = rounding(cd)

    # per-point projection A = LN([xyz/r ; f] @ W1 + b1), in the compute dtype
    pts = torch.cat([xyz, features], -1).contiguous()
    prep_args = (w1, params.biases[0], params.ln_scales[0], params.ln_biases[0])
    if not kernels:
        A = plain_prep(pts, *prep_args, radius=radius, compute_dtype=cd)
    elif train:
        A = _Prep.apply(pts, *prep_args, radius, cd)
    else:
        A = sa_prep(pts, *prep_args, radius=radius, compute_dtype=cd)
    # per-center offset b_c = -(x_c / r) @ W1[:3]
    cen_xyz = gather_points(xyz, ranks)
    cen_scaled = cen_xyz / cen_xyz.new_tensor(radius)
    b_c = (-rnd(cen_scaled) @ rnd(w1[:3].float())).to(cd)

    n_blocks = -(-M // block)
    m_pad = n_blocks * block - M
    ranks_p, b_c_p, cen_p = ranks, b_c, cen_xyz
    if m_pad:
        # edge-pad so the last block's window midpoint stays on a real center
        ranks_p = torch.cat([ranks, ranks[:, -1:].expand(-1, m_pad)], 1)
        b_c_p = torch.cat([b_c, b_c.new_zeros(B, m_pad, b_c.shape[-1])], 1)
        cen_p = torch.cat([cen_xyz, cen_xyz[:, -1:].expand(-1, m_pad, -1)], 1)
    weights = _pair_weights(params)
    if kernels:
        starts = window_starts(ranks_p, N, W, dense)
        xyz, cen_p = xyz.contiguous(), cen_p.contiguous()
        mode = resolve_d2_mode()
        mask = (sa_radius_mask(xyz, cen_p, starts, radius=radius, window=W)
                if mode == "pre" else None)
        pool_args = (A, xyz, b_c_p.contiguous(), cen_p, starts, *weights)
        if train:
            outs = _Pool.apply(*pool_args, radius, W, mode, mask)[:, :M]
        else:
            # the pair kernels take A and b_c in bf16
            bf16 = (A.to(torch.bfloat16), xyz, b_c_p.to(torch.bfloat16))
            outs = sa_pair_pool(*bf16, *pool_args[3:], radius=radius, window=W, d2_mode=mode,
                                mask=mask)[:, :M]
    else:
        pool = winner_pool if impl == "winner" else scan_pool
        outs = pool(A, xyz, b_c_p, cen_p, ranks_p, params, radius=radius, window=W,
                    block=block, dense=dense, compute_dtype=cd)[:, :M]

    # The center's own point always lies in its ball, but a block-shared
    # window may miss it: max in the self term, recomputed from its inputs.
    _, b, s, lb = params
    self_in = torch.cat([cen_scaled, gather_points(features, ranks)], -1)
    h = rnd(rnd(self_in) @ rnd(w1.float()))
    h = rnd(h + rnd(b[0].float()))
    h = rnd(layer_norm(h, s[0], lb[0]))
    h = _pair_mlp(rnd(torch.relu(h + b_c.float())), *weights, rnd)
    outs = torch.maximum(outs, h)
    # last LayerNorm + ReLU on the pooled centers
    outs = torch.relu(layer_norm(outs, s[2], lb[2]))
    if return_rank_order:
        return outs, ranks
    if center_order is not None:
        # back to center_idx order from the rank order
        inv = torch.argsort(center_order, dim=1)
        outs = outs.gather(1, inv[..., None].expand(-1, -1, outs.shape[-1]))
    return outs


def window_starts(ranks: torch.Tensor, n_points: int, window: int, dense: bool):
    """(B, M_pad // 16) window starts: midpoint rank of each 16-center block - W/2, clipped."""
    B, m_total = ranks.shape
    if dense:
        return torch.zeros((B, m_total // BLOCK), dtype=torch.int32, device=ranks.device)
    mids = ranks.view(B, m_total // BLOCK, BLOCK)[:, :, BLOCK // 2]
    return torch.clamp(mids - window // 2, 0, n_points - window).int()
