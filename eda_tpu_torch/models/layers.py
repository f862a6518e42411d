"""Cross-modal transformer layers, position embeddings and prediction heads.

Counterparts of ``eda_tpu/models/layers.py``. Conventions kept from the JAX package:

* batch-first ``(B, L, F)`` throughout;
* masks are validity masks: True = real token;
* post-norm residual blocks;
* each module computes in the dtype it was declared with: a ``Dense`` with
  ``dtype=bfloat16`` casts its input, kernel and bias to bf16 and returns bf16
  (as flax's ``Dense(dtype=...)`` does), while the parameters stay f32;
* LayerNorm epsilons are explicit: 1e-6 in the residual blocks (flax's
  default), 1e-12 for the text projector, 1e-5 in RoBERTa.

``train()`` / ``eval()`` switch dropout and BatchNorm's batch statistics as
flax's ``train`` flag does; dropout sits where the JAX modules put it.

Under data parallelism ``parallel.shard_params`` gives every ``BatchNorm``
and ``Dropout`` the mesh (``mesh``): in train mode the statistics are those
of the global batch and each rank draws the global batch's mask and keeps
its rows; eval mode reads neither. Under tensor parallelism it also sets
``tp`` on the attention, FFN and RoBERTa layers, which then run their share
of the heads and hidden units.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from eda_tpu_torch.parallel.mesh import copy_to_model, global_sum, reduce_from_model

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax momentum (eda_tpu/models/pointnet2.py:30)
ATTN_LN_EPS = 1e-6  # flax nn.LayerNorm default


class Dense(nn.Module):
    """``y = x @ W^T + b`` computed in ``dtype`` (flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def row_parallel(dense: Dense, x: torch.Tensor, mesh) -> torch.Tensor:
    """``dense(x)`` with ``dense``'s weight split by columns over the model group:
    the partial products summed in the compute dtype (as XLA's psum), then the
    replicated bias added once."""
    y = reduce_from_model(F.linear(x.to(dense.dtype), dense.weight.to(dense.dtype)), mesh)
    return y if dense.bias is None else y + dense.bias.to(dense.dtype)


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the last axis, in f32.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch statistics over every other axis, with flax's fast
    variance ``E[x^2] - E[x]^2`` (biased, clipped at 0), and updates the
    running statistics as flax does: ``r = 0.9 r + 0.1 batch``. With a ``mesh``
    of several data ranks the sums of ``x`` and ``x^2`` are all-reduced over
    its data group and divided by the global count (the flax statistics of
    the global batch), so the running statistics stay equal on every rank.
    """

    mesh = None  # parallel.shard_params

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if self.mesh is not None and self.mesh.data > 1:
                count = x.numel() // x.shape[-1] * self.mesh.data
                mean, mean2 = global_sum(torch.stack([x.sum(axes), (x * x).sum(axes)]),
                                         self.mesh) / count
                var = torch.clamp(mean2 - mean * mean, min=0.0)
            else:
                mean = x.mean(axes)
                var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class Dropout(nn.Dropout):
    """flax ``nn.Dropout``: ``where(keep, x / keep_prob, 0)`` in the input's dtype.

    ``shape`` (optional) draws one mask of that shape and broadcasts it over
    the input, as flax's ``broadcast_dropout`` does for attention weights.
    Set ``p = 0`` to switch it off in train mode.

    In train mode the mask is drawn on the input's device from ``generator``,
    which the training step sets for the length of one step
    (``train.step.dropout_generator``), as flax draws from the step's
    ``dropout`` key; without one the layer raises. With a ``mesh``
    the mask of the input's own shape is drawn over the global batch (the
    data ranks' rows stacked) and the rank keeps its rows, so W ranks drop
    what one process drops on the whole batch; ``split`` (a mesh) does the
    same over the last axis for an input split over the model group.
    """

    generator: Optional[torch.Generator] = None
    mesh = None

    def forward(self, x: torch.Tensor, shape=None, split=None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("train-mode dropout draws from the training step's generator "
                               "(eda_tpu_torch.train.step.dropout_generator)")
        keep_prob = 1.0 - self.p
        if shape is not None:
            keep = torch.rand(shape, device=x.device, generator=self.generator) < keep_prob
        else:
            full = list(x.shape)
            if self.mesh is not None:
                full[0] *= self.mesh.data
            if split is not None:
                full[-1] *= split.model
            keep = torch.rand(full, device=x.device, generator=self.generator) < keep_prob
            if self.mesh is not None:
                keep = keep.narrow(0, self.mesh.data_rank * x.shape[0], x.shape[0])
            if split is not None:
                keep = keep.narrow(-1, split.model_rank * x.shape[-1], x.shape[-1])
        return torch.where(keep, x / torch.tensor(keep_prob, dtype=x.dtype), torch.zeros_like(x))


def softmax_rounded(w: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` in the input's dtype: ``exp(w - max)`` rounded per op,
    the sum taken in f32 and rounded back, then one rounded division."""
    e = torch.exp(w - w.amax(-1, keepdim=True))
    return e / e.float().sum(-1, keepdim=True).to(w.dtype)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` with a key validity mask.

    The core rounds where flax 0.12's ``dot_product_attention`` rounds in the
    compute dtype: the queries divided by ``sqrt(depth)``, the ``q @ k^T``
    logits, the masked logits (``finfo(dtype).min``), the softmax, and the
    ``probs @ v`` product. In train mode the attention weights drop out with
    one ``(1, 1, Lq, Lk)`` mask shared by every batch row and head.

    With ``fuse`` (``ModelConfig.fused_qkv``; ``eda_tpu/models/layers.py:
    _FusedMHACore``) the projections whose inputs are the same tensor run as
    one wide product: ``q is k is v`` as one (d, 3d), ``q is k`` as (d, 2d)
    beside v, ``k is v`` as q beside (d, 2d). The parameters stay the
    unfused module's, so checkpoints and conversions do not change.

    With ``tp`` (a mesh, ``parallel.shard_params``) the module holds the rows
    of q / k / v and the columns of ``out`` of its share of the heads, runs
    those heads, and sums the out projection's partial products over the
    model group.
    """

    tp = None

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, fuse: bool = False):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
        self.fuse = fuse
        self.query = Dense(d_model, d_model, dtype=dtype)
        self.key = Dense(d_model, d_model, dtype=dtype)
        self.value = Dense(d_model, d_model, dtype=dtype)
        self.out = Dense(d_model, d_model, dtype=dtype)
        self.dropout = Dropout(dropout)

    def _project(self, x, *dense: Dense):
        """``x`` through the ``dense`` projections as one product, split back."""
        w = torch.cat([m.weight for m in dense]).to(self.dtype)
        b = torch.cat([m.bias for m in dense]).to(self.dtype)
        return (F.linear(x.to(self.dtype), w) + b).chunk(len(dense), -1)

    def projections(self, q, k, v):
        """(q, k, v) projected; with ``fuse``, in one product where their inputs
        are one tensor."""
        if self.fuse:
            if q is k and k is v:
                return self._project(q, self.query, self.key, self.value)
            if q is k:
                return (*self._project(q, self.query, self.key), self.value(v))
            if k is v:
                return (self.query(q), *self._project(k, self.key, self.value))
        return self.query(q), self.key(k), self.value(v)

    def forward(self, q, k, v, key_valid: Optional[torch.Tensor] = None):
        if self.tp is not None:
            q, k, v = copy_to_model(self.tp, q, k, v)
        B, Lq, d = q.shape
        dh = d // self.n_heads
        qp, kp, vp = self.projections(q, k, v)
        h = qp.shape[-1] // dh  # the heads this rank runs
        qh = qp.reshape(B, Lq, h, dh).transpose(1, 2)
        kh = kp.reshape(B, k.shape[1], h, dh).transpose(1, 2)
        vh = vp.reshape(B, v.shape[1], h, dh).transpose(1, 2)
        qh = qh / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(self.dtype)
        w = qh @ kh.transpose(-1, -2)  # (B, h, Lq, Lk) in the compute dtype
        if key_valid is not None:
            w = w.masked_fill(~key_valid[:, None, None, :].bool(), torch.finfo(w.dtype).min)
        w = self.dropout(softmax_rounded(w), shape=(1, 1) + tuple(w.shape[-2:]))
        x = (w @ vh).transpose(1, 2).reshape(B, Lq, h * dh)
        return self.out(x) if self.tp is None else row_parallel(self.out, x, self.tp)


class ResidualAttn(nn.Module):
    """``LayerNorm(x + attn(q, k, v))`` with ``q = x + q_pos``.

    ``k=None`` means the keys are the queries (position embedding on both):
    k is then the same tensor as q, which the fused projection reads once.
    """

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype, dropout: float = 0.0,
                 fuse: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, n_heads, dtype, dropout, fuse)
        self.dropout = Dropout(dropout)
        self.norm = nn.LayerNorm(d_model, eps=ATTN_LN_EPS)

    def forward(self, x, k, v, valid, q_pos=None):
        q = x if q_pos is None else x + q_pos
        k = q if k is None else k
        v = k if v is None else v
        return self.norm(x + self.dropout(self.attn(q, k, v, valid)))


class FFN(nn.Module):
    """``LayerNorm(x + Dense(relu(Dense(x))))``; with ``tp`` (a mesh) the hidden
    units split over the model group (column- then row-parallel)."""

    tp = None

    def __init__(self, d_model: int, dim_feedforward: int, dtype: torch.dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.dense = nn.ModuleList([
            Dense(d_model, dim_feedforward, dtype=dtype),
            Dense(dim_feedforward, d_model, dtype=dtype),
        ])
        self.dropout = Dropout(dropout)
        self.norm = nn.LayerNorm(d_model, eps=ATTN_LN_EPS)

    def forward(self, x):
        if self.tp is None:
            h = self.dropout(torch.relu(self.dense[0](x)))
            return self.norm(x + self.dropout(self.dense[1](h)))
        (xs,) = copy_to_model(self.tp, x)
        h = self.dropout(torch.relu(self.dense[0](xs)), split=self.tp)
        return self.norm(x + self.dropout(row_parallel(self.dense[1], h, self.tp)))


class PositionEmbeddingLearned(nn.Module):
    """Dense + BN + ReLU + Dense over xyz (3) or xyz+size (6) coordinates."""

    def __init__(self, in_dim: int, num_pos_feats: int, dtype: torch.dtype):
        super().__init__()
        self.dense = nn.ModuleList([
            Dense(in_dim, num_pos_feats, dtype=dtype),
            Dense(num_pos_feats, num_pos_feats, dtype=dtype),
        ])
        self.bn = nn.ModuleList([BatchNorm(num_pos_feats)])

    def forward(self, coords):
        return self.dense[1](torch.relu(self.bn[0](self.dense[0](coords))))


class BiEncoderLayer(nn.Module):
    """Self-attention per modality, then bidirectional cross-attention.

    Vision self-attention (position embedding on q and k), language
    self-attention, then lang->vis attention + FFN and vis->lang attention
    + FFN, where both directions read the other modality's pre-cross features.
    With ``butd``, vision also attends to the detected boxes (``cross_d``,
    no position embedding on the query) before its FFN. ``fused_qkv`` fuses
    the attention projections (``MultiHeadAttention``).
    """

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int,
                 self_attend: bool, dtype: torch.dtype, dropout: float = 0.0,
                 butd: bool = False, fused_qkv: bool = False):
        super().__init__()
        self.self_attend = self_attend
        fu = fused_qkv
        if self_attend:
            self.self_vis = ResidualAttn(d_model, n_heads, dtype, dropout, fu)
            self.self_lang = ResidualAttn(d_model, n_heads, dtype, dropout, fu)
        self.cross_lv = ResidualAttn(d_model, n_heads, dtype, dropout, fu)
        self.ffn_lv = FFN(d_model, dim_feedforward, dtype, dropout)
        self.cross_vl = ResidualAttn(d_model, n_heads, dtype, dropout, fu)
        if butd:
            self.cross_d = ResidualAttn(d_model, n_heads, dtype, dropout, fu)
        self.ffn_vl = FFN(d_model, dim_feedforward, dtype, dropout)

    def forward(self, vis_feats, pos_feats, vis_valid, text_feats, text_valid,
                detected_feats=None, detected_valid=None):
        if self.self_attend:
            vis_feats = self.self_vis(vis_feats, None, vis_feats, vis_valid, q_pos=pos_feats)
            text_feats = self.self_lang(text_feats, text_feats, text_feats, text_valid)
        text_kv = text_feats
        text_feats = self.ffn_lv(self.cross_lv(text_feats, vis_feats, vis_feats, vis_valid))
        vis_feats = self.cross_vl(vis_feats, text_kv, text_kv, text_valid, q_pos=pos_feats)
        if hasattr(self, "cross_d"):
            vis_feats = self.cross_d(vis_feats, detected_feats, detected_feats, detected_valid)
        return self.ffn_vl(vis_feats), text_feats


class BiDecoderLayer(nn.Module):
    """Query self-attention -> cross(text) -> cross(boxes, ``butd``) -> cross(vision) -> FFN.

    The learned embedding of the query location is added to q (and to k in
    self-attention) at every attention call. ``fused_qkv`` fuses the attention
    projections (``MultiHeadAttention``).
    """

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int,
                 self_position_embedding: str, dtype: torch.dtype, dropout: float = 0.0,
                 butd: bool = False, fused_qkv: bool = False):
        super().__init__()
        fu = fused_qkv
        loc_dim = {"xyz_learned": 3, "loc_learned": 6}.get(self_position_embedding)
        if loc_dim is not None:
            self.self_posembed = PositionEmbeddingLearned(loc_dim, d_model, dtype)
        self.self_attn = ResidualAttn(d_model, n_heads, dtype, dropout, fu)
        self.cross_l = ResidualAttn(d_model, n_heads, dtype, dropout, fu)
        if butd:
            self.cross_d = ResidualAttn(d_model, n_heads, dtype, dropout, fu)
        self.cross_v = ResidualAttn(d_model, n_heads, dtype, dropout, fu)
        self.ffn = FFN(d_model, dim_feedforward, dtype, dropout)

    def forward(self, query, vis_feats, text_feats, query_loc, text_valid,
                detected_feats=None, detected_valid=None):
        q_pos = self.self_posembed(query_loc) if hasattr(self, "self_posembed") else None
        query = self.self_attn(query, None, query, None, q_pos=q_pos)
        query = self.cross_l(query, text_feats, text_feats, text_valid, q_pos=q_pos)
        if hasattr(self, "cross_d"):
            query = self.cross_d(query, detected_feats, detected_feats, detected_valid,
                                 q_pos=q_pos)
        query = self.cross_v(query, vis_feats, vis_feats, None, q_pos=q_pos)
        return self.ffn(query)


class PointsObjClsModule(nn.Module):
    """Seed objectness head: (Dense + BN + ReLU) x 2 + Dense(1), f32 logits (B, K)."""

    def __init__(self, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.dense = nn.ModuleList([
            Dense(d_model, d_model, dtype=dtype),
            Dense(d_model, d_model, dtype=dtype),
            Dense(d_model, 1, dtype=torch.float32),
        ])
        self.bn = nn.ModuleList([BatchNorm(d_model), BatchNorm(d_model)])

    def forward(self, x):
        for dense, bn in zip(self.dense[:2], self.bn):
            x = torch.relu(bn(dense(x)))
        return self.dense[2](x)[..., 0]


class ThreeLayerMLP(nn.Module):
    """(Dense without bias + BN + ReLU + Dropout(0.3)) x 2 + Dense(out) in f32."""

    def __init__(self, dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dense = nn.ModuleList([
            Dense(dim, dim, bias=False, dtype=dtype),
            Dense(dim, dim, bias=False, dtype=dtype),
            Dense(dim, out_dim, dtype=torch.float32),
        ])
        self.bn = nn.ModuleList([BatchNorm(dim), BatchNorm(dim)])
        self.dropout = Dropout(0.3)

    def forward(self, x):
        for dense, bn in zip(self.dense[:2], self.bn):
            x = self.dropout(torch.relu(bn(dense(x))))
        return self.dense[2](x)


class ClsAgnosticPredictHead(nn.Module):
    """Center, size and soft-token class heads: (base_xyz + residual, size, sem_cls)."""

    def __init__(self, num_class: int, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.center_head = ThreeLayerMLP(d_model, 3, dtype)
        self.size_head = ThreeLayerMLP(d_model, 3, dtype)
        self.sem_cls_head = ThreeLayerMLP(d_model, num_class, dtype)

    def forward(self, features, base_xyz):
        return (
            base_xyz + self.center_head(features),
            self.size_head(features),
            self.sem_cls_head(features),
        )


class ContrastiveProjection(nn.Module):
    """Three-layer MLP into the shared contrastive space, L2-normalized."""

    def __init__(self, d_model: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dense = nn.ModuleList([
            Dense(d_model, d_model, dtype=dtype),
            Dense(d_model, d_model, dtype=dtype),
            Dense(d_model, out_dim, dtype=torch.float32),
        ])

    def forward(self, x):
        h = torch.relu(self.dense[1](torch.relu(self.dense[0](x))))
        h = self.dense[2](h)
        return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-12)


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's default kernel init: truncated normal with variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)
