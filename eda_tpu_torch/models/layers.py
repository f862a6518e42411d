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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the last axis, in f32.

    Eval mode normalises with the running statistics. Train mode normalises
    with the batch statistics over every other axis, with flax's fast
    variance ``E[x^2] - E[x]^2`` (biased, clipped at 0), and updates the
    running statistics as flax does: ``r = 0.9 r + 0.1 batch``.
    """

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
    ``dropout`` key; without one the layer raises.
    """

    generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor, shape=None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("train-mode dropout draws from the training step's generator "
                               "(eda_tpu_torch.train.step.dropout_generator)")
        keep_prob = 1.0 - self.p
        keep = torch.rand(shape if shape is not None else x.shape, device=x.device,
                          generator=self.generator) < keep_prob
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
    """

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
        B, Lq, d = q.shape
        h = self.n_heads
        dh = d // h
        qp, kp, vp = self.projections(q, k, v)
        qh = qp.reshape(B, Lq, h, dh).transpose(1, 2)
        kh = kp.reshape(B, k.shape[1], h, dh).transpose(1, 2)
        vh = vp.reshape(B, v.shape[1], h, dh).transpose(1, 2)
        qh = qh / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(self.dtype)
        w = qh @ kh.transpose(-1, -2)  # (B, h, Lq, Lk) in the compute dtype
        if key_valid is not None:
            w = w.masked_fill(~key_valid[:, None, None, :].bool(), torch.finfo(w.dtype).min)
        w = self.dropout(softmax_rounded(w), shape=(1, 1) + tuple(w.shape[-2:]))
        x = w @ vh
        return self.out(x.transpose(1, 2).reshape(B, Lq, d))


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
    """``LayerNorm(x + Dense(relu(Dense(x))))``."""

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
        h = self.dropout(torch.relu(self.dense[0](x)))
        return self.norm(x + self.dropout(self.dense[1](h)))


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
